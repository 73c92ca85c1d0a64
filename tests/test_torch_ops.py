"""The port's resize op (``sparkdl_tpu_torch.ops.infeed``) against the JAX
package's (``sparkdl_tpu.ops.infeed``) on the CPU: the same numpy-seeded
inputs through both, the JAX side through its XLA path and through the
Pallas kernel in interpret mode (as tests/test_ops.py runs it).

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version tested here."""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import infeed as jax_infeed
from sparkdl_tpu_torch.ops import infeed

# fp32 on both sides; only the summation order differs. Bounds are 1e-5
# of the output's range: 1e-5 on the [-1, 1] scale, 255e-5 on 0..255.
TOL_UNIT = 1e-5
TOL_COUNTS = 255 * 1e-5

# (name, input shape, output hw, scale, offset, input dtype, tolerance):
# the chip smoke's shapes, the main path's 512→299 at batch 2 (the
# per-image math does not depend on the batch, and interpret mode is slow)
CASES = [
    ("main_geometry", (2, 512, 512, 3), (299, 299), 1.0, 0.0, np.uint8,
     TOL_COUNTS),
    ("small_unit", (3, 40, 56, 3), (24, 32), 1 / 127.5, -1.0, np.uint8,
     TOL_UNIT),
    ("upsample", (2, 150, 150, 1), (299, 299), 1.0, 0.0, np.uint8,
     TOL_COUNTS),
    ("fp32_input", (4, 64, 48, 3), (33, 71), 1.0, 0.0, np.float32,
     TOL_COUNTS),
]


def _input(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == np.float32:
        x = x.astype(np.float32) * (255 / 256) + rng.random(shape,
                                                            np.float32)
    return x


@pytest.mark.parametrize("src,dst", [(40, 24), (56, 32), (512, 299),
                                     (150, 299), (17, 17), (64, 8)])
def test_weight_matrix_identical_to_jax(src, dst):
    np.testing.assert_array_equal(infeed.bilinear_weight_matrix(src, dst),
                                  jax_infeed.bilinear_weight_matrix(src, dst))


@pytest.mark.parametrize("src,dst", [(512, 299), (150, 299), (40, 24)])
def test_weight_bands_cover_every_nonzero(src, dst):
    w = infeed.bilinear_weight_matrix(src, dst)
    lo, hi = infeed.weight_bands(w)
    cols = np.arange(src)[None, :]
    outside = (cols < lo[:, None]) | (cols >= hi[:, None])
    assert not w[outside].any()
    assert (w[np.arange(dst), lo] != 0).all()
    assert (w[np.arange(dst), hi - 1] != 0).all()


@pytest.mark.parametrize("name,shape,out_hw,scale,offset,dtype,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_xla_and_pallas(name, shape, out_hw, scale,
                                          offset, dtype, tol):
    x = _input(shape, dtype)
    before = infeed.launches
    got = infeed.fused_resize_normalize(torch.from_numpy(x), out_hw, scale,
                                        offset)
    assert infeed.launches == before  # CPU tensors take the plain version
    got = got.numpy()
    xla = np.asarray(jax_infeed.fused_resize_normalize(
        x, out_hw, scale=scale, offset=offset, use_pallas=False))
    pallas = np.asarray(jax_infeed.fused_resize_normalize(
        x, out_hw, scale=scale, offset=offset, use_pallas=True,
        interpret=True))
    assert got.shape == (shape[0], *out_hw, shape[3])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)


def test_wrapper_rejects_other_dtypes_and_ranks():
    with pytest.raises(TypeError):
        infeed.fused_resize_normalize(torch.zeros(1, 4, 4, 3,
                                                  dtype=torch.int32), (2, 2))
    with pytest.raises(ValueError):
        infeed.fused_resize_normalize(torch.zeros(4, 4, 3,
                                                  dtype=torch.uint8), (2, 2))
    with pytest.raises(ValueError):
        infeed.fused_resize_normalize(torch.zeros(1, 4, 4, 3,
                                                  dtype=torch.uint8), (0, 2))


# The CUDA kernel's launch plan (``resize_plan``): band weights, tiling and
# shared memory, checked on the CPU. The geometries: the main path (to
# InceptionV3's 299 and to ResNet50's and VGG's 224), an upscale, the
# identity, the small cases, and phone photos to 299.
PLAN_GEOMETRIES = [
    ((512, 512), (299, 299)), ((512, 512), (224, 224)),
    ((150, 150), (299, 299)),
    ((299, 299), (299, 299)), ((40, 40), (24, 24)), ((56, 56), (32, 32)),
    ((3024, 3024), (299, 299)), ((4032, 4032), (299, 299)),
    ((3024, 4032), (299, 299)),
]
PLAN_IDS = [f"{s[0]}x{s[1]}to{d[0]}x{d[1]}" for s, d in PLAN_GEOMETRIES]


def _plan(geometry, c, **kw):
    (src_h, src_w), (h, w) = geometry
    return infeed.resize_plan(src_h, h, src_w, w, c, **kw)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("geometry", PLAN_GEOMETRIES, ids=PLAN_IDS)
def test_plan_stages_every_nonzero_weight(geometry, c):
    plan = _plan(geometry, c)
    (src_h, src_w), (h, w) = geometry
    for src, dense, lo, hi, step, spans in (
            (src_h, infeed.bilinear_weight_matrix(src_h, h), plan.h_lo,
             plan.h_hi, plan.rows, plan.bands),
            (src_w, infeed.bilinear_weight_matrix(src_w, w), plan.w_lo,
             plan.w_hi, plan.tile_w, plan.tiles)):
        block = np.arange(len(lo)) // step
        assert len(spans) == block[-1] + 1
        start, stop = spans[block, 0], spans[block, 1]
        assert (0 <= start).all() and (stop <= src).all()
        staged = ((np.arange(src)[None, :] >= start[:, None])
                  & (np.arange(src)[None, :] < stop[:, None]))
        assert not dense[~staged].any()
    # the ring holds the band being computed and the one in flight
    assert plan.depth >= 2 * int(np.ptp(plan.bands, axis=1).max())
    # a ring slot holds the widest tile's row with up to 15 bytes before it
    assert plan.pitch % 16 == 0
    assert plan.pitch >= 15 + int(np.ptp(plan.tiles, axis=1).max()) * c


@pytest.mark.parametrize("geometry", PLAN_GEOMETRIES, ids=PLAN_IDS)
def test_plan_band_weights_equal_dense_inside_band(geometry):
    plan = _plan(geometry, 3)
    (src_h, src_w), (h, w) = geometry
    # the kernel's per-band table of row weights
    dense = infeed.bilinear_weight_matrix(src_h, h)
    for b, (rs, re) in enumerate(plan.bands):
        rows = dense[b * plan.rows:(b + 1) * plan.rows, rs:re].T
        table = plan.band_table[b, :re - rs, :len(rows.T)]
        np.testing.assert_array_equal(table, rows)
        assert not plan.band_table[b, re - rs:].any()
        assert not plan.band_table[b, :, len(rows.T):].any()
    for dense, band, lo, hi in (
            (infeed.bilinear_weight_matrix(src_h, h), plan.h_weights,
             plan.h_lo, plan.h_hi),
            (infeed.bilinear_weight_matrix(src_w, w), plan.w_weights,
             plan.w_lo, plan.w_hi)):
        assert band.dtype == np.float32
        assert band.shape == (dense.shape[0], int((hi - lo).max()))
        for y in range(dense.shape[0]):
            taps = hi[y] - lo[y]
            np.testing.assert_array_equal(band[y, :taps],
                                          dense[y, lo[y]:hi[y]])
            assert not band[y, taps:].any()
            assert not dense[y, :lo[y]].any() and not dense[y, hi[y]:].any()


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("geometry", PLAN_GEOMETRIES, ids=PLAN_IDS)
def test_plan_shared_memory_fits_the_budget(geometry, c):
    for itemsize in (1, 4):
        plan = _plan(geometry, c, itemsize=itemsize)
        assert plan.smem <= infeed.SMEM_BUDGET <= infeed.SMEM_MAX
        assert plan.smem == infeed._smem_bytes(plan.rows, plan.depth,
                                               plan.pitch, itemsize)


@pytest.mark.parametrize("c", [1, 3])
def test_plan_shared_memory_does_not_grow_with_the_source(c):
    # the same output and budget from ever wider sources: the tiles narrow
    plans = [infeed.resize_plan(512, 299, src_w, 299, c)
             for src_w in (512, 1024, 2048, 4032, 8064)]
    assert all(p.smem <= infeed.SMEM_BUDGET for p in plans)
    assert plans[0].tile_w == 299 and len(plans[0].tiles) == 1
    assert [p.tile_w for p in plans] == sorted(
        (p.tile_w for p in plans), reverse=True)


def test_plan_main_path_is_one_tile_per_band():
    plan = infeed.resize_plan(512, 299, 512, 299, 3)
    assert (plan.rows, plan.tile_w, len(plan.tiles)) == (infeed.ROWS, 299, 1)
    assert len(plan.bands) == -(-299 // infeed.ROWS)


def _run_plan(x, plan, out_hw, scale, offset, grid):
    """The CUDA kernel's schedule in numpy, for ``grid`` persistent
    blocks: each walks its contiguous run of items (image, tile, band;
    bands fastest), loading into ring slots only the source rows an item
    adds to the band before it, one item in front of the compute,
    which finds the item's rows where the loader put them. Every tap
    checks that its slot still holds its own row; row and column passes
    accumulate in fp32 over ascending sources."""
    n, _, _, c = x.shape
    h, w = out_hw
    n_bands, n_tiles = len(plan.bands), len(plan.tiles)
    items = n * n_tiles * n_bands
    out = np.full((n, h, w, c), np.nan, np.float32)

    def decode(i):
        band, rest = i % n_bands, i // n_bands
        tile, img = rest % n_tiles, rest // n_tiles
        y0, x0 = band * plan.rows, tile * plan.tile_w
        return (img, tile, band, y0, min(plan.rows, h - y0), x0,
                min(plan.tile_w, w - x0))

    def advance(run, i, first, item):
        _, _, band, y0, rows, _, _ = item
        ve = plan.h_hi[y0 + rows - 1]
        if band > 0 and i > first:
            vb = plan.h_hi[y0 - 1]
        else:
            run["v0"] = vb = plan.h_lo[y0]
            run["slot0"] = run["next"]
        run["next"] = (run["slot0"] + ve - run["v0"]) % plan.depth
        return vb, ve

    def slot(run, v):
        return (run["slot0"] + v - run["v0"]) % plan.depth

    for b in range(grid):
        first, last = items * b // grid, items * (b + 1) // grid
        ring = [None] * plan.depth
        run = {"v0": 0, "slot0": 0, "next": 0}
        loads = iter(range(first, last))
        placed = []  # (item, ring slot of its band's first row), in order

        def load_next():
            i = next(loads, None)
            if i is not None:
                item = decode(i)
                img, tile = item[:2]
                cs, ce = plan.tiles[tile]
                for v in range(*advance(run, i, first, item)):
                    ring[slot(run, v)] = ((img, tile, v), x[
                        img, v, cs:ce].astype(np.float32))
                band = item[3] // plan.rows
                placed.append((item, slot(run, plan.bands[band, 0])))

        load_next()
        for _ in range(first, last):
            load_next()
            (img, tile, band, y0, rows, x0, cols), slot0 = placed.pop(0)
            cs, ce = plan.tiles[tile]
            vlo = plan.bands[band, 0]
            t = np.zeros((plan.rows, ce - cs, c), np.float32)
            for v in range(vlo, plan.bands[band, 1]):
                held, row = ring[(slot0 + v - vlo) % plan.depth]
                assert held == (img, tile, v)
                t += plan.band_table[band, v - vlo][:, None, None] * row
            for xl in range(cols):
                xo = x0 + xl
                acc = np.zeros((rows, c), np.float32)
                for j in range(plan.w_hi[xo] - plan.w_lo[xo]):
                    acc += (plan.w_weights[xo, j]
                            * t[:rows, plan.w_lo[xo] - cs + j])
                out[img, y0:y0 + rows, xo] = (acc * np.float32(scale)
                                              + offset)
    return out


# (input shape, output hw, scale, offset, input dtype, plan options): the
# main path's 512→224 (ResNet50, VGG), the chip smoke's small cases and
# its two tall images, whose steep vertical
# downscales shorten the bands (to 2 rows within the budget, to 1 in up to
# 227 KB), and two downscales with a budget so small that the plan tiles
# columns (the first also shortens its bands)
SCHEDULE_CASES = [
    ((1, 512, 512, 3), (224, 224), 1.0, 0.0, np.uint8, {}),
    ((3, 40, 56, 3), (24, 32), 1 / 127.5, -1.0, np.uint8, {}),
    ((3, 41, 57, 1), (24, 33), 1.0, 0.0, np.uint8, {}),
    ((1, 30, 30, 1), (61, 61), 1.0, 0.0, np.uint8, {}),
    ((2, 17, 17, 3), (17, 17), 1.0, 0.0, np.uint8, {}),
    ((1, 6000, 16, 1), (8, 16), 1.0, 0.0, np.uint8, {}),
    ((1, 10000, 64, 3), (8, 32), 1.0, 0.0, np.uint8, {}),
    ((2, 64, 48, 3), (33, 71), 1.0, 0.0, np.float32, {}),
    ((1, 200, 260, 3), (23, 29), 1.0, 0.0, np.uint8,
     {"smem_budget": 4096, "rows": 8}),
    ((2, 90, 70, 3), (31, 23), 1 / 127.5, -1.0, np.uint8,
     {"smem_budget": 6144, "rows": 8}),
]


@pytest.mark.parametrize(
    "shape,out_hw,scale,offset,dtype,opts", SCHEDULE_CASES,
    ids=[f"{'x'.join(map(str, c[0]))}to{c[1][0]}x{c[1][1]}"
         for c in SCHEDULE_CASES])
def test_plan_schedule_reproduces_plain(shape, out_hw, scale, offset,
                                        dtype, opts):
    x = _input(shape, dtype)
    plan = infeed.resize_plan(shape[1], out_hw[0], shape[2], out_hw[1],
                              shape[3], itemsize=np.dtype(dtype).itemsize,
                              **opts)
    if opts:  # the budget forces column tiles
        assert len(plan.tiles) > 1
    elif shape[1] >= 6000:  # the tall images' bands
        assert (plan.rows, plan.smem > infeed.SMEM_BUDGET) == (
            (2, False) if shape[1] == 6000 else (1, True))
    ref = infeed.fused_resize_normalize_plain(torch.from_numpy(x), out_hw,
                                              scale, offset).numpy()
    tol = TOL_UNIT if scale != 1.0 else TOL_COUNTS
    items = shape[0] * len(plan.tiles) * len(plan.bands)
    # one block walks every item; a few blocks split runs mid-image; one
    # block an item
    for grid in sorted({1, min(3, items), items}):
        got = _run_plan(x, plan, out_hw, scale, offset, grid)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_plan_rejects_unbuilt_band_heights_and_too_steep_downscales():
    with pytest.raises(ValueError):
        infeed.resize_plan(512, 299, 512, 299, 3, rows=3)
    with pytest.raises(ValueError):
        infeed.resize_plan(30000, 200, 30000, 200, 3)


def test_build_hash_covers_included_csrc_files(tmp_path, monkeypatch):
    from sparkdl_tpu_torch.ops import _build
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "k.cuh"\nint f();\n')
    (tmp_path / "k.cuh").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build.library_path("k")
    assert before == _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    after = _build.library_path("k")
    assert after != before
    (tmp_path / "k.cuh").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("k") not in (before, after)



def test_phase_variants_cut_the_kernel_once():
    """Each variant of k1_phases.py applies every one of its cuts to the
    kernel's source exactly once, and a cut that no longer matches stops
    the script; without CUDA it exits non-zero and prints nothing on
    stdout."""
    code = (
        "import contextlib, io, json\n"
        "import k1_phases\n"
        "from sparkdl_tpu_torch.ops import _build\n"
        "src = open(_build.CSRC_DIR + '/resize_normalize.cu').read()\n"
        "changed = {n: k1_phases.variant_source(src, c) != src\n"
        "           for n, c in k1_phases.VARIANTS.items()}\n"
        "try:\n"
        "    k1_phases.variant_source('// edited\\n', ['row_pass'])\n"
        "    stale = 'accepted'\n"
        "except RuntimeError as e:\n"
        "    stale = str(e)\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = k1_phases.main()\n"
        "print(json.dumps({'changed': changed, 'stale': stale, 'rc': rc,\n"
        "                  'stdout': out.getvalue()}))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["changed"].pop("full") is False
    assert len(result["changed"]) == 7 and all(result["changed"].values())
    assert "occurs 0 times" in result["stale"]
    assert result["rc"] != 0 and result["stdout"] == ""


def test_k2_phase_variants_cut_the_kernel_once():
    """k2_phases.py finds the design whose cuts all match K2's source once
    (the persistent design today, and the one-block-per-item design of
    its first version, kept so the script can time that too); each
    variant changes the source, a cut that no longer matches stops the
    script, and without CUDA it exits non-zero and prints nothing on
    stdout."""
    code = (
        "import contextlib, io, json\n"
        "import k2_phases\n"
        "from sparkdl_tpu_torch.ops import _build\n"
        "src = open(_build.CSRC_DIR + '/yuv420_resize_normalize.cu').read()\n"
        "design = k2_phases.design_of(src)\n"
        "changed = {n: k2_phases.variant_source(src, design, c) != src\n"
        "           for n, c in k2_phases.VARIANTS.items()}\n"
        "try:\n"
        "    k2_phases.design_of('// edited\\n')\n"
        "    stale = 'accepted'\n"
        "except RuntimeError as e:\n"
        "    stale = str(e)\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = k2_phases.main()\n"
        "print(json.dumps({'design': design, 'changed': changed,\n"
        "                  'stale': stale, 'rc': rc,\n"
        "                  'stdout': out.getvalue()}))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["design"] == "persistent"
    assert result["changed"].pop("full") is False
    assert len(result["changed"]) == 7 and all(result["changed"].values())
    assert "no design's cuts match" in result["stale"]
    assert result["rc"] != 0 and result["stdout"] == ""


# ---------------------------------------------------------------------------
# The 4:2:0 op (K2's plain version) against the JAX package's, and K2's
# launch plan and schedule
# ---------------------------------------------------------------------------

# a float32 resize value this close to k + 0.5 is a tie, which float32
# summation order may round to either neighbour (as in test_torch_slice.py)
TIE = 1e-4

# (name, batch, source hw, output hw, scale, offset, tolerance): the
# headline upsample, the RGB main path's source, bench.py's full-resolution
# 4:2:0 shape, the identity, and a downscale to the [-1, 1] scale. The
# tolerances are K1's: the colour transform's coefficients (at most 1.772
# with the luma's 1, on values up to 255) stay within them.
YUV_CASES = [
    ("headline_150to299", 2, (150, 150), (299, 299), 1.0, 0.0, TOL_COUNTS),
    ("rgb_main_512to299", 2, (512, 512), (299, 299), 1.0, 0.0, TOL_COUNTS),
    ("full_res_298to299", 2, (298, 298), (299, 299), 1.0, 0.0, TOL_COUNTS),
    ("identity_24", 3, (24, 24), (24, 24), 1.0, 0.0, TOL_COUNTS),
    ("unit_40x56to24x32", 3, (40, 56), (24, 32), 1 / 127.5, -1.0, TOL_UNIT),
]


def _packed(n, src_hw, seed=0):
    """Packed 4:2:0 rows of smooth images with noise, so the colour
    transform leaves some pixels inside [0, 255] and clips others."""
    from sparkdl_tpu_torch.image.imageIO import rgbToYuv420
    rng = np.random.default_rng(seed)
    h, w = src_hw
    yy, xx = np.mgrid[0:h, 0:w]
    rows = []
    for i in range(n):
        base = np.stack([128 + 120 * np.sin((xx + 7 * i) / 9.0 + c)
                         * np.cos(yy / 13.0 - c) for c in range(3)], -1)
        noisy = base + rng.normal(0, 20, base.shape)
        rows.append(rgbToYuv420(np.clip(noisy, 0, 255).astype(np.uint8)))
    return np.stack(rows)


@pytest.mark.parametrize("name,n,src_hw,out_hw,scale,offset,tol", YUV_CASES,
                         ids=[c[0] for c in YUV_CASES])
def test_yuv420_plain_matches_jax(name, n, src_hw, out_hw, scale, offset,
                                  tol):
    x = _packed(n, src_hw)
    before = infeed.yuv420_launches
    got = infeed.fused_yuv420_resize_normalize(
        torch.from_numpy(x), src_hw, out_hw, scale, offset)
    got_u8 = infeed.fused_yuv420_resize_normalize(
        torch.from_numpy(x), src_hw, out_hw, scale, offset,
        out_dtype=torch.uint8)
    assert infeed.yuv420_launches == before  # CPU tensors: plain version
    ref = np.asarray(jax_infeed.fused_yuv420_resize_normalize(
        x, src_hw, out_hw, scale=scale, offset=offset))
    got, got_u8 = got.numpy(), got_u8.numpy()
    assert got.shape == got_u8.shape == (n, *out_hw, 3)
    assert (got.dtype, got_u8.dtype) == (np.float32, np.uint8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    # the uint8 form is round(jax) (half to even, clipped), except where
    # the value sits at a tie: there the two sums may round either way
    ref_u8 = np.clip(np.round(ref), 0, 255).astype(np.uint8)
    tie = np.abs(np.abs(got - np.floor(got)) - 0.5) < TIE
    diff = got_u8.astype(int) - ref_u8.astype(int)
    np.testing.assert_array_equal(diff[~tie], 0)
    assert np.abs(diff).max() <= 1
    if scale == 1.0:   # the 0..255 cases clip some pixels at both ends
        assert (ref == 0).any() and (ref == 255).any()


def test_yuv420_unpack_errors_match_jax():
    ok = np.zeros((2, 24 * 24 * 3 // 2), np.uint8)
    for hw, rows in (((23, 24), ok), ((24, 0), ok), ((0, 0), ok),
                     ((24, 24), ok[:, :-1]), ((24, 26), ok)):
        with pytest.raises(ValueError) as jax_err:
            jax_infeed.yuv420_unpack(rows, hw)
        with pytest.raises(ValueError) as err:
            infeed.yuv420_unpack(torch.from_numpy(rows), hw)
        assert str(err.value) == str(jax_err.value)
    y, cb, cr = infeed.yuv420_unpack(torch.from_numpy(_packed(2, (24, 24))),
                                     (24, 24))
    assert (y.shape, cb.shape, cr.shape) == ((2, 24, 24, 1), (2, 12, 12, 1),
                                             (2, 12, 12, 1))


def test_yuv420_wrapper_rejects_other_dtypes_and_ranks():
    x = torch.zeros(2, 24 * 24 * 3 // 2, dtype=torch.uint8)
    with pytest.raises(TypeError):
        infeed.fused_yuv420_resize_normalize(x.float(), (24, 24), (8, 8))
    with pytest.raises(TypeError):
        infeed.fused_yuv420_resize_normalize(x, (24, 24), (8, 8),
                                             out_dtype=torch.float16)
    with pytest.raises(ValueError):
        infeed.fused_yuv420_resize_normalize(x[0], (24, 24), (8, 8))
    with pytest.raises(ValueError):
        infeed.fused_yuv420_resize_normalize(x, (24, 24), (0, 8))


# geometries of K2's plan, with the column tiles each needs: the chip
# smoke's cases (the headline upsample, the RGB main path's source,
# bench.py's full-resolution shape, phone photos, a small odd output), and
# a 1600-wide strip cut to 64 columns, a 25x horizontal downscale whose
# full-width row pass does not fit the budget
YUV_PLAN_CASES = [
    ((150, 150), (299, 299), 1), ((512, 512), (299, 299), 1),
    ((298, 298), (299, 299), 1), ((3024, 4032), (299, 299), 38),
    ((46, 62), (23, 37), 1), ((24, 24), (24, 24), 1),
    ((16, 1600), (2, 64), 4),
]
YUV_PLAN_IDS = [f"{s[0]}x{s[1]}to{d[0]}x{d[1]}" for s, d, _ in YUV_PLAN_CASES]


@pytest.mark.parametrize("src,dst,tiles", YUV_PLAN_CASES, ids=YUV_PLAN_IDS)
def test_yuv420_plan_stages_every_nonzero_weight_within_budget(src, dst,
                                                               tiles):
    for itemsize in (1, 4):   # uint8 and float32 output
        plan = infeed.yuv420_plan(*src, *dst, out_itemsize=itemsize)
        assert plan.smem <= infeed.YUV420_SMEM_BUDGET
        assert plan.smem == infeed._yuv420_smem_bytes(
            plan.tile_w, dst[1], plan.luma, plan.chroma, plan.staged,
            itemsize)
        assert len(plan.luma.tiles) == tiles
        # one tile stages its bands' uint8 output when that fits too
        assert plan.staged == (tiles == 1 and itemsize == 1 and
                               infeed._yuv420_smem_bytes(
                                   plan.tile_w, dst[1], plan.luma,
                                   plan.chroma, True, itemsize)
                               <= infeed.YUV420_SMEM_BUDGET)
        for p, (sh, sw) in ((plan.luma, src),
                            (plan.chroma, (src[0] // 2, src[1] // 2))):
            assert len(p.bands) == -(-dst[0] // infeed.YUV420_ROWS)
            assert len(p.tiles) == -(-dst[1] // plan.tile_w)
            spans = np.ptp(p.tiles, axis=1)
            # a slot keeps its row's offset in its 16-byte chunk: up to 15
            # bytes before the widest tile's row
            assert p.pitch % 16 == 0 and p.pitch >= 15 + int(spans.max())
            # the ring holds the band being computed and the next one's
            # rows; a band starts where the one before ended or earlier,
            # so a continuing band's new rows follow the last loaded
            assert p.depth >= 2 * int(np.ptp(p.bands, axis=1).max())
            assert (p.bands[1:, 0] <= p.bands[:-1, 1]).all()
            # every column a tile's padded taps read is in its row-pass
            # results, computed in whole chunks
            taps = p.col_weights.shape[1]
            tile = np.arange(dst[1]) // plan.tile_w
            assert taps % 2 == 0
            assert p.t_pitch % infeed.YUV420_CHUNK == 0
            assert p.t_pitch >= int(spans.max())
            assert ((p.col_lo - p.tiles[tile, 0] + taps) <= p.t_pitch).all()
            for src_n, dense, lo, hi, weights, spans_, step in (
                    (sh, infeed.bilinear_weight_matrix(sh, dst[0]),
                     p.row_lo, p.row_hi, p.row_weights, p.bands,
                     infeed.YUV420_ROWS),
                    (sw, infeed.bilinear_weight_matrix(sw, dst[1]),
                     p.col_lo, p.col_hi, p.col_weights, p.tiles,
                     plan.tile_w)):
                # each output's taps hold every nonzero weight, in order,
                # with zeros past its count; its band or tile stages them
                for o in range(dense.shape[0]):
                    nt = hi[o] - lo[o]
                    np.testing.assert_array_equal(weights[o, :nt],
                                                  dense[o, lo[o]:hi[o]])
                    assert not weights[o, nt:].any()
                    assert not dense[o, :lo[o]].any()
                    assert not dense[o, hi[o]:].any()
                block = np.arange(dense.shape[0]) // step
                start, stop = spans_[block, 0], spans_[block, 1]
                assert (0 <= start).all() and (stop <= src_n).all()
                assert (start <= lo).all() and (hi <= stop).all()


def _column_units(rows, cols, fast):
    """(row, column) of each column-pass output in the kernel's thread
    mapping. ``fast``: thread ``tid`` takes column ``tid`` and every row.
    Otherwise thread ``tid`` starts at unit ``tid`` of ``rows * cols``
    and steps by YUV420_THREADS units, carrying columns into rows without
    dividing."""
    threads = infeed.YUV420_THREADS
    got = []
    for tid in range(threads):
        if fast:
            got += [(r, tid) for r in range(rows)] if tid < cols else []
            continue
        dr, dx = threads // cols, threads % cols
        r, xl = tid // cols, tid % cols
        for u in range(tid, rows * cols, threads):
            assert (r, xl) == divmod(u, cols)
            got.append((r, xl))
            xl += dx
            r += dr
            if xl >= cols:
                xl -= cols
                r += 1
    return got


def _run_yuv420_plan(x, plan, src_hw, out_hw, scale, offset, grid,
                     out_dtype=np.float32, x_addr=0, out_addr=0, seed=11):
    """K2's schedule in numpy, for ``grid`` persistent blocks and a
    tensor and an output at byte addresses ``x_addr`` and ``out_addr``.
    Work items (image, tile, band; bands fastest) are handed out one at a
    time: block b takes items b and b + grid, then the queue hands each
    next item to whichever block asks (drawn from ``seed``). A block's
    loader runs two items in front, issued once an item's row pass is
    done: it copies an item's source rows into each plane's ring after
    the last item's, in 16-byte chunks from the row's own offset in its
    chunk (bytes where the tensor's edge cuts a chunk) into slots that
    start as garbage, its row taps into the buffer of its parity, and its
    tile's column weights (zero past the tile) and first columns into the
    column buffer (one for a one-tile plan, else by item number mod 3).
    The row pass
    walks each output row's own taps over chunks of columns, checking
    that every slot and buffer it reads still holds its own; the column
    pass takes the tile's zero-padded column taps, every output once in
    the kernel's thread mapping; a one-tile uint8 plan stages each band's
    output at the output's offset in its 16-byte chunk and writes it out,
    before the next item's row pass, by whole chunks and bytes at the
    ends. Sums are fp32 over ascending sources."""
    H, W = src_hw
    h, w = out_hw
    n = x.shape[0]
    R = infeed.YUV420_ROWS
    f32 = np.float32
    flat = np.ascontiguousarray(x).reshape(-1)
    row_bytes = H * W * 3 // 2
    # ring: (plane plan, the plane's offset in a packed row, row stride)
    rings = {"y": (plan.luma, 0, W),
             "cb": (plan.chroma, H * W, W // 2),
             "cr": (plan.chroma, H * W + (H // 2) * (W // 2), W // 2)}
    groups = {"y": ("y",), "c": ("cb", "cr")}
    n_bands, n_tiles = len(plan.luma.bands), len(plan.luma.tiles)
    items = n * n_tiles * n_bands
    assert 1 <= grid <= items
    itemsize = np.dtype(out_dtype).itemsize
    taps = (plan.luma.col_weights.shape[1], plan.chroma.col_weights.shape[1])
    fast = plan.tile_w <= infeed.YUV420_THREADS and taps in ((2, 2), (4, 2))
    out = np.zeros(n * h * w * 3 * itemsize, np.uint8)
    written = np.zeros(out.size, int)
    rng = np.random.default_rng(seed)

    # which items each block takes
    taken = [[b] + ([b + grid] if b + grid < items else [])
             for b in range(grid)]
    for i in range(2 * grid, items):
        taken[rng.integers(grid)].append(i)

    def finish(rgb):   # clip, affine, and for uint8 the round
        v = np.clip(rgb, 0, 255).astype(f32)
        if scale != 1.0 or offset != 0.0:
            v = (v * f32(scale)).astype(f32) + f32(offset)
        if out_dtype == np.uint8:
            return np.clip(np.rint(v), 0, 255).astype(np.uint8)
        return v.astype(f32)

    def copy_out(stage, img, band):
        """The kernel's copy-out of a staged band: a whole 16-byte chunk
        of the output in one store, the ragged ends byte by byte."""
        y0 = band * R
        nb = min(R, h - y0) * w * 3 * itemsize
        base = (img * h + y0) * w * 3 * itemsize
        head = (out_addr + base) & 15
        for b0 in range(0, head + nb, 16):
            lo, hi = max(b0, head), min(b0 + 16, head + nb)
            # a whole chunk in one 16-byte store, else the band's bytes
            assert (lo, hi) == (b0, b0 + 16) or b0 in (0, (head + nb - 1)
                                                        // 16 * 16)
            out[base - head + lo:base - head + hi] = stage[lo:hi]
            written[base - head + lo:base - head + hi] += 1

    for b in range(grid):
        # each ring is flat bytes, with garbage past its last slot (the
        # kernel reads on into the next region of shared memory)
        ring = {k: rng.integers(0, 256, p.depth * p.pitch + 64, np.uint8)
                for k, (p, _, _) in rings.items()}
        held = {k: [None] * p.depth for k, (p, _, _) in rings.items()}
        nexts = {key: 0 for key in groups}   # slot after the last row loaded
        tap_buffers = [None, None]           # the band each buffer holds
        col_buffers = [None, None, None]     # the tile each buffer holds
        loads = iter(taken[b])
        placed = []   # (img, tile, band, {ring: slot of the band's row 0})

        def load_next():
            i = next(loads, None)
            if i is None:
                return
            band, rest = i % n_bands, i // n_bands
            img, tile = rest // n_tiles, rest % n_tiles
            slots = {}
            for key, names in groups.items():
                p = rings[names[0]][0]
                vlo, ve = p.bands[band]
                # the item's rows follow the last item's; a band spans at
                # most half the ring, so no division is needed
                slot0 = nexts[key]
                assert ve - vlo <= p.depth // 2
                nexts[key] = (slot0 + ve - vlo) % p.depth
                cs, ce = p.tiles[tile]
                for name in names:
                    _, off, stride = rings[name]
                    slots[name] = slot0
                    for v in range(vlo, ve):
                        slot = (slot0 + v - vlo) % p.depth
                        src = img * row_bytes + off + v * stride + cs
                        head = (x_addr + src) & 15
                        dst = slot * p.pitch
                        assert head + ce - cs <= p.pitch
                        for c0 in range(0, head + ce - cs, 16):
                            g = src - head + c0
                            if 0 <= g and g + 16 <= flat.size:
                                seg = slice(c0, c0 + 16)
                            else:   # the row's bytes only
                                seg = slice(max(c0, head),
                                            min(c0 + 16, head + ce - cs))
                            ring[name][dst + seg.start:dst + seg.stop] = \
                                flat[src - head + seg.start:
                                     src - head + seg.stop]
                        held[name][slot] = (img, tile, v)
            tap_buffers[len(placed) & 1] = band
            if n_tiles > 1 or not placed:
                col_buffers[len(placed) % 3 if n_tiles > 1 else 0] = tile
            placed.append((img, tile, band, slots))

        load_next()
        load_next()
        stage = rng.integers(0, 256, 16 + R * w * 3 * itemsize, np.uint8)
        prev = None
        for i in range(len(taken[b])):
            img, tile, band, slots = placed[i]
            assert tap_buffers[i & 1] == band
            y0, x0 = band * R, tile * plan.tile_w
            rows, cols = min(R, h - y0), min(plan.tile_w, w - x0)
            if plan.staged and prev is not None:
                copy_out(stage, *prev)
            # row pass: each output row's own taps, all chunks at once
            t = {}
            for name, (p, off, stride) in rings.items():
                t[name] = np.zeros((R, p.t_pitch), f32)
                for k in range(rows):
                    lo, hi = p.row_lo[y0 + k], p.row_hi[y0 + k]
                    for j in range(hi - lo):
                        slot = slots[name] + lo + j - p.bands[band, 0]
                        assert slot < 2 * p.depth
                        slot %= p.depth
                        assert held[name][slot] == (img, tile, lo + j)
                        src = (img * row_bytes + off + (lo + j) * stride
                               + p.tiles[tile, 0])
                        at = slot * p.pitch + ((x_addr + src) & 15)
                        t[name][k] += (f32(p.row_weights[y0 + k, j])
                                       * ring[name][at:at + p.t_pitch])
            # item i + 2, once item i's rows and row taps are done with
            load_next()
            # column pass from the item's column buffer: the tile's column
            # taps, zero-padded, and its first columns
            assert col_buffers[i % 3 if n_tiles > 1 else 0] == tile
            cw, cl = {}, {}
            for key, p in (("y", plan.luma), ("c", plan.chroma)):
                cw[key] = np.zeros((p.col_weights.shape[1], plan.tile_w), f32)
                cw[key][:, :cols] = p.col_weights[x0:x0 + cols].T
                cl[key] = np.zeros(plan.tile_w, np.int64)
                cl[key][:cols] = p.col_lo[x0:x0 + cols] - p.tiles[tile, 0]
            units = _column_units(rows, cols, fast)
            assert sorted(units) == [(r, xl) for r in range(rows)
                                     for xl in range(cols)]
            sums = {}
            for key, names in groups.items():
                ntaps = cw[key].shape[0]
                idx = cl[key][:cols, None] + np.arange(ntaps)
                for name in names:
                    acc = np.zeros((R, cols), f32)
                    for j in range(ntaps):
                        acc += cw[key][j, :cols] * t[name][:, idx[:, j]]
                    sums[name] = acc[:rows]
            yv, cb, cr = (sums["y"], sums["cb"] - f32(128),
                          sums["cr"] - f32(128))
            px = finish(np.stack([
                yv + f32(infeed._CR_R) * cr,
                yv + f32(infeed._CB_G) * cb + f32(infeed._CR_G) * cr,
                yv + f32(infeed._CB_B) * cb], axis=-1))
            base = (img * h + y0) * w * 3 * itemsize
            if plan.staged:
                # at the output's offset in its 16-byte chunk
                assert x0 == 0 and cols == w and out_dtype == np.uint8
                head = (out_addr + base) & 15
                nb = rows * w * 3
                assert head + nb <= stage.size
                stage[head:head + nb] = px.reshape(-1)
                prev = (img, band)
            else:
                for r in range(rows):
                    e = (base + ((r * w + x0) * 3) * itemsize)
                    seg = px[r].reshape(-1).view(np.uint8)
                    out[e:e + seg.size] = seg
                    written[e:e + seg.size] += 1
        if plan.staged and prev is not None:
            copy_out(stage, *prev)
    assert (written == 1).all()
    return out.view(out_dtype).reshape(n, h, w, 3)


# (source hw, output hw, scale, offset): a downscale to the [-1, 1] scale,
# a small odd output, the identity, an upsample, a geometry that tiles its
# columns, and the headline's 150x150 -> 299x299
YUV_SCHEDULE_CASES = [
    ((40, 56), (24, 32), 1 / 127.5, -1.0),
    ((46, 62), (23, 37), 1.0, 0.0),
    ((24, 24), (24, 24), 1.0, 0.0),
    ((30, 20), (61, 45), 1.0, 0.0),
    ((16, 1600), (2, 64), 1.0, 0.0),
    ((150, 150), (299, 299), 1.0, 0.0),
]


@pytest.mark.parametrize("src,dst,scale,offset", YUV_SCHEDULE_CASES, ids=[
    "unit_downscale", "odd_output", "identity", "upsample",
    "tiled_columns", "headline"])
def test_yuv420_plan_schedule_reproduces_plain(src, dst, scale, offset):
    n = 1 if src == (150, 150) else 2
    x = _packed(n, src, seed=3)
    ref = infeed.fused_yuv420_resize_normalize_plain(
        torch.from_numpy(x), src, dst, scale, offset).numpy()
    tol = TOL_UNIT if scale != 1.0 else TOL_COUNTS
    ref_u8 = infeed.round_to_uint8(torch.from_numpy(ref)).numpy()
    for out_dtype, x_addr, out_addr in ((np.float32, 0, 0),
                                        (np.uint8, 7, 5)):
        plan = infeed.yuv420_plan(*src, *dst,
                                  np.dtype(out_dtype).itemsize)
        items = n * len(plan.luma.tiles) * len(plan.luma.bands)
        # one block takes every item; a few blocks take items from the
        # queue; one block an item
        for grid in sorted({1, min(3, items), items}):
            got = _run_yuv420_plan(x, plan, src, dst, scale, offset, grid,
                                   out_dtype, x_addr, out_addr)
            if out_dtype == np.float32:
                np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
            else:   # a tie may round either way with the summation order
                assert np.abs(got.astype(int) - ref_u8).max() <= 1


def test_yuv420_plan_rejects_odd_sources_and_steep_downscales():
    with pytest.raises(ValueError, match="even"):
        infeed.yuv420_plan(151, 150, 299, 299)
    # 8 rows of fp32 row-pass results for Y and both chroma planes fit 48 KB
    # only while one output column's luma taps span at most ~768 source
    # columns; at 1024 -> 1 and 4096 -> 8 they span over 1000
    for src, dst in (((2, 1024), (1, 1)), ((2, 4096), (2, 8))):
        with pytest.raises(ValueError, match="shared memory"):
            infeed.yuv420_plan(*src, *dst)


def test_yuv420_ctypes_args_match_the_kernels_structs(tmp_path):
    """The ctypes mirror of K2's launch arguments lays its fields out as
    the kernel's C structs do (compiled here with the host compiler; the
    launcher also refuses a size mismatch on the card)."""
    from sparkdl_tpu_torch.ops import _build
    src = open(os.path.join(_build.CSRC_DIR,
                            "yuv420_resize_normalize.cu")).read()
    structs = src[src.index("struct Plane {"):src.index("namespace {")]
    fields = [(name, "Args", name) for name, _ in infeed._Yuv420Args._fields_]
    fields += [(f"luma.{name}", "Args", f"luma.{name}")
               for name, _ in infeed._Plane._fields_]
    prog = tmp_path / "layout.cpp"
    prog.write_text(
        "#include <cstddef>\n#include <cstdio>\n" + structs +
        "int main() {\n  std::printf(\"%zu\\n\", sizeof(Args));\n" +
        "".join(f'  std::printf("%zu\\n", offsetof({t}, {f}));\n'
                for _, t, f in fields) + "}\n")
    exe = tmp_path / "layout"
    subprocess.run(["g++", "-std=c++17", str(prog), "-o", str(exe)],
                   check=True, capture_output=True, timeout=60)
    got = [int(v) for v in subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()]
    luma = infeed._Yuv420Args.luma.offset
    want = [ctypes.sizeof(infeed._Yuv420Args)]
    want += [getattr(infeed._Yuv420Args, n).offset
             for n, _ in infeed._Yuv420Args._fields_]
    want += [luma + getattr(infeed._Plane, n).offset
             for n, _ in infeed._Plane._fields_]
    assert got == want
