"""The port's resize op (``sparkdl_tpu_torch.ops.infeed``) against the JAX
package's (``sparkdl_tpu.ops.infeed``) on the CPU: the same numpy-seeded
inputs through both, the JAX side through its XLA path and through the
Pallas kernel in interpret mode (as tests/test_ops.py runs it).

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version tested here."""

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
# shared memory, checked on the CPU. The geometries: the main path, an
# upscale, the identity, the small cases, and phone photos to 299.
PLAN_GEOMETRIES = [
    ((512, 512), (299, 299)), ((150, 150), (299, 299)),
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
# chip smoke's small cases and its two tall images, whose steep vertical
# downscales shorten the bands (to 2 rows within the budget, to 1 in up to
# 227 KB), and two downscales with a budget so small that the plan tiles
# columns (the first also shortens its bands)
SCHEDULE_CASES = [
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
