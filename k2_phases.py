#!/usr/bin/env python3
"""Where the CUDA 4:2:0 kernel's time goes: variant builds of
``sparkdl_tpu_torch/ops/csrc/yuv420_resize_normalize.cu``, each with some
of its phases cut out, timed on one NVIDIA GPU at the headline shape
(64 packed 150×150 4:2:0 rows → 299×299 RGB, uint8 and fp32 out).

    python3 k2_phases.py          # from the root of a checkout

Each variant is the kernel's source with textual cuts. The script knows
the cuts of two designs of the kernel (one block per work item, and
persistent blocks over a ring); it takes the design all of whose cuts
match the checkout's source exactly once, so an edited kernel stops it
instead of timing the wrong thing. All variants are built at once, by
nvcc with the flags of ``ops/_build.py``, into
``sparkdl_tpu_torch/_build/phases/``, and launched through the wrapper
``ops/infeed.py::fused_yuv420_resize_normalize`` with the variant's
library in place of the kernel's, so each runs with the plan, arguments
and grid the main path gives the kernel. A variant that cuts a phase
computes garbage; only ``full`` is held to the plain version. Each time
is the mean of 20 launches replayed from a CUDA graph (device time),
taken twice: the variants in order, then in reverse.

Then ``full`` alone at batches of 16 to 256 rows, to split its time into
a part that grows with the batch and a part that does not (the launch,
the pipeline's fill and drain): per 64 images, the slope between the two
largest batches; fixed, the time at 64 less that.

Prints one JSON line per variant, a summary line with each phase's share
of ``full``, the batch sweep, and last the card's name and power limit as
nvidia-smi gives them. Exits non-zero without CUDA, or if no design's
cuts match, a build fails or ``full`` disagrees with the plain version.
"""

import json
import os
import subprocess
import sys

import chip_smoke

SOURCE = "yuv420_resize_normalize.cu"
N = 64  # the headline's batch
BATCHES = (16, 32, 64, 128, 256)  # the batch sweep of the full kernel

# what each cut removes, per design: cut name -> [(text in the kernel,
# replacement), ...]; every text must occur exactly once
CUTS = {
    # one block per (image, tile, band): row pass straight from device
    # memory, then the column pass, colour math and per-pixel stores
    "one_block_per_item": {
        # the source bytes: the row pass multiplies a constant
        "loads": [("xv[m] = m < live ? (float)__ldg(px + m) : 0.f;",
                   "xv[m] = m < live ? 1.f : 0.f;")],
        # the row pass: no row-pass result is computed
        "row_pass": [("for (int q = tid; q < yq + 2 * cq; q += kThreads)",
                      "for (int q = tid; q < 0; q += kThreads)")],
        # the column pass's tap loops: every sum stays 0
        "column_taps": [("for (int i = 0; i < ynt; ++i)",
                         "for (int i = 0; i < 0; ++i)"),
                        ("for (int i = 0; i < cnt; ++i)",
                         "for (int i = 0; i < 0; ++i)")],
        # BT.601 inverse, clip, affine and round: the sums are stored
        "colour": [("      const float cbk = __fsub_rn(cb[k], 128.f);\n"
                    "      const float crk = __fsub_rn(cr[k], 128.f);\n"
                    "      float rgb[3];\n",
                    "      float rgb[3] = {yv[k], cb[k], cr[k]};\n"),
                   ("      rgb[0] = __fadd_rn(yv[k], "
                    "__fmul_rn(a.cr_r, crk));\n"
                    "      rgb[1] = __fadd_rn(__fadd_rn(yv[k], "
                    "__fmul_rn(a.cb_g, cbk)),\n"
                    "                         __fmul_rn(a.cr_g, crk));\n"
                    "      rgb[2] = __fadd_rn(yv[k], "
                    "__fmul_rn(a.cb_b, cbk));\n",
                    ""),
                   ("const float v = __fadd_rn(\n"
                    "            __fmul_rn(fminf(fmaxf(rgb[c], 0.f), 255.f), "
                    "a.scale), a.offset);",
                    "const float v = rgb[c];"),
                   ("(uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);",
                    "(uint8_t)v;")],
        # the output stores: computed, but stored only for a value that
        # never occurs, so the compiler keeps the work
        "stores": [("          static_cast<uint8_t*>(a.out)[o + c] =",
                    "          if (v == 1e30f) "
                    "static_cast<uint8_t*>(a.out)[o + c] ="),
                   ("          static_cast<float*>(a.out)[o + c] = v;",
                    "          if (v == 1e30f) "
                    "static_cast<float*>(a.out)[o + c] = v;")],
    },
    # persistent blocks over a cp.async ring of source rows, a row pass by
    # each output row's own taps, a column pass of one column and all
    # rows a thread (compile-time taps) or of (row, column) units, and a
    # one-tile band's output staged and written in 16-byte stores
    "persistent": {
        # the loader's copies of source rows into the rings: the row pass
        # reads whatever the rings hold
        "loads": [("    if (ch >= (head + nbytes + 15) >> 4) return;",
                   "    return;")],
        # the row pass: no row-pass result is computed
        "row_pass": [("for (int u = tid; u < units; u += kThreads)",
                      "for (int u = tid; u < 0; u += kThreads)")],
        # the column pass's multiply-adds (and so its weight and t loads):
        # every sum stays 0
        "column_taps": [("yv = fmaf(wy[i], ty[(k0 + k) * tp_y + i], yv);",
                         ";"),
                        ("              cb = fmaf(wc[i], c.x, cb);\n"
                         "              cr = fmaf(wc[i], c.y, cr);\n", ""),
                        ("for (int i = 0; i < a.luma.col_taps; ++i)",
                         "for (int i = 0; i < 0; ++i)"),
                        ("for (int i = 0; i < a.chroma.col_taps; ++i)",
                         "for (int i = 0; i < 0; ++i)")],
        # BT.601 inverse, clip, affine and round: the sums are stored
        "colour": [("            colour<kU8, kAffine>(a, yv, cb, cr, v[k]);",
                    "            v[k][0] = yv, v[k][1] = cb, v[k][2] = cr;"),
                   ("        colour<kU8, kAffine>(a, yv, cb, cr, v);",
                    "        v[0] = yv, v[1] = cb, v[2] = cr;")],
        # the output stores and the staged copy-out: computed, but stored
        # only under a condition that never holds, so the compiler keeps
        # the work
        "stores": [("if (k0 + k < rows) put(",
                    "if (a.h < 0) put("),
                   ("        put(dst + r * pitch + xl * 3, v);",
                    "        if (a.h < 0) put(dst + r * pitch + xl * 3, v);"),
                   ("for (int ch = c0 + tid; ch < c1; ch += kThreads)",
                    "for (int ch = c0 + tid; ch < 0; ch += kThreads)"),
                   ("    if (warp == kWarps - 2) {", "    if (warp < 0) {")],
    },
}
VARIANTS = {
    "full": (),
    "no_loads": ("loads",),
    "no_row_pass": ("row_pass",),
    "no_column_taps": ("column_taps",),
    "no_colour": ("colour",),
    "no_stores": ("stores",),
    "stores_only": ("loads", "row_pass", "column_taps", "colour"),
    # what is left: the block's start, its index loads, barriers and loops
    "skeleton": ("loads", "row_pass", "column_taps", "colour", "stores"),
}


def design_of(text):
    """The design whose cuts all match ``text`` exactly once."""
    misses = {}
    for design, cuts in CUTS.items():
        bad = [f"{cut!r}: {old!r} occurs {text.count(old)} times"
               for cut, pairs in cuts.items() for old, _ in pairs
               if text.count(old) != 1]
        if not bad:
            return design
        misses[design] = bad
    raise RuntimeError("no design's cuts match the kernel: " + "; ".join(
        f"{d}: {', '.join(b)}" for d, b in misses.items()))


def variant_source(text, design, cuts):
    for cut in cuts:
        for old, new in CUTS[design][cut]:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {cut!r}: {old!r} occurs "
                                   f"{text.count(old)} times in the kernel")
            text = text.replace(old, new)
    return text


def build_all(_build):
    """Builds every variant at once; returns ({name: library path},
    design, {name: ptxas lines})."""
    with open(os.path.join(_build.CSRC_DIR, SOURCE)) as f:
        text = f.read()
    design = design_of(text)
    out_dir = os.path.join(_build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        src = os.path.join(out_dir, f"yuv420_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, design, cuts))
        lib = os.path.join(out_dir, f"yuv420_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, ptxas, failed = {}, {}, []
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = lib
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    if failed:
        raise RuntimeError("variant builds failed:\n" + "\n".join(failed))
    return libs, design, ptxas


def main():
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("k2_phases: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from sparkdl_tpu_torch.ops import _build, infeed

    smi = chip_smoke.nvidia_smi()
    paths, design, ptxas = build_all(_build)
    src_hw, out_hw = chip_smoke.HEADLINE_SRC, chip_smoke.MAIN_OUT
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (N, src_hw[0] * src_hw[1] * 3 // 2),
                      generator=gen, dtype=torch.uint8).cuda()
    ref = infeed.fused_yuv420_resize_normalize_plain(x, src_hw, out_hw)
    dtypes = {"u8": torch.uint8, "f32": torch.float32}
    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}

    def use(name):
        # the wrapper loads its library through _build.load, which
        # returns what it has loaded under the kernel's name
        with _build._lock:
            _build._loaded[infeed.KERNEL_YUV420] = libs[name]

    def launcher(dtype):
        def launch():
            return infeed.fused_yuv420_resize_normalize(
                x, src_hw, out_hw, out_dtype=dtype)
        return launch

    use("full")
    full = launcher(torch.float32)()
    full_u8 = launcher(torch.uint8)()
    torch.cuda.synchronize()
    full_err = (full - ref).abs().max().item()
    own = int((full_u8 != infeed.round_to_uint8(full)).sum().item())
    if not (full_err <= chip_smoke.BOUND_COUNTS and own == 0):
        raise AssertionError(f"full variant: max|diff| {full_err} > "
                             f"{chip_smoke.BOUND_COUNTS} or uint8 != "
                             f"rint(own fp32) at {own} values")
    launch = {}
    for name in VARIANTS:
        use(name)
        launch[name] = {
            key: infeed.yuv420_launch_config(x, src_hw, out_hw, dtype)
            for key, dtype in dtypes.items()}
    order = list(VARIANTS)
    runs = {(name, key): [] for name in order for key in dtypes}
    for names in (order, order[::-1]):
        for name in names:
            use(name)
            for key, dtype in dtypes.items():
                runs[name, key].append(chip_smoke.time_ms(launcher(dtype),
                                                          graph=True))
    device_ms = {k: sum(r) / len(r) for k, r in runs.items()}
    for name in order:
        print(json.dumps({
            "variant": name, "cuts": list(VARIANTS[name]),
            **{f"device_ms_{key}": device_ms[name, key] for key in dtypes},
            **{f"device_ms_{key}_runs": runs[name, key] for key in dtypes},
            "launch": launch[name], "ptxas": ptxas[name]}), flush=True)
    print(json.dumps({
        "design": design, "n": N, "src_hw": list(src_hw),
        "out_hw": list(out_hw), "full_max_abs_err": full_err,
        "share_of_full": {
            key: {name: device_ms[name, key] / device_ms["full", key]
                  for name in order} for key in dtypes}}), flush=True)
    use("full")
    sweep = {}
    for key, dtype in dtypes.items():
        times = {}
        for n in BATCHES:
            xb = torch.randint(0, 256, (n, x.shape[1]), generator=gen,
                               dtype=torch.uint8).cuda()
            times[n] = chip_smoke.time_ms(
                lambda: infeed.fused_yuv420_resize_normalize(
                    xb, src_hw, out_hw, out_dtype=dtype), graph=True)
        per_64 = (times[BATCHES[-1]] - times[BATCHES[-2]]) * 64 / (
            BATCHES[-1] - BATCHES[-2])
        sweep[key] = {"device_ms": times, "per_64_images_ms": per_64,
                      "fixed_ms": times[N] - per_64 * N / 64}
    print(json.dumps({"batch_sweep": sweep}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
