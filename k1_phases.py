#!/usr/bin/env python3
"""Where the CUDA resize kernel's time goes: variant builds of
``sparkdl_tpu_torch/ops/csrc/resize_normalize.cu``, each with some of its
phases cut out, timed on one NVIDIA GPU at the main path's shape
(64×512×512×3 uint8 → 299×299).

    python3 k1_phases.py          # from the root of a checkout

Each variant is the kernel's source with textual cuts. Every cut must
match the source exactly once, so an edited kernel stops this script
instead of timing the wrong thing. All variants are built at once, by
nvcc with the flags of ``ops/_build.py``, into
``sparkdl_tpu_torch/_build/phases/``, and launched with the plan, the
arguments and the grid that ``ops/infeed.py`` gives the kernel. A variant
that cuts a phase computes garbage; only ``full`` is held to the plain
version. Each time is the mean of 20 launches replayed from a CUDA graph
(device time), taken twice: the variants in order, then in reverse.

Prints one JSON line per variant, a summary line with each phase's share
of ``full``, and last the card's name and power limit as nvidia-smi gives
them. Exits non-zero without CUDA, or if a cut or a build fails or
``full`` disagrees with the plain version.
"""

import json
import os
import subprocess
import sys

import chip_smoke

# what each cut removes, as (text in the kernel, replacement)
CUTS = {
    # the loader's copies into the ring (cp.async and plain loads)
    "loads": ("      issue(s);\n", ""),
    # the row pass: no t element is computed
    "row_pass": ("q < q_lo + nq; q += kThreads", "q < q_lo; q += kThreads"),
    # the column pass's tap loop: each output is stored as `offset`
    "column_taps": ("for (int i0 = 0; i0 < nt; i0 += 4)",
                    "for (int i0 = 0; i0 < 0; i0 += 4)"),
    # the whole column pass, its stores included
    "column_pass": ("for (int j = tid; j < jn; j += kThreads)",
                    "for (int j = tid; j < 0; j += kThreads)"),
}
VARIANTS = {
    "full": (),
    "no_loads": ("loads",),
    "no_row_pass": ("row_pass",),
    "no_column_taps": ("column_taps",),
    "no_column_pass": ("column_pass",),
    "loads_only": ("row_pass", "column_pass"),
    "stores_only": ("loads", "row_pass", "column_taps"),
    # what is left: the item loop, its barriers and bookkeeping
    "skeleton": ("loads", "row_pass", "column_pass"),
}


def variant_source(text, cuts):
    for cut in cuts:
        old, new = CUTS[cut]
        if text.count(old) != 1:
            raise RuntimeError(f"cut {cut!r}: {old!r} occurs "
                               f"{text.count(old)} times in the kernel")
        text = text.replace(old, new)
    return text


def build_all(_build):
    """Builds every variant at once; returns {name: library path}."""
    with open(os.path.join(_build.CSRC_DIR, "resize_normalize.cu")) as f:
        text = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in VARIANTS.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, cuts))
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = lib
    if failed:
        raise RuntimeError("variant builds failed:\n" + "\n".join(failed))
    return libs


def main():
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("k1_phases: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from sparkdl_tpu_torch.ops import _build, infeed

    smi = chip_smoke.nvidia_smi()
    paths = build_all(_build)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, chip_smoke.MAIN_SHAPE, generator=gen,
                      dtype=torch.uint8).cuda()
    n, src_h, src_w, c = x.shape
    h, w = chip_smoke.MAIN_OUT
    plan, arrays, slots = infeed._device_plan(
        src_h, h, src_w, w, c, 1, infeed.ROWS, x.device)
    bw, h_lo, h_hi, ww_, w_lo, w_hi = arrays
    grid = infeed._grid(plan, n, slots)
    ref = infeed.fused_resize_normalize_plain(x, (h, w))
    argtypes = infeed._library().resize_normalize_launch.argtypes

    launchers, occupancy = {}, {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.resize_normalize_launch.argtypes = argtypes
        lib.resize_normalize_launch.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.resize_normalize_occupancy.argtypes = [ctypes.c_int] * 3 + [ip] * 3
        vals = [ctypes.c_int(0) for _ in range(3)]
        err = lib.resize_normalize_occupancy(
            1, plan.rows, plan.smem, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"{name}: occupancy query failed ({err})")
        occupancy[name] = {"blocks_per_sm": vals[0].value,
                           "registers": vals[1].value,
                           "local_bytes": vals[2].value}

        def launch(fn=lib.resize_normalize_launch, name=name):
            out = torch.empty((n, h, w, c), dtype=torch.float32,
                              device=x.device)
            err = fn(x.data_ptr(), 1, x.numel(), bw.data_ptr(),
                     h_lo.data_ptr(), h_hi.data_ptr(), bw.shape[1],
                     ww_.data_ptr(), w_lo.data_ptr(), w_hi.data_ptr(),
                     out.data_ptr(), n, src_h, src_w, c, h, w, plan.rows,
                     plan.tile_w, plan.depth, plan.pitch, plan.smem, grid,
                     1.0, 0.0, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed ({err})")
            return out
        launchers[name] = launch

    full_err = (launchers["full"]() - ref).abs().max().item()
    if not full_err <= chip_smoke.BOUND_COUNTS:
        raise AssertionError(f"full variant: max|diff| {full_err} > "
                             f"{chip_smoke.BOUND_COUNTS}")
    order = list(VARIANTS)
    runs = {name: [] for name in order}
    for names in (order, order[::-1]):
        for name in names:
            runs[name].append(chip_smoke.time_ms(launchers[name],
                                                 graph=True))
    device_ms = {name: sum(r) / len(r) for name, r in runs.items()}
    for name in order:
        print(json.dumps({
            "variant": name, "cuts": list(VARIANTS[name]),
            "device_ms": device_ms[name], "device_ms_runs": runs[name],
            **occupancy[name]}), flush=True)
    full = device_ms["full"]
    print(json.dumps({
        "shape": list(chip_smoke.MAIN_SHAPE),
        "out_hw": list(chip_smoke.MAIN_OUT), "rows": plan.rows,
        "tile_w": plan.tile_w, "smem_bytes": plan.smem, "grid": grid,
        "full_max_abs_err": full_err,
        "share_of_full": {name: device_ms[name] / full for name in order}}),
        flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
