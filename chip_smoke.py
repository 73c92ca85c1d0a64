#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sparkdl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each on stdout:

1. ``env``       — the card (nvidia-smi name and power limit), torch, CUDA.
2. ``build``     — builds the port's two CUDA kernels from the checkout's
                   sources with nvcc (one process each, started together),
                   with ptxas's registers and spills, and the native host
                   shim with g++; ``host`` says whether the shim built,
                   and whether with libjpeg.
3. ``kernel``    — K1 (RGB resize): holds the kernel against its plain
                   PyTorch version on the card at the main path's shapes
                   (512→299 and, ``main_224``, 512→224) and a few others
                   (a phone-photo downscale, unaligned rows, tall images
                   whose plans take shorter bands), times each case
                   beside its bound with its launch configuration (grid,
                   threads, shared memory, blocks per SM), times kernel,
                   plain version and the PyTorch library call that
                   computes the same function at both main shapes, and
                   checks and times the kernel at each band height it
                   is built for at the main and the phone-photo shapes.
4. ``kernel_yuv420`` — K2 (4:2:0 resize + colour): the same for K2 at the
                   headline shape (uint8 and fp32 output), the RGB main
                   path's source size, bench.py's full-resolution 4:2:0
                   shape, phone photos and a small odd geometry: fp32
                   against the plain version, uint8 against rint of K2's
                   own fp32 output (exactly) and of the plain version's
                   (within one count); beside the plain version's time,
                   the composition of per-plane ``F.interpolate`` and the
                   colour math (no single PyTorch call computes it); each
                   case's launch: the persistent grid, items a block,
                   ring depths, shared memory, blocks per SM, registers
                   and ptxas's spill bytes.
                   Times are CUDA events around warm calls: ``ms`` is
                   the eager call through the Python wrapper, as kernel,
                   plain version and library are all timed;
                   ``device_ms`` is the kernel's calls replayed from a
                   CUDA graph, the device's time without the host's.
5. ``featurize`` — drives K1's path through its public entry points:
                   ``DeepImageFeaturizer(modelName="InceptionV3",
                   deviceResizeFrom=(512, 512))`` over a ``DataFrame`` of
                   512 seeded 512×512 RGB images in 8 partitions: a cold
                   run, then the counted run, with the kernels' launch
                   counts set to 0 just before it and read just after;
                   cross-checks one batch against the plain resize
                   feeding the same model.
6. ``predict``   — ``DeepImagePredictor(modelName="ResNet50",
                   deviceResizeFrom=(512, 512), decodePredictions=True,
                   topK=5)`` over the same frame, cold then counted (K1
                   must launch 8 times); every row 5 float32 scores, best
                   first; the decoded rows against ``decode_predictions``
                   of an undecoded run, and one batch of probabilities
                   against the plain resize feeding the same model.
7. ``zoo``       — Xception, ResNet50, VGG16 and VGG19 at full width and
                   depth each featurize one batch of 64 of those images
                   through ``deviceResizeFrom`` (K1 once a model), against
                   the same network built in float32 on the card and fed
                   by the plain resize, within a bound counted in bf16
                   roundings.
8. ``headline``  — drives the 4:2:0 path as the JAX package's benchmark
                   headlines it: 512 seeded 150×150 textured images
                   packed as 4:2:0 rows (``rgbToYuv420``) in 8
                   partitions, through ``TensorTransformer`` over
                   ``deviceResizeModel(InceptionV3, (150, 150),
                   packedFormat="yuv420")``, batch 64: a cold run, then
                   the counted run (K2 must launch 8 times, K1 none);
                   cross-checks one batch against the plain 4:2:0 op
                   feeding the same model.
9. ``trained_predict`` — ``DeepImagePredictor(modelName="TestNet",
                   decodePredictions=True, topK=1)`` with the committed,
                   trained weights (read by the port's msgpack reader)
                   over the held-out set its provenance names: accuracy
                   at least 0.95, each decoded name the raw scores' best.
10. ``kernels``  — each kernel's launches on its paths and pass/fail.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no last line; it does the same without CUDA.
Apart from TestNet's the weights are seeded-random (no download): the
features are checked for shape, finiteness and agreement, not for
meaning.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# the port's CUDA kernels: each one's source in the repo, and the TPU
# kernel (or XLA op) it replaces
KERNEL = "resize_normalize"
KERNEL_SOURCE = "sparkdl_tpu_torch/ops/csrc/resize_normalize.cu"
KERNEL_REPLACES = "sparkdl_tpu/ops/infeed.py:96"
KERNEL_YUV420 = "yuv420_resize_normalize"
KERNEL_YUV420_SOURCE = "sparkdl_tpu_torch/ops/csrc/yuv420_resize_normalize.cu"
KERNEL_YUV420_REPLACES = "sparkdl_tpu/ops/infeed.py:152"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# fp32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

MAIN_SHAPE = (64, 512, 512, 3)
FEATURES = 2048          # InceptionV3's feature width
MAIN_OUT = (299, 299)
MAIN_OUT_224 = (224, 224)  # ResNet50's and VGG's input
N_IMAGES = 512
PARTITIONS = 8
BATCH = 64
# the headline path's source size (bench.py's packed_src)
HEADLINE_SRC = (150, 150)
# max |kernel - plain|: fp32, only the summation order differs
BOUND_COUNTS = 1e-3      # outputs on the 0..255 scale
BOUND_UNIT = 1e-5        # outputs on the [-1, 1] scale
# featurizer vs plain-resize path, as max|diff| / max|ref| over the batch:
# the two resizes may round a pixel whose value sits at .5 to different
# uint8 counts, and the model then runs in bf16
BOUND_FEATURES_REL = 2e-2
# K2's colour math after the resize: 2 subtractions, 4 multiplies and 4
# adds a pixel, then a clip (2) and the affine (2) a channel
YUV420_FLOPS_PER_PIXEL = 10 + 3 * 4
# the predict path: a ResNet50 classifier decoded to its top 5
PREDICT_MODEL = "ResNet50"
TOP_K = 5
# the zoo phase: each model featurizes one batch of the 512×512 images
ZOO_MODELS = ("Xception", "ResNet50", "VGG16", "VGG19")
ZOO_IMAGES = 64
# a zoo model in bf16 against the same network in float32, as max|diff| /
# max|ref|: each step that rounds to bf16 on the longest path (the input
# cast; each conv's output, its BatchNorm's or bias's, each residual add,
# the global pool) errs by at most half a bf16 step (2^-9) relative, and
# in the worst case these add up: ResNet50 1 + 2 + 16 × (3 × 2 + 1) + 1
# = 116 roundings; Xception 1 + 2 × 2 + 3 × (2 × 3 + 1) + 8 × (3 × 3 + 1)
# + (2 × 3 + 1) + 2 × 3 + 1 = 120 (a separable unit rounds its depthwise,
# pointwise and BatchNorm outputs); VGG16 1 + 13 × 2 + 2 × 2 = 31 and
# VGG19 1 + 16 × 2 + 2 × 2 = 37 (conv or dense output, bias)
ZOO_ROUNDINGS = {"Xception": 120, "ResNet50": 116, "VGG16": 31, "VGG19": 37}
BF16_HALF_STEP = 2.0 ** -9
# the committed TestNet on its held-out set, as the JAX package's test
TESTNET_MIN_ACCURACY = 0.95


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3, graph=False):
    """Mean ms of one ``fn()`` on the card, by CUDA events around
    ``iters`` warm calls, each result dropped before the next call (so
    the allocator reuses one output). With ``graph`` the calls are
    captured into one CUDA graph and replayed, so the time is the
    device's alone and not the Python wrapper's (a short kernel otherwise
    waits on the host)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def resize_bound_ms(x, out, infeed):
    """Least time for the resize on this card: the larger of its bytes
    (input read once, output written once) over HBM bandwidth and its
    fp32 operations on this geometry's nonzero weights over the fp32
    peak."""
    n, src_h, src_w, c = x.shape
    h, w = out.shape[1:3]
    taps = []
    for src, dst in ((src_h, h), (src_w, w)):
        lo, hi = infeed.weight_bands(infeed.bilinear_weight_matrix(src, dst))
        taps.append(int((hi - lo).sum()))
    macs = n * src_w * c * taps[0] + n * h * c * taps[1]
    flops = 2 * macs + 2 * out.numel()
    nbytes = x.numel() * x.element_size() + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def speed(bound_ms, nbytes, ms, device_ms):
    """A kernel time (eager, and from a graph) beside its bound."""
    return {"ms": ms, "device_ms": device_ms, "bound_ms": bound_ms,
            "achieved_gb_per_s": nbytes / ms * 1e-6,
            "device_gb_per_s": nbytes / device_ms * 1e-6,
            "bound_share": bound_ms / ms,
            "device_bound_share": bound_ms / device_ms}


def kernel_speed(infeed, x, out_hw, out):
    """The kernel's time on ``x`` beside its bound, and how it launches."""
    def call():
        return infeed.fused_resize_normalize(x, out_hw)
    bound_ms, bound_by, nbytes, _ = resize_bound_ms(x, out, infeed)
    return {**speed(bound_ms, nbytes, time_ms(call),
                    time_ms(call, graph=True)),
            "bound_by": bound_by, "launch": infeed.launch_config(x, out_hw)}


def check_resize_kernel(torch, infeed):
    gen = torch.Generator().manual_seed(0)
    cases = [
        ("main", MAIN_SHAPE, MAIN_OUT, 1.0, 0.0, torch.uint8, BOUND_COUNTS),
        ("small_unit", (3, 40, 56, 3), (24, 32), 1 / 127.5, -1.0,
         torch.uint8, BOUND_UNIT),
        ("upsample", (2, 150, 150, 1), (299, 299), 1.0, 0.0, torch.uint8,
         BOUND_COUNTS),
        ("fp32_input", (4, 64, 48, 3), (33, 71), 1.0, 0.0, torch.float32,
         BOUND_COUNTS),
        # phone photos to model size: the plan tiles columns
        ("large_downscale", (2, 3024, 4032, 3), MAIN_OUT, 1.0, 0.0,
         torch.uint8, BOUND_COUNTS),
        # rows of 57 bytes: no 16-byte alignment, one channel
        ("unaligned_c1", (3, 41, 57, 1), (24, 33), 1.0, 0.0, torch.uint8,
         BOUND_COUNTS),
        # steep vertical downscales: bands of 2 rows within the 100 KB
        # budget, and of 1 row in up to 227 KB
        ("tall_rows2", (1, 6000, 16, 1), (8, 16), 1.0, 0.0, torch.uint8,
         BOUND_COUNTS),
        ("tall_rows1", (1, 10000, 64, 3), (8, 32), 1.0, 0.0, torch.uint8,
         BOUND_COUNTS),
        # the main path's images to ResNet50's and VGG's input
        ("main_224", MAIN_SHAPE, MAIN_OUT_224, 1.0, 0.0, torch.uint8,
         BOUND_COUNTS),
    ]
    results = []
    inputs = {}
    for name, shape, out_hw, scale, offset, dtype, bound in cases:
        x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        if dtype == torch.float32:
            x = x.float() * (255.0 / 256.0) + torch.rand(shape, generator=gen)
        x = x.cuda()
        got = infeed.fused_resize_normalize(x, out_hw, scale, offset)
        ref = infeed.fused_resize_normalize_plain(x, out_hw, scale, offset)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all().item()) and err <= bound
        results.append({"case": name, "shape": list(shape),
                        "out_hw": list(out_hw), "dtype": str(dtype),
                        "max_abs_err": err, "bound": bound, "ok": ok,
                        **kernel_speed(infeed, x, out_hw, got)})
        if not ok:
            raise AssertionError(f"resize kernel case {name}: max|diff| "
                                 f"{err} > {bound}")
        inputs[name] = (x, out_hw, bound)
        if name == "main":
            main_err = err

    timing = main_timing(infeed, *inputs["main"][:2])
    timing_224 = main_timing(infeed, *inputs["main_224"][:2])
    # the band height: the default against the others the kernel is built
    # for, each held to the plain version and with its launch configuration
    rows_sweep = {}
    for name in ("main", "large_downscale"):
        xs, hw, bound = inputs[name]
        ref = infeed.fused_resize_normalize_plain(xs, hw)
        rows_sweep[name] = []
        for rows in infeed.KERNEL_ROWS:
            def call():
                return infeed._launch(xs, *hw, 1.0, 0.0, rows)
            err = (call() - ref).abs().max().item()
            rows_sweep[name].append({
                "rows": rows, "default": rows == infeed.ROWS,
                "max_abs_err": err, "bound": bound,
                "device_ms": time_ms(call, graph=True),
                **infeed.launch_config(xs, hw, rows)})
            if not err <= bound:
                raise AssertionError(f"resize kernel, {name} at {rows} rows "
                                     f"a band: max|diff| {err} > {bound}")
    return results, main_err, {**timing, "rows_sweep": rows_sweep,
                               "main_224": timing_224}


def main_timing(infeed, x, out_hw):
    """Kernel, plain version and library call at one of the main path's
    geometries, beside the kernel's bound."""
    import torch.nn.functional as F
    xf = x.float().permute(0, 3, 1, 2)   # NCHW view, channels_last memory

    def kernel():
        return infeed.fused_resize_normalize(x, out_hw)

    def plain():
        return infeed.fused_resize_normalize_plain(x, out_hw)

    def library():
        return F.interpolate(xf, size=out_hw, mode="bilinear",
                             antialias=True, align_corners=False)

    # in turns: plain, kernel, kernel, plain (one card, one call), all
    # eager through their Python entry points; then the kernel from a
    # CUDA graph (device time; the plain version copies its weights from
    # the host, which a graph cannot capture), and the library call
    p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                      time_ms(plain))
    d1, d2 = time_ms(kernel, graph=True), time_ms(kernel, graph=True)
    lib_ms = time_ms(library)
    lib_err = (library().permute(0, 2, 3, 1) - plain()).abs().max().item()
    bound_ms, bound_by, nbytes, flops = resize_bound_ms(x, kernel(), infeed)
    return {**speed(bound_ms, nbytes, (k1 + k2) / 2, (d1 + d2) / 2),
            "out_hw": list(out_hw), "plain_ms": (p1 + p2) / 2,
            "library_ms": lib_ms, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops, "launch": infeed.launch_config(x, out_hw),
            "ms_runs": [k1, k2], "device_ms_runs": [d1, d2],
            "plain_ms_runs": [p1, p2],
            "library_max_abs_diff_vs_plain": lib_err}


def yuv420_bound_ms(x, src_hw, out, infeed):
    """Least time for K2's function on this card: the larger of its bytes
    (packed input read once, output written once) over HBM bandwidth and
    its fp32 operations (each plane's banded multiply-adds on this
    geometry's nonzero weights, and the colour math) over the fp32
    peak."""
    n = x.shape[0]
    H, W = src_hw
    h, w = out.shape[1:3]
    macs = 0
    for planes, (sh, sw) in ((1, (H, W)), (2, (H // 2, W // 2))):
        taps = []
        for src, dst in ((sh, h), (sw, w)):
            lo, hi = infeed.weight_bands(
                infeed.bilinear_weight_matrix(src, dst))
            taps.append(int((hi - lo).sum()))
        macs += planes * n * (sw * taps[0] + h * taps[1])
    flops = 2 * macs + YUV420_FLOPS_PER_PIXEL * n * h * w
    nbytes = x.numel() * x.element_size() + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def yuv420_composition(torch, F, infeed, x, src_hw, out_hw, out_dtype):
    """K2's function composed of PyTorch calls: each plane converted to
    fp32 NCHW and resized by ``F.interpolate(bilinear, antialias=True)``
    (Cb and Cr as one 2-channel call), then the colour math, clip,
    and for uint8 the round. A yardstick of what PyTorch's own kernels
    take; the port never calls it."""
    y, cb, cr = infeed.yuv420_unpack(x, src_hw)
    yf = F.interpolate(y.permute(0, 3, 1, 2).float(), size=out_hw,
                       mode="bilinear", antialias=True, align_corners=False)
    c = F.interpolate(torch.cat([cb, cr], dim=3).permute(0, 3, 1, 2).float(),
                      size=out_hw, mode="bilinear", antialias=True,
                      align_corners=False) - 128.0
    yf, cbf, crf = yf[:, 0], c[:, 0], c[:, 1]
    rgb = torch.stack([yf + infeed._CR_R * crf,
                       yf + infeed._CB_G * cbf + infeed._CR_G * crf,
                       yf + infeed._CB_B * cbf], dim=-1).clamp_(0.0, 255.0)
    return infeed.round_to_uint8(rgb) if out_dtype == torch.uint8 else rgb


def ptxas_spills(log):
    """Spill-store bytes ptxas reports for each K2 instance in a build
    log: {"uint8": n, "float32": n} (K2's kernel template takes ``true``
    for uint8 output)."""
    spills, instance = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            instance = ("uint8" if "yuv420_kernelILb1E" in line else
                        "float32" if "yuv420_kernelILb0E" in line else None)
        elif instance and "bytes spill stores" in line:
            spills[instance] = int(line.split("bytes spill stores")[0]
                                   .split(",")[-1])
            instance = None
    return spills


def check_yuv420_kernel(torch, infeed, spills):
    """K2 at each case: fp32 against the plain version, uint8 against rint
    of its own fp32 output and of the plain version's; then the timed
    output type's eager and graph times, bound, plain version and PyTorch
    composition, and its launch (persistent grid, items a block, rings,
    shared memory, blocks per SM, registers, and the spill bytes that
    ptxas reported in ``spills``)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    u8, f32 = torch.uint8, torch.float32
    cases = [
        ("headline_u8", 64, HEADLINE_SRC, MAIN_OUT, u8),
        ("headline_f32", 64, HEADLINE_SRC, MAIN_OUT, f32),
        ("rgb_main_512", 64, (512, 512), MAIN_OUT, u8),
        ("full_res_298", 64, (298, 298), MAIN_OUT, u8),
        ("large_downscale", 2, (3024, 4032), MAIN_OUT, u8),
        ("small_odd", 3, (46, 62), (23, 37), u8),
    ]
    results = []
    for name, n, src_hw, out_hw, timed in cases:
        row = src_hw[0] * src_hw[1] * 3 // 2
        x = torch.randint(0, 256, (n, row), generator=gen,
                          dtype=torch.uint8).cuda()
        got = infeed.fused_yuv420_resize_normalize(x, src_hw, out_hw)
        got_u8 = infeed.fused_yuv420_resize_normalize(x, src_hw, out_hw,
                                                      out_dtype=u8)
        ref = infeed.fused_yuv420_resize_normalize_plain(x, src_hw, out_hw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        own = int((got_u8 != infeed.round_to_uint8(got)).sum().item())
        off = (got_u8.int() - infeed.round_to_uint8(ref).int()).abs()
        off_max, off_count = int(off.max().item()), int((off > 0).sum())
        ok = (bool(torch.isfinite(got).all().item()) and err <= BOUND_COUNTS
              and own == 0 and off_max <= 1)
        out = got_u8 if timed == u8 else got

        def call():
            return infeed.fused_yuv420_resize_normalize(x, src_hw, out_hw,
                                                        out_dtype=timed)

        def plain():
            return infeed.fused_yuv420_resize_normalize_plain(
                x, src_hw, out_hw, out_dtype=timed)

        def composition():
            return yuv420_composition(torch, F, infeed, x, src_hw, out_hw,
                                      timed)

        bound_ms, bound_by, nbytes, flops = yuv420_bound_ms(x, src_hw, out,
                                                            infeed)
        comp_diff = (composition().float() - plain().float()).abs().max()
        results.append({
            "case": name, "n": n, "src_hw": list(src_hw),
            "out_hw": list(out_hw), "timed_dtype": str(timed),
            "max_abs_err": err, "bound": BOUND_COUNTS,
            "u8_differs_from_rint_own": own,
            "u8_max_diff_vs_rint_plain": off_max,
            "u8_pixels_differing_vs_rint_plain": off_count, "ok": ok,
            **speed(bound_ms, nbytes, time_ms(call),
                    time_ms(call, graph=True)),
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "plain_ms": time_ms(plain),
            "torch_composition_ms": time_ms(composition),
            "composition_max_abs_diff_vs_plain": comp_diff.item(),
            "launch": {**infeed.yuv420_launch_config(x, src_hw, out_hw,
                                                     timed),
                       "spill_store_bytes": spills.get(
                           str(timed).split(".")[-1])}})
        if not ok:
            raise AssertionError(
                f"4:2:0 kernel case {name}: max|diff| {err} (bound "
                f"{BOUND_COUNTS}), uint8 != rint(own fp32) at {own} "
                f"values, max {off_max} counts from rint(plain)")
    return results


def headline(torch, np, smi_line):
    """The 4:2:0 path through its public entry points; returns K2's
    launches on the counted run."""
    from sparkdl_tpu_torch import DataFrame, TensorTransformer
    from sparkdl_tpu_torch.image.imageIO import rgbToYuv420
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    from sparkdl_tpu_torch.utils.synth import textured_image

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    packed = np.stack([rgbToYuv420(textured_image(rng, *HEADLINE_SRC))
                       for _ in range(N_IMAGES)])
    df = DataFrame.from_columns({"image": packed},
                                num_partitions=PARTITIONS)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = zoo.getModelFunction("InceptionV3", featurize=True)
    mf = deviceResizeModel(model, HEADLINE_SRC, packedFormat="yuv420")
    model_build_s = time.perf_counter() - t0
    runs = []
    for run in ("cold", "main"):
        # a transformer per run, so its metrics are that run's
        transformer = TensorTransformer(
            modelFunction=mf, inputMapping={"image": "image"},
            outputMapping={"features": "features"}, batchSize=BATCH)
        if run == "main":
            # the counted run: the counts are 0 just before, read just after
            infeed.launches = infeed.yuv420_launches = 0
        t0 = time.perf_counter()
        out = transformer.transform(df).collect()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, out))
    launches = {KERNEL_YUV420: infeed.yuv420_launches,
                KERNEL: infeed.launches}
    if launches != {KERNEL_YUV420: N_IMAGES // BATCH, KERNEL: 0}:
        raise AssertionError(f"headline launches {launches}: K2 must launch "
                             f"{N_IMAGES // BATCH} times and K1 none")

    feats = [np.asarray(o["features"]) for _, o in runs]
    for f in feats:
        if f.shape != (N_IMAGES, FEATURES) or not np.isfinite(f).all():
            raise AssertionError(f"features {f.shape}, finite="
                                 f"{np.isfinite(f).all()}")
    if not np.array_equal(runs[1][1]["image"], packed):
        raise AssertionError("rows came back changed or out of order")

    # one batch through the plain 4:2:0 op (with its round) and the same
    # model function
    x = torch.from_numpy(packed[:BATCH]).cuda()
    with torch.inference_mode():
        y_plain = infeed.fused_yuv420_resize_normalize_plain(
            x, HEADLINE_SRC, MAIN_OUT, out_dtype=torch.uint8).contiguous()
        y_kernel = infeed.fused_yuv420_resize_normalize(
            x, HEADLINE_SRC, MAIN_OUT, out_dtype=torch.uint8)
    differing = int((y_plain != y_kernel).sum().item())
    ref = model.apply({"image": y_plain})["features"].float().cpu().numpy()
    rel = rel_diff(feats[1][:BATCH], ref)
    if not rel <= BOUND_FEATURES_REL:
        raise AssertionError(f"headline vs plain 4:2:0 path: relative "
                             f"max|diff| {rel} > {BOUND_FEATURES_REL}")
    warm_s = runs[1][0]
    emit("headline", model="InceptionV3", images=N_IMAGES,
         partitions=PARTITIONS, batch=BATCH, source_hw=list(HEADLINE_SRC),
         packed_row_bytes=int(packed.shape[1]),
         features_shape=list(feats[1].shape), finite=True,
         launches=launches, setup_s=setup_s, model_build_s=model_build_s,
         cold_s=runs[0][0], warm_s=warm_s,
         warm_images_per_s=N_IMAGES / warm_s,
         runs_max_abs_diff=float(np.abs(feats[0] - feats[1]).max()),
         features_max_abs=float(np.abs(feats[1]).max()),
         crosscheck_rel_max_diff=rel, crosscheck_bound=BOUND_FEATURES_REL,
         crosscheck_pixels_differing=differing,
         runner=runner_fields(transformer.metrics), card=smi_line)
    return launches[KERNEL_YUV420]


def rgb_frame(np):
    """The RGB paths' input: 512 seeded 512×512 images as image structs in
    a DataFrame of 8 partitions; (images, rows, frame, seconds to make)."""
    from sparkdl_tpu_torch import DataFrame
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (N_IMAGES, 512, 512, 3), dtype=np.uint8)
    rows = [{"image": imageArrayToStruct(img, origin=f"img_{i:04d}")}
            for i, img in enumerate(imgs)]
    df = DataFrame.from_pylist(rows, num_partitions=PARTITIONS)
    return imgs, rows, df, time.perf_counter() - t0


def check_order(out, rows):
    if [r["origin"] for r in out["image"]] != \
            [r["image"]["origin"] for r in rows]:
        raise AssertionError("rows came back out of order")


def rel_diff(got, ref):
    """max|got - ref| / max|ref|."""
    import numpy as np
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def plain_resized(torch, infeed, imgs, out_hw):
    """The plain resize of ``imgs`` on the card with the featurizer's
    round-cast, contiguous as the kernel's output is (so the model sees
    the same layout, and cuDNN picks the same algorithms, as in the run),
    and the kernel's, and how many values the two differ at."""
    from sparkdl_tpu_torch.transformers.utils import round_to_uint8
    x = torch.from_numpy(imgs).cuda()
    with torch.inference_mode():
        y_plain = round_to_uint8(infeed.fused_resize_normalize_plain(
            x, out_hw)).contiguous()
        y_kernel = round_to_uint8(infeed.fused_resize_normalize(x, out_hw))
    return y_plain, int((y_plain != y_kernel).sum().item())


def runner_fields(metrics):
    return {k: getattr(metrics, k) for k in (
        "rows", "batches", "seconds", "bytes_staged", "bytes_copied",
        "transfer_wait_seconds")}


def featurize(torch, np, smi_line, frame):
    from sparkdl_tpu_torch import DeepImageFeaturizer
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import infeed

    imgs, rows, df, setup_s = frame
    featurizer = DeepImageFeaturizer(
        modelName="InceptionV3", inputCol="image", outputCol="features",
        deviceResizeFrom=(512, 512), batchSize=BATCH)
    runs = []
    for run in ("cold", "main"):
        if run == "main":
            # the counted run: the counts are 0 just before, read just after
            infeed.launches = infeed.yuv420_launches = 0
        t0 = time.perf_counter()
        planned = featurizer.transform(df)   # builds the model function
        t1 = time.perf_counter()
        out = planned.collect()              # runs the plan
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, out, t1 - t0))
    launches = infeed.launches
    if infeed.yuv420_launches:
        raise AssertionError("the RGB path launched the 4:2:0 kernel")

    feats = [np.asarray(o["features"]) for _, o, _ in runs]
    for f in feats:
        if f.shape != (N_IMAGES, FEATURES) or not np.isfinite(f).all():
            raise AssertionError(f"features {f.shape}, finite="
                                 f"{np.isfinite(f).all()}")
    for _, o, _ in runs:
        check_order(o, rows)

    # one batch through the plain resize, the same round-cast and the
    # same model (zoo weights are the same seeded init)
    y_plain, differing = plain_resized(torch, infeed, imgs[:BATCH], MAIN_OUT)
    mf = zoo.getModelFunction("InceptionV3", featurize=True)
    ref = mf.apply({"image": y_plain})["features"].float().cpu().numpy()
    rel = rel_diff(feats[1][:BATCH], ref)
    if not rel <= BOUND_FEATURES_REL:
        raise AssertionError(f"featurizer vs plain-resize path: relative "
                             f"max|diff| {rel} > {BOUND_FEATURES_REL}")
    warm_s = runs[1][0]
    emit("featurize", model="InceptionV3", images=N_IMAGES,
         partitions=PARTITIONS, batch=BATCH, source_hw=[512, 512],
         features_shape=list(feats[1].shape), finite=True,
         launches={KERNEL: launches}, setup_s=setup_s, cold_s=runs[0][0],
         warm_s=warm_s, warm_images_per_s=N_IMAGES / warm_s,
         warm_model_build_s=runs[1][2],
         warm_collect_images_per_s=N_IMAGES / (warm_s - runs[1][2]),
         runs_max_abs_diff=float(np.abs(feats[0] - feats[1]).max()),
         features_max_abs=float(np.abs(feats[1]).max()),
         crosscheck_rel_max_diff=rel, crosscheck_bound=BOUND_FEATURES_REL,
         crosscheck_pixels_differing=differing,
         runner=runner_fields(featurizer.metrics), card=smi_line)
    return launches


def predict(torch, np, smi_line, frame):
    """``DeepImagePredictor(ResNet50, deviceResizeFrom=(512, 512),
    decodePredictions=True, topK=5)`` over the featurize phase's frame,
    cold then counted; its decoded rows against ``decode_predictions``
    of the undecoded run, and one batch of its probabilities against the
    plain resize feeding the same model. Returns K1's launches."""
    from sparkdl_tpu_torch import DeepImagePredictor
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import infeed

    imgs, rows, df, _ = frame
    kw = dict(modelName=PREDICT_MODEL, inputCol="image", outputCol="preds",
              deviceResizeFrom=(512, 512), batchSize=BATCH)
    predictor = DeepImagePredictor(decodePredictions=True, topK=TOP_K, **kw)
    runs = []
    for run in ("cold", "main"):
        if run == "main":
            # the counted run: the counts are 0 just before, read just after
            infeed.launches = infeed.yuv420_launches = 0
        t0 = time.perf_counter()
        planned = predictor.transform(df)   # builds the model function
        t1 = time.perf_counter()
        out = planned.collect()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, out, t1 - t0))
    launches = {KERNEL: infeed.launches, KERNEL_YUV420: infeed.yuv420_launches}
    if launches != {KERNEL: N_IMAGES // BATCH, KERNEL_YUV420: 0}:
        raise AssertionError(f"predict launches {launches}: K1 must launch "
                             f"{N_IMAGES // BATCH} times and K2 none")
    decoded = runs[1][1]["preds"]
    check_order(runs[1][1], rows)
    for row in decoded:
        scores = [e["score"] for e in row]
        if len(row) != TOP_K or \
                not all(type(v) is np.float32 for v in scores) or \
                not np.isfinite(scores).all() or \
                any(a < b for a, b in zip(scores, scores[1:])):
            raise AssertionError(f"decoded row {row}: want {TOP_K} "
                                 "finite float32 scores, best first")

    # the same frame undecoded: each decoded row is decode_predictions of
    # the raw scores, up to the stated tolerance (the two runs are two
    # executions of the model); class ids may swap only where two
    # adjacent raw scores lie within it
    raw_out = DeepImagePredictor(**kw).transform(df).collect()
    raw = np.asarray(raw_out["preds"])
    if raw.shape != (N_IMAGES, 1000) or not np.isfinite(raw).all():
        raise AssertionError(f"raw predictions {raw.shape}")
    t0 = time.perf_counter()   # the decode stage's work, on its own
    want = zoo.decode_predictions(raw, top=TOP_K,
                                  class_index=zoo.model_class_index(
                                      PREDICT_MODEL))
    decode_s = time.perf_counter() - t0
    names = zoo.model_class_index(PREDICT_MODEL) or \
        zoo._imagenet_class_names()
    index = {c: i for i, (c, _) in names.items()}
    worst = swaps = 0
    for i, (got_row, want_row) in enumerate(zip(decoded, want)):
        tol = BOUND_FEATURES_REL * float(raw[i].max())
        for e, (c, d, score) in zip(got_row, want_row):
            own = float(raw[i, index[e["class"]]])
            worst = max(worst, abs(float(e["score"]) - own))
            if abs(float(e["score"]) - own) > tol:
                raise AssertionError(f"row {i}: decoded score {e} against "
                                     f"its raw score {own}")
            if e["class"] != c:
                swaps += 1
                if abs(own - score) > tol:
                    raise AssertionError(f"row {i}: decoded {e}, "
                                         f"decode_predictions {(c, d, score)}")

    # one batch through the plain resize, the same round-cast and the
    # same model
    y_plain, differing = plain_resized(torch, infeed, imgs[:BATCH],
                                       MAIN_OUT_224)
    mf = zoo.getModelFunction(PREDICT_MODEL, featurize=False)
    ref = mf.apply({"image": y_plain})["predictions"].float().cpu().numpy()
    rel = rel_diff(raw[:BATCH], ref)
    if not rel <= BOUND_FEATURES_REL:
        raise AssertionError(f"predictor vs plain-resize path: relative "
                             f"max|diff| {rel} > {BOUND_FEATURES_REL}")
    warm_s = runs[1][0]
    emit("predict", model=PREDICT_MODEL, images=N_IMAGES,
         partitions=PARTITIONS, batch=BATCH, source_hw=[512, 512],
         top_k=TOP_K, launches=launches, cold_s=runs[0][0], warm_s=warm_s,
         warm_images_per_s=N_IMAGES / warm_s, warm_model_build_s=runs[1][2],
         warm_collect_images_per_s=N_IMAGES / (warm_s - runs[1][2]),
         decode_predictions_s=decode_s,
         decoded_vs_raw_max_score_diff=worst,
         decoded_vs_raw_class_swaps=swaps,
         decoded_tolerance_rel=BOUND_FEATURES_REL,
         top1_counts=len({row[0]["class"] for row in decoded}),
         crosscheck_rel_max_diff=rel, crosscheck_bound=BOUND_FEATURES_REL,
         crosscheck_pixels_differing=differing,
         runner=runner_fields(predictor.metrics), card=smi_line)
    return launches[KERNEL]


def zoo_models(torch, np, smi_line, frame):
    """Each of Xception, ResNet50, VGG16 and VGG19 at full width and depth
    featurizes one batch of the 512×512 images through
    ``deviceResizeFrom`` (cold, then counted), against the same network
    built in float32 and fed by the plain resize. Returns K1's launches
    over the counted runs."""
    from sparkdl_tpu_torch import DataFrame, DeepImageFeaturizer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import infeed

    imgs, rows, _, _ = frame
    df = DataFrame.from_pylist(rows[:ZOO_IMAGES], num_partitions=1)
    total = 0
    results = []
    for name in ZOO_MODELS:
        spec = zoo.getKerasApplicationModel(name)
        featurizer = DeepImageFeaturizer(
            modelName=name, inputCol="image", outputCol="features",
            deviceResizeFrom=(512, 512), batchSize=BATCH)
        runs = []
        for run in ("cold", "main"):
            if run == "main":
                # the counted run: counts 0 just before, read just after
                infeed.launches = infeed.yuv420_launches = 0
            t0 = time.perf_counter()
            planned = featurizer.transform(df)   # builds the model function
            t1 = time.perf_counter()
            out = planned.collect()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, out, t1 - t0))
        launches = infeed.launches
        if launches != ZOO_IMAGES // BATCH or infeed.yuv420_launches:
            raise AssertionError(f"{name}: K1 launched {launches} times, "
                                 f"K2 {infeed.yuv420_launches}")
        total += launches
        check_order(runs[1][1], rows[:ZOO_IMAGES])
        feats = np.asarray(runs[1][1]["features"])
        if feats.shape != (ZOO_IMAGES, spec.feature_dim) or \
                not np.isfinite(feats).all():
            raise AssertionError(f"{name}: features {feats.shape}, finite="
                                 f"{np.isfinite(feats).all()}")

        # the same weights in a float32 network, fed by the plain resize
        y_plain, differing = plain_resized(torch, infeed, imgs[:ZOO_IMAGES],
                                           spec.input_size)
        net = spec.module_fn(dtype=torch.float32)
        net.load_state_dict(zoo.load_state_dict(name), strict=True)
        ref_mf = ModelFunction(
            zoo.ZooModel(spec, net, featurize=True),
            {"image": ((spec.height, spec.width, 3), np.uint8)},
            ["features"], name=f"{name}:float32")
        ref = ref_mf.apply({"image": y_plain})["features"].cpu().numpy()
        rel = rel_diff(feats, ref)
        bound = ZOO_ROUNDINGS[name] * BF16_HALF_STEP
        warm_s = runs[1][0]
        results.append({
            "model": name, "input_hw": list(spec.input_size),
            "features_shape": list(feats.shape), "finite": True,
            "launches": {KERNEL: launches}, "cold_s": runs[0][0],
            "warm_s": warm_s, "warm_images_per_s": ZOO_IMAGES / warm_s,
            "warm_model_build_s": runs[1][2],
            "warm_collect_images_per_s": ZOO_IMAGES / (warm_s - runs[1][2]),
            "bf16_vs_fp32_rel_max_diff": rel, "bound": bound,
            "bf16_roundings_on_longest_path": ZOO_ROUNDINGS[name],
            "pixels_differing_kernel_vs_plain": differing,
            "features_max_abs": float(np.abs(ref).max())})
        if not rel <= bound:
            raise AssertionError(f"{name}: bf16 vs float32 relative "
                                 f"max|diff| {rel} > {bound}")
        del featurizer, net, ref_mf, runs
        torch.cuda.empty_cache()
    emit("zoo", images=ZOO_IMAGES, batch=BATCH, source_hw=[512, 512],
         models=results, card=smi_line)
    return total


def trained_predict(torch, np, smi_line):
    """``DeepImagePredictor(TestNet, decodePredictions=True, topK=1)`` on
    the card with the committed, trained weights (read by the port's
    msgpack reader) over the held-out set its provenance names; accuracy
    and each decoded name against the raw scores' best class."""
    from sparkdl_tpu_torch import DataFrame, DeepImagePredictor
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.testnet import synthetic_testnet_dataset
    from sparkdl_tpu_torch.ops import infeed

    provenance = zoo.weights_provenance("TestNet")
    if provenance != "committed":
        raise AssertionError(f"TestNet weights are {provenance!r}, not the "
                             "committed artifact")
    with open(os.path.join(zoo.ARTIFACTS_DIR,
                           "TestNet.provenance.json")) as f:
        ds = json.load(f)["dataset"]
    x, labels = synthetic_testnet_dataset(
        ds["n_eval"], seed=ds["eval_seed"], noise=ds["noise"],
        proto_seed=ds["proto_seed"])
    rows = [{"image": imageArrayToStruct(a, origin=f"eval_{i:04d}")}
            for i, a in enumerate(x)]
    df = DataFrame.from_pylist(rows, num_partitions=PARTITIONS)
    kw = dict(modelName="TestNet", inputCol="image", outputCol="preds",
              batchSize=BATCH)
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = DeepImagePredictor(decodePredictions=True, topK=1, **kw) \
        .transform(df).collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {KERNEL: infeed.launches, KERNEL_YUV420: infeed.yuv420_launches}
    check_order(out, rows)
    raw = np.asarray(DeepImagePredictor(**kw).transform(df).collect()["preds"])
    top1 = []
    for i, row in enumerate(out["preds"]):
        (e,) = row
        k = int(e["class"].split("_")[-1])
        if e["description"] != f"prototype_{k}" or \
                raw[i, k] != raw[i].max():
            raise AssertionError(f"row {i}: decoded {e}, raw best class "
                                 f"{int(raw[i].argmax())}")
        top1.append(k)
    accuracy = float((np.array(top1) == labels).mean())
    emit("trained_predict", model="TestNet", weights=provenance,
         dataset=ds, images=len(rows), accuracy=accuracy,
         min_accuracy=TESTNET_MIN_ACCURACY, launches=launches,
         seconds=seconds, card=smi_line)
    if not accuracy >= TESTNET_MIN_ACCURACY:
        raise AssertionError(f"TestNet held-out accuracy {accuracy} < "
                             f"{TESTNET_MIN_ACCURACY}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    repo = os.path.dirname(os.path.abspath(__file__))
    from sparkdl_tpu_torch.ops import _build, infeed
    # weights cache inside the checkout (empty: seeded-random weights)
    os.environ.setdefault("SPARKDL_TPU_TORCH_MODEL_CACHE", os.path.join(
        repo, "sparkdl_tpu_torch", "_build", "model_cache"))
    # exact fp32 for the plain resize's matmuls; the model runs in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), python=sys.version.split()[0])

    # the two nvcc builds and the shim's g++ build, all started together
    from sparkdl_tpu_torch import native

    def build(name):
        t = time.perf_counter()
        log = _build.build(name, ptxas_report=True)
        return time.perf_counter() - t, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        shim = pool.submit(native.get_lib)
        builds = {name: pool.submit(build, name)
                  for name in (KERNEL, KERNEL_YUV420)}
        builds = {name: f.result() for name, f in builds.items()}
        shim_built = shim.result() is not None
    for name, (seconds, log) in builds.items():
        # per kernel instance: its (mangled) name, then its spills and
        # registers
        emit("build", name=name, seconds=seconds,
             ptxas=[ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln])
    emit("host", shim_built=shim_built, shim_libjpeg=native.has_jpeg(),
         build_wall_s=time.perf_counter() - t0)

    cases, main_err, timing = check_resize_kernel(torch, infeed)
    emit("kernel", name=KERNEL, cases=cases, card=smi, **timing)
    yuv_cases = check_yuv420_kernel(torch, infeed,
                                    ptxas_spills(builds[KERNEL_YUV420][1]))
    emit("kernel_yuv420", name=KERNEL_YUV420, cases=yuv_cases, card=smi)

    frame = rgb_frame(np)
    # K1's launches on each of its paths' counted runs
    k1_paths = {"featurize": featurize(torch, np, smi, frame),
                "predict": predict(torch, np, smi, frame),
                "zoo": zoo_models(torch, np, smi, frame)}
    del frame
    yuv_launches = headline(torch, np, smi)
    trained_predict(torch, np, smi)

    launches = sum(k1_paths.values())
    emit("kernels", launches={KERNEL: launches, KERNEL_YUV420: yuv_launches},
         launches_by_path={KERNEL: k1_paths,
                           KERNEL_YUV420: {"headline": yuv_launches}},
         passed=all(k1_paths.values()) and yuv_launches > 0)
    if not all(k1_paths.values()):
        raise AssertionError(f"kernel {KERNEL} was not launched on each of "
                             f"its paths: {k1_paths}")
    main = yuv_cases[0]
    kernels = [{
        "name": KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "launches_by_path": k1_paths,
        "max_abs_err": main_err, "ms": timing["ms"],
        "device_ms": timing["device_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "main_224": {k: timing["main_224"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}, {
        "name": KERNEL_YUV420, "route": "cuda",
        "source": KERNEL_YUV420_SOURCE, "replaces": KERNEL_YUV420_REPLACES,
        "launches": yuv_launches, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "torch_composition_ms": main["torch_composition_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
