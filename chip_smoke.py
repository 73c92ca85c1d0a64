#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sparkdl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each on stdout:

1. ``env``       — the card (nvidia-smi name and power limit), torch, CUDA.
2. ``build``     — builds the port's CUDA kernel from the checkout's
                   source with nvcc.
3. ``kernel``    — holds the kernel against its plain PyTorch version on
                   the card at the main path's shape and a few others
                   (a phone-photo downscale, unaligned rows, tall images
                   whose plans take shorter bands), times each case
                   beside its bound with its launch configuration (grid,
                   threads, shared memory, blocks per SM), times kernel,
                   plain version and the PyTorch library call that
                   computes the same function at the main shape, and
                   checks and times the kernel at each band height it is
                   built for at the main and the phone-photo shapes.
                   Times are CUDA events around warm calls: ``ms`` is
                   the eager call through the Python wrapper, as kernel,
                   plain version and library are all timed;
                   ``device_ms`` is the kernel's calls replayed from a
                   CUDA graph, the device's time without the host's.
4. ``featurize`` — drives the main path through its public entry points:
                   ``DeepImageFeaturizer(modelName="InceptionV3",
                   deviceResizeFrom=(512, 512))`` over a ``DataFrame`` of
                   512 seeded 512×512 RGB images in 8 partitions: a cold
                   run, then the main run, with the kernel's launch count
                   set to 0 just before it and read just after;
                   cross-checks one batch against the plain resize
                   feeding the same model.
5. ``kernels``   — the kernel's launches on the main path and pass/fail.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no last line; it does the same without CUDA.
The weights are seeded-random (no download): the features are checked
for shape, finiteness and agreement, not for meaning.
"""

import json
import os
import subprocess
import sys
import time

# the port's one CUDA kernel: its source in the repo, and the TPU kernel
# it replaces
KERNEL = "resize_normalize"
KERNEL_SOURCE = "sparkdl_tpu_torch/ops/csrc/resize_normalize.cu"
KERNEL_REPLACES = "sparkdl_tpu/ops/infeed.py:96"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# fp32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

MAIN_SHAPE = (64, 512, 512, 3)
MAIN_OUT = (299, 299)
N_IMAGES = 512
PARTITIONS = 8
BATCH = 64
# max |kernel - plain|: fp32, only the summation order differs
BOUND_COUNTS = 1e-3      # outputs on the 0..255 scale
BOUND_UNIT = 1e-5        # outputs on the [-1, 1] scale
# featurizer vs plain-resize path, as max|diff| / max|ref| over the batch:
# the two resizes may round a pixel whose value sits at .5 to different
# uint8 counts, and the model then runs in bf16
BOUND_FEATURES_REL = 2e-2


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
    import torch.nn.functional as F
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

    x = inputs["main"][0]
    xf = x.float().permute(0, 3, 1, 2)   # NCHW view, channels_last memory

    def kernel():
        return infeed.fused_resize_normalize(x, MAIN_OUT)

    def plain():
        return infeed.fused_resize_normalize_plain(x, MAIN_OUT)

    def library():
        return F.interpolate(xf, size=MAIN_OUT, mode="bilinear",
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
    out = kernel()
    bound_ms, bound_by, nbytes, flops = resize_bound_ms(x, out, infeed)
    ms, device_ms = (k1 + k2) / 2, (d1 + d2) / 2
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
    timing = {**speed(bound_ms, nbytes, ms, device_ms),
              "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms,
              "bound_by": bound_by, "bytes": nbytes, "flops": flops,
              "launch": infeed.launch_config(x, MAIN_OUT),
              "ms_runs": [k1, k2], "device_ms_runs": [d1, d2],
              "plain_ms_runs": [p1, p2], "rows_sweep": rows_sweep,
              "library_max_abs_diff_vs_plain": lib_err}
    return results, main_err, timing


def featurize(torch, np, smi_line):
    from sparkdl_tpu_torch import DataFrame, DeepImageFeaturizer
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.transformers.utils import round_to_uint8

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (N_IMAGES, 512, 512, 3), dtype=np.uint8)
    rows = [{"image": imageArrayToStruct(img, origin=f"img_{i:04d}")}
            for i, img in enumerate(imgs)]
    df = DataFrame.from_pylist(rows, num_partitions=PARTITIONS)
    setup_s = time.perf_counter() - t0

    featurizer = DeepImageFeaturizer(
        modelName="InceptionV3", inputCol="image", outputCol="features",
        deviceResizeFrom=(512, 512), batchSize=BATCH)
    runs = []
    for run in ("cold", "main"):
        if run == "main":
            # the counted run: the count is 0 just before, read just after
            infeed.launches = 0
        t0 = time.perf_counter()
        planned = featurizer.transform(df)   # builds the model function
        t1 = time.perf_counter()
        out = planned.collect()              # runs the plan
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, out, t1 - t0))
    launches = infeed.launches

    feats = [np.asarray(o["features"]) for _, o, _ in runs]
    for f in feats:
        if f.shape != (N_IMAGES, 2048) or not np.isfinite(f).all():
            raise AssertionError(f"features {f.shape}, finite="
                                 f"{np.isfinite(f).all()}")
    for _, o, _ in runs:
        if [r["origin"] for r in o["image"]] != \
                [r["image"]["origin"] for r in rows]:
            raise AssertionError("rows came back out of order")

    # one batch through the plain resize, the same round-cast and the
    # same model (zoo weights are the same seeded init)
    x = torch.from_numpy(imgs[:BATCH]).cuda()
    with torch.inference_mode():
        # contiguous, as the kernel's output is: the model then sees the
        # same layout (and cuDNN picks the same algorithms) as in the run
        y_plain = round_to_uint8(infeed.fused_resize_normalize_plain(
            x, MAIN_OUT)).contiguous()
        y_kernel = round_to_uint8(infeed.fused_resize_normalize(
            x, MAIN_OUT))
    differing = int((y_plain != y_kernel).sum().item())
    mf = zoo.getModelFunction("InceptionV3", featurize=True)
    ref = mf.apply({"image": y_plain})["features"].float().cpu().numpy()
    got = feats[1][:BATCH]
    rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
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
         runner={k: getattr(featurizer.metrics, k) for k in (
             "rows", "batches", "seconds", "bytes_staged", "bytes_copied",
             "transfer_wait_seconds")},
         card=smi_line)
    return launches


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

    t0 = time.perf_counter()
    log = _build.build(KERNEL, ptxas_report=True)
    # per kernel: its (mangled) name, then its spills and registers
    emit("build", name=KERNEL, seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "entry function" in ln or "registers" in ln
                or "spill" in ln])

    cases, main_err, timing = check_resize_kernel(torch, infeed)
    emit("kernel", name="resize_normalize", cases=cases, card=smi,
         **timing)

    launches = featurize(torch, np, smi)

    emit("kernels", name=KERNEL, launches=launches, passed=launches > 0)
    if launches == 0:
        raise AssertionError(f"kernel {KERNEL} was not launched on the "
                             "main path")
    kernels = [{
        "name": KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_err, "ms": timing["ms"],
        "device_ms": timing["device_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
