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
9. ``runner_split`` — one chunk of the featurize path (64 of those images,
                   InceptionV3 behind ``deviceResizeFrom``), by CUDA
                   events: the host→device copy through a pinned staging
                   buffer (host copy, then async copy) and straight from
                   the pageable array, each also with a model call
                   queued ahead of it (how long the host is held); the
                   model (K1, round-cast, InceptionV3), eager and from a
                   CUDA graph; the copy back into pinned and pageable
                   memory; pinned allocation cold and warm; and each zoo
                   model alone at batch 64, eager and from a graph.
10. ``strategies`` — the featurize frame (and the same 512 images in one
                   partition) under each runner strategy, ``immediate``,
                   ``deferred``, ``host_async``, ``prefetch`` (depth 1),
                   two passes each, then with an infeed ring of 2 and of
                   8 slots, two passes over one plan: every output equal
                   to ``immediate``'s bit for bit, K1 8 times a pass, the
                   ring's second pass with hits; and the headline under
                   ``immediate`` against its ``deferred`` run, bit for bit.
11. ``small_partitions`` — the same 512 images in 32 partitions of 16
                   rows through the featurizer: the engine re-chunks
                   them, so the runner reports 8 batches, not 32, and the
                   features equal the 8×64 frame's bit for bit.
12. ``host_pipeline`` — the parallel host pipeline under the headline
                   (K2): ``deviceResizeModel(InceptionV3, (150, 150),
                   packedFormat="yuv420")`` through ``TensorTransformer``,
                   batch 64, over 1,024 seeded 150×150 images in 16
                   partitions of 64, each partition's source drawing its
                   textured images from (seed, partition) where it loads
                   and a host stage packing them to 33,750-byte 4:2:0
                   rows. Serial, then 4 workers in thread mode, then in
                   process mode (its first pass starts the pool): two
                   warm passes each, images/s, the overlap ratio
                   ``(engine.busy_seconds + device.run_seconds) / wall``,
                   the ``pipeline.*`` counter deltas; every output bit for
                   bit the serial pass's, K2 16 times a pass, no process
                   pass falling back to threads, bytes through the
                   hand-off, a probe task's worker without CUDA, no
                   ``/dev/shm`` segment left.
13. ``host_pipeline_k1`` — the featurize configuration (K1) with its 512
                   seeded 512×512 structs drawn where each partition
                   loads, serial then twice on the process pool (4
                   workers): the same features bit for bit, K1 8 times a
                   pass, every fragment through shared memory, the
                   hand-off's bytes and seconds.
14. ``input_service`` — the ``host_pipeline`` frame with its host prefix
                   on a decode fleet: two ``python -m
                   sparkdl_tpu_torch.inputsvc serve --port 0``
                   subprocesses (READY line within a bound), widths 1 and
                   2, then both beside a dead endpoint; every output bit
                   for bit the serial pass's, no local decode or RPC error
                   on the live fleet, the dead endpoint counted down.
15. ``snapshot`` — ``DataFrame.snapshot`` over the same frame through the
                   device stage, a cold epoch (16 chunks written) then a
                   warm one (16 read back, none decoded), each bit for bit
                   the serial pass's, with each epoch's images/s and
                   engine busy seconds. Then one ``pipeline_phases`` line:
                   the four phases' seconds.
16. ``transfer`` — the transfer-learning flow on the card:
                   ``Pipeline([DeepImageFeaturizer("InceptionV3",
                   deviceResizeFrom=(512, 512)), LogisticRegression(
                   maxIter=100, regParam=1e-3)])`` fitted over the same
                   frame with labels ``i % 10``, then transform and
                   ``ClassificationEvaluator`` (the counted run: K1 8
                   times in the fit's collect and 8 in the transform; the
                   runner's output-shape probe is a trace that launches
                   nothing);
                   probabilities finite and summing to 1; the same fit
                   on the CPU over the collected features within the
                   stated bounds; the fitted ``PipelineModel`` saved,
                   reloaded with ``load_model`` and transformed to the
                   same bits. The fit's seconds split into featurize and
                   LR fit, and the LR's ms a step.
17. ``graph``     — ``ModelFunction.fromList([buildSpImageConverter(299,
                   299, scale=1/127.5, offset=-1), InceptionV3])`` (the
                   zoo's bf16 network without its preprocess) through
                   ``TFImageTransformer(deviceResizeFrom=(512, 512))`` over
                   the featurize frame, counted (K1 8 times), against
                   ``DeepImageFeaturizer``'s features within the featurize
                   bound; ``rename_io`` and ``select_outputs`` of it on one
                   batch, bit for bit; ``output_signature()`` of each
                   function, which must launch no kernel and leave
                   ``torch.cuda.memory_allocated()`` as it was.
18. ``export``    — the headline's function exported by ``torch.export``
                   with a symbolic batch and with a fixed batch of 64
                   (bytes and seconds of each), loaded by
                   ``ModelIngest.fromExport`` and run through
                   ``TFTransformer`` over the headline frame, counted (K2
                   8 times, K1 none), bit for bit the un-exported pass;
                   the fixed-batch program refuses 32 rows and bytes that
                   are no program are refused, each with ``ValueError``;
                   a ``TensorTransformer`` holding the function saved,
                   then loaded and run over the same rows by a fresh
                   ``python3 -c`` process that imports only
                   ``sparkdl_tpu_torch`` (started after the save, beside
                   the exports and loads): K2 8 times there, the features
                   handed back through an ``.npy`` file, bit for bit.
19. ``udf``       — ``makeModelUDF`` of the InceptionV3 featurizer behind
                   ``deviceResizeFrom=(512, 512)``, ``kind="image"``, then
                   ``callUDF`` over the featurize frame, counted (K1 8
                   times), bit for bit ``ImageTransformer``'s pass; the
                   UDF's direct call on one batch of 64 equals those rows.
                   Then one ``graph_phases`` line: the three phases'
                   seconds. Nothing Keras-related runs here: the card's
                   machine has no keras, so the Keras paths (the
                   converter, ``KerasTransformer``,
                   ``KerasImageFileTransformer``, ``registerKerasImageUDF``,
                   the weight import) are checked by the CPU tests only.
20. ``trained_predict`` — ``DeepImagePredictor(modelName="TestNet",
                   decodePredictions=True, topK=1)`` with the committed,
                   trained weights (read by the port's msgpack reader)
                   over the held-out set its provenance names: accuracy
                   at least 0.95, each decoded name the raw scores' best.
21. ``transfer_trained`` — ``Pipeline([DeepImageFeaturizer("TestNet"),
                   LogisticRegression()])`` on the TestNet's 4,096 train
                   images, then ``CrossValidator`` (3 folds) and
                   ``TrainValidationSplit`` over ``regParam`` {0, 1e-2} ×
                   ``maxIter`` {50, 100} on the cached featurized train
                   split: finite metrics, and held-out accuracy at least
                   0.95 after the fit and for each best model.
22. ``logreg_scale`` — ``LogisticRegression`` alone on 262,144 × 2,048
                   seeded fp32 features, 10 classes, 64 partitions:
                   full-batch for 100 steps (ms a step beside its bound:
                   the table read twice a step over HBM bandwidth), the
                   step alone by CUDA events, one minibatch and one
                   streaming epoch at batch 4096, the default budget's
                   switch to streaming (with its warning), and the card
                   against the CPU at 8,192 rows, 20 steps.
23. ``kernels``  — each kernel's launches on its paths and pass/fail.

Then one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no last line; it does the same without CUDA.
Apart from TestNet's the weights are seeded-random (no download): the
features are checked for shape, finiteness and agreement, not for
meaning.
"""

import contextlib
import glob
import json
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
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
# the runner's transfer strategies, and the infeed ring depths tried
STRATEGIES = ("immediate", "deferred", "host_async", "prefetch")
RING_DEPTHS = (2, 8)
# the small_partitions phase: the same images in partitions of 16 rows
SMALL_PARTITIONS = 32
# the zoo models timed alone at batch 64 in runner_split
SPLIT_MODELS = ("InceptionV3",) + ZOO_MODELS
# the transfer-learning phases: logistic regression on 10 classes
LR_CLASSES = 10
LR_ITERS = 100
LR_REG = 1e-3
# logreg_scale: a quarter of the north-star table's 1,048,576 rows of
# InceptionV3's width, in 64 partitions; minibatch and streaming fits at
# batch 4096; the card against the CPU on the first 8,192 rows
LR_ROWS = 262_144
LR_PARTITIONS = 64
LR_BATCH = 4096
LR_CHECK_ROWS = 8192
LR_CHECK_ITERS = 20
# the host pipeline, input service and snapshot phases: the headline's
# model over 1,024 seeded 150×150 images in 16 partitions of 64, drawn
# and packed to 4:2:0 rows where each partition loads; 4 pool workers,
# a fleet of 2 decode servers
PIPE_IMAGES = 1024
PIPE_PARTITIONS = 16
PIPE_WORKERS = 4
FLEET_WIDTH = 2
# host_pipeline_k1: the featurize phase's 512 seeded 512×512 images in 8
# partitions, drawn where each partition loads
K1_PIPE_SEED = 1
# the shared-memory segments multiprocessing makes, and the bound on
# every wait for a worker or a server
SHM_GLOB = "/dev/shm/psm_*"
WAIT_S = 60.0
# transfer_trained: the grid tuned over the TestNet features
TUNE_REG = (0.0, 1e-2)
TUNE_ITERS = (50, 100)
TUNE_FOLDS = 3
TUNE_TRAIN_RATIO = 0.75
# a fit on the card against the same fit on the CPU, from the same
# initial bits on the same features: the Adam updates are the same
# float32 arithmetic and differ only in the order of the sums inside the
# products (cuBLAS's against the CPU's). Reordering a 2,048-term fp32 dot
# product moves it by about sqrt(2048) half-ulps, ~3e-6 relative; a CPU
# replay of these fits in other orders (columns or rows permuted, or in
# float64; on features shaped like this script's: random InceptionV3
# features and the logreg_scale table) moved the objective history by at
# most 6e-7 relative and the probabilities by at most 9e-7. The bounds
# keep 10x and more above that, and are the JAX-parity tests' own.
LR_BOUND_HISTORY_REL = 1e-4
LR_BOUND_PROB = 1e-5


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
    launches on the counted run, and the frame, model function and
    features of that run."""
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
    return launches[KERNEL_YUV420], (df, mf, feats[1])


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
    fields = {k: getattr(metrics, k) for k in (
        "rows", "batches", "seconds", "bytes_staged", "bytes_copied",
        "transfer_wait_seconds")}
    return {**fields, "rows_per_second": metrics.rows_per_second}


def fields_delta(after, before):
    """Counters of one pass: the difference of two ``runner_fields``."""
    delta = {k: after[k] - before[k] for k in after
             if k != "rows_per_second"}
    delta["rows_per_second"] = (delta["rows"] / delta["seconds"]
                                if delta["seconds"] else 0.0)
    return delta


@contextlib.contextmanager
def runner_env(**knobs):
    """The runner's environment knobs (``SPARKDL_TPU_<KNOB>``) set for
    the runners made inside, as a user sets them."""
    old = {}
    for knob, value in knobs.items():
        name = f"SPARKDL_TPU_{knob.upper()}"
        old[name] = os.environ.get(name)
        os.environ[name] = str(value)
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def plan_runner(planned):
    """The batch runner behind a planned frame's device stage."""
    return next(st.batch_hint.runner for st in planned._plan
                if st.kind == "device")


def events_ms(torch, fn, iters=5, warmup=2):
    """Mean device ms of ``fn()`` by CUDA events around ``iters`` warm
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def median(values):
    values = sorted(values)
    return values[len(values) // 2]


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
    return launches, feats[1]


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
    device_ms = {}
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
        net = zoo.build_module(spec.module_fn, zoo.load_state_dict(name),
                               torch.device("cuda"), dtype=torch.float32)
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
        device_ms[name] = model_device_ms(torch, name)
    emit("zoo", images=ZOO_IMAGES, batch=BATCH, source_hw=[512, 512],
         models=results, card=smi_line)
    return total, device_ms


def model_device_ms(torch, name):
    """One zoo model alone (bf16, featurize) on a batch of 64 uint8
    images on the card: ms a batch by CUDA events around eager calls
    (``eager``: the host may hold the device back), and replayed from a
    CUDA graph (``graph``: the device's time alone)."""
    from sparkdl_tpu_torch.models import zoo
    spec = zoo.getKerasApplicationModel(name)
    mf = zoo.getModelFunction(name, featurize=True)
    x = torch.randint(0, 256, (BATCH, spec.height, spec.width, 3),
                      generator=torch.Generator().manual_seed(2),
                      dtype=torch.uint8).cuda()
    ms = {"eager": events_ms(torch, lambda: mf.apply({"image": x})),
          "graph": time_ms(lambda: mf.apply({"image": x}), iters=5,
                           graph=True)}
    del mf, x
    torch.cuda.empty_cache()
    return ms


def runner_split(torch, np, smi_line, frame, zoo_ms):
    """Where one chunk of the featurize path spends its time on the card:
    the host→device copy through a pinned staging buffer and straight
    from pageable memory (alone, and with a model call queued ahead, as
    in a pipelined run), the model (K1, round-cast, InceptionV3; eager,
    and replayed from a CUDA graph), the copy back, pinned allocation,
    and each zoo model alone at batch 64 (``zoo_ms``, timed in the zoo
    phase, plus InceptionV3 here)."""
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    x = np.ascontiguousarray(frame[0][:BATCH])   # 64×512×512×3 uint8
    mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"), (512, 512))
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    pinned = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
    pin_cold_ms = (time.perf_counter() - t0) * 1e3
    del pinned
    t0 = time.perf_counter()
    pinned = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
    pin_warm_ms = (time.perf_counter() - t0) * 1e3
    xd = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    xd2 = torch.empty_like(xd)

    src = torch.from_numpy(x)

    def host_copy(parallel):
        """ms to write the chunk into the pinned buffer: numpy's copy
        (one thread), or torch's (its intra-op threads), as the runner
        stages."""
        t0 = time.perf_counter()
        if parallel:
            pinned.copy_(src)
        else:
            pinned.numpy()[:] = x
        return (time.perf_counter() - t0) * 1e3

    def timed_copy(dst, host):
        """(host ms to issue dst.copy_(host, non_blocking), device ms of
        the copy by CUDA events around it)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        dst.copy_(host, non_blocking=True)
        end.record()
        issue = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        return issue, start.elapsed_time(end)

    def queued(fn):
        """Host ms of ``fn()`` issued right behind one chunk's model call
        on the same stream (how long it holds the host there)."""
        torch.cuda.synchronize()
        mf.apply({"image": xd})
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return host

    def staged_behind_model():
        host_copy(True)
        xd2.copy_(pinned, non_blocking=True)

    runs = {k: [] for k in ("copy_numpy", "copy_torch", "pinned",
                            "pageable", "pinned_q", "pageable_q")}
    for _ in range(7):
        runs["copy_numpy"].append(host_copy(False))
        runs["copy_torch"].append(host_copy(True))
        runs["pinned"].append(timed_copy(xd, pinned))
        runs["pageable"].append(timed_copy(xd, src))
        runs["pinned_q"].append(queued(staged_behind_model))
        runs["pageable_q"].append(
            queued(lambda: xd2.copy_(src, non_blocking=True)))
    runs = {k: v[2:] for k, v in runs.items()}
    torch.cuda.synchronize()
    if not (torch.equal(xd.cpu(), src) and torch.equal(xd2.cpu(), src)):
        raise AssertionError("runner_split: the copied chunk differs")

    model_ms = events_ms(torch, lambda: mf.apply({"image": xd}))
    model_graph_ms = time_ms(lambda: mf.apply({"image": xd}), iters=5,
                             graph=True)
    out = mf.apply({"image": xd})["features"]
    slab = torch.empty(tuple(out.shape), dtype=out.dtype, pin_memory=True)
    d2h_pinned_ms = median([timed_copy(slab, out)[1] for _ in range(5)])
    pageable_slab = torch.empty(tuple(out.shape), dtype=out.dtype)
    d2h_pageable_ms = median([timed_copy(pageable_slab, out)[1]
                              for _ in range(5)])
    inception_ms = model_device_ms(torch, "InceptionV3")
    emit("runner_split", model="InceptionV3", chunk=list(x.shape),
         chunk_bytes=int(x.nbytes),
         stage_copy_numpy_ms=median(runs["copy_numpy"]),
         stage_copy_torch_ms=median(runs["copy_torch"]),
         torch_threads=torch.get_num_threads(),
         h2d_pinned_issue_ms=median(c[0] for c in runs["pinned"]),
         h2d_pinned_device_ms=median(c[1] for c in runs["pinned"]),
         h2d_pageable_issue_ms=median(c[0] for c in runs["pageable"]),
         h2d_pageable_device_ms=median(c[1] for c in runs["pageable"]),
         staged_host_ms_behind_model=median(runs["pinned_q"]),
         pageable_host_ms_behind_model=median(runs["pageable_q"]),
         model_ms=model_ms, model_graph_ms=model_graph_ms,
         d2h_pinned_ms=d2h_pinned_ms,
         d2h_pageable_ms=d2h_pageable_ms, d2h_bytes=int(out.numel() * 4),
         pin_alloc_cold_ms=pin_cold_ms, pin_alloc_warm_ms=pin_warm_ms,
         model_device_ms_batch64={"InceptionV3": inception_ms, **zoo_ms},
         card=smi_line)
    del mf, xd, xd2, pinned, slab, out, src
    torch.cuda.empty_cache()


def ring_replay(depth, chunks):
    """Hits on the second of two passes over ``chunks`` distinct chunks
    that the infeed ring's policy gives, replayed on the host."""
    from sparkdl_tpu_torch.runtime.runner import InfeedRing
    ring = InfeedRing(depth)
    hits = 0
    for p in range(2):
        for c in range(chunks):
            ring.tick()
            fp = bytes([c])
            if ring.get(fp) is not None:
                hits += p
            else:
                ring.note_shipped(fp)
                ring.admit(fp, fp, 0)
    return hits


def featurizer(batch=BATCH):
    from sparkdl_tpu_torch import DeepImageFeaturizer
    return DeepImageFeaturizer(
        modelName="InceptionV3", inputCol="image", outputCol="features",
        deviceResizeFrom=(512, 512), batchSize=batch)


def counted_pass(torch, np, planned, rows, ref, what):
    """One collect of a planned featurize frame with K1's count set to 0
    just before and read just after: (seconds, runner counters of the
    pass, K1 launches). Features must equal ``ref`` bit for bit when
    given, rows must come back in order."""
    from sparkdl_tpu_torch.ops import infeed
    runner = plan_runner(planned)
    before = runner_fields(runner.metrics)
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = planned.collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = infeed.launches
    if launches != N_IMAGES // BATCH or infeed.yuv420_launches:
        raise AssertionError(f"{what}: K1 launched {launches} times, K2 "
                             f"{infeed.yuv420_launches}")
    check_order(out, rows)
    feats = np.asarray(out["features"])
    if ref is not None and not np.array_equal(feats, ref):
        raise AssertionError(
            f"{what}: features differ from immediate's at "
            f"{int((feats != ref).sum())} values, max "
            f"{float(np.abs(feats - ref).max())}")
    return seconds, fields_delta(runner_fields(runner.metrics), before), \
        launches, feats


def strategies(torch, np, smi_line, frame, head):
    """The featurize frame (8 partitions of 64) and the same images in one
    partition under each runner strategy, then with infeed rings; every
    output against ``immediate``'s bits. The headline under
    ``immediate`` against its ``deferred`` run (``head``). Returns K1's
    and K2's launches over the counted passes."""
    from sparkdl_tpu_torch import DataFrame, TensorTransformer
    from sparkdl_tpu_torch.ops import infeed

    imgs, rows, df, _ = frame
    frames = {"8x64": df,
              "1x512": DataFrame.from_pylist(rows, num_partitions=1)}
    ref = None     # immediate's features over the 8×64 frame
    results = []
    k1 = 0
    for layout, frame_df in frames.items():
        for strategy in STRATEGIES:
            with runner_env(runner_strategy=strategy, prefetch_depth=1):
                planned = featurizer().transform(frame_df)
            runner = plan_runner(planned)
            passes = []
            for i in range(2):
                seconds, counters, launches, feats = counted_pass(
                    torch, np, planned, rows, ref,
                    f"{strategy} {layout} pass {i}")
                ref = feats if ref is None else ref
                k1 += launches
                passes.append({"seconds": seconds,
                               "images_per_s": N_IMAGES / seconds,
                               "launches": {KERNEL: launches},
                               "runner": counters})
            results.append({"layout": layout, "strategy": runner.strategy,
                            "max_inflight": runner.max_inflight,
                            "prefetch_depth": runner.prefetch_depth,
                            "warm_images_per_s": passes[1]["images_per_s"],
                            "passes": passes, "bit_identical": True})
    rings = []
    for depth in RING_DEPTHS:
        with runner_env(infeed_ring=depth):
            planned = featurizer().transform(df)
        runner = plan_runner(planned)
        passes = []
        for i in range(2):
            seconds, counters, launches, _ = counted_pass(
                torch, np, planned, rows, ref,
                f"ring {depth} pass {i}")
            k1 += launches
            stats = dict(vars(runner.ship_stats))
            passes.append({"seconds": seconds,
                           "images_per_s": N_IMAGES / seconds,
                           "launches": {KERNEL: launches},
                           "runner": counters, "ship_stats": stats})
        second = {k: passes[1]["ship_stats"][k] - passes[0]["ship_stats"][k]
                  for k in passes[1]["ship_stats"]}
        want = ring_replay(depth, N_IMAGES // BATCH)
        if second["hits"] != want:
            raise AssertionError(f"ring {depth}: {second['hits']} hits on "
                                 f"the second pass, its policy gives {want}")
        if depth >= N_IMAGES // BATCH and second["reshipped_bytes"]:
            raise AssertionError(f"ring {depth} holds the whole frame but "
                                 f"its second pass reshipped {second}")
        rings.append({"infeed_ring": depth, "strategy": runner.strategy,
                      "second_pass": second,
                      "second_pass_hits_by_policy": want, "passes": passes,
                      "ring_state": runner.ring_state(),
                      "bit_identical": True})

    # the headline under immediate against its deferred run
    df_head, mf_head, feats_head = head
    with runner_env(runner_strategy="immediate"):
        transformer = TensorTransformer(
            modelFunction=mf_head, inputMapping={"image": "image"},
            outputMapping={"features": "features"}, batchSize=BATCH)
        planned = transformer.transform(df_head)
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = planned.collect()
    torch.cuda.synchronize()
    head_s = time.perf_counter() - t0
    k2 = infeed.yuv420_launches
    if k2 != N_IMAGES // BATCH or infeed.launches:
        raise AssertionError(f"headline under immediate: K2 {k2}, K1 "
                             f"{infeed.launches}")
    feats = np.asarray(out["features"])
    if not np.array_equal(feats, feats_head):
        raise AssertionError(
            "headline: immediate differs from deferred at "
            f"{int((feats != feats_head).sum())} values")
    emit("strategies", model="InceptionV3", images=N_IMAGES, batch=BATCH,
         source_hw=[512, 512], runs=results, rings=rings,
         headline={"strategy": "immediate", "seconds": head_s,
                   "images_per_s": N_IMAGES / head_s,
                   "launches": {KERNEL_YUV420: k2},
                   "bit_identical_to_deferred": True,
                   "runner": runner_fields(transformer.metrics)},
         card=smi_line)
    return k1, k2, ref, results


def small_partitions(torch, np, smi_line, frame, ref, results):
    """The featurize frame's 512 images in 32 partitions of 16 rows: the
    engine cuts 64-row blocks across partitions, so the runner reports 8
    batches a pass, and the features equal the 8×64 frame's. Returns
    K1's launches on the counted pass."""
    from sparkdl_tpu_torch import DataFrame
    _, rows, _, _ = frame
    df = DataFrame.from_pylist(rows, num_partitions=SMALL_PARTITIONS)
    planned = featurizer().transform(df)
    cold_s, _, _, _ = counted_pass(torch, np, planned, rows, ref,
                                   "small partitions, cold")
    seconds, counters, launches, _ = counted_pass(
        torch, np, planned, rows, ref, "small partitions")
    if counters["batches"] != N_IMAGES // BATCH:
        raise AssertionError(f"small partitions: the runner ran "
                             f"{counters['batches']} batches, not "
                             f"{N_IMAGES // BATCH}")
    aligned = next(r for r in results if r["layout"] == "8x64"
                   and r["strategy"] == plan_runner(planned).strategy)
    emit("small_partitions", model="InceptionV3", images=N_IMAGES,
         partitions=SMALL_PARTITIONS, rows_per_partition=N_IMAGES //
         SMALL_PARTITIONS, batch=BATCH, launches={KERNEL: launches},
         runner_batches=counters["batches"], bit_identical_to_8x64=True,
         cold_s=cold_s, warm_s=seconds,
         warm_images_per_s=N_IMAGES / seconds,
         aligned_8x64_warm_images_per_s=aligned["warm_images_per_s"],
         runner=counters, card=smi_line)
    return launches

def cuda_probe(batch):
    """A host stage run in a pool worker: the worker's pid, whether it
    had loaded torch, and whether it has initialised CUDA."""
    import numpy as np
    loaded = "torch" in sys.modules
    import torch
    n = len(next(iter(batch.values())))
    return {"pid": np.full(n, os.getpid()),
            "torch_loaded": np.full(n, loaded),
            "cuda_initialized": np.full(n, torch.cuda.is_initialized())}


def pipe_frame(engine, partitions=PIPE_PARTITIONS):
    """The host pipeline phases' headline frame: each partition's source
    draws 64 textured 150×150 images from (seed 0, partition) where it
    loads, and a host stage packs them to 4:2:0 rows."""
    from sparkdl_tpu_torch.data.frame import DataFrame, Source
    from sparkdl_tpu_torch.utils.synth import PackYuv420, SeededImages
    per = PIPE_IMAGES // PIPE_PARTITIONS
    return DataFrame([Source(SeededImages(0, p, per, *HEADLINE_SRC), per)
                      for p in range(partitions)], engine=engine) \
        .map_batches(PackYuv420(), name="packYuv420")


def headline_transformer(mf):
    from sparkdl_tpu_torch import TensorTransformer
    return TensorTransformer(
        modelFunction=mf, inputMapping={"image": "image"},
        outputMapping={"features": "features"}, batchSize=BATCH)


def counter_values():
    from sparkdl_tpu_torch.obs import Counter, default_registry
    return {m.name: m.value for m in default_registry().metrics()
            if isinstance(m, Counter)}


def pipe_pass(torch, np, planned, images, kernel, what):
    """One collect with both kernels' counts set to 0 just before and
    read just after: its seconds, images/s, the registry's counter
    deltas, the overlap ratio ``(engine.busy_seconds + device.run_seconds)
    / wall`` and the launches; ``kernel``'s launches must be one a batch
    of 64, the other kernel's none."""
    from sparkdl_tpu_torch.ops import infeed
    before = counter_values()
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = planned.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {KERNEL: infeed.launches, KERNEL_YUV420: infeed.yuv420_launches}
    after = counter_values()
    delta = {k: v - before.get(k, 0.0) for k, v in after.items()
             if v != before.get(k, 0.0)}
    other = KERNEL if kernel == KERNEL_YUV420 else KERNEL_YUV420
    if launches[kernel] != images // BATCH or launches[other]:
        raise AssertionError(f"{what}: launches {launches}, {kernel} must "
                             f"launch {images // BATCH} times, {other} "
                             f"none")
    busy = delta.get("engine.busy_seconds", 0.0)
    device = delta.get("device.run_seconds", 0.0)
    return {"seconds": wall, "images_per_s": images / wall,
            "overlap_ratio": (busy + device) / wall,
            "engine_busy_s": busy, "device_run_s": device,
            "launches": {kernel: launches[kernel]},
            "counters": {k: v for k, v in delta.items()
                         if k.split(".")[0] in ("pipeline", "inputsvc")}}, out


def same_rows(np, out, ref, what):
    """``out`` against the reference pass bit for bit: the ``image``
    column (packed rows, or structs by origin: rows in order) and the
    features."""
    got_rows, ref_rows = out["image"], ref["image"]
    if got_rows.dtype == object:
        same = [r["origin"] for r in got_rows] == \
            [r["origin"] for r in ref_rows]
    else:
        same = np.array_equal(got_rows, ref_rows)
    if not same:
        raise AssertionError(f"{what}: rows differ from the serial pass "
                             "or came back out of order")
    feats, ref_feats = np.asarray(out["features"]), np.asarray(
        ref["features"])
    if feats.shape != ref_feats.shape or not np.isfinite(feats).all() \
            or not np.array_equal(feats, ref_feats):
        raise AssertionError(
            f"{what}: features differ from the serial pass at "
            f"{int((feats != ref_feats).sum())} values")


def shm_free():
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def shm_left(before):
    """Segments made since ``before`` that are still there after up to
    ``WAIT_S`` (abandoned fragments are unlinked as they land)."""
    deadline = time.monotonic() + WAIT_S
    while True:
        left = sorted(set(glob.glob(SHM_GLOB)) - before)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def host_pipeline(torch, np, smi_line, mf, proc_engine):
    """The headline through the parallel host pipeline: serial, then 4
    workers in thread mode, then in process mode (its first pass starts
    the pool); every output bit for bit the serial pass's, K2 16 times a
    pass, no process-pass fallback to threads, bytes through the
    hand-off, workers without CUDA, no segment left. Returns K2's
    launches over the counted passes, and the serial pass's output."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    shm_before = set(glob.glob(SHM_GLOB))
    engines = {"serial": LocalEngine(),
               "thread": LocalEngine(pipeline_workers=PIPE_WORKERS,
                                     pipeline_mode="thread"),
               "process": proc_engine}
    ref = None
    modes = {}
    k2 = 0
    try:
        for mode, engine in engines.items():
            planned = headline_transformer(mf).transform(pipe_frame(engine))
            passes = []
            for i in range(3 if mode == "process" else 2):
                what = f"host_pipeline {mode} pass {i}"
                result, out = pipe_pass(torch, np, planned, PIPE_IMAGES,
                                        KERNEL_YUV420, what)
                if ref is None:
                    ref = out
                else:
                    same_rows(np, out, ref, what)
                counters = result["counters"]
                if mode == "process" and (
                        counters.get("pipeline.fallbacks", 0.0)
                        or not counters.get("pipeline.handoff_bytes")):
                    raise AssertionError(f"{what}: not process mode "
                                         f"through the hand-off: "
                                         f"{counters}")
                k2 += result["launches"][KERNEL_YUV420]
                passes.append(result)
            warm = passes[1:] if mode == "process" else passes
            modes[mode] = {
                "workers": 0 if mode == "serial" else PIPE_WORKERS,
                "best_images_per_s": max(p["images_per_s"] for p in warm),
                "passes": passes}
            if mode == "process":
                modes[mode]["pool_start_pass_s"] = passes[0]["seconds"]
        from sparkdl_tpu_torch.data.frame import DataFrame
        probe = DataFrame.from_columns(
            {"i": np.arange(2 * PIPE_WORKERS)}, 2 * PIPE_WORKERS,
            engine=proc_engine).map_batches(cuda_probe).collect()
    finally:
        engines["serial"].shutdown()
        engines["thread"].shutdown()
    if probe["cuda_initialized"].any() or os.getpid() in set(probe["pid"]):
        raise AssertionError(f"a pool worker initialised CUDA: {probe}")
    left = shm_left(shm_before)
    if left:
        raise AssertionError(f"host_pipeline left segments {left}")
    serial = modes["serial"]["best_images_per_s"]
    emit("host_pipeline", model="InceptionV3", images=PIPE_IMAGES,
         partitions=PIPE_PARTITIONS, batch=BATCH,
         source_hw=list(HEADLINE_SRC),
         packed_row_bytes=int(ref["image"].shape[1]),
         cpu_count=os.cpu_count(), shm_free_bytes=shm_free(), modes=modes,
         speedup_vs_serial={m: v["best_images_per_s"] / serial
                            for m, v in modes.items()},
         bit_identical=True,
         worker_probe={"pids": sorted({int(p) for p in probe["pid"]}),
                       "torch_loaded": bool(probe["torch_loaded"].all()),
                       "cuda_initialized": False},
         shm_segments_left=0, card=smi_line)
    return k2, ref


def host_pipeline_k1(torch, np, smi_line, proc_engine):
    """The featurize configuration (K1) with its 512 seeded 512×512
    structs drawn where each partition loads, serial then twice on the
    process pool: the same features bit for bit, K1 8 times a pass, and
    the hand-off's bytes and seconds. Returns K1's launches over the
    three passes."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    from sparkdl_tpu_torch.data.frame import DataFrame, Source
    from sparkdl_tpu_torch.utils.synth import SeededImages
    shm_before = set(glob.glob(SHM_GLOB))
    per = N_IMAGES // PARTITIONS

    def frame(engine):
        return DataFrame([Source(SeededImages(K1_PIPE_SEED, p, per, 512, 512,
                                              textured=False), per)
                          for p in range(PARTITIONS)], engine=engine)

    serial_engine = LocalEngine()
    try:
        ref_pass, ref = pipe_pass(torch, np,
                                  featurizer().transform(frame(serial_engine)),
                                  N_IMAGES, KERNEL, "host_pipeline_k1 serial")
    finally:
        serial_engine.shutdown()
    planned = featurizer().transform(frame(proc_engine))
    passes = []
    # the first pass also loads the pack stage's modules (torch among
    # them) in each worker
    for i in range(2):
        what = f"host_pipeline_k1 process pass {i}"
        result, out = pipe_pass(torch, np, planned, N_IMAGES, KERNEL, what)
        same_rows(np, out, ref, what)
        counters = result["counters"]
        if counters.get("pipeline.fallbacks", 0.0) or \
                counters.get("pipeline.shm_segments", 0.0) != PARTITIONS:
            raise AssertionError(f"{what}: every fragment must come "
                                 f"through shared memory: {counters}")
        passes.append(result)
    left = shm_left(shm_before)
    if left:
        raise AssertionError(f"host_pipeline_k1 left segments {left}")
    warm = passes[1]["counters"]
    emit("host_pipeline_k1", model="InceptionV3", images=N_IMAGES,
         partitions=PARTITIONS, batch=BATCH, source_hw=[512, 512],
         workers=PIPE_WORKERS, serial=ref_pass, process_passes=passes,
         warm_images_per_s={"serial": ref_pass["images_per_s"],
                            "process": passes[1]["images_per_s"]},
         handoff_bytes=warm.get("pipeline.handoff_bytes", 0.0),
         handoff_s=warm.get("pipeline.handoff_seconds", 0.0),
         bit_identical=True, shm_segments_left=0, card=smi_line)
    return sum(p["launches"][KERNEL] for p in [ref_pass] + passes)


def start_decode_server(repo):
    """``python -m sparkdl_tpu_torch.inputsvc serve --port 0`` as a
    subprocess: (process, its ``host:port`` from the READY line, read
    within ``WAIT_S``)."""
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparkdl_tpu_torch.inputsvc", "serve",
         "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env, cwd=repo)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        line = lines.get(timeout=WAIT_S)
    except queue.Empty:
        proc.kill()
        raise AssertionError("a decode server printed no READY line") \
            from None
    if "READY" not in line:
        proc.kill()
        raise AssertionError(f"decode server: {line!r}")
    return proc, line.split()[-1]


def dead_endpoint():
    """A local port nothing listens on."""
    sock = socket.create_server(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return f"127.0.0.1:{port}"


def input_service(torch, np, smi_line, mf, ref, repo):
    """The headline frame with its host prefix on a decode fleet of
    server subprocesses: widths 1 and 2, then 2 live beside a dead
    endpoint; every output bit for bit the serial pass's, no local
    decode or RPC error on the live fleet, the dead endpoint counted.
    Returns K2's launches over the three passes."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    t0 = time.perf_counter()
    servers = []
    try:
        with ThreadPoolExecutor(FLEET_WIDTH) as pool:
            for f in [pool.submit(start_decode_server, repo)
                      for _ in range(FLEET_WIDTH)]:
                servers.append(f.result())
        start_s = time.perf_counter() - t0
        endpoints = [ep for _, ep in servers]
        # each server imports the port's decode modules on its first
        # request: a two-partition stream warms both
        warm = LocalEngine(inputsvc_endpoints=endpoints)
        try:
            pipe_frame(warm, partitions=FLEET_WIDTH).collect()
        finally:
            warm.shutdown()
        runs = {"width_1": endpoints[:1], "width_2": endpoints,
                "width_2_and_dead": endpoints + [dead_endpoint()]}
        results = {}
        k2 = 0
        for name, fleet in runs.items():
            engine = LocalEngine(inputsvc_endpoints=fleet)
            try:
                planned = headline_transformer(mf).transform(pipe_frame(engine))
                result, out = pipe_pass(torch, np, planned, PIPE_IMAGES,
                                        KERNEL_YUV420, f"input_service {name}")
            finally:
                engine.shutdown()
            same_rows(np, out, ref, f"input_service {name}")
            c = result["counters"]
            if c.get("inputsvc.local_decodes", 0.0) or \
                    c.get("inputsvc.rpc_errors", 0.0) or \
                    c.get("inputsvc.fallbacks", 0.0) or \
                    c.get("inputsvc.tasks", 0.0) != PIPE_PARTITIONS:
                raise AssertionError(f"input_service {name}: {c}")
            down = c.get("inputsvc.endpoints_down", 0.0)
            if down != (1 if name == "width_2_and_dead" else 0):
                raise AssertionError(f"input_service {name}: "
                                     f"{down} endpoints counted down")
            k2 += result["launches"][KERNEL_YUV420]
            results[name] = {"endpoints": len(fleet), **result}
    finally:
        for proc, _ in servers:
            proc.terminate()
        for proc, _ in servers:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=15)
    emit("input_service", model="InceptionV3", images=PIPE_IMAGES,
         partitions=PIPE_PARTITIONS, batch=BATCH, servers=FLEET_WIDTH,
         server_start_s=start_s, runs=results,
         images_per_s={k: v["images_per_s"] for k, v in results.items()},
         bit_identical=True, card=smi_line)
    return k2


def snapshot_phase(torch, np, smi_line, mf, ref):
    """``DataFrame.snapshot`` over the headline frame, through the device
    stage: a cold epoch writes 16 chunks, a warm one reads all 16 back;
    both outputs bit for bit the serial pass's. Returns K2's launches
    over both epochs."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    engine = LocalEngine()
    epochs = {}
    k2 = 0
    try:
        with tempfile.TemporaryDirectory() as root:
            base = pipe_frame(engine)
            for epoch in ("cold", "warm"):
                planned = headline_transformer(mf).transform(
                    base.snapshot(root, fingerprint="seed0-1024x150x150"))
                result, out = pipe_pass(torch, np, planned, PIPE_IMAGES,
                                        KERNEL_YUV420, f"snapshot {epoch}")
                same_rows(np, out, ref, f"snapshot {epoch}")
                k2 += result["launches"][KERNEL_YUV420]
                epochs[epoch] = result
    finally:
        engine.shutdown()
    cold, warm = epochs["cold"]["counters"], epochs["warm"]["counters"]
    if cold.get("inputsvc.snapshot_misses") != PIPE_PARTITIONS or \
            warm.get("inputsvc.snapshot_hits") != PIPE_PARTITIONS or \
            warm.get("inputsvc.snapshot_misses", 0.0):
        raise AssertionError(f"snapshot: cold {cold}, warm {warm}")
    emit("snapshot", model="InceptionV3", images=PIPE_IMAGES,
         partitions=PIPE_PARTITIONS, batch=BATCH, epochs=epochs,
         images_per_s={k: v["images_per_s"] for k, v in epochs.items()},
         engine_busy_s={k: v["engine_busy_s"] for k, v in epochs.items()},
         bit_identical=True, card=smi_line)
    return k2



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


def lr_agreement(np, card, cpu, frame):
    """A fit on the card against the same fit on the CPU: the largest
    relative difference of their objective histories and the largest
    difference of their probabilities on ``frame``."""
    h_card = np.asarray(card.objectiveHistory)
    h_cpu = np.asarray(cpu.objectiveHistory)
    if h_card.shape != h_cpu.shape or not np.isfinite(h_card).all():
        raise AssertionError(f"objective histories {h_card.shape} and "
                             f"{h_cpu.shape}, finite="
                             f"{np.isfinite(h_card).all()}")
    p_card = card.transform(frame).collect()["probability"]
    p_cpu = cpu.transform(frame).collect()["probability"]
    hist_rel = float(np.abs(h_card / h_cpu - 1).max())
    prob = float(np.abs(p_card - p_cpu).max())
    if not (hist_rel <= LR_BOUND_HISTORY_REL and prob <= LR_BOUND_PROB):
        raise AssertionError(
            f"card against CPU: history {hist_rel} (bound "
            f"{LR_BOUND_HISTORY_REL}), probabilities {prob} (bound "
            f"{LR_BOUND_PROB})")
    return {"history_rel_max_diff": hist_rel, "prob_max_abs_diff": prob,
            "bound_history_rel": LR_BOUND_HISTORY_REL,
            "bound_prob": LR_BOUND_PROB}


def lr_fields(model):
    """A fitted model's ``fitStats`` with its ms a step."""
    st = dict(model.fitStats)
    st["ms_per_iteration"] = st["train_s"] / st["steps"] * 1e3
    st["final_loss"] = float(model.objectiveHistory[-1])
    return st


def transfer(torch, np, smi_line, frame):
    """``Pipeline([DeepImageFeaturizer(InceptionV3, deviceResizeFrom=
    (512, 512)), LogisticRegression(maxIter=100, regParam=1e-3)])`` fitted
    on the card over the featurize phase's frame with labels ``i % 10``,
    then transform and ``ClassificationEvaluator``: K1 launches 8 times
    in the fit's collect and 8 times in the transform (the counted run;
    the runner's output-shape probe is a trace that launches nothing); the
    same fit on the CPU over the collected features agrees within the
    stated bounds; the saved and reloaded model transforms to the same
    bits. Returns K1's launches."""
    import tempfile

    from sparkdl_tpu_torch import (
        ClassificationEvaluator,
        DataFrame,
        LogisticRegression,
        Pipeline,
        load_model,
    )
    from sparkdl_tpu_torch.ops import infeed

    _, rows, _, _ = frame
    labels = np.arange(N_IMAGES) % LR_CLASSES
    df = DataFrame.from_pylist([{**r, "label": int(l)}
                                for r, l in zip(rows, labels)],
                               num_partitions=PARTITIONS)
    pipe = Pipeline(stages=[featurizer(), LogisticRegression(
        maxIter=LR_ITERS, regParam=LR_REG)])
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    model = pipe.fit(df)
    fit_s = time.perf_counter() - t0
    fit_launches = infeed.launches
    t1 = time.perf_counter()
    out = model.transform(df).collect()
    transform_s = time.perf_counter() - t1
    launches = infeed.launches
    # one launch a batch in the fit's collect and in the transform; the
    # memory-budget estimate reads the frame's zero-row schema, whose
    # empty output the runner shapes from the model's output signature,
    # a trace that launches nothing (the JAX package's eval_shape)
    per_pass = N_IMAGES // BATCH
    if fit_launches != per_pass or launches != 2 * per_pass \
            or infeed.yuv420_launches:
        raise AssertionError(f"transfer: K1 launched {fit_launches} times "
                             f"in the fit and {launches} in all, K2 "
                             f"{infeed.yuv420_launches}")
    check_order(out, rows)
    lr = model.stages[1]
    st = lr_fields(lr)
    if st["mode"] != "full_batch" or not st["device"].startswith("cuda"):
        raise AssertionError(f"the fit ran {st['mode']} on {st['device']}")
    feats = np.asarray(out["features"])
    probs = np.asarray(out["probability"])
    sums = float(np.abs(probs.sum(1) - 1).max())
    if feats.shape != (N_IMAGES, FEATURES) or \
            probs.shape != (N_IMAGES, LR_CLASSES) or \
            not np.isfinite(probs).all() or not sums <= 1e-5:
        raise AssertionError(f"features {feats.shape}, probabilities "
                             f"{probs.shape}, finite="
                             f"{np.isfinite(probs).all()}, sums off by "
                             f"{sums}")
    accuracy = ClassificationEvaluator().evaluate(DataFrame.from_columns(
        {"prediction": out["prediction"], "label": out["label"]}))
    # the same fit on the CPU, from the same seed, on these features
    features = DataFrame.from_columns({"features": feats, "label": labels},
                                      PARTITIONS)
    cpu = LogisticRegression(maxIter=LR_ITERS, regParam=LR_REG,
                             device="cpu").fit(features)
    agreement = lr_agreement(np, lr, cpu, features)
    with tempfile.TemporaryDirectory() as d:
        model.save(os.path.join(d, "model"))
        again = load_model(os.path.join(d, "model")).transform(df).collect()
    reload_equal = {k: bool(np.array_equal(again[k], out[k]))
                    for k in ("features", "probability", "prediction")}
    # the LR's own work: its fit less the collect (the featurizer's run)
    # and the estimate (the featurizer's output-shape trace); what its
    # timed parts leave is the host work between them (labels, one-hot)
    lr_fit_s = st["fit_s"] - st["collect_s"] - st["estimate_s"]
    st["other_s"] = lr_fit_s - st["setup_s"] - st["upload_s"] - st["train_s"]
    emit("transfer", model="InceptionV3", images=N_IMAGES,
         partitions=PARTITIONS, classes=LR_CLASSES, max_iter=LR_ITERS,
         reg=LR_REG, launches={KERNEL: launches, "fit": fit_launches},
         fit_s=fit_s, featurize_s=fit_s - lr_fit_s, lr_fit_s=lr_fit_s,
         lr=st, transform_s=transform_s, prob_sum_max_diff=sums,
         train_accuracy=accuracy, cpu_agreement=agreement,
         reload_bit_equal=reload_equal, card=smi_line)
    if not all(reload_equal.values()):
        raise AssertionError(f"the reloaded model's transform differs: "
                             f"{reload_equal}")
    return launches


def signatures_launch_nothing(torch, infeed, functions):
    """``output_signature()`` of each function: a trace under
    ``FakeTensorMode``, which must launch no kernel and leave the card's
    allocated memory as it was. Returns the functions' names."""
    torch.cuda.synchronize()
    before = (infeed.launches, infeed.yuv420_launches,
              torch.cuda.memory_allocated())
    for mf in functions:
        mf.output_signature()
    torch.cuda.synchronize()
    after = (infeed.launches, infeed.yuv420_launches,
             torch.cuda.memory_allocated())
    if after != before:
        raise AssertionError(f"output_signature launched or allocated: "
                             f"(K1, K2, bytes) {before} -> {after}")
    return [mf.name for mf in functions]


def inception_net(torch, np):
    """InceptionV3 (bf16, fp32 BN, the zoo's seeded weights) as a
    ModelFunction of float32 NHWC images already scaled to [-1, 1]: the
    zoo's network without its preprocess, for a converter piece to feed."""
    from sparkdl_tpu_torch.graph import ModelFunction
    from sparkdl_tpu_torch.models import zoo

    class NHWCFeatures(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            # the zoo's layout: an NHWC batch viewed as channels_last NCHW
            return self.net(x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last), features_only=True)

    spec = zoo.getKerasApplicationModel("InceptionV3")
    net = zoo.build_module(spec.module_fn, zoo.load_state_dict(spec.name),
                           torch.device("cuda"))
    return ModelFunction.fromSingle(
        NHWCFeatures(net), input_shape=(299, 299, 3),
        input_dtype=np.float32, input_name="converted",
        output_name="features", name="InceptionV3:net")


def graph_phase(torch, np, smi_line, frame, ref):
    """``ModelFunction.fromList([buildSpImageConverter(299, 299, scale=
    1/127.5, offset=-1), InceptionV3])`` through ``TFImageTransformer(
    deviceResizeFrom=(512, 512))`` over the featurize frame (the counted
    run: K1 8 times), against the featurizer's features ``ref``;
    ``rename_io`` and ``select_outputs`` of it on one batch, bit for bit;
    and the output signatures of the phase's functions, which launch
    nothing. Returns K1's launches."""
    from sparkdl_tpu_torch import TFImageTransformer
    from sparkdl_tpu_torch.graph import (
        ModelFunction,
        buildSpImageConverter,
        utils as tfx,
    )
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    imgs, rows, df, _ = frame
    t0 = time.perf_counter()
    converter = buildSpImageConverter(299, 299, scale=1 / 127.5,
                                      offset=-1.0)
    net = inception_net(torch, np)
    mf = ModelFunction.fromList([converter, net],
                                name="spImageConverter+InceptionV3")
    build_s = time.perf_counter() - t0
    transformer = TFImageTransformer(
        inputCol="image", outputCol="features", modelFunction=mf,
        deviceResizeFrom=(512, 512), batchSize=BATCH)
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = transformer.transform(df).collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {KERNEL: infeed.launches, KERNEL_YUV420: infeed.yuv420_launches}
    if launches != {KERNEL: N_IMAGES // BATCH, KERNEL_YUV420: 0}:
        raise AssertionError(f"graph launches {launches}: K1 must launch "
                             f"{N_IMAGES // BATCH} times and K2 none")
    check_order(out, rows)
    feats = np.asarray(out["features"])
    if feats.shape != (N_IMAGES, FEATURES) or not np.isfinite(feats).all():
        raise AssertionError(f"features {feats.shape}, finite="
                             f"{np.isfinite(feats).all()}")
    rel = rel_diff(feats, ref)
    if not rel <= BOUND_FEATURES_REL:
        raise AssertionError(f"composed vs DeepImageFeaturizer: relative "
                             f"max|diff| {rel} > {BOUND_FEATURES_REL}")

    # the wrappers on one batch, against the composed function itself
    renamed = mf.rename_io({"image": "pixels"}, {"features": "emb"})
    selected = tfx.select_outputs(mf, ["features"])
    x = torch.from_numpy(imgs[:BATCH]).cuda()
    wrappers = {}
    for what, fn, in_name, out_name in (
            ("composed", mf, "image", "features"),
            ("rename_io", renamed, "pixels", "emb"),
            ("select_outputs", selected, "image", "features")):
        resized = deviceResizeModel(fn, (512, 512))
        wrappers[what] = resized.apply({in_name: x})[out_name] \
            .float().cpu().numpy()
    same = {k: bool(np.array_equal(v, wrappers["composed"]))
            for k, v in wrappers.items()}
    functions = [converter, net, mf, renamed, selected,
                 deviceResizeModel(mf, (512, 512))]
    names = signatures_launch_nothing(torch, infeed, functions)
    emit("graph", model="InceptionV3", images=N_IMAGES, batch=BATCH,
         functions=names, launches=launches, build_s=build_s,
         seconds=seconds, images_per_s=N_IMAGES / seconds,
         vs_featurizer_rel_max_diff=rel,
         vs_featurizer_bit_equal=bool(np.array_equal(feats, ref)),
         bound=BOUND_FEATURES_REL, wrappers_bit_equal=same,
         batch_matches_pass=bool(np.array_equal(wrappers["composed"],
                                                feats[:BATCH])),
         card=smi_line)
    if not all(same.values()):
        raise AssertionError(f"rename_io / select_outputs changed the "
                             f"bits: {same}")
    return launches[KERNEL]


FRESH_PROCESS = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import sparkdl_tpu_torch
from sparkdl_tpu_torch.ops import infeed
stage_dir, rows_path, out_path = sys.argv[1:4]
stage = sparkdl_tpu_torch.load_model(stage_dir)
load_s = time.perf_counter() - t0
packed = np.load(rows_path)
df = sparkdl_tpu_torch.DataFrame.from_columns({"image": packed},
                                              num_partitions=int(sys.argv[4]))
infeed.launches = infeed.yuv420_launches = 0
t1 = time.perf_counter()
out = stage.transform(df).collect()
transform_s = time.perf_counter() - t1
np.save(out_path, np.asarray(out["features"]))
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "sparkdl_tpu", "keras"))
print(json.dumps({"k1": infeed.launches, "k2": infeed.yuv420_launches,
                  "import_and_load_s": load_s, "transform_s": transform_s,
                  "banned_modules": banned}))
"""


def export_phase(torch, np, smi_line, head, repo):
    """The headline's function exported with a symbolic batch and with a
    fixed batch of 64 (bytes and seconds of each), loaded back
    (``ModelIngest.fromExport``) and run through ``TFTransformer`` over
    the headline frame (the counted run: K2 8 times, K1 none), bit for
    bit the un-exported pass; the fixed-batch program refusing 32 rows
    and bytes that are no program refused; and a ``TensorTransformer``
    holding the function saved, then loaded by a fresh ``python3 -c``
    process that imports only ``sparkdl_tpu_torch``, which runs the same
    rows (K2 8 times) and hands its features back through an ``.npy``
    file, bit for bit. The fresh process starts right after the save and
    runs beside the exports and loads here (its start is mostly torch's
    import); the counted run waits for it. Returns K2's launches here
    and in the fresh process."""
    import tempfile

    from sparkdl_tpu_torch import ModelIngest, TensorTransformer, TFTransformer
    from sparkdl_tpu_torch.ops import infeed

    df, mf, ref = head
    packed = np.asarray(df.collect()["image"])
    sizes, seconds, blobs = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(
            repo, "sparkdl_tpu_torch", "_build")) as d:
        stage_dir = os.path.join(d, "stage")
        t0 = time.perf_counter()
        TensorTransformer(modelFunction=mf, inputMapping={"image": "image"},
                          outputMapping={"features": "features"},
                          batchSize=BATCH).save(stage_dir)
        seconds["save_s"] = time.perf_counter() - t0
        saved = {f: os.path.getsize(os.path.join(stage_dir, f))
                 for f in sorted(os.listdir(stage_dir))}
        rows_path = os.path.join(d, "rows.npy")
        out_path = os.path.join(d, "features.npy")
        np.save(rows_path, packed)
        t_fresh = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-c", FRESH_PROCESS, stage_dir, rows_path,
             out_path, str(PARTITIONS)], cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            for what, batch in (("symbolic", None), ("fixed", BATCH)):
                t0 = time.perf_counter()
                blobs[what] = mf.export(batch_size=batch)
                seconds[f"export_{what}_s"] = time.perf_counter() - t0
                sizes[what] = len(blobs[what])
            t0 = time.perf_counter()
            loaded = ModelIngest.fromExport(blobs["symbolic"],
                                            name="headline")
            seconds["load_symbolic_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fixed = ModelIngest.fromExport(blobs["fixed"], name="headline64")
            seconds["load_fixed_s"] = time.perf_counter() - t0
            stdout, stderr = child.communicate(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        seconds["fresh_process_s"] = time.perf_counter() - t_fresh
        if child.returncode != 0:
            raise AssertionError(f"the fresh process failed: "
                                 f"{stderr[-2000:]}")
        fresh = json.loads(stdout.strip().splitlines()[-1])
        fresh_feats = np.load(out_path)

    transformer = TFTransformer(
        modelFunction=loaded, inputMapping={"image": "image"},
        outputMapping={"features": "features"}, batchSize=BATCH)
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = transformer.transform(df).collect()
    torch.cuda.synchronize()
    seconds["exported_pass_s"] = time.perf_counter() - t0
    launches = {KERNEL_YUV420: infeed.yuv420_launches,
                KERNEL: infeed.launches}
    if launches != {KERNEL_YUV420: N_IMAGES // BATCH, KERNEL: 0}:
        raise AssertionError(f"export launches {launches}: K2 must launch "
                             f"{N_IMAGES // BATCH} times and K1 none")
    feats = np.asarray(out["features"])
    exported_equal = bool(np.array_equal(feats, ref))

    # the fixed batch: 64 rows run, 32 are refused with the port's
    # ValueError
    x = torch.from_numpy(packed[:BATCH]).cuda()
    fixed_equal = bool(np.array_equal(
        fixed.apply({"image": x})["features"].cpu().numpy(), ref[:BATCH]))
    refusals = {}
    half = f"batch_{BATCH // 2}"
    try:
        fixed.apply({"image": x[:BATCH // 2]})
    except ValueError as e:
        refusals[half] = str(e)
    try:
        ModelIngest.fromExport(b"\x00not a program" * 8)
    except ValueError as e:
        refusals["not_an_export"] = str(e)[:80]
    if set(refusals) != {half, "not_an_export"}:
        raise AssertionError(f"refusals {refusals}")
    names = signatures_launch_nothing(torch, infeed, [mf, loaded, fixed])

    fresh_equal = bool(np.array_equal(fresh_feats, ref))
    diffs = {"exported": float(np.abs(feats - ref).max()),
             "fresh_process": float(np.abs(fresh_feats - ref).max())}
    emit("export", model="InceptionV3", source_hw=list(HEADLINE_SRC),
         bytes=sizes, seconds=seconds, saved_files=saved,
         launches=launches, exported_bit_equal=exported_equal,
         fixed_batch_bit_equal=fixed_equal, refusals=refusals,
         signature_functions=names, fresh_process=fresh,
         fresh_process_bit_equal=fresh_equal, max_abs_diff=diffs,
         card=smi_line)
    if not (exported_equal and fixed_equal and fresh_equal):
        raise AssertionError(
            f"exported pass equal {exported_equal}, fixed batch equal "
            f"{fixed_equal}, fresh process equal {fresh_equal}: {diffs}")
    if (fresh["k2"], fresh["k1"]) != (N_IMAGES // BATCH, 0) or \
            fresh["banned_modules"]:
        raise AssertionError(f"the fresh process: {fresh}")
    return launches[KERNEL_YUV420], fresh["k2"]


def udf_phase(torch, np, smi_line, frame):
    """``makeModelUDF`` of the InceptionV3 featurizer behind
    ``deviceResizeFrom=(512, 512)`` with ``kind="image"``, then
    ``callUDF`` over the featurize frame (the counted run: K1 8 times),
    bit for bit ``ImageTransformer``'s pass over the same function; the
    UDF's direct call on one batch of 64 equals those rows. Returns K1's
    launches and the function."""
    from sparkdl_tpu_torch import ImageTransformer
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    from sparkdl_tpu_torch.udf import callUDF, makeModelUDF, unregisterUDF

    imgs, rows, df, _ = frame
    mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"), (512, 512))
    udf = makeModelUDF(mf, "inception_features", kind="image",
                       batch_size=BATCH, replace=True)
    try:
        infeed.launches = infeed.yuv420_launches = 0
        t0 = time.perf_counter()
        out = callUDF("inception_features", df, "image", "features") \
            .collect()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {KERNEL: infeed.launches,
                    KERNEL_YUV420: infeed.yuv420_launches}
        if launches != {KERNEL: N_IMAGES // BATCH, KERNEL_YUV420: 0}:
            raise AssertionError(f"udf launches {launches}: K1 must launch "
                                 f"{N_IMAGES // BATCH} times and K2 none")
        check_order(out, rows)
        feats = np.asarray(out["features"])
        ref = np.asarray(ImageTransformer(
            inputCol="image", outputCol="features", modelFunction=mf,
            batchSize=BATCH).transform(df).collect()["features"])
        direct = np.asarray(udf(imgs[:BATCH]))
    finally:
        unregisterUDF("inception_features")
    same = bool(np.array_equal(feats, ref))
    direct_same = bool(np.array_equal(direct, feats[:BATCH]))
    names = signatures_launch_nothing(torch, infeed, [mf])
    emit("udf", model="InceptionV3", images=N_IMAGES, batch=BATCH,
         launches=launches, seconds=seconds,
         images_per_s=N_IMAGES / seconds,
         finite=bool(np.isfinite(feats).all()),
         features_shape=list(feats.shape),
         image_transformer_bit_equal=same, direct_call_bit_equal=direct_same,
         signature_functions=names, card=smi_line)
    if feats.shape != (N_IMAGES, FEATURES) or not np.isfinite(feats).all() \
            or not same or not direct_same:
        raise AssertionError(f"udf: shape {feats.shape}, equal to "
                             f"ImageTransformer {same}, direct call "
                             f"{direct_same}")
    return launches[KERNEL]


def transfer_trained(torch, np, smi_line):
    """The committed TestNet's features over its provenance's dataset:
    ``Pipeline([DeepImageFeaturizer("TestNet"), LogisticRegression()])``
    fitted on the train split and scored on the held-out split, then
    ``CrossValidator`` and ``TrainValidationSplit`` over a grid of
    ``regParam`` × ``maxIter`` on the cached featurized train split; each
    best model's held-out accuracy at least 0.95."""
    from sparkdl_tpu_torch import (
        ClassificationEvaluator,
        CrossValidator,
        DataFrame,
        DeepImageFeaturizer,
        LogisticRegression,
        ParamGridBuilder,
        Pipeline,
        TrainValidationSplit,
    )
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.testnet import synthetic_testnet_dataset

    with open(os.path.join(zoo.ARTIFACTS_DIR,
                           "TestNet.provenance.json")) as f:
        ds = json.load(f)["dataset"]

    def split(n, seed):
        x, y = synthetic_testnet_dataset(n, seed=seed, noise=ds["noise"],
                                         proto_seed=ds["proto_seed"])
        return DataFrame.from_pylist(
            [{"image": imageArrayToStruct(a, origin=f"r{i}"),
              "label": int(l)} for i, (a, l) in enumerate(zip(x, y))],
            num_partitions=PARTITIONS)

    train = split(ds["n_train"], ds["seed"])
    test = split(ds["n_eval"], ds["eval_seed"])
    ev = ClassificationEvaluator()

    def featurizer_testnet():
        return DeepImageFeaturizer(modelName="TestNet", inputCol="image",
                                   outputCol="features", batchSize=BATCH)

    t0 = time.perf_counter()
    model = Pipeline(stages=[featurizer_testnet(),
                             LogisticRegression()]).fit(train)
    fit_s = time.perf_counter() - t0
    accuracy = ev.evaluate(model.transform(test))
    train_f = featurizer_testnet().transform(train).cache()
    test_f = featurizer_testnet().transform(test).cache()
    grid = ParamGridBuilder().addGrid(LogisticRegression.regParam, TUNE_REG) \
        .addGrid(LogisticRegression.maxIter, TUNE_ITERS).build()
    tuned = {}
    for name, tuner in (
            ("cross_validator", CrossValidator(
                estimator=LogisticRegression(), estimatorParamMaps=grid,
                evaluator=ev, numFolds=TUNE_FOLDS)),
            ("train_validation_split", TrainValidationSplit(
                estimator=LogisticRegression(), estimatorParamMaps=grid,
                evaluator=ev, trainRatio=TUNE_TRAIN_RATIO))):
        t = time.perf_counter()
        fitted = tuner.fit(train_f)
        metrics = getattr(fitted, "avgMetrics", None) \
            or fitted.validationMetrics
        tuned[name] = {"seconds": time.perf_counter() - t,
                       "metrics": [float(m) for m in metrics],
                       "best_held_out_accuracy": ev.evaluate(
                           fitted.transform(test_f)),
                       "best": lr_fields(fitted.bestModel)}
    emit("transfer_trained", model="TestNet", dataset=ds,
         train_rows=ds["n_train"], held_out_rows=ds["n_eval"],
         fit_s=fit_s, lr=lr_fields(model.stages[1]),
         held_out_accuracy=accuracy, min_accuracy=TESTNET_MIN_ACCURACY,
         grid={"regParam": list(TUNE_REG), "maxIter": list(TUNE_ITERS)},
         num_folds=TUNE_FOLDS, train_ratio=TUNE_TRAIN_RATIO, tuned=tuned,
         card=smi_line)
    accuracies = [accuracy] + [t["best_held_out_accuracy"]
                               for t in tuned.values()]
    if not all(a >= TESTNET_MIN_ACCURACY for a in accuracies) or not all(
            np.isfinite(t["metrics"]).all() for t in tuned.values()):
        raise AssertionError(f"transfer_trained: held-out accuracies "
                             f"{accuracies}, metrics "
                             f"{[t['metrics'] for t in tuned.values()]}")


def logreg_scale(torch, np, smi_line):
    """``LogisticRegression`` alone on 262,144 × 2,048 fp32 seeded
    features (10 classes, 64 partitions): full-batch for 100 steps with
    its ms a step beside the bound, the step alone on the resident table
    by CUDA events, one minibatch and one streaming epoch at batch 4096,
    the default memory budget's switch to streaming, and the card
    against the CPU on the first 8,192 rows."""
    import logging

    from sparkdl_tpu_torch import ClassificationEvaluator, DataFrame
    from sparkdl_tpu_torch import LogisticRegression
    from sparkdl_tpu_torch.estimators.logistic_regression import (
        _AdamTrainer,
    )

    t0 = time.perf_counter()
    # seeded on the card: class means 5e-4 apart in scale under N(0, 0.01)
    # noise, so the classes overlap and the probabilities stay off 0 and 1
    g = torch.Generator(device="cuda").manual_seed(0)
    means = torch.randn(LR_CLASSES, FEATURES, generator=g,
                        device="cuda") * 5e-4
    y = np.arange(LR_ROWS) % LR_CLASSES
    X = (means[torch.from_numpy(y).cuda()] + 0.01 * torch.randn(
        LR_ROWS, FEATURES, generator=g, device="cuda")).cpu().numpy()
    setup_s = time.perf_counter() - t0
    df = DataFrame.from_columns({"features": X, "label": y}, LR_PARTITIONS)

    full = LogisticRegression(maxIter=LR_ITERS, memoryBudgetBytes=0).fit(df)
    full_st = lr_fields(full)
    if full_st["mode"] != "full_batch" or \
            not np.isfinite(full.objectiveHistory).all():
        raise AssertionError(f"full-batch fit: {full_st}")
    # the step alone on the resident table, as the fit runs it
    Xd = torch.from_numpy(X).cuda()
    Yd = torch.from_numpy(np.eye(LR_CLASSES, dtype=np.float32)[y]).cuda()
    trainer = _AdamTrainer(full.coefficients, full.intercept,
                           torch.device("cuda"), 0.1, 0.0)
    step_ms = events_ms(torch, lambda: trainer.step(Xd, Yd), iters=20,
                        warmup=3)
    del Xd, Yd, trainer
    # the step reads X twice (the logits, then the weights' gradient)
    nbytes = 2 * X.nbytes
    flops = 4 * LR_ROWS * FEATURES * LR_CLASSES
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    train_accuracy = ClassificationEvaluator().evaluate(full.transform(df))

    modes = {}
    for name, kw in (("minibatch", dict(memoryBudgetBytes=0)),
                     ("streaming", dict(streaming=True))):
        m = LogisticRegression(maxIter=1, batchSize=LR_BATCH, **kw).fit(df)
        modes[name] = lr_fields(m)
        if modes[name]["mode"] != name or \
                modes[name]["steps"] != LR_ROWS // LR_BATCH or \
                not np.isfinite(m.objectiveHistory).all():
            raise AssertionError(f"{name} fit: {modes[name]}")

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    capture = Capture()
    lr_logger = logging.getLogger(
        "sparkdl_tpu_torch.estimators.logistic_regression")
    lr_logger.addHandler(capture)
    try:
        auto = LogisticRegression(maxIter=1).fit(df)
    finally:
        lr_logger.removeHandler(capture)
    switched = any("auto-switching to the streaming fit" in m
                   for m in capture.messages)
    modes["auto_switch"] = {**lr_fields(auto), "warned": switched}
    if not switched or auto.fitStats["mode"] != "streaming":
        raise AssertionError(f"default budget: {modes['auto_switch']}")

    small = DataFrame.from_columns({"features": X[:LR_CHECK_ROWS],
                                    "label": y[:LR_CHECK_ROWS]}, PARTITIONS)
    card = LogisticRegression(maxIter=LR_CHECK_ITERS).fit(small)
    cpu = LogisticRegression(maxIter=LR_CHECK_ITERS,
                             device="cpu").fit(small)
    agreement = lr_agreement(np, card, cpu, small)
    emit("logreg_scale", rows=LR_ROWS, features=FEATURES,
         classes=LR_CLASSES, partitions=LR_PARTITIONS,
         table_bytes=X.nbytes, setup_s=setup_s, full_batch=full_st,
         step_device_ms=step_ms, bound_ms=bound_ms,
         bound_by="bytes" if t_bytes >= t_ops else "operations",
         bound_bytes=nbytes, bound_flops=flops,
         bound_share=bound_ms / full_st["ms_per_iteration"],
         step_bound_share=bound_ms / step_ms,
         train_accuracy=train_accuracy, modes=modes,
         cpu_check={"rows": LR_CHECK_ROWS, "iterations": LR_CHECK_ITERS,
                    **agreement}, card=smi_line)


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
    k1_paths = {}
    k1_paths["featurize"], featurize_ref = featurize(torch, np, smi, frame)
    k1_paths["predict"] = predict(torch, np, smi, frame)
    k1_paths["zoo"], zoo_ms = zoo_models(torch, np, smi, frame)
    yuv_launches, head = headline(torch, np, smi)
    runner_split(torch, np, smi, frame, zoo_ms)
    k1_paths["strategies"], yuv_strategies, ref, runs = strategies(
        torch, np, smi, frame, head)
    k1_paths["small_partitions"] = small_partitions(torch, np, smi, frame,
                                                    ref, runs)
    # the parallel host pipeline and the input service under both paths;
    # one process pool serves host_pipeline and host_pipeline_k1
    from sparkdl_tpu_torch.data.engine import LocalEngine
    proc_engine = LocalEngine(pipeline_workers=PIPE_WORKERS,
                              pipeline_mode="process")
    t0 = time.perf_counter()
    try:
        yuv_pipe, pipe_ref = host_pipeline(torch, np, smi, head[1],
                                           proc_engine)
        k1_paths["host_pipeline_k1"] = host_pipeline_k1(torch, np, smi,
                                                        proc_engine)
    finally:
        proc_engine.shutdown()
    yuv_fleet = input_service(torch, np, smi, head[1], pipe_ref, repo)
    yuv_snapshot = snapshot_phase(torch, np, smi, head[1], pipe_ref)
    emit("pipeline_phases", seconds=time.perf_counter() - t0, card=smi)
    del pipe_ref
    k1_paths["transfer"] = transfer(torch, np, smi, frame)
    # the graph toolkit, export and the UDFs
    t0 = time.perf_counter()
    k1_paths["graph"] = graph_phase(torch, np, smi, frame, featurize_ref)
    yuv_export, yuv_fresh = export_phase(torch, np, smi, head, repo)
    k1_paths["udf"] = udf_phase(torch, np, smi, frame)
    emit("graph_phases", seconds=time.perf_counter() - t0, card=smi)
    del frame, head, featurize_ref
    yuv_paths = {"headline": yuv_launches, "strategies": yuv_strategies,
                 "host_pipeline": yuv_pipe, "input_service": yuv_fleet,
                 "snapshot": yuv_snapshot, "export": yuv_export,
                 "export_fresh_process": yuv_fresh}
    yuv_launches = sum(yuv_paths.values())
    trained_predict(torch, np, smi)
    transfer_trained(torch, np, smi)
    logreg_scale(torch, np, smi)

    launches = sum(k1_paths.values())
    emit("kernels", launches={KERNEL: launches, KERNEL_YUV420: yuv_launches},
         launches_by_path={KERNEL: k1_paths, KERNEL_YUV420: yuv_paths},
         passed=all(k1_paths.values()) and all(yuv_paths.values()))
    if not all(k1_paths.values()) or not all(yuv_paths.values()):
        raise AssertionError(f"a kernel was not launched on each of its "
                             f"paths: {KERNEL} {k1_paths}, {KERNEL_YUV420} "
                             f"{yuv_paths}")
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
        "launches": yuv_launches, "launches_by_path": yuv_paths,
        "max_abs_err": main["max_abs_err"],
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
