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
                   seconds. The card's machine has no keras, so what
                   reads a Keras model or file (the converter's
                   keras-reading half ``keras_spec``, ``KerasTransformer``,
                   ``KerasImageFileTransformer``, ``registerKerasImageUDF``,
                   the weight import) is checked by the CPU tests only;
                   the estimator's training core runs here from the
                   committed spec (``keras_estimator`` below).
20. ``serve``     — online serving through ``ModelServer`` (bench.py's
                   serve shape: a 50 ms coalesce window, 512 queued rows,
                   batch 64, the request log armed): the headline's
                   function (K2) under 4 threads × 16 requests × 32
                   seeded rows plus 2 requests of 96 (split across
                   micro-batches), then the featurize function
                   (``deviceResizeModel(InceptionV3, (512, 512))``, K1)
                   under 4 × 4 × 16 rows plus one of 80, each on a fresh
                   server after ``warmup()``, then both at once on one
                   server. Each pass: offered and achieved rows/s, fill
                   ratio, p50/p99 latency, rejections, deadline misses,
                   failures, the ``tails`` block, the coalesce copy's
                   seconds (``serve.stage_seconds``), each session's
                   first and median micro-batch device ms; every answer
                   against the offline ``BatchRunner`` over the same rows
                   (within 1e-3 relative, bit-equality printed), each
                   kernel's launches equal to its session's
                   micro-batches, no kernel built or planned after
                   warmup, and the concurrent answers equal to each
                   session's alone. Then the drills on a TestNet session
                   (``serve_drills``): a full queue of 64 rows
                   (``ServerOverloaded``), a 1 ms deadline behind a held
                   dispatch (``DeadlineExceeded``, its rows never run),
                   priority shedding (``ShedForPriority`` while the
                   availability budget burns, a lower class displaced by
                   a higher one), transient ``serve.dispatch`` faults
                   (survivors re-dispatched and answered), permanent
                   ones (``CircuitOpen``, then a probe closes the
                   circuit), ``close()`` draining and ``close(drain=
                   False)`` failing the queue with ``ServerClosed``; each
                   drill's counts against ``server.metrics``.
21. ``obs``       — tracing and health over both paths, after ``serve``:
                   the featurize frame (K1) and the headline (K2) through
                   their entry points disarmed, armed, disarmed, armed
                   (``obs_trace``: armed outputs bit for bit the disarmed,
                   0 spans dropped, 8 ``dispatch``, ``device_get``,
                   ``device_put`` and ``pad_stage`` spans a pass; per lane
                   busy ms and %, top spans, stalls, span counts, the
                   ``report --bound`` verdict, both walls); one armed
                   headline session under the serve phase's traffic
                   (``obs_serve``: ``report --tails`` attributes at least
                   95% of the p99, every exemplar's request id resolves
                   to a request span and a flow, ``serve_telemetry``'s
                   ``/metricsz`` parses as Prometheus text, ``/healthz``
                   200, ``/statusz`` names the session and the card); a
                   stall drill on a TestNet session held inside a
                   dispatch with the watchdog at 0.5 s (``obs_stall``:
                   ``/healthz`` 503 naming ``serve.dispatcher:wedge``, a
                   flight bundle with spans, ``watchdog.stalls``, the
                   queue, the card and its ``torch.cuda`` memory figures,
                   no ``error`` in the port's sections and no degraded
                   probe, then 200 after the release); and
                   ``SPARKDL_TPU_SANITIZE=1`` (``obs_ship_guard``: the four
                   strategies bit for bit under the armed guard, each
                   kernel's first launch at a new geometry under it,
                   ``.item()`` refused, and which ways of waiting for the
                   card the guard refuses). Then ``obs_phases``: the
                   phase's seconds and the disarmed ``span`` / ``watch`` /
                   ``pulse`` µs a call.
22. ``parallel``  — ``parallel/`` on the card, after ``obs``: the featurize
                   rows (K1) and the headline rows (K2) through
                   ``ShardedBatchRunner`` on a mesh of one (``make_mesh()``,
                   per-slot batch 64) and on a mesh of two slots on
                   ``cuda:0`` (per-slot batch 32), at 512 rows and a ragged
                   500, under each strategy and with
                   ``transfer_interleave=2``: each pass bit for bit
                   ``BatchRunner`` at the same per-slot batch, the kernel
                   once per slot chunk (``parallel_sharded``: rows/s and
                   runner seconds beside ``BatchRunner``'s);
                   ``DeepImageFeaturizer(useMesh=True)`` on the one card:
                   one warning, bit for bit ``useMesh=False``
                   (``parallel_use_mesh``); ``ModelServer.register(mesh=
                   make_mesh())`` for the headline function under a quarter
                   of the serve phase's traffic, bit for bit the offline
                   runner, ``collective`` false (``parallel_serve``); the
                   data-parallel train step of InceptionV3 at full width
                   (299×299, 1000 classes, batch 32, bf16 with float32
                   parameters and BatchNorm, SGD with momentum, seeded
                   weights, deterministic cuDNN algorithms): 5 plain steps
                   (the loss falls, every running statistic moves), the
                   same 5 through a one-rank NCCL group on
                   ``global_mesh()`` (bit for bit), one step in bf16
                   against float32 (the loss within its rounding bound,
                   each update lowering the float32 loss), ms a step by
                   CUDA events with the peak memory, and a checkpoint
                   (three saves under ``keep=2``, a restore into a fresh
                   state, one more step on each bit for bit)
                   (``parallel_train``); then ``parallel_phases``: the
                   phase's seconds and ``collective.*`` counters.
23. ``keras_estimator`` — ``KerasImageFileEstimator`` training
                   ``keras.applications`` InceptionV3 at full width (the
                   committed topology ``sparkdl_tpu_torch/models/
                   keras_specs/inception_v3.json``: 299×299×3, a 1000-way
                   softmax, 94 BatchNorms without ``gamma``) with seeded
                   weights, through the estimator's private spec seam
                   (the card's machine has no keras to read a model
                   file), over 256 ``synth://<i>`` rows in 8 partitions
                   whose ``imageLoader`` returns seeded 299×299×3 float32
                   arrays in [-1, 1], labels 0-9 one-hot to 1000; adam,
                   categorical cross-entropy, float32 with TF32 off,
                   deterministic cuDNN. Seven gates: a 2-epoch fit at
                   batch 32 lowers its epoch loss, moves all 94 moving
                   means and variances and holds every parameter on
                   ``cuda``; the same fit again bit for bit; one epoch
                   with ``checkpointDir`` then two resumed from it
                   (``resumedFrom`` 1) bit for bit the uninterrupted fit;
                   ``fitMultiple`` over README's grid (``batch_size`` 32
                   and 64) at ``parallelism=2`` on the one card, each
                   trial bit for bit its serial fit;
                   ``KerasImageFileModel.transform`` bit for bit the
                   trained module's eval forward at batch 64;
                   ``streaming=True`` with and without ``cacheDecoded``
                   bit for bit; ``useMesh=True`` one warning and bit for
                   bit. Printed: ms a step by CUDA events (median of the
                   steps after the first) at batch 32 and 64 with the peak
                   memory, each fit's wall seconds, the first fit's
                   optimizer construction, the checkpoint's bytes and its
                   save and restore seconds, and K1's and K2's launches
                   over the phase (none: its convolutions are cuDNN's);
                   then ``keras_estimator_phases``.
24. ``trained_predict`` — ``DeepImagePredictor(modelName="TestNet",
                   decodePredictions=True, topK=1)`` with the committed,
                   trained weights (read by the port's msgpack reader)
                   over the held-out set its provenance names: accuracy
                   at least 0.95, each decoded name the raw scores' best.
25. ``transfer_trained`` — ``Pipeline([DeepImageFeaturizer("TestNet"),
                   LogisticRegression()])`` on the TestNet's 4,096 train
                   images, then ``CrossValidator`` (3 folds) and
                   ``TrainValidationSplit`` over ``regParam`` {0, 1e-2} ×
                   ``maxIter`` {50, 100} on the cached featurized train
                   split: finite metrics, and held-out accuracy at least
                   0.95 after the fit and for each best model.
26. ``logreg_scale`` — ``LogisticRegression`` alone on 262,144 × 2,048
                   seeded fp32 features, 10 classes, 64 partitions:
                   full-batch for 100 steps (ms a step beside its bound:
                   the table read twice a step over HBM bandwidth), the
                   step alone by CUDA events, one minibatch and one
                   streaming epoch at batch 4096, the default budget's
                   switch to streaming (with its warning), and the card
                   against the CPU at 8,192 rows, 20 steps.
27. ``kernels``  — each kernel's launches on its paths and pass/fail.

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
# the serve phase: bench.py's serve traffic (bench.py:408-500, :1145) on a
# ModelServer at batch 64 for the headline's function (4 threads × 16
# requests × 32 rows, 2 oversized requests of 96 rows), a smaller one for
# the featurize function (4 × 4 × 16 rows and one request of 80), bench's
# config (a 50 ms coalesce window, 512 queued rows)
SERVE_THREADS = 4
SERVE_REQUESTS = 16
SERVE_ROWS = 32
SERVE_BIG = 2
SERVE_K1_REQUESTS = 4
SERVE_K1_ROWS = 16
SERVE_K1_BIG_ROWS = 80
SERVE_WAIT_S = 0.05
SERVE_QUEUE_ROWS = 512
# a served answer against the offline runner over the same rows, as
# max|diff| / max|ref|: the same model on the same rows in batches of the
# same padded shape, so bit-equal is expected; the bound allows a
# different cuDNN algorithm between the two runners
SERVE_BOUND_REL = 1e-3
# the drills: a queue bound of 64 rows, requests of 16
DRILL_QUEUE_ROWS = 64
DRILL_ROWS = 16
# the obs phase's stall drill: the watchdog's threshold
OBS_STALL_THRESHOLD_S = 0.5
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
# the parallel phase: the featurize and headline rows through
# ShardedBatchRunner on a mesh of one (per-slot batch 64) and on two slots
# of the card (per-slot batch 32), each pass against BatchRunner at the
# same per-slot batch, at 512 rows and at a ragged 500
PARALLEL_CARD = "cuda:0"
RAGGED_ROWS = 500
PARALLEL_INTERLEAVE = 2
# the mesh-backed serve session: the serve phase's headline traffic at a
# quarter of its count (4 threads × 4 requests × 32 rows, one of 96)
PARALLEL_SERVE_REQUESTS = 4
PARALLEL_SERVE_BIG = 1
# the train step: InceptionV3 at full width (299×299×3, 1000 classes) in
# bf16 with float32 parameters and BatchNorm, seeded random weights, a
# fixed batch of 32, SGD with momentum; a checkpoint keeping 2 steps
TRAIN_MODEL = "InceptionV3"
TRAIN_BATCH = 32
TRAIN_STEPS = 5
TRAIN_TX = ("sgd", 1e-2, 0.9)
TRAIN_SEED = 0
CKPT_KEEP = 2
# one train step in bf16 against the same step in float32, from the same
# weights and batch. Forward: each bf16 rounding on InceptionV3's longest
# path errs by at most half a bf16 step (2^-9) relative: the input cast,
# each of its 47 ConvBN units' conv output and BatchNorm output (stem 5,
# 3 × 3 in block A, 3 in reduction A, 4 × 5 in block B, 4 in reduction
# B, 2 × 3 in block C), and the global pool: 1 + 94 + 1 = 96, so the
# logits move by at most 96 × 2^-9 of their largest magnitude and the
# cross-entropy by at most twice that much in absolute terms. The update
# has no such bound: the backward of a training BatchNorm, g - mean(g) -
# x̂·mean(g·x̂), cancels, and 94 of them in a row at random weights turn
# bf16's roundings into a different direction (the JAX package's own bf16
# and float32 first updates of InceptionV3 differ by 134% of the update's
# norm, cosine 0.13; the port's by 137%, cosine 0.07: both on the CPU at
# 139×139, batch 8, tools/torch_train_precision.py). So the update is
# held to what training needs: the
# bf16 update lowers the float32 loss, as the float32 update does; its
# distance and cosine to the float32 update are printed
TRAIN_FWD_ROUNDINGS = 96
# the keras_estimator phase: keras.applications InceptionV3's committed
# topology (299×299×3, a 1000-way softmax, every layer at full width)
# with seeded weights, trained by KerasImageFileEstimator on 256 seeded
# 299×299×3 rows in [-1, 1] in 8 partitions (labels 0-9, one-hot to
# 1000), adam at its default learning rate, 2 epochs, in float32 with
# TF32 off (main sets it) and deterministic cuDNN algorithms
KE_SPEC = "sparkdl_tpu_torch/models/keras_specs/inception_v3.json"
KE_ROWS = 256
KE_PARTITIONS = 8
KE_LABELS = 10
KE_EPOCHS = 2
KE_BATCH = 32
KE_BATCH_LARGE = 64         # README's grid: batch_size 32 and 64
KE_SEED = 0


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


# -- the serve phase: ModelServer over K2 and K1 ------------------------------

class HeldRunner:
    """A drill's runner: a ``BatchRunner`` whose ``run`` first waits for
    ``release``, so a drill holds the dispatcher inside a dispatch while
    it fills the queue behind it."""

    def __init__(self, runner):
        self.runner = runner
        self.model_fn = runner.model_fn
        self.preferred_chunk = runner.preferred_chunk
        self.entered = threading.Event()
        self.release = threading.Event()

    def run(self, inputs):
        self.entered.set()
        if not self.release.wait(WAIT_S):
            raise TimeoutError("drill runner was never released")
        return self.runner.run(inputs)

    def warmup(self):
        return self.runner.warmup()


def serve_requests(np, mf, seed, per_thread, rows, big, big_rows):
    """Seeded requests for one session: ``SERVE_THREADS`` threads ×
    ``per_thread`` requests of ``rows`` rows, then ``big`` oversized
    requests of ``big_rows`` rows (split across micro-batches); returns
    the requests and ``big``."""
    (shape, dtype), = mf.input_signature.values()
    rng = np.random.default_rng(seed)
    sizes = [rows] * (SERVE_THREADS * per_thread) + [big_rows] * big
    return [rng.integers(0, 256, (n,) + tuple(shape), dtype=dtype)
            for n in sizes], big


def fire(server, traffic):
    """Submit every session's requests at once (``traffic``: {model:
    (input name, requests, oversized count)}): per session
    ``SERVE_THREADS`` threads (thread t submits small requests t,
    t + SERVE_THREADS, ...), the oversized ones from this thread once
    they run; then wait for every answer. Returns per session its
    answers ({index: outputs}), the rejected indices, the seconds until
    the submitters were done and until the last answer."""
    from sparkdl_tpu_torch.serve import ServerOverloaded

    out = {model: {"futures": {}, "rejected": []} for model in traffic}
    lock = threading.Lock()

    def submit(model, name, requests, indices):
        for i in indices:
            try:
                f = server.submit({name: requests[i]}, model=model)
            except ServerOverloaded:
                with lock:
                    out[model]["rejected"].append(i)
            else:
                with lock:
                    out[model]["futures"][i] = f

    workers = []
    t0 = time.perf_counter()
    for model, (name, requests, big) in traffic.items():
        workers += [threading.Thread(target=submit, args=(
            model, name, requests,
            range(t, len(requests) - big, SERVE_THREADS)))
            for t in range(SERVE_THREADS)]
    for w in workers:
        w.start()
    for model, (name, requests, big) in traffic.items():
        submit(model, name, requests,
               range(len(requests) - big, len(requests)))
    for w in workers:
        w.join(WAIT_S)
        if w.is_alive():
            raise AssertionError("a serve submitter did not finish")
    submit_s = time.perf_counter() - t0
    for model in traffic:
        futures = out[model].pop("futures")
        out[model]["answers"] = {i: f.result(WAIT_S)
                                 for i, f in futures.items()}
    elapsed = time.perf_counter() - t0
    for model in traffic:
        out[model].update(submit_s=submit_s, elapsed_s=elapsed)
    return out


def kernel_state(infeed, _build):
    """What a first call would still build: the loaded kernel libraries
    and the misses of both kernels' plan caches."""
    return (sorted(_build._loaded), infeed._device_plan.cache_info().misses,
            infeed._yuv420_device_plan.cache_info().misses)


def check_serve_answers(np, name, requests, answers, ref):
    """Every answer against the offline runner's output ``ref`` over all
    the requests' rows (concatenated in order): shape, finite, max|diff|
    / max|ref| (returned), and whether every answer was bit-equal."""
    offsets = np.cumsum([0] + [len(r) for r in requests])
    worst, bit_equal, rows = 0.0, True, 0
    for i, out in answers.items():
        got = np.asarray(out[name])
        want = ref[offsets[i]:offsets[i + 1]]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"serve answer {i}: shape {got.shape} "
                                 f"(want {want.shape}), finite "
                                 f"{np.isfinite(got).all()}")
        worst = max(worst, rel_diff(got, want))
        bit_equal = bit_equal and bool(np.array_equal(got, want))
        rows += len(got)
    return worst, bit_equal, rows


def serve_pass(torch, np, smi_line, sessions, what):
    """One counted pass: a fresh ``ModelServer`` (bench.py's config) with
    ``sessions`` ({model: (function, kernel, (requests, oversized
    count))}) registered at
    batch 64 and warmed, then every session's traffic at once, the
    request log armed and the kernels' counts set to 0 just before.
    Each kernel's launches must equal its session's micro-batches, the
    pass must build nothing, and every answer must agree with the
    offline runner. Returns per model the answers and the launches."""
    from sparkdl_tpu_torch.obs import (
        default_registry,
        request_log,
        tails_from_records,
    )
    from sparkdl_tpu_torch.ops import _build, infeed
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import ModelServer, ServeConfig

    config = ServeConfig(max_wait_s=SERVE_WAIT_S,
                         max_queue_rows=SERVE_QUEUE_ROWS)
    server = ModelServer(config)
    for model, (mf, _kernel, _requests) in sessions.items():
        server.register(model, mf, batch_size=BATCH)
    warmed = server.warmup()
    torch.cuda.synchronize()
    built = kernel_state(infeed, _build)
    streams = set(infeed._queues)
    reg = default_registry()
    counters = ("serve.stage_seconds", "serve.coalesce_wait_seconds")
    before = {c: reg.counter(c).value for c in counters}
    runner_before = {m: runner_fields(server.session(m).runner.metrics)
                     for m in sessions}
    rlog = request_log()
    rlog.arm()
    rlog.clear()
    try:
        infeed.launches = infeed.yuv420_launches = 0
        result = fire(server, {m: (mf.input_names[0], *traffic)
                               for m, (mf, _k, traffic) in
                               sessions.items()})
        torch.cuda.synchronize()
        launches = {KERNEL: infeed.launches,
                    KERNEL_YUV420: infeed.yuv420_launches}
        server.close()
        records = rlog.records()
    finally:
        rlog.arm_from_env()
    no_build = kernel_state(infeed, _build) == built
    streams_added = len(set(infeed._queues) - streams)
    m = server.metrics.as_dict()
    out = {}
    for model, (mf, kernel, (requests, big)) in sessions.items():
        res = result[model]
        session = server.session(model)
        runner = fields_delta(runner_fields(session.runner.metrics),
                              runner_before[model])
        # the offline pass over the same rows (outside the counted run)
        name = mf.input_names[0]
        out_name = mf.output_names[0]
        ref = BatchRunner(mf, BATCH).run(
            {name: np.concatenate(requests)})[out_name]
        rel, bit_equal, rows = check_serve_answers(
            np, out_name, requests, res["answers"], ref)
        offered = sum(len(r) for r in requests)
        out[model] = {"answers": res["answers"], "kernel": kernel,
                      "batches": runner["batches"], "rel": rel,
                      "bit_equal": bit_equal, "rows_checked": rows,
                      "rejected": len(res["rejected"]),
                      "offered_rows_per_s": offered / res["submit_s"],
                      "achieved_rows_per_s": rows / res["elapsed_s"],
                      "runner_s": runner["seconds"], "model": mf.name,
                      "offered_rows": offered, "requests": len(requests),
                      "oversized": big}
        if not rel <= SERVE_BOUND_REL:
            raise AssertionError(f"{what} {model}: serve vs offline "
                                 f"relative max|diff| {rel} > "
                                 f"{SERVE_BOUND_REL}")
    by_kernel = {KERNEL: 0, KERNEL_YUV420: 0}
    for model, o in out.items():
        by_kernel[o["kernel"]] += o["batches"]
    tails = tails_from_records(records)
    # each session's first micro-batch (the first answered record) beside
    # its median one-batch request: the dispatcher thread's first run
    first_ms = {}
    for model, (mf, _k, _t) in sessions.items():
        mine = [r for r in records if r.model == model and r.batches == 1]
        if mine:
            first_ms[model] = {
                "first_batch_device_ms": mine[0].phases["device"] * 1e3,
                "median_batch_device_ms": median(
                    [r.phases["device"] for r in mine]) * 1e3}
    emit("serve", what=what, sessions={
        model: {k: v for k, v in o.items() if k != "answers"}
        for model, o in out.items()},
        batch=BATCH, config={"max_wait_s": config.max_wait_s,
                             "max_queue_rows": config.max_queue_rows},
        threads=SERVE_THREADS,
        warmed=warmed, launches=launches,
        batches=m["batches"], batch_fill_ratio=m["batch_fill_ratio"],
        latency_p50_ms=m["latency_p50_ms"],
        latency_p99_ms=m["latency_p99_ms"], requests=m["requests"],
        rows=m["rows"], rejections=m["rejections"],
        deadline_misses=m["deadline_misses"], failures=m["failures"],
        retries=m["retries"], tails=tails,
        stage_s=reg.counter(counters[0]).value - before[counters[0]],
        coalesce_wait_s=reg.counter(counters[1]).value
        - before[counters[1]],
        device_ms=first_ms,
        no_build_after_warmup=no_build, k2_streams_added=streams_added,
        bound=SERVE_BOUND_REL, card=smi_line)
    if launches != by_kernel or sum(by_kernel.values()) != m["batches"]:
        raise AssertionError(f"{what}: launches {launches} against the "
                             f"sessions' micro-batches {by_kernel} (server "
                             f"{m['batches']})")
    if not no_build or streams_added:
        raise AssertionError(f"{what}: a kernel was built or planned after "
                             f"warmup ({no_build}), or K2 launched on a "
                             f"new stream ({streams_added})")
    if m["failures"] or m["deadline_misses"] or not all(warmed.values()):
        raise AssertionError(f"{what}: failures {m['failures']}, deadline "
                             f"misses {m['deadline_misses']}, warmed "
                             f"{warmed}")
    if tails["requests"] != sum(len(o["answers"]) for o in out.values()):
        raise AssertionError(f"{what}: the request log holds "
                             f"{tails['requests']} successes")
    return out


def serve_drills(torch, np, smi_line, testnet):
    """The serving contract's drills on a TestNet session (the committed
    weights), each on a fresh server; every drill's counts against
    ``server.metrics.as_dict()``. Returns the drills' results."""
    from sparkdl_tpu_torch.obs import default_registry, slo_tracker
    from sparkdl_tpu_torch.resilience import faults
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import (
        CircuitOpen,
        DeadlineExceeded,
        ModelServer,
        ServeConfig,
        ServerClosed,
        ServerOverloaded,
        ShedForPriority,
    )

    name = testnet.input_names[0]
    shape, dtype = testnet.input_signature[name]
    rng = np.random.default_rng(11)

    def rows(n):
        return rng.integers(0, 256, (n,) + tuple(shape), dtype=dtype)

    offline = BatchRunner(testnet, BATCH)

    def answer_ok(fut, x):
        got = fut.result(WAIT_S)["features"]
        return bool(np.array_equal(got, offline.run({name: x})["features"]))

    def server_with(held=False, **cfg):
        server = ModelServer(ServeConfig(**cfg))
        runner = BatchRunner(testnet, BATCH)
        if held:
            runner = HeldRunner(runner)
        server.register("testnet", runner=runner)
        server.warmup()
        return server, runner

    def held_first(server, runner):
        x = rows(BATCH)
        fut = server.submit({name: x})
        if not runner.entered.wait(WAIT_S):
            raise AssertionError("the drill's first request never ran")
        return fut, x

    def closed_metrics(server):
        server.close()
        return server.metrics.as_dict()

    drills = {}
    # a clean availability window for the drills
    slo_tracker().clear()

    # 1. a burst behind a full queue of 64 rows → ServerOverloaded
    server, runner = server_with(True, max_queue_rows=DRILL_QUEUE_ROWS,
                                 max_wait_s=0.0)
    first, x0 = held_first(server, runner)
    admitted, rejected = [], 0
    for _ in range(2 * DRILL_QUEUE_ROWS // DRILL_ROWS):
        x = rows(DRILL_ROWS)
        try:
            admitted.append((server.submit({name: x}), x))
        except ServerOverloaded:
            rejected += 1
    runner.release.set()
    ok = answer_ok(first, x0) and all(answer_ok(f, x) for f, x in admitted)
    m = closed_metrics(server)
    drills["overloaded"] = {"admitted": len(admitted), "rejected": rejected,
                            "answers_bit_equal": ok,
                            "metrics": {k: m[k] for k in (
                                "requests", "rejections", "batches")}}
    if not (rejected == m["rejections"] == DRILL_QUEUE_ROWS // DRILL_ROWS
            and m["requests"] == 1 + len(admitted) and ok):
        raise AssertionError(f"overloaded drill: {drills['overloaded']}")

    # 2. a 1 ms deadline behind a held dispatch → DeadlineExceeded, its
    # rows never run
    server, runner = server_with(True, max_wait_s=0.0)
    first, x0 = held_first(server, runner)
    doomed = server.submit({name: rows(DRILL_ROWS)}, deadline=0.001)
    x = rows(DRILL_ROWS)
    live = server.submit({name: x})
    time.sleep(0.01)
    runner.release.set()
    try:
        doomed.result(WAIT_S)
        expired = None
    except DeadlineExceeded as e:
        expired = str(e)
    ok = answer_ok(first, x0) and answer_ok(live, x)
    m = closed_metrics(server)
    # the rows that reached the model: the held batch and the live one
    dispatched = server.metrics.batch_rows
    drills["deadline"] = {"error": expired, "dispatched_rows": dispatched,
                          "answers_bit_equal": ok,
                          "metrics": {k: m[k] for k in (
                              "requests", "deadline_misses", "failures")}}
    if expired is None or "queued" not in expired or ok is not True \
            or dispatched != BATCH + DRILL_ROWS \
            or (m["deadline_misses"], m["failures"]) != (1, 0):
        raise AssertionError(f"deadline drill: {drills['deadline']}")

    # 3. priority: with the availability budget burning (the drills
    # above failed requests), an arrival below the highest queued class
    # past the watermark → ShedForPriority; a higher class displaces a
    # queued lower one when the queue is full
    burn = default_registry().gauge("slo.availability.burn_rate").value
    server, runner = server_with(True, max_queue_rows=DRILL_QUEUE_ROWS,
                                 max_wait_s=0.0, shed_watermark_frac=0.5)
    first, x0 = held_first(server, runner)
    low = server.submit({name: rows(DRILL_QUEUE_ROWS // 2)}, priority=1)
    try:
        server.submit({name: rows(DRILL_ROWS)}, priority=0)
        shed = None
    except ShedForPriority as e:
        shed = type(e).__name__
    x = rows(40)
    high = server.submit({name: x}, priority=2)
    runner.release.set()
    try:
        low.result(WAIT_S)
        displaced = None
    except ServerOverloaded as e:
        displaced = type(e).__name__
    ok = answer_ok(first, x0) and answer_ok(high, x)
    m = closed_metrics(server)
    drills["priority"] = {"burn_rate": burn, "shed_at_admission": shed,
                          "displaced": displaced, "answers_bit_equal": ok,
                          "metrics": {k: m[k] for k in (
                              "shed", "shed_rows", "rejections")}}
    if not (burn >= 1.0 and shed == "ShedForPriority"
            and displaced == "ServerOverloaded" and ok
            and (m["shed"], m["shed_rows"], m["rejections"])
            == (2, DRILL_ROWS + DRILL_QUEUE_ROWS // 2, 1)):
        raise AssertionError(f"priority drill: {drills['priority']}")

    # 4. transient serve.dispatch faults: failed micro-batches re-dispatch
    # their requests; one request a batch, in turn
    faults.inject("serve.dispatch", "transient", 0.3, seed=4)
    try:
        server, runner = server_with(max_wait_s=0.0,
                                     retry_base_backoff_s=0.001)
        answered = failed = 0
        ok = True
        for _ in range(8):
            x = rows(BATCH)
            fut = server.submit({name: x})
            try:
                ok = answer_ok(fut, x) and ok
                answered += 1
            except faults.InjectedFault:
                failed += 1
        injected = faults.state()["sites"]["serve.dispatch"]["injected"]
    finally:
        faults.disarm()
    m = closed_metrics(server)
    drills["transient"] = {"answered": answered, "failed": failed,
                           "injected": injected, "answers_bit_equal": ok,
                           "metrics": {k: m[k] for k in (
                               "requests", "retries", "failures")}}
    if not (m["retries"] >= 1 and answered >= 1 and ok
            and m["failures"] == failed
            and injected == m["retries"] + failed):
        raise AssertionError(f"transient drill: {drills['transient']}")

    # 5. permanent faults open the circuit (CircuitOpen at submit); after
    # circuit_reset_s a probe closes it
    reset_s = 0.5
    faults.inject("serve.dispatch", "permanent", 1.0)
    try:
        server, runner = server_with(max_wait_s=0.0,
                                     circuit_failure_threshold=3,
                                     circuit_reset_s=reset_s)
        failed = 0
        for _ in range(3):
            try:
                server.submit({name: rows(DRILL_ROWS)}).result(WAIT_S)
            except faults.InjectedPermanentFault:
                failed += 1
        try:
            server.submit({name: rows(DRILL_ROWS)})
            refused = None
        except CircuitOpen as e:
            refused = type(e).__name__
        opened = server.session().circuit.status()
    finally:
        faults.disarm()
    time.sleep(reset_s * 1.2)
    x = rows(DRILL_ROWS)
    ok = answer_ok(server.submit({name: x}), x)
    after = server.session().circuit.status()
    m = closed_metrics(server)
    drills["circuit"] = {"failed": failed, "refused": refused,
                         "opened": opened, "after_probe": after,
                         "answers_bit_equal": ok,
                         "metrics": {k: m[k] for k in (
                             "failures", "circuit_rejections", "retries")}}
    if not (failed == m["failures"] == 3 and refused == "CircuitOpen"
            and opened["state"] == "open" and after["state"] == "closed"
            and after["opens"] == 1 and ok
            and (m["circuit_rejections"], m["retries"]) == (1, 0)):
        raise AssertionError(f"circuit drill: {drills['circuit']}")

    # 6 and 7. close() drains every admitted request; close(drain=False)
    # fails the queued ones with ServerClosed
    for drain in (True, False):
        server, runner = server_with(True, max_wait_s=0.0)
        first, x0 = held_first(server, runner)
        queued = []
        for _ in range(3):
            x = rows(DRILL_ROWS)
            queued.append((server.submit({name: x}), x))
        closer = threading.Thread(target=server.close, args=(drain,))
        closer.start()
        while not server.session()._queue.closing:
            time.sleep(0.001)
        runner.release.set()
        closer.join(WAIT_S)
        if closer.is_alive():
            raise AssertionError("close() did not return")
        ok = answer_ok(first, x0)
        closed = 0
        for fut, x in queued:
            if drain:
                ok = answer_ok(fut, x) and ok
            else:
                try:
                    fut.result(WAIT_S)
                except ServerClosed:
                    closed += 1
        try:
            server.submit({name: rows(1)})
            after_close = None
        except ServerClosed as e:
            after_close = type(e).__name__
        m = server.metrics.as_dict()
        key = "close_drain" if drain else "close_no_drain"
        drills[key] = {"queued": len(queued), "failed_closed": closed,
                       "submit_after_close": after_close,
                       "answers_bit_equal": ok,
                       "metrics": {k: m[k] for k in (
                           "requests", "batches", "failures")}}
        if not (ok and after_close == "ServerClosed"
                and closed == (0 if drain else len(queued))
                and m["requests"] == 1 + len(queued)
                and m["batches"] == (2 if drain else 1)
                and m["failures"] == 0):
            raise AssertionError(f"{key} drill: {drills[key]}")
    emit("serve_drills", model=testnet.name, batch=BATCH, drills=drills,
         card=smi_line)
    return drills


def serve_phase(torch, np, smi_line, head_mf, feat_mf, testnet):
    """``ModelServer`` on the card: the headline's function (K2) under
    bench.py's serve traffic, the featurize function (K1) under a
    smaller one, both at once on one server (each answer equal to its
    session's alone), then the drills on TestNet. Returns K1's and K2's
    launches over the counted passes."""
    t0 = time.perf_counter()
    head = serve_requests(np, head_mf, 20, SERVE_REQUESTS, SERVE_ROWS,
                          SERVE_BIG, BATCH + SERVE_ROWS)
    feat = serve_requests(np, feat_mf, 21, SERVE_K1_REQUESTS, SERVE_K1_ROWS,
                          1, SERVE_K1_BIG_ROWS)
    sessions = {"headline": (head_mf, KERNEL_YUV420, head),
                "featurize": (feat_mf, KERNEL, feat)}
    alone = {}
    for model, session in sessions.items():
        alone[model] = serve_pass(torch, np, smi_line, {model: session},
                                  model)[model]
    both = serve_pass(torch, np, smi_line, sessions, "concurrent")
    same = {}
    for model, o in both.items():
        common = set(o["answers"]) & set(alone[model]["answers"])
        same[model] = (len(common), all(
            np.array_equal(o["answers"][i][n], alone[model]["answers"][i][n])
            for i in common for n in o["answers"][i]))
    emit("serve_concurrent", same_as_alone=same, card=smi_line)
    if not all(ok and n for n, ok in same.values()):
        raise AssertionError(f"concurrent sessions changed answers: {same}")
    serve_drills(torch, np, smi_line, testnet)
    emit("serve_phases", seconds=time.perf_counter() - t0, card=smi_line)
    return (alone["featurize"]["batches"] + both["featurize"]["batches"],
            alone["headline"]["batches"] + both["headline"]["batches"])


def lane_digest(report, events):
    """Per lane busy ms / % of the trace's wall, the top spans, the
    stalls and the span counts per (lane, name) of one exported trace,
    from the port's report functions (host clock)."""
    spans = [e for e in events if e.get("ph") == "X"]
    lane_of = {e["pid"]: e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "process_name"}
    t0 = min(e["ts"] for e in spans)
    wall = max(e["ts"] + e["dur"] for e in spans) - t0
    by_lane, by_name = {}, {}
    for e in spans:
        lane = lane_of[e["pid"]]
        by_lane.setdefault(lane, []).append((e["ts"], e["ts"] + e["dur"]))
        by_name.setdefault(f"{lane}/{e['name']}", []).append(e["dur"])
    lanes = {lane: {"busy_ms": report._merged_length(iv) / 1e3,
                    "busy_pct": 100.0 * report._merged_length(iv) / wall,
                    "spans": len(iv)} for lane, iv in by_lane.items()}
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    stall_names = [k for k in by_name if any(
        k.split("/", 1)[1].startswith(s) for s in report.STALL_NAMES)]
    return {"wall_ms": wall / 1e3, "lanes": lanes,
            "top_spans_ms": {k: sum(v) / 1e3 for k, v in top},
            "stalls_ms": {k: sum(by_name[k]) / 1e3 for k in stall_names},
            "counts": {k: len(v) for k, v in sorted(by_name.items())}}


def disarmed_us(fn, n=20_000, repeats=5):
    """Least µs of one disarmed hook call over ``repeats`` runs of
    ``n`` (noise only adds time)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def traced_passes(torch, np, smi_line, frame, head):
    """The featurize frame (K1) and the headline (K2), each through its
    entry point disarmed, armed, disarmed, armed: the armed outputs must
    equal the disarmed bit for bit, the trace must drop nothing, and
    each pass must record 8 ``dispatch`` and 8 ``device_get`` spans (8
    chunks of 64, one drain each in every strategy). Prints each pass's
    lanes, top spans, stalls, ``report --bound`` verdict and span counts.
    """
    from sparkdl_tpu_torch import DeepImageFeaturizer, TensorTransformer
    from sparkdl_tpu_torch.obs import report, tracer

    chunks = N_IMAGES // BATCH
    featurizer = DeepImageFeaturizer(
        modelName="InceptionV3", inputCol="image", outputCol="features",
        deviceResizeFrom=(512, 512), batchSize=BATCH)
    headline_t = TensorTransformer(
        modelFunction=head[1], inputMapping={"image": "image"},
        outputMapping={"features": "features"}, batchSize=BATCH)
    planned = {"featurize": featurizer.transform(frame[2]),
               "headline": headline_t.transform(head[0])}
    trc = tracer()
    results = {}
    for what, plan in planned.items():
        outs, walls, digest = {}, {"disarmed": [], "armed": []}, None
        for run in ("disarmed", "armed", "disarmed", "armed"):
            trc.clear()
            if run == "armed":
                trc.arm()
            else:
                trc.disarm()
            t0 = time.perf_counter()
            out = plan.collect()
            torch.cuda.synchronize()
            walls[run].append(time.perf_counter() - t0)
            trc.disarm()
            feats = np.asarray(out["features"])
            if run in outs and not np.array_equal(outs[run], feats):
                raise AssertionError(f"obs {what}: two {run} passes differ")
            outs[run] = feats
            if run == "armed":
                events = trc.trace_events()
                dropped = trc.dropped
                digest = lane_digest(report, events)
                bound = report.bound_summary(events)
        trc.arm_from_env()
        trc.clear()
        counts = digest["counts"]
        equal = bool(np.array_equal(outs["armed"], outs["disarmed"]))
        results[what] = {
            "bit_equal": equal, "dropped": dropped,
            "disarmed_wall_s": walls["disarmed"],
            "armed_wall_s": walls["armed"], **digest,
            "bound": {k: bound[k] for k in ("bound_by", "headroom_pct",
                                             "util")}}
        emit("obs_trace", what=what, **results[what], card=smi_line)
        if not equal or dropped or outs["armed"].shape != (N_IMAGES,
                                                           FEATURES):
            raise AssertionError(f"obs {what}: armed output bit-equal "
                                 f"{equal}, {dropped} spans dropped")
        for name in ("ship/dispatch", "device/device_get",
                     "ship/device_put", "ship/pad_stage"):
            if counts.get(name) != chunks:
                raise AssertionError(f"obs {what}: {counts.get(name)} "
                                     f"{name} spans, want {chunks}")
    return results


def obs_serve(torch, np, smi_line, head_mf):
    """One armed headline session under the serve phase's traffic:
    ``report --tails`` must attribute at least 95% of the p99 to the
    named phases and every exemplar's request id must resolve to a
    request span and a flow in the export. Its ``serve_telemetry``
    answers ``/metricsz`` (Prometheus text), ``/healthz`` (200) and
    ``/statusz`` (the session and the card). Returns K2's launches."""
    from sparkdl_tpu_torch.obs import report, request_log, tracer
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import ModelServer, ServeConfig

    requests, big = serve_requests(np, head_mf, 20, SERVE_REQUESTS,
                                   SERVE_ROWS, SERVE_BIG, BATCH + SERVE_ROWS)
    name, out_name = head_mf.input_names[0], head_mf.output_names[0]
    ref = BatchRunner(head_mf, BATCH).run(
        {name: np.concatenate(requests)})[out_name]
    server = ModelServer(ServeConfig(max_wait_s=SERVE_WAIT_S,
                                     max_queue_rows=SERVE_QUEUE_ROWS))
    server.register("headline", head_mf, batch_size=BATCH)
    server.warmup()
    trc = tracer()
    trc.clear()
    request_log().clear()
    trc.arm()
    try:
        before = infeed.yuv420_launches
        result = fire(server, {"headline": (name, requests, big)})
        torch.cuda.synchronize()
        launches = infeed.yuv420_launches - before
        tel = server.serve_telemetry(port=0)
        pages = {path: http_get(tel.url(path))
                 for path in ("/metricsz", "/healthz", "/statusz")}
        exemplars = server.metrics.latency_exemplars()
        batches = server.metrics.as_dict()["batches"]
        server.close()
        events = trc.trace_events()
        dropped = trc.dropped
    finally:
        trc.arm_from_env()
        trc.clear()
        request_log().arm_from_env()
    res = result["headline"]
    rel, bit_equal, rows = check_serve_answers(np, out_name, requests,
                                               res["answers"], ref)
    tails = report.tails_summary(events)
    text = report.summarize_tails(events)
    req_spans = {e["args"]["request_id"] for e in events
                 if e.get("ph") == "X" and e.get("name") == "request"}
    flows = {}
    for e in events:
        if e.get("cat") == "request_flow":
            flows.setdefault(e["id"], set()).add(e["ph"])
    resolved = [ex["request_id"] in req_spans
                and flows.get(ex["request_id"]) == {"s", "t", "f"}
                for ex in exemplars]
    metrics_ok, kinds = prometheus_kinds(pages["/metricsz"][1])
    status = json.loads(pages["/statusz"][1])
    statusz_ok = ("headline" in status["servers"][0]["models"]
                  and status["platform"]["devices"][0]
                  == torch.cuda.get_device_name(0))
    emit("obs_serve", answered=len(res["answers"]),
         rejected=len(res["rejected"]), batches=batches,
         k2_launches=launches, rel=rel, bit_equal=bit_equal,
         tails=tails, tails_text=text.splitlines(), dropped=dropped,
         exemplars=len(exemplars), exemplars_resolved=sum(resolved),
         metricsz={"code": pages["/metricsz"][0], "parses": metrics_ok,
                   "kinds": kinds},
         healthz=pages["/healthz"][0], statusz_names_session_and_card=(
             statusz_ok), card=smi_line)
    if not (tails and tails["attributed_pct"] is not None
            and tails["attributed_pct"] >= 95.0 and exemplars
            and all(resolved) and not dropped
            and rel <= SERVE_BOUND_REL and launches == batches):
        raise AssertionError(f"obs serve: tails {tails}, exemplars "
                             f"resolved {sum(resolved)}/{len(exemplars)}, "
                             f"dropped {dropped}, rel {rel}, launches "
                             f"{launches} for {batches} batches")
    if not (pages["/metricsz"][0] == 200 and metrics_ok
            and pages["/healthz"][0] == 200
            and pages["/statusz"][0] == 200 and statusz_ok):
        raise AssertionError(f"obs telemetry: {[p[0] for p in pages.values()]}"
                             f", metricsz parses {metrics_ok}, statusz "
                             f"names the session and card {statusz_ok}")
    return launches


def http_get(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prometheus_kinds(text):
    """Whether ``text`` parses as Prometheus text exposition (every
    sample after its ``# HELP`` and ``# TYPE``, kinds counter or gauge),
    and the count of each kind."""
    import re
    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*) "
                        r"[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|nan|inf)$")
    kinds, typed, ok = {}, None, True
    for line in text.strip().splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            typed = name
            kinds[kind] = kinds.get(kind, 0) + 1
            ok = ok and kind in ("counter", "gauge")
            continue
        m = sample.match(line)
        ok = ok and m is not None and m.group(1) == typed
    return ok and bool(kinds), kinds


def stall_drill(torch, np, smi_line, testnet):
    """A TestNet session whose runner blocks on an event inside a
    dispatch, the watchdog armed at 0.5 s and the flight recorder armed:
    ``/healthz`` turns 503 naming the dispatcher, the bundle is written
    (spans, ``watchdog.stalls >= 1``, the queue state, the card's name
    and ``torch.cuda`` memory figures, no ``error`` in the port's own
    sections), then released the request resolves and ``/healthz``
    answers 200 again; no flight probe degraded."""
    from sparkdl_tpu_torch.obs import default_registry, flight, tracer
    from sparkdl_tpu_torch.obs.watchdog import watchdog
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import ModelServer, ServeConfig

    name = testnet.input_names[0]
    shape, dtype = testnet.input_signature[name]
    x = np.random.default_rng(12).integers(0, 256, (DRILL_ROWS,)
                                           + tuple(shape), dtype=dtype)
    reg = default_registry()
    degrades = reg.counter("flight.degrade_events").value
    stalls = reg.counter("watchdog.stalls").value
    wd, rec = watchdog(), flight.recorder()
    bundle_dir = tempfile.mkdtemp(prefix="sparkdl_flight_")
    os.environ["SPARKDL_TPU_FLIGHT_DIR"] = bundle_dir
    server = ModelServer(ServeConfig(max_wait_s=0.0))
    runner = HeldRunner(BatchRunner(testnet, BATCH))
    server.register("wedge", runner=runner)
    server.warmup()
    wd.arm(threshold_s=OBS_STALL_THRESHOLD_S)
    rec.arm()
    try:
        tel = server.serve_telemetry(port=0)
        dumps = rec.dumps
        t0 = time.perf_counter()
        fut = server.submit({name: x})
        code, body = http_get(tel.url("/healthz"))
        while code == 200 and time.perf_counter() - t0 < WAIT_S:
            time.sleep(0.02)
            code, body = http_get(tel.url("/healthz"))
        stalled_after_s = time.perf_counter() - t0
        health = json.loads(body)
        while rec.dumps == dumps and time.perf_counter() - t0 < WAIT_S:
            time.sleep(0.02)
        with open(rec.last_dump_path) as f:
            bundle = json.load(f)
        runner.release.set()
        answer = fut.result(WAIT_S)["features"]
        t1 = time.perf_counter()
        while not wd.healthy() and time.perf_counter() - t1 < WAIT_S:
            time.sleep(0.02)
        code_after, _ = http_get(tel.url("/healthz"))
    finally:
        runner.release.set()
        server.close()
        wd.disarm()
        wd.arm_from_env()
        rec.disarm()
        tracer().arm_from_env()
        tracer().clear()
        os.environ.pop("SPARKDL_TPU_FLIGHT_DIR", None)
    mem = (bundle["memory_stats"] or {}).get("cuda:0") or {}
    errors = [k for k in ("platform", "memory_stats", "pipeline",
                          "inputsvc", "slo", "requests", "resilience")
              if "error" in bundle[k]]
    errors += ["serve" for s in bundle["serve"] if "error" in s]
    wedge = [s["models"]["wedge"] for s in bundle["serve"]
             if "wedge" in s.get("models", {})]
    summary = {
        "healthz_stalled": code, "stalled_sources":
            health.get("stalled_sources"),
        "stalled_after_s": stalled_after_s,
        "threshold_s": OBS_STALL_THRESHOLD_S,
        "bundle": {"span_count": bundle["span_count"],
                   "watchdog_stalls": bundle["registry"].get(
                       "watchdog.stalls"),
                   "reason": bundle["reason"],
                   "queue": wedge[0] if wedge else None,
                   "platform": bundle["platform"],
                   "memory_cuda0": {k: mem.get(k) for k in (
                       "allocated_bytes.all.current",
                       "reserved_bytes.all.peak", "free_bytes",
                       "total_bytes")},
                   "sections_with_error": errors,
                   "ledger": bundle["ledger"], "fleet": bundle["fleet"]},
        "answer_shape": list(answer.shape),
        "healthz_after_release": code_after,
        "flight_degrade_events": reg.counter(
            "flight.degrade_events").value - degrades,
        "watchdog_stalls": reg.counter("watchdog.stalls").value - stalls}
    emit("obs_stall", **summary, card=smi_line)
    if not (code == 503 and "serve.dispatcher:wedge"
            in health.get("stalled_sources", [])
            and bundle["span_count"] >= 1
            and bundle["registry"].get("watchdog.stalls", 0) >= 1
            and wedge and bundle["platform"]["devices"][0]
            == torch.cuda.get_device_name(0)
            and mem.get("allocated_bytes.all.current") is not None
            and mem.get("total_bytes") and not errors
            and code_after == 200
            and summary["flight_degrade_events"] == 0):
        raise AssertionError(f"obs stall drill: {summary}")
    return summary


def guarded_strategies(torch, np, smi_line, head):
    """``SPARKDL_TPU_SANITIZE=1``: the headline's rows through the
    runner under each strategy with the guard armed, bit-equal to the
    unguarded ``immediate`` run; a first launch of each kernel at a new
    geometry (its plan's upload) inside an armed guard; and an implicit
    sync (``.item()`` on a card tensor) inside the guard must raise.
    Returns K1's and K2's launches."""
    from sparkdl_tpu_torch.obs import default_registry
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.runtime import sanitize
    from sparkdl_tpu_torch.runtime.runner import BatchRunner

    df, mf, _ = head
    rows = {"image": np.asarray(df.collect()["image"])}
    ref = BatchRunner(mf, BATCH, strategy="immediate").run(rows)["features"]
    reg = default_registry()
    armed0 = reg.counter("sanitize.armed_runs").value
    k1, k2 = infeed.launches, infeed.yuv420_launches
    results = {}
    with runner_env(sanitize=1):
        for strategy in STRATEGIES:
            out = BatchRunner(mf, BATCH, strategy=strategy).run(rows)
            results[strategy] = bool(np.array_equal(out["features"], ref))
        armed_runs = reg.counter("sanitize.armed_runs").value - armed0
        # inputs on the card before the guard: their copy is a blocking
        # H2D, which the guard refuses
        x = torch.from_numpy(rows["image"][:BATCH]).cuda()
        img = torch.zeros((BATCH, 512, 512, 3), dtype=torch.uint8,
                          device="cuda")
        cold = {}
        with sanitize.ship_guard(torch.device("cuda")) as armed:
            y = infeed.fused_yuv420_resize_normalize(
                x, HEADLINE_SRC, (224, 224), out_dtype=torch.uint8)
            cold["k2_150_to_224"] = list(y.shape)
            cold["k1_512_to_256"] = list(
                infeed.fused_resize_normalize(img, (256, 256)).shape)
            try:
                torch.ones(1, device="cuda").sum().item()
                item_raised = None
            except RuntimeError as e:
                item_raised = str(e).splitlines()[0][:160]
            trips = sync_trips(torch, np)
        mode_after = torch.cuda.get_sync_debug_mode()
    launches = (infeed.launches - k1, infeed.yuv420_launches - k2)
    emit("obs_ship_guard", bit_equal=results, guard_armed=armed,
         armed_runs=armed_runs, cold_plans_under_guard=cold,
         item_raised=item_raised, trips_the_guard=trips,
         sync_debug_mode_after=mode_after,
         launches={KERNEL: launches[0], KERNEL_YUV420: launches[1]},
         card=smi_line)
    if not (all(results.values()) and armed
            and armed_runs == len(STRATEGIES) and item_raised
            and mode_after == 0 and not trips["event_synchronize"]
            and not trips["pinned_copy_then_event_wait"]):
        raise AssertionError(f"obs ship_guard: bit-equal {results}, armed "
                             f"{armed} ({armed_runs} runs), .item() raised "
                             f"{item_raised!r}, mode after {mode_after}")
    return launches


def sync_trips(torch, np):
    """Which of the runner's ways to wait for the card the armed guard
    refuses (``torch.cuda.set_sync_debug_mode("error")``): True where
    the operation raised."""
    dev = torch.ones(1 << 16, device="cuda")
    pinned = torch.empty(1 << 16, pin_memory=True)
    stream = torch.cuda.Stream()

    def event_synchronize():
        done = torch.cuda.Event()
        done.record()
        done.synchronize()

    def pinned_copy_then_event_wait():
        pinned.copy_(dev, non_blocking=True)
        event_synchronize()

    ops = {
        "pageable_blocking_copy_d2h": lambda: torch.empty(1 << 16).copy_(
            dev),
        "pinned_blocking_copy_d2h": lambda: pinned.copy_(dev),
        "pinned_copy_then_event_wait": pinned_copy_then_event_wait,
        "event_synchronize": event_synchronize,
        "stream_synchronize": stream.synchronize,
        "device_synchronize": torch.cuda.synchronize,
        "as_tensor_h2d": lambda: torch.as_tensor(np.zeros(4), device="cuda"),
    }
    trips = {}
    for name, op in ops.items():
        try:
            op()
            trips[name] = False
        except RuntimeError:
            trips[name] = True
    return trips


def obs_phase(torch, np, smi_line, frame, head, testnet):
    """Tracing and health on the card (module docstring, phase 21:
    ``obs``). Returns K1's and K2's launches over the phase."""
    from sparkdl_tpu_torch.obs import span
    from sparkdl_tpu_torch.obs.watchdog import pulse, watch
    from sparkdl_tpu_torch.ops import infeed

    t0 = time.perf_counter()
    # the counted run: the counts are 0 just before, read just after
    infeed.launches = infeed.yuv420_launches = 0
    traced_passes(torch, np, smi_line, frame, head)
    obs_serve(torch, np, smi_line, head[1])
    stall_drill(torch, np, smi_line, testnet)
    guarded_strategies(torch, np, smi_line, head)
    launches = infeed.launches, infeed.yuv420_launches
    hooks = {"span": lambda: span("s", lane="engine").__enter__(),
             "watch": lambda: watch("hot.loop").__enter__(),
             "pulse": lambda: pulse("hot.loop")}
    costs = {k: disarmed_us(fn) for k, fn in hooks.items()}
    emit("obs_phases", seconds=time.perf_counter() - t0,
         disarmed_us_per_call=costs,
         launches={KERNEL: launches[0], KERNEL_YUV420: launches[1]},
         card=smi_line)
    if max(costs.values()) >= 10.0:
        raise AssertionError(f"a disarmed hook costs {costs} µs")
    return launches


def sharded_path(torch, np, smi_line, mf, x, what, kernel):
    """``x`` through ``ShardedBatchRunner`` over ``mf`` on a mesh of one
    (per-slot batch 64) and on two slots of the card (per-slot 32), at
    512 rows and at a ragged 500, under every strategy and with the
    interleaved placement, each pass counted and bit for bit
    ``BatchRunner`` at the same per-slot batch. Returns ``kernel``'s
    launches over the passes."""
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.parallel import ShardedBatchRunner, make_mesh
    from sparkdl_tpu_torch.runtime.runner import BatchRunner

    name, = mf.input_names
    out_name, = mf.output_names
    meshes = {"mesh_of_one": (make_mesh(), BATCH),
              "two_slots": (make_mesh(devices=[PARALLEL_CARD] * 2),
                            BATCH // 2)}
    runs = [(s, None) for s in STRATEGIES] + \
        [("deferred", PARALLEL_INTERLEAVE)]
    total = 0

    def counted(runner, rows):
        nonlocal total
        # the counted run: the counts are 0 just before, read just after
        infeed.launches = infeed.yuv420_launches = 0
        got = runner.run({name: rows})[out_name]
        torch.cuda.synchronize()
        launched = {KERNEL: infeed.launches,
                    KERNEL_YUV420: infeed.yuv420_launches}
        total += launched[kernel]
        return got, launched

    for n in (N_IMAGES, RAGGED_ROWS):
        rows = x[:n]
        for mesh_name, (mesh, per_slot) in meshes.items():
            want = {KERNEL: 0, KERNEL_YUV420: 0}
            want[kernel] = -(-n // per_slot)
            plain = BatchRunner(mf, per_slot)
            ref, launched = counted(plain, rows)
            if launched != want:
                raise AssertionError(f"{what} BatchRunner({per_slot}) on "
                                     f"{n} rows launched {launched}")
            passes = {}
            for strategy, interleave in runs:
                runner = ShardedBatchRunner(
                    mf, mesh, batch_size=per_slot, strategy=strategy,
                    transfer_interleave=interleave)
                got, launched = counted(runner, rows)
                label = strategy if interleave is None else \
                    f"{strategy}+interleave{interleave}"
                if got.shape != ref.shape or not np.isfinite(got).all():
                    raise AssertionError(f"{what} {mesh_name} {label}: "
                                         f"{got.shape}, finite "
                                         f"{np.isfinite(got).all()}")
                if not np.array_equal(got, ref):
                    raise AssertionError(
                        f"{what} {mesh_name} {label} on {n} rows: not bit "
                        f"for bit BatchRunner({per_slot}) (max|diff| "
                        f"{float(np.abs(got - ref).max())})")
                if launched != want:
                    raise AssertionError(f"{what} {mesh_name} {label} on "
                                         f"{n} rows launched {launched}, "
                                         f"want {want}")
                passes[label] = {
                    "seconds": runner.metrics.seconds,
                    "rows_per_s": runner.metrics.rows_per_second,
                    "batches": runner.metrics.batches}
            emit("parallel_sharded", path=what, mesh=mesh_name,
                 mesh_shape=dict(mesh.shape), slot_batch=per_slot,
                 global_batch=per_slot * mesh.shape["data"], rows=n,
                 launches_per_pass=want[kernel], bit_equal=True,
                 batch_runner={"seconds": plain.metrics.seconds,
                               "rows_per_s": plain.metrics.rows_per_second},
                 sharded=passes, card=smi_line)
    return total


def use_mesh_pass(torch, np, smi_line, frame, ref):
    """``DeepImageFeaturizer(useMesh=True)`` over the featurize frame on
    the one card: one warning, and the features of ``useMesh=False``
    bit for bit. Returns K1's launches."""
    import logging

    from sparkdl_tpu_torch import DeepImageFeaturizer
    from sparkdl_tpu_torch.ops import infeed

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    capture = Capture()
    logger = logging.getLogger("sparkdl_tpu_torch.transformers.utils")
    logger.addHandler(capture)
    try:
        featurizer = DeepImageFeaturizer(
            modelName="InceptionV3", inputCol="image", outputCol="features",
            deviceResizeFrom=(512, 512), batchSize=BATCH, useMesh=True)
        planned = featurizer.transform(frame[2])
        # the counted run: the counts are 0 just before, read just after
        infeed.launches = infeed.yuv420_launches = 0
        out = planned.collect()
        torch.cuda.synchronize()
        launches = infeed.launches
    finally:
        logger.removeHandler(capture)
    warned = [m for m in capture.messages if "only one local device" in m]
    feats = np.asarray(out["features"])
    equal = bool(np.array_equal(feats, ref))
    emit("parallel_use_mesh", warnings=len(warned), bit_equal=equal,
         launches={KERNEL: launches}, card=smi_line)
    if len(warned) != 1 or not equal or launches != N_IMAGES // BATCH:
        raise AssertionError(f"useMesh=True on one card: {len(warned)} "
                             f"warnings, bit-equal {equal}, K1 {launches}")
    return launches


def mesh_serve(torch, np, smi_line, head_mf):
    """``ModelServer.register(mesh=make_mesh())`` for the headline
    function under the serve phase's traffic at a smaller count: every
    answer bit for bit the offline runner's, ``session.collective``
    False, K2 once a micro-batch. Returns K2's launches."""
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.parallel import ShardedBatchRunner, make_mesh
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import ModelServer, ServeConfig

    requests, big = serve_requests(
        np, head_mf, 11, PARALLEL_SERVE_REQUESTS, SERVE_ROWS,
        PARALLEL_SERVE_BIG, 3 * SERVE_ROWS)
    server = ModelServer(ServeConfig(max_wait_s=SERVE_WAIT_S,
                                     max_queue_rows=SERVE_QUEUE_ROWS))
    session = server.register("headline", head_mf, batch_size=BATCH,
                              mesh=make_mesh(),
                              transfer_interleave=PARALLEL_INTERLEAVE)
    try:
        warmed = server.warmup()
        torch.cuda.synchronize()
        # the counted run: the counts are 0 just before, read just after
        infeed.launches = infeed.yuv420_launches = 0
        res = fire(server, {"headline": (head_mf.input_names[0], requests,
                                         big)})["headline"]
        torch.cuda.synchronize()
        launches = {KERNEL: infeed.launches,
                    KERNEL_YUV420: infeed.yuv420_launches}
        status = server.telemetry_status()["models"]["headline"]
    finally:
        server.close()
    m = server.metrics.as_dict()
    out_name = head_mf.output_names[0]
    ref = BatchRunner(head_mf, BATCH).run(
        {head_mf.input_names[0]: np.concatenate(requests)})[out_name]
    rel, bit_equal, rows = check_serve_answers(np, out_name, requests,
                                               res["answers"], ref)
    emit("parallel_serve", runner=type(session.runner).__name__,
         collective=session.collective,
         transfer_interleave=status["runner"]["transfer_interleave"],
         warmed=warmed, answered_rows=rows, rejected=len(res["rejected"]),
         batches=m["batches"], launches=launches, bit_equal=bit_equal,
         rel_max_diff=rel, latency_p50_ms=m["latency_p50_ms"],
         latency_p99_ms=m["latency_p99_ms"],
         achieved_rows_per_s=rows / res["elapsed_s"], card=smi_line)
    if (not isinstance(session.runner, ShardedBatchRunner)
            or session.collective or not bit_equal or not rows
            or launches != {KERNEL: 0, KERNEL_YUV420: m["batches"]}
            or m["failures"] or not all(warmed.values())):
        raise AssertionError(f"mesh serve session: collective "
                             f"{session.collective}, bit-equal {bit_equal}, "
                             f"rows {rows}, launches {launches} against "
                             f"{m['batches']} batches, failures "
                             f"{m['failures']}, warmed {warmed}")
    return launches[KERNEL_YUV420]


def train_state(torch, dtype=None):
    """A fresh train state of ``TRAIN_MODEL`` on the card from the seeded
    weights (``dtype`` the network's compute dtype; its default bf16),
    and its step."""
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.parallel import create_train_state, make_train_step
    spec = zoo.getKerasApplicationModel(TRAIN_MODEL)
    kw = {} if dtype is None else {"dtype": dtype}
    net = zoo.build_module(spec.module_fn,
                           zoo.init_state_dict(TRAIN_MODEL, TRAIN_SEED),
                           torch.device(PARALLEL_CARD), **kw)
    net = net.to(PARALLEL_CARD)
    return (create_train_state(net, None, TRAIN_TX),
            make_train_step(net, spec.preprocess, spec.num_classes))


def train_batch(torch, np):
    from sparkdl_tpu_torch.models import zoo
    spec = zoo.getKerasApplicationModel(TRAIN_MODEL)
    rng = np.random.default_rng(TRAIN_SEED + 1)
    images = rng.integers(0, 256, (TRAIN_BATCH, spec.height, spec.width, 3),
                          dtype=np.uint8)
    labels = rng.integers(0, spec.num_classes, TRAIN_BATCH)
    return {"image": torch.from_numpy(images).to(PARALLEL_CARD),
            "label": torch.from_numpy(labels).to(PARALLEL_CARD)}


def fp32_loss(torch, batch, params):
    """The float32 network's train-mode loss on ``batch`` at ``params``
    (float32 master weights, either dtype's), and its logits' largest
    magnitude; a fresh state, so no other run's statistics move."""
    import torch.nn.functional as F

    from sparkdl_tpu_torch.parallel.train import softmax_cross_entropy
    state, step = train_state(torch, torch.float32)
    with torch.no_grad():
        for k, v in params.items():
            state.params[k].copy_(v)
        x = step.preprocess(batch["image"].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        logits = state.module(x, features_only=False, train=True)
        targets = F.one_hot(batch["label"], logits.shape[-1]).float()
        loss = softmax_cross_entropy(logits, targets).mean()
    return float(loss), float(logits.abs().max())


def run_steps(torch, step, state, batch, n):
    """``n`` steps; each step's loss and its device ms by CUDA events."""
    losses, ms = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    return state, losses, ms


def same_state(torch, a, b):
    """Whether two states hold the same bits in every parameter and
    BatchNorm statistic."""
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params) \
        and all(torch.equal(a.batch_stats[k], b.batch_stats[k])
                for k in a.batch_stats)


def train_phase(torch, np, smi_line):
    """The data-parallel train step at full width (module docstring,
    ``parallel``): plain, through a one-rank NCCL group on the global
    mesh, bf16 against float32, and a checkpoint round trip."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from sparkdl_tpu_torch.parallel import (
        global_mesh,
        initialize,
        make_mesh,
        shard_train_step,
    )
    from sparkdl_tpu_torch.parallel.checkpoint import (
        PytreeCheckpointer,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    # deterministic cuDNN algorithms: the plain and the group-of-one runs
    # must give the same bits
    cudnn.deterministic, cudnn.benchmark = True, False
    batch = train_batch(torch, np)
    try:
        # (a) plain: a mesh of one, no process group (the step as it is)
        state_a, step_a = train_state(torch)
        step_a, state_a = shard_train_step(step_a, make_mesh(), state_a)
        stats0 = {k: v.clone() for k, v in state_a.batch_stats.items()}
        torch.cuda.reset_peak_memory_stats()
        state_a, losses_a, ms_a = run_steps(torch, step_a, state_a, batch,
                                            TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        moved = sum(not torch.equal(stats0[k], v)
                    for k, v in state_a.batch_stats.items())
        # (b) the same steps through a one-rank NCCL group
        initialize(num_processes=1)
        try:
            backend = dist.get_backend()
            mesh = global_mesh()
            state_b, step_b = train_state(torch)
            step_b, state_b = shard_train_step(step_b, mesh, state_b)
            state_b, losses_b, ms_b = run_steps(torch, step_b, state_b,
                                                batch, TRAIN_STEPS)
        finally:
            dist.destroy_process_group()
        equal_b = losses_b == losses_a and same_state(torch, state_a,
                                                      state_b)
        del state_b
        # (c) one step in bf16 against the same step in float32
        updates, losses_c, stepped = {}, {}, {}
        for label, dtype in (("bf16", None), ("fp32", torch.float32)):
            state_c, step_c = train_state(torch, dtype)
            before = {k: v.detach().clone()
                      for k, v in state_c.params.items()}
            state_c, (loss,), _ = run_steps(torch, step_c, state_c, batch,
                                            1)
            losses_c[label] = loss
            stepped[label] = {k: v.detach().clone()
                              for k, v in state_c.params.items()}
            updates[label] = torch.cat([(stepped[label][k] - before[k])
                                        .reshape(-1) for k in before])
            del state_c
        u16, u32 = updates["bf16"], updates["fp32"]
        update_rel = float((u16 - u32).norm() / u32.norm())
        update_cos = float(torch.dot(u16, u32) / (u16.norm() * u32.norm()))
        loss0, logits_max = fp32_loss(torch, batch, before)
        after = {label: fp32_loss(torch, batch, p)[0]
                 for label, p in stepped.items()}
        loss_diff = abs(losses_c["bf16"] - losses_c["fp32"])
        loss_bound = 2 * TRAIN_FWD_ROUNDINGS * BF16_HALF_STEP * logits_max
        # the checkpoint: state (a) saved three times under keep=2, the
        # last restored into a fresh state, one more step on each
        ckdir = tempfile.mkdtemp(prefix="sparkdl_ckpt_")
        try:
            for step_no in range(TRAIN_STEPS - 2, TRAIN_STEPS + 1):
                t0 = time.perf_counter()
                path = save_checkpoint(ckdir, state_a, step=step_no,
                                       keep=CKPT_KEEP)
                save_s = time.perf_counter() - t0
            save_bytes = sum(os.path.getsize(os.path.join(path, f))
                             for f in os.listdir(path))
            with PytreeCheckpointer(ckdir) as ck:
                kept = ck.all_steps()
            latest = latest_step(ckdir)
            fresh, fresh_step = train_state(torch)
            t0 = time.perf_counter()
            fresh = restore_checkpoint(ckdir, fresh)
            restore_s = time.perf_counter() - t0
            restored_step = fresh.step
            state_a, (loss_a6,), _ = run_steps(torch, step_a, state_a,
                                               batch, 1)
            fresh, (loss_r6,), _ = run_steps(torch, fresh_step, fresh,
                                             batch, 1)
            equal_ckpt = loss_a6 == loss_r6 and same_state(torch, state_a,
                                                           fresh)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    # the same steps with cuDNN's default algorithms (not deterministic)
    state_d, step_d = train_state(torch)
    _, _, ms_default = run_steps(torch, step_d, state_d, batch, TRAIN_STEPS)
    del state_d
    emit("parallel_train", model=TRAIN_MODEL, batch=TRAIN_BATCH,
         tx=list(TRAIN_TX), steps=TRAIN_STEPS, losses=losses_a,
         step_ms=ms_a, ms_per_step=median(ms_a[1:]),
         ms_per_step_default_algorithms=median(ms_default[1:]),
         peak_memory_bytes=peak, bn_stats_moved=moved,
         bn_stats=len(stats0), nccl_backend=backend,
         nccl_group_bit_equal=equal_b, nccl_step_ms=median(ms_b[1:]),
         bf16_vs_fp32={"loss_bf16": losses_c["bf16"],
                       "loss_fp32": losses_c["fp32"],
                       "loss_abs_diff": loss_diff, "loss_bound": loss_bound,
                       "logits_max_fp32": logits_max,
                       "fp32_loss_before": loss0,
                       "fp32_loss_after_bf16_update": after["bf16"],
                       "fp32_loss_after_fp32_update": after["fp32"],
                       "update_rel_norm_diff": update_rel,
                       "update_cosine": update_cos},
         checkpoint={"save_s": save_s, "save_bytes": save_bytes,
                     "restore_s": restore_s, "kept": kept, "latest": latest,
                     "restored_step": restored_step,
                     "resumed_bit_equal": equal_ckpt},
         card=smi_line)
    if not losses_a[-1] < losses_a[0] or moved != len(stats0):
        raise AssertionError(f"train: losses {losses_a}, BN statistics "
                             f"moved {moved} of {len(stats0)}")
    if backend != "nccl" or not equal_b:
        raise AssertionError(f"train: the one-rank {backend} group's steps "
                             f"are not bit for bit the plain steps "
                             f"({losses_b} against {losses_a})")
    if not (loss_diff <= loss_bound and after["bf16"] < loss0
            and after["fp32"] < loss0 and np.isfinite(update_rel)):
        raise AssertionError(f"train: bf16 against float32 loss diff "
                             f"{loss_diff} (bound {loss_bound}); float32 "
                             f"loss {loss0} before, {after} after each "
                             f"update; update distance {update_rel}")
    want = list(range(TRAIN_STEPS + 1 - CKPT_KEEP, TRAIN_STEPS + 1))
    if (kept != want or latest != TRAIN_STEPS
            or restored_step != TRAIN_STEPS or not equal_ckpt):
        raise AssertionError(f"checkpoint: kept {kept} (want {want}), "
                             f"latest {latest}, restored step "
                             f"{restored_step}, resumed bit-equal "
                             f"{equal_ckpt}")


def ke_loader(uri):
    """The phase's imageLoader: row ``synth://<i>`` as a seeded 299×299×3
    float32 array in [-1, 1] (the card's machine has no image decoder)."""
    import numpy as np
    i = int(uri.split("://", 1)[1])
    return np.random.default_rng((KE_SEED, i)).uniform(
        -1.0, 1.0, (299, 299, 3)).astype(np.float32)


def ke_spec(np, repo):
    """The committed InceptionV3 topology with seeded weights drawn by
    each variable's shape: conv kernels He-normal, the dense kernel
    Glorot-uniform, BatchNorm means and biases 0, variances 1, as Keras
    initialises them."""
    from sparkdl_tpu_torch.graph.keras_convert import KerasSpec
    with open(os.path.join(repo, KE_SPEC)) as f:
        spec = KerasSpec.from_json(f.read())
    rng = np.random.default_rng(KE_SEED)
    for v in spec.variables():
        shape = tuple(v["shape"])
        if v["name"] == "kernel" and len(shape) == 4:
            std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
            value = rng.standard_normal(shape, np.float32) * np.float32(std)
        elif v["name"] == "kernel":
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            value = rng.uniform(-lim, lim, shape).astype(np.float32)
        elif v["name"] in ("moving_variance", "gamma"):
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        spec.weights[v["path"]] = value
    return spec


def ke_estimator(spec, fit=None, **over):
    """The phase's estimator over the seeded spec (the private seam in
    place of reading the model file: the card's machine has no keras)."""
    from sparkdl_tpu_torch import KerasImageFileEstimator
    kw = dict(inputCol="uri", outputCol="probs", labelCol="label",
              modelFile=KE_SPEC, imageLoader=ke_loader,
              kerasOptimizer="adam", kerasLoss="categorical_crossentropy",
              kerasFitParams={"epochs": KE_EPOCHS, "batch_size": KE_BATCH,
                              "seed": KE_SEED, **(fit or {})},
              batchSize=KE_BATCH_LARGE, useMesh=False)
    kw.update(over)
    est = KerasImageFileEstimator(**kw)
    est._spec_override = spec
    return est


def ke_fit(torch, est, frame, walls, name):
    t0 = time.perf_counter()
    model = est.fit(frame)
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return model


def ke_same(torch, a, b):
    """Two fitted models with the same history and every parameter and
    moving statistic bit for bit."""
    sa = a.modelFunction.module.state_dict()
    sb = b.modelFunction.module.state_dict()
    return a.history == b.history and sa.keys() == sb.keys() and all(
        torch.equal(sa[k], sb[k]) for k in sa)


@contextlib.contextmanager
def ke_step_events(torch):
    """CUDA events around every train step taken inside the block."""
    from sparkdl_tpu_torch.estimators import keras_image_file_estimator as k
    real = k._TrainStep.__call__
    events = []

    def timed(self, xb, yb):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = real(self, xb, yb)
        end.record()
        events.append((start, end))
        return loss

    k._TrainStep.__call__ = timed
    try:
        yield events
    finally:
        k._TrainStep.__call__ = real


def ke_timed_fit(torch, est, frame, walls, name):
    """A fit with each step's device ms by CUDA events and the peak
    memory."""
    torch.cuda.reset_peak_memory_stats()
    with ke_step_events(torch) as events:
        model = ke_fit(torch, est, frame, walls, name)
    ms = [s.elapsed_time(e) for s, e in events]
    return model, ms, torch.cuda.max_memory_allocated()


def ke_moved(model):
    """How many BatchNorm layers' moving means and variances moved from
    Keras's initial 0 and 1."""
    module = model.modelFunction.module
    state = module.state_dict()
    means = [state[name] for path, (name, _) in module.variables.items()
             if path.endswith("/moving_mean")]
    variances = [state[name] for path, (name, _) in module.variables.items()
                 if path.endswith("/moving_variance")]
    return (sum(bool((m != 0).any()) for m in means), len(means),
            sum(bool((v != 1).any()) for v in variances), len(variances))


def keras_estimator_phase(torch, np, smi_line, repo):
    """The Keras estimator on the card (module docstring,
    ``keras_estimator``): seven gates over full-width InceptionV3 fits."""
    import logging
    import shutil

    from sparkdl_tpu_torch import DataFrame
    from sparkdl_tpu_torch.ops import infeed

    t_phase = time.perf_counter()
    spec = ke_spec(np, repo)
    labels = np.random.default_rng(KE_SEED + 1).integers(0, KE_LABELS,
                                                         KE_ROWS)
    frame = DataFrame.from_pylist(
        [{"uri": f"synth://{i}", "label": int(labels[i])}
         for i in range(KE_ROWS)], num_partitions=KE_PARTITIONS)
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    infeed.launches = infeed.yuv420_launches = 0
    walls, gates = {}, {}
    ckdir = tempfile.mkdtemp(prefix="sparkdl_ke_ckpt_")
    try:
        # (1) a 2-epoch fit at batch 32 with adam
        a, ms32, peak32 = ke_timed_fit(torch, ke_estimator(spec), frame,
                                       walls, "fit")
        moved = ke_moved(a)
        on_card = all(p.device.type == "cuda" for p in
                      a.modelFunction.module.parameters())
        gates["loss_falls"] = a.history[-1] < a.history[0]
        gates["statistics_moved"] = (moved[0] == moved[1] == 94
                                     and moved[2] == moved[3] == 94)
        gates["parameters_on_cuda"] = on_card
        # (2) the same fit again
        b = ke_fit(torch, ke_estimator(spec), frame, walls, "fit_again")
        gates["repeat_bit_equal"] = ke_same(torch, a, b)
        # (3) one epoch with checkpoints, then resumed to two
        c1 = ke_fit(torch, ke_estimator(spec, {"epochs": 1},
                                        checkpointDir=ckdir),
                    frame, walls, "checkpointed_1_epoch")
        (trial_dir,) = os.listdir(ckdir)
        step_dir = os.path.join(ckdir, trial_dir, "1")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        c2 = ke_fit(torch, ke_estimator(spec, checkpointDir=ckdir), frame,
                    walls, "resumed")
        gates["resume_bit_equal"] = (c2.resumedFrom == 1
                                     and ke_same(torch, c2, b))
        # (4) README's grid at parallelism 2 on the one card, each trial
        # against its own serial fit
        d, ms64, peak64 = ke_timed_fit(
            torch, ke_estimator(spec, {"batch_size": KE_BATCH_LARGE}),
            frame, walls, "fit_batch64")
        est = ke_estimator(spec, parallelism=2)
        fp = est.getParam("kerasFitParams")
        grid = [{fp: {"epochs": KE_EPOCHS, "batch_size": bs,
                      "seed": KE_SEED}}
                for bs in (KE_BATCH, KE_BATCH_LARGE)]
        t0 = time.perf_counter()
        trials = dict(est.fitMultiple(frame, grid))
        torch.cuda.synchronize()
        walls["fit_multiple"] = time.perf_counter() - t0
        gates["fit_multiple_bit_equal"] = (
            sorted(trials) == [0, 1] and ke_same(torch, trials[0], a)
            and ke_same(torch, trials[1], d))
        del trials
        # (5) transform against the trained module's eval forward
        t0 = time.perf_counter()
        probs = np.asarray(a.transform(frame).collect()["probs"])
        walls["transform"] = time.perf_counter() - t0
        x = np.stack([ke_loader(f"synth://{i}") for i in range(KE_ROWS)])
        with torch.inference_mode():
            ref = np.concatenate([
                a.modelFunction.module({"input": torch.from_numpy(
                    x[i:i + KE_BATCH_LARGE]).cuda()})["output_0"]
                .cpu().numpy() for i in range(0, KE_ROWS, KE_BATCH_LARGE)])
        gates["transform_bit_equal"] = (
            probs.shape == (KE_ROWS, 1000) and bool(np.isfinite(probs).all())
            and np.array_equal(probs, ref))
        # (6) streaming, with and without cacheDecoded
        e = ke_fit(torch, ke_estimator(spec, streaming=True), frame, walls,
                   "streaming")
        f = ke_fit(torch, ke_estimator(spec, streaming=True,
                                       cacheDecoded=True),
                   frame, walls, "streaming_cached")
        gates["cache_decoded_bit_equal"] = ke_same(torch, e, f)
        # (7) useMesh=True on the one card: one warning, the same bits
        log = logging.getLogger(
            "sparkdl_tpu_torch.estimators.keras_image_file_estimator")
        seen = []
        handler = logging.Handler()
        handler.emit = seen.append
        log.addHandler(handler)
        try:
            g = ke_fit(torch, ke_estimator(spec, useMesh=True), frame, walls,
                       "use_mesh")
        finally:
            log.removeHandler(handler)
        warned = sum("useMesh requested" in r.getMessage() for r in seen)
        gates["use_mesh_warns_once_bit_equal"] = (warned == 1
                                                  and ke_same(torch, g, b))
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
        shutil.rmtree(ckdir, ignore_errors=True)
    launches = {KERNEL: infeed.launches, KERNEL_YUV420: infeed.yuv420_launches}
    emit("keras_estimator", model="keras.applications.InceptionV3",
         spec=KE_SPEC, rows=KE_ROWS, partitions=KE_PARTITIONS,
         epochs=KE_EPOCHS, optimizer="adam",
         dtype="float32", tf32={"matmul": torch.backends.cuda.matmul
                                .allow_tf32,
                                "cudnn": torch.backends.cudnn.allow_tf32},
         cudnn_deterministic=True,
         step_ms={str(KE_BATCH): median(ms32[1:]),
                  str(KE_BATCH_LARGE): median(ms64[1:])},
         step_ms_all={str(KE_BATCH): ms32, str(KE_BATCH_LARGE): ms64},
         peak_memory_bytes={str(KE_BATCH): peak32,
                            str(KE_BATCH_LARGE): peak64},
         history=a.history, bn_moving_moved=list(moved),
         fit_wall_s=walls, first_fit=a.fitStats,
         optimizer_construction_s=a.fitStats["optimizer_s"],
         checkpoint={"bytes": ckpt_bytes,
                     "save_s": c1.fitStats["save_s"],
                     "restore_s": c2.fitStats["restore_s"],
                     "resumed_from": c2.resumedFrom},
         use_mesh_warnings=warned, gates=gates, kernel_launches=launches,
         card=smi_line)
    emit("keras_estimator_phases", seconds=time.perf_counter() - t_phase,
         fits=len(walls) - 1, card=smi_line)
    failed = [k for k, ok in gates.items() if not ok]
    if failed or any(launches.values()):
        raise AssertionError(f"keras_estimator: gates failed {failed}; "
                             f"kernel launches {launches} (none expected)")


def parallel_phase(torch, np, smi_line, frame, head, featurize_ref):
    """``parallel/`` on the card (module docstring, ``parallel``).
    Returns K1's and K2's launches over the phase."""
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.obs import default_registry
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    t0 = time.perf_counter()
    reg = default_registry()
    names = ("collective.launches", "collective.lock_wait_seconds",
             "collective.lock_waits")
    before = {k: reg.counter(k).value for k in names}
    feat_mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"),
                                (512, 512))
    k1 = sharded_path(torch, np, smi_line, feat_mf, frame[0], "featurize",
                      KERNEL)
    packed = np.asarray(head[0].collect()["image"])
    k2 = sharded_path(torch, np, smi_line, head[1], packed, "headline",
                      KERNEL_YUV420)
    k1 += use_mesh_pass(torch, np, smi_line, frame, featurize_ref)
    k2 += mesh_serve(torch, np, smi_line, head[1])
    train_phase(torch, np, smi_line)
    emit("parallel_phases", seconds=time.perf_counter() - t0,
         collective={k: reg.counter(k).value - before[k] for k in names},
         launches={KERNEL: k1, KERNEL_YUV420: k2}, card=smi_line)
    return k1, k2


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
    # online serving: the headline's function (K2) and the featurize
    # function (K1) behind a ModelServer, then the drills on TestNet
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    k1_paths["serve"], yuv_serve = serve_phase(
        torch, np, smi, head[1],
        deviceResizeModel(zoo.getModelFunction("InceptionV3"), (512, 512)),
        zoo.getModelFunction("TestNet"))
    # tracing and health over both paths
    k1_paths["obs"], yuv_obs = obs_phase(torch, np, smi, frame, head,
                                         zoo.getModelFunction("TestNet"))
    # several devices: the sharded runner, useMesh, a mesh-backed serve
    # session, the data-parallel train step and its checkpoint
    k1_paths["parallel"], yuv_parallel = parallel_phase(
        torch, np, smi, frame, head, featurize_ref)
    del frame, head, featurize_ref
    # the Keras estimator: full-width InceptionV3 fits (no kernel of the
    # port's runs on this path: its convolutions are cuDNN's)
    keras_estimator_phase(torch, np, smi, repo)
    yuv_paths = {"headline": yuv_launches, "strategies": yuv_strategies,
                 "host_pipeline": yuv_pipe, "input_service": yuv_fleet,
                 "snapshot": yuv_snapshot, "export": yuv_export,
                 "export_fresh_process": yuv_fresh, "serve": yuv_serve,
                 "obs": yuv_obs, "parallel": yuv_parallel}
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
