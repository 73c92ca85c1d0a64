#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sparkdl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each on stdout:

1. ``env``       — the card (nvidia-smi name and power limit), torch, CUDA.
2. ``build``     — builds the port's three CUDA kernels from the checkout's
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
   ``kernel_epilogue`` — K3 (the conv units' inference epilogue):
                   every distinct conv-unit output of InceptionV3 and
                   ResNet50 at batch 256, channels_last and contiguous,
                   with and without conv bias, residual and ReLU, seeded
                   inputs with NaN, ±0 and ±inf planted: value for value
                   the eager chain (``conv_epilogue_plain``), in the
                   input's layout. Per network: each unit's device ms
                   from a CUDA graph summed over the network beside its
                   bound; the largest unit's ms, device ms, plain ms and
                   bound (3.35 TB/s) and its launch; then a featurize
                   pass (8 chunks of 64) where K3 and
                   ``model.epilogue.fused`` count units × chunks and
                   ``model.epilogue.eager`` 0, and one batch through the
                   network with K3 against the eager chain (gradients
                   on), value for value. ``host_us``: the host's µs a
                   call of K3's wrapper, of its launch configuration, of
                   a unit's per-channel terms and of the plain chain.
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
22. ``lint``      — the port's static analysis on the card's machine,
                   after ``obs``: ``python3 -m sparkdl_tpu_torch.analysis
                   --json`` with its default targets (the package and this
                   script), cold then warm on a fresh cache file
                   (``lint_analyzer``: exit 0 and 0 unsuppressed findings
                   both times, every file a cache hit warm; the suppressed
                   counts by rule, the seconds); the analyzer's torch sync
                   table held against the card's guard (``lint_sync_table``:
                   each H14 and H1 form run on a card tensor under
                   ``SPARKDL_TPU_SANITIZE=1`` and analyzed as a line of a
                   hot loop — every form H14 flags is refused, ``.numpy()``
                   and ``np.asarray`` with their own ``TypeError``, which
                   the message names; ``len(t)``, iteration and the drain's
                   pinned copy and event wait are neither flagged nor
                   refused; printed as form, rule, flagged, guard); the
                   NaN stop (``lint_nan_stop``: a TestNet emitting one NaN
                   row in chunk 2 of 4 raises ``FloatingPointError`` naming
                   the chunk under ``SPARKDL_TPU_SANITIZE_NANS=1``, and
                   without that flag the guarded output is bit for bit the
                   unguarded); the ring's registry keys (``lint_ring_keys``:
                   the featurize function, K1, twice over two chunks of 64
                   through a 2-slot ring, the registry's ``ship.ring_*`` and
                   ``ship.bytes_*`` against the runner's ``ShipStats``, the
                   second pass 2 hits and both chunks' bytes resident, none
                   reshipped, ``ship.inflight_peak`` at least 1); then
                   ``lint_phases``: the phase's seconds (under 60).
23. ``forensics`` — measurement on the card, after ``lint``, with the
                   compile log and the ledger armed (InceptionV3 at batch
                   64): the ledger's link ceilings probed on the card
                   (``probe_ceilings(force=True)``); the featurize pass
                   (K1, 8 times) and the headline pass (K2, 8 times)
                   again, the headline bit for bit its own phase's; every
                   compile event (weight placements, first calls with
                   their FLOPs, the port's ops they did not count, and
                   their peak bytes); InceptionV3's recorded FLOPs at 64
                   within 5% of the analytic 2·MACs of its convolutions
                   (``conv_flops``); the steady contract
                   (``warmup_runner``, then 128 rows at the warm shape: no
                   event, then one batch of 48: exactly one unexpected
                   retrace whose diff names ``inputs.image``); the
                   footprint's first-call rung beside one batch's peak
                   measured directly and the signature rung;
                   ``measure_device_resident`` beside ``runner_split``'s
                   graph time, and with the compile log disarmed and
                   armed in turns; ``profiling.trace`` over one warm
                   featurize pass: the device's busy share (the union of
                   its kernels' and copies' time over the pass's wall)
                   and its top 5 device ops, the Chrome trace written
                   under ``sparkdl_tpu_torch/_build/forensics_trace``
                   (git ignores it); the ledger's windows closed during
                   the two passes (``ledger.util.*``, ``bound_by``,
                   ``headroom_pct``, at least one); ``/metricsz``
                   carrying ``ledger.*`` and ``hbm.*``, ``/statusz`` and
                   a flight bundle with ``ledger`` and ``compile``
                   sections that are not error entries, ``/healthz``
                   counting the one retrace.
24. ``parallel``  — ``parallel/`` on the card, after ``forensics``: the
                   featurize rows (K1) and the headline rows (K2) through
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
25. ``autotune``  — the closed loop and the worker plane, after
                   ``parallel``: the autotune controller armed with
                   ``interval_s=0`` (a step after every runner run and
                   every served micro-batch), the tracer and the compile
                   log armed, each target attached after arming. The
                   disarmed ``poll()``'s median µs over 100,000 calls;
                   ``FleetTarget`` on a registry with one replica of the
                   headline's function: with no fresh ledger window it
                   never scales; ``RechunkTarget`` on the headline runner
                   with the ladder {32, 64, 128}: the prewarm runs each
                   rung once (K2 3 times) and marks the model steady;
                   partitions of 20 rows step the rung down by one with
                   K2 launching each run; partitions of 128 rows move the
                   ladder with no unexpected retrace; one ragged run of
                   100 rows counts exactly as many unexpected retraces as
                   the new shapes the model saw (a forward pre-hook
                   records them); every ladder run against an unarmed run
                   at 64 on the same rows (bit for bit at 64, within
                   BOUND_FEATURES_REL elsewhere); ``RunnerTarget`` on
                   the featurize runner (K1, prefetch strategy): one
                   window of memory pressure sheds ``prefetch_depth`` by
                   one, a trial that cannot pay ``min_gain`` (set to
                   10) reverts and freezes, a forced quick flip of
                   ``prefetch_depth`` is refused as an oscillation;
                   ``ServeTarget`` on a session of the headline: a burst
                   of full requests shrinks ``max_wait_s``, a trickle of
                   8-row requests grows it within the p99 budget, each
                   answer bit for bit the offline runner; two pooled
                   worker processes over the 4:2:0 headline with
                   telemetry armed and ``PipelineTarget`` attached: the
                   rows bit for bit the serial engine's, the exported
                   trace's worker tracks at ``WORKER_PID_BASE + i`` with
                   every worker span inside the parent's run window,
                   ``worker.all.*`` the sum of ``worker.<i>.*``, a degrade
                   raised in both workers logged once in the parent, and
                   a worker-death fault injected into a second pool
                   naming its dead in ``/healthz`` and the flight
                   bundle's ``workers[]``; then the fleet under sustained
                   load with the ledger armed: at most one replica more,
                   answers bit for bit those before. One ``autotune``
                   line: each applied decision (target, knob, from, to,
                   reason), the controller's state, every section's
                   numbers, the phase's seconds and K1's and K2's
                   launches.
26. ``fleet``     — the fleet control plane over both paths, after
                   ``autotune``: one ``ModelServer`` with bench.py's serve
                   config behind one ``ModelRegistry`` with a warm-start
                   store in a temporary directory. ``placement``: the
                   card's measured budget, both functions (the headline's,
                   K2, and the featurize one, K1; seed-0 InceptionV3) at 2
                   replicas each planned on device 0, one byte more than
                   the free memory refused (counted), each function's
                   signature estimate beside the peak measured over a
                   warm batch; ``deploy``: both deployed on that plan, the
                   first deploy of each writing its ``torch.export`` blob
                   (seconds, bytes); ``route``: the serve phase's traffic
                   for each through ``registry.submit`` (counted: every
                   answer bit for bit the offline runner, launches equal
                   to the replicas' micro-batches, nothing built, every
                   replica used; p50/p99, rows/s and ``fleet.routes``
                   beside the serve phase's numbers for the same traffic
                   sent straight to a server); ``swap``: the headline's
                   traffic in rounds while its weights are swapped to
                   ``init_state_dict("InceptionV3", seed=1)`` (nothing
                   dropped, each answer's rows bit for bit v1's or v2's
                   offline output, a request of one micro-batch all one
                   version, v2 alone after the swap, version 2 with a new
                   fingerprint; stage / flip / probe ms, the longest gate
                   wait, the peak memory, the window's p99);
                   ``warm_start``: ``scale("headline", 3)`` a warm hit with
                   ``torch.export.export`` refused, answering v2's bits,
                   and a fresh ``python3 -c`` process that deploys the
                   seed-0 headline cold and then against the store (one
                   hit, no export, v1's bits), each replica's seconds and
                   first request's ms; ``drills``: a resized tensor
                   refused before any transfer, ``fleet.swap`` at rate 1.0
                   rolled back with v2 serving and the swap then made,
                   ``fleet.route`` at 0.5 (seed 7) with nothing dropped;
                   ``statusz``: ``/statusz`` carries ``registry.state()``.
                   Then ``fleet_phases``.
27. ``keras_estimator`` — ``KerasImageFileEstimator`` training
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
28. ``spark``     — the Spark face (``data/spark_binding.py``) through a
                   duck-typed session in this script whose ``runJob``
                   pickles a job's task function once with the standard
                   library (dump seconds and bytes printed) and loads it,
                   and each partition's element, per task (load seconds
                   printed): ``DeepImageFeaturizer("InceptionV3",
                   deviceResizeFrom=(512, 512))`` over 256 seeded
                   512×512 rows in 4 partitions under ``SparkEngine``, bit
                   for bit the same plan under ``LocalEngine``, K1 4 times
                   from the unpickled export (wall s and rows/s, host
                   clock); the 4:2:0 headline (256 packed 150×150 rows,
                   ``TensorTransformer``) likewise with K2 4 times; a
                   host-backend ``ModelFunction`` (numpy L2 rows) after
                   the featurizer in one local plan: equal to numpy on
                   the collected features, ``ship.bytes_shipped`` grown by
                   the featurizer's input bytes alone, and a plan holding
                   it refusing ``pickle`` with ``TypeError``; an image
                   ``ModelUDF`` over the featurizer's function registered
                   by ``register_udf`` and called on an ndarray of image
                   structs after a ``pickle`` round trip, bit for bit
                   ``ModelUDF.apply`` (K1 once); ``union``, ``join`` on an
                   id, ``limit``, ``repartition``, ``coalesce`` and
                   ``sample`` over the features on the Spark engine, each
                   equal to the verb on the collected batch; and the
                   boundaries: where pyarrow or pandas is installed,
                   one partition's Arrow batch through
                   ``plan_to_map_in_arrow`` bit for bit its local rows, a
                   ``write_parquet`` read back equal, ``to_pandas``; where
                   a package is absent (tensorflow, pyspark there), its
                   path (a TF-era source, ``SparkEngine()``) raising with
                   the package's name. Then the phase's wall seconds.
29. ``trained_predict`` — ``DeepImagePredictor(modelName="TestNet",
                   decodePredictions=True, topK=1)`` with the committed,
                   trained weights (read by the port's msgpack reader)
                   over the held-out set its provenance names: accuracy
                   at least 0.95, each decoded name the raw scores' best.
30. ``transfer_trained`` — ``Pipeline([DeepImageFeaturizer("TestNet"),
                   LogisticRegression()])`` on the TestNet's 4,096 train
                   images, then ``CrossValidator`` (3 folds) and
                   ``TrainValidationSplit`` over ``regParam`` {0, 1e-2} ×
                   ``maxIter`` {50, 100} on the cached featurized train
                   split: finite metrics, and held-out accuracy at least
                   0.95 after the fit and for each best model.
31. ``logreg_scale`` — ``LogisticRegression`` alone on 262,144 × 2,048
                   seeded fp32 features, 10 classes, 64 partitions:
                   full-batch for 100 steps (ms a step beside its bound:
                   the table read twice a step over HBM bandwidth), the
                   step alone by CUDA events, one minibatch and one
                   streaming epoch at batch 4096, the default budget's
                   switch to streaming (with its warning), and the card
                   against the CPU at 8,192 rows, 20 steps.
32. ``kernels``  — each kernel's launches on its paths and pass/fail.

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
import logging
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
KERNEL_EPILOGUE = "conv_epilogue"
KERNEL_EPILOGUE_SOURCE = "sparkdl_tpu_torch/ops/csrc/conv_epilogue.cu"
KERNEL_EPILOGUE_REPLACES = ("sparkdl_tpu_torch/models/layers.py's eager "
                            "conv-unit epilogue (XLA fuses it in the JAX "
                            "package: no Pallas kernel)")

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
# the kernel_epilogue phase: every distinct conv-unit output of the two
# benchmarked networks at the benchmark's batch, each in both layouts with
# and without bias, residual and ReLU; values planted in each input
EPILOGUE_NETS = ("InceptionV3", "ResNet50")
EPILOGUE_BATCH = 256
EPILOGUE_SPECIALS = (float("nan"), 0.0, -0.0, float("inf"), float("-inf"))
EPILOGUE_PLANTED = 64    # of each special value, in y and in the residual
# the host's cost of one conv unit's epilogue: calls enqueued back to back
# on a unit small enough that the card keeps up (bias, residual, ReLU)
EPILOGUE_HOST_SHAPE = (1, 64, 8, 8)
EPILOGUE_HOST_CALLS = 2000
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
# what the fleet phase compares its routed passes with
DIRECT_FIELDS = ("p50_ms", "p99_ms", "achieved_rows_per_s", "rejected",
                 "offered_rows")
# the fleet phase: replicas a model, and the failover drill's requests
FLEET_REPLICAS = 2
FLEET_FAILOVER_REQUESTS = 20
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
# the forensics phase: the ledger's window while its passes run, the
# off-shape batch of the steady contract, the bound on InceptionV3's
# recorded FLOPs against the analytic count (relative), and how many
# device ops the profile lists
FORENSICS_WINDOW_S = 0.2
# the autotune phase: the ladder of the K2 headline runner, its partitions
# (20 rows: fill 20/64 under the ladder's down_fill; multiples of 128;
# one ragged 100 = 64 + a 36-row tail at rung 64), the serve window's
# traffic, the pooled pipeline's partitions, the fleet's load
AUTOTUNE_POLLS = 100_000
AUTOTUNE_LADDER = (32, 64, 128)
AUTOTUNE_SMALL_ROWS = 20
AUTOTUNE_SMALL_RUNS = 5
AUTOTUNE_FULL_RUNS = 4
AUTOTUNE_FULL_ROWS = 128
AUTOTUNE_RAGGED_ROWS = 100
AUTOTUNE_WINDOW_S = 0.2
AUTOTUNE_SERVE_WAIT_S = 0.02
AUTOTUNE_SERVE_MIN_WAIT_S = 0.005
AUTOTUNE_LATENCY_BUDGET_S = 2.0
AUTOTUNE_QUEUE_ROWS = 8192
AUTOTUNE_SERVE_BURST = 16
AUTOTUNE_SERVE_TRICKLE = 12
AUTOTUNE_TRICKLE_ROWS = 8
AUTOTUNE_PIPE_PARTS = 8
AUTOTUNE_FLEET_REQUESTS = 8
AUTOTUNE_FLEET_LOAD = 24
AUTOTUNE_FLEET_WAVES = 3
FORENSICS_OFF_BATCH = 48
FORENSICS_FLOPS_REL = 0.05
FORENSICS_TOP_OPS = 5
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


def unit_outputs(torch, name):
    """Every conv unit of the zoo network ``name`` in forward order, as
    ``(C, H, W, bias, residual, relu)`` of its output, from hooks on a
    one-image forward on the meta device (no weights, no kernels)."""
    from sparkdl_tpu_torch.models import layers, zoo
    spec = zoo.getKerasApplicationModel(name)
    with torch.device("meta"):
        net = spec.module_fn().eval()
    units = []

    def hook(mod, args, kwargs, out):
        units.append((int(out.shape[1]), int(out.shape[2]),
                      int(out.shape[3]),
                      getattr(getattr(mod, "conv", None), "bias",
                              None) is not None,
                      kwargs.get("residual") is not None, bool(mod.relu)))
    for m in net.modules():
        if isinstance(m, (layers.ConvBN, layers.SeparableConvBN)):
            m.register_forward_hook(hook, with_kwargs=True)
    x = torch.empty((1, spec.height, spec.width, 3), device="meta")
    with torch.no_grad():
        net(x.permute(0, 3, 1, 2), features_only=True)
    return units


def epilogue_terms(torch, c, gen):
    """Seeded per-channel terms of a conv unit on the card: the bf16 conv
    bias and BatchNorm's (mean, mul, offset) as ``BatchNorm`` makes them
    (eps 1e-3)."""
    def draw(lo, hi):
        return torch.rand(c, generator=gen, device="cuda") * (hi - lo) + lo
    bias = (torch.randn(c, generator=gen, device="cuda") * 0.2).to(
        torch.bfloat16)
    mean = torch.randn(c, generator=gen, device="cuda") * 0.2
    mul = torch.rsqrt(draw(0.6, 1.4) + 1e-3) * draw(0.8, 1.2)
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    return bias, mean, mul, beta


def planted(torch, shape, gen):
    """A seeded bf16 [N, C, H, W] channels_last tensor (a permuted NHWC
    one, as the conv's output is) with ``EPILOGUE_PLANTED`` of each
    special value at seeded places."""
    n, c, h, w = shape
    base = torch.randn((n, h, w, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    flat = base.view(-1)
    k = EPILOGUE_PLANTED
    where = torch.randint(0, flat.numel(), (k * len(EPILOGUE_SPECIALS),),
                          generator=gen, device="cuda")
    values = torch.tensor(EPILOGUE_SPECIALS, device="cuda").repeat_interleave(
        k).to(torch.bfloat16)
    flat[where] = values
    return base.permute(0, 3, 1, 2)


def same_values(torch, a, b):
    """(value-equal, NaN in the same places; values whose bits differ
    outside NaN, i.e. +0 against -0)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False, -1
    fa, fb = a.masked_fill(na, 0), b.masked_fill(nb, 0)
    bits = int((fa.view(torch.int16) != fb.view(torch.int16)).sum())
    return bool(torch.equal(fa, fb)), bits


def epilogue_bytes(shape, bias, res):
    """Least HBM traffic of one call: y read and the output written once
    (bf16), the residual read once, the per-channel terms once."""
    n, c, h, w = shape
    elems = n * c * h * w
    return 2 * elems * (2 + int(res)) + c * (12 + 2 * int(bias))


def epilogue_case_timing(torch, epilogue, shape, bias, res, relu, gen,
                         iters=10):
    """K3's device ms on one unit's shape (channels_last, from a CUDA
    graph), beside its bound and how it launches."""
    y = planted(torch, shape, gen)
    r = planted(torch, shape, gen) if res else None
    b, mean, mul, beta = epilogue_terms(torch, shape[1], gen)
    b = b if bias else None

    def call():
        return epilogue.conv_epilogue(y, b, mean, mul, beta, r, relu)
    nbytes = epilogue_bytes(shape, bias, res)
    return {"device_ms": time_ms(call, iters=iters, graph=True),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "launch": epilogue.launch_config(y, b, mean, mul, beta, r, relu)}


def epilogue_host_us(torch, epilogue, gen):
    """Host µs of one call, each enqueued right after the last on
    ``EPILOGUE_HOST_SHAPE`` (the card finishes each before the host has
    the next, so the wall time is the host's): K3 through its wrapper
    (the op's dispatch, the checks, the launch configuration, the ctypes
    launch, the counters), the plain chain it replaces, and the per-unit
    terms a conv unit computes before the call (``BatchNorm``'s
    ``inference_terms`` and the bias cast)."""
    from sparkdl_tpu_torch.models.layers import BatchNorm
    c = EPILOGUE_HOST_SHAPE[1]
    y = planted(torch, EPILOGUE_HOST_SHAPE, gen)
    r = planted(torch, EPILOGUE_HOST_SHAPE, gen)
    bias, mean, mul, beta = epilogue_terms(torch, c, gen)
    args = (y, bias, mean, mul, beta, r, True)
    bn = BatchNorm(c).cuda()
    bias32 = bias.float()

    def terms():
        bn.inference_terms()
        bias32.to(torch.bfloat16)

    def us(fn):
        with torch.inference_mode():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EPILOGUE_HOST_CALLS):
                fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / EPILOGUE_HOST_CALLS * 1e6
    return {"shape": list(EPILOGUE_HOST_SHAPE), "calls": EPILOGUE_HOST_CALLS,
            "k3_call": us(lambda: epilogue.conv_epilogue(*args)),
            "launch_config": us(lambda: epilogue.launch_config(*args)),
            "unit_terms": us(terms),
            "plain_chain": us(lambda: epilogue.conv_epilogue_plain(*args))}


def epilogue_pass(torch, np, name, frame, units):
    """One counted featurize pass of ``name`` over the featurize phase's
    frame (8 chunks of 64): K3 must launch once per unit and chunk, the
    registry's fused count the same, its eager count 0. Then one batch of
    64 through the network under ``inference_mode`` (K3) against the same
    batch with gradients on (the eager chain): value for value."""
    from sparkdl_tpu_torch import DeepImageFeaturizer
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.obs.registry import default_registry
    from sparkdl_tpu_torch.ops import epilogue
    imgs, rows, df, _ = frame
    feat = DeepImageFeaturizer(
        modelName=name, inputCol="image", outputCol="features",
        deviceResizeFrom=(512, 512), batchSize=BATCH)
    feat.transform(df).collect()     # cold: builds the model function
    torch.cuda.synchronize()
    reg = default_registry()
    keys = ("model.epilogue.fused", "model.epilogue.eager")
    before = [reg.counter(k).value for k in keys]
    epilogue.launches = 0
    t0 = time.perf_counter()
    out = feat.transform(df).collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fused, eager = (reg.counter(k).value - v for k, v in zip(keys, before))
    launches = epilogue.launches
    chunks = N_IMAGES // BATCH
    want = len(units) * chunks
    feats = np.asarray(out["features"])
    check_order(out, rows)
    if not (launches == fused == want and eager == 0
            and np.isfinite(feats).all()):
        raise AssertionError(
            f"{name}: K3 launched {launches} times, fused "
            f"{fused}, eager {eager}; want {want} ({len(units)} units x "
            f"{chunks} chunks) and 0; features finite "
            f"{bool(np.isfinite(feats).all())}")
    # the same network on the same batch, K3 against the eager chain
    mf = zoo.getModelFunction(name, featurize=True)
    spec = zoo.getKerasApplicationModel(name)
    x = torch.from_numpy(imgs[:BATCH, :spec.height, :spec.width].copy()
                         ).cuda()
    with torch.inference_mode():
        fused_out = mf.module({"image": x})["features"]
    eager_before = reg.counter("model.epilogue.eager").value
    with torch.enable_grad():
        eager_out = mf.module({"image": x})["features"].detach()
    eager_calls = reg.counter("model.epilogue.eager").value - eager_before
    equal, _ = same_values(torch, fused_out, eager_out)
    if not equal or eager_calls != len(units):
        raise AssertionError(
            f"{name}: features with K3 against the eager chain: equal "
            f"{equal}, max |diff| "
            f"{float((fused_out - eager_out).abs().max())}; eager calls "
            f"{eager_calls} of {len(units)} units")
    return {"model": name, "units": len(units), "chunks": chunks,
            "launches": launches, "fused": fused, "eager": eager,
            "pass_s": seconds, "images_per_s": N_IMAGES / seconds,
            "features_equal_eager_chain": equal,
            "eager_chain_units_counted": eager_calls}


def kernel_epilogue(torch, np, smi_line, frame):
    """K3 against the eager chain on the card; see the module docstring.
    Returns the main shape's numbers and the launches of the counted
    passes."""
    from sparkdl_tpu_torch.ops import epilogue
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    nets, cases, failures = {}, 0, []
    for name in EPILOGUE_NETS:
        units = unit_outputs(torch, name)
        distinct = sorted(set(units))
        shapes = sorted({u[:3] for u in units})
        for c, h, w in shapes:
            shape = (EPILOGUE_BATCH, c, h, w)
            y_cl = planted(torch, shape, gen)
            r_cl = planted(torch, shape, gen)
            bias, mean, mul, beta = epilogue_terms(torch, c, gen)
            for cl in (True, False):
                y = y_cl if cl else y_cl.contiguous()
                r = r_cl if cl else r_cl.contiguous()
                for has_bias in (False, True):
                    for has_res in (False, True):
                        for relu in (True, False):
                            args = (y, bias if has_bias else None, mean,
                                    mul, beta, r if has_res else None, relu)
                            got = epilogue.conv_epilogue(*args)
                            ref = epilogue.conv_epilogue_plain(*args)
                            equal, bits = same_values(torch, got, ref)
                            layout_kept = got.stride() == y.stride()
                            cases += 1
                            if not (equal and layout_kept):
                                failures.append({
                                    "net": name, "shape": list(shape),
                                    "channels_last": cl, "bias": has_bias,
                                    "residual": has_res, "relu": relu,
                                    "equal": equal, "bits": bits,
                                    "layout_kept": layout_kept})
                            del got, ref
            del y_cl, r_cl
        # device ms of every unit as the network runs it (channels_last),
        # summed over the network, and the largest shape's full timing
        per_unit = {}
        for cfg in distinct:
            c, h, w, has_bias, has_res, relu = cfg
            per_unit[cfg] = epilogue_case_timing(
                torch, epilogue, (EPILOGUE_BATCH, c, h, w), has_bias,
                has_res, relu, gen)
        k3_ms = sum(per_unit[u]["device_ms"] for u in units)
        bound_ms = sum(per_unit[u]["bound_ms"] for u in units)
        largest = max(distinct, key=lambda u: epilogue_bytes(
            (EPILOGUE_BATCH,) + u[:3], u[3], u[4]))
        c, h, w, has_bias, has_res, relu = largest
        shape = (EPILOGUE_BATCH, c, h, w)
        y = planted(torch, shape, gen)
        r = planted(torch, shape, gen) if has_res else None
        bias, mean, mul, beta = epilogue_terms(torch, c, gen)
        bias = bias if has_bias else None
        args = (y, bias, mean, mul, beta, r, relu)
        nbytes = epilogue_bytes(shape, has_bias, has_res)
        main = speed(nbytes / HBM_BYTES_PER_S * 1e3, nbytes,
                     time_ms(lambda: epilogue.conv_epilogue(*args)),
                     time_ms(lambda: epilogue.conv_epilogue(*args),
                             graph=True))
        main.update(
            shape=list(shape), bias=has_bias, residual=has_res, relu=relu,
            bytes=nbytes, bound_by="bytes",
            plain_ms=time_ms(lambda: epilogue.conv_epilogue_plain(*args)),
            plain_device_ms=time_ms(
                lambda: epilogue.conv_epilogue_plain(*args), graph=True),
            launch=epilogue.launch_config(*args))
        del y, r, args
        nets[name] = {
            "units": len(units), "distinct_units": len(distinct),
            "shapes": len(shapes), "main": main,
            "k3_device_ms_per_batch": k3_ms,
            "k3_bound_ms_per_batch": bound_ms,
            "k3_bound_share_per_batch": bound_ms / k3_ms,
            "units_device_ms": [[list(u), per_unit[u]["device_ms"],
                                 per_unit[u]["bound_ms"],
                                 per_unit[u]["launch"]["mode"]]
                                for u in distinct]}
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K3 differs from the eager chain in "
                             f"{len(failures)} of {cases} cases: "
                             f"{failures[:8]}")
    passes = [epilogue_pass(torch, np, name, frame, unit_outputs(torch, name))
              for name in EPILOGUE_NETS]
    emit("kernel_epilogue", name=KERNEL_EPILOGUE, batch=EPILOGUE_BATCH,
         cases=cases, equal=True, nets=nets, passes=passes,
         host_us=epilogue_host_us(torch, epilogue, gen),
         seconds=time.perf_counter() - t0, card=smi_line)
    return nets, sum(p["launches"] for p in passes)


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
    return model_graph_ms


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
    # sparkdl-lint: allow[H11] -- restored in this function's finally by arm_from_env(), which disarms the request log unless the environment armed it
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
        mine = tails_from_records([r for r in records if r.model == model])
        out[model] = {"answers": res["answers"], "kernel": kernel,
                      "p50_ms": mine["p50_ms"], "p99_ms": mine["p99_ms"],
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
    launches over the counted passes, and each session's latency and
    rows/s alone."""
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
    # each session's traffic alone, straight to the server (the fleet
    # phase routes the same traffic)
    direct = {model: {k: o[k] for k in DIRECT_FIELDS}
              for model, o in alone.items()}
    return (alone["featurize"]["batches"] + both["featurize"]["batches"],
            alone["headline"]["batches"] + both["headline"]["batches"],
            direct)


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
    # sparkdl-lint: allow[H11] -- restored in this function's finally by arm_from_env(), which disarms the tracer unless the environment armed it
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
            trips = {k: v is not None
                     for k, v in sync_trips(torch, np).items()}
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


def sync_trips(torch, np, ops=None):
    """Which ways to wait for the card the armed guard refuses
    (``torch.cuda.set_sync_debug_mode("error")``): the name of what each
    operation raised, None where it ran. ``ops`` defaults to the
    runner's ways to wait."""
    if ops is None:
        ops = runner_waits(torch, np)
    trips = {}
    for name, op in ops.items():
        try:
            op()
            trips[name] = None
        except (RuntimeError, TypeError) as e:
            trips[name] = type(e).__name__
    return trips


def runner_waits(torch, np):
    """The runner's ways to wait for the card, by name."""
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

    return {
        "pageable_blocking_copy_d2h": lambda: torch.empty(1 << 16).copy_(
            dev),
        "pinned_blocking_copy_d2h": lambda: pinned.copy_(dev),
        "pinned_copy_then_event_wait": pinned_copy_then_event_wait,
        "event_synchronize": event_synchronize,
        "stream_synchronize": stream.synchronize,
        "device_synchronize": torch.cuda.synchronize,
        "as_tensor_h2d": lambda: torch.as_tensor(np.zeros(4), device="cuda"),
    }


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


# -- the static analysis (phase ``lint``) ------------------------------------

#: the sync forms of the analyzer's torch table, each run on a card tensor
#: ``t`` (one element) under the armed guard and analyzed as one line of
#: a hot loop: (statement, rule, whether the rule flags it)
LINT_FORMS = (
    ("t.item()", "H14", True),
    ("t.tolist()", "H14", True),
    ("t.cpu()", "H14", True),
    ("t.to('cpu')", "H14", True),
    ("t.numpy()", "H14", True),
    ("float(t)", "H14", True),
    ("int(t)", "H14", True),
    ("bool(t)", "H14", True),
    ("if t: out.append(1)", "H14", True),
    ("np.asarray(t)", "H14", True),
    ("len(t)", "H14", False),
    ("for r in t: out.append(r)", "H14", False),
    ("torch.cuda.synchronize()", "H1", True),
    ("stream.synchronize()", "H1", True),
    ("event.synchronize()", "H1", True),
    ("np.asarray(torch.mm(t[None], t[None].T))", "H1", True),
)
#: the sanctioned drain (obs/trace.py::timed_device_get over an event
#: wait on a non-blocking copy into pinned memory)
LINT_DRAIN = ("pinned.copy_(t, non_blocking=True); event.record(); "
              "timed_device_get(event.synchronize)")
LINT_FIXTURE = (
    "import numpy as np\n"
    "import torch\n"
    "from sparkdl_tpu_torch.obs.trace import timed_device_get\n"
    "from sparkdl_tpu_torch.obs.watchdog import watch as watchdog_watch\n"
    "def loop(xs, out, stream, event, pinned):\n"
    "    with watchdog_watch('lint'):\n"
    "        t = torch.as_tensor(xs, device='cuda')\n"
    "        {}\n")


def lint_analyzer(repo):
    """``python3 -m sparkdl_tpu_torch.analysis --json`` with its default
    targets, cold then warm on a fresh cache file: (seconds, JSON) of
    each run."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, SPARKDL_TPU_TORCH_LINT_CACHE=os.path.join(
            tmp, "lint_cache.json"))
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "sparkdl_tpu_torch.analysis",
                 "--json"], cwd=repo, env=env, capture_output=True,
                text=True, timeout=300)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(
                    f"lint: the analyzer exited {proc.returncode}: "
                    f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            runs.append((seconds, json.loads(proc.stdout)))
    return runs


def lint_sync_table(torch, np):
    """Each form of :data:`LINT_FORMS` and the drain: whether the
    analyzer flags it (unsuppressed, its rule) and what the armed guard
    does with it on the card."""
    from sparkdl_tpu_torch.analysis import analyze_source
    from sparkdl_tpu_torch.obs.trace import timed_device_get
    from sparkdl_tpu_torch.runtime import sanitize

    t = torch.ones(1, device="cuda")
    scope = {"t": t, "torch": torch, "np": np, "out": [],
             "stream": torch.cuda.Stream(), "event": torch.cuda.Event(),
             "pinned": torch.empty(1, pin_memory=True),
             "timed_device_get": timed_device_get}
    scope["event"].record()
    forms = list(LINT_FORMS) + [(LINT_DRAIN, "drain", False)]
    ops = {stmt: (lambda stmt=stmt: exec(stmt, dict(scope)))
           for stmt, _, _ in forms}
    with runner_env(sanitize=1):
        with sanitize.ship_guard(torch.device("cuda")) as armed:
            trips = sync_trips(torch, np, ops)
    torch.cuda.synchronize()
    rows = []
    for stmt, rule, expect in forms:
        found = [f for f in analyze_source(
            LINT_FIXTURE.format(stmt), "sparkdl_tpu_torch/lint_form.py")
            if not f.suppressed]
        hits = [f for f in found if f.rule == rule] if rule != "drain" \
            else found
        rows.append({"form": stmt, "rule": rule, "flagged": bool(hits),
                     "expected": expect,
                     "guard": trips[stmt] or "ran",
                     "message": hits[0].message[:120] if hits else ""})
    return armed, rows


def lint_nan_stop(torch, np, smi_line):
    """C6: a TestNet whose output rows turn NaN where the input's first
    byte is 255, one marked row in 4 chunks of 16, through the runner on
    the card: under ``SPARKDL_TPU_SANITIZE=1`` and
    ``SPARKDL_TPU_SANITIZE_NANS=1`` it raises naming the chunk; under the
    first flag alone the output is bit for bit the unguarded run's."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.runtime.runner import BatchRunner

    testnet = zoo.getModelFunction("TestNet")
    (name,) = testnet.output_names

    class NanRows(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = testnet.module

        def forward(self, inputs):
            y = self.inner(inputs)[name]
            bad = inputs["image"].reshape(y.shape[0], -1)[:, 0] == 255
            return {name: torch.where(bad[:, None],
                                      torch.full_like(y, float("nan")), y)}

    mf = ModelFunction(NanRows(), testnet.input_signature, [name])
    x = np.random.default_rng(6).integers(0, 255, (64, 32, 32, 3),
                                          dtype=np.uint8)
    x[37, 0, 0, 0] = 255          # chunk 2: rows 32..47

    def run():
        return BatchRunner(mf, 16).run({"image": x})[name]

    plain = run()
    with runner_env(sanitize=1):
        guarded = run()
    with runner_env(sanitize=1, sanitize_nans=1):
        try:
            run()
            stopped = None
        except FloatingPointError as e:
            stopped = str(e)
    nan_rows = np.flatnonzero(np.isnan(plain).any(axis=1)).tolist()
    same = plain.tobytes() == guarded.tobytes()
    emit("lint_nan_stop", nan_rows=nan_rows, stopped=stopped,
         guarded_bit_equal=same, card=smi_line)
    if nan_rows != [37] or not same or not stopped or \
            "chunk 2 (rows 32..47" not in stopped:
        raise AssertionError(f"lint NaN stop: NaN rows {nan_rows}, raised "
                             f"{stopped!r}, guarded bit-equal {same}")


def lint_ring_keys(torch, np, smi_line, frame):
    """C5: one runner with ``infeed_ring=2`` runs the featurize function
    (K1) twice over the same two chunks of 64 rows; the registry's ring
    and in-flight keys must agree with its ``ShipStats``. Returns K1's
    launches."""
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.obs import default_registry
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"), (512, 512))
    rows = {mf.input_names[0]: frame[0][:2 * BATCH]}
    reg = default_registry()
    keys = ("ship.ring_hits", "ship.ring_misses", "ship.ring_donations",
            "ship.bytes_resident", "ship.bytes_reshipped")
    reg.gauge("ship.inflight_peak").set(0)
    runner = BatchRunner(mf, BATCH, infeed_ring=2)
    infeed.launches = infeed.yuv420_launches = 0
    passes = []
    for _ in range(2):
        before = {k: reg.counter(k).value for k in keys}
        stats = dict(vars(runner.ship_stats))
        out = runner.run(rows)
        passes.append({
            "registry": {k: reg.counter(k).value - before[k] for k in keys},
            "ship_stats": {k: v - stats[k]
                           for k, v in vars(runner.ship_stats).items()},
            "finite": bool(np.isfinite(out["features"]).all())})
    launches = infeed.launches
    peak = reg.gauge("ship.inflight_peak").value
    depth = reg.gauge("ship.inflight").value
    nbytes = int(rows[mf.input_names[0]].nbytes)
    emit("lint_ring_keys", passes=passes, inflight=depth,
         inflight_peak=peak, chunk_bytes=nbytes // 2,
         launches={KERNEL: launches}, card=smi_line)
    second = passes[1]
    agree = all(
        p["registry"]["ship.ring_hits"] == p["ship_stats"]["hits"]
        and p["registry"]["ship.ring_misses"] == p["ship_stats"]["misses"]
        and p["registry"]["ship.bytes_resident"]
        == p["ship_stats"]["resident_bytes"]
        and p["registry"]["ship.bytes_reshipped"]
        == p["ship_stats"]["reshipped_bytes"]
        and p["registry"]["ship.ring_donations"]
        == p["ship_stats"]["donated"] for p in passes)
    if not (agree and second["registry"]["ship.ring_hits"] == 2
            and second["registry"]["ship.bytes_resident"] == nbytes
            and all(p["registry"]["ship.bytes_reshipped"] == 0
                    for p in passes)
            and peak >= 1 and depth == 0 and launches == 4
            and all(p["finite"] for p in passes)):
        raise AssertionError(f"lint ring keys: {passes}, in flight {depth}, "
                             f"peak {peak}, K1 {launches}")
    return launches


def lint_phase(torch, np, smi_line, frame, repo):
    """The port's static analysis on the card's machine (module
    docstring, phase 22: ``lint``). Returns K1's launches over the
    phase."""
    t_phase = time.perf_counter()
    (cold_s, cold), (warm_s, warm) = lint_analyzer(repo)
    suppressed = {rule: v["suppressed"]
                  for rule, v in sorted(cold["by_rule"].items())}
    emit("lint_analyzer", cold_s=cold_s, warm_s=warm_s,
         cold_total_s=cold["timing"]["total_s"],
         warm_total_s=warm["timing"]["total_s"],
         unsuppressed=[cold["unsuppressed"], warm["unsuppressed"]],
         suppressed_by_rule=suppressed, targets=cold["targets"],
         cache_warm=warm["cache"], python=sys.version.split()[0])
    if cold["unsuppressed"] or warm["unsuppressed"] or \
            warm["cache"]["misses"] or not warm["cache"]["hits"]:
        raise AssertionError(f"lint: unsuppressed {cold['unsuppressed']}/"
                             f"{warm['unsuppressed']}, warm cache "
                             f"{warm['cache']}")
    armed, rows = lint_sync_table(torch, np)
    emit("lint_sync_table", guard_armed=armed,
         rows=[[r["form"], r["rule"], r["flagged"], r["guard"]]
               for r in rows], card=smi_line)
    wrong = [r for r in rows if r["flagged"] != r["expected"]
             or (r["rule"] == "H14" and r["expected"] and r["guard"] == "ran")
             or (not r["expected"] and r["guard"] != "ran")
             or (r["guard"] == "TypeError" and r["rule"] == "H14"
                 and "raises on a CUDA tensor" not in r["message"])]
    if not armed or wrong:
        raise AssertionError(f"lint sync table: armed {armed}, wrong {wrong}")
    lint_nan_stop(torch, np, smi_line)
    launches = lint_ring_keys(torch, np, smi_line, frame)
    seconds = time.perf_counter() - t_phase
    emit("lint_phases", seconds=seconds, launches={KERNEL: launches},
         card=smi_line)
    if seconds >= 60.0:
        raise AssertionError(f"lint phase took {seconds:.1f} s")
    return launches


def conv_flops(torch, module, inputs):
    """2·MACs of ``module(inputs)``'s convolutions and matrix products,
    from each op's weight and output shapes, under ``FakeTensorMode``:
    the analytic count the compile log's ``FlopCounterMode`` is held
    to."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.convolution.default:
                w = args[1]     # [Cout, Cin / groups, kh, kw]
                self.flops += 2 * out.numel() * int(w[0].numel())
            elif func in (aten.mm.default, aten.addmm.default):
                a = args[-2]
                self.flops += 2 * out.numel() * int(a.shape[-1])
            return out

    with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
            torch.no_grad():
        fake = {k: mode.from_tensor(v) for k, v in inputs.items()}
        with Products() as counter:
            module(fake)
    return counter.flops


def forensics_phase(torch, np, smi_line, frame, head, featurize_ref,
                    model_graph_ms, repo):
    """Measurement on the card (module docstring, phase 23:
    ``forensics``). Returns K1's and K2's launches over the phase."""
    from sparkdl_tpu_torch import DeepImageFeaturizer
    from sparkdl_tpu_torch.fleet.placement import (
        _signature_bytes,
        estimate_footprint,
    )
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.obs import flight
    from sparkdl_tpu_torch.obs.compile_log import compile_log
    from sparkdl_tpu_torch.obs.export import start_telemetry
    from sparkdl_tpu_torch.obs.ledger import ledger, probe_ceilings
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.runtime.runner import BatchRunner, warmup_runner
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    from sparkdl_tpu_torch.utils import profiling
    from sparkdl_tpu_torch.utils.measure import measure_device_resident

    imgs, rows, df, _ = frame
    head_df, head_mf, head_feats = head
    t_phase = time.perf_counter()
    clog, led = compile_log(), ledger()
    saved = (clog._override, led._override, led.window_s, led.probe_file)
    # the card's link ceilings, probed deliberately (a tick never probes)
    led.probe_file = os.path.join(repo, "sparkdl_tpu_torch", "_build",
                                  "ledger_probe.json")
    t0 = time.perf_counter()
    ceilings = probe_ceilings(path=led.probe_file, force=True)
    probe_s = time.perf_counter() - t0
    if "error" in ceilings:
        raise AssertionError(f"the link probe failed: {ceilings}")
    led.ensure_ceilings(ceilings)
    clog.clear()
    clog.arm()
    led.arm()
    led.window_s = FORENSICS_WINDOW_S
    # the counted run: the counts are 0 just before, read just after
    infeed.launches = infeed.yuv420_launches = 0
    try:
        led.baseline()
        # the featurize pass (K1) and the headline pass (K2)
        featurizer = DeepImageFeaturizer(
            modelName="InceptionV3", inputCol="image",
            outputCol="features", deviceResizeFrom=(512, 512),
            batchSize=BATCH)
        t0 = time.perf_counter()
        planned = featurizer.transform(df)
        feats = np.asarray(planned.collect()["features"])
        torch.cuda.synchronize()
        featurize_s = time.perf_counter() - t0
        k1_pass = infeed.launches
        if k1_pass != N_IMAGES // BATCH or rel_diff(
                feats, featurize_ref) > BOUND_FEATURES_REL:
            raise AssertionError(f"forensics featurize pass: K1 {k1_pass}")
        t0 = time.perf_counter()
        head_out = np.asarray(headline_transformer(head_mf).transform(
            head_df).collect()["features"])
        torch.cuda.synchronize()
        headline_s = time.perf_counter() - t0
        k2_pass = infeed.yuv420_launches
        if k2_pass != N_IMAGES // BATCH or not np.array_equal(
                head_out, head_feats):
            raise AssertionError(f"forensics headline pass: K2 {k2_pass}, "
                                 "features differ from the headline's")
        pass_events = clog.events()
        pass_windows = led.history()

        # InceptionV3's recorded FLOPs against the analytic count
        analytic = conv_flops(torch, head_mf.module, {
            "image": torch.zeros((BATCH, head_df.schema["image"].shape[1]),
                                 dtype=torch.uint8, device="cuda")})
        # the featurizer's function is new: its first call is an event;
        # the headline's ran before the log was armed (the earlier
        # phases), so it is warm — no event — and its FLOPs are the
        # count for the shape it runs
        first_calls = [e for e in pass_events if e.kind == "first_call"]
        flops = {"featurize": next(
            (e.cost["flops"] for e in first_calls if e.cost and e.signature
             == {"inputs.image": f"uint8[{BATCH},512,512,3]"}), None),
            "headline": head_mf.last_flops()}
        flops_rel = {k: abs((v or 0) - analytic) / analytic
                     for k, v in flops.items()}
        if len(first_calls) != 1 or \
                max(flops_rel.values()) > FORENSICS_FLOPS_REL:
            raise AssertionError(f"recorded FLOPs {flops} against the "
                                 f"analytic {analytic}")

        # the steady contract: warmed, then the warm shape, then one
        # off-shape batch
        feat_mf = deviceResizeModel(
            zoo.getModelFunction("InceptionV3", featurize=True), (512, 512))
        signature_ws = 2 * (
            _signature_bytes(feat_mf.input_signature, BATCH)
            + _signature_bytes(feat_mf.output_signature(), BATCH))
        runner = BatchRunner(feat_mf, batch_size=BATCH)
        if not warmup_runner(runner):
            raise AssertionError("warmup_runner did not warm")
        # the footprint's first-call rung: the warm-up's event at 64
        fp = estimate_footprint(feat_mf, BATCH)
        if fp.detail["source"] != "memory_analysis":
            raise AssertionError(f"footprint {fp.detail}")
        events0, unexpected0 = clog.events_total, clog.unexpected_retraces
        runner.run({"image": imgs[:2 * BATCH]})
        warm_events = clog.events_total - events0
        warm_unexpected = clog.unexpected_retraces - unexpected0
        runner.batch_size = FORENSICS_OFF_BATCH
        runner.run({"image": imgs[:FORENSICS_OFF_BATCH]})
        off_unexpected = clog.unexpected_retraces - unexpected0
        off = clog.events()[-1]
        want_diff = (f"inputs.image: uint8[{BATCH},512,512,3] -> "
                     f"uint8[{FORENSICS_OFF_BATCH},512,512,3]")
        if (warm_events, warm_unexpected, off_unexpected) != (0, 0, 1) \
                or not off.unexpected or off.diff != want_diff:
            raise AssertionError(
                f"steady contract: warm events {warm_events}, unexpected "
                f"{warm_unexpected} then {off_unexpected}: {off}")

        # one batch's peak measured directly, for the footprint
        x = torch.from_numpy(imgs[:BATCH]).cuda()
        feat_mf.apply({"image": x})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feat_mf.apply({"image": x})
        torch.cuda.synchronize()
        measured = int(x.nbytes) + torch.cuda.max_memory_allocated() - base
        del x

        # the model alone with its input on the card, and the same
        # with the compile log disarmed and armed in turns (its cost)
        resident = measure_device_resident(feat_mf, BATCH, 8)
        turns = []
        for armed in (False, True, True, False):
            clog.arm() if armed else clog.disarm()
            turns.append(("armed" if armed else "disarmed",
                          measure_device_resident(feat_mf, BATCH, 8)[
                              "batch_ms"]))
        clog.arm()

        # the device's busy share over one warm featurize pass
        trace_dir = os.path.join(repo, "sparkdl_tpu_torch", "_build",
                                 "forensics_trace")
        with profiling.trace(trace_dir) as prof:
            t0 = time.perf_counter()
            planned.collect()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        busy = profiling.device_busy(prof, traced_s, top=FORENSICS_TOP_OPS)
        if not busy["device_events"]:
            raise AssertionError("the profile holds no device time")

        # the ledger's windows over the passes, and the live surfaces
        led.tick()
        windows = led.history()
        if not pass_windows:
            raise AssertionError("the ledger closed no window during the "
                                 "passes")
        tel = start_telemetry()
        try:
            metrics_code, metrics = http_get(tel.url("/metricsz"))
            status_code, status = http_get(tel.url("/statusz"))
            health_code, health = http_get(tel.url("/healthz"))
        finally:
            tel.close()
        status, health = json.loads(status), json.loads(health)
        bundle = flight.recorder().bundle(reason="forensics")
        surfaces = {
            "metricsz_ledger": "sparkdl_ledger_util_compute" in metrics,
            "metricsz_hbm": "sparkdl_hbm_d0_bytes_in_use" in metrics,
            "statusz_ledger_ok": "error" not in status["ledger"],
            "statusz_compile_ok": "error" not in status["compile"],
            "bundle_ledger_ok": "error" not in bundle["ledger"],
            "bundle_compile_ok": "error" not in bundle["compile"],
            "healthz_unexpected_retraces": health["unexpected_retraces"],
            "codes": [metrics_code, status_code, health_code]}
        if not (all(v for k, v in surfaces.items()
                    if k.endswith(("_ok", "_ledger", "_hbm")))
                and health["unexpected_retraces"] == 1
                and surfaces["codes"] == [200, 200, 200]):
            raise AssertionError(f"forensics surfaces {surfaces}")
        launches = infeed.launches, infeed.yuv420_launches
        events = clog.events()
    finally:
        clog._override, led._override, led.window_s, led.probe_file = saved
        clog.clear()
    kinds = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    emit("forensics", card=smi_line, batch=BATCH,
         link_ceilings={k: ceilings[k] for k in ("link_h2d_MBps",
                                                 "link_d2h_MBps")},
         probe_s=probe_s, featurize_s=featurize_s, headline_s=headline_s,
         pass_launches={KERNEL: k1_pass, KERNEL_YUV420: k2_pass},
         compile_events=[{
             "name": e.name, "kind": e.kind, "wall_s": round(e.wall_s, 4),
             "signature": e.signature, "flops": (e.cost or {}).get("flops"),
             "uncounted_ops": (e.cost or {}).get("uncounted_ops"),
             "memory": e.memory, "retrace": e.retrace,
             "unexpected": e.unexpected, "diff": e.diff}
             for e in events],
         events_by_kind=kinds, flops_analytic=analytic,
         flops_recorded=flops, flops_rel_diff=flops_rel,
         steady={"warm_events": warm_events,
                 "warm_unexpected_retraces": warm_unexpected,
                 "off_shape_unexpected_retraces": off_unexpected,
                 "diff": off.diff, "off_shape_first_call_s": off.wall_s},
         ledger={"windows": len(windows), "during_passes": [{
             k: w[k] for k in ("dt_s", "util", "bound_by", "headroom_pct",
                               "link_basis", "compute_basis", "ship_MBps")}
             for w in pass_windows]},
         surfaces=surfaces,
         device_resident=resident, device_resident_turns_ms=turns,
         runner_split_model_graph_ms=model_graph_ms,
         profile={**busy, "trace": os.path.relpath(
             os.path.join(trace_dir, "trace.json"), repo)},
         footprint={"first_call_workspace_bytes":
                    fp.detail["workspace_bytes"],
                    "measured_batch_bytes": measured,
                    "signature_workspace_bytes": signature_ws,
                    "params_bytes": fp.detail["params_bytes"]},
         launches={KERNEL: launches[0], KERNEL_YUV420: launches[1]},
         seconds=time.perf_counter() - t_phase)
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


def autotune_degrade_drill(batch):
    """A host stage run in a pool worker: raises one degrade warning
    through the pipeline's ``_warn_once`` (a telemetry-armed worker ships
    it to the parent instead of logging it) and returns the batch."""
    from sparkdl_tpu_torch.data import pipeline
    pipeline._warn_once("autotune-drill",
                        "autotune drill: a degrade raised in worker pid %d",
                        os.getpid())
    return batch


class LinesWith(logging.Handler):
    """A logging handler keeping the records whose text holds ``needle``."""

    def __init__(self, needle):
        super().__init__()
        self.needle = needle
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if self.needle in msg:
            self.lines.append(msg)


def autotune_decisions(trc, since):
    """The controller's applied decisions since ``since`` (a span count),
    from the ``autotune.apply`` spans: (target, knob, from, to, reason)."""
    out = []
    for r in trc.spans()[since:]:
        if r.name == "autotune.apply":
            a = r.attrs
            out.append([a["target"], a["knob"], a["frm"], a["to"],
                        a["reason"]])
    return out


def autotune_fleet_part(registry, requests):
    """Every request through the fleet's front door at once; the answers
    in request order."""
    futures = [registry.submit({"image": r}, model="head") for r in requests]
    return [f.result(WAIT_S)["features"] for f in futures]


def autotune_phase(torch, np, smi_line, frame, head, repo):
    """The closed loop and the worker plane on the card (module docstring,
    phase 25: ``autotune``). Returns K1's and K2's launches over the
    phase."""
    from sparkdl_tpu_torch.autotune import (
        FleetTarget,
        PipelineTarget,
        Proposal,
        RechunkTarget,
        RunnerTarget,
        ServeTarget,
        controller,
        poll,
    )
    from sparkdl_tpu_torch.data.engine import LocalEngine
    from sparkdl_tpu_torch.data.pipeline import PipelineWorkerError
    from sparkdl_tpu_torch.fleet import ModelRegistry
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.obs import default_registry, flight, remote
    from sparkdl_tpu_torch.obs.compile_log import compile_log
    from sparkdl_tpu_torch.obs.export import start_telemetry
    from sparkdl_tpu_torch.obs.ledger import ledger
    from sparkdl_tpu_torch.obs.trace import tracer
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.resilience import faults
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import ModelServer, ServeConfig
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    t_phase = time.perf_counter()
    imgs = frame[0]
    head_df, head_mf, _ = head
    packed = np.asarray(head_df.collect()["image"])
    reg = default_registry()
    ctl, clog, led, trc = controller(), compile_log(), ledger(), tracer()
    saved = (clog._override, led._override, led.window_s)
    out = {}

    # 7. the disarmed poll: one armed check
    ctl.reset()
    if ctl.armed:
        raise AssertionError("the controller is armed before the phase")
    per_call = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(AUTOTUNE_POLLS):
            poll()
        per_call.append((time.perf_counter() - t0) / AUTOTUNE_POLLS)
    out["disarmed_poll_us"] = {"median": median(per_call) * 1e6,
                               "runs": [v * 1e6 for v in per_call],
                               "calls_a_run": AUTOTUNE_POLLS}
    if ctl.steps:
        raise AssertionError("a disarmed poll stepped the controller")

    # the counted run: the counts are 0 just before, read at the end
    infeed.launches = infeed.yuv420_launches = 0
    clog.arm()
    ctl.arm(interval_s=0.0)
    trc.arm()
    trc.clear()
    remote.aggregator().clear()
    server = fleet_server = None
    try:
        # 6a. the fleet with no fresh ledger window: it never scales
        fleet_server = ModelServer(ServeConfig(
            max_wait_s=AUTOTUNE_SERVE_WAIT_S,
            max_queue_rows=AUTOTUNE_QUEUE_ROWS))
        fleet = ModelRegistry(fleet_server)
        fleet.deploy("head", head_mf, batch_size=BATCH, replicas=1)
        fleet_target = ctl.attach(FleetTarget(fleet, "head",
                                              max_replicas=2))
        led.window_s = AUTOTUNE_WINDOW_S
        prior_before = fleet_target.describe()["ledger_prior"]
        reqs = [packed[(i % 8) * BATCH:(i % 8 + 1) * BATCH]
                for i in range(AUTOTUNE_FLEET_REQUESTS)]
        fleet_before = autotune_fleet_part(fleet, reqs)
        replicas_a = len(fleet.entry("head").replicas)
        if prior_before is not None or replicas_a != 1:
            raise AssertionError(f"fleet without a fresh window: prior "
                                 f"{prior_before}, {replicas_a} replicas")

        # 1. the ladder on the K2 headline runner
        t0 = time.perf_counter()
        runner = BatchRunner(head_mf, batch_size=BATCH)
        ladder = RechunkTarget(runner, ladder=AUTOTUNE_LADDER,
                               name="ladder")
        warmed = []
        ladder.on_attach = lambda: warmed.append(
            RechunkTarget.prewarm(ladder))
        seen = set()
        hook = head_mf.module.register_forward_pre_hook(
            lambda m, args: seen.update(
                int(v.shape[0]) for v in args[0].values()))
        k2_0 = infeed.yuv420_launches
        ctl.attach(ladder)           # arm-then-attach: prewarm runs here
        prewarm = {"rungs": warmed, "launches":
                   infeed.yuv420_launches - k2_0,
                   "steady": all(c.steady
                                 for c in head_mf._calls.values()),
                   "steady_models": reg.gauge(
                       "compile.steady_models").value}
        if warmed != [len(AUTOTUNE_LADDER)] or \
                prewarm["launches"] != len(AUTOTUNE_LADDER) or \
                not prewarm["steady"]:
            raise AssertionError(f"ladder prewarm {prewarm}")
        runs = []        # (rung, rows' first index, n, features)

        def ladder_run(lo, n):
            rung = runner.batch_size
            k2 = infeed.yuv420_launches
            got = runner.run({"image": packed[lo:lo + n]})["features"]
            runs.append((rung, lo, n, got, infeed.yuv420_launches - k2))

        # partitions of 20 rows: fill 20/64 under down_fill
        for i in range(AUTOTUNE_SMALL_RUNS):
            ladder_run(i * AUTOTUNE_SMALL_ROWS, AUTOTUNE_SMALL_ROWS)
        small = [(r, k) for r, _lo, _n, _g, k in runs]
        down = [r for r, _k in small]
        if AUTOTUNE_LADDER[0] not in down[1:] or down[0] != BATCH \
                or any(k < 1 for _r, k in small):
            raise AssertionError(f"small partitions: rungs {down}, K2 "
                                 f"{[k for _r, k in small]}")
        # partitions whose rows are a multiple of 128: the ladder may
        # move, no move records an unexpected retrace
        unexpected0 = clog.unexpected_retraces
        full0 = len(runs)
        for i in range(AUTOTUNE_FULL_RUNS):
            ladder_run((i % 4) * AUTOTUNE_FULL_ROWS, AUTOTUNE_FULL_ROWS)
        full_unexpected = clog.unexpected_retraces - unexpected0
        full_rungs = [r for r, *_ in runs[full0:]]
        if full_unexpected:
            raise AssertionError(f"full partitions at rungs {full_rungs}: "
                                 f"{full_unexpected} unexpected retraces")
        # one ragged run: its unexpected retraces are the new shapes the
        # model saw (none where the runner pads the tail to the rung)
        seen.clear()
        unexpected0 = clog.unexpected_retraces
        ragged_rung = runner.batch_size
        ladder_run(0, AUTOTUNE_RAGGED_ROWS)
        ragged_unexpected = clog.unexpected_retraces - unexpected0
        new_shapes = sorted(seen - set(AUTOTUNE_LADDER))
        hook.remove()
        if ragged_unexpected != len(new_shapes):
            raise AssertionError(
                f"ragged run: {ragged_unexpected} unexpected retraces "
                f"for the new shapes {new_shapes}")
        ctl.detach(ladder)
        ladder_s = time.perf_counter() - t0

        # 3. RunnerTarget on the K1 featurize runner, prefetch strategy
        t0 = time.perf_counter()
        feat_mf = deviceResizeModel(
            zoo.getModelFunction("InceptionV3", featurize=True), (512, 512))
        frunner = BatchRunner(feat_mf, batch_size=BATCH,
                              strategy="prefetch", prefetch_depth=2)
        pressure = [False]
        rt = ctl.attach(RunnerTarget(frunner, name="featurize",
                                     memory_pressure=lambda: pressure[0]))
        x = imgs[:AUTOTUNE_FULL_ROWS]
        k1_0 = infeed.launches
        frunner.run({"image": x})                     # baseline window
        pressure[0] = True
        frunner.run({"image": x})                     # one pressed window
        pressure[0] = False
        shed = frunner.prefetch_depth
        if shed != 1:
            raise AssertionError(f"memory pressure left prefetch_depth "
                                 f"{shed} (from 2)")
        # a trial that cannot pay: every drain share starts one, and a
        # gain of min_gain = 10 (1000%) is out of reach
        rt.raise_wait_frac, rt.min_gain = 0.0, 10.0
        inflight0 = frunner.max_inflight
        frunner.run({"image": x})                     # trial starts
        trial_to = frunner.max_inflight
        frunner.run({"image": x})                     # judged: revert
        del rt.raise_wait_frac, rt.min_gain
        if trial_to != inflight0 + 1 or frunner.max_inflight != inflight0 \
                or rt._inflight.frozen_for <= 0:
            raise AssertionError(
                f"unpaid trial: max_inflight {inflight0} -> {trial_to} -> "
                f"{frunner.max_inflight}, frozen {rt._inflight.frozen_for}")
        # a forced quick flip of prefetch_depth (last moved down within
        # the oscillation window): refused and counted
        osc0 = ctl.oscillations
        depth = frunner.prefetch_depth
        flipped = ctl._apply(rt, Proposal(rt._depth, depth + 1,
                                          "forced quick flip"))
        if flipped or frunner.prefetch_depth != depth or \
                ctl.oscillations != osc0 + 1:
            raise AssertionError(f"quick flip: moved {flipped}, depth "
                                 f"{frunner.prefetch_depth}, oscillations "
                                 f"{ctl.oscillations - osc0}")
        k1_runner = infeed.launches - k1_0
        ctl.detach(rt)
        out["runner"] = {"seconds": time.perf_counter() - t0,
                         "prefetch_depth_after_pressure": shed,
                         "trial": [inflight0, trial_to,
                                   frunner.max_inflight],
                         "trial_min_gain": 10.0,
                         "oscillations": ctl.oscillations - osc0,
                         "describe": rt.describe(), "k1_launches": k1_runner}

        # 4. ServeTarget on a serve session over the K2 headline
        t0 = time.perf_counter()
        server = ModelServer(ServeConfig(
            max_wait_s=AUTOTUNE_SERVE_WAIT_S,
            max_queue_rows=AUTOTUNE_QUEUE_ROWS))
        session = server.register("autotune", head_mf, batch_size=BATCH)
        server.warmup()
        st = ctl.attach(ServeTarget(
            session, name="serve", min_wait_s=AUTOTUNE_SERVE_MIN_WAIT_S,
            latency_budget_s=AUTOTUNE_LATENCY_BUDGET_S))
        m = session.metrics

        def window(requests, one_by_one):
            b0, r0, c0 = m.batches, m.batch_rows, m.batch_capacity_rows
            lat, answers = [], []
            if one_by_one:
                for r in requests:
                    t = time.perf_counter()
                    answers.append(server.submit(
                        {"image": r}, model="autotune").result(WAIT_S))
                    lat.append(time.perf_counter() - t)
            else:
                t = time.perf_counter()
                futures = [server.submit({"image": r}, model="autotune")
                           for r in requests]
                for f in futures:
                    answers.append(f.result(WAIT_S))
                    lat.append(time.perf_counter() - t)
            fill = (m.batch_rows - r0) / max(1, m.batch_capacity_rows - c0)
            return answers, {"batches": m.batches - b0, "fill": fill,
                             "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                             "max_wait_s": session.max_wait_s}

        wait0 = session.max_wait_s
        burst = [packed[(i % 8) * BATCH:(i % 8 + 1) * BATCH]
                 for i in range(AUTOTUNE_SERVE_BURST)]
        burst_ans, burst_w = window(burst, False)
        trickle = [packed[i * AUTOTUNE_TRICKLE_ROWS:
                          (i + 1) * AUTOTUNE_TRICKLE_ROWS]
                   for i in range(AUTOTUNE_SERVE_TRICKLE)]
        trickle_ans, trickle_w = window(trickle, True)
        p99 = m.latency_seconds(0.99)
        if not burst_w["max_wait_s"] < wait0 or \
                not trickle_w["max_wait_s"] > burst_w["max_wait_s"] or \
                p99 > AUTOTUNE_LATENCY_BUDGET_S:
            raise AssertionError(f"serve window {wait0} -> burst "
                                 f"{burst_w} -> trickle {trickle_w}, p99 "
                                 f"{p99}")
        ctl.detach(st)
        server.close()
        server = None
        out["serve"] = {"seconds": time.perf_counter() - t0,
                        "max_wait_s_start": wait0, "burst": burst_w,
                        "trickle": trickle_w,
                        "session_p99_ms": p99 * 1e3,
                        "latency_budget_s": AUTOTUNE_LATENCY_BUDGET_S}

        # 5. PipelineTarget and the worker plane: two pooled workers
        # over the 4:2:0 headline, the ledger armed
        t0 = time.perf_counter()
        led.ensure_ceilings()       # the forensics phase's probe
        led.arm()
        led.baseline()

        def pooled(engine):
            return headline_transformer(head_mf).transform(
                pipe_frame(engine, AUTOTUNE_PIPE_PARTS).map_batches(
                    autotune_degrade_drill, name="degradeDrill"))

        serial = pooled(LocalEngine()).collect()
        engine = LocalEngine(pipeline_workers=2, pipeline_mode="process")
        pt = ctl.attach(PipelineTarget(engine, name="pipeline",
                                       max_workers=4))
        # the rates the target's windows read (None: no rate)
        windows = []
        read_window = pt._window
        pt._window = lambda: windows.append(read_window()) or windows[-1]
        drill = LinesWith("autotune drill")
        remote_log = logging.getLogger("sparkdl_tpu_torch.obs.remote")
        remote_log.addHandler(drill)
        before = counter_values()
        walls, passes = [], []
        try:
            for _ in range(2):
                w0 = time.perf_counter()
                passes.append(pooled(engine).collect())
                torch.cuda.synchronize()
                walls.append((w0, time.perf_counter()))
                # the stream's active seconds are counted when it ends,
                # after the device stage's last poll: one more step
                # reads them
                ctl.step()
        finally:
            remote_log.removeHandler(drill)
            del pt._window
        after = counter_values()
        for i, o in enumerate(passes):
            same_rows(np, o, serial, f"autotune pooled pass {i}")
        delta = {k: v - before.get(k, 0.0) for k, v in after.items()
                 if k.startswith("worker.") and v != before.get(k, 0.0)}
        delta_p = {k: after.get(k, 0.0) - before.get(k, 0.0)
                   for k in ("pipeline.rows", "pipeline.stream_seconds")}
        rollup_bad = {}
        for k, v in delta.items():
            if not k.startswith("worker.all."):
                continue
            name = k[len("worker.all."):]
            parts = sum(d for kk, d in delta.items()
                        if kk.split(".", 2)[1].isdigit()
                        and kk.split(".", 2)[2] == name)
            # float counters are summed in another order: 1e-9 relative
            if abs(parts - v) > 1e-9 * max(1.0, abs(v)):
                rollup_bad[name] = (v, parts)
        status = remote.aggregator().workers_status()
        degrades = {f"worker.{s['index']}": delta.get(
            f"worker.{s['index']}.degrade_events", 0.0) for s in status}
        trace_path = os.path.join(repo, "sparkdl_tpu_torch", "_build",
                                  "autotune_trace.json")
        trc.export(trace_path)
        with open(trace_path) as f:
            events = json.load(f)
        base = remote.WORKER_PID_BASE
        tracks = sorted({e["pid"] for e in events if e.get("ph") == "X"
                         and e["pid"] >= base})
        lo = (walls[0][0] - trc._epoch) * 1e6
        hi = (walls[-1][1] - trc._epoch) * 1e6
        wspans = [e for e in events if e.get("ph") == "X"
                  and e["pid"] >= base]
        margin_us = min([min(e["ts"] - lo, hi - e["ts"] - e["dur"])
                         for e in wspans] or [float("nan")])
        if rollup_bad or len(status) != 2 or tracks != [base, base + 1] \
                or not margin_us >= 0 or len(drill.lines) != 1 \
                or not all(v >= 1 for v in degrades.values()):
            raise AssertionError(
                f"worker plane: rollups {rollup_bad}, workers "
                f"{len(status)}, tracks {tracks}, span margin {margin_us} "
                f"µs, drill lines {drill.lines}, degrades {degrades}")
        pipeline_describe = pt.describe()
        ctl.detach(pt)

        # a fault injected into a worker of the same pool (the
        # worker-death drill, shipped in the telemetry config) reaches
        # /healthz and workers[]
        died = None
        try:
            faults.inject("pipeline.worker_death", "transient", 1.0)
            try:
                pipe_frame(engine, 1).collect()
            except PipelineWorkerError as e:
                died = repr(e)
        finally:
            faults.disarm("pipeline.worker_death")
            engine.shutdown()
        tel = start_telemetry()
        try:
            health = json.loads(http_get(tel.url("/healthz"))[1])
        finally:
            tel.close()
        bundle = flight.recorder().bundle(reason="autotune worker drill")
        dead_rows = [w for w in bundle["workers"] if w.get("dead")]
        if died is None or not health["worker_dead"] or not dead_rows:
            raise AssertionError(f"worker death: raised {died}, /healthz "
                                 f"{health}, dead rows {dead_rows}")
        out["pipeline"] = {
            "seconds": time.perf_counter() - t0,
            "walls_s": [b - a for a, b in walls],
            "workers": [{k: s[k] for k in ("index", "pid", "frames",
                                            "spans_retained")}
                        for s in status],
            "worker_tracks": tracks, "worker_spans": len(wspans),
            "span_margin_us": margin_us,
            "rollup_counters": sorted(k for k in delta
                                      if k.startswith("worker.all.")),
            "degrade_events": degrades, "degrade_log_lines": drill.lines,
            "death": {"raised": died,
                      "healthz_worker_dead": health["worker_dead"],
                      "bundle_dead": [[w["index"], w["death_reason"]]
                                      for w in dead_rows]},
            "target": pipeline_describe,
            "target_windows_rows_per_s": windows,
            "rows_and_stream_seconds": [
                delta_p.get("pipeline.rows", 0.0),
                delta_p.get("pipeline.stream_seconds", 0.0)],
            "trace": os.path.relpath(trace_path, repo)}

        # 6b. the fleet under sustained serve load, the ledger armed
        t0 = time.perf_counter()
        led.baseline()
        load = [packed[(i % 8) * BATCH:(i % 8 + 1) * BATCH]
                for i in range(AUTOTUNE_FLEET_LOAD)]
        replicas_seen = [len(fleet.entry("head").replicas)]
        for _ in range(AUTOTUNE_FLEET_WAVES):
            autotune_fleet_part(fleet, load)
            replicas_seen.append(len(fleet.entry("head").replicas))
        after_ans = autotune_fleet_part(fleet, reqs)
        diffs = [float(np.abs(a - b).max())
                 for a, b in zip(fleet_before, after_ans)]
        same = len(after_ans) == len(fleet_before) and not any(diffs)
        verdicts = [w["bound_by"] for w in led.history()]
        if replicas_seen != sorted(replicas_seen) or \
                replicas_seen[-1] > 2 or not same:
            raise AssertionError(f"fleet under load: replicas "
                                 f"{replicas_seen}, answers' max diffs "
                                 f"{diffs}")
        out["fleet"] = {"seconds": time.perf_counter() - t0,
                        "prior_without_window": prior_before,
                        "replicas": replicas_seen,
                        "answers_bit_equal": same,
                        "ledger_bound_by": led.last_bound(),
                        "ledger_verdicts": verdicts,
                        "describe": fleet_target.describe()}
        ctl.detach(fleet_target)
        decisions = autotune_decisions(trc, 0)
        state = ctl.state()
    finally:
        if server is not None:
            server.close()
        if fleet_server is not None:
            fleet_server.close()
        faults.disarm("pipeline.worker_death")
        ctl.reset()
        clog._override, led._override, led.window_s = saved
        trc.disarm()
        trc.clear()
        trc.arm_from_env()
        remote.aggregator().clear()

    # 2. outputs: each armed ladder run against an unarmed run at the
    # base rung on the same rows
    ref_runner = BatchRunner(head_mf, batch_size=BATCH)
    rows_out = []
    for rung, lo, n, got, _k in runs:
        ref = ref_runner.run({"image": packed[lo:lo + n]})["features"]
        if rung == BATCH:
            ok = np.array_equal(got, ref)
            rows_out.append([rung, n, "bit_equal", ok])
        else:
            rel = rel_diff(got, ref)
            ok = rel <= BOUND_FEATURES_REL
            rows_out.append([rung, n, float(np.abs(got - ref).max()), rel])
        if not ok:
            raise AssertionError(f"ladder run at rung {rung}, {n} rows: "
                                 f"{rows_out[-1]}")
    for a, r in zip(burst_ans + trickle_ans, burst + trickle):
        ref = ref_runner.run({"image": r})["features"]
        if not np.array_equal(a["features"], ref):
            raise AssertionError("a served answer differs from the offline "
                                 "runner at the same batch")
    launches = {KERNEL: infeed.launches, KERNEL_YUV420:
                infeed.yuv420_launches}
    out["ladder"] = {"seconds": ladder_s, "ladder": list(AUTOTUNE_LADDER),
                     "prewarm": prewarm,
                     "small_partition_rungs": down,
                     "small_partition_k2": [k for _r, k in small],
                     "full_partition_rungs": full_rungs,
                     "full_unexpected_retraces": full_unexpected,
                     "ragged": {"rows": AUTOTUNE_RAGGED_ROWS,
                                "rung": ragged_rung,
                                "tail_rows": AUTOTUNE_RAGGED_ROWS
                                % ragged_rung,
                                "shapes_seen_new": new_shapes,
                                "unexpected_retraces": ragged_unexpected},
                     "outputs": rows_out}
    emit("autotune", decisions=decisions, state=state, launches=launches,
         seconds=time.perf_counter() - t_phase, card=smi_line, **out)
    if not launches[KERNEL] or not launches[KERNEL_YUV420]:
        raise AssertionError(f"autotune launches {launches}")
    return launches[KERNEL], launches[KERNEL_YUV420]


FLEET_FRESH_PROCESS = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from sparkdl_tpu_torch.fleet import ModelRegistry, WarmStartCache
from sparkdl_tpu_torch.models import zoo
from sparkdl_tpu_torch.ops import infeed
from sparkdl_tpu_torch.serve import ModelServer, ServeConfig
from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
store, rows_path, out_path, batch, src = sys.argv[1:6]
batch, src = int(batch), tuple(int(v) for v in src.split("x"))
import_s = time.perf_counter() - t0

def headline():
    return deviceResizeModel(zoo.getModelFunction("InceptionV3"), src,
                             packedFormat="yuv420")

def no_export(*args, **kwargs):
    raise AssertionError("torch.export.export was called")

rows = np.load(rows_path)
# the process's first forward (CUDA's start, the kernels' and cuDNN's
# first loads) on a function of its own, before either replica is timed
t0 = time.perf_counter()
headline().apply({"image": torch.zeros((batch,) + rows.shape[1:],
                                       dtype=torch.uint8,
                                       device="cuda")})["features"].cpu()
out = {"import_s": import_s, "first_forward_s": time.perf_counter() - t0}
for what, root in (("cold", None), ("warm", store)):
    server = ModelServer(ServeConfig(max_wait_s=0.0))
    cache = WarmStartCache(root)
    registry = ModelRegistry(server, warmstart=cache)
    t0 = time.perf_counter()
    mf = headline()
    build_s = time.perf_counter() - t0
    real_export, torch.export.export = torch.export.export, no_export
    try:
        t0 = time.perf_counter()
        registry.deploy("headline", mf, batch_size=batch, replicas=1)
        torch.cuda.synchronize()
        deploy_s = time.perf_counter() - t0
    finally:
        torch.export.export = real_export
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    got = registry.submit({"image": rows}, model="headline").result(60)
    first_ms = (time.perf_counter() - t0) * 1e3
    out[what] = {"model_build_s": build_s, "replica_s": deploy_s,
                 "first_request_ms": first_ms, "store": cache.state(),
                 "k1": infeed.launches, "k2": infeed.yuv420_launches,
                 "program": type(server.session("headline@r0").runner
                                 .model_fn.module).__name__}
    if what == "warm":
        np.save(out_path, got["features"])
        out["warm"]["last_load"] = cache.last_load
    server.close()
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "sparkdl_tpu", "keras"))
out["banned_modules"] = banned
print(json.dumps(out))
"""


def fleet_counter(name):
    from sparkdl_tpu_torch.obs import default_registry
    return default_registry().counter(name).value


def replica_batches(server, names, before=None):
    """Each replica session's runner batches (less ``before``)."""
    now = {n: server.session(n).runner.metrics.batches for n in names}
    if before is None:
        return now
    return {n: now[n] - before[n] for n in names}


def versions_of(np, got, v1, v2):
    """Per row of one answer, 1 or 2: the offline output of that version
    it equals bit for bit (0: neither)."""
    return [1 if np.array_equal(g, a) else 2 if np.array_equal(g, b) else 0
            for g, a, b in zip(got, v1, v2)]


def fleet_placement(torch, np, smi_line, functions):
    """Step 1: the card's measured budget, the plan of both functions at
    2 replicas each on device 0, a refusal of one byte more than the
    card's free memory (counted), and each function's signature estimate
    beside the peak ``torch.cuda.max_memory_allocated`` measures over a
    warm batch above what was allocated before it."""
    from sparkdl_tpu_torch.fleet import (
        ModelFootprint,
        PlacementError,
        device_budgets,
        estimate_footprint,
        plan_placement,
    )
    budgets = device_budgets()
    if len(budgets) != 1 or budgets[0].source != "measured":
        raise AssertionError(f"fleet budgets {budgets}")
    footprints = [estimate_footprint(mf, BATCH, name)
                  for name, (mf, _k, _t) in functions.items()]
    plan = plan_placement(footprints,
                          replicas={n: FLEET_REPLICAS for n in functions},
                          budgets=budgets)
    want = {n: [0] * FLEET_REPLICAS for n in functions}
    if plan.assignments != want:
        raise AssertionError(f"fleet plan {plan.as_dict()}")
    refusals = fleet_counter("fleet.placement_refusals")
    refused = None
    try:
        plan_placement([ModelFootprint("too_big",
                                       budgets[0].free_bytes + 1)],
                       budgets=budgets)
    except PlacementError as e:
        refused = {"need_bytes": e.need_bytes,
                   "best_free_bytes": e.best_free_bytes,
                   "counted": fleet_counter("fleet.placement_refusals")
                   - refusals}
    if refused is None or refused["counted"] != 1:
        raise AssertionError(f"the refusal: {refused}")
    peaks = {}
    for name, (mf, _k, (requests, _big)) in functions.items():
        x = {mf.input_names[0]: torch.from_numpy(
            np.concatenate(requests)[:BATCH]).cuda()}
        mf.apply(x)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mf.apply(x)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    emit("fleet", step="placement", budget={
        "limit_bytes": budgets[0].limit_bytes,
        "free_bytes": budgets[0].free_bytes, "source": budgets[0].source},
        plan=plan.as_dict(), refusal=refused,
        estimate={fp.name: fp.detail for fp in footprints},
        measured_peak_above_allocated_bytes=peaks, batch=BATCH,
        card=smi_line)
    return plan


def fleet_route_pass(torch, np, registry, server, model, fn, refs):
    """One model's traffic through ``registry.submit`` (the counted run:
    the kernels' counts are 0 just before, read just after): every answer
    bit for bit the offline runner, each kernel's launches equal to the
    replicas' micro-batches, nothing built, every replica used."""
    from sparkdl_tpu_torch.obs import request_log, tails_from_records
    from sparkdl_tpu_torch.ops import _build, infeed
    mf, kernel, (requests, big) = fn
    names = registry.entry(model).replicas
    built, streams = kernel_state(infeed, _build), set(infeed._queues)
    before = replica_batches(server, names)
    routes = fleet_counter("fleet.routes")
    rlog = request_log()
    # sparkdl-lint: allow[H11] -- restored in this function's finally by arm_from_env(), which disarms the request log unless the environment armed it
    rlog.arm()
    rlog.clear()
    try:
        infeed.launches = infeed.yuv420_launches = 0
        res = fire(registry, {model: (mf.input_names[0], requests, big)})
        torch.cuda.synchronize()
        launches = {KERNEL: infeed.launches,
                    KERNEL_YUV420: infeed.yuv420_launches}
        records = rlog.records()
    finally:
        rlog.arm_from_env()
    batches = replica_batches(server, names, before)
    res = res[model]
    _rel, bit_equal, rows = check_serve_answers(
        np, mf.output_names[0], requests, res["answers"], refs)
    tails = tails_from_records(records)
    want = {KERNEL: 0, KERNEL_YUV420: 0}
    want[kernel] = sum(batches.values())
    out = {"replica_batches": batches, "launches": launches,
           "bit_equal": bit_equal, "rows_answered": rows,
           "requests": len(requests), "rejected": len(res["rejected"]),
           "p50_ms": tails["p50_ms"], "p99_ms": tails["p99_ms"],
           "achieved_rows_per_s": rows / res["elapsed_s"],
           "offered_rows": sum(len(r) for r in requests),
           "routes": fleet_counter("fleet.routes") - routes,
           "no_build": kernel_state(infeed, _build) == built,
           "k2_streams_added": len(set(infeed._queues) - streams)}
    if not bit_equal or launches != want or not out["no_build"] or \
            out["k2_streams_added"] or min(batches.values()) < 1:
        raise AssertionError(f"fleet route {model}: {out}")
    return out


def fleet_swap_under_load(torch, np, registry, server, fn, v1, new_state):
    """Step 3: the headline's traffic in rounds on a helper thread while
    ``swap_weights`` runs, then one round after it returned. Every
    admitted request answered; each answer's rows bit for bit v1's or
    v2's offline output, a request of at most one micro-batch all one
    version and an oversized one v1 then v2 at most once; the round
    after the swap v2 only. Returns the step's fields and v2's offline
    output."""
    from sparkdl_tpu_torch.obs import request_log, tails_from_records
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    mf, _kernel, (requests, big) = fn
    name, out_name = mf.input_names[0], mf.output_names[0]
    entry = registry.entry("headline")
    names = list(entry.replicas)
    fingerprint = entry.fingerprint
    offsets = np.cumsum([0] + [len(r) for r in requests])
    rounds, stop, failed = [], threading.Event(), []
    started = threading.Event()

    def traffic():
        try:
            while not stop.is_set():
                started.set()
                rounds.append(fire(registry, {"headline": (
                    name, requests, big)})["headline"])
        except BaseException as e:      # re-raised on the main thread
            failed.append(e)
            started.set()

    for s in names:
        server.session(s).gate_wait_max_s = 0.0
    before = replica_batches(server, names)
    rlog = request_log()
    # sparkdl-lint: allow[H11] -- restored in this function's finally by arm_from_env(), which disarms the request log unless the environment armed it
    rlog.arm()
    rlog.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    infeed.launches = infeed.yuv420_launches = 0
    worker = threading.Thread(target=traffic)
    worker.start()
    try:
        started.wait(WAIT_S)
        time.sleep(0.05)
        t0 = time.perf_counter()
        version = registry.swap_weights("headline", new_state,
                                        note="seed 1")
        swap_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        stop.set()
        worker.join(WAIT_S)
        records = rlog.records()
        rlog.arm_from_env()
    if failed or worker.is_alive():
        raise AssertionError(f"fleet swap traffic failed: {failed}")
    after = fire(registry, {"headline": (name, requests, big)})["headline"]
    torch.cuda.synchronize()
    launches = {KERNEL: infeed.launches,
                KERNEL_YUV420: infeed.yuv420_launches}
    batches = replica_batches(server, names, before)
    v2 = BatchRunner(entry.model_fn, BATCH).run(
        {name: np.concatenate(requests)})[out_name]
    seen = {"v1": 0, "v2": 0, "straddled": 0}
    for r in rounds:
        for i, got in r["answers"].items():
            rows = versions_of(np, got[out_name], v1[offsets[i]:offsets[i + 1]],
                               v2[offsets[i]:offsets[i + 1]])
            if 0 in rows or rows != sorted(rows) or (
                    len(rows) <= BATCH and len(set(rows)) > 1):
                raise AssertionError(f"request {i} of a round mixed "
                                     f"versions: {rows}")
            seen["straddled" if len(set(rows)) > 1
                 else f"v{rows[0]}"] += 1
    after_ok = all(
        versions_of(np, got[out_name], v1[offsets[i]:offsets[i + 1]],
                    v2[offsets[i]:offsets[i + 1]]) == [2] * len(got[out_name])
        for i, got in after["answers"].items())
    tails = tails_from_records(records)
    probes = 1 + len(names)     # the reference before, each replica after
    out = {"version": version.version,
           "new_fingerprint": version.fingerprint != fingerprint,
           "swap_s": swap_s, "last_swap_ms": registry.last_swap_ms,
           "phases_ms": registry.last_swap_phases,
           "gate_wait_max_ms": 1e3 * max(
               server.session(s).gate_wait_max_s for s in names),
           "peak_above_allocated_bytes": peak,
           "rounds": len(rounds), "answers": seen,
           "rejected": sum(len(r["rejected"]) for r in rounds),
           "after_swap_v2_only": after_ok,
           "after_swap_answers": len(after["answers"]),
           "swap_window_p50_ms": tails["p50_ms"],
           "swap_window_p99_ms": tails["p99_ms"],
           "launches": launches, "replica_batches": batches,
           "probe_batches": probes}
    if version.version != 2 or not out["new_fingerprint"] or not after_ok \
            or not after["answers"] or seen["v1"] + seen["straddled"] < 1 \
            or launches != {KERNEL: 0, KERNEL_YUV420:
                            sum(batches.values()) + probes}:
        raise AssertionError(f"fleet swap: {out}")
    return out, v2


def fleet_warm_start(torch, np, smi_line, registry, server, fn, v1, v2,
                     store, repo):
    """Step 4: ``scale("headline", 3)`` after the swap is a warm hit with
    ``torch.export.export`` refused, and the new replica answers with
    v2's bits; then a fresh ``python3 -c`` process deploys the seed-0
    headline against the same store: one hit, no export, answers bit
    for bit the cold v1 answers (it also times a cold replica)."""
    mf, _kernel, (requests, _big) = fn
    name, out_name = mf.input_names[0], mf.output_names[0]
    cache = registry.warmstart
    rows = np.concatenate(requests)[:BATCH]
    hits = cache.hits
    real_export = torch.export.export

    def no_export(*args, **kwargs):
        raise AssertionError("torch.export.export was called on a warm "
                             "start")
    torch.export.export = no_export
    try:
        t0 = time.perf_counter()
        replicas = registry.scale("headline", FLEET_REPLICAS + 1)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        torch.export.export = real_export
    newest = registry.entry("headline").replicas[-1]
    t0 = time.perf_counter()
    got = server.submit({name: rows}, model=newest).result(WAIT_S)
    warm_first_ms = (time.perf_counter() - t0) * 1e3
    scaled_v2 = bool(np.array_equal(got[out_name], v2[:BATCH]))
    program = type(server.session(newest).runner.model_fn.module).__name__

    rows_path = os.path.join(store, "rows.npy")
    out_path = os.path.join(store, "fresh.npy")
    np.save(rows_path, rows)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", FLEET_FRESH_PROCESS, store, rows_path,
         out_path, str(BATCH), "x".join(map(str, HEADLINE_SRC))],
        cwd=repo, capture_output=True, text=True, timeout=300)
    fresh_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the fleet's fresh process failed: "
                             f"{child.stderr[-2000:]}")
    fresh = json.loads(child.stdout.strip().splitlines()[-1])
    fresh_equal = bool(np.array_equal(np.load(out_path), v1[:BATCH]))
    out = {"replicas": replicas, "hits": cache.hits - hits,
           "scale_warm_s": warm_s, "warm_first_request_ms": warm_first_ms,
           "last_load": cache.last_load, "installed": program,
           "scaled_replica_v2_bit_equal": scaled_v2,
           "fresh_process": fresh, "fresh_process_s": fresh_s,
           "fresh_process_v1_bit_equal": fresh_equal}
    warm = fresh["warm"]
    if replicas != FLEET_REPLICAS + 1 or out["hits"] != 1 or \
            not scaled_v2 or program != "_Exported" or not fresh_equal or \
            warm["store"]["hits"] != 1 or warm["store"]["misses"] or \
            warm["program"] != "_Exported" or fresh["cold"]["store"][
                "enabled"] or fresh["banned_modules"] or \
            (warm["k2"], warm["k1"]) != (1, 0):
        raise AssertionError(f"fleet warm start: {out}")
    return out


def fleet_drills(torch, np, registry, fn, new_state, v1, v2):
    """Step 5: a state with one tensor resized raises ``SwapShapeError``
    before any transfer; ``fleet.swap`` at transient rate 1.0 raises
    ``SwapError`` with v2 still serving bit for bit, and the same swap
    (back to seed 0's weights) succeeds disarmed and serves v1's bits;
    ``fleet.route`` at transient rate 0.5, seed 7: 20 requests from one
    thread, none dropped, failovers counted."""
    from sparkdl_tpu_torch.fleet import SwapError, SwapShapeError
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.resilience import faults
    mf, _kernel, (requests, _big) = fn
    name, out_name = mf.input_names[0], mf.output_names[0]
    entry = registry.entry("headline")
    rows = np.concatenate(requests)[:SERVE_ROWS]

    def answer():
        return registry.submit({name: rows}, model="headline").result(
            WAIT_S)[out_name]

    out = {}
    bad = dict(new_state)
    key = next(iter(bad))
    bad[key] = torch.zeros((bad[key].shape[0] + 1,) + bad[key].shape[1:])
    failures = fleet_counter("fleet.swap_failures")
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    try:
        registry.swap_weights("headline", bad)
    except SwapShapeError as e:
        out["shape_refusal"] = str(e)[:160]
    out["shape_refusal_allocated_delta"] = \
        torch.cuda.memory_allocated() - allocated
    out["shape_refusal_counted"] = \
        fleet_counter("fleet.swap_failures") - failures
    seed0 = {f"inner.net.{k}": v for k, v in
             zoo.init_state_dict("InceptionV3", seed=0).items()}
    faults.inject("fleet.swap", kind="transient", rate=1.0)
    try:
        registry.swap_weights("headline", seed0)
    except SwapError as e:
        out["mid_swap_fault"] = type(e).__name__
    finally:
        faults.disarm()
    out["version_after_fault"] = entry.version
    out["v2_serving_after_fault"] = bool(np.array_equal(answer(),
                                                        v2[:SERVE_ROWS]))
    out["retry_version"] = registry.swap_weights("headline", seed0,
                                                 note="seed 0").version
    out["v1_serving_after_retry"] = bool(np.array_equal(answer(),
                                                        v1[:SERVE_ROWS]))
    failovers = fleet_counter("fleet.route_failovers")
    faults.inject("fleet.route", kind="transient", rate=0.5, seed=7)
    try:
        futures = [registry.submit({name: rows}, model="headline")
                   for _ in range(FLEET_FAILOVER_REQUESTS)]
    finally:
        faults.disarm()
    answered = [f.result(WAIT_S)[out_name] for f in futures]
    out["failover_answered"] = sum(np.array_equal(a, v1[:SERVE_ROWS])
                                   for a in answered)
    out["failovers"] = fleet_counter("fleet.route_failovers") - failovers
    if "shape_refusal" not in out or out["shape_refusal_counted"] != 1 \
            or out["shape_refusal_allocated_delta"] \
            or out.get("mid_swap_fault") != "SwapError" \
            or out["version_after_fault"] != 2 \
            or not out["v2_serving_after_fault"] \
            or out["retry_version"] != 3 \
            or not out["v1_serving_after_retry"] \
            or out["failover_answered"] != FLEET_FAILOVER_REQUESTS \
            or out["failovers"] < 1:
        raise AssertionError(f"fleet drills: {out}")
    return out


def fleet_phase(torch, np, smi_line, direct, repo):
    """The fleet control plane on the card (module docstring, phase 26:
    ``fleet``). Returns K1's and K2's launches over the counted runs (the
    routed passes and the swap under load)."""
    from sparkdl_tpu_torch.fleet import ModelRegistry, WarmStartCache
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.serve import ModelServer, ServeConfig
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    t_phase = time.perf_counter()
    head_mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"),
                                HEADLINE_SRC, packedFormat="yuv420")
    feat_mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"),
                                (512, 512))
    functions = {
        "headline": (head_mf, KERNEL_YUV420, serve_requests(
            np, head_mf, 20, SERVE_REQUESTS, SERVE_ROWS, SERVE_BIG,
            BATCH + SERVE_ROWS)),
        "featurize": (feat_mf, KERNEL, serve_requests(
            np, feat_mf, 21, SERVE_K1_REQUESTS, SERVE_K1_ROWS, 1,
            SERVE_K1_BIG_ROWS))}
    # the offline v1 outputs (outside the counted runs)
    refs = {m: BatchRunner(mf, BATCH).run(
        {mf.input_names[0]: np.concatenate(t[0])})[mf.output_names[0]]
        for m, (mf, _k, t) in functions.items()}
    plan = fleet_placement(torch, np, smi_line, functions)

    store = tempfile.mkdtemp(prefix="fleet_store_", dir=os.path.join(
        repo, "sparkdl_tpu_torch", "_build"))
    server = ModelServer(ServeConfig(max_wait_s=SERVE_WAIT_S,
                                     max_queue_rows=SERVE_QUEUE_ROWS))
    registry = ModelRegistry(server, warmstart=WarmStartCache(store))
    try:
        deploys = {}
        for model, (mf, _k, (requests, _b)) in functions.items():
            t0 = time.perf_counter()
            entry = registry.deploy(model, mf, batch_size=BATCH,
                                    replicas=FLEET_REPLICAS, placement=plan)
            torch.cuda.synchronize()
            deploy_s = time.perf_counter() - t0
            save = dict(registry.warmstart.last_save)
            t0 = time.perf_counter()
            server.submit({mf.input_names[0]: requests[0]},
                          model=entry.replicas[0]).result(WAIT_S)
            deploys[model] = {
                "deploy_s": deploy_s, "export_s": save["export_s"],
                "blob_bytes": save["bytes"],
                "cold_replica_s": (deploy_s - save["seconds"])
                / FLEET_REPLICAS,
                "cold_first_request_ms": (time.perf_counter() - t0) * 1e3,
                "replicas": entry.replicas}
        cache = registry.warmstart.state()
        emit("fleet", step="deploy", deploys=deploys, store=cache,
             card=smi_line)
        if (cache["writes"], cache["hits"], cache["entries"]) != (2, 0, 2):
            raise AssertionError(f"fleet deploy: store {cache}")

        routed = {m: fleet_route_pass(torch, np, registry, server, m, fn,
                                      refs[m])
                  for m, fn in functions.items()}
        emit("fleet", step="route", routed=routed, direct=direct,
             card=smi_line)

        new_state = {f"inner.net.{k}": v for k, v in
                     zoo.init_state_dict("InceptionV3", seed=1).items()}
        swap, v2 = fleet_swap_under_load(torch, np, registry, server,
                                         functions["headline"],
                                         refs["headline"], new_state)
        emit("fleet", step="swap", routed_p99_ms=routed["headline"][
            "p99_ms"], **swap, card=smi_line)

        warm = fleet_warm_start(torch, np, smi_line, registry, server,
                                functions["headline"], refs["headline"],
                                v2, store, repo)
        emit("fleet", step="warm_start", cold={
            m: {k: d[k] for k in ("cold_replica_s", "cold_first_request_ms")}
            for m, d in deploys.items()}, **warm, card=smi_line)

        drills = fleet_drills(torch, np, registry, functions["headline"],
                              new_state, refs["headline"], v2)
        emit("fleet", step="drills", **drills, card=smi_line)

        status = json.loads(http_get(
            server.serve_telemetry(port=0).url("/statusz"))[1])
        mine = json.loads(json.dumps(registry.state()))
        statusz = mine in status["fleet"]["registries"]
        emit("fleet", step="statusz", carries_registry=statusz,
             registries=len(status["fleet"]["registries"]),
             versions={m: e["version"] for m, e in mine["models"].items()},
             swaps=mine["swaps"], swap_failures=mine["swap_failures"],
             swap_rollbacks=mine["swap_rollbacks"],
             warmstart=mine["warmstart"], router=mine["router"],
             card=smi_line)
        if not statusz:
            raise AssertionError("/statusz does not carry the registry")
    finally:
        server.close()
        import shutil
        shutil.rmtree(store, ignore_errors=True)
    launches = (routed["featurize"]["launches"][KERNEL],
                routed["headline"]["launches"][KERNEL_YUV420]
                + swap["launches"][KERNEL_YUV420])
    emit("fleet_phases", seconds=time.perf_counter() - t_phase,
         launches={KERNEL: launches[0], KERNEL_YUV420: launches[1]},
         card=smi_line)
    return launches



# -- the Spark face (phase ``spark``) ---------------------------------------

SPARK_IMAGES = 256
SPARK_PARTITIONS = 4
SPARK_UDF_ROWS = 64
SPARK_SAMPLE = (0.5, 3)
SPARK_LIMIT = 100


class DuckRDD:
    """The slice of an RDD that ``SparkEngine`` uses: ``map`` records the
    task function."""

    def __init__(self, items, fn=None):
        self.items = list(items)
        self.fn = fn

    def map(self, fn):
        return DuckRDD(self.items, fn)


class DuckContext:
    """``parallelize`` and ``runJob`` as a Spark driver runs them: a job
    serialises its task function once with the standard library's
    ``pickle`` (Spark ships one stage's closure once) and each task loads
    that blob and its partition's element anew, in this process."""

    def __init__(self, jobs):
        self.jobs = jobs

    def parallelize(self, seq, n):
        seq = list(seq)
        if n != len(seq):
            raise AssertionError(f"{n} slices for {len(seq)} tasks")
        return DuckRDD(seq)

    def runJob(self, rdd, fn, partitions):
        import pickle
        t0 = time.perf_counter()
        blob = pickle.dumps((rdd.fn, fn))
        job = {"partitions": list(partitions), "dump_s":
               time.perf_counter() - t0, "blob_bytes": len(blob),
               "load_s": [], "task_s": []}
        out = []
        for p in partitions:
            t0 = time.perf_counter()
            task_fn, part_fn = pickle.loads(blob)
            item = pickle.loads(pickle.dumps(rdd.items[p]))
            t1 = time.perf_counter()
            out.extend(part_fn(iter([task_fn(item)])))
            job["load_s"].append(t1 - t0)
            job["task_s"].append(time.perf_counter() - t1)
        self.jobs.append(job)
        return out


class DuckSession:
    def __init__(self):
        self.jobs = []
        self.sparkContext = DuckContext(self.jobs)


class DuckRegistrar:
    """A session's ``udf.register`` seam; ``select`` calls a registered
    function the way an executor does, after a ``pickle`` round trip."""

    def __init__(self):
        self.registered = {}
        self.udf = self

    def register(self, name, fn):
        self.registered[name] = fn

    def select(self, name, values):
        import pickle
        t0 = time.perf_counter()
        blob = pickle.dumps(self.registered[name])
        t1 = time.perf_counter()
        fn = pickle.loads(blob)
        t2 = time.perf_counter()
        return fn(values), {"dump_s": t1 - t0, "load_s": t2 - t1,
                            "blob_bytes": len(blob)}


def l2_rows(params, inputs):
    """A host-backend model: each feature row over its L2 norm (numpy)."""
    import numpy as np
    x = np.asarray(inputs["features"], np.float32)
    return {"unit": x / np.linalg.norm(x, axis=1, keepdims=True)}


def spark_job_fields(jobs):
    return [{"partitions": j["partitions"], "dump_s": j["dump_s"],
             "blob_bytes": j["blob_bytes"], "load_s": j["load_s"],
             "task_s": j["task_s"]} for j in jobs]


def spark_run(torch, frame, engine, session):
    """``frame``'s plan on ``engine``; (batch, wall s, K1, K2, jobs)."""
    from sparkdl_tpu_torch import DataFrame
    from sparkdl_tpu_torch.ops import infeed
    planned = DataFrame(frame._sources, frame._plan, engine)
    del session.jobs[:]
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    out = planned.collect()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, infeed.launches,
            infeed.yuv420_launches, spark_job_fields(session.jobs))


def same_batch(np, a, b):
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and (np.array_equal(a[k], b[k]) if a[k].dtype != object
             else list(a[k]) == list(b[k])) for k in a)


def spark_verbs(np, feats, engine):
    """union, join on ``id``, limit, repartition, coalesce and sample over
    the card's features in 4 partitions on ``engine``, each against the
    same verb on the collected numpy batch."""
    from sparkdl_tpu_torch import DataFrame
    n = len(feats)
    ids = np.arange(n, dtype=np.int64)
    batch = {"id": ids, "features": feats}
    df = DataFrame.from_columns(batch, SPARK_PARTITIONS, engine)
    labels = {"id": ids[::-1][: n // 2].copy(),
              "label": (ids[::-1][: n // 2] % 10).astype(np.int64)}
    right = DataFrame.from_columns(labels, 2, engine)
    bounds = np.linspace(0, n, SPARK_PARTITIONS + 1).astype(int)
    frac, seed = SPARK_SAMPLE
    keep = np.concatenate([
        np.random.default_rng((seed, i)).random(hi - lo) < frac
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))])
    order = {int(k): j for j, k in enumerate(labels["id"])}
    matched = np.array([int(i) in order for i in ids])
    pos = np.array([order[int(i)] for i in ids[matched]])
    expect = {
        "union": {k: np.concatenate([v, v]) for k, v in batch.items()},
        "join": {"id": ids[matched], "features": feats[matched],
                 "label": labels["label"][pos]},
        "limit": {k: v[:SPARK_LIMIT] for k, v in batch.items()},
        "repartition": batch,
        "coalesce": batch,
        "sample": {k: v[keep] for k, v in batch.items()},
    }
    frames = {
        "union": df.union(df),
        "join": df.join(right, "id"),
        "limit": df.limit(SPARK_LIMIT),
        "repartition": df.repartition(3),
        "coalesce": df.coalesce(2),
        "sample": df.sample(frac, seed),
    }
    out = {}
    for name, verb_df in frames.items():
        got = verb_df.collect()
        out[name] = {"rows": int(len(got["id"])),
                     "partitions": verb_df.num_partitions,
                     "equal": same_batch(np, got, expect[name])}
    return out


def arrow_boundary(np, planned, ref, feats):
    """The Arrow, pandas, TF and pyspark boundaries: where the package is
    installed, the path runs and agrees with the numpy path (one
    partition's Arrow batch through ``plan_to_map_in_arrow``, bit for bit
    the local rows; a ``write_parquet`` read back by ``read_parquet``;
    ``to_pandas``); where it is not, each call raises naming it."""
    import importlib
    import importlib.util
    from sparkdl_tpu_torch import DataFrame, ModelIngest, SparkEngine
    from sparkdl_tpu_torch.data import arrow
    from sparkdl_tpu_torch.data.spark_binding import plan_to_map_in_arrow

    def arrow_batch():
        src = planned._sources[0]
        out = next(plan_to_map_in_arrow(planned._plan)(
            iter([arrow.batch_to_arrow(src.load())])))
        rows = src.num_rows
        got = np.stack(out.column("features").to_pylist())
        return bool(np.array_equal(got.astype(np.float32),
                                   ref["features"][:rows]))

    def parquet():
        d = tempfile.mkdtemp(prefix="spark_pq_")
        DataFrame.from_columns({"features": feats}, SPARK_PARTITIONS) \
            .write_parquet(os.path.join(d, "pq"))
        back = DataFrame.read_parquet(os.path.join(d, "pq")).collect()
        return bool(np.array_equal(back["features"], feats))

    def pandas():
        pdf = DataFrame.from_columns({"features": feats[:4]}, 1).to_pandas()
        return list(pdf.shape) == [4, 1]

    def graphdef():
        ModelIngest.fromGraphDef(b"", ["x"], ["y"])
        return False

    def spark_engine():
        SparkEngine()
        return False

    checks = (("plan_to_map_in_arrow", "pyarrow", arrow_batch),
              ("write_read_parquet", "pyarrow", parquet),
              ("to_pandas", "pandas", pandas),
              ("fromGraphDef", "tensorflow", graphdef),
              ("SparkEngine", "pyspark", spark_engine))
    out = {}
    for what, package, call in checks:
        present = importlib.util.find_spec(package) is not None
        entry = {"package": package, "installed": present}
        if present:
            entry["version"] = getattr(importlib.import_module(package),
                                       "__version__", None)
        try:
            entry["agrees"] = call()
            entry["raised"] = None
        except Exception as e:
            entry["agrees"] = False
            entry["raised"] = f"{type(e).__name__}: {e}"
        # a present package's path agrees; an absent one's raises with
        # its name (no fallback carries on)
        entry["ok"] = (entry["agrees"] if present else
                       bool(entry["raised"]) and package in entry["raised"])
        out[what] = entry
    return out


def spark_phase(torch, np, smi_line):
    """The Spark face on the card (module docstring, phase ``spark``).
    Returns K1's and K2's launches over the phase's counted runs."""
    from sparkdl_tpu_torch import (
        DataFrame,
        DeepImageFeaturizer,
        SparkEngine,
        TensorTransformer,
        register_udf,
    )
    from sparkdl_tpu_torch.data.engine import LocalEngine
    from sparkdl_tpu_torch.graph import ModelFunction
    from sparkdl_tpu_torch.image.imageIO import (
        imageArrayToStruct,
        rgbToYuv420,
    )
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.obs import default_registry
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    from sparkdl_tpu_torch.udf import makeModelUDF
    from sparkdl_tpu_torch.utils.synth import textured_image
    import pickle

    t_phase = time.perf_counter()
    session = DuckSession()
    spark = SparkEngine(spark=session)
    local = LocalEngine()
    fails = []
    k1 = k2 = 0

    # featurize: InceptionV3 behind K1, 4 partitions of 64, Spark against
    # local; the local plan carries a host-backend stage after the card's
    rng = np.random.default_rng(15)
    imgs = rng.integers(0, 256, (SPARK_IMAGES, 512, 512, 3), dtype=np.uint8)
    rows = [{"id": i, "image": imageArrayToStruct(img, origin=f"s_{i:03d}")}
            for i, img in enumerate(imgs)]
    df = DataFrame.from_pylist(rows, SPARK_PARTITIONS, local)
    featurizer = DeepImageFeaturizer(
        modelName="InceptionV3", inputCol="image", outputCol="features",
        deviceResizeFrom=(512, 512), batchSize=BATCH)
    host_mf = ModelFunction(l2_rows, {"features": ((FEATURES,), np.float32)},
                            ["unit"], backend="host", name="l2_rows")
    unit = TensorTransformer(modelFunction=host_mf,
                             inputMapping={"features": "features"},
                             outputMapping={"unit": "unit"},
                             batchSize=BATCH)
    shipped = default_registry().counter("ship.bytes_shipped")
    planned = featurizer.transform(df)
    before = shipped.value
    infeed.launches = infeed.yuv420_launches = 0
    t0 = time.perf_counter()
    ref = unit.transform(planned).collect()
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    shipped_local = shipped.value - before
    local_k1 = infeed.launches
    got, spark_s, launches, yuv, jobs = spark_run(torch, planned, spark,
                                                  session)
    k1 += launches + local_k1
    feats = np.asarray(got["features"])
    featurize_equal = same_batch(np, got, {k: v for k, v in ref.items()
                                           if k != "unit"})
    unit_ref = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    host_equal = bool(np.array_equal(np.asarray(ref["unit"]), unit_ref))
    feed_bytes = SPARK_IMAGES * 512 * 512 * 3
    host_plan = unit.transform(DataFrame.from_columns(
        {"features": feats}, SPARK_PARTITIONS, local))
    try:
        pickle.dumps(host_plan._plan)
        refused = None
    except TypeError as e:
        refused = str(e)
    featurize = {
        "images": SPARK_IMAGES, "partitions": SPARK_PARTITIONS,
        "launches": {KERNEL: launches, KERNEL_YUV420: yuv},
        "local_launches": {KERNEL: local_k1}, "wall_s": spark_s,
        "rows_per_s": SPARK_IMAGES / spark_s, "local_wall_s": local_s,
        "local_rows_per_s": SPARK_IMAGES / local_s, "jobs": jobs,
        "bit_equal_local": featurize_equal,
        "finite": bool(np.isfinite(feats).all()),
        "features_shape": list(feats.shape)}
    host_stage = {
        "equal_numpy": host_equal, "ship_bytes_local_pass": shipped_local,
        "featurize_input_bytes": feed_bytes,
        "host_stage_shipped": shipped_local - feed_bytes,
        "pickle_refused": refused}
    if not (featurize_equal and launches == SPARK_IMAGES // BATCH
            and yuv == 0 and feats.shape == (SPARK_IMAGES, FEATURES)
            and np.isfinite(feats).all()):
        fails.append("featurize")
    if not (host_equal and shipped_local == feed_bytes and refused
            and "re-create it on the worker" in refused):
        fails.append("host_stage")

    # the 4:2:0 headline behind K2, Spark against local
    packed = np.stack([rgbToYuv420(textured_image(rng, *HEADLINE_SRC))
                       for _ in range(SPARK_IMAGES)])
    head_mf = deviceResizeModel(zoo.getModelFunction("InceptionV3"),
                                HEADLINE_SRC, packedFormat="yuv420")
    head = TensorTransformer(
        modelFunction=head_mf, inputMapping={"image": "image"},
        outputMapping={"features": "features"}, batchSize=BATCH).transform(
        DataFrame.from_columns({"image": packed}, SPARK_PARTITIONS, local))
    head_ref, head_local_s, _, head_local_k2, _ = spark_run(
        torch, head, local, session)
    head_got, head_s, head_k1, head_k2, head_jobs = spark_run(
        torch, head, spark, session)
    k2 += head_k2 + head_local_k2
    headline_equal = same_batch(np, head_got, head_ref)
    headline = {"images": SPARK_IMAGES, "partitions": SPARK_PARTITIONS,
                "launches": {KERNEL: head_k1, KERNEL_YUV420: head_k2},
                "local_launches": {KERNEL_YUV420: head_local_k2},
                "wall_s": head_s, "rows_per_s": SPARK_IMAGES / head_s,
                "local_wall_s": head_local_s, "jobs": head_jobs,
                "bit_equal_local": headline_equal}
    if not (headline_equal and head_k2 == SPARK_IMAGES // BATCH
            and head_k1 == 0):
        fails.append("headline")

    # the SQL seam: an InceptionV3 image UDF (K1) registered on a session,
    # called on an ndarray of image structs after a pickle round trip; its
    # function is the featurize plan's, so it ships the bytes that plan's
    # job exported
    udf = makeModelUDF(plan_runner(planned).model_fn, "spark_features",
                       kind="image", batch_size=BATCH, register=False)
    registrar = DuckRegistrar()
    register_udf(registrar, udf)
    structs = np.empty(SPARK_UDF_ROWS, dtype=object)
    structs[:] = [r["image"] for r in rows[:SPARK_UDF_ROWS]]
    infeed.launches = 0
    t0 = time.perf_counter()
    sql_out, sql_pickle = registrar.select("spark_features", structs)
    sql_s = time.perf_counter() - t0
    sql_k1 = infeed.launches
    udf_ref = np.asarray(udf.apply(DataFrame.from_columns(
        {"image": structs}, 1, local), "image", "f").collect()["f"])
    k1 += infeed.launches
    sql_got = np.asarray([np.asarray(v, np.float32) for v in sql_out])
    sql_equal = bool(sql_got.shape == udf_ref.shape
                     and np.array_equal(sql_got, udf_ref))
    sql = {"rows": SPARK_UDF_ROWS, "seconds": sql_s, "pickle": sql_pickle,
           "launches": {KERNEL: sql_k1}, "bit_equal_apply": sql_equal,
           "output": type(sql_out).__name__ + "[" +
           type(sql_out[0]).__name__ + "]"}
    if not (sql_equal and sql_k1 == 1 and isinstance(sql_out[0], list)):
        fails.append("sql")

    # frame verbs over the card's features, on the Spark engine
    verbs = spark_verbs(np, feats, spark)
    if not all(v["equal"] for v in verbs.values()):
        fails.append("verbs")

    infeed.launches = 0
    boundary = arrow_boundary(np, planned, ref, feats)
    k1 += infeed.launches
    if not all(v["ok"] for v in boundary.values()):
        fails.append("boundary")
    local.shutdown()
    phase_s = time.perf_counter() - t_phase
    emit("spark", featurize=featurize, host_stage=host_stage,
         headline=headline, sql=sql, verbs=verbs, boundary=boundary,
         phase_s=phase_s, failed=fails, card=smi_line)
    if fails:
        raise AssertionError(f"spark: failed {fails}")
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

    # the three nvcc builds and the shim's g++ build, all started together
    from sparkdl_tpu_torch import native

    def build(name):
        t = time.perf_counter()
        log = _build.build(name, ptxas_report=True)
        return time.perf_counter() - t, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        shim = pool.submit(native.get_lib)
        builds = {name: pool.submit(build, name)
                  for name in (KERNEL, KERNEL_YUV420, KERNEL_EPILOGUE)}
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
    epilogue_nets, epilogue_launches = kernel_epilogue(torch, np, smi, frame)
    # K1's launches on each of its paths' counted runs
    k1_paths = {}
    k1_paths["featurize"], featurize_ref = featurize(torch, np, smi, frame)
    k1_paths["predict"] = predict(torch, np, smi, frame)
    k1_paths["zoo"], zoo_ms = zoo_models(torch, np, smi, frame)
    yuv_launches, head = headline(torch, np, smi)
    model_graph_ms = runner_split(torch, np, smi, frame, zoo_ms)
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
    k1_paths["serve"], yuv_serve, serve_direct = serve_phase(
        torch, np, smi, head[1],
        deviceResizeModel(zoo.getModelFunction("InceptionV3"), (512, 512)),
        zoo.getModelFunction("TestNet"))
    # tracing and health over both paths
    k1_paths["obs"], yuv_obs = obs_phase(torch, np, smi, frame, head,
                                         zoo.getModelFunction("TestNet"))
    # the static analysis on this machine, its sync table against the
    # card's guard, the NaN stop and the ring's registry keys (K1)
    k1_paths["lint"] = lint_phase(torch, np, smi, frame, repo)
    # measurement on the card: the compile log, the ledger, the profiler
    k1_paths["forensics"], yuv_forensics = forensics_phase(
        torch, np, smi, frame, head, featurize_ref, model_graph_ms, repo)
    # several devices: the sharded runner, useMesh, a mesh-backed serve
    # session, the data-parallel train step and its checkpoint
    k1_paths["parallel"], yuv_parallel = parallel_phase(
        torch, np, smi, frame, head, featurize_ref)
    # the closed loop and the worker plane: the autotune controller with
    # its five targets over both paths, the telemetry frames of pooled
    # workers
    k1_paths["autotune"], yuv_autotune = autotune_phase(
        torch, np, smi, frame, head, repo)
    del frame, head, featurize_ref
    # the fleet control plane over both paths: placement, deploys, routed
    # traffic, a hot swap under load, warm start, drills, /statusz
    k1_paths["fleet"], yuv_fleet_cp = fleet_phase(torch, np, smi,
                                                  serve_direct, repo)
    # the Keras estimator: full-width InceptionV3 fits (no kernel of the
    # port's runs on this path: its convolutions are cuDNN's)
    keras_estimator_phase(torch, np, smi, repo)
    # the Spark face: both paths as Spark tasks from unpickled exports, a
    # host-backend stage, the SQL seam, the frame verbs, what is absent
    k1_paths["spark"], yuv_spark = spark_phase(torch, np, smi)
    yuv_paths = {"headline": yuv_launches, "strategies": yuv_strategies,
                 "host_pipeline": yuv_pipe, "input_service": yuv_fleet,
                 "snapshot": yuv_snapshot, "export": yuv_export,
                 "export_fresh_process": yuv_fresh, "serve": yuv_serve,
                 "obs": yuv_obs, "forensics": yuv_forensics,
                 "parallel": yuv_parallel, "autotune": yuv_autotune,
                 "fleet": yuv_fleet_cp, "spark": yuv_spark}
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
        "torch_composition_ms": main["torch_composition_ms"]}, {
        "name": KERNEL_EPILOGUE, "route": "cuda",
        "source": KERNEL_EPILOGUE_SOURCE,
        "replaces": KERNEL_EPILOGUE_REPLACES,
        "launches": epilogue_launches,
        "main": {net: {k: v["main"][k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "bound_ms",
            "device_bound_share")} for net, v in epilogue_nets.items()},
        "library_ms": None}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
