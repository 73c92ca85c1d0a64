"""KerasImageFileEstimator: parallel hyperparameter search + DP fine-tune —
counterpart of ``sparkdl_tpu/estimators/keras_image_file_estimator.py``.

The reference's ``fit(df, paramMaps)`` collected (URI, label) rows into
Spark's main process, decoded every image there with ``imageLoader``, and
ran one Spark task per ParamMap, each deserializing the Keras file and
running ``model.fit`` on one machine (SURVEY §3.4). The JAX package decodes on
engine host threads and trains the Keras 3 model itself through
``stateless_call`` on Keras's JAX backend. The port cannot run Keras (the
card's machine has none), so it trains the model converted to torch:

* the ``modelFile`` is read by the installed keras into a
  :class:`~sparkdl_tpu_torch.graph.keras_convert.KerasSpec` once per fit,
  in the calling process, and each trial builds its own module from the
  spec (``graph/keras_convert.py::build_module``), so concurrent trials
  never share state, as each JAX trial's own ``load_model`` gives;
* a trial's step is one torch autograd pass in training mode (Keras's
  BatchNormalization and Dropout rules, see ``keras_convert.py``) and one
  step of a torch optimizer with optax's defaults (:data:`OPTIMIZERS`),
  on the losses the JAX package names (:data:`LOSSES`);
* batch order is the JAX package's, index for index (the same seeded
  permutations and wrap), checkpoints go through
  ``parallel/checkpoint.py`` each epoch, and a re-run resumes from them;
* on a global mesh (one process per device, ``parallel.initialize`` in
  each, ``useMesh=True``) the step is data-parallel: each rank takes its
  rows of the global batch, BatchNorm's moments are the global batch's
  and the gradients are averaged in one flat all-reduce.

``fitMultiple`` runs trials on a thread pool (the reference's one Spark
task per ParamMap). The JAX step's compile-log hook
(``obs/compile_log.py``) is not ported yet.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch._device import resolve_device
from sparkdl_tpu_torch.data.frame import LiveBatchHint, column, num_rows
from sparkdl_tpu_torch.data.tensors import column_to_tensor, column_values
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.keras_convert import (
    KerasModule,
    KerasSpec,
    build_module,
    keras_spec,
)
from sparkdl_tpu_torch.models.layers import synced_batch_stats
from sparkdl_tpu_torch.obs import span
from sparkdl_tpu_torch.obs.watchdog import watch as watchdog_watch
from sparkdl_tpu_torch.parallel.mesh import DATA_AXIS, collective_launch
from sparkdl_tpu_torch.parallel.train import average_gradients
from sparkdl_tpu_torch.params import (
    CanLoadImage,
    HasBatchSize,
    HasDevice,
    HasInputCol,
    HasKerasLoss,
    HasKerasModel,
    HasKerasOptimizer,
    HasLabelCol,
    HasOutputCol,
    HasOutputMode,
    HasUseMesh,
    keyword_only,
)
from sparkdl_tpu_torch.params.base import Param, TypeConverters
from sparkdl_tpu_torch.params.pipeline import Estimator, Model
from sparkdl_tpu_torch.runtime.runner import RunnerMetrics
from sparkdl_tpu_torch.transformers import utils as tfr_utils

logger = logging.getLogger(__name__)

_LOADED_COL = "__sparkdl_tpu_torch_loaded__"


# ---------------------------------------------------------------------------
# losses and optimizers (reference: kerasLoss / kerasOptimizer params)
# ---------------------------------------------------------------------------

_EPS = 1e-7


def _categorical_crossentropy(p, y):
    return -torch.sum(y * torch.log(torch.clamp(p, _EPS, 1.0)), dim=-1)


def _binary_crossentropy(p, y):
    return -torch.mean(y * torch.log(torch.clamp(p, _EPS, 1.0))
                       + (1.0 - y) * torch.log(torch.clamp(1.0 - p, _EPS,
                                                           1.0)), dim=-1)


def _mse(p, y):
    return torch.mean(torch.square(p - y), dim=-1)


def _softmax_cross_entropy(logits, labels):
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)


def _sigmoid_binary_cross_entropy(logits, labels):
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    return -labels * log_p - (1.0 - labels) * log_not_p


def _squared_error(predictions, targets):
    return torch.square(predictions - targets)


def _l2_loss(predictions, targets):
    return 0.5 * torch.square(predictions - targets)


# Keras-era names take probabilities and clip them (the reference's
# compiled Keras losses); the others are optax's losses of that name and
# take logits. Each maps (predictions, targets) to per-row or
# per-element losses; the step takes their mean.
LOSSES: Dict[str, Callable] = {
    "categorical_crossentropy": _categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "mse": _mse,
    "softmax_cross_entropy": _softmax_cross_entropy,
    "sigmoid_binary_cross_entropy": _sigmoid_binary_cross_entropy,
    "squared_error": _squared_error,
    "l2_loss": _l2_loss,
}


def _resolve_loss(loss) -> Callable:
    """Loss name or callable → ``fn(preds, targets) -> losses``."""
    if callable(loss):
        return loss
    fn = LOSSES.get(loss)
    if fn is None:
        raise ValueError(f"unknown loss {loss!r}; the port has "
                         f"{sorted(LOSSES)}")
    return fn


class _OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``'s defaults and arithmetic: ``nu = (1 - decay) g²
    + decay nu`` from ``nu = 0``, ``p += (g * rsqrt(nu + eps)) * -lr``
    (eps inside the root; torch's RMSprop adds it outside, and decays by
    0.99)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d, eps, lr = group["decay"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = (1 - d) * (g * g) + d * state["nu"]
                state["nu"] = nu
                p.add_((torch.rsqrt(nu + eps) * g) * -lr)


class _OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad``'s defaults and arithmetic: ``s = g² + s`` from
    ``s = 0.1``, ``p += (where(s > 0, rsqrt(s + eps), 0) * g) * -lr``
    with ``eps = 1e-7`` inside the root (torch's Adagrad starts from 0
    and adds 1e-10 outside it)."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, {"lr": lr, "eps": eps,
                                  "initial": initial_accumulator_value})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            eps, lr = group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial"])
                s = g * g + state["sum_of_squares"]
                state["sum_of_squares"] = s
                inv = torch.where(s > 0, torch.rsqrt(s + eps),
                                  torch.zeros_like(s))
                p.add_((inv * g) * -lr)


# optax's name → a torch optimizer over (params, learning_rate) with
# optax's defaults, not torch's: Adam and AdamW b1 0.9, b2 0.999, eps 1e-8
# outside the root, AdamW's decoupled weight decay 1e-4 (torch's 1e-2);
# SGD without momentum
OPTIMIZERS: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr),
    "adam": lambda params, lr: torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
    "adamw": lambda params, lr: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
    "rmsprop": lambda params, lr: _OptaxRMSprop(params, lr),
    "adagrad": lambda params, lr: _OptaxAdagrad(params, lr),
}


def _resolve_optimizer(opt, fit_params: dict
                       ) -> Callable[[List[torch.Tensor]],
                                     torch.optim.Optimizer]:
    """Optimizer name or factory → ``params -> torch.optim.Optimizer``.
    A callable (the counterpart of passing an optax transformation) is
    used as it is; a name takes ``fit_params["learning_rate"]`` (default
    1e-3)."""
    if callable(opt):
        return opt
    make = OPTIMIZERS.get(opt)
    if make is None:
        raise ValueError(f"unknown optimizer {opt!r}; the port maps "
                         f"{sorted(OPTIMIZERS)}")
    lr = float(fit_params.get("learning_rate", 1e-3))
    return lambda params: make(params, lr)


def _config_fingerprint_bytes(est) -> bytes:
    """Hyperparameter identity for checkpoint fingerprints, byte for byte
    the JAX package's (so a trial's checkpoint directory has the same
    name in both). ``epochs`` is deliberately EXCLUDED: it is the
    training budget, not the run's identity — an interrupted 2-epoch run
    extended to 4 epochs must resume the same checkpoints."""
    fit_params = {k: v for k, v in est.getKerasFitParams().items()
                  if k != "epochs"}
    # field separators: delimiter-free concatenation lets distinct
    # configs collide byte for byte and share a checkpoint directory
    return "\x1f".join([
        repr(sorted(fit_params.items())),
        repr(est.getKerasLoss()),
        repr(est.getOrDefault("kerasOptimizer")),
        est.getModelFile(),
    ]).encode()


class _TrainStep:
    """One step over a batch of this rank's rows: the module's forward in
    training mode, the mean of the loss, the backward and the optimizer's
    step. On a global ``mesh`` BatchNorm takes the data group's moments
    and the gradients are averaged over it in one flat all-reduce before
    the step. Returns the loss as a device scalar: nothing waits for the
    device."""

    def __init__(self, module: KerasModule, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer, mesh=None):
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.params = dict(module.named_parameters())

    def __call__(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        sync = contextlib.nullcontext()
        if self.mesh is not None:
            sync = synced_batch_stats(self.mesh.group(DATA_AXIS),
                                      self.mesh.shape[DATA_AXIS])
        with sync:
            preds = self.module({"input": xb})["output_0"]
        loss = torch.mean(self.loss_fn(preds, yb))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            average_gradients(self.params, self.mesh.group(DATA_AXIS),
                              self.mesh.shape[DATA_AXIS])
        self.optimizer.step()
        return loss.detach()


def _epoch_mean(losses: List[torch.Tensor], mesh) -> float:
    """An epoch's mean step loss after its one wait for the device; on a
    global mesh each rank's losses are averaged over the data group
    first (one all-reduce an epoch: the ranks' rows are equal shares)."""
    stacked = torch.stack(losses)
    if mesh is not None:
        import torch.distributed as dist
        dist.all_reduce(stacked, group=mesh.group(DATA_AXIS))
        stacked = stacked / mesh.shape[DATA_AXIS]
    return float(np.mean(stacked.cpu().numpy()))


def _state_tree(module: KerasModule, optimizer, generator,
                history: List[float]) -> Dict[str, Any]:
    """What a checkpoint holds: the trainable and non-trainable tensors
    by name, the optimizer's state, the dropout generator's state and the
    loss history."""
    return {"trainable": dict(module.named_parameters()),
            "non_trainable": dict(module.named_buffers()),
            "opt_state": optimizer.state_dict(),
            "rng": generator.get_state(),
            "history": np.asarray(history, np.float64)}


def _restore_state(saved: Dict[str, Any], module: KerasModule, optimizer,
                   generator) -> List[float]:
    """Load a checkpoint's tree into a fresh trial's state (names and
    shapes checked); returns its loss history."""
    live = {"trainable": dict(module.named_parameters()),
            "non_trainable": dict(module.named_buffers())}
    with torch.no_grad():
        for group, tensors in live.items():
            got = saved[group]
            if set(got) != set(tensors):
                raise ValueError(
                    f"the checkpoint's {group} tensors {sorted(got)} are "
                    f"not the model's {sorted(tensors)}")
            for k, t in tensors.items():
                if tuple(got[k].shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint tensor {k} has shape "
                        f"{tuple(got[k].shape)}, the model's "
                        f"{tuple(t.shape)}")
                t.copy_(got[k])
    optimizer.load_state_dict(saved["opt_state"])
    generator.set_state(saved["rng"])
    return [float(h) for h in saved["history"]]


class _Trial:
    """One trial's training state: its own module built from the spec,
    loss, optimizer, dropout generator, step and checkpointer, and the
    seconds of its setup and saves (``fitStats``)."""

    def __init__(self, est: "KerasImageFileEstimator", spec: KerasSpec,
                 mesh, batch_size: int, seed: int):
        t0 = time.perf_counter()
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(est.getDevice()))
        self.module, self.loss_fn, make_optimizer = est._setup_trial(
            spec, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.module.seed_dropout(self.generator)
        t1 = time.perf_counter()
        self.optimizer = make_optimizer(list(self.module.parameters()))
        t2 = time.perf_counter()
        self.step, self.batch_size = est._compile_step(
            self.module, self.loss_fn, self.optimizer, batch_size, mesh)
        self.launch = collective_launch(mesh)
        self.history: List[float] = []
        self.stats = {"device": str(self.device), "build_s": t1 - t0,
                      "optimizer_s": t2 - t1, "restore_s": 0.0,
                      "save_s": 0.0}
        self.checkpointer = None
        self._writes = True

    def open_checkpoints(self, est, tag: str,
                         fingerprint: Callable[[], str], epochs: int) -> int:
        """With ``checkpointDir`` set, open ``checkpointDir/<tag>_<the
        fingerprint>`` and restore the newest step ≤ ``epochs`` (the one
        every process holds, on a global mesh); returns that epoch (0:
        none). Only process 0 writes."""
        if not est.isDefined("checkpointDir"):
            return 0
        from sparkdl_tpu_torch.parallel import distributed as dist
        from sparkdl_tpu_torch.parallel.checkpoint import PytreeCheckpointer
        self.checkpointer = PytreeCheckpointer(os.path.join(
            est.getOrDefault("checkpointDir"), f"{tag}_{fingerprint()}"))
        # resume from the newest step still on disk that fits this run's
        # epoch budget (older steps may have been pruned)
        usable = [s for s in self.checkpointer.all_steps() if s <= epochs]
        best = max(usable) if usable else 0
        info = dist.host_info()
        self._writes = info.process_index == 0
        if self.mesh is not None and info.process_count > 1:
            # every process must restore the SAME step
            best = dist.agree_resume_step(best, usable)
        if best:
            t0 = time.perf_counter()
            self.history = _restore_state(
                self.checkpointer.load(best), self.module, self.optimizer,
                self.generator)
            self.stats["restore_s"] = time.perf_counter() - t0
        return best

    def save(self) -> None:
        if self.checkpointer is None or not self._writes:
            return
        t0 = time.perf_counter()
        self.checkpointer.save(len(self.history), _state_tree(
            self.module, self.optimizer, self.generator, self.history))
        self.stats["save_s"] += time.perf_counter() - t0

    def close(self) -> None:
        """Wait for the last checkpoint write; on a global mesh every
        process waits for process 0's, so a fit that follows finds it."""
        if self.checkpointer is not None:
            t0 = time.perf_counter()
            self.checkpointer.close()
            if self.mesh is not None:
                import torch.distributed as dist
                dist.barrier(group=self.mesh.group(DATA_AXIS))
            self.stats["save_s"] += time.perf_counter() - t0

    def run_step(self, xb: np.ndarray, yb: np.ndarray) -> torch.Tensor:
        # stage the batch outside the launch lock (the lock covers only
        # the collective program's dispatch)
        x = torch.from_numpy(xb).to(self.device)
        y = torch.from_numpy(yb).to(self.device)
        with span("step", lane="estimator", rows=len(xb)), \
                watchdog_watch("estimator.step"), self.launch:
            return self.step(x, y)


# ---------------------------------------------------------------------------
# the fitted model
# ---------------------------------------------------------------------------

class KerasImageFileModel(Model, HasInputCol, HasOutputCol, HasOutputMode,
                          HasBatchSize, HasUseMesh, CanLoadImage):
    """Fitted model: the trained module wrapped as a ModelFunction, on
    the device it trained on.

    Plays the role of the ``KerasImageFileTransformer`` the reference
    built from each trial's returned weights: transform = imageLoader on
    host threads → the module's eval forward on the device."""

    def __init__(self, model_fn: ModelFunction, *, inputCol, outputCol,
                 imageLoader, outputMode="vector", batchSize=64,
                 useMesh=False, history: Optional[List[float]] = None,
                 resumedFrom: int = 0):
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=64, useMesh=False)
        self._set(inputCol=inputCol, outputCol=outputCol,
                  imageLoader=imageLoader, outputMode=outputMode,
                  batchSize=batchSize, useMesh=useMesh)
        self.modelFunction = model_fn
        self.history = history or []  # per-epoch mean training loss
        # which epoch this fit restored from (0 = trained from scratch):
        # observable proof a checkpointDir resume actually happened
        self.resumedFrom = int(resumedFrom)
        self.metrics = RunnerMetrics()
        # seconds of the fit's parts (not persisted)
        self.fitStats: Dict[str, Any] = {}

    def _transform(self, dataset):
        mf = self.modelFunction
        in_name, out_name = tfr_utils.single_io(mf)
        out_col = self.getOutputCol()
        mode = self.getOutputMode()
        runner = tfr_utils.make_runner(mf, self.getBatchSize(),
                                       use_mesh=self.getUseMesh(),
                                       metrics=self.metrics)
        shape, dtype = mf.input_signature[in_name]

        def apply(batch):
            arr = tfr_utils.reshapeLoadedRows(
                column_to_tensor(column(batch, _LOADED_COL)), shape, dtype,
                mf.name)
            out = runner.run({in_name: arr})[out_name]
            batch = {k: v for k, v in batch.items() if k != _LOADED_COL}
            return tfr_utils.appendModelOutput(batch, out_col, out, mode)

        loaded = self.loadImagesInternal(dataset, self.getInputCol(),
                                         _LOADED_COL)
        return loaded.map_batches(apply, kind="device",
                                  name=f"apply({mf.name})",
                                  batch_hint=LiveBatchHint(runner))

    def copy(self, extra: Optional[dict] = None) -> "KerasImageFileModel":
        that = super().copy(extra)
        that.modelFunction = self.modelFunction
        that.history = list(self.history)
        that.metrics = RunnerMetrics()
        that.fitStats = dict(self.fitStats)
        return that

    def _extra_state(self):
        # the ModelFunction persists as its torch.export program with the
        # trained weights baked in (persistence.py's model_fn codec)
        return {"modelFunction": self.modelFunction,
                "history": [float(v) for v in self.history],
                "resumedFrom": self.resumedFrom}

    @classmethod
    def _from_saved(cls, params, extra, children):
        return cls(extra["modelFunction"],
                   inputCol=params["inputCol"],
                   outputCol=params["outputCol"],
                   imageLoader=params.get("imageLoader"),
                   outputMode=params.get("outputMode", "vector"),
                   batchSize=params.get("batchSize", 64),
                   useMesh=params.get("useMesh", False),
                   history=extra.get("history"),
                   resumedFrom=extra.get("resumedFrom", 0))


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

class KerasImageFileEstimator(Estimator, HasInputCol, HasOutputCol,
                              HasLabelCol, HasKerasModel, HasKerasOptimizer,
                              HasKerasLoss, HasOutputMode, HasBatchSize,
                              CanLoadImage, HasDevice):
    """Fits a user Keras model file on an image-URI DataFrame.

    Params mirror the reference estimator (``inputCol`` URI column,
    ``labelCol``, ``modelFile``, ``imageLoader``, ``kerasOptimizer``,
    ``kerasLoss``, ``kerasFitParams``, ``outputCol``/``outputMode``).
    ``kerasFitParams`` keys: ``epochs`` (default 1), ``batch_size``
    (default 32, the per-step global batch), ``learning_rate``,
    ``shuffle`` (default True), ``seed``. The model trains on ``device``
    (None = the card).

    ``parallelism`` bounds concurrent trials in ``fitMultiple``;
    ``useMesh`` trains data-parallel over the process group's global
    mesh (one process per device) when there is one of several ranks,
    else warns once a fit and trains on one device.
    """

    parallelism = Param("KerasImageFileEstimator", "parallelism",
                        "max concurrent trials in fitMultiple",
                        TypeConverters.toInt)
    useMesh = Param("KerasImageFileEstimator", "useMesh",
                    "train data-parallel over the global device mesh",
                    TypeConverters.toBoolean)
    checkpointDir = Param(
        "KerasImageFileEstimator", "checkpointDir",
        "checkpoint directory: training state saves per epoch and an "
        "interrupted fit resumes from the last epoch (the reference "
        "restarted from scratch, SURVEY §5)", TypeConverters.toString)
    streaming = Param(
        "KerasImageFileEstimator", "streaming",
        "train by streaming decoded partitions through the engine "
        "instead of collecting (X, y) into one process's memory — removes "
        "the reference's dataset-must-fit-in-memory cliff (SURVEY §3.4) at "
        "the cost of re-decoding each epoch (see cacheDecoded)",
        TypeConverters.toBoolean)
    cacheDecoded = Param(
        "KerasImageFileEstimator", "cacheDecoded",
        "streaming mode: spill decoded tensors to per-partition files "
        "during epoch 1 and stream the cache on later epochs — decode "
        "runs once per fit instead of once per epoch, while memory stays "
        "streaming-shaped", TypeConverters.toBoolean)

    # A private seam: a KerasSpec, weights included, used in place of
    # reading ``modelFile`` (which then names the model for the
    # checkpoint fingerprint only). It lets a machine without keras train
    # a committed topology; everything after the spec is the estimator's
    # own code.
    _spec_override: Optional[KerasSpec] = None

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, labelCol=None,
                 modelFile=None, imageLoader=None, kerasOptimizer="adam",
                 kerasLoss="categorical_crossentropy", kerasFitParams=None,
                 outputMode="vector", batchSize=64, parallelism=2,
                 useMesh=True, checkpointDir=None, streaming=False,
                 cacheDecoded=False, device=None):
        super().__init__()
        self._setDefault(kerasOptimizer="adam",
                         kerasLoss="categorical_crossentropy",
                         kerasFitParams={"epochs": 1, "batch_size": 32},
                         outputMode="vector", batchSize=64, parallelism=2,
                         useMesh=True, streaming=False, cacheDecoded=False,
                         device=None)
        self._set(inputCol=inputCol, outputCol=outputCol, labelCol=labelCol,
                  modelFile=modelFile, imageLoader=imageLoader,
                  kerasOptimizer=kerasOptimizer, kerasLoss=kerasLoss,
                  kerasFitParams=kerasFitParams, outputMode=outputMode,
                  batchSize=batchSize, parallelism=parallelism,
                  useMesh=useMesh, checkpointDir=checkpointDir,
                  streaming=streaming, cacheDecoded=cacheDecoded,
                  device=device)

    # -- validation (reference _validateParams) -----------------------------

    def _validateParams(self):
        for name in ("inputCol", "outputCol", "labelCol", "modelFile",
                     "imageLoader"):
            if not self.isDefined(name):
                raise ValueError(f"KerasImageFileEstimator requires param "
                                 f"{name!r} to be set")

    # -- the model file ------------------------------------------------------

    def _read_spec(self) -> KerasSpec:
        """The model file read by the installed keras into a spec, or the
        private seam's spec."""
        if self._spec_override is not None:
            return self._spec_override
        import keras
        model = keras.models.load_model(self.getModelFile(), compile=False)
        return keras_spec(model)

    def _train_mesh(self):
        """The global mesh of a process group of several ranks, or None
        (after one warning) when there is none to train over."""
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            from sparkdl_tpu_torch.parallel.distributed import global_mesh
            return global_mesh()
        logger.warning(
            "useMesh requested but no process group of several ranks is "
            "initialized (torch trains one process per device: call "
            "parallel.initialize in each); training single-device")
        return None

    # -- data localization (reference _getNumpyFeaturesAndLabels) -----------

    def _getNumpyFeaturesAndLabels(self, dataset
                                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode the URI column with ``imageLoader`` on engine host
        threads and collect ``(X, y)`` (the reference decoded serially in
        one process — its documented scalability cliff)."""
        self._validateParams()
        loaded = self.loadImagesInternal(
            dataset.select(self.getInputCol(), self.getLabelCol()),
            self.getInputCol(), _LOADED_COL)
        table = loaded.collect()
        X = np.asarray(column_to_tensor(column(table, _LOADED_COL)),
                       dtype=np.float32)
        y = column_values(column(table, self.getLabelCol()))
        return X, y

    # -- one trial ----------------------------------------------------------

    @staticmethod
    def _trial_fingerprint(est, X: np.ndarray, y: np.ndarray) -> str:
        """Checkpoint identity for one trial: hyperparameters AND data,
        byte for byte the JAX package's. Resume must only ever continue a
        run with the same config on the same (X, y)."""
        import hashlib
        h = hashlib.sha256()
        h.update(_config_fingerprint_bytes(est))
        h.update(repr((X.shape, str(X.dtype))).encode())
        h.update(np.ascontiguousarray(y).tobytes())
        stride = max(1, len(X) // 16)
        h.update(np.ascontiguousarray(X[::stride]).tobytes())
        return h.hexdigest()[:16]

    def _setup_trial(self, spec: KerasSpec, device: torch.device):
        """The trial's own module built from the fit's spec on ``device``
        (in training mode), its loss and its optimizer factory."""
        module = build_module(spec, device)
        module.train()
        loss_fn = _resolve_loss(self.getKerasLoss())
        make_optimizer = _resolve_optimizer(self.getKerasOptimizer(),
                                            self.getKerasFitParams())
        return module, loss_fn, make_optimizer

    def _trainOne(self, X: np.ndarray, y: np.ndarray, paramMap: dict,
                  spec: KerasSpec, mesh=None,
                  checkpoint_tag: str = "fit") -> KerasImageFileModel:
        """Train one configuration on the collected ``(X, y)``. With
        ``checkpointDir`` set, state saves each epoch under
        ``dir/<tag>_<fingerprint>`` and a re-run with the same config and
        data resumes at the last saved epoch, producing the same final
        model as an uninterrupted run."""
        t_fit = time.perf_counter()
        est = self.copy(paramMap) if paramMap else self
        est._validateParams()
        fit_params = est.getKerasFitParams()
        epochs = int(fit_params.get("epochs", 1))
        shuffle = bool(fit_params.get("shuffle", True))
        seed = int(fit_params.get("seed", 0))
        mesh = mesh if est.getOrDefault("useMesh") else None

        trial = _Trial(est, spec, mesh,
                       int(fit_params.get("batch_size", 32)), seed)
        n_out = int(spec.output_shapes[0][-1])
        targets = self._prepare_targets(y, est.getKerasLoss(), n_out)
        batch_size = trial.batch_size
        # this rank's rows of each global batch (all of them on one
        # device)
        lo, hi = 0, batch_size
        if mesh is not None:
            from sparkdl_tpu_torch.parallel.mesh import data_sharding
            lo, hi = data_sharding(mesh).rows(batch_size)[
                mesh.coordinate[0]]

        n = len(X)
        if n == 0:
            raise ValueError("cannot fit on an empty dataset")
        steps_per_epoch = max(1, math.ceil(n / batch_size))
        rng = np.random.default_rng(seed)

        start_epoch = trial.open_checkpoints(
            est, checkpoint_tag, lambda: self._trial_fingerprint(est, X, y),
            epochs)
        # burn the skipped epochs' shuffles so a resumed run sees the same
        # batch order as an uninterrupted one
        for _ in range(start_epoch):
            if shuffle:
                rng.permutation(n)

        for epoch in range(start_epoch, epochs):
            with span("epoch", lane="estimator", epoch=epoch):
                order = rng.permutation(n) if shuffle else np.arange(n)
                # wrap indices so every step sees a full batch (a padded
                # and masked tail would change the BatchNorm moments);
                # np.resize tiles the permutation as often as needed when
                # batch_size > n
                if n % batch_size:
                    order = np.resize(order, steps_per_epoch * batch_size)
                losses = []
                for s in range(steps_per_epoch):
                    sel = order[s * batch_size:(s + 1) * batch_size][lo:hi]
                    losses.append(trial.run_step(X[sel], targets[sel]))
                trial.history.append(_epoch_mean(losses, mesh))
                trial.save()
        trial.close()
        return self._model(est, trial, start_epoch, spec, t_fit)

    def _compile_step(self, module: KerasModule, loss_fn: Callable,
                      optimizer: torch.optim.Optimizer, batch_size: int,
                      mesh=None) -> Tuple[_TrainStep, int]:
        """The train step, and the global batch it takes: single-device,
        or data-parallel on a global ``mesh``, where the batch is rounded
        up to a multiple of the data axis (each rank an equal share).
        The JAX step's compile-log instrumentation waits for the port's
        ``obs/compile_log.py``."""
        if mesh is not None:
            ndata = mesh.shape[DATA_AXIS]
            batch_size = max(1, -(-batch_size // ndata)) * ndata
        return _TrainStep(module, loss_fn, optimizer, mesh), batch_size

    def _model(self, est, trial: _Trial, start_epoch: int,
               spec: KerasSpec, t_fit: float) -> KerasImageFileModel:
        trial.optimizer.zero_grad(set_to_none=True)   # free the gradients
        mf = self._as_model_function(trial.module, spec, trial.device)
        model = KerasImageFileModel(
            mf, inputCol=est.getInputCol(), outputCol=est.getOutputCol(),
            imageLoader=est.getImageLoader(), outputMode=est.getOutputMode(),
            batchSize=est.getBatchSize(),
            useMesh=est.getOrDefault("useMesh"), history=trial.history,
            resumedFrom=start_epoch)
        model.fitStats = {**trial.stats,
                          "fit_s": time.perf_counter() - t_fit}
        return model

    @staticmethod
    def _prepare_targets(y: np.ndarray, loss, n_out: int) -> np.ndarray:
        """Integer class labels one-hot to the model's output width for
        categorical losses — including float64 columns holding INTEGRAL
        class ids, the Spark ML label convention this library accepts
        everywhere else (LogisticRegression, its predictionCol output);
        everything else passes through as float32, with 1-D targets
        lifted to [N, 1] so elementwise losses align with a 2-D model
        output — without the reshape, [N,1] preds against [N] targets
        broadcast to [N,N] and BCE silently minimizes a wrong
        objective."""
        if loss == "categorical_crossentropy" and y.ndim == 1:
            ids = None
            if np.issubdtype(y.dtype, np.integer):
                ids = y.astype(np.int64)
            elif (np.issubdtype(y.dtype, np.floating) and len(y)
                    and (y == np.round(y)).all()):
                ids = y.astype(np.int64)
            if ids is not None:
                if len(ids) and (ids.min() < 0 or ids.max() >= n_out):
                    # np.eye fancy-indexing would silently WRAP a -1
                    # label to the last class (re-encode {-1,1} to
                    # {0,1}, like LogisticRegression demands)
                    raise ValueError(
                        f"class ids must be in [0, {n_out}); got range "
                        f"[{ids.min()}, {ids.max()}] (re-encode e.g. "
                        "{-1,1} labels to {0,1})")
                return np.eye(n_out, dtype=np.float32)[ids]
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 1:
            y = y.reshape(len(y), 1)
            if n_out != 1:
                raise ValueError(
                    f"1-D targets against a {n_out}-wide model output; "
                    "provide targets shaped [N, n_out] explicitly")
        return y

    @staticmethod
    def _as_model_function(module: KerasModule, spec: KerasSpec,
                           device) -> ModelFunction:
        """The trained module, in eval mode, as an inference
        ModelFunction (the wrapping of ``ModelIngest.fromKerasModel``)."""
        return ModelFunction(
            module.eval(),
            {"input": (tuple(spec.input_shape), np.dtype(spec.input_dtype))},
            spec.output_names, device=device,
            name=f"keras_trained:{spec.name}")

    # -- streaming training --------------------------------------------------

    @staticmethod
    def _streaming_fingerprint(est, uris, labels) -> str:
        """Checkpoint identity for a streaming trial, byte for byte the
        JAX package's: hyperparameters AND the (uri, label) manifest
        (Python values, as Arrow's ``to_pylist`` gives them there)."""
        import hashlib
        h = hashlib.sha256()
        h.update(_config_fingerprint_bytes(est))
        for u, lab in zip(uris, labels):
            # separators: 'img1',23 must not hash like 'img12',3
            h.update(str(u).encode() + b"\x1f")
            h.update(repr(lab).encode() + b"\x1e")
        return h.hexdigest()[:16]

    def _epoch_stream(self, loaded, label_col, batch_size,
                      n_out, loss, epoch_seed, shuffle,
                      num_steps: Optional[int] = None):
        """Yield uniform (xb, yb) training batches from the loaded
        frame's partition stream, one epoch's worth.

        Partition order is permuted per epoch (shuffle) and rows are
        permuted within each partition — an engine-friendly shuffle that
        never holds more than a partition plus one batch in memory. A
        partial final batch is filled cyclically from the epoch's first
        rows, matching the in-memory trainer's np.resize(order) wrap so
        every step sees a full batch.

        ``num_steps``: yield EXACTLY this many batches (multi-process
        mode: every process must take the same number of steps or the
        collective deadlocks) — the stream restarts over the frame if
        this process's shard runs dry before the quota, and stops early
        once met. ``None`` (one process) derives the step count from the
        data.
        """
        import collections

        rng = np.random.default_rng(epoch_seed)
        frame = loaded
        if shuffle:
            frame = loaded.with_partition_order(
                rng.permutation(loaded.num_partitions))

        # (xs, ys, offset) segments; emitting a batch slices views and
        # copies exactly batch_size rows — never the whole remainder
        parts: collections.deque = collections.deque()
        buffered = 0
        emitted = 0
        head_x = head_y = None  # first batch, kept for the cyclic tail

        def targets(y):
            return self._prepare_targets(np.asarray(y), loss, n_out)

        def emit(n_rows: int):
            nonlocal buffered
            xs_out, ys_out = [], []
            need = n_rows
            while need:
                xs, ys, off = parts[0]
                take = min(need, len(xs) - off)
                xs_out.append(xs[off:off + take])
                ys_out.append(ys[off:off + take])
                if off + take == len(xs):
                    parts.popleft()
                else:
                    parts[0] = (xs, ys, off + take)
                need -= take
            buffered -= n_rows
            return np.concatenate(xs_out), np.concatenate(ys_out)

        def tail_batch():
            """Assemble the final partial batch, wrapped cyclically."""
            X, y = emit(buffered)
            if head_x is None:
                # whole pass smaller than one batch: tile it (the
                # in-memory trainer's np.resize does the same)
                reps = -(-batch_size // len(X))
                X = np.concatenate([X] * reps)[:batch_size]
                y = np.concatenate([y] * reps)[:batch_size]
            else:
                pad = batch_size - len(X)
                X = np.concatenate([X, head_x[:pad]])
                y = np.concatenate([y, head_y[:pad]])
            return X, y

        while True:
            saw_rows = False
            for batch in frame.stream():
                xs = np.asarray(column_to_tensor(column(batch, _LOADED_COL)),
                                dtype=np.float32)
                ys = column_values(column(batch, label_col))
                if shuffle and len(xs) > 1:
                    perm = rng.permutation(len(xs))
                    xs, ys = xs[perm], ys[perm]
                if len(xs):
                    saw_rows = True
                    parts.append((xs, ys, 0))
                    buffered += len(xs)
                while buffered >= batch_size and (
                        num_steps is None or emitted < num_steps):
                    xb, yb = emit(batch_size)
                    if head_x is None:
                        head_x, head_y = xb, yb
                    emitted += 1
                    yield xb, targets(yb)
                if num_steps is not None and emitted >= num_steps:
                    return
            # one full pass over the frame is done
            if num_steps is None:
                if buffered:
                    X, y = tail_batch()
                    yield X, targets(y)
                return
            if emitted >= num_steps:
                return
            if not saw_rows and not buffered and head_x is None:
                raise ValueError(
                    "this process's data shard is empty; repartition the "
                    "dataset with at least one partition per process "
                    "(numPartitions >= process_count)")
            if buffered:
                X, y = tail_batch()
                emitted += 1
                yield X, targets(y)
                if emitted >= num_steps:
                    return
            # shard dry, quota unmet: stream it again (re-decode)

    def _trainStreaming(self, dataset, paramMap: dict, spec: KerasSpec,
                        mesh=None, checkpoint_tag: str = "fit",
                        spill_dir: Optional[str] = None
                        ) -> KerasImageFileModel:
        """Entry for one streaming trial: resolves the effective
        estimator and owns the decoded-spill directory's lifetime
        (created here when ``cacheDecoded`` and none was passed, removed
        on ANY exit — early validation failures included). A caller
        passing ``spill_dir`` (fitMultiple's shared trial cache) keeps
        ownership."""
        est = self.copy(paramMap) if paramMap else self
        if not est.getOrDefault("cacheDecoded"):
            spill_dir = None  # a trial override can disable the cache
        own_dir = None
        if spill_dir is None and est.getOrDefault("cacheDecoded"):
            import tempfile
            own_dir = spill_dir = tempfile.mkdtemp(
                prefix="sparkdl_tpu_torch_decoded_")
        try:
            return self._trainStreamingImpl(dataset, est, spec, mesh,
                                            spill_dir, checkpoint_tag)
        finally:
            if own_dir is not None:
                import shutil
                shutil.rmtree(own_dir, ignore_errors=True)

    def _trainStreamingImpl(self, dataset, est, spec: KerasSpec, mesh,
                            spill_dir: Optional[str],
                            checkpoint_tag: str) -> KerasImageFileModel:
        """Train one configuration by streaming decoded partitions
        through the engine — no one-process materialization of the
        image tensor (the reference's hard boundary, SURVEY §3.4).
        Epochs re-decode unless ``cacheDecoded``.

        Several processes (a global mesh of several ranks, after
        ``parallel.initialize``): each process streams only ITS
        round-robin partition shard and steps on its share of the global
        batch, and every process takes the same (globally derived)
        number of steps an epoch, so the collectives stay aligned.
        ``checkpointDir`` must then name a path every process reaches;
        process 0 writes, and a resumed run first agrees on the step."""
        t_fit = time.perf_counter()
        est._validateParams()
        fit_params = est.getKerasFitParams()
        epochs = int(fit_params.get("epochs", 1))
        shuffle = bool(fit_params.get("shuffle", True))
        seed = int(fit_params.get("seed", 0))
        mesh = mesh if est.getOrDefault("useMesh") else None

        from sparkdl_tpu_torch.parallel import distributed as dist
        info = dist.host_info()
        multihost = info.process_count > 1
        if multihost:
            if mesh is None:
                raise ValueError(
                    "multi-process streaming requires useMesh=True (the "
                    "global batch is laid out over the global mesh)")
            if dataset.num_partitions < info.process_count:
                # fail on EVERY process before any step — a mid-epoch
                # failure on one would leave the others blocked in their
                # first collective
                raise ValueError(
                    f"dataset has {dataset.num_partitions} partitions "
                    f"for {info.process_count} processes; repartition "
                    "with numPartitions >= process_count so every "
                    "process owns data")

        in_col, label_col = est.getInputCol(), est.getLabelCol()
        base = dataset.select(in_col, label_col)
        loaded = est.loadImagesInternal(base, in_col, _LOADED_COL)
        loaded_local = (dist.host_shard_dataframe(loaded) if multihost
                        else loaded)
        if spill_dir is not None:
            # epoch 1 decodes and spills THIS process's shard; later
            # epochs stream the cache — decode runs once per fit. The
            # directory's lifetime is owned by _trainStreaming or
            # fitMultiple.
            loaded_local = loaded_local.cache_to_disk(spill_dir)

        # cheap manifest (strings + labels): sizing + fingerprint, the
        # same on every process, so step counts agree everywhere;
        # collected per partition so shard emptiness is checkable
        part_batches = list(base.stream())
        uris = [u for b in part_batches for u in column(b, in_col).tolist()]
        labels_all = [v for b in part_batches
                      for v in column_values(column(b, label_col)).tolist()]
        n = len(uris)
        if n == 0:
            raise ValueError("cannot fit on an empty dataset")
        shard_rows: List[int] = []
        if multihost:
            counts = [num_rows(b) for b in part_batches]
            for host in range(info.process_count):
                owned = dist.host_shard_indices(
                    len(counts), host, info.process_count)
                shard_rows.append(sum(counts[i] for i in owned))
                if shard_rows[-1] == 0:
                    # the same computation on every process → every one
                    # raises here, before any step
                    raise ValueError(
                        f"process {host}'s partition shard holds 0 rows "
                        f"(partition sizes {counts}); repartition so "
                        "every process owns data")

        trial = _Trial(est, spec, mesh,
                       int(fit_params.get("batch_size", 32)), seed)
        n_out = int(spec.output_shapes[0][-1])
        batch_size = trial.batch_size
        if multihost:
            rows_per_step = batch_size // info.process_count
            if rows_per_step * info.process_count != batch_size:
                raise ValueError(
                    f"global batch {batch_size} does not split evenly "
                    f"across {info.process_count} processes; choose a "
                    "batch_size divisible by the process count")
            # per-epoch quota sized by the LARGEST shard, so every
            # process covers its whole shard each epoch (smaller shards
            # cycle); the same on every process
            steps_per_epoch = max(1, -(-max(shard_rows) // rows_per_step))
        else:
            rows_per_step = batch_size
            steps_per_epoch = None  # derived from the stream

        rng = np.random.default_rng(seed)
        start_epoch = trial.open_checkpoints(
            est, checkpoint_tag,
            lambda: self._streaming_fingerprint(est, uris, labels_all),
            epochs)
        # one seed drawn per epoch (skipped epochs burn theirs, so a
        # resumed run repeats the uninterrupted run's batch order)
        epoch_seeds = [int(s) for s in
                       rng.integers(0, 2**63 - 1, size=epochs)]

        for epoch in range(start_epoch, epochs):
            with span("epoch", lane="estimator", epoch=epoch,
                      streaming=True):
                losses = []
                for xb, yb in self._epoch_stream(
                        loaded_local, label_col, rows_per_step, n_out,
                        est.getKerasLoss(), epoch_seeds[epoch], shuffle,
                        num_steps=steps_per_epoch):
                    losses.append(trial.run_step(xb, yb))
                trial.history.append(_epoch_mean(losses, mesh))
            trial.save()
        trial.close()
        return self._model(est, trial, start_epoch, spec, t_fit)

    # -- Estimator interface -------------------------------------------------

    def _fit(self, dataset) -> KerasImageFileModel:
        self._validateParams()
        spec = self._read_spec()
        mesh = self._train_mesh() if self.getOrDefault("useMesh") else None
        if self.getOrDefault("streaming"):
            return self._trainStreaming(dataset, {}, spec, mesh)
        X, y = self._getNumpyFeaturesAndLabels(dataset)
        return self._trainOne(X, y, {}, spec, mesh)

    # params whose override changes the localized (X, y), not just the
    # training configuration
    _DATA_PARAMS = frozenset({"inputCol", "labelCol", "imageLoader"})

    def _trialData(self, dataset, paramMap: dict, shared):
        """The (X, y) for one trial: the shared localization unless the
        paramMap overrides a data param, in which case the trial
        re-localizes with its own columns/loader."""
        names = {p.name if isinstance(p, Param) else str(p)
                 for p in paramMap}
        if names & self._DATA_PARAMS:
            return self.copy(paramMap)._getNumpyFeaturesAndLabels(dataset)
        return shared

    def fitMultiple(self, dataset, paramMaps: Sequence[dict]):
        """Yield ``(index, model)`` as trials finish — data localized
        once (the reference's broadcast) unless a trial overrides a data
        param, the model file read once into a spec (unless a trial
        names another), trials dispatched concurrently (the reference's
        one-Spark-task-per-ParamMap). With ``streaming`` nothing is
        localized; each trial streams partitions through the (shared,
        thread-safe) engine, with the same ``parallelism`` bound."""
        self._validateParams()
        streaming = self.getOrDefault("streaming")
        shared = (None if streaming
                  else self._getNumpyFeaturesAndLabels(dataset))
        specs = {self.getModelFile(): self._read_spec()}
        trials = [self.copy(pm) if pm else self for pm in paramMaps]
        for est in trials:
            if est.getModelFile() not in specs:
                specs[est.getModelFile()] = est._read_spec()
        mesh = (self._train_mesh()
                if any(est.getOrDefault("useMesh") for est in trials)
                else None)
        parallelism = max(1, self.getOrDefault("parallelism"))
        from sparkdl_tpu_torch.parallel.distributed import host_info
        if host_info().process_count > 1 and parallelism > 1:
            # every process must launch its collectives in the SAME
            # order: racing trial threads would interleave differently
            # per process and deadlock
            logger.warning(
                "multi-process fitMultiple: running trials serially "
                "(parallelism=%d ignored) to keep the collectives' order "
                "identical in every process", parallelism)
            parallelism = 1

        # one decoded-spill cache SHARED by every trial that keeps the
        # data params — the cache depends only on (inputCol, labelCol,
        # imageLoader), so per-trial caches would re-decode the dataset
        # k times, exactly the cost cacheDecoded exists to remove.
        # Concurrent trials spilling the same partition are safe: a
        # temporary name then a rename, deterministic decode.
        def _keeps_data_params(pm) -> bool:
            names = {p.name if isinstance(p, Param) else str(p)
                     for p in pm}
            return not (names & self._DATA_PARAMS)

        shared_spill = None
        if streaming and self.getOrDefault("cacheDecoded") \
                and any(_keeps_data_params(pm) for pm in paramMaps):
            import tempfile
            shared_spill = tempfile.mkdtemp(
                prefix="sparkdl_tpu_torch_decoded_shared_")

        def trial(i, pm):
            spec = specs[trials[i].getModelFile()]
            if streaming:
                use_shared = (shared_spill if _keeps_data_params(pm)
                              else None)
                return self._trainStreaming(dataset, pm, spec, mesh,
                                            checkpoint_tag=f"trial_{i}",
                                            spill_dir=use_shared)
            X, y = self._trialData(dataset, pm, shared)
            return self._trainOne(X, y, pm, spec, mesh,
                                  checkpoint_tag=f"trial_{i}")

        try:
            if parallelism == 1 or len(paramMaps) <= 1:
                for i, pm in enumerate(paramMaps):
                    yield i, trial(i, pm)
                return

            with ThreadPoolExecutor(
                    max_workers=parallelism,
                    thread_name_prefix="sparkdl-tpu-torch-trial") as ex:
                futs = {ex.submit(trial, i, pm): i
                        for i, pm in enumerate(paramMaps)}
                from concurrent.futures import as_completed
                for fut in as_completed(futs):
                    yield futs[fut], fut.result()
        finally:
            if shared_spill is not None:
                import shutil
                shutil.rmtree(shared_spill, ignore_errors=True)
