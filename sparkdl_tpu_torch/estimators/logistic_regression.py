"""LogisticRegression: the classifier half of the transfer-learning flow —
counterpart of ``sparkdl_tpu/estimators/logistic_regression.py``.

A multinomial softmax classifier over a features vector column, trained
with Adam by torch on the estimator's device (the card unless
``device="cpu"``), returned as a Model that scores on the host in numpy
and appends a probability vector and a predicted label. The training
products are plain matrix products (``torch.matmul``), as the JAX
package's are outside any Pallas kernel.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from sparkdl_tpu_torch._device import resolve_device
from sparkdl_tpu_torch.data.frame import column, num_rows
from sparkdl_tpu_torch.data.tensors import (
    append_tensor_column,
    append_unique_column,
    column_to_tensor,
    column_values,
)
from sparkdl_tpu_torch.params import (
    HasDevice,
    HasLabelCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.params.pipeline import Estimator, Model

logger = logging.getLogger(__name__)


def _features(batch, col: str) -> np.ndarray:
    """A features column as float32 ``[N, D]`` (wider rows flattened)."""
    X = np.asarray(column_to_tensor(column(batch, col)), dtype=np.float32)
    return X.reshape(len(X), -1) if X.ndim != 2 and len(X) else X


class LogisticRegressionModel(Model):
    """Fitted coefficients; transform appends the predicted class label
    (``predictionCol``, float64, Spark MLlib's convention) and the
    softmax probability vector (``probabilityCol``, float32), computed on
    the host in numpy.

    ``fitStats`` (not saved) says how the fit went: its ``mode``
    (``full_batch``, ``minibatch`` or ``streaming``), ``device``,
    ``rows``, ``steps``, ``fit_s`` (the whole fit), ``estimate_s`` (the
    memory-budget estimate, which may run the upstream plan on an empty
    prototype), ``collect_s`` (collecting the frame, its upstream plan
    included; 0 when streaming), ``setup_s`` (the weights' copy to the
    device and the optimizer's construction: torch's first optimizer in a
    process imports ``torch._dynamo``), ``upload_s`` (the table's copy to the
    device) and
    ``train_s`` (the training loop up to the loss history's arrival on
    the host)."""

    featuresCol = Param("LogisticRegressionModel", "featuresCol",
                        "features vector column", TypeConverters.toString)
    predictionCol = Param("LogisticRegressionModel", "predictionCol",
                          "predicted class label column (float64)",
                          TypeConverters.toString)
    probabilityCol = Param("LogisticRegressionModel", "probabilityCol",
                           "output probability-vector column",
                           TypeConverters.toString)

    def __init__(self, coefficients: np.ndarray, intercept: np.ndarray,
                 featuresCol: str, predictionCol: str,
                 probabilityCol: str = "probability",
                 objectiveHistory: Optional[List[float]] = None):
        super().__init__()
        self.coefficients = np.asarray(coefficients)   # [D, C]
        self.intercept = np.asarray(intercept)         # [C]
        self._set(featuresCol=featuresCol, predictionCol=predictionCol,
                  probabilityCol=probabilityCol)
        self.objectiveHistory = objectiveHistory or []
        self.fitStats: dict = {}

    @property
    def numClasses(self) -> int:
        return self.coefficients.shape[1]

    @property
    def numFeatures(self) -> int:
        return self.coefficients.shape[0]

    @property
    def coefficientMatrix(self) -> np.ndarray:
        """pyspark's layouts: binomial is ONE signed-margin row
        ``[1, numFeatures]`` (class-1 row − class-0 row of the stored
        softmax weights); multinomial ``[numClasses, numFeatures]``. A
        copy."""
        if self.numClasses == 2:
            return (self.coefficients[:, 1]
                    - self.coefficients[:, 0])[None, :]
        return self.coefficients.T.copy()

    @property
    def interceptVector(self) -> np.ndarray:
        """Binomial: the length-1 signed-margin intercept; multinomial:
        length numClasses. A copy."""
        if self.numClasses == 2:
            return np.asarray([self.intercept[1] - self.intercept[0]])
        return self.intercept.copy()

    def _transform(self, dataset):
        W, b = self.coefficients, self.intercept
        feat = self.getOrDefault("featuresCol")
        pred_col = self.getOrDefault("predictionCol")
        prob_col = self.getOrDefault("probabilityCol")

        def apply(batch):
            X = _features(batch, feat)
            if not len(X):
                X = np.zeros((0, W.shape[0]), np.float32)
            logits = X @ W + b
            logits -= logits.max(-1, keepdims=True)
            e = np.exp(logits)
            probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
            batch = append_tensor_column(batch, prob_col, probs)
            return append_unique_column(batch, pred_col,
                                        probs.argmax(-1).astype(np.float64))

        return dataset.map_batches(apply, name=f"logreg({feat})")

    def copy(self, extra: Optional[dict] = None):
        that = super().copy(extra)
        that.objectiveHistory = list(self.objectiveHistory)
        return that

    def _extra_state(self):
        return {"coefficients": self.coefficients,
                "intercept": self.intercept,
                "objectiveHistory": [float(v)
                                     for v in self.objectiveHistory]}

    @classmethod
    def _from_saved(cls, params, extra, children):
        return cls(extra["coefficients"], extra["intercept"],
                   featuresCol=params.get("featuresCol", "features"),
                   predictionCol=params.get("predictionCol", "prediction"),
                   probabilityCol=params.get("probabilityCol",
                                             "probability"),
                   objectiveHistory=extra.get("objectiveHistory"))


def from_jax_params(W, b, featuresCol: str = "features",
                    predictionCol: str = "prediction",
                    probabilityCol: str = "probability"
                    ) -> LogisticRegressionModel:
    """The port's model from numpy ``W [D, C]`` and ``b [C]``, such as a
    JAX-fitted model's ``coefficients`` and ``intercept``."""
    return LogisticRegressionModel(
        np.asarray(W, np.float32), np.asarray(b, np.float32),
        featuresCol=featuresCol, predictionCol=predictionCol,
        probabilityCol=probabilityCol)


class _AdamTrainer:
    """``W [D, C]`` and ``b [C]`` on a device under torch's Adam with
    optax's defaults; the L2 term stays in the loss (Adam's
    ``weight_decay`` would add it to the gradient and decay ``b`` too).
    ``step`` returns the loss as a device tensor: nothing waits for the
    device inside the loop."""

    def __init__(self, W0, b0, device: torch.device, lr: float,
                 reg: float):
        t0 = time.perf_counter()
        self.W = torch.tensor(np.asarray(W0), dtype=torch.float32,
                              device=device, requires_grad=True)
        self.b = torch.tensor(np.asarray(b0), dtype=torch.float32,
                              device=device, requires_grad=True)
        self.opt = torch.optim.Adam([self.W, self.b], lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.reg = reg
        self.setup_s = time.perf_counter() - t0

    def step(self, X: torch.Tensor, Y: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on rows ``X``, one-hot ``Y`` and row weights ``w``
        (None: the plain mean)."""
        self.opt.zero_grad()
        logits = X @ self.W + self.b
        ce = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
        loss = ce.mean() if w is None else (ce * w).sum() / w.sum()
        loss = loss + self.reg * (self.W * self.W).sum()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def result(self):
        return (self.W.detach().cpu().numpy(),
                self.b.detach().cpu().numpy())


def _pad_batch(xb: np.ndarray, yb: np.ndarray, bs: int):
    """A ragged minibatch padded to ``bs`` rows of weight 0."""
    wb = np.ones(len(xb), np.float32)
    pad = bs - len(xb)
    if pad:
        xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
        wb = np.concatenate([wb, np.zeros(pad, np.float32)])
    return xb, yb, wb


def _epoch_loss(losses: List[torch.Tensor]) -> float:
    """An epoch's mean step loss, after the epoch's one wait for the
    device."""
    return float(np.mean(torch.stack(losses).cpu().numpy()))


class LogisticRegression(Estimator, HasLabelCol, HasDevice):
    """Multinomial logistic regression on a features vector column.

    Params follow Spark MLlib's names where they map (``featuresCol``,
    ``labelCol``, ``predictionCol``, ``maxIter``, ``regParam`` for L2);
    training is Adam on ``device`` (None: the card, which raises without
    one).

    ``batchSize=0`` (default) trains full-batch: the table is copied to
    the device once and stays there, and ``maxIter`` counts steps. A
    positive ``batchSize`` takes shuffled minibatches from the host
    table instead, and ``maxIter`` counts epochs. ``streaming=True``
    (with ``batchSize > 0``) assembles the minibatches from the
    partition stream, so the table is never collected: one partition
    and one minibatch at a time, epochs permuting partition order and
    rows within each partition. ``numClasses=0`` infers the class count
    (streaming: with one labels-only pass over the frame).

    A frame whose feature table is known, without running a partition,
    to exceed ``memoryBudgetBytes`` switches to the streaming fit with
    a warning (0 disables the switch); a collected fit warns once it has
    buffered more than the budget. A CUDA out-of-memory error raises.
    """

    featuresCol = Param("LogisticRegression", "featuresCol",
                        "features vector column", TypeConverters.toString)
    predictionCol = Param("LogisticRegression", "predictionCol",
                          "predicted class label column (float64)",
                          TypeConverters.toString)
    probabilityCol = Param("LogisticRegression", "probabilityCol",
                           "output probability-vector column",
                           TypeConverters.toString)
    maxIter = Param("LogisticRegression", "maxIter",
                    "training iterations (minibatch mode: epochs)",
                    TypeConverters.toInt)
    batchSize = Param("LogisticRegression", "batchSize",
                      "minibatch size; 0 = full-batch",
                      TypeConverters.toInt)
    regParam = Param("LogisticRegression", "regParam",
                     "L2 regularization strength", TypeConverters.toFloat)
    learningRate = Param("LogisticRegression", "learningRate",
                         "adam learning rate", TypeConverters.toFloat)
    seed = Param("LogisticRegression", "seed", "init seed",
                 TypeConverters.toInt)
    streaming = Param("LogisticRegression", "streaming",
                      "assemble minibatches from the partition stream "
                      "(never collect the feature table)",
                      TypeConverters.toBoolean)
    numClasses = Param("LogisticRegression", "numClasses",
                       "class count; 0 = infer (streaming mode: with "
                       "one labels-only pass)", TypeConverters.toInt)
    memoryBudgetBytes = Param(
        "LogisticRegression", "memoryBudgetBytes",
        "feature-matrix size above which fit() auto-switches to the "
        "streaming path instead of collecting (0 disables)",
        TypeConverters.toInt)

    # the batch of an auto-switched streaming fit when batchSize is 0
    _AUTO_STREAM_BATCH = 4096
    _DEFAULT_BUDGET = 1 << 30  # 1 GiB of f32 features

    @keyword_only
    def __init__(self, *, featuresCol="features", labelCol="label",
                 predictionCol="prediction", probabilityCol="probability",
                 maxIter=100, regParam=0.0, learningRate=0.1, seed=0,
                 batchSize=0, streaming=False, numClasses=0,
                 memoryBudgetBytes=_DEFAULT_BUDGET, device=None):
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         probabilityCol="probability", maxIter=100,
                         regParam=0.0, learningRate=0.1, seed=0,
                         batchSize=0, streaming=False, numClasses=0,
                         memoryBudgetBytes=self._DEFAULT_BUDGET,
                         device=None)
        self._set(featuresCol=featuresCol, labelCol=labelCol,
                  predictionCol=predictionCol,
                  probabilityCol=probabilityCol, maxIter=maxIter,
                  regParam=regParam, learningRate=learningRate, seed=seed,
                  batchSize=batchSize, streaming=streaming,
                  numClasses=numClasses,
                  memoryBudgetBytes=memoryBudgetBytes, device=device)

    @staticmethod
    def _clean_labels(y: np.ndarray) -> np.ndarray:
        """Validate a label array (Spark conventions) → int64 ids."""
        if y.ndim != 1:
            raise ValueError(
                f"labelCol must hold scalar class ids, got shape "
                f"{y.shape}")
        if np.issubdtype(y.dtype, np.floating):
            # Spark ML labels are doubles holding integral class ids
            if len(y) and not (y == np.round(y)).all():
                i = int(np.flatnonzero(y != np.round(y))[0])
                raise ValueError(
                    f"labelCol must hold integral class ids; row {i} "
                    f"is {y[i]!r}")
            y = y.astype(np.int64)
        elif not np.issubdtype(y.dtype, np.integer):
            raise ValueError(
                f"labelCol must hold integer class ids, got dtype "
                f"{y.dtype} shape {y.shape}")
        if len(y) and y.min() < 0:
            raise ValueError(
                f"labelCol must hold class ids in [0, C); got minimum "
                f"{y.min()} (re-encode e.g. {{-1,1}} labels to {{0,1}})")
        return y

    def _init_params(self, n_features: int, n_classes: int):
        """The initial ``(W [D, C], b [C])``, drawn on the CPU from a
        generator seeded with ``seed``, so a fit on the card and one on
        the CPU start from the same bits."""
        g = torch.Generator().manual_seed(self.getOrDefault("seed"))
        W = torch.randn((n_features, n_classes), generator=g,
                        dtype=torch.float32) * 0.01
        return W, torch.zeros(n_classes, dtype=torch.float32)

    def _trainer(self, n_features: int, n_classes: int,
                 device: torch.device) -> _AdamTrainer:
        W0, b0 = self._init_params(n_features, n_classes)
        return _AdamTrainer(W0, b0, device,
                            float(self.getOrDefault("learningRate")),
                            float(self.getOrDefault("regParam")))

    def _estimate_feature_bytes(self, dataset, feat: str
                                ) -> Optional[int]:
        """The f32 feature-matrix size a collected fit would build, or
        None when it cannot be known without running a partition: the
        row count must be known and the schema probe free (in-memory
        frames), and the features column a numeric ``[N, *shape]``."""
        rows = dataset.known_count()
        if not rows or not dataset.schema_probe_free:
            return None
        try:
            proto = column(dataset.schema, feat)
        except Exception:
            # advisory only: a missing column or a stage that refuses
            # the empty prototype fails again, clearly, in the fit
            return None
        shape = proto.shape[1:]
        if proto.dtype == object or not shape:
            return None
        return rows * int(np.prod(shape)) * 4

    def _fit(self, dataset) -> LogisticRegressionModel:
        t_fit = time.perf_counter()
        device = resolve_device(self.getDevice())
        feat = self.getOrDefault("featuresCol")
        bs = int(self.getOrDefault("batchSize") or 0)
        streaming = bool(self.getOrDefault("streaming"))
        budget = int(self.getOrDefault("memoryBudgetBytes") or 0)
        if streaming and bs <= 0:
            raise ValueError(
                "streaming=True requires batchSize > 0 (streamed "
                "minibatches need a static batch shape)")
        t_est = time.perf_counter()
        est = None
        if not streaming and budget > 0:
            est = self._estimate_feature_bytes(dataset, feat)
        estimate_s = time.perf_counter() - t_est
        if est is not None and est > budget:
            bs = bs or self._AUTO_STREAM_BATCH
            logger.warning(
                "feature matrix ≈%.1f GiB exceeds "
                "memoryBudgetBytes=%.1f GiB; auto-switching to the "
                "streaming fit (batchSize=%d, maxIter counts "
                "EPOCHS). Set streaming=True explicitly to choose "
                "your own batch, or raise memoryBudgetBytes to "
                "collect anyway.",
                est / 2**30, budget / 2**30, bs)
            streaming = True
        if streaming:
            trainer, history, stats = self._run_streaming(dataset, feat, bs,
                                                          device)
            stats["estimate_s"] = estimate_s
            return self._model(trainer, history, stats, t_fit)

        # collect once: the upstream plan (the featurizer) runs here;
        # the byte watchdog warns when a frame whose size was not known
        # up front outgrows the budget
        seen = {"bytes": 0, "warned": False}

        def _watch(b):
            seen["bytes"] += sum(v.nbytes for v in b.values())
            if budget > 0 and seen["bytes"] > budget \
                    and not seen["warned"]:
                seen["warned"] = True
                logger.warning(
                    "collected fit has already buffered %.1f GiB "
                    "(memoryBudgetBytes=%.1f GiB) and the frame isn't "
                    "finished; use streaming=True (with batchSize) to "
                    "fit without materializing the feature table",
                    seen["bytes"] / 2**30, budget / 2**30)

        t0 = time.perf_counter()
        table = dataset.collect(on_batch=_watch)
        collect_s = time.perf_counter() - t0
        if not table or num_rows(table) == 0:
            raise ValueError("cannot fit on an empty dataset")
        X = _features(table, feat)
        y = self._clean_labels(column_values(
            column(table, self.getLabelCol())))
        declared = int(self.getOrDefault("numClasses"))
        if declared > 0:
            # a declared class count is a promise, not a floor
            if int(y.max()) >= declared:
                raise ValueError(
                    f"label {int(y.max())} out of range for "
                    f"numClasses={declared}")
            n_classes = max(declared, 2)
        else:
            n_classes = max(int(y.max()) + 1, 2)
        onehot = np.eye(n_classes, dtype=np.float32)[y]
        trainer = self._trainer(X.shape[1], n_classes, device)
        if 0 < bs < len(X):
            history, stats = self._run_minibatch(trainer, X, onehot, bs,
                                                 device)
        else:
            history, stats = self._run_full_batch(trainer, X, onehot,
                                                  device)
        stats.update(collect_s=collect_s, estimate_s=estimate_s)
        return self._model(trainer, history, stats, t_fit)

    def _model(self, trainer: _AdamTrainer, history, stats, t_fit: float
               ) -> LogisticRegressionModel:
        W, b = trainer.result()
        model = LogisticRegressionModel(
            W, b, featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            probabilityCol=self.getOrDefault("probabilityCol"),
            objectiveHistory=history)
        model.fitStats = {"device": str(trainer.W.device), **stats,
                          "setup_s": trainer.setup_s,
                          "fit_s": time.perf_counter() - t_fit}
        return model

    def _run_full_batch(self, trainer: _AdamTrainer, X, onehot, device):
        """One resident device copy of the table; ``maxIter`` steps. The
        loss history leaves the device once, at the end."""
        t0 = time.perf_counter()
        Xd = torch.from_numpy(X).to(device)
        Yd = torch.from_numpy(onehot).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        losses = [trainer.step(Xd, Yd)
                  for _ in range(self.getOrDefault("maxIter"))]
        history = torch.stack(losses).cpu().tolist() if losses else []
        return history, {"mode": "full_batch", "rows": len(X),
                         "steps": len(losses), "upload_s": t1 - t0,
                         "train_s": time.perf_counter() - t1}

    def _run_minibatch(self, trainer: _AdamTrainer, X, onehot, bs: int,
                       device):
        """Shuffled host minibatches (the JAX package's permutations,
        from ``np.random.default_rng(seed)``) copied to the device one
        at a time; ``maxIter`` counts epochs, the history holds each
        epoch's mean loss, and the ragged tail pads with weight-0 rows."""
        n = len(X)
        rng = np.random.default_rng(self.getOrDefault("seed"))
        history = []
        steps = 0
        t0 = time.perf_counter()
        for _ in range(self.getOrDefault("maxIter")):
            perm = rng.permutation(n)
            losses = []
            for lo in range(0, n, bs):
                idx = perm[lo:lo + bs]
                xb, yb, wb = _pad_batch(X[idx], onehot[idx], bs)
                losses.append(trainer.step(
                    *(torch.from_numpy(a).to(device) for a in (xb, yb, wb))))
            steps += len(losses)
            history.append(_epoch_loss(losses))
        return history, {"mode": "minibatch", "rows": n, "steps": steps,
                         "upload_s": 0.0,
                         "train_s": time.perf_counter() - t0}

    def _run_streaming(self, dataset, feat: str, bs: int, device):
        """Minibatches assembled from the partition stream: the table is
        never collected. Each epoch permutes partition order and the
        rows of each partition (from ``np.random.default_rng(seed)``, as
        the JAX package draws them) and pads the ragged tail with
        weight-0 rows."""
        label_col = self.getLabelCol()
        declared = int(self.getOrDefault("numClasses"))
        if declared <= 0:
            # labels-only pass: one int a row, never the features
            seen = -1
            for batch in dataset.select(label_col).stream():
                y = self._clean_labels(column_values(batch[label_col]))
                if len(y):
                    seen = max(seen, int(y.max()))
            if seen < 0:
                raise ValueError("cannot fit on an empty dataset")
            declared = seen + 1
        # a 1-class declaration widens to 2 as in the collected path; the
        # range checks stay against `declared`
        n_classes = max(declared, 2)
        eye = np.eye(n_classes, dtype=np.float32)

        rng = np.random.default_rng(self.getOrDefault("seed"))
        trainer: Optional[_AdamTrainer] = None
        history = []
        rows = steps = 0
        t0 = time.perf_counter()
        for _ in range(self.getOrDefault("maxIter")):
            frame = dataset.with_partition_order(
                rng.permutation(dataset.num_partitions))
            parts: collections.deque = collections.deque()
            buffered = 0
            losses = []

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

            def run_step(xb, yb):
                nonlocal trainer
                if trainer is None:
                    trainer = self._trainer(xb.shape[1], n_classes, device)
                xb, yb, wb = _pad_batch(xb, yb, bs)
                losses.append(trainer.step(
                    *(torch.from_numpy(a).to(device) for a in (xb, yb, wb))))

            epoch_rows = 0
            for batch in frame.stream():
                if num_rows(batch) == 0:
                    continue
                xs = _features(batch, feat)
                y = self._clean_labels(column_values(
                    column(batch, label_col)))
                if len(y) and int(y.max()) >= declared:
                    raise ValueError(
                        f"label {int(y.max())} out of range for "
                        f"numClasses={declared}")
                perm = rng.permutation(len(xs))
                parts.append((xs[perm], eye[y][perm], 0))
                buffered += len(xs)
                epoch_rows += len(xs)
                while buffered >= bs:
                    run_step(*emit(bs))
            if buffered:
                run_step(*emit(buffered))
            if not epoch_rows:
                raise ValueError("cannot fit on an empty dataset")
            rows = epoch_rows
            steps += len(losses)
            history.append(_epoch_loss(losses))
        if trainer is None:
            raise ValueError(
                "no training steps ran (empty dataset or maxIter=0)")
        return trainer, history, {
            "mode": "streaming", "rows": rows, "steps": steps,
            "collect_s": 0.0, "upload_s": 0.0,
            "train_s": time.perf_counter() - t0}
