"""Evaluators for CrossValidator / TrainValidationSplit scoring —
counterpart of ``sparkdl_tpu/estimators/evaluators.py``: pyspark's
evaluator semantics over a scored frame's prediction and label columns,
in numpy on the host. Each evaluator streams: batches reduce into
sufficient statistics, so the scored frame is never collected.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sparkdl_tpu_torch.data.frame import column, num_rows
from sparkdl_tpu_torch.data.tensors import column_to_tensor, column_values
from sparkdl_tpu_torch.params.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.params.pipeline import EmptyScoredFrameError, Evaluator


def _pred_and_labels(batch, predictionCol: str, labelCol: str):
    """(preds, labels) arrays of one batch."""
    preds = np.asarray(column_to_tensor(column(batch, predictionCol)))
    return preds, column_values(column(batch, labelCol))


def _check_finite(arr: np.ndarray, col: str, what: str) -> None:
    """NaN/Inf in a scored column is a diverged model or a broken
    upstream transform — scoring them as ordinary values returns
    plausible-looking garbage (all-NaN predictions measured accuracy
    0.5 and AUC 0.5, numbers a CV could SELECT on). Refuse loudly.
    No copies on the hot path: floats are checked in their own dtype;
    integers are finite by construction; only object arrays (pylist
    labels) pay a cast."""
    if not arr.size:
        return
    kind = arr.dtype.kind
    if kind in "iub":
        return
    if kind in "fc":
        ok = bool(np.isfinite(arr).all())
    else:
        ok = bool(np.isfinite(np.asarray(arr, dtype=np.float64)).all())
    if not ok:
        raise ValueError(
            f"column {col!r} contains non-finite {what} (NaN/Inf — "
            "diverged model or broken upstream transform); refusing "
            "to score them as ordinary values")


def _stream_pred_and_labels(dataset, predictionCol: str, labelCol: str):
    """Per-batch (preds, labels) pairs from the partition stream —
    evaluators accumulate sufficient statistics batch by batch, so the
    scored table is never held whole in memory. Non-finite values raise
    per batch (:func:`_check_finite`)."""
    for batch in dataset.stream():
        if num_rows(batch):
            preds, labels = _pred_and_labels(batch, predictionCol,
                                             labelCol)
            _check_finite(preds, predictionCol, "predictions")
            _check_finite(labels, labelCol, "labels")
            yield preds, labels


_CLS_METRICS = ("accuracy", "f1", "weightedPrecision", "weightedRecall")
_PRED_SEMANTICS = ("auto", "labels", "probabilities")
# 'labels' is invalid for LossEvaluator: cross-entropy on class labels
# is meaningless
_LOSS_SEMANTICS = ("auto", "probabilities")


def _gather_deferred(preds_parts, labels_parts):
    """THE whole-column gather: 'auto' scalar semantics defer to here.
    One named seam so tests can prove the declared-semantics path never
    reaches it (two SCALAR arrays — vectors never defer)."""
    return np.concatenate(preds_parts), np.concatenate(labels_parts)


def _binary_scalar_loss(preds: np.ndarray,
                        labels: np.ndarray) -> Tuple[float, int]:
    """(sum of -log p_picked, count) for scalar binary P(class 1) —
    shared by the streaming (declared-semantics) and gathered (auto)
    paths so their clip/threshold semantics can never diverge."""
    p = np.clip(preds, 1e-7, 1.0 - 1e-7)
    y = labels.astype(np.float64)
    picked = np.where(y > 0.5, p, 1.0 - p)
    return float(-np.log(picked).sum()), len(picked)


def _scalar_pred_ids(preds: np.ndarray, semantics: str,
                     col: str) -> np.ndarray:
    """Scalar predictions → class ids under a DECLARED semantic:
    ``labels`` casts (values are class ids), ``probabilities``
    thresholds at 0.5 (binary P(class 1)). Values that contradict the
    declaration raise — scoring a mis-wired column under a declared
    semantic would silently return a plausible metric."""
    if semantics == "labels":
        if preds.size and not np.all(preds == np.round(preds)):
            raise ValueError(
                f"column {col!r} holds non-integral values but "
                "predictionSemantics='labels'; use 'probabilities' "
                "for binary score columns")
        return preds.astype(np.int64)
    if preds.size and (preds.min() < 0.0 or preds.max() > 1.0):
        raise ValueError(
            f"column {col!r} holds values outside [0, 1] but "
            "predictionSemantics='probabilities'; use 'labels' for "
            "class-id columns")
    return (preds > 0.5).astype(np.int64)


class ClassificationEvaluator(Evaluator):
    """Scores argmax(prediction vector) — or a class-label column — vs
    an integer (or one-hot) label column. ``metricName`` follows
    pyspark's MulticlassClassificationEvaluator: ``accuracy`` (default),
    ``f1`` / ``weightedPrecision`` / ``weightedRecall`` (per-class
    values weighted by true-class support). Larger is better.

    Evaluation STREAMS: each partition batch reduces into a confusion
    matrix, so scoring a frame holds one batch (not the table of
    prediction vectors) in memory — all four metrics are confusion
    functions, so this is exact, not approximate. The one case that
    gathers a column is scalar predictions under the default
    ``predictionSemantics="auto"``, whose "class labels or
    probabilities?" disambiguation is a whole-column property (a batch
    of saturated 0.0/1.0 probabilities is indistinguishable from binary
    labels); that gathers two scalar arrays, never vectors. Declaring
    the semantic — ``predictionSemantics="labels"`` (class ids, e.g.
    LogisticRegressionModel's predictionCol) or ``"probabilities"``
    (binary P(class 1), thresholded at 0.5) — removes the gather and
    keeps scalar scoring fully streaming."""

    predictionCol = Param("ClassificationEvaluator", "predictionCol",
                          "prediction vector column",
                          TypeConverters.toString)
    labelCol = Param("ClassificationEvaluator", "labelCol", "label column",
                     TypeConverters.toString)
    metricName = Param("ClassificationEvaluator", "metricName",
                       f"one of {_CLS_METRICS}", TypeConverters.toString)
    predictionSemantics = Param(
        "ClassificationEvaluator", "predictionSemantics",
        f"scalar-prediction semantic, one of {_PRED_SEMANTICS}",
        TypeConverters.toString)

    @keyword_only
    def __init__(self, *, predictionCol="prediction", labelCol="label",
                 metricName="accuracy", predictionSemantics="auto"):
        super().__init__()
        self._setDefault(predictionCol="prediction", labelCol="label",
                         metricName="accuracy", predictionSemantics="auto")
        self._set(predictionCol=predictionCol, labelCol=labelCol,
                  metricName=metricName,
                  predictionSemantics=predictionSemantics)
        if self.getOrDefault("metricName") not in _CLS_METRICS:
            raise ValueError(
                f"metricName must be one of {_CLS_METRICS}, got "
                f"{metricName!r}")
        if self.getOrDefault("predictionSemantics") not in _PRED_SEMANTICS:
            raise ValueError(
                f"predictionSemantics must be one of {_PRED_SEMANTICS}, "
                f"got {predictionSemantics!r}")

    def _evaluate(self, dataset) -> float:
        metric = self.getOrDefault("metricName")
        if metric not in _CLS_METRICS:
            # re-validate here too: set()/copy(extra) bypass __init__,
            # and _metric_from_confusion's dispatch must never silently
            # treat an unknown name as f1
            raise ValueError(
                f"metricName must be one of {_CLS_METRICS}, got "
                f"{metric!r}")
        semantics = self.getOrDefault("predictionSemantics")
        if semantics not in _PRED_SEMANTICS:
            raise ValueError(
                f"predictionSemantics must be one of {_PRED_SEMANTICS}, "
                f"got {semantics!r}")
        pred_col = self.getOrDefault("predictionCol")
        conf: dict = {}  # (pred_id, label_id) -> count; SPARSE so
        # large un-reindexed ids never allocate a dense id²-sized matrix
        scalar_preds, scalar_labels = [], []
        for preds, labels in _stream_pred_and_labels(
                dataset, pred_col, self.getOrDefault("labelCol")):
            if labels.ndim > 1:  # one-hot labels
                labels = labels.argmax(-1)
            labels = labels.astype(np.int64)
            if preds.ndim > 1 and preds.shape[-1] == 1:
                preds = preds[..., 0]  # (N,1) sigmoid outputs → binary
            if preds.ndim == 1:
                if semantics != "auto":
                    # declared semantic: reduce this batch into the
                    # confusion counts now — nothing is gathered
                    _accumulate_confusion(
                        conf,
                        _scalar_pred_ids(preds, semantics, pred_col),
                        labels)
                else:
                    # "class labels vs probabilities" is a whole-column
                    # decision (a batch of saturated 0.0/1.0
                    # probabilities is indistinguishable from binary
                    # labels) — defer; scalars only, never vectors
                    scalar_preds.append(preds)
                    scalar_labels.append(labels)
            else:
                _accumulate_confusion(conf, preds.argmax(-1), labels)
        if scalar_preds:
            preds, labels = _gather_deferred(scalar_preds, scalar_labels)
            if np.all(preds == np.round(preds)):
                # integral values: already class labels (e.g.
                # LogisticRegressionModel's predictionCol)
                pred_ids = preds.astype(np.int64)
            else:
                if preds.min() < 0.0 or preds.max() > 1.0:
                    # non-integral AND outside [0,1]: neither class
                    # labels nor probabilities — raw scores/margins
                    # mistakenly wired in; thresholding them at 0.5
                    # would return a plausible metric (the declared-
                    # semantics and vector paths both refuse this)
                    raise ValueError(
                        f"column "
                        f"{self.getOrDefault('predictionCol')!r} "
                        "holds non-integral values outside [0, 1] "
                        "(raw scores?): neither class labels nor "
                        "probabilities — point predictionCol at the "
                        "prediction or probability column")
                pred_ids = (preds > 0.5).astype(np.int64)
            _accumulate_confusion(conf, pred_ids, labels)
        return _metric_from_confusion(conf, metric)


def _accumulate_confusion(conf: dict, pred_ids: np.ndarray,
                          labels: np.ndarray) -> None:
    """Add one batch's (pred, label) pairs into the sparse
    ``conf[(pred, label)]`` counts — vectorized per batch via a
    pair-unique, with memory O(distinct pairs), never O(max_id²)."""
    if len(pred_ids) == 0:
        return
    pairs = np.stack([pred_ids, labels])
    uniq, counts = np.unique(pairs, axis=1, return_counts=True)
    for p, l, c in zip(uniq[0].tolist(), uniq[1].tolist(),
                       counts.tolist()):
        conf[(p, l)] = conf.get((p, l), 0) + c


def _metric_from_confusion(conf: dict, metric: str) -> float:
    """Support-weighted precision / recall / f1 (or accuracy) from
    sparse ``conf[(pred, label)]`` counts — pyspark semantics: each
    class present in the labels contributes weighted by its true count;
    a class never predicted contributes precision 0."""
    total = sum(conf.values())
    if total == 0:
        # one convention across all three evaluators: an empty scored
        # frame RAISES, matching
        # BinaryClassificationEvaluator — a CV fold whose validation
        # side filtered every row out must not silently score 0.0.
        # Typed so CrossValidator can nan-skip the fold (loudly).
        raise EmptyScoredFrameError(
            "cannot evaluate an empty scored frame (0 rows with "
            "predictions and labels); check upstream filters/folds")
    if metric == "accuracy":
        correct = sum(c for (p, l), c in conf.items() if p == l)
        return float(correct / total)
    pred_totals: dict = {}
    label_totals: dict = {}
    for (p, l), c in conf.items():
        pred_totals[p] = pred_totals.get(p, 0) + c
        label_totals[l] = label_totals.get(l, 0) + c
    out = 0.0
    for c_id, support in label_totals.items():  # classes in the labels
        tp = float(conf.get((c_id, c_id), 0))
        fp = float(pred_totals.get(c_id, 0)) - tp
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / support if support else 0.0
        if metric == "weightedPrecision":
            value = precision
        elif metric == "weightedRecall":
            value = recall
        else:  # f1
            value = (2 * precision * recall / (precision + recall)
                     if precision + recall else 0.0)
        out += value * support / total
    return float(out)


_BIN_METRICS = ("areaUnderROC", "areaUnderPR")


class BinaryClassificationEvaluator(Evaluator):
    """Threshold-free binary ranking metrics over a score column — the
    evaluator the reference README's transfer-learning example composed
    with (pyspark ``BinaryClassificationEvaluator``). ``metricName``:
    ``areaUnderROC`` (default; rank statistic with average-rank tie
    handling) or ``areaUnderPR`` (average precision). The score column
    may be a scalar score, an (N,1) sigmoid output, or an (N,2)
    probability vector (class-1 column used). Labels must be binary
    {0,1}. Larger is better.

    ``rawPredictionCol`` defaults to ``"rawPrediction"`` (pyspark's
    default, for drop-in parity); when that column is absent the
    evaluator accepts ``"probability"`` — the column this build's
    LogisticRegressionModel writes, and a monotone transform of the
    margin, so both ranking metrics agree.

    Evaluation STREAMS: batches reduce into per-distinct-score
    (positives, negatives) counts — the exact sufficient statistic both
    rank metrics are computed from — so the scored table is never held
    whole in driver memory."""

    rawPredictionCol = Param("BinaryClassificationEvaluator",
                             "rawPredictionCol",
                             "score / probability column",
                             TypeConverters.toString)
    labelCol = Param("BinaryClassificationEvaluator", "labelCol",
                     "binary label column", TypeConverters.toString)
    metricName = Param("BinaryClassificationEvaluator", "metricName",
                       f"one of {_BIN_METRICS}", TypeConverters.toString)

    @keyword_only
    def __init__(self, *, rawPredictionCol="rawPrediction",
                 labelCol="label", metricName="areaUnderROC"):
        super().__init__()
        self._setDefault(rawPredictionCol="rawPrediction",
                         labelCol="label", metricName="areaUnderROC")
        self._set(rawPredictionCol=rawPredictionCol, labelCol=labelCol,
                  metricName=metricName)
        if self.getOrDefault("metricName") not in _BIN_METRICS:
            raise ValueError(
                f"metricName must be one of {_BIN_METRICS}, got "
                f"{metricName!r}")

    def _score_column(self, batch) -> str:
        """Resolve against the first streamed batch's columns (not
        dataset.columns, whose schema probe may load partition 0)."""
        col = self.getOrDefault("rawPredictionCol")
        names = set(batch)
        if (col == "rawPrediction" and col not in names
                and "probability" in names):
            # default fallback: this build's LR head writes
            # 'probability'; a monotone transform of the raw margin, so
            # both ranking metrics are identical on either column.
            # (keyword_only _sets the default kwarg, so explicit vs
            # unset is indistinguishable here — warn once per instance,
            # naming the substitution, in case a real column was meant.)
            if not getattr(self, "_warned_prob_fallback", False):
                self._warned_prob_fallback = True
                import logging
                logging.getLogger(__name__).warning(
                    "BinaryClassificationEvaluator: no 'rawPrediction' "
                    "column; scoring 'probability' instead (set "
                    "rawPredictionCol explicitly to silence)")
            return "probability"
        return col  # let the column-lookup error name the missing col

    def _evaluate(self, dataset) -> float:
        metric = self.getOrDefault("metricName")
        if metric not in _BIN_METRICS:
            raise ValueError(
                f"metricName must be one of {_BIN_METRICS}, got "
                f"{metric!r}")
        label_col = self.getOrDefault("labelCol")
        # Streaming rank statistics: each batch reduces (vectorized, no
        # per-row Python) into (distinct score, positives, negatives)
        # arrays; one final np.unique merges the per-batch groups. Both
        # metrics are exact functions of that grouped form — the same
        # grouping the collected implementation used via np.unique —
        # and the held state is three flat scalar arrays bounded by the
        # per-batch distinct counts, never the scored table.
        score_col = None
        uniq_parts, pos_parts, neg_parts = [], [], []
        for batch in dataset.stream():
            if num_rows(batch) == 0:
                continue
            if score_col is None:
                score_col = self._score_column(batch)
            scores, labels = _pred_and_labels(batch, score_col,
                                              label_col)
            _check_finite(scores, score_col, "scores")
            _check_finite(labels, label_col, "labels")
            if scores.ndim > 1:
                if scores.shape[-1] == 1:
                    scores = scores[..., 0]
                elif scores.shape[-1] == 2:
                    scores = scores[..., 1]  # P(class 1)
                else:
                    raise ValueError(
                        f"binary evaluator needs scalar / (N,1) / "
                        f"(N,2) scores, got shape {scores.shape}")
            if labels.ndim > 1:
                labels = labels.argmax(-1)
            uniq_l = set(np.unique(labels).tolist())
            if not uniq_l <= {0, 1}:
                raise ValueError(
                    f"labels must be binary 0/1, got values "
                    f"{sorted(uniq_l)}")
            labels = labels.astype(np.int64)
            uniq, inv = np.unique(np.asarray(scores, np.float64),
                                  return_inverse=True)
            uniq_parts.append(uniq)
            pos_parts.append(np.bincount(inv, weights=(labels == 1),
                                         minlength=len(uniq)))
            neg_parts.append(np.bincount(inv, weights=(labels == 0),
                                         minlength=len(uniq)))
        if not uniq_parts:
            raise EmptyScoredFrameError(
                "cannot evaluate an empty scored frame (0 rows — e.g. "
                "a validation fold that filtered every row out)")
        merged, inv = np.unique(np.concatenate(uniq_parts),
                                return_inverse=True)
        pos_g = np.bincount(inv, weights=np.concatenate(pos_parts),
                            minlength=len(merged))
        neg_g = np.bincount(inv, weights=np.concatenate(neg_parts),
                            minlength=len(merged))
        n_pos, n_neg = int(pos_g.sum()), int(neg_g.sum())
        if n_pos == 0 or n_neg == 0:
            raise ValueError(
                "AUC is undefined with a single class present "
                f"({n_pos} positives / {n_neg} negatives)")
        if metric == "areaUnderROC":
            return _roc_auc_grouped(pos_g, neg_g, n_pos, n_neg)
        return _average_precision_grouped(pos_g, neg_g, n_pos)


def _roc_auc_grouped(pos_g, neg_g, n_pos: int, n_neg: int) -> float:
    """Mann-Whitney U ROC-AUC with average ranks for ties, from
    (per-distinct-score ascending) positive/negative counts."""
    c = pos_g + neg_g
    ends = np.cumsum(c)                      # 1-based group end rank
    avg_rank = ends - (c - 1) / 2.0
    pos_rank_sum = float((avg_rank * pos_g).sum())
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def _average_precision_grouped(pos_g, neg_g, n_pos: int) -> float:
    """PR-AUC with tied scores grouped into ONE threshold (pyspark's
    threshold semantics): deterministic under any row order. Each
    distinct score (descending) contributes its true positives times
    the precision at that threshold."""
    tp_g = pos_g[::-1]                       # score desc
    n_g = (pos_g + neg_g)[::-1].astype(np.float64)
    cum_tp = np.cumsum(tp_g)
    cum_n = np.cumsum(n_g)
    return float(np.sum(tp_g * (cum_tp / cum_n)) / n_pos)


class LossEvaluator(Evaluator):
    """Mean categorical cross-entropy of a probability-vector prediction
    column vs integer labels. Smaller is better.

    Default ``predictionCol`` is ``"probability"`` — the column
    LogisticRegressionModel writes its softmax vector to. Its
    ``predictionCol`` ("prediction") holds the float64 CLASS LABEL
    (Spark convention): cross-entropy on labels is meaningless, and for
    a binary model it is undetectable from values alone (all 0.0/1.0
    looks like a saturated sigmoid), so the default must point at
    probabilities.

    ``predictionSemantics="probabilities"`` declares a SCALAR column to
    be binary P(class 1): the column-level "is this actually labels?"
    guards (which gather two scalar arrays) are replaced by per-batch
    range checks and scalar scoring streams like the vector path. The
    ``"auto"`` default keeps the protective whole-column analysis."""

    predictionCol = Param("LossEvaluator", "predictionCol",
                          "probability vector column",
                          TypeConverters.toString)
    labelCol = Param("LossEvaluator", "labelCol", "label column",
                     TypeConverters.toString)
    predictionSemantics = Param(
        "LossEvaluator", "predictionSemantics",
        "scalar-prediction semantic: 'auto' or 'probabilities' "
        "('labels' is invalid here — cross-entropy on class labels is "
        "meaningless)", TypeConverters.toString)

    @keyword_only
    def __init__(self, *, predictionCol="probability", labelCol="label",
                 predictionSemantics="auto"):
        super().__init__()
        self._setDefault(predictionCol="probability", labelCol="label",
                         predictionSemantics="auto")
        self._set(predictionCol=predictionCol, labelCol=labelCol,
                  predictionSemantics=predictionSemantics)
        if self.getOrDefault("predictionSemantics") not in _LOSS_SEMANTICS:
            raise ValueError(
                f"predictionSemantics must be one of {_LOSS_SEMANTICS} "
                f"for LossEvaluator, got {predictionSemantics!r}")

    def isLargerBetter(self) -> bool:
        return False

    def _evaluate(self, dataset) -> float:
        # Streams: probability VECTORS (the memory hog — C can be 1000)
        # reduce per batch into (sum of -log picked, count); scalar
        # probabilities gather as two scalar arrays because their
        # labels-vs-probabilities guards are whole-column properties —
        # unless predictionSemantics declares them, which swaps the
        # column analysis for per-batch range checks and streams.
        semantics = self.getOrDefault("predictionSemantics")
        if semantics not in _LOSS_SEMANTICS:
            raise ValueError(
                f"predictionSemantics must be one of {_LOSS_SEMANTICS} "
                f"for LossEvaluator, got {semantics!r}")
        pred_col = self.getOrDefault("predictionCol")
        total, n = 0.0, 0
        scal_p, scal_l = [], []
        for preds, labels in _stream_pred_and_labels(
                dataset, pred_col, self.getOrDefault("labelCol")):
            if preds.ndim > 1 and preds.shape[-1] == 1:
                # squeeze BEFORE the class-label guard, or an (N,1)
                # tensor column of integer labels would bypass it
                preds = preds[..., 0]  # (N,1) sigmoid outputs → binary
            if preds.ndim == 1 and semantics == "probabilities":
                if preds.size and (preds.min() < 0.0
                                   or preds.max() > 1.0):
                    # values outside [0,1] are definitively not
                    # probabilities, declared semantic or not
                    raise ValueError(
                        f"column {pred_col!r} holds values outside "
                        "[0, 1] but predictionSemantics="
                        "'probabilities'; point predictionCol at the "
                        "probability column")
                batch_total, batch_n = _binary_scalar_loss(
                    preds, labels.argmax(-1) if labels.ndim > 1
                    else labels)
                total += batch_total
                n += batch_n
                continue
            if preds.ndim == 1:
                scal_p.append(preds)
                scal_l.append(labels.argmax(-1) if labels.ndim > 1
                              else labels)
                continue
            if preds.size and (preds.min() < 0.0 or preds.max() > 1.0):
                # A probability-VECTOR column with values outside
                # [0, 1] is raw logits mistakenly wired in; clipping
                # would return a plausible-looking loss.
                raise ValueError(
                    f"column {pred_col!r} holds values outside [0, 1] "
                    "(raw logits?), not probabilities; point "
                    "LossEvaluator(predictionCol=...) at the "
                    "probability vector column (e.g. 'probability')")
            p = np.clip(preds, 1e-7, 1.0 - 1e-7)
            if labels.ndim == 1:
                ids = labels.astype(np.int64)
                if len(ids) and (ids.min() < 0
                                 or ids.max() >= p.shape[-1]):
                    # negative ids would wrap to the LAST class and
                    # return a plausible-looking loss (the scalar
                    # branch's twin guard)
                    raise ValueError(
                        f"labels must be class ids in [0, "
                        f"{p.shape[-1]}); got "
                        f"[{ids.min()}, {ids.max()}] (re-encode e.g. "
                        "{-1,1} labels to {0,1})")
                picked = p[np.arange(len(ids)), ids]
            else:
                picked = np.sum(p * labels, axis=-1)
            total += float(-np.log(picked).sum())
            n += len(picked)
        if scal_p:
            preds, labels = _gather_deferred(scal_p, scal_l)
            if len(preds) and preds.min(initial=1.0) < 0.0:
                # negative values are as definitively not-probabilities
                # as values above 1 (e.g. a {-1, 1} label convention
                # column): clipping them would return a near-perfect
                # loss
                raise ValueError(
                    f"column {pred_col!r} holds negative values, not "
                    "probabilities; point "
                    "LossEvaluator(predictionCol=...) at the "
                    "probability vector column (e.g. 'probability')")
            if len(preds) and np.all(preds == np.round(preds)):
                if preds.max(initial=0.0) > 1.0:
                    # Values above 1 are definitely class labels (e.g.
                    # LogisticRegressionModel's predictionCol) —
                    # cross-entropy on labels is meaningless; fail
                    # loudly instead of returning a plausible number.
                    raise ValueError(
                        f"column {pred_col!r} holds integer class "
                        "labels, not probabilities; point "
                        "LossEvaluator(predictionCol=...) at the "
                        "probability vector column (e.g. 'probability')")
                # All values exactly 0.0/1.0 is ambiguous: binary class
                # labels (garbage loss) or a fully saturated sigmoid in
                # float32 (legitimate). Warn instead of crashing a
                # scoring loop.
                import logging
                logging.getLogger(__name__).warning(
                    "LossEvaluator: column %r contains only exact "
                    "0.0/1.0 values — if these are class labels rather "
                    "than saturated probabilities, this loss is "
                    "meaningless; point predictionCol at the "
                    "probability column", pred_col)
            elif len(preds) and preds.max(initial=0.0) > 1.0:
                # NON-integral values above 1 are raw scores/logits —
                # as definitively not-probabilities as negatives;
                # clipping to 1-1e-7 would return a plausible loss
                # (the vector path's 'raw logits?' guard, scalar twin)
                raise ValueError(
                    f"column {pred_col!r} holds values above 1 (raw "
                    "scores?), not probabilities; point "
                    "LossEvaluator(predictionCol=...) at the "
                    "probability vector column (e.g. 'probability')")
            batch_total, batch_n = _binary_scalar_loss(preds, labels)
            total += batch_total
            n += batch_n
        if n == 0:
            # same convention as the other evaluators
            raise EmptyScoredFrameError(
                "cannot evaluate an empty scored frame (0 rows with "
                "predictions and labels); check upstream filters/folds")
        return total / n
