"""Hyperparameter tuning — counterpart of ``sparkdl_tpu/params/tuning.py``:
``ParamGridBuilder``, ``CrossValidator`` and ``TrainValidationSplit``
over partitioned frames. Fold and split membership is drawn per
partition from ``np.random.default_rng((seed, partition index))``, as in
the JAX package, so both packages put the same rows on the same side.
"""

from __future__ import annotations

import itertools
import logging
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.params.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.params.pipeline import (
    EmptyScoredFrameError,
    Estimator,
    Evaluator,
    Model,
)

logger = logging.getLogger(__name__)


def _seeded_split(dataset, seed: int, name: str, draw, keep_a: bool):
    """Membership as a plan stage: each partition draws a boolean "side
    A" mask from a generator seeded by (seed, partition logical index)
    via ``draw(rng, n_rows)``, so a row's side is the same every time the
    frame is materialized, and the two sides (``keep_a`` True / False)
    recompute the same draw: disjoint and covering without knowing the
    global row count, and no stage holds more than one partition."""

    def _stage(batch, index: int):
        n = len(next(iter(batch.values()))) if batch else 0
        rng = np.random.default_rng((seed, index))
        side_a = draw(rng, n)
        mask = side_a if keep_a else ~side_a
        return {k: v[mask] for k, v in batch.items()}

    return dataset.map_batches(_stage, name=name,
                               row_preserving=False, with_index=True)


def _fold_split(dataset, k: int, fold: int, seed: int, keep_train: bool):
    """CV fold membership: rows drawing fold id != ``fold`` train."""
    side = "train" if keep_train else "valid"
    return _seeded_split(
        dataset, seed, f"fold{fold}/{side}",
        lambda rng, n: rng.integers(0, k, size=n) != fold, keep_train)


def _cached_for_tuning(dataset, cache_dir):
    """Materialize the upstream plan once for all the tuning passes: in
    memory (``cache_dir=None``), or spilled to a fresh subdirectory of
    ``cache_dir`` that no other fit shares. Returns ``(frame,
    cleanup)``."""
    if cache_dir is None:
        return dataset.cache(), (lambda: None)
    os.makedirs(cache_dir, exist_ok=True)
    spill = tempfile.mkdtemp(prefix="tuning_spill_", dir=cache_dir)
    return (dataset.cache_to_disk(spill),
            lambda: shutil.rmtree(spill, ignore_errors=True))


def _best(metrics, ev: Evaluator) -> int:
    return int(np.argmax(metrics) if ev.isLargerBetter()
               else np.argmin(metrics))


class ParamGridBuilder:
    """Cartesian-product grid of param maps (pyspark's API)."""

    def __init__(self):
        self._grid: Dict[Param, Sequence] = {}

    def addGrid(self, param: Param, values: Sequence) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        if len(args) == 1 and isinstance(args[0], dict):
            args = list(args[0].items())
        for param, value in args:
            self._grid[param] = [value]
        return self

    def build(self) -> List[dict]:
        keys = list(self._grid)
        if not keys:
            return [{}]
        return [dict(zip(keys, combo))
                for combo in itertools.product(*(self._grid[k]
                                                  for k in keys))]


class CrossValidatorModel(Model):
    """``subModels`` (``collectSubModels=True`` only, else None) is
    ``[fold][candidate] -> Model``; in memory only, not saved.

    ``avgMetrics[i]`` is candidate *i*'s mean over the folds every
    candidate scored: a fold whose validation side scored 0 rows for any
    candidate is left out of every candidate's average, so candidates
    are compared on the same folds."""

    def __init__(self, bestModel: Model, avgMetrics: List[float],
                 subModels: Optional[List[List[Model]]] = None):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics
        self.subModels = subModels

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)

    def _extra_state(self):
        return {"avgMetrics": [float(m) for m in self.avgMetrics]}

    def _child_stages(self):
        return {"bestModel": self.bestModel}

    @classmethod
    def _from_saved(cls, params, extra, children):
        return cls(children["bestModel"], extra["avgMetrics"])


class CrossValidator(Estimator):
    """k-fold cross validation of an estimator over a param grid. The
    upstream plan runs once for all 2×k fold passes: in memory by
    default, or spilled under ``cacheDir``."""

    estimator = Param("CrossValidator", "estimator", "estimator to tune")
    estimatorParamMaps = Param("CrossValidator", "estimatorParamMaps",
                               "param grid", TypeConverters.toList)
    evaluator = Param("CrossValidator", "evaluator", "metric evaluator")
    numFolds = Param("CrossValidator", "numFolds", "number of folds",
                     TypeConverters.toInt)
    seed = Param("CrossValidator", "seed", "random seed",
                 TypeConverters.toInt)
    cacheDir = Param("CrossValidator", "cacheDir",
                     "spill directory for larger-than-RAM datasets",
                     TypeConverters.toString)
    collectSubModels = Param(
        "CrossValidator", "collectSubModels",
        "keep every (fold, candidate) fitted model on the result "
        "(memory scales with numFolds * len(paramMaps))",
        TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, *, estimator=None, estimatorParamMaps=None,
                 evaluator=None, numFolds=3, seed=42, cacheDir=None,
                 collectSubModels=False):
        super().__init__()
        self._setDefault(numFolds=3, seed=42, cacheDir=None,
                         collectSubModels=False)
        self._set(estimator=estimator, estimatorParamMaps=estimatorParamMaps,
                  evaluator=evaluator, numFolds=numFolds, seed=seed,
                  cacheDir=cacheDir, collectSubModels=collectSubModels)

    def _kfold(self, dataset):
        """The k (train, validation) frame pairs."""
        k = self.getOrDefault("numFolds")
        seed = self.getOrDefault("seed")
        for fold in range(k):
            yield (_fold_split(dataset, k, fold, seed, True),
                   _fold_split(dataset, k, fold, seed, False))

    def _fit(self, dataset) -> CrossValidatorModel:
        est: Estimator = self.getOrDefault("estimator")
        maps: List[dict] = self.getOrDefault("estimatorParamMaps")
        ev: Evaluator = self.getOrDefault("evaluator")
        nfolds = self.getOrDefault("numFolds")
        # a fold that scored 0 rows stays NaN and is left out
        scores = np.full((len(maps), nfolds), np.nan)
        sub: Optional[List[List[Model]]] = \
            ([[None] * len(maps) for _ in range(nfolds)]
             if self.getOrDefault("collectSubModels") else None)
        dataset, cleanup = _cached_for_tuning(
            dataset, self.getOrDefault("cacheDir"))
        try:
            for fold, (train, valid) in enumerate(self._kfold(dataset)):
                for idx, model in est.fitMultiple(train, maps):
                    if sub is not None:
                        sub[fold][idx] = model
                    try:
                        scores[idx, fold] = ev.evaluate(
                            model.transform(valid))
                    except EmptyScoredFrameError:
                        logger.warning(
                            "fold %d scored 0 rows for candidate %d "
                            "(validation side empty after upstream "
                            "filters); the fold will be excluded from "
                            "EVERY candidate's average so candidates "
                            "stay comparable", fold, idx)
            fold_ok = ~np.isnan(scores).any(axis=0)
            if not fold_ok.any():
                raise ValueError(
                    f"no fold was scored by every candidate "
                    f"(fold validation sides scored 0 rows for "
                    f"{int(np.isnan(scores).any(axis=0).sum())} of "
                    f"{nfolds} folds across {len(maps)} candidates) — "
                    "the dataset is too small for numFolds or an "
                    "upstream/candidate filter drops everything")
            if not fold_ok.all():
                logger.warning(
                    "excluding fold(s) %s from every candidate's "
                    "average (some candidate scored 0 validation rows "
                    "there); candidates are compared on the common "
                    "%d-fold subset",
                    [int(f) for f in np.nonzero(~fold_ok)[0]],
                    int(fold_ok.sum()))
            metrics = scores[:, fold_ok].mean(axis=1)
            bestModel = est.fit(dataset, maps[_best(metrics, ev)])
        finally:
            cleanup()
        return CrossValidatorModel(bestModel, list(metrics), subModels=sub)


class TrainValidationSplitModel(Model):
    """``subModels`` (``collectSubModels=True`` only, else None) is
    ``[candidate] -> Model``; in memory only, not saved."""

    def __init__(self, bestModel: Model, validationMetrics: List[float],
                 subModels: Optional[List[Model]] = None):
        super().__init__()
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics
        self.subModels = subModels

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)

    def _extra_state(self):
        return {"validationMetrics": [float(m)
                                      for m in self.validationMetrics]}

    def _child_stages(self):
        return {"bestModel": self.bestModel}

    @classmethod
    def _from_saved(cls, params, extra, children):
        return cls(children["bestModel"], extra["validationMetrics"])


class TrainValidationSplit(Estimator):
    """One seeded train/validation split over a param grid, with the
    same per-partition membership and ``cacheDir`` spill as
    :class:`CrossValidator`."""

    estimator = Param("TrainValidationSplit", "estimator", "estimator to tune")
    estimatorParamMaps = Param("TrainValidationSplit", "estimatorParamMaps",
                               "param grid", TypeConverters.toList)
    evaluator = Param("TrainValidationSplit", "evaluator", "metric evaluator")
    trainRatio = Param("TrainValidationSplit", "trainRatio",
                       "fraction of rows used for training",
                       TypeConverters.toFloat)
    seed = Param("TrainValidationSplit", "seed", "random seed",
                 TypeConverters.toInt)
    cacheDir = Param("TrainValidationSplit", "cacheDir",
                     "spill directory for larger-than-RAM datasets",
                     TypeConverters.toString)
    collectSubModels = Param(
        "TrainValidationSplit", "collectSubModels",
        "keep every candidate's fitted model on the result",
        TypeConverters.toBoolean)

    @keyword_only
    def __init__(self, *, estimator=None, estimatorParamMaps=None,
                 evaluator=None, trainRatio=0.75, seed=42, cacheDir=None,
                 collectSubModels=False):
        super().__init__()
        self._setDefault(trainRatio=0.75, seed=42, cacheDir=None,
                         collectSubModels=False)
        self._set(estimator=estimator, estimatorParamMaps=estimatorParamMaps,
                  evaluator=evaluator, trainRatio=trainRatio, seed=seed,
                  cacheDir=cacheDir, collectSubModels=collectSubModels)

    def _split(self, dataset):
        """(train, valid): a per-partition seeded coin decides each
        row's side."""
        ratio = self.getOrDefault("trainRatio")
        seed = self.getOrDefault("seed")

        def draw(rng, n):
            return rng.random(n) < ratio

        return (_seeded_split(dataset, seed, "split/train", draw, True),
                _seeded_split(dataset, seed, "split/valid", draw, False))

    def _fit(self, dataset) -> TrainValidationSplitModel:
        est: Estimator = self.getOrDefault("estimator")
        maps: List[dict] = self.getOrDefault("estimatorParamMaps")
        ev: Evaluator = self.getOrDefault("evaluator")
        dataset, cleanup = _cached_for_tuning(
            dataset, self.getOrDefault("cacheDir"))
        try:
            train, valid = self._split(dataset)
            metrics = [0.0] * len(maps)
            sub: Optional[List[Model]] = \
                ([None] * len(maps)
                 if self.getOrDefault("collectSubModels") else None)
            for idx, model in est.fitMultiple(train, maps):
                if sub is not None:
                    sub[idx] = model
                try:
                    metrics[idx] = ev.evaluate(model.transform(valid))
                except EmptyScoredFrameError as e:
                    # the one validation side is every candidate's
                    raise ValueError(
                        "the validation side of the split scored 0 "
                        f"rows (trainRatio="
                        f"{self.getOrDefault('trainRatio')}); the "
                        "dataset is too small or an upstream filter "
                        "drops everything") from e
            bestModel = est.fit(dataset, maps[_best(metrics, ev)])
        finally:
            cleanup()
        return TrainValidationSplitModel(bestModel, metrics, subModels=sub)
