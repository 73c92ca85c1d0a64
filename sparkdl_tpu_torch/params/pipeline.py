"""Transformer / Estimator / Pipeline / Evaluator bases — counterpart of
``sparkdl_tpu/params/pipeline.py``: Spark ML's composition semantics
(``Pipeline(stages=[...]).fit(df)``, ``model.transform(df)``, param-map
overrides on both) over the port's numpy-batch ``DataFrame``."""

from __future__ import annotations

import logging
from abc import abstractmethod
from typing import List, Optional, Sequence

from sparkdl_tpu_torch.params.base import (
    Param,
    Params,
    TypeConverters,
    keyword_only,
)

logger = logging.getLogger(__name__)

# Multi-stage param claims already warned about in this process:
# CrossValidator copies a pipeline per candidate per fold, and the same
# line nFolds × nCandidates times would bury it.
_warned_shared_claims: set = set()


class Transformer(Params):
    """A pipeline stage mapping DataFrame → DataFrame."""

    def transform(self, dataset, params: Optional[dict] = None):
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    @abstractmethod
    def _transform(self, dataset):
        raise NotImplementedError


class Estimator(Params):
    """A pipeline stage fit(DataFrame) → Model."""

    def fit(self, dataset, params=None):
        if params is None:
            return self._fit(dataset)
        if isinstance(params, dict):
            return self.copy(params)._fit(dataset)
        if isinstance(params, (list, tuple)):
            return [m for _, m in self.fitMultiple(dataset, list(params))]
        raise TypeError(f"params must be dict or list of dicts, got {params!r}")

    def fitMultiple(self, dataset, paramMaps: Sequence[dict]):
        """Yield ``(index, model)`` for each param map, fitted one after
        another."""
        for i, pm in enumerate(paramMaps):
            yield i, self.copy(pm)._fit(dataset)

    @abstractmethod
    def _fit(self, dataset):
        raise NotImplementedError


class Model(Transformer):
    """A Transformer produced by an Estimator."""


def _split_extra(owner: Params, extra):
    """Split a param-map override into the entries ``owner`` owns and
    those meant for its stages (what lets a CrossValidator grid over a
    Pipeline reach a stage's param). String keys resolve against the
    owner only."""
    own, foreign = {}, {}
    for p, v in (extra or {}).items():
        if isinstance(p, str) or owner.hasParam(p.name):
            own[p] = v
        else:
            foreign[p] = v
    return own, foreign


def _child_stage_list(stage):
    """The nested stage list of a pipeline-like stage, else None."""
    if isinstance(stage, Pipeline):
        return stage.getStages()
    kids = getattr(stage, "stages", None)
    return kids if isinstance(kids, list) else None


def _carries_param(stage, p) -> bool:
    """Whether ``stage``, or a stage of a nested pipeline, owns ``p``."""
    if any(q == p for q in stage.params):
        return True
    kids = _child_stage_list(stage)
    return bool(kids) and any(_carries_param(k, p) for k in kids)


def _stage_subs(owner: Params, stages, foreign):
    """Per-stage sub-maps of ``foreign``; an entry no stage claims
    raises. A Param carried by several stages (identity is (owner
    class, name), not pyspark's per-instance uid) applies to all of them,
    with a warning once per process, since pyspark would scope it to
    one stage."""
    subs = []
    claims: dict = {}
    for s in stages:
        sub = {p: v for p, v in foreign.items() if _carries_param(s, p)}
        for p in sub:
            claims.setdefault(p, []).append(type(s).__name__)
        subs.append(sub)
    unclaimed = [p for p in foreign if p not in claims]
    if unclaimed:
        raise AttributeError(
            f"param map entries {unclaimed} belong to neither the "
            f"{type(owner).__name__} nor any of its stages")
    for p, owners in claims.items():
        key = (p, tuple(owners))
        if len(owners) > 1 and key not in _warned_shared_claims:
            _warned_shared_claims.add(key)
            logger.warning(
                "param map entry %s is carried by %d stages (%s) and "
                "applies to ALL of them — Param identity here is "
                "(owner class, name), not a per-instance uid; set the "
                "param on the intended stage directly to scope it",
                p, len(owners), ", ".join(owners))
    return subs


def _stages_as_children(stages):
    """Stage list → persistence child map (sorted keys: reload order)."""
    return {f"stage_{i:04d}_{type(s).__name__}": s
            for i, s in enumerate(stages)}


def _stages_from_children(children):
    return [children[k] for k in sorted(children)]


class PipelineModel(Model):
    """Applies fitted stages in order."""

    def __init__(self, stages: List[Transformer]):
        super().__init__()
        self.stages = list(stages)

    def _transform(self, dataset):
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset

    def copy(self, extra: Optional[dict] = None) -> "PipelineModel":
        own, foreign = _split_extra(self, extra)
        subs = _stage_subs(self, self.stages, foreign)
        that = super().copy(own)
        that.stages = [s.copy(sub) for s, sub in zip(self.stages, subs)]
        return that

    def _child_stages(self):
        return _stages_as_children(self.stages)

    @classmethod
    def _from_saved(cls, params, extra, children):
        return cls(_stages_from_children(children))


class Pipeline(Estimator):
    """Chain of Transformers and Estimators, fitted front to back."""

    stages = Param("Pipeline", "stages", "pipeline stages",
                   TypeConverters.toList)

    @keyword_only
    def __init__(self, *, stages: Optional[List[Params]] = None):
        super().__init__()
        self._set(stages=stages or [])

    def setStages(self, stages: List[Params]) -> "Pipeline":
        return self._set(stages=stages)

    def getStages(self) -> List[Params]:
        return self.getOrDefault("stages")

    def copy(self, extra: Optional[dict] = None) -> "Pipeline":
        """Entries owned by a stage go to that stage's copy, recursively
        through nested pipelines; the Pipeline's own entries (``stages``)
        apply first; anything unclaimed raises."""
        own, foreign = _split_extra(self, extra)
        that = super().copy(own)
        stages = that.getStages()
        subs = _stage_subs(self, stages, foreign)
        that._set(stages=[s.copy(sub) for s, sub in zip(stages, subs)])
        return that

    def _unsaved_param_names(self):
        return {"stages"}  # saved as child stages

    def _child_stages(self):
        return _stages_as_children(self.getStages())

    @classmethod
    def _from_saved(cls, params, extra, children):
        return cls(stages=_stages_from_children(children))

    def _fit(self, dataset) -> PipelineModel:
        stages = self.getStages()
        for s in stages:
            if not isinstance(s, (Transformer, Estimator)):
                raise TypeError(f"pipeline stage {s!r} is neither Transformer "
                                "nor Estimator")
        fitted: List[Transformer] = []
        # stages after the last estimator are not applied during fit
        last_est = max((i for i, s in enumerate(stages)
                        if isinstance(s, Estimator)), default=-1)
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(dataset)
                fitted.append(model)
                if i < last_est:
                    dataset = model.transform(dataset)
            else:
                fitted.append(stage)
                if i < last_est:
                    dataset = stage.transform(dataset)
        return PipelineModel(fitted)


class EmptyScoredFrameError(ValueError):
    """An evaluator was given a scored frame with 0 rows. Typed so tuning
    can skip such a fold (loudly) while a standalone ``evaluate`` still
    fails."""


class Evaluator(Params):
    """Scores a transformed DataFrame. ``evaluate(dataset, params)``
    scores through a copy carrying ``params``; the instance is never
    mutated. Subclasses implement ``_evaluate``."""

    def evaluate(self, dataset, params: Optional[dict] = None) -> float:
        if params is not None and not isinstance(params, dict):
            raise TypeError(
                "params must be a dict of (Param | name) -> value, got "
                f"{type(params).__name__}")
        if params:
            return self.copy(params).evaluate(dataset)
        return self._evaluate(dataset)

    def _evaluate(self, dataset) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True
