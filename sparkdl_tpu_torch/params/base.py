"""Core Param/Params machinery — counterpart of
``sparkdl_tpu/params/base.py`` (pyspark's ``Params`` semantics: typed
params, a class-level registry, explicit values over defaults, param
maps, and ``save``). ``Transformer`` lives in ``params/pipeline.py`` and
is re-exported here."""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional


class Param:
    """A typed parameter slot; identity is ``(owner, name)``."""

    __slots__ = ("parent", "name", "doc", "typeConverter")

    def __init__(self, parent: str, name: str, doc: str,
                 typeConverter: Optional[Callable[[Any], Any]] = None):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda x: x)

    def __repr__(self) -> str:
        return f"Param({self.parent}.{self.name})"

    def __hash__(self) -> int:
        return hash((self.parent, self.name))

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, Param)
                and self.parent == other.parent and self.name == other.name)


def keyword_only(func):
    """Force keyword-only construction; the wrapped method sees its
    keyword arguments in ``self._input_kwargs``."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(
                f"{func.__name__}() only accepts keyword arguments; "
                f"got {len(args)} positional")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


class Params:
    """Anything carrying typed params: explicitly set values
    (``_paramMap``) over defaults (``_defaultParamMap``)."""

    def __init__(self):
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self.uid = f"{type(self).__name__}_{id(self):x}"

    @property
    def params(self) -> list:
        """All Params declared on the class hierarchy, name-sorted."""
        seen = {}
        for klass in reversed(type(self).__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, Param):
                    seen[attr.name] = attr
        return [seen[k] for k in sorted(seen)]

    def hasParam(self, paramName: str) -> bool:
        return any(p.name == paramName for p in self.params)

    def getParam(self, paramName: str) -> Param:
        for p in self.params:
            if p.name == paramName:
                return p
        raise AttributeError(
            f"{type(self).__name__} has no param '{paramName}'")

    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            return self.getParam(param.name)
        if isinstance(param, str):
            return self.getParam(param)
        raise TypeError(f"cannot resolve param from {param!r}")

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def isDefined(self, param) -> bool:
        p = self._resolveParam(param)
        return p in self._paramMap or p in self._defaultParamMap

    def getOrDefault(self, param):
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(
            f"param {p.name!r} of {type(self).__name__} is not set "
            "and has no default")

    def set(self, param, value) -> "Params":
        p = self._resolveParam(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def setParams(self, **kwargs) -> "Params":
        """Set several params by name (``lr.setParams(maxIter=10)``);
        unknown names raise, and an explicit ``None`` clears the param
        back to its default."""
        for name, value in kwargs.items():
            if value is None:
                self.clear(name)
            else:
                self.set(name, value)
        return self

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if value is None:
                continue
            p = self.getParam(name)
            self._paramMap[p] = p.typeConverter(value)
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            self._defaultParamMap[self.getParam(name)] = value
        return self

    def clear(self, param) -> "Params":
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def extractParamMap(self, extra: Optional[dict] = None) -> dict:
        pm = dict(self._defaultParamMap)
        pm.update(self._paramMap)
        if extra:
            pm.update(extra)
        return pm

    def explainParam(self, param) -> str:
        """One param's doc and current value. A Param object of another
        class raises rather than explaining a same-named param."""
        if isinstance(param, Param) \
                and not any(p == param for p in self.params):
            raise ValueError(
                f"Param {param.name!r} does not belong to "
                f"{type(self).__name__}")
        p = self._resolveParam(param)
        cur = (repr(self.getOrDefault(p))
               if self.isDefined(p) else "undefined")
        return f"{p.name}: {p.doc} (current: {cur})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    def copy(self, extra: Optional[dict] = None) -> "Params":
        that = copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for p, v in extra.items():
                rp = that._resolveParam(p)
                that._paramMap[rp] = rp.typeConverter(v)
        return that

    def _copyValues(self, to: "Params", extra: Optional[dict] = None):
        for p, v in self.extractParamMap(extra).items():
            if to.hasParam(p.name):
                to._set(**{p.name: v})
        return to

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist this stage (params, fitted state, child stages) to a
        directory; reload with :func:`sparkdl_tpu_torch.load_model`."""
        from sparkdl_tpu_torch.params.persistence import save_stage
        save_stage(self, path)

    def _extra_state(self) -> Dict[str, Any]:
        """Non-Param fitted state to persist (coefficients, histories);
        restored through ``_from_saved``'s ``extra``."""
        return {}

    def _child_stages(self) -> Dict[str, "Params"]:
        """Nested stages saved as subdirectories; sorted keys are the
        reload order."""
        return {}

    def _unsaved_param_names(self) -> set:
        """Params left out of a save (saved as children instead)."""
        return set()

    @classmethod
    def _from_saved(cls, params: Dict[str, Any], extra: Dict[str, Any],
                    children: Dict[str, "Params"]) -> "Params":
        """Rebuild from saved state: explicit params go back into the
        ``keyword_only`` constructor. Stages with fitted state or
        children override this."""
        if extra or children:
            raise NotImplementedError(
                f"{cls.__name__} saved extra state/children but does "
                "not override _from_saved")
        return cls(**params)


class TypeConverters:
    """Typed converters for Param values."""

    @staticmethod
    def toString(value) -> str:
        if isinstance(value, str):
            return value
        raise TypeError(f"expected str, got {type(value).__name__}")

    @staticmethod
    def toInt(value) -> int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"expected int, got {type(value).__name__}")
        if int(value) != value:
            raise TypeError(f"expected integral value, got {value}")
        return int(value)

    @staticmethod
    def toFloat(value) -> float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"expected float, got {type(value).__name__}")
        return float(value)

    @staticmethod
    def toBoolean(value) -> bool:
        if not isinstance(value, bool):
            raise TypeError(f"expected bool, got {type(value).__name__}")
        return value

    @staticmethod
    def toList(value) -> list:
        if isinstance(value, (list, tuple)):
            return list(value)
        raise TypeError(f"expected list, got {type(value).__name__}")

    @staticmethod
    def toListString(value) -> list:
        value = TypeConverters.toList(value)
        if not all(isinstance(v, str) for v in value):
            raise TypeError("expected list of str")
        return value

    @staticmethod
    def toIntPairOrNone(value):
        if value is None:
            return None
        if not isinstance(value, (list, tuple)) or len(value) != 2:
            raise TypeError(f"expected (h, w) pair, got {value!r}")
        return (TypeConverters.toInt(value[0]),
                TypeConverters.toInt(value[1]))

    @staticmethod
    def toDevice(value) -> str:
        """A device name torch parses (``"cuda"``, ``"cuda:1"``,
        ``"cpu"``), kept as a string."""
        import torch
        return str(torch.device(value))

    @staticmethod
    def toCallable(value):
        if callable(value):
            return value
        raise TypeError(f"expected callable, got {type(value).__name__}")

    @staticmethod
    def toStringDict(value) -> dict:
        """{str: str} mapping, from a dict or a list of pairs."""
        if isinstance(value, dict):
            items = value.items()
        elif isinstance(value, (list, tuple)):
            items = list(value)
        else:
            raise TypeError(
                f"expected dict or pair-list, got {type(value).__name__}")
        out = {}
        for k, v in items:
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError("mapping keys and values must be str")
            out[k] = v
        return out

    @staticmethod
    def toHParams(value) -> dict:
        """{str: number/array} dict of named constants."""
        import numpy as np
        if not isinstance(value, dict):
            raise TypeError(
                f"expected hyperparams dict, got {type(value).__name__}")
        out = {}
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError("hyperparam names must be str")
            if not isinstance(v, (int, float, bool, np.ndarray, list, tuple)):
                raise TypeError(
                    f"hyperparam {k!r} must be numeric or array-like, "
                    f"got {type(v).__name__}")
            out[k] = v
        return out

    @staticmethod
    def toOptimizer(value):
        """An optimizer name the port maps to a torch optimizer with
        optax's defaults, or a factory ``params -> torch.optim.Optimizer``
        (the counterpart of passing an optax transformation)."""
        from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
            OPTIMIZERS,
        )
        if isinstance(value, str):
            if value not in OPTIMIZERS:
                raise TypeError(f"unknown optimizer {value!r}; the port "
                                f"maps {sorted(OPTIMIZERS)}")
            return value
        if callable(value):
            return value
        raise TypeError(
            f"expected optimizer name or factory, got {value!r}")

    @staticmethod
    def toLoss(value):
        """A loss name (the Keras-era ones or optax's) or a callable."""
        from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
            LOSSES,
        )
        if isinstance(value, str):
            if value not in LOSSES:
                raise TypeError(f"unknown loss {value!r}; the port has "
                                f"{sorted(LOSSES)}")
            return value
        if callable(value):
            return value
        raise TypeError(f"expected loss name or callable, got {value!r}")

    @staticmethod
    def toModelFunction(value):
        from sparkdl_tpu_torch.graph.function import ModelFunction
        if isinstance(value, ModelFunction):
            return value
        raise TypeError(
            f"expected ModelFunction, got {type(value).__name__}")


# Transformer moved to params/pipeline.py with the other stage bases; the
# import sits last because pipeline.py imports this module's names.
from sparkdl_tpu_torch.params.pipeline import Transformer  # noqa: E402,F401
