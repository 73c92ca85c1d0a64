"""Core Param/Params machinery and the Transformer base — counterpart of
``sparkdl_tpu/params/base.py`` and ``params/pipeline.py::Transformer``
(pyspark's ``Params`` semantics: typed params, a class-level registry,
explicit values over defaults, param-map overrides on ``transform``)."""

from __future__ import annotations

import copy
import functools
from abc import abstractmethod
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

    def copy(self, extra: Optional[dict] = None) -> "Params":
        that = copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for p, v in extra.items():
                rp = that._resolveParam(p)
                that._paramMap[rp] = rp.typeConverter(v)
        return that


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
    def toBoolean(value) -> bool:
        if not isinstance(value, bool):
            raise TypeError(f"expected bool, got {type(value).__name__}")
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
    def toModelFunction(value):
        from sparkdl_tpu_torch.graph.function import ModelFunction
        if isinstance(value, ModelFunction):
            return value
        raise TypeError(
            f"expected ModelFunction, got {type(value).__name__}")


class Transformer(Params):
    """A pipeline stage mapping DataFrame → DataFrame."""

    def transform(self, dataset, params: Optional[dict] = None):
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    @abstractmethod
    def _transform(self, dataset):
        raise NotImplementedError
