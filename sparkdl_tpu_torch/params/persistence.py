"""Fitted-stage persistence: ``stage.save(dir)`` / ``load_model(dir)`` —
counterpart of ``sparkdl_tpu/params/persistence.py``. A saved stage is a
directory:

* ``metadata.json`` — ``{"format", "version", "class", "params",
  "defaults", "extra", "children"}``: the stage's explicitly set params,
  its defaults and its non-Param fitted state (coefficients, histories),
  each as a typed descriptor;
* an ``.npy`` sidecar for each numpy array;
* a ``.pt2`` sidecar for each ``ModelFunction``: its export
  (``ModelFunction.export``, the bytes ``torch.export.save`` writes, with
  the weights baked in and a fixed batch kept), loaded back by
  ``ModelFunction.deserialize`` onto the kind of device it was saved
  from, as the JAX package saves its StableHLO export;
* a module-level callable (an ``imageLoader``) as its import path;
* one subdirectory per child stage (PipelineModel stages,
  CrossValidatorModel's bestModel), each a saved stage itself.

Anything else (a lambda or local function, an object) raises
``TypeError`` naming its key: the JAX package pickles such values with
cloudpickle, and this package writes no pickle.

``load_model`` resolves classes and callables by import path, only under
``sparkdl_tpu_torch`` unless ``trusted_modules`` says otherwise, and
rebuilds the stage with ``cls._from_saved(params, extra, children)``.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Iterable, Optional

import numpy as np

FORMAT = "sparkdl_tpu_torch.stage"
VERSION = 1


def _is_plain_json(value) -> bool:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return True
    if isinstance(value, (list, tuple)):
        return all(_is_plain_json(v) for v in value)
    if isinstance(value, dict):
        return all(isinstance(k, str) and _is_plain_json(v)
                   for k, v in value.items())
    return False


def _encode_value(key: str, value, directory: str) -> dict:
    """Value → JSON descriptor (and a sidecar for arrays and model
    functions)."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    if _is_plain_json(value):
        return {"kind": "json", "value": value}
    if isinstance(value, np.ndarray) and value.dtype != object:
        fname = f"{key}.npy"
        np.save(os.path.join(directory, fname), value)
        return {"kind": "ndarray", "file": fname}
    if isinstance(value, ModelFunction):
        try:
            blob = value.export(batch_size=value._fixed_batch)
        except Exception as e:
            raise TypeError(
                f"cannot save {key!r}: ModelFunction {value.name!r} does "
                f"not export with torch.export ({type(e).__name__}: "
                f"{str(e)[:200]}); rebuild the stage with it after "
                "loading") from e
        fname = f"{key}.pt2"
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(blob)
        # the batch is read back from the program
        return {"kind": "model_fn", "file": fname, "name": value.name,
                "device": value.device.type}
    qualname = getattr(value, "__qualname__", "")
    if callable(value) and getattr(value, "__module__", None) and \
            qualname and "<" not in qualname:
        return {"kind": "callable", "module": value.__module__,
                "qualname": qualname}
    raise TypeError(
        f"cannot save {key!r}: a {type(value).__name__} is neither plain "
        "JSON, a numeric numpy array, a ModelFunction nor a module-level "
        "callable (a lambda or a local function has no import path, and "
        "this package writes no pickle); rebuild the stage with it after "
        "loading")


def _trusted(module: str, allowed) -> bool:
    return "*" in allowed or any(
        module == m or module.startswith(m + ".") for m in allowed)


def _resolve(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _decode_value(desc: dict, directory: str, allowed):
    kind = desc["kind"]
    if kind == "json":
        return desc["value"]
    if kind == "ndarray":
        return np.load(os.path.join(directory, desc["file"]))
    if kind == "model_fn":
        from sparkdl_tpu_torch.graph.function import ModelFunction
        with open(os.path.join(directory, desc["file"]), "rb") as f:
            return ModelFunction.deserialize(f.read(), name=desc["name"],
                                             device=desc["device"])
    if kind == "callable":
        if not _trusted(desc["module"], allowed):
            raise ValueError(
                f"{directory} names the callable "
                f"{desc['module']}.{desc['qualname']}, outside the trusted "
                f"module prefixes {allowed}; pass trusted_modules=[...] to "
                "load_model if you trust this artifact")
        return _resolve(desc["module"], desc["qualname"])
    raise ValueError(f"unknown descriptor kind {kind!r}")


def save_stage(stage, path: str) -> None:
    """Save a Transformer, Model or Estimator to ``path`` (created; it
    must be absent or empty: a save never overwrites)."""
    os.makedirs(path, exist_ok=True)
    if os.listdir(path):
        raise FileExistsError(
            f"{path} is not empty; choose a fresh directory "
            "(overwrite is never implicit)")
    cls = type(stage)
    unsaved = stage._unsaved_param_names()
    params = {p.name: _encode_value(f"param_{p.name}", v, path)
              for p, v in stage._paramMap.items() if p.name not in unsaved}
    # defaults are saved too, so a reload under a version whose
    # constructor defaults changed behaves as the saved stage did
    explicit = {p.name for p in stage._paramMap}
    defaults = {p.name: _encode_value(f"default_{p.name}", v, path)
                for p, v in stage._defaultParamMap.items()
                if p.name not in unsaved and p.name not in explicit}
    extra = {k: _encode_value(f"extra_{k}", v, path)
             for k, v in stage._extra_state().items()}
    children = stage._child_stages()
    for name, child in children.items():
        save_stage(child, os.path.join(path, name))
    meta = {"format": FORMAT, "version": VERSION,
            "class": f"{cls.__module__}.{cls.__qualname__}",
            "params": params, "defaults": defaults, "extra": extra,
            "children": sorted(children)}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def load_stage(path: str, *, trusted_modules: Optional[Iterable[str]] = None):
    """Load a stage saved by :func:`save_stage` (exported as
    ``sparkdl_tpu_torch.load_model``). Class resolution is restricted to
    ``sparkdl_tpu_torch`` modules; ``trusted_modules=["my_pkg"]``
    (prefix match) admits stages of your own classes, ``["*"]`` any."""
    if isinstance(trusted_modules, str):
        trusted_modules = [trusted_modules]
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{path} is not a saved stage (no metadata.json)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path} was not written by sparkdl_tpu_torch persistence "
            f"(format={meta.get('format')!r})")
    module, _, qualname = meta["class"].rpartition(".")
    allowed = ["sparkdl_tpu_torch"] + sorted(trusted_modules or [])
    if not _trusted(module, allowed):
        raise ValueError(
            f"{path} declares stage class {meta['class']!r}, outside "
            f"the trusted module prefixes {allowed}; pass "
            "trusted_modules=[...] to load_model if you trust this "
            "artifact")
    cls = _resolve(module, qualname)
    params = {name: _decode_value(d, path, allowed)
              for name, d in meta["params"].items()}
    extra = {name: _decode_value(d, path, allowed)
             for name, d in meta["extra"].items()}
    children = {name: load_stage(os.path.join(path, name),
                                 trusted_modules=trusted_modules)
                for name in meta.get("children", [])}
    stage = cls._from_saved(params, extra, children)
    # the saved defaults replace this version's constructor defaults
    for name, d in meta.get("defaults", {}).items():
        if stage.hasParam(name):
            stage._defaultParamMap[stage.getParam(name)] = \
                _decode_value(d, path, allowed)
    # keyword_only constructors set every argument explicitly, which
    # would shadow the restored defaults: clear the explicit entries the
    # save did not record as explicit, where a default still resolves
    keep = set(meta["params"]) | stage._unsaved_param_names()
    for p in [p for p in stage._paramMap if p.name not in keep]:
        if p in stage._defaultParamMap:
            stage.clear(p)
    return stage
