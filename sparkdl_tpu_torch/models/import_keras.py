"""Import Keras-applications weights into the port's zoo — counterpart of
``sparkdl_tpu/models/import_keras.py``.

Pretrained weights arrive by conversion: build the matching
``keras.applications`` model (with its ImageNet weights, wherever the
user got them), walk both models in execution order, and copy kernels
and statistics across, each kind (conv, dense, BatchNorm) paired in
order with its shape checked. Pairing by order makes this an
architecture check as well: a zoo module out of step with Keras stops
lining up and the import raises.

The port's side of the order is recorded from one forward of the module
on the ``meta`` device (no storage, no arithmetic), built in float32 so
each conv and dense call receives the parameter itself: a
``TorchFunctionMode`` sees every ``conv2d`` and ``linear`` call and names
its weight's module, and forward pre-hooks see every BatchNorm. The
Keras side is the JAX package's (``keras_layer_order`` and its helpers,
copied here: the port imports nothing of the JAX package). keras is
imported only inside the functions that read a Keras model.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from sparkdl_tpu_torch.models import layers

# the torch functions a conv or a dense layer goes through
_CONV_FNS = (F.conv2d, torch.conv2d)
_LINEAR_FNS = (F.linear, torch._C._nn.linear)


class _Recorder(TorchFunctionMode):
    """Records ``(module path, kind)`` for each conv and dense call whose
    weight is a parameter of the module being walked."""

    def __init__(self, weights: Dict[int, str], records, seen):
        super().__init__()
        self.weights = weights
        self.records = records
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = ("conv" if func in _CONV_FNS
                else "dense" if func in _LINEAR_FNS else None)
        if kind is not None:
            weight = args[1] if len(args) > 1 else kwargs.get("weight")
            path = self.weights.get(id(weight))
            if path is not None and path not in self.seen:
                self.seen.add(path)
                self.records.append((path, kind))
        return func(*args, **kwargs)


def torch_layer_order(module_fn, input_shape: Tuple[int, ...]
                      ) -> List[Tuple[str, str]]:
    """Execution-ordered ``(module path, kind)`` for every conv, dense and
    BatchNorm call of ``module_fn(dtype=float32)`` on an NHWC
    ``input_shape``; kind ∈ {"conv", "dense", "bn"}."""
    with torch.device("meta"):
        module = module_fn(dtype=torch.float32)
    weights = {id(m.weight): name for name, m in module.named_modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))}
    records: List[Tuple[str, str]] = []
    seen = set()

    def bn_hook(name):
        def hook(mod, args):
            if name not in seen:
                seen.add(name)
                records.append((name, "bn"))
        return hook

    handles = [m.register_forward_pre_hook(bn_hook(name))
               for name, m in module.named_modules()
               if isinstance(m, (layers.BatchNorm, nn.BatchNorm2d))]
    h, w, c = input_shape
    try:
        with _Recorder(weights, records, seen):
            module(torch.zeros((1, c, h, w), device="meta"))
    finally:
        for handle in handles:
            handle.remove()
    return records


# -- the Keras side: the JAX package's helpers -------------------------------

def _collect(model) -> Dict[str, Any]:
    """name → (layer, kind) for weight-bearing layers."""
    import keras
    out = {}
    for layer in model.layers:
        if isinstance(layer, keras.layers.SeparableConv2D):
            out[layer.name] = (layer, "sepconv")
        elif isinstance(layer, keras.layers.Conv2D):
            out[layer.name] = (layer, "conv")
        elif isinstance(layer, keras.layers.Dense):
            out[layer.name] = (layer, "dense")
        elif isinstance(layer, keras.layers.BatchNormalization):
            out[layer.name] = (layer, "bn")
    return out


def _counter_key(name: str) -> int:
    """Auto-name counter: "conv2d" → 0, "conv2d_7" → 7."""
    tail = name.rsplit("_", 1)[-1]
    return int(tail) if tail.isdigit() else 0


def _resnet_key(name: str):
    """Creation order of keras-apps ResNet names: conv1 first, then
    (stage, block, branch) — branch 0 (shortcut) is created first in
    each projecting block, matching the zoo's Bottleneck."""
    if name.startswith("conv1_"):
        return (0, 0, 0)
    m = re.fullmatch(
        r"conv(\d+)_block(\d+)_(\d+)_(?:conv|bn)", name)
    if not m:
        raise ValueError(f"unrecognized resnet layer name {name!r}")
    return tuple(int(g) for g in m.groups())


def keras_layer_order(model) -> List[Tuple[Any, str]]:
    """``(layer, kind)`` for weight-bearing layers in CREATION order —
    which equals the zoo modules' execution order.

    ``model.layers`` is depth-sorted (BFS), NOT creation-sorted, so each
    architecture family needs its ordering recovered from names:
    auto-named models (InceptionV3) via the per-class name counter,
    explicitly-named models (VGG/ResNet) via their structured names,
    Xception via its documented block layout.
    """
    layers_ = _collect(model)
    names = list(layers_)

    if any(n.startswith("block1_sepconv") or n.startswith("block2_sepconv")
           for n in names) and any(n.startswith("conv2d") for n in names):
        ordered = _xception_name_order(names)
    elif any(re.fullmatch(r"conv\d+_block\d+_\d+_(conv|bn)", n)
             for n in names):
        def key(n):
            if n == "predictions":
                return (99, 0, 0)
            return _resnet_key(n)
        ordered = sorted(names, key=key)
    elif all(_is_auto_name(n) or n == "predictions" for n in names):
        # auto-named (InceptionV3): counter per class prefix
        ordered = sorted(names, key=lambda n: (0 if n != "predictions"
                                               else 1, _counter_key(n)))
    else:
        # explicit sequential names (VGG: block{i}_conv{j}, fc1, fc2)
        ordered = sorted(names)
    return [layers_[n] for n in ordered]


def _is_auto_name(name: str) -> bool:
    base = name.rsplit("_", 1)[0] if name.rsplit("_", 1)[-1].isdigit() \
        else name
    return base in ("conv2d", "batch_normalization", "dense",
                    "separable_conv2d")


def _xception_name_order(names: List[str]) -> List[str]:
    """Creation order of keras-apps Xception weight layers. Shortcut
    convs are auto-named conv2d/_1/_2/_3 (+ matching auto-named BNs) and
    are created BEFORE their block's sepconvs, exactly like the zoo's
    modules."""
    order = ["block1_conv1", "block1_conv1_bn",
             "block1_conv2", "block1_conv2_bn"]
    auto_conv = sorted([n for n in names if _is_auto_name(n)
                        and n.startswith("conv2d")], key=_counter_key)
    auto_bn = sorted([n for n in names if _is_auto_name(n)
                      and n.startswith("batch_normalization")],
                     key=_counter_key)
    shortcut = list(zip(auto_conv, auto_bn))
    for i, block in enumerate((2, 3, 4)):
        order += list(shortcut[i])
        for j in (1, 2):
            order += [f"block{block}_sepconv{j}",
                      f"block{block}_sepconv{j}_bn"]
    for block in range(5, 13):
        for j in (1, 2, 3):
            order += [f"block{block}_sepconv{j}",
                      f"block{block}_sepconv{j}_bn"]
    order += list(shortcut[3])
    for block, js in ((13, (1, 2)), (14, (1, 2))):
        for j in js:
            order += [f"block{block}_sepconv{j}",
                      f"block{block}_sepconv{j}_bn"]
    order.append("predictions")
    missing = set(order) - set(names)
    extra = set(names) - set(order)
    if missing or extra:
        raise ValueError(
            f"xception layout mismatch: missing {sorted(missing)[:4]}, "
            f"unexpected {sorted(extra)[:4]}")
    return order


# -- pairing -----------------------------------------------------------------

def _put(state: Dict[str, torch.Tensor], shapes: Dict[str, torch.Size],
         key: str, value: np.ndarray) -> None:
    if key not in shapes:
        raise KeyError(f"no parameter {key} in the zoo module")
    if tuple(shapes[key]) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {key}: torch {tuple(shapes[key])} vs keras "
            f"{tuple(value.shape)} — architectures out of sync")
    state[key] = torch.from_numpy(np.ascontiguousarray(value,
                                                       dtype=np.float32))


def import_keras_weights(module_fn, keras_model,
                         input_shape: Tuple[int, ...]
                         ) -> Dict[str, torch.Tensor]:
    """Convert ``keras_model``'s weights into a float32 state dict for
    ``module_fn()`` (a zoo architecture), pairing layers by execution
    order per kind and checking every shape; every key of the module's
    state dict is filled."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  module_fn(dtype=torch.float32).state_dict().items()}
    order = torch_layer_order(module_fn, input_shape)
    korder = keras_layer_order(keras_model)

    tq = {kind: [p for p, k in order if k == kind]
          for kind in ("conv", "dense", "bn")}
    # a SeparableConv2D is two convs on the torch side: (depthwise,
    # pointwise)
    kconv: List[Tuple[Any, str]] = []
    for layer, kind in korder:
        if kind == "sepconv":
            kconv += [(layer, "dw"), (layer, "pw")]
        elif kind == "conv":
            kconv.append((layer, "full"))
    kq = {"conv": kconv,
          "dense": [l for l, k in korder if k == "dense"],
          "bn": [l for l, k in korder if k == "bn"]}
    for kind in ("conv", "dense", "bn"):
        if len(tq[kind]) != len(kq[kind]):
            raise ValueError(
                f"{kind} count mismatch: torch has {len(tq[kind])}, keras "
                f"has {len(kq[kind])} — architectures out of sync")

    state: Dict[str, torch.Tensor] = {}
    for path, (layer, part) in zip(tq["conv"], kq["conv"]):
        weights = layer.get_weights()
        if part == "dw":
            # keras depthwise kernel (h, w, in, mult) → (in, 1, h, w), the
            # weight of a conv with groups=in, for mult == 1
            dw = weights[0]
            if dw.shape[-1] != 1:
                raise ValueError(
                    f"depth multiplier {dw.shape[-1]} != 1 unsupported")
            _put(state, shapes, f"{path}.weight", dw.transpose(2, 3, 0, 1))
            continue
        if part == "pw":
            _put(state, shapes, f"{path}.weight",
                 weights[1].transpose(3, 2, 0, 1))
            continue
        _put(state, shapes, f"{path}.weight",
             weights[0].transpose(3, 2, 0, 1))     # HWIO → OIHW
        if getattr(layer, "use_bias", False):
            _put(state, shapes, f"{path}.bias", weights[1])

    for path, layer in zip(tq["dense"], kq["dense"]):
        weights = layer.get_weights()
        _put(state, shapes, f"{path}.weight", weights[0].T)
        if getattr(layer, "use_bias", True):
            _put(state, shapes, f"{path}.bias", weights[1])

    for path, layer in zip(tq["bn"], kq["bn"]):
        weights = layer.get_weights()
        idx = 0
        gamma = beta = None
        if layer.scale:
            gamma = weights[idx]
            idx += 1
        if layer.center:
            beta = weights[idx]
            idx += 1
        mean, var = weights[idx], weights[idx + 1]
        _put(state, shapes, f"{path}.weight",
             np.ones_like(mean) if gamma is None else gamma)
        _put(state, shapes, f"{path}.bias",
             np.zeros_like(mean) if beta is None else beta)
        _put(state, shapes, f"{path}.running_mean", mean)
        _put(state, shapes, f"{path}.running_var", var)

    missing = set(shapes) - set(state)
    if missing:
        raise ValueError(f"the keras model filled no value for "
                         f"{sorted(missing)[:4]}: architectures out of sync")
    return state


_KERAS_APPLICATIONS = {
    "InceptionV3": ("inception_v3", "InceptionV3"),
    "Xception": ("xception", "Xception"),
    "ResNet50": ("resnet50", "ResNet50"),
    "VGG16": ("vgg16", "VGG16"),
    "VGG19": ("vgg19", "VGG19"),
}


def import_named_model(name: str, keras_model=None,
                       weights: Optional[str] = "imagenet",
                       fetcher=None) -> Dict[str, torch.Tensor]:
    """Convert a named zoo model's Keras-applications weights and store
    them in the :class:`~sparkdl_tpu_torch.models.fetcher.ModelFetcher`
    cache as ``<name>.pt``, which ``zoo.getModelFunction(name)`` reads
    first.

    ``keras_model`` overrides the auto-built ``keras.applications``
    model (e.g. one loaded from a local ``.h5``); ``weights`` is passed
    to the keras.applications constructor otherwise (Keras fetches
    ``"imagenet"`` weights itself, where it can)."""
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    from sparkdl_tpu_torch.models.zoo import getKerasApplicationModel

    spec = getKerasApplicationModel(name)
    if name not in _KERAS_APPLICATIONS:
        raise ValueError(
            f"no keras.applications counterpart for {name!r}")
    if keras_model is None:
        import importlib
        mod_name, cls_name = _KERAS_APPLICATIONS[name]
        mod = importlib.import_module(f"keras.applications.{mod_name}")
        keras_model = getattr(mod, cls_name)(weights=weights)

    state = import_keras_weights(spec.module_fn, keras_model,
                                 (spec.height, spec.width, 3))
    fetcher = fetcher or ModelFetcher()
    fetcher.put(f"{name}.pt", state)
    materialize_imagenet_class_index(fetcher)
    return state


def materialize_imagenet_class_index(fetcher=None) -> Optional[str]:
    """Put the canonical ``imagenet_class_index.json`` (label metadata,
    not weights) into the fetcher cache so
    ``DeepImagePredictor(decodePredictions=True)`` emits real class
    names. The source is keras's own cache (``~/.keras/models/``) when
    an earlier keras run put it there. Unlike the JAX package this never
    downloads it: without a copy it returns None and decoding keeps the
    synthetic ``class_i`` names (visibly synthetic labels beat silently
    wrong ones)."""
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher

    fetcher = fetcher or ModelFetcher()
    dst = os.path.join(fetcher.cache_dir, "imagenet_class_index.json")
    if os.path.exists(dst):
        return dst
    src = os.path.join(os.path.expanduser("~"), ".keras", "models",
                       "imagenet_class_index.json")
    if not os.path.exists(src):
        return None
    try:
        with open(src) as f:
            raw = json.load(f)  # validate before committing to the cache
    except (OSError, ValueError) as e:
        # label metadata is optional: a corrupt cached index must not
        # fail a weight import that already succeeded
        logging.getLogger(__name__).warning(
            "unreadable imagenet_class_index.json at %s (%s); "
            "decode_predictions keeps synthetic class_i names", src, e)
        return None
    if not isinstance(raw, dict) or len(raw) != 1000:
        logging.getLogger(__name__).warning(
            "unexpected imagenet_class_index.json shape (%s entries); "
            "not installing", len(raw) if isinstance(raw, dict) else "?")
        return None
    os.makedirs(fetcher.cache_dir, exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(raw, f)
    os.replace(tmp, dst)
    from sparkdl_tpu_torch.models import zoo
    zoo._imagenet_class_names.cache_clear()
    return dst
