"""Weight bridge: a flax variables tree → the port's ``state_dict``.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``
trees of arrays keyed by flax module names. The port's modules carry
the same names (``ConvBN_3``, ``InceptionBlockB_1``, ``Conv_0`` of VGG,
...), except the leaf modules renamed by their parent, so a variable's
torch key is its flax path with those renamed and the leaf mapped. The
parent is known by what it holds — a ``BatchNorm_0`` beside its conv(s)
is a ``ConvBN`` or a ``SeparableConvBN``, wherever it sits (a lone layer
is the tree's root):

* in a ``ConvBN`` (``Conv_0`` + ``BatchNorm_0``): ``Conv_0`` → ``conv``,
  ``BatchNorm_0`` → ``bn``;
* in a ``SeparableConvBN`` (``Conv_0``, ``Conv_1`` + ``BatchNorm_0``):
  ``Conv_0`` (the depthwise conv) → ``depthwise``, ``Conv_1`` (the
  pointwise conv) → ``pointwise``, ``BatchNorm_0`` → ``bn``;
* a model's single head ``Dense_0`` (no ``Dense_1`` beside it) →
  ``fc``; VGG's ``Conv_0…Conv_12`` and ``Dense_0…Dense_2`` (no
  BatchNorm beside them) keep their names.

Leaves:

* conv kernel HWIO → ``weight`` OIHW (a depthwise kernel
  ``(kh, kw, 1, C)`` becomes ``(C, 1, kh, kw)``, the layout of a conv
  with ``groups=C``);
* Dense kernel ``(in, out)`` → ``weight`` ``(out, in)``;
* BatchNorm ``scale``/``bias`` (params) → ``bn.weight``/``bn.bias``,
  ``mean``/``var`` (batch_stats) → ``bn.running_mean``/``running_var``.

Leaves are anything ``numpy.asarray`` reads (numpy or jax arrays, or the
views ``models/msgpack.py`` returns); the bridge imports neither jax nor
flax.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# leaf-module renames in a ConvBN and in a SeparableConvBN
_CONV_BN = {"Conv_0": "conv", "BatchNorm_0": "bn"}
_SEPARABLE = {"Conv_0": "depthwise", "Conv_1": "pointwise",
              "BatchNorm_0": "bn"}
_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _module_name(name: str, siblings) -> str:
    if "BatchNorm_0" in siblings:
        renames = _SEPARABLE if "Conv_1" in siblings else _CONV_BN
        return renames.get(name, name)
    if name == "Dense_0" and "Dense_1" not in siblings:
        return "fc"
    return name


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(torch module path + flax leaf name, leaf) for every leaf."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, path + (_module_name(str(key), tree),))
        else:
            yield path + (str(key),), value


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax variables tree into a float32 torch state dict
    (load it with ``module.load_state_dict(..., strict=True)``)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _walk(tree):
            *modules, name = path
            key = (collection, name)
            if key not in _LEAF_NAMES:
                raise ValueError(
                    f"no torch counterpart for {collection}/"
                    f"{'/'.join(path)}")
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)   # HWIO → OIHW
                elif arr.ndim == 2:
                    arr = arr.T                       # (in, out) → (out, in)
                else:
                    raise ValueError(
                        f"unexpected kernel rank {arr.ndim} at "
                        f"{'/'.join(path)}")
            torch_key = ".".join(modules + [_LEAF_NAMES[key]])
            out[torch_key] = torch.tensor(np.ascontiguousarray(arr))
    return out
