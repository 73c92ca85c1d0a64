"""Weight bridge: a flax variables tree → the port's ``state_dict``.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``
trees of arrays keyed by flax module names. The port's modules carry
the same names (``ConvBN_3``, ``InceptionBlockB_1``, ...), except the
three leaf modules renamed below, so a variable's torch key is its flax
path with those renamed and the leaf mapped:

* conv kernel HWIO → ``conv.weight`` OIHW;
* Dense kernel ``(in, out)`` → ``fc.weight`` ``(out, in)``;
* BatchNorm ``scale``/``bias`` (params) → ``bn.weight``/``bn.bias``,
  ``mean``/``var`` (batch_stats) → ``bn.running_mean``/``running_var``.

Leaves are anything ``numpy.asarray`` reads (numpy or jax arrays); the
bridge imports neither jax nor flax.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_MODULE_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "Dense_0": "fc"}
_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, path + (str(key),))
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
            torch_key = ".".join([_MODULE_NAMES.get(m, m) for m in modules]
                                 + [_LEAF_NAMES[key]])
            out[torch_key] = torch.tensor(arr)   # a contiguous copy
    return out
