"""Seeded weights for a configuration, made on the run's device.

Each parameter the configuration's reference lists (``param_shapes()``)
is of one kind, which says how it is drawn:

* ``kernel``: normal with standard deviation sqrt(2 / fan_in) (He et
  al.), fan_in = numel / shape[0]: the inputs of a Linear ``(out, in)``
  or a fused ``in_proj`` ``(3d, d)``, and ``in x kh x kw`` of a conv
  (``kh x kw`` of a depthwise ``(C, 1, kh, kw)``, as in Keras);
* ``gamma``: a normalisation's scale (BatchNorm or LayerNorm), uniform
  in ``bn_gamma`` [lo, hi], times the value of the first pattern of
  ``bn_scale`` that names its key (ResNet50's stem 1/64, for an input
  that spans +-128 after the "caffe" preprocessing, and 1/4 on the last
  unit of each residual branch, so the sum of the branches does not
  grow with depth);
* ``var``: a running variance, uniform in ``bn_var`` [lo, hi];
* ``mean``, ``beta``, ``bias``, ``embedding``: a running mean, a
  normalisation's offset, a conv or dense bias, and a positional
  embedding or a class or probe token, normal with standard deviation
  ``bn_mean_std``, ``bn_beta_std``, ``bias_std`` and ``embedding_std``.

A reference may declare its parameters' kinds: ``param_kinds()``
returns ``{key: kind}``. A key it does not name takes the kind its
suffix gives, as BatchNorm conv units name theirs: ``.conv.weight`` and
``fc.weight`` are kernels, then ``bn.weight``, ``running_var``,
``running_mean``, ``bn.bias`` and, last, any ``.bias``. A key that
neither names is an error. A configuration's ``weights`` (the scheme)
needs only the keys its kinds read.

All kernels come, in the reference's order, from one draw of the
device's generator seeded by the run's seed; every other parameter, in
order, from a uniform and a normal draw of a second generator of the
seed. So every term of a conv unit moves its output: a program that
drops a running mean, an offset or a bias reads wrong. Activations stay
near unit scale through both CNNs, where the program's own seeded init
(LeCun-normal) lets them fade.

The keys and shapes come from the configuration's reference, which names
them as the program's zoo does, so the same state dict feeds the program
(through its weight cache) and the reference.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import torch

from perfbench.inputs import generator

KINDS = ("kernel", "gamma", "var", "mean", "beta", "bias", "embedding")
# the scheme's standard deviation of each kind drawn normal
_NORMAL_STD = {"mean": "bn_mean_std", "beta": "bn_beta_std",
               "bias": "bias_std", "embedding": "embedding_std"}
# the suffix rule, in order, for keys a reference does not name
_SUFFIXES = (("bn.weight", "gamma"), ("running_var", "var"),
             ("running_mean", "mean"), ("bn.bias", "beta"),
             (".bias", "bias"))


def _suffix_kind(key: str) -> str:
    if key.endswith(".conv.weight") or key == "fc.weight":
        return "kernel"
    for suffix, kind in _SUFFIXES:
        if key.endswith(suffix):
            return kind
    raise ValueError(f"parameter {key!r}: its reference declares no kind "
                     f"for it (param_kinds()) and no suffix rule names it")


def _kinds_of(shapes, declared: Optional[Mapping[str, str]] = None
              ) -> Dict[str, str]:
    """Each key's kind: the reference's declaration, else its suffix."""
    declared = dict(declared or {})
    keys = {k for k, _ in shapes}
    for key, kind in declared.items():
        if key not in keys:
            raise ValueError(f"param_kinds() names {key!r}, which "
                             f"param_shapes() does not list")
        if kind not in KINDS:
            raise ValueError(f"parameter {key!r}: unknown kind {kind!r}; "
                             f"the kinds are {KINDS}")
    return {k: declared.get(k) or _suffix_kind(k) for k, _ in shapes}


def make_state(shapes, seed: int, device, scheme: dict,
               kinds: Optional[Mapping[str, str]] = None
               ) -> Dict[str, torch.Tensor]:
    """``shapes``: [(key, shape)] as the reference lists them;
    ``scheme``: a configuration's ``weights``; ``kinds``: the
    reference's ``param_kinds()``, if it declares any."""
    kind = _kinds_of(shapes, kinds)
    kernels = [(k, s) for k, s in shapes if kind[k] == "kernel"]
    total = sum(math.prod(s) for _, s in kernels)
    gen = generator(seed, 0, device)
    draw = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for key, shape in kernels:
        n = math.prod(shape)
        fan_in = n // shape[0]
        state[key] = draw[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
        at += n

    rest = [(k, s) for k, s in shapes if k not in state]
    total = sum(math.prod(s) for _, s in rest)
    gen = generator(seed, 2, device)
    uniform = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(total, generator=gen, device=device)
    at = 0
    for key, shape in rest:
        n = math.prod(shape)
        u, z = uniform[at:at + n].view(shape), normal[at:at + n].view(shape)
        at += n
        if kind[key] == "gamma":
            g_lo, g_hi = scheme["bn_gamma"]
            base = next((float(v) for p, v in
                         scheme.get("bn_scale", {}).items()
                         if re.fullmatch(p, key)), 1.0)
            state[key] = base * (g_lo + (g_hi - g_lo) * u)
        elif kind[key] == "var":
            v_lo, v_hi = scheme["bn_var"]
            state[key] = v_lo + (v_hi - v_lo) * u
        else:
            state[key] = z * scheme[_NORMAL_STD[kind[key]]]
    return state


def for_cell(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's seeded weights: its reference's shapes and kinds, its
    configuration's scheme."""
    ref = cell.reference()
    kinds = ref.param_kinds() if hasattr(ref, "param_kinds") else None
    return make_state(ref.param_shapes(), seed, device,
                      cell.config["weights"], kinds)
