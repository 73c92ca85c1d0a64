"""Seeded weights for a configuration, made on the run's device.

Conv and dense kernels are drawn normal with standard deviation
sqrt(2 / fan_in) (He et al.), all of them from one draw of the device's
generator seeded by the run's seed. Every other parameter comes from two
more draws of a second generator of the seed, by the ranges a
configuration's ``weights`` gives:

* ``bn_gamma`` [lo, hi]: each BatchNormalization scale uniform in the
  range (InceptionV3's Keras layers have no scale: [1, 1]), times the
  value of the first pattern of ``bn_scale`` that names its key
  (ResNet50's stem 1/64, for an input that spans +-128 after the "caffe"
  preprocessing, and 1/4 on the last unit of each residual branch, so
  the sum of the branches does not grow with depth);
* ``bn_var`` [lo, hi]: each running variance uniform in the range;
* ``bn_mean_std``, ``bn_beta_std``, ``bias_std``: each running mean,
  BatchNormalization offset, and conv or dense bias normal with that
  standard deviation.

So every term of a conv unit moves its output: a program that drops a
running mean, an offset or a bias reads wrong. Activations stay near
unit scale through both networks, where the program's own seeded init
(LeCun-normal) lets them fade.

The keys and shapes come from the configuration's reference, which names
them as the program's zoo does, so the same state dict feeds the program
(through its weight cache) and the reference.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch

from perfbench.inputs import generator


def _kind(key: str) -> str:
    """Which range a non-kernel parameter is drawn from."""
    if key.endswith("bn.weight"):
        return "gamma"
    if key.endswith("running_var"):
        return "var"
    if key.endswith("running_mean"):
        return "mean"
    if key.endswith("bn.bias"):
        return "beta"
    return "bias"


def make_state(shapes, seed: int, device,
               scheme: dict) -> Dict[str, torch.Tensor]:
    """``shapes``: [(key, shape)] as the reference lists them;
    ``scheme``: a configuration's ``weights``."""
    kernels = [(k, s) for k, s in shapes
               if k.endswith(".conv.weight") or k == "fc.weight"]
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
    g_lo, g_hi = scheme["bn_gamma"]
    v_lo, v_hi = scheme["bn_var"]
    std = {"mean": scheme["bn_mean_std"], "beta": scheme["bn_beta_std"],
           "bias": scheme["bias_std"]}
    at = 0
    for key, shape in rest:
        n = math.prod(shape)
        u, z = uniform[at:at + n].view(shape), normal[at:at + n].view(shape)
        at += n
        kind = _kind(key)
        if kind == "gamma":
            base = next((float(v) for p, v in
                         scheme.get("bn_scale", {}).items()
                         if re.fullmatch(p, key)), 1.0)
            state[key] = base * (g_lo + (g_hi - g_lo) * u)
        elif kind == "var":
            state[key] = v_lo + (v_hi - v_lo) * u
        else:
            state[key] = z * std[kind]
    return state
