"""InceptionV3 (Szegedy et al. 2016, arXiv:1512.00567) in plain float32
PyTorch, written from the layout of ``keras.applications.inception_v3``
(``include_top=False, pooling="avg"``: the 2048-d features).

Each ``conv2d_bn`` is Conv2D without bias, BatchNormalization (epsilon
1e-3) and ReLU. The mixed blocks' branches are listed in Keras' order,
which is also the order of their concatenation. Parameter keys are the
program zoo's (``ConvBN_<i>`` in creation order inside each block).

Departures from Keras: Keras' BatchNormalization here has no scale
(``scale=False``); the state dict carries one (``bn.weight``) and it is
applied, so a scale of 1 is Keras' layer. The input is the model's
uint8 image, preprocessed as ``inception_v3.preprocess_input`` does
(x / 127.5 - 1).
"""

from __future__ import annotations

import torch

from perfbench.reference.layers import (
    avg_pool_same,
    conv_bn,
    conv_bn_shapes,
    global_pool,
    max_pool,
)

INPUT_HW = (299, 299)
FEATURES = 2048

# (kind, argument) of each block after the stem, in order
_BLOCKS = ([("A", p) for p in (32, 64, 64)] + [("RA", None)]
           + [("B", c7) for c7 in (128, 160, 160, 192)] + [("RB", None)]
           + [("C", None)] * 2)
_NAMES = {"A": "InceptionBlockA", "RA": "ReductionA",
          "B": "InceptionBlockB", "RB": "ReductionB",
          "C": "InceptionBlockC"}


def _block_convs(kind, arg, c):
    """(in, out, kernel, stride, padding) of a block's convs in creation
    order, and the block's output channels."""
    if kind == "A":
        return [(c, 64, (1, 1), 1, "same"),
                (c, 48, (1, 1), 1, "same"), (48, 64, (5, 5), 1, "same"),
                (c, 64, (1, 1), 1, "same"), (64, 96, (3, 3), 1, "same"),
                (96, 96, (3, 3), 1, "same"),
                (c, arg, (1, 1), 1, "same")], 224 + arg
    if kind == "RA":
        return [(c, 384, (3, 3), 2, "valid"),
                (c, 64, (1, 1), 1, "same"), (64, 96, (3, 3), 1, "same"),
                (96, 96, (3, 3), 2, "valid")], 480 + c
    if kind == "B":
        return [(c, 192, (1, 1), 1, "same"),
                (c, arg, (1, 1), 1, "same"), (arg, arg, (1, 7), 1, "same"),
                (arg, 192, (7, 1), 1, "same"),
                (c, arg, (1, 1), 1, "same"), (arg, arg, (7, 1), 1, "same"),
                (arg, arg, (1, 7), 1, "same"), (arg, arg, (7, 1), 1, "same"),
                (arg, 192, (1, 7), 1, "same"),
                (c, 192, (1, 1), 1, "same")], 768
    if kind == "RB":
        return [(c, 192, (1, 1), 1, "same"),
                (192, 320, (3, 3), 2, "valid"),
                (c, 192, (1, 1), 1, "same"), (192, 192, (1, 7), 1, "same"),
                (192, 192, (7, 1), 1, "same"),
                (192, 192, (3, 3), 2, "valid")], 512 + c
    return [(c, 320, (1, 1), 1, "same"),
            (c, 384, (1, 1), 1, "same"), (384, 384, (1, 3), 1, "same"),
            (384, 384, (3, 1), 1, "same"),
            (c, 448, (1, 1), 1, "same"), (448, 384, (3, 3), 1, "same"),
            (384, 384, (1, 3), 1, "same"), (384, 384, (3, 1), 1, "same"),
            (c, 192, (1, 1), 1, "same")], 2048


_STEM = [(3, 32, (3, 3), 2, "valid"), (32, 32, (3, 3), 1, "valid"),
         (32, 64, (3, 3), 1, "same"), (64, 80, (1, 1), 1, "valid"),
         (80, 192, (3, 3), 1, "valid")]


def _layout():
    """[(block prefix or "", kind, [conv specs])] for the whole net."""
    out = [("", "stem", _STEM)]
    counts, c = {}, 192
    for kind, arg in _BLOCKS:
        i = counts[kind] = counts.get(kind, -1) + 1
        convs, c = _block_convs(kind, arg, c)
        out.append((f"{_NAMES[kind]}_{i}.", kind, convs))
    return out


def param_shapes():
    """[(key, shape)] of every parameter and statistic, with the dense
    top (``fc``) the zoo's state dict also carries."""
    out = []
    for prefix, _, convs in _layout():
        for i, (cin, cout, k, _, _) in enumerate(convs):
            out += conv_bn_shapes(f"{prefix}ConvBN_{i}", cin, cout, k)
    return out + [("fc.weight", (1000, FEATURES)), ("fc.bias", (1000,))]


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [-1, 1]."""
    return x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0


def forward(state, x: torch.Tensor, quant=None) -> torch.Tensor:
    """uint8 [N, 299, 299, 3] -> float32 features [N, 2048]."""
    h = preprocess(x)
    for prefix, kind, convs in _layout():
        def cb(i, t):
            _, _, _, stride, pad = convs[i]
            return conv_bn(state, f"{prefix}ConvBN_{i}", t, stride, pad,
                           quant=quant)
        if kind == "stem":
            h = cb(2, cb(1, cb(0, h)))
            h = max_pool(h)
            h = cb(4, cb(3, h))
            h = max_pool(h)
        elif kind == "A":
            h = torch.cat([cb(0, h), cb(2, cb(1, h)),
                           cb(5, cb(4, cb(3, h))),
                           cb(6, avg_pool_same(h))], dim=1)
        elif kind == "RA":
            h = torch.cat([cb(0, h), cb(3, cb(2, cb(1, h))), max_pool(h)],
                          dim=1)
        elif kind == "B":
            b7 = cb(3, cb(2, cb(1, h)))
            bd = cb(8, cb(7, cb(6, cb(5, cb(4, h)))))
            h = torch.cat([cb(0, h), b7, bd, cb(9, avg_pool_same(h))],
                          dim=1)
        elif kind == "RB":
            h = torch.cat([cb(1, cb(0, h)), cb(5, cb(4, cb(3, cb(2, h)))),
                           max_pool(h)], dim=1)
        else:
            b3 = cb(1, h)
            bd = cb(5, cb(4, h))
            h = torch.cat([cb(0, h), cb(2, b3), cb(3, b3), cb(6, bd),
                           cb(7, bd), cb(8, avg_pool_same(h))], dim=1)
    return global_pool(h, quant)
