"""ResNet50 (He et al. 2016, arXiv:1512.03385) in plain float32 PyTorch,
written from the layout of ``keras.applications.resnet50`` with its top:
the 1000-way softmax.

The stem is ZeroPadding2D(3), a 7x7 stride-2 Conv2D, BatchNormalization
(epsilon 1.001e-5), ReLU, ZeroPadding2D(1) and a 3x3 stride-2 max pool.
Each bottleneck (Keras' ``block1``) is a 1x1 conv carrying the stride, a
3x3 "same" conv and a 1x1 conv to four times the filters, each with its
BatchNormalization, added to the shortcut (a strided 1x1 conv with its
BatchNormalization in a stage's first block, else the input) and passed
through ReLU. Stages of 3, 4, 6 and 3 blocks of 64, 128, 256 and 512
filters; every conv has a bias. Global average pooling, then the dense
layer and softmax.

Parameter keys are the program zoo's: in a block that projects its
shortcut, the projection is ``ConvBN_0`` and the main branch
``ConvBN_1..3``; otherwise the main branch is ``ConvBN_0..2``. The input
is the model's uint8 RGB image, preprocessed as ``resnet50.
preprocess_input`` does ("caffe": RGB to BGR, minus the ImageNet means).
No departure from Keras.
"""

from __future__ import annotations

import torch

from perfbench.reference.layers import (
    conv_bn,
    conv_bn_shapes,
    dense,
    global_pool,
    max_pool,
)

INPUT_HW = (224, 224)
EPS = 1.001e-5
_BGR_MEAN = (103.939, 116.779, 123.68)
_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def _blocks():
    """(prefix, in channels, filters, stride, projects) of each block."""
    out, c, i = [], 64, 0
    for s, (blocks, filters) in enumerate(_STAGES):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            out.append((f"Bottleneck_{i}.", c, filters, stride, b == 0))
            c, i = filters * 4, i + 1
    return out


def param_shapes():
    out = conv_bn_shapes("ConvBN_0", 3, 64, (7, 7), bias=True)
    for prefix, c, f, _, project in _blocks():
        convs = [(c, f, (1, 1)), (f, f, (3, 3)), (f, 4 * f, (1, 1))]
        if project:
            convs.insert(0, (c, 4 * f, (1, 1)))
        for i, (cin, cout, k) in enumerate(convs):
            out += conv_bn_shapes(f"{prefix}ConvBN_{i}", cin, cout, k,
                                  bias=True)
    return out + [("fc.weight", (1000, 2048)), ("fc.bias", (1000,))]


def preprocess(x: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC RGB -> float32 NCHW BGR minus the means."""
    mean = torch.tensor(_BGR_MEAN, device=x.device).view(1, 3, 1, 1)
    return torch.flip(x.permute(0, 3, 1, 2).to(torch.float32), [1]) - mean


def logits(state, x: torch.Tensor, quant=None) -> torch.Tensor:
    """uint8 [N, 224, 224, 3] -> float32 logits [N, 1000]."""
    h = torch.nn.functional.pad(preprocess(x), (3, 3, 3, 3))
    h = conv_bn(state, "ConvBN_0", h, 2, "valid", eps=EPS, quant=quant)
    h = max_pool(h, pad=1)
    for prefix, _, _, stride, project in _blocks():
        first = 1 if project else 0
        shortcut = (conv_bn(state, f"{prefix}ConvBN_0", h, stride, "valid",
                            relu=False, eps=EPS, quant=quant)
                    if project else h)
        y = conv_bn(state, f"{prefix}ConvBN_{first}", h, stride, "valid",
                    eps=EPS, quant=quant)
        y = conv_bn(state, f"{prefix}ConvBN_{first + 1}", y, 1, "same",
                    eps=EPS, quant=quant)
        y = conv_bn(state, f"{prefix}ConvBN_{first + 2}", y, 1, "valid",
                    relu=False, eps=EPS, quant=quant)
        h = torch.relu(y + shortcut)
        if quant is not None:
            h = quant.value(h)
    return dense(state, global_pool(h, quant))


def forward(state, x: torch.Tensor, quant=None) -> torch.Tensor:
    """uint8 [N, 224, 224, 3] -> softmax predictions [N, 1000]."""
    return torch.softmax(logits(state, x, quant), dim=-1)
