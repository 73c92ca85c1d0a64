"""Keras model → an equivalent ``nn.Module`` of the port.

The JAX package runs a Keras 3 model as it is, through Keras's JAX
backend (``sparkdl_tpu/graph/ingest.py::fromKerasModel``). The port
cannot run it through Keras: the card's machine has no keras, and a
process holds one Keras backend. So it converts: it reads the model's
layer graph (Sequential or functional, from each output back through the
layers' inbound nodes), takes each layer's weights as numpy arrays from
whatever backend Keras runs, and builds one torch module that computes
the same function on the device. keras is imported by the caller only
(``graph/ingest.py``); this module reads Keras objects by their
attributes and config and imports no keras itself.

Layers converted (the ones the JAX package's tests and examples and the
five keras.applications architectures use): InputLayer, Conv2D,
SeparableConv2D, DepthwiseConv2D, Dense, BatchNormalization, Activation,
ReLU, MaxPooling2D, AveragePooling2D, GlobalAveragePooling2D,
GlobalMaxPooling2D, Flatten, Dropout (the identity at inference), Add,
Concatenate, ZeroPadding2D, Rescaling and Reshape, all channels-last.
Any other layer raises ``NotImplementedError`` naming its class.

Inside the module a rank-4 tensor is NCHW, as torch's convolutions take
it; every other rank keeps Keras's layout. Keras's channels-last axes map
onto that at each layer (a softmax, a BatchNormalization or a
Concatenate on the last axis acts on dim 1; a Flatten or a Reshape of a
rank-4 tensor goes through NHWC first, so it flattens in HWC order), and
a rank-4 input or output is NHWC at the module's boundary.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.graph.function import Tensors

SUPPORTED_LAYERS = (
    "InputLayer", "Conv2D", "SeparableConv2D", "DepthwiseConv2D", "Dense",
    "BatchNormalization", "Activation", "ReLU", "MaxPooling2D",
    "AveragePooling2D", "GlobalAveragePooling2D", "GlobalMaxPooling2D",
    "Flatten", "Dropout", "Add", "Concatenate", "ZeroPadding2D",
    "Rescaling", "Reshape")


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _channel_dim(rank: int) -> int:
    """Keras's last (channel) axis inside the module."""
    return 1 if rank == 4 else rank - 1


def _axis(axis: int, rank: int) -> int:
    """A Keras axis of a rank-``rank`` tensor, inside the module."""
    axis = axis % rank
    if rank == 4:
        return (0, 2, 3, 1)[axis]
    return axis


def _numpy(value) -> np.ndarray:
    """A Keras variable (any backend) → a float32 numpy array."""
    import keras
    return np.asarray(keras.ops.convert_to_numpy(value), dtype=np.float32)


def _buffer(module: nn.Module, name: str, value) -> None:
    module.register_buffer(
        name, None if value is None else torch.from_numpy(
            np.ascontiguousarray(value, dtype=np.float32)))


# -- activations -------------------------------------------------------------

def _relu(x, negative_slope=0.0, max_value=None, threshold=0.0):
    """keras.activations.relu with its options, in its order of ops."""
    if negative_slope != 0.0:
        negative_part = (F.relu(-x + threshold) if threshold != 0.0
                         else F.relu(-x))
    if threshold != 0.0:
        x = x * (x > threshold).to(x.dtype)
    else:
        x = F.relu(x)
    if max_value is not None:
        x = torch.clamp(x, 0.0, float(max_value))
    if negative_slope != 0.0:
        x = x - negative_slope * negative_part
    return x


_ACTIVATIONS = {
    "linear": lambda x, dim: x,
    "relu": lambda x, dim: F.relu(x),
    "relu6": lambda x, dim: torch.clamp(x, 0.0, 6.0),
    "sigmoid": lambda x, dim: torch.sigmoid(x),
    "tanh": lambda x, dim: torch.tanh(x),
    "softmax": lambda x, dim: torch.softmax(x, dim=dim),
    "log_softmax": lambda x, dim: torch.log_softmax(x, dim=dim),
    "silu": lambda x, dim: F.silu(x),
    "swish": lambda x, dim: F.silu(x),
    "elu": lambda x, dim: F.elu(x),
    "selu": lambda x, dim: F.selu(x),
    "softplus": lambda x, dim: F.softplus(x),
    "softsign": lambda x, dim: F.softsign(x),
    "exponential": lambda x, dim: torch.exp(x),
    "gelu": lambda x, dim: F.gelu(x),
}


class Activation(nn.Module):
    """A named Keras activation; softmax over the channel axis."""

    def __init__(self, name: str, rank: int, layer_name: str = ""):
        super().__init__()
        if name not in _ACTIVATIONS:
            raise NotImplementedError(
                f"activation {name!r} (layer {layer_name!r}) is not "
                f"converted; converted: {sorted(_ACTIVATIONS)}")
        self.act = name
        self.dim = _channel_dim(rank)

    def forward(self, x):
        return _ACTIVATIONS[self.act](x, self.dim)


def _activation(layer, rank: int) -> Activation:
    name = layer.get_config().get("activation", "linear")
    if not isinstance(name, str):
        raise NotImplementedError(
            f"layer {layer.name!r} has a custom activation {name!r}")
    return Activation(name, rank, layer.name)


# -- layers ------------------------------------------------------------------

def _same_pads(size: Sequence[int], kernel: Sequence[int],
               stride: Sequence[int], dilation: Sequence[int]
               ) -> Tuple[int, int, int, int]:
    """Keras's (lax's) "same" padding of H and W as ``F.pad``'s (left,
    right, top, bottom): the total a dim needs, the smaller half before
    (a stride-2 even input pads one more at the bottom and right, which
    ``nn.Conv2d``'s symmetric padding cannot say)."""
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        out = math.ceil(n / s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    return left, right, top, bottom


def _pads(layer, in_shape, kernel) -> Optional[Tuple[int, int, int, int]]:
    cfg = layer.get_config()
    padding = cfg["padding"]
    if padding == "valid":
        return None
    if padding != "same":
        raise NotImplementedError(
            f"layer {layer.name!r}: padding {padding!r} is not converted")
    return _same_pads(in_shape[1:3], kernel, cfg["strides"],
                      cfg.get("dilation_rate", (1, 1)))


def _check_channels_last(layer) -> None:
    fmt = layer.get_config().get("data_format", "channels_last")
    if fmt not in (None, "channels_last"):
        raise NotImplementedError(
            f"layer {layer.name!r}: data_format {fmt!r} is not converted "
            "(only channels_last)")


class Conv(nn.Module):
    """Conv2D, DepthwiseConv2D or SeparableConv2D (a depthwise conv then
    a pointwise one), "same" padding by ``F.pad``, then the activation."""

    def __init__(self, weight, bias, stride, dilation, groups, pads,
                 act: Activation, pointwise=None):
        super().__init__()
        _buffer(self, "weight", weight)
        _buffer(self, "pointwise", pointwise)
        _buffer(self, "bias", bias)
        self.stride = tuple(stride)
        self.dilation = tuple(dilation)
        self.groups = groups
        self.pads = pads
        self.act = act

    def forward(self, x):
        if self.pads is not None:
            x = F.pad(x, self.pads)
        if self.pointwise is None:
            y = F.conv2d(x, self.weight, self.bias, self.stride, 0,
                         self.dilation, self.groups)
        else:
            y = F.conv2d(x, self.weight, None, self.stride, 0,
                         self.dilation, self.groups)
            y = F.conv2d(y, self.pointwise, self.bias)
        return self.act(y)


def _depthwise(kernel: np.ndarray) -> np.ndarray:
    """Keras depthwise kernel (h, w, in, mult) → a grouped conv's OIHW
    weight (in * mult, 1, h, w); output channel i * mult + m, as Keras
    orders them."""
    h, w, cin, mult = kernel.shape
    return kernel.reshape(h, w, cin * mult).transpose(2, 0, 1)[:, None]


def _conv(layer, kind: str, in_shapes, rank) -> nn.Module:
    _check_channels_last(layer)
    cfg = layer.get_config()
    (in_shape,) = in_shapes
    dilation = cfg.get("dilation_rate", (1, 1))
    bias = _numpy(layer.bias) if cfg.get("use_bias", True) else None
    act = _activation(layer, 4)
    if kind == "Conv2D":
        kernel = _numpy(layer.kernel)          # HWIO
        return Conv(kernel.transpose(3, 2, 0, 1), bias, cfg["strides"],
                    dilation, cfg.get("groups", 1),
                    _pads(layer, in_shape, kernel.shape[:2]), act)
    # (h, w, in, mult): DepthwiseConv2D names it kernel
    depthwise = _numpy(layer.kernel if kind == "DepthwiseConv2D"
                       else layer.depthwise_kernel)
    pads = _pads(layer, in_shape, depthwise.shape[:2])
    weight = _depthwise(depthwise)
    if kind == "DepthwiseConv2D":
        return Conv(weight, bias, cfg["strides"], dilation,
                    depthwise.shape[2], pads, act)
    pointwise = _numpy(layer.pointwise_kernel)     # (1, 1, in*mult, out)
    return Conv(weight, bias, cfg["strides"], dilation, depthwise.shape[2],
                pads, act, pointwise=pointwise.transpose(3, 2, 0, 1))


class Dense(nn.Module):
    """``x @ kernel + bias`` on the last Keras axis, then the
    activation."""

    def __init__(self, kernel, bias, act: Activation):
        super().__init__()
        _buffer(self, "weight", kernel.T)
        _buffer(self, "bias", bias)
        self.act = act

    def forward(self, x):
        four = x.dim() == 4
        y = F.linear(_to_nhwc(x) if four else x, self.weight, self.bias)
        return self.act(_to_nchw(y) if four else y)


class BatchNorm(nn.Module):
    """Inference BatchNormalization as Keras computes it:
    ``x * inv + (beta - mean * inv)``, ``inv = rsqrt(var + eps) *
    gamma``."""

    def __init__(self, mean, var, gamma, beta, epsilon: float, dim: int,
                 rank: int):
        super().__init__()
        shape = [1] * rank
        shape[dim] = -1
        inv = torch.rsqrt(torch.from_numpy(var) + np.float32(epsilon))
        if gamma is not None:
            inv = inv * torch.from_numpy(gamma)
        res = -torch.from_numpy(mean) * inv
        if beta is not None:
            res = res + torch.from_numpy(beta)
        self.register_buffer("inv", inv.reshape(shape).contiguous())
        self.register_buffer("res", res.reshape(shape).contiguous())

    def forward(self, x):
        return x * self.inv + self.res


def _batch_norm(layer, in_shapes, rank) -> nn.Module:
    cfg = layer.get_config()
    axis = cfg["axis"]
    axis = axis[0] if isinstance(axis, (list, tuple)) else axis
    if axis % rank != rank - 1:
        raise NotImplementedError(
            f"layer {layer.name!r}: BatchNormalization over axis {axis} "
            "is not converted (only the last)")
    return BatchNorm(_numpy(layer.moving_mean), _numpy(layer.moving_variance),
                     _numpy(layer.gamma) if cfg["scale"] else None,
                     _numpy(layer.beta) if cfg["center"] else None,
                     cfg["epsilon"], _channel_dim(rank), rank)


class Relu(nn.Module):
    def __init__(self, negative_slope, max_value, threshold):
        super().__init__()
        self.negative_slope = float(negative_slope or 0.0)
        self.max_value = max_value
        self.threshold = float(threshold or 0.0)

    def forward(self, x):
        return _relu(x, self.negative_slope, self.max_value, self.threshold)


class Pool(nn.Module):
    """Max or average pooling; "same" pads by ``F.pad`` (-inf for max)
    and an average divides by the window's real pixels, as Keras does."""

    def __init__(self, kind: str, size, stride, pads):
        super().__init__()
        self.kind = kind
        self.size = tuple(size)
        self.stride = tuple(stride)
        self.pads = pads

    def forward(self, x):
        if self.kind == "max":
            if self.pads is not None:
                x = F.pad(x, self.pads, value=float("-inf"))
            return F.max_pool2d(x, self.size, self.stride)
        if self.pads is None:
            return F.avg_pool2d(x, self.size, self.stride)
        # window sums over window counts of the pixels inside the image
        total = F.avg_pool2d(F.pad(x, self.pads), self.size, self.stride,
                             divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        count = F.avg_pool2d(F.pad(ones, self.pads), self.size, self.stride,
                             divisor_override=1)
        return total / count


def _pool(layer, kind: str, in_shapes, rank) -> nn.Module:
    _check_channels_last(layer)
    cfg = layer.get_config()
    size = cfg["pool_size"]
    stride = cfg["strides"] or size
    pads = None
    if cfg["padding"] == "same":
        pads = _same_pads(in_shapes[0][1:3], size, stride, (1, 1))
    elif cfg["padding"] != "valid":
        raise NotImplementedError(
            f"layer {layer.name!r}: padding {cfg['padding']!r}")
    return Pool(kind, size, stride, pads)


class GlobalPool(nn.Module):
    def __init__(self, kind: str, keepdims: bool):
        super().__init__()
        self.kind = kind
        self.keepdims = keepdims

    def forward(self, x):
        if self.kind == "max":
            return torch.amax(x, dim=(2, 3), keepdim=self.keepdims)
        return torch.mean(x, dim=(2, 3), keepdim=self.keepdims)


class Flatten(nn.Module):
    def forward(self, x):
        return _to_nhwc(x).reshape(x.shape[0], -1)


class Identity(nn.Module):
    def forward(self, x):
        return x


class Add(nn.Module):
    def forward(self, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class Concatenate(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, *xs):
        return torch.cat(xs, dim=self.dim)


class ZeroPad(nn.Module):
    def __init__(self, pads):
        super().__init__()
        self.pads = tuple(pads)

    def forward(self, x):
        return F.pad(x, self.pads)


class Rescale(nn.Module):
    def __init__(self, scale, offset, rank: int):
        super().__init__()
        shape = [1] * rank
        shape[_channel_dim(rank)] = -1
        for name, value in (("scale", scale), ("offset", offset)):
            value = np.asarray(value, dtype=np.float32)
            if value.ndim > 1:
                raise NotImplementedError(
                    f"Rescaling with a {name} of shape {value.shape} is "
                    "not converted (scalars and per-channel vectors are)")
            self.register_buffer(name, torch.from_numpy(
                value.reshape(shape) if value.ndim else value))

    def forward(self, x):
        return x.to(torch.float32) * self.scale + self.offset


class Reshape(nn.Module):
    def __init__(self, target: Sequence[int]):
        super().__init__()
        self.target = tuple(int(d) for d in target)

    def forward(self, x):
        return _to_nchw(_to_nhwc(x).reshape((x.shape[0],) + self.target))


def _zero_padding(layer) -> nn.Module:
    _check_channels_last(layer)
    (top, bottom), (left, right) = layer.get_config()["padding"]
    return ZeroPad((left, right, top, bottom))


def convert_layer(layer, in_shapes: List[Tuple], rank: int) -> nn.Module:
    """One Keras layer → its module, given its inputs' Keras shapes and
    the rank of its first input."""
    kind = type(layer).__name__
    cfg = layer.get_config()
    if kind in ("Conv2D", "DepthwiseConv2D", "SeparableConv2D"):
        return _conv(layer, kind, in_shapes, rank)
    if kind == "Dense":
        return Dense(_numpy(layer.kernel),
                     _numpy(layer.bias) if cfg.get("use_bias", True)
                     else None, _activation(layer, rank))
    if kind == "BatchNormalization":
        return _batch_norm(layer, in_shapes, rank)
    if kind == "Activation":
        return _activation(layer, rank)
    if kind == "ReLU":
        return Relu(cfg.get("negative_slope"), cfg.get("max_value"),
                    cfg.get("threshold"))
    if kind in ("MaxPooling2D", "AveragePooling2D"):
        return _pool(layer, "max" if kind == "MaxPooling2D" else "avg",
                     in_shapes, rank)
    if kind in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
        _check_channels_last(layer)
        return GlobalPool("max" if kind == "GlobalMaxPooling2D" else "avg",
                          bool(cfg.get("keepdims", False)))
    if kind == "Flatten":
        _check_channels_last(layer)
        return Flatten()
    if kind in ("Dropout", "InputLayer"):
        return Identity()
    if kind == "Add":
        return Add()
    if kind == "Concatenate":
        return Concatenate(_axis(cfg["axis"], rank))
    if kind == "ZeroPadding2D":
        return _zero_padding(layer)
    if kind == "Rescaling":
        return Rescale(cfg["scale"], cfg["offset"], rank)
    if kind == "Reshape":
        return Reshape(cfg["target_shape"])
    raise NotImplementedError(
        f"Keras layer {kind} ({layer.name!r}) is not converted; the port "
        f"converts {', '.join(SUPPORTED_LAYERS)}")


class KerasModule(nn.Module):
    """The converted graph: ``{"input": x}`` → ``{"output_i": y_i}``, each
    step a converted layer on the tensors it reads."""

    def __init__(self, layers: List[nn.Module],
                 steps: List[Tuple[int, List[int], int]],
                 output_ids: List[int]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.steps = [(i, list(ins), out) for i, ins, out in steps]
        self.output_ids = list(output_ids)

    def forward(self, inputs: Tensors) -> Tensors:
        (x,) = inputs.values()
        env: Dict[int, torch.Tensor] = {0: _to_nchw(x)}
        for layer, ins, out in self.steps:
            env[out] = self.layers[layer](*[env[i] for i in ins])
        return {f"output_{i}": _to_nhwc(env[t])
                for i, t in enumerate(self.output_ids)}


def _nodes_in_order(model):
    """(layer, node) of every layer call from the inputs to the outputs,
    each after the calls that make its inputs."""
    order, done = [], set()
    stack = [(t, False) for t in reversed(model.outputs)]
    while stack:
        tensor, expanded = stack.pop()
        op, node_index, _ = tensor._keras_history
        node = op._inbound_nodes[node_index]
        if id(node) in done:
            continue
        if expanded:
            done.add(id(node))
            order.append((op, node))
            continue
        stack.append((tensor, True))
        stack.extend((t, False) for t in reversed(node.input_tensors))
    return order


def convert_model(model) -> Tuple[KerasModule, Tuple[int, ...], str,
                                  List[str]]:
    """A single-input Keras model → (module, per-row input shape, input
    dtype name, output names)."""
    import keras
    if len(model.inputs) != 1:
        raise ValueError(
            f"expected a single-input model, got {len(model.inputs)}")
    (inp,) = model.inputs
    raw_shape = inp.shape[1:]
    if any(d is None for d in raw_shape):
        raise ValueError(
            f"model {model.name!r} has dynamic input shape {inp.shape}; "
            "rebuild it with concrete input dims (e.g. Input((224, 224, 3)) "
            "instead of Input((None, None, 3)))")
    ids = {id(inp): 0}
    layers, steps = [], []
    for op, node in _nodes_in_order(model):
        if type(op).__name__ == "InputLayer":
            for t in node.output_tensors:
                if id(t) not in ids:
                    raise ValueError(f"input layer {op.name!r} is not the "
                                     "model's input")
            continue
        if isinstance(op, keras.Model):
            raise NotImplementedError(
                f"a nested model ({type(op).__name__} {op.name!r}) is not "
                "converted; flatten it into one functional model")
        ins = list(node.input_tensors)
        (out,) = node.output_tensors
        module = convert_layer(op, [tuple(t.shape) for t in ins],
                               len(ins[0].shape))
        ids[id(out)] = len(ids)
        steps.append((len(layers), [ids[id(t)] for t in ins], ids[id(out)]))
        layers.append(module)
    outputs = [ids[id(t)] for t in model.outputs]
    return (KerasModule(layers, steps, outputs),
            tuple(int(d) for d in raw_shape), str(inp.dtype or "float32"),
            [f"output_{i}" for i in range(len(outputs))])
