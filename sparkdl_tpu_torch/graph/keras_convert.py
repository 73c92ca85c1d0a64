"""Keras model → an equivalent ``nn.Module`` of the port, in two halves.

The JAX package runs a Keras 3 model as it is, through Keras's JAX
backend (``sparkdl_tpu/graph/ingest.py::fromKerasModel``). The port
cannot run it through Keras: the card's machine has no keras, and a
process holds one Keras backend. So it converts, in two steps:

* :func:`keras_spec` reads a live Keras model (Sequential or functional,
  from each output back through the layers' inbound nodes) into a
  :class:`KerasSpec`: for each layer call, in order, the layer's class,
  the config keys ``build_module`` reads, the ids of the tensors it reads,
  and each of its variables as float32 numpy keyed by its Keras path,
  with its ``trainable`` flag. It reads Keras objects by their
  attributes and config; keras itself is imported by the caller
  (``graph/ingest.py``, the estimator), whatever backend it runs.
* :func:`build_module` builds one torch module from a spec and imports
  no keras, so it runs where keras is absent. A spec's topology goes to
  JSON and back (:meth:`KerasSpec.to_json`, :meth:`KerasSpec.from_json`);
  its weights never do.

:func:`convert_model` is the two in a row.

Layers converted (the ones the JAX package's tests and examples and the
five keras.applications architectures use): InputLayer, Conv2D,
SeparableConv2D, DepthwiseConv2D, Dense, BatchNormalization, Activation,
ReLU, MaxPooling2D, AveragePooling2D, GlobalAveragePooling2D,
GlobalMaxPooling2D, Flatten, Dropout, Add, Concatenate, ZeroPadding2D,
Rescaling and Reshape, all channels-last. Any other layer raises
``NotImplementedError`` naming its class.

Inside the module a rank-4 tensor is NCHW, as torch's convolutions take
it; every other rank keeps Keras's layout. Keras's channels-last axes map
onto that at each layer (a softmax, a BatchNormalization or a
Concatenate on the last axis acts on dim 1; a Flatten or a Reshape of a
rank-4 tensor goes through NHWC first, so it flattens in HWC order), and
a rank-4 input or output is NHWC at the module's boundary.

Training, as Keras's ``stateless_call(..., training=True)`` runs a
model: variables Keras marks trainable are ``nn.Parameter``\\ s, the
others buffers (:attr:`KerasModule.variables` names each variable's
tensor and its layout), and ``module.train()`` switches two layers.
BatchNormalization normalizes by the batch's mean and biased variance
over every axis but the channel's and moves its moving statistics by
``moving * momentum + batch * (1 - momentum)``, Keras 3's rule, unless
the layer is frozen (``trainable=False``), which keeps it in inference
mode. Dropout drops with its rate, drawing from the generator that
:meth:`KerasModule.seed_dropout` gives it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.graph.function import Tensors
from sparkdl_tpu_torch.models.layers import keras_batch_moments

SUPPORTED_LAYERS = (
    "InputLayer", "Conv2D", "SeparableConv2D", "DepthwiseConv2D", "Dense",
    "BatchNormalization", "Activation", "ReLU", "MaxPooling2D",
    "AveragePooling2D", "GlobalAveragePooling2D", "GlobalMaxPooling2D",
    "Flatten", "Dropout", "Add", "Concatenate", "ZeroPadding2D",
    "Rescaling", "Reshape")

# the config keys build_module reads, per layer class: a spec keeps these
# and drops the rest of Keras's config
_CONV_KEYS = ("strides", "padding", "dilation_rate", "use_bias",
              "activation", "data_format")
_POOL_KEYS = ("pool_size", "strides", "padding", "data_format")
_CONFIG_KEYS = {
    "Conv2D": _CONV_KEYS + ("groups",),
    "SeparableConv2D": _CONV_KEYS,
    "DepthwiseConv2D": _CONV_KEYS,
    "Dense": ("use_bias", "activation"),
    "BatchNormalization": ("axis", "epsilon", "momentum", "center",
                           "scale"),
    "Activation": ("activation",),
    "ReLU": ("negative_slope", "max_value", "threshold"),
    "MaxPooling2D": _POOL_KEYS,
    "AveragePooling2D": _POOL_KEYS,
    "GlobalAveragePooling2D": ("keepdims", "data_format"),
    "GlobalMaxPooling2D": ("keepdims", "data_format"),
    "Flatten": ("data_format",),
    "Dropout": ("rate", "noise_shape"),
    "Concatenate": ("axis",),
    "ZeroPadding2D": ("padding", "data_format"),
    "Rescaling": ("scale", "offset"),
    "Reshape": ("target_shape",),
}

SPEC_FORMAT = "sparkdl_tpu_torch.keras_spec"
SPEC_VERSION = 1


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
    """A Keras variable (any backend), or an array, → a float32 numpy
    array; keras is imported only for a variable."""
    if isinstance(value, np.ndarray):
        return np.asarray(value, dtype=np.float32)
    import keras
    return np.asarray(keras.ops.convert_to_numpy(value), dtype=np.float32)


# -- the spec ----------------------------------------------------------------

@dataclasses.dataclass
class KerasSpec:
    """A Keras model as plain data. ``nodes`` holds one dict per layer
    call, in an order where each call follows the calls that make its
    inputs: ``class`` and ``name`` of the layer, the ``config`` keys the
    ``build_module`` reads, ``inbound`` (the ids of the tensors it reads: 0 is the
    model's input, node ``i``'s output is ``i + 1``), ``in_shapes`` (their
    Keras shapes, batch ``None``), the layer's ``trainable`` flag and its
    ``variables`` (``{"name", "path", "shape", "trainable"}`` each).
    ``output_ids`` are the model's outputs, ``output_shapes`` their Keras
    shapes. ``weights`` maps each variable's path to its float32 value;
    it is not part of the JSON."""

    name: str
    input_shape: Tuple[int, ...]
    input_dtype: str
    nodes: List[Dict[str, Any]]
    output_ids: List[int]
    output_shapes: List[List[Optional[int]]]
    weights: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict,
                                                       repr=False)

    @property
    def output_names(self) -> List[str]:
        return [f"output_{i}" for i in range(len(self.output_ids))]

    def variables(self) -> List[Dict[str, Any]]:
        """Every variable of every node, in node order."""
        return [v for node in self.nodes for v in node["variables"]]

    def to_json(self) -> str:
        """The topology as JSON text, one node a line (no weights)."""
        head = {"format": SPEC_FORMAT, "version": SPEC_VERSION,
                "name": self.name, "input_shape": list(self.input_shape),
                "input_dtype": self.input_dtype,
                "output_ids": list(self.output_ids),
                "output_shapes": [list(s) for s in self.output_shapes]}
        lines = [json.dumps(head, sort_keys=True)[:-1] + ', "nodes": [']
        # numpy values in a config (a Rescaling scale) as Python's
        lines += [json.dumps(node, sort_keys=True,
                             default=lambda v: v.tolist()) + ","
                  for node in self.nodes]
        if self.nodes:
            lines[-1] = lines[-1][:-1]
        lines.append("]}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_json(text: str) -> "KerasSpec":
        """A spec read from :meth:`to_json`'s text, without weights."""
        obj = json.loads(text)
        if obj.get("format") != SPEC_FORMAT or \
                obj.get("version") != SPEC_VERSION:
            raise ValueError(
                f"not a Keras spec of version {SPEC_VERSION} (format "
                f"{obj.get('format')!r}, version {obj.get('version')!r})")
        return KerasSpec(obj["name"], tuple(obj["input_shape"]),
                         obj["input_dtype"], obj["nodes"],
                         list(obj["output_ids"]), obj["output_shapes"])


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


def _shape(shape) -> List[Optional[int]]:
    return [None if d is None else int(d) for d in shape]


def keras_spec(model) -> KerasSpec:
    """A single-input Keras model → its :class:`KerasSpec`, weights
    included."""
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
    nodes: List[Dict[str, Any]] = []
    weights: Dict[str, np.ndarray] = {}
    for op, node in _nodes_in_order(model):
        kind = type(op).__name__
        if kind == "InputLayer":
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
        cfg = op.get_config()
        trainable = {id(v) for v in op.trainable_weights}
        variables = []
        for v in op.weights:
            weights[v.path] = _numpy(v)
            variables.append({"name": v.name, "path": v.path,
                              "shape": _shape(v.shape),
                              "trainable": id(v) in trainable})
        nodes.append({
            "class": kind, "name": op.name,
            "config": {k: cfg[k] for k in _CONFIG_KEYS.get(kind, ())
                       if k in cfg},
            "inbound": [ids[id(t)] for t in ins],
            "in_shapes": [_shape(t.shape) for t in ins],
            "trainable": bool(op.trainable),
            "variables": variables})
        ids[id(out)] = len(ids)
    return KerasSpec(model.name, tuple(int(d) for d in raw_shape),
                     str(inp.dtype or "float32"), nodes,
                     [ids[id(t)] for t in model.outputs],
                     [_shape(t.shape) for t in model.outputs], weights)


# -- variables ---------------------------------------------------------------

def to_torch_layout(value: np.ndarray, layout: str) -> np.ndarray:
    """A Keras variable's value in the layout its tensor holds: a conv
    kernel HWIO → OIHW (``"conv"``), a depthwise kernel (h, w, in, mult)
    → a grouped conv's (in * mult, 1, h, w) (``"depthwise"``; output
    channel i * mult + m, as Keras orders them), a dense kernel (in, out)
    → (out, in) (``"dense"``); ``""`` as it is."""
    if layout == "conv":
        return value.transpose(3, 2, 0, 1)
    if layout == "depthwise":
        h, w, cin, mult = value.shape
        return value.reshape(h, w, cin * mult).transpose(2, 0, 1)[:, None]
    if layout == "dense":
        return value.T
    return value


def to_keras_layout(value: np.ndarray, layout: str,
                    keras_shape: Sequence[int]) -> np.ndarray:
    """The inverse of :func:`to_torch_layout`."""
    if layout == "conv":
        return value.transpose(2, 3, 1, 0)
    if layout == "depthwise":
        return value[:, 0].transpose(1, 2, 0).reshape(tuple(keras_shape))
    if layout == "dense":
        return value.T
    return value


class _Vars:
    """One node's variables by their Keras short name, registered on the
    node's module as parameters (trainable) or buffers."""

    def __init__(self, node: Dict[str, Any], weights: Dict[str, np.ndarray]):
        self.node = node
        self.by_name = {v["name"]: v for v in node["variables"]}
        self.weights = weights
        # path -> (attribute, layout, Keras shape)
        self.registered: Dict[str, Tuple[str, str, Tuple[int, ...]]] = {}

    def value(self, name: str) -> np.ndarray:
        var = self.by_name.get(name)
        if var is None:
            raise ValueError(f"layer {self.node['name']!r} has no variable "
                             f"{name!r}")
        try:
            return self.weights[var["path"]]
        except KeyError:
            raise ValueError(f"the spec has no weights for "
                             f"{var['path']!r}") from None

    def register(self, module: nn.Module, attr: str, name: Optional[str],
                 layout: str = "") -> None:
        """``module.<attr>`` holds variable ``name`` (None: no tensor)."""
        if name is None:
            module.register_buffer(attr, None)
            return
        var = self.by_name.get(name)
        value = to_torch_layout(self.value(name), layout)
        # a copy: a module trains in place, and the spec's arrays are
        # shared by every module built from it
        tensor = torch.from_numpy(np.array(value, dtype=np.float32,
                                           order="C"))
        if var["trainable"]:
            module.register_parameter(attr, nn.Parameter(tensor))
        else:
            module.register_buffer(attr, tensor)
        self.registered[var["path"]] = (attr, layout, tuple(var["shape"]))


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


def _activation(node, rank: int) -> Activation:
    name = node["config"].get("activation", "linear")
    if not isinstance(name, str):
        raise NotImplementedError(
            f"layer {node['name']!r} has a custom activation {name!r}")
    return Activation(name, rank, node["name"])


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


def _pads(node, in_shape, kernel) -> Optional[Tuple[int, int, int, int]]:
    cfg = node["config"]
    padding = cfg["padding"]
    if padding == "valid":
        return None
    if padding != "same":
        raise NotImplementedError(
            f"layer {node['name']!r}: padding {padding!r} is not converted")
    return _same_pads(in_shape[1:3], kernel, cfg["strides"],
                      cfg.get("dilation_rate", (1, 1)))


def _check_channels_last(node) -> None:
    fmt = node["config"].get("data_format", "channels_last")
    if fmt not in (None, "channels_last"):
        raise NotImplementedError(
            f"layer {node['name']!r}: data_format {fmt!r} is not converted "
            "(only channels_last)")


class Conv(nn.Module):
    """Conv2D, DepthwiseConv2D or SeparableConv2D (a depthwise conv then
    a pointwise one), "same" padding by ``F.pad``, then the activation.
    ``weight`` (and ``pointwise`` and ``bias``) are registered by
    :func:`_conv`."""

    def __init__(self, stride, dilation, groups, pads, act: Activation):
        super().__init__()
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


def _conv(node, kind: str, vs: _Vars) -> nn.Module:
    _check_channels_last(node)
    cfg = node["config"]
    (in_shape,) = node["in_shapes"]
    dilation = cfg.get("dilation_rate", (1, 1))
    act = _activation(node, 4)
    if kind == "Conv2D":
        kernel = vs.value("kernel")                 # HWIO
        module = Conv(cfg["strides"], dilation, cfg.get("groups", 1),
                      _pads(node, in_shape, kernel.shape[:2]), act)
        vs.register(module, "weight", "kernel", "conv")
        vs.register(module, "pointwise", None)
    else:
        # (h, w, in, mult): DepthwiseConv2D names it kernel
        name = "kernel" if kind == "DepthwiseConv2D" else "depthwise_kernel"
        depthwise = vs.value(name)
        module = Conv(cfg["strides"], dilation, depthwise.shape[2],
                      _pads(node, in_shape, depthwise.shape[:2]), act)
        vs.register(module, "weight", name, "depthwise")
        vs.register(module, "pointwise",
                    "pointwise_kernel" if kind == "SeparableConv2D"
                    else None, "conv")      # (1, 1, in*mult, out)
    vs.register(module, "bias",
                "bias" if cfg.get("use_bias", True) else None)
    return module


class Dense(nn.Module):
    """``x @ kernel + bias`` on the last Keras axis, then the activation;
    ``weight`` (out, in) and ``bias`` are registered by
    :func:`_build_layer`."""

    def __init__(self, act: Activation):
        super().__init__()
        self.act = act

    def forward(self, x):
        four = x.dim() == 4
        y = F.linear(_to_nhwc(x) if four else x, self.weight, self.bias)
        return self.act(_to_nchw(y) if four else y)


class BatchNorm(nn.Module):
    """BatchNormalization as Keras computes it: ``x * inv + (beta - mean
    * inv)``, ``inv = rsqrt(var + eps) * gamma``. In inference (and in a
    frozen layer) mean and var are the moving statistics; in training
    they are the batch's, over every axis but the channel (the data
    group's whole batch inside ``models/layers.py::synced_batch_stats``),
    which also moves the moving ones by Keras's momentum. ``gamma`` (if
    ``scale``), ``beta`` (if ``center``), ``moving_mean`` and
    ``moving_variance`` are registered by :func:`_batch_norm`."""

    def __init__(self, epsilon: float, momentum: float, dim: int,
                 rank: int, trainable: bool):
        super().__init__()
        self.eps = float(np.float32(epsilon))
        self.momentum = float(momentum)
        self.shape = [1] * rank
        self.shape[dim] = -1
        self.dims = tuple(d for d in range(rank) if d != dim)
        self.trainable = bool(trainable)

    def forward(self, x):
        if self.training and self.trainable:
            mean, var = keras_batch_moments(x, self.dims)
            with torch.no_grad():
                m = self.momentum
                self.moving_mean.copy_(self.moving_mean * m
                                       + mean * (1.0 - m))
                self.moving_variance.copy_(self.moving_variance * m
                                           + var * (1.0 - m))
        else:
            mean, var = self.moving_mean, self.moving_variance
        inv = torch.rsqrt(var + self.eps)
        if self.gamma is not None:
            inv = inv * self.gamma
        res = -mean * inv
        if self.beta is not None:
            res = res + self.beta
        return x * inv.reshape(self.shape) + res.reshape(self.shape)


def _batch_norm(node, vs: _Vars, rank: int) -> nn.Module:
    cfg = node["config"]
    axis = cfg["axis"]
    axis = axis[0] if isinstance(axis, (list, tuple)) else axis
    if axis % rank != rank - 1:
        raise NotImplementedError(
            f"layer {node['name']!r}: BatchNormalization over axis {axis} "
            "is not converted (only the last)")
    module = BatchNorm(cfg["epsilon"], cfg.get("momentum", 0.99),
                       _channel_dim(rank), rank, node.get("trainable", True))
    vs.register(module, "gamma", "gamma" if cfg["scale"] else None)
    vs.register(module, "beta", "beta" if cfg["center"] else None)
    vs.register(module, "moving_mean", "moving_mean")
    vs.register(module, "moving_variance", "moving_variance")
    return module


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


def _pool(node, kind: str) -> nn.Module:
    _check_channels_last(node)
    cfg = node["config"]
    size = cfg["pool_size"]
    stride = cfg["strides"] or size
    pads = None
    if cfg["padding"] == "same":
        pads = _same_pads(node["in_shapes"][0][1:3], size, stride, (1, 1))
    elif cfg["padding"] != "valid":
        raise NotImplementedError(
            f"layer {node['name']!r}: padding {cfg['padding']!r}")
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


class Dropout(nn.Module):
    """The identity in inference; in training each element is kept with
    probability ``1 - rate`` and scaled by its inverse, as Keras does,
    drawn from ``generator`` (None: torch's default one)."""

    def __init__(self, rate: float, noise_shape, layer_name: str):
        super().__init__()
        self.rate = float(rate)
        self.noise_shape = noise_shape
        self.layer_name = layer_name
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        if self.noise_shape is not None:
            raise NotImplementedError(
                f"layer {self.layer_name!r}: training with a Dropout "
                "noise_shape is not converted")
        keep = 1.0 - self.rate
        mask = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
            .bernoulli_(keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


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


def _zero_padding(node) -> nn.Module:
    _check_channels_last(node)
    (top, bottom), (left, right) = node["config"]["padding"]
    return ZeroPad((left, right, top, bottom))


def _build_layer(node: Dict[str, Any], vs: _Vars) -> nn.Module:
    """One node of a spec → its module, its variables registered."""
    kind = node["class"]
    cfg = node["config"]
    rank = len(node["in_shapes"][0])
    if kind in ("Conv2D", "DepthwiseConv2D", "SeparableConv2D"):
        return _conv(node, kind, vs)
    if kind == "Dense":
        module = Dense(_activation(node, rank))
        vs.register(module, "weight", "kernel", "dense")
        vs.register(module, "bias",
                    "bias" if cfg.get("use_bias", True) else None)
        return module
    if kind == "BatchNormalization":
        return _batch_norm(node, vs, rank)
    if kind == "Activation":
        return _activation(node, rank)
    if kind == "ReLU":
        return Relu(cfg.get("negative_slope"), cfg.get("max_value"),
                    cfg.get("threshold"))
    if kind in ("MaxPooling2D", "AveragePooling2D"):
        return _pool(node, "max" if kind == "MaxPooling2D" else "avg")
    if kind in ("GlobalAveragePooling2D", "GlobalMaxPooling2D"):
        _check_channels_last(node)
        return GlobalPool("max" if kind == "GlobalMaxPooling2D" else "avg",
                          bool(cfg.get("keepdims", False)))
    if kind == "Flatten":
        _check_channels_last(node)
        return Flatten()
    if kind == "Dropout":
        return Dropout(cfg.get("rate", 0.0), cfg.get("noise_shape"),
                       node["name"])
    if kind == "Add":
        return Add()
    if kind == "Concatenate":
        return Concatenate(_axis(cfg["axis"], rank))
    if kind == "ZeroPadding2D":
        return _zero_padding(node)
    if kind == "Rescaling":
        return Rescale(cfg["scale"], cfg["offset"], rank)
    if kind == "Reshape":
        return Reshape(cfg["target_shape"])
    raise NotImplementedError(
        f"Keras layer {kind} ({node['name']!r}) is not converted; the port "
        f"converts {', '.join(SUPPORTED_LAYERS)}")


class KerasModule(nn.Module):
    """The converted graph: ``{"input": x}`` → ``{"output_i": y_i}``, each
    step a converted layer on the tensors it reads. ``variables`` maps
    each Keras variable path to ``(name in this module, layout)``, the
    layout as :func:`to_torch_layout` names it; ``keras_shapes`` keeps
    each variable's Keras shape."""

    def __init__(self, layers: List[nn.Module],
                 steps: List[Tuple[int, List[int], int]],
                 output_ids: List[int],
                 variables: Optional[Dict[str, Tuple[str, str]]] = None,
                 keras_shapes: Optional[Dict[str, Tuple[int, ...]]] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.steps = [(i, list(ins), out) for i, ins, out in steps]
        self.output_ids = list(output_ids)
        self.variables = dict(variables or {})
        self.keras_shapes = dict(keras_shapes or {})

    def forward(self, inputs: Tensors) -> Tensors:
        (x,) = inputs.values()
        env: Dict[int, torch.Tensor] = {0: _to_nchw(x)}
        for layer, ins, out in self.steps:
            env[out] = self.layers[layer](*[env[i] for i in ins])
        return {f"output_{i}": _to_nhwc(env[t])
                for i, t in enumerate(self.output_ids)}

    def keras_weights(self) -> Dict[str, np.ndarray]:
        """Every variable's current value in Keras's layout, by path."""
        tensors = dict(self.named_parameters())
        tensors.update(self.named_buffers())
        return {path: to_keras_layout(
                    tensors[name].detach().cpu().numpy(), layout,
                    self.keras_shapes[path])
                for path, (name, layout) in self.variables.items()}

    def seed_dropout(self, generator: Optional[torch.Generator]) -> None:
        """Every Dropout layer draws from ``generator``."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator


def build_module(spec: KerasSpec, device=None) -> KerasModule:
    """The torch module of ``spec`` with its weights (each tensor a copy),
    on ``device`` (None: the CPU, where the weights are; its caller places
    it). Imports no keras."""
    layers, steps = [], []
    variables: Dict[str, Tuple[str, str]] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, node in enumerate(spec.nodes):
        vs = _Vars(node, spec.weights)
        layers.append(_build_layer(node, vs))
        steps.append((i, list(node["inbound"]), i + 1))
        for path, (attr, layout, shape) in vs.registered.items():
            # a layer called twice converts twice: the first call's
            # tensors stand for its variables
            variables.setdefault(path, (f"layers.{i}.{attr}", layout))
            shapes[path] = shape
    module = KerasModule(layers, steps, spec.output_ids, variables, shapes)
    return module if device is None else module.to(device)


def convert_model(model) -> Tuple[KerasModule, Tuple[int, ...], str,
                                  List[str]]:
    """A single-input Keras model → (module, per-row input shape, input
    dtype name, output names)."""
    spec = keras_spec(model)
    return (build_module(spec), spec.input_shape, spec.input_dtype,
            spec.output_names)
