"""Named-model zoo registry — counterpart of ``sparkdl_tpu/models/zoo.py``:
every model the JAX zoo carries (InceptionV3, Xception, ResNet50, VGG16,
VGG19 and the tiny TestNet), their weights, class indices and
``decode_predictions``; and one model the JAX package does not carry,
the SigLIP so400m/14 vision tower at 384 (``models/siglip.py``), a
featurizer without a classifier.

Preprocessing is part of the model function: uint8 NHWC comes in, is
viewed as NCHW (channels_last in memory, no copy), preprocessed on the
device and fed to the network.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch._device import DeviceLike, resolve_device
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.fetcher import ModelFetcher
from sparkdl_tpu_torch.models.inception import InceptionV3
from sparkdl_tpu_torch.models.layers import BatchNorm, LayerNorm
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.models.siglip import SigLIP
from sparkdl_tpu_torch.models.testnet import TestNet
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception


def _inception_preprocess(x: torch.Tensor) -> torch.Tensor:
    """uint8 → [-1, 1] float32 (x/127.5 - 1, InceptionV3/Xception; SigLIP's
    rescale with mean 0.5 and std 0.5)."""
    return x.to(torch.float32) * (1.0 / 127.5) - 1.0


_CAFFE_MEAN = (103.939, 116.779, 123.68)  # BGR means


def _caffe_preprocess(x: torch.Tensor,
                      mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 RGB NCHW → BGR float32, ImageNet-mean-subtracted (VGG and
    ResNet50). ``ZooModel`` passes the means as a buffer on the model's
    device (a copy from the host each batch would wait for the device's
    queue, and a tensor made inside a trace would be the trace's)."""
    if mean is None:
        mean = torch.tensor(_CAFFE_MEAN, dtype=torch.float32,
                            device=x.device).view(1, 3, 1, 1)
    return torch.flip(x.to(torch.float32), [1]) - mean


def _testnet_preprocess(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / 255.0)


@dataclasses.dataclass(frozen=True)
class NamedImageModel:
    """Zoo entry: constructor, input size, preprocess, output widths
    (``num_classes`` None: a featurizer without a classifier)."""

    name: str
    module_fn: Callable[..., nn.Module]   # (dtype=...) -> module
    input_size: Tuple[int, int]           # (height, width)
    preprocess: Callable[[torch.Tensor], torch.Tensor]
    feature_dim: int
    num_classes: Optional[int] = 1000

    @property
    def height(self) -> int:
        return self.input_size[0]

    @property
    def width(self) -> int:
        return self.input_size[1]


KERAS_APPLICATION_MODELS: Dict[str, NamedImageModel] = {
    m.name: m for m in [
        NamedImageModel("InceptionV3", InceptionV3, (299, 299),
                        _inception_preprocess, 2048),
        NamedImageModel("Xception", Xception, (299, 299),
                        _inception_preprocess, 2048),
        NamedImageModel("ResNet50", ResNet50, (224, 224),
                        _caffe_preprocess, 2048),
        NamedImageModel("VGG16", VGG16, (224, 224),
                        _caffe_preprocess, 4096),
        NamedImageModel("VGG19", VGG19, (224, 224),
                        _caffe_preprocess, 4096),
        NamedImageModel("TestNet", TestNet, (32, 32),
                        _testnet_preprocess, 16, num_classes=10),
        NamedImageModel("SigLIP-so400m-patch14-384", SigLIP, (384, 384),
                        _inception_preprocess, 1152, num_classes=None),
    ]
}

SUPPORTED_MODELS = tuple(KERAS_APPLICATION_MODELS)


def getKerasApplicationModel(name: str) -> NamedImageModel:
    if name not in KERAS_APPLICATION_MODELS:
        raise ValueError(
            f"unsupported model {name!r}; supported: "
            f"{sorted(KERAS_APPLICATION_MODELS)}")
    return KERAS_APPLICATION_MODELS[name]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)  # bounded: full state dicts are large
def init_state_dict(name: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Deterministic seeded init on the CPU, with flax's default
    initializers: every tensor of two or more dims (conv and dense
    kernels, embeddings, a probe token) LeCun-normal over its first
    dim's slice (truncated at two standard deviations), biases 0, a
    normalization's (BatchNorm, LayerNorm) scale 1 and offset 0,
    BatchNorm mean 0 / var 1. The numbers differ from the JAX package's
    seeded init (another generator); weights shared with it go through
    the fetcher cache."""
    with torch.device("meta"):   # shapes only: no default init
        module = getKerasApplicationModel(name).module_fn()
    scales = {f"{prefix}.weight" for prefix, m in module.named_modules()
              if isinstance(m, (BatchNorm, LayerNorm))}
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in module.state_dict().items():
        value = torch.empty(value.shape, dtype=torch.float32)
        if key in scales or key.endswith("running_var"):
            value.fill_(1.0)
        elif value.ndim > 1:   # kernels, embeddings
            fan_in = value[0].numel()
            # unit variance after truncation at ±2σ (flax's
            # truncated_normal variance scaling)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(value, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        else:
            value.zero_()
        state[key] = value
    return state


# The port's copy of the JAX package's committed artifacts: the trained
# TestNet (flax msgpack), its sha256, class index and provenance.
ARTIFACTS_DIR = os.path.join(os.path.dirname(__file__), "artifacts")

_warned_random: set = set()


def _from_msgpack(fetcher: ModelFetcher,
                  fileName: str) -> Dict[str, torch.Tensor]:
    """A flax blob, hash-checked, read by the port's msgpack reader and
    renamed by the weight bridge."""
    from sparkdl_tpu_torch.models import msgpack
    from sparkdl_tpu_torch.models.convert import flax_to_state_dict
    return flax_to_state_dict(msgpack.loads(fetcher.get_bytes(fileName)))


def _resolve_weights(name: str, fetcher: Optional[ModelFetcher]):
    """The provenance cascade, in priority order — one source of truth
    for :func:`weights_provenance` and :func:`load_state_dict`, as in the
    JAX package. Returns ``(source, loader)``; ``loader()`` gives the
    state dict (no loader for the seeded init)."""
    fetcher = fetcher or ModelFetcher()
    if fetcher.has(f"{name}.pt"):
        return "cache", lambda: fetcher.get(f"{name}.pt")
    fileName = f"{name}.msgpack"
    if fetcher.has(fileName):
        return "cache", lambda: _from_msgpack(fetcher, fileName)
    if os.path.exists(os.path.join(ARTIFACTS_DIR, fileName)):
        return "committed", lambda: _from_msgpack(
            ModelFetcher(cache_dir=ARTIFACTS_DIR), fileName)
    return "random", None


def weights_provenance(name: str,
                       fetcher: Optional[ModelFetcher] = None) -> str:
    """Where :func:`load_state_dict` gets this model's weights:
    ``"cache"`` (the fetcher cache's ``<name>.pt``, else its
    ``<name>.msgpack``, a JAX package cache entry), ``"committed"`` (the
    trained artifact shipped in the package), or ``"random"`` (seeded
    init)."""
    return _resolve_weights(name, fetcher)[0]


def load_state_dict(name: str, fetcher: Optional[ModelFetcher] = None,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """The model's weights by provenance priority, else the seeded init —
    with a LOUD warning, because a random featurizer emits structured
    noise and a random predictor's labels are meaningless."""
    _, loader = _resolve_weights(name, fetcher)
    if loader is not None:
        return loader()
    if name not in _warned_random:
        _warned_random.add(name)
        logging.getLogger(__name__).warning(
            "model %r is serving SEEDED-RANDOM weights: features are "
            "structured noise and predicted labels are meaningless. "
            "Nothing is downloaded — convert weights with "
            "models.convert and seed the cache via "
            "ModelFetcher.put(%r, state_dict), or copy the JAX package's "
            "cache entry %r (with its .sha256) into the cache.",
            name, f"{name}.pt", f"{name}.msgpack")
    return init_state_dict(name, seed)


# ---------------------------------------------------------------------------
# ModelFunction assembly
# ---------------------------------------------------------------------------

def build_module(module_fn: Callable[..., nn.Module],
                 state: Dict[str, torch.Tensor], device: torch.device,
                 **kwargs) -> nn.Module:
    """``module_fn(**kwargs)`` holding ``state``, without torch's default
    init: the module is built on the ``meta`` device (no storage, no
    init kernels) and the state dict is assigned into it
    (``load_state_dict(strict=True, assign=True)``), each tensor cast to
    the dtype the module declares. Every parameter and buffer must then
    be real: a module that left one on ``meta`` (a buffer outside the
    state dict) raises. On the CPU the tensors are copied first, so no
    two model functions share weights (a ``.to(device)`` to the card
    copies them anyway)."""
    with torch.device("meta"):
        net = module_fn(**kwargs)
    declared = net.state_dict(keep_vars=True)
    state = {k: (v.to(declared[k].dtype) if k in declared else v)
             for k, v in state.items()}
    if device.type == "cpu":
        state = {k: v.clone() for k, v in state.items()}
    net.load_state_dict(state, strict=True, assign=True)
    left = [name for name, t in (*net.named_parameters(),
                                 *net.named_buffers()) if t.is_meta]
    if left:
        raise RuntimeError(
            f"{type(net).__name__} kept tensors on the meta device after "
            f"its weights were assigned: {left}")
    return net


class ZooModel(nn.Module):
    """``{"image": uint8 [N, H, W, 3]}`` → ``{"features": [N, D]}`` or
    ``{"predictions": softmax [N, classes]}``, all on one device."""

    def __init__(self, spec: NamedImageModel, net: nn.Module,
                 featurize: bool):
        super().__init__()
        self.preprocess = spec.preprocess
        self.net = net
        self.featurize = featurize
        if spec.preprocess is _caffe_preprocess:
            self.register_buffer("caffe_mean", torch.tensor(
                _CAFFE_MEAN, dtype=torch.float32).view(1, 3, 1, 1),
                persistent=False)
        else:
            self.caffe_mean = None

    def forward(self, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        # NHWC → NCHW: a contiguous NHWC batch is already channels_last,
        # so this copies nothing; any other layout is made so, which
        # keeps cuDNN on one (channels_last) algorithm family
        x = inputs["image"].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = (self.preprocess(x) if self.caffe_mean is None
             else _caffe_preprocess(x, self.caffe_mean))
        out = self.net(x, features_only=self.featurize)
        if self.featurize:
            return {"features": out}
        return {"predictions": torch.softmax(out, dim=-1)}


def getModelFunction(name: str, featurize: bool = True,
                     device: DeviceLike = None,
                     fetcher: Optional[ModelFetcher] = None
                     ) -> ModelFunction:
    """Named model → ModelFunction on ``device`` (``None`` = the card):
    uint8 NHWC [N, H, W, 3] → ``features`` (penultimate layer) or, with
    ``featurize=False``, softmax ``predictions`` (a ``ValueError`` for a
    model without a classifier)."""
    spec = getKerasApplicationModel(name)
    if not featurize and spec.num_classes is None:
        raise ValueError(f"model {name!r} has no classifier: it gives "
                         f"features only (featurize=True, "
                         f"DeepImageFeaturizer)")
    device = resolve_device(device)   # before any work: no card raises
    net = build_module(spec.module_fn, load_state_dict(name, fetcher),
                       device)
    return ModelFunction(
        ZooModel(spec, net, featurize),
        input_signature={"image": ((spec.height, spec.width, 3),
                                   np.uint8)},
        output_names=["features" if featurize else "predictions"],
        device=device,
        name=f"{name}:{'featurize' if featurize else 'predict'}")


# ---------------------------------------------------------------------------
# prediction decoding (DeepImagePredictor's decodePredictions)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _imagenet_class_names() -> Dict[int, Tuple[str, str]]:
    """ImageNet class index shared by the 5 ImageNet-shaped zoo models:
    ``imagenet_class_index.json`` in the fetcher cache, else in the
    artifacts directory; else synthetic ``class_i`` names (no index is
    bundled: visibly synthetic labels beat silently wrong ones)."""
    for directory in (ModelFetcher().cache_dir, ARTIFACTS_DIR):
        path = os.path.join(directory, "imagenet_class_index.json")
        if os.path.exists(path):
            return load_class_index(path)
    return {i: (f"n{i:08d}", f"class_{i}") for i in range(1000)}


def load_class_index(path: str) -> Dict[int, Tuple[str, str]]:
    """Read a class-index JSON (keras ``imagenet_class_index`` layout:
    ``{"0": ["id", "name"], ...}``) into ``{idx: (id, name)}``."""
    with open(path) as f:
        raw = json.load(f)
    return {int(k): tuple(v) for k, v in raw.items()}


def model_class_index(name: str,
                      fetcher: Optional[ModelFetcher] = None
                      ) -> Optional[Dict[int, Tuple[str, str]]]:
    """A model's own class index, ``<name>.class_index.json`` in the
    fetcher cache, else beside the committed artifact; None when the
    model has none (decoding then uses the ImageNet index)."""
    fileName = f"{name}.class_index.json"
    fetcher = fetcher or ModelFetcher()
    for directory in (fetcher.cache_dir, ARTIFACTS_DIR):
        path = os.path.join(directory, fileName)
        if os.path.exists(path):
            return load_class_index(path)
    return None


def decode_predictions(logits: np.ndarray, top: int = 5,
                       class_index: Optional[Dict[int, Tuple[str, str]]]
                       = None):
    """logits/probs [N, C] → per row a list of (class_id, class_name,
    score), best first. ``class_index`` overrides the default ImageNet
    index (see :func:`model_class_index`)."""
    logits = np.asarray(logits)
    names = class_index if class_index is not None \
        else _imagenet_class_names()
    out = []
    for row in logits:
        idx = np.argsort(row)[::-1][:top]
        out.append([
            (*names.get(int(i), (f"n{int(i):08d}", f"class_{int(i)}")),
             float(row[i]))
            for i in idx
        ])
    return out
