"""Named-model zoo registry — counterpart of
``sparkdl_tpu/models/zoo.py`` for the models this port carries
(InceptionV3 and the tiny TestNet).

Preprocessing is part of the model function: uint8 NHWC comes in, is
viewed as NCHW (channels_last in memory, no copy), scaled on the device
and fed to the network.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch._device import DeviceLike, resolve_device
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.fetcher import ModelFetcher
from sparkdl_tpu_torch.models.inception import InceptionV3
from sparkdl_tpu_torch.models.testnet import TestNet


def _inception_preprocess(x: torch.Tensor) -> torch.Tensor:
    """uint8 → [-1, 1] float32 (x/127.5 - 1, InceptionV3/Xception)."""
    return x.to(torch.float32) * (1.0 / 127.5) - 1.0


def _testnet_preprocess(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / 255.0)


@dataclasses.dataclass(frozen=True)
class NamedImageModel:
    """Zoo entry: constructor, input size, preprocess, output widths."""

    name: str
    module_fn: Callable[[], nn.Module]
    input_size: Tuple[int, int]           # (height, width)
    preprocess: Callable[[torch.Tensor], torch.Tensor]
    feature_dim: int
    num_classes: int = 1000

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
        NamedImageModel("TestNet", TestNet, (32, 32),
                        _testnet_preprocess, 16, num_classes=10),
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
    initializers: conv and dense kernels LeCun-normal (truncated at two
    standard deviations), biases 0, BatchNorm scale 1 / bias 0 / mean 0 /
    var 1. The numbers differ from the JAX package's seeded init (another
    generator); weights shared with it go through the fetcher cache."""
    module = getKerasApplicationModel(name).module_fn()
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in module.state_dict().items():
        value = torch.empty_like(value, dtype=torch.float32)
        if key.endswith("conv.weight") or key.endswith("fc.weight"):
            fan_in = value[0].numel()
            # unit variance after truncation at ±2σ (flax's
            # truncated_normal variance scaling)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(value, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        elif key.endswith("running_var") or key.endswith("bn.weight"):
            value.fill_(1.0)
        else:
            value.zero_()
        state[key] = value
    return state


_warned_random: set = set()


def weights_provenance(name: str,
                       fetcher: Optional[ModelFetcher] = None) -> str:
    """``"cache"`` when the fetcher cache holds ``<name>.pt``, else
    ``"random"`` (seeded init)."""
    fetcher = fetcher or ModelFetcher()
    return "cache" if fetcher.has(f"{name}.pt") else "random"


def load_state_dict(name: str, fetcher: Optional[ModelFetcher] = None,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """The cached weights when present, else the seeded init — with a
    LOUD warning, because a random featurizer emits structured noise."""
    fetcher = fetcher or ModelFetcher()
    if fetcher.has(f"{name}.pt"):
        return fetcher.get(f"{name}.pt")
    if name not in _warned_random:
        _warned_random.add(name)
        logging.getLogger(__name__).warning(
            "model %r is serving SEEDED-RANDOM weights: features are "
            "structured noise and predicted labels are meaningless. "
            "Nothing is downloaded — convert weights with "
            "models.convert and seed the cache via "
            "ModelFetcher.put(%r, state_dict).", name, f"{name}.pt")
    return init_state_dict(name, seed)


# ---------------------------------------------------------------------------
# ModelFunction assembly
# ---------------------------------------------------------------------------

class ZooModel(nn.Module):
    """``{"image": uint8 [N, H, W, 3]}`` → ``{"features": [N, D]}`` or
    ``{"predictions": softmax [N, classes]}``, all on one device."""

    def __init__(self, spec: NamedImageModel, net: nn.Module,
                 featurize: bool):
        super().__init__()
        self.preprocess = spec.preprocess
        self.net = net
        self.featurize = featurize

    def forward(self, inputs: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        # NHWC → NCHW: a contiguous NHWC batch is already channels_last,
        # so this copies nothing; any other layout is made so, which
        # keeps cuDNN on one (channels_last) algorithm family
        x = inputs["image"].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.preprocess(x)
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
    ``featurize=False``, softmax ``predictions``."""
    spec = getKerasApplicationModel(name)
    device = resolve_device(device)   # before any work: no card raises
    net = spec.module_fn()
    net.load_state_dict(load_state_dict(name, fetcher), strict=True)
    return ModelFunction(
        ZooModel(spec, net, featurize),
        input_signature={"image": ((spec.height, spec.width, 3),
                                   np.uint8)},
        output_names=["features" if featurize else "predictions"],
        device=device,
        name=f"{name}:{'featurize' if featurize else 'predict'}")
