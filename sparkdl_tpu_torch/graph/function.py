"""ModelFunction: the deployable unit of compute — counterpart of
``sparkdl_tpu/graph/function.py::ModelFunction`` and
``graph/utils.py::with_preprocessor``.

A ModelFunction is an ``nn.Module`` that maps a dict of named batch
tensors to a dict of named batch tensors, placed on one device, with
its named input signature (per-row shape and numpy dtype, batch dim
implicit) and output names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch._device import DeviceLike, resolve_device

# name -> (per-row shape tuple, numpy dtype)
Signature = Dict[str, Tuple[Tuple[int, ...], Any]]
Tensors = Dict[str, torch.Tensor]


class ModelFunction:
    """A named-IO module on one device (``None`` = the card)."""

    def __init__(self, module: nn.Module, input_signature: Signature,
                 output_names: Sequence[str], device: DeviceLike = None,
                 name: str = "model_fn"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.input_signature: Signature = dict(input_signature)
        self.output_names: List[str] = list(output_names)
        self.name = name

    @property
    def input_names(self) -> List[str]:
        return list(self.input_signature)

    def apply(self, inputs: Tensors) -> Tensors:
        """Run on tensors already on :attr:`device`."""
        with torch.inference_mode():
            return self.module(inputs)

    def __call__(self, inputs: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        """numpy dict in → numpy dict out (copies both ways)."""
        tensors = {k: torch.tensor(np.asarray(inputs[k]), device=self.device)
                   for k in self.input_names}
        out = self.apply(tensors)
        return {k: out[k].cpu().numpy() for k in self.output_names}


class _Preprocessed(nn.Module):
    def __init__(self, fn: Callable[[Tensors], Tensors], inner: nn.Module):
        super().__init__()
        self.fn = fn
        self.inner = inner

    def forward(self, inputs: Tensors) -> Tensors:
        return self.inner(self.fn(inputs))


def with_preprocessor(mf: ModelFunction, fn: Callable[[Tensors], Tensors],
                      input_signature: Optional[Signature] = None,
                      name: Optional[str] = None) -> ModelFunction:
    """Prepend ``fn`` (``{name: tensor} → {name: tensor}``, on the
    model's device) to the model; ``input_signature`` is what the new
    function takes."""
    return ModelFunction(
        _Preprocessed(fn, mf.module),
        input_signature or mf.input_signature, mf.output_names,
        device=mf.device, name=name or f"pre+{mf.name}")
