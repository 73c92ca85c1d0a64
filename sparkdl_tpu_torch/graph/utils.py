"""IO-name checks, wrappers and freeze helpers for ModelFunctions —
counterpart of ``sparkdl_tpu/graph/utils.py`` (the reference's ``tfx``:
``validated_graph`` / ``validated_input`` / ``validated_output``,
``get_shape``, ``strip_and_freeze_until``). A ModelFunction's named IO
plays the role of the reference's tensor names. Every wrapper keeps the
function's device, and carries a fixed batch and a recorded output
signature through, as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from torch import nn

from sparkdl_tpu_torch.graph.function import (
    ModelFunction,
    Signature,
    Tensors,
)


def validated_model(mf) -> ModelFunction:
    """Assert the object is a usable ModelFunction (reference
    ``validated_graph``)."""
    if not isinstance(mf, ModelFunction):
        raise TypeError(
            f"expected a ModelFunction, got {type(mf).__name__}")
    if not mf.input_signature:
        raise ValueError(f"model {mf.name!r} declares no inputs")
    return mf


def validated_input(mf: ModelFunction, name: str) -> str:
    """Assert ``name`` is one of the model's inputs."""
    validated_model(mf)
    if name not in mf.input_signature:
        raise ValueError(
            f"input {name!r} not in model {mf.name!r}; inputs: "
            f"{mf.input_names}")
    return name


def validated_output(mf: ModelFunction, name: str) -> str:
    """Assert ``name`` is one of the model's outputs."""
    validated_model(mf)
    if name not in mf.output_names:
        raise ValueError(
            f"output {name!r} not in model {mf.name!r}; outputs: "
            f"{mf.output_names}")
    return name


def get_input_shape(mf: ModelFunction, name: str) -> Tuple[int, ...]:
    """Per-row shape of a named input (batch dim implicit)."""
    shape, _ = mf.input_signature[validated_input(mf, name)]
    return tuple(shape)


def get_output_shape(mf: ModelFunction, name: str) -> Tuple[int, ...]:
    """Per-row shape of a named output, from :meth:`output_signature`."""
    validated_output(mf, name)
    shape, _ = mf.output_signature()[name]
    return tuple(shape)


def input_names(mf: ModelFunction) -> List[str]:
    return validated_model(mf).input_names


def output_names(mf: ModelFunction) -> List[str]:
    return validated_model(mf).output_names


def _wrapped(mf: ModelFunction, module: nn.Module,
             input_signature: Optional[Signature],
             out_names: Optional[List[str]], name: str,
             output_signature: Optional[Signature]) -> ModelFunction:
    out = ModelFunction(module, input_signature or mf.input_signature,
                        out_names, device=mf.device, name=name)
    out._fixed_batch = mf._fixed_batch
    out._output_signature = output_signature
    return out


class _Select(nn.Module):
    def __init__(self, inner: nn.Module, names: List[str]):
        super().__init__()
        self.inner = inner
        self.names = list(names)

    def forward(self, inputs: Tensors) -> Tensors:
        out = self.inner(inputs)
        return {k: out[k] for k in self.names}


def select_outputs(mf: ModelFunction, names: List[str],
                   name: Optional[str] = None) -> ModelFunction:
    """The function cut to a subset of its outputs (the reference's
    graph pruning). The whole forward still runs: torch does not delete
    the unused computation the way XLA's dead-code elimination does."""
    validated_model(mf)
    names = [validated_output(mf, n) for n in names]
    if not names:
        raise ValueError("select_outputs needs at least one output")
    recorded = mf._output_signature
    return _wrapped(
        mf, _Select(mf.module, names), None, names,
        name or f"{mf.name}[{','.join(names)}]",
        None if recorded is None
        else {k: v for k, v in recorded.items() if k in names})


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
    model's device) to the model, in the same forward (the reference
    stitched a preprocessor graph in front with ``GraphFunction.fromList``);
    ``input_signature`` is what the new function takes."""
    validated_model(mf)
    recorded = mf._output_signature
    return _wrapped(mf, _Preprocessed(fn, mf.module), input_signature,
                    mf.output_names, name or f"pre+{mf.name}",
                    None if recorded is None else dict(recorded))


class _Postprocessed(nn.Module):
    def __init__(self, inner: nn.Module, fn: Callable[[Tensors], Tensors]):
        super().__init__()
        self.inner = inner
        self.fn = fn

    def forward(self, inputs: Tensors) -> Tensors:
        return self.fn(self.inner(inputs))


def with_postprocessor(mf: ModelFunction, fn: Callable[[Tensors], Tensors],
                       output_names_out: Optional[List[str]] = None,
                       name: Optional[str] = None) -> ModelFunction:
    """Append ``fn`` (``{name: tensor} → {name: tensor}``) after the model
    in the same forward (the reference's output flattener was this,
    composed at the graph level). Without ``output_names_out`` the names
    come from a trace under ``FakeTensorMode`` (at a fixed batch's
    size), which launches nothing."""
    validated_model(mf)
    out = _wrapped(mf, _Postprocessed(mf.module, fn), None,
                   output_names_out, name or f"{mf.name}+post", None)
    out.output_names  # traced now, as the JAX package infers them here
    return out


def strip_and_freeze(mf: ModelFunction,
                     batch_size: Optional[int] = None) -> bytes:
    """Weights baked in, the computation frozen by ``torch.export`` (the
    reference's ``strip_and_freeze_until``): the deploy form."""
    return validated_model(mf).export(batch_size=batch_size)


def load_frozen(blob: bytes, name: str = "frozen",
                device=None) -> ModelFunction:
    """Inverse of :func:`strip_and_freeze`, onto ``device`` (``None`` =
    the card)."""
    return ModelFunction.deserialize(blob, name=name, device=device)
