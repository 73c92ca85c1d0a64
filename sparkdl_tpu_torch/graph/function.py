"""ModelFunction: the deployable unit of compute — counterpart of
``sparkdl_tpu/graph/function.py::ModelFunction``.

A ModelFunction is an ``nn.Module`` that maps a dict of named batch
tensors to a dict of named batch tensors, placed on one device, with its
named input signature (per-row shape and numpy dtype, batch dim
implicit) and output names. Composition (:meth:`ModelFunction.fromList`,
:meth:`~ModelFunction.rename_io`, the wrappers of ``graph/utils.py``)
nests modules: torch runs the stages one after another in one forward.

The JAX package freezes a function by ``jax.export`` into StableHLO; here
:meth:`ModelFunction.export` freezes it by ``torch.export`` into the
bytes ``torch.export.save`` writes, weights baked in, and
:meth:`ModelFunction.deserialize` loads them back. The port's two device
ops are registered ops (``torch.ops.sparkdl_tpu_torch.*``), so an
exported program holds them by name and runs them, kernel and all, once
``sparkdl_tpu_torch.ops`` is imported in the loading process.
:meth:`ModelFunction.output_signature` is the counterpart of
``jax.eval_shape``: one forward under ``FakeTensorMode``, which launches
nothing and allocates no device memory.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch._device import DeviceLike, resolve_device

# name -> (per-row shape tuple, numpy dtype)
Signature = Dict[str, Tuple[Tuple[int, ...], Any]]
Tensors = Dict[str, torch.Tensor]

# an export with a symbolic batch takes 1 to MAX_EXPORT_BATCH rows; it is
# traced at 2 rows, because torch.export specialises sizes 0 and 1
MAX_EXPORT_BATCH = 4096
_TRACE_BATCH = 2


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or a torch dtype) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def numpy_dtype(dtype: torch.dtype):
    """torch dtype → numpy dtype; bfloat16, which numpy lacks, stays a
    torch dtype."""
    if dtype == torch.bfloat16:
        return dtype
    return torch.empty(0, dtype=dtype).numpy().dtype


def _as_dict(x, names: Sequence[str]) -> Dict[str, Any]:
    if isinstance(x, dict):
        return x
    if len(names) != 1:
        raise ValueError(
            f"got a single array for multi-input function {list(names)}")
    return {names[0]: x}


class ParamBuffers(nn.Module):
    """A flat dict of tensors held as buffers, so they move with the
    module and an export bakes them in."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self.keys = list(params)
        for i, key in enumerate(self.keys):
            self.register_buffer(f"p{i}", torch.as_tensor(
                np.asarray(params[key]) if not isinstance(
                    params[key], torch.Tensor) else params[key]))

    def as_dict(self) -> Tensors:
        return {key: getattr(self, f"p{i}")
                for i, key in enumerate(self.keys)}


class _Single(nn.Module):
    """``fn(params, x)`` or ``fn(x)`` on one named input → one named
    output (or the dict ``fn`` returns)."""

    def __init__(self, fn, params, input_name: str, output_name: str):
        super().__init__()
        self.fn = fn
        self.params = None if params is None else ParamBuffers(params)
        self.input_name = input_name
        self.output_name = output_name

    def forward(self, inputs: Tensors) -> Tensors:
        x = inputs[self.input_name]
        y = (self.fn(x) if self.params is None
             else self.fn(self.params.as_dict(), x))
        return y if isinstance(y, dict) else {self.output_name: y}


class _Chain(nn.Module):
    """Stages run in order, each stage's one output fed to the next
    stage's one input (the JAX package's ``fromList`` checks and
    messages, at call time as there)."""

    def __init__(self, stages: Sequence[nn.Module], names: Sequence[str],
                 input_names: Sequence[List[str]]):
        super().__init__()
        self.stages = nn.ModuleList(stages)
        self.names = list(names)
        self.input_names = [list(n) for n in input_names]

    def forward(self, inputs: Tensors) -> Tensors:
        cur, out = inputs, {}
        last = len(self.stages) - 1
        for i, stage in enumerate(self.stages):
            out = stage(cur)
            if i < last:
                if len(out) != 1:
                    raise ValueError(
                        f"stage {self.names[i]} has {len(out)} outputs; "
                        "fromList chains single-output stages")
                nxt_in = self.input_names[i + 1]
                if len(nxt_in) != 1:
                    raise ValueError(
                        f"stage {self.names[i + 1]} has {len(nxt_in)} "
                        "inputs; fromList chains single-input stages")
                cur = {nxt_in[0]: next(iter(out.values()))}
        return out


class _Renamed(nn.Module):
    def __init__(self, inner: nn.Module, inv_in: Dict[str, str],
                 output_map: Dict[str, str]):
        super().__init__()
        self.inner = inner
        self.inv_in = dict(inv_in)
        self.output_map = dict(output_map)

    def forward(self, inputs: Tensors) -> Tensors:
        out = self.inner({self.inv_in.get(n, n): v
                          for n, v in inputs.items()})
        return {self.output_map.get(n, n): v for n, v in out.items()}


class _Exported(nn.Module):
    """A loaded ``torch.export`` program. It takes the batches the program
    was exported for and raises ``ValueError`` for any other, before the
    program's own guards would fail with an assertion."""

    def __init__(self, program: nn.Module, signature: Signature,
                 batch_range: Tuple[int, int]):
        super().__init__()
        self.program = program
        self.signature = dict(signature)
        self.batch_range = tuple(batch_range)

    def train(self, mode: bool = True):
        # an exported program has no train mode to switch (torch refuses
        # to); it was exported in eval mode
        self.training = mode
        return self

    def forward(self, inputs: Tensors) -> Tensors:
        lo, hi = self.batch_range
        for name, (shape, dtype) in self.signature.items():
            x = inputs[name]
            n = x.shape[0]
            if not lo <= n <= hi:
                what = (f"a fixed batch of {lo}" if lo == hi
                        else f"batches of {lo} to {hi} rows")
                raise ValueError(
                    f"input {name!r} has {n} rows; this exported program "
                    f"takes {what}")
            if tuple(x.shape[1:]) != tuple(shape) or \
                    x.dtype != torch_dtype(dtype):
                raise ValueError(
                    f"input {name!r} is {x.dtype} {tuple(x.shape[1:])} a "
                    f"row; the program takes {torch_dtype(dtype)} "
                    f"{tuple(shape)}")
        return self.program(inputs)


def _program_signature(ep) -> Tuple[Signature, Signature,
                                    Tuple[int, int]]:
    """(input signature, output signature, batch range) of an exported
    program, read from its graph: the user inputs' and outputs' shapes
    and dtypes, and the batch dim's range (one value when fixed)."""
    nodes = {n.name: n for n in ep.graph.nodes}
    sig = ep.graph_signature
    in_vals = [nodes[name].meta["val"] for name in sig.user_inputs]
    (args, kwargs) = pytree.tree_unflatten(in_vals, ep.call_spec.in_spec)
    if len(args) != 1 or kwargs or not isinstance(args[0], dict):
        raise ValueError("the exported program does not take one dict of "
                         "named tensors, as a ModelFunction does")
    (output_node,) = [n for n in ep.graph.nodes if n.op == "output"]
    out_vals = [a.meta["val"] for a in output_node.args[0]]
    outs = pytree.tree_unflatten(out_vals, ep.call_spec.out_spec)
    if not isinstance(outs, dict):
        raise ValueError("the exported program does not return a dict of "
                         "named tensors, as a ModelFunction does")

    def per_row(vals) -> Signature:
        return {k: (tuple(int(d) for d in v.shape[1:]),
                    numpy_dtype(v.dtype)) for k, v in vals.items()}

    batch = next(iter(args[0].values())).shape[0]
    if isinstance(batch, int):
        batch_range = (batch, batch)
    else:
        ranges = ep.range_constraints[batch.node.expr]
        batch_range = (int(ranges.lower), int(ranges.upper))
    return per_row(args[0]), per_row(outs), batch_range


class ModelFunction:
    """A named-IO module on one device (``None`` = the card)."""

    def __init__(self, module: nn.Module, input_signature: Signature,
                 output_names: Optional[Sequence[str]] = None,
                 device: DeviceLike = None, name: str = "model_fn"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.input_signature: Signature = dict(input_signature)
        self._output_names = list(output_names) if output_names else None
        self.name = name
        # the output signature an exported program records (set by
        # deserialize, carried by the wrappers): output_signature()
        # returns it instead of tracing
        self._output_signature: Optional[Signature] = None
        # the only batch a fixed-batch exported program takes (set by
        # deserialize, carried by the wrappers): traces use it
        self._fixed_batch: Optional[int] = None

    # -- construction -------------------------------------------------------

    @staticmethod
    def fromSingle(fn, params: Optional[Dict[str, Any]] = None,
                   input_shape: Tuple[int, ...] = (),
                   input_dtype=np.float32,
                   input_name: str = "input",
                   output_name: str = "output",
                   name: str = "model_fn",
                   device: DeviceLike = None) -> "ModelFunction":
        """Wrap a single-tensor function: ``fn(params, x) -> y`` with
        ``params`` a flat dict of tensors (or arrays), or ``fn(x) -> y``
        (an ``nn.Module`` among them) when ``params`` is None."""
        return ModelFunction(
            _Single(fn, params, input_name, output_name),
            {input_name: (tuple(input_shape), input_dtype)},
            [output_name], device=device, name=name)

    @staticmethod
    def fromList(functions: Sequence["ModelFunction"],
                 name: str = "composed") -> "ModelFunction":
        """Chain single-output → single-input functions into one, on the
        first one's device (reference ``GraphFunction.fromList``). A link
        with several outputs or inputs raises ``ValueError`` when the
        chain runs, as in the JAX package."""
        functions = list(functions)
        if not functions:
            raise ValueError("fromList needs at least one function")
        head = functions[0]
        for f in functions[1:]:
            if f.device != head.device:
                raise ValueError(
                    f"fromList needs its functions on one device: "
                    f"{head.name} is on {head.device}, {f.name} on "
                    f"{f.device}")
        mf = ModelFunction(
            _Chain([f.module for f in functions],
                   [f.name for f in functions],
                   [f.input_names for f in functions]),
            dict(head.input_signature), functions[-1]._output_names,
            device=head.device, name=name)
        mf._fixed_batch = next((f._fixed_batch for f in functions
                                if f._fixed_batch is not None), None)
        return mf

    # -- introspection ------------------------------------------------------

    @property
    def input_names(self) -> List[str]:
        return list(self.input_signature)

    @property
    def output_names(self) -> List[str]:
        if self._output_names is None:
            self._output_names = list(self.output_signature())
        return list(self._output_names)

    def output_signature(self, batch_size: int = 1) -> Signature:
        """Named per-row output shapes and dtypes, from one forward under
        ``FakeTensorMode`` (the module's real weights let in): no kernel
        launches and no device memory is allocated. A deserialized
        program returns the signature its export recorded; a wrapper
        around a fixed-batch program traces at that batch."""
        if self._output_signature is not None:
            return dict(self._output_signature)
        from torch._subclasses.fake_tensor import FakeTensorMode
        b = self._fixed_batch or batch_size
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            inputs = {n: torch.empty((b,) + tuple(shape),
                                     dtype=torch_dtype(dtype),
                                     device=self.device)
                      for n, (shape, dtype) in self.input_signature.items()}
            out = {k: (tuple(int(d) for d in v.shape[1:]), v.dtype)
                   for k, v in self.module(inputs).items()}
        return {k: (shape, numpy_dtype(dtype))
                for k, (shape, dtype) in out.items()}

    def rename_io(self, input_map: Optional[Dict[str, str]] = None,
                  output_map: Optional[Dict[str, str]] = None
                  ) -> "ModelFunction":
        """New ModelFunction with renamed inputs and outputs (the
        reference's ``graph/input.py::translateInputMapping``)."""
        input_map = input_map or {}
        output_map = output_map or {}
        inv_in = {new: old for old, new in input_map.items()}
        sig = {input_map.get(n, n): v
               for n, v in self.input_signature.items()}
        out_names = ([output_map.get(n, n) for n in self._output_names]
                     if self._output_names else None)
        out = ModelFunction(_Renamed(self.module, inv_in, output_map), sig,
                            out_names, device=self.device,
                            name=f"{self.name}.renamed")
        out._fixed_batch = self._fixed_batch
        if self._output_signature is not None:
            out._output_signature = {
                output_map.get(n, n): v
                for n, v in self._output_signature.items()}
        return out

    # -- execution ----------------------------------------------------------

    def apply(self, inputs: Tensors) -> Tensors:
        """Run on tensors already on :attr:`device`."""
        with torch.inference_mode():
            return self.module(inputs)

    def __call__(self, inputs):
        """numpy in → numpy out (copies both ways): a dict of named
        arrays gives a dict; a bare array (single-input functions) gives
        a bare array when the function has one output."""
        single = not isinstance(inputs, dict)
        d = _as_dict(inputs, self.input_names)
        tensors = {k: torch.tensor(np.asarray(d[k]), device=self.device)
                   for k in self.input_names}
        out = self.apply(tensors)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if single and len(out) == 1:
            return next(iter(out.values()))
        return out

    # -- serialization (the "freeze" step) ----------------------------------

    def export(self, batch_size: Optional[int] = None) -> bytes:
        """The function frozen by ``torch.export`` with its weights baked
        in, as the bytes ``torch.export.save`` writes. ``batch_size=None``
        exports a symbolic batch of 1 to ``MAX_EXPORT_BATCH`` rows;
        an int, that batch alone."""
        if self._fixed_batch is not None and batch_size != self._fixed_batch:
            raise ValueError(
                f"{self.name} wraps a program exported for a fixed batch of "
                f"{self._fixed_batch}; export it with batch_size="
                f"{self._fixed_batch}")
        b = _TRACE_BATCH if batch_size is None else int(batch_size)
        args = ({n: torch.zeros((b,) + tuple(shape), dtype=torch_dtype(dtype),
                                device=self.device)
                 for n, (shape, dtype) in self.input_signature.items()},)
        dynamic = None
        if batch_size is None:
            batch = torch.export.Dim("batch", min=1, max=MAX_EXPORT_BATCH)
            dynamic = ({n: {0: batch} for n in self.input_names},)
        # under no_grad, not inference_mode: export refuses inference
        # tensors
        with torch.no_grad():
            program = torch.export.export(self.module, args,
                                          dynamic_shapes=dynamic)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()

    @staticmethod
    def deserialize(blob: bytes, name: str = "exported",
                    device: DeviceLike = None) -> "ModelFunction":
        """Load bytes written by :meth:`export` onto ``device`` (``None`` =
        the card). The signatures and the fixed batch are read from the
        program, not from a probe."""
        # registers K1 and K2, which the program calls by name
        import sparkdl_tpu_torch.ops  # noqa: F401
        from torch.export.passes import move_to_device_pass
        device = resolve_device(device)
        try:
            program = torch.export.load(io.BytesIO(blob))
        except Exception as e:
            raise ValueError(
                f"not a torch.export program ({len(blob)} bytes; produce "
                "one with ModelFunction.export): "
                f"{type(e).__name__}: {str(e)[:120]}") from e
        program = move_to_device_pass(program, device)
        in_sig, out_sig, batch_range = _program_signature(program)
        mf = ModelFunction(_Exported(program.module(), in_sig, batch_range),
                           in_sig, list(out_sig), device=device, name=name)
        mf._output_signature = out_sig
        if batch_range[0] == batch_range[1]:
            mf._fixed_batch = batch_range[0]
        return mf

    # -- shipping -----------------------------------------------------------

    def __getstate__(self):
        """Pickled as its export (the JAX package ships its function by
        cloudpickle; the port has no cloudpickle): another process loads
        the program onto the same kind of device."""
        return {"blob": self.export(self._fixed_batch), "name": self.name,
                "device": self.device.type}

    def __setstate__(self, state):
        self.__dict__.update(ModelFunction.deserialize(
            state["blob"], state["name"], state["device"]).__dict__)

    def __repr__(self) -> str:
        outs = self._output_names or "?"
        return (f"ModelFunction({self.name}, device={self.device}, "
                f"inputs={self.input_names}, outputs={outs})")


# the wrapper's old home: callers import it from here too
from sparkdl_tpu_torch.graph.utils import with_preprocessor  # noqa: E402,F401
