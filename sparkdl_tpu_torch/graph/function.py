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
nothing and allocates no device memory. :meth:`ModelFunction.replicas`
is the counterpart of ``replicated_params`` / ``sharded_jitted``: the
module copied once to each device of a mesh and cached on the function,
so every runner over it shares one copy per device.

The fleet registry's hot-swap (``fleet/registry.py``) goes through two
seams, as in the JAX package (``stage_params`` and ``commit_params``,
JAX ``graph/function.py:328``, ``:359``): :meth:`ModelFunction.stage_params`
copies new weights onto the function's device on a side stream, off the
dispatch path; :meth:`ModelFunction.commit_params` rebinds the module's
parameters and buffers to them, with no transfer, under the serve
session's swap gate. The weights are the module's ``state_dict`` by name
(:meth:`ModelFunction.state_dict`). No layer caches a tensor derived from
a weight (``models/layers.py::conv2d`` casts at each forward), so a
rebind leaves nothing stale. :meth:`ModelFunction.install_program`, the
counterpart of ``install_aot`` (JAX ``:370``), makes a
:meth:`~ModelFunction.deserialize`-d program the function's module for
the fleet's warm-start store.

Compile forensics (``obs/compile_log.py``), as the JAX function routes
its jits: :meth:`ModelFunction.apply` runs each device's module through
the log's wrapper (``<name>.apply``), whose first call at a new input
signature is an event (FLOPs, and on the card the first call's peak
memory); a module's first move onto a device is a ``device_put`` event
(``<name>.device_params``); :meth:`~ModelFunction.export` and
:meth:`~ModelFunction.deserialize` record theirs. Disarmed, each is one
armed check.

A ModelFunction may instead wrap a host callable (``backend="host"``),
as in the JAX package: ``apply_fn(params, inputs_dict) -> outputs_dict``
over numpy arrays, run on the host as it is. The TF-era sources
(``graph/ingest.py``) build one around a TF graph, which runs on the CPU
through the TF runtime, where the reference ran it. A host function has
no device and no module: it does not chain, export, place, replicate,
swap weights or pickle, and each of those raises as the JAX package's
does. It is chosen by its constructor, never as a way out of a card or
kernel failure.
"""

from __future__ import annotations

import collections
import copy
import hashlib
import io
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch._device import DeviceLike, resolve_device
from sparkdl_tpu_torch.obs.compile_log import compile_log

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
    # sparkdl-lint: allow[H1] -- a zero-element CPU tensor made on this line: .numpy() reads its dtype, no device is involved
    return torch.empty(0, dtype=dtype).numpy().dtype


def _canonical(device) -> torch.device:
    """``cuda`` with its index (the current device when it has none)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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


class _RenamedHost:
    """A host function's ``apply_fn`` under renamed inputs and outputs."""

    def __init__(self, apply_fn, inv_in: Dict[str, str],
                 output_map: Dict[str, str]):
        self.apply_fn = apply_fn
        self.inv_in = dict(inv_in)
        self.output_map = dict(output_map)

    def __call__(self, params, inputs):
        out = self.apply_fn(params, {self.inv_in.get(n, n): v
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


BACKENDS = ("torch", "host")


def _placed(name: str, module: nn.Module, device: torch.device,
            placement: str) -> nn.Module:
    """``module`` moved onto ``device``; with the compile log armed, a
    move of any weight is recorded as the JAX ``device_params`` event
    (its wall, and the count and bytes of the tensors that moved)."""
    log = compile_log()
    if not log.armed:
        return module.to(device)
    where = _canonical(device)
    moving = [t for t in module.state_dict().values()
              if t.device != where]
    if not moving:
        return module.to(device)
    t0 = time.perf_counter()
    module = module.to(device)
    log.record_transfer(
        name=f"{name}.device_params", kind="device_put",
        wall_s=time.perf_counter() - t0,
        detail={"placement": placement, "leaves": len(moving),
                "bytes": sum(int(t.nbytes) for t in moving)})
    return module


def _load_program(blob: bytes, device: torch.device):
    """``torch.export.load`` of ``blob``, moved onto ``device``."""
    # registers K1, K2 and K3, which the program calls by name
    import sparkdl_tpu_torch.ops  # noqa: F401
    from torch.export.passes import move_to_device_pass
    try:
        program = torch.export.load(io.BytesIO(blob))
    except Exception as e:
        raise ValueError(
            f"not a torch.export program ({len(blob)} bytes; produce "
            "one with ModelFunction.export): "
            f"{type(e).__name__}: {str(e)[:120]}") from e
    return move_to_device_pass(program, device)


#: how many unpickled programs a process keeps loaded (least recently
#: used dropped first)
PROGRAM_CACHE_SIZE = 2
_programs: "collections.OrderedDict" = collections.OrderedDict()
_programs_lock = threading.Lock()


def _shipped_program(blob: bytes, device: torch.device):
    """The loaded program of a pickled function. A Spark executor's
    worker unpickles the same stage in every task of a job, and loading
    an InceptionV3 program takes seconds (its graph's deserialization),
    so the process keeps the last :data:`PROGRAM_CACHE_SIZE` programs by
    the SHA-256 of their bytes and device. Each unpickled function still
    gets a module of its own (``program.module()``), whose weights it
    rebinds, never overwrites, on a swap (``commit_params``)."""
    key = (hashlib.sha256(blob).hexdigest(), str(device))
    with _programs_lock:
        program = _programs.get(key)
        if program is not None:
            _programs.move_to_end(key)
            return program
    program = _load_program(blob, device)
    with _programs_lock:
        _programs[key] = program
        while len(_programs) > PROGRAM_CACHE_SIZE:
            _programs.popitem(last=False)
    return program


class ModelFunction:
    """A named-IO module on one device (``None`` = the card), or with
    ``backend="host"`` a host callable ``apply_fn(params, inputs) ->
    outputs`` over numpy (``module`` is then that callable, ``params``
    its first argument, and ``device`` must be None)."""

    def __init__(self, module, input_signature: Signature,
                 output_names: Optional[Sequence[str]] = None,
                 device: DeviceLike = None, name: str = "model_fn",
                 backend: str = "torch", params: Any = None):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {backend!r}")
        self.backend = backend
        if backend == "host":
            if not callable(module) or isinstance(module, nn.Module):
                raise TypeError(
                    "a host-backend ModelFunction wraps a callable "
                    "apply_fn(params, inputs) -> outputs over numpy, not "
                    f"{type(module).__name__}")
            if device is not None:
                raise ValueError(
                    "a host-backend ModelFunction runs on the host as it "
                    f"is; it takes no device (got {device!r})")
            self.device = None
            self.module = None
            self.apply_fn = module
            self.params = params
        else:
            if params is not None:
                raise ValueError(
                    "params= is for host-backend functions; a torch "
                    "function's weights live in its module")
            self.device = resolve_device(device)
            self.module = _placed(name, module, self.device,
                                  "default").eval()
            self.apply_fn = None
            self.params = None
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
        # the module's copy on each other device (replicas())
        self._replicas: Dict[torch.device, nn.Module] = {}
        self._replicas_lock = threading.Lock()
        # the compile log's wrapper of the module on each device it ran
        # on (None: its own), made at the first apply there
        self._calls: Dict[Optional[torch.device], Any] = {}
        # a fromSingle function's params by the caller's keys → their
        # state_dict names ({"w": "params.p0"}), for stage_params
        self._param_aliases: Optional[Dict[str, str]] = None
        # the bytes this function last pickled as, with the state they
        # were exported from (__getstate__)
        self._shipped: Optional[Tuple[tuple, bytes]] = None

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
        mf = ModelFunction(
            _Single(fn, params, input_name, output_name),
            {input_name: (tuple(input_shape), input_dtype)},
            [output_name], device=device, name=name)
        if params is not None:
            mf._param_aliases = {key: f"params.p{i}"
                                 for i, key in enumerate(params)}
        return mf

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
        for f in functions:
            if f.backend != "torch":
                raise ValueError(
                    f"fromList requires torch-backend functions, got "
                    f"'{f.backend}' for {f.name}")
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
        if self.backend != "torch":
            raise ValueError("output_signature requires a torch backend")
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
        if self.backend == "host":
            out = ModelFunction(
                _RenamedHost(self.apply_fn, inv_in, output_map), sig,
                out_names, name=f"{self.name}.renamed", backend="host",
                params=self.params)
        else:
            out = ModelFunction(_Renamed(self.module, inv_in, output_map),
                                sig, out_names, device=self.device,
                                name=f"{self.name}.renamed")
        out._fixed_batch = self._fixed_batch
        if self._output_signature is not None:
            out._output_signature = {
                output_map.get(n, n): v
                for n, v in self._output_signature.items()}
        return out

    # -- execution ----------------------------------------------------------

    def apply(self, inputs: Tensors, device: Optional[torch.device] = None
              ) -> Tensors:
        """Run on tensors already on :attr:`device`, or on ``device``
        with the module's replica there (:meth:`replicas`)."""
        self._require_torch("run tensors of")
        if device is not None:
            device = _canonical(device)
            if device == _canonical(self.device):
                device = None
        module = self.module if device is None else self.module_on(device)
        call = self._calls.get(device)
        if call is None or call.__wrapped__ is not module:
            call = self._logged_call(module, device)
        with torch.inference_mode():
            return call(inputs)

    def last_flops(self, device=None) -> Optional[float]:
        """The FLOPs the compile log counted for the signature last run
        on ``device`` (None: the function's own), or None."""
        if device is not None:
            device = _canonical(device)
            if device == _canonical(self.device):
                device = None
        return getattr(self._calls.get(device), "last_flops", None)

    def _logged_call(self, module: nn.Module, device):
        """The compile log's wrapper of ``module`` (on ``device``, None
        for the function's own), made anew when the module changed."""
        with self._replicas_lock:
            call = self._calls.get(device)
            if call is None or call.__wrapped__ is not module:
                where = "" if device is None else f"[{device}]"
                call = compile_log().instrument(
                    module, name=f"{self.name}.apply{where}",
                    kind="first_call", arg_names=("inputs",))
                self._calls[device] = call
            return call

    def module_on(self, device) -> nn.Module:
        """The module on ``device``: its own on :attr:`device`, else its
        replica there, copied at the first call and kept."""
        self._require_torch("place")
        device = _canonical(device)
        if device == _canonical(self.device):
            return self.module
        with self._replicas_lock:
            replica = self._replicas.get(device)
            if replica is None:
                # sparkdl-lint: allow[H8] -- the hold is the point: one replica per device, built once, and a second thread must wait for it rather than copy the module twice; the compile log's flight dump on this path fires only when armed, on a first placement
                replica = _placed(self.name, copy.deepcopy(self.module),
                                  device, str(device)).eval()
                self._replicas[device] = replica
            return replica

    def replicas(self, mesh) -> Dict[torch.device, nn.Module]:
        """The module on each distinct device of a local ``mesh`` (one
        copy per device, shared by every mesh and runner over this
        function)."""
        self._require_torch("replicate")
        return {d: self.module_on(d) for d in mesh.distinct_devices()}

    def _require_torch(self, what: str) -> None:
        if self.backend != "torch":
            raise ValueError(f"cannot {what} backend '{self.backend}'")

    def __call__(self, inputs):
        """numpy in → numpy out (copies both ways): a dict of named
        arrays gives a dict; a bare array (single-input functions) gives
        a bare array when the function has one output. A host function
        takes and returns numpy dicts as the JAX package's does (a bare
        array for a single-input function; a dict back)."""
        if self.backend == "host":
            d = _as_dict(inputs, self.input_names)
            return self.apply_fn(self.params,
                                 {k: np.asarray(v) for k, v in d.items()})
        single = not isinstance(inputs, dict)
        d = _as_dict(inputs, self.input_names)
        tensors = {k: torch.tensor(np.asarray(d[k]), device=self.device)
                   for k in self.input_names}
        out = self.apply(tensors)
        # sparkdl-lint: allow[H1] -- the numpy-in, numpy-out convenience call: host outputs are its return contract (the runner never calls it; it drains through timed_device_get)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if single and len(out) == 1:
            return next(iter(out.values()))
        return out

    # -- hot swap (the fleet registry's two-phase weight flip) --------------

    def _state_module(self) -> nn.Module:
        """The module whose ``state_dict`` names the weights: an installed
        or loaded program's graph module (which keeps the exported
        module's names), else the module."""
        if self.backend != "torch":
            raise ValueError(
                f"cannot stage params for backend {self.backend!r}")
        module = self.module
        return module.program if isinstance(module, _Exported) else module

    def state_dict(self) -> Tensors:
        """The function's weights by name: its module's ``state_dict``
        (tensors that share the live storage)."""
        return self._state_module().state_dict()

    def canonical_state(self, new_state: Dict[str, Any]) -> Dict[str, Any]:
        """``new_state`` by ``state_dict`` names. A ``fromSingle``
        function also takes its params by the keys it was built with
        (``{"w": ...}`` for ``params.p0``)."""
        aliases = self._param_aliases
        if aliases and set(new_state) == set(aliases):
            return {aliases[k]: v for k, v in new_state.items()}
        return dict(new_state)

    def stage_params(self, new_state: Dict[str, Any]) -> Tensors:
        """Copy ``new_state`` (host or device tensors, or numpy arrays,
        by ``state_dict`` name or :meth:`canonical_state` key) onto the
        function's device WITHOUT making it live: the hot-swap's staging
        half, off the dispatch path. On the card the copies run on a side
        stream, which is synchronised before this returns, and each
        tensor is ``record_stream``-ed for the device's default stream,
        the one a serve dispatcher computes on. Returns the staged tensors
        for :meth:`commit_params`; dropping them un-stages them."""
        self._state_module()   # a host function has no weights to stage
        state = self.canonical_state(new_state)

        def tensor(v):
            return v if isinstance(v, torch.Tensor) else \
                torch.tensor(np.asarray(v))

        if self.device.type != "cuda":
            return {k: tensor(v).to(self.device, copy=True)
                    for k, v in state.items()}
        side = torch.cuda.Stream(self.device)
        # the side stream starts after work already queued on the
        # device's tensors (a device-side source may still be written)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            staged = {k: tensor(v).to(self.device, non_blocking=True,
                                      copy=True)
                      for k, v in state.items()}
        # sparkdl-lint: allow[H1] -- a weight swap's staging fence: the side stream's copies must be complete before the caller flips the replica to them (swap time, off the serving stream)
        side.synchronize()
        compute = torch.cuda.default_stream(self.device)
        for t in staged.values():
            t.record_stream(compute)
        return staged

    def commit_params(self, new_state: Dict[str, Any],
                      staged: Tensors) -> None:
        """Flip to pre-staged weights: the module's parameters and
        buffers are rebound to ``staged`` (``load_state_dict(...,
        assign=True)``), with no transfer. ``new_state`` is what was
        staged (kept for the JAX package's signature). The caller holds
        the serve session's swap gate, so the flip lands BETWEEN
        dispatches, and drops the old tensors only after it. Copies on
        other devices (:meth:`module_on`) are dropped, to be made anew
        from the new weights."""
        self._state_module().load_state_dict(staged, strict=True,
                                             assign=True)
        with self._replicas_lock:
            self._replicas.clear()

    def install_program(self, program: "ModelFunction") -> None:
        """Make ``program``, a :meth:`deserialize`-d function on this
        function's device, this function's module — the counterpart of
        the JAX package's ``install_aot``, for the fleet's warm-start
        store (``fleet/warmstart.py``), which calls it before a replica's
        runner is built. The program's recorded output signature and
        fixed batch come with it."""
        if self.backend != "torch":
            raise ValueError(
                f"cannot install an executable for backend "
                f"{self.backend!r}")
        if _canonical(program.device) != _canonical(self.device):
            raise ValueError(
                f"cannot install a program on {program.device} into "
                f"{self.name} on {self.device}")
        self.module = program.module
        self._output_signature = program._output_signature
        self._fixed_batch = program._fixed_batch
        with self._replicas_lock:
            self._replicas.clear()

    # -- serialization (the "freeze" step) ----------------------------------

    def export(self, batch_size: Optional[int] = None) -> bytes:
        """The function frozen by ``torch.export`` with its weights baked
        in, as the bytes ``torch.export.save`` writes. ``batch_size=None``
        exports a symbolic batch of 1 to ``MAX_EXPORT_BATCH`` rows;
        an int, that batch alone."""
        if self.backend != "torch":
            raise ValueError(f"cannot export backend '{self.backend}'")
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
        t0 = time.perf_counter()
        # under no_grad, not inference_mode: export refuses inference
        # tensors
        with torch.no_grad():
            program = torch.export.export(self.module, args,
                                          dynamic_shapes=dynamic)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blob = buf.getvalue()
        log = compile_log()
        if log.armed:
            log.record_transfer(
                name=f"{self.name}.export", kind="export",
                wall_s=time.perf_counter() - t0,
                detail={"bytes": len(blob), "batch": batch_size})
        return blob

    @staticmethod
    def deserialize(blob: bytes, name: str = "exported",
                    device: DeviceLike = None) -> "ModelFunction":
        """Load bytes written by :meth:`export` onto ``device`` (``None`` =
        the card). The signatures and the fixed batch are read from the
        program, not from a probe."""
        device = resolve_device(device)
        t0 = time.perf_counter()
        program = _load_program(blob, device)
        log = compile_log()
        if log.armed:
            log.record_transfer(
                name=f"{name}.deserialize", kind="deserialize",
                wall_s=time.perf_counter() - t0,
                detail={"bytes": len(blob)})
        return ModelFunction._from_program(program, name, device)

    @staticmethod
    def _from_program(program, name: str,
                      device: torch.device) -> "ModelFunction":
        """A function over a loaded program: a module of its own
        (``program.module()``), the signatures read from the program."""
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
        the program onto the same kind of device. The export is kept and
        pickled again while the function's weights are unchanged
        (:meth:`_ship_key`), so a frame collected on Spark job after job
        exports its model once. A host function holds
        live host state (a TF graph) and refuses, as in the JAX
        package."""
        if self.backend == "host":
            raise TypeError(
                f"host-backend ModelFunction {self.name!r} cannot be "
                "serialized for shipping (it wraps live TF runtime "
                "state); re-create it on the worker from its source "
                "artifact (SavedModel/checkpoint path), or export a "
                "torch-backend model with ModelFunction.export instead")
        key = self._ship_key()
        if self._shipped is None or self._shipped[0] != key:
            self._shipped = (key, self.export(self._fixed_batch))
        return {"blob": self._shipped[1], "name": self.name,
                "device": self.device.type,
                "param_aliases": self._param_aliases}

    def _ship_key(self) -> tuple:
        """What the export depends on besides the code: the module, the
        fixed batch, and each weight's identity and in-place version
        (``Tensor._version``), so a rebind (``commit_params``), an
        installed program or an in-place update exports anew."""
        state = self._state_module().state_dict(keep_vars=True)
        return (id(self.module), self._fixed_batch) + tuple(
            (k, id(v), v._version) for k, v in state.items())

    def __setstate__(self, state):
        device = resolve_device(state["device"])
        self.__dict__.update(ModelFunction._from_program(
            _shipped_program(state["blob"], device), state["name"],
            device).__dict__)
        self._param_aliases = state.get("param_aliases")

    def __repr__(self) -> str:
        outs = self._output_names or "?"
        where = (f"device={self.device}" if self.backend == "torch"
                 else f"backend={self.backend}")
        return (f"ModelFunction({self.name}, {where}, "
                f"inputs={self.input_names}, outputs={outs})")


# the wrapper's old home: callers import it from here too
from sparkdl_tpu_torch.graph.utils import with_preprocessor  # noqa: E402,F401
