"""Data-parallel training step — counterpart of
``sparkdl_tpu/parallel/train.py``.

The JAX step is a pure function jitted against a mesh, and XLA inserts
its collectives. torch's idiom is one process per device, so here the
step runs in every rank of a ``torch.distributed`` group laid out as a
global mesh (``parallel/distributed.py::global_mesh``), and the
collectives are written out:

* **data axis.** Each rank takes its rows of the global batch. BatchNorm
  averages its batch mean and mean of squares over the data group
  (``models/layers.py::synced_batch_stats``), so the statistics are the
  global batch's, as in the JAX step, whose sharded program is the
  unsharded one. The gradients are averaged over the data group in one
  flat all-reduce before the optimizer steps, and the ``loss`` and
  ``accuracy`` metrics are averaged the same way.
* **model axis** (``shard_model_axis=True``). The parameters that
  :func:`~sparkdl_tpu_torch.parallel.mesh.param_shardings` splits are
  held as this rank's shard only, with their optimizer state. Before the
  forward they are all-gathered in the model group by an autograd-aware
  gather, whose backward reduce-scatters their gradients.

A local mesh of one slot, or no mesh, runs the step with no collective.
A local mesh of several slots refuses to train: run one process per
device and use ``global_mesh``. The state is mutated in place: the
module's parameters and BatchNorm buffers, and the torch optimizer.

Optimizers are named, as the JAX package passes optax transformations:
``("sgd", lr)``, ``("sgd", lr, momentum)`` (optax's trace ``g +
m·trace`` is torch's momentum with ``dampening=0``) and ``("adam", lr)``
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, in both).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (
    Any,
    Callable,
    Container,
    Dict,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import synced_batch_stats
from sparkdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    collective_launch,
    data_sharding,
    param_shardings,
)

_STAT_SUFFIXES = ("running_mean", "running_var")


@dataclasses.dataclass
class TrainState:
    """A module in training: its ``step`` count, the ``params`` the
    optimizer updates (the module's own parameters, or this rank's
    shards of the model-axis-split ones), its BatchNorm statistics
    (``batch_stats``, the module's live buffers), the torch
    ``optimizer`` and the ``tx`` it was made from. ``shards`` maps each
    split parameter to the dimension split; ``mesh`` is the global mesh
    the state is laid out on (None: unsharded, one process)."""

    step: int
    module: nn.Module
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    tx: Tuple
    shards: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh: Optional[Mesh] = None

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    @property
    def layout(self) -> Dict[str, int]:
        """The mesh layout a checkpoint records (empty when unsharded)."""
        if self.mesh is None:
            return {}
        return {"data": self.mesh.shape[DATA_AXIS],
                "model": self.mesh.shape[MODEL_AXIS],
                "model_rank": self.mesh.coordinate[1]}


def make_optimizer(tx: Sequence, params) -> torch.optim.Optimizer:
    """A torch optimizer for a named ``tx``: ``("sgd", lr[, momentum])``
    or ``("adam", lr)``."""
    kind, *args = tuple(tx)
    params = list(params)
    if kind == "sgd" and len(args) in (1, 2):
        momentum = float(args[1]) if len(args) == 2 and args[1] else 0.0
        return torch.optim.SGD(params, lr=float(args[0]), momentum=momentum,
                               dampening=0.0, nesterov=False)
    if kind == "adam" and len(args) == 1:
        return torch.optim.Adam(params, lr=float(args[0]),
                                betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"tx must be ('sgd', lr), ('sgd', lr, momentum) or "
                     f"('adam', lr), got {tuple(tx)!r}")


def create_train_state(module: nn.Module,
                       variables: Optional[Mapping[str, Any]],
                       tx: Sequence) -> TrainState:
    """Load ``variables`` (a state dict: params and BatchNorm buffers,
    e.g. ``models/convert.py::flax_to_state_dict``; None keeps the
    module's own) into ``module`` in place and wrap it with an
    optimizer named by ``tx``."""
    if variables is not None:
        module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                if not isinstance(v, torch.Tensor) else v
                                for k, v in variables.items()}, strict=True)
    params = dict(module.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(
        step=0, module=module, params=params,
        batch_stats=_batch_stats(module),
        optimizer=make_optimizer(tx, params.values()), tx=tuple(tx))


def _batch_stats(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in module.named_buffers()
            if k.endswith(_STAT_SUFFIXES)}


def _to_nchw(images: torch.Tensor) -> torch.Tensor:
    # uint8 NHWC → NCHW, channels_last in memory (the zoo model's layout)
    return images.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _batch(batch: Mapping[str, Any], device: torch.device,
           rows: Optional[Tuple[int, int]] = None):
    images = torch.as_tensor(batch["image"])
    labels = torch.as_tensor(batch["label"]).long()
    if rows is not None:
        images, labels = images[rows[0]:rows[1]], labels[rows[0]:rows[1]]
    return images.to(device), labels.to(device)


class _GatherShards(torch.autograd.Function):
    """All-gather of a split parameter's shards along ``dim`` in the
    model group; its backward sums the full gradient over the group and
    hands each rank its shard's slice (a reduce-scatter written as an
    all-reduce: gloo has no reduce-scatter, and torch's autograd gather
    falls back to a scatter that fails on a subgroup)."""

    @staticmethod
    def forward(ctx, shard, dim, group, size, rank):
        import torch.distributed as dist
        ctx.dim, ctx.group, ctx.size, ctx.rank = dim, group, size, rank
        parts = [torch.empty_like(shard) for _ in range(size)]
        dist.all_gather(parts, shard.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        part = grad.chunk(ctx.size, ctx.dim)[ctx.rank]
        return part.contiguous(), None, None, None, None


def _full_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every parameter at its full size: the split ones all-gathered
    (autograd-aware) in the model group of the state's mesh."""
    if not state.shards:
        return state.params
    mesh = state.mesh
    group = mesh.group(MODEL_AXIS)
    size, rank = mesh.shape[MODEL_AXIS], mesh.coordinate[1]
    full = dict(state.params)
    for name, dim in state.shards.items():
        full[name] = _GatherShards.apply(state.params[name], dim, group,
                                         size, rank)
    return full


def _logits(state: TrainState, x: torch.Tensor,
            train: bool) -> torch.Tensor:
    if not state.shards:
        return state.module(x, features_only=False, train=train)
    return torch.func.functional_call(
        state.module, _full_params(state), (x,),
        {"features_only": False, "train": train}, strict=False)


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Per row ``-sum(targets * log_softmax(logits))`` (optax's)."""
    return -(targets * F.log_softmax(logits.float(), dim=-1)).sum(-1)


def _metrics(logits, labels, loss) -> Dict[str, torch.Tensor]:
    acc = (logits.argmax(-1) == labels).float().mean()
    return {"loss": loss.detach(), "accuracy": acc}


class TrainStep:
    """One optimizer step on a zoo-style module (``forward(x,
    features_only, train)``): softmax cross-entropy on the logits with
    optax's label smoothing ``(1-α)·onehot + α/C``, BatchNorm statistics
    moved in train mode. ``step(state, batch)`` with ``batch`` {"image":
    uint8 NHWC, "label": int} returns ``(state, {"loss", "accuracy"})``;
    the state, which carries the module, is updated in place."""

    def __init__(self, preprocess: Callable, num_classes: int,
                 label_smoothing: float = 0.0):
        self.preprocess = preprocess
        self.num_classes = int(num_classes)
        self.label_smoothing = float(label_smoothing)

    def targets(self, labels: torch.Tensor) -> torch.Tensor:
        onehot = F.one_hot(labels, self.num_classes).float()
        a = self.label_smoothing
        if a == 0.0:
            return onehot
        return (1.0 - a) * onehot + a / self.num_classes

    def __call__(self, state: TrainState, batch: Mapping[str, Any]):
        return self.run(state, batch)

    def run(self, state: TrainState, batch: Mapping[str, Any],
            mesh: Optional[Mesh] = None):
        """The step; on a global ``mesh`` with this rank's rows, the
        gradient and metric all-reduces and the model-axis gathers."""
        rows = None
        sync = contextlib.nullcontext()
        if mesh is not None:
            data_group = mesh.group(DATA_AXIS)
            rows = data_sharding(mesh).rows(
                len(batch["label"]))[mesh.coordinate[0]]
            sync = synced_batch_stats(data_group, mesh.shape[DATA_AXIS])
        images, labels = _batch(batch, state.device, rows)
        x = self.preprocess(_to_nchw(images))
        with sync:
            logits = _logits(state, x, True)
        loss = softmax_cross_entropy(logits, self.targets(labels)).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = _metrics(logits, labels, loss)
        if mesh is not None:
            _average_grads(state, mesh, data_group)
            metrics = _average(metrics, data_group, mesh.shape[DATA_AXIS])
        state.optimizer.step()
        state.step += 1
        return state, metrics


def make_train_step(module: nn.Module, preprocess: Callable,
                    num_classes: int,
                    label_smoothing: float = 0.0) -> TrainStep:
    """The train step of ``module`` (see :class:`TrainStep`; the JAX
    package's signature: the step runs the module its state carries);
    run it sharded with :func:`shard_train_step`."""
    return TrainStep(preprocess, num_classes, label_smoothing)


def make_eval_step(module: nn.Module, preprocess: Callable,
                   num_classes: int) -> Callable:
    """Loss and accuracy of a batch with frozen statistics (for
    CrossValidator scoring)."""

    def eval_step(state: TrainState, batch: Mapping[str, Any]
                  ) -> Dict[str, torch.Tensor]:
        images, labels = _batch(batch, state.device)
        with torch.no_grad():
            logits = _logits(state, preprocess(_to_nchw(images)), False)
            onehot = F.one_hot(labels, num_classes).float()
            loss = softmax_cross_entropy(logits, onehot).mean()
        return _metrics(logits, labels, loss)

    return eval_step


def _average(metrics: Dict[str, torch.Tensor], group, size: int):
    import torch.distributed as dist
    stacked = torch.stack([metrics["loss"], metrics["accuracy"]])
    dist.all_reduce(stacked, group=group)
    stacked = stacked / size
    return {"loss": stacked[0], "accuracy": stacked[1]}


def average_gradients(params: Mapping[str, torch.Tensor], group,
                      size: int, shards: Container[str] = (),
                      model_n: int = 1) -> None:
    """Average every gradient of ``params`` over ``group`` (``size``
    ranks) in one flat all-reduce. A split parameter's gradient (named in
    ``shards``) came out of the gather's backward summed over the model
    group's ``model_n`` identical replicas of the forward, so it is
    divided by the model axis too."""
    import torch.distributed as dist
    names = [k for k, p in params.items() if p.grad is not None]
    grads = [params[k].grad for k in names]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= size
    lo = 0
    for k, g in zip(names, grads):
        part = flat[lo:lo + g.numel()].view_as(g)
        lo += g.numel()
        g.copy_(part / model_n if k in shards else part)


def _average_grads(state: TrainState, mesh: Mesh, data_group) -> None:
    average_gradients(state.params, data_group, mesh.shape[DATA_AXIS],
                      state.shards, mesh.shape[MODEL_AXIS])


class ShardedTrainStep:
    """A :class:`TrainStep` bound to a global mesh: ``step(state,
    batch)`` takes the GLOBAL batch (its rows must split evenly over the
    data axis, as a JAX data sharding requires); each rank runs its rows,
    under :func:`collective_launch` when the mesh has several devices."""

    def __init__(self, step: TrainStep, mesh: Mesh):
        self.step = step
        self.mesh = mesh

    def __call__(self, state: TrainState, batch: Mapping[str, Any]):
        with collective_launch(self.mesh):
            return self.step.run(state, batch, self.mesh)


def shard_train_step(train_step: TrainStep, mesh: Optional[Mesh],
                     state: TrainState, shard_model_axis: bool = True
                     ) -> Tuple[Callable, TrainState]:
    """Bind ``train_step`` to ``mesh`` and lay out ``state`` on it.

    Returns ``(step, state)``. A global mesh (one process per device)
    splits the batch over its data axis and, with ``shard_model_axis``
    and a model axis above 1, holds the parameters that
    :func:`param_shardings` splits as this rank's shards, their optimizer
    state with them. No mesh, or a local mesh of one slot, returns the
    step as it is. A local mesh of several slots raises."""
    if mesh is None or not mesh.is_global:
        if mesh is not None and mesh.size > 1:
            raise ValueError(
                f"a train step does not run on a local mesh of "
                f"{mesh.size} slots: torch trains one process per "
                "device. Start one process per device, call "
                "parallel.initialize(...) in each, and pass "
                "parallel.global_mesh()")
        return train_step, state
    model_n = mesh.shape[MODEL_AXIS]
    model_rank = mesh.coordinate[1]
    if shard_model_axis and model_n > 1 and not state.shards:
        _shard_state(state, mesh, model_n, model_rank)
    state.mesh = mesh
    return ShardedTrainStep(train_step, mesh), state


def _shard_state(state: TrainState, mesh: Mesh, model_n: int,
                 model_rank: int) -> None:
    """Replace each split parameter by this rank's shard (the module
    keeps a meta placeholder: the full tensor is gathered per step) and
    rebuild the optimizer over the shards, slicing its state the same
    way (optax's state shards like its params in the JAX step)."""
    dims = {k: d for k, d in param_shardings(state.params, mesh).items()
            if d is not None}
    old_opt = state.optimizer
    new_params: Dict[str, torch.Tensor] = {}
    moved: Dict[int, Tuple[torch.Tensor, Optional[int]]] = {}
    for name, p in state.params.items():
        dim = dims.get(name)
        if dim is None:
            new_params[name] = p
            moved[id(p)] = (p, None)
            continue
        shard = nn.Parameter(
            p.detach().chunk(model_n, dim)[model_rank].clone())
        new_params[name] = shard
        moved[id(p)] = (shard, dim)
        owner, leaf = _owner(state.module, name)
        owner._parameters[leaf] = nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype, device="meta"),
            requires_grad=False)
    opt = make_optimizer(state.tx, new_params.values())
    for p_old, st in old_opt.state.items():
        p_new, dim = moved[id(p_old)]
        opt.state[p_new] = {
            k: (v.chunk(model_n, dim)[model_rank].clone()
                if dim is not None and isinstance(v, torch.Tensor)
                and v.shape == p_old.shape else v)
            for k, v in st.items()}
    state.params = new_params
    state.optimizer = opt
    state.shards = dims


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf
