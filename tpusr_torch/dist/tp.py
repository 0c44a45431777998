"""Tensor parallelism: output-channel-sharded parameters on a ('data',
'model') mesh (port of ``tpusr/dist/tp.py``).

The rule is JAX's (``tp_spec``): a conv or dense kernel shards its output
channels over 'model' when the axis divides them, its bias alike; a leaf
whose channels do not divide (the 3-channel tail conv of an SR net, a
class head of odd width) stays replicated. Each 'model' rank holds its
shard of every divisible leaf, and its Adam moments alike.

XLA inserts the collectives from the shardings; here they are explicit. A
module whose parameters are shards runs on its shard and gathers its output
channels from the other 'model' ranks (``tp_modules``):

- its input passes through ``_CopyToGroup``: the identity forward, an
  all-reduce of the input gradient backward, since each rank's input
  gradient is only its output channels' part;
- its output through ``_GatherChannels``: an all-gather of the channel
  axis forward, and backward this rank's slice of the output gradient,
  which every rank computes whole because everything downstream of the
  gather runs replicated. (``torch.distributed.nn.functional.all_gather``
  sums the gradient over the ranks instead, right for a loss that differs
  per rank and ``model``-times too large here.)

Gradients of sharded leaves are complete on their rank; gradients
all-reduce over 'data' only.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from tpusr_torch.dist.mesh import (all_gather_cat, axis_index, axis_size,
                                   batch_shard, make_mesh, shard_batch)


def make_tp_mesh(n_data: int, n_model: int, device=None):
    """2-D ('data', 'model') mesh over n_data * n_model ranks."""
    return make_mesh(shape=(n_data, n_model), axis_names=("data", "model"),
                     device=device)


def cout_dim(name: str, leaf: torch.Tensor) -> int:
    """The output-channel dim of a parameter by the port's layouts: a
    ``kernel`` is flax's (HWIO, (in, out)), so its last dim; a ``weight``
    is PyTorch's (OIHW, Linear's (out, in)) and a bias 1-D, so dim 0."""
    return leaf.dim() - 1 if name.endswith("kernel") else 0


def tp_spec(path: str, leaf, n_model: int, axis: str = "model") -> tuple:
    """The placement of one parameter leaf (JAX: its ``PartitionSpec``):
    ``axis`` at its output-channel dim when ``n_model`` divides it, else
    ``()`` (replicated). ``path`` is the port's parameter name."""
    shape = tuple(leaf.shape)
    if len(shape) < 1:
        return ()
    d = cout_dim(path, leaf)
    if shape[d] % n_model:
        return ()
    return tuple(axis if i == d else None for i in range(len(shape)))


def _shard(mesh, name: str, leaf: torch.Tensor, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    spec = tp_spec(name, leaf, n, axis)
    if not spec:
        return leaf
    d = spec.index(axis)
    size = leaf.shape[d] // n
    out = leaf.detach().narrow(d, axis_index(mesh, axis) * size, size).clone()
    return out.requires_grad_(leaf.requires_grad)


def shard_params_tp(mesh, tree, axis: str = "model"):
    """A parameter tree with each divisible leaf replaced by this rank's
    output-channel shard: a dict name -> tensor, or a trainer's
    ``TrainState`` (its parameters and Adam moments by the same names;
    the step count and rate as they are)."""
    if isinstance(tree, dict):
        return {k: _shard(mesh, k, v, axis) if isinstance(v, torch.Tensor)
                else v for k, v in tree.items()}
    from tpusr_torch.train.trainer import TrainState

    if isinstance(tree, TrainState):
        opt = dict(tree.opt_state)
        for key in ("mu", "nu"):
            opt[key] = shard_params_tp(mesh, opt[key], axis)
        return TrainState(params=shard_params_tp(mesh, tree.params, axis),
                          opt_state=opt, lr=tree.lr)
    raise TypeError(f"shard_params_tp: a dict of tensors or a TrainState, "
                    f"not {type(tree).__name__}")


def gather_params_tp(mesh, tree, model: nn.Module, axis: str = "model"):
    """The inverse of ``shard_params_tp`` on every rank: each shard of
    ``tree`` (a dict, or a ``TrainState`` with its Adam moments) gathered
    whole, what a checkpoint of a tensor-parallel state writes."""
    own = dict(model.named_parameters())

    def whole(name, t):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) == tuple(
                own[name].shape):
            return t
        return all_gather_cat(t.detach(), mesh.get_group(axis),
                              axis_size(mesh, axis), cout_dim(name, t))
    if isinstance(tree, dict):
        return {k: whole(k, v) for k, v in tree.items()}
    from tpusr_torch.train.trainer import TrainState

    opt = dict(tree.opt_state)
    for key in ("mu", "nu"):
        opt[key] = gather_params_tp(mesh, opt[key], model, axis)
    return TrainState(params=gather_params_tp(mesh, tree.params, model, axis),
                      opt_state=opt, lr=tree.lr)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """All-gather of dim ``dim`` over ``group`` forward; this rank's slice
    of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim, index, size):
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        return all_gather_cat(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None, None)


def gather_channels(x: torch.Tensor, mesh, dim: int,
                    axis: str = "model") -> torch.Tensor:
    """The whole channel axis ``dim`` of a shard on every ``axis`` rank."""
    return _GatherChannels.apply(x, mesh.get_group(axis), dim,
                                 axis_index(mesh, axis), axis_size(mesh, axis))


def sharded_names(model: nn.Module, params: dict) -> set:
    """The names of ``params`` that are shards: smaller than the model's
    own parameter of that name."""
    own = dict(model.named_parameters())
    return {k for k, v in params.items()
            if k in own and tuple(v.shape) != tuple(own[k].shape)}


@contextlib.contextmanager
def tp_modules(model: nn.Module, params: dict, mesh, axis: str = "model"):
    """Within the block, every submodule of ``model`` whose parameters in
    ``params`` are shards takes its input through ``_CopyToGroup`` and
    gathers its output channels (``nn.Conv2d``: NCHW's dim 1; the others
    NHWC or (N, C): the last dim). A no-op when nothing is sharded."""
    shards = sharded_names(model, params)
    handles = []
    if shards:
        group = mesh.get_group(axis)
        for name, mod in model.named_modules():
            own = [f"{name}.{p}" if name else p
                   for p, _ in mod.named_parameters(recurse=False)]
            if not any(p in shards for p in own):
                continue
            dim = 1 if isinstance(mod, nn.Conv2d) else -1

            def pre(_m, args, kwargs, group=group):
                return (_CopyToGroup.apply(args[0], group),) + args[1:], kwargs

            def post(_m, _args, out, dim=dim):
                return gather_channels(out, mesh, dim, axis)

            handles.append(mod.register_forward_pre_hook(pre, with_kwargs=True))
            handles.append(mod.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def full_param(params: dict, name: str, model: nn.Module, mesh,
               axis: str = "model") -> torch.Tensor:
    """Parameter ``name`` whole on every rank (its shards gathered, with the
    slice gradient), or as it is when it is not sharded."""
    t = params[name]
    own = dict(model.named_parameters())[name]
    if tuple(t.shape) == tuple(own.shape):
        return t
    return gather_channels(t, mesh, cout_dim(name, t), axis)


def tp_apply(mesh, model: nn.Module, params: dict, x: torch.Tensor,
             data_axis: str | None = "data", **kwargs) -> torch.Tensor:
    """``model`` on a global batch with tensor-parallel ``params``
    (``shard_params_tp``), the batch split over ``data_axis`` when the
    mesh has one; returns the global output on every rank (JAX: the jitted
    ``model.apply`` on sharded inputs)."""
    from torch.func import functional_call

    names = mesh.mesh_dim_names
    if data_axis in names:
        shard = batch_shard(mesh, x.shape[0], data_axis)
        x = shard_batch(mesh, x, batch_axis=data_axis)
    else:
        shard = None
    with tp_modules(model, params, mesh):
        out = functional_call(model, params, (x,), kwargs)
    return shard.gather(out) if shard is not None else out
