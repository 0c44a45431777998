"""Pipeline parallelism: the EDSR res-block chain staged over a mesh axis
(port of ``tpusr/dist/pp.py``).

- The mesh gets a ``'stage'`` axis; stage ``s`` holds res blocks
  ``[s*k, (s+1)*k)`` of the chain (``stack_res_params``).
- The batch splits into M microbatches that run the GPipe schedule of
  ``M + S - 1`` steps: at step t stage s applies its blocks to microbatch
  ``t - s`` and hands the activation to stage ``s + 1``
  (``batch_isend_irecv``, ``dist.mesh.hop``); the last stage's outputs are
  broadcast to every stage (JAX: the ``psum`` of a buffer that only the last
  stage fills).
- The convs outside the chain (head, body and skip, upsample, tail) run on
  the full batch outside the pipelined region, replicated over the stages
  and split over 'data' when a ``data_axis`` is given.
- JAX's backward falls out of the transposes of ``ppermute`` and ``psum``;
  here it is written out: the reverse schedule hands each microbatch's
  output gradient from stage ``s + 1`` back to stage ``s``, which runs the
  backward of its blocks on it; stage 0's input gradients are broadcast and
  go into the head with the skip's. Each stage's block gradients are
  summed into the whole tree over the stages (a stage's blocks are zeros
  elsewhere), so every rank steps the whole parameter tree.

The convs are K2's (``models.edsr.conv3x3``: forward, and its input
gradient where autograd needs one). The loss and gradients equal the dense
step's up to the order of float32 sums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpusr_torch.dist.mesh import (all_gather_cat, all_reduce_flat,
                                   axis_index, axis_ranks, axis_size, hop,
                                   make_mesh, mesh_device)
from tpusr_torch.models.edsr import conv3x3
from tpusr_torch.models.layers import pixel_shuffle


def _res_names(params: dict) -> list[str]:
    blocks = {k.split(".")[0] for k in params if k.startswith("res")}
    return sorted(blocks, key=lambda s: int(s[3:]))


def stack_res_params(params: dict, n_stages: int):
    """Split an EDSR parameter dict (name -> tensor) into (the stacked res
    chain, the rest): the stacked tree ``{"conv1": {"kernel", "bias"},
    "conv2": ...}`` has leading dims ``(n_stages, blocks_per_stage)`` on
    every leaf; the rest ``{"head": {"kernel", "bias"}, ...}`` holds head,
    body, up and tail."""
    names = _res_names(params)
    if not names or len(names) % n_stages:
        raise ValueError(
            f"{len(names)} res blocks do not split into {n_stages} stages")
    k = len(names) // n_stages
    stacked = {
        conv: {leaf: torch.stack([params[f"{b}.{conv}.{leaf}"] for b in names])
               .reshape((n_stages, k) + tuple(params[f"{names[0]}.{conv}.{leaf}"]
                                              .shape))
               for leaf in ("kernel", "bias")}
        for conv in ("conv1", "conv2")}
    rest = {}
    for name, t in params.items():
        if not name.startswith("res"):
            mod, leaf = name.rsplit(".", 1)
            rest.setdefault(mod, {})[leaf] = t
    return stacked, rest


def _conv(p: dict, name: str, x: torch.Tensor, relu: bool = False):
    return conv3x3(x, p[f"{name}.kernel"], p[f"{name}.bias"], relu)


class _Pipeline:
    """One EDSR forward (and backward) with the res chain pipelined over
    ``stage_axis``; ``params`` is the model's ordinary parameter dict."""

    def __init__(self, model, mesh, n_micro: int, stage_axis: str,
                 data_axis: str | None):
        self.model, self.mesh, self.n_micro = model, mesh, n_micro
        self.stage_axis, self.data_axis = stage_axis, data_axis
        self.n_stages = axis_size(mesh, stage_axis)
        self.stage = axis_index(mesh, stage_axis)
        self.ranks = axis_ranks(mesh, stage_axis)
        self.stage_group = mesh.get_group(stage_axis)
        scale = model.scale_factor
        self.ups = [("up0", 2), ("up1", 2)] if scale == 4 else [("up0", scale)]

    def _blocks(self) -> list[str]:
        names = [f"res{i}" for i in range(self.model.num_res_blocks)]
        if len(names) % self.n_stages:
            raise ValueError(f"{len(names)} res blocks do not split into "
                             f"{self.n_stages} stages")
        k = len(names) // self.n_stages
        return names[self.stage * k:(self.stage + 1) * k]

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """(M, mb_local, ...): the microbatches' rows on this rank."""
        n = x.shape[0]
        if n % self.n_micro:
            raise ValueError(f"batch {n} not divisible by "
                             f"n_micro={self.n_micro}")
        mb = rows = n // self.n_micro
        lo = 0
        if self.data_axis is not None:
            nd = axis_size(self.mesh, self.data_axis)
            if mb % nd:
                raise ValueError(
                    f"microbatch size {mb} not divisible by mesh axis "
                    f"'{self.data_axis}' size {nd}")
            rows = mb // nd
            lo = axis_index(self.mesh, self.data_axis) * rows
        return x.reshape((self.n_micro, mb) + x.shape[1:])[:, lo:lo + rows]

    def _hop(self, out, toward: int, like: torch.Tensor, recv: bool) -> list:
        """Send ``out`` (unless None) to stage ``s + toward``; receive a
        tensor shaped as ``like`` from stage ``s - toward`` when ``recv``."""
        s = self.stage
        return hop([(out, self.ranks[s + toward])] if out is not None else [],
                   [(like, self.ranks[s - toward])] if recv else [])

    def forward(self, p: dict, xm: torch.Tensor, grad: bool):
        """(h0, y, record): the head's output and the chain's output for
        every microbatch on every stage; ``record`` keeps this stage's
        (input, output) per microbatch for the backward."""
        model, s, n_s, m_total = self.model, self.stage, self.n_stages, self.n_micro
        blocks = self._blocks()
        with torch.set_grad_enabled(grad):
            h0 = _conv(p, "head", xm.flatten(0, 1)).reshape(
                xm.shape[:2] + (xm.shape[2], xm.shape[3], -1))
        record, outs, buf = {}, {}, None
        for t in range(m_total + n_s - 1):
            m = t - s
            out = None
            if 0 <= m < m_total:
                inp = h0[m].detach() if s == 0 else buf
                inp = inp.requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    y = inp
                    for b in blocks:
                        r = _conv(p, f"{b}.conv2", _conv(p, f"{b}.conv1", y, True))
                        y = y + model.res_scaling * r
                out = y
                record[m] = (inp, out)
                if s == n_s - 1:
                    outs[m] = out.detach()
            # hand microbatch t - s to stage s + 1; take t - s + 1 from s - 1
            got = self._hop(out if s < n_s - 1 else None, +1,
                            h0[0], s > 0 and 0 <= t - (s - 1) < m_total)
            if got:
                buf = got[0]
        if s == n_s - 1:
            y_all = torch.stack([outs[m] for m in range(m_total)])
        else:
            y_all = torch.empty_like(h0.detach())
        dist.broadcast(y_all, self.ranks[-1], group=self.stage_group)
        return h0, y_all, record

    def tail(self, p: dict, y: torch.Tensor, h0: torch.Tensor):
        """Body conv + skip, the upsample convs, the tail conv and the clip
        on (M, mb, ...) microbatches, as one batch."""
        z = _conv(p, "body", y.flatten(0, 1)) + h0.flatten(0, 1)
        for name, r in self.ups:
            z = pixel_shuffle(_conv(p, name, z), r)
        z = _conv(p, "tail", z)
        z = torch.minimum(torch.maximum(z, z.new_zeros(())), z.new_ones(()))
        return z.reshape(y.shape[:2] + z.shape[1:])

    def backward(self, record: dict, dy: torch.Tensor) -> torch.Tensor:
        """The reverse schedule: output gradients from stage s + 1, the
        blocks' backward, input gradients to stage s - 1. Returns stage 0's
        input gradients (M, mb, ...), broadcast to every stage."""
        s, n_s, m_total = self.stage, self.n_stages, self.n_micro
        d_in, buf = {}, None
        for t in range(m_total + n_s - 1):
            m = m_total - 1 - (t - (n_s - 1 - s))
            g_in = None
            if 0 <= m < m_total:
                inp, out = record[m]
                g_out = dy[m] if s == n_s - 1 else buf
                inp.grad = None
                torch.autograd.backward(out, g_out)
                g_in = inp.grad
                d_in[m] = g_in
            # the microbatch stage s + 1 runs at this step is ours next
            m_next = m_total - 1 - (t - (n_s - 2 - s))
            got = self._hop(g_in if s > 0 else None, -1, dy[0],
                            s < n_s - 1 and 0 <= m_next < m_total)
            if got:
                buf = got[0]
        if s == 0:
            dh0 = torch.stack([d_in[m] for m in range(m_total)])
        else:
            dh0 = torch.empty_like(dy)
        dist.broadcast(dh0, self.ranks[0], group=self.stage_group)
        return dh0


def make_pp_edsr_apply(model, mesh, n_micro: int, stage_axis: str = "stage",
                       data_axis: str | None = None):
    """Build ``apply(params, x) -> sr``: the EDSR forward with the res chain
    pipelined over ``mesh``'s ``stage_axis``.

    ``model`` is an ``EDSR`` (its block count, res_scaling and scale fix
    the schedule); ``params`` its ordinary parameter dict (name ->
    tensor). ``x`` is the full (N, h, w, c) batch on every rank, split into
    ``n_micro`` microbatches (``n_micro >= n_stages`` keeps the bubble at
    ``(S-1)/(M+S-1)``); with ``data_axis`` each microbatch's rows are also
    split over that axis (DP x PP). Returns the whole SR batch on every
    rank; the same convs in the same order as ``model``."""
    pipe = _Pipeline(model, mesh, n_micro, stage_axis, data_axis)

    def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
        x = x.to(mesh_device(mesh))
        xm = pipe._split(x)
        with torch.no_grad():
            h0, y, _ = pipe.forward(params, xm, grad=False)
            sr = pipe.tail(params, y, h0)
        if data_axis is not None:
            sr = all_gather_cat(sr, mesh.get_group(data_axis),
                                axis_size(mesh, data_axis), dim=1)
        return sr.reshape((x.shape[0],) + sr.shape[2:])

    return apply


def make_pp_train_step(model, mesh, n_micro: int, learning_rate=1e-4,
                       stage_axis: str = "stage",
                       data_axis: str | None = None):
    """One full PP training step: the MSE loss through the pipelined
    forward, the gradients by the reverse schedule, an SGD update. Returns
    ``step(params, x, y) -> (params, loss)``: the new parameters (the whole
    ordinary tree, on every rank) and the global loss;
    ``step.value_and_grad(params, x, y) -> (loss, {name: gradient})`` is
    the step without the update."""
    pipe = _Pipeline(model, mesh, n_micro, stage_axis, data_axis)

    def value_and_grad(params: dict, x: torch.Tensor, y: torch.Tensor):
        dev = mesh_device(mesh)
        x, y = x.to(dev), y.to(dev)
        xm, ym = pipe._split(x), pipe._split(y)
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        h0, y_all, record = pipe.forward(p, xm, grad=True)
        h0_leaf = h0.detach().requires_grad_()
        y_leaf = y_all.requires_grad_()
        with torch.enable_grad():
            sr = pipe.tail(p, y_leaf, h0_leaf)
            loss = torch.sum((sr - ym) ** 2) / y.numel()
            loss.backward()
        dh0 = pipe.backward(record, y_leaf.grad)
        torch.autograd.backward(h0, h0_leaf.grad + dh0)
        names = list(p)
        grads = [p[k].grad if p[k].grad is not None else torch.zeros_like(p[k])
                 for k in names]
        res = [i for i, k in enumerate(names) if k.startswith("res")]
        if res:     # each stage holds its own blocks' gradients
            summed = all_reduce_flat([grads[i] for i in res], pipe.stage_group)
            for i, g in zip(res, summed):
                grads[i] = g
        loss = loss.detach()
        if data_axis is not None:
            out = all_reduce_flat([loss] + grads, mesh.get_group(data_axis))
            loss, grads = out[0], out[1:]
        return loss, dict(zip(names, grads))

    def step(params: dict, x: torch.Tensor, y: torch.Tensor):
        loss, grads = value_and_grad(params, x, y)
        with torch.no_grad():
            new = {k: params[k] - learning_rate * g for k, g in grads.items()}
        return new, loss

    step.value_and_grad = value_and_grad
    return step


def make_pp_mesh(n_stages: int, n_data: int = 1, stage_axis: str = "stage",
                 device=None):
    """A ('data', 'stage') mesh for DP x PP, or a 1-D ('stage',) mesh when
    n_data == 1."""
    if n_data == 1:
        return make_mesh(shape=(n_stages,), axis_names=(stage_axis,),
                         device=device)
    return make_mesh(shape=(n_data, n_stages),
                     axis_names=("data", stage_axis), device=device)
