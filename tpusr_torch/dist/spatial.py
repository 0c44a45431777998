"""Spatial sharding (the sequence-parallel analog): ring attention and
full-image ESRGAN SR with the image's rows split over a mesh axis (port of
``tpusr/dist/spatial.py``).

- **Ring attention** (``make_ring_attention``, ``ring_attention``): the
  token axis (HW, row-major, so a block of image rows is a block of tokens)
  is split over a mesh axis; each rank keeps its query block and passes the
  key/value blocks around the ring, n - 1 hops in all (to the next rank,
  from the previous one: ``batch_isend_irecv``), folding each block into the
  exact online-softmax recurrence. The dense (HW, HW) map never exists; a
  rank holds (HW/n, HW/n) scores at a time. The two products are
  ``torch.matmul`` in fp32 (TF32 off), as JAX's ``einsum`` at
  ``precision=HIGHEST`` outside any Pallas kernel.
- **Full-image SR** (``full_image_esrgan_sr``): the generator runs on each
  rank's block of rows. XLA inserted the conv halo exchanges by itself; here
  ``halo_convs`` does: before every 3x3 conv each rank sends its first row
  to the rank above and its last row to the rank below and receives theirs,
  K2 runs on the slab of H/n + 2 rows (SAME), and the two edge rows are
  dropped. At the image's edges the halo rows are zeros, SAME's padding. The
  pixel shuffle keeps rows local (each doubles), and both attention sites
  run the ring. One image in, the whole SR image back on every rank.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from tpusr_torch.dist.mesh import (NamedSharding, all_gather_cat,
                                   axis_index, axis_ranks, axis_size, hop,
                                   mesh_device)
from tpusr_torch.models.edsr import Conv3x3


def _fold(state, gq, f_blk, h_blk):
    """One online-softmax fold of a key/value block into (m, l, acc); the
    score matrix is reused in place for its exponentials."""
    m, l, acc = state
    s = torch.matmul(gq, f_blk.transpose(1, 2))
    m_new = torch.maximum(m, s.amax(dim=-1))
    scale = torch.exp(m - m_new)
    p = s.sub_(m_new[..., None]).exp_()
    l = l * scale + p.sum(dim=-1)
    acc = acc * scale[..., None] + torch.matmul(p, h_blk)
    return m_new, l, acc


def ring_attention(gq: torch.Tensor, fk: torch.Tensor, hv: torch.Tensor,
                   ranks: list[int], me: int) -> torch.Tensor:
    """Exact softmax attention of this rank's queries ``gq`` (B, N/n, dk)
    over every rank's keys and values, this rank's being ``fk``/``hv``;
    ``ranks`` are the ring's global ranks and ``me`` this rank's place in
    it. No gradient (serving only)."""
    n = len(ranks)
    b, nl, _ = gq.shape
    with torch.no_grad():
        state = (torch.full((b, nl), -math.inf, dtype=gq.dtype,
                            device=gq.device),
                 torch.zeros((b, nl), dtype=gq.dtype, device=gq.device),
                 torch.zeros((b, nl, hv.shape[-1]), dtype=gq.dtype,
                             device=gq.device))
        f_blk, h_blk = fk, hv
        for step in range(n):
            state = _fold(state, gq, f_blk, h_blk)
            if step < n - 1:   # n blocks need n - 1 hops
                nxt, prev = ranks[(me + 1) % n], ranks[(me - 1) % n]
                f_blk, h_blk = hop([(f_blk, nxt), (h_blk, nxt)],
                                   [(f_blk, prev), (h_blk, prev)])
        _m, l, acc = state
        return acc / l[..., None]


def make_ring_attention(mesh, axis: str = "data"):
    """Build ``attention_fn(gg, ff, hf) -> o``: exact ring attention with
    the tokens split over ``mesh`` axis ``axis``. gg/ff/hf are the whole
    (B, N, d) query/key/value tensors on every rank (the SelfAttention
    projections g/f/h); each rank takes its block of N/n tokens, runs the
    ring, and the blocks of ``o`` are gathered back on every rank. N must
    be divisible by the axis size."""
    n = axis_size(mesh, axis)
    ranks, me, group = axis_ranks(mesh, axis), axis_index(mesh, axis), \
        mesh.get_group(axis)

    def attention_fn(gg, ff, hf):
        tokens = gg.shape[1]
        if tokens % n:
            raise ValueError(
                f"ring attention: token count {tokens} not divisible by mesh "
                f"axis '{axis}' size {n}")
        blk = slice(me * tokens // n, (me + 1) * tokens // n)
        o = ring_attention(gg[:, blk], ff[:, blk], hf[:, blk], ranks, me)
        return all_gather_cat(o, group, n, 1)

    return attention_fn


def spatial_sharding(mesh, axis: str = "data") -> NamedSharding:
    """(B, H, W, C) with H split over the mesh axis."""
    return NamedSharding(mesh, (None, axis))


@contextlib.contextmanager
def halo_convs(module: torch.nn.Module, ranks: list[int], me: int):
    """Within the block, every ``Conv3x3`` of ``module`` runs on this rank's
    block of rows with one halo row from each neighbour: the neighbours'
    edge rows are exchanged (``batch_isend_irecv``), zeros stand at the
    image's edges, K2 runs on the slab and the two edge rows are dropped."""
    n = len(ranks)
    up = ranks[me - 1] if me > 0 else None
    down = ranks[me + 1] if me < n - 1 else None

    def pre(_m, args):
        x = args[0]
        row = x[:, :1]
        sends = [(x[:, :1], up)] * (up is not None) + \
            [(x[:, -1:], down)] * (down is not None)
        recvs = [(row, up)] * (up is not None) + \
            [(row, down)] * (down is not None)
        got = hop(sends, recvs)
        top = got.pop(0) if up is not None else torch.zeros_like(row)
        bottom = got.pop(0) if down is not None else torch.zeros_like(row)
        return (torch.cat([top, x, bottom], 1),) + args[1:]

    def post(_m, _args, out):
        return out[:, 1:-1]

    handles = []
    for mod in module.modules():
        if isinstance(mod, Conv3x3):
            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def full_image_esrgan_sr(gen, img: torch.Tensor, mesh,
                         axis: str = "data") -> torch.Tensor:
    """Run the ESRGAN generator on a FULL image with its rows split over the
    mesh axis.

    ``gen`` is an ``ESRGANGenerator`` (it holds its weights: JAX's
    ``variables`` argument has no counterpart; its attention is replaced by
    the ring for the call). ``img`` is the whole (B, H, W, C) image in
    [-1, 1] on every rank; H (and so the token counts at both attention
    sites) must be divisible by the axis size. Returns the whole (B,
    H*scale, W*scale, C) SR image on every rank, equal to ``gen(img)`` up to
    the order of float32 sums."""
    n = axis_size(mesh, axis)
    if img.shape[1] % n:
        raise ValueError(
            f"full_image_esrgan_sr: H={img.shape[1]} not divisible by mesh "
            f"axis '{axis}' size {n} (pad the image or pick a mesh shape "
            f"that divides H)")
    ranks, me = axis_ranks(mesh, axis), axis_index(mesh, axis)
    rows = img.shape[1] // n
    x = img.to(mesh_device(mesh))[:, me * rows:(me + 1) * rows].contiguous()

    def ring(gg, ff, hf):
        return ring_attention(gg, ff, hf, ranks, me)

    saved = gen.attention_block_size, gen.attention_fn
    gen.attention_block_size, gen.attention_fn = None, ring
    try:
        with torch.no_grad(), halo_convs(gen, ranks, me):
            y = gen(x)
    finally:
        gen.attention_block_size, gen.attention_fn = saved
    return all_gather_cat(y, mesh.get_group(axis), n, 1)
