"""Shared layers (port of ``tpusr/models/layers.py``): DCR pixel shuffle,
spectral normalization (``SNConv``, ``SNDense``) and SAGAN self-attention
with its blockwise online-softmax form.

- ``SNConv``/``SNDense`` keep the kernel pristine and divide by sigma on the
  fly (the JAX package's non-destructive form of keras
  ``SpectralNormalization``); the power-iteration vector ``u`` is a buffer,
  updated by one step when ``update_stats=True``, and sigma takes no
  gradient through ``u`` or ``v``.
- ``SelfAttention``: f, g and h project to C/8, C/8 and C/2, softmax(g f^T)
  over all HW positions, the ``v`` projection back to C and a plain residual
  add (no gamma), ESRGAN_model.py:30-79.

None of these runs in a Pallas kernel in the JAX package: the 1x1 convs and
the attention products are matrix products (``torch.matmul`` in fp32, TF32
off, as JAX's ``precision=HIGHEST``), the strided SN convs ``F.conv2d``.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.core import prng
from tpusr_torch.models.init import (ParamRng, dense_params, draw_device,
                                    glorot_uniform, param_rng)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """tf.nn.depth_to_space parity (DCR): (N, H, W, C*r^2) -> (N, H*r, W*r, C).

    Not ``torch.nn.PixelShuffle``, which is CRD and would scramble the
    channels (the polyphase tail's channel order depends on DCR)."""
    n, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, oc)


# ------------------------------------------------------ spectral norm

def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v) + eps)


def _spectral_sigma(w_mat: torch.Tensor, u: torch.Tensor,
                    update_stats: bool) -> torch.Tensor:
    """One power-iteration estimate of ||W||_2 with the persistent ``u``
    (1, out). Gradients flow through ``w_mat`` only: the power-iteration
    vectors are computed without grad (keras parity)."""
    with torch.no_grad():
        v = _l2_normalize(u @ w_mat.T)
        u_new = _l2_normalize(v @ w_mat)
    sigma = (v @ w_mat @ u_new.T)[0, 0]
    if update_stats:
        with torch.no_grad():
            u.copy_(u_new)
    return sigma


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _SpectralParams(nn.Module):
    def _init_params(self, shape, rng: ParamRng) -> None:
        """flax's draws in the layer's scope, on its device: the
        glorot-uniform kernel, the zero bias, then the spectral ``u`` ~ N(0,
        1) (1, features) (``tpusr/models/layers.py:48-52``)."""
        dev = draw_device(rng.device)
        self.kernel = nn.Parameter(
            glorot_uniform(rng.next(), shape, dev) if rng.draw
            else torch.zeros(shape, device=dev), requires_grad=False)
        rng.next()
        self.bias = nn.Parameter(torch.zeros(shape[-1], device=dev),
                                 requires_grad=False)
        self.register_buffer("u", prng.normal(rng.next(), (1, shape[-1]), dev)
                             if rng.draw else torch.zeros((1, shape[-1]),
                                                          device=dev))


class SNConv(_SpectralParams):
    """Spectrally-normalized Conv2D (keras SpectralNormalization parity):
    HWIO ``kernel``, ``bias`` and the buffer ``u`` (1, features); NHWC in
    and out, XLA's SAME padding at any stride. Drawn on the device ``rng``
    carries."""

    def __init__(self, cin: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), padding: str = "SAME",
                 rng: ParamRng | None = None):
        super().__init__()
        if padding != "SAME":
            raise ValueError(f"SNConv: padding {padding!r} (SAME only)")
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self._init_params((kh, kw, cin, features), param_rng(rng))

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        kh, kw, _cin, feat = self.kernel.shape
        sigma = _spectral_sigma(self.kernel.reshape(-1, feat), self.u,
                                update_stats)
        w_bar = (self.kernel / sigma).to(x.dtype).permute(3, 2, 0, 1)
        (sh, sw), (h, w) = self.strides, x.shape[1:3]
        ph, pw = _same_pads(h, kh, sh), _same_pads(w, kw, sw)
        xp = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
        y = F.conv2d(xp, w_bar, stride=self.strides).permute(0, 2, 3, 1)
        return y + self.bias.to(x.dtype)


class SNDense(_SpectralParams):
    """Spectrally-normalized Dense: ``kernel`` (in, features), ``bias`` and
    the buffer ``u`` (1, features), drawn as ``SNConv``'s."""

    def __init__(self, cin: int, features: int, rng: ParamRng | None = None):
        super().__init__()
        self._init_params((cin, features), param_rng(rng))

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        sigma = _spectral_sigma(self.kernel, self.u, update_stats)
        return x @ (self.kernel / sigma).to(x.dtype) + self.bias.to(x.dtype)


# ------------------------------------------------------ self-attention

class Conv1x1(nn.Module):
    """flax ``nn.Conv(features, (1, 1))`` on NHWC as a matrix product over
    the channel axis: ``kernel`` (Cin, Cout) (flax's (1, 1, Cin, Cout)
    without its unit axes), ``bias``; flax's lecun_normal init in the
    scope ``rng``, on its device."""

    def __init__(self, cin: int, cout: int, rng: ParamRng):
        super().__init__()
        rng = param_rng(rng)
        kernel, bias = dense_params(rng, (cin, cout), rng.device)
        self.kernel = nn.Parameter(kernel, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


def _streaming_attention(gg: torch.Tensor, ff: torch.Tensor, hf: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """Exact softmax attention with O(HW * block) memory: a loop over key
    blocks with a running (max, denominator, numerator), the online-softmax
    recurrence in the JAX scan's order. HW must be divisible by
    ``block_size``."""
    b, n, _dk = gg.shape
    dv = hf.shape[-1]
    m = torch.full((b, n), -math.inf, dtype=gg.dtype, device=gg.device)
    den = torch.zeros((b, n), dtype=gg.dtype, device=gg.device)
    acc = torch.zeros((b, n, dv), dtype=gg.dtype, device=gg.device)
    for j in range(0, n, block_size):
        f_j, h_j = ff[:, j: j + block_size], hf[:, j: j + block_size]
        s = torch.matmul(gg, f_j.transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.matmul(p, h_j)
        m = m_new
    return acc / den[..., None]


class SelfAttention(nn.Module):
    """SAGAN-style self-attention over HW tokens (ESRGAN_model.py:30-79).

    ``block_size``: when set and smaller than HW, the (HW, HW) attention
    matrix is never materialized: keys and values stream through the exact
    online-softmax loop in blocks of ``block_size`` tokens, which must divide
    HW. ``attention_fn(gg, ff, hf) -> o`` on (B, HW, d) token tensors
    (queries = g, keys = f, values = h) overrides both and takes precedence.
    Its weights are drawn on the device ``rng`` carries.
    """

    def __init__(self, channels: int, block_size: int | None = None,
                 attention_fn: "typing.Callable | None" = None,
                 rng: ParamRng | None = None):
        super().__init__()
        self.channels = channels
        self.block_size = block_size
        self.attention_fn = attention_fn
        rng = param_rng(rng)
        self.f = Conv1x1(channels, channels // 8, rng.child("f"))
        self.g = Conv1x1(channels, channels // 8, rng.child("g"))
        self.h = Conv1x1(channels, channels // 2, rng.child("h"))
        self.v = Conv1x1(channels // 2, channels, rng.child("v"))

    def attend(self, x: torch.Tensor, block_size: int | None,
               attention_fn=None) -> torch.Tensor:
        """The layer with the given ``block_size`` and ``attention_fn``."""
        b, hh, ww, _c = x.shape
        n = hh * ww
        ff = self.f(x).reshape(b, n, -1)
        gg = self.g(x).reshape(b, n, -1)
        hf = self.h(x).reshape(b, n, -1)
        if attention_fn is not None:
            o = attention_fn(gg, ff, hf)
        elif block_size is None or n <= block_size:
            beta = torch.softmax(torch.matmul(gg, ff.transpose(1, 2)), dim=-1)
            o = torch.matmul(beta, hf)
        else:
            if n % block_size:
                raise ValueError(
                    f"block_size {block_size} must divide HW={n} (choose a "
                    f"divisor of the token count)")
            o = _streaming_attention(gg, ff, hf, block_size)
        o = o.reshape(b, hh, ww, self.channels // 2)
        return x + self.v(o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attend(x, self.block_size, self.attention_fn)
