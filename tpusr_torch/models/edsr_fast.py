"""EDSR fast forward with the composed polyphase tail (port of
``tpusr/models/edsr_fast.py``), in float32 or bfloat16.

The upsample tail (up conv(s), pixel shuffle(s), final conv) is linear, so it
collapses into one (k, k, f, s^2*channels) conv on the low-res grid, k = 7
for x4 (``fused_tail_kernel``). That composed conv covers the interior; a
``pad``-cell border band is recomputed with the chained tail on thin slabs,
whose zero paddings differ from the composed conv's. ``pixel_shuffle(fn(x),
s)`` equals ``EDSR.forward(x)``.

Every 3x3 conv (body, and ``up0``/``up1``/``tail`` on the slabs) runs through
K2, in the forward's dtype. The composed 7x7 conv is left to ``F.conv2d``
(float32 with TF32 off, or bfloat16), as the JAX package left it to XLA.

In bfloat16 the forward follows the JAX package's bf16 branch: weights and
biases rounded to bf16, ``W_eff``/``b_eff`` built in float64 from the float32
weights and then rounded, residual adds in bf16. One difference is by
design: JAX rounds each conv to bf16 and then adds a bf16 bias (two
roundings); K2 adds the bias in fp32 and rounds once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpusr_torch.bridge import hwio_to_oihw
from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
from tpusr_torch.device import fp32_math
from tpusr_torch.models.layers import pixel_shuffle


def _chained_tail(convs: dict, y: torch.Tensor, scale_factor: int,
                  conv=conv3x3_bias_act) -> torch.Tensor:
    """The reference tail: up conv(s) + pixel shuffle(s) + final conv (no
    clip). ``convs`` maps ``up0``/``up1``/``tail`` to (kernel, bias)."""
    def run(name, x):
        k, b = convs[name]
        return conv(x.contiguous(), k, b)

    if scale_factor in (2, 3):
        z = pixel_shuffle(run("up0", y), scale_factor)
    else:
        z = pixel_shuffle(run("up0", y), 2)
        z = pixel_shuffle(run("up1", z), 2)
    return run("tail", z)


def _interleaved_to_poly(img: torch.Tensor, s: int) -> torch.Tensor:
    """(N, s*H, s*W, C) -> (N, H, W, s^2*C), inverse of the DCR pixel
    shuffle."""
    n, hh, ww, c = img.shape
    h, w = hh // s, ww // s
    x = img.reshape(n, h, s, w, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, s * s * c)


def fused_tail_kernel(edsr):
    """Compose the linear tail into one conv over the body output, in
    polyphase space, by impulse probing the chained tail once on the CPU in
    float64. Returns (W_eff (k, k, f, s^2*c), b_eff (s^2*c,), pad), float32
    on the CPU."""
    s = edsr.scale_factor
    n_stages = 3 if s == 4 else 2
    k_eff = 2 * n_stages + 1
    pad = k_eff // 2
    convs = {n: (c.kernel.detach().cpu().double(), c.bias.detach().cpu().double())
             for n, c in edsr.tail_convs().items()}
    f = convs["up0"][0].shape[2]
    c_out = convs["tail"][0].shape[3]

    S = 4 * pad + 1
    p0 = S // 2
    imp = torch.zeros((f, S, S, f), dtype=torch.float64)
    imp[torch.arange(f), p0, p0, torch.arange(f)] = 1.0
    zero_bias = {n: (k, torch.zeros_like(b)) for n, (k, b) in convs.items()}
    resp = _chained_tail(zero_bias, imp, s, conv3x3_bias_act_plain)
    b_eff_img = _chained_tail(
        convs, torch.zeros((1, S, S, f), dtype=torch.float64), s,
        conv3x3_bias_act_plain)[0, s * p0: s * p0 + s, s * p0: s * p0 + s, :]
    b_eff = b_eff_img.reshape(s * s * c_out)            # o(E, F, c) order

    w = torch.zeros((k_eff, k_eff, f, s * s * c_out), dtype=torch.float64)
    for tr in range(k_eff):
        for tc in range(k_eff):
            pr = p0 + pad - tr
            pc = p0 + pad - tc
            blk = resp[:, s * pr: s * pr + s, s * pc: s * pc + s, :]
            w[tr, tc] = blk.reshape(f, s * s * c_out)
    return w.float(), b_eff.float(), pad


def fused_sr_stages(edsr, dtype=torch.float32) -> dict:
    """The fused forward's stages, bound to an ``EDSR`` module in ``dtype``
    (float32 or bfloat16), each a function of the previous stage's output
    so that each can be run alone on shared inputs:

    - ``head``: x -> the head conv (the first launch of ``body``);
    - ``body``: x -> head, residual blocks, body conv and skip (K2);
    - ``tail``: y -> the composed 7x7 conv (``F.conv2d``) + ``b_eff``;
    - ``borders``: (y, z) -> z with its ``pad``-cell border band replaced,
      in place, by the chained tail on the four slabs (K2);
    - ``clip``: z -> clamp to [0, 1].
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    s = edsr.scale_factor
    fp32_math()
    dev = edsr.head.kernel.device
    w_eff, b_eff, pad = fused_tail_kernel(edsr)
    w_eff = hwio_to_oihw(w_eff).contiguous().to(dev, dtype)
    b_eff = b_eff.to(dev, dtype)
    slab = 2 * pad + 1
    params = edsr.conv_params(dtype)
    tail = {n: params[n] for n in edsr.tail_convs()}

    def chained_poly(yslab):
        return _interleaved_to_poly(_chained_tail(tail, yslab, s), s)

    def head(x):
        return conv3x3_bias_act(x.to(dtype).contiguous(), *params["head"])

    def body(x):
        return edsr.body_out(x.to(dtype).contiguous(), params)

    def composed(y):
        z = F.conv2d(y.permute(0, 3, 1, 2), w_eff, padding=pad)
        return z.permute(0, 2, 3, 1) + b_eff

    def borders(y, z):
        # border-band correction: chained zero-padding semantics
        z[:, :pad] = chained_poly(y[:, :slab])[:, :pad]
        z[:, -pad:] = chained_poly(y[:, -slab:])[:, -pad:]
        z[:, :, :pad] = chained_poly(y[:, :, :slab])[:, :, :pad]
        z[:, :, -pad:] = chained_poly(y[:, :, -slab:])[:, :, -pad:]
        return z

    return {"head": head, "body": body, "tail": composed, "borders": borders,
            "clip": lambda z: z.clamp(0.0, 1.0)}


def make_fused_sr_apply(edsr, dtype=torch.float32):
    """Bind an ``EDSR`` module into a forward with the fused linear tail, in
    ``dtype`` (float32 or bfloat16).

    Returns (fn, s), s the model's scale factor: ``fn(x) -> y_poly`` of
    shape (N, H, W, s^2*channels) in ``dtype``, clipped to [0, 1], on the
    module's device; in float32 ``pixel_shuffle(y_poly, s)`` equals
    ``edsr(x)``, borders included. ``fn`` runs ``fused_sr_stages`` in turn.
    """
    st = fused_sr_stages(edsr, dtype)

    def fn(x):
        y = st["body"](x)
        return st["clip"](st["borders"](y, st["tail"](y)))

    return fn, edsr.scale_factor
