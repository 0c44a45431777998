"""EDSR fast forwards in polyphase layout (port of
``tpusr/models/edsr_fast.py``), in float32 or bfloat16: the composed tail
(``make_fused_sr_apply``, the serving path) and the uncomposed one
(``make_poly_sr_apply``).

The upsample tail (up conv(s), pixel shuffle(s), final conv) is linear, so it
collapses into one (k, k, f, s^2*channels) conv on the low-res grid, k = 7
for x4 (``fused_tail_kernel``). That composed conv covers the interior; a
``pad``-cell border band is recomputed with the chained tail on thin slabs,
whose zero paddings differ from the composed conv's. ``pixel_shuffle(fn(x),
s)`` equals ``EDSR.forward(x)``.

Every 3x3 conv (body, and ``up0``/``up1``/``tail`` on the slabs) runs through
K2, in the forward's dtype. The composed 7x7 conv is left to ``F.conv2d``
(float32 with TF32 off, or bfloat16), as the JAX package left it to XLA.

The uncomposed path (``polyphase_tail_kernel``, ``edsr_forward_poly``,
``make_poly_sr_apply``) refactors only the final tail conv to run before the
last pixel shuffle: the head, the residual blocks, the body and the up
convs run on K2, the refactored (3, 3, f*r^2, c*r^2) tail conv on
``F.conv2d`` (JAX leaves it to ``lax.conv``), and ``pixel_shuffle(fn(x),
r)`` is the SR image. ``dualize_conv_kernel``/``_conv_dual`` (a conv
emitting two horizontally adjacent pixels per output row) are kept as the
JAX package keeps them, as a building block.

In bfloat16 the fused forward follows the JAX package's bf16 branch: weights and
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
from tpusr_torch.models.edsr import conv3x3 as edsr_conv3x3
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


# ------------------------------------------- the uncomposed polyphase path
def polyphase_tail_kernel(w_tail, r: int) -> torch.Tensor:
    """Refactor a (3, 3, cin, cout) SAME-conv kernel that runs after a
    pixel-shuffle(r) into a (3, 3, cin*r^2, cout*r^2) kernel that runs
    before it (on the pre-shuffle tensor), on the CPU in ``w_tail``'s dtype.

    Channel orders follow the DCR pixel shuffle: pre-shuffle channel
    ch(e, f, c) = e*(r*cin) + f*cin + c; output channel o(e, f, c3) =
    e*(r*cout) + f*cout + c3, so ``pixel_shuffle(conv(z, W_poly), r)``
    equals ``conv(pixel_shuffle(z, r), w_tail)``.
    """
    w_tail = torch.as_tensor(w_tail).detach().cpu()
    kh, kw, cin, cout = w_tail.shape
    if (kh, kw) != (3, 3):
        raise ValueError("polyphase refactor written for 3x3 tails")
    w = torch.zeros((3, 3, cin * r * r, cout * r * r), dtype=w_tail.dtype)
    for e in range(r):
        for f in range(r):
            for dy in (-1, 0, 1):
                u, ep = divmod(e + dy, r)   # cell offset, source row-phase
                if not -1 <= u <= 1:
                    continue
                for dx in (-1, 0, 1):
                    v, fp = divmod(f + dx, r)
                    if not -1 <= v <= 1:
                        continue
                    src = ep * r * cin + fp * cin
                    dst = e * r * cout + f * cout
                    w[u + 1, v + 1, src: src + cin, dst: dst + cout] = \
                        w_tail[dy + 1, dx + 1]
    return w


def dualize_conv_kernel(k) -> torch.Tensor:
    """(3, 3, cin, cout) SAME-conv kernel -> (3, 4, cin, 2*cout) dual-pixel
    kernel computing two horizontally adjacent output pixels per output
    position: a stride-(1, 2) conv over the union window (input columns
    2j-1..2j+2, kernel width 4, padding (1, 2)). Exact: the extra taps are
    zero. The JAX package measured it a net loss inside the EDSR body and
    keeps it as a building block; so does the port."""
    k = torch.as_tensor(k)
    kh, kw, cin, cout = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError("dual-pixel refactor written for 3x3 kernels")
    k2 = torch.zeros((3, 4, cin, 2 * cout), dtype=k.dtype, device=k.device)
    k2[:, 0:3, :, :cout] = k     # even output pixel: window cols 0..2
    k2[:, 1:4, :, cout:] = k     # odd output pixel: window cols 1..3
    return k2


def _conv_dual(k2: torch.Tensor, b: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """Apply a ``dualize_conv_kernel`` kernel: x (N, H, W, cin) with W even
    -> (N, H, W, cout), numerically the SAME conv with the original kernel
    (``F.conv2d``, as JAX's ``lax.conv``)."""
    n, h, w, _ = x.shape
    cout = k2.shape[-1] // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 1))
    y = F.conv2d(xp, hwio_to_oihw(k2).to(x.dtype), stride=(1, 2))
    y = y.permute(0, 2, 3, 1) + torch.cat([b, b]).to(x.dtype)
    return y.reshape(n, h, w // 2, 2, cout).reshape(n, h, w, cout)


def edsr_forward_poly(edsr, x: torch.Tensor, params: dict | None = None,
                      poly_tail_kernel: torch.Tensor | None = None):
    """EDSR forward that returns the CLIPPED polyphase output (N, H*s/r,
    W*s/r, r^2*channels), r the final shuffle factor (2 for x2/x4, 3 for
    x3), in x's dtype; ``pixel_shuffle(result, r)`` is ``edsr(x)``.

    ``params``: ``edsr.conv_params(x.dtype)`` (default: the module's own);
    ``poly_tail_kernel``: a precomputed ``polyphase_tail_kernel`` on x's
    device in x's dtype (default: built from the tail's kernel per call).
    Returns (y_poly, r).
    """
    if params is None:
        params = edsr.conv_params(x.dtype)
    s = edsr.scale_factor
    y = edsr.body_out(x.contiguous(), params)
    # ``edsr.conv3x3``, as ``body_out`` runs its convs: K2 (and the hooks
    # that hold each K2 launch against its twin see these launches too)
    if s in (2, 3):
        r = s
        z = edsr_conv3x3(y, *params["up0"])               # (N, H, W, f*r^2)
    else:   # x4: the first x2 interleaved, the second kept polyphase
        r = 2
        z = pixel_shuffle(edsr_conv3x3(y, *params["up0"]), 2)
        z = edsr_conv3x3(z, *params["up1"])               # (N, 2H, 2W, f*4)
    w_tail, b_tail = params["tail"]
    if poly_tail_kernel is None:
        poly_tail_kernel = polyphase_tail_kernel(w_tail.float(), r).to(
            z.device, z.dtype)
    zp = F.conv2d(z.permute(0, 3, 1, 2), hwio_to_oihw(poly_tail_kernel),
                  padding=1).permute(0, 2, 3, 1)
    zp = zp + b_tail.to(zp.dtype).repeat(r * r)
    return zp.clamp(0.0, 1.0), r


def make_poly_sr_apply(edsr, dtype=torch.bfloat16):
    """Bind an ``EDSR`` module into the uncomposed polyphase forward in
    ``dtype`` (float32 or bfloat16; bfloat16 by default, as in JAX).

    Returns (fn, r): ``fn(x) -> y_poly`` with ``pixel_shuffle(y_poly, r)``
    the SR image. The refactored tail kernel is built once, in float32 on
    the CPU, then cast to ``dtype`` on the module's device.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    fp32_math()
    r = edsr.scale_factor if edsr.scale_factor in (2, 3) else 2
    dev = edsr.head.kernel.device
    wp = polyphase_tail_kernel(edsr.tail.kernel.float(), r).to(dev, dtype)
    params = edsr.conv_params(dtype)

    def fn(x):
        return edsr_forward_poly(edsr, x.to(dtype), params, wp)[0]

    return fn, r
