"""Post-training int8 EDSR for the SR stage (port of
``tpusr/models/edsr_quant.py``).

The design is the JAX package's mixed-precision trunk:
- the running activation stays bf16 end to end (residual adds, the 0.1
  scaling and the global skip are bf16 operations, each rounded);
- each 3x3 conv quantizes its input on the fly (per-tensor symmetric scale,
  max-abs calibrated on the f32 forward), runs int8 x int8 -> int32 and
  dequantizes with one per-channel f32 rescale + bias to bf16;
- the composed 7x7 linear tail (``edsr_fast.fused_tail_kernel``) is quantized
  the same way and dequantized to f32;
- the thin border-band slabs run the chained tail in bf16.

Where the JAX package leaves the int8 convs to XLA, the port runs them as:
- the 3x3 convs (head, residual blocks, body): ``conv3x3_int8_dequant``, a
  hand-written CUDA instance of the ``conv3x3.cu`` template (PyTorch has no
  int8 conv on CUDA); with ``int8_carry`` each block's conv1 is K1 itself,
  its ``rescale_carry``/``bias_carry`` being K1's requant epilogue;
- the composed 7x7 tail: ``torch._int_mm`` over an im2col of the 49 shifted
  views of the zero-padded int8 tensor (exact int32), then the f32 dequant;
  its plain twin ``tail_conv_int8_plain`` is a float64 conv, exact too;
- the border slabs: K2's bf16 instance. It rounds once after an fp32 bias
  add where JAX's bf16 conv rounds the conv and then adds a bf16 bias, so
  the band differs from JAX's by design; the interior is exact.

Every f32 step rounds as ``edsr_quant.py`` is written, one operation at a
time (no FMA contraction), so on the same tree the port's interior SR equals
the JAX forward run op by op.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.bridge import hwio_to_oihw
from tpusr_torch.core.conv3x3 import (conv3x3_bias_act, conv3x3_int8_dequant,
                                      conv3x3_int8_requant)
from tpusr_torch.models.edsr_fast import (_chained_tail, _interleaved_to_poly,
                                          fused_tail_kernel)
from tpusr_torch.models.quant import f32


def _maxabs(x: torch.Tensor) -> float:
    return float(x.abs().max())


def _model_device(edsr) -> torch.device:
    return edsr.head.kernel.device


def calibrate_edsr(edsr, sample_lr) -> dict:
    """Run the f32 forward of ``edsr`` on a calibration batch and record every
    conv INPUT's symmetric int8 scale (max-abs / 127). Keys: 'head',
    'res{i}_conv1', 'res{i}_conv2', 'body', 'tail'."""
    x = torch.as_tensor(np.asarray(sample_lr, np.float32)
                        if not torch.is_tensor(sample_lr) else sample_lr,
                        dtype=torch.float32, device=_model_device(edsr))
    params = edsr.conv_params()

    def conv(name, t, relu=False):
        k, b = params[name]
        return conv3x3_bias_act(t.contiguous(), k, b, relu)

    with torch.inference_mode():
        scales = {"head": max(_maxabs(x) / 127.0, 1e-8)}
        head = y = conv("head", x)
        for i in range(edsr.num_res_blocks):
            scales[f"res{i}_conv1"] = max(_maxabs(y) / 127.0, 1e-8)
            t = conv(f"res{i}.conv1", y, relu=True)
            scales[f"res{i}_conv2"] = max(_maxabs(t) / 127.0, 1e-8)
            y = y + edsr.res_scaling * conv(f"res{i}.conv2", t)
        scales["body"] = max(_maxabs(y) / 127.0, 1e-8)
        y = conv("body", y) + head
        scales["tail"] = max(_maxabs(y) / 127.0, 1e-8)
    return scales


def _quantize_kernel(k: torch.Tensor):
    """(kh, kw, cin, cout) f32 -> (int8 kernel, per-cout f32 weight scale)."""
    w_scale = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
    return torch.round(k / w_scale).clamp(-127, 127).to(torch.int8), w_scale


def quantize_edsr(edsr, act_scales: dict) -> dict:
    """Per-output-channel int8 kernels and the fused rescale vectors of the
    head, residual-block, body and composed-tail convs, the same tree as
    ``tpusr.models.edsr_quant.quantize_edsr`` (``bridge.edsr_qtree_from_flax``
    converts one of those). Computed on the CPU in float32, then placed on the
    model's device."""
    cpu = torch.device("cpu")
    w_eff, b_eff, pad = fused_tail_kernel(edsr)
    q = {"layers": {}, "pad": pad, "act_scales": dict(act_scales),
         "n_res": edsr.num_res_blocks}

    def add(name, kernel, bias):
        kq, ws = _quantize_kernel(kernel.detach().cpu().float())
        s_in = act_scales[name]
        q["layers"][name] = {"kernel_q": kq.contiguous(),
                             "rescale": f32(s_in, cpu) * ws,
                             "bias": bias.detach().cpu().float().clone(),
                             "inv_s_in": f32(1.0 / s_in, cpu)}

    add("head", edsr.head.kernel, edsr.head.bias)
    for i in range(edsr.num_res_blocks):
        blk = getattr(edsr, f"res{i}")
        add(f"res{i}_conv1", blk.conv1.kernel, blk.conv1.bias)
        add(f"res{i}_conv2", blk.conv2.kernel, blk.conv2.bias)
        # int8 carry (edsr_quant.py:101-110): conv1's accumulator rescaled
        # straight to conv2's int8 input grid; clip(., 0, 127) is the ReLU
        # and the +0.5 makes K1's truncating cast round half up
        l1 = q["layers"][f"res{i}_conv1"]
        s_in2 = f32(act_scales[f"res{i}_conv2"], cpu)
        l1["rescale_carry"] = l1["rescale"] / s_in2
        l1["bias_carry"] = l1["bias"] / s_in2 + 0.5
    add("body", edsr.body.kernel, edsr.body.bias)
    add("tail", w_eff, b_eff)
    dev = _model_device(edsr)
    q["layers"] = {name: {k: v.to(dev) for k, v in layer.items()}
                   for name, layer in q["layers"].items()}
    return q


def _quantize_in(layer: dict, x: torch.Tensor) -> torch.Tensor:
    """A conv's input on its int8 grid: round(x * inv_s_in), clipped."""
    x = torch.round(x.float() * layer["inv_s_in"]).clamp(-127, 127)
    return x.to(torch.int8).contiguous()


def _dequant(layer: dict, acc: torch.Tensor, out_dtype=torch.bfloat16):
    """int32 accumulator -> ``acc * rescale + bias`` in f32 (two roundings),
    cast to ``out_dtype``."""
    return (acc.float() * layer["rescale"] + layer["bias"]).to(out_dtype)


def _qconv(layer: dict, x: torch.Tensor) -> torch.Tensor:
    """Quantize the input, int8 3x3 conv, dequant to bf16, in one launch of
    ``conv3x3_int8_dequant`` after the quantization."""
    return conv3x3_int8_dequant(_quantize_in(layer, x), layer["kernel_q"],
                                layer["rescale"], layer["bias"])


def _qconv_int8_out(layer: dict, x8: torch.Tensor) -> torch.Tensor:
    """int8 input -> int8 conv -> ReLU + requant to the next conv's grid,
    fused into one rescale: K1 with ``rescale_carry``/``bias_carry``."""
    return conv3x3_int8_requant(x8, layer["kernel_q"], layer["rescale_carry"],
                                layer["bias_carry"])


def tail_conv_int8(x8: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """k x k SAME int8 conv -> exact int32, as one ``torch._int_mm`` over an
    im2col of the k^2 shifted views of the zero-padded input (K = k^2 * Cin,
    taps in HWIO order). x8: (N, H, W, Cin) int8; kq: (k, k, Cin, Cout)
    int8."""
    n, h, w, cin = x8.shape
    k, cout = kq.shape[0], kq.shape[-1]
    p = k // 2
    xp = F.pad(x8, (0, 0, p, p, p, p))
    cols = torch.cat([xp[:, ty:ty + h, tx:tx + w] for ty in range(k)
                      for tx in range(k)], dim=-1)
    acc = torch._int_mm(cols.reshape(n * h * w, k * k * cin),
                        kq.reshape(k * k * cin, cout))
    return acc.reshape(n, h, w, cout)


def tail_conv_int8_plain(x8: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``tail_conv_int8``: a float64 conv, exact for the
    EDSR tail (|acc| <= 7*7*64*127^2 < 2^53)."""
    acc = F.conv2d(x8.permute(0, 3, 1, 2).double(), hwio_to_oihw(kq).double(),
                   padding=kq.shape[0] // 2)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def make_fused_sr_apply_int8(edsr, sample_lr=None, act_scales: dict | None = None,
                             border_correction: bool = True,
                             int8_carry: bool = False, qtree: dict | None = None):
    """int8 twin of ``edsr_fast.make_fused_sr_apply``: the same fused-tail
    polyphase forward with every conv int8 and a bf16 trunk.

    Returns (fn, s): ``fn(x) -> y_poly`` float32, clipped to [0, 1];
    ``pixel_shuffle(y_poly, s)`` is the SR image. The int8 tree comes from
    ``qtree`` (``quantize_edsr`` or ``bridge.edsr_qtree_from_flax``), else
    from ``act_scales`` (``calibrate_edsr``), else from calibrating on the
    ``sample_lr`` batch.

    ``border_correction=False`` skips the chained-tail border band: the
    composed conv's zero padding then stands within ``pad`` cells of each
    image border. ``int8_carry=True`` keeps each residual block's conv1 ->
    conv2 handoff in int8 (conv1 on K1 with the carry rescale).
    """
    s = edsr.scale_factor
    if qtree is None:
        if act_scales is None:
            if sample_lr is None:
                raise ValueError("need act_scales or a sample_lr calibration "
                                 "batch")
            act_scales = calibrate_edsr(edsr, sample_lr)
        qtree = quantize_edsr(edsr, act_scales)
    layers, pad = qtree["layers"], qtree["pad"]
    slab = 2 * pad + 1
    dev = _model_device(edsr)
    res_scaling = torch.tensor(edsr.res_scaling, dtype=torch.bfloat16, device=dev)
    params = edsr.conv_params(torch.bfloat16) if border_correction else {}
    tail = {n: params[n] for n in edsr.tail_convs()} if border_correction else {}

    def body_out(x):
        head = y = _qconv(layers["head"], x)
        for i in range(qtree["n_res"]):
            l1, l2 = layers[f"res{i}_conv1"], layers[f"res{i}_conv2"]
            if int8_carry:
                t8 = _qconv_int8_out(l1, _quantize_in(l1, y))
                t = conv3x3_int8_dequant(t8, l2["kernel_q"], l2["rescale"],
                                         l2["bias"])
            else:
                t = _qconv(l2, torch.relu(_qconv(l1, y)))
            y = y + res_scaling * t          # bf16(0.1) * t, then the add
        return _qconv(layers["body"], y) + head

    def chained_poly(yslab):
        return _interleaved_to_poly(_chained_tail(tail, yslab, s), s)

    def fn(x):
        y = body_out(x.float().contiguous())
        lt = layers["tail"]
        z = _dequant(lt, tail_conv_int8(_quantize_in(lt, y), lt["kernel_q"]),
                     torch.float32)
        if border_correction:
            # border-band correction: chained zero-padding semantics (bf16)
            z[:, :pad] = chained_poly(y[:, :slab])[:, :pad].float()
            z[:, -pad:] = chained_poly(y[:, -slab:])[:, -pad:].float()
            z[:, :, :pad] = chained_poly(y[:, :, :slab])[:, :, :pad].float()
            z[:, :, -pad:] = chained_poly(y[:, :, -slab:])[:, :, -pad:].float()
        return z.clamp(0.0, 1.0)

    return fn, s
