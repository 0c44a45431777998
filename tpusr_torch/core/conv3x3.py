"""3x3 SAME convolutions with fused epilogues: K1, K2 and the int8 EDSR's
dequant conv.

- ``conv3x3_int8_requant`` (K1) replaces the Pallas kernel
  ``tpusr/core/pallas_conv.py::conv3x3_int8_requant``: int8 x int8 -> int32,
  then ``clip(acc * rescale + bias_over_out, 0, 127)`` and a truncating int8
  cast. It runs every conv of the int8 VGG16 backbone.
- ``conv3x3_bias_act`` (K2) replaces ``pallas_conv.py::conv3x3_bias_act``:
  float32 or bfloat16 x and kernel, float32 bias, fp32 accumulation, + bias
  and optional ReLU in fp32, one cast to x's dtype. It runs every 3x3 conv of
  the EDSR forward, f32 and bf16; each dtype is its own kernel instance with
  its own launch count.
- ``conv3x3_int8_dequant`` has no Pallas counterpart: it replaces the XLA
  int8 conv + dequant of the int8 EDSR (``tpusr/models/edsr_quant.py::
  _qconv``): int8 x int8 -> int32, then ``acc * rescale + bias`` in f32 and
  one cast to bf16. PyTorch has no int8 conv on CUDA.

All take the JAX package's layouts: x (N, H, W, Cin) NHWC and kernels
(3, 3, Cin, Cout) HWIO. Each wrapper launches the hand-written CUDA kernel of
``csrc/conv3x3.cu`` for a CUDA tensor and calls its plain PyTorch twin for a
CPU tensor; there is no other dispatch. ``LAUNCHES`` counts kernel launches,
one per call that reached the kernel.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from tpusr_torch.bridge import hwio_to_oihw
from tpusr_torch.core import _build

LAUNCHES = {"conv3x3_int8_requant": 0, "conv3x3_bias_act": 0,
            "conv3x3_bias_act_bf16": 0, "conv3x3_int8_dequant": 0}
_launch_lock = threading.Lock()   # a server's worker thread launches too


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def _check_args(name, x, kernel, vecs, x_dtype, k_dtype):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (N, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: kernel must be (3, 3, {cin}, Cout), got "
                         f"{tuple(kernel.shape)}")
    cout = kernel.shape[-1]
    if x.dtype != x_dtype or kernel.dtype != k_dtype:
        raise TypeError(f"{name}: expected x {x_dtype} and kernel {k_dtype}, "
                        f"got {x.dtype} and {kernel.dtype}")
    for v in vecs:
        if tuple(v.shape) != (cout,) or v.dtype != torch.float32:
            raise ValueError(f"{name}: per-channel vectors must be float32 "
                             f"({cout},), got {v.dtype} {tuple(v.shape)}")
    devices = {t.device for t in (x, kernel, *vecs)}
    if len(devices) != 1:
        raise ValueError(f"{name}: all operands must be on one device, got "
                         f"{sorted(map(str, devices))}")
    return cout


def _check_cuda(name, *tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def conv3x3_int8_requant_plain(x, w_q, rescale, bias_over_out):
    """The plain twin of K1: an exact int8 conv via float64 ``F.conv2d``
    (|acc| <= 9*512*127^2 < 2^53), then the requant of quant.py:112-115 in
    float32, one rounding per operation."""
    acc = F.conv2d(_nchw(x).double(), hwio_to_oihw(w_q).double(), padding=1)
    y = _nhwc(acc).to(torch.int32).float() * rescale + bias_over_out
    return y.clamp(0.0, 127.0).to(torch.int8)


def _int8_gemm_conv(name, plain, x, w_q, rescale, bias, out_dtype):
    """One int8 instance of the template (K1 or the dequant): its plain twin
    for a CPU tensor, its kernel for a CUDA tensor."""
    cout = _check_args(name, x, w_q, (rescale, bias), torch.int8, torch.int8)
    if x.device.type == "cpu":
        return plain(x, w_q, rescale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda(name, x, w_q, rescale, bias)
    n, h, w, cin = x.shape
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv3x3")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("conv3x3", getattr(lib, f"{name}_launch")(
        x.data_ptr(), w_q.data_ptr(), rescale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), n, h, w, cin, cout, stream))
    _count_launch(name)
    return y


def conv3x3_int8_requant(x, w_q, rescale, bias_over_out):
    """3x3 SAME int8 conv + fused requantization (K1).

    x: (N, H, W, Cin) int8; w_q: (3, 3, Cin, Cout) int8; rescale and
    bias_over_out: (Cout,) float32 (the bias carries quant.py's +0.5 fold).
    Returns (N, H, W, Cout) int8.
    """
    return _int8_gemm_conv("conv3x3_int8_requant", conv3x3_int8_requant_plain,
                           x, w_q, rescale, bias_over_out, torch.int8)


def conv3x3_int8_dequant_plain(x, w_q, rescale, bias):
    """The plain twin of the dequant conv: an exact int8 conv via float64
    ``F.conv2d``, then ``acc * rescale + bias`` in float32, one rounding per
    operation, and one cast to bf16 (edsr_quant.py:141-143)."""
    acc = F.conv2d(_nchw(x).double(), hwio_to_oihw(w_q).double(), padding=1)
    y = _nhwc(acc).to(torch.int32).float() * rescale + bias
    return y.to(torch.bfloat16)


def conv3x3_int8_dequant(x, w_q, rescale, bias):
    """3x3 SAME int8 conv + fused dequantization to bf16.

    x: (N, H, W, Cin) int8; w_q: (3, 3, Cin, Cout) int8; rescale (the input
    scale times the per-channel weight scale) and bias: (Cout,) float32.
    Returns (N, H, W, Cout) bfloat16.
    """
    return _int8_gemm_conv("conv3x3_int8_dequant", conv3x3_int8_dequant_plain,
                           x, w_q, rescale, bias, torch.bfloat16)


def conv3x3_bias_act_plain(x, kernel, bias, relu: bool = False):
    """The plain twin of K2: ``F.conv2d`` + bias (+ ReLU) in x's float dtype,
    except that bf16 x and kernel are convolved in fp32 (on their exact
    values), with bias and ReLU in fp32 and one cast back to bf16, as K2's
    bf16 contract has it. The caller turns TF32 off
    (``tpusr_torch.device``)."""
    out_dtype = x.dtype
    if out_dtype == torch.bfloat16:
        x, kernel = x.float(), kernel.float()
    y = _nhwc(F.conv2d(_nchw(x), hwio_to_oihw(kernel), padding=1)) + bias
    y = torch.relu(y) if relu else y
    return y.to(out_dtype)


_K2_INSTANCES = {torch.float32: ("conv3x3_bias_act", "f32"),
                 torch.bfloat16: ("conv3x3_bias_act_bf16", "bf16")}


def conv3x3_bias_act(x, kernel, bias, relu: bool = False):
    """3x3 SAME float conv + bias (+ ReLU) (K2).

    x: (N, H, W, Cin) float32 or bfloat16; kernel: (3, 3, Cin, Cout) of x's
    dtype; bias: (Cout,) float32. Accumulates in fp32 with plain FMAs, adds
    the bias (and takes the ReLU) in fp32 and returns x's dtype, rounded
    once.
    """
    # any other dtype is refused by _check_args as not float32
    dtype = x.dtype if x.dtype in _K2_INSTANCES else torch.float32
    name, tag = _K2_INSTANCES[dtype]
    cout = _check_args(name, x, kernel, (bias,), dtype, dtype)
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, kernel, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda(name, x, kernel, bias)
    n, h, w, cin = x.shape
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv3x3")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = getattr(lib, f"conv3x3_bias_act_{tag}_launch")
    _build.check("conv3x3", launch(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
        n, h, w, cin, cout, int(relu), stream))
    _count_launch(name)
    return y
