"""3x3 SAME convolutions with fused epilogues: K1, K2 and the int8 EDSR's
dequant conv.

- ``conv3x3_int8_requant`` (K1) replaces the Pallas kernel
  ``tpusr/core/pallas_conv.py::conv3x3_int8_requant``: int8 x int8 -> int32,
  then ``clip(acc * rescale + bias_over_out, 0, 127)`` and a truncating int8
  cast. It runs every conv of the int8 VGG16 backbone.
- ``conv3x3_bias_act`` (K2) replaces ``pallas_conv.py::conv3x3_bias_act``:
  float32 or bfloat16 x and kernel, float32 bias, fp32 accumulation, + bias
  and optional ReLU in fp32, one cast to x's dtype. It runs every 3x3 conv of
  the EDSR forward, f32 and bf16; each dtype is its own kernel with its own
  launch count (``csrc/conv3x3_bias_act.cu``: bf16 on the tensor cores, f32
  on an FFMA register-tiled GEMM, picked among their tiles by shape alone).
- ``conv3x3_bias_act_train`` is K2 under autograd (``Conv3x3BiasActFn``):
  the forward is K2, and so is the input gradient, a 3x3 SAME conv of the
  output gradient with the flipped, transposed kernel, both in the
  forward's dtype (K2-f32 or K2-bf16). It runs every 3x3 conv of the EDSR
  and ESRGAN-generator training forwards and backwards; serving never
  enters it.
- ``conv3x3_int8_dequant`` has no Pallas counterpart: it replaces the XLA
  int8 conv + dequant of the int8 EDSR (``tpusr/models/edsr_quant.py::
  _qconv``): int8 x int8 -> int32, then ``acc * rescale + bias`` in f32 and
  one cast to bf16. PyTorch has no int8 conv on CUDA.

All take the JAX package's layouts: x (N, H, W, Cin) NHWC and kernels
(3, 3, Cin, Cout) HWIO. Each wrapper launches its hand-written CUDA kernel
(K1 and the dequant conv in ``csrc/conv3x3.cu``, on the int8 tensor cores)
for a CUDA tensor and calls its plain PyTorch twin for a CPU tensor; there
is no other dispatch. ``LAUNCHES`` counts kernel launches, one per call that
reached the kernel.

The two int8 kernels read their weights K-major, packed once by
``pack_int8_kernel``; the int8 trees keep the packed copy beside
``kernel_q`` (``kernel_packed``) and the paths pass it. A call without it
packs for itself.
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


PACK_K_ALIGN, PACK_N_ALIGN = 128, 64   # csrc/conv3x3.cu: K_ALIGN, BN


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_int8_kernel(w_q: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO int8 -> the K-major operand of K1 and the
    dequant conv: (Cout_p, K_p) int8, row co = ``w_q[..., co]`` flattened
    in (ky, kx, ci) order (k = (ky*3 + kx)*Cin + ci), zero-padded to
    Cout_p = Cout rounded up to 64 and K_p = 9*Cin rounded up to 128."""
    cin, cout = w_q.shape[2], w_q.shape[3]
    packed = torch.zeros((_round_up(cout, PACK_N_ALIGN),
                          _round_up(9 * cin, PACK_K_ALIGN)),
                         dtype=w_q.dtype, device=w_q.device)
    packed[:cout, :9 * cin] = w_q.permute(3, 0, 1, 2).reshape(cout, 9 * cin)
    return packed


def unpack_int8_kernel(packed: torch.Tensor, cin: int,
                       cout: int) -> torch.Tensor:
    """The inverse of ``pack_int8_kernel``: (3, 3, Cin, Cout) HWIO."""
    return packed[:cout, :9 * cin].reshape(cout, 3, 3, cin).permute(1, 2, 3, 0)


def conv3x3_int8_requant_plain(x, w_q, rescale, bias_over_out):
    """The plain twin of K1: an exact int8 conv via float64 ``F.conv2d``
    (|acc| <= 9*512*127^2 < 2^53), then the requant of quant.py:112-115 in
    float32, one rounding per operation."""
    acc = F.conv2d(_nchw(x).double(), hwio_to_oihw(w_q).double(), padding=1)
    y = _nhwc(acc).to(torch.int32).float() * rescale + bias_over_out
    return y.clamp(0.0, 127.0).to(torch.int8)


def _int8_gemm_conv(name, plain, x, w_q, rescale, bias, w_packed,
                    out_dtype):
    """One int8 instance of the template (K1 or the dequant): its plain twin
    for a CPU tensor (on the weights unpacked from ``w_packed`` when it is
    given), its kernel for a CUDA tensor."""
    cout = _check_args(name, x, w_q, (rescale, bias), torch.int8, torch.int8)
    cin = x.shape[-1]
    if w_packed is not None:
        want = (_round_up(cout, PACK_N_ALIGN), _round_up(9 * cin, PACK_K_ALIGN))
        if (tuple(w_packed.shape) != want or w_packed.dtype != torch.int8
                or w_packed.device != x.device):
            raise ValueError(
                f"{name}: packed weights must be int8 {want} on {x.device} "
                f"(pack_int8_kernel), got {w_packed.dtype} "
                f"{tuple(w_packed.shape)} on {w_packed.device}")
    if x.device.type == "cpu":
        if w_packed is not None:
            w_q = unpack_int8_kernel(w_packed, cin, cout)
        return plain(x, w_q, rescale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if w_packed is None:
        w_packed = pack_int8_kernel(w_q)
    _check_cuda(name, x, w_packed, rescale, bias)
    n, h, w, _ = x.shape
    if max(x.numel(), n * h * w * cout) >= 2 ** 31:
        raise ValueError(f"{name}: x and the output must hold < 2^31 elements "
                         f"(the kernel's offsets are 32-bit)")
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv3x3")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("conv3x3", getattr(lib, f"{name}_launch")(
        x.data_ptr(), w_packed.data_ptr(), rescale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), n, h, w, cin, cout, stream))
    _count_launch(name)
    return y


def conv3x3_int8_requant(x, w_q, rescale, bias_over_out, w_packed=None):
    """3x3 SAME int8 conv + fused requantization (K1).

    x: (N, H, W, Cin) int8; w_q: (3, 3, Cin, Cout) int8; rescale and
    bias_over_out: (Cout,) float32 (the bias carries quant.py's +0.5 fold);
    w_packed: ``pack_int8_kernel(w_q)``, made here when not given.
    Returns (N, H, W, Cout) int8.
    """
    return _int8_gemm_conv("conv3x3_int8_requant", conv3x3_int8_requant_plain,
                           x, w_q, rescale, bias_over_out, w_packed,
                           torch.int8)


def conv3x3_int8_dequant_plain(x, w_q, rescale, bias):
    """The plain twin of the dequant conv: an exact int8 conv via float64
    ``F.conv2d``, then ``acc * rescale + bias`` in float32, one rounding per
    operation, and one cast to bf16 (edsr_quant.py:141-143)."""
    acc = F.conv2d(_nchw(x).double(), hwio_to_oihw(w_q).double(), padding=1)
    y = _nhwc(acc).to(torch.int32).float() * rescale + bias
    return y.to(torch.bfloat16)


def conv3x3_int8_dequant(x, w_q, rescale, bias, w_packed=None):
    """3x3 SAME int8 conv + fused dequantization to bf16.

    x: (N, H, W, Cin) int8; w_q: (3, 3, Cin, Cout) int8; rescale (the input
    scale times the per-channel weight scale) and bias: (Cout,) float32;
    w_packed: ``pack_int8_kernel(w_q)``, made here when not given.
    Returns (N, H, W, Cout) bfloat16.
    """
    return _int8_gemm_conv("conv3x3_int8_dequant", conv3x3_int8_dequant_plain,
                           x, w_q, rescale, bias, w_packed, torch.bfloat16)


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
    dtype; bias: (Cout,) float32. Accumulates in fp32 (f32: fp32 FMAs over k
    in order; bf16: the tensor cores' fp32 sums of the exact products), adds
    the bias (and takes the ReLU) in fp32 and returns x's dtype, rounded
    once. Each output's sum runs in one order whatever the batch around it.
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
    if max(x.numel(), n * h * w * cout) >= 2 ** 31:
        raise ValueError(f"{name}: x and the output must hold < 2^31 elements "
                         f"(the kernel's offsets are 32-bit)")
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv3x3_bias_act")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = getattr(lib, f"conv3x3_bias_act_{tag}_launch")
    _build.check("conv3x3_bias_act", launch(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
        n, h, w, cin, cout, int(relu), stream))
    _count_launch(name)
    return y


class Conv3x3BiasActFn(torch.autograd.Function):
    """K2 with a backward, for training in float32 or bfloat16.

    Forward: ``conv3x3_bias_act`` (K2-f32 or K2-bf16 on a card, by x's
    dtype; the plain twin on the CPU). Backward, from the saved output
    ``y``: the ReLU mask ``y > 0`` (the gradient at 0 is 0, as
    ``jax.nn.relu``'s), taken on ``y`` in its own dtype; dX = K2 in x's
    dtype on the mask times dY with the kernel flipped in both spatial dims
    and transposed in its channel dims, zero bias, no ReLU (exact for a
    stride-1 SAME 3x3 conv), only when x needs a gradient; dW =
    ``torch.nn.grad.conv2d_weight`` in the kernel's dtype (cuDNN on a card;
    JAX computes it in XLA, outside any Pallas kernel); db = the sum over N,
    H and W in fp32. Each gradient has its input's dtype.
    """

    @staticmethod
    def forward(ctx, x, kernel, bias, relu: bool):
        y = conv3x3_bias_act(x.contiguous(), kernel, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, kernel, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, y = ctx.saved_tensors
        dy = dy.to(x.dtype)
        if ctx.relu:
            dy = torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                                    device=dy.device))
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            k_t = kernel.flip(0, 1).transpose(2, 3).contiguous()
            dx = conv3x3_bias_act(dy, k_t, torch.zeros(
                kernel.shape[2], dtype=torch.float32, device=kernel.device))
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                _nchw(x), (kernel.shape[3], kernel.shape[2], 3, 3), _nchw(dy),
                padding=1).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 1, 2), dtype=torch.float32)
        return dx, dw, db, None


def conv3x3_bias_act_train(x, kernel, bias, relu: bool = False):
    """``conv3x3_bias_act`` (float32 or bfloat16 x and kernel, float32
    bias) with a gradient for x, kernel and bias (``Conv3x3BiasActFn``): two
    K2 launches of x's dtype a call on a card, one forward and one for dX,
    the second skipped when x needs no gradient."""
    if x.dtype not in _K2_INSTANCES:
        raise TypeError(f"conv3x3_bias_act_train: float32 or bfloat16, got "
                        f"{x.dtype}")
    return Conv3x3BiasActFn.apply(x, kernel, bias, relu)
