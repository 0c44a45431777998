"""Winograd F(2x2, 3x3) convolution (port of ``tpusr/core/winograd.py``).

F(2,3) computes each 2x2 output tile from a 4x4 input tile with 16
multiplies per channel pair instead of 36:

    Y = A^T [ (G g G^T) .* (B^T d B) ] A

with B and A in {0, +-1} (the input transform is exact in integers) and G
in {0, +-1, +-1/2} (the weight transform is done once in float32).

- ``winograd_conv``: the transforms and one 16-way batched GEMM
  (``torch.bmm``) on float32 or bfloat16-rounded operands, summed in
  float32 (JAX's ``preferred_element_type``);
- ``winograd_conv_int8``: the int32 input transform of an int8 tensor
  (|u| <= 4*127), requantised by ``_requant_u4`` (u/4, rounded half away
  from zero), int8 GEMMs with int32 sums (``torch._int_mm``), one float32
  rescale per (position, output channel) before the output transform.

Activations are NHWC and kernels HWIO, as in the JAX package. These products
are library GEMMs: JAX computes them with ``dot_general`` outside any Pallas
kernel. Nothing in the serving path calls this module; the JAX package keeps
it as the measured record that it loses on the TPU, and ``chip_smoke.py``
times it against ``F.conv2d`` on the H100 for the same record.
"""

from __future__ import annotations

import numpy as np
import torch

# F(2x2, 3x3) transform matrices
_BT = np.asarray([[1, 0, -1, 0],
                  [0, 1, 1, 0],
                  [0, -1, 1, 0],
                  [0, 1, 0, -1]], np.float32)
_G = np.asarray([[1, 0, 0],
                 [0.5, 0.5, 0.5],
                 [0.5, -0.5, 0.5],
                 [0, 0, 1]], np.float32)
_AT = np.asarray([[1, 1, 1, 0],
                  [0, 1, -1, -1]], np.float32)


def transform_weights(kernel) -> torch.Tensor:
    """(3, 3, K, N) -> (16, K, N): G g G^T per channel pair, float32."""
    g = torch.as_tensor(kernel).float()
    G = torch.from_numpy(_G).to(g.device)
    t = torch.einsum("ai,ijkn,bj->abkn", G, g, G)
    return t.reshape(16, *t.shape[2:])


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(
            f"winograd F(2,3): H and W must be even (2x2 output tiles), "
            f"got {(h, w)}")


def _tiles(x: torch.Tensor) -> list[list[torch.Tensor]]:
    """x (B, H, W, C), zero-padded by one -> d[i][j] (B, H/2, W/2, C), the
    (i, j) element of every 4x4 tile at stride 2."""
    _, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return [[xp[:, i: i + h: 2, j: j + w: 2] for j in range(4)]
            for i in range(4)]


def _input_transform(d, dtype) -> list[torch.Tensor]:
    """B^T d B with {0, +-1} coefficients as explicit sums, in JAX's
    order: 16 tensors (B, H/2, W/2, C)."""
    bt = _BT.astype(np.int32)
    u = []
    for a in range(4):
        for b4 in range(4):
            acc = None
            for i in range(4):
                if bt[a, i] == 0:
                    continue
                inner = None
                for j in range(4):
                    if bt[b4, j] == 0:
                        continue
                    term = d[i][j].to(dtype)
                    term = term if bt[b4, j] > 0 else -term
                    inner = term if inner is None else inner + term
                inner = inner if bt[a, i] > 0 else -inner
                acc = inner if acc is None else acc + inner
            u.append(acc)
    return u


def _output_assemble(f: torch.Tensor, b: int, th: int, tw: int,
                     n: int) -> torch.Tensor:
    """A^T F A: (16, B*th*tw, N) float32 -> (B, 2*th, 2*tw, N)."""
    at = torch.from_numpy(_AT).to(f.device)
    fm = f.reshape(4, 4, b, th, tw, n)
    y = torch.einsum("ea,abxtwn,fb->xtwefn", at, fm, at)
    y = y.permute(0, 1, 3, 2, 4, 5)       # (B, th, e, tw, f, N)
    return y.reshape(b, 2 * th, 2 * tw, n)


def winograd_conv(x: torch.Tensor, kernel: torch.Tensor,
                  gemm_dtype=torch.float32) -> torch.Tensor:
    """SAME 3x3 conv via F(2x2, 3x3); x (B, H, W, K) with even H, W, the
    GEMM operands in ``gemm_dtype`` (float32 or bfloat16), sums in float32.
    Returns float32 (B, H, W, N)."""
    b, h, w, k = x.shape
    _check_even(h, w)
    n = kernel.shape[-1]
    th, tw = h // 2, w // 2
    u = _input_transform(_tiles(x), gemm_dtype)
    U = torch.stack([t.reshape(b * th * tw, k) for t in u])       # (16, M, K)
    W = transform_weights(kernel).to(x.device, gemm_dtype)        # (16, K, N)
    # float32 sums of the (bf16-rounded) operands: preferred_element_type
    Y = torch.bmm(U.float(), W.float())
    return _output_assemble(Y, b, th, tw, n)


def quantize_winograd_weights(kernel, s_u: np.ndarray):
    """(3, 3, K, N) float32 -> (Wq (16, K, N) int8, rescale (16, 1, N)
    float32), on the kernel's device: rescale folds the per-position input
    scale and the per-(position, N) weight scale for the float32 dequant
    after the int8 GEMM. Rounds half to even, as JAX's ``np.round``."""
    t = transform_weights(kernel)                                 # (16, K, N)
    w_scale = (t.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    wq = torch.round(t / w_scale).clamp(-127, 127).to(torch.int8)
    s_u = torch.as_tensor(np.asarray(s_u, np.float32), device=t.device)
    return wq, w_scale * s_u.reshape(16, 1, 1)


def _requant_u4(t: torch.Tensor) -> torch.Tensor:
    """int32 u (|u| <= 508) -> int8 u/4, rounded half away from zero on the
    magnitude (a shift of the signed value would floor negatives one grid
    step low)."""
    return (torch.sign(t) * ((t.abs() + 2) >> 2)).clamp(-127, 127).to(torch.int8)


def _int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 by ``torch._int_mm``,
    which on the card needs M > 16 and K, N multiples of 8 (zero rows and
    columns are added where they are not)."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def winograd_conv_int8(x_int8: torch.Tensor, s_x: float, wq: torch.Tensor,
                       rescale: torch.Tensor) -> torch.Tensor:
    """int8 Winograd: x int8 (B, H, W, K) with activation scale ``s_x``;
    ``wq``/``rescale`` from ``quantize_winograd_weights`` with
    ``int8_u_scales(s_x)`` (|B^T d B| <= 4*127, so u/4 fits int8), on
    ``x_int8``'s device. Returns the float32 conv output (B, H, W, N)."""
    b, h, w, k = x_int8.shape
    _check_even(h, w)
    n = wq.shape[-1]
    th, tw = h // 2, w // 2
    u = _input_transform(_tiles(x_int8), torch.int32)             # exact int32
    U = [_requant_u4(t).reshape(b * th * tw, k) for t in u]
    Y = torch.stack([_int8_gemm(U[p], wq[p]) for p in range(16)])  # (16, M, N)
    F = Y.float() * rescale
    return _output_assemble(F, b, th, tw, n)


def int8_u_scales(s_x: float) -> np.ndarray:
    """Per-position u scales for ``quantize_winograd_weights``: the /4
    requant makes the effective u grid s_x * 4."""
    return np.full((16,), s_x * 4.0, np.float32)
