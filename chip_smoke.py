#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpusr_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card with sm_90a, the CUDA
toolkit (``nvcc``) and no network. It imports no JAX. Phases, each printing
its own lines:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, the TF32 flags (off);
2. build: every CUDA source of the port, one ``nvcc`` per source, in parallel;
3. K1 (``conv3x3_int8_requant``) against its plain twin at each shape the
   serving path launches it at (13 trunk layers at the batch from 560x560,
   the 11 per-patch layers of blocks 2-5 at the escalated patches from
   48x48): bit-equal;
4. K3 (``block1_int8``, fused patch extraction + block 1 + pool) against its
   plain twin at the escalation's 4 images of 512^2 (400 patches), the guard
   fallback's 16 (1600 patches) and one 128^2 image (4 patches): 0 differing
   int8 values, timed beside the block 1 it replaces (patch extraction, two
   K1 launches and the pool);
5. K2 (``conv3x3_bias_act``, f32) against its plain twin at the EDSR body
   shapes and the border-band slab shapes: max |err| <= 1e-4 (fp32 sums in
   another order), with ``F.conv2d`` fp32 timed beside it as the library
   yardstick;
6. K2's bf16 instance against its twin at the same shapes: within 1 bf16
   ulp (fp32 sums in another order, each rounded once), ``F.conv2d`` bf16
   as the yardstick;
7. K4 (``nlm_denoise``) against its twin at 128^2 (the LR size the classic
   comparison denoises) and 512^2, 1024^2, 2048^2: ``allclose`` at atol
   1e-5 (box sums and exp weights in another order);
8. the serving slice at full width: EDSR x4 (16 blocks, 64 filters) and
   VGG16 (2 classes) from ``--seed``, the classifier's last bias centered so
   both classes get votes, the shipped mode (f32 fused SR -> guarded
   vote_frac int8 cascade) served by ``PipelineServer`` at batch 16 for 20
   requests, with the launch counts the path implies (a per-patch call
   launches K3 once and K1 11 times), the SR held against a plain chained
   EDSR, the int8 stage held against the same stage on K1's and K3's twins,
   the K3 per-patch probabilities held equal to the all-K1 path, and the
   guard-tripped cascade held against that all-K1 per-patch path;
9. bf16 SR serving: one batch of 16 through ``make_serving_pipeline(
   sr_mode="bf16", cascade_int8, vote_frac, frac 0.28125, guard 0.6)`` on
   the same weights, with 46 K2-bf16 launches, its SR against the f32 SR
   and its classes against the f32-SR cascade;
10. int8 SR serving: ``conv3x3_int8_dequant`` against its twin at its
   shapes (bit-equal) and the ``torch._int_mm`` 7x7 tail against its
   float64 twin (equal); then one batch of 16 of each of bench.py's int8-SR
   rows (``int8_sr_per_patch_int8``, ``int8_sr_shared_trunk_int8``,
   ``int8_sr_noborder_shared_trunk_int8``) with their launch counts, the SR
   held bit for bit against the same SR on the dequant conv's twin, and
   its PSNR against the f32 SR;
11. the f32 modes: one batch of ``shared_trunk_f32`` (its patch
   probabilities against a float64 run of the same trunk), one of
   ``per_patch_f32`` with ``classify_chunks=4`` against ``classify_chunks
   =1``, and one call of ``tpusr_torch.entry.entry()``;
12. the classic-SR comparison: ``run_classic_comparison`` on 16 HR 512^2 /
   LR 128^2 uint8 pairs made from ``--seed``, with the K4 launches it
   implies, the reference's score pattern, and one pair's SR images held
   against the same harness run on the CPU (plain twins).

Each path (8-12) is driven with the launch counts set to 0 just before it
and read just after. Before the last line it prints one JSON object with a
record per kernel (times: K1, K2 and K3 for one served batch of 16 on the
path without the guard fallback, K2-bf16 the same on the bf16 path, the
dequant conv for one int8-SR batch, K4 one launch at 128^2; ``launches``
counts the kernel's path) and the ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12,
                  # special-function unit (expf): 16 results per clock per
                  # SM (NVIDIA's CUDA C++ throughput table, compute
                  # capability 9.0), 132 SMs at the 1.98 GHz boost clock
                  "sfu": 16 * 132 * 1.98e9}
K2_ATOL = 1e-4       # fp32 sums of up to 9*64 terms in another order
K2_BF16_ULPS = 1     # one rounding to bf16 each, beyond the fp32 order gap
K4_ATOL = 1e-5       # box sums and exp weights in another order than the twin
SR_ATOL = 1e-4       # fused polyphase tail vs the chained tail, fp32
BF16_SR_MIN_PSNR = 35.0  # bf16 keeps 8 significant bits: 2^-9 per rounding
TRUNK_F32_ATOL = 1e-4    # f32 trunk probs against a float64 run of it
INT8_SR_MIN_PSNR = 25.0  # interior int8 SR against the f32 SR, random weights
# bench.py's int8-SR rows (MODES): (sr_border_correction, clf_mode)
INT8_SR_ROWS = {"int8_sr_per_patch_int8": (True, "per_patch_int8"),
                "int8_sr_shared_trunk_int8": (True, "shared_trunk_int8"),
                "int8_sr_noborder_shared_trunk_int8": (False, "shared_trunk_int8")}
K4_SIZES = (128, 512, 1024, 2048)
CLASSIC_PAIRS, CLASSIC_HR, CLASSIC_LR = 16, 512, 128


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


@dataclass(frozen=True)
class Slice:
    """The served configuration: the shipped mode at its published widths."""
    lr: int = 128
    scale: int = 4
    blocks: int = 16
    filters: int = 64
    widths: tuple = (64, 128, 256, 512, 512)
    dense: int = 256
    patch: int = 96
    stride: int = 48
    batch: int = 16
    requests: int = 20
    frac: float = 0.25
    guard: float = 0.6
    bf16_frac: float = 0.28125

    @property
    def hr(self) -> int:
        return self.lr * self.scale

    def n_patches(self) -> int:
        from tpusr_torch.core.pad import pad_amounts
        from tpusr_torch.core.patches import patch_grid_size
        ph, pw = pad_amounts(self.hr, self.hr, self.patch, self.stride)
        nh, nw = patch_grid_size(self.hr + ph, self.hr + pw, self.patch,
                                 self.stride)
        return nh * nw

    def escalated(self) -> int:
        return max(1, min(self.batch, math.ceil(self.batch * self.frac - 1e-9)))


# ----------------------------------------------------------------- shapes

def vgg_conv_shapes(n: int, hw: int, widths, first_block: int = 1
                    ) -> list[tuple]:
    """(N, H, W, Cin, Cout) of the int8 VGG16 convs from block
    ``first_block`` on, for an (n, hw, hw) input to that block: pools after
    blocks 1-4 halve the grid."""
    from tpusr_torch.models.vgg import VGG16_CFG
    shapes = []
    cin = 3 if first_block == 1 else widths[first_block - 2]
    for (block, n_convs, _f), wd in zip(VGG16_CFG, widths):
        if block < first_block:
            continue
        for _ in range(n_convs):
            shapes.append((n, hw, hw, cin, wd))
            cin = wd
        if block < 5:
            hw //= 2
    return shapes


def k1_shapes(cfg: Slice) -> list[tuple[str, tuple, int]]:
    """(where, shape, launches per served batch) for K1: the shared trunk on
    the reflect-padded batch, then blocks 2-5 of the per-patch path on the
    escalated images' patches (block 1 is K3's)."""
    from tpusr_torch.core.pad import pad_amounts
    padded = cfg.hr + pad_amounts(cfg.hr, cfg.hr, cfg.patch, cfg.stride)[0]
    trunk = vgg_conv_shapes(cfg.batch, padded, cfg.widths)
    patches = vgg_conv_shapes(cfg.escalated() * cfg.n_patches(),
                              cfg.patch // 2, cfg.widths, first_block=2)
    return ([("trunk", s, 1) for s in trunk]
            + [("escalation", s, 1) for s in patches])


def n_per_patch_k1(cfg: Slice) -> int:
    """K1 launches of one per-patch call (blocks 2-5)."""
    return sum(1 for where, *_ in k1_shapes(cfg) if where == "escalation")


def reset_counts() -> None:
    from tpusr_torch.core import conv3x3
    from tpusr_torch.models import block1
    conv3x3.reset_launch_counts()
    block1.reset_launch_counts()


def read_counts() -> dict:
    """The launch counts of every kernel on the serving paths."""
    from tpusr_torch.core import conv3x3
    from tpusr_torch.models import block1
    return {**conv3x3.LAUNCHES, **block1.LAUNCHES}


def launches_want(**counts) -> dict:
    """Expected launch counts: the given kernels, every other one 0."""
    return {**{k: 0 for k in read_counts()}, **counts}


def k2_shapes(cfg: Slice) -> list[tuple[str, tuple, bool, int]]:
    """(where, shape, relu, launches per served batch) for K2 in the x4
    fused SR forward: head, residual blocks and body conv on the LR grid,
    then up0/up1/tail on the 7-cell border-band slabs (top/bottom and
    left/right)."""
    n, h, f = cfg.batch, cfg.lr, cfg.filters
    out = [("head", (n, h, h, 3, f), False, 1),
           ("res.conv1", (n, h, h, f, f), True, cfg.blocks),
           ("res.conv2+body", (n, h, h, f, f), False, cfg.blocks + 1)]
    slab = 7                                  # 2 * pad + 1, pad = 3 at x4
    for name, rows, cols, cin, cout in (
            ("up0", slab, h, f, 4 * f), ("up1", 2 * slab, 2 * h, f, 4 * f),
            ("tail", 4 * slab, 4 * h, f, 3)):
        out.append((f"{name} top/bottom", (n, rows, cols, cin, cout), False, 2))
        out.append((f"{name} left/right", (n, cols, rows, cin, cout), False, 2))
    return out


def dequant_shapes(cfg: Slice) -> list[tuple[str, tuple, int]]:
    """(where, shape, launches per batch) of ``conv3x3_int8_dequant`` in the
    int8 SR forward: the head, and the residual-block and body convs."""
    n, h, f = cfg.batch, cfg.lr, cfg.filters
    return [("head", (n, h, h, 3, f), 1),
            ("res+body", (n, h, h, f, f), 2 * cfg.blocks + 1)]


def bound(ops: float, nbytes: float, kind: str,
          sfu_ops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for ``ops`` operations of ``kind``, ``sfu_ops``
    special-function operations and ``nbytes`` of traffic."""
    t_ops = max(ops / PEAK_OPS_PER_S[kind], sfu_ops / PEAK_OPS_PER_S["sfu"]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_work(shape, elem_bytes: int, n_vecs: int = 2) -> tuple[float, float]:
    """Operations and bytes of one 3x3 conv launch: each input read once,
    each output written once, ``n_vecs`` f32 vectors per channel."""
    n, h, w, cin, cout = shape
    m = n * h * w
    ops = 2.0 * m * 9 * cin * cout
    nbytes = elem_bytes * (m * cin + 9 * cin * cout + m * cout) + 4 * n_vecs * cout
    return ops, nbytes


def nlm_work(h: int, w: int) -> tuple[float, float, float]:
    """fp32 operations, expf calls and bytes of one K4 launch on an (h, w)
    image. For each of the 168 offsets: a difference and a square on the
    (h+4, w+4) box-extended window, 4 + 4 adds of the separable box sum,
    and per pixel the 1/25 scale, the subtraction of 2 sigma^2, the max,
    the scale by 1/h^2, the weighted add to num and the add to den (8); then
    one division per pixel. The image is read once and the output written
    once."""
    n_off = 168
    ops = n_off * (2.0 * (h + 4) * (w + 4) + 4.0 * h * (w + 4) + 4.0 * h * w
                   + 8.0 * h * w) + h * w
    return ops, float(n_off * h * w), 8.0 * h * w + 8.0


# ----------------------------------------------------------------- timing

def time_ms(fn, min_total_ms: float = 30.0, max_iters: int = 50) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around a run of
    launches after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    est = max(start.elapsed_time(end), 1e-3)
    iters = max(2, min(max_iters, int(min_total_ms / est)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, sync) -> float:
    """Host-clock ms of ``fn()`` ended by a device barrier."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


# ----------------------------------------------------------------- phases

def phase_environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    from tpusr_torch.device import fp32_math
    fp32_math()
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    return card


def phase_build() -> None:
    from tpusr_torch.core import _build
    t0 = time.perf_counter()
    names = _build.build_all()
    for name in names:
        _build.load(name)
    print(f"[build] {', '.join(f'csrc/{n}.cu' for n in names)} built and "
          f"loaded in {time.perf_counter() - t0:.2f} s")


def _int8_operands(shape, g, dev):
    n, h, w, cin, cout = shape
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device=dev,
                       dtype=torch.int8)
    # |acc| ~ sqrt(9 cin) * 127^2 / 3: rescale spreads outputs over the clip
    # range, so both clips and the interior are exercised
    acc_std = math.sqrt(9 * cin) * 127.0 ** 2 / 3.0
    rs = (torch.rand(cout, generator=g, device=dev) + 0.5) * (40.0 / acc_std)
    b = torch.rand(cout, generator=g, device=dev) * 20.0 - 10.0 + 0.5
    return x, wq, rs, b


def block1_operands(g, dev, n: int, h: int, w: int):
    """A block-1 int8 tree (b1c1 3 -> 64, b1c2 64 -> 64) with K1's spread of
    rescales and biases, and (n, h, w, 3) int8 images."""
    q = {"layers": {}}
    for name, cin in (("block1_conv1", 3), ("block1_conv2", 64)):
        _, wq, rs, b = _int8_operands((1, 1, 1, cin, 64), g, dev)
        q["layers"][name] = {"kernel_q": wq, "rescale": rs, "bias_over_out": b}
    images = torch.randint(-127, 128, (n, h, w, 3), generator=g, device=dev,
                           dtype=torch.int8)
    return q, images


def phase_k1(cfg: Slice, dev) -> dict:
    from tpusr_torch.core.conv3x3 import (conv3x3_int8_requant,
                                          conv3x3_int8_requant_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0,
           "t_ops": 0.0, "t_bytes": 0.0}
    for where, shape, mult in k1_shapes(cfg):
        x, wq, rs, b = _int8_operands(shape, g, dev)
        y = conv3x3_int8_requant(x, wq, rs, b)
        yp = conv3x3_int8_requant_plain(x, wq, rs, b)
        torch.cuda.synchronize()
        err = int((y.int() - yp.int()).abs().max())
        check(torch.equal(y, yp), f"K1 differs from its twin at {shape}: "
                                  f"{int((y != yp).sum())} values, max {err}")
        spread = int(torch.unique(y).numel())
        ms = time_ms(lambda: conv3x3_int8_requant(x, wq, rs, b))
        pms = time_ms(lambda: conv3x3_int8_requant_plain(x, wq, rs, b),
                      min_total_ms=10.0, max_iters=5)
        ops, nbytes = conv_work(shape, 1)
        bms, by = bound(ops, nbytes, "int8")
        print(f"[K1] {where:10s} {str(shape):28s} equal (max|err| {err}, "
              f"{spread} levels)  kernel {ms:.4f} ms  twin {pms:.4f} ms  "
              f"bound {bms:.4f} ms ({by})  x{mult}/batch")
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * pms
        tot["bound_ms"] += mult * bms
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        tot["err"] = max(tot["err"], err)
        del x, wq, y, yp
    torch.cuda.empty_cache()
    return tot


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps, across zero (bit patterns on a monotone line)."""
    def line(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(a) - line(b)).abs()


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |v| (8 significant bits), float32."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def check_k2_bf16(x, k, b, relu, y, yp) -> tuple[int, int, float]:
    """K2-bf16's output ``y`` against its twin's ``yp`` on bf16 ``x``, ``k``.

    The bf16 instance accumulates the same fp32 FMAs in the same k order as
    the f32 instance, so ``y`` must equal K2-f32 on the same values rounded
    once to bf16, bit for bit. Against the twin, the two fp32 sums differ
    by their summation order (K2-f32 against its twin on the same values
    measures that gap), and each is rounded once: ``|y - yp| <= ulp +
    |y32 - yp32|``. Where sums cancel to near zero the gap is many bf16
    ulps wide; everywhere else it is within one ulp. Returns the largest
    ulp distance, the count of outputs more than one ulp apart and the
    largest |y - yp|."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    y32 = conv3x3_bias_act(x.float(), k.float(), b, relu)
    yp32 = conv3x3_bias_act_plain(x.float(), k.float(), b, relu)
    check(torch.equal(y, y32.bfloat16()),
          f"K2-bf16 != bf16(K2-f32) at {tuple(x.shape)}->{tuple(y.shape)}: "
          f"{int((y != y32.bfloat16()).sum())} values")
    d = (y.float() - yp.float()).abs()
    tol = K2_BF16_ULPS * bf16_ulp(torch.maximum(y.float().abs(), yp.float().abs())) \
        + (y32 - yp32).abs()
    ulps = _bf16_ulps(y, yp)
    check(bool((d <= tol).all()), f"K2-bf16 vs its twin at {tuple(y.shape)}: "
                                  f"{int((d > tol).sum())} values beyond 1 ulp "
                                  f"+ the fp32 order gap")
    return int(ulps.max()), int((ulps > K2_BF16_ULPS).sum()), float(d.max())


def block1_work(n: int, h: int, w: int, patch: int, n_patches: int
                ) -> tuple[float, float]:
    """int8 operations and bytes of one K3 launch: both convs' MACs on every
    patch pixel (27 and 576 per output channel), the images read once, the
    weights and the four per-channel vectors read once, the pooled output
    written once."""
    ops = 2.0 * n_patches * patch * patch * 64 * (27 + 576)
    nbytes = (n * h * w * 3 + 9 * 64 * (3 + 64) + 4 * 4 * 64
              + n_patches * (patch // 2) ** 2 * 64)
    return ops, float(nbytes)


def phase_k3(cfg: Slice, dev) -> dict:
    """K3 against its plain twin at the per-patch path's shapes; the current
    block 1 (patch extraction, two K1 launches, the pool) timed beside it.
    Returns the record of the escalation's shape, the served batch's K3
    launch on the path without the guard fallback."""
    from tpusr_torch.core.conv3x3 import conv3x3_int8_requant
    from tpusr_torch.models.block1 import (block1_int8, block1_plain,
                                           extract_patches_reference,
                                           grid_counts, max_pool2x2)
    g = torch.Generator(device=dev).manual_seed(5)
    rec = {}
    for where, n, hw in (("escalation", cfg.escalated(), cfg.hr),
                         ("guard fallback", cfg.batch, cfg.hr),
                         ("one 128^2 image", 1, 128)):
        q, images = block1_operands(g, dev, n, hw, hw)
        l1, l2 = (q["layers"][k] for k in ("block1_conv1", "block1_conv2"))

        def plain():   # 4 images at a time: float64 activations are large
            return torch.cat([block1_plain(q, images[i:i + 4], cfg.patch,
                                           cfg.stride)
                              for i in range(0, n, 4)])

        def k1_block1():
            x = extract_patches_reference(images, cfg.patch, cfg.stride)
            for layer in (l1, l2):
                x = conv3x3_int8_requant(x, layer["kernel_q"], layer["rescale"],
                                         layer["bias_over_out"])
            return max_pool2x2(x)

        y = block1_int8(q, images, cfg.patch, cfg.stride)
        yp = plain()
        torch.cuda.synchronize()
        n_diff = int((y != yp).sum())
        check(y.shape == yp.shape and n_diff == 0,
              f"K3 differs from its twin at {where}: {n_diff} values")
        check(torch.equal(k1_block1(), y), f"K3 != patches + 2 K1 + pool at "
                                           f"{where}")
        spread = int(torch.unique(y).numel())
        ms = time_ms(lambda: block1_int8(q, images, cfg.patch, cfg.stride))
        pms = time_ms(plain, min_total_ms=10.0, max_iters=3)
        k1ms = time_ms(k1_block1, max_iters=10)
        n_h, n_w = grid_counts(hw, hw, cfg.patch, cfg.stride)
        ops, nbytes = block1_work(n, hw, hw, cfg.patch, n * n_h * n_w)
        bms, by = bound(ops, nbytes, "int8")
        print(f"[K3] {where:16s} {n} x {hw}^2 -> {tuple(y.shape)}: 0 of "
              f"{y.numel()} int8 values differ ({spread} levels)  kernel "
              f"{ms:.4f} ms  twin {pms:.4f} ms  bound {bms:.4f} ms ({by}: "
              f"{ops / 1e9:.1f} G int8 ops)  current block 1 (patches + 2 K1 "
              f"+ pool) {k1ms:.4f} ms")
        if where == "escalation":
            rec = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "err": 0.0,
                   "t_ops": bms if by == "operations" else 0.0,
                   "t_bytes": bms if by == "bytes" else 0.0}
        del q, images, y, yp
    torch.cuda.empty_cache()
    return rec


def phase_k2(cfg: Slice, dev) -> dict:
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    g = torch.Generator(device=dev).manual_seed(2)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "err": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for where, shape, relu, mult in k2_shapes(cfg):
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=g, device=dev)
        k = torch.randn((3, 3, cin, cout), generator=g, device=dev) \
            * math.sqrt(2.0 / (9 * cin))
        b = torch.randn(cout, generator=g, device=dev) * 0.1
        y = conv3x3_bias_act(x, k, b, relu)
        yp = conv3x3_bias_act_plain(x, k, b, relu)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        check(err <= K2_ATOL, f"K2 differs from its twin at {shape}: "
                              f"max|err| {err} > {K2_ATOL}")
        x_nchw, k_oihw = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous()
        ms = time_ms(lambda: conv3x3_bias_act(x, k, b, relu))
        pms = time_ms(lambda: conv3x3_bias_act_plain(x, k, b, relu))
        lms = time_ms(lambda: F.conv2d(x_nchw, k_oihw, b, padding=1))
        ops, nbytes = conv_work(shape, 4)
        bms, by = bound(ops, nbytes, "fp32")
        print(f"[K2] {where:20s} {str(shape):27s} relu={int(relu)} max|err| "
              f"{err:.3g}  kernel {ms:.4f} ms  twin {pms:.4f} ms  F.conv2d "
              f"{lms:.4f} ms  bound {bms:.4f} ms ({by})  x{mult}/batch")
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * pms
        tot["library_ms"] += mult * lms
        tot["bound_ms"] += mult * bms
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        tot["err"] = max(tot["err"], err)
    return tot


def phase_k2_bf16(cfg: Slice, dev) -> dict:
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act, conv3x3_bias_act_plain
    g = torch.Generator(device=dev).manual_seed(3)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "err": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for where, shape, relu, mult in k2_shapes(cfg):
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=g, device=dev).bfloat16()
        k = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             * math.sqrt(2.0 / (9 * cin))).bfloat16()
        b = torch.randn(cout, generator=g, device=dev) * 0.1
        y = conv3x3_bias_act(x, k, b, relu)
        yp = conv3x3_bias_act_plain(x, k, b, relu)
        torch.cuda.synchronize()
        check(y.dtype == torch.bfloat16, f"K2-bf16 returned {y.dtype}")
        ulps, n_over, err = check_k2_bf16(x, k, b, relu, y, yp)
        x_nchw, k_oihw = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous()
        b16 = b.bfloat16()
        ms = time_ms(lambda: conv3x3_bias_act(x, k, b, relu))
        pms = time_ms(lambda: conv3x3_bias_act_plain(x, k, b, relu))
        lms = time_ms(lambda: F.conv2d(x_nchw, k_oihw, b16, padding=1))
        ops, nbytes = conv_work(shape, 2, n_vecs=1)
        bms, by = bound(ops, nbytes, "bf16")
        print(f"[K2-bf16] {where:20s} {str(shape):27s} relu={int(relu)} "
              f"== bf16(K2-f32); vs twin max {ulps} ulp, {n_over} of "
              f"{y.numel()} beyond 1 ulp, all within the fp32 order gap "
              f"(max|err| {err:.3g})  kernel {ms:.4f} ms  twin "
              f"{pms:.4f} ms  F.conv2d bf16 {lms:.4f} ms  bound {bms:.4f} ms "
              f"({by})  x{mult}/batch")
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * pms
        tot["library_ms"] += mult * lms
        tot["bound_ms"] += mult * bms
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        tot["err"] = max(tot["err"], err)
    return tot


def smooth_images(g: torch.Generator, n: int, size: int, channels: int,
                  dev) -> torch.Tensor:
    """(n, size, size, channels) float32 in [0, 255]: bicubic-upsampled
    coarse noise plus two sharp-edged rectangles and fine noise per image
    (textured regions and edges, what the classic algorithms are told
    apart on)."""
    from tpusr_torch.core.resize import resize
    coarse = torch.rand((n, size // 16, size // 16, channels), generator=g,
                        device=dev)
    img = resize(coarse, (size, size), "bicubic") * 180.0 + 30.0
    q = size // 8
    for i in range(n):
        r, c = (int(v) for v in torch.randint(0, 4 * q, (2,), generator=g,
                                              device=dev))
        img[i, r:r + 3 * q, c:c + 2 * q] += 50.0
        img[i, c:c + 2 * q, r:r + 4 * q] -= 40.0
    img += torch.randn(img.shape, generator=g, device=dev) * 3.0
    return img.clamp(0.0, 255.0)


def phase_k4(dev) -> dict:
    from tpusr_torch.classic.algorithms import estimate_sigma
    from tpusr_torch.core.nlm import nl_means_denoise, nlm_denoise
    g = torch.Generator(device=dev).manual_seed(4)
    rec = {}
    for size in K4_SIZES:
        x = (smooth_images(g, 1, size, 1, dev)[0, :, :, 0] / 255.0).contiguous()
        sigma = estimate_sigma(x)
        h = 1.15 * sigma
        y = nlm_denoise(x, sigma, h)
        yp = nl_means_denoise(x, sigma, h)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        check(bool(torch.isfinite(y).all()) and torch.allclose(
            y, yp, rtol=0, atol=K4_ATOL),
            f"K4 differs from its twin at {size}^2: max|err| {err} > {K4_ATOL}")
        ms = time_ms(lambda: nlm_denoise(x, sigma, h))
        pms = time_ms(lambda: nl_means_denoise(x, sigma, h), max_iters=5)
        ops, exps, nbytes = nlm_work(size, size)
        bms, by = bound(ops, nbytes, "fp32", sfu_ops=exps)
        print(f"[K4] {size}x{size} sigma {float(sigma):.4f} max|err| {err:.3g}"
              f"  kernel {ms:.4f} ms  twin {pms:.4f} ms  bound {bms:.4f} ms "
              f"({by}: {ops / 1e9:.2f} GFLOP fp32 at 67 TFLOP/s, "
              f"{exps / 1e6:.1f} M expf at {PEAK_OPS_PER_S['sfu'] / 1e12:.2f} "
              f"T/s, {nbytes / 1e6:.2f} MB at 3.35 TB/s)")
        if size == CLASSIC_LR:          # the shape the classic path launches
            rec = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "err": 0.0,
                   "t_ops": bms if by == "operations" else 0.0,
                   "t_bytes": bms if by == "bytes" else 0.0}
        rec["err"] = max(rec.get("err", 0.0), err)
    return rec


def image_logodds(probs: torch.Tensor) -> torch.Tensor:
    """(N, P, 2) patch probs -> (N,) per-image median patch log-odds."""
    p = probs.double().cpu()
    return torch.log(p[..., 1].clamp_min(1e-9)
                     / p[..., 0].clamp_min(1e-9)).median(dim=1).values


def center_classifier_bias(vgg, trunk: torch.Tensor, per_patch: torch.Tensor):
    """Shift the class-1 logit bias by minus the median over images of the
    mean of the trunk's and the per-patch path's median patch log-odds, so
    the votes of both paths split between the classes. Returns the shift
    and the two per-image log-odds vectors."""
    lt, lp = image_logodds(trunk), image_logodds(per_patch)
    delta = -float(((lt + lp) / 2).median())
    with torch.no_grad():
        vgg.predictions.bias[1] += delta
    return delta, lt, lp


def plain_edsr(edsr, x: torch.Tensor) -> torch.Tensor:
    """The chained EDSR x4 forward on K2's plain twin: the reference the
    fused SR path is held against."""
    from tpusr_torch.core.conv3x3 import conv3x3_bias_act_plain as conv
    from tpusr_torch.models.layers import pixel_shuffle

    def c(m, t, relu=False):
        return conv(t, m.kernel, m.bias, relu)

    head = y = c(edsr.head, x)
    for i in range(edsr.num_res_blocks):
        blk = getattr(edsr, f"res{i}")
        y = y + edsr.res_scaling * c(blk.conv2, c(blk.conv1, y, True))
    y = c(edsr.body, y) + head
    y = pixel_shuffle(c(edsr.up0, y), 2)
    y = pixel_shuffle(c(edsr.up1, y), 2)
    return c(edsr.tail, y).clamp(0.0, 1.0)


class on_plain_twins:
    """Route the int8 classifier's kernels (K1 in the backbone, K3 for block
    1) to their plain twins on the same device for the duration of a
    reference computation."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3
        from tpusr_torch.models import block1, quant
        self._quant = quant
        self._orig = (quant.conv3x3_int8_requant, quant.block1_int8)
        quant.conv3x3_int8_requant = conv3x3.conv3x3_int8_requant_plain
        quant.block1_int8 = block1.block1_plain

    def __exit__(self, *exc):
        (self._quant.conv3x3_int8_requant,
         self._quant.block1_int8) = self._orig


def phase_slice(cfg: Slice, dev, seed: int, sync, card: str) -> dict:
    from tpusr_torch.core.patches import patchify
    from tpusr_torch.models import EDSR, VGG16Classifier
    from tpusr_torch.models.block1 import extract_patches_reference
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.models.quant import (per_patch_int8_probs,
                                          quantized_vgg16_apply)
    from tpusr_torch.models.vgg_trunk import shared_trunk_probs_int8
    from tpusr_torch.pipeline import (FusedSRClassifyPipeline, PipelineServer,
                                      make_serving_pipeline)
    from tpusr_torch.pipeline.cascade import make_cascade_votes

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(seed)
    edsr = EDSR(scale_factor=cfg.scale, num_res_blocks=cfg.blocks,
                num_filters=cfg.filters, device=dev, generator=g)
    vgg = VGG16Classifier(num_classes=2, dense_units=cfg.dense,
                          widths=cfg.widths, device=dev, generator=g)
    rng = np.random.default_rng(seed)

    def lr_images(n):
        # noise images of different brightness, so that a random classifier
        # sees images that differ by more than the trunk's padding offset
        gain = rng.uniform(0.05, 1.0, (n, 1, 1, 1)).astype(np.float32)
        return rng.random((n, cfg.lr, cfg.lr, 3), dtype=np.float32) * gain

    requests, calib_lr = lr_images(cfg.requests), lr_images(4)
    calib_lr = torch.as_tensor(calib_lr, device=dev)

    # calibration patches as the serve command takes them: the first 64
    # patches of the f32 SR of 4 calibration images
    fn, r = make_fused_sr_apply(edsr)
    with torch.inference_mode():
        sr_cal = pixel_shuffle(fn(calib_lr), r)
        calib = patchify(sr_cal, cfg.patch, cfg.stride)
        calib = calib.reshape((-1,) + calib.shape[2:])[:64]

    def build():
        return make_serving_pipeline(
            edsr, vgg, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
            stride=cfg.stride, sr_mode="f32", clf_mode="cascade_int8",
            calib_patches=calib, cascade_escalate_frac=cfg.frac,
            cascade_escalate_score="vote_frac",
            cascade_guard_threshold=cfg.guard, device=dev)

    # random weights vote one class; center the last bias on the requests'
    # trunk and per-patch log-odds so that both classes get votes
    pipe = build()
    with torch.inference_mode():
        srq = pipe.pre_quant(pipe.sr_apply(torch.as_tensor(requests, device=dev)))
        trunk = shared_trunk_probs_int8(pipe.qtree, srq, cfg.patch, cfg.stride)
        pp = torch.cat([pipe.cascade_votes.per_patch_probs(srq[i:i + 4])
                        for i in range(0, srq.shape[0], 4)])
    delta, lt, lp = center_classifier_bias(vgg, trunk, pp)
    pipe = build()
    del srq, trunk, pp
    sync()
    print(f"[slice] EDSR x{cfg.scale} {cfg.blocks} blocks {cfg.filters} "
          f"filters, VGG16 widths {cfg.widths}, seed {seed}; per-image "
          f"log-odds trunk [{lt.min():+.4f}, {lt.max():+.4f}], per-patch "
          f"[{lp.min():+.4f}, {lp.max():+.4f}]; class-1 bias shifted by "
          f"{delta:+.4f}; set-up {time.perf_counter() - t0:.1f} s")

    # ---- the main path: 20 requests through the server at batch 16 ----
    votes = pipe.cascade_votes
    votes.guard_trips = 0
    server = PipelineServer(pipe, batch_size=cfg.batch, max_wait_ms=50.0)
    futures = [server.submit(im) for im in requests]
    reset_counts()
    t0 = time.perf_counter()
    with server:
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    launches = read_counts()
    trips = votes.guard_trips
    last_escalated = votes.last_escalated.cpu()

    # per batch: the trunk (13 K1) and the escalation (K3 + 11 K1); per
    # guard trip: the fallback (K3 + 11 K1)
    n_batches = math.ceil(cfg.requests / cfg.batch)
    per_batch_k1 = len(k1_shapes(cfg))
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))
    want = launches_want(
        conv3x3_int8_requant=n_batches * per_batch_k1
        + trips * n_per_patch_k1(cfg),
        conv3x3_bias_act=n_batches * per_batch_k2,
        block1_int8=n_batches + trips)
    print(f"[slice] served {len(results)} requests in {n_batches} batches in "
          f"{served_s:.3f} s; guard trips {trips}; launches {launches} "
          f"(expected {want})")
    check(launches == want, f"launch counts {launches} != {want}")

    srs = np.stack([r["sr"] for r in results])
    classes = np.array([r["class"] for r in results])
    confs = np.array([r["confidence"] for r in results])
    check(srs.shape == (cfg.requests, cfg.hr, cfg.hr, 3), f"SR {srs.shape}")
    check(bool(np.isfinite(srs).all()) and srs.min() >= 0.0 and srs.max() <= 1.0,
          "SR not finite in [0, 1]")
    check(set(classes.tolist()) == {0, 1}, f"classes {classes.tolist()}")
    check(bool(((confs >= 0) & (confs <= 1)).all()), "confidence out of [0, 1]")
    tail = cfg.requests - (n_batches - 1) * cfg.batch
    check(last_escalated.numel() == cfg.escalated()
          and bool((last_escalated < tail).all()),
          f"partial batch escalated {last_escalated.tolist()}")
    print(f"[slice] classes {classes.tolist()}; partial batch (n_valid="
          f"{tail}) escalated {sorted(last_escalated.tolist())}")

    def variant(**stage):
        """The served pipeline's SR and quantizer with another classify
        stage."""
        return FusedSRClassifyPipeline(
            pipe.sr_apply, lr_hw=(cfg.lr, cfg.lr), scale=cfg.scale,
            patch=cfg.patch, stride=cfg.stride, pre_quant=pipe.pre_quant,
            device=dev, **stage)

    def cascade(guard):
        return make_cascade_votes(pipe.qtree, cfg.patch, cfg.stride, cfg.frac,
                                  "vote_frac", guard)

    def all_k1_probs(srq):
        """The per-patch path with block 1 on K1: extracted patches through
        quantized_vgg16_apply."""
        flat = extract_patches_reference(srq, cfg.patch, cfg.stride)
        return quantized_vgg16_apply(pipe.qtree, flat).reshape(
            srq.shape[0], cfg.n_patches(), -1)

    # ---- correctness of the served results against references ----
    batch = torch.as_tensor(requests[:cfg.batch], device=dev)
    with torch.inference_mode():
        sr, cls_b, conf_b = pipe(batch, n_valid=cfg.batch)
        check(votes.last_escalated.numel() == cfg.escalated(),
              "full batch escalation count")
        check(np.array_equal(cls_b.cpu().numpy(), classes[:cfg.batch])
              and np.allclose(conf_b.cpu().numpy(), confs[:cfg.batch],
                              rtol=0, atol=1e-6),
              "served results differ from a direct call on the same batch")
        sr_err = float((sr[:2] - plain_edsr(edsr, batch[:2])).abs().max())
        check(sr_err <= SR_ATOL, f"SR vs plain chained EDSR: {sr_err}")
        srq = pipe.pre_quant(sr)
        with on_plain_twins():
            cls_p, conf_p = votes(srq, cfg.batch)
        check(torch.equal(cls_p, cls_b)
              and torch.allclose(conf_p, conf_b, rtol=0, atol=1e-6),
              "cascade on K1's and K3's twins differs from the served cascade")
        probs_k3 = per_patch_int8_probs(pipe.qtree, srq, cfg.patch, cfg.stride)
        check(torch.equal(probs_k3, all_k1_probs(srq)),
              "per_patch_int8_probs (K3 + 11 K1) != patches + 13 K1")
        tripped = variant(cascade_votes=cascade(0.0))    # always trips
        per_patch = variant(trunk_probs=all_k1_probs)
        _, cls_g, conf_g = tripped(batch)
        _, cls_pp, conf_pp = per_patch(batch)
        check(tripped.cascade_votes.guard_trips == 1, "guard 0.0 did not trip")
        check(torch.equal(cls_g, cls_pp) and torch.equal(conf_g, conf_pp),
              "guard-tripped cascade differs from the all-K1 per-patch path")
    print(f"[slice] SR vs plain chained EDSR max|err| {sr_err:.3g} (atol "
          f"{SR_ATOL}); cascade on K1's and K3's twins equal; per-patch probs "
          f"K3 + 11 K1 == patches + 13 K1 on {cfg.batch} images (torch.equal);"
          f" guard-tripped cascade == the all-K1 per-patch path (classes "
          f"{cls_pp.tolist()})")

    # ---- steady-state time per batch and per stage ----
    # the served mode, and the same cascade with the guard off: the time of
    # a batch on which the guard stays silent
    unguarded = variant(cascade_votes=cascade(None))
    with torch.inference_mode():
        batch_ms = min(host_ms(lambda: pipe(batch, n_valid=cfg.batch), sync)
                       for _ in range(3))
        silent_ms = min(host_ms(lambda: unguarded(batch, n_valid=cfg.batch),
                                sync) for _ in range(3))
        srq = pipe.pre_quant(pipe.sr_apply(batch))
        n_esc = cfg.escalated()
        stages = {
            "sr": time_ms(lambda: pipe.sr_apply(batch), max_iters=5),
            "quantize": time_ms(lambda: pipe.pre_quant(sr), max_iters=5),
            "trunk": time_ms(lambda: shared_trunk_probs_int8(
                pipe.qtree, srq, cfg.patch, cfg.stride), max_iters=5),
            "escalation": time_ms(lambda: votes.per_patch_probs(srq[:n_esc]),
                                  max_iters=5),
            "guard_fallback": time_ms(lambda: votes.per_patch_probs(srq),
                                      max_iters=3),
        }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[slice] {card}, batch {cfg.batch} (host clock, best of 3): served mode "
          f"{batch_ms:.2f} ms per batch, {cfg.batch / batch_ms * 1e3:.1f} img/s "
          f"(guard tripped on {trips} of {n_batches} served batches); guard "
          f"silent {silent_ms:.2f} ms, {cfg.batch / silent_ms * 1e3:.1f} img/s; "
          f"stages (device ms) "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; peak memory {peak_gb:.1f} GB")
    return launches, {"edsr": edsr, "vgg": vgg, "calib": calib,
                      "calib_lr": calib_lr, "batch": batch, "sr_f32": sr,
                      "pipe": pipe}


def phase_bf16(cfg: Slice, dev, state: dict, sync, card: str) -> dict:
    """One batch of 16 through the bf16 SR serving mode on the slice's
    weights and calibration patches."""
    from tpusr_torch.pipeline import make_serving_pipeline

    def build(frac, guard, sr_mode="bf16"):
        return make_serving_pipeline(
            state["edsr"], state["vgg"], (cfg.lr, cfg.lr), cfg.scale,
            patch=cfg.patch, stride=cfg.stride, sr_mode=sr_mode,
            clf_mode="cascade_int8", calib_patches=state["calib"],
            cascade_escalate_frac=frac, cascade_escalate_score="vote_frac",
            cascade_guard_threshold=guard, device=dev)

    pipe = build(cfg.bf16_frac, cfg.guard)
    batch = state["batch"]
    votes = pipe.cascade_votes
    # ---- the main path: one full batch through the bf16 serving mode ----
    reset_counts()
    sr, cls, conf = pipe(batch, n_valid=cfg.batch)
    sync()
    launches = read_counts()
    trips = votes.guard_trips
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))
    want = launches_want(
        conv3x3_int8_requant=len(k1_shapes(cfg)) + trips * n_per_patch_k1(cfg),
        conv3x3_bias_act_bf16=per_batch_k2, block1_int8=1 + trips)
    print(f"[bf16] sr_mode=bf16 cascade_int8 vote_frac frac {cfg.bf16_frac} "
          f"guard {cfg.guard}: one batch of {cfg.batch}; guard trips {trips}; "
          f"launches {launches} (expected {want})")
    check(launches == want, f"bf16 launch counts {launches} != {want}")
    check(votes.last_escalated.numel()
          == math.ceil(cfg.batch * cfg.bf16_frac - 1e-9), "bf16 escalation count")
    check(sr.dtype == torch.float32 and tuple(sr.shape)
          == (cfg.batch, cfg.hr, cfg.hr, 3), f"bf16 SR {sr.dtype} {tuple(sr.shape)}")
    check(bool(torch.isfinite(sr).all()) and float(sr.min()) >= 0.0
          and float(sr.max()) <= 1.0, "bf16 SR not finite in [0, 1]")
    check(bool(((conf >= 0) & (conf <= 1)).all()), "confidence out of [0, 1]")

    # the bf16 SR against the f32 SR on the same LR batch, and the classes
    # against the f32-SR cascade with the same settings
    sr32 = state["sr_f32"]
    mse = float(((sr - sr32) ** 2).mean())
    psnr = 10.0 * math.log10(1.0 / max(mse, 1e-30))
    check(psnr >= BF16_SR_MIN_PSNR, f"bf16 SR vs f32 SR PSNR {psnr:.2f} dB "
                                    f"< {BF16_SR_MIN_PSNR}")
    _, cls32, _ = build(cfg.bf16_frac, cfg.guard, "f32")(batch, n_valid=cfg.batch)
    n_diff = int((cls != cls32).sum())
    unguarded = build(cfg.bf16_frac, None)
    with torch.inference_mode():
        guarded_ms = min(host_ms(lambda: pipe(batch, n_valid=cfg.batch), sync)
                         for _ in range(3))
        silent_ms = min(host_ms(lambda: unguarded(batch, n_valid=cfg.batch), sync)
                        for _ in range(3))
        sr_ms = time_ms(lambda: pipe.sr_apply(batch), max_iters=5)
    print(f"[bf16] SR PSNR against the f32 SR {psnr:.2f} dB (min "
          f"{BF16_SR_MIN_PSNR}); classes {cls.tolist()}, {n_diff} of "
          f"{cfg.batch} differ from the f32-SR cascade {cls32.tolist()}")
    print(f"[bf16] {card}, batch {cfg.batch} (host clock, best of 3): guard on "
          f"{guarded_ms:.2f} ms per batch, {cfg.batch / guarded_ms * 1e3:.1f} "
          f"img/s (tripped {trips} of 1); guard off {silent_ms:.2f} ms, "
          f"{cfg.batch / silent_ms * 1e3:.1f} img/s; bf16 SR stage "
          f"{sr_ms:.2f} ms (device)")
    return launches


class dequant_on_plain_twin:
    """Route the int8 EDSR's 3x3 convs to the dequant conv's plain twin (on
    the same device) for the duration of a reference computation."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3
        from tpusr_torch.models import edsr_quant
        self._mod, self._orig = edsr_quant, edsr_quant.conv3x3_int8_dequant
        edsr_quant.conv3x3_int8_dequant = conv3x3.conv3x3_int8_dequant_plain

    def __exit__(self, *exc):
        self._mod.conv3x3_int8_dequant = self._orig


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-30))


def phase_int8_sr(cfg: Slice, dev, state: dict, sync, card: str):
    """The dequant conv and the int8 tail against their twins, then one batch
    of 16 of each int8-SR row of bench.py. Returns the dequant conv's
    launches over the three rows and its record (one batch's launches)."""
    from tpusr_torch.core.conv3x3 import (conv3x3_int8_dequant,
                                          conv3x3_int8_dequant_plain)
    from tpusr_torch.models.edsr_quant import (tail_conv_int8,
                                               tail_conv_int8_plain)
    from tpusr_torch.pipeline import make_serving_pipeline

    g = torch.Generator(device=dev).manual_seed(6)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "t_ops": 0.0, "t_bytes": 0.0}
    for where, shape, mult in dequant_shapes(cfg):
        x, wq, rs, b = _int8_operands(shape, g, dev)
        y = conv3x3_int8_dequant(x, wq, rs, b)
        yp = conv3x3_int8_dequant_plain(x, wq, rs, b)
        torch.cuda.synchronize()
        n_diff = int((y.view(torch.int16) != yp.view(torch.int16)).sum())
        check(n_diff == 0, f"dequant conv differs from its twin at {shape}: "
                           f"{n_diff} values")
        ms = time_ms(lambda: conv3x3_int8_dequant(x, wq, rs, b))
        pms = time_ms(lambda: conv3x3_int8_dequant_plain(x, wq, rs, b),
                      min_total_ms=10.0, max_iters=5)
        n, h, w, cin, cout = shape
        ops = 2.0 * n * h * w * 9 * cin * cout
        nbytes = n * h * w * (cin + 2 * cout) + 9 * cin * cout + 8 * cout
        bms, by = bound(ops, nbytes, "int8")
        print(f"[int8-sr] dequant conv {where:8s} {str(shape):26s} bit-equal "
              f"to its twin (bf16)  kernel {ms:.4f} ms  twin {pms:.4f} ms  "
              f"bound {bms:.4f} ms ({by})  x{mult}/batch")
        tot["ms"] += mult * ms
        tot["plain_ms"] += mult * pms
        tot["bound_ms"] += mult * bms
        tot["t_" + ("ops" if by == "operations" else by)] += mult * bms
        del x, wq, y, yp
    n, h, f = cfg.batch, cfg.lr, cfg.filters
    x8 = torch.randint(-127, 128, (n, h, h, f), generator=g, device=dev,
                       dtype=torch.int8)
    kq = torch.randint(-127, 128, (7, 7, f, 3 * cfg.scale ** 2), generator=g,
                       device=dev, dtype=torch.int8)
    check(torch.equal(tail_conv_int8(x8, kq), tail_conv_int8_plain(x8, kq)),
          "int8 7x7 tail (torch._int_mm) != its float64 twin")
    tail_ms = time_ms(lambda: tail_conv_int8(x8, kq), max_iters=10)
    tail_pms = time_ms(lambda: tail_conv_int8_plain(x8, kq), max_iters=5)
    print(f"[int8-sr] 7x7 tail {tuple(x8.shape)} -> {tuple(kq.shape[-1:])} "
          f"channels: torch._int_mm over the im2col equals its float64 twin; "
          f"{tail_ms:.4f} ms, twin {tail_pms:.4f} ms")
    del x8, kq

    batch, sr32 = state["batch"], state["sr_f32"]
    per_batch_k1 = len(k1_shapes(cfg))
    band = 4 * 3          # pad 3 cells of the composed tail, x4
    interior = (slice(None), slice(band, -band), slice(band, -band))
    dequant_launches = 0
    for row, (border, clf_mode) in INT8_SR_ROWS.items():
        pipe = make_serving_pipeline(
            state["edsr"], state["vgg"], (cfg.lr, cfg.lr), cfg.scale,
            patch=cfg.patch, stride=cfg.stride, sr_mode="int8",
            clf_mode=clf_mode, calib_lr=state["calib_lr"],
            calib_patches=state["calib"], sr_border_correction=border,
            device=dev)
        # ---- the main path: one batch of this row ----
        reset_counts()
        sr, cls, conf = pipe(batch)
        sync()
        launches = read_counts()
        per_patch = clf_mode == "per_patch_int8"
        want = launches_want(
            conv3x3_int8_dequant=2 * cfg.blocks + 2,
            conv3x3_bias_act_bf16=12 if border else 0,
            conv3x3_int8_requant=(n_per_patch_k1(cfg) if per_patch
                                  else per_batch_k1 - n_per_patch_k1(cfg)),
            block1_int8=1 if per_patch else 0)
        check(launches == want, f"{row} launch counts {launches} != {want}")
        dequant_launches += launches["conv3x3_int8_dequant"]
        check(sr.dtype == torch.float32 and tuple(sr.shape)
              == (cfg.batch, cfg.hr, cfg.hr, 3), f"{row} SR {tuple(sr.shape)}")
        check(bool(torch.isfinite(sr).all()) and float(sr.min()) >= 0.0
              and float(sr.max()) <= 1.0, f"{row} SR not finite in [0, 1]")
        check(bool(((conf >= 0) & (conf <= 1)).all()), f"{row} confidence")
        with torch.inference_mode(), dequant_on_plain_twin():
            sr_twin = pipe.sr_apply(batch[:2])
        check(torch.equal(sr[:2], sr_twin),
              f"{row} SR differs from the same SR on the dequant conv's twin")
        p_all, p_in = psnr_db(sr, sr32), psnr_db(sr[interior], sr32[interior])
        check(p_in >= INT8_SR_MIN_PSNR, f"{row} interior SR PSNR {p_in:.2f} dB "
                                        f"< {INT8_SR_MIN_PSNR}")
        with torch.inference_mode():
            batch_ms = min(host_ms(lambda: pipe(batch), sync) for _ in range(3))
            sr_ms = time_ms(lambda: pipe.sr_apply(batch), max_iters=5)
        print(f"[int8-sr] {row}: launches {launches}; SR == SR on the dequant "
              f"twin (2 images); PSNR against the f32 SR {p_all:.2f} dB, "
              f"interior {p_in:.2f} dB (min {INT8_SR_MIN_PSNR}); classes "
              f"{cls.tolist()}")
        print(f"[int8-sr] {row}: {card}, batch {cfg.batch} (host clock, best "
              f"of 3) {batch_ms:.2f} ms per batch, "
              f"{cfg.batch / batch_ms * 1e3:.1f} img/s; int8 SR stage "
              f"{sr_ms:.2f} ms (device)")
        del pipe, sr
    torch.cuda.empty_cache()
    return dequant_launches, tot


def phase_f32_modes(cfg: Slice, dev, state: dict, sync, card: str) -> None:
    """shared_trunk_f32, classify_chunks and entry() on the card."""
    import copy

    from tpusr_torch.entry import entry
    from tpusr_torch.models.vgg_trunk import shared_trunk_probs_f32
    from tpusr_torch.pipeline import (FusedSRClassifyPipeline,
                                      make_serving_pipeline)

    edsr, vgg, batch = state["edsr"], state["vgg"], state["batch"]
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))

    def build(clf_mode):
        return make_serving_pipeline(
            edsr, vgg, (cfg.lr, cfg.lr), cfg.scale, patch=cfg.patch,
            stride=cfg.stride, sr_mode="f32", clf_mode=clf_mode, device=dev)

    # ---- shared_trunk_f32: one batch ----
    pipe = build("shared_trunk_f32")
    reset_counts()
    sr, cls, conf = pipe(batch)
    sync()
    launches = read_counts()
    want = launches_want(conv3x3_bias_act=per_batch_k2)
    check(launches == want, f"shared_trunk_f32 launches {launches} != {want}")
    check(bool(((conf >= 0) & (conf <= 1)).all()), "trunk f32 confidence")
    vgg64 = copy.deepcopy(vgg).double()
    with torch.inference_mode():
        probs = shared_trunk_probs_f32(vgg, sr[:2], cfg.patch, cfg.stride)
        probs64 = shared_trunk_probs_f32(vgg64, sr[:2], cfg.patch, cfg.stride)
        trunk_ms = min(host_ms(lambda: pipe(batch), sync) for _ in range(3))
    del vgg64
    err = float((probs.double() - probs64).abs().max())
    check(probs.shape == (2, cfg.n_patches(), 2) and err <= TRUNK_F32_ATOL,
          f"shared_trunk_f32 probs against float64: {err} > {TRUNK_F32_ATOL}")
    print(f"[f32-modes] shared_trunk_f32: launches {launches}; patch probs "
          f"against the float64 trunk max|err| {err:.3g} (atol "
          f"{TRUNK_F32_ATOL}); classes {cls.tolist()}; {card}, batch "
          f"{cfg.batch} {trunk_ms:.2f} ms per batch (host clock, best of 3)")

    # ---- per_patch_f32 with classify_chunks 4 against 1 ----
    pp = build("per_patch_f32")
    chunked = FusedSRClassifyPipeline(
        pp.sr_apply, clf_apply=pp.clf_apply, lr_hw=(cfg.lr, cfg.lr),
        scale=cfg.scale, patch=cfg.patch, stride=cfg.stride,
        classify_chunks=4, device=dev)
    _, cls1, conf1 = pp(batch)
    _, cls4, conf4 = chunked(batch)
    # cuDNN may pick another algorithm for 400 patches than for 1600
    d = float((conf1 - conf4).abs().max())
    check(torch.equal(cls1, cls4) and d <= 1e-6,
          f"classify_chunks=4 differs from 1: max|d conf| {d}")
    with torch.inference_mode():
        ms1 = min(host_ms(lambda: pp(batch), sync) for _ in range(2))
        ms4 = min(host_ms(lambda: chunked(batch), sync) for _ in range(2))
    print(f"[f32-modes] per_patch_f32: classify_chunks=4 == 1 (classes equal, "
          f"max|d conf| {d:.3g}); {ms1:.2f} ms and {ms4:.2f} ms per batch of "
          f"{cfg.batch} (host clock, best of 2)")
    del pp, chunked

    # ---- entry(): the f32 reference path ----
    fn, args = entry(device=dev)
    reset_counts()
    sr_e, cls_e, conf_e = fn(*args)
    sync()
    launches = read_counts()
    shapes = [tuple(t.shape) for t in (sr_e, cls_e, conf_e)]
    check(shapes == [(2, 512, 512, 3), (2,), (2,)], f"entry() shapes {shapes}")
    check(bool(torch.isfinite(sr_e).all()) and float(sr_e.min()) >= 0.0
          and float(sr_e.max()) <= 1.0, "entry() SR not finite in [0, 1]")
    want = launches_want(conv3x3_bias_act=2 * 16 + 5)  # chained EDSR x4
    check(launches == want, f"entry() launches {launches} != {want}")
    print(f"[f32-modes] entry(): {shapes}, classes {cls_e.tolist()}, "
          f"confidences {[round(float(c), 6) for c in conf_e]}; launches "
          f"{launches}")


def phase_classic(dev, seed: int, sync, card: str) -> int:
    """The classic-SR comparison on the card over 16 pairs; returns the K4
    launches it made."""
    from tpusr_torch.classic.harness import (CLASSIC_ALGORITHMS, pair_metrics,
                                             run_classic_comparison, sr_images)
    from tpusr_torch.core import nlm
    from tpusr_torch.core.resize import resize

    g = torch.Generator(device=dev).manual_seed(seed)
    hr = torch.round(smooth_images(g, CLASSIC_PAIRS, CLASSIC_HR, 3, dev))
    lr = torch.round(resize(hr, (CLASSIC_LR, CLASSIC_LR), "area")).clamp(0, 255)
    hr_u8 = hr.to(torch.uint8).cpu().numpy()
    lr_u8 = lr.to(torch.uint8).cpu().numpy()
    del hr, lr
    repeats = 1

    # ---- the main path: the comparison over 16 pairs on the card ----
    nlm.reset_launch_counts()
    t0 = time.perf_counter()
    summary, ranked, _, stats = run_classic_comparison(
        list(hr_u8), list(lr_u8), time_repeats=repeats, device=dev)
    sync()
    wall_s = time.perf_counter() - t0
    launches = nlm.LAUNCHES["nlm_denoise"]
    # per pair: the scored run, the warm-up and the timed repeats; once per
    # shape: the memory measurement
    want = CLASSIC_PAIRS * (2 + repeats) + 1
    print(f"[classic] {CLASSIC_PAIRS} pairs HR {CLASSIC_HR}^2 / LR "
          f"{CLASSIC_LR}^2 in {wall_s:.1f} s; K4 launches {launches} "
          f"(expected {want})")
    check(launches == want, f"K4 launches {launches} != {want}")
    check(set(summary) == set(CLASSIC_ALGORITHMS), f"algorithms {set(summary)}")
    for alg in CLASSIC_ALGORITHMS:
        check(all(math.isfinite(v) for v in stats["psnr"][alg]),
              f"{alg}: PSNR not finite")
        check(all(t > 0 for t in stats["time"][alg]), f"{alg}: time")
        check(all(m > 0 for m in stats["memory"][alg]), f"{alg}: memory")
    # the reference's quirk: NLM's [0, 1] output scored against [0, 255]
    check(summary["nlm"]["psnr_mean"] < 10.0,
          f"NLM PSNR {summary['nlm']['psnr_mean']} >= 10")
    check(summary["bicubic"]["psnr_mean"] > 20.0,
          f"bicubic PSNR {summary['bicubic']['psnr_mean']} <= 20")

    # one pair on the card against the same harness on the CPU (plain twins)
    cpu = torch.device("cpu")
    hr0, lr0 = (torch.as_tensor(a.astype(np.float32)) for a in (hr_u8[0], lr_u8[0]))
    with torch.inference_mode():
        on_card = sr_images(hr0.to(dev), lr0.to(dev))
        on_cpu = sr_images(hr0, lr0)
    worst = {}
    for alg in CLASSIC_ALGORITHMS:
        a, b = on_card[alg].cpu(), on_cpu[alg]
        d = (a - b).abs()
        if alg == "nlm":     # a float image: K4 and the lanczos matmul
            check(float(d.max()) <= 1e-4, f"nlm on the card vs the CPU: "
                                          f"{float(d.max())}")
            worst[alg] = f"{float(d.max()):.2g}"
        else:                # stored uint8 values: a level at most, <= 0.1%
            n = int((d > 0).sum())
            check(float(d.max()) <= 1.0 and n <= 0.001 * d.numel(),
                  f"{alg} on the card vs the CPU: {n} values differ, max "
                  f"{float(d.max())}")
            worst[alg] = n
    metrics = pair_metrics(hr0, on_cpu)
    psnr_cpu = {a: float(metrics[a]["psnr"]) for a in CLASSIC_ALGORITHMS}
    print(f"[classic] pair 0 on the card vs the CPU: values one level apart "
          f"{worst}; PSNR card "
          + ", ".join(f"{a} {stats['psnr'][a][0]:.3f}" for a in CLASSIC_ALGORITHMS)
          + "; CPU " + ", ".join(f"{a} {psnr_cpu[a]:.3f}" for a in CLASSIC_ALGORITHMS))
    for alg in CLASSIC_ALGORITHMS:
        check(abs(stats["psnr"][alg][0] - psnr_cpu[alg]) <= 1e-3
              * abs(psnr_cpu[alg]) + 1e-3, f"{alg}: PSNR card vs CPU")
    print(f"[classic] {card}: ranking "
          + ", ".join(f"{a} {s:.4f}" for a, s in ranked))
    print("[classic] per algorithm (mean over pairs): "
          + "; ".join(f"{a} {summary[a]['time_mean'] * 1e3:.3f} ms "
                      f"{summary[a]['memory_mean'] / 1e6:.1f} MB "
                      f"PSNR {summary[a]['psnr_mean']:.2f} SSIM "
                      f"{summary[a]['ssim_mean']:.4f}" for a in CLASSIC_ALGORITHMS))
    return launches


def kernel_record(name, source, replaces, launches, tot, library) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"tpusr_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["t_ops"] >= tot["t_bytes"] else "bytes",
            "library_ms": library}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import tpusr_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = Slice()
    try:
        card = phase_environment()
        phase_build()
        k1 = phase_k1(cfg, dev)
        k3 = phase_k3(cfg, dev)
        k2 = phase_k2(cfg, dev)
        k2b = phase_k2_bf16(cfg, dev)
        k4 = phase_k4(dev)
        sync = torch.cuda.synchronize
        launches, state = phase_slice(cfg, dev, args.seed, sync, card)
        bf16_launches = phase_bf16(cfg, dev, state, sync, card)
        dequant_launches, dq = phase_int8_sr(cfg, dev, state, sync, card)
        phase_f32_modes(cfg, dev, state, sync, card)
        del state
        torch.cuda.empty_cache()
        k4_launches = phase_classic(dev, args.seed, sync, card)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        kernel_record("conv3x3_int8_requant", "conv3x3.cu",
                      "tpusr/core/pallas_conv.py:78",
                      launches["conv3x3_int8_requant"], k1, None),
        kernel_record("conv3x3_bias_act", "conv3x3.cu",
                      "tpusr/core/pallas_conv.py:123",
                      launches["conv3x3_bias_act"], k2, k2["library_ms"]),
        kernel_record("conv3x3_bias_act_bf16", "conv3x3.cu",
                      "tpusr/core/pallas_conv.py:123",
                      bf16_launches["conv3x3_bias_act_bf16"], k2b,
                      k2b["library_ms"]),
        kernel_record("nlm_denoise", "nlm.cu", "tpusr/core/pallas_nlm.py:81",
                      k4_launches, k4, None),
        kernel_record("block1_int8", "block1.cu",
                      "tpusr/models/pallas_vgg.py:275",
                      launches["block1_int8"], k3, None),
        kernel_record("conv3x3_int8_dequant", "conv3x3.cu",
                      "tpusr/models/edsr_quant.py:117", dequant_launches, dq,
                      None),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
