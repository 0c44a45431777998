#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpusr_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card with sm_90a, the CUDA
toolkit (``nvcc``) and no network. It imports no JAX. Phases, each printing
its own lines:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, the TF32 flags (off);
2. build: every CUDA source of the port, compiled with ``nvcc`` in parallel;
3. K1 (``conv3x3_int8_requant``) against its plain twin at each shape the
   serving path launches it at (13 trunk layers at the batch from 560x560,
   13 per-patch layers at the escalated patches from 96x96): bit-equal;
4. K2 (``conv3x3_bias_act``) against its plain twin at the EDSR body shapes
   and the border-band slab shapes: max |err| <= 1e-4 (fp32 sums in another
   order), with ``F.conv2d`` fp32 timed beside it as the library yardstick;
5. the slice at full width: EDSR x4 (16 blocks, 64 filters) and VGG16 (2
   classes) from ``--seed``, the classifier's last bias centered so both
   classes get votes, the shipped mode (f32 fused SR -> guarded vote_frac
   int8 cascade) served by ``PipelineServer`` at batch 16 for 20 requests,
   with the launch counts the path implies, the SR held against a plain
   chained EDSR, the int8 stage held against the same stage on K1's twin,
   and the guard-tripped cascade held against ``per_patch_int8``.

Before the last line it prints one JSON object with a record per kernel
(times are for the launches of one served batch of 16 on the healthy path;
``launches`` counts the whole served run) and the ``nvidia-smi`` line; the
last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line.
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
PEAK_OPS_PER_S = {"int8": 1979e12, "fp32": 67e12}
K2_ATOL = 1e-4       # fp32 sums of up to 9*64 terms in another order
SR_ATOL = 1e-4       # fused polyphase tail vs the chained tail, fp32


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

def vgg_conv_shapes(n: int, hw: int, widths) -> list[tuple]:
    """(N, H, W, Cin, Cout) of the 13 int8 VGG16 convs from an (n, hw, hw)
    input: pools after blocks 1-4 halve the grid."""
    from tpusr_torch.models.vgg import VGG16_CFG
    shapes, cin = [], 3
    for (block, n_convs, _f), wd in zip(VGG16_CFG, widths):
        for _ in range(n_convs):
            shapes.append((n, hw, hw, cin, wd))
            cin = wd
        if block < 5:
            hw //= 2
    return shapes


def k1_shapes(cfg: Slice) -> list[tuple[str, tuple, int]]:
    """(where, shape, launches per served batch) for K1: the shared trunk on
    the reflect-padded batch, then the per-patch path on the escalated
    images' patches."""
    from tpusr_torch.core.pad import pad_amounts
    padded = cfg.hr + pad_amounts(cfg.hr, cfg.hr, cfg.patch, cfg.stride)[0]
    trunk = vgg_conv_shapes(cfg.batch, padded, cfg.widths)
    patches = vgg_conv_shapes(cfg.escalated() * cfg.n_patches(), cfg.patch,
                              cfg.widths)
    return ([("trunk", s, 1) for s in trunk]
            + [("escalation", s, 1) for s in patches])


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


def bound(ops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """Least time in ms for ``ops`` operations and ``nbytes`` of traffic."""
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_work(shape, elem_bytes: int) -> tuple[float, float]:
    """Operations and bytes of one 3x3 conv launch: each input read once,
    each output written once, two f32 vectors per channel."""
    n, h, w, cin, cout = shape
    m = n * h * w
    ops = 2.0 * m * 9 * cin * cout
    nbytes = elem_bytes * (m * cin + 9 * cin * cout + m * cout) + 8 * cout
    return ops, nbytes


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


class k1_on_plain_twin:
    """Route the int8 backbone's convs to K1's plain twin (on the same
    device) for the duration of a reference computation."""

    def __enter__(self):
        from tpusr_torch.core import conv3x3
        from tpusr_torch.models import quant
        self._quant, self._orig = quant, quant.conv3x3_int8_requant
        quant.conv3x3_int8_requant = conv3x3.conv3x3_int8_requant_plain

    def __exit__(self, *exc):
        self._quant.conv3x3_int8_requant = self._orig


def phase_slice(cfg: Slice, dev, seed: int, sync, card: str) -> dict:
    from tpusr_torch.core import conv3x3
    from tpusr_torch.core.patches import patchify
    from tpusr_torch.models import EDSR, VGG16Classifier
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.models.quant import quantized_vgg16_apply
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

    # calibration patches as the serve command takes them: the first 64
    # patches of the f32 SR of 4 calibration images
    fn, r = make_fused_sr_apply(edsr)
    with torch.inference_mode():
        sr_cal = pixel_shuffle(fn(torch.as_tensor(calib_lr, device=dev)), r)
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
    conv3x3.reset_launch_counts()
    votes.guard_trips = 0
    server = PipelineServer(pipe, batch_size=cfg.batch, max_wait_ms=50.0)
    futures = [server.submit(im) for im in requests]
    t0 = time.perf_counter()
    with server:
        results = [f.result(timeout=600) for f in futures]
    served_s = time.perf_counter() - t0
    launches = dict(conv3x3.LAUNCHES)
    trips = votes.guard_trips
    last_escalated = votes.last_escalated.cpu()

    n_batches = math.ceil(cfg.requests / cfg.batch)
    per_batch_k1 = len(k1_shapes(cfg))
    per_batch_k2 = sum(m for *_, m in k2_shapes(cfg))
    n_layers = per_batch_k1 // 2
    want = {"conv3x3_int8_requant": n_batches * per_batch_k1 + trips * n_layers,
            "conv3x3_bias_act": n_batches * per_batch_k2}
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
        with k1_on_plain_twin():
            cls_p, conf_p = votes(srq, cfg.batch)
        check(torch.equal(cls_p, cls_b)
              and torch.allclose(conf_p, conf_b, rtol=0, atol=1e-6),
              "cascade on K1's twin differs from the served cascade")
        tripped = variant(cascade_votes=cascade(0.0))    # always trips
        per_patch = variant(
            clf_apply=lambda p: quantized_vgg16_apply(pipe.qtree, p))
        _, cls_g, conf_g = tripped(batch)
        _, cls_pp, conf_pp = per_patch(batch)
        check(tripped.cascade_votes.guard_trips == 1, "guard 0.0 did not trip")
        check(torch.equal(cls_g, cls_pp) and torch.equal(conf_g, conf_pp),
              "guard-tripped cascade differs from per_patch_int8")
    print(f"[slice] SR vs plain chained EDSR max|err| {sr_err:.3g} (atol "
          f"{SR_ATOL}); cascade on K1's twin equal; guard-tripped cascade "
          f"== per_patch_int8 (classes {cls_pp.tolist()})")

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
    return launches


def kernel_record(name, replaces, launches, tot, library) -> dict:
    return {"name": name, "route": "cuda",
            "source": "tpusr_torch/csrc/conv3x3.cu", "replaces": replaces,
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
        k2 = phase_k2(cfg, dev)
        launches = phase_slice(cfg, dev, args.seed, torch.cuda.synchronize,
                               card)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        kernel_record("conv3x3_int8_requant", "tpusr/core/pallas_conv.py:78",
                      launches["conv3x3_int8_requant"], k1, None),
        kernel_record("conv3x3_bias_act", "tpusr/core/pallas_conv.py:123",
                      launches["conv3x3_bias_act"], k2, k2["library_ms"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
