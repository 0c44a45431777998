"""Protocol-scale serving gate on the port's trainers (port of
``tpusr/tools/serving_gate.py``).

Each serving mode deviates numerically from the f32 per-patch reference
path (VGG16_model.py:168-270 protocol). The gate measures every mode
against that path at protocol scale (512x512 SR images, 96x96 patches,
stride 48, a 100-patch majority vote) on weights it trains itself:

1. a synthetic 3D-print-surface dataset: smooth background against
   periodic ridge "z-offset" stripes, the reference's 2-class task;
2. the full VGG16 classifier trained on 96x96 HR crops and the full EDSR x4
   on aligned LR/HR crops, briefly, on the card (``ClassifierTrainer``,
   ``SupervisedSRTrainer``; EDSR's convs and their input gradients on K2);
3. the nine serving configurations over N protocol images, with patch-vote
   agreement, confidence drift, accuracy and SR PSNR/SSIM drift (an
   SR-modifying mode is "image_faithful" only >= 35 dB against the f32 SR),
   and the cascade rows derived from their votes.

Names, arguments, defaults, CLI flags and report keys are the JAX tool's.
Where the port differs:

- every tensor stays on one device, the card unless the caller passes
  ``device="cpu"``; only scalars and (N,)-vectors come back to the host;
- the data, the crop pools, the batches and the initial weights are JAX's
  draws (``tpusr_torch.core.prng``): ``split(PRNGKey(seed), 9)`` for the
  surfaces, ``split(PRNGKey(seed), 3)`` for a crop pool,
  ``randint(fold_in(PRNGKey(seed), step))`` for a step's batch, and the
  networks start from flax's ``init`` at ``PRNGKey(42)``, as the JAX
  trainers' ``init_state``; what differs is the training arithmetic
  (cuDNN's float32 against XLA's);
- the per-patch vote path takes a function of whole images, so that the
  int8 classifier runs block 1 on K3 fused with the patch extraction;
- ``train_classifier`` and ``train_edsr`` return the trained modules, the
  port's form of a parameter tree;
- cuDNN is held to deterministic algorithms while the gate trains and
  scores, so that a seed's run reproduces bit for bit, as ``gate_merge``
  requires (one seed's VGG16 training diverged in one run and learned in
  another without it);
- ``main`` writes ``GATE_torch.json`` by default and records the card's name
  and power limit in the report's ``device`` field.

Run:  python -m tpusr_torch.tools.serving_gate --task hard --seeds 0,1,2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import time

import numpy as np
import torch

from tpusr_torch.core import prng
from tpusr_torch.core.pad import pad_amounts
from tpusr_torch.core.patches import patch_grid_size
from tpusr_torch.core.resize import resize
from tpusr_torch.device import resolve_device
from tpusr_torch.metrics.image import psnr as psnr_fn, ssim as ssim_fn
from tpusr_torch.models import EDSR, VGG16Classifier
from tpusr_torch.models.block1 import extract_patches_reference
from tpusr_torch.models.edsr_fast import make_fused_sr_apply
from tpusr_torch.models.edsr_quant import make_fused_sr_apply_int8
from tpusr_torch.models.layers import pixel_shuffle
from tpusr_torch.models.quant import (calibrate_vgg16, per_patch_int8_probs,
                                      quantize_vgg16)
from tpusr_torch.models.vgg_trunk import (shared_trunk_probs_f32,
                                          shared_trunk_probs_int8)
from tpusr_torch.pipeline.defect_pipeline import _vote
from tpusr_torch.train import ClassifierTrainer, SupervisedSRTrainer

PATCH, STRIDE = 96, 48
INIT_SEED = 42      # the JAX trainers' init_state key is PRNGKey(42)


# --------------------------------------------------------------- dataset
def _bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of ``jax.image.resize(..., "bicubic")`` when
    it enlarges: Keys' cubic with a = -0.5 at half-pixel centres, each row
    renormalised over the taps that fall inside the image. (Not the
    cv2-parity bicubic of ``core/resize.py``: a = -0.75, clamped taps.)"""
    if out_size < in_size:
        raise ValueError(f"enlarging only: {in_size} -> {out_size}")
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    taps = np.floor(src).astype(np.int64)[:, None] + np.arange(-1, 3)
    d = np.abs(src[:, None] - taps)
    a = -0.5
    w = np.where(d <= 1.0, ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0,
                 np.where(d < 2.0, (((d - 5.0) * d + 8.0) * d - 4.0) * a, 0.0))
    w = np.where((taps >= 0) & (taps < in_size), w, 0.0)
    w /= w.sum(axis=1, keepdims=True)
    out = np.zeros((out_size, in_size))
    np.add.at(out, (np.repeat(np.arange(out_size), 4),
                    np.clip(taps, 0, in_size - 1).ravel()), w.ravel())
    return out


def _bicubic_upsample(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, h, w, C) -> (N, size, size, C) float32, as ``jax.image.resize``'s
    bicubic enlarges, computed in float64."""
    wh = torch.from_numpy(_bicubic_weights(x.shape[1], size)).to(x.device)
    ww = torch.from_numpy(_bicubic_weights(x.shape[2], size)).to(x.device)
    y = torch.einsum("oi,nijc->nojc", wh, x.double())
    return torch.einsum("pj,nojc->nopc", ww, y).float()


def _surface_keys(seed: int) -> list:
    return prng.split(prng.PRNGKey(seed), 9)


def _surface_order(seed: int, n: int) -> torch.Tensor:
    """The shuffle of ``make_surface_images(seed, n)``: JAX's
    ``permutation(ks[6], n)``, drawn on the CPU whatever the images'
    device, so that ``surface_labels`` needs no card."""
    return prng.permutation(_surface_keys(seed)[6], n)


def surface_draws(seed: int, n: int, size: int = 512,
                  amp_range=(0.12, 0.25), coverage_range=(1.0, 1.0),
                  device=None) -> dict:
    """The random draws of ``make_surface_images``: JAX's, from ``ks =
    split(PRNGKey(seed), 9)``, on ``device`` (``ks[6]``'s permutation on
    the CPU). ``nz`` is the unit normal noise, before the ``noise``
    scale."""
    dev = resolve_device(device)
    cells = size // 32 + 1
    ks = _surface_keys(seed)

    def uniform(k, shape, lo, hi):
        return prng.uniform(ks[k], shape, lo, hi, dev)

    return {"bg_small": uniform(0, (n, cells, cells, 1), 0.3, 0.7),
            "theta": uniform(1, (n,), 0.0, np.pi),
            "period": uniform(2, (n,), 32.0, 64.0),
            "phase": uniform(3, (n,), 0.0, 2 * np.pi),
            "amp": uniform(4, (n,), *amp_range),
            "nz": prng.normal(ks[5], (n, size, size, 3), dev),
            "order": _surface_order(seed, n).to(dev),
            "cov": uniform(7, (n,), *coverage_range),
            "phi": uniform(8, (n,), 0.0, np.pi)}


def build_surface_images(draws: dict, size: int, noise: float = 0.01):
    """The images and labels of ``make_surface_images`` from its draws
    (``surface_draws``, or JAX's own), each step in the order and float32
    rounding of JAX's ``make_surface_images``."""
    bg_small = draws["bg_small"]
    n, dev = bg_small.shape[0], bg_small.device
    bg = _bicubic_upsample(bg_small, size)
    labels = torch.arange(n, device=dev) % 2
    yy, xx = torch.meshgrid(torch.arange(size, device=dev, dtype=torch.float32),
                            torch.arange(size, device=dev, dtype=torch.float32),
                            indexing="ij")

    def per_image(v):
        return v[:, None, None]

    proj = (xx * per_image(torch.cos(draws["theta"]))
            + yy * per_image(torch.sin(draws["theta"])))
    wave = torch.sin(2 * math.pi * proj / per_image(draws["period"])
                     + per_image(draws["phase"]))
    stripe = (per_image(labels.float()) * per_image(draws["amp"]) * wave)[..., None]
    # partial-coverage band: stripes only where the projection onto a second
    # random direction falls below the per-image coverage cut
    band = (xx * per_image(torch.cos(draws["phi"]))
            + yy * per_image(torch.sin(draws["phi"])))
    bmin = band.amin(dim=(1, 2), keepdim=True)
    bmax = band.amax(dim=(1, 2), keepdim=True)
    u = (band - bmin) / (bmax - bmin)
    stripe = stripe * (u <= per_image(draws["cov"]))[..., None]
    tint = torch.tensor([1.0, 0.96, 0.9], device=dev)
    img = torch.clamp((bg + stripe) * tint + draws["nz"] * noise, 0.0, 1.0)
    order = draws["order"]
    return img[order], labels[order].to(torch.int32)


def make_surface_images(seed: int, n: int, size: int = 512,
                        amp_range=(0.12, 0.25), noise: float = 0.01,
                        coverage_range=(1.0, 1.0), device=None):
    """Synthetic print-surface dataset: class 0 = smooth extrusion, class 1 =
    periodic ridge stripes (z-offset defect look). Returns (hr [n, s, s, 3]
    float32 [0, 1], labels [n] int32) on ``device``, balanced and shuffled.

    ``coverage_range`` is the task-difficulty lever: each defect image's
    stripes cover only a random fraction of the surface (a half-plane band),
    so the image-level vote of a low-coverage defect image sits near the 50%
    boundary while patch-level discrimination stays easy (``TASKS``)."""
    return build_surface_images(
        surface_draws(seed, n, size, amp_range, coverage_range, device),
        size, noise)


def surface_labels(seed: int, n: int) -> np.ndarray:
    """The labels ``make_surface_images(seed, n, ...)`` returns, without
    building the images: ``arange(n) % 2`` in the order of its shuffle, drawn
    on the CPU on any device. Offline tools (``gate_rederive``) recover the
    eval labels of a stored gate run this way."""
    labels = torch.arange(n) % 2
    return labels[_surface_order(seed, n)].numpy().astype(np.int32)


def make_crop_pool(seed: int, imgs: torch.Tensor, labels: torch.Tensor, k: int,
                   crop: int, align: int = 1):
    """k random crops as a pool on the images' device: (crops, labels,
    (idx, y0, x0)). ``align`` keeps offsets divisible (for scale-aligned
    LR/HR pairs). JAX's draws: ``randint`` on ``split(PRNGKey(seed), 3)``."""
    n, h, w, _ = imgs.shape
    dev = imgs.device
    k1, k2, k3 = prng.split(prng.PRNGKey(seed), 3)
    idx = prng.randint(k1, (k,), 0, n, dev)
    y0 = prng.randint(k2, (k,), 0, (h - crop) // align + 1, dev) * align
    x0 = prng.randint(k3, (k,), 0, (w - crop) // align + 1, dev) * align
    r = torch.arange(crop, device=dev)
    crops = imgs[idx[:, None, None], (y0[:, None] + r)[:, :, None],
                 (x0[:, None] + r)[:, None, :]]
    return crops, labels[idx], (idx, y0, x0)


# --------------------------------------------------------------- training
@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms while open (its
    backward convs otherwise may sum in a different order on every run)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _with_params(model, state):
    """``model`` with the trained parameters of a trainer's ``state``."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.params[name])
    return model


def classifier_pool(hr, labels, seed=0):
    """``train_classifier``'s pool of 2048 96x96 crops from ``hr`` (crop
    seed ``seed + 100``), half of it through a downscale -> upscale cycle so
    the trained classifier is robust on SR-reconstructed surfaces (the
    serving domain): (crops, labels) on the images' device."""
    pool_x, pool_y, _ = make_crop_pool(seed + 100, hr, labels, 2048, PATCH)
    half = pool_x.shape[0] // 2
    cycled = resize(resize(pool_x[:half], (PATCH // 4, PATCH // 4), "area"),
                    (PATCH, PATCH), "bicubic")
    return torch.cat([cycled.clamp(0.0, 1.0), pool_x[half:]]), pool_y


def classifier_batch(pool_x, pool_y, step: int, batch: int = 64, seed=0):
    """Step ``step``'s batch of ``train_classifier``: rows
    ``randint(fold_in(PRNGKey(seed), step))`` of the pool."""
    idx = prng.randint(prng.fold_in(prng.PRNGKey(seed), step), (batch,), 0,
                       pool_x.shape[0], pool_x.device)
    return pool_x[idx], pool_y[idx]


@_deterministic_cudnn()
def train_classifier(hr, labels, steps=500, batch=64, seed=0, verbose=False):
    """Brief training of the full-size VGG16Classifier on 96x96 crops from a
    pool on the images' device. Returns (model, final train-batch accuracy)."""
    dev = hr.device
    pool_x, pool_y = classifier_pool(hr, labels, seed)
    model = VGG16Classifier(num_classes=2, device=dev, key=INIT_SEED)
    trainer = ClassifierTrainer(model, learning_rate=2e-4, device=dev)
    state = trainer.init_state()
    acc = None
    for step in range(steps):
        state, m = trainer.train_step(
            state, *classifier_batch(pool_x, pool_y, step, batch, seed), step)
        if verbose and (step + 1) % 100 == 0:
            print(f"  clf step {step + 1}: loss={float(m['loss']):.4f} "
                  f"acc={float(m['accuracy']):.3f}", flush=True)
        acc = m["accuracy"]
    return _with_params(model, state), float(acc)


@_deterministic_cudnn()
def train_edsr(hr, steps=300, batch=16, seed=1, scale=4, verbose=False):
    """Brief training of the full 16-block EDSR x4 on aligned area-downscale
    LR/HR crops (the reference's degradation geometry), on the images'
    device. Returns the model."""
    dev = hr.device
    crop_hr = 128
    pool_hr, _, _ = make_crop_pool(seed + 200, hr, hr[:, 0, 0, 0], 1024,
                                   crop_hr, align=scale)
    pool_lr = resize(pool_hr, (crop_hr // scale, crop_hr // scale), "area")
    model = EDSR(scale_factor=scale, device=dev, key=INIT_SEED)
    trainer = SupervisedSRTrainer(model, learning_rate=1e-4, device=dev)
    state = trainer.init_state()
    key = prng.PRNGKey(seed)
    for step in range(steps):
        sel = prng.randint(prng.fold_in(key, step), (batch,), 0,
                           pool_hr.shape[0], dev)
        state, m = trainer.train_step(state, pool_lr[sel], pool_hr[sel])
        if verbose and (step + 1) % 100 == 0:
            print(f"  edsr step {step + 1}: loss={float(m['loss']):.5f} "
                  f"psnr={float(m['psnr']):.2f}", flush=True)
    return _with_params(model, state)


# ------------------------------------------------------------ vote paths
def _chunked(fn, x: torch.Tensor, chunk: int) -> list:
    """``fn`` (a tuple of tensors per call) over full chunks of ``x``, then
    over the last ``chunk`` rows with the results sliced to the remainder,
    as the JAX tool chunks; the outputs concatenated per position."""
    n = x.shape[0]
    outs = [fn(x[s:s + chunk]) for s in range(0, n - chunk + 1, chunk)]
    rem = n % chunk
    if rem:
        outs.append(tuple(t[-rem:] for t in fn(x[-chunk:])))
    return [torch.cat(col) for col in zip(*outs)]


def patch_probs(clf_apply):
    """A per-patch classifier on extracted patches, ``clf_apply(patches) ->
    (M, classes)``, as a function of whole images for ``per_patch_votes``:
    the reference's reflect-padded 96/48 patches of each image."""
    def fn(images):
        probs = clf_apply(extract_patches_reference(images, PATCH, STRIDE))
        return probs.reshape(images.shape[0], -1, probs.shape[-1])
    return fn


def _votes(fn, images: torch.Tensor, chunk: int, with_scores: bool):
    """Per-image votes of ``fn(block) -> (nb, n_patches, classes)`` probs,
    chunked as the JAX tool chunks, as numpy arrays."""
    vote = _vote_scores if with_scores else _vote
    with torch.inference_mode():
        cols = _chunked(lambda b: vote(fn(b)), images, chunk)
    return tuple(c.cpu().numpy() for c in cols)


def per_patch_votes(clf_probs_fn, sr_images: torch.Tensor, chunk=8):
    """The reference protocol: reflect-pad, classify every 96/48 patch on its
    own, majority-vote (VGG16_model.py:168-270). ``clf_probs_fn(images) ->
    (nb, n_patches, classes)`` classifies the patches of a chunk of images
    (``patch_probs`` of a patch classifier, or ``quant.per_patch_int8_probs``
    whose block 1 K3 fuses with the extraction). Returns numpy (classes,
    confidences)."""
    return _votes(clf_probs_fn, sr_images, chunk, with_scores=False)


def _vote_scores(probs: torch.Tensor):
    """``_vote`` plus the cascade's trunk-side ranking signals, for (..., P,
    C) probabilities. vote_frac: the fraction of patches whose argmax agrees
    with the final vote (the patch disagreement `_vote`'s mean-probability
    confidence can hide). mean_margin: the mean top-2 probability gap across
    patches."""
    cls, conf = _vote(probs)
    preds = probs.argmax(dim=-1)
    vote_frac = (preds == cls[..., None]).float().mean(dim=-1)
    top2 = torch.sort(probs, dim=-1).values
    mean_margin = (top2[..., -1] - top2[..., -2]).mean(dim=-1)
    return cls, conf, vote_frac, mean_margin


def shared_trunk_votes(fn, sr_images: torch.Tensor, chunk=16,
                       with_scores=False):
    """fn(block) -> (nb, n_patches, classes) probs (f32 or int8 trunk).
    Returns numpy (classes, confidences), and with ``with_scores`` also the
    per-image cascade ranking scores (vote_frac, mean_margin)."""
    return _votes(fn, sr_images, chunk, with_scores)


def _apply_sr(fn, r, lr_images: torch.Tensor, chunk=16) -> torch.Tensor:
    """SR a batch chunk-wise, float32; the result stays on the device."""
    with torch.inference_mode():
        return _chunked(lambda x: (pixel_shuffle(fn(x), r).float(),),
                        lr_images, chunk)[0]


# ------------------------------------------------------------------ gate
BOUNDARY_CONF = 0.65  # ref-confidence below this marks a "boundary" image
# trunk-confidence escalation thresholds certified for the serving cascade
CASCADE_THRESHOLDS = (0.60, 0.70, 0.80, 0.90)
# static top-K escalation fractions certified for the serving cascade (the
# JAX tool's sweep: steps of 1/32 and single images at N=128 around the
# certified minimum)
CASCADE_FRACS = (0.15625, 0.1875, 0.21875, 0.25, 0.265625, 0.2734375,
                 0.28125, 0.296875, 0.3046875, 0.3125, 0.375, 0.5)
# Trunk-collapse guard (cascade.py guard_threshold): past it, the escalated
# subset's trunk-vs-per-patch disagreement re-serves the whole batch
# per-patch (correctness-safe: full per-patch is the certified path)
CASCADE_GUARD_THRESHOLD = 0.6


def gate_row_name(sr_mode: str, clf_mode: str, border: bool = True,
                  cascade_score: str = "conf",
                  cascade_frac: float | None = None,
                  cascade_guard: bool = False) -> str:
    """The gate mode-row name a make_serving_pipeline configuration maps to.
    Raises on configurations the gate does not certify."""
    if clf_mode == "cascade_int8":
        if sr_mode not in ("f32", "bf16"):
            raise ValueError("the gate certifies the cascade on f32/bf16 SR "
                             f"only (got sr_mode={sr_mode!r})")
        if cascade_frac is None:
            raise ValueError("cascade_int8 needs cascade_frac")
        prefix = "cascade_int8" if sr_mode == "f32" else "bf16_sr_cascade_int8"
        score = cascade_score + ("+guard" if cascade_guard else "")
        return f"{prefix}[{score}]@frac={cascade_frac}"
    key = {
        ("f32", "per_patch_int8", True): "int8_per_patch",
        ("f32", "shared_trunk_f32", True): "shared_trunk_f32",
        ("f32", "shared_trunk_int8", True): "shared_trunk_int8",
        ("bf16", "per_patch_int8", True): "bf16_sr_per_patch_int8",
        ("bf16", "shared_trunk_int8", True): "bf16_sr_shared_trunk_int8",
        ("int8", "per_patch_f32", True): "int8_sr_f32_per_patch",
        ("int8", "per_patch_int8", True): "int8_sr_per_patch_int8",
        ("int8", "shared_trunk_int8", True): "int8_sr_shared_trunk_int8",
        ("int8", "shared_trunk_int8", False):
            "int8_sr_noborder_shared_trunk_int8",
    }.get((sr_mode, clf_mode, border))
    if key is None:
        raise ValueError(f"no gate row for sr_mode={sr_mode!r} "
                         f"clf_mode={clf_mode!r} border={border} "
                         "(per_patch_f32 on f32 SR is the reference path "
                         "itself; other combos were never gated)")
    return key


def _lex_score(vote_frac, conf, n_patches):
    """vote_frac primary, conf tie-break, exactly lexicographic: vote_frac
    is quantized to 1/n_patches steps and conf <= 1, so conf scaled by half
    a quantum can never cross a vote_frac step."""
    return vote_frac + conf * (0.5 / n_patches)


def cascade_rank_analysis(raw_votes, ref_cls, trunk_scores, n_patches=100,
                          trunk_mode="shared_trunk_int8"):
    """Per ranking score, the ranks of the trunk's flips against the
    reference and (max flip rank + 1)/N, the least zero-flip static
    escalation fraction; 'vote_frac+conf' is the lexicographic score the
    cascade runs for escalate_score='vote_frac'."""
    if trunk_mode not in raw_votes or trunk_scores is None:
        return None
    cls_t, conf_t = raw_votes[trunk_mode]
    n = len(cls_t)
    flips = np.flatnonzero(np.asarray(cls_t) != np.asarray(ref_cls))
    scores = {"conf": np.asarray(conf_t),
              **{k: np.asarray(v) for k, v in trunk_scores.items()}}
    scores["vote_frac+conf"] = _lex_score(scores["vote_frac"],
                                          scores["conf"], n_patches)
    out = {"n_images": n, "trunk_flips": int(flips.size), "scores": {}}
    for name, s in scores.items():
        order = np.argsort(s, kind="stable")
        rank_of = np.empty(n, np.int64)
        rank_of[order] = np.arange(n)
        franks = sorted(int(rank_of[i]) for i in flips)
        out["scores"][name] = {
            "flip_ranks": franks,
            "min_zero_flip_escalation_frac":
                0.0 if not franks else (franks[-1] + 1) / n,
        }
    return out


# cascade parent pairs: derived-row prefix -> (trunk mode, per-patch mode)
CASCADE_PARENTS = {
    "cascade_int8": ("shared_trunk_int8", "int8_per_patch"),
    "bf16_sr_cascade_int8": ("bf16_sr_shared_trunk_int8",
                             "bf16_sr_per_patch_int8"),
}


def derive_cascade_modes(raw_votes, ref_cls, ref_conf, labels_h,
                         trunk_scores=None, n_patches=100,
                         parents=("shared_trunk_int8", "int8_per_patch"),
                         prefix="cascade_int8"):
    """Derived cascade rows, a numpy merge of two parents' votes: the
    trunk's votes with the low-scored images escalated to the per-patch
    path, at every ``CASCADE_THRESHOLDS`` confidence threshold and, per
    ranking score, every ``CASCADE_FRACS`` static top-K fraction, each also
    with the trunk-collapse guard (``[score+guard]``)."""
    trunk_mode, pp_mode = parents
    if not (trunk_mode in raw_votes and pp_mode in raw_votes):
        return []
    cls_t, conf_t = raw_votes[trunk_mode]
    cls_p, conf_p = raw_votes[pp_mode]
    out = []

    def add(name, esc):
        cls_c = np.where(esc, cls_p, cls_t)
        conf_c = np.where(esc, conf_p, conf_t)
        entry = _compare(name, ref_cls, ref_conf, cls_c, conf_c, labels_h)
        entry["escalation_fraction"] = float(esc.mean())
        # flips remaining on non-escalated images: the cascade's only
        # failure channel (escalated images carry certified votes)
        entry["unescalated_flips"] = int(((cls_c != ref_cls) & ~esc).sum())
        out.append(entry)

    for T in CASCADE_THRESHOLDS:
        add(f"{prefix}@{T:.2f}", conf_t < T)

    rank_scores = {"conf": np.asarray(conf_t)}
    if trunk_scores is not None and "vote_frac" in trunk_scores:
        rank_scores["vote_frac"] = _lex_score(
            np.asarray(trunk_scores["vote_frac"]), np.asarray(conf_t),
            n_patches)
    n = len(cls_t)
    for sname, s in rank_scores.items():
        for frac in CASCADE_FRACS:
            k = max(1, round(n * frac))
            # k lowest-scored images, ties to lower index (the cascade's
            # stable sort)
            esc = np.zeros(n, bool)
            esc[np.argsort(s, kind="stable")[:k]] = True
            add(f"{prefix}[{sname}]@frac={frac}", esc)
            # guarded twin: past the threshold the whole batch serves
            # per-patch votes
            canary = float((cls_p[esc] != cls_t[esc]).mean())
            gesc = np.ones(n, bool) if canary >= CASCADE_GUARD_THRESHOLD \
                else esc
            add(f"{prefix}[{sname}+guard]@frac={frac}", gesc)
            out[-1]["guard_canary"] = canary
            out[-1]["guard_triggered"] = bool(
                canary >= CASCADE_GUARD_THRESHOLD)
    return out


def _compare(name, ref_cls, ref_conf, cls, conf, labels_h):
    agree = float((cls == ref_cls).mean())
    flips = int((cls != ref_cls).sum())
    # boundary images: where the reference vote itself is least certain
    nearb = ref_conf < BOUNDARY_CONF
    out = {
        "mode": name,
        "vote_agreement": agree,
        "flips": flips,
        "mean_abs_conf_drift": float(np.abs(conf - ref_conf).mean()),
        "max_abs_conf_drift": float(np.abs(conf - ref_conf).max()),
        "accuracy": float((cls == labels_h).mean()),
        "pred_class1_frac": float((cls == 1).mean()),
        "boundary_images": int(nearb.sum()),
    }
    if nearb.any():
        out["boundary_vote_agreement"] = float((cls[nearb]
                                                == ref_cls[nearb]).mean())
        out["boundary_max_abs_conf_drift"] = float(
            np.abs(conf[nearb] - ref_conf[nearb]).max())
    return out


@_deterministic_cudnn()
def run_gate(n_images=128, size=512, clf_steps=500, edsr_steps=600, seed=0,
             verbose=True, mode_names=None, amp_range=(0.12, 0.25),
             noise=0.01, coverage_range=(1.0, 1.0), device=None):
    """Train at protocol scale on ``device`` (CUDA unless ``device="cpu"``),
    evaluate every serving mode (or ``mode_names``), return the gate report
    dict. ``coverage_range`` sets the task's difficulty
    (``make_surface_images``)."""
    t0 = time.time()
    dev = resolve_device(device)
    scale = 4
    lr_hw = size // scale
    n_train = max(64, n_images // 2)

    def log(msg):
        if verbose:
            print(f"[gate {time.time() - t0:6.0f}s] {msg}", flush=True)

    log(f"dataset: {n_train} train + {n_images} eval images ({size}x{size}) "
        f"amp={amp_range} noise={noise} coverage={coverage_range}")
    hr_train, y_train = make_surface_images(seed, n_train, size, amp_range,
                                            noise, coverage_range, device=dev)
    hr_eval, y_eval_dev = make_surface_images(seed + 1, n_images, size,
                                              amp_range, noise, coverage_range,
                                              device=dev)
    y_eval = y_eval_dev.cpu().numpy()

    log(f"training VGG16 classifier ({clf_steps} steps)...")
    clf, train_acc = train_classifier(hr_train, y_train, steps=clf_steps,
                                      verbose=verbose)
    log(f"classifier final train-batch acc: {train_acc:.3f}")
    log(f"training EDSR x4 ({edsr_steps} steps)...")
    edsr = train_edsr(hr_train, steps=edsr_steps, verbose=verbose)

    # protocol LR inputs (area downscale like the degradation model's resize)
    lr_eval = resize(hr_eval, (lr_hw, lr_hw), "area")

    # build only the SR variants some requested mode consumes
    want = (lambda n: mode_names is None or n in mode_names)
    need_int8_sr = (want("int8_sr_f32_per_patch")
                    or want("int8_sr_per_patch_int8")
                    or want("int8_sr_shared_trunk_int8"))
    need_int8_sr_nb = want("int8_sr_noborder_shared_trunk_int8")
    need_bf16_sr = (want("bf16_sr_per_patch_int8")
                    or want("bf16_sr_shared_trunk_int8"))

    log("building SR variants...")
    f32_fn, r = make_fused_sr_apply(edsr, torch.float32)
    sr_f32 = _apply_sr(f32_fn, r, lr_eval)
    sr_int8 = sr_int8_nb = sr_bf16 = None
    psnr_sr_drift = psnr_sr_nb_drift = psnr_sr_bf16_drift = None
    ssim_sr_drift = ssim_sr_nb_drift = ssim_sr_bf16_drift = None

    def _sr_drift(variant, chunk=16):
        # mean PSNR/SSIM of the variant's SR image against the f32 SR image,
        # chunked to bound memory at any --images; one host read
        with torch.inference_mode():
            ps = torch.cat([psnr_fn(sr_f32[s:s + chunk], variant[s:s + chunk])
                            for s in range(0, sr_f32.shape[0], chunk)])
            ss = torch.cat([ssim_fn(sr_f32[s:s + chunk], variant[s:s + chunk])
                            for s in range(0, sr_f32.shape[0], chunk)])
            return tuple(float(v) for v in
                         torch.stack([ps.double().mean(), ss.double().mean()]))

    if need_int8_sr:
        q_fn, _ = make_fused_sr_apply_int8(edsr, sample_lr=lr_eval[:4])
        sr_int8 = _apply_sr(q_fn, r, lr_eval)
        psnr_sr_drift, ssim_sr_drift = _sr_drift(sr_int8)
    if need_int8_sr_nb:
        q_fn_nb, _ = make_fused_sr_apply_int8(edsr, sample_lr=lr_eval[:4],
                                              border_correction=False)
        sr_int8_nb = _apply_sr(q_fn_nb, r, lr_eval)
        psnr_sr_nb_drift, ssim_sr_nb_drift = _sr_drift(sr_int8_nb)
    if need_bf16_sr:
        bf16_fn, _ = make_fused_sr_apply(edsr, torch.bfloat16)
        sr_bf16 = _apply_sr(bf16_fn, r, lr_eval)
        psnr_sr_bf16_drift, ssim_sr_bf16_drift = _sr_drift(sr_bf16)

    # classifier variants
    calib, _, _ = make_crop_pool(seed + 300, hr_train, y_train, 32, PATCH)
    qtree = quantize_vgg16(clf, calibrate_vgg16(clf, calib))
    f32_probs = patch_probs(clf)

    def int8_probs(images):
        return per_patch_int8_probs(qtree, images, PATCH, STRIDE)

    def int8_trunk(images):
        return shared_trunk_probs_int8(qtree, images, PATCH, STRIDE)

    log("A: f32 SR + f32 per-patch (reference path)...")
    ref_cls, ref_conf = per_patch_votes(f32_probs, sr_f32)
    report = {
        "protocol": {"images": n_images, "size": size, "patch": PATCH,
                     "stride": STRIDE,
                     "patches_per_image": 100 if size == 512 else None,
                     "amp_range": list(amp_range), "noise": noise,
                     "coverage_range": list(coverage_range)},
        "training": {"clf_steps": clf_steps, "edsr_steps": edsr_steps,
                     "clf_final_train_acc": train_acc},
        "seed": seed,
        "reference_accuracy": float((ref_cls == y_eval).mean()),
        "reference_boundary_images": int((ref_conf < BOUNDARY_CONF).sum()),
        "psnr_int8_sr_vs_f32_sr_db": psnr_sr_drift,
        "psnr_int8_noborder_sr_vs_f32_sr_db": psnr_sr_nb_drift,
        "psnr_bf16_sr_vs_f32_sr_db": psnr_sr_bf16_drift,
        "ssim_int8_sr_vs_f32_sr": ssim_sr_drift,
        "ssim_int8_noborder_sr_vs_f32_sr": ssim_sr_nb_drift,
        "ssim_bf16_sr_vs_f32_sr": ssim_sr_bf16_drift,
        "modes": [],
    }

    runs = [
        ("int8_per_patch", lambda: per_patch_votes(int8_probs, sr_f32)),
        ("shared_trunk_f32",
         lambda: shared_trunk_votes(
             lambda b: shared_trunk_probs_f32(clf, b, PATCH, STRIDE), sr_f32)),
        ("shared_trunk_int8",
         lambda: shared_trunk_votes(int8_trunk, sr_f32, with_scores=True)),
        ("int8_sr_f32_per_patch", lambda: per_patch_votes(f32_probs, sr_int8)),
        # bench frontier mode: int8 SR + the reference patch protocol with
        # int8 numerics (no shared trunk)
        ("int8_sr_per_patch_int8", lambda: per_patch_votes(int8_probs, sr_int8)),
        ("int8_sr_shared_trunk_int8",
         lambda: shared_trunk_votes(int8_trunk, sr_int8)),
        # the bench serving configuration: composed-tail SR without the
        # chained-tail border band
        ("int8_sr_noborder_shared_trunk_int8",
         lambda: shared_trunk_votes(int8_trunk, sr_int8_nb)),
        # bf16-SR serving pair: the same int8 classifier parents on the bf16
        # SR image
        ("bf16_sr_per_patch_int8", lambda: per_patch_votes(int8_probs, sr_bf16)),
        ("bf16_sr_shared_trunk_int8",
         lambda: shared_trunk_votes(int8_trunk, sr_bf16, with_scores=True)),
    ]
    if mode_names is not None:  # subset for cheap harness smokes
        runs = [(n, f) for n, f in runs if n in mode_names]
    raw_votes, trunk_scores_by_mode = {}, {}
    for name, fn in runs:
        log(f"{name}...")
        res = fn()
        cls, conf = res[0], res[1]
        if len(res) == 4:  # a trunk mode carries cascade rank scores
            trunk_scores_by_mode[name] = {"vote_frac": res[2],
                                          "mean_margin": res[3]}
        raw_votes[name] = (cls, conf)
        report["modes"].append(_compare(name, ref_cls, ref_conf, cls, conf,
                                        y_eval))

    pad_h, pad_w = pad_amounts(size, size, PATCH, STRIDE)
    nh, nw = patch_grid_size(size + pad_h, size + pad_w, PATCH, STRIDE)
    n_patches = nh * nw
    for prefix, (tname, pname) in CASCADE_PARENTS.items():
        ts = trunk_scores_by_mode.get(tname)
        report["modes"].extend(
            derive_cascade_modes(raw_votes, ref_cls, ref_conf, y_eval,
                                 trunk_scores=ts, n_patches=n_patches,
                                 parents=(tname, pname), prefix=prefix))
        rank = cascade_rank_analysis(raw_votes, ref_cls, ts, n_patches,
                                     trunk_mode=tname)
        if rank is not None:
            key = ("cascade_rank_analysis" if prefix == "cascade_int8"
                   else f"{prefix}_rank_analysis")
            report[key] = rank

    # raw per-image votes (small: N ints + N floats per mode) so thresholds
    # can be re-derived offline without re-training
    report["raw_votes"] = {
        "reference": {"cls": ref_cls.tolist(),
                      "conf": np.round(ref_conf, 4).tolist()},
        **{name: {"cls": c.tolist(), "conf": np.round(f, 4).tolist()}
           for name, (c, f) in raw_votes.items()},
    }
    for tname, scores in trunk_scores_by_mode.items():
        report["raw_votes"][tname].update(
            {k: np.round(v, 4).tolist() for k, v in scores.items()})

    report["gate_standard"] = {
        "min_vote_agreement": 0.99,
        "min_reference_accuracy": 0.85,
        # an SR-image-modifying mode is "image_faithful" only if its SR
        # output holds >= 35 dB against the f32 SR image (the SR image is a
        # user deliverable, not just classifier input)
        "min_image_faithful_psnr_db": 35.0,
    }
    report["meaningful"] = (report["reference_accuracy"] >= 0.85
                            and 0.1 <= float((ref_cls == 1).mean()) <= 0.9)
    report["elapsed_sec"] = round(time.time() - t0, 1)
    sr_psnr_of_mode = {  # which SR variant each mode serves (None = f32 SR)
        "int8_sr_f32_per_patch": psnr_sr_drift,
        "int8_sr_per_patch_int8": psnr_sr_drift,
        "int8_sr_shared_trunk_int8": psnr_sr_drift,
        "int8_sr_noborder_shared_trunk_int8": psnr_sr_nb_drift,
        "bf16_sr_per_patch_int8": psnr_sr_bf16_drift,
        "bf16_sr_shared_trunk_int8": psnr_sr_bf16_drift,
    }
    for m in report["modes"]:
        m["passes_gate"] = m["vote_agreement"] >= 0.99
        sr_psnr = sr_psnr_of_mode.get(m["mode"])
        if sr_psnr is None and m["mode"].startswith("bf16_sr_cascade"):
            sr_psnr = psnr_sr_bf16_drift  # derived rows serve the bf16 SR
        if sr_psnr is not None:
            m["sr_psnr_vs_f32_db"] = sr_psnr
            m["image_faithful"] = sr_psnr >= 35.0
    return report


# the hard task puts the trained f32 reference path near the reference's
# operating point (VGG16.ipynb cell 8: 0.9205): defect images carry stripes
# on only a random fraction of the surface (make_surface_images)
TASKS = {
    "easy": {"amp_range": (0.12, 0.25), "noise": 0.01,
             "coverage_range": (1.0, 1.0)},
    "hard": {"amp_range": (0.12, 0.25), "noise": 0.01,
             "coverage_range": (0.35, 1.0)},
}


def aggregate_runs(runs):
    """Cross-seed aggregation: a mode passes only if it clears the 99% vote
    agreement bar on every seed."""
    by_mode = {}
    for rep in runs:
        for m in rep["modes"]:
            by_mode.setdefault(m["mode"], []).append(m)
    agg = {
        "seeds": [r["seed"] for r in runs],
        "images_total": sum(r["protocol"]["images"] for r in runs),
        "reference_accuracy_per_seed": [r["reference_accuracy"]
                                        for r in runs],
        "reference_boundary_images_total": sum(
            r["reference_boundary_images"] for r in runs),
        "modes": [],
    }
    seeds_of_mode = {}
    for rep in runs:
        for m in rep["modes"]:
            seeds_of_mode.setdefault(m["mode"], []).append(rep["seed"])
    for name, ms in by_mode.items():
        entry = {
            "mode": name,
            # seeds that ran this mode: a "passes on all seeds" claim is only
            # as strong as this list
            "seeds": seeds_of_mode[name],
            "min_vote_agreement": min(m["vote_agreement"] for m in ms),
            "mean_vote_agreement": float(np.mean([m["vote_agreement"]
                                                  for m in ms])),
            "total_flips": sum(m["flips"] for m in ms),
            "max_abs_conf_drift": max(m["max_abs_conf_drift"] for m in ms),
            "passes_gate_all_seeds": all(m["passes_gate"] for m in ms),
        }
        bvals = [m["boundary_vote_agreement"] for m in ms
                 if "boundary_vote_agreement" in m]
        if bvals:
            entry["min_boundary_vote_agreement"] = min(bvals)
        if any("escalation_fraction" in m for m in ms):
            entry["max_escalation_fraction"] = max(
                m["escalation_fraction"] for m in ms)
            entry["total_unescalated_flips"] = sum(
                m["unescalated_flips"] for m in ms)
        if any("image_faithful" in m for m in ms):
            entry["image_faithful_all_seeds"] = all(
                m.get("image_faithful", True) for m in ms)
        agg["modes"].append(entry)
    return agg


def card_line(device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={device.index}"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--clf-steps", type=int, default=500)
    ap.add_argument("--edsr-steps", type=int, default=600)
    ap.add_argument("--seeds", default="0",
                    help="comma-separated seeds; each gets its own dataset "
                         "+ training + full mode matrix")
    ap.add_argument("--task", choices=sorted(TASKS), default="easy",
                    help="difficulty preset (hard ~= the reference's 0.92 "
                         "operating point)")
    ap.add_argument("--amp-lo", type=float, default=None)
    ap.add_argument("--amp-hi", type=float, default=None)
    ap.add_argument("--noise", type=float, default=None)
    ap.add_argument("--cov-lo", type=float, default=None)
    ap.add_argument("--cov-hi", type=float, default=None)
    ap.add_argument("--modes", default=None,
                    help="comma-separated mode subset (default: all); the "
                         "derived cascade rows need both shared_trunk_int8 "
                         "and int8_per_patch")
    ap.add_argument("--out", default="GATE_torch.json")
    args = ap.parse_args(argv)
    preset = TASKS[args.task]
    amp = (preset["amp_range"][0] if args.amp_lo is None else args.amp_lo,
           preset["amp_range"][1] if args.amp_hi is None else args.amp_hi)
    noise = preset["noise"] if args.noise is None else args.noise
    cov = (preset["coverage_range"][0] if args.cov_lo is None else args.cov_lo,
           preset["coverage_range"][1] if args.cov_hi is None else args.cov_hi)
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = resolve_device(None)

    runs = []
    for seed in seeds:
        print(f"=== seed {seed} ===", flush=True)
        runs.append(run_gate(args.images, args.size, args.clf_steps,
                             args.edsr_steps, seed, amp_range=amp,
                             noise=noise, coverage_range=cov,
                             mode_names=(args.modes.split(",")
                                         if args.modes else None),
                             device=dev))
    report = {"task": {"name": args.task, "amp_range": list(amp),
                       "noise": noise, "coverage_range": list(cov)},
              "device": card_line(dev),
              "aggregate": aggregate_runs(runs), "runs": runs}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"task": report["task"], "device": report["device"],
                      "aggregate": report["aggregate"]}, indent=2))


if __name__ == "__main__":
    main()
