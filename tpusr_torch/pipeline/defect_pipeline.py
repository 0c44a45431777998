"""LR -> SR -> patch-vote defect classification (port of
``tpusr/pipeline/defect_pipeline.py``: ``_vote``, the per-patch, trunk and
cascade branches of ``FusedSRClassifyPipeline``, and
``make_serving_pipeline`` for the modes below).

PyTorch runs eagerly, so the pipeline is a sequence of launches on one stream
rather than one compiled graph; no host round trip happens between stages
except the cascade guard's one scalar read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpusr_torch.core.pad import pad_amounts, reflect_pad_hw
from tpusr_torch.core.patches import patch_grid_size, patchify
from tpusr_torch.device import resolve_device
from tpusr_torch.models.layers import pixel_shuffle


def _vote(probs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., P, C) patch probabilities -> (class, confidence) per leading
    index: most votes, ties broken by higher mean probability (the
    reference's tie-break, VGG16_model.py:252-270); confidence is the mean
    probability of the winning class."""
    num_classes = probs.shape[-1]
    preds = probs.argmax(dim=-1)                      # first maximum
    votes = F.one_hot(preds, num_classes).to(probs.dtype).sum(dim=-2)
    mean_probs = probs.mean(dim=-2)
    # mean_probs < 1 <= one vote: votes + mean_probs is exactly lexicographic
    winner = (votes + mean_probs).argmax(dim=-1)
    conf = mean_probs.gather(-1, winner[..., None])[..., 0]
    return winner, conf


class FusedSRClassifyPipeline:
    """LR image batch -> SR -> patch-vote defect classification.

    ``sr_apply(lr_batch)`` maps (N, h, w, 3) [0, 1] -> (N, h*scale, w*scale,
    3) [0, 1]. Exactly one of:
    - ``clf_apply(patches)``: (M, patch, patch, 3) -> (M, classes) probs;
    - ``trunk_probs(images)``: (N, H, W, 3) -> (N, n_patches, classes);
    - ``cascade_votes(images, n_valid)`` -> (classes, confidences).
    ``pre_quant`` maps the SR batch to the classifier's input dtype before
    patch extraction. Runs on ``device`` (CUDA unless ``device="cpu"``).
    """

    def __init__(self, sr_apply, clf_apply=None, lr_hw: tuple[int, int] = None,
                 scale: int = None, patch: int = 96, stride: int | None = None,
                 pre_quant=None, trunk_probs=None, cascade_votes=None,
                 device=None):
        if sum(x is not None
               for x in (clf_apply, trunk_probs, cascade_votes)) != 1:
            raise ValueError("pass exactly one of clf_apply / trunk_probs / "
                             "cascade_votes")
        if lr_hw is None or scale is None:
            raise ValueError("lr_hw and scale are required, e.g. "
                             "lr_hw=(128, 128), scale=4")
        self.device = resolve_device(device)
        self.lr_hw = tuple(lr_hw)
        self.scale = scale
        self.patch = patch
        self.stride = stride if stride is not None else max(1, patch // 2)
        self.sr_apply = sr_apply
        self.clf_apply = clf_apply
        self.pre_quant = pre_quant
        self.trunk_probs = trunk_probs
        self.cascade_votes = cascade_votes
        hr_h, hr_w = lr_hw[0] * scale, lr_hw[1] * scale
        self._pad = pad_amounts(hr_h, hr_w, patch, self.stride)
        nh, nw = patch_grid_size(hr_h + self._pad[0], hr_w + self._pad[1],
                                 patch, self.stride)
        self.n_patches = nh * nw

    def _classify_block(self, srq):
        patches = patchify(reflect_pad_hw(srq, *self._pad), self.patch,
                           self.stride)                    # (n, P, p, p, 3)
        flat = patches.reshape((-1,) + patches.shape[2:])
        probs = self.clf_apply(flat)
        return probs.reshape(srq.shape[0], self.n_patches, -1)

    def run(self, lr_batch: torch.Tensor, n_valid: int):
        """The pipeline on a device batch. Rows >= ``n_valid`` are batch
        padding; only the cascade consumes it."""
        sr = self.sr_apply(lr_batch)
        srq = self.pre_quant(sr) if self.pre_quant is not None else sr
        if self.cascade_votes is not None:
            classes, confs = self.cascade_votes(srq, n_valid)
            return sr, classes, confs
        if self.trunk_probs is not None:
            probs = self.trunk_probs(srq)
        else:
            probs = self._classify_block(srq)
        classes, confs = _vote(probs)
        return sr, classes, confs

    def __call__(self, lr_batch, n_valid=None):
        """Returns (sr_batch, classes, confidences), tensors on the
        pipeline's device."""
        x = torch.as_tensor(lr_batch, dtype=torch.float32,
                            device=self.device).contiguous()
        with torch.inference_mode():
            return self.run(x, x.shape[0] if n_valid is None else int(n_valid))


def make_serving_pipeline(edsr, clf, lr_hw: tuple[int, int], scale: int,
                          patch: int = 96, stride: int = 48,
                          sr_mode: str = "f32",
                          clf_mode: str = "cascade_int8",
                          calib_patches=None,
                          cascade_escalate_frac: float = 0.25,
                          cascade_escalate_score: str = "vote_frac",
                          cascade_guard_threshold: float | None = 0.6,
                          device=None) -> FusedSRClassifyPipeline:
    """Serving pipeline from an ``EDSR`` and a ``VGG16Classifier`` module.

    The defaults are the shipped serving mode (bench.py DEFAULT_MODE,
    ``cascade_int8_votefrac_guarded``): f32 SR with the fused tail, and the
    int8 shared-trunk cascade with vote_frac escalation of 25% of each batch
    and the trunk-collapse guard at 0.6.

    sr_mode:  'f32'. ('bf16' and 'int8' are not ported yet.)
    clf_mode: 'per_patch_f32' | 'per_patch_int8' | 'shared_trunk_int8' |
              'cascade_int8'; the int8 modes calibrate on ``calib_patches``.
              ('shared_trunk_f32' is not ported yet.)
    The modules are moved to ``device`` (CUDA unless ``device="cpu"``).
    """
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply

    dev = resolve_device(device)
    if sr_mode in ("bf16", "int8"):
        raise NotImplementedError(
            f"sr_mode={sr_mode!r} is not ported yet (ROADMAP.md, queue 1: "
            f"{'bf16 SR' if sr_mode == 'bf16' else 'int8 SR (edsr_quant)'})")
    if sr_mode != "f32":
        raise ValueError(f"unknown sr_mode {sr_mode!r}")
    if scale != edsr.scale_factor:
        raise ValueError(f"scale {scale} != the EDSR model's "
                         f"{edsr.scale_factor}")
    edsr = edsr.to(dev)
    clf = clf.to(dev)
    poly_fn, r = make_fused_sr_apply(edsr)

    def sr_apply(x):
        return pixel_shuffle(poly_fn(x), r)

    clf_apply = trunk_probs = cascade_votes = pre_quant = qtree = None
    if clf_mode.endswith("int8"):
        from tpusr_torch.models.quant import (calibrate_vgg16, quantize_input,
                                              quantize_vgg16)

        if calib_patches is None:
            raise ValueError(f"clf_mode={clf_mode!r} needs calib_patches")
        qtree = quantize_vgg16(clf, calibrate_vgg16(clf, calib_patches))

        def pre_quant(sr):
            return quantize_input(qtree, sr)
    if clf_mode == "per_patch_f32":
        clf_apply = clf
    elif clf_mode == "per_patch_int8":
        from tpusr_torch.models.quant import quantized_vgg16_apply

        def clf_apply(p):
            return quantized_vgg16_apply(qtree, p)
    elif clf_mode == "shared_trunk_int8":
        from tpusr_torch.models.vgg_trunk import shared_trunk_probs_int8

        def trunk_probs(imgs):
            return shared_trunk_probs_int8(qtree, imgs, patch, stride)
    elif clf_mode == "cascade_int8":
        from tpusr_torch.pipeline.cascade import make_cascade_votes

        cascade_votes = make_cascade_votes(
            qtree, patch, stride, escalate_frac=cascade_escalate_frac,
            escalate_score=cascade_escalate_score,
            guard_threshold=cascade_guard_threshold)
    elif clf_mode == "shared_trunk_f32":
        raise NotImplementedError(
            "clf_mode='shared_trunk_f32' is not ported yet (ROADMAP.md, "
            "queue 1: shared-trunk f32)")
    else:
        raise ValueError(f"unknown clf_mode {clf_mode!r}")

    pipe = FusedSRClassifyPipeline(
        sr_apply, clf_apply=clf_apply, lr_hw=lr_hw, scale=scale, patch=patch,
        stride=stride, pre_quant=pre_quant, trunk_probs=trunk_probs,
        cascade_votes=cascade_votes, device=dev)
    pipe.qtree = qtree
    return pipe
