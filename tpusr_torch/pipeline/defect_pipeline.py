"""LR -> SR -> patch-vote defect classification (port of
``tpusr/pipeline/defect_pipeline.py``: ``_vote``, ``FusedSRClassifyPipeline``
with its per-patch, trunk and cascade branches and ``classify_chunks``, and
``make_serving_pipeline`` for every SR and classifier mode but ``mesh``).

PyTorch runs eagerly, so the pipeline is a sequence of launches on one stream
rather than one compiled graph; no host round trip happens between stages
except the cascade guard's one scalar read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpusr_torch.core.pad import pad_amounts
from tpusr_torch.core.patches import patch_grid_size
from tpusr_torch.device import resolve_device
from tpusr_torch.models.block1 import extract_patches_reference
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
    - ``per_patch_probs(images)``: (N, H, W, 3) -> (N, n_patches, classes),
      a per-patch classifier that extracts the patches itself (the int8
      path, whose block 1 K3 fuses with the extraction);
    - ``trunk_probs(images)``: (N, H, W, 3) -> (N, n_patches, classes);
    - ``cascade_votes(images, n_valid)`` -> (classes, confidences).
    ``pre_quant`` maps the SR batch to the classifier's input dtype before
    patch extraction. ``classify_chunks`` > 1 runs the per-patch stage
    (``clf_apply`` or ``per_patch_probs``) over that many image sub-batches
    in turn: the same results with a smaller patch working set. Runs on
    ``device`` (CUDA unless ``device="cpu"``).
    """

    def __init__(self, sr_apply, clf_apply=None, lr_hw: tuple[int, int] = None,
                 scale: int = None, patch: int = 96, stride: int | None = None,
                 classify_chunks: int = 1, pre_quant=None, trunk_probs=None,
                 cascade_votes=None, per_patch_probs=None, device=None):
        if sum(x is not None for x in (clf_apply, per_patch_probs, trunk_probs,
                                       cascade_votes)) != 1:
            raise ValueError("pass exactly one of clf_apply / per_patch_probs "
                             "/ trunk_probs / cascade_votes")
        if lr_hw is None or scale is None:
            raise ValueError("lr_hw and scale are required, e.g. "
                             "lr_hw=(128, 128), scale=4")
        if classify_chunks < 1:
            raise ValueError(f"classify_chunks must be >= 1, got "
                             f"{classify_chunks}")
        self.device = resolve_device(device)
        self.lr_hw = tuple(lr_hw)
        self.scale = scale
        self.patch = patch
        self.stride = stride if stride is not None else max(1, patch // 2)
        self.classify_chunks = classify_chunks
        self.sr_apply = sr_apply
        self.clf_apply = clf_apply
        self.per_patch_probs = per_patch_probs
        self.pre_quant = pre_quant
        self.trunk_probs = trunk_probs
        self.cascade_votes = cascade_votes
        hr_h, hr_w = lr_hw[0] * scale, lr_hw[1] * scale
        pad_h, pad_w = pad_amounts(hr_h, hr_w, patch, self.stride)
        nh, nw = patch_grid_size(hr_h + pad_h, hr_w + pad_w, patch, self.stride)
        self.n_patches = nh * nw

    def _classify_block(self, srq):
        if self.per_patch_probs is not None:
            return self.per_patch_probs(srq)
        flat = extract_patches_reference(srq, self.patch, self.stride)
        return self.clf_apply(flat).reshape(srq.shape[0], self.n_patches, -1)

    def _per_patch_stage(self, srq):
        n, chunks = srq.shape[0], self.classify_chunks
        if chunks == 1:
            return self._classify_block(srq)
        if n % chunks:
            # one unchunked block would hold the whole patch working set,
            # which chunking exists to bound: refuse instead
            raise ValueError(f"batch size {n} is not divisible by "
                             f"classify_chunks={chunks}; pick a batch that "
                             f"divides evenly (or classify_chunks=1)")
        return torch.cat([self._classify_block(block)
                          for block in srq.split(n // chunks)])

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
            probs = self._per_patch_stage(srq)
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
                          sr_mode: str = "int8",
                          clf_mode: str = "shared_trunk_int8",
                          calib_lr=None, calib_patches=None,
                          sr_border_correction: bool = True,
                          cascade_escalate_frac: float = 0.25,
                          cascade_escalate_score: str = "conf",
                          cascade_guard_threshold: float | None = None,
                          device=None) -> FusedSRClassifyPipeline:
    """Serving pipeline from an ``EDSR`` and a ``VGG16Classifier`` module,
    with the JAX factory's modes and defaults (int8 SR, int8 shared trunk).
    The shipped mode (bench.py ``DEFAULT_MODE``) is ``sr_mode="f32",
    clf_mode="cascade_int8", cascade_escalate_score="vote_frac",
    cascade_guard_threshold=0.6``.

    sr_mode:  'f32' | 'bf16' | 'int8' -- the fused-tail SR forward (int8:
              post-training quantized, calibrated on ``calib_lr``;
              ``sr_border_correction=False`` drops its chained-tail border
              band); the SR image is float32 after the shuffle.
    clf_mode: 'per_patch_f32' | 'per_patch_int8' | 'shared_trunk_f32' |
              'shared_trunk_int8' | 'cascade_int8'; the int8 modes calibrate
              on ``calib_patches``. The cascade re-classifies the
              ``cascade_escalate_frac`` lowest-scored images of each batch
              per patch, scored by ``cascade_escalate_score`` ('conf' or
              'vote_frac'); ``cascade_guard_threshold`` arms the
              trunk-collapse guard.
    The modules are moved to ``device`` (CUDA unless ``device="cpu"``).
    """
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply

    dev = resolve_device(device)
    if scale != edsr.scale_factor:
        raise ValueError(f"scale {scale} != the EDSR model's "
                         f"{edsr.scale_factor}")
    edsr = edsr.to(dev)
    clf = clf.to(dev)
    if sr_mode == "int8":
        from tpusr_torch.models.edsr_quant import make_fused_sr_apply_int8

        if calib_lr is None:
            raise ValueError("sr_mode='int8' needs a calib_lr batch")
        poly_fn, r = make_fused_sr_apply_int8(
            edsr, sample_lr=calib_lr, border_correction=sr_border_correction)
    elif sr_mode in ("f32", "bf16"):
        dtype = torch.float32 if sr_mode == "f32" else torch.bfloat16
        poly_fn, r = make_fused_sr_apply(edsr, dtype)
    else:
        raise ValueError(f"unknown sr_mode {sr_mode!r}")

    def sr_apply(x):
        return pixel_shuffle(poly_fn(x), r).float()

    stage = {}
    pre_quant = qtree = None
    if clf_mode.endswith("int8"):
        from tpusr_torch.models.quant import (calibrate_vgg16, quantize_input,
                                              quantize_vgg16)

        if calib_patches is None:
            raise ValueError(f"clf_mode={clf_mode!r} needs calib_patches")
        qtree = quantize_vgg16(clf, calibrate_vgg16(clf, calib_patches))

        def pre_quant(sr):
            return quantize_input(qtree, sr)
    if clf_mode == "per_patch_f32":
        stage["clf_apply"] = clf
    elif clf_mode == "per_patch_int8":
        from tpusr_torch.models.quant import per_patch_int8_probs

        stage["per_patch_probs"] = lambda imgs: per_patch_int8_probs(
            qtree, imgs, patch, stride)
    elif clf_mode == "shared_trunk_f32":
        from tpusr_torch.models.vgg_trunk import shared_trunk_probs_f32

        stage["trunk_probs"] = lambda imgs: shared_trunk_probs_f32(
            clf, imgs, patch, stride)
    elif clf_mode == "shared_trunk_int8":
        from tpusr_torch.models.vgg_trunk import shared_trunk_probs_int8

        stage["trunk_probs"] = lambda imgs: shared_trunk_probs_int8(
            qtree, imgs, patch, stride)
    elif clf_mode == "cascade_int8":
        from tpusr_torch.pipeline.cascade import make_cascade_votes

        stage["cascade_votes"] = make_cascade_votes(
            qtree, patch, stride, escalate_frac=cascade_escalate_frac,
            escalate_score=cascade_escalate_score,
            guard_threshold=cascade_guard_threshold)
    else:
        raise ValueError(f"unknown clf_mode {clf_mode!r}")

    pipe = FusedSRClassifyPipeline(
        sr_apply, lr_hw=lr_hw, scale=scale, patch=patch, stride=stride,
        pre_quant=pre_quant, device=dev, **stage)
    pipe.qtree = qtree
    return pipe
