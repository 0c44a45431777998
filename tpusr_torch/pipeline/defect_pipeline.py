"""LR -> SR -> patch-vote defect classification (port of
``tpusr/pipeline/defect_pipeline.py``: ``_vote``, ``make_patch_classifier``,
``classify_defects``, ``FusedSRClassifyPipeline`` with its per-patch, trunk
and cascade branches, ``classify_chunks``, ``throughput`` and ``mesh``,
``make_serving_pipeline`` for every SR and classifier mode, and
``run_defect_detection_comparison``).

PyTorch runs eagerly, so the pipeline is a sequence of launches on one stream
rather than one compiled graph; no host round trip happens between stages
except the cascade guard's one scalar read.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.core.pad import pad_amounts
from tpusr_torch.core.patches import patch_grid_size
from tpusr_torch.device import resolve_device
from tpusr_torch.dist.mesh import axis_size, batch_shard, check_mesh
from tpusr_torch.metrics.image import psnr as psnr_fn, ssim as ssim_fn
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


def make_patch_classifier(clf_apply, image_hw: tuple[int, int], patch: int,
                          stride: int | None = None):
    """image -> (class, confidence) patch-vote classification for a fixed
    image shape. ``clf_apply(patches)`` -> (N, num_classes) probs; the image
    is (H, W, C) on the classifier's device."""
    stride = stride if stride is not None else max(1, patch // 2)
    h, w = image_hw

    def fn(image):
        if tuple(image.shape[:2]) != (h, w):
            raise ValueError(f"image {tuple(image.shape)} is not {(h, w)}")
        with torch.inference_mode():
            patches = extract_patches_reference(image[None], patch, stride)
            return _vote(clf_apply(patches))

    return fn


def classify_defects(clf_apply, image, patch: int, stride: int | None = None,
                     device=None):
    """One-shot patch-vote classification (classify_defects_method parity):
    (class, confidence) of one (H, W, C) [0, 1] image, classified on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    image = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    cls, conf = make_patch_classifier(clf_apply, image.shape[:2], patch,
                                      stride)(image)
    return int(cls), float(conf)


class FusedSRClassifyPipeline:
    """LR image batch -> SR -> patch-vote defect classification.

    ``sr_apply(lr_batch)`` maps (N, h, w, 3) [0, 1] -> (N, h*scale, w*scale,
    3) [0, 1]. Exactly one of:
    - ``clf_apply(patches)``: (M, patch, patch, 3) -> (M, classes) probs;
    - ``per_patch_probs(images)``: (N, H, W, 3) -> (N, n_patches, classes),
      a per-patch classifier that extracts the patches itself (the int8
      path, whose block 1 K3 fuses with the extraction);
    - ``trunk_probs(images)``: (N, H, W, 3) -> (N, n_patches, classes);
    - ``cascade_votes(images, n_valid)`` -> (classes, confidences) (under
      a mesh, also ``shard=``: ``CascadeVotes``).
    ``pre_quant`` maps the SR batch to the classifier's input dtype before
    patch extraction. ``classify_chunks`` > 1 runs the per-patch stage
    (``clf_apply`` or ``per_patch_probs``) over that many image sub-batches
    in turn: the same results with a smaller patch working set. Runs on
    ``device`` (CUDA unless ``device="cpu"``).

    ``mesh`` (a ``DeviceMesh`` with a 'data' axis): the pipeline is called
    on every rank with the same global batch; when the axis divides the
    batch each rank runs its rows (the cascade ranks the global batch, see
    ``pipeline.cascade``) and the SR, classes and confidences come back
    all-gathered; otherwise every rank runs the whole batch, as JAX shards
    only a divisible batch.
    """

    def __init__(self, sr_apply, clf_apply=None, lr_hw: tuple[int, int] = None,
                 scale: int = None, patch: int = 96, stride: int | None = None,
                 classify_chunks: int = 1, pre_quant=None, trunk_probs=None,
                 cascade_votes=None, per_patch_probs=None, mesh=None,
                 device=None):
        check_mesh(mesh)
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
        self.mesh = mesh
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

    def run(self, lr_batch: torch.Tensor, n_valid: int, shard=None):
        """The pipeline on a device batch (this rank's rows of the global
        batch with ``shard``). Rows >= ``n_valid`` (global rows) are batch
        padding; only the cascade consumes it."""
        sr = self.sr_apply(lr_batch)
        srq = self.pre_quant(sr) if self.pre_quant is not None else sr
        if self.cascade_votes is not None:
            if shard is None:
                classes, confs = self.cascade_votes(srq, n_valid)
            else:
                classes, confs = self.cascade_votes(srq, n_valid, shard=shard)
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
        n = x.shape[0]
        n_valid = n if n_valid is None else int(n_valid)
        with torch.inference_mode():
            if self.mesh is None or n % axis_size(self.mesh, "data"):
                return self.run(x, n_valid)
            shard = batch_shard(self.mesh, n)
            out = self.run(shard.take(x), n_valid, shard)
            return tuple(shard.gather(t) for t in out)

    def throughput(self, lr_batch, iters: int = 10) -> float:
        """Steady-state images/sec of the pipeline: the host clock over
        ``iters`` calls after a warm-up, between device barriers."""
        x = torch.as_tensor(lr_batch, dtype=torch.float32,
                            device=self.device).contiguous()
        with torch.inference_mode():
            self.run(x, x.shape[0])
            _sync(self.device)
            t0 = time.perf_counter()
            for _ in range(iters):
                self.run(x, x.shape[0])
            _sync(self.device)
        return x.shape[0] * iters / (time.perf_counter() - t0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_serving_pipeline(edsr, clf, lr_hw: tuple[int, int], scale: int,
                          patch: int = 96, stride: int = 48,
                          sr_mode: str = "int8",
                          clf_mode: str = "shared_trunk_int8",
                          calib_lr=None, calib_patches=None,
                          sr_border_correction: bool = True,
                          cascade_escalate_frac: float = 0.25,
                          cascade_escalate_score: str = "conf",
                          cascade_guard_threshold: float | None = None,
                          mesh=None, device=None) -> FusedSRClassifyPipeline:
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
    ``mesh``: the pipeline runs data-parallel (``FusedSRClassifyPipeline``);
    the int8 calibration runs whole on every rank.
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
        pre_quant=pre_quant, mesh=mesh, device=dev, **stage)
    pipe.qtree = qtree
    return pipe


def run_defect_detection_comparison(sr_methods: dict, clf_apply, x_lr, x_hr, y,
                                    patch: int = 96, stride: int | None = None,
                                    batch_size: int = 16, verbose: bool = True,
                                    device=None):
    """The reference's missing ``defect_detection_pipeline.ipynb``, as a
    function.

    For each SR method name -> ``sr_apply(lr_batch) -> sr_batch`` ([0, 1] in
    and out, tensors on ``device``, CUDA unless ``device="cpu"``),
    super-resolve every prediction image, patch-vote classify it with
    ``clf_apply(patches) -> probs``, and collect per-method results:
    predictions, confidences, accuracy, confusion matrix, SR fidelity
    (PSNR/SSIM against HR) and SR + classify wall time. Each batch is padded
    to one shape (the trailing one by repeating its last image), one untimed
    warm-up batch runs first, and only the pipeline call is timed, on the
    host clock between device barriers.
    """
    dev = resolve_device(device)
    x_lr = np.asarray(x_lr, np.float32)
    x_hr = np.asarray(x_hr, np.float32)
    y = np.asarray(y)
    n = x_lr.shape[0]
    hr_hw = x_hr.shape[1:3]
    results: dict[str, dict] = {}

    for name, sr_apply in sr_methods.items():
        scale = hr_hw[0] // x_lr.shape[1]
        pipe = FusedSRClassifyPipeline(sr_apply, clf_apply, x_lr.shape[1:3],
                                       scale, patch, stride, device=dev)
        bs = min(batch_size, n)
        pipe(x_lr[:bs])  # warm-up, untimed
        preds, confs, psnrs, ssims = [], [], [], []
        elapsed = 0.0
        for s in range(0, n, bs):
            xb = x_lr[s:s + bs]
            nb = xb.shape[0]
            if nb < bs:  # pad to one batch shape, slice results after
                xb = np.concatenate([xb, np.repeat(xb[-1:], bs - nb, axis=0)])
            xb = torch.as_tensor(xb, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            sr, cls, conf = pipe(xb)
            _sync(dev)
            elapsed += time.perf_counter() - t0
            hb = torch.as_tensor(x_hr[s:s + bs], device=dev)
            with torch.inference_mode():
                psnrs.append(psnr_fn(hb, sr[:nb]))
                ssims.append(ssim_fn(hb, sr[:nb]))
            preds.append(cls[:nb])
            confs.append(conf[:nb])

        preds, confs, psnrs, ssims = (torch.cat(v).cpu().numpy() for v in
                                      (preds, confs, psnrs, ssims))
        # size from labels and predictions: a class the classifier emits but
        # the label subset lacks must not index out of the matrix
        num_classes = int(max(2, y.max() + 1, preds.max() + 1))
        cm = np.zeros((num_classes, num_classes), np.int64)
        for t, p in zip(y, preds):
            cm[int(t), int(p)] += 1
        acc = float((preds == y).mean())
        correct = preds == y
        results[name] = {
            "predictions": preds,
            "confidences": confs,
            "accuracy": acc,
            "confusion_matrix": cm,
            "psnr_mean": float(psnrs.mean()),
            "ssim_mean": float(ssims.mean()),
            "time_sec": elapsed,
            "mean_confidence": float(confs.mean()),
            "mean_confidence_correct": float(confs[correct].mean()) if correct.any() else np.nan,
            "mean_confidence_wrong": float(confs[~correct].mean()) if (~correct).any() else np.nan,
            "error_rate": 1.0 - acc,
        }
        if verbose:
            print(f"{name}: acc={acc:.4f} psnr={results[name]['psnr_mean']:.2f} "
                  f"time={elapsed:.2f}s")
    return results
