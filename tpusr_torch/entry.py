"""The f32 reference path as one callable (counterpart of
``__graft_entry__.entry()``): chained EDSR x4 (not the fused tail), per-patch
f32 VGG16 and the patch vote, at 128x128 LR, patch 96, stride 48.

    fn, (lr_batch,) = entry()
    sr, classes, confidences = fn(lr_batch)

The JAX entry draws its weights with ``jax.random.PRNGKey(0)`` and ``(1)``;
those bits cannot be reproduced in PyTorch, so here the EDSR weights come
from a ``torch.Generator`` seeded 0 and the VGG16 weights from one seeded 1.
The example batch of 2 LR images is ``np.random.default_rng(0)``'s, as in
the JAX entry.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusr_torch.device import resolve_device
from tpusr_torch.models import EDSR, VGG16Classifier
from tpusr_torch.pipeline.defect_pipeline import FusedSRClassifyPipeline

LR_HW, SCALE, PATCH, STRIDE = (128, 128), 4, 96, 48


def entry_pipeline(edsr, clf, lr_hw=LR_HW, patch: int = PATCH,
                   stride: int = STRIDE, device=None) -> FusedSRClassifyPipeline:
    """The reference path on given modules: ``edsr`` (chained forward) ->
    per-patch ``clf`` -> vote."""
    return FusedSRClassifyPipeline(edsr, clf_apply=clf, lr_hw=lr_hw,
                                   scale=edsr.scale_factor, patch=patch,
                                   stride=stride, device=device)


def entry(device=None):
    """Returns (fn, example_args): ``fn(lr_batch) -> (sr, classes,
    confidences)`` on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    edsr = EDSR(scale_factor=SCALE, device=dev,
                generator=torch.Generator().manual_seed(0))
    clf = VGG16Classifier(num_classes=2, device=dev,
                          generator=torch.Generator().manual_seed(1))
    pipe = entry_pipeline(edsr, clf, device=dev)

    def fn(lr_batch):
        return pipe(lr_batch)

    fn.pipeline = pipe
    example = (torch.as_tensor(np.random.default_rng(0).random(
        (2, *LR_HW, 3), dtype=np.float32), device=dev),)
    return fn, example
