"""Confidence-cascade serving mode (port of ``tpusr/pipeline/cascade.py``):
shared-trunk votes, exact per-patch escalation of the K lowest-scored images,
and the trunk-collapse guard.

Differences from the JAX version, none of which changes a result:

- the escalation set comes from a stable ascending sort of the score, which
  puts the lower index first on ties as ``lax.top_k(-score, k)`` does;
- the guard is a host ``if`` on the canary (one device-to-host sync per
  batch) where JAX has a ``lax.cond``;
- the vote function is an object that records the last escalation set and
  counts guard trips, so a caller can see what the cascade did.
"""

from __future__ import annotations

import math

import torch

from tpusr_torch.core.pad import pad_amounts
from tpusr_torch.core.patches import patch_grid_size
from tpusr_torch.models.quant import per_patch_int8_probs, quantize_input
from tpusr_torch.models.vgg_trunk import shared_trunk_probs_int8
from tpusr_torch.pipeline.defect_pipeline import _vote


class CascadeVotes:
    """``votes(images, n_valid=None) -> (classes, confidences)``; see
    ``make_cascade_votes``."""

    def __init__(self, qtree: dict, patch: int, stride: int,
                 escalate_frac: float, escalate_score: str,
                 guard_threshold: float | None):
        if not 0.0 < escalate_frac <= 1.0:
            raise ValueError(f"escalate_frac must be in (0, 1], got "
                             f"{escalate_frac}")
        if escalate_score not in ("conf", "vote_frac"):
            raise ValueError(f"escalate_score must be 'conf' or 'vote_frac', "
                             f"got {escalate_score!r}")
        self.qtree = qtree
        self.patch, self.stride = patch, stride
        self.escalate_frac = escalate_frac
        self.escalate_score = escalate_score
        self.guard_threshold = guard_threshold
        self.last_escalated: torch.Tensor | None = None
        self.guard_trips = 0

    def per_patch_probs(self, images: torch.Tensor) -> torch.Tensor:
        """The exact per-patch int8 path (block 1 through K3): (N, H, W, 3)
        int8 images -> (N, n_patches, classes) probs in row-major patch
        order."""
        return per_patch_int8_probs(self.qtree, images, self.patch, self.stride)

    def __call__(self, images: torch.Tensor, n_valid=None):
        q = self.qtree
        if images.dtype != torch.int8:
            images = quantize_input(q, images)
        n, h, w, _ = images.shape
        pad_h, pad_w = pad_amounts(h, w, self.patch, self.stride)
        nh, nw = patch_grid_size(h + pad_h, w + pad_w, self.patch, self.stride)

        probs_t = shared_trunk_probs_int8(q, images, self.patch, self.stride)
        cls_t, conf_t = _vote(probs_t)
        if self.escalate_score == "vote_frac":
            preds = probs_t.argmax(dim=-1)                 # (N, n_patches)
            agree = (preds == cls_t[:, None]).float()
            # conf <= 1 scaled by half a 1/n_patches quantum: exactly
            # lexicographic (vote_frac, conf)
            score = agree.mean(dim=1) + conf_t * (0.5 / (nh * nw))
        else:
            score = conf_t
        if n_valid is not None:  # pad rows must never win escalation slots
            real = torch.arange(n, device=score.device) < n_valid
            score = torch.where(real, score, torch.full_like(score, math.inf))

        k = max(1, min(n, math.ceil(n * self.escalate_frac - 1e-9)))
        idx = torch.sort(score, stable=True).indices[:k]  # k lowest, ties low-index first
        self.last_escalated = idx
        cls_p, conf_p = _vote(self.per_patch_probs(images.index_select(0, idx)))
        classes = cls_t.index_copy(0, idx, cls_p)
        confs = conf_t.index_copy(0, idx, conf_p)
        if self.guard_threshold is None:
            return classes, confs

        # trunk-collapse guard: the escalated subset carries both vote sets,
        # so their disagreement estimates the trunk's batch flip rate; past
        # the threshold the whole batch is served from the per-patch path
        canary = (cls_p != cls_t.index_select(0, idx)).float().mean()
        if bool(canary >= self.guard_threshold):
            self.guard_trips += 1
            return _vote(self.per_patch_probs(images))
        return classes, confs


def make_cascade_votes(qtree: dict, patch: int = 96, stride: int = 48,
                       escalate_frac: float = 0.25,
                       escalate_score: str = "conf",
                       guard_threshold: float | None = None) -> CascadeVotes:
    """Build the cascade vote function for a port int8 tree.

    ``votes(images, n_valid=None)``: ``images`` (N, H, W, 3) [0, 1] f32 or
    int8 from ``quantize_input``. ``K = max(1, ceil(N * escalate_frac))``
    lowest-scored images are re-classified by the per-patch int8 path; rows
    >= ``n_valid`` are batch padding and never take an escalation slot.
    ``escalate_score``: 'conf' (mean winning-class probability) or
    'vote_frac' (patch agreement with conf as a lexicographic tie-break).
    ``guard_threshold`` (None = off) re-serves the whole batch per-patch when
    the escalated images' trunk-vs-per-patch disagreement reaches it.
    """
    return CascadeVotes(qtree, patch, stride, escalate_frac, escalate_score,
                        guard_threshold)
