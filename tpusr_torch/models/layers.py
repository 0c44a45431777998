"""Shared layers (port of the parts of ``tpusr/models/layers.py`` on the
serving path)."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """tf.nn.depth_to_space parity (DCR): (N, H, W, C*r^2) -> (N, H*r, W*r, C).

    Not ``torch.nn.PixelShuffle``, which is CRD and would scramble the
    channels (the polyphase tail's channel order depends on DCR)."""
    n, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, oc)
