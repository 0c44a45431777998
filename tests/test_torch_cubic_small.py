"""uint8 ``INTER_CUBIC`` from a source under 4x4, which OpenCV keeps on its
own path (IPP takes sources of at least 4x4): ``_cv_ops.resize_u8`` against
``cv2.resize`` with no tolerance. OpenCV's vertical pass there is
``VResizeCubicVec_32s8u`` (float32, 8 values a step, no fused
multiply-add) for all but the last ``ow * c % 8`` values of a row, which
take the integer ``VResizeCubic``.
"""

import cv2
import numpy as np
import pytest
import torch

from tpusr_torch.data import _cv_ops as ops

SOURCES = [(h, w) for h in range(1, 4) for w in range(1, 8)]
OUTPUTS = [(oh, ow) for oh in range(1, 5) for ow in range(1, 6)]


def _differ(img, out) -> int:
    got = ops.resize_u8(torch.from_numpy(img), out, "bicubic").numpy()
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_CUBIC)
    return int((got != want.reshape(got.shape)).sum())


def test_all_420_small_sources_equal_cv2():
    """Every source from 1x1 to 3x7 into every size from 1x1 to 4x5: 420
    cases, 0 that differ (29 before the integer tail)."""
    rng = np.random.default_rng(420)
    bad = [(hw, out) for hw in SOURCES for out in OUTPUTS
           if _differ(rng.integers(0, 256, (*hw, 3), np.uint8), out)]
    assert len(SOURCES) * len(OUTPUTS) == 420
    assert bad == []


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_small_sources_enlarged_far_equal_cv2(channels):
    """Rows long enough for the float32 steps, with a tail, on random
    shapes."""
    rng = np.random.default_rng(channels)
    for _ in range(60):
        hw = (int(rng.integers(1, 4)), int(rng.integers(1, 8)))
        out = (int(rng.integers(1, 50)), int(rng.integers(1, 50)))
        img = rng.integers(0, 256, (*hw, channels), np.uint8)
        assert _differ(img, out) == 0, (hw, out)
