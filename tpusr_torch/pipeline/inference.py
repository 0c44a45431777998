"""Patch-based and full-image SR inference (port of
``tpusr/pipeline/inference.py``).

The reference's flow (``SRCNN_model.py:111-247``, ``EDSR_model.py:189-315``,
``ESRGAN_model.py:858-979``): reflect-pad -> patches -> batched net ->
overlap-add -> crop -> clip, on the device with no host round trip; the
metrics dict keeps the reference's field names (``time_sec``,
``gpu_mean_current_mb``, ``gpu_peak_mb``).

The JAX module keeps an LRU of compiled closures (``_SR_FN_CACHE``,
``_full_image_apply_fn``) so that a loop over images does not re-trace.
PyTorch runs eagerly and has nothing to compile, so the port builds its small
closure per call and keeps no cache.

A net here is any callable on an NHWC batch (a module, or a function of one);
its convs run where the net runs them (EDSR's and ESRGAN's on K2).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpusr_torch.core.pad import pad_amounts, reflect_pad_hw
from tpusr_torch.core.patches import overlap_add, patch_grid_size, patchify
from tpusr_torch.core.resize import resize
from tpusr_torch.device import resolve_device
from tpusr_torch.dist.mesh import axis_size, check_mesh
from tpusr_torch.dist.spatial import full_image_esrgan_sr
from tpusr_torch.train.callbacks import _device_memory_info, _mb, _synchronize


def _net_device(apply_fn, device) -> torch.device:
    """``device`` when given; else the device of ``apply_fn``'s parameters
    when it is a module that has some; else the default (CUDA)."""
    if device is None and isinstance(apply_fn, torch.nn.Module):
        p = next(apply_fn.parameters(), None)
        if p is not None:
            return resolve_device(p.device)
    return resolve_device(device)


def sr_inference_fn(apply_fn, lr_hw: tuple[int, int], patch: int, stride: int,
                    scale: int, in_range=(0.0, 1.0), out_range=(0.0, 1.0)):
    """The pad -> patchify -> net -> overlap-add -> crop -> clip function for
    a fixed LR shape: (h, w, 3) [0, 1] tensor -> (h*scale, w*scale, 3) [0, 1]
    on the tensor's device. ``apply_fn(patches)`` maps (N, p, p, 3) -> (N,
    p*scale, p*scale, 3).

    in_range/out_range handle ESRGAN's [-1, 1] convention
    (ESRGAN_model.py:929,946)."""
    h, w = lr_hw
    pad_h, pad_w = pad_amounts(h, w, patch, stride)
    nh, nw = patch_grid_size(h + pad_h, w + pad_w, patch, stride)

    def fn(lr_img: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = reflect_pad_hw(lr_img, pad_h, pad_w)
            patches = patchify(x, patch, stride)
            if in_range != (0.0, 1.0):
                lo, hi = in_range
                patches = patches * (hi - lo) + lo
            preds = apply_fn(patches.contiguous())
            if out_range != (0.0, 1.0):
                lo, hi = out_range
                preds = (preds - lo) / (hi - lo)
            sr = overlap_add(preds, (nh, nw), stride * scale,
                             crop_hw=(h * scale, w * scale))
            return sr.clamp(0.0, 1.0)

    return fn


def _timed_call(fn, *args):
    """Run ``fn(*args)`` with the reference's inference-metrics protocol: the
    host clock around the call, ended by a synchronisation of the output's
    device, and torch's allocator statistics of that device before and
    after (None on the CPU)."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    mem_begin = _device_memory_info(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    _synchronize(out.device if isinstance(out, torch.Tensor) else dev)
    elapsed = time.perf_counter() - t0
    mem_end = _device_memory_info(dev)

    cur_b = mem_begin.get("current") if isinstance(mem_begin, dict) else None
    cur_e = mem_end.get("current") if isinstance(mem_end, dict) else None
    if cur_b is not None and cur_e is not None:
        mean_cur = _mb((cur_b + cur_e) / 2.0)
    else:
        mean_cur = _mb(cur_e) if cur_e is not None else None
    pk_b = mem_begin.get("peak") if isinstance(mem_begin, dict) else None
    pk_e = mem_end.get("peak") if isinstance(mem_end, dict) else None
    peak = _mb(max(pk_b, pk_e)) if (pk_b is not None and pk_e is not None) else (
        _mb(pk_e) if pk_e is not None else None)
    return out, {
        "time_sec": float(elapsed),
        "gpu_mean_current_mb": mean_cur,
        "gpu_peak_mb": peak,
    }


def _lr_tensor(lr_img, dev: torch.device) -> torch.Tensor:
    if isinstance(lr_img, torch.Tensor):
        return lr_img.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(lr_img, np.float32), device=dev)


def super_resolve_image(apply_fn, lr_img, patch_size_lr: int = 48,
                        stride: int = 24, scale: int = 2,
                        normalize_pm1: bool = False, device=None):
    """EDSR/ESRGAN-style patch SR on a single (h, w, 3) [0, 1] LR image
    (EDSR_model.py:189-315). Returns (sr tensor (h*scale, w*scale, 3) in
    [0, 1] on the net's device, metrics).

    ``apply_fn(patches)`` is the model forward (a module carries its
    weights); set ``normalize_pm1=True`` for ESRGAN's tanh generator. The
    image goes to ``device``, by default the module's own (else CUDA)."""
    dev = _net_device(apply_fn, device)
    lr = _lr_tensor(lr_img, dev)
    # the model's range is both its input and output convention (the
    # [0,1]<->[-1,1] maps of ESRGAN_model.py:929,946 are symmetric)
    in_map = (0.0, 1.0) if not normalize_pm1 else (-1.0, 1.0)
    fn = sr_inference_fn(apply_fn, tuple(lr.shape[:2]), patch_size_lr, stride,
                         scale, in_range=in_map, out_range=in_map)
    return _timed_call(fn, lr)


def srcnn_super_resolve(apply_fn, lr_img, hr_h: int, hr_w: int,
                        patch_size: int = 33, stride: int = 14,
                        interpolation: str = "bicubic", device=None):
    """SRCNN-style SR: upscale LR to HR size first (``core/resize.py``, cv2
    filters), then same-size patch restoration (SRCNN_model.py:111-247).
    Returns (sr tensor (hr_h, hr_w, 3) in [0, 1], metrics)."""
    dev = _net_device(apply_fn, device)
    lr = _lr_tensor(lr_img, dev)
    pad_h, pad_w = pad_amounts(hr_h, hr_w, patch_size, stride)
    nh, nw = patch_grid_size(hr_h + pad_h, hr_w + pad_w, patch_size, stride)

    def fn(img):
        with torch.inference_mode():
            up = resize(img, (hr_h, hr_w), interpolation).clamp(0.0, 1.0)
            x = reflect_pad_hw(up, pad_h, pad_w)
            preds = apply_fn(patchify(x, patch_size, stride).contiguous())
            sr = overlap_add(preds, (nh, nw), stride, crop_hw=(hr_h, hr_w))
            return sr.clamp(0.0, 1.0)

    return _timed_call(fn, lr)


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def super_resolve_full_image(generator, lr_img, mesh=None,
                             attention_block_size: int = 4096,
                             axis: str = "data"):
    """Full-image ESRGAN SR: no patch decomposition, no overlap-add.

    The whole (h, w, 3) [0, 1] image goes through ``generator`` (an
    ``ESRGANGenerator``, which holds its weights: the JAX function's
    ``variables`` argument has no counterpart) on the generator's device.
    The dense self-attention map is O((HW)^2); it is bounded by:

    - no mesh: each attention site runs the blockwise online-softmax form
      with the largest block <= ``attention_block_size`` that divides the
      trunk's token count, O(HW * block) memory;
    - ``mesh`` (a ``DeviceMesh``; called on every rank with the same image):
      the image's rows split over ``axis`` with ring attention over the
      split token axis (``dist.spatial.full_image_esrgan_sr``) when the axis
      divides h; otherwise the path without a mesh, as in JAX.

    Returns (sr image as a numpy array in [0, 1], metrics dict) with the
    fields of ``super_resolve_image``.
    """
    check_mesh(mesh)
    dev = _net_device(generator, None)
    lr = _lr_tensor(lr_img, dev)
    x = lr[None] * 2.0 - 1.0
    h, w = int(lr.shape[0]), int(lr.shape[1])

    if mesh is not None and h % axis_size(mesh, axis) == 0:
        def fn(xb):
            with torch.inference_mode():
                return full_image_esrgan_sr(generator, xb, mesh, axis)
        sr, metrics = _timed_call(fn, x)
    else:
        block = _largest_divisor_at_most(h * w, attention_block_size)

        def fn(xb):
            with torch.inference_mode():
                return generator(xb)

        saved = generator.attention_block_size, generator.attention_fn
        generator.attention_block_size, generator.attention_fn = block, None
        try:
            sr, metrics = _timed_call(fn, x)
        finally:
            generator.attention_block_size, generator.attention_fn = saved
    return ((sr[0] + 1.0) / 2.0).clamp(0.0, 1.0).cpu().numpy(), metrics
