"""Degradation model: HR -> (LR, interp_name) (port of
``tpusr/data/degrade.py``; reference ``data/common_methods.py:51-100``).

Gaussian blur (p=.7, k in {3,5,7}, sigma in [0.8,2.0]), horizontal motion
blur (p=.3, k in {5,7,9}), downscale by ``scale_factor`` with a random
interpolation from {bilinear, bicubic, area, lanczos4} (OpenCV's taps,
``core/resize.py``), Gaussian noise (p=.7, sigma in [2,10] on the 0..255
scale).

The random draws are split from the arithmetic. ``sample_draws`` makes
JAX's draws from a ``jax.random`` key (``tpusr_torch.core.prng``: the
core's ``split(key, 8)`` and ``normal(fold_in(key, 99))``, the JPEG
stage's ``split(fold_in(key, 7))``); ``degrade_image_core`` takes them as
arguments, so given draws can be applied too, and computes only the branch
that was drawn
(the JAX core evaluates every variant and selects, an XLA device, not the
semantics). The JPEG re-encode stage (p=.7, q in [20, 60)) is a host codec,
as in JAX: ``jpeg_roundtrip`` rounds the LR to uint8, encodes it with the
port's encoder (``pipeline/jpeg_encode.py``, the bytes of
``cv2.imencode``) and decodes it with the port's decoder
(``pipeline/jpeg.py``, the pixels of ``cv2.imdecode``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.core import prng
from tpusr_torch.core.resize import resize
from tpusr_torch.device import fp32_math
from tpusr_torch.pipeline.jpeg import decode_jpeg_u8
from tpusr_torch.pipeline.jpeg_encode import encode_jpeg_u8

_INTERP_NAMES = ("INTER_LINEAR", "INTER_CUBIC", "INTER_AREA", "INTER_LANCZOS4")
_INTERP_METHODS = ("bilinear", "bicubic", "area", "lanczos4")
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    scale_factor: float = 0.5
    p_gauss_blur: float = 0.7
    p_motion_blur: float = 0.3
    p_noise: float = 0.7
    p_jpeg: float = 0.7
    gauss_ksizes: tuple[int, ...] = (3, 5, 7)
    motion_ksizes: tuple[int, ...] = (5, 7, 9)
    sigma_range: tuple[float, float] = (0.8, 2.0)
    noise_range: tuple[float, float] = (2.0, 10.0)
    jpeg_q_range: tuple[int, int] = (20, 60)


@dataclasses.dataclass(frozen=True)
class DegradeDraws:
    """One image's random choices: Gaussian blur on/off, its kernel size and
    sigma; motion blur on/off and its size; the interpolation (an index into
    ``_INTERP_NAMES``); noise on/off, its std (0..255 scale) and
    ``noise_erf``, the standard-normal noise of the LR's shape before its
    factor sqrt(2) (``prng.normal_erf_inv``: the normal is ``noise_erf *
    sqrt(2)``); the JPEG round trip on/off and its quality. The noise is
    added as XLA compiles the JAX core, ``lr + erf * (std * sqrt(2))`` with
    one rounding."""
    blur: bool
    ksize: int
    sigma: float
    motion: bool
    motion_size: int
    interp: int
    noise: bool
    noise_std: float
    noise_erf: torch.Tensor
    jpeg: bool = False
    jpeg_quality: int = 0


def lr_shape(hr_shape, cfg: DegradeConfig = DegradeConfig()) -> tuple:
    """(h, w, c) of the LR image ``cfg`` makes from an HR of ``hr_shape``."""
    h, w, c = hr_shape
    return int(h * cfg.scale_factor), int(w * cfg.scale_factor), c


def sample_draws(key, hr_shape, cfg: DegradeConfig = DegradeConfig(),
                 device=None) -> DegradeDraws:
    """One image's choices from the PRNG key ``key``, as the JAX package
    draws them (``tpusr/data/degrade.py``): the core's, then the JPEG
    stage's (on/off, then the quality in [lo, hi)); the noise tensor is
    drawn on ``device``."""
    keys = prng.split(key, 8)

    def u(k, lo=0.0, hi=1.0):
        return float(prng.uniform(k, (), lo, hi))

    def index(k, n):
        return int(prng.randint(k, (), 0, n))

    k1, k2 = prng.split(prng.fold_in(key, 7))
    lo, hi = cfg.jpeg_q_range
    erf = prng.normal_erf_inv(prng.fold_in(key, 99), lr_shape(hr_shape, cfg),
                              device)
    return DegradeDraws(
        blur=u(keys[0]) < np.float32(cfg.p_gauss_blur),
        ksize=cfg.gauss_ksizes[index(keys[1], len(cfg.gauss_ksizes))],
        sigma=u(keys[2], *cfg.sigma_range),
        motion=u(keys[3]) < np.float32(cfg.p_motion_blur),
        motion_size=cfg.motion_ksizes[index(keys[4], len(cfg.motion_ksizes))],
        interp=index(keys[5], len(_INTERP_METHODS)),
        noise=u(keys[6]) < np.float32(cfg.p_noise),
        noise_std=u(keys[7], *cfg.noise_range),
        noise_erf=erf,
        jpeg=u(k1) < np.float32(cfg.p_jpeg),
        jpeg_quality=int(prng.randint(k2, (), lo, hi)))


def _gauss_kernel1d(ksize: int, sigma: float, device) -> torch.Tensor:
    """cv2.getGaussianKernel parity for the sigma>0 path, in float32."""
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (ksize - 1) / 2.0
    s = torch.tensor(sigma, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * s * s))
    return k / torch.sum(k)


def _sep_blur(img: torch.Tensor, kv: torch.Tensor, kh: torch.Tensor
              ) -> torch.Tensor:
    """Separable blur of an (h, w, c) image with reflect-101 borders (cv2's
    default; numpy's and F.pad's ``reflect``): the vertical taps, then the
    horizontal ones, each channel on its own."""
    c = img.shape[-1]
    ph, pw = kv.shape[0] // 2, kh.shape[0] // 2
    x = img.permute(2, 0, 1)[None]                      # (1, c, h, w)
    x = F.pad(x, (pw, pw, ph, ph), mode="reflect")
    x = F.conv2d(x, kv.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, kh.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x[0].permute(1, 2, 0)


def degrade_image_core(hr01: torch.Tensor, draws: DegradeDraws,
                       cfg: DegradeConfig = DegradeConfig()):
    """Degrade an (h, w, c) HR image in [0, 1] with the given draws (the JPEG
    stage excluded). Returns (lr01, interp_idx), interp_idx indexing
    ``_INTERP_NAMES``."""
    fp32_math()
    x = hr01.to(torch.float32) * 255.0
    if draws.blur:
        k = _gauss_kernel1d(draws.ksize, draws.sigma, x.device)
        x = _sep_blur(x, k, k)
    if draws.motion:
        x = _sep_blur(x, torch.ones(1, device=x.device),
                      torch.full((draws.motion_size,), 1.0 / draws.motion_size,
                                 device=x.device))
    out = lr_shape(tuple(hr01.shape), cfg)
    lr = resize(x, out[:2], _INTERP_METHODS[draws.interp])
    if draws.noise:
        scale = float(np.float32(draws.noise_std) * np.float32(prng.SQRT2))
        lr = torch.clamp(prng.fma32(draws.noise_erf.to(lr.device), scale, lr),
                         0.0, 255.0)
    # XLA compiles the division by 255 as a product by float32(1 / 255)
    return torch.clamp(lr, 0.0, 255.0) * _INV_255, draws.interp


def jpeg_roundtrip(lr01, quality: int):
    """The JPEG re-encode (common_methods.py:94-99) of an (h, w, 3) RGB
    image in [0, 1], on the host: rounded to uint8 as JAX rounds it,
    encoded at ``quality`` and decoded. Returns float32 in [0, 1] of
    ``lr01``'s kind (a tensor comes back on its device)."""
    is_tensor = isinstance(lr01, torch.Tensor)
    x = lr01.detach().cpu().numpy() if is_tensor else np.asarray(lr01)
    u8 = np.clip(x * 255.0, 0, 255).round().astype(np.uint8)
    out = decode_jpeg_u8(encode_jpeg_u8(u8, int(quality))).astype(
        np.float32) / 255.0
    return torch.from_numpy(out).to(lr01.device) if is_tensor else out


def degrade_image(hr01, key=None, cfg: DegradeConfig = DegradeConfig(),
                  apply_jpeg: bool = True, seed: int | None = None):
    """Full degradation (common_methods.py:51-100). ``hr01`` is an (h, w,
    c) numpy array or tensor in [0, 1]; the draws are JAX's from the PRNG
    key ``key`` (default ``PRNGKey(seed)``, or 0), the core runs on
    ``hr01``'s device, and with ``apply_jpeg`` (the default, as in JAX) the
    drawn JPEG round trip follows on the host. Returns (lr01, interp_name),
    lr01 of ``hr01``'s kind."""
    is_numpy = not isinstance(hr01, torch.Tensor)
    x = torch.as_tensor(np.asarray(hr01, np.float32)) if is_numpy else hr01
    if key is None:
        key = prng.PRNGKey(0 if seed is None else seed)
    draws = sample_draws(key, tuple(x.shape), cfg, x.device)
    return degrade_with_draws(x, draws, cfg, apply_jpeg, is_numpy)


def degrade_with_draws(hr01: torch.Tensor, draws: DegradeDraws,
                       cfg: DegradeConfig = DegradeConfig(),
                       apply_jpeg: bool = True, to_numpy: bool = False):
    """The core on ``hr01``'s device with ``draws``, then the JPEG stage
    when drawn and ``apply_jpeg``. Returns (lr01, interp_name)."""
    lr01, idx = degrade_image_core(hr01, draws, cfg)
    if apply_jpeg and draws.jpeg:
        lr01 = jpeg_roundtrip(lr01, draws.jpeg_quality)
    return (lr01.cpu().numpy() if to_numpy else lr01), _INTERP_NAMES[idx]
