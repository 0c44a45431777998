"""Keras-ImageDataGenerator-parity stochastic augmentation (port of
``tpusr/data/augment.py``).

Reference recipe (``defect_detection_models/VGG16_model.py:129-140``):
``ImageDataGenerator(rotation_range=20, width_shift_range=.2,
height_shift_range=.2, horizontal_flip=True)``. Keras warps with
``scipy.ndimage.affine_transform(order=1, mode='nearest')`` on a
rotation-then-shift matrix offset to the image centre, then flips
horizontally. The drawing of the parameters (``draw_augment_params``, from
a ``jax.random`` key through ``tpusr_torch.core.prng``: JAX's draws) is
split from the warp (``affine_warp``, ``apply_augment``), so given
(theta, tx, ty, flip) can be warped too.
"""

from __future__ import annotations

import math

import torch

from tpusr_torch.core import prng


def affine_warp(img: torch.Tensor, theta_deg, tx, ty) -> torch.Tensor:
    """Warp like Keras ``apply_affine_transform``: one (H, W, C) image with
    scalar parameters, or an (N, H, W, C) batch with (N,) parameters.

    ``theta_deg`` rotates; ``tx``/``ty`` shift along rows/cols in pixels.
    Sampling is bilinear with edge clamp (scipy order=1, mode='nearest'),
    output coordinates mapped through the matrix into the input; every step
    in float32, as the JAX function rounds it.
    """
    single = img.dim() == 3
    x = img[None] if single else img
    n, h, w, _ = x.shape
    dev = x.device

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1, 1, 1)

    t = vec(theta_deg) * torch.tensor(math.pi / 180.0, dtype=torch.float32)
    tx, ty = vec(tx), vec(ty)
    ct, st = torch.cos(t), torch.sin(t)
    # closed form of Keras's permuted, centre-offset rotation-then-shift
    m0 = ct * tx - st * ty
    m1 = st * tx + ct * ty
    o0 = h / 2.0 - 0.5
    o1 = w / 2.0 - 0.5
    b0 = o0 - (ct * o0 - st * o1) + m0
    b1 = o1 - (st * o0 + ct * o1) + m1

    rr = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    cc = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w)
    sr = (ct * rr + st * cc + b1).clamp(0.0, h - 1.0)
    sc = (-st * rr + ct * cc + b0).clamp(0.0, w - 1.0)
    r0, c0 = torch.floor(sr), torch.floor(sc)
    fr = (sr - r0)[..., None]
    fc = (sc - c0)[..., None]
    r0i, c0i = r0.long(), c0.long()
    r1i = (r0i + 1).clamp(max=h - 1)
    c1i = (c0i + 1).clamp(max=w - 1)
    bi = torch.arange(n, device=dev).reshape(n, 1, 1)
    v00, v01 = x[bi, r0i, c0i], x[bi, r0i, c1i]
    v10, v11 = x[bi, r1i, c0i], x[bi, r1i, c1i]
    top = v00 * (1 - fc) + v01 * fc
    bot = v10 * (1 - fc) + v11 * fc
    out = top * (1 - fr) + bot * fr
    return out[0] if single else out


def draw_augment_params(key, n: int, h: int, w: int,
                        rotation_range: float = 20.0,
                        width_shift_range: float = 0.2,
                        height_shift_range: float = 0.2,
                        horizontal_flip: bool = True, device=None):
    """(theta, tx, ty, flip), each (n,), drawn as
    ``ImageDataGenerator.get_random_transform`` draws them: theta ~ U(-rot,
    rot) degrees; row/col shifts ~ U(-s, s), scaled by h (resp. w) when
    |shift| < 1; flip with p = 0.5 (all False without ``horizontal_flip``).
    JAX's draws from ``key`` (``split(key, 4)``, three uniforms and a
    bernoulli, ``tpusr/data/augment.py``), made on ``device``."""
    k1, k2, k3, k4 = prng.split(key, 4)
    theta = prng.uniform(k1, (n,), -rotation_range, rotation_range, device)
    tx = prng.uniform(k2, (n,), -height_shift_range, height_shift_range,
                      device)
    tx = torch.where(tx.abs() < 1.0, tx * h, tx)
    ty = prng.uniform(k3, (n,), -width_shift_range, width_shift_range, device)
    ty = torch.where(ty.abs() < 1.0, ty * w, ty)
    if horizontal_flip:
        flip = prng.bernoulli(k4, 0.5, (n,), device)
    else:
        flip = torch.zeros(n, dtype=torch.bool, device=device)
    return theta, tx, ty, flip


def apply_augment(batch: torch.Tensor, theta, tx, ty, flip) -> torch.Tensor:
    """Warp each image of an NHWC batch, then flip the ones ``flip`` marks
    (Keras flips after the warp)."""
    out = affine_warp(batch, theta, tx, ty)
    return torch.where(flip.reshape(-1, 1, 1, 1), out.flip(2), out)


def random_augment_batch(key, batch: torch.Tensor,
                         rotation_range: float = 20.0,
                         width_shift_range: float = 0.2,
                         height_shift_range: float = 0.2,
                         horizontal_flip: bool = True) -> torch.Tensor:
    """Per-image random affine + hflip over an NHWC batch (Keras defaults),
    drawn from the PRNG key ``key`` as JAX draws them."""
    n, h, w = batch.shape[:3]
    params = draw_augment_params(key, n, h, w, rotation_range,
                                 width_shift_range, height_shift_range,
                                 horizontal_flip, device=batch.device)
    return apply_augment(batch, *params)
