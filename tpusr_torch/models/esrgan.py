"""ESRGAN (port of ``tpusr/models/esrgan.py``): the RRDB generator with
self-attention and the spectral-norm discriminator.

- Generator (ESRGAN_model.py:303-345): Conv64 -> N RRDB blocks (3 dense
  blocks of 5 convs with growth-channel concatenation, x0.2 residual scaling
  at both levels) -> trunk conv + skip -> SelfAttention(64) -> log2(scale)
  upsample blocks (Conv 4f -> DCR pixel shuffle x2 -> LeakyReLU(0.2),
  SelfAttention after the first) -> Conv64 relu -> Conv(channels) tanh.
  Output range [-1, 1]. The notebook config (growth 8, 4 RRDB, x2) has
  1,162,915 parameters.
- Discriminator (:347-377): 6 spectrally-normalized convs (64 s1; then 64,
  64, 128, 128, 256 at strides 2, 1, 2, 1, 2), LeakyReLU(0.2), GAP ->
  SN-Dense 256 -> SN-Dense 1 sigmoid. 658,305 parameters + 961 spectral u.

Activations are NHWC and conv kernels HWIO, as in the JAX package. Every 3x3
stride-1 conv of the generator runs through K2 (``edsr.conv3x3``), as the
port's EDSR does; the dense blocks concatenate on the channel axis, in JAX's
order ``[x, x1, ...]``, into a contiguous tensor, which K2 takes. The
discriminator's strided SN convs are ``F.conv2d``. Submodule names mirror the
flax trees, so ``tpusr_torch.bridge`` maps them key for key.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.core import prng
from tpusr_torch.models.edsr import Conv3x3
from tpusr_torch.models.init import DEFAULT_KEY, ParamRng, param_rng
from tpusr_torch.models.layers import (SelfAttention, SNConv, SNDense,
                                       pixel_shuffle)

LEAKY_SLOPE = 0.2


def _conv(cin: int, cout: int, rng: ParamRng) -> Conv3x3:
    """flax ``nn.Conv(cout, (3, 3), padding="SAME")`` of scope ``rng``:
    lecun_normal, zero bias."""
    return Conv3x3(cin, cout, rng, init_scale=1.0)


class DenseBlock(nn.Module):
    """Five-conv dense block with growth-channel concatenation
    (ESRGAN_model.py:212-254)."""

    def __init__(self, in_ch: int, growth: int, rng: ParamRng):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", _conv(in_ch + i * growth, growth,
                                                  rng.child(f"conv{i + 1}")))
        self.conv5 = _conv(in_ch + 4 * growth, in_ch, rng.child("conv5"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            conv = getattr(self, f"conv{i + 1}")
            feats.append(conv(torch.cat(feats, -1) if i else x, relu=True))
        return x + 0.2 * self.conv5(torch.cat(feats, -1))


class RRDB(nn.Module):
    """Residual-in-residual dense block (ESRGAN_model.py:256-282)."""

    def __init__(self, in_ch: int, growth: int, rng: ParamRng):
        super().__init__()
        self.dense1 = DenseBlock(in_ch, growth, rng.child("dense1"))
        self.dense2 = DenseBlock(in_ch, growth, rng.child("dense2"))
        self.dense3 = DenseBlock(in_ch, growth, rng.child("dense3"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.dense3(self.dense2(self.dense1(x)))


class ESRGANGenerator(nn.Module):
    """The RRDB generator, x``scale_factor`` (a power of 2), on ``device``
    (CUDA unless the caller passes ``device="cpu"``, its weights made
    there); weights are flax's
    ``init`` from ``key`` (a PRNG key, or an int seed; by default the
    first of ``split(PRNGKey(42))``, the JAX GAN trainer's) or loaded with
    ``tpusr_torch.bridge.esrgan_generator_from_flax``, without gradients
    until ``trainable()``.

    ``attention_block_size`` (blockwise online-softmax attention, O(HW *
    block) memory; must divide the token count at each attention site) and
    ``attention_fn`` (a full override of the attention inner computation)
    apply at both attention sites; they are configuration, not parameters,
    and may be changed between calls."""

    def __init__(self, scale_factor: int = 2, growth_channels: int = 32,
                 num_rrdb_blocks: int = 23, channels: int = 3,
                 base_filters: int = 64,
                 attention_block_size: int | None = None,
                 attention_fn: "typing.Callable | None" = None, device=None,
                 key=None):
        super().__init__()
        num_up = int(math.log2(scale_factor)) if scale_factor >= 1 else -1
        if num_up < 0 or 2 ** num_up != scale_factor:
            # int(log2(3)) == 1 would silently build an x2 generator against
            # x3 targets
            raise ValueError(
                f"ESRGANGenerator scale_factor must be a power of 2 "
                f"(log2(scale) upsample blocks, ESRGAN_model.py:327-339); "
                f"got {scale_factor}")
        r = param_rng(prng.split(DEFAULT_KEY)[0] if key is None else key,
                      device)
        f = base_filters
        self.init_args = dict(scale_factor=scale_factor,
                              growth_channels=growth_channels,
                              num_rrdb_blocks=num_rrdb_blocks,
                              channels=channels, base_filters=base_filters)
        self.scale_factor = scale_factor
        self.num_rrdb_blocks = num_rrdb_blocks
        self.num_up = num_up
        self.attention_block_size = attention_block_size
        self.attention_fn = attention_fn
        self.initial_conv = _conv(channels, f, r.child("initial_conv"))
        for i in range(num_rrdb_blocks):
            self.add_module(f"rrdb_{i}", RRDB(f, growth_channels,
                                              r.child(f"rrdb_{i}")))
        self.trunk_conv = _conv(f, f, r.child("trunk_conv"))
        self.self_attention_trunk = SelfAttention(
            f, rng=r.child("self_attention_trunk"))
        for i in range(num_up):
            self.add_module(f"upsample_{i}_conv",
                            _conv(f, 4 * f, r.child(f"upsample_{i}_conv")))
            if i == 0:
                self.self_attention_upsample_0 = SelfAttention(
                    f, rng=r.child("self_attention_upsample_0"))
        self.final_conv1 = _conv(f, f, r.child("final_conv1"))
        self.final_conv2 = _conv(f, channels, r.child("final_conv2"))

    def trainable(self, on: bool = True) -> "ESRGANGenerator":
        """Turn the weights' gradients on (or off); returns the model."""
        return self.requires_grad_(on)

    def _attend(self, layer: SelfAttention, y: torch.Tensor) -> torch.Tensor:
        return layer.attend(y, self.attention_block_size, self.attention_fn)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The convolutional trunk, up to the first attention: the initial
        conv, the RRDB blocks, the trunk conv and the skip."""
        trunk_in = self.initial_conv(x)
        y = trunk_in
        for i in range(self.num_rrdb_blocks):
            y = getattr(self, f"rrdb_{i}")(y)
        return trunk_in + self.trunk_conv(y)

    def tail(self, t: torch.Tensor) -> torch.Tensor:
        """From the trunk's output to the image: the trunk attention, the
        upsample blocks and the final convs."""
        y = self._attend(self.self_attention_trunk, t)
        for i in range(self.num_up):
            y = pixel_shuffle(getattr(self, f"upsample_{i}_conv")(y), 2)
            y = F.leaky_relu(y, LEAKY_SLOPE)
            if i == 0:
                y = self._attend(self.self_attention_upsample_0, y)
        y = self.final_conv1(y, relu=True)
        return torch.tanh(self.final_conv2(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, channels) in [-1, 1] -> (N, sH, sW, channels) in
        [-1, 1]."""
        return self.tail(self.trunk(x))


class ESRGANDiscriminator(nn.Module):
    """The spectral-norm discriminator on ``device`` (CUDA unless
    ``device="cpu"``): (N, H, W, 3) -> (N, 1) sigmoid scores. With
    ``update_stats=True`` every SN layer runs one power-iteration step on its
    ``u``."""

    def __init__(self, channels: int = 3, device=None, key=None):
        """Weights and ``u`` are flax's ``init`` from ``key`` (a PRNG key,
        or an int seed; by default the second of ``split(PRNGKey(42))``,
        the JAX GAN trainer's), made on ``device``."""
        super().__init__()
        r = param_rng(prng.split(DEFAULT_KEY)[1] if key is None else key,
                      device)
        self.init_args = dict(channels=channels)
        self.conv1 = SNConv(channels, 64, rng=r.child("conv1"))
        cin = 64
        for i, (f, s) in enumerate(zip((64, 64, 128, 128, 256), (2, 1, 2, 1, 2))):
            self.add_module(f"conv{i + 2}", SNConv(
                cin, f, strides=(s, s), rng=r.child(f"conv{i + 2}")))
            cin = f
        self.dense1 = SNDense(cin, 256, rng=r.child("dense1"))
        self.output = SNDense(256, 1, rng=r.child("output"))

    def forward(self, x: torch.Tensor, update_stats: bool = False
                ) -> torch.Tensor:
        y = x
        for i in range(6):
            y = F.leaky_relu(getattr(self, f"conv{i + 1}")(y, update_stats),
                             LEAKY_SLOPE)
        y = y.mean(dim=(1, 2))                       # GAP
        y = F.leaky_relu(self.dense1(y, update_stats), LEAKY_SLOPE)
        return torch.sigmoid(self.output(y, update_stats))
