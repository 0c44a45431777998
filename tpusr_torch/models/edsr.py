"""EDSR (port of ``tpusr/models/edsr.py``): head conv -> residual blocks ->
body conv + global skip -> DCR pixel-shuffle upsampling -> tail conv ->
clip [0, 1].

Activations are NHWC and conv kernels HWIO, as in the JAX package; every 3x3
conv runs through K2 (``conv3x3``): ``conv3x3_bias_act``, or
``conv3x3_bias_act_train`` (K2 forward and K2 input gradient, float32 or
bfloat16) where grad mode is on and the conv's input, kernel or bias requires
grad (``trainable()``, or the trainers' state). Submodule names mirror the flax tree (``head``, ``res{i}.conv1``/
``conv2``, ``body``, ``up0``/``up1``, ``tail``), so a flax tree maps onto
the state dict key for key.
"""

from __future__ import annotations

import torch
from torch import nn

from tpusr_torch.core.conv3x3 import (conv3x3_bias_act,
                                      conv3x3_bias_act_train)
from tpusr_torch.models.init import ParamRng, dense_params, param_rng
from tpusr_torch.models.layers import pixel_shuffle


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """A 3x3 SAME conv on K2, with K2's gradient where autograd needs one.
    A bf16 bias (the bf16 training forward casts every weight) is added in
    fp32 at its rounded value, as K2 takes it."""
    if bias.dtype == torch.bfloat16:
        bias = bias.float()
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad
                                    or bias.requires_grad):
        return conv3x3_bias_act_train(x, kernel, bias, relu)
    return conv3x3_bias_act(x.contiguous(), kernel, bias, relu)


class Conv3x3(nn.Module):
    """3x3 SAME conv with an HWIO ``kernel`` and a ``bias``, run by K2,
    drawn as the flax conv of scope ``rng`` draws them, on the device
    ``rng`` carries. ``init_scale`` 2.0 is flax's he_normal (EDSR), 1.0 its
    lecun_normal (the ``nn.Conv`` default)."""

    def __init__(self, cin: int, cout: int, rng: ParamRng,
                 init_scale: float = 2.0):
        super().__init__()
        rng = param_rng(rng)
        kernel, bias = dense_params(rng, (3, 3, cin, cout), rng.device,
                                    init_scale)
        self.kernel = nn.Parameter(kernel, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return conv3x3(x, self.kernel, self.bias, relu)


class ResBlock(nn.Module):
    def __init__(self, filters: int, rng: ParamRng):
        super().__init__()
        self.conv1 = Conv3x3(filters, filters, rng.child("conv1"))
        self.conv2 = Conv3x3(filters, filters, rng.child("conv2"))


class EDSR(nn.Module):
    """EDSR x2/x3/x4. Runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``), where its weights are made; they are flax's
    ``init`` from ``key`` (a PRNG key,
    or an int seed for ``PRNGKey(seed)``; by default ``PRNGKey(42)``, the
    JAX trainer's) or are loaded with
    ``tpusr_torch.bridge.edsr_from_flax``, without gradients until
    ``trainable()``."""

    def __init__(self, scale_factor: int = 2, channels: int = 3,
                 num_res_blocks: int = 16, num_filters: int = 64,
                 res_scaling: float = 0.1, device=None, key=None):
        super().__init__()
        if scale_factor not in (2, 3, 4):
            raise ValueError(f"scale factor {scale_factor} not supported")
        r = param_rng(key, device)
        f = num_filters
        self.init_args = dict(scale_factor=scale_factor, channels=channels,
                              num_res_blocks=num_res_blocks,
                              num_filters=num_filters, res_scaling=res_scaling)
        self.scale_factor = scale_factor
        self.num_res_blocks = num_res_blocks
        self.res_scaling = res_scaling
        self.head = Conv3x3(channels, f, r.child("head"))
        for i in range(num_res_blocks):
            self.add_module(f"res{i}", ResBlock(f, r.child(f"res{i}")))
        self.body = Conv3x3(f, f, r.child("body"))
        if scale_factor in (2, 3):
            self.up0 = Conv3x3(f, f * scale_factor ** 2, r.child("up0"))
        else:  # x4 = two chained x2 stages
            self.up0 = Conv3x3(f, f * 4, r.child("up0"))
            self.up1 = Conv3x3(f, f * 4, r.child("up1"))
        self.tail = Conv3x3(f, channels, r.child("tail"))

    def trainable(self, on: bool = True) -> "EDSR":
        """Turn the weights' gradients on (or off); returns the model."""
        return self.requires_grad_(on)

    def tail_convs(self) -> dict[str, Conv3x3]:
        """The linear upsample tail: up conv(s) and the final conv."""
        names = ("up0", "tail") if self.scale_factor in (2, 3) else (
            "up0", "up1", "tail")
        return {n: getattr(self, n) for n in names}

    def conv_params(self, dtype=torch.float32) -> dict:
        """Conv name (``head``, ``res{i}.conv1``, ...) -> (kernel in
        ``dtype``, bias rounded to ``dtype`` and held in float32, as K2
        takes it). For float32 these are the module's own tensors."""
        return {name: (m.kernel.to(dtype), m.bias.to(dtype).float())
                for name, m in self.named_modules() if isinstance(m, Conv3x3)}

    def body_out(self, x: torch.Tensor, params: dict | None = None
                 ) -> torch.Tensor:
        """Head, residual blocks, body conv and the global skip, in x's
        dtype, with ``params`` from ``conv_params`` (by default the
        modules' own weights in their dtype: float32, or the bf16 training
        forward's casts)."""
        if params is None:
            # the modules themselves, so forward hooks (dist.tp_modules) see
            # every conv
            def conv(name, t, relu=False):
                return self.get_submodule(name)(t, relu)
        else:
            def conv(name, t, relu=False):
                return conv3x3(t, *params[name], relu)

        head = y = conv("head", x)
        for i in range(self.num_res_blocks):
            t = conv(f"res{i}.conv2", conv(f"res{i}.conv1", y, relu=True))
            y = y + self.res_scaling * t
        return conv("body", y) + head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.body_out(x)
        if self.scale_factor in (2, 3):
            y = pixel_shuffle(self.up0(y), self.scale_factor)
        else:
            y = pixel_shuffle(self.up0(y), 2)
            y = pixel_shuffle(self.up1(y), 2)
        # clip as jnp.clip: gradient 0.5 at exactly 0 and 1 (clamp's is 1)
        y = self.tail(y)
        return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))
