"""EDSR (port of ``tpusr/models/edsr.py``): head conv -> residual blocks ->
body conv + global skip -> DCR pixel-shuffle upsampling -> tail conv ->
clip [0, 1].

Activations are NHWC and conv kernels HWIO, as in the JAX package; every 3x3
conv runs through K2 (``conv3x3_bias_act``). Submodule names mirror the flax
tree (``head``, ``res{i}.conv1``/``conv2``, ``body``, ``up0``/``up1``,
``tail``), so a flax tree maps onto the state dict key for key.
"""

from __future__ import annotations

import torch
from torch import nn

from tpusr_torch.core.conv3x3 import conv3x3_bias_act
from tpusr_torch.device import resolve_device
from tpusr_torch.models.init import default_generator, variance_scaling
from tpusr_torch.models.layers import pixel_shuffle


class Conv3x3(nn.Module):
    """3x3 SAME conv with an HWIO ``kernel`` and a ``bias``, run by K2."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        # flax he_normal: variance 2 / fan_in, truncated normal
        self.kernel = nn.Parameter(
            variance_scaling((3, 3, cin, cout), 9 * cin, 2.0, generator),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return conv3x3_bias_act(x.contiguous(), self.kernel, self.bias, relu)


class ResBlock(nn.Module):
    def __init__(self, filters: int, generator: torch.Generator):
        super().__init__()
        self.conv1 = Conv3x3(filters, filters, generator)
        self.conv2 = Conv3x3(filters, filters, generator)


class EDSR(nn.Module):
    """EDSR x2/x3/x4 for inference. Runs on ``device`` (CUDA unless the
    caller passes ``device="cpu"``); weights come from ``generator`` or are
    loaded with ``tpusr_torch.bridge.edsr_from_flax``."""

    def __init__(self, scale_factor: int = 2, channels: int = 3,
                 num_res_blocks: int = 16, num_filters: int = 64,
                 res_scaling: float = 0.1, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if scale_factor not in (2, 3, 4):
            raise ValueError(f"scale factor {scale_factor} not supported")
        dev = resolve_device(device)
        g = default_generator(generator)
        f = num_filters
        self.scale_factor = scale_factor
        self.num_res_blocks = num_res_blocks
        self.res_scaling = res_scaling
        self.head = Conv3x3(channels, f, g)
        for i in range(num_res_blocks):
            self.add_module(f"res{i}", ResBlock(f, g))
        self.body = Conv3x3(f, f, g)
        if scale_factor in (2, 3):
            self.up0 = Conv3x3(f, f * scale_factor ** 2, g)
        else:  # x4 = two chained x2 stages
            self.up0 = Conv3x3(f, f * 4, g)
            self.up1 = Conv3x3(f, f * 4, g)
        self.tail = Conv3x3(f, channels, g)
        self.to(dev)

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
        module's own float32 weights)."""
        params = self.conv_params() if params is None else params

        def conv(name, t, relu=False):
            k, b = params[name]
            return conv3x3_bias_act(t.contiguous(), k, b, relu)

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
        return self.tail(y).clamp(0.0, 1.0)
