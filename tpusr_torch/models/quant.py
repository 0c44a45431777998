"""Post-training int8 quantization of the VGG16 classifier (port of
``tpusr/models/quant.py``).

- weights: symmetric per-output-channel int8;
- activations: symmetric per-tensor int8 with max-abs scales calibrated on a
  f32 forward;
- each conv runs int8 x int8 -> int32 with the fused f32 requant to the next
  layer's grid: K1 (``conv3x3_int8_requant``), except block 1 of the
  per-patch path on whole images (``per_patch_int8_probs``), which K3
  (``models/block1.py``) fuses with the patch extraction and the pool
  wherever it takes the call (an even patch; width 64 on a card);
- the head (GAP -> Dense 256 -> Dense softmax) stays f32.

The int8 tree mirrors the JAX one key for key (``tpusr_torch.bridge.
qtree_from_flax`` converts one). Arithmetic follows quant.py step by step so
the int8 activations match bit for bit: scales are Python floats used as f32
values, and a division by a scale divides by an f32 tensor on the operand's
device (a CUDA division by a host scalar multiplies by its reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpusr_torch.bridge import dense_to_linear, oihw_to_hwio
from tpusr_torch.core.conv3x3 import conv3x3_int8_requant, pack_int8_kernel
from tpusr_torch.models import block1
from tpusr_torch.models.block1 import (block1_int8, extract_patches_reference,
                                       max_pool2x2)
from tpusr_torch.models.vgg import VGG16_CFG


def f32(value: float, device) -> torch.Tensor:
    """A Python float as a 0-dim float32 tensor on ``device``."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def calibrate_vgg16(model, sample_patches) -> dict:
    """Per-layer activation max-abs on the f32 forward of ``model`` (a
    ``VGG16Classifier``). Returns {layer_name: scale}, the input scale keyed
    '__input__'."""
    x = torch.as_tensor(np.array(sample_patches, np.float32)
                        if not torch.is_tensor(sample_patches)
                        else sample_patches,
                        dtype=torch.float32, device=_model_device(model))
    with torch.inference_mode():
        scales = {"__input__": max(float(x.abs().max()) / 127.0, 1e-8)}
        x = x.permute(0, 3, 1, 2)
        for block, n_convs, _f in VGG16_CFG:
            for ci in range(1, n_convs + 1):
                name = f"block{block}_conv{ci}"
                x = F.relu(model.vgg16[name](x))
                scales[name] = max(float(x.max()) / 127.0, 1e-8)
            x = F.max_pool2d(x, 2, 2)
    return scales


def quantize_vgg16(model, act_scales: dict) -> dict:
    """Quantize ``model``'s backbone to per-channel int8 and precompute the
    fused rescale factors. Computed on the CPU in float32 (device-independent,
    as quant.py:57-87 computes it), then placed on the model's device. Each
    layer also keeps K1's K-major copy of its kernel (``kernel_packed``)."""
    dev = _model_device(model)
    cpu = torch.device("cpu")
    q = {"act_scales": dict(act_scales), "layers": {}}
    prev_scale = act_scales["__input__"]
    for block, n_convs, _f in VGG16_CFG:
        for ci in range(1, n_convs + 1):
            name = f"block{block}_conv{ci}"
            conv = model.vgg16[name]
            k = oihw_to_hwio(conv.weight.detach().cpu().float()).contiguous()
            b = conv.bias.detach().cpu().float()
            w_scale = torch.clamp_min(k.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
            k_q = torch.round(k / w_scale).clamp(-127, 127).to(torch.int8)
            out_scale = act_scales[name]
            # y_f32 = y_int32 * prev_scale * w_scale + bias, then / out_scale;
            # the +0.5 in the bias turns the truncating cast into round-half-up
            rescale = f32(prev_scale, cpu) * w_scale / f32(out_scale, cpu)
            bias_over_out = b / f32(out_scale, cpu) + 0.5
            q["layers"][name] = {"kernel_q": k_q.to(dev),
                                 "kernel_packed": pack_int8_kernel(k_q).to(dev),
                                 "rescale": rescale.to(dev),
                                 "bias_over_out": bias_over_out.to(dev)}
            prev_scale = out_scale
    q["final_scale"] = prev_scale
    q["head"] = {
        name: {"kernel": dense_to_linear(lin.weight.detach()).float().contiguous(),
               "bias": lin.bias.detach().float().clone()}
        for name, lin in (("fc1", model.fc1), ("predictions", model.predictions))}
    return q


def quantize_input(q: dict, images: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images -> the classifier's int8 input grid."""
    s_in = f32(q["act_scales"]["__input__"], images.device)
    x = torch.round(images.float() / s_in).clamp(-127, 127)
    return x.to(torch.int8)


def int8_backbone(q: dict, x: torch.Tensor, pool5: bool = True,
                  first_block: int = 1) -> torch.Tensor:
    """The int8 VGG16 conv trunk shared by the per-patch and shared-trunk
    paths: K1 convs, stride-2 max pools after blocks 1-4, and after block 5
    only when ``pool5``. ``first_block`` > 1 starts on that block's input
    (the per-patch path runs block 1 through K3). Input/output are int8 on
    ``q``'s grids."""
    for block, n_convs, _f in VGG16_CFG[first_block - 1:]:
        for ci in range(1, n_convs + 1):
            layer = q["layers"][f"block{block}_conv{ci}"]
            x = conv3x3_int8_requant(x.contiguous(), layer["kernel_q"],
                                     layer["rescale"], layer["bias_over_out"],
                                     layer.get("kernel_packed"))
        if block < 5 or pool5:
            x = max_pool2x2(x)
    return x


def head_probs(feats: torch.Tensor, head: dict) -> torch.Tensor:
    """(..., C5) f32 GAP features -> (..., classes) softmax probs."""
    fc1, pred = head["fc1"], head["predictions"]
    h = torch.relu(feats @ fc1["kernel"] + fc1["bias"])
    return torch.softmax(h @ pred["kernel"] + pred["bias"], dim=-1)


def _pooled_head(q: dict, x: torch.Tensor) -> torch.Tensor:
    """(M, h, w, C5) int8 pool5 output -> (M, classes) probs."""
    feats = x.float() * q["final_scale"]
    return head_probs(feats.mean(dim=(1, 2)), q["head"])


def quantized_vgg16_apply(q: dict, patches: torch.Tensor) -> torch.Tensor:
    """int8 backbone + f32 head on extracted patches: (N, H, W, 3) [0, 1]
    (or int8 from ``quantize_input``) -> (N, classes) probs. All 13 convs
    run through K1."""
    x = patches if patches.dtype == torch.int8 else quantize_input(q, patches)
    return _pooled_head(q, int8_backbone(q, x, pool5=True))


def per_patch_int8_probs(q: dict, images: torch.Tensor, patch: int = 96,
                         stride: int = 48) -> torch.Tensor:
    """The per-patch int8 classifier on whole images: (N, H, W, 3) [0, 1] (or
    int8 from ``quantize_input``) -> (N, n_patches, classes) probs in
    row-major patch order. Block 1 runs through K3 (patch extraction
    included), blocks 2-5 through K1, the head in f32; the values equal
    ``quantized_vgg16_apply`` on the extracted patches, which is what runs
    where K3 does not take the call (an odd patch, or a block-1 width other
    than 64 on a card): 13 K1 launches, the VALID pools flooring as JAX's
    do."""
    x = images if images.dtype == torch.int8 else quantize_input(q, images)
    x = x.contiguous()
    if block1.takes(q, x, patch):
        pooled = block1_int8(q, x, patch, stride)
        probs = _pooled_head(q, int8_backbone(q, pooled, pool5=True,
                                              first_block=2))
    else:
        probs = quantized_vgg16_apply(
            q, extract_patches_reference(x, patch, stride))
    return probs.reshape(x.shape[0], -1, probs.shape[-1])
