"""flax param trees -> the port's modules and int8 trees.

The one place that converts layouts. A flax tree is a nested dict of arrays
(anything ``np.asarray`` takes); flax keeps NHWC activations, HWIO conv
kernels and Dense kernels as (in, out). The port keeps HWIO where its own
kernels take it (EDSR's K2 convs, the int8 tree's K1 weights) and PyTorch's
layouts in PyTorch's own layers (OIHW ``nn.Conv2d``, (out, in) ``nn.Linear``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusr_torch.device import resolve_device


def hwio_to_oihw(k: torch.Tensor) -> torch.Tensor:
    return k.permute(3, 2, 0, 1)


def oihw_to_hwio(k: torch.Tensor) -> torch.Tensor:
    return k.permute(2, 3, 1, 0)


def dense_to_linear(k: torch.Tensor) -> torch.Tensor:
    """flax Dense (in, out) <-> nn.Linear (out, in); its own inverse."""
    return k.T


def _tensor(a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a)).to(dtype)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def edsr_from_flax(params: dict, scale_factor: int, res_scaling: float = 0.1,
                   device=None):
    """``tpusr.models.EDSR`` params -> ``tpusr_torch.models.edsr.EDSR``."""
    from tpusr_torch.models.edsr import EDSR

    n_res = sum(1 for k in params if k.startswith("res"))
    head_k = np.shape(params["head"]["kernel"])
    model = EDSR(scale_factor=scale_factor,
                 channels=np.shape(params["tail"]["kernel"])[-1],
                 num_res_blocks=n_res, num_filters=head_k[-1],
                 res_scaling=res_scaling, device=resolve_device(device))
    sd = {k: _tensor(v) for k, v in _flatten(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def vgg16_from_flax(params: dict, device=None):
    """``tpusr.models.VGG16Classifier`` params (VGG16 block names; any block
    widths) -> ``tpusr_torch.models.vgg.VGG16Classifier``."""
    from tpusr_torch.models.vgg import VGG16_CFG, VGG16Classifier

    bb = params["vgg16"]
    widths = tuple(np.shape(bb[f"block{b}_conv1"]["kernel"])[-1]
                   for b, _n, _f in VGG16_CFG)
    model = VGG16Classifier(
        num_classes=np.shape(params["predictions"]["bias"])[0],
        dense_units=np.shape(params["fc1"]["bias"])[0], widths=widths,
        device=resolve_device(device))
    sd = {}
    for name, p in bb.items():
        sd[f"vgg16.{name}.weight"] = hwio_to_oihw(_tensor(p["kernel"]))
        sd[f"vgg16.{name}.bias"] = _tensor(p["bias"])
    for name in ("fc1", "predictions"):
        sd[f"{name}.weight"] = dense_to_linear(_tensor(params[name]["kernel"]))
        sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    model.load_state_dict(sd, strict=True)
    return model


def qtree_from_flax(q: dict, device=None) -> dict:
    """A JAX ``quantize_vgg16`` tree -> the port's int8 tree: the same keys,
    torch tensors on ``device`` (kernel_q int8 HWIO, as K1 takes it; the
    head's Dense kernels stay (in, out)), scales as Python floats."""
    dev = resolve_device(device)
    layers = {
        name: {"kernel_q": _tensor(p["kernel_q"], torch.int8).contiguous().to(dev),
               "rescale": _tensor(p["rescale"]).to(dev),
               "bias_over_out": _tensor(p["bias_over_out"]).to(dev)}
        for name, p in q["layers"].items()}
    head = {name: {"kernel": _tensor(p["kernel"]).to(dev),
                   "bias": _tensor(p["bias"]).to(dev)}
            for name, p in q["head"].items()}
    return {"act_scales": {k: float(v) for k, v in q["act_scales"].items()},
            "layers": layers, "final_scale": float(q["final_scale"]),
            "head": head}


def edsr_qtree_from_flax(q: dict, device=None) -> dict:
    """A JAX ``quantize_edsr`` tree -> the port's int8 EDSR tree: the same
    keys, torch tensors on ``device`` (kernel_q int8 HWIO; rescale, bias,
    rescale_carry and bias_carry float32 vectors; inv_s_in a 0-dim float32),
    ``pad`` and ``n_res`` as ints and the scales as Python floats."""
    dev = resolve_device(device)
    layers = {}
    for name, p in q["layers"].items():
        layer = {"kernel_q": _tensor(p["kernel_q"], torch.int8).contiguous()}
        for key in ("rescale", "bias", "inv_s_in", "rescale_carry",
                    "bias_carry"):
            if key in p:
                layer[key] = _tensor(p[key])
        layers[name] = {k: v.to(dev) for k, v in layer.items()}
    return {"layers": layers, "pad": int(q["pad"]), "n_res": int(q["n_res"]),
            "act_scales": {k: float(v) for k, v in q["act_scales"].items()}}
