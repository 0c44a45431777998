"""flax param trees <-> the port's modules, and flax trees -> int8 trees.

The one place that converts layouts, both ways (``*_from_flax`` into the
port; ``to_flax_tree`` and the per-network ``*_to_flax`` out of it, for the
Keras exporter and the tests). A flax tree is a nested dict of arrays
(anything ``np.asarray`` takes); flax keeps NHWC activations, HWIO conv
kernels and Dense kernels as (in, out). The port keeps HWIO where its own
kernels take it (EDSR's and ESRGAN's K2 convs, the int8 tree's K1 weights, the
SN convs), flax's (in, out) in its matrix products (SN Dense, the attention's
1x1 convs as (Cin, Cout) matrices) and PyTorch's layouts in PyTorch's own
layers (OIHW ``nn.Conv2d``, (out, in) ``nn.Linear``).
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


def flax_path(name: str) -> tuple[str, ...]:
    """A port parameter name -> the path of the same leaf in the flax tree:
    ``vgg16.block5_conv3.weight`` -> ``("vgg16", "block5_conv3", "kernel")``,
    ``res0.conv1.kernel`` -> ``("res0", "conv1", "kernel")``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def srcnn_from_flax(params: dict, device=None):
    """``tpusr.models.SRCNN`` params -> ``tpusr_torch.models.srcnn.SRCNN``."""
    from tpusr_torch.models.srcnn import SRCNN

    k1 = np.shape(params["conv1"]["kernel"])
    model = SRCNN(channels=k1[2], f1=k1[3],
                  f2=np.shape(params["conv2"]["kernel"])[3],
                  device=resolve_device(device))
    sd = {}
    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.weight"] = hwio_to_oihw(_tensor(params[name]["kernel"]))
        sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    model.load_state_dict(sd, strict=True)
    return model


def vgg16_from_flax(params: dict, device=None, dropout_rate: float = 0.2):
    """``tpusr.models.VGG16Classifier`` params (VGG16 block names; any block
    widths) -> ``tpusr_torch.models.vgg.VGG16Classifier``."""
    from tpusr_torch.models.vgg import VGG16_CFG, VGG16Classifier

    bb = params["vgg16"]
    widths = tuple(np.shape(bb[f"block{b}_conv1"]["kernel"])[-1]
                   for b, _n, _f in VGG16_CFG)
    model = VGG16Classifier(
        num_classes=np.shape(params["predictions"]["bias"])[0],
        dense_units=np.shape(params["fc1"]["bias"])[0], widths=widths,
        device=resolve_device(device), dropout_rate=dropout_rate)
    sd = {}
    for name, p in bb.items():
        sd[f"vgg16.{name}.weight"] = hwio_to_oihw(_tensor(p["kernel"]))
        sd[f"vgg16.{name}.bias"] = _tensor(p["bias"])
    for name in ("fc1", "predictions"):
        sd[f"{name}.weight"] = dense_to_linear(_tensor(params[name]["kernel"]))
        sd[f"{name}.bias"] = _tensor(params[name]["bias"])
    model.load_state_dict(sd, strict=True)
    return model


def vgg19_features_from_flax(params: dict, device=None):
    """``tpusr.models.VGG19Features`` params (any block widths) ->
    ``tpusr_torch.models.vgg.VGG19Features``."""
    from tpusr_torch.models.vgg import VGG19_CFG, VGG19Features

    bb = params["vgg19"]
    widths = tuple(np.shape(bb[f"block{b}_conv1"]["kernel"])[-1]
                   for b, _n, _f in VGG19_CFG)
    model = VGG19Features(widths=widths, device="cpu")
    sd = {}
    for name, p in bb.items():
        sd[f"vgg19.{name}.weight"] = hwio_to_oihw(_tensor(p["kernel"]))
        sd[f"vgg19.{name}.bias"] = _tensor(p["bias"])
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device))


def qtree_from_flax(q: dict, device=None) -> dict:
    """A JAX ``quantize_vgg16`` tree -> the port's int8 tree: the same keys,
    torch tensors on ``device`` (kernel_q int8 HWIO, as K1's public
    signature takes it; the head's Dense kernels stay (in, out)), scales as
    Python floats, plus each layer's ``kernel_packed``, the K-major copy K1
    reads."""
    from tpusr_torch.core.conv3x3 import pack_int8_kernel
    dev = resolve_device(device)
    layers = {}
    for name, p in q["layers"].items():
        kq = _tensor(p["kernel_q"], torch.int8).contiguous()
        layers[name] = {"kernel_q": kq.to(dev),
                        "kernel_packed": pack_int8_kernel(kq).to(dev),
                        "rescale": _tensor(p["rescale"]).to(dev),
                        "bias_over_out": _tensor(p["bias_over_out"]).to(dev)}
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
    ``pad`` and ``n_res`` as ints and the scales as Python floats, plus each
    3x3 layer's ``kernel_packed``, the K-major copy its conv kernel reads."""
    from tpusr_torch.core.conv3x3 import pack_int8_kernel
    dev = resolve_device(device)
    layers = {}
    for name, p in q["layers"].items():
        layer = {"kernel_q": _tensor(p["kernel_q"], torch.int8).contiguous()}
        if layer["kernel_q"].shape[0] == 3:
            layer["kernel_packed"] = pack_int8_kernel(layer["kernel_q"])
        for key in ("rescale", "bias", "inv_s_in", "rescale_carry",
                    "bias_carry"):
            if key in p:
                layer[key] = _tensor(p[key])
        layers[name] = {k: v.to(dev) for k, v in layer.items()}
    return {"layers": layers, "pad": int(q["pad"]), "n_res": int(q["n_res"]),
            "act_scales": {k: float(v) for k, v in q["act_scales"].items()}}


def _with_1x1_as_matrix(name: str, t: torch.Tensor) -> torch.Tensor:
    """flax's 1x1 conv kernels (1, 1, Cin, Cout) -> the port's ``Conv1x1``
    (Cin, Cout); any other leaf as it is."""
    if name.endswith(".kernel") and t.dim() == 4 and t.shape[:2] == (1, 1):
        return t[0, 0]
    return t


def esrgan_generator_from_flax(params: dict, device=None,
                               attention_block_size: int | None = None):
    """``tpusr.models.ESRGANGenerator`` params -> ``tpusr_torch.models.
    esrgan.ESRGANGenerator``; the configuration is read off the tree."""
    from tpusr_torch.models.esrgan import ESRGANGenerator

    n_up = sum(1 for k in params if k.startswith("upsample_"))
    model = ESRGANGenerator(
        scale_factor=2 ** n_up,
        growth_channels=np.shape(params["rrdb_0"]["dense1"]["conv1"]["kernel"])[-1],
        num_rrdb_blocks=sum(1 for k in params if k.startswith("rrdb_")),
        channels=np.shape(params["final_conv2"]["kernel"])[-1],
        base_filters=np.shape(params["initial_conv"]["kernel"])[-1],
        attention_block_size=attention_block_size, device="cpu")
    sd = {k: _with_1x1_as_matrix(k, _tensor(v))
          for k, v in _flatten(params).items()}
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device))


def esrgan_discriminator_from_flax(params: dict, spectral: dict, device=None):
    """``tpusr.models.ESRGANDiscriminator`` params and its ``spectral``
    collection (each SN layer's ``u``) -> ``tpusr_torch.models.esrgan.
    ESRGANDiscriminator``."""
    from tpusr_torch.models.esrgan import ESRGANDiscriminator

    model = ESRGANDiscriminator(
        channels=np.shape(params["conv1"]["kernel"])[2], device="cpu")
    sd = {k: _tensor(v) for k, v in _flatten(params).items()}
    sd.update({k: _tensor(v) for k, v in _flatten(spectral).items()})
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device))


def lpips_alex_from_arrays(flat: dict, device=None):
    """An LPIPS-alex bundle (``conv{i}/kernel`` HWIO, ``conv{i}/bias``,
    ``lin{i}/weight``; ``tpusr_torch.tools.lpips_weights``) ->
    ``tpusr_torch.metrics.lpips.LPIPSAlex``."""
    from tpusr_torch.metrics.lpips import LPIPSAlex
    from tpusr_torch.tools.lpips_weights import validate

    validate(flat)
    model = LPIPSAlex(device="cpu")
    sd = {}
    for i in range(1, 6):
        sd[f"conv{i}.weight"] = hwio_to_oihw(_tensor(flat[f"conv{i}/kernel"]))
        sd[f"conv{i}.bias"] = _tensor(flat[f"conv{i}/bias"])
        sd[f"lin{i}"] = _tensor(flat[f"lin{i}/weight"])
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device))


def vgg_backbone_from_arrays(model, layers: dict, backbone_key: str,
                             source: str = "weights") -> None:
    """Write {layer: {'kernel': HWIO, 'bias': ...}} (a converted ImageNet
    ``.npz``, ``tools/imagenet_weights.py``) into ``model``'s
    ``backbone_key`` convs (OIHW ``nn.Conv2d``), in place. Every layer must
    exist in the backbone at its shape."""
    backbone = getattr(model, backbone_key)
    with torch.no_grad():
        for layer, leaves in layers.items():
            conv = backbone[layer] if layer in backbone else None
            if conv is None:
                raise ValueError(f"{source}: unexpected layer {layer} for "
                                 f"backbone {backbone_key}")
            for leaf, arr in leaves.items():
                t = _tensor(arr)
                if leaf == "kernel":
                    dst, t = conv.weight, hwio_to_oihw(t)
                elif leaf == "bias":
                    dst = conv.bias
                else:
                    raise ValueError(f"{source}: unexpected leaf {layer}/{leaf}")
                if t.shape != dst.shape:
                    want = oihw_to_hwio(dst) if leaf == "kernel" else dst
                    raise ValueError(f"{source}:{layer}/{leaf}: shape "
                                     f"{tuple(np.shape(arr))}, the model "
                                     f"wants {tuple(want.shape)}")
                dst.copy_(t.to(dst.device, dst.dtype))


# ------------------------------------------------------- the port -> flax
def to_flax_tree(params: dict) -> dict:
    """Port parameters (name -> tensor, as ``named_parameters``, a
    ``state_dict`` or a trainer's ``TrainState.params`` hold them) -> a
    nested flax tree of numpy arrays in flax's layouts: ``nn.Conv2d``'s
    OIHW ``weight`` -> HWIO ``kernel``, ``nn.Linear``'s (out, in) ->
    Dense's (in, out); every other leaf as it is."""
    tree: dict = {}
    for name, t in params.items():
        a = t.detach().cpu()
        if name.endswith(".weight"):
            a = oihw_to_hwio(a) if a.dim() == 4 else dense_to_linear(a)
        *path, leaf = flax_path(name)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a.numpy().copy()
    return tree


def esrgan_generator_to_flax(params: dict) -> dict:
    """Generator parameters -> flax's tree: as ``to_flax_tree``, with the
    attention's ``Conv1x1`` (Cin, Cout) matrices back to flax's
    (1, 1, Cin, Cout) kernels."""
    tree = to_flax_tree(params)
    for name, node in tree.items():
        if name.startswith("self_attention"):
            for sub in node.values():
                if sub["kernel"].ndim == 2:
                    sub["kernel"] = sub["kernel"][None, None]
    return tree
