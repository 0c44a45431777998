"""VGG16 defect classifier and VGG19 perceptual-feature extractor (port of
``tpusr/models/vgg.py``).

- ``VGG16Classifier``: VGG16 conv base -> global average pool -> Dropout ->
  Dense 256 relu -> Dropout -> Dense softmax; dropout only with
  ``train=True``. It serves the ``per_patch_f32`` mode and the f32
  calibration forward of the int8 path, and ``ClassifierTrainer`` trains it.
- ``VGG19Features``: VGG19 up to ``block5_conv4`` (after its ReLU), the
  frozen perceptual extractor of the ESRGAN trainer, fed keras 'caffe'
  preprocessing (``preprocess_caffe``: RGB -> BGR, mean subtracted).

Neither is a Pallas path in the JAX package, so both run PyTorch's own
``nn.Conv2d``/``nn.Linear`` (cuDNN, TF32 off). Their weights are in
PyTorch's layouts (OIHW, Linear (out, in)); ``tpusr_torch.bridge`` converts a
flax tree once. The public forwards take NHWC images, as the JAX models do.
ImageNet weights (a download) load from the Keras ``.h5`` release
(``load_keras_h5_weights``) or its converted ``.npz``
(``tools/imagenet_weights.py``); without them the models run on their
seeded initialisers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.bridge import dense_to_linear, hwio_to_oihw
from tpusr_torch.core import prng
from tpusr_torch.models.init import (DrawnConv2d, DrawnLinear, ParamRng,
                                    dense_params, dropout_key, param_rng)

# (block, convs-in-block, filters)
VGG16_CFG = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))
VGG19_CFG = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))

IMAGENET_BGR_MEAN = (103.939, 116.779, 123.68)


def conv_names() -> list[str]:
    return [f"block{b}_conv{c}" for b, n, _f in VGG16_CFG
            for c in range(1, n + 1)]


def preprocess_caffe(x_rgb_255: torch.Tensor) -> torch.Tensor:
    """keras.applications preprocess_input(mode='caffe'): RGB -> BGR on the
    last axis, then the ImageNet BGR mean subtracted."""
    x = x_rgb_255.flip(-1)
    return x - torch.tensor(IMAGENET_BGR_MEAN, dtype=x.dtype, device=x.device)


class _VGGBackbone(nn.ModuleDict):
    """The VGG conv base: ``cfg`` (block, convs, width) rows, each conv 3x3
    SAME + ReLU (flax lecun_normal kernels, zero biases, drawn in the
    scope ``rng`` on its device; no torch initialiser runs), a 2x2 max
    pool after each block. With
    ``until`` (a layer name) it holds the layers up to that conv and returns
    right after its ReLU; a name that matches no layer raises, so a typo
    cannot return the post-pool features. Takes and returns NCHW."""

    def __init__(self, cfg, rng: ParamRng, until: str | None = None):
        super().__init__()
        names = [f"block{b}_conv{c}" for b, n, _w in cfg for c in range(1, n + 1)]
        if until is not None and until not in names:
            raise ValueError(
                f"until={until!r} matched no layer of this backbone")
        rng = param_rng(rng)
        self.until = until
        self.blocks = tuple(cfg)
        cin = 3
        for b, n, wd in self.blocks:
            for c in range(1, n + 1):
                conv = DrawnConv2d(cin, wd, 3, padding=1, device=rng.device)
                # flax lecun_normal: variance 1 / fan_in, stored HWIO there
                kernel, bias = dense_params(rng.child(f"block{b}_conv{c}"),
                                            (3, 3, cin, wd), rng.device)
                conv.weight.data = hwio_to_oihw(kernel).contiguous()
                conv.bias.data = bias
                self[f"block{b}_conv{c}"] = conv
                cin = wd
                if f"block{b}_conv{c}" == until:
                    return

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b, n, _wd in self.blocks:
            for c in range(1, n + 1):
                name = f"block{b}_conv{c}"
                x = F.relu(self[name](x))
                if name == self.until:
                    return x
            x = F.max_pool2d(x, 2, 2)
        return x


class VGG16Classifier(nn.Module):
    """``widths`` overrides the five block widths (tests use narrow ones);
    the layer names and the block structure stay VGG16's."""

    def __init__(self, num_classes: int = 2, dense_units: int = 256,
                 widths: tuple[int, ...] | None = None, device=None,
                 key=None, dropout_rate: float = 0.2):
        """Weights are flax's ``init`` from ``key`` (a PRNG key, or an int
        seed; by default ``PRNGKey(42)``, ``models.init.DEFAULT_KEY``), made
        on ``device`` (CUDA unless ``device="cpu"``)."""
        super().__init__()
        r = param_rng(key, device)
        widths = tuple(widths or (f for _b, _n, f in VGG16_CFG))
        self.dropout_rate = dropout_rate
        self.init_args = dict(num_classes=num_classes, dense_units=dense_units,
                              widths=widths, dropout_rate=dropout_rate)
        self.blocks = tuple((b, n, wd) for (b, n, _f), wd in zip(VGG16_CFG, widths))
        self.vgg16 = _VGGBackbone(self.blocks, r.child("vgg16"))
        self.fc1 = DrawnLinear(widths[-1], dense_units, device=r.device)
        self.predictions = DrawnLinear(dense_units, num_classes,
                                       device=r.device)
        for name in ("fc1", "predictions"):
            lin = getattr(self, name)
            kernel, bias = dense_params(r.child(name), (lin.in_features,
                                                        lin.out_features),
                                        r.device)
            lin.weight.data = dense_to_linear(kernel).contiguous()
            lin.bias.data = bias
        self.requires_grad_(False)

    def _dropout(self, x: torch.Tensor, train: bool, dropout_rng, index: int,
                 rows: tuple[int, int] | None = None) -> torch.Tensor:
        """flax ``Dropout`` ``Dropout_{index}``: keep where
        ``bernoulli(key, 1 - rate)`` holds, scaled by 1 / (1 - rate), the
        key derived from ``dropout_rng`` (the ``dropout`` collection's root
        key) as flax derives it. ``rows`` (lo, n): ``x`` is rows [lo, lo +
        len(x)) of a batch of n, and keeps those rows of the batch's mask
        (JAX draws one mask for the global batch)."""
        if not train or self.dropout_rate <= 0:
            return x
        if dropout_rng is None:
            raise ValueError("VGG16Classifier: train=True needs a dropout_rng "
                             "for the dropout masks")
        keep_prob = 1.0 - self.dropout_rate
        lo, n = (0, x.shape[0]) if rows is None else rows
        keep = prng.bernoulli(dropout_key(dropout_rng, (f"Dropout_{index}",)),
                              keep_prob, (n,) + tuple(x.shape[1:]),
                              x.device)[lo:lo + x.shape[0]]
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_rng=None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """(N, H, W, 3) [0, 1] patches -> (N, classes) softmax probs; with
        ``train``, dropout masks drawn as flax draws them from the
        ``dropout`` key ``dropout_rng`` (``rows``: see ``_dropout``)."""
        x = self.vgg16(x.permute(0, 3, 1, 2))
        x = x.mean(dim=(2, 3))                       # GlobalAveragePooling2D
        x = self._dropout(x, train, dropout_rng, 0, rows)
        x = F.relu(self.fc1(x))
        x = self._dropout(x, train, dropout_rng, 1, rows)
        return torch.softmax(self.predictions(x), dim=-1)


class VGG19Features(nn.Module):
    """VGG19 up to ``block5_conv4`` (the perceptual-loss extractor), frozen,
    on ``device`` (CUDA unless ``device="cpu"``): (N, H, W, 3) caffe-
    preprocessed images -> (N, H/16, W/16, 512) features. ``widths``
    overrides the five block widths (tests use narrow ones)."""

    def __init__(self, widths: tuple[int, ...] | None = None, device=None,
                 key=None):
        """Weights are flax's ``init`` from ``key`` (a PRNG key, or an int
        seed; by default ``PRNGKey(42)``, ``models.init.DEFAULT_KEY``), made
        on ``device``."""
        super().__init__()
        widths = tuple(widths or (f for _b, _n, f in VGG19_CFG))
        self.init_args = dict(widths=widths)
        cfg = tuple((b, n, wd) for (b, n, _f), wd in zip(VGG19_CFG, widths))
        self.vgg19 = _VGGBackbone(cfg, param_rng(key, device).child("vgg19"),
                                  until="block5_conv4")
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.vgg19(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def load_keras_h5_weights(model, h5_path: str, backbone_key: str):
    """Import conv kernels/biases from a Keras VGG ``.h5`` into ``model``'s
    ``backbone_key`` convs (``vgg16`` of a ``VGG16Classifier``, ``vgg19`` of
    a ``VGG19Features``), in place, keyed by layer name (block{i}_conv{j});
    returns the model. Every backbone layer must be found, at its shape."""
    from tpusr_torch.bridge import oihw_to_hwio, vgg_backbone_from_arrays
    from tpusr_torch.train.keras_import import (_layer_of, _leaf,
                                                keras_layer_weights)

    backbone = getattr(model, backbone_key)
    layers = {}
    for _lname, ws in keras_layer_weights(h5_path):
        for wname, arr in ws:
            layer = _layer_of(wname)
            if layer in backbone and _leaf(wname) == "kernel":
                bias = next((a for w2, a in ws
                             if _layer_of(w2) == layer and _leaf(w2) == "bias"),
                            None)
                if bias is None:
                    raise ValueError(f"{h5_path}: layer {layer!r} has a "
                                     f"kernel but no bias")
                want = tuple(oihw_to_hwio(backbone[layer].weight).shape)
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"{h5_path}: shape mismatch at {layer}: h5 "
                        f"{arr.shape} vs flax {want}")
                layers[layer] = {"kernel": arr, "bias": bias}
    missing = sorted(set(backbone.keys()) - set(layers))
    if missing:
        # an .h5 with unparsable names (or the wrong VGG variant) must not
        # silently leave layers at random init
        raise ValueError(
            f"{h5_path}: no weights found for backbone layers {missing}")
    vgg_backbone_from_arrays(model, layers, backbone_key, source=h5_path)
    return model
