"""Offline ImageNet weights for VGG16/VGG19 (port of
``tpusr/tools/imagenet_weights.py``).

The reference downloads Keras ImageNet weights for the classifier base
(``VGG16_model.py:66-72``) and the ESRGAN perceptual extractor
(``ESRGAN_model.py:379-399``). Provisioning is offline: copy the official
Keras ``*_notop.h5`` releases (``imagenet_manifest.json`` beside this file
lists their names, URLs and hashes) next to the repo and either pass the
``.h5`` directly (``FineTunedVGG16.setup_model(imagenet_weights_path=...)``,
``ESRGAN.setup_model(vgg19_weights_path=...)``, ``train-esrgan
--vgg19-weights``) or convert it once to a validated ``.npz``:

    python -m tpusr_torch.tools.imagenet_weights --arch vgg16 \
        --src vgg16_weights_tf_dim_ordering_tf_kernels_notop.h5 \
        --out weights/vgg16_imagenet.npz

The ``.h5`` is read by the port's own HDF5 codec (``train/hdf5.py``). The
``.npz`` layout is ``block{b}_conv{c}/kernel`` (HWIO) and ``/bias``;
``bridge.py`` writes it into the port's OIHW ``nn.Conv2d`` weights.
``--verify-official`` hashes a provisioned file against the manifest
(``--record-sha256`` writes the sha256 into this package's copy of it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "imagenet_manifest.json")

# (block, convs in the block, filters), as tpusr_torch.models.vgg's configs
_CFGS = {
    "vgg16": ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)),
    "vgg19": ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512)),
}


def expected_shapes(arch: str) -> dict[str, tuple]:
    cfg = _CFGS[arch]
    shapes = {}
    in_ch = 3
    for block, n_convs, filters in cfg:
        for ci in range(1, n_convs + 1):
            shapes[f"block{block}_conv{ci}"] = (3, 3, in_ch, filters)
            in_ch = filters
    return shapes


def h5_backbone_arrays(h5_path: str) -> dict[str, dict[str, np.ndarray]]:
    """{layer: {'kernel': ..., 'bias': ...}} from a Keras VGG .h5."""
    from tpusr_torch.train.keras_import import (_layer_of, _leaf,
                                                keras_layer_weights)

    out: dict[str, dict[str, np.ndarray]] = {}
    for _lname, ws in keras_layer_weights(h5_path):
        for wname, arr in ws:
            layer = _layer_of(wname) or _lname
            if layer.startswith("block") and "_conv" in layer:
                out.setdefault(layer, {})[_leaf(wname)] = np.asarray(arr)
    return out


def validate(arch: str, layers: dict[str, dict[str, np.ndarray]]) -> None:
    want = expected_shapes(arch)
    missing = sorted(set(want) - set(layers))
    if missing:
        raise ValueError(f"{arch}: missing conv layers {missing}")
    for name, shape in want.items():
        got = tuple(layers[name]["kernel"].shape)
        if got != shape:
            raise ValueError(f"{arch}/{name}: kernel shape {got}, want {shape}")
        if tuple(layers[name]["bias"].shape) != (shape[-1],):
            raise ValueError(f"{arch}/{name}: bad bias shape")


def convert(arch: str, src_h5: str, out_npz: str) -> None:
    """Validate a Keras VGG .h5 and save a flat .npz weight bundle."""
    layers = h5_backbone_arrays(src_h5)
    validate(arch, layers)
    flat = {"__arch__": np.asarray(arch)}
    for name, ws in layers.items():
        flat[f"{name}/kernel"] = ws["kernel"]
        flat[f"{name}/bias"] = ws["bias"]
    os.makedirs(os.path.dirname(os.path.abspath(out_npz)) or ".", exist_ok=True)
    np.savez(out_npz, **flat)
    print(f"validated {arch} ({len(layers)} conv layers) -> {out_npz}")


def npz_layers(npz_path: str) -> dict[str, dict[str, np.ndarray]]:
    """{layer: {'kernel': HWIO, 'bias': ...}} of a converted bundle."""
    layers: dict[str, dict[str, np.ndarray]] = {}
    with np.load(npz_path) as data:
        for key in data.files:
            if key == "__arch__" or "/" not in key:
                continue
            layer, leaf = key.split("/", 1)
            layers.setdefault(layer, {})[leaf] = data[key]
    return layers


def load_npz_backbone(model, npz_path: str, backbone_key: str):
    """Write a converted ``.npz`` bundle into ``model``'s backbone
    (``vgg16`` of a ``VGG16Classifier``, ``vgg19`` of a ``VGG19Features``),
    in place; every layer of the bundle must exist there at its shape.
    Returns the model."""
    from tpusr_torch.bridge import vgg_backbone_from_arrays

    vgg_backbone_from_arrays(model, npz_layers(npz_path), backbone_key,
                             source=npz_path)
    return model


def load_backbone_weights(model, path: str, backbone_key: str):
    """Dispatch .h5 (Keras) / .npz (converted) backbone weight imports, in
    place; returns the model."""
    if path.endswith(".npz"):
        return load_npz_backbone(model, path, backbone_key)
    from tpusr_torch.models.vgg import load_keras_h5_weights

    return load_keras_h5_weights(model, path, backbone_key)


def load_manifest() -> dict:
    """The manifest of the official weight releases (filenames, URLs,
    hashes, expected parameter counts)."""
    with open(MANIFEST) as f:
        return json.load(f)


def file_hashes(path: str) -> dict[str, str]:
    md5, sha = hashlib.md5(), hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            md5.update(chunk)
            sha.update(chunk)
    return {"md5": md5.hexdigest(), "sha256": sha.hexdigest()}


def verify_official(path: str, key: str, record_sha256: bool = False) -> dict:
    """Check a provisioned file against the manifest. md5 must match the
    keras-applications file_hash; sha256 is compared when recorded, or
    written into the manifest on first provisioning with record_sha256."""
    manifest = load_manifest()
    if key not in manifest:
        raise KeyError(f"unknown manifest key {key!r}; have "
                       f"{[k for k in manifest if not k.startswith('_')]}")
    entry = manifest[key]
    got = file_hashes(path)
    if got["md5"] != entry["md5"]:
        raise ValueError(
            f"{path}: md5 {got['md5']} does not match the official "
            f"{entry['filename']} ({entry['md5']}) — wrong or corrupt file")
    if entry.get("sha256"):
        if got["sha256"] != entry["sha256"]:
            raise ValueError(f"{path}: sha256 mismatch vs recorded manifest")
    elif record_sha256:
        entry["sha256"] = got["sha256"]
        with open(MANIFEST, "w") as f:
            json.dump(manifest, f, indent=2)
        print(f"recorded sha256 {got['sha256']} for {key}")
    return got


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Validate/convert Keras VGG ImageNet weights for "
                    "tpusr_torch")
    p.add_argument("--arch", choices=("vgg16", "vgg19"), required=True)
    p.add_argument("--src", required=True, help="Keras .h5 (notop) weight file")
    p.add_argument("--out", default=None,
                   help=".npz output; omit to validate only")
    p.add_argument("--verify-official", action="store_true",
                   help="check --src md5/sha256 against the manifest "
                        "(official releases only)")
    p.add_argument("--record-sha256", action="store_true",
                   help="with --verify-official: record the sha256 into the "
                        "manifest on first provisioning")
    args = p.parse_args(argv)
    if args.verify_official:
        key = f"{args.arch}_notop"
        got = verify_official(args.src, key, record_sha256=args.record_sha256)
        print(f"{args.src}: md5 OK ({got['md5']}), sha256 {got['sha256']}")
    if args.out:
        convert(args.arch, args.src, args.out)
    else:
        validate(args.arch, h5_backbone_arrays(args.src))
        print(f"{args.src}: valid {args.arch} backbone")


if __name__ == "__main__":
    main()
