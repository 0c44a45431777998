"""Keras ``.h5`` importers (port of ``tpusr/train/keras_import.py``): the
reference's saved models into the port's modules.

The reference persists full Keras models (``SRCNN_{ts}.h5``,
``EDSR_x{s}_{ts}.h5``, ``ESRGAN_generator_x{s}_{ts}.h5``, ``VGG16_{ts}.h5``;
SURVEY.md §5). These importers read them with the port's own HDF5 codec
(``train/hdf5.py``; no h5py), fill a flax-layout numpy tree by the JAX
importers' rules, and hand it to ``bridge.*_from_flax``, the one place that
converts layouts. Each takes the port's parameters (name -> tensor, as
``named_parameters`` or a trainer's state hold them) as the template whose
shapes the file must match, and returns the port's module on ``device``.

Keras Conv2D kernels are (kh, kw, in, out) and Dense kernels (in, out), as
in flax. SRCNN/EDSR use Keras auto-named layers, so those map by layer
order; ESRGAN and VGG use explicit layer names. Keras 2 weight names
(``conv2d/kernel:0``) and Keras 3 names (``seq/conv2d/kernel``) follow the
same rules, and the same ``ValueError``s are raised on a wrong layer count
or shape, as in JAX. As there, only an unsplit ``layer_names`` attribute is
read: a file that splits it (``layer_names0``, ``layer_names1``, ...) is
walked in ``keys()`` order, which is alphabetical (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np

from tpusr_torch import bridge
from tpusr_torch.train import hdf5


def _weights_group(f):
    return f["model_weights"] if "model_weights" in f else f


def _names(values) -> list:
    """Decoded names of a name-list attribute; a null one holds none."""
    if values is None or isinstance(values, hdf5.Empty):
        return []
    return [n.decode() if isinstance(n, bytes) else str(n) for n in values]


def _layer_names(f):
    g = _weights_group(f)
    names = g.attrs.get("layer_names")
    if names is not None:
        return _names(names)
    return list(g.keys())


def keras_layer_weights(path: str):
    """Ordered list of (layer_name, [(weight_name, array), ...]) for the
    layers that have weights."""
    out = []
    with hdf5.File(path) as f:
        g = _weights_group(f)
        for lname in _layer_names(f):
            if lname not in g:
                continue
            grp = g[lname]
            wnames = _names(grp.attrs.get("weight_names", []))
            if not wnames:
                continue
            arrays = [np.asarray(grp[w]) for w in wnames]
            out.append((lname, list(zip(wnames, arrays))))
    return out


def _leaf(wname: str) -> str:
    """'conv2d/kernel:0' (keras 2) or 'seq/conv2d/kernel' (keras 3) -> 'kernel'."""
    return wname.split("/")[-1].split(":")[0]


def _layer_of(wname: str) -> str:
    parts = wname.split("/")
    return parts[-2] if len(parts) >= 2 else ""


def _conv_dense_pairs(path):
    """(kernel, bias) tuples for conv/dense layers, in saved layer order."""
    pairs = []
    for _lname, ws in keras_layer_weights(path):
        kernel = bias = None
        for wname, arr in ws:
            if _leaf(wname) == "kernel":
                kernel = arr
            elif _leaf(wname) == "bias":
                bias = arr
        if kernel is not None:
            pairs.append((kernel, bias))
    return pairs


def _set(tree, path, kernel, bias):
    node = tree
    for k in path[:-1]:
        node = node[k]
    leaf = path[-1]
    want = node[leaf]["kernel"].shape
    if tuple(kernel.shape) != tuple(want):
        raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                         f"h5 {kernel.shape} vs flax {want}")
    node[leaf] = {"kernel": np.array(kernel), "bias": np.array(bias)}


def import_srcnn(params: dict, h5_path: str, device=None):
    """SRCNN: 3 convs in order -> conv1/conv2/conv3 (SRCNN_model.py:45-53)."""
    pairs = _conv_dense_pairs(h5_path)
    if len(pairs) != 3:
        raise ValueError(f"expected 3 conv layers, found {len(pairs)}")
    out = bridge.to_flax_tree(params)
    for i, (k, b) in enumerate(pairs, 1):
        _set(out, (f"conv{i}",), k, b)
    return bridge.srcnn_from_flax(out, device=device)


def import_edsr(params: dict, h5_path: str, num_res_blocks: int = 16,
                scale_factor: int = 2, res_scaling: float = 0.1,
                device=None):
    """EDSR: convs in creation order — head, (res conv1, conv2) x N, body,
    upsample conv(s), tail (EDSR_model.py:96-125)."""
    pairs = _conv_dense_pairs(h5_path)
    n_up = 2 if scale_factor == 4 else 1
    expected = 1 + 2 * num_res_blocks + 1 + n_up + 1
    if len(pairs) != expected:
        raise ValueError(f"expected {expected} conv layers, found {len(pairs)}")
    out = bridge.to_flax_tree(params)
    it = iter(pairs)
    _set(out, ("head",), *next(it))
    for i in range(num_res_blocks):
        k, b = next(it)
        _set(out, (f"res{i}", "conv1"), k, b)
        k, b = next(it)
        _set(out, (f"res{i}", "conv2"), k, b)
    _set(out, ("body",), *next(it))
    for i in range(n_up):
        _set(out, (f"up{i}",), *next(it))
    _set(out, ("tail",), *next(it))
    return bridge.edsr_from_flax(out, scale_factor, res_scaling=res_scaling,
                                 device=device)


_ESRGAN_ATTN = {"self_attention_trunk": "self_attention_trunk",
                "self_attention_upsample_0": "self_attention_upsample_0"}


def _count_kernels(tree) -> int:
    """Number of {kernel, bias} conv/dense nodes in a params tree."""
    if not isinstance(tree, dict):
        return 0
    return (1 if "kernel" in tree else 0) + sum(
        _count_kernels(v) for k, v in tree.items() if k != "kernel")


def import_esrgan_generator(params: dict, h5_path: str, device=None,
                            attention_block_size: int | None = None):
    """ESRGAN generator: explicit layer names (ESRGAN_model.py:303-345).
    initial_conv, rrdb_{i}_dense{j}_conv{k}, trunk_conv, self-attention f/g/h/v,
    upsample_{i}_conv, final_conv1/final_conv2. Raises if any conv is left
    unfilled (an .h5 with unrecognized layer names must not silently keep
    random init)."""
    out = bridge.esrgan_generator_to_flax(params)
    expected = _count_kernels(out)
    filled = []

    def _fill(o, path, k, b):
        _set(o, path, k, b)
        filled.append(path)

    for lname, ws in keras_layer_weights(h5_path):
        arrays = {_leaf(w): a for w, a in ws}
        if lname in _ESRGAN_ATTN:
            # SelfAttention stores its four sub-convs' weights in one layer
            # group, named <layer>_{f,g,h,v}/kernel
            sub = {}
            for wname, arr in ws:
                tag = _layer_of(wname).rsplit("_", 1)[-1]  # f/g/h/v
                sub.setdefault(tag, {})[_leaf(wname)] = arr
            for tag in ("f", "g", "h", "v"):
                if tag in sub:
                    _fill(out, (lname, tag), sub[tag]["kernel"], sub[tag]["bias"])
            continue
        if "kernel" not in arrays:
            continue
        k, b = arrays["kernel"], arrays.get("bias")
        if lname == "initial_conv":
            _fill(out, ("initial_conv",), k, b)
        elif lname == "trunk_conv":
            _fill(out, ("trunk_conv",), k, b)
        elif lname.startswith("rrdb_"):
            # rrdb_{i}_dense{j}_conv{k}
            stem, convk = lname.rsplit("_", 1)
            block, densej = stem.rsplit("_", 1)
            _fill(out, (block, densej, convk), k, b)
        elif lname.startswith("upsample_") and lname.endswith("_conv"):
            _fill(out, (lname,), k, b)
        elif lname in ("final_conv1", "final_conv2"):
            _fill(out, (lname,), k, b)
    if len(filled) != expected:
        raise ValueError(
            f"import_esrgan_generator: matched {len(filled)} of {expected} "
            f"conv layers in {h5_path} — unrecognized layer names would "
            f"leave random-initialized params")
    return bridge.esrgan_generator_from_flax(
        out, device=device, attention_block_size=attention_block_size)


_DISC_MAP = {f"disc_conv{i}": f"conv{i}" for i in range(1, 7)}
_DISC_MAP.update({"disc_dense1": "dense1", "disc_output": "output"})


def import_esrgan_discriminator(params: dict, spectral: dict, h5_path: str,
                                device=None):
    """ESRGAN discriminator incl. spectral-norm state: the reference saves it
    as ``ESRGAN_discriminator_x{s}_{ts}.h5`` (ESRGAN_model.py:989-993) and
    reloads it to resume adversarial training (:143-149). Each conv/dense is
    wrapped in SpectralNormalization; saved weight paths keep the inner layer
    names (disc_conv{1..6}, disc_dense1, disc_output) plus the wrapper's
    power-iteration vector ('vector_u' in keras 3, 'sn_u' in
    tensorflow_addons). ``params``/``spectral`` are the port's (the module's
    parameters and ``u`` buffers by name); returns the port's module.
    """
    out, spec = bridge.to_flax_tree(params), bridge.to_flax_tree(spectral)
    seen = set()
    for _lname, ws in keras_layer_weights(h5_path):
        kernel = bias = u = inner = None
        for wname, arr in ws:
            leaf = _leaf(wname)
            if leaf == "kernel":
                kernel, inner = arr, _layer_of(wname)
            elif leaf == "bias":
                bias = arr
            elif leaf in ("vector_u", "sn_u", "u"):
                u = arr
        if kernel is None or inner not in _DISC_MAP:
            continue
        tgt = _DISC_MAP[inner]
        _set(out, (tgt,), kernel, bias)
        if u is not None:
            want = tuple(np.asarray(spec[tgt]["u"]).shape)
            if tuple(u.shape) != want:
                raise ValueError(f"u-vector shape mismatch at {tgt}: "
                                 f"h5 {u.shape} vs flax {want}")
            spec[tgt] = {"u": np.array(u)}
        seen.add(tgt)
    missing = set(_DISC_MAP.values()) - seen
    if missing:
        raise ValueError(
            f"discriminator import incomplete; missing layers {sorted(missing)}")
    return bridge.esrgan_discriminator_from_flax(out, spec, device=device)


def import_vgg16_classifier(params: dict, h5_path: str, device=None,
                            dropout_rate: float = 0.2):
    """FineTunedVGG16: vgg16 backbone (block{i}_conv{j}) + head Dense 256 +
    Dense num_classes named 'predictions' (VGG16_model.py:84-97). The keras
    model nests the VGG16 base as a sub-model layer."""
    out = bridge.to_flax_tree(params)
    dense_seen = []
    for lname, ws in keras_layer_weights(h5_path):
        for wname, arr in ws:
            leaf = _leaf(wname)
            layer = _layer_of(wname)
            if leaf != "kernel":
                continue
            bias = next((a for w2, a in ws
                         if _layer_of(w2) == layer and _leaf(w2) == "bias"),
                        None)
            if bias is None:
                raise ValueError(
                    f"import_vgg16_classifier: layer {layer!r} in {h5_path} "
                    f"has a kernel but no bias")
            if layer.startswith("block") and "_conv" in layer:
                _set(out, ("vgg16", layer), arr, bias)
            elif layer == "predictions":
                _set(out, ("predictions",), arr, bias)
            elif arr.ndim == 2:
                dense_seen.append((layer, arr, bias))
    # the remaining 2-D kernel is the 256-unit head (keras auto-name 'dense')
    fc1_shape = tuple(np.asarray(out["fc1"]["kernel"]).shape)
    for _layer, k, b in dense_seen:
        if k.shape == fc1_shape:
            _set(out, ("fc1",), k, b)
            break
    else:
        raise ValueError(
            f"import_vgg16_classifier: no dense kernel of shape {fc1_shape} "
            f"(the 256-unit head) found in {h5_path} — candidates: "
            f"{[(n, a.shape) for n, a, _ in dense_seen]}; a silently skipped "
            f"head would break logit parity")
    return bridge.vgg16_from_flax(out, device=device,
                                  dropout_rate=dropout_rate)
