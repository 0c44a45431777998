"""Keras ``.h5`` exporters (port of ``tpusr/train/keras_export.py``), with no
TensorFlow.

The reference's artifacts are full Keras models (``SRCNN_model.py:249-259``,
``EDSR_model.py:317-330``, ``ESRGAN_model.py:981-996``,
``VGG16_model.py:272-281``, reloaded with ``load_model(custom_objects=...)``).
The JAX exporters build a Keras twin of each network and ``model.save`` it.
Here the twins are the JSON Keras writes into ``model_config`` (built by
``_Graph`` as Keras 3 names and wires the layers in a fresh session) and the
``model_weights`` tree beside it (layer groups, ``layer_names``,
``weight_names``, ``backend``/``keras_version``), written by the port's
HDF5 codec (``train/hdf5.py``) with the attribute types of Keras's file.
``keras.models.load_model`` rebuilds the model from it with the JAX
package's custom objects (``Scale``, ``DepthToSpace``, ``ClipZeroOne``,
``KerasSelfAttention``), and the importers read it back bit for bit.

The weights are flax-layout trees (HWIO conv, (in, out) Dense), which is
Keras's layout too: ``bridge.*_to_flax`` makes them from the port's
modules.
"""

from __future__ import annotations

import json

import numpy as np

from tpusr_torch.train import hdf5

KERAS_VERSION = "3.13.1"     # the Keras release whose file layout this is
BACKEND = "tensorflow"

_POLICY = {"module": "keras", "class_name": "DTypePolicy",
           "config": {"name": "float32"}, "registered_name": None}


def _np(a):
    return np.asarray(a, np.float32)


def _initializer(name, config):
    return {"module": "keras.initializers", "class_name": name,
            "config": config, "registered_name": None}


def _base(name):
    return {"name": name, "trainable": True, "dtype": _POLICY}


def _conv_config(name, filters, k, activation="linear", strides=1):
    return {**_base(name), "filters": filters, "kernel_size": [k, k],
            "strides": [strides, strides], "padding": "same",
            "data_format": "channels_last", "dilation_rate": [1, 1],
            "groups": 1, "activation": activation, "use_bias": True,
            "kernel_initializer": _initializer("GlorotUniform",
                                               {"seed": None}),
            "bias_initializer": _initializer("Zeros", {}),
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None}


def _dense_config(name, units, activation="linear"):
    return {**_base(name), "units": units, "activation": activation,
            "use_bias": True,
            "kernel_initializer": _initializer("GlorotUniform",
                                               {"seed": None}),
            "bias_initializer": _initializer("Zeros", {}),
            "kernel_regularizer": None, "bias_regularizer": None,
            "kernel_constraint": None, "bias_constraint": None,
            "quantization_config": None}


class _Graph:
    """A Keras functional model as Keras 3 serialises it: layers in call
    order, each with its config, its inbound node (the tensors it was called
    on, by shape and producing layer) and its weights. Auto names come from
    per-class counters, as in a fresh Keras session (``add``, ``add_1``,
    ...); ``uids`` may be shared with an enclosing model."""

    def __init__(self, uids=None):
        self.uids = {} if uids is None else uids
        self.layers = []          # (layer entry, [(weight path, array)])
        self.inputs = self.output = None

    def uid(self, prefix):
        n = self.uids.get(prefix, 0)
        self.uids[prefix] = n + 1
        return prefix if n == 0 else f"{prefix}_{n}"

    def input(self, shape, name=None):
        name = name or self.uid("input_layer")
        self.layers.append(({"class_name": "InputLayer", "config": {
            "batch_shape": [None, *shape], "dtype": "float32",
            "sparse": False, "ragged": False, "name": name,
            "optional": False}, "name": name, "inbound_nodes": []}, []))
        self.inputs = (name, [None, *shape])
        return self.inputs

    @staticmethod
    def _tensor(t):
        return {"class_name": "__keras_tensor__", "config": {
            "shape": t[1], "dtype": "float32", "keras_history": [t[0], 0, 0]}}

    def call(self, class_name, config, inputs, shape, weights=(),
             kwargs=None):
        """Call a layer whose ``config`` starts with its name on
        ``inputs`` (one tensor, or a list for a merge layer); returns the
        output tensor (layer name, shape)."""
        args = ([self._tensor(t) for t in inputs] if isinstance(inputs, list)
                else self._tensor(inputs))
        name = config["name"]
        self.layers.append(({"class_name": class_name, "config": config,
                             "name": name, "inbound_nodes": [
                                 {"args": [args], "kwargs": kwargs or {}}]},
                            list(weights)))
        self.output = (name, shape)
        return self.output

    def auto(self, class_name, prefix, extra, inputs, shape, kwargs=None):
        """A weightless layer with an auto name (``prefix``, numbered)."""
        return self.call(class_name, {**_base(self.uid(prefix)), **extra},
                         inputs, shape, kwargs=kwargs)

    def conv(self, x, name, filters, k=3, activation="linear", strides=1,
             kernel=None, bias=None):
        h, w = x[1][1:3]
        if strides > 1 and h is not None:
            h, w = -(-h // strides), -(-w // strides)
        return self.call("Conv2D", _conv_config(name, filters, k, activation,
                                                strides),
                         x, [None, h, w, filters],
                         [(f"{name}/kernel", kernel), (f"{name}/bias", bias)])

    def config(self, name=None):
        return {"class_name": "Functional", "config": {
            "name": name or self.uid("functional"), "trainable": True,
            "layers": [entry for entry, _w in self.layers],
            "input_layers": [self.inputs[0], 0, 0],
            "output_layers": [self.output[0], 0, 0]}}


def _save(path, model_config, layers):
    """Write a Keras 3 legacy ``.h5``: ``model_config`` and the
    ``model_weights`` tree of ``layers`` [(layer name, [(weight path,
    array)])] in model order, attribute types as Keras's file has them."""
    with hdf5.File(path, "w") as f:
        f.attrs["backend"] = BACKEND
        f.attrs["keras_version"] = KERAS_VERSION
        f.attrs["model_config"] = json.dumps(model_config).encode("utf8")
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = [n.encode("utf8") for n, _w in layers]
        g.attrs["backend"] = BACKEND.encode("utf8")
        g.attrs["keras_version"] = KERAS_VERSION.encode("utf8")
        for lname, weights in [*layers, ("top_level_model_weights", [])]:
            lg = g.create_group(lname)
            lg.attrs["weight_names"] = [w.encode("utf8") for w, _a in weights]
            for wname, arr in weights:
                lg.create_dataset(wname, data=_np(arr))


def _functional_weights(graph):
    return [(entry["name"], w) for entry, w in graph.layers]


# ----------------------------------------------------------- the networks
def srcnn_model(params):
    """Reference SRCNN (SRCNN_model.py:45-53) as Keras's Sequential:
    Conv f1 (9x9) relu -> Conv f2 (1x1) relu -> Conv channels (5x5)."""
    g = _Graph()
    k = [params[f"conv{i}"]["kernel"] for i in (1, 2, 3)]
    name = g.uid("sequential")
    cin = int(np.shape(k[0])[2])
    g.input((None, None, cin))
    entries, layers = [g.layers[0][0]], []
    for i, act in zip((1, 2, 3), ("relu", "relu", "linear")):
        kshape = np.shape(k[i - 1])
        entries.append({"class_name": "Conv2D", "config": _conv_config(
            f"conv{i}", int(kshape[3]), int(kshape[0]), act)})
        layers.append((f"conv{i}", [
            (f"{name}/conv{i}/kernel", params[f"conv{i}"]["kernel"]),
            (f"{name}/conv{i}/bias", params[f"conv{i}"]["bias"])]))
    config = {"class_name": "Sequential", "config": {
        **_base(name), "layers": [{"class_name": e["class_name"],
                                   "config": e["config"]} for e in entries],
        "build_input_shape": [None, None, None, cin]}}
    return config, layers


def edsr_model(params, res_scaling=0.1):
    """Reference EDSR (EDSR_model.py:96-125): head -> N res blocks (no BN,
    x res_scaling) -> body + global skip -> depth_to_space upsample tail ->
    conv -> clip [0, 1]."""
    n_res = len([k for k in params if k.startswith("res")])
    nf = int(np.shape(params["head"]["kernel"])[3])
    channels = int(np.shape(params["head"]["kernel"])[2])
    scale = 4 if "up1" in params else int(round(
        (np.shape(params["up0"]["kernel"])[3] // nf) ** 0.5))
    g = _Graph()
    inp = g.input((None, None, channels))

    def conv(x, name, node, activation="linear"):
        return g.conv(x, name, int(np.shape(node["kernel"])[3]),
                      activation=activation, kernel=node["kernel"],
                      bias=node["bias"])

    x = head = conv(inp, "head", params["head"])
    for i in range(n_res):
        sc = x
        x = conv(x, f"res{i}_conv1", params[f"res{i}"]["conv1"], "relu")
        x = conv(x, f"res{i}_conv2", params[f"res{i}"]["conv2"])
        x = g.auto("Scale", "scale", {"factor": res_scaling}, x, x[1])
        x = g.auto("Add", "add", {}, [x, sc], x[1])
    x = conv(x, "body", params["body"])
    x = g.auto("Add", "add", {}, [x, head], x[1])
    r = 2 if scale in (2, 4) else scale
    for i in range(2 if scale == 4 else 1):
        x = conv(x, f"up{i}", params[f"up{i}"])
        x = g.auto("DepthToSpace", "depth_to_space", {"block_size": r}, x,
                   [None, None, None, x[1][3] // (r * r)])
    x = conv(x, "tail", params["tail"])
    g.call("ClipZeroOne", {"name": g.uid("clip_zero_one"),
                           "activity_regularizer": None, "trainable": True,
                           "dtype": _POLICY, "autocast": True}, x, x[1])
    return g.config(), _functional_weights(g)


def esrgan_generator_model(params):
    """Reference RRDBNet generator (ESRGAN_model.py:303-345), with the layer
    names the importer expects: initial_conv, rrdb_{i}_dense{j}_conv{k},
    trunk_conv, self_attention_*, upsample_{i}_conv, final_conv1/2."""
    filters = int(np.shape(params["initial_conv"]["kernel"])[3])
    channels = int(np.shape(params["initial_conv"]["kernel"])[2])
    n_rrdb = len([k for k in params if k.startswith("rrdb_")])
    growth = int(np.shape(params["rrdb_0"]["dense1"]["conv1"]["kernel"])[3])
    n_up = len([k for k in params if k.startswith("upsample_")])
    g = _Graph()
    inp = g.input((None, None, channels), name="lr_input")

    def conv(x, name, node, activation="linear"):
        return g.conv(x, name, int(np.shape(node["kernel"])[3]),
                      activation=activation, kernel=node["kernel"],
                      bias=node["bias"])

    def chans(c):
        return [None, None, None, c]

    def dense_block(x, name, node):
        feats = [x]
        for k in range(1, 5):
            inz = feats[0] if len(feats) == 1 else g.auto(
                "Concatenate", "concatenate", {"axis": -1}, list(feats),
                chans(sum(t[1][3] for t in feats)))
            feats.append(conv(inz, f"{name}_conv{k}", node[f"conv{k}"],
                              "relu"))
        cat = g.auto("Concatenate", "concatenate", {"axis": -1}, list(feats),
                     chans(sum(t[1][3] for t in feats)))
        x5 = conv(cat, f"{name}_conv5", node["conv5"])
        x5 = g.auto("Scale", "scale", {"factor": 0.2}, x5, x5[1])
        return g.auto("Add", "add", {}, [x, x5], x[1])

    def attention(x, name):
        node = params[name]
        weights = []
        for tag in ("f", "g", "h", "v"):
            weights += [(f"{name}/{name}_{tag}/kernel", node[tag]["kernel"]),
                        (f"{name}/{name}_{tag}/bias", node[tag]["bias"])]
        return g.call("KerasSelfAttention", {**_base(name),
                                             "channels": filters},
                      x, x[1], weights)

    x = trunk = conv(inp, "initial_conv", params["initial_conv"])
    for i in range(n_rrdb):
        blk_in = x
        for j in (1, 2, 3):
            x = dense_block(x, f"rrdb_{i}_dense{j}",
                            params[f"rrdb_{i}"][f"dense{j}"])
        x = g.auto("Scale", "scale", {"factor": 0.2}, x, x[1])
        x = g.auto("Add", "add", {}, [blk_in, x], x[1])
    x = conv(x, "trunk_conv", params["trunk_conv"])
    x = g.auto("Add", "add", {}, [trunk, x], x[1])
    x = attention(x, "self_attention_trunk")
    for i in range(n_up):
        x = conv(x, f"upsample_{i}_conv", params[f"upsample_{i}_conv"])
        x = g.auto("DepthToSpace", "depth_to_space", {"block_size": 2}, x,
                   chans(x[1][3] // 4))
        x = g.auto("LeakyReLU", "leaky_re_lu", {"negative_slope": 0.2}, x,
                   x[1])
        if i == 0:
            x = attention(x, "self_attention_upsample_0")
    x = conv(x, "final_conv1", params["final_conv1"], "relu")
    conv(x, "final_conv2", params["final_conv2"], "tanh")
    return g.config(), _functional_weights(g)


def esrgan_discriminator_model(params, spectral, input_hw=96):
    """Reference discriminator (ESRGAN_model.py:347-377): 6 SN convs
    (64,64,64,128,128,256 / strides 1,2,1,2,1,2), GAP, SN-Dense 256,
    SN-Dense 1 sigmoid; each wrapped in ``SpectralNormalization``."""
    g = _Graph()
    x = g.input((input_hw, input_hw, 3), name="hr_input")

    def sn(x, class_name, inner, node, u, shape):
        name = g.uid("spectral_normalization")
        inner_name = inner["name"]
        return g.call("SpectralNormalization", {
            **_base(name), "layer": {
                "module": "keras.layers", "class_name": class_name,
                "config": inner, "registered_name": None,
                "build_config": {"input_shape": x[1]}},
            "power_iterations": 1}, x, shape,
            [(f"{name}/{inner_name}/kernel", node["kernel"]),
             (f"{name}/{inner_name}/bias", node["bias"]),
             (f"{name}/vector_u", np.reshape(u, (1, -1)))],
            kwargs={"training": False})

    def leaky(x):
        return g.auto("LeakyReLU", "leaky_re_lu", {"negative_slope": 0.2},
                      x, x[1])

    widths = (64, 64, 64, 128, 128, 256)
    strides = (1, 2, 1, 2, 1, 2)
    h = input_hw
    for i, (f, s) in enumerate(zip(widths, strides), 1):
        h = -(-h // s)
        x = sn(x, "Conv2D", _conv_config(f"disc_conv{i}", f, 3, strides=s),
               params[f"conv{i}"], spectral[f"conv{i}"]["u"],
               [None, h, h, f])
        x = leaky(x)
    x = g.call("GlobalAveragePooling2D", {**_base("disc_gap"),
                                          "data_format": "channels_last",
                                          "keepdims": False},
               x, [None, widths[-1]])
    x = sn(x, "Dense", _dense_config("disc_dense1", 256), params["dense1"],
           spectral["dense1"]["u"], [None, 256])
    x = leaky(x)
    sn(x, "Dense", _dense_config("disc_output", 1, "sigmoid"),
       params["output"], spectral["output"]["u"], [None, 1])
    return g.config(), _functional_weights(g)


_VGG16_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512),
                 (5, 3, 512))


def vgg16_classifier_model(params, input_shape=(96, 96, 3), dropout=0.3):
    """Reference FineTunedVGG16 (VGG16_model.py:84-97): the
    ``keras.applications.VGG16`` base (include_top=False, a nested model)
    -> GAP -> Dropout -> Dense relu 'fc1' -> Dropout -> Dense softmax
    'predictions'."""
    uids: dict = {}
    base = _Graph(uids)
    x = base.input(tuple(input_shape))
    h = input_shape[0]
    base_weights = []
    for block, n_convs, filters in _VGG16_BLOCKS:
        for c in range(1, n_convs + 1):
            name = f"block{block}_conv{c}"
            node = params["vgg16"][name]
            width = int(np.shape(node["kernel"])[3])
            x = base.conv(x, name, width, activation="relu")
            base_weights += [(f"{name}/kernel", node["kernel"]),
                             (f"{name}/bias", node["bias"])]
        h //= 2
        x = base.call("MaxPooling2D", {
            **_base(f"block{block}_pool"), "pool_size": [2, 2],
            "padding": "valid", "strides": [2, 2],
            "data_format": "channels_last"}, x, [None, h, h, x[1][3]])
    g = _Graph(uids)
    inp = g.input(tuple(input_shape))
    x = g.call("Functional", base.config("vgg16")["config"], inp,
               base.output[1], base_weights,
               kwargs={"training": False, "mask": None})
    x = g.auto("GlobalAveragePooling2D", "global_average_pooling2d",
               {"data_format": "channels_last", "keepdims": False}, x,
               [None, x[1][3]])
    drop = {"rate": dropout, "seed": None, "noise_shape": None}
    x = g.auto("Dropout", "dropout", drop, x, x[1],
               kwargs={"training": False})
    units = int(np.shape(params["fc1"]["bias"])[0])
    x = g.call("Dense", _dense_config("fc1", units, "relu"), x,
               [None, units], [("fc1/kernel", params["fc1"]["kernel"]),
                               ("fc1/bias", params["fc1"]["bias"])])
    x = g.auto("Dropout", "dropout", drop, x, x[1],
               kwargs={"training": False})
    classes = int(np.shape(params["predictions"]["bias"])[0])
    g.call("Dense", _dense_config("predictions", classes, "softmax"), x,
           [None, classes],
           [("predictions/kernel", params["predictions"]["kernel"]),
            ("predictions/bias", params["predictions"]["bias"])])
    return g.config(), _functional_weights(g)


# ----------------------------------------------------------------- export
def export_srcnn(params: dict, path: str) -> None:
    """flax-layout SRCNN params (conv1/conv2/conv3) -> reference-format .h5."""
    _save(path, *srcnn_model(params))


def export_edsr(params: dict, path: str, res_scaling: float = 0.1) -> None:
    """flax-layout EDSR params -> reference-format .h5 (scale read off the
    upsample kernels). ``res_scaling`` is graph structure, not a weight: it
    must match the trained model's value (EDSR_model.py:47)."""
    _save(path, *edsr_model(params, res_scaling))


def export_esrgan_generator(params: dict, path: str) -> None:
    """flax-layout ESRGAN generator params -> reference-format .h5."""
    _save(path, *esrgan_generator_model(params))


def export_esrgan_discriminator(params: dict, spectral: dict, path: str,
                                input_hw: int = 96) -> None:
    """flax-layout discriminator params + spectral ``u`` -> .h5 with Keras
    SpectralNormalization wrappers (the reference's resume artifact,
    ESRGAN_model.py:989-993)."""
    _save(path, *esrgan_discriminator_model(params, spectral, input_hw))


def export_vgg16_classifier(params: dict, path: str,
                            input_shape=(96, 96, 3), dropout=0.3) -> None:
    """flax-layout VGG16Classifier params -> reference-format .h5 (nested
    VGG16 base + fc1/predictions head)."""
    _save(path, *vgg16_classifier_model(params, input_shape, dropout))
