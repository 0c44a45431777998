"""Write the Keras .h5 fixtures beside this file with the JAX package's
exporters (``tpusr.train.keras_export``, which build the Keras twins and
``model.save``), and ``manifest.json``: h5py's view of each file (its tree,
every attribute's type and decoded value, every dataset's shape, dtype and
sha256; ``test_torch_fixtures.h5_describe``).

    python tests/data/keras/make_fixtures.py

Needs TensorFlow, Keras 3 and h5py. The weights are drawn from the numpy
seeds of ``test_torch_fixtures._keras_nets``. SRCNN, EDSR x2 and x4 and the
ESRGAN generator are committed whole; the discriminator and the VGG16
classifier, whose widths are fixed (2.7 and 59 MB), only as their skeleton
(``<name>.skeleton.json``: the same records, the seed in the manifest).
Each file is exported after ``keras.backend.clear_session()``, so its
layer names are those of a fresh process.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [os.path.dirname(TESTS), TESTS]
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")

import h5py  # noqa: E402
import keras  # noqa: E402
import tensorflow as tf  # noqa: E402

from test_torch_fixtures import (KERAS_FULL, KERAS_SKELETONS,  # noqa: E402
                                 _keras_nets, h5_describe,
                                 keras_fixture_tree)
from tpusr.train import keras_export as ke  # noqa: E402


def export(name, path):
    keras.backend.clear_session()
    trees = keras_fixture_tree(name)
    if name == "srcnn":
        ke.export_srcnn(trees[0], path)
    elif name.startswith("edsr"):
        ke.export_edsr(trees[0], path)
    elif name == "esrgan_generator":
        ke.export_esrgan_generator(trees[0], path)
    elif name == "esrgan_discriminator":
        ke.export_esrgan_discriminator(trees[0], trees[1], path, input_hw=24)
    else:
        ke.export_vgg16_classifier(trees[0], path)


def main():
    nets = _keras_nets()
    manifest = {"writer": {"keras": keras.__version__,
                           "tensorflow": tf.__version__,
                           "h5py": h5py.__version__,
                           "hdf5": h5py.version.hdf5_version},
                "seeds": {n: nets[n][3] for n in nets}, "files": {}}
    for name in KERAS_FULL:
        path = os.path.join(HERE, f"{name}.h5")
        export(name, path)
        manifest["files"][f"{name}.h5"] = h5_describe(path)
    with tempfile.TemporaryDirectory() as tmp:
        for name in KERAS_SKELETONS:
            path = os.path.join(tmp, f"{name}.h5")
            export(name, path)
            with open(os.path.join(HERE, f"{name}.skeleton.json"), "w") as f:
                json.dump(h5_describe(path), f, indent=0)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=0)
    print(json.dumps(manifest["writer"]))


if __name__ == "__main__":
    main()
