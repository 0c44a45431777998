"""``keras.models.load_model`` on the port's Keras ``.h5`` exports.

The port writes Keras files with its own HDF5 codec and no TensorFlow
(``tpusr_torch/train/keras_export.py``). Here Keras 3 loads each of the five
networks' files with the JAX package's custom objects, and its forward
agrees with the port's within 1e-5. Keras's ``SpectralNormalization``
divides the kernel by its spectral norm only when called in training (it
then stores the divided kernel), so the discriminator is compared in
training mode: one power-iteration step from the stored ``u`` on both
sides, as the port's discriminator always takes. Marked slow, as the JAX
package's own Keras suites are (TensorFlow is slow to import).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

tf = pytest.importorskip("tensorflow")

from test_torch_fixtures import keras_fixture_tree  # noqa: E402
from tpusr.train.keras_export import (edsr_custom_objects,  # noqa: E402
                                      esrgan_custom_objects)
from tpusr_torch import bridge  # noqa: E402
from tpusr_torch.train import keras_export  # noqa: E402


def _run(module, x):
    with torch.no_grad():
        return module(torch.as_tensor(x)).numpy()


@pytest.mark.parametrize("name", ["srcnn", "edsr_x2", "edsr_x4",
                                  "esrgan_generator", "esrgan_discriminator",
                                  "vgg16_classifier"])
def test_load_model_matches_the_port(tmp_path, name):
    trees = keras_fixture_tree(name)
    path = str(tmp_path / f"{name}.h5")
    rng = np.random.default_rng(5)
    if name == "srcnn":
        keras_export.export_srcnn(trees[0], path)
        model, custom = bridge.srcnn_from_flax(trees[0], "cpu"), None
        x = rng.random((2, 24, 24, 3), dtype=np.float32)
    elif name.startswith("edsr"):
        keras_export.export_edsr(trees[0], path)
        scale = int(name[-1])
        model = bridge.edsr_from_flax(trees[0], scale, device="cpu")
        custom = edsr_custom_objects()
        x = rng.random((2, 8, 8, 3), dtype=np.float32)
    elif name == "esrgan_generator":
        keras_export.export_esrgan_generator(trees[0], path)
        model = bridge.esrgan_generator_from_flax(trees[0], "cpu")
        custom = esrgan_custom_objects()
        x = rng.random((2, 8, 8, 3), dtype=np.float32) * 2 - 1
    elif name == "esrgan_discriminator":
        keras_export.export_esrgan_discriminator(trees[0], trees[1], path,
                                                 input_hw=24)
        model = bridge.esrgan_discriminator_from_flax(trees[0], trees[1],
                                                      "cpu")
        custom = esrgan_custom_objects()
        x = rng.random((2, 24, 24, 3), dtype=np.float32)
    else:
        keras_export.export_vgg16_classifier(trees[0], path)
        model = bridge.vgg16_from_flax(trees[0], "cpu")
        custom = None
        x = rng.random((2, 96, 96, 3), dtype=np.float32)
    model.eval()
    training = name == "esrgan_discriminator"
    km = tf.keras.models.load_model(path, safe_mode=False,
                                    custom_objects=custom, compile=False)
    want = _run(model, x)
    got = km(x, training=training).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
