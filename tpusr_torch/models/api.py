"""Reference-shaped lifecycle facades (port of ``tpusr/models/api.py``:
``SRCNNModel``, ``EDSR``, ``ESRGAN``, ``FineTunedVGG16``, ``_saved_arch`` and
``augment_classification_set``).

The reference exposes one class per model with a uniform contract,
``setup_model`` -> ``fit`` -> ``evaluate`` -> ``super_resolve_image`` /
``classify_defects_method`` -> ``save`` (``SRCNN_model.py``,
``EDSR_model.py``, ``ESRGAN_model.py``, ``VGG16_model.py``). These facades
present that surface over the port's trainers (``tpusr_torch.train``),
inference (``pipeline/inference.py``) and patch-vote classifier, with the
JAX facades' names, arguments and defaults, plus ``device`` (CUDA unless the
caller passes ``device="cpu"``).

Each facade keeps a module as a template and a trainer state whose
parameters (by the module's parameter names) it trains, restores and saves;
``torch.func.functional_call`` runs the template on them (the ``ESRGAN``
facade's state is the GAN trainer's whole ``GANState``). Checkpoints are the
port's own (``train/checkpoint.py``), with the JAX facades' ``arch``
metadata, so ``from_pretrained``/``from_trained`` rebuilds the saved
architecture whatever the setup arguments. ``from_pretrained`` also takes
a reference Keras ``.h5`` (imported weight for weight by
``train/keras_import.py``), and ``save_h5`` exports one
(``train/keras_export.py``), both through the port's own HDF5 codec.
ImageNet weights (``imagenet_weights_path`` of ``FineTunedVGG16``,
``vgg19_weights_path`` of ``ESRGAN``) load from the Keras ``.h5`` release or
a converted ``.npz`` (``tools/imagenet_weights.py``), as in JAX. An Orbax
directory (the JAX package's checkpoint) is refused: the JAX package's
``convert`` writes it as a ``.h5``, which the port reads.

``mesh`` (a ``DeviceMesh``, ``tpusr_torch.dist``) goes to the trainers and
to full-image SR, as in JAX; under it a restored checkpoint is broadcast
from rank 0, and only rank 0 writes one.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
from torch.func import functional_call

from tpusr_torch import bridge
from tpusr_torch.config import RANDOM_SEED
from tpusr_torch.device import resolve_device
from tpusr_torch.dist.mesh import is_writer, replicate
from tpusr_torch.models.edsr import EDSR as EDSRModule
from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
from tpusr_torch.models.srcnn import SRCNN
from tpusr_torch.models.vgg import VGG16_CFG, VGG16Classifier, VGG19Features
from tpusr_torch.pipeline.defect_pipeline import classify_defects
from tpusr_torch.pipeline.inference import (srcnn_super_resolve,
                                            super_resolve_full_image,
                                            super_resolve_image)
from tpusr_torch.train.checkpoint import (load_metadata, restore_checkpoint,
                                          save_checkpoint)
from tpusr_torch.train import keras_export, keras_import
from tpusr_torch.train.gan import ESRGANTrainer
from tpusr_torch.tools.imagenet_weights import load_backbone_weights
from tpusr_torch.train.trainer import ClassifierTrainer, SupervisedSRTrainer


def _is_h5(path):
    return isinstance(path, str) and path.endswith((".h5", ".hdf5"))


def _saved_arch(pretrained_path):
    """Architecture config stored in a facade checkpoint's sidecar, if any."""
    if pretrained_path is None or _is_h5(pretrained_path):
        return None
    meta = load_metadata(os.path.dirname(pretrained_path) or ".",
                         os.path.basename(pretrained_path))
    return (meta or {}).get("arch")


def _restore(state, pretrained_path, mesh=None):
    """``state`` restored from the port's checkpoint at ``pretrained_path``;
    under a ``mesh`` every rank then holds rank 0's copy (broadcast)."""
    if pretrained_path is None or not os.path.exists(pretrained_path):
        raise FileNotFoundError(
            f"Pretrained model file not found at {pretrained_path}")
    if os.path.isdir(pretrained_path):
        raise NotImplementedError(
            f"{pretrained_path}: a directory is an Orbax checkpoint of the JAX "
            f"package, which the port does not read; write it as a Keras .h5 "
            f"with the JAX package's `python -m tpusr.cli convert --model "
            f"<model> --src {pretrained_path}` and pass the .h5 (the port's "
            f"own checkpoints are files)")
    state = restore_checkpoint(os.path.dirname(pretrained_path) or ".",
                               os.path.basename(pretrained_path), state)
    if mesh is not None:
        replicate(mesh, state)
    return state


def _h5_found(path) -> bool:
    """``path`` names a Keras ``.h5`` that exists (a missing one goes on to
    ``_restore``'s FileNotFoundError)."""
    return _is_h5(path) and os.path.exists(path)


def _take(old: dict, new: dict) -> dict:
    """``new``'s tensors under ``old``'s names, devices, dtypes and
    trainable flags (a trainer state's parameters, after an import)."""
    return {k: new[k].detach().to(v.device, v.dtype, copy=True)
            .requires_grad_(v.requires_grad) for k, v in old.items()}


def _h5_path(directory, name) -> str:
    os.makedirs(directory, exist_ok=True)
    return os.path.join(directory, f"{name}.h5")


def _seeded() -> torch.Generator:
    """The facades' initialiser stream (JAX: ``PRNGKey(RANDOM_SEED)``)."""
    return torch.Generator().manual_seed(RANDOM_SEED)


def module_with_params(module: torch.nn.Module, params: dict
                       ) -> torch.nn.Module:
    """A copy of ``module`` holding ``params`` (a trainer state's, by
    parameter name), without gradients: what the serving factory takes
    where the JAX package passes ``state.params``."""
    out = copy.deepcopy(module).requires_grad_(False)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(params[name])
    return out


class _Facade:
    """What the three facades share: the template, the state, the device."""

    def __init__(self, mesh=None, device=None):
        self.module = None
        self.trainer = None
        self.state = None
        self.mesh = mesh
        self.device = resolve_device(device)

    def _apply(self, x):
        """The template on the state's parameters."""
        return functional_call(self.module, self.state.params, (x,))

    def network(self) -> torch.nn.Module:
        """The module with the state's current weights
        (``module_with_params``)."""
        if self.module is None:
            raise ValueError("Model is not built yet.")
        return module_with_params(self.module, self.state.params)


class SRCNNModel(_Facade):
    """SRCNN lifecycle parity with ``SRCNN_model.py:18-260``."""

    def __init__(self, mesh=None, device=None):
        super().__init__(mesh, device)
        self.module = SRCNN(device=self.device, generator=_seeded())
        self._trained = False

    def setup_model(self, input_shape=(24, 24, 3), learning_rate=1e-4,
                    from_pretrained=False, pretrained_path=None,
                    compute_dtype="float32"):
        self.trainer = SupervisedSRTrainer(self.module,
                                           learning_rate=learning_rate,
                                           mesh=self.mesh,
                                           compute_dtype=compute_dtype,
                                           device=self.device)
        self.state = self.trainer.init_state()
        if from_pretrained:
            if _h5_found(pretrained_path):
                net = keras_import.import_srcnn(
                    self.state.params, pretrained_path, device=self.device)
                self.state.params = _take(self.state.params,
                                          dict(net.named_parameters()))
            else:
                self.state = _restore(self.state, pretrained_path, self.mesh)
            self._trained = True

    def fit(self, X_train, Y_train, X_val, Y_val, batch_size=16, epochs=50):
        if self.trainer is None:
            raise ValueError("Model has not been set up.")
        res = self.trainer.fit(X_train, Y_train, X_val, Y_val,
                               batch_size=batch_size, epochs=epochs,
                               es_patience=3, plateau_patience=2,
                               state=self.state)
        self.state = res.state
        self._trained = True
        return res.history, res.time_tracker, res.memory_tracker

    def evaluate(self, X_test, Y_test):
        if not self._trained:
            raise RuntimeError("Model has not been trained.")
        ev = self.trainer.evaluate(self.state, X_test, Y_test)
        print(f"Loss: {ev['loss']:.4f}, PSNR: {ev['psnr']:.2f} dB, "
              f"SSIM: {ev['ssim']:.4f}")
        return [ev["loss"], ev["psnr"], ev["ssim"]]

    def super_resolve_image(self, lr_img, hr_h, hr_w, patch_size=33, stride=14,
                            interpolation="bicubic"):
        if not self._trained:
            raise RuntimeError("Model has not been trained.")
        return srcnn_super_resolve(self._apply, lr_img, hr_h, hr_w,
                                   patch_size=patch_size, stride=stride,
                                   interpolation=interpolation,
                                   device=self.device)

    def save(self, directory, timestamp):
        if not self._trained:
            raise RuntimeError("Cannot save an untrained model.")
        if not directory:
            raise ValueError("Directory path must be provided.")
        path = save_checkpoint(directory, f"SRCNN_{timestamp}", self.state)
        print(f"Model saved to {path}")
        return path

    def save_h5(self, directory, timestamp):
        """Export to the reference's Keras ``.h5`` format
        (``SRCNN_{ts}.h5``, SRCNN_model.py:249-259): loadable with
        ``keras.models.load_model`` and re-importable bit for bit."""
        if not self._trained:
            raise RuntimeError("Cannot save an untrained model.")
        path = _h5_path(directory, f"SRCNN_{timestamp}")
        if is_writer():
            keras_export.export_srcnn(bridge.to_flax_tree(self.state.params),
                                      path)
        return path


class EDSR(_Facade):
    """EDSR lifecycle parity with ``EDSR_model.py:23-330``."""

    def __init__(self, mesh=None, device=None):
        super().__init__(mesh, device)
        self.scale_factor = None
        self.trained = False

    def setup_model(self, scale_factor=2, channels=3, num_res_blocks=16,
                    num_filters=64, res_scaling=0.1, learning_rate=1e-4,
                    loss="mean_squared_error", from_pretrained=False,
                    pretrained_path=None, compute_dtype="float32"):
        if from_pretrained:
            arch = _saved_arch(pretrained_path)
            if arch:  # the checkpoint knows its own architecture
                scale_factor = arch.get("scale_factor", scale_factor)
                channels = arch.get("channels", channels)
                num_res_blocks = arch.get("num_res_blocks", num_res_blocks)
                num_filters = arch.get("num_filters", num_filters)
                res_scaling = arch.get("res_scaling", res_scaling)
        self.scale_factor = scale_factor
        self._arch = {"scale_factor": scale_factor, "channels": channels,
                      "num_res_blocks": num_res_blocks,
                      "num_filters": num_filters, "res_scaling": res_scaling}
        self.module = EDSRModule(scale_factor=scale_factor, channels=channels,
                                 num_res_blocks=num_res_blocks,
                                 num_filters=num_filters,
                                 res_scaling=res_scaling, device=self.device,
                                 generator=_seeded())
        # the reference compiles MSE regardless of the loss arg (EDSR_model.py:137)
        self.trainer = SupervisedSRTrainer(self.module,
                                           learning_rate=learning_rate,
                                           clipnorm=1.0, mesh=self.mesh,
                                           loss="mse",
                                           compute_dtype=compute_dtype,
                                           device=self.device)
        self.state = self.trainer.init_state()
        if from_pretrained:
            if _h5_found(pretrained_path):
                net = keras_import.import_edsr(
                    self.state.params, pretrained_path,
                    num_res_blocks=num_res_blocks, scale_factor=scale_factor,
                    res_scaling=res_scaling, device=self.device)
                self.state.params = _take(self.state.params,
                                          dict(net.named_parameters()))
            else:
                self.state = _restore(self.state, pretrained_path, self.mesh)
            self.trained = True

    def fit(self, X_train, Y_train, X_val, Y_val, batch_size=16, epochs=300):
        if self.module is None:
            raise ValueError("Model is not built yet.")
        res = self.trainer.fit(X_train, Y_train, X_val, Y_val,
                               batch_size=batch_size, epochs=epochs,
                               es_patience=5, plateau_patience=3,
                               state=self.state)
        self.state = res.state
        self.trained = True
        return res.history, res.time_tracker, res.memory_tracker

    def evaluate(self, X_test, Y_test):
        if not self.trained:
            raise RuntimeError("Model has not been trained.")
        ev = self.trainer.evaluate(self.state, X_test, Y_test)
        print(f"Loss: {ev['loss']:.4f}, PSNR: {ev['psnr']:.2f} dB, "
              f"SSIM: {ev['ssim']:.4f}")
        return [ev["loss"], ev["psnr"], ev["ssim"]]

    def super_resolve_image(self, lr_img, patch_size_lr=48, stride=24):
        if not self.trained:
            raise RuntimeError("Model has not been trained.")
        if self.scale_factor is None:
            raise ValueError("scale_factor is not set. Call setup_model first.")
        return super_resolve_image(self._apply, lr_img,
                                   patch_size_lr=patch_size_lr, stride=stride,
                                   scale=self.scale_factor, device=self.device)

    def save(self, directory, timestamp):
        if not self.trained:
            raise RuntimeError("Cannot save an untrained model.")
        if not directory:
            raise ValueError("Directory path must be provided.")
        path = save_checkpoint(directory,
                               f"EDSR_x{self.scale_factor}_{timestamp}",
                               self.state, metadata={"arch": self._arch})
        print(f"Model saved to {path}")
        return path

    def save_h5(self, directory, timestamp):
        """Export to the reference's Keras ``.h5`` format
        (``EDSR_x{s}_{ts}.h5``, EDSR_model.py:317-330)."""
        if not self.trained:
            raise RuntimeError("Cannot save an untrained model.")
        path = _h5_path(directory, f"EDSR_x{self.scale_factor}_{timestamp}")
        if is_writer():
            keras_export.export_edsr(bridge.to_flax_tree(self.state.params),
                                     path,
                                     res_scaling=self._arch["res_scaling"])
        return path


class ESRGAN(_Facade):
    """ESRGAN lifecycle parity with ``ESRGAN_model.py:81-996``: the
    generator, the discriminator and the frozen VGG19 extractor, trained
    adversarially by ``ESRGANTrainer``; ``state`` is its whole
    ``GANState``."""

    def __init__(self, mesh=None, device=None):
        super().__init__(mesh, device)
        self.generator = None
        self.discriminator = None
        self.vgg_model = None
        self.scale_factor = None
        self.trained = False

    def setup_model(self, scale_factor=2, growth_channels=32,
                    num_rrdb_blocks=23, input_shape=(24, 24, 3),
                    output_shape=(48, 48, 3), from_trained=False,
                    generator_pretrained_path=None,
                    discriminator_pretrained_path=None,
                    vgg19_weights_path=None, compute_dtype="float32"):
        if from_trained:
            arch = _saved_arch(generator_pretrained_path)
            if arch:
                scale_factor = arch.get("scale_factor", scale_factor)
                growth_channels = arch.get("growth_channels", growth_channels)
                num_rrdb_blocks = arch.get("num_rrdb_blocks", num_rrdb_blocks)
                # the output is always input * scale
                output_shape = (input_shape[0] * scale_factor,
                                input_shape[1] * scale_factor,
                                input_shape[2])
        self.scale_factor = scale_factor
        self.output_shape = tuple(output_shape)
        self._arch = {"scale_factor": scale_factor,
                      "growth_channels": growth_channels,
                      "num_rrdb_blocks": num_rrdb_blocks}
        g = _seeded()
        self.generator = ESRGANGenerator(scale_factor=scale_factor,
                                         growth_channels=growth_channels,
                                         num_rrdb_blocks=num_rrdb_blocks,
                                         device=self.device, generator=g)
        self.discriminator = ESRGANDiscriminator(device=self.device,
                                                 generator=g)
        # the JAX facade draws VGG19 from PRNGKey(0)
        self.vgg_model = VGG19Features(
            device=self.device, generator=torch.Generator().manual_seed(0))
        if vgg19_weights_path:
            load_backbone_weights(self.vgg_model, vgg19_weights_path, "vgg19")
        self.trainer = ESRGANTrainer(self.generator, self.discriminator,
                                     self.vgg_model, mesh=self.mesh,
                                     compute_dtype=compute_dtype,
                                     device=self.device)
        self.state = self.trainer.init_state(input_shape, output_shape)
        if from_trained:
            if (generator_pretrained_path is None
                    or not os.path.exists(generator_pretrained_path)):
                raise FileNotFoundError("Generator pretrained path does not "
                                        f"exist: {generator_pretrained_path}")
            if _is_h5(generator_pretrained_path):
                # the reference reloads BOTH networks to resume adversarial
                # training (ESRGAN_model.py:137-149)
                if (discriminator_pretrained_path is None
                        or not os.path.exists(discriminator_pretrained_path)):
                    raise FileNotFoundError(
                        "Discriminator pretrained path does not exist: "
                        f"{discriminator_pretrained_path}")
                st = self.state
                g = keras_import.import_esrgan_generator(
                    st.g_params, generator_pretrained_path,
                    device=self.device)
                d = keras_import.import_esrgan_discriminator(
                    st.d_params, st.d_spectral, discriminator_pretrained_path,
                    device=self.device)
                st.g_params = _take(st.g_params, dict(g.named_parameters()))
                st.d_params = _take(st.d_params, dict(d.named_parameters()))
                st.d_spectral = _take(st.d_spectral, dict(d.named_buffers()))
            else:
                # the port's checkpoint holds the whole GANState
                self.state = _restore(self.state, generator_pretrained_path,
                                      self.mesh)
            self.trained = True

    def network(self) -> torch.nn.Module:
        """The generator with the state's current weights."""
        if self.generator is None:
            raise ValueError("Model is not built yet.")
        return module_with_params(self.generator, self.state.g_params)

    def _apply(self, x):
        return functional_call(self.generator, self.state.g_params, (x,))

    def fit(self, X_train=None, Y_train=None, X_val=None, Y_val=None,
            epochs=100, batch_size=16, steps_per_epoch=None, normalize=True,
            save_dir=None):
        if X_train is None or Y_train is None:
            raise ValueError("Must provide (X_train, Y_train)")
        res = self.trainer.fit(X_train, Y_train, X_val, Y_val, epochs=epochs,
                               batch_size=batch_size,
                               steps_per_epoch=steps_per_epoch,
                               normalize=normalize, save_dir=save_dir,
                               state=self.state)
        self.state = res.state
        self.trained = True
        return res.epoch_losses, res.time_tracker, res.memory_tracker

    def evaluate(self, X_test, Y_test, batch_size=16):
        if not self.trained:
            raise RuntimeError("Model has not been trained.")
        return self.trainer.evaluate(self.state, X_test, Y_test,
                                     batch_size=batch_size)

    def super_resolve_image(self, lr_img, patch_size_lr=48, stride=24,
                            batch_size=16):
        if not self.trained:
            raise RuntimeError("Model has not been trained or loaded.")
        return super_resolve_image(self._apply, lr_img,
                                   patch_size_lr=patch_size_lr, stride=stride,
                                   scale=self.scale_factor, normalize_pm1=True,
                                   device=self.device)

    def super_resolve_full_image(self, lr_img, attention_block_size=4096):
        """Full-image SR: the whole image through the generator at once,
        its attention blockwise (``pipeline.super_resolve_full_image``).
        Returns (sr_img in [0, 1], metrics dict)."""
        if not self.trained:
            raise RuntimeError("Model has not been trained or loaded.")
        return super_resolve_full_image(
            self.network(), lr_img, mesh=self.mesh,
            attention_block_size=attention_block_size)

    def save(self, directory, timestamp):
        if not self.trained:
            raise RuntimeError("Cannot save an untrained model.")
        path = save_checkpoint(
            directory, f"ESRGAN_x{self.scale_factor}_{timestamp}", self.state,
            metadata={"arch": self._arch})
        print(f"Generator+discriminator state saved to {path}")
        return path

    def save_h5(self, directory, timestamp):
        """Export generator + discriminator to the reference's two-file
        Keras ``.h5`` format (``ESRGAN_{generator,discriminator}_x{s}_{ts}
        .h5``, ESRGAN_model.py:981-996). Returns (gen_path, disc_path)."""
        if not self.trained:
            raise RuntimeError("Cannot save an untrained model.")
        s, st = self.scale_factor, self.state
        g_path = _h5_path(directory, f"ESRGAN_generator_x{s}_{timestamp}")
        d_path = _h5_path(directory,
                          f"ESRGAN_discriminator_x{s}_{timestamp}")
        if is_writer():
            keras_export.export_esrgan_generator(
                bridge.esrgan_generator_to_flax(st.g_params), g_path)
            keras_export.export_esrgan_discriminator(
                bridge.to_flax_tree(st.d_params),
                bridge.to_flax_tree(st.d_spectral), d_path,
                input_hw=self.output_shape[0])
        return g_path, d_path


class FineTunedVGG16(_Facade):
    """VGG16 defect-classifier lifecycle parity with ``VGG16_model.py:16-281``."""

    def __init__(self, mesh=None, device=None):
        super().__init__(mesh, device)
        self.input_shape = None
        self.trained = False

    def setup_model(self, input_shape=(128, 128, 3), num_classes=2,
                    train_last_n_layers=4, base_trainable=False,
                    dropout_rate=0.2, l2_reg=0.0, learning_rate=1e-3,
                    loss="sparse_categorical_crossentropy",
                    from_pretrained=False, pretrained_path=None,
                    imagenet_weights_path=None, compute_dtype="float32"):
        if from_pretrained:
            arch = _saved_arch(pretrained_path)
            if arch:
                input_shape = tuple(arch.get("input_shape", input_shape))
                num_classes = arch.get("num_classes", num_classes)
                dropout_rate = arch.get("dropout_rate", dropout_rate)
        assert input_shape[-1] == 3, "Input must have 3 channels (RGB)."
        if loss != "sparse_categorical_crossentropy":
            raise ValueError(
                f"Unsupported loss {loss!r}: only "
                "'sparse_categorical_crossentropy' is implemented "
                "(the reference compiles exactly this, VGG16_model.py:102)")
        self.input_shape = tuple(input_shape)
        self._arch = {"input_shape": list(self.input_shape),
                      "num_classes": num_classes, "dropout_rate": dropout_rate}
        self.module = VGG16Classifier(num_classes=num_classes,
                                      dropout_rate=dropout_rate,
                                      device=self.device, generator=_seeded())
        if imagenet_weights_path:
            load_backbone_weights(self.module, imagenet_weights_path, "vgg16")
        pred = None
        if not base_trainable:
            pred = lambda path: path[0] != "vgg16"  # noqa: E731
        elif train_last_n_layers > 0:
            # unfreeze the last N backbone conv layers (VGG16_model.py:79-82)
            names = [f"block{b}_conv{c}" for b, n, _f in VGG16_CFG
                     for c in range(1, n + 1)]
            trainable = set(names[-train_last_n_layers:])
            pred = lambda path: (path[0] != "vgg16"  # noqa: E731
                                 or path[1] in trainable)
        self.trainer = ClassifierTrainer(self.module,
                                         learning_rate=learning_rate,
                                         mesh=self.mesh,
                                         trainable_predicate=pred,
                                         l2_reg=l2_reg,
                                         compute_dtype=compute_dtype,
                                         device=self.device)
        self.state = self.trainer.init_state()
        if from_pretrained:
            if _h5_found(pretrained_path):
                net = keras_import.import_vgg16_classifier(
                    self.state.params, pretrained_path, device=self.device)
                self.state.params = _take(self.state.params,
                                          dict(net.named_parameters()))
            else:
                self.state = _restore(self.state, pretrained_path, self.mesh)
            self.trained = True

    def fit(self, X_train, y_train, X_val, y_val, batch_size=32, epochs=50,
            use_augmentation=True):
        if self.module is None:
            raise ValueError("Model is not built yet.")
        # augmentation happens per batch inside the train step (Keras
        # ImageDataGenerator parity, tpusr_torch.data.augment)
        res = self.trainer.fit(X_train, y_train, X_val, y_val,
                               batch_size=batch_size, epochs=epochs,
                               augment=use_augmentation, state=self.state)
        self.state = res.state
        self.trained = True
        return res.history

    def evaluate(self, X_test, y_test):
        if not self.trained:
            raise RuntimeError("Model has not been trained.")
        ev = self.trainer.evaluate(self.state, X_test, y_test)
        print(f"Loss: {ev['loss']:.4f}, Accuracy: {ev['accuracy']:.4f}")
        return [ev["loss"], ev["accuracy"]]

    def classify_defects_method(self, image, patch_size=None, stride=None,
                                batch_size=32):
        if self.module is None:
            raise ValueError("Model is not built yet.")
        if not self.trained:  # same guard as evaluate(): random-init weights
            raise RuntimeError("Model has not been trained.")
        if image is None:
            raise ValueError("image must be provided")
        img = np.asarray(image)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError("image must be HxWx3 RGB array")
        if patch_size is None:
            patch_size = int(self.input_shape[0])
        return classify_defects(self._apply, img, patch=patch_size,
                                stride=stride, device=self.device)

    def save(self, directory, timestamp):
        if not self.trained:
            raise RuntimeError("Cannot save an untrained model.")
        path = save_checkpoint(directory, f"VGG16_{timestamp}", self.state,
                               metadata={"arch": self._arch})
        print(f"Model saved to {path}")
        return path

    def save_h5(self, directory, timestamp):
        """Export to the reference's Keras ``.h5`` format
        (``VGG16_{ts}.h5``, VGG16_model.py:272-281)."""
        if not self.trained:
            raise RuntimeError("Cannot save an untrained model.")
        path = _h5_path(directory, f"VGG16_{timestamp}")
        if is_writer():
            keras_export.export_vgg16_classifier(
                bridge.to_flax_tree(self.state.params), path,
                input_shape=self.input_shape)
        return path


def augment_classification_set(x, y, seed=RANDOM_SEED, device=None):
    """One-shot dataset doubling via the Keras-parity warp ops, drawn from a
    generator seeded by ``seed`` on ``device``.

    Training-time parity lives in the train step (``ClassifierTrainer`` with
    ``augment=True`` warps every batch on the fly, like
    ``ImageDataGenerator.flow`` in VGG16_model.py:129-140); this helper
    remains for offline dataset expansion only.
    """
    from tpusr_torch.data.augment import random_augment_batch

    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    out = random_augment_batch(torch.Generator(device=dev).manual_seed(seed), xt)
    return (np.concatenate([xt.cpu().numpy(), out.cpu().numpy()]),
            np.concatenate([y, y]))
