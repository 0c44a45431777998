"""Typed experiment configs: a copy of ``tpusr/config.py`` (the JAX
package's ``__init__`` imports JAX, so the port copies the file rather than
importing it).

It replaces the reference's single constants file
(``SRModels/constants.py:1-15``) plus the kwargs/literals scattered through
its notebooks. One source of truth for patch geometry, seeds, model
hyperparams, and mesh shape.
"""

from __future__ import annotations

import dataclasses

RANDOM_SEED = 42  # constants.py:15

# constants.py:1-13
SRCNN_PATCH_SIZE, SRCNN_STRIDE = 24, 12
EDSR_PATCH_SIZE, EDSR_STRIDE, EDSR_SCALE_FACTOR = 24, 12, 2
ESRGAN_PATCH_SIZE, ESRGAN_STRIDE, ESRGAN_SCALE_FACTOR = 24, 12, 2
VGG_PATCH_SIZE, VGG_STRIDE = 96, 48


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    n_devices: int | None = None      # None = all local devices
    axis_names: tuple[str, ...] = ("data",)


@dataclasses.dataclass(frozen=True)
class SRCNNConfig:
    patch_size: int = SRCNN_PATCH_SIZE
    stride: int = SRCNN_STRIDE
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 50
    es_patience: int = 3              # SRCNN_model.py:82
    plateau_patience: int = 2
    f1: int = 96
    f2: int = 32


@dataclasses.dataclass(frozen=True)
class EDSRConfig:
    patch_size: int = EDSR_PATCH_SIZE
    stride: int = EDSR_STRIDE
    scale_factor: int = EDSR_SCALE_FACTOR
    num_res_blocks: int = 16
    num_filters: int = 64
    res_scaling: float = 0.1
    learning_rate: float = 5e-5       # EDSR.ipynb cell 4
    clipnorm: float = 1.0
    batch_size: int = 16
    epochs: int = 300
    es_patience: int = 5              # EDSR_model.py:160
    plateau_patience: int = 3


@dataclasses.dataclass(frozen=True)
class ESRGANConfig:
    patch_size: int = ESRGAN_PATCH_SIZE
    stride: int = ESRGAN_STRIDE
    scale_factor: int = ESRGAN_SCALE_FACTOR
    growth_channels: int = 8          # ESRGAN.ipynb cell 6
    num_rrdb_blocks: int = 4
    g_lr: float = 1e-4                # ESRGAN_model.py:176-195
    d_lr: float = 1e-5
    decay_steps: int = 10000
    decay_rate: float = 0.5
    adv_weight: float = 1.0           # ESRGAN_model.py:520-524
    perc_weight: float = 1.0
    pixel_weight: float = 100.0
    spec_weight: float = 1.0
    batch_size: int = 16
    epochs: int = 10


@dataclasses.dataclass(frozen=True)
class VGG16Config:
    patch_size: int = VGG_PATCH_SIZE
    stride: int = VGG_STRIDE
    num_classes: int = 2
    dropout_rate: float = 0.2
    dense_units: int = 256
    l2_reg: float = 0.0
    learning_rate: float = 1e-3
    batch_size: int = 32
    epochs: int = 50
    train_last_n_layers: int = 4
    base_trainable: bool = False


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    hr_root: str = "data/images/HR"
    lr_root: str = "data/images/LR"
    interpolation_map_path: str | None = None
    class_map_path: str | None = None
    test_size: float = 0.2
    val_size: float = 0.1
    seed: int = RANDOM_SEED
