"""The port's models draw their initial weights on their own device
(``tpusr_torch/models/init.py``): every sampler call of a build goes to the
device the model is built for, the draw helpers refuse a draw with no
device, and a build moves no global generator. That the drawn values are
flax's ``init`` on the same key is held in ``tests/test_torch_prng.py``.

The seven models are those ``chip_smoke.py``'s ``[init]`` phase builds at
full width on the card, here at narrow widths: EDSR x4, SRCNN, the VGG16
classifier, VGG19 up to ``block5_conv4``, the ESRGAN generator at two
configurations and the discriminator. On the ``meta`` device the samplers
are replaced by recorders, so a build that drew anything on the CPU, or
made any parameter there, would show.
"""

import random

import numpy as np
import pytest
import torch

from test_torch_fixtures import NARROW_WIDTHS
from tpusr_torch.core import prng
from tpusr_torch.models import (EDSR, SRCNN, ESRGANDiscriminator,
                                ESRGANGenerator)
from tpusr_torch.models.init import (ParamRng, dense_params, drawn_leaves,
                                     glorot_uniform, variance_scaling)
from tpusr_torch.models.vgg import VGG16Classifier, VGG19Features

MODELS = {
    "edsr_x4": lambda dev: EDSR(scale_factor=4, num_res_blocks=2,
                                num_filters=8, device=dev, key=1),
    "srcnn": lambda dev: SRCNN(f1=8, f2=4, device=dev, key=2),
    "vgg16": lambda dev: VGG16Classifier(num_classes=2, dense_units=16,
                                         widths=NARROW_WIDTHS, device=dev,
                                         key=3),
    "vgg19": lambda dev: VGG19Features(widths=NARROW_WIDTHS, device=dev,
                                       key=4),
    "esrgan_x4": lambda dev: ESRGANGenerator(4, 4, 1, base_filters=16,
                                             device=dev, key=5),
    "esrgan_x2": lambda dev: ESRGANGenerator(2, 4, 2, base_filters=16,
                                             device=dev, key=6),
    "discriminator": lambda dev: ESRGANDiscriminator(device=dev, key=7),
}
# the samplers a build calls, by the position of their shape argument
SAMPLERS = {"truncated_normal": 3, "uniform": 1, "normal": 1}


def record_draws(monkeypatch) -> list:
    """Replace the samplers a build calls with recorders of (sampler,
    device); on the CPU each calls through, elsewhere it returns an empty
    tensor of the sampler's shape. The plain draw's words are recorded
    too (``_bits32``)."""
    calls = []
    for name, at in SAMPLERS.items():
        real = getattr(prng, name)

        def rec(*args, _name=name, _real=real, _at=at, **kw):
            device, shape = args[-1], args[_at]
            calls.append((_name, torch.device(device)))
            if torch.device(device).type == "cpu":
                return _real(*args, **kw)
            return torch.empty(shape, device=device)
        monkeypatch.setattr(prng, name, rec)
    bits = prng._bits32

    def rec_bits(key, shape, device):
        calls.append(("_bits32", torch.device(device or "cpu")))
        return bits(key, shape, device)
    monkeypatch.setattr(prng, "_bits32", rec_bits)
    return calls


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_draw_of_a_build_goes_to_the_models_device(name, device,
                                                         monkeypatch):
    calls = record_draws(monkeypatch)
    model = MODELS[name](device)
    dev = torch.device(device)
    samplers = [c for c in calls if c[0] != "_bits32"]
    assert len(samplers) == drawn_leaves(model) > 0
    assert {d for _n, d in calls} == {dev}, calls
    tensors = list(model.parameters()) + list(model.buffers())
    assert {t.device for t in tensors} == {dev}


def test_no_draw_builds_zeros_on_the_device_and_draws_nothing(monkeypatch):
    calls = record_draws(monkeypatch)
    model = EDSR(scale_factor=2, num_res_blocks=1, num_filters=8,
                 device="meta", key="no draw")
    assert calls == []
    assert {p.device.type for p in model.parameters()} == {"meta"}


@pytest.mark.parametrize("helper", [
    lambda: variance_scaling((0, 1), (3, 3, 2, 4), 1.0, None),
    lambda: glorot_uniform((0, 1), (4, 8), None),
    lambda: dense_params(ParamRng(1), (3, 3, 2, 4), None),
    lambda: dense_params(ParamRng("no draw"), (3, 3, 2, 4), None),
], ids=["variance_scaling", "glorot_uniform", "dense_params",
        "dense_params_no_draw"])
def test_a_draw_helper_without_a_device_raises(helper, monkeypatch):
    calls = record_draws(monkeypatch)
    with pytest.raises(ValueError, match="needs the device"):
        helper()
    assert calls == []


def test_a_layer_scope_without_a_device_raises():
    from tpusr_torch.models.edsr import Conv3x3
    with pytest.raises(ValueError, match="needs the device"):
        Conv3x3(2, 4, ParamRng(3).child("head"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_build_moves_no_generator(name):
    torch_state = torch.random.get_rng_state()
    np_state = np.random.get_state()
    py_state = random.getstate()
    launches = dict(prng.LAUNCHES)
    MODELS[name]("cpu")
    assert torch.equal(torch.random.get_rng_state(), torch_state)
    after = np.random.get_state()
    assert after[0] == np_state[0] and np.array_equal(after[1], np_state[1])
    assert after[2:] == np_state[2:]
    assert random.getstate() == py_state
    assert prng.LAUNCHES == launches


def test_trainer_draws_a_fresh_state_on_its_device(monkeypatch):
    """``init_state(rng=...)`` draws anew on the trainer's device, not on
    the CPU to be copied."""
    from tpusr_torch.train import ClassifierTrainer
    model = MODELS["vgg16"]("cpu")
    tr = ClassifierTrainer(model, 1e-3, device="cpu")
    calls = record_draws(monkeypatch)
    st = tr.init_state(rng=9)
    assert len([c for c in calls if c[0] != "_bits32"]) == drawn_leaves(model)
    assert {d for _n, d in calls} == {torch.device("cpu")}
    fresh = VGG16Classifier(num_classes=2, dense_units=16,
                            widths=NARROW_WIDTHS, device="cpu", key=9)
    for k, v in fresh.named_parameters():
        assert torch.equal(st.params[k], v), k
