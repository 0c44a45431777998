"""The port's serving-gate classifier loop on the CPU against JAX's
(``tests/data/gate_trajectory/jax_cpu.json``, written by ``make_fixture.py``
there with JAX on the CPU, read by ``chip_smoke.jax_fixture``): seed 6 of the hard task at full width, the
gate's surfaces, pool, VGG16 from ``PRNGKey(42)``, batches and dropout
masks, steps 0-11 (``tpusr_torch.tools.gate_trajectory.Loop``).

Measured on the CPU: the losses are 6e-8 and 3e-7 apart at steps 0 and 1
and 1e-5 at step 2; the gap then grows about tenfold a step (float32 sums
in another order, carried by Adam's first steps), and both runs spike above
1.0 at step 5 (1.1449 and 1.1316) before the ln 2 plateau. So steps 0 and 1
are held within 1e-6, step 2 within 1e-4, and step 5 above 1.0 in both.
"""

import numpy as np
import pytest

from chip_smoke import jax_fixture
from tpusr_torch.tools.gate_trajectory import Loop, first_escape

SEED, STEPS = 6, 12


@pytest.fixture(scope="module")
def port_loss():
    run = Loop(SEED, "cpu").run(STEPS)
    return np.array(run["loss"], np.float32), np.array(run["accuracy"])


def test_the_fixture_is_jax_cpu_at_300_steps_of_seed_6_and_30_of_7_8():
    loss, acc = jax_fixture(SEED)
    assert loss.shape == acc.shape == (300,)
    assert all(jax_fixture(s)[0].shape == (30,) for s in (7, 8))
    assert abs(float(loss[0]) - np.log(2)) < 1e-3
    assert first_escape(loss) is not None and first_escape(loss) > 200


@pytest.mark.parametrize("step,atol", [(0, 1e-6), (1, 1e-6), (2, 1e-4)])
def test_the_port_steps_as_jax_on_the_cpu(port_loss, step, atol):
    jax_loss, _ = jax_fixture(SEED)
    assert abs(float(port_loss[0][step]) - float(jax_loss[step])) <= atol


def test_both_spike_at_step_5_and_return_to_the_plateau(port_loss):
    jax_loss, _ = jax_fixture(SEED)
    assert port_loss[0][5] > 1.0 and jax_loss[5] > 1.0
    assert np.abs(port_loss[0][9:] - np.log(2)).max() < 0.01
    assert ((port_loss[1] >= 0) & (port_loss[1] <= 1)).all()
