"""A full-width EDSR x4 ``TrainState`` (16 blocks of 64 filters, 1,517,571
parameters; drawn weights after two steps of the trainer's Adam), written
by the JAX package's ``save_checkpoint``, restored by the port leaf for
leaf, and the port's save of it read back by JAX's ``restore_checkpoint``
equal, on the CPU (a file of its own: the largest checkpoint of the CPU
tests)."""

import jax
import jax.numpy as jnp

from test_torch_orbax import (assert_same_leaves, jax_leaves, mf,
                              port_leaves, port_state, _moments_not_zero)
from tpusr.train.checkpoint import restore_checkpoint as jax_restore
from tpusr.train.checkpoint import save_checkpoint as jax_save
from tpusr_torch.train import restore_checkpoint, save_checkpoint


def test_full_width_edsr_x4_train_state_round_trips(tmp_path):
    arch = {"scale_factor": 4, "channels": 3, "num_res_blocks": 16,
            "num_filters": 64, "res_scaling": 0.1}
    _tr, st_j, _fwd, _x = mf.edsr_state(train=False, **arch)
    want = jax_leaves(st_j)
    assert sum(v.size for k, v in want.items() if k[0] == "params") == 1517571
    _moments_not_zero(want)
    jax_save(str(tmp_path), "x4", st_j)
    _pt, template, _f = port_state("edsr_x4", arch)
    got = restore_checkpoint(str(tmp_path), "x4", template)
    assert_same_leaves(port_leaves(got), want)
    save_checkpoint(str(tmp_path / "t"), "x4", got)
    back = jax_restore(str(tmp_path / "t"), "x4",
                       jax.tree.map(jnp.zeros_like, st_j))
    assert_same_leaves(jax_leaves(back), want)
