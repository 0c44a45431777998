"""Write ``jax_cpu.json`` beside this file: the JAX package's serving-gate
classifier loop on the hard task, run on the CPU, as float32 bit patterns
(hex) of each step's loss and train-batch accuracy. It is the reference that
``tests/test_torch_gate_trajectory.py`` and ``chip_smoke.py``'s gate phase
hold the port's loop to.

    JAX_PLATFORMS=cpu python tests/data/gate_trajectory/make_fixture.py

The loop is ``tpusr/tools/serving_gate.py::train_classifier`` as
``run_gate`` calls it for ``--task hard`` at seed S: the training surfaces
``make_surface_images(S, 64, 512, (0.12, 0.25), 0.01, (0.35, 1.0))``, the
pool of 2048 crops of 96^2 (seed 100, half of it through the area ->
bicubic cycle), ``VGG16Classifier(2)`` under ``ClassifierTrainer`` at lr
2e-4, and batches of 64 from ``randint(fold_in(PRNGKey(0), step))``. Seed 6
runs 300 steps (its loss leaves the ln 2 plateau near step 240; about 12
minutes on 8 CPU cores), seeds 7 and 8 run 30 (``RUNS``).
"""

import json
import os
import struct
import time

import jax
import jax.numpy as jnp
import jaxlib
import numpy as np

from tpusr.core.resize import resize
from tpusr.models import VGG16Classifier
from tpusr.tools.serving_gate import PATCH, TASKS, make_crop_pool, \
    make_surface_images
from tpusr.train import ClassifierTrainer

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRAIN, SIZE, BATCH, POOL, LR = 64, 512, 64, 2048, 2e-4
RUNS = {6: 300, 7: 30, 8: 30}       # seed -> steps


def f32_hex(v) -> str:
    return struct.pack(">f", np.float32(v)).hex()


def trajectory(seed: int, steps: int) -> dict:
    task = TASKS["hard"]
    hr, labels = make_surface_images(seed, N_TRAIN, SIZE, task["amp_range"],
                                     task["noise"], task["coverage_range"])
    pool_x, pool_y, _ = make_crop_pool(100, hr, labels, POOL, PATCH)
    half = pool_x.shape[0] // 2
    cycled = resize(resize(pool_x[:half], (PATCH // 4, PATCH // 4), "area"),
                    (PATCH, PATCH), "bicubic")
    pool_x = jnp.concatenate([jnp.clip(cycled, 0.0, 1.0), pool_x[half:]])
    trainer = ClassifierTrainer(VGG16Classifier(num_classes=2),
                                learning_rate=LR)
    state = trainer.init_state(jnp.zeros((1, PATCH, PATCH, 3)))
    key = jax.random.PRNGKey(0)
    loss, acc = [], []
    t0 = time.time()
    for step in range(steps):
        idx = jax.random.randint(jax.random.fold_in(key, step), (BATCH,), 0,
                                 pool_x.shape[0])
        state, m = trainer.train_step(state, jnp.take(pool_x, idx, axis=0),
                                      jnp.take(pool_y, idx, axis=0), step)
        loss.append(f32_hex(m["loss"]))
        acc.append(f32_hex(m["accuracy"]))
        if step % 25 == 0 or step == steps - 1:
            print(f"seed {seed} step {step}: loss "
                  f"{float(m['loss']):.6f} acc {float(m['accuracy']):.4f} "
                  f"({time.time() - t0:.0f} s)", flush=True)
    return {"steps": steps, "loss": loss, "accuracy": acc}


def main() -> None:
    out = {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
           "platform": jax.devices()[0].platform,
           "setup": {"task": "hard", "n_train": N_TRAIN, "size": SIZE,
                     "pool": POOL, "pool_seed": 100, "batch": BATCH,
                     "batch_key": "fold_in(PRNGKey(0), step)", "lr": LR},
           "seeds": {}}
    for seed, steps in RUNS.items():
        out["seeds"][str(seed)] = trajectory(seed, steps)
    path = os.path.join(HERE, "jax_cpu.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
