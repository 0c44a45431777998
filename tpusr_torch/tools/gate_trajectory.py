"""The serving gate's VGG16 loop step by step, on one device.

The loop is ``serving_gate.train_classifier`` as ``run_gate`` runs it for
``--task hard`` at one seed: the seed's 64 training surfaces, the pool of
2048 crops (``classifier_pool``), VGG16 (2 classes) from ``PRNGKey(42)``
under ``ClassifierTrainer`` at rate 2e-4, and step s's batch of 64 from
``fold_in(PRNGKey(0), s)`` (``classifier_batch``). ``Loop`` runs it and
keeps each step's loss and train-batch accuracy, so that its course can be
held to JAX's and one device's to another's; ``first_escape`` finds where a
course leaves the ln 2 plateau that the classifier sits on after its first
steps.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusr_torch.models import VGG16Classifier
from tpusr_torch.tools.serving_gate import (INIT_SEED, TASKS,
                                            classifier_batch,
                                            classifier_pool,
                                            make_surface_images)
from tpusr_torch.train import ClassifierTrainer

N_TRAIN, SIZE, BATCH, LR = 64, 512, 64, 2e-4
ESCAPE_LOSS = 0.5     # the plateau sits at ln 2 = 0.6931; an escape is well below


def first_escape(losses, start: int = 0) -> int | None:
    """The first step (counted from ``start``) whose loss is under
    ``ESCAPE_LOSS``, or None."""
    for i, v in enumerate(losses):
        if v < ESCAPE_LOSS:
            return start + i
    return None


class Loop:
    """Seed ``seed``'s gate classifier loop on ``device``: the pool (built
    there, or ``pool`` moved there), the model, the trainer and its state at
    step ``step``."""

    def __init__(self, seed: int, device, pool=None):
        dev = torch.device(device)
        if pool is None:
            task = TASKS["hard"]
            hr, labels = make_surface_images(
                seed, N_TRAIN, SIZE, task["amp_range"], task["noise"],
                task["coverage_range"], device=dev)
            pool = classifier_pool(hr, labels)
            del hr
        self.pool = tuple(t.to(dev) for t in pool)
        self.device = dev
        self.trainer = ClassifierTrainer(
            VGG16Classifier(num_classes=2, device=dev, key=INIT_SEED),
            learning_rate=LR, device=dev)
        self.state = self.trainer.init_state()
        self.step = 0

    def batch(self, step: int):
        return classifier_batch(*self.pool, step, BATCH)

    def run(self, steps: int) -> dict:
        """``steps`` steps from ``self.step``: {"loss", "accuracy"}, lists
        of floats."""
        out = []
        for _ in range(steps):
            self.state, m = self.trainer.train_step(
                self.state, *self.batch(self.step), self.step)
            out.append(torch.stack([m["loss"], m["accuracy"]]))
            self.step += 1
        vals = torch.stack(out).cpu().numpy() if out else np.zeros((0, 2))
        return {"loss": vals[:, 0].tolist(), "accuracy": vals[:, 1].tolist()}
