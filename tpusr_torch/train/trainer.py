"""Supervised trainers for SRCNN / EDSR / VGG16 (port of
``tpusr/train/trainer.py``).

Lifecycle parity with the reference model classes (``SRCNN_model.py:62-109``,
``EDSR_model.py:140-187``, ``VGG16_model.py:111-166``): ``fit`` returns
(history, time_tracker, memory_tracker, state); EarlyStopping(val_loss) with
best-weight restore, ReduceLROnPlateau, Adam. The JAX class names, arguments
and defaults hold, plus ``device`` (CUDA unless the caller passes
``device="cpu"``).

The state is the JAX trainer's: a ``TrainState`` of parameters (the model's
parameter names -> tensors), optimiser state and a mutable learning rate.
The model is a template run by ``torch.func.functional_call`` on the
state's parameters, so a restored or copied state trains and evaluates as it
is. Where JAX donates the state and returns a new one, a step here updates
the state's tensors in place and returns the same state: ``EarlyStopping``
and the checkpoints keep real copies.

A step: forward (EDSR's convs on K2 and its input gradient on K2, through
``conv3x3_bias_act_train``; SRCNN and VGG16 on ``F.conv2d``, as XLA runs
them in JAX), loss, gradients, optax's ``clip_by_global_norm`` when
``clipnorm`` is set, Adam (b1 0.9, b2 0.999, eps 1e-8, then the rate), and
the PSNR/SSIM or accuracy metrics without grad. Metrics stay on the device
until an epoch ends.

``compute_dtype="bfloat16"`` is JAX's ``_cast_in``: the forward runs on the
parameters and the input cast to bf16 (EDSR's convs on K2-bf16, forward and
dX) and its output is cast to float32; master parameters, Adam's moments,
the loss and the metrics stay float32, and the gradients reach the float32
parameters through the casts. ``remat=True`` (``SupervisedSRTrainer``, as
JAX's ``jax.checkpoint`` of the forward; JAX's ``ClassifierTrainer`` has no
``remat``) keeps no activation of the forward for the backward and runs the
forward again there (``torch.utils.checkpoint``, non-reentrant): the same
gradients, bit for bit, for the memory of the activations, and on a card
one K2 launch more per conv.

``mesh`` (a ``DeviceMesh`` with a 'data' axis, ``tpusr_torch.dist``):
every rank is called with the same global batch and takes its rows. The
loss and every metric are the global weighted means: each rank sums
``w * value`` over its rows, divides by the global ``sum(w)`` (the padded
trailing batch's mask counts once), and the ranks all-reduce those sums,
not their own means. The gradients are all-reduced over 'data' before
``clip_by_global_norm`` and Adam, so every rank takes the same step. With a
'model' axis the state may hold output-channel shards
(``dist.shard_params_tp``): the sharded modules gather their channels in
the forward, the clip's norm sums the shards over 'model', and a
checkpoint holds the shards gathered whole. Only rank 0 writes
checkpoints, metric logs and the epoch lines.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpusr_torch.bridge import flax_path
from tpusr_torch.core import prng
from tpusr_torch.data.augment import random_augment_batch
from tpusr_torch.data.prefetch import prefetch_iterator
from tpusr_torch.device import resolve_device
from tpusr_torch.dist.mesh import (all_reduce_flat, axis_index, batch_shard,
                                   check_mesh, has_axis, is_writer, replicate)
from tpusr_torch.dist.tp import (full_param, gather_params_tp,
                                 sharded_names, tp_modules)
from tpusr_torch.metrics.image import psnr as psnr_fn, ssim as ssim_fn
from tpusr_torch.train.callbacks import (EarlyStopping, EpochMemoryTracker,
                                         EpochTimeTracker, ReduceLROnPlateau)
from tpusr_torch.train.checkpoint import save_checkpoint_async

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TrainState:
    """Parameters by the model's parameter names; ``opt_state`` holds Adam's
    step ``count`` and the moments ``mu``/``nu`` of the trainable
    parameters (and any moment of a frozen one restored from a state that
    trained it, ``bridge.train_state_from_jax``); ``lr`` is mutable so
    ``ReduceLROnPlateau`` can change it."""
    params: dict
    opt_state: dict
    lr: float


@dataclasses.dataclass
class FitResult:
    history: dict
    time_tracker: EpochTimeTracker
    memory_tracker: EpochMemoryTracker
    state: TrainState


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(compute_dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or the torch dtype) -> the torch dtype;
    K2 has these two instances, so no other."""
    for name, dt in _COMPUTE_DTYPES.items():
        if compute_dtype in (name, dt):
            return dt
    raise ValueError(f"compute_dtype={compute_dtype!r}: 'float32' or "
                     f"'bfloat16'")


def cast_in(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``_cast_in`` of one leaf: a floating tensor cast to the compute
    dtype (differentiably), anything else as it is."""
    if t.is_floating_point() and t.dtype != dtype:
        return t.to(dtype)
    return t


def remat_call(fn, on: bool):
    """``fn()``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``on`` and autograd records: no activation of ``fn`` is kept for the
    backward, which runs ``fn`` again (``jax.checkpoint``)."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, use_reentrant=False)
    return fn()


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the JAX state holds its rate."""
    return float(np.float32(v))


def _take(a, sel: np.ndarray, device: torch.device) -> torch.Tensor:
    """Rows ``sel`` of a numpy array or a tensor, as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(sel, device=a.device)].to(device)
    return torch.as_tensor(np.asarray(a)[sel]).to(device)


def _wmean(v: torch.Tensor, w: torch.Tensor, denom=None) -> torch.Tensor:
    """sum(v * w) / denom; ``denom`` defaults to sum(w) (a rank's rows of
    a global batch pass the global sum)."""
    return torch.sum(v * w) / (torch.sum(w) if denom is None else denom)


def clip_by_global_norm(grads: list, max_norm: float, sharded=None,
                        group=None) -> list:
    """optax's ``clip_by_global_norm``: every leaf ``(g / |g|) * max_norm``
    where the global norm |g| over all leaves is at least ``max_norm``
    (``clip_grad_norm_`` divides by |g| + 1e-6 instead). ``sharded[i]``
    marks leaf i as a tensor-parallel shard, whose squares are summed over
    ``group`` (the 'model' ranks)."""
    sq = [torch.sum(g * g) for g in grads]
    if sharded is not None and any(sharded):
        part = torch.stack([q for q, s in zip(sq, sharded) if s]).sum()
        torch.distributed.all_reduce(part, group=group)
        sq = [q for q, s in zip(sq, sharded) if not s] + [part]
    g_norm = torch.sqrt(torch.stack(sq).sum())
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


def adam_update(opt: dict, params: dict, names: list, grads: list,
                lr: float) -> None:
    """optax ``scale_by_adam`` then ``-lr`` and ``apply_updates``, in place,
    on ``params[k]`` for k in ``names`` with the moments and step count of
    ``opt`` (``{"count", "mu", "nu"}``): mu = (1 - b1) g + b1 mu, nu =
    (1 - b2) g^2 + b2 nu, both bias-corrected by 1 - b^count (float32),
    u = mu_hat / (sqrt(nu_hat) + eps), p += -lr u. A moment ``opt`` holds
    for a parameter not in ``names`` (a frozen one) takes the step of a
    zero gradient, as the JAX trainer's masked step gives it: mu = b1 mu,
    nu = b2 nu, and its parameter does not move."""
    opt["count"] += 1
    t = np.float32(opt["count"])
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** t)
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** t)
    mu = [opt["mu"][k] for k in names]
    nu = [opt["nu"][k] for k in names]
    params = [params[k] for k in names]
    with torch.no_grad():
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - ADAM_B2)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, sq)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        held = set(names)
        for m, beta in (("mu", ADAM_B1), ("nu", ADAM_B2)):
            frozen = [v for k, v in opt[m].items() if k not in held]
            if frozen:
                torch._foreach_mul_(frozen, beta)


class SupervisedSRTrainer:
    """MSE (or MAE) regression trainer with PSNR/SSIM metrics
    (SRCNN/EDSR semantics)."""

    metric_keys = ("loss", "psnr", "ssim")
    trainable_predicate = None      # every parameter trains

    def __init__(self, model, learning_rate=1e-4, clipnorm=None, mesh=None,
                 loss: str = "mse", remat: bool = False,
                 compute_dtype="float32", device=None):
        check_mesh(mesh)
        if loss not in ("mse", "mae"):
            raise ValueError(f"Unsupported loss {loss!r}: 'mse' or 'mae'")
        self.model = model
        self.mesh = mesh
        self.base_lr = learning_rate
        self.clipnorm = clipnorm
        self.loss_name = loss
        self.remat = remat
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.device = resolve_device(device)

    # ---- functional pieces -------------------------------------------------
    def _trainable(self, name: str) -> bool:
        pred = self.trainable_predicate
        return pred is None or bool(pred(flax_path(name)))

    def init_state(self, sample_x=None, rng=None) -> TrainState:
        """A fresh state: the model's own weights (``sample_x`` is not needed,
        the port's models know their shapes; a model built from
        ``PRNGKey(42)`` holds what the JAX trainer's default ``init_state``
        draws), or, with ``rng`` a PRNG key (or an int seed), flax's
        ``init`` from it, drawn anew on the trainer's device. Frozen parameters
        (``trainable_predicate``) need no gradient and have no moments."""
        model = self.model
        if rng is not None:
            model = type(model)(**model.init_args, device=self.device,
                                key=rng)
        params = {k: v.detach().to(self.device, torch.float32, copy=True)
                  .requires_grad_(self._trainable(k))
                  for k, v in model.named_parameters()}
        train = [k for k, v in params.items() if v.requires_grad]
        opt = {"count": 0,
               "mu": {k: torch.zeros_like(params[k]) for k in train},
               "nu": {k: torch.zeros_like(params[k]) for k in train}}
        state = TrainState(params=params, opt_state=opt, lr=_f32(self.base_lr))
        if self.mesh is not None:
            replicate(self.mesh, state)
        return state

    def _apply(self, params: dict, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """The model on ``params`` and ``x`` cast to the compute dtype; its
        output cast to float32. Shards of a 'model' axis run as
        ``dist.tp_modules`` says."""
        dt = self.compute_dtype
        cast = {k: cast_in(v, dt) for k, v in params.items()}

        def run():
            return functional_call(self.model, cast, (cast_in(x, dt),),
                                   kwargs).float()
        if not has_axis(self.mesh, "model"):
            return run()
        with tp_modules(self.model, params, self.mesh):
            return run()

    def _shard(self, n: int):
        """This rank's rows of a global batch of ``n`` (None without a
        'data' axis)."""
        if not has_axis(self.mesh, "data"):
            return None
        return batch_shard(self.mesh, n, "data")

    def _loss(self, params, x, y, w, step, denom=None, rows=None):
        """(loss, prediction) of a weighted batch: the weighted mean over
        ``denom`` (default sum(w)); ``rows`` (lo, n) places a rank's rows
        in the global batch."""
        pred = remat_call(lambda: self._apply(params, x), self.remat)
        d = pred - y
        per = (d * d) if self.loss_name == "mse" else d.abs()
        return _wmean(per.mean(dim=tuple(range(1, per.dim()))), w, denom), pred

    def _metrics(self, loss, pred, y, w, denom) -> dict:
        with torch.no_grad():
            pred = pred.detach()
            return {"loss": loss.detach(),
                    "psnr": _wmean(psnr_fn(y, pred), w, denom),
                    "ssim": _wmean(ssim_fn(y, pred), w, denom)}

    def _step(self, state: TrainState, x, y, w, step, grad: bool):
        """Loss, metrics and (with ``grad``) the trainable parameters'
        gradients of a global batch: this rank's rows, the sums
        all-reduced over 'data'."""
        denom = torch.sum(w)
        shard = self._shard(x.shape[0])
        rows = None
        if shard is not None:
            x, y, w = shard.take(x), shard.take(y), shard.take(w)
            rows = (shard.lo, shard.n)
        names = [k for k, v in state.params.items() if v.requires_grad]
        grads = []
        with torch.set_grad_enabled(grad):
            loss, pred = self._loss(state.params, x, y, w, step, denom, rows)
            if grad:
                grads = list(torch.autograd.grad(
                    loss, [state.params[k] for k in names]))
        metrics = self._metrics(loss, pred, y, w, denom)
        if shard is not None:
            keys = list(metrics)
            sums = all_reduce_flat([metrics[k] for k in keys] + grads,
                                   shard.group)
            metrics = dict(zip(keys, sums[:len(keys)]))
            grads = sums[len(keys):]
        if grad and self.clipnorm is not None:
            sharded = None
            if has_axis(self.mesh, "model"):
                shards = sharded_names(self.model, state.params)
                sharded = [k in shards for k in names]
            grads = clip_by_global_norm(
                grads, self.clipnorm, sharded,
                self.mesh.get_group("model") if sharded else None)
        metrics["n"] = denom
        return metrics, dict(zip(names, grads)), pred

    def value_and_grad(self, state: TrainState, x, y, w=None, step: int = 0):
        """(loss, prediction, {name: gradient}) of one global batch, for
        the trainable parameters (clipped when ``clipnorm`` is set); under a
        mesh the prediction is this rank's rows."""
        if w is None:
            w = self._ones_weights(x.shape[0])
        metrics, grads, pred = self._step(state, x, y, w, step, True)
        return metrics["loss"], pred, grads

    def _train_step_w(self, state: TrainState, x, y, w, step: int = 0):
        metrics, grads, _ = self._step(state, x, y, w, step, True)
        adam_update(state.opt_state, state.params, list(grads),
                    list(grads.values()), state.lr)
        return state, metrics

    def _eval_step_w(self, state: TrainState, x, y, w) -> dict:
        return self._step(state, x, y, w, None, False)[0]

    # unweighted public steps (tests / direct users)
    def train_step(self, state, x, y):
        return self._train_step_w(state, x, y, self._ones_weights(x.shape[0]))

    def eval_step(self, state, x, y):
        return self._eval_step_w(state, x, y, self._ones_weights(x.shape[0]))

    def _ones_weights(self, n):
        return torch.ones((n,), dtype=torch.float32, device=self.device)

    # ---- keras-like lifecycle ----------------------------------------------
    def _batches(self, x, y, batch_size, rng, shuffle=True):
        """Yield (xb, yb, wb) on the trainer's device with a STATIC batch
        shape: the trailing partial batch is padded by repeating its first
        row and masked out via wb (Keras trains on the trailing batch)."""
        n = x.shape[0]
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n, batch_size):
            sel = idx[s: s + batch_size]
            nb = sel.shape[0]
            if nb < batch_size:
                sel = np.concatenate([sel, np.repeat(sel[:1], batch_size - nb)])
            wb = torch.as_tensor((np.arange(batch_size) < nb).astype(np.float32))
            yield (_take(x, sel, self.device), _take(y, sel, self.device),
                   wb.to(self.device))

    @staticmethod
    def _epoch_mean(vals, ns):
        """Aggregate per-batch means weighted by real (unmasked) row counts."""
        v = torch.stack(vals).double().cpu().numpy()
        n = torch.stack(ns).double().cpu().numpy()
        return float((v * n).sum() / n.sum())

    def fit(self, x_train, y_train, x_val, y_val, batch_size=16, epochs=50,
            es_patience=3, plateau_patience=2, plateau_factor=0.5, min_lr=1e-7,
            seed=42, verbose=True, state: TrainState | None = None,
            metrics_logger=None, prefetch: int = 2,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            checkpoint_offset: int = 0) -> FitResult:
        # continue from loaded/previous weights when given (Keras fit semantics)
        state = state if state is not None else self.init_state(x_train[:1])

        def fmt(epoch, train_m, val_m, st):
            return (f"epoch {epoch + 1}/{epochs} loss={train_m['loss']:.5f} "
                    f"psnr={train_m['psnr']:.2f} val_loss={val_m['loss']:.5f} "
                    f"val_psnr={val_m['psnr']:.2f} lr={st.lr:.2e}")

        return self._fit_loop(
            x_train, y_train, x_val, y_val, batch_size, epochs, es_patience,
            plateau_patience, plateau_factor, min_lr, seed, verbose, state,
            metrics_logger, prefetch, checkpoint_dir, checkpoint_every,
            checkpoint_offset, train_fn=self._train_step_w, fmt_line=fmt)

    def _fit_loop(self, x_train, y_train, x_val, y_val, batch_size, epochs,
                  es_patience, plateau_patience, plateau_factor, min_lr, seed,
                  verbose, state, metrics_logger, prefetch, checkpoint_dir,
                  checkpoint_every, checkpoint_offset, train_fn,
                  fmt_line) -> FitResult:
        """The Keras-parity epoch loop shared by both trainers: train batches
        (prefetched), validation, trackers, history/logging, periodic async
        checkpoints, ReduceLROnPlateau, EarlyStopping with best-weight
        restore. ``train_fn(state, xb, yb, wb) -> (state, metrics)``."""
        metric_keys = self.metric_keys
        ckpt_handle = None  # most recent async periodic save
        rng = np.random.default_rng(seed)
        early = EarlyStopping(patience=es_patience)
        plateau = ReduceLROnPlateau(plateau_factor, plateau_patience, min_lr)
        tt, mt = EpochTimeTracker(self.device), EpochMemoryTracker(self.device)
        history: dict[str, list] = {k: [] for k in (
            *metric_keys, *(f"val_{k}" for k in metric_keys), "lr",
            "epoch_time_sec")}

        for epoch in range(epochs):
            tt.begin_epoch()
            mt.begin_epoch()
            agg = {k: [] for k in metric_keys}
            ns = []
            for xb, yb, wb in prefetch_iterator(
                    self._batches(x_train, y_train, batch_size, rng), prefetch):
                state, m = train_fn(state, xb, yb, wb)
                for k in agg:
                    agg[k].append(m[k])
                ns.append(m["n"])
            train_m = {k: self._epoch_mean(v, ns) for k, v in agg.items()}

            vagg = {k: [] for k in metric_keys}
            vns = []
            for xb, yb, wb in self._batches(x_val, y_val, batch_size, rng,
                                            shuffle=False):
                m = self._eval_step_w(state, xb, yb, wb)
                for k in vagg:
                    vagg[k].append(m[k])
                vns.append(m["n"])
            val_m = {k: self._epoch_mean(v, vns) for k, v in vagg.items()}

            tt.end_epoch()
            mt.end_epoch()
            for k, v in train_m.items():
                history[k].append(v)
            for k, v in val_m.items():
                history[f"val_{k}"].append(v)
            history["lr"].append(state.lr)
            history["epoch_time_sec"].append(tt.epoch_times_sec[-1])
            if metrics_logger is not None and is_writer():
                metrics_logger.log_epoch(epoch, {
                    **train_m, **{f"val_{k}": v for k, v in val_m.items()},
                    "lr": state.lr, "epoch_time_sec": tt.epoch_times_sec[-1]})
            if verbose and is_writer():
                print(fmt_line(epoch, train_m, val_m, state))

            if (checkpoint_dir is not None and checkpoint_every > 0
                    and (epoch + 1) % checkpoint_every == 0):
                # periodic resume point (the whole TrainState); the write
                # overlaps the next epoch. One save in flight at a time, and
                # an earlier save's failure surfaces here. checkpoint_offset
                # keeps epoch numbering monotonic across resumed runs.
                if ckpt_handle is not None:
                    ckpt_handle.wait()
                ep = checkpoint_offset + epoch + 1
                whole = state
                if has_axis(self.mesh, "model"):    # the shards, gathered
                    whole = gather_params_tp(self.mesh, state, self.model)
                ckpt_handle = save_checkpoint_async(
                    checkpoint_dir, f"epoch_{ep:04d}", whole,
                    metadata={"epoch": ep, "val_loss": val_m["loss"]})
            state.lr = _f32(plateau.update(val_m["loss"], state.lr))
            if early.update(val_m["loss"], state.params):
                break

        if ckpt_handle is not None:
            ckpt_handle.wait()
        if early.best_state is not None:  # restore_best_weights, in place
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(early.best_state[k])
        return FitResult(history, tt, mt, state)

    def evaluate(self, state: TrainState, x_test, y_test, batch_size=16):
        agg = {k: [] for k in self.metric_keys}
        ns = []
        for xb, yb, wb in self._batches(x_test, y_test, batch_size,
                                        np.random.default_rng(0), shuffle=False):
            m = self._eval_step_w(state, xb, yb, wb)
            for k in agg:
                agg[k].append(m[k])
            ns.append(m["n"])
        return {k: self._epoch_mean(v, ns) for k, v in agg.items()}


class ClassifierTrainer(SupervisedSRTrainer):
    """Sparse-categorical-crossentropy + accuracy (VGG16_model.py semantics).

    ``trainable_predicate(path)`` decides which parameters train; it is
    called on the flax path tuple (``("vgg16", "block5_conv3", "kernel")``,
    ``tpusr_torch.bridge.flax_path``), so one predicate serves both packages.
    A frozen parameter gets no gradient and no update: the JAX step's masked
    gradients and updates. Dropout draws from ``fold_in(PRNGKey(dropout_seed),
    step)`` and augmentation from ``fold_in(PRNGKey(dropout_seed + 1),
    step)``, as the JAX trainer does.
    """

    metric_keys = ("loss", "accuracy")

    def __init__(self, model, learning_rate=1e-3, mesh=None,
                 trainable_predicate: Callable[[tuple], bool] | None = None,
                 dropout_seed: int = 0, l2_reg: float = 0.0,
                 compute_dtype="float32", device=None):
        self.trainable_predicate = trainable_predicate
        self.dropout_seed = dropout_seed
        self.l2_reg = float(l2_reg)
        super().__init__(model, learning_rate=learning_rate, mesh=mesh,
                         compute_dtype=compute_dtype, device=device)

    def _loss(self, params, x, y, w, step, denom=None, rows=None):
        """(cross-entropy on log(clip(probs, 1e-7, 1)) + the Keras L2 penalty
        on the Dense-256 kernel, probs); ``step`` None is the eval forward
        (no dropout). A rank's rows (``rows``) keep their rows of the
        global batch's dropout masks, and the penalty is added on the first
        'data' rank only, so the all-reduced sums count it once."""
        if step is None:
            probs = self._apply(params, x)
        else:
            key = prng.fold_in(prng.PRNGKey(self.dropout_seed), step)
            probs = self._apply(params, x, train=True, dropout_rng=key,
                                rows=rows)
        # minimum/maximum, not clamp: softmax saturates to exactly 1.0 in
        # fp32, where jnp.clip's gradient is 0.5 and clamp's 1
        clipped = torch.minimum(torch.maximum(probs, probs.new_tensor(1e-7)),
                                probs.new_ones(()))
        ce = -torch.log(clipped).gather(1, y.long()[:, None])[:, 0]
        loss = _wmean(ce, w, denom)
        first = rows is None or axis_index(self.mesh, "data") == 0
        if self.l2_reg > 0 and first:
            kernel = params["fc1.weight"]
            if has_axis(self.mesh, "model"):
                kernel = full_param(params, "fc1.weight", self.model,
                                    self.mesh)
            loss = loss + self.l2_reg * torch.sum(kernel ** 2)
        return loss, probs

    def _metrics(self, loss, probs, y, w, denom) -> dict:
        with torch.no_grad():
            acc = _wmean((probs.argmax(-1) == y.long()).float(), w, denom)
            return {"loss": loss.detach(), "accuracy": acc}

    def _train_step_w(self, state, x, y, w, step: int = 0,
                      augment: bool = False):
        if augment:
            x = random_augment_batch(prng.fold_in(
                prng.PRNGKey(self.dropout_seed + 1), step), x)
        return super()._train_step_w(state, x, y, w, step)

    def train_step(self, state, x, y, step):
        return self._train_step_w(state, x, y, self._ones_weights(x.shape[0]),
                                  int(step), False)

    def fit(self, x_train, y_train, x_val, y_val, batch_size=32, epochs=50,
            es_patience=3, plateau_patience=2, plateau_factor=0.5, min_lr=1e-7,
            seed=42, verbose=True, augment=False,
            state: TrainState | None = None, metrics_logger=None,
            prefetch: int = 2, checkpoint_dir: str | None = None,
            checkpoint_every: int = 0,
            checkpoint_offset: int = 0) -> FitResult:
        state = state if state is not None else self.init_state(x_train[:1])
        step = 0  # global step feeds the dropout/augmentation keys

        def train_fn(st, xb, yb, wb):
            nonlocal step
            st, m = self._train_step_w(st, xb, yb, wb, step, augment)
            step += 1
            return st, m

        def fmt(epoch, train_m, val_m, st):
            return (f"epoch {epoch + 1}/{epochs} loss={train_m['loss']:.4f} "
                    f"acc={train_m['accuracy']:.4f} "
                    f"val_acc={val_m['accuracy']:.4f}")

        return self._fit_loop(
            x_train, y_train, x_val, y_val, batch_size, epochs, es_patience,
            plateau_patience, plateau_factor, min_lr, seed, verbose, state,
            metrics_logger, prefetch, checkpoint_dir, checkpoint_every,
            checkpoint_offset, train_fn=train_fn, fmt_line=fmt)

    def evaluate(self, state: TrainState, x_test, y_test, batch_size=32):
        return super().evaluate(state, x_test, y_test, batch_size)
