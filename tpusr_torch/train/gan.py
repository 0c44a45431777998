"""ESRGAN adversarial trainer (port of ``tpusr/train/gan.py``): one
discriminator update and one generator update per step.

Loss parity (ESRGAN_model.py:401-533), as the JAX trainer has it:
- D: BCE(real -> 1) + BCE(fake -> 0) on sigmoid outputs (keras' clip 1e-7).
- G: BCE(fake -> 1) + 1.0 * the VGG19 ``block5_conv4`` perceptual MSE (on
  denormalised, caffe-preprocessed images) + 100.0 * pixel L1 + 1.0 *
  spectral L1 of FFT2 magnitudes over the trailing (W, C) axes of NHWC (the
  reference's ``tf.signal.fft2d`` quirk, preserved).
- Adam (b1 0.9, b2 0.999) with exponential staircase decay: G 1e-4, D 1e-5,
  x0.5 every 10k steps; step ``t`` uses the rate at ``t`` (optax reads its
  schedule at the count before the update).

The step, in JAX's order: the D loss with ``update_stats=True`` on the real
batch, so every spectral-norm ``u`` takes one power-iteration step, and the
fake batch through D on the new ``u``; D's gradients and its Adam update;
then the G loss through the updated D and the new ``u`` (no further power
step, and no gradient into D); G's gradients and its Adam update; PSNR and
SSIM of the step on ``(x + 1) / 2``. The generator's 3x3 convs run on K2 in
both directions (``edsr.conv3x3``); the discriminator and the frozen VGG19
extractor run on cuDNN.

As in ``trainer.py``, the modules are templates run by
``torch.func.functional_call`` on a ``GANState``'s tensors, and a step
updates that state in place and returns it. ``compute_dtype="bfloat16"`` runs
the generator (K2-bf16) and the VGG19 extractor in bf16; master parameters,
Adam's moments, every loss term, the metrics and the discriminator with its
power iteration stay float32. ``remat=True`` runs the generator's forward
under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of it in the G
loss).

``mesh`` (a ``DeviceMesh`` with a 'data' axis): every rank is called with
the same global batch and takes its rows; each loss term is a mean over the
batch, so a rank's term over its rows, divided by the 'data' size, sums over
the ranks to the global mean. The D and G gradients, the losses and the
metrics are all-reduced over 'data'. The spectral-norm ``u`` vectors take
their power step from the weights alone, so they stay equal on every rank.
A validation batch that the 'data' size does not divide (the partial tail)
runs replicated, as in JAX. Only rank 0 writes checkpoints, the preview PNGs
and the epoch lines.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch.func import functional_call

from tpusr_torch.core import prng
from tpusr_torch.data.prefetch import prefetch_iterator
from tpusr_torch.device import resolve_device
from tpusr_torch.dist.mesh import (all_reduce_flat, axis_size, batch_shard,
                                   check_mesh, has_axis, is_writer, replicate)
from tpusr_torch.metrics.image import psnr as psnr_fn, ssim as ssim_fn
from tpusr_torch.models.vgg import preprocess_caffe
from tpusr_torch.pipeline.png import encode_png_u8
from tpusr_torch.train.callbacks import EpochMemoryTracker, EpochTimeTracker
from tpusr_torch.train.checkpoint import save_checkpoint_async
from tpusr_torch.train.trainer import (_f32, _take, adam_update, cast_in,
                                       compute_dtype_of, remat_call)

_EPS = 1e-7  # keras binary_crossentropy prob clipping


def _bce(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    # minimum/maximum as jnp.clip: the gradient at a bound is JAX's
    p = torch.minimum(torch.maximum(y_pred, y_pred.new_tensor(_EPS)),
                      y_pred.new_tensor(1.0 - _EPS))
    return torch.mean(-(y_true * torch.log(p)
                        + (1.0 - y_true) * torch.log(1.0 - p)))


def pixel_l1(hr_real: torch.Tensor, hr_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(hr_real - hr_fake))


def spectral_l1(hr_real: torch.Tensor, hr_fake: torch.Tensor) -> torch.Tensor:
    """L1 of FFT2 magnitudes over the trailing two axes, (W, C) of an NHWC
    batch: the reference's tf.signal.fft2d innermost-axes behaviour
    (ESRGAN_model.py:461-473), not (H, W)."""
    real_mag = torch.abs(torch.fft.fft2(hr_real.to(torch.complex64),
                                        dim=(-2, -1)))
    fake_mag = torch.abs(torch.fft.fft2(hr_fake.to(torch.complex64),
                                        dim=(-2, -1)))
    return torch.mean(torch.abs(real_mag - fake_mag))


def staircase_lr(init_value: float, decay_steps: int, decay_rate: float,
                 count: int) -> float:
    """``optax.exponential_decay(init_value, decay_steps, decay_rate,
    staircase=True)`` at ``count``, in float32 as optax computes it:
    ``init * rate ** floor(count / decay_steps)``."""
    if decay_steps <= 0 or decay_rate == 0 or count <= 0:
        return _f32(init_value)
    p = np.floor(np.float32(count) / np.float32(decay_steps))
    return float(np.float32(init_value)
                 * np.power(np.float32(decay_rate), np.float32(p)))


@dataclasses.dataclass
class GANState:
    """``g_params``/``d_params``: the generator's and discriminator's
    parameters by the modules' names (float32); ``d_spectral``: each
    spectral-norm layer's ``u`` by buffer name; ``g_opt``/``d_opt``: Adam's
    ``{"count", "mu", "nu"}``; ``step``: the steps taken."""
    g_params: dict
    d_params: dict
    d_spectral: dict
    g_opt: dict
    d_opt: dict
    step: int


@dataclasses.dataclass
class GANFitResult:
    epoch_losses: dict
    time_tracker: EpochTimeTracker
    memory_tracker: EpochMemoryTracker
    state: GANState


def _adam_state(params: dict) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


class ESRGANTrainer:
    """The JAX trainer's names, arguments and defaults, plus ``device``
    (CUDA unless ``device="cpu"``). ``vgg_params`` (name -> tensor, the
    extractor's parameter names) defaults to ``vgg_features``' own weights;
    they stay frozen."""

    def __init__(self, generator, discriminator, vgg_features,
                 vgg_params: dict | None = None, g_lr=1e-4, d_lr=1e-5,
                 decay_steps=10000, decay_rate=0.5, adv_weight=1.0,
                 perc_weight=1.0, pixel_weight=100.0, spec_weight=1.0,
                 mesh=None, remat: bool = False, compute_dtype="float32",
                 device=None):
        check_mesh(mesh)
        self.mesh = mesh
        self.generator = generator
        self.discriminator = discriminator
        self.vgg_features = vgg_features
        self.device = resolve_device(device)
        self.remat = remat
        self.compute_dtype = compute_dtype_of(compute_dtype)
        if vgg_params is None:
            vgg_params = dict(vgg_features.named_parameters())
        self.vgg_params = vgg_params
        # frozen, so cast to the compute dtype once
        self._vgg_in = {k: cast_in(v.detach().to(self.device),
                                   self.compute_dtype)
                        for k, v in vgg_params.items()}
        self.weights = (adv_weight, perc_weight, pixel_weight, spec_weight)
        self.g_sched = lambda count: staircase_lr(g_lr, decay_steps,
                                                  decay_rate, count)
        self.d_sched = lambda count: staircase_lr(d_lr, decay_steps,
                                                  decay_rate, count)

    # ---- state -------------------------------------------------------------
    def init_state(self, lr_shape=None, hr_shape=None, rng=None) -> GANState:
        """A fresh state: the modules' own weights (the shapes are not
        needed, the port's modules know theirs; modules built from the two
        keys of ``split(PRNGKey(42))`` hold what the JAX trainer's default
        draws), or, with ``rng`` a PRNG key (or an int seed), a generator
        and a discriminator drawn anew on the trainer's device from
        ``split(rng)``'s two keys, as flax's ``init`` draws them."""
        gen, disc = self.generator, self.discriminator
        if rng is not None:
            rg, rd = prng.split(rng)
            gen = type(gen)(**gen.init_args,
                            attention_block_size=gen.attention_block_size,
                            device=self.device, key=rg)
            disc = type(disc)(**disc.init_args, device=self.device, key=rd)

        def leaves(named):
            return {k: v.detach().to(self.device, torch.float32, copy=True)
                    .requires_grad_() for k, v in named}
        g_params = leaves(gen.named_parameters())
        d_params = leaves(disc.named_parameters())
        d_spectral = {k: b.detach().to(self.device, torch.float32, copy=True)
                      for k, b in disc.named_buffers()}
        state = GANState(g_params=g_params, d_params=d_params,
                         d_spectral=d_spectral, g_opt=_adam_state(g_params),
                         d_opt=_adam_state(d_params), step=0)
        if self.mesh is not None:
            replicate(self.mesh, state)
        return state

    # ---- the networks ------------------------------------------------------
    def _generate(self, g_params: dict, lr: torch.Tensor) -> torch.Tensor:
        """The generator on ``g_params`` and ``lr`` in the compute dtype,
        its output in float32; under ``torch.utils.checkpoint`` with
        ``remat``."""
        dt = self.compute_dtype

        def fwd():
            params = {k: cast_in(v, dt) for k, v in g_params.items()}
            return functional_call(self.generator, params,
                                   (cast_in(lr, dt),)).float()
        return remat_call(fwd, self.remat)

    def _disc(self, d_params: dict, d_spectral: dict, x: torch.Tensor,
              update_stats: bool = False) -> torch.Tensor:
        """The discriminator in float32; with ``update_stats`` each ``u``
        of ``d_spectral`` takes one power-iteration step, in place."""
        return functional_call(self.discriminator, {**d_params, **d_spectral},
                               (x,), {"update_stats": update_stats})

    def _perceptual(self, hr_real: torch.Tensor,
                    hr_fake: torch.Tensor) -> torch.Tensor:
        """VGG19 feature MSE on denormalised inputs (ESRGAN_model.py:
        401-431)."""
        def feats(x):
            x255 = (x + 1.0) * 127.5
            return functional_call(
                self.vgg_features, self._vgg_in,
                (cast_in(preprocess_caffe(x255), self.compute_dtype),)).float()
        fr = feats(hr_real)
        ff = feats(hr_fake)
        return torch.mean((fr - ff) ** 2)

    def _g_terms(self, fake, d_params, d_spectral, hr):
        """The four generator loss terms of ``fake`` and their weighted
        sum."""
        d_fake = self._disc(d_params, d_spectral, fake)
        adv = _bce(torch.ones_like(d_fake), d_fake)
        perc = self._perceptual(hr, fake)
        pix = pixel_l1(hr, fake)
        spec = spectral_l1(hr, fake)
        wa, wp, wx, ws = self.weights
        total = wa * adv + wp * perc + wx * pix + ws * spec
        return total, {"adv": adv, "perc": perc, "pixel": pix, "spec": spec,
                       "fake": fake}

    def g_loss_components(self, g_params, d_params, d_spectral, lr, hr):
        """All four generator loss terms (shared by the train, val and eval
        paths): (total, {"adv", "perc", "pixel", "spec", "fake"})."""
        return self._g_terms(self._generate(g_params, lr), d_params,
                             d_spectral, hr)

    def d_loss(self, d_params, d_spectral, fake, hr):
        """The D loss: BCE(real -> 1) with ``update_stats=True``, so every
        ``u`` of ``d_spectral`` takes one power-iteration step in place, then
        BCE(fake -> 0) through D on the new ``u``."""
        d_real = self._disc(d_params, d_spectral, hr, True)
        d_fake = self._disc(d_params, d_spectral, fake)
        return (_bce(torch.ones_like(d_real), d_real)
                + _bce(torch.zeros_like(d_fake), d_fake))

    @staticmethod
    def _image_metrics(hr: torch.Tensor, fake: torch.Tensor) -> dict:
        hr01, fake01 = (hr + 1.0) / 2.0, (fake.detach() + 1.0) / 2.0
        return {"psnr": torch.mean(psnr_fn(hr01, fake01)),
                "ssim": torch.mean(ssim_fn(hr01, fake01))}

    # ---- steps -------------------------------------------------------------
    def _shard(self, n: int, divisible_only: bool = False):
        """This rank's rows of a global batch of ``n`` (None without a
        'data' axis, or, with ``divisible_only``, when the axis does not
        divide ``n``: such a batch runs replicated)."""
        if not has_axis(self.mesh, "data"):
            return None
        if divisible_only and n % axis_size(self.mesh, "data"):
            return None
        return batch_shard(self.mesh, n, "data")

    @staticmethod
    def _reduce(shard, scalars: dict, grads: list = ()):
        """``scalars`` (each a rank's mean over its rows) and ``grads``
        summed over the 'data' ranks, the means divided by their count
        first; as they are without a shard."""
        if shard is None:
            return scalars, list(grads)
        keys = list(scalars)
        out = all_reduce_flat([scalars[k] / shard.size for k in keys]
                              + list(grads), shard.group)
        return dict(zip(keys, out[:len(keys)])), out[len(keys):]

    def train_step(self, state: GANState, lr: torch.Tensor,
                   hr: torch.Tensor):
        """One D update and one G update on a global batch in [-1, 1];
        returns the state (updated in place) and the step's metrics on the
        device."""
        lr, hr = lr.to(self.device), hr.to(self.device)
        shard = self._shard(lr.shape[0])
        if shard is not None:
            lr, hr = shard.take(lr), shard.take(hr)
        scale = 1.0 if shard is None else 1.0 / shard.size
        d_names, g_names = list(state.d_params), list(state.g_params)
        with torch.enable_grad():
            # JAX computes the generator's output twice, in the D loss and
            # in the G loss, from the same parameters and input; here it
            # runs once and the D loss takes it detached
            fake = self._generate(state.g_params, lr)
            d_loss = self.d_loss(state.d_params, state.d_spectral,
                                 fake.detach(), hr)
            d_grads = torch.autograd.grad(
                d_loss if shard is None else d_loss * scale,
                [state.d_params[k] for k in d_names])
        d_m, d_grads = self._reduce(shard, {"d_loss": d_loss.detach()},
                                    d_grads)
        adam_update(state.d_opt, state.d_params, d_names, d_grads,
                    self.d_sched(state.d_opt["count"]))
        # the G loss through the updated D, which takes no gradient here
        d_now = {k: v.detach() for k, v in state.d_params.items()}
        with torch.enable_grad():
            g_loss, _aux = self._g_terms(fake, d_now, state.d_spectral, hr)
            g_grads = torch.autograd.grad(
                g_loss if shard is None else g_loss * scale,
                [state.g_params[k] for k in g_names])
        with torch.no_grad():
            metrics = {"g_loss": g_loss.detach(),
                       **self._image_metrics(hr, fake)}
        metrics, g_grads = self._reduce(shard, metrics, g_grads)
        adam_update(state.g_opt, state.g_params, g_names, g_grads,
                    self.g_sched(state.g_opt["count"]))
        state.step += 1
        return state, {"g_loss": metrics["g_loss"], "d_loss": d_m["d_loss"],
                       "psnr": metrics["psnr"], "ssim": metrics["ssim"]}

    def val_step(self, state: GANState, lr: torch.Tensor,
                 hr: torch.Tensor) -> dict:
        """The G loss, PSNR and SSIM of a global batch; sharded over 'data'
        when the axis divides it, else replicated."""
        with torch.no_grad():
            lr, hr = lr.to(self.device), hr.to(self.device)
            shard = self._shard(lr.shape[0], divisible_only=True)
            if shard is not None:
                lr, hr = shard.take(lr), shard.take(hr)
            g_loss, aux = self.g_loss_components(
                state.g_params, state.d_params, state.d_spectral, lr, hr)
            return self._reduce(shard, {
                "g_loss": g_loss, **self._image_metrics(hr, aux["fake"])})[0]

    def _val_batches(self, x, y, batch_size, normalize):
        """Yield (n_real, xb, yb) including the partial tail (the
        reference's tf.data ``.batch`` keeps it, ESRGAN_model.py:782-856)."""
        n = len(x)
        for s in range(0, n, batch_size):
            sel = np.arange(s, min(s + batch_size, n))
            xb, yb = _take(x, sel, self.device), _take(y, sel, self.device)
            if normalize:
                xb, yb = xb * 2.0 - 1.0, yb * 2.0 - 1.0
            yield len(sel), xb, yb

    def _val_metrics(self, state, x, y, batch_size, normalize) -> dict:
        agg = {"g_loss": [], "psnr": [], "ssim": []}
        sizes = []
        for nb, xb, yb in self._val_batches(x, y, batch_size, normalize):
            m = self.val_step(state, xb, yb)
            for k in agg:
                agg[k].append(m[k])
            sizes.append(nb)
        return {k: float(np.average(torch.stack(v).double().cpu().numpy(),
                                    weights=sizes))
                for k, v in agg.items()}

    # ------------------------------------------------------------------ fit
    def fit(self, x_train, y_train, x_val=None, y_val=None, epochs=10,
            batch_size=16, steps_per_epoch=None, normalize=True, save_dir=None,
            seed=42, verbose=True, state=None, prefetch: int = 2,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            checkpoint_offset: int = 0) -> GANFitResult:
        """Train on [0, 1] arrays or tensors (normalised to [-1, 1] like
        ESRGAN_model.py:596-598). Saves a 5x5 SR preview grid per epoch when
        ``save_dir`` is given, and an async resume point of the whole
        ``GANState`` every ``checkpoint_every`` epochs when
        ``checkpoint_dir`` is given."""
        rng = np.random.default_rng(seed)
        ckpt_handle = None
        n = x_train.shape[0]
        if steps_per_epoch is None:
            steps_per_epoch = max(1, n // batch_size)
        if state is None:
            # seed also selects the init weights, not just the batch stream
            state = self.init_state(rng=prng.PRNGKey(seed))

        # Shuffle without replacement, as the reference's tf.data
        # shuffle->batch->repeat stream (ESRGAN_model.py:578-598): one
        # persistent permutation stream, reshuffled when it runs out; the
        # partial tail is dropped on reshuffle (static batch shape).
        perm = rng.permutation(n)
        pos = 0

        def next_batch_idx():
            nonlocal perm, pos
            if batch_size >= n:  # keep the batch shape on tiny datasets
                reps = -(-batch_size // n)
                return np.concatenate(
                    [rng.permutation(n) for _ in range(reps)])[:batch_size]
            if pos + batch_size > n:
                perm, pos = rng.permutation(n), 0
            sel = perm[pos:pos + batch_size]
            pos += batch_size
            return sel

        tt = EpochTimeTracker(self.device)
        mt = EpochMemoryTracker(self.device)
        epoch_losses: dict[str, list] = {}
        preview = (x_train[:25] if x_val is None or len(x_val) == 0
                   else x_val[:25])

        for epoch in range(epochs):
            tt.begin_epoch()
            mt.begin_epoch()
            agg = {"g_loss": [], "d_loss": [], "psnr": [], "ssim": []}

            def epoch_batches():
                for _ in range(steps_per_epoch):
                    sel = next_batch_idx()
                    xb = _take(x_train, sel, self.device)
                    yb = _take(y_train, sel, self.device)
                    if normalize:
                        xb, yb = xb * 2.0 - 1.0, yb * 2.0 - 1.0
                    yield xb, yb

            for xb, yb in prefetch_iterator(epoch_batches(), prefetch):
                state, m = self.train_step(state, xb, yb)
                for k in agg:
                    agg[k].append(m[k])
            train_m = {k: float(np.mean(torch.stack(v).cpu().numpy()))
                       for k, v in agg.items()}

            val_m = {}
            if x_val is not None and len(x_val):
                val_m = {f"val_{k}": v for k, v in self._val_metrics(
                    state, x_val, y_val, batch_size, normalize).items()}

            if save_dir is not None and is_writer():
                self._save_sr_grid(state, preview, save_dir, epoch + 1,
                                   normalize)
            if (checkpoint_dir is not None and checkpoint_every > 0
                    and (epoch + 1) % checkpoint_every == 0):
                # one save in flight at a time, and an earlier save's
                # failure surfaces here; the offset keeps the numbering
                # monotonic across resumed runs
                if ckpt_handle is not None:
                    ckpt_handle.wait()
                ep = checkpoint_offset + epoch + 1
                ckpt_handle = save_checkpoint_async(
                    checkpoint_dir, f"epoch_{ep:04d}", state,
                    metadata={"epoch": ep, "g_loss": train_m["g_loss"]})

            tt.end_epoch()
            mt.end_epoch()
            for k, v in {**train_m, **val_m}.items():
                epoch_losses.setdefault(k, []).append(v)
            epoch_losses.setdefault("g_lr", []).append(self.g_sched(state.step))
            epoch_losses.setdefault("d_lr", []).append(self.d_sched(state.step))
            if verbose and is_writer():
                msg = (f"epoch {epoch + 1}/{epochs} g={train_m['g_loss']:.3f} "
                       f"d={train_m['d_loss']:.3f} psnr={train_m['psnr']:.2f} "
                       f"ssim={train_m['ssim']:.4f}")
                if val_m:
                    msg += f" val_psnr={val_m['val_psnr']:.2f}"
                print(msg)

        if ckpt_handle is not None:
            ckpt_handle.wait()
        return GANFitResult(epoch_losses, tt, mt, state)

    def evaluate(self, state: GANState, x_test, y_test, batch_size=16,
                 normalize=True) -> dict:
        """Average PSNR, SSIM and G loss over the test set, the partial tail
        batch included (ESRGAN_model.py:782-856)."""
        out = self._val_metrics(state, x_test, y_test, batch_size, normalize)
        return {"avg_psnr": out["psnr"], "avg_ssim": out["ssim"],
                "avg_g_loss": out["g_loss"]}

    def _preview(self, g_params: dict, lr: torch.Tensor) -> torch.Tensor:
        """The generator in float32 on ``g_params`` (the preview runs the
        master weights, whatever the compute dtype)."""
        with torch.no_grad():
            return functional_call(self.generator, g_params, (lr,))

    def _save_sr_grid(self, state, preview01, save_dir, epoch_idx, normalize):
        """5x5 generator preview PNG per epoch (ESRGAN_model.py:652-678),
        written by the port's PNG codec."""
        os.makedirs(save_dir, exist_ok=True)
        x = torch.as_tensor(np.asarray(preview01, np.float32)
                            if not isinstance(preview01, torch.Tensor)
                            else preview01).to(self.device, torch.float32)
        lr_in = x * 2.0 - 1.0 if normalize else x
        sr = self._preview(state.g_params, lr_in).cpu().numpy()
        sr = (sr + 1.0) / 2.0
        n = min(25, sr.shape[0])
        rows = cols = 5
        h, w, ch = sr.shape[1:]
        grid = np.zeros((rows * h, cols * w, ch), np.uint8)
        for i in range(n):
            r, c = divmod(i, cols)
            tile = (np.clip(sr[i], 0, 1) * 255.0).round().astype(np.uint8)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile
        path = os.path.join(save_dir, f"epoch_{epoch_idx:03d}_sr_grid.png")
        with open(path, "wb") as f:
            f.write(encode_png_u8(grid))
