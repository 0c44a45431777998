"""Command-line entry points of the port (port of ``tpusr/cli/__main__.py``):
the reference's notebook flows, and the serving tier.

    python -m tpusr_torch.cli classic      --hr-dir HR --lr-dir LR --out results/
    python -m tpusr_torch.cli train-srcnn  --hr-dir HR --lr-dir LR --interp-map m.pkl ...
    python -m tpusr_torch.cli train-edsr   --hr-dir HR --lr-dir LR ...
    python -m tpusr_torch.cli train-esrgan --hr-dir HR --lr-dir LR ...
    python -m tpusr_torch.cli train-vgg16  --hr-dir HR --class-map c.pkl ...
    python -m tpusr_torch.cli pipeline     --lr-dir LRp --hr-dir HRp --class-map c.pkl ...
    python -m tpusr_torch.cli serve        --edsr-ckpt E --vgg16-ckpt V [...]
    python -m tpusr_torch.cli eda          --hr-dir HR --lr-dir LR --out eda/

Every command takes the JAX command's flags and defaults, plus ``--device``
(default ``cuda``): with no card and no ``--device cpu`` a command exits
with a message; it never falls back to the CPU. The flows are the JAX
package's (load -> split(seed 42) -> train -> evaluate -> checkpoint +
metrics JSON), on the port's loaders (``data/loading.py``: PNG and baseline
JPEG), its trainers and facades; checkpoints are the port's own
(``train/checkpoint.py``). ``classic`` and ``pipeline`` write the JSON the
JAX commands write and no figures: the JAX commands draw theirs with
matplotlib, which the port does not use.

``--data-parallel`` on the four ``train-*`` commands trains over a 'data'
mesh of every rank (``tpusr_torch.dist``): one rank alone, or N ranks under
torchrun (``torchrun --nproc-per-node N -m tpusr_torch.cli train-edsr
--data-parallel ...``), one card each; only rank 0 writes the checkpoint
and its logs.

``eda`` runs the dataset EDA (``data/eda.py``) on the card and writes its
CSVs, without the JAX command's figures. ``convert`` moves a model between
the port's checkpoint and the reference's Keras ``.h5`` (the port's own
HDF5 codec, ``train/hdf5.py``), both ways. ``preprocess`` (a video decoder)
is listed with its JAX flags and exits with a message naming what it lacks.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import math
import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GATE_FILE = "GATE_torch.json"    # the port's gate verdict, on the H100
NO_FIGURES = ("figures are not drawn: the JAX command draws them with "
              "matplotlib, which the port does not use")


def _device(args):
    """The command's torch device; exits with a message when it asks for a
    card and none is available."""
    from tpusr_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError:
        raise SystemExit(
            f"tpusr_torch {args.cmd}: --device {args.device} asks for a CUDA "
            f"card and none is available; pass --device cpu to run on the "
            f"CPU (the kernels' plain PyTorch twins)") from None


def _mesh(args, dev):
    """``--data-parallel``: a 'data' mesh over every rank (torchrun's, or
    this process alone), as the JAX command's ``make_mesh()``."""
    if not args.data_parallel:
        return None
    from tpusr_torch.dist import bootstrap, make_mesh

    bootstrap.initialize(device=dev)
    return make_mesh(device=dev)


def _split_indices(n: int, test_size: float, seed: int):
    """(train, test) indices of scikit-learn's ``train_test_split(
    test_size=t, random_state=seed)`` over n rows: its ``ShuffleSplit``
    draws ``RandomState(seed).permutation(n)``, the first ceil(t * n) rows
    are the test set and the rest the train set."""
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def _split(x, y, seed=42, test_size=0.2, val_size=0.1):
    """train/val/test split with the notebooks' seed-42 convention: the two
    ``train_test_split`` calls of the JAX command, without scikit-learn."""
    tr, te = _split_indices(len(x), test_size, seed)
    x_tr, x_te, y_tr, y_te = x[tr], x[te], y[tr], y[te]
    rel = val_size / (1.0 - test_size)
    tr, va = _split_indices(len(x_tr), rel, seed)
    return x_tr[tr], y_tr[tr], x_tr[va], y_tr[va], x_te, y_te


def _timestamp():
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def _save_run(out_dir, name, state, history, eval_metrics, tt, mt, arch=None):
    """The JAX command's files: the checkpoint, its ``.meta.json`` (eval,
    history, epoch times, memory, timestamp), and the per-epoch
    ``.metrics.jsonl`` and ``.csv`` beside it. ``arch``, where given, goes
    into the metadata as the facades' own ``save`` writes it, so the
    facades rebuild the trained architecture from the checkpoint (the JAX
    command writes none, and its ESRGAN checkpoint does not restore into
    the facade's default architecture)."""
    from tpusr_torch.dist.mesh import is_writer
    from tpusr_torch.train import save_checkpoint
    from tpusr_torch.train.logging import MetricsLogger, jsonl_to_csv

    ts = _timestamp()
    if not is_writer():  # under --data-parallel only rank 0 writes
        return os.path.abspath(os.path.join(out_dir, f"{name}_{ts}"))
    meta = {
        "eval": eval_metrics,
        "history": history,
        "epoch_time_sec": tt.epoch_times_sec,
        "memory": mt.as_dict(),
        "timestamp": ts,
    }
    if arch is not None:
        meta["arch"] = arch
    path = save_checkpoint(out_dir, f"{name}_{ts}", state, metadata=meta)
    # observability sidecar: per-epoch JSONL + CSV next to the checkpoint
    jl = os.path.join(out_dir, f"{name}_{ts}.metrics.jsonl")
    epochs = max((len(v) for v in history.values() if isinstance(v, list)),
                 default=0)
    with MetricsLogger(jl, run_name=f"{name}_{ts}") as logger:
        for e in range(epochs):
            rec = {k: v[e] for k, v in history.items()
                   if isinstance(v, list) and len(v) > e}
            logger.log_epoch(e, rec)
        logger.log("eval", epochs, eval_metrics)
    jsonl_to_csv(jl, jl[: -len(".jsonl")] + ".csv", scope="epoch")
    print(f"saved {path}")
    return path


def _maybe_resume(args, trainer, init_state_args):
    """--resume <checkpoint-path>: restore a whole TrainState/GANState
    (parameters AND optimizer state, a true mid-training resume) and hand it
    to fit via state=."""
    path = getattr(args, "resume", None)
    if not path:
        return None
    from tpusr_torch.train import restore_checkpoint

    template = trainer.init_state(*init_state_args)
    state = restore_checkpoint(os.path.dirname(os.path.abspath(path)),
                               os.path.basename(path), template)
    if trainer.mesh is not None:  # --data-parallel: rank 0's copy everywhere
        from tpusr_torch.dist import replicate
        replicate(trainer.mesh, state)
    print(f"resumed from {path}")
    return state


def _ckpt_kwargs(args):
    """--checkpoint-every N: periodic async resume points (epoch_NNNN under
    --out), pairing with --resume for preemption-tolerant runs. When resuming
    from a periodic point, numbering continues from its recorded epoch so a
    restarted run never overwrites newer progress with smaller labels."""
    every = getattr(args, "checkpoint_every", 0)
    if not every:
        return {}
    offset = 0
    resume = getattr(args, "resume", None)
    if resume:
        from tpusr_torch.train.checkpoint import load_metadata
        meta = load_metadata(os.path.dirname(os.path.abspath(resume)),
                             os.path.basename(resume))
        offset = int((meta or {}).get("epoch", 0))
    return {"checkpoint_dir": args.out, "checkpoint_every": every,
            "checkpoint_offset": offset}


def _compute_dtype(args) -> str:
    return "bfloat16" if args.bf16 else "float32"


def cmd_preprocess(args):
    raise SystemExit(
        "tpusr_torch preprocess: not ported — it decodes video frames "
        "(cv2.VideoCapture) and crops them with OpenCV, and the port has no "
        "video decoder; run `python -m tpusr.cli preprocess` to write the "
        "HR/LR PNG pairs and maps the other commands read")


def cmd_classic(args):
    """The classic-SR comparison over the HR/LR pairs (the reference's
    ``super_resolucion_clasica`` notebook): ``classic_summary.json`` and the
    ranking; no figures."""
    from tpusr_torch.classic.harness import (CLASSIC_ALGORITHMS,
                                             run_classic_comparison)
    from tpusr_torch.data.loading import get_all_image_paths, imread_rgb_u8

    dev = _device(args)
    hr_d = {os.path.basename(p): p for p in get_all_image_paths(args.hr_dir)}
    lr_d = {os.path.basename(p): p for p in get_all_image_paths(args.lr_dir)}
    common = sorted(set(hr_d) & set(lr_d))
    common = common[: int(args.fraction * len(common))]  # notebook: 70%
    if args.limit:
        common = common[: args.limit]
    hr_images = [imread_rgb_u8(hr_d[b]) for b in common]
    lr_images = [imread_rgb_u8(lr_d[b]) for b in common]
    print(f"evaluating {len(common)} HR/LR pairs over {len(CLASSIC_ALGORITHMS)} algorithms")

    summary, ranked, _, _ = run_classic_comparison(hr_images, lr_images,
                                                   device=dev)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "classic_summary.json"), "w") as f:
        json.dump({"summary": summary,
                   "ranked": [[a, s] for a, s in ranked]}, f, indent=2,
                  default=float)
    print(f"classic: {NO_FIGURES}")
    for a, s in ranked:
        print(f"{a}: {s:.4f}")


def _load_sr_patches(args, mode, patch, stride, scale):
    from tpusr_torch.data import load_dataset_as_patches

    if mode == "srcnn":
        x, y, hr_h, hr_w = load_dataset_as_patches(
            args.hr_dir, args.lr_dir, mode="srcnn", patch_size=patch,
            stride=stride, interpolation_map_path=args.interp_map)
        return x, y, (hr_h, hr_w)
    x, y = load_dataset_as_patches(args.hr_dir, args.lr_dir, mode="scale",
                                   patch_size=patch, stride=stride,
                                   scale_factor=scale)
    return x, y, None


def cmd_train_srcnn(args):
    from tpusr_torch.config import SRCNNConfig
    from tpusr_torch.models.api import _seeded
    from tpusr_torch.models.srcnn import SRCNN
    from tpusr_torch.train import SupervisedSRTrainer

    dev = _device(args)
    mesh = _mesh(args, dev)
    cfg = SRCNNConfig(batch_size=args.batch_size, epochs=args.epochs,
                      learning_rate=args.lr)
    x, y, hr_hw = _load_sr_patches(args, "srcnn", cfg.patch_size, cfg.stride, 1)
    x_tr, y_tr, x_va, y_va, x_te, y_te = _split(x, y)
    trainer = SupervisedSRTrainer(
        SRCNN(f1=cfg.f1, f2=cfg.f2, device=dev, generator=_seeded()),
        learning_rate=cfg.learning_rate, mesh=mesh,
        compute_dtype=_compute_dtype(args), device=dev)
    res = trainer.fit(x_tr, y_tr, x_va, y_va, batch_size=cfg.batch_size,
                      epochs=cfg.epochs, es_patience=cfg.es_patience,
                      plateau_patience=cfg.plateau_patience,
                      state=_maybe_resume(args, trainer, (x_tr[:1],)),
                      **_ckpt_kwargs(args))
    ev = trainer.evaluate(res.state, x_te, y_te, batch_size=cfg.batch_size)
    print(f"Loss: {ev['loss']:.4f}, PSNR: {ev['psnr']:.2f} dB, SSIM: {ev['ssim']:.4f}")
    meta_eval = {**ev, "hr_h": hr_hw[0], "hr_w": hr_hw[1]}
    return _save_run(args.out, "SRCNN", res.state, res.history, meta_eval,
                     res.time_tracker, res.memory_tracker)


def cmd_train_edsr(args):
    from tpusr_torch.config import EDSRConfig
    from tpusr_torch.models.api import _seeded
    from tpusr_torch.models.edsr import EDSR
    from tpusr_torch.train import SupervisedSRTrainer

    dev = _device(args)
    mesh = _mesh(args, dev)
    # --lr replaces EDSRConfig's 5e-5, as in the JAX command
    cfg = EDSRConfig(batch_size=args.batch_size, epochs=args.epochs,
                     learning_rate=args.lr, scale_factor=args.scale)
    x, y, _ = _load_sr_patches(args, "scale", cfg.patch_size, cfg.stride,
                               cfg.scale_factor)
    x_tr, y_tr, x_va, y_va, x_te, y_te = _split(x, y)
    model = EDSR(scale_factor=cfg.scale_factor,
                 num_res_blocks=cfg.num_res_blocks,
                 num_filters=cfg.num_filters, res_scaling=cfg.res_scaling,
                 device=dev, generator=_seeded())
    trainer = SupervisedSRTrainer(
        model, learning_rate=cfg.learning_rate, clipnorm=cfg.clipnorm,
        mesh=mesh, compute_dtype=_compute_dtype(args), device=dev)
    res = trainer.fit(x_tr, y_tr, x_va, y_va, batch_size=cfg.batch_size,
                      epochs=cfg.epochs, es_patience=cfg.es_patience,
                      plateau_patience=cfg.plateau_patience,
                      state=_maybe_resume(args, trainer, (x_tr[:1],)),
                      **_ckpt_kwargs(args))
    ev = trainer.evaluate(res.state, x_te, y_te, batch_size=cfg.batch_size)
    print(f"Loss: {ev['loss']:.4f}, PSNR: {ev['psnr']:.2f} dB, SSIM: {ev['ssim']:.4f}")
    arch = {"scale_factor": cfg.scale_factor, "channels": 3,
            "num_res_blocks": cfg.num_res_blocks,
            "num_filters": cfg.num_filters, "res_scaling": cfg.res_scaling}
    return _save_run(args.out, f"EDSR_x{cfg.scale_factor}", res.state,
                     res.history, ev, res.time_tracker, res.memory_tracker,
                     arch=arch)


def cmd_train_esrgan(args):
    import torch

    from tpusr_torch.config import ESRGANConfig
    from tpusr_torch.models.api import _seeded
    from tpusr_torch.models.esrgan import ESRGANDiscriminator, ESRGANGenerator
    from tpusr_torch.models.vgg import VGG19Features
    from tpusr_torch.train import ESRGANTrainer

    from tpusr_torch.tools.imagenet_weights import load_backbone_weights

    dev = _device(args)
    mesh = _mesh(args, dev)
    # --lr sets the generator LR; the discriminator keeps the reference's
    # 10:1 G:D ratio (ESRGAN_model.py:176-195: 1e-4 / 1e-5)
    cfg = ESRGANConfig(batch_size=args.batch_size, epochs=args.epochs,
                       scale_factor=args.scale, g_lr=args.lr,
                       d_lr=args.lr * 0.1)
    x, y, _ = _load_sr_patches(args, "scale", cfg.patch_size, cfg.stride,
                               cfg.scale_factor)
    x_tr, y_tr, x_va, y_va, x_te, y_te = _split(x, y)

    g = _seeded()
    gen = ESRGANGenerator(scale_factor=cfg.scale_factor,
                          growth_channels=cfg.growth_channels,
                          num_rrdb_blocks=cfg.num_rrdb_blocks, device=dev,
                          generator=g)
    disc = ESRGANDiscriminator(device=dev, generator=g)
    # the JAX command draws VGG19 from PRNGKey(0)
    vgg = VGG19Features(device=dev, generator=torch.Generator().manual_seed(0))
    if args.vgg19_weights:   # the Keras .h5 release, or its converted .npz
        load_backbone_weights(vgg, args.vgg19_weights, "vgg19")
    trainer = ESRGANTrainer(gen, disc, vgg, g_lr=cfg.g_lr, d_lr=cfg.d_lr,
                            decay_steps=cfg.decay_steps,
                            decay_rate=cfg.decay_rate, mesh=mesh,
                            compute_dtype=_compute_dtype(args), device=dev)
    res = trainer.fit(x_tr, y_tr, x_va, y_va, epochs=cfg.epochs,
                      batch_size=cfg.batch_size, save_dir=args.preview_dir,
                      state=_maybe_resume(
                          args, trainer,
                          (x_tr.shape[1:], y_tr.shape[1:])),
                      **_ckpt_kwargs(args))
    ev = trainer.evaluate(res.state, x_te, y_te, batch_size=cfg.batch_size)
    print(f"PSNR: {ev['avg_psnr']:.2f}, SSIM: {ev['avg_ssim']:.4f}, "
          f"G-loss: {ev['avg_g_loss']:.2f}")
    arch = {"scale_factor": cfg.scale_factor,
            "growth_channels": cfg.growth_channels,
            "num_rrdb_blocks": cfg.num_rrdb_blocks}
    return _save_run(args.out, f"ESRGAN_x{cfg.scale_factor}", res.state,
                     res.epoch_losses, ev, res.time_tracker,
                     res.memory_tracker, arch=arch)


def cmd_train_vgg16(args):
    from tpusr_torch.config import VGG16Config
    from tpusr_torch.data import load_defects_dataset_as_patches
    from tpusr_torch.models.api import _seeded
    from tpusr_torch.models.vgg import VGG16Classifier
    from tpusr_torch.train import ClassifierTrainer

    dev = _device(args)
    mesh = _mesh(args, dev)
    cfg = VGG16Config(batch_size=args.batch_size, epochs=args.epochs,
                      patch_size=args.patch_size, stride=args.stride)
    x, y = load_defects_dataset_as_patches(args.hr_dir,
                                           patch_size=cfg.patch_size,
                                           stride=cfg.stride,
                                           class_map_path=args.class_map)
    x_tr, y_tr, x_va, y_va, x_te, y_te = _split(x, y)
    pred = None
    if not cfg.base_trainable:
        pred = lambda path: path[0] != "vgg16"  # noqa: E731
    trainer = ClassifierTrainer(
        VGG16Classifier(num_classes=cfg.num_classes,
                        dropout_rate=cfg.dropout_rate,
                        dense_units=cfg.dense_units, device=dev,
                        generator=_seeded()),
        learning_rate=cfg.learning_rate, mesh=mesh, trainable_predicate=pred,
        compute_dtype=_compute_dtype(args), device=dev)
    res = trainer.fit(x_tr, y_tr, x_va, y_va, batch_size=cfg.batch_size,
                      epochs=cfg.epochs,
                      state=_maybe_resume(args, trainer, (x_tr[:1],)),
                      **_ckpt_kwargs(args))
    ev = trainer.evaluate(res.state, x_te, y_te, batch_size=cfg.batch_size)
    print(f"Loss: {ev['loss']:.4f}, Accuracy: {ev['accuracy']:.4f}")
    arch = {"input_shape": [cfg.patch_size, cfg.patch_size, 3],
            "num_classes": cfg.num_classes, "dropout_rate": cfg.dropout_rate}
    return _save_run(args.out, "VGG16", res.state, res.history, ev,
                     res.time_tracker, res.memory_tracker, arch=arch)


def _ckpt_sidecar_metrics(ckpt_path):
    """train/val/eval metric dict from a _save_run checkpoint sidecar, in the
    plot_sr_metrics/time/memory key schema."""
    from tpusr_torch.train.checkpoint import load_metadata

    meta = load_metadata(os.path.dirname(ckpt_path) or ".",
                         os.path.basename(ckpt_path)) or {}
    hist = meta.get("history", {})
    ev = meta.get("eval", {})
    out = {}
    for met in ("loss", "psnr", "ssim"):
        if hist.get(met):
            out[f"train_{met}"] = hist[met][-1]
        # the GAN history uses g_loss
        elif met == "loss" and hist.get("g_loss"):
            out["train_loss"] = hist["g_loss"][-1]
        if hist.get(f"val_{met}"):
            out[f"val_{met}"] = hist[f"val_{met}"][-1]
        if met in ev:
            out[f"eval_{met}"] = ev[met]
    for src, dst in (("avg_g_loss", "eval_loss"), ("avg_psnr", "eval_psnr"),
                     ("avg_ssim", "eval_ssim")):
        if src in ev:
            out[dst] = ev[src]
    times = meta.get("epoch_time_sec") or []
    if times:
        out["train_epoch_time_sec"] = float(sum(times) / len(times))
    mem = meta.get("memory") or {}
    if mem.get("gpu_mean_current_mb") is not None:
        out["train_mem_mean_mb"] = mem["gpu_mean_current_mb"]
    if mem.get("gpu_peak_mb") is not None:
        out["train_mem_peak_mb"] = mem["gpu_peak_mb"]
    return out


# classic interpolation baselines (classic_algorithms.py:7-21), on the
# device; the reference's method name "lanczos" is the lanczos4 kernel
_INTERP_ALIAS = {"lanczos": "lanczos4"}


def build_classic_sr_methods(names, hr_hw):
    """name -> sr_apply(lr_batch)->[0,1] HR batch, for every reference
    interpolation method name (incl. the 'lanczos' alias)."""
    import torch

    from tpusr_torch.core.resize import resize

    return {
        name: (lambda x, n=_INTERP_ALIAS.get(name, name):
               torch.clamp(resize(x, hr_hw, n), 0.0, 1.0))
        for name in names
    }


def cmd_pipeline(args):
    """End-to-end LR -> SR (per method) -> classify comparison, the missing
    defect_detection_pipeline notebook (SURVEY §0): the classic
    interpolators plus any trained SRCNN/EDSR/ESRGAN checkpoints, each SR
    classified by VGG16's patch votes. Writes ``pipeline_results.json`` and
    prints each method's train-side and inference-side statistics (what the
    JAX command plots); no figures."""
    import torch

    from tpusr_torch.core.resize import resize
    from tpusr_torch.data import load_predictions_dataset
    from tpusr_torch.models.api import (EDSR as EDSRFacade,
                                        ESRGAN as ESRGANFacade,
                                        FineTunedVGG16, SRCNNModel)
    from tpusr_torch.pipeline import defect_pipeline
    from tpusr_torch.train.profiling import device_memory_mb

    dev = _device(args)
    x_lr, x_hr, y = load_predictions_dataset(args.lr_dir, args.hr_dir,
                                             args.class_map)
    scale = x_hr.shape[1] // x_lr.shape[1]
    hr_hw = x_hr.shape[1:3]

    vgg = FineTunedVGG16(device=dev)
    vgg.setup_model(input_shape=(96, 96, 3), num_classes=2,
                    from_pretrained=bool(args.vgg16_ckpt),
                    pretrained_path=args.vgg16_ckpt)
    clf_apply = vgg.network()

    interp_names = [m.strip() for m in args.classic_methods.split(",") if m.strip()]
    sr_methods = build_classic_sr_methods(interp_names, hr_hw)
    sidecars = {}
    if args.srcnn_ckpt:
        srcnn = SRCNNModel(device=dev)
        srcnn.setup_model(from_pretrained=True, pretrained_path=args.srcnn_ckpt)
        srcnn_net = srcnn.network()
        # SRCNN consumes a pre-upscaled input (SRCNN_model.py:111-247):
        # cv2-parity resize to HR size, then the residual net
        sr_methods["srcnn"] = lambda x: torch.clamp(
            srcnn_net(resize(x, hr_hw, args.srcnn_interp)), 0.0, 1.0)
        sidecars["srcnn"] = args.srcnn_ckpt
    if args.edsr_ckpt:
        edsr = EDSRFacade(device=dev)
        edsr.setup_model(scale_factor=scale, from_pretrained=True,
                         pretrained_path=args.edsr_ckpt)
        edsr_net = edsr.network()
        sr_methods["edsr"] = lambda x: torch.clamp(edsr_net(x), 0.0, 1.0)
        sidecars["edsr"] = args.edsr_ckpt
    if args.esrgan_ckpt:
        esr = ESRGANFacade(device=dev)
        esr.setup_model(scale_factor=scale, from_trained=True,
                        generator_pretrained_path=args.esrgan_ckpt,
                        discriminator_pretrained_path=args.esrgan_disc_ckpt)
        # dense attention, as the JAX command builds the generator
        esr_net = esr.network()
        # tanh generator works in [-1, 1] (ESRGAN_model.py:929,946)
        sr_methods["esrgan"] = lambda x: torch.clamp(
            (esr_net(x * 2.0 - 1.0) + 1.0) / 2.0, 0.0, 1.0)
        sidecars["esrgan"] = args.esrgan_ckpt

    mem_before = device_memory_mb(dev)
    results = defect_pipeline.run_defect_detection_comparison(
        sr_methods, clf_apply, x_lr, x_hr, y, batch_size=args.batch_size,
        device=dev)
    mem_after = device_memory_mb(dev)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "pipeline_results.json"), "w") as f:
        json.dump({k: {kk: vv for kk, vv in v.items()
                       if kk not in ("predictions", "confidences",
                                     "confusion_matrix")}
                   for k, v in results.items()}, f, indent=2, default=float)
    print(f"pipeline: {NO_FIGURES}")
    # the statistics the JAX command's sr metrics / time / memory panels
    # show: train-side from the checkpoint sidecars, inference-side measured
    # in this run
    for n, r in results.items():
        m = _ckpt_sidecar_metrics(sidecars[n]) if n in sidecars else {}
        m["inference_time_sec"] = r["time_sec"]
        m["inference_mem_mean_mb"] = 0.5 * (mem_before["current_mb"]
                                            + mem_after["current_mb"])
        m["inference_mem_peak_mb"] = max(mem_before["peak_mb"],
                                         mem_after["peak_mb"])
        print(f"{n}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in m.items()))
    return results


def cmd_convert(args):
    """Move a model between the port's checkpoint and the reference's Keras
    ``.h5`` (SRCNN_model.py:249-259, EDSR_model.py:317-330,
    ESRGAN_model.py:981-996, VGG16_model.py:272-281), as the JAX command.

    The direction is set by ``--src``: a ``.h5``/``.hdf5`` file is imported
    and written as the port's checkpoint; anything else is read as the
    port's checkpoint and exported to ``.h5`` (loadable with
    ``keras.models.load_model``). Returns the written path(s)."""
    from tpusr_torch.models.api import (EDSR, ESRGAN, FineTunedVGG16,
                                        SRCNNModel)

    to_ckpt = args.src.endswith((".h5", ".hdf5"))
    ts = args.timestamp or _timestamp()
    if not to_ckpt and args.model == "esrgan" and args.disc:
        # checkpoint sources carry both G and D (plus the arch sidecar);
        # a user-supplied --disc would be silently ignored — refuse instead
        raise SystemExit("--disc only applies when --src is a Keras .h5 "
                         "generator; checkpoint sources already contain the "
                         "discriminator")
    dev = _device(args)
    if args.model == "srcnn":
        m = SRCNNModel(device=dev)
        m.setup_model(from_pretrained=True, pretrained_path=args.src)
    elif args.model == "edsr":
        m = EDSR(device=dev)
        m.setup_model(scale_factor=args.scale, num_res_blocks=args.blocks,
                      num_filters=args.filters, from_pretrained=True,
                      pretrained_path=args.src)
    elif args.model == "esrgan":
        m = ESRGAN(device=dev)
        hw = args.patch_size
        m.setup_model(scale_factor=args.scale, growth_channels=args.growth,
                      num_rrdb_blocks=args.rrdb_blocks,
                      input_shape=(hw, hw, 3),
                      output_shape=(hw * args.scale, hw * args.scale, 3),
                      from_trained=True,
                      generator_pretrained_path=args.src,
                      discriminator_pretrained_path=args.disc)
    else:  # vgg16
        m = FineTunedVGG16(device=dev)
        m.setup_model(input_shape=(args.input_hw, args.input_hw, 3),
                      num_classes=args.num_classes,
                      from_pretrained=True, pretrained_path=args.src)
    path = m.save(args.out, ts) if to_ckpt else m.save_h5(args.out, ts)
    shown = " + ".join(path) if isinstance(path, tuple) else path
    print(f"Converted {args.src} -> {shown}")
    return path


def cmd_eda(args):
    """The dataset EDA (``data/eda.py``) on the card: ``eda_metrics.csv``
    and ``eda_summary.csv`` under ``--out``, the global panel's numbers and
    the scenario pick printed; no figures. ``--lpips-weights`` (else
    ``$TPUSR_LPIPS_WEIGHTS`` or ``weights/lpips_alex.npz``) fills the LPIPS
    column. Returns the output directory."""
    from tpusr_torch.data.eda import run_eda_pipeline

    dev = _device(args)
    run_eda_pipeline(args.lr_dir, args.hr_dir, args.out,
                     interp_map_path=args.interp_map, limit=args.limit,
                     lpips_weights=args.lpips_weights, device=dev)
    print(f"[eda] wrote eda_metrics.csv and eda_summary.csv to {args.out}")
    return args.out


def _gate_certification_note(args) -> str | None:
    """One-line serving-gate verdict for the selected configuration, from
    the port's own gate report (``GATE_torch.json`` at the root of the
    checkout, written by ``python -m tpusr_torch.tools.serving_gate``; None
    when it is not there). A mode the gate failed gets a warning."""
    from tpusr_torch.tools.serving_gate import gate_row_name

    if (args.sr_mode, args.clf_mode) == ("f32", "per_patch_f32"):
        return "reference-parity path (the gate's comparison baseline)"
    try:
        row = gate_row_name(args.sr_mode, args.clf_mode,
                            border=not args.no_border,
                            cascade_score=args.cascade_score,
                            cascade_frac=args.cascade_frac,
                            cascade_guard=args.cascade_guard > 0)
    except ValueError as e:
        return f"WARNING: configuration NOT gate-certified ({e})"
    path = os.path.join(_REPO, GATE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        report = json.load(f)
    task = report.get("task", {}).get("name", "")
    modes = report["aggregate"]["modes"]
    m = next((x for x in modes if x["mode"] == row), None)
    if m is None:
        return (f"WARNING: {row} has no row in the serving gate "
                "(uncertified configuration)")
    if not m.get("passes_gate_all_seeds"):
        passing = [x["mode"] for x in modes if x.get("passes_gate_all_seeds")]
        return (f"WARNING: {row} FAILED the {task} serving gate "
                f"(min vote agreement {m['min_vote_agreement']:.4f} < 0.99, "
                f"{m['total_flips']} flips over seeds {m.get('seeds')} — "
                f"{GATE_FILE}); rows that pass every seed there: "
                f"{', '.join(passing) or 'none'}")
    return (f"{task}-gate certified: {row} (min vote agreement "
            f"{m['min_vote_agreement']:.4f}, {m['total_flips']} flips over "
            f"seeds {m.get('seeds')} — {GATE_FILE})")


def _read_calib_dir(calib_dir: str, lr_hw: tuple[int, int]):
    """Up to 16 calibration images (``*.png``, ``*.jpg`` and ``*.jpeg``,
    sorted together by path, as the JAX command lists them) as an (N, h, w,
    3) float32 [0, 1] array, each resized to the LR size with OpenCV's
    ``INTER_AREA`` weights (``core/resize.py``) and rounded back to uint8,
    as the JAX command reads them with cv2."""
    import torch

    from tpusr_torch.core.resize import resize
    from tpusr_torch.pipeline.png import decode_image_u8

    files = sorted(f for ext in ("png", "jpg", "jpeg")
                   for f in glob.glob(os.path.join(calib_dir, f"*.{ext}")))[:16]
    if not files:
        raise SystemExit(f"--calib-dir {calib_dir}: no images")
    imgs = []
    for f in files:
        with open(f, "rb") as fh:
            body = fh.read()
        try:
            u8 = decode_image_u8(body)
        except ValueError as e:
            raise SystemExit(f"--calib-dir: unreadable image {f} ({e})") from None
        if u8.shape[:2] != lr_hw:
            u8 = (resize(torch.from_numpy(u8).float(), lr_hw, "area")
                  .round().clamp(0, 255).to(torch.uint8).numpy())
        imgs.append(u8)
    return np.stack(imgs).astype(np.float32) / 255.0


def cmd_serve(args):
    """Stand up the serving tier: load trained EDSR + VGG16 checkpoints,
    build a gated ``make_serving_pipeline`` configuration, and serve HTTP
    requests with cross-request micro-batching (``PipelineServer``). Fast
    modes are validated by ``python -m tpusr_torch.tools.serving_gate``
    (``GATE_torch.json``)."""
    import torch

    from tpusr_torch.core.patches import patchify
    from tpusr_torch.models.api import EDSR as EDSRFacade, FineTunedVGG16
    from tpusr_torch.models.edsr_fast import make_fused_sr_apply
    from tpusr_torch.models.layers import pixel_shuffle
    from tpusr_torch.pipeline import PipelineServer, make_serving_pipeline
    from tpusr_torch.pipeline.http_serving import make_http_server

    dev = _device(args)
    lr_hw = (args.lr_size, args.lr_size)
    edsr = EDSRFacade(device=dev)
    edsr.setup_model(scale_factor=args.scale, from_pretrained=True,
                     pretrained_path=args.edsr_ckpt)
    vgg = FineTunedVGG16(device=dev)
    vgg.setup_model(input_shape=(args.patch, args.patch, 3),
                    num_classes=args.num_classes, from_pretrained=True,
                    pretrained_path=args.vgg16_ckpt)
    edsr_net, vgg_net = edsr.network(), vgg.network()

    calib_lr = calib_patches = None
    if args.sr_mode == "int8" or args.clf_mode.endswith("int8"):
        if args.calib_dir:
            calib = _read_calib_dir(args.calib_dir, lr_hw)
        else:
            print("warning: int8 mode without --calib-dir — calibrating on "
                  "random inputs (pass real LR images for tighter scales)",
                  flush=True)
            calib = np.random.default_rng(0).random(
                (8, *lr_hw), dtype=np.float32)[..., None].repeat(3, -1)
        calib_lr = torch.as_tensor(calib, device=dev)
        # classifier calibration patches come from the f32 SR of the same
        # calibration images: the distribution the classifier will see
        fn, r = make_fused_sr_apply(edsr_net)
        with torch.inference_mode():
            sr = pixel_shuffle(fn(calib_lr[:4]), r)
            pats = patchify(sr, args.patch, args.stride)
        calib_patches = pats.reshape((-1, args.patch, args.patch, 3))[:64]

    pipe = make_serving_pipeline(
        edsr_net, vgg_net, lr_hw, args.scale, patch=args.patch,
        stride=args.stride, sr_mode=args.sr_mode, clf_mode=args.clf_mode,
        calib_lr=calib_lr, calib_patches=calib_patches,
        sr_border_correction=not args.no_border,
        cascade_escalate_frac=args.cascade_frac,
        cascade_escalate_score=args.cascade_score,
        cascade_guard_threshold=(args.cascade_guard
                                 if args.cascade_guard > 0 else None),
        device=dev)

    config = {"sr_mode": args.sr_mode, "clf_mode": args.clf_mode,
              "scale": args.scale, "patch": args.patch,
              "stride": args.stride, "batch_size": args.batch_size,
              "max_wait_ms": args.max_wait_ms,
              "border_correction": not args.no_border, "device": str(dev)}
    if args.clf_mode == "cascade_int8":
        config["cascade_escalate_frac"] = args.cascade_frac
        config["cascade_escalate_score"] = args.cascade_score
        config["cascade_guard_threshold"] = (args.cascade_guard
                                             if args.cascade_guard > 0
                                             else None)
    note = _gate_certification_note(args)
    if note:
        config["gate"] = note
        print(f"tpusr_torch serve: {note}", flush=True)
    with PipelineServer(pipe, batch_size=args.batch_size,
                        max_wait_ms=args.max_wait_ms) as server:
        # warm the full serving path (the kernels' libraries load, cuDNN and
        # cuBLAS pick their algorithms, the worker's round trip) before the
        # port is announced: the first real request must not pay for it
        server.submit(np.zeros((*lr_hw, 3), np.float32)).result(timeout=900)
        httpd = make_http_server(
            server, lr_hw, config=config, host=args.host, port=args.port,
            request_timeout=args.request_timeout,
            max_requests=args.max_requests or None)
        port = httpd.server_address[1]
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(port))
        print(f"tpusr_torch serve: {args.sr_mode} SR x {args.clf_mode} on "
              f"{dev} at http://{args.host}:{port} (POST /classify, /sr, "
              f"/classify_sr; GET /healthz)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()


DEVICE_HELP = ("torch device to run on (default cuda; cpu runs the kernels' "
               "plain PyTorch twins)")
DP_HELP = ("data-parallel over every rank: this process alone, or each rank "
           "of torchrun --nproc-per-node N")


def build_parser():
    p = argparse.ArgumentParser(prog="tpusr_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("preprocess", help="not ported: video -> HR/LR PNG "
                        "pairs needs a video decoder")
    sp.add_argument("--video", required=True)
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--lr-dir", required=True)
    sp.add_argument("--skip-seconds", type=float, default=0.0)
    sp.add_argument("--frame-interval", type=float, default=1.0)
    sp.add_argument("--hr-size", type=int, default=None)
    sp.add_argument("--prefix", default="sample")
    sp.add_argument("--interp-map", default=None)
    sp.add_argument("--class-map", default=None)
    sp.add_argument("--class-id", type=int, default=None)
    sp.add_argument("--predictions", action="store_true")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--max-frames", type=int, default=None)
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser("classic", help="rank the eight classic SR "
                        "algorithms over HR/LR PNG pairs: classic_summary.json "
                        "(no figures)")
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--lr-dir", required=True)
    sp.add_argument("--out", default="classic_algorithms_results")
    sp.add_argument("--fraction", type=float, default=0.7)
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_classic)

    for name, fn, extra, what in (
        ("train-srcnn", cmd_train_srcnn, ("interp_map",), "SRCNN"),
        ("train-edsr", cmd_train_edsr, ("scale",), "EDSR"),
        ("train-esrgan", cmd_train_esrgan,
         ("scale", "vgg19_weights", "preview_dir"), "ESRGAN, adversarially"),
    ):
        sp = sub.add_parser(name, help=f"train {what} on HR/LR PNG pairs")
        sp.add_argument("--hr-dir", required=True)
        sp.add_argument("--lr-dir", required=True)
        sp.add_argument("--out", default="checkpoints")
        sp.add_argument("--batch-size", type=int, default=16)
        sp.add_argument("--epochs", type=int, default=50)
        sp.add_argument("--lr", type=float, default=1e-4)
        sp.add_argument("--data-parallel", action="store_true",
                        help=DP_HELP)
        sp.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (f32 master params/loss)")
        sp.add_argument("--resume", default=None,
                        help="checkpoint path: resume training incl. "
                             "optimizer state")
        sp.add_argument("--checkpoint-every", type=int, default=0,
                        help="save an async epoch_NNNN resume point under "
                             "--out every N epochs")
        if "interp_map" in extra:
            sp.add_argument("--interp-map", default=None)
        if "scale" in extra:
            sp.add_argument("--scale", type=int, default=2)
        if "vgg19_weights" in extra:
            sp.add_argument("--vgg19-weights", default=None,
                            help="VGG19 ImageNet weights: the Keras notop "
                                 ".h5 release or its converted .npz")
        if "preview_dir" in extra:
            sp.add_argument("--preview-dir", default=None)
        sp.add_argument("--device", default="cuda", help=DEVICE_HELP)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("train-vgg16", help="train the VGG16 defect "
                        "classifier on HR PNG patches")
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--class-map", required=True)
    sp.add_argument("--out", default="checkpoints")
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--patch-size", type=int, default=96)
    sp.add_argument("--stride", type=int, default=48)
    sp.add_argument("--data-parallel", action="store_true", help=DP_HELP)
    sp.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (f32 master params/loss)")
    sp.add_argument("--resume", default=None,
                    help="checkpoint path: resume training incl. "
                         "optimizer state")
    sp.add_argument("--checkpoint-every", type=int, default=0,
                    help="save an async epoch_NNNN resume point under "
                         "--out every N epochs")
    sp.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_train_vgg16)

    sp = sub.add_parser("pipeline", help="LR -> SR (per method) -> "
                        "classify comparison: pipeline_results.json (no "
                        "figures)")
    sp.add_argument("--lr-dir", required=True)
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--class-map", required=True)
    sp.add_argument("--out", default="DL_results")
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--vgg16-ckpt", default=None)
    sp.add_argument("--srcnn-ckpt", default=None)
    sp.add_argument("--srcnn-interp", default="bicubic",
                    help="pre-upscale interpolation for the SRCNN path")
    sp.add_argument("--edsr-ckpt", default=None)
    sp.add_argument("--esrgan-ckpt", default=None)
    sp.add_argument("--esrgan-disc-ckpt", default=None,
                    help="required when --esrgan-ckpt is a Keras .h5")
    sp.add_argument("--classic-methods",
                    default="bilinear,bicubic,area,lanczos4",
                    help="comma list of classic interpolators to compare")
    sp.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("convert", help="a model between the port's "
                        "checkpoint and the reference's Keras .h5, both ways")
    sp.add_argument("--model", required=True,
                    choices=("srcnn", "edsr", "esrgan", "vgg16"))
    sp.add_argument("--src", required=True,
                    help="a Keras .h5 (imports to the port's checkpoint) or "
                         "the port's checkpoint path (exports to .h5)")
    sp.add_argument("--disc", default=None,
                    help="discriminator .h5 (required for --model esrgan "
                         "when --src is a generator .h5)")
    sp.add_argument("--out", default="checkpoints")
    sp.add_argument("--timestamp", default=None,
                    help="artifact timestamp suffix (default: now)")
    sp.add_argument("--scale", type=int, default=2,
                    help="SR scale (for .h5 sources only; checkpoints carry "
                         "their architecture sidecar)")
    sp.add_argument("--blocks", type=int, default=16,
                    help="EDSR res blocks (needed for .h5 sources only; "
                         "checkpoints carry their architecture sidecar)")
    sp.add_argument("--filters", type=int, default=64)
    sp.add_argument("--growth", type=int, default=32,
                    help="ESRGAN growth channels (.h5 sources only)")
    sp.add_argument("--rrdb-blocks", type=int, default=23,
                    help="ESRGAN RRDB block count (.h5 sources only)")
    sp.add_argument("--patch-size", type=int, default=24,
                    help="ESRGAN LR train-patch size (fixes the "
                         "discriminator export geometry)")
    sp.add_argument("--input-hw", type=int, default=96,
                    help="VGG16 input H=W (the reference trains on 96x96 "
                         "patches)")
    sp.add_argument("--num-classes", type=int, default=2)
    sp.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("serve", help="HTTP serving tier: micro-batched "
                        "SR + defect classification from trained checkpoints")
    sp.add_argument("--edsr-ckpt", required=True)
    sp.add_argument("--vgg16-ckpt", required=True)
    sp.add_argument("--scale", type=int, default=4)
    sp.add_argument("--lr-size", type=int, default=128,
                    help="served LR image side")
    sp.add_argument("--patch", type=int, default=96)
    sp.add_argument("--stride", type=int, default=48)
    sp.add_argument("--num-classes", type=int, default=2)
    # serve defaults = the JAX package's shipped mode: f32 SR +
    # vote_frac-ranked cascade_int8 at frac 0.25 with the trunk-collapse
    # guard at 0.6 (certified on the TPU by GATE_r05.json's 12 seeds; the
    # port's GATE_torch.json fails it on 1 of its 12 seeds, and the serve
    # command says so)
    sp.add_argument("--sr-mode", default="f32",
                    choices=("f32", "bf16", "int8"))
    sp.add_argument("--clf-mode", default="cascade_int8",
                    choices=("per_patch_f32", "per_patch_int8",
                             "shared_trunk_f32", "shared_trunk_int8",
                             "cascade_int8"))
    sp.add_argument("--cascade-score", choices=("conf", "vote_frac"),
                    default="vote_frac",
                    help="cascade_int8: escalation ranking signal — patch-"
                         "agreement fraction (certified) or trunk vote "
                         "confidence")
    sp.add_argument("--cascade-frac", type=float, default=0.25,
                    help="cascade_int8: fraction of each batch (the lowest-"
                         "scored trunk votes) escalated to the exact "
                         "per-patch int8 path")
    sp.add_argument("--cascade-guard", type=float, default=0.6,
                    help="cascade_int8: trunk-collapse guard threshold — "
                         "if the escalated subset's trunk-vs-per-patch "
                         "disagreement reaches it, the whole batch is "
                         "re-served per-patch (0 disables)")
    sp.add_argument("--no-border", action="store_true",
                    help="drop the int8 SR border band (classify-only mode: "
                         "fastest, SR output not image-faithful)")
    sp.add_argument("--calib-dir", default=None,
                    help="directory of LR PNG images for int8 calibration")
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--max-wait-ms", type=float, default=5.0)
    sp.add_argument("--request-timeout", type=float, default=120.0,
                    help="per-request wait on the batcher future (seconds)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8512,
                    help="0 picks a free port (printed + --port-file)")
    sp.add_argument("--port-file", default=None,
                    help="write the bound port here once listening")
    sp.add_argument("--max-requests", type=int, default=0,
                    help="shut down after N POSTs (0 = serve forever)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain PyTorch twins)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("eda", help="dataset EDA: per-pair metrics and "
                        "their summary as CSV (no figures)")
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--lr-dir", required=True)
    sp.add_argument("--out", default="eda_results")
    sp.add_argument("--interp-map", default=None)
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--lpips-weights", default=None,
                    help="provisioned lpips_alex .npz "
                         "(tpusr_torch.tools.lpips_weights); fills the LPIPS "
                         "column and picks the scenarios by LPIPS")
    sp.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sp.set_defaults(fn=cmd_eda)
    return p


def main(argv=None):
    """Run one command; returns what it returns (a checkpoint path, ...)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()  # exit status 0; a failed command raises or exits non-zero
