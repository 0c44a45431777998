"""The f32 reference path as one callable (counterpart of
``__graft_entry__.entry()``): chained EDSR x4 (not the fused tail), per-patch
f32 VGG16 and the patch vote, at 128x128 LR, patch 96, stride 48.

    fn, (lr_batch,) = entry()
    sr, classes, confidences = fn(lr_batch)

As the JAX entry, the EDSR weights are flax's ``init`` from
``jax.random.PRNGKey(0)`` and the VGG16 weights from ``PRNGKey(1)``, drawn
by ``tpusr_torch.core.prng``. The example batch of 2 LR images is ``np.random.default_rng(0)``'s, as in
the JAX entry.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusr_torch.core import prng
from tpusr_torch.device import resolve_device
from tpusr_torch.dist.bootstrap import spawn
from tpusr_torch.models import EDSR, VGG16Classifier
from tpusr_torch.pipeline.defect_pipeline import FusedSRClassifyPipeline

LR_HW, SCALE, PATCH, STRIDE = (128, 128), 4, 96, 48


def entry_pipeline(edsr, clf, lr_hw=LR_HW, patch: int = PATCH,
                   stride: int = STRIDE, device=None) -> FusedSRClassifyPipeline:
    """The reference path on given modules: ``edsr`` (chained forward) ->
    per-patch ``clf`` -> vote."""
    return FusedSRClassifyPipeline(edsr, clf_apply=clf, lr_hw=lr_hw,
                                   scale=edsr.scale_factor, patch=patch,
                                   stride=stride, device=device)


def entry(device=None):
    """Returns (fn, example_args): ``fn(lr_batch) -> (sr, classes,
    confidences)`` on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    edsr = EDSR(scale_factor=SCALE, device=dev, key=0)
    clf = VGG16Classifier(num_classes=2, device=dev, key=1)
    pipe = entry_pipeline(edsr, clf, device=dev)

    def fn(lr_batch):
        return pipe(lr_batch)

    fn.pipeline = pipe
    example = (torch.as_tensor(np.random.default_rng(0).random(
        (2, *LR_HW, 3), dtype=np.float32), device=dev),)
    return fn, example


# ------------------------------------------------------ the multi-rank dry run

def _center_bias(vgg, probs_fn, classes_fn=None) -> None:
    """Shift the class-1 logit bias so that the patch votes of
    ``probs_fn()`` ((N, P, 2) probs with the current bias) split the images
    between both classes: a random VGG16 votes one class for every image,
    and a one-class vote spectrum is weak evidence for single == multi.
    An image's vote turns from class 0 to 1 at one shift of its log-odds
    (votes, then the mean probability on a tie), found by bisection; the
    shifts tried lie midway between two images' turning points, the most
    even splits first and the widest gaps among them, and the first whose
    float32 run (``classes_fn()``, by default the votes of ``probs_fn()``)
    splits the classes stays."""
    from tpusr_torch.pipeline.defect_pipeline import _vote

    with torch.no_grad():
        base = float(vgg.predictions.bias[1])
        p = probs_fn().double()
        lo = torch.log(p[..., 1].clamp_min(1e-12) / p[..., 0].clamp_min(1e-12))

        def ones(d: float) -> torch.Tensor:
            p1 = torch.sigmoid(lo + d)
            return _vote(torch.stack([1 - p1, p1], -1))[0] == 1

        lo_d, hi_d = torch.full((lo.shape[0],), -60.0), torch.full(
            (lo.shape[0],), 60.0)
        for _ in range(80):      # every image's turning point at once
            mid = (lo_d + hi_d) / 2
            p1 = torch.sigmoid(lo + mid[:, None].to(lo))
            up = (_vote(torch.stack([1 - p1, p1], -1))[0] == 1).cpu()
            hi_d, lo_d = torch.where(up, mid, hi_d), torch.where(up, lo_d, mid)
        turns = sorted(set(hi_d.tolist()))
        tries = []
        for a, b in zip(turns[:-1], turns[1:]):
            n1 = int(ones((a + b) / 2).sum())
            tries.append(((-abs(2 * n1 - lo.shape[0]), b - a), (a + b) / 2))
        if classes_fn is None:
            def classes_fn():
                return _vote(probs_fn())[0]
        for _key, d in sorted(tries, reverse=True):
            vgg.predictions.bias[1] = base + d
            if len(classes_fn().unique()) > 1:
                return


def _dryrun_rank(rank: int, n: int, device: str, init_file: str,
                 backend: str, p2p: bool) -> None:
    """One rank of ``dryrun_multichip``: the six checks of
    ``__graft_entry__._dryrun_multichip_impl``, each single == multi."""
    import math

    import torch.distributed as dist

    from tpusr_torch.dist import (full_image_esrgan_sr, make_mesh,
                                  make_pp_mesh, make_pp_train_step,
                                  make_tp_mesh, shard_params_tp)
    from tpusr_torch.models import (ESRGANDiscriminator, ESRGANGenerator,
                                    SRCNN, VGG19Features)
    from tpusr_torch.models.quant import (calibrate_vgg16,
                                          per_patch_int8_probs,
                                          quantize_input, quantize_vgg16)
    from tpusr_torch.models.vgg_trunk import (shared_trunk_probs_f32,
                                              shared_trunk_probs_int8)
    from tpusr_torch.pipeline.cascade import make_cascade_votes
    from tpusr_torch.train import ESRGANTrainer, SupervisedSRTrainer

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        dev = resolve_device(device)
        mesh = make_mesh(device=dev)
        rng = np.random.default_rng(0)
        batch = 2 * n

        def t(a):
            return torch.as_tensor(a, device=dev)

        # (DP) the ESRGAN step with the full VGG19: finite, as JAX's (its
        # equality with the unsharded step: tests/test_torch_dist_sharding)
        lr = rng.random((batch, 8, 8, 3), dtype=np.float32) * 2 - 1
        hr = rng.random((batch, 16, 16, 3), dtype=np.float32) * 2 - 1
        # JAX's keys: the trainer's default split(PRNGKey(42)), VGG19 from
        # PRNGKey(0), then 2, 3, 42 (SRCNN's trainer default), 4 and 5
        rg, rd = prng.split(prng.PRNGKey(42))
        tr = ESRGANTrainer(
            ESRGANGenerator(scale_factor=2, growth_channels=4,
                            num_rrdb_blocks=1, device=dev, key=rg),
            ESRGANDiscriminator(device=dev, key=rd),
            VGG19Features(device=dev, key=0), mesh=mesh, device=dev)
        met = tr.train_step(tr.init_state(), t(lr), t(hr))[1]
        g_loss, d_loss = float(met["g_loss"]), float(met["d_loss"])
        assert math.isfinite(g_loss) and math.isfinite(d_loss), (g_loss, d_loss)
        del tr

        # (DP) the fused LR -> EDSR SR -> VGG16 patch-vote pipeline
        sr_model = EDSR(scale_factor=2, num_res_blocks=1, device=dev, key=2)
        clf = VGG16Classifier(num_classes=2, device=dev, key=3)
        plr = t(rng.random((batch, 16, 16, 3)).astype(np.float32))
        with torch.no_grad():
            sr_imgs = sr_model(plr)
        pipe_1 = entry_pipeline(sr_model, clf, (16, 16), 32, 16, dev)
        _center_bias(clf, lambda: pipe_1._classify_block(sr_imgs))

        def classes(m, **stage):
            from tpusr_torch.pipeline.defect_pipeline import \
                FusedSRClassifyPipeline
            p = FusedSRClassifyPipeline(sr_model, lr_hw=(16, 16), scale=2,
                                        patch=32, stride=16, mesh=m,
                                        device=dev, **stage)
            return p(plr, n_valid=stage.pop("n_valid", None))[1].cpu()

        cls = classes(mesh, clf_apply=clf)
        assert torch.equal(cls, classes(None, clf_apply=clf)), cls
        assert len(cls.unique()) > 1, f"vote spectrum degenerate: {cls}"

        # (DP) the shared trunk, its bias centered on its own log-odds
        per_patch_bias = clf.predictions.bias.detach().clone()
        _center_bias(clf, lambda: shared_trunk_probs_f32(clf, sr_imgs, 32, 16))

        def trunk(imgs):
            return shared_trunk_probs_f32(clf, imgs, 32, 16)
        tcls = classes(mesh, trunk_probs=trunk)
        assert torch.equal(tcls, classes(None, trunk_probs=trunk)), tcls
        assert len(tcls.unique()) > 1, f"trunk spectrum degenerate: {tcls}"

        # (DP) the guarded vote_frac int8 cascade, 3 pad rows (n_valid), its
        # bias centered on the int8 paths' log-odds until the cascade's own
        # classes split
        with torch.no_grad():
            clf.predictions.bias.copy_(per_patch_bias)
        calib = t(rng.random((4, 32, 32, 3)).astype(np.float32))
        scales = calibrate_vgg16(clf, calib)

        def int8_paths():
            # the trunk's and the per-patch path's probs: the cascade serves
            # the one or the other, so either's turning points may split it
            q = quantize_vgg16(clf, scales)
            x = quantize_input(q, sr_imgs)
            return torch.cat([shared_trunk_probs_int8(q, x, 32, 16),
                              per_patch_int8_probs(q, x, 32, 16)])

        def cascade(m):
            from tpusr_torch.pipeline.defect_pipeline import \
                FusedSRClassifyPipeline
            q = quantize_vgg16(clf, scales)
            votes = make_cascade_votes(q, 32, 16, escalate_frac=0.25,
                                       escalate_score="vote_frac",
                                       guard_threshold=0.6)
            p = FusedSRClassifyPipeline(
                sr_model, cascade_votes=votes, lr_hw=(16, 16), scale=2,
                patch=32, stride=16, mesh=m, device=dev,
                pre_quant=lambda s: quantize_input(q, s))
            return p(plr, n_valid=batch - 3)[1].cpu()
        _center_bias(clf, int8_paths, lambda: cascade(None))
        ccls = cascade(mesh)
        assert torch.equal(ccls, cascade(None)), ccls
        # with fewer than 2 real images (1 or 2 ranks) one escalation and
        # the guard may leave no bias that splits the classes
        assert batch - 3 < 2 or len(ccls.unique()) > 1, \
            f"cascade spectrum degenerate: {ccls}"

        # (TP) DP x TP SRCNN step: channel-sharded state, loss as replicated
        n_model = 2 if n % 2 == 0 else 1
        mesh2d = make_tp_mesh(n // n_model, n_model, device=dev)
        sx = t(rng.random((batch, 12, 12, 3), dtype=np.float32))
        sy = t(rng.random((batch, 12, 12, 3), dtype=np.float32))

        def srcnn_loss(m):
            tr = SupervisedSRTrainer(SRCNN(device=dev, key=42), mesh=m,
                                     device=dev)
            st = tr.init_state()
            if m is not None:
                st = shard_params_tp(m, st)
            return float(tr.train_step(st, sx, sy)[1]["loss"])
        tp_loss, ref_loss = srcnn_loss(mesh2d), srcnn_loss(None)
        assert abs(tp_loss - ref_loss) < 1e-4, (tp_loss, ref_loss)

        line = (f"dryrun_multichip({n}): g_loss={g_loss:.4f} "
                f"d_loss={d_loss:.4f} pipeline_classes={cls.tolist()} "
                f"trunk_classes={tcls.tolist()} "
                f"cascade_classes={ccls.tolist()} "
                f"tp_loss={tp_loss:.6f}=={ref_loss:.6f}")
        if p2p:
            # (SP) full-image SR, rows split + ring attention == dense
            gen = ESRGANGenerator(scale_factor=2, growth_channels=4,
                                  num_rrdb_blocks=1, device=dev, key=4)
            full = t(rng.random((1, 2 * n, 8, 3), dtype=np.float32) * 2 - 1)
            sp_sr = full_image_esrgan_sr(gen, full, mesh)
            with torch.no_grad():
                sp_err = float((sp_sr - gen(full)).abs().max())
            assert sp_err <= 5e-5, sp_err

            # (PP) the pipelined EDSR train step's loss == the dense loss
            n_stages = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
            pp_mesh = make_pp_mesh(n_stages, n_data=n // n_stages, device=dev)
            pp_model = EDSR(scale_factor=2, num_res_blocks=n_stages,
                            num_filters=8, device=dev, key=5)
            px = t(rng.random((4, 8, 8, 3), dtype=np.float32))
            py = t(rng.random((4, 16, 16, 3), dtype=np.float32))
            params = dict(pp_model.named_parameters())
            _, pp_loss = make_pp_train_step(pp_model, pp_mesh, n_micro=2)(
                params, px, py)
            with torch.no_grad():
                dense = float(torch.mean((pp_model(px) - py) ** 2))
            pp_loss = float(pp_loss)
            assert abs(pp_loss - dense) < 1e-5, (pp_loss, dense)
            line += (f" sp_full_image_sr_maxerr={sp_err:.2e} "
                     f"pp_loss={pp_loss:.6f}=={dense:.6f}")
        else:
            line += (" sp, pp: SKIPPED (gloo carries no send/recv of CUDA "
                     "tensors; run them on one card per rank)")
        if rank == 0:
            print(line + " single==multi OK", flush=True)
    finally:
        dist.destroy_process_group()


def _bootstrap_rank(pid: int, port: int, device: str, out_dir: str) -> None:
    """One of the 2 processes of the bootstrap check: ``initialize`` over
    TCP, a reduce across the processes, and a DP EDSR step on a global batch
    built from each process's half."""
    import json
    import os

    import torch.distributed as dist

    from tpusr_torch.dist import bootstrap
    from tpusr_torch.train import SupervisedSRTrainer

    if device == "cpu":
        torch.set_num_threads(1)
    assert not bootstrap.is_initialized()
    try:
        assert bootstrap.initialize(f"localhost:{port}", 2, pid, device=device)
        assert bootstrap.is_initialized()
        dev = resolve_device(device)
        mesh = bootstrap.global_mesh(("data",), device=dev)
        local = torch.full((4, 2), float(pid + 1))
        total = float(bootstrap.process_local_batch(mesh, local).sum())
        rng = np.random.default_rng(7)
        xs = rng.random((8, 8, 8, 3), dtype=np.float32)
        ys = rng.random((8, 16, 16, 3), dtype=np.float32)
        half = slice(4 * pid, 4 * pid + 4)
        xg = bootstrap.process_local_batch(mesh, xs[half])
        yg = bootstrap.process_local_batch(mesh, ys[half])

        def loss(m, x, y):
            tr = SupervisedSRTrainer(
                EDSR(scale_factor=2, num_res_blocks=1, num_filters=8,
                     device=dev, key=7),
                learning_rate=1e-3, mesh=m, device=dev)
            return float(tr.train_step(tr.init_state(), x, y)[1]["loss"])
        res = {"psum_total": total, "dp_loss": loss(mesh, xg, yg),
               "single_loss": loss(None, torch.as_tensor(xs, device=dev),
                                   torch.as_tensor(ys, device=dev)),
               "mesh_2d": list(bootstrap.global_mesh(
                   ("data", "model"), shape=(1, 2), device=dev).mesh.shape),
               "hybrid": list(bootstrap.hybrid_mesh(device=dev).mesh.shape)}
        try:
            bootstrap.global_mesh(("data",), shape=(3,), device=dev)
        except ValueError as e:
            res["bad_shape"] = str(e)
        with open(os.path.join(out_dir, f"c{pid}.json"), "w") as f:
            json.dump(res, f)
        # process 0 hosts the store: none leaves while the other still
        # builds its groups
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_bootstrap_2proc(device: str = "cuda") -> dict:
    """Two processes joined by ``dist.bootstrap.initialize`` on a free local
    port: the cross-process sum and the DP loss, equal on both and to the
    single-process step. Returns process 0's numbers."""
    import json
    import os
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as td:
        spawn(_bootstrap_rank, 2, (port, device, td))
        res = [json.load(open(os.path.join(td, f"c{i}.json")))
               for i in range(2)]
    assert res[0]["psum_total"] == res[1]["psum_total"] == 24.0, res
    assert res[0]["dp_loss"] == res[1]["dp_loss"], res
    assert abs(res[0]["dp_loss"] - res[0]["single_loss"]) <= \
        1e-5 * res[0]["single_loss"], res
    print(f"bootstrap 2-process: psum={res[0]['psum_total']} "
          f"dp_loss={res[0]['dp_loss']:.6f} OK", flush=True)
    return res[0]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: the DP GAN
    step, the DP fused pipeline, the trunk and the guarded cascade with 3
    pad rows, a DP x TP step, full-image SR with the rows split and a PP
    step, on ``n_devices`` ranks, each equal to the same call unsharded;
    then the 2-process bootstrap. Raises on any disagreement.

    One process per rank (spawned): on ``cuda`` one card each over NCCL, or,
    where the machine has fewer cards than ranks, all on card 0 over gloo,
    which carries no send/recv of CUDA tensors, so SP and PP are then
    skipped and say so (as the bootstrap is on a machine of one card). CPU
    ranks (gloo) run only for ``device="cpu"``."""
    import os
    import tempfile

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        backend, p2p = "nccl", True
    else:
        backend, p2p = "gloo", dev.type == "cpu"
    with tempfile.TemporaryDirectory() as td:
        spawn(_dryrun_rank, n_devices, (n_devices, dev.type,
                                        os.path.join(td, "init"), backend,
                                        p2p))
    if dev.type == "cuda" and torch.cuda.device_count() < 2:
        print("bootstrap 2-process: SKIPPED (one card, and NCCL takes one "
              "process a card)", flush=True)
    else:
        dryrun_bootstrap_2proc(dev.type)
