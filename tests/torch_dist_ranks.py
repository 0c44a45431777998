"""Gloo ranks on the CPU for the port's parallelism tests
(tests/test_torch_dist_*.py). Imports no JAX: every rank is a fresh process
that imports torch and tpusr_torch only.

``run_ranks(suite, world, tmp_path, *args)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), joins them into one gloo group through a
file under ``tmp_path`` (no port to collide under xdist), runs
``suite(rank, world, *args)`` with one thread each, and returns each rank's
result (a dict of numpy arrays, numbers and strings). The suites below run
every sharded path of one test file in one start, and report what the test
compares against its single-device run and JAX's.
"""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpusr_torch.dist.bootstrap import spawn

TIMEOUT_S = 240


def _entry(rank, world, init_file, out_dir, suite, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = suite(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(suite, world: int, tmp_path, *args) -> list:
    out_dir = os.path.join(str(tmp_path), f"ranks_{suite.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "init")
    spawn(_entry, world, (world, init_file, out_dir, suite, args), TIMEOUT_S)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy().copy()


def _np_dict(d: dict) -> dict:
    return {k: _np(v) for k, v in d.items()}


# ------------------------------------------------------------ DP (sharding)

def dp_suite(rank, world, sr, clf, gan, pipe):
    """test_torch_dist_sharding.py: the mesh, shard_batch, the DP steps of
    both trainers and the GAN trainer, a fit with a partial trailing batch,
    the DP fused pipeline. Each case returns the sharded result and the same
    call without a mesh on this rank."""
    from tpusr_torch.bridge import (edsr_from_flax, srcnn_from_flax,
                                    vgg16_from_flax)
    from tpusr_torch.models import (ESRGANDiscriminator, ESRGANGenerator,
                                    VGG19Features)
    from tpusr_torch.dist import make_mesh, shard_batch, batch_sharding
    from tpusr_torch.dist.mesh import axis_size
    from tpusr_torch.train import (ClassifierTrainer, ESRGANTrainer,
                                   SupervisedSRTrainer)

    out = {}
    mesh = make_mesh(device="cpu")
    out["mesh"] = (axis_size(mesh, "data"), tuple(mesh.mesh_dim_names))
    xs = shard_batch(mesh, np.ones((16, 8, 8, 3), np.float32))
    out["shard_rows"] = xs.shape[0]
    out["batch_sharding"] = batch_sharding(mesh, ndim=4).spec

    # SRCNN: one DP step == the single-device step
    def srcnn_step(m):
        tr = SupervisedSRTrainer(srcnn_from_flax(sr["srcnn"], device="cpu"),
                                 learning_rate=1e-3, mesh=m, device="cpu")
        st, met = tr.train_step(tr.init_state(), torch.from_numpy(sr["x"]),
                                torch.from_numpy(sr["y"]))
        return float(met["loss"]), _np_dict(st.params)
    out["srcnn"] = {"dp": srcnn_step(mesh), "single": srcnn_step(None)}

    # EDSR x4 (clipnorm): the loss and every gradient leaf
    def edsr_grads(m):
        tr = SupervisedSRTrainer(
            edsr_from_flax(sr["edsr"], 4, device="cpu"),
            learning_rate=1e-3, clipnorm=1.0, mesh=m, device="cpu")
        loss, _, g = tr.value_and_grad(tr.init_state(),
                                       torch.from_numpy(sr["x4"]),
                                       torch.from_numpy(sr["y4"]))
        return float(loss), _np_dict(g)
    out["edsr"] = {"dp": edsr_grads(mesh), "single": edsr_grads(None)}

    # a fit whose trailing batch is partial (10 rows, batch 4)
    def fit(m):
        tr = SupervisedSRTrainer(srcnn_from_flax(sr["srcnn"], device="cpu"),
                                 learning_rate=3e-2, mesh=m, device="cpu")
        res = tr.fit(sr["fx"], sr["fy"], sr["vx"], sr["vy"], batch_size=4,
                     epochs=3, seed=3, verbose=False)
        return res.history, _np_dict(res.state.params)
    out["fit"] = {"dp": fit(mesh), "single": fit(None)}

    # VGG16 with dropout: one DP step == the single-device step
    def clf_step(m):
        tr = ClassifierTrainer(vgg16_from_flax(clf["params"], device="cpu",
                                               dropout_rate=0.5),
                               learning_rate=1e-3, l2_reg=1e-3, mesh=m,
                               device="cpu")
        st, met = tr.train_step(tr.init_state(), torch.from_numpy(clf["x"]),
                                torch.from_numpy(clf["y"]), 7)
        return float(met["loss"]), float(met["accuracy"]), _np_dict(st.params)
    out["clf"] = {"dp": clf_step(mesh), "single": clf_step(None)}

    # the GAN step (g4 x2 from a seed, a narrow VGG19)
    def gan_step(m):
        s = gan["seed"]
        gen = ESRGANGenerator(scale_factor=2, growth_channels=4,
                              num_rrdb_blocks=1, base_filters=8, device="cpu",
                              key=s)
        disc = ESRGANDiscriminator(device="cpu", key=s + 1)
        vgg = VGG19Features(widths=(4, 4, 4, 4, 4), device="cpu", key=s + 2)
        tr = ESRGANTrainer(gen, disc, vgg, mesh=m, device="cpu")
        st, met = tr.train_step(tr.init_state(), torch.from_numpy(gan["lr"]),
                                torch.from_numpy(gan["hr"]))
        val = tr.val_step(st, torch.from_numpy(gan["lr"][:3]),
                          torch.from_numpy(gan["hr"][:3]))
        return ({k: float(v) for k, v in met.items()},
                {k: float(v) for k, v in val.items()},
                _np_dict(st.g_params), _np_dict(st.d_spectral))
    out["gan"] = {"dp": gan_step(mesh), "single": gan_step(None)}

    # the fused pipeline: per-patch f32 classifier behind EDSR x2
    from tpusr_torch.pipeline import FusedSRClassifyPipeline

    edsr = edsr_from_flax(pipe["edsr"], 2, device="cpu")
    vgg = vgg16_from_flax(pipe["clf"], device="cpu")

    def fused(m):
        p = FusedSRClassifyPipeline(edsr, clf_apply=vgg, lr_hw=(16, 16),
                                    scale=2, patch=32, stride=16, mesh=m,
                                    device="cpu")
        sr_, cls, conf = p(pipe["lr"])
        return _np(sr_), _np(cls), _np(conf)
    out["fused"] = {"dp": fused(mesh), "single": fused(None)}
    return out


# ------------------------------------------------------- TP and the cascade

def tp_suite(rank, world, tp):
    """test_torch_dist_tp.py, on a (2, 2) ('data', 'model') mesh: VGG16 and
    EDSR forwards with channel-sharded parameters, a DP x TP SRCNN step and
    an EDSR x4 step with clipnorm, each beside the same call without a
    mesh."""
    from tpusr_torch.bridge import (edsr_from_flax, srcnn_from_flax,
                                    vgg16_from_flax)
    from tpusr_torch.dist import make_tp_mesh, shard_params_tp
    from tpusr_torch.dist.tp import gather_params_tp, tp_apply
    from tpusr_torch.train import SupervisedSRTrainer

    mesh = make_tp_mesh(2, 2, device="cpu")
    out = {}
    vgg = vgg16_from_flax(tp["vgg"], device="cpu")
    params = dict(vgg.named_parameters())
    x = torch.from_numpy(tp["vgg_x"])
    out["vgg"] = (_np(tp_apply(mesh, vgg, shard_params_tp(mesh, params), x)),
                  _np(vgg(x)))
    out["vgg_sharded"] = sorted(
        k for k, v in shard_params_tp(mesh, params).items()
        if v.shape != params[k].shape)
    out["vgg_gathered"] = all(torch.equal(v, params[k]) for k, v in
                              gather_params_tp(mesh, shard_params_tp(
                                  mesh, params), vgg).items())
    edsr = edsr_from_flax(tp["edsr"], 2, device="cpu")
    x = torch.from_numpy(tp["edsr_x"])
    out["edsr"] = (_np(tp_apply(mesh, edsr, shard_params_tp(
        mesh, dict(edsr.named_parameters())), x)), _np(edsr(x)))

    def step(model, m, x, y, **kw):
        tr = SupervisedSRTrainer(model, mesh=m, device="cpu", **kw)
        st = tr.init_state()
        if m is not None:
            st = shard_params_tp(m, st)
        st, met = tr.train_step(st, torch.from_numpy(x), torch.from_numpy(y))
        return float(met["loss"]), _np_dict(st.params)

    for name, make, kw in (
            ("srcnn", lambda: srcnn_from_flax(tp["srcnn"], device="cpu"), {}),
            ("edsr4", lambda: edsr_from_flax(tp["edsr4"], 4, device="cpu"),
             {"clipnorm": 1e-3, "learning_rate": 1e-3})):
        x, y = tp[f"{name}_x"], tp[f"{name}_y"]
        out[name] = (step(make(), mesh, x, y, **kw),
                     step(make(), None, x, y, **kw))
    return out


def _stub_cascade(tables):
    """The cascade's trunk, quantizer and per-patch path replaced by table
    lookups keyed by each image's mean (tests/test_sharding.py's stubs):
    every rank sees only its rows, so the stubs find them by value."""
    import tpusr_torch.pipeline.cascade as casc

    means = torch.from_numpy(tables["img_means"])

    def rows(x):
        m = x.float().mean(dim=(1, 2, 3))
        return torch.argmin((m[:, None] - means[None]).abs(), dim=1)

    trunk = torch.from_numpy(tables["trunk"])
    pp = torch.from_numpy(tables["pp"])
    casc.quantize_input = lambda q, x: x
    casc.shared_trunk_probs_int8 = lambda q, x, p, s: trunk[rows(x)]

    class Stubbed(casc.CascadeVotes):
        def per_patch_probs(self, images):
            return pp[rows(images)][:, None, :]
    return Stubbed


def cascade_suite(rank, world, tables, net):
    """test_torch_dist_pipeline.py, on a 2-rank 'data' mesh: the cascade on
    the stub tables (both scores, with and without pad rows, the guard at
    0.0, 0.6 and 1.01) and the shipped serving mode on narrow networks,
    sharded and whole."""
    from tpusr_torch.bridge import edsr_from_flax, vgg16_from_flax
    from tpusr_torch.dist import make_mesh
    from tpusr_torch.dist.mesh import batch_shard
    from tpusr_torch.pipeline import make_serving_pipeline

    mesh = make_mesh(device="cpu")
    Stubbed = _stub_cascade(tables)
    imgs = torch.from_numpy(tables["imgs"])
    out = {}
    for score, guard, n_valid in tables["cases"]:
        votes = Stubbed({}, 2, 2, 0.25, score, guard)
        shard = batch_shard(mesh, imgs.shape[0])
        cls, conf = votes(shard.take(imgs), n_valid, shard=shard)
        sharded = (_np(shard.gather(cls)), _np(shard.gather(conf)),
                   votes.guard_trips, _np(votes.last_escalated))
        votes = Stubbed({}, 2, 2, 0.25, score, guard)
        cls, conf = votes(imgs, n_valid)
        out[(score, guard, n_valid)] = (sharded, (
            _np(cls), _np(conf), votes.guard_trips, _np(votes.last_escalated)))

    edsr = edsr_from_flax(net["edsr"], 2, device="cpu")
    vgg = vgg16_from_flax(net["clf"], device="cpu")
    served = {}
    for m in (mesh, None):
        pipe = make_serving_pipeline(
            edsr, vgg, lr_hw=(16, 16), scale=2, patch=32, stride=16,
            sr_mode="f32", clf_mode="cascade_int8",
            calib_patches=net["calib"], cascade_escalate_score="vote_frac",
            cascade_guard_threshold=net["guard"], mesh=m, device="cpu")
        sr, cls, conf = pipe(net["lr"], n_valid=net["n_valid"])
        served["dp" if m is not None else "single"] = (
            _np(sr), _np(cls), _np(conf), pipe.cascade_votes.guard_trips)
    out["served"] = served
    return out


# ------------------------------------------------------------------- PP

def pp_suite(rank, world, pp):
    """test_torch_dist_pp.py on 4 ranks: the pipelined EDSR forward over 4
    stages, the x3/x4 tails and DP x PP over ('data', 'stage') = (2, 2), the
    validation error, and the PP train steps' loss and gradients."""
    from tpusr_torch.bridge import edsr_from_flax
    from tpusr_torch.dist import (make_pp_edsr_apply, make_pp_mesh,
                                  make_pp_train_step)

    out = {}
    mesh4 = make_pp_mesh(n_stages=4, device="cpu")
    mesh22 = make_pp_mesh(n_stages=2, n_data=2, device="cpu")
    for name, (tree, scale, mesh_name, n_micro, data_axis) in pp["fwd"].items():
        model = edsr_from_flax(pp["trees"][tree], scale, device="cpu")
        mesh = mesh4 if mesh_name == "4" else mesh22
        apply = make_pp_edsr_apply(model, mesh, n_micro=n_micro,
                                   data_axis=data_axis)
        x = torch.from_numpy(pp["x"][name])
        out[name] = _np(apply(dict(model.named_parameters()), x))
    model = edsr_from_flax(pp["trees"]["b8"], 2, device="cpu")
    try:
        make_pp_edsr_apply(model, mesh4, n_micro=5)(
            dict(model.named_parameters()), torch.zeros(12, 8, 8, 3))
    except ValueError as e:
        out["error"] = str(e)
    for name, (tree, mesh_name, n_micro, lr, data_axis) in pp["train"].items():
        model = edsr_from_flax(pp["trees"][tree], 2, device="cpu")
        mesh = mesh4 if mesh_name == "4" else mesh22
        step = make_pp_train_step(model, mesh, n_micro=n_micro,
                                  learning_rate=lr, data_axis=data_axis)
        params = dict(model.named_parameters())
        x, y = torch.from_numpy(pp["tx"]), torch.from_numpy(pp["ty"])
        new, loss = step(params, x, y)
        _, grads = step.value_and_grad(params, x, y)
        out[name] = (float(loss), _np_dict(new), _np_dict(grads))
    return out


# ------------------------------------------------------------------- SP

def sp_suite(rank, world, sp):
    """test_torch_dist_spatial.py on 2 ranks: ring attention against the
    dense layer, its divisibility error, full-image SR with the rows split
    (halo convs + the ring) against the dense generator, and
    ``super_resolve_full_image(mesh=)`` on a divisible and an indivisible
    image."""
    from tpusr_torch.bridge import esrgan_generator_from_flax
    from tpusr_torch.dist import (full_image_esrgan_sr, make_mesh,
                                  make_ring_attention)
    from tpusr_torch.models.init import ParamRng
    from tpusr_torch.models.layers import SelfAttention
    from tpusr_torch.pipeline.inference import super_resolve_full_image

    mesh = make_mesh(device="cpu")
    out = {}
    attn = SelfAttention(16, rng=ParamRng(device="cpu"))
    attn.load_state_dict({k: torch.from_numpy(v)
                          for k, v in sp["attn"].items()})
    x = torch.from_numpy(sp["attn_x"])
    with torch.no_grad():
        ring = make_ring_attention(mesh)
        out["ring"] = (_np(attn.attend(x, None, ring)), _np(attn(x)))
    bad = torch.zeros(1, 13, 4)
    try:
        ring(bad, bad, bad)
    except ValueError as e:
        out["ring_error"] = str(e)
    gen = esrgan_generator_from_flax(sp["gen"], device="cpu")
    img = torch.from_numpy(sp["img"])
    with torch.no_grad():
        out["full"] = (_np(full_image_esrgan_sr(gen, img, mesh)), _np(gen(img)))
    for name in ("lr16", "lr17"):
        out[name] = super_resolve_full_image(gen, sp[name], mesh=mesh)[0]
        out[name + "_single"] = super_resolve_full_image(gen, sp[name])[0]
    return out
