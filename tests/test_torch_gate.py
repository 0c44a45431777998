"""The port's serving gate (tpusr_torch/tools/serving_gate.py) against
tpusr/tools/serving_gate.py on the CPU.

- The numpy layer (row names, the derived cascade rows, the rank analysis,
  the comparison and the cross-seed aggregate) equals JAX's exactly.
- ``build_surface_images``, given JAX's own draws, gives JAX's images; its
  bicubic upsample is ``jax.image.resize``'s.
- The vote paths and ``run_gate`` run on the same images and weights in
  both packages: a narrow VGG16 (widths (8, 8, 16, 16, 16), dense 256)
  trained by the port's ``train_classifier`` for 300 steps and an EDSR x4 of
  one block of 8 filters trained by ``SupervisedSRTrainer`` for 150 steps,
  both on the port's hard-task images of 128^2, carried to JAX by
  ``to_flax_tree``. They are away from the class tie: on the 8 eval images
  the f32 reference path votes [0, 0, 1, 0, 1, 0, 0, 0] against labels
  [0, 0, 1, 1, 1, 0, 0, 1] (accuracy 0.75), one boundary image.
"""

import copy
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_edsr_quant import BAND_ATOL, BAND_MIN_PSNR
from test_torch_fixtures import to_numpy
from tpusr_torch.bridge import to_flax_tree
import tpusr.models.vgg as jvgg
import tpusr.tools.serving_gate as jsg
from tpusr.models import edsr_quant as jeq
from tpusr.models import quant as jq
from tpusr.models.edsr_fast import make_fused_sr_apply as jax_fused
from tpusr.models.layers import pixel_shuffle as jax_pixel_shuffle
from tpusr.models.vgg_trunk import (shared_trunk_probs_f32 as jax_trunk_f32,
                                    shared_trunk_probs_int8 as jax_trunk_int8)
import tpusr_torch.tools.serving_gate as tsg
from tpusr_torch.bridge import edsr_qtree_from_flax, qtree_from_flax
from tpusr_torch.core.resize import resize
from tpusr_torch.models import edsr_quant as teq
from tpusr_torch.models.edsr_fast import make_fused_sr_apply
from tpusr_torch.models.quant import per_patch_int8_probs
from tpusr_torch.models.vgg_trunk import (shared_trunk_probs_f32,
                                          shared_trunk_probs_int8)
from tpusr_torch.train import SupervisedSRTrainer

WIDTHS = (8, 8, 16, 16, 16)
SIZE, N_TRAIN, N_EVAL = 128, 16, 8
HARD = tsg.TASKS["hard"]
F32_SR_ROWS = ("int8_per_patch", "shared_trunk_f32", "shared_trunk_int8")
SR_ROWS = ("int8_sr_f32_per_patch", "int8_sr_per_patch_int8",
           "int8_sr_shared_trunk_int8", "int8_sr_noborder_shared_trunk_int8",
           "bf16_sr_per_patch_int8", "bf16_sr_shared_trunk_int8")


@pytest.fixture(scope="module", autouse=True)
def threads_per_worker():
    """Under pytest-xdist, this worker's share of the intra-op threads while
    the module's tests run: beside the other workers, torch's default of a
    thread per core oversubscribes the host and the CPU training here slows
    by an order of magnitude. A run in one process keeps the default."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


def _narrow_jax_vgg(mp):
    mp.setattr(jvgg, "_VGG16_CFG", tuple(
        (b, n, w) for (b, n, _f), w in zip(jvgg._VGG16_CFG, WIDTHS)))


@pytest.fixture(scope="module")
def trained():
    """Hard-task images from the port's generator and narrow networks
    trained on them by the port: (hr_train, y_train, hr_eval, y_eval,
    calibration crops, VGG16, its flax tree, EDSR, its flax tree)."""
    hr, y = tsg.make_surface_images(0, N_TRAIN, SIZE, HARD["amp_range"],
                                    HARD["noise"], HARD["coverage_range"],
                                    device="cpu")
    hr_eval, y_eval = tsg.make_surface_images(
        1, N_EVAL, SIZE, HARD["amp_range"], HARD["noise"],
        HARD["coverage_range"], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsg, "VGG16Classifier", functools.partial(
            tsg.VGG16Classifier, widths=WIDTHS))
        vgg, _ = tsg.train_classifier(hr, y, steps=300, batch=16)
    edsr = tsg.EDSR(scale_factor=4, num_res_blocks=1, num_filters=8,
                        device="cpu",
                        generator=torch.Generator().manual_seed(tsg.INIT_SEED))
    trainer = SupervisedSRTrainer(edsr, learning_rate=5e-3, device="cpu")
    state = trainer.init_state()
    lr = resize(hr, (SIZE // 4, SIZE // 4), "area")
    for step in range(150):
        sel = torch.randint(0, N_TRAIN, (4,),
                            generator=torch.Generator().manual_seed(step))
        state, _ = trainer.train_step(state, lr[sel], hr[sel])
    edsr = tsg._with_params(edsr, state)
    calib = tsg.make_crop_pool(300, hr, y, 32, tsg.PATCH)[0]
    return {"hr": hr, "y": y, "hr_eval": hr_eval, "y_eval": y_eval,
            "calib": calib, "vgg": vgg,
            "cv": to_flax_tree(dict(vgg.named_parameters())), "edsr": edsr,
            "ev": to_flax_tree(dict(edsr.named_parameters()))}


# ------------------------------------------------------------ numpy layer
def _numpy_case(name):
    """(function name, args, kwargs) of one numpy-layer case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 37
    ref_cls = rng.integers(0, 2, n)
    ref_conf = np.round(rng.uniform(0.5, 1.0, n), 4)
    labels = rng.integers(0, 2, n)
    trunk = (np.where(rng.random(n) < 0.2, 1 - ref_cls, ref_cls),
             np.round(rng.uniform(0.5, 1.0, n), 4))
    pp = (np.where(rng.random(n) < 0.05, 1 - ref_cls, ref_cls),
          np.round(rng.uniform(0.5, 1.0, n), 4))
    scores = {"vote_frac": rng.integers(50, 101, n) / 100.0,
              "mean_margin": np.round(rng.uniform(0, 1, n), 4)}
    f32_pair = {"shared_trunk_int8": trunk, "int8_per_patch": pp}
    bf16_pair = {"bf16_sr_shared_trunk_int8": trunk,
                 "bf16_sr_per_patch_int8": pp}
    # a collapsed trunk: every image flipped, so each canary is 1.0 (>= 0.6)
    collapsed = {"shared_trunk_int8": (1 - pp[0], trunk[1]),
                 "int8_per_patch": pp}
    cases = {
        "compare": ("_compare", ("m", ref_cls, ref_conf, trunk[0], trunk[1],
                                 labels), {}),
        "compare_no_boundary": ("_compare", ("m", ref_cls, ref_conf + 1.0,
                                             pp[0], pp[1], labels), {}),
        "derive_f32_pair": ("derive_cascade_modes",
                            (f32_pair, ref_cls, ref_conf, labels), {}),
        "derive_f32_pair_scores": (
            "derive_cascade_modes", (f32_pair, ref_cls, ref_conf, labels),
            {"trunk_scores": scores, "n_patches": 100}),
        "derive_bf16_pair_scores": (
            "derive_cascade_modes", (bf16_pair, ref_cls, ref_conf, labels),
            {"trunk_scores": scores, "n_patches": 100,
             "parents": jsg.CASCADE_PARENTS["bf16_sr_cascade_int8"],
             "prefix": "bf16_sr_cascade_int8"}),
        "derive_canary_over_guard": (
            "derive_cascade_modes", (collapsed, ref_cls, ref_conf, labels),
            {"trunk_scores": scores}),
        "derive_missing_parent": (
            "derive_cascade_modes", ({"int8_per_patch": pp}, ref_cls,
                                     ref_conf, labels), {}),
        "rank_analysis": ("cascade_rank_analysis",
                          (f32_pair, ref_cls, scores), {"n_patches": 100}),
        "rank_analysis_bf16": (
            "cascade_rank_analysis", (bf16_pair, ref_cls, scores),
            {"trunk_mode": "bf16_sr_shared_trunk_int8"}),
        "rank_analysis_no_scores": ("cascade_rank_analysis",
                                    (f32_pair, ref_cls, None), {}),
        "lex_score": ("_lex_score", (scores["vote_frac"], trunk[1], 100), {}),
    }
    if name == "aggregate_runs":
        runs = []
        for seed in (0, 1, 2):
            modes = [jsg._compare(m, ref_cls, ref_conf, *v, labels)
                     for m, v in f32_pair.items()]
            modes += jsg.derive_cascade_modes(f32_pair, ref_cls, ref_conf,
                                              labels, trunk_scores=scores)
            for m in modes:
                m["passes_gate"] = m["vote_agreement"] >= 0.99
            modes[0]["image_faithful"] = seed != 1
            runs.append({"seed": seed, "protocol": {"images": n},
                         "reference_accuracy": 0.9 - 0.01 * seed,
                         "reference_boundary_images": seed,
                         "modes": modes[seed:]})
            ref_cls = 1 - ref_cls if seed == 1 else ref_cls
        return "aggregate_runs", (runs,), {}
    return cases[name]


GATE_ROW_CASES = [
    ("f32", "per_patch_int8", True), ("f32", "shared_trunk_f32", True),
    ("f32", "shared_trunk_int8", True), ("bf16", "per_patch_int8", True),
    ("bf16", "shared_trunk_int8", True), ("int8", "per_patch_f32", True),
    ("int8", "per_patch_int8", True), ("int8", "shared_trunk_int8", True),
    ("int8", "shared_trunk_int8", False),
    ("f32", "cascade_int8", True, "vote_frac", 0.25, True),
    ("bf16", "cascade_int8", True, "conf", 0.28125, False),
    ("f32", "cascade_int8", True, "vote_frac", 0.25, False),
    # the ones that raise
    ("int8", "cascade_int8", True, "conf", 0.25, False),
    ("f32", "cascade_int8", True, "conf", None, False),
    ("f32", "per_patch_f32", True), ("bf16", "shared_trunk_f32", True),
    ("f32", "shared_trunk_int8", False),
]


def _call(mod, fname, args, kwargs):
    try:
        return "ok", getattr(mod, fname)(*copy.deepcopy(args),
                                         **copy.deepcopy(kwargs))
    except ValueError as e:
        return "raised", str(e)


@pytest.mark.parametrize("case", [
    "compare", "compare_no_boundary", "derive_f32_pair",
    "derive_f32_pair_scores", "derive_bf16_pair_scores",
    "derive_canary_over_guard", "derive_missing_parent", "rank_analysis",
    "rank_analysis_bf16", "rank_analysis_no_scores", "lex_score",
    "aggregate_runs", "constants",
    *(f"gate_row_name{i}" for i in range(len(GATE_ROW_CASES)))])
def test_numpy_layer_equals_jax(case):
    if case == "constants":
        for name in ("PATCH", "STRIDE", "BOUNDARY_CONF", "CASCADE_THRESHOLDS",
                     "CASCADE_FRACS", "CASCADE_GUARD_THRESHOLD",
                     "CASCADE_PARENTS", "TASKS"):
            assert getattr(tsg, name) == getattr(jsg, name), name
        return
    if case.startswith("gate_row_name"):
        args = GATE_ROW_CASES[int(case[len("gate_row_name"):])]
        fname, kwargs = "gate_row_name", {}
    else:
        fname, args, kwargs = _numpy_case(case)
    got, want = _call(tsg, fname, args, kwargs), _call(jsg, fname, args, kwargs)
    if isinstance(want[1], np.ndarray):
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    else:
        assert got == want
    if case == "derive_canary_over_guard":
        guarded = [r for r in got[1] if "+guard]" in r["mode"]]
        assert guarded and all(r["guard_triggered"] for r in guarded)
        assert all(r["escalation_fraction"] == 1.0 for r in guarded)
    if case.startswith("gate_row_name") and len(args) > 3:
        assert got[0] == ("raised" if args[0] == "int8" or args[4] is None
                          else "ok")


@pytest.mark.parametrize("classes", [2, 3])
def test_vote_scores_matches_jax_on_ties(classes):
    rng = np.random.default_rng(classes)
    probs = rng.dirichlet(np.ones(classes), (6, 10)).astype(np.float32)
    probs[0] = probs[0, :1]                 # every patch equal
    probs[1, :, :] = 1.0 / classes          # every patch at an exact tie
    # votes split 5/5, the tie broken by the higher mean probability
    half = np.eye(classes, dtype=np.float32)[np.arange(10) % 2]
    probs[2] = (0.9 - 0.2 * (np.arange(10) % 2))[:, None] * half
    probs[2] += (1.0 - probs[2].sum(-1, keepdims=True)) / classes
    want = jax.vmap(jsg._vote_scores)(jnp.asarray(probs))
    got = tsg._vote_scores(torch.from_numpy(probs))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------- dataset
def _jax_draws(seed, n, size, amp_range, coverage_range):
    """make_surface_images's draws, from JAX's own key split, in a jit as
    JAX's ``make_surface_images`` draws them."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 9)
    cells = size // 32 + 1

    @jax.jit
    def draw():
        def u(k, shape, lo, hi):
            return jax.random.uniform(ks[k], shape, minval=lo, maxval=hi)
        return {"bg_small": u(0, (n, cells, cells, 1), 0.3, 0.7),
                "theta": u(1, (n,), 0.0, np.pi),
                "period": u(2, (n,), 32.0, 64.0),
                "phase": u(3, (n,), 0.0, 2 * np.pi),
                "amp": u(4, (n,), *amp_range),
                "nz": jax.random.normal(ks[5], (n, size, size, 3)),
                "order": jax.random.permutation(ks[6], n),
                "cov": u(7, (n,), *coverage_range),
                "phi": u(8, (n,), 0.0, np.pi)}
    return {k: torch.from_numpy(np.array(v)) for k, v in draw().items()}


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("task", ["easy", "hard"])
def test_surface_images_from_jax_draws_match_jax(task, size):
    t = jsg.TASKS[task]
    want, want_labels = jsg.make_surface_images(5, 8, size, t["amp_range"],
                                                t["noise"], t["coverage_range"])
    got, labels = tsg.build_surface_images(
        _jax_draws(5, 8, size, t["amp_range"], t["coverage_range"]), size,
        t["noise"])
    assert got.dtype == torch.float32 and labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"{task} {size}^2: max |d| {err:.3g}")
    assert err <= 1e-6


@pytest.mark.parametrize("sizes", [(17, 512), (5, 128)])
def test_bicubic_upsample_matches_jax_image_resize(sizes):
    a, b = sizes
    x = np.random.default_rng(a).random((2, a, a, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, b, b, 3),
                                       "bicubic"))
    got = tsg._bicubic_upsample(torch.from_numpy(x), b).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="enlarging"):
        tsg._bicubic_weights(b, a)


def test_port_surface_images_are_balanced_seeded_and_labelled():
    img, labels = tsg.make_surface_images(3, 8, 128, device="cpu")
    assert img.shape == (8, 128, 128, 3) and img.dtype == torch.float32
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
    assert sorted(np.bincount(labels.numpy()).tolist()) == [4, 4]
    np.testing.assert_array_equal(labels.numpy(), tsg.surface_labels(3, 8))
    again, _ = tsg.make_surface_images(3, 8, 128, device="cpu")
    assert torch.equal(img, again)
    other, other_labels = tsg.make_surface_images(4, 8, 128, device="cpu")
    assert not torch.equal(img, other)
    np.testing.assert_array_equal(other_labels.numpy(), tsg.surface_labels(4, 8))
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tsg.make_surface_images(3, 2, 64)


def test_partial_coverage_masks_stripes():
    """tests/test_serving_gate.py::test_partial_coverage_masks_stripes on the
    port's generator: the same draws with another coverage change only the
    defect images' stripe band."""
    full, labels_f = tsg.make_surface_images(3, 8, 128, coverage_range=(1.0, 1.0),
                                             device="cpu")
    part, labels_p = tsg.make_surface_images(3, 8, 128, coverage_range=(0.3, 0.4),
                                             device="cpu")
    assert torch.equal(labels_f, labels_p)
    lab = labels_f.numpy()
    d = np.abs(full.numpy() - part.numpy())
    assert (d.max(axis=(1, 2, 3))[lab == 0] == 0).all()
    frac = (d > 1e-6).any(-1).mean(axis=(1, 2))
    assert (frac[lab == 1] > 0.2).all() and (frac[lab == 1] < 0.95).all()


def test_crop_pool_gathers_aligned_crops():
    img, labels = tsg.make_surface_images(0, 4, 64, device="cpu")
    crops, cl, (idx, y0, x0) = tsg.make_crop_pool(7, img, labels, 12, 32,
                                                  align=4)
    assert crops.shape == (12, 32, 32, 3)
    assert bool(((y0 % 4 == 0) & (x0 % 4 == 0) & (y0 <= 32) & (x0 <= 32)).all())
    for i in range(12):
        assert torch.equal(crops[i], img[idx[i], y0[i]:y0[i] + 32,
                                         x0[i]:x0[i] + 32])
    assert torch.equal(cl, labels[idx])
    again = tsg.make_crop_pool(7, img, labels, 12, 32, align=4)[0]
    assert torch.equal(crops, again)


# -------------------------------------------------------------- vote paths
def test_vote_paths_match_jax_with_a_remainder_chunk(trained, monkeypatch):
    """n = 3 images in chunks of 2 (a full chunk and a remainder) through
    each vote path and ``_apply_sr``, on the same weights, images and int8
    tree in both packages: classes equal, confidences and scores within
    1e-5."""
    _narrow_jax_vgg(monkeypatch)
    cv, vgg, ev, edsr = (trained[k] for k in ("cv", "vgg", "ev", "edsr"))
    lr = resize(trained["hr_eval"][:3], (SIZE // 4, SIZE // 4), "area")
    fj, r = jax_fused(ev, 4, dtype=jnp.float32)
    sr_j = jsg._apply_sr(fj, r, jnp.asarray(lr.numpy()), chunk=2)
    ft, rt = make_fused_sr_apply(edsr)
    sr_t = tsg._apply_sr(ft, rt, lr, chunk=2)
    np.testing.assert_allclose(sr_t.numpy(), np.asarray(sr_j), rtol=0,
                               atol=1e-5)
    sr = sr_t.numpy()
    qj = jq.quantize_vgg16(cv, jq.calibrate_vgg16(
        cv, jnp.asarray(trained["calib"].numpy())))
    qt = qtree_from_flax(jax.tree.map(np.asarray, qj), device="cpu")
    model = jvgg.VGG16Classifier(num_classes=2)
    paths = {
        "per_patch_f32": (
            lambda: jsg.per_patch_votes(
                lambda p: model.apply({"params": cv}, p), jnp.asarray(sr), 2),
            lambda: tsg.per_patch_votes(tsg.patch_probs(vgg), sr_t, 2)),
        "per_patch_int8": (
            lambda: jsg.per_patch_votes(
                lambda p: jq.quantized_vgg16_apply(qj, p), jnp.asarray(sr), 2),
            lambda: tsg.per_patch_votes(
                lambda b: per_patch_int8_probs(qt, b), sr_t, 2)),
        "trunk_f32": (
            lambda: jsg.shared_trunk_votes(
                lambda b: jax_trunk_f32(cv, b), jnp.asarray(sr), 2),
            lambda: tsg.shared_trunk_votes(
                lambda b: shared_trunk_probs_f32(vgg, b), sr_t, 2)),
        "trunk_int8_scores": (
            lambda: jsg.shared_trunk_votes(
                lambda b: jax_trunk_int8(qj, b), jnp.asarray(sr), 2,
                with_scores=True),
            lambda: tsg.shared_trunk_votes(
                lambda b: shared_trunk_probs_int8(qt, b), sr_t, 2,
                with_scores=True)),
    }
    for name, (jax_fn, port_fn) in paths.items():
        if "int8" in name:
            # int8 paths against JAX run op by op: under jit XLA's CPU
            # backend contracts f32 multiply-adds into FMAs, which moves
            # single int8 values (ROADMAP.md, queue 3)
            with jax.disable_jit():
                want = jax_fn()
        else:
            want = jax_fn()
        got = port_fn()
        assert len(got) == len(want) and all(len(g) == 3 for g in got), name
        np.testing.assert_array_equal(got[0], np.asarray(want[0]), err_msg=name)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5,
                                       err_msg=name)


# ---------------------------------------------------------------- run_gate
def _patch_gate(mp, mod, trained, as_array, clf, edsr):
    """Hand ``mod.run_gate`` the fixture's images, calibration crops and
    weights: its train call (seed 0) gets the training images, its eval
    call (seed 1) the eval images."""
    def images(seed, n, *a, **k):
        hr, y = ((trained["hr"], trained["y"]) if seed == 0 else
                 (trained["hr_eval"][:n], trained["y_eval"][:n]))
        return as_array(hr), as_array(y)

    mp.setattr(mod, "make_surface_images", images)
    mp.setattr(mod, "make_crop_pool",
               lambda *a, **k: (as_array(trained["calib"]), None, None))
    mp.setattr(mod, "train_classifier", lambda *a, **k: (clf, 1.0))
    mp.setattr(mod, "train_edsr", lambda *a, **k: edsr)


def test_run_gate_matches_jax_on_the_same_data_and_weights(trained,
                                                          monkeypatch):
    _narrow_jax_vgg(monkeypatch)
    _patch_gate(monkeypatch, tsg, trained, lambda t: t, trained["vgg"],
                trained["edsr"])
    _patch_gate(monkeypatch, jsg, trained, lambda t: jnp.asarray(t.numpy()),
                trained["cv"], trained["ev"])
    kw = dict(n_images=N_EVAL, size=SIZE, clf_steps=1, edsr_steps=1, seed=0,
              verbose=False, amp_range=HARD["amp_range"],
              coverage_range=HARD["coverage_range"])
    got = tsg.run_gate(device="cpu", **kw)
    want = jsg.run_gate(**kw)

    assert [m["mode"] for m in got["modes"]] == [m["mode"]
                                                 for m in want["modes"]]
    for a, b in zip(got["modes"], want["modes"]):
        assert set(a) == set(b), a["mode"]
    assert set(got) == set(want)
    assert set(got["raw_votes"]) == set(want["raw_votes"])
    for name, votes in got["raw_votes"].items():
        assert set(votes) == set(want["raw_votes"][name]), name
    rv_t, rv_j = got["raw_votes"], want["raw_votes"]
    assert rv_t["reference"]["cls"] == rv_j["reference"]["cls"]
    np.testing.assert_allclose(rv_t["reference"]["conf"],
                               rv_j["reference"]["conf"], rtol=0, atol=1e-4)
    assert got["reference_accuracy"] == want["reference_accuracy"]
    # rows on the f32 SR, and the cascade rows derived from them: classes
    # equal
    for name in F32_SR_ROWS:
        assert rv_t[name]["cls"] == rv_j[name]["cls"], name
    rows_t = {m["mode"]: m for m in got["modes"]}
    for m in want["modes"]:
        if m["mode"].startswith("cascade_int8"):
            for key in ("flips", "accuracy", "escalation_fraction",
                        "unescalated_flips"):
                assert rows_t[m["mode"]][key] == m[key], (m["mode"], key)
    # rows on the int8 and bf16 SR: counted (ROADMAP.md, queue 3)
    flips = {name: int(np.sum(np.asarray(rv_t[name]["cls"])
                              != np.asarray(rv_j[name]["cls"])))
             for name in SR_ROWS}
    print(f"reference classes {rv_t['reference']['cls']}, labels "
          f"{trained['y_eval'].tolist()}; SR-row class flips port vs JAX "
          f"{flips}; bf16 SR PSNR against f32 SR: port "
          f"{got['psnr_bf16_sr_vs_f32_sr_db']:.2f}, JAX "
          f"{want['psnr_bf16_sr_vs_f32_sr_db']:.2f} dB")
    # the bf16 SR as tests/test_torch_bf16.py holds it
    assert (got["psnr_bf16_sr_vs_f32_sr_db"]
            >= want["psnr_bf16_sr_vs_f32_sr_db"] - 0.5)


@pytest.mark.parametrize("border", [True, False])
def test_run_gate_int8_sr_matches_jax_run_op_by_op(trained, border):
    """The int8 SR the gate builds (its own calibration on the first 4 LR
    eval images), held as tests/test_torch_edsr_quant.py holds int8 SR: on
    JAX's int8 tree for the same scales, against JAX's int8 SR run op by op,
    the interior equal and the bf16 band within its tolerance; the gate's
    own tree differs from JAX's only in the composed tail's rescale and bias
    (float64 impulse probe against f32), within 1e-6 of it."""
    lr = resize(trained["hr_eval"], (SIZE // 4, SIZE // 4), "area")
    scales = teq.calibrate_edsr(trained["edsr"], lr[:4])
    qj = to_numpy(jeq.quantize_edsr(trained["ev"], 4, scales))
    fj, rj = jeq.make_fused_sr_apply_int8(trained["ev"], 4, act_scales=scales,
                                          border_correction=border)
    with jax.disable_jit():
        want = np.asarray(jax_pixel_shuffle(fj(jnp.asarray(lr.numpy())), rj))
    fn, r = teq.make_fused_sr_apply_int8(
        trained["edsr"], qtree=edsr_qtree_from_flax(qj, device="cpu"),
        border_correction=border)
    got = tsg._apply_sr(fn, r, lr).numpy()
    band = np.ones(got.shape, bool)
    pad = 4 * qj["pad"]
    band[:, pad:-pad, pad:-pad] = False
    np.testing.assert_array_equal(got[~band], want[~band])
    d = np.abs(got - want)[band]
    if border:
        psnr = 10 * np.log10(1.0 / max(float(np.mean(d ** 2)), 1e-30))
        assert d.max() <= BAND_ATOL and psnr >= BAND_MIN_PSNR
    else:
        assert d.max() == 0.0
    fg, _ = teq.make_fused_sr_apply_int8(trained["edsr"], sample_lr=lr[:4],
                                         border_correction=border)
    np.testing.assert_allclose(tsg._apply_sr(fg, r, lr).numpy(), got, rtol=0,
                               atol=1e-6)


def test_train_functions_are_seeded_and_train(monkeypatch):
    """``train_classifier`` and ``train_edsr`` on the CPU at narrow widths:
    the same seed gives the same weights, another seed others, and the
    weights move from the seeded init."""
    monkeypatch.setattr(tsg, "VGG16Classifier", functools.partial(
        tsg.VGG16Classifier, widths=WIDTHS))
    monkeypatch.setattr(tsg, "EDSR", functools.partial(
        tsg.EDSR, num_res_blocks=1, num_filters=8))
    hr, y = tsg.make_surface_images(0, 4, SIZE, device="cpu")

    def flat(model):
        return torch.cat([p.detach().flatten() for p in model.parameters()])

    a, acc = tsg.train_classifier(hr, y, steps=3, batch=4)
    b, _ = tsg.train_classifier(hr, y, steps=3, batch=4)
    c, _ = tsg.train_classifier(hr, y, steps=3, batch=4, seed=1)
    init = tsg.VGG16Classifier(
        num_classes=2, device="cpu",
        generator=torch.Generator().manual_seed(tsg.INIT_SEED))
    assert 0.0 <= acc <= 1.0
    assert torch.equal(flat(a), flat(b)) and not torch.equal(flat(a), flat(c))
    assert not torch.equal(flat(a), flat(init))
    e1 = tsg.train_edsr(hr, steps=2, batch=2)
    e2 = tsg.train_edsr(hr, steps=2, batch=2)
    e_init = tsg.EDSR(scale_factor=4, device="cpu",
                          generator=torch.Generator().manual_seed(tsg.INIT_SEED))
    assert torch.equal(flat(e1), flat(e2))
    assert not torch.equal(flat(e1), flat(e_init))
    assert bool(torch.isfinite(flat(e1)).all())
