"""The port's shared trunk and cascade (tpusr_torch/models/vgg_trunk.py,
tpusr_torch/pipeline/cascade.py) against the JAX package: trunk probs on a
narrow VGG16 tree, and the cascade's escalation set, merge, pad-row mask,
tie order, ceil count and guard — the last ones with the stubbed parents of
tests/test_cascade.py, applied to both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpusr.pipeline.cascade as jcasc
import tpusr_torch.pipeline.cascade as tcasc
from test_torch_fixtures import center_classifier_bias, to_numpy, vgg16_tree
from tpusr.models import quant as jq
from tpusr.models.vgg_trunk import shared_trunk_probs_int8 as jax_trunk
from tpusr.pipeline.defect_pipeline import _vote as jax_vote
from tpusr_torch.bridge import qtree_from_flax
from tpusr_torch.models.vgg_trunk import shared_trunk_probs_int8

PATCH, STRIDE, HW = 32, 16, 64   # the smallest trunk-legal geometry


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(1)
    params = vgg16_tree(rng)
    calib = rng.random((6, PATCH, PATCH, 3), dtype=np.float32)
    scales = jq.calibrate_vgg16(params, calib)
    imgs = rng.random((8, HW, HW, 3), dtype=np.float32)
    q0 = jq.quantize_vgg16(params, scales)
    # split the trunk's votes between the classes
    params = center_classifier_bias(params, jax_trunk(q0, jnp.asarray(imgs),
                                                      PATCH, STRIDE))
    qtree = to_numpy(jq.quantize_vgg16(params, scales))
    return qtree, qtree_from_flax(qtree, device="cpu"), imgs


def test_shared_trunk_probs_match_jax(narrow):
    qtree, q, imgs = narrow
    want = np.asarray(jax_trunk(qtree, jnp.asarray(imgs), PATCH, STRIDE))
    got = shared_trunk_probs_int8(q, torch.from_numpy(imgs), PATCH, STRIDE)
    assert got.shape == want.shape == (8, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _expected_escalation(probs_t, k, n_valid):
    """vote_frac lexicographic score, pad rows +inf, k lowest, ties by index."""
    cls, conf = map(np.asarray, jax.vmap(jax_vote)(jnp.asarray(probs_t)))
    agree = (probs_t.argmax(-1) == cls[:, None]).mean(1)
    score = agree.astype(np.float32) + conf * np.float32(0.5 / probs_t.shape[1])
    score[n_valid:] = np.inf
    return np.argsort(score, kind="stable")[:k]


@pytest.mark.parametrize("guard", [None, 0.6, 0.0])
def test_cascade_matches_jax_on_a_real_tree(narrow, guard):
    qtree, q, imgs = narrow
    n_valid = 6
    votes_j = jcasc.make_cascade_votes(qtree, PATCH, STRIDE, 0.25, "vote_frac",
                                       guard)
    cls_j, conf_j = map(np.asarray, votes_j(jnp.asarray(imgs), n_valid))
    votes_t = tcasc.make_cascade_votes(q, PATCH, STRIDE, 0.25, "vote_frac",
                                       guard)
    cls_t, conf_t = votes_t(torch.from_numpy(imgs), n_valid)
    np.testing.assert_array_equal(cls_t.numpy(), cls_j)
    np.testing.assert_allclose(conf_t.numpy(), conf_j, atol=1e-6, rtol=0)
    if guard != 0.0:  # the bias is centered on the trunk's votes
        assert len(np.unique(cls_j)) == 2
    probs_t = np.asarray(jax_trunk(qtree, jnp.asarray(imgs), PATCH, STRIDE))
    np.testing.assert_array_equal(votes_t.last_escalated.numpy(),
                                  _expected_escalation(probs_t, 2, n_valid))
    # guard 0.0 always trips: the whole batch is served per-patch
    assert votes_t.guard_trips == (1 if guard == 0.0 else 0)


# ---- stubbed parents: one patch per 2x2 image, image i has mean i-ish ----

def _stub(monkeypatch, n, trunk_probs, pp_probs):
    """Stub both packages' parents: the trunk returns ``trunk_probs``
    (n, 1, 2); the per-patch path returns ``pp_probs[i]`` for every patch of
    image i (images are told apart by their mean)."""
    trunk_probs = np.asarray(trunk_probs, np.float32)
    pp_probs = np.asarray(pp_probs, np.float32)
    imgs = (np.arange(n * 12, dtype=np.float32).reshape(n, 2, 2, 3)
            / (n * 12.0))
    means = imgs.mean(axis=(1, 2, 3))

    def pp(xp, flat):
        m = flat.reshape(flat.shape[0], -1).mean(1)
        idx = xp.abs(m[:, None] - xp.asarray(means)[None, :]).argmin(1)
        return xp.asarray(pp_probs)[idx]

    monkeypatch.setattr(jcasc, "quantize_input", lambda q, x: x)
    monkeypatch.setattr(jcasc, "shared_trunk_probs_int8",
                        lambda q, x, p, s: jnp.asarray(trunk_probs))
    monkeypatch.setattr(jcasc, "quantized_vgg16_apply",
                        lambda q, f: pp(jnp, f))
    tnp = type("T", (), {"abs": staticmethod(torch.abs),
                         "asarray": staticmethod(torch.as_tensor)})
    monkeypatch.setattr(tcasc, "quantize_input", lambda q, x: x)
    monkeypatch.setattr(tcasc, "shared_trunk_probs_int8",
                        lambda q, x, p, s: torch.as_tensor(trunk_probs))
    monkeypatch.setattr(tcasc, "quantized_vgg16_apply",
                        lambda q, f: pp(tnp, f))
    return imgs


def _both(imgs, n_valid=None, **kw):
    cls_j, conf_j = jcasc.make_cascade_votes({}, patch=2, stride=2, **kw)(
        jnp.asarray(imgs), n_valid)
    votes = tcasc.make_cascade_votes({}, patch=2, stride=2, **kw)
    cls_t, conf_t = votes(torch.from_numpy(imgs), n_valid)
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), atol=1e-7)
    return cls_t.numpy(), conf_t.numpy(), votes


def _two_class(p1):
    p1 = np.asarray(p1, np.float32)
    return np.stack([p1, 1.0 - p1], axis=-1)


def test_escalation_count_ceils_not_rounds(monkeypatch):
    n = 16
    imgs = _stub(monkeypatch, n, _two_class(0.6 + 0.02 * np.arange(n))[:, None],
                 np.tile([[0.1, 0.9]], (n, 1)))
    cls, _, votes = _both(imgs, escalate_frac=0.28125)
    # ceil(16 * 0.28125) = 5 lowest-confidence images flip to class 1
    assert cls.sum() == 5 and (cls[:5] == 1).all()
    np.testing.assert_array_equal(votes.last_escalated.numpy(), np.arange(5))


def test_pad_rows_never_take_escalation_slots(monkeypatch):
    n, n_valid = 8, 5
    # pad rows 5..7 have the lowest trunk confidence of the batch
    p1 = np.array([0.9, 0.7, 0.8, 0.6, 0.95, 0.51, 0.52, 0.53])
    imgs = _stub(monkeypatch, n, _two_class(p1)[:, None],
                 np.tile([[0.1, 0.9]], (n, 1)))
    cls, _, votes = _both(imgs, n_valid=n_valid, escalate_frac=0.25)
    np.testing.assert_array_equal(np.sort(votes.last_escalated.numpy()), [1, 3])
    np.testing.assert_array_equal(cls, [0, 1, 0, 1, 0, 0, 0, 0])


def test_tied_scores_escalate_lower_indices_first(monkeypatch):
    n = 8
    p1 = np.array([0.9, 0.7, 0.9, 0.7, 0.7, 0.9, 0.7, 0.9])  # four tied lows
    imgs = _stub(monkeypatch, n, _two_class(p1)[:, None],
                 np.tile([[0.1, 0.9]], (n, 1)))
    for score in ("conf", "vote_frac"):
        cls, _, votes = _both(imgs, escalate_frac=0.25, escalate_score=score)
        np.testing.assert_array_equal(votes.last_escalated.numpy(), [1, 3])
        np.testing.assert_array_equal(cls, [0, 1, 0, 1, 0, 0, 0, 0])


def test_guard_triggers_on_trunk_collapse(monkeypatch):
    n = 8
    imgs = _stub(monkeypatch, n, np.tile([[[0.9, 0.1]]], (n, 1, 1)),
                 np.tile([[0.2, 0.8]], (n, 1)))
    cls_u, _, _ = _both(imgs, escalate_frac=0.25, guard_threshold=None)
    assert cls_u.sum() == 2
    cls_g, conf_g, votes = _both(imgs, escalate_frac=0.25, guard_threshold=0.6)
    assert (cls_g == 1).all() and votes.guard_trips == 1
    np.testing.assert_allclose(conf_g, 0.8, atol=1e-6)


def test_guard_stays_silent_on_healthy_trunk(monkeypatch):
    n = 8
    p1 = 0.55 + 0.04 * np.arange(n)
    imgs = _stub(monkeypatch, n, _two_class(1.0 - p1)[:, None],
                 _two_class(1.0 - p1))
    cls_u, conf_u, _ = _both(imgs, escalate_frac=0.25)
    cls_g, conf_g, votes = _both(imgs, escalate_frac=0.25, guard_threshold=0.6)
    np.testing.assert_array_equal(cls_g, cls_u)
    np.testing.assert_array_equal(conf_g, conf_u)
    assert votes.guard_trips == 0


def test_argument_validation_matches_jax():
    for kw in ({"escalate_frac": 0.0}, {"escalate_frac": 1.5},
               {"escalate_score": "margin"}):
        with pytest.raises(ValueError):
            jcasc.make_cascade_votes({}, PATCH, STRIDE, **kw)
        with pytest.raises(ValueError):
            tcasc.make_cascade_votes({}, PATCH, STRIDE, **kw)
