"""The port's LPIPS-alex (``tpusr_torch/metrics/lpips.py``) and its weight
tool (``tpusr_torch/tools/lpips_weights.py``) against the JAX package's, on
seeded random bundles in the official layout (no download).

Tolerance: distances within 1e-5 of JAX's ``lpips_alex`` on the same
bundle and inputs (float32 convolutions summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tpusr.metrics import lpips as jax_lpips
from tpusr.tools import lpips_weights as jax_tool
from tpusr_torch.metrics import lpips as tl
from tpusr_torch.tools import lpips_weights as tool

ATOL = 1e-5


def _random_flat(seed=0):
    """A bundle as ``tests/test_lpips.py`` writes one: N(0, 0.1) weights,
    non-negative heads."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in tool.expected_shapes().items():
        a = rng.standard_normal(shape).astype(np.float32) * 0.1
        flat[key] = np.abs(a) if key.startswith("lin") else a
    return flat


def _bundle(tmp_path, seed=0):
    path = str(tmp_path / f"lpips_{seed}.npz")
    np.savez(path, **_random_flat(seed))
    return path


def test_expected_shapes_match_jax():
    assert tool.expected_shapes() == jax_tool.expected_shapes()
    assert tl.ALEX_CONVS == jax_lpips.ALEX_CONVS


@pytest.mark.parametrize("hw", [(64, 64), (48, 56), (96, 80)])
def test_lpips_alex_matches_jax(tmp_path, hw):
    path = _bundle(tmp_path, sum(hw))
    net = tl.load_lpips_npz(path, device="cpu")
    w = jax_lpips.load_lpips_npz(path)
    rng = np.random.default_rng(hw[0])
    a = rng.random((3, *hw, 3), dtype=np.float32) * 2 - 1
    b = np.clip(a + rng.normal(scale=0.3, size=a.shape), -1, 1).astype(np.float32)
    with torch.no_grad():
        got = tl.lpips_alex(net, torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax.jit(jax_lpips.lpips_alex)(w, jnp.asarray(a),
                                                   jnp.asarray(b)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (want > 0).all()


def test_uint8_entry_matches_jax_and_is_zero_on_identity(tmp_path):
    path = _bundle(tmp_path, 3)
    net = tl.load_lpips_npz(path, device="cpu")
    w = jax_lpips.load_lpips_npz(path)
    rng = np.random.default_rng(4)
    a = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    b = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    got = tl.lpips_alex_from_uint8_rgb(net, a, b)
    assert abs(got - jax_lpips.lpips_alex_from_uint8_rgb(w, a, b)) <= ATOL
    assert tl.lpips_alex_from_uint8_rgb(net, a, a) == 0.0
    # tensors are taken as they are
    assert tl.lpips_alex_from_uint8_rgb(
        net, torch.from_numpy(a), torch.from_numpy(b)) == got


def test_unit_normalize_matches_jax():
    rng = np.random.default_rng(5)
    f = rng.normal(size=(2, 7, 5, 16)).astype(np.float32)
    f[0, 0, 0] = 0.0      # a zero feature vector: eps keeps it finite
    want = np.asarray(jax_lpips._unit_normalize(jnp.asarray(f)))
    got = tl._unit_normalize(torch.from_numpy(f).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def _official_layout_pths(tmp_path, seed=4):
    """Checkpoints in the official key layout: torchvision AlexNet's
    ``features.{0,3,6,8,10}`` (OIHW) and the lpips ``lin{i}.model.1``
    heads."""
    rng = np.random.default_rng(seed)
    alex_sd, in_ch = {}, 3
    for idx, (k, _s, _p, out_ch) in zip((0, 3, 6, 8, 10), tl.ALEX_CONVS):
        alex_sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((out_ch, in_ch, k, k)).astype(np.float32) * 0.1)
        alex_sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(out_ch).astype(np.float32) * 0.1)
        in_ch = out_ch
    lin_sd = {f"lin{i}.model.1.weight": torch.from_numpy(np.abs(
        rng.standard_normal((1, c, 1, 1))).astype(np.float32))
        for i, (_k, _s, _p, c) in enumerate(tl.ALEX_CONVS)}
    alex_path, lin_path = str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth")
    torch.save(alex_sd, alex_path)
    torch.save(lin_sd, lin_path)
    return alex_sd, alex_path, lin_path


def test_convert_validate_load_round_trip(tmp_path):
    """official-layout .pth pair -> convert -> validate -> load: the same
    bundle as JAX's converter writes, and the loaded net's conv weights are
    the checkpoint's OIHW tensors."""
    alex_sd, alex_path, lin_path = _official_layout_pths(tmp_path)
    out = str(tmp_path / "w" / "lpips_alex.npz")
    flat = tool.convert(alex_path, lin_path, out)
    tool.validate(flat)
    want = jax_tool.convert(alex_path, lin_path, str(tmp_path / "jax.npz"))
    assert sorted(flat) == sorted(want)
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k])
    net = tl.load_lpips_npz(out, device="cpu")
    for i, idx in enumerate((0, 3, 6, 8, 10), start=1):
        torch.testing.assert_close(getattr(net, f"conv{i}").weight,
                                   alex_sd[f"features.{idx}.weight"],
                                   rtol=0, atol=0)
    img = (np.random.default_rng(5).random((40, 40, 3)) * 255).astype(np.uint8)
    assert tl.lpips_alex_from_uint8_rgb(net, img, img) == 0.0
    assert tl.lpips_alex_from_uint8_rgb(net, img, 255 - img) > 0.0


def test_main_converts_and_the_linear_heads_must_be_there(tmp_path, capsys):
    _, alex_path, lin_path = _official_layout_pths(tmp_path, 6)
    out = str(tmp_path / "m.npz")
    tool.main(["--alexnet", alex_path, "--linear", lin_path, "--out", out])
    assert "validated lpips_alex" in capsys.readouterr().out
    tool.validate(dict(np.load(out)))
    with pytest.raises(ValueError, match="linear weights for tap 1"):
        tool.convert(alex_path, alex_path, "")


def test_validate_rejects_bad_shapes_and_missing_keys():
    flat = _random_flat(6)
    flat["conv3/kernel"] = flat["conv3/kernel"][..., :-1]
    with pytest.raises(ValueError, match="conv3/kernel"):
        tool.validate(flat)
    flat = _random_flat(6)
    del flat["lin5/weight"]
    with pytest.raises(ValueError, match="missing lin5/weight"):
        tool.validate(flat)


def test_default_weights_path_reads_the_environment(tmp_path, monkeypatch):
    path = _bundle(tmp_path, 8)
    monkeypatch.setenv("TPUSR_LPIPS_WEIGHTS", path)
    assert tool.default_weights_path() == path
    monkeypatch.setenv("TPUSR_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert tool.default_weights_path() == jax_tool.default_weights_path()


def test_the_net_runs_where_it_is_asked_to():
    net = tl.LPIPSAlex(device="cpu")
    assert net.conv1.weight.device.type == "cpu"
    assert not any(p.requires_grad for p in net.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tl.LPIPSAlex()
