"""K5 (``tpusr_torch/csrc/prng.cu``, JAX's random streams in one CUDA
kernel) as far as the CPU can hold it: its float constants equal
``core/prng.py``'s bit for bit, its sampler codes and C signature agree
with the wrapper's, a draw on the CPU never loads a CUDA library, and the
plain samplers (``PLAIN``, K5's twin) and the words entry give the public
samplers' draws. The kernel itself runs in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""

import re
import struct

import numpy as np
import pytest
import torch

from tpusr_torch.core import _build, prng

# the source without its comments
SOURCE = re.sub(r"//[^\n]*", "", (_build.CSRC / "prng.cu").read_text())
HEX_FLOAT = re.compile(r"(-?0x[0-9a-fA-F]+\.[0-9a-fA-F]*p[+-]?\d+)f")


def _body(name: str) -> str:
    """The definition of ``name`` in prng.cu: a function's or an enum's
    braces, an array's initialiser or a macro's line."""
    head = re.search(rf"(#define {name} |\b{name}(\(|\[\d+\] =| {{))", SOURCE)
    if head.group(0).startswith("#define"):
        return SOURCE[head.start():SOURCE.index("\n", head.start())]
    start = SOURCE.index("{", head.start())
    depth, i = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(SOURCE[i], 0)
        if depth == 0:
            return SOURCE[head.start():i + 1]
        i += 1


def _literals(name: str) -> list[float]:
    return [float.fromhex(h) for h in HEX_FLOAT.findall(_body(name))]


def _bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


@pytest.mark.parametrize("name,want", [
    ("xla_log", [prng._FLT_MIN, prng._FLT_MIN, prng._SQRTHF, *prng._LOG_P,
                 prng._LOG_Q1, prng._LOG_Q2]),
    ("xla_log1p", [*prng._LOG1P_DEN, *prng._LOG1P_NUM, prng._LOG1P_SMALL]),
    ("ERFINV_LT5", prng._ERFINV_LT5),
    ("ERFINV_GE5", prng._ERFINV_GE5),
    ("SQRT2", [prng.SQRT2]),
])
def test_kernel_constants_equal_the_plain_versions(name, want):
    """Every hex-float literal of the function (in order) is the plain
    version's constant, as float32 bits; each is a float32 value."""
    got = _literals(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert float(np.float32(g)) == g
        assert _bits(g) == _bits(w), (name, g.hex(), float(w).hex())


def test_kernel_kinds_and_signature_agree_with_the_wrapper():
    enum = dict((k, int(v)) for k, v in re.findall(
        r"^\s+([A-Z0-9_]+) = (\d+),$", _body("enum Kind"), re.MULTILINE))
    names = {"bits32": "BITS32", "bits": "BITS64", "uniform": "UNIFORM",
             "bernoulli": "BERNOULLI", "normal": "NORMAL",
             "normal_erf_inv": "NORMAL_ERF_INV",
             "truncated_normal": "TRUNCATED", "randint": "RANDINT"}
    assert {k: enum[v] for k, v in names.items()} == {
        k: code for k, (code, _) in prng._KINDS.items()}
    proto = SOURCE[SOURCE.index('extern "C" int prng_launch('):]
    params = proto[proto.index("(") + 1:proto.index(")")].split(",")
    assert len(params) == len(_build.SIGNATURES["prng"]["prng_launch"])


@pytest.mark.parametrize("sampler", sorted(prng.PLAIN))
def test_a_cpu_draw_never_loads_a_cuda_library(monkeypatch, sampler):
    def refuse(name):
        raise AssertionError(f"a CPU draw loaded csrc/{name}.cu")
    monkeypatch.setattr(_build, "load", refuse)
    key = prng.PRNGKey(3)
    args = {"truncated_normal": (key, -2.0, 2.0, (33,)),
            "bernoulli": (key, 0.8, (33,)), "permutation": (key, 33)}.get(
        sampler, (key, (33,)))
    before = prng.LAUNCHES["prng"]
    got = getattr(prng, sampler)(*args)
    assert torch.equal(got, prng.PLAIN[sampler](*args))
    assert prng.LAUNCHES["prng"] == before


@pytest.mark.parametrize("bounds", [(None, None), (-2.0, 2.0)])
def test_normal_from_words_gives_the_draws_values(bounds):
    key, shape = prng.PRNGKey(11), (4099,)
    words = prng._bits32(key, shape, "cpu")
    draw = (prng.normal(key, shape) if bounds[0] is None
            else prng.truncated_normal(key, *bounds, shape))
    assert torch.equal(prng.normal_from_words(words, *bounds), draw)


def test_other_devices_are_refused():
    with pytest.raises(ValueError):
        prng.uniform(prng.PRNGKey(0), (4,), device="meta")
