"""JAX's random streams in PyTorch: the partitionable threefry2x32 PRNG that
``jax.random`` uses by default, and the samplers the JAX package draws from,
equal to JAX's on the CPU bit for bit.

A key is a pair of 32-bit words held on the host, ``(k0, k1)`` as Python
ints (``PRNGKey``, ``split`` and ``fold_in`` return such tuples; ``as_key``
takes a ``jax.random.PRNGKey`` array too). Draws (``bits``, ``uniform``,
``normal``, ``normal_erf_inv``, ``truncated_normal``, ``randint``,
``bernoulli``, ``permutation``) are made on the device asked for:

- on a CUDA device, one launch of K5 (``csrc/prng.cu``) per draw
  (``permutation``: one per sort round): the hash and the sampler in
  registers, only the result stored. ``LAUNCHES`` counts them. A failed
  build or launch raises; a draw on the card never takes the tensor ops;
- on the CPU, the plain version: plain tensor ops in ``int64`` masked to 32
  bits (torch's ``uint32`` lacks most ops), the normal samplers through a
  table of their 2^23 values once a process has drawn enough of them. The
  plain samplers (``PLAIN``) run on any device, so a check can hold K5
  against them on the card.

The rules follow ``jax/_src/prng.py`` (``threefry_seed``, the threefry
rounds, ``iota_2x32_shape``, the fold-like split and random bits with
``jax_threefry_partitionable`` on) and ``jax/_src/random.py``
(``_uniform``, ``_normal_real``, ``_truncated_normal``, ``_randint``,
``_bernoulli``, ``_shuffle``). The float steps follow what XLA compiles for
the CPU: ``f * (max - min) + min`` is one fused multiply-add, ``erf_inv``
is Giles' polynomial in fused multiply-adds over XLA's inline ``log1p``
(a Cephes rational for small arguments, else a Cephes ``log``), and
``erf`` is XLA's rational in fused multiply-adds. In the plain version a
fused multiply-add of float32 values is computed exactly (``fma32``: the
product and sum in float64, rounded to odd, then to float32), so nothing
depends on whether a backend contracts ``a * b + c``; K5 issues the card's
own fused multiply-add there and rounds every other step on its own.
"""

from __future__ import annotations

import functools
import math
import struct
import threading

import numpy as np
import torch

from tpusr_torch.core import _build

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# ------------------------------------------------------------------- keys

def _i32(v: int) -> int:
    """A 32-bit word as the int32 that holds the same bits."""
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def _threefry2x32(k0: int, k1: int, x0, x1):
    """The threefry2x32 hash of the counter words ``(x0, x1)`` under key
    ``(k0, k1)``: Python ints (32-bit words), or int32 tensors whose bits
    are the words (adds wrap; the right shift is masked to a logical
    one)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    tensor = isinstance(x0, torch.Tensor)

    def add(v, w):
        if tensor:
            return v + (_i32(w) if isinstance(w, int) else w)
        return (v + w) & M32

    def rotl(v, r):
        if tensor:
            return (v << r) | ((v >> (32 - r)) & ((1 << r) - 1))
        return ((v << r) | (v >> (32 - r))) & M32

    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = x0 ^ rotl(x1, r)
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(x1, ks[(i + 2) % 3] + i + 1)
    return x0, x1


def as_key(key) -> tuple[int, int]:
    """A key as ``(k0, k1)``: from a tuple, any length-2 array of 32-bit
    words (a ``jax.random.PRNGKey``, a numpy or torch array), or an int
    seed (``PRNGKey(seed)``)."""
    if isinstance(key, tuple) and len(key) == 2 and all(
            isinstance(k, int) for k in key):
        return key
    if isinstance(key, (int, np.integer)):
        return PRNGKey(key)
    words = np.asarray(key).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a PRNG key has two 32-bit words, got {key!r}")
    return int(words[0]) & M32, int(words[1]) & M32


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's high and low words (a seed
    in int32's range has high word 0, as JAX gives without x64)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return 0, seed & M32


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    k0, k1 = as_key(key)
    return _threefry2x32(k0, k1, 0, int(data) & M32)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``: key i hashes the 64-bit counter i."""
    k0, k1 = as_key(key)
    return [_threefry2x32(k0, k1, 0, i) for i in range(num)]


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


# On the CPU every elementwise pass runs over chunks below torch's parallel
# grain (32768 elements), so each op runs on the calling thread: the
# hundreds of small ops of a draw, handed to a thread pool shared with other
# processes' threads, ran up to 200 times slower. On the card (the plain
# version held against K5) a pass takes 2^24 values, so the float64
# temporaries of a normal draw stay within a few GB.
_CPU_CHUNK = 1 << 14
_CUDA_CHUNK = 1 << 24


def _in_chunks(n: int, device, dtype, fn) -> torch.Tensor:
    """(n,) of ``dtype``: ``fn(start, stop)`` over [0, n) in chunks."""
    out = torch.empty(n, dtype=dtype, device=device)
    step = _CUDA_CHUNK if out.device.type == "cuda" else _CPU_CHUNK
    for s in range(0, n, step):
        out[s:s + step] = fn(s, min(s + step, n))
    return out


def _count(shape) -> int:
    n = math.prod(shape)
    if n >= 2 ** 31:
        raise ValueError(f"a draw of {n} values is more than this port draws")
    return n


def _bits32(key, shape, device) -> torch.Tensor:
    """``jax.random.bits`` as an int32 tensor holding the words, by plain
    tensor ops: element i (row-major) hashes the 64-bit counter i, and the
    two output words are xor-ed."""
    k0, k1 = as_key(key)
    shape = _shape(shape)

    def words(start, stop):
        lo = torch.arange(start, stop, dtype=torch.int32, device=device)
        o0, o1 = _threefry2x32(k0, k1, torch.zeros_like(lo), lo)
        return o0 ^ o1
    return _in_chunks(_count(shape), device, torch.int32, words).reshape(shape)


def _device(device) -> torch.device:
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"prng: unsupported device {dev}")
    return dev


# ------------------------------------------------------------------- K5

LAUNCHES = {"prng": 0}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        LAUNCHES["prng"] = 0


# csrc/prng.cu's samplers (its enum Kind) and the dtype each stores
_KINDS = {"bits32": (0, torch.int32), "bits": (1, torch.int64),
          "uniform": (2, torch.float32), "bernoulli": (3, torch.bool),
          "normal": (4, torch.float32), "normal_erf_inv": (5, torch.float32),
          "truncated_normal": (6, torch.float32),
          "randint": (7, torch.int64)}


def _word(v: float) -> int:
    """The float32 ``v``'s bits, as an unsigned 32-bit int."""
    return int(np.float32(v).view(np.uint32))


def _k5(kind: str, device: torch.device, shape=None, key=(0, 0),
        words: torch.Tensor | None = None, *, lo=0.0, span=1.0, p=0.0,
        clip=(0.0, 0.0), key2=(0, 0), span_u=0, mult=0,
        minval=0) -> torch.Tensor:
    """One launch of K5 on the current stream of the CUDA ``device``, under
    that card's device guard: the sampler ``kind`` over the counters of
    ``shape`` under ``key``, or (``normal`` and ``truncated_normal`` only)
    over the int32 ``words``. The scalars are the sampler's
    (``csrc/prng.cu``'s ``Params``), floats already rounded to float32."""
    code, dtype = _KINDS[kind]
    if words is not None:
        if words.dtype != torch.int32 or not words.is_contiguous():
            raise ValueError("prng: words must be a contiguous int32 tensor")
        shape, device = tuple(words.shape), words.device
    shape = _shape(shape)
    n = _count(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if n == 0:
        return out
    k0, k1 = as_key(key)
    k2, k3 = as_key(key2)
    lib = _build.load("prng")
    # the launch goes to the card that owns ``out``, whichever is current
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _build.check("prng", lib.prng_launch(
            out.data_ptr(), None if words is None else words.data_ptr(), n,
            code, k0, k1, k2, k3, _word(lo), _word(span),
            int((lo, span) == (0.0, 1.0)), _word(p), _word(clip[0]),
            _word(clip[1]), span_u & M32, mult & M32, minval & M32, stream))
    with _launch_lock:
        LAUNCHES["prng"] += 1
    return out


def bits_plain(key, shape=(), device=None) -> torch.Tensor:
    return _bits32(key, shape, device).long() & M32


def bits(key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor on
    ``device``."""
    dev = _device(device)
    if dev.type == "cuda":
        return _k5("bits", dev, shape, key)
    return bits_plain(key, shape, dev)


# ------------------------------------------------------- float arithmetic

def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _llvm(hexbits: int) -> float:
    """A float32 constant as LLVM prints it (the bits of the double)."""
    return struct.unpack(">d", hexbits.to_bytes(8, "big"))[0]


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding. The float32 product is
    exact in float64, so the float64 sum ``s`` rounds once; rounding ``s``
    to float32 is then correct unless ``s`` fell on a float32 midpoint,
    and there the sum's error (TwoSum) moves ``s`` one float64 ulp off it
    toward the exact value. On the card this runs without a branch, so
    nothing waits on the device; on the host, where a test costs no wait,
    a pass with no midpoint skips the correction (half the work)."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else float(v)
               for v in (a, b, c))
    p = a * b
    s = p + c
    sb = s.view(torch.int64)
    mid = (sb & 0x1FFFFFFF) == 0x10000000
    if s.device.type == "cpu" and not bool(mid.any()):
        return s.float()
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # +1 on the bits moves |s| up: where the exact value lies beyond |s|
    nudge = (torch.sign(err) * torch.sign(s)).long() * mid
    return (sb + nudge).view(torch.float64).float()


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b`` correctly rounded (through float64, where the
    double rounding is harmless), whatever the backend's float32 division."""
    return (a.double() / b.double()).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt(a)`` correctly rounded, as XLA's ``vsqrtps`` (torch's
    float32 sqrt on the CPU is not)."""
    return torch.sqrt(a.double()).float()


def _float_from_bits(b: torch.Tensor) -> torch.Tensor:
    """Random words (int32) -> float32 in [0, 1): 23 mantissa bits under
    exponent 0, minus 1 (``jax.random._uniform``)."""
    return (((b >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def _uniform_range(minval: float, maxval: float) -> tuple[float, float]:
    """``(lo, span)`` of a uniform on [minval, maxval), rounded as JAX
    rounds them (float32 bounds, their float32 difference)."""
    lo = _f32(minval)
    return lo, _f32(np.float32(maxval) - np.float32(lo))


def _uniform_from_bits(b: torch.Tensor, minval: float,
                       maxval: float) -> torch.Tensor:
    lo, span = _uniform_range(minval, maxval)
    f = _float_from_bits(b)
    if (lo, span) == (0.0, 1.0):   # f * 1 + 0 is f: no rounding to mirror
        return f
    u = fma32(f, span, lo)
    return torch.clamp_min(u, lo)


# XLA's inline log1p for float32 (CPU): a Cephes rational for |x| <
# sqrt(2) - 1, else Cephes' log of 1 + x.
_SQRTHF = _llvm(0x3FE6A09E60000000)
_LOG_P = [_llvm(h) for h in (
    0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
    0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)]
_LOG_Q1 = _llvm(0xBF2BD01060000000)
_LOG_Q2 = _llvm(0x3FE6300000000000)
_LOG1P_NUM = [_llvm(h) for h in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000)]
_LOG1P_DEN = [_llvm(h) for h in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)]
_LOG1P_SMALL = _llvm(0x3FDA8279A0000000)
_FLT_MIN = _llvm(0x3810000000000000)


def _xla_log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU, for finite y > 0."""
    y = torch.clamp_min(y, _FLT_MIN)
    ib = y.view(torch.int32)
    e = ((ib >> 23) - 127).float() + 1.0
    m = ((ib & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    z = x * x
    x3 = z * x
    p = _LOG_P
    a = fma32(fma32(x, p[0], p[1]), x, p[2])
    b = fma32(fma32(x, p[3], p[4]), x, p[5])
    c = fma32(fma32(x, p[6], p[7]), x, p[8])
    r = fma32(fma32(fma32(a, x3, b), x3, c), x3, e * _LOG_Q1)
    r = (x - z * 0.5) + r
    return fma32(e, _LOG_Q2, r)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU, for finite x > -1."""
    x2 = x * x
    zero = x * 0.0
    den = zero + 1.0
    for k in _LOG1P_DEN:
        den = fma32(den, x, k)
    num = zero + _LOG1P_NUM[0]
    for k in _LOG1P_NUM[1:]:
        num = fma32(num, x, k)
    small = (x * x2) * _div(num, den)
    small = x + (small - x2 * 0.5)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _xla_log(x + 1.0))


# Giles' float32 erf_inv coefficients, for w < 5 and w >= 5.
_ERFINV_LT5 = [_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)]
_ERFINV_GE5 = [_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]
SQRT2 = _f32(np.sqrt(2))


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv, for u in (-1, 1)."""
    lg = _xla_log1p(u * -u)
    lt = lg > -5.0
    w = torch.where(lt, -2.5 - lg, _sqrt(-lg) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = fma32(coef(0), w, coef(1))
    for i in range(2, 9):
        p = fma32(w, p, coef(i))
    return torch.where(u.abs() == 1.0, torch.full_like(p, math.inf), p) * u


_ERF_CLAMP = _llvm(0x400DF38D00000000)
_ERF_NUM = [_llvm(h) for h in (
    0x3F2E05AA20000000, 0x3F6BEBB440000000, 0x3FAA16DD60000000,
    0x3FC7B4E800000000, 0x3FF20DD740000000)]
_ERF_DEN = [_llvm(h) for h in (
    0xBE7FA720C0000000, 0x3EF8B11BE0000000, 0x3F50ADA500000000,
    0x3F8CD0FA80000000, 0x3FBC698420000000, 0x3FDFD68940000000)]
_INVSQRT2 = _llvm(0x3FE6A09E60000000)


def _erf_scaled(v: float) -> float:
    """XLA's float32 ``erf(v / sqrt(2))`` (the division folded into a
    multiply by float32 1/sqrt(2), as XLA folds it)."""
    x = torch.tensor(_f32(v), dtype=torch.float32) * _INVSQRT2
    x = x.clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = fma32(x2, _ERF_NUM[0], _ERF_NUM[1])
    for k in _ERF_NUM[2:]:
        p = fma32(p, x2, k)
    q = fma32(x2, _ERF_DEN[0], _ERF_DEN[1])
    for k in _ERF_DEN[2:] + [1.0]:
        q = fma32(q, x2, k)
    return float(_div(x * p, q))


# --------------------------------------------------------------- samplers

def uniform_plain(key, shape=(), minval: float = 0.0, maxval: float = 1.0,
                  device=None) -> torch.Tensor:
    return _uniform_from_bits(_bits32(key, shape, device), minval, maxval)


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` (float32) on ``device``."""
    dev = _device(device)
    if dev.type == "cuda":
        lo, span = _uniform_range(minval, maxval)
        return _k5("uniform", dev, shape, key, lo=lo, span=span)
    return uniform_plain(key, shape, minval, maxval, dev)


# The normal samplers are functions of the uniform's 23 mantissa bits. On
# the CPU the values are computed for small draws; once a draw reaches
# _TABLE_MIN values for some bounds, or the draws computed so far 4 *
# _TABLE_MIN (a table is 2**23 computed values), a table of all 2**23 of
# them is built and kept for the process (they are a pure function of
# those), and every later draw looks its values up. The plain version on
# the card computes every value; K5 needs no table.
_TABLES: dict = {}
_COMPUTED: dict = {}
_MANTISSAS = 1 << 23
_TABLE_MIN = 1 << 20
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


@functools.lru_cache(maxsize=64)
def _truncated_range(lower: float, upper: float):
    """``truncated_normal``'s uniform range (erf of the bounds over sqrt 2,
    as XLA computes it) and its clip, inside the open bounds."""
    return ((_erf_scaled(lower), _erf_scaled(upper)),
            (float(np.nextafter(np.float32(lower), np.float32(np.inf))),
             float(np.nextafter(np.float32(upper), np.float32(-np.inf)))))


def _normal_values(b: torch.Tensor, lower: float | None,
                   upper: float | None) -> torch.Tensor:
    """For the words ``b``: ``erf_inv(u)``, the standard normal before its
    factor sqrt(2) (no bounds), or ``truncated_normal``'s values."""
    if lower is None:
        return _erf_inv(_uniform_from_bits(b, _NORMAL_LO, 1.0))
    (lo, hi), clip = _truncated_range(lower, upper)
    v = _erf_inv(_uniform_from_bits(b, lo, hi)) * SQRT2
    return v.clamp(*clip)


def _normal_table(lower, upper, device: torch.device) -> torch.Tensor:
    tag = (str(device), lower, upper)
    if tag not in _TABLES:
        def values(start, stop):
            k = torch.arange(start, stop, dtype=torch.int32, device=device)
            return _normal_values(k << 9, lower, upper)
        _TABLES[tag] = _in_chunks(_MANTISSAS, device, torch.float32, values)
    return _TABLES[tag]


def _normal_draw(key, shape, lower, upper, device) -> torch.Tensor:
    """The plain version of the normal samplers (``normal_erf_inv`` without
    bounds): computed, or on the CPU looked up in the table."""
    b = _bits32(key, shape, device).reshape(-1)
    dev = b.device
    tag = (str(dev), lower, upper)
    computed = _COMPUTED.get(tag, 0)
    if dev.type != "cpu" or (b.numel() < _TABLE_MIN
                             and computed < 4 * _TABLE_MIN
                             and tag not in _TABLES):
        if dev.type == "cpu":
            _COMPUTED[tag] = computed + b.numel()
        out = _in_chunks(b.numel(), dev, torch.float32,
                         lambda s, e: _normal_values(b[s:e], lower, upper))
    else:
        table = _normal_table(lower, upper, dev)
        out = table[((b >> 9) & (_MANTISSAS - 1)).long()]
    return out.reshape(_shape(shape))


def normal_erf_inv_plain(key, shape=(), device=None) -> torch.Tensor:
    return _normal_draw(key, shape, None, None, device)


def normal_erf_inv(key, shape=(), device=None) -> torch.Tensor:
    """``erf_inv(u)`` of ``normal``'s draw: ``normal`` is this times
    float32 sqrt(2). XLA folds that factor into a later scalar product, so
    a caller that mirrors such code needs this value."""
    dev = _device(device)
    if dev.type == "cuda":
        return _k5("normal_erf_inv", dev, shape, key,
                   **_normal_params(None, None))
    return normal_erf_inv_plain(key, shape, dev)


def normal_plain(key, shape=(), device=None) -> torch.Tensor:
    return normal_erf_inv_plain(key, shape, device) * SQRT2


def normal(key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.normal`` (float32) on ``device``: sqrt(2) erf_inv(u),
    u uniform on (nextafter(-1, 0), 1)."""
    dev = _device(device)
    if dev.type == "cuda":
        return _k5("normal", dev, shape, key, **_normal_params(None, None))
    return normal_plain(key, shape, dev)


def truncated_normal_plain(key, lower: float, upper: float, shape=(),
                           device=None) -> torch.Tensor:
    return _normal_draw(key, shape, float(lower), float(upper), device)


def truncated_normal(key, lower: float, upper: float, shape=(),
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal`` (float32, scalar bounds) on
    ``device``: sqrt(2) erf_inv(u), u uniform on (erf(lower / sqrt(2)),
    erf(upper / sqrt(2))), clipped into (lower, upper)."""
    dev = _device(device)
    if dev.type == "cuda":
        return _k5("truncated_normal", dev, shape, key,
                   **_normal_params(float(lower), float(upper)))
    return truncated_normal_plain(key, lower, upper, shape, dev)


def _normal_params(lower: float | None, upper: float | None) -> dict:
    """K5's scalars for a normal sampler: the uniform's range, the clip."""
    if lower is None:
        lo, span = _uniform_range(_NORMAL_LO, 1.0)
        return {"lo": lo, "span": span}
    (lo, hi), clip = _truncated_range(lower, upper)
    lo, span = _uniform_range(lo, hi)
    return {"lo": lo, "span": span, "clip": clip}


def normal_from_words(words: torch.Tensor, lower: float | None = None,
                      upper: float | None = None) -> torch.Tensor:
    """``normal``'s values (no bounds) or ``truncated_normal``'s of the
    random words ``words`` (int32), on their device: one K5 launch on the
    card, the plain version on the CPU. A check feeds every mantissa
    through both."""
    if words.device.type == "cuda":
        kind = "normal" if lower is None else "truncated_normal"
        return _k5(kind, words.device, words=words,
                   **_normal_params(lower, upper))
    v = _normal_values(words, lower, upper)
    return v * SQRT2 if lower is None else v


def bernoulli_plain(key, p: float = 0.5, shape=(),
                    device=None) -> torch.Tensor:
    return uniform_plain(key, shape, device=device) < _f32(p)


def bernoulli(key, p: float = 0.5, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode ``low``): uniform < p, as bool."""
    dev = _device(device)
    if dev.type == "cuda":
        return _k5("bernoulli", dev, shape, key, p=_f32(p))
    return bernoulli_plain(key, p, shape, dev)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b`` mod 2**32 for 32-bit words, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _rem(a, span: int):
    """XLA's unsigned remainder: ``a % 0`` is ``a``."""
    return a % span if span else a


def _randint_range(minval: int, maxval: int) -> tuple[int, int, int]:
    """``(minval, span, mult)`` of ``randint``, in uint32 arithmetic as JAX
    reduces two words modulo the span (``minval`` clamped to int32)."""
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    out_of_range = maxval > hi32
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    span = (maxval - minval) & M32
    if maxval <= minval:
        span = 1
    if out_of_range and maxval > minval:
        span = (span + 1) & M32
    return minval, span, _rem(_rem(2 ** 16, span) ** 2 & M32, span)


def randint_plain(key, shape=(), minval: int = 0, maxval: int = 1,
                  device=None) -> torch.Tensor:
    minval, span, mult = _randint_range(minval, maxval)
    k1, k2 = split(key)
    higher, lower = bits_plain(k1, shape, device), bits_plain(k2, shape, device)
    off = (_mul32(_rem(higher, span), mult) + _rem(lower, span)) & M32
    off = _rem(off, span)
    v = (minval + off) & M32
    return torch.where(v > 2 ** 31 - 1, v - 2 ** 32, v)


def randint(key, shape=(), minval: int = 0, maxval: int = 1,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` (int32, scalar bounds) as an int64 tensor on
    ``device``: two words per value from ``split(key)``, reduced modulo
    the span as JAX does (in uint32 arithmetic)."""
    dev = _device(device)
    if dev.type == "cuda":
        lo, span, mult = _randint_range(minval, maxval)
        k1, k2 = split(key)
        return _k5("randint", dev, shape, k1, key2=k2, span_u=span,
                   mult=mult, minval=lo)
    return randint_plain(key, shape, minval, maxval, dev)


def _permutation(key, n: int, device, words) -> torch.Tensor:
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        # the sign bit flipped, signed order is the words' unsigned order
        order = torch.sort(words(sub) ^ -2 ** 31, stable=True).indices
        x = x[order]
    return x


def permutation_plain(key, n: int, device=None) -> torch.Tensor:
    return _permutation(key, n, device,
                        lambda sub: _bits32(sub, (n,), device))


def permutation(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds of a stable sort of the values by fresh 32-bit words (on the
    card, each round's words from one K5 launch)."""
    dev = _device(device)
    if dev.type == "cuda":
        return _permutation(key, n, dev,
                            lambda sub: _k5("bits32", dev, (n,), sub))
    return permutation_plain(key, n, dev)


# The plain version of each sampler, on any device (K5's twin on the card)
PLAIN = {"bits": bits_plain, "uniform": uniform_plain,
         "normal": normal_plain, "normal_erf_inv": normal_erf_inv_plain,
         "truncated_normal": truncated_normal_plain,
         "bernoulli": bernoulli_plain, "randint": randint_plain,
         "permutation": permutation_plain}
