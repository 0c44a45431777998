"""A bounded search for Intel IPP's float arithmetic in uint8
``INTER_CUBIC`` at x3, where ``_cv_ops.ipp_cubic`` still rounds some
half-level ties the other way (``tests/test_torch_eda.py``'s
``X3_CUBIC_MISMATCH``). Each variant is a tap family x a horizontal sum
order x a vertical sum order (rounding half to even), counted against
``cv2.resize`` on the test's x3 images and two more; the best are then
counted on the x2, x2.5 and x4 cases, where ``ipp_cubic`` is exact.

Tap families: the current one (fraction in float32, outer taps as powers
of it, the second as one minus the rest), the same per tabulated phase
(which at x3 gives the same taps),
the Keys distance polynomials (powers, Horner, Horner with FMA, each also
normalised by the taps' sum), the distance polynomials in double rounded
to float32, OpenCV's ``interpolateCubic`` in Horner form with and without
FMA. Sum orders: pairs, in sequence, reversed, an FMA chain either way,
FMA pairs either way. Also the passes swapped (vertical first).

    python tests/torch_cubic_x3_sweep.py

Needs OpenCV; prints the best variants. An FMA is its product and sum in
double, rounded once to float32.
"""

import itertools

import cv2
import numpy as np

f = np.float32


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def taps(n_in, n_out, kind):
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(src).astype(np.int64)
    t64 = src - x0
    t = t64.astype(np.float32)
    one = np.ones_like(t)
    if kind in ("current", "tabulated"):
        t2 = t * t
        t3 = t2 * t
        w0 = f(-0.75) * t3 + f(1.5) * t2 + f(-0.75) * t
        w2 = f(-1.25) * t3 + f(1.5) * t2 + f(0.75) * t
        w3 = f(0.75) * t3 - f(0.75) * t2
        w = [w0, f(1) - w0 - w2 - w3, w2, w3]
    elif kind == "distance-double":
        w = [(((1.25 * d - 2.25) * d * d + 1) if i in (1, 2)
              else (((-0.75 * d + 3.75) * d - 6) * d + 3)).astype(np.float32)
             for i, d in enumerate((1 + t64, t64, 1 - t64, 2 - t64))]
    elif kind.startswith("distance"):
        w = []
        for i, d in enumerate((f(1) + t, t, f(1) - t, f(2) - t)):
            inner = i in (1, 2)
            if "fma" in kind:
                v = fma(fma(f(1.25) * one, d, f(-2.25) * one) * d, d, one) \
                    if inner else fma(fma(fma(f(-0.75) * one, d,
                                              f(3.75) * one),
                                          d, f(-6) * one), d, f(3) * one)
            elif "horner" in kind:
                v = (f(1.25) * d - f(2.25)) * d * d + f(1) if inner \
                    else ((f(-0.75) * d + f(3.75)) * d - f(6)) * d + f(3)
            else:
                v = f(1.25) * d ** 3 - f(2.25) * d * d + f(1) if inner \
                    else f(-0.75) * d ** 3 + f(3.75) * d * d - f(6) * d + f(3)
            w.append(v.astype(np.float32))
        if kind.endswith("normalised"):
            s = ((w[0] + w[1]) + w[2]) + w[3]
            w = [v / s for v in w]
    else:                                   # interpolateCubic, Horner
        a = f(-0.75)
        x = t + f(1)
        u = f(1) - t
        if kind == "opencv-horner":
            w0 = ((a * x - f(5) * a) * x + f(8) * a) * x - f(4) * a
            w1 = ((a + f(2)) * t - (a + f(3))) * t * t + f(1)
            w2 = ((a + f(2)) * u - (a + f(3))) * u * u + f(1)
        else:
            w0 = fma(fma(fma(a * one, x, -f(5) * a * one), x, f(8) * a * one),
                     x, -f(4) * a * one)
            w1 = fma(fma((a + f(2)) * one, t, -(a + f(3)) * one) * t, t, one)
            w2 = fma(fma((a + f(2)) * one, u, -(a + f(3)) * one) * u, u, one)
        w = [w0, w1, w2, f(1) - w0 - w1 - w2]
    idx = np.clip(x0[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, [v.astype(np.float32) for v in w]


def combine(s, w, order):
    q = [s[i] * w[i] for i in range(4)]
    if order == "pairs":
        return (q[0] + q[1]) + (q[2] + q[3])
    if order == "sequence":
        return ((q[0] + q[1]) + q[2]) + q[3]
    if order == "reversed":
        return ((q[3] + q[2]) + q[1]) + q[0]
    if order == "fma-chain":
        a = q[0]
        for i in (1, 2, 3):
            a = fma(s[i], w[i], a)
        return a
    if order == "fma-chain-reversed":
        a = q[3]
        for i in (2, 1, 0):
            a = fma(s[i], w[i], a)
        return a
    if order == "fma-pairs":
        return fma(s[0], w[0], q[1]) + fma(s[2], w[2], q[3])
    return fma(s[1], w[1], q[0]) + fma(s[3], w[3], q[2])   # reversed pairs


ORDERS = ("pairs", "sequence", "reversed", "fma-chain", "fma-chain-reversed",
          "fma-pairs", "fma-pairs-reversed")
KINDS = ("current", "tabulated", "distance", "distance-horner",
         "distance-fma", "distance-normalised", "distance-horner-normalised",
         "distance-fma-normalised", "distance-double", "opencv-horner",
         "opencv-fma")


def resize(img, oh, ow, kind, ho, vo):
    h, w, _ = img.shape
    xi, xw = taps(w, ow, kind)
    yi, yw = taps(h, oh, kind)
    x = img.astype(np.float32)
    s = [x[:, xi[:, k]] for k in range(4)]
    hor = combine(s, [np.broadcast_to(v[None, :, None], s[0].shape)
                      for v in xw], ho)
    r = [hor[yi[:, k]] for k in range(4)]
    v = combine(r, [np.broadcast_to(v[:, None, None], r[0].shape)
                    for v in yw], vo)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def case(factor, seed, hw):
    h, w = hw
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    oh, ow = int(h * factor), int(w * factor)
    return img, oh, ow, cv2.resize(img, (ow, oh),
                                   interpolation=cv2.INTER_CUBIC)


def count(cases, kind, ho, vo, swapped=False):
    n = 0
    for img, oh, ow, want in cases:
        if swapped:
            got = resize(np.ascontiguousarray(img.transpose(1, 0, 2)), ow, oh,
                         kind, ho, vo).transpose(1, 0, 2)
        else:
            got = resize(img, oh, ow, kind, ho, vo)
        n += int((got != want).sum())
    return n


def main():
    x3 = [case(3, 3, hw) for hw in ((12, 12), (16, 9), (32, 32))]
    x3 += [case(3, s, (24, 40)) for s in (7, 8)]
    others = [case(fa, fa if isinstance(fa, int) else int(10 * fa), hw)
              for fa in (2, 4, 2.5) for hw in ((12, 12), (16, 9), (32, 32))]
    values = sum(w.size for *_, w in x3)
    res = sorted((count(x3, k, ho, vo, sw), k, ho, vo, sw)
                 for sw in (False, True)
                 for k, ho, vo in itertools.product(KINDS, ORDERS, ORDERS))
    print(f"{len(res)} variants on {values} x3 values; the best:")
    for n, k, ho, vo, sw in res[:8]:
        print(f"  {n:4d} mismatches: taps {k}, horizontal {ho}, vertical "
              f"{vo}{', passes swapped' if sw else ''}; on x2/x2.5/x4: "
              f"{count(others, k, ho, vo, sw)}")


if __name__ == "__main__":
    main()
