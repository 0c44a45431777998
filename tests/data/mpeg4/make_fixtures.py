"""Write the MPEG-4 Part 2 video fixtures beside this file, with OpenCV's
answers, for ``tests/test_torch_mpeg4.py`` and for checks on a machine that
has no OpenCV (``chip_smoke.py``'s preprocess phase):

- ``print_720p.mp4``: ``tests/data/video/make_fixtures.py``'s 40 frames of
  a print moving over the bed, 1280x720 at 10 fps, written by
  ``cv2.VideoWriter`` as ``mp4v`` in MP4;
- the small clips of ``CLIPS``, each written by ``cv2.VideoWriter`` with
  its fourcc into its container, their content chosen to provoke a tool of
  the decoder (``scene``);
- ``crafted_72x40.avi``: hand-written VOPs (``crafted_samples``, the
  bitstream writer below) in an AVI: intra blocks of 0s and 255s, P-VOPs
  whose vectors take every half-pel case in both rounding types and point
  outside the frame, ``f_code`` 2 and 3, VOPs with ``vop_coded`` 0 and the
  intra DC inside the AC VLC (``intra_dc_vlc_thr``), tools that FFmpeg's
  encoder does not write;
- ``manifest.json``: per clip, ``cv2.VideoCapture``'s rate, frame count
  and the sha256 of each frame's BGR bytes, and what the port's decoder
  counted in it (``counts``); two frames of the 720p clip as
  ``print_720p_f<i>.png``.

    python tests/data/mpeg4/make_fixtures.py

Needs OpenCV (and the port, for the counts).
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpusr_torch.data import mpeg4 as m  # noqa: E402  (the VLC tables)

_spec = importlib.util.spec_from_file_location(
    "video_fixtures", os.path.join(REPO, "tests", "data", "video",
                                   "make_fixtures.py"))
vfx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(vfx)

# name -> (fourcc, (width, height), frames, scene)
CLIPS = {
    "pan_96x64.mp4": ("mp4v", (96, 64), 16, "pan"),
    "static_80x48.mov": ("mp4v", (80, 48), 16, "static"),
    "noise_64x64.avi": ("XVID", (64, 64), 16, "noise"),
    "edge_100x60.avi": ("DIVX", (100, 60), 16, "edge"),
    "cut_144x80.avi": ("FMP4", (144, 80), 16, "cut"),
}
PRINT = "print_720p.mp4"
CRAFTED = "crafted_72x40.avi"


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ------------------------------------------------------------------ scenes
def scene(kind: str, w: int, h: int, t: int) -> np.ndarray:
    """Frame ``t`` of a small clip (BGR uint8), from numpy arithmetic."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind in ("pan", "edge"):
        # a texture moving by half and whole pixels, in x, y and both
        steps = [(0.5, 0), (0, 0.5), (0.5, 0.5), (1, 0), (0, 1), (1.5, -0.5),
                 (-0.5, 1.5), (2, 2)]
        dx = sum(steps[k % len(steps)][0] for k in range(t))
        dy = sum(steps[k % len(steps)][1] for k in range(t))
        if kind == "edge":             # and across the picture's edges
            dx, dy = 3.5 * t - 20, 1.5 * t - 6
        x, y = xx - dx, yy - dy
        v = 128 + 60 * np.sin(x / 6.1) * np.cos(y / 7.3) + 40 * np.sin(
            (x + 2 * y) / 11.0)
        img = np.stack([v, 255 - v, 0.5 * v + 40], -1)
        if kind == "edge":
            img[((np.floor(x / 6) + np.floor(y / 6)) % 2) == 0] *= 0.3
    elif kind == "static":
        v = 100 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 3.0)
        img = np.stack([v, v * 0.8, 255 - v], -1)
        x0, y0 = 4 + 3 * t, 8 + t // 2
        img[y0: y0 + 12, x0: x0 + 12] = (30, 220, 250)
    elif kind == "noise":
        # a drifting wave with noise on a third of the MBs: escapes, long
        # vectors (f_code 2)
        base = 128 + 50 * np.sin((xx - 2 * t) / 5.0)
        noisy = ((xx // 16 + yy // 16 + t) % 3) == 0
        img = np.stack([base] * 3, -1) + np.random.default_rng(t).normal(
            0, 40, (h, w, 3)) * noisy[..., None]
    elif kind == "cut":
        if t < 7:
            return vfx.print_frame(t, w, h)
        v = 200 - 150 * ((np.floor(xx / 9) + np.floor(yy / 5)) % 2)
        img = np.stack([v, 255 - v, 128 + 0 * v], -1)
        img[:, : 2 * t] = 20
    else:
        raise ValueError(kind)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def write_clip(path: str, fourcc: str, frames, fps: float = 10.0) -> None:
    import cv2
    frames = list(frames)
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not out.isOpened():
        raise RuntimeError(f"cv2.VideoWriter refused {path} ({fourcc})")
    for f in frames:
        out.write(f)
    out.release()


def write_named_clip(directory: str, name: str) -> str:
    """Write ``CLIPS[name]`` (or the 720p clip) into ``directory``."""
    path = os.path.join(directory, name)
    if name == PRINT:
        write_clip(path, "mp4v", (vfx.print_frame(i) for i in range(40)))
        return path
    fourcc, (w, h), n, kind = CLIPS[name]
    write_clip(path, fourcc, (scene(kind, w, h, t) for t in range(n)))
    return path


def read_cv2(path: str):
    """``cv2.VideoCapture``'s frames and rate."""
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


# ------------------------------------------------------- a bitstream writer
def _symbols(codes, levels):
    syms = [(last, run, lev) for last in (0, 1)
            for run, n in enumerate(levels[last]) for lev in range(1, n + 1)]
    return dict(zip(syms, codes[:-1]))


_TCOEF = {"inter": (_symbols(m._INTER_CODES, m._INTER_LEVELS), m._INTER[1:]),
          "intra": (_symbols(m._INTRA_CODES, m._INTRA_LEVELS), m._INTRA[1:])}
MVTAB = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
         (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10),
         (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10),
         (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11),
         (3, 11), (2, 11), (3, 12), (2, 12)]
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
MCBPC_I = [(1, 1), (1, 3), (2, 3), (3, 3)]
# P-VOP MCBPC by (mb type, cbpc): 0 inter, 1 inter+q, 2 inter4v, 3 intra
MCBPC_P = {(0, 0): (1, 1), (1, 0): (3, 3), (2, 0): (2, 3), (3, 0): (3, 5),
           (4, 0): (4, 6)}
MCBPC_P_INTRA = [(3, 5), (4, 8), (3, 8), (3, 7)]
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
          (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
            (1, 8), (1, 9), (1, 10), (1, 11), (1, 12)]


class Bits:
    """An MSB-first bit writer."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> "Bits":
        self.bits.extend((value >> (n - 1 - k)) & 1 for k in range(n))
        return self

    def code(self, code_bits) -> "Bits":
        return self.put(*code_bits)

    def align(self) -> "Bits":
        """``next_start_code``'s stuffing: a 0, then 1s to the byte."""
        self.bits.append(0)
        while len(self.bits) % 8:
            self.bits.append(1)
        return self

    def bytes(self) -> bytes:
        b = np.array(self.bits, np.uint8).reshape(-1, 8)
        return np.packbits(b, axis=1).reshape(-1).tobytes()


VOL_DEFAULTS = dict(vo_type=1, verid=None, chroma_format=1, low_delay=1,
                    shape=0, resolution=10, interlaced=0, obmc_disable=1,
                    sprite=0, not_8_bit=0, quant_type=0, quarter_sample=0,
                    complexity_disable=1, resync_disable=1,
                    data_partitioned=0, scalability=0, video_signal_type=0)


def headers(w: int, h: int, user: bytes = b"Lavc62.28.101", **fields) -> bytes:
    """VOS, visual object, VO and VOL headers (and an encoder's user data)
    as FFmpeg's encoder lays them out; ``fields`` override the VOL's."""
    f = dict(VOL_DEFAULTS, **fields)
    o = Bits().put(0x1B0, 32).put(1, 8).put(0x1B5, 32).put(0, 1).put(1, 4)
    o.put(f["video_signal_type"], 1)
    if f["video_signal_type"]:
        o.put(5, 3).put(1, 1).put(0, 1)          # full range, no matrix
    o.align().put(0x100, 32).put(0x120, 32)
    o.put(0, 1).put(f["vo_type"], 8)
    if f["verid"]:
        o.put(1, 1).put(f["verid"], 4).put(1, 3)
    else:
        o.put(0, 1)
    o.put(1, 4)                                  # square pixels
    o.put(1, 1).put(f["chroma_format"], 2).put(f["low_delay"], 1).put(0, 1)
    o.put(f["shape"], 2).put(1, 1).put(f["resolution"], 16).put(1, 1)
    o.put(0, 1).put(1, 1).put(w, 13).put(1, 1).put(h, 13).put(1, 1)
    o.put(f["interlaced"], 1).put(f["obmc_disable"], 1)
    o.put(f["sprite"], 1 if (f["verid"] or 1) == 1 else 2)
    o.put(f["not_8_bit"], 1).put(f["quant_type"], 1)
    if (f["verid"] or 1) != 1:
        o.put(f["quarter_sample"], 1)
    o.put(f["complexity_disable"], 1).put(f["resync_disable"], 1)
    o.put(f["data_partitioned"], 1)
    if (f["verid"] or 1) != 1:
        o.put(0, 1).put(0, 1)                    # newpred, reduced res
    o.put(f["scalability"], 1).align()
    out = o.bytes()
    return out + (b"\0\0\1\xb2" + user if user else b"")


def _coefficients(o: Bits, scan: list, start: int, kind: str) -> None:
    """``scan``'s levels from position ``start`` on, each by its VLC code,
    or by escape 1, 2 or 3 when it has none, as an encoder picks them."""
    tab, (max_level, max_run) = _TCOEF[kind]
    nz = [i for i in range(start, 64) if scan[i]]
    prev = start - 1
    for j, i in enumerate(nz):
        last, run, lev = int(j == len(nz) - 1), i - prev - 1, scan[i]
        prev, a, s = i, abs(lev), int(lev < 0)
        if (last, run, a) in tab:
            o.code(tab[(last, run, a)]).put(s, 1)
            continue
        o.put(3, 7)
        lmax = max_level[last][run] if run < len(max_level[last]) else 0
        if lmax and (last, run, a - lmax) in tab:
            o.put(0, 1).code(tab[(last, run, a - lmax)]).put(s, 1)
            continue
        if a < len(max_run[last]) and (last, 0, a) in tab and (
                last, run - max_run[last][a] - 1, a) in tab:
            o.put(2, 2).code(tab[(last, run - max_run[last][a] - 1, a)])
            o.put(s, 1)
            continue
        o.put(3, 2).put(last, 1).put(run, 6).put(1, 1).put(lev & 0xFFF, 12)
        o.put(1, 1)


def vop_header(kind: int, q: int, rounding: int = 0, fcode: int = 1,
               thr_code: int = 0, coded: int = 1, tinc: int = 0,
               tbits: int = 4) -> Bits:
    o = Bits().put(0x1B6, 32).put(kind, 2).put(0, 1).put(1, 1)
    o.put(tinc, tbits).put(1, 1).put(coded, 1)
    if coded:
        if kind == 1:
            o.put(rounding, 1)
        o.put(thr_code, 3).put(q, 5)
        if kind == 1:
            o.put(fcode, 3)
    return o


def _levels(block: np.ndarray, q: int, dc_scale: int) -> np.ndarray:
    """A float forward DCT of an 8x8 block, quantised (DC by
    ``dc_scale``, AC by 2q): (64,) ints in natural order."""
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(
        k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    f = (c @ block.astype(np.float64) @ c.T).reshape(64)
    lev = np.zeros(64, np.int64)
    lev[0] = int(round(f[0] / dc_scale))
    lev[1:] = np.clip(np.trunc(f[1:] / (2 * q)), -2047, 2047)
    return lev


class _Intra:
    """The DC and AC predictors of one VOP's intra blocks, as the decoder
    keeps them: per plane, by block position with a border, the DC times its
    scale (1024 outside and at non-intra MBs) and each block's first column
    and row (zeros there)."""

    def __init__(self, mbw: int, mbh: int):
        self.dc = [np.full((2 * mbh + 1, 2 * mbw + 1), 1024, np.int64),
                   np.full((mbh + 1, mbw + 1), 1024, np.int64),
                   np.full((mbh + 1, mbw + 1), 1024, np.int64)]
        self.ac = [{}, {}, {}]

    def mb(self, o: Bits, planes, mx: int, my: int, q: int, dc_vlc: bool,
           ac_pred: bool, mcbpc) -> None:
        """Code MB (mx, my) of ``planes`` as an intra MB."""
        ys, cs = m._Y_DC_SCALE[q], m._C_DC_SCALE[q]
        scans = []
        for n in range(6):
            if n < 4:
                plane, by, bx = 0, 2 * my + (n >> 1), 2 * mx + (n & 1)
                scale = ys
            else:
                plane, by, bx, scale = n - 3, my, mx, cs
            px = planes[plane][by * 8: by * 8 + 8, bx * 8: bx * 8 + 8]
            lev = _levels(px, q, scale)
            g = self.dc[plane]
            a, b, c = g[by + 1, bx], g[by, bx], g[by, bx + 1]
            top = abs(a - b) < abs(b - c)
            pred = c if top else a
            g[by + 1, bx + 1] = min(2047, max(0, lev[0] * scale))
            coded = lev.copy()
            coded[0] = lev[0] - (pred + (scale >> 1)) // scale
            acs = self.ac[plane]
            if ac_pred:
                if top:
                    coded[1:8] -= acs.get((by - 1, bx), (0,) * 14)[7:]
                else:
                    coded[8::8] -= acs.get((by, bx - 1), (0,) * 14)[:7]
            acs[(by, bx)] = tuple(lev[8::8]) + tuple(lev[1:8])
            order = (m.ZIGZAG if not ac_pred else
                     m.ALT_HORIZONTAL if top else m.ALT_VERTICAL)
            scans.append([int(coded[order[i]]) for i in range(64)])
        start = 1 if dc_vlc else 0
        cbp = sum(1 << (5 - n) for n in range(6) if any(scans[n][start:]))
        o.code(mcbpc[cbp & 3]).put(int(ac_pred), 1).code(CBPY[cbp >> 2])
        for n in range(6):
            diff = scans[n][0]
            if dc_vlc:
                size = abs(diff).bit_length()
                o.code((DC_LUM if n < 4 else DC_CHROM)[size])
                if size:
                    o.put(diff if diff > 0 else diff + (1 << size) - 1, size)
                    if size > 8:
                        o.put(1, 1)
            if cbp >> (5 - n) & 1:
                _coefficients(o, scans[n], start, "intra")


def i_vop(planes, q: int = 1, thr_code: int = 0, tinc: int = 0,
          ac_pred=lambda mx, my: False) -> bytes:
    """An I-VOP coding ``planes`` (Y, U, V of whole MBs); ``ac_pred(mx,
    my)`` says which MBs predict their AC coefficients."""
    mbh, mbw = planes[0].shape[0] // 16, planes[0].shape[1] // 16
    o = vop_header(0, q, thr_code=thr_code, tinc=tinc)
    intra = _Intra(mbw, mbh)
    for my in range(mbh):
        for mx in range(mbw):
            intra.mb(o, planes, mx, my, q, q < m._DC_THRESHOLD[thr_code],
                     ac_pred(mx, my), MCBPC_I)
    return o.align().bytes()


def p_vop(mvs, q: int = 2, rounding: int = 0, fcode: int = 1,
          tinc: int = 0, planes=None) -> bytes:
    """A P-VOP: ``mvs[my][mx]`` a half-pel vector (x, y) of an inter MB
    without residual, None for a ``not_coded`` MB, or "intra" for an intra
    MB coding ``planes`` (its AC predicted when mx + my is even)."""
    mbh, mbw = len(mvs), len(mvs[0])
    o = vop_header(1, q, rounding, fcode, tinc=tinc)
    lim = 1 << (4 + fcode)
    got, intra = {}, _Intra(mbw, mbh)
    for my in range(mbh):
        for mx in range(mbw):
            v = mvs[my][mx]
            if v is None:
                o.put(1, 1)
                continue
            if v == "intra":
                o.put(0, 1)
                intra.mb(o, planes, mx, my, q, True, (mx + my) % 2 == 0,
                         MCBPC_P_INTRA)
                got[(mx, my)] = (0, 0)
                continue
            o.put(0, 1).code(MCBPC_P[(0, 0)]).code(CBPY[15])
            a = got.get((mx - 1, my), (0, 0))
            if my == 0:
                pred = a
            else:
                b = got.get((mx, my - 1), (0, 0))
                c = got.get((mx + 1, my - 1), (0, 0))
                pred = tuple(sorted((a[k], b[k], c[k]))[1] for k in (0, 1))
            for k in (0, 1):
                d = ((v[k] - pred[k] + lim) % (2 * lim)) - lim
                if d == 0:
                    o.put(1, 1)
                    continue
                bs, val = fcode - 1, abs(d) - 1
                o.code(MVTAB[(val >> bs) + 1]).put(int(d < 0), 1)
                if bs:
                    o.put(val & ((1 << bs) - 1), bs)
            got[(mx, my)] = v
    return o.align().bytes()


def crafted_samples(w: int = 72, h: int = 40, seed: int = 0) -> list:
    """The hand-written stream of ``crafted_72x40.avi``: one AVI chunk per
    VOP, the headers in band before the first."""
    rng = np.random.default_rng(seed)
    mbw, mbh = -(-w // 16), -(-h // 16)

    def planes():
        return (rng.choice([0, 0, 255, 1, 3, 128, 77, 254],
                           (mbh * 16, mbw * 16)),
                rng.choice([0, 0, 255, 1, 129, 3], (mbh * 8, mbw * 8)),
                rng.choice([0, 255, 3, 100, 0, 1], (mbh * 8, mbw * 8)))

    def vectors(r, half=None, fixed=None):
        out = []
        for my in range(mbh):
            row = []
            for mx in range(mbw):
                if fixed is not None:
                    row.append(fixed)
                    continue
                x, y = (int(v) for v in rng.integers(-r, r, 2))
                if half is not None:
                    x, y = 2 * (x // 2) + half[0], 2 * (y // 2) + half[1]
                row.append((x, y))
            out.append(row)
        return out

    samples = [headers(w, h) + i_vop(planes())]
    t = 0
    for rounding in (0, 1):
        for half in ((1, 0), (0, 1), (1, 1), (0, 0)):
            t += 1
            samples.append(p_vop(vectors(12, half), rounding=rounding,
                                 tinc=t % 10))
        samples.append(i_vop(planes(), tinc=t % 10,
                             ac_pred=lambda mx, my: (mx + my + rounding) % 2))
    mixed = vectors(12)
    for mx, my in ((0, 0), (1, 0), (2, 1), (3, 1), (4, 2), (0, 2)):
        mixed[my % mbh][mx % mbw] = "intra"   # intra MBs inside a P-VOP
    mixed[1 % mbh][1 % mbw] = None
    t += 1
    samples.append(p_vop(mixed, rounding=1, tinc=t % 10, planes=planes()))
    for fcode in (2, 3):                     # long vectors, far outside
        t += 1
        samples.append(p_vop(vectors(30 << (fcode - 1)), fcode=fcode,
                             rounding=t % 2, tinc=t % 10))
    t += 1
    samples.append(vop_header(1, 2, coded=0, tinc=t % 10).align().bytes())
    skip = vectors(4)
    skip[0][1 % mbw] = skip[1 % mbh][2 % mbw] = None     # not_coded MBs
    samples.append(p_vop(skip, rounding=1, tinc=t % 10))
    for thr_code, q in ((7, 2), (1, 14), (3, 9)):   # DC inside the AC VLC
        t += 1
        samples.append(i_vop(planes(), q=q, thr_code=thr_code, tinc=t % 10))
        samples.append(p_vop(vectors(20), rounding=t % 2, tinc=t % 10))
    return samples


def write_crafted(path: str) -> None:
    vfx.write_avi(path, crafted_samples(), 72, 40, fourcc=b"FMP4")


# ---------------------------------------------------------------- manifest
def clip_entry(path: str, keep=()) -> dict:
    from tpusr_torch.data.video import open_video

    frames, fps = read_cv2(path)
    for i in keep:
        import cv2
        cv2.imwrite(path[:-4] + f"_f{i}.png", frames[i])
    video = open_video(path)
    for _ in video.frames():
        pass
    return {"fps": fps, "frames": len(frames), "height": frames[0].shape[0],
            "width": frames[0].shape[1], "sha256": [sha(f) for f in frames],
            "png_frames": list(keep), "counts": dict(sorted(
                video.counts.items()))}


def main() -> None:
    clips = {}
    write_named_clip(HERE, PRINT)
    clips[PRINT] = clip_entry(os.path.join(HERE, PRINT), (0, 20))
    for name in CLIPS:
        clips[name] = clip_entry(write_named_clip(HERE, name))
    write_crafted(os.path.join(HERE, CRAFTED))
    clips[CRAFTED] = clip_entry(os.path.join(HERE, CRAFTED))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"clips": clips}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
