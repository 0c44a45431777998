"""Motion-JPEG in AVI, read as ``cv2.VideoCapture`` reads it on x86.

The JAX package reads the print videos with OpenCV, whose FFmpeg backend
demuxes the AVI, decodes each frame with FFmpeg's MJPEG decoder and
converts it to BGR with swscale. The port has no video library, so it
carries this reader:

- the RIFF ``AVI `` container (OpenDML ``AVIX`` extensions too): the first
  video stream's ``strh`` (its ``dwRate / dwScale`` is the rate
  ``CAP_PROP_FPS`` gives) and ``strf`` (its compression must be MJPEG; any
  other codec, and any other container such as MP4 or Matroska, is refused
  by name), then that stream's ``##dc``/``##db`` chunks of ``movi`` in file
  order, ``LIST rec`` groups included; the main header ``avih`` and the
  indexes (``idx1``, ``ix##``) are not needed;
- each frame's JPEG parsed and Huffman-decoded by the port's decoder
  (``pipeline/jpeg.py``), then FFmpeg's arithmetic, not libjpeg's: the
  DC predictor starts at 1024 (the level shift), coefficients are kept in
  int16, the 8-bit ``simple_idct`` (rows then columns, the DC-only row
  shortcut), and swscale's unscaled ``yuv420p``/``yuv422p`` -> ``bgr24``
  converter as its SSSE3 code computes it for full-range (JPEG) input: the
  chroma sample repeated over its 2x2 (or 2x1) pixels, the planes scaled by
  8, ``pmulhw`` with the BT.601 coefficients scaled by 224/255, saturated
  to 0..255. Gray frames are replicated to three channels.

Frames at 4:2:0 and 4:2:2 of even height (what ``cv2.VideoWriter`` writes)
and gray frames are read; other subsampling and odd heights, which send
swscale to its scaling path, are refused by name.

``read_avi`` parses the container; its frames decode when asked for, so a
caller that samples one frame in ten decodes one in ten.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from tpusr_torch.pipeline.jpeg import parse_jpeg

_MJPEG = {b"MJPG", b"mjpg", b"AVRn", b"LJPG", b"JPGL", b"dmb1", b"jpeg",
          b"JPEG", b"MJPA", b"AVDJ", b"ACDV", b"QIVG", b"SLMJ"}
_CONTAINERS = ((4, b"ftyp", "MP4/QuickTime"), (0, b"\x1aE\xdf\xa3",
                                                 "Matroska/WebM"),
               (0, b"OggS", "Ogg"), (0, b"FLV", "FLV"),
               (0, b"\x00\x00\x01\xba", "MPEG-PS"), (0, b"G", "MPEG-TS"))
# simple_idct's 8-bit weights, round(cos(k pi / 16) sqrt(2) 2^14)
_W1, _W2, _W3, _W4, _W5, _W6, _W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


@dataclasses.dataclass
class AviVideo:
    """A parsed MJPEG AVI: frame size, the stream's rate (``CAP_PROP_FPS``,
    0 when the header has none), its fourcc and each frame's JPEG bytes."""
    width: int
    height: int
    fps: float
    fourcc: str
    chunks: list

    def __len__(self) -> int:
        return len(self.chunks)

    def frame(self, i: int) -> np.ndarray:
        """Frame ``i`` as (h, w, 3) uint8 BGR, as ``VideoCapture.read``."""
        return decode_mjpeg_frame(self.chunks[i])

    def frames(self):
        """The frames in order, each a zero-argument callable that decodes
        it (so that unsampled frames are never decoded)."""
        return [lambda c=c: decode_mjpeg_frame(c) for c in self.chunks]


def _refuse_container(head: bytes, path: str) -> None:
    for at, magic, name in _CONTAINERS:
        if head[at: at + len(magic)] == magic:
            raise ValueError(f"{path}: a {name} file; the port reads MJPEG "
                             f"in AVI only")
    raise ValueError(f"{path}: not a RIFF AVI file")


def _walk(data: bytes, pos: int, end: int, chunks: list, stream: list) -> None:
    """Collect each stream's headers and every stream's frame chunks
    (stream number, payload) of a RIFF list."""
    while pos + 8 <= end:
        cid = data[pos: pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4: pos + 8])
        body_end = min(pos + 8 + size, end)
        if cid in (b"RIFF", b"LIST"):
            kind = data[pos + 8: pos + 12]
            if kind == b"strl":
                stream.append({})
            _walk(data, pos + 12, body_end, chunks, stream)
        elif cid in (b"strh", b"strf") and stream:
            stream[-1].setdefault(cid.decode(), data[pos + 8: body_end])
        elif cid[2:] in (b"dc", b"db") and cid[:2].isdigit():
            chunks.append((int(cid[:2]), data[pos + 8: body_end]))
        pos += 8 + size + (size & 1)


def read_avi(path: str) -> AviVideo:
    """Parse the AVI at ``path`` (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        _refuse_container(data[:12], path)
    chunks, streams = [], []
    _walk(data, 0, len(data), chunks, streams)
    video = next((i for i, s in enumerate(streams)
                  if s.get("strh", b"")[:4] == b"vids"), None)
    if video is None:
        raise ValueError(f"{path}: an AVI with no video stream")
    strh, strf = streams[video]["strh"], streams[video].get("strf", b"")
    if len(strh) < 32 or len(strf) < 20:
        raise ValueError(f"{path}: the video stream's headers are truncated")
    handler = strh[4:8]
    compression = strf[16:20]
    if compression not in _MJPEG:
        name = compression.decode("latin-1").strip("\x00 ") or repr(compression)
        raise ValueError(f"{path}: the video codec is {name}, not MJPEG; the "
                         f"port reads MJPEG in AVI only")
    scale, rate = struct.unpack("<II", strh[20:28])
    fps = rate / scale if scale else 0.0
    width, height = struct.unpack("<ii", strf[4:12])
    return AviVideo(width, abs(height), fps,
                    (handler if handler.strip(b"\x00") else compression)
                    .decode("latin-1"),
                    [c for s, c in chunks if s == video and c])


def _i16(x: np.ndarray) -> np.ndarray:
    return ((x + 32768) & 0xFFFF) - 32768


def _i32(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def simple_idct(block: np.ndarray) -> np.ndarray:
    """FFmpeg's 8-bit ``simple_idct`` put of (..., 8, 8) dequantised
    coefficients (row = vertical frequency, DC carrying the +1024 level
    shift) -> (..., 8, 8) uint8."""
    b = block.astype(np.int64)
    r = [b[..., :, k] for k in range(8)]
    a0 = _W4 * r[0] + (1 << 10) + _W2 * r[2] + _W4 * r[4] + _W6 * r[6]
    a1 = _W4 * r[0] + (1 << 10) + _W6 * r[2] - _W4 * r[4] - _W2 * r[6]
    a2 = _W4 * r[0] + (1 << 10) - _W6 * r[2] - _W4 * r[4] + _W2 * r[6]
    a3 = _W4 * r[0] + (1 << 10) - _W2 * r[2] + _W4 * r[4] - _W6 * r[6]
    b0 = _W1 * r[1] + _W3 * r[3] + _W5 * r[5] + _W7 * r[7]
    b1 = _W3 * r[1] - _W7 * r[3] - _W1 * r[5] - _W5 * r[7]
    b2 = _W5 * r[1] - _W1 * r[3] + _W7 * r[5] + _W3 * r[7]
    b3 = _W7 * r[1] - _W5 * r[3] + _W3 * r[5] - _W1 * r[7]
    rows = np.stack([_i16(_i32(x) >> 11) for x in
                     (a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                      a3 - b3, a2 - b2, a1 - b1, a0 - b0)], axis=-1)
    dc_only = ~np.any(b[..., :, 1:], axis=-1)           # idctRowCondDC
    rows = np.where(dc_only[..., None], _i16(r[0] * 8)[..., None], rows)
    c = [rows[..., k, :] for k in range(8)]
    a0 = _W4 * (c[0] + 32) + _W2 * c[2] + _W4 * c[4] + _W6 * c[6]
    a1 = _W4 * (c[0] + 32) + _W6 * c[2] - _W4 * c[4] - _W2 * c[6]
    a2 = _W4 * (c[0] + 32) - _W6 * c[2] - _W4 * c[4] + _W2 * c[6]
    a3 = _W4 * (c[0] + 32) - _W2 * c[2] + _W4 * c[4] - _W6 * c[6]
    b0 = _W1 * c[1] + _W3 * c[3] + _W5 * c[5] + _W7 * c[7]
    b1 = _W3 * c[1] - _W7 * c[3] - _W1 * c[5] - _W5 * c[7]
    b2 = _W5 * c[1] - _W1 * c[3] + _W7 * c[5] + _W3 * c[7]
    b3 = _W7 * c[1] - _W5 * c[3] + _W3 * c[5] - _W1 * c[7]
    cols = np.stack([np.clip(_i32(x) >> 20, 0, 255) for x in
                     (a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                      a3 - b3, a2 - b2, a1 - b1, a0 - b0)], axis=-2)
    return cols.astype(np.uint8)


def _plane(c) -> np.ndarray:
    """A component's samples at its own resolution, as FFmpeg decodes
    them."""
    coef = _i16(c.coef * c.q[None, None, :])
    coef[..., 0] = np.clip(c.coef[..., 0] * c.q[0] + 1024, -32768, 32767)
    px = simple_idct(coef.reshape(c.rows, c.cols, 8, 8))
    px = px.transpose(0, 2, 1, 3).reshape(c.rows * 8, c.cols * 8)
    return px[:c.dh, :c.dw].astype(np.int64)


def _round_int16(f: int) -> int:
    """swscale's ``roundToInt16``."""
    return max(-0x7FFF, min(0x7FFF, (f + (1 << 15)) >> 16))


def _yuv2rgb_coefficients() -> tuple[int, int, int, int, int]:
    """(y, v->r, u->b, u->g, v->g) ``pmulhw`` coefficients of swscale's
    ``ff_yuv2rgb_c_init_tables`` for full-range BT.601 input (the default
    colourspace), contrast and saturation 1."""
    crv, cbu, cgu, cgv = 104597, 132201, 25675, 53279
    crv, cbu = crv * 224 // 255, cbu * 224 // 255
    cgu, cgv = -cgu * 224 // 255, -cgv * 224 // 255
    return tuple(_round_int16(v << 13) for v in (1 << 16, crv, cbu, cgu, cgv))


_CY, _CVR, _CUB, _CUG, _CVG = _yuv2rgb_coefficients()


def decode_mjpeg_frame(body: bytes) -> np.ndarray:
    """One MJPEG frame -> (h, w, 3) uint8 BGR, the pixels
    ``cv2.VideoCapture.read`` gives (see the module docstring)."""
    frame, _ = parse_jpeg(body)
    h, w = frame.height, frame.width
    planes = [_plane(c) for c in frame.comps]
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1).astype(np.uint8)
    y, cb, cr = frame.comps
    ratios = {(frame.max_h // c.h, frame.max_v // c.v) for c in (cb, cr)}
    if (y.h, y.v) != (frame.max_h, frame.max_v) or len(ratios) != 1 or \
            ratios.pop() not in ((2, 2), (2, 1)):
        raise ValueError("MJPEG frame subsampling other than 4:2:0 and 4:2:2 "
                         "is not supported (FFmpeg converts it on another "
                         "path)")
    if h % 2:
        raise ValueError(f"MJPEG frame of odd height {h} is not supported "
                         f"(swscale converts it on its scaling path)")
    rv = frame.max_v // cb.v

    def up(p):
        return np.repeat(np.repeat(p, rv, axis=0), 2, axis=1)[:h, :w]

    yy = ((planes[0] * 8) * _CY) >> 16
    u, v = up(planes[1]) * 8 - 1024, up(planes[2]) * 8 - 1024
    b = yy + ((u * _CUB) >> 16)
    g = yy + (((u * _CUG) >> 16) + ((v * _CVG) >> 16))
    r = yy + ((v * _CVR) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)
