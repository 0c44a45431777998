"""AVI, read as ``cv2.VideoCapture`` reads it on x86: Motion-JPEG here,
MPEG-4 Part 2 through ``data/mpeg4.py``.

The JAX package reads the print videos with OpenCV, whose FFmpeg backend
demuxes the AVI, decodes each frame with FFmpeg's decoder and converts it
to BGR with swscale. The port has no video library, so it carries this
reader:

- the RIFF ``AVI `` container (OpenDML ``AVIX`` extensions too): the first
  video stream's ``strh`` (its ``dwRate / dwScale`` is the rate
  ``CAP_PROP_FPS`` gives) and ``strf`` (its compression must be MJPEG, or
  ``FMP4``/``XVID``/``DIVX``/``DX50``/``MP4V``, which go to the MPEG-4
  Part 2 decoder with the VOL taken in band; any other codec, and any other
  container such as Ogg, is refused by name; Matroska goes to
  ``data/matroska.py``), then that stream's
  ``##dc``/``##db`` chunks of ``movi`` in file order, ``LIST rec`` groups
  included; the main header ``avih`` and the indexes (``idx1``, ``ix##``)
  are not needed;
- each MJPEG frame's JPEG parsed and Huffman-decoded by the port's decoder
  (``pipeline/jpeg.py``), then FFmpeg's arithmetic, not libjpeg's: the
  DC predictor starts at 1024 (the level shift), coefficients are kept in
  int16, the 8-bit ``simple_idct`` (``data/idct.py``), and swscale's
  unscaled ``yuv420p``/``yuv422p`` -> ``bgr24`` converter for full-range
  (JPEG) input (``data/swscale.py``). Gray frames are replicated to three
  channels.

MJPEG frames at 4:2:0 and 4:2:2 of even height (what ``cv2.VideoWriter``
writes) and gray frames are read; other subsampling and odd heights, which
send swscale to its scaling path, are refused by name.

``read_avi`` parses the container. MJPEG frames decode when asked for, so
a caller that samples one frame in ten decodes one in ten; an MPEG-4 AVI
decodes in order, each frame predicted from the one before.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from tpusr_torch.data.idct import simple_idct, wrap_int16
from tpusr_torch.data.mpeg4 import Mpeg4Video
from tpusr_torch.data.swscale import yuv_to_bgr
from tpusr_torch.pipeline.jpeg import parse_jpeg

_MJPEG = {b"MJPG", b"mjpg", b"AVRn", b"LJPG", b"JPGL", b"dmb1", b"jpeg",
          b"JPEG", b"MJPA", b"AVDJ", b"ACDV", b"QIVG", b"SLMJ"}
# the fourccs of FFmpeg's mpeg4 decoder in AVI
_MPEG4 = {b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4V", b"mp4v"}
_CONTAINERS = ((0, b"OggS", "Ogg"), (0, b"FLV", "FLV"),
               (0, b"\x00\x00\x01\xba", "MPEG-PS"), (0, b"G", "MPEG-TS"))


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
        it (so that unsampled frames are never decoded: MJPEG frames stand
        alone)."""
        return [lambda c=c: decode_mjpeg_frame(c) for c in self.chunks]


def _refuse_container(head: bytes, path: str) -> None:
    for at, magic, name in _CONTAINERS:
        if head[at: at + len(magic)] == magic:
            raise ValueError(f"{path}: a {name} file; the port reads AVI "
                             f"(MJPEG, MPEG-4 Part 2), MP4/QuickTime "
                             f"(MPEG-4 Part 2) and Matroska/WebM")
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


def read_avi(path: str):
    """Parse the AVI at ``path`` (see the module docstring): an
    ``AviVideo`` (MJPEG) or an ``mpeg4.Mpeg4Video``."""
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
    scale, rate = struct.unpack("<II", strh[20:28])
    fps = rate / scale if scale else 0.0
    if compression in _MPEG4:
        return Mpeg4Video.from_samples(
            fps, [c for s, c in chunks if s == video and c],
            compression.decode("latin-1"), path)
    if compression not in _MJPEG:
        name = compression.decode("latin-1").strip("\x00 ") or repr(compression)
        raise ValueError(f"{path}: the video codec is {name}, not MJPEG or "
                         f"MPEG-4 Part 2; the port reads those two in AVI")
    width, height = struct.unpack("<ii", strf[4:12])
    return AviVideo(width, abs(height), fps,
                    (handler if handler.strip(b"\x00") else compression)
                    .decode("latin-1"),
                    [c for s, c in chunks if s == video and c])


def _plane(c) -> np.ndarray:
    """A component's samples at its own resolution, as FFmpeg decodes
    them."""
    coef = wrap_int16(c.coef * c.q[None, None, :])
    coef[..., 0] = np.clip(c.coef[..., 0] * c.q[0] + 1024, -32768, 32767)
    px = simple_idct(coef.reshape(c.rows, c.cols, 8, 8))
    px = px.transpose(0, 2, 1, 3).reshape(c.rows * 8, c.cols * 8)
    return px[:c.dh, :c.dw]


def decode_mjpeg_frame(body: bytes) -> np.ndarray:
    """One MJPEG frame -> (h, w, 3) uint8 BGR, the pixels
    ``cv2.VideoCapture.read`` gives (see the module docstring)."""
    frame, _ = parse_jpeg(body)
    h, w = frame.height, frame.width
    planes = [_plane(c) for c in frame.comps]
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
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
    return yuv_to_bgr(*planes, frame.max_v // cb.v, full_range=True)
