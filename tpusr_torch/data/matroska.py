"""Matroska ``.mkv`` and WebM ``.webm``, read as FFmpeg's ``matroska``
demuxer reads them for ``cv2.VideoCapture``: the frames of the one video
track in file order, and the rate ``CAP_PROP_FPS`` gives.

- EBML: the header (DocType ``matroska`` or ``webm``), then the Segment's
  SeekHead, Info, Tracks and Clusters (Cues, Tags, Chapters and the like
  are skipped); Void and CRC-32 elements anywhere; a Segment or Cluster of
  unknown size (what a live recorder writes) ends at the first element that
  cannot be its child; a file cut inside a Cluster keeps the blocks that
  end before the cut, as FFmpeg does.
- Tracks: the first video TrackEntry (``TrackType`` 1): its ``CodecID``,
  ``CodecPrivate``, ``PixelWidth``/``PixelHeight`` and ``DefaultDuration``,
  and one ``ContentEncoding`` of header stripping (``ContentCompAlgo`` 3,
  its ``ContentCompSettings`` put back before each frame) or zlib (0).
- Clusters: ``SimpleBlock`` and ``BlockGroup``/``Block`` of the video track
  (the blocks of other tracks, audio among them, are skipped), unlaced or in
  each of the three lacings (Xiph, EBML, fixed).
- The rate: FFmpeg's ``avg_frame_rate``, ``av_reduce(1e9, DefaultDuration,
  30000)``, which it also takes as ``r_frame_rate`` (what OpenCV's
  ``get_fps`` returns) between 5 and 1000 fps.

Codecs: ``V_VP8`` (``data/vp8video.py``), ``V_MPEG4/ISO/ASP`` (and ``SP``,
``AP``; the VOL is in ``CodecPrivate``, else in band: ``data/mpeg4.py``)
and ``V_MJPEG`` (``data/avi.py``'s MJPEG frames).

Refused by name: encryption, compression other than header stripping and
zlib (and a zlib frame inflating past 64 MiB), chained encodings, a second
video track, a video track without its pixel size, a track with no
``DefaultDuration`` or a rate outside 5-1000 fps (FFmpeg then guesses the
rate from the timestamps), the EBML header versions FFmpeg refuses, and
every other codec (H.264, HEVC, AV1, VP9, FFV1 and the rest). Every size is
checked against its parent and the file.
"""

from __future__ import annotations

import math
import zlib

from tpusr_torch.data.avi import AviVideo
from tpusr_torch.data.mpeg4 import Mpeg4Video, read_headers
from tpusr_torch.data.vp8video import Vp8Video

MAGIC = b"\x1aE\xdf\xa3"

EBML, DOCTYPE = 0x1A45DFA3, 0x4282
SEGMENT, SEEKHEAD, INFO, TRACKS, CLUSTER = (0x18538067, 0x114D9B74,
                                            0x1549A966, 0x1654AE6B,
                                            0x1F43B675)
CUES, TAGS, CHAPTERS, ATTACHMENTS = (0x1C53BB6B, 0x1254C367, 0x1043A770,
                                     0x1941A469)
VOID, CRC32 = 0xEC, 0xBF
TRACK_ENTRY, TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = (
    0xAE, 0xD7, 0x83, 0x86, 0x63A2)
DEFAULT_DURATION, VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = (0x23E383, 0xE0, 0xB0,
                                                      0xBA)
ENCODINGS, ENCODING, ENCODING_SCOPE, ENCODING_TYPE = (0x6D80, 0x6240,
                                                      0x5032, 0x5033)
COMPRESSION, COMP_ALGO, COMP_SETTINGS, ENCRYPTION = (0x5034, 0x4254, 0x4255,
                                                     0x5035)
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0xA3, 0xA0, 0xA1

# EBMLReadVersion, EBMLMaxSizeLength, EBMLMaxIDLength, DocTypeReadVersion:
# (ID, the most FFmpeg reads, the default)
_EBML_LIMITS = ((0x42F7, 1, 1), (0x42F3, 8, 8), (0x42F2, 4, 4),
                (0x4285, 3, 1))
# the level-1 elements: any of them ends a Cluster of unknown size
_LEVEL1 = {SEEKHEAD, INFO, TRACKS, CLUSTER, CUES, TAGS, CHAPTERS,
           ATTACHMENTS}
_CODECS = {"V_MPEG4/ISO/AVC": "H.264 (V_MPEG4/ISO/AVC)",
           "V_MPEGH/ISO/HEVC": "HEVC (V_MPEGH/ISO/HEVC)",
           "V_AV1": "AV1 (V_AV1)", "V_VP9": "VP9 (V_VP9)",
           "V_FFV1": "FFV1 (V_FFV1)", "V_THEORA": "Theora (V_THEORA)",
           "V_MS/VFW/FOURCC": "a VfW-compatibility track (V_MS/VFW/FOURCC)",
           "V_UNCOMPRESSED": "uncompressed video (V_UNCOMPRESSED)"}
_MPEG4 = ("V_MPEG4/ISO/ASP", "V_MPEG4/ISO/SP", "V_MPEG4/ISO/AP")
_ALGOS = {1: "bzlib", 2: "lzo1x"}
_MAX_INFLATE = 1 << 26      # a compressed video frame, far above any real one


class _Malformed(Exception):
    """A structural fault of the file, reported with its path."""


def _refuse(path: str, what: str):
    raise ValueError(f"{path}: a Matroska/WebM file with {what}, which is "
                     f"not supported; the port reads VP8, MPEG-4 Part 2 and "
                     f"MJPEG video in Matroska/WebM")


def vint(data: bytes, pos: int, end: int, keep_marker: bool):
    """An EBML variable-length integer at ``data[pos]``: (value, position
    after it, all value bits set). IDs keep their length marker."""
    if pos >= end:
        raise _Malformed(f"a truncated element header at {pos}")
    first = data[pos]
    n = 9 - first.bit_length()
    if n > 8:
        raise _Malformed(f"an invalid EBML number at {pos}")
    if pos + n > end:
        raise _Malformed(f"a truncated element header at {pos}")
    v = first if keep_marker else first & (0xFF >> n)
    for b in data[pos + 1: pos + n]:
        v = (v << 8) | b
    return v, pos + n, not keep_marker and v == (1 << (7 * n)) - 1


def element(data: bytes, pos: int, end: int):
    """(ID, body start, body end or None for an unknown size) of the
    element at ``pos``."""
    eid, pos, _ = vint(data, pos, end, True)
    if eid > 0xFFFFFFFF:
        raise _Malformed(f"an ID longer than 4 bytes at {pos}")
    size, pos, unknown = vint(data, pos, end, False)
    return eid, pos, None if unknown else pos + size


def children(data: bytes, start: int, end: int):
    """(ID, body start, body end) of each element in ``data[start:end]``,
    Void and CRC-32 skipped; a child that runs past ``end`` is refused."""
    out, pos = [], start
    while pos < end:
        eid, body, stop = element(data, pos, end)
        if stop is None:
            raise _Malformed(f"an element {eid:#x} of unknown size inside "
                             f"an element of known size")
        if stop > end:
            raise _Malformed(f"the element {eid:#x} at {pos} runs past its "
                             f"parent's end")
        if eid not in (VOID, CRC32):
            out.append((eid, body, stop))
        pos = stop
    return out


def _uint(data, body, stop) -> int:
    if stop - body > 8:
        raise _Malformed("an unsigned integer longer than 8 bytes")
    return int.from_bytes(data[body:stop], "big")


class _Track:
    """The fields of a TrackEntry that the reader uses."""

    def __init__(self, data, body, stop, path):
        f = {eid: (b, s) for eid, b, s in children(data, body, stop)}

        def get(eid, default=None):
            return _uint(data, *f[eid]) if eid in f else default

        self.number = get(TRACK_NUMBER, 0)
        self.type = get(TRACK_TYPE, 0)
        self.codec = (data[slice(*f[CODEC_ID])].rstrip(b"\0")
                      .decode("latin-1") if CODEC_ID in f else "")
        self.private = data[slice(*f[CODEC_PRIVATE])] if CODEC_PRIVATE in f \
            else b""
        self.default_duration = get(DEFAULT_DURATION)
        self.width = self.height = 0
        if VIDEO in f:
            v = {eid: (b, s) for eid, b, s in children(data, *f[VIDEO])}
            self.width = _uint(data, *v[PIXEL_WIDTH]) if PIXEL_WIDTH in v \
                else 0
            self.height = _uint(data, *v[PIXEL_HEIGHT]) \
                if PIXEL_HEIGHT in v else 0
        self.strip = b""
        self.zlib = False
        if ENCODINGS in f:
            self._encoding(data, f[ENCODINGS], path)

    def _encoding(self, data, where, path):
        encs = [e for e in children(data, *where) if e[0] == ENCODING]
        if len(encs) > 1:
            _refuse(path, f"{len(encs)} chained ContentEncodings")
        if not encs:
            return
        f = {eid: (b, s) for eid, b, s in children(data, *encs[0][1:])}
        kind = _uint(data, *f[ENCODING_TYPE]) if ENCODING_TYPE in f else 0
        if kind == 1 or ENCRYPTION in f:
            _refuse(path, "encryption (ContentEncryption)")
        scope = _uint(data, *f[ENCODING_SCOPE]) if ENCODING_SCOPE in f else 1
        if kind != 0 or scope not in (1, 3):
            _refuse(path, f"a ContentEncoding of type {kind}, scope {scope}")
        c = {eid: (b, s) for eid, b, s in
             children(data, *f[COMPRESSION])} if COMPRESSION in f else {}
        algo = _uint(data, *c[COMP_ALGO]) if COMP_ALGO in c else 0
        if algo == 3:
            self.strip = data[slice(*c[COMP_SETTINGS])] \
                if COMP_SETTINGS in c else b""
            if scope & 2:
                self.private = self.strip + self.private
        elif algo == 0:
            self.zlib = True
            if scope & 2:
                self.private = _inflate(self.private)
        else:
            _refuse(path, f"{_ALGOS.get(algo, f'algorithm {algo}')} "
                          f"compression (ContentCompAlgo {algo})")

    def decode(self, frame: bytes) -> bytes:
        """A frame with the track's encoding undone."""
        if self.zlib:
            return _inflate(frame)
        return self.strip + frame if self.strip else frame


def _inflate(body: bytes) -> bytes:
    """A zlib-compressed frame, refused past ``_MAX_INFLATE`` bytes."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(body, _MAX_INFLATE)
    except zlib.error as e:
        raise _Malformed(f"a zlib frame that does not inflate ({e})") \
            from None
    if d.unconsumed_tail:
        raise _Malformed(f"a zlib frame inflating past {_MAX_INFLATE} bytes")
    return out


def laced(data: bytes, pos: int, stop: int) -> list[bytes]:
    """The frames of a Block's payload from its flags byte at ``pos``:
    unlaced, or Xiph (1), fixed-size (2) or EBML (3) lacing."""
    if pos >= stop:
        raise _Malformed("a block with no flags byte")
    lacing = (data[pos] >> 1) & 3
    pos += 1
    if lacing == 0:
        return [data[pos:stop]]
    if pos >= stop:
        raise _Malformed("a laced block with no frame count")
    n = data[pos] + 1
    pos += 1
    sizes = []
    if lacing == 1:
        for _ in range(n - 1):
            size = 0
            while True:
                if pos >= stop:
                    raise _Malformed("a truncated Xiph lace")
                b = data[pos]
                pos += 1
                size += b
                if b != 255:
                    break
            sizes.append(size)
    elif lacing == 3:
        size, pos, _ = vint(data, pos, stop, False)
        sizes.append(size)
        for _ in range(n - 2):
            start = pos
            raw, pos, _ = vint(data, pos, stop, False)
            size += raw - ((1 << (7 * (pos - start) - 1)) - 1)
            if size < 0:
                raise _Malformed("a negative EBML lace size")
            sizes.append(size)
    else:
        if (stop - pos) % n:
            raise _Malformed("a fixed-size lace that does not divide its "
                             "block")
        sizes = [(stop - pos) // n] * (n - 1)
    last = stop - pos - sum(sizes)
    if last < 0:
        raise _Malformed("lace sizes beyond their block")
    out = []
    for size in sizes + [last]:
        out.append(data[pos: pos + size])
        pos += size
    return out


def av_reduce(num: int, den: int, limit: int) -> tuple[int, int]:
    """FFmpeg's ``av_reduce``: num/den as the nearest fraction whose terms
    are at most ``limit`` (its continued-fraction walk)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= limit and den <= limit:
        a1n, a1d, den = num, den, 0
    while den:
        x = num // den
        nxt = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, nxt
    return a1n, a1d


def rate(default_duration: int | None, path: str) -> float:
    """``CAP_PROP_FPS`` of a track with this DefaultDuration (ns)."""
    if not default_duration:
        _refuse(path, "no DefaultDuration (FFmpeg guesses the rate from the "
                      "timestamps)")
    num, den = av_reduce(10 ** 9, default_duration, 30000)
    if not (num < den * 1000 and num > den * 5):
        _refuse(path, f"a rate of {num}/{den} fps (outside 5-1000 fps FFmpeg "
                      f"guesses the rate from the timestamps)")
    return num / den


def demux(data: bytes, path: str):
    """(the video track, its frames in file order) of a Matroska file."""
    eid, body, stop = element(data, 0, len(data))
    if eid != EBML:
        raise _Malformed("no EBML header")
    stop = min(stop if stop is not None else len(data), len(data))
    head = {e: (b, s) for e, b, s in children(data, body, stop)}
    doctype = data[slice(*head[DOCTYPE])].rstrip(b"\0") if DOCTYPE in head \
        else b"matroska"
    if doctype not in (b"matroska", b"webm"):
        raise _Malformed(f"the DocType {doctype!r}")
    for eid, most, default in _EBML_LIMITS:     # FFmpeg's refusals
        if (_uint(data, *head[eid]) if eid in head else default) > most:
            raise _Malformed(f"an EBML header of unsupported features "
                             f"({eid:#x} above {most})")
    pos = stop
    while True:                                 # the first Segment
        if pos >= len(data):
            raise _Malformed("no Segment")
        eid, body, stop = element(data, pos, len(data))
        if eid == SEGMENT:
            break
        if stop is None:
            raise _Malformed(f"an element {eid:#x} of unknown size before "
                             f"the Segment")
        pos = stop
    end = len(data) if stop is None else min(stop, len(data))
    track, frames, pos = None, [], body
    while pos < end:
        eid, body, stop = element(data, pos, end)
        if eid == CLUSTER:
            pos = _cluster(data, body, stop, end, track, frames, path)
            continue
        if stop is None:
            raise _Malformed(f"an element {eid:#x} of unknown size in the "
                             f"Segment")
        stop = min(stop, end)
        if eid == TRACKS:
            track = _video_track(data, body, stop, path, track)
        pos = stop
    if track is None:
        raise ValueError(f"{path}: a Matroska/WebM file with no video track")
    return track, frames


def _video_track(data, body, stop, path, known):
    tracks = [_Track(data, b, s, path) for eid, b, s in
              children(data, body, stop) if eid == TRACK_ENTRY]
    video = [t for t in tracks if t.type == 1]
    if known is not None:
        video.insert(0, known)
    if len(video) > 1:
        _refuse(path, "a second video track")
    return video[0] if video else None


def _cluster(data, body, stop, end, track, frames, path) -> int:
    """Collect the video frames of the Cluster whose body starts at
    ``body``; returns where the next element starts."""
    known = stop is not None
    stop = min(stop, end) if known else end
    pos = body
    while pos < stop:
        eid, b, s = element(data, pos, stop)
        if not known and eid in _LEVEL1 | {SEGMENT, EBML}:
            return pos                          # an unknown size ends here
        if s is None:
            raise _Malformed(f"an element {eid:#x} of unknown size in a "
                             f"Cluster")
        if s > stop:                            # cut by the end of the file
            break
        if eid == SIMPLE_BLOCK:
            _block(data, b, s, track, frames, path)
        elif eid == BLOCK_GROUP:
            for e, bb, ss in children(data, b, s):
                if e == BLOCK:
                    _block(data, bb, ss, track, frames, path)
        pos = s
    return stop


def _block(data, body, stop, track, frames, path) -> None:
    number, pos, _ = vint(data, body, stop, False)
    if track is None or number != track.number:
        return
    if pos + 2 > stop:
        raise _Malformed("a block shorter than its header")
    for f in laced(data, pos + 2, stop):
        frames.append(track.decode(f))


def read_mkv(path: str):
    """The video track of the Matroska/WebM file at ``path`` -> a video
    object of its codec (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        track, frames = demux(data, path)
    except _Malformed as e:
        raise ValueError(f"{path}: a malformed Matroska/WebM file "
                         f"({e})") from None
    codec = track.codec
    if codec in _CODECS or codec not in ("V_VP8", "V_MJPEG") + _MPEG4:
        _refuse(path, _CODECS.get(codec, f"the codec {codec!r}"))
    if not (track.width and track.height):
        _refuse(path, "a video track without its PixelWidth and PixelHeight "
                      "(cv2 reads no frame of it)")
    fps = rate(track.default_duration, path)
    frames = [f for f in frames if f]
    if codec == "V_VP8":
        return Vp8Video(fps, frames, path)
    if codec == "V_MJPEG":
        return AviVideo(track.width, track.height, fps, "MJPG", frames)
    if track.private and read_headers(track.private)[0] is not None:
        return Mpeg4Video.from_config(track.private, fps, frames, "mp4v",
                                      path)
    return Mpeg4Video.from_samples(fps, frames, "mp4v", path)
