"""MP4 and QuickTime ``.mov`` (ISO base media file format), read as FFmpeg's
``mov`` demuxer reads them for ``cv2.VideoCapture``: the video samples of
the first video track, in decode order, and the rate ``CAP_PROP_FPS``
gives.

- The boxes are walked with ``moov`` before or after ``mdat``, 64-bit
  ``largesize`` and a last box that runs to the end of the file included.
- The first ``trak`` whose ``mdia/hdlr`` is ``vide`` is taken: ``mdhd``
  gives its timescale, ``stsd`` its one sample entry (``mp4v``, whose
  ``esds`` DecoderSpecificInfo carries the MPEG-4 Part 2 VOL), ``stts``,
  ``stsc``, ``stsz`` and ``stco``/``co64`` every sample's offset and size
  in decode order (the sync samples of ``stss`` are the I-VOPs, which the
  decoder finds in the samples themselves).
- The rate is FFmpeg's ``r_frame_rate`` (``av_guess_frame_rate``, what
  OpenCV's ``get_fps`` returns): the timescale over the sample duration,
  when ``stts`` holds one duration (or a second one for the last sample
  alone).
- The edit list that ``cv2.VideoWriter`` writes (one edit from media time
  0 at rate 1 that covers the track) changes nothing; any other is refused.

Refused by name: H.264 (``avc1``/``avc3``), HEVC (``hvc1``/``hev1``), VP9
(``vp09``), AV1 (``av01``) and any other sample entry, an ``esds`` of
another object type, composition offsets (``ctts``: B-frames), fragmented
files (``moof``/``mvex``), a file with no video track. Every offset and size
is checked against the file before it is read.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip")
_CODECS = {b"avc1": "H.264 (avc1)", b"avc3": "H.264 (avc3)",
           b"hvc1": "HEVC (hvc1)", b"hev1": "HEVC (hev1)",
           b"vp09": "VP9 (vp09)", b"vp08": "VP8 (vp08)",
           b"av01": "AV1 (av01)", b"mjpa": "Motion-JPEG (mjpa)",
           b"jpeg": "Motion-JPEG (jpeg)", b"encv": "encrypted video (encv)"}


def _refuse(path: str, what: str):
    raise ValueError(f"{path}: {what} is not supported; the port reads "
                     f"MPEG-4 Part 2 (mp4v) video in MP4/QuickTime")


def boxes(data: bytes, start: int, end: int, path: str):
    """(type, body start, body end) of each box in ``data[start:end]``."""
    out, pos = [], start
    while pos < end:
        if end - pos < 8:
            raise ValueError(f"{path}: a truncated box header at {pos}")
        size, kind = struct.unpack(">I4s", data[pos: pos + 8])
        head = 8
        if size == 1:
            if end - pos < 16:
                raise ValueError(f"{path}: a truncated largesize at {pos}")
            (size,) = struct.unpack(">Q", data[pos + 8: pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"{path}: the {kind!r} box at {pos} runs past "
                             f"its parent's end")
        out.append((kind, pos + head, pos + size))
        pos += size
    return out


def _children(data, box, path):
    return boxes(data, box[1], box[2], path)


def _find(data, box, kind, path):
    return next((b for b in _children(data, box, path) if b[0] == kind), None)


def _table(data, box, path, fmt: str, fields: int, skip: int = 0):
    """A full box's ``entry_count`` rows of ``fields`` big-endian values
    (``fmt`` 'u4'/'u8') after ``skip`` bytes, as an (n, fields) array."""
    body = data[box[1]: box[2]]
    if len(body) < 8 + skip:
        raise ValueError(f"{path}: a truncated {box[0]!r} box")
    (n,) = struct.unpack(">I", body[4 + skip: 8 + skip])
    width = int(fmt[1]) * fields
    if n * width > len(body) - 8 - skip:
        raise ValueError(f"{path}: the {box[0]!r} box holds fewer entries "
                         f"than its count {n}")
    arr = np.frombuffer(body, f">{fmt}", n * fields, 8 + skip)
    return arr.astype(np.int64).reshape(n, fields)


def _descriptor(body: bytes, pos: int, path: str):
    """(tag, payload start, payload end) of an MPEG-4 descriptor."""
    if pos + 2 > len(body):
        raise ValueError(f"{path}: a truncated esds descriptor")
    tag, length, pos = body[pos], 0, pos + 1
    for _ in range(4):
        if pos >= len(body):
            raise ValueError(f"{path}: a truncated esds descriptor")
        b = body[pos]
        pos += 1
        length = (length << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    if pos + length > len(body):
        raise ValueError(f"{path}: an esds descriptor runs past its box")
    return tag, pos, pos + length


def decoder_specific_info(body: bytes, path: str) -> bytes:
    """The DecoderSpecificInfo of an ``esds`` box's body (an MPEG-4 Visual
    stream's VOL headers)."""
    tag, pos, end = _descriptor(body, 4, path)
    if tag != 3:
        raise ValueError(f"{path}: the esds holds no ES descriptor")
    flags = body[pos + 2]
    pos += 3
    if flags & 0x80:
        pos += 2
    if flags & 0x40:
        pos += 1 + body[pos]
    if flags & 0x20:
        pos += 2
    tag, pos, end = _descriptor(body, pos, path)
    if tag != 4:
        raise ValueError(f"{path}: the esds holds no decoder config")
    if body[pos] != 0x20:
        _refuse(path, f"an esds of object type {body[pos]:#04x} (not MPEG-4 "
                      f"Visual, 0x20)")
    tag, pos, end = _descriptor(body, pos + 13, path)
    if tag != 5:
        raise ValueError(f"{path}: the esds holds no DecoderSpecificInfo")
    return body[pos: end]


def read_mp4(path: str):
    """The first video track of the MP4/QuickTime file at ``path`` ->
    ``mpeg4.Mpeg4Video`` (see the module docstring)."""
    from tpusr_torch.data.mpeg4 import Mpeg4Video

    with open(path, "rb") as f:
        data = f.read()
    try:
        config, fps, samples = _video_track(data, path)
    except (struct.error, IndexError) as e:     # a box shorter than its fields
        raise ValueError(f"{path}: a malformed MP4/QuickTime file "
                         f"({e})") from None
    return Mpeg4Video.from_config(config, fps, samples, "mp4v", path)


def _video_track(data: bytes, path: str):
    """(the VOL headers, the rate, the samples) of the first video
    track."""
    top = boxes(data, 0, len(data), path)
    kinds = [b[0] for b in top]
    if b"moof" in kinds:
        _refuse(path, "a fragmented MP4 (moof)")
    moov = next((b for b in top if b[0] == b"moov"), None)
    if moov is None:
        raise ValueError(f"{path}: an MP4/QuickTime file with no moov box")
    if _find(data, moov, b"mvex", path) is not None:
        _refuse(path, "a fragmented MP4 (mvex)")
    mvhd = _find(data, moov, b"mvhd", path)
    if mvhd is None or mvhd[2] - mvhd[1] < 20:
        raise ValueError(f"{path}: no movie header (mvhd)")
    v = data[mvhd[1]]
    (movie_scale,) = struct.unpack(">I", data[mvhd[1] + (20 if v else 12):
                                              mvhd[1] + (24 if v else 16)])
    for trak in _children(data, moov, path):
        if trak[0] != b"trak":
            continue
        mdia = _find(data, trak, b"mdia", path)
        hdlr = mdia and _find(data, mdia, b"hdlr", path)
        if hdlr and data[hdlr[1] + 8: hdlr[1] + 12] == b"vide":
            break
    else:
        raise ValueError(f"{path}: an MP4/QuickTime file with no video "
                         f"track")
    mdhd = _find(data, mdia, b"mdhd", path)
    if mdhd is None:
        raise ValueError(f"{path}: the video track has no mdhd")
    v = data[mdhd[1]]
    (timescale,) = struct.unpack(">I", data[mdhd[1] + (20 if v else 12):
                                            mdhd[1] + (24 if v else 16)])
    minf = _find(data, mdia, b"minf", path)
    stbl = minf and _find(data, minf, b"stbl", path)
    if stbl is None:
        raise ValueError(f"{path}: the video track has no sample table")
    tables = {b[0]: b for b in _children(data, stbl, path)}
    if b"ctts" in tables:
        _refuse(path, "composition time offsets (ctts: B-frames)")
    for need in (b"stsd", b"stts", b"stsc"):
        if need not in tables:
            raise ValueError(f"{path}: the sample table has no {need!r}")
    if b"stsz" not in tables:
        _refuse(path, "a sample size table other than stsz")

    # the sample entry and its VOL
    stsd = tables[b"stsd"]
    (count,) = struct.unpack(">I", data[stsd[1] + 4: stsd[1] + 8])
    entries = boxes(data, stsd[1] + 8, stsd[2], path)
    if count != 1 or len(entries) != 1:
        _refuse(path, f"a track with {count} sample descriptions")
    kind, start, end = entries[0]
    if kind != b"mp4v":
        name = _CODECS.get(kind, f"the {kind.decode('latin-1')!r} codec")
        _refuse(path, name)
    esds = next((b for b in boxes(data, start + 78, end, path)
                 if b[0] == b"esds"), None)
    if esds is None:
        raise ValueError(f"{path}: the mp4v sample entry has no esds")
    config = decoder_specific_info(data[esds[1]: esds[2]], path)

    # the samples' durations, offsets and sizes
    stts = _table(data, tables[b"stts"], path, "u4", 2)
    n = int(stts[:, 0].sum())
    stsz = tables[b"stsz"]
    (size, count) = struct.unpack(">II", data[stsz[1] + 4: stsz[1] + 12])
    if size * count > len(data):
        raise ValueError(f"{path}: stsz declares {count} samples of {size} "
                         f"bytes, more than the file holds")
    sizes = (np.full(count, size, np.int64) if size else
             _table(data, stsz, path, "u4", 1, skip=4)[:, 0])
    if count != n:
        raise ValueError(f"{path}: stsz counts {count} samples, stts {n}")
    if b"stco" in tables:
        chunks = _table(data, tables[b"stco"], path, "u4", 1)[:, 0]
    elif b"co64" in tables:
        chunks = _table(data, tables[b"co64"], path, "u8", 1)[:, 0]
    else:
        raise ValueError(f"{path}: the sample table has no chunk offsets")
    stsc = _table(data, tables[b"stsc"], path, "u4", 3)
    if len(stsc) == 0 or stsc[0, 0] != 1 or (stsc[:, 2] != 1).any() or \
            (np.diff(stsc[:, 0]) <= 0).any():
        raise ValueError(f"{path}: a malformed sample-to-chunk table")
    offsets, k = [], 0
    for c in range(len(chunks)):
        row = np.searchsorted(stsc[:, 0], c + 1, side="right") - 1
        pos = int(chunks[c])
        for _ in range(int(stsc[row, 1])):
            if k == n:
                break
            offsets.append(pos)
            pos += int(sizes[k])
            k += 1
    if k != n:
        raise ValueError(f"{path}: the chunks hold {k} of {n} samples")
    samples = []
    for off, sz in zip(offsets, sizes.tolist()):
        if off + sz > len(data):
            raise ValueError(f"{path}: a sample at {off} of {sz} bytes runs "
                             f"past the end of the file ({len(data)} bytes)")
        samples.append(data[off: off + sz])

    # the edit list
    edts = _find(data, trak, b"edts", path)
    elst = edts and _find(data, edts, b"elst", path)
    if elst:
        body = data[elst[1]: elst[2]]
        v = body[0] if body else 0
        fmt, width = (">QqhH", 20) if v else (">IihH", 12)
        (count,) = struct.unpack(">I", body[4:8]) if len(body) >= 8 else (0,)
        if count != 1 or len(body) < 8 + width:
            _refuse(path, f"an edit list of {count} edits")
        seg, media, rate, _ = struct.unpack(fmt, body[8: 8 + width])
        track = int(stts[:, 0] @ stts[:, 1])
        if media != 0 or rate != 1 or (
                seg and seg * timescale < track * movie_scale):
            _refuse(path, "an edit list other than one edit from media time "
                          "0 at rate 1 over the whole track")

    # the rate: r_frame_rate from the sample durations
    if not (len(stts) == 1 or (len(stts) == 2 and stts[1, 0] == 1)) or \
            stts[0, 1] == 0:
        _refuse(path, "a variable frame rate (stts with several durations)")
    fps = timescale / int(stts[0, 1])
    if not 0 < fps <= 210:
        _refuse(path, f"a rate of {fps} fps (FFmpeg guesses another above "
                      f"210)")
    return config, fps, samples
