"""PBM, PGM, PPM (P1-P6) and PAM (P7) in numpy: what OpenCV's
``PxMDecoder`` and ``PAMDecoder`` give through ``cv2.imdecode(
IMREAD_COLOR)``, swapped to RGB.

P1-P6 (``grfmt_pxm.cpp``):

- Numbers as ``ReadNumber`` reads them: whitespace and ``#`` comments (to
  the end of the line) skipped, a run of digits, and the one byte after
  it consumed whatever it is; any other byte before a number is refused,
  and so is a file that ends before that byte. The binary data starts right
  after the byte that ends ``maxval`` (the height for P4).
- ``maxval`` 1-65535. Binary samples are taken as they are, 16-bit ones
  (``maxval`` over 255, big-endian) as their high byte; ASCII samples are
  clamped to ``maxval``, scaled as ``v * 255 // maxval`` at 8 bits and taken
  as their high byte at 16.
- P1 reads one digit a sample (``0`` white, any other black), P4 packed
  bits (1 black), rows padded to a byte.

P7 (``grfmt_pam.cpp``): a header of ``WIDTH``, ``HEIGHT``, ``DEPTH``,
``MAXVAL`` (each once, digits only; a value ends at a NUL byte, as a C
string does), optional ``TUPLTYPE`` and ``#``
lines, closed by ``ENDHDR`` and the end of its line (its first ``\n`` or
``\r``).

- Without ``TUPLTYPE``: depth 1 is ``BLACKANDWHITE`` at ``maxval`` 1, else
  ``GRAYSCALE`` below 256; depth 3 below 256 is ``RGB``; anything else is
  refused. ``GRAYSCALE`` and ``BLACKANDWHITE`` take depth 1, ``RGB`` 3.
- At ``maxval`` 1, whatever the tuple type, each row of ``width * depth``
  bytes is read as packed bits (1 white). Otherwise samples are taken as
  they are (16-bit ones as their high byte), gray replicated, and ``RGB``
  samples land in OpenCV's B, G, R order, so the RGB returned is the
  file's reversed.
- ``GRAYSCALE_ALPHA`` and ``RGB_ALPHA`` are refused by name: OpenCV
  converts only the first pixels of each row and leaves the rest of its
  buffer uninitialised, so no decoder can give its bytes.

What OpenCV refuses raises ``ValueError``; sizes are checked against the
body and ``expected_hw`` before the image is allocated.
"""

from __future__ import annotations

import re

import numpy as np

MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30   # OpenCV's CV_IO_MAX_IMAGE_*
_INT_MAX = (1 << 31) - 1
_SKIP = rb"(?:[ \t\n\v\f\r]|#[^\n\r]*[\n\r])*"
_NUMBER = re.compile(_SKIP + rb"(\d+)\D")
_DIGIT = re.compile(_SKIP + rb"(\d)", re.S)
_WORD = re.compile(rb"[^ \t\n\v\f\r]*")
_PAM_FORMATS = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"RGB": 3,
                b"GRAYSCALE_ALPHA": 2, b"RGB_ALPHA": 4}


def _read_numbers(body: bytes, pos: int, count: int, one_digit=False):
    """``count`` numbers as ``ReadNumber`` reads them from ``pos`` ->
    (list, position after)."""
    pattern = _DIGIT if one_digit else _NUMBER
    out = []
    for m in pattern.finditer(body, pos):
        if m.start() != pos:
            break
        v = int(m.group(1))
        if v > _INT_MAX:
            raise ValueError("PNM number too large")
        out.append(v)
        pos = m.end()
        if len(out) == count:
            return out, pos
    raise ValueError(f"PNM: {body[pos:pos + 1]!r} at byte {pos} where a "
                     f"number should be")


def _check_size(w: int, h: int, expected_hw):
    if w <= 0 or h <= 0 or w > MAX_SIDE or h > MAX_SIDE \
            or w * h > MAX_PIXELS:
        raise ValueError(f"PNM image {w}x{h} is not decodable")
    if expected_hw is not None and (h, w) != tuple(expected_hw):
        raise ValueError(f"image is {h}x{w}, expected "
                         f"{expected_hw[0]}x{expected_hw[1]}")


def _raw(body: bytes, pos: int, n: int) -> np.ndarray:
    if len(body) - pos < n:
        raise ValueError("PNM data truncated")
    return np.frombuffer(body, np.uint8, n, pos)


def _samples(body, pos, h, w, nch, maxval):
    """Binary samples (h, w, nch) as uint8 (16-bit ones' high bytes)."""
    if maxval > 255:
        return _raw(body, pos, 2 * h * w * nch)[0::2].reshape(h, w, nch)
    return _raw(body, pos, h * w * nch).reshape(h, w, nch)


def _bits(body, pos, h, w, stride) -> np.ndarray:
    """Packed rows of ``stride`` bytes, most significant bit first ->
    (h, w) 0/1."""
    rows = _raw(body, pos, h * stride).reshape(h, stride)
    return np.unpackbits(rows, axis=1)[:, :w]


def _pnm(body: bytes, expected_hw):
    kind = body[1] - ord("0")
    (w, h), pos = _read_numbers(body, 2, 2)
    maxval = 1
    if kind not in (1, 4):
        (maxval,), pos = _read_numbers(body, pos, 1)
        if maxval > 65535:
            raise ValueError(f"PNM maxval {maxval} over 65535")
    if maxval <= 0:
        raise ValueError("PNM maxval 0")
    _check_size(w, h, expected_hw)
    nch = 3 if kind in (3, 6) else 1
    if kind == 4:
        return np.where(_bits(body, pos, h, w, (w + 7) // 8), 0, 255) \
            .astype(np.uint8)[..., None]
    if kind == 1:
        if len(body) - pos < w * h:
            raise ValueError("PNM data truncated")
        v, _ = _read_numbers(body, pos, w * h, one_digit=True)
        return np.where(np.array(v).reshape(h, w, 1), 0, 255).astype(np.uint8)
    if kind in (5, 6):
        return _samples(body, pos, h, w, nch, maxval)
    if len(body) - pos < 2 * w * h * nch:
        raise ValueError("PNM data truncated")
    v, _ = _read_numbers(body, pos, w * h * nch)
    v = np.minimum(np.array(v, np.int64), maxval).reshape(h, w, nch)
    v = v * 255 // maxval if maxval < 256 else v >> 8
    return v.astype(np.uint8)


def _line_end(body: bytes, pos: int) -> int:
    """The position after the first ``\n`` or ``\r`` from ``pos``."""
    ends = [i for i in (body.find(b"\n", pos), body.find(b"\r", pos))
            if i >= 0]
    if not ends:
        raise ValueError("PAM header truncated")
    return min(ends) + 1


def _pam_header(body: bytes):
    """The P7 header's fields -> (fields, data offset)."""
    if body[2:3] not in (b"\n", b"\r"):
        raise ValueError("PAM: P7 not followed by a line break")
    pos, fields, tupltype = 3, {}, None
    n = len(body)
    while True:
        while pos < n and body[pos:pos + 1].isspace():
            pos += 1
        if pos >= n:
            raise ValueError("PAM header truncated")
        if body[pos:pos + 1] == b"#":
            pos = _line_end(body, pos)
            continue
        m = _WORD.match(body, pos)
        ident, pos = m.group(), m.end()
        if pos >= n:
            raise ValueError("PAM header truncated")
        if ident == b"ENDHDR":          # the data follows its line's end
            return fields, tupltype, _line_end(body, pos)
        if ident not in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL",
                         b"TUPLTYPE"):
            raise ValueError(f"PAM header field {ident[:16]!r}")
        end = _line_end(body, pos)
        value = body[pos:end].split(b"\0")[0].strip(b" \t\n\v\f\r")
        pos = end
        if ident == b"TUPLTYPE":
            if value not in _PAM_FORMATS:
                raise ValueError(f"PAM tuple type {value[:32]!r}")
            tupltype = value
            continue
        if ident in fields:
            raise ValueError(f"PAM header repeats {ident.decode()}")
        if not value.isdigit():
            raise ValueError(f"PAM {ident.decode()} {value[:16]!r} is not a "
                             f"number")
        fields[ident] = int(value)


def _pam(body: bytes, expected_hw):
    fields, tupltype, pos = _pam_header(body)
    if len(fields) != 4:
        raise ValueError("PAM header without WIDTH, HEIGHT, DEPTH and "
                         "MAXVAL")
    w, h = fields[b"WIDTH"], fields[b"HEIGHT"]
    depth, maxval = fields[b"DEPTH"], fields[b"MAXVAL"]
    if maxval > 65535:
        raise ValueError(f"PAM maxval {maxval} over 65535")
    if tupltype is None:
        if depth == 1 and maxval < 256:
            tupltype = b"BLACKANDWHITE" if maxval == 1 else b"GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tupltype = b"RGB"
        else:
            raise ValueError(f"PAM of depth {depth} and maxval {maxval} "
                             f"without a tuple type")
    if not 1 <= depth <= 4 or _PAM_FORMATS[tupltype] != depth:
        raise ValueError(f"PAM {tupltype.decode()} of depth {depth}")
    if tupltype in (b"GRAYSCALE_ALPHA", b"RGB_ALPHA"):
        raise ValueError(f"PAM {tupltype.decode()}: OpenCV's IMREAD_COLOR "
                         f"bytes for it are uninitialised memory")
    _check_size(w, h, expected_hw)
    if maxval == 1:
        return np.where(_bits(body, pos, h, w, w * depth), 255, 0) \
            .astype(np.uint8)[..., None]
    s = _samples(body, pos, h, w, depth, maxval)
    return s[..., ::-1] if depth == 3 else s


def decode_pnm_u8(body: bytes,
                  expected_hw: tuple[int, int] | None = None) -> np.ndarray:
    """P1-P7 bytes -> (h, w, 3) uint8 RGB, ``cv2.imdecode(IMREAD_COLOR)``'s
    bytes swapped to RGB."""
    if len(body) < 3 or body[:1] != b"P" or body[1:2] not in b"1234567" \
            or not body[2:3].isspace():
        raise ValueError("not a PNM image (no P1-P7 header)")
    img = _pam(body, expected_hw) if body[1:2] == b"7" \
        else _pnm(body, expected_hw)
    return np.repeat(img, 3, 2) if img.shape[2] == 1 else img.copy()
