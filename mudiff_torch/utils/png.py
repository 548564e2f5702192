"""8-bit grayscale PNG files, on the standard library's ``zlib``.

The port's stand-in for PIL, which the card's machine does not have.
``write_gray8`` writes one IHDR (bit depth 8, colour type 0, no
interlace), one IDAT of zlib-compressed rows, each with filter type 0
(None), and IEND; every CRC is ``zlib.crc32``.  ``read_gray8`` reads
8-bit grayscale, non-interlaced PNGs from any writer: it checks the
signature and every CRC, joins the IDAT chunks and undoes all five
filter types (None, Sub, Up, Average, Paeth) row by row.  Any other
format raises ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_gray8(path: str, image: np.ndarray) -> None:
    """Write a (H, W) uint8 array as an 8-bit grayscale PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"write_gray8 takes a 2-D uint8 array, got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image], axis=1)  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    data = (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _average(line: np.ndarray, prior: np.ndarray) -> np.ndarray:
    out, left = [], 0
    for f, up in zip(line.tolist(), prior.tolist()):
        left = (f + ((left + up) >> 1)) & 0xFF
        out.append(left)
    return np.array(out, np.uint8)


def _paeth(line: np.ndarray, prior: np.ndarray) -> np.ndarray:
    out, a, c = [], 0, 0
    for f, b in zip(line.tolist(), prior.tolist()):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        a, c = (f + pred) & 0xFF, b
        out.append(a)
    return np.array(out, np.uint8)


def read_gray8(path: str) -> np.ndarray:
    """Read an 8-bit grayscale PNG into a (H, W) uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[:1].isupper():  # a critical chunk this reader does not know
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if (depth, colour, compression, filtering, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale, non-interlaced PNGs are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {h}x{w}")
    rows = raw.reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prior = np.zeros(w, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line, dtype=np.uint8)
        elif kind == 2:
            out[y] = line + prior
        elif kind == 3:
            out[y] = _average(line, prior)
        elif kind == 4:
            out[y] = _paeth(line, prior)
        else:
            raise ValueError(f"{path}: unknown filter type {kind} in row {y}")
        prior = out[y]
    return out
