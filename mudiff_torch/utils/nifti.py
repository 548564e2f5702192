"""Minimal self-contained NIfTI-1 reader/writer.

The port's own copy of ``mudiff_tpu/utils/nifti.py`` (pure numpy, gzip,
struct): the port imports nothing of the JAX package, so it keeps its
own.  The two must read and write the same files;
``tests/test_torch_port_volume.py`` checks that both ways.  The subset
the pipeline needs: load .nii/.nii.gz volumes (data + affine + raw
header), apply scl slope/inter, and save float32 volumes with a
preserved affine (reference engine/test_volume.py:292-300).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348


@dataclass
class Nifti1Image:
    """A loaded NIfTI volume: float-capable data, 4x4 affine, raw header."""

    dataobj: np.ndarray
    affine: np.ndarray
    header_bytes: bytes

    def get_fdata(self) -> np.ndarray:
        return self.dataobj.astype(np.float32, copy=False)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dataobj.shape

    @property
    def header(self) -> bytes:
        return self.header_bytes


def _open(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _affine_from_header(hdr: bytes, bo: str) -> np.ndarray:
    sform_code = struct.unpack_from(bo + "h", hdr, 254)[0]
    qform_code = struct.unpack_from(bo + "h", hdr, 252)[0]
    pixdim = np.asarray(struct.unpack_from(bo + "8f", hdr, 76))
    if sform_code > 0:
        rows = [
            struct.unpack_from(bo + "4f", hdr, 280),
            struct.unpack_from(bo + "4f", hdr, 296),
            struct.unpack_from(bo + "4f", hdr, 312),
        ]
        aff = np.eye(4, dtype=np.float64)
        aff[:3, :] = rows
        return aff
    if qform_code > 0:
        b, c, d = struct.unpack_from(bo + "3f", hdr, 256)
        ox, oy, oz = struct.unpack_from(bo + "3f", hdr, 268)
        a2 = max(0.0, 1.0 - b * b - c * c - d * d)
        a = np.sqrt(a2)
        R = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        scales = np.array([pixdim[1], pixdim[2], qfac * pixdim[3]])
        aff = np.eye(4)
        aff[:3, :3] = R * scales
        aff[:3, 3] = (ox, oy, oz)
        return aff
    aff = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    return aff


def load(path: str) -> Nifti1Image:
    with _open(path) as f:
        raw = f.read()
    if len(raw) < HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    bo = "<" if sizeof_hdr == HDR_SIZE else ">"
    if struct.unpack_from(bo + "i", raw, 0)[0] != HDR_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file")
    magic = raw[344:348]
    if magic.startswith(b"ni1"):
        raise ValueError(
            f"{path}: detached .hdr/.img NIfTI pairs are not supported; "
            "convert to single-file .nii/.nii.gz"
        )
    if not magic.startswith(b"n+1"):
        raise ValueError(f"{path}: bad magic {magic!r}")
    dim = struct.unpack_from(bo + "8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack_from(bo + "h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype code {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    vox_offset = int(struct.unpack_from(bo + "f", raw, 108)[0]) or 352
    scl_slope, scl_inter = struct.unpack_from(bo + "2f", raw, 112)
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(
        raw, dtype=dt, count=count, offset=vox_offset
    ).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    affine = _affine_from_header(raw[:HDR_SIZE], bo)
    return Nifti1Image(
        dataobj=np.asarray(data), affine=affine, header_bytes=raw[:HDR_SIZE]
    )


def save(
    img_or_data,
    affine: Optional[np.ndarray] = None,
    path: Optional[str] = None,
    header: Optional[bytes] = None,
) -> None:
    """Save a volume as float32 NIfTI (.nii or .nii.gz by extension).

    Accepts either a Nifti1Image or (data, affine).  When a source header
    is given, its geometry fields (pixdim, q/s-form) are carried over and
    only dim/datatype/offset are rewritten.
    """
    if isinstance(img_or_data, Nifti1Image):
        data = img_or_data.dataobj
        affine = img_or_data.affine if affine is None else affine
        header = img_or_data.header_bytes if header is None else header
    else:
        data = img_or_data
    assert path is not None, "save path required"
    data = np.asarray(data, dtype=np.float32)

    if header is not None and struct.unpack_from("<i", header, 0)[0] != HDR_SIZE:
        # Big-endian source header: patching LE fields into it would
        # produce a mixed-endian (corrupt) file.  Rebuild a fresh LE
        # header carrying over only the geometry fields we preserve
        # (pixdim + xyzt_units); q/s-form are rewritten from the affine
        # below.
        pixdim = struct.unpack_from(">8f", header, 76)
        xyzt_units = header[123:124]
        fresh = bytearray(HDR_SIZE)
        struct.pack_into("<8f", fresh, 76, *pixdim)
        fresh[123:124] = xyzt_units
        header = bytes(fresh)

    hdr = bytearray(header if header is not None else bytes(HDR_SIZE))
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(np.float32)])
    struct.pack_into("<h", hdr, 72, 32)  # bitpix
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl slope/inter
    if affine is not None:
        struct.pack_into("<h", hdr, 254, 1)  # sform_code = 1
        struct.pack_into("<4f", hdr, 280, *np.asarray(affine)[0, :4])
        struct.pack_into("<4f", hdr, 296, *np.asarray(affine)[1, :4])
        struct.pack_into("<4f", hdr, 312, *np.asarray(affine)[2, :4])
    hdr[344:348] = b"n+1\x00"
    body = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    with _open(path, "wb") as f:
        f.write(body)
