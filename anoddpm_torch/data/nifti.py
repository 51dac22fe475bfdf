"""Minimal NIfTI-1 reader (own copy of `anoddpm_tpu/data/nifti.py`, numpy
and the standard library only): .nii and .nii.gz single-file images, the
common on-disk dtypes in either byte order, and scl_slope/scl_inter
scaling, enough to read the NFBS and Edinburgh T1 volumes.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


def read_nifti(path: str) -> Tuple[np.ndarray, dict]:
    """Returns (data array in file axis order, header dict)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr == 348:
        endian = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == 348:
        endian = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = dim[0]
    shape = tuple(dim[1:1 + ndim])
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    vox_offset = int(struct.unpack_from(endian + "f", raw, 108)[0])
    magic = raw[344:348]
    if not magic.startswith(b"n+1") and not magic.startswith(b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count,
                         offset=vox_offset or 352)
    data = data.reshape(shape, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0) and not np.isnan(scl_slope):
        data = data * scl_slope + scl_inter
    header = {"shape": shape, "datatype": datatype, "scl_slope": scl_slope,
              "scl_inter": scl_inter}
    return data, header
