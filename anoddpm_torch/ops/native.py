"""ctypes bindings for the host C++ OpenSimplex oracle (csrc/simplex3.cpp).

Counterpart of `anoddpm_tpu/ops/native.py:24-101`, over the port's own
copy of the source.  `g++ -O3 -ffp-contract=off` builds it at first use
into `build/kernels/` at the root of the checkout (beside the CUDA
kernels, never next to the source), under a name keyed by a hash of the
source and the flags.  It is an independent float64 implementation of the
noise: the oracle of the table-path field (`ops.simplex`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional, Tuple

import numpy as np

from ._build import BUILD_DIR, CSRC

SOURCE = CSRC / "simplex3.cpp"
# -ffp-contract=off: a fused multiply-add moves exact region-boundary cases
# (in_sum == 2.0) into another simplex region than plain float64 does.
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsimplex3_host-{digest}.so"


def build() -> str:
    """Compile the library unless it is built; returns its path."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.anoddpm_init_perm.argtypes = [ctypes.c_int64, i32p, i32p]
        lib.anoddpm_noise3.restype = ctypes.c_double
        lib.anoddpm_noise3.argtypes = [ctypes.c_double] * 3 + [i32p, i32p]
        lib.anoddpm_noise3_batch.argtypes = [f64p, f64p, f64p,
                                             ctypes.c_int64, i32p, i32p, f64p]
        lib.anoddpm_fractal_fixed_t.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, i32p, i32p, f64p]
        _lib = lib
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _table(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def init_perm(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's permutation table and gradient ids for `seed`,
    (256,) int32 each."""
    lib = _load()
    perm = np.zeros(256, np.int32)
    grad_id = np.zeros(256, np.int32)
    lib.anoddpm_init_perm(ctypes.c_int64(seed), _i32p(perm), _i32p(grad_id))
    return perm, grad_id


def noise3(x: float, y: float, z: float, perm, grad_id) -> float:
    perm, grad_id = _table(perm), _table(grad_id)
    return _load().anoddpm_noise3(x, y, z, _i32p(perm), _i32p(grad_id))


def noise3_batch(xs, ys, zs, perm, grad_id) -> np.ndarray:
    """noise3 at every point (xs[i], ys[i], zs[i]), float64."""
    lib = _load()
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    zs = np.ascontiguousarray(zs, np.float64)
    perm, grad_id = _table(perm), _table(grad_id)
    out = np.zeros(xs.shape, np.float64)
    lib.anoddpm_noise3_batch(_f64p(xs), _f64p(ys), _f64p(zs), xs.size,
                             _i32p(perm), _i32p(grad_id), _f64p(out))
    return out


def fractal_fixed_t(shape_hw, t: float, octaves: int = 6,
                    persistence: float = 0.8, frequency: float = 64.0,
                    perm=None, grad_id=None, seed: int = 3) -> np.ndarray:
    """The (H, W) octave field on the plane z = t, float64, from `perm` and
    `grad_id` (or those of `seed`)."""
    lib = _load()
    if perm is None:
        perm, grad_id = init_perm(seed)
    perm, grad_id = _table(perm), _table(grad_id)
    h, w = shape_hw
    out = np.zeros((h, w), np.float64)
    lib.anoddpm_fractal_fixed_t(h, w, t, octaves, persistence, frequency,
                                _i32p(perm), _i32p(grad_id), _f64p(out))
    return out
