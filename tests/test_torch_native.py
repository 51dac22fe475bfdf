"""The port's host C++ OpenSimplex oracle (`anoddpm_torch.ops.native`, its
own copy of csrc/simplex3.cpp built by g++ into build/kernels/): the
goldens and the JAX package's `native` bit for bit, and the port's
table-path field within float32 of it."""
import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is not installed")

from anoddpm_torch.ops import native  # noqa: E402


@pytest.fixture(scope="module")
def jax_native():
    from anoddpm_tpu.ops import native as jn
    jn.build()
    return jn


def test_builds_under_build_kernels():
    path = native.build()
    assert "/build/kernels/" in path and path.endswith(".so")
    assert native.SOURCE.read_bytes().count(b"anoddpm_fractal_fixed_t") >= 1


@pytest.mark.parametrize("seed", [3, 12345, -9876543210, 9999999999])
def test_perm_matches_golden_and_jax(golden, jax_native, seed):
    g = golden(f"golden_perm_{seed}.npz")
    perm, grad_id = native.init_perm(seed)
    np.testing.assert_array_equal(perm, g["perm"])
    np.testing.assert_array_equal(grad_id * 3, g["perm_grad_index3"])
    jp, jg = jax_native.init_perm(seed)
    np.testing.assert_array_equal(perm, jp)
    np.testing.assert_array_equal(grad_id, jg)


def test_noise3_matches_golden_and_jax(golden, jax_native):
    g = golden("golden_noise3.npz")
    perm = g["perm"].astype(np.int32)
    gid = (g["pgi"] // 3).astype(np.int32)
    pts = g["pts"]
    vals = native.noise3_batch(pts[:, 0], pts[:, 1], pts[:, 2], perm, gid)
    np.testing.assert_allclose(vals, g["vals"], atol=1e-12)
    np.testing.assert_array_equal(
        vals, jax_native.noise3_batch(pts[:, 0], pts[:, 1], pts[:, 2], perm, gid))
    assert native.noise3(*pts[0], perm, gid) == vals[0]


def test_octave_field_matches_golden_and_jax(golden, jax_native):
    g = golden("golden_octave_field.npz")
    perm = g["perm"].astype(np.int32)
    gid = (g["pgi"] // 3).astype(np.int32)
    field = native.fractal_fixed_t((16, 24), 7.0, octaves=4, persistence=0.8,
                                   frequency=8.0, perm=perm, grad_id=gid)
    np.testing.assert_allclose(field, g["field"][0], atol=1e-12)
    np.testing.assert_array_equal(field, jax_native.fractal_fixed_t(
        (16, 24), 7.0, octaves=4, persistence=0.8, frequency=8.0, perm=perm,
        grad_id=gid))


def test_oracle_holds_the_table_path_field():
    """The port's table-path field (float32, plain PyTorch on the CPU)
    against the oracle's float64 field from the same tables."""
    from anoddpm_torch.ops import simplex as sx
    perm, gid = native.init_perm(424242)
    ts_ = [0.0, 37.0]
    got = sx.batched_fractal3_fixed_t_table(
        torch.from_numpy(np.stack([perm] * 2).astype(np.int64)),
        torch.from_numpy(np.stack([gid] * 2).astype(np.int64)),
        torch.tensor(ts_), (24, 20), 6, 0.8, 64.0).numpy()
    for i, t in enumerate(ts_):
        want = native.fractal_fixed_t((24, 20), t, 6, 0.8, 64.0, perm, gid)
        err = np.abs(got[i] - want)
        assert np.median(err) < 1e-6 and (err < 1e-4).mean() > 0.99, err.max()
