"""The PyTorch port stands alone: importing it loads no JAX, flax or
anoddpm_tpu, no source of it names them, and its entry points refuse to
fall back to the CPU quietly when there is no card."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_loads_no_jax():
    # a subprocess, because this test process imported jax in conftest
    code = ("import sys, anoddpm_torch, anoddpm_torch.detect; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'anoddpm_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|anoddpm_tpu)\b",
                         re.MULTILINE)
    files = sorted((ROOT / "anoddpm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    from anoddpm_torch import detect
    from anoddpm_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        detect._load_eval_model(str(tmp_path), "1")
    with pytest.raises(RuntimeError):
        detect.anomalous_metric_calculation(token="1", root_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        detect.main(["1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors; anything else
    launches its kernel or raises (here: the meta device)."""
    from anoddpm_torch.ops.group_norm_silu import group_norm_silu
    from anoddpm_torch.ops.simplex import batched_fractal3_fixed_t
    x = torch.empty((1, 32, 4, 4), device="meta")
    with pytest.raises(ValueError):
        group_norm_silu(x, torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError):
        batched_fractal3_fixed_t(torch.zeros(1, dtype=torch.int64, device="meta"),
                                 torch.zeros(1, device="meta"), (4, 4))
