"""The PyTorch port stands alone: importing it loads no JAX, flax or
anoddpm_tpu (nor pandas, matplotlib or imageio, which only its writers
import when called, nor cv2, PIL or nibabel, which the card's machine
lacks), no source of it names them, and its entry points refuse to
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
    code = ("import sys, anoddpm_torch, anoddpm_torch.detect, "
            "anoddpm_torch.train, anoddpm_torch.training, "
            "anoddpm_torch.evaluation, anoddpm_torch.observe, "
            "anoddpm_torch.models.ema, anoddpm_torch.data.pipeline, "
            "anoddpm_torch.data.datasets, anoddpm_torch.compat.flax_params, "
            "anoddpm_torch.compat.jax_random, anoddpm_torch.compat.flax_init, "
            "anoddpm_torch.streams, "
            "anoddpm_torch.visualize, anoddpm_torch.graphs, "
            "anoddpm_torch.metrics, anoddpm_torch.diffusion, "
            "anoddpm_torch.data.nifti, anoddpm_torch.data.transforms, "
            "anoddpm_torch.data.preprocess, anoddpm_torch.data.inspect, "
            "anoddpm_torch.data.synthetic, anoddpm_torch.ops.noise, "
            "anoddpm_torch.ops.simplex, anoddpm_torch.parallel, "
            "anoddpm_torch.parallel.mesh, anoddpm_torch.baselines, "
            "anoddpm_torch.figures, anoddpm_torch.models.context_encoder, "
            "anoddpm_torch.compat.torch_import, anoddpm_torch.ops.native, "
            "anoddpm_torch.campaigns, anoddpm_torch.campaigns._results, "
            "anoddpm_torch.campaigns._stages, "
            "anoddpm_torch.campaigns.band, anoddpm_torch.campaigns.flagship, "
            "anoddpm_torch.campaigns.seed_replication, "
            "anoddpm_torch.campaigns.quality_compare, "
            "anoddpm_torch.campaigns.model_size_quality, "
            "anoddpm_torch.campaigns.diffuse_calibration, "
            "anoddpm_torch.campaigns.train_longer, "
            "anoddpm_torch.campaigns.dense_sweep, "
            "anoddpm_torch.campaigns.f3_s2d64, anoddpm_torch.bench, "
            "anoddpm_torch.campaigns.chain_flops, "
            "anoddpm_torch.campaigns.mfu_push, "
            "anoddpm_torch.campaigns.bf16_norm_ab, "
            "anoddpm_torch.campaigns.substep_probe, "
            "anoddpm_torch.campaigns.trace_categories; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'anoddpm_tpu', "
            "'pandas', 'matplotlib', 'imageio', 'cv2', 'PIL', 'nibabel') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "anoddpm_torch.parallel", "anoddpm_torch.parallel.mesh",
    "anoddpm_torch.baselines", "anoddpm_torch.figures",
    "anoddpm_torch.models.context_encoder", "anoddpm_torch.compat.torch_import",
    "anoddpm_torch.ops.native", "anoddpm_torch.campaigns",
    "anoddpm_torch.campaigns._results", "anoddpm_torch.campaigns._stages",
    "anoddpm_torch.campaigns.band",
    "anoddpm_torch.campaigns.flagship", "anoddpm_torch.campaigns.seed_replication",
    "anoddpm_torch.campaigns.quality_compare",
    "anoddpm_torch.campaigns.model_size_quality",
    "anoddpm_torch.campaigns.diffuse_calibration",
    "anoddpm_torch.campaigns.train_longer", "anoddpm_torch.campaigns.dense_sweep",
    "anoddpm_torch.campaigns.f3_s2d64", "anoddpm_torch.bench",
    "anoddpm_torch.campaigns.chain_flops", "anoddpm_torch.campaigns.mfu_push",
    "anoddpm_torch.campaigns.bf16_norm_ab",
    "anoddpm_torch.campaigns.substep_probe",
    "anoddpm_torch.campaigns.trace_categories",
    "anoddpm_torch.compat.jax_random", "anoddpm_torch.compat.flax_init",
    "anoddpm_torch.streams"])
def test_new_modules_load_no_jax_or_writers(module):
    """Each module alone loads no jax, flax, optax, matplotlib or imageio."""
    code = (f"import sys, {module}; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'anoddpm_tpu', "
            "'matplotlib', 'imageio') if m in sys.modules]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|anoddpm_tpu)\b",
                         re.MULTILINE)
    files = (sorted((ROOT / "anoddpm_torch").rglob("*.py"))
             + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_sources_import_no_image_packages():
    """cv2, PIL and nibabel are not on the card's machine: the port reads
    NIfTI, PNG and draws its masks itself."""
    pattern = re.compile(r"^\s*(import|from)\s+(cv2|PIL|nibabel)\b", re.MULTILINE)
    files = sorted((ROOT / "anoddpm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert [str(f) for f in files if pattern.search(f.read_text())] == []


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
    from anoddpm_torch import train
    from anoddpm_torch.config import load_args
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(load_args("256syn128", config_dir=str(ROOT / "configs")),
                    root_dir=str(tmp_path))
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
    from anoddpm_torch.ops.simplex import batched_fractal3_fixed_t_params
    with pytest.raises(ValueError):
        batched_fractal3_fixed_t_params(
            torch.zeros(1, dtype=torch.int64, device="meta"),
            torch.zeros(1, device="meta"), (4, 4), torch.zeros(3, device="meta"))
    from anoddpm_torch.ops.group_norm_silu import group_norm_silu_backward
    stats = torch.zeros((1, 32), device="meta")
    with pytest.raises(ValueError):
        group_norm_silu_backward(x, x, torch.ones(32), torch.zeros(32), stats,
                                 stats)
