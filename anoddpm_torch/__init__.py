"""anoddpm-torch: the PyTorch/CUDA port of anoddpm-tpu for NVIDIA Hopper.

Partial-diffusion anomaly detection with multi-octave simplex noise, as in
`anoddpm_tpu`, rebuilt on PyTorch:

- diffusion math as plain functions over a `Schedule` of tensors
  (`anoddpm_torch.schedule`, `anoddpm_torch.diffusion`),
- the guided-diffusion UNet as an `nn.Module` in NCHW layout, with
  submodules named after the flax tree (`anoddpm_torch.models.unet`),
- hand-written CUDA kernels for `sm_90a`: the simplex octave field
  (`anoddpm_torch.ops.simplex`) and fused GroupNorm(32)+SiLU with its
  gradient (`anoddpm_torch.ops.group_norm_silu`), each beside its plain
  PyTorch version, which runs only for tensors on the CPU,
- the headline detection protocol (`python -m anoddpm_torch.detect`),
- training with AdamW and an EMA, checkpoints that resume from the port's
  or the JAX package's, and the test-set suite
  (`python -m anoddpm_torch.train`), data-parallel under `torchrun`
  (`anoddpm_torch.parallel`), with remat and substeps,
- the context-encoder baseline (`anoddpm_torch.baselines`), the paper's
  figures (`anoddpm_torch.figures`) and the import of the reference's
  PyTorch checkpoints (`anoddpm_torch.compat.torch_import`),
- the quality campaigns that train a configuration to its recipe and score
  it against the JAX package's seed band (`anoddpm_torch.campaigns`).

The package never imports `jax`, `flax` or `anoddpm_tpu`; it keeps its own
copies of the JAX-free pieces it needs.  Importing it imports nothing heavy.
"""

__version__ = "0.1.0"
