"""The plain reference: fp32 PyTorch, TF32 off, importing nothing of
`anoddpm_torch` or of the JAX package.  A frozen copy of the equations
of the UNet, the simplex octave field, the schedule, the DDPM and DDIM
updates, the anomaly metrics and the optimiser, written from the port's
sources as they stood when the benchmark was defined."""
