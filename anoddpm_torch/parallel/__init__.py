"""Data parallelism under torch.distributed (`anoddpm_torch.parallel.mesh`)."""
