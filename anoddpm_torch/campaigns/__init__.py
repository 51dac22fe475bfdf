"""The quality campaigns: train a configuration to its recipe with the port
and score it (counterparts of the JAX side's `scripts/flagship_campaign.py`,
`scripts/seed_replication.py`, `scripts/quality_compare.py` and
`scripts/model_size_quality.py`).

- `flagship`: train args256syn128, then DDPM-200 and DDIM-15 detection,
  the test-set suite and the figures, each stage skipped when its result
  exists (``python -m anoddpm_torch.campaigns.flagship``);
- `seed_replication`: fresh seeds per model cell, every protocol on every
  seed, aggregates over every seed in the file;
- `quality_compare`, `model_size_quality`: protocol loops on trained tokens;
- `band`: one result against the JAX package's n-seed band, read as data
  from `results/seed_replication.json`.

They write their own result files (`results/torch_*.json`) and never the
JAX package's.
"""
