"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
test marked `cuda` skips without a card."""
