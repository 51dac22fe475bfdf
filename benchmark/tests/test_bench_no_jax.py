"""A process that imports the harness, its entries, the reference, every
metric reader and the port's modules that the entries drive holds no
module whose top-level name is jax, jaxlib, flax, optax or anoddpm_tpu."""

import json
import subprocess
import sys

from benchmark.tests.tiny import ROOT

PROBE = """
import json, pathlib, sys
sys.path.insert(0, {root!r})
from benchmark.core import harness, entry_detect, entry_train, trace, yardstick
from benchmark.reference import unet, simplex, diffusion, metrics, train
import anoddpm_torch.detect, anoddpm_torch.train, anoddpm_torch.training
for m in json.load(open({manifest!r}))["per_layer"] + json.load(open({manifest!r}))["end_to_end"]:
    harness.reader(pathlib.Path({bench!r}), m["name"])
print(json.dumps(harness.forbidden_modules()))
"""


def test_no_jax_in_a_run():
    code = PROBE.format(root=str(ROOT), manifest=str(ROOT / "BENCHMARK.json"),
                        bench=str(ROOT / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert set(harness_forbidden()) == {"jax", "jaxlib", "flax", "optax",
                                        "anoddpm_tpu"}


def harness_forbidden():
    from benchmark.core import harness
    return harness.FORBIDDEN
