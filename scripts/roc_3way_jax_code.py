"""Does the JAX package of today compute the committed 3-way ROC as the
commit that wrote it did?  Runs, on the CPU, the JAX package's `roc_data`
of two JAX trees on the same seeded weights and compares their curves.

    git archive 1602564 anoddpm_tpu | tar -x -C build/jax1602564
    JAX_PLATFORMS=cpu python scripts/roc_3way_jax_code.py build/jax1602564 .

For each tree, in a subprocess of its own (each imports its own
`anoddpm_tpu`): a 32^2 s2d-2 UNet from flax's init of key(1), perturbed
by a seeded N(0, 0.05), saved as a simplex and a Gaussian checkpoint; the
call `roc_data(["s", "g"], ce_token="ce", args_override={"lesion_kind":
"diffuse", "lesion_severity": 1.5})` of
`results/roc_3way_diffuse_sev1.5.csv`'s command, cut to 2 volumes, T 50
(linear; lambda 200 clamps to it) and 20 context-encoder steps; and the
16 buffers of the linear T = 1000 schedule the s2d64 configs train on.
Prints, per curve and buffer, whether the two trees agree bit for bit.
This script runs the JAX package: it is not part of the port."""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

BASE = {"img_size": [32, 32], "dataset": "synthetic", "noise_fn": "simplex",
        "anomalous_volumes": 2, "sample_distance": 16, "T": 50,
        "beta_schedule": "linear", "base_channels": 32, "channel_mults": "1",
        "attention_resolutions": "16", "space_to_depth": 2,
        "compute_dtype": "float32", "Batch_Size": 2}

CHILD = r"""
import json, os, sys, warnings
warnings.simplefilter("ignore")
tree, out, root, base = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
sys.path.insert(0, tree)
import numpy as np, jax, jax.numpy as jnp, optax
import anoddpm_tpu
assert os.path.realpath(anoddpm_tpu.__file__).startswith(os.path.realpath(tree))
from anoddpm_tpu import checkpoint, detect
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.models.unet import UNet
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
model = UNet(img_size=32, base_channels=32, channel_mults=(1,),
             attention_resolutions="16", space_to_depth=2)
params = jax.jit(model.init)(jax.random.key(1), jnp.zeros((1, 32, 32, 1)),
                             jnp.zeros((1,), jnp.int32))
rng = np.random.default_rng(6)
params = jax.tree_util.tree_map(
    lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), params)
for token, kind in (("s", "simplex"), ("g", "gauss")):
    args = defaultdict_from_json({**base, "arg_num": token, "noise_fn": kind})
    checkpoint.save_checkpoint(root, args, 0, params, params,
                               optax.adamw(1e-4).init(params), final=True)
os.makedirs(os.path.join(root, "configs"), exist_ok=True)
with open(os.path.join(root, "configs", "argsce.json"), "w") as f:
    json.dump({**base, "arg_num": "ce"}, f)
curves = detect.roc_data(["s", "g"], root_dir=root, t_distance=200,
                         max_volumes=2, ce_token="ce", ce_train_steps=20,
                         args_override={"lesion_kind": "diffuse",
                                        "lesion_severity": 1.5})
sched = make_schedule(get_beta_schedule(1000, "linear"))
arrays = {f"curve {k} {'fpr tpr'.split()[i]}": np.asarray(v[i])
          for k, v in curves.items() for i in (0, 1)}
arrays.update({f"schedule {k}": np.asarray(v) for k, v in vars(sched).items()
               if hasattr(v, "shape")})
np.savez(out, **arrays)
"""


def run_tree(tree: str, work: str) -> dict:
    out = os.path.join(work, os.path.basename(os.path.abspath(tree)) + ".npz")
    root = tempfile.mkdtemp(dir=work)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), out,
                    root, json.dumps(BASE)], check=True, env=env,
                   stdout=subprocess.DEVNULL)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def main(argv=None):
    old_tree, new_tree = (sys.argv[1:] if argv is None else argv)[:2]
    with tempfile.TemporaryDirectory() as work:
        old, new = run_tree(old_tree, work), run_tree(new_tree, work)
    same = sorted(old) == sorted(new)
    print(f"keys equal: {same} ({len(old)} arrays)")
    for k in sorted(old):
        eq = k in new and old[k].shape == new[k].shape and np.array_equal(old[k], new[k])
        same &= eq
        print(f"{k}: {'bit-equal' if eq else 'DIFFERS'} {old[k].shape}")
    print("the two trees compute the 3-way ROC alike" if same
          else "the trees differ")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
