"""One JAX tree's run for `scripts/torch_model_size_jax_code.py`:

    JAX_PLATFORMS=cpu python scripts/model_size_jax_tree.py TREE OUT ROOT \
        ARGS_JSON PROTOCOLS_JSON SITE_JSON

imports TREE's `anoddpm_tpu` (TREE first on sys.path), records what it
draws and computes while its train CLI's `train` runs epoch 0 of ARGS
under ROOT and its `anomalous_metric_calculation` scores the final weights
under each protocol, and writes the records to OUT (.npz) and OUT.json.
It runs the JAX package: it is not part of the port."""
import contextlib
import inspect
import io
import json
import os
import sys
import warnings

warnings.simplefilter("ignore")
tree, out, root, raw, protocols, site = sys.argv[1:7]
raw, protocols, site = json.loads(raw), json.loads(protocols), tuple(json.loads(site))
sys.path.insert(0, tree)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import anoddpm_tpu  # noqa: E402
from anoddpm_tpu import training as tr  # noqa: E402
from anoddpm_tpu.models import unet as un  # noqa: E402
from anoddpm_tpu.ops import noise as nz  # noqa: E402
from anoddpm_tpu.ops import simplex as sx  # noqa: E402

assert os.path.realpath(anoddpm_tpu.__file__).startswith(os.path.realpath(tree))

rec, recipe = {}, {}
def put(tag, *arrays):
    rec.setdefault(tag, []).append([np.asarray(a) for a in arrays])
def kd(key):
    return (jax.random.key_data(key)
            if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key)
phase = ["train"]
def traced(tag):
    return lambda *a: put(f"{phase[0]} {tag}", *a)

_seeds = sx.seeds_from_key
def seeds_rec(key, n):
    s = _seeds(key, n)
    jax.debug.callback(traced("seeds"), s, ordered=True)
    return s
sx.seeds_from_key = seeds_rec

_sampler = nz.sampler_from_args
def sampler_rec(args):
    inner = _sampler(args)
    def sampler(key, shape, t):
        field = inner(key, shape, t)
        jax.debug.callback(traced("noise"), kd(key), t, field, ordered=True)
        return field
    if hasattr(inner, "fingerprint"):
        sampler.fingerprint = inner.fingerprint
    return sampler
nz.sampler_from_args = sampler_rec

_step = tr.make_train_step
def step_rec(*a, **kw):
    recipe["train_step"] = {k: (v if isinstance(v, (int, float, str, bool))
                                or v is None else repr(v)) for k, v in kw.items()}
    return _step(*a, **kw)
tr.make_train_step = step_rec
_opt = tr.make_optimizer
def opt_rec(*a):
    recipe["optimizer"] = {"lr": a[0], "weight_decay": a[1], "grad_clip": a[2]}
    return _opt(*a)
tr.make_optimizer = opt_rec
for name in ("jit_train_step", "jit_multi_step"):
    def wrap(orig, name=name):
        def jitted(*a, **kw):
            recipe["dispatch"] = name + (f" x{a[1]}" if name == "jit_multi_step" else "")
            f = orig(*a, **kw)
            def call(state, x, key):
                put("step", kd(key), x)
                return f(state, x, key)
            return call
        return jitted
    if hasattr(tr, name):
        setattr(tr, name, wrap(getattr(tr, name)))
_unet = un.unet_from_args
def unet_rec(*a, **kw):
    m = _unet(*a, **kw)
    recipe["model"] = {k: repr(getattr(m, k)) for k in m.__dataclass_fields__
                       if k not in ("parent", "name")}
    return m
un.unet_from_args = unet_rec
_init = tr.init_train_state
def init_rec(*a, **kw):
    state = _init(*a, **kw)
    leaves = jax.tree_util.tree_flatten_with_path(state.params)[0]
    rec["init_names"] = [jax.tree_util.keystr(p) for p, _ in leaves]
    jax.debug.callback(lambda *v: put("init", *v), *[v for _, v in leaves])
    return state
tr.init_train_state = init_rec

# imported after the patches above, so that they bind the recording versions
from anoddpm_tpu import detect  # noqa: E402
from anoddpm_tpu import train as jtrain  # noqa: E402
from anoddpm_tpu.config import defaultdict_from_json  # noqa: E402
_batch = detect.evaluate_anomaly_batch
def batch_rec(*a, **kw):
    out, recon = _batch(*a, **kw)
    put(f"{phase[0]} reconstructions", recon)
    return out, recon
detect.evaluate_anomaly_batch = batch_rec

args = defaultdict_from_json(dict(raw))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    jtrain.train(args, root_dir=root, max_epochs=0)
jax.effects_barrier()
with open(os.path.join(root, "metrics", f"args{args['arg_num']}-train.jsonl")) as f:
    loss = json.loads(f.readline())["loss"]
line = next(l for l in buf.getvalue().splitlines() if "total VLB" in l)
vlb = float(line.split("total VLB: ")[1].split()[0])
scores = {}
eargs, em, sched = detect._load_eval_model(root, args["arg_num"])
d_set = detect.anomalous_dataset_from_args(root, eargs)
for i in range(min(len(d_set), int(raw["anomalous_volumes"]))):
    put("anomalous set", d_set[i]["image"], d_set[i]["mask"])
for name, over in protocols:
    phase[0] = name
    a = defaultdict_from_json({**dict(eargs), **over})
    with contextlib.redirect_stdout(io.StringIO()):
        r = detect.anomalous_metric_calculation(args=a, root_dir=root, em=em,
                                                sched=sched,
                                                max_volumes=int(raw["anomalous_volumes"]))
    jax.effects_barrier()
    scores[name] = {k: float(r[k]) for k in ("auc", "dice", "ssim", "iou")}
# one norm+SiLU site, eager, as the UNet computes it, on the inputs of
# tests/test_torch_norm_paths.py (bf16-exact k/16, so that every fp32 sum
# of the statistics is exact in any order)
rng = np.random.default_rng(0)
x = (rng.integers(-64, 65, site) / 16).astype(np.float32)
gamma = (1 + 0.1 * rng.standard_normal(site[-1])).astype(np.float32)
beta = (0.1 * rng.standard_normal(site[-1])).astype(np.float32)
p = {"params": {"GroupNorm_0": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}}
with jax.disable_jit():
    y = jax.nn.silu(un.GroupNorm32().apply(p, jnp.asarray(x).astype(jnp.bfloat16)))
put("norm site", x, gamma, beta, y.astype(jnp.float32))
recipe["norm_site_source"] = inspect.getsource(un.GroupNorm32.__call__)
recipe["norm_site_dtype"] = str(y.dtype)
arrays = {f"{tag}|{i}|{j}": a for tag, rows in rec.items() if tag != "init_names"
          for i, row in enumerate(rows) for j, a in enumerate(row)}
np.savez(out, **arrays)
with open(out + ".json", "w") as f:
    json.dump({"recipe": recipe, "loss": loss, "vlb": vlb, "vlb_line": line,
               "scores": scores, "init_names": rec["init_names"],
               "counts": {tag: len(rows) for tag, rows in rec.items()
                          if tag != "init_names"}}, f)
