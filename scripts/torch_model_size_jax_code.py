"""Does the JAX package of today compute the args256syn64 run that wrote
`results/model_size_quality.json` as the commit that wrote it did?  Runs,
on the CPU, args256syn64's own recipe through the train CLI's `train` and
`scripts/model_size_quality.py`'s three protocols in two (or more) JAX
trees, each in a subprocess of its own, and compares what they draw and
compute.

    mkdir -p build/jax75887cc
    git archive 75887cc anoddpm_tpu | tar -x -C build/jax75887cc
    JAX_PLATFORMS=cpu python scripts/torch_model_size_jax_code.py \
        build/jax75887cc . [--out results/torch_model_size_jax_code.json]

The first tree is the reference, each other tree is held to it; the trees
run at once.  Per tree:
configs/args256syn64.json as the train CLI reads it (its own recipe: no
`train_substeps`, so 1 step a dispatch), cut to 32^2, mults (1, 2),
attention at 16, T 100 (lambda 200 clamps to it) and 2 anomalous volumes,
seed 0, batch 8, 16 steps: epoch 0 through the tree's `train.train`
(`max_epochs=0`: the init, 16 steps, the epoch-0 VLB sweep, the test-set
suite), then `anomalous_metric_calculation` on its final weights under
DDPM-200, DDIM-25 eta 1 and DDIM-15 eta 1.  Recorded, in the order the
tree ran them: the recipe the trainer built (the train step's and the
optimiser's arguments, the dispatch, the model's fields), flax's init of
the seed, each step's loop key and batch, every noise call's key, t and
field, every simplex seed set, the epoch-0 loss and VLB, the anomalous
set, each protocol's metrics; and one norm+SiLU site of each tree's
`GroupNorm32` on a bf16 input (eager), which is also held to the port's
flax order (`norm_impl: "flax"`, `bf16_norm: false`: `flax_norm` on the
CPU) by the rule of `tests/test_torch_norm_paths.py` (on its bf16-exact
inputs the bf16 output bit for bit against JAX eager).  Prints, per record, whether the trees agree bit for bit and
where they first part, and writes it all as JSON.  This script runs the
JAX package: it is not part of the port."""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/args256syn64.json"
CUT = {"img_size": [32, 32], "channel_mults": [1, 2],
       "attention_resolutions": "16", "T": 100, "sample_distance": 80,
       "anomalous_volumes": 2, "arg_num": "msq"}
PROTOCOLS = [
    ("ddpm200", {"sampler": "ddpm"}),
    ("ddim25_eta1", {"sampler": "ddim", "ddim_steps": 25, "ddim_eta": 1.0}),
    ("ddim15_eta1", {"sampler": "ddim", "ddim_steps": 15, "ddim_eta": 1.0}),
]
SITE = (2, 32, 32, 64)   # N, H, W, C of the norm site (NHWC, bf16)

# the run of one tree, in a process of its own (it imports that tree's
# anoddpm_tpu and JAX)
TREE_RUN = os.path.join(ROOT, "scripts", "model_size_jax_tree.py")


def run_tree(tree: str, work: str, raw: dict) -> tuple:
    name = os.path.basename(os.path.abspath(tree)) or "tree"
    out = os.path.join(work, f"{name}.npz")
    root = tempfile.mkdtemp(dir=work)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, TREE_RUN, os.path.abspath(tree), out,
                    root, json.dumps(raw), json.dumps(PROTOCOLS),
                    json.dumps(SITE)], check=True, env=env, cwd=ROOT,
                   stdout=subprocess.DEVNULL)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    with open(out + ".json") as f:
        return arrays, json.load(f)


def records(arrays: dict) -> dict:
    """{tag: [[array, ...] per record]} from the child's flat npz keys."""
    rows = {}
    for k in arrays:
        tag, i, j = k.rsplit("|", 2)
        rows.setdefault(tag, {}).setdefault(int(i), {})[int(j)] = arrays[k]
    return {tag: [[r[j] for j in sorted(r)] for _, r in sorted(rs.items())]
            for tag, rs in rows.items()}


def first_parting(ref: list, got: list):
    """(number of records, index of the first record that differs or None)."""
    for i, (a, b) in enumerate(zip(ref, got)):
        if len(a) != len(b) or not all(
                x.shape == y.shape and np.array_equal(x, y, equal_nan=True)
                for x, y in zip(a, b)):
            return len(ref), i
    return len(ref), (None if len(ref) == len(got) else min(len(ref), len(got)))


def port_site(row) -> dict:
    """The port's flax-order site (`flax_norm`, bf16_path False, SiLU) on
    the tree's input and parameters, against the tree's eager output
    (bf16 bit for bit on these inputs, `tests/test_torch_norm_paths.py`)."""
    import torch
    sys.path.insert(0, ROOT)
    from anoddpm_torch.models.unet import flax_norm
    x, gamma, beta, want = row
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    y = flax_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                  False, True)
    got = y.float().permute(0, 2, 3, 1).numpy()
    return {"dtype": str(y.dtype).replace("torch.", ""),
            "bit_equal_share": float(np.mean(got == want)),
            "max_abs": float(np.abs(got - want).max())}


ORDER = ["recipe", "init", "step", "train noise", "train seeds", "loss",
         "vlb", "anomalous set"] + [
    f"{p} {k}" for p, _ in PROTOCOLS
    for k in ("noise", "seeds", "reconstructions", "scores")] + ["norm site"]
# the committed file rounds each score to 4 decimals
FILE_DECIMALS = 4


def recipe_parting(ref: dict, got: dict) -> dict:
    """The recipe's keys that differ, the model's fields compared where
    both trees have them; a field one tree lacks is listed with its value
    (the norm site's source text is kept, not compared: its arrays are)."""
    out = {"differs": [], "fields_only_in_one": {}}
    for k in sorted(set(ref) | set(got)):
        if k == "norm_site_source":
            continue
        a, b = ref.get(k), got.get(k)
        if k == "model" and a and b:
            out["fields_only_in_one"] = {f: a.get(f, b.get(f))
                                         for f in set(a) ^ set(b)}
            a = {f: v for f, v in a.items() if f in b}
            b = {f: v for f, v in b.items() if f in a}
        if a != b:
            out["differs"].append(k)
    return out


def compare(ref, got) -> dict:
    (ra, rj), (ga, gj) = ref, got
    rr, gr = records(ra), records(ga)
    out = {}
    for tag in ORDER:
        if tag == "recipe":
            out[tag] = recipe_parting(rj["recipe"], gj["recipe"])
            out[tag]["equal"] = not out[tag]["differs"]
        elif tag in ("loss", "vlb"):
            out[tag] = {"equal": rj[tag] == gj[tag], "ref": rj[tag], "got": gj[tag]}
        elif tag.endswith("scores"):
            p = tag.split()[0]
            ref_s, got_s = rj["scores"][p], gj["scores"][p]
            rounded = lambda d: {k: round(v, FILE_DECIMALS) for k, v in d.items()}
            out[tag] = {"equal": rounded(ref_s) == rounded(got_s),
                        "bit_equal": ref_s == got_s,
                        "largest_difference": max(abs(ref_s[k] - got_s[k])
                                                  for k in ref_s),
                        "ref": ref_s, "got": got_s}
        else:
            n, i = first_parting(rr.get(tag, []), gr.get(tag, []))
            out[tag] = {"equal": i is None and n > 0, "records": n,
                        "first_differs_at": i}
            if tag == "init":
                out[tag]["names_equal"] = rj["init_names"] == gj["init_names"]
                out[tag]["equal"] &= out[tag]["names_equal"]
    parted = [t for t in ORDER if not out[t]["equal"]]
    out["first_parting"] = parted[0] if parted else None
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="scripts/torch_model_size_jax_code.py")
    p.add_argument("trees", nargs="+", help="JAX trees; the first is the reference")
    p.add_argument("--out", default=None, help="JSON path (relative to the repo)")
    ns = p.parse_args(sys.argv[1:] if argv is None else argv)
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
    raw.update(CUT)
    with tempfile.TemporaryDirectory() as work, \
            concurrent.futures.ThreadPoolExecutor(len(ns.trees)) as pool:
        runs = list(pool.map(lambda t: run_tree(t, work, raw), ns.trees))
    ref_site = records(runs[0][0])["norm site"][0]
    res = {"config": CONFIG, "cut": CUT, "protocols": [n for n, _ in PROTOCOLS],
           "trees": ns.trees, "recipe": runs[0][1]["recipe"],
           "epoch0": {t: {"loss": r[1]["loss"], "vlb": r[1]["vlb"]}
                      for t, r in zip(ns.trees, runs)},
           "scores": {t: r[1]["scores"] for t, r in zip(ns.trees, runs)},
           "counts": runs[0][1]["counts"],
           "port_norm_site": {t: port_site(records(r[0])["norm site"][0])
                              for t, r in zip(ns.trees, runs)},
           "against": {}}
    for tree, run in zip(ns.trees[1:], runs[1:]):
        cmp = compare(runs[0], run)
        res["against"][tree] = cmp
        print(f"== {tree} against {ns.trees[0]}")
        for tag in ORDER:
            c = cmp[tag]
            extra = (f" ({c['records']} records"
                     + (f", first differs at {c['first_differs_at']}"
                        if c.get("first_differs_at") is not None else "") + ")"
                     if "records" in c else "")
            if tag.endswith("scores"):
                extra = (f" at {FILE_DECIMALS} decimals; bit-equal "
                         f"{c['bit_equal']}, largest difference "
                         f"{c['largest_difference']:.3e}")
                print(f"{tag}: {'equal' if c['equal'] else 'DIFFER'}{extra}")
                continue
            print(f"{tag}: {'bit-equal' if c['equal'] else 'DIFFERS'}{extra}")
        print("first parting:", cmp["first_parting"])
    same = all(c["first_parting"] is None for c in res["against"].values())
    res["verdict"] = ("today's JAX package computes the reference tree's "
                      "args256syn64 run" if same else
                      "the trees part at: " + "; ".join(
                          f"{t}: {c['first_parting']}"
                          for t, c in res["against"].items() if c["first_parting"]))
    print(res["verdict"])
    print("port norm site:", json.dumps(res["port_norm_site"]))
    if ns.out:
        path = os.path.join(ROOT, ns.out)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
