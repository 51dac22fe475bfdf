"""The s2d64 campaigns' results beside what they are held against, as
markdown tables:

    python3 scripts/torch_s2d64_report.py [RESULTS_DIR]

RESULTS_DIR (results/ by default) holds the port's files
(torch_diffuse_calibration.json, torch_train_longer.json,
torch_dense_sweep_full.json, torch_f3_s2d64.json, torch_dense_sweep/) and
the JAX package's diffuse_calibration.json and dense_sweep_full.json.
From the checkout: the JAX seed bands (results/seed_replication.json),
the port's 600-epoch seeds (results/torch_seed_replication.json) and the
JAX pooled curve (metrics/args256syn64s2d-lambda.csv).  A file that is
absent leaves its table out.  Needs neither a card nor torch."""
import csv
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 2.0


def load(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def band(seed_results, cell, metric):
    agg = seed_results[f"{cell}/aggregate"][metric]
    return agg["mean"] - K * agg["std"], agg["mean"] + K * agg["std"]


def held(value, lo, hi):
    return f"{value:.4f} ({'inside' if lo <= value <= hi else 'OUTSIDE'} {lo:.4f}–{hi:.4f})"


def diffuse_table(res_dir, jax_seeds, port_seeds):
    port = load(os.path.join(res_dir, "torch_diffuse_calibration.json"))
    jax = load(os.path.join(res_dir, "diffuse_calibration.json"))
    if port is None:
        return
    print("| Severity | Port AUC | Port Dice | Port SSIM | Port IoU | JAX AUC | JAX Dice |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for key in sorted(port, key=lambda k: float(k.rsplit("sev", 1)[1])):
        p, j = port[key], (jax or {}).get(key, {})
        print(f"| {key.rsplit('sev', 1)[1]} | {p['auc']:.4f} | {p['dice']:.4f} | "
              f"{p['ssim']:.4f} | {p['iou']:.4f} | {j.get('auc', float('nan')):.4f} | "
              f"{j.get('dice', float('nan')):.4f} |")
    sev = port.get("ddim15_eta1_diffuse_sev1.5")
    if sev:
        cell = "s2d64_ddim15_eta1_diffuse"
        seed1 = port_seeds.get(f"{cell}/seed1", {})
        print(f"\nsev 1.5 against the JAX band {cell} (mean ± {K:g}σ, n = "
              f"{jax_seeds[cell + '/aggregate']['auc']['n']}): AUC "
              f"{held(sev['auc'], *band(jax_seeds, cell, 'auc'))}, Dice "
              f"{held(sev['dice'], *band(jax_seeds, cell, 'dice'))}; the "
              f"port's seed 1 in that cell (torch_seed_replication.json): AUC "
              f"{seed1.get('auc', float('nan')):.4f}, "
              f"Dice {seed1.get('dice', float('nan')):.4f}")
    aucs = [port[k]["auc"] for k in sorted(port, key=lambda k: float(k.rsplit("sev", 1)[1]))]
    print(f"AUC rises with severity: {all(a < b for a, b in zip(aucs, aucs[1:]))}\n")


def longer_table(res_dir, port_seeds):
    res = load(os.path.join(res_dir, "torch_train_longer.json"))
    if not res:
        return
    print("| Key | AUC | Dice | SSIM | IoU | 600 epochs (same seed): AUC | Dice |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for key, e in sorted(res.items()):
        cell, seed = key.split("/")
        base = port_seeds.get(f"s2d64_{cell.split('_', 1)[1]}/{seed}", {})
        print(f"| {key} | {e['auc']:.4f} | {e['dice']:.4f} | {e['ssim']:.4f} | "
              f"{e['iou']:.4f} | {base.get('auc', float('nan')):.4f} | "
              f"{base.get('dice', float('nan')):.4f} |")
    print()


def read_curve(path):
    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def dense_table(res_dir):
    summary = load(os.path.join(res_dir, "torch_dense_sweep_full.json"))
    port_csv = os.path.join(res_dir, "torch_dense_sweep",
                            "args256syn64s2d-lambda.csv")
    if summary is None or not os.path.exists(port_csv):
        return
    jax_summary = load(os.path.join(res_dir, "dense_sweep_full.json")) or {}
    port = read_curve(port_csv)
    jax = read_curve(os.path.join(ROOT, "metrics", "args256syn64s2d-lambda.csv"))
    print(f"dense sweep: {summary['volumes']} volumes, λ step "
          f"{summary['lambda_step']}, {len(summary['csv_files'])} CSVs; sweep "
          f"{summary['sweep_seconds']:.1f} s (JAX run on its own system: "
          f"{jax_summary.get('sweep_seconds', float('nan')):.1f} s), train "
          f"{summary.get('train_seconds', float('nan')):.1f} s for "
          f"{summary.get('train_epochs', 'no')} epochs")
    print("\n| λ | Port AUC | JAX AUC | Port Dice | JAX Dice | Port SSIM | JAX SSIM |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for i, (p, j) in enumerate(zip(port, jax)):
        if i % 4 == 0 or i == len(port) - 1:
            print(f"| {int(p['t'])} | {p['auc']:.4f} | {j['auc']:.4f} | "
                  f"{p['dice']:.4f} | {j['dice']:.4f} | {p['ssim']:.4f} | "
                  f"{j['ssim']:.4f} |")
    for name, curve in (("port", port), ("JAX", jax)):
        a = max(curve, key=lambda r: r["auc"])
        d = max(curve, key=lambda r: r["dice"])
        print(f"{name}: AUC peaks at λ {int(a['t'])} ({a['auc']:.4f}), Dice at "
              f"λ {int(d['t'])} ({d['dice']:.4f}); λ = 0 row dice "
              f"{curve[0]['dice']:.3g}, ssim {curve[0]['ssim']:.4f}, auc "
              f"{curve[0]['auc']:.4f}")
    print()


def f3_table(res_dir, jax_seeds, port_seeds):
    res = load(os.path.join(res_dir, "torch_f3_s2d64.json"))
    if not res:
        return
    print("| Cell | Seed 0 AUC | Seed 0 Dice | Seed 1 AUC | Dice | JAX band AUC | Dice |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for key, e in sorted(res.items()):
        cell = key.split("/")[0]
        s1 = port_seeds.get(f"{cell}/seed1", {})
        lo_a, hi_a = band(jax_seeds, cell, "auc")
        lo_d, hi_d = band(jax_seeds, cell, "dice")
        agg = jax_seeds[f"{cell}/aggregate"]
        sig = (e["dice"] - agg["dice"]["mean"]) / agg["dice"]["std"]
        print(f"| {cell} | {held(e['auc'], lo_a, hi_a)} | "
              f"{held(e['dice'], lo_d, hi_d)} ({sig:+.1f}σ) | "
              f"{s1.get('auc', float('nan')):.4f} | "
              f"{s1.get('dice', float('nan')):.4f} | {lo_a:.4f}–{hi_a:.4f} | "
              f"{lo_d:.4f}–{hi_d:.4f} |")
    print()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    res_dir = argv[0] if argv else os.path.join(ROOT, "results")
    jax_seeds = load(os.path.join(ROOT, "results", "seed_replication.json"))
    port_seeds = load(os.path.join(ROOT, "results",
                                   "torch_seed_replication.json")) or {}
    diffuse_table(res_dir, jax_seeds, port_seeds)
    longer_table(res_dir, port_seeds)
    dense_table(res_dir)
    f3_table(res_dir, jax_seeds, port_seeds)


if __name__ == "__main__":
    main()
