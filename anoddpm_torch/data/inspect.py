"""Dataset sanity harnesses: quick visual checks that a dataset is wired
correctly before spending card time training on it.

Own copy of `anoddpm_tpu/data/inspect.py`, writing through the port's
`visualize` (the sheets with its PNG encoder), under the JAX package's
file names: inspection-outputs/ARGS={n}/anomalous-volumes.mp4 (or .gif)
and sheet-{k}.png.

CLI: ``python -m anoddpm_torch.data.inspect <ARG_NUM> [all|video|compare]``
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .. import visualize as vz
from .datasets import anomalous_dataset_from_args, dataset_from_args


def dataset_volume_video(d_set, out_path: str, max_volumes: int = 22,
                         row_size: int = 5, fps: int = 20) -> str:
    """Animate through the slice axis of the anomalous volumes, each frame
    a grid of all volumes at that slice (`checkDataSet`,
    dataset.py:239-277).  Volumes with fewer slices freeze on their last
    slice."""
    vols = []
    for i in range(min(len(d_set), max_volumes)):
        img = d_set[i]["image"]
        vols.append(np.asarray(img if img.ndim == 4 else img[None]))
    n_slices = max(v.shape[0] for v in vols)
    frames = []
    for s in range(n_slices):
        frame = np.stack([v[min(s, v.shape[0] - 1)] for v in vols])
        frames.append(frame)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    # save_video may fall back to .gif when no mp4 encoder exists
    return vz.save_video(out_path, frames, row_size=row_size, fps=fps)


def healthy_anomalous_grid(healthy_ds, ano_ds, out_dir: str,
                           n_each: int = 10, n_sheets: int = 5,
                           row_size: int = 5) -> list:
    """Side-by-side healthy/anomalous sample sheets
    (`load_datasets_for_test`, dataset.py:330-347): each sheet stacks
    `n_each` healthy samples above `n_each` anomalous slices."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    rng = np.random.default_rng(0)
    for sheet in range(n_sheets):
        healthy = np.stack([
            healthy_ds[int(rng.integers(len(healthy_ds)))]["image"]
            for _ in range(n_each)])
        ano_imgs = []
        while len(ano_imgs) < n_each:
            vol = ano_ds[int(rng.integers(len(ano_ds)))]["image"]
            vol = vol if vol.ndim == 4 else vol[None]
            ano_imgs.append(vol[int(rng.integers(vol.shape[0]))])
        out = np.concatenate([healthy, np.stack(ano_imgs)])
        path = os.path.join(out_dir, f"sheet-{sheet}.png")
        vz.save_grid_png(path, out, row_size=row_size)
        paths.append(path)
    return paths


def inspect(args, root_dir: str = ".", mode: str = "all",
            max_volumes: Optional[int] = None) -> None:
    out_dir = os.path.join(root_dir, "inspection-outputs",
                           f"ARGS={args['arg_num']}")
    if mode in ("all", "video"):
        ano = anomalous_dataset_from_args(root_dir, args)
        p = dataset_volume_video(
            ano, os.path.join(out_dir, "anomalous-volumes.mp4"),
            max_volumes=max_volumes or 22)
        print(f"wrote {p}")
    if mode in ("all", "compare"):
        healthy = dataset_from_args(root_dir, args, train=True)
        ano = anomalous_dataset_from_args(root_dir, args)
        for p in healthy_anomalous_grid(healthy, ano, out_dir):
            print(f"wrote {p}")


def main(argv=None) -> None:
    import sys
    from ..config import load_args
    argv = list(sys.argv[1:] if argv is None else argv)
    token = argv[0] if argv else "_smoke64"
    mode = argv[1] if len(argv) > 1 else "all"
    args = load_args(token)
    inspect(args, mode=mode)


if __name__ == "__main__":
    main()
