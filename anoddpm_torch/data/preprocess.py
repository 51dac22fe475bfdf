"""Dataset preprocessing: NIfTI volumes -> normalised .npy volume caches.

Own copy of `anoddpm_tpu/data/preprocess.py`, numpy only.

CLI: ``python -m anoddpm_torch.data.preprocess <DATASETS_ROOT>``
- NFBS Train/Test healthy volumes: read the T1 .nii.gz, clip-normalise
  (mean - std .. mean + 2 std), save {name}.npy beside the source;
- Edinburgh Anomalous-T1: raw and mask volumes, each turned by `np.rot90`,
  to raw_cleaned/ and mask/ .npy stacks;
- `export_anogan_pngs`: the optional 64 x 64 PNG export of the 4
  restricted slices of each anomalous volume, through the port's resize
  and PNG encoder.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import visualize as vz
from . import transforms as T
from .nifti import read_nifti


def preprocess_healthy(root: str, subset: str = "Train",
                       verbose: bool = True) -> int:
    """NFBS volumes: normalise and cache as .npy; returns how many."""
    base = os.path.join(root, subset)
    if not os.path.isdir(base):
        return 0
    count = 0
    for name in sorted(os.listdir(base)):
        vol_dir = os.path.join(base, name)
        if not os.path.isdir(vol_dir):
            continue
        out = os.path.join(vol_dir, f"{name}.npy")
        if os.path.exists(out):
            continue
        nii = os.path.join(vol_dir, f"sub-{name}_ses-NFB3_T1w.nii.gz")
        if not os.path.exists(nii):
            continue
        volume, _ = read_nifti(nii)
        volume = T.clip_normalise_volume(volume)
        np.save(out, volume.astype(np.float32))
        count += 1
        if verbose:
            print(f"cached {out}")
    return count


def preprocess_anomalous(root: str, verbose: bool = True) -> int:
    """Edinburgh anomalous volumes: image and mask .npy stacks; returns how
    many volumes."""
    ano = os.path.join(root, "CancerousDataset", "EdinburghDataset",
                       "Anomalous-T1")
    raw_dir = os.path.join(ano, "raw")
    out_img = os.path.join(ano, "raw_cleaned")
    out_mask = os.path.join(ano, "mask")
    if not os.path.isdir(raw_dir):
        return 0
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_mask, exist_ok=True)
    count = 0
    for fname in sorted(os.listdir(raw_dir)):
        if not (fname.endswith(".nii") or fname.endswith(".nii.gz")):
            continue
        name = fname.split(".")[0]
        out = os.path.join(out_img, f"{name}.npy")
        if os.path.exists(out):
            continue
        volume, _ = read_nifti(os.path.join(raw_dir, fname))
        volume = np.rot90(volume)
        volume = T.clip_normalise_volume(volume)
        np.save(out, volume.astype(np.float32))
        mask_src = os.path.join(ano, "mask_raw", fname)
        if os.path.exists(mask_src):
            mask, _ = read_nifti(mask_src)
            mask = np.rot90(mask)
            np.save(os.path.join(out_mask, f"{name}.npy"),
                    (mask > 0).astype(np.float32))
        count += 1
        if verbose:
            print(f"cached {out}")
    return count


def _png_u8(img: np.ndarray) -> np.ndarray:
    """A float image as cv2.imwrite stores it in an 8-bit PNG: rounded to
    the nearest integer, ties to even, and saturated to 0..255."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def export_anogan_pngs(root: str, out_size: int = 64) -> int:
    """out_size^2 PNGs of the 4 restricted slices of each anomalous volume
    (and of its mask) under root/AnoGAN; returns how many slices."""
    from .datasets import EDINBURGH_SLICES
    ano = os.path.join(root, "CancerousDataset", "EdinburghDataset",
                       "Anomalous-T1")
    out_dir = os.path.join(root, "AnoGAN")
    img_dir = os.path.join(out_dir, "Anomalous")
    mask_dir = os.path.join(out_dir, "Anomalous-mask")
    count = 0
    if not os.path.isdir(os.path.join(ano, "raw_cleaned")):
        return 0
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    def write(path, img):
        small = T.resize_bilinear(T.center_crop(img.astype(np.float32), (175, 240))
                                  * np.float32(255.0), (out_size, out_size))
        with open(path, "wb") as f:
            f.write(vz.encode_png(_png_u8(small)))

    for name, (lo, hi) in EDINBURGH_SLICES.items():
        vol_path = os.path.join(ano, "raw_cleaned", f"{name}.npy")
        mask_path = os.path.join(ano, "mask", f"{name}.npy")
        if not os.path.exists(vol_path):
            continue
        volume = np.load(vol_path)
        mask_vol = np.load(mask_path) if os.path.exists(mask_path) else None
        for s in np.linspace(lo + 5, hi - 5, 4).astype(np.int32):
            write(os.path.join(img_dir, f"{name}-slice={s}.png"), volume[s])
            if mask_vol is not None:
                write(os.path.join(mask_dir, f"{name}-slice={s}.png"), mask_vol[s])
            count += 1
    return count


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    root = argv[0] if argv else "./DATASETS"
    n_train = preprocess_healthy(root, "Train")
    n_test = preprocess_healthy(root, "Test")
    n_ano = preprocess_anomalous(root)
    print(f"cached: {n_train} train, {n_test} test, {n_ano} anomalous volumes")


if __name__ == "__main__":
    main()
