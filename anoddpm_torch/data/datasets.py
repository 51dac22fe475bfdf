"""Dataset classes: NFBS healthy MRI, Edinburgh anomalous MRI, MVTec
(leather), DAGM (carpet), CIFAR-10 and the synthetic phantoms, with the
dispatch by args["dataset"].

Own copy of `anoddpm_tpu/data/datasets.py`, numpy only: the images are read
by the port's PNG decoder (`visualize.decode_png`) in place of cv2.imread,
and the DAGM defect ellipse is rasterised by `transforms.fill_ellipse` in
place of cv2.ellipse.  Every dataset returns dict samples with float32 NHWC
arrays in [-1, 1]:
  healthy:    {"image": (H, W, C), "filenames": str}
  anomalous:  {"image": (S, H, W, C), "mask": (S, H, W, C), "slices", ...}
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from .. import visualize as vz
from . import transforms as T
from .nifti import read_nifti
from .synthetic import SyntheticAnomalyDataset, SyntheticMRIDataset

# Per-patient tumour slice ranges of the 22 Edinburgh volumes.
EDINBURGH_SLICES = {
    "17904": (165, 205), "18428": (177, 213), "18582": (160, 190),
    "18638": (160, 212), "18675": (140, 200), "18716": (135, 190),
    "18756": (150, 205), "18863": (130, 190), "18886": (120, 180),
    "18975": (170, 194), "19015": (158, 195), "19085": (155, 195),
    "19275": (184, 213), "19277": (158, 209), "19357": (158, 210),
    "19398": (164, 200), "19423": (142, 200), "19567": (160, 200),
    "19628": (147, 210), "19691": (155, 200), "19723": (140, 170),
    "19849": (150, 180),
}


def read_image(path: str, rgb: bool) -> np.ndarray:
    """An 8-bit PNG as cv2.imread gives it: (H, W) grey, or with `rgb`
    (H, W, 3) in RGB order (cv2.imread(path, 1) then BGR2RGB).  Alpha is
    dropped; grey is repeated to RGB; RGB is made grey with libpng's
    integer weights, (9797 R + 19234 G + 3737 B) >> 15, as OpenCV's
    reader asks libpng to."""
    with open(path, "rb") as f:
        img = vz.decode_png(f.read())
    if img.ndim == 3:
        img = img[..., 0] if img.shape[2] == 2 else img[..., :3]
    if rgb:
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


class MRIDataset:
    """Healthy NFBS T1 volumes -> a coronal slice through the training
    transform.  Volumes are normalised and cached as .npy on first read."""

    def __init__(self, root_dir: str, img_size=(256, 256),
                 random_slice: bool = False, seed: int = 0):
        self.root_dir = root_dir
        self.img_size = tuple(img_size)
        self.random_slice = random_slice
        self.filenames = sorted(
            f for f in os.listdir(root_dir)
            if f != ".DS_Store" and os.path.isdir(os.path.join(root_dir, f)))
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.filenames)

    def _volume(self, name: str) -> np.ndarray:
        cache = os.path.join(self.root_dir, name, f"{name}.npy")
        if os.path.exists(cache):
            return np.load(cache)
        nii = os.path.join(self.root_dir, name, f"sub-{name}_ses-NFB3_T1w.nii.gz")
        volume, _ = read_nifti(nii)
        volume = T.clip_normalise_volume(volume)
        np.save(cache, volume.astype(np.float32))
        return volume.astype(np.float32)

    def __getitem__(self, idx) -> Dict:
        name = self.filenames[idx]
        volume = self._volume(name)
        # a random coronal slice in 40..100, else the fixed slice 80
        slice_idx = int(self._rng.integers(40, 101)) if self.random_slice else 80
        img = volume[:, slice_idx, :].reshape(volume.shape[0],
                                              volume.shape[2]).astype(np.float32)
        img = T.mri_train_transform(img, self.img_size, self._rng)
        return {"image": img, "filenames": name}


class AnomalousMRIDataset:
    """Edinburgh anomalous T1 volumes and tumour masks, from the .npy stacks
    that `preprocess` writes.

    slice_selection: "random" | "iterateKnown" | "iterateKnown_restricted"
    (4 evenly spaced tumour slices) | "iterateUnknown".
    """

    def __init__(self, root_dir: str, img_size=(256, 256),
                 slice_selection: str = "iterateKnown_restricted",
                 cleaned: bool = True, seed: int = 0):
        self.root_dir = root_dir
        self.img_size = tuple(img_size)
        self.slice_selection = slice_selection
        sub = "raw_cleaned" if cleaned else "raw"
        self.names = sorted(EDINBURGH_SLICES.keys())
        self.paths = [os.path.join(root_dir, sub, f"{n}.npy") for n in self.names]
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.names)

    def _mask_volume(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.root_dir, "mask", f"{name}.npy"))

    def _select_slices(self, name: str, n_slices: int) -> np.ndarray:
        lo, hi = EDINBURGH_SLICES[name]
        if self.slice_selection == "random":
            return np.array([int(self._rng.integers(lo, hi + 1))])
        if self.slice_selection == "iterateKnown":
            return np.arange(lo, hi)
        if self.slice_selection == "iterateKnown_restricted":
            return np.linspace(lo + 5, hi - 5, 4).astype(np.int32)
        return np.arange(n_slices)  # iterateUnknown

    def __getitem__(self, idx) -> Dict:
        name = self.names[idx]
        volume = np.load(self.paths[idx])
        mask_volume = self._mask_volume(name)
        slices = self._select_slices(name, volume.shape[0])
        imgs, masks = [], []
        for s in slices:
            img = volume[s].astype(np.float32)
            msk = mask_volume[s].astype(np.float32)
            imgs.append(T.anomalous_transform(img, self.img_size))
            m = T.anomalous_transform(msk, self.img_size)
            masks.append((m > 0).astype(np.float32))
        return {
            "image": np.stack(imgs),
            "mask": np.stack(masks),
            "filenames": self.paths[idx],
            "slices": slices,
        }


def load_image_mask(root_dir: str, name: str, img_size,
                    slice_selection: str = "iterateKnown_restricted"):
    """Image and mask of one named Edinburgh volume, through the anomalous
    transform."""
    ds = AnomalousMRIDataset(root_dir, img_size, slice_selection)
    idx = ds.names.index(str(name))
    return ds[idx]


def _crop_or_resize(img, mask, img_size, random_crop, rng, clamp):
    """A random (th, tw) crop of image and mask at one offset, or both
    resized to img_size (the mask re-thresholded)."""
    h, w = img.shape[:2]
    th, tw = img_size
    if random_crop:
        hi_y, hi_x = (max(h - th, 0), max(w - tw, 0)) if clamp else (h - th, w - tw)
        y = int(rng.integers(0, hi_y + 1))
        x = int(rng.integers(0, hi_x + 1))
        img = img[y:y + th, x:x + tw]
        if mask is not None:
            mask = mask[y:y + th, x:x + tw]
        return img, mask
    img = T.resize_bilinear(img, img_size)
    if mask is not None:
        mask = (T.resize_bilinear(mask, img_size) > 0).astype(np.float32)
    return img, mask


class MVTec:
    """MVTec leather (color/cut/fold/glue/poke[,good]) with ground-truth
    masks."""

    CLASSES = ["color", "cut", "fold", "glue", "poke"]

    def __init__(self, root_dir: str, anomalous: bool = False,
                 img_size=(256, 256), rgb: bool = True,
                 random_crop: bool = True, include_good: bool = False,
                 seed: int = 0):
        self.root_dir = root_dir
        self.anomalous = anomalous
        self.img_size = tuple(img_size)
        self.rgb = rgb
        self.random_crop = random_crop
        self._rng = np.random.default_rng(seed)
        classes = list(self.CLASSES) + (["good"] if include_good else [])
        if anomalous:
            self.filenames = [
                os.path.join(root_dir, "test", c, f)
                for c in classes
                for f in sorted(os.listdir(os.path.join(root_dir, "test", c)))
                if f.endswith(".png")]
        else:
            train_dir = os.path.join(root_dir, "train", "good")
            self.filenames = [os.path.join(train_dir, f)
                              for f in sorted(os.listdir(train_dir))
                              if f.endswith(".png")]

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx) -> Dict:
        path = self.filenames[idx]
        img = read_image(path, self.rgb)
        if not self.rgb:
            img = img[..., None]
        img = img.astype(np.float32) / 255.0

        mask = None
        if self.anomalous:
            cls = os.path.basename(os.path.dirname(path))
            if cls == "good":
                mask = np.zeros(img.shape[:2] + (1,), np.float32)
            else:
                mpath = os.path.join(self.root_dir, "ground_truth", cls,
                                     os.path.basename(path)[:-4] + "_mask.png")
                mask = (read_image(mpath, False) > 0).astype(np.float32)[..., None]

        img, mask = _crop_or_resize(img, mask, self.img_size, self.random_crop,
                                    self._rng, clamp=False)
        if img.ndim == 2:          # a one-channel resize comes back (H, W)
            img = img[..., None]
        if mask is not None and mask.ndim == 2:
            mask = mask[..., None]

        sample = {"image": T.normalize_unit(img), "filenames": path}
        if mask is not None:
            sample["mask"] = mask
        return sample


class DAGM:
    """DAGM carpet (Class1) with elliptical defect masks rasterised from
    labels.txt."""

    def __init__(self, root_dir: str, anomalous: bool = False,
                 img_size=(256, 256), rgb: bool = False,
                 random_crop: bool = True, seed: int = 0):
        if anomalous and not root_dir.endswith("_def"):
            root_dir += "_def"
        self.root_dir = root_dir
        self.anomalous = anomalous
        self.img_size = tuple(img_size)
        self.rgb = rgb
        self.random_crop = random_crop
        self._rng = np.random.default_rng(seed)
        self.filenames = sorted(
            (f for f in os.listdir(root_dir) if f.endswith(".png")),
            key=lambda x: int(x[:-4]))
        if anomalous:
            self.coords = self._load_coordinates(
                os.path.join(root_dir, "labels.txt"))

    @staticmethod
    def _load_coordinates(path):
        coords = {}
        with open(path) as f:
            for line in f.read().split("\n"):
                parts = line.split("\t")
                if len(parts) == 6:
                    idx = int(parts[0]) - 1
                    coords[idx] = {
                        "major_axis": round(float(parts[1])),
                        "minor_axis": round(float(parts[2])),
                        "angle": float(parts[3]),
                        "x": round(float(parts[4])),
                        "y": round(float(parts[5])),
                    }
        return coords

    def _make_mask(self, idx, img):
        """The defect ellipse over the image's shape (every channel), at the
        reference's angle convention (angle / 4.7) * 270 degrees."""
        info = self.coords[idx]
        mask = T.fill_ellipse(img.shape[:2], (info["x"], info["y"]),
                              (info["major_axis"], info["minor_axis"]),
                              (info["angle"] / 4.7) * 270)
        mask = mask.astype(np.float32)
        return np.repeat(mask[..., None], img.shape[2], 2) if img.ndim == 3 else mask

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx) -> Dict:
        path = os.path.join(self.root_dir, self.filenames[idx])
        img = read_image(path, self.rgb)
        mask = None
        if self.anomalous:
            mask = self._make_mask(int(self.filenames[idx][:-4]) - 1, img)
        img = img.astype(np.float32) / 255.0
        img, mask = _crop_or_resize(img, mask, self.img_size, self.random_crop,
                                    self._rng, clamp=True)
        if img.ndim == 2:
            img = img[..., None]
        sample = {"image": T.normalize_unit(img), "filenames": self.filenames[idx]}
        if mask is not None:
            if mask.ndim == 2:
                mask = mask[..., None]
            sample["mask"] = mask[..., :1]
        return sample


class CIFAR10:
    """CIFAR-10 from the standard python pickle batches on local disk (the
    files this program writes or the published ones, nothing else: reading
    them unpickles)."""

    def __init__(self, root_dir: str, train: bool = True):
        base = os.path.join(root_dir, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        images, labels = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"])
            labels.extend(d[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.images = (data.transpose(0, 2, 3, 1).astype(np.float32) / 255.0 - 0.5) / 0.5
        self.labels = np.asarray(labels)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return {"image": self.images[idx], "label": int(self.labels[idx]),
                "filenames": f"cifar-{idx}"}


def init_datasets(root_dir: str, args) -> Tuple[object, object]:
    """The healthy-MRI Train/Test pair under root_dir/DATASETS."""
    train = MRIDataset(os.path.join(root_dir, "DATASETS", "Train"),
                       img_size=args["img_size"],
                       random_slice=args["random_slice"])
    test = MRIDataset(os.path.join(root_dir, "DATASETS", "Test"),
                      img_size=args["img_size"],
                      random_slice=args["random_slice"])
    return train, test


def _name(args) -> str:
    return str(args.get("dataset", "") or "synthetic").lower()


def dataset_from_args(root_dir: str, args, train: bool = True):
    """The healthy training or test set named by args["dataset"]: the
    synthetic phantoms (seed 0 or 1), or files under root_dir/DATASETS."""
    name = _name(args)
    img_size = args["img_size"]
    if name in ("synthetic", ""):
        return SyntheticMRIDataset(img_size=img_size, seed=0 if train else 1)
    if name == "mri":
        sub = "Train" if train else "Test"
        return MRIDataset(os.path.join(root_dir, "DATASETS", sub),
                          img_size=img_size,
                          random_slice=bool(args.get("random_slice", True)))
    if name == "leather":
        return MVTec(os.path.join(root_dir, "DATASETS", "leather"),
                     anomalous=not train, img_size=img_size, rgb=True)
    if name == "carpet":
        return DAGM(os.path.join(root_dir, "DATASETS", "CARPET", "Class1"),
                    anomalous=not train, img_size=img_size)
    if name == "cifar":
        return CIFAR10(os.path.join(root_dir, "DATASETS", "CIFAR10"), train=train)
    raise ValueError(f"unknown dataset: {name}")


def anomalous_dataset_from_args(root_dir: str, args):
    """The anomalous evaluation set named by args["dataset"]: synthetic
    lesions (args lesion_kind, lesion_severity, anomalous_volumes), DAGM
    carpet, MVTec leather, or else the Edinburgh volumes under
    root_dir/DATASETS."""
    name = _name(args)
    if name in ("synthetic", ""):
        kind = str(args.get("lesion_kind") or "bump")
        severity = float(args.get("lesion_severity") or 1.0)
        vols = args.get("anomalous_volumes")
        length = 22 if vols is None or vols == "" else int(vols)
        if length <= 0:
            raise ValueError(f"anomalous_volumes must be > 0, got {vols!r}")
        return SyntheticAnomalyDataset(img_size=args["img_size"], length=length,
                                       lesion_kind=kind, lesion_severity=severity)
    if name == "carpet":
        return DAGM(os.path.join(root_dir, "DATASETS", "CARPET", "Class1"),
                    anomalous=True, img_size=args["img_size"])
    if name == "leather":
        return MVTec(os.path.join(root_dir, "DATASETS", "leather"),
                     anomalous=True, img_size=args["img_size"], rgb=True)
    return AnomalousMRIDataset(
        os.path.join(root_dir, "DATASETS", "CancerousDataset",
                     "EdinburghDataset", "Anomalous-T1"),
        img_size=args["img_size"], slice_selection="iterateKnown_restricted")
