"""The port's real-data modules against the JAX package on fixture files:
the NIfTI reader, the cv2-free transforms (resize, affine warp, filled
ellipse), the PNG reader, the MRI, MVTec, DAGM and CIFAR-10 datasets,
preprocess, inspect, and the "mri" configuration through one training step
and one detection group.

Tolerances: resize within 1e-5 (OpenCV sums in another order, a few fp32
ulps); the affine warp within 1e-5 and equal on >= 99.9% of the pixels
(the port repeats OpenCV 5's arithmetic, fused multiply-adds included);
the DAGM ellipse mask within IoU 0.98 of cv2.ellipse's (the port redraws
OpenCV's polygon, fill and outline; a few boundary pixels differ)."""
import gzip
import json
import os
import pickle
import shutil
import struct

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anoddpm_tpu import detect as jdetect
from anoddpm_tpu import training as jtr
from anoddpm_tpu.config import defaultdict_from_json
from anoddpm_tpu.data import datasets as jds
from anoddpm_tpu.data import inspect as jinspect
from anoddpm_tpu.data import nifti as jnifti
from anoddpm_tpu.data import pipeline as jpipe
from anoddpm_tpu.data import preprocess as jprep
from anoddpm_tpu.data import transforms as jT
from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_torch import detect as tdetect
from anoddpm_torch import schedule as ts
from anoddpm_torch import train as ttrain
from anoddpm_torch import training as ttr
from anoddpm_torch import visualize as tvz
from anoddpm_torch.compat.flax_params import unet_state_dict_from_flax
from anoddpm_torch.data import datasets as tds
from anoddpm_torch.data import inspect as tinspect
from anoddpm_torch.data import nifti as tnifti
from anoddpm_torch.data import preprocess as tprep
from anoddpm_torch.data import transforms as tT
from anoddpm_torch.data.synthetic import _lesion, _phantom
from anoddpm_torch.models.unet import UNet
from torch_parity import CONFIGS, T, bank_samplers

RESIZE_TOL = 1e-5
AFFINE_TOL, AFFINE_EQUAL = 1e-5, 0.999
ELLIPSE_IOU = 0.98

_NIFTI_CODES = {np.dtype(v).name: k for k, v in jnifti._DTYPES.items()}


def write_nifti(path, data, dtype=np.float32, endian="<", slope=1.0, inter=0.0):
    """A single-file NIfTI-1 image of `data` as `dtype` in byte order
    `endian`, gzipped for a .gz path."""
    data = np.asarray(data)
    dt = np.dtype(dtype).newbyteorder(endian)
    hdr = bytearray(352)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "8h", hdr, 40,
                     *((data.ndim,) + data.shape + (1,) * (7 - data.ndim)))
    struct.pack_into(endian + "h", hdr, 70, _NIFTI_CODES[np.dtype(dtype).name])
    struct.pack_into(endian + "h", hdr, 72, dt.itemsize * 8)
    struct.pack_into(endian + "f", hdr, 108, 352.0)
    struct.pack_into(endian + "f", hdr, 112, slope)
    struct.pack_into(endian + "f", hdr, 116, inter)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.astype(dt).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


# --- NIfTI ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.dtype(v).name for v in jnifti._DTYPES.values()])
@pytest.mark.parametrize("endian,suffix,slope", [("<", ".nii.gz", 1.0),
                                                 (">", ".nii", 0.5)])
def test_read_nifti_matches_jax(tmp_path, dtype, endian, suffix, slope):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 100, size=(5, 7, 3)).astype(dtype)
    path = str(tmp_path / f"v{suffix}")
    write_nifti(path, data, dtype, endian, slope=slope, inter=3.0)
    got, ghdr = tnifti.read_nifti(path)
    want, whdr = jnifti.read_nifti(path)
    assert ghdr == whdr and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    expect = data * slope + 3.0 if slope != 1.0 else data
    np.testing.assert_array_equal(got, expect.astype(np.float64))


# --- transforms ---------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [((235, 235), 256), ((175, 240), 256),
                                        ((256, 256), 128), ((256, 256), 64),
                                        ((300, 300, 3), (256, 256)),
                                        ((40, 30, 1), (16, 24))])
def test_resize_bilinear_matches_cv2(shape, size):
    img = np.random.default_rng(1).uniform(-1, 2, size=shape).astype(np.float32)
    want = jT.resize_bilinear(img, size)
    got = tT.resize_bilinear(img, size)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_random_affine_matches_jax(seed):
    img = np.random.default_rng(10 + seed).uniform(0, 1, size=(256, 192)).astype(np.float32)
    want = jT.random_affine(img, np.random.default_rng(seed))
    got = tT.random_affine(img, np.random.default_rng(seed))
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= AFFINE_TOL
    assert (got == want).mean() >= AFFINE_EQUAL


def test_rotation_matrix_matches_cv2():
    for angle in (-2.9, 0.0, 1.3, 45.0):
        np.testing.assert_allclose(tT.rotation_matrix((96, 128), angle),
                                   cv2.getRotationMatrix2D((96, 128), angle, 1.0),
                                   rtol=0, atol=1e-12)


def test_train_and_anomalous_transforms_match_jax():
    img = np.random.default_rng(2).uniform(0, 1, size=(256, 192)).astype(np.float32)
    got = tT.mri_train_transform(img, (64, 64), np.random.default_rng(3))
    want = jT.mri_train_transform(img, (64, 64), np.random.default_rng(3))
    np.testing.assert_allclose(got, want, atol=2 * RESIZE_TOL, rtol=0)
    np.testing.assert_allclose(tT.anomalous_transform(img, (32, 32)),
                               jT.anomalous_transform(img, (32, 32)),
                               atol=2 * RESIZE_TOL, rtol=0)
    vol = np.random.default_rng(4).normal(100, 20, size=(6, 7, 8))
    np.testing.assert_array_equal(tT.clip_normalise_volume(vol),
                                  jT.clip_normalise_volume(vol))
    for size in (8, (9, 5), (3, 20)):
        np.testing.assert_array_equal(tT.center_crop(img[:7, :6], size),
                                      jT.center_crop(img[:7, :6], size))


def _iou(a, b):
    a, b = a > 0, b > 0
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


def test_fill_ellipse_matches_cv2():
    """At DAGM's angle convention, axes and image size: each mask within
    IoU 0.98 of cv2.ellipse's, and 0.999 on average."""
    rng = np.random.default_rng(0)
    ious = []
    for _ in range(60):
        center = (int(rng.integers(0, 512)), int(rng.integers(0, 512)))
        axes = (int(rng.integers(0, 120)), int(rng.integers(0, 120)))
        angle = rng.uniform(0, 4.7) / 4.7 * 270
        want = cv2.ellipse(np.zeros((512, 512), np.uint8), center, axes, angle,
                           0, 360, 255, -1)
        got = tT.fill_ellipse((512, 512), center, axes, angle)
        ious.append(_iou(got, want))
    assert min(ious) >= ELLIPSE_IOU and np.mean(ious) >= 0.999


# --- PNG ----------------------------------------------------------------------

def test_png_reader_matches_cv2_imread(tmp_path):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:80]
    smooth = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128).astype(np.uint8)
    images = {"grey": smooth, "noise": rng.integers(0, 256, (33, 47), dtype=np.uint8),
              "bgr": np.stack([smooth, smooth[::-1],
                               rng.integers(0, 256, (64, 80), dtype=np.uint8)], -1),
              "bgra": rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)}
    for name, img in images.items():
        path = str(tmp_path / f"{name}.png")
        cv2.imwrite(path, img)
        want_rgb = cv2.cvtColor(cv2.imread(path, 1), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(tds.read_image(path, True), want_rgb)
        np.testing.assert_array_equal(tds.read_image(path, False), cv2.imread(path, 0))


@pytest.mark.parametrize("shape", [(17, 23), (9, 31, 3)])
def test_png_reader_reads_the_port_encoder(shape):
    img = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(tvz.decode_png(tvz.encode_png(img, "t")), img)


def test_png_reader_refuses_other_formats(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        tds.read_image(path, False)
    with pytest.raises(ValueError, match="not a PNG"):
        tvz.decode_png(b"GIF89a")


# --- MRI datasets -------------------------------------------------------------

NFBS_SHAPE = (60, 104, 50)       # cut from NFBS's 256 x 256 x 192
EDINBURGH_SHAPE = (220, 30, 40)  # slices on axis 0, as preprocess leaves them


def _write_nfbs(root, names, seed):
    rng = np.random.default_rng(seed)
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d)
        vol = rng.uniform(0, 800, size=NFBS_SHAPE).astype(np.float32)
        write_nifti(os.path.join(d, f"sub-{name}_ses-NFB3_T1w.nii.gz"), vol)


@pytest.fixture(scope="module")
def nfbs_pair(tmp_path_factory):
    """Two copies of one NFBS tree (each package writes its .npy cache)."""
    base = tmp_path_factory.mktemp("nfbs")
    _write_nfbs(str(base / "a"), ("A00001", "A00002"), 0)
    shutil.copytree(base / "a", base / "b")
    return str(base / "a"), str(base / "b")


@pytest.mark.parametrize("random_slice", [True, False])
def test_mri_dataset_matches_jax(nfbs_pair, random_slice):
    want_ds = jds.MRIDataset(nfbs_pair[0], (32, 32), random_slice, seed=2)
    got_ds = tds.MRIDataset(nfbs_pair[1], (32, 32), random_slice, seed=2)
    assert got_ds.filenames == want_ds.filenames
    for idx in (0, 1, 0):   # the third reads the cache, on the rng's third draw
        got, want = got_ds[idx], want_ds[idx]
        assert got["filenames"] == want["filenames"]
        assert got["image"].shape == (32, 32, 1)
        np.testing.assert_allclose(got["image"], want["image"],
                                   atol=2 * RESIZE_TOL, rtol=0)
    for name in got_ds.filenames:
        np.testing.assert_array_equal(
            np.load(os.path.join(nfbs_pair[1], name, f"{name}.npy")),
            np.load(os.path.join(nfbs_pair[0], name, f"{name}.npy")))


@pytest.fixture(scope="module")
def edinburgh_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("edinburgh")
    os.makedirs(root / "raw_cleaned")
    os.makedirs(root / "mask")
    rng = np.random.default_rng(1)
    for name in ("17904", "18582", "19849"):
        vol = rng.uniform(0, 1, size=EDINBURGH_SHAPE).astype(np.float32)
        mask = (rng.uniform(size=EDINBURGH_SHAPE) > 0.95).astype(np.float32)
        np.save(root / "raw_cleaned" / f"{name}.npy", vol)
        np.save(root / "mask" / f"{name}.npy", mask)
    return str(root)


def _same_anomalous(got, want):
    np.testing.assert_array_equal(got["slices"], want["slices"])
    assert got["filenames"] == want["filenames"]
    assert got["image"].shape == want["image"].shape
    np.testing.assert_allclose(got["image"], want["image"], atol=2 * RESIZE_TOL,
                               rtol=0)
    np.testing.assert_array_equal(got["mask"], want["mask"])


@pytest.mark.parametrize("mode", ["random", "iterateKnown",
                                  "iterateKnown_restricted", "iterateUnknown"])
def test_anomalous_mri_dataset_matches_jax(edinburgh_root, mode):
    got_ds = tds.AnomalousMRIDataset(edinburgh_root, (24, 24), mode, seed=3)
    want_ds = jds.AnomalousMRIDataset(edinburgh_root, (24, 24), mode, seed=3)
    assert len(got_ds) == len(want_ds) == 22
    assert got_ds.names == want_ds.names
    for idx in (0, got_ds.names.index("19849"), 0):
        _same_anomalous(got_ds[idx], want_ds[idx])


def test_load_image_mask_and_init_datasets_match_jax(edinburgh_root, nfbs_pair):
    _same_anomalous(tds.load_image_mask(edinburgh_root, "18582", (32, 32)),
                    jds.load_image_mask(edinburgh_root, "18582", (32, 32)))
    root = os.path.dirname(nfbs_pair[0])
    os.makedirs(os.path.join(root, "DATASETS"), exist_ok=True)
    for sub in ("Train", "Test"):
        link = os.path.join(root, "DATASETS", sub)
        if not os.path.exists(link):
            os.symlink(nfbs_pair[0], link)
    args = {"img_size": (16, 16), "random_slice": False}
    got, want = tds.init_datasets(root, args), jds.init_datasets(root, args)
    for g, w in zip(got, want):
        assert g.root_dir == w.root_dir and g.filenames == w.filenames
        np.testing.assert_allclose(g[1]["image"], w[1]["image"],
                                   atol=2 * RESIZE_TOL, rtol=0)


def _write_datasets_tree(root, seed=0):
    """DATASETS/ as `preprocess` reads it: NFBS Train (2) and Test (1)
    volumes, and one Edinburgh raw volume with its mask, made of smooth
    phantoms and an ellipsoid lesion, slice by slice."""
    rng = np.random.default_rng(seed)
    for sub, names in (("Train", ("A00001", "A00002")), ("Test", ("A00003",))):
        base = os.path.join(root, "Train" if sub == "Train" else "Test")
        os.makedirs(base, exist_ok=True)
        for name in names:
            d = os.path.join(base, name)
            os.makedirs(d)
            vol = np.stack([_phantom(rng, (NFBS_SHAPE[0], NFBS_SHAPE[2]))
                            for _ in range(NFBS_SHAPE[1])], axis=1) * 700
            write_nifti(os.path.join(d, f"sub-{name}_ses-NFB3_T1w.nii.gz"),
                        vol.astype(np.int16), np.int16)
    ano = os.path.join(root, "CancerousDataset", "EdinburghDataset", "Anomalous-T1")
    os.makedirs(os.path.join(ano, "raw"))
    os.makedirs(os.path.join(ano, "mask_raw"))
    # rot90 turns (120, 210, 160) into 210 slices of 120 x 160
    bump, mask = _lesion(rng, (120, 160))
    vol = np.stack([_phantom(rng, (120, 160)) + 0.4 * bump for _ in range(210)], 1)
    write_nifti(os.path.join(ano, "raw", "17904.nii.gz"), vol * 500)
    write_nifti(os.path.join(ano, "mask_raw", "17904.nii.gz"),
                np.repeat(mask[:, None, :], 210, axis=1), np.uint8)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_preprocess_matches_jax(tmp_path, capsys):
    _write_datasets_tree(str(tmp_path / "a"))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    jprep.main([str(tmp_path / "a")])
    tprep.main([str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert out.count("cached: 2 train, 1 test, 1 anomalous volumes") == 2
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    for rel in _files(tmp_path / "a"):
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "b" / rel),
                                          np.load(tmp_path / "a" / rel))
    assert jprep.export_anogan_pngs(str(tmp_path / "a")) == 4
    assert tprep.export_anogan_pngs(str(tmp_path / "b")) == 4
    pngs = [f for f in _files(tmp_path / "a") if f.endswith(".png")]
    assert len(pngs) == 8 and pngs == [f for f in _files(tmp_path / "b")
                                       if f.endswith(".png")]
    for rel in pngs:
        want = cv2.imread(str(tmp_path / "a" / rel), 0).astype(int)
        got = cv2.imread(str(tmp_path / "b" / rel), 0).astype(int)
        assert got.shape == (64, 64) and np.abs(got - want).max() <= 1
        assert (got == want).mean() >= 0.99


# --- MVTec, DAGM, CIFAR-10 ----------------------------------------------------

@pytest.fixture(scope="module")
def mvtec_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("leather"))
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "train", "good"))
    for i in range(2):
        img = rng.integers(0, 255, size=(80, 90, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(root, "train", "good", f"{i:03d}.png"), img)
    for cls in tds.MVTec.CLASSES + ["good"]:
        os.makedirs(os.path.join(root, "test", cls))
        os.makedirs(os.path.join(root, "ground_truth", cls))
        img = rng.integers(0, 255, size=(80, 90, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(root, "test", cls, "000.png"), img)
        mask = np.zeros((80, 90), np.uint8)
        mask[20:45, 30:70] = 255
        cv2.imwrite(os.path.join(root, "ground_truth", cls, "000_mask.png"), mask)
    return root


@pytest.mark.parametrize("anomalous,rgb,crop", [(False, True, True),
                                                (True, True, True),
                                                (True, False, False),
                                                (True, True, False)])
def test_mvtec_matches_jax(mvtec_root, anomalous, rgb, crop):
    kw = dict(anomalous=anomalous, img_size=(32, 48), rgb=rgb, random_crop=crop,
              include_good=True, seed=4)
    got_ds, want_ds = tds.MVTec(mvtec_root, **kw), jds.MVTec(mvtec_root, **kw)
    assert got_ds.filenames == want_ds.filenames
    for idx in list(range(len(got_ds))) + [0]:
        got, want = got_ds[idx], want_ds[idx]
        assert got.keys() == want.keys() and got["filenames"] == want["filenames"]
        if crop:
            np.testing.assert_array_equal(got["image"], want["image"])
        else:
            np.testing.assert_allclose(got["image"], want["image"],
                                       atol=2 * RESIZE_TOL, rtol=0)
        if anomalous:
            np.testing.assert_array_equal(got["mask"], want["mask"])


@pytest.fixture(scope="module")
def dagm_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("carpet"))
    d = os.path.join(root, "Class1_def")
    os.makedirs(d)
    rng = np.random.default_rng(1)
    lines = []
    for i in range(1, 5):
        img = rng.integers(0, 255, size=(128, 128), dtype=np.uint8)
        cv2.imwrite(os.path.join(d, f"{i}.png"), img)
        lines.append(f"{i}\t{rng.uniform(5, 40):.3f}\t{rng.uniform(3, 20):.3f}\t"
                     f"{rng.uniform(0, 4.7):.4f}\t{rng.uniform(30, 98):.2f}\t"
                     f"{rng.uniform(30, 98):.2f}")
    with open(os.path.join(d, "labels.txt"), "w") as f:
        f.write("\n".join(lines))
    return os.path.join(root, "Class1")


@pytest.mark.parametrize("crop", [True, False])
def test_dagm_matches_jax(dagm_root, crop):
    kw = dict(anomalous=True, img_size=(64, 64), random_crop=crop, seed=2)
    got_ds, want_ds = tds.DAGM(dagm_root, **kw), jds.DAGM(dagm_root, **kw)
    assert got_ds.filenames == want_ds.filenames and got_ds.coords == want_ds.coords
    for idx in range(len(got_ds)):
        got, want = got_ds[idx], want_ds[idx]
        assert got["filenames"] == want["filenames"]
        assert got["image"].shape == want["image"].shape == (64, 64, 1)
        if crop:
            np.testing.assert_array_equal(got["image"], want["image"])
        else:
            np.testing.assert_allclose(got["image"], want["image"],
                                       atol=2 * RESIZE_TOL, rtol=0)
        assert got["mask"].shape == want["mask"].shape
        img = cv2.imread(os.path.join(got_ds.root_dir, got_ds.filenames[idx]), 0)
        full = (got_ds._make_mask(idx, img), want_ds._make_mask(idx, img))
        assert full[1].sum() > 0 and _iou(*full) >= ELLIPSE_IOU


def test_cifar10_matches_jax(tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    os.makedirs(base)
    rng = np.random.default_rng(3)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 4))}, f)
    for train in (True, False):
        got, want = tds.CIFAR10(str(tmp_path), train), jds.CIFAR10(str(tmp_path), train)
        assert len(got) == len(want) == (20 if train else 4)
        for i in (0, len(got) - 1):
            g, w = got[i], want[i]
            np.testing.assert_array_equal(g["image"], w["image"])
            assert (g["label"], g["filenames"]) == (w["label"], w["filenames"])


def test_dispatch_matches_jax(mvtec_root, dagm_root, tmp_path):
    """Every family name builds the same class over the same files."""
    os.makedirs(tmp_path / "DATASETS" / "CARPET")
    os.symlink(mvtec_root, tmp_path / "DATASETS" / "leather")
    os.symlink(dagm_root + "_def", tmp_path / "DATASETS" / "CARPET" / "Class1_def")
    os.makedirs(tmp_path / "DATASETS" / "CARPET" / "Class1")
    root = str(tmp_path)
    for name in ("leather", "carpet", "mri", "synthetic"):
        args = defaultdict_from_json({"img_size": (32, 32), "dataset": name,
                                      "anomalous_volumes": 2})
        got = tds.anomalous_dataset_from_args(root, args)
        want = jds.anomalous_dataset_from_args(root, args)
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
    args = defaultdict_from_json({"img_size": (32, 32), "dataset": "leather"})
    assert tds.dataset_from_args(root, args).filenames == \
        jds.dataset_from_args(root, args).filenames
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.dataset_from_args(root, defaultdict_from_json({"img_size": (8, 8),
                                                           "dataset": "nope"}))


# --- inspect ------------------------------------------------------------------

def test_inspect_writes_the_jax_file_names(tmp_path, capsys):
    args = defaultdict_from_json({"img_size": (16, 16), "dataset": "synthetic",
                                  "arg_num": "insp", "anomalous_volumes": 2})
    for pkg, sub in ((jinspect, "a"), (tinspect, "b")):
        pkg.inspect(args, root_dir=str(tmp_path / sub), mode="all", max_volumes=2)
    got, want = _files(tmp_path / "b"), _files(tmp_path / "a")
    assert got == want and "inspection-outputs/ARGS=insp/sheet-4.png" in got
    sheet = tds.read_image(str(tmp_path / "b" / got[-1]), False)
    assert sheet.shape == (4 * 16 + 10, 5 * 16 + 12)  # 4 rows of 5, padded


# --- the "mri" configuration end to end ----------------------------------------

MRI_ARGS = {"arg_num": "mri32", "img_size": [32, 32], "Batch_Size": 2,
            "EPOCHS": 0, "iters_per_epoch": 1, "T": T, "base_channels": 32,
            "channel_mults": [1, 2], "attention_resolutions": "16",
            "beta_schedule": "cosine", "loss-type": "l2", "lr": 1e-4,
            "sample_distance": 12, "train_start": True, "random_slice": True,
            "noise_fn": "simplex", "dataset": "mri", "compute_dtype": "float32",
            "skip_test_eval": True, "seed": 0}


def test_mri_config_train_step_and_detection_match_jax(tmp_path, monkeypatch):
    """`train.train` on the "mri" dispatch for one step, then
    `anomalous_metric_calculation` on one Edinburgh volume group from its
    checkpoint, against the JAX package on the same batch, parameters, t
    and noise bank: the step's loss at rtol 1e-5, the parameters after it
    within Adam's first-step tolerance, the detection metrics at the chain
    tolerance of test_torch_detect (AUC 1e-3, the others 1e-2)."""
    from test_torch_train import assert_update_matches, jax_t, params_of, torch_tree
    from anoddpm_torch.config import defaultdict_from_json as tdefault
    from torch_parity import flax_and_port
    _write_datasets_tree(str(tmp_path / "DATASETS"))
    tprep.main([str(tmp_path / "DATASETS")])
    args = tdefault(dict(MRI_ARGS))

    # the JAX side: its first batch of the same dataset, one step from
    # perturbed flax parameters
    fmodel, params, _ = flax_and_port(CONFIGS["s2d1"])
    jsched = make_schedule(get_beta_schedule(T, "cosine"))
    jsamp, tsamp = bank_samplers((2, 32, 32, 1))
    tx = jtr.make_optimizer(1e-4, 0.0, 1.0)
    step = jax.jit(jtr.make_train_step(fmodel, jsched, tx, jsamp, "l2", max_t=12))
    key = jax.random.key(7)
    jset = jds.dataset_from_args(str(tmp_path), defaultdict_from_json(dict(MRI_ARGS)))
    x = next(jpipe.batch_iterator(jset, 2, shuffle=True))["image"]
    state0 = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            ema_params=params, opt_state=tx.init(params))
    state1, metrics = step(state0, jnp.asarray(x), key)

    # the port: train.train with the same start, t and noise
    t0 = jax_t(key, 0)
    seen = {}

    def new_state(a, device):
        model = UNet(**CONFIGS["s2d1"])
        model.load_state_dict(unet_state_dict_from_flax(params))
        seen["before"] = params_of(model)
        return ttr.init_train_state(model, ttr.make_optimizer(model.parameters(), 1e-4))

    real_step = ttr.make_train_step

    def make_step(*a, **k):
        inner = real_step(*a, **k)

        def one(state, batch, generator, t=None):
            seen["x"] = batch.numpy().transpose(0, 2, 3, 1)
            return inner(state, batch, generator,
                         t=torch.from_numpy(t0.astype(np.int64)))
        return one

    monkeypatch.setattr(ttrain, "new_train_state", new_state)
    monkeypatch.setattr(ttrain, "make_train_step", make_step)
    monkeypatch.setattr(ttrain, "sampler_from_args", lambda a: tsamp)
    state = ttrain.train(args, root_dir=str(tmp_path), device="cpu")
    assert state.step == 1
    np.testing.assert_allclose(seen["x"], x, atol=2 * RESIZE_TOL, rtol=0)
    with open(tmp_path / "metrics" / "argsmri32-train.jsonl") as f:
        loss = json.loads(f.readline())["loss"]
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)

    def grads_fn(p):
        from anoddpm_tpu import diffusion as jd
        per, _ = jd.calc_loss(lambda a, b: fmodel.apply(p, a, b), jsched,
                              jnp.asarray(x), jnp.asarray(t0),
                              jax.random.key(0), jsamp)
        return jnp.mean(per)
    grads = torch_tree(jax.jit(jax.grad(grads_fn))(params))
    assert_update_matches(seen["before"], params_of(state.model),
                          torch_tree(params), torch_tree(state1.params), grads)

    # detection from the port's checkpoint on the preprocessed volume
    jano = jds.anomalous_dataset_from_args(str(tmp_path), defaultdict_from_json(dict(MRI_ARGS)))
    sample = jano[0]
    assert sample["image"].shape == (4, 32, 32, 1) and sample["mask"].sum() > 0
    jdet, tdet = bank_samplers(sample["image"].shape)
    want, _ = jdetect.evaluate_anomaly_batch(
        jtr.EvalModel(fmodel, state1.ema_params), jsched, sample["image"],
        sample["mask"], jax.random.key(0), jdet, t_distance=T)
    monkeypatch.setattr(tdetect, "sampler_from_args", lambda a: tdet)
    summary = tdetect.anomalous_metric_calculation(
        token="mri32", root_dir=str(tmp_path), max_volumes=1, device="cpu")
    np.testing.assert_allclose(summary["auc"], np.mean(want["auc"]), atol=1e-3)
    for k in ("dice", "ssim", "iou", "precision", "recall", "fpr"):
        np.testing.assert_allclose(summary[k], np.mean(want[k]), atol=1e-2, err_msg=k)
    assert os.path.exists(tmp_path / "metrics" / "argsmri32.csv")
