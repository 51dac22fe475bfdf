"""The port's scalar metrics, image grids, PNG encoder, videos and CSV
post-processing against the JAX package: the metrics on the same arrays
within 1e-12, `gridify_output` exactly, a PNG the port writes decoded with
`zlib` back to its grid, the rolling statistics and the ROC CSV against
the pandas versions within 1e-12."""
import csv
import struct
import zlib

import numpy as np
import pytest

from anoddpm_tpu import graphs as jgraphs
from anoddpm_tpu import metrics as jm
from anoddpm_tpu import visualize as jvz
from anoddpm_torch import graphs as tgraphs
from anoddpm_torch import metrics as tm
from anoddpm_torch import visualize as tvz


def arrays(seed=0, shape=(3, 16, 16, 1)):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, shape)
    recon = real + rng.normal(0, 0.6, shape)
    mask = (rng.random(shape) > 0.8).astype(np.float32)
    return real, recon, mask


SCALARS = ["dice_coeff", "iou", "precision", "recall", "fpr", "recall_correct",
           "fpr_correct"]


@pytest.mark.parametrize("name", SCALARS)
@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_metrics_equal_jax(name, seed):
    real, recon, mask = arrays(seed)
    pred = (tm.square_error(real, recon) > 0.5).astype(np.float32)
    if name == "dice_coeff":
        for r, c, m in ((real, recon, mask), (real[0], recon[0], mask[0])):
            assert abs(tm.dice_coeff(r, c, m) - jm.dice_coeff(r, c, m)) <= 1e-12
        assert abs(tm.dice_coeff(real, recon, mask, mse=pred)
                   - jm.dice_coeff(real, recon, mask, mse=pred)) <= 1e-12
    else:
        got, want = getattr(tm, name)(mask, pred), getattr(jm, name)(mask, pred)
        assert abs(got - want) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_curve_auc_and_ssim_equal_jax(seed):
    real, recon, mask = arrays(seed)
    scores = (real - recon) ** 2
    if seed == 2:                       # ties in the scores
        scores = np.round(scores, 1)
    got, want = tm.roc_curve(mask, scores), jm.roc_curve(mask, scores)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)
    assert abs(tm.auc(got[0], got[1]) - jm.auc(want[0], want[1])) <= 1e-12
    assert abs(tm.roc_auc_score(mask, scores) - jm.roc_auc_score(mask, scores)) <= 1e-12
    assert abs(tm.ssim(real[0, ..., 0], recon[0, ..., 0])
               - jm.ssim(real[0, ..., 0], recon[0, ..., 0])) <= 1e-12
    assert abs(tm.ssim(real[0], recon[0], channel_axis=-1)
               - jm.ssim(real[0], recon[0], channel_axis=-1)) <= 1e-12


@pytest.mark.parametrize("n,row,c", [(1, -1, 1), (7, 3, 1), (5, 8, 3), (4, 2, 3)])
def test_gridify_output_equals_jax(n, row, c):
    images = np.random.default_rng(n).uniform(-1.2, 1.2, (n, 9, 11, c))
    got = tvz.gridify_output(images, row)
    np.testing.assert_array_equal(got, jvz.gridify_output(images, row))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(tvz.to_uint8(images), jvz.to_uint8(images))


def read_png(path):
    """(pixels, tEXt chunks) of an 8-bit grey or RGB PNG with unfiltered
    rows."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, text, header = 8, b"", {}, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\x00")
            text[key.decode()] = value.decode("latin-1")
        pos += 12 + length
    w, h, depth, color = header[:4]
    channels = {0: 1, 2: 3}[color]
    assert depth == 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    assert (raw[:, 0] == 0).all()
    pixels = raw[:, 1:].reshape(h, w, channels)
    return (pixels[..., 0] if channels == 1 else pixels), text


@pytest.mark.parametrize("c", [1, 3])
def test_png_decodes_to_the_grid(tmp_path, c):
    images = np.random.default_rng(c).uniform(-1, 1, (6, 10, 12, c))
    path = tmp_path / "sub" / "grid.png"
    tvz.save_grid_png(str(path), images, row_size=4, title="real,sample-3epoch")
    pixels, text = read_png(path)
    np.testing.assert_array_equal(pixels, tvz.gridify_output(images, 4))
    assert text == {"Title": "real,sample-3epoch"}
    with pytest.raises(ValueError):
        tvz.encode_png(np.zeros((4, 4, 2), np.uint8))


def test_snapshots_and_heatmap_write_their_panels(tmp_path):
    real, recon, mask = arrays(3, (2, 8, 8, 1))
    tvz.heatmap_figure(real, recon, mask, str(tmp_path / "h.png"))
    pixels, _ = read_png(tmp_path / "h.png")
    want = jvz.gridify_output(np.concatenate(
        [real, recon, (recon - real) ** 2 * 2 - 1,
         ((((recon - real) ** 2 * 2 - 1) > 0) * 2.0 - 1), mask]), 5)
    np.testing.assert_array_equal(pixels, want)
    tvz.training_snapshot(str(tmp_path / "t.png"), real, recon, recon, 7)
    tvz.sample_snapshot(str(tmp_path / "s.png"), real, recon, real, 8)
    assert read_png(tmp_path / "t.png")[1]["Title"].endswith("mse-7epoch")
    assert read_png(tmp_path / "s.png")[0].shape == jvz.gridify_output(
        np.concatenate([real, recon, real]), 8).shape


def test_save_video_writes_the_same_file_as_jax(tmp_path):
    """The same frames give the same file name (mp4, or the GIF fallback
    where imageio has no mp4 writer) and, for a GIF, the same frames."""
    import imageio
    frames = list(np.random.default_rng(4).uniform(-1, 1, (3, 2, 8, 8, 1)))
    got = tvz.save_video(str(tmp_path / "port" / "v.mp4"), frames, row_size=2)
    want = jvz.save_video(str(tmp_path / "jax" / "v.mp4"), frames, row_size=2)
    assert got.rsplit("/", 1)[1] == want.rsplit("/", 1)[1]
    if got.endswith(".gif"):
        a, b = imageio.mimread(got), imageio.mimread(want)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def read_table(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(c) if c else np.nan for c in r] for r in rows[1:]]


@pytest.mark.parametrize("window", [1, 3, 8])
def test_rolling_mean_std_equals_pandas(tmp_path, window):
    rng = np.random.default_rng(window)
    rows = [[f"{t:04}", *(f"{v:.4f}" for v in rng.random(3)), "vol"]
            for t in range(0, 500, 25)]
    rows[4][2] = ""                       # a missing value
    write_csv(tmp_path / "in.csv", ["timestep", "Dice", "SSIM", "IOU", "name"], rows)
    tgraphs.rolling_mean_std(str(tmp_path / "in.csv"), window,
                             str(tmp_path / "port.csv"))
    jgraphs.rolling_mean_std(str(tmp_path / "in.csv"), window,
                             str(tmp_path / "jax.csv"))
    gh, got = read_table(tmp_path / "port.csv")
    wh, want = read_table(tmp_path / "jax.csv")
    assert gh == wh
    np.testing.assert_allclose(np.array(got), np.array(want), atol=1e-12, rtol=0)


def test_make_roc_csv_equals_pandas(tmp_path):
    rng = np.random.default_rng(9)
    curves = {}
    for name, n in (("a", 900), ("b", 50)):
        f, t, _ = tm.roc_curve(rng.random(n) > 0.7, rng.random(n))
        curves[name] = (f, t)
    assert len(tgraphs.reduce_quality(*curves["a"])[0]) <= 202
    tgraphs.make_roc_csv(curves, str(tmp_path / "port.csv"))
    jgraphs.make_roc_csv(curves, str(tmp_path / "jax.csv"))
    gh, got = read_table(tmp_path / "port.csv")
    wh, want = read_table(tmp_path / "jax.csv")
    assert gh == wh == ["a_fpr", "a_tpr", "b_fpr", "b_tpr"]
    np.testing.assert_allclose(np.array(got), np.array(want), atol=1e-12, rtol=0)


def test_graphs_cli_writes_its_outputs(tmp_path):
    write_csv(tmp_path / "args1-lambda.csv", ["t", "dice", "ssim"],
              [[t, 0.1 * i, 0.5] for i, t in enumerate(range(50, 300, 50))])
    out = tmp_path / "out"
    tgraphs.main([str(tmp_path / "args1-lambda.csv"), "--out", str(out),
                  "--window", "2"])
    assert sorted(p.name for p in out.iterdir()) == [
        "args1-lambda-mu-std.csv", "dice-comparison.png"]
