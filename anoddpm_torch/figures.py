"""The paper's figures: ``python -m anoddpm_torch.figures <ARG_NUM> <which>``.

Counterpart of `anoddpm_tpu/figures.py:29-416`.  Each generator runs the
port's chains on the card (the EMA model of `detect._load_eval_model`) and
writes under ``final-outputs/`` the file names the JAX package writes:
PNG sheets by the port's own encoder (`visualize.save_grid_png`), videos
through imageio when a figure needs one.  which is one of `GENERATORS`
(sequence, masked_comparison, videos, ano, gauss_simplex,
varying_frequency, varying_t) or all; ``<SIMPLEX_ARG_NUM> test_set
<GAUSS_ARG_NUM> [anomalous]`` makes the two-checkpoint filmstrips and
``<ARG_NUM> ce [train_steps]`` the context-encoder sheets.  Images are
NHWC numpy between the functions.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from . import diffusion as dmod
from . import streams
from . import visualize as vz
from .data.datasets import anomalous_dataset_from_args
from .data.pipeline import to_nchw, to_nhwc
from .detect import _device_of, _load_eval_model, detection_A_fixedT
from .device import DeviceLike
from .ops.noise import make_noise_sampler, sampler_from_args


def _out_dir(root_dir: str) -> str:
    d = os.path.join(root_dir, "final-outputs")
    os.makedirs(d, exist_ok=True)
    return d


def _first_slice(args, root_dir, index: int = 0):
    """The first slice of anomalous volume `index` (cycled): (x (1, H, W,
    C), mask (1, H, W, C) or None)."""
    d_set = anomalous_dataset_from_args(root_dir, args)
    sample = d_set[index % len(d_set)]
    img = np.asarray(sample["image"])
    mask = sample.get("mask")
    if img.ndim == 4:
        img, mask = img[:1], (mask[:1] if mask is not None else None)
    else:
        img = img[None]
        mask = mask[None] if mask is not None else None
    return img, (np.asarray(mask) if mask is not None else None)


def make_prediction(real, recon, mask, x_t, threshold: float = 0.5,
                    error_fn: str = "sq"):
    """The 6-panel builder: (panels, thresholded error), the panels
    stacked as (real, x_t, reconstruction, error map, thresholded error,
    mask), each (B, H, W, C), in the [-1, 1] display range.  error_fn "sq":
    ((recon - real)^2 * 2) - 1 against (threshold * 2) - 1; "l1": the signed
    difference."""
    real, recon = np.asarray(real), np.asarray(recon)
    mask, x_t = np.asarray(mask), np.asarray(x_t)
    if error_fn == "l1":
        err = recon - real
    else:
        err = ((recon - real) ** 2 * 2) - 1
    pred = ((err > (threshold * 2) - 1).astype(np.float32) * 2) - 1
    panels = np.concatenate([real, x_t, recon, err, pred, mask], axis=0)
    return panels, pred


def _sequence_fb(em, sched, t_distance: int, sampler, whole: str = "whole"):
    """fb(x NHWC, seed) -> (recon, frames (F, B, H, W, C)) by
    `forward_backward_sequence` with `sampler`, from a generator seeded
    `seed` on the model's device."""
    device = _device_of(em)

    def fb(x, seed):
        generator = torch.Generator(device=device).manual_seed(seed)
        with torch.inference_mode():
            recon, frames = dmod.forward_backward_sequence(
                em, sched, to_nchw(x).to(device), t_distance, generator,
                noise_sampler=sampler, see_whole_sequence=whole)
        return to_nhwc(recon), to_nhwc(frames)

    return fb


def _whole_sequence(x, seed, fb):
    """"whole"-capture `fb` with x_0 prepended: (x_0, the forward chain,
    the reverse chain), as the reference's sequence list."""
    recon, frames = fb(x, seed)
    return recon, np.concatenate([np.asarray(x)[None], frames])


def _mirror_indices(n_frames: int, n_fwd: int) -> np.ndarray:
    """Filmstrip frame indices: `n_fwd` frames evenly over the forward
    half, then n_fwd - 1 mirrored from the end of the reverse half."""
    fwd_idx = np.linspace(0, n_frames // 2, n_fwd).astype(int)
    bwd_idx = (-1 * fwd_idx[-2::-1]) - 1
    return np.append(fwd_idx, bwd_idx)


def _sequence_row(frames, prediction, mask, n_fwd: int = 6):
    """One filmstrip row: mirrored frames, then prediction and mask."""
    idxs = _mirror_indices(len(frames), n_fwd)
    panels = [frames[i] for i in idxs] + [prediction, mask]
    return np.concatenate(panels, axis=0), len(panels)


def ano_outputs(args, em, sched, root_dir: str = ".", n_attempts: int = 3,
                rows: int = 1, t_distance: int = 250, threshold: float = 0.5):
    """Per attempt, `rows` anomalous slices through "whole" partial
    diffusion at lambda = `t_distance` (clamped to [1, T]), the generator
    seeded attempt * 97 + row: final-outputs/ARGS={n}/attempt={k}-{threshold}
    -predictions.png (the 6-panel rows) and ...-sequence.png (13-column
    filmstrips with prediction and mask)."""
    streams.torch_only(args, "figures.ano_outputs")
    td = max(1, min(t_distance, sched.num_timesteps))
    out_dir = os.path.join(_out_dir(root_dir), f"ARGS={args['arg_num']}")
    os.makedirs(out_dir, exist_ok=True)
    fb = _sequence_fb(em, sched, td, sampler_from_args(args))
    for attempt in range(n_attempts):
        pred_rows, seq_rows = [], []
        n_cols = 13
        for r in range(rows):
            x, mask = _first_slice(args, root_dir, index=attempt * rows + r)
            mask_panel = mask if mask is not None else np.zeros(x.shape, np.float32)
            recon, full = _whole_sequence(x, attempt * 97 + r, fb)
            panels, pred = make_prediction(x, recon, mask_panel,
                                           full[max(td // 2, 1)], threshold)
            pred_rows.append(panels)
            row, n_cols = _sequence_row(full, pred, mask_panel)
            seq_rows.append(row)
        vz.save_grid_png(
            os.path.join(out_dir,
                         f"attempt={attempt + 1}-{threshold}-predictions.png"),
            np.concatenate(pred_rows, axis=0), row_size=6)
        vz.save_grid_png(
            os.path.join(out_dir,
                         f"attempt={attempt + 1}-{threshold}-sequence.png"),
            np.concatenate(seq_rows, axis=0), row_size=n_cols)


def ce_outputs(args, ce_model=None, root_dir: str = ".", n_attempts: int = 3,
               rows: int = 2, window: int = 4, ce_train_steps: int = 2000,
               threshold: float = 0.5, device: DeviceLike = None):
    """The context-encoder sheets: per attempt, `rows` anomalous slices
    reconstructed by `sliding_window_inpaint` as (x_0, reconstruction,
    square error, prediction, mask) rows,
    final-outputs/ARGS={n}/ce-attempt={k}-predictions.png.  Without a
    trained `ce_model` one is trained for `ce_train_steps` on the config's
    healthy set."""
    streams.torch_only(args, "figures.ce_outputs")
    from .baselines import train_context_encoder
    from .models.context_encoder import sliding_window_inpaint
    if ce_model is None:
        ce_model = train_context_encoder(args, root_dir=root_dir,
                                         steps=ce_train_steps, device=device)
    model_device = _device_of(ce_model)
    out_dir = os.path.join(_out_dir(root_dir), f"ARGS={args['arg_num']}")
    os.makedirs(out_dir, exist_ok=True)
    for attempt in range(n_attempts):
        sheet = []
        for r in range(rows):
            x, mask = _first_slice(args, root_dir, index=attempt * rows + r)
            mask_panel = mask if mask is not None else np.zeros(x.shape, np.float32)
            recon = to_nhwc(sliding_window_inpaint(
                ce_model, to_nchw(x).to(model_device), window))
            mse = ((recon - x) ** 2 * 2) - 1
            pred = (((recon - x) ** 2 > threshold).astype(np.float32) * 2) - 1
            sheet.append(np.concatenate([x, recon, mse, pred, mask_panel],
                                        axis=0))
        vz.save_grid_png(
            os.path.join(out_dir, f"ce-attempt={attempt + 1}-predictions.png"),
            np.concatenate(sheet, axis=0), row_size=5)


def test_set_outputs(simplex_token, gauss_token, root_dir: str = ".",
                     anomalous: bool = False, t_distance: int = 250,
                     n_attempts: int = 2, use_checkpoint: bool = False,
                     device: DeviceLike = None):
    """The paper's Figure 1: 7-column "whole" filmstrips (4 forward frames,
    3 reverse) of the same images under the simplex-trained and the
    gauss-trained checkpoints, on the healthy test set (2 rows each) or
    the anomalous set (1 row each), the generator seeded attempt * 31 +
    row: final-outputs/ARGS={simplex n}/test_set_mixed_attempt={k}
    -sequence.png."""
    models = {}
    for tag, token in (("simplex", simplex_token), ("gauss", gauss_token)):
        models[tag] = _load_eval_model(root_dir, token, use_checkpoint, device)
    args_s = models["simplex"][0]
    td = max(1, min(t_distance, *(m[2].num_timesteps for m in models.values())))
    rows = 1 if anomalous else 2
    out_dir = os.path.join(_out_dir(root_dir), f"ARGS={args_s['arg_num']}")
    os.makedirs(out_dir, exist_ok=True)

    if anomalous:
        def get_image(i):
            return _first_slice(args_s, root_dir, index=i)[0]
    else:
        from .data.datasets import dataset_from_args
        d_set = dataset_from_args(root_dir, args_s, train=False)

        def get_image(i):
            return np.asarray(d_set[i % len(d_set)]["image"])[None]

    fbs = {tag: _sequence_fb(em, sched, td, sampler_from_args(args_m))
           for tag, (args_m, em, sched) in models.items()}
    for attempt in range(n_attempts):
        imgs = [get_image(attempt * rows + r) for r in range(rows)]
        sequences = [_whole_sequence(x, attempt * 31 + r, fbs[tag])[1]
                     for tag in ("simplex", "gauss")
                     for r, x in enumerate(imgs)]
        idxs = _mirror_indices(len(sequences[0]), n_fwd=4)
        grid = np.concatenate(
            [np.concatenate([seq[i] for i in idxs], axis=0)
             for seq in sequences], axis=0)
        vz.save_grid_png(
            os.path.join(out_dir,
                         f"test_set_mixed_attempt={attempt + 1}-sequence.png"),
            grid, row_size=len(idxs))


def denoise_sequence(args, em, sched, root_dir: str = ".",
                     t_distance: Optional[int] = None, n_cols: int = 13):
    """A 13-frame forward/backward filmstrip of the first anomalous slice
    at lambda = sample_distance / 2: final-outputs/ARGS={n}-sequence.png."""
    streams.torch_only(args, "figures.denoise_sequence")
    x, _ = _first_slice(args, root_dir)
    if t_distance is None:
        t_distance = int(args["sample_distance"]) // 2
    fb = _sequence_fb(em, sched, t_distance, sampler_from_args(args))
    _, frames = fb(x, 0)
    idxs = np.linspace(0, frames.shape[0] - 1, n_cols).astype(int)
    strip = np.concatenate([frames[i] for i in idxs], axis=0)
    vz.save_grid_png(os.path.join(_out_dir(root_dir),
                                  f"ARGS={args['arg_num']}-sequence.png"),
                     strip, row_size=n_cols)


def masked_comparison(args, em, sched, root_dir: str = ".",
                      t_distance: int = 250, n_volumes: int = 4):
    """`make_prediction` rows of the first slice of `n_volumes` volumes
    ("half" sequences, generator seeded by the volume's index):
    final-outputs/ARGS={n}-masked-comparison.png."""
    streams.torch_only(args, "figures.masked_comparison")
    td = min(t_distance, sched.num_timesteps)
    fb = _sequence_fb(em, sched, td, sampler_from_args(args), whole="half")
    rows = []
    for i in range(n_volumes):
        x, mask = _first_slice(args, root_dir, index=i)
        recon, frames = fb(x, i)
        mask_panel = mask if mask is not None else np.zeros(recon.shape, np.float32)
        panels, _ = make_prediction(x, recon, mask_panel, frames[0])
        rows.append(panels)
    vz.save_grid_png(os.path.join(_out_dir(root_dir),
                                  f"ARGS={args['arg_num']}-masked-comparison.png"),
                     np.concatenate(rows, axis=0), row_size=6)


def diffusion_videos(args, em, sched, root_dir: str = ".", n_volumes: int = 2):
    """A "whole" partial-diffusion video of the first slice of `n_volumes`
    volumes at lambda = sample_distance / 2:
    final-outputs/ARGS={n}-video-{i}.mp4."""
    streams.torch_only(args, "figures.diffusion_videos")
    lam = int(args["sample_distance"]) // 2
    fb = _sequence_fb(em, sched, lam, sampler_from_args(args))
    for i in range(n_volumes):
        x, _ = _first_slice(args, root_dir, index=i)
        _, frames = fb(x, i)
        vz.save_video(os.path.join(_out_dir(root_dir),
                                   f"ARGS={args['arg_num']}-video-{i}.mp4"),
                      list(frames))


def gauss_simplex_comparison(args, em, sched, root_dir: str = ".",
                             t_distance: int = 250):
    """`make_prediction` rows of the first slice under Gaussian, then
    simplex noise (generator seeded 7):
    final-outputs/ARGS={n}-gauss-vs-simplex.png."""
    streams.torch_only(args, "figures.gauss_simplex_comparison")
    x, mask = _first_slice(args, root_dir)
    td = min(t_distance, sched.num_timesteps)
    rows = []
    for kind in ("gauss", "simplex"):
        fb = _sequence_fb(em, sched, td, make_noise_sampler(kind), whole="half")
        recon, frames = fb(x, 7)
        mask_panel = mask if mask is not None else np.zeros(recon.shape, np.float32)
        panels, _ = make_prediction(x, recon, mask_panel, frames[0])
        rows.append(panels)
    vz.save_grid_png(os.path.join(_out_dir(root_dir),
                                  f"ARGS={args['arg_num']}-gauss-vs-simplex.png"),
                     np.concatenate(rows, axis=0), row_size=6)


def varying_frequency(args, em, sched, root_dir: str = ".", end_freq: int = 6):
    """The frequency sweep of `detect.detection_A_fixedT` at lambda = 250
    (clamped to T): final-outputs/ARGS={n}-varying-frequency.png."""
    x, mask = _first_slice(args, root_dir)
    mask_panel = mask if mask is not None else np.zeros(x.shape)
    grid = detection_A_fixedT(args, em, sched, x, mask_panel, end_freq=end_freq,
                              t_distance=min(250, sched.num_timesteps))
    vz.save_grid_png(os.path.join(_out_dir(root_dir),
                                  f"ARGS={args['arg_num']}-varying-frequency.png"),
                     grid, row_size=6)


def gauss_varying_t(args, em, sched, root_dir: str = ".",
                    lambdas=(250, 500, 750)):
    """Gaussian reconstructions of the first slice at each lambda (clamped
    to T; generator seeded lambda): final-outputs/ARGS={n}-gauss-varyingT.png."""
    streams.torch_only(args, "figures.gauss_varying_t")
    x, mask = _first_slice(args, root_dir)
    device = _device_of(em)
    sampler = make_noise_sampler("gauss")
    rows = [x]
    for lam in lambdas:
        lam = min(lam, sched.num_timesteps)
        generator = torch.Generator(device=device).manual_seed(lam)
        with torch.inference_mode():
            recon = dmod.forward_backward(em, sched, to_nchw(x).to(device), lam,
                                          generator, noise_sampler=sampler)
        rows.append(to_nhwc(recon))
    rows.append(mask if mask is not None else np.zeros_like(rows[0]))
    vz.save_grid_png(os.path.join(_out_dir(root_dir),
                                  f"ARGS={args['arg_num']}-gauss-varyingT.png"),
                     np.concatenate(rows, axis=0), row_size=len(rows))


GENERATORS = {
    "sequence": denoise_sequence,
    "masked_comparison": masked_comparison,
    "videos": diffusion_videos,
    "ano": ano_outputs,
    "gauss_simplex": gauss_simplex_comparison,
    "varying_frequency": varying_frequency,
    "varying_t": gauss_varying_t,
}

_USAGE = (f"usage: python -m anoddpm_torch.figures <ARG_NUM> "
          f"[{'|'.join(GENERATORS)}|all]\n"
          f"       python -m anoddpm_torch.figures <SIMPLEX_ARG_NUM> "
          f"test_set <GAUSS_ARG_NUM> [anomalous]\n"
          f"       python -m anoddpm_torch.figures <ARG_NUM> ce [train_steps]")


def main(argv=None, device: DeviceLike = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(_USAGE)
    token = argv[0]
    which = argv[1] if len(argv) > 1 else "all"
    if which == "ce":
        from .config import load_args
        steps = int(argv[2]) if len(argv) > 2 else 2000
        ce_outputs(load_args(token), ce_train_steps=steps, device=device)
        return
    if which == "test_set":
        if len(argv) < 3:
            raise SystemExit("test_set needs a second (gauss) ARG_NUM")
        test_set_outputs(token, argv[2], anomalous="anomalous" in argv[3:],
                         device=device)
        return
    if which != "all" and which not in GENERATORS:
        raise SystemExit(_USAGE)
    args, em, sched = _load_eval_model(".", token, device=device)
    targets = GENERATORS if which == "all" else {which: GENERATORS[which]}
    for name, fn in targets.items():
        print(f"generating {name}...", flush=True)
        fn(args, em, sched)


if __name__ == "__main__":
    main()
