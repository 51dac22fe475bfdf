"""Training entry point:
``python -m anoddpm_torch.train [RESUME_RECENT|RESUME_FINAL] <ARG_NUM>``.

Counterpart of `anoddpm_tpu/train.py:40-259`: the positional argument
selects ``configs/args{N}.json``; the loop keeps the reference recipe
(100 images an epoch unless `iters_per_epoch`, AdamW after a global-norm
clip of 1.0, EMA 0.9999, t < min(sample_distance, T) with train_start,
the metrics JSONL every 10 epochs, with `save_imgs` a snapshot every 50
epochs (and a one-step EMA sample grid every 100), the VLB sweep printed
every 200, checkpoints every `checkpoint_every` epochs, with `save_vids` a
"half"-sequence video every 500, then the final save, the purge of the
periodic checkpoints and the test-set suite).  Batches reach
the card through a pinned-memory prefetch thread.  It runs on the card
unless `device="cpu"`, and raises without one.

``torchrun --nproc_per_node=N -m anoddpm_torch.train <ARG_NUM>`` trains
data-parallel over N processes (`parallel.mesh`): `Batch_Size` is the
global batch and must divide by N; each rank takes its rows and the
gradients are averaged; only rank 0 writes checkpoints, the JSONL log,
snapshots, videos and the VLB sweep (these three on its own rows of the
batch) and runs the test-set suite, while the others wait at a barrier.
`train_substeps` S > 1 takes S steps per dispatch
(`training.make_multi_step`): iters_per_epoch // S dispatches an epoch,
and images/s counts B * S.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from . import diffusion as dmod
from . import evaluation as ev
from . import visualize as vz
from .checkpoint import load_checkpoint, purge_checkpoints, save_checkpoint
from .config import load_args, resolve_in_channels
from .data.datasets import dataset_from_args
from .data.pipeline import batch_iterator, prefetch_to_device, to_nhwc
from .device import DeviceLike, resolve_device
from .models.unet import unet_from_args
from .observe import MetricsLogger, ProfileWindow, StepTimer
from .ops.noise import sampler_from_args
from .parallel.mesh import Mesh, close_mesh, mesh_from_env
from .schedule import schedule_from_args
from .training import (TrainState, init_train_state, load_optimizer_state,
                       make_multi_step, make_optimizer, make_train_step,
                       optimizer_state)

_USAGE = ("usage: python -m anoddpm_torch.train [RESUME_RECENT|RESUME_FINAL] "
          "<ARG_NUM>\n       torchrun --nproc_per_node=N -m "
          "anoddpm_torch.train [RESUME_RECENT|RESUME_FINAL] <ARG_NUM>")


def save_snapshot(path: str, state: TrainState, sched, noise_sampler, x,
                  epoch: int, max_t: int, generator: torch.Generator) -> None:
    """The every-50-epochs training image: at epochs divisible by 100 the
    real / sample / pred_x0 grid of one EMA reverse step from a random t
    (the q-jump with the training noise), else the real / x_t / eps
    estimate / square error grid of the training model at t < max_t."""
    model = state.model
    was_training = model.training
    model.eval()
    with torch.inference_mode():
        if epoch % 100 == 0:
            t = dmod.sample_timesteps(generator, x.shape[0], sched.num_timesteps)
            x_t = dmod.sample_q(sched, x, t, noise_sampler(x.shape, t, generator))
            sample, pred_x0 = dmod.sample_p(state.ema, sched, x_t, t, generator)
            vz.sample_snapshot(path, to_nhwc(x), to_nhwc(sample),
                               to_nhwc(pred_x0), epoch)
        else:
            t = dmod.sample_timesteps(generator, x.shape[0], max_t)
            x_t = dmod.sample_q(sched, x, t, noise_sampler(x.shape, t, generator))
            vz.training_snapshot(path, to_nhwc(x), to_nhwc(x_t),
                                 to_nhwc(model(x_t, t)), epoch)
    model.train(was_training)


def new_train_state(args, device: torch.device) -> TrainState:
    """A fresh run's state on `device`: the UNet initialised on the CPU from
    args' seed (the same weights on every device), its EMA copy, and the
    clipped AdamW of args."""
    seed = int(args.get("seed", 0) or 0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = unet_from_args(args, resolve_in_channels(args))
    model = model.to(device)
    optimizer = make_optimizer(model.parameters(), float(args["lr"]),
                               float(args.get("weight_decay", 0) or 0),
                               float(args.get("grad_clip_norm", 1.0) or 1.0))
    return init_train_state(model, optimizer)


def restore_train_state(state: TrainState, root_dir: str, args,
                        resume: str) -> int:
    """Load model, EMA and AdamW state from params-final (RESUME_FINAL) or
    the newest periodic checkpoint (RESUME_RECENT), written by the port or
    by the JAX package; returns the checkpoint's epoch.  The step counter
    restarts at 0, as in the JAX trainer."""
    payload, meta = load_checkpoint(root_dir, args["arg_num"],
                                    use_checkpoint=resume == "RESUME_RECENT")
    if not payload["opt"]:
        raise ValueError("the checkpoint holds no optimizer state to resume")
    state.model.load_state_dict(payload["model"])
    state.ema.load_state_dict(payload["ema"])
    load_optimizer_state(state, payload["opt"])
    return int(meta["n_epoch"])


def train(args, root_dir: str = ".", resume: Optional[str] = None,
          max_epochs: Optional[int] = None, device: DeviceLike = None,
          mesh: Optional[Mesh] = None) -> TrainState:
    """Train args' model under `root_dir`; returns the final state.  Under
    a `mesh` this process trains its rows on `mesh.device`."""
    device = mesh.device if mesh is not None else resolve_device(device)
    main_rank = mesh is None or mesh.is_main
    sched = schedule_from_args(args).to(device)
    noise_sampler = sampler_from_args(args)
    state = new_train_state(args, device)
    start_epoch = 0
    if resume:
        start_epoch = restore_train_state(state, root_dir, args, resume)
        print(f"resumed from epoch {start_epoch}")

    # never train on t >= lambda_max with train_start
    if args.get("train_start"):
        max_t = min(int(args["sample_distance"]), sched.num_timesteps)
    else:
        max_t = sched.num_timesteps
    train_step = make_train_step(
        sched, noise_sampler, loss_type=str(args.get("loss-type") or "l2"),
        max_t=max_t, ema_decay=float(args.get("ema_decay", 0.9999) or 0.9999),
        loss_weight=str(args.get("loss_weight") or "none"),
        dropout=float(args.get("dropout", 0) or 0) > 0, mesh=mesh)
    substeps = int(args.get("train_substeps") or 1)
    if substeps > 1:
        train_step = make_multi_step(train_step, substeps)

    batch_size = int(args["Batch_Size"])
    if mesh is not None and batch_size % mesh.world_size:
        raise ValueError(f"Batch_Size {batch_size} does not divide over "
                         f"{mesh.world_size} ranks")
    dataset = dataset_from_args(root_dir, args, train=True)
    test_dataset = dataset_from_args(root_dir, args, train=False)
    loader = prefetch_to_device(batch_iterator(dataset, batch_size,
                                               shuffle=True), device,
                                substeps=substeps, mesh=mesh)
    test_loader = batch_iterator(test_dataset, batch_size, shuffle=True, seed=1)

    is_cifar = str(args.get("dataset", "")).lower() == "cifar"
    iters_per_epoch = int(args.get("iters_per_epoch") or
                          (200 if is_cifar else max(100 // batch_size, 1)))
    epochs = int(args["EPOCHS"]) if max_epochs is None else max_epochs
    checkpoint_every = int(args.get("checkpoint_every", 1000) or 1000)
    generator = torch.Generator(device=device).manual_seed(
        int(args.get("seed", 0) or 0))

    def after_main_rank_draws():
        """Rank 0 alone drew from the shared generator: hand its state on."""
        if mesh is not None:
            mesh.broadcast_generator(generator)

    start_time = time.time()
    losses, vlb_log = [], []
    mlog = (MetricsLogger(f"{root_dir}/metrics/args{args['arg_num']}-train.jsonl")
            if main_rank else None)
    timer = StepTimer()
    prof = ProfileWindow(f"train-args{args['arg_num']}"
                         + (f"-rank{mesh.rank}" if mesh is not None else ""))
    try:
        for epoch in range(start_epoch, epochs + 1):
            prof.start_epoch(epoch - start_epoch)
            epoch_losses = []
            for i in range(max(iters_per_epoch // substeps, 1)):
                x = next(loader)["image"]
                x_vis = x[-1] if substeps > 1 else x
                metrics = train_step(state, x, generator)
                timer.tick()
                epoch_losses.append(metrics["loss"])
                if epoch % 50 == 0 and i == 0 and args.get("save_imgs"):
                    if main_rank:
                        save_snapshot(
                            f"{root_dir}/diffusion-training-images/"
                            f"ARGS={args['arg_num']}/EPOCH={epoch}.png", state,
                            sched, noise_sampler, x_vis, epoch, max_t,
                            generator)
                    after_main_rank_draws()
            prof.end_epoch(epoch - start_epoch)
            losses.append(float(torch.stack(epoch_losses).mean()))
            if epoch % 10 == 0 and main_rank:
                mlog.log(state.step, epoch=epoch, loss=losses[-1],
                         grad_norm=metrics["grad_norm"],
                         imgs_per_sec=(batch_size * substeps / timer.mean
                                       if timer.mean == timer.mean else 0.0))

            if epoch % 200 == 0:
                if main_rank:
                    sweep_start = time.time()
                    state.model.eval()
                    with torch.inference_mode():
                        vlb_terms = dmod.calc_total_vlb(state.model, sched,
                                                        x_vis, generator)
                    vlb_log.append(float(vlb_terms["total_vlb"].mean()))
                    sweep_s = time.time() - sweep_start
                    elapsed = time.time() - start_time
                    eta = (epochs - epoch) * (elapsed / (epoch + 1 - start_epoch))
                    print(f"epoch: {epoch}, loss: {losses[-1]:.5f}, "
                          f"total VLB: {vlb_log[-1]:.4f} "
                          f"(mean of last 10: {np.mean(vlb_log[-10:]):.4f}), "
                          f"prior vlb: {float(vlb_terms['prior_vlb'].mean()):.2f}, "
                          f"vb: {float(vlb_terms['vb'].mean()):.3f}, "
                          f"x_0_mse: {float(vlb_terms['x_0_mse'].mean()):.3f}, "
                          f"mse: {float(vlb_terms['mse'].mean()):.3f}, "
                          f"VLB sweep {sweep_s:.2f} s, "
                          f"elapsed {elapsed:.0f}s, eta {eta:.0f}s", flush=True)
                after_main_rank_draws()

            if epoch % checkpoint_every == 0 and epoch > start_epoch:
                if main_rank:
                    save_checkpoint(root_dir, args, epoch,
                                    state.model.state_dict(),
                                    state.ema.state_dict(),
                                    optimizer_state(state), loss=losses[-1])
                if mesh is not None:
                    mesh.barrier()

            if (epoch % 500 == 0 and args.get("save_vids")
                    and epoch > start_epoch):
                if main_rank:
                    lam = (int(args["sample_distance"])
                           // (2 if epoch % 1000 == 0 else 4))
                    with torch.inference_mode():
                        _, frames = dmod.forward_backward_sequence(
                            state.ema, sched, x_vis, lam, generator,
                            noise_sampler=noise_sampler,
                            see_whole_sequence="half")
                    vz.save_video(f"{root_dir}/diffusion-videos/"
                                  f"ARGS={args['arg_num']}/"
                                  f"sample-EPOCH={epoch}.mp4",
                                  list(to_nhwc(frames)),
                                  row_size=min(8, batch_size))
                after_main_rank_draws()
    finally:
        # the profiler is process-wide: always close the trace, the log and
        # the prefetch thread, even when the epoch loop unwinds on an error
        prof.stop()
        if mlog is not None:
            mlog.close()
        loader.close()
    if main_rank:
        save_checkpoint(root_dir, args, epochs, state.model.state_dict(),
                        state.ema.state_dict(), optimizer_state(state),
                        final=True)
        purge_checkpoints(root_dir, args["arg_num"])
        if not args.get("skip_test_eval"):
            ev.testing(test_loader, state.ema, sched, args,
                       noise_sampler=noise_sampler, root_dir=root_dir,
                       save_videos=bool(args.get("save_vids")))
    if mesh is not None:
        mesh.barrier()
    return state


def main(argv=None, device: DeviceLike = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    resume = None
    for flag in ("RESUME_RECENT", "RESUME_FINAL"):
        if flag in argv:
            resume = flag
            argv.remove(flag)
    if not argv:
        raise SystemExit(_USAGE)
    args = load_args(argv[0])
    mesh = mesh_from_env(device)
    if mesh is None or mesh.is_main:
        print(f"args{args['arg_num']}: {dict(args)}")
    try:
        train(args, resume=resume, mesh=mesh, device=device)
    finally:
        close_mesh(mesh)


if __name__ == "__main__":
    main()
