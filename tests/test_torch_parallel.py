"""Data parallelism of the port on the CPU: two gloo processes against one.

Each test starts W = 2 processes with `torch.multiprocessing` and a
"file://" rendezvous under its tmp_path (no TCP port, so parallel test
workers cannot collide), and compares what rank 0 wrote with the same call
made here without a mesh.  Every spawn has its own limit (`run_ranks`:
the process group's timeout and a join deadline), so a hang fails the test
instead of the suite.

- Two train steps (hybrid loss, prop-t weights, randParam noise, dropout
  0) through DDP, with and without remat "dots": parameters, EMA and AdamW
  state within 1e-5 relative of one process on the whole batch.
- `sharded_anomalous_metrics`: reconstructions within 1e-5, the same CSV;
  `graph_data` and `roc_data` with a mesh against without one, and
  `graph_data` on the JAX package's keys (`rng: "jax"`) against a control
  that computes each rank's rows at its batch shape in this process.
- `train.train` on args_dptest-like args (train_substeps 2) on 2 ranks,
  stopped after its epoch-2 checkpoint and resumed with RESUME_RECENT;
  the detect and train CLIs as torchrun starts them.
"""
import dataclasses
import datetime
import os
import pickle
import time
import uuid

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from anoddpm_torch import checkpoint as tckpt
from anoddpm_torch import detect as tdetect
from anoddpm_torch import schedule as ts
from anoddpm_torch import training as ttr
from anoddpm_torch.config import defaultdict_from_json, load_args
from anoddpm_torch.models.unet import UNet
from anoddpm_torch.ops.noise import make_noise_sampler
from anoddpm_torch.parallel.mesh import (Mesh, close_mesh, init_mesh,
                                         shard_sampler)

WORLD = 2
TIMEOUT_S = 240      # per spawn: the join deadline and the group's timeout
CFG = dict(img_size=32, base_channels=32, channel_mults=(1, 2),
           attention_resolutions="16")
T_SHORT = 10
LR = 1e-4            # args_dptest's
ARGS = {"img_size": [32, 32], "T": 20, "beta_schedule": "cosine",
        "base_channels": 32, "channel_mults": "1 2",
        "attention_resolutions": "16", "noise_fn": "simplex",
        "dataset": "synthetic", "compute_dtype": "float32",
        "anomalous_volumes": 2, "Batch_Size": 2, "sample_distance": 8,
        "arg_num": "dp"}


def _entry(rank, fn, root, payload, store):
    torch.set_num_threads(1)
    mesh = init_mesh("cpu", init_method=f"file://{store}",
                     rank=rank, world_size=WORLD,
                     timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(mesh, root, payload)
        if mesh.is_main:
            with open(os.path.join(root, "rank0.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        close_mesh(mesh)


def spawn_ranks(entry, args):
    """entry(rank, *args) in WORLD spawned processes, joined within
    TIMEOUT_S; the processes are stopped whatever happens."""
    ctx = mp.start_processes(entry, args=args, nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                pytest.fail(f"{WORLD} ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def rendezvous(root):
    return os.path.join(root, f"rendezvous-{uuid.uuid4().hex}")


def run_ranks(fn, root, payload=None):
    """fn(mesh, root, payload) on WORLD gloo ranks; returns rank 0's result."""
    spawn_ranks(_entry, (fn, str(root), payload, rendezvous(root)))
    with open(os.path.join(root, "rank0.pkl"), "rb") as f:
        return pickle.load(f)


def seeded_unet(seed=0):
    """The small UNet with every parameter perturbed (its zero-initialised
    output conv would otherwise predict 0)."""
    torch.manual_seed(seed)
    model = UNet(**CFG)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return model


def global_batches(n=2, b=4):
    rng = np.random.default_rng(4)
    return [torch.from_numpy(rng.normal(size=(b, 1, 32, 32)).astype(np.float32))
            for _ in range(n)]


def take_steps(mesh, remat):
    """Two train steps from seeded weights; mesh None: the whole batch."""
    model = seeded_unet()
    state = ttr.init_train_state(model, ttr.make_optimizer(model.parameters(),
                                                           LR))
    sched = ts.make_schedule(ts.get_beta_schedule(T_SHORT, "cosine"))
    step = ttr.make_train_step(sched, make_noise_sampler("simplex_randParam"),
                               "hybrid", loss_weight="prop-t", remat=remat,
                               mesh=mesh)
    gen = torch.Generator().manual_seed(3)
    losses, grads = [], []
    for x in global_batches():
        m = step(state, x if mesh is None else mesh.shard_batch(x), gen)
        losses.append(float(m["loss"]))
        grads.append({n: p.grad.clone() for n, p in
                      state.model.named_parameters()})
    opt = ttr.optimizer_state(state)
    return dict(losses=losses, grads=grads,
                params={n: p.detach().clone() for n, p in
                        state.model.named_parameters()},
                ema={n: p.detach().clone() for n, p in
                     state.ema.named_parameters()},
                opt={n: {k: v.clone() for k, v in e.items()}
                     for n, e in opt.items()})


def _steps_worker(mesh, root, remat):
    return take_steps(mesh, remat)


def assert_close(got, want, rtol, scale, err_msg, where=None):
    """got within rtol x `scale` of want (at the elements `where`)."""
    g, w = got.numpy(), want.numpy()
    if where is not None:
        g, w = g[where], w[where]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("remat", [None, "dots"])
def test_ddp_train_steps_equal_one_process(tmp_path, remat):
    """Within 1e-5 relative (to the largest magnitude of the parameter or
    state kind).  Where a parameter's gradient is below 1e-3 of the largest
    (the biases before a GroupNorm whose groups are single channels: their
    true gradient is 0 and reads ~1e-10), Adam steps by +-lr with a sign
    set by rounding, which differs with the order of the batch sums; there
    a parameter is held to 2 lr a step."""
    got = run_ranks(_steps_worker, tmp_path, remat)
    want = take_steps(None, remat)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    steps = len(want["grads"])
    gmax = max(float(g.abs().max()) for gs in want["grads"] for g in gs.values())
    for n, w in want["params"].items():
        keep = np.all([gs[n].abs().numpy() > 1e-3 * gmax
                       for gs in want["grads"]], axis=0)
        assert_close(got["params"][n], w, 1e-5, float(w.abs().max()), n, keep)
        assert float((got["params"][n] - w).abs().max()) <= 2 * LR * steps, n
    for n, w in want["ema"].items():
        assert_close(got["ema"][n], w, 1e-5, float(w.abs().max()), n)
    for kind in ("exp_avg", "exp_avg_sq"):
        scale = max(float(e[kind].abs().max()) for e in want["opt"].values())
        for n, e in want["opt"].items():
            assert_close(got["opt"][n][kind], e[kind], 1e-5, scale,
                         f"{n} {kind}")
            assert float(got["opt"][n]["step"]) == float(e["step"]) == steps


def test_shard_sampler_keeps_this_ranks_rows():
    """The sharded draw of each rank equals its rows of one global draw, at
    per-sample t, for every noise kind the configs use."""
    class Rank:
        world_size = 2

        def __init__(self, rank):
            self.rank = rank

    t = torch.tensor([3, 9, 0, 5])
    for kind in ("gauss", "simplex", "simplex_randParam", "random"):
        sampler = make_noise_sampler(kind)
        whole = sampler((4, 1, 16, 16), t, torch.Generator().manual_seed(1))
        for r in range(2):
            part = shard_sampler(sampler, Rank(r))(
                (2, 1, 16, 16), t[2 * r:2 * r + 2],
                torch.Generator().manual_seed(1))
            torch.testing.assert_close(part, whole[2 * r:2 * r + 2],
                                       rtol=0, atol=0, msg=kind)


def write_checkpoint(root):
    args = defaultdict_from_json(dict(ARGS))
    model = seeded_unet(1)
    tckpt.save_checkpoint(str(root), args, 0, model.state_dict(),
                          model.state_dict(), {}, final=True)
    return args


def recording_metrics(monkeypatch_or_none, store):
    """Wrap `detect.M.batched_anomaly_metrics` to keep the reconstructions."""
    real = tdetect.M.batched_anomaly_metrics

    def wrapped(images, recon, masks):
        store.append(np.array(recon))
        return real(images, recon, masks)

    if monkeypatch_or_none is None:
        tdetect.M.batched_anomaly_metrics = wrapped
    else:
        monkeypatch_or_none.setattr(tdetect.M, "batched_anomaly_metrics", wrapped)


def detection_suite(mesh, root, monkeypatch=None):
    """sharded metrics, graph and roc on the checkpoint under root."""
    args, em, sched = tdetect._load_eval_model(str(root), "dp", device="cpu")
    recons = []
    recording_metrics(monkeypatch, recons)
    # chunks of 4 slices on 1 rank and on 2: the same two chunks
    summary = tdetect.sharded_anomalous_metrics(
        args, em, sched, mesh, root_dir=str(root), t_distance=6,
        chunk_per_device=4 if mesh is None else 2)
    csv_text = open(os.path.join(root, "metrics", "argsdp.csv")).read() \
        if mesh is None or mesh.is_main else None
    rows = tdetect.graph_data((args, em, sched), root_dir=str(root),
                              lambdas=[0, 2, 5, 9], max_volumes=1,
                              lambda_batch=4, mesh=mesh)
    curves = tdetect.roc_data(["dp"], root_dir=str(root), t_distance=6,
                              max_volumes=1, mesh=mesh, device="cpu")
    return dict(summary=summary, csv=csv_text, recons=recons[:2], rows=rows,
                curves=curves)


def _detect_worker(mesh, root, _):
    return detection_suite(mesh, root)


@pytest.fixture(scope="module")
def detection_runs(tmp_path_factory):
    """The detection suite on 2 gloo ranks and in this process, each on its
    own copy of one checkpoint."""
    roots = {k: tmp_path_factory.mktemp(f"dp{k}") for k in (1, 2)}
    for root in roots.values():
        write_checkpoint(root)
    mp_ = pytest.MonkeyPatch()
    try:
        one = detection_suite(None, roots[1], mp_)
    finally:
        mp_.undo()
    two = run_ranks(_detect_worker, roots[2])
    return one, two, roots


def test_sharded_metrics_equal_one_process(detection_runs):
    one, two, roots = detection_runs
    assert len(one["recons"][0]) == len(two["recons"][0]) == 8   # 2 volumes
    np.testing.assert_allclose(two["recons"][0], one["recons"][0], atol=1e-5,
                               rtol=0)
    assert two["csv"] == one["csv"] and one["csv"].startswith("dice,ssim,iou,")
    for k, v in one["summary"].items():
        assert abs(two["summary"][k] - v) <= 1e-5, k


def test_graph_data_with_a_mesh_equals_without(detection_runs):
    one, two, _ = detection_runs
    np.testing.assert_allclose(two["recons"][1], one["recons"][1], atol=1e-5,
                               rtol=0)
    assert [r["t"] for r in two["rows"]] == [0, 2, 5, 9]
    for a, b in zip(two["rows"], one["rows"]):
        for k in ("dice", "ssim", "iou", "auc"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


def test_roc_data_with_a_mesh_equals_without(detection_runs):
    one, two, roots = detection_runs
    (gf, gt), (wf, wt) = two["curves"]["argsdp"], one["curves"]["argsdp"]
    from anoddpm_torch import metrics as tm
    assert abs(tm.auc(gf, gt) - tm.auc(wf, wt)) <= 1e-5
    for root in roots.values():
        assert (root / "metrics" / "roc-comparison.csv").exists()


def jax_graph(mesh, root, monkeypatch=None):
    """`graph_data` under `rng: "jax"` on the checkpoint under root: six
    lambdas in two chunks of 4 (the second padded), key(11) split once per
    chunk on every rank."""
    args, em, sched = tdetect._load_eval_model(str(root), "dp", device="cpu")
    args["rng"] = "jax"
    recons = []
    recording_metrics(monkeypatch, recons)
    rows = tdetect.graph_data((args, em, sched), root_dir=str(root),
                              lambdas=[0, 2, 5, 9, 12, 15], max_volumes=1,
                              lambda_batch=4, mesh=mesh)
    return dict(rows=rows, recons=recons)


def _jax_graph_worker(mesh, root, _):
    return jax_graph(mesh, root)


@dataclasses.dataclass(frozen=True)
class StagedMesh(Mesh):
    """A rank of the mesh run in this process, one rank after the other,
    rank 0 last: `gather_rows` keeps each rank's rows in `staged`, and
    rank 0's returns the kept rows of every rank in rank order."""
    staged: dict = dataclasses.field(default_factory=dict, compare=False)

    def gather_rows(self, x):
        self.staged.setdefault(self.rank, []).append(x.detach().cpu())
        if not self.is_main:
            return x
        return torch.cat([self.staged[r].pop(0) for r in range(self.world_size)])


def staged_ranks(root):
    """`jax_graph` on each rank of a 2-rank mesh in turn, in this process,
    on one thread as `_entry` runs a rank: the port's own sharded path
    (the key split per chunk, the padding, `mesh.rows`, `shard_sampler`),
    each rank's rows computed at its batch shape, without gloo.  Returns
    rank 0's result."""
    staged, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for rank in reversed(range(WORLD)):
            with pytest.MonkeyPatch.context() as mp_:
                out = jax_graph(StagedMesh(rank, WORLD, torch.device("cpu"),
                                           "gloo", staged), root, mp_)
    finally:
        torch.set_num_threads(threads)
    return out


def test_graph_data_on_jax_keys_with_a_mesh_equals_without(tmp_path,
                                                          monkeypatch):
    """Each rank splits the JAX key alike and draws the noise of the whole
    lambda batch, keeping its rows.  The control (`staged_ranks`) runs the
    same ranks of the port's own sharded path in this process: the 2 gloo
    ranks must reconstruct exactly what it does and write its pooled rows.

    The control is then held to one process on the whole lambda batch.
    Each rank's batch of 2 (not 4) changes the summation order of the CPU
    convolutions, so the two are two fp32 evaluations of one 15-step chain:
    they are held by the terms of RECON_RULE's Gaussian rule
    (`tests/test_torch_jax_streams.py`), 99.9% of pixels within 1e-4 and
    all within 1e-3 (not its simplex terms, which allow for two codes'
    lattice flips: here one code draws the same fields on both sides).  The change of batch shape alone moved pixels by up
    to 1.05e-5 on one host and 8.2e-6 on another, while the ranks equalled
    the control bit for bit (`scripts/parity_oracles.py graph`); a wrong
    noise row, key split or padding moves pixels by O(0.1).  The pooled
    rows keep their former limit, 1e-5 (6e-8 measured)."""
    roots = {k: tmp_path / f"w{k}" for k in ("one", "two", "control")}
    for root in roots.values():
        root.mkdir()
        write_checkpoint(root)
    control = staged_ranks(roots["control"])
    one = jax_graph(None, roots["one"], monkeypatch)
    two = run_ranks(_jax_graph_worker, roots["two"])
    assert len(one["recons"]) == len(two["recons"]) == len(control["recons"]) == 2
    for a, b, c in zip(two["recons"], one["recons"], control["recons"]):
        np.testing.assert_array_equal(a, c)
        d = np.abs(c - b)
        assert np.mean(d <= 1e-4) >= 0.999 and d.max() <= 1e-3, d.max()
    assert [r["t"] for r in two["rows"]] == [0, 2, 5, 9, 12, 15]
    assert two["rows"] == control["rows"]
    for a, b in zip(control["rows"], one["rows"]):
        for k in ("dice", "ssim", "iou", "auc"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)


DPTEST = {"Batch_Size": 4, "EPOCHS": 4, "iters_per_epoch": 4,
          "checkpoint_every": 2, "arg_num": "dptest_w2", "T": 10}


def _train_worker(mesh, root, leg):
    from anoddpm_torch import train
    args = load_args("args_dptest", config_dir=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"))
    args.update(DPTEST)
    if leg == 1:   # stop after the epoch-2 checkpoint, as a crash would
        real_save = train.save_checkpoint
        train.save_checkpoint = (lambda *a, **k: None if k.get("final")
                                 else real_save(*a, **k))
        train.purge_checkpoints = lambda *a, **k: None
        train.ev.testing = lambda *a, **k: {}
        state = train.train(args, root_dir=root, mesh=mesh, max_epochs=3)
    else:
        state = train.train(args, root_dir=root, mesh=mesh,
                            resume="RESUME_RECENT")
    return dict(step=state.step,
                params={n: p.detach().clone() for n, p in
                        state.model.named_parameters()})


def test_train_on_two_ranks_with_resume(tmp_path):
    """args_dptest (hybrid loss, prop-t, randParam, dropout, 2 substeps) at
    a global batch of 4 on 2 ranks: leg 1 to epoch 3, then RESUME_RECENT
    from the epoch-2 checkpoint to the end, with the test-set suite."""
    leg1 = run_ranks(_train_worker, tmp_path, 1)
    assert leg1["step"] == 4 * 4            # 4 epochs x 2 dispatches x 2
    base = tmp_path / "model" / "diff-params-ARGS=dptest_w2"
    assert (base / "checkpoint").is_dir() and not (base / "params-final").exists()
    os.remove(tmp_path / "rank0.pkl")
    leg2 = run_ranks(_train_worker, tmp_path, 2)
    assert leg2["step"] == 3 * 4            # epochs 2..4
    assert (base / "params-final").is_dir()
    assert not (base / "checkpoint").exists() or not os.listdir(base / "checkpoint")
    # epoch 0's record, from rank 0 alone (the log is appended to)
    log = (tmp_path / "metrics" / "argsdptest_w2-train.jsonl").read_text()
    assert len(log.strip().splitlines()) == 1
    assert all(torch.isfinite(p).all() for p in leg2["params"].values())


def _cli_rank(rank, root, store):
    """One torchrun-like rank: RANK and WORLD_SIZE in the environment, the
    rendezvous moved to a file, then the detect and train CLIs."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    from anoddpm_torch import train
    from anoddpm_torch.parallel import mesh as mesh_mod
    real, calls = mesh_mod.init_mesh, []

    def file_rendezvous(device=None):
        calls.append(None)
        return real(device, init_method=f"file://{store}-{len(calls)}",
                    timeout=datetime.timedelta(seconds=TIMEOUT_S))

    mesh_mod.init_mesh = file_rendezvous
    os.chdir(root)
    tdetect.main(["dp", "metrics"], device="cpu")
    train.main(["dpcli"], device="cpu")
    if rank == 0:
        with open(os.path.join(root, "rank0.pkl"), "wb") as f:
            pickle.dump(len(calls), f)


def test_torchrun_clis_on_two_ranks(tmp_path):
    """`detect <N> metrics` and `train <N>` as torchrun starts them, on 2
    gloo ranks: the sharded metrics CSV and the final checkpoint, written
    by rank 0 alone."""
    write_checkpoint(tmp_path)
    os.makedirs(tmp_path / "configs")
    import json
    with open(tmp_path / "configs" / "argsdpcli.json", "w") as f:
        json.dump({**ARGS, "T": T_SHORT, "Batch_Size": 4, "EPOCHS": 1,
                   "iters_per_epoch": 2, "checkpoint_every": 1,
                   "skip_test_eval": True, "lr": LR}, f)
    spawn_ranks(_cli_rank, (str(tmp_path), rendezvous(tmp_path)))
    with open(tmp_path / "rank0.pkl", "rb") as f:
        assert pickle.load(f) == 2             # one process group per CLI
    header, cells = (tmp_path / "metrics" / "argsdp.csv").read_text().splitlines()
    assert header == "dice,ssim,iou,precision,recall,fpr,auc"
    assert all(np.isfinite(float(c.split(" +- ")[0]))
               for c in cells.split(",")[:-1])
    base = tmp_path / "model" / "diff-params-ARGS=dpcli"
    assert (base / "params-final").is_dir()
    log = (tmp_path / "metrics" / "argsdpcli-train.jsonl").read_text()
    assert len(log.strip().splitlines()) == 1   # epoch 0, rank 0 alone
