"""The check of the check: a run with the chip's look skipped, at 32x32 on
the CPU, comes out correct when sound, and not correct with the control
(the reference with fp8 operands, or its loss over half of the rows) in
the program's place, or with the timed path broken underneath: a step
that returns its state unchanged, half of the batch left out with the mean
taken over the rest, an answer altered where it is produced; and, for
training, each of those, or stale rows replayed, only after set-up's
three checked steps, which the late stage's steps from the state the
window reached catch.  (One chip: no exchange between chips to leave
out.)"""

import pytest
import torch

import anoddpm_torch.detect as detect
import anoddpm_torch.diffusion as dm
import anoddpm_torch.train as train
import anoddpm_torch.training as training
from benchmark.tests import tiny

DETECT = "paper128.detect.ddpm200.b8"
TRAIN = "paper128.train.b8"


@pytest.mark.parametrize("name", [DETECT, TRAIN])
def test_sound_run_is_correct(name):
    correct, checks, run = tiny.run(name)
    assert correct, checks
    assert run.attempted >= 1


@pytest.mark.parametrize("name,control", [(DETECT, "fp8"), (TRAIN, "fp8"),
                                          (TRAIN, "half_batch")])
def test_control_is_not_correct(name, control):
    correct, checks, _ = tiny.run(name, control=control)
    assert not correct, checks


def unchanged_reverse_step(monkeypatch):
    monkeypatch.setattr(dm, "sample_p", lambda model_fn, sched, x_t, *a, **k:
                        (x_t, x_t))


def half_batch_chain(monkeypatch):
    whole = dm.forward_backward

    def half(model_fn, sched, x, *a, **k):
        out = whole(model_fn, sched, x[: x.shape[0] // 2], *a, **k)
        return torch.cat([out, out])[: x.shape[0]]
    monkeypatch.setattr(dm, "forward_backward", half)


def altered_answer(monkeypatch):
    score = detect.M.batched_anomaly_metrics

    def altered(real, recon, mask):
        out = score(real, recon, mask)
        out["auc"] = out["auc"] * 0.9
        return out
    monkeypatch.setattr(detect.M, "batched_anomaly_metrics", altered)


def unchanged_train_state(monkeypatch):
    monkeypatch.setattr(training.Optimizer, "step",
                        lambda self: torch.zeros(()))
    monkeypatch.setattr(training, "ema_update", lambda *a, **k: None)


def half_batch_loss(monkeypatch):
    whole = dm.calc_loss

    def half(model_fn, sched, x_0, *a, **k):
        loss, extra = whole(model_fn, sched, x_0, *a, **k)
        return loss[: x_0.shape[0] // 2], extra
    monkeypatch.setattr(dm, "calc_loss", half)


def altered_loss(monkeypatch):
    make = train.make_train_step

    def made(*a, **k):
        step = make(*a, **k)

        def altered(*sa, **sk):
            out = step(*sa, **sk)
            out["loss"] = out["loss"] * 1.05
            return out
        return altered
    monkeypatch.setattr(train, "make_train_step", made)


WARM_UP = 3     # set-up's checked steps; the faults below start after them


def late_unchanged_train_state(monkeypatch):
    whole, calls = training.Optimizer.step, [0]

    def step(self):
        calls[0] += 1
        return whole(self) if calls[0] <= WARM_UP else torch.zeros(())
    monkeypatch.setattr(training.Optimizer, "step", step)


def late_half_batch_loss(monkeypatch):
    whole, calls = dm.calc_loss, [0]

    def half(model_fn, sched, x_0, *a, **k):
        calls[0] += 1
        loss, extra = whole(model_fn, sched, x_0, *a, **k)
        return (loss if calls[0] <= WARM_UP
                else loss[: x_0.shape[0] // 2]), extra
    monkeypatch.setattr(dm, "calc_loss", half)


def late_stale_rows(monkeypatch):
    make = train.make_train_step

    def made(*a, **k):
        step, calls, kept = make(*a, **k), [0], []

        def stale(state, x, *sa, **sk):
            calls[0] += 1
            if calls[0] > WARM_UP:
                kept[:] = kept or [x]
                x = kept[0]
            return step(state, x, *sa, **sk)
        return stale
    monkeypatch.setattr(train, "make_train_step", made)


@pytest.mark.parametrize("name,fault", [
    (DETECT, unchanged_reverse_step), (DETECT, half_batch_chain),
    (DETECT, altered_answer), (TRAIN, unchanged_train_state),
    (TRAIN, half_batch_loss), (TRAIN, altered_loss),
    (TRAIN, late_unchanged_train_state), (TRAIN, late_half_batch_loss),
    (TRAIN, late_stale_rows)])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    correct, checks, _ = tiny.run(name)
    assert not correct, checks
