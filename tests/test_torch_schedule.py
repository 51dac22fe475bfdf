"""The port's Schedule equals the JAX package's field for field, including
the degenerate edge cases (T = 1, linear schedules with betas >= 1)."""
import dataclasses

import numpy as np
import pytest
import torch

from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
from anoddpm_torch import schedule as ts


@pytest.mark.filterwarnings("ignore:beta schedule contains values")
@pytest.mark.parametrize("name", ["cosine", "linear"])
@pytest.mark.parametrize("T", [1, 2, 10, 1000])
def test_schedule_fields_equal_jax(name, T):
    np.testing.assert_array_equal(ts.get_beta_schedule(T, name),
                                  get_beta_schedule(T, name))
    want = make_schedule(get_beta_schedule(T, name))
    got = ts.make_schedule(ts.get_beta_schedule(T, name))
    assert got.num_timesteps == want.num_timesteps == T
    for field in dataclasses.fields(got):
        value = getattr(got, field.name)
        assert value.dtype == torch.float32, field.name
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(getattr(want, field.name)),
                                      err_msg=field.name)


def test_schedule_to_moves_every_field():
    sched = ts.make_schedule(ts.get_beta_schedule(10, "cosine"))
    moved = sched.to("cpu")
    for field in dataclasses.fields(sched):
        assert torch.equal(getattr(moved, field.name), getattr(sched, field.name))
    with pytest.raises(NotImplementedError):
        ts.get_beta_schedule(10, "quadratic")
