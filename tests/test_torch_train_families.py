"""One train step of the port against the JAX package's: v12 detect and v8
pose in float64 (as `test_torch_train_tasks.py`: the loss terms within 1e-4
relative, each gradient leaf and each parameter leaf's change within 2e-5
of JAX's, parameter leaves within 1e-3 and BatchNorm statistics within 1e-5
of their norms).  The bfloat16 step is in `test_torch_train_bf16.py`."""

import pytest
import torch

from test_torch_train_tasks import check_float64_step

torch.set_num_threads(2)


@pytest.mark.parametrize("family, task", [("v12", "detect"), ("v8", "pose")])
def test_one_step_matches_jax(family, task):
    check_float64_step(family, task)
