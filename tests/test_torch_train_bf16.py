"""A v8 detect train step of the port in bfloat16 compute with float32
parameters (the recipe's types) against the JAX package's.

bfloat16 keeps 8 significant bits, and a train step's gradients in it are
mostly rounding: JAX's own bfloat16 step moves the parameters ~75 % of the
way off its float32 step (the distance of the updates over all leaves,
relative to the float32 update).  So the port's bfloat16 step is held to
JAX's float32 step no further than 1.5x JAX's bfloat16 step is, for the
parameter updates and for the BatchNorm statistics, and its loss within
2e-2 relative of both JAX losses."""

import numpy as np
import torch

from test_torch_train import _flat
from test_torch_train_tasks import jax_step, port_step

torch.set_num_threads(2)


def _distance(leaves, ref, start, kind):
    """The distance of ``leaves`` from ``ref`` over all leaves of ``kind``,
    relative to ``ref``'s own size (its update from ``start`` for the
    parameters)."""
    num = den = 0.0
    for path, r in ref.items():
        if path[0] != kind:
            continue
        base = start[path] if kind == "params" else 0.0
        num += np.sum((np.asarray(leaves[path], np.float64) - r) ** 2)
        den += np.sum((np.asarray(r, np.float64) - base) ** 2)
    return float(np.sqrt(num / den))


def test_bfloat16_step_matches_jax():
    p0, s0, jax_bf16_m, jax_bf16, _ = jax_step("v8", "detect", "bfloat16")
    _, _, jax_f32_m, jax_f32, _ = jax_step("v8", "detect", "float32")
    got_m, got, _ = port_step("v8", "detect", "bfloat16", p0, s0)
    assert got_m[0]["num_fg"] > 0 and np.isfinite(got_m[0]["grad_norm"])
    for want in (jax_bf16_m, jax_f32_m):
        np.testing.assert_allclose(got_m[0]["loss"], want[0]["loss"], rtol=2e-2)
    start = _flat({"params": p0})
    for kind in ("params", "batch_stats"):
        ours, theirs = _distance(got, jax_f32, start, kind), _distance(jax_bf16, jax_f32, start, kind)
        assert ours <= 1.5 * theirs, (kind, ours, theirs)
