"""What every entry gives the run, and the pieces entries share.

An entry module (``entries/<name>.py``) has ``setup(cell, seed, device) ->
Session``.  The run calls ``before(i)``, ``call(i)`` and ``after(i)`` for
each call ``i`` of the window, timing ``call`` alone; ``call`` ends with
the call's answers on the host.  After the window it reads
``layer_work()`` (the work of the calls ``before(i, True)`` marked traced,
for the per-layer readers),
then ``release()`` and ``judge()`` (the check against the reference).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Session:
    """Base of an entry's session (see the module docstring)."""

    units_per_call = 1        # robot-scans of a step, frames of a batch
    rate_metric = ""          # end-to-end name of units per second
    tail_metric = ""          # end-to-end name of the calls' 95th percentile (ms)
    kind = ""                 # what the per-layer readers key on: 'slam' or 'detect'

    def __init__(self):
        self.dispatch_s: list[float] = []  # host seconds from calling the program to its return, each call
        self.traced: list[int] = []        # indices of the calls inside the profiler's window
        self.sampled: set[int] = set()     # indices of the calls the check samples
        self.failed = 0

    def before(self, i: int, traced: bool = False) -> None:
        pass

    def call(self, i: int) -> None:
        raise NotImplementedError

    def after(self, i: int) -> None:
        pass

    def layer_work(self) -> dict:
        return {}

    def drop_traced(self) -> None:
        """Forget what ``before(i, True)`` kept."""

    def release(self) -> None:
        pass

    def judge(self, control: bool = False) -> list[Check]:
        raise NotImplementedError


def sampled_calls(check: dict, seed: int) -> list[int]:
    """The call indices the check samples: ``check["calls"]`` distinct
    indices drawn from the seed below ``check["within"]``; where
    ``check["maintenance_interval"]`` is given, the first is a maintenance
    step (``(tick + 1) % interval == 0`` for ``tick = first_tick + i``) and
    the second one that is not."""
    rng = np.random.default_rng([int(seed) % 2**63, 0])
    within, n = int(check["within"]), int(check["calls"])
    every = check.get("maintenance_interval")
    first = int(check.get("first_tick", 0))
    maint = [i for i in range(within) if every and (first + i + 1) % every == 0]
    other = [i for i in range(within) if not every or (first + i + 1) % every != 0]
    if not maint or not other or n < 2:
        return sorted(int(x) for x in rng.choice(within, size=n, replace=False))
    picks = [int(rng.choice(maint)), int(rng.choice(other))]
    rest = [i for i in range(within) if i not in picks]
    picks += [int(x) for x in rng.choice(rest, size=max(0, n - 2), replace=False)]
    return sorted(picks)
