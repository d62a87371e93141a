"""Tracing and profiling: the counterpart of the JAX package's
``utils/profiling.py``.

`StageTimer` accumulates named per-stage wall times with context-manager
scopes; with ``sync`` it waits for the device work behind a stage's result
before it stops the clock, so a time covers the kernels the stage queued.
`trace` wraps ``torch.profiler`` and writes a Chrome / TensorBoard trace of
the CPU and CUDA activity into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _wait_for(result) -> None:
    """Wait for the card when any tensor in ``result`` (a tensor, or any
    nesting of tuples, lists and dicts) lies on it; CPU tensors need no
    wait."""
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


class StageTimer:
    """Accumulating named timers: ``with timer("icp", result): ...``, or
    ``timer.measure("icp", fn, *args)``; ``report()`` -> dict."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                _wait_for(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def measure(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            _wait_for(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(self.totals)
        }

    def summary(self) -> str:
        return "\n".join(
            f"{k:24s} {v['count']:6d} calls  {v['mean_ms']:9.3f} ms/call  {v['total_s']:8.3f} s"
            for k, v in self.report().items()
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    card; on exit the trace is written to ``log_dir`` as a Chrome trace
    (``trace_<pid>.json``; chrome://tracing, Perfetto or TensorBoard's
    profiler plugin read it)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
