"""The profiler's window and what the per-layer readers read from it.

A traced slice of calls runs under ``torch.profiler`` between two idle
spins of the card: the tracer may miss device work of the first and last
milliseconds it is on, and the spins, left out of everything read, keep
the calls clear of both ends.  The window is the time between the end of
the first spin and the start of the second.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SPIN_CYCLES = 20_000_000  # ~10 ms of a kernel that does nothing


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    kernels: list      # device events inside the window, by start
    host: list         # host-side events inside the window
    window_us: float
    busy_us: float     # union of the device events' intervals


def spin(device) -> None:
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize(device)


def _events(prof):
    """``(device events, host events)`` as `Event` rows."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
        dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
        row = Event(e.name(), float(start), float(start + dur))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(row)
        else:
            host.append(row)
    return dev, host


def _union(events) -> float:
    total, end = 0.0, -float("inf")
    for e in sorted(events, key=lambda e: e.start_us):
        if e.end_us > end:
            total += e.end_us - max(e.start_us, end)
            end = e.end_us
    return total


def traced(fn, device) -> Trace:
    """Run ``fn()`` in the profiler's window; raises when the trace holds no
    device work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spin(device)
        fn()
        torch.cuda.synchronize(device)
        spin(device)
    dev, host = _events(prof)
    spins = sorted((e for e in dev if "spin" in e.name.lower()), key=lambda e: e.start_us)
    if len(spins) < 2:
        raise RuntimeError(f"profiler: {len(spins)} spin kernels recorded, not 2")
    lo, hi = spins[0].end_us, spins[-1].start_us
    kernels = sorted((e for e in dev if "spin" not in e.name.lower() and lo <= e.start_us <= hi),
                     key=lambda e: e.start_us)
    if not kernels:
        raise RuntimeError("profiler: no device work recorded in the window")
    host = [e for e in host if e.end_us >= lo and e.start_us <= hi]
    clipped = [Event(k.name, k.start_us, min(k.end_us, hi)) for k in kernels]
    return Trace(kernels, host, hi - lo, _union(clipped))


def time_by_name(trace: Trace, calls: int, match) -> float:
    """Device seconds of the kernels whose name ``match`` accepts: per
    name, the mean over the records kept times the launches a call (the
    records rounded up to a multiple of ``calls``), so a record the tracer
    lost does not lower the time."""
    by: dict[str, list] = {}
    for k in trace.kernels:
        if match(k.name):
            by.setdefault(k.name, []).append(k.end_us - k.start_us)
    total = 0.0
    for durs in by.values():
        per_call = -(-len(durs) // calls)
        total += sum(durs) / len(durs) * per_call * calls
    return total / 1e6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each gap named by the innermost host event spanning its middle."""
    by: dict[str, float] = {}
    for k in trace.kernels:
        by[k.name] = by.get(k.name, 0.0) + (k.end_us - k.start_us) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], trace.kernels[0].start_us
    for k in trace.kernels:
        if k.start_us > end:
            gaps.append((end, k.start_us))
        end = max(end, k.end_us)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        spans = [h for h in trace.host if h.start_us <= mid <= h.end_us]
        label = min(spans, key=lambda h: h.end_us - h.start_us).name if spans else "(no host event)"
        named.append([label[:80], (g1 - g0) / 1e6])
    return {"device_ops": [[n[:80], s] for n, s in ops], "idle_gaps": named}
