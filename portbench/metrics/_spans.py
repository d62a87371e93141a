"""What the span readers share: the program's stage spans over the traced
calls (`icp_slam_yolo_tpu_torch.utils.profiling.spans`: each record a
span's name, parent, counts and device interval between timing events),
or ``None`` where the cell is of another kind, the program keeps no span
records, or their roots are not the traced calls one for one.

A span's interval on the device holds the time the device waited for the
host inside it.  `busy_ms_per_call` reads the device operations' time
inside the interval instead: the timing events are placed on the trace's
clock (`anchor_us`) and the trace's device operations are cut to each
interval.  What a stage reads depends on where its span is placed in the
program."""

import bisect
import statistics

from icp_slam_yolo_tpu_torch.utils import profiling

ROOTS = {"slam": "slam.step", "detect": "detect.batch"}


def records(ctx, kind: str):
    read = getattr(profiling, "spans", None)
    if ctx.kind != kind or not ctx.traced or read is None:
        return None
    recs = read()
    roots = [r.name for r in recs if r.parent is None]
    if len(roots) != ctx.traced or any(name != ROOTS[kind] for name in roots):
        return None
    return recs


def merged(events) -> list:
    """The union of the events' intervals (us), sorted and disjoint."""
    out = []
    for e in sorted(events, key=lambda e: e.start_us):
        if out and e.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end_us)
        else:
            out.append([e.start_us, e.end_us])
    return [tuple(iv) for iv in out]


def covered_us(intervals: list, start: float, end: float) -> float:
    """The part of [start, end] that the sorted, disjoint ``intervals`` cover."""
    total = 0.0
    for a, b in intervals[max(bisect.bisect_right(intervals, (start,)) - 1, 0):]:
        if a >= end:
            break
        total += max(0.0, min(b, end) - max(a, start))
    return total


def anchor_us(host, roots, ref):
    """The trace time (us) of the event ``ref``: for each root, the end of
    the host's first event record inside its host event (the record of its
    entry event) less that event's time after ``ref`` on the device; the
    median over the roots.  A root opened while the device idles, as each
    call of a closed loop is, reads its own record's time; one opened on a
    busy device reads early, and the median passes over it.  ``None``
    without a root's host event or record."""
    name = roots[0].name
    opened = sorted((e for e in host if e.name == name), key=lambda e: e.start_us)
    recorded = sorted((e for e in host if "EventRecord" in e.name), key=lambda e: e.start_us)
    starts = [e.start_us for e in recorded]
    if len(opened) != len(roots):
        return None
    found = []
    for root, e in zip(roots, opened):
        i = bisect.bisect_left(starts, e.start_us)
        if i == len(recorded) or recorded[i].start_us > e.end_us:
            return None
        found.append(recorded[i].end_us - ref.elapsed_time(root.start) * 1e3)
    return statistics.median(found)


def busy_ms_per_call(ctx, kind: str, name: str):
    """Device ms of the operations inside the intervals of the spans called
    ``name``, summed, over the traced calls."""
    recs = records(ctx, kind)
    if recs is None:
        return None
    mine = [r for r in recs if r.name == name]
    roots = [r for r in recs if r.parent is None]
    if not mine or any(r.end is None for r in mine + roots):
        return None
    ref = roots[0].start
    at = anchor_us(ctx.trace.host, roots, ref)
    if at is None:
        return None
    busy = merged(ctx.trace.kernels)
    total = sum(covered_us(busy, at + ref.elapsed_time(r.start) * 1e3, at + ref.elapsed_time(r.end) * 1e3)
                for r in mine)
    return total / 1e3 / ctx.traced


def count_per_call(ctx, kind: str, name: str, key: str):
    """The ``key`` counts of the spans called ``name``, summed, over the
    traced calls."""
    recs = records(ctx, kind)
    if recs is None:
        return None
    found = [r.counts.get(key, 0) for r in recs if r.name == name]
    return sum(found) / ctx.traced if found else None
