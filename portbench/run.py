"""Run one cell of the benchmark once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (building or loading the kernels, making the inputs and weights from
the seed, warming the cell's shapes) counts as ``setup_s``.  Then a closed
loop for ``--seconds``: each call is timed from the program's call until
its answers are on the host, and the next goes out when it is answered.
``--trace 1`` runs a slice of the window under the profiler and reports the
per-layer metrics instead of the end-to-end ones.  After the window the
program's answers at the sampled calls are compared with the plain
reference; each number is printed beside its limit, last on standard error
and under ``checks`` in the result line.  Exits non-zero, printing no
result, without a card, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "icp_slam_yolo_tpu")


def cache_environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout;
    nothing of JAX or flax pulled in by a library.  PyTorch keeps its
    default host threads, as a user runs it."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def cell_metrics(name: str) -> tuple[list, list, int]:
    """The cell's end-to-end and per-layer metric entries and its chips."""
    from portbench.spec import benchmark

    bench = benchmark()
    chips = next((w.get("chips", 1) for w in bench["workloads"] if w["name"] == name), 1)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)], chips


def window(session, seconds: float, trace_calls: int, device):
    """The closed loop; returns ``(call seconds, window seconds, traced
    calls' Trace or None, seconds the traced slice took)``.  It runs at
    least until the last call the check samples.  With ``trace_calls``, once
    a third of the window has passed the next calls run under the profiler,
    and their times are kept out of the host statistics."""
    from portbench.trace import traced

    times, tr, traced_s = [], None, 0.0

    def one(j: int, mark: bool = False, into: list = times) -> float:
        session.before(j, mark)
        a = time.perf_counter()
        session.call(j)
        end = time.perf_counter()
        into.append(end - a)
        session.after(j)
        return end

    t0 = time.perf_counter()
    i = 0
    while True:
        if trace_calls and tr is None and time.perf_counter() - t0 >= seconds / 3.0:
            # the slice's pattern once untraced first (the traced calls keep
            # their inputs for the work count), so that the allocator holds the
            # blocks this asks for and the trace sees no cudaMalloc of it
            for j in range(i, i + trace_calls):
                one(j, True)
            session.drop_traced()
            i += trace_calls
            first, marks, n_before = i, [], len(session.dispatch_s)
            a = time.perf_counter()
            tr = traced(lambda: [one(j, True, marks) for j in range(first, first + trace_calls)], device)
            traced_s = time.perf_counter() - a
            del session.dispatch_s[n_before:]
            session.traced = list(range(first, first + trace_calls))
            times += marks
            i += trace_calls
            continue
        end = one(i)
        i += 1
        if end - t0 >= seconds and i > max(session.sampled, default=-1):
            return times, end - t0, tr, traced_s


def run(cell, seed: int, seconds: float, trace: bool, device, e2e: list, per_layer: list, chips: int = 1):
    """Set up, run the window, read the metrics and check the answers:
    ``(result line as a dict, checks)``.  ``device`` is the card; the tests
    drive it on the CPU with ``trace`` off."""
    import torch

    from portbench.spec import entry_module, metric_reader

    session = entry_module(cell).setup(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        # the peak from here on: the program's state and working set and the
        # inputs, not what making the weights took for a moment
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    times, window_s, tr, traced_s = window(session, seconds, int(cell.check.get("trace_calls", 8)) if trace else 0,
                                           device)
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    calls = len(times)
    rate = calls * session.units_per_call / window_s
    metrics, breakdown = {}, None
    if trace:
        # the rate outside the profiler's slice, which it slows
        untraced = (calls - len(session.traced)) * session.units_per_call / (window_s - traced_s)
        ctx = types.SimpleNamespace(kind=session.kind, trace=tr, traced=len(session.traced),
                                    dispatch_s=list(session.dispatch_s), work=session.layer_work(), rate=untraced,
                                    units_per_call=session.units_per_call)
        for m in per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        from portbench.trace import breakdown as make_breakdown

        breakdown = make_breakdown(tr)
    else:
        values = {session.rate_metric: rate, session.tail_metric: percentile(times, 95) * 1e3, "setup_s": setup_s}
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    session.release()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    checks = session.judge()
    print(f"portbench: {cell.name} seed {seed}: {calls} calls in {window_s:.3f} s, setup {setup_s:.2f} s",
          file=sys.stderr)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": peak}
    if tr is not None:
        device_info.update(busy_s=tr.busy_us / 1e6, window_s=tr.window_us / 1e6)
    line = {"correct": all(c.ok for c in checks), "attempted": calls * session.units_per_call,
            "failed": session.failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_environment()

    import torch

    from portbench.spec import load_cell

    cell = load_cell(args.workload)
    e2e, per_layer, chips = cell_metrics(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, checks = run(cell, args.seed, args.seconds, bool(args.trace), device, e2e, per_layer, chips)
    from icp_slam_yolo_tpu_torch.ops.pallas import _lib

    if _lib.build_seconds is not None:
        print(f"portbench: this run built the kernels in {_lib.build_seconds:.1f} s (inside setup_s)", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of {bad} were loaded in this process", file=sys.stderr)
        return 4
    print(f"portbench: card {power_limit()}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
