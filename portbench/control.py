"""The check's two readings for a cell on the card, several seeds in one
process: each seed's sound run (the program through the sampled calls,
judged against the reference) and its control (the reference in the
precision below the configuration's, put in the program's place).  The
benchmark's own runs never run this; its output sets the limits.

    python3 portbench/control.py --workload <cell> --seeds <n> <n> ...

Prints one JSON line a seed: ``{"seed", "program": {number: value},
"control": {number: value}}``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.run import cache_environment  # noqa: E402


def readings(cell, seed: int, device, control: bool = True) -> dict:
    import torch

    from portbench.spec import entry_module

    session = entry_module(cell).setup(cell, seed, device)
    for i in range(max(session.sampled) + 1):
        session.before(i)
        session.call(i)
        session.after(i)
    session.release()
    out = {"seed": seed, "program": {c.name: c.value for c in session.judge()}}
    if control:
        out["control"] = {c.name: c.value for c in session.judge(control=True)}
    del session
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true", help="the program's readings only")
    args = ap.parse_args()
    cache_environment()
    import torch

    from portbench.spec import load_cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = readings(cell, seed, torch.device("cuda", 0), not args.no_control)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
