"""Read the compared numbers of one cell over many seeds in one process: the
program's (its sound runs set each limit's lower reading) or the control's
(its smallest reading sets the upper one).  The benchmark's own runs never
run this.

    python3 -m benchmark_torch.readings --workload <cell> --seeds 11,12,13 \\
        [--seconds 2] [--control]

Each seed runs the cell as :func:`benchmark_torch.run.run_cell` does, a
short window at the cell's own size and load, and checks as many answers
as a run does; with ``--control`` the configuration's control stands in the
program's place (no warm-up).  One JSON line a seed, then the largest and
smallest reading of each compared number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from benchmark_torch import run, spec


def read(cell, seeds: list, seconds: float, control: bool, device: str = "cuda",
         out=print) -> dict:
    """``{number: [readings]}`` over ``seeds``, one line printed a seed."""
    got = {}
    for seed in seeds:
        fac = run.control_factorizer(cell.config) if control else None
        result, _ = run.run_cell(cell, seed, seconds, False, device=device, factorizer=fac,
                                 warmup=not control, out=lambda _line: None)
        out(json.dumps({"seed": seed, "control": control, "correct": result["correct"],
                        "attempted": result["attempted"], "checks": result["checks"]}))
        for key, c in result["checks"].items():
            got.setdefault(key, []).append(c["value"])
        del fac, result
        gc.collect()
    return got


def _order(x) -> float:
    """A reading that printed as null (NaN or infinite) orders above all."""
    return float("inf") if x is None else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    run.pin_caches()
    run.few_threads()
    cell = spec.cell(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    got = read(cell, [int(s) for s in args.seeds.split(",")], args.seconds, args.control)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "max": {k: max(v, key=_order) for k, v in got.items()},
                      "min": {k: min(v, key=_order) for k, v in got.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
