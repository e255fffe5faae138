"""Readings for the limits of a cell's comparison, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process (so set-up is paid once for the imports
and the kernel build): one run of the cell at its own size and load with
a window of ``--seconds``, the comparison of what that window produced
with the plain reference (the program's reading), and the control's
reading: the reference in fp8 put in the program's place, judged by the
harness's own verdict against the same limits (``control_correct``,
which has to come out false). One JSON line a seed. ``PERF.md`` gives
the readings each limit in ``benchmark/limits/`` was set from.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as _run  # noqa: E402,F401  (the run's environment: caches, no JAX)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(spec, args.workload, seed, args.seconds, False, control=True)
        print(json.dumps({
            "seed": seed, "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
            "program": {k: c["value"] for k, c in r["checks"].items()},
            "control": {k: c["value"] for k, c in r["control"].items()},
            "control_correct": r["control_correct"],
            "limits": {k: c["limit"] for k, c in r["checks"].items()},
            "metrics": {k: m["value"] for k, m in r["metrics"].items()},
            "run_s": time.perf_counter() - t0,
        }), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
