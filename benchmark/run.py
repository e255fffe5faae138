"""The benchmark's one command.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card of this machine:
set-up from the seed, a measured window of ``--seconds``, then the
comparison with the plain reference. The last line of standard output is
the result as one JSON object (end-to-end metrics with ``--trace 0``,
per-layer metrics and the device trace with ``--trace 1``); the last
lines of standard error are the numbers compared, each beside its limit.
Exits non-zero, printing no result, without enough CUDA devices, or if a
JAX module or the JAX package is loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches at fixed paths inside the checkout, so that only a checkout's
# first run builds; no library may bring JAX into the process
for var, sub in (
    ("TRITON_CACHE_DIR", "triton"),
    ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
    ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
    ("CUDA_CACHE_PATH", "nv"),
):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.cell_of(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    result = harness.run_cell(
        spec, args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START,
    )
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that may not be loaded were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"setup {result['setup_phases']} reference_s {result['reference_s']:.3f}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
