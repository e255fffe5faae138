"""One run of one cell: set-up, the measured window, the per-layer
readings, and the comparison with the plain reference.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that entry names; its
traffic mix in ``benchmark/traffic/<traffic>.json``, whose ``generator``
names the general generator in ``benchmark/generators/``; the limits of its
comparison in ``benchmark/limits/<cell>.json``; each per-layer metric in
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from benchmark.trace import DeviceTrace, Spans

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "pathway_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")


def config_of(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits_of(workload: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload}.json").read_text())


def generator_of(traffic: dict):
    return importlib.import_module(f"benchmark.generators.{traffic['generator']}")


def metric_module(name: str):
    """``benchmark/metrics/<name>.py``, loaded by its path (the names
    hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, kind: str, workload: str) -> list[dict]:
    """The cell's end_to_end or per_layer entries."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(readings: dict, limits: dict) -> tuple[dict, bool]:
    """Each reading beside its limit, and whether every one is a number
    at or under it. The one verdict for the program's readings and the
    control's: a reading that is not a finite number fails."""
    checks = {
        name: {"value": value if math.isfinite(value) else None, "limit": limits[name]["limit"]}
        for name, value in readings.items()
    }
    ok = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return checks, ok


def run_cell(
    spec: dict, workload: str, seed: int, seconds: float, trace: bool, *,
    device: str = "cuda", t_start: float | None = None, model: dict | None = None,
    traffic: dict | None = None, limits: dict | None = None, control: bool = False,
) -> dict:
    """One run; returns the result object and, under ``checks``, each
    number compared with its limit. `model`, `traffic` and `limits`
    replace the cell's own (the CPU tests run a cell at a tiny size).
    With `control`, the control's readings are judged against the same
    limits by :func:`judge`: ``control`` and ``control_correct``."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell_of(spec, workload)
    model = model or config_of(spec, cell["config"])["model"]
    traffic = traffic or traffic_of(cell["traffic"])
    limits = limits or limits_of(workload)
    generator = generator_of(traffic)
    import_s = time.perf_counter() - t_start
    import pathway_tpu_torch  # noqa: F401  (timed apart: the port's import)

    port_import_s = time.perf_counter() - t_start - import_s
    on_card = torch.device(device).type == "cuda"
    spans = Spans()
    tracer = DeviceTrace(spans) if trace else None
    run = generator.Run(model, traffic, seed, device, spans)
    win = run.window(seconds, tracer)
    setup_s = win["t0"] - t_start
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    rec = dict(win["rec"], spans=dict(spans.seconds), model=model)
    rec["trace"] = tracer.summary() if tracer is not None else None

    if trace:
        metrics = {}
        for m in metrics_for(spec, "per_layer", workload):
            value = metric_module(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(win["e2e"], setup_s=setup_s)
        metrics = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in metrics_for(spec, "end_to_end", workload)
        }

    run.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, within = judge(run.check(), limits)
    reference_s = time.perf_counter() - t_ref
    correct = win["attempted"] > 0 and win["failed"] == 0 and within
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": memory_peak,
    }
    result = {
        "correct": correct, "attempted": win["attempted"], "failed": win["failed"],
        "metrics": metrics, "device": device_info,
    }
    if trace:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {
            "device_ops": rec["trace"]["device_ops"], "idle_gaps": rec["trace"]["idle_gaps"],
        }
    if control:
        result["control"], result["control_correct"] = judge(run.control(), limits)
    result["setup_phases"] = dict(run.setup_phases, import_s=import_s, port_import_s=port_import_s)
    result["reference_s"] = reference_s
    result["checks"] = checks
    return result
