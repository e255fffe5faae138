"""BENCHMARK.json against the rules it must keep, and every file a
cell, configuration or metric is found by."""

import json
import math
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def _cells_of(metric: dict) -> list[str]:
    return metric.get("workloads", [c["name"] for c in SPEC["workloads"]])


def test_bench_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_bench_names_units_and_text():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for n in names + [w["name"] for w in SPEC["workloads"]] + list(E2E) + [m["name"] for m in SPEC["per_layer"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)


def test_bench_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_bench_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert TEXT.match(metric["layer"])
    moved = E2E[metric["moves"]]
    # the metric it moves is reported in every cell that reports this one
    assert set(_cells_of(metric)) <= set(_cells_of(moved))
    mod = harness.metric_module(metric["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (metric["unit"], metric["layer"], metric["moves"])
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_bench_cell_files(cell):
    cfg = harness.config_of(SPEC, cell["config"])
    traffic = harness.traffic_of(cell["traffic"])
    harness.generator_of(traffic)
    limits = harness.limits_of(cell["name"])
    assert limits and all(c["limit"] > 0 for c in limits.values())
    assert cfg["name"] == cell["config"]
    e2e = harness.metrics_for(SPEC, "end_to_end", cell["name"])
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.metrics_for(SPEC, "per_layer", cell["name"])
    # every configuration is used by a cell, and each pair appears once
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_bench_configuration_file(entry):
    cfg = harness.config_of(SPEC, entry["name"])
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    pub, model = cfg["published"], cfg["model"]
    if "hidden_size" in pub:  # BERT's keys
        widths = (pub["hidden_size"], pub["num_attention_heads"], pub["num_hidden_layers"], pub["intermediate_size"], pub["vocab_size"])
    else:  # GPT-2's keys
        widths = (pub["n_embd"], pub["n_head"], pub["n_layer"], pub["n_inner"] or 4 * pub["n_embd"], pub["vocab_size"])
    assert widths == (model["d_model"], model["n_heads"], model["n_layers"], model["d_ff"], model["vocab_size"])
    assert entry["name"] in [w["config"] for w in SPEC["workloads"]]


def test_bench_run_seconds_fit_a_full_check():
    rs = SPEC["run_seconds"]
    cells = 24
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(len(SPEC["workloads"]) * 0.25))
