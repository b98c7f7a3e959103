"""BENCHMARK.json: every cell resolves its files by name, and every
name, unit and entry keeps to the manifest's rules."""
import json
import os
import re

import pytest

import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    MAN = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    for key in ("encoder", "video", "guarantees", "limits"):
        assert key in c["config"]
    for key in ("shape", "api", "pool_frames", "content", "warm_frames",
                "trace_frames"):
        assert key in c["traffic"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert "setup_s" in [m["name"] for m in c["end_to_end"]]
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


def all_names():
    yield from (c["name"] for c in MAN["configs"])
    for w in MAN["workloads"]:
        yield w["name"]
        yield w["config"]
        yield w["traffic"]
    yield from (m["name"] for m in METRICS)
    for c in MAN["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entry(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in MAN["end_to_end"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_each_layer_metric_moves_what_its_cell_reports(cell):
    c = harness.load_cell(cell)
    reported = {m["name"] for m in c["end_to_end"]}
    assert {m["moves"] for m in c["per_layer"]} <= reported - {"setup_s"}
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]


def test_manifest_shape():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert len({w["name"] for w in MAN["workloads"]}) == len(CELLS)
    assert len({(w["config"], w["traffic"])
                for w in MAN["workloads"]}) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(MAN["paths"][0] + "/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
