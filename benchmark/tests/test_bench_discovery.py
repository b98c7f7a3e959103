"""A configuration, a traffic mix and a per-layer metric added as new
files, with entries added to BENCHMARK.json, are found by name with no
edit to any file the benchmark already has."""
import json
import os
import shutil

import harness


def test_added_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)

    conf = json.loads((root / "benchmark/configs/port-ldp1-e720-qp32.json")
                      .read_text())
    conf.update(name="port-ldp1-e720-qp27")
    conf["encoder"]["qp"] = conf["guarantees"]["slice_qp"] = 27
    (root / "benchmark/configs/port-ldp1-e720-qp27.json").write_text(
        json.dumps(conf))
    traffic = json.loads((root / "benchmark/traffic/chunked.json")
                         .read_text())
    traffic.update(api="encode")
    (root / "benchmark/traffic/sync.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/frames_in_window.py").write_text(
        "def read(run):\n    return float(run.frames)\n")

    qp27 = "port-ldp1-e720-qp27"
    man["configs"].append(dict(man["configs"][0], name=qp27,
                               file=f"benchmark/configs/{qp27}.json"))
    man["workloads"].append(dict(name="ldp720.sync", config=qp27,
                                 traffic="sync", chips=1, why="test"))
    man["per_layer"].append(dict(name="frames_in_window", unit="frames",
                                 better="higher", source="host_clock",
                                 layer="api", moves="fps",
                                 workloads=["ldp720.sync"]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = harness.load_cell("ldp720.sync", root=str(root))
    assert cell["config"]["encoder"]["qp"] == 27
    assert cell["traffic"]["api"] == "encode"
    names = [m["name"] for m in cell["per_layer"]]
    assert "frames_in_window" in names
    assert "p_program_host_ms_per_frame" not in names   # other cells' only
    run = harness.Run(cell, 1, 1.0, True)
    run.frames = 12
    got = harness.metrics_of(run, [m for m in cell["per_layer"]
                                   if m["name"] == "frames_in_window"])
    assert got == {"frames_in_window": {"value": 12.0, "unit": "frames"}}
    # the old cells still resolve, and no file the benchmark had changed
    assert harness.load_cell("ldp720.chunk4", root=str(root))
    for p, data in before.items():
        assert p.read_bytes() == data, p
