"""On the card: each cell's run at its own size comes out correct, and
the control comes out not correct.  Marked `chip`; each test looks for
a CUDA device itself and skips without one.  On the card:

    python -m pytest benchmark/tests -m chip
"""
import json
import os
import subprocess
import sys

import pytest

import harness

CELLS = ["ldp720.chunk4", "ai720.chunk16"]


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _last_json(args):
    out = subprocess.run([sys.executable, *args], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    need_card()
    res = _last_json([os.path.join("benchmark", "run.py"), "--workload",
                      cell, "--seed", str(2**31 + 11), "--seconds", "5",
                      "--trace", "0"])[-1]
    assert res["correct"], res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    need_card()
    for res in _last_json([os.path.join("benchmark", "control.py"),
                           "--workload", cell, "--seeds", "1", "2", "3",
                           "--seconds", "5"]):
        assert not res["correct"], res
