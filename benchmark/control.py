"""The control and the planted faults, at a cell's own size on the chip.

    python benchmark/control.py --workload <cell> --seeds 1 2 3
                                --seconds <s> [--fault token|state|half]

Without --fault, runs the control: the program at QP one step coarser
than the configuration states (the next lower quantizer precision),
judged against the configuration's own guarantees.  With --fault, runs
the program with that fault planted (faults.py).  One result line per
seed, in one process, with the compared numbers and their limits; the
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    import harness
    from faults import FAULTS, Patches
    cell = harness.load_cell(a.workload)
    overrides = None
    patches = Patches()
    if a.fault:
        FAULTS[a.fault][0](patches)
    else:
        overrides = dict(qp=cell["config"]["encoder"]["qp"] + 1)
    try:
        for seed in a.seeds:
            run, judged = harness.run_cell(a.workload, seed, a.seconds,
                                           False, cell=cell,
                                           encoder_overrides=overrides)
            correct, checks = harness.decide(cell, judged)
            print(json.dumps(dict(
                workload=a.workload, seed=seed, fault=a.fault or "qp+1",
                correct=correct, frames=run.frames,
                checks={k: c["value"] for k, c in checks.items()})),
                flush=True)
    finally:
        patches.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
