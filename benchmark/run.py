"""The benchmark of homerhevc_torch, the PyTorch and CUDA HEVC encoder.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Runs one cell of BENCHMARK.json on the CUDA device: set-up (content
from the seed, the encoder, the stream's first frames), a measured
window of `--seconds`, then the comparison with the reference (the
window's stream decoded by a conformant decoder, against the encoder's
reconstructions, the source frames and the configuration's
guarantees).  With --trace 0 it reports the cell's end-to-end metrics,
with --trace 1 its per-layer metrics from a traced part of the window.
The last line of standard output is one JSON object; the numbers that
decide `correct` are the last lines of standard error and the last key
of that object.  Exits non-zero, with no result, without the CUDA
devices the cell needs, or when JAX or the JAX package is loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_of(cell, run, judged, trace: bool) -> dict:
    """The result line: metrics, device and the compared numbers, each
    with its limit (last)."""
    import harness
    correct, checks = harness.decide(cell, judged)
    specs = cell["per_layer"] if trace else cell["end_to_end"]
    attempted = run.traced_frames + run.frames
    res = dict(correct=correct, attempted=attempted,
               failed=attempted - judged["decoded_window"],
               metrics=harness.metrics_of(run, specs),
               device=dict(platform="gpu", kind=run.device_kind,
                           count=cell["workload"]["chips"],
                           memory_peak_bytes=run.memory_peak_bytes))
    if trace and run.traced is not None:
        from frozen import trace_math
        res["device"]["busy_s"] = trace_math.busy_us(
            [(a, b) for _, a, b in run.traced["device"]]) / 1e6
        res["device"]["window_s"] = run.traced["wall_s"]
        res["breakdown"] = harness.breakdown(run.traced)
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    a = parse(argv)
    if a.trace:
        # the program's stage accumulators are read at import
        os.environ["HOMERHEVC_PROFILE"] = "1"
    import harness
    cell = harness.load_cell(a.workload)
    try:
        run, judged = harness.run_cell(a.workload, a.seed, a.seconds,
                                       bool(a.trace), t_process=T_PROCESS,
                                       cell=cell)
    except harness.NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    res = result_of(cell, run, judged, bool(a.trace))
    for k in ("first_breaks", "decoder_errors", "decoder_warnings",
              "missing_recons"):
        if judged[k]:
            print(f"[bench] {k}: {judged[k]}", file=sys.stderr)
    print(f"[bench] compared {judged['compared_frames']} reconstructions, "
          f"{judged['pictures']} pictures", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
