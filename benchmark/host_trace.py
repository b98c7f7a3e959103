"""A traced run of one cell, with the device's idle time named by the
program's spans.

    python benchmark/host_trace.py --workload <cell> --seed <n>
                                   --seconds <s>

Runs `benchmark/run.py ... --trace 1` in this process (its lines as they
are, the result line last but one), then prints one more JSON line
from the traced part's device operations and the spans the program's
dispatching thread had open:

* idle_gaps_host: the ten longest idle gaps, each named by the
  innermost span open at its midpoint ("none" where none was);
* idle_by_host_span: idle seconds summed by that name, the ten largest;
* device_idle_unattributed_share: as the metric of that name;
* first_op_after_dispatch_us: the traced part's first device
  operation's start less the start of the first api.dispatch span that
  overlaps the traced part (at least 0 where the two clocks agree);
* ms_per_frame: every span name's total over the window, per frame,
  beside p_program_host_ms_per_frame and dispatch_ms_per_frame, which
  the benchmark clocks itself.
"""
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import run as bench_run     # noqa: E402


def host_line(run) -> dict:
    import program_spans as ps
    spans = ps.traced_host_spans(run)
    out = {}
    if spans:
        dev = run.traced["device"]
        first = min(a for _, a, _ in dev)
        dispatch = min(a for n, a, _ in spans if n == "api.dispatch")
        out = dict(idle_gaps_host=ps.idle_gaps_host(dev, spans),
                   idle_by_host_span=ps.idle_by_host_span(dev, spans),
                   device_idle_unattributed_share=ps.unattributed_idle_share(
                       dev, spans),
                   first_op_after_dispatch_us=first - dispatch)
    per_frame = {name: ps.span_ms_per_frame(run, name)
                 for name in sorted(run.stages)}
    per_frame["p_program_host_ms_per_frame"] = \
        run.spans.get("models.inter_frame", 0.0) * 1e3 / run.frames
    per_frame["dispatch_ms_per_frame"] = run.dispatch_s * 1e3 / run.frames
    out["ms_per_frame"] = per_frame
    return out


def main(argv=None) -> int:
    # the program's spans are switched on when it is imported
    os.environ["HOMERHEVC_PROFILE"] = "1"
    import harness
    runs = []
    real = harness.run_cell

    def run_cell(*a, **kw):
        got = real(*a, **kw)
        runs.append(got[0])
        return got
    harness.run_cell = run_cell
    try:
        rc = bench_run.main(list(sys.argv[1:] if argv is None else argv)
                            + ["--trace", "1"])
    finally:
        harness.run_cell = real
    if rc == 0 and runs:
        print(json.dumps(host_line(runs[0])), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
