"""drain_wait_ms_per_frame (layer api): the program's api.drain_wait spans
(the dispatching thread waiting for the worker's
finished chunks) over the window, per frame.  Only a run with the
program's spans on has it."""
from program_spans import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "api.drain_wait")
