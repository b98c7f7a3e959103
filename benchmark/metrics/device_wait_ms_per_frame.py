"""device_wait_ms_per_frame (layer api): the program's api.device_wait spans
(the worker waiting for the card to finish a
chunk) over the window, per frame.  Only a run with the
program's spans on has it."""
from program_spans import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "api.device_wait")
