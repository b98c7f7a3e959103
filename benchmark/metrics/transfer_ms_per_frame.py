"""transfer_ms_per_frame (layer api): the program's transfer spans
(the worker's one device-to-host pull of a
chunk's records) over the window, per frame.  Only a run with the
program's spans on has it."""
from program_spans import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "transfer")
