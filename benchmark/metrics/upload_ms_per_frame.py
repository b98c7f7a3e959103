"""upload_ms_per_frame (layer api): the program's api.upload spans
(the dispatching thread staging a chunk's frames on the host and
uploading them) over the window, per frame.  Only a run with the
program's spans on has it."""
from program_spans import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "api.upload")
