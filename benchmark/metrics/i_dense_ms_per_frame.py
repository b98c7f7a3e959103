"""i_dense_ms_per_frame (layer models.intra_frame): the host time of
the all-intra chunk's i.dense spans (the dense decision, once per
frame) over the window, per frame.  Only a run with the program's
spans on has it."""
from program_spans import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "i.dense")
