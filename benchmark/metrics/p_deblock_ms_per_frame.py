"""p_deblock_ms_per_frame (layer models.inter_frame): the host time of
the P frame program's p.deblock span (deblocking) over the window,
per frame.  Only a run with the program's spans on has it."""
from program_spans import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "p.deblock")
