"""p_program_host_ms_per_frame (layer models.inter_frame): the host
clock around each call into the P frame program
(inter_frame.encode_p_chunk_packed, spans/models.inter_frame.json) over
the window, per frame: the time the host spends launching a P frame's
work.  Only a traced run clocks it."""


def read(run):
    s = run.spans.get("models.inter_frame")
    return None if s is None else s * 1e3 / run.frames
