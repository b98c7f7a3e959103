"""dispatch_ms_per_frame (layer api): the host clock around each
Encoder.encode_async or Encoder.encode call of the window, per frame."""


def read(run):
    return run.dispatch_s * 1e3 / run.frames
