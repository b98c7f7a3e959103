"""fps: frames whose Annex-B bytes the client received, over the
window (first frame submitted to the return of the last bytes)."""


def read(run):
    return run.frames / run.window_s
