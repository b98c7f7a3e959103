"""kbps: all bits the window coded, per frame, at the configuration's
frame rate, in kbit/s."""


def read(run):
    rate = run.config["video"]["frame_rate"]
    return run.window_bits / run.frames * rate / 1000.0
