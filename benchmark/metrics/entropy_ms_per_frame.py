"""entropy_ms_per_frame (layer entropy): the program's
stage("entropy") accumulator over the window, per frame.  Only a run
with the program's stage accumulators on has it."""


def read(run):
    s = run.stages.get("entropy")
    return None if s is None else s * 1e3 / run.frames
