"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds, for
the tests that drive a whole run without a chip."""
import copy

import harness

SIZES = {"ldp720.chunk4": (128, 64), "ai720.chunk16": (256, 128)}


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.load_cell(name))
    w, h = SIZES[name]
    conf = cell["config"]
    for part in ("video", "encoder", "guarantees"):
        conf[part].update(width=w, height=h)
    cell["traffic"].update(pool_frames=8,
                           content=dict(plants=4, diverge=16, quads=16))
    if cell["traffic"]["shape"] == "chunks":
        conf["encoder"]["intra_frames_per_launch"] = 2
        conf["guarantees"]["tile_grid"] = [2, 1]     # tile_auto at 256x128
    return cell


def run_tiny(name: str, seed: int = 2**31 + 7, trace: bool = False,
             trace_frames: int = 0, **kw) -> tuple:
    """(correct, checks, run) of the tiny cell on the CPU.  A traced part
    here records no device operation (the CPU has no device trace)."""
    cell = tiny_cell(name)
    cell["traffic"]["trace_frames"] = trace_frames
    run, judged = harness.run_cell(name, seed, 0.1, trace, device="cpu",
                                   cell=cell, log=lambda *a: None, **kw)
    correct, checks = harness.decide(cell, judged)
    return correct, checks, run
