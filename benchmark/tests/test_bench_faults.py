"""Whole runs on the CPU at a small size, with the look for a chip
skipped: a sound run comes out correct; the control (the program at the
next coarser quantizer, QP 33, where the configuration states QP 32)
and each fault a cell can have, planted in the program under the timed
path, come out not correct, on the number named.  The exchange between
chips is not among the faults: every cell runs on one chip."""
import pytest

from bench_tiny import run_tiny
from faults import FAULTS

LDP, AI = "ldp720.chunk4", "ai720.chunk16"


@pytest.mark.parametrize("cell", [LDP, AI])
def test_sound_run_is_correct(cell):
    correct, checks, run = run_tiny(cell)
    assert correct, checks
    assert run.frames and run.window_bits > 0


@pytest.mark.parametrize("cell", [LDP, AI])
def test_control_is_not_correct(cell):
    correct, checks, _ = run_tiny(cell, encoder_overrides=dict(qp=33))
    assert not correct
    assert checks["guarantee_breaks"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [LDP, AI])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    plant, numbers = FAULTS[fault]
    plant(monkeypatch.setattr)
    correct, checks, _ = run_tiny(cell)
    assert not correct
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert failed & numbers, checks


@pytest.mark.parametrize("cell,lose", [
    (LDP, "keep"), (AI, "keep"), (AI, "stack")])
def test_lost_reconstructions_are_not_correct(cell, lose, monkeypatch):
    """A reconstruction that is due but was not handed over (the
    encoder's reference planes kept elsewhere, or an all-intra chunk's
    stack no longer found) fails the run instead of shrinking the
    comparison."""
    import harness
    if lose == "keep":
        monkeypatch.setattr(harness._Client, "_keep_recon", lambda self: None)
    else:
        monkeypatch.setattr(harness, "_frames_of", lambda t, stacked: t[None])
    correct, checks, _ = run_tiny(cell)
    assert not correct
    assert checks["recon_diff_px"]["value"] > 0, checks


@pytest.mark.parametrize("cell", [LDP, AI])
def test_traced_part_comes_before_the_window(cell, monkeypatch):
    """The traced part's frames are judged with the window's, and the
    window after it is clocked alone.  The CPU has no device profiler:
    the traced part records nothing here."""
    import harness
    monkeypatch.setattr(harness, "_trace_start", lambda: (None, 0.0))
    monkeypatch.setattr(harness, "_trace_stop", lambda p, t0, n, sync: dict(
        device=[], wall_s=1.0, frames=n, stop_s=0.0, read_s=0.0))
    n = 2 if cell == AI else 4
    correct, checks, run = run_tiny(cell, trace=True, trace_frames=n)
    assert correct, checks
    assert run.traced_frames == n and run.traced["frames"] == n
    assert run.frames >= 1 and run.window_bits > 0


def test_traced_run_clocks_the_layer_spans():
    from homerhevc_torch.models import inter_frame
    real = inter_frame.encode_p_chunk_packed
    correct, _, run = run_tiny(LDP, trace=True)
    assert correct
    assert run.spans["models.inter_frame"] > 0
    assert inter_frame.encode_p_chunk_packed is real     # unwrapped after
