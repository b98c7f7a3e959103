"""Faults planted in the program under the timed path, for the checks
that `correct` must fail: each plant(patch) replaces one function of
homerhevc_torch through `patch(owner, name, value)` (pytest's
monkeypatch.setattr in the tests, `Patches` in control.py)."""


def alter_token(patch):
    """A byte of every coded slice flipped where the entropy coder
    produces it."""
    from homerhevc_torch.entropy import binding
    real = binding.encode_slice

    def encode_slice(ccfg, rec):
        out = bytearray(real(ccfg, rec))
        out[len(out) // 2] ^= 0x10
        return bytes(out)
    patch(binding, "encode_slice", encode_slice)


def state_unchanged(patch):
    """A P chunk hands back its reference planes as its reconstruction;
    an all-intra wavefront step writes nothing."""
    from homerhevc_torch.models import inter_frame, intra_frame
    real = inter_frame.encode_p_chunk_packed

    def encode_p_chunk_packed(buf, ref_y, ref_u, ref_v, **kw):
        out = real(buf, ref_y, ref_u, ref_v, **kw)
        out.update(recon_y=ref_y, recon_u=ref_u, recon_v=ref_v)
        return out
    patch(inter_frame, "encode_p_chunk_packed",
                        encode_p_chunk_packed)
    patch(intra_frame, "_wavefront_step",
                        lambda *args: None)


def half_left_out(patch):
    """Half of each chunk's frames left out: the first half is coded in
    their place."""
    from homerhevc_torch.api import Encoder
    for name in ("_dispatch_p_chunk", "_dispatch_i_chunk"):
        real = getattr(Encoder, name)

        def dispatch(self, frames, *a, _real=real, **kw):
            frames = list(frames)
            half = len(frames) // 2
            if half:
                frames[half:2 * half] = frames[:half]
            return _real(self, frames, *a, **kw)
        patch(Encoder, name, dispatch)


FAULTS = {"token": (alter_token, {"recon_diff_px", "decode_errors"}),
          "state": (state_unchanged, {"recon_diff_px"}),
          "half": (half_left_out, {"worst_frame_mse_y"})}


class Patches:
    """setattr that remembers what it replaced; undo() puts it back."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            setattr(*self.saved.pop())
