"""homerhevc_torch — the HEVC encoder of homerhevc_tpu ported to PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

YUV420 8-bit frames in, HEVC Main-profile Annex-B out: device compute in
PyTorch (on the CUDA device unless the caller asks for the CPU), the
window-gather and slab-search kernels in CUDA C++ (csrc/), entropy coding
in the shared native C++ host library (native/).
"""

__version__ = "0.1.0"

from homerhevc_torch.config import EncoderConfig  # noqa: E402,F401
