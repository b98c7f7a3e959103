// Per-window gather from a stack of int32 planes (sm_90a).
//
// Replaces the TPU kernels gather_windows_pallas and
// gather_windows_ref_pallas (homerhevc_tpu/ops/pallas_kernels.py): out[k]
// is the size x size window of plane clamp(ri[k], 0, R-1) whose top-left
// corner is (clamp(by[k], 0, hp-size), clamp(bx[k], 0, wp-size)).  The
// plain gather is the case R = 1 (ri may be null).
//
// Bound: device memory.  Every output element is one 4-byte read and one
// 4-byte write and there is no arithmetic to hide behind, so the design
// only has to keep the accesses coalesced: a CTA copies whole windows,
// its threads walk each window row-major, so neighbouring threads read
// neighbouring addresses of one plane row and write neighbouring
// addresses of the output.  The TPU kernel's 8x128 superwindow DMA and
// roll machinery existed only for Mosaic's tiling and is not carried over.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void gather_windows_kernel(const int* __restrict__ planes,
                                      const int* __restrict__ ri,
                                      const int* __restrict__ by,
                                      const int* __restrict__ bx,
                                      int* __restrict__ out, int n, int R,
                                      int hp, int wp, int size) {
    const int area = size * size;
    for (int k = blockIdx.x; k < n; k += gridDim.x) {
        const int r = ri ? clampi(ri[k], 0, R - 1) : 0;
        const int y0 = clampi(by[k], 0, hp - size);
        const int x0 = clampi(bx[k], 0, wp - size);
        const int* src = planes + (size_t)r * hp * wp + (size_t)y0 * wp + x0;
        int* dst = out + (size_t)k * area;
        for (int e = threadIdx.x; e < area; e += blockDim.x) {
            const int row = e / size;
            const int col = e - row * size;
            dst[e] = src[(size_t)row * wp + col];
        }
    }
}

}  // namespace

extern "C" int gather_windows_launch(const int* planes, const int* ri,
                                     const int* by, const int* bx, int* out,
                                     int n, int R, int hp, int wp, int size,
                                     void* stream) {
    if (n <= 0) return 0;
    const int area = size * size;
    int threads = area >= 256 ? 256 : ((area + 31) / 32) * 32;
    int blocks = n < 65535 ? n : 65535;
    gather_windows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        planes, ri, by, bx, out, n, R, hp, wp, size);
    return (int)cudaGetLastError();
}
