// Per-window gather from a stack of int32 planes (sm_90a).
//
// Replaces the TPU kernels gather_windows_pallas and
// gather_windows_ref_pallas (homerhevc_tpu/ops/pallas_kernels.py): out[k]
// is the size x size window of plane clamp(ri[k], 0, R-1) whose top-left
// corner is (clamp(by[k], 0, hp-size), clamp(bx[k], 0, wp-size)).  The
// plain gather is the case R = 1 (ri may be null).
//
// Bound: device memory.  Every output word is one 4-byte read and one
// 4-byte write, with no arithmetic to hide behind.  At the encoder's
// shapes (3,840-7,680 windows of 11-25 pixels a side) a call moves a few
// MB, a few microseconds at the card's memory rate, so the fixed costs
// of scheduling and of index arithmetic weigh as much as the bytes.  The
// design:
//   * the output is one flat stream of n * size^2 words; each thread
//     writes 4 consecutive words with one 16-byte store (the wrapper's
//     output is 256-byte aligned) and handles a ragged tail itself;
//   * window, row and column of a word come from division by size and
//     size^2, compile-time constants for the sizes the encoder uses (11,
//     20, 22, 23, 25); one instantiation takes size at run time for every
//     other size;
//   * a grid of a few CTAs per SM strides over the stream, instead of one
//     short CTA per window;
//   * origins and plane indices come through the read-only path and are
//     clamped as the TPU kernels' wrappers clamp them.  Plane reads stay
//     scalar: windows start at any alignment, and neighbouring windows
//     overlap, so most of them hit L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ const int* window(
        const int* __restrict__ planes, const int* __restrict__ ri,
        const int* __restrict__ by, const int* __restrict__ bx, int k,
        int R, int hp, int wp, int size) {
    const int r = ri ? clampi(__ldg(ri + k), 0, R - 1) : 0;
    const int y0 = clampi(__ldg(by + k), 0, hp - size);
    const int x0 = clampi(__ldg(bx + k), 0, wp - size);
    return planes + (size_t)r * hp * wp + (size_t)y0 * wp + x0;
}

// SIZE > 0: window size known at compile time; SIZE == 0: size_rt.
// total = n * size^2 < 2^31 (the launcher splits larger calls).
template <int SIZE>
__global__ void __launch_bounds__(256) gather_windows_kernel(
        const int* __restrict__ planes, const int* __restrict__ ri,
        const int* __restrict__ by, const int* __restrict__ bx,
        int* __restrict__ out, int n, int R, int hp, int wp, int size_rt,
        int total) {
    const int size = SIZE ? SIZE : size_rt;
    const unsigned area = size * size;
    const int nvec = (total + 3) >> 2;
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
         v += gridDim.x * blockDim.x) {
        const int e0 = v << 2;
        int k = (unsigned)e0 / area;
        const unsigned rem = (unsigned)e0 - k * area;
        int row = rem / (unsigned)size;
        int col = rem - row * size;
        const int* p = window(planes, ri, by, bx, k, R, hp, wp, size)
                       + (size_t)row * wp;        // start of this row
        int val[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            val[j] = (e0 + j < total) ? p[col] : 0;
            if (++col == size) {
                col = 0;
                p += wp;
                if (++row == size) {
                    row = 0;
                    if (++k < n)
                        p = window(planes, ri, by, bx, k, R, hp, wp, size);
                }
            }
        }
        if (e0 + 4 <= total) {
            *reinterpret_cast<int4*>(out + e0) =
                make_int4(val[0], val[1], val[2], val[3]);
        } else {
            for (int j = 0; e0 + j < total; ++j) out[e0 + j] = val[j];
        }
    }
}

int sm_count() {
    static int sms = 0;
    if (!sms) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 1;
    }
    return sms;
}

template <int SIZE>
int launch(const int* planes, const int* ri, const int* by, const int* bx,
           int* out, int n, int R, int hp, int wp, int size,
           cudaStream_t stream) {
    const int threads = 256, ctas_per_sm = 8;
    const long long area = (long long)size * size;
    // windows per launch: a multiple of 4 (so every launch's output
    // stays 16-byte aligned) whose words fit an int
    const long long chunk = ((INT32_MAX - 3) / area) & ~3ll;
    if (chunk == 0) return (int)cudaErrorInvalidValue;
    for (long long k0 = 0; k0 < n; k0 += chunk) {
        const int nk = (int)(n - k0 < chunk ? n - k0 : chunk);
        const int total = (int)(nk * area);
        const long long nvec = (total + 3) / 4;
        long long blocks = (nvec + threads - 1) / threads;
        if (blocks > (long long)sm_count() * ctas_per_sm)
            blocks = (long long)sm_count() * ctas_per_sm;
        gather_windows_kernel<SIZE><<<(int)blocks, threads, 0, stream>>>(
            planes, ri ? ri + k0 : nullptr, by + k0, bx + k0,
            out + k0 * area, nk, R, hp, wp, size, total);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

extern "C" int gather_windows_launch(const int* planes, const int* ri,
                                     const int* by, const int* bx, int* out,
                                     int n, int R, int hp, int wp, int size,
                                     void* stream) {
    if (n <= 0) return 0;
    if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
    switch (size) {
        case 11: return launch<11>(planes, ri, by, bx, out, n, R, hp, wp, size, s);
        case 20: return launch<20>(planes, ri, by, bx, out, n, R, hp, wp, size, s);
        case 22: return launch<22>(planes, ri, by, bx, out, n, R, hp, wp, size, s);
        case 23: return launch<23>(planes, ri, by, bx, out, n, R, hp, wp, size, s);
        case 25: return launch<25>(planes, ri, by, bx, out, n, R, hp, wp, size, s);
        default: return launch<0>(planes, ri, by, bx, out, n, R, hp, wp, size, s);
    }
}
