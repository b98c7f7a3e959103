// Full-search block matching over a slab (sm_90a).
//
// Replaces the TPU kernel slab_search_pallas
// (homerhevc_tpu/ops/pallas_kernels.py), whose work the reference runs as
// me.slab_search_jnp.  For cur [h, w] and slab [h + 2ry, w + 2rx], the
// cost of offset (dy, dx) at output block (by, bx) is the bs x bs SAD of
// slab[dy + y, dx + x] against cur[y, x] over the block plus
// |dy - ry| + |dx - rx|; out[by, bx] is the flat index dy * (2rx+1) + dx
// of the first minimum in ascending flat order (argmin's tie-break).
//
// Bound: at the encoder's shapes the two calls are small (a few million
// absolute differences each), so launch latency dominates; the work is
// arithmetic on a tile that fits in shared memory.  A CTA owns a tile of
// output blocks, stages its cur tile and the slab tile with its halo in
// shared memory once, and each thread then walks every offset of one
// output block from shared memory, keeping its running minimum in
// registers (int32 is exact: every cost is below 2^17).
#include <climits>
#include <cuda_runtime.h>

namespace {

__global__ void slab_search_kernel(const int* __restrict__ cur,
                                   const int* __restrict__ slab,
                                   int* __restrict__ out, int h, int w,
                                   int bs, int ry, int rx) {
    extern __shared__ int sm[];
    const int tby = blockDim.y, tbx = blockDim.x;
    const int ch = tby * bs, cw = tbx * bs;          // cur tile
    const int sh = ch + 2 * ry, sw = cw + 2 * rx;    // slab tile + halo
    int* scur = sm;
    int* sslab = sm + ch * cw;
    const int oy0 = blockIdx.y * tby, ox0 = blockIdx.x * tbx;
    const int py0 = oy0 * bs, px0 = ox0 * bs;
    const int hs = h + 2 * ry, ws = w + 2 * rx;
    const int tid = threadIdx.y * tbx + threadIdx.x;
    const int nt = tbx * tby;
    for (int i = tid; i < ch * cw; i += nt) {
        const int yy = py0 + i / cw, xx = px0 + i % cw;
        scur[i] = (yy < h && xx < w) ? cur[yy * w + xx] : 0;
    }
    for (int i = tid; i < sh * sw; i += nt) {
        const int yy = py0 + i / sw, xx = px0 + i % sw;
        sslab[i] = (yy < hs && xx < ws) ? slab[yy * ws + xx] : 0;
    }
    __syncthreads();
    const int bh = h / bs, bw = w / bs;
    const int oy = oy0 + threadIdx.y, ox = ox0 + threadIdx.x;
    if (oy >= bh || ox >= bw) return;
    const int ly = threadIdx.y * bs, lx = threadIdx.x * bs;
    const int ny = 2 * ry + 1, nx = 2 * rx + 1;
    int best = INT_MAX, besti = 0;
    for (int dy = 0; dy < ny; ++dy) {
        for (int dx = 0; dx < nx; ++dx) {
            int s = abs(dy - ry) + abs(dx - rx);
            for (int yy = 0; yy < bs; ++yy) {
                const int* a = sslab + (ly + dy + yy) * sw + lx + dx;
                const int* b = scur + (ly + yy) * cw + lx;
                for (int xx = 0; xx < bs; ++xx) s += abs(a[xx] - b[xx]);
            }
            if (s < best) {
                best = s;
                besti = dy * nx + dx;
            }
        }
    }
    out[oy * bw + ox] = besti;
}

}  // namespace

extern "C" int slab_search_launch(const int* cur, const int* slab, int* out,
                                  int h, int w, int bs, int ry, int rx,
                                  void* stream) {
    const int bh = h / bs, bw = w / bs;
    if (bh <= 0 || bw <= 0) return 0;
    // largest square tile (in output blocks) whose shared footprint fits
    // the default 48 KB of dynamic shared memory
    int t = 16;
    size_t smem = 0;
    for (; t > 1; t /= 2) {
        smem = sizeof(int) * ((size_t)t * bs * t * bs
                              + (size_t)(t * bs + 2 * ry) * (t * bs + 2 * rx));
        if (smem <= 48 * 1024) break;
    }
    smem = sizeof(int) * ((size_t)t * bs * t * bs
                          + (size_t)(t * bs + 2 * ry) * (t * bs + 2 * rx));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            slab_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 block(t, t);
    dim3 grid((bw + t - 1) / t, (bh + t - 1) / t);
    slab_search_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        cur, slab, out, h, w, bs, ry, rx);
    return (int)cudaGetLastError();
}
