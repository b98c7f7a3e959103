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
// Bound: at the encoder's shapes a call is 3,840 output blocks times 561
// offsets of 2x2 pixels, or 49 offsets of 8x8: a few million absolute
// differences, about a microsecond of the card's integer rate, so what
// limits it is how many of those differences run side by side and the
// fixed cost of a launch.  The design therefore spreads the
// (output block, offset) pairs over the whole card:
//   * a CTA owns a tile of TY x TX output blocks (one warp each) and
//     stages its cur tile and the slab tile with its halo in shared
//     memory once (opting in above 48 KB);
//   * the 32 lanes of a warp split its block's offsets, lane l taking
//     flat indices l, l + 32, ...; each lane holds the block's bs x bs
//     cur pixels in registers, so a serial chain is at most
//     ceil(offsets / 32) * bs^2 differences (72 and 128 at the encoder's
//     two shapes, against 2,244 and 3,136 with one thread per block);
//   * the slab tile's row pitch is padded to be congruent to 2rx+1
//     modulo 32, so the word a lane reads sits at bank
//     (base + flat index) mod 32 and the 32 consecutive flat indices of
//     one step fall on 32 distinct banks;
//   * each lane keeps the minimum of the 64-bit key
//     (cost << 32) | flat index, and the warp reduces the keys with
//     shuffles: equal costs resolve to the lower flat index whatever
//     the order of the reduction.  The cost is biased by 2^31 before it
//     enters the key, so keys order as signed int32 costs, as argmin
//     over the plain version's int32 costs does.
// Costs accumulate in int32 like the plain version (every cost at the
// encoder's shapes is below 2^17).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// BS > 0: block size known at compile time, cur pixels in registers.
// BS == 0: any block size (bs), cur pixels read from shared memory.
template <int BS>
__global__ void slab_search_kernel(const int* __restrict__ cur,
                                   const int* __restrict__ slab,
                                   int* __restrict__ out, int h, int w,
                                   int bs_rt, int ry, int rx, int ty,
                                   int tx, int pitch) {
    extern __shared__ int sm[];
    const int bs = BS ? BS : bs_rt;
    const int ch = ty * bs, cw = tx * bs;            // cur tile
    const int sh = ch + 2 * ry, sw = cw + 2 * rx;    // slab tile + halo
    int* scur = sm;
    int* sslab = sm + ch * cw;                       // row pitch `pitch`
    const int py0 = blockIdx.y * ch, px0 = blockIdx.x * cw;
    const int hs = h + 2 * ry, ws = w + 2 * rx;
    const int nt = blockDim.x;
    for (int i = threadIdx.x; i < ch * cw; i += nt) {
        const int yy = py0 + i / cw, xx = px0 + i % cw;
        scur[i] = (yy < h && xx < w) ? __ldg(cur + yy * w + xx) : 0;
    }
    for (int i = threadIdx.x; i < sh * sw; i += nt) {
        const int r = i / sw, c = i % sw;
        const int yy = py0 + r, xx = px0 + c;
        sslab[r * pitch + c] =
            (yy < hs && xx < ws) ? __ldg(slab + yy * ws + xx) : 0;
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wy = warp / tx, wx = warp % tx;
    const int oy = blockIdx.y * ty + wy, ox = blockIdx.x * tx + wx;
    const int bh = h / bs, bw = w / bs;
    if (oy >= bh || ox >= bw) return;
    const int* bcur = scur + wy * bs * cw + wx * bs;
    const int* bslab = sslab + wy * bs * pitch + wx * bs;

    int c[BS ? BS * BS : 1];
    if (BS) {
#pragma unroll
        for (int yy = 0; yy < BS; ++yy)
#pragma unroll
            for (int xx = 0; xx < BS; ++xx) c[yy * BS + xx] = bcur[yy * cw + xx];
    }

    const int nx = 2 * rx + 1, nofs = (2 * ry + 1) * nx;
    const int step_dy = 32 / nx, step_dx = 32 % nx;
    int dy = lane / nx, dx = lane % nx;
    uint64_t best = ~0ull;
    for (int o = lane; o < nofs; o += 32) {
        int s = abs(dy - ry) + abs(dx - rx);
        const int* a = bslab + dy * pitch + dx;
        if (BS) {
#pragma unroll
            for (int yy = 0; yy < BS; ++yy)
#pragma unroll
                for (int xx = 0; xx < BS; ++xx)
                    s += abs(a[yy * pitch + xx] - c[yy * BS + xx]);
        } else {
            for (int yy = 0; yy < bs; ++yy)
                for (int xx = 0; xx < bs; ++xx)
                    s += abs(a[yy * pitch + xx] - bcur[yy * cw + xx]);
        }
        const uint64_t key =
            ((uint64_t)((unsigned)s ^ 0x80000000u) << 32) | (unsigned)o;
        best = key < best ? key : best;
        dy += step_dy;
        dx += step_dx;
        if (dx >= nx) {
            dx -= nx;
            ++dy;
        }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        const uint64_t other = __shfl_xor_sync(0xffffffffu, best, m);
        best = other < best ? other : best;
    }
    if (lane == 0) out[oy * bw + ox] = (int)(unsigned)(best & 0xffffffffu);
}

template <int BS>
int launch(const int* cur, const int* slab, int* out, int h, int w, int bs,
           int ry, int rx, cudaStream_t stream) {
    const int bh = h / bs, bw = w / bs;
    int dev = 0, max_smem = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    // 2 x 4 output blocks (8 warps) a CTA, or one when a large radius
    // would not fit the tile's halo in shared memory
    const int tiles[2][2] = {{2, 4}, {1, 1}};
    for (const auto& t : tiles) {
        const int ty = t[0], tx = t[1];
        const int sw = tx * bs + 2 * rx, nx = 2 * rx + 1;
        const int pitch = sw + (((nx - sw) % 32) + 32) % 32;
        const size_t smem =
            sizeof(int) * ((size_t)ty * bs * tx * bs
                           + (size_t)(ty * bs + 2 * ry) * pitch);
        if (smem > (size_t)max_smem && ty * tx > 1) continue;
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                slab_search_kernel<BS>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        dim3 grid((bw + tx - 1) / tx, (bh + ty - 1) / ty);
        slab_search_kernel<BS><<<grid, 32 * ty * tx, smem, stream>>>(
            cur, slab, out, h, w, bs, ry, rx, ty, tx, pitch);
        return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int slab_search_launch(const int* cur, const int* slab, int* out,
                                  int h, int w, int bs, int ry, int rx,
                                  void* stream) {
    if (h / bs <= 0 || w / bs <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (bs) {
        case 2: return launch<2>(cur, slab, out, h, w, bs, ry, rx, s);
        case 4: return launch<4>(cur, slab, out, h, w, bs, ry, rx, s);
        case 8: return launch<8>(cur, slab, out, h, w, bs, ry, rx, s);
        default: return launch<0>(cur, slab, out, h, w, bs, ry, rx, s);
    }
}
