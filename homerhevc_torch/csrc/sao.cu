// Sample-adaptive offset of one frame, all three components, as three
// kernels (sm_90a): sao_stats, sao_decide, sao_apply.
//
// Replaces no TPU kernel.  The JAX package's SAO (homerhevc_tpu/ops/sao.py)
// is plain jnp that XLA fuses into a few programs; run eagerly on the card,
// the same algorithm (homerhevc_torch/ops/sao.py, sao_frame_plain) is about
// 4,500 small launches per frame, and the host's time to launch them, not
// the card, sets the stage's time.  These kernels do the same work in
// three launches and give the same bytes: the planes, the per-CTU type,
// offsets and band position, and every decision on the way.
//
// Bound: device memory.  At 1280x768 (720p padded) the stats read the
// original and the reconstruction of three int32 planes and the apply
// reads the reconstruction again and writes the new planes: about 24 MB,
// 7 us at the card's memory rate.  The decisions between them touch a few
// hundred KB.  The design:
//   * sao_stats: one 256-thread block per CTU and component (64x64 luma,
//     32x32 chroma CTBs).  A thread keeps its 16 edge-offset (EO) class
//     sums and counts in registers and the warp adds them with one
//     reduction each; band-offset (BO) histograms go to shared memory by
//     integer atomics (exact in any order).  The block then derives its
//     own per-CTU parameters (the iterate-toward-zero offsets, one thread
//     per EO category and band, then the BO window), which need nothing
//     outside the block.  It writes one 128-int record per CTU and
//     component.
//   * sao_decide: one block.  One thread per CTU picks the explicit luma
//     and chroma modes; then one thread per CTU row walks the merge-left
//     chain across the columns, and after a barrier one thread per CTU
//     takes the merge-up pass.  It writes the fields in the layout of
//     sao.pack_sao_fields' three int32 maps.
//   * sao_apply: one thread per sample of the three planes, padding
//     included, into new planes (the pre-SAO reconstruction is read
//     again for the edge classes, so it is never written).
//
// Exactness.  Every float32 step follows the plain version's order
// (ops/f32.py): f32.fma is the product and sum in double, rounded once;
// other float32 sums and products are __fadd_rn / __fmul_rn, which the
// compiler never contracts; ties in an argmin go to the first minimum; and
// comparisons are strict where the plain version's are.  Integer sums are
// exact in any order.  lambda is read from device memory, so nothing here
// synchronises with the host.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CTB_Y = 64, CTB_C = 32;
// a (component, CTU) record of sao_stats
constexpr int REC = 128;
constexpr int R_EO_D = 0;       // [type 4][category 1..4] sums of org - rec
constexpr int R_EO_C = 16;      // the same, counts
constexpr int R_BO_D = 32;      // [band 32] sums
constexpr int R_BO_C = 64;      // [band 32] counts
constexpr int R_EO_OFF = 96;    // [type 4][category 4] offsets
constexpr int R_EO_COST = 112;  // [type 4] float bits
constexpr int R_BO_OFF = 116;   // [4] offsets of the window's bands
constexpr int R_BO_COST = 120;  // float bits
constexpr int R_BAND = 121;     // the window's first band
// a parameter set of one CTU: t_y, t_c, off[3][4], bp[3]
constexpr int NPAR = 17;
constexpr int P_T = 0, P_OFF = 2, P_BP = 14;
constexpr float BIG = 3e38f;
constexpr float MERGE_FLAG_BITS = 0.9f;
constexpr unsigned FULL = 0xffffffffu;

struct Frame {
    const int* org[3];
    const int* rec[3];
    int* out[3];
    int h[3], w[3], bh[3], bw[3];
    int by, bx;                   // the CTU grid, shared by the components
    const float* lam_y;
    const float* lam_c;
};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floordiv(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// f32.fma: round_f32(double(a) * b + double(c)), one rounding
__device__ __forceinline__ float fma_f32(float a, double b, float c) {
    return __double2float_rn(__dadd_rn(__dmul_rn((double)a, b), (double)c));
}

// neighbours (ady, adx, bdy, bdx) of EO class t: horizontal, vertical,
// 135 and 45 degrees
__device__ __forceinline__ int4 eo_neighbours(int t) {
    switch (t) {
        case 0: return make_int4(0, -1, 0, 1);
        case 1: return make_int4(-1, 0, 1, 0);
        case 2: return make_int4(-1, -1, 1, 1);
        default: return make_int4(-1, 1, 1, -1);
    }
}

// the mapped edge category (0..4) of sample v at (y, x) for EO class t,
// or -1 where a neighbour lies outside the coded bounds (bh, bw): the
// sample then takes no EO offset (sao.eo_class_maps' `valid`)
__device__ __forceinline__ int eo_category(const int* __restrict__ rec,
                                           int w, int bh, int bw, int y,
                                           int x, int t, int v) {
    const int4 n = eo_neighbours(t);
    const int ay = y + n.x, ax = x + n.y, cy = y + n.z, cx = x + n.w;
    if (ay < 0 || ay >= bh || ax < 0 || ax >= bw || cy < 0 || cy >= bh
            || cx < 0 || cx >= bw)
        return -1;
    const int raw = 2 + sgn(v - __ldg(rec + ay * w + ax))
                    + sgn(v - __ldg(rec + cy * w + cx));
    return raw == 2 ? 0 : (raw < 2 ? raw + 1 : raw);
}

// sao._best_offset for one statistic: sign +1 / -1 clips the offset's
// sign (EO categories), 0 is BO (free sign, one more bin)
__device__ void best_offset(int diff, int cnt, float lam, int sign,
                            int& off, float& cost) {
    int init = cnt > 0 ? floordiv(diff + sgn(diff) * (cnt / 2), cnt) : 0;
    init = clampi(init, -7, 7);
    if (sign > 0) init = clampi(init, 0, 7);
    else if (sign < 0) init = clampi(init, -7, 0);
    const int s = sgn(init), a = init < 0 ? -init : init;
    int best_o = 0;
    float best_c = 0.0f;
    for (int mag = 1; mag <= 7; ++mag) {
        const int o = s * mag;
        const float dist = __int2float_rn(cnt * o * o - 2 * diff * o);
        const double rate = mag + 1.0 - (mag == 7 ? 1.0 : 0.0)
                            + (sign == 0 ? 1.0 : 0.0);
        const float c = fma_f32(lam, rate, dist);
        if (mag <= a && c < best_c) {
            best_o = o;
            best_c = c;
        }
    }
    off = best_o;
    cost = best_c;
}

__global__ void __launch_bounds__(256) sao_stats_kernel(
        Frame f, int* __restrict__ rec_out) {
    const int nctu = f.by * f.bx;
    const int comp = blockIdx.x / nctu, ctu = blockIdx.x % nctu;
    const int ctb = comp ? CTB_C : CTB_Y;
    const int y0 = (ctu / f.bx) * ctb, x0 = (ctu % f.bx) * ctb;
    const int w = f.w[comp], bh = f.bh[comp], bw = f.bw[comp];
    const int* __restrict__ rec = f.rec[comp];
    const int* __restrict__ org = f.org[comp];
    __shared__ int s_eo[32];            // sums [16], counts [16]
    __shared__ int s_bo[64];            // sums [32], counts [32]
    __shared__ int s_off[48];           // EO [16], then BO [32]
    __shared__ float s_cost[48];
    const int tid = threadIdx.x;
    if (tid < 32) s_eo[tid] = 0;
    if (tid < 64) s_bo[tid] = 0;
    __syncthreads();

    int ed[4][4], ec[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) ed[t][k] = ec[t][k] = 0;
    for (int p = tid; p < ctb * ctb; p += blockDim.x) {
        const int y = y0 + p / ctb, x = x0 + p % ctb;
        const int v = __ldg(rec + y * w + x);
        const int d = __ldg(org + y * w + x) - v;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int cat = eo_category(rec, w, bh, bw, y, x, t, v);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const bool m = cat == k + 1;
                ed[t][k] += m ? d : 0;
                ec[t][k] += m;
            }
        }
        // BO counts every sample, the padding included
        const int band = v >> 3;
        if (band >= 0 && band < 32) {
            atomicAdd(&s_bo[band], d);
            atomicAdd(&s_bo[32 + band], 1);
        }
    }
    // blockDim.x is a multiple of 32 and every thread gets here
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int sd = __reduce_add_sync(FULL, ed[t][k]);
            const int sc = __reduce_add_sync(FULL, ec[t][k]);
            if ((tid & 31) == 0) {
                atomicAdd(&s_eo[t * 4 + k], sd);
                atomicAdd(&s_eo[16 + t * 4 + k], sc);
            }
        }
    __syncthreads();

    // sao.derive_params: Cr (comp 2) is the secondary component
    const bool second = comp == 2;
    const float lam = comp ? *f.lam_c : *f.lam_y;
    if (tid < 16) {
        // EO class tid / 4, category tid % 4 + 1: valleys and concave
        // edges take offsets >= 0, peaks and convex edges <= 0
        best_offset(s_eo[tid], s_eo[16 + tid], lam, (tid & 3) < 2 ? 1 : -1,
                    s_off[tid], s_cost[tid]);
    } else if (tid < 48) {
        best_offset(s_bo[tid - 16], s_bo[16 + tid], lam, 0, s_off[tid],
                    s_cost[tid]);
    }
    __syncthreads();
    int* __restrict__ r = rec_out + (size_t)blockIdx.x * REC;
    if (tid < 32) r[R_EO_D + tid] = s_eo[tid];
    if (tid < 64) r[R_BO_D + tid] = s_bo[tid];
    if (tid < 16) r[R_EO_OFF + tid] = s_off[tid];
    if (tid == 0) {
        const double eo_rate = second ? 0.0 : 4.0;
        for (int t = 0; t < 4; ++t) {
            const float* c = s_cost + 4 * t;
            const float sum = __fadd_rn(__fadd_rn(__fadd_rn(c[0], c[1]), c[2]),
                                        c[3]);
            r[R_EO_COST + t] = __float_as_int(fma_f32(lam, eo_rate, sum));
        }
        // the cumulative sum of [0, bo_cost[0..31]] in f32.cumsum0's order:
        // a prefix inside each 16-entry chunk, then the prefix of the chunk
        // totals added on
        const float* bc = s_cost + 16;
        float cs[33];
        float acc = 0.0f;                       // the leading zero
        float pre0[16], pre1[16];
        pre0[0] = acc;
        for (int j = 1; j < 16; ++j) pre0[j] = acc = __fadd_rn(acc, bc[j - 1]);
        pre1[0] = acc = bc[15];
        for (int j = 1; j < 16; ++j) pre1[j] = acc = __fadd_rn(acc, bc[15 + j]);
        const float tot0 = pre0[15];
        const float tot1 = __fadd_rn(tot0, pre1[15]);
        for (int j = 0; j < 16; ++j) {
            cs[j] = __fadd_rn(pre0[j], 0.0f);
            cs[16 + j] = __fadd_rn(pre1[j], tot0);
        }
        cs[32] = __fadd_rn(bc[31], tot1);
        // the best window of 4 bands, its first minimum
        int band_pos = 0;
        float best = __fsub_rn(cs[4], cs[0]);
        for (int j = 1; j < 29; ++j) {
            const float win = __fsub_rn(cs[j + 4], cs[j]);
            if (win < best) {
                best = win;
                band_pos = j;
            }
        }
        r[R_BO_COST] = __float_as_int(fma_f32(lam, second ? 5.0 : 7.0, best));
        r[R_BAND] = band_pos;
        for (int k = 0; k < 4; ++k) r[R_BO_OFF + k] = s_off[16 + band_pos + k];
    }
}

__device__ __forceinline__ float as_float(int v) { return __int_as_float(v); }

// sao._adopt_dist: the exact SSD change of applying (typ, off, bp) to the
// CTU whose record is r.  The four statistics are read whatever the type
// (BO's window bands, else the EO class's categories), without a branch,
// so that the merge chain's loads of one step all go out at once.
__device__ __forceinline__ float adopt_dist(const int* __restrict__ r,
                                            int typ, const int* off, int bp) {
    const int t = clampi(typ - 2, 0, 3);
    int d = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int b = (bp + k) & 31;
        const int ic = typ == 1 ? R_BO_C + b : R_EO_C + 4 * t + k;
        const int id = typ == 1 ? R_BO_D + b : R_EO_D + 4 * t + k;
        d += r[ic] * off[k] * off[k] - 2 * r[id] * off[k];
    }
    return __int2float_rn(typ == 0 ? 0 : d);
}

// the cost of CTU c taking the parameter set p: Y + Cb + Cr
__device__ __forceinline__ float cand_cost(const int* __restrict__ recs,
                                           int nctu, int c, const int* p) {
    const float dy = adopt_dist(recs + (size_t)c * REC, p[P_T], p + P_OFF,
                                p[P_BP]);
    const float dcb = adopt_dist(recs + (size_t)(nctu + c) * REC, p[P_T + 1],
                                 p + P_OFF + 4, p[P_BP + 1]);
    const float dcr = adopt_dist(recs + (size_t)(2 * nctu + c) * REC,
                                 p[P_T + 1], p + P_OFF + 8, p[P_BP + 2]);
    return __fadd_rn(__fadd_rn(dy, dcb), dcr);
}

// first minimum of n costs
__device__ __forceinline__ int argmin6(const float* c) {
    int best = 0;
    for (int i = 1; i < 6; ++i)
        if (c[i] < c[best]) best = i;
    return best;
}

// the offsets of mode `best` (0 off, 1 BO, 2 + t EO class t)
__device__ __forceinline__ void mode_offsets(const int* __restrict__ r,
                                             int best, int* off) {
    for (int k = 0; k < 4; ++k)
        off[k] = best == 1 ? r[R_BO_OFF + k]
                 : best >= 2 ? r[R_EO_OFF + 4 * (best - 2) + k] : 0;
}

// the fields: type [3][n], offsets [3][n][4], band_pos [3][n]
__device__ void put_fields(int* __restrict__ fields, int n, int c,
                           const int* p) {
    fields[c] = p[P_T];
    fields[n + c] = p[P_T + 1];
    fields[2 * n + c] = p[P_T + 1];
    for (int comp = 0; comp < 3; ++comp) {
        for (int k = 0; k < 4; ++k)
            fields[3 * n + (comp * n + c) * 4 + k] = p[P_OFF + 4 * comp + k];
        fields[15 * n + comp * n + c] = p[P_BP + comp];
    }
}

__global__ void __launch_bounds__(512) sao_decide_kernel(
        Frame f, const unsigned char* __restrict__ avail_l,
        const unsigned char* __restrict__ avail_u, int merge,
        int* __restrict__ scratch, int* __restrict__ fields) {
    const int n = f.by * f.bx;
    const int* __restrict__ recs = scratch;
    int* __restrict__ expl = scratch + (size_t)3 * n * REC;
    int* __restrict__ p1 = expl + (size_t)n * NPAR;
    float* __restrict__ cost_e = reinterpret_cast<float*>(p1 + (size_t)n * NPAR);
    float* __restrict__ cost1 = cost_e + n;
    const float lam_y = *f.lam_y, lam_c = *f.lam_c;

    // sao.select_luma and sao.select_chroma: the explicit modes
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const int* ry = recs + (size_t)c * REC;
        const int* rcb = recs + (size_t)(n + c) * REC;
        const int* rcr = recs + (size_t)(2 * n + c) * REC;
        int p[NPAR];
        float cy[6], cc[6];
        cy[0] = __fmul_rn(lam_y, 1.0f);
        cy[1] = as_float(ry[R_BO_COST]);
        cc[0] = __fadd_rn(__fmul_rn(lam_c, 1.0f), __fmul_rn(lam_c, 0.0f));
        cc[1] = __fadd_rn(as_float(rcb[R_BO_COST]), as_float(rcr[R_BO_COST]));
        for (int t = 0; t < 4; ++t) {
            cy[2 + t] = as_float(ry[R_EO_COST + t]);
            cc[2 + t] = __fadd_rn(as_float(rcb[R_EO_COST + t]),
                                  as_float(rcr[R_EO_COST + t]));
        }
        const int by_ = argmin6(cy), bc_ = argmin6(cc);
        p[P_T] = by_;
        p[P_T + 1] = bc_;
        mode_offsets(ry, by_, p + P_OFF);
        mode_offsets(rcb, bc_, p + P_OFF + 4);
        mode_offsets(rcr, bc_, p + P_OFF + 8);
        p[P_BP] = ry[R_BAND];
        p[P_BP + 1] = rcb[R_BAND];
        p[P_BP + 2] = rcr[R_BAND];
        cost_e[c] = __fadd_rn(cy[by_], cc[bc_]);
        int* e = expl + (size_t)c * NPAR;
        for (int i = 0; i < NPAR; ++i) e[i] = p[i];
        if (!merge) put_fields(fields, n, c, p);
    }
    if (!merge) return;
    __syncthreads();

    // sao.merge_adopt_rdo, pass 1: left chains, one thread per CTU row
    const float fbits = __fmul_rn(lam_y, MERGE_FLAG_BITS);
    for (int row = threadIdx.x; row < f.by; row += blockDim.x) {
        int prev[NPAR];
#pragma unroll
        for (int i = 0; i < NPAR; ++i) prev[i] = 0;
        for (int x = 0; x < f.bx; ++x) {
            const int c = row * f.bx + x;
            const int* e = expl + (size_t)c * NPAR;
            int ex[NPAR];
#pragma unroll
            for (int i = 0; i < NPAR; ++i) ex[i] = e[i];
            const bool has_l = avail_l[c], has_u = avail_u[c];
            const float c_l = has_l ? __fadd_rn(cand_cost(recs, n, c, prev),
                                                fbits)
                                    : BIG;
            const float c_e = fma_f32(
                fbits, (double)__fadd_rn((float)has_l, (float)has_u),
                cost_e[c]);
            const bool take_l = c_l < c_e;
            int* q = p1 + (size_t)c * NPAR;
#pragma unroll
            for (int i = 0; i < NPAR; ++i) {
                prev[i] = take_l ? prev[i] : ex[i];
                q[i] = prev[i];
            }
            cost1[c] = c_e < c_l ? c_e : c_l;
        }
    }
    __syncthreads();

    // pass 2: each CTU may adopt the pass-1 outcome of the CTU above
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const int* own = p1 + (size_t)c * NPAR;
        const int* up = c >= f.bx ? own - (size_t)f.bx * NPAR : own;
        const float c_u = avail_u[c]
                          ? fma_f32(fbits, 2.0, cand_cost(recs, n, c, up))
                          : BIG;
        put_fields(fields, n, c, c_u < cost1[c] ? up : own);
    }
}

__global__ void __launch_bounds__(256) sao_apply_kernel(
        Frame f, const int* __restrict__ fields) {
    const int n = f.by * f.bx;
    const int ny = f.h[0] * f.w[0], nc = f.h[1] * f.w[1];
    const int total = ny + 2 * nc;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += gridDim.x * blockDim.x) {
        const int comp = i < ny ? 0 : 1 + (i - ny) / nc;
        const int p = comp ? (i - ny) - (comp - 1) * nc : i;
        const int w = f.w[comp], ctb = comp ? CTB_C : CTB_Y;
        const int y = p / w, x = p - (p / w) * w;
        const int c = comp * n + (y / ctb) * f.bx + x / ctb;
        const int* __restrict__ rec = f.rec[comp];
        const int typ = __ldg(fields + c);
        const int* off = fields + 3 * n + 4 * c;
        const int v = __ldg(rec + p);
        int add = 0;
        if (typ == 1) {
            const int band = v >> 3, bp = __ldg(fields + 15 * n + c);
            for (int k = 0; k < 4; ++k)
                if (band == ((bp + k) & 31)) add += __ldg(off + k);
        } else if (typ >= 2) {
            const int cat = eo_category(rec, w, f.bh[comp], f.bw[comp], y, x,
                                        typ - 2, v);
            if (cat > 0) add = __ldg(off + cat - 1);
        }
        f.out[comp][p] = clampi(v + add, 0, 255);
    }
}

}  // namespace

// ints of scratch per CTU: three records, two parameter sets, two costs
extern "C" int sao_scratch_ints_per_ctu() { return 3 * REC + 2 * NPAR + 2; }

// planes: org/rec/out [3] of luma h x w and chroma h/2 x w/2, contiguous
// int32, h and w multiples of 64; (bh, bw) the coded luma bounds (chroma
// bounds bh/2, bw/2); lam_y / lam_c one float32 each in device memory;
// avail_l / avail_u [h/64][w/64] bytes; fields 18 ints per CTU.
extern "C" int sao_frame_launch(
        const int* org_y, const int* org_u, const int* org_v,
        const int* rec_y, const int* rec_u, const int* rec_v, int* out_y,
        int* out_u, int* out_v, const float* lam_y, const float* lam_c,
        const unsigned char* avail_l, const unsigned char* avail_u, int h,
        int w, int bh, int bw, int merge, int* scratch,
        long long scratch_ints, int* fields, void* stream) {
    if (h <= 0 || w <= 0 || h % CTB_Y || w % CTB_Y || bh <= 0 || bh > h
            || bw <= 0 || bw > w)
        return (int)cudaErrorInvalidValue;
    Frame f;
    f.org[0] = org_y; f.org[1] = org_u; f.org[2] = org_v;
    f.rec[0] = rec_y; f.rec[1] = rec_u; f.rec[2] = rec_v;
    f.out[0] = out_y; f.out[1] = out_u; f.out[2] = out_v;
    for (int c = 0; c < 3; ++c) {
        const int s = c ? 2 : 1;
        f.h[c] = h / s;
        f.w[c] = w / s;
        f.bh[c] = bh / s;
        f.bw[c] = bw / s;
    }
    f.by = h / CTB_Y;
    f.bx = w / CTB_Y;
    f.lam_y = lam_y;
    f.lam_c = lam_c;
    const int n = f.by * f.bx;
    if (scratch_ints < (long long)n * sao_scratch_ints_per_ctu())
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    sao_stats_kernel<<<3 * n, 256, 0, s>>>(f, scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sao_decide_kernel<<<1, 512, 0, s>>>(f, avail_l, avail_u, merge, scratch,
                                        fields);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long total = (long long)h * w * 3 / 2;
    sao_apply_kernel<<<(int)((total + 255) / 256), 256, 0, s>>>(f, fields);
    return (int)cudaGetLastError();
}
