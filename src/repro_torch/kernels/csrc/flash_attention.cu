// Causal / sliding-window flash attention for sm_90a.  Plain C interface,
// loaded with ctypes.
//
// Replaces the Pallas TPU kernel flash_attention in
// src/repro/kernels/flash_attention.py (_flash_kernel, pallas_call at :98):
//   o[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/(H/KV),j] + mask)
//              v[b,h/(H/KV),j]
// with mask = -1e30 where a key is past the query (causal) or at least
// `window` positions behind it (window > 0), positions counted from 0.  The
// online softmax runs in f32: running max m, denominator l and an f32
// output accumulator; each p tile is rounded to v's dtype before the PV
// product, as the TPU kernel does (:68-70); the output is o / max(l, 1e-30).
//
// Design.  The TPU kernel's grid walks one (batch, head) row of q blocks in
// order; here blocks run in parallel, so one block owns a query tile of one
// (batch, head) and loops over the kv tiles itself, from `lo` to `hi` --
// the affine bounds of the TPU kernel (:43-44), so whole tiles past the
// causal end or before the window start are skipped.  K/V tiles are staged
// in shared memory.  Grouped kv heads are read in place (kv head h / (H/KV),
// no broadcast copy).  Ragged S and T are masked here: query rows past S are
// not written, keys past T get p = 0 exactly.  Two kernels, each templated
// on hd in {16, 64, 128, 256} (64 is qwen1.5-0.5b's, 16 its smoke
// config's):
//  - bf16 (the LM path): 4 warps own 64 query rows, 16 a warp; both
//    products run on the tensor cores (mma.sync m16n8k16, f32 sums) from
//    ldmatrix fragments; the score accumulator becomes the PV product's A
//    operand in registers, so p never touches shared memory.
//  - f32: the same loop on the FMA pipes: 256 threads in a 16 x 16 grid,
//    thread (ty, tx) holding rows ty*RM.. and columns tx + 16 j; p goes
//    through shared memory.
//
// Bound on an H100 SXM (data sheet, 700 W): causal prefill of qwen1.5-0.5b
// (B = 1, H = KV = 16, S = T = 2048, hd = 64, bf16) does 4 hd flops per
// unmasked (query, key) pair and head, 8.6e9 flops: 8.7 us at 989 TFLOP/s
// of bf16 tensor cores, against 16.8 MB of q, k, v and o (5.0 us).  This
// version has no wgmma, TMA or copy/compute overlap: K/V loads and the
// products alternate behind barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                 // a 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;            // the TPU kernel's mask value
// keys past T: below any masked score, so exp(s - m) is exactly 0
constexpr float OUT_OF_RANGE = -3.0e38f;

// The first kv tile a block of queries q0..last must visit: the window's
// start (the TPU kernel's lo bound), unless a row sees no key at all (past
// T - 1 + window, only when S > T).  Such a row's softmax runs over masked
// scores alone and averages v over all T keys, as the plain version's
// does, so its block visits every tile.
__device__ __forceinline__ int first_tile(int q0, int last, int T_len,
                                          int window, int BLOCK_K)
{
    if (window <= 0 || last >= T_len - 1 + window) return 0;
    return max(0, q0 - window + 1) / BLOCK_K;
}

// ---------------------------------------------------------------------------
// f32: both products on the FMA pipes
// ---------------------------------------------------------------------------

template <int HD, int BLOCK_Q, int BLOCK_K>
constexpr size_t smem_floats()
{
    // Q (BLOCK_Q x HD+1), K (BLOCK_K x HD+1), V (BLOCK_K x HD),
    // P (BLOCK_Q x BLOCK_K+1)
    return (size_t)BLOCK_Q * (HD + 1) + (size_t)BLOCK_K * (HD + 1)
           + (size_t)BLOCK_K * HD + (size_t)BLOCK_Q * (BLOCK_K + 1);
}

template <int HD, int BLOCK_Q, int BLOCK_K>
__global__ void __launch_bounds__(THREADS)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int KV, int S, int T_len, float scale, int causal,
                 int window)
{
    constexpr int RM = BLOCK_Q / 16, RN = BLOCK_K / 16, RD = HD / 16;
    constexpr int QLD = HD + 1, KLD = HD + 1, PLD = BLOCK_K + 1;
    extern __shared__ float smem[];
    float* Qs = smem;                        // padded rows: no bank conflicts
    float* Ks = Qs + BLOCK_Q * QLD;
    float* Vs = Ks + BLOCK_K * KLD;
    float* Ps = Vs + BLOCK_K * HD;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int bh = blockIdx.y;               // b * H + h
    const int b = bh / H, h = bh - b * H;
    const int kvh = h / (H / KV);
    const int q0 = blockIdx.x * BLOCK_Q;
    const float* qb = q + (size_t)bh * S * HD;
    const float* kb = k + (size_t)(b * KV + kvh) * T_len * HD;
    const float* vb = v + (size_t)(b * KV + kvh) * T_len * HD;
    float* ob = o + (size_t)bh * S * HD;

    for (int i = tid; i < BLOCK_Q * HD; i += THREADS) {
        const int r = i / HD, d = i % HD;
        Qs[r * QLD + d] = q0 + r < S ? qb[(size_t)(q0 + r) * HD + d] : 0.f;
    }

    float m[RM], l[RM], acc[RM][RD];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
    }

    const int n_tiles = (T_len + BLOCK_K - 1) / BLOCK_K;
    const int hi = causal
        ? min(n_tiles, (q0 + BLOCK_Q + BLOCK_K - 1) / BLOCK_K) : n_tiles;
    const int lo = first_tile(q0, min(q0 + BLOCK_Q, S) - 1, T_len, window,
                              BLOCK_K);

    for (int ti = lo; ti < hi; ++ti) {
        const int t0 = ti * BLOCK_K;
        __syncthreads();                     // the last tile's reads are done
        for (int i = tid; i < BLOCK_K * HD; i += THREADS) {
            const int r = i / HD, d = i % HD;
            const bool in = t0 + r < T_len;  // zeros past T keep p * v finite
            const size_t g = (size_t)(t0 + r) * HD + d;
            Ks[r * KLD + d] = in ? kb[g] : 0.f;
            Vs[r * HD + d] = in ? vb[g] : 0.f;
        }
        __syncthreads();

        float s[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qa[RM], ka[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i) qa[i] = Qs[(ty * RM + i) * QLD + d];
#pragma unroll
            for (int j = 0; j < RN; ++j) ka[j] = Ks[(tx + 16 * j) * KLD + d];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j)
                    s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int qpos = q0 + ty * RM + i;
            float mx = m[i];
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const int kpos = t0 + tx + 16 * j;
                const bool ok = (!causal || kpos <= qpos)
                                && (window <= 0 || qpos - kpos < window);
                float x = ok ? s[i][j] * scale : NEG_INF;
                if (kpos >= T_len) x = OUT_OF_RANGE;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float corr = expf(m[i] - mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const float p = expf(s[i][j] - mx);
                sum += p;
                Ps[(ty * RM + i) * PLD + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * corr + sum;
            m[i] = mx;
#pragma unroll
            for (int j = 0; j < RD; ++j) acc[i][j] *= corr;
        }
        __syncthreads();

#pragma unroll 8
        for (int kk = 0; kk < BLOCK_K; ++kk) {
            float pa[RM], va[RD];
#pragma unroll
            for (int i = 0; i < RM; ++i) pa[i] = Ps[(ty * RM + i) * PLD + kk];
#pragma unroll
            for (int j = 0; j < RD; ++j) va[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RD; ++j)
                    acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + ty * RM + i;
        if (row >= S) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < RD; ++j)
            ob[(size_t)row * HD + tx + 16 * j] = acc[i][j] / den;
    }
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;                  // 16 query rows a warp
constexpr int TC_BLOCK_Q = 16 * TC_WARPS;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i's fragment (transposed: .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p)
{
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p)
{
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int BLOCK_K>
constexpr size_t tc_smem_bytes()
{
    // Q (TC_BLOCK_Q rows), K and V (BLOCK_K rows each), rows padded by 8
    // elements so that ldmatrix's eight 16-byte rows fall in distinct bank
    // groups
    return (size_t)(TC_BLOCK_Q + 2 * BLOCK_K) * (HD + 8)
           * sizeof(__nv_bfloat16);
}

// Loads `rows` rows of HD bf16 from `src` (row stride HD) into `dst` (row
// stride HD + 8), 16 bytes a thread; rows at or past `valid` are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int valid)
{
    constexpr int CHUNKS = HD / 8;
    for (int i = threadIdx.x; i < rows * CHUNKS; i += 32 * TC_WARPS) {
        const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid)
            v = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
        *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = v;
    }
}

template <int HD, int BLOCK_K>
__global__ void __launch_bounds__(32 * TC_WARPS)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int H, int KV, int S,
                int T_len, float scale, int causal, int window)
{
    constexpr int LD = HD + 8;
    constexpr int NT = BLOCK_K / 8;               // score n-tiles of 8 keys
    constexpr int DT = HD / 8;               // output n-tiles of 8 dims
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + TC_BLOCK_Q * LD;
    __nv_bfloat16* Vs = Ks + BLOCK_K * LD;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
    const int bh = blockIdx.y;
    const int b = bh / H, h = bh - b * H;
    const int kvh = h / (H / KV);
    const int q0 = blockIdx.x * TC_BLOCK_Q;
    const __nv_bfloat16* kb = k + (size_t)(b * KV + kvh) * T_len * HD;
    const __nv_bfloat16* vb = v + (size_t)(b * KV + kvh) * T_len * HD;
    __nv_bfloat16* ob = o + (size_t)bh * S * HD;

    load_tile<HD>(Qs, q + ((size_t)bh * S + q0) * HD, TC_BLOCK_Q, S - q0);

    // rows g and g + 8 of the warp's 16: running max, denominator, output
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const int row0 = q0 + warp * 16 + g;     // query position of row g

    const int n_tiles = (T_len + BLOCK_K - 1) / BLOCK_K;
    const int hi = causal
        ? min(n_tiles, (q0 + TC_BLOCK_Q + BLOCK_K - 1) / BLOCK_K) : n_tiles;
    const int lo = first_tile(q0, min(q0 + TC_BLOCK_Q, S) - 1, T_len, window,
                              BLOCK_K);

    for (int ti = lo; ti < hi; ++ti) {
        const int t0 = ti * BLOCK_K;
        __syncthreads();                     // the last tile's reads are done
        load_tile<HD>(Ks, kb + (size_t)t0 * HD, BLOCK_K, T_len - t0);
        load_tile<HD>(Vs, vb + (size_t)t0 * HD, BLOCK_K, T_len - t0);
        __syncthreads();

        // s = q k^T over hd, 16 at a time
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, Qs + (warp * 16 + mr + (mi & 1) * 8) * LD
                           + kk * 16 + (mi >> 1) * 8);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t kf[4];
                ldsm_x4(kf, Ks + (j * 8 + mr + (mi >> 1) * 8) * LD
                                + kk * 16 + (mi & 1) * 8);
                mma_bf16(s[j], a, kf[0], kf[1]);
                mma_bf16(s[j + 1], a, kf[2], kf[3]);
            }
        }

        // mask, online softmax; a row's 4 quad lanes share it
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qpos = row0 + (e >> 1) * 8;
                const int kpos = t0 + j * 8 + tig * 2 + (e & 1);
                const bool ok = (!causal || kpos <= qpos)
                                && (window <= 0 || qpos - kpos < window);
                float x = ok ? s[j][e] * scale : NEG_INF;
                if (kpos >= T_len) x = OUT_OF_RANGE;
                s[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            corr[r] = expf(m[r] - mx[r]);
            m[r] = mx[r];
        }
        uint32_t p[NT][2];                   // p rounded to bf16, packed
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float p0 = expf(s[j][0] - mx[0]), p1 = expf(s[j][1] - mx[0]);
            const float p2 = expf(s[j][2] - mx[1]), p3 = expf(s[j][3] - mx[1]);
            sum[0] += p0 + p1;
            sum[1] += p2 + p3;
            p[j][0] = pack_bf16(p0, p1);
            p[j][1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
            l[r] = l[r] * corr[r] + sum[r];
        }
#pragma unroll
        for (int j = 0; j < DT; ++j) {
            acc[j][0] *= corr[0];
            acc[j][1] *= corr[0];
            acc[j][2] *= corr[1];
            acc[j][3] *= corr[1];
        }

        // o += p v over the tile's keys, 16 at a time: two score n-tiles
        // make one A fragment
#pragma unroll
        for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
            const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1],
                                   p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
            for (int j = 0; j < DT; j += 2) {
                uint32_t vf[4];
                ldsm_x4_trans(vf, Vs + (kk * 16 + mr + (mi & 1) * 8) * LD
                                     + j * 8 + (mi >> 1) * 8);
                mma_bf16(acc[j], a, vf[0], vf[1]);
                mma_bf16(acc[j + 1], a, vf[2], vf[3]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= S) continue;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < DT; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + (size_t)row * HD + j * 8 + tig * 2) =
                __floats2bfloat162_rn(acc[j][2 * r] / den,
                                      acc[j][2 * r + 1] / den);
    }
}

template <int HD, int BLOCK_K>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int KV, int S, int T_len, float scale, int causal,
              int window, cudaStream_t stream)
{
    constexpr size_t smem = tc_smem_bytes<HD, BLOCK_K>();
    auto kernel = flash_kernel_tc<HD, BLOCK_K>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + TC_BLOCK_Q - 1) / TC_BLOCK_Q, B * H);
    kernel<<<grid, 32 * TC_WARPS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, KV, S, T_len, scale,
        causal, window);
    return (int)cudaGetLastError();
}

template <int HD, int BLOCK_Q, int BLOCK_K>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int T_len, float scale, int causal,
               int window, cudaStream_t stream)
{
    constexpr size_t smem =
        smem_floats<HD, BLOCK_Q, BLOCK_K>() * sizeof(float);
    auto kernel = flash_kernel_f32<HD, BLOCK_Q, BLOCK_K>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, B * H);
    kernel<<<grid, THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, H, KV,
        S, T_len, scale, causal, window);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, H, S, hd), k/v (B, KV, T, hd),
// o (B, H, S, hd), all contiguous, H a multiple of KV.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KV, int S, int T,
                               int hd, int dtype, float scale, int causal,
                               int window, void* stream)
{
    if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1 || T < 1
        || B * H > 65535 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    // f32 tiles: 64 x 64 up to hd 128 (up to 113 KB of shared memory),
    // 32 x 32 at hd 256, where a 64-row accumulator would not fit the
    // registers; bf16 key tiles: 64, and 32 at hd 256 for the same reason
    switch (hd * 2 + dtype) {
    case 16 * 2:
        return launch_f32<16, 64, 64>(q, k, v, o, B, H, KV, S, T, scale,
                                      causal, window, st);
    case 64 * 2:
        return launch_f32<64, 64, 64>(q, k, v, o, B, H, KV, S, T, scale,
                                      causal, window, st);
    case 128 * 2:
        return launch_f32<128, 64, 64>(q, k, v, o, B, H, KV, S, T, scale,
                                       causal, window, st);
    case 256 * 2:
        return launch_f32<256, 32, 32>(q, k, v, o, B, H, KV, S, T, scale,
                                       causal, window, st);
    case 16 * 2 + 1:
        return launch_tc<16, 64>(q, k, v, o, B, H, KV, S, T, scale, causal,
                                 window, st);
    case 64 * 2 + 1:
        return launch_tc<64, 64>(q, k, v, o, B, H, KV, S, T, scale, causal,
                                 window, st);
    case 128 * 2 + 1:
        return launch_tc<128, 64>(q, k, v, o, B, H, KV, S, T, scale, causal,
                                  window, st);
    case 256 * 2 + 1:
        return launch_tc<256, 32>(q, k, v, o, B, H, KV, S, T, scale, causal,
                                  window, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
