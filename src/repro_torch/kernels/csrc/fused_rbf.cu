// Fused RBF products for sm_90a: the matrix-free affinity pass and the
// Nystrom serving pass.  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/fused_rbf_matmat.py:
//   fused_rbf_matmat      (pallas_call at :268, bodies :79 / :104 / :117)
//   fused_nystrom_matmat  (pallas_call at :200, bodies :137 / :162)
//
//   fused_rbf_matmat:     O   = diag(rs) . K . diag(cs) . V          (n, b)
//   fused_nystrom_matmat: O   = K . (cs * V),  deg = K . cv          (m, b), (m,)
//   with K_ij = exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / (2 sigma^2)).
//
// K is never written out.  One thread block owns a BLOCK_M stripe of
// output rows and walks every BLOCK_N column tile of y in a loop, so the
// TPU's sequential grid axis becomes this in-block loop: no atomics, and
// the sums are deterministic.  Per column tile:
//   1. the x stripe and the y tile are staged in shared memory, d in DK
//      chunks (any d works), together with the (cs * V) tile -- and, for
//      the Nystrom pass, cv as one more column of that tile;
//   2. each thread computes a 4x4 block of x.y, turns it into K entries
//      (norms in f32, max(., 0), expf) and writes them to shared memory;
//   3. four threads per output row each take every fourth column of the
//      K tile and accumulate K . W into WB registers for their row.
// After the last tile the four partial sums of a row meet by warp shuffle.
//
// Ragged edges are masked here: rows past n are never written, columns
// past m load zero points and a zero W row, so they contribute nothing;
// so do columns whose cs (and cv) is 0.
//
// Bound on an H100 SXM (data sheet, 700 W): one pass at n = m = 131072,
// d = 32, b = 8 does 2nmd + 2nmb + ~5nm = 1.46 TFLOP, 22 ms at the
// 67 TFLOP/s f32 non-tensor peak, against ~25 MB of traffic (8 us at
// 3.35 TB/s): compute-bound.  This version runs on the f32 FMA pipes; the
// tensor-core (wgmma) and bf16 variants are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;            // output rows per thread block
constexpr int BLOCK_N = 64;            // y columns per tile
constexpr int DK = 32;                 // feature chunk staged per step
constexpr int THREADS = 256;
constexpr int LD = BLOCK_N + 4;        // padded row of the staged tiles
constexpr int TPR = THREADS / BLOCK_M; // threads per output row, phase 3
constexpr int MAX_WIDTH = 64;          // widest W tile (b, or b + 1)

static_assert(BLOCK_M == BLOCK_N, "the K tile reuses the staging buffer");
static_assert(2 * DK * LD >= BLOCK_M * LD, "K tile must fit the staging");
static_assert(THREADS == 16 * 16 && BLOCK_M == 16 * 4, "4x4 micro tiles");
static_assert(TPR == 4, "the final shuffle reduces over 4 lanes");

template <int WB>
__global__ void __launch_bounds__(THREADS)
fused_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ V, const float* __restrict__ rs,
             const float* __restrict__ cs, const float* __restrict__ cv,
             float* __restrict__ out, float* __restrict__ deg,
             int n, int m, int d, int b, float inv2s2)
{
    // staging: xs | ys ([DK][LD] each, k-major) during the dot product,
    // then the K tile ([BLOCK_M][LD]) in the same bytes
    __shared__ __align__(16) float stage[2 * DK * LD];
    __shared__ __align__(16) float W[BLOCK_N * WB];
    __shared__ float xn[BLOCK_M];
    __shared__ float yn[BLOCK_N];
    float* xs = stage;
    float* ys = stage + DK * LD;
    float* P = stage;

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * BLOCK_M;
    const int ty = tid / 16, tx = tid % 16;      // dot-product micro tile
    const int pr = tid / TPR, q = tid % TPR;     // K . W row and lane

    if (tid < BLOCK_M) {
        const int r = row0 + tid;
        float s = 0.f;
        if (r < n)
            for (int k = 0; k < d; ++k) {
                const float v = x[(size_t)r * d + k];
                s = fmaf(v, v, s);
            }
        xn[tid] = s;
    }

    float acc[WB];
#pragma unroll
    for (int c = 0; c < WB; ++c) acc[c] = 0.f;

    for (int c0 = 0; c0 < m; c0 += BLOCK_N) {
        for (int i = tid; i < BLOCK_N * WB; i += THREADS) {
            const int j = i / WB, c = i % WB, col = c0 + j;
            float w = 0.f;
            if (col < m) {
                if (c < b) w = cs[col] * V[(size_t)col * b + c];
                else if (cv != nullptr && c == b) w = cv[col];
            }
            W[i] = w;
        }

        float dot[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
        float ysq = 0.f;

        for (int k0 = 0; k0 < d; k0 += DK) {
            for (int i = tid; i < BLOCK_M * DK; i += THREADS) {
                const int r = i / DK, k = i % DK, gk = k0 + k;
                const int gr = row0 + r, gc = c0 + r;
                xs[k * LD + r] =
                    (gr < n && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
                ys[k * LD + r] =
                    (gc < m && gk < d) ? y[(size_t)gc * d + gk] : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int k = 0; k < DK; ++k) {
                const float4 a =
                    *reinterpret_cast<const float4*>(&xs[k * LD + ty * 4]);
                const float4 e =
                    *reinterpret_cast<const float4*>(&ys[k * LD + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        dot[i][j] = fmaf(av[i], ev[j], dot[i][j]);
            }
            if (tid < BLOCK_N)
                for (int k = 0; k < DK; ++k) {
                    const float v = ys[k * LD + tid];
                    ysq = fmaf(v, v, ysq);
                }
            __syncthreads();
        }
        if (tid < BLOCK_N) yn[tid] = ysq;
        __syncthreads();

        // K tile: overwrites the staging buffer (everyone is past it)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            float kv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float d2 = fmaxf(
                    xn[r] + yn[tx * 4 + j] - 2.f * dot[i][j], 0.f);
                kv[j] = expf(-d2 * inv2s2);
            }
            *reinterpret_cast<float4*>(&P[r * LD + tx * 4]) =
                make_float4(kv[0], kv[1], kv[2], kv[3]);
        }
        __syncthreads();

#pragma unroll 4
        for (int jj = 0; jj < BLOCK_N / TPR; ++jj) {
            const int j = q + TPR * jj;
            const float p = P[pr * LD + j];
            const float* w = &W[j * WB];
            if constexpr (WB % 4 == 0) {
#pragma unroll
                for (int c = 0; c < WB; c += 4) {
                    const float4 w4 = *reinterpret_cast<const float4*>(w + c);
                    acc[c] = fmaf(p, w4.x, acc[c]);
                    acc[c + 1] = fmaf(p, w4.y, acc[c + 1]);
                    acc[c + 2] = fmaf(p, w4.z, acc[c + 2]);
                    acc[c + 3] = fmaf(p, w4.w, acc[c + 3]);
                }
            } else {
#pragma unroll
                for (int c = 0; c < WB; ++c) acc[c] = fmaf(p, w[c], acc[c]);
            }
        }
        __syncthreads();   // next tile rewrites W and the staging buffer
    }

#pragma unroll
    for (int c = 0; c < WB; ++c) {
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 1);
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 2);
    }
    const int gr = row0 + pr;
    if (gr >= n) return;
    const float scale = rs != nullptr ? rs[gr] : 1.f;
#pragma unroll
    for (int c = 0; c < WB; ++c) {
        if (c % TPR != q) continue;
        if (c < b) out[(size_t)gr * b + c] = scale * acc[c];
        else if (deg != nullptr && c == b) deg[gr] = acc[c];
    }
}

int launch(const float* x, const float* y, const float* V, const float* rs,
           const float* cs, const float* cv, float* out, float* deg,
           int n, int m, int d, int b, float inv2s2, cudaStream_t stream)
{
    const int width = b + (cv != nullptr ? 1 : 0);
    if (n < 0 || m < 0 || d < 1 || b < 1 || width > MAX_WIDTH)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const dim3 grid((n + BLOCK_M - 1) / BLOCK_M), block(THREADS);
#define REPRO_LAUNCH(WB)                                                  \
    fused_kernel<WB><<<grid, block, 0, stream>>>(x, y, V, rs, cs, cv,     \
                                                 out, deg, n, m, d, b,    \
                                                 inv2s2)
    if (width <= 1) REPRO_LAUNCH(1);
    else if (width <= 2) REPRO_LAUNCH(2);
    else if (width <= 4) REPRO_LAUNCH(4);
    else if (width <= 8) REPRO_LAUNCH(8);
    else if (width <= 16) REPRO_LAUNCH(16);
    else if (width <= 32) REPRO_LAUNCH(32);
    else REPRO_LAUNCH(64);
#undef REPRO_LAUNCH
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_rbf_matmat(const float* x, const float* y,
                                const float* V, const float* rs,
                                const float* cs, float* out, int n, int m,
                                int d, int b, float inv2s2, void* stream)
{
    return launch(x, y, V, rs, cs, nullptr, out, nullptr, n, m, d, b,
                  inv2s2, (cudaStream_t)stream);
}

extern "C" int fused_nystrom_matmat(const float* x, const float* y,
                                    const float* V, const float* cs,
                                    const float* cv, float* out, float* deg,
                                    int m, int n, int d, int b, float inv2s2,
                                    void* stream)
{
    // m queries (output rows) against n training points (columns)
    return launch(x, y, V, nullptr, cs, cv, out, deg, m, n, d, b, inv2s2,
                  (cudaStream_t)stream);
}
