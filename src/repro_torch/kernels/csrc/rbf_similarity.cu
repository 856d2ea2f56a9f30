// RBF similarity tiles for sm_90a: the dense and knn-topt affinities' S.
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel rbf_similarity in
// src/repro/kernels/rbf_similarity.py:35 (pallas_call at :58, body
// _rbf_kernel at :21):
//
//   S[i, j] = exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) * inv2s2)   (n, m)
//
// with x (n, d), y (m, d) float32 and inv2s2 = 1 / (2 sigma^2) rounded in
// f32 by the caller, as the JAX kernel does.  The |x|^2 + |y|^2 - 2 x.y
// form is kept (not (x - y)^2), so rounding gives the same near-1
// diagonal and the same near-tie order that the top-t sparsification
// sees in JAX.
//
// Every output element is written exactly once, so the TPU grid (either
// order) becomes a 2-D grid of independent blocks: one block per
// BLOCK_M x BLOCK_N output tile.  Per tile:
//   1. the x stripe and the y tile are staged in shared memory, d in DK
//      chunks (any d works), k-major so a thread reads float4s;
//   2. each of the 256 threads accumulates a 4x4 block of x.y in
//      registers, and the 128 staging threads of the norms sum |x_i|^2
//      and |y_j|^2 from the same staged chunks;
//   3. each thread turns its 4x4 block into S entries and writes them as
//      four float4 rows (16 threads cover one 256-byte tile row).
// Ragged edges are masked: rows past n are not written, columns past m
// are written by scalar stores up to m only.  Output offsets are 64-bit
// (n * m passes 2^31 at n = m = 65536).
//
// Bound on an H100 SXM (data sheet, 700 W) at n = m = 65536, d = 32: the
// 17.2 GB written take 5.1 ms at 3.35 TB/s; the 2nmd = 2.75e11 FMA flops
// take 4.1 ms at the 67 TFLOP/s f32 non-tensor peak -- both pipes are
// close to the limit, bytes slightly ahead.  This version runs the dot
// products on the f32 FMA pipes; a tensor-core (wgmma) version is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;          // output rows per block
constexpr int BLOCK_N = 64;          // output columns per block
constexpr int DK = 32;               // feature chunk staged per step
constexpr int THREADS = 256;
constexpr int LD = BLOCK_M + 4;      // padded row of the staged tiles

static_assert(BLOCK_M == BLOCK_N, "x and y tiles share one staging loop");
static_assert(THREADS == 16 * 16 && BLOCK_M == 16 * 4, "4x4 micro tiles");
static_assert(BLOCK_M + BLOCK_N <= THREADS, "one thread per norm");

__global__ void __launch_bounds__(THREADS)
rbf_kernel(const float* __restrict__ x, const float* __restrict__ y,
           float* __restrict__ out, int n, int m, int d, float inv2s2)
{
    __shared__ __align__(16) float xs[DK * LD];
    __shared__ __align__(16) float ys[DK * LD];
    __shared__ float xn[BLOCK_M];
    __shared__ float yn[BLOCK_N];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.y * BLOCK_M;
    const int col0 = blockIdx.x * BLOCK_N;
    const int ty = tid / 16, tx = tid % 16;

    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
    // threads [0, BLOCK_M) sum |x_row|^2, [BLOCK_M, BLOCK_M + BLOCK_N)
    // sum |y_col|^2, in feature order
    float sq = 0.f;
    const float* own = tid < BLOCK_M ? xs + tid : ys + (tid - BLOCK_M);

    for (int k0 = 0; k0 < d; k0 += DK) {
        for (int i = tid; i < BLOCK_M * DK; i += THREADS) {
            const int r = i / DK, k = i % DK, gk = k0 + k;
            const int gr = row0 + r, gc = col0 + r;
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
        if (tid < BLOCK_M + BLOCK_N)
            for (int k = 0; k < DK; ++k) {
                const float v = own[k * LD];
                sq = fmaf(v, v, sq);
            }
        __syncthreads();     // the next chunk overwrites the staging
    }
    if (tid < BLOCK_M) xn[tid] = sq;
    else if (tid < BLOCK_M + BLOCK_N) yn[tid - BLOCK_M] = sq;
    __syncthreads();

    const int gc = col0 + tx * 4;
    const bool vec = (m % 4 == 0) && gc + 3 < m;   // 16-byte aligned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, gr = row0 + r;
        if (gr >= n) break;
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float d2 =
                fmaxf(xn[r] + yn[tx * 4 + j] - 2.f * dot[i][j], 0.f);
            kv[j] = expf(-d2 * inv2s2);
        }
        float* o = out + (size_t)gr * (size_t)m + gc;
        if (vec) {
            *reinterpret_cast<float4*>(o) =
                make_float4(kv[0], kv[1], kv[2], kv[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (gc + j < m) o[j] = kv[j];
        }
    }
}

}  // namespace

extern "C" int rbf_similarity(const float* x, const float* y, float* out,
                              int n, int m, int d, float inv2s2,
                              void* stream)
{
    if (n < 0 || m < 0 || d < 1) return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return (int)cudaSuccess;
    const long long row_tiles = (n + BLOCK_M - 1) / BLOCK_M;
    if (row_tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
    const dim3 grid((m + BLOCK_N - 1) / BLOCK_N, (unsigned)row_tiles);
    rbf_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, out, n, m,
                                                          d, inv2s2);
    return (int)cudaGetLastError();
}
