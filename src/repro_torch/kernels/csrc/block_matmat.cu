// Row-blocked matrix product for sm_90a: the dense operator's pass.
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel block_matmat / block_matvec in
// src/repro/kernels/block_matvec.py:111,129 (_matmat at :89, pallas_call
// at :97):
//
//   out = A @ V,   A (n, m), V (m, b) float32, out (n, b) float32,
//
// accumulated in f32.  block_matvec is the b = 1 view.
//
// The TPU kernel revisits an output row tile across the sequential column
// axis of its grid.  Here one block owns a stripe of BLOCK_M = 8 * ROWS
// rows (ROWS per warp) and loops over the whole m axis itself, BLOCK_N
// columns at a time, so there are no atomics and the sums are
// deterministic.  Per column tile:
//   1. every warp loads its ROWS rows of the A tile into registers: lane l
//      reads columns l, l + 32, l + 64, l + 96, so the 32 lanes of a warp
//      read 128 consecutive bytes of a row per load (coalesced);
//   2. the block stages the (BLOCK_N, b) V tile in shared memory, stored
//      column-major so lane l reads V[l + 32 q, c] without bank conflicts;
//   3. each lane accumulates its ROWS x WB partial sums in registers.
// After the last tile a warp butterfly (5 shuffles) sums the 32 lanes'
// partials.  Widths are templated in buckets 1, 2, 4, 8, 16, 32, 64, with
// ROWS * WB <= 64 accumulators a thread; columns past b are zero in the
// staged V tile and never written.  Rows past n and columns past m are
// masked, and offsets into A are 64-bit (A holds 4.29e9 elements at
// n = m = 65536).
//
// Bound on an H100 SXM (data sheet, 700 W) at n = m = 65536: the 17.2 GB
// of A read once take 5.1 ms at 3.35 TB/s, at any b <= 64; the 2nmb
// flops are 0.7e11 at b = 8 (1.0 ms at 67 TFLOP/s).  Memory-bound: the
// design keeps A's stream coalesced and ROWS * 4 independent loads a lane
// in flight per tile.  V is re-read from L2 by every block: BLOCK_N * b
// floats per BLOCK_M * BLOCK_N of A, 1/8 of A's bytes at b = 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_N = 128;           // columns of A per tile
constexpr int PER_LANE = BLOCK_N / 32; // columns per lane per tile
constexpr int LDV = BLOCK_N + 1;       // padded column of the V tile
constexpr int MAX_WIDTH = 64;

template <int WB, int ROWS>
__global__ void __launch_bounds__(THREADS)
matmat_kernel(const float* __restrict__ A, const float* __restrict__ V,
              float* __restrict__ out, int n, int m, int b)
{
    __shared__ float Vs[WB * LDV];     // Vs[c * LDV + j] = V[c0 + j, c]

    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int row0 = (blockIdx.x * WARPS + warp) * ROWS;

    float acc[ROWS][WB];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < WB; ++c) acc[r][c] = 0.f;

    for (int c0 = 0; c0 < m; c0 += BLOCK_N) {
        float a[ROWS][PER_LANE];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int gr = row0 + r;
            const float* Ar = A + (size_t)gr * (size_t)m;
#pragma unroll
            for (int q = 0; q < PER_LANE; ++q) {
                const int j = c0 + q * 32 + lane;
                a[r][q] = (gr < n && j < m) ? Ar[j] : 0.f;
            }
        }
        for (int i = threadIdx.x; i < BLOCK_N * WB; i += THREADS) {
            const int jj = i / WB, c = i % WB, j = c0 + jj;
            Vs[c * LDV + jj] =
                (c < b && j < m) ? V[(size_t)j * b + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < WB; ++c) {
#pragma unroll
            for (int q = 0; q < PER_LANE; ++q) {
                const float v = Vs[c * LDV + q * 32 + lane];
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                    acc[r][c] = fmaf(a[r][q], v, acc[r][c]);
            }
        }
        __syncthreads();   // the next tile rewrites Vs
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < WB; ++c)
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
                acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int gr = row0 + r;
        if (gr >= n) break;
#pragma unroll
        for (int c = 0; c < WB; ++c)
            if (c % 32 == lane && c < b) out[(size_t)gr * b + c] = acc[r][c];
    }
}

template <int WB, int ROWS>
void launch(const float* A, const float* V, float* out, int n, int m, int b,
            cudaStream_t stream)
{
    static_assert(WB * ROWS <= 64, "accumulators per thread");
    constexpr int BLOCK_M = WARPS * ROWS;
    const unsigned grid = (unsigned)((n + BLOCK_M - 1) / BLOCK_M);
    matmat_kernel<WB, ROWS><<<grid, THREADS, 0, stream>>>(A, V, out, n, m,
                                                          b);
}

}  // namespace

extern "C" int block_matmat(const float* A, const float* V, float* out,
                            int n, int m, int b, void* stream)
{
    if (n < 0 || m < 0 || b < 1 || b > MAX_WIDTH)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    if (b <= 1) launch<1, 8>(A, V, out, n, m, b, s);
    else if (b <= 2) launch<2, 8>(A, V, out, n, m, b, s);
    else if (b <= 4) launch<4, 8>(A, V, out, n, m, b, s);
    else if (b <= 8) launch<8, 8>(A, V, out, n, m, b, s);
    else if (b <= 16) launch<16, 4>(A, V, out, n, m, b, s);
    else if (b <= 32) launch<32, 2>(A, V, out, n, m, b, s);
    else launch<64, 1>(A, V, out, n, m, b, s);
    return (int)cudaGetLastError();
}
