// Nearest-center assignment for sm_90a.  Plain C interface, loaded with
// ctypes.
//
// Replaces the Pallas TPU kernel kmeans_assign in
// src/repro/kernels/kmeans_assign.py (pallas_call at :41, body :19):
//   idx_i = argmin_j max(|p_i|^2 + |c_j|^2 - 2 p_i.c_j, 0),  dist_i = that min
// -- the same decomposition the JAX estimator evaluates in jnp for Lloyd's
// assignment step (src/repro/core/kmeans.py:48, :56-57).
//
// One thread per point.  The k centers and their squared norms sit in
// shared memory (the TPU kernel's replicated "center file"); each thread
// scans them in order and keeps the first strict minimum, so ties go to
// the lowest index, as jnp.argmin does.
//
// Bound on an H100 SXM (data sheet, 700 W): at n = 131072 points, k = 8
// centers of dimension 8 the pass reads 4.2 MB and writes 1.6 MB: about
// 2 us at 3.35 TB/s, memory-bound (its ~30 MFLOP are 0.5 us at 67 TFLOP/s).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
assign_kernel(const float* __restrict__ p, const float* __restrict__ c,
              int64_t* __restrict__ idx, float* __restrict__ dist,
              int n, int k, int d)
{
    extern __shared__ float smem[];
    float* cs = smem;            // (k, d) centers
    float* cc = smem + k * d;    // (k,) squared center norms
    for (int i = threadIdx.x; i < k * d; i += blockDim.x) cs[i] = c[i];
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
        float s = 0.f;
        for (int t = 0; t < d; ++t) s = fmaf(cs[j * d + t], cs[j * d + t], s);
        cc[j] = s;
    }
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float* pi = p + (size_t)i * d;
    float pp = 0.f;
    for (int t = 0; t < d; ++t) pp = fmaf(pi[t], pi[t], pp);
    float best = INFINITY;
    int64_t arg = 0;
    for (int j = 0; j < k; ++j) {
        float dot = 0.f;
        for (int t = 0; t < d; ++t) dot = fmaf(pi[t], cs[j * d + t], dot);
        const float d2 = fmaxf(pp + cc[j] - 2.f * dot, 0.f);
        if (d2 < best) {
            best = d2;
            arg = j;
        }
    }
    idx[i] = arg;
    dist[i] = best;
}

}  // namespace

extern "C" int kmeans_assign(const float* p, const float* c, int64_t* idx,
                             float* dist, int n, int k, int d, void* stream)
{
    const size_t smem = (size_t)(k * d + k) * sizeof(float);
    if (n < 0 || k < 1 || d < 1 || smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    assign_kernel<<<(n + THREADS - 1) / THREADS, THREADS, smem,
                    (cudaStream_t)stream>>>(p, c, idx, dist, n, k, d);
    return (int)cudaGetLastError();
}
