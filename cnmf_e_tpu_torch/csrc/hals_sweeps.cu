// Class-scheduled Gauss-Seidel HALS sweeps on a row-major factor X (K, d).
//
// Replaces the TPU kernel cnmf_e_tpu/ops/pallas_hals.py:
// hals_sweeps_rows_pallas (body _hals_rows_kernel). Given U (K, d) and the
// symmetric Gram V (K, K), each schedule step updates rows [lo, hi) of one
// colour class:
//     x_k <- x_k + (u_k - V_k . X) / cc_k,   cc_k = max(V_kk, 1e-12)
// with relu for the spatial factor (the search mask arrives folded into U
// as a -1e30 sentinel, so masked entries relu to 0) and rows frozen where
// gate_k == 0. A free step updates all its rows from the same snapshot of
// X (rows of one class do not interact); a non-free step updates its rows
// one after another, each recomputing its residual from the current X.
//
// Columns are independent, so one CTA owns a tile of TD columns: it keeps
// the (K, TD) tile of X in shared memory for all n_iter sweeps, reads U and
// V through L1/L2, and writes X back once. The product V_k . X is an FP32
// FFMA dot over K per (row, column) — the kernel is bound by shared-memory
// reads of X (one per FMA); V_k is a warp-uniform broadcast load.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hals_sweeps_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   float* __restrict__ X, const float* __restrict__ cc,
                   const float* __restrict__ gate,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   const int* __restrict__ fr,
                   const int* __restrict__ n_steps_ptr, int K, int d,
                   int n_iter, int relu, int TD) {
  extern __shared__ float smem[];
  float* Xs = smem;                          // (K, TD) tile of X
  float* Rs = smem + (size_t)K * TD;         // (B, TD) free-step results
  const int tile0 = blockIdx.x * TD;
  const int ncol = min(TD, d - tile0);
  const int tid = threadIdx.x;

  for (int i = tid; i < K * TD; i += blockDim.x) {
    const int k = i / TD, c = i - k * TD;
    Xs[i] = (c < ncol) ? X[(size_t)k * d + tile0 + c] : 0.f;
  }
  __syncthreads();

  const int n_steps = *n_steps_ptr;
  for (int it = 0; it < n_iter; ++it) {
    for (int j = 0; j < n_steps; ++j) {
      const int r0 = lo[j], r1 = hi[j];
      if (r1 <= r0) continue;                // uniform across the CTA
      if (fr[j]) {
        const int n = (r1 - r0) * TD;
        for (int p = tid; p < n; p += blockDim.x) {
          const int r = p / TD, c = p - r * TD, k = r0 + r;
          const float xk = Xs[k * TD + c];
          float out = xk;
          if (c < ncol && gate[k] > 0.f) {
            const float* Vk = V + (size_t)k * K;
            float acc = 0.f;
            for (int q = 0; q < K; ++q) acc = fmaf(Vk[q], Xs[q * TD + c], acc);
            float xn = xk + (U[(size_t)k * d + tile0 + c] - acc) / cc[k];
            if (relu && xn < 0.f) xn = 0.f;
            out = xn;
          }
          Rs[p] = out;
        }
        __syncthreads();
        for (int p = tid; p < n; p += blockDim.x) Xs[r0 * TD + p] = Rs[p];
        __syncthreads();
      } else {
        // each thread owns whole columns, so rows update in order without
        // barriers between them
        for (int c = tid; c < ncol; c += blockDim.x) {
          for (int k = r0; k < r1; ++k) {
            if (!(gate[k] > 0.f)) continue;
            const float* Vk = V + (size_t)k * K;
            float acc = 0.f;
            for (int q = 0; q < K; ++q) acc = fmaf(Vk[q], Xs[q * TD + c], acc);
            float xn = Xs[k * TD + c]
                + (U[(size_t)k * d + tile0 + c] - acc) / cc[k];
            if (relu && xn < 0.f) xn = 0.f;
            Xs[k * TD + c] = xn;
          }
        }
        __syncthreads();
      }
    }
  }

  for (int i = tid; i < K * TD; i += blockDim.x) {
    const int k = i / TD, c = i - k * TD;
    if (c < ncol) X[(size_t)k * d + tile0 + c] = Xs[i];
  }
}

}  // namespace

extern "C" int hals_sweeps_launch(const float* U, const float* V, float* X,
                                  const float* cc, const float* gate,
                                  const int* lo, const int* hi, const int* fr,
                                  const int* n_steps, int K, int d,
                                  int n_iter, int relu, int TD, int B,
                                  void* stream) {
  const size_t smem = (size_t)(K + B) * TD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hals_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d + TD - 1) / TD;
  hals_sweeps_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      U, V, X, cc, gate, lo, hi, fr, n_steps, K, d, n_iter, relu, TD);
  return (int)cudaGetLastError();
}

extern "C" const char* cnmfe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
