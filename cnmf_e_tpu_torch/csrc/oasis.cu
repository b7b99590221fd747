// Divide-and-conquer OASIS AR(1) (oasisAR1.m:59-109): the three kernels of
// cnmf_e_tpu/ops/pallas_oasis.py::oasis_ar1_pallas_dc.
//
//   oasis_chunk_pools  replaces _oasis_pools_pallas (body _oasis_kernel):
//                      one thread per (trace, chunk) lane runs the
//                      sample-level pool stack over its L samples.
//   oasis_pool_merge   replaces _pool_merge_pallas (body
//                      _pool_event_kernel): one thread per trace pushes the
//                      chunk pool lists in order and resolves violations
//                      across chunks (exact: pool merging is confluent).
//   oasis_reconstruct  replaces _reconstruct_pallas (body
//                      _reconstruct_kernel): one thread per (trace, pool)
//                      writes c on the pool's range and s at its start.
//
// A pool is (v, w, t0, len) with value v / w; the top two pools merge while
//     v_q / w_q < max(v_p / w_p, 0) * g^len_p + smin.
// Each lane's stack lives in its own rows of the output arrays (global
// memory, L1-cached), so there is no cap on T. The work is a sequential
// event loop per lane: bound by latency, not by bytes or FLOPs; the
// parallelism is the K * T / L chunk lanes of pass 1.
//
// The merge arithmetic uses explicit round-to-nearest intrinsics so the
// compiler cannot contract it into FMAs: every operation rounds exactly as
// the plain PyTorch version's does, and the merge decisions agree.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void merge_top(float* v, float* w, int* ln, int& n,
                                          float logg, float smin) {
  while (n >= 2) {
    const int p = n - 2, q = n - 1;
    const float gl = expf(__fmul_rn(logg, (float)ln[p]));
    const float vp = fmaxf(v[p] / w[p], 0.f);
    const float vq = v[q] / w[q];
    if (!(vq < __fadd_rn(__fmul_rn(vp, gl), smin))) break;
    v[p] = __fadd_rn(v[p], __fmul_rn(v[q], gl));
    w[p] = __fadd_rn(w[p], __fmul_rn(__fmul_rn(w[q], gl), gl));
    ln[p] += ln[q];
    --n;
  }
}

__device__ __forceinline__ void clear_from(float* v, float* w, int* ts,
                                           int* ln, int n, int cap) {
  for (int i = n; i < cap; ++i) {
    v[i] = 0.f;
    w[i] = 1.f;
    ts[i] = 0;
    ln[i] = 0;
  }
}

__global__ void oasis_chunk_pools_kernel(
    const float* __restrict__ vinit, const float* __restrict__ g,
    const float* __restrict__ smin, int K, int nc, int L, float* v, float* w,
    int* ts, int* ln, int* n_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= K * nc) return;
  const int k = lane / nc;
  const float logg = logf(fmaxf(g[k], 1e-10f));
  const float sm = smin[k];
  const size_t base = (size_t)lane * L;
  const float* y = vinit + base;
  float* vl = v + base;
  float* wl = w + base;
  int* tl = ts + base;
  int* ll = ln + base;
  const int t_off = (lane - k * nc) * L;
  int n = 0;
  for (int t = 0; t < L; ++t) {
    vl[n] = y[t];
    wl[n] = 1.f;
    tl[n] = t_off + t;
    ll[n] = 1;
    ++n;
    merge_top(vl, wl, ll, n, logg, sm);
  }
  clear_from(vl, wl, tl, ll, n, L);
  n_out[lane] = n;
}

__global__ void oasis_pool_merge_kernel(
    const float* __restrict__ v0, const float* __restrict__ w0,
    const int* __restrict__ ts0, const int* __restrict__ l0,
    const int* __restrict__ n_in, const float* __restrict__ g,
    const float* __restrict__ smin, int K, int nc, int L, float* v, float* w,
    int* ts, int* ln, int* n_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float logg = logf(fmaxf(g[k], 1e-10f));
  const float sm = smin[k];
  const int P = nc * L;
  const size_t base = (size_t)k * P;
  float* vk = v + base;
  float* wk = w + base;
  int* tk = ts + base;
  int* lk = ln + base;
  int n = 0;
  for (int c = 0; c < nc; ++c) {
    const int m = n_in[k * nc + c];
    const size_t src = ((size_t)k * nc + c) * L;
    for (int i = 0; i < m; ++i) {
      vk[n] = v0[src + i];
      wk[n] = w0[src + i];
      tk[n] = ts0[src + i];
      lk[n] = l0[src + i];
      ++n;
      merge_top(vk, wk, lk, n, logg, sm);
    }
  }
  clear_from(vk, wk, tk, lk, n, P);
  n_out[k] = n;
}

__global__ void oasis_reconstruct_kernel(
    const float* __restrict__ v, const float* __restrict__ w,
    const int* __restrict__ ts, const int* __restrict__ ln,
    const int* __restrict__ n, const float* __restrict__ g, int K, int P,
    int T, float* __restrict__ c, float* __restrict__ s) {
  const int k = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n[k]) return;
  const float gk = g[k];
  const float logg = logf(fmaxf(gk, 1e-10f));
  const size_t base = (size_t)k * P;
  const float val = fmaxf(v[base + j] / fmaxf(w[base + j], 1e-20f), 0.f);
  const int t0 = ts[base + j];
  const int t1 = min(t0 + ln[base + j], T);
  float* ck = c + (size_t)k * T;
  float* sk = s + (size_t)k * T;
  for (int t = t0; t < t1; ++t) {
    ck[t] = __fmul_rn(val, expf(__fmul_rn(logg, (float)(t - t0))));
    sk[t] = 0.f;
  }
  if (t0 > 0 && t0 < T && j > 0) {
    // the spike at the pool start: c[t0] - g * c[t0 - 1], with c[t0 - 1]
    // the previous pool's decayed end
    const float vprev = fmaxf(v[base + j - 1] / fmaxf(w[base + j - 1], 1e-20f),
                              0.f);
    const int lprev = max(ln[base + j - 1] - 1, 0);
    const float prev_end = __fmul_rn(vprev, expf(__fmul_rn(logg, (float)lprev)));
    sk[t0] = __fsub_rn(val, __fmul_rn(gk, prev_end));
  }
}

}  // namespace

extern "C" int oasis_chunk_pools_launch(const float* vinit, const float* g,
                                        const float* smin, int K, int nc,
                                        int L, float* v, float* w, int* ts,
                                        int* ln, int* n, void* stream) {
  const int lanes = K * nc, threads = 128;
  oasis_chunk_pools_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(vinit, g, smin, K, nc, L,
                                                     v, w, ts, ln, n);
  return (int)cudaGetLastError();
}

extern "C" int oasis_pool_merge_launch(const float* v0, const float* w0,
                                       const int* ts0, const int* l0,
                                       const int* n_in, const float* g,
                                       const float* smin, int K, int nc,
                                       int L, float* v, float* w, int* ts,
                                       int* ln, int* n, void* stream) {
  // few traces, long sequential loops: small blocks spread them over SMs
  const int threads = 32;
  oasis_pool_merge_kernel<<<(K + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(v0, w0, ts0, l0, n_in, g,
                                                    smin, K, nc, L, v, w, ts,
                                                    ln, n);
  return (int)cudaGetLastError();
}

extern "C" int oasis_reconstruct_launch(const float* v, const float* w,
                                        const int* ts, const int* ln,
                                        const int* n, const float* g, int K,
                                        int P, int T, float* c, float* s,
                                        void* stream) {
  const int threads = 128;
  dim3 grid((P + threads - 1) / threads, K);
  oasis_reconstruct_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      v, w, ts, ln, n, g, K, P, T, c, s);
  return (int)cudaGetLastError();
}
