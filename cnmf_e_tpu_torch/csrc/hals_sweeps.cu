// Class-scheduled Gauss-Seidel HALS sweeps on a row-major factor X (K, d).
//
// Replaces the TPU kernel cnmf_e_tpu/ops/pallas_hals.py:
// hals_sweeps_rows_pallas (body _hals_rows_kernel). Given U (K, d) and the
// symmetric Gram V (K, K), each schedule step updates rows [lo, hi) of one
// colour class:
//     x_k <- x_k + (u_k - V_k . X) / cc_k,   cc_k = max(V_kk, 1e-12)
// with relu for the spatial factor, a (K, d) support mask (masked entries
// start at 0 and stay 0) and rows frozen where gate_k == 0 or V_kk == 0.
// A free step updates all its rows from one snapshot of X (rows of one
// class do not interact); a non-free step updates its rows in order.
//
// Bound on an H100: 2 K^2 d FP32 multiply-adds per sweep on the CUDA cores
// (4.83 GFLOP at K = 192, d = 65,536: 0.072 ms at 67 TFLOP/s), against one
// read of X, U and the mask and one write of X (0.05 ms at 3.35 TB/s). So
// the sweeps are bound by FP32 FMAs, and the design keeps the FMA pipes fed:
//   * one CTA owns TD columns; its (K, TD) tile of X stays in shared memory
//     for all sweeps and is read from and written to device memory once;
//   * the step's residual R = U - V[rows] X is a register-tiled product:
//     the step's V rows are staged (transposed, by cp.async) in shared
//     memory, and each thread owns an RM x 4 micro-tile, so one 16-byte
//     shared load of X feeds 4 * RM FMAs (16 at RM = 4, as does one of V).
//     RM (1..4) follows the step's row count, so small colour classes do
//     not pay for 64 rows;
//   * a step of few rows would leave most row groups idle behind one
//     K-long FMA chain per row, so at RM = 1 the idle row groups of a warp
//     split the dot: S lanes (2, 4 or 8) each sum every S-th Gram column
//     and shuffles add the S parts;
//   * a free step applies the epilogue (/cc, relu, mask, gate) to the
//     results in registers after one barrier and writes them into the tile;
//   * a non-free step computes the same block residual from its snapshot,
//     then corrects it row by row as the TPU kernel does:
//     r_k = R_k - V[k, lo:k] . (X[lo:k] - X0[lo:k]), a dot of at most 32
//     terms per column, split over the P adjacent lanes of a column and
//     summed by shuffles, so every thread works and no CTA barrier sits
//     inside the row loop;
//   * the mask is read here (uint8/bool), U is prefetched into registers
//     before the product, and the gate and cc come from V's diagonal, so the
//     wrapper adds no pass over the (K, d) operands;
//   * TD is chosen from (K, d): 64 columns for the spatial factor (two
//     CTAs share an SM at K = 192, so one CTA's staging overlaps the
//     other's FMAs), 16 for short rows (d = T = 2000 gives 125 CTAs; on
//     an H100, 250 CTAs of 8 columns measured slower, so the K split
//     fills the CTA instead), and narrower only while a large K does not
//     fit; V streams through shared memory in slices of KC rows of the
//     Gram when the whole step slice does not fit, so there is no K cap.
// Everything is FP32 with IEEE division (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsFree = 64;               // rows of one product chunk
constexpr int kRowsSeq = 32;                // rows of one in-order chunk
constexpr int kVsStride = kRowsFree + 4;    // padded, keeps float4 alignment
constexpr int kVbStride = kRowsSeq + 1;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

#define kNegInf __int_as_float(0xff800000)

template <int TD>
struct Layout {
  static constexpr int CM = TD < 4 ? TD : 4;            // columns per thread
  static constexpr int CG = TD / CM;                     // column groups
  static constexpr int LC = CG < 8 ? CG : 8;             // per warp
  static constexpr int LR = 32 / LC;                     // row groups per warp
  static constexpr int WC = CG / LC;                     // warps across
  static constexpr int RG = kThreads / CG;               // row groups
  static constexpr int RMAX = RG >= kRowsFree ? 1 : kRowsFree / RG;
  static constexpr int P = kThreads / TD < 32 ? kThreads / TD : 32;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Args {
  const float* U;
  const float* V;
  const uint8_t* mask;
  const float* gate;
  int K, d, relu, KC, tile0, ncol, vec;
};

// Stage V[r0 + rr, q0 + qq] at Vs[qq * kVsStride + rr] for rr < nst (rows
// past nr read as 0) and qq < kc: each warp takes rows, its lanes the
// contiguous Gram columns, so the reads coalesce and no index is divided.
__device__ __forceinline__ void stage_v(float* Vs, const Args& a, int r0,
                                        int nr, int nst, int q0, int kc) {
  const int lane = threadIdx.x & 31;
  for (int rr = threadIdx.x >> 5; rr < nst; rr += kThreads / 32) {
    const float* src = a.V + (size_t)(r0 + rr) * a.K + q0;
    for (int qq = lane; qq < kc; qq += 32) {
      float* dst = Vs + qq * kVsStride + rr;
      if (rr < nr)
        cp_async4(dst, src + qq);
      else
        *dst = 0.f;
    }
  }
  cp_async_wait_all();
}

// acc[i][j] += sum_q Vs[q][rg*RM + i] * Xs[q][cg*CM + j] over q = 0, S,
// 2S, ... (n terms). S is a template argument so that the unrolled loads
// take constant offsets.
template <int TD, int RM, int S>
__device__ __forceinline__ void product(const float* __restrict__ Xs,
                                        const float* __restrict__ Vs, int n,
                                        int rg, int cg,
                                        float (&acc)[RM][Layout<TD>::CM]) {
  constexpr int CM = Layout<TD>::CM;
  constexpr int vstep = S * kVsStride, xstep = S * TD;
  const float* vp = Vs + rg * RM;
  const float* xp = Xs + cg * CM;
#pragma unroll 4
  for (int q = 0; q < n; ++q) {
    float v[RM], x[CM];
    if constexpr (RM == 4) {
      const float4 t = *reinterpret_cast<const float4*>(vp);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else if constexpr (RM == 2) {
      const float2 t = *reinterpret_cast<const float2*>(vp);
      v[0] = t.x; v[1] = t.y;
    } else {
      v[0] = vp[0];
    }
    if constexpr (CM == 4) {
      const float4 t = *reinterpret_cast<const float4*>(xp);
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if constexpr (CM == 2) {
      const float2 t = *reinterpret_cast<const float2*>(xp);
      x[0] = t.x; x[1] = t.y;
    } else {
      x[0] = xp[0];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(v[i], x[j], acc[i][j]);
    vp += vstep;
    xp += xstep;
  }
}

// One chunk of nr <= kRowsFree (free) or kRowsSeq (in order) rows
// starting at r0, with RM rows per thread.
template <int TD, int RM>
__device__ void chunk(float* Xs, float* Vs, float* Ds, float* Vb, float* ccs,
                      float* gts, const Args& a, int r0, int nr, bool fr) {
  using L = Layout<TD>;
  constexpr int CM = L::CM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = (warp % L::WC) * L::LC + lane % L::LC;
  // the K split: S row groups of a warp, lanes LC apart, share a row
  // group's dot; S = 1 unless few rows leave row groups idle
  int S = 1;
  if constexpr (RM == 1)
    while (S < 8 && S < L::LR && 2 * S * nr <= L::RG && 16 * S <= a.KC)
      S *= 2;
  const int rgw = (warp / L::WC) * L::LR + lane / L::LC;
  const int ks = rgw & (S - 1);                  // this lane's share
  const int rg = rgw >> (__ffs(S) - 1);
  const int row0 = rg * RM;                      // first local row
  const bool busy = row0 < nr;                   // sums part of a dot
  const bool active = busy && ks == 0;           // owns the result
  const int c0 = cg * CM;
  const int nst = min(kRowsFree, ((nr + RM - 1) / RM) * RM);

  // prefetch this thread's U, gate and cc before the product. A masked
  // entry's U becomes -inf: the relu that a mask implies then turns its
  // update into exactly 0, the same number as the JAX kernel's -1e30
  // sentinel gives
  float u[RM][CM], acc[RM][CM], cc[RM];
  bool gt[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int k = r0 + row0 + i;
    const bool rok = active && row0 + i < nr;
    float vkk = 0.f;
    if (rok) vkk = a.V[(size_t)k * a.K + k];
    cc[i] = fmaxf(vkk, 1e-12f);
    gt[i] = rok && a.gate[k] > 0.f && vkk > 0.f;
    const size_t g = (size_t)k * a.d + a.tile0 + c0;
    bool done = false;
    if constexpr (CM == 4) {
      if (a.vec && rok && c0 + 4 <= a.ncol) {
        const float4 t = *reinterpret_cast<const float4*>(a.U + g);
        u[i][0] = t.x; u[i][1] = t.y; u[i][2] = t.z; u[i][3] = t.w;
        if (a.mask) {
          const uchar4 m = *reinterpret_cast<const uchar4*>(a.mask + g);
          if (!m.x) u[i][0] = kNegInf;
          if (!m.y) u[i][1] = kNegInf;
          if (!m.z) u[i][2] = kNegInf;
          if (!m.w) u[i][3] = kNegInf;
        }
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const bool ok = rok && c0 + j < a.ncol;
        u[i][j] = !ok ? 0.f : (a.mask && !a.mask[g + j]) ? kNegInf
                                                          : a.U[g + j];
      }
    }
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;
  }

  // R = U - V[r0:r0+nr] X, V streamed in slices of KC Gram columns
  for (int q0 = 0; q0 < a.K; q0 += a.KC) {
    const int kc = min(a.KC, a.K - q0);
    if (q0 > 0) __syncthreads();                 // the last slice is read
    stage_v(Vs, a, r0, nr, nst, q0, kc);
    __syncthreads();
    if (busy) {
      const float* xq = Xs + (size_t)(q0 + ks) * TD;
      const float* vq = Vs + ks * kVsStride;
      const int n = (kc - ks + S - 1) / S;
      if constexpr (RM == 1) {
        if (S == 8) product<TD, 1, 8>(xq, vq, n, rg, cg, acc);
        else if (S == 4) product<TD, 1, 4>(xq, vq, n, rg, cg, acc);
        else if (S == 2) product<TD, 1, 2>(xq, vq, n, rg, cg, acc);
        else product<TD, 1, 1>(xq, vq, n, rg, cg, acc);
      } else {
        product<TD, RM, 1>(xq, vq, n, rg, cg, acc);
      }
    }
  }
  if constexpr (RM == 1) {
    // every lane joins (S is uniform over the CTA; idle lanes add zeros)
    for (int o = S >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < CM; ++j)
        acc[0][j] += __shfl_xor_sync(0xffffffffu, acc[0][j], o * L::LC);
  }
  __syncthreads();                               // every read of X is done

  if (fr) {
    // free step: epilogue in registers, straight into the tile
    if (active) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (!gt[i]) continue;                    // frozen row (or past nr)
        float* xr = Xs + (size_t)(r0 + row0 + i) * TD + c0;
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          if (c0 + j >= a.ncol) continue;
          float xn = xr[j] + (u[i][j] - acc[i][j]) / cc[i];
          if (a.relu && xn < 0.f) xn = 0.f;
          xr[j] = xn;
        }
      }
    }
    __syncthreads();
    return;
  }

  // non-free step: stage the block residual (a masked entry stays -inf),
  // the rows' cc and gate, and the (nr, nr) diagonal block of V
  if (active) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (row0 + i >= nr) continue;
#pragma unroll
      for (int j = 0; j < CM; ++j)
        Ds[(row0 + i) * TD + c0 + j] = u[i][j] - acc[i][j];
    }
  }
  for (int i = tid; i < nr; i += kThreads) {
    const int k = r0 + i;
    const float vkk = a.V[(size_t)k * a.K + k];
    ccs[i] = fmaxf(vkk, 1e-12f);
    gts[i] = (a.gate[k] > 0.f && vkk > 0.f) ? 1.f : 0.f;
  }
  for (int i = tid; i < nr * nr; i += kThreads) {
    const int kk = i / nr, jj = i - kk * nr;     // Vb[jj][kk] = V[k, j]
    Vb[jj * kVbStride + kk] = a.V[(size_t)(r0 + kk) * a.K + r0 + jj];
  }
  __syncthreads();

  // rows in order: P adjacent lanes per column split the correction dot
  constexpr int P = L::P;
  const int c = tid / P, p = tid % P;
  if (c < TD) {                                  // whole warps when TD < 8
    for (int kk = 0; kk < nr; ++kk) {
      float part = 0.f;
      for (int jj = p; jj < kk; jj += P)
        part = fmaf(Vb[jj * kVbStride + kk], Ds[jj * TD + c], part);
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      float* xk = Xs + (size_t)(r0 + kk) * TD + c;
      const float x0 = *xk;
      float xn = x0;
      if (gts[kk] != 0.f) {
        xn = x0 + (Ds[kk * TD + c] - part) / ccs[kk];
        if (a.relu && xn < 0.f) xn = 0.f;
      }
      __syncwarp();
      if (p == 0) {
        *xk = xn;
        Ds[kk * TD + c] = xn - x0;               // delta for the later rows
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

template <int TD>
__global__ void __launch_bounds__(kThreads)
hals_sweeps_kernel(const float* __restrict__ U, const float* __restrict__ V,
                   const float* __restrict__ X, float* __restrict__ out,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ gate,
                   const int* __restrict__ starts,
                   const int* __restrict__ ends,
                   const int* __restrict__ free_,
                   const int* __restrict__ n_steps_ptr, int K, int d,
                   int n_iter, int relu, int B, int KC) {
  using L = Layout<TD>;
  extern __shared__ __align__(16) float smem[];
  float* Vs = smem;                                  // (KC, kVsStride)
  float* Xs = Vs + KC * kVsStride;                   // (K, TD) tile of X
  float* Ds = Xs + round4(K * TD);                   // (kRowsSeq, TD)
  float* Vb = Ds + round4(kRowsSeq * TD);            // (kRowsSeq, kVbStride)
  float* ccs = Vb + kRowsSeq * kVbStride;
  float* gts = ccs + kRowsSeq;

  Args a;
  a.U = U; a.V = V; a.mask = mask; a.gate = gate;
  a.K = K; a.d = d; a.relu = relu; a.KC = KC;
  a.tile0 = blockIdx.x * TD;
  a.ncol = min(TD, d - a.tile0);
  a.vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(U) % 16 == 0)
          && (!mask || reinterpret_cast<uintptr_t>(mask) % 4 == 0);

  // the X tile by cp.async, all of a thread's copies in flight at once,
  // then the mask zeroes its masked entries in place
  const bool vec_x = TD % 4 == 0 && d % 4 == 0
      && reinterpret_cast<uintptr_t>(X) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec_x) {
    for (int e = 4 * threadIdx.x; e < K * TD; e += 4 * kThreads) {
      const int k = e / TD, c = e - k * TD;
      if (c < a.ncol)
        cp_async16(Xs + e, X + (size_t)k * d + a.tile0 + c);
      else
        *reinterpret_cast<float4*>(Xs + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < K * TD; i += kThreads) {
      const int k = i / TD, c = i - k * TD;
      if (c < a.ncol)
        cp_async4(Xs + i, X + (size_t)k * d + a.tile0 + c);
      else
        Xs[i] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (mask) {
#pragma unroll 8
    for (int i = threadIdx.x; i < K * TD; i += kThreads) {
      const int k = i / TD, c = i - k * TD;
      if (c < a.ncol && !mask[(size_t)k * d + a.tile0 + c]) Xs[i] = 0.f;
    }
    __syncthreads();
  }

  const int n_steps = *n_steps_ptr;
  const int Kp = ((K + B - 1) / B) * B;
  for (int it = 0; it < n_iter; ++it) {
    for (int j = 0; j < n_steps; ++j) {
      // the JAX kernel's 8-aligned B-row window, gated to [start, end)
      const int s = starts[j];
      const int sc = max(min((s / 8) * 8, Kp - B), 0);
      const int hi = min(min(sc + B, ends[j]), K);
      const bool fr = free_[j] != 0;
      const int cap = fr ? kRowsFree : kRowsSeq;
      // rows of a free step do not interact, and a non-free step's rows
      // update in order, so either splits into chunks
      for (int r0 = s; r0 < hi; r0 += cap) {
        const int nr = min(cap, hi - r0);
        if (L::RMAX >= 4 && nr > 2 * L::RG) {
          if constexpr (L::RMAX >= 4)
            chunk<TD, 4>(Xs, Vs, Ds, Vb, ccs, gts, a, r0, nr, fr);
        } else if (L::RMAX >= 2 && nr > L::RG) {
          if constexpr (L::RMAX >= 2)
            chunk<TD, 2>(Xs, Vs, Ds, Vb, ccs, gts, a, r0, nr, fr);
        } else {
          chunk<TD, 1>(Xs, Vs, Ds, Vb, ccs, gts, a, r0, nr, fr);
        }
      }
    }
  }

  if (vec_x) {
    for (int e = 4 * threadIdx.x; e < K * TD; e += 4 * kThreads) {
      const int k = e / TD, c = e - k * TD;
      if (c < a.ncol)
        *reinterpret_cast<float4*>(out + (size_t)k * d + a.tile0 + c) =
            *reinterpret_cast<const float4*>(Xs + e);
    }
  } else {
    for (int i = threadIdx.x; i < K * TD; i += kThreads) {
      const int k = i / TD, c = i - k * TD;
      if (c < a.ncol) out[(size_t)k * d + a.tile0 + c] = Xs[i];
    }
  }
}

template <int TD>
int launch_td(const float* U, const float* V, const float* X, float* out,
              const uint8_t* mask, const float* gate, const int* starts,
              const int* ends, const int* fr, const int* n_steps, int K,
              int d, int n_iter, int relu, int B, int KC,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)KC * kVsStride + round4(K * TD) + round4(kRowsSeq * TD)
       + kRowsSeq * kVbStride + 2 * kRowsSeq);
  cudaError_t err = cudaFuncSetAttribute(
      hals_sweeps_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d + TD - 1) / TD;
  hals_sweeps_kernel<TD><<<grid, kThreads, smem, stream>>>(
      U, V, X, out, mask, gate, starts, ends, fr, n_steps, K, d, n_iter,
      relu, B, KC);
  return (int)cudaGetLastError();
}

}  // namespace

// TD (columns per CTA) and KC (Gram columns per V slice) come from the
// wrapper (ops/hals_kernels.py::_tiling), which sizes them to shared memory.
extern "C" int hals_sweeps_launch(const float* U, const float* V,
                                  const float* X, float* out,
                                  const uint8_t* mask, const float* gate,
                                  const int* starts, const int* ends,
                                  const int* fr, const int* n_steps, int K,
                                  int d, int n_iter, int relu, int B, int TD,
                                  int KC, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define HALS_TD(N)                                                       \
  case N:                                                                \
    return launch_td<N>(U, V, X, out, mask, gate, starts, ends, fr,      \
                        n_steps, K, d, n_iter, relu, B, KC, s);
  switch (TD) {
    HALS_TD(64) HALS_TD(32) HALS_TD(16) HALS_TD(8) HALS_TD(4) HALS_TD(2)
    HALS_TD(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HALS_TD
}

extern "C" const char* cnmfe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
