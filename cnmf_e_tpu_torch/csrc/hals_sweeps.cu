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
// Column c of V_k . X reads only column c of X, so a CTA owns TD columns.
// Two bodies share that tiling (TD from the wrapper):
//
// The dense body, for unmasked calls (every temporal sweep) and for the
// tiles the compacted body hands back. Bound on an H100: 2 K^2 d FP32
// multiply-adds per sweep on the CUDA cores (4.83 GFLOP at K = 192,
// d = 65,536: 0.072 ms at 67 TFLOP/s), against one read of X, U and the
// mask and one write of X (0.05 ms at 3.35 TB/s). So it is bound by FP32
// FMAs, and the design keeps the FMA pipes fed:
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
//
// The compacted body, for masked calls (the spatial factor on its search
// locations). In a tile only the rows whose mask touches its columns
// contribute to V_k . X or change: every other row's entries are masked,
// so they are 0 before and after. Search masks are sparse (a 512 x 512
// field of 2000 neurons puts 3 of the 2000 rows in a 16-column tile on
// average), so the multiply-adds fall to sum_t k_t^2 TD per sweep over the
// tiles' active-row counts k_t, and the body is bound by bytes: one read
// of the (K, d) mask and one write of the (K, d) output (2.6 GB at
// K = 2000, d = 262,144: 0.8 ms at 3.35 TB/s), the active rows of X and U
// beside them. The design does about that:
//   * the CTA reads the tile's K x TD mask bytes once, 16 bytes a load
//     where aligned, eight rows a thread in flight, and builds the
//     ascending list of active rows with warp ballots and one prefix sum
//     a batch of 2048 rows (the ballots are also the tile's row bitmap);
//   * it stages only those rows (X with masked entries 0, U with masked
//     entries -inf, the k_t x k_t sub-Gram V[act][:, act], cc and gate)
//     and cuts the dense body's chunks of each schedule step to its active
//     rows, once, so chunks that hold none cost nothing in the sweeps;
//   * the sweeps run the dense body's chunks and arithmetic on those rows,
//     so the result is the dense body's to the bit: each residual in the
//     dense body's S partial FMA chains (ascending rows, one chain per
//     residue of q % KC mod S) and its shuffle tree, the non-free
//     correction in its P chains, the same epilogue; the rows left out only
//     add exact zeros there. G adjacent lanes own a column and split a free
//     chunk's rows (one snapshot); lane 0 runs an in-order chunk's rows.
//     Columns do not interact, so only warp barriers;
//   * it writes the whole tile in float4 stores, 0 in the inactive rows.
//     A tile of more than kCap active rows (or non-empty chunks) is listed
//     instead, and a dense launch of a few CTAs an SM walks the list; it
//     exits at once when the list is empty. Nothing synchronises the host.
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

// The dense body on one tile of TD columns: every row of the (K, TD) tile
// of X in shared memory through every sweep.
template <int TD>
__device__ __forceinline__ void dense_tile(
    float* smem, const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ X, float* __restrict__ out,
    const uint8_t* __restrict__ mask, const float* __restrict__ gate,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ free_, const int* __restrict__ n_steps_ptr,
    int K, int d, int n_iter, int relu, int B, int KC, int tile) {
  using L = Layout<TD>;
  float* Vs = smem;                                  // (KC, kVsStride)
  float* Xs = Vs + KC * kVsStride;                   // (K, TD) tile of X
  float* Ds = Xs + round4(K * TD);                   // (kRowsSeq, TD)
  float* Vb = Ds + round4(kRowsSeq * TD);            // (kRowsSeq, kVbStride)
  float* ccs = Vb + kRowsSeq * kVbStride;
  float* gts = ccs + kRowsSeq;

  Args a;
  a.U = U; a.V = V; a.mask = mask; a.gate = gate;
  a.K = K; a.d = d; a.relu = relu; a.KC = KC;
  a.tile0 = tile * TD;
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

// Unmasked calls: one CTA a tile.
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
  extern __shared__ __align__(16) float smem[];
  dense_tile<TD>(smem, U, V, X, out, mask, gate, starts, ends, free_,
                 n_steps_ptr, K, d, n_iter, relu, B, KC, blockIdx.x);
}

// Masked calls, the tiles the compacted body handed back: work[0] tiles
// listed at work[1..], walked by a grid of a few CTAs an SM (none: every
// CTA returns at once).
template <int TD>
__global__ void __launch_bounds__(kThreads)
hals_sweeps_fallback_kernel(
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ X, float* __restrict__ out,
    const uint8_t* __restrict__ mask, const float* __restrict__ gate,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ free_, const int* __restrict__ n_steps_ptr,
    const int* __restrict__ work, int K, int d, int n_iter, int B, int KC) {
  extern __shared__ __align__(16) float smem[];
  const int n = work[0];
  for (int t = blockIdx.x; t < n; t += gridDim.x) {
    if (t != blockIdx.x) __syncthreads();    // the last tile is written out
    dense_tile<TD>(smem, U, V, X, out, mask, gate, starts, ends, free_,
                   n_steps_ptr, K, d, n_iter, 1, B, KC, work[1 + t]);
  }
}

// ---------------------------------------------------------------------- //
// The compacted body.
// ---------------------------------------------------------------------- //
constexpr int kCap = 64;                    // active rows a tile can hold
constexpr int kCapStride = kCap + 1;        // row stride of the sub-Gram
constexpr int kScan = 72;                   // 64 counts, n_act, n_chunks
constexpr int kPasses = 8;                  // rows of a thread per batch
static_assert(kThreads == 256, "the row scan assumes 8 warps of 32");

__host__ __device__ constexpr size_t compact_smem(int TD, int K) {
  return sizeof(float) * ((size_t)3 * kCap * TD + kCap * kCapStride
                          + 2 * kCap)
      + sizeof(int) * ((size_t)4 * kCap + kScan + 2 * ((K + 31) / 32));
}

// Whether row m[0, ncol) of the mask holds any set byte: 16-, 8- or
// 4-byte loads where the whole aligned tile is there (vec), else bytes.
template <int TD>
__device__ __forceinline__ bool row_any(const uint8_t* __restrict__ m,
                                        int ncol, bool vec) {
  if constexpr (TD % 16 == 0) {
    if (vec) {
      const uint4* p = reinterpret_cast<const uint4*>(m);
      uint4 t = p[0];
#pragma unroll
      for (int j = 1; j < TD / 16; ++j) {
        const uint4 u = p[j];
        t.x |= u.x; t.y |= u.y; t.z |= u.z; t.w |= u.w;
      }
      return (t.x | t.y | t.z | t.w) != 0u;
    }
  } else if constexpr (TD == 8) {
    if (vec) {
      const uint2 t = *reinterpret_cast<const uint2*>(m);
      return (t.x | t.y) != 0u;
    }
  } else if constexpr (TD == 4) {
    if (vec) return *reinterpret_cast<const unsigned*>(m) != 0u;
  }
  unsigned acc = 0;
  for (int c = 0; c < ncol; ++c) acc |= m[c];
  return acc != 0u;
}

// The first index of rows[0, n) (ascending) that is >= v.
__device__ __forceinline__ int first_at_least(const int* rows, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Masked calls, one CTA a tile: the rows whose mask touches the tile run
// the schedule in shared memory; every other row is written as 0. A tile
// of more than kCap active rows, or of more than kCap non-empty chunks of
// the dense body's, goes to the list of work for the fallback launch.
template <int TD>
__global__ void __launch_bounds__(kThreads)
hals_sweeps_compact_kernel(
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ X, float* __restrict__ out,
    const uint8_t* __restrict__ mask, const float* __restrict__ gate,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ free_, const int* __restrict__ n_steps_ptr,
    int* __restrict__ work, unsigned long long* __restrict__ stats, int K,
    int d, int n_iter, int B, int KC) {
  using L = Layout<TD>;
  extern __shared__ __align__(16) float smem[];
  float* Xc = smem;                          // (kCap, TD) active rows of X
  float* Uc = Xc + kCap * TD;                // (kCap, TD) of U, -inf masked
  float* Dc = Uc + kCap * TD;                // (kCap, TD) a chunk's rows
  float* Vc = Dc + kCap * TD;                // (kCap, kCapStride) sub-Gram
  float* ccc = Vc + kCap * kCapStride;
  float* gtc = ccc + kCap;
  int* rows = reinterpret_cast<int*>(gtc + kCap);   // active rows, ascending
  int* rmod = rows + kCap;                   // rows[q] % KC
  int* chunks = rmod + kCap;                 // per chunk: ca | cb << 8 |
                                             // free << 16 | nr << 17, r0
  int* scan = chunks + 2 * kCap;
  const int nw = (K + 31) >> 5;
  unsigned* bits = reinterpret_cast<unsigned*>(scan + kScan);  // row bitmap
  int* woff = reinterpret_cast<int*>(bits + nw);   // active rows before word

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int tile0 = blockIdx.x * TD, ncol = min(TD, d - tile0);
  constexpr int VW = TD < 16 ? TD : 16;
  const bool vec = ncol == TD && d % VW == 0
      && reinterpret_cast<uintptr_t>(mask) % VW == 0;

  // the active rows, in ascending order: rows k0 + p * 256 + tid of a batch
  // are flagged in bit p, a warp ballot per pass gives its 32 rows' word of
  // the bitmap, and one prefix sum over the batch's 64 words, in row order,
  // places each active row
  int n_act = 0;
  for (int k0 = 0; k0 < K; k0 += kPasses * kThreads) {
    unsigned f = 0;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int k = k0 + p * kThreads + tid;
      if (k < K && row_any<TD>(mask + (size_t)k * d + tile0, ncol, vec))
        f |= 1u << p;
    }
    unsigned b[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      b[p] = __ballot_sync(0xffffffffu, (f >> p) & 1u);
      if (lane == 0) scan[p * 8 + warp] = __popc(b[p]);
    }
    __syncthreads();
    if (warp == 0) {
      const int c0 = scan[2 * lane], c1 = scan[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const int ex = n_act + incl - c0 - c1;
      scan[2 * lane] = ex;
      scan[2 * lane + 1] = ex + c0;
      if (lane == 31) scan[64] = n_act + incl;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int w = (k0 >> 5) + p * 8 + warp;
      const int off = scan[p * 8 + warp];
      if (lane == 0 && w < nw) {
        bits[w] = b[p];
        woff[w] = off;
      }
      if ((f >> p) & 1u) {
        const int pos = off + __popc(b[p] & below);
        if (pos < kCap) rows[pos] = k0 + p * kThreads + tid;
      }
    }
    n_act = scan[64];
    __syncthreads();                         // scan is read; the next may write
  }

  // the dense body's chunks on this tile, in order: step j covers rows
  // [s, hi) (the same window), split into chunks of kRowsFree (free) or
  // kRowsSeq (in order) rows from s; a chunk keeps its active rows
  // [ca, cb) of the list, its first row r0 and its row count nr
  int n_ch = 0;
  if (n_act <= kCap) {
    if (warp == 0) {
      const int n_steps = *n_steps_ptr;
      const int Kp = ((K + B - 1) / B) * B;
      int cnt = 0;
      for (int j0 = 0; j0 < n_steps; j0 += 32) {
        const int j = j0 + lane;
        int s = 0, hi = 0, fr = 0, mine = 0;
        if (j < n_steps) {
          s = starts[j];
          const int sc = max(min((s / 8) * 8, Kp - B), 0);
          hi = min(min(sc + B, ends[j]), K);
          fr = free_[j] != 0;
        }
        const int cap = fr ? kRowsFree : kRowsSeq;
        for (int r0 = s; r0 < hi; r0 += cap)
          mine += first_at_least(rows, n_act, r0)
              < first_at_least(rows, n_act, min(r0 + cap, hi));
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        int pos = cnt + incl - mine;
        for (int r0 = s; r0 < hi; r0 += cap) {
          const int nr = min(cap, hi - r0);
          const int ca = first_at_least(rows, n_act, r0);
          const int cb = first_at_least(rows, n_act, r0 + nr);
          if (ca < cb && pos < kCap) {
            chunks[2 * pos] = ca | (cb << 8) | (fr << 16) | (nr << 17);
            chunks[2 * pos + 1] = r0;
          }
          pos += ca < cb;
        }
        cnt += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) scan[65] = cnt;
    }
    __syncthreads();
    n_ch = scan[65];
  }
  if (n_act > kCap || n_ch > kCap) {
    if (tid == 0) {
      work[1 + atomicAdd(work, 1)] = blockIdx.x;
      atomicAdd(stats + 1, 1ull);
    }
    return;
  }

  // stage the active rows: X with masked entries 0, U with masked entries
  // -inf (the relu a mask implies turns their update into exactly 0), the
  // sub-Gram, and each row's cc and gate from V's diagonal
  for (int e = tid; e < n_act * TD; e += kThreads) {
    const int i = e / TD, c = e - i * TD;
    const size_t g = (size_t)rows[i] * d + tile0 + c;
    float x = 0.f, u = kNegInf;
    if (c < ncol && mask[g]) {
      x = X[g];
      u = U[g];
    }
    Xc[e] = x;
    Uc[e] = u;
  }
  for (int e = tid; e < n_act * n_act; e += kThreads) {
    const int i = e / n_act, j = e - i * n_act;
    Vc[i * kCapStride + j] = V[(size_t)rows[i] * K + rows[j]];
  }
  for (int i = tid; i < n_act; i += kThreads) {
    const int k = rows[i];
    const float vkk = V[(size_t)k * K + k];
    ccc[i] = fmaxf(vkk, 1e-12f);
    gtc[i] = (gate[k] > 0.f && vkk > 0.f) ? 1.f : 0.f;
    rmod[i] = k % KC;
  }
  __syncthreads();

  // the sweeps, in the dense body's arithmetic, so the result is the same
  // to the bit: G adjacent lanes own a column (columns do not interact).
  // A row's residual is the dense body's dot: S partial FMA chains in
  // ascending row order, Gram column q in chain (q % KC) % S, added as
  // its shuffle tree adds them (S from the chunk's row count as there);
  // the rows left out add exact zeros there. A free chunk's rows are split
  // over the G lanes, go to Dc, and into the tile after the group's last
  // read. An in-order chunk stages its block residuals in Dc, then lane 0
  // updates its rows in order, each corrected by the earlier rows'
  // changes in P partial chains, (j - r0) % P, and the same tree.
  constexpr int G = kThreads / TD < 32 ? kThreads / TD : 32;
  constexpr int P = L::P;
  const int c = tid / G, g = tid % G;
  auto residual = [&](int i, int S) {        // V[row i] . X, column c
    const float* vr = Vc + i * kCapStride;
    float t[8];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      t[ks] = 0.f;
      if (ks < S)
        for (int q = 0; q < n_act; ++q)
          if ((rmod[q] & (S - 1)) == ks)
            t[ks] = fmaf(vr[q], Xc[q * TD + c], t[ks]);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      if (o < S)
#pragma unroll
        for (int ks = 0; ks < o; ++ks) t[ks] += t[ks + o];
    return t[0];
  };
  if (c < TD) {                              // whole warps when TD < 8
    for (int it = 0; it < n_iter; ++it) {
      for (int e = 0; e < n_ch; ++e) {
        const int ch = chunks[2 * e], r0 = chunks[2 * e + 1];
        const int ca = ch & 0xff, cb = (ch >> 8) & 0xff, nr = ch >> 17;
        // the dense body's K split: RM = 1 and few rows
        const bool rm1 = !(L::RMAX >= 4 && nr > 2 * L::RG)
            && !(L::RMAX >= 2 && nr > L::RG);
        int S = 1;
        while (rm1 && S < 8 && S < L::LR && 2 * S * nr <= L::RG
               && 16 * S <= KC)
          S *= 2;
        if ((ch >> 16) & 1) {                // free: from one snapshot
          for (int i = ca + g; i < cb; i += G) {
            if (gtc[i] == 0.f) continue;     // frozen row
            float xn = Xc[i * TD + c]
                + (Uc[i * TD + c] - residual(i, S)) / ccc[i];
            if (xn < 0.f) xn = 0.f;
            Dc[i * TD + c] = xn;
          }
          __syncwarp();
          for (int i = ca + g; i < cb; i += G)
            if (gtc[i] != 0.f) Xc[i * TD + c] = Dc[i * TD + c];
        } else {                             // in order
          for (int i = ca + g; i < cb; i += G)
            Dc[i * TD + c] = Uc[i * TD + c] - residual(i, S);
          __syncwarp();
          if (g == 0) {
            for (int i = ca; i < cb; ++i) {
              float tp[P];
#pragma unroll
              for (int p = 0; p < P; ++p) tp[p] = 0.f;
              for (int j = ca; j < i; ++j) {
                const int p = (rows[j] - r0) % P;
                tp[p] = fmaf(Vc[i * kCapStride + j], Dc[j * TD + c], tp[p]);
              }
#pragma unroll
              for (int o = P / 2; o > 0; o >>= 1)
#pragma unroll
                for (int p = 0; p < o; ++p) tp[p] += tp[p + o];
              const float x0 = Xc[i * TD + c];
              float xn = x0;
              if (gtc[i] != 0.f) {
                xn = x0 + (Dc[i * TD + c] - tp[0]) / ccc[i];
                if (xn < 0.f) xn = 0.f;
              }
              Xc[i * TD + c] = xn;
              Dc[i * TD + c] = xn - x0;      // the change, for later rows
            }
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // the whole tile: the active rows' values, 0 in every other row (all of
  // whose entries are masked)
  const bool vec_o = TD % 4 == 0 && d % 4 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec_o) {
    for (int e = 4 * tid; e < K * TD; e += 4 * kThreads) {
      const int k = e / TD, c4 = e - k * TD;
      if (c4 >= ncol) continue;
      const unsigned w = bits[k >> 5], m = 1u << (k & 31);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w & m) {
        const int i = woff[k >> 5] + __popc(w & (m - 1u));
        v = *reinterpret_cast<const float4*>(Xc + i * TD + c4);
      }
      *reinterpret_cast<float4*>(out + (size_t)k * d + tile0 + c4) = v;
    }
  } else {
    for (int e = tid; e < K * TD; e += kThreads) {
      const int k = e / TD, c1 = e - k * TD;
      if (c1 >= ncol) continue;
      const unsigned w = bits[k >> 5], m = 1u << (k & 31);
      float v = 0.f;
      if (w & m) v = Xc[(woff[k >> 5] + __popc(w & (m - 1u))) * TD + c1];
      out[(size_t)k * d + tile0 + c1] = v;
    }
  }
  if (tid == 0) {
    atomicAdd(stats, 1ull);
    atomicAdd(stats + 2, (unsigned long long)n_act);
  }
}

size_t dense_smem(int K, int TD, int KC) {
  return sizeof(float) *
      ((size_t)KC * kVsStride + round4(K * TD) + round4(kRowsSeq * TD)
       + kRowsSeq * kVbStride + 2 * kRowsSeq);
}

template <int TD>
int launch_td(const float* U, const float* V, const float* X, float* out,
              const uint8_t* mask, const float* gate, const int* starts,
              const int* ends, const int* fr, const int* n_steps, int K,
              int d, int n_iter, int relu, int B, int KC,
              cudaStream_t stream) {
  const size_t smem = dense_smem(K, TD, KC);
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

template <int TD>
int launch_masked_td(const float* U, const float* V, const float* X,
                     float* out, const uint8_t* mask, const float* gate,
                     const int* starts, const int* ends, const int* fr,
                     const int* n_steps, int* work,
                     unsigned long long* stats, int K, int d, int n_iter,
                     int B, int KC, int n_sm, cudaStream_t stream) {
  const int grid = (d + TD - 1) / TD;
  const size_t csmem = compact_smem(TD, K);
  cudaError_t err = cudaFuncSetAttribute(
      hals_sweeps_compact_kernel<TD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(work, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  hals_sweeps_compact_kernel<TD><<<grid, kThreads, csmem, stream>>>(
      U, V, X, out, mask, gate, starts, ends, fr, n_steps, work, stats, K, d,
      n_iter, B, KC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = dense_smem(K, TD, KC);
  err = cudaFuncSetAttribute(hals_sweeps_fallback_kernel<TD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hals_sweeps_fallback_kernel<TD>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int fgrid = max(1, min(grid, per_sm * n_sm));
  hals_sweeps_fallback_kernel<TD><<<fgrid, kThreads, smem, stream>>>(
      U, V, X, out, mask, gate, starts, ends, fr, n_steps, work, K, d,
      n_iter, B, KC);
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

// A masked call (relu): the compacted body on every tile, then the dense
// body on the tiles it listed in work (d / TD + 1 ints); stats (3 int64)
// accumulate the compacted tiles, the listed tiles and the compacted
// tiles' active rows. n_sm sizes the fallback's grid.
extern "C" int hals_sweeps_masked_launch(
    const float* U, const float* V, const float* X, float* out,
    const uint8_t* mask, const float* gate, const int* starts,
    const int* ends, const int* fr, const int* n_steps, int* work,
    unsigned long long* stats, int K, int d, int n_iter, int B, int TD,
    int KC, int n_sm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define HALS_TD(N)                                                        \
  case N:                                                                 \
    return launch_masked_td<N>(U, V, X, out, mask, gate, starts, ends, fr, \
                               n_steps, work, stats, K, d, n_iter, B, KC,  \
                               n_sm, s);
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
