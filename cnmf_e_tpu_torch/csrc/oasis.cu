// Divide-and-conquer OASIS AR(1) (oasisAR1.m:59-109): the three kernels of
// cnmf_e_tpu/ops/pallas_oasis.py::oasis_ar1_pallas_dc, and one entry that
// launches them as one solve.
//
//   oasis_chunk_pools  replaces _oasis_pools_pallas (body _oasis_kernel):
//                      the sample-level pool stack over each length-L
//                      chunk of each trace.
//   oasis_pool_merge   replaces _pool_merge_pallas (body
//                      _pool_event_kernel): pushes the chunk pool lists of a
//                      trace in order and resolves violations across chunks
//                      (exact: pool merging is confluent).
//   oasis_reconstruct  replaces _reconstruct_pallas (body
//                      _reconstruct_kernel): pools -> c and s, a thread a
//                      sample.
//   oasis_solve_launch replaces oasis_ar1_pallas_dc: y -> c, s, the three
//                      kernels back to back on the caller's stream.
//
// A pool is (v, w, t0, len) with value v / w; the top two pools merge while
//     v_q / w_q < max(v_p / w_p, 0) * g^len_p + smin.
//
// What bounds the first two on this card. Their bytes are a few MB, a few
// microseconds at 3.35 TB/s. Their time is set by serial chains of
// dependent events: a push or a merge per step, each an IEEE division, an
// expf and a stack access; per (trace, chunk) lane in pass 1, per trace in
// pass 2. So the designs keep each chain's state in registers and shared
// memory, shorten the chains where that is exact, and spread the chains
// over as many SMs as there are.
//
// oasis_chunk_pools: one thread per lane, one warp of 32 lanes per CTA, so
// K * nc lanes run on K * nc / 32 SMs. Each lane's stack (v, w, len) lives
// slot-major (slot i of lane j at [i * 32 + j]): in shared memory, where
// the lanes of the warp fall in 32 distinct banks whatever their stack
// depths, 384 * L bytes a CTA, so L <= 605 on this card's 227 KB; past
// that in a global scratch with the same layout a warp, where the lanes'
// accesses to one slot row fall in one 128-byte line (L2-resident: 4.7 MB
// at K = 192, T = 2000). The two bodies are one template. The top two pools
// stay in registers, the second with its g^len and merge threshold
// max(v / w, 0) * g^len + smin, computed when it becomes the second; a push
// reuses the top pool's quotient from its last test. The chunk's samples
// are staged in the v stack itself: a push of sample t writes slot n - 2 <
// t, so slot t holds y[t] until it is read. The staging forms pass 1's
// input where the solve asks for it (y - lam (1 - g), y - lam at the last
// sample), and the last chunk of a trace ends at T, so no padded copy of
// the traces is made. t0 is not stored: the write-out computes it as the
// chunk offset plus the running sum of lengths, and writes every slot, the
// (0, 1, 0, 0) tail included. A lane reads and writes its own rows in
// 16-byte pieces where L % 4 == 0 (on an H100, 4-byte pieces made the
// kernel 1.4-1.6x as slow at L = 128, K = 64 and 192). No lane touches
// another's slots, so the kernel has no barrier.
//
// oasis_pool_merge: one warp per trace. It rests on a property of pass 1:
// no two adjacent pools of a chunk's list violate each other (the last
// change to pool i+1 was followed by a test of (i, i+1) that found none,
// and pool i can change after that only by absorbing pool i+1). So once a
// pushed pool of chunk c does not merge, no later pool of chunk c can: the
// test of each compares two pools exactly as pass 1 left them. The warp
// pushes a chunk's pools serially only while they merge, then appends the
// rest untested, one pool per lane, coalesced. The merges happen in the
// same order on the same values as in the plain version's full push, so
// the output is the same bit for bit. The serial part runs in every lane
// on the same register values (the top two pools, the top's quotient and
// the second's threshold); pushes are fed by shuffles from the chunk's
// first 32 pools, which the warp loads in one coalesced read at the start
// of the chunk. Lane 0 alone
// stores the stack and, where a cascade reaches into earlier chunks,
// refills the second pool from the output row and shares it by shuffles.
// The whole warp writes the tail.
//
// oasis_reconstruct: bound by the bytes of c and s (K * T * 8) and of the
// live pools, about a microsecond at K = 192, T = 2000; its time is set by
// latency. A CTA of 256 threads writes one tile of 512 samples of one
// trace (the grid is K * tiles in x, so any K runs). It finds the tile's
// first pool by a 256-ary search over the sorted pool starts (one load a
// thread a round, two rounds up to 65,536 pools), stages the tile's pools
// (value, start) and the one before them in shared memory, and each thread
// then finds its samples' pools by a binary search there. Every c[t] and
// s[t] on [0, T) is written once, coalesced; a long pool costs what as
// many one-sample pools cost. Pools that start at or past T are never
// read.
//
// The arithmetic uses explicit round-to-nearest intrinsics so the compiler
// cannot contract it into FMAs: every operation rounds exactly as the plain
// PyTorch version's does, so the merge decisions agree and c and s are the
// plain version's.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// pass 1's three L-slot stacks of 32 lanes fit one CTA's opt-in shared
// memory up to this chunk length; longer chunks take the global-stack body
constexpr int kSmemOptin = 232448;  // bytes a CTA on Hopper
constexpr int kK2SmemMaxL = kSmemOptin / (3 * kWarp * 4);
// reconstruction: a CTA of kReconThreads threads writes kReconTile samples
constexpr int kReconThreads = 256;
constexpr int kReconTile = 512;

__device__ __forceinline__ float decay(float logg, int len) {
  return expf(__fmul_rn(logg, (float)len));
}

// --------------------------------------------------------------------- //
// pass 1
// --------------------------------------------------------------------- //
// y (K, row): lane (k, c) takes samples [c L, min(c L + L, T)) of row k.
// With lam it stages y - lam (1 - g), and y - lam at sample T - 1.
template <bool kGlobal>
__global__ void __launch_bounds__(kWarp) oasis_chunk_pools_kernel(
    const float* __restrict__ y, const float* __restrict__ g,
    const float* __restrict__ lam, const float* __restrict__ smin, int K,
    int T, int row, int nc, int L, bool vec_in, bool vec_out,
    float* scratch, float* __restrict__ v, float* __restrict__ w,
    int* __restrict__ ts, int* __restrict__ ln, int* __restrict__ n_out) {
  // three stacks of [L][32]: v, w, len; in shared memory, or in this
  // warp's part of the global scratch
  extern __shared__ float smem[];
  const size_t S = (size_t)L * kWarp;
  float* sv = kGlobal ? scratch + (size_t)blockIdx.x * 3 * S : smem;
  float* sw = sv + S;
  int* sl = reinterpret_cast<int*>(sw + S);
  const int j = threadIdx.x;
  const int lane = blockIdx.x * kWarp + j;
  if (lane >= K * nc) return;
  const int k = lane / nc;
  const int c0 = (lane - k * nc) * L;
  const int Lc = min(L, T - c0);
  const float gk = g[k];
  const float logg = logf(fmaxf(gk, 1e-10f));
  const float sm = smin[k];
  const float* yc = y + (size_t)k * row + c0;

  // stage the chunk: slot t of the v stack holds pass 1's input at c0 + t
  const bool adjust = lam != nullptr;
  const float lk = adjust ? lam[k] : 0.f;
  const float off = __fmul_rn(lk, __fsub_rn(1.f, gk));
  auto stage = [&](int t, float yt) {
    sv[t * kWarp + j] =
        adjust ? __fsub_rn(yt, c0 + t == T - 1 ? lk : off) : yt;
  };
  int t = 0;
  if (vec_in) {
    for (; t + 4 <= Lc; t += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(yc + t));
      stage(t, q.x);
      stage(t + 1, q.y);
      stage(t + 2, q.z);
      stage(t + 3, q.w);
    }
  }
  for (; t < Lc; ++t) stage(t, __ldg(yc + t));

  // slots 0 .. n-3 in the stacks; in registers the top (n-1) with its
  // quotient qt = vt / wt, and the second (n-2) with gls = g^ls and its
  // threshold ths
  float vt = 0.f, wt = 1.f, qt = 0.f, vs = 0.f, ws = 1.f, gls = 1.f,
        ths = 0.f;
  int lt = 0, ls = 0, n = 0;
  float yt = sv[j];
  for (t = 0; t < Lc; ++t) {
    // this step's stores reach slot n - 2 <= t - 2 at most
    const float y_next = t + 1 < Lc ? sv[(t + 1) * kWarp + j] : 0.f;
    if (n >= 2) {
      const int s = (n - 2) * kWarp + j;
      sv[s] = vs;
      sw[s] = ws;
      sl[s] = ls;
    }
    if (n >= 1) {
      vs = vt;
      ws = wt;
      ls = lt;
      gls = decay(logg, ls);
      ths = __fadd_rn(__fmul_rn(fmaxf(qt, 0.f), gls), sm);
    }
    vt = yt;
    wt = 1.f;
    lt = 1;
    qt = yt;  // y / 1, exactly
    ++n;
    while (n >= 2 && qt < ths) {
      vt = __fadd_rn(vs, __fmul_rn(vt, gls));
      wt = __fadd_rn(ws, __fmul_rn(__fmul_rn(wt, gls), gls));
      lt += ls;
      qt = vt / wt;
      --n;
      if (n >= 2) {
        const int s = (n - 2) * kWarp + j;
        vs = sv[s];
        ws = sw[s];
        ls = sl[s];
        gls = decay(logg, ls);
        ths = __fadd_rn(__fmul_rn(fmaxf(vs / ws, 0.f), gls), sm);
      }
    }
    yt = y_next;
  }
  if (n >= 2) {
    sv[(n - 2) * kWarp + j] = vs;
    sw[(n - 2) * kWarp + j] = ws;
    sl[(n - 2) * kWarp + j] = ls;
  }
  if (n >= 1) {
    sv[(n - 1) * kWarp + j] = vt;
    sw[(n - 1) * kWarp + j] = wt;
    sl[(n - 1) * kWarp + j] = lt;
  }

  // write every slot: pools with their start times, then (0, 1, 0, 0)
  const size_t base = (size_t)lane * L;
  int t0 = c0;
  if (vec_out) {
    for (int q = 0; q < L / 4; ++q) {
      float a[4], b[4];
      int c[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        const bool live = i < n;
        a[e] = live ? sv[i * kWarp + j] : 0.f;
        b[e] = live ? sw[i * kWarp + j] : 1.f;
        d[e] = live ? sl[i * kWarp + j] : 0;
        c[e] = live ? t0 : 0;
        t0 += d[e];
      }
      reinterpret_cast<float4*>(v + base)[q] = make_float4(a[0], a[1], a[2],
                                                           a[3]);
      reinterpret_cast<float4*>(w + base)[q] = make_float4(b[0], b[1], b[2],
                                                           b[3]);
      reinterpret_cast<int4*>(ts + base)[q] = make_int4(c[0], c[1], c[2],
                                                        c[3]);
      reinterpret_cast<int4*>(ln + base)[q] = make_int4(d[0], d[1], d[2],
                                                        d[3]);
    }
  } else {
    for (int i = 0; i < L; ++i) {
      const bool live = i < n;
      const int l = live ? sl[i * kWarp + j] : 0;
      v[base + i] = live ? sv[i * kWarp + j] : 0.f;
      w[base + i] = live ? sw[i * kWarp + j] : 1.f;
      ts[base + i] = live ? t0 : 0;
      ln[base + i] = l;
      t0 += l;
    }
  }
  n_out[lane] = n;
}

// --------------------------------------------------------------------- //
// pass 2
// --------------------------------------------------------------------- //
struct Pool {
  float v, w;
  int t, l;
};

__device__ __forceinline__ Pool shfl_pool(const Pool& p, int src) {
  return {__shfl_sync(kFull, p.v, src), __shfl_sync(kFull, p.w, src),
          __shfl_sync(kFull, p.t, src), __shfl_sync(kFull, p.l, src)};
}

__global__ void __launch_bounds__(kWarp) oasis_pool_merge_kernel(
    const float* __restrict__ v0, const float* __restrict__ w0,
    const int* __restrict__ ts0, const int* __restrict__ l0,
    const int* __restrict__ n_in, const float* __restrict__ g,
    const float* __restrict__ smin, int nc, int L, float* v, float* w,
    int* ts, int* ln, int* n_out) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  const float logg = logf(fmaxf(g[k], 1e-10f));
  const float sm = smin[k];
  const size_t P = (size_t)nc * L;
  const size_t in_k = (size_t)k * P;
  float* vk = v + in_k;
  float* wk = w + in_k;
  int* tk = ts + in_k;
  int* lk = ln + in_k;

  auto load_in = [&](size_t i) -> Pool {
    return {__ldg(v0 + i), __ldg(w0 + i), __ldg(ts0 + i), __ldg(l0 + i)};
  };
  auto store_out = [&](size_t s, const Pool& p) {
    vk[s] = p.v;
    wk[s] = p.w;
    tk[s] = p.t;
    lk[s] = p.l;
  };
  const Pool empty = {0.f, 1.f, 0, 0};

  // the top two pools, the same in every lane: the top with its quotient
  // qt = v / w, the second with its g^len (gls) and merge threshold (ths).
  // Slots 0 .. n-3 live in the output row, written by lane 0 or, for
  // appended pools, by the whole warp
  Pool top = empty, sec = empty;
  float qt = 0.f, gls = 1.f, ths = 0.f;
  int n = 0;
  // the second from a pool whose quotient is known
  auto set_second = [&](const Pool& p, float q) {
    sec = p;
    gls = decay(logg, sec.l);
    ths = __fadd_rn(__fmul_rn(fmaxf(q, 0.f), gls), sm);
  };

  for (int c = 0; c < nc; ++c) {
    const size_t src = in_k + (size_t)c * L;
    // the chunk's first 32 pools, pool `lane` in lane `lane`, coalesced
    const Pool win = lane < L ? load_in(src + lane) : empty;
    const int m = __ldg(n_in + (size_t)k * nc + c);
    // pool i of the chunk, in every lane (i is the same in every lane)
    auto pool_at = [&](int i) -> Pool {
      return i < kWarp ? shfl_pool(win, i) : load_in(src + i);
    };

    // push while the pushes merge
    int i = 0;
    while (i < m) {
      const Pool q = pool_at(i++);
      if (n >= 2 && lane == 0) store_out(n - 2, sec);
      if (n >= 1) set_second(top, qt);
      top = q;
      qt = q.v / q.w;
      ++n;
      bool merged = false;
      while (n >= 2 && qt < ths) {
        top.v = __fadd_rn(sec.v, __fmul_rn(top.v, gls));
        top.w = __fadd_rn(sec.w, __fmul_rn(__fmul_rn(top.w, gls), gls));
        top.t = sec.t;
        top.l += sec.l;
        qt = top.v / top.w;
        --n;
        merged = true;
        if (n >= 2) {
          Pool r = empty;
          if (lane == 0) r = {vk[n - 2], wk[n - 2], tk[n - 2], lk[n - 2]};
          r = shfl_pool(r, 0);
          set_second(r, r.v / r.w);
        }
      }
      if (!merged) break;
    }

    // the rest of the chunk cannot merge: append pools i .. m-1
    const int cnt = m - i;
    if (cnt > 0) {
      if (lane == 0) {
        if (n >= 2) store_out(n - 2, sec);
        store_out(n - 1, top);
      }
      __syncwarp();
      for (int b = i & ~(kWarp - 1); b < m; b += kWarp) {
        const int idx = b + lane;
        if (idx >= i && idx < m) {
          store_out(n + idx - i, b == 0 ? win : load_in(src + idx));
        }
      }
      const Pool last = pool_at(m - 1);
      if (cnt >= 2) {
        const Pool p = pool_at(m - 2);
        set_second(p, p.v / p.w);
      } else {
        set_second(top, qt);
      }
      top = last;
      qt = last.v / last.w;
      n += cnt;
      __syncwarp();
    }
  }

  if (lane == 0) {
    if (n >= 2) store_out(n - 2, sec);
    if (n >= 1) store_out(n - 1, top);
    n_out[k] = n;
  }
  __syncwarp();
  for (size_t s = n + lane; s < P; s += kWarp) store_out(s, empty);
}

// --------------------------------------------------------------------- //
// reconstruction
// --------------------------------------------------------------------- //
// CTA b writes samples [tile * kReconTile, +kReconTile) of trace
// b / tiles, tile = b % tiles; P pool slots a trace, the first n[k] live
// with sorted starts (n[k] = 0 reads slot 0, as the plain version does).
__global__ void __launch_bounds__(kReconThreads) oasis_reconstruct_kernel(
    const float* __restrict__ v, const float* __restrict__ w,
    const int* __restrict__ ts, const int* __restrict__ n,
    const float* __restrict__ g, int P, int T, int tiles,
    float* __restrict__ c, float* __restrict__ s) {
  // slot i holds pool j0 - 1 + i: its value max(v / w, 0) and its start
  __shared__ float s_val[kReconTile + 1];
  __shared__ int s_t0[kReconTile + 1];
  const int k = blockIdx.x / tiles;
  const int lo_t = (blockIdx.x - k * tiles) * kReconTile;
  const int hi_t = min(lo_t + kReconTile, T);
  const size_t base = (size_t)k * P;
  const int* tk = ts + base;
  const int np = max(__ldg(n + k), 1);

  // j0, the last pool that starts at or before lo_t: each round narrows
  // [lo, hi) to one of 256 strides, one load a thread
  int lo = 0, hi = np;
  while (hi - lo > 1) {
    const int step = (hi - lo + kReconThreads - 1) / kReconThreads;
    const int idx = lo + (int)threadIdx.x * step;
    const int below =
        __syncthreads_count(idx < hi && __ldg(tk + idx) <= lo_t);
    lo += max(below - 1, 0) * step;
    hi = min(lo + step, hi);
  }
  const int j0 = lo;
  // the tile holds at most one pool a sample: j0 .. j0 + m - 1
  const int m = min(np - j0, hi_t - lo_t);
  for (int i = threadIdx.x; i <= m; i += kReconThreads) {
    const int j = j0 - 1 + i;
    float val = 0.f;
    int t0 = 0;
    if (j >= 0) {
      val = fmaxf(__ldg(v + base + j) / fmaxf(__ldg(w + base + j), 1e-20f),
                  0.f);
      t0 = __ldg(tk + j);
    }
    s_val[i] = val;
    s_t0[i] = t0;
  }
  __syncthreads();

  const float gk = __ldg(g + k);
  const float logg = logf(fmaxf(gk, 1e-10f));
  float* ck = c + (size_t)k * T;
  float* sk = s + (size_t)k * T;
  for (int t = lo_t + threadIdx.x; t < hi_t; t += kReconThreads) {
    // the last slot of 1 .. m whose pool starts at or before t
    int a = 1, b = m + 1;
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (s_t0[mid] <= t) {
        a = mid;
      } else {
        b = mid;
      }
    }
    const int t0 = s_t0[a];
    const float ct =
        __fmul_rn(s_val[a], expf(__fmul_rn(logg, (float)(t - t0))));
    float st = 0.f;
    if (t == t0 && t > 0) {
      // the spike at the pool start: c[t0] - g * c[t0 - 1], with c[t0 - 1]
      // the previous pool's decayed end
      const float prev = __fmul_rn(
          s_val[a - 1], expf(__fmul_rn(logg, (float)(t - 1 - s_t0[a - 1]))));
      st = __fsub_rn(ct, __fmul_rn(gk, prev));
    }
    ck[t] = ct;
    sk[t] = st;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lets a kernel take dynamic shared memory past 48 KB, up to the device's
// opt-in limit; the attribute is set once per device.
template <typename Kernel>
cudaError_t allow_optin_smem(Kernel kernel) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && done[dev])) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

// the global stacks of pass 1 for `lanes` lanes of chunk length L, in
// floats: three [L][32] stacks a warp
size_t k2_scratch_floats(size_t lanes, int L) {
  return (lanes + kWarp - 1) / kWarp * 3 * (size_t)L * kWarp;
}

int launch_chunk_pools(const float* y, const float* g, const float* lam,
                       const float* smin, int K, int T, int row, int L,
                       float* scratch, float* v, float* w, int* ts, int* ln,
                       int* n, cudaStream_t stream) {
  const int nc = (T + L - 1) / L;
  const int lanes = K * nc;
  if (lanes <= 0) return 0;
  const int ctas = (lanes + kWarp - 1) / kWarp;
  const bool vec_in = L % 4 == 0 && row % 4 == 0 && aligned16(y);
  const bool vec_out = L % 4 == 0 && aligned16(v) && aligned16(w) &&
                       aligned16(ts) && aligned16(ln);
  if (L > kK2SmemMaxL) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    oasis_chunk_pools_kernel<true><<<ctas, kWarp, 0, stream>>>(
        y, g, lam, smin, K, T, row, nc, L, vec_in, vec_out, scratch, v, w,
        ts, ln, n);
  } else {
    const int smem = 3 * L * kWarp * (int)sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err =
          allow_optin_smem(oasis_chunk_pools_kernel<false>);
      if (err != cudaSuccess) return (int)err;
    }
    oasis_chunk_pools_kernel<false><<<ctas, kWarp, smem, stream>>>(
        y, g, lam, smin, K, T, row, nc, L, vec_in, vec_out, nullptr, v, w,
        ts, ln, n);
  }
  return (int)cudaGetLastError();
}

// The solve's workspace, carved from one allocation (or, with base null,
// only measured): pass 1's pools and counts, pass 2's, and pass 1's global
// stacks where L needs them; each array 256-byte aligned.
struct SolveBuffers {
  float *v1, *w1;
  int *t1, *l1, *n1;
  float *v2, *w2;
  int *t2, *l2, *n2;
  float* scratch;
  size_t bytes;
};

SolveBuffers solve_buffers(char* base, int K, int T, int L) {
  size_t off = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  const size_t nc = (T + L - 1) / L;
  const size_t lanes = (size_t)K * nc;
  const size_t slots = lanes * L;
  SolveBuffers b;
  b.v1 = reinterpret_cast<float*>(take(slots * 4));
  b.w1 = reinterpret_cast<float*>(take(slots * 4));
  b.t1 = reinterpret_cast<int*>(take(slots * 4));
  b.l1 = reinterpret_cast<int*>(take(slots * 4));
  b.n1 = reinterpret_cast<int*>(take(lanes * 4));
  b.v2 = reinterpret_cast<float*>(take(slots * 4));
  b.w2 = reinterpret_cast<float*>(take(slots * 4));
  b.t2 = reinterpret_cast<int*>(take(slots * 4));
  b.l2 = reinterpret_cast<int*>(take(slots * 4));
  b.n2 = reinterpret_cast<int*>(take((size_t)K * 4));
  b.scratch = L > kK2SmemMaxL
                  ? reinterpret_cast<float*>(
                        take(k2_scratch_floats(lanes, L) * 4))
                  : nullptr;
  b.bytes = off;
  return b;
}

}  // namespace

extern "C" int oasis_chunk_pools_launch(const float* vinit, const float* g,
                                        const float* smin, int K, int nc,
                                        int L, float* scratch, float* v,
                                        float* w, int* ts, int* ln, int* n,
                                        void* stream) {
  return launch_chunk_pools(vinit, g, nullptr, smin, K, nc * L, nc * L, L,
                            scratch, v, w, ts, ln, n, (cudaStream_t)stream);
}

extern "C" int oasis_pool_merge_launch(const float* v0, const float* w0,
                                       const int* ts0, const int* l0,
                                       const int* n_in, const float* g,
                                       const float* smin, int K, int nc,
                                       int L, float* v, float* w, int* ts,
                                       int* ln, int* n, void* stream) {
  if (K <= 0) return 0;
  // one warp per trace, one warp per CTA: K = 64 traces run on 64 SMs
  oasis_pool_merge_kernel<<<K, kWarp, 0, (cudaStream_t)stream>>>(
      v0, w0, ts0, l0, n_in, g, smin, nc, L, v, w, ts, ln, n);
  return (int)cudaGetLastError();
}

extern "C" int oasis_reconstruct_launch(const float* v, const float* w,
                                        const int* ts, const int* n,
                                        const float* g, int K, int P, int T,
                                        float* c, float* s, void* stream) {
  const int tiles = (T + kReconTile - 1) / kReconTile;
  const long long ctas = (long long)K * tiles;
  if (ctas <= 0) return 0;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  oasis_reconstruct_kernel<<<(unsigned)ctas, kReconThreads, 0,
                             (cudaStream_t)stream>>>(v, w, ts, n, g, P, T,
                                                     tiles, c, s);
  return (int)cudaGetLastError();
}

// Bytes of the workspace oasis_solve_launch takes for (K, T, L).
extern "C" long long oasis_solve_workspace(int K, int T, int L) {
  return (long long)solve_buffers(nullptr, K, T, L).bytes;
}

// The whole solve: y (K, T) and g, lam, smin (K,) -> c, s (K, T), pass 1
// on chunks of L (the last one ending at T), pass 2, the reconstruction;
// three launches on `stream`, no host work between them.
extern "C" int oasis_solve_launch(const float* y, const float* g,
                                  const float* lam, const float* smin, int K,
                                  int T, int L, void* workspace, float* c,
                                  float* s, void* stream) {
  if (K <= 0 || T <= 0) return 0;
  const SolveBuffers b =
      solve_buffers(static_cast<char*>(workspace), K, T, L);
  const int nc = (T + L - 1) / L;
  int err = launch_chunk_pools(y, g, lam, smin, K, T, T, L, b.scratch, b.v1,
                               b.w1, b.t1, b.l1, b.n1,
                               (cudaStream_t)stream);
  if (err != 0) return err;
  err = oasis_pool_merge_launch(b.v1, b.w1, b.t1, b.l1, b.n1, g, smin, K, nc,
                                L, b.v2, b.w2, b.t2, b.l2, b.n2, stream);
  if (err != 0) return err;
  return oasis_reconstruct_launch(b.v2, b.w2, b.t2, b.n2, g, K, nc * L, T, c,
                                  s, stream);
}
