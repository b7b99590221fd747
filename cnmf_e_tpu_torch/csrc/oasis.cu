// Divide-and-conquer OASIS AR(1) (oasisAR1.m:59-109): the three kernels of
// cnmf_e_tpu/ops/pallas_oasis.py::oasis_ar1_pallas_dc.
//
//   oasis_chunk_pools  replaces _oasis_pools_pallas (body _oasis_kernel):
//                      the sample-level pool stack over each length-L
//                      chunk of each trace.
//   oasis_pool_merge   replaces _pool_merge_pallas (body
//                      _pool_event_kernel): pushes the chunk pool lists of a
//                      trace in order and resolves violations across chunks
//                      (exact: pool merging is confluent).
//   oasis_reconstruct  replaces _reconstruct_pallas (body
//                      _reconstruct_kernel): one thread per (trace, pool)
//                      writes c on the pool's range and s at its start.
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
// in shared memory, slot-major (slot i of lane j at [i * 32 + j]), so the
// lanes of the warp fall in 32 distinct banks whatever their stack depths:
// 384 * L bytes a CTA, which caps L at 605 on this card's 227 KB. The top
// two pools stay in registers, the second with its g^len and merge
// threshold max(v / w, 0) * g^len + smin, computed when it becomes the
// second; a push reuses the top pool's quotient from its last test. The
// chunk's samples are staged in the v stack itself: a push of sample t
// writes slot n - 2 < t, so slot t holds y[t] until it is read. t0 is not
// stored: the write-out computes it as the chunk offset plus the running
// sum of lengths, and writes every slot, the (0, 1, 0, 0) tail included.
// A lane reads and writes its own rows in 16-byte pieces where L % 4 == 0
// (on an H100, 4-byte pieces made the kernel 1.4-1.6x as slow at L = 128,
// K = 64 and 192). No lane touches another's slots, so the kernel has no
// barrier.
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
// The merge arithmetic uses explicit round-to-nearest intrinsics so the
// compiler cannot contract it into FMAs: every operation rounds exactly as
// the plain PyTorch version's does, and the merge decisions agree.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float decay(float logg, int len) {
  return expf(__fmul_rn(logg, (float)len));
}

// --------------------------------------------------------------------- //
// pass 1
// --------------------------------------------------------------------- //
__global__ void __launch_bounds__(kWarp) oasis_chunk_pools_kernel(
    const float* __restrict__ vinit, const float* __restrict__ g,
    const float* __restrict__ smin, int K, int nc, int L, bool vec,
    float* __restrict__ v, float* __restrict__ w, int* __restrict__ ts,
    int* __restrict__ ln, int* __restrict__ n_out) {
  // three stacks of [L][32]: v, w, len
  extern __shared__ float smem[];
  const size_t S = (size_t)L * kWarp;
  float* sv = smem;
  float* sw = sv + S;
  int* sl = reinterpret_cast<int*>(sw + S);
  const int j = threadIdx.x;
  const int lane = blockIdx.x * kWarp + j;
  if (lane >= K * nc) return;
  const int k = lane / nc;
  const float logg = logf(fmaxf(g[k], 1e-10f));
  const float sm = smin[k];
  const size_t base = (size_t)lane * L;

  // stage the chunk: slot t of the v stack holds y[t]
  if (vec) {
    const float4* y4 = reinterpret_cast<const float4*>(vinit + base);
    for (int q = 0; q < L / 4; ++q) {
      const float4 y = __ldg(y4 + q);
      sv[(4 * q + 0) * kWarp + j] = y.x;
      sv[(4 * q + 1) * kWarp + j] = y.y;
      sv[(4 * q + 2) * kWarp + j] = y.z;
      sv[(4 * q + 3) * kWarp + j] = y.w;
    }
  } else {
    for (int t = 0; t < L; ++t) sv[t * kWarp + j] = __ldg(vinit + base + t);
  }

  // slots 0 .. n-3 in shared memory; in registers the top (n-1) with its
  // quotient qt = vt / wt, and the second (n-2) with gls = g^ls and its
  // threshold ths
  float vt = 0.f, wt = 1.f, qt = 0.f, vs = 0.f, ws = 1.f, gls = 1.f,
        ths = 0.f;
  int lt = 0, ls = 0, n = 0;
  float y = sv[j];
  for (int t = 0; t < L; ++t) {
    // this step's stores reach slot n - 2 <= t - 2 at most
    const float y_next = t + 1 < L ? sv[(t + 1) * kWarp + j] : 0.f;
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
    vt = y;
    wt = 1.f;
    lt = 1;
    qt = y;  // y / 1, exactly
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
    y = y_next;
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
  int t0 = (lane - k * nc) * L;
  if (vec) {
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

}  // namespace

extern "C" int oasis_chunk_pools_launch(const float* vinit, const float* g,
                                        const float* smin, int K, int nc,
                                        int L, float* v, float* w, int* ts,
                                        int* ln, int* n, void* stream) {
  const int lanes = K * nc;
  if (lanes <= 0) return 0;
  // three stacks of L slots of 32 lanes each
  const int smem = 3 * L * kWarp * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_optin_smem(oasis_chunk_pools_kernel);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = L % 4 == 0 && aligned16(vinit) && aligned16(v) &&
                   aligned16(w) && aligned16(ts) && aligned16(ln);
  oasis_chunk_pools_kernel<<<(lanes + kWarp - 1) / kWarp, kWarp, smem,
                             (cudaStream_t)stream>>>(vinit, g, smin, K, nc, L,
                                                     vec, v, w, ts, ln, n);
  return (int)cudaGetLastError();
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
