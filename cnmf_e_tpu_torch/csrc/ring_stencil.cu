// Direct f32 ring stencil (K6):
//     out[t, h, w] = w0[h, w] + sum_r wt[r, h*W + w] * X[t, h + dy_r, w + dx_r]
// with X zero outside the field of view.
//
// Replaces the TPU kernel cnmf_e_tpu/ops/pallas_ring.py: apply_ring_pallas
// (body _ring_kernel). That kernel runs in an (H, T, W) layout and rolls
// lanes so a tap's weight broadcasts without a relayout; none of that
// carries over.
//
// What bounds it on an H100: at 256 x 256 x 2000 frames with R = 92 taps
// (radius 13) the movie is read once and the output written once (1.05 GB,
// 0.31 ms at 3.35 TB/s), and the 12.06 G products cost 24.2 GFLOP of
// separate multiplies and adds (0.36 ms at the 67 TFLOP/s FP32 peak). A
// kernel that reads each product's halo value from shared memory moves 4
// bytes a product, 48 GB, and shared memory serves 128 bytes a clock on each
// of the 132 SMs: about 1.6 ms at 1.75 GHz. That shared-memory floor, not
// HBM and not the FP32 pipes, bounds a design that keeps each pixel's
// weights in one thread.
//
// Two bodies, picked by the wrapper on the shape (ops/ring_kernels.py,
// _stencil_plan):
//
// ring_stencil_regs_kernel<RADIUS> (integer radius <= kMaxRegRadius = 14,
// so R <= 92, and W % 4 == 0): the taps in registers.
//   * One thread a pixel of an 8 x 32 tile (one warp a tile row); the
//     thread loads its pixel's R weights once into registers and keeps them
//     for every frame it walks, so shared memory holds only frame halos.
//   * The tap offsets are compile-time: the ring's taps are generated by a
//     constexpr walk in ring_offsets' order (dy outer, dx inner, distance in
//     [radius, radius + 1)), one template per radius, so each tap's halo
//     address is an immediate and a tap costs one shared load a frame.
//   * F frames a thread: F independent sums, each over the taps in offset
//     order, break the dependent add chain.
//   * Halos of F frames are staged kStages - 1 groups ahead, each group by
//     one TMA tile load of an (F, HH, WW) box of the (T, H, W) movie that
//     one thread issues and an mbarrier reports: the load's out-of-bounds
//     zero fill is the zero padding, and no other thread spends an
//     instruction on the copy (the tensor map needs W % 4 == 0: 16-byte
//     row strides).
//   * Up to kWideTaps = 56 taps (radius 9 and below), F = 4 and two CTAs
//     (16 warps) an SM: 128 registers a thread hold the weights without a
//     spill. Past that ptxas spilled at the two-CTA cap (328 bytes at
//     radius 13), so wider rings take F = 8 and one CTA an SM with up to
//     255 registers (209 at radius 13) and 204 KB of halos.
//   Measured on an H100 at 700 W (scripts_torch/ring_variants.py,
//   chip_smoke.py): 1.78 ms at the step's shape, about 1.1x the
//   shared-memory floor, where every thread's 16-byte cp.async copies of
//   the halos (17 a thread a group, with their index arithmetic) took 2.73;
//   0.28 ms on the fit's 128 x 128 grid at radius 9 against 0.39.
//   Reusing halo values from registers across neighbouring pixels would
//   cut the shared loads further, but every extra pixel a thread owns costs
//   R more weight registers (184 of 255 for two pixels at R = 92, before
//   the frames' sums and addresses); it is not taken.
//
// ring_stencil_smem_kernel (every other shape: a radius past the register
// cap, a non-integer radius, W % 4 != 0): the weights in shared memory.
//   One thread a pixel of an HT x WT tile walking its frames one at a time;
//   the tile's (R, HT*WT) weights in shared memory; the halo of frame t + 1
//   streamed in by 4-byte cp.async copies while frame t is summed. Each tap
//   costs three shared loads (weight, halo value, offset).
//
// Rounding: both bodies compute each tap as a separate round-to-nearest
// multiply and add (__fmul_rn, __fadd_rn: no FMA contraction) in offset
// order, then add w0: the plain version's arithmetic, so both agree with
// it bit for bit.

#include <cuda.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

// ------------------------------------------------------------------ //
// the register body
// ------------------------------------------------------------------ //
constexpr int kHT = 8;                 // pixel tile rows
constexpr int kWT = 32;                // pixel tile columns: a warp a row
constexpr int kRegThreads = kHT * kWT;
constexpr int kStages = 3;             // frame groups in shared memory
constexpr int kWideTaps = 56;          // rings of more taps build wide:
constexpr int kFNarrow = 4;            // frames a thread, two CTAs an SM
constexpr int kFWide = 8;              // frames a thread, one CTA an SM
// radius 15's wide halos (3 x 8 frames of 38 x 64) take 233,472 bytes,
// past the 232,448 a CTA can have
constexpr int kMaxRegRadius = 14;

// the r-th tap of the integer-radius ring (dx when want_dx), or the tap
// count for r = -1
constexpr int ring_tap(int rad, int r, bool want_dx) {
  int n = 0;
  for (int y = -rad - 1; y <= rad + 1; ++y)
    for (int x = -rad - 1; x <= rad + 1; ++x) {
      const int q = y * y + x * x;
      if (q >= rad * rad && q < (rad + 1) * (rad + 1)) {
        if (n == r) return want_dx ? x : y;
        ++n;
      }
    }
  return n;
}

template <int RAD>
struct RegGeom {
  static constexpr int R = ring_tap(RAD, -1, false);
  static constexpr bool kWide = R > kWideTaps;
  static constexpr int F = kWide ? kFWide : kFNarrow;
  static constexpr int kMinCtas = kWide ? 1 : 2;
  static constexpr int MRA = (RAD + 3) / 4 * 4;  // halo column margin
  static constexpr int HH = kHT + 2 * RAD;       // halo rows
  static constexpr int WW = kWT + 2 * MRA;       // halo columns, % 4 == 0
  static constexpr int FS = HH * WW;             // floats a frame halo
  static constexpr int SS = F * FS;              // floats a stage
  static constexpr size_t kSmem = (size_t)kStages * SS * sizeof(float);
};

template <int RAD, int r>
struct TapOffset {   // the tap's halo offset from its pixel's own slot
  static constexpr int value =
      (RAD + ring_tap(RAD, r, false)) * RegGeom<RAD>::WW +
      RegGeom<RAD>::MRA + ring_tap(RAD, r, true);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the (F, HH, WW) box at (frame z, row y, column x) into dst; bar counts
// its bytes
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, uint32_t bytes, int x,
                                        int y, int z) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(x), "r"(y),
      "r"(z)
      : "memory");
}

template <int RAD, int r>
__device__ __forceinline__ void add_tap(float (&acc)[RegGeom<RAD>::F],
                                        float w, const float* p) {
  constexpr int off = TapOffset<RAD, r>::value;
#pragma unroll
  for (int f = 0; f < RegGeom<RAD>::F; ++f)
    acc[f] = __fadd_rn(acc[f], __fmul_rn(w, p[f * RegGeom<RAD>::FS + off]));
}

// every tap in offset order (a comma fold runs left to right)
template <int RAD, int... r>
__device__ __forceinline__ void add_taps(float (&acc)[RegGeom<RAD>::F],
                                         const float (&w)[sizeof...(r)],
                                         const float* p,
                                         std::integer_sequence<int, r...>) {
  (add_tap<RAD, r>(acc, w[r], p), ...);
}

template <int RAD>
__global__ void __launch_bounds__(kRegThreads, RegGeom<RAD>::kMinCtas)
ring_stencil_regs_kernel(const __grid_constant__ CUtensorMap xmap,
                         const float* __restrict__ wt,
                         const float* __restrict__ w0,
                         float* __restrict__ out, int T, int H, int W,
                         int TT) {
  using G = RegGeom<RAD>;
  constexpr int F = G::F;
  extern __shared__ __align__(1024) float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);        // kStages halo groups
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + kStages * G::SS);
  const int c0 = blockIdx.x * kWT, h0 = blockIdx.y * kHT;
  const int t0 = blockIdx.z * TT, t1 = min(t0 + TT, T);
  const int n_groups = (t1 - t0 + F - 1) / F;
  const int tid = threadIdx.x;
  const int ly = tid / kWT, lx = tid % kWT;
  const int h = h0 + ly, w = c0 + lx;
  const bool mine = h < H && w < W;
  const size_t HW = (size_t)H * W;

  // group g's F frames into buffer g % kStages (thread 0 only); frames
  // past T and pixels outside the field of view arrive as zeros
  auto stage = [&](int g) {
    tma_box(xs + (g % kStages) * G::SS, &xmap, full + g % kStages,
            G::SS * sizeof(float), c0 - G::MRA, h0 - RAD, t0 + g * F);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < kStages - 1 && g < n_groups; ++g) stage(g);
  float wr[G::R];
#pragma unroll
  for (int r = 0; r < G::R; ++r)
    wr[r] = mine ? wt[(size_t)r * HW + (size_t)h * W + w] : 0.f;
  const float b = mine ? w0[(size_t)h * W + w] : 0.f;
  const float* own = xs + ly * G::WW + lx;

  for (int g = 0; g < n_groups; ++g) {
    mbar_wait(full + g % kStages, (g / kStages) & 1);
    // every thread is done with group g - 1's buffer, which the next
    // stage overwrites
    __syncthreads();
    if (tid == 0 && g + kStages - 1 < n_groups) stage(g + kStages - 1);
    float acc[F] = {};
    add_taps<RAD>(acc, wr, own + (g % kStages) * G::SS,
                  std::make_integer_sequence<int, G::R>{});
    if (mine) {
      const int tg = t0 + g * F;
#pragma unroll
      for (int f = 0; f < F; ++f)
        if (tg + f < t1)
          out[(size_t)(tg + f) * HW + (size_t)h * W + w] =
              __fadd_rn(acc[f], b);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <int RAD>
int launch_regs(const float* X, const float* wt, const float* w0, float* out,
                int T, int H, int W, int TT, cudaStream_t stream) {
  using G = RegGeom<RAD>;
  if (TT % G::F) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(float),
                                 (cuuint64_t)H * W * sizeof(float)};
  const cuuint32_t box[3] = {G::WW, G::HH, G::F}, unit[3] = {1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(X), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = G::kSmem + kStages * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      ring_stencil_regs_kernel<RAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kWT - 1) / kWT, (H + kHT - 1) / kHT,
                  (T + TT - 1) / TT);
  ring_stencil_regs_kernel<RAD><<<grid, kRegThreads, smem, stream>>>(
      xmap, wt, w0, out, T, H, W, TT);
  return (int)cudaGetLastError();
}

// the instantiation for `radius`, one per radius 1 .. kMaxRegRadius
template <int RAD>
int launch_regs_radius(int radius, const float* X, const float* wt,
                       const float* w0, float* out, int T, int H, int W,
                       int TT, cudaStream_t stream) {
  if (radius == RAD) return launch_regs<RAD>(X, wt, w0, out, T, H, W, TT,
                                             stream);
  if constexpr (RAD > 1)
    return launch_regs_radius<RAD - 1>(radius, X, wt, w0, out, T, H, W, TT,
                                       stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ //
// the shared-memory body
// ------------------------------------------------------------------ //
// Copy the (HH, WW) halo of frame t into buf with asynchronous copies
// (zero outside the field of view) and commit them as one group.
__device__ __forceinline__ void stage_halo(const float* __restrict__ X,
                                           float* buf, int t, int H, int W,
                                           int h0, int c0, int mr, int HH,
                                           int WW, int P, int tid) {
  const float* Xt = X + (size_t)t * H * W;
  const int drow = P / WW, dcol = P - drow * WW;
  int row = tid / WW, col = tid - row * WW;
  for (int i = tid; i < HH * WW; i += P) {
    const int yy = h0 - mr + row, xx = c0 - mr + col;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    __pipeline_memcpy_async(buf + i, in ? Xt + (size_t)yy * W + xx : X, 4,
                            in ? 0 : 4);
    row += drow;
    col += dcol;
    if (col >= WW) {
      col -= WW;
      ++row;
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(256)
ring_stencil_smem_kernel(const float* __restrict__ X,
                         const float* __restrict__ wt,
                         const float* __restrict__ w0,
                         const int* __restrict__ dy,
                         const int* __restrict__ dx, float* __restrict__ out,
                         int T, int H, int W, int R, int mr, int HT, int WT,
                         int TT) {
  extern __shared__ float smem[];
  const int P = HT * WT;                       // pixels = threads per CTA
  const int HH = HT + 2 * mr, WW = WT + 2 * mr;
  float* ws = smem;                            // (R, P) tap weights
  float* xs = ws + (size_t)R * P;              // 2 x (HH, WW) frame halos
  int* offs = reinterpret_cast<int*>(xs + 2 * HH * WW);  // (R) into a halo
  const int c0 = blockIdx.x * WT, h0 = blockIdx.y * HT;
  const int t0 = blockIdx.z * TT, t1 = min(t0 + TT, T);
  const int tid = threadIdx.x;
  const int ly = tid / WT, lx = tid - ly * WT;
  const int h = h0 + ly, w = c0 + lx;
  const bool mine = h < H && w < W;
  const size_t HW = (size_t)H * W;

  stage_halo(X, xs, t0, H, W, h0, c0, mr, HH, WW, P, tid);
  for (int i = tid; i < R * P; i += blockDim.x) {
    const int r = i / P, j = i - r * P;
    const int hj = h0 + j / WT, wj = c0 + j % WT;
    ws[i] = (hj < H && wj < W) ? wt[(size_t)r * HW + (size_t)hj * W + wj]
                               : 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x)
    offs[r] = (mr + dy[r]) * WW + (mr + dx[r]);
  const float b = mine ? w0[(size_t)h * W + w] : 0.f;
  const int base = ly * WW + lx;

  for (int t = t0; t < t1; ++t) {
    const float* cur = xs + ((t - t0) & 1) * HH * WW;
    if (t + 1 < t1) {
      // the other buffer was last read in frame t - 1, before the barrier
      // that closed it
      stage_halo(X, xs + ((t + 1 - t0) & 1) * HH * WW, t + 1, H, W, h0, c0,
                 mr, HH, WW, P, tid);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();          // frame t's halo (and the weights) are in
    if (mine) {
      float acc = 0.f;
#pragma unroll 4
      for (int r = 0; r < R; ++r)
        acc = __fadd_rn(acc, __fmul_rn(ws[r * P + tid], cur[base + offs[r]]));
      out[(size_t)t * HW + (size_t)h * W + w] = __fadd_rn(acc, b);
    }
    __syncthreads();          // frame t's halo is read
  }
}

}  // namespace

// X: (T, H, W); wt: (R, H*W); w0: (H*W); out: (T, H, W); the ring of
// integer radius `radius` (1 .. kMaxRegRadius); W % 4 == 0 and X 16-byte
// aligned; a CTA walks TT frames (a multiple of the frames a thread)
extern "C" int ring_stencil_regs_launch(const float* X, const float* wt,
                                        const float* w0, float* out, int T,
                                        int H, int W, int radius, int TT,
                                        void* stream) {
  if (W % 4 || radius < 1 || radius > kMaxRegRadius)
    return (int)cudaErrorInvalidValue;
  return launch_regs_radius<kMaxRegRadius>(radius, X, wt, w0, out, T, H, W,
                                           TT, (cudaStream_t)stream);
}

// X: (T, H, W); wt: (R, H*W); w0: (H*W); dy, dx: (R); out: (T, H, W)
extern "C" int ring_stencil_smem_launch(const float* X, const float* wt,
                                        const float* w0, const int* dy,
                                        const int* dx, float* out, int T,
                                        int H, int W, int R, int mr, int HT,
                                        int WT, int TT, void* stream) {
  const int HH = HT + 2 * mr, WW = WT + 2 * mr;
  const size_t smem = ((size_t)R * HT * WT + 2 * (size_t)HH * WW + R) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ring_stencil_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + WT - 1) / WT, (H + HT - 1) / HT, (T + TT - 1) / TT);
  ring_stencil_smem_kernel<<<grid, HT * WT, smem, (cudaStream_t)stream>>>(
      X, wt, w0, dy, dx, out, T, H, W, R, mr, HT, WT, TT);
  return (int)cudaGetLastError();
}
