// Banded bf16 ring product with f32 accumulation (K5 and K7):
//     out[t, h, w] = w0[h, w] + sum_k A_h[t, k] * bands[h, k, w],
//     A_h[t, d*W + w'] = X[row h + d - mr, frame t, column w'],  k < D*W,
// where X is the bf16 movie, zero in the rows outside [0, H) (the TPU
// kernels pad it with mr zero rows above and below; here the copies into
// shared memory zero-fill them), and D = 2*mr + 1 (the ring's row span).
//
// Replaces the TPU kernels cnmf_e_tpu/ops/pallas_ring_mxu.py:
//   ring_banded_flat  apply_ring_mxu_flat (body _mxu_flat_kernel): X is
//                     the flat (T, H * W) movie, so A_h is the contiguous
//                     column window [(h - mr)*W, (h - mr + D)*W);
//   ring_banded_htw   apply_ring_mxu (body _mxu_kernel): X is (H, T, W),
//                     so A_h is D row slabs of (T, W).
// One kernel body serves both (K7 is K5's body on other strides): the
// launchers pass the layout as the strides of X per frame (s_t) and per
// movie row (s_d). Both write out in (T, H, W).
//
// What bounds it on an H100: the function itself is the stencil's R taps a
// pixel, 24 GFLOP at 256 x 256 x 2000, radius 13 (0.02 ms at the 989
// TFLOP/s bf16 peak), and its bytes (the H*W*R band entries that hold a
// tap, the bf16 movie, w0 and the f32 output: 0.80 GB, 0.24 ms at 3.35
// TB/s). A dense (T x D*W) @ (D*W x W) product per output row does 1.81
// TFLOP, since about 90% of every band is structural zeros. This design:
//   * Visits only the 16-deep k blocks of a column tile that hold a tap:
//     for output columns [n0, n0 + TN) and band row d the taps lie in
//     d*W + [n0 + dxmin_d, n0 + TN - 1 + dxmax_d], clipped to [0, W). The
//     host lists those blocks per column tile (ops/ring_kernels.py,
//     banded_k_blocks), and the CTA walks its tile's list and reads no other
//     block of the bands: 2,376 of 6,912 k rows a tile at radius 13 and
//     W = 256, 0.62 TFLOP in all.
//   * A CTA owns TM = 256 frames x TN = 64 columns of one output row; its 8
//     warps (4 x 2) each hold a 64 x 32 tile of f32 sums in registers and
//     run mma.sync m16n8k16 bf16 on fragments read with ldmatrix (the B
//     tile transposed by ldmatrix.trans). Each band block is read once per
//     256 frames; holding a tile's whole band list (304 KB) in shared memory
//     is beyond the card.
//   * A two-stage cp.async ring of 16-byte copies feeds the tiles (four
//     listed blocks a stage, source size 0 zero-fills past T, past D*W,
//     past W and outside the field of view), so the next stage's loads
//     overlap the products; two CTAs an SM hide each other's barriers.
//   Measured on an H100 at 700 W (scripts_torch/ring_variants.py and
//   chip_smoke.py): four blocks a stage at two stages beat two at three by
//   7%; one CTA an SM was 15-40% slower in every build tried; sharing the
//   movie columns between two output rows a CTA (0.52 of their L2
//   traffic) made it 13% slower, so L2 traffic is not what holds it; TMA
//   boxes of 8 columns (16 bytes) over 256 frames made it 1.9x slower. What
//   holds it, whether the mma.sync rate, ldmatrix's shared-memory traffic
//   or the copies' issue, is not measured; wgmma on swizzled TMA tiles is
//   the next lever.
//
// Rounding: the products of bf16 operands are exact in f32; the tensor
// cores sum them in their own order, so the result differs from the plain
// version's f32 product by summation order only, then w0 is added.
// W % 8 == 0 keeps every 16-byte chunk inside one band row and aligned.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TM = 256;              // frames a CTA
constexpr int TN = 64;               // output columns a CTA
constexpr int KB = 16;               // depth of one listed k block
constexpr int EPS = 4;               // listed blocks a pipeline stage
constexpr int KS = KB * EPS;         // depth a stage
constexpr int kStages = 2;           // 90 KB a CTA: two CTAs an SM
constexpr int LDA = KS + 8;          // 144-byte rows: ldmatrix
constexpr int LDB = TN + 8;          // conflict-free
constexpr int A_ELEMS = TM * LDA;
constexpr int STAGE_ELEMS = A_ELEMS + KS * LDB;
constexpr size_t kSmem = (size_t)kStages * STAGE_ELEMS * 2;
constexpr int kThreads = 256;        // 8 warps: 4 along frames, 2 along
                                     // columns
constexpr int kMinCtas = 2;          // CTAs an SM: at most 128 registers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// FLAT: X is (T, H * W), so A_h's k-th column sits at (h - mr)*W + k of a
// frame's row and needs no band-row split
template <bool FLAT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
ring_banded_kernel(const __nv_bfloat16* __restrict__ X,
                   const __nv_bfloat16* __restrict__ bands,
                   const float* __restrict__ w0,
                   const int* __restrict__ kstart,
                   const int* __restrict__ koff, float* __restrict__ out,
                   int T, int H, int W, int D, long long s_t,
                   long long s_d) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  const int nt = blockIdx.x, n0 = nt * TN;
  const int m0 = blockIdx.y * TM;
  const int h = blockIdx.z;
  const int DW = D * W, mr = (D - 1) / 2;
  const long long HW = (long long)H * W;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* ks = kstart + koff[nt];
  const int n_blocks = koff[nt + 1] - koff[nt];
  const int n_stages = (n_blocks + EPS - 1) / EPS;
  const __nv_bfloat16* Bh = bands + (size_t)h * DW * W;

  // listed blocks EPS*s .. EPS*s + EPS - 1 into buffer s % kStages
  auto load = [&](int s) {
    __nv_bfloat16* As = smem + (s % kStages) * STAGE_ELEMS;
    __nv_bfloat16* Bs = As + A_ELEMS;
    // A: TM frames x EPS blocks x two 8-element chunks
#pragma unroll
    for (int j = 0; j < TM * EPS * 2 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (EPS * 2), e = (i / 2) % EPS, c = i % 2;
      const int blk = s * EPS + e, t = m0 + r;
      const int k = (blk < n_blocks ? __ldg(ks + blk) : DW) + 8 * c;
      bool in = t < T && k < DW;
      long long a;                  // the chunk's first element in X
      if (FLAT) {
        a = (long long)(h - mr) * W + k;
        in = in && a >= 0 && a < HW;
        a += t * s_t;
      } else {
        const int d = k / W, j = h - mr + d;
        in = in && j >= 0 && j < H;
        a = j * s_d + t * s_t + (k - d * W);
      }
      __pipeline_memcpy_async(As + r * LDA + e * KB + 8 * c, in ? X + a : X,
                              16, in ? 0 : 16);
    }
    // B: EPS blocks x KB rows x TN / 8 chunks
#pragma unroll
    for (int j = 0; j < EPS * KB * TN / 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int e = i / (KB * TN / 8), r = (i / (TN / 8)) % KB,
                c = i % (TN / 8);
      const int blk = s * EPS + e;
      const int k = (blk < n_blocks ? __ldg(ks + blk) : DW) + r;
      const int n = n0 + 8 * c;
      const bool in = k < DW && n < W;
      __pipeline_memcpy_async(Bs + (e * KB + r) * LDB + 8 * c,
                              in ? Bh + (size_t)k * W + n : bands, 16,
                              in ? 0 : 16);
    }
  };

  const int wm = (warp / 2) * 64, wn = (warp % 2) * 32;
  float acc[4][4][4] = {};

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s);
    __pipeline_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    __pipeline_wait_prior(kStages - 2);
    // stage s is in, and every warp is done with stage s - 1's buffer,
    // which the next load overwrites
    __syncthreads();
    if (s + kStages - 1 < n_stages) load(s + kStages - 1);
    __pipeline_commit();
    const __nv_bfloat16* As = smem + (s % kStages) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], As + (wm + 16 * i + lane % 16) * LDA + kk +
                          (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t q[4];
        ldsm_x4_trans(q, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB +
                             wn + 16 * jp + (lane / 16) * 8);
        b[2 * jp][0] = q[0];
        b[2 * jp][1] = q[1];
        b[2 * jp + 1][0] = q[2];
        b[2 * jp + 1][1] = q[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // acc[i][j]: rows wm + 16i + lane/4 (+ 8), columns wn + 8j + 2(lane%4)
  // (+ 1) of the tile
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + 8 * j + 2 * (lane % 4);
    if (n >= W) continue;           // W % 8 == 0: n + 1 < W as well
    const float2 b0 = *reinterpret_cast<const float2*>(w0 + (size_t)h * W + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = m0 + wm + 16 * i + lane / 4 + 8 * hr;
        if (t < T)
          *reinterpret_cast<float2*>(out + (size_t)t * HW + (size_t)h * W +
                                     n) =
              make_float2(acc[i][j][2 * hr] + b0.x,
                          acc[i][j][2 * hr + 1] + b0.y);
      }
  }
}

template <bool FLAT>
int launch_banded(const void* X, const void* bands, const float* w0,
                  const int* kstart, const int* koff, float* out, int T,
                  int H, int W, int D, long long s_t, long long s_d,
                  void* stream) {
  if (W % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ring_banded_kernel<FLAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TN - 1) / TN, (T + TM - 1) / TM, H);
  ring_banded_kernel<FLAT><<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(X),
      static_cast<const __nv_bfloat16*>(bands), w0, kstart, koff, out, T, H,
      W, D, s_t, s_d);
  return (int)cudaGetLastError();
}

}  // namespace

// X: (T, H * W) bf16; bands: (H, D*W, W) bf16; w0: (H*W); kstart, koff:
// banded_k_blocks(radius, W); out: (T, H, W)
extern "C" int ring_banded_flat_launch(const void* X, const void* bands,
                                       const float* w0, const int* kstart,
                                       const int* koff, float* out, int T,
                                       int H, int W, int D, void* stream) {
  return launch_banded<true>(X, bands, w0, kstart, koff, out, T, H, W, D,
                             /*s_t=*/(long long)H * W, /*s_d=*/W, stream);
}

// X: (H, T, W) bf16
extern "C" int ring_banded_htw_launch(const void* X, const void* bands,
                                      const float* w0, const int* kstart,
                                      const int* koff, float* out, int T,
                                      int H, int W, int D, void* stream) {
  return launch_banded<false>(X, bands, w0, kstart, koff, out, T, H, W, D,
                              /*s_t=*/W, /*s_d=*/(long long)T * W, stream);
}
