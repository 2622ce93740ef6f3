// Float device code of kernel E (attention.cu, replacing the QKV and proj
// products of yolov8_vit_tpu/ops/attention.py `_attn_block_kernel`): row
// LayerNorm into the activation dtype, and the GEMM of its QKV and proj
// products with the bias and bias + residual epilogues:
//     out[r][c] = dtype( sum_k a[r][k] * w[k][c] + bias[c] (+ resid[r][c]) )
// a (m, k) row-major and w (k, n) row-major: the JAX (in, out) layout, so
// the weights need no transpose, only the one cast to the activation
// dtype the model makes per load.  The sum is f32 and the epilogue adds
// bias (and residual) in f32 before the one rounding, as the TPU kernel's
// `preferred_element_type=f32` products do.
//
// Bound on the H100 for E at 64 crops x 785 tokens x 768, bf16: QKV is
// 2 x 50240 x 768 x 2304 = 178 GFLOP (0.18 ms at 989 TFLOP/s) against 309
// MB of a, w and out (0.09 ms); proj 59 GFLOP (0.06 ms) against 155 MB
// (0.05 ms): operations.
//
//   bf16 (sm_90a): warp-specialised wgmma.  A CTA computes a 256 x 128
//         tile: one producer warp's thread streams 64-deep k-tiles of a
//         (one box of 256 rows) and w (two 64 x 64 boxes) through a ring
//         of 4 stages of 48 KB with TMA (128-byte swizzle, zero fill past
//         m, n and k); 4 consumer warpgroups of 64 rows each run wgmma
//         m64n128k16 with a K-major from shared memory and w MN-major,
//         keep one k-tile's products in flight while the next tile's
//         barrier is awaited, and release each stage through an mbarrier.
//         The products are bound by L2 reads more than by the tensor
//         cores: a 128 x 128 tile reads one byte of a and w from L2 for
//         every 64 flops, so QKV at that tile reads 2.8 GB from L2 (about
//         0.4 ms at the 6.8 TB/s measured); the 256 x 128 tile (one CTA an
//         SM) halves the re-reads of w.  k and n multiples of 8 (TMA's
//         16-byte strides).
//   f32:  CUDA cores, 64 x 64 tiles, 4 x 4 outputs a thread, explicit FMA.
#pragma once

#include "sdpa.cuh"

namespace {

enum FloatEpilogue { kFEpiBias = 0, kFEpiResidual = 1 };

// One warp per row: LayerNorm in f32, output in OutT.
template <typename InT, typename OutT>
__global__ void ln_rows_kernel(const InT* __restrict__ x, int m, int d,
                               const float* __restrict__ ln_scale,
                               const float* __restrict__ ln_bias, float eps,
                               OutT* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= m) return;
  const InT* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
  const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(d));
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = to_f(xr[i]) - mu;
    ss += c * c;
  }
  const float var = __fdiv_rn(warp_sum(ss), static_cast<float>(d));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(var + eps));
  OutT* orow = out + static_cast<size_t>(row) * d;
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<OutT>((to_f(xr[i]) - mu) * r * ln_scale[i] + ln_bias[i]);
}

template <typename T>
int ln_rows(const void* x, int m, int d, const float* s, const float* b,
            float eps, void* out, cudaStream_t st) {
  if (m == 0) return 0;
  ln_rows_kernel<T, T><<<(m + kRowsPerBlock - 1) / kRowsPerBlock,
                         32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(x), m, d, s, b, eps, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 GEMM: wgmma + TMA ---------------------------------------------------
// 256 x 128 tiles, 4 consumer warpgroups of 64 rows each, 4 stages.
constexpr int kGWgs = 4, kGM = 64 * kGWgs, kGN = 128, kGK = 64;
constexpr int kGStages = 4;
constexpr int kGABytes = kGM * kGK * 2;           // a: kGM rows of 128 B
constexpr int kGBBox = kGK * 64 * 2;              // w: one 64-column box
constexpr int kGStage = kGABytes + 2 * kGBBox;
constexpr size_t kGSmem =
    kGStages * kGStage + 1024 + 2 * kGStages * sizeof(uint64_t);

template <int kEpi>
__global__ void __launch_bounds__(128 * kGWgs + 32, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tw, int m, int n, int k,
                 const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ resid,
                 __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint8_t gemm_smem[];
  uint8_t* tiles = align_1024(gemm_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kGStages * kGStage);
  uint64_t* empty = full + kGStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int nk = (k + kGK - 1) / kGK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGWgs);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kGWgs) {               // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kGStages;
        mbar_wait(&empty[st], ((kt / kGStages) & 1) ^ 1);
        uint8_t* dst = tiles + st * kGStage;
        mbar_expect_tx(&full[st], kGStage);
        tma_load_2d(dst, &ta, &full[st], kt * kGK, m0);
        tma_load_2d(dst + kGABytes, &tw, &full[st], n0, kt * kGK);
        tma_load_2d(dst + kGABytes + kGBBox, &tw, &full[st], n0 + 64,
                    kt * kGK);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kGStages;
    mbar_wait(&full[st], (kt / kGStages) & 1);
    const uint8_t* at = tiles + st * kGStage + wg * (64 * 128);
    const uint8_t* bt = tiles + st * kGStage + kGABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk)
      wgmma_ss_n128<1>(acc, gmma_desc(at + kk * 32, 16, 1024, 1),
                       gmma_desc(bt + kk * 16 * 128, kGBBox, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<1>();                     // k-tile kt - 1 is done with its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kGStages]);
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < kGN / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wg * 64 + (warp & 3) * 16 + g + hr * 8;
      const int col = n0 + j * 8 + 2 * tq;
      if (row >= m || col >= n) continue;         // n even: col + 1 < n
      const size_t o = static_cast<size_t>(row) * n + col;
      float v0 = acc[j * 4 + 2 * hr] + bias[col];
      float v1 = acc[j * 4 + 2 * hr + 1] + bias[col + 1];
      if (kEpi == kFEpiResidual) {
        v0 = __bfloat162float(resid[o]) + v0;
        v1 = __bfloat162float(resid[o + 1]) + v1;
      }
      *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
    }
}

template <int kEpi>
int gemm_bf16(const void* a, const void* w, int m, int n, int k,
              const float* bias, const void* resid, void* out,
              cudaStream_t st) {
  CUtensorMap ta, tw;
  const uint64_t adims[2] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(m)};
  const uint64_t astride[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t abox[2] = {kGK, kGM};
  int e = encode_bf16_map(&ta, a, 2, adims, astride, abox);
  if (e) return e;
  const uint64_t wdims[2] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k)};
  const uint64_t wstride[1] = {static_cast<uint64_t>(n) * 2};
  const uint32_t wbox[2] = {64, kGK};
  e = encode_bf16_map(&tw, w, 2, wdims, wstride, wbox);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      gemm_wgmma_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGSmem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  dim3 grid((n + kGN - 1) / kGN, (m + kGM - 1) / kGM);
  gemm_wgmma_kernel<kEpi><<<grid, 128 * kGWgs + 32, kGSmem, st>>>(
      ta, tw, m, n, k, bias, static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---- f32 GEMM ------------------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <int kEpi>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                int m, int n, int k, const float* __restrict__ bias,
                const float* __restrict__ resid, float* __restrict__ out) {
  __shared__ float as[kFK][kFM + 4];      // transposed: as[kk][row]
  __shared__ float bs[kFK][kFN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kFK) {
#pragma unroll
    for (int rep = 0; rep < 4; ++rep) {
      const int idx = tid + rep * 256;
      const int r = idx >> 4, kk = idx & 15;
      as[kk][r] = (m0 + r < m && k0 + kk < k)
          ? a[static_cast<size_t>(m0 + r) * k + k0 + kk] : 0.f;
      const int kb = idx >> 6, c = idx & 63;
      bs[kb][c] = (k0 + kb < k && n0 + c < n)
          ? w[static_cast<size_t>(k0 + kb) * n + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[kk][ty + 16 * i];
        bv[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row >= m || col >= n) continue;
      const size_t o = static_cast<size_t>(row) * n + col;
      float v = acc[i][j] + bias[col];
      if (kEpi == kFEpiResidual) v = resid[o] + v;
      out[o] = v;
    }
}

template <typename T, int kEpi>
int gemm_float(const void* a, const void* w, int m, int n, int k,
               const float* bias, const void* resid, void* out,
               cudaStream_t st) {
  if (m == 0) return 0;
  if constexpr (sizeof(T) == 2) {
    return gemm_bf16<kEpi>(a, w, m, n, k, bias, resid, out, st);
  } else {
    dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
    gemm_f32_kernel<kEpi><<<grid, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), m, n, k,
        bias, static_cast<const float*>(resid), static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace
