// Float device code of kernel E (attention.cu): row LayerNorm into the
// activation dtype, and the GEMM of its QKV and proj products with the
// bias and bias + residual epilogues:
//     out[r][c] = dtype( sum_k a[r][k] * w[k][c] + bias[c] (+ resid[r][c]) )
// a (m, k) row-major and w (k, n) row-major: the JAX (in, out) layout, so
// the weights need no transpose, only the one cast to the activation
// dtype the model makes per load.  The sum is f32 and the epilogue adds
// bias (and residual) in f32 before the one rounding, as the TPU kernel's
// `preferred_element_type=f32` products do.
//   bf16: tensor cores (mma.sync.m16n8k16, bf16 x bf16 -> f32), 128 x 128
//         CTA tiles of 8 warps (32 x 64 each), k-tiles of 32 double-
//         buffered with cp.async; A fragments by ldmatrix, B (k-major in
//         shared memory) by ldmatrix.trans.  k and n multiples of 8.
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

// ---- bf16 GEMM ---------------------------------------------------------------
constexpr int kGM = 128, kGN = 128, kGK = 32;
constexpr int kALd = kGK + 8;     // 80-byte rows: ldmatrix conflict-free
constexpr int kBLd = kGN + 8;     // 272-byte rows

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

template <int kEpi>
__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ w, int m, int n, int k,
                 const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ resid,
                 __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kGM * kALd];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kGK * kBLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      const int idx = tid + rep * 256;
      const int ra = idx >> 2, ca = (idx & 3) * 8;          // A: 128 x 4
      const bool va = m0 + ra < m && k0 + ca < k;
      cp_async16(&as[stage][ra * kALd + ca],
                 va ? a + static_cast<size_t>(m0 + ra) * k + k0 + ca : a, va);
      const int rb = idx >> 4, cb = (idx & 15) * 8;         // B: 32 x 16
      const bool vb = k0 + rb < k && n0 + cb < n;
      cp_async16(&bs[stage][rb * kBLd + cb],
                 vb ? w + static_cast<size_t>(k0 + rb) * n + n0 + cb : w, vb);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (k + kGK - 1) / kGK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * kGK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* at = as[kt & 1];
    const __nv_bfloat16* bt = bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < kGK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], at + (wm * 32 + mi * 16 + (lane & 15)) * kALd +
                                ks + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, bt + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kBLd +
                   wn * 64 + (2 * nj + (lane >> 4)) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm * 32 + mi * 16 + g + hr * 8;
        const int col = n0 + wn * 64 + ni * 8 + 2 * tq;
        if (row >= m || col >= n) continue;       // n even: col + 1 < n
        const size_t o = static_cast<size_t>(row) * n + col;
        float v0 = acc[mi][ni][2 * hr] + bias[col];
        float v1 = acc[mi][ni][2 * hr + 1] + bias[col + 1];
        if (kEpi == kFEpiResidual) {
          v0 = __bfloat162float(resid[o]) + v0;
          v1 = __bfloat162float(resid[o + 1]) + v1;
        }
        *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
      }
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
    dim3 grid((n + kGN - 1) / kGN, (m + kGM - 1) / kGM);
    gemm_bf16_kernel<kEpi><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(w), m, n, k, bias,
        static_cast<const __nv_bfloat16*>(resid),
        static_cast<__nv_bfloat16*>(out));
  } else {
    dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
    gemm_f32_kernel<kEpi><<<grid, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), m, n, k,
        bias, static_cast<const float*>(resid), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
