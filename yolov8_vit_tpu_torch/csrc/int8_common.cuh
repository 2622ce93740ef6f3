// Shared device code of the W8A8 kernels C, G, H (quant_mlp.cu) and D
// (attention.cu): per-row LayerNorm + dynamic int8 quantization, and an
// int8 tensor-core GEMM (mma.sync m16n8k32, s8 x s8 -> s32) with the
// rescale / bias / GELU / SiLU / residual epilogues of
// yolov8_vit_tpu/ops/quant.py.
//
// Arithmetic follows the TPU kernels operation by operation:
//   quantize_act: scale = max(amax, 1e-8) / 127; q = clip(rint(x / scale),
//                 -127, 127) with IEEE division and round-half-to-even;
//   epilogue:     ((float)acc * s_row) * s_col + bias, in that order;
//   gelu (tanh):  x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))));
//   silu:         y * (1 / (1 + exp(-y))), in f32 before the one cast.
// The library is built with -fmad=false, so none of it is contracted.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

// activation dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;     // f32(sqrt(2 / pi))
  const float x3 = x * (x * x);
  const float t = tanhf(c * (x + 0.044715f * x3));
  return x * (0.5f * (1.0f + t));
}

// One warp per row: optional LayerNorm (ln_scale != nullptr), then
// per-row symmetric int8 quantization.  x (m, d) -> q (m, d), qs (m,).
constexpr int kRowsPerBlock = 8;

template <typename InT>
__global__ void ln_quant_rows_kernel(const InT* __restrict__ x, int m, int d,
                                     const float* __restrict__ ln_scale,
                                     const float* __restrict__ ln_bias,
                                     float eps, int8_t* __restrict__ q,
                                     float* __restrict__ qs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= m) return;
  const InT* xr = x + static_cast<size_t>(row) * d;
  float mu = 0.f, r = 1.f;
  const bool ln = ln_scale != nullptr;
  if (ln) {
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += to_f(xr[i]);
    mu = __fdiv_rn(warp_sum(s), static_cast<float>(d));
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float c = to_f(xr[i]) - mu;
      ss += c * c;
    }
    const float var = __fdiv_rn(warp_sum(ss), static_cast<float>(d));
    r = __fdiv_rn(1.f, __fsqrt_rn(var + eps));
  }
  float amax = 0.f;
  for (int i = lane; i < d; i += 32) {
    float h = to_f(xr[i]);
    if (ln) h = (h - mu) * r * ln_scale[i] + ln_bias[i];
    amax = fmaxf(amax, fabsf(h));
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  int8_t* qr = q + static_cast<size_t>(row) * d;
  for (int i = lane; i < d; i += 32) {
    float h = to_f(xr[i]);
    if (ln) h = (h - mu) * r * ln_scale[i] + ln_bias[i];
    const float v = fminf(fmaxf(rintf(__fdiv_rn(h, scale)), -127.f), 127.f);
    qr[i] = static_cast<int8_t>(v);
  }
  if (lane == 0) qs[row] = scale;
}

template <typename InT>
int ln_quant_rows(const void* x, int m, int d, const float* ln_scale,
                  const float* ln_bias, float eps, int8_t* q, float* qs,
                  cudaStream_t stream) {
  if (m == 0) return 0;
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_quant_rows_kernel<InT><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const InT*>(x), m, d, ln_scale, ln_bias, eps, q, qs);
  return static_cast<int>(cudaGetLastError());
}

// ---- int8 GEMM: out[r][c] = epi(sum_k a[r][k] * w[c][k]) -----------------
// a (m, k) int8 row-major; w (n, k) int8: the weight TRANSPOSED to
// (out, in) so each output column's k run is contiguous, which is the
// "col" B operand of mma.sync.  k % 16 == 0 and 16-byte aligned rows.
enum Epilogue { kEpiBias = 0, kEpiResidual = 1, kEpiGeluF32 = 2,
                kEpiBiasSilu = 3 };

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kLd = kBK + 16;   // smem row stride (bytes): conflict-free frags

__device__ __forceinline__ void mma_s8(int* c, const int* a, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename OutT, int kEpi>
__global__ void __launch_bounds__(256)
gemm_i8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
               int m, int n, int k, const float* __restrict__ sa,
               const float* __restrict__ sw, const float* __restrict__ bias,
               const OutT* __restrict__ resid, void* __restrict__ out) {
  __shared__ __align__(16) int8_t as[kBM * kLd];
  __shared__ __align__(16) int8_t bs[kBN * kLd];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;      // 4 x 2 warps: 16 x 64 each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    {   // A tile: 64 rows x 64 bytes, one 16-byte chunk per thread
      const int r = tid >> 2, ch = (tid & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < m && k0 + ch < k)
        v = *reinterpret_cast<const int4*>(
            a + static_cast<size_t>(m0 + r) * k + k0 + ch);
      *reinterpret_cast<int4*>(as + r * kLd + ch) = v;
    }
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {   // B tile: 128 rows x 64 bytes
      const int idx = tid + rep * 256;
      const int r = idx >> 2, ch = (idx & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + r < n && k0 + ch < k)
        v = *reinterpret_cast<const int4*>(
            w + static_cast<size_t>(n0 + r) * k + k0 + ch);
      *reinterpret_cast<int4*>(bs + r * kLd + ch) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      const int8_t* ar = as + (wm * 16 + g) * kLd + ks + t * 4;
      int af[4];
      af[0] = *reinterpret_cast<const int*>(ar);
      af[1] = *reinterpret_cast<const int*>(ar + 8 * kLd);
      af[2] = *reinterpret_cast<const int*>(ar + 16);
      af[3] = *reinterpret_cast<const int*>(ar + 8 * kLd + 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* br = bs + (wn * 64 + nt * 8 + g) * kLd + ks + t * 4;
        mma_s8(acc[nt], af, *reinterpret_cast<const int*>(br),
               *reinterpret_cast<const int*>(br + 16));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm * 16 + g + (i >= 2 ? 8 : 0);
      const int col = n0 + wn * 64 + nt * 8 + t * 2 + (i & 1);
      if (row >= m || col >= n) continue;
      const size_t o = static_cast<size_t>(row) * n + col;
      const float v = static_cast<float>(acc[nt][i]) * sa[row] * sw[col]
                      + bias[col];
      if (kEpi == kEpiBias) {
        static_cast<OutT*>(out)[o] = from_f<OutT>(v);
      } else if (kEpi == kEpiBiasSilu) {
        const float sig = __fdiv_rn(1.f, 1.f + expf(-v));
        static_cast<OutT*>(out)[o] = from_f<OutT>(v * sig);
      } else if (kEpi == kEpiResidual) {
        static_cast<OutT*>(out)[o] = from_f<OutT>(to_f(resid[o]) + v);
      } else {
        static_cast<float*>(out)[o] = gelu_tanh(v);
      }
    }
  }
}

template <typename OutT, int kEpi>
int gemm_i8(const int8_t* a, const int8_t* w, int m, int n, int k,
            const float* sa, const float* sw, const float* bias,
            const void* resid, void* out, cudaStream_t stream) {
  if (m == 0) return 0;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_i8_kernel<OutT, kEpi><<<grid, 256, 0, stream>>>(
      a, w, m, n, k, sa, sw, bias, static_cast<const OutT*>(resid), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
