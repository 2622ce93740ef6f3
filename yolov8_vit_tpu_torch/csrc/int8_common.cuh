// Shared device code of the W8A8 kernels C, G, H (quant_mlp.cu) and D
// (attention.cu): per-row LayerNorm + dynamic int8 quantization, and one
// int8 GEMM (s8 x s8 -> s32 on wgmma, operands streamed by TMA) with the
// rescale / bias / GELU / SiLU / residual epilogues of
// yolov8_vit_tpu/ops/quant.py and the two epilogues of the recomputed
// fc1 (row amax of the GELU, then its int8 codes).
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

#include "hopper.cuh"

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

// One warp per row: LayerNorm where kLN, then per-row symmetric int8
// quantization.  x (m, ld) -> q (m, ld), qs (m,); the statistics, the amax
// and the codes are over the row's first d columns, and q's columns d..ld
// are zero (the zero padding of the GEMM operands that follow).  `zero`
// (m,), where not null, is set to 0: the row-amax buffer of the fc1 that
// follows.
constexpr int kRowsPerBlock = 8;

template <typename InT, bool kLN>
__global__ void ln_quant_rows_kernel(const InT* __restrict__ x, int m, int d,
                                     int ld,
                                     const float* __restrict__ ln_scale,
                                     const float* __restrict__ ln_bias,
                                     float eps, int8_t* __restrict__ q,
                                     float* __restrict__ qs,
                                     unsigned* __restrict__ zero) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= m) return;
  const InT* xr = x + static_cast<size_t>(row) * ld;
  float mu = 0.f, r = 1.f;
  if (kLN) {
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
    if (kLN) h = (h - mu) * r * ln_scale[i] + ln_bias[i];
    amax = fmaxf(amax, fabsf(h));
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  int8_t* qr = q + static_cast<size_t>(row) * ld;
  for (int i = lane; i < d; i += 32) {
    float h = to_f(xr[i]);
    if (kLN) h = (h - mu) * r * ln_scale[i] + ln_bias[i];
    const float v = fminf(fmaxf(rintf(__fdiv_rn(h, scale)), -127.f), 127.f);
    qr[i] = static_cast<int8_t>(v);
  }
  for (int i = d + lane; i < ld; i += 32) qr[i] = 0;
  if (lane == 0) {
    qs[row] = scale;
    if (zero != nullptr) zero[row] = 0u;
  }
}

// ln_scale == nullptr: no LayerNorm.  Rows of x and q are ld apart.
template <typename InT>
int ln_quant_rows(const void* x, int m, int d, int ld, const float* ln_scale,
                  const float* ln_bias, float eps, int8_t* q, float* qs,
                  cudaStream_t stream, unsigned* zero = nullptr) {
  if (m == 0) return 0;
  const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  if (ln_scale != nullptr)
    ln_quant_rows_kernel<InT, true><<<blocks, 32 * kRowsPerBlock, 0,
                                      stream>>>(
        static_cast<const InT*>(x), m, d, ld, ln_scale, ln_bias, eps, q, qs,
        zero);
  else
    ln_quant_rows_kernel<InT, false><<<blocks, 32 * kRowsPerBlock, 0,
                                       stream>>>(
        static_cast<const InT*>(x), m, d, ld, nullptr, nullptr, 0.f, q, qs,
        zero);
  return static_cast<int>(cudaGetLastError());
}

// ---- int8 GEMM: out[r][c] = epi(sum_k a[r][k] * w[c][k]) -----------------
// a (m, k) int8 row-major; w (n, k) int8: the weight transposed to (out,
// in), so both operands are K-major, the one layout wgmma takes for 8-bit
// types.  k % 16 == 0, n % 8 == 0 and 16-byte aligned bases (TMA's rules
// for the rows of a, w and out): the wrappers zero-pad other widths.
//
// Warp-specialised sm_90a kernel.  A CTA computes a 256 x 128 tile: one
// producer warp's thread streams 128-deep k-tiles (one 128-byte row of a
// and of w per row of the tile) by TMA, 128-byte swizzle, into a ring of
// 4 stages of 48 KB (a: 256 rows, w: 128 rows); TMA fills zeros past m, n
// and k.  4 consumer warpgroups of 64 rows each run wgmma m64n128k32
// s32.s8.s8 from shared memory (4 a k-tile, the descriptor's start
// advancing 32 bytes each), keep one k-tile's products in flight while
// the next tile's barrier is awaited, and release each stage through an
// mbarrier.  The epilogue runs on the 64 s32 sums a thread holds, in
// registers, and puts its warpgroup's 64 x 128 outputs into shared memory
// (the warpgroup's own slices of a, free once its last wgmma retired),
// from where one TMA store a 128-byte-wide box writes them: whole lines
// instead of a thread's scattered pairs, and no element past m or n.
// Every read of s_row, of the residual and of the amax buffer, and every
// row reduction, masks rows >= m (a zero row of a still gives gelu(bias)
// != 0).
enum Epilogue {
  kEpiBias = 0,       // out = v                     (OutT)
  kEpiResidual = 1,   // out = resid + v             (OutT)
  kEpiBiasSilu = 2,   // out = v * sigmoid(v)        (OutT)
  kEpiGeluAmax = 3,   // amax[r] = max(amax[r], max_c |gelu(v)|); no out
  kEpiGeluQuant = 4,  // out = int8 codes of gelu(v) at amax's scale; scale
};                    //   of row r into out_scale[r]
// with v = ((float)acc * s_row) * s_col + bias

struct I8Epi {
  const float* sa;       // (m,) row scales of a
  const float* sw;       // (n,) column scales of w
  const float* bias;     // (n,)
  const void* resid;     // (m, n) OutT, kEpiResidual
  void* out;             // (m, n) OutT; int8 codes for kEpiGeluQuant
  unsigned* amax;        // (m,) f32 bits, zeroed before kEpiGeluAmax
  float* out_scale;      // (m,) kEpiGeluQuant
};

constexpr int kQWgs = 4, kQM = 64 * kQWgs, kQN = 128, kQK = 128;
constexpr int kQStages = 4;
constexpr int kQABytes = kQM * kQK;               // a: kQM rows of 128 B
constexpr int kQStage = kQABytes + kQN * kQK;     // + w: kQN rows of 128 B
constexpr size_t kQSmem =
    kQStages * kQStage + 1024 + 2 * kQStages * sizeof(uint64_t);

__device__ __forceinline__ float rescale(int acc, float s_row, float s_col,
                                         float bias) {
  return (static_cast<float>(acc) * s_row) * s_col + bias;
}

__device__ __forceinline__ float quant_code(float v, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

template <typename OutT> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<int8_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// columns c, c + 1 of the residual row at p + c
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two adjacent outputs (int8: codes) at p, one store
__device__ __forceinline__ void put_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float v0,
                                         float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void put_pair(int8_t* p, float q0, float q1) {
  *reinterpret_cast<char2*>(p) = make_char2(static_cast<signed char>(q0),
                                            static_cast<signed char>(q1));
}

// Columns c, c + 1 of row r of a warpgroup's 64 x 128 output tile, staged
// as sizeof(OutT) boxes of 64 rows x 128 bytes with the 128-byte swizzle
// (the 16-byte chunk index XOR the row's low 3 bits, as TMA reads it);
// box b lies in the warpgroup's a-slice of stage b.
template <typename OutT>
__device__ __forceinline__ void stage_pair(uint8_t* tile, int r, int c,
                                           float v0, float v1) {
  constexpr int kBoxCols = 128 / sizeof(OutT);
  const int byte = (c % kBoxCols) * static_cast<int>(sizeof(OutT));
  put_pair(reinterpret_cast<OutT*>(
               tile + (c / kBoxCols) * kQStage + r * 128
               + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)),
           v0, v1);
}

template <typename OutT, int kEpi>
__global__ void __launch_bounds__(128 * kQWgs + 32, 1)
gemm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tout, int m, int n,
                     int k, const I8Epi ep) {
  static_assert(kQStages >= static_cast<int>(sizeof(OutT)),
                "an output tile takes one stage's a-slice a 128-byte box");
  extern __shared__ uint8_t i8_smem[];
  uint8_t* tiles = align_1024(i8_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kQStages * kQStage);
  uint64_t* empty = full + kQStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kQM, n0 = blockIdx.x * kQN;
  const int nk = (k + kQK - 1) / kQK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kQWgs);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kQWgs) {               // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kQStages;
        mbar_wait(&empty[st], ((kt / kQStages) & 1) ^ 1);
        uint8_t* dst = tiles + st * kQStage;
        mbar_expect_tx(&full[st], kQStage);
        tma_load_2d(dst, &ta, &full[st], kt * kQK, m0);
        tma_load_2d(dst + kQABytes, &tw, &full[st], kt * kQK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kQStages;
    mbar_wait(&full[st], (kt / kQStages) & 1);
    const uint8_t* at = tiles + st * kQStage + wg * (64 * kQK);
    const uint8_t* bt = tiles + st * kQStage + kQABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQK / 32; ++kk)
      wgmma_s8_n128(acc, gmma_desc(at + kk * 32, 16, 1024, 1),
                    gmma_desc(bt + kk * 32, 16, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<1>();                     // k-tile kt - 1 is done with its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kQStages]);
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);

  // acc[4 j + 2 hr + e]: row 16 (warp % 4) + g + 8 hr of the warpgroup's
  // 64, column 8 j + 2 tq + e of the tile
  const int g = lane >> 2, tq = lane & 3;
  uint8_t* const out_tile = tiles + wg * (64 * kQK);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = (warp & 3) * 16 + g + hr * 8;
    const int row = m0 + wg * 64 + r;
    const bool row_ok = row < m;
    const float s_row = row_ok ? ep.sa[row] : 0.f;
    if constexpr (kEpi == kEpiGeluAmax) {
      float mx = 0.f;
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + j * 8 + 2 * tq + e;
          if (col < n)
            mx = fmaxf(mx, fabsf(gelu_tanh(rescale(
                acc[j * 4 + 2 * hr + e], s_row, ep.sw[col], ep.bias[col]))));
        }
      // the four threads of a quad hold one row; every lane shuffles
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // non-negative floats order as their bits: an exact max in any order
      if (row_ok && tq == 0) atomicMax(&ep.amax[row], __float_as_uint(mx));
    } else {
      if (!row_ok) continue;             // TMA stores no row past m
      float scale = 0.f;
      if constexpr (kEpi == kEpiGeluQuant) {
        scale = __fdiv_rn(fmaxf(__uint_as_float(ep.amax[row]), 1e-8f), 127.f);
        if (blockIdx.x == 0 && tq == 0) ep.out_scale[row] = scale;
      }
      const size_t ro = static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j) {
        const int c = j * 8 + 2 * tq, col = n0 + c;
        if (col >= n) continue;          // n even: col + 1 < n
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = rescale(acc[j * 4 + 2 * hr + e], s_row, ep.sw[col + e],
                         ep.bias[col + e]);
        if constexpr (kEpi == kEpiResidual) {
          const float2 x =
              load_pair(static_cast<const OutT*>(ep.resid) + ro + col);
          v[0] = x.x + v[0];
          v[1] = x.y + v[1];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kEpi == kEpiBiasSilu)
            v[e] = v[e] * __fdiv_rn(1.f, 1.f + expf(-v[e]));
          if constexpr (kEpi == kEpiGeluQuant)
            v[e] = quant_code(gelu_tanh(v[e]), scale);
        }
        stage_pair<OutT>(out_tile, r, c, v[0], v[1]);
      }
    }
  }
  if constexpr (kEpi != kEpiGeluAmax) {
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
      constexpr int kBoxCols = 128 / sizeof(OutT);
#pragma unroll
      for (int b = 0; b < static_cast<int>(sizeof(OutT)); ++b)
        tma_store_2d(&tout, out_tile + b * kQStage, n0 + b * kBoxCols,
                     m0 + wg * 64);
      tma_store_commit_and_wait();
    }
  }
}

template <typename OutT, int kEpi>
int gemm_i8(const int8_t* a, const int8_t* w, int m, int n, int k,
            const I8Epi& ep, cudaStream_t stream) {
  if (m == 0) return 0;
  CUtensorMap ta, tw, tout;
  const uint64_t stride[1] = {static_cast<uint64_t>(k)};
  const uint64_t adims[2] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(m)};
  const uint32_t abox[2] = {kQK, kQM};
  int e = encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, 2, adims,
                     stride, abox);
  if (e) return e;
  const uint64_t wdims[2] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(n)};
  const uint32_t wbox[2] = {kQK, kQN};
  e = encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, 2, wdims, stride,
                 wbox);
  if (e) return e;
  tout = ta;                             // the amax pass stores no tile
  if constexpr (kEpi != kEpiGeluAmax) {
    const uint64_t odims[2] = {static_cast<uint64_t>(n),
                               static_cast<uint64_t>(m)};
    const uint64_t ostride[1] = {static_cast<uint64_t>(n) * sizeof(OutT)};
    const uint32_t obox[2] = {128 / sizeof(OutT), 64};
    e = encode_map(&tout, map_type<OutT>(), sizeof(OutT), ep.out, 2, odims,
                   ostride, obox);
    if (e) return e;
  }
  cudaError_t ce = cudaFuncSetAttribute(
      gemm_i8_wgmma_kernel<OutT, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kQSmem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  dim3 grid((n + kQN - 1) / kQN, (m + kQM - 1) / kQM);
  gemm_i8_wgmma_kernel<OutT, kEpi><<<grid, 128 * kQWgs + 32, kQSmem,
                                     stream>>>(ta, tw, tout, m, n, k, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
