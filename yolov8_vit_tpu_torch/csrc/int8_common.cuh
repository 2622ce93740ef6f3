// Shared device code of the W8A8 kernels C, G, H (quant_mlp.cu) and D
// (attention.cu): per-row LayerNorm + dynamic int8 quantization, and one
// int8 GEMM (s8 x s8 -> s32 on wgmma, operands streamed by TMA; a
// persistent grid in ping-pong, one tile's epilogue beside the next's
// products) with the rescale / bias / GELU / SiLU / residual epilogues of
// yolov8_vit_tpu/ops/quant.py and the two epilogues of the recomputed fc1
// (row amax of the GELU, then its int8 codes).
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
// types.  m is any row count; k % 16 == 0, n % 8 == 0 and 16-byte aligned
// bases (TMA's rules for the rows of a, w and out): the wrappers zero-pad
// other widths.
//
// Persistent, warp-specialised sm_90a kernel in ping-pong.  A tile is 128
// x 128 outputs; two CTAs form a cluster over a 256 x 128 tile, each
// loading its own 128 rows of a and half of the 128 rows of w, which TMA
// multicasts to both (the weight tile read from L2 once for two CTAs).
// The clusters that fit the card at once take the tiles in turn, columns
// fastest, so that neighbouring clusters share rows of a in L2.  A CTA
// holds:
//   - one producer warp, whose one thread streams the CTA's tiles in turn
//     as 128-deep k-tiles by TMA (128-byte swizzle; zeros past m, n and k)
//     into a ring of stages; a stage is free once the consumers of both
//     CTAs have released it.  The ring runs on across tiles.
//   - two math groups of two warpgroups (64 rows each), taking the CTA's
//     tiles alternately, each starting a tile's products once the other
//     has awaited its last k-tile.  A group runs wgmma m64n128k32
//     s32.s8.s8 from the ring, keeping one k-tile's products in flight
//     while the next is awaited, then applies the epilogue to the 64 sums
//     a thread holds, in registers, while the other group's products run
//     on the tensor cores.  The GELU passes' epilogue (tanhf; the quantize
//     pass's IEEE division) is a chain of dependent instructions whose pace
//     follows the warps that run it: here every math warp of the SM,
//     neither stalled behind a mainloop nor waiting for one.  A warpgroup
//     puts its 64 x 128 outputs into its own buffer in shared memory, from
//     where one TMA store a 128-byte-wide box writes them: whole lines
//     instead of a thread's scattered pairs, and no element past m or n.
// Every read of s_row, of the residual and of the amax buffer, and every
// row reduction, masks rows >= m (a zero row of a still gives gelu(bias)
// != 0), and the epilogue reads no column >= n (a box of w wholly past n
// or of a wholly past m loads the tensor's first rows instead).
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

constexpr int kQGroups = 2, kQWgs = 2;            // groups, warpgroups a group
constexpr int kQM = 64 * kQWgs, kQN = 128, kQK = 128;
constexpr int kQCluster = 2;                      // CTA rank r: rows r kQM..
constexpr int kQABytes = kQM * kQK;               // a: kQM rows of 128 B
constexpr int kQStage = kQABytes + kQN * kQK;     // + w: kQN rows of 128 B
constexpr int kQWRows = kQN / kQCluster;          // the w rows a CTA loads
constexpr int kQThreads = 128 * kQWgs * kQGroups + 32;
constexpr int kQBox = 64 * 128;                   // an output box: 64 x 128 B

// A warpgroup's output buffer holds sizeof(OutT) boxes (none for the
// amax pass); the ring takes the rest of the CTA's shared memory.
template <typename OutT, int kEpi>
__host__ __device__ constexpr int out_bytes() {
  return kEpi == kEpiGeluAmax
             ? 0
             : kQGroups * kQWgs * static_cast<int>(sizeof(OutT)) * kQBox;
}
template <typename OutT, int kEpi>
__host__ __device__ constexpr int ring_stages() {
  return (232448 - 1024 - 256 - out_bytes<OutT, kEpi>()) / kQStage;
}
template <typename OutT, int kEpi>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(ring_stages<OutT, kEpi>()) * kQStage
         + out_bytes<OutT, kEpi>() + 1024
         + (2 * ring_stages<OutT, kEpi>() + kQGroups) * sizeof(uint64_t);
}

__device__ __forceinline__ float rescale(int acc, float s_row, float s_col,
                                         float bias) {
  return (static_cast<float>(acc) * s_row) * s_col + bias;
}

__device__ __forceinline__ float silu(float v) {
  return v * __fdiv_rn(1.f, 1.f + expf(-v));
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
// (the 16-byte chunk index XOR the row's low 3 bits, as TMA reads it).
template <typename OutT>
__device__ __forceinline__ void stage_pair(uint8_t* tile, int r, int c,
                                           float v0, float v1) {
  constexpr int kBoxCols = 128 / sizeof(OutT);
  const int byte = (c % kBoxCols) * static_cast<int>(sizeof(OutT));
  put_pair(reinterpret_cast<OutT*>(
               tile + (c / kBoxCols) * kQBox + r * 128
               + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)),
           v0, v1);
}

// A warpgroup's epilogue on the 64 sums a thread holds: acc[4 j + 2 hr +
// e] is row 16 (warp % 4) + g + 8 hr of the warpgroup's 64 (row0 the
// first's row of the output), column n0 + 8 j + 2 tq + e.  Rows past m
// are computed too (TMA stores none of them); a group of 8 columns past n
// is skipped, by the whole warp at once, since n % 8 == 0.
template <typename OutT, int kEpi>
__device__ __forceinline__ void epilogue(const int* acc, int row0, int n0,
                                         int m, int n, const I8Epi& ep,
                                         uint8_t* out_tile,
                                         const CUtensorMap* tout, int bar) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int rw = ((threadIdx.x >> 5) & 3) * 16 + g;   // the thread's row hr 0
  if constexpr (kEpi != kEpiGeluAmax) {
    // the warpgroup's last store has read its buffer
    if ((threadIdx.x & 127) == 0) tma_store_wait_read();
    named_barrier(bar, 128);
  }
  float s_row[2], scale[2], mx[2] = {0.f, 0.f};
  bool row_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + rw + 8 * hr;
    row_ok[hr] = row < m;
    s_row[hr] = row_ok[hr] ? ep.sa[row] : 0.f;
    scale[hr] = 0.f;
    if constexpr (kEpi == kEpiGeluQuant) {
      if (row_ok[hr]) {
        scale[hr] =
            __fdiv_rn(fmaxf(__uint_as_float(ep.amax[row]), 1e-8f), 127.f);
        if (n0 == 0 && tq == 0) ep.out_scale[row] = scale[hr];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQN / 8; ++j) {
    if (n0 + j * 8 >= n) break;
    const int c = j * 8 + 2 * tq, col = n0 + c;
    float sw[2], bs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sw[e] = ep.sw[col + e];
      bs[e] = ep.bias[col + e];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = rescale(acc[j * 4 + 2 * hr + e], s_row[hr], sw[e], bs[e]);
      if constexpr (kEpi == kEpiGeluAmax) {
        const float a = fmaxf(fabsf(gelu_tanh(v[0])), fabsf(gelu_tanh(v[1])));
        mx[hr] = fmaxf(mx[hr], a);
      } else {
        if constexpr (kEpi == kEpiResidual) {
          const float2 x =
              row_ok[hr]
                  ? load_pair(static_cast<const OutT*>(ep.resid)
                              + static_cast<size_t>(row0 + rw + 8 * hr) * n
                              + col)
                  : make_float2(0.f, 0.f);
          v[0] = x.x + v[0];
          v[1] = x.y + v[1];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kEpi == kEpiBiasSilu)
            v[e] = silu(v[e]);
          if constexpr (kEpi == kEpiGeluQuant)
            v[e] = quant_code(gelu_tanh(v[e]), scale[hr]);
        }
        stage_pair<OutT>(out_tile, rw + 8 * hr, c, v[0], v[1]);
      }
    }
  }
  if constexpr (kEpi == kEpiGeluAmax) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      // the four threads of a quad hold one row; every lane shuffles.
      // Non-negative floats order as their bits: an exact max in any order.
      float r = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      if (row_ok[hr] && tq == 0)
        atomicMax(&ep.amax[row0 + rw + 8 * hr], __float_as_uint(r));
    }
  } else {
    fence_proxy_async();
    named_barrier(bar, 128);
    if ((threadIdx.x & 127) == 0) {
      constexpr int kBoxCols = 128 / sizeof(OutT);
#pragma unroll
      for (int b = 0; b < static_cast<int>(sizeof(OutT)); ++b)
        tma_store_2d(tout, out_tile + b * kQBox, n0 + b * kBoxCols, row0);
      tma_store_commit();
    }
  }
}

template <typename OutT, int kEpi>
__global__ void __launch_bounds__(kQThreads, 1)
gemm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tout, int m, int n,
                     int k, const I8Epi ep) {
  constexpr int kStages = ring_stages<OutT, kEpi>();
  extern __shared__ uint8_t i8_smem[];
  uint8_t* ring = align_1024(i8_smem);
  uint8_t* outs = ring + kStages * kQStage;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(outs + out_bytes<OutT, kEpi>());
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;      // a group's turn at the ring
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / kQCluster;
  const int clusters = gridDim.x / kQCluster;
  const int n_tiles = (n + kQN - 1) / kQN;
  const int tiles = (m + kQCluster * kQM - 1) / (kQCluster * kQM) * n_tiles;
  const int nk = (k + kQK - 1) / kQK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // a release from each consumer warp of a group, in both CTAs (each
      // reads the half of w this CTA's producer loads)
      mbar_init(&empty[s], kQCluster * 4 * kQWgs);
    }
    for (int g = 0; g < kQGroups; ++g) mbar_init(&turn[g], 4 * kQWgs);
    mbar_fence_init();
  }
  cluster_sync();       // every CTA's barriers exist before any arrival

  // the first row and column of the CTA's j-th tile (j < its tile count)
  auto tile_origin = [&](int j, int& m0, int& n0) {
    const int t = cluster + j * clusters, mt = t / n_tiles;
    m0 = (mt * kQCluster + rank) * kQM;
    n0 = (t - mt * n_tiles) * kQN;
  };
  const int my_tiles = (tiles - cluster + clusters - 1) / clusters;
  if (warp == 4 * kQWgs * kQGroups) {    // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int j = 0; j < my_tiles; ++j) {
        int m0, n0;
        tile_origin(j, m0, n0);
        const int wr = n0 + rank * kQWRows;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          uint8_t* s = ring + st * kQStage;
          mbar_expect_tx(&full[st], kQStage);
          tma_load_2d(s, &ta, &full[st], kt * kQK, m0 < m ? m0 : 0);
          tma_load_2d_multicast(s + kQABytes + rank * kQWRows * kQK, &tw,
                                &full[st], kt * kQK, wr < n ? wr : 0,
                                (1u << kQCluster) - 1);
        }
      }
    }
  } else {                               // the math groups
    const int wg = warp >> 2, grp = wg / kQWgs, wl = wg % kQWgs;
    uint8_t* const out_tile =
        outs + wg * static_cast<int>(sizeof(OutT)) * kQBox;
    int acc[64];
    for (int j = grp; j < my_tiles; j += kQGroups) {
      int m0, n0;
      tile_origin(j, m0, n0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      int it = j * nk;                   // the tile's first k-tile in the ring
      // The other group has awaited every k-tile of the tile before, so
      // the phase a full barrier is awaited in is its next one (a parity
      // wait cannot tell a phase from the one two ahead).
      if (j > 0) mbar_wait(&turn[grp], ((j - 1) >> 1) & 1);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        if (kt == nk - 1 && lane == 0) mbar_arrive(&turn[grp ^ 1]);
        const uint8_t* at = ring + st * kQStage + wl * (64 * kQK);
        const uint8_t* bt = ring + st * kQStage + kQABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQK / 32; ++kk)
          wgmma_s8_n128(acc, gmma_desc(at + kk * 32, 16, 1024, 1),
                        gmma_desc(bt + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();                 // k-tile it - 1 is done with its stage
        if (kt > 0 && lane == 0)
          mbar_arrive_cluster<kQCluster>(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs<64>(acc);
      if (lane == 0)
        mbar_arrive_cluster<kQCluster>(&empty[(it - 1) % kStages]);
      epilogue<OutT, kEpi>(acc, m0 + wl * 64, n0, m, n, ep, out_tile, &tout,
                           1 + wg);
    }
    // the warpgroup's last store has read its buffer
    if (kEpi != kEpiGeluAmax && (threadIdx.x & 127) == 0)
      tma_store_wait_read();
  }
  // no CTA leaves while another may still multicast into it or arrive on
  // its barriers
  cluster_sync();
}

template <typename OutT, int kEpi>
int gemm_i8(const int8_t* a, const int8_t* w, int m, int n, int k,
            const I8Epi& ep, cudaStream_t stream) {
  static_assert(smem_bytes<OutT, kEpi>() <= 232448, "one CTA an SM");
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
  const uint32_t wbox[2] = {kQK, kQWRows};
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
  const int tiles = (m + kQCluster * kQM - 1) / (kQCluster * kQM)
                    * ((n + kQN - 1) / kQN);
  return launch_clustered<gemm_i8_wgmma_kernel<OutT, kEpi>, kQCluster>(
      tiles, kQThreads, static_cast<int>(smem_bytes<OutT, kEpi>()), stream,
      ta, tw, tout, m, n, k, ep);
}

}  // namespace
