// The key-tiled SDPA core shared by kernels D, E and F (attention.cu):
//     o = softmax(q k^T * scale) v      per (image, head), any sequence T
//
// Rounding points follow the TPU kernels (yolov8_vit_tpu/ops/attention.py):
//   prescale = 1 (`_sdpa_per_head`, kernels D and E): q * scale rounded to
//     the activation dtype, then scores q.k in f32;
//   prescale = 0 (`_attn_kernel`, kernel F): scores q.k in f32, times the
//     f32 scale;
//   both: keys >= t_real masked to -inf, e = exp(s - max), p = e / sum(e)
//   normalised in f32 and THEN rounded to the dtype, P.V accumulated in f32
//   and rounded to the dtype.
// An online softmax that divides at the end would round P at another
// point, so the core is two passes over the key tiles: pass 1 takes each
// row's max and sum of exponentials (the sum rescaled as the max grows),
// pass 2 recomputes the scores, forms p, rounds it and accumulates P.V.
// K and V of one head at T = 785 (201 KB in bf16) do not fit a CTA, so
// both passes stream 64-key tiles through shared memory; ragged query and
// key tiles are zero-filled and their keys masked.
//
// bf16: one CTA of 4 warps per 64 query rows of one (head, image); each
// warp owns 16 rows.  Q.K^T and P.V run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulation); the score
// fragment becomes P's A fragment in registers, V's B fragment comes from
// ldmatrix.trans.  f32: CUDA cores, one CTA of 8 warps per 32 query rows,
// one warp per row at a time, lanes over keys for the scores and over
// head columns for P.V.
#pragma once

#include "int8_common.cuh"

namespace {

struct SdpaArgs {
  const void* q;         // element (img, token, head, c) at
  const void* k;         //   ptr + img * bstride + token * ld + head * hd + c
  const void* v;
  void* o;               // (img, token, head, c), contiguous
  long long bstride;
  int ld, t, heads, t_real;
  float scale;
  int prescale;
};

constexpr int kKeyTile = 64;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---- bf16, tensor cores ----------------------------------------------------
constexpr int kBf16QRows = 64;   // 4 warps x 16 rows

// Rows k0 .. k0 + 63 of one head's K (or V) into a (64, HD + 8) tile,
// 16-byte chunks, rows >= t zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int k0, int t, int ld) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < kKeyTile * kChunks; i += blockDim.x) {
    const int r = i / kChunks, ch = i - r * kChunks;
    int4 val = make_int4(0, 0, 0, 0);
    if (k0 + r < t)
      val = *reinterpret_cast<const int4*>(
          src + static_cast<size_t>(k0 + r) * ld + ch * 8);
    *reinterpret_cast<int4*>(dst + r * (HD + 8) + ch * 8) = val;
  }
}

// s (16 rows x 64 keys of this warp) = Q.K^T over the tile in `ks`, scaled
// (prescale == 0) and masked.
template <int HD>
__device__ __forceinline__ void scores_bf16(float (*s)[4],
                                            const uint32_t (*qf)[4],
                                            const __nv_bfloat16* ks, int k0,
                                            const SdpaArgs& a) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* kr = ks + (j * 8 + g) * (HD + 8) + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_bf16(s[j], qf[kk], bf16_pair(kr + kk * 16),
               bf16_pair(kr + kk * 16 + 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!a.prescale) s[j][e] = s[j][e] * a.scale;
      if (k0 + j * 8 + 2 * tq + (e & 1) >= a.t_real) s[j][e] = -INFINITY;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
sdpa_bf16_kernel(SdpaArgs a) {
  __shared__ __align__(16) __nv_bfloat16 ks[kKeyTile * (HD + 8)];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeyTile * (HD + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, img = blockIdx.z;
  const size_t base = static_cast<size_t>(img) * a.bstride + h * HD;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + base;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + base;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + base;
  const int r0 = blockIdx.x * kBf16QRows + warp * 16 + g, r1 = r0 + 8;

  // Q's A fragments for the whole head dim, rounded as the TPU kernel
  // rounds q * scale when prescale is set
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = kk * 16 + half * 8 + 2 * tq;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = rr ? r1 : r0;
        float x0 = 0.f, x1 = 0.f;
        if (row < a.t) {
          const __nv_bfloat16* p = q + static_cast<size_t>(row) * a.ld + c;
          x0 = __bfloat162float(p[0]);
          x1 = __bfloat162float(p[1]);
          if (a.prescale) {
            x0 = x0 * a.scale;
            x1 = x1 * a.scale;
          }
        }
        qf[kk][half * 2 + rr] = pack_bf16(x0, x1);
      }
    }
  }

  float s[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < a.t; k0 += kKeyTile) {            // pass 1
    load_tile_bf16<HD>(ks, k, k0, a.t, a.ld);
    __syncthreads();
    scores_bf16<HD>(s, qf, ks, k0, a);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[rr], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += expf(s[j][2 * rr] - mn) + expf(s[j][2 * rr + 1] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[rr] = (m[rr] == -INFINITY ? 0.f : l[rr] * expf(m[rr] - mn)) + sum;
      m[rr] = mn;
    }
    __syncthreads();
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  for (int k0 = 0; k0 < a.t; k0 += kKeyTile) {            // pass 2
    load_tile_bf16<HD>(ks, k, k0, a.t, a.ld);
    load_tile_bf16<HD>(vs, v, k0, a.t, a.ld);
    __syncthreads();
    scores_bf16<HD>(s, qf, ks, k0, a);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {            // 16 keys per k-step
      uint32_t pf[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sj = s[2 * kk + half];
        pf[half * 2] = pack_bf16(__fdiv_rn(expf(sj[0] - m[0]), l[0]),
                                 __fdiv_rn(expf(sj[1] - m[0]), l[0]));
        pf[half * 2 + 1] = pack_bf16(__fdiv_rn(expf(sj[2] - m[1]), l[1]),
                                     __fdiv_rn(expf(sj[3] - m[1]), l[1]));
      }
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nb = 0; nb < HD / 8; nb += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + key * (HD + 8) + (nb + (lane >> 4)) * 8);
        mma_bf16(o[nb], pf, b[0], b[1]);
        mma_bf16(o[nb + 1], pf, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rr ? r1 : r0;
    if (row >= a.t) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(img) * a.t + row) * a.heads + h) * HD;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * tq) =
          pack_bf16(o[nb][2 * rr], o[nb][2 * rr + 1]);
  }
}

// ---- f32, CUDA cores -------------------------------------------------------
constexpr int kF32Warps = 8, kF32RowsPerWarp = 4;
constexpr int kF32QRows = kF32Warps * kF32RowsPerWarp;   // 32

template <int HD>
constexpr size_t sdpa_f32_smem() {
  return sizeof(float) * (kKeyTile * (HD + 1) + kKeyTile * HD +
                          kF32QRows * HD + kF32QRows * kKeyTile);
}

template <int HD>
__global__ void __launch_bounds__(32 * kF32Warps)
sdpa_f32_kernel(SdpaArgs a) {
  extern __shared__ float sm[];
  float* ks = sm;                                  // (64, HD + 1)
  float* vs = ks + kKeyTile * (HD + 1);            // (64, HD)
  float* qs = vs + kKeyTile * HD;                  // (32, HD)
  float* ps = qs + kF32QRows * HD;                 // (32, 64)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, img = blockIdx.z;
  const int q0 = blockIdx.x * kF32QRows;
  const size_t base = static_cast<size_t>(img) * a.bstride + h * HD;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;

  for (int i = threadIdx.x; i < kF32QRows * HD; i += blockDim.x) {
    const int r = i / HD, c = i - r * HD;
    float x = 0.f;
    if (q0 + r < a.t) {
      x = q[static_cast<size_t>(q0 + r) * a.ld + c];
      if (a.prescale) x = x * a.scale;
    }
    qs[i] = x;
  }

  // score of key `j` of the tile for query row `r` of the CTA
  auto score = [&](int r, int j, int k0) {
    const float* qr = qs + r * HD;
    const float* kr = ks + j * (HD + 1);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc = __fmaf_rn(qr[c], kr[c], acc);
    if (!a.prescale) acc = acc * a.scale;
    return k0 + j >= a.t_real ? -INFINITY : acc;
  };
  auto load = [&](float* dst, const float* src, int k0, int ldd) {
    for (int i = threadIdx.x; i < kKeyTile * HD; i += blockDim.x) {
      const int r = i / HD, c = i - r * HD;
      dst[r * ldd + c] = k0 + r < a.t
          ? src[static_cast<size_t>(k0 + r) * a.ld + c] : 0.f;
    }
  };

  float m[kF32RowsPerWarp], l[kF32RowsPerWarp];
#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < a.t; k0 += kKeyTile) {            // pass 1
    __syncthreads();
    load(ks, k, k0, HD + 1);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const int r = warp * kF32RowsPerWarp + i;
      const float s0 = score(r, lane, k0), s1 = score(r, lane + 32, k0);
      const float mn = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      const float sum = warp_sum(expf(s0 - mn) + expf(s1 - mn));
      l[i] = (m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mn)) + sum;
      m[i] = mn;
    }
  }

  constexpr int kCols = (HD + 31) / 32;
  float o[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) o[i][cc] = 0.f;
  for (int k0 = 0; k0 < a.t; k0 += kKeyTile) {            // pass 2
    __syncthreads();
    load(ks, k, k0, HD + 1);
    load(vs, v, k0, HD);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const int r = warp * kF32RowsPerWarp + i;
      float* pr = ps + r * kKeyTile;
      pr[lane] = __fdiv_rn(expf(score(r, lane, k0) - m[i]), l[i]);
      pr[lane + 32] = __fdiv_rn(expf(score(r, lane + 32, k0) - m[i]), l[i]);
      __syncwarp();
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int c = lane + 32 * cc;
        if (c < HD) {
          float acc = o[i][cc];
          for (int j = 0; j < kKeyTile; ++j)
            acc = __fmaf_rn(pr[j], vs[j * HD + c], acc);
          o[i][cc] = acc;
        }
      }
      __syncwarp();
    }
  }

  float* out = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    const int row = q0 + warp * kF32RowsPerWarp + i;
    if (row >= a.t) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < HD)
        out[((static_cast<size_t>(img) * a.t + row) * a.heads + h) * HD + c] =
            o[i][cc];
    }
  }
}

template <int HD>
int launch_sdpa_hd(const SdpaArgs& a, int dtype, int nb, cudaStream_t st) {
  if (dtype == kBF16) {
    dim3 grid((a.t + kBf16QRows - 1) / kBf16QRows, a.heads, nb);
    sdpa_bf16_kernel<HD><<<grid, 128, 0, st>>>(a);
  } else {
    constexpr size_t smem = sdpa_f32_smem<HD>();
    cudaError_t e = cudaFuncSetAttribute(
        sdpa_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((a.t + kF32QRows - 1) / kF32QRows, a.heads, nb);
    sdpa_f32_kernel<HD><<<grid, 32 * kF32Warps, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The core over nb images; head dims 16, 32 and 64 (every ViT the package
// defines has 64; the small test shapes use 16 and 32).
int launch_sdpa(const SdpaArgs& a, int dtype, int nb, int hd,
                cudaStream_t st) {
  if (nb == 0 || a.t == 0) return 0;
  if (dtype != kBF16 && dtype != kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_sdpa_hd<16>(a, dtype, nb, st);
    case 32: return launch_sdpa_hd<32>(a, dtype, nb, st);
    case 64: return launch_sdpa_hd<64>(a, dtype, nb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
