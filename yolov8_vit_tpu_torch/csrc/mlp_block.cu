// mt::mlp_block: the float ViT's MLP sub-block in three launches,
//     h   = bf16( gelu( bf16( bf16(LN2(x) @ w1) + b1 ) ) )
//     out = bf16( x + bf16( bf16(h @ w2) + b2 ) )
// on bf16 activations with f32 sums, rounding where the port's plain
// expression rounds (models/vit.py `Block`: LayerNorm to bf16, each flax
// Dense(dtype=bf16) a product rounded to bf16 and a bf16 bias add, the
// exact GELU in f32 rounded once, the residual's bf16 add).  It replaces
// no TPU kernel: the JAX package's float MLP is plain flax (nn.Dense,
// nn.gelu(approximate=False)) that XLA fuses on the TPU, where the port
// ran about 17 device operations a block (LayerNorm's casts and
// reductions, two cuBLAS GEMMs, the bias adds, GELU, the residual add),
// each a pass over the 4x wider hidden tensor or the residual stream.
//
// Bound on the H100 at ViT-B/8, 64 crops x 785 tokens (m = 50,240 rows),
// d 768, hidden 3072: 4 m d h = 474 G bf16 operations a block (0.48 ms
// at 989 TFLOP/s) against 0.16 GB of x and out in bf16 and the weights
// (0.05 ms): operations.
//
//   1. LN rows: one warp a row held in registers, f32 statistics with
//      flax's fast variance E[x^2] - E[x]^2 clamped at 0, scale and bias,
//      one rounding.
//   2. fc1 and 3. fc2: one GEMM kernel (`mlp_gemm_kernel`), two
//      epilogues, warp-specialised.  A CTA computes 128-row tiles: one
//      producer warp's thread streams 64-deep k-tiles of a (a box of 128
//      rows, K-major, 128-byte swizzle) and of w (the JAX (in, out)
//      layout: 64 x 64 boxes, wgmma's MN-major B) through a ring of
//      stages on full / empty mbarriers; two consumer warpgroups of 64
//      rows each run wgmma m64nNk16 (N the tile's width).  Two CTAs form
//      a cluster over the same columns and rows 128 apart: each loads its
//      own rows of a and every other weight box, which TMA multicasts into
//      both CTAs, so the weight tile is read from L2 once for two CTAs;
//      a stage is free once the consumers of both CTAs released it
//      (remote mbarrier arrivals).  The grid is persistent: the clusters
//      that fit the card at once take cluster tiles in turn (columns
//      fastest, so neighbouring clusters share rows of a in L2), and the
//      ring runs on across tiles.  The epilogue is not the consumers': they
//      round each finished tile's products to bf16 into a staging area in
//      shared memory and go on to the next tile's products, while
//      epilogue warps add the bias and apply GELU (fc1: about 30
//      instructions an element, which 3 warps cannot issue in a tile's
//      mainloop time, so fc1 runs 192-column tiles and 7 epilogue warps,
//      fc2 256-column tiles and 3; see `Cfg`) or add the bias and the
//      residual (fc2), and store 16 bytes a lane.  Rows and columns past m
//      and n are not stored; m is any row count; k and n multiples of 8
//      (TMA's 16-byte strides).
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

typedef __nv_bfloat16 bf16;

enum MlpEpilogue { kGelu = 0, kResidual = 1 };

constexpr int kWgs = 2;                          // consumer warpgroups
constexpr int kBM = 64 * kWgs, kBK = 64;
constexpr int kCluster = 2;
constexpr int kABytes = kBM * kBK * 2;           // a: kBM rows of 128 B
constexpr int kBBox = kBK * 64 * 2;              // w: 64 k-rows x 64 columns
constexpr int kLnRows = 8;                       // LN rows (warps) a block

// A GEMM's tile width kBN, its epilogue warps and its ring.  The threads
// (the consumer warpgroups, the producer warp, the epilogue warps) share
// 65,536 registers alike, and the consumers hold kBN / 2 accumulators:
//   fc1 (kGelu): its GELU (erff, about 30 instructions an element) needs
//     more issue slots than the tensor cores leave idle in 3 warps' hands,
//     so 192-column tiles (96 accumulators) leave room for 7 epilogue
//     warps in 512 threads (128 registers), and 4 stages fit;
//   fc2 (kResidual): a light epilogue, 256-column tiles (1.33x fewer
//     bytes of a for each operation), 3 epilogue warps in 384 threads (168
//     registers), 3 stages beside the 64 KB staging area.
template <int kEpi>
struct Cfg {
  static constexpr int kBN = kEpi == kGelu ? 192 : 256;
  static constexpr int kEpiWarps = kEpi == kGelu ? 7 : 3;
  static constexpr int kStages = kEpi == kGelu ? 4 : 3;
  static constexpr int kThreads = 128 * kWgs + 32 + 32 * kEpiWarps;
  static constexpr int kStage = kABytes + (kBN / 64) * kBBox;
  // staging: 64 rows of kBN bf16 a consumer warpgroup
  static constexpr int kRowBytes = kBN * 2;
  static constexpr int kWgStaging = 64 * kRowBytes;
  // the ring, the staging areas, the barriers
  static constexpr int kSmem = kStages * kStage + kWgs * kWgStaging + 1024
                               + 2 * (kStages + kWgs) * 8;
  static_assert(kSmem <= 232448, "one CTA an SM");
  // the epilogue's tasks (16-byte chunks of 8 columns): kPerLane a lane,
  // whole rows a group
  static constexpr int kChunks = kBN / 8, kPerLane = 3;
  static constexpr int kRows = 32 * kPerLane / kChunks;
  static_assert(32 * kPerLane % kChunks == 0, "whole rows a group");
};

struct MlpGemm {
  int m, n, k;
  int m_tiles, n_tiles;           // cluster tiles: kCluster * kBM x kBN
  const bf16* bias;               // (n,)
  const bf16* res;                // (m, n) for kResidual
  bf16* out;                      // (m, n)
};

// D (64 x 192, f32) += A (64 x 16, bf16, K-major) B (16 x 192, bf16,
// MN-major), both from shared memory; D: 96 floats a thread, in the layout
// of hopper.cuh's wgmma_ss_n128 repeated over 24 column groups
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16, K-major) B (16 x 256, bf16,
// MN-major), both from shared memory; D: 128 floats a thread, in the
// layout of hopper.cuh's wgmma_ss_n128 repeated over 32 column groups
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_mn(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 192) wgmma_n192(d, a, b);
  else wgmma_n256(d, a, b);
}

// ---- arithmetic at the plain expression's rounding points ----------------
// the bf16 pair (low: the first) of two f32 values, rounded to nearest
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the exact GELU in f32 as PyTorch's F.gelu computes it on the card:
// x * 0.5 * (1 + erf(x / sqrt 2)), the accurate erff
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

// bf16 pattern -> bf16 pattern of its GELU, rounded once
__device__ __forceinline__ uint32_t gelu_bf16(uint32_t bits) {
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(gelu_erf(__uint_as_float(bits << 16))));
}

__global__ void gelu_table_kernel(uint16_t* __restrict__ out) {
  const uint32_t bits = blockIdx.x * blockDim.x + threadIdx.x;
  out[bits] = static_cast<uint16_t>(gelu_bf16(bits));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- 1. LN rows ------------------------------------------------------------
// One warp a row of d (a multiple of 8, at most 256 KC) bf16 values, held
// in registers (lane l the 8 values at l 8 + 256 j, j < KC): mean = sum x
// / d, var = max(sum x^2 / d - mean^2, 0), then bf16((x - mean) *
// (rsqrt(var + eps) * scale) + bias), as the plain LayerNorm's f32 ops (no
// contracted multiply-adds: -fmad=false).  x is read once.
template <int KC>
__global__ void __launch_bounds__(32 * kLnRows)
ln_rows_kernel(const bf16* __restrict__ x, int m, int d,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float eps,
               bf16* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnRows + warp;
  if (row >= m) return;
  const bf16* xr = x + row * d;
  uint4 v[KC];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int c = lane * 8 + 256 * j;
    v[j] = c < d ? *reinterpret_cast<const uint4*>(xr + c)
                 : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = __uint_as_float(w[e] << 16),
                  b = __uint_as_float(w[e] & 0xffff0000u);
      s += a + b;
      ss += a * a + b * b;
    }
  }
  const float inv = 1.f / static_cast<float>(d);
  const float mean = warp_sum(s) * inv;
  const float var = fmaxf(warp_sum(ss) * inv - mean * mean, 0.f);
  const float r = rsqrtf(var + eps);
  bf16* orow = out + row * d;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int c = lane * 8 + 256 * j;
    if (c >= d) continue;
    const float4 sc[2] = {*reinterpret_cast<const float4*>(scale + c),
                          *reinterpret_cast<const float4*>(scale + c + 4)};
    const float4 bi[2] = {*reinterpret_cast<const float4*>(bias + c),
                          *reinterpret_cast<const float4*>(bias + c + 4)};
    const float scv[8] = {sc[0].x, sc[0].y, sc[0].z, sc[0].w,
                          sc[1].x, sc[1].y, sc[1].z, sc[1].w};
    const float biv[8] = {bi[0].x, bi[0].y, bi[0].z, bi[0].w,
                          bi[1].x, bi[1].y, bi[1].z, bi[1].w};
    const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = __uint_as_float(w[e] << 16),
                  b = __uint_as_float(w[e] & 0xffff0000u);
      o[e] = pack2((a - mean) * (r * scv[2 * e]) + biv[2 * e],
                   (b - mean) * (r * scv[2 * e + 1]) + biv[2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(orow + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

constexpr int kLnMaxChunks = 8;                  // d up to 2048

template <int KC>
int ln_rows(const void* x, int m, int d, const float* scale,
            const float* bias, float eps, void* out, cudaStream_t st) {
  if constexpr (KC > kLnMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (d > 256 * KC)
      return ln_rows<KC + 1>(x, m, d, scale, bias, eps, out, st);
    ln_rows_kernel<KC><<<(m + kLnRows - 1) / kLnRows, 32 * kLnRows, 0,
                         st>>>(static_cast<const bf16*>(x), m, d, scale,
                               bias, eps, static_cast<bf16*>(out));
    return static_cast<int>(cudaGetLastError());
  }
}

// ---- 2, 3. the GEMMs ------------------------------------------------------
// A consumer warpgroup hands each finished tile's products (64 rows x kBN
// columns, rounded to bf16: the expression's first rounding point) to the
// epilogue warps through a staging area in shared memory: kBN x 2 bytes a
// row, the 16-byte chunk j of row r at chunk j ^ (r mod 8) of the row, so
// that both the writes of the accumulator layout (8 rows x 4 lanes) and
// the epilogue's reads (runs of 8 chunks of a row) are free of bank
// conflicts.

// the warp's 16 rows (16 w .. 16 w + 15 of its warpgroup's 64) of products
// from the accumulators into the warpgroup's staging area
template <int kEpi>
__device__ __forceinline__ void stage_products(const float* acc,
                                               uint8_t* stg) {
  using C = Cfg<kEpi>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  uint8_t* rows = stg + ((threadIdx.x >> 5) & 3) * 16 * C::kRowBytes;
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(rows + (g + 8 * hr) * C::kRowBytes
                                   + (j ^ g) * 16 + tq * 4) =
          pack2(acc[j * 4 + 2 * hr], acc[j * 4 + 2 * hr + 1]);
}

// the residual's 16 bytes at (row, c) (kResidual), zeros elsewhere
template <int kEpi>
__device__ __forceinline__ uint4 residual_of(int row, int c,
                                             const MlpGemm& p) {
  if (kEpi != kResidual || row >= p.m || c >= p.n)
    return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(
      p.res + static_cast<long long>(row) * p.n + c);
}

// An epilogue warp takes a warpgroup's staged rows kRows at a time: their
// kRows x kChunks chunks are 32 x kPerLane tasks, task i = lane + 32 k of
// lane `lane` (k < kPerLane) the chunk i mod kChunks of row i / kChunks,
// so a lane keeps its columns (and their bias) from one group of rows to
// the next.  Row group `gi` (rows row0 + kRows gi ..) to the output: each
// task adds its bias `b[k]` (eight f32 values) and rounds, then applies
// GELU and rounds (kGelu) or adds the residual `xv[k]` and rounds
// (kResidual); 16 bytes a task.  The tasks' GELUs are independent, which
// keeps the warp issuing.
template <int kEpi>
__device__ __forceinline__ void finish_group(const uint8_t* stg, int gi,
                                             int row0, int n0,
                                             const float (*b)[8],
                                             const uint4* xv,
                                             const MlpGemm& p) {
  using C = Cfg<kEpi>;
  const int lane = threadIdx.x & 31;
  uint32_t w[C::kPerLane][4];
#pragma unroll
  for (int k = 0; k < C::kPerLane; ++k) {
    const int i = lane + 32 * k, j = i % C::kChunks;
    const int r = gi * C::kRows + i / C::kChunks;
    const uint4 v = r < 64 ? *reinterpret_cast<const uint4*>(
        stg + r * C::kRowBytes + (j ^ (r & 7)) * 16)
        : make_uint4(0, 0, 0, 0);
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    const uint32_t x[4] = {xv[k].x, xv[k].y, xv[k].z, xv[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the bias add, both values rounded by one conversion
      const uint32_t sb = pack2(__uint_as_float(in[e] << 16) + b[k][2 * e],
                                __uint_as_float(in[e] & 0xffff0000u)
                                + b[k][2 * e + 1]);
      const float s0 = __uint_as_float(sb << 16),
                  s1 = __uint_as_float(sb & 0xffff0000u);
      w[k][e] = kEpi == kGelu
          ? pack2(gelu_erf(s0), gelu_erf(s1))
          : pack2(__uint_as_float(x[e] << 16) + s0,
                  __uint_as_float(x[e] & 0xffff0000u) + s1);
    }
  }
#pragma unroll
  for (int k = 0; k < C::kPerLane; ++k) {
    const int i = lane + 32 * k;
    const int r = gi * C::kRows + i / C::kChunks, row = row0 + r;
    const int c = n0 + (i % C::kChunks) * 8;
    if (r < 64 && row < p.m && c < p.n)
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(row) * p.n
                                + c) =
          make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
  }
}

// the residual's chunks of row group `gi` for this lane's tasks (kResidual)
template <int kEpi>
__device__ __forceinline__ void residual_group(int gi, int row0, int n0,
                                               const MlpGemm& p, uint4* xv) {
  using C = Cfg<kEpi>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < C::kPerLane; ++k) {
    const int i = lane + 32 * k;
    const int r = gi * C::kRows + i / C::kChunks;
    xv[k] = residual_of<kEpi>(r < 64 ? row0 + r : p.m,
                              n0 + (i % C::kChunks) * 8, p);
  }
}

template <int kEpi>
__global__ void __launch_bounds__(Cfg<kEpi>::kThreads, 1)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tw, const MlpGemm p) {
  using C = Cfg<kEpi>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  extern __shared__ uint8_t mlp_smem[];
  uint8_t* base = align_1024(mlp_smem);
  uint8_t* staging = base + kStages * C::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging
                                               + kWgs * C::kWgStaging);
  uint64_t* empty = full + kStages;
  uint64_t* staged = empty + kStages;    // a warpgroup's products are staged
  uint64_t* drained = staged + kWgs;     // ... and read by the epilogue warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const int tiles = p.m_tiles * p.n_tiles;
  const int nk = (p.k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // a release from each consumer warp of both CTAs
      mbar_init(&empty[s], kCluster * 4 * kWgs);
    }
    for (int w = 0; w < kWgs; ++w) {
      mbar_init(&staged[w], 128);
      mbar_init(&drained[w], 32 * C::kEpiWarps);
    }
    mbar_fence_init();
  }
  cluster_sync();       // both CTAs' barriers exist before any arrival

  // Cluster tiles (kCluster x kBM rows, kBN columns; columns fastest) are
  // dealt to the clusters in turn; every role walks the same tiles.
  if (warp == 4 * kWgs) {                  // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int t = cluster; t < tiles; t += clusters) {
        const int mt = t / p.n_tiles;
        const int m0 = (mt * kCluster + static_cast<int>(rank)) * kBM;
        const int n0 = (t - mt * p.n_tiles) * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          uint8_t* s = base + st * C::kStage;
          // this CTA's rows of a, and every weight box of the tile: each
          // CTA loads every other one, multicast into both (a box wholly
          // past m or n loads rows or columns of the tensor's start
          // instead: their outputs are not stored)
          mbar_expect_tx(&full[st], C::kStage);
          tma_load_2d(s, &ta, &full[st], kt * kBK, m0 < p.m ? m0 : 0);
          for (int box = static_cast<int>(rank); box < kBN / 64;
               box += kCluster) {
            const int c = n0 + box * 64;
            tma_load_2d_multicast(s + kABytes + box * kBBox, &tw, &full[st],
                                  c < p.n ? c : 0, kt * kBK,
                                  (1u << kCluster) - 1);
          }
        }
      }
    }
  } else if (warp > 4 * kWgs) {            // the epilogue warps
    // Each tile's rows, a warpgroup's 64 as it stages them, dealt to the
    // epilogue warps a group of rows at a time, while the consumers run
    // the next tile's mainloop: the GELU and the stores cost the tensor
    // cores no time.  A warp loads a group's residual a group ahead (past
    // the tile's last group: rows of no use, zeros past m).
    const int e = warp - 4 * kWgs - 1;
    constexpr int kGroups = (64 + C::kRows - 1) / C::kRows;
    int n = 0;
    for (int t = cluster; t < tiles; t += clusters, ++n) {
      const int mt = t / p.n_tiles;
      const int m0 = (mt * kCluster + static_cast<int>(rank)) * kBM;
      const int n0 = (t - mt * p.n_tiles) * kBN;
      float bias[C::kPerLane][8];        // this lane's columns', in f32
#pragma unroll
      for (int k = 0; k < C::kPerLane; ++k) {
        const int c = n0 + ((lane + 32 * k) % C::kChunks) * 8;
        const uint4 bv = c < p.n ? *reinterpret_cast<const uint4*>(p.bias + c)
                                 : make_uint4(0, 0, 0, 0);
        const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bias[k][2 * e] = __uint_as_float(bw[e] << 16);
          bias[k][2 * e + 1] = __uint_as_float(bw[e] & 0xffff0000u);
        }
      }
      // the tile's kWgs x kGroups groups dealt in turn across the
      // warpgroups' boundary (kGroups a warpgroup need not divide among
      // the warps); a warp waits for a warpgroup's rows before its first
      // group of them and releases them after its last
      uint4 xv[C::kPerLane], xnext[C::kPerLane];
      residual_group<kEpi>(e, m0, n0, p, xnext);
      int w = 0;
      mbar_wait(&staged[0], n & 1);
      for (int g = e; g < kWgs * kGroups; g += C::kEpiWarps) {
        for (; g >= (w + 1) * kGroups; ++w) {
          mbar_arrive(&drained[w]);
          mbar_wait(&staged[w + 1], n & 1);
        }
        const int gi = g - w * kGroups, row0 = m0 + w * 64;
#pragma unroll
        for (int k = 0; k < C::kPerLane; ++k) xv[k] = xnext[k];
        const int g2 = g + C::kEpiWarps, w2 = g2 / kGroups;
        residual_group<kEpi>(g2 - w2 * kGroups, m0 + w2 * 64, n0, p, xnext);
        finish_group<kEpi>(staging + w * C::kWgStaging, gi, row0, n0, bias,
                           xv, p);
      }
      for (; w < kWgs; ++w) {
        mbar_arrive(&drained[w]);
        if (w + 1 < kWgs) mbar_wait(&staged[w + 1], n & 1);
      }
    }
  } else {                                 // the consumer warpgroups
    const int wg = warp >> 2;
    float acc[kBN / 2];
    int it = 0, n = 0;
    for (int t = cluster; t < tiles; t += clusters, ++n) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint8_t* at = base + st * C::kStage + wg * (64 * 128);
        const uint8_t* bt = base + st * C::kStage + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_mn<kBN>(acc, gmma_desc(at + kk * 32, 16, 1024, 1),
                        gmma_desc(bt + kk * 16 * 128, kBBox, 1024, 1));
        wgmma_commit();
        wgmma_wait<1>();                 // k-tile it - 1 is done with its stage
        if (kt > 0 && lane == 0)
          mbar_arrive_cluster<kCluster>(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs<kBN / 2>(acc);
      if (lane == 0) mbar_arrive_cluster<kCluster>(&empty[(it - 1) % kStages]);
      // the epilogue warps have read the last tile's products
      mbar_wait(&drained[wg], (n & 1) ^ 1);
      stage_products<kEpi>(acc, staging + wg * C::kWgStaging);
      mbar_arrive(&staged[wg]);
    }
  }
  // no CTA leaves while the other may still multicast into it or arrive
  // on its barriers
  cluster_sync();
}

template <int kEpi>
int gemm(const void* a, const void* w, int m, int n, int k, const void* bias,
         const void* res, void* out, cudaStream_t st) {
  using C = Cfg<kEpi>;
  CUtensorMap ta, tw;
  const uint64_t adims[2] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(m)};
  const uint64_t astride[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t abox[2] = {kBK, kBM};
  int e = encode_bf16_map(&ta, a, 2, adims, astride, abox);
  if (e) return e;
  const uint64_t wdims[2] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k)};
  const uint64_t wstride[1] = {static_cast<uint64_t>(n) * 2};
  const uint32_t wbox[2] = {64, kBK};
  e = encode_bf16_map(&tw, w, 2, wdims, wstride, wbox);
  if (e) return e;
  MlpGemm p;
  p.m = m;
  p.n = n;
  p.k = k;
  p.m_tiles = (m + kCluster * kBM - 1) / (kCluster * kBM);
  p.n_tiles = (n + C::kBN - 1) / C::kBN;
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  return launch_clustered<mlp_gemm_kernel<kEpi>, kCluster>(
      p.m_tiles * p.n_tiles, C::kThreads, C::kSmem, st, ta, tw, p);
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

// The MLP sub-block of m rows: x (m, d) bf16; LN params (d,) f32; w1 (d,
// hidden) and w2 (hidden, d) bf16 in the JAX (in, out) layout, b1
// (hidden,) and b2 (d,) bf16; scratch ln (m, d) and h (m, hidden) bf16;
// out (m, d) bf16, not x.  d (at most 2048) and hidden multiples of 8,
// the matrices contiguous, every pointer 16-byte aligned.  Three
// launches on `stream`; returns a CUDA error code (cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int launch_mlp_block(const void* x, int m, int d, int hidden,
                                const float* ln_scale, const float* ln_bias,
                                float eps, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* ln,
                                void* h, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || d < 8 || d % 8 || d > 256 * kLnMaxChunks || hidden < 8
      || hidden % 8 || out == x || !aligned(ln_scale, 16)
      || !aligned(ln_bias, 16)
      || !aligned(x, 16) || !aligned(w1, 16) || !aligned(w2, 16)
      || !aligned(ln, 16) || !aligned(h, 16) || !aligned(out, 16)
      || !aligned(b1, 16) || !aligned(b2, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  int e = ln_rows<1>(x, m, d, ln_scale, ln_bias, eps, ln, st);
  if (e) return e;
  e = gemm<kGelu>(ln, w1, m, hidden, d, b1, nullptr, h, st);
  if (e) return e;
  return gemm<kResidual>(h, w2, m, d, hidden, b2, x, out, st);
}

// out: 65,536 bf16, the GELU of bf16 pattern i at i by the GEMM epilogue's
// arithmetic (gelu_erf, one rounding)
extern "C" int launch_gelu_table(void* out, void* stream) {
  gelu_table_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
