// Kernel K of the port: one ConvBlock of the bf16 detector in one launch,
//     out = bf16( silu( sum_k x * w + bias ) )            (+ residual: a
//     bf16 add, f32 sum of the two bf16 values rounded once)
// on NHWC bf16 tensors with f32 accumulation, as the JAX package's fused
// ConvBlock computes it (yolov8_vit_tpu/models/yolov8.py `ConvBlock`:
// conv_general_dilated with preferred_element_type=f32, + bias, nn.silu,
// one cast).  It replaces no TPU kernel: on the TPU XLA fuses the conv,
// the bias and the SiLU; the port ran them as five device operations
// (cast to f32, cuDNN in TF32, bias add, SiLU, cast back), about 10 ms of
// a 32-frame YOLOv8-s step in passes over f32 intermediates.
//
// Arithmetic: every product bf16 x bf16 is exact in the f32 sum; the f32
// bias is added to the sum; SiLU is y / (1 + expf(-y)) in f32 with the
// IEEE division (PyTorch's own F.silu formula, no special-function
// shortcut); one round-to-nearest-even to bf16.  A residual is added as
// PyTorch's bf16 add does, after that rounding.
//
// Bound on the H100 at YOLOv8-s, 640 x 640, 32 frames: 54 convs, 908 G
// operations (0.92 ms at 989 TFLOP/s) against 3.9 GB of inputs read once,
// outputs written once and weights (1.2 ms at 3.35 TB/s): bytes, by a
// little; the 1x1 convs alone are bytes-bound by far.
//
// Design: an implicit GEMM, M output pixels, N output channels, K taps x
// input channels, on wgmma (bf16 in, f32 sums in registers).  A CTA holds
// one producer warp and two consumer warpgroups; each warpgroup owns one
// M-block of 64 output pixels and the CTA's BN output channels (BN 64 or
// 128; the host picks 64 where 128 would leave fewer than two CTAs an
// SM).  The producer's thread streams K-blocks through a ring of stages
// in shared memory with TMA, on full / empty mbarriers:
//   input
//     1x1 convs: a plain GEMM, no halo: 64 consecutive pixels of the
//           flattened (frame, row, column) order, rows of 64 channels
//           (128 bytes) with the 128-byte swizzle, the layout wgmma reads
//           K-major with it (as csrc/gemm_float.cuh's A);
//     3x3 convs: planes of 16-byte pixels (8 channels each), the K-major
//           layout wgmma reads without swizzle (8-pixel core matrices, the
//           next 8 channels a plane further on), so that a tap is a shift
//           of whole pixels;
//     3x3 stride 1: an 8 x 8 block of output pixels, its 10 x 10 input
//           pixels with the halo by a 5-D map over (channel, column, row,
//           chunk, frame); coordinates off the image read as zeros,
//           which is the convolution's padding.  The 8-row groups of the
//           64-pixel A operand are the block's 8 output rows, one input
//           row apart (SBO), so a tap (u, v) is a shift of the
//           descriptor's start by u rows and v pixels;
//     3x3 stride 2: the same block, its 17 x 17 input pixels as an even
//           and an odd column plane (two maps, 9 columns each), so the
//           taps read one plane with a shift of 0 or 1 pixel and the
//           output rows lie two input rows apart;
//   weights the HWIO kernel (the flax tree's own layout) by a 3-D map over
//           (out channel, in channel, tap), boxes of 64 out channels with
//           the 128-byte swizzle: wgmma's MN-major B operand.
// A ragged K-block (in channels not a multiple of the block) reads zeros
// past the tensors.  The epilogue works on the accumulators in registers
// and stores each bf16 pair once; pixels off the image and channels past
// cout are not stored.  The CTAs are persistent (as many as fit the card
// at once, two or more an SM by shared memory and registers) and take
// tiles in turn; the ring runs on across tiles, so the producer loads the
// next tile while the consumers run the epilogue, and one CTA's epilogue
// overlaps another's products on the same SM.
//
// The stem (3 input channels: K = 27, padded to 32 in shared memory) has
// a kernel of its own (`conv_silu_stem_kernel`): its pixels are 6 bytes,
// which TMA cannot address, so the threads gather each output pixel's 27
// inputs (three runs of 9 contiguous values) into the same K-major layout
// and run the same wgmma.
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

typedef __nv_bfloat16 bf16;

enum ConvMode { kFlat = 0, kS1 = 1, kS2 = 2 };

constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;
constexpr int kWBoxN = 64;               // out channels of a weight box

__host__ __device__ constexpr int up(int v, int a) {
  return (v + a - 1) / a * a;
}

// per mode: in channels a K-block (KC), taps, ring stages, and the bytes
// of one warpgroup's input tile and of one weight box
template <int kMode>
struct Geo;
template <>
struct Geo<kFlat> {
  static constexpr int KC = 64, kTaps = 1, kStages = 3;
  static constexpr int kInTx = 64 * KC * 2;               // 64 pixels
  static constexpr int kInWg = kInTx;
};
template <>
struct Geo<kS1> {
  static constexpr int KC = 16, kTaps = 9, kStages = 2;
  static constexpr int kInTx = (KC / 8) * 10 * 10 * 16;   // 10 x 10 pixels
  static constexpr int kInWg = up(kInTx, 128);
};
template <>
struct Geo<kS2> {
  static constexpr int KC = 16, kTaps = 9, kStages = 2;
  static constexpr int kPar = (KC / 8) * 17 * 9 * 16;     // a column plane
  static constexpr int kInTx = 2 * kPar;
  static constexpr int kInWg = 2 * up(kPar, 128);
};

template <int kMode, int BN>
struct Layout {
  using G = Geo<kMode>;
  static constexpr int kWBox = G::kTaps * G::KC * kWBoxN * 2;
  static constexpr int kWBoxes = BN / kWBoxN;
  static constexpr int kStage = up(kWBoxes * kWBox + 2 * G::kInWg, 1024);
  static constexpr int kTx = kWBoxes * kWBox + 2 * G::kInTx;
  static constexpr int kSmem =
      G::kStages * kStage + 2 * G::kStages * 8 + 1024;
  static_assert(2 * (kSmem + 1024) <= 232448, "two CTAs an SM");
};

struct ConvParams {
  int batch, h, w, cin, ho, wo, cout;
  int tiles_x, tiles_per_image;     // 8 x 8 output blocks (3x3 modes)
  int m_blocks, n_tiles;
  long long pixels;                 // batch * ho * wo
  const float* bias;
  const bf16* res;                  // residual or nullptr, pixel stride ldr
  long long ldr;
  bf16* out;                        // pixel stride ldo
  long long ldo;
};

// D (64 x N, f32) += A (64 x 16, bf16, K-major) B (16 x N, bf16), both from
// shared memory; B MN-major (TB = 1) or K-major (TB = 0).  N = 64 here;
// N = 128 is hopper.cuh's wgmma_ss_n128.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %34;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(TB), "r"(1));
}

template <int BN, int TB>
__device__ __forceinline__ void mma(float* acc, uint64_t a, uint64_t b) {
  if constexpr (BN == 128) wgmma_ss_n128<TB>(acc, a, b, 1);
  else wgmma_ss_n64<TB>(acc, a, b);
}

// SiLU in f32 as PyTorch's F.silu computes it: y / (1 + exp(-y)), the
// accurate expf and the IEEE division
__device__ __forceinline__ float silu_f32(float y) {
  return __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
}

// the 32-bit word k of four, k a value of the lane (selects: a runtime
// index into a register array would put it in local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t* w, int k) {
  const uint32_t lo = (k & 1) ? w[1] : w[0], hi = (k & 1) ? w[3] : w[2];
  return (k & 2) ? hi : lo;
}

// the bf16 pair (low: the first) of two f32 values, rounded to nearest
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the accumulators of one warpgroup (wgmma's m64nBN f32 layout) to the
// output: + bias, SiLU, one rounding, the residual's bf16 add; pix[hr] is
// the output pixel of the thread's row 8 hr within its warp's 16 (-1: off
// the image or past the last block).  A quad of lanes holds one row's 8
// channels of each 8-channel chunk, two a lane; four chunks at a time are
// transposed across the quad (shuffles), so that each lane stores one
// chunk's 16 bytes and a warp's store writes 8 rows of 64 contiguous bytes
// (two-channel stores wrote 16 bytes a row, and the stores set the pace of
// the 1x1 convs).
template <int BN>
__device__ __forceinline__ void epilogue(const float* acc,
                                         const ConvParams& p, int n0,
                                         const long long* pix) {
  static_assert(BN % 32 == 0, "four chunks at a time");
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 4) {
    uint32_t v[2][4];                      // [row][chunk]: this lane's pair
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + (j0 + jj) * 8 + 2 * tq;
      const bool ok = n < p.cout;          // cout a multiple of 8
      const float b0 = ok ? p.bias[n] : 0.f, b1 = ok ? p.bias[n + 1] : 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        v[hr][jj] = pack2(silu_f32(acc[(j0 + jj) * 4 + 2 * hr] + b0),
                          silu_f32(acc[(j0 + jj) * 4 + 2 * hr + 1] + b1));
    }
    const int n = n0 + (j0 + tq) * 8;      // the chunk this lane stores
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      // w[k]: pair k of chunk j0 + tq, from lane k of the quad, which
      // sent its pair of that chunk in the round k ^ tq
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t got = __shfl_xor_sync(0xffffffffu,
                                             pick4(v[hr], tq ^ r), r);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k == (tq ^ r)) w[k] = got;
      }
      if (pix[hr] < 0 || n >= p.cout) continue;
      if (p.res != nullptr) {
        const uint4 rv = *reinterpret_cast<const uint4*>(
            p.res + pix[hr] * p.ldr + n);
        const uint32_t rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = pack2(__uint_as_float(rr[k] << 16)
                           + __uint_as_float(w[k] << 16),
                       __uint_as_float(rr[k] & 0xffff0000u)
                           + __uint_as_float(w[k] & 0xffff0000u));
      }
      *reinterpret_cast<uint4*>(p.out + pix[hr] * p.ldo + n) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// M-block `mb` of a 3x3 mode: frame, first output row and column
__device__ __forceinline__ void block_origin(const ConvParams& p, int mb,
                                             int* b, int* y0, int* x0) {
  *b = mb / p.tiles_per_image;
  const int r = mb - *b * p.tiles_per_image;
  const int ty = r / p.tiles_x;
  *y0 = ty * 8;
  *x0 = (r - ty * p.tiles_x) * 8;
}

template <int kMode, int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_silu_kernel(const __grid_constant__ CUtensorMap t_in,
                 const __grid_constant__ CUtensorMap t_odd,
                 const __grid_constant__ CUtensorMap t_w,
                 const ConvParams p) {
  using G = Geo<kMode>;
  using L = Layout<kMode, BN>;
  extern __shared__ uint8_t conv_smem[];
  uint8_t* base = align_1024(conv_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + G::kStages * L::kStage);
  uint64_t* empty = full + G::kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (p.m_blocks + 1) / 2 * p.n_tiles;
  const int nkb = (p.cin + G::KC - 1) / G::KC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Tiles (a pair of M-blocks x BN out channels, out channels fastest)
  // are dealt to the CTAs in turn; the ring's stage and phase run on
  // across tiles, so the producer loads the next tile's first K-blocks
  // while the consumers run this tile's epilogue.
  if (warp == kConsumers / 32) {         // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int pair = tile / p.n_tiles;
        const int n0 = (tile - pair * p.n_tiles) * BN;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int st = it % G::kStages;
          mbar_wait(&empty[st], ((it / G::kStages) & 1) ^ 1);
          uint8_t* s = base + st * L::kStage;
          mbar_expect_tx(&full[st], L::kTx);
#pragma unroll
          for (int j = 0; j < L::kWBoxes; ++j)
            tma_load_3d(s + j * L::kWBox, &t_w, &full[st], n0 + j * kWBoxN,
                        kb * G::KC, 0);
          uint8_t* in = s + L::kWBoxes * L::kWBox;
          const int chunk = kb * (G::KC / 8);
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const int mb = 2 * pair + w;
            uint8_t* dst = in + w * G::kInWg;
            if constexpr (kMode == kFlat) {
              tma_load_2d(dst, &t_in, &full[st], kb * G::KC, mb * 64);
            } else {
              int b, y0, x0;
              block_origin(p, mb, &b, &y0, &x0);
              if constexpr (kMode == kS1) {
                tma_load_5d(dst, &t_in, &full[st], 0, x0 - 1, y0 - 1, chunk,
                            b);
              } else {
                tma_load_5d(dst, &t_in, &full[st], 0, x0, 2 * y0 - 1, chunk,
                            b);
                tma_load_5d(dst + up(G::kPar, 128), &t_odd, &full[st], 0,
                            x0 - 1, 2 * y0 - 1, chunk, b);
              }
            }
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, wr = warp & 3;   // rows 16 wr + g and + 8
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int pair = tile / p.n_tiles;
    const int n0 = (tile - pair * p.n_tiles) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int st = it % G::kStages;
      mbar_wait(&full[st], (it / G::kStages) & 1);
      const uint8_t* wt = base + st * L::kStage;
      const uint8_t* in = wt + L::kWBoxes * L::kWBox + wg * G::kInWg;
      wgmma_fence();
      if constexpr (kMode == kFlat) {
#pragma unroll
        for (int kk = 0; kk < G::KC / 16; ++kk)
          mma<BN, 1>(acc, gmma_desc(in + kk * 32, 16, 1024, 1),
                     gmma_desc(wt + kk * 16 * 128, L::kWBox, 1024, 1));
      } else if constexpr (kMode == kS1) {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int u = t / 3, v = t % 3;
          mma<BN, 1>(acc, gmma_desc(in + (u * 10 + v) * 16, 1600, 160, 0),
                     gmma_desc(wt + t * G::KC * 128, L::kWBox, 1024, 1));
        }
      } else {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int u = t / 3, v = t % 3;
          // column 2 ox - 1 + v: odd plane (index ox - 1, the plane's
          // start) for v = 0, even (ox) for 1, odd (ox) for 2
          const uint8_t* plane = in + (v == 1 ? 0 : up(G::kPar, 128));
          mma<BN, 1>(acc,
                     gmma_desc(plane + (u * 9 + (v == 2)) * 16, 17 * 9 * 16,
                               2 * 9 * 16, 0),
                     gmma_desc(wt + t * G::KC * 128, L::kWBox, 1024, 1));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();                   // K-block it - 1 is done with its stage
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % G::kStages]);
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % G::kStages]);

    const int mb = 2 * pair + wg;
    long long pix[2] = {-1, -1};
    if (mb < p.m_blocks) {
      if constexpr (kMode == kFlat) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long q = static_cast<long long>(mb) * 64 + wr * 16 + g
                              + hr * 8;
          if (q < p.pixels) pix[hr] = q;
        }
      } else {
        int b, y0, x0;
        block_origin(p, mb, &b, &y0, &x0);
        const int ox = x0 + g;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int oy = y0 + 2 * wr + hr;
          if (oy < p.ho && ox < p.wo)
            pix[hr] = (static_cast<long long>(b) * p.ho + oy) * p.wo + ox;
        }
      }
    }
    epilogue<BN>(acc, p, n0, pix);
  }
}

// The stem: a 3x3 stride-2 conv over RGB (cin = 3, pixels 6 bytes apart),
// K = 27 padded to 32.  K is ordered (tap row u, tap column v, channel):
// for each u the 9 values (v, c) are one run of 9 contiguous bf16 in the
// input row.
// M-blocks of 64 consecutive output pixels, one a warpgroup; a CTA walks
// its blocks (grid-stride) with the weights' K rows (HWIO flattened, the
// same order) loaded once.  Each pair of threads gathers one pixel's 32 K
// values (zeros past K and off the image) into the K-major layout, then
// two k-steps of wgmma (B K-major) and the epilogue.
template <int BN>
__device__ __forceinline__ void mma_k(float* acc, uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_ss_n64<0>(acc, a, b);
  else wgmma_ss_small<BN>(acc, a, b, 1);
}

// K values 16 H .. 16 H + 15 of output pixel (b, oy, ox), packed in pairs
template <int H>
__device__ __forceinline__ void stem_gather(const bf16* __restrict__ x,
                                            const ConvParams& p, int b,
                                            int oy, int ox, uint32_t* v) {
  const int ix = ox * 2 - 1, iy0 = oy * 2 - 1;
  const bool col0 = ix >= 0, col2 = ix + 2 < p.w;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    constexpr int kBase = 16 * H;
    const int k = kBase + e;                     // a constant once unrolled
    if (k >= 27) continue;
    const int u = k / 9, vc = k - u * 9, c = vc / 3;
    const int iy = iy0 + u;
    const bool ok = iy >= 0 && iy < p.h && (c == 0 ? col0 : c == 2 ? col2
                                                                   : true);
    if (ok)
      v[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(
                       x[((static_cast<long long>(b) * p.h + iy) * p.w + ix)
                         * 3 + vc])) << (16 * (e & 1));
  }
}

template <int BN>
__global__ void __launch_bounds__(kConsumers)
conv_silu_stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const ConvParams p) {
  __shared__ __align__(128) uint8_t a_s[2][4 * 64 * 16];
  __shared__ __align__(128) uint8_t b_s[4 * BN * 16];
  const int tid = threadIdx.x, wg = tid >> 7, i = tid & 127;
  const int nt = blockIdx.x % p.n_tiles, n0 = nt * BN;
  const int pairs = (p.m_blocks + 1) / 2;
  const int first = blockIdx.x / p.n_tiles;
  const int stride = gridDim.x / p.n_tiles;

  for (int idx = tid; idx < 4 * BN; idx += kConsumers) {
    const int j = idx / BN, n = idx - j * BN;
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = j * 8 + e;
      if (k < 27 && n0 + n < p.cout)
        v[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(
                         w[k * p.cout + n0 + n])) << (16 * (e & 1));
    }
    *reinterpret_cast<uint4*>(b_s + idx * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }

  const int px = i >> 1, half = i & 1;
  const int lane = tid & 31, g = lane >> 2, wr = (tid >> 5) & 3;
  const long long hw = static_cast<long long>(p.ho) * p.wo;
  for (int pair = first; pair < pairs; pair += stride) {
    const int mb = 2 * pair + wg;
    const long long q = static_cast<long long>(mb) * 64 + px;
    uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (mb < p.m_blocks && q < p.pixels) {
      const int b = static_cast<int>(q / hw);
      const int r = static_cast<int>(q - b * hw);
      const int oy = r / p.wo, ox = r - oy * p.wo;
      if (half == 0) stem_gather<0>(x, p, b, oy, ox, v);
      else stem_gather<1>(x, p, b, oy, ox, v);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      *reinterpret_cast<uint4*>(a_s[wg] + ((2 * half + jj) * 64 + px) * 16) =
          make_uint4(v[4 * jj], v[4 * jj + 1], v[4 * jj + 2], v[4 * jj + 3]);
    fence_proxy_async();
    __syncthreads();

    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma_k<BN>(acc, gmma_desc(a_s[wg] + kk * 2 * 1024, 1024, 128, 0),
                gmma_desc(b_s + kk * 2 * BN * 16, BN * 16, 128, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    __syncthreads();                     // a_s is free for the next block

    long long pix[2] = {-1, -1};
    if (mb < p.m_blocks) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long qq = static_cast<long long>(mb) * 64 + wr * 16 + g
                             + hr * 8;
        if (qq < p.pixels) pix[hr] = qq;
      }
    }
    epilogue<BN>(acc, p, n0, pix);
  }
}

// CTAs resident on the card at once for a kernel, found once
int resident_ctas(const void* kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem)
             != cudaSuccess || per_sm < 1)
    return 132;
  return sms * per_sm;
}

template <int BN>
int launch_stem(const void* x, const void* wt, ConvParams& p,
                cudaStream_t st) {
  static int resident = 0;
  if (resident == 0)
    resident = resident_ctas(
        reinterpret_cast<const void*>(conv_silu_stem_kernel<BN>),
        kConsumers, 0);
  p.n_tiles = (p.cout + BN - 1) / BN;
  const long long pairs = (p.m_blocks + 1) / 2;
  // the resident CTAs walk the blocks, each loading the weights once
  const long long ctas = pairs < resident / p.n_tiles
                             ? pairs : resident / p.n_tiles;
  conv_silu_stem_kernel<BN><<<static_cast<unsigned>(
                                     (ctas > 0 ? ctas : 1) * p.n_tiles),
                                 kConsumers, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), p);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int BN>
int launch_mode(const CUtensorMap& t_in, const CUtensorMap& t_odd,
                const CUtensorMap& t_w, const ConvParams& p,
                cudaStream_t st) {
  using L = Layout<kMode, BN>;
  static int resident = 0;
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        conv_silu_kernel<kMode, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = resident_ctas(
        reinterpret_cast<const void*>(conv_silu_kernel<kMode, BN>), kThreads,
        L::kSmem);
  }
  const long long tiles = static_cast<long long>((p.m_blocks + 1) / 2)
                          * p.n_tiles;
  const long long grid = tiles < resident ? tiles : resident;
  conv_silu_kernel<kMode, BN><<<static_cast<unsigned>(grid), kThreads,
                                L::kSmem, st>>>(t_in, t_odd, t_w, p);
  return static_cast<int>(cudaGetLastError());
}

// BN: 128 where the out channels fill it and the grid still gives two
// CTAs to every SM, else 64
int pick_bn(int m_blocks, int cout, bool allow128) {
  const long long pairs = (m_blocks + 1) / 2;
  if (!allow128 || cout <= 64 || pairs * ((cout + 127) / 128) < 2 * 132)
    return 64;
  return 128;
}

}  // namespace

// One ConvBlock: x (batch, h, w, cin) bf16, element (b, y, x, c) at
// x + ((b * h + y) * w + x) * ldx + c (a channel slice of a wider NHWC
// buffer: ldx its channels); wt the HWIO kernel (k, k, cin, cout) bf16
// contiguous; bias (cout,) f32; out (batch, ho, wo, cout) at pixel stride
// ldo, and residual (same shape, pixel stride ldr) or nullptr, both
// 16-byte aligned with strides of 8 channels.  k = 1
// (stride 1) or 3 (stride 1 or 2, zero padding 1).  cin and ldx
// multiples of 8 with x 16-byte aligned, or cin = ldx = 3 with k = 3 and
// stride 2 (the stem); cout a multiple of 8.  Returns a CUDA error code (cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int launch_conv_silu(const void* x, int batch, int h, int w,
                                int cin, long long ldx, const void* wt,
                                int k, int stride, int cout,
                                const float* bias, const void* res,
                                long long ldr, void* out, long long ldo,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!((k == 1 && stride == 1) || (k == 3 && (stride == 1 || stride == 2)))
      || cin < 1 || cout < 8 || cout % 8 || ldo < cout || ldo % 8
      || reinterpret_cast<uintptr_t>(out) % 16 || h < 1 || w < 1
      || (res != nullptr && (ldr < cout || ldr % 8
                             || reinterpret_cast<uintptr_t>(res) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pad = k / 2;
  ConvParams p;
  p.batch = batch;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.ho = (h + 2 * pad - k) / stride + 1;
  p.wo = (w + 2 * pad - k) / stride + 1;
  p.cout = cout;
  p.pixels = static_cast<long long>(batch) * p.ho * p.wo;
  p.bias = bias;
  p.res = static_cast<const bf16*>(res);
  p.ldr = ldr;
  p.out = static_cast<bf16*>(out);
  p.ldo = ldo;
  if (batch == 0) return 0;

  if (cin == 3) {                                 // the stem
    if (k != 3 || stride != 2 || ldx != 3)
      return static_cast<int>(cudaErrorInvalidValue);
    p.tiles_x = p.tiles_per_image = 0;
    p.m_blocks = static_cast<int>((p.pixels + 63) / 64);
    return cout <= 32 ? launch_stem<32>(x, wt, p, st)
                      : launch_stem<64>(x, wt, p, st);
  }
  if (cin % 8 || ldx % 8 || ldx < cin)
    return static_cast<int>(cudaErrorInvalidValue);

  const uint64_t esz = 2;
  // weights: (out channel, in channel, tap), boxes of 64 x KC x taps
  const int mode = k == 1 ? kFlat : stride == 1 ? kS1 : kS2;
  const int kc = mode == kFlat ? Geo<kFlat>::KC : Geo<kS1>::KC;
  CUtensorMap t_w, t_in, t_odd;
  {
    const uint64_t dims[3] = {static_cast<uint64_t>(cout),
                              static_cast<uint64_t>(cin),
                              static_cast<uint64_t>(k * k)};
    const uint64_t strides[2] = {cout * esz, static_cast<uint64_t>(cin)
                                                 * cout * esz};
    const uint32_t box[3] = {kWBoxN, static_cast<uint32_t>(kc),
                             static_cast<uint32_t>(k * k)};
    const int e = encode_bf16_map(&t_w, wt, 3, dims, strides, box);
    if (e) return e;
  }
  const uint64_t px = ldx * esz;                 // bytes a pixel
  if (mode == kFlat) {
    p.tiles_x = p.tiles_per_image = 0;
    p.m_blocks = static_cast<int>((p.pixels + 63) / 64);
    const uint64_t dims[2] = {static_cast<uint64_t>(cin),
                              static_cast<uint64_t>(p.pixels)};
    const uint64_t strides[1] = {px};
    const uint32_t box[2] = {Geo<kFlat>::KC, 64};
    int e = encode_bf16_map(&t_in, x, 2, dims, strides, box);
    if (e) return e;
    t_odd = t_in;
  } else {
    p.tiles_x = (p.wo + 7) / 8;
    p.tiles_per_image = p.tiles_x * ((p.ho + 7) / 8);
    p.m_blocks = batch * p.tiles_per_image;
    const uint64_t row = static_cast<uint64_t>(w) * px;
    const uint64_t img = static_cast<uint64_t>(h) * row;
    const uint32_t chunks = Geo<kS1>::KC / 8;
    if (mode == kS1) {
      const uint64_t dims[5] = {8, static_cast<uint64_t>(w),
                                static_cast<uint64_t>(h),
                                static_cast<uint64_t>(cin / 8),
                                static_cast<uint64_t>(batch)};
      const uint64_t strides[4] = {px, row, 16, img};
      const uint32_t box[5] = {8, 10, 10, chunks, 1};
      int e = encode_bf16_map(&t_in, x, 5, dims, strides, box);
      if (e) return e;
      t_odd = t_in;
    } else {
      if (w < 2) return static_cast<int>(cudaErrorInvalidValue);
      const uint64_t strides[4] = {2 * px, row, 16, img};
      const uint32_t box[5] = {8, 9, 17, chunks, 1};
      const uint64_t even[5] = {8, static_cast<uint64_t>((w + 1) / 2),
                                static_cast<uint64_t>(h),
                                static_cast<uint64_t>(cin / 8),
                                static_cast<uint64_t>(batch)};
      int e = encode_bf16_map(&t_in, x, 5, even, strides, box);
      if (e) return e;
      uint64_t odd[5] = {8, static_cast<uint64_t>(w / 2), even[2], even[3],
                         even[4]};
      e = encode_bf16_map(&t_odd, static_cast<const bf16*>(x) + ldx, 5, odd,
                          strides, box);
      if (e) return e;
    }
  }
  const int bn = pick_bn(p.m_blocks, cout, mode != kS2);
  p.n_tiles = (cout + bn - 1) / bn;
  if (mode == kFlat)
    return bn == 128 ? launch_mode<kFlat, 128>(t_in, t_odd, t_w, p, st)
                     : launch_mode<kFlat, 64>(t_in, t_odd, t_w, p, st);
  if (mode == kS1)
    return bn == 128 ? launch_mode<kS1, 128>(t_in, t_odd, t_w, p, st)
                     : launch_mode<kS1, 64>(t_in, t_odd, t_w, p, st);
  return launch_mode<kS2, 64>(t_in, t_odd, t_w, p, st);
}
