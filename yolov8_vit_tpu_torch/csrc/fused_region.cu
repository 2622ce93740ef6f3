// Kernel J of the port: the detector's early region, b1 (3x3 stride-2
// conv + SiLU) followed by b2 (C2f with one shortcut bottleneck), in bf16
// with f32 accumulation.  Replaces yolov8_vit_tpu/ops/fused_region.py
// `_kern` (`fused_b1b2`).
//
// The TPU program works on 2x2-cell tensors (4C lanes, embedded kernels
// with structural zeros) because its matrix unit is 128 lanes wide; this
// port computes the same function on flat NHWC tensors with the flat conv
// kernels, and so does a quarter of those multiply-adds.
//
// Bound on the H100 at the deployed shape (32 frames, 320x320x32 in,
// 160x160x64 out): the five convolutions are 77 G bf16 operations, 78 us
// at 989 TFLOP/s; the bytes the function must move (input once, output
// once, the five stages' 47,104 bf16 weights, 94 KB) are 315 MB, 94 us at
// 3.35 TB/s: bound by bytes.  So nothing but the input and the output may
// cross device memory, and the five stages run inside one CTA.
//
// Design: one launch of a persistent kernel, one CTA an SM: a producer
// warp and two consumer warpgroups, the front (b1, cv1) and the back
// (m0.cv1, m0.cv2 + residual, cv2).  A work unit is a column strip of one
// image, 60 output columns wide, over a segment of output rows (the host
// picks the segments so that the units fill whole waves of the SMs).  A
// CTA walks its units top to bottom with a rolling window of rows in
// shared memory:
//   input   rows 2Y .. 2Y + 1 a slot, by TMA (a 5-D map over (channel,
//           column parity, column / 2, row, image): each 8-channel chunk of
//           each column parity is a plane of 16-byte pixels, the layout
//           wgmma reads K-major without swizzle, so a tap's one-pixel
//           shift is a 16-byte shift of the descriptor's start and the
//           stride-2 taps read the even or the odd plane; coordinates off
//           the image read as zeros, which is the convolutions' padding);
//           a ring of 4 slots on full / empty mbarriers, the producer
//           running ahead of the front;
//   y       one row (b1's output, the front's), y1 a ring of 4 rows (cv1's:
//           p0 | p1, written by the front, read by the back), m1 three
//           rows and h one (the back's), all bf16 in the same planar
//           layout, 64 pixels (2 halo columns each side of the strip) plus
//           a zero slack pixel at each end;
//   out     one row of 60 pixels, written by a 4-D TMA store (128-byte or
//           64-byte swizzle; the store drops what lies off the image).
// The front, for each row Y: b1 -> y, cv1 -> y1 row Y.  The back, for each
// output row r: m1 row r + 1 from p1 rows r .. r + 2, m2 row r from m1 rows
// r - 1 .. r + 1, h = p1 + m2, cv2 over (p0, p1, h) -> out row r.  Named
// barriers hand each y1 row from the front to the back and back again, so
// one warpgroup's products run while the other's epilogue does.  A segment
// of rows [R0, R1) starts two rows early (y1 from R0 - 2, m1 from R0 - 1):
// those halo rows are recomputed, not shared between units.  Every product
// is wgmma m64nNk16 (bf16 in, f32 sum), A (64 pixels) and B (the weights,
// K-major: (tap, 8-channel chunk) blocks of N rows of 16 bytes) from
// shared memory.  The weights of all five stages stay in shared memory for
// the CTA's life, so a CTA reads them once.  The epilogue is
// `_silu_bf16` (silu2_bf16); the residual is a bf16 add.  After every
// stage that feeds a 3x3 conv (y1, m1), pixels off the image (rows or
// columns) are set to zero, as the TPU kernel masks its halo rows
// (silu(bias) != 0).
//
// What sets its pace (PERF.md §6; builds with parts of it removed): the
// epilogues, two special-function operations an output, 16,384 outputs a
// row, which four warps a role do not keep busy; then the products'
// shared-memory reads (A 2 KB a k-step).
//
// Shared memory at (c1, c2) = (32, 64): out 7,680 + input ring 4 x 17,408
// + weights 94,208 + y 8,448 + y1 4 x 8,448 + m1 3 x 4,224 + h 4,224 +
// barriers + 1,024 of alignment = 231,744 bytes of the 232,448 a CTA may
// have: one launch, no intermediate in device memory (the biases are read
// through the read-only cache).  So the fused kernel is built for (32, 64)
// (YOLOv8-s) and (16, 32) (YOLOv8-n) only.
//
// Wider widths (YOLOv8-m's (48, 96) holds 212 KB of weights alone, -l's
// and -x's more) run the five-launch form (`wide`): one implicit-GEMM
// conv kernel (mma.sync m16n8k16) launched a stage, the four
// intermediates in caller scratch.  A CTA computes 8 x 16 output pixels
// for up to 64 output channels: it stages the input tile with its halo
// (zero outside the image) and its channels' weights in shared memory,
// 16 padding bytes a pixel and a weight row so that the fragment loads
// meet no bank conflict; each of its 8 warps owns one output row.  At
// (80, 160) b1 stages 192 KB.  Its weights are `prepare_region`'s too,
// (out channel, tap x in channel) a stage.  It keeps the IEEE logistic.
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

constexpr int kPix = 64;            // pixels a row computes (wgmma's M)
constexpr int kStrip = 60;          // output columns a strip keeps
constexpr int kEnt = kPix + 2;      // row-buffer entries: a slack pixel a side
constexpr int kInEnt = kPix + 1;    // input plane entries a row
constexpr int kSlots = 4;           // input ring
constexpr int kY1 = 4;              // y1 ring: rows the back runs behind
// consumers: the back (warpgroup 0) and the front (warpgroup 1)
constexpr int kRole = 128;
constexpr int kConsumers = 2 * kRole;
constexpr int kThreads = kConsumers + 32;

__host__ __device__ constexpr int up(int v, int a) {
  return (v + a - 1) / a * a;
}

template <int C1, int C2>
struct Region {
  static constexpr int C = C2 / 2;
  // weight elements of each stage, in the order b1, cv1, m0.cv1, m0.cv2, cv2
  static constexpr int kWb1 = 9 * C1 * C2, kWcv1 = C2 * C2, kWm = 9 * C * C,
                       kWcv2 = 3 * C * C2;
  static constexpr int kW = kWb1 + kWcv1 + 2 * kWm + kWcv2;
  // an input box: 2 rows x kInEnt pixels x 16 bytes, 128-byte aligned
  static constexpr int kBoxBytes = 2 * kInEnt * 16;
  static constexpr int kBox = up(kBoxBytes, 128);
  static constexpr int kBoxes = 2 * (C1 / 8);          // parity x chunk
  static constexpr int kSlot = kBoxes * kBox;
  static constexpr int kPlane = kEnt * 16;
  static constexpr int kYRow = (C2 / 8) * kPlane;
  static constexpr int kMRow = (C / 8) * kPlane;
  static constexpr int kOutRow = C2 * 2;                // bytes a pixel
  // byte offsets from the 1,024-aligned base
  static constexpr int oOut = 0;
  static constexpr int oIn = up(kStrip * kOutRow, 128);
  static constexpr int oW = oIn + kSlots * kSlot;
  static constexpr int oY = up(oW + 2 * kW, 128);
  static constexpr int oY1 = oY + kYRow;
  static constexpr int oM1 = oY1 + kY1 * kYRow;
  static constexpr int oH = oM1 + 3 * kMRow;
  static constexpr int oBar = up(oH + kMRow, 8);
  static constexpr int kSmem = oBar + 2 * kSlots * 8 + 1024;
  static_assert(kSmem <= 232448, "kernel J's shared memory");
  static_assert(C1 % 16 == 0 && C % 16 == 0, "16-channel k-steps");
};

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// K-major operand without swizzle: rows 16 bytes apart (8-row groups at
// 128), the second 8-element chunk of a k-step `lbo` bytes on
__device__ __forceinline__ uint64_t kdesc(const uint8_t* p, unsigned lbo) {
  return gmma_desc(p, lbo, 128, 0);
}

// the logistic of a bf16-valued y in f32: IEEE expf and division
// (kExact: the five-launch form), or one ex2 and one reciprocal on the
// special-function units (the fused kernel: __expf, __fdividef, a few f32
// ulps off).  `silu_table_kernel` holds both on every bf16 y against the
// plain version: the exact form rounds as it does on every finite y, the
// fast form on every y >= -87.3; below, where 1 + e^-y > 2^126,
// __fdividef returns 0 for a logistic under 2^-126, so SiLU gives -0
// where the plain version gives a value under 2^-119 in magnitude.  The
// exact form costs the fused kernel about 0.4 ms a call (PERF.md §6).
template <bool kExact>
__device__ __forceinline__ float logistic(float y) {
  if constexpr (kExact) return __fdiv_rn(1.f, 1.f + expf(-y));
  return __fdividef(1.f, 1.f + __expf(-y));
}

// f32 sums + biases of two channels -> their bf16 SiLU pair (low: the
// first), at the TPU kernel's `_silu_bf16` rounding points: the sum
// rounded to bf16, the logistic in f32 rounded to bf16, their product
// rounded to bf16 (a bf16 pair product: the f32 product of two bf16 is
// exact, so one rounding either way).  The roundings go two values an
// instruction.
template <bool kExact>
__device__ __forceinline__ uint32_t silu2_bf16(float a0, float a1, float b0,
                                               float b1) {
  const __nv_bfloat162 y = __floats2bfloat162_rn(a0 + b0, a1 + b1);
  const __nv_bfloat162 r = __hmul2(
      y, __floats2bfloat162_rn(logistic<kExact>(__low2float(y)),
                               logistic<kExact>(__high2float(y))));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the bf16 at the low or high half of a pair, as an f32
__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// a stage's outputs from its accumulators (mma.sync's C layout over N / 8
// column groups): v[nb][rr] is the SiLU pair of channels nb * 8 + 2 tq,
// + 1 at pixel px0 + 8 rr.  All are computed before any is stored, so
// their special-function work overlaps (a store or a mask between them
// would serialize the chains).
template <int N>
__device__ __forceinline__ void silu_pairs(const float* acc,
                                           const float* bias, int tq,
                                           uint32_t (*v)[2]) {
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    const int ch = nb * 8 + 2 * tq;
    const float b0 = __ldg(bias + ch), b1 = __ldg(bias + ch + 1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      v[nb][rr] = silu2_bf16<false>(acc[nb * 4 + 2 * rr],
                                    acc[nb * 4 + 2 * rr + 1], b0, b1);
  }
}

// one stage's products for this warpgroup: acc (64 pixels x N) over TAPS
// taps of KS k-steps; a(tap, ks) and b(tap, ks) give the descriptors
template <int N, int TAPS, int KS, class FA, class FB>
__device__ __forceinline__ void stage_mma(float* acc, FA a, FB b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_ss_small<N>(acc, a(t, s), b(t, s), t + s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
}

struct RegionArgs {
  const __nv_bfloat16* w;    // the prepared weights (`prepare_region`)
  const float* bias;
  int ho, wo;                // output rows and columns
  int strips, segs, seg_rows, units;
};

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 1)
fused_region_kernel(const __grid_constant__ CUtensorMap tin,
                    const __grid_constant__ CUtensorMap tout,
                    const RegionArgs a) {
  using L = Region<C1, C2>;
  constexpr int C = L::C;
  extern __shared__ uint8_t region_smem[];
  uint8_t* base = align_1024(region_smem);
  uint8_t* sout = base + L::oOut;
  uint8_t* sinp = base + L::oIn;
  uint8_t* sw = base + L::oW;
  uint8_t* sy = base + L::oY;
  uint8_t* sy1 = base + L::oY1;
  uint8_t* sm1 = base + L::oM1;
  uint8_t* sh = base + L::oH;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::oBar);
  uint64_t* empty = full + kSlots;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the weights once, the row buffers zeroed once (their slack pixels
  // stay zero)
  {
    const int4* src = reinterpret_cast<const int4*>(a.w);
    int4* dst = reinterpret_cast<int4*>(sw);
    for (int i = tid; i < 2 * L::kW / 16; i += kThreads) dst[i] = src[i];
    int4* z = reinterpret_cast<int4*>(sy);
    for (int i = tid; i < (L::oBar - L::oY) / 16; i += kThreads)
      z[i] = make_int4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kRole / 32);       // the front's warps
    }
    mbar_fence_init();
  }
  fence_proxy_async();
  __syncthreads();

  auto decode = [&](int u, int& img, int& x0, int& r0, int& r1) {
    const int strip = u % a.strips, t = u / a.strips;
    const int seg = t % a.segs;
    img = t / a.segs;
    x0 = strip * kStrip;
    r0 = seg * a.seg_rows;
    r1 = min(a.ho, r0 + a.seg_rows);
  };

  if (warp == kConsumers / 32) {             // the producer warp
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        int img, x0, r0, r1;
        decode(u, img, x0, r0, r1);
        for (int s = r0 - 3; s <= r1 + 1; ++s, ++it) {
          const int st = it % kSlots;
          mbar_wait(&empty[st], ((it / kSlots) & 1) ^ 1);
          mbar_expect_tx(&full[st], L::kBoxes * L::kBoxBytes);
          uint8_t* dst = sinp + st * L::kSlot;
          for (int p = 0; p < 2; ++p)
            for (int j = 0; j < C1 / 8; ++j)
              tma_load_5d(dst + (p * (C1 / 8) + j) * L::kBox, &tin,
                          &full[st], 8 * j, p, x0 - 3, 2 * s, img);
        }
      }
    }
    return;
  }

  // ---- the consumers: the front (warpgroup 1: b1, cv1) writes y1 rows
  // into a ring of kY1, the back (warpgroup 0: m0.cv1, m0.cv2 + residual,
  // cv2, the stores) reads them; each runs its own products while the
  // other runs its epilogue.  Ring row k is handed over by named barriers
  // kFull + k (the front arrives, the back waits) and kEmpty + k (the
  // back arrives when done with the row, the front waits before writing
  // it again); each warpgroup's stages are ordered by its own barrier.
  constexpr int kBack = 1, kFront = 2, kFull = 3, kEmpty = kFull + kY1;
  constexpr int kBoth = 2 * kRole;
  const int g = lane >> 2, tq = lane & 3;
  const int px0 = (warp & 3) * 16 + g;       // pixels px0, px0 + 8
  const uint8_t* w_b1 = sw;
  const uint8_t* w_cv1 = w_b1 + 2 * L::kWb1;
  const uint8_t* w_m1 = w_cv1 + 2 * L::kWcv1;
  const uint8_t* w_m2 = w_m1 + 2 * L::kWm;
  const uint8_t* w_cv2 = w_m2 + 2 * L::kWm;
  const float* b_b1 = a.bias;
  const float* b_cv1 = b_b1 + C2;
  const float* b_m1 = b_cv1 + C2;
  const float* b_m2 = b_m1 + C;
  const float* b_cv2 = b_m2 + C;
  auto ring3 = [](int row) { return (row % 3 + 3) % 3; };
  // whether pixel px (column x0 - 2 + px) of row `row` lies on the image
  auto inside = [&](int x0, int row, int px) {
    const int x = x0 - 2 + px;
    return row >= 0 && row < a.ho && x >= 0 && x < a.wo;
  };
  auto y1row = [&](int k) { return sy1 + k * L::kYRow; };
  // a (pixel, channel pair) of a planar row buffer
  auto at = [](uint8_t* row, int px, int ch) {
    return reinterpret_cast<uint32_t*>(row + (ch >> 3) * L::kPlane
                                       + (px + 1) * 16 + (ch & 7) * 2);
  };

  if (warp >= kRole / 32) {                  // ---- the front -------------
    int it = 0, rows = 0;                    // slots and y1 rows so far
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      int img, x0, r0, r1;
      decode(u, img, x0, r0, r1);
      const int nsl = r1 - r0 + 5;           // slots r0 - 3 .. r1 + 1
      mbar_wait(&full[it % kSlots], (it / kSlots) & 1);
      for (int y = r0 - 2; y <= r1 + 1; ++y, ++rows) {
        const int k = y - (r0 - 2);          // slots it + k (y - 1), + k + 1
        const int sp = (it + k) % kSlots, sc = (it + k + 1) % kSlots;
        mbar_wait(&full[sc], ((it + k + 1) / kSlots) & 1);
        named_barrier(kFront, kRole);        // cv1 has read the last y
        // b1: 3x3 stride 2 from input rows 2y - 1 .. 2y + 1 -> y
        {
          constexpr int N = C2;
          float acc[N / 2];
          const uint8_t* prev = sinp + sp * L::kSlot;
          const uint8_t* cur = sinp + sc * L::kSlot;
          stage_mma<N, 9, C1 / 16>(
              acc,
              [&](int t, int s) {
                const int uu = t / 3, v = t % 3;
                const uint8_t* slot = uu == 0 ? prev : cur;
                const int q = uu == 1 ? 0 : 1;
                const int par = v == 1 ? 0 : 1, e0 = v == 0 ? 0 : 1;
                return kdesc(slot + (par * (C1 / 8) + 2 * s) * L::kBox
                                 + q * kInEnt * 16 + e0 * 16,
                             L::kBox);
              },
              [&](int t, int s) {
                return kdesc(w_b1 + (t * (C1 / 8) + 2 * s) * C2 * 16,
                             C2 * 16);
              });
          if (lane == 0) mbar_arrive(&empty[sp]);
          uint32_t v[N / 8][2];
          silu_pairs<N>(acc, b_b1, tq, v);
#pragma unroll
          for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              *at(sy, px0 + 8 * rr, nb * 8 + 2 * tq) = v[nb][rr];
        }
        fence_proxy_async();
        named_barrier(kFront, kRole);
        // cv1: 1x1 -> y1 row y (p0 | p1), zero off the image
        {
          constexpr int N = C2;
          float acc[N / 2];
          stage_mma<N, 1, C2 / 16>(
              acc,
              [&](int, int s) {
                return kdesc(sy + 2 * s * L::kPlane + 16, L::kPlane);
              },
              [&](int, int s) {
                return kdesc(w_cv1 + 2 * s * C2 * 16, C2 * 16);
              });
          const int kr = rows % kY1;
          if (rows >= kY1) named_barrier(kEmpty + kr, kBoth);
          uint8_t* dst = y1row(kr);
          uint32_t v[N / 8][2];
          silu_pairs<N>(acc, b_cv1, tq, v);
#pragma unroll
          for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              *at(dst, px0 + 8 * rr, nb * 8 + 2 * tq) =
                  inside(x0, y, px0 + 8 * rr) ? v[nb][rr] : 0u;
          fence_proxy_async();
          named_barrier_arrive(kFull + kr, kBoth);
        }
      }
      // the last slot (row r1 + 1's inputs)
      if (lane == 0) mbar_arrive(&empty[(it + nsl - 1) % kSlots]);
      it += nsl;
    }
    // the back's releases of the last kY1 rows, so that no barrier is left
    // half arrived
    for (int r = rows > kY1 ? rows - kY1 : 0; r < rows; ++r)
      named_barrier(kEmpty + r % kY1, kBoth);
    return;
  }

  // ---- the back ----------------------------------------------------------
  int rows = 0;                              // y1 rows of earlier units
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    int img, x0, r0, r1;
    decode(u, img, x0, r0, r1);
    // ring row of y1 row R of this unit, its hand-over and its release
    auto kr = [&](int row) { return (rows + row - (r0 - 2)) % kY1; };
    auto ready = [&](int row) { named_barrier(kFull + kr(row), kBoth); };
    auto done = [&](int row) {
      named_barrier_arrive(kEmpty + kr(row), kBoth);
    };
    // m0.cv1: 3x3 over p1 rows m - 1 .. m + 1 -> m1 row m, zero off the
    // image
    auto m1_row = [&](int m) {
      constexpr int N = C;
      float acc[N / 2];
      stage_mma<N, 9, C / 16>(
          acc,
          [&](int t, int s) {
            return kdesc(y1row(kr(m - 1 + t / 3))
                             + (C / 8 + 2 * s) * L::kPlane + (t % 3) * 16,
                         L::kPlane);
          },
          [&](int t, int s) {
            return kdesc(w_m1 + (t * (C / 8) + 2 * s) * C * 16, C * 16);
          });
      uint8_t* dst = sm1 + ring3(m) * L::kMRow;
      uint32_t v[N / 8][2];
      silu_pairs<N>(acc, b_m1, tq, v);
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *at(dst, px0 + 8 * rr, nb * 8 + 2 * tq) =
              inside(x0, m, px0 + 8 * rr) ? v[nb][rr] : 0u;
      fence_proxy_async();
      named_barrier(kBack, kRole);
    };
    ready(r0 - 2);
    ready(r0 - 1);
    ready(r0);
    m1_row(r0 - 1);
    done(r0 - 2);
    ready(r0 + 1);
    m1_row(r0);
    done(r0 - 1);
    for (int r = r0; r < r1; ++r) {
      ready(r + 2);
      m1_row(r + 1);
      uint8_t* p = y1row(kr(r));
      // m0.cv2: 3x3 over m1 rows r - 1 .. r + 1, h = p1 + m2
      {
        constexpr int N = C;
        float acc[N / 2];
        stage_mma<N, 9, C / 16>(
            acc,
            [&](int t, int s) {
              const uint8_t* row = sm1 + ring3(r - 1 + t / 3) * L::kMRow;
              return kdesc(row + 2 * s * L::kPlane + (t % 3) * 16,
                           L::kPlane);
            },
            [&](int t, int s) {
              return kdesc(w_m2 + (t * (C / 8) + 2 * s) * C * 16, C * 16);
            });
        uint32_t v[N / 8][2];
        silu_pairs<N>(acc, b_m2, tq, v);
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int px = px0 + 8 * rr, ch = nb * 8 + 2 * tq;
            const uint32_t res = *at(p, px, C + ch);
            const __nv_bfloat162 h = __floats2bfloat162_rn(
                lo_bf16(res) + lo_bf16(v[nb][rr]),
                hi_bf16(res) + hi_bf16(v[nb][rr]));
            *at(sh, px, ch) = *reinterpret_cast<const uint32_t*>(&h);
          }
      }
      if (tid == 0) bulk_wait_read();       // the last row's store read sout
      fence_proxy_async();
      named_barrier(kBack, kRole);
      // cv2: 1x1 over (p0, p1, h) -> out row r
      {
        constexpr int N = C2;
        float acc[N / 2];
        stage_mma<N, 1, 3 * C / 16>(
            acc,
            [&](int, int s) {
              const int ch = 2 * s;            // 8-channel chunk
              const uint8_t* src = ch < C2 / 8
                                       ? p + ch * L::kPlane
                                       : sh + (ch - C2 / 8) * L::kPlane;
              return kdesc(src + 16, L::kPlane);
            },
            [&](int, int s) {
              return kdesc(w_cv2 + 2 * s * C2 * 16, C2 * 16);
            });
        // swizzled as the output map's box (Swizzle<B, 4, 3>)
        constexpr int kB = C2 * 2 == 128 ? 3 : C2 * 2 == 64 ? 2 : 1;
        uint32_t v[N / 8][2];
        silu_pairs<N>(acc, b_cv2, tq, v);
#pragma unroll
        for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int op = px0 + 8 * rr - 2;
            const uint32_t off = op * L::kOutRow + (nb * 8 + 2 * tq) * 2;
            if (op >= 0 && op < kStrip)
              *reinterpret_cast<uint32_t*>(
                  sout + (off ^ (((off >> 7) & ((1u << kB) - 1)) << 4))) =
                  v[nb][rr];
          }
      }
      fence_proxy_async();
      named_barrier(kBack, kRole);
      if (tid == 0) {
        tma_store_4d(&tout, sout, 0, x0, r, img);
        bulk_commit();
      }
      done(r);
    }
    done(r1);
    done(r1 + 1);
    rows += r1 - r0 + 4;
  }
  if (tid == 0) bulk_wait_all();
}

template <int C1, int C2>
int launch_region(const void* x, int batch, int h, int w, const void* wprep,
                  const float* bias, void* out, cudaStream_t st) {
  using L = Region<C1, C2>;
  const int ho = h / 2, wo = w / 2;
  // input: (channel, column parity, column / 2, row, image); the box one
  // 8-channel chunk of one parity, kInEnt pixels, 2 rows
  const uint64_t din[5] = {C1, 2, static_cast<uint64_t>(wo),
                           static_cast<uint64_t>(h),
                           static_cast<uint64_t>(batch)};
  const uint64_t str_in[4] = {2ull * C1, 4ull * C1, 2ull * C1 * w,
                              2ull * C1 * w * h};
  const uint32_t bin[5] = {8, 1, kInEnt, 2, 1};
  // output: (channel, column, row, image); the box one row of the strip
  const uint64_t dout[4] = {C2, static_cast<uint64_t>(wo),
                            static_cast<uint64_t>(ho),
                            static_cast<uint64_t>(batch)};
  const uint64_t str_out[3] = {2ull * C2, 2ull * C2 * wo,
                               2ull * C2 * wo * ho};
  const uint32_t bout[4] = {C2, kStrip, 1, 1};
  CUtensorMap tin, tout;
  int e = encode_bf16_map(&tin, x, 5, din, str_in, bin);
  if (e) return e;
  e = encode_bf16_map(&tout, out, 4, dout, str_out, bout);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      fused_region_kernel<C1, C2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  int dev = 0, sms = 0;
  ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  RegionArgs a;
  a.w = static_cast<const __nv_bfloat16*>(wprep);
  a.bias = bias;
  a.ho = ho;
  a.wo = wo;
  a.strips = (wo + kStrip - 1) / kStrip;
  // row segments: the fewest waves of units, each unit paying 4 rows of
  // recomputed halo
  long best = -1;
  for (int segs = 1; segs <= ho && segs <= 64; ++segs) {
    const int rows = (ho + segs - 1) / segs;
    const long units = static_cast<long>(batch) * a.strips * segs;
    const long cost = (units + sms - 1) / sms * (rows + 4);
    if (best < 0 || cost < best) {
      best = cost;
      a.segs = segs;
      a.seg_rows = rows;
    }
  }
  a.segs = (ho + a.seg_rows - 1) / a.seg_rows;
  a.units = batch * a.strips * a.segs;
  const int grid = a.units < sms ? a.units : sms;
  fused_region_kernel<C1, C2><<<grid, kThreads, L::kSmem, st>>>(tin, tout,
                                                                 a);
  return static_cast<int>(cudaGetLastError());
}

// every bf16 value y (bit pattern i) -> silu2_bf16 of y with either
// logistic, bf16 bits: the epilogue on every value a stage's rounded sum
// can take, for the check against the plain version
__global__ void silu_table_kernel(uint32_t* fast, uint32_t* exact) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // a pair
  if (i >= 32768) return;
  const float y0 = __uint_as_float(static_cast<uint32_t>(2 * i) << 16);
  const float y1 = __uint_as_float(static_cast<uint32_t>(2 * i + 1) << 16);
  fast[i] = silu2_bf16<false>(y0, y1, 0.f, 0.f);
  exact[i] = silu2_bf16<true>(y0, y1, 0.f, 0.f);
}

// ---- the five-launch form, for widths the fused kernel cannot hold -------
namespace wide {

constexpr int kTH = 8, kTW = 16;     // output tile (rows = warps)
constexpr int kMaxSeg = 3;
constexpr int kPadBytes = 16;

struct ConvArgs {
  // input: nseg channel segments of cseg channels each; element (b, y, x,
  // c) of segment s at x[s] + ((b * h + y) * w + x) * ldx[s] + c
  const __nv_bfloat16* x[kMaxSeg];
  int ldx[kMaxSeg];
  int nseg, cseg;
  int h, w, ho, wo, ksize, stride, pad;
  // weights (cout, ksize * ksize * nseg * cseg), k = tap * cin + channel
  const __nv_bfloat16* wt;
  const float* bias;
  int cout;
  const __nv_bfloat16* res;          // optional residual, row stride ldr
  int ldr;
  __nv_bfloat16* out;                // row stride ldo
  int ldo;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 sum + bias -> bf16 SiLU as the TPU kernel's `_silu_bf16`
__device__ __forceinline__ __nv_bfloat16 silu_bf16(float acc, float bias) {
  const __nv_bfloat16 y = __float2bfloat16_rn(acc + bias);
  const float yf = __bfloat162float(y);
  const __nv_bfloat16 s = __float2bfloat16_rn(logistic<true>(yf));
  return __float2bfloat16_rn(yf * __bfloat162float(s));
}

template <int NT>      // n-tiles of 8 output channels per block
__global__ void __launch_bounds__(256) conv_bf16_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cin = a.nseg * a.cseg;
  const int kk = a.ksize * a.ksize * cin;
  const int ps = cin * 2 + kPadBytes;            // bytes per staged pixel
  const int ws = kk * 2 + kPadBytes;             // bytes per weight row
  const int in_w = (kTW - 1) * a.stride + a.ksize;
  const int in_h = (kTH - 1) * a.stride + a.ksize;
  unsigned char* xs = smem;
  unsigned char* wsm = smem + static_cast<size_t>(in_h) * in_w * ps;
  const int nct = (a.cout + NT * 8 - 1) / (NT * 8);
  const int b = blockIdx.z / nct, n0 = (blockIdx.z % nct) * NT * 8;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;

  const int cps = a.cseg / 8;                    // 16-byte chunks / segment
  const int cpp = a.nseg * cps;                  // chunks per pixel
  for (int idx = tid; idx < in_h * in_w * cpp; idx += 256) {
    const int pix = idx / cpp, ch = idx - pix * cpp;
    const int seg = ch / cps, cc = (ch - seg * cps) * 8;
    const int r = pix / in_w, c = pix - r * in_w;
    const int iy = iy0 + r, ix = ix0 + c;
    int4 v = make_int4(0, 0, 0, 0);
    if (iy >= 0 && iy < a.h && ix >= 0 && ix < a.w)
      v = *reinterpret_cast<const int4*>(
          a.x[seg] + (static_cast<size_t>(b * a.h + iy) * a.w + ix)
                         * a.ldx[seg] + cc);
    *reinterpret_cast<int4*>(xs + static_cast<size_t>(pix) * ps
                             + (seg * a.cseg + cc) * 2) = v;
  }
  const int kchunks = kk / 8;
  for (int idx = tid; idx < NT * 8 * kchunks; idx += 256) {
    const int n = idx / kchunks, kc = (idx - n * kchunks) * 8;
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + n < a.cout)
      v = *reinterpret_cast<const int4*>(
          a.wt + static_cast<size_t>(n0 + n) * kk + kc);
    *reinterpret_cast<int4*>(wsm + static_cast<size_t>(n) * ws + kc * 2) = v;
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int taps = a.ksize * a.ksize;
  for (int tap = 0; tap < taps; ++tap) {
    const int u = tap / a.ksize, v = tap - u * a.ksize;
    // output pixel (row warp, column g and g + 8) reads staged pixel
    // (warp * stride + u, column * stride + v)
    const unsigned char* p0 =
        xs + (static_cast<size_t>(warp * a.stride + u) * in_w
              + g * a.stride + v) * ps;
    const unsigned char* p1 = p0 + static_cast<size_t>(8 * a.stride) * ps;
    for (int c0 = 0; c0 < cin; c0 += 16) {
      uint32_t af[4];
      const int co = (c0 + t * 2) * 2;
      af[0] = *reinterpret_cast<const uint32_t*>(p0 + co);
      af[1] = *reinterpret_cast<const uint32_t*>(p1 + co);
      af[2] = *reinterpret_cast<const uint32_t*>(p0 + co + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(p1 + co + 16);
      const int kb = (tap * cin + c0 + t * 2) * 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (n0 + nt * 8 >= a.cout) continue;       // warp-uniform
        const unsigned char* br =
            wsm + static_cast<size_t>(nt * 8 + g) * ws + kb;
        mma_bf16(acc[nt], af, *reinterpret_cast<const uint32_t*>(br),
                 *reinterpret_cast<const uint32_t*>(br + 16));
      }
    }
  }

  const int oy = oy0 + warp;
  if (oy >= a.ho) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + t * 2;
    if (col >= a.cout) continue;
    const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = ox0 + g + half * 8;
      if (ox >= a.wo) continue;
      const size_t pix = static_cast<size_t>(b * a.ho + oy) * a.wo + ox;
      __nv_bfloat16 y0 = silu_bf16(acc[nt][half * 2], b0);
      __nv_bfloat16 y1 = silu_bf16(acc[nt][half * 2 + 1], b1);
      if (a.res != nullptr) {
        const __nv_bfloat16* r = a.res + pix * a.ldr + col;
        y0 = __float2bfloat16_rn(__bfloat162float(r[0])
                                 + __bfloat162float(y0));
        y1 = __float2bfloat16_rn(__bfloat162float(r[1])
                                 + __bfloat162float(y1));
      }
      __nv_bfloat162 pair;
      pair.x = y0;
      pair.y = y1;
      *reinterpret_cast<__nv_bfloat162*>(a.out + pix * a.ldo + col) = pair;
    }
  }
}

template <int NT>
int launch_conv_nt(const ConvArgs& a, int batch, cudaStream_t st) {
  const int cin = a.nseg * a.cseg;
  const int kk = a.ksize * a.ksize * cin;
  const int in_w = (kTW - 1) * a.stride + a.ksize;
  const int in_h = (kTH - 1) * a.stride + a.ksize;
  const size_t smem = static_cast<size_t>(in_h) * in_w
                          * (cin * 2 + kPadBytes)
                      + static_cast<size_t>(NT) * 8 * (kk * 2 + kPadBytes);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      conv_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nct = (a.cout + NT * 8 - 1) / (NT * 8);
  dim3 grid((a.wo + kTW - 1) / kTW, (a.ho + kTH - 1) / kTH, batch * nct);
  conv_bf16_kernel<NT><<<grid, 256, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_conv(const ConvArgs& a, int batch, cudaStream_t st) {
  if (a.cout <= 16) return launch_conv_nt<2>(a, batch, st);
  if (a.cout <= 32) return launch_conv_nt<4>(a, batch, st);
  return launch_conv_nt<8>(a, batch, st);
}

ConvArgs conv_args(const __nv_bfloat16* x, int ldx, int cseg, int h, int w,
                   int ksize, int stride, const __nv_bfloat16* wt,
                   const float* bias, int cout, __nv_bfloat16* out,
                   int ldo) {
  ConvArgs a;
  a.x[0] = x;  a.x[1] = nullptr;  a.x[2] = nullptr;
  a.ldx[0] = ldx;  a.ldx[1] = 0;  a.ldx[2] = 0;
  a.nseg = 1;  a.cseg = cseg;
  a.h = h;  a.w = w;
  a.ksize = ksize;  a.stride = stride;  a.pad = ksize / 2;
  a.ho = (h + 2 * a.pad - ksize) / stride + 1;
  a.wo = (w + 2 * a.pad - ksize) / stride + 1;
  a.wt = wt;  a.bias = bias;  a.cout = cout;
  a.res = nullptr;  a.ldr = 0;
  a.out = out;  a.ldo = ldo;
  return a;
}

// the five stages; wprep and bias as `prepare_region` lays them out for
// this form, scratch y and y1 (batch, h/2, w/2, c2), m1 and hh (.., c)
int launch(const void* x, int batch, int h, int w, int c1, int c2,
           const void* wprep, const float* bias, void* scratch, void* out,
           cudaStream_t st) {
  typedef __nv_bfloat16 bf;
  const int c = c2 / 2, ho = h / 2, wo = w / 2;
  const size_t px = static_cast<size_t>(batch) * ho * wo;
  bf* yb = static_cast<bf*>(scratch);
  bf* y1b = yb + px * c2;
  bf* m1b = y1b + px * c2;
  bf* hb = m1b + px * c;
  const bf* w_b1 = static_cast<const bf*>(wprep);
  const bf* w_cv1 = w_b1 + 9 * c1 * c2;
  const bf* w_m1 = w_cv1 + c2 * c2;
  const bf* w_m2 = w_m1 + 9 * c * c;
  const bf* w_cv2 = w_m2 + 9 * c * c;
  const float* b_cv1 = bias + c2;
  const float* b_m1 = b_cv1 + c2;
  const float* b_m2 = b_m1 + c;
  const float* b_cv2 = b_m2 + c;
  // b1: 3x3 stride 2
  int e = launch_conv(conv_args(static_cast<const bf*>(x), c1, c1, h, w, 3,
                                2, w_b1, bias, c2, yb, c2), batch, st);
  if (e) return e;
  // b2.cv1: 1x1, c2 -> 2c
  e = launch_conv(conv_args(yb, c2, c2, ho, wo, 1, 1, w_cv1, b_cv1, c2, y1b,
                            c2), batch, st);
  if (e) return e;
  // bottleneck on the second split half: 3x3, 3x3 + residual
  e = launch_conv(conv_args(y1b + c, c2, c, ho, wo, 3, 1, w_m1, b_m1, c, m1b,
                            c), batch, st);
  if (e) return e;
  ConvArgs a = conv_args(m1b, c, c, ho, wo, 3, 1, w_m2, b_m2, c, hb, c);
  a.res = y1b + c;
  a.ldr = c2;
  e = launch_conv(a, batch, st);
  if (e) return e;
  // b2.cv2: 1x1 over [first half | second half | bottleneck output]
  a = conv_args(y1b, c2, c, ho, wo, 1, 1, w_cv2, b_cv2, c2,
                static_cast<bf*>(out), c2);
  a.nseg = 3;
  a.x[1] = y1b + c;  a.ldx[1] = c2;
  a.x[2] = hb;       a.ldx[2] = c;
  return launch_conv(a, batch, st);
}

}  // namespace wide

}  // namespace

// fast and exact: 65,536 bf16 each, the SiLU of bf16 bit pattern i at i
extern "C" int launch_silu_table(void* fast, void* exact, void* stream) {
  silu_table_kernel<<<128, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(fast), static_cast<uint32_t*>(exact));
  return static_cast<int>(cudaGetLastError());
}

// x (batch, h, w, c1) bf16 NHWC -> out (batch, h/2, w/2, c2) bf16.  wprep:
// the five stages' weights in `prepare_region`'s layout for (c1, c2)
// (bf16), bias their biases (f32), both 16-byte aligned; h and w even.
// (c1, c2) = (32, 64) (YOLOv8-s) or (16, 32) (YOLOv8-n) runs the fused
// kernel, scratch unused; any other pair with c1 and c2 / 2 multiples of
// 16 the five-launch form, with scratch for 3 x c2 channels of bf16 at
// every output pixel.
extern "C" int launch_fused_b1b2(const void* x, int batch, int h, int w,
                                 int c1, int c2, const void* wprep,
                                 const float* bias, void* scratch, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h % 2 || w % 2 || h < 2 || w < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  if (c1 == 32 && c2 == 64)
    return launch_region<32, 64>(x, batch, h, w, wprep, bias, out, st);
  if (c1 == 16 && c2 == 32)
    return launch_region<16, 32>(x, batch, h, w, wprep, bias, out, st);
  if (c1 % 16 || (c2 / 2) % 16 || c2 % 2 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide::launch(x, batch, h, w, c1, c2, wprep, bias, scratch, out, st);
}
