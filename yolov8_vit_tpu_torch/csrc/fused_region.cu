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
// once, 74 KB of weights) are 315 MB, 94 us at 3.35 TB/s: bound by bytes.
//
// Design: one implicit-GEMM convolution kernel, launched five times on one
// stream (3x3 s2; 1x1; 3x3; 3x3 + residual; 1x1 over the three concat
// parts read from their own pointers, no concat buffer), with the four
// intermediates in device memory.  A block computes 8 x 16 output pixels
// for up to 64 output channels: it stages the input tile with its halo
// (zero outside the image) and the weights in shared memory with 16
// padding bytes per pixel / per weight row, so the mma.sync.m16n8k16
// fragment loads meet no bank conflict at stride 1; each of its 8 warps
// owns one output row of 16 pixels.  The epilogue is `_silu_bf16`: f32 sum
// + f32 bias, one rounding to bf16, the logistic in f32 rounded to bf16,
// their bf16 product; the residual is a bf16 add.  Keeping the b1 tile
// resident across the five stages (one launch, no intermediate traffic,
// which is what the byte bound assumes) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

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
  const __nv_bfloat16 s =
      __float2bfloat16_rn(__fdiv_rn(1.f, 1.f + expf(-yf)));
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
  if (batch == 0) return 0;
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

}  // namespace

// x (batch, h, w, c1) bf16 NHWC -> out (batch, h/2, w/2, c2); c = c2 / 2.
// Weights transposed to (out channels, taps * in channels) bf16, biases
// f32.  Scratch in bf16: y and y1 (batch, h/2, w/2, c2), m1 and hh
// (batch, h/2, w/2, c).  c1 and c multiples of 16.
extern "C" int launch_fused_b1b2(
    const void* x, int batch, int h, int w, int c1, int c2,
    const void* w_b1, const float* b_b1, const void* w_cv1,
    const float* b_cv1, const void* w_m1, const float* b_m1,
    const void* w_m2, const float* b_m2, const void* w_cv2,
    const float* b_cv2, void* y, void* y1, void* m1, void* hh, void* out,
    void* stream) {
  typedef __nv_bfloat16 bf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = c2 / 2;
  if (c1 % 16 || c % 16 || h % 2 || w % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = h / 2, wo = w / 2;
  bf* yb = static_cast<bf*>(y);
  bf* y1b = static_cast<bf*>(y1);
  bf* m1b = static_cast<bf*>(m1);
  bf* hb = static_cast<bf*>(hh);
  // b1: 3x3 stride 2
  int e = launch_conv(conv_args(static_cast<const bf*>(x), c1, c1, h, w, 3,
                                2, static_cast<const bf*>(w_b1), b_b1, c2,
                                yb, c2), batch, st);
  if (e) return e;
  // b2.cv1: 1x1, c2 -> 2c
  e = launch_conv(conv_args(yb, c2, c2, ho, wo, 1, 1,
                            static_cast<const bf*>(w_cv1), b_cv1, c2, y1b,
                            c2), batch, st);
  if (e) return e;
  // bottleneck on the second split half: 3x3, 3x3 + residual
  e = launch_conv(conv_args(y1b + c, c2, c, ho, wo, 3, 1,
                            static_cast<const bf*>(w_m1), b_m1, c, m1b, c),
                  batch, st);
  if (e) return e;
  ConvArgs a = conv_args(m1b, c, c, ho, wo, 3, 1,
                         static_cast<const bf*>(w_m2), b_m2, c, hb, c);
  a.res = y1b + c;
  a.ldr = c2;
  e = launch_conv(a, batch, st);
  if (e) return e;
  // b2.cv2: 1x1 over [first half | second half | bottleneck output]
  a = conv_args(y1b, c2, c, ho, wo, 1, 1, static_cast<const bf*>(w_cv2),
                b_cv2, c2, static_cast<bf*>(out), c2);
  a.nseg = 3;
  a.x[1] = y1b + c;  a.ldx[1] = c2;
  a.x[2] = hb;       a.ldx[2] = c;
  return launch_conv(a, batch, st);
}
