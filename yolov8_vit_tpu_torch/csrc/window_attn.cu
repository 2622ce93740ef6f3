// mt::window_attn: SwinV2's shifted-window cosine attention, from the qkv
// GEMM's output to the input of proj, in one launch a block:
//
//   x' = roll(qkv, (-s, -s)) partitioned into ws x ws windows of N tokens
//   logits = (q / |q|)(k / |k|)^T * exp(min(logit_scale_h, ln 100))
//            + table_h[idx(q, k)] + mask(q, k)
//   o = softmax(logits) v, the partition and the roll reversed
//
// with table = 16 sigmoid(cpb(coords)) over the (2 ws - 1)^2 relative
// offsets (made once at load), idx V1's relative position index, and mask
// -100 between tokens of different shifted regions (timm's construction
// over the last window row and column of a shifted block), 0 elsewhere.
// It replaces no TPU kernel: the JAX package has no Swin.  Head dim 32
// (every SwinV2 width), windows 8 and 16 (N = 64 and 256).
//
// Bound on the H100, SwinV2-B at 256 for 64 crops, one block of stage 1
// (64 x 16 windows x 4 heads): the products 4 x 262,144 rows x 256 keys x
// 128 = 34 GFLOP (35 us at 989 TFLOP/s); q, k, v and o 268 MB of bf16 (80
// us at 3.35 TB/s): bytes.  268 M exponentials on 16 lanes an SM: about
// 70 us, near the bytes.
//
// Design (sm_90a, on the SDPA core's building blocks in sdpa.cuh): a CTA
// holds one (window, head) and 128 of its query rows (64 at window 8), one
// warpgroup each 64 rows.  Its threads gather the window's K and V with
// 16-byte loads, the roll folded into the addressing (token (r, c) of
// window (wr, wc) reads grid pixel ((wr ws + r + s) mod H, (wc ws + c + s)
// mod W), and its output goes to the same pixel, which is where the
// reverse roll puts it), normalise each k in f32, and store K and V
// whole in shared memory in the 64-byte-swizzled layout TMA would leave
// (KvTile<32>), so the core's `scores_bf16` (wgmma m64n64k16, Q in
// registers) and its P.V wgmma read them as they read the core's tiles.
// TMA cannot do this gather: a window's rows wrap around the grid.  q is
// normalised in registers across each quad of lanes.  One pass of online
// softmax over the 64-key tiles (K and V of a window fit: 32 KB at N =
// 256), the scale applied to the f32 scores; the bias is read from this
// head's table (3.8 KB) in shared memory, its index and the region mask
// worked out from the token coordinates, so nothing (heads, N, N) is read.
#include "sdpa.cuh"

namespace {

constexpr int kHd = 32;
using WinTile = KvTile<kHd>;

struct WinArgs {
  const __nv_bfloat16* qkv;  // (b, h, w, 3c): q | k | v, heads of 32
  const float* table;        // (heads, (2 ws - 1)^2)
  const float* scale;        // (heads,)
  __nv_bfloat16* out;        // (b, h, w, c)
  int h, w, c, shift;
};

template <int WS>
struct WinShape {
  static constexpr int kN = WS * WS;                  // tokens a window
  static constexpr int kTiles = kN / kKeyTile;        // key tiles of 64
  static constexpr int kGroups = kTiles < 2 ? kTiles : 2;   // a CTA
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kSplit = kTiles / kGroups;     // CTAs a window-head
  static constexpr int kTw = 2 * WS - 1;
  static constexpr size_t kSmem =
      1024 + 2 * kTiles * WinTile::kBytes + 4 * kTw * kTw;
  static_assert(kN % kKeyTile == 0, "windows of a multiple of 64 tokens");
};

__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <int WS>
__global__ void __launch_bounds__(WinShape<WS>::kThreads)
window_attn_kernel(WinArgs a) {
  using S = WinShape<WS>;
  using L = WinTile;
  extern __shared__ uint8_t win_smem[];
  uint8_t* ks = align_1024(win_smem);
  uint8_t* vs = ks + S::kTiles * L::kBytes;
  float* tab = reinterpret_cast<float*>(vs + S::kTiles * L::kBytes);
  const int win = blockIdx.x / S::kSplit, part = blockIdx.x % S::kSplit;
  const int head = blockIdx.y, img = blockIdx.z;
  const int nwr = a.h / WS, nwc = a.w / WS;
  const int wr = win / nwc, wc = win % nwc;
  const size_t c3 = 3 * static_cast<size_t>(a.c);

  // the grid pixel of token t of this window (the roll folded in)
  auto pixel = [&](int t) -> size_t {
    int r = wr * WS + t / WS + a.shift, col = wc * WS + t % WS + a.shift;
    if (r >= a.h) r -= a.h;
    if (col >= a.w) col -= a.w;
    return (static_cast<size_t>(img) * a.h + r) * a.w + col;
  };

  // K (normalised) and V of the whole window, swizzled as TMA leaves them
  for (int i = threadIdx.x; i < 2 * S::kN; i += S::kThreads) {
    const bool is_v = i >= S::kN;
    const int t = is_v ? i - S::kN : i;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.qkv + pixel(t) * c3 + (is_v ? 2 : 1) * a.c + head * kHd);
    uint4 ch[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ch[j] = src[j];
    if (!is_v) {
      uint32_t* u = reinterpret_cast<uint32_t*>(ch);
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float x0 = lo_bf16(u[j]), x1 = hi_bf16(u[j]);
        ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)));
      }
      const float nrm = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        u[j] = pack_bf16(lo_bf16(u[j]) / nrm, hi_bf16(u[j]) / nrm);
    }
    const int row = t & (kKeyTile - 1);
    uint8_t* dst = (is_v ? vs : ks) + (t / kKeyTile) * L::kBytes
                   + row * L::kRowBytes;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(dst + ((j ^ ((row >> 1) & 3)) << 4)) = ch[j];
  }
  for (int i = threadIdx.x; i < S::kTw * S::kTw; i += S::kThreads)
    tab[i] = a.table[static_cast<size_t>(head) * S::kTw * S::kTw + i];
  fence_proxy_async();        // the thread stores, visible to wgmma
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = (part * S::kGroups + (warp >> 2)) * 64 + (warp & 3) * 16 + g;
  int qr[2], qc[2];
  size_t qpix[2];
  uint32_t qf[kHd / 16][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    qr[rr] = row / WS;
    qc[rr] = row % WS;
    qpix[rr] = pixel(row);
    const __nv_bfloat16* q = a.qkv + qpix[rr] * c3 + head * kHd;
    float x[kHd / 16][2][2];
    float ss = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            q + kk * 16 + half * 8 + 2 * tq);
        x[kk][half][0] = lo_bf16(v);
        x[kk][half][1] = hi_bf16(v);
        ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x[kk][half][0], x[kk][half][0]),
                                     __fmul_rn(x[kk][half][1], x[kk][half][1])));
      }
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 1));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, 2));
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        qf[kk][half * 2 + rr] =
            pack_bf16(x[kk][half][0] / nrm, x[kk][half][1] / nrm);
  }

  const float sc = a.scale[head];
  const int edge = WS - a.shift;
  const bool mrow = a.shift > 0 && wr == nwr - 1;
  const bool mcol = a.shift > 0 && wc == nwc - 1;
  float s[8][4], o[kHd / 8][4];
#pragma unroll
  for (int nb = 0; nb < kHd / 8; ++nb)
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < S::kTiles; ++i) {
    scores_bf16<kHd>(s, qf, ks + i * L::kBytes, i * kKeyTile, S::kN);
    // logits, in log2 units
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int key = i * kKeyTile + j * 8 + 2 * tq + (e & 1);
        const int kr = key / WS, kc = key % WS;
        float t = __fadd_rn(__fmul_rn(s[j][e], sc),
                            tab[(qr[rr] - kr + WS - 1) * S::kTw
                                + qc[rr] - kc + WS - 1]);
        if ((mrow && ((qr[rr] >= edge) != (kr >= edge)))
            || (mcol && ((qc[rr] >= edge) != (kc >= edge))))
          t = __fadd_rn(t, -100.f);
        s[j][e] = __fmul_rn(t, kLog2e);
      }
    uint32_t pf[4][4];
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
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[j][e] = ex2_approx(__fsub_rn(s[j][e], mn));
          sum = __fadd_rn(sum, s[j][e]);
        }
      if (i > 0) {
        const float corr = ex2_approx(__fsub_rn(m[rr], mn));
        l[rr] = __fadd_rn(__fmul_rn(l[rr], corr), sum);
#pragma unroll
        for (int nb = 0; nb < kHd / 8; ++nb) {
          o[nb][2 * rr] = __fmul_rn(o[nb][2 * rr], corr);
          o[nb][2 * rr + 1] = __fmul_rn(o[nb][2 * rr + 1], corr);
        }
      } else {
        l[rr] = sum;
      }
      m[rr] = mn;
    }
    // P's A fragments, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          pf[kk][half * 2 + rr] = pack_bf16(s[2 * kk + half][2 * rr],
                                            s[2 * kk + half][2 * rr + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kHd, 1>(&o[0][0], pf[kk],
                       gmma_desc(vs + i * L::kBytes + kk * 16 * L::kRowBytes,
                                 L::kAtoms, L::kGroup, L::kLayout),
                       1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kHd / 2>(&o[0][0]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float tot = l[rr];
    tot = __fadd_rn(tot, __shfl_xor_sync(0xffffffffu, tot, 1));
    tot = __fadd_rn(tot, __shfl_xor_sync(0xffffffffu, tot, 2));
    const float rl = __frcp_rn(tot);
    __nv_bfloat16* orow = a.out + qpix[rr] * a.c + head * kHd;
#pragma unroll
    for (int nb = 0; nb < kHd / 8; ++nb)
      *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * tq) =
          pack_bf16(__fmul_rn(o[nb][2 * rr], rl),
                    __fmul_rn(o[nb][2 * rr + 1], rl));
  }
}

template <int WS>
int launch_ws(const WinArgs& a, int b, int heads, cudaStream_t st) {
  using S = WinShape<WS>;
  if (a.h % WS || a.w % WS) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((a.h / WS) * (a.w / WS) * S::kSplit, heads, b);
  window_attn_kernel<WS><<<grid, S::kThreads, S::kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (b, h, w, 3c) bf16, table (heads, (2 ws - 1)^2) f32, scale (heads,)
// f32 -> out (b, h, w, c) bf16; c = 32 heads, ws 8 or 16, 0 <= shift < ws.
extern "C" int launch_window_attn(const void* qkv, const void* table,
                                  const void* scale, void* out, int b, int h,
                                  int w, int c, int heads, int ws, int shift,
                                  void* stream) {
  if (c != heads * kHd || shift < 0 || shift >= ws || b < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  WinArgs a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.table = static_cast<const float*>(table);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.h = h;
  a.w = w;
  a.c = c;
  a.shift = shift;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == 8) return launch_ws<8>(a, b, heads, st);
  if (ws == 16) return launch_ws<16>(a, b, heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
