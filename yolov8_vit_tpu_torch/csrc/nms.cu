// Greedy NMS kernels for Hopper (sm_90a): kernels A, B and I of the port,
// three forms of one ordered scan (greedy_nms_kernel<form>).
//
// A  greedy_nms_kernel<0> replaces yolov8_vit_tpu/ops/nms.py
//    `_nms_argmax_kernel_ml` (stage-1 EfficientNMS, multi-label,
//    class-aware): candidates are (class, anchor) pairs; each iteration of
//    the TPU kernel picks the highest live score (ties to the lowest flat
//    index class * n + anchor), kills every anchor of the picked class whose
//    IoU with the picked box is above the threshold and the picked entry
//    itself, and stops at max_output picks or when no live score is above
//    score_threshold.  Output rows in pick order, zero / -1 padded.
// B  greedy_nms_kernel<1> replaces `_mask_scan_kernel` (stage-2
//    area-sorted NMS): rows that are valid with score > score_threshold
//    compete by box area, descending, ties to the lowest row; suppression
//    is class-agnostic; the output is a keep mask in row order.  The
//    kernel computes each row's priority itself (valid, score > threshold,
//    area as ops/boxes.py box_area), or reads it where the wrapper made it.
// I  greedy_nms_kernel<2> replaces `_nms_argmax_kernel` (stage-1
//    EfficientNMS, single-label: one candidate per anchor, its best class,
//    and the class-band side, all taken in the kernel's compaction as the
//    plain version's `single_label_candidates` takes them): keys
//    (score desc, anchor asc), which is the TPU kernel's tie-break (the
//    lowest flat index among equal maxima).  Classes are kept apart as the
//    TPU kernel keeps them, by shifting each box by label * side before
//    the IoU, in the same f32 operations: the shifted coordinates round,
//    so a class-equality mask would decide pairs near the threshold
//    differently, and every pair is tested (over_thr_i).  Output rows carry
//    the boxes as given.
//
// Why an ordered scan computes what the argmax loop computes.
// A pick only kills entries; it never changes a live score.  So the next
// pick is always the first live entry in the order (score desc, flat index
// asc), and the loop is the greedy scan of that order: keep a candidate
// unless an earlier kept candidate of its class (any class for B and I)
// overlaps it above the threshold.  An entry at or below score_threshold
// is never picked, and a killed entry (held at -1 for A and I, -1e9 for B)
// is never live again while score_threshold >= -1 (the wrappers refuse
// lower ones), so only the entries above the threshold need ordering.  The
// pair decision is the TPU kernel's own, IoU(later, earlier) = inter /
// max(area + c_area - inter, 1e-9) in iou_of's operation order, IEEE
// division, strict `>`, built with -fmad=false (_build.py), with `area`
// the later candidate's and c_area the earlier (picked) one's, as the TPU
// kernel takes them when the earlier is picked.  For A and B, min / max
// are symmetric and IEEE addition commutes, so IoU(i, j) is bitwise IoU(j,
// i).  For I it is not: the later candidate's area is taken on its shifted
// coordinates and the earlier one's on the coordinates as given.  Every
// test here (the kept set against a candidate, the pairwise mask of a
// chunk) is built in the (later, earlier) direction, which is the only
// one the argmax loop ever evaluates, so a pairwise over-threshold mask
// decides exactly what the per-pick IoU pass decides for all three forms.
// A NaN score (or priority) makes the TPU kernel's first max NaN, and it
// keeps nothing; these kernels do the same.
//
// Bounds on the H100 (132 SMs, 3.35 TB/s).  A at (32, 8400) anchors x 5
// classes: 9.7 MB of boxes and scores, about 3 us of bytes; the picks are
// dependent, so each image's kept set is a chain of up to 100 decisions,
// and what the design can shorten is the work around each decision.  B
// at (32, 100) rows: 64 KB, launch-latency bound.  I at (32, 8400)
// anchors x 5 classes: the same 9.7 MB as A, about 3 us of bytes.
//
// Design (one CTA per image decides; the TPU kernel's argmax over the
// whole pool per pick, with its block barriers, is gone):
//  1. Compact.  Read the image's scores once (A, I: a cluster of 4 CTAs an
//     image, a share each, appending through distributed shared memory to
//     the first CTA's count and window; the others then exit); every
//     entry above the threshold becomes a 64-bit key: the score's
//     order-preserving bits, inverted, above its flat index, so that
//     ascending keys are (score desc, flat asc) and the keys are unique.
//     Keys go to a global pool (the wrapper's scratch, n * c a row) and,
//     while they fit, straight into the shared-memory window.
//  2. Window.  When more unprocessed keys than the window holds are above
//     the threshold, an MSD radix select (8-bit digits, one histogram pass
//     over the pool a digit) finds a key bound below which at most a
//     window's worth of them lie, and those are gathered; otherwise the
//     window holds every unprocessed key.  A bitonic sort orders the
//     window in shared memory (strides below 32 by warp shuffles).
//     Windows grow from 256 keys to W, 2x a window.  Where a window kept
//     under a quarter of its keys, one pass drops every unprocessed key
//     that a kept box of its class overlaps above the threshold before
//     the next.  This path bounds nothing: any n * c is taken.
//  3. Chunks of sorted candidates, 64 growing 2x to CH: their boxes go to
//     shared memory; in parallel, each candidate is tested against the
//     boxes kept so far (the first 1,024 in shared memory, the rest in the
//     output rows for A and I, a scratch list for B), and the within-chunk
//     over-threshold bits of each pair (later, earlier; of one class for
//     A) are
//     set, one warp a 32-candidate word, lanes a bit, by ballot.
//  4. One warp decides the chunk in order: lane w holds the removed bits of
//     word w; the next live candidate is a find-first-set; a kept
//     candidate's row is ORed in by every lane (its 32 words, coalesced)
//     and its index noted; the block writes the kept rows after, and a
//     barrier ends the chunk (its slots are the next chunk's).  No
//     block barrier per candidate, no global memory in the serial part:
//     its floor is the dependent chain find-first-set -> row load ->
//     shuffle, once a candidate kept.  It stops at max_output, or the
//     next chunk (or window) follows.
// Tie-breaks and arithmetic follow the TPU kernels exactly; the library is
// built with -fmad=false so no multiply-add is contracted, and `/` is IEEE
// division (no fast math).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

namespace cg = cooperative_groups;

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

using u64 = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kKilledB = -1e9f;
// the largest window and chunk a launch may ask for (shared memory:
// nms_layout, 8 W + 28 CH + CH^2 / 8 bytes + 21 KB)
constexpr int kMaxWindow = 4096, kMaxChunk = 1024;
// the kept boxes (and A's and I's labels) held in shared memory, besides
// the output rows, for the tests against the kept set; past it they are
// read from the output rows
constexpr int kKeptSmem = 1024;
// kernel A's and I's CTAs an image (a thread-block cluster: all read the
// scores, the first goes on alone); its score loads in flight a lane; the
// first window's and the first chunk's sizes (later ones grow 2x, to the
// launch's W and CH)
constexpr int kClusterA = 4;
constexpr int kLoads = 16, kFirstWindow = 256, kFirstChunk = 64;
// the kernel's three forms (greedy_nms_kernel's template argument)
constexpr int kFormA = 0, kFormB = 1, kFormI = 2;

__device__ __forceinline__ float iou_of(float x1, float y1, float x2, float y2,
                                        float cx1, float cy1, float cx2,
                                        float cy2, float c_area) {
  float area = fmaxf(x2 - x1, 0.f) * fmaxf(y2 - y1, 0.f);
  float iw = fmaxf(fminf(x2, cx2) - fmaxf(x1, cx1), 0.f);
  float ih = fmaxf(fminf(y2, cy2) - fmaxf(y1, cy1), 0.f);
  float inter = iw * ih;
  return __fdiv_rn(inter, fmaxf(area + c_area - inter, 1e-9f));
}

// iou_of(x, c) > thr, x the later candidate and c the earlier one, as the
// TPU kernel computes it when c is picked.  Where the boxes do not overlap
// the quotient is +-0, and 0 > thr is decided without the division.
__device__ __forceinline__ bool over_thr(const float4 x, const float4 c,
                                         float thr) {
  const float iw = fmaxf(fminf(x.z, c.z) - fmaxf(x.x, c.x), 0.f);
  const float ih = fmaxf(fminf(x.w, c.w) - fmaxf(x.y, c.y), 0.f);
  if (iw * ih == 0.f) return 0.f > thr;
  const float c_area = fmaxf(c.z - c.x, 0.f) * fmaxf(c.w - c.y, 0.f);
  return iou_of(x.x, x.y, x.z, x.w, c.x, c.y, c.z, c.w, c_area) > thr;
}

// Kernel I's pair decision, iou(x, c) > thr with x the later candidate
// (label lx) and c the earlier kept one (label lc), in the TPU kernel's
// operations: both boxes shifted by label * side, the intersection and
// the later box's area on the shifted coordinates, the earlier box's
// area on its coordinates as given.  The shifted coordinates round, so
// this is not iou(c, x): the pair is only ever decided in this direction.
__device__ __forceinline__ bool over_thr_i(const float4 x, int lx,
                                           const float4 c, int lc,
                                           float side, float thr) {
  const float xo = __int2float_rn(lx) * side, co = __int2float_rn(lc) * side;
  const float x1 = x.x + xo, y1 = x.y + xo, x2 = x.z + xo, y2 = x.w + xo;
  const float cx1 = c.x + co, cy1 = c.y + co, cx2 = c.z + co,
              cy2 = c.w + co;
  const float iw = fmaxf(fminf(x2, cx2) - fmaxf(x1, cx1), 0.f);
  const float ih = fmaxf(fminf(y2, cy2) - fmaxf(y1, cy1), 0.f);
  if (iw * ih == 0.f) return 0.f > thr;
  const float c_area = fmaxf(c.z - c.x, 0.f) * fmaxf(c.w - c.y, 0.f);
  return iou_of(x1, y1, x2, y2, cx1, cy1, cx2, cy2, c_area) > thr;
}

// The score half of a candidate key: ascending keys are descending scores.
// -0 and +0 compare equal, so both take the key of +0.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

// I's candidate of an anchor: its best class score and the first class
// that has it (torch.max's over the classes; a NaN anywhere makes the
// image keep nothing, through the kernel's NaN flag, as the TPU kernel's
// NaN max does)
__device__ __forceinline__ float best_class(const float* row, int c,
                                            int& lab, bool& nan) {
  float best = row[0];
  lab = 0;
  nan = best != best;
  for (int k = 1; k < c; ++k) {
    const float v = row[k];
    nan |= v != v;
    if (v > best) {
      best = v;
      lab = k;
    }
  }
  return best;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

struct NmsArgs {
  const float* boxes;     // (B, n, 4) xyxy
  const float* scores;    // A: (B, n, c); B: (B, n) or null
  const uint8_t* valid;   // B: (B, n) 0/1, with scores; null for A
  const float* pri;       // B: (B, n) priorities made by the wrapper, or null
  int n, c;               // anchors (rows) and classes (1 for B)
  float iou_thr, score_thr;
  int max_out;            // A: output rows; B: n
  int window, chunk;      // powers of two, <= kMaxWindow, kMaxChunk
  u64* pool;              // (B, n * c) keys, scratch
  int* num_dets;          // A: (B,)
  float* out_boxes;       // A: (B, max_out, 4); B: (B, n, 4) kept boxes
  float* out_scores;      // A: (B, max_out)
  int* out_labels;        // A: (B, max_out)
  uint8_t* keep;          // B: (B, n)
};

// The bound `cut` of a window: 1 <= #{keys in [lo, cut)} <= cap, where more
// than cap keys are >= lo.  MSD radix select on 8-bit digits: in the
// bucket of keys sharing the digits fixed so far (all of them >= lo, and
// none below it left), the largest digit d whose keys up to d number at
// most cap gives the cut at d + 1 when that count is not 0; otherwise the
// first digit's bucket alone holds more than cap keys, and the select
// descends into it.  Keys are unique, so the last digit always cuts.
__device__ u64 select_cut(const u64* __restrict__ pool, int total, u64 lo,
                          unsigned cap, unsigned* hist, u64* s_word,
                          int* s_flag) {
  const int tid = threadIdx.x, bs = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  u64 prefix = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    const u64 hi_mask = shift == 56 ? 0ull : (~0ull << (shift + 8));
    for (int i = tid; i < 256; i += bs) hist[i] = 0;
    __syncthreads();
    // one atomic a digit a warp: tied scores put whole windows in a bin
    for (int i0 = warp * 32; i0 < total; i0 += bs) {
      const int i = i0 + lane;
      int digit = -1;
      if (i < total) {
        const u64 k = pool[i];
        if (k >= lo && k != ~0ull && (k & hi_mask) == prefix)
          digit = static_cast<int>((k >> shift) & 255);
      }
      const unsigned same = __match_any_sync(kFull, digit);
      if (digit >= 0 && lane == __ffs(same) - 1)
        atomicAdd(&hist[digit], static_cast<unsigned>(__popc(same)));
    }
    __syncthreads();
    if (warp == 0) {
      unsigned v[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) { v[j] = hist[8 * lane + j]; sum += v[j]; }
      unsigned incl = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      unsigned cum = incl - sum;
      int best = -1;
      unsigned best_cum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cum += v[j];
        if (cum <= cap) { best = 8 * lane + j; best_cum = cum; }
      }
      // counts only grow with the digit: the largest lane's best is the d
      for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(kFull, best, off);
        const unsigned oc = __shfl_xor_sync(kFull, best_cum, off);
        if (ob > best) { best = ob; best_cum = oc; }
      }
      if (lane == 0) {
        const u64 next = static_cast<u64>(best + 1) << shift;
        if (best >= 0 && best_cum > 0) {
          *s_flag = 1;
          *s_word = prefix | next;
        } else {
          *s_flag = 0;
          *s_word = prefix | next;     // the first bucket, too large
        }
      }
    }
    __syncthreads();
    const int done = *s_flag;
    const u64 word = *s_word;
    __syncthreads();
    if (done) return word;
    prefix = word;
  }
  return ~0ull;   // not reached: unique keys cut at the last digit
}

// Append `key` where `take`, warp-aggregated: one shared atomic a warp.
// Every lane of the warp must call it.
__device__ __forceinline__ int warp_append(bool take, int* counter) {
  const unsigned bal = __ballot_sync(kFull, take);
  if (bal == 0u) return -1;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(counter, __popc(bal));
  base = __shfl_sync(kFull, base, 0);
  return take ? base + __popc(bal & lanemask_lt()) : -1;
}

// Byte offsets of kernel A's and B's shared-memory arrays for a window W
// and a chunk CH (a multiple of 32), each 16-byte aligned: the chunk's
// boxes, the window's keys, the chunk's scores and tags, its removed
// bits, its CH x CH / 32 mask words, the select's 256-bin histogram, the
// chunk's kept indices, and the first kKeptSmem kept boxes and labels.
struct NmsSmem {
  size_t box, win, score, tag, rem, mask, hist, list, sbox, slabel, total;
};

__host__ __device__ inline NmsSmem nms_layout(int W, int CH) {
  auto up = [](size_t v) { return (v + 15) & ~static_cast<size_t>(15); };
  NmsSmem L;
  L.box = 0;
  L.win = up(L.box + 16ull * CH);
  L.score = up(L.win + 8ull * W);
  L.tag = up(L.score + 4ull * CH);
  L.rem = up(L.tag + 4ull * CH);
  L.mask = up(L.rem + 4ull * (CH / 32));
  L.hist = up(L.mask + 4ull * CH * (CH / 32));
  L.list = up(L.hist + 4ull * 256);
  L.sbox = up(L.list + 4ull * CH);
  L.slabel = up(L.sbox + 16ull * kKeptSmem);
  L.total = up(L.slabel + 4ull * kKeptSmem);
  return L;
}

// Whether candidate box q (class cls) is suppressed by kept box k: the
// kept set from shared memory, past kKeptSmem from the output rows.
template <int kForm>
__device__ __forceinline__ bool kept_over(const float4 q, int cls, int k,
                                          const float4* sbox,
                                          const int* slabel,
                                          const float4* kbox,
                                          const int* klabel, float side,
                                          float thr) {
  const bool near = k < kKeptSmem;
  const int kcls = near ? slabel[k] : klabel[k];
  const float4 kb = near ? sbox[k] : kbox[k];
  if constexpr (kForm == kFormI) return over_thr_i(q, cls, kb, kcls, side,
                                                   thr);
  if (kForm == kFormA && kcls != cls) return false;
  return over_thr(q, kb, thr);
}

template <int kForm>
__global__ void __launch_bounds__(1024)
greedy_nms_kernel(const NmsArgs p) {
  constexpr bool kB = kForm == kFormB, kI = kForm == kFormI;
  extern __shared__ __align__(16) unsigned char nms_smem[];
  const int W = p.window, CH = p.chunk;
  const NmsSmem L = nms_layout(W, CH);
  float4* cbox = reinterpret_cast<float4*>(nms_smem + L.box);     // CH
  u64* win = reinterpret_cast<u64*>(nms_smem + L.win);            // W
  float* cscore = reinterpret_cast<float*>(nms_smem + L.score);   // CH
  int* ctag = reinterpret_cast<int*>(nms_smem + L.tag);  // CH: A class, B row
  unsigned* crem = reinterpret_cast<unsigned*>(nms_smem + L.rem);  // CH / 32
  unsigned* cmask = reinterpret_cast<unsigned*>(nms_smem + L.mask);
  unsigned* hist = reinterpret_cast<unsigned*>(nms_smem + L.hist);  // 256
  int* klist = reinterpret_cast<int*>(nms_smem + L.list);  // a chunk's kept
  float4* sbox = reinterpret_cast<float4*>(nms_smem + L.sbox);  // kKeptSmem
  int* slabel = reinterpret_cast<int*>(nms_smem + L.slabel);    // kKeptSmem
  __shared__ int s_cnt, s_nan, s_kept, s_flag;
  __shared__ unsigned s_side;     // I: the bits of max |box coordinate|
  __shared__ u64 s_word;

  const int tid = threadIdx.x, bs = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = bs >> 5;
  // A: a cluster of CTAs an image (rank 0 decides); B: one CTA an image
  const int crank = kB ? 0 : static_cast<int>(cg::this_cluster()
                                                  .block_rank());
  const int csize = kB ? 1 : static_cast<int>(cg::this_cluster()
                                                  .num_blocks());
  const int b = blockIdx.x / csize, n = p.n, c = kB ? 1 : p.c;
  const float4* bx =
      reinterpret_cast<const float4*>(p.boxes) + static_cast<size_t>(b) * n;
  const float* sc = p.scores == nullptr
                        ? nullptr
                        : p.scores + static_cast<size_t>(b) * n * c;
  u64* pool = p.pool + static_cast<size_t>(b) * n * (kI ? 1 : c);
  // the kept list: A's output rows, B's scratch (class-agnostic)
  const int kcap = kB ? n : p.max_out;
  float4* kbox = reinterpret_cast<float4*>(p.out_boxes)
                 + static_cast<size_t>(b) * kcap;
  float* kscore = kB ? nullptr : p.out_scores + static_cast<size_t>(b) * kcap;
  int* klabel = kB ? nullptr : p.out_labels + static_cast<size_t>(b) * kcap;
  uint8_t* keep = kB ? p.keep + static_cast<size_t>(b) * n : nullptr;
  const float thr = kB ? kKilledB / 2.f : p.score_thr;

  if (tid == 0 && crank == 0) {
    s_cnt = 0;
    s_nan = 0;
    s_kept = 0;
    s_side = 0;
  }
  if (kB)
    for (int i = tid; i < n; i += bs) keep[i] = 0;
  // the count, NaN flag and window of the cluster's first CTA (A)
  int* cnt0 = &s_cnt;
  int* nan0 = &s_nan;
  u64* win0 = win;
  unsigned* side0 = &s_side;
  if constexpr (kB) {
    __syncthreads();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // the first CTA's counters, before any CTA appends
    cnt0 = cluster.map_shared_rank(&s_cnt, 0);
    nan0 = cluster.map_shared_rank(&s_nan, 0);
    win0 = cluster.map_shared_rank(win, 0);
    side0 = cluster.map_shared_rank(&s_side, 0);
  }

  // ---- 1. compact: every entry above the threshold becomes a key --------
  // A's CTAs read a share of the scores each, as one flat stream, kLoads
  // loads in flight a lane before any is appended (one dependent load a
  // step would leave the loop bound by memory latency); only a
  // candidate's flat position is split into (anchor, class).
  if (kForm == kFormA) {
    const int total_in = n * c;
    const int share = ((total_in + csize - 1) / csize + 32 * kLoads - 1)
                      / (32 * kLoads) * (32 * kLoads);
    const int r0 = crank * share, r1 = min(total_in, r0 + share);
    for (int p0 = r0 + warp * 32 * kLoads; p0 < r1; p0 += bs * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int q = p0 + 32 * j + lane;
        v[j] = q < r1 ? sc[q] : -INFINITY;
      }
      // one atomic a warp for its kLoads x 32 entries
      unsigned bal[kLoads];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        if (v[j] != v[j]) *nan0 = 1;
        bal[j] = __ballot_sync(kFull, v[j] > thr);
        cnt += __popc(bal[j]);
      }
      if (cnt == 0) continue;
      int pos = 0;
      if (lane == 0) pos = atomicAdd(cnt0, cnt);
      pos = __shfl_sync(kFull, pos, 0);
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        if ((bal[j] >> lane) & 1u) {
          const int q = p0 + 32 * j + lane, a = q / c, k = q - a * c;
          const int at = pos + __popc(bal[j] & lanemask_lt());
          const u64 key = (static_cast<u64>(score_key(v[j])) << 32)
                          | static_cast<unsigned>(k * n + a);
          pool[at] = key;
          if (at < W) win0[at] = key;
        }
        pos += __popc(bal[j]);
      }
    }
  } else if (kI) {
    // I's CTAs read a share of the anchors each: an anchor's best class
    // (its c scores), and the largest |coordinate| of its box, for the
    // class-band side = 2 (max |boxes| + 1) that the wrapper's plain
    // version takes (as non-negative floats, their bits order as the
    // values, and a NaN's above every number, so a NaN coordinate makes
    // the side NaN, as torch's amax does)
    const int share = ((n + csize - 1) / csize + 31) / 32 * 32;
    const int a_lo = crank * share, a_hi = min(n, a_lo + share);
    unsigned bmax = 0;
    for (int a0 = a_lo + warp * 32; a0 < a_hi; a0 += bs) {
      const int a = a0 + lane;
      float best = -INFINITY;
      if (a < a_hi) {
        int lab;
        bool nan;
        best = best_class(sc + static_cast<size_t>(a) * c, c, lab, nan);
        if (nan) *nan0 = 1;
        const float4 q = bx[a];
        bmax = max(bmax, max(max(__float_as_uint(q.x) & 0x7fffffffu,
                                 __float_as_uint(q.y) & 0x7fffffffu),
                             max(__float_as_uint(q.z) & 0x7fffffffu,
                                 __float_as_uint(q.w) & 0x7fffffffu)));
      }
      const int pos = warp_append(best > thr, cnt0);
      if (pos >= 0) {
        const u64 key = (static_cast<u64>(score_key(best)) << 32)
                        | static_cast<unsigned>(a);
        pool[pos] = key;
        if (pos < W) win0[pos] = key;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      bmax = max(bmax, __shfl_xor_sync(kFull, bmax, off));
    if (lane == 0) atomicMax(side0, bmax);
  } else {
    for (int a0 = warp * 32; a0 < n; a0 += bs) {
      const int a = a0 + lane;
      float s = kKilledB;
      if (a < n) {
        if (p.pri != nullptr) {
          s = p.pri[static_cast<size_t>(b) * n + a];
        } else if (p.valid[static_cast<size_t>(b) * n + a] != 0
                   && sc[a] > p.score_thr) {
          // box_area: (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
          const float4 q = bx[a];
          float w = q.z - q.x, h = q.w - q.y;
          w = w < 0.f ? 0.f : w;
          h = h < 0.f ? 0.f : h;
          s = w * h;
        }
        if (s != s) *nan0 = 1;
      }
      const int pos = warp_append(s > thr, cnt0);
      if (pos >= 0) {
        const u64 key = (static_cast<u64>(score_key(s)) << 32)
                        | static_cast<unsigned>(a);
        pool[pos] = key;
        if (pos < W) win0[pos] = key;
      }
    }
  }
  if constexpr (kB) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();   // every key in the pool and the window
    if (crank != 0) return;
  }
  const int total = s_nan ? 0 : s_cnt;
  // I: every box of the image is in s_side now
  const float side = kI ? 2.f * (__uint_as_float(s_side) + 1.f) : 0.f;
  int remaining = total, kept = 0;
  u64 lo = 0;
  bool first = true;
  // windows grow from kFirstWindow to W, chunks from kFirstChunk to CH:
  // where the first hundred candidates decide the kept set, neither a
  // large sort nor a large mask is paid for
  int wcap = min(W, kFirstWindow), chunk = min(CH, kFirstChunk);

  // ---- 2-4. windows of sorted keys, decided a chunk at a time ----------
  int kept_before = 0, last_window = 0;
  while (remaining > 0 && kept < p.max_out) {
    // where the last window kept under a quarter of its keys, most of
    // the pool is likely suppressed too
    if (!first && kept > 0 && 4 * (kept - kept_before) < last_window) {
      // drop the unprocessed keys a kept box suppresses, all at once (the
      // chunks' own test against the kept boxes would drop them one
      // chunk at a time): they become ~0, above every bound
      if (tid == 0) s_cnt = 0;
      __syncthreads();
      int dropped = 0;
      for (int i = tid; i < total; i += bs) {
        const u64 key = pool[i];
        if (key < lo || key == ~0ull) continue;
        const unsigned flat = static_cast<unsigned>(key);
        const int cls = kB || kI ? 0 : static_cast<int>(flat / n);
        const int a = static_cast<int>(flat) - cls * n;
        const float4 q = bx[a];
        int tag = cls;
        if (kI) {
          bool nan;
          best_class(sc + static_cast<size_t>(a) * c, c, tag, nan);
        }
        for (int k = 0; k < kept; ++k)
          if (kept_over<kForm>(q, tag, k, sbox, slabel, kbox, klabel, side,
                               p.iou_thr)) {
            pool[i] = ~0ull;
            ++dropped;
            break;
          }
      }
      if (dropped) atomicAdd(&s_cnt, dropped);
      __syncthreads();
      remaining -= s_cnt;
      __syncthreads();
      if (remaining == 0) break;
    }
    kept_before = kept;
    int wc = total;
    if (!(first && total <= wcap)) {
      const bool all = remaining <= wcap;
      const u64 cut = all ? ~0ull
                          : select_cut(pool, total, lo, wcap, hist, &s_word,
                                       &s_flag);
      if (tid == 0) s_cnt = 0;
      __syncthreads();
      for (int i0 = warp * 32; i0 < total; i0 += bs) {
        const int i = i0 + lane;
        u64 k = 0;
        bool take = false;
        if (i < total) {
          k = pool[i];
          take = k >= lo && k < cut;      // never a dropped key (~0)
        }
        const int pos = warp_append(take, &s_cnt);
        if (pos >= 0) win[pos] = k;
      }
      __syncthreads();
      wc = s_cnt;
    }
    first = false;
    // bitonic sort of the window, padded to a power of two (at least 32)
    // with ~0: strides of 32 and up through shared memory, a barrier
    // each; the strides below 32 in registers, a warp's 32 consecutive
    // keys exchanged by shuffles
    int np2 = 32;
    while (np2 < wc) np2 <<= 1;
    for (int i = wc + tid; i < np2; i += bs) win[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= np2; size <<= 1) {
      int stride = size >> 1;
      for (; stride >= 32; stride >>= 1) {
        for (int i = tid; i < np2; i += bs) {
          const int j = i ^ stride;
          if (j > i) {
            const u64 x = win[i], y = win[j];
            if ((x > y) == ((i & size) == 0)) { win[i] = y; win[j] = x; }
          }
        }
        __syncthreads();
      }
      for (int i0 = warp * 32; i0 < np2; i0 += bs) {
        const int i = i0 + lane;
        const bool up = (i & size) == 0;
        u64 x = win[i];
        for (int st = stride; st > 0; st >>= 1) {
          const u64 y = __shfl_xor_sync(kFull, x, st);
          x = (((i & st) == 0) == up) ? (x < y ? x : y) : (x < y ? y : x);
        }
        win[i] = x;
      }
      __syncthreads();
    }

    for (int c0 = 0; c0 < wc && kept < p.max_out;) {
      const int C = min(chunk, wc - c0), nw = (C + 31) >> 5;
      for (int i = tid; i < C; i += bs) {
        const unsigned flat = static_cast<unsigned>(win[c0 + i]);
        const int cls = kB || kI ? 0 : static_cast<int>(flat / n);
        const int a = static_cast<int>(flat) - cls * n;
        cbox[i] = bx[a];
        if constexpr (kI) {
          bool nan;
          int lab;
          cscore[i] = best_class(sc + static_cast<size_t>(a) * c, c, lab,
                                 nan);
          ctag[i] = lab;
        } else {
          if (!kB) cscore[i] = sc[static_cast<size_t>(a) * c + cls];
          ctag[i] = kB ? a : cls;
        }
      }
      for (int w = tid; w < nw; w += bs) {
        const int lim = C - 32 * w;    // bits at and past C count as removed
        crem[w] = lim >= 32 ? 0u : (~0u << lim);
      }
      __syncthreads();
      // against every box kept so far (earlier chunks and windows): a warp
      // a candidate, its lanes over the kept list
      if (kept > 0) {
        for (int i = warp; i < C; i += nwarps) {
          const float4 q = cbox[i];
          bool over = false;
          for (int k = lane; k < kept && !over; k += 32)
            over = kept_over<kForm>(q, ctag[i], k, sbox, slabel, kbox,
                                    klabel, side, p.iou_thr);
          if (__any_sync(kFull, over) && lane == 0)
            atomicOr(&crem[i >> 5], 1u << (i & 31));
        }
        __syncthreads();
      }
      // within the chunk: row i, word w = bits of the later j it overlaps;
      // the words at and above row i's own, for rows not yet removed
      for (int w = 0; w < nw; ++w) {
        const int j = (w << 5) + lane;
        const int rows = min(C, (w + 1) << 5);
        for (int i = warp; i < rows; i += nwarps) {
          if ((crem[i >> 5] >> (i & 31)) & 1u) continue;
          bool over = false;
          if (j > i && j < C) {
            if constexpr (kI)
              over = over_thr_i(cbox[j], ctag[j], cbox[i], ctag[i], side,
                                p.iou_thr);
            else if (kB || ctag[j] == ctag[i])
              over = over_thr(cbox[j], cbox[i], p.iou_thr);
          }
          const unsigned bits = __ballot_sync(kFull, over);
          if (lane == 0) cmask[i * nw + w] = bits;
        }
      }
      __syncthreads();
      // one warp decides the chunk in order
      if (warp == 0) {
        unsigned rem = lane < nw ? crem[lane] : ~0u;
        int kc = kept;
        for (int w = 0; w < nw && kc < p.max_out; ++w) {
          unsigned live = ~__shfl_sync(kFull, rem, w);
          while (live != 0u && kc < p.max_out) {
            const int bit = __ffs(live) - 1, i = (w << 5) + bit;
            if (lane == 0) klist[kc - kept] = i;
            ++kc;
            if (lane >= w && lane < nw) rem |= cmask[i * nw + lane];
            live = ~__shfl_sync(kFull, rem, w)
                   & (bit == 31 ? 0u : (~0u << (bit + 1)));
          }
        }
        if (lane == 0) s_kept = kc;
      }
      __syncthreads();
      // the chunk's kept rows, in pick order, written in parallel
      for (int t = tid; t < s_kept - kept; t += bs) {
        const int i = klist[t], kc = kept + t;
        kbox[kc] = cbox[i];
        if (kc < kKeptSmem) {
          sbox[kc] = cbox[i];
          slabel[kc] = ctag[i];
        }
        if (kB) {
          keep[ctag[i]] = 1;
        } else {
          kscore[kc] = cscore[i];
          klabel[kc] = ctag[i];
        }
      }
      // the rows above read other threads' chunk slots, which the next
      // chunk's load overwrites
      __syncthreads();
      kept = s_kept;
      c0 += C;
      chunk = min(CH, 2 * chunk);
    }
    remaining -= wc;
    last_window = wc;
    lo = win[wc - 1] + 1;     // the window's largest key: all below are done
    wcap = min(W, 2 * wcap);
    __syncthreads();
  }

  if (!kB) {
    for (int s = kept + tid; s < p.max_out; s += bs) {
      kbox[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      kscore[s] = 0.f;
      klabel[s] = -1;
    }
    if (tid == 0) p.num_dets[b] = kept;
  }
}

size_t nms_smem_bytes(int window, int chunk) {
  return nms_layout(window, chunk).total;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int kForm>
int launch_greedy(const NmsArgs& a, int batch, int threads, int cluster,
                  cudaStream_t st) {
  if (!pow2(a.window) || !pow2(a.chunk) || a.window > kMaxWindow
      || a.chunk > kMaxChunk || a.window < 32 || a.chunk < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  // once a process: the largest window and chunk a launch may take
  static const cudaError_t attr = cudaFuncSetAttribute(
      greedy_nms_kernel<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(nms_smem_bytes(kMaxWindow, kMaxChunk)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (batch == 0) return 0;
  if (cluster == 1) {
    greedy_nms_kernel<kForm><<<batch, threads,
                            nms_smem_bytes(a.window, a.chunk), st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = nms_smem_bytes(a.window, a.chunk);
  cfg.stream = st;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, greedy_nms_kernel<kForm>,
                                           a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A.  boxes (B, n, 4), scores (B, n, c) f32; pool (B, n * c)
// 8-byte scratch; outputs num_dets (B,), out_boxes (B, max_out, 4),
// out_scores (B, max_out), out_labels (B, max_out).  window, chunk: powers
// of two, 32 to 4096 and 32 to 1024.  Needs score_thr >= -1.
extern "C" int launch_nms_argmax_ml(const float* boxes, const float* scores,
                                    int batch, int n, int c, float iou_thr,
                                    float score_thr, int max_out, int window,
                                    int chunk, void* pool, int* num_dets,
                                    float* out_boxes, float* out_scores,
                                    int* out_labels, void* stream) {
  NmsArgs a{};
  a.boxes = boxes;
  a.scores = scores;
  a.n = n;
  a.c = c;
  a.iou_thr = iou_thr;
  a.score_thr = score_thr;
  a.max_out = max_out;
  a.window = window;
  a.chunk = chunk;
  a.pool = static_cast<u64*>(pool);
  a.num_dets = num_dets;
  a.out_boxes = out_boxes;
  a.out_scores = out_scores;
  a.out_labels = out_labels;
  return launch_greedy<kFormA>(a, batch, 1024, kClusterA,
                              static_cast<cudaStream_t>(stream));
}

// Kernel I.  boxes (B, n, 4), scores (B, n, c) f32; pool (B, n) 8-byte
// scratch; outputs as kernel A's (the boxes as given, not shifted).  The
// kernel takes each anchor's best class and the class-band side itself.
// window, chunk as kernel A's.  Needs score_thr >= -1.
extern "C" int launch_nms_argmax(const float* boxes, const float* scores,
                                 int batch, int n, int c, float iou_thr,
                                 float score_thr, int max_out, int window,
                                 int chunk, void* pool, int* num_dets,
                                 float* out_boxes, float* out_scores,
                                 int* out_labels, void* stream) {
  NmsArgs a{};
  a.boxes = boxes;
  a.scores = scores;
  a.n = n;
  a.c = c;
  a.iou_thr = iou_thr;
  a.score_thr = score_thr;
  a.max_out = max_out;
  a.window = window;
  a.chunk = chunk;
  a.pool = static_cast<u64*>(pool);
  a.num_dets = num_dets;
  a.out_boxes = out_boxes;
  a.out_scores = out_scores;
  a.out_labels = out_labels;
  return launch_greedy<kFormI>(a, batch, 1024, kClusterA,
                               static_cast<cudaStream_t>(stream));
}

// Kernel B.  boxes (B, n, 4) f32; either scores (B, n) f32 and valid
// (B, n) 0/1 bytes (the priority made in the kernel), or pri (B, n) f32
// (scores and valid null); pool (B, n) 8-byte and kept (B, n, 4) f32
// scratch; keep (B, n) 0/1 bytes out.
extern "C" int launch_mask_scan(const float* boxes, const float* scores,
                                const uint8_t* valid, const float* pri,
                                int batch, int n, float iou_thr,
                                float score_thr, int window, int chunk,
                                void* pool, float* kept, uint8_t* keep,
                                void* stream) {
  NmsArgs a{};
  a.boxes = boxes;
  a.scores = scores;
  a.valid = valid;
  a.pri = pri;
  a.n = n;
  a.c = 1;
  a.iou_thr = iou_thr;
  a.score_thr = score_thr;
  a.max_out = n;
  a.window = window;
  a.chunk = chunk;
  a.pool = static_cast<u64*>(pool);
  a.out_boxes = kept;
  a.keep = keep;
  return launch_greedy<kFormB>(a, batch, 1024, 1,
                             static_cast<cudaStream_t>(stream));
}
