// Greedy NMS kernels for Hopper (sm_90a): kernels A, B and I of the port.
//
// A  nms_argmax_ml_kernel replaces yolov8_vit_tpu/ops/nms.py
//    `_nms_argmax_kernel_ml` (stage-1 EfficientNMS, multi-label,
//    class-aware).  One CTA per image keeps every (class, anchor) score in
//    shared memory (5 x 8400 f32 = 168 KB); each iteration is a block-wide
//    (max score, min flat index) reduction followed by one IoU pass over the
//    anchors that kills same-class entries.  Its bound on the H100 is not the
//    ~9.7 MB of input (about 3 us at 3.35 TB/s) but the sequential pick loop
//    (up to 100 dependent iterations, each two block barriers); one CTA per
//    image keeps the whole loop on chip, with no launch or global round trip
//    per pick.
// I  nms_argmax_kernel replaces `_nms_argmax_kernel` (stage-1 EfficientNMS,
//    single-label: one candidate per anchor, its best class).  The same
//    loop as A over one score per anchor (8400 f32 = 34 KB of shared
//    memory), bound by the same sequential picks.  Classes are kept apart
//    as the TPU kernel keeps them, by shifting each box by label * side
//    before the IoU, in the same f32 operations: the shifted coordinates
//    round, so a class-equality mask would decide pairs near the threshold
//    differently.
// B  mask_scan_kernel replaces `_mask_scan_kernel` (stage-2 area-sorted
//    class-agnostic NMS over the 100 stage-1 rows, keep mask in row order).
//    64 KB of input per batch: launch-latency bound.  One CTA of 128 threads
//    per image, one row per thread, the same reduction loop.
//
// Tie-breaks and arithmetic follow the TPU kernels exactly: ties go to the
// lowest flat index (class * A + anchor for A, row for B); IoU is
// inter / max(a + b - inter, 1e-9) with a strict `>`; killed entries hold
// -1 (A) or -1e9 (B).  The library is built with -fmad=false so no
// multiply-add is contracted, and `/` is IEEE division (no fast math).
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace {

constexpr float kKilledB = -1e9f;

// Block-wide argmax: the largest value, ties to the smallest index.  Every
// thread returns the winner.  `sv`/`si` hold 33 entries of scratch.
__device__ void block_argmax(float& v, int& idx, float* sv, int* si) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = idx; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sv[lane] : -INFINITY;
    idx = lane < nwarps ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, v, off);
      int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
    }
    if (lane == 0) { sv[32] = v; si[32] = idx; }
  }
  __syncthreads();
  v = sv[32];
  idx = si[32];
  __syncthreads();   // scratch is reused by the next call
}

__device__ __forceinline__ float iou_of(float x1, float y1, float x2, float y2,
                                        float cx1, float cy1, float cx2,
                                        float cy2, float c_area) {
  float area = fmaxf(x2 - x1, 0.f) * fmaxf(y2 - y1, 0.f);
  float iw = fmaxf(fminf(x2, cx2) - fmaxf(x1, cx1), 0.f);
  float ih = fmaxf(fminf(y2, cy2) - fmaxf(y1, cy1), 0.f);
  float inter = iw * ih;
  return __fdiv_rn(inter, fmaxf(area + c_area - inter, 1e-9f));
}

// boxes (B, n, 4), scores (B, n, c) -> num_dets (B,), out_boxes
// (B, max_out, 4), out_scores (B, max_out), out_labels (B, max_out).
__global__ void nms_argmax_ml_kernel(const float* __restrict__ boxes,
                                     const float* __restrict__ scores,
                                     int n, int c, float iou_thr,
                                     float score_thr, int max_out,
                                     int* __restrict__ num_dets,
                                     float* __restrict__ out_boxes,
                                     float* __restrict__ out_scores,
                                     int* __restrict__ out_labels) {
  extern __shared__ float smem[];
  const int total = n * c;
  float* scs = smem;                              // (c, n) class-major
  float* red_v = smem + total;                    // 33
  int* red_i = reinterpret_cast<int*>(red_v + 33);  // 33
  const int b = blockIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * n * 4;
  const float* sc = scores + static_cast<size_t>(b) * total;
  float* ob = out_boxes + static_cast<size_t>(b) * max_out * 4;
  float* os = out_scores + static_cast<size_t>(b) * max_out;
  int* ol = out_labels + static_cast<size_t>(b) * max_out;

  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int a = i / c, k = i - a * c;
    scs[k * n + a] = sc[i];
  }
  for (int s = threadIdx.x; s < max_out; s += blockDim.x) {
    ob[4 * s] = 0.f; ob[4 * s + 1] = 0.f; ob[4 * s + 2] = 0.f;
    ob[4 * s + 3] = 0.f;
    os[s] = 0.f;
    ol[s] = -1;
  }
  __syncthreads();

  int kept = 0;
  while (kept < max_out) {
    float v = -INFINITY;
    int idx = INT_MAX;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const float s = scs[i];
      if (s > v) { v = s; idx = i; }   // strided ascending: first max wins
    }
    block_argmax(v, idx, red_v, red_i);
    if (!(v > score_thr)) break;
    const int k = idx / n, a = idx - k * n;
    const float cx1 = bx[4 * a], cy1 = bx[4 * a + 1];
    const float cx2 = bx[4 * a + 2], cy2 = bx[4 * a + 3];
    const float c_area = fmaxf(cx2 - cx1, 0.f) * fmaxf(cy2 - cy1, 0.f);
    float* plane = scs + k * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float iou = iou_of(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2],
                               bx[4 * j + 3], cx1, cy1, cx2, cy2, c_area);
      if (iou > iou_thr || j == a) plane[j] = -1.f;
    }
    if (threadIdx.x == 0) {
      ob[4 * kept] = cx1; ob[4 * kept + 1] = cy1;
      ob[4 * kept + 2] = cx2; ob[4 * kept + 3] = cy2;
      os[kept] = v;
      ol[kept] = k;
    }
    ++kept;
    __syncthreads();
  }
  if (threadIdx.x == 0) num_dets[b] = kept;
}

// boxes (B, n, 4), per-anchor best score (B, n) and its label as f32
// (B, n), side (B,) -> the outputs of kernel A.  Output rows carry the
// box as given, not shifted.
__global__ void nms_argmax_kernel(const float* __restrict__ boxes,
                                  const float* __restrict__ scores,
                                  const float* __restrict__ labels,
                                  const float* __restrict__ sides, int n,
                                  float iou_thr, float score_thr,
                                  int max_out, int* __restrict__ num_dets,
                                  float* __restrict__ out_boxes,
                                  float* __restrict__ out_scores,
                                  int* __restrict__ out_labels) {
  extern __shared__ float smem[];
  float* scs = smem;                              // n
  float* red_v = smem + n;                        // 33
  int* red_i = reinterpret_cast<int*>(red_v + 33);  // 33
  const int b = blockIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * n * 4;
  const float* lab = labels + static_cast<size_t>(b) * n;
  const float side = sides[b];
  float* ob = out_boxes + static_cast<size_t>(b) * max_out * 4;
  float* os = out_scores + static_cast<size_t>(b) * max_out;
  int* ol = out_labels + static_cast<size_t>(b) * max_out;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    scs[i] = scores[static_cast<size_t>(b) * n + i];
  for (int s = threadIdx.x; s < max_out; s += blockDim.x) {
    ob[4 * s] = 0.f; ob[4 * s + 1] = 0.f; ob[4 * s + 2] = 0.f;
    ob[4 * s + 3] = 0.f;
    os[s] = 0.f;
    ol[s] = -1;
  }
  __syncthreads();

  int kept = 0;
  while (kept < max_out) {
    float v = -INFINITY;
    int idx = INT_MAX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float s = scs[i];
      if (s > v) { v = s; idx = i; }
    }
    block_argmax(v, idx, red_v, red_i);
    if (!(v > score_thr)) break;
    const float cx1 = bx[4 * idx], cy1 = bx[4 * idx + 1];
    const float cx2 = bx[4 * idx + 2], cy2 = bx[4 * idx + 3];
    const float clab = lab[idx];
    const float coff = clab * side;
    // the selected box's area is taken on the coordinates as given
    const float c_area = fmaxf(cx2 - cx1, 0.f) * fmaxf(cy2 - cy1, 0.f);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float off = lab[j] * side;
      const float iou = iou_of(bx[4 * j] + off, bx[4 * j + 1] + off,
                               bx[4 * j + 2] + off, bx[4 * j + 3] + off,
                               cx1 + coff, cy1 + coff, cx2 + coff,
                               cy2 + coff, c_area);
      if (iou > iou_thr || j == idx) scs[j] = -1.f;
    }
    if (threadIdx.x == 0) {
      ob[4 * kept] = cx1; ob[4 * kept + 1] = cy1;
      ob[4 * kept + 2] = cx2; ob[4 * kept + 3] = cy2;
      os[kept] = v;
      ol[kept] = static_cast<int>(clab);
    }
    ++kept;
    __syncthreads();
  }
  if (threadIdx.x == 0) num_dets[b] = kept;
}

// boxes (B, n, 4), priority (B, n) -> keep (B, n) as 0/1 bytes.
__global__ void mask_scan_kernel(const float* __restrict__ boxes,
                                 const float* __restrict__ pri, int n,
                                 float iou_thr, uint8_t* __restrict__ keep) {
  extern __shared__ float smem[];
  float* pr = smem;                               // n
  float* red_v = smem + n;                        // 33
  int* red_i = reinterpret_cast<int*>(red_v + 33);  // 33
  const int b = blockIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * n * 4;
  uint8_t* kp = keep + static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    pr[i] = pri[static_cast<size_t>(b) * n + i];
    kp[i] = 0;
  }
  __syncthreads();
  while (true) {
    float v = -INFINITY;
    int idx = INT_MAX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float s = pr[i];
      if (s > v) { v = s; idx = i; }
    }
    block_argmax(v, idx, red_v, red_i);
    if (!(v > kKilledB / 2.f)) break;
    const float cx1 = bx[4 * idx], cy1 = bx[4 * idx + 1];
    const float cx2 = bx[4 * idx + 2], cy2 = bx[4 * idx + 3];
    const float c_area = fmaxf(cx2 - cx1, 0.f) * fmaxf(cy2 - cy1, 0.f);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float iou = iou_of(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2],
                               bx[4 * j + 3], cx1, cy1, cx2, cy2, c_area);
      if (iou > iou_thr || j == idx) pr[j] = kKilledB;
    }
    if (threadIdx.x == 0) kp[idx] = 1;
    __syncthreads();
  }
}

}  // namespace

extern "C" int launch_nms_argmax_ml(const float* boxes, const float* scores,
                                    int batch, int n, int c, float iou_thr,
                                    float score_thr, int max_out,
                                    int* num_dets, float* out_boxes,
                                    float* out_scores, int* out_labels,
                                    void* stream) {
  const size_t smem = (static_cast<size_t>(n) * c + 66) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nms_argmax_ml_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  nms_argmax_ml_kernel<<<batch, 1024, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, n, c, iou_thr, score_thr, max_out, num_dets, out_boxes,
      out_scores, out_labels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_nms_argmax(const float* boxes, const float* scores,
                                 const float* labels, const float* sides,
                                 int batch, int n, float iou_thr,
                                 float score_thr, int max_out, int* num_dets,
                                 float* out_boxes, float* out_scores,
                                 int* out_labels, void* stream) {
  const size_t smem = (static_cast<size_t>(n) + 66) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nms_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (batch == 0) return 0;
  nms_argmax_kernel<<<batch, 1024, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, labels, sides, n, iou_thr, score_thr, max_out, num_dets,
      out_boxes, out_scores, out_labels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_mask_scan(const float* boxes, const float* pri,
                                int batch, int n, float iou_thr,
                                uint8_t* keep, void* stream) {
  if (batch == 0) return 0;
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = (static_cast<size_t>(n) + 66) * sizeof(float);
  mask_scan_kernel<<<batch, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      boxes, pri, n, iou_thr, keep);
  return static_cast<int>(cudaGetLastError());
}
