// Kernel D of the port: the ViT's pre-norm W8A8 attention sub-block
//     out = x + proj_i8(SDPA(qkv_i8(LN1(x))))
// Replaces yolov8_vit_tpu/ops/attention.py `_attn_block_kernel_i8`.
//
// Bound on the H100 at the main path's shapes (64 crops x 197 tokens x
// 768, 12 heads of 64): the QKV and proj products are 59.5 G int8
// operations (about 30 us at 1,979 TOPS) and the attention products
// 2 x 2 x 64 x 12 x 197^2 x 64 = 7.6 GFLOP (about 8 us at 989 TFLOP/s);
// the bytes it must move take about 12 us, so it is bound by operations.
//
// Design: a chain of five launches on one stream, intermediates in device
// memory (a CTA cannot hold what one TPU program held in VMEM):
//   1. LN1 + per-row quantize             x -> int8 (m, d), scale (m)
//   2. int8 GEMM qkv, epilogue *s + b     -> qkv (m, 3d) in x's dtype
//   3. SDPA, one CTA per (head, crop)     -> heads (m, d) in x's dtype
//   4. per-row quantize of the heads      -> int8 (m, d), scale (m)
//   5. int8 GEMM proj, epilogue + x       -> out (m, d) in x's dtype
// Step 3 follows the TPU kernel's rounding: q * hd^-0.5 rounded to the
// activation dtype, scores and softmax in f32, P rounded to the dtype,
// P.V accumulated in f32 and rounded to the dtype.  It keeps one head's K
// and V in shared memory as f32 (K rows padded to 65 floats: the score
// loop's lanes read distinct banks) and gives each warp one query row at
// a time; the products run on the CUDA cores, not the tensor cores.
#include "int8_common.cuh"

namespace {

constexpr int kSdpaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kSdpaWarps)
sdpa_kernel(const T* __restrict__ qkv, int t, int d, int hd, int t_real,
            float scale, T* __restrict__ o) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* ks = smem;                          // (t, hd + 1)
  float* vs = ks + t * ldk;                  // (t, hd)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = vs + t * hd + warp * (hd + t);  // per warp: q (hd), p (t)
  float* pw = qw + hd;
  const int h = blockIdx.x, img = blockIdx.y;
  const size_t ld = 3 * static_cast<size_t>(d);
  const T* base = qkv + static_cast<size_t>(img) * t * ld;
  for (int i = threadIdx.x; i < t * hd; i += blockDim.x) {
    const int j = i / hd, c = i - j * hd;
    ks[j * ldk + c] = to_f(base[j * ld + d + h * hd + c]);
    vs[j * hd + c] = to_f(base[j * ld + 2 * d + h * hd + c]);
  }
  __syncthreads();
  for (int i = warp; i < t; i += kSdpaWarps) {
    for (int c = lane; c < hd; c += 32)
      qw[c] = to_f(from_f<T>(to_f(base[i * ld + h * hd + c]) * scale));
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < t; j += 32) {
      float s = 0.f;
      const float* kr = ks + j * ldk;
      for (int c = 0; c < hd; ++c) s += qw[c] * kr[c];
      if (j >= t_real) s = -INFINITY;
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < t; j += 32)
      pw[j] = to_f(from_f<T>(__fdiv_rn(pw[j], sum)));
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc += pw[j] * vs[j * hd + c];
      o[(static_cast<size_t>(img) * t + i) * d + h * hd + c] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

size_t sdpa_smem(int t, int hd) {
  return sizeof(float) * (static_cast<size_t>(t) * (hd + 1) +
                          static_cast<size_t>(t) * hd +
                          static_cast<size_t>(kSdpaWarps) * (hd + t));
}

template <typename T>
int run(const void* x, int nb, int t, int d, int heads, int t_real,
        float scale, const float* ln_s, const float* ln_b, float eps,
        const int8_t* wqt, const float* sq, const float* bq,
        const int8_t* wpt, const float* sp, const float* bp, int8_t* hq,
        float* sx, void* qkv, void* heads_out, int8_t* oq, float* so,
        void* out, cudaStream_t st) {
  const int m = nb * t, hd = d / heads;
  int e = ln_quant_rows<T>(x, m, d, ln_s, ln_b, eps, hq, sx, st);
  if (e) return e;
  e = gemm_i8<T, kEpiBias>(hq, wqt, m, 3 * d, d, sx, sq, bq, nullptr, qkv,
                           st);
  if (e) return e;
  const size_t smem = sdpa_smem(t, hd);
  cudaError_t ce = cudaFuncSetAttribute(
      sdpa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (m > 0) {
    sdpa_kernel<T><<<dim3(heads, nb), 32 * kSdpaWarps, smem, st>>>(
        static_cast<const T*>(qkv), t, d, hd, t_real, scale,
        static_cast<T*>(heads_out));
    e = static_cast<int>(cudaGetLastError());
    if (e) return e;
  }
  e = ln_quant_rows<T>(heads_out, m, d, nullptr, nullptr, 0.f, oq, so, st);
  if (e) return e;
  return gemm_i8<T, kEpiResidual>(oq, wpt, m, d, d, so, sp, bp, x, out, st);
}

}  // namespace

// wqt (3d, d) and wpt (d, d): the int8 kernels transposed to (out, in).
// `scale` is hd^-0.5 already rounded to the activation dtype.
extern "C" int launch_attn_block_i8(
    const void* x, int dtype, int nb, int t, int d, int heads, int t_real,
    float scale, const float* ln_s, const float* ln_b, float eps,
    const int8_t* wqt, const float* sq, const float* bq, const int8_t* wpt,
    const float* sp, const float* bp, int8_t* hq, float* sx, void* qkv,
    void* heads_out, int8_t* oq, float* so, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(x, nb, t, d, heads, t_real, scale, ln_s, ln_b,
                              eps, wqt, sq, bq, wpt, sp, bp, hq, sx, qkv,
                              heads_out, oq, so, out, st);
  if (dtype == kF32)
    return run<float>(x, nb, t, d, heads, t_real, scale, ln_s, ln_b, eps,
                      wqt, sq, bq, wpt, sp, bp, hq, sx, qkv, heads_out, oq,
                      so, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
