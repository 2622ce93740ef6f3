// Kernels D, E and F of the port: the ViT's attention in three forms.
//   D  out = x + proj_i8(SDPA(qkv_i8(LN1(x))))   replaces
//      yolov8_vit_tpu/ops/attention.py `_attn_block_kernel_i8`;
//   E  out = x + proj(SDPA(qkv(LN1(x))))          float weights, replaces
//      yolov8_vit_tpu/ops/attention.py `_attn_block_kernel`;
//   F  o = softmax(q k^T / sqrt(d)) v over (B, T, H, D), replaces
//      yolov8_vit_tpu/ops/attention.py `_attn_kernel`.
// All three run the key-tiled two-pass SDPA core of sdpa.cuh, so any
// sequence length works (ViT-B/8's 785 tokens included).
//
// Bounds on the H100 (989 bf16 TFLOP/s, 1,979 int8 TOPS, 3.35 TB/s):
//   D at 64 crops x 197 tokens x 768 (ViT-B/16): 59.5 G int8 operations
//     (30 us) + 7.6 GFLOP of attention products (8 us): operations;
//   E at 64 crops x 785 tokens x 768 (ViT-B/8): QKV and proj products
//     8 M d^2 = 0.24 TFLOP + attention 4 x 64 x 12 x 785^2 x 64 = 0.12
//     TFLOP, about 0.36 ms, against about 0.05 ms for its 154 MB of x in
//     and out: operations;
//   F at (64, 785, 12, 64): 0.12 TFLOP, about 0.12 ms, against 0.09 ms of
//     bytes: operations.
// The SDPA core recomputes the scores in its second pass (1.5x the score
// products) to keep the TPU kernel's rounding of P, and its exponentials
// alone need about 0.23-0.26 ms at F's shape on the special-function
// units (sdpa.cuh), above the products' bound.
//
// Design: where one TPU program held a group of images' whole sub-block
// in VMEM, D and E are chains of launches on one stream with the
// intermediates in device memory:
//   D: LN1 + row quantize -> int8 GEMM qkv (*s + b) -> SDPA -> row
//      quantize -> int8 GEMM proj (*s + b + x)   (int8_common.cuh: the
//      GEMM on wgmma s8 with a TMA ring, as C, G and H)
//   E: LN1 to the dtype -> GEMM qkv (+ b) -> SDPA -> GEMM proj (+ b + x)
//      (gemm_float.cuh: bf16 on wgmma with TMA, f32 on the CUDA cores)
//   F: the SDPA core alone on strided (B, T, H, D) views.
// D's int8 GEMMs in both dtypes, and at bf16 the SDPA and E's GEMMs, are
// warp-specialised sm_90a kernels: a
// producer warp streams tiles with TMA into a ring of shared-memory stages
// behind mbarriers, and consumer warpgroups run wgmma on them (hopper.cuh).
// Their TMA tensor maps are encoded per call on the host from the
// pointers and strides the wrappers pass; a base or stride off TMA's
// 16-byte rules returns an error, and the wrapper raises.
#include "gemm_float.cuh"

namespace {

SdpaArgs packed_qkv(const void* qkv, void* heads_out, int dtype, int t,
                    int d, int heads, int t_real, float scale) {
  // q | k | v packed along the feature axis of (nb * t, 3d) rows
  const size_t es = dtype == kBF16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  SdpaArgs a;
  a.q = base;
  a.k = base + es * d;
  a.v = base + es * 2 * d;
  a.o = heads_out;
  a.bstride = static_cast<long long>(t) * 3 * d;
  a.ld = 3 * d;
  a.t = t;
  a.heads = heads;
  a.t_real = t_real;
  a.scale = scale;
  a.prescale = 1;
  return a;
}

// Rows of x and out are ld >= d apart (the columns past d zero): the
// QKV GEMM's depth and the proj GEMM's width.  dh = heads x the head dim
// the SDPA core runs (a real head dim padded up to one the core takes,
// with zero columns in each head): the width of q, k, v and the heads'
// output, and the proj GEMM's depth.
template <typename T>
int run(const void* x, int nb, int t, int d, int ld, int dh, int heads,
        int t_real, float scale, const float* ln_s, const float* ln_b,
        float eps, const int8_t* wqt, const float* sq, const float* bq,
        const int8_t* wpt, const float* sp, const float* bp, int8_t* hq,
        float* sx, void* qkv, void* heads_out, int8_t* oq, float* so,
        void* out, cudaStream_t st) {
  const int m = nb * t, hd = dh / heads;
  int e = ln_quant_rows<T>(x, m, d, ld, ln_s, ln_b, eps, hq, sx, st);
  if (e) return e;
  e = gemm_i8<T, kEpiBias>(hq, wqt, m, 3 * dh, ld,
                           I8Epi{sx, sq, bq, nullptr, qkv, nullptr, nullptr},
                           st);
  if (e) return e;
  constexpr int code = sizeof(T) == 2 ? kBF16 : kF32;
  e = launch_sdpa(packed_qkv(qkv, heads_out, code, t, dh, heads, t_real,
                             scale), code, nb, hd, st);
  if (e) return e;
  e = ln_quant_rows<T>(heads_out, m, dh, dh, nullptr, nullptr, 0.f, oq, so,
                       st);
  if (e) return e;
  return gemm_i8<T, kEpiResidual>(
      oq, wpt, m, ld, dh, I8Epi{so, sp, bp, x, out, nullptr, nullptr}, st);
}

}  // namespace

// x and out (nb * t, ld), the real width d <= ld; wqt (3 dh, ld) and wpt
// (ld, dh): the int8 kernels transposed to (out, in), zero-padded, the
// qkv rows of each head padded to dh / heads; ld and dh multiples of 16.
// `scale` is the real head dim's hd^-0.5, rounded to the activation dtype.
extern "C" int launch_attn_block_i8(
    const void* x, int dtype, int nb, int t, int d, int ld, int dh,
    int heads, int t_real, float scale, const float* ln_s, const float* ln_b,
    float eps, const int8_t* wqt, const float* sq, const float* bq,
    const int8_t* wpt, const float* sp, const float* bp, int8_t* hq,
    float* sx, void* qkv, void* heads_out, int8_t* oq, float* so, void* out,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(x, nb, t, d, ld, dh, heads, t_real, scale,
                              ln_s, ln_b, eps, wqt, sq, bq, wpt, sp, bp, hq,
                              sx, qkv, heads_out, oq, so, out, st);
  if (dtype == kF32)
    return run<float>(x, nb, t, d, ld, dh, heads, t_real, scale, ln_s, ln_b,
                      eps, wqt, sq, bq, wpt, sp, bp, hq, sx, qkv, heads_out,
                      oq, so, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// dh = heads x the head dim the SDPA core runs (as D's): the width of q,
// k, v and the heads' output, and the proj GEMM's depth.
template <typename T>
int run_float(const void* x, int dtype, int nb, int t, int d, int dh,
              int heads, int t_real, float scale, const float* ln_s,
              const float* ln_b, float eps, const void* wq, const float* bq,
              const void* wp, const float* bp, void* h, void* qkv,
              void* heads_out, void* out, cudaStream_t st) {
  const int m = nb * t;
  int e = ln_rows<T>(x, m, d, ln_s, ln_b, eps, h, st);
  if (e) return e;
  e = gemm_float<T, kFEpiBias>(h, wq, m, 3 * dh, d, bq, nullptr, qkv, st);
  if (e) return e;
  e = launch_sdpa(packed_qkv(qkv, heads_out, dtype, t, dh, heads, t_real,
                             scale), dtype, nb, dh / heads, st);
  if (e) return e;
  return gemm_float<T, kFEpiResidual>(heads_out, wp, m, d, dh, bp, x, out,
                                      st);
}

}  // namespace

// Kernel E.  wq (d, 3 dh) and wp (dh, d) in the JAX (in, out) layout and
// the activation dtype (each head's q, k, v columns and proj rows padded
// with zeros to dh / heads); biases and LN params f32; h (m, d), qkv (m,
// 3 dh) and heads_out (m, dh) scratch in the activation dtype.  `scale`
// is the real head dim's hd^-0.5, already rounded to the activation dtype.
extern "C" int launch_attn_block(
    const void* x, int dtype, int nb, int t, int d, int dh, int heads,
    int t_real,
    float scale, const float* ln_s, const float* ln_b, float eps,
    const void* wq, const float* bq, const void* wp, const float* bp,
    void* h, void* qkv, void* heads_out, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run_float<__nv_bfloat16>(x, dtype, nb, t, d, dh, heads, t_real,
                                    scale, ln_s, ln_b, eps, wq, bq, wp, bp,
                                    h, qkv, heads_out, out, st);
  if (dtype == kF32)
    return run_float<float>(x, dtype, nb, t, d, dh, heads, t_real, scale,
                            ln_s, ln_b, eps, wq, bq, wp, bp, h, qkv,
                            heads_out, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel F on (nb, t, heads, hd) views: element (b, i, h, c) of q, k and v
// at ptr + b * bstride + i * ld + h * hd + c; o contiguous (nb, t, heads,
// hd).  The f32 `scale` multiplies the f32 scores.
extern "C" int launch_flash_attention(
    const void* q, const void* k, const void* v, int dtype, int nb, int t,
    int heads, int hd, int ld, long long bstride, float scale, void* o,
    void* stream) {
  SdpaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.bstride = bstride;
  a.ld = ld;
  a.t = t;
  a.heads = heads;
  a.t_real = t;
  a.scale = scale;
  a.prescale = 0;
  return launch_sdpa(a, dtype, nb, hd, static_cast<cudaStream_t>(stream));
}
