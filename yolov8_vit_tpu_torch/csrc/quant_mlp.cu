// Kernels C, G and H of the port: the W8A8 dense layer and MLP sub-blocks
// of yolov8_vit_tpu/ops/quant.py.
//   C  out = x + (q(gelu_tanh(q(LN(x)) . W1 * s + b1)) . W2 * s + b2)
//      replaces `_quant_mlp_ln_kernel`;
//   H  the same without the LN, the MLP input h and the residual read from
//      two pointers; replaces `_quant_mlp_kernel`;
//   G  out = act(q(x) . W * s_x * s_w + b), act the identity or SiLU;
//      replaces `_quant_matmul_kernel`.
//
// Bounds on the H100 at ViT-B widths (64 crops x 197 tokens = 12608 rows,
// 768 wide, hidden 3072).  C and H: 2 x 12608 x 768 x 3072 x 2 = 119 G int8
// operations, about 60 us at 1,979 TOPS; the bytes they must move (rows in
// and out, two 2.4 MB weights) take about 13 us: bound by operations (this
// design computes fc1 twice, 178.5 G operations, about 90 us).  G at
// (768, 3072) bf16: 59 G operations, 30 us, against 12608 x (768 + 3072) x 2
// bytes, 29 us: the two bounds meet; its narrower shapes are bound by bytes.
//
// Design: where the TPU programs held a 256-row tile and its whole fc1
// output in VMEM, these are chains of launches on one stream, with the
// intermediates in device memory, on the one int8 GEMM of
// int8_common.cuh: a persistent grid of 2-CTA clusters walking 256 x 128
// tiles, the weight tile multicast to both CTAs through a TMA ring that
// runs on across tiles, and in each CTA two math groups of two wgmma s8
// warpgroups in ping-pong: one group's epilogue, in registers, runs while
// the other's products run.  The GELU passes' epilogue (tanhf; the
// quantize pass's IEEE division) takes longer than their products and sets
// their pace, with every math warp of the SM on it; fc2's is hidden
// behind its products.
//   C, H  1. (LN +) per-row quantize      (m, d)   -> int8 (m, d), scale (m);
//            also zeroes the (m,) row-amax buffer
//         2. fc1, amax pass: epilogue gelu, max |gelu| of each row of its
//            tile into the amax buffer (atomic max on the f32 bits); stores
//            nothing else
//         3. fc1 again, quantize pass: the same products and epilogue, so
//            the same gelu values bit for bit, then the int8 codes at the
//            row's scale -> int8 (m, hid), scale (m)
//         4. fc2, epilogue + residual -> out (m, d) in x's dtype
//   G     1. per-row quantize; 2. int8 GEMM, epilogue bias (+ SiLU)
// quantize_act(gelu(fc1)) needs each whole 3072-wide row's amax before any
// of its codes.  Recomputing fc1 (59.5 G int8 operations, about 30 us at
// peak) replaces writing it in f32 and reading it back (m x hid x 4 bytes
// each way, 310 MB at ViT-B/16's 12608 rows, about 0.09 ms at 3.35 TB/s);
// on the H100 the chain measured a little faster so (PERF.md) and needs no
// f32 scratch.  The int32 sums are exact, so every epilogue sees the same
// values as the plain version's f64 products rounded to f32.
#include "int8_common.cuh"

namespace {

// ln_s == nullptr: no LayerNorm (kernel H); `res` is the residual stream
// (x itself for kernel C).  amax (m,) is scratch for the fc1 row maxima.
// Rows of x, res and out are ld >= d apart (the GEMMs' width; columns past
// d are zero), and the LN and row quantize take the first d columns.
template <typename T>
int run(const void* x, const void* res, int m, int d, int ld, int hid,
        const float* ln_s, const float* ln_b, float eps, const int8_t* w1t,
        const float* s1, const float* b1, const int8_t* w2t, const float* s2,
        const float* b2, int8_t* hq, float* sx, unsigned* amax, int8_t* aq,
        float* sa, void* out, cudaStream_t st) {
  int e = ln_quant_rows<T>(x, m, d, ld, ln_s, ln_b, eps, hq, sx, st, amax);
  if (e) return e;
  const I8Epi fc1{sx, s1, b1, nullptr, aq, amax, sa};
  e = gemm_i8<int8_t, kEpiGeluAmax>(hq, w1t, m, hid, ld, fc1, st);
  if (e) return e;
  e = gemm_i8<int8_t, kEpiGeluQuant>(hq, w1t, m, hid, ld, fc1, st);
  if (e) return e;
  return gemm_i8<T, kEpiResidual>(
      aq, w2t, m, ld, hid, I8Epi{sa, s2, b2, res, out, nullptr, nullptr},
      st);
}

template <typename T>
int run_dense(const void* x, int m, int k, int n, const int8_t* wt,
              const float* sw, const float* bias, int silu, int8_t* xq,
              float* sx, void* out, cudaStream_t st) {
  int e = ln_quant_rows<T>(x, m, k, k, nullptr, nullptr, 0.f, xq, sx, st);
  if (e) return e;
  const I8Epi ep{sx, sw, bias, nullptr, out, nullptr, nullptr};
  if (silu) return gemm_i8<T, kEpiBiasSilu>(xq, wt, m, n, k, ep, st);
  return gemm_i8<T, kEpiBias>(xq, wt, m, n, k, ep, st);
}

}  // namespace

// Kernels C and H.  x, res and out (m, ld), the real width d <= ld (the
// columns past d zero); w1t (hid, ld) and w2t (ld, hid): the int8 kernels
// transposed to (out, in) and zero-padded; ld and hid multiples of 16.
// ln_s == nullptr skips the LayerNorm (H); res is the residual stream in
// x's dtype (x itself for C).  Scratch: hq (m, ld) and aq (m, hid) int8,
// sx, amax and sa (m,) 4-byte words.
extern "C" int launch_quant_mlp(const void* x, const void* res, int dtype,
                                int m, int d, int ld, int hid,
                                const float* ln_s,
                                const float* ln_b, float eps,
                                const int8_t* w1t, const float* s1,
                                const float* b1, const int8_t* w2t,
                                const float* s2, const float* b2,
                                int8_t* hq, float* sx, unsigned* amax,
                                int8_t* aq, float* sa, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(x, res, m, d, ld, hid, ln_s, ln_b, eps, w1t,
                              s1, b1, w2t, s2, b2, hq, sx, amax, aq, sa, out,
                              st);
  if (dtype == kF32)
    return run<float>(x, res, m, d, ld, hid, ln_s, ln_b, eps, w1t, s1, b1,
                      w2t, s2, b2, hq, sx, amax, aq, sa, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel G.  wt (n, k): the int8 kernel transposed to (out, in); xq (m, k)
// int8 and sx (m,) f32 scratch; out (m, n) in x's dtype; k and n multiples
// of 16 (the wrapper zero-pads x's columns and wt).
extern "C" int launch_quant_dense(const void* x, int dtype, int m, int k,
                                  int n, const int8_t* wt, const float* sw,
                                  const float* bias, int silu, int8_t* xq,
                                  float* sx, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run_dense<__nv_bfloat16>(x, m, k, n, wt, sw, bias, silu, xq, sx,
                                    out, st);
  if (dtype == kF32)
    return run_dense<float>(x, m, k, n, wt, sw, bias, silu, xq, sx, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
