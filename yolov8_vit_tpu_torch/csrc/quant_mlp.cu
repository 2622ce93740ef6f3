// Kernel C of the port: the ViT's pre-norm W8A8 MLP sub-block
//     out = x + (q(gelu_tanh(q(LN(x)) . W1 * s + b1)) . W2 * s + b2)
// Replaces yolov8_vit_tpu/ops/quant.py `_quant_mlp_ln_kernel`.
//
// Bound on the H100 at the main path's shapes (x 64 crops x 197 tokens x
// 768, hidden 3072): 2 x 12608 x 768 x 3072 x 2 = 119 G int8 operations,
// about 60 us at 1,979 TOPS; the bytes it must move (x in, out, two 2.4 MB
// weights) take about 13 us, so it is bound by operations.
//
// Design: where the TPU program held a 256-row tile's whole fc1 output in
// VMEM, this is a chain of four launches on one stream, with the
// intermediates in device memory:
//   1. LN + per-row quantize          x (m, d)   -> int8 (m, d), scale (m)
//   2. int8 GEMM fc1, epilogue gelu   -> f32 (m, hid)
//   3. per-row quantize over hid      -> int8 (m, hid), scale (m)
//   4. int8 GEMM fc2, epilogue + x    -> out (m, d) in x's dtype
// Both products run on the tensor cores (mma.sync s8, int32 accumulation,
// exact).  The f32 fc1 round trip (m x hid x 4 bytes each way) is the
// price of the simple form; keeping a 16-row fc1 tile in shared memory
// (16 x 3072 f32 = 192 KB) would remove it.
#include "int8_common.cuh"

namespace {

template <typename T>
int run(const void* x, int m, int d, int hid, const float* ln_s,
        const float* ln_b, float eps, const int8_t* w1t, const float* s1,
        const float* b1, const int8_t* w2t, const float* s2, const float* b2,
        int8_t* hq, float* sx, float* a, int8_t* aq, float* sa, void* out,
        cudaStream_t st) {
  int e = ln_quant_rows<T>(x, m, d, ln_s, ln_b, eps, hq, sx, st);
  if (e) return e;
  e = gemm_i8<float, kEpiGeluF32>(hq, w1t, m, hid, d, sx, s1, b1, nullptr,
                                  a, st);
  if (e) return e;
  e = ln_quant_rows<float>(a, m, hid, nullptr, nullptr, 0.f, aq, sa, st);
  if (e) return e;
  return gemm_i8<T, kEpiResidual>(aq, w2t, m, d, hid, sa, s2, b2, x, out,
                                  st);
}

}  // namespace

// w1t (hid, d) and w2t (d, hid): the int8 kernels transposed to (out, in).
extern "C" int launch_quant_mlp_ln(const void* x, int dtype, int m, int d,
                                   int hid, const float* ln_s,
                                   const float* ln_b, float eps,
                                   const int8_t* w1t, const float* s1,
                                   const float* b1, const int8_t* w2t,
                                   const float* s2, const float* b2,
                                   int8_t* hq, float* sx, float* a,
                                   int8_t* aq, float* sa, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(x, m, d, hid, ln_s, ln_b, eps, w1t, s1, b1,
                              w2t, s2, b2, hq, sx, a, aq, sa, out, st);
  if (dtype == kF32)
    return run<float>(x, m, d, hid, ln_s, ln_b, eps, w1t, s1, b1, w2t, s2,
                      b2, hq, sx, a, aq, sa, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
