// mt_infer: the PyTorch port's native driver, the counterpart of the JAX
// package's csrc/pjrt_driver.cc.  It loads an AOTInductor package that
// holds an engine's whole graph with its weights (written by
//   python3 -m yolov8_vit_tpu_torch.runtime.export detect ... --stablehlo P
// as P.pt2), decodes and letterboxes an image with the port's host image
// library (csrc/host/), runs the graph with no Python in the process, and
// prints every output:
//
//   mt_infer --package detect.pt2 --image street.bmp [--imgsz 640]
//            [--dump-prefix out] [--device cuda|cpu]
//   mt_infer --list-devices [--device cpu]
//   mt_infer --list-ops
//
// The graph calls the hand-written kernels as operators mt::* (the Python
// package's ops/library.py).  In a Python process those dispatch to the
// package's own implementations; here this file registers the same names
// with schemas generated from ops/library.py's SCHEMAS (mt_schemas.h,
// written by _build.build_driver), and its CUDA implementations call the
// kernel libraries' C entry points (the same .so files _build.lib loads,
// opened with dlopen by the paths baked in at build time) on PyTorch's
// current stream.  A library that does not load fails the run: nothing
// falls back to another implementation.  The CUDA implementations take the
// head dims the SDPA core runs (16, 32, 64, 128): the Python wrappers pad
// others, this driver refuses them.  conv_f32 is cuDNN's convolution with
// its TF32 switch set for the call, as the Python operator does.
//
// Built with the host C++ compiler against the wheel's libtorch; the CUDA
// implementations are compiled in where the CUDA headers exist
// (MT_WITH_CUDA), and elsewhere every kernel operator raises.
//
// Exit codes: 0 OK; 1 a failed load, decode or run; 2 a bad or missing
// argument.

#include <dlfcn.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <optional>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/library.h>
#ifdef MT_WITH_CUDA
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include "imgproc.h"
#include "mt_schemas.h"

#ifndef MT_LIB_NMS
#define MT_LIB_NMS ""
#endif
#ifndef MT_LIB_QUANT_MLP
#define MT_LIB_QUANT_MLP ""
#endif
#ifndef MT_LIB_ATTENTION
#define MT_LIB_ATTENTION ""
#endif
#ifndef MT_LIB_FUSED_REGION
#define MT_LIB_FUSED_REGION ""
#endif
#ifndef MT_LIB_CONV_SILU
#define MT_LIB_CONV_SILU ""
#endif
#ifndef MT_LIB_MLP_BLOCK
#define MT_LIB_MLP_BLOCK ""
#endif

namespace {

using at::Tensor;
using OptTensor = std::optional<Tensor>;

// ---- the kernel libraries ---------------------------------------------------
void* kernel_lib(const std::string& name) {
  static std::map<std::string, void*> libs;
  static const std::map<std::string, std::string> paths = {
      {"nms", MT_LIB_NMS},
      {"quant_mlp", MT_LIB_QUANT_MLP},
      {"attention", MT_LIB_ATTENTION},
      {"fused_region", MT_LIB_FUSED_REGION},
      {"conv_silu", MT_LIB_CONV_SILU},
      {"mlp_block", MT_LIB_MLP_BLOCK}};
  auto it = libs.find(name);
  if (it != libs.end()) return it->second;
  const std::string& path = paths.at(name);
  void* h = path.empty() ? nullptr : dlopen(path.c_str(), RTLD_NOW);
  TORCH_CHECK(h != nullptr, "kernel library ", name, " (",
              path.empty() ? "not built into this driver" : path,
              ") failed to load",
              path.empty() ? std::string() : std::string(": ") + dlerror(),
              "; build the driver on the card's machine with "
              "yolov8_vit_tpu_torch._build.build_driver()");
  libs[name] = h;
  return h;
}

template <typename Fn>
Fn entry(const char* lib, const char* fn) {
  void* sym = dlsym(kernel_lib(lib), fn);
  TORCH_CHECK(sym != nullptr, "kernel library ", lib, " has no ", fn);
  return reinterpret_cast<Fn>(sym);
}

void check(const char* lib, int rc, const char* what) {
  if (rc == 0) return;
  auto err = entry<const char* (*)(int)>(lib, "kernel_error_string");
  TORCH_CHECK(false, what, ": CUDA error ", rc, " (", err(rc), ")");
}

void* stream() {
#ifdef MT_WITH_CUDA
  return static_cast<void*>(c10::cuda::getCurrentCUDAStream().stream());
#else
  TORCH_CHECK(false, "this driver was built without CUDA");
  return nullptr;
#endif
}

void require_cuda(std::initializer_list<const Tensor*> ts) {
  for (const Tensor* t : ts)
    TORCH_CHECK(t->is_cuda(), "mt_infer runs the kernels on the card only "
                "(the plain versions are the Python package's); got a ",
                t->device(), " tensor");
}

int dtype_code(const Tensor& t, const char* what) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, what, " takes f32 or bf16; got ", t.scalar_type());
  return -1;
}

int64_t r16(int64_t v) { return (v + 15) / 16 * 16; }

Tensor f32c(const Tensor& t) { return t.to(at::kFloat).contiguous(); }

// x (..., w) with zero columns up to `width` (ops/quant.py pad_cols)
Tensor pad_cols(const Tensor& x, int64_t width) {
  int64_t w = x.size(-1);
  return w == width ? x : at::constant_pad_nd(x, {0, width - w}, 0);
}

// (out, in) copy of an int8 (in, out) weight, both padded to 16
// (ops/quant.py padded_t)
Tensor padded_t(const Tensor& w) {
  return pad_cols(pad_cols(w.t(), r16(w.size(0))).t(), r16(w.size(1)))
      .t()
      .contiguous();
}

// ops/quant.py transposed_i8
Tensor transposed_i8(const Tensor& w, const OptTensor& wt) {
  if (!wt.has_value()) return padded_t(w);
  int64_t fin = w.size(0), fout = w.size(1);
  if (wt->size(0) == r16(fout) && wt->size(1) == r16(fin))
    return wt->contiguous();
  TORCH_CHECK(wt->size(0) == fout && wt->size(1) == fin,
              "transposed weight does not fit ", w.sizes());
  return padded_t(wt->t());
}

int64_t sdpa_head_dim(int64_t d, int64_t heads, const char* what) {
  TORCH_CHECK(heads > 0 && d % heads == 0, what, ": D=", d,
              " is no multiple of heads=", heads);
  int64_t hd = d / heads;
  TORCH_CHECK(hd == 16 || hd == 32 || hd == 64 || hd == 128, what,
              ": head dim ", hd, "; mt_infer runs head dims 16, 32, 64 and "
              "128 (the Python package pads others)");
  return hd;
}

float rounded_scale(int64_t hd, at::ScalarType dt) {
  // hd^-0.5 in the activation dtype, as float(torch.tensor(s, dtype=dt))
  return at::scalar_tensor(std::pow(double(hd), -0.5), at::kDouble)
      .to(dt)
      .item<float>();
}

// ---- operators (ops/library.py; the Python launchers in ops/*.py) ----------
using NmsFn = int (*)(const float*, const float*, int, int, int, float, float,
                      int, int, int, void*, int*, float*, float*, int*, void*);

std::tuple<Tensor, Tensor, Tensor, Tensor> nms_run(
    const char* fn, const Tensor& boxes_in, const Tensor& scores_in,
    double iou, double score, int64_t max_out, int64_t window, int64_t chunk,
    bool multi_label) {
  require_cuda({&boxes_in, &scores_in});
  TORCH_CHECK(score >= -1.0, fn, " takes score_threshold >= -1");
  Tensor boxes = f32c(boxes_in), scores = f32c(scores_in);
  int64_t b = scores.size(0), n = scores.size(1), c = scores.size(2);
  TORCH_CHECK(n * c < (int64_t(1) << 31), fn, ": flat index overflow");
  auto f = boxes.options().dtype(at::kFloat);
  auto i = boxes.options().dtype(at::kInt);
  Tensor num = at::empty({b}, i), ob = at::empty({b, max_out, 4}, f),
         os = at::empty({b, max_out}, f), ol = at::empty({b, max_out}, i);
  Tensor pool = at::empty({b, multi_label ? n * c : n},
                          boxes.options().dtype(at::kLong));
  int rc = entry<NmsFn>("nms", fn)(
      boxes.data_ptr<float>(), scores.data_ptr<float>(), int(b), int(n),
      int(c), float(iou), float(score), int(max_out), int(window), int(chunk),
      pool.data_ptr(), num.data_ptr<int>(), ob.data_ptr<float>(),
      os.data_ptr<float>(), ol.data_ptr<int>(), stream());
  check("nms", rc, fn);
  return {num, ob, os, ol};
}

std::tuple<Tensor, Tensor, Tensor, Tensor> nms_argmax_ml(
    const Tensor& boxes, const Tensor& scores, double iou, double score,
    int64_t max_out, int64_t window, int64_t chunk) {
  return nms_run("launch_nms_argmax_ml", boxes, scores, iou, score, max_out,
                 window, chunk, true);
}

std::tuple<Tensor, Tensor, Tensor, Tensor> nms_argmax(
    const Tensor& boxes, const Tensor& scores, double iou, double score,
    int64_t max_out, int64_t window, int64_t chunk) {
  return nms_run("launch_nms_argmax", boxes, scores, iou, score, max_out,
                 window, chunk, false);
}

Tensor mask_scan(const Tensor& boxes_in, const OptTensor& scores,
                 const OptTensor& valid, const OptTensor& pri, double iou,
                 double score, int64_t window, int64_t chunk) {
  require_cuda({&boxes_in});
  TORCH_CHECK(pri.has_value() != (scores.has_value() && valid.has_value()),
              "kernel B takes scores and valid, or pri");
  Tensor boxes = f32c(boxes_in);
  int64_t b = boxes.size(0), t = boxes.size(1);
  Tensor sc, va, pr;
  if (pri.has_value()) {
    require_cuda({&*pri});
    pr = f32c(*pri);
  } else {
    require_cuda({&*scores, &*valid});
    sc = f32c(*scores);
    va = valid->to(at::kBool).contiguous();
  }
  Tensor keep = at::empty({b, t}, boxes.options().dtype(at::kBool));
  Tensor pool = at::empty({b, t}, boxes.options().dtype(at::kLong));
  Tensor kept = at::empty({b, t, 4}, boxes.options());
  using Fn = int (*)(const float*, const float*, const uint8_t*, const float*,
                     int, int, float, float, int, int, void*, float*,
                     uint8_t*, void*);
  int rc = entry<Fn>("nms", "launch_mask_scan")(
      boxes.data_ptr<float>(), sc.defined() ? sc.data_ptr<float>() : nullptr,
      va.defined() ? reinterpret_cast<const uint8_t*>(va.data_ptr()) : nullptr,
      pr.defined() ? pr.data_ptr<float>() : nullptr, int(b), int(t),
      float(iou), float(score), int(window), int(chunk), pool.data_ptr(),
      kept.data_ptr<float>(), reinterpret_cast<uint8_t*>(keep.data_ptr()),
      stream());
  check("nms", rc, "mask_scan (kernel B)");
  return keep;
}

// kernels C (ln given) and H: rows (M, D) -> (M, D)
Tensor quant_mlp_run(const char* what, const Tensor& xm_in,
                     const Tensor& res_in, const Tensor* ln_s,
                     const Tensor* ln_b, double eps, const Tensor& w1_i8,
                     const Tensor& s1_in, const Tensor& b1_in,
                     const Tensor& w2_i8, const Tensor& s2_in,
                     const Tensor& b2_in, const OptTensor& w1_t,
                     const OptTensor& w2_t) {
  require_cuda({&xm_in, &res_in, &w1_i8, &w2_i8, &s1_in, &b1_in, &s2_in,
                &b2_in});
  Tensor xm = xm_in.contiguous();
  int code = dtype_code(xm, what);
  TORCH_CHECK(res_in.scalar_type() == xm.scalar_type() &&
                  res_in.sizes() == xm.sizes(),
              what, " takes rows and residual of one shape and dtype");
  int64_t m = xm.size(0), d = xm.size(1);
  Tensor w1t = transposed_i8(w1_i8, w1_t), w2t = transposed_i8(w2_i8, w2_t);
  int64_t hp = w1t.size(0), dp = w1t.size(1);
  TORCH_CHECK(dp == r16(d), what, ": weights do not fit D=", d);
  Tensor xp = pad_cols(xm, dp).contiguous();
  Tensor rp = &res_in == &xm_in ? xp : pad_cols(res_in.contiguous(), dp)
                                           .contiguous();
  Tensor s1 = pad_cols(f32c(s1_in), hp), b1 = pad_cols(f32c(b1_in), hp);
  Tensor s2 = pad_cols(f32c(s2_in), dp), b2 = pad_cols(f32c(b2_in), dp);
  Tensor ls, lb;
  if (ln_s != nullptr) {
    ls = f32c(*ln_s);
    lb = f32c(*ln_b);
  }
  auto o = xm.options();
  Tensor out = at::empty_like(xp);
  Tensor hq = at::empty({m, dp}, o.dtype(at::kChar));
  Tensor sx = at::empty({m}, o.dtype(at::kFloat));
  Tensor amax = at::empty({m}, o.dtype(at::kInt));
  Tensor aq = at::empty({m, hp}, o.dtype(at::kChar));
  Tensor sa = at::empty({m}, o.dtype(at::kFloat));
  using Fn = int (*)(const void*, const void*, int, int, int, int, int,
                     const float*, const float*, float, const int8_t*,
                     const float*, const float*, const int8_t*, const float*,
                     const float*, int8_t*, float*, unsigned*, int8_t*,
                     float*, void*, void*);
  int rc = entry<Fn>("quant_mlp", "launch_quant_mlp")(
      xp.data_ptr(), rp.data_ptr(), code, int(m), int(d), int(dp), int(hp),
      ls.defined() ? ls.data_ptr<float>() : nullptr,
      lb.defined() ? lb.data_ptr<float>() : nullptr, float(eps),
      w1t.data_ptr<int8_t>(), s1.data_ptr<float>(), b1.data_ptr<float>(),
      w2t.data_ptr<int8_t>(), s2.data_ptr<float>(), b2.data_ptr<float>(),
      hq.data_ptr<int8_t>(), sx.data_ptr<float>(),
      reinterpret_cast<unsigned*>(amax.data_ptr<int>()),
      aq.data_ptr<int8_t>(), sa.data_ptr<float>(), out.data_ptr(), stream());
  check("quant_mlp", rc, what);
  return out.narrow(1, 0, d).contiguous();
}

Tensor quant_mlp_ln(const Tensor& x, const Tensor& ln_scale,
                    const Tensor& ln_bias, const Tensor& w1_i8,
                    const Tensor& s1, const Tensor& b1, const Tensor& w2_i8,
                    const Tensor& s2, const Tensor& b2, double ln_eps,
                    const OptTensor& w1_t, const OptTensor& w2_t) {
  require_cuda({&ln_scale, &ln_bias});
  return quant_mlp_run("quant_mlp_ln (kernel C)", x, x, &ln_scale, &ln_bias,
                       ln_eps, w1_i8, s1, b1, w2_i8, s2, b2, w1_t, w2_t);
}

Tensor quant_mlp(const Tensor& h, const Tensor& residual, const Tensor& w1_i8,
                 const Tensor& s1, const Tensor& b1, const Tensor& w2_i8,
                 const Tensor& s2, const Tensor& b2, const OptTensor& w1_t,
                 const OptTensor& w2_t) {
  return quant_mlp_run("quant_mlp (kernel H)", h, residual, nullptr, nullptr,
                       0.0, w1_i8, s1, b1, w2_i8, s2, b2, w1_t, w2_t);
}

Tensor quant_dense(const Tensor& x_in, const Tensor& w_i8,
                   const Tensor& w_scale, const Tensor& bias, bool silu,
                   const OptTensor& w_t) {
  require_cuda({&x_in, &w_i8, &w_scale, &bias});
  int code = dtype_code(x_in, "quant_dense (kernel G)");
  int64_t m = x_in.size(0), n = w_i8.size(1);
  Tensor wt = transposed_i8(w_i8, w_t);
  int64_t np = wt.size(0), kp = wt.size(1);
  Tensor xm = pad_cols(x_in.contiguous(), kp).contiguous();
  Tensor sw = pad_cols(f32c(w_scale), np), b = pad_cols(f32c(bias), np);
  auto o = xm.options();
  Tensor xq = at::empty({m, kp}, o.dtype(at::kChar));
  Tensor sx = at::empty({m}, o.dtype(at::kFloat));
  Tensor out = at::empty({m, np}, o);
  using Fn = int (*)(const void*, int, int, int, int, const int8_t*,
                     const float*, const float*, int, int8_t*, float*, void*,
                     void*);
  int rc = entry<Fn>("quant_mlp", "launch_quant_dense")(
      xm.data_ptr(), code, int(m), int(kp), int(np), wt.data_ptr<int8_t>(),
      sw.data_ptr<float>(), b.data_ptr<float>(), silu ? 1 : 0,
      xq.data_ptr<int8_t>(), sx.data_ptr<float>(), out.data_ptr(), stream());
  check("quant_mlp", rc, "quant_dense (kernel G)");
  return out.narrow(1, 0, n).contiguous();
}

Tensor attn_block_i8(const Tensor& x_in, const Tensor& ln_scale,
                     const Tensor& ln_bias, const Tensor& wqkv_i8,
                     const Tensor& sqkv, const Tensor& bqkv,
                     const Tensor& wproj_i8, const Tensor& sproj,
                     const Tensor& bproj, int64_t heads, double ln_eps,
                     std::optional<int64_t> t_real, const OptTensor& wqkv_t,
                     const OptTensor& wproj_t) {
  require_cuda({&x_in, &ln_scale, &ln_bias, &wqkv_i8, &sqkv, &bqkv,
                &wproj_i8, &sproj, &bproj});
  Tensor x = x_in.contiguous();
  const char* what = "attn_block_i8 (kernel D)";
  int code = dtype_code(x, what);
  int64_t b = x.size(0), t = x.size(1), d = x.size(2);
  int64_t hd = sdpa_head_dim(d, heads, what), m = b * t, dh = d;
  Tensor wqt = transposed_i8(wqkv_i8, wqkv_t);
  Tensor wpt = transposed_i8(wproj_i8, wproj_t);
  Tensor ls = f32c(ln_scale), lb = f32c(ln_bias), sq = f32c(sqkv),
         bq = f32c(bqkv), sp = f32c(sproj), bp = f32c(bproj);
  auto o = x.options();
  Tensor hq = at::empty({m, d}, o.dtype(at::kChar));
  Tensor sx = at::empty({m}, o.dtype(at::kFloat));
  Tensor qkv = at::empty({m, 3 * dh}, o);
  Tensor heads_out = at::empty({m, dh}, o);
  Tensor oq = at::empty({m, dh}, o.dtype(at::kChar));
  Tensor so = at::empty({m}, o.dtype(at::kFloat));
  Tensor out = at::empty({m, d}, o);
  using Fn = int (*)(const void*, int, int, int, int, int, int, int, int,
                     float, const float*, const float*, float, const int8_t*,
                     const float*, const float*, const int8_t*, const float*,
                     const float*, int8_t*, float*, void*, void*, int8_t*,
                     float*, void*, void*);
  int rc = entry<Fn>("attention", "launch_attn_block_i8")(
      x.data_ptr(), code, int(b), int(t), int(d), int(d), int(dh),
      int(heads), int(t_real.value_or(t)),
      rounded_scale(hd, x.scalar_type()), ls.data_ptr<float>(),
      lb.data_ptr<float>(), float(ln_eps), wqt.data_ptr<int8_t>(),
      sq.data_ptr<float>(), bq.data_ptr<float>(), wpt.data_ptr<int8_t>(),
      sp.data_ptr<float>(), bp.data_ptr<float>(), hq.data_ptr<int8_t>(),
      sx.data_ptr<float>(), qkv.data_ptr(), heads_out.data_ptr(),
      oq.data_ptr<int8_t>(), so.data_ptr<float>(), out.data_ptr(), stream());
  check("attention", rc, what);
  return out.view({b, t, d});
}

Tensor attn_block(const Tensor& x_in, const Tensor& ln_scale,
                  const Tensor& ln_bias, const Tensor& wqkv,
                  const Tensor& bqkv, const Tensor& wproj,
                  const Tensor& bproj, int64_t heads, double ln_eps,
                  std::optional<int64_t> t_real) {
  require_cuda({&x_in, &ln_scale, &ln_bias, &wqkv, &bqkv, &wproj, &bproj});
  Tensor x = x_in.contiguous();
  const char* what = "attn_block (kernel E)";
  int code = dtype_code(x, what);
  int64_t b = x.size(0), t = x.size(1), d = x.size(2);
  TORCH_CHECK(d % 8 == 0, what, ": D=", d, " is no multiple of 8");
  int64_t hd = sdpa_head_dim(d, heads, what), m = b * t, dh = d;
  Tensor wq = wqkv.to(x.scalar_type()).contiguous();
  Tensor wp = wproj.to(x.scalar_type()).contiguous();
  Tensor ls = f32c(ln_scale), lb = f32c(ln_bias), bq = f32c(bqkv),
         bp = f32c(bproj);
  auto o = x.options();
  Tensor h = at::empty({m, d}, o), qkv = at::empty({m, 3 * dh}, o),
         heads_out = at::empty({m, dh}, o), out = at::empty_like(x);
  using Fn = int (*)(const void*, int, int, int, int, int, int, int, float,
                     const float*, const float*, float, const void*,
                     const float*, const void*, const float*, void*, void*,
                     void*, void*, void*);
  int rc = entry<Fn>("attention", "launch_attn_block")(
      x.data_ptr(), code, int(b), int(t), int(d), int(dh), int(heads),
      int(t_real.value_or(t)), rounded_scale(hd, x.scalar_type()),
      ls.data_ptr<float>(), lb.data_ptr<float>(), float(ln_eps),
      wq.data_ptr(), bq.data_ptr<float>(), wp.data_ptr(),
      bp.data_ptr<float>(), h.data_ptr(), qkv.data_ptr(),
      heads_out.data_ptr(), out.data_ptr(), stream());
  check("attention", rc, what);
  return out;
}

Tensor flash_attention(const Tensor& q_in, const Tensor& k_in,
                       const Tensor& v_in) {
  require_cuda({&q_in, &k_in, &v_in});
  const char* what = "flash_attention (kernel F)";
  TORCH_CHECK(k_in.sizes() == q_in.sizes() && v_in.sizes() == q_in.sizes() &&
                  k_in.scalar_type() == q_in.scalar_type() &&
                  v_in.scalar_type() == q_in.scalar_type(),
              what, " takes q, k, v of one shape and dtype");
  Tensor q = q_in.contiguous(), k = k_in.contiguous(), v = v_in.contiguous();
  int code = dtype_code(q, what);
  int64_t b = q.size(0), t = q.size(1), heads = q.size(2), hd = q.size(3);
  sdpa_head_dim(heads * hd, heads, what);
  Tensor out = at::empty_like(q);
  using Fn = int (*)(const void*, const void*, const void*, int, int, int,
                     int, int, int, long long, float, void*, void*);
  int rc = entry<Fn>("attention", "launch_flash_attention")(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), code, int(b), int(t),
      int(heads), int(hd), int(q.stride(1)), (long long)q.stride(0),
      float(std::pow(double(hd), -0.5)), out.data_ptr(), stream());
  check("attention", rc, what);
  return out;
}

Tensor fused_b1b2(const Tensor& x_in, const Tensor& w, const Tensor& bias,
                  int64_t c2) {
  require_cuda({&x_in, &w, &bias});
  const char* what = "fused_b1b2 (kernel J)";
  Tensor x = x_in.contiguous();
  int64_t b = x.size(0), h = x.size(1), wd = x.size(2), c1 = x.size(3);
  bool fused = (c1 == 32 && c2 == 64) || (c1 == 16 && c2 == 32);
  TORCH_CHECK(x.scalar_type() == at::kBFloat16 && h % 2 == 0 &&
                  wd % 2 == 0 && (fused || (c1 % 16 == 0 && c2 % 32 == 0)),
              what, " takes bf16 (B, H, W, c1), H and W even, (c1, c2) in "
              "((32, 64), (16, 32)) or c1 and c2 / 2 multiples of 16");
  Tensor out = at::empty({b, h / 2, wd / 2, c2}, x.options());
  Tensor scratch;
  if (!fused) scratch = at::empty({b * (h / 2) * (wd / 2) * 3 * c2}, x.options());
  using Fn = int (*)(const void*, int, int, int, int, int, const void*,
                     const float*, void*, void*, void*);
  int rc = entry<Fn>("fused_region", "launch_fused_b1b2")(
      x.data_ptr(), int(b), int(h), int(wd), int(c1), int(c2),
      w.contiguous().data_ptr(), f32c(bias).data_ptr<float>(),
      scratch.defined() ? scratch.data_ptr() : nullptr, out.data_ptr(),
      stream());
  check("fused_region", rc, what);
  return out;
}

// (B, H, W, C) with channels adjacent and pixels one stride apart: a whole
// NHWC tensor or a channel slice of one (ops/conv_block.py _pixel_dense)
bool pixel_dense(const Tensor& t) {
  int64_t ld = t.stride(2);
  return t.stride(3) == 1 && (t.stride(1) == t.size(2) * ld || t.size(1) == 1)
         && (t.stride(0) == t.size(1) * t.size(2) * ld || t.size(0) == 1);
}

void conv_silu(const Tensor& x_in, const Tensor& weight, const Tensor& bias,
               int64_t stride, const OptTensor& residual_in,
               const Tensor& out) {
  require_cuda({&x_in, &weight, &bias, &out});
  const char* what = "conv_silu (kernel K)";
  int64_t b = x_in.size(0), h = x_in.size(1), w = x_in.size(2),
          cin = x_in.size(3), cout = weight.size(0), k = weight.size(1);
  int64_t p = k / 2, ho = (h + 2 * p - k) / stride + 1,
          wo = (w + 2 * p - k) / stride + 1;
  TORCH_CHECK(x_in.scalar_type() == at::kBFloat16 &&
                  weight.scalar_type() == at::kBFloat16 &&
                  bias.scalar_type() == at::kFloat &&
                  out.scalar_type() == at::kBFloat16 &&
                  out.sizes() == at::IntArrayRef({b, ho, wo, cout}) &&
                  pixel_dense(out) &&
                  weight.strides() ==
                      at::IntArrayRef({1, k * cin * cout, cin * cout, cout}),
              what, " takes bf16 x (B, H, W, cin), bf16 (cout, k, k, cin) "
              "weights over HWIO memory, f32 bias and a bf16 NHWC out");
  Tensor x = pixel_dense(x_in) ? x_in : x_in.contiguous();
  Tensor res;
  if (residual_in.has_value()) {
    res = *residual_in;
    require_cuda({&res});
    TORCH_CHECK(res.sizes() == out.sizes() &&
                    res.scalar_type() == at::kBFloat16,
                what, " takes a bf16 residual of the output's shape");
    if (!pixel_dense(res) || res.stride(2) % 8 ||
        reinterpret_cast<uintptr_t>(res.data_ptr()) % 16)
      res = res.contiguous();
  }
  using Fn = int (*)(const void*, int, int, int, int, long long, const void*,
                     int, int, int, const float*, const void*, long long,
                     void*, long long, void*);
  int rc = entry<Fn>("conv_silu", "launch_conv_silu")(
      x.data_ptr(), int(b), int(h), int(w), int(cin), (long long)x.stride(2),
      weight.data_ptr(), int(k), int(stride), int(cout),
      bias.contiguous().data_ptr<float>(),
      res.defined() ? res.data_ptr() : nullptr,
      res.defined() ? (long long)res.stride(2) : 0LL, out.data_ptr(),
      (long long)out.stride(2), stream());
  check("conv_silu", rc, what);
}

Tensor mlp_block(const Tensor& x_in, const Tensor& ln_scale,
                 const Tensor& ln_bias, const Tensor& w1, const Tensor& b1,
                 const Tensor& w2, const Tensor& b2, double ln_eps) {
  require_cuda({&x_in, &ln_scale, &ln_bias, &w1, &b1, &w2, &b2});
  const char* what = "mlp_block";
  Tensor x = x_in.contiguous();
  if (reinterpret_cast<uintptr_t>(x.data_ptr()) % 16) x = x.clone();
  int64_t d = x.size(-1), hidden = w1.size(1), m = x.numel() / d;
  TORCH_CHECK(x.scalar_type() == at::kBFloat16 && d % 8 == 0 && d <= 2048 &&
                  hidden % 8 == 0 && w1.size(0) == d && w2.size(0) == hidden &&
                  w2.size(1) == d,
              what, " takes bf16 x (..., D), w1 (D, H) and w2 (H, D), D (at "
              "most 2048) and H multiples of 8");
  auto aligned = [](Tensor c) {    // 16-byte aligned bases (TMA, vectors)
    return reinterpret_cast<uintptr_t>(c.data_ptr()) % 16 ? c.clone() : c;
  };
  auto bf = [&](const Tensor& t) {
    return aligned(t.to(at::kBFloat16).contiguous());
  };
  Tensor wa = bf(w1), ba = bf(b1), wb = bf(w2), bb = bf(b2);
  Tensor ls = aligned(f32c(ln_scale)), lb = aligned(f32c(ln_bias));
  auto o = x.options();
  Tensor ln = at::empty({m, d}, o), h = at::empty({m, hidden}, o),
         out = at::empty_like(x);
  using Fn = int (*)(const void*, int, int, int, const float*, const float*,
                     float, const void*, const void*, const void*,
                     const void*, void*, void*, void*, void*);
  int rc = entry<Fn>("mlp_block", "launch_mlp_block")(
      x.data_ptr(), int(m), int(d), int(hidden), ls.data_ptr<float>(),
      lb.data_ptr<float>(), float(ln_eps), wa.data_ptr(), ba.data_ptr(),
      wb.data_ptr(), bb.data_ptr(), ln.data_ptr(), h.data_ptr(),
      out.data_ptr(), stream());
  check("mlp_block", rc, what);
  return out;
}

Tensor conv_f32(const Tensor& x, const Tensor& weight, const OptTensor& bias,
                int64_t stride, bool allow_tf32) {
  auto& ctx = at::globalContext();
  bool prev = ctx.allowTF32CuDNN();
  ctx.setAllowTF32CuDNN(allow_tf32);
  int64_t p = weight.size(-1) / 2;
  Tensor y;
  try {
    y = at::conv2d(x, weight, bias, {stride, stride}, {p, p});
  } catch (...) {
    ctx.setAllowTF32CuDNN(prev);
    throw;
  }
  ctx.setAllowTF32CuDNN(prev);
  return y.contiguous(x.suggest_memory_format());
}

}  // namespace

TORCH_LIBRARY(mt, m) { MT_DEFINE_OPS(m) }

#define MT_IMPLS(m)                               \
  m.impl("nms_argmax_ml", nms_argmax_ml);         \
  m.impl("mask_scan", mask_scan);                 \
  m.impl("quant_mlp_ln", quant_mlp_ln);           \
  m.impl("attn_block_i8", attn_block_i8);         \
  m.impl("attn_block", attn_block);               \
  m.impl("flash_attention", flash_attention);     \
  m.impl("quant_dense", quant_dense);             \
  m.impl("quant_mlp", quant_mlp);                 \
  m.impl("nms_argmax", nms_argmax);               \
  m.impl("fused_b1b2", fused_b1b2);               \
  m.impl("conv_silu", conv_silu);                 \
  m.impl("mlp_block", mlp_block);                 \
  m.impl("conv_f32", conv_f32);

// the kernel operators are registered for the CPU too, where they refuse
// CPU tensors with a message (require_cuda) instead of "no kernel"; every
// registration checks its C++ signature against the schema at startup
TORCH_LIBRARY_IMPL(mt, CPU, m) { MT_IMPLS(m) }
#ifdef MT_WITH_CUDA
TORCH_LIBRARY_IMPL(mt, CUDA, m) { MT_IMPLS(m) }
#endif

// ---- the program -------------------------------------------------------------
namespace {

struct Args {
  std::string package, image, dump_prefix, device = "cuda";
  int imgsz = 0;
  bool list_devices = false, list_ops = false;
};

int cuda_devices() {
#ifdef MT_WITH_CUDA
  return int(c10::cuda::device_count());
#else
  return 0;
#endif
}

std::vector<int64_t> parse_shape(const std::string& s) {
  std::vector<int64_t> out;
  size_t pos = 0;
  while (pos <= s.size()) {
    size_t x = s.find('x', pos);
    out.push_back(std::stoll(s.substr(pos, x - pos)));
    if (x == std::string::npos) break;
    pos = x + 1;
  }
  return out;
}

// an exception's message without c10's backtrace (which an operator's
// error carries through AOTInductor's proxy executor as plain text)
std::string brief(const std::exception& e) {
  std::string msg = e.what();
  if (auto* ce = dynamic_cast<const c10::Error*>(&e))
    msg = ce->what_without_backtrace();
  return msg.substr(0, msg.find("\nException raised from"));
}

void dump(const std::string& path, const Tensor& host) {
  std::ofstream out(path, std::ios::binary);
  out.write(static_cast<const char*>(host.data_ptr()),
            std::streamsize(host.nbytes()));
}

void print_output(size_t i, const Tensor& host) {
  printf("output[%zu]: %zu bytes:", i, size_t(host.nbytes()));
  int64_t n = std::min<int64_t>(host.numel(), 8);
  Tensor flat = host.reshape({-1});
  for (int64_t j = 0; j < n; ++j) {
    if (host.is_floating_point())
      printf(" %.4f", flat[j].item<double>());
    else
      printf(" %lld", (long long)flat[j].item<int64_t>());
  }
  printf("\n");
}

}  // namespace

int main(int argc, char** argv) {
  Args args;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](std::string& dst) {
      if (i + 1 >= argc) {
        fprintf(stderr, "missing value for %s\n", a.c_str());
        return false;
      }
      dst = argv[++i];
      return true;
    };
    std::string v;
    if (a == "--package") {
      if (!next(args.package)) return 2;
    } else if (a == "--image") {
      if (!next(args.image)) return 2;
    } else if (a == "--dump-prefix") {
      if (!next(args.dump_prefix)) return 2;
    } else if (a == "--device") {
      if (!next(args.device)) return 2;
      if (args.device != "cuda" && args.device != "cpu") {
        fprintf(stderr, "bad --device %s (want cuda or cpu)\n",
                args.device.c_str());
        return 2;
      }
    } else if (a == "--imgsz") {
      if (!next(v)) return 2;
      args.imgsz = atoi(v.c_str());
      if (args.imgsz <= 0) {
        fprintf(stderr, "bad --imgsz %s\n", v.c_str());
        return 2;
      }
    } else if (a == "--list-devices") {
      args.list_devices = true;
    } else if (a == "--list-ops") {
      args.list_ops = true;
    } else {
      fprintf(stderr, "unknown arg %s\n", a.c_str());
      return 2;
    }
  }
  if (args.list_ops) {
    for (const char* name : kMtOps) {
      const auto& op =
          c10::Dispatcher::singleton().findSchemaOrThrow(name, "");
      printf("%s\n", c10::toString(op.schema()).c_str());
    }
  }
  bool cuda = args.device == "cuda";
  if (args.list_devices) {
    printf("platform: %s\n", args.device.c_str());
    printf("addressable devices: %d\n", cuda ? cuda_devices() : 1);
  }
  if (args.package.empty()) {
    if (args.list_ops || args.list_devices) return 0;
    fprintf(stderr, "--package required\n");
    return 2;
  }
  if (cuda && cuda_devices() == 0) {
    fprintf(stderr, "--device cuda: no CUDA device%s\n",
#ifdef MT_WITH_CUDA
            ""
#else
            " (this driver was built without CUDA)"
#endif
    );
    return 1;
  }

  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::unordered_map<std::string, std::string> meta;
  try {
    loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        args.package);
    meta = loader->get_metadata();
  } catch (const std::exception& e) {
    fprintf(stderr, "failed to load package %s: %s\n", args.package.c_str(),
            brief(e).c_str());
    return 1;
  }
  auto get = [&](const char* key) {
    auto it = meta.find(key);
    return it == meta.end() ? std::string() : it->second;
  };
  if (get("mt_weights") != "inside") {
    fprintf(stderr, "package %s does not hold its weights (an engine "
            "dir's blob takes them as an argument): export one with "
            "--stablehlo\n", args.package.c_str());
    return 1;
  }
  std::string pkg_device = get("AOTI_DEVICE_KEY");
  if (!pkg_device.empty() && pkg_device != args.device) {
    fprintf(stderr, "package %s was compiled for %s, not --device %s\n",
            args.package.c_str(), pkg_device.c_str(), args.device.c_str());
    return 1;
  }
  if (!cuda) {
    // a kernel operator's error inside a run cannot be relied on to come
    // back as an exception (some libtorch versions abort), so a CPU run
    // refuses them before it starts
    std::string kernels, ops = get("mt_ops") + ",";
    for (size_t pos = 0, end; (end = ops.find(',', pos)) != std::string::npos;
         pos = end + 1) {
      std::string op = ops.substr(pos, end - pos);
      if (!op.empty() && op != "conv_f32")
        kernels += (kernels.empty() ? "" : ", ") + op;
    }
    if (!kernels.empty()) {
      fprintf(stderr, "package %s calls the kernel operators %s, which "
              "mt_infer runs on the card only (--device cuda)\n",
              args.package.c_str(), kernels.c_str());
      return 1;
    }
  }
  std::vector<int64_t> shape = parse_shape(get("mt_input_shape"));
  const std::string range = get("mt_input_range");
  if (shape.size() != 4 || shape[3] != 3) {
    fprintf(stderr, "package %s: bad mt_input_shape\n", args.package.c_str());
    return 1;
  }
  const int64_t N = shape[0], H = shape[1], W = shape[2];
  if (args.imgsz && (args.imgsz != H || args.imgsz != W)) {
    fprintf(stderr, "--imgsz %d: the package takes %lldx%lld inputs\n",
            args.imgsz, (long long)H, (long long)W);
    return 1;
  }

  // ---- input: decode + letterbox (or the frame as decoded) ----------------
  Tensor frame = at::full({H, W, 3}, 114, at::kByte);
  if (!args.image.empty()) {
    mt::Image img = mt::DecodeImageFile(args.image);
    if (!img.ok()) {
      fprintf(stderr, "decode failed: %s\n", args.image.c_str());
      return 1;
    }
    if (range == "u8") {
      if (img.height != H || img.width != W) {
        fprintf(stderr, "the package takes %lldx%lld frames; %s is %dx%d\n",
                (long long)H, (long long)W, args.image.c_str(), img.height,
                img.width);
        return 1;
      }
      std::memcpy(frame.data_ptr(), img.data.data(), img.data.size());
    } else {
      mt::LetterboxInfo info = mt::LetterboxU8(
          img, int(W), int(H), 114, frame.data_ptr<uint8_t>());
      printf("letterbox ratio=%.4f dw=%.1f dh=%.1f\n", info.ratio, info.dw,
             info.dh);
    }
  }
  Tensor input;
  if (range == "u8")
    input = frame;
  else if (range == "01")
    input = frame.to(at::kFloat) / 255.0f;
  else if (range == "pm1")
    input = frame.to(at::kFloat) / 255.0f * 2.0f - 1.0f;
  else {
    fprintf(stderr, "package %s: unknown mt_input_range %s\n",
            args.package.c_str(), range.c_str());
    return 1;
  }
  input = input.unsqueeze(0).expand({N, H, W, 3}).contiguous();
  if (!args.dump_prefix.empty()) dump(args.dump_prefix + "_input.bin", input);

  // ---- run ------------------------------------------------------------------
  std::vector<Tensor> outs;
  try {
    Tensor x = cuda ? input.to(at::Device(at::kCUDA, 0)) : input;
    outs = loader->run({x});
#ifdef MT_WITH_CUDA
    if (cuda) c10::cuda::device_synchronize();
#endif
  } catch (const std::exception& e) {
    fprintf(stderr, "run failed: %s\n", brief(e).c_str());
    return 1;
  }
  printf("package outputs: %zu (%s)\n", outs.size(), get("mt_outputs").c_str());
  for (size_t i = 0; i < outs.size(); ++i) {
    Tensor host = outs[i].to(at::kCPU).contiguous();
    print_output(i, host);
    if (!args.dump_prefix.empty())
      dump(args.dump_prefix + "_" + std::to_string(i) + ".bin", host);
  }
  printf("OK\n");
  return 0;
}
