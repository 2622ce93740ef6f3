"""PyTorch port, models: YOLOv8 head maps and the W8A8 ViT classifier held
against the JAX package on the same parameters and inputs, plus the
parameter-tree plumbing (load, export, port-native init).

Bars: 2e-3 on detector head maps (tests/test_fulldim_parity.py); ViT
logits at f32 within 1e-4 (int8 products exact, float order differs);
ViT argmax agreement at bf16.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.config import DetectConfig as JDetectConfig
from yolov8_vit_tpu.models.two_stage import TwoStagePipeline as JPipe
from yolov8_vit_tpu.models.vit import ViTClassifier as JViTClassifier
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.ops import blob as jblob
from yolov8_vit_tpu.ops.crop import crop_to_patches_i8 as j_crop
from yolov8_vit_tpu.ops.letterbox import letterbox_fast as j_lb_fast
from yolov8_vit_tpu.ops.letterbox import letterbox_s2d as j_lb_s2d
from yolov8_vit_tpu.ops.quant import MLP_AND_ATTN_SUFFIXES
from yolov8_vit_tpu.ops.quant import prequantize_tree as j_prequantize

from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
from yolov8_vit_tpu_torch.ops import blob, letterbox_fast
from yolov8_vit_tpu_torch.weights import init_tree, load_tree, module_tree

DET_KW = dict(input_size=(64, 64), variant="n", nms_topk=16)
VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40)


@pytest.fixture(scope="module")
def jax_params():
    """One JAX init (float ViT), pre-quantized as a w8a engine is built."""
    pipe = JPipe(det_cfg=JDetectConfig(**DET_KW), vit_spec=JViTSpec(**VIT_KW),
                 stem_mode="flat")
    params = jax.tree.map(np.asarray,
                          jax.jit(pipe.init_params)(jax.random.PRNGKey(0)))
    params["vit_w8a"] = jax.tree.map(
        np.asarray, j_prequantize(params["vit"], MLP_AND_ATTN_SUFFIXES))
    return params


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (3, 96, 128, 3),
                                             np.uint8)


@pytest.mark.parametrize("stem_mode", ["flat", "cell"])
def test_yolov8_head_maps_match_jax(jax_params, frames, stem_mode):
    """Same params, f32: the port's flat NHWC detector against JAX's flat
    stem and its s2d + cell-layout stem (same arithmetic, TPU layout)."""
    jp = JPipe(det_cfg=JDetectConfig(**DET_KW), stem_mode=stem_mode)
    imgs = jnp.asarray(frames)
    if stem_mode == "flat":
        lb, _, _ = j_lb_fast(imgs, (64, 64), dtype=jnp.float32)
    else:
        lb, _, _ = j_lb_s2d(imgs, (64, 64), dtype=jnp.float32)
    ref = jp.detector.apply(jax_params["det"], jblob(lb))
    det = YOLOv8(detect_spec(DetectConfig(**DET_KW)))
    load_tree(det, jax_params["det"]["params"])
    tlb, _, _ = letterbox_fast(torch.from_numpy(frames), (64, 64),
                               dtype=torch.float32)
    with torch.no_grad():
        got = det(blob(tlb))
    assert len(got) == len(ref) == 3
    for (gb, gc), (rb, rc) in zip(got, ref):
        assert gb.shape == rb.shape and gc.shape == rc.shape
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), atol=2e-3,
                                   rtol=0)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=2e-3,
                                   rtol=0)


def test_yolov8_bf16_matches_jax_bf16(jax_params, frames):
    """bf16 activations, same params: each conv accumulates its bf16
    operands in f32 and adds the bias before one rounding, as JAX does, so
    the stem's two convs (b0, b1) are equal bit for bit; deeper layers
    differ only where the two f32 sums round to neighbouring bf16 values.
    Head maps within 1e-4 (a conv that rounds its output before the bias
    gives a stem off by up to 2^-7 and head maps off by 1.5e-4)."""
    jp = JPipe(det_cfg=JDetectConfig(**DET_KW), stem_mode="flat")
    lb, _, _ = j_lb_fast(jnp.asarray(frames), (64, 64), dtype=jnp.bfloat16)
    ref, st = jp.detector.apply(jax_params["det"],
                                jblob(lb).astype(jnp.bfloat16),
                                capture_intermediates=True)
    det = YOLOv8(detect_spec(DetectConfig(**DET_KW)), dtype=torch.bfloat16)
    load_tree(det, jax_params["det"]["params"])
    tlb, _, _ = letterbox_fast(torch.from_numpy(frames), (64, 64),
                               dtype=torch.bfloat16)
    x = blob(tlb).to(torch.bfloat16)
    with torch.no_grad():
        got = det(x)
        h = x.permute(0, 3, 1, 2)
        for name in ("b0", "b1"):
            h = getattr(det, name)(h)
            r = st["intermediates"][name]["__call__"][0]
            np.testing.assert_array_equal(
                h.permute(0, 2, 3, 1).float().numpy(),
                np.asarray(r.astype(jnp.float32)), err_msg=name)
    for (gb, gc), (rb, rc) in zip(got, ref):
        for g, r in ((gb, rb), (gc, rc)):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(r.astype(jnp.float32)),
                                       atol=1e-4, rtol=0)


def _patches(frames, seed=1):
    rng = np.random.default_rng(seed)
    k = 6
    x1 = rng.integers(0, 80, k)
    y1 = rng.integers(0, 60, k)
    bx = np.stack([x1, y1, x1 + rng.integers(4, 40, k),
                   y1 + rng.integers(4, 30, k)], -1).astype(np.int32)
    si = rng.integers(0, len(frames), k).astype(np.int32)
    return np.array(j_crop(jnp.asarray(frames), jnp.asarray(si),
                             jnp.asarray(bx), (32, 32), 8))


def _vits(jax_params, dtype_j, dtype_t):
    spec_kw = dict(VIT_KW, quant="w8a", attn_impl="fused")
    jv = JViTClassifier(JViTSpec(**spec_kw), 5, dtype=dtype_j)
    tv = ViTClassifier(ViTSpec(**spec_kw), 5, dtype=dtype_t)
    load_tree(tv, jax_params["vit_w8a"]["params"])
    return jv, tv


def test_vit_w8a_logits_match_jax_f32(jax_params, frames):
    patches = _patches(frames)
    jv, tv = _vits(jax_params, jnp.float32, torch.float32)
    ref = np.asarray(jv.apply(jax_params["vit_w8a"], jnp.asarray(patches)))
    with torch.no_grad():
        got = tv(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_vit_w8a_bf16_argmax_matches_jax(jax_params, frames):
    """bf16 activations: both frameworks round at slightly different
    points (a torch bf16 matmul rounds before its bias), so the bar is the
    classification: argmax equal to JAX bf16 and to the port's f32."""
    patches = _patches(frames, seed=2)
    jv, tv = _vits(jax_params, jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jv.apply(jax_params["vit_w8a"], jnp.asarray(patches))
                     .astype(jnp.float32))
    with torch.no_grad():
        got = tv(torch.from_numpy(patches)).float().numpy()
    _, tv32 = _vits(jax_params, jnp.float32, torch.float32)
    with torch.no_grad():
        got32 = tv32(torch.from_numpy(patches)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_array_equal(got.argmax(-1), got32.argmax(-1))
    spread = ref.max() - ref.min()
    assert np.abs(got - ref).max() / spread < 0.05


def test_vit_w8a_pad_tokens_matches_jax(jax_params, frames):
    """Lane-padded sequence (pad_tokens > tokens): padded keys masked in
    kernel D's SDPA (t_real), cls-token logits as JAX's."""
    spec_kw = dict(VIT_KW, quant="w8a", attn_impl="fused", pad_tokens=24)
    jv = JViTClassifier(JViTSpec(**spec_kw), 5)
    tv = ViTClassifier(ViTSpec(**spec_kw), 5)
    load_tree(tv, jax_params["vit_w8a"]["params"])
    patches = _patches(frames, seed=3)
    ref = np.asarray(jv.apply(jax_params["vit_w8a"], jnp.asarray(patches)))
    with torch.no_grad():
        got = tv(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_vit_float_modes_raise_not_ported(jax_params, frames):
    """Formerly the refusal of float ViT modes; the fused float path
    (kernel E's plain version on the CPU) now runs and gives JAX's f32
    logits (bar of tests/test_fused_attention.py:43)."""
    spec_kw = dict(VIT_KW, attn_impl="fused")
    jv = JViTClassifier(JViTSpec(**spec_kw), 5)
    tv = ViTClassifier(ViTSpec(**spec_kw), 5)
    load_tree(tv, jax_params["vit"]["params"])
    patches = _patches(frames, seed=4)
    ref = np.asarray(jv.apply(jax_params["vit"], jnp.asarray(patches)))
    with torch.no_grad():
        got = tv(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("part", ["det", "vit", "vit_w8a"])
def test_tree_load_export_round_trip(jax_params, part):
    if part == "det":
        mod = YOLOv8(detect_spec(DetectConfig(**DET_KW)))
    else:
        quant = "w8a" if part == "vit_w8a" else "none"
        mod = ViTClassifier(ViTSpec(**VIT_KW, quant=quant, attn_impl="fused"),
                            5)
    load_tree(mod, jax_params[part]["params"])
    back = module_tree(mod)
    ref = jax.tree_util.tree_flatten_with_path(jax_params[part]["params"])[0]
    for path, leaf in ref:
        node = back
        for p in path:
            node = node[p.key]
        assert node.numpy().dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node.numpy(), leaf)


@pytest.mark.parametrize("part", ["det", "vit"])
def test_reload_remakes_derived_buffers(jax_params, frames, part):
    """The derived buffers (weights in the activation dtype, fused head
    convs, the int8 fold) are made at each load: a module loaded with one
    tree and then another computes what a fresh module loaded with the
    second does, and the derived buffers stay out of the exported tree."""
    dt = torch.bfloat16
    if part == "det":
        def make():
            return YOLOv8(detect_spec(DetectConfig(**DET_KW)), dtype=dt)
        tlb, _, _ = letterbox_fast(torch.from_numpy(frames), (64, 64),
                                   dtype=dt)
        x = blob(tlb).to(dt)
    else:
        def make():
            return ViTClassifier(ViTSpec(**VIT_KW, attn_impl="fused"), 5,
                                 dtype=dt)
        x = torch.from_numpy(_patches(frames, seed=5))
    tree = jax_params[part]["params"]
    other = jax.tree.map(lambda a: a * 0.5 if a.dtype.kind == "f" else a,
                         tree)
    mod, fresh = make(), make()
    with torch.no_grad():
        first = mod(x)
        load_tree(mod, other)
        got_other = mod(x)
        load_tree(mod, tree)
        got = mod(x)
        load_tree(fresh, tree)
        fresh.prepare()
        ref = fresh(x)
    leaves = [jax.tree.leaves(o) for o in (first, got_other, got, ref)]
    assert not all(torch.equal(a, b) for a, b in zip(leaves[1], leaves[2]))
    assert not all(torch.equal(a, b) for a, b in zip(leaves[0], leaves[2]))
    for g, r in zip(leaves[2], leaves[3]):
        assert torch.equal(g, r)
    assert len(jax.tree.leaves(module_tree(mod))) == \
        len(jax.tree.leaves(tree))


def test_tree_load_is_strict(jax_params):
    det = YOLOv8(detect_spec(DetectConfig(**DET_KW)))
    tree = dict(jax_params["det"]["params"])
    tree.pop("b0")
    with pytest.raises(KeyError, match="b0/conv"):
        load_tree(det, tree)


def test_port_native_init_matches_jax_tree_layout(jax_params):
    """init_tree draws f32 weights and pre-quantizes them: same paths,
    shapes and dtypes as the JAX init + prequantize_tree, and no all-zero
    int8 kernel (the trap of initializing a w8a tree directly)."""
    pipe = TwoStagePipeline(
        det_cfg=DetectConfig(**DET_KW),
        vit_spec=ViTSpec(**VIT_KW, quant="w8a", attn_impl="fused"),
        device="cpu")
    tree = init_tree(pipe, seed=3)
    for part, ref in (("det", jax_params["det"]), ("vit", jax_params["vit_w8a"])):
        flat_ref = {tuple(p.key for p in path): np.asarray(leaf) for path, leaf
                    in jax.tree_util.tree_flatten_with_path(ref)[0]}
        flat_got = {tuple(p.key for p in path): leaf for path, leaf
                    in jax.tree_util.tree_flatten_with_path(tree[part])[0]}
        assert set(flat_got) == set(flat_ref)
        for k, leaf in flat_got.items():
            assert tuple(leaf.shape) == flat_ref[k].shape, k
            assert leaf.dtype == torch.from_numpy(flat_ref[k]).dtype, k
            if k[-1] == "kernel_i8":
                assert bool((leaf != 0).any()), k
    head = tree["det"]["params"]["detect"]
    assert float(head["box0_2"]["bias"][0]) == 1.0
    np.testing.assert_allclose(
        head["cls0_2"]["bias"].numpy(),
        np.asarray(jax_params["det"]["params"]["detect"]["cls0_2"]["bias"]),
        rtol=1e-6)
    again = init_tree(pipe, seed=3)
    assert torch.equal(again["vit"]["params"]["model"]["pos_embed"],
                       tree["vit"]["params"]["model"]["pos_embed"])


def test_entry_points_default_to_cuda():
    """Without device="cpu" an entry point asks for the card; on a machine
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TwoStagePipeline(det_cfg=DetectConfig(**DET_KW),
                         vit_spec=ViTSpec(**VIT_KW, quant="w8a",
                                          attn_impl="fused"))


def test_conv_f32_tf32_switch_is_thread_safe(monkeypatch):
    """conv_f32 sets cuDNN's process-wide TF32 flag around its conv: from
    several threads at once, with mixed operands_in_bf16, every conv must
    see its own call's setting, and the flag must end as it started.  The
    recording conv sleeps, so that unlocked set / restore pairs would
    interleave."""
    import threading
    import time

    from yolov8_vit_tpu_torch.models import yolov8 as y
    seen, real_conv = [], torch.nn.functional.conv2d

    def recording_conv(x, w, *args, **kw):
        want = bool(x[0, 0, 0, 0])
        time.sleep(0.002)
        seen.append((want, torch.backends.cudnn.allow_tf32))
        return real_conv(x, w, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording_conv)
    start = torch.backends.cudnn.allow_tf32
    w = torch.ones(1, 1, 1, 1)

    def worker(i):
        for j in range(10):
            bf16 = (i + j) % 2 == 0
            y.conv_f32(torch.full((1, 1, 2, 2), float(bf16)), w,
                       operands_in_bf16=bf16)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == 60
    assert all(want == flag for want, flag in seen), seen
    assert torch.backends.cudnn.allow_tf32 == start
