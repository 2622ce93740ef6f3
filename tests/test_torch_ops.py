"""PyTorch port, geometry ops and NMS (plain versions of kernels A and B)
held against the JAX package on the same numpy inputs.

Integer and geometry outputs must be equal; NMS outputs must be
index-exact and bit-equal.  The wrappers run their plain versions here
because every tensor lies on the CPU.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.ops import boxes as jboxes
from yolov8_vit_tpu.ops import crop as jcrop
from yolov8_vit_tpu.ops import dfl as jdfl
from yolov8_vit_tpu.ops.letterbox import letterbox_fast as j_letterbox_fast
from yolov8_vit_tpu.ops.letterbox import letterbox_params as j_lb_params
from yolov8_vit_tpu.ops.nms import area_sorted_nms as j_area_nms
from yolov8_vit_tpu.ops.nms import efficient_nms_scan as j_nms
from masked_nms_oracle import efficient_nms as masked_oracle
from test_nms_scan import _dense_scene, torch_efficient_nms, torch_greedy_nms

from yolov8_vit_tpu_torch.ops import boxes, crop, dfl, letterbox, nms


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("in_hw,out_hw", [((96, 128), (64, 64)),
                                          ((720, 1280), (640, 640)),
                                          ((640, 640), (640, 640)),
                                          ((481, 333), (640, 640))])
def test_letterbox_params_equal(in_hw, out_hw):
    assert letterbox.letterbox_params(in_hw, out_hw) == \
        j_lb_params(in_hw, out_hw)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (50, 70)])
def test_letterbox_fast_f32(hw):
    """Geometry (ratio, dwdh, pad bands) exact; interpolated pixels agree
    to f32 rounding (the two-term sums may contract differently)."""
    img = np.random.default_rng(0).integers(0, 256, (2, *hw, 3), np.uint8)
    ja, jr, jd = j_letterbox_fast(jnp.asarray(img), (64, 64),
                                    dtype=jnp.float32)
    ta, tr, td = letterbox.letterbox_fast(_t(img), (64, 64),
                                          dtype=torch.float32)
    assert (jr, jd) == (tr, td)
    ja = np.asarray(ja)
    assert ta.shape == ja.shape and ta.dtype == torch.float32
    np.testing.assert_array_equal(ta.numpy() == 114, ja == 114)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-3)
    if hw == (64, 64):
        np.testing.assert_array_equal(ta.numpy(), ja)


def test_make_anchors_and_dfl():
    a_t, s_t = dfl.make_anchors((64, 96), (8, 16, 32))
    a_j, s_j = jdfl.make_anchors((64, 96), (8, 16, 32))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    dist = np.random.default_rng(1).normal(
        0, 3, (2, a_t.shape[0], 64)).astype(np.float32)
    got = dfl.dfl_decode(_t(dist), a_t, s_t, 16).numpy()
    ref = np.asarray(jdfl.dfl_decode(jnp.asarray(dist), a_j, s_j, 16))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_box_ops_exact():
    rng = np.random.default_rng(2)
    b = np.sort(rng.uniform(-20, 700, (3, 16, 2, 2)), axis=2) \
        .transpose(0, 1, 3, 2).reshape(3, 16, 4).astype(np.float32)
    np.testing.assert_array_equal(boxes.box_area(_t(b)).numpy(),
                                  np.asarray(jboxes.box_area(jnp.asarray(b))))
    got = boxes.unletterbox_boxes(_t(b), 0.5, (0.0, 80.0)).numpy()
    ref = np.asarray(jboxes.unletterbox_boxes(jnp.asarray(b), 0.5,
                                              (0.0, 80.0)))
    np.testing.assert_array_equal(got, ref)
    ib = np.round(np.clip(b, 0, 640)).astype(np.int32).astype(np.float32)
    wh = np.asarray([[640, 480]], np.float32)
    got = boxes.inflate_boxes(_t(ib), _t(wh)).numpy()
    ref = np.asarray(jboxes.inflate_boxes(jnp.asarray(ib), jnp.asarray(wh)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("patch,size", [(8, 32), (16, 224)])
def test_crop_to_patches_i8_bytes_equal(patch, size):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 50, 70, 3), np.uint8)
    k = 12
    x1 = rng.integers(-5, 60, k)
    y1 = rng.integers(-5, 40, k)
    bx = np.stack([x1, y1, x1 + rng.integers(0, 40, k),
                   y1 + rng.integers(0, 30, k)], -1).astype(np.int32)
    bx[0] = [10, 10, 10, 10]                  # degenerate 0-px box
    si = rng.integers(0, 3, k).astype(np.int32)
    got = crop.crop_to_patches_i8(_t(imgs), _t(si), _t(bx), (size, size),
                                  patch)
    ref = np.asarray(jcrop.crop_to_patches_i8(
        jnp.asarray(imgs), jnp.asarray(si), jnp.asarray(bx), (size, size),
        patch))
    assert got.dtype == torch.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _assert_nms_equal(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_kernel_a_plain_dense_vs_jax_and_torch(seed, ties):
    """>=1,500 above-threshold candidates: index-exact against the JAX
    kernel (interpret mode) and the independent torch greedy."""
    b, s = _dense_scene(2048, seed, 1500, ties)
    got = nms.efficient_nms_scan(_t(b), _t(s))
    _assert_nms_equal(got, j_nms(jnp.asarray(b), jnp.asarray(s)))
    ref = torch_efficient_nms(b, s, 0.65, 0.25, 100)
    assert int(got[0]) == ref[0]
    _assert_nms_equal(got[1:], ref[1:])


@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_a_plain_vs_masked_oracle(seed):
    b, s = _dense_scene(2048, seed, 300)
    got = nms.efficient_nms_scan(_t(b), _t(s))
    _assert_nms_equal(got, masked_oracle(jnp.asarray(b), jnp.asarray(s),
                                         pre_topk=1024))


def test_kernel_a_plain_batched_boundary_iou():
    """Batched images with exact score ties and pairs at IoU exactly .65
    (13/20, not suppressed) and just above it (13.5/20)."""
    bb, ss = [], []
    for seed in range(3):
        b, s = _dense_scene(1024, 20 + seed, 400, ties=True)
        for p, w2 in enumerate((6.5, 6.75, 6.5)):
            i = 2 * p
            b[i] = [40.0 * p, 700, 40.0 * p + 10, 702]
            b[i + 1] = [40.0 * p, 700, 40.0 * p + w2, 702]
            s[i, 2] = s[i + 1, 2] = 0.875
        bb.append(b)
        ss.append(s)
    bb, ss = np.stack(bb), np.stack(ss)
    got = nms.efficient_nms_scan(_t(bb), _t(ss))
    ref = jax.vmap(j_nms)(jnp.asarray(bb), jnp.asarray(ss))
    _assert_nms_equal(got, ref)
    for i in range(3):
        tref = torch_efficient_nms(bb[i], ss[i], 0.65, 0.25, 100)
        assert int(got[0][i]) == tref[0]
        _assert_nms_equal([g[i] for g in got[1:]], tref[1:])


def test_kernel_a_multilabel_and_padding():
    bx = np.array([[100, 100, 200, 200], [400, 400, 480, 480]], np.float32)
    sc = np.zeros((2, 5), np.float32)
    sc[0, 1], sc[0, 3], sc[1, 2] = 0.6, 0.4, 0.5
    got = nms.efficient_nms_scan(_t(bx), _t(sc))
    assert int(got[0]) == 3
    _assert_nms_equal(got, j_nms(jnp.asarray(bx), jnp.asarray(sc)))
    assert (got[3][3:] == -1).all() and (got[2][3:] == 0).all()


@pytest.mark.parametrize("seed", [7, 8, 9, 10])
def test_kernel_b_plain_vs_jax_both_impls(seed):
    """Second-stage NMS with exact area ties and a pair at IoU exactly .45:
    equal to both JAX impls and to the torch greedy."""
    rng = np.random.default_rng(seed)
    n = 100
    centers = rng.normal(150, 40, (n, 2))
    wh = rng.choice([20, 40, 40, 60], (n, 2)).astype(np.float64)
    bx = np.round(np.concatenate([centers - wh / 2, centers + wh / 2],
                                 -1)).astype(np.float32)
    bx[0], bx[1] = [0, 300, 10, 302], [0, 300, 4.5, 302]   # IoU exactly .45
    sc = (np.round(rng.uniform(0, 1, n) * 8) / 8).astype(np.float32)
    sc[:2] = 0.875
    valid = rng.random(n) > 0.2
    valid[:2] = True
    got = nms.area_sorted_nms(_t(bx), _t(sc), _t(valid))
    for impl in ("scan", "argsort"):
        ref = j_area_nms(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(valid),
                         impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=impl)
    v = valid & (sc > 0.35)
    key = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
    idx = torch.nonzero(torch.from_numpy(v)).flatten()
    keep = torch_greedy_nms(_t(bx)[idx], _t(key.astype(np.float32))[idx], 0.45)
    ref = np.zeros(n, bool)
    ref[idx[torch.as_tensor(keep, dtype=torch.long)].numpy()] = True
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kernel_b_plain_batched():
    rng = np.random.default_rng(9)
    bx = np.round(rng.uniform(0, 200, (4, 100, 2))).astype(np.float32)
    bx = np.concatenate([bx, bx + rng.choice([10, 30], (4, 100, 2))], -1) \
        .astype(np.float32)
    sc = rng.uniform(0, 1, (4, 100)).astype(np.float32)
    valid = rng.random((4, 100)) > 0.3
    got = nms.area_sorted_nms(_t(bx), _t(sc), _t(valid))
    ref = jax.vmap(j_area_nms)(jnp.asarray(bx), jnp.asarray(sc),
                               jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

