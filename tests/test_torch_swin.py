"""PyTorch port, the SwinV2 classifier (models/swin.py) and its window
attention (mt::window_attn's plain version), held against the plain
reference tests/swin_ref.py on the CPU in float32.

The tiny model: img 32, patch 4, embed 16, depths (2, 2, 2, 2), heads
(1, 2, 4, 8), window 4.  Its grids are 8, 4, 2 and 1: stage 1 has a
shifted block (shift 2), the later stages take the grid as the window and
no shift, as the published model's last two stages do.  Every leaf is
random: biases, LayerNorm scales, the continuous position bias MLP and the
logit scales (scales 2 to 12: a scale s multiplies the logits' rounding
errors by s / 4 a block, so scales near the clamp's 100 would amplify f32
rounding past any tolerance over eight blocks; the clamp itself is held in
the one-block test of the operator, at scales 7.4 and 148).

Tolerance 1e-5 on the logits: both sides compute in f32, the port with
its int8-folded patch embedding and its own window partition order, so
their sums round differently by a few f32 ulps of values of order 1; a
copy of the reference with any one mechanism broken is off by far more.
"""
import numpy as np
import pytest
import torch

import swin_ref
from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.swin import SwinV2Classifier, SwinV2Spec
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.ops import attention
from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
from yolov8_vit_tpu_torch.weights import (_leaves, init_tree, load_tree,
                                          load_pipeline_tree, module_tree)

TINY = SwinV2Spec(img_size=32, patch=4, embed_dim=16, depths=(2, 2, 2, 2),
                  heads=(1, 2, 4, 8), window=4, backbone_classes=40)
REF_CFG = {"patch_size": 4, "depths": [2, 2, 2, 2],
           "num_heads": [1, 2, 4, 8], "window_size": 4}
TOL = 1e-5
MECHANISMS = ["shift", "bias", "cosine", "postnorm", "merge"]


def _random_tree(spec, seed=0):
    """Every leaf of a SwinV2Classifier tree random."""
    g = torch.Generator().manual_seed(seed)
    tree = module_tree(SwinV2Classifier(spec, num_classes=5))

    def fill(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v, path + (k,))
                continue
            name = ".".join(path + (k,))
            if name.endswith("logit_scale"):     # scales 2 to 12
                t = torch.rand(v.shape, generator=g) * np.log(6) + np.log(2)
            elif "norm" in name and k == "weight":
                t = 1.0 + 0.3 * torch.randn(v.shape, generator=g)
            elif k == "bias" or name.endswith(("q_bias", "v_bias")):
                t = 0.1 * torch.randn(v.shape, generator=g)
            else:
                fan_in = v.shape[0] if k == "kernel" else v[0].numel()
                t = torch.randn(v.shape, generator=g) / fan_in ** 0.5
            node[k] = t
    fill(tree, ())
    return tree


def _flat(tree):
    return {".".join(p): v for p, v in _leaves(tree)}


def _crops(k, seed=1):
    """int8 crops in the port's patch layout and the same pixels as [-1,
    1] NHWC images for the reference."""
    rng = np.random.default_rng(seed)
    px = torch.from_numpy(rng.integers(0, 256, (k, 32, 32, 3), np.uint8))
    i8 = (px.to(torch.int16) - 128).to(torch.int8)
    patches = i8.reshape(k, 8, 4, 8, 4, 3).permute(0, 1, 3, 2, 4, 5) \
        .reshape(k, 64, 4, 12)
    return patches, px.to(torch.float32) / 127.5 - 1.0


@pytest.fixture(scope="module")
def tiny():
    tree = _random_tree(TINY)
    model = load_tree(SwinV2Classifier(TINY, num_classes=5), tree)
    patches, img = _crops(6)
    with torch.no_grad():
        got = model(patches)
    return tree, got, img


def _gap(got, want):
    return float((got - want).abs().max())


def test_spec_windows_and_shifts():
    assert [TINY.window_shift(i, j) for i in range(4) for j in range(2)] \
        == [(4, 0), (4, 2), (4, 0), (4, 0), (2, 0), (2, 0), (1, 0), (1, 0)]
    b = SwinV2Spec()
    assert [b.window_shift(i, 1) for i in range(4)] == [
        (16, 8), (16, 8), (16, 0), (8, 0)]
    assert b.windows_per_crop() == 2 * 16 + 2 * 4 + 18 + 2


def test_tree_names_are_timms():
    names = set(_flat(module_tree(SwinV2Classifier(TINY))))
    for key in ("model.patch_embed.proj.weight", "model.patch_embed.norm.bias",
                "model.layers.1.downsample.reduction.weight",
                "model.layers.1.downsample.norm.weight",
                "model.layers.0.blocks.1.attn.logit_scale",
                "model.layers.0.blocks.1.attn.q_bias",
                "model.layers.0.blocks.1.attn.cpb_mlp.0.weight",
                "model.layers.0.blocks.1.attn.cpb_mlp.2.weight",
                "model.layers.3.blocks.0.mlp.fc2.bias",
                "model.head.fc.weight", "fc2.kernel"):
        assert key in names, key
    assert not any("downsample" in n for n in names
                   if n.startswith("model.layers.0."))
    assert "model.layers.0.blocks.0.attn.cpb_mlp.2.bias" not in names


def test_plain_path_matches_reference(tiny):
    tree, got, img = tiny
    want = swin_ref.classifier(img, _flat(tree), REF_CFG)
    assert _gap(got, want) <= TOL, _gap(got, want)


@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_broken_mechanism_fails_the_tolerance(tiny, mechanism):
    """The reference holds the port within TOL; the same reference with
    one mechanism broken does not."""
    tree, got, img = tiny
    p = _flat(tree)
    assert _gap(got, swin_ref.classifier(img, p, REF_CFG)) <= TOL
    broken = swin_ref.classifier(img, p, REF_CFG, broken=mechanism)
    assert _gap(got, broken) > 100 * TOL, (mechanism, _gap(got, broken))


@pytest.mark.parametrize("shift", [0, 2])
def test_window_op_matches_reference_attention(shift):
    """mt::window_attn on the CPU (the plain version) against the
    reference's attention (proj the identity) on one block's input."""
    g = torch.Generator().manual_seed(3)
    b, hw, heads, ws = 2, 8, 2, 4
    c = 16 * heads
    p = {"a.q_bias": torch.randn(c, generator=g) / 4,
         "a.v_bias": torch.randn(c, generator=g) / 4,
         "a.qkv.weight": torch.randn(3 * c, c, generator=g) / c ** 0.5,
         "a.proj.weight": torch.eye(c), "a.proj.bias": torch.zeros(c),
         "a.logit_scale": torch.tensor([2.0, 5.0]).reshape(2, 1, 1),  # clamped
         "a.cpb_mlp.0.weight": torch.randn(512, 2, generator=g),
         "a.cpb_mlp.0.bias": torch.randn(512, generator=g),
         "a.cpb_mlp.2.weight": torch.randn(heads, 512, generator=g) / 20}
    x = torch.randn(b, hw, hw, c, generator=g)
    want = swin_ref.window_attention(x, p, "a", heads, ws, shift)
    qkv = torch.nn.functional.linear(x, p["a.qkv.weight"], torch.cat(
        [p["a.q_bias"], torch.zeros(c), p["a.v_bias"]]))
    hid = torch.relu(attention.relative_coords(ws) @ p["a.cpb_mlp.0.weight"].T
                     + p["a.cpb_mlp.0.bias"])
    table = (16 * torch.sigmoid(hid @ p["a.cpb_mlp.2.weight"].T)).T
    scale = p["a.logit_scale"].clamp(max=np.log(100.0)).exp().reshape(-1)
    got = attention.window_attention(qkv, table, scale, window=ws,
                                     shift=shift, heads=heads)
    assert _gap(got, want) <= TOL


def test_shift_mask_is_timms():
    m = attention.shift_mask(8, 8, 4, 2)
    assert torch.equal(m, swin_ref.attn_mask(8, 8, 4, 2))
    assert not m[0].any() and m[3].any()


DENSE = dict(input_size=(64, 64), variant="n", nms_topk=16, nms_conf=1e-6,
             conf_second=1e-6, nms_iou=0.995, custom_nms_iou=0.999)


@pytest.fixture(scope="module")
def pipeline():
    pipe = TwoStagePipeline(det_cfg=DetectConfig(**DENSE), vit_spec=TINY,
                            classify_budget=2, device="cpu")
    tree = densify_detect_head(init_tree(pipe, seed=4))
    tree["vit"] = {"params": _random_tree(TINY, seed=5)}
    return load_pipeline_tree(pipe, tree), tree


def _inflated(boxes, w, h):
    ib = np.round(boxes).astype(np.int64)
    ex = ((ib[:, 2] - ib[:, 0]) // 10) // 2
    ey = ((ib[:, 3] - ib[:, 1]) // 10) // 2
    return np.stack([np.maximum(0, ib[:, 0] - ex),
                     np.maximum(0, ib[:, 1] - ey),
                     np.minimum(w, ib[:, 2] + ex),
                     np.minimum(h, ib[:, 3] + ey)], -1)


def _ref_crops(frame, boxes, size=32):
    """Nearest-resized crops in [-1, 1] (the service's contract)."""
    h, w = frame.shape[:2]
    out = []
    for x1, y1, x2, y2 in boxes:
        bw, bh = max(x2 - x1, 1), max(y2 - y1, 1)
        d = np.arange(size)
        sx = np.clip(x1 + np.minimum(d * bw // size, bw - 1), 0, w - 1)
        sy = np.clip(y1 + np.minimum(d * bh // size, bh - 1), 0, h - 1)
        out.append(frame[sy[:, None], sx[None, :]])
    return torch.from_numpy(np.stack(out)).float() / 127.5 - 1.0


def test_cpu_forward_captures_no_graph(pipeline):
    """Only the card replays the forward as a CUDA graph: a CPU forward
    captures none."""
    model = pipeline[0].vit
    with torch.no_grad():
        logits = model(torch.zeros((2, 64, 4, 12), dtype=torch.int8))
    assert logits.shape == (2, 5) and model._graphs == {}


def test_two_stage_pipeline_with_tiny_swin(pipeline):
    """TwoStagePipeline's fused forward classifies each kept box's crop as
    the reference classifies the same crop."""
    pipe, tree = pipeline
    frames = np.random.default_rng(6).integers(0, 256, (3, 96, 128, 3),
                                               np.uint8)
    out = pipe(torch.from_numpy(frames))
    p = _flat(tree["vit"]["params"])
    done = 0
    for f in range(3):
        k = np.nonzero(out["final_valid"][f].numpy()
                       & (out["cls_labels"][f].numpy() >= 0))[0]
        if not len(k):
            continue
        cb = _inflated(out["boxes"][f].numpy()[k], 128, 96)
        logits = swin_ref.classifier(_ref_crops(frames[f], cb), p, REF_CFG)
        probs = torch.softmax(logits, -1)
        np.testing.assert_array_equal(out["cls_labels"][f].numpy()[k],
                                      logits.argmax(-1).numpy())
        np.testing.assert_allclose(out["cls_scores"][f].numpy()[k],
                                   probs.max(-1).values.numpy(), atol=TOL)
        done += len(k)
    assert done == 6        # two slots a frame, all filled on dense frames


def test_runner_counts_the_windows(pipeline):
    """profile["cls_windows"]: the fused steps' slots and the ladder's
    chunks times the windows of a crop."""
    pipe, _ = pipeline
    runner = BatchRunner(pipe, max_batch=2)
    frames = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 96, 128, 3), np.uint8))
    prof = {}
    runner.run_device_batches([frames, frames], profile=prof)
    wpc = TINY.windows_per_crop()
    assert wpc == 2 * 4 + 2 + 2 + 2
    chunks = prof["ladder_chunks"]
    assert chunks > 0
    ladder = prof["cls_windows"] - 2 * 2 * 2 * wpc
    assert ladder % (2 * 2 * wpc) == 0 and ladder >= chunks * 4 * wpc
