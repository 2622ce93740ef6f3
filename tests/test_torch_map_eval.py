"""PyTorch port, detection mAP (yolov8_vit_tpu_torch/train/map_eval.py):
`evaluate_map` equal (==) to the JAX package's on the same seeded
predictions and ground truth: near-duplicates of true boxes, wrong
classes, classes absent from the ground truth, scores on both sides of
the confidence threshold, images without predictions or without boxes."""
import numpy as np
import pytest

from yolov8_vit_tpu.train import map_eval as j_map

from yolov8_vit_tpu_torch.train import map_eval


def _dataset(seed: int, n_img: int = 12, nc: int = 5):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(n_img):
        m = int(rng.integers(0, 6)) if i % 5 else 0       # images w/o gt
        xy = rng.uniform(0, 500, (m, 2))
        gt_boxes = np.concatenate([xy, xy + rng.uniform(10, 120, (m, 2))],
                                  1).astype(np.float32)
        # class 4 never appears in the ground truth
        gt_labels = rng.integers(0, nc - 1, m)
        gts.append({"boxes": gt_boxes, "labels": gt_labels})
        rows, labels = [], []
        for b, lab in zip(gt_boxes, gt_labels):
            for _ in range(int(rng.integers(0, 3))):      # duplicates
                rows.append(b + rng.normal(0, 6, 4))
                labels.append(lab if rng.random() < 0.8   # wrong classes
                              else rng.integers(0, nc))
        for _ in range(int(rng.integers(0, 4))):          # background
            p = rng.uniform(0, 550, 2)
            rows.append(np.concatenate([p, p + rng.uniform(5, 80, 2)]))
            labels.append(rng.integers(0, nc))
        if i % 7 == 3:                                    # no predictions
            rows, labels = [], []
        scores = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
        if len(scores) > 2:
            scores[1] = scores[0]                         # score ties
        preds.append({"boxes": np.asarray(rows, np.float32).reshape(-1, 4),
                      "scores": scores,
                      "labels": np.asarray(labels, np.int64)})
    return preds, gts


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("conf", [0.0, 0.25, 0.6])
def test_evaluate_map_equals_jax(seed, conf):
    preds, gts = _dataset(seed)
    got = map_eval.evaluate_map(preds, gts, 5, conf_threshold=conf)
    want = j_map.evaluate_map(preds, gts, 5, conf_threshold=conf)
    assert got == want
    assert 0.0 < got["map50"] < 1.0


@pytest.mark.parametrize("case", ["perfect", "wrong_class", "empty_gt"])
def test_edge_cases_equal_jax(case):
    box = np.array([[10, 10, 50, 50]], np.float32)
    gt = {"boxes": box, "labels": np.array([0])}
    pred = {"boxes": box, "scores": np.array([0.9], np.float32),
            "labels": np.array([0])}
    if case == "wrong_class":
        pred["labels"] = np.array([1])
    if case == "empty_gt":
        gt = {"boxes": np.zeros((0, 4), np.float32),
              "labels": np.zeros(0, np.int64)}
    got = map_eval.evaluate_map([pred], [gt], 2)
    assert got == j_map.evaluate_map([pred], [gt], 2)
    assert got["map50"] == {"perfect": 1.0, "wrong_class": 0.0,
                            "empty_gt": 0.0}[case]
