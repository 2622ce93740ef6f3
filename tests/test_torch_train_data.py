"""PyTorch port, the classifier's dataset (train/dataset.py) against the
JAX package's on the synthetic VOC set of tests/test_train_pipeline.py:
the same records under the same `random.Random` seed, the same crops
under the same numpy seed, and two epochs of train and eval batches with
equal labels and images within the augment bars of
tests/test_torch_augment.py (equal but where the elastic transform ran:
99.9 % within 1e-5, all within 0.07)."""
import random

import numpy as np
import pytest

from yolov8_vit_tpu.config import CFG as JCFG
from yolov8_vit_tpu.train import dataset as J

from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.train import dataset as P

from test_train_pipeline import _make_dataset


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    _make_dataset(str(root / "train_xml"), n_per_class=4,
                  classes=("good", "broke", "lose", "circle"))
    _make_dataset(str(root / "valid_xml"), n_per_class=2)
    return [str(root / "train_xml")], [str(root / "valid_xml")]


def test_split_by_circle_matches_jax(dirs):
    for d in dirs:
        assert P.split_by_circle(d, random.Random(3)) == \
            J.split_by_circle(d, random.Random(3))


def test_crop_record_matches_jax(dirs):
    obj, cir = P.split_by_circle(dirs[0], random.Random(0))
    for i, row in enumerate(obj + cir):
        for training in (True, False):
            np.testing.assert_array_equal(
                P.crop_record(row, training, np.random.default_rng(i)),
                J.crop_record(row, training, np.random.default_rng(i)))


@pytest.mark.parametrize("training", [True, False])
def test_batches_match_jax(dirs, training):
    kw = dict(train_bs=3, img_size=(64, 64), train_path=dirs[0],
              valid_path=dirs[1])
    p_tr, p_va = P.build_dataloaders(CFG(**kw), seed=5)
    j_tr, j_va = J.build_dataloaders(JCFG(**kw), seed=5)
    pd, jd = (p_tr, j_tr) if training else (p_va, j_va)
    assert pd.rate == jd.rate and len(pd) == len(jd)
    n = 0
    for epoch in (1, 2):
        for (pi, po), (ji, jo) in zip(
                pd.batches(3, epoch=epoch, drop_last=training),
                jd.batches(3, epoch=epoch, drop_last=training),
                strict=True):
            np.testing.assert_array_equal(po, jo)
            err = np.abs(pi - ji)
            assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 0.07
            if not training:
                np.testing.assert_array_equal(pi, ji)
            n += len(pi)
    assert n == 2 * (len(pd) - len(pd) % 3 if training else len(pd))
