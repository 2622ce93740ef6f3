"""PyTorch port, the classifier's training (yolov8_vit_tpu_torch/train/,
utils/checkpoint.py): each piece held against the JAX package's on the
same inputs, made from a numpy seed, and the same params (the JAX init,
carried over with `weights.load_tree`), on the tiny spec of
tests/test_train_pipeline.py.

Bars: losses atol 1e-6; the schedule equal; the train step's loss rtol
1e-5, step 1's gradients within 1e-4 of each leaf's largest |g|, every
param after 3 steps atol 1e-5 (f32 forward and backward in two
frameworks: sums in another order), `correct` equal, the trained leaves
equal to JAX's params tree; the eval step's loss rtol 1e-6 with correct
and the confusion matrix equal; the port's SGD against the optax chain
on given gradients atol 1e-7; a trained model reloaded through
module_tree / load_tree bit-equal; the exported engine under JAX's Engine
within 1e-5 of the port's logits.
"""
import dataclasses
import json
import os

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.config import CFG as JCFG
from yolov8_vit_tpu.models.vit import ViTClassifier as JViTClassifier
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.runtime.engine import Engine as JEngine
from yolov8_vit_tpu.runtime.engine import save_engine as j_save_engine
from yolov8_vit_tpu.train import losses as j_losses
from yolov8_vit_tpu.train import vit_train as j_vit_train
from yolov8_vit_tpu.train.ema import EMA as JEMA
from yolov8_vit_tpu.train.schedule import cosine_anneal_schedule as j_sched

from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.train import classify, losses
from yolov8_vit_tpu_torch.train.ema import EMA
from yolov8_vit_tpu_torch.train.schedule import cosine_anneal_schedule
from yolov8_vit_tpu_torch.train.vit_train import (ViTTrainer, make_eval_step,
                                                  make_optimizer,
                                                  make_train_step)
from yolov8_vit_tpu_torch.utils.checkpoint import TrainCheckpointer
from yolov8_vit_tpu_torch.weights import load_tree, module_tree

from test_train_pipeline import _make_dataset

TINY_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
               backbone_classes=40)
TINY = ViTSpec(**TINY_KW)
LRS = (1e-2, 5e-3, 1e-3)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def jparams():
    p = jax.jit(JViTClassifier(JViTSpec(**TINY_KW), 5).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return jax.tree.map(np.asarray, p)


def _batch(seed, n=4, nc=5):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    return imgs, np.eye(nc, dtype=np.float32)[rng.integers(0, nc, n)]


def _port(jparams, cfg=None):
    trainer = ViTTrainer(cfg=cfg or CFG(), spec=TINY, device="cpu",
                         log_fn=lambda *a: None)
    return trainer, *trainer.init(jparams["params"])


def _param_tree(model, attr=None) -> dict:
    """{path: array} of the training form's parameters (or their .grad)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for n, p in mod.named_parameters(recurse=False):
            t = p if attr is None else getattr(p, attr)
            path = tuple(mod_name.split(".")) + (n,) if mod_name else (n,)
            out[path] = t.detach().numpy()
    return out


# ---- losses, schedule --------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(8, 5))).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    lt, ot = torch.from_numpy(logits), torch.from_numpy(onehot)
    lj, oj = jnp.asarray(logits), jnp.asarray(onehot)
    for name in ("focal_loss", "label_smoothing_ce", "combined_loss"):
        np.testing.assert_allclose(
            float(getattr(losses, name)(lt, ot)),
            float(getattr(j_losses, name)(lj, oj)), atol=1e-6, err_msg=name)


def test_schedule_equals_jax():
    for nb in (1, 3, 10):
        for t in range(25):
            assert cosine_anneal_schedule(t, nb, 1e-4) == j_sched(t, nb, 1e-4)


# ---- optimizer, train and eval steps -------------------------------------------
def test_sgd_equals_optax_chain():
    """torch.optim.SGD(momentum .9, dampening 0, weight decay 1e-3) against
    add_decayed_weights -> trace(.9) -> -lr * update on given gradients."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in LRS]
    opt = j_vit_train.make_optimizer(JCFG())
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt.init(pj)
    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    sgd = make_optimizer(CFG(), model)
    for lr, g in zip(LRS, grads):
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = optax.apply_updates(pj, jax.tree.map(lambda u: -lr * u, upd))
        for k, p in model.items():
            p.grad = torch.from_numpy(g[k])
        sgd.param_groups[0]["lr"] = lr
        sgd.step()
    for k, p in model.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]),
                                   atol=1e-7, rtol=1e-6)


def test_train_step_matches_jax(jparams):
    jm = JViTClassifier(JViTSpec(**TINY_KW), 5)
    jopt = j_vit_train.make_optimizer(JCFG())
    jstep = jax.jit(j_vit_train.make_train_step(jm, jopt))
    _, model, opt = _port(jparams)
    step = make_train_step(model, opt)
    # the trained set: every leaf of JAX's params tree, nothing else
    assert set(_param_tree(model)) == {
        p[1:] for p, _ in _flat(jparams)}
    pj, state = jparams, jopt.init(jparams)
    for i, lr in enumerate(LRS):
        imgs, onehot = _batch(10 + i)
        if i == 0:
            gj = jax.grad(lambda p: j_losses.combined_loss(
                jm.apply(p, jnp.asarray(imgs)), jnp.asarray(onehot)))(pj)
        pj, state, lj, cj = jstep(pj, state, jnp.asarray(imgs),
                                  jnp.asarray(onehot), jnp.float32(lr))
        lt, ct = step(torch.from_numpy(imgs), torch.from_numpy(onehot), lr)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        assert int(ct) == int(cj)
        if i == 0:
            got = _param_tree(model, "grad")
            for path, g in _flat(gj["params"]):
                bar = 1e-4 * np.abs(g).max()
                np.testing.assert_allclose(got[path], g, atol=bar, rtol=0,
                                           err_msg=str(path))
    got = _param_tree(model)
    for path, p in _flat(pj["params"]):
        np.testing.assert_allclose(got[path], p, atol=1e-5, rtol=0,
                                   err_msg=str(path))


def test_eval_step_matches_jax(jparams):
    jm = JViTClassifier(JViTSpec(**TINY_KW), 5)
    jeval = jax.jit(j_vit_train.make_eval_step(jm, 5))
    _, model, _ = _port(jparams)
    estep = make_eval_step(model, 5)
    imgs, onehot = _batch(20, n=16)
    lj, cj, mj = jeval(jparams, jnp.asarray(imgs), jnp.asarray(onehot))
    lt, ct, mt = estep(torch.from_numpy(imgs), torch.from_numpy(onehot))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert int(ct) == int(cj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_trained_model_reloads_bit_equal(jparams):
    """After an optimizer step nothing is stale: the trained leaves, loaded
    into a fresh serving-form model, give the trained model's logits."""
    _, model, opt = _port(jparams)
    imgs, onehot = _batch(30)
    make_train_step(model, opt)(torch.from_numpy(imgs),
                                torch.from_numpy(onehot), 1e-2)
    fresh = load_tree(ViTClassifier(TINY, 5), module_tree(model))
    x = torch.from_numpy(_batch(31)[0])
    with torch.no_grad():
        assert torch.equal(fresh(x), model(x))
    before = ViTClassifier(TINY, 5)
    load_tree(before, jparams["params"])
    with torch.no_grad():
        assert not torch.equal(before(x), model(x))


def test_train_form_refuses_serving_specs():
    for kw in (dict(quant="w8a", attn_impl="fused"),
               dict(attn_impl="fused")):
        with pytest.raises(ValueError, match="training form"):
            ViTClassifier(ViTSpec(**TINY_KW, **kw), 5).train_form()
    with pytest.raises(ValueError, match="training form"):
        ViTClassifier(TINY, 5, dtype=torch.bfloat16).train_form()


def test_trainer_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ViTTrainer(cfg=CFG(), spec=TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        classify.retrain(cfg=CFG(epoch=0), workdir="/nonexistent")


# ---- fit through classify.train ------------------------------------------------
@pytest.fixture(autouse=True)
def _tiny_spec(monkeypatch):
    monkeypatch.setattr(classify, "_spec_for", lambda cfg: TINY)


def _cfg(tmp_path, **kw):
    return dataclasses.replace(
        CFG(train_bs=4, epoch=2, lr=3e-3,
            train_path=[str(tmp_path / "train_xml")],
            valid_path=[str(tmp_path / "valid_xml")],
            img_size=(32, 32)), **kw)


def test_fit_matches_jax_and_exports_engine_jax_loads(tmp_path,
                                                      monkeypatch):
    """classify.train in both packages on the same data from the same init
    (JAX's, at cfg.seed): the same result.json rows (accuracies equal,
    val loss rtol 1e-4), the best engine exported, and the final params
    under JAX's Engine within 1e-5 of the port's logits."""
    from yolov8_vit_tpu.train import classify as j_classify
    monkeypatch.setattr(j_classify, "_spec_for",
                        lambda cfg: JViTSpec(**TINY_KW))
    _make_dataset(str(tmp_path / "train_xml"), n_per_class=8)
    _make_dataset(str(tmp_path / "valid_xml"), n_per_class=3)
    cfg = _cfg(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        os.makedirs(d)
    j_cfg = JCFG(**dataclasses.asdict(cfg))
    _, j_best = j_classify.train(j_cfg, log=True, workdir=str(jdir),
                                 log_fn=lambda *a: None)
    init = jax.jit(JViTClassifier(JViTSpec(**TINY_KW), 5).init)(
        jax.random.PRNGKey(cfg.seed), jnp.zeros((1, 32, 32, 3)))
    model, best = classify.train(
        cfg, log=True, workdir=str(pdir), log_fn=lambda *a: None,
        init_params=jax.tree.map(np.asarray, init), device="cpu")
    rows = json.load(open(pdir / "train/result.json"))
    j_rows = json.load(open(jdir / "train/result.json"))
    assert set(rows) == set(j_rows) == {"1", "2"}
    for k, r in rows.items():
        assert set(r) == set(j_rows[k])
        assert r["train_acc"] == j_rows[k]["train_acc"]
        assert r["val_acc"] == j_rows[k]["val_acc"]
        np.testing.assert_allclose(r["loss"], j_rows[k]["loss"], rtol=1e-4)
    assert best == j_best > 40.0
    best_dir = str(pdir / "weights/new_weight/best")
    meta = json.load(open(os.path.join(best_dir, "meta.json")))
    assert meta["kind"] == "classify" and meta["num_classes"] == 5
    final = str(tmp_path / "final")
    classify.class_export({"params": module_tree(model)}, cfg, final)
    x = _batch(40)[0]
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    got = np.asarray(JEngine(final)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_train_resumes_from_jax_pretrained_dir(tmp_path, jparams):
    """cfg.pretrained holding an engine the JAX package wrote: the port's
    train starts from exactly those params."""
    pre = str(tmp_path / "weights/vit_best")
    j_save_engine(pre, "classify", jparams,
                  {"vit_spec": TINY_KW, "num_classes": 5,
                   "model_name": "tiny"})
    logs = []
    model, _ = classify.train(_cfg(tmp_path, epoch=0), workdir=str(tmp_path),
                              log_fn=logs.append, device="cpu")
    assert any("resumed from" in m for m in logs)
    got = dict(_flat(module_tree(model)))
    for path, p in _flat(jparams["params"]):
        np.testing.assert_array_equal(got[path], p)


# ---- checkpointer resume and EMA (tests/test_train_resume_ema.py) -------------
def _loaders(n=8, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]

    def loader():
        for i in range(0, n, 4):
            yield imgs[i:i + 4], onehot[i:i + 4]
    return loader


def test_fit_resumes_from_checkpointer(tmp_path, jparams):
    cfg = CFG(epoch=3, train_bs=4, lr=1e-3)
    t1, m1, o1 = _port(jparams, cfg)
    t1.fit(m1, o1, _loaders(), _loaders())

    ck = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    t2, m2, o2 = _port(jparams, cfg)
    t2.fit(m2, o2, _loaders(), _loaders(), checkpointer=ck,
           stop_after_epoch=2)
    assert ck.latest_step() == 2
    t3, m3, o3 = _port(jparams, cfg)
    _, _, best3 = t3.fit(m3, o3, _loaders(), _loaders(), checkpointer=ck)
    assert ck.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]
    full, resumed = _param_tree(m1), _param_tree(m3)
    for path, p in full.items():
        np.testing.assert_allclose(resumed[path], p, rtol=1e-4, atol=1e-6)
    ck.close()


def test_fit_resume_preserves_result_json(tmp_path, jparams):
    cfg = CFG(epoch=3, train_bs=4, lr=1e-3)
    log_path = str(tmp_path / "result.json")
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    t, m, o = _port(jparams, cfg)
    t.log_path = log_path
    t.fit(m, o, _loaders(), _loaders(), log=True, checkpointer=ck,
          stop_after_epoch=2)
    assert set(json.load(open(log_path))) == {"1", "2"}
    t2, m2, o2 = _port(jparams, cfg)
    t2.log_path = log_path
    t2.fit(m2, o2, _loaders(), _loaders(), log=True, checkpointer=ck)
    assert set(json.load(open(log_path))) == {"1", "2", "3"}
    ck.close()


def test_ema_ramp_and_convergence():
    ema = EMA({"w": torch.zeros(4)}, decay=0.9, tau=10.0)
    pt = {"w": torch.ones(4)}
    ema.update(pt)
    assert float(ema.params["w"][0]) > 0.9
    for _ in range(200):
        ema.update(pt)
    np.testing.assert_allclose(ema.params["w"].numpy(), 1.0, atol=1e-3)


def test_ema_matches_jax():
    rng = np.random.default_rng(4)
    p0 = {"a": {"k": rng.normal(size=(3, 5)).astype(np.float32)},
          "b": rng.normal(size=(6,)).astype(np.float32)}
    je = JEMA(jax.tree.map(jnp.asarray, p0), decay=0.99, tau=5.0)
    te = EMA(jax.tree.map(torch.from_numpy, p0), decay=0.99, tau=5.0)
    for _ in range(6):
        p = jax.tree.map(lambda v: rng.normal(size=v.shape)
                         .astype(np.float32), p0)
        je.update(jax.tree.map(jnp.asarray, p))
        te.update(jax.tree.map(torch.from_numpy, p))
    got = dict(_flat(jax.tree.map(lambda t: t.numpy(), te.params)))
    for path, v in _flat(je.params):
        np.testing.assert_allclose(got[path], v, atol=1e-7, rtol=1e-6)
