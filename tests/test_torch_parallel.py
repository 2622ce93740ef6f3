"""PyTorch port, the mesh layer (parallel/) and its users, on the CPU:
worlds of 2 and 4 gloo processes (tests/parallel_helper.py spawns them;
rendezvous through a FileStore in a temporary directory).

  * the mesh's shapes and errors against JAX's make_mesh on as many
    devices, the sharding rules' placements against JAX's;
  * the ViT trainer data parallel and data x tensor parallel (qkv split
    by head within q, k and v) against the one-process step on the same
    global batch, within tests/test_parallel.py's bar (rtol 1e-4, atol
    1e-6), a partial tail batch included, and a checkpointed resume;
  * the YOLO step data parallel against the one-process step, and
    yolo_train.train over a mesh;
  * the meshed BatchRunner: integer outputs equal the meshless runner's,
    on frames where one rank's rows overflow their classify budget while
    the whole batch's budget holds them;
  * dryrun_multichip(2).
"""
import os
import random

import numpy as np
import pytest
import torch
import jax

from yolov8_vit_tpu.config import MeshConfig as JMeshConfig
from yolov8_vit_tpu.models.vit import ViTClassifier as JViTClassifier
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.parallel import make_mesh as j_make_mesh
from yolov8_vit_tpu.parallel import vit_param_sharding as j_sharding
from yolov8_vit_tpu.parallel.mesh import mesh_from_config as j_from_config

import parallel_helper as H
from yolov8_vit_tpu_torch.config import CFG, DetectConfig
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.parallel import vit_param_sharding
from yolov8_vit_tpu_torch.train import yolo_train as tt
from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
from yolov8_vit_tpu_torch.weights import _reset, module_tree

TINY = ViTSpec(**H.TINY_VIT)
BAR = dict(rtol=1e-4, atol=1e-6)       # tests/test_parallel.py:89-93


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_close(got, want, **tol):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=str(path), **tol)


# ---- mesh, placements ----------------------------------------------------------
def _jax_cases(n):
    devs = jax.devices()[:n]
    out = {}
    cases = {"all": {}, "dp_tp": {"n_data": n // 2, "n_model": 2},
             "tp_all": {"n_model": n}, "n_model_3": {"n_model": 3},
             "too_many_model": {"n_model": 2 * n},
             "too_big": {"n_data": n // 2 + 1, "n_model": 2},
             "subset": {"n_data": 1, "n_model": 2},
             "zero": {"n_data": 0}}
    for key, kw in cases.items():
        try:
            m = j_make_mesh(devices=devs, **kw)
            out[key] = (m.devices.shape, tuple(m.axis_names))
        except ValueError:
            out[key] = "ValueError"
    for key, cfg in {"cfg_tp2": JMeshConfig(model_parallel=2),
                     "cfg_names": JMeshConfig(data_axis="dp",
                                              model_axis="tp")}.items():
        m = j_from_config(cfg, devices=devs)
        out[key] = (m.devices.shape, tuple(m.axis_names))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_shapes_and_errors_match_jax(n):
    got = H.spawn(n, "mesh_cases")
    want = _jax_cases(n)
    for rank, out in enumerate(got):
        for key, w in want.items():
            assert out[key] == w, (rank, key)
        assert out["local"] == (n, 1) and out["global_tp2"] == (n // 2, 2)
        assert out["primary"] == (rank == 0)


def test_world_of_one_and_jax_environment(tmp_path):
    """Without a process group, local_mesh is a world of 1; init_multihost
    reads JAX's environment names (a file:// rendezvous here).  Each in a
    process of its own: both set the process's group."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    codes = {
        "local": "from yolov8_vit_tpu_torch.parallel import local_mesh, "
                 "is_primary\nassert is_primary()\n"
                 "m = local_mesh(device='cpu')\n"
                 "print(tuple(m.mesh.shape), m.mesh_dim_names)",
        "env": "import torch.distributed as dist\n"
               "from yolov8_vit_tpu_torch.parallel import init_multihost, "
               "global_mesh, is_primary\ninit_multihost(device='cpu')\n"
               "assert dist.get_world_size() == 1 and is_primary()\n"
               "m = global_mesh()\nprint(tuple(m.mesh.shape), "
               "m.mesh_dim_names)"}
    env = dict(os.environ, PYTHONPATH=repo, JAX_NUM_PROCESSES="1",
               JAX_PROCESS_ID="0", JAX_COORDINATOR_ADDRESS="file://"
               + str(tmp_path / "rendezvous"))
    for name, code in codes.items():
        run = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, (name, run.stderr[-2000:])
        assert run.stdout.strip() == "(1, 1) ('data', 'model')", name


def test_vit_param_sharding_matches_jax():
    jparams = jax.jit(JViTClassifier(JViTSpec(**H.TINY_VIT), 5).init)(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    mesh = j_make_mesh(n_data=4, n_model=2)
    want = jax.tree_util.tree_map_with_path(
        lambda p, s: tuple(s.spec), j_sharding(mesh, jparams),
        is_leaf=lambda x: hasattr(x, "spec"))
    model = ViTClassifier(TINY, 5)
    got = vit_param_sharding(None, {"params": module_tree(model)})
    w = {p: tuple(v) for p, v in _flat_specs(want)}
    g = {p: tuple(v) for p, v in _flat_specs(got)}
    assert set(g) == set(w) and g == w
    assert sum("model" in v for v in g.values()) == 6 * TINY.depth


def _flat_specs(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_specs(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_shard_params_split_heads_and_round_trip():
    """qkv's shard holds whole heads of each of q, k and v; gathering the
    shards gives the tree back; shard_batch gives a rank its data rows;
    replicate takes the first rank's values."""
    model = ViTClassifier(TINY, 5)
    _reset(model, torch.Generator().manual_seed(0))
    tree = {"params": module_tree(model)}
    out = H.spawn(4, "shard_round_trip", tree["params"])
    qkv = tree["params"]["model"]["block0"]["attn"]["qkv"]["kernel"]
    d = TINY.dim
    for rank, o in enumerate(out):
        r_data, r_model = divmod(rank, 2)
        rows = torch.arange(16).reshape(8, 2)[4 * r_data:4 * r_data + 4]
        assert torch.equal(o["rows"], rows)
        assert torch.equal(o["replicated"], torch.zeros(3))
        half = d // 2
        want = torch.cat([qkv[:, p * d + r_model * half:
                              p * d + (r_model + 1) * half]
                          for p in range(3)], 1)
        assert torch.equal(o["qkv_local"], want)
        for path, leaf in _flat(tree["params"]):
            np.testing.assert_array_equal(o["back"][path], leaf)


# ---- the ViT trainer -------------------------------------------------------------
def _vit_batches(seed, sizes):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)])
            for b in sizes]


@pytest.fixture(scope="module")
def vit_init():
    trainer = ViTTrainer(CFG(), TINY, log_fn=lambda *a: None, device="cpu")
    return module_tree(trainer.init()[0])


@pytest.mark.parametrize("n,n_model", [(2, 1), (2, 2), (4, 2)],
                         ids=["dp2", "tp2", "dp2xtp2"])
def test_vit_steps_match_one_process(vit_init, n, n_model):
    """One epoch of a full batch and a tail batch (8 rows: split; 3 rows:
    replicated), then validation of 8 + 5 rows."""
    train, valid = _vit_batches(0, [8, 3]), _vit_batches(1, [8, 5])
    trainer = ViTTrainer(CFG(), TINY, log_fn=lambda *a: None, device="cpu")
    model, opt = trainer.init(vit_init)
    want_t = trainer.train_one_epoch(model, opt, train, 0)
    want_v = trainer.valid_one_epoch(model, valid)
    got = H.spawn(n, "vit_steps", n_model, vit_init, train,
                  valid)
    for o in got:
        assert o["train"][0] == pytest.approx(want_t[0], rel=1e-5)
        assert o["train"][1] == want_t[1]
        assert o["valid"][0] == want_v[0]
        assert o["valid"][1] == pytest.approx(want_v[1], rel=1e-5)
        np.testing.assert_array_equal(o["valid"][2], want_v[2])
        _assert_trees_close(o["params"], module_tree(model), **BAR)


def test_vit_tp_checkpoint_resume_matches_one_process(tmp_path, vit_init):
    """fit over a (2, 2) mesh, stopped after epoch 2 and resumed from the
    checkpoint (whole params and momentum buffers, split again) for epoch
    3, equals three epochs in one process."""
    batches = _vit_batches(2, [4, 4])
    trainer = ViTTrainer(CFG(epoch=3), TINY, log_fn=lambda *a: None,
                         device="cpu")
    model, opt = trainer.init(vit_init)
    trainer.fit(model, opt, lambda: batches, lambda: batches)
    got = H.spawn(4, "vit_fit_resume", vit_init,
                  batches, str(tmp_path / "ckpt"))
    _assert_trees_close(got[0][1], module_tree(model), **BAR)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2", "3"]


def test_vit_tp_refuses_heads_that_do_not_split():
    from yolov8_vit_tpu_torch.parallel.sharding import tensor_parallel

    class Mesh:                      # the axis queries tensor_parallel makes
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (1, 3)[i]

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None
    model = ViTClassifier(TINY, 5).train_form()
    with pytest.raises(ValueError, match="do not split"):
        tensor_parallel(model, Mesh())


# ---- YOLO ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    from test_torch_yolo_train import _make_voc_dir
    from yolov8_vit_tpu_torch.data.voc import xml2txt
    root = tmp_path_factory.mktemp("yolo_dp")
    _make_voc_dir(str(root / "new"))
    dst = str(root / "fold0")
    assert xml2txt(str(root / "new"), dst, val_fraction=0.3,
                   rng=random.Random(2)) == 10
    return dst


def test_yolo_dp_step_matches_one_process(fold):
    batch = next(tt.YoloDataset(fold, "train", 64, 8).batches(
        4, augment=True, seed=1))
    want = H.yolo_step(0, 1, "cpu", batch)
    got = H.spawn(2, "yolo_step", batch)
    for o in got:
        assert o["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for k, v in want["parts"].items():
            assert o["parts"][k] == pytest.approx(v, rel=1e-5)
        _assert_trees_close(o["params"], want["params"], **BAR)


def test_yolo_train_over_mesh(fold):
    """yolo_train.train(mesh=...) at world 2 against one process: the same
    steps (7 train frames, batch 2: three split steps, the tail dropped),
    EMA and validation."""
    want_p, want_m = tt.train(1, 2, fold, DetectConfig(**H.TINY_DET),
                              max_gt=8, log_fn=lambda *a: None,
                              device="cpu")
    got = H.spawn(2, "yolo_train", fold)
    for o in got:
        assert set(o["metrics"]) == set(want_m) == {"preval", "final"}
        _assert_trees_close(o["params"], want_p, **BAR)


# ---- the meshed BatchRunner ------------------------------------------------------
@pytest.fixture(scope="module")
def runner_files(tmp_path_factory):
    """A fitted tiny pipeline's tree (detections track planted covers) and
    4 frames: two crowded (5 kept between them), two empty."""
    from PIL import Image
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.utils.densify import (fit_detect_head,
                                                    make_cover_scenes)
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree
    root = tmp_path_factory.mktemp("runner")
    pipe = TwoStagePipeline(
        det_cfg=DetectConfig(input_size=(64, 64), variant="n", nms_topk=16),
        vit_spec=ViTSpec(**H.TINY_VIT, quant="w8a", attn_impl="fused"),
        classify_budget=2, device="cpu")
    tree = init_tree(pipe, 0)
    load_pipeline_tree(pipe, tree)
    imgs, covers = make_cover_scenes(np.random.default_rng(3), 8, (64, 64),
                                     lam=1.5)
    with pytest.warns(UserWarning, match="separation"):
        tree = fit_detect_head(tree, pipe, imgs, covers, box_bin=2)
    torch.save(tree, root / "tree.pt")
    crowded, _ = make_cover_scenes(np.random.default_rng(12), 2, (64, 64),
                                   lam=3.0)
    empty, _ = make_cover_scenes(np.random.default_rng(13), 2, (64, 64),
                                 lam=0.0)
    paths = []
    for i, img in enumerate(np.concatenate([crowded, empty])):
        p = str(root / f"f{i}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
    return str(root / "tree.pt"), paths


@pytest.mark.parametrize("n", [2, 4])
def test_meshed_runner_equals_meshless(runner_files, n):
    tree, paths = runner_files
    out = H.spawn(n, "runner", tree, paths, 2)
    for rank, o in enumerate(out):
        plain = o["plain"]
        kept = [int(r["final_valid"].sum()) for r in plain]
        assert kept[2:] == [0, 0] and 4 < sum(kept) <= 8, kept
        # the whole batch's budget (4 x 2 slots) holds every kept box ...
        pk = o["packed_plain"].numpy()
        assert not ((pk[:, 1 + 5 * 16:1 + 6 * 16] < 0)
                    & (pk[:, 1 + 4 * 16:1 + 5 * 16] > 0)).any()
        # ... while the first rank's rows overflow their own budget
        assert o["local_overflow"] == (rank == 0)
        assert "max_batch 3 must be a multiple" in o["error"]
        for got in (o["meshed"], o["meshed_dev"]):
            for a, b in zip(got, plain):
                for k in ("num_dets", "det_labels", "final_valid",
                          "cls_labels"):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                v = b["final_valid"]
                assert (a["cls_labels"][v] >= 0).all()
                np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)
                np.testing.assert_allclose(a["cls_scores"][v],
                                           b["cls_scores"][v], atol=1e-5)
    assert out[0]["overflow_dets"] > 0 and out[0]["overflow_ms"] > 0.0


def test_dryrun_multichip_2():
    from yolov8_vit_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(2, device="cpu", timeout=300)
    assert out["vit"]["mesh"] == {"data": 1, "model": 2}
    assert np.isfinite(out["vit"]["loss"]) and np.isfinite(
        out["yolo"]["loss"])
    assert out["serve"]["num_dets"] > 0
