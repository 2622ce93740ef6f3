"""Worker processes for tests/test_torch_parallel.py: n spawned processes
join a gloo group through a FileStore in a temporary directory (no fixed
port: xdist runs several test workers at once) and run one of the
functions below with rank, world size and device.  Imports torch, numpy
and the port only, so a spawned process starts without JAX."""
import numpy as np
import torch
import torch.distributed as dist

TINY_VIT = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
                backbone_classes=40)
TINY_DET = dict(input_size=(64, 64), variant="n", num_classes=5,
                nms_pre_topk=64, nms_topk=16)


def spawn(n: int, name: str, *args, timeout: float = 300.0):
    """Run `name`(rank, n, device, *args) in n spawned gloo processes on
    the CPU (parallel.dryrun.spawn) -> every rank's result, in rank
    order."""
    from yolov8_vit_tpu_torch.parallel.dryrun import spawn as _spawn
    return _spawn(globals()[name], n, *args, device="cpu", timeout=timeout)


# ---- the workers ---------------------------------------------------------
def mesh_cases(rank, n, dev):
    """make_mesh / mesh_from_config on the cases of the JAX tests:
    (mesh shape, axis names) or the error's type."""
    from yolov8_vit_tpu_torch.config import MeshConfig
    from yolov8_vit_tpu_torch.parallel import (global_mesh, is_primary,
                                               local_mesh, make_mesh,
                                               mesh_from_config)
    out = {}
    cases = {"all": {}, "dp_tp": {"n_data": n // 2, "n_model": 2},
             "tp_all": {"n_model": n}, "n_model_3": {"n_model": 3},
             "too_many_model": {"n_model": 2 * n},
             "too_big": {"n_data": n // 2 + 1, "n_model": 2},
             "subset": {"n_data": 1, "n_model": 2},
             "zero": {"n_data": 0}}
    for key, kw in cases.items():
        try:
            m = make_mesh(device="cpu", **kw)
            out[key] = (tuple(m.mesh.shape), m.mesh_dim_names)
        except ValueError:
            out[key] = "ValueError"
    for key, cfg in {"cfg_tp2": MeshConfig(model_parallel=2),
                     "cfg_names": MeshConfig(data_axis="dp",
                                             model_axis="tp")}.items():
        m = mesh_from_config(cfg, device="cpu")
        out[key] = (tuple(m.mesh.shape), m.mesh_dim_names)
    out["local"] = tuple(local_mesh(device="cpu").mesh.shape)
    out["global_tp2"] = tuple(global_mesh(2).mesh.shape)
    out["primary"] = is_primary()
    return out


def _flat_places(tree, prefix=()):
    """(path, placement) of each leaf of a placement tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_places(v, prefix + (k,))
    else:
        yield prefix, tuple(tree)


def shard_round_trip(rank, n, dev, tree):
    """shard_batch rows, replicate, shard_params of a ViT tree over a
    (n / 2, 2) mesh and each split leaf gathered back (gather_leaf) ->
    {path: leaf}."""
    from yolov8_vit_tpu_torch.parallel import (make_mesh, replicate,
                                               shard_batch, shard_params,
                                               vit_param_sharding)
    from yolov8_vit_tpu_torch.parallel.sharding import gather_leaf
    mesh = make_mesh(n_data=n // 2, n_model=2, device="cpu")
    rows = shard_batch(mesh, torch.arange(4 * n).reshape(2 * n, 2))
    mine = {"x": torch.full((3,), float(rank))}
    replicate(mesh, mine)
    spec = vit_param_sharding(mesh, tree)
    local = shard_params(mesh, tree, spec)
    qkv = local["model"]["block0"]["attn"]["qkv"]["kernel"]
    back = {}
    for path, place in _flat_places(spec):
        leaf = local
        for part in path:
            leaf = leaf[part]
        back[path] = gather_leaf(mesh, ".".join(path), leaf) \
            if "model" in place else leaf
    return {"rows": rows, "replicated": mine["x"], "qkv_local": qkv,
            "back": back}


def vit_steps(rank, n, dev, n_model, init, train_batches, valid_batches):
    """The trainer over a (n / n_model, n_model) mesh from the `init`
    params: one epoch of `train_batches`, one of `valid_batches` ->
    (train (loss, acc), valid (acc, loss, confusion), the whole params
    tree)."""
    from yolov8_vit_tpu_torch.config import CFG
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
    mesh = make_mesh(n_data=n // n_model, n_model=n_model, device="cpu")
    trainer = ViTTrainer(CFG(), ViTSpec(**TINY_VIT), mesh,
                         log_fn=lambda *a: None, device="cpu")
    model, opt = trainer.init(init)
    train = trainer.train_one_epoch(model, opt, train_batches, 0)
    valid = trainer.valid_one_epoch(model, valid_batches)
    return {"train": train, "valid": valid,
            "params": trainer.params_tree(model)}


def vit_fit_resume(rank, n, dev, init, batches, ckpt_dir):
    """fit over a (n / 2, 2) mesh with a checkpointer: two epochs, then a
    fresh trainer resumed from the checkpoint for a third -> the whole
    params tree after each run."""
    from yolov8_vit_tpu_torch.config import CFG
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
    from yolov8_vit_tpu_torch.utils.checkpoint import TrainCheckpointer
    mesh = make_mesh(n_data=n // 2, n_model=2, device="cpu")
    trees = []
    for stop in (2, 3):
        trainer = ViTTrainer(CFG(epoch=3), ViTSpec(**TINY_VIT), mesh,
                             log_fn=lambda *a: None, device="cpu")
        model, opt = trainer.init(init)
        trainer.fit(model, opt, lambda: batches, lambda: batches,
                    checkpointer=TrainCheckpointer(ckpt_dir),
                    stop_after_epoch=stop)
        trees.append(trainer.params_tree(model))
        dist.barrier()
    return trees


def yolo_step(rank, n, dev, batch):
    """One YOLO step, data parallel over n, from seed-0 weights."""
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.train import yolo_train as tt
    from yolov8_vit_tpu_torch.weights import module_tree
    cfg = DetectConfig(**TINY_DET)
    model = tt.build_train_model(cfg, None, "cpu")
    named = dict(model.named_parameters())
    opt = tt.make_yolo_optimizer(named, 1e-4, 1.0, 1, 2, 100)
    mesh = make_mesh(device="cpu") if n > 1 else None
    step = tt.make_yolo_train_step(model, opt, cfg.input_size, 16, mesh=mesh)
    loss, parts = step(*(torch.from_numpy(a) for a in batch))
    return {"loss": float(loss), "parts": {k: float(v)
                                           for k, v in parts.items()},
            "params": module_tree(model)}


def yolo_train(rank, n, dev, fold):
    """yolo_train.train for one epoch at batch 2 over a mesh of n."""
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.train import yolo_train as tt
    params, metrics = tt.train(1, 2, fold, DetectConfig(**TINY_DET),
                               max_gt=8, log_fn=lambda *a: None,
                               mesh=make_mesh(device="cpu"), device="cpu")
    return {"params": params, "metrics": metrics}


def runner(rank, n, dev, tree_path, paths, budget):
    """The meshed BatchRunner (max_batch 4, data axis n) against the
    meshless one in the same process, from files and from a device batch;
    the meshed runner's max_batch error; whether this rank's rows alone
    overflow their budget."""
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.parallel import make_mesh, shard_batch
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree
    pipe = TwoStagePipeline(
        det_cfg=DetectConfig(input_size=(64, 64), variant="n", nms_topk=16),
        vit_spec=ViTSpec(**TINY_VIT, quant="w8a", attn_impl="fused"),
        classify_budget=budget, device="cpu")
    load_pipeline_tree(pipe, torch.load(tree_path, weights_only=False))
    mesh = make_mesh(device="cpu")
    meshed = BatchRunner(pipe, max_batch=4, mesh=mesh)
    plain = BatchRunner(pipe, max_batch=4)
    prof: dict = {}
    got = meshed.run_paths(paths, profile=prof)
    batch = torch.from_numpy(np.stack([plain._decode(p) for p in paths]))
    got_dev = meshed.run_device_batches([batch])[0]
    rows = pipe(shard_batch(mesh, batch))
    local_overflow = bool(((rows["cls_labels"] < 0)
                           & rows["final_valid"]).any())
    try:
        BatchRunner(pipe, max_batch=3, mesh=mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"meshed": got, "meshed_dev": got_dev, "plain": plain.run_paths(
        paths), "packed": meshed._fn(batch), "packed_plain": plain._fn(batch),
        "local_overflow": local_overflow, "overflow_ms": prof["overflow_ms"],
        "overflow_dets": prof["overflow_dets"],
        "error": error}
