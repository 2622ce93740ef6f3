"""Multi-process dry run (the port's counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip`), at its tiny shapes:

  1. one ViT training step over a (data, model) mesh: rows over "data",
     qkv / proj / fc1 / fc2 over "model" (2 when n >= 2);
  2. one YOLO training step, data parallel over all n processes;
  3. two-stage inference through `BatchRunner(mesh=...)` over all n, with
     a densified detect head (detections asserted), equal to the meshless
     runner in the same process: integer outputs exactly, floats within
     rtol 1e-5, atol 1e-6.

Run inside a process group of at least n processes, or from a single
process without one: it then spawns n processes (rendezvous through a
file in a temporary directory) and returns rank 0's report.

    python3 -m yolov8_vit_tpu_torch.parallel.dryrun [n] [--device cpu]
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from yolov8_vit_tpu_torch import _build


def _vit_step(n: int, device) -> dict:
    from yolov8_vit_tpu_torch.config import CFG
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer

    n_model = 2 if n >= 2 else 1
    mesh = make_mesh(n_data=n // n_model, n_model=n_model)
    spec = ViTSpec(img_size=32, patch=8, dim=64, depth=2, heads=4,
                   backbone_classes=40)
    trainer = ViTTrainer(CFG(num_classes=5), spec, mesh, log_fn=lambda *a: 0,
                         device=device)
    model, opt = trainer.init()
    batch = n // n_model * 2
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, batch)]
    loss, acc = trainer.train_one_epoch(model, opt, [(imgs, onehot)], 0)
    return {"mesh": {"data": n // n_model, "model": n_model}, "loss": loss,
            "correct": round(acc * batch / 100), "batch": batch}


def _yolo_step(n: int, device) -> dict:
    from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, YOLOv8Spec
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.train.yolo_train import make_yolo_train_step
    from yolov8_vit_tpu_torch.weights import _reset

    dmesh = make_mesh(n_data=n, n_model=1)
    model = YOLOv8(YOLOv8Spec(0.33, 0.125, 1024, num_classes=3))
    _reset(model, torch.Generator().manual_seed(1))
    model = model.train_form().to(device)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    step = make_yolo_train_step(model, opt, (64, 64), mesh=dmesh)
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(
        rng.normal(size=(n, 64, 64, 3)).astype(np.float32)).to(device)
    gt = torch.tensor([[[8.0, 16, 40, 48]]], device=device).repeat(n, 1, 1)
    labels = torch.zeros((n, 1), dtype=torch.int64, device=device)
    mask = torch.ones((n, 1), dtype=torch.bool, device=device)
    loss, _parts = step(imgs, gt, labels, mask)
    return {"mesh": {"data": n}, "loss": float(loss)}


def _serve(n: int, device) -> dict:
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.parallel import make_mesh
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree

    pipe = TwoStagePipeline(
        det_cfg=DetectConfig(input_size=(64, 64), variant="n", nms_topk=16,
                             nms_conf=1e-4),
        vit_spec=ViTSpec(img_size=32, patch=8, dim=64, depth=2, heads=4,
                         backbone_classes=40),
        classify_budget=2, device=device)
    load_pipeline_tree(pipe, densify_detect_head(init_tree(pipe, 2)))
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(
        rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)).to(device)
    dmesh = make_mesh(n_data=n, n_model=1)
    got = BatchRunner(pipe, max_batch=n, mesh=dmesh) \
        .run_device_batches([frames])[0]
    want = BatchRunner(pipe, max_batch=n).run_device_batches([frames])[0]
    dets = sum(r["num_dets"] for r in got)
    if dets == 0:
        raise AssertionError("the densified head produced no detections: "
                             "the meshed serving run exercised nothing "
                             "downstream of the detector")
    equality = "exact"
    for a, b in zip(got, want):
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if np.issubdtype(x.dtype, np.integer) or x.dtype == np.bool_ \
                    or np.array_equal(x, y):
                np.testing.assert_array_equal(
                    x, y, err_msg=f"meshed vs one-process mismatch in {k!r}")
            else:
                np.testing.assert_allclose(
                    x, y, rtol=1e-5, atol=1e-6,
                    err_msg=f"meshed vs one-process mismatch in {k!r}")
                equality = "allclose(1e-5)"
    return {"mesh": {"data": n}, "num_dets": int(dets),
            "equality": equality}


def _run(n: int, device) -> dict:
    if dist.get_world_size() < n:
        raise ValueError(f"dryrun_multichip({n}) in a group of "
                         f"{dist.get_world_size()} processes")
    out = {"vit": _vit_step(n, device), "yolo": _yolo_step(n, device),
           "serve": _serve(n, device)}
    if dist.get_rank() == 0:
        v, y, s = out["vit"], out["yolo"], out["serve"]
        print(f"dryrun_multichip OK (ViT DPxTP): mesh {v['mesh']} "
              f"loss={v['loss']:.4f} correct={v['correct']}/{v['batch']}")
        print(f"dryrun_multichip OK (YOLO DP): mesh data={n} "
              f"loss={y['loss']:.4f}")
        print(f"dryrun_multichip OK (two-stage serve DP): mesh data={n} "
              f"num_dets={s['num_dets']} meshed==one-process: "
              f"{s['equality']}", flush=True)
    return out


def _worker(rank: int, n: int, root: str, device: str, backend: str, fn,
            args) -> None:
    dev = _build.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        # the processes share the host's cores (and a test run's workers):
        # one thread each
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(root, "store"), n), rank=rank, world_size=n)
    try:
        out = fn(rank, n, dev, *args)
        torch.save(out, os.path.join(root, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *args, device="cuda", timeout: float = 600.0) -> list:
    """Run fn(rank, n, device, *args) in n new processes joined in one
    process group (rendezvous through a file in a temporary directory) ->
    every rank's result, in rank order.  `fn` is a module-level function
    (the processes are spawned).  The group is nccl when each process has
    its own card, gloo otherwise (the CPU, or several processes on one
    card: gloo also carries CUDA tensors).  Raises when a process fails or
    outlives `timeout`."""
    dev = _build.resolve_device(device)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= n else "gloo"
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        procs = [ctx.Process(target=_worker, args=(r, n, root, str(dev),
                                                   backend, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} over {n} "
                               f"processes: exit codes {codes}"
                               + (" (timed out)" if alive else ""))
        return [torch.load(os.path.join(root, f"out{r}.pt"),
                           weights_only=False) for r in range(n)]


def _spawned_run(rank: int, n: int, dev) -> dict:
    return _run(n, dev)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> dict:
    """The dry run over n processes (see the module docstring) -> rank 0's
    report; `spawn`s the processes when no process group exists."""
    dev = _build.resolve_device(device)
    if dist.is_initialized():
        return _run(n_devices, dev)
    return spawn(_spawned_run, n_devices, device=dev, timeout=timeout)[0]


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = "cuda"
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    print(json.dumps(dryrun_multichip(int(args[0]) if args else 2, dev)))
