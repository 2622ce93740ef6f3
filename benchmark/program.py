"""The benchmark's one adapter to the program under test, the PyTorch port
(`yolov8_vit_tpu_torch`): it builds the port's objects from a
configuration file and a weight tree, as a deployment builds them.  The
float tree is pre-quantized by the port itself for an int8 ViT."""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def det_config(cfg: dict):
    from yolov8_vit_tpu_torch.config import DetectConfig
    d = cfg["detector"]
    return DetectConfig(
        input_size=tuple(d["input_size"]), variant=d["variant"],
        num_classes=cfg["num_classes"], reg_max=d["reg_max"],
        strides=tuple(d["strides"]), nms_iou=d["nms_iou"],
        nms_conf=d["nms_conf"], nms_topk=d["nms_topk"],
        conf_second=d["conf_second"], custom_nms_iou=d["custom_nms_iou"])


def vit_spec(cfg: dict):
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    v = cfg["vit"]
    return ViTSpec(img_size=v["img_size"], patch=v["patch"], dim=v["dim"],
                   depth=v["depth"], heads=v["heads"],
                   mlp_ratio=v["mlp_ratio"],
                   backbone_classes=v["backbone_classes"],
                   attn_impl=v["attn_impl"], quant=v["quant"])


def vit_params(cfg: dict, tree: dict) -> dict:
    """The ViT's params as the port serves them (its own pre-quantize for
    the int8 modes)."""
    from yolov8_vit_tpu_torch.ops import quant
    params = tree["vit"]["params"]
    if cfg["vit"]["quant"] == "w8a":
        return quant.prequantize_tree(params, quant.MLP_AND_ATTN_SUFFIXES)
    if cfg["vit"]["quant"] == "w8":
        return quant.prequantize_tree(params, quant.MLP_SUFFIXES)
    return params


def bulk_runner(cfg: dict, mix: dict, tree: dict, device: str):
    """(pipeline, BatchRunner) at the mix's batch and classify budget."""
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree
    pipe = TwoStagePipeline(det_cfg=det_config(cfg), vit_spec=vit_spec(cfg),
                            num_classes=cfg["num_classes"],
                            classify_budget=mix["budget"],
                            dtype=DTYPES[cfg["dtype"]], device=device)
    load_pipeline_tree(pipe, {"det": tree["det"],
                              "vit": {"params": vit_params(cfg, tree)}})
    return pipe, BatchRunner(pipe, max_batch=mix["batch"])


def warm_ladder(pipe, frames, max_batch: int) -> None:
    """Run the overflow ladder's two chunk shapes once (the runner's
    max_batch x budget slots, and 8x that) on a batch of frames."""
    k = max_batch * pipe.classify_budget
    h, w = frames.shape[1], frames.shape[2]
    for slots in (k, 8 * k):
        box = torch.tensor([[0, 0, w // 4, h // 4]] * slots,
                           dtype=torch.int32, device=frames.device)
        pipe.classify(frames, torch.zeros(slots, dtype=torch.int32,
                                          device=frames.device), box)
