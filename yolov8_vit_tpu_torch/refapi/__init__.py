"""Reference-API surface: the names of the reference's `utils/utils.py`
in one module, as the JAX package's `refapi` collects them, so code
written against the reference keeps its call sites:

    from yolov8_vit_tpu_torch import refapi as utils

Every name is implemented elsewhere in the port under the same name and
semantics.  `build_model` returns (model, params): the port's
ViTClassifier with the Network_Wrapper `.pth` loaded, on `device`, and
the converted tree.  Submodules: `refapi.trainClass`, `refapi.trainYolo`,
`refapi.class_config`.
"""
from __future__ import annotations

import re

from yolov8_vit_tpu_torch.data.voc import generate_annotation, indent  # noqa: F401
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.serve.downloads import download_images  # noqa: F401
from yolov8_vit_tpu_torch.serve.geocode import location2lalo  # noqa: F401
from yolov8_vit_tpu_torch.serve.oss import AliyunOss, make_object_store  # noqa: F401
from yolov8_vit_tpu_torch.serve.sse import log  # noqa: F401

_TIMM_NAME = re.compile(
    r"vit_(?P<size>tiny|small|base|large)_patch(?P<patch>\d+)_(?P<img>\d+)")

_DIMS = {"tiny": (192, 12, 3), "small": (384, 12, 6),
         "base": (768, 12, 12),
         "large": (1024, 24, 16)}   # dim, depth, heads


def spec_from_timm_name(model_name: str, **overrides) -> ViTSpec:
    """timm model id (e.g. `vit_base_patch8_224.augreg_in21k`) ->
    ViTSpec."""
    m = _TIMM_NAME.match(model_name)
    if not m:
        raise ValueError(f"unrecognized timm ViT name: {model_name!r}")
    dim, depth, heads = _DIMS[m["size"]]
    kw = dict(img_size=int(m["img"]), patch=int(m["patch"]),
              dim=dim, depth=depth, heads=heads)
    kw.update(overrides)
    return ViTSpec(**kw)


def Network_Wrapper(model, num_class: int) -> ViTClassifier:
    """The reference's `Network_Wrapper(model, num_class)`: backbone
    logits -> ReLU -> Linear(1000, 128) -> ReLU -> Linear(128, num_class).
    `model` is a ViTSpec, or a module with a `spec` (its spec is
    reused)."""
    spec = model if isinstance(model, ViTSpec) else model.spec
    return ViTClassifier(spec, num_classes=num_class)


def _key_sorted(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _key_sorted(tree[k]) for k in sorted(tree)}


def wrapper_params(spec: ViTSpec, num_classes: int,
                   pretrained_path: str | None, seed: int = 0) -> dict:
    """The classifier's variables {"params": tree}: the Network_Wrapper
    `.pth` converted (`runtime.convert.convert_vit_wrapper`; keys sorted,
    as the JAX package's build_model returns them from jax.tree.map, so an
    engine written from them holds JAX's bytes), or without one a random
    init drawn from a torch.Generator seeded with `seed`."""
    if pretrained_path:
        from yolov8_vit_tpu_torch.runtime.convert import (
            convert_vit_wrapper, load_torch_state_dict)
        return _key_sorted(convert_vit_wrapper(
            load_torch_state_dict(pretrained_path), depth=spec.depth))
    import torch
    from yolov8_vit_tpu_torch.weights import init_vit_tree
    return init_vit_tree(spec, num_classes, torch.Generator().manual_seed(seed))


def build_model(CFG, modelName: str, pretrained_path: str | None,
                spec: ViTSpec | None = None, device="cuda"):
    """The reference's `build_model(CFG, modelName, pretrained_path)`:
    the timm backbone in Network_Wrapper with the fine-tuned `.pth`
    loaded.  Returns (model, params): the ViTClassifier on `device` with
    `params` loaded (f32 activations), and the variables tree.  `spec`
    overrides the architecture named by `modelName` (tests use tiny
    dims)."""
    from yolov8_vit_tpu_torch import _build
    from yolov8_vit_tpu_torch.weights import load_tree
    device = _build.resolve_device(device)
    spec = spec or spec_from_timm_name(modelName)
    params = wrapper_params(spec, CFG.num_classes, pretrained_path)
    model = Network_Wrapper(spec, CFG.num_classes).to(device)
    load_tree(model, params["params"])
    return model, params
