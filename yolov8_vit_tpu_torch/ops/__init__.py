"""Device ops of the two-stage pipeline (PyTorch port)."""
from yolov8_vit_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention, fused_attention_block, fused_attention_block_i8,
)
from yolov8_vit_tpu_torch.ops.boxes import (  # noqa: F401
    box_area, inflate_boxes, unletterbox_boxes,
)
from yolov8_vit_tpu_torch.ops.crop import crop_to_patches_i8  # noqa: F401
from yolov8_vit_tpu_torch.ops.dfl import dfl_decode, make_anchors  # noqa: F401
from yolov8_vit_tpu_torch.ops.fused_region import (  # noqa: F401
    fused_b1b2, prepare_region, region_b1b2_plain,
)
# (`letterbox`, the exact-gather form, is imported from its module: the
# name `ops.letterbox` stays the module)
from yolov8_vit_tpu_torch.ops.letterbox import (  # noqa: F401
    letterbox_fast, letterbox_params,
)
from yolov8_vit_tpu_torch.ops.nms import (  # noqa: F401
    area_sorted_nms, efficient_nms_scan, nms_single_label,
)
from yolov8_vit_tpu_torch.ops.preprocess import blob  # noqa: F401
from yolov8_vit_tpu_torch.ops.quant import (  # noqa: F401
    prequantize_tree, quant_dense, quant_dense_fused, quant_mlp_fused,
    quant_mlp_ln_fused, quantize_act, quantize_weight,
)
from yolov8_vit_tpu_torch.ops.resize import (  # noqa: F401
    interp_matrix, resize_bilinear, resize_bilinear_mm, resize_nearest,
)

# the wrappers that launch a CUDA kernel, each with its `launches` count
# (kernels A-F, then G-J; A, B and I are three forms of one ordered-scan
# kernel, csrc/nms.cu `greedy_nms_kernel`; I is
# efficient_nms_scan(multi_label=False), counted on nms_single_label)
KERNEL_WRAPPERS = (efficient_nms_scan, area_sorted_nms, quant_mlp_ln_fused,
                   fused_attention_block_i8, fused_attention_block,
                   flash_attention, quant_dense_fused, quant_mlp_fused,
                   nms_single_label, fused_b1b2)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
