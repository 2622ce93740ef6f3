"""Device ops of the two-stage pipeline (PyTorch port)."""
from yolov8_vit_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention, fused_attention_block, fused_attention_block_i8,
    window_attention,
)
from yolov8_vit_tpu_torch.ops.boxes import (  # noqa: F401
    box_area, box_iou, inflate_boxes, unletterbox_boxes,
)
from yolov8_vit_tpu_torch.ops.conv_block import conv_silu  # noqa: F401
from yolov8_vit_tpu_torch.ops.crop import (  # noqa: F401
    crop_and_resize_nearest, crop_to_patches_i8,
)
from yolov8_vit_tpu_torch.ops.dfl import dfl_decode, make_anchors  # noqa: F401
from yolov8_vit_tpu_torch.ops.fused_region import (  # noqa: F401
    fused_b1b2, prepare_region, region_b1b2_plain,
)
# (`letterbox`, the exact-gather form, is imported from its module: the
# name `ops.letterbox` stays the module, where the JAX package rebinds it
# to the function)
from yolov8_vit_tpu_torch.ops.letterbox import (  # noqa: F401
    letterbox_fast, letterbox_params,
)
from yolov8_vit_tpu_torch.ops.mlp import mlp_block  # noqa: F401
from yolov8_vit_tpu_torch.ops.nms import (  # noqa: F401
    area_sorted_nms, efficient_nms_scan, nms_single_label,
)
from yolov8_vit_tpu_torch.ops.preprocess import blob, normalize_pm1  # noqa: F401
from yolov8_vit_tpu_torch.ops.quant import (  # noqa: F401
    prequantize_tree, quant_dense, quant_dense_fused, quant_dense_pre,
    quant_mlp_fused, quant_mlp_ln_fused, quantize_act, quantize_weight,
)
from yolov8_vit_tpu_torch.ops.resize import (  # noqa: F401
    interp_matrix, resize_bilinear, resize_bilinear_mm, resize_nearest,
)

# registers the kernels as torch.library operators (mt::*), which the
# wrappers call (`ops.library`, not an exported name)
import yolov8_vit_tpu_torch.ops.library  # noqa: F401,E402

# the wrappers that launch a CUDA kernel, each with its `launches` count
# (kernels A-F, then G-K, then SwinV2's window attention and the float
# ViT's MLP sub-block; A, B and I are
# three forms of one ordered-scan kernel, csrc/nms.cu `greedy_nms_kernel`;
# I is efficient_nms_scan(multi_label=False), counted on nms_single_label)
KERNEL_WRAPPERS = (efficient_nms_scan, area_sorted_nms, quant_mlp_ln_fused,
                   fused_attention_block_i8, fused_attention_block,
                   flash_attention, quant_dense_fused, quant_mlp_fused,
                   nms_single_label, fused_b1b2, conv_silu, window_attention,
                   mlp_block)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
