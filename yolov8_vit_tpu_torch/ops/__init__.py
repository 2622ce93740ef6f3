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
# wrappers call, and counts their launches
from yolov8_vit_tpu_torch.ops.library import (  # noqa: F401,E402
    launch_counts, reset_launch_counts,
)
