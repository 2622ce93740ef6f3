"""Box geometry ops (xyxy convention throughout)."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    return ((boxes[..., 2] - boxes[..., 0]).clamp_min(0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0))


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (N, 4) and (M, 4) xyxy boxes -> (N, M)
    (torchvision's `box_iou` formulation; the union floored at 1e-9)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / union.clamp_min(1e-9)


def unletterbox_boxes(boxes: torch.Tensor, ratio: float,
                      dwdh: tuple[float, float]) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coords back to the original image:
    `(boxes - (dw, dh, dw, dh)) / ratio`."""
    dw, dh = dwdh
    shift = torch.tensor([dw, dh, dw, dh], dtype=boxes.dtype,
                         device=boxes.device)
    return (boxes - shift) / ratio


def inflate_boxes(boxes: torch.Tensor, img_wh: torch.Tensor) -> torch.Tensor:
    """Inflate xyxy boxes before cropping, clamped to the image: each side
    moves out by ((side_len // 10) // 2) pixels, in integer arithmetic with
    floor division.  `img_wh` is (..., 2) (width, height), broadcastable."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    dis_x = torch.floor(x2 - x1).to(torch.int32).div(10, rounding_mode="floor")
    dis_y = torch.floor(y2 - y1).to(torch.int32).div(10, rounding_mode="floor")
    ex = dis_x.div(2, rounding_mode="floor").to(boxes.dtype)
    ey = dis_y.div(2, rounding_mode="floor").to(boxes.dtype)
    w = img_wh[..., 0]
    h = img_wh[..., 1]
    return torch.stack([
        (x1 - ex).clamp_min(0.0),
        (y1 - ey).clamp_min(0.0),
        torch.minimum(w, x2 + ex),
        torch.minimum(h, y2 + ey),
    ], dim=-1)
