"""What the detector's conv rounding costs on the card.

    python3 -m yolov8_vit_tpu_torch.utils.conv_cost

YOLOv8-s at 640x640, batch 32, bf16 activations, random weights from seed
0.  Times (CUDA events, 10 forwards a turn) the detector as it runs, each
conv accumulating its bf16 operands in f32 (TF32 allowed) with the bias
added before one bf16 rounding, against the same net with bf16 convs that
round their output before the bias, in turns: as it runs, rounding first,
rounding first, as it runs.  Prints one JSON line.  Needs a CUDA device.
The rounding-first form lives only here, as the baseline of this
measurement.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F


def main() -> int:
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models import yolov8 as y
    from yolov8_vit_tpu_torch.ops import blob, letterbox_fast
    if not torch.cuda.is_available():
        print("conv_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    det = y.YOLOv8(y.detect_spec(DetectConfig(variant="s")), dtype=bf16)
    gen = torch.Generator().manual_seed(0)
    for m in det.modules():
        if hasattr(m, "reset"):
            m.reset(gen)
    det.prepare()
    det.to("cuda")
    frames = torch.randint(0, 256, (32, 640, 640, 3), dtype=torch.uint8,
                           generator=gen).to("cuda")
    lb, _, _ = letterbox_fast(frames, (640, 640), dtype=bf16)
    x = blob(lb).to(bf16)
    # the kernels in bf16, made before timing as the port makes its own
    w_bf16 = {id(b.w): b.w.to(bf16) for b in det.modules()
              if isinstance(b, y.ConvBlock)}
    w_bf16.update({id(w): w.to(bf16) for n, w in det.detect.named_buffers()
                   if n.startswith("entry") and n.endswith("_w")})

    def rounds_first(x, w, bias, stride):
        out = F.conv2d(x, w_bf16[id(w)], stride=stride,
                       padding=w.shape[-1] // 2)
        return F.silu(out.to(torch.float32) + bias[:, None, None]).to(x.dtype)

    def time_ms(reps=10):
        with torch.no_grad():
            det(x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                det(x)
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    runs = {"as_run_ms": [], "rounds_first_ms": []}
    as_run = y._conv_silu
    for key in ("as_run_ms", "rounds_first_ms", "rounds_first_ms",
                "as_run_ms"):
        y._conv_silu = as_run if key == "as_run_ms" else rounds_first
        try:
            runs[key].append(time_ms())
        finally:
            y._conv_silu = as_run
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "runs": runs} | {
        k: sum(v) / len(v) for k, v in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
