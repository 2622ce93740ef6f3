"""End-to-end smoke script, the reference's `test.py`: load a detect
engine and a classify engine, run the two-stage host flow
(`serve/infer.py::main`) over an image directory, and write VOC
prediction XMLs through the `generate_annotation` callback
(model-assisted labeling).  The engines run on the card.

    python3 -m yolov8_vit_tpu_torch.examples.smoke \\
        --detect-engine weights/detect_engine \\
        --classify-engine weights/class_engine --images ./image/
"""
from __future__ import annotations

import argparse


def main(argv=None, device="cuda") -> list:
    """Parse `argv`, run, print the rows and return them."""
    ap = argparse.ArgumentParser(prog="yolov8_vit_tpu_torch.examples.smoke")
    ap.add_argument("--detect-engine", required=True)
    ap.add_argument("--classify-engine", default=None)
    ap.add_argument("--images", required=True)
    ap.add_argument("--out-xml", default="predictions/")
    ap.add_argument("--draw-dir", default=None)
    args = ap.parse_args(argv)

    from yolov8_vit_tpu_torch.data.voc import generate_annotation
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.serve.infer import main as infer_main

    engine = Engine(args.detect_engine, device=device)
    engine.set_desired(["num_dets", "bboxes", "scores", "labels"])
    model_list = []
    if args.classify_engine:
        model_list.append(Engine(args.classify_engine, device=device))

    def func(folder, filename, path, objects):
        generate_annotation(folder, filename, path, objects,
                            save_dir=args.out_xml)

    results = infer_main(engine, args.images, model_list=model_list,
                         func=func, save_draw_dir=args.draw_dir)
    for row in results:
        print(row)
    print(f"{len(results)} detections across "
          f"{len(set(r[0] for r in results))} images; "
          f"XMLs in {args.out_xml}")
    return results


if __name__ == "__main__":
    main()
