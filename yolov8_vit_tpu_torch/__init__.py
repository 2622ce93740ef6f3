"""PyTorch + CUDA port of yolov8_vit_tpu (two-stage YOLOv8 -> ViT inference).

The JAX package `yolov8_vit_tpu` is the reference; this package imports
torch and never jax, flax or the JAX package.  Its entry points run on the
card unless the caller passes device="cpu", where every hand-written
kernel's wrapper runs its plain PyTorch version.
"""
