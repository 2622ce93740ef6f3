"""Readings of the program's own spans (yolov8_vit_tpu_torch's
utils/profiling.py `span`: `runner.*`, `train.*`) in a traced slice with
the host's ranges: each span's count and time within the window, and the
device operations of the window a step of a span.

The host's times carry the host trace's own cost (operators recorded with
their shapes): parent and change are traced alike, so they compare."""
from __future__ import annotations


def ranges(tr, name: str) -> list[tuple[float, float]]:
    """(start, end) us of every host range `name` that starts inside the
    window."""
    return [(a, b) for a, b, n in tr.host
            if n == name and tr.t0 <= a < tr.t1]


def count(tr, name: str) -> int:
    return len(ranges(tr, name))


def total_ms(tr, name: str) -> float:
    return sum(b - a for a, b in ranges(tr, name)) / 1e3


def mean_ms(tr, name: str) -> float | None:
    """Mean duration of span `name`, ms; None when the slice has none."""
    n = count(tr, name)
    return total_ms(tr, name) / n if n else None


def per_step_ms(tr, name: str, step: str) -> float | None:
    """Total time of span `name` over the count of span `step`, ms; None
    when either is absent."""
    n = count(tr, step)
    return total_ms(tr, name) / n if n and count(tr, name) else None


def device_ops_per_step(tr, step: str) -> float | None:
    """Device operations (kernels, copies, memsets) in the window over the
    count of span `step`; None without the span or without operations."""
    n, ops = count(tr, step), len(tr.in_window())
    return ops / n if n and ops else None
