"""Train-state checkpoints: params, optimizer state and extra metrics,
one directory per step (PyTorch port of
`yolov8_vit_tpu/utils/checkpoint.py`).

The JAX package writes these with orbax, which the GPU machine does not
have; the port writes its own format, and the two do not read each
other's checkpoints.  A step is `<directory>/<step>/state.pt`, written by
`torch.save` to a temporary directory that is then renamed, so a step
directory is either complete or absent.  Only the newest `max_to_keep`
steps are kept.  Loading uses `torch.load(weights_only=True)`: the state
holds tensors, numbers, strings and containers only.
"""
from __future__ import annotations

import os
import shutil

import torch


class TrainCheckpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def save(self, step: int, params, opt_state,
             extra: dict | None = None) -> None:
        """params: a tree of tensors (`weights.module_tree`); opt_state:
        the optimizer's `state_dict()`."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": params, "opt_state": opt_state,
                    "extra": dict(extra or {})},
                   os.path.join(tmp, "state.pt"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None,
                template: dict | None = None) -> dict | None:
        """The state saved at `step` (the latest when None), tensors on the
        CPU; None when there is none.  With a `template`, each of its
        top-level keys must be in the state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self.directory, str(step),
                                        "state.pt"),
                           map_location="cpu", weights_only=True)
        if template is not None:
            missing = set(template) - set(state)
            if missing:
                raise KeyError(f"checkpoint step {step} lacks "
                               f"{sorted(missing)}")
        return state

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
