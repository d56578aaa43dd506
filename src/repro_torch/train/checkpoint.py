"""Asynchronous checkpointing in the reference's layout, after
``repro/train/checkpoint.py``.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json   (tmp-dir + atomic
rename, so a killed writer never publishes a torn checkpoint — the same
atomicity contract as core.tracestore).

Leaves are stored unsharded under the reference's keys
(``models.convert.state_to_flat``: the parameter path joined by ``/``,
each segment's leaves stacked over its layers), so a directory written by
either package restores into the other. Async: ``save(...,
blocking=False)`` snapshots to host memory synchronously (the training
step updates the state in place afterwards) and writes in a background
thread; ``wait`` joins it and raises what it raised.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..models.convert import state_from_flat, state_to_flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -------------------------------------------------------------
    def save(self, state, step: int, blocking: bool = True,
             extra: Optional[Dict] = None) -> None:
        flat = state_to_flat(state)     # host snapshot (synchronous)
        if blocking:
            self._write(flat, step, extra or {})
        else:
            self.wait()                 # one in-flight write at a time
            self._thread = threading.Thread(
                target=self._write_async, args=(flat, step, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint write failed") \
                from err

    def _write_async(self, flat, step, extra) -> None:
        try:
            self._write(flat, step, extra)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, flat: Dict[str, np.ndarray], step: int,
               extra: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "n_leaves": len(flat), **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """The state at ``step`` (the latest by default) in ``template``'s
        structure, devices and dtypes; raises KeyError for a leaf the
        checkpoint lacks and ValueError for a shape that differs."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}", "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return state_from_flat(template, flat)
