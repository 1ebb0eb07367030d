"""Mid-trial checkpoints: epoch-granular train-state snapshots.

The port's copy of ``CheckpointManager`` from
``rafiki_tpu/store/checkpoint.py`` (:1-90). One safetensors file per
checkpoint, ``ckpt_<step>.safetensors``, holding a flat ``{name:
ndarray}`` dict (the train loops name their state ``leaf_<i>``),
written atomically (a temporary file in the same directory, then a
rename) with all but the newest ``keep_last`` pruned. The files are
written and read by :mod:`.tensorfile` (the card's machine has no
``safetensors`` package) in the package's own layout, so either
package's manager reads a directory that the other wrote (byte for
byte the same files: a 0-d array is stored as shape (1,) by both).
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from .tensorfile import load_file, save

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.safetensors$")


class CheckpointManager:
    """Atomic save and restore of flat ``{name: ndarray}`` dicts keyed by
    an integer step (epoch), keeping the newest ``keep_last`` on disk."""

    def __init__(self, ckpt_dir: str, keep_last: int = 2):
        self.ckpt_dir = ckpt_dir
        self.keep_last = max(1, int(keep_last))
        os.makedirs(ckpt_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"ckpt_{step}.safetensors")

    def steps(self) -> list:
        try:
            names = os.listdir(self.ckpt_dir)
        except FileNotFoundError:
            return []  # the directory was swept: no checkpoints
        return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, names)
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, arrays: Dict[str, np.ndarray]) -> str:
        path = self._path(step)
        # A sibling worker's end-of-job sweep of scoped checkpoints may
        # have removed the directory under a running trial; the save
        # makes it again rather than erring the trial.
        os.makedirs(self.ckpt_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.ckpt_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                # ascontiguousarray makes a 0-d array shape (1,), as the
                # reference's manager writes it; readers reshape.
                f.write(save({k: np.ascontiguousarray(v)
                              for k, v in arrays.items()}))
            os.replace(tmp, path)  # a crash never leaves a torn file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._prune()
        return path

    def restore(self, step: Optional[int] = None,
                ) -> Tuple[int, Dict[str, np.ndarray]]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        return step, load_file(self._path(step))

    def _prune(self) -> None:
        for s in self.steps()[:-self.keep_last]:
            try:
                os.unlink(self._path(s))
            except OSError:
                pass
