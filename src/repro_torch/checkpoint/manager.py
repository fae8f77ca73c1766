"""Checkpoint rotation and auto-resume (port of
``repro/checkpoint/manager.py``): ``CheckpointManager`` keeps the newest
``keep_n`` steps of a directory and restores the newest valid one."""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

from repro_torch.checkpoint import checkpoint as ckpt

_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 save_every: int = 100):
        self.directory = directory
        self.keep_n = keep_n
        self.save_every = save_every
        os.makedirs(directory, exist_ok=True)

    def steps(self) -> list[int]:
        """The steps with a written manifest, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        path = ckpt.save(self.directory, step, tree, extra)
        self._rotate()
        return path

    def restore_latest(self, like: Any) -> tuple[Optional[int], Any]:
        """(step, tree) of the newest valid checkpoint, or (None, like)."""
        for step in reversed(self.steps()):
            try:
                return step, ckpt.restore(self.path(step), like)
            except Exception:
                continue   # half-written/corrupt → fall back to older
        return None, like

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.path(s), ignore_errors=True)
