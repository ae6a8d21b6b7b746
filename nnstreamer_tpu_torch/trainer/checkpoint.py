"""Training checkpoint/resume (L4).

The port of nnstreamer_tpu's ``trainer/checkpoint.py``: full training-state
checkpoints — params, optimizer state, epoch counter, loss/accuracy
history and the data-iterator epoch — in retention-managed step
directories. The state is the port's own format: ``torch.save`` of a tree
of tensors and plain values, read back with ``weights_only=True`` (no
pickled code runs on a restore). The reference's orbax form
(``use_orbax``) is not ported on purpose: the card's machine has no orbax
and the port never needs one.

Layout: ``<dir>/step_<n>/state.pt`` + ``meta.json``. ``latest_step`` finds
the newest complete checkpoint; partial writes are ignored (written to a
``.tmp`` directory and renamed).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import torch

from ..utils.log import logger

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """Step-numbered training checkpoints with retention.

    ``save(step, state, meta)`` / ``restore(step=None) -> (state, meta)``
    where ``state`` is a tree of tensors (params/opt_state/...) and
    ``meta`` a small JSON-able dict (epoch, histories, iterator state)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> str:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            torch.save(state, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as fh:
                json.dump(meta or {}, fh)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish: partial writes never visible
        self._retain()
        logger.info("checkpoint saved: %s", final)
        return final

    # -- read ----------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for entry in os.listdir(self.directory):
            m = _STEP_RE.match(entry)
            if m and os.path.exists(os.path.join(self.directory, entry,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> dict:
        """Just the JSON meta of a step — cheap progress peek, no state IO."""
        with open(os.path.join(self.directory, f"step_{step}",
                               "meta.json")) as fh:
            return json.load(fh)

    def restore(self, step: Optional[int] = None,
                map_location: Any = None) -> Tuple[Any, dict]:
        """Restore ``(state, meta)`` of ``step`` (default the latest),
        tensors on ``map_location`` (default where they were saved)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        meta = self.read_meta(step)
        state = torch.load(os.path.join(path, "state.pt"),
                           map_location=map_location, weights_only=True)
        return state, meta

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
