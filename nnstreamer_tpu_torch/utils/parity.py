"""Shared label-parity harness — the port's half of nnstreamer_tpu's
``utils/parity.py``.

One definition of the parity flow: frames go through
``tensor_filter ! tensor_decoder mode=image_labeling`` on a given framework
and come back as label indices, so two runtimes (``framework=torch`` on a
``.tflite`` file and ``framework=tflite``, the interpreter) are compared
through the same pipeline.

nnstreamer_tpu's ``export_f32_mobilenet`` (the flax MobileNet-v2 through
jax2tf to a ``.tflite``) has no counterpart here: the port has no exporter
from torch to tflite yet (ROADMAP A7, beside ``aot/export``).
"""
from __future__ import annotations

import sys
import types
from typing import Callable, List, Sequence


def register_entry_module(name: str, fwd: Callable) -> str:
    """Expose ``fwd`` as an importable ``<name>:entry`` model for the torch
    backend (module entries are one of its model formats). Returns the
    model string. Caller owns cleanup (tests: monkeypatch.setitem)."""
    mod = types.ModuleType(name)
    mod.entry = fwd
    sys.modules[name] = mod
    return f"{name}:entry"


def labels_through(framework: str, model: str, frames: Sequence,
                   timeout: float = 120.0, extra: str = "") -> List[int]:
    """Push ``frames`` ((1, 224, 224, 3) float32 each) through the canonical
    parity pipeline on ``framework`` and return the decoded label indices,
    in order. ``extra`` is appended to the filter's properties (e.g.
    ``accelerator=cpu`` or ``custom=...``)."""
    from ..runtime.parse import parse_launch

    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        "dimensions=3:224:224:1,types=float32 "
        f"! tensor_filter framework={framework} model={model} {extra} "
        "! tensor_decoder mode=image_labeling "
        f"! tensor_sink name=out max-stored={max(64, len(frames))}"
    )
    got: List[int] = []
    pipe.get("out").connect(lambda b: got.append(b.meta["label_index"]))
    pipe.play()
    src = pipe.get("in")
    for f in frames:
        src.push_buffer(f)
    src.end_of_stream()
    pipe.wait(timeout=timeout)
    pipe.stop()
    return got
