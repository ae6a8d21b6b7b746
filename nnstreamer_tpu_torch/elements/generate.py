"""tensor_generate: streaming autoregressive generation as a pipeline
stage (L3).

The port of nnstreamer_tpu's ``elements/generate.py``. ``tensor_filter`` +
``models/lm_serving`` emits one buffer per prompt holding the whole
generated sequence; ``tensor_generate`` prefills the prompt once, then
emits ONE BUFFER PER DECODED TOKEN downstream, so sinks and decoders see
generation incrementally, the way a text UI or an SSE endpoint reads an LM.

    appsrc (B,P) int32 ! tensor_generate
        model=nnstreamer_tpu_torch.models.lm_serving:base steps=64
    ! tensor_sink     # receives `steps` buffers of (B, 1) int32 per prompt

Properties: ``model`` (module:attr of an entry exposing
``make_streaming(device, temperature)``), ``steps`` (tokens per prompt),
``conversation`` (keep the KV cache across prompt buffers; a buffer with
``meta["reset"]`` starts a new conversation), ``serve_dtype`` /
``cache_len`` (the entry's serving knobs), ``temperature`` / ``seed``
(sampling), ``accelerator`` (``auto`` / ``gpu`` / ``cuda`` = ``cuda:0``,
``cuda:N``, or ``cpu``). Each output buffer is a host (B, 1) int32 array
carrying ``meta["gen_step"]`` (0-based) and ``meta["gen_last"]``.

Not in this package yet: ``mesh`` is accepted as a property, and a
non-empty value is an error when the first buffer arrives.
"""
from __future__ import annotations

import importlib

import numpy as np

from ..core import (
    Buffer,
    Caps,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
)
from ..models.lm_serving import with_serve_knobs
from ..registry.elements import register_element
from ..runtime.element import Element, ElementError, Prop, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.hw_accel import device_for_accelerator


@register_element
class TensorGenerate(Element):
    ELEMENT_NAME = "tensor_generate"
    SINK_TEMPLATES = (
        PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),
    )
    SRC_TEMPLATES = (
        PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),
    )
    PROPERTIES = dict(Element.PROPERTIES)
    PROPERTIES.update({
        "model": Prop("", str,
                      "module:attr of an entry with make_streaming(device)"),
        "steps": Prop(16, int, "tokens generated per prompt buffer"),
        "mesh": Prop("", str, "device mesh spec: not ported (must be empty)"),
        "conversation": Prop(False, prop_bool,
                             "persist the KV cache across prompt buffers "
                             "(multi-turn; buffer meta reset=True starts "
                             "a new conversation)"),
        "serve_dtype": Prop("", str,
                            "serving dtype for the entry's params + KV "
                            "cache (e.g. bfloat16; activations stay "
                            "float32; entry must be a dataclass with a "
                            "serve_dtype field)"),
        "cache_len": Prop(0, int,
                          "right-size the serving KV cache to this length "
                          "instead of the model's max_seq (entry dataclass "
                          "field cache_len; 0 = max_seq)"),
        "temperature": Prop(0.0, float,
                            "0 = greedy (deterministic); > 0 = sampling"),
        "seed": Prop(0, int, "sampling seed (temperature > 0)"),
        "accelerator": Prop("auto", str,
                            "auto | gpu | cuda | cuda:N | cpu (auto, gpu "
                            "and cuda run on cuda:0)"),
    })

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._stream = None
        self._session = None

    def _ensure_stream(self):
        """Lazy build on the first buffer (tensor_filter's open pattern):
        load failures surface as bus ERRORs from the streaming thread,
        and a never-played element never pays for its parameters."""
        if self._stream is not None:
            return self._stream
        if self.props["mesh"]:
            raise ElementError(
                f"{self.name}: mesh={self.props['mesh']!r} is not ported to "
                "nnstreamer_tpu_torch (one device only; leave mesh empty)")
        model = self.props["model"]
        if not model or ":" not in model:
            raise ElementError(
                f"{self.name}: model must be a module:attr entry with "
                f"make_streaming(device), got {model!r}")
        mod_name, _, attr = model.partition(":")
        entry = getattr(importlib.import_module(mod_name), attr)
        try:
            entry = with_serve_knobs(entry, self.props["serve_dtype"],
                                     self.props["cache_len"], model)
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from e
        conversation = self.props["conversation"]
        what = "make_session" if conversation else "make_streaming"
        maker = getattr(entry, what, None)
        if maker is None:
            raise ElementError(
                f"{self.name}: {model} has no {what}(device) — "
                "use tensor_filter for whole-sequence entries")
        try:
            device = device_for_accelerator(self.props["accelerator"])
        except ValueError as e:
            raise ElementError(f"{self.name}: {e}") from e
        temperature = float(self.props["temperature"])
        if conversation:
            self._session = maker(device, temperature)
            self._stream = self._session.generate
        else:
            self._stream = maker(device, temperature)
        return self._stream

    def stop(self) -> None:
        self._stream = None
        self._session = None

    def transform_caps(self, src_pad: Pad) -> Caps:
        # (B, 1) per token, B known only per buffer: a flexible stream
        return caps_from_tensors_info(TensorsInfo((), TensorFormat.FLEXIBLE))

    def chain(self, pad: Pad, buf: Buffer) -> None:
        stream = self._ensure_stream()
        if self._session is not None and buf.meta.get("reset"):
            self._session.reset()
        prompt = np.asarray(buf.as_numpy().tensors[0])
        if prompt.ndim != 2:
            raise ElementError(
                f"{self.name}: prompt must be (batch, prompt_len) int32, "
                f"got shape {prompt.shape}")
        steps = int(self.props["steps"])
        for i, token in enumerate(stream(prompt, steps,
                                         rng=int(self.props["seed"]))):
            out = Buffer([token.cpu().numpy().reshape(-1, 1)])
            out.copy_metadata_from(buf)
            out.meta["gen_step"] = i
            out.meta["gen_last"] = i == steps - 1
            self.push(out)
