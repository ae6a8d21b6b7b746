"""Source elements: synthetic test sources and programmatic injection.

Reference analogs: GStreamer ``videotestsrc``/``appsrc`` (used throughout
the reference's tests, SURVEY.md §4) plus a tensor-native test source.
Frames are made on the host, or on the card with ``tensor_src
device=true``; ``tensor_src_callable`` pulls them from a user callable
(host arrays or CUDA tensors, pushed as they come).
"""
from __future__ import annotations

import queue as _queue
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    TensorsInfo,
    caps_from_tensors_info,
    clock_now,
    parse_caps_string,
)
from ..core.caps import VIDEO_MIME, any_media_caps
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..runtime.element import Prop, SourceElement, prop_bool
from ..runtime.pad import PadDirection, PadTemplate
from ..utils.hw_accel import device_for_accelerator

_ANY_MEDIA_CAPS = any_media_caps()


def _parse_framerate(v):
    if isinstance(v, (int, float)):
        return float(v)
    text = str(v)
    if "/" in text:
        num, den = text.split("/", 1)
        return int(num) / max(int(den), 1)
    return float(text)


class _PacedSource(SourceElement):
    """Common frame pacing + frame counting."""

    PROPERTIES = {
        "num_buffers": Prop(-1, int, "stop after N buffers (-1 = forever)"),
        "framerate": Prop(0.0, _parse_framerate, "frames/sec (0 = as fast as possible)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._frame = 0
        self._t0: Optional[float] = None

    def reset_flow(self) -> None:
        super().reset_flow()
        self._frame = 0
        self._t0 = None

    def _pace(self) -> Optional[dict]:
        """Returns timestamp kwargs for the next frame, or None when done."""
        n = self.props["num_buffers"]
        if n >= 0 and self._frame >= n:
            return None
        fps = self.props["framerate"]
        if self._t0 is None:
            self._t0 = clock_now()
        if fps > 0:
            target = self._t0 + self._frame / fps
            delay = target - clock_now()
            if delay > 0:
                time.sleep(delay)
            pts = self._frame / fps
            dur = 1.0 / fps
        else:
            pts = clock_now() - self._t0
            dur = None
        kw = {"pts": pts, "duration": dur, "offset": self._frame}
        self._frame += 1
        return kw


@register_element
class TensorSrc(_PacedSource):
    """Synthetic ``other/tensors`` source (test signal generator)."""

    ELEMENT_NAME = "tensor_src"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "dimensions": Prop("1", str, "reference dim string(s), '.'-separated"),
        "types": Prop("float32", str, "dtype(s), '.'-separated"),
        "pattern": Prop("counter", str, "zeros | ones | random | counter"),
        "seed": Prop(0, int, "RNG seed for pattern=random"),
        "device": Prop(False, prop_bool,
                       "generate frames ON the card (a torch.Generator per "
                       "frame, seeded from seed and the frame index): the "
                       "stream is device-resident from birth and no stage "
                       "pays a host→device copy"),
        "accelerator": Prop("auto", str,
                            "device of device=true frames: auto | gpu | "
                            "cuda[:N] | cpu (auto and gpu = cuda:0)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        dims = self.props["dimensions"].split(".")
        types = self.props["types"].split(".")
        if len(types) == 1:
            types = types * len(dims)
        self._info = TensorsInfo.of(
            *(TensorSpec.from_dim_string(d, t) for d, t in zip(dims, types))
        )
        self._rng = np.random.default_rng(self.props["seed"])
        self._dev: Optional[torch.device] = None  # device=true, on first frame

    def get_src_caps(self) -> Caps:
        return caps_from_tensors_info(self._info)

    def device_affinity(self) -> str:
        # device=true streams are device-resident from birth
        return "device" if self.props["device"] else "neutral"

    def _device_create(self, idx: int) -> list:
        """Every tensor of frame ``idx`` made on the device. Values differ
        from the host path's (and from nnstreamer_tpu's jax.random); the
        patterns, dtypes and ranges are the same: random floats in [0, 1),
        random integers in [0, 127)."""
        if self._dev is None:  # a missing card fails here, on the bus
            self._dev = device_for_accelerator(self.props["accelerator"])
        pattern = self.props["pattern"]
        dev = self._dev
        gen = None
        if pattern == "random":
            # mixed so that the low 32 bits (all the CPU's mt19937 uses)
            # differ with the seed and with the frame index
            gen = torch.Generator(device=dev)
            gen.manual_seed((self.props["seed"] * 0x9E3779B97F4A7C15 + idx)
                            % 2 ** 64)
        out = []
        for spec in self._info.specs:
            dt = spec.dtype.torch_dtype
            if pattern == "zeros":
                a = torch.zeros(spec.shape, dtype=dt, device=dev)
            elif pattern == "ones":
                a = torch.ones(spec.shape, dtype=dt, device=dev)
            elif pattern == "random":
                if spec.dtype.is_float:
                    a = torch.rand(spec.shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(dt)
                else:
                    a = torch.randint(0, 127, spec.shape, generator=gen,
                                      device=dev, dtype=dt)
            else:  # counter
                a = torch.full(spec.shape, idx, dtype=torch.int64,
                               device=dev).to(dt)
            out.append(a)
        return out

    def create(self) -> Optional[Buffer]:
        kw = self._pace()
        if kw is None:
            return None
        if self.props["device"]:
            return Buffer(self._device_create(self._frame - 1), **kw)
        pattern = self.props["pattern"]
        arrays = []
        for spec in self._info.specs:
            # numpy has no bfloat16: made in float32 and rounded once into
            # a CPU torch.bfloat16 tensor, the port's host bfloat16
            bf16 = spec.dtype.torch_dtype is torch.bfloat16
            dt = np.float32 if bf16 else spec.dtype.np_dtype
            if pattern == "zeros":
                a = np.zeros(spec.shape, dt)
            elif pattern == "ones":
                a = np.ones(spec.shape, dt)
            elif pattern == "random":
                if spec.dtype.is_float:
                    a = self._rng.random(spec.shape, np.float32).astype(dt)
                else:
                    a = self._rng.integers(0, 127, spec.shape).astype(dt)
            else:  # counter: every element = frame index (mod dtype range)
                a = np.full(spec.shape, self._frame - 1).astype(dt)
            arrays.append(torch.from_numpy(a).to(torch.bfloat16) if bf16
                          else a)
        return Buffer(arrays, **kw)


@register_element
class VideoTestSrc(_PacedSource):
    """Raw-video test source (GStreamer ``videotestsrc`` analog).

    Produces ``video/raw`` frames: HxWxC uint8 arrays. Patterns: smpte-ish
    gradient, solid, checkers, counter.
    """

    ELEMENT_NAME = "videotestsrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new(VIDEO_MIME)),)
    PROPERTIES = {
        "width": Prop(320, int),
        "height": Prop(240, int),
        "format": Prop("RGB", str, "RGB | BGR | GRAY8 | RGBA | BGRx"),
        "pattern": Prop("gradient", str, "gradient | solid | checkers | counter"),
        # GStreamer live-source pacing: this runtime is backpressure-
        # driven (no pipeline clock), so accepted as a no-op for the
        # reference's launch lines
        "is_live": Prop(False, prop_bool, "accepted for compat (no-op)"),
    }

    _CHANNELS = {"RGB": 3, "BGR": 3, "GRAY8": 1, "RGBA": 4, "BGRx": 4}

    def get_src_caps(self) -> Caps:
        # GStreamer test sources have no size props — size/format come from
        # downstream caps negotiation. Our push-based analog: adopt the
        # nearest downstream capsfilter's constraints (reference launch
        # idiom: videotestsrc ! video/x-raw,width=...,format=RGB ! ...)
        from .media import downstream_filter_fields

        hint = downstream_filter_fields(self)
        for key in ("width", "height"):
            if isinstance(hint.get(key), int):  # scalars only, not ranges
                self.props[key] = hint[key]
        fmt = hint.get("format")
        if isinstance(fmt, str) and fmt in self._CHANNELS:
            # only formats this source can synthesize; anything else is
            # videoconvert's job downstream
            self.props["format"] = fmt
        if not self.props["framerate"]:
            fr = hint.get("framerate")
            if isinstance(fr, tuple) and len(fr) == 2:
                self.props["framerate"] = fr[0] / max(fr[1], 1)
            elif isinstance(fr, (int, float)):
                self.props["framerate"] = float(fr)
        p = self.props
        fps = p["framerate"]
        return Caps.new(
            VIDEO_MIME,
            format=p["format"],
            width=p["width"],
            height=p["height"],
            framerate=(int(fps), 1) if fps else (0, 1),
        )

    def create(self) -> Optional[Buffer]:
        kw = self._pace()
        if kw is None:
            return None
        p = self.props
        h, w = p["height"], p["width"]
        c = self._CHANNELS[p["format"]]
        idx = self._frame - 1
        pattern = p["pattern"]
        if pattern == "solid":
            frame = np.full((h, w, c), 128, np.uint8)
        elif pattern == "checkers":
            yy, xx = np.mgrid[0:h, 0:w]
            frame = (((yy // 8 + xx // 8) % 2) * 255).astype(np.uint8)
            frame = np.repeat(frame[:, :, None], c, axis=2)
        elif pattern == "counter":
            frame = np.full((h, w, c), idx % 256, np.uint8)
        else:  # gradient
            xx = np.linspace(0, 255, w, dtype=np.uint8)
            frame = np.broadcast_to(xx[None, :, None], (h, w, c)).copy()
            frame[:, :, 0] = ((frame[:, :, 0].astype(np.int32) + idx) % 256).astype(np.uint8)
        return Buffer([frame], **kw)


@register_element
class AppSrc(SourceElement):
    """Programmatic injection source (GStreamer ``appsrc`` analog).

    The app pushes buffers with ``push_buffer()`` and terminates with
    ``end_of_stream()``. Caps come from the ``caps`` property (caps string)
    or ``set_caps_obj``.
    """

    ELEMENT_NAME = "appsrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _ANY_MEDIA_CAPS),)
    PROPERTIES = {
        "caps": Prop(None, lambda v: v, "caps string for the stream"),
        "max_queued": Prop(64, int, "producer-side bound (backpressure)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._buf_q: _queue.Queue = _queue.Queue(maxsize=self.props["max_queued"])
        self._caps_obj: Optional[Caps] = None
        if self.props["caps"]:
            self._caps_obj = parse_caps_string(self.props["caps"])

    def set_caps_obj(self, caps: Caps) -> None:
        self._caps_obj = caps

    def push_buffer(self, buf: "Buffer | np.ndarray | torch.Tensor | list",
                    timeout=None) -> None:
        if isinstance(buf, (np.ndarray, torch.Tensor)):
            buf = Buffer([buf])
        elif isinstance(buf, (list, tuple)):
            buf = Buffer(list(buf))
        self._buf_q.put(("buf", buf), timeout=timeout)

    def end_of_stream(self) -> None:
        self._buf_q.put(("eos", None))

    def get_src_caps(self) -> Caps:
        if self._caps_obj is None:
            raise ValueError(f"{self.describe()}: no caps set")
        return self._caps_obj

    def create(self) -> Optional[Buffer]:
        while self.running:
            try:
                kind, payload = self._buf_q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if kind == "eos":
                return None
            return payload
        return None


@register_element
class TensorSrcCallable(_PacedSource):
    """Pulls tensor frames from a user callable (sensor-ingestion analog of
    the reference's ``tensor_src_iio``, gsttensor_srciio.c — the sysfs/IIO
    device is replaced by an app-supplied sampler function). A sampler
    that returns CUDA tensors keeps the stream on the card."""

    ELEMENT_NAME = "tensor_src_callable"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "dimensions": Prop("1", str),
        "types": Prop("float32", str),
    }

    def __init__(self, name=None, sampler: Optional[Callable] = None, **props):
        super().__init__(name, **props)
        self.sampler = sampler
        dims = self.props["dimensions"].split(".")
        types = self.props["types"].split(".")
        if len(types) == 1:
            types = types * len(dims)
        self._info = TensorsInfo.of(
            *(TensorSpec.from_dim_string(d, t) for d, t in zip(dims, types))
        )

    def get_src_caps(self) -> Caps:
        return caps_from_tensors_info(self._info)

    def create(self) -> Optional[Buffer]:
        kw = self._pace()
        if kw is None or self.sampler is None:
            return None
        sample = self.sampler(self._frame - 1)
        if sample is None:
            return None
        arrays = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                  for a in (sample if isinstance(sample, (list, tuple))
                            else [sample])]
        return Buffer(arrays, **kw)
