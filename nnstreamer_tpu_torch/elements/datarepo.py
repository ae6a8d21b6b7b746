"""datareposrc / datareposink: MLOps dataset reader/writer (L3).

Reference analog: ``gst/datarepo/`` (2920 LoC) — raw sample file + JSON meta
(caps, sample offsets); the src supports ``start-sample-index`` /
``stop-sample-index``, ``epochs``, and ``is-shuffle`` for reproducible
training data order (gstdatareposrc.h:82-88), through nnstreamer_tpu's
``elements/datarepo.py``.

The files are nnstreamer_tpu's: a file either package writes reads back
byte-exact in the other. A bfloat16 tensor is written and read as its
bit patterns (numpy has no bfloat16; it arrives and leaves as a CPU
``torch.bfloat16`` tensor, one copy down for a card tensor). With
``use-native=true`` (the default) the samples come from the C++ prefetcher
(``native.RepoReader``, a background thread of ``pread`` into pooled
blocks) when the native runtime is built; otherwise, or with
``use-native=false``, from numpy's memmap. Both read the same order
through the same seeded shuffle.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

import torch

from ..core import (
    Buffer,
    DataType,
    Caps,
    TensorsInfo,
    caps_from_tensors_info,
    parse_caps_string,
    tensors_info_from_caps,
)
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, SinkElement, SourceElement, prop_bool
from ..core.buffer import bf16_bits, bf16_from_bits
from ..runtime.pad import Pad, PadDirection, PadTemplate


@register_element
class DataRepoSink(SinkElement):
    ELEMENT_NAME = "datareposink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    PROPERTIES = {
        "location": Prop(None, str, "raw sample data file"),
        "json": Prop(None, str, "metadata JSON file"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fh = None
        self._count = 0
        self._info: Optional[TensorsInfo] = None

    def start(self) -> None:
        if not self.props["location"] or not self.props["json"]:
            raise ElementError(f"{self.describe()}: location and json required")
        self._fh = open(self.props["location"], "wb")
        self._count = 0

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._info = tensors_info_from_caps(caps)

    def render(self, buf: Buffer) -> None:
        for t in buf.as_numpy().tensors:
            if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
                t = bf16_bits(t)  # the bytes of nnstreamer_tpu's bfloat16
            # buffer-protocol write: no per-tensor .tobytes() copy
            self._fh.write(np.ascontiguousarray(t).data)
        self._count += 1

    def stop(self) -> None:
        if self._fh is None:
            return
        self._fh.close()
        self._fh = None
        meta = {
            "gst_caps": str(caps_from_tensors_info(self._info)) if self._info else "",
            "total_samples": self._count,
            "sample_size": self._info.nbytes if self._info else 0,
        }
        with open(self.props["json"], "w") as fh:
            json.dump(meta, fh)


@register_element
class DataRepoSrc(SourceElement):
    ELEMENT_NAME = "datareposrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "location": Prop(None, str, "raw sample data file"),
        "json": Prop(None, str, "metadata JSON file"),
        "start_sample_index": Prop(0, int),
        "stop_sample_index": Prop(-1, int, "-1 = last"),
        "epochs": Prop(1, int),
        "start_epoch": Prop(0, int,
                            "resume: skip the first K epochs while keeping "
                            "the seeded shuffle stream aligned (trainer "
                            "checkpoint meta's data_epoch)"),
        "is_shuffle": Prop(False, prop_bool, "shuffle sample order per epoch"),
        "seed": Prop(0, int, "shuffle RNG seed (reproducibility)"),
        "use_native": Prop(True, prop_bool,
                           "prefetch samples with the C++ reader when built"),
        "tensors_sequence": Prop(None, str,
                                 "read only these tensor indices of each "
                                 "sample, in order (reference prop)"),
        # reference gstdatareposrc.c:191-196: optional caps override
        # describing the sample format (wins over the JSON's gst_caps)
        "caps": Prop(None, str,
                     "caps string describing the stored samples "
                     "(optional; overrides the metadata JSON)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._info: Optional[TensorsInfo] = None
        self._sequence: Optional[List[int]] = None
        self._data: Optional[np.memmap] = None
        self._native_reader = None
        self._order: List[int] = []
        self._pos = 0
        self._epoch = 0
        self._epochs = 1
        self._rng = np.random.default_rng(self.props["seed"])

    def get_src_caps(self) -> Caps:
        # the sample count always comes from the JSON; a caps property
        # overrides only the stored format
        with open(self.props["json"]) as fh:
            meta = json.load(fh)
        caps = parse_caps_string(self.props["caps"] or meta["gst_caps"])
        self._info = tensors_info_from_caps(caps)
        self._sample_size = self._info.nbytes
        # reference tensors-sequence: read only the chosen tensors of each
        # sample, in the given order; announced caps follow the selection
        seq = self.props["tensors_sequence"]
        self._sequence = None
        if seq:
            picks = [int(p) for p in str(seq).split(",") if p.strip()]
            n = len(self._info.specs)
            bad = [p for p in picks if not 0 <= p < n]
            if bad:
                raise ElementError(
                    f"{self.describe()}: tensors-sequence {bad} out of "
                    f"range for a {n}-tensor sample")
            self._sequence = picks
            caps = caps_from_tensors_info(
                TensorsInfo.of(*(self._info.specs[p] for p in picks)))
        total = meta["total_samples"]
        start = self.props["start_sample_index"]
        stop = self.props["stop_sample_index"]
        stop = total - 1 if stop < 0 else min(stop, total - 1)
        if start > stop:
            raise ElementError(f"{self.describe()}: start {start} > stop {stop}")
        self._indices = list(range(start, stop + 1))
        self._data = np.memmap(self.props["location"], dtype=np.uint8, mode="r")
        # epochs<=0 behaves as one epoch on both paths (native clamps the same)
        self._epochs = max(self.props["epochs"], 1)
        resume = min(max(self.props["start_epoch"], 0), self._epochs)
        # advance the shuffle stream past the completed epochs so the resumed
        # order continues exactly where the interrupted run left off
        for _ in range(resume):
            self._begin_epoch()
        self._epoch = resume
        if self._epoch >= self._epochs:
            self._order = []
        else:
            self._begin_epoch()
        if self.props["use_native"]:
            self._open_native()
        return caps

    # keep the materialized multi-epoch order bounded; past this the python
    # per-epoch path is the right trade (O(N) memory)
    _NATIVE_MAX_ORDER = 1 << 24

    def _open_native(self) -> None:
        """Hand the full multi-epoch sample order to the C++ prefetcher so
        disk reads overlap pipeline compute (including across epochs)."""
        from .. import native

        if self._native_reader is not None:
            self._native_reader.close()
            self._native_reader = None
        if not native.available():
            return
        epochs = max(self.props["epochs"], 1)
        resume = min(max(self.props["start_epoch"], 0), epochs)
        if (epochs - resume) * len(self._indices) > self._NATIVE_MAX_ORDER:
            return
        idx = np.asarray(self._indices, np.uint64)
        rng = np.random.default_rng(self.props["seed"])
        parts = []
        for n in range(epochs):
            e = idx.copy()
            if self.props["is_shuffle"]:
                rng.shuffle(e)  # same Generator draws as the python path
            if n >= resume:  # skipped epochs still consume the rng stream
                parts.append(e)
        if not parts:
            return
        full_order = np.concatenate(parts) if len(parts) > 1 else parts[0]
        try:
            self._native_reader = native.RepoReader(
                self.props["location"], self._sample_size, full_order,
            )
        except (OSError, RuntimeError):
            self._native_reader = None

    def reset_flow(self) -> None:
        super().reset_flow()
        self._epoch = 0
        self._pos = 0
        # replay determinism: a fresh run re-seeds the shuffle stream, so the
        # python and native paths emit identical orders on every play()
        self._rng = np.random.default_rng(self.props["seed"])
        if self._native_reader is not None:
            self._native_reader.close()
            self._native_reader = None

    def _begin_epoch(self) -> None:
        self._order = list(self._indices)
        if self.props["is_shuffle"]:
            self._rng.shuffle(self._order)
        self._pos = 0

    def create(self) -> Optional[Buffer]:
        reader = self._native_reader  # local ref: stop() may null it
        if reader is not None:
            return self._create_native(reader)
        if self._pos >= len(self._order):
            self._epoch += 1
            if self._epoch >= self._epochs:
                return None
            self._begin_epoch()
        idx = self._order[self._pos]
        self._pos += 1
        base = idx * self._sample_size
        raw = np.asarray(self._data[base:base + self._sample_size])
        return self._unpack(raw, idx)

    def _create_native(self, reader) -> Optional[Buffer]:
        try:
            got = reader.next()
        except StopIteration:
            return None
        except OSError as e:
            raise ElementError(f"{self.describe()}: native read failed: {e}")
        if got is None:  # no timeout requested, should not happen
            return None
        view, idx, block = got
        try:
            return self._unpack(view, int(idx))
        finally:
            reader.release(block)

    def _unpack(self, raw: np.ndarray, idx: int) -> Buffer:
        tensors = []
        off = 0
        for spec in self._info.specs:
            chunk = raw[off:off + spec.nbytes]
            if spec.dtype is DataType.BFLOAT16:
                # a copy: a native block is reused once released
                tensors.append(bf16_from_bits(chunk.view(np.uint16).copy())
                               .reshape(spec.shape))
            else:
                tensors.append(chunk.view(spec.dtype.np_dtype)
                               .reshape(spec.shape).copy())
            off += spec.nbytes
        if self._sequence is not None:
            tensors = [tensors[p] for p in self._sequence]
        return Buffer(tensors, offset=idx)

    def stop(self) -> None:
        # teardown order matters: drop the run flag (so the woken task thread
        # can't emit a fake EOS), unblock a consumer stuck in next(), join the
        # task thread, and only then free native state
        self._running.clear()
        reader = self._native_reader
        if reader is not None:
            reader.cancel()
        super().stop()
        if reader is not None:
            reader.close()
            self._native_reader = None
