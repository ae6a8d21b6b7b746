"""tensor_src_iio: Linux Industrial-I/O sensor device → tensor stream (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_srciio.c`` (2603 LoC)
— reads an IIO device's buffered scan via sysfs/devfs. A design of its own
covering the same device model:

  * device discovery under ``<base-dir>/iio:deviceN`` by ``name`` file
    (base-dir defaults to /sys/bus/iio/devices; tests point it at a fake
    tree — the reference's tests do exactly this with a mock sysfs);
  * channel enumeration from ``scan_elements/*_en`` + ``*_index`` +
    ``*_type`` (type strings like ``le:s16/32>>2`` parsed for dtype,
    storage bits, shift — same grammar the reference parses);
  * ``sampling_frequency`` written when requested; buffer ``length`` set;
  * data: reads ``/dev/iio:deviceN`` when present, else the sysfs
    ``*_raw`` per-channel values (polled mode), at ``frequency`` Hz.

Output: one (channels,) tensor per scan — float32 after applying the
per-channel shift/scale, or raw ints with ``raw=true``.

The port of nnstreamer_tpu's ``elements/iio.py``: host numpy scans, the
same bytes; a downstream filter moves them to the card.
"""
from __future__ import annotations

import os
import re
import select
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from ..core import Buffer, Caps, TensorsInfo
from ..core.tensors import TensorSpec
from ..core.caps import caps_from_tensors_info
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, SourceElement, prop_bool
from ..runtime.pad import PadDirection, PadTemplate

_DEFAULT_BASE = "/sys/bus/iio/devices"
_TYPE_RE = re.compile(r"^(?P<endian>le|be):(?P<sign>s|u)(?P<bits>\d+)/"
                      r"(?P<storage>\d+)(?:X(?P<repeat>\d+))?>>(?P<shift>\d+)$")


class _Channel:
    def __init__(self, name: str, index: int, type_str: str):
        self.name = name
        self.index = index
        m = _TYPE_RE.match(type_str.strip())
        if not m:
            raise ValueError(f"iio: bad channel type '{type_str}'")
        self.le = m.group("endian") == "le"
        self.signed = m.group("sign") == "s"
        self.bits = int(m.group("bits"))
        self.storage = int(m.group("storage"))
        self.shift = int(m.group("shift"))
        if self.storage not in (8, 16, 32, 64):
            raise ValueError(f"iio: unsupported storage {self.storage}")

    @property
    def nbytes(self) -> int:
        return self.storage // 8

    def decode(self, raw: bytes) -> int:
        fmt = {8: "b", 16: "h", 32: "i", 64: "q"}[self.storage]
        if not self.signed:
            fmt = fmt.upper()
        (v,) = struct.unpack(("<" if self.le else ">") + fmt, raw)
        v >>= self.shift
        mask = (1 << self.bits) - 1
        v &= mask
        if self.signed and v & (1 << (self.bits - 1)):
            v -= 1 << self.bits
        return v


@register_element
class TensorSrcIIO(SourceElement):
    ELEMENT_NAME = "tensor_src_iio"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "device": Prop(None, str, "IIO device name (matched against 'name')"),
        "device_number": Prop(-1, int, "or: explicit iio:deviceN number"),
        "base_dir": Prop(_DEFAULT_BASE, str, "sysfs iio root (tests: fake tree)"),
        "frequency": Prop(0.0, float, "poll/sample frequency Hz (0 = as fast "
                                      "as the device delivers / 100Hz poll)"),
        "raw": Prop(False, prop_bool, "emit raw ints instead of scaled float32"),
        "num_buffers": Prop(-1, int, "stop after N scans (-1 = endless)"),
        # reference gsttensor_srciio.c:315-379 property breadth
        "mode": Prop("continuous", str,
                     "one-shot = emit a single scan then EOS; continuous = "
                     "stream (reference operating modes)"),
        "dev_dir": Prop("/dev", str,
                        "device-node directory for buffered reads "
                        "(reference dev-dir; tests point it at a fake)"),
        "trigger": Prop("", str,
                        "trigger name written to trigger/current_trigger "
                        "at start (buffered mode; best-effort like the "
                        "reference's sysfs write)"),
        "trigger_number": Prop(-1, int,
                               "or: trigger index -> trigger name "
                               "'trigger<N>'"),
        "channels": Prop("auto", str,
                         "'auto' = all enabled scan channels; or explicit "
                         "indices '1,3,5' to enable exactly those"),
        "buffer_capacity": Prop(1, int,
                                "kernel ring capacity request (accepted; "
                                "reads here are scan-at-a-time so depth "
                                "does not change delivery)"),
        "merge_channels_data": Prop(True, prop_bool,
                                    "true = one tensor with all channels "
                                    "(reference default); false = one "
                                    "tensor per channel"),
    }
    PROP_ALIASES = {"iio_base_dir": "base_dir"}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._dir: Optional[str] = None
        self._channels: List[_Channel] = []
        self._scale = 1.0
        self._offset = 0.0
        self._dev_fh = None
        self._count = 0

    # -- device discovery ----------------------------------------------------
    def _find_device(self) -> str:
        base = self.props["base_dir"]
        if self.props["device_number"] >= 0:
            d = os.path.join(base, f"iio:device{self.props['device_number']}")
            if not os.path.isdir(d):
                raise ElementError(f"{self.describe()}: no {d}")
            return d
        want = self.props["device"]
        if not want:
            raise ElementError(f"{self.describe()}: device or device-number required")
        if not os.path.isdir(base):
            raise ElementError(f"{self.describe()}: iio base '{base}' missing")
        for entry in sorted(os.listdir(base)):
            name_file = os.path.join(base, entry, "name")
            try:
                with open(name_file) as fh:
                    if fh.read().strip() == want:
                        return os.path.join(base, entry)
            except OSError:
                continue
        raise ElementError(f"{self.describe()}: IIO device '{want}' not found")

    def _read_channels(self) -> None:
        scan = os.path.join(self._dir, "scan_elements")
        chans = []
        if os.path.isdir(scan):
            for f in sorted(os.listdir(scan)):
                if not f.endswith("_en"):
                    continue
                ch = f[:-3]
                try:
                    with open(os.path.join(scan, f)) as fh:
                        if fh.read().strip() != "1":
                            continue
                    with open(os.path.join(scan, f"{ch}_index")) as fh:
                        index = int(fh.read().strip())
                    with open(os.path.join(scan, f"{ch}_type")) as fh:
                        type_str = fh.read().strip()
                except OSError as e:
                    raise ElementError(f"{self.describe()}: bad channel {ch}: {e}")
                chans.append(_Channel(ch, index, type_str))
        else:
            # no buffered scan: poll *_raw files as one channel each
            for f in sorted(os.listdir(self._dir)):
                if f.endswith("_raw"):
                    c = _Channel(f[:-4], len(chans), "le:s32/32>>0")
                    c.poll_file = os.path.join(self._dir, f)
                    chans.append(c)
        if not chans:
            raise ElementError(f"{self.describe()}: no enabled channels")
        want = str(self.props["channels"]).strip().lower()
        if want and want != "auto":
            try:
                keep = {int(p) for p in want.split(",")}
            except ValueError:
                raise ElementError(
                    f"{self.describe()}: channels must be 'auto' or a "
                    f"','-separated index list, not '{want}'")
            chans = [c for c in chans if c.index in keep]
            if not chans:
                raise ElementError(
                    f"{self.describe()}: no enabled channel has an index "
                    f"in {sorted(keep)}")
        self._channels = sorted(chans, key=lambda c: c.index)

    def _read_scalar(self, fname: str, default: float) -> float:
        try:
            with open(os.path.join(self._dir, fname)) as fh:
                return float(fh.read().strip())
        except OSError:
            return default

    # -- source lifecycle ----------------------------------------------------
    def get_src_caps(self) -> Caps:
        self._dir = self._find_device()
        self._read_channels()
        self._scale = self._read_scalar("in_scale", 1.0)
        self._offset = self._read_scalar("in_offset", 0.0)
        freq = self.props["frequency"]
        if freq > 0:
            try:
                with open(os.path.join(self._dir, "sampling_frequency"), "w") as fh:
                    fh.write(str(freq))
            except OSError:
                pass  # fixed-rate devices reject writes; poll pacing still applies
        trig = self.props["trigger"]
        if not trig and self.props["trigger_number"] >= 0:
            trig = f"trigger{self.props['trigger_number']}"
        if trig:
            # reference: select the capture trigger via sysfs (best effort
            # — polled/fake trees have no trigger directory)
            try:
                with open(os.path.join(self._dir, "trigger",
                                       "current_trigger"), "w") as fh:
                    fh.write(trig)
            except OSError:
                pass
        dev_node = os.path.join(self.props["dev_dir"],
                                os.path.basename(self._dir))
        if os.path.exists(dev_node) and os.path.isdir(
                os.path.join(self._dir, "scan_elements")):
            try:
                self._dev_fh = open(dev_node, "rb", buffering=0)
            except OSError:
                self._dev_fh = None
        dtype = "int32" if self.props["raw"] else "float32"
        if self.props["merge_channels_data"]:
            specs = [TensorSpec((len(self._channels),), dtype)]
        else:
            specs = [TensorSpec((1,), dtype) for _ in self._channels]
        return caps_from_tensors_info(TensorsInfo.of(*specs))

    def create(self) -> Optional[Buffer]:
        limit = self.props["num_buffers"]
        if str(self.props["mode"]).lower() in ("one-shot", "oneshot"):
            limit = 1 if limit < 0 else min(limit, 1)
        if 0 <= limit <= self._count:
            return None
        freq = self.props["frequency"]
        if self._dev_fh is not None:
            values = self._read_buffered()
        else:
            if freq <= 0:
                freq = 100.0
            time.sleep(1.0 / freq)
            values = self._read_polled()
        if values is None:
            return None
        self._count += 1
        if self.props["raw"]:
            arr = np.asarray(values, np.int32)
        else:
            arr = ((np.asarray(values, np.float64) + self._offset)
                   * self._scale).astype(np.float32)
        if self.props["merge_channels_data"]:
            return Buffer([arr])
        return Buffer([arr[i:i + 1] for i in range(len(self._channels))])

    def _scan_layout(self) -> Tuple[List[int], int]:
        """Kernel IIO scan layout: each element is aligned to its own storage
        size, and the scan is padded to the largest element's alignment (the
        reference computes the same offsets from _index/_type)."""
        offsets, off = [], 0
        for c in self._channels:
            n = c.nbytes
            off = (off + n - 1) // n * n  # align up to the element size
            offsets.append(off)
            off += n
        biggest = max(c.nbytes for c in self._channels)
        total = (off + biggest - 1) // biggest * biggest
        return offsets, total

    def _read_buffered(self) -> Optional[List[int]]:
        offsets, scan_bytes = self._scan_layout()
        fd = self._dev_fh.fileno()
        raw = b""
        while len(raw) < scan_bytes:
            if not self.running:
                return None
            # poll with timeout so stop() can cancel us (a bare read() would
            # block unkillably when the device has no fresh scan)
            ready, _, _ = select.select([fd], [], [], 0.1)
            if not ready:
                continue
            try:
                chunk = os.read(fd, scan_bytes - len(raw))
            except OSError:
                return None
            if not chunk:
                return None
            raw += chunk
        return [c.decode(raw[o:o + c.nbytes])
                for c, o in zip(self._channels, offsets)]

    def _read_polled(self) -> Optional[List[int]]:
        values = []
        for c in self._channels:
            path = getattr(c, "poll_file",
                           os.path.join(self._dir, f"{c.name}_raw"))
            try:
                with open(path) as fh:
                    values.append(int(fh.read().strip()))
            except OSError:
                return None
        return values

    def reset_flow(self) -> None:
        super().reset_flow()
        self._count = 0

    def stop(self) -> None:
        super().stop()
        if self._dev_fh is not None:
            self._dev_fh.close()
            self._dev_fh = None
