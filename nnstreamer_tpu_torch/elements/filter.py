"""tensor_filter: THE inference element (L3).

Reference analog: ``gst/nnstreamer/tensor_filter/tensor_filter.c`` (1581 LoC)
+ property/lifecycle logic from ``tensor_filter_common.c`` (3118 LoC). Caps
negotiation opens the backend and loads model info (§3.1 call stack); the
steady-state chain (§3.2) runs: validate → input-combination → invoke (timed)
→ output-combination → push. Notes:

* outputs stay device-resident (CUDA tensors) between filter stages;
* invoke statistics use the same 10-sample sliding window;
* QoS throttling honors ``tensor_rate`` THROTTLE events exactly like the
  reference (``gst_tensor_filter_check_throttling_delay``, tensor_filter.c:512);
* ``framework=auto`` detects the backend from the model extension via the
  config's framework_priority (tensor_filter_common.c:1218).

* ``model=registry://name[@version]`` resolves through
  ``registry/models.py``; its ``framework`` entry feeds ``framework=auto``,
  and a ``builtin://`` model picks ``torch``.

* memory accounting (``obs/memory.py``, while ``obs.memory.ACTIVE``): the
  model's param footprint at backend open and the byte channels the
  torch backend measures over the first invoke on the card, keyed by the
  profiler's series name; an OOM-shaped invoke failure lands in the
  flight recorder with this stage's name.

* segment fusion (``runtime/fusion.py``): a filter inside a fused
  segment runs as a stage of the segment's one dispatch
  (``fusion_stage``: input-combination → model → output-combination);
  sync-invoke, latency profiling, invoke-dynamic and suspend make it a
  barrier. A placement pin (``set_placement_device``) picks the card its
  backend opens on.

* suspend (``suspend=<ms>``): a watchdog thread releases the backend
  after that much idle time, so the model's weights go back to the
  allocator; the next buffer reopens it under the invoke lock.

* hot model swap (``is-updatable``): ``reload_model`` reloads the model
  in place (the backend's RELOAD_MODEL event), ``prepare_model`` →
  ``commit_model`` → ``release_prepared`` flips to a separately opened
  backend. On the card a fused segment's CUDA graphs hold the old
  weights' addresses, so a swap drops the graphs first, waits on the CUDA
  event recorded behind the last replay that read the old weights (the
  segment's fence; for an unfused filter an event behind its last
  invoke), and only then lets the old weights go. ``swap_log`` records
  the order. The layout and tensor-name properties are declarative, as
  in nnstreamer_tpu: the port's models take NHWC and address tensors by
  position.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from ..analysis.sanitizer import named_lock
from ..backends.base import (
    Accelerator,
    BackendEvent,
    FilterBackend,
    FilterProperties,
    acquire_backend,
    release_backend,
)
from ..core import (
    Buffer,
    Caps,
    Event,
    EventType,
    MessageType,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
    clock_now,
    tensors_info_from_caps,
)
from ..obs import memory as obs_memory
from ..obs import profile as obs_profile
from ..registry.config import get_config
from ..registry.elements import register_element
from ..registry.subplugin import SubpluginKind, names as subplugin_names
from ..runtime.element import ElementError, Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger
from ..utils.stats import InvokeStats


def _layout_list(v) -> str:
    """Validate a ','-separated layout declaration (reference accepts
    any|NHWC|NCHW|none per tensor, tensor_filter_common.c:923-926)."""
    s = str(v).strip()
    for part in filter(None, (p.strip() for p in s.split(","))):
        if part.lower() not in ("any", "nhwc", "nchw", "none"):
            raise ValueError(
                f"layout '{part}' not one of any|NHWC|NCHW|none")
    return s


def _parse_combination(v) -> Optional[List[int]]:
    """Parse "0,2,1" style tensor index lists (input-combination)."""
    if v is None or v == "":
        return None
    return [int(p) for p in str(v).split(",")]


def _parse_out_combination(v) -> Optional[List[tuple]]:
    """Parse output-combination: "i0,o1" (i=input passthrough, o=model
    output; bare ints mean outputs) — reference ``output-combination`` prop
    (tensor_filter.c:857-876)."""
    if v is None or v == "":
        return None
    out = []
    for p in str(v).split(","):
        p = p.strip()
        if p.startswith("i"):
            out.append(("i", int(p[1:])))
        elif p.startswith("o"):
            out.append(("o", int(p[1:])))
        else:
            out.append(("o", int(p)))
    return out


@register_element
class TensorFilter(TransformElement):
    ELEMENT_NAME = "tensor_filter"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    DEVICE_AFFINITY = "device"  # model on the card; outputs stay device-resident
    PROPERTIES = {
        "framework": Prop("auto", str, "backend name or 'auto' (detect from model ext)"),
        "model": Prop("", str, "module:attr of a callable or model entry, "
                      "builtin://<name>[?k=v...] or registry://name[@ver]"),
        "custom": Prop("", str, "backend-specific option string 'k:v,k2:v2'"),
        "accelerator": Prop("auto", str,
                            "auto | cpu | gpu (auto and gpu run on cuda:0)"),
        "input_combination": Prop(None, _parse_combination,
                                  "indices of input tensors passed to the model"),
        "output_combination": Prop(None, _parse_out_combination,
                                   "i<N>=input passthrough, o<N>=model output; plain ints = outputs"),
        "shared_tensor_filter_key": Prop("", str, "share one opened model across elements"),
        "latency_report": Prop(False, prop_bool, "post latency messages on the bus"),
        "throttle": Prop(True, prop_bool, "honor QoS throttle events from tensor_rate"),
        "sync_invoke": Prop(False, prop_bool,
                            "block until device results are ready (debug/bench)"),
        "latency_sampling": Prop(10, int,
                                 "block on every Nth invoke to sample true "
                                 "device latency (0 = never); dispatch time "
                                 "is recorded every invoke"),
        # reference tensor_filter_common.c property breadth
        "invoke_dynamic": Prop(False, prop_bool,
                               "output shape decided per invoke; src caps "
                               "become flexible (reference invoke-dynamic, "
                               "tensor_filter.c:692,900-914)"),
        "suspend": Prop(0.0, float,
                        "unload the framework after this many idle ms; "
                        "reopened transparently on the next buffer "
                        "(reference suspend prop, 0 = never)"),
        "is_updatable": Prop(True, prop_bool,
                             "allow reload_model() hot swaps (reference "
                             "is-updatable)"),
        "input_dims": Prop("", str,
                           "force model input dims '3:224:224:1[,...]' for "
                           "backends that can't self-describe (reference "
                           "input prop)"),
        "input_types": Prop("", str, "force model input dtypes 'uint8,...'"),
        "output_dims": Prop("", str, "force model output dims (reference output)"),
        "output_types": Prop("", str, "force model output dtypes"),
        # reference tensor-name props (tensorflow signature tensors);
        # carried on the element for launch-line compat, consumed by
        # backends that address tensors by name
        "inputname": Prop("", str, "input tensor names 'a,b' (reference)"),
        "outputname": Prop("", str, "output tensor names (reference)"),
        # reference data-layout declaration (tensor_filter_common.c:923-947:
        # any|NHWC|NCHW|none per tensor, ','-separated). Declarative here
        # as there: the port's models are NHWC-native
        "inputlayout": Prop("", _layout_list,
                            "declared input data layout per tensor: "
                            "any|NHWC|NCHW|none, ','-separated"),
        "outputlayout": Prop("", _layout_list,
                             "declared output data layout per tensor"),
        # reference tensor_filter.c:366-510: ``latency``/``throughput`` are
        # SETTABLE mode flags (0 off, 1 on) that enable profiling; reading
        # them back returns the measured value (get_property below)
        "latency": Prop(0, int,
                        "1 = profile device latency every invoke "
                        "(reference latency prop); read back as ms"),
        "throughput": Prop(0, int,
                           "1 = enable throughput accounting (reference "
                           "throughput prop); read back as fps"),
    }
    # the reference's original property spellings (tensor_filter.c
    # "input"/"inputtype"/"output"/"outputtype") — drop-in launch lines
    PROP_ALIASES = {
        "input": "input_dims",
        "inputtype": "input_types",
        "output": "output_dims",
        "outputtype": "output_types",
    }
    # config-file: the generic key=value property file lives in Element
    # (reference gst_tensor_parse_config_file); _apply_config_file below
    # additionally routes non-property lines into custom options.

    # LATENCY-query tuning (reference tensor_filter.c:110-120): headroom
    # padded onto the reported estimate to limit re-report churn while
    # tracking a maximum; threshold of downward deviation that still
    # forces a re-report
    LATENCY_REPORT_HEADROOM = 0.05
    LATENCY_REPORT_THRESHOLD = 0.25

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.backend: Optional[FilterBackend] = None
        self.stats = InvokeStats()
        self._latency_reported = 0.0  # last value handed to a LATENCY query
        self._latency_posted = 0.0    # estimate last announced on the bus
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._throttle_delay_s = 0.0
        self._last_accept_ts = 0.0  # last accepted frame (QoS throttle gate)
        self._model_view_info: Optional[TensorsInfo] = None
        # THE invoke lock: backend open/close, invokes, suspend/resume
        # unloads and hot-swap flips serialize on it (per-instance name —
        # pipelines run many filters)
        self._backend_lock = named_lock(
            f"TensorFilter._backend_lock:{self.name}")
        # last completed invoke (suspend idle clock)
        self._last_invoke_ts = 0.0  # guarded-by: _backend_lock
        self._suspend_thread: Optional[threading.Thread] = None
        self._suspend_stop = threading.Event()
        # hot swap / suspend: (step, monotonic s) in order — the fence
        # waited on ("segment fence": behind the segment's last replay,
        # "stream fence": behind the last invoke on the backend's card,
        # "no fence": nothing on a card), then "released" once the old
        # weights were let go
        self.swap_log: deque = deque(maxlen=64)
        # fences of retired backends from commit_model, by id
        self._retire_fences: Dict[int, tuple] = {}
        # memory accounting (obs/memory.py): armed at backend open while
        # accounting is on, consumed by the first invoke
        self._mem_pending = False
        # placement-planner device pin for this filter's stage
        # (runtime/placement.py): consumed at backend open; an explicit
        # user custom=device:N always wins
        self._placement_device_index: Optional[int] = None

    def set_placement_device(self, index: Optional[int]) -> None:
        """Planner-assigned card for this filter's stage. Applies the
        next time the backend opens (play(), supervised restart), never
        mid-invoke; None clears the pin."""
        self._placement_device_index = index

    SUBPLUGIN_KIND = SubpluginKind.FILTER  # read-only sub-plugins prop

    # read-only observability props (reference latency/throughput props)
    def get_property(self, key: str):
        key_n = key.replace("-", "_")
        if key_n == "latency":
            return self.stats.recent_device_latency_s * 1e3
        if key_n == "throughput":
            return self.stats.throughput_fps
        if key_n in ("inputranks", "outputranks"):
            # reference read-only rank lists (tensor_filter_common.c:928,949)
            info = self._in_info if key_n == "inputranks" else self._out_info
            if info is None or not info.specs:
                return ""
            return ",".join(str(len(s.shape)) for s in info.specs)
        return super().get_property(key)

    # -- lifecycle ----------------------------------------------------------
    def _resolve_model(self) -> tuple:
        """(path, framework_hint): expands registry:// URIs (reference
        mlagent:// resolution, gst/nnstreamer/ml_agent.c)."""
        from ..registry.models import resolve

        return resolve(self.props["model"])

    def _detect_framework(self, model: str, hint: Optional[str]) -> str:
        # aliases ([filter-aliases] in the ini, reference nnstreamer.ini.in)
        # apply to explicit framework names AND to auto-detect candidates
        fw = self.props["framework"]
        if fw != "auto":
            return get_config().filter_alias(fw)
        if hint:
            return get_config().filter_alias(hint)
        if model.startswith("builtin://"):
            return "torch"
        candidates = [get_config().filter_alias(c)
                      for c in get_config().framework_priority(model)]
        available = set(subplugin_names(SubpluginKind.FILTER))
        for c in candidates:
            if c in available:
                return c
        raise ElementError(
            f"{self.describe()}: cannot auto-detect framework for model "
            f"'{model}' (candidates {candidates}, available {sorted(available)})"
        )

    def _config_file_begin(self) -> None:
        # a fresh top-level config-file apply replaces previously merged
        # custom options (re-setting the property must not duplicate them)
        self._config_custom = []

    def _config_file_other_line(self, ln: str) -> None:
        """Filter extension to the generic config-file: lines that are not
        properties (``factor:5`` custom-option style) merge into the
        ``custom`` string; property lines — including nested config-file=
        — are handled by Element with its cycle guard."""
        extra = getattr(self, "_config_custom", None)
        if extra is None:
            extra = self._config_custom = []
        extra.append(ln)

    def _custom_with_config_file(self) -> str:
        custom = self.props["custom"]
        extra = getattr(self, "_config_custom", [])
        if not extra:
            return custom
        joined = ",".join(extra)
        return f"{custom},{joined}" if custom else joined

    def _open_backend(self) -> None:
        if self.backend is not None:
            return
        # resolve ONCE: path and framework hint must describe the same
        # registry version even if the registry file changes concurrently
        model, hint = self._resolve_model()
        fprops = FilterProperties(
            model=model,
            custom=self._custom_with_config_file(),
            accelerator=Accelerator(self.props["accelerator"]),
            placement_device=self._placement_device_index,
        )
        self.backend = acquire_backend(
            self._detect_framework(model, hint), fprops,
            self.props["shared_tensor_filter_key"]
        )
        if obs_memory.ACTIVE:
            self._record_memory_static()

    def _record_memory_static(self) -> None:
        """Byte estimate for this filter as a singleton stage: the
        model's param footprint now, the measured channels of the first
        invoke (``_mem_pending``). Names match the profiler series so
        profile artifacts line up."""
        nb = obs_memory.backend_param_nbytes(self.backend)
        obs_memory.record_stage(obs_profile.series_name(self), "filter",
                                param_bytes=nb)
        if self.props["model"]:
            obs_memory.record_model_params(self.props["model"], nb)
        arm = getattr(self.backend, "measure_next_invoke", None)
        if arm is not None:
            arm()
        self._mem_pending = True

    def _record_memory_compiled(self, inputs) -> None:
        analyze = getattr(self.backend, "memory_analysis", None)
        compiled = analyze(inputs) if analyze is not None else None
        if compiled is not None:
            obs_memory.record_compiled(
                obs_profile.series_name(self), "filter", compiled,
                param_bytes=obs_memory.backend_param_nbytes(self.backend))

    def _ensure_backend(self) -> FilterBackend:
        """Reopen a suspended framework transparently (reference suspend/
        resume: the fw is unloaded when idle, reloaded on the next buffer)."""
        if self.backend is None:
            self._open_backend()
            if self._model_view_info is not None:
                self.backend.set_input_info(self._model_view_info)
        return self.backend

    def _release_backend(self) -> None:
        if self.backend is not None:
            release_backend(self.backend, self.props["shared_tensor_filter_key"])
            self.backend = None

    # -- retiring weights safely (suspend, hot swap) -------------------------
    def _fence_old(self, device) -> tuple:
        """Drop the fused segment's graphs and return (event, kind): the
        event behind the last device work that may read the current
        weights — the segment's fence, else (unfused, or nothing
        replayed) an event recorded now on ``device``'s current stream,
        behind every invoke already enqueued there; None on the CPU."""
        fence = self._invalidate_fused()
        if fence is not None:
            return fence, "segment fence"
        if device is not None and device.type == "cuda":
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(device))
            return fence, "stream fence"
        return None, "no fence"

    def _release_after(self, fenced: tuple,
                       release: Callable[[], None]) -> None:
        """Wait on the fence of ``_fence_old`` (that one event, never the
        whole card), then ``release``; both steps land in ``swap_log``."""
        fence, kind = fenced
        if fence is not None:
            fence.synchronize()
        self.swap_log.append((kind, clock_now()))
        release()
        self.swap_log.append(("released", clock_now()))

    def _suspend_watch(self) -> None:
        idle_s = self.props["suspend"] / 1e3
        while not self._suspend_stop.wait(max(idle_s / 2, 0.05)):
            with self._backend_lock:
                if (self.backend is not None
                        and clock_now() - self._last_invoke_ts > idle_s):
                    logger.info("%s: suspending idle framework", self.name)
                    self._release_after(self._fence_old(self.backend_device),
                                        self._release_backend)

    def _start_suspend_watch(self) -> None:
        if self.props["suspend"] <= 0 or self._suspend_thread is not None:
            return
        # baseline the idle clock: 0.0 would read as hours idle and
        # unload the just-opened backend on the first tick
        with self._backend_lock:
            self._last_invoke_ts = clock_now()
        self._suspend_stop.clear()
        self._suspend_thread = threading.Thread(
            target=self._suspend_watch, name=f"{self.name}:suspend",
            daemon=True)
        self._suspend_thread.start()

    def set_property(self, key: str, value) -> None:
        super().set_property(key, value)
        if (key.replace("-", "_") == "suspend"
                and getattr(self, "_in_info", None) is not None):
            # set on a running filter: it leaves its fused segment (suspend
            # is a barrier; the rebuild defuses) and the watchdog starts
            self._invalidate_fused()
            self._start_suspend_watch()

    def stop(self) -> None:
        self._suspend_stop.set()
        if self._suspend_thread is not None:
            self._suspend_thread.join(timeout=2.0)
            self._suspend_thread = None
        with self._backend_lock:
            self._release_backend()

    # -- negotiation (§3.1) -------------------------------------------------
    @staticmethod
    def _forced_info(dims: str, types: str) -> Optional[TensorsInfo]:
        """Build a TensorsInfo from 'd:d:d,d:d' dims + 'type1,type2' props
        (reference input/inputtype/output/outputtype declarations)."""
        if not dims:
            return None
        from ..core.tensors import TensorSpec

        dim_parts = dims.split(",")
        type_parts = types.split(",") if types else ["float32"] * len(dim_parts)
        if len(type_parts) != len(dim_parts):
            raise ElementError(
                f"declared {len(dim_parts)} dims but {len(type_parts)} types "
                f"({dims!r} vs {types!r})")
        specs = [
            TensorSpec.from_dim_string(d, t)
            for d, t in zip(dim_parts, type_parts)
        ]
        return TensorsInfo.of(*specs)

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        in_info = tensors_info_from_caps(caps)
        with self._backend_lock:  # the suspend watchdog must not unload here
            self._open_backend()
            model_in, model_out = self.backend.get_model_info()
            # explicit declarations beat backend self-description (reference:
            # input/inputtype/output/outputtype props for opaque models)
            forced_in = self._forced_info(self.props["input_dims"],
                                          self.props["input_types"])
            forced_out = self._forced_info(self.props["output_dims"],
                                           self.props["output_types"])
            if forced_in is not None:
                model_in = forced_in
            if forced_out is not None:
                model_out = forced_out
            if in_info.format is TensorFormat.STATIC and in_info.specs:
                sel = self.props["input_combination"]
                model_view = self._select(in_info.specs, sel) if sel else in_info.specs
                model_view_info = TensorsInfo.of(*model_view)
                if model_in is not None and not model_in.is_equal(model_view_info):
                    raise ElementError(
                        f"{self.describe()}: stream {model_view_info.describe()} != "
                        f"model input {model_in.describe()}"
                    )
                self._model_view_info = model_view_info
                if model_out is None:
                    model_out = self.backend.set_input_info(model_view_info)
        self._in_info = in_info
        self._out_info = self._compute_out_info(in_info, model_out)
        self._start_suspend_watch()

    def _compute_out_info(self, in_info: TensorsInfo,
                          model_out: Optional[TensorsInfo]) -> Optional[TensorsInfo]:
        out_comb = self.props["output_combination"]
        if self.props["invoke_dynamic"]:
            # output shape decided per invoke → flexible src caps
            # (reference invoke-dynamic, tensor_filter.c:692,900-914)
            return None
        if model_out is None:
            return None  # flexible downstream
        if out_comb is None:
            return model_out
        specs = []
        for src, idx in out_comb:
            specs.append(in_info.specs[idx] if src == "i" else model_out.specs[idx])
        return TensorsInfo.of(*specs)

    def transform_caps(self, src_pad: Pad) -> Caps:
        if self._out_info is not None:
            return caps_from_tensors_info(self._out_info)
        return caps_from_tensors_info(TensorsInfo((), TensorFormat.FLEXIBLE))

    # -- segment fusion (runtime/fusion.py) ---------------------------------
    def fusion_barrier(self) -> Optional[str]:
        base = super().fusion_barrier()
        if base is not None:
            return base
        # per-instance disqualifiers: behaviors that cannot live inside a
        # composed dispatch without changing semantics
        if self.props["invoke_dynamic"]:
            return "invoke-dynamic (output shapes decided per invoke)"
        if self.props["suspend"] > 0:
            return "suspend (idle framework unload would outlive the trace)"
        if self.props["sync_invoke"]:
            return "sync-invoke (per-invoke blocking is the requested behavior)"
        if self.props["latency"] or self.props["latency_report"]:
            return "latency profiling (needs per-invoke timing)"
        return None

    def fusion_stage(self):
        """Pure per-buffer invoke for segment fusion: input-combination →
        model → output-combination, all inside the segment's one
        dispatch. None when the opened backend hands out no stage (a
        pinned card) — the segment then defuses."""
        if self.fusion_barrier() is not None or self._in_info is None:
            return None
        backend = self.backend
        if backend is None:
            return None
        fn = backend.fusion_callable()
        if fn is None:
            return None
        sel = self.props["input_combination"]
        out_comb = self.props["output_combination"]

        def stage(xs):
            inputs = [xs[i] for i in sel] if sel else list(xs)
            outs = fn(*inputs)
            if out_comb is not None:
                outs = tuple(xs[idx] if src == "i" else outs[idx]
                             for src, idx in out_comb)
            return outs
        return stage

    def fusion_device(self):
        """The backend's card: a segment holding this filter runs there."""
        return getattr(self.backend, "device", None)

    def fusion_gate(self, buf: Buffer) -> bool:
        """QoS throttle on the fused path: the SAME acceptance-window gate
        as the unfused hot loop step 0, run host-side before the dispatch."""
        return self._throttle_accept()

    def _invalidate_fused(self) -> Optional[torch.cuda.Event]:
        """A model swap (``commit_model``/``reload_model``) or a suspend
        changed what this element computes: drop the segment's captured
        graphs so the next buffer re-captures against the new backend.
        Returns the segment's fence (the event behind the last replay of
        the dropped graphs; None when unfused or nothing was replayed on
        a card). The AOT eviction comes with ROADMAP A7."""
        seg = self._fusion_member
        if seg is not None:
            return seg.invalidate(evict_aot=True)
        return None

    # -- QoS (reference tensor_filter.c:512) --------------------------------
    def handle_src_event(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.QOS and self.props["throttle"]:
            self._throttle_delay_s = float(event.data.get("throttle_delay_s", 0.0))
            return  # consumed, like the reference
        super().handle_src_event(pad, event)

    @staticmethod
    def _select(items, indices):
        return [items[i] for i in indices]

    # -- hot loop (§3.2) ----------------------------------------------------
    def _throttle_accept(self) -> bool:
        """QoS acceptance gate: drop frames arriving faster than the QoS
        delay. The window starts at frame ACCEPTANCE (reference
        gst_tensor_filter_check_throttling_delay), not invoke completion."""
        if self._throttle_delay_s > 0:
            now = clock_now()
            if now - self._last_accept_ts < self._throttle_delay_s:
                return False
            self._last_accept_ts = now
        return True

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if self._in_info is None:
            raise ElementError(f"{self.describe()}: buffer before caps/open")
        # 0. throttling
        if not self._throttle_accept():
            return None  # frame dropped (reference: GST_BASE_TRANSFORM drop)
        # 1. input combination
        sel = self.props["input_combination"]
        model_inputs = self._select(buf.tensors, sel) if sel else buf.tensors
        # 2-3. invoke (timed). Dispatch time is recorded every frame; true
        # device latency (the reference's synchronous invoke number,
        # tensor_filter.c:366-510) is sampled every Nth frame by blocking,
        # so latency_report stays honest without serializing the stream.
        sampling = self.props["latency_sampling"]
        if self.props["latency"]:  # reference latency=1: profile every invoke
            sampling = 1
        # skip the very first invoke (includes kernel builds and warm-up)
        # so one giant outlier doesn't own the 10-sample window
        sample_device = self.props["sync_invoke"] or (
            sampling > 0
            and self.stats.total_invokes > 0
            and self.stats.total_invokes % sampling == 0
        )
        with self._backend_lock:  # suspend watchdog must not unload mid-invoke
            backend = self._ensure_backend()
            # clock starts AFTER a possible suspend-resume reload — a model
            # reopen must not read as inference latency
            t0 = clock_now()
            try:
                outputs = backend.invoke(model_inputs)
            except Exception as e:
                # an OOM-shaped failure (torch.cuda.OutOfMemoryError)
                # lands in the flight ring with THIS stage's name before
                # the error path loses context (the canonical series
                # name, so the event joins the stage's estimate)
                if obs_memory.looks_like_oom(e):
                    pipe = getattr(self, "pipeline", None)
                    obs_memory.record_alloc_failure(
                        obs_profile.series_name(self), e,
                        pipeline=pipe.name if pipe is not None else None)
                raise
            t1 = self._last_invoke_ts = clock_now()
            record_mem = obs_memory.ACTIVE and self._mem_pending
            if record_mem:
                self._mem_pending = False
        if record_mem:
            self._record_memory_compiled(model_inputs)
        # dispatch channel gets ONLY the host-side call time, even on
        # sampled frames — waiting time goes to the device channel
        self.stats.record(t1 - t0)
        if sample_device:
            for dev in {o.device for o in outputs
                        if isinstance(o, torch.Tensor) and o.is_cuda}:
                torch.cuda.current_stream(dev).synchronize()
            self.stats.record_device(clock_now() - t0)
        # 5. output combination: i<N> passthrough of inputs, o<N>/int = outputs
        out_comb = self.props["output_combination"]
        if out_comb is not None:
            outputs = [
                buf.tensors[idx] if src == "i" else outputs[idx]
                for src, idx in out_comb
            ]
        out = Buffer(list(outputs)).copy_metadata_from(buf)
        if self.props["latency_report"]:
            self.post_message(MessageType.ELEMENT, **self.stats.snapshot())
            self._track_latency()
        return out

    # -- pipeline LATENCY query (reference tensor_filter.c:366-510,1386) ----
    def _estimated_latency_s(self) -> float:
        """Current invoke latency estimate: sampled device-complete time
        when available, host dispatch time otherwise."""
        est = self.stats.recent_device_latency_s
        return est if est > 0 else self.stats.recent_latency_s

    def _track_latency(self) -> None:
        """Post a LATENCY bus message when the estimate outgrows the last
        reported value or sinks >25% below it, prompting the app to re-run
        Pipeline.query_latency() (reference track_latency). One message per
        announcement: re-posts only once the estimate escapes what was
        already announced, so an app that never queries isn't flooded."""
        estimated = self._estimated_latency_s()
        if estimated <= 0:
            return
        reported = self._latency_reported
        deviation = abs(estimated - reported) / reported if reported > 0 else 0.0
        if not (estimated > reported or deviation > self.LATENCY_REPORT_THRESHOLD):
            return
        posted = self._latency_posted
        if posted > 0 and (
                abs(estimated - posted) / posted <= self.LATENCY_REPORT_THRESHOLD
                and estimated <= posted * (1 + self.LATENCY_REPORT_HEADROOM)):
            return  # this estimate was already announced; await the query
        self._latency_posted = estimated
        self.post_message(MessageType.LATENCY,
                          estimated_s=estimated, reported_s=reported)

    def report_latency(self):
        if not self.props["latency_report"]:
            return None
        estimated = self._estimated_latency_s()
        if estimated <= 0:
            return None
        latency = estimated * (1 + self.LATENCY_REPORT_HEADROOM)
        self._latency_reported = latency
        self._latency_posted = 0.0  # the app reacted; re-arm announcements
        return latency

    # -- runtime model control ----------------------------------------------
    @property
    def backend_device(self):
        """The device the opened backend runs on."""
        return getattr(self.backend, "device", None)

    # -- staged hot swap (service control plane) ----------------------------
    # reload_model() below swaps in place: the old model is gone before the
    # new one proved it can serve. A zero-downtime rollout needs prepare →
    # warmup → flip → retire instead, with the OLD backend serving traffic
    # until the flip.

    def prepare_model(self, new_model: str) -> FilterBackend:
        """Open a backend for ``new_model`` WITHOUT touching the live one
        (same resolution path as _open_backend: registry:// URIs, framework
        detect, aliases). Caller warms it up, then either commit_model()s
        it in or releases it (rollback)."""
        if not self.props["is_updatable"]:
            raise ElementError(
                f"{self.describe()}: model swap refused (is-updatable=false)")
        from ..registry.models import resolve

        model_path, hint = resolve(new_model)
        fw = self._detect_framework(model_path, hint)
        fprops = FilterProperties(
            model=model_path,
            custom=self._custom_with_config_file(),
            accelerator=Accelerator(self.props["accelerator"]),
            placement_device=self._placement_device_index,
        )
        backend = acquire_backend(fw, fprops, "")  # never shared: private
        # until commit, so a failed warmup can't poison a share-key entry
        if self._model_view_info is not None:
            backend.set_input_info(self._model_view_info)
        # registry-slot footprint (obs/memory.py): what THIS version's
        # params weigh, recorded at prepare time
        obs_memory.record_model_params(
            new_model, obs_memory.backend_param_nbytes(backend))
        return backend

    def commit_model(self, backend: FilterBackend,
                     new_model: str) -> Optional[FilterBackend]:
        """Atomically flip the live backend to a prepared one; returns the
        RETIRED backend (caller releases it after in-flight work drains —
        release_prepared() does that)."""
        with self._backend_lock:
            old = self.backend
            self.backend = backend
            self.props["model"] = new_model
        # AFTER the flip (outside the invoke lock): an in-flight fused
        # dispatch finishes on the old graph — same semantics as an
        # in-flight unfused invoke — and the next buffer re-captures
        fenced = self._fence_old(getattr(old, "device", None))
        if old is not None:
            self._retire_fences[id(old)] = fenced
        return old

    def release_prepared(self, backend: Optional[FilterBackend]) -> None:
        """Release a backend from prepare_model (rollback) or commit_model
        (retire-old): a retired one only after its fence."""
        if backend is None:
            return
        fenced = self._retire_fences.pop(id(backend), (None, "no fence"))
        # a retired backend may be the one _open_backend acquired under
        # the element's share key; release under that key so refcounts
        # balance (prepare_model never uses a share key), and a second
        # filter on that key keeps it alive until its own release
        self._release_after(fenced, lambda: release_backend(
            backend, self.props["shared_tensor_filter_key"]))

    def reload_model(self, new_model: Optional[str] = None) -> None:
        """Hot model swap without pipeline restart (reference ``is-updatable``
        + RELOAD_MODEL event, nnstreamer_plugin_api_filter.h:378-384). The
        backend loads the new model beside the old one; the old weights
        go once the last device work that read them has finished."""
        if not self.props["is_updatable"]:
            raise ElementError(
                f"{self.describe()}: model reload refused (is-updatable=false)")
        with self._backend_lock:  # vs suspend watchdog unloading concurrently
            if new_model:
                self.props["model"] = new_model
                if self.backend is not None and self.backend.props is not None:
                    # registry:// URIs resolve to the concrete path, same as open
                    self.backend.props.model, _ = self._resolve_model()
            backend = self.backend
            if backend is not None:
                backend.handle_event(BackendEvent.RELOAD_MODEL)
        fenced = self._fence_old(getattr(backend, "device", None))
        if backend is not None:
            self._release_after(fenced, backend.release_retired)
