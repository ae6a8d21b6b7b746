"""tensor_serving: continuous-batching model execution in a pipeline (L3).

The port of nnstreamer_tpu's ``elements/serving.py``. It routes each
incoming buffer through a :class:`~nnstreamer_tpu_torch.serving.Scheduler`,
so concurrent streams — other pipelines, other threads — coalesce into one
shape-bucketed device batch. Within one stream it behaves like
``tensor_filter`` (a buffer in, the model's output out, in order); the win
appears when several streams share a scheduler via ``shared-key``:

    # pipeline A and B in one process — one device batch serves both
    ... ! tensor_serving framework=torch
            model=nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8
            shared-key=mnet bucket-sizes=1,2,4,8 max-wait-ms=3 ! ...

Batches run through the port's torch backend (``framework=torch``, or
``auto``) and its :class:`~nnstreamer_tpu_torch.serving.BackendExecutor`,
on ``cuda:0`` unless ``accelerator=cpu``. Outputs stay where the model put
them (on the card), sliced per request.

Admission control applies per buffer: when the scheduler sheds (queue
depth, deadline budget), the element either drops the frame (``on-shed=
drop``, streaming QoS) or raises (``on-shed=error``). Per-request serving
metrics ride the output buffer meta under ``"serving"``.
"""
from __future__ import annotations

from typing import Optional

from ..analysis.sanitizer import named_lock
from ..backends.base import Accelerator, FilterProperties
from ..core import Buffer, Caps, tensors_info_from_caps
from ..core.caps import caps_from_tensors_info
from ..obs import context as obs_context
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger

_TENSOR_CAPS = Caps.new("other/tensors")


def _parse_buckets(spec: str) -> tuple:
    try:
        sizes = tuple(int(p) for p in str(spec).split(",") if p.strip())
    except ValueError:
        sizes = ()
    if not sizes or any(b < 1 for b in sizes):
        raise ElementError(
            f"bucket-sizes={spec!r}: expected comma-separated positive "
            "integers (e.g. 1,2,4,8)")
    return sizes


@register_element
class TensorServing(TransformElement):
    """Continuous-batching model execution: buffers route through a
    shared :class:`~nnstreamer_tpu.serving.Scheduler`, so concurrent
    streams (other pipelines via `shared-key`, tensor-query clients,
    direct submitters) coalesce into one shape-bucketed device batch;
    unmeetable buffers shed with a typed error instead of buffering
    unboundedly. Per-request serving metrics ride the output buffer meta
    under ``"serving"``. See docs/serving.md."""

    ELEMENT_NAME = "tensor_serving"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    DEVICE_AFFINITY = "device"  # batches execute on the scheduler's card
    # fusion opt-out (runtime/fusion.py): cross-buffer batching state —
    # a buffer's result depends on co-batched traffic from OTHER
    # streams, which no pure per-buffer stage can express
    FUSABLE = False
    PROPERTIES = {
        "framework": Prop("torch", str,
                          "backend executing the batches: torch (or auto, "
                          "which is torch)"),
        "model": Prop(None, str,
                      "model source, same forms as tensor_filter "
                      "framework=torch (builtin://, module:attr)"),
        "custom": Prop("", str, "backend custom string (k:v,k2:v2)"),
        "accelerator": Prop("auto", str,
                            "auto | cpu | gpu (auto and gpu run on "
                            "cuda:0)"),
        "bucket_sizes": Prop("1,2,4,8", str,
                             "row-count buckets batches are padded to — "
                             "the only input shapes steady-state "
                             "traffic ever shows the model"),
        "max_wait_ms": Prop(3.0, float,
                            "flush budget: a partially-filled bucket "
                            "waits at most this long for co-batchable "
                            "traffic"),
        "max_depth": Prop(256, int,
                          "admission control: queue depth beyond which "
                          "submissions shed with QueueFullError"),
        "deadline_ms": Prop(0.0, float,
                            "per-buffer latency budget (0 = none); "
                            "unmeetable buffers shed with "
                            "DeadlineExceededError"),
        "priority": Prop(0, int,
                         "scheduling priority for this stream's buffers "
                         "(lower runs sooner)"),
        "predictive_shed": Prop(True, prop_bool,
                                "shed at admission when the estimated "
                                "queue wait already exceeds the deadline "
                                "budget"),
        "shared_key": Prop("", str,
                           "elements with the same key share ONE "
                           "scheduler — their streams coalesce into one "
                           "device batch (empty = private)"),
        "on_shed": Prop("drop", str,
                        "shed buffers: drop (warn + continue, streaming "
                        "QoS) | error (fail the stream)"),
        "timeout": Prop(60.0, float,
                        "seconds chain() waits for a result before "
                        "failing the stream"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["model"]:
            raise ElementError(f"{self.describe()}: 'model' property required")
        if self.props["framework"] not in ("torch", "pytorch", "auto"):
            raise ElementError(
                f"{self.describe()}: framework="
                f"{self.props['framework']} — tensor_serving batches "
                "through the torch backend only")
        try:
            Accelerator(self.props["accelerator"])
        except ValueError:
            raise ElementError(
                f"{self.describe()}: accelerator="
                f"{self.props['accelerator']!r} (expected auto, cpu or gpu)")
        if self.props["on_shed"] not in ("drop", "error"):
            raise ElementError(
                f"{self.describe()}: on-shed must be drop|error")
        _parse_buckets(self.props["bucket_sizes"])  # validate early
        # negotiation (a streaming thread) and a query-server attach (the
        # caller's) may both ask for the scheduler first: one creates it
        self._sched_lock = named_lock("TensorServing._sched_lock")
        self.scheduler = None                     # guarded-by: _sched_lock
        self._shared_key: Optional[str] = None    # guarded-by: _sched_lock
        self._backend = None
        self._shed_warned = False

    # -- scheduler lifecycle -------------------------------------------------
    def _signature(self) -> tuple:
        # buckets in BatchFormer's normalized form (sorted, deduped), so
        # "8,4,2,1" and "1,2,4,8" — the same batching behavior — don't
        # hard-fail the shared-key rebind check on string spelling
        return ("torch", self.props["model"], self.props["custom"],
                self.props["accelerator"],
                tuple(sorted(set(_parse_buckets(self.props["bucket_sizes"])))))

    def _make_scheduler(self):
        from ..backends.torch_backend import TorchBackend
        from ..serving import BackendExecutor, Scheduler

        backend = TorchBackend()
        backend.open(FilterProperties(
            model=self.props["model"], custom=self.props["custom"],
            accelerator=Accelerator(self.props["accelerator"])))
        self._backend = backend
        # the scheduler owns the backend's lifetime (on_close): with
        # shared-key the scheduler outlives the element that created it,
        # and closing the backend here on that element's stop() would
        # break every other element still batching through it
        kw = dict(name=self.name,
                  bucket_sizes=_parse_buckets(self.props["bucket_sizes"]),
                  max_wait_s=self.props["max_wait_ms"] * 1e-3,
                  max_depth=self.props["max_depth"],
                  predictive_shed=self.props["predictive_shed"],
                  on_close=backend.close)
        sched = Scheduler(executor=BackendExecutor(backend), **kw)
        # shared-key joiners never run this factory but still need the
        # backend for caps negotiation (transform_caps/set_input_info) —
        # ride it on the scheduler that already owns its lifetime
        sched.backend = backend
        return sched

    def _ensure_scheduler(self):
        with self._sched_lock:
            return self._ensure_scheduler_locked()

    def _ensure_scheduler_locked(self):
        if self.scheduler is not None:
            return self.scheduler
        key = self.props["shared_key"]
        if key:
            from ..serving import get_shared_scheduler

            self.scheduler = get_shared_scheduler(
                key, self._make_scheduler, self._signature())
            self._shared_key = key
            # when another element created the scheduler, adopt its
            # backend so this element negotiates the same static caps
            # (not the FLEXIBLE fallback) regardless of start order
            self._backend = getattr(self.scheduler, "backend",
                                    self._backend)
            self._warn_ignored_shared_knobs(self.scheduler)
        else:
            self.scheduler = self._make_scheduler()
        return self.scheduler

    def _warn_ignored_shared_knobs(self, sched) -> None:
        """A joining element inherits the shared scheduler's queue and
        batching knobs; model/bucket mismatches hard-fail (signature),
        but differing max-wait/max-depth/predictive-shed would be
        silently ignored — say so."""
        mine = {"max-wait-ms": self.props["max_wait_ms"],
                "max-depth": self.props["max_depth"],
                "predictive-shed": self.props["predictive_shed"]}
        theirs = {"max-wait-ms": sched.former.max_wait_s * 1e3,
                  "max-depth": sched.queue.max_depth,
                  "predictive-shed": sched.queue.predictive_shed}
        ignored = {k: (mine[k], theirs[k]) for k in mine
                   if mine[k] != theirs[k]}
        if ignored:
            logger.warning(
                "%s: shared-key='%s' scheduler already exists; these "
                "properties keep the creator's values (requested vs "
                "effective): %s", self.name, self._shared_key, ignored)

    def stop(self) -> None:
        with self._sched_lock:
            sched, self.scheduler = self.scheduler, None
            key, self._shared_key = self._shared_key, None
            # the backend is closed by the scheduler's on_close (possibly
            # later, when the last shared-key holder releases) — only drop
            # our negotiation reference here, under the lock that guards
            # its adoption in _ensure_scheduler_locked
            self._backend = None
        if sched is not None:
            if key:
                from ..serving import release_shared_scheduler

                release_shared_scheduler(key)
            else:
                sched.close()
        super().stop()

    # -- negotiation ---------------------------------------------------------
    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._ensure_scheduler()
        self._in_info = tensors_info_from_caps(caps)

    def transform_caps(self, src_pad: Pad) -> Caps:
        from ..core import TensorFormat, TensorsInfo

        info = getattr(self, "_in_info", None)
        out = None
        if info is not None and info.specs and self._backend is not None:
            # the model's shape rule: no device work
            out = self._backend.set_input_info(info)
        if out is None:
            return caps_from_tensors_info(
                TensorsInfo((), TensorFormat.FLEXIBLE))
        return caps_from_tensors_info(out)

    # -- dataflow ------------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> None:
        from ..serving import AdmissionError

        sched = self._ensure_scheduler()
        deadline_ms = self.props["deadline_ms"]
        trace_ctx = None
        if obs_context.TRACING:
            # a trace context that arrived on the buffer (query wire,
            # fabric attempt) follows the request into the batch
            trace_ctx = obs_context.TraceContext.from_meta(
                buf.meta.get("trace"))
        try:
            req = sched.submit(
                tuple(buf.tensors), priority=self.props["priority"],
                deadline_s=deadline_ms * 1e-3 if deadline_ms > 0 else None,
                trace=trace_ctx)
        except AdmissionError as e:
            if self.props["on_shed"] == "error":
                raise ElementError(f"{self.describe()}: {e}") from e
            if not self._shed_warned:
                self._shed_warned = True
                logger.warning(
                    "%s: shedding under load (%s: %s) — further sheds "
                    "are silent", self.name, type(e).__name__, e)
            return
        outs = req.result(self.props["timeout"])
        out = Buffer(list(outs)).copy_metadata_from(buf)
        out.meta["serving"] = dict(req.metrics)
        self.push(out)
