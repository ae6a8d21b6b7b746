"""Diagnostic model and rule catalog shared by both lint passes.

Every finding is a :class:`Diagnostic` carrying a stable rule ID
(``NNL0xx`` graph, ``NNL1xx`` source, ``NNL2xx`` concurrency, ``NNL3xx``
lifecycle, ``NNL4xx`` device-transfer, ``NNL5xx`` wire-protocol rules),
a severity, a
human-readable message, and a location (element/pad name for graph
findings, ``file:line:col`` span for source findings). The catalog in
:data:`RULES` is the single source of truth — docs/lint.md and the CLI's
``--rules`` listing are generated from it.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional


class Severity(enum.Enum):
    ERROR = "error"      # the pipeline cannot work / the code is wrong
    WARNING = "warning"  # works, but a perf or robustness hazard
    INFO = "info"        # informational report (never gates, even --strict)

    def __str__(self) -> str:
        return self.value


@dataclass(frozen=True)
class Rule:
    """Catalog entry for one lint rule."""

    id: str
    severity: Severity
    title: str
    rationale: str


# ---------------------------------------------------------------------------
# Rule catalog. IDs are STABLE — tests, pragmas, and CI gates reference
# them; never renumber, only append.
# ---------------------------------------------------------------------------
_RULES = (
    # -- graph lint (pass 1) ------------------------------------------------
    Rule("NNL001", Severity.ERROR, "unknown element",
         "the launch string names an element factory the registry does not "
         "know; the message carries a did-you-mean suggestion"),
    Rule("NNL002", Severity.ERROR, "unknown property",
         "a property key is not declared by the element class (checked "
         "against the MRO-merged PROPERTIES table and PROP_ALIASES)"),
    Rule("NNL003", Severity.ERROR, "caps mismatch",
         "abstract caps propagation found a pad link whose upstream "
         "shape/dtype/media estimate cannot intersect the downstream "
         "constraint — runtime negotiation would fail after devices are "
         "grabbed and jit has compiled"),
    Rule("NNL004", Severity.WARNING, "dangling pad",
         "an always-present pad is unlinked: a sink pad that will never "
         "receive data, or a src pad whose buffers are silently dropped"),
    Rule("NNL005", Severity.ERROR, "graph cycle",
         "the element graph contains a directed cycle; data flow would "
         "recurse forever (feedback loops belong in tensor_repo pairs)"),
    Rule("NNL006", Severity.WARNING, "unreachable element",
         "no path from any source element reaches this element — it will "
         "never see a buffer"),
    Rule("NNL007", Severity.WARNING, "fan arity",
         "a tee with fewer than two branches or an N-input combiner "
         "(mux/merge) with fewer than two linked inputs is a no-op or a "
         "stalled graph"),
    Rule("NNL008", Severity.WARNING, "recompile storm",
         "a flexible-shaped (dynamic) stream feeds a jitted tensor_filter "
         "without invoke-dynamic: every new shape forces an XLA recompile "
         "in the hot loop"),
    Rule("NNL009", Severity.WARNING, "bucket coverage",
         "a tensor_serving element's bucket set cannot cover the declared "
         "input rows — every buffer overflows the largest bucket and pads "
         "to a multiple of it"),
    Rule("NNL010", Severity.WARNING, "host round-trip",
         "a host-only element sits between device elements: buffers leave "
         "the accelerator, are processed on host, and are shipped back — "
         "a device→host→device sync in the steady-state path"),
    Rule("NNL011", Severity.WARNING, "incomplete pipeline",
         "the pipeline has no source or no sink element; it can play but "
         "will never produce or consume data"),
    Rule("NNL012", Severity.ERROR, "parse/construction failure",
         "the launch string does not parse, or an element constructor "
         "rejected its configuration"),
    Rule("NNL013", Severity.INFO, "fusion segmentation plan",
         "informational: the device-segment fusion compiler's plan for "
         "this pipeline — which linear runs of device elements collapse "
         "to ONE XLA dispatch per buffer (runtime/fusion.py); info "
         "findings never gate, not even under --strict"),
    Rule("NNL014", Severity.INFO, "placement plan available",
         "informational: a multi-stage device pipeline runs with default "
         "placement while the profile store (NNS_PROFILE_STORE) holds a "
         "matching ProfileArtifact — a better plan is available via "
         "Pipeline(place=\"auto\") (runtime/placement.py); info findings "
         "never gate, not even under --strict"),
    Rule("NNL015", Severity.INFO, "AOT artifact coverage",
         "informational: the AOT compile cache (NNS_AOT_CACHE) holds "
         "exported stage programs matching this topology — restarts, "
         "hot-swap prepares, and replica spawns load instead of "
         "tracing, and a shape-polymorphic artifact covers every "
         "serving bucket with ONE export (nnstreamer_tpu_torch/aot); "
         "info findings never gate, not even under --strict"),
    # -- source lint (pass 2) -----------------------------------------------
    Rule("NNL100", Severity.ERROR, "unlintable source file",
         "a file handed to the source lint cannot be read or parsed "
         "(syntax error, missing file) — nothing in it was checked"),
    Rule("NNL101", Severity.WARNING, "host sync in hot path",
         "an explicit device→host synchronization (block_until_ready, "
         "jax.device_get, np.asarray in scheduler loops) inside an "
         "element/scheduler hot function stalls the dispatch pipeline"),
    Rule("NNL102", Severity.WARNING, "scalar pull in hot path",
         "float()/int()/bool() on a non-constant value inside a "
         "device-affinity element's hot function forces a blocking "
         "device→host transfer of one scalar per call"),
    Rule("NNL103", Severity.ERROR, "bare except",
         "a bare `except:` catches SystemExit/KeyboardInterrupt and hides "
         "the error type; catch a concrete exception class"),
    Rule("NNL104", Severity.WARNING, "silent exception swallow",
         "a broad `except Exception` whose handler is only pass/continue "
         "inside a hot function drops errors on the floor — the stream "
         "corrupts silently instead of posting a pipeline ERROR"),
    Rule("NNL105", Severity.WARNING, "blocking call in batch formation",
         "blocking I/O, time.sleep, or lock acquisition inside a serving "
         "batch-formation section adds tail latency to every request in "
         "the forming batch"),
    Rule("NNL106", Severity.WARNING, "python branch on tracer",
         "a function handed to jax.jit branches (if/while) on a parameter "
         "value: under trace the parameter is a tracer and the branch "
         "either fails or silently bakes in one path"),
    # -- concurrency lint (pass 3) -------------------------------------------
    Rule("NNL201", Severity.ERROR, "lock-order inversion",
         "two locks are acquired in opposite nesting orders on different "
         "code paths — two threads interleaving those paths deadlock; "
         "every path must acquire locks in one global order"),
    Rule("NNL202", Severity.WARNING, "unguarded shared state",
         "an attribute declared '# guarded-by: <lock>' (or written under a "
         "lock elsewhere in the class) is also written with no lock held — "
         "a concurrent reader can observe torn/stale state"),
    Rule("NNL203", Severity.WARNING, "blocking call while holding a lock",
         "a lock is held across a blocking operation (sleep, subprocess, "
         "socket I/O, indefinite get()/wait()/join(), block_until_ready) — "
         "every thread contending the lock stalls for the full call"),
    Rule("NNL204", Severity.WARNING, "Condition.wait without predicate loop",
         "a Condition.wait outside a while-loop re-check: spurious wakeups "
         "and stolen notifications make the waiter proceed on a false "
         "predicate — wrap the wait in 'while not predicate:'"),
    Rule("NNL205", Severity.WARNING, "thread without join/stop path",
         "a thread is started with no reachable join in its owning class "
         "(or fire-and-forget): shutdown leaks it, and a daemon thread "
         "dying mid-operation can corrupt shared state"),
    # -- lifecycle lint (pass 4) ----------------------------------------------
    Rule("NNL301", Severity.ERROR, "acquire without release",
         "a paired resource (calibration refcount, admission reservation, "
         "live span, registered handle) is acquired but NO matching "
         "release call is reachable — not in the function, not anywhere "
         "in the owning class/module; every long-running process leaks "
         "one unit per call"),
    Rule("NNL302", Severity.WARNING, "exception path escapes holding a resource",
         "a resource is released on the normal path only: an exception "
         "raised between acquire and release escapes without the release "
         "(no finally, no context manager, no release-and-reraise "
         "handler) — one failed request leaks the unit forever"),
    Rule("NNL303", Severity.WARNING, "refcount imbalance",
         "a refcounted pair (begin_calibration/end_calibration, "
         "recording enable/disable) is acquired and released an unequal "
         "number of times across branches, loops, or early returns of "
         "the same function — the count drifts and the OTHER users of "
         "the shared refcount are silenced or pinned on"),
    Rule("NNL304", Severity.WARNING, "subprocess without reap path",
         "a subprocess.Popen handle is stored with no poll/wait/kill/"
         "terminate/communicate call reachable in the owning scope — the "
         "child is never reaped (zombie) and never stopped on shutdown"),
    Rule("NNL305", Severity.WARNING, "atomic write without failure cleanup",
         "a temp-file + os.replace/os.rename atomic-publish sequence has "
         "no failure-path cleanup: an exception between the temp write "
         "and the rename strands the .tmp file on disk forever (and a "
         "retry loop strands one per attempt)"),
    Rule("NNL306", Severity.WARNING, "registration without unregister on stop",
         "an object registers itself into a module-level registry "
         "(metrics weakset, ThreadRegistry, track_* scrape surfaces) "
         "with no matching unregister/drain on its stop path — stale "
         "entries keep publishing until GC, which for a weakref may be "
         "never while the scrape itself holds iteration references"),
    # -- transfer lint (pass 5) -----------------------------------------------
    Rule("NNL401", Severity.WARNING, "implicit device→host materialization in hot scope",
         "a device-provenance value (backend invoke result, fusion_stage "
         "output, jnp constructor) is materialized on host inside an "
         "element/scheduler hot function — np.asarray/np.array, "
         "float/int/bool, .tolist()/.item(), or Python iteration — "
         "forcing one blocking device→host transfer per buffer; NNL1xx's "
         "sync rules generalized from call names to value flow"),
    Rule("NNL402", Severity.WARNING, "per-frame device allocation churn",
         "a fresh jnp device array is constructed (zeros/ones/full/"
         "arange/…) inside a per-buffer dispatch path — one device "
         "allocation + H2D fill per frame that a hoisted constant or a "
         "donated buffer would kill; allocation inside a nested "
         "to-be-jitted closure is exempt (it compiles into the graph)"),
    Rule("NNL403", Severity.WARNING, "host round-trip sandwich",
         "one value goes device→host→device inside a single function "
         "(materialized from a device value, then fed back to a jnp "
         "constructor / device_put / invoke) — the intra-function twin "
         "of graph-level NNL010; keep the intermediate on device"),
    Rule("NNL404", Severity.WARNING, "donation opportunity / violation",
         "a single-owner device value is passed to a jitted callable "
         "compiled without donate_argnums (the buffer could be donated "
         "and the output written in place), or a donated argument is "
         "read after the call (its buffer was invalidated by XLA — "
         "use-after-donate returns garbage or raises)"),
    Rule("NNL405", Severity.WARNING, "byte-copy of a wire/shm buffer",
         "bytes(buffer) / .tobytes() on a whole frame in a transport/"
         "query hot path copies the payload the zero-copy wire contract "
         "says must be handed off by reference (memoryview, sendmsg "
         "gather-write, buffer-protocol file write)"),
    # -- protocol lint (pass 6) -------------------------------------------------
    Rule("NNL501", Severity.ERROR, "struct-layout drift",
         "a wire struct layout disagrees with its own module: a packed "
         "format with no matching unpack (or vice versa), an unpack "
         "destructured into the wrong number of fields, or a declared "
         "header-size constant that no longer equals calcsize(format) — "
         "width, field-count, and offset drift ship silently and corrupt "
         "every frame on the wire"),
    Rule("NNL502", Severity.ERROR, "unvalidated wire-derived size",
         "a length/count/rank field read off the wire flows into an "
         "allocation, range loop, multiplication, frombuffer, or sized "
         "recv without a bounds check against a declared limit — a "
         "hostile peer's 4-byte field drives an OOM-scale allocation or "
         "a billions-iteration loop (the memory-bomb shape)"),
    Rule("NNL503", Severity.WARNING, "unbounded recv path",
         "a socket read outside the typed TornFrameError/FrameError "
         "contract: a partial-read loop that never checks for EOF (hangs "
         "forever on a half-closed peer), a handshake read on a "
         "just-accepted connection with no deadline (a silent peer parks "
         "the worker thread), or wire bytes parsed with unpack_from "
         "where struct.error escapes untyped and kills the reader — a "
         "skewed peer must produce a typed error, never a hang"),
    Rule("NNL504", Severity.WARNING, "encode/decode asymmetry or fallback gap",
         "a field key written by an encoder with no reader in the paired "
         "decoder (or read but never written), or negotiation caps "
         "consumed by hard indexing instead of .get with a fallback — an "
         "old peer that echoes the offer verbatim (or omits the key) "
         "must fall back to the legacy path, not raise KeyError"),
    Rule("NNL505", Severity.WARNING, "platform-dependent serialization",
         "a wire struct format without an explicit byte order ('@' or "
         "'=' or bare codes use NATIVE order and alignment — the frame "
         "layout changes across architectures), or meta emitted by "
         "iterating an unsorted dict (hash/insertion order is not a wire "
         "contract; canonical encoders iterate sorted(items()))"),
)

RULES: Dict[str, Rule] = {r.id: r for r in _RULES}


@dataclass(frozen=True)
class Diagnostic:
    """One lint finding."""

    rule: str
    severity: Severity
    message: str
    location: str = ""            # element/pad name or file path
    line: Optional[int] = None    # 1-based source line (source lint)
    col: Optional[int] = None     # 0-based column (source lint)
    hint: str = ""                # optional fix suggestion
    fix_hint: str = ""            # machine-usable fix: the exact missing
    #                               call/edit (lifecycle rules name the
    #                               release call); falls back to `hint`
    #                               in to_dict() when a pass sets none

    @property
    def is_error(self) -> bool:
        return self.severity is Severity.ERROR

    def span(self) -> str:
        if self.line is None:
            return self.location
        col = f":{self.col}" if self.col is not None else ""
        return f"{self.location}:{self.line}{col}"

    def format(self) -> str:
        loc = self.span()
        hint = f" ({self.hint})" if self.hint else ""
        where = f" [{loc}]" if loc else ""
        return f"{self.rule} {self.severity}: {self.message}{hint}{where}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": str(self.severity),
            "message": self.message,
            "location": self.location,
            "line": self.line,
            "col": self.col,
            "hint": self.hint,
            "fix_hint": self.fix_hint or self.hint,
        }


def make(rule_id: str, message: str, *, location: str = "",
         line: Optional[int] = None, col: Optional[int] = None,
         hint: str = "", fix_hint: str = "") -> Diagnostic:
    """Build a Diagnostic with the catalog's severity for ``rule_id``."""
    return Diagnostic(rule_id, RULES[rule_id].severity, message,
                      location=location, line=line, col=col, hint=hint,
                      fix_hint=fix_hint)
