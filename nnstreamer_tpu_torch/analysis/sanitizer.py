"""tsan-lite, leakcheck and the transfer byte ledger: opt-in runtime
sanitizers for the control plane.

The port of nnstreamer_tpu's ``analysis/sanitizer.py``, pure Python. The
package's threaded layers create their locks through the named factories
here:

    from ..analysis.sanitizer import named_lock
    self._lock = named_lock("RequestQueue._lock")

**Disabled (the default), the factories return raw ``threading``
primitives** — no wrapper object, no extra frame; the only cost is one
function call at construction. Enabled (:func:`enable`, or ``NNS_TSAN=1``
in the environment when this module is first imported, with
``NNS_TSAN_HOLD_S`` as ``hold_warn_s``), they return instrumented wrappers
that

* record each thread's lock-acquisition nesting into a global
  lock-order graph (edge ``A → B`` = ``B`` acquired while ``A`` held);
* record a violation when the observed graph goes **cyclic** — two
  threads have taken the same locks in opposite orders, a deadlock
  waiting for the right interleaving;
* flag holds longer than ``hold_warn_s``;
* expose everything via :func:`report` / :func:`violations`.

Enable/disable affects locks created AFTERWARDS.

**Leak ledger.** Paired acquire/release protocols — the serving plane's
KV pages, memory-guard reservations, live spans — report into one ledger
via :func:`note_acquire` / :func:`note_release`; disabled, each call is a
single module-global check (``NNS_LEAKCHECK=1`` at first import turns
it on). :func:`outstanding` lists what was acquired
and not released; a test asserts it is empty after a full cycle. Release
without a matching acquire is ignored; ``idempotent=True`` acquisitions
count once per key.

**Transfer byte ledger.** Choke points that move bytes between the host
and the card report them with :func:`note_transfer`; :func:`nbytes_of`
sizes torch tensors and numpy arrays alike. nnstreamer_tpu also runs its
pure-jit regions under ``jax.transfer_guard`` (``no_implicit_d2h``);
PyTorch has no such guard, so the port keeps only the ledger.

**Wire frame-fuzz scorekeeper** (``NNS_WIREFUZZ=1`` at first import, or
:func:`enable_wirefuzz`): fuzzers record each mutant's fate on a wire
surface with :func:`note_mutant` (``typed``/``clean`` satisfy the
contract; ``hang``/``crash``/``silent`` are violations), and the frame
codec reports every clean encode and decode with :func:`note_frame_event`.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_state = threading.Lock()   # guards the module tables below
_enabled = False
_hold_warn_s = 1.0
_edges: Dict[Tuple[str, str], dict] = {}   # (a, b) -> {count, sites, threads}
_violations: List[dict] = []
_long_holds: List[dict] = []
_acquire_counts: Dict[str, int] = {}
_tls = threading.local()


# ---------------------------------------------------------------------------
# control surface
# ---------------------------------------------------------------------------

def enable(hold_warn_s: float = 1.0) -> None:
    """Instrument locks created from now on; also resets the tables."""
    global _enabled, _hold_warn_s
    reset()
    with _state:
        _enabled = True
        _hold_warn_s = float(hold_warn_s)


def disable() -> None:
    global _enabled
    with _state:
        _enabled = False


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear every recorded edge/violation/hold (between test phases)."""
    with _state:
        _edges.clear()
        _violations.clear()
        _long_holds.clear()
        _acquire_counts.clear()


def violations() -> List[dict]:
    with _state:
        return list(_violations)


def report() -> dict:
    """Everything observed so far (JSON-friendly)."""
    with _state:
        return {
            "enabled": _enabled,
            "hold_warn_s": _hold_warn_s,
            "locks": dict(_acquire_counts),
            "edges": [
                {"from": a, "to": b, **info}
                for (a, b), info in sorted(_edges.items())
            ],
            "violations": list(_violations),
            "long_holds": list(_long_holds),
        }


# ---------------------------------------------------------------------------
# factories — the ONLY public way the package creates named locks
# ---------------------------------------------------------------------------

def named_lock(name: str):
    """A ``threading.Lock`` (disabled) or an order-recording wrapper."""
    if not _enabled:
        return threading.Lock()
    return _TsanLock(name, threading.Lock())


def named_rlock(name: str):
    if not _enabled:
        return threading.RLock()
    return _TsanLock(name, threading.RLock(), reentrant=True)


def named_condition(name: str, lock=None):
    """A Condition over ``lock`` (a lock returned by :func:`named_lock`,
    or None for a private one). Waiting releases the lock — the wrapper
    keeps the held-stack bookkeeping consistent across the wait."""
    if not _enabled:
        if isinstance(lock, _TsanLock):  # created while enabled, mixed use
            return _TsanCondition(name, lock)
        return threading.Condition(lock)
    if lock is None:
        lock = _TsanLock(name + ".lock", threading.Lock())
    elif not isinstance(lock, _TsanLock):
        lock = _TsanLock(name + ".lock", lock)
    return _TsanCondition(name, lock)


# ---------------------------------------------------------------------------
# bookkeeping
# ---------------------------------------------------------------------------

def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _depths() -> dict:
    d = getattr(_tls, "depths", None)
    if d is None:
        d = _tls.depths = {}
    return d


def _site(skip: int = 2) -> str:
    """First caller frame OUTSIDE this module (the user-code acquire)."""
    try:
        f = sys._getframe(skip)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return "?"
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except (ValueError, AttributeError):
        return "?"


def _note_acquire(lock: "_TsanLock") -> None:
    depths = _depths()
    d = depths.get(id(lock), 0)
    depths[id(lock)] = d + 1
    if d:
        return  # reentrant re-acquire: no new node on the stack
    stack = _stack()
    site = _site(2)
    if stack:
        _record_edge(stack[-1][0].name, lock.name, site)
    with _state:
        _acquire_counts[lock.name] = _acquire_counts.get(lock.name, 0) + 1
    stack.append((lock, time.monotonic(), site))


def _note_release(lock: "_TsanLock") -> None:
    depths = _depths()
    d = depths.get(id(lock), 0)
    if d > 1:
        depths[id(lock)] = d - 1
        return
    depths.pop(id(lock), None)
    stack = _stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] is lock:
            _, t0, site = stack.pop(i)
            held = time.monotonic() - t0
            if held > _hold_warn_s:
                with _state:
                    _long_holds.append({
                        "lock": lock.name, "held_s": round(held, 3),
                        "acquired_at": site,
                        "thread": threading.current_thread().name})
            return


def _record_edge(a: str, b: str, site: str) -> None:
    tname = threading.current_thread().name
    with _state:
        info = _edges.get((a, b))
        fresh = info is None
        if fresh:
            info = _edges[(a, b)] = {"count": 0, "sites": [], "threads": []}
        info["count"] += 1
        if len(info["sites"]) < 4 and site not in info["sites"]:
            info["sites"].append(site)
        if tname not in info["threads"]:
            info["threads"].append(tname)
        if not fresh:
            return
        if a == b:
            # two INSTANCES sharing a name nested (same-object recursion
            # on a plain Lock would have deadlocked before reaching us).
            # One consistent nesting is not a deadlock — recorded as an
            # edge for visibility, excluded from cycle detection (give
            # the locks per-instance names to order instances)
            return
        cycle = _find_path_locked(b, a)
        if cycle is not None:
            _violations.append({
                "type": "lock-order",
                "edge": [a, b],
                "cycle": [a] + cycle,
                "site": site,
                "thread": tname,
            })


def _find_path_locked(src: str, dst: str) -> Optional[List[str]]:
    """Path src → … → dst over the observed edges, self-edges excluded
    (caller holds _state)."""
    adj: Dict[str, List[str]] = {}
    for (a, b) in _edges:
        if a != b:
            adj.setdefault(a, []).append(b)
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, p = stack.pop()
        for nxt in adj.get(node, ()):
            if nxt == dst:
                return p + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, p + [nxt]))
    return None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

class _TsanLock:
    """Order-recording proxy over a Lock/RLock."""

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name: str, inner, reentrant: bool = False):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self) -> None:
        _note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _TsanCondition:
    """Condition proxy sharing a :class:`_TsanLock`'s bookkeeping: the
    wait path records the implicit release/re-acquire so the per-thread
    held stack stays truthful across the block."""

    __slots__ = ("name", "_lockw", "_inner")

    def __init__(self, name: str, lockw: _TsanLock):
        self.name = name
        self._lockw = lockw
        self._inner = threading.Condition(lockw._inner)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lockw.acquire(blocking, timeout)

    def release(self) -> None:
        self._lockw.release()

    def __enter__(self):
        self._lockw.acquire()
        return self

    def __exit__(self, *exc):
        self._lockw.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        _note_release(self._lockw)
        try:
            # nnlint: disable=NNL204 — a pass-through proxy: the predicate
            # loop is the caller's contract, as with Condition.wait itself
            return self._inner.wait(timeout)
        finally:
            _note_acquire(self._lockw)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# ---------------------------------------------------------------------------
# NNS_LEAKCHECK — paired-resource leak ledger (see module docstring)
# ---------------------------------------------------------------------------

# module-global fast path: note_acquire/note_release check this and only
# this when the leak sanitizer is off (the microbench leg gates it)
LEAK = False

_leak_lock = threading.Lock()   # guards the ledger tables below
# (kind, key) -> {count, thread, site, t0, detail}
_ledger: Dict[Tuple[str, str], dict] = {}
_leak_totals: Dict[str, int] = {}         # kind -> total acquisitions seen


def enable_leakcheck() -> None:
    """Start recording paired acquisitions; clears the ledger."""
    global LEAK
    with _leak_lock:
        _ledger.clear()
        _leak_totals.clear()
        LEAK = True


def disable_leakcheck() -> None:
    global LEAK
    LEAK = False


def leakcheck_enabled() -> bool:
    return LEAK


def reset_leakcheck() -> None:
    """Drop every recorded acquisition (between test phases)."""
    with _leak_lock:
        _ledger.clear()
        _leak_totals.clear()


def note_acquire(kind: str, key: str, detail: str = "",
                 idempotent: bool = False) -> None:
    """Record one acquisition of a paired resource. ``idempotent=True``
    marks set-semantics registrations (weakset add, re-track): the
    ledger holds one unit per key no matter how often it re-registers."""
    if not LEAK:
        return
    site = _site(2)
    tname = threading.current_thread().name
    with _leak_lock:
        entry = _ledger.get((kind, key))
        if entry is None:
            entry = _ledger[(kind, key)] = {
                "count": 0, "thread": tname, "site": site,
                "sites": [], "t0": time.monotonic(), "detail": detail}
        if idempotent:
            entry["count"] = 1
        else:
            entry["count"] += 1
        # a refcounted key is acquired from several callers; the leaker
        # may not be the FIRST one, so keep every distinct site (bounded)
        # — outstanding() reports them all
        acq = f"{site} ({tname})"
        if acq not in entry["sites"] and len(entry["sites"]) < 4:
            entry["sites"].append(acq)
        _leak_totals[kind] = _leak_totals.get(kind, 0) + 1


def note_release(kind: str, key: str) -> None:
    """Record one release. Unknown (kind, key) pairs are ignored — the
    acquisition predates :func:`enable_leakcheck`, or a clamped
    double-release (the runtime pairs clamp at zero by design)."""
    if not LEAK:
        return
    with _leak_lock:
        entry = _ledger.get((kind, key))
        if entry is None:
            return
        entry["count"] -= 1
        if entry["count"] <= 0:
            del _ledger[(kind, key)]


def outstanding(kind: Optional[str] = None) -> List[dict]:
    """Currently-unreleased acquisitions, oldest first (JSON-friendly).
    The per-test zero-outstanding assertion reads this. ``site``/
    ``thread`` are the FIRST acquirer's; ``sites`` lists every distinct
    acquirer seen (bounded) — for refcounted keys the leaker can be any
    of them, and ``held_s`` measures from the first acquire."""
    now = time.monotonic()
    with _leak_lock:
        rows = [
            {"kind": k, "key": key, "count": e["count"],
             "thread": e["thread"], "site": e["site"],
             "sites": list(e["sites"]),
             "held_s": round(now - e["t0"], 3), "detail": e["detail"]}
            for (k, key), e in _ledger.items()
            if kind is None or k == kind]
    rows.sort(key=lambda r: -r["held_s"])
    return rows


def leak_report() -> dict:
    """Everything the leak ledger knows (JSON-friendly)."""
    with _leak_lock:
        totals = dict(_leak_totals)
    rows = outstanding()
    return {
        "enabled": LEAK,
        "acquired_total": totals,
        "outstanding": rows,
        "outstanding_units": sum(r["count"] for r in rows),
    }


# ---------------------------------------------------------------------------
# NNS_XFERCHECK — byte-accounted transfer sanitizer (see module docstring)
# ---------------------------------------------------------------------------

# module-global fast path: note_transfer/no_implicit_d2h check this and
# only this when the transfer sanitizer is off (the microbench leg
# gates it)
XFER = False

_xfer_lock = threading.Lock()   # guards the transfer tables below
# (stage, direction) -> {bytes, count, site}; direction is "d2h" / "h2d"
_xfer_ledger: Dict[Tuple[str, str], dict] = {}
_xfer_violations: List[dict] = []


def enable_xfercheck() -> None:
    """Arm the transfer guards and byte ledger; clears both tables."""
    global XFER
    with _xfer_lock:
        _xfer_ledger.clear()
        del _xfer_violations[:]
        XFER = True


def disable_xfercheck() -> None:
    global XFER
    XFER = False


def xfercheck_enabled() -> bool:
    return XFER


def reset_xfercheck() -> None:
    """Drop every recorded transfer and violation (between test phases)."""
    with _xfer_lock:
        _xfer_ledger.clear()
        del _xfer_violations[:]


def note_transfer(stage: str, direction: str, nbytes: int,
                  count: int = 1) -> None:
    """Account one INTENTIONAL transfer of ``nbytes`` at a choke point.
    ``direction`` is ``"d2h"`` (an explicit ``.cpu()`` / Buffer.as_numpy)
    or ``"h2d"`` (an upload to the card); wire encode/decode
    and queue hand-off account their host-side byte movement under
    ``"wire"`` / ``"queue"`` stage names so the per-stage scoreboard
    covers every boundary the zero-copy contract names."""
    if not XFER:
        return
    site = _site(2)
    with _xfer_lock:
        entry = _xfer_ledger.get((stage, direction))
        if entry is None:
            entry = _xfer_ledger[(stage, direction)] = {
                "bytes": 0, "count": 0, "site": site}
        entry["bytes"] += int(nbytes)
        entry["count"] += count


def nbytes_of(tensors) -> int:
    """Total byte size of a tensor/buffer sequence (torch tensors on any
    device, numpy arrays, bytes, memoryviews — anything with ``nbytes``,
    ``numel``/``element_size`` or a length)."""
    total = 0
    for t in tensors:
        nb = getattr(t, "nbytes", None)
        if nb is None and hasattr(t, "element_size"):  # a torch tensor
            nb = t.numel() * t.element_size()
        if nb is None:
            try:
                nb = len(t)
            except TypeError:
                nb = 0
        total += int(nb)
    return total


def xfer_transfers() -> List[dict]:
    """Per-(stage, direction) byte accounting rows (JSON-friendly),
    largest first."""
    with _xfer_lock:
        rows = [
            {"stage": stage, "direction": direction,
             "bytes": e["bytes"], "count": e["count"], "site": e["site"]}
            for (stage, direction), e in _xfer_ledger.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return rows


def xfer_violations() -> List[dict]:
    """Guard trips recorded so far. The port records none: PyTorch has
    no transfer guard, so only the byte ledger carries over (the list
    stays for the reference's report shape)."""
    with _xfer_lock:
        return list(_xfer_violations)


def xfer_report() -> dict:
    """Everything the transfer sanitizer knows (JSON-friendly)."""
    rows = xfer_transfers()
    totals: Dict[str, int] = {}
    for r in rows:
        totals[r["direction"]] = totals.get(r["direction"], 0) + r["bytes"]
    return {
        "enabled": XFER,
        "transfers": rows,
        "total_bytes": totals,
        "violations": xfer_violations(),
    }


# ---------------------------------------------------------------------------
# NNS_WIREFUZZ — structure-aware frame-fuzz scorekeeper (see module docstring)
# ---------------------------------------------------------------------------

# module-global fast path: note_frame_event/note_mutant check this and
# only this when the fuzzer is off (the microbench wirefuzz leg gates it)
WIREFUZZ = False

#: outcomes that satisfy the wire contract; anything else is a violation
WIREFUZZ_OK_OUTCOMES = ("typed", "clean")

_wf_lock = threading.Lock()   # guards the fuzz tables below
# surface -> outcome -> count (surface: "decode_frame", "shm_ring", ...)
_wf_outcomes: Dict[str, Dict[str, int]] = {}
_wf_violations: List[dict] = []
# stage -> {frames, bytes}: clean-decode accounting from the codec choke
# points (frame.py _note_wire_bytes) while the fuzzer is armed
_wf_frames: Dict[str, dict] = {}


def enable_wirefuzz() -> None:
    """Arm the fuzz scorekeeper; clears every table."""
    global WIREFUZZ
    with _wf_lock:
        _wf_outcomes.clear()
        del _wf_violations[:]
        _wf_frames.clear()
        WIREFUZZ = True


def disable_wirefuzz() -> None:
    global WIREFUZZ
    WIREFUZZ = False


def wirefuzz_enabled() -> bool:
    return WIREFUZZ


def reset_wirefuzz() -> None:
    """Drop every recorded outcome/violation (between test phases)."""
    with _wf_lock:
        _wf_outcomes.clear()
        del _wf_violations[:]
        _wf_frames.clear()


def note_frame_event(stage: str, nbytes: int) -> None:
    """Codec choke-point hook: one successfully decoded/encoded frame
    at ``stage`` (called from transport/frame.py's ``_note_wire_bytes``
    while armed) — the byte-parity denominator for surviving mutants."""
    if not WIREFUZZ:
        return
    with _wf_lock:
        entry = _wf_frames.get(stage)
        if entry is None:
            entry = _wf_frames[stage] = {"frames": 0, "bytes": 0}
        entry["frames"] += 1
        entry["bytes"] += int(nbytes)


def note_mutant(surface: str, mutation: str, outcome: str,
                detail: str = "") -> None:
    """Record one mutant's fate on one surface. ``outcome`` is ``typed``
    / ``clean`` (contract satisfied) or ``hang`` / ``crash`` /
    ``silent`` (recorded as a violation the per-test fixture gates)."""
    if not WIREFUZZ:
        return
    with _wf_lock:
        per = _wf_outcomes.setdefault(surface, {})
        per[outcome] = per.get(outcome, 0) + 1
        if outcome not in WIREFUZZ_OK_OUTCOMES:
            _wf_violations.append({
                "surface": surface, "mutation": mutation,
                "outcome": outcome, "detail": detail[:300],
                "thread": threading.current_thread().name})


def wirefuzz_violations() -> List[dict]:
    """Contract breaches recorded so far (hang/crash/silent mutants).
    The per-test fixture asserts no NEW entries."""
    with _wf_lock:
        return list(_wf_violations)


def wirefuzz_report() -> dict:
    """Everything the fuzz scorekeeper knows (JSON-friendly)."""
    with _wf_lock:
        surfaces = {s: dict(per) for s, per in _wf_outcomes.items()}
        frames = {s: dict(e) for s, e in _wf_frames.items()}
        viols = list(_wf_violations)
    total = sum(n for per in surfaces.values() for n in per.values())
    typed = sum(per.get("typed", 0) for per in surfaces.values())
    clean = sum(per.get("clean", 0) for per in surfaces.values())
    return {
        "enabled": WIREFUZZ,
        "surfaces": surfaces,
        "frames": frames,
        "mutants_total": total,
        "typed": typed,
        "clean": clean,
        "hangs": sum(per.get("hang", 0) for per in surfaces.values()),
        "crashes": sum(per.get("crash", 0) for per in surfaces.values()),
        "silent": sum(per.get("silent", 0) for per in surfaces.values()),
        "violations": viols,
    }


if os.environ.get("NNS_TSAN", "") == "1":
    enable(hold_warn_s=float(os.environ.get("NNS_TSAN_HOLD_S", "5")))
if os.environ.get("NNS_LEAKCHECK", "") == "1":
    enable_leakcheck()
if os.environ.get("NNS_WIREFUZZ", "") == "1":
    enable_wirefuzz()
