"""Versioned model slots: zero-downtime rollout for running services (L7).

Reference analog: the ML-Agent model database (``mlagent://`` URIs with
registered versions + activate semantics) — but where the reference
resolves a version once at pipeline build, a service slot stays LIVE:
launch lines reference ``registry://<slot>`` (resolved through the
process-local registry overlay, :mod:`..registry.models`), and
:meth:`ModelSlots.swap` rolls every bound, running ``tensor_filter`` to a
new version without stopping the pipeline:

    prepare-new  — open a second backend for the new version (the old one
                   keeps serving every frame meanwhile);
    warmup       — invoke the new backend once on zeros shaped like the
                   negotiated input, on its device, and wait for the
                   device to finish it (a model that cannot serve must
                   fail HERE, not on live traffic; its first forward's
                   cost lands here too);
    atomic flip  — swap the element's backend pointer under its invoke
                   lock (one pointer store: no frame ever sees a
                   half-swapped model);
    retire-old   — release the previous backend after the flip, once the
                   fence behind the last work that read its weights has
                   passed (``TensorFilter.release_prepared``).

Warmup failure rolls back: prepared backends are released, the active
version and every live element are untouched, and :class:`SwapError`
carries the cause.

Fused-segment interaction (runtime/fusion.py): a filter running inside a
fused device segment serves through a COMPOSED callable (a CUDA graph on
the card), not its own backend dispatch. ``commit_model`` invalidates the
segment right after the flip, so the next buffer re-captures against the
new backend; a
canary router (no traceable callable) defuses its segment for the canary
window and the promote/cancel commit re-fuses it. Fractional **canary** routing wraps the live backend
in a deterministic splitter that sends ``fraction`` of invokes to the
candidate version — promote installs it for 100%, rollback discards it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.sanitizer import named_lock
from ..obs import flight as obs_flight
from ..obs import quality as obs_quality
from ..registry.models import register_local_model, unregister_local_model
from ..utils.log import logger


class SwapError(RuntimeError):
    """A hot swap failed and was rolled back (old version still serving)."""


class QualityGateError(SwapError):
    """Canary promotion refused by the output-quality gate: the
    candidate's output sketch diverges from the primary's (or it emits
    NaN/Inf, or it raised on mirrored live inputs). The canary stays
    live — gather more samples, fix the model, or ``cancel_canary``."""

    def __init__(self, message: str, report: Optional[dict] = None):
        super().__init__(message)
        self.report = report or {}


class _CanaryBackend:
    """Deterministic fractional router between the live backend and a
    candidate. Invoke ``i`` routes to the canary when the running product
    ``floor((i+1)*f) > floor(i*f)`` — exact long-run fraction, no rng.
    Everything except ``invoke`` proxies to the primary (negotiation,
    model info, events).

    With a quality monitor attached (``canary(..., quality_gate=...)``)
    the router also records output health into the monitor's
    primary/canary sketches and MIRRORS a deterministic sample of
    primary traffic through the candidate (shadow invoke: output
    discarded, never served) — so even a tiny-fraction canary gathers
    enough candidate samples for the promote gate, and a candidate that
    crashes on live inputs fails the gate with zero client-visible
    request errors."""

    def __init__(self, primary, canary, fraction: float, quality=None):
        self.primary = primary
        self.canary = canary
        self.fraction = float(fraction)
        self.quality = quality  # shared obs_quality.CanaryQuality or None
        self._lock = named_lock("CanaryBackend._lock")
        self._n = 0                 # guarded-by: _lock
        self.primary_invokes = 0    # guarded-by: _lock
        self.canary_invokes = 0     # guarded-by: _lock

    def _pick_canary(self) -> bool:
        with self._lock:
            n = self._n
            self._n += 1
            hit = int((n + 1) * self.fraction) > int(n * self.fraction)
            if hit:
                self.canary_invokes += 1
            else:
                self.primary_invokes += 1
            return hit

    def invoke(self, inputs):
        q = self.quality
        if self._pick_canary():
            # routed-canary outputs are NOT recorded in the gate
            # sketches: the router's deterministic split can correlate
            # with input structure (alternating frame types at
            # fraction=0.5 sends every B-frame to the canary), and
            # sketches built over different input populations would
            # diverge by input mix alone
            return self.canary.invoke(inputs)
        out = self.primary.invoke(inputs)
        if q is not None and q.should_mirror():
            # the gate compares ONLY mirrored pairs: both sides observe
            # the SAME live input, so the two sketches are built over
            # an identical input population and directly comparable
            q.observe_primary(out)
            try:
                q.observe_canary(self.canary.invoke(inputs),
                                 mirrored=True)
            except Exception as e:  # noqa: BLE001 - a shadow failure is
                # a GATE verdict, never a client-visible error
                q.mirror_failed(e)
        return out

    def fusion_callable(self):
        """Never traceable: per-invoke routing is the whole point. Must be
        explicit — __getattr__ would otherwise proxy to the primary's
        traceable callable and the fused segment would re-fuse around the
        primary, starving the canary of traffic for its whole window."""
        return None

    def routing_stats(self) -> dict:
        with self._lock:
            return {"fraction": self.fraction,
                    "primary_invokes": self.primary_invokes,
                    "canary_invokes": self.canary_invokes}

    def __getattr__(self, name):
        return getattr(self.primary, name)


class ModelSlots:
    """The manager's named, versioned model slots."""

    def __init__(self, manager):
        self._manager = manager
        self._lock = named_lock("ModelSlots._lock")
        self._slots: Dict[str, dict] = {}  # guarded-by: _lock

    # -- definition ----------------------------------------------------------
    def define(self, name: str, versions: Dict[str, str],
               active: str, drafts: Optional[Dict[str, str]] = None) -> None:
        """Create/replace a slot: ``versions`` maps version → model URI
        (any form tensor_filter accepts). Publishes ``registry://name``.

        ``drafts`` maps a version to its speculative-decode DRAFT
        companion URI: the slot then carries (draft, target) as a pair —
        rollouts move both together, and :meth:`promote_canary` can
        arbitrate the pair's draft-acceptance rate
        (docs/service.md#draft-target-slots)."""
        if active not in versions:
            raise KeyError(f"slot '{name}': active version '{active}' not "
                           f"in {sorted(versions)}")
        drafts = dict(drafts or {})
        unknown = sorted(set(drafts) - set(versions))
        if unknown:
            raise KeyError(f"slot '{name}': draft(s) for unknown "
                           f"version(s) {unknown}")
        with self._lock:
            self._slots[name] = {"versions": dict(versions),
                                 "active": active, "canary": None,
                                 "drafts": drafts,
                                 "spec_acceptance": {}}
        self._publish(name)

    def add_version(self, name: str, version: str, uri: str,
                    draft: Optional[str] = None) -> None:
        with self._lock:
            slot = self._slot(name)
            slot["versions"][version] = uri
            if draft is not None:
                slot["drafts"][version] = draft
        self._publish(name)

    def _slot(self, name: str) -> dict:
        if name not in self._slots:
            raise KeyError(f"unknown model slot '{name}' "
                           f"(have: {sorted(self._slots)})")
        return self._slots[name]

    def _publish(self, name: str) -> None:
        """Mirror the slot into the process-local registry overlay so
        ``model=registry://name`` resolves with no registry file."""
        with self._lock:
            slot = self._slot(name)
            entry = {"versions": dict(slot["versions"]),
                     "active": slot["active"]}
        register_local_model(name, entry)

    def unpublish_all(self) -> None:
        with self._lock:
            names = list(self._slots)
        for n in names:
            unregister_local_model(n)

    def info(self, name: str) -> dict:
        with self._lock:
            slot = self._slot(name)
            out = {"versions": dict(slot["versions"]),
                   "active": slot["active"]}
            if slot.get("drafts"):
                out["drafts"] = dict(slot["drafts"])
            if slot.get("spec_acceptance"):
                out["spec_acceptance"] = {
                    v: dict(o) for v, o in slot["spec_acceptance"].items()}
            canary = slot["canary"]
        if canary is not None:
            version, router = canary
            out["canary"] = {"version": version, **router.routing_stats()}
            if router.quality is not None:
                out["canary"]["quality"] = router.quality.report()
        return out

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def uri(self, name: str, version: Optional[str] = None) -> str:
        with self._lock:
            slot = self._slot(name)
            ver = version or slot["active"]
            if ver not in slot["versions"]:
                raise KeyError(f"slot '{name}' has no version '{ver}' "
                               f"(have: {sorted(slot['versions'])})")
            return slot["versions"][ver]

    def draft_uri(self, name: str,
                  version: Optional[str] = None) -> Optional[str]:
        """The speculative-decode draft companion of ``version`` (active
        version by default), or None — a version without a draft serves
        target-only."""
        with self._lock:
            slot = self._slot(name)
            ver = version or slot["active"]
            if ver not in slot["versions"]:
                raise KeyError(f"slot '{name}' has no version '{ver}' "
                               f"(have: {sorted(slot['versions'])})")
            return slot.get("drafts", {}).get(ver)

    def note_spec_acceptance(self, name: str, version: str,
                             rate: float, rounds: int) -> None:
        """Record a (draft, target) pair's observed draft-acceptance
        rate over ``rounds`` speculative rounds (the serving plane's
        ``spec_acceptance_rate`` snapshot, or a bench canary). The most
        recent observation per version is what
        :meth:`promote_canary`'s acceptance gate arbitrates against."""
        with self._lock:
            slot = self._slot(name)
            if version not in slot["versions"]:
                raise KeyError(f"slot '{name}' has no version '{version}' "
                               f"(have: {sorted(slot['versions'])})")
            slot.setdefault("spec_acceptance", {})[version] = {
                "rate": float(rate), "rounds": int(rounds)}

    # -- live bindings -------------------------------------------------------
    def bound_filters(self, name: str) -> List[Tuple[object, object]]:
        """(service, tensor_filter element) pairs whose ``model`` property
        references this slot un-pinned (``registry://name``; an ``@ver``
        pin opts the element out of rollouts, same as the reference)."""
        from ..elements.filter import TensorFilter

        ref = f"registry://{name}"
        out = []
        for svc in self._manager.services():
            pipe = svc.pipeline
            if pipe is None:
                continue
            for el in pipe.elements.values():
                if isinstance(el, TensorFilter) and el.props.get("model") == ref:
                    out.append((svc, el))
        return out

    # -- hot swap ------------------------------------------------------------
    def swap(self, name: str, version: str, services=None,
             activate: bool = True) -> dict:
        """Roll every bound running filter to ``version`` (prepare → warmup
        → flip → retire), then activate it for future starts. Rollback on
        any warmup failure. Returns {"slot","version","flipped": N}.

        ``services`` restricts the flip to filters bound through those
        :class:`~.manager.Service` objects — the per-replica step of a
        fabric ROLLING swap (service/fabric.py drains one replica, flips
        only it, readmits, then moves on). ``activate=False`` flips the
        selected filters without advancing the slot's active version
        (fabric replica-canary: one replica serves the candidate while
        restarts elsewhere still resolve the old version)."""
        uri = self.uri(name, version)  # validates slot + version
        with self._lock:
            has_canary = self._slot(name)["canary"] is not None
        if has_canary:
            # a live canary router would be retired as 'old' by the flip,
            # leaking its candidate backend — unwind it first so the flip
            # retires a plain backend
            self.cancel_canary(name)
        bound = self.bound_filters(name)
        if services is not None:
            keep = {id(s) for s in services}
            bound = [(svc, el) for svc, el in bound if id(svc) in keep]
        prepared = self._prepare_all(bound, uri, name, version,
                                     what=f"swap to '{version}'")
        # phase 2: atomic flips (pointer store under each element's invoke
        # lock) + retire the old backends. The element's model PROPERTY
        # keeps the stable registry:// slot reference — a suspend/resume
        # reopen resolves it against the new active version below
        for el, backend in prepared:
            old = el.commit_model(backend, f"registry://{name}")
            el.release_prepared(old)
        if activate:
            with self._lock:
                self._slot(name)["active"] = version
                self._slot(name)["canary"] = None
            self._publish(name)
        logger.info("slot %s: swapped to version %s (%d live filters "
                    "flipped%s)", name, version, len(prepared),
                    "" if activate else ", not activated")
        return {"slot": name, "version": version, "flipped": len(prepared)}

    def _prepare_all(self, bound, uri: str, name: str, version: str,
                     what: str) -> List[Tuple[object, object]]:
        """Phase 1 of any rollout: prepare + warmup EVERY bound element
        before touching ANY live backend — all-or-nothing, with prepared
        backends closed on the first failure."""
        prepared: List[Tuple[object, object]] = []  # (element, new backend)
        try:
            for _svc, el in bound:
                backend = el.prepare_model(uri)
                self._warmup(el, backend, name, version)
                prepared.append((el, backend))
        except Exception as e:
            for _el, backend in prepared:
                try:
                    backend.close()
                except Exception:  # noqa: BLE001 - rollback is best-effort
                    pass
            raise SwapError(
                f"slot '{name}' {what} rolled back: {e}") from e
        return prepared

    @staticmethod
    def _warmup(el, backend, name: str, version: str) -> None:
        """One inference on zeros shaped like the element's negotiated
        input. No negotiated caps yet (service not started) ⇒ nothing to
        warm against — the regular start-time warmup covers it."""
        info = getattr(el, "_in_info", None)
        if info is None or not info.specs:
            return
        zeros = [np.zeros(tuple(s.shape), dtype=s.dtype.np_dtype)
                 for s in info.specs]
        out = backend.invoke(zeros)
        if not out:
            raise SwapError(
                f"slot '{name}' version '{version}': warmup inference "
                "returned no outputs")
        for t in out:  # the warmup counts only once the card finished it
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()

    # -- canary --------------------------------------------------------------
    def canary(self, name: str, version: str, fraction: float,
               quality_gate=None) -> dict:
        """Route ``fraction`` of each bound filter's invokes to ``version``
        (prepared + warmed like a swap), keeping the active version on the
        rest. One canary per slot.

        ``quality_gate`` arms the output-quality gate (``True`` for the
        defaults, a dict of :class:`~..obs.quality.QualityGate` fields,
        or a ready instance): routers then mirror a deterministic sample
        of primary traffic through the candidate and record both sides'
        output health, and :meth:`promote_canary` refuses with a typed
        :class:`QualityGateError` when the candidate's output sketch
        diverges beyond the gate (docs/service.md#canary-quality-gate).

        A canary is a LIVE-TRAFFIC experiment, not durable state: it lasts
        until promoted or canceled. Stopping/restarting a bound service
        (or a ``suspend=`` idle unload) reopens the filter at the slot's
        ACTIVE version — end the experiment first; ``promote_canary``
        refuses when no live router remains.
        """
        if not 0.0 < fraction < 1.0:
            raise ValueError(f"canary fraction {fraction} must be in (0,1)")
        gate = obs_quality.QualityGate.from_config(quality_gate)
        monitor = obs_quality.CanaryQuality(gate) if gate is not None \
            else None
        uri = self.uri(name, version)
        with self._lock:
            if self._slot(name)["canary"] is not None:
                raise SwapError(f"slot '{name}' already has a canary "
                                "(promote or cancel it first)")
        bound = self.bound_filters(name)
        if not bound:
            raise SwapError(f"slot '{name}': no running filter bound — "
                            "canary needs live traffic to split")
        routers = []
        prepared = self._prepare_all(bound, uri, name, version,
                                     what=f"canary '{version}'")
        for el, backend in prepared:
            # ONE monitor shared by every bound filter's router: the
            # gate's verdict covers the slot, not one element
            router = _CanaryBackend(el.backend, backend, fraction,
                                    quality=monitor)
            el.commit_model(router, el.props["model"])  # model ref unchanged
            routers.append(router)
        with self._lock:
            self._slot(name)["canary"] = (version, routers[0])
        logger.info("slot %s: canary %s at %.0f%% across %d filters%s",
                    name, version, fraction * 100, len(routers),
                    " (quality gate armed)" if monitor is not None else "")
        return {"slot": name, "canary": version, "fraction": fraction,
                "filters": len(routers),
                "quality_gate": gate.spec() if gate is not None else None}

    def promote_canary(self, name: str, acceptance_gate=None) -> dict:
        """Canary graduates: its backend becomes the active one everywhere,
        the old primary retires, and the slot's active version advances.

        With a quality gate armed, promotion is checked FIRST: a
        candidate whose output sketch diverges from the primary's (PSI
        drift, new NaN/Inf, or a mirrored-invoke crash) is refused with
        a typed :class:`QualityGateError` — a ``quality`` flight event
        and the ``nns_quality_gate_refusals_total`` counter record the
        refusal, and the canary stays live for more samples or a
        ``cancel_canary``.

        ``acceptance_gate`` additionally arbitrates speculative-decode
        (draft, target) pairs (``True`` for defaults, a dict of
        :class:`~..obs.quality.SpecAcceptanceGate` fields, or an
        instance): the candidate version's recorded draft-acceptance
        (:meth:`note_spec_acceptance`) must clear the floor and must not
        regress the ACTIVE pair's rate beyond the gate — output parity
        is guaranteed by construction, so this gate guards the
        THROUGHPUT the pair was promoted to win."""
        with self._lock:
            slot = self._slot(name)
            canary = slot["canary"]
            active = slot["active"]
            acc = dict(slot.get("spec_acceptance", {}))
        if canary is None:
            raise SwapError(f"slot '{name}' has no canary to promote")
        version, router = canary
        acc_gate = obs_quality.SpecAcceptanceGate.from_config(acceptance_gate)
        if acc_gate is not None:
            ok, reason = acc_gate.verdict(acc.get(version), acc.get(active))
            if not ok:
                obs_quality.GATE_REFUSALS.inc()
                obs_flight.record(
                    "quality", "gate_refused",
                    {"slot": name, "version": version, "reason": reason,
                     "gate": "spec_acceptance"})
                logger.warning("slot %s: canary '%s' promotion REFUSED "
                               "by acceptance gate: %s", name, version,
                               reason)
                raise QualityGateError(
                    f"slot '{name}': canary '{version}' failed the "
                    f"speculative-acceptance gate: {reason}",
                    report={"spec_acceptance": acc,
                            "gate": acc_gate.spec()})
        monitor = router.quality
        if monitor is not None:
            ok, reason, report = monitor.verdict()
            if not ok:
                obs_quality.GATE_REFUSALS.inc()
                obs_flight.record(
                    "quality", "gate_refused",
                    {"slot": name, "version": version, "reason": reason,
                     "divergence": report.get("divergence"),
                     "mirrors": report.get("mirrors")})
                logger.warning("slot %s: canary '%s' promotion REFUSED "
                               "by quality gate: %s", name, version, reason)
                raise QualityGateError(
                    f"slot '{name}': canary '{version}' failed the "
                    f"quality gate: {reason}", report=report)
        flipped = 0
        for _svc, el in self.bound_filters(name):
            router = el.backend
            if isinstance(router, _CanaryBackend):
                el.commit_model(router.canary, el.props["model"])
                # the router's retirement fenced the primary's last work
                el.release_prepared(router.primary, fence_of=router)
                flipped += 1
        if flipped == 0:
            # the routers are gone (service restarted / filter reopened at
            # the active version): promoting would claim a version no live
            # element is serving
            with self._lock:
                self._slot(name)["canary"] = None
            raise SwapError(
                f"slot '{name}': canary '{version}' no longer live (bound "
                "services restarted?) — canary cleared, active version "
                "unchanged; rerun canary() or swap()")
        with self._lock:
            self._slot(name)["active"] = version
            self._slot(name)["canary"] = None
        self._publish(name)
        out = {"slot": name, "version": version, "promoted": True,
               "flipped": flipped}
        if monitor is not None:
            out["quality"] = monitor.report()
        return out

    def cancel_canary(self, name: str) -> dict:
        """Abort the canary: candidate backends close, the primary keeps
        serving 100% again."""
        with self._lock:
            canary = self._slot(name)["canary"]
        if canary is None:
            raise SwapError(f"slot '{name}' has no canary to cancel")
        version, _router = canary
        for _svc, el in self.bound_filters(name):
            router = el.backend
            if isinstance(router, _CanaryBackend):
                el.commit_model(router.primary, el.props["model"])
                try:
                    # after the fence of the router's retirement, behind
                    # the last work that read the candidate's weights
                    el.release_prepared(router.canary, fence_of=router)
                except Exception:  # noqa: BLE001
                    pass
        with self._lock:
            self._slot(name)["canary"] = None
        return {"slot": name, "canceled": version}
