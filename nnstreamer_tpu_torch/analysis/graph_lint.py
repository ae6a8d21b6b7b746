"""Pass 1: static pipeline-graph validation (rules NNL0xx).

Runs on parsed-but-not-started :class:`Pipeline` objects — nothing is
played, no backend is opened, no device is grabbed. Three stages:

1. **dry checks** on the launch text (``NNL001``/``NNL002``): element and
   property names are cross-checked against the registry *before* any
   element is constructed, so a typo'd pipeline yields a did-you-mean
   diagnostic instead of a stack trace;
2. **topology** (``NNL004``–``NNL007``, ``NNL011``): dangling pads,
   cycles, unreachable elements, tee/mux arity, missing sources/sinks;
3. **abstract caps propagation** (``NNL003``, ``NNL008``–``NNL010``):
   each source's statically-known caps flow downstream through
   caps-transparent elements and capsfilters using the SAME negotiation
   algebra the runtime uses (``core.caps`` intersect) — a link whose
   estimate can't intersect the downstream constraint is reported as the
   negotiation failure it would become at play(), and the estimates feed
   the perf-hazard rules (flexible streams re-capturing per shape,
   serving bucket coverage, device→host→device round-trips).

The port of nnstreamer_tpu's ``analysis/graph_lint.py``: the same rules,
codes and severities on the same launch lines.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..core.caps import Caps, looks_like_caps, parse_caps_string
from .diagnostics import Diagnostic, make

# element factories the caps estimate may flow THROUGH unchanged
# (true identity elements; capsfilter is handled structurally)
_IDENTITY_ELEMENTS = {"queue", "tee"}

# combiner factories whose request sink pads only make sense >= 2
_COMBINERS = {"tensor_mux", "tensor_merge", "compositor", "tensor_join"}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_launch(description: str) -> List[Diagnostic]:
    """Lint a gst-launch-style text pipeline: dry registry checks first,
    then (when the text is constructible) the full graph lint."""
    diags = _dry_check(description)
    if any(d.is_error for d in diags):
        return diags
    from ..runtime.parse import parse_launch

    try:
        pipe = parse_launch(description)
    except Exception as e:  # noqa: BLE001 - reported as a diagnostic
        diags.append(make(
            "NNL012", f"pipeline does not build: {type(e).__name__}: {e}",
            location="launch"))
        return diags
    return diags + lint_pipeline(pipe)


def lint_pbtxt(text: str) -> List[Diagnostic]:
    """Lint a MediaPipe-style pbtxt graph (reference converter format)."""
    from ..runtime.pbtxt import from_pbtxt

    try:
        launch = from_pbtxt(text)
    except Exception as e:  # noqa: BLE001 - reported as a diagnostic
        return [make("NNL012", f"pbtxt does not parse: {e}",
                     location="pbtxt")]
    return lint_launch(launch)


def lint_pipeline(pipeline) -> List[Diagnostic]:
    """Lint a constructed Pipeline object (graph rules only — element
    and property names were validated at construction)."""
    diags: List[Diagnostic] = []
    elements = list(pipeline.elements.values())
    diags += _check_completeness(elements)
    diags += _check_dangling(elements)
    cyclic = _check_cycles(elements, diags)
    diags += _check_reachability(elements)
    diags += _check_arity(elements)
    if not cyclic:
        est = _propagate_caps(elements, diags)
        diags += _check_filter_hazards(elements, est)
        diags += _check_serving_buckets(elements, est)
    diags += _check_host_roundtrip(elements)
    diags += _check_fusion_plan(pipeline)
    diags += _check_placement_hint(pipeline)
    diags += _check_aot_artifacts(pipeline)
    return diags


# ---------------------------------------------------------------------------
# dry checks (no construction)
# ---------------------------------------------------------------------------

def _dry_check(description: str) -> List[Diagnostic]:
    from ..registry.elements import (
        element_factories,
        get_factory,
        merged_properties,
        suggest_element,
    )
    from ..runtime.parse import _NAME_REF_RE, launch_chains

    diags: List[Diagnostic] = []
    try:
        chains = launch_chains(description)
    except ValueError as e:
        return [make("NNL012", f"launch string does not parse: {e}",
                     location="launch")]
    known = set(element_factories())
    for chain in chains:
        for entry in chain:
            head = entry[0]
            if _NAME_REF_RE.match(head) and len(entry) == 1:
                continue  # "t." pad reference
            if looks_like_caps(head):
                try:
                    parse_caps_string(" ".join(entry))
                except Exception as e:  # noqa: BLE001
                    diags.append(make(
                        "NNL012", f"bad caps string '{head}': {e}",
                        location="launch"))
                continue
            if head not in known:
                hint = suggest_element(head)
                diags.append(make(
                    "NNL001", f"unknown element '{head}'",
                    location="launch",
                    hint=f"did you mean '{hint}'?" if hint else ""))
                continue
            cls = get_factory(head)
            props = set(merged_properties(cls))
            aliases = {}
            for klass in cls.__mro__:
                for k, v in (getattr(klass, "PROP_ALIASES", {}) or {}).items():
                    aliases.setdefault(k, v)
            for tok in entry[1:]:
                key, eq, _ = tok.partition("=")
                if not eq:
                    diags.append(make(
                        "NNL012", f"bad property token '{tok}' for "
                        f"element {head}", location="launch"))
                    continue
                key_n = key.replace("-", "_")
                key_n = aliases.get(key_n, key_n)
                if key_n in ("name", "config_file"):
                    continue
                if "::" in key_n and getattr(cls, "ACCEPT_CHILD_PROPS", False):
                    continue
                if key_n not in props:
                    close = _closest(key_n, props)
                    diags.append(make(
                        "NNL002",
                        f"element '{head}' has no property '{key}'",
                        location="launch",
                        hint=f"did you mean '{close}'?" if close else ""))
    return diags


def _closest(name: str, candidates) -> Optional[str]:
    import difflib

    matches = difflib.get_close_matches(name, list(candidates), n=1,
                                        cutoff=0.6)
    return matches[0] if matches else None


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

def _is_source(el) -> bool:
    return not el.sink_pads


def _is_sink(el) -> bool:
    return not el.src_pads


def _downstream(el):
    for pad in el.src_pads:
        if pad.peer is not None and pad.peer.element is not None:
            yield pad.peer.element


def _upstream(el):
    for pad in el.sink_pads:
        if pad.peer is not None and pad.peer.element is not None:
            yield pad.peer.element


def _check_completeness(elements) -> List[Diagnostic]:
    diags = []
    if elements and not any(_is_source(e) for e in elements):
        diags.append(make("NNL011", "pipeline has no source element",
                          location="pipeline"))
    if elements and not any(_is_sink(e) for e in elements):
        diags.append(make("NNL011", "pipeline has no sink element",
                          location="pipeline"))
    return diags


def _check_dangling(elements) -> List[Diagnostic]:
    diags = []
    for el in elements:
        linked = any(p.is_linked for p in el.sink_pads + el.src_pads)
        if not linked and len(elements) > 1 and not _is_source(el):
            # fully isolated non-source: reported once as unreachable
            # (a source is never "unreachable" — it seeds reachability —
            # so its dangling src pads must be reported here)
            continue
        for pad in el.sink_pads:
            if not pad.is_linked:
                diags.append(make(
                    "NNL004", f"sink pad '{pad.full_name}' is unlinked — "
                    "it will never receive data", location=el.name))
        for pad in el.src_pads:
            if not pad.is_linked:
                diags.append(make(
                    "NNL004", f"src pad '{pad.full_name}' is unlinked — "
                    "its buffers are dropped", location=el.name))
    return diags


def _check_cycles(elements, diags: List[Diagnostic]) -> bool:
    """DFS cycle detection; appends NNL005 and returns True on a cycle."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {id(e): WHITE for e in elements}
    found = False

    def visit(el, path):
        nonlocal found
        color[id(el)] = GRAY
        path.append(el.name)
        for nxt in _downstream(el):
            c = color.get(id(nxt), WHITE)
            if c == GRAY and not found:
                found = True
                start = path.index(nxt.name) if nxt.name in path else 0
                loop = path[start:] + [nxt.name]
                diags.append(make(
                    "NNL005",
                    f"element graph contains a cycle: {' -> '.join(loop)}",
                    location=nxt.name))
            elif c == WHITE:
                visit(nxt, path)
        path.pop()
        color[id(el)] = BLACK

    for el in elements:
        if color[id(el)] == WHITE:
            visit(el, [])
    return found


def _check_reachability(elements) -> List[Diagnostic]:
    sources = [e for e in elements if _is_source(e)]
    if not sources:
        return []  # NNL011 already covers the no-source case
    seen = set()
    stack = list(sources)
    while stack:
        el = stack.pop()
        if id(el) in seen:
            continue
        seen.add(id(el))
        stack.extend(_downstream(el))
        # crop-style multi-input elements pull companions in via their
        # other sinks; those upstreams still count as "wired up"
    diags = []
    for el in elements:
        if id(el) not in seen:
            diags.append(make(
                "NNL006", f"element '{el.name}' "
                f"({el.ELEMENT_NAME or type(el).__name__}) is not "
                "reachable from any source", location=el.name))
    return diags


def _check_arity(elements) -> List[Diagnostic]:
    diags = []
    for el in elements:
        kind = el.ELEMENT_NAME
        if kind == "tee":
            n = sum(1 for p in el.src_pads if p.is_linked)
            if n <= 1:
                diags.append(make(
                    "NNL007", f"tee '{el.name}' has {n} linked "
                    f"branch{'es' if n != 1 else ''} — a tee needs >= 2 "
                    "to be useful", location=el.name))
        elif kind in _COMBINERS:
            n = sum(1 for p in el.sink_pads if p.is_linked)
            if n < 2:
                diags.append(make(
                    "NNL007", f"{kind} '{el.name}' has {n} linked "
                    f"input{'s' if n != 1 else ''} — combining needs "
                    ">= 2", location=el.name))
    return diags


# ---------------------------------------------------------------------------
# abstract caps propagation
# ---------------------------------------------------------------------------

def _topo_order(elements) -> List:
    indeg = {id(e): 0 for e in elements}
    for el in elements:
        for _ in _upstream(el):
            indeg[id(el)] += 1
    order, ready = [], [e for e in elements if indeg[id(e)] == 0]
    while ready:
        el = ready.pop()
        order.append(el)
        for nxt in _downstream(el):
            indeg[id(nxt)] -= 1
            if indeg[id(nxt)] == 0:
                ready.append(nxt)
    return order


def _source_estimate(el) -> Optional[Caps]:
    """A source's statically-known caps, or None. get_src_caps is cheap
    and side-effect-free for the built-in sources (synthetic generators
    read their props; file sources read headers)."""
    try:
        return el.get_src_caps()
    except Exception:  # noqa: BLE001 - unknown until runtime
        return None


def _out_estimate(el, in_caps: Optional[Caps]) -> Optional[Caps]:
    """Abstract transfer function: what flows out of ``el`` given the
    first linked sink pad's estimate. None = unknown (checks skip)."""
    filter_caps = getattr(el, "filter_caps", None)
    if filter_caps is not None:  # capsfilter (duck-typed, as media.py does)
        if in_caps is None:
            return filter_caps
        out = in_caps.intersect(filter_caps)
        return out if not out.is_empty else None
    if _is_source(el):
        return _source_estimate(el)
    if getattr(el, "CAPS_TRANSPARENT", False) or \
            el.ELEMENT_NAME in _IDENTITY_ELEMENTS:
        return in_caps
    return None


def _propagate_caps(elements, diags: List[Diagnostic]) -> Dict[int, Caps]:
    """Flow estimates downstream in topological order. Returns a map of
    ``id(sink_pad) -> Caps`` — the estimate ARRIVING at each sink pad —
    and appends NNL003 for links whose estimate can't negotiate."""
    arriving: Dict[int, Caps] = {}
    for el in _topo_order(elements):
        in_caps: Optional[Caps] = None
        for pad in el.sink_pads:
            got = arriving.get(id(pad))
            if got is not None and in_caps is None:
                in_caps = got
        out = _out_estimate(el, in_caps)
        # a capsfilter whose filter can't intersect its input is itself
        # the mismatch (the estimate went empty inside _out_estimate)
        filter_caps = getattr(el, "filter_caps", None)
        if (filter_caps is not None and in_caps is not None
                and in_caps.intersect(filter_caps).is_empty):
            diags.append(make(
                "NNL003",
                f"caps filter '{el.name}' ({filter_caps}) cannot "
                f"intersect the upstream stream ({in_caps}) — "
                "negotiation would fail at play()", location=el.name))
            continue
        if out is None:
            continue
        for pad in el.src_pads:
            peer = pad.peer
            if peer is None:
                continue
            eff = out.intersect(peer.template.caps)
            if eff.is_empty:
                diags.append(make(
                    "NNL003",
                    f"link {pad.full_name} -> {peer.full_name}: upstream "
                    f"caps ({out}) cannot intersect the sink template "
                    f"({peer.template.caps})", location=peer.full_name))
                continue
            arriving[id(peer)] = eff
    return arriving


# ---------------------------------------------------------------------------
# perf-hazard rules
# ---------------------------------------------------------------------------

def _arriving_info(el, est: Dict[int, Caps]):
    """(caps, TensorsInfo|None) arriving at el's first estimated sink."""
    from ..core.caps import tensors_info_from_caps

    for pad in el.sink_pads:
        caps = est.get(id(pad))
        if caps is None:
            continue
        try:
            return caps, tensors_info_from_caps(caps)
        except Exception:  # noqa: BLE001 - non-tensor caps
            return caps, None
    return None, None


def _check_filter_hazards(elements, est) -> List[Diagnostic]:
    """NNL008: a flexible (per-frame-shaped) stream feeding a
    tensor_filter re-captures its fused segment on every new shape."""
    from ..core.caps import caps_tensor_format
    from ..core.tensors import TensorFormat

    diags = []
    for el in elements:
        if el.ELEMENT_NAME != "tensor_filter":
            continue
        caps, _ = _arriving_info(el, est)
        if caps is None or \
                caps_tensor_format(caps) is not TensorFormat.FLEXIBLE:
            continue
        if el.props.get("invoke_dynamic"):
            continue  # declared dynamic: the backend expects it
        diags.append(make(
            "NNL008",
            f"tensor_filter '{el.name}' receives a FLEXIBLE stream while "
            "a fused segment captures one CUDA graph per input signature "
            "— every new frame shape re-captures in the hot loop",
            location=el.name,
            hint="bucket shapes upstream (tensor_aggregator / pad), set "
                 "invoke-dynamic=true, or retire the BATCH-dim half by "
                 "construction: a shape-poly AOT artifact (NNS_AOT_CACHE, "
                 "nnstreamer_tpu_torch/aot, docs/aot.md) serves every batch "
                 "size through ONE exported program — trailing dims stay "
                 "concrete, so bucket those upstream first; NNL015 reports "
                 "coverage. For LM PROMPTS the fix is chunked prefill "
                 "(serving.PagedLMEngine): the fixed chunk is the only "
                 "prefill shape"))
    return diags


def _check_serving_buckets(elements, est) -> List[Diagnostic]:
    """NNL009: declared input rows a tensor_serving bucket set can't
    cover — every buffer overflows the largest bucket."""
    from ..core.tensors import TensorFormat

    diags = []
    for el in elements:
        if el.ELEMENT_NAME != "tensor_serving":
            continue
        try:
            buckets = sorted(
                int(p) for p in str(el.props["bucket_sizes"]).split(",")
                if p.strip())
        except (ValueError, KeyError):
            continue  # element construction already validated/failed
        if not buckets:
            continue
        _, info = _arriving_info(el, est)
        if info is None or info.format is not TensorFormat.STATIC \
                or not info.specs:
            continue
        spec = info.specs[0]
        rows = spec.shape[0] if spec.shape else 1
        if rows is not None and rows > buckets[-1]:
            diags.append(make(
                "NNL009",
                f"tensor_serving '{el.name}': declared input rows "
                f"({rows}) exceed the largest bucket ({buckets[-1]}) — "
                "every buffer pads to a multiple of the largest bucket",
                location=el.name,
                hint=f"add a bucket >= {rows} to bucket-sizes"))
    return diags


def _check_host_roundtrip(elements) -> List[Diagnostic]:
    """NNL010: a host-affinity element with a device element upstream AND
    downstream forces a device→host→device round trip per buffer."""
    affinity = {id(e): e.device_affinity() for e in elements}

    def reaches_device(el, step) -> Optional[str]:
        seen = set()
        stack = list(step(el))
        while stack:
            cur = stack.pop()
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            if affinity.get(id(cur)) == "device":
                return cur.name
            stack.extend(step(cur))
        return None

    diags = []
    for el in elements:
        if affinity[id(el)] != "host":
            continue
        up = reaches_device(el, _upstream)
        down = reaches_device(el, _downstream)
        if up and down:
            # name the fusion barrier: the element's own contract (see
            # runtime/fusion.py barrier_reason) says WHY the device chain
            # splits here, so the fix hint is actionable
            try:
                barrier = el.fusion_barrier() or "host-affinity element"
            except Exception:  # noqa: BLE001 - lint must not die on an element
                barrier = "host-affinity element"
            diags.append(make(
                "NNL010",
                f"host-only element '{el.name}' "
                f"({el.ELEMENT_NAME or type(el).__name__}) sits between "
                f"device elements '{up}' and '{down}' — each buffer "
                "makes a device→host→device round trip; fusion barrier: "
                f"{barrier} (splits the fused device segments around it)",
                location=el.name,
                hint="move host work before the first device stage or "
                     "after the last one"))
    return diags


def _check_fusion_plan(pipeline) -> List[Diagnostic]:
    """NNL013 (info): report the device-segment fusion plan — which
    linear runs collapse to one dispatch per buffer at play(). The
    planner is the SAME code the runtime uses (runtime/fusion.py), so
    what the linter reports is what play() installs."""
    from ..runtime.fusion import plan_segments

    if not getattr(pipeline, "fuse", True):
        # fusion disabled for this pipeline (fuse=False / NNS_NO_FUSE=1):
        # reporting a plan that play() will not install would be a lie
        return []
    try:
        plan = plan_segments(pipeline)
    except Exception:  # noqa: BLE001 - an info report must never fail lint
        return []
    diags = []
    for seg in plan.segments:
        names = " -> ".join(el.name for el in seg)
        diags.append(make(
            "NNL013",
            f"fused device segment: {names} ({len(seg)} elements, one "
            "dispatch per buffer)",
            location=seg[0].name,
            hint="disable with Pipeline(fuse=False) or NNS_NO_FUSE=1"))
    return diags


def _check_placement_hint(pipeline) -> List[Diagnostic]:
    """NNL014 (info): the pipeline has >= 2 device stages it leaves on
    default placement, AND the profile store already holds a matching
    artifact — the placement planner could balance those stages across
    chips from real measurements ("a better plan is available"). Info
    only: never gates, not even under --strict, and absent entirely when
    no store is configured (NNS_PROFILE_STORE unset) — the lint touches
    no device and opens no backend, same contract as every graph rule."""
    if getattr(pipeline, "place", None):
        return []  # placement is already on (or an explicit plan applies)
    try:
        from ..obs import profile as obs_profile
        from ..runtime.fusion import plan_segments
        from ..runtime.placement import Planner

        planner = Planner()
        if planner.store is None:
            return []
        stages = plan_segments(pipeline, min_run=1).segments
        if len(stages) < 2:
            return []  # a single stage has nothing to balance
        artifact = planner.artifact_for(pipeline)
    except Exception:  # noqa: BLE001 - an info hint must never fail lint
        return []
    if artifact is None:
        return []
    return [make(
        "NNL014",
        f"{len(stages)}-stage device pipeline runs with default placement "
        f"but the profile store holds a matching artifact "
        f"(topology {artifact.key.get('topology', '?')}) — a better plan "
        "is available",
        location=next(iter(pipeline.elements), ""),
        hint='enable with Pipeline(place="auto") / parse_launch(place='
             '"auto") or `launch --place auto`')]


def _check_aot_artifacts(pipeline) -> List[Diagnostic]:
    """NNL015 (info), sibling of NNL014: the AOT compile cache
    (``NNS_AOT_CACHE``) holds exported programs covering this topology —
    restarts and replica spawns load instead of tracing, and a
    shape-poly artifact serves every batch size. Info only: never gates,
    absent when no cache is configured, and reads meta files only — no
    device is touched and no backend opened."""
    try:
        from .. import aot
        from ..obs import profile as obs_profile

        cache = aot.default_cache()
        if cache is None:
            return []
        refs = cache.stage_artifacts(obs_profile.topology_hash(pipeline))
        if not refs:
            return []
        names = set(refs.values())
        entries = [e for e in cache.list()
                   if os.path.basename(e["path"]) in names]
    except Exception:  # noqa: BLE001 - an info hint must never fail lint
        return []
    n_poly = sum(1 for e in entries if e.get("poly"))
    return [make(
        "NNL015",
        f"AOT compile cache holds {len(refs)} artifact(s) covering this "
        f"topology ({n_poly} shape-poly — serving buckets covered by a "
        "single artifact per stage): restarts, hot-swap prepares, and "
        "replica spawns load instead of tracing",
        location=next(iter(pipeline.elements), ""),
        hint="inspect with `python -m nnstreamer_tpu_torch aot list`")]
