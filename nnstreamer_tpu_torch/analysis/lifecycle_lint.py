"""Pass 4: interprocedural resource-lifecycle & exception-path lint
(rules NNL3xx).

The codebase carries a dozen paired acquire/release protocols — the
memory-guard ``reserve``/``release``, the refcounted
``begin_calibration``/``end_calibration`` halves, live ``start_span``/
``Span.end`` spans, metrics ``track_*``/``untrack_*`` registrations,
``ThreadRegistry.track``/``drain``, ``subprocess.Popen`` handles, the
AOT writer lock, temp-file atomic publishes — and each of them is a
place a leak can hide. This pass makes the contract checkable the
same way pass 3 made lock discipline checkable:

* **NNL301** — a resource is acquired but NO matching release is
  reachable anywhere (function, owning class, or module).
* **NNL302** — the release exists but only on the normal path: an
  exception between acquire and release escapes without it (no
  ``finally``, no context manager, no release-and-reraise handler).
* **NNL303** — refcount imbalance: branches/loops/early returns of one
  function leave different net counts of a refcounted pair.
* **NNL304** — a ``subprocess.Popen`` stored with no
  poll/wait/kill/terminate/communicate path in the owning scope.
* **NNL305** — a temp-file + ``os.replace`` atomic publish with no
  failure-path cleanup of the temp file.
* **NNL306** — a registration (module-level ``WeakSet.add(self)``,
  ``track_pipeline(self)``-style scrape surfaces,
  ``ThreadRegistry.track``) with no unregister/drain on the stop path.

The paired-API registry is seeded two ways: built-in knowledge of the
repo's own pairs (below), and the ``# pairs-with: <release>`` annotation
convention — mirroring ``# guarded-by:`` — written on (or directly
above) an acquire function's ``def`` line::

    def begin_window():   # pairs-with: end_window
        ...

Every call to an annotated function then participates in the same
dataflow: release reachable on ALL paths, exception paths included.

Scoping mirrors the concurrency lint: whole files, ``self.method()`` /
module-``fn()`` calls resolved one level deep (a helper that releases
credits its caller; a helper that acquires debits it), the same
``# nnlint: disable=NNL3xx`` pragmas, and ``# nnlint: skip-file``
(generated scaffolds) excludes a file entirely. Ownership transfer is
respected: a resource returned, passed onward, or stored into another
object escapes the function and is the new owner's contract; a resource
stored on ``self`` shifts the obligation to the class (some method must
release it — the resource-ownership table in docs/lint.md).

The runtime twin is the ``NNS_LEAKCHECK=1`` ledger in
:mod:`.sanitizer`: the same pairs report acquire/release at runtime and
the test suite asserts zero outstanding units per test.

The port of nnstreamer_tpu's ``analysis/lifecycle_lint.py``: the same
rules, pairs and dataflow. The built-in pairs name the port's own
protocols (``obs/profile.py``'s calibration and recording halves,
``obs/memory.py``'s guard, ``obs/context.py``'s spans, ``obs/metrics.py``'s
track/untrack), which keep the reference's names.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, make
from .source_lint import (_collect_pragmas, _dotted, _suppressed,
                          skip_file)

# ---------------------------------------------------------------------------
# paired-API registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PairSpec:
    """One acquire/release protocol the dataflow tracks.

    ``receiver=True`` pairs are methods on a shared object (the key is
    the receiver expression, e.g. ``self.memory_guard``); ``False``
    pairs are module functions (the key is the call's dotted prefix).
    ``kind`` selects the analysis: ``refcount`` gets NNL303 path
    balance, ``handle`` gets plain reachability, ``span`` binds the
    release to the acquire's RESULT object (``s = start_span(); …
    s.end()``).
    """

    pid: str
    acquires: Tuple[str, ...]
    releases: Tuple[str, ...]
    kind: str                      # "refcount" | "handle" | "span"
    receiver: bool = False
    receiver_token: str = ""       # receiver text must contain this
    fix: str = ""                  # release spelling for fix_hint


_BUILTIN_PAIRS: Tuple[PairSpec, ...] = (
    PairSpec("calibration", ("begin_calibration",), ("end_calibration",),
             "refcount", fix="end_calibration()"),
    PairSpec("recording", ("enable_recording",), ("disable_recording",),
             "refcount", fix="disable_recording()"),
    PairSpec("reservation", ("reserve",), ("release",), "handle",
             receiver=True, receiver_token="guard", fix=".release(nbytes)"),
    PairSpec("span", ("start_span",), ("end",), "span", fix=".end(status)"),
)

# NNL306 registration pairs: call-with-self registration that demands a
# call-with-self unregistration somewhere in the same class
_REGISTRATION_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("track_pipeline", "untrack_pipeline"),
    ("track_manager", "untrack_manager"),
)

_PAIRS_WITH_RE = re.compile(r"#\s*pairs-with:\s*([A-Za-z_][A-Za-z0-9_]*)")

# NNL304 — reap evidence on a Popen handle
_REAP_METHODS = {"poll", "wait", "kill", "terminate", "communicate",
                 "send_signal"}

# NNL305 — cleanup evidence inside except/finally
_CLEANUP_CALLS = {"os.remove", "os.unlink", "shutil.rmtree", "unlink",
                  "remove", "rmtree"}

# calls assumed non-raising for NNL302's "risky statement" scan
_BENIGN_PREFIXES = ("logger.", "logging.", "log.")
_BENIGN_NAMES = {"print", "len", "isinstance", "getattr", "hasattr",
                 "round", "min", "max", "int", "float", "str", "bool",
                 "list", "dict", "tuple", "set", "id", "repr", "format"}


# ---------------------------------------------------------------------------
# module model
# ---------------------------------------------------------------------------

@dataclass
class _ClassInfo:
    name: str
    node: ast.ClassDef
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    registry_attrs: Set[str] = field(default_factory=set)   # ThreadRegistry
    popen_attrs: Dict[str, int] = field(default_factory=dict)  # attr -> line


@dataclass
class _ModuleInfo:
    path: Path
    display: str
    tree: ast.Module
    text: str
    lines: List[str]
    pragmas: Dict[int, Set[str]]
    comments: Set[int]
    classes: List[_ClassInfo] = field(default_factory=list)
    module_funcs: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    weaksets: Set[str] = field(default_factory=set)   # module-level names


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def lint_lifecycle(paths: Sequence, *, root: Optional[str] = None
                   ) -> List[Diagnostic]:
    """Lifecycle-lint Python sources (same path semantics as
    :func:`..source_lint.lint_source`)."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts))
        else:
            files.append(p)

    modules: List[_ModuleInfo] = []
    diags: List[Diagnostic] = []
    for f in files:
        try:
            text = f.read_text()
            if skip_file(text):
                continue
            tree = ast.parse(text, filename=str(f))
        except (OSError, SyntaxError, ValueError) as e:
            diags.append(make("NNL100", f"cannot lint {f}: {e}",
                              location=str(f)))
            continue
        display = str(f)
        if root:
            try:
                display = str(f.relative_to(root))
            except ValueError:
                pass
        pragmas, comments = _collect_pragmas(text)
        modules.append(_ModuleInfo(f, display, tree, text,
                                   text.splitlines(), pragmas, comments))

    pairs = list(_BUILTIN_PAIRS)
    for m in modules:
        _index_module(m)
        pairs.extend(_annotated_pairs(m))
    registry = _PairRegistry(pairs)

    for m in modules:
        raw = _lint_module(m, registry)
        diags.extend(d for d in raw
                     if not _suppressed(d, m.pragmas, m.comments))
    return diags


def _index_module(m: _ModuleInfo) -> None:
    for node in m.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(getattr(node, "value", None), ast.Call):
            d = _dotted(node.value.func)
            if d in ("weakref.WeakSet", "WeakSet"):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        m.weaksets.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m.module_funcs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            ci = _ClassInfo(node.name, node)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods[sub.name] = sub
            init = ci.methods.get("__init__")
            if init is not None:
                for stmt in ast.walk(init):
                    if not (isinstance(stmt, ast.Assign)
                            and isinstance(stmt.value, ast.Call)):
                        continue
                    d = _dotted(stmt.value.func)
                    for t in stmt.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        if d in ("ThreadRegistry", "threads.ThreadRegistry",
                                 "utils.threads.ThreadRegistry"):
                            ci.registry_attrs.add(attr)
            # Popen stored on self anywhere in the class
            for fn in ci.methods.values():
                for stmt in ast.walk(fn):
                    if (isinstance(stmt, ast.Assign)
                            and isinstance(stmt.value, ast.Call)
                            and _dotted(stmt.value.func)
                            in ("subprocess.Popen", "Popen")):
                        for t in stmt.targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                ci.popen_attrs.setdefault(attr, stmt.lineno)
            m.classes.append(ci)


def _annotated_pairs(m: _ModuleInfo) -> List[PairSpec]:
    """``# pairs-with: <release>`` on (or above) a ``def`` line registers
    a pair under the function's name — the annotation IS the contract,
    so the pair is global to the lint run. A module function becomes a
    refcount pair (``begin_x``/``end_x`` style); a METHOD becomes a
    receiver-matched handle pair (``obj.acquire``/``obj.release`` on the
    same receiver)."""
    out: List[PairSpec] = []

    def scan(fns: Dict[str, ast.FunctionDef], method: bool) -> None:
        for name, fn in fns.items():
            for ln in (fn.lineno, fn.lineno - 1):
                if 1 <= ln <= len(m.lines):
                    hit = _PAIRS_WITH_RE.search(m.lines[ln - 1])
                    if hit:
                        rel = hit.group(1)
                        if method:
                            out.append(PairSpec(
                                f"pairs-with:{name}", (name,), (rel,),
                                "handle", receiver=True,
                                fix=f".{rel}(...)"))
                        else:
                            out.append(PairSpec(
                                f"pairs-with:{name}", (name,), (rel,),
                                "refcount", fix=f"{rel}()"))
                        break

    scan(m.module_funcs, method=False)
    for ci in m.classes:
        scan(ci.methods, method=True)
    return out


class _PairRegistry:
    def __init__(self, pairs: Sequence[PairSpec]):
        self.pairs = list(pairs)
        self.by_acquire: Dict[str, List[PairSpec]] = {}
        self.by_release: Dict[str, List[PairSpec]] = {}
        for p in pairs:
            for a in p.acquires:
                self.by_acquire.setdefault(a, []).append(p)
            for r in p.releases:
                self.by_release.setdefault(r, []).append(p)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _self_attr(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _call_name(call: ast.Call) -> Tuple[str, str]:
    """(final name, dotted prefix) of a call: ``obs_profile.begin_x()``
    -> ("begin_x", "obs_profile"); ``begin_x()`` -> ("begin_x", "")."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr, _dotted(f.value)
    if isinstance(f, ast.Name):
        return f.id, ""
    return "", ""


def _is_benign_call(call: ast.Call) -> bool:
    d = _dotted(call.func)
    return d in _BENIGN_NAMES or d.startswith(_BENIGN_PREFIXES)


# ---------------------------------------------------------------------------
# per-function scan (flow-insensitive collection)
# ---------------------------------------------------------------------------

@dataclass
class _Acq:
    pair: PairSpec
    key: str
    line: int
    var: Optional[str] = None      # span result binding
    stored_attr: Optional[str] = None
    escaped: bool = False
    in_with: bool = False


@dataclass
class _FnFacts:
    acquires: List[_Acq] = field(default_factory=list)
    # (pair pid, key, line)
    releases: List[Tuple[str, str, int]] = field(default_factory=list)
    # self-method / module-fn call sites: (name, line, is_method)
    calls: List[Tuple[str, int, bool]] = field(default_factory=list)


def _receiver_key(expr: ast.expr, alias: Dict[str, str]) -> str:
    txt = _dotted(expr)
    head = txt.split(".", 1)[0]
    if head in alias:
        txt = alias[head] + txt[len(head):]
    return txt


def _scan_function(fn: ast.FunctionDef, reg: _PairRegistry) -> _FnFacts:
    facts = _FnFacts()
    alias: Dict[str, str] = {}      # local name -> canonical receiver text
    span_vars: Dict[str, _Acq] = {}  # local name -> span acquisition

    def handle_acquire(call: ast.Call, bound: Optional[ast.expr]) -> None:
        name, prefix = _call_name(call)
        for pair in reg.by_acquire.get(name, ()):
            if pair.receiver:
                if not isinstance(call.func, ast.Attribute):
                    continue
                key = _receiver_key(call.func.value, alias)
                if pair.receiver_token and pair.receiver_token not in key:
                    continue
            elif pair.kind == "span":
                key = f"span@{call.lineno}"
            else:
                key = f"{pair.pid}:{prefix}"
            acq = _Acq(pair, key, call.lineno)
            if bound is not None:
                attr = _self_attr(bound)
                if attr is not None:
                    acq.stored_attr = attr
                elif isinstance(bound, ast.Name):
                    acq.var = bound.id
                    if pair.kind == "span":
                        span_vars[bound.id] = acq
                else:
                    # stored into another object / subscript: ownership
                    # transferred (req._span = …, table[k] = …)
                    acq.escaped = True
            facts.acquires.append(acq)

    def handle_release(call: ast.Call) -> None:
        name, prefix = _call_name(call)
        for pair in reg.by_release.get(name, ()):
            if pair.receiver:
                if not isinstance(call.func, ast.Attribute):
                    continue
                key = _receiver_key(call.func.value, alias)
                if pair.receiver_token and pair.receiver_token not in key:
                    continue
                facts.releases.append((pair.pid, key, call.lineno))
            elif pair.kind == "span":
                # <var>.end() / self.<attr>.end() / <expr>.end()
                if not isinstance(call.func, ast.Attribute):
                    continue
                recv = call.func.value
                if isinstance(recv, ast.Name) and recv.id in span_vars:
                    facts.releases.append(
                        ("span", span_vars[recv.id].key, call.lineno))
                else:
                    facts.releases.append(
                        ("span", f"recv:{_receiver_key(recv, alias)}",
                         call.lineno))
            else:
                facts.releases.append(
                    (pair.pid, f"{pair.pid}:{prefix}", call.lineno))

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            v = node.value
            if isinstance(v, ast.Call):
                handle_acquire(v, t)
            if isinstance(t, ast.Name) and isinstance(
                    v, (ast.Attribute, ast.Name)):
                alias[t.id] = _receiver_key(v, alias)
        if isinstance(node, ast.Call):
            name, _pfx = _call_name(node)
            if name in reg.by_acquire:
                # bare-expression acquire (not the Assign case above)
                parent_bound = _assigned_value_of(fn, node)
                if parent_bound is None:
                    handle_acquire(node, None)
            if name in reg.by_release:
                handle_release(node)
            # one-level expansion targets
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                facts.calls.append((f.attr, node.lineno, True))
            elif isinstance(f, ast.Name):
                facts.calls.append((f.id, node.lineno, False))

    # escapes: a bound var returned / passed as argument / yielded /
    # stored anywhere else, and keys of receiver acquires whose value is
    # the function's return
    bound_vars = {a.var: a for a in facts.acquires if a.var}
    if bound_vars:
        for node in ast.walk(fn):
            names: List[str] = []
            if isinstance(node, (ast.Return, ast.Yield)) \
                    and node.value is not None:
                names = [n.id for n in ast.walk(node.value)
                         if isinstance(n, ast.Name)]
            elif isinstance(node, ast.Call):
                nm, _ = _call_name(node)
                is_release = any(nm in p.releases for p in reg.pairs)
                if not is_release:
                    for a in list(node.args) + [kw.value
                                                for kw in node.keywords]:
                        names.extend(n.id for n in ast.walk(a)
                                     if isinstance(n, ast.Name))
            elif isinstance(node, ast.Assign):
                t = node.targets[0] if len(node.targets) == 1 else None
                if not isinstance(t, ast.Name):
                    for n in ast.walk(node.value):
                        if isinstance(n, ast.Name):
                            names.append(n.id)
            for n in names:
                if n in bound_vars:
                    bound_vars[n].escaped = True
    return facts


def _assigned_value_of(fn: ast.FunctionDef,
                       call: ast.Call) -> Optional[ast.expr]:
    """The Assign target when ``call`` is the RHS of a single-target
    assignment (so the walk doesn't double-count it)."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and node.value is call):
            return node.targets[0]
    return None


# ---------------------------------------------------------------------------
# NNL302 — exception-path analysis (line-range based)
# ---------------------------------------------------------------------------

def _try_nodes(fn: ast.FunctionDef) -> List[ast.Try]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.Try)]


def _line_in(node: ast.stmt, line: int) -> bool:
    end = getattr(node, "end_lineno", node.lineno)
    return node.lineno <= line <= end


def _release_protected(fn: ast.FunctionDef, acq_line: int,
                       release_lines: List[int],
                       release_names: Set[str]) -> bool:
    """True when SOME matching release runs on the exception edge: a
    release inside a ``finally`` whose try covers the acquire-to-release
    region, or inside an ``except`` handler that re-raises."""
    for t in _try_nodes(fn):
        body_start = t.body[0].lineno
        body_end = getattr(t.body[-1], "end_lineno", t.body[-1].lineno)
        covers = body_start <= acq_line <= body_end or (
            acq_line < body_start
            and any(body_start <= r for r in release_lines))
        if not covers:
            continue
        for stmt in t.finalbody:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) \
                        and _call_name(sub)[0] in release_names:
                    return True
        for h in t.handlers:
            has_release = any(
                isinstance(sub, ast.Call)
                and _call_name(sub)[0] in release_names
                for stmt in h.body for sub in ast.walk(stmt))
            has_raise = any(isinstance(sub, ast.Raise)
                            for stmt in h.body for sub in ast.walk(stmt))
            if has_release and has_raise:
                return True
    return False


def _risky_between(fn: ast.FunctionDef, a: int, b: int,
                   release_names: Set[str]) -> Optional[int]:
    """First line in (a, b) containing a call that can plausibly raise
    (not logging, not the release itself)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if not a < node.lineno < b:
            continue
        name, _ = _call_name(node)
        if name in release_names or _is_benign_call(node):
            continue
        return node.lineno
    return None


# ---------------------------------------------------------------------------
# NNL303 — refcount path balance
# ---------------------------------------------------------------------------

def _refcount_path_findings(fn: ast.FunctionDef, m: _ModuleInfo,
                            keys: Dict[str, PairSpec],
                            summaries: Dict[Tuple[bool, str],
                                            Dict[str, int]],
                            reg: _PairRegistry) -> List[Diagnostic]:
    """Walk the function's statement tree tracking net counts for the
    given refcount keys; flag branch/loop/early-return imbalance."""
    diags: List[Diagnostic] = []
    exits: List[Tuple[int, Dict[str, int]]] = []   # (line, state at return)

    def call_delta(state: Dict[str, int], call: ast.Call) -> None:
        name, prefix = _call_name(call)
        for pair in reg.by_acquire.get(name, ()):
            if pair.receiver or pair.kind == "span":
                continue
            key = f"{pair.pid}:{prefix}"
            if key in keys:
                state[key] = state.get(key, 0) + 1
        for pair in reg.by_release.get(name, ()):
            if pair.receiver or pair.kind == "span":
                continue
            key = f"{pair.pid}:{prefix}"
            if key in keys:
                state[key] = max(0, state.get(key, 0) - 1)
        # one-level expansion: a called helper's net effect
        f = call.func
        tgt = None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self":
            tgt = summaries.get((True, f.attr))
        elif isinstance(f, ast.Name):
            tgt = summaries.get((False, f.id))
        if tgt:
            for key, net in tgt.items():
                if key in keys:
                    state[key] = max(0, state.get(key, 0) + net)

    def walk_expr(state: Dict[str, int], e: Optional[ast.expr]) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                call_delta(state, node)

    def walk(stmts: Sequence[ast.stmt],
             state: Dict[str, int]) -> Tuple[Dict[str, int], bool]:
        """Returns (state at fall-through, fell) — ``fell`` False when
        every path returned/raised."""
        for s in stmts:
            if isinstance(s, ast.Return):
                walk_expr(state, s.value)
                exits.append((s.lineno, dict(state)))
                return state, False
            if isinstance(s, ast.Raise):
                return state, False   # exception exits are NNL302's job
            if isinstance(s, ast.If):
                walk_expr(state, s.test)
                before = dict(state)
                sa, fa = walk(s.body, dict(state))
                sb, fb = walk(s.orelse, dict(state))
                if fa and fb and sa != sb:
                    # flag RELEASE asymmetry only: one branch released
                    # units the other kept. Acquire asymmetry
                    # (`if enabled: begin()`) is the normal conditional-
                    # activation idiom — the exit check still catches a
                    # path that never balances.
                    imbal = [
                        k for k in set(sa) | set(sb)
                        if sa.get(k, 0) != sb.get(k, 0)
                        and min(sa.get(k, 0), sb.get(k, 0))
                        < before.get(k, 0)]
                    if imbal:
                        key = imbal[0]
                        diags.append(make(
                            "NNL303",
                            f"refcount imbalance across branches in "
                            f"'{fn.name}': one path releases "
                            f"'{key.split(':')[0]}' "
                            f"({sa.get(key, 0)} vs {sb.get(key, 0)} "
                            "outstanding) and the other keeps it",
                            location=m.display, line=s.lineno,
                            hint="release the same number of units on "
                                 "every branch (or move the release to "
                                 "a finally)",
                            fix_hint=keys[key].fix))
                if fa and fb:
                    state = {k: max(sa.get(k, 0), sb.get(k, 0))
                             for k in set(sa) | set(sb)}
                elif fa:
                    state = sa
                elif fb:
                    state = sb
                else:
                    return state, False
            elif isinstance(s, (ast.For, ast.While)):
                if isinstance(s, ast.For):
                    walk_expr(state, s.iter)
                else:
                    walk_expr(state, s.test)
                before = dict(state)
                after, _fell = walk(s.body, dict(state))
                if after != before:
                    key = next(k for k in set(after) | set(before)
                               if after.get(k, 0) != before.get(k, 0))
                    diags.append(make(
                        "NNL303",
                        f"loop body in '{fn.name}' changes the "
                        f"'{key.split(':')[0]}' refcount net per "
                        "iteration — the count drifts with the trip "
                        "count",
                        location=m.display, line=s.lineno,
                        hint="balance acquire/release inside one "
                             "iteration",
                        fix_hint=keys[key].fix))
                    state = after
                walk(s.orelse, state)
            elif isinstance(s, ast.Try):
                state, fell = walk(s.body, state)
                for h in s.handlers:
                    hs, _ = walk(h.body, dict(state))
                    state = {k: max(state.get(k, 0), hs.get(k, 0))
                             for k in set(state) | set(hs)}
                state, _ = walk(s.orelse, state)
                state, ffell = walk(s.finalbody, state)
                if not fell:
                    return state, False
            elif isinstance(s, ast.With):
                for item in s.items:
                    walk_expr(state, item.context_expr)
                state, fell = walk(s.body, state)
                if not fell:
                    return state, False
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            else:
                for child in ast.iter_child_nodes(s):
                    if isinstance(child, ast.expr):
                        walk_expr(state, child)
                    elif isinstance(child, list):
                        pass
        return state, True

    final_state, fell = walk(fn.body, {k: 0 for k in keys})
    if fell:
        exits.append((getattr(fn, "end_lineno", fn.lineno),
                      dict(final_state)))
    # an early return holding MORE than some other exit skipped a release
    for key in keys:
        counts = [(ln, st.get(key, 0)) for ln, st in exits]
        if not counts:
            continue
        low = min(c for _, c in counts)
        for ln, c in counts:
            if c > low and (ln, c) != counts[-1]:
                diags.append(make(
                    "NNL303",
                    f"early return in '{fn.name}' exits with "
                    f"{c} outstanding '{key.split(':')[0]}' unit(s) "
                    f"while another path exits with {low}",
                    location=m.display, line=ln,
                    hint="release before the early return, or hoist the "
                         "release into a finally",
                    fix_hint=keys[key].fix))
                break
    return diags


# ---------------------------------------------------------------------------
# per-module pass
# ---------------------------------------------------------------------------

def _release_index(m: _ModuleInfo, reg: _PairRegistry
                   ) -> Dict[str, Set[str]]:
    """Module-wide release evidence: pair pid -> set of keys released
    anywhere in the module (class methods included) — the cross-method /
    cross-function credit for NNL301."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(m.tree):
        if not isinstance(node, ast.Call):
            continue
        name, prefix = _call_name(node)
        for pair in reg.by_release.get(name, ()):
            if pair.receiver:
                if isinstance(node.func, ast.Attribute):
                    out.setdefault(pair.pid, set()).add(
                        _dotted(node.func.value))
            elif pair.kind == "span":
                if isinstance(node.func, ast.Attribute):
                    out.setdefault("span", set()).add(
                        _dotted(node.func.value))
            else:
                out.setdefault(pair.pid, set()).add(
                    f"{pair.pid}:{prefix}")
                out.setdefault(pair.pid, set()).add(f"{pair.pid}:*")
    return out


def _fn_summaries(m: _ModuleInfo, reg: _PairRegistry
                  ) -> Dict[Tuple[bool, str], Dict[str, int]]:
    """(is_method, name) -> net refcount effect per key, for one-level
    call expansion. Methods of ALL classes share the name space the
    caller resolves against its own class — collisions are acceptable
    lint noise, not correctness."""
    out: Dict[Tuple[bool, str], Dict[str, int]] = {}

    def net(fn: ast.FunctionDef) -> Dict[str, int]:
        eff: Dict[str, int] = {}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name, prefix = _call_name(node)
            for pair in reg.by_acquire.get(name, ()):
                if not pair.receiver and pair.kind != "span":
                    k = f"{pair.pid}:{prefix}"
                    eff[k] = eff.get(k, 0) + 1
            for pair in reg.by_release.get(name, ()):
                if not pair.receiver and pair.kind != "span":
                    k = f"{pair.pid}:{prefix}"
                    eff[k] = eff.get(k, 0) - 1
        return {k: v for k, v in eff.items() if v}

    for name, fn in m.module_funcs.items():
        s = net(fn)
        if s:
            out[(False, name)] = s
    for ci in m.classes:
        for name, fn in ci.methods.items():
            s = net(fn)
            if s:
                out[(True, name)] = s
    return out


def _lint_module(m: _ModuleInfo, reg: _PairRegistry) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    released = _release_index(m, reg)
    summaries = _fn_summaries(m, reg)

    def functions():
        for name, fn in m.module_funcs.items():
            yield None, name, fn
        for ci in m.classes:
            for name, fn in ci.methods.items():
                yield ci, name, fn

    for ci, name, fn in functions():
        facts = _scan_function(fn, reg)
        diags.extend(_check_function(m, ci, name, fn, facts, released,
                                     summaries, reg))
        diags.extend(_check_atomic_write(m, fn))

    for ci in m.classes:
        diags.extend(_check_class(m, ci, reg))
    diags.extend(_check_weaksets(m))
    return diags


def _class_release_evidence(ci: _ClassInfo, release_names: Set[str]
                            ) -> Tuple[Set[str], Set[str],
                                       Set[str], Set[str]]:
    """(release call names seen, receiver texts a RELEASE is called on,
    attrs with ``.end()`` called, attrs with reap/drain methods called)
    across the whole class — including via simple ``x = self.attr``
    aliases. Only release-named calls contribute receiver evidence (the
    acquire's own receiver must never credit itself)."""
    names: Set[str] = set()
    receivers: Set[str] = set()
    ended_attrs: Set[str] = set()
    reaped_attrs: Set[str] = set()
    for fn in ci.methods.values():
        alias: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                attr = _self_attr(node.value)
                if attr is not None:
                    alias[node.targets[0].id] = attr
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            nm, _ = _call_name(node)
            names.add(nm)
            if isinstance(node.func, ast.Attribute):
                recv = node.func.value
                if nm in release_names:
                    receivers.add(_dotted(recv))
                attr = _self_attr(recv)
                if attr is None and isinstance(recv, ast.Name):
                    attr = alias.get(recv.id)
                if attr is not None:
                    if nm == "end":
                        ended_attrs.add(attr)
                    if nm in _REAP_METHODS or nm == "drain":
                        reaped_attrs.add(attr)
    return names, receivers, ended_attrs, reaped_attrs


def _check_function(m: _ModuleInfo, ci: Optional[_ClassInfo], fname: str,
                    fn: ast.FunctionDef, facts: _FnFacts,
                    released: Dict[str, Set[str]],
                    summaries: Dict[Tuple[bool, str], Dict[str, int]],
                    reg: _PairRegistry) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    all_release_names = set(reg.by_release)
    if ci is not None:
        cls_names, cls_recv, cls_ended, _ = _class_release_evidence(
            ci, all_release_names)
    else:
        cls_names, cls_recv, cls_ended = set(), set(), set()

    # helper-released keys via one-level expansion: the helper's call
    # NAME counts as a release spelling for protection analysis (a
    # finally calling self._close() that releases IS an exception-safe
    # release)
    helper_released: Set[str] = set()
    helper_release_lines: Dict[str, List[int]] = {}
    helper_release_names: Dict[str, Set[str]] = {}
    for cname, line, is_method in facts.calls:
        s = summaries.get((is_method, cname))
        if s:
            for key, netv in s.items():
                if netv < 0:
                    helper_released.add(key)
                    helper_release_lines.setdefault(key, []).append(line)
                    helper_release_names.setdefault(key, set()).add(cname)

    released_keys_in_fn: Dict[str, List[int]] = {}
    for pid, key, line in facts.releases:
        released_keys_in_fn.setdefault(key, []).append(line)
    for key, lines in helper_release_lines.items():
        released_keys_in_fn.setdefault(key, []).extend(lines)

    refcount_keys: Dict[str, PairSpec] = {}

    for acq in facts.acquires:
        if acq.escaped or acq.in_with:
            continue
        pair = acq.pair
        rel_lines = released_keys_in_fn.get(acq.key, [])
        if pair.kind == "span" and not rel_lines:
            # a span bound to self.X: class-wide .end() evidence
            if acq.stored_attr is not None:
                if acq.stored_attr in cls_ended:
                    continue
                owner = f"class {ci.name}" if ci else "this module"
                diags.append(make(
                    "NNL301",
                    f"span stored in 'self.{acq.stored_attr}' in "
                    f"'{fname}' is never ended anywhere in {owner}",
                    location=m.display, line=acq.line,
                    hint="call .end(status) on every terminal path "
                         "(stop/close/error)",
                    fix_hint=f"self.{acq.stored_attr}.end(...)"))
                continue
            if acq.var is None:
                diags.append(make(
                    "NNL301",
                    f"span started in '{fname}' is discarded without "
                    "being bound or ended — it can never be closed",
                    location=m.display, line=acq.line,
                    hint="bind it and .end() it, or use record_span for "
                         "post-hoc emission", fix_hint=".end(status)"))
                continue
            diags.append(make(
                "NNL301",
                f"span '{acq.var}' started in '{fname}' has no "
                ".end() on any path (and never escapes the function)",
                location=m.display, line=acq.line,
                hint="end it in a finally, or hand it off",
                fix_hint=f"{acq.var}.end(status)"))
            continue
        if pair.kind != "span" and not rel_lines:
            # cross-method / cross-function protocol: credit when the
            # class (receiver pairs) or module (function pairs) releases
            if pair.receiver:
                ok = (acq.key in cls_recv
                      or any(acq.key.endswith(r) or r.endswith(acq.key)
                             for r in released.get(pair.pid, ())))
            else:
                ok = (acq.key in released.get(pair.pid, ())
                      or any(r in cls_names for r in pair.releases)
                      or f"{pair.pid}:*" in released.get(pair.pid, ()))
            if not ok:
                rel = pair.releases[0]
                where = f"class {ci.name}" if ci else "this module"
                diags.append(make(
                    "NNL301",
                    f"'{pair.acquires[0]}' acquired in '{fname}' has no "
                    f"matching '{rel}' anywhere in {where}",
                    location=m.display, line=acq.line,
                    hint=f"pair every {pair.acquires[0]} with a "
                         f"{rel} on a reachable stop/cleanup path",
                    fix_hint=pair.fix or f"{rel}()"))
            continue
        # release exists in THIS function: exception-path + balance
        rel_names = set(pair.releases)
        if pair.kind == "span":
            rel_names = {"end"}
        rel_names |= helper_release_names.get(acq.key, set())
        last_rel = max(rel_lines)
        if not _release_protected(fn, acq.line, rel_lines, rel_names):
            risky = _risky_between(fn, acq.line, last_rel, rel_names)
            if risky is not None:
                rel = pair.releases[0]
                diags.append(make(
                    "NNL302",
                    f"'{pair.acquires[0]}' at line {acq.line} in "
                    f"'{fname}' is released only on the normal path — "
                    f"an exception at line {risky} escapes holding the "
                    "resource",
                    location=m.display, line=acq.line,
                    hint="wrap the region in try/finally (or release "
                         "and re-raise in the handler)",
                    fix_hint=f"finally: {pair.fix or rel + '()'}"))
        if pair.kind == "refcount":
            refcount_keys[acq.key] = pair

    if refcount_keys:
        diags.extend(_refcount_path_findings(fn, m, refcount_keys,
                                             summaries, reg))
    return diags


# ---------------------------------------------------------------------------
# NNL304 / NNL306 — class-level lifecycle shape
# ---------------------------------------------------------------------------

def _check_class(m: _ModuleInfo, ci: _ClassInfo,
                 reg: _PairRegistry) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    names, receivers, _ended, reaped = _class_release_evidence(
        ci, set(reg.by_release))

    # NNL304 — stored Popen without a reap path
    for attr, line in ci.popen_attrs.items():
        if attr not in reaped:
            diags.append(make(
                "NNL304",
                f"'self.{attr}' holds a subprocess.Popen but class "
                f"{ci.name} never calls poll/wait/kill/terminate on it "
                "— the child is never reaped or stopped",
                location=m.display, line=line,
                hint="add a stop/close path that terminates and waits "
                     "the process",
                fix_hint=f"self.{attr}.terminate(); self.{attr}.wait()"))

    # NNL306 — ThreadRegistry tracked but never drained
    for attr in ci.registry_attrs:
        tracks = any(
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "track"
            and _self_attr(node.func.value) == attr
            for fn in ci.methods.values() for node in ast.walk(fn))
        if tracks and attr not in reaped:
            line = next(
                (node.lineno for fn in ci.methods.values()
                 for node in ast.walk(fn)
                 if isinstance(node, ast.Call)
                 and isinstance(node.func, ast.Attribute)
                 and node.func.attr == "track"
                 and _self_attr(node.func.value) == attr),
                ci.node.lineno)
            diags.append(make(
                "NNL306",
                f"'self.{attr}' (ThreadRegistry) tracks threads but "
                f"class {ci.name} never drains it — stop() cannot join "
                "the workers",
                location=m.display, line=line,
                hint="call .drain() on the stop/close path",
                fix_hint=f"self.{attr}.drain()"))

    # NNL306 — track_*(self) registration without untrack_*(self)
    for track, untrack in _REGISTRATION_PAIRS:
        for fn in ci.methods.values():
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and _call_name(node)[0] == track):
                    continue
                if not any(isinstance(a, ast.Name) and a.id == "self"
                           for a in node.args):
                    continue   # registering a foreign object: its owner's
                    # stop path carries the unregister contract
                if untrack in names:
                    continue
                diags.append(make(
                    "NNL306",
                    f"class {ci.name} registers itself via {track}(self) "
                    f"but never calls {untrack}(self) — the scrape keeps "
                    "publishing a stopped instance",
                    location=m.display, line=node.lineno,
                    hint=f"call {untrack}(self) on the stop path "
                         "(PR-10 unregister-at-stop stance)",
                    fix_hint=f"{untrack}(self)"))
    return diags


def _check_weaksets(m: _ModuleInfo) -> List[Diagnostic]:
    """Module-level WeakSet: ``X.add(self)`` demands ``X.discard(self)``
    (or .remove) somewhere in the module."""
    diags: List[Diagnostic] = []
    if not m.weaksets:
        return diags
    added: Dict[str, int] = {}
    removed: Set[str] = set()
    for node in ast.walk(m.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in m.weaksets):
            continue
        ws = node.func.value.id
        self_arg = any(isinstance(a, ast.Name) and a.id == "self"
                       for a in node.args)
        if node.func.attr == "add" and self_arg:
            added.setdefault(ws, node.lineno)
        elif node.func.attr in ("discard", "remove"):
            removed.add(ws)
    for ws, line in added.items():
        if ws not in removed:
            diags.append(make(
                "NNL306",
                f"module weakset '{ws}' gains self-registrations but is "
                "never discarded from — instances stay on the scrape "
                "surface after stop, until GC",
                location=m.display, line=line,
                hint=f"{ws}.discard(self) on the stop path "
                     "(re-add on start)",
                fix_hint=f"{ws}.discard(self)"))
    return diags


# ---------------------------------------------------------------------------
# NNL305 — atomic write without failure-path cleanup
# ---------------------------------------------------------------------------

def _check_atomic_write(m: _ModuleInfo, fn: ast.FunctionDef
                        ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    # temp names: assigned from an expression whose constants mention
    # ".tmp" (f-strings/concats) or from mkstemp/NamedTemporaryFile
    tmp_vars: Dict[str, int] = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        is_tmp = False
        for sub in ast.walk(v):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                    and ".tmp" in sub.value:
                is_tmp = True
            if isinstance(sub, ast.Call) and _call_name(sub)[0] in (
                    "mkstemp", "NamedTemporaryFile", "mkdtemp"):
                is_tmp = True
        if is_tmp:
            tmp_vars[node.targets[0].id] = node.lineno
    if not tmp_vars:
        return diags

    published: Dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _dotted(node.func) in (
                "os.replace", "os.rename", "shutil.move"):
            if node.args and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in tmp_vars:
                published[node.args[0].id] = node.lineno
    if not published:
        return diags

    # cleanup evidence: an except handler / finally block that BOTH
    # calls remove/unlink/rmtree AND mentions the tmp var — block-level,
    # so `for stranded in (tmp, mtmp): os.remove(stranded)` counts
    cleaned: Set[str] = set()
    for t in _try_nodes(fn):
        for blk in [h.body for h in t.handlers] + [t.finalbody]:
            has_cleanup = False
            mentioned: Set[str] = set()
            for stmt in blk:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        d = _dotted(sub.func)
                        nm = _call_name(sub)[0]
                        if d in _CLEANUP_CALLS or nm in (
                                "unlink", "remove", "rmtree"):
                            has_cleanup = True
                    if isinstance(sub, ast.Name) and sub.id in tmp_vars:
                        mentioned.add(sub.id)
            if has_cleanup:
                cleaned |= mentioned
    for var, line in published.items():
        if var not in cleaned:
            diags.append(make(
                "NNL305",
                f"atomic publish of temp file '{var}' in '{fn.name}' "
                "has no failure-path cleanup — an exception before "
                f"os.replace strands '{var}' on disk",
                location=m.display, line=tmp_vars[var],
                hint="wrap write+replace in try/except that removes the "
                     "temp file and re-raises (or finally-unlink with "
                     "missing_ok)",
                fix_hint=f"except: os.remove({var}); raise"))
    return diags
