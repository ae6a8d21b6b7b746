"""Pass 3: concurrency lint of the threaded control plane (rules NNL2xx).

The service/serving/runtime layers are a dozen cooperating threads
(queue workers, source tasks, scheduler loops, the health monitor,
supervisor timers, the HTTP control plane) synchronized with ad-hoc
locks. The failure modes that only surface under production load —
lock-order deadlocks, torn reads in the swap/drain/restart paths,
shutdown hangs — are exactly what a static pass can pin down before
traffic does. Five rules:

* **NNL201** — lock-order inversion: every function's lock-acquisition
  nesting contributes edges to one global lock-order graph (lock
  identity = ``Class.attr`` / ``module.name``); a cycle means two code
  paths acquire the same pair of locks in opposite orders.
* **NNL202** — unguarded shared state: an attribute annotated
  ``# guarded-by: <lock>`` on its ``__init__`` line (the contract
  convention for service/serving/runtime classes) written without that
  lock held, or an un-annotated attribute written both under and
  outside a lock in non-init methods.
* **NNL203** — blocking call while a lock is held: sleep, subprocess,
  socket ops, indefinite ``.get()``/``.wait()``/``.join()``/
  ``.result()``, ``block_until_ready`` and its torch counterparts
  (``torch.cuda.synchronize``, a stream's or event's ``.synchronize()``)
  inside a ``with lock:`` body.
* **NNL204** — ``Condition.wait`` outside a ``while`` predicate loop
  (spurious wakeups and stolen notifications are real).
* **NNL205** — a thread started with no join path in its owning class
  (or fire-and-forget): shutdown leaks it.

Scoping mirrors the source lint: the pass walks whole files, resolves
``self.method()`` / module-``fn()`` calls one level deep (a helper
called with a lock held inherits the held set), and honours the same
``# nnlint: disable=`` pragmas. A Condition constructed over an
existing lock (``threading.Condition(self._lock)``) aliases that lock —
holding the condition IS holding the lock.

The port of nnstreamer_tpu's ``analysis/concurrency_lint.py``: the rules
are spelling-independent and carry over as they are.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, make
from .source_lint import _collect_pragmas, _dotted, _suppressed, skip_file

# lock factory spellings: raw threading primitives and the sanitizer's
# named factories (analysis/sanitizer.py) — the latter is what the
# control plane adopts so tsan-lite can observe the same locks at runtime
_LOCK_CTORS = {
    "threading.Lock": "lock", "Lock": "lock",
    "named_lock": "lock", "sanitizer.named_lock": "lock",
    "threading.RLock": "rlock", "RLock": "rlock",
    "named_rlock": "rlock", "sanitizer.named_rlock": "rlock",
    "threading.Condition": "cond", "Condition": "cond",
    "named_condition": "cond", "sanitizer.named_condition": "cond",
}

_THREAD_CTORS = {"threading.Thread", "threading.Timer"}
# bare Thread/Timer only count when imported from threading (a project
# class named Timer — e.g. a stats context manager — must not match)
_THREAD_BARE = {"Thread", "Timer"}

# NNL203 — calls that can block for unbounded/long time
_BLOCKING_DOTTED = {
    "time.sleep", "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "urllib.request.urlopen", "socket.create_connection",
    "requests.get", "requests.post", "torch.cuda.synchronize",
}
_BLOCKING_METHODS = {"accept", "recv", "recvfrom", "sendall",
                     "block_until_ready", "synchronize"}
# methods that block indefinitely when called with NO arguments
_BLOCKING_IF_BARE = {"get", "join", "result", "wait", "acquire"}

# NNL202 — receiver-mutating methods counted as writes
_MUTATORS = {"append", "extend", "add", "remove", "pop", "popleft",
             "appendleft", "clear", "update", "discard", "insert"}

_GUARDED_BY_TOKEN = "guarded-by:"


@dataclass(frozen=True)
class _LockId:
    key: str    # "Class.attr" or "module.name" — the graph node
    kind: str   # lock | rlock | cond


@dataclass
class _ClassInfo:
    name: str
    node: ast.ClassDef
    lock_attrs: Dict[str, str] = field(default_factory=dict)   # attr -> kind
    cond_alias: Dict[str, str] = field(default_factory=dict)   # cond -> lock
    guarded: Dict[str, str] = field(default_factory=dict)      # attr -> lock
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    joined_attrs: Set[str] = field(default_factory=set)

    def canon(self, attr: str) -> str:
        return self.cond_alias.get(attr, attr)

    def lock_id(self, attr: str) -> Optional[_LockId]:
        if attr not in self.lock_attrs:
            return None
        canon = self.canon(attr)
        kind = self.lock_attrs.get(canon, self.lock_attrs[attr])
        return _LockId(f"{self.name}.{canon}", kind)


@dataclass
class _ModuleInfo:
    path: Path
    display: str
    tree: ast.Module
    text: str
    pragmas: Dict[int, Set[str]]
    comments: Set[int]
    stem: str
    classes: List[_ClassInfo] = field(default_factory=list)
    module_locks: Dict[str, str] = field(default_factory=dict)
    module_funcs: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    thread_subclasses: Set[str] = field(default_factory=set)
    threading_imports: Set[str] = field(default_factory=set)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def lint_concurrency(paths: Sequence, *, root: Optional[str] = None
                     ) -> List[Diagnostic]:
    """Concurrency-lint Python sources (same path semantics as
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
        stem = f.parent.name if f.stem == "__init__" else f.stem
        modules.append(_ModuleInfo(f, display, tree, text, pragmas,
                                   comments, stem))

    thread_classes = set(_THREAD_CTORS)
    for m in modules:
        _index_module(m)
        thread_classes |= m.thread_subclasses

    edges: Dict[Tuple[str, str], List[str]] = {}
    for m in modules:
        raw = _lint_module(m, thread_classes | m.threading_imports, edges)
        diags.extend(d for d in raw
                     if not _suppressed(d, m.pragmas, m.comments))
    diags.extend(_order_cycles(edges))
    return diags


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _is_thread_base(base: ast.expr) -> bool:
    return _dotted(base) in ("threading.Thread", "Thread")


def _lock_ctor_kind(value: ast.expr) -> Optional[str]:
    if isinstance(value, ast.Call):
        return _LOCK_CTORS.get(_dotted(value.func))
    return None


def _cond_underlying(call: ast.Call) -> Optional[str]:
    """The lock attr a Condition is built over: positional arg or the
    named factory's ``lock=`` keyword — ``self.X`` only."""
    candidates = list(call.args)
    candidates += [kw.value for kw in call.keywords if kw.arg == "lock"]
    for a in candidates:
        if (isinstance(a, ast.Attribute) and isinstance(a.value, ast.Name)
                and a.value.id == "self"):
            return a.attr
    return None


def _guarded_decl(line_text: str) -> Optional[str]:
    if _GUARDED_BY_TOKEN not in line_text:
        return None
    tail = line_text.split(_GUARDED_BY_TOKEN, 1)[1].strip()
    name = tail.split()[0].rstrip(",;") if tail else ""
    return name or None


def _index_module(m: _ModuleInfo) -> None:
    lines = m.text.splitlines()
    for node in m.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module == "threading":
            m.threading_imports |= {a.name for a in node.names
                                    if a.name in _THREAD_BARE}
        if isinstance(node, ast.Assign):
            kind = _lock_ctor_kind(node.value)
            if kind:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        m.module_locks[t.id] = kind
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m.module_funcs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            ci = _ClassInfo(node.name, node)
            if any(_is_thread_base(b) for b in node.bases):
                m.thread_subclasses.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods[sub.name] = sub
                elif isinstance(sub, ast.Assign):
                    kind = _lock_ctor_kind(sub.value)
                    if kind:
                        for t in sub.targets:
                            if isinstance(t, ast.Name):
                                ci.lock_attrs[t.id] = kind
            init = ci.methods.get("__init__")
            if init is not None:
                for stmt in ast.walk(init):
                    if isinstance(stmt, ast.Assign):
                        raw_targets = stmt.targets
                    elif isinstance(stmt, ast.AnnAssign) \
                            and stmt.value is not None:
                        raw_targets = [stmt.target]
                    else:
                        continue
                    targets = [t for t in raw_targets
                               if isinstance(t, ast.Attribute)
                               and isinstance(t.value, ast.Name)
                               and t.value.id == "self"]
                    if not targets:
                        continue
                    kind = _lock_ctor_kind(stmt.value)
                    for t in targets:
                        if kind:
                            ci.lock_attrs[t.attr] = kind
                            if kind == "cond":
                                under = _cond_underlying(stmt.value)
                                if under:
                                    ci.cond_alias[t.attr] = under
                        elif stmt.lineno <= len(lines):
                            guard = _guarded_decl(lines[stmt.lineno - 1])
                            if guard:
                                ci.guarded[t.attr] = guard
            ci.joined_attrs = _collect_joined_attrs(ci)
            m.classes.append(ci)


def _self_attr(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _collect_joined_attrs(ci: _ClassInfo) -> Set[str]:
    """Attrs X for which ``self.X.join(...)`` is reachable somewhere in
    the class, directly or through a simple local alias (``t = self.X``,
    ``t, self.X = self.X, None``, ``for t in (self.X, self.Y)``) — the
    NNL205 "has a join path" evidence."""
    joined: Set[str] = set()
    # self.A = self.B anywhere in the class: joining A is evidence for B
    # (a fired Timer kept joinable under a second attr)
    attr_alias: Dict[str, Set[str]] = {}
    for fn in ci.methods.values():
        alias: Dict[str, Set[str]] = {}

        def bind(var: ast.expr, src: ast.expr) -> None:
            attrs: Set[str] = set()
            for sub in ast.walk(src):
                attr = _self_attr(sub)
                if attr:
                    attrs.add(attr)
                elif isinstance(sub, ast.Name) and sub.id in alias:
                    # local-to-local flow: `for t in swapped` inherits
                    # what `swapped` aliased (the tuple-swap idiom)
                    attrs |= alias[sub.id]
            if not attrs:
                return
            if isinstance(var, ast.Name):
                alias.setdefault(var.id, set()).update(attrs)
            else:
                tattr = _self_attr(var)
                if tattr:
                    attr_alias.setdefault(tattr, set()).update(attrs)

        # alias collection first, iterated: ast.walk is breadth-first, so
        # a `for t in swapped:` node is visited BEFORE the nested assign
        # that defines `swapped` — one more sweep settles the chain
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Tuple) \
                                and isinstance(node.value, ast.Tuple) \
                                and len(t.elts) == len(node.value.elts):
                            for te, ve in zip(t.elts, node.value.elts):
                                bind(te, ve)
                        else:
                            bind(t, node.value)
                elif isinstance(node, ast.For):
                    bind(node.target, node.iter)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "join":
                recv = node.func.value
                attr = _self_attr(recv)
                if attr:
                    joined.add(attr)
                elif isinstance(recv, ast.Name) and recv.id in alias:
                    joined |= alias[recv.id]
    for tattr, sources in attr_alias.items():
        if tattr in joined:
            joined |= sources
    return joined


# ---------------------------------------------------------------------------
# per-module analysis
# ---------------------------------------------------------------------------

@dataclass
class _WriteSite:
    attr: str
    held: Tuple[str, ...]
    line: int
    fn: str


class _Walker:
    """Walks one function with a held-lock stack, recording lock-order
    edges, blocking-under-lock calls, wait-predicate shape, shared-state
    writes, and thread creations. ``expand=True`` marks a one-level call
    expansion (edges/blocking/writes only — no NNL204/205 duplicates)."""

    def __init__(self, module: _ModuleInfo, cls: Optional[_ClassInfo],
                 thread_classes: Set[str],
                 edges: Dict[Tuple[str, str], List[str]],
                 diags: List[Diagnostic],
                 writes: List[_WriteSite]):
        self.m = module
        self.cls = cls
        self.thread_classes = thread_classes
        self.edges = edges
        self.diags = diags
        self.writes = writes
        self.held: List[_LockId] = []
        self.while_depth = 0
        self.expand = False
        self.fn_name = ""
        self._expanded: Set[int] = set()
        self._seen: Set[Tuple[str, int, str]] = set()
        # sweep-1 mode: record intra-class call sites + held sets, skip
        # every rule except acquire/release tracking
        self.collect_calls: Optional[Dict[str, List[Tuple[str, ...]]]] = None

    # -- lock resolution -----------------------------------------------------
    def _resolve(self, expr: ast.expr) -> Optional[_LockId]:
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)):
            owner = expr.value.id
            if owner == "self" and self.cls is not None:
                return self.cls.lock_id(expr.attr)
            if self.cls is not None and owner == self.cls.name:
                return self.cls.lock_id(expr.attr)
        elif isinstance(expr, ast.Name) and expr.id in self.m.module_locks:
            return _LockId(f"{self.m.stem}.{expr.id}",
                           self.m.module_locks[expr.id])
        return None

    def _emit(self, rule: str, msg: str, line: int, hint: str = "") -> None:
        key = (rule, line, msg)
        if key in self._seen:
            return
        self._seen.add(key)
        self.diags.append(make(rule, msg, location=self.m.display,
                               line=line, hint=hint))

    # -- function entry ------------------------------------------------------
    def walk_function(self, fn: ast.FunctionDef, fn_name: str,
                      entry_held: Sequence[_LockId] = (),
                      expand: bool = False) -> None:
        prev = (self.held, self.while_depth, self.expand, self.fn_name)
        self.held = list(entry_held)
        self.while_depth = 0
        self.expand = expand
        self.fn_name = fn_name
        self._walk_body(fn.body)
        self.held, self.while_depth, self.expand, self.fn_name = prev

    # -- statements ----------------------------------------------------------
    def _walk_body(self, stmts: Sequence[ast.stmt]) -> None:
        for s in stmts:
            self._walk_stmt(s)

    def _acquire(self, lock: _LockId, line: int) -> bool:
        """Track an acquisition; returns False when the lock was already
        held (reentrant) so the caller must NOT release it at with-exit —
        popping the outer hold would analyze the rest of the caller's
        critical section as lock-free."""
        held_keys = [h.key for h in self.held]
        if lock.key in held_keys:
            if lock.kind == "lock":
                self._emit(
                    "NNL201",
                    f"non-reentrant lock '{lock.key}' acquired while "
                    f"already held in '{self.fn_name}' — self-deadlock",
                    line, hint="use an RLock or restructure the call path")
            return False  # reentrant: no new edge, no new hold
        if self.held:
            edge = (self.held[-1].key, lock.key)
            rules = self.m.pragmas.get(line, set())
            if not ("NNL201" in rules or "all" in rules):
                self.edges.setdefault(edge, []).append(
                    f"{self.m.display}:{line} ({self.fn_name})")
        self.held.append(lock)
        return True

    def _release(self, lock: _LockId) -> None:
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i].key == lock.key:
                del self.held[i]
                return

    def _walk_stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in s.items:
                lock = self._resolve(item.context_expr)
                if lock is not None:
                    if self._acquire(lock, s.lineno):
                        acquired.append(lock)
                else:
                    self._visit_expr(item.context_expr)
            self._walk_body(s.body)
            for lock in acquired:
                self._release(lock)
        elif isinstance(s, ast.While):
            self._visit_expr(s.test)
            self.while_depth += 1
            self._walk_body(s.body)
            self.while_depth -= 1
            self._walk_body(s.orelse)
        elif isinstance(s, ast.For):
            self._visit_expr(s.iter)
            self._walk_body(s.body)
            self._walk_body(s.orelse)
        elif isinstance(s, ast.If):
            self._visit_expr(s.test)
            self._walk_body(s.body)
            self._walk_body(s.orelse)
        elif isinstance(s, ast.Try):
            self._walk_body(s.body)
            for h in s.handlers:
                self._walk_body(h.body)
            self._walk_body(s.orelse)
            self._walk_body(s.finalbody)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass  # nested defs run later, not here
        elif isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._record_write_targets(s)
            if s.value is not None:
                self._visit_expr(s.value)
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.expr):
                    self._visit_expr(child)

    def _record_write_targets(self, s: ast.stmt) -> None:
        targets = []
        if isinstance(s, ast.Assign):
            targets = s.targets
        elif isinstance(s, (ast.AugAssign, ast.AnnAssign)):
            targets = [s.target]
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self" and self.cls is not None
                    and self.fn_name != "__init__"):
                self.writes.append(_WriteSite(
                    t.attr, tuple(h.key for h in self.held), s.lineno,
                    self.fn_name))

    # -- expressions ---------------------------------------------------------
    def _visit_expr(self, e: Optional[ast.expr]) -> None:
        if e is None:
            return
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                self._visit_call(node)

    def _visit_call(self, call: ast.Call) -> None:
        f = call.func
        dotted = _dotted(f)
        method = f.attr if isinstance(f, ast.Attribute) else None

        # acquire()/release() outside a with
        if method in ("acquire", "release") and isinstance(f, ast.Attribute):
            lock = self._resolve(f.value)
            if lock is not None:
                if method == "acquire":
                    self._acquire(lock, call.lineno)
                else:
                    self._release(lock)
                return

        if self.collect_calls is not None:
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and self.cls is not None
                    and f.attr in self.cls.methods):
                self.collect_calls.setdefault(f.attr, []).append(
                    tuple(h.key for h in self.held))
            return

        # NNL202 — mutating method on a self attribute
        if (method in _MUTATORS and isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Attribute)
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "self" and self.cls is not None
                and self.fn_name != "__init__"):
            self.writes.append(_WriteSite(
                f.value.attr, tuple(h.key for h in self.held),
                call.lineno, self.fn_name))

        # NNL204 — Condition.wait outside a while predicate loop
        if (method == "wait" and not self.expand
                and isinstance(f, ast.Attribute)):
            recv = self._resolve(f.value)
            if recv is not None and recv.kind == "cond" \
                    and self.while_depth == 0:
                self._emit(
                    "NNL204",
                    f"Condition.wait on '{recv.key}' in '{self.fn_name}' "
                    "is not inside a while predicate loop",
                    call.lineno,
                    hint="spurious wakeups happen: 'while not pred: "
                         "cond.wait(timeout)'")

        # NNL203 — blocking call while a lock is held
        if self.held:
            self._check_blocking(call, dotted, method)

        # one-level call expansion with the held set
        # (NNL205 thread shapes are handled by _scan_threads)
        if self.held and not self.expand:
            self._maybe_expand(call)

    def _check_blocking(self, call: ast.Call, dotted: str,
                        method: Optional[str]) -> None:
        what = None
        if dotted in _BLOCKING_DOTTED:
            what = dotted
        elif method in _BLOCKING_METHODS:
            what = f".{method}()"
        elif (method in _BLOCKING_IF_BARE and not call.args
                and not call.keywords):
            recv_lock = (self._resolve(call.func.value)
                         if isinstance(call.func, ast.Attribute) else None)
            if recv_lock is not None and any(
                    h.key == recv_lock.key for h in self.held):
                return  # cond.wait()/lock.acquire() on the held lock itself:
                # it releases or re-enters — NNL204 owns the wait shape
            what = f".{method}() with no timeout"
        if what is None:
            return
        self._emit(
            "NNL203",
            f"'{what}' called in '{self.fn_name}' while holding "
            f"{self.held[-1].key}",
            call.lineno,
            hint="move the blocking call outside the lock, or give it "
                 "a timeout")

    def _maybe_expand(self, call: ast.Call) -> None:
        f = call.func
        target = None
        name = ""
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and self.cls is not None):
            target = self.cls.methods.get(f.attr)
            name = f.attr
        elif isinstance(f, ast.Name):
            target = self.m.module_funcs.get(f.id)
            name = f.id
        if target is None or id(target) in self._expanded:
            return
        self._expanded.add(id(target))
        self.walk_function(target, name, entry_held=list(self.held),
                           expand=True)
        self._expanded.discard(id(target))


# ---------------------------------------------------------------------------
# NNL205 — thread lifecycle shape (statement-level scan)
# ---------------------------------------------------------------------------

def _thread_ctor(value: ast.expr, thread_classes: Set[str]
                 ) -> Optional[str]:
    if isinstance(value, ast.Call):
        d = _dotted(value.func)
        if d in thread_classes:
            return d
    return None


def _scan_threads(m: _ModuleInfo, cls: Optional[_ClassInfo],
                  fn: ast.FunctionDef, thread_classes: Set[str],
                  diags: List[Diagnostic]) -> None:
    local_threads: Dict[str, int] = {}       # var -> creation line
    local_ok: Set[str] = set()

    def emit(what: str, line: int) -> None:
        diags.append(make(
            "NNL205",
            f"{what} in '{fn.name}' has no join/stop path",
            location=m.display, line=line,
            hint="store it and join it on stop/close (daemon=True is not "
                 "a shutdown strategy), or pragma with a justification"))

    # pass 1: thread creations (attr-stored, local, fire-and-forget)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            if _thread_ctor(node.value, thread_classes):
                t = node.targets[0]
                attr = _self_attr(t)
                if attr is not None:
                    if cls is not None and attr not in cls.joined_attrs:
                        emit(f"thread stored in 'self.{attr}' "
                             f"(never joined in class {cls.name})",
                             node.lineno)
                elif isinstance(t, ast.Name):
                    local_threads[t.id] = node.lineno
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "start"
                    and isinstance(f.value, ast.Call)
                    and _thread_ctor(f.value, thread_classes)):
                emit("fire-and-forget thread (constructed and started "
                     "without a reference)", node.lineno)
    if not local_threads:
        return
    # pass 2: evidence a local thread is joined or handed off — a join
    # call, a return, or ANY use in an assigned value / call argument
    # (self.x = t, lst + [t], register(t)): ownership moved somewhere
    # with its own join rules
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id in local_threads:
                    local_ok.add(sub.id)
        elif isinstance(node, ast.Return) and node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    local_ok.add(sub.id)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "join" \
                    and isinstance(f.value, ast.Name):
                local_ok.add(f.value.id)
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.Name) \
                            and sub.id in local_threads:
                        local_ok.add(sub.id)
    for var, line in local_threads.items():
        if var not in local_ok:
            emit(f"thread in local '{var}' (started but never joined, "
                 "returned, or stored)", line)


# ---------------------------------------------------------------------------
# per-module pass
# ---------------------------------------------------------------------------

def _entry_held(ci: _ClassInfo, m: _ModuleInfo,
                thread_classes: Set[str]) -> Dict[str, List[_LockId]]:
    """Sweep 1: for each private method, the locks held at EVERY
    intra-class call site — the method's assumed entry held-set (a
    ``_build``-style helper only ever called under the lock is analyzed
    as holding it). Iterated to a small fixpoint so a helper's helper
    (``invoke → _ensure_backend → _open_backend``) inherits the lock
    through the chain."""
    kinds = {f"{ci.name}.{ci.canon(a)}": k
             for a, k in ci.lock_attrs.items()}
    entry: Dict[str, List[_LockId]] = {n: [] for n in ci.methods}
    for _ in range(3):
        call_sites: Dict[str, List[Tuple[str, ...]]] = {}
        w = _Walker(m, ci, thread_classes, {}, [], [])
        w.collect_calls = call_sites
        for name, fn in ci.methods.items():
            w.walk_function(fn, name, entry_held=entry[name])
        nxt: Dict[str, List[_LockId]] = {}
        for name, fn in ci.methods.items():
            sites = call_sites.get(name)
            if not name.startswith("_") or name.startswith("__") \
                    or not sites:
                nxt[name] = []
                continue
            common = set(sites[0])
            for s in sites[1:]:
                common &= set(s)
            nxt[name] = sorted((_LockId(k, kinds.get(k, "lock"))
                                for k in common), key=lambda l: l.key)
        if nxt == entry:
            break
        entry = nxt
    return entry


def _lint_module(m: _ModuleInfo, thread_classes: Set[str],
                 edges: Dict[Tuple[str, str], List[str]]
                 ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    for fn in m.module_funcs.values():
        w = _Walker(m, None, thread_classes, edges, diags, [])
        w.walk_function(fn, fn.name)
        _scan_threads(m, None, fn, thread_classes, diags)

    for ci in m.classes:
        writes: List[_WriteSite] = []
        entry = _entry_held(ci, m, thread_classes)
        w = _Walker(m, ci, thread_classes, edges, diags, writes)
        for name, fn in ci.methods.items():
            w.walk_function(fn, name, entry_held=entry.get(name, []))
            _scan_threads(m, ci, fn, thread_classes, diags)
        diags.extend(_shared_state_findings(m, ci, writes))
    return diags


def _shared_state_findings(m: _ModuleInfo, ci: _ClassInfo,
                           writes: List[_WriteSite]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    by_attr: Dict[str, List[_WriteSite]] = {}
    for site in writes:
        by_attr.setdefault(site.attr, []).append(site)

    for attr, guard in ci.guarded.items():
        lock = ci.lock_id(guard) or ci.lock_id(ci.canon(guard))
        want = lock.key if lock else f"{ci.name}.{guard}"
        for site in by_attr.get(attr, []):
            if want not in site.held:
                diags.append(make(
                    "NNL202",
                    f"'{ci.name}.{attr}' is declared guarded-by "
                    f"'{guard}' but written in '{site.fn}' without it",
                    location=m.display, line=site.line,
                    hint=f"take {want} around the write (or fix the "
                         "guarded-by annotation)"))
    for attr, sites in by_attr.items():
        if attr in ci.guarded:
            continue
        locked = [s for s in sites if s.held]
        bare = [s for s in sites if not s.held]
        if not locked or not bare:
            continue
        lock_names = sorted({k for s in locked for k in s.held})
        for site in bare:
            diags.append(make(
                "NNL202",
                f"'{ci.name}.{attr}' is written under {lock_names[0]} in "
                f"'{locked[0].fn}' but without any lock in '{site.fn}'",
                location=m.display, line=site.line,
                hint="hold the same lock for every write (annotate the "
                     "attr '# guarded-by: <lock>' to make the contract "
                     "checkable)"))
    return diags


# ---------------------------------------------------------------------------
# NNL201 — global cycle detection
# ---------------------------------------------------------------------------

def _order_cycles(edges: Dict[Tuple[str, str], List[str]]
                  ) -> List[Diagnostic]:
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)

    def path(src: str, dst: str) -> Optional[List[str]]:
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

    diags: List[Diagnostic] = []
    reported: Set[frozenset] = set()
    for (a, b), sites in sorted(edges.items()):
        back = path(b, a)
        if back is None:
            continue
        cycle = frozenset([a] + back)
        if cycle in reported:
            continue
        reported.add(cycle)
        loop = " -> ".join([a] + back)
        where = "; ".join(sites[:2])
        diags.append(make(
            "NNL201",
            f"lock-order cycle: {loop} (edge {a} -> {b} at {where}; the "
            "reverse path exists elsewhere) — concurrent threads can "
            "deadlock",
            location=sites[0].split(" ")[0],
            hint="pick one global order for these locks and acquire "
                 "them in that order on every path"))
    return diags
