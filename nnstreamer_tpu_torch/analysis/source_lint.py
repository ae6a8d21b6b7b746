"""Pass 2: AST-based hot-path linting of our own tree (rules NNL1xx).

The checks encode the perf discipline the rest of the codebase is built
around: element ``chain``/``transform`` bodies and the serving
scheduler's batch loop are THE steady-state hot paths — a stray
``torch.cuda.synchronize()`` or a silent ``except`` there costs every
buffer of every stream. Scoping is structural, not name-matching on the whole
tree:

* files under ``elements/`` (and the runtime pad/element substrate) get
  the element hot set (``chain``/``transform``/``render``/``create``);
* files under ``serving/`` get the scheduler hot set (``_loop``/
  ``_execute``/``step``/``take_ready``/...);
* files under ``obs/`` get the observability hot set — trace-context
  propagation (``to_meta``/``from_meta``/``start_span``/``record_span``/
  ``end``) and the flight-recorder ``record`` run inside pad pushes,
  batch loops, and fused dispatches, so the same no-sync / no-silent-
  swallow discipline applies;
* helpers *called from* a hot function in the same module are hot too
  (one level — e.g. ``_block_ready`` called from ``Scheduler._execute``).

Intentional sites (a sampled latency probe, the decode loop's one
designed host pull) are annotated in-source with
``# nnlint: disable=NNL1xx`` pragmas on the offending line (or the line
above), which keeps the self-lint gate at zero findings without blinding
the rule.

The port of nnstreamer_tpu's ``analysis/source_lint.py``: the same scopes,
hot sets, one-level helper expansion, pragmas and rules, with the torch
spellings of the two JAX-only seeds. NNL101's syncs are
``torch.cuda.synchronize``, a stream's or event's ``.synchronize()`` and
the pulls ``.cpu()``/``.item()``/``.tolist()``/``.numpy()`` (name-based,
as the reference's ``block_until_ready``: a pull of a host tensor takes a
pragma saying so). NNL106's traced functions are the ones the port hands
to CUDA-graph capture or ``torch.export`` (``torch.export.export``,
``torch.cuda.make_graphed_callables``, a fused segment's ``_capture``)
and the ``__call__``/``forward`` of classes declaring
``capture_safe = True`` (the models a fused segment captures).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, make

# hot function names per scope (see module docstring)
# "dispatch" covers the fused-segment single-dispatch path
# (runtime/fusion.py FusedSegment.dispatch): the NNL1xx hot-path
# discipline applies to the fusion compiler itself
ELEMENT_HOT = {"chain", "transform", "render", "create", "_task",
               "_chain_guarded", "push", "dispatch"}
SERVING_HOT = {"_loop", "_execute", "_admit_one", "step", "take_ready",
               "add", "_form", "next_flush_in"}
# obs hot paths (obs/context.py, obs/flight.py, obs/profile.py,
# obs/quality.py): called from element chains, the serving batch loop,
# and fused dispatches when tracing is on — `record` unconditionally;
# the continuous profiler's recording surface (observe / record_request
# / record_queue_wait / record_fused, plus the digest insert and tracer
# callbacks they hit) and the quality taps' recording surface
# (observe_reduced / fold / record_fused_outputs / observe_outputs —
# sampled tensor-health reductions riding the same hooks) join the same
# no-sync / no-silent-swallow discipline
OBS_HOT = {"record", "to_meta", "from_meta", "start_span", "record_span",
           "end", "_record_finished", "_coerce_parent",
           "observe", "record_request", "record_queue_wait",
           "record_fused", "buffer_flow", "serving_event", "add",
           "observe_reduced", "_fold", "fold", "record_fused_outputs",
           "observe_outputs"}

_HOT_BY_SCOPE = {"element": ELEMENT_HOT, "serving": SERVING_HOT,
                 "obs": OBS_HOT}

# NNL101 — calls that synchronize device → host
_SYNC_METHODS = {"synchronize", "cpu", "item", "tolist", "numpy"}
_SYNC_DOTTED = {"torch.cuda.synchronize"}
# additionally flagged inside serving/runtime hot paths, where arrays in
# flight are device-resident by design
_SYNC_DOTTED_SERVING = {"np.asarray", "np.array", "numpy.asarray",
                        "numpy.array"}

# NNL105 — blocking calls that don't belong in batch formation
_BLOCKING_DOTTED = {"time.sleep", "subprocess.run", "subprocess.Popen",
                    "subprocess.check_output", "requests.get",
                    "requests.post", "socket.socket"}
_BLOCKING_NAMES = {"open", "print", "input"}
_BLOCKING_METHODS = {"acquire"}

_PRAGMA_RE = re.compile(r"#\s*nnlint:\s*disable=([A-Za-z0-9_,\s]+)")
_SKIP_FILE_TOKEN = "nnlint: skip-file"


def skip_file(text: str) -> bool:
    """``# nnlint: skip-file`` in the first 15 lines excludes the file
    from every source pass — the escape hatch for generated scaffolds
    (``__main__`` codegen skeletons carry it with a justification) whose
    TODO stubs would otherwise trip the strict self-lint gate."""
    head = text.splitlines()[:15]
    return any(_SKIP_FILE_TOKEN in ln for ln in head)


def lint_source(paths: Sequence, *, root: Optional[str] = None
                ) -> List[Diagnostic]:
    """Lint Python sources: each path is a file or a directory walked
    recursively. ``root`` (default: common parent) only affects how
    locations are displayed."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts))
        else:
            files.append(p)
    diags: List[Diagnostic] = []
    for f in files:
        diags.extend(_lint_file(f, root=root))
    return diags


def _lint_file(path: Path, root: Optional[str] = None) -> List[Diagnostic]:
    try:
        text = path.read_text()
        if skip_file(text):
            return []
        tree = ast.parse(text, filename=str(path))
    except (OSError, SyntaxError, ValueError) as e:
        return [make("NNL100", f"cannot lint {path}: {e}",
                     location=str(path))]
    display = str(path)
    if root:
        try:
            display = str(path.relative_to(root))
        except ValueError:
            pass
    pragmas, comments = _collect_pragmas(text)
    scope = _file_scope(path)
    finder = _FunctionIndex(tree)
    hot = finder.hot_functions(scope)
    device_classes = finder.device_affinity_classes()

    raw: List[Diagnostic] = []
    raw += _check_bare_except(tree, display)
    for fn, fscope, cls in hot:
        raw += _check_host_sync(fn, fscope, display)
        raw += _check_scalar_pull(fn, fscope, cls, device_classes, display)
        raw += _check_silent_swallow(fn, display)
        if fscope == "serving":
            raw += _check_blocking(fn, display)
    raw += _check_tracer_branch(tree, display)
    return [d for d in raw if not _suppressed(d, pragmas, comments)]


# ---------------------------------------------------------------------------
# scoping machinery
# ---------------------------------------------------------------------------

def _file_scope(path: Path) -> Optional[str]:
    parts = set(path.parts)
    if "serving" in parts:
        return "serving"
    if "elements" in parts:
        return "element"
    if "obs" in parts:
        return "obs"
    if "runtime" in parts and path.name in ("pad.py", "element.py",
                                            "queue.py", "fusion.py"):
        return "element"
    return None


class _FunctionIndex:
    """All function defs in a module, with enough structure to resolve
    one level of intra-module calls (self.helper() / module helper())."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.module_funcs: Dict[str, ast.FunctionDef] = {}
        self.methods: Dict[Tuple[str, str], ast.FunctionDef] = {}
        self.classes: List[ast.ClassDef] = []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes.append(node)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.methods[(node.name, sub.name)] = sub

    def device_affinity_classes(self) -> Set[str]:
        """Class names declaring DEVICE_AFFINITY = \"device\" (visible to
        the AST — no import needed)."""
        out: Set[str] = set()
        for cls in self.classes:
            for node in cls.body:
                if (isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "DEVICE_AFFINITY"
                                for t in node.targets)
                        and isinstance(node.value, ast.Constant)
                        and node.value.value == "device"):
                    out.add(cls.name)
        return out

    def hot_functions(self, scope: Optional[str]
                      ) -> List[Tuple[ast.FunctionDef, str, Optional[str]]]:
        """(function, scope, class name) for every hot function, with one
        level of same-module call expansion."""
        if scope is None:
            return []
        names = _HOT_BY_SCOPE[scope]
        roots: List[Tuple[ast.FunctionDef, Optional[str]]] = []
        for (cls, fname), fn in self.methods.items():
            if fname in names:
                roots.append((fn, cls))
        for fname, fn in self.module_funcs.items():
            if fname in names:
                roots.append((fn, None))
        seen = {id(fn) for fn, _ in roots}
        expanded = list(roots)
        for fn, cls in roots:
            for callee, ccls in self._callees(fn, cls):
                if id(callee) not in seen:
                    seen.add(id(callee))
                    expanded.append((callee, ccls))
        return [(fn, scope, cls) for fn, cls in expanded]

    def _callees(self, fn: ast.FunctionDef, cls: Optional[str]
                 ) -> Iterable[Tuple[ast.FunctionDef, Optional[str]]]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and cls is not None):
                target = self.methods.get((cls, f.attr))
                if target is not None:
                    yield target, cls
            elif isinstance(f, ast.Name):
                target = self.module_funcs.get(f.id)
                if target is not None:
                    yield target, None


def _collect_pragmas(text: str) -> Tuple[Dict[int, Set[str]], Set[int]]:
    """(pragma rules per line, comment-only line numbers). A pragma
    applies to its own line, or — when written as a standalone comment —
    to the next code line, looking up through a contiguous comment block
    (multi-line pragma comments are common)."""
    pragmas: Dict[int, Set[str]] = {}
    comments: Set[int] = set()
    for i, line in enumerate(text.splitlines(), start=1):
        if line.lstrip().startswith("#"):
            comments.add(i)
        m = _PRAGMA_RE.search(line)
        if m:
            pragmas[i] = {r.strip() for r in m.group(1).split(",")
                          if r.strip()}
    return pragmas, comments


def _suppressed(d: Diagnostic, pragmas: Dict[int, Set[str]],
                comments: Set[int]) -> bool:
    if d.line is None:
        return False

    def match(ln: int) -> bool:
        rules = pragmas.get(ln)
        return bool(rules and (d.rule in rules or "all" in rules))

    if match(d.line):
        return True
    ln = d.line - 1
    while ln in comments:
        if match(ln):
            return True
        ln -= 1
    return False


# ---------------------------------------------------------------------------
# call-shape helpers
# ---------------------------------------------------------------------------

def _dotted(func: ast.expr) -> str:
    """'torch.cuda.synchronize' for Attribute chains rooted at a Name;
    '.method' for attribute calls on arbitrary expressions; 'name' for
    bare calls."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:
        return "." + parts[-len(parts)]
    return ""


def _method_name(func: ast.expr) -> Optional[str]:
    return func.attr if isinstance(func, ast.Attribute) else None


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _check_host_sync(fn: ast.FunctionDef, scope: str, display: str
                     ) -> List[Diagnostic]:
    diags = []
    sync_dotted = set(_SYNC_DOTTED)
    if scope == "serving":
        sync_dotted |= _SYNC_DOTTED_SERVING
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        method = _method_name(node.func)
        if dotted in sync_dotted or method in _SYNC_METHODS:
            what = dotted or f".{method}()"
            diags.append(make(
                "NNL101",
                f"'{what}' in hot function '{fn.name}' forces a "
                "device→host sync per call", location=display,
                line=node.lineno, col=node.col_offset,
                hint="keep values device-resident; sample or batch the "
                     "sync, or pragma if intentional"))
    return diags


def _check_scalar_pull(fn: ast.FunctionDef, scope: str, cls: Optional[str],
                       device_classes: Set[str], display: str
                       ) -> List[Diagnostic]:
    # only meaningful where the values flowing through are device arrays:
    # methods of a DEVICE_AFFINITY="device" element class
    if scope != "element" or cls is None or cls not in device_classes:
        return []
    diags = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if not (isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")):
            continue
        if len(node.args) != 1 or isinstance(node.args[0], ast.Constant):
            continue
        diags.append(make(
            "NNL102",
            f"{node.func.id}() on a runtime value in hot function "
            f"'{fn.name}' of device element '{cls}' blocks on a "
            "device→host scalar transfer", location=display,
            line=node.lineno, col=node.col_offset,
            hint="keep the comparison on device (torch ops) or pull once "
                 "per batch, not per scalar"))
    return diags


def _check_bare_except(tree: ast.Module, display: str) -> List[Diagnostic]:
    diags = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            diags.append(make(
                "NNL103", "bare 'except:' hides the error type and "
                "catches KeyboardInterrupt/SystemExit", location=display,
                line=node.lineno, col=node.col_offset,
                hint="catch Exception (or a concrete class) instead"))
    return diags


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    return (isinstance(t, ast.Name)
            and t.id in ("Exception", "BaseException"))


def _check_silent_swallow(fn: ast.FunctionDef, display: str
                          ) -> List[Diagnostic]:
    diags = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is not None and not _is_broad(node):
            continue
        body_ok = all(
            isinstance(s, (ast.Pass, ast.Continue, ast.Break))
            or (isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant))
            for s in node.body)
        if body_ok:
            diags.append(make(
                "NNL104",
                f"broad except in hot function '{fn.name}' swallows the "
                "error silently — the stream corrupts without a pipeline "
                "ERROR", location=display, line=node.lineno,
                col=node.col_offset,
                hint="log it, post_error(), or narrow the exception type"))
    return diags


def _check_blocking(fn: ast.FunctionDef, display: str) -> List[Diagnostic]:
    diags = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        method = _method_name(node.func)
        bare = node.func.id if isinstance(node.func, ast.Name) else None
        if (dotted in _BLOCKING_DOTTED or bare in _BLOCKING_NAMES
                or method in _BLOCKING_METHODS):
            what = dotted or bare or f".{method}()"
            diags.append(make(
                "NNL105",
                f"blocking call '{what}' in batch-formation function "
                f"'{fn.name}' adds tail latency to every queued request",
                location=display, line=node.lineno, col=node.col_offset,
                hint="move I/O off the scheduler thread"))
    return diags


# callables that trace their first argument: CUDA-graph capture and
# torch.export (the port's counterparts of jax.jit)
_TRACING_CALLS = {"torch.export.export", "export.export",
                  "torch.cuda.make_graphed_callables",
                  "make_graphed_callables", "self._capture", "_capture"}
# methods of a ``capture_safe = True`` class that a capture traces
_TRACED_METHODS = {"__call__", "forward"}


def _declares_capture_safe(cls: ast.ClassDef) -> bool:
    for node in cls.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "capture_safe"
                        for t in node.targets)
                and isinstance(node.value, ast.Constant)
                and node.value.value is True):
            return True
    return False


def _traced_functions(tree: ast.Module
                           ) -> List[Tuple[ast.AST, Set[str]]]:
    """(function, static param names) for the functions a capture or an
    export traces: the first argument of a tracing call when it is a
    function defined in the same module (or a lambda), and the
    ``__call__``/``forward`` of a class declaring ``capture_safe = True``.
    A method's ``self`` is static (a Python object, not a tensor)."""
    defs: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    out: List[Tuple[ast.AST, Set[str]]] = []
    seen: Set[int] = set()

    def record(fn, static: Set[str]) -> None:
        if id(fn) in seen:
            return
        seen.add(id(fn))
        out.append((fn, static))

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _declares_capture_safe(node):
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and sub.name in _TRACED_METHODS):
                    pos = sub.args.posonlyargs + sub.args.args
                    record(sub, {pos[0].arg} if pos else set())
        elif isinstance(node, ast.Call):
            if _dotted(node.func) in _TRACING_CALLS and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Name) and arg.id in defs:
                    record(defs[arg.id], set())
                elif isinstance(arg, ast.Lambda):
                    record(arg, set())
    return out


def _param_names(fn) -> Set[str]:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


# metadata attributes that are static python values at trace time —
# branching on them is shape-polymorphism, not tracer leakage
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "layout", "requires_grad"}
_SAFE_CALLS = {"isinstance", "len", "getattr", "hasattr", "type", "callable"}
# tensor methods that return static metadata (``x.dim()``, ``x.size(0)``)
_STATIC_METHODS = {"dim", "size", "numel", "is_floating_point",
                   "is_complex", "is_contiguous", "get_device"}


def _tracer_names_in(test: ast.expr, params: Set[str]) -> List[ast.Name]:
    hits: List[ast.Name] = []

    def scan(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return  # `x is None` — identity check, legal on a tracer
        if isinstance(node, ast.Subscript):
            # x.shape[0] style — the Subscript wraps the Attribute
            if (isinstance(node.value, ast.Attribute)
                    and node.value.attr in _STATIC_ATTRS):
                return
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in _SAFE_CALLS or _method_name(node.func) in _STATIC_METHODS:
                return
        if isinstance(node, ast.Name) and node.id in params:
            hits.append(node)
            return
        for child in ast.iter_child_nodes(node):
            scan(child)

    scan(test)
    return hits


def _check_tracer_branch(tree: ast.Module, display: str) -> List[Diagnostic]:
    diags = []
    for fn, static in _traced_functions(tree):
        params = _param_names(fn) - static
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for node in ast.walk(ast.Module(body=body, type_ignores=[])):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for name in _tracer_names_in(node.test, params):
                fname = getattr(fn, "name", "<lambda>")
                diags.append(make(
                    "NNL106",
                    f"traced function '{fname}' branches on parameter "
                    f"'{name.id}' — a capture or an export bakes in the "
                    "branch it took", location=display, line=node.lineno,
                    col=node.col_offset,
                    hint="use torch.where, or hoist the value to a "
                         "Python attribute fixed before the capture"))
                break  # one finding per branch statement
    return diags
