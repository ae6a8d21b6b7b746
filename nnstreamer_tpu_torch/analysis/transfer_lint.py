"""Pass 5: device-transfer & copy-discipline lint (rules NNL4xx).

Pass 2's sync rules (NNL101/NNL102) match call *names*; this pass tracks
value *flow*: a forward dataflow over each function classifies every
local as ``device`` / ``host`` / ``hostdev`` (a host value materialized
FROM a device value) / unknown, so the rules fire on what a value *is*,
not what the call is spelled like.

The port of nnstreamer_tpu's ``analysis/transfer_lint.py``: the same
dataflow, scopes and rules, seeded with torch spellings.

Device provenance seeds
    * ``torch.*`` constructors with a ``device=`` that is not the CPU,
      ``.to(<device>)`` and ``.cuda()``; a ``torch.*`` op or a tensor
      method fed a device value stays on the device
    * backend ``.invoke(...)`` results and ``fusion_stage`` outputs
    * calls through a captured or exported callable — a local
      ``f = torch.cuda.make_graphed_callables(...)``, an exported
      program's ``.module()``, or a class attribute bound to either
      (``functools.partial`` wrappers included)
    * one level of intra-module call expansion: a helper whose returns
      classify as device credits its call sites (same discipline as
      pass 2's hot-function expansion)

Host provenance seeds: ``np.*`` / ``numpy.*`` constructors, ``bytes`` /
``bytearray`` / ``memoryview``, ``torch.*`` constructors without a
device, ``.cpu()`` and ``.numpy()``. A host value whose *source* was a
device value (``np.asarray(dev)``, ``dev.tolist()``, ``dev.cpu()``) is
``hostdev`` — the state NNL403 watches.

Rules
    NNL401  implicit device→host materialization in a hot scope
            (``np.asarray`` / ``float`` / ``int`` / ``bool`` /
            ``.tolist`` / ``.item`` / ``.numpy`` / iteration over a
            device tensor); ``.cpu()`` is the explicit pull, the
            counterpart of ``jax.device_get``
    NNL402  per-frame device allocation churn (a fresh ``torch``
            constructor with a device inside a per-buffer dispatch path;
            nested stage closures are exempt — a capture replays their
            allocations from its pool)
    NNL403  host round-trip sandwich at function granularity
            (device→host→device on one value; intra-function twin of
            graph-level NNL010)
    NNL404  donation: kept in the catalog and never emitted — PyTorch
            has no buffer donation (an op's ``out=`` is the caller's
            own choice, not a compiler contract a read-after can break)
    NNL405  byte-copy of a wire/shm buffer (``bytes(buf)`` /
            ``.tobytes()`` on a whole frame in transport/query paths;
            header slices like ``bytes(blob[:4])`` are exempt)

Hot scoping, pragmas (``# nnlint: disable=NNL4xx``) and ``skip-file``
are shared with pass 2 (source_lint). The runtime twin is
``NNS_XFERCHECK=1`` (analysis/sanitizer.py): a per-(stage, direction)
byte ledger at the choke points.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, make
from .source_lint import (_collect_pragmas, _dotted, _file_scope,
                          _FunctionIndex, _method_name, _suppressed,
                          skip_file)

# value-flow states
DEVICE = "device"
HOST = "host"
HOSTDEV = "hostdev"   # host value materialized from a device value
DEVICEFN = "devicefn"  # callable returning device values (a captured or
#                        exported callable, a fusion_stage output)
DEVICE_SEQ = "device_seq"  # host sequence OF device tensors (backend
#                            invoke returns a list — iterating the list
#                            is free; materializing an element is not)

# fresh-allocation constructors: one device allocation (+ H2D fill for
# as_tensor/tensor) per call — churn when per-buffer (NNL402)
_TORCH_CONSTRUCTORS = {"zeros", "ones", "full", "empty", "arange",
                       "linspace", "eye", "zeros_like", "ones_like",
                       "full_like", "empty_like", "rand", "randn",
                       "randint", "as_tensor", "tensor"}

# implicit materializers: produce a host value from a device one WITHOUT
# going through the explicit pull (.cpu() / Buffer.as_numpy) — NNL401 in
# hot scope
_NP_MATERIALIZERS = {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array"}
_SCALAR_PULLS = {"float", "int", "bool"}
_METHOD_MATERIALIZERS = {"tolist", "item", "numpy"}
# tensor methods whose result is host metadata, not a tensor
_METADATA_METHODS = {"size", "dim", "numel", "stride", "data_ptr",
                     "element_size", "get_device", "is_contiguous",
                     "is_floating_point", "nbytes", "tobytes"}

# calls whose result is a callable that runs on the device
_CAPTURE_CALLS = {"torch.cuda.make_graphed_callables",
                  "make_graphed_callables", "fusion_stage"}

# wire-path files for NNL405: the query/transport stack plus the binary
# tensor codec — everything the zero-copy wire contract covers
_WIRE_DIRS = {"query", "transport", "shm"}
_WIRE_FILES = {"serialize.py", "protocol.py"}


def lint_transfer(paths: Sequence, *, root: Optional[str] = None
                  ) -> List[Diagnostic]:
    """Transfer-lint Python sources: each path is a file or a directory
    walked recursively. ``root`` only affects display locations."""
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
    hot_ids = {id(fn) for fn, _, _ in finder.hot_functions(scope)}
    ctx = _ModuleContext(finder)

    raw: List[Diagnostic] = []
    for fn, cls in _all_functions(finder):
        flow = _FunctionFlow(fn, cls, ctx)
        flow.run()
        hot = id(fn) in hot_ids
        if hot:
            raw += _emit_materializations(flow, fn, display)
            raw += _emit_alloc_churn(flow, fn, display)
        raw += _emit_sandwich(flow, fn, display)
    if _is_wire_file(path):
        for fn, _cls in _all_functions(finder):
            raw += _check_wire_copies(fn, display)
    return [d for d in raw if not _suppressed(d, pragmas, comments)]


def _all_functions(finder: _FunctionIndex
                   ) -> List[Tuple[ast.FunctionDef, Optional[str]]]:
    out: List[Tuple[ast.FunctionDef, Optional[str]]] = []
    for fn in finder.module_funcs.values():
        out.append((fn, None))
    for (cls, _fname), fn in finder.methods.items():
        out.append((fn, cls))
    return out


def _is_wire_file(path: Path) -> bool:
    parts = set(path.parts)
    return bool(parts & _WIRE_DIRS) or path.name in _WIRE_FILES


# ---------------------------------------------------------------------------
# module-level provenance context
# ---------------------------------------------------------------------------

def _is_capture_expr(value: ast.expr) -> bool:
    """True when ``value`` binds a device callable — a capture call
    (``torch.cuda.make_graphed_callables(f, ...)``), an exported
    program's ``.module()``, or ``functools.partial`` around either."""
    if not isinstance(value, ast.Call):
        return False
    d = _dotted(value.func)
    if d in _CAPTURE_CALLS or _method_name(value.func) == "module":
        return True
    if d in ("functools.partial", "partial") and value.args:
        return _is_capture_expr(value.args[0])
    return False


def _is_cpu(node: Optional[ast.expr]) -> bool:
    """A device spelled as the CPU: ``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    if (isinstance(node, ast.Call) and _dotted(node.func) == "torch.device"
            and node.args):
        return _is_cpu(node.args[0])
    return False


def _device_kw(node: ast.Call) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == "device" and not (isinstance(kw.value, ast.Constant)
                                       and kw.value.value is None):
            return kw.value
    return None


def _is_dtype(node: ast.expr) -> bool:
    """``torch.float32``-style dtype attributes (``.to(dtype)`` keeps the
    tensor where it is)."""
    d = _dotted(node) if isinstance(node, ast.Attribute) else ""
    return d.startswith("torch.") and d != "torch.device"


class _ModuleContext:
    """Cross-function provenance for one module: per-class capture
    attribute bindings (``self._step = make_graphed_callables(...)``) and
    one-level return-state summaries for module functions / methods."""

    def __init__(self, finder: _FunctionIndex):
        self.finder = finder
        # (class name, attr) bound to a device callable
        self.capture_attrs: Set[Tuple[str, str]] = set()
        self._summaries: Dict[int, Optional[str]] = {}
        for cls in finder.classes:
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                if not _is_capture_expr(node.value):
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        self.capture_attrs.add((cls.name, t.attr))

    def return_state(self, fn: ast.FunctionDef, cls: Optional[str]
                     ) -> Optional[str]:
        """DEVICE/HOST when every return of ``fn`` classifies that way
        (one level only — summaries don't consult other summaries)."""
        key = id(fn)
        if key in self._summaries:
            return self._summaries[key]
        self._summaries[key] = None  # cycle/one-level guard
        flow = _FunctionFlow(fn, cls, self, summarizing=True)
        flow.run()
        states = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                states.add(flow.classify(node.value))
        state = None
        if states == {DEVICE}:
            state = DEVICE
        elif states and states <= {HOST, HOSTDEV}:
            state = HOST
        self._summaries[key] = state
        return state


# ---------------------------------------------------------------------------
# per-function forward dataflow
# ---------------------------------------------------------------------------

class _FunctionFlow:
    """Single forward pass over one function body, in statement order
    (loop back-edges are not iterated — lint precision, not soundness).
    Classifies locals and ``self.x`` attributes and records the events
    the NNL40x emitters translate into findings."""

    def __init__(self, fn: ast.FunctionDef, cls: Optional[str],
                 ctx: _ModuleContext, summarizing: bool = False):
        self.fn = fn
        self.cls = cls
        self.ctx = ctx
        self.summarizing = summarizing
        self.env: Dict[str, str] = {}       # local name -> state
        self.attr_env: Dict[str, str] = {}  # self attr  -> state
        # events
        self.materializations: List[Tuple[ast.AST, str]] = []  # (node, what)
        self.device_allocs: List[ast.Call] = []
        self.sandwiches: List[Tuple[ast.Call, str]] = []  # (upload, name)
        # every Name load with its line
        self.loads: Dict[str, List[int]] = {}
        self.local_device_names: Set[str] = set()

    # -- classification -----------------------------------------------------

    def classify(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                if (self.cls is not None
                        and (self.cls, node.attr) in self.ctx.capture_attrs):
                    return DEVICEFN
                return self.attr_env.get(node.attr)
            return None
        if isinstance(node, ast.Call):
            return self._classify_call(node)
        if isinstance(node, (ast.BinOp,)):
            left = self.classify(node.left)
            right = self.classify(node.right)
            if DEVICE in (left, right):
                return DEVICE
            if left in (HOST, HOSTDEV) or right in (HOST, HOSTDEV):
                return HOSTDEV if HOSTDEV in (left, right) else HOST
            return None
        if isinstance(node, ast.UnaryOp):
            return self.classify(node.operand)
        if isinstance(node, ast.Subscript):
            base = self.classify(node.value)
            return DEVICE if base == DEVICE_SEQ else base
        if isinstance(node, ast.IfExp):
            a, b = self.classify(node.body), self.classify(node.orelse)
            return a if a == b else None
        if isinstance(node, (ast.List, ast.Tuple)):
            states = {self.classify(e) for e in node.elts}
            return DEVICE_SEQ if DEVICE in states else None
        return None

    def _upload_target(self, node: ast.Call) -> Optional[ast.expr]:
        """The receiver a ``.to(<device>)`` / ``.cuda()`` moves to the
        device; None for any other call (and for ``.to(dtype)`` or a
        ``.to`` the CPU)."""
        method = _method_name(node.func)
        if method == "cuda":
            return node.func.value
        if method != "to":
            return None
        dev = _device_kw(node)
        if dev is None and node.args:
            dev = node.args[0]
        if dev is None or _is_cpu(dev) or _is_dtype(dev):
            return None
        return node.func.value

    def _to_cpu(self, node: ast.Call) -> bool:
        method = _method_name(node.func)
        if method == "cpu":
            return True
        if method != "to":
            return False
        dev = _device_kw(node)
        if dev is None and node.args:
            dev = node.args[0]
        return _is_cpu(dev)

    def _torch_device_call(self, node: ast.Call) -> bool:
        """A ``torch.*`` call with an explicit non-CPU ``device=``."""
        dev = _device_kw(node)
        return dev is not None and not _is_cpu(dev)

    def _classify_call(self, node: ast.Call) -> Optional[str]:
        dotted = _dotted(node.func)
        method = _method_name(node.func)
        arg0 = node.args[0] if node.args else None
        # device seeds
        if dotted.startswith("torch.") and not dotted.startswith(
                ("torch.cuda.", "torch.export.", "torch.distributed.")):
            if self._torch_device_call(node):
                return DEVICE
            dev = _device_kw(node)
            if dev is not None:          # device="cpu"
                return HOST
            if any(self.classify(a) in (DEVICE, DEVICE_SEQ)
                   for a in node.args):
                return DEVICE
            tail = dotted.rsplit(".", 1)[-1]
            if tail in _TORCH_CONSTRUCTORS or tail == "from_numpy":
                return HOST
            return None
        if self._upload_target(node) is not None:
            return DEVICE
        if method == "invoke":
            return DEVICE_SEQ
        if _is_capture_expr(node):
            return DEVICEFN
        if self.classify(node.func) == DEVICEFN:
            return DEVICE
        # explicit/implicit materializers: hostdev when fed a device value
        if isinstance(node.func, ast.Attribute) and (
                self._to_cpu(node) or method in _METHOD_MATERIALIZERS):
            base = self.classify(node.func.value)
            return HOSTDEV if base in (DEVICE, HOSTDEV) else HOST
        if dotted in _NP_MATERIALIZERS:
            return (HOSTDEV
                    if arg0 is not None
                    and self.classify(arg0) in (DEVICE, DEVICE_SEQ, HOSTDEV)
                    else HOST)
        if method == "tobytes":
            return HOST
        # a tensor method on a device value stays on the device
        if (isinstance(node.func, ast.Attribute)
                and method not in _METADATA_METHODS
                and self.classify(node.func.value) == DEVICE):
            return DEVICE
        # host seeds
        if dotted.startswith("np.") or dotted.startswith("numpy."):
            return HOST
        if dotted in ("bytes", "bytearray", "memoryview"):
            return HOST
        # one-level intra-module call expansion
        callee = self._resolve_callee(node)
        if callee is not None and not self.summarizing:
            fn, ccls = callee
            return self.ctx.return_state(fn, ccls)
        return None

    def _resolve_callee(self, node: ast.Call
                        ) -> Optional[Tuple[ast.FunctionDef, Optional[str]]]:
        f = node.func
        finder = self.ctx.finder
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and self.cls is not None):
            target = finder.methods.get((self.cls, f.attr))
            if target is not None:
                return target, self.cls
        elif isinstance(f, ast.Name):
            target = finder.module_funcs.get(f.id)
            if target is not None:
                return target, None
        return None

    # -- statement walk ------------------------------------------------------

    def run(self) -> None:
        self._collect_loads(self.fn)
        self._walk(self.fn.body, in_nested=False)

    def _collect_loads(self, fn: ast.FunctionDef) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                self.loads.setdefault(node.id, []).append(node.lineno)

    def _walk(self, body: List[ast.stmt], in_nested: bool) -> None:
        for stmt in body:
            self._statement(stmt, in_nested)

    def _statement(self, stmt: ast.stmt, in_nested: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # nested defs are (almost always here) stage closures that a
            # fused segment captures: their allocations replay inside the
            # graph — scan for materialization events only, flag no churn
            self._scan_exprs(stmt, in_nested=True)
            return
        # compound statements: scan only the header expressions here —
        # body statements are walked individually below (scanning the
        # whole subtree would double-count their events)
        if isinstance(stmt, ast.For):
            self._scan_exprs(stmt.iter, in_nested, stop_at_defs=True)
            iter_state = self.classify(stmt.iter)
            if iter_state == DEVICE and not self.summarizing:
                self.materializations.append(
                    (stmt, "iteration over a device array"))
            if isinstance(stmt.target, ast.Name) and iter_state is not None:
                self.env[stmt.target.id] = (
                    DEVICE if iter_state == DEVICE_SEQ else iter_state)
            self._walk(stmt.body, in_nested)
            self._walk(stmt.orelse, in_nested)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_exprs(stmt.test, in_nested, stop_at_defs=True)
            self._walk(stmt.body, in_nested)
            self._walk(stmt.orelse, in_nested)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._scan_exprs(item.context_expr, in_nested,
                                 stop_at_defs=True)
            self._walk(stmt.body, in_nested)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, in_nested)
            for h in stmt.handlers:
                self._walk(h.body, in_nested)
            self._walk(stmt.orelse, in_nested)
            self._walk(stmt.finalbody, in_nested)
            return
        self._scan_exprs(stmt, in_nested, stop_at_defs=True)
        if isinstance(stmt, ast.Assign):
            self._assign(stmt.targets, stmt.value)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._assign([stmt.target], stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            state = self.classify(stmt.value)
            if isinstance(stmt.target, ast.Name) and state is not None:
                self.env[stmt.target.id] = state

    def _assign(self, targets: List[ast.expr], value: ast.expr) -> None:
        state = self.classify(value)
        for t in targets:
            if isinstance(t, ast.Name):
                if state is not None:
                    self.env[t.id] = state
                    if state == DEVICE:
                        self.local_device_names.add(t.id)
                elif t.id in self.env:
                    del self.env[t.id]  # rebound to unknown
            elif (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                if state is not None:
                    self.attr_env[t.attr] = state
            elif isinstance(t, (ast.Tuple, ast.List)):
                # tuple-unpack of one call: every element inherits the
                # call's state (a step returning (tok, cache) yields two
                # device values)
                for elt in t.elts:
                    if isinstance(elt, ast.Name) and state is not None:
                        self.env[elt.id] = state
                        if state == DEVICE:
                            self.local_device_names.add(elt.id)
                    elif (isinstance(elt, ast.Attribute)
                            and isinstance(elt.value, ast.Name)
                            and elt.value.id == "self"
                            and state is not None):
                        self.attr_env[elt.attr] = state

    def _scan_exprs(self, stmt: ast.stmt, in_nested: bool,
                    stop_at_defs: bool = False) -> None:
        """Record rule events for every expression of ``stmt`` (without
        descending into nested defs when ``stop_at_defs``)."""
        stack: List[ast.AST] = [stmt]
        while stack:
            node = stack.pop()
            if stop_at_defs and node is not stmt and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)):
                self._scan_exprs(node, in_nested=True)
                continue
            if isinstance(node, ast.Call):
                self._call_event(node, in_nested)
            stack.extend(ast.iter_child_nodes(node))

    def _call_event(self, node: ast.Call, in_nested: bool) -> None:
        if self.summarizing:
            return
        dotted = _dotted(node.func)
        method = _method_name(node.func)
        arg0 = node.args[0] if node.args else None
        # NNL401 events — implicit materialization of a device value
        if (dotted in _NP_MATERIALIZERS and arg0 is not None
                and self.classify(arg0) in (DEVICE, DEVICE_SEQ)):
            self.materializations.append((node, dotted))
        elif (dotted in _SCALAR_PULLS and arg0 is not None
                and len(node.args) == 1
                and self.classify(arg0) == DEVICE):
            self.materializations.append((node, f"{dotted}()"))
        elif (method in _METHOD_MATERIALIZERS
                and self.classify(node.func.value) == DEVICE):
            self.materializations.append((node, f".{method}()"))
        # NNL402 events — fresh device constructor (exempt inside nested
        # stage closures a capture replays)
        is_torch = dotted.startswith("torch.")
        tail = dotted.rsplit(".", 1)[-1] if "." in dotted else ""
        if not in_nested and is_torch and tail in _TORCH_CONSTRUCTORS:
            if self._torch_device_call(node) or (
                    tail.endswith("_like") and _device_kw(node) is None
                    and arg0 is not None
                    and self.classify(arg0) == DEVICE):
                self.device_allocs.append(node)
        # NNL403 events — hostdev value fed back to the device
        uploaded: List[ast.expr] = []
        if is_torch and self._torch_device_call(node):
            uploaded = list(node.args)
        elif method == "invoke":
            uploaded = list(node.args)
        else:
            target = self._upload_target(node)
            if target is not None:
                uploaded = [target]
        for arg in uploaded:
            if self.classify(arg) == HOSTDEV:
                self.sandwiches.append((node, ast.unparse(arg)))


# ---------------------------------------------------------------------------
# rule emitters
# ---------------------------------------------------------------------------

def _emit_materializations(flow: _FunctionFlow, fn: ast.FunctionDef,
                           display: str) -> List[Diagnostic]:
    diags = []
    for node, what in flow.materializations:
        diags.append(make(
            "NNL401",
            f"'{what}' materializes a device value on host inside hot "
            f"function '{fn.name}' — one implicit device→host transfer "
            "per buffer", location=display, line=node.lineno,
            col=node.col_offset,
            hint="keep the value device-resident, or pull once through "
                 "the explicit path and pragma the intentional site",
            fix_hint="stay on device (torch ops), or pull with .cpu() / "
                     "Buffer.as_numpy at a batch boundary and add "
                     "'# nnlint: disable=NNL401' with the justification"))
    return diags


def _emit_alloc_churn(flow: _FunctionFlow, fn: ast.FunctionDef,
                      display: str) -> List[Diagnostic]:
    diags = []
    for node in flow.device_allocs:
        what = _dotted(node.func)
        diags.append(make(
            "NNL402",
            f"'{what}' allocates a fresh device tensor inside per-buffer "
            f"hot function '{fn.name}' — one device allocation per "
            "frame", location=display, line=node.lineno,
            col=node.col_offset,
            hint="hoist the constant to __init__/module scope, or reuse "
                 "a preallocated buffer",
            fix_hint=f"hoist the {what}(...) out of the per-buffer path "
                     "(construct once, reuse), or write into the previous "
                     "frame's buffer with out="))
    return diags


def _emit_sandwich(flow: _FunctionFlow, fn: ast.FunctionDef,
                   display: str) -> List[Diagnostic]:
    diags = []
    for node, name in flow.sandwiches:
        diags.append(make(
            "NNL403",
            f"'{name}' went device→host and is re-uploaded to device in "
            f"'{fn.name}' — a host round-trip sandwich on one value",
            location=display, line=node.lineno, col=node.col_offset,
            hint="keep the intermediate on device (the intra-function "
                 "twin of graph-level NNL010)",
            fix_hint="compute the intermediate with torch ops instead of "
                     "materializing it; drop the host hop entirely"))
    return diags


def _check_wire_copies(fn: ast.FunctionDef, display: str
                       ) -> List[Diagnostic]:
    diags = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        method = _method_name(node.func)
        if (dotted == "bytes" and len(node.args) == 1
                and isinstance(node.args[0], (ast.Name, ast.Attribute))):
            what = "bytes(<buffer>)"
        elif method == "tobytes":
            what = ".tobytes()"
        else:
            continue  # bytes(blob[a:b]) header slices etc are exempt
        diags.append(make(
            "NNL405",
            f"'{what}' copies a whole wire/shm buffer in '{fn.name}' — "
            "the zero-copy wire contract hands frames off by reference",
            location=display, line=node.lineno, col=node.col_offset,
            hint="pass the memoryview through (sendmsg gather-write, "
                 "buffer-protocol file write) instead of copying",
            fix_hint="replace the copy with a memoryview hand-off: "
                     "sock.sendmsg([header, payload]) for sockets, "
                     "fh.write(memoryview) for files"))
    return diags
