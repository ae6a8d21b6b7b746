"""Pass 6: wire-protocol & serialization-contract lint (rules NNL5xx).

Passes 2–5 audit how code computes; this pass audits what code *promises
a peer*: the NNSB/NNSQ/NNSR/MQTT codecs and the caps negotiation are a
contract with a remote process that may be truncated, corrupted,
version-skewed, or outright hostile — and the contract must hold
statically, before a byte ever crosses a socket.

Scope: only wire files (the ``query``/``transport``/``shm`` trees plus
``serialize.py``/``protocol.py``) — the same scoping as NNL405's
zero-copy contract. Non-wire files produce no findings.

Rules
    NNL501  struct-layout drift: a multi-field format packed but never
            unpacked in its module (or vice versa), an unpack
            destructured into the wrong field count, or a declared
            ``*_SIZE``/``*_BYTES`` constant that no longer equals
            ``calcsize`` of its like-named struct
    NNL502  unvalidated wire-derived size: a value unpacked off the wire
            (or read via a recv helper) flowing into ``range``/
            ``bytearray``/``frombuffer``/a sized recv/a byte-string
            multiply with no bounds comparison anywhere in the function
            — the hostile-peer memory-bomb shape
    NNL503  unbounded recv path: a partial-read loop with no EOF
            progress check, a message-level read on a parameter socket
            with no prior ``settimeout`` deadline, or ``unpack_from``
            on wire bytes where ``struct.error`` escapes untyped
    NNL504  encode/decode asymmetry and negotiation-fallback gaps: a
            literal field key written by an encode-side function with
            no reader in the module's decode side (or vice versa), or
            negotiation caps consumed by hard ``["key"]`` indexing
            instead of ``.get`` with a legacy fallback
    NNL505  platform-dependent serialization: a multi-byte wire format
            without an explicit ``<``/``>``/``!`` byte order, or an
            encode-side function emitting by iterating an unsorted
            ``.items()``

Pragmas (``# nnlint: disable=NNL5xx``) and ``skip-file`` are shared with
pass 2 (source_lint).

The port of nnstreamer_tpu's ``analysis/protocol_lint.py``: the rules
are spelling-independent and carry over as they are, scoped to the
port's ``query/`` and ``transport/`` trees and its ``serialize.py`` /
``protocol.py`` files.
"""
from __future__ import annotations

import ast
import struct as _struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import Diagnostic, make
from .source_lint import (_collect_pragmas, _dotted, _method_name,
                          _suppressed, skip_file)

# wire-path files: the query/transport stack plus the tensor codecs —
# everything the hostile-peer contract covers
_WIRE_DIRS = {"query", "transport", "shm"}
_WIRE_FILES = {"serialize.py", "protocol.py"}

# struct codes whose encoding is byte-order-free: a format made only of
# these needs no explicit prefix (NNL505 exempts it)
_ORDER_FREE_CODES = set("bBsxc?")

# name tokens classifying codec functions for NNL504/NNL505
_ENCODE_TOKENS = {"encode", "pack", "offer", "reply"}
_DECODE_TOKENS = {"decode", "unpack", "split", "parse"}

# recv-helper call names (byte- and message-level) for NNL502 taint
# seeds and NNL503's "this function touches the socket" predicate
_RECV_NAMES = {"recv", "recv_into", "recvfrom", "recvmsg"}
_MSG_READ_RE = ("recv_msg", "_read_packet", "read_packet", "recv_frame",
                "read_frame")


def lint_protocol(paths: Sequence, *, root: Optional[str] = None
                  ) -> List[Diagnostic]:
    """Protocol-lint Python sources: each path is a file or a directory
    walked recursively; only wire-scope files produce findings. ``root``
    only affects display locations."""
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


def _is_wire_file(path: Path) -> bool:
    parts = set(path.parts)
    return bool(parts & _WIRE_DIRS) or path.name in _WIRE_FILES


def _lint_file(path: Path, root: Optional[str] = None) -> List[Diagnostic]:
    if not _is_wire_file(path):
        return []
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
    mod = _ModuleWire(tree)

    raw: List[Diagnostic] = []
    raw += _check_layout(mod, display)
    raw += _check_byte_order(mod, display)
    raw += _check_codec_symmetry(mod, display)
    for fn in mod.functions:
        raw += _check_wire_sizes(fn, mod, display)
        raw += _check_recv_contract(fn, mod, display)
        raw += _check_caps_fallback(fn, display)
        raw += _check_hash_order(fn, display)
    return [d for d in raw if not _suppressed(d, pragmas, comments)]


# ---------------------------------------------------------------------------
# module model
# ---------------------------------------------------------------------------

def _fmt_fields(fmt: str) -> int:
    """Number of values a struct format packs/unpacks ('8Q' = 8 fields,
    '4s' = 1, 'x' pad = 0); -1 when the format does not parse."""
    try:
        _struct.calcsize(fmt)
    except _struct.error:
        return -1
    s = fmt.strip()
    if s and s[0] in "<>!=@":
        s = s[1:]
    n, count = 0, ""
    for ch in s:
        if ch.isdigit():
            count += ch
            continue
        if ch.isspace():
            continue
        rep = int(count) if count else 1
        count = ""
        if ch == "x":
            continue
        n += 1 if ch == "s" else rep
    return n


def _name_tokens(name: str) -> Set[str]:
    return {t for t in name.lower().split("_") if t}


class _ModuleWire:
    """Everything the NNL50x emitters need from one wire module: every
    function def, the module-level ``struct.Struct`` bindings with their
    literal formats, module integer constants, and the pack/unpack-side
    occurrences of every literal format."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.functions: List[ast.FunctionDef] = []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(node)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.functions.append(sub)
        # module-level struct bindings: NAME = struct.Struct("<fmt>")
        self.structs: Dict[str, Tuple[str, ast.Assign]] = {}
        # module-level int constants: NAME = 123 (incl. 1 << 20 shifts)
        self.int_consts: Dict[str, Tuple[int, ast.Assign]] = {}
        for node in tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            v = node.value
            if (isinstance(v, ast.Call)
                    and _dotted(v.func) in ("struct.Struct", "Struct")
                    and v.args and isinstance(v.args[0], ast.Constant)
                    and isinstance(v.args[0].value, str)):
                self.structs[t.id] = (v.args[0].value, node)
            else:
                val = _const_int(v)
                if val is not None:
                    self.int_consts[t.id] = (val, node)
        # (fmt, node) occurrences per side
        self.pack_sites: List[Tuple[str, ast.Call]] = []
        self.unpack_sites: List[Tuple[str, ast.Call]] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                side, fmt = self._classify_struct_call(node)
                if side == "pack":
                    self.pack_sites.append((fmt, node))
                elif side == "unpack":
                    self.unpack_sites.append((fmt, node))

    def _classify_struct_call(self, node: ast.Call
                              ) -> Tuple[Optional[str], str]:
        """('pack'|'unpack'|None, fmt) for a struct pack/unpack call —
        module-level ``struct.pack("<fmt>", …)``, a bound
        ``STRUCT.pack(…)``, or the reader idiom ``r.unpack(STRUCT, …)``
        where STRUCT is a module struct binding."""
        dotted = _dotted(node.func)
        method = _method_name(node.func)
        if dotted in ("struct.pack", "struct.pack_into",
                      "struct.unpack", "struct.unpack_from"):
            if (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                side = ("unpack" if dotted.rsplit(".", 1)[-1]
                        .startswith("unpack") else "pack")
                return side, node.args[0].value
            return None, ""
        if method in ("pack", "pack_into", "unpack", "unpack_from"):
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id in self.structs:
                side = "unpack" if method.startswith("unpack") else "pack"
                return side, self.structs[recv.id][0]
            # reader idiom: r.unpack(_HEADER, "what")
            if method.startswith("unpack"):
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id in self.structs:
                        return "unpack", self.structs[a.id][0]
        return None, ""

    def unpack_field_count(self, node: ast.Call) -> Optional[int]:
        side, fmt = self._classify_struct_call(node)
        if side != "unpack":
            return None
        n = _fmt_fields(fmt)
        return n if n >= 0 else None


def _const_int(node: ast.expr) -> Optional[int]:
    """Statically evaluated int of a constant expression (literals and
    the ``1 << 20`` idiom); None otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp):
        left, right = _const_int(node.left), _const_int(node.right)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.LShift):
                return left << right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
        except (OverflowError, ValueError):
            return None
    return None


# ---------------------------------------------------------------------------
# NNL501 — struct-layout drift
# ---------------------------------------------------------------------------

def _check_layout(mod: _ModuleWire, display: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    # (a) declared size constant vs calcsize of its like-named struct:
    # struct _HEADER pairs with HEADER_SIZE / _HEADER_SIZE / HEADER_BYTES
    for sname, (fmt, _node) in mod.structs.items():
        base = sname.strip("_").upper()
        try:
            size = _struct.calcsize(fmt)
        except _struct.error:
            continue
        for cname, (val, cnode) in mod.int_consts.items():
            cbase = cname.strip("_").upper()
            if not (cbase.startswith(base + "_")
                    and cbase.rsplit("_", 1)[-1] in ("SIZE", "BYTES",
                                                     "LEN")):
                continue
            if val != size:
                diags.append(make(
                    "NNL501",
                    f"declared constant {cname}={val} disagrees with "
                    f"calcsize({sname}.format '{fmt}')={size} — the "
                    "header layout drifted from its declared width",
                    location=display, line=cnode.lineno,
                    col=cnode.col_offset,
                    hint="derive the constant from the struct "
                         f"({cname} = {sname}.size) so it can never "
                         "drift",
                    fix_hint=f"set {cname} = {sname}.size (or update "
                             f"the format) — wire width must have one "
                             "source of truth"))
    # (b) one-sided multi-field formats: packed but never unpacked in
    # this module, or vice versa (single-field formats are exempt —
    # helpers like length prefixes legitimately live on one side)
    packed = {fmt for fmt, _ in mod.pack_sites}
    unpacked = {fmt for fmt, _ in mod.unpack_sites}
    both = packed and unpacked  # one-sided modules (pure senders) exempt
    if both:
        for fmt, node in mod.pack_sites:
            if _fmt_fields(fmt) >= 2 and fmt not in unpacked:
                diags.append(make(
                    "NNL501",
                    f"format '{fmt}' is packed but never unpacked in "
                    "this module — the decoder's layout can drift "
                    "without a diff touching both sides",
                    location=display, line=node.lineno,
                    col=node.col_offset,
                    hint="bind the layout once (MOD_STRUCT = "
                         "struct.Struct(...)) and use it on both sides",
                    fix_hint="share one module-level struct.Struct "
                             "between the pack and unpack sites"))
        for fmt, node in mod.unpack_sites:
            if _fmt_fields(fmt) >= 2 and fmt not in packed:
                diags.append(make(
                    "NNL501",
                    f"format '{fmt}' is unpacked but never packed in "
                    "this module — the encoder's layout can drift "
                    "without a diff touching both sides",
                    location=display, line=node.lineno,
                    col=node.col_offset,
                    hint="bind the layout once (MOD_STRUCT = "
                         "struct.Struct(...)) and use it on both sides",
                    fix_hint="share one module-level struct.Struct "
                             "between the pack and unpack sites"))
    # (c) unpack destructure arity: tuple target length vs field count
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not isinstance(t, (ast.Tuple, ast.List)):
            continue
        if any(isinstance(e, ast.Starred) for e in t.elts):
            continue  # starred target absorbs any arity
        if not isinstance(node.value, ast.Call):
            continue
        nfields = mod.unpack_field_count(node.value)
        if nfields is None:
            continue
        if len(t.elts) != nfields:
            diags.append(make(
                "NNL501",
                f"unpack destructured into {len(t.elts)} name(s) but the "
                f"format carries {nfields} field(s) — field-count drift "
                "raises at runtime on every frame",
                location=display, line=node.lineno, col=node.col_offset,
                hint="match the target tuple to the format's fields",
                fix_hint="add/remove destructure targets (or a *rest "
                         "star) to match the struct's field count"))
    return diags


# ---------------------------------------------------------------------------
# NNL505 — platform-dependent serialization
# ---------------------------------------------------------------------------

def _check_byte_order(mod: _ModuleWire, display: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    seen: Set[int] = set()
    sites: List[Tuple[str, ast.AST]] = []
    for name, (fmt, node) in mod.structs.items():
        sites.append((fmt, node))
    sites.extend(mod.pack_sites)
    sites.extend(mod.unpack_sites)
    for fmt, node in sites:
        if id(node) in seen:
            continue
        seen.add(id(node))
        s = fmt.strip()
        if not s or s[0] in "<>!":
            continue
        body = s[1:] if s[0] in "=@" else s
        codes = {c for c in body if not c.isdigit() and not c.isspace()}
        if codes <= _ORDER_FREE_CODES and s[0] not in "=@":
            continue  # pure byte/char formats carry no order
        diags.append(make(
            "NNL505",
            f"struct format '{fmt}' uses native byte order"
            + (" and alignment" if s[0] not in "=@" else "")
            + " — the wire layout changes across architectures; a "
            "big-endian or differently-aligned peer mis-decodes every "
            "field",
            location=display,
            line=getattr(node, "lineno", None),
            col=getattr(node, "col_offset", None),
            hint="declare the byte order explicitly: '<' "
                 "little-endian (NNSB/NNSR convention) or '>' network "
                 "order",
            fix_hint=f"prefix the format with '<' (or '>'): "
                     f"'{'<' + body}'"))
    return diags


def _check_hash_order(fn: ast.FunctionDef, display: str
                      ) -> List[Diagnostic]:
    if not (_name_tokens(fn.name) & _ENCODE_TOKENS):
        return []
    diags: List[Diagnostic] = []
    iters: List[ast.expr] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters.extend(g.iter for g in node.generators)
    for it in iters:
        if not (isinstance(it, ast.Call) and _method_name(it.func)
                in ("items", "keys", "values")):
            continue
        diags.append(make(
            "NNL505",
            f"encoder '{fn.name}' iterates an unsorted "
            f".{_method_name(it.func)}() — the emitted byte stream "
            "depends on dict insertion order, which is not a wire "
            "contract (two peers encoding the same meta produce "
            "different bytes)",
            location=display, line=it.lineno, col=it.col_offset,
            hint="iterate sorted(...) so the encoding is canonical",
            fix_hint=f"wrap the iteration: sorted(x."
                     f"{_method_name(it.func)}())"))
    return diags


# ---------------------------------------------------------------------------
# NNL502 — unvalidated wire-derived sizes
# ---------------------------------------------------------------------------

def _is_recv_call(node: ast.Call) -> bool:
    method = _method_name(node.func)
    if method in _RECV_NAMES:
        return True
    name = node.func.id if isinstance(node.func, ast.Name) else ""
    return ("read_exact" in name or "recv_exact" in name
            or name in _MSG_READ_RE)


def _walk_outside_len(node: ast.AST):
    """ast.walk that does not descend into ``len(...)`` calls — the
    length of an already-received buffer is bounded by what actually
    arrived, so it never re-taints a size."""
    stack = [node]
    while stack:
        n = stack.pop()
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "len"):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _taint_seed(node: ast.expr, mod: _ModuleWire) -> bool:
    """True when ``node`` contains an unpack / recv / from_bytes call —
    its value came off the wire."""
    for sub in _walk_outside_len(node):
        if not isinstance(sub, ast.Call):
            continue
        side, _fmt = mod._classify_struct_call(sub)
        if side == "unpack":
            return True
        if _is_recv_call(sub):
            return True
        if _dotted(sub.func).endswith("from_bytes"):
            return True
    return False


def _check_wire_sizes(fn: ast.FunctionDef, mod: _ModuleWire,
                      display: str) -> List[Diagnostic]:
    # 1. taint: names assigned (directly or transitively, two fixpoint
    #    sweeps) from unpack/recv results
    tainted: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            if value is None:
                continue
            hit = _taint_seed(value, mod) or any(
                isinstance(s, ast.Name) and s.id in tainted
                for s in _walk_outside_len(value))
            if not hit:
                continue
            for t in targets:
                elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t])
                for e in elts:
                    if isinstance(e, ast.Name):
                        tainted.add(e.id)
    if not tainted:
        return []
    # 2. guards: a name compared anywhere in the function (if/while/
    #    assert bound checks) or clamped via min()/max() counts as
    #    validated — flow-insensitive on purpose (low false positives)
    guarded: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and sub.id in tainted:
                    guarded.add(sub.id)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name)
              and node.func.id in ("min", "max")):
            for a in node.args:
                for sub in ast.walk(a):
                    if isinstance(sub, ast.Name) and sub.id in tainted:
                        guarded.add(sub.id)
    live = tainted - guarded
    if not live:
        return []
    # 3. sinks
    diags: List[Diagnostic] = []

    def flag(node: ast.AST, name: str, sink: str) -> None:
        diags.append(make(
            "NNL502",
            f"wire-derived size '{name}' flows into {sink} with no "
            f"bounds check in '{fn.name}' — a hostile peer's length "
            "field drives the allocation directly",
            location=display, line=node.lineno, col=node.col_offset,
            hint="compare against a declared limit (MAX_TENSORS / "
                 "MAX_META_BYTES / MAX_PAYLOAD_BYTES style) and raise "
                 "the typed FrameError before allocating",
            fix_hint=f"add 'if {name} > <declared MAX>: raise "
                     "FrameError(...)' before this use"))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            fname = (node.func.id if isinstance(node.func, ast.Name)
                     else "")
            dotted = _dotted(node.func)
            args_kw = list(node.args) + [kw.value for kw in node.keywords]
            live_arg = next(
                (a.id for a in args_kw
                 if isinstance(a, ast.Name) and a.id in live), None)
            if live_arg is None:
                continue
            # NOTE: bytes()/bytearray()/memoryview() of a tainted value
            # are NOT sinks — a received buffer's copy is bounded by
            # what actually arrived; only *integer* sizes bomb
            if fname == "range":
                flag(node, live_arg, "range()")
            elif dotted.endswith("frombuffer") or dotted.endswith("empty") \
                    or dotted.endswith("zeros"):
                flag(node, live_arg, f"{dotted}()")
            elif _is_recv_call(node):
                flag(node, live_arg, "a sized socket read")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            for side, other in ((node.left, node.right),
                                (node.right, node.left)):
                if (isinstance(side, ast.Name) and side.id in live
                        and isinstance(other, ast.Constant)
                        and isinstance(other.value, (bytes, str))):
                    flag(node, side.id, "a byte-string multiply")
    return diags


# ---------------------------------------------------------------------------
# NNL503 — unbounded recv paths
# ---------------------------------------------------------------------------

def _check_recv_contract(fn: ast.FunctionDef, mod: _ModuleWire,
                         display: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    diags += _check_partial_read_loops(fn, display)
    diags += _check_handshake_deadline(fn, display)
    diags += _check_untyped_unpack(fn, display)
    return diags


def _check_partial_read_loops(fn: ast.FunctionDef, display: str
                              ) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for loop in ast.walk(fn):
        if not isinstance(loop, ast.While):
            continue
        # recv result names assigned inside the loop
        recv_names: List[Tuple[str, ast.Assign]] = []
        for node in ast.walk(loop):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _method_name(node.value.func) in _RECV_NAMES):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        recv_names.append((t.id, node))
        for name, assign in recv_names:
            # an If on the recv result that breaks/returns/raises =
            # the EOF progress check (recv returning b'' must exit)
            handled = False
            for node in ast.walk(loop):
                if not isinstance(node, ast.If):
                    continue
                touches = any(isinstance(s, ast.Name) and s.id == name
                              for s in ast.walk(node.test))
                exits = any(isinstance(s, (ast.Return, ast.Raise,
                                           ast.Break))
                            for s in ast.walk(node))
                if touches and exits:
                    handled = True
                    break
            if not handled:
                diags.append(make(
                    "NNL503",
                    f"partial-read loop in '{fn.name}' never checks "
                    f"'{name}' for EOF — recv() returns b'' forever on "
                    "a half-closed peer and the loop spins without "
                    "progress",
                    location=display, line=assign.lineno,
                    col=assign.col_offset,
                    hint="an empty read must exit the loop with the "
                         "typed error (TornFrameError mid-frame, None/"
                         "ConnectionError at a frame boundary)",
                    fix_hint=f"add 'if not {name}: raise "
                             "TornFrameError(...)' (or return the "
                             "typed EOF) inside the loop"))
    return diags


def _check_handshake_deadline(fn: ast.FunctionDef, display: str
                              ) -> List[Diagnostic]:
    """A message-level read (recv_msg/_read_packet style) on a
    *parameter* socket — the accept-side handshake shape — needs a
    ``settimeout`` deadline first: a silent hostile peer otherwise parks
    the worker thread forever."""
    params = {a.arg for a in (fn.args.args + fn.args.kwonlyargs)}
    params.discard("self")
    if not params:
        return []
    # lines where <param>.settimeout(...) is called
    deadline_lines: Dict[str, int] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and _method_name(node.func) == "settimeout"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in params):
            p = node.func.value.id
            deadline_lines[p] = min(deadline_lines.get(p, node.lineno),
                                    node.lineno)
    diags: List[Diagnostic] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in _MSG_READ_RE):
            continue
        arg0 = node.args[0] if node.args else None
        if not (isinstance(arg0, ast.Name) and arg0.id in params):
            continue
        first_deadline = deadline_lines.get(arg0.id)
        if first_deadline is None or first_deadline > node.lineno:
            diags.append(make(
                "NNL503",
                f"'{fn.name}' reads a message from parameter socket "
                f"'{arg0.id}' with no prior settimeout deadline — a "
                "peer that connects and sends nothing parks this "
                "thread forever (no typed error, no reclaim)",
                location=display, line=node.lineno, col=node.col_offset,
                hint="set a handshake deadline before the first read, "
                     "reset to None once the peer proved live",
                fix_hint=f"call {arg0.id}.settimeout(<handshake "
                         "deadline>) before this read (and "
                         f"{arg0.id}.settimeout(None) after the "
                         "handshake completes)"))
            break  # one finding per function is enough
    return diags


def _check_untyped_unpack(fn: ast.FunctionDef, display: str
                          ) -> List[Diagnostic]:
    """``unpack_from`` on wire bytes in a function that reads from a
    socket, outside any try that catches ``struct.error`` — a short
    frame kills the reader thread with an untyped exception."""
    touches_socket = any(
        isinstance(n, ast.Call) and _is_recv_call(n)
        for n in ast.walk(fn))
    if not touches_socket:
        return []
    # map: every node inside a try BODY whose handlers catch
    # struct.error (or broader)
    covered: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        catches = False
        for h in node.handlers:
            names: List[str] = []
            if h.type is None:
                catches = True
                break
            types = (h.type.elts if isinstance(h.type, ast.Tuple)
                     else [h.type])
            names = [_dotted(t) for t in types]
            if any(n in ("struct.error", "Exception", "BaseException")
                   for n in names):
                catches = True
                break
        if not catches:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                covered.add(id(sub))
    diags: List[Diagnostic] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and (_dotted(node.func) == "struct.unpack_from"
                     or _method_name(node.func) == "unpack_from")):
            continue
        if id(node) in covered:
            continue
        diags.append(make(
            "NNL503",
            f"unpack_from in socket-reading '{fn.name}' can raise "
            "struct.error on a short frame — it escapes the typed "
            "contract and kills the reader thread",
            location=display, line=node.lineno, col=node.col_offset,
            hint="a malformed peer frame must become a typed error "
                 "(log-and-drop or ConnectionError), never an "
                 "unhandled struct.error",
            fix_hint="wrap the parse in try/except struct.error and "
                     "convert to the typed error (or drop the frame "
                     "with a warning)"))
    return diags


# ---------------------------------------------------------------------------
# NNL504 — encode/decode asymmetry & negotiation fallback
# ---------------------------------------------------------------------------

def _literal_keys_written(fn: ast.FunctionDef) -> Dict[str, ast.AST]:
    keys: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.setdefault(k.value, k)
        elif (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            keys.setdefault(node.slice.value, node)
    return keys


def _literal_keys_read(fn: ast.FunctionDef) -> Dict[str, ast.AST]:
    keys: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            keys.setdefault(node.slice.value, node)
        elif (isinstance(node, ast.Call)
                and _method_name(node.func) in ("get", "pop")
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            keys.setdefault(node.args[0].value, node)
        elif (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and isinstance(node.left, ast.Constant)
                and isinstance(node.left.value, str)):
            keys.setdefault(node.left.value, node)
    return keys


def _check_codec_symmetry(mod: _ModuleWire, display: str
                          ) -> List[Diagnostic]:
    """Literal field keys written by the module's encode side vs read by
    its decode side. Only fires in modules that HAVE both sides (a codec
    module); pure senders/receivers are exempt."""
    enc_fns = [f for f in mod.functions
               if _name_tokens(f.name) & _ENCODE_TOKENS]
    dec_fns = [f for f in mod.functions
               if _name_tokens(f.name) & _DECODE_TOKENS]
    if not enc_fns or not dec_fns:
        return []
    written: Dict[str, Tuple[ast.AST, str]] = {}
    for f in enc_fns:
        for k, node in _literal_keys_written(f).items():
            written.setdefault(k, (node, f.name))
    read: Dict[str, Tuple[ast.AST, str]] = {}
    for f in dec_fns:
        for k, node in _literal_keys_read(f).items():
            read.setdefault(k, (node, f.name))
    # decode-side functions may legitimately read keys a *remote*
    # encoder writes — asymmetry only fires when the module writes keys
    # AND reads keys and a written key has no reader (write-only fields
    # are dead wire weight AND a drift hazard: the reader was renamed)
    diags: List[Diagnostic] = []
    if not written or not read:
        return []
    for k, (node, fname) in sorted(written.items()):
        if k in read:
            continue
        diags.append(make(
            "NNL504",
            f"field key '{k}' is written by encoder '{fname}' but no "
            "decode-side function in this module reads it — either "
            "dead wire weight or a renamed reader (the asymmetry "
            "ships silently)",
            location=display, line=getattr(node, "lineno", None),
            col=getattr(node, "col_offset", None),
            hint="read the key in the paired decoder, or drop it from "
                 "the encoder",
            fix_hint=f"add the '{k}' read to the decode side (or "
                     "delete the write); keep encode/decode key sets "
                     "symmetric"))
    return diags


def _check_caps_fallback(fn: ast.FunctionDef, display: str
                         ) -> List[Diagnostic]:
    """Hard ``caps["key"]`` indexing in a decode/parse-side negotiation
    function: an old peer that echoed the offer verbatim (or omitted the
    key) raises KeyError instead of falling back to the legacy path."""
    if not (_name_tokens(fn.name) & _DECODE_TOKENS):
        return []
    params = {a.arg for a in (fn.args.args + fn.args.kwonlyargs)}
    params.discard("self")
    diags: List[Diagnostic] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
                and isinstance(node.value, ast.Name)
                and node.value.id in params):
            continue
        key = node.slice.value
        diags.append(make(
            "NNL504",
            f"'{fn.name}' hard-indexes negotiation field "
            f"['{key}'] — a legacy peer that omits the key (or echoes "
            "the offer verbatim) raises KeyError instead of taking the "
            "fallback path",
            location=display, line=node.lineno, col=node.col_offset,
            hint="negotiation fields are optional by contract: use "
                 ".get with the legacy default",
            fix_hint=f"replace with .get('{key}') and branch to the "
                     "legacy/JSON fallback when absent"))
    return diags
