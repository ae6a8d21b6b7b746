"""Shape-polymorphic ``torch.export`` of a stage, and its loading (L4').

The counterpart of nnstreamer_tpu's ``aot/export.py``. The producing half
of the AOT artifact plane: a stage callable (a fused segment's composed
function, a singleton filter's model) is traced ONCE by
``torch.export.export`` with a **symbolic batch dimension** and saved as
the bytes of ``torch.export.save`` (an ``ExportedProgram``, weights
included); the consuming half loads those bytes and serves through the
program's module, run eagerly — no Python re-trace of the model, and ONE
artifact covers every batch size its recorded range holds.

Poly-dim rules (as the reference's):

* dimension 0 of every rank >= 1 tensor leaf is exported as ONE shared
  symbol ``b`` (all leading dims are the same batch); trailing dims stay
  concrete; rank-0 leaves have no batch axis and stay concrete;
* the trace runs with ``backed_size_oblivious`` on, so an example batch
  of 1 (or 2) does not specialize the symbol: without it torch 0/1-
  specializes a batch-1 example and ranges a batch-2 one at [2, inf).
  Where the computation itself guards ``b != 1`` (``.contiguous()`` on
  a permuted tensor does), a symbol from 1 up is refused and the export
  is tried again with the symbol from 2 up. The range is recorded
  (``meta["batch_range"]``) and :meth:`LoadedArtifact.compatible`
  refuses what it excludes;
* a computation whose result depends on the concrete batch (a fixed
  reshape, a lookup keyed by shape, a host read) fails symbolic export:
  :func:`export_stage` then exports statically for the observed
  signature (``meta["poly"]`` False: the artifact still spares a
  restart the trace, for that one signature), and a stage that exports
  neither way raises :class:`ExportError` — the caller serves live and
  reports it.

The hand kernels are torch ops (``nns::decode_attention``,
``nns::flash_attention``, ``nns::fma_gemm``, ``nns::depthwise_fma``):
an exported program holds one node per launch, and its loaded module
launches the kernels. ``torch.export.load`` needs those ops registered
before it resolves the graph, so :func:`load_artifact` imports the ops'
modules first; a load that still meets an unknown op raises
:class:`ExportError`.

AOTInductor and ``torch.compile`` are not used: the artifact is the
``ExportedProgram``, run eagerly after ``.module()`` (a card's fused
segment then captures that module in its CUDA graph as it would the live
stages).
"""
from __future__ import annotations

import io
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ..utils.log import logger

#: meta-schema marker for the symbolic batch dim in recorded shapes
_SYM = "b"


class ExportError(RuntimeError):
    """The stage could not be exported (neither poly nor static), or an
    artifact could not be loaded."""


def _register_ops() -> None:
    """Import the modules that register the ``nns::`` ops: a fresh
    process must know them before ``torch.export.load`` resolves a
    graph that calls them."""
    from ..ops import (  # noqa: F401 - registration is the import
        decode_attention,
        depthwise_fma,
        flash_attention,
        fma_gemm,
    )


class _Stage(torch.nn.Module):
    """``fn`` as a module: one argument, the positional-argument tuple
    (so the exported module is called as ``module(args)`` whatever the
    arity); the result as a tuple."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, args):
        out = self.fn(*args)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _poly_specs(args: tuple, min_batch: int = 0):
    """dynamic_shapes mirroring ``args``: dim 0 of every rank >= 1 leaf
    is ONE shared batch Dim (the reference's ``_poly_arg_specs``), from
    ``min_batch`` up."""
    b = torch.export.Dim(_SYM, min=min_batch) if min_batch else \
        torch.export.Dim(_SYM)
    return (pytree.tree_map(lambda t: {0: b} if t.dim() else None, args),)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _cells(vals, sym_dims=()) -> List[dict]:
    """Serializable (shape, dtype) cells; a dim that is a symbol renders
    as ``"b"``."""
    cells = []
    for v in vals:
        shape = []
        for d in v.shape:
            if isinstance(d, torch.SymInt) or str(d) in sym_dims:
                shape.append(_SYM)
            else:
                shape.append(int(d))
        cells.append({"shape": shape, "dtype": _dtype_name(v.dtype)})
    return cells


def _program_avals(program) -> Tuple[List[dict], List[dict], Optional[list]]:
    """(in cells, out cells, batch range) read from an ExportedProgram's
    graph: the user inputs' and outputs' fake values, the symbol's
    range from ``range_constraints`` (upper None = unbounded)."""
    user_inputs = set(program.graph_signature.user_inputs)
    ins = [n.meta["val"] for n in program.graph.nodes
           if n.op == "placeholder" and n.name in user_inputs]
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in pytree.tree_leaves(out_node.args[0])
            if hasattr(a, "meta") and isinstance(a.meta.get("val"),
                                                 torch.Tensor)]
    syms = set()
    for v in ins:
        for d in v.shape:
            if isinstance(d, torch.SymInt):
                syms.add(str(d))
    rng = None
    for sym, vr in program.range_constraints.items():
        if str(sym) in syms:
            hi = str(vr.upper)
            lo, hi = int(str(vr.lower)), None if "oo" in hi else int(hi)
            if rng is not None:   # one range that every symbol admits
                lo = max(lo, rng[0])
                hi = rng[1] if hi is None else \
                    hi if rng[1] is None else min(hi, rng[1])
            rng = [lo, hi]
    return _cells(ins), _cells(outs), rng


class LoadedArtifact:
    """An exported (or loaded) stage program ready to serve.

    ``call(*args)`` runs the program's module eagerly. ``compatible(args)``
    checks concrete positional arguments against the recorded inputs:
    structure, dtypes, ranks and every non-symbolic dim must match; the
    symbolic batch accepts any size >= 1 inside the recorded range."""

    __slots__ = ("program", "module", "poly", "in_avals", "out_avals",
                 "batch_range")

    def __init__(self, program, poly: Optional[bool] = None):
        self.program = program
        self.module = program.module()
        self.in_avals, self.out_avals, self.batch_range = \
            _program_avals(program)
        self.poly = bool(poly) if poly is not None else any(
            _SYM in c["shape"] for c in self.in_avals)

    def call(self, *args):
        return self.module(args)

    def compatible(self, args: tuple) -> bool:
        leaves = pytree.tree_leaves(args)
        if len(leaves) != len(self.in_avals):
            return False
        lo, hi = self.batch_range or (1, None)
        for x, cell in zip(leaves, self.in_avals):
            if not isinstance(x, torch.Tensor):
                x = _as_tensor(x)
            shape, want = tuple(x.shape), cell["shape"]
            if len(shape) != len(want):
                return False
            if _dtype_name(x.dtype) != cell["dtype"]:
                return False
            for got, w in zip(shape, want):
                if w == _SYM:
                    if got < max(1, lo) or (hi is not None and got > hi):
                        return False
                elif got != w:
                    return False
        return True

    def __repr__(self):
        return (f"LoadedArtifact<poly={self.poly} "
                f"in={len(self.in_avals)} avals>")


def _own_storage(program) -> None:
    """Give every constant of ``program`` a dense storage of its own. A
    weight laid on a padded pitch (``ops/fma_gemm.py::padded_rows``) is a
    view of a larger storage, and torch 2.11's ``torch.export.save``
    writes only ``numel`` elements of it, which its ``load`` then
    refuses (strides past the storage). The graph reads the values, not
    the layout; the kernels take any row pitch."""
    for name, t in list(program.constants.items()):
        if isinstance(t, torch.Tensor) and (
                not t.is_contiguous() or t.storage_offset()
                or t.untyped_storage().nbytes()
                != t.numel() * t.element_size()):
            program.constants[name] = t.clone(
                memory_format=torch.contiguous_format)


def guarded(loaded: "LoadedArtifact", live: Callable) -> Callable:
    """``serve(*args)``: the artifact while it covers the arguments, else
    ``live`` — a poly artifact symbolizes only the batch dim, so a stream
    whose trailing dims vary keeps the live path instead of an input-
    check error in the hot loop. The verdict is memoized per signature:
    the check runs once per NEW shape, never per buffer."""
    verdicts: dict = {}

    def serve(*args):
        sig = tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                    else type(x) for x in pytree.tree_leaves(args))
        ok = verdicts.get(sig)
        if ok is None:
            if len(verdicts) > 512:  # flexible streams: bound the memo
                verdicts.clear()
            ok = verdicts[sig] = loaded.compatible(args)
        return loaded.call(*args) if ok else live(*args)
    serve.loaded = loaded
    return serve


def _export(module: torch.nn.Module, args: tuple, poly: bool):
    if not poly:
        return torch.export.export(module, (args,))
    from torch.fx.experimental import _config as fx_config

    with fx_config.patch(backed_size_oblivious=True):
        try:
            return torch.export.export(module, (args,),
                                       dynamic_shapes=_poly_specs(args))
        except Exception:  # noqa: BLE001 - a guard of b != 1
            return torch.export.export(
                module, (args,), dynamic_shapes=_poly_specs(args, 2))


def _device_of(args: tuple) -> str:
    for t in pytree.tree_leaves(args):
        if isinstance(t, torch.Tensor):
            return str(t.device)
    return "cpu"


def export_stage(fn: Callable, example_args: tuple, poly: bool = True
                 ) -> Tuple[bytes, dict, "LoadedArtifact"]:
    """Export ``fn`` (called as ``fn(*example_args)``) and save it.
    Returns ``(blob, meta, loaded)``: ``loaded`` is the freshly exported
    program, so the exporting process serves through the same graph a
    warm restart loads.

    ``poly=True`` tries the symbolic-batch export first and falls back to
    a static one when the computation rejects a symbolic batch;
    ``meta["poly"]`` records which. Raises :class:`ExportError` when
    neither exports. The trace runs under ``torch.no_grad()`` (serving
    computes no gradient)."""
    args = pytree.tree_map(_as_tensor, tuple(example_args))
    module = _Stage(fn)
    program = None
    is_poly = False
    poly_err: Optional[BaseException] = None
    with torch.no_grad():
        if poly and any(t.dim() for t in pytree.tree_leaves(args)):
            try:
                program = _export(module, args, True)
                is_poly = True
            except Exception as e:  # noqa: BLE001 - fall back to static
                poly_err = e

        if program is None:
            try:
                program = _export(module, args, False)
            except Exception as e:  # noqa: BLE001 - reported as ExportError
                raise ExportError(
                    f"stage export failed (poly: {poly_err}; static: {e})"
                ) from e
            if poly_err is not None:
                logger.info("aot: symbolic-batch export rejected (%s) — "
                            "exported a static artifact instead",
                            str(poly_err).splitlines()[0][:200])
    # the example inputs would be saved with the program (a batch of
    # frames): the artifact keeps the graph and the weights only
    program.example_inputs = None
    _own_storage(program)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    loaded = LoadedArtifact(program, is_poly)
    meta = {
        "poly": is_poly,
        "in_avals": loaded.in_avals,
        "out_avals": loaded.out_avals,
        "batch_range": loaded.batch_range,
        "platforms": [_device_of(args)],
        "device": _device_of(args),
        "nbytes": len(blob),
    }
    return blob, meta, loaded


def load_artifact(blob: bytes, poly: Optional[bool] = None
                  ) -> LoadedArtifact:
    """Load ``torch.export.save`` bytes into a servable program. The
    ``nns::`` ops are registered first; ``poly`` is the meta hint (None:
    derived from the recorded inputs)."""
    try:
        _register_ops()
        missing = None
    except ImportError as e:
        missing = e
    try:
        program = torch.export.load(io.BytesIO(blob))
    except Exception as e:  # noqa: BLE001 - typed for the callers
        why = "" if missing is None else \
            f" (the nns:: kernel ops are not registered: {missing})"
        raise ExportError(f"artifact does not load{why}: {e}") from e
    return LoadedArtifact(program, poly)


def fabricate_inputs(meta: dict, batch: int = 1) -> List[Any]:
    """Zero arrays shaped like an artifact's recorded inputs, every
    symbolic dim set to ``batch`` (raised to the recorded range's lower
    end, so the warmup runs the program) — what a replica's warmup
    fabricates when its caps are not static. A flat list of numpy arrays
    (the wire carries flat tensor lists); bfloat16 as a CPU torch
    tensor."""
    import numpy as np

    lo = (meta.get("batch_range") or [1])[0]
    batch = max(int(batch), int(lo))
    out = []
    for cell in meta.get("in_avals", []):
        shape = tuple(int(batch) if isinstance(d, str) else int(d)
                      for d in cell["shape"])
        dt = cell["dtype"]
        if dt == "bfloat16":
            out.append(torch.zeros(shape, dtype=torch.bfloat16))
        else:
            out.append(np.zeros(shape, dtype=np.dtype(dt)))
    return out
