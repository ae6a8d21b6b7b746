"""Elementwise tensor-stream ops as plain torch functions (L3 compute).

Reference analog: the ORC SIMD kernels behind ``tensor_transform``
(gst/nnstreamer/elements/nnstreamer-orc.orc + the macro dispatch in
gsttensor_transform.c:460-490). Each ``make_*`` returns ``fn(x) -> y`` on a
``torch.Tensor``; it runs where the tensor lies (the card, the CPU, or
``device="meta"`` for shape and dtype inference) and never writes into
its input.

The dtypes follow nnstreamer_tpu's element, which runs these modes under
``jax.jit`` with 64-bit types off (its ``transform_ops.py``):

* every 64-bit type becomes its 32-bit sibling (:func:`canonical_dtype`):
  a ``typecast`` to float64 gives float32, to int64 int32, to uint64
  uint32, and a float64 input is float32 before any mode runs;
* a Python int meets an integer tensor in the tensor's dtype and wraps
  (uint8 11 + 250 = 5; a bound of -1 on uint8 is 255);
* a Python float promotes an integer tensor to float32, and ``div``
  always does (true division);
* an integer tensor raised to a negative integer power is a TypeError;
* a float becomes an integer by truncation, saturated at the type's
  bounds, NaN as 0 (XLA's conversion; PyTorch's own wraps);
* ``div:V`` multiplies by the reciprocal of V rounded in the tensor's
  dtype, as XLA compiles a division by a constant.

Upstream NNStreamer keeps float64 and int64; this package follows the
reference it is held against. uint16/uint32 arithmetic, which PyTorch
does not implement, runs in int64 and wraps back.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..core import DataType
from ..core.data import parse_number

_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}
# unsigned types PyTorch converts but does not compute in
_WIDE = (torch.uint16, torch.uint32)


def canonical_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype nnstreamer_tpu computes in for ``dtype``: 64-bit types
    map to their 32-bit siblings."""
    return _CANONICAL.get(dtype, dtype)


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its canonical dtype (a copy only when that differs)."""
    dt = canonical_dtype(x.dtype)
    return x if dt is x.dtype else x.to(dt)


def _is_int(x: torch.Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex())


def _wrap(v: int, dtype: torch.dtype) -> int:
    """A Python int as ``dtype`` holds it (two's-complement wrap)."""
    bits = dtype.itemsize * 8
    v %= 1 << bits
    if dtype.is_signed and v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def computable(x: torch.Tensor) -> torch.Tensor:
    """``x``, or ``x`` as int64 where PyTorch has no arithmetic for its
    dtype (uint16, uint32)."""
    return x.to(torch.int64) if x.dtype in _WIDE else x


def _int_op(y: torch.Tensor, fn: Callable) -> torch.Tensor:
    """``fn`` on an integer tensor in its own dtype; uint16/uint32 go
    through int64 and wrap back."""
    return fn(computable(y)).to(y.dtype)


def _cast(x: torch.Tensor, target: torch.dtype) -> torch.Tensor:
    """``x.to(target)``; float to integer saturates as XLA's does."""
    if _is_int(x) or target.is_floating_point or target.is_complex:
        return x.to(target)
    info = torch.iinfo(target)
    wide = torch.nan_to_num(x.real.to(torch.float64), nan=0.0,
                            posinf=info.max, neginf=info.min)
    return wide.clamp(info.min, info.max).to(torch.int64).to(target)


def make_typecast(dtype: DataType) -> Callable:
    target = canonical_dtype(dtype.torch_dtype)

    def fn(x):
        return _cast(x, target)

    return fn


def make_dimchg(from_dim: int, to_dim: int) -> Callable:
    """Move axis ``from_dim`` to position ``to_dim``.

    NOTE on conventions: the reference's dimchg indexes dims lowest-first
    ("0:3" = NCHW->NHWC style moves, gsttensor_transform.h:57-67); these
    are row-major Python axes counted from the end when negative, as in
    nnstreamer_tpu.
    """

    def fn(x):
        return torch.movedim(x, from_dim, to_dim)

    return fn


def make_transpose(axes: Sequence[int]) -> Callable:
    axes_t = tuple(axes)

    def fn(x):
        return x.permute(axes_t).contiguous()

    return fn


def _raw_op(op: str, y: torch.Tensor, val):
    if op == "add":
        return y + val
    if op == "sub":
        return y - val
    if op == "mul":
        return y * val
    if op == "div":
        # XLA folds a division by a constant into a multiplication by its
        # reciprocal, rounded in the tensor's dtype; so does this
        return y * torch.tensor(val, dtype=y.dtype).reciprocal().item()
    return y ** val


def _arith_apply(op: str, y: torch.Tensor, val):
    if op not in ("add", "sub", "mul", "div", "pow"):
        raise ValueError(f"unknown arithmetic op '{op}'")
    if _is_int(y):
        if op == "div" or isinstance(val, float):
            y = y.to(torch.float32)
        elif op == "pow" and val < 0:
            raise TypeError(
                f"Integers cannot be raised to negative powers, got "
                f"pow:{val} on {y.dtype}")
        else:
            return _int_op(y, lambda t: _raw_op(op, t, val))
    return _raw_op(op, y, val)


def make_arithmetic(ops: Sequence[Tuple],
                    out_dtype: DataType | None = None,
                    per_channel_dim: int | None = None) -> Callable:
    """Chained scalar arithmetic: entries ``(op, value[, channel])`` — the
    reference's operator-chain syntax ``add:1,mul:0.5`` plus per-channel
    ops (``per-channel:true@DIM,add:V@CH``): with ``per_channel_dim`` set,
    an entry carrying a channel index applies only to that slice of the
    channel axis, and its result is stored in the tensor's dtype. The
    reference counts dims lowest-first (dim 0 = the fastest-varying axis,
    e.g. RGB channels of ``3:W:H:1``) — Python axis ``ndim - 1 - DIM``. A
    channel outside the axis changes nothing, as in nnstreamer_tpu."""

    def fn(x):
        y = x
        if out_dtype is not None:
            y = _cast(y, canonical_dtype(out_dtype.torch_dtype))
        elif _is_int(x) or x.dtype is torch.bfloat16:
            # the reference promotes every input that is not a numpy
            # floating type to float32: integers, and bfloat16 too
            y = y.to(torch.float32)
        for entry in ops:
            op, val, ch = entry if len(entry) == 3 else (*entry, None)
            if ch is None or per_channel_dim is None:
                y = _arith_apply(op, y, val)
                continue
            axis = y.ndim - 1 - per_channel_dim
            if not 0 <= axis < y.ndim:
                raise ValueError(
                    f"per-channel dim {per_channel_dim} out of range "
                    f"for rank-{y.ndim} tensor")
            if not -y.shape[axis] <= ch < y.shape[axis]:
                continue
            # the result is stored in y's dtype, as JAX's .at[].set
            # stores it
            part = _cast(_arith_apply(op, y.select(axis, ch), val), y.dtype)
            y = y.clone()
            work = computable(y)
            work.select(axis, ch).copy_(part.to(work.dtype))
            y = work.to(y.dtype)
        return y

    return fn


def make_stand(mode: str = "default", per_channel: bool = False) -> Callable:
    """Standardization: zero-mean/unit-variance ("default") or dc-removal
    ("dc-average") — reference stand mode. The standard deviation is the
    population one (``correction=0``), as ``jnp.std``'s."""

    def fn(x):
        xf = x.to(torch.float32)
        dims = tuple(range(xf.ndim - 1)) if per_channel else None
        if dims == ():
            # a rank-1 tensor has no axis to reduce per channel (torch
            # would read dim=() as every axis): each element is its mean
            mean, std = xf, torch.zeros_like(xf)
        else:
            std, mean = torch.std_mean(xf, dim=dims, correction=0,
                                       keepdim=per_channel)
        if mode == "dc-average":
            return xf - mean
        return (xf - mean) / torch.clamp(std, min=1e-10)

    return fn


def make_clamp(lo, hi) -> Callable:
    def fn(x):
        if _is_int(x):
            if isinstance(lo, float) or isinstance(hi, float):
                x = x.to(torch.float32)
            else:
                a, b = _wrap(lo, x.dtype), _wrap(hi, x.dtype)
                return _int_op(x, lambda t: torch.clamp(t, a, b))
        return torch.clamp(x, lo, hi)

    return fn


def make_padding(pads: Sequence[Tuple[int, int]], value: float = 0.0) -> Callable:
    pads_t = tuple((int(a), int(b)) for a, b in pads)

    def fn(x):
        if any(a < 0 or b < 0 for a, b in pads_t):
            raise ValueError(f"padding {pads_t} holds a negative width")
        widths = pads_t * x.ndim if len(pads_t) == 1 else pads_t
        if len(widths) != x.ndim:
            raise ValueError(f"padding {pads_t} has {len(pads_t)} axis "
                             f"pairs for a rank-{x.ndim} tensor")
        fill = _wrap(int(value), x.dtype) if _is_int(x) else value
        work = computable(x)
        out = torch.full([n + a + b for n, (a, b) in zip(x.shape, widths)],
                         fill, dtype=work.dtype, device=x.device)
        out[tuple(slice(a, a + n) for n, (a, _) in zip(x.shape, widths))] = work
        return out.to(x.dtype)

    return fn


# -- option-string parsing (reference gsttensor_transform.c property syntax) --

def parse_transform_options(mode: str, option: str):
    """Parse the ``option=`` string for a transform ``mode`` into a maker call.

    Syntax parity (gsttensor_transform.h:57-67 modes):
      * typecast: ``option=uint8``
      * arithmetic: ``option=typecast:float32,add:-127.5,div:127.5``
      * transpose: ``option=1:0:2`` (axis order)
      * dimchg: ``option=0:2`` (move axis 0 to 2)
      * stand: ``option=default`` | ``dc-average`` [``:per-channel``]
      * clamp: ``option=lo:hi``
      * padding: ``option=a0lo:a0hi,a1lo:a1hi,...`` [``,value:v``]
    """
    if mode == "typecast":
        return make_typecast(DataType.from_any(option.strip()))
    if mode == "arithmetic":
        ops: List[Tuple] = []
        out_dtype = None
        pc_dim = None
        for part in option.split(","):
            part = part.strip()
            if not part:
                continue
            op, _, val = part.partition(":")
            op = op.strip().lower()
            if op == "typecast":
                out_dtype = DataType.from_any(val.strip())
            elif op == "per-channel":
                # reference grammar: per-channel:(false|true@DIM) — only
                # enabled when the @DIM is present (gsttensor_transform.c
                # :760-768 requires num_values > 1)
                flag, _, dim = val.partition("@")
                if flag.strip().lower() == "true" and dim:
                    pc_dim = int(dim)
            else:
                # reference grammar: op:NUMBER[@CH_IDX][:NUMBER...] — the
                # value is values[0]; @CH binds the op to one channel in
                # per-channel mode (gsttensor_transform.c:790-812)
                first = val.split(":")[0]
                num, _, ch = first.partition("@")
                ops.append((op, parse_number(num),
                            int(ch) if ch else None))
        return make_arithmetic(ops, out_dtype, per_channel_dim=pc_dim)
    if mode == "transpose":
        try:
            axes = [int(p) for p in option.split(":")]
        except ValueError:
            raise ValueError(f"transpose option '{option}' is not a "
                             "':'-separated axis list")
        # the reference rejects non-permutation axis lists at property-set
        # time (gsttensor_transform.c mode option parse, expectFail corpus
        # lines)
        if sorted(axes) != list(range(len(axes))) or len(axes) < 2:
            raise ValueError(
                f"transpose option '{option}' must be a permutation of "
                f"0..{max(len(axes) - 1, 1)}")
        return make_transpose(axes)
    if mode == "dimchg":
        frm, _, to = option.partition(":")
        return make_dimchg(int(frm), int(to))
    if mode == "stand":
        parts = option.split(":")
        return make_stand(parts[0] or "default",
                          per_channel=("per-channel" in parts))
    if mode == "clamp":
        lo, _, hi = option.partition(":")
        return make_clamp(parse_number(lo), parse_number(hi))
    if mode == "padding":
        pads = []
        value = 0.0
        for part in option.split(","):
            part = part.strip()
            if part.startswith("value:"):
                value = parse_number(part.split(":", 1)[1])
            elif part:
                lo, _, hi = part.partition(":")
                pads.append((int(lo), int(hi)))
        return make_padding(pads, value)
    raise ValueError(f"unknown transform mode '{mode}'")
