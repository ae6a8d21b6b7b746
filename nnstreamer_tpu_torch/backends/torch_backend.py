"""PyTorch execution backend (``framework=torch``, alias ``pytorch``).

The counterpart of nnstreamer_tpu's ``backends/jax_backend.py``: PyTorch on
the card is the pipeline's execution engine. Inputs move to the backend's
device once per frame, the model runs eagerly, and outputs stay on the
device so the next stage reads them there.

Model sources accepted by the ``model`` property:
  * ``builtin://<name>[?k=v...]`` — deterministic fake models mirroring the
    reference's test fixtures (tests/nnstreamer_example/custom_example_*)
    and nnstreamer_tpu's ``jax_backend.py`` builtins: passthrough, scaler
    (factor=), add (value=), average, argmax, matmul (n=), mlp (n=,
    layers=) and sleeper (ms=, factor=). They compute in nnstreamer_tpu's
    dtypes (64-bit types as 32-bit ones, see ops/transform_ops.py);
    matmul and mlp draw their weights from seeded CPU ``torch.Generator``s,
    from JAX's distribution (standard normal), the same on every device;
  * ``<module>:<attr>`` — an import path to a callable, or to an entry
    object with ``make(device)`` (e.g. ``models/lm_serving.py``), which
    builds the callable on the backend's device;
  * ``<file>.tflite`` — the flatbuffer rebuilt as torch ops on the
    backend's device (``models/tflite_import.py``), with nnstreamer_tpu's
    ``custom=`` options: ``quantized_exec:fake-quant|float|int8|
    int8-native``, ``batch:N``, ``precision:`` and ``float_output:``.
    ``int8-native`` runs the C++ engine on the host: its inputs cross to
    the host once per batch, its outputs stay there, its input shapes are
    fixed at load, and it never joins a fused segment.

Device choice (``_select_device``): ``accelerator=cpu`` runs on the CPU;
``custom=device:N`` pins ``cuda:N``; then the placement planner's card;
otherwise ``cuda:0``. Without a card,
opening fails unless the CPU was asked for — there is no quiet fallback.

Segment fusion (``runtime/fusion.py``): on a card a model joins a fused
segment's CUDA graph only when it declares ``capture_safe = True`` (the
zoo's entries and the builtins but ``sleeper`` do); any other model runs
its own eager invoke. On the CPU every model fuses.

Memory accounting (``obs/memory.py``): ``measure_next_invoke()`` arms a
measurement of the next invoke on the card, and ``memory_analysis()``
returns it as a :class:`~..obs.memory.MeasuredMemory` — the reference's
XLA query is static, this one is measured. On the CPU there is none.

Shape inference: caps negotiation must not run the model (at the ``base``
LM width one invoke is a whole 64-step generate). The served callable
declares a shape rule instead — an ``output_info(in_info)`` attribute
returning the output ``TensorsInfo`` — which costs no device work. A
callable without one gets flexible output caps.
"""
from __future__ import annotations

import importlib
import os
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core import DataType, TensorsInfo
from ..core.buffer import as_torch
from ..core.tensors import TensorSpec
from ..models.lm_serving import with_serve_knobs
from ..obs.memory import MeasuredMemory, tree_nbytes
from ..ops.transform_ops import canonicalize, computable
from ..utils.hw_accel import device_for_accelerator
from ..utils.log import logger
from .base import (Accelerator, BackendEvent, FilterBackend, FilterProperties,
                   register_backend)


def _apply_serve_knobs(entry, custom: dict, model: str):
    """``custom=serve_dtype:bfloat16,cache_len:640`` on a module:attr
    entry (models/lm_serving.py — bf16 weights+KV cache, right-sized
    cache)."""
    cl = custom.get("cache_len") or "0"
    try:
        cache_len = int(cl)
    except ValueError:
        raise ValueError(f"custom=cache_len:{cl!r} is not an integer")
    return with_serve_knobs(entry, custom.get("serve_dtype"), cache_len,
                            model)


def _as_float(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor as float32 (a Python float promotes it so in
    JAX); float tensors keep their dtype."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _normal(shape, seed: int, device) -> torch.Tensor:
    """Standard normal float32 weights from a CPU generator seeded with
    ``seed``: the same values on every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


class _Weights:
    """Weights of a builtin made on first use per (device, shape), or
    given (nnstreamer_tpu's values, through models/convert.py). Meta
    tensors get meta weights: shape inference draws nothing."""

    def __init__(self, given: Optional[Dict[str, Any]] = None):
        self._given = given or {}
        self._made: Dict[tuple, torch.Tensor] = {}

    def get(self, name: str, shape, seed: int, device) -> torch.Tensor:
        if device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        key = (name, tuple(shape), str(device))
        if key not in self._made:
            w = self._given.get(name)
            if w is None:
                w = _normal(shape, seed, device)
            elif tuple(w.shape) != tuple(shape):
                raise ValueError(f"builtin weight {name}: given "
                                 f"{tuple(w.shape)}, the input needs "
                                 f"{tuple(shape)}")
            self._made[key] = w.to(device)
        return self._made[key]


def _builtin_models() -> Dict[str, Callable]:
    """name → maker(params, weights) → ``fn(*tensors) -> tuple``."""

    def passthrough(params, weights):
        return lambda *xs: xs

    def scaler(params, weights):
        f = float(params.get("factor", 2.0))
        return lambda *xs: tuple(_as_float(x) * f for x in xs)

    def add(params, weights):
        v = float(params.get("value", 1.0))
        return lambda *xs: tuple(_as_float(x) + v for x in xs)

    def average(params, weights):
        # reference custom_example_average: mean over all non-batch axes
        def one(x):
            x = _as_float(x)
            if x.ndim <= 1:  # no non-batch axis: nothing to average
                return x
            return x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)

        return lambda *xs: tuple(one(x) for x in xs)

    def argmax(params, weights):
        def one(x):
            return torch.argmax(computable(x), dim=-1).to(torch.int32)

        return lambda *xs: tuple(one(x) for x in xs)

    def matmul(params, weights):
        n = int(params.get("n", 64))

        def fn(x):
            w = weights.get("w", (n, n), 0, x.device)
            dt = torch.promote_types(x.dtype, w.dtype)
            return (x.to(dt) @ w.to(dt),)

        return fn

    def mlp(params, weights):
        # nnstreamer_tpu's compile-bound stand-in (its weights fold at XLA
        # compile time); here an ordinary tanh MLP on the same weights'
        # distribution: w_in from seed layers+1, hidden i from seed i,
        # w_out from seed layers+2
        n = int(params.get("n", 256))
        layers = int(params.get("layers", 12))

        def one(x):
            h = x.reshape(x.shape[0], -1).to(torch.float32)
            dev = h.device
            w_in = weights.get("w_in", (h.shape[1], n), layers + 1, dev)
            h = torch.tanh(h @ (w_in * 0.1))
            for i in range(layers):
                w = weights.get(f"w{i}", (n, n), i, dev)
                h = torch.tanh(h @ (w * 0.05))
            return h @ weights.get("w_out", (n, 1), layers + 2, dev)

        return lambda *xs: tuple(one(x) for x in xs)

    def sleeper(params, weights):
        # a known fixed service time: sleeps on the host once per invoke
        # (never during shape inference), then scales by factor in the
        # input's dtype
        ms = float(params.get("ms", 5.0))
        f = float(params.get("factor", 1.0))

        def one(x):
            work = computable(x)
            return (work * torch.tensor(f).to(work.dtype)).to(x.dtype)

        def fn(*xs):
            if not any(x.is_meta for x in xs):
                time.sleep(ms / 1e3)
            return tuple(one(x) for x in xs)

        return fn

    return {
        "passthrough": passthrough,
        "scaler": scaler,
        "add": add,
        "average": average,
        "argmax": argmax,
        "matmul": matmul,
        "mlp": mlp,
        "sleeper": sleeper,
    }


class _Builtin:
    """A builtin:// model as the backend serves it: inputs in nnstreamer_tpu's
    dtypes, outputs as a tuple, and a shape rule that runs the model on
    meta tensors."""

    def __init__(self, fn: Callable, capture_safe: bool = True):
        self.fn = fn
        # a CUDA graph may capture it (runtime/fusion.py)
        self.capture_safe = capture_safe

    def __call__(self, *xs):
        return tuple(self.fn(*(canonicalize(x) for x in xs)))

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        metas = [torch.empty(s.shape, dtype=s.dtype.torch_dtype,
                             device="meta") for s in in_info.specs]
        return TensorsInfo.of(*(
            TensorSpec(tuple(o.shape), DataType.from_any(o.dtype))
            for o in self(*metas)))


def make_builtin(model: str, params: Optional[Dict[str, str]] = None,
                 weights: Optional[Dict[str, torch.Tensor]] = None
                 ) -> _Builtin:
    """``builtin://<name>[?k=v...]`` → the served callable. ``params``
    add to (and override) the URI's query; ``weights`` replace the drawn
    ones by name (matmul: ``w``; mlp: ``w_in``, ``w0``.., ``w_out``)."""
    parsed = urllib.parse.urlparse(model)
    name = parsed.netloc or parsed.path.lstrip("/")
    merged = dict(urllib.parse.parse_qsl(parsed.query))
    merged.update(params or {})
    builtins = _builtin_models()
    if name not in builtins:
        raise ValueError(
            f"unknown builtin model '{name}' (have: {sorted(builtins)})")
    # sleeper's host sleep would run once, at capture, and never again
    return _Builtin(builtins[name](merged, _Weights(weights)),
                    capture_safe=name != "sleeper")


class _HostNative:
    """A host-native model (``quantized_exec:int8-native``) as the backend
    serves it: card inputs are pulled to the host once per batch,
    explicitly; outputs are host tensors; the input contract is the one
    recorded at load (nnstreamer_tpu's jax backend refuses any other)."""

    host_native = True
    capture_safe = False

    def __init__(self, fn: Callable, in_info: TensorsInfo,
                 out_info: TensorsInfo):
        self.fn = fn
        self.in_info = in_info
        self.out_info = out_info

    def __call__(self, *xs):
        return tuple(torch.from_numpy(o) for o in self.fn(*xs))

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        if [(tuple(s.shape), s.dtype) for s in in_info.specs] == [
                (tuple(s.shape), s.dtype) for s in self.in_info.specs]:
            return self.out_info
        raise ValueError(
            "host-native model: input info is fixed at load "
            f"({self.in_info}); cannot retarget to {in_info}")


def _select_device(props: FilterProperties) -> torch.device:
    idx = props.custom_dict().get("device")
    if idx is None:
        if (props.placement_device is not None
                and props.accelerator is not Accelerator.CPU):
            return device_for_accelerator(f"cuda:{props.placement_device}")
        return device_for_accelerator(props.accelerator.value)
    if props.accelerator is Accelerator.CPU:
        raise ValueError(
            f"custom=device:{idx} names a CUDA device and conflicts "
            "with accelerator=cpu")
    try:
        i = int(idx)
    except ValueError:
        raise ValueError(f"custom=device:{idx!r} is not a device index")
    if i < 0:
        raise ValueError(f"custom=device:{i} must be >= 0")
    return device_for_accelerator(f"cuda:{i}")


@register_backend
class TorchBackend(FilterBackend):
    NAME = "torch"
    ALIASES = ("pytorch",)

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable] = None
        self._device: Optional[torch.device] = None
        # the module:attr object after the serve knobs were applied
        self.model_entry: Any = None
        # obs/memory.py: measure the next invoke on the card
        self._mem_arm = False
        self._mem_record: Optional[MeasuredMemory] = None
        # model info from the last set_input_info (get_model_info serves
        # it, as nnstreamer_tpu's jax backend does after eval_shape)
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        # callables a RELOAD_MODEL replaced: held until release_retired,
        # so queued device work never reads freed weights
        self._retired: List[Callable] = []

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        self._device = _select_device(props)
        self._fn = self._load_model(props.model, props)
        logger.info("torch backend opened model=%s device=%s",
                    props.model, self._device)

    def close(self) -> None:
        self._fn = None
        self.model_entry = None
        self._retired = []
        self._in_info = self._out_info = None
        super().close()

    @property
    def device(self) -> Optional[torch.device]:
        """The device this backend runs on."""
        return self._device

    def _load_model(self, model: str, props: FilterProperties) -> Callable:
        if model.startswith("builtin://"):
            return make_builtin(model, props.custom_dict())
        if ":" in model and not os.path.exists(model):
            mod_name, _, attr = model.partition(":")
            entry = getattr(importlib.import_module(mod_name), attr)
            entry = _apply_serve_knobs(entry, props.custom_dict(), model)
            self.model_entry = entry
            maker = getattr(entry, "make", None)
            return maker(device=self._device) if maker else entry
        if model.endswith(".tflite") and os.path.exists(model):
            from ..models.tflite_import import load_tflite

            fn, self._in_info, self._out_info = load_tflite(
                model, props.custom_dict(), device=self._device)
            if getattr(fn, "host_native", False):
                return _HostNative(fn, self._in_info, self._out_info)
            return fn
        raise ValueError(
            f"torch backend cannot load model '{model}' (expected "
            "'<module>:<attr>', 'builtin://<name>' or a .tflite file)")

    def get_model_info(self):
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> Optional[TensorsInfo]:
        rule = getattr(self._fn, "output_info", None)
        if rule is None:
            return None
        self._out_info = rule(in_info)
        self._in_info = in_info
        return self._out_info

    def handle_event(self, event: BackendEvent, data: Optional[dict] = None) -> None:
        if event is BackendEvent.RELOAD_MODEL:
            # reference RELOAD_MODEL (nnstreamer_plugin_api_filter.h:378-384):
            # old and new co-resident until the swap completes; the old
            # callable is retired, not dropped (release_retired)
            new_fn = self._load_model(self.props.model, self.props)
            self._retired.append(self._fn)
            self._fn = new_fn

    def release_retired(self) -> None:
        self._retired = []

    def invoke(self, inputs: List[Any]) -> List[Any]:
        if self._fn is None:
            raise RuntimeError("torch backend: invoke before open")
        if self._mem_arm:
            self._mem_arm = False
            return self._invoke_measured(inputs)
        if getattr(self._fn, "host_native", False):
            xs = [as_torch(x) for x in inputs]  # it pulls them itself
        else:
            xs = [as_torch(x).to(self._device) for x in inputs]
        with torch.inference_mode():
            out = self._fn(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def fusion_callable(self) -> Optional[Callable]:
        """The model as a fused segment's stage (``runtime/fusion.py``):
        ``fn(*xs) -> tuple`` under ``torch.inference_mode()``, as
        ``invoke`` runs it, on inputs the segment already moved to this
        backend's device. None (the segment defuses) for a filter pinned
        by ``custom=device:N`` to a card other than the default: pinned
        stages keep their own dispatch and copies. On a card, also None
        unless the model declares ``capture_safe = True``: a CUDA graph
        bakes in what the model reads on the host and cannot hold a host
        sync, which an eager model may do freely. Never the measured
        invoke: its synchronize and peak-statistics reset cannot run
        inside a capture."""
        fn = self._fn
        if fn is None or getattr(fn, "host_native", False):
            return None
        idx = self.props.custom_dict().get("device") if self.props else None
        if idx is not None and int(idx) != 0:
            return None
        dev = self._device
        if dev is not None and dev.type == "cuda" and \
                not getattr(fn, "capture_safe", False):
            return None

        def call(*xs):
            with torch.inference_mode():
                out = fn(*xs)
            return tuple(out) if isinstance(out, (list, tuple)) else (out,)
        return call

    def measure_next_invoke(self) -> None:
        """Measure the bytes of the next invoke (obs/memory.py)."""
        self._mem_arm = True

    def _invoke_measured(self, inputs: List[Any]) -> List[Any]:
        """One invoke with the caching allocator's peak tracked around it
        (the input upload included): temp = peak − bytes allocated
        before. Nothing is measured on the CPU."""
        dev = self._device
        if dev.type != "cuda":
            self._mem_record = None
            return self.invoke(inputs)
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        outs = self.invoke(inputs)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        self._mem_record = MeasuredMemory(
            temp=max(0, peak - before), output=tree_nbytes(outs),
            argument=tree_nbytes([as_torch(x) for x in inputs]))
        return outs

    def memory_analysis(self, inputs) -> Optional[MeasuredMemory]:
        """The record of the measured invoke (the filter calls this right
        after it; ``inputs`` is the reference hook's signature). None on
        the CPU."""
        return self._mem_record
