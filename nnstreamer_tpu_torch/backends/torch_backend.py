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

Sharded invoke (``custom=mesh:dp=N`` | ``mesh:auto`` | ``mesh:DxT``,
:func:`parse_mesh_spec`): SPMD over an initialized ``torch.distributed``
world (``parallel.init_multihost``), one process per card, every rank
running the same launch line on the same frames. The mesh is built before
the model loads, and a model entry with ``make_sharded(mesh)`` builds
against it (models/lm_serving.py: parameters over ``tp``). Each invoke
hands this rank the dp block of every batched input and all-gathers the
outputs over dp, so every rank's sink holds the global batch, as the
reference's global array does. A batch that dp does not divide runs whole
on every rank (one warning), as in the reference. The spec must cover the
world exactly (the reference meshes the first N of more local devices);
without a process group it is an error naming ``init_multihost``. The
device is the rank's own: its card under NCCL, the CPU under gloo
(``accelerator=cpu``). ``custom=device:N`` and ``custom=mesh:`` exclude
each other. A meshed filter never fuses, is never served from the AOT
cache, and has no measured memory footprint.

Segment fusion (``runtime/fusion.py``): on a card a model joins a fused
segment's CUDA graph only when it declares ``capture_safe = True`` (the
zoo's entries and the builtins but ``sleeper`` do); any other model runs
its own eager invoke. On the CPU every model fuses.

Memory accounting (``obs/memory.py``): ``measure_next_invoke()`` arms a
measurement of the next invoke on the card, and ``memory_analysis()``
returns it as a :class:`~..obs.memory.MeasuredMemory` — the reference's
XLA query is static, this one is measured. On the CPU there is none.

AOT compile cache (``aot/``, on when ``NNS_AOT_CACHE`` names a
directory): a filter's first invoke loads its model's exported program
from the cache (``aot_state()`` "hit") or exports the model with a
symbolic batch and saves it ("export"), keyed by the resolved model,
the custom knobs, the trailing-dim signature and the device; later
invokes serve through the program while it covers their inputs. A model
that does not export (one whose trace reads tensor values on the host;
the host-native executor is never tried) is served live and reported
(``aot_state()`` None). The LM entries export, a whole generate
unrolled: at ``base`` width that trace takes minutes of host time, paid
by the first invoke. A fused segment consults the cache for the whole
segment (``runtime/fusion.py``).

Shape inference: caps negotiation must not run the model (at the ``base``
LM width one invoke is a whole 64-step generate). The served callable
declares a shape rule instead — an ``output_info(in_info)`` attribute
returning the output ``TensorsInfo`` — which costs no device work. A
callable without one gets flexible output caps.
"""
from __future__ import annotations

import contextlib
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
from ..parallel import collectives as C
from ..parallel.mesh import axis_group, axis_index, axis_size, mesh_device
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


def _real_tensors() -> contextlib.ExitStack:
    """A context in which tensor factories make real tensors, untraced,
    while a torch.export trace runs."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    stack = contextlib.ExitStack()
    stack.enter_context(unset_fake_temporarily())
    stack.enter_context(disable_proxy_modes_tracing())
    return stack


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
            # a trace (torch.export, aot/) makes its tensors fake: the
            # weights are drawn for real, once, and become constants of
            # the exported program as of a live call
            real = _real_tensors() if torch.compiler.is_compiling() \
                else contextlib.nullcontext()
            with real:
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


def parse_mesh_spec(spec: str, world_size: Optional[int] = None):
    """A ``mesh:`` spec → a ``DeviceMesh`` over every rank of the world,
    axes ``("dp",)`` or ``("dp", "tp")`` — shared by the filter backend
    (``custom=mesh:...``) and ``tensor_generate mesh=``. Every rank calls
    it together.

    Accepted: ``dp=<N>`` | ``auto``/``all`` (dp over every rank) |
    ``<D>x<T>`` (dp × tp). ``world_size`` defaults to the initialized
    world's. Raises ValueError on anything else, when no process group is
    up, or when the spec does not cover the world exactly."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    spec = spec.strip().lower()
    n: Optional[int] = None
    tp = 1
    auto = spec in ("auto", "all", "dp=all", "dp=auto")
    if spec.startswith("dp=") and not auto:
        try:
            n = int(spec[3:])
        except ValueError:
            pass
    elif "x" in spec:  # mesh:DxT — dp × tp for shard-aware entries
        try:
            d_s, t_s = spec.split("x", 1)
            n, tp = int(d_s), int(t_s)
        except ValueError:
            n = None
    if (n is None and not auto) or tp < 1:
        raise ValueError(
            f"mesh spec {spec!r} — expected 'dp=<N>', 'auto', or "
            "'<D>x<T>' (dp×tp)")
    if world_size is None:
        if not dist.is_initialized():
            raise ValueError(
                f"mesh spec {spec} needs a torch.distributed world, one "
                "process per card, and none is up: call "
                "nnstreamer_tpu_torch.parallel.init_multihost() first, or "
                "set NNS_COORD, NNS_NUM_PROCS and NNS_PROC_ID for it")
        world_size = dist.get_world_size()
    if auto:
        n = world_size
    total = n * tp
    if total != world_size:
        raise ValueError(
            f"mesh spec {spec} needs {total} ranks, out of range: the "
            f"world has {world_size} (a mesh covers the whole world, one "
            "rank per card)")
    sizes = {"dp": n} if tp == 1 else {"dp": n, "tp": tp}
    return make_mesh(None, sizes)


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
        # (model, what invoke runs for it: the model, or the AOT artifact
        # guarding it); resolved again whenever the model is replaced
        self._served: Optional[tuple] = None
        # "hit" | "export" | None (the live model)
        self._aot_state: Optional[str] = None
        # custom=mesh:... — the sharded invoke (None = one device)
        self._mesh = None
        self._mesh_warned = False

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        custom = props.custom_dict()
        spec = custom.get("mesh")
        if spec is not None and custom.get("device") is not None:
            raise ValueError(
                "custom=device:N and custom=mesh:... are mutually "
                "exclusive (a mesh shards over every rank's card; pin "
                "stages OR shard one stage, not both)")
        self._device = _select_device(props)
        if spec is not None:
            # the mesh before the model: make_sharded places its params
            try:
                self._mesh = parse_mesh_spec(spec)
                self._device = mesh_device(self._mesh, self._device)
            except ValueError as e:
                raise ValueError(f"custom=mesh:{e}") from None
        self._fn = self._load_model(props.model, props)
        logger.info("torch backend opened model=%s device=%s mesh=%s",
                    props.model, self._device, self._mesh)

    def close(self) -> None:
        self._fn = None
        self._mesh = None
        self._served = None
        self._aot_state = None
        self.model_entry = None
        self._retired = []
        self._in_info = self._out_info = None
        super().close()

    @property
    def device(self) -> Optional[torch.device]:
        """The device this backend runs on."""
        return self._device

    @property
    def mesh(self):
        """The device mesh this backend shards over (None = one
        device)."""
        return self._mesh

    def _load_model(self, model: str, props: FilterProperties) -> Callable:
        if model.startswith("builtin://"):
            return make_builtin(model, props.custom_dict())
        if model.endswith(".py") and os.path.exists(model):
            # a model file (``codegen filter``'s skeleton): it defines a
            # callable ``model(*tensors)`` and may declare IN_INFO/OUT_INFO
            ns: Dict[str, Any] = {"__file__": model}
            with open(model) as fh:
                code = fh.read()
            exec(compile(code, model, "exec"), ns)  # noqa: S102 - user model file
            if "IN_INFO" in ns:
                self._in_info = ns["IN_INFO"]
            if "OUT_INFO" in ns:
                self._out_info = ns["OUT_INFO"]
            if "model" not in ns or not callable(ns["model"]):
                raise ValueError(f"{model}: must define a callable 'model'")
            return ns["model"]
        if ":" in model and not os.path.exists(model):
            mod_name, _, attr = model.partition(":")
            entry = getattr(importlib.import_module(mod_name), attr)
            entry = _apply_serve_knobs(entry, props.custom_dict(), model)
            self.model_entry = entry
            sharded = getattr(entry, "make_sharded", None)
            if self._mesh is not None and sharded is not None:
                return sharded(self._mesh, device=self._device)
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
            "'<module>:<attr>', 'builtin://<name>', a .py model file or a "
            ".tflite file)")

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
            # the old model's served callable goes with it
            self._served = None
            self._aot_state = None

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
            if self._mesh is not None:
                return self._invoke_sharded(xs)
        fn, served = self._fn, self._served
        if served is None or served[0] is not fn:
            # first invoke of this model (a reload re-keys: the model
            # fingerprint covers on-disk weight changes)
            served = self._served = (fn, self._resolve_served(fn, xs))
        with torch.inference_mode():
            out = served[1](*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _invoke_sharded(self, xs: List[torch.Tensor]) -> List[Any]:
        """Mesh mode: this rank runs the model on the dp block of each
        batched input and the outputs are all-gathered over dp. When dp
        does not divide an input's batch (say a partial tail an
        aggregator let through) the call runs whole on every rank — the
        model's ``whole_batch`` where it has one — with one warning, as
        in the reference; rank-0 inputs have no batch and pass whole."""
        dp = axis_size(self._mesh, "dp")
        whole = any(x.dim() and x.shape[0] % dp for x in xs)
        if whole:
            if not self._mesh_warned:
                self._mesh_warned = True
                logger.warning(
                    "torch mesh backend model=%s: input batch %s not "
                    "divisible by dp=%d — running this call unsharded "
                    "(size the upstream tensor_aggregator to a multiple "
                    "of the dp axis)",
                    self.props.model if self.props else "?",
                    [tuple(x.shape) for x in xs], dp)
            fn = getattr(self._fn, "whole_batch", self._fn)
        else:
            r = axis_index(self._mesh, "dp")
            xs = [x.chunk(dp)[r] if x.dim() else x for x in xs]
            fn = self._fn
        with torch.inference_mode():
            out = fn(*xs)
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        if whole:
            return out
        group = axis_group(self._mesh, "dp")
        return [C.all_gather_plain(o, group, 0) if o.dim() else o
                for o in out]

    def aot_state(self) -> Optional[str]:
        """Whether this backend serves through an AOT artifact: "hit"
        (loaded from the compile cache), "export" (exported at this
        open), or None (the live model)."""
        return self._aot_state

    def _resolve_served(self, fn: Callable, example_inputs) -> Callable:
        if getattr(fn, "host_native", False):
            return fn
        try:
            served = self._aot_resolve(fn, example_inputs)
        except Exception:  # noqa: BLE001 - cache trouble != correctness
            logger.exception("torch backend: AOT cache consult failed — "
                             "serving the live model")
            served = None
        return fn if served is None else served

    def _aot_resolve(self, fn: Callable,
                     example_inputs) -> Optional[Callable]:
        """AOT compile-cache consult for the singleton-filter path: load
        this model's exported program keyed by (resolved model, custom
        knobs, trailing-dim signature, device signature), or export it
        with a symbolic batch and serve through the export — a
        supervised restart or replica spawn of the same filter then
        loads instead of tracing. None = the live model (cache off /
        export refused)."""
        from .. import aot

        cache = aot.default_cache()
        if cache is None:
            return None
        shapes = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                  for x in example_inputs]
        key, stage, digest = aot.backend_key(self, shapes)
        loaded = cache.load(key, stage, digest)
        if loaded is not None and loaded.compatible(tuple(example_inputs)):
            self._aot_state = "hit"
            return aot.guarded(loaded, fn)
        try:
            blob, meta, fresh = aot.export_stage(fn,
                                                 tuple(example_inputs))
        except aot.ExportError as e:
            logger.info("torch backend model=%s: AOT export refused (%s) "
                        "— serving the live model",
                        self.props.model if self.props else "?",
                        str(e).splitlines()[0][:300])
            return None
        cache.save(key, stage, digest, blob, meta)
        self._aot_state = "export"
        return aot.guarded(fresh, fn)

    def fusion_callable(self) -> Optional[Callable]:
        """The model as a fused segment's stage (``runtime/fusion.py``):
        ``fn(*xs) -> tuple`` under ``torch.inference_mode()``, as
        ``invoke`` runs it, on inputs the segment already moved to this
        backend's device. None (the segment defuses) for a filter pinned
        by ``custom=device:N`` to a card other than the default: pinned
        stages keep their own dispatch and copies; and under a mesh: the
        sharded invoke's split and gather belong to this stage. On a
        card, also None
        unless the model declares ``capture_safe = True``: a CUDA graph
        bakes in what the model reads on the host and cannot hold a host
        sync, which an eager model may do freely. Never the measured
        invoke: its synchronize and peak-statistics reset cannot run
        inside a capture."""
        fn = self._fn
        if fn is None or getattr(fn, "host_native", False) \
                or self._mesh is not None:
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
        if dev.type != "cuda" or self._mesh is not None:
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
        the CPU and under a mesh (a rank's bytes are its share)."""
        return self._mem_record
