"""``torch.export`` artifact backend (``framework=torch-export``, alias
``pt2``).

The counterpart of nnstreamer_tpu's ``backends/stablehlo_backend.py``:
it loads a saved ``ExportedProgram`` (the bytes of ``torch.export.save``
in a ``.pt2`` file, as :func:`export_callable`, ``aot.export_stage`` or
the AOT compile cache write them) and serves through its module, run
eagerly — the "compiled artifact" deployment path (the reference
deserializes portable StableHLO; the port loads the exported ATen graph
with its weights, the ``nns::`` kernel ops registered first). ``.pt2``
files pick this backend under ``framework=auto``.

A program runs where it was exported: its weights and the devices its
graph names are fixed then, so opening it for another device (a
``cuda:0`` export under ``accelerator=cpu``) is an error that says so;
export again on the device it should serve on.

The reference's names for its StableHLO backend — ``stablehlo``,
``jax-export``, ``hlo`` and the ``.jaxexport``/``.stablehlo``/``.hlo``
files — need JAX, which the port does not use: opening one raises
:class:`~.base.FrameworkUnavailable` naming the ``.pt2`` route.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..core import DataType, TensorsInfo
from ..core.buffer import as_torch
from ..core.tensors import TensorSpec
from ..utils.log import logger
from .base import (FilterBackend, FilterProperties, FrameworkUnavailable,
                   register_backend)


def _program_device(loaded) -> Optional[torch.device]:
    """The device the program's inputs were exported on (None with no
    tensor input)."""
    for n in loaded.program.graph.nodes:
        val = n.meta.get("val") if n.op == "placeholder" else None
        if isinstance(val, torch.Tensor):
            return val.device
    return None


def _info(cells, batch: Optional[int]) -> Optional[TensorsInfo]:
    specs = []
    for c in cells:
        if any(isinstance(d, str) for d in c["shape"]) and batch is None:
            return None
        shape = tuple(batch if isinstance(d, str) else int(d)
                      for d in c["shape"])
        specs.append(TensorSpec(shape,
                                DataType.from_any(getattr(torch, c["dtype"]))))
    return TensorsInfo.of(*specs)


@register_backend
class TorchExportBackend(FilterBackend):
    NAME = "torch-export"
    ALIASES = ("pt2",)
    REENTRANT = True

    def __init__(self):
        super().__init__()
        self._loaded = None
        self._device: Optional[torch.device] = None
        self._batch: Optional[int] = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        from .. import aot
        from .torch_backend import _select_device

        want = _select_device(props)
        with open(props.model, "rb") as fh:
            loaded = aot.load_artifact(fh.read())
        dev = _program_device(loaded)
        if dev is not None and (dev.type, dev.index or 0) != \
                (want.type, want.index or 0):
            raise ValueError(
                f"{props.model} was exported on {dev}; this filter runs on "
                f"{want} — export it again there")
        self._loaded = loaded
        self._device = dev or want
        logger.info("torch-export backend loaded %s (%s, device %s)",
                    props.model, "shape-poly" if loaded.poly else "static",
                    self._device)

    def close(self) -> None:
        self._loaded = None
        self._batch = None
        super().close()

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def get_model_info(self) -> Tuple[Optional[TensorsInfo],
                                      Optional[TensorsInfo]]:
        """From the program's signature. A shape-poly program declares
        nothing until an input signature fixes the batch
        (``set_input_info``)."""
        if self._loaded is None:
            return None, None
        return (_info(self._loaded.in_avals, self._batch),
                _info(self._loaded.out_avals, self._batch))

    def set_input_info(self, in_info: TensorsInfo) -> Optional[TensorsInfo]:
        loaded = self._loaded
        metas = [torch.empty(s.shape, dtype=s.dtype.torch_dtype,
                             device="meta") for s in in_info.specs]
        if loaded is None or not loaded.compatible(tuple(metas)):
            return None
        self._batch = int(in_info.specs[0].shape[0]) \
            if in_info.specs and in_info.specs[0].shape else None
        return _info(loaded.out_avals, self._batch)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        if self._loaded is None:
            raise RuntimeError("torch-export backend: invoke before open")
        xs = [as_torch(x).to(self._device) for x in inputs]
        with torch.inference_mode():
            out = self._loaded.call(*xs)
        return list(out)

    def fusion_callable(self):
        """The loaded module is an ordinary torch graph: it joins a fused
        segment (captured in the segment's CUDA graph on a card; an
        exported program holds no host read — export refuses them), as
        the reference's exported program inlines into a segment's jit."""
        loaded = self._loaded
        if loaded is None:
            return None

        def stage(*xs):
            with torch.inference_mode():
                return tuple(loaded.call(*xs))
        return stage


@register_backend
class StableHloBackend(FilterBackend):
    """The reference's ``stablehlo`` names: a typed error at open."""

    NAME = "stablehlo"
    ALIASES = ("jax-export", "hlo")

    def open(self, props: FilterProperties) -> None:
        raise FrameworkUnavailable(
            f"framework={self.NAME} loads jax.export StableHLO, which needs "
            "JAX; the port's exported artifacts are .pt2 files served by "
            "framework=torch-export (write one with "
            "backends.pt2_backend.export_callable or aot.export_stage)")


def export_callable(fn, example_inputs, path: str,
                    poly: bool = False) -> dict:
    """Save a torch callable as a ``.pt2`` file this backend loads (the
    artifact-producing side). ``poly=True`` exports dim 0 of every input
    as one symbolic batch dim, so one file serves every batch size.
    Returns the artifact's meta."""
    from ..aot import export_stage

    args = tuple(as_torch(a) for a in example_inputs)
    blob, meta, _loaded = export_stage(fn, args, poly=poly)
    with open(path, "wb") as fh:
        fh.write(blob)
    return meta
