"""TensorFlow filter backend: SavedModel + frozen GraphDef (L4).

The counterpart of nnstreamer_tpu's ``backends/tf_backend.py``; it runs on
the host CPU, and card tensors cross to the host once, explicitly.
TensorFlow is imported in :meth:`TensorFlowBackend.open`, never at import:
on a host without it, opening raises :class:`~.base.FrameworkUnavailable`
naming tensorflow.

Reference analog: ``ext/nnstreamer/tensor_filter/tensor_filter_tensorflow.cc``
(804 LoC — TF-C API session/graph-def load). TF2 redesign: a SavedModel
directory serves one of its signatures; a frozen ``.pb`` GraphDef (the
reference's native format — its test models mnist.pb /
conv_actions_frozen.pb are frozen graphs) is imported via
``wrap_function`` and pruned to a concrete feeds→fetches function.
Graph endpoints auto-detect (Placeholder ops → inputs, consumer-less
non-Const ops → outputs) unless named explicitly.

Custom options:
  ``signature:<key>`` — SavedModel signature to serve (default:
  ``[tensorflow] signature`` config key, then ``serving_default``).
  ``inputs:<name;name2>`` — explicit positional→name binding (SavedModel
  signature kwargs, or GraphDef tensor names like ``input:0``).
  ``outputs:<name;name2>`` — GraphDef fetch tensor names.

Restored signatures canonicalize their kwargs, so declaration order is lost;
inputs therefore bind to the signature's input names **sorted
alphabetically** unless ``inputs:`` overrides the order. Outputs come back
sorted by output name (deterministic across processes).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from ..core import DataType, TensorsInfo
from ..core.tensors import TensorSpec
from ..utils.log import logger
from .base import (Accelerator, FilterBackend, FilterProperties,
                   import_tensorflow, register_backend)
from .tflite_backend import _host


@register_backend
class TensorFlowBackend(FilterBackend):
    NAME = "tensorflow"
    ALIASES = ("tf", "tensorflow2")
    ACCELERATORS = (Accelerator.CPU,)

    def __init__(self):
        super().__init__()
        self._fn = None
        self._input_names: List[str] = []
        self._output_names: List[str] = []
        self._pruned = None  # set only for frozen-GraphDef models

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        import os

        from ..registry.config import get_config

        tf = import_tensorflow(self.NAME)

        opts = props.custom_dict()
        if os.path.isfile(props.model) and props.model.endswith(".pb"):
            if os.path.basename(props.model) == "saved_model.pb":
                # common mistake: pointing at the file inside a SavedModel
                # dir — that .pb is a SavedModel proto, not a GraphDef
                logger.info("model points at saved_model.pb; loading the "
                            "SavedModel directory instead")
                model_path = os.path.dirname(props.model) or "."
            else:
                self._open_graphdef(props.model, opts)
                return
        else:
            model_path = props.model
        sig_key = opts.get("signature") or get_config().get(
            "tensorflow", "signature", "serving_default"
        )
        loaded = tf.saved_model.load(model_path)
        try:
            self._fn = loaded.signatures[sig_key]
        except KeyError:
            raise ValueError(
                f"SavedModel {props.model} has no signature '{sig_key}' "
                f"(available: {list(loaded.signatures)})"
            )
        self._loaded = loaded  # keep the object alive (owns the variables)
        _, kwargs_sig = self._fn.structured_input_signature
        self._input_names = sorted(kwargs_sig)
        order = opts.get("inputs")
        if order:
            names = [n.strip() for n in order.split(";") if n.strip()]
            if sorted(names) != self._input_names:
                raise ValueError(
                    f"custom inputs:{order} does not match signature inputs "
                    f"{self._input_names}"
                )
            self._input_names = names
        out_sel = opts.get("outputs")
        if out_sel:
            names = [n.strip() for n in out_sel.split(";") if n.strip()]
            unknown = set(names) - set(self._fn.structured_outputs)
            if unknown:
                raise ValueError(
                    f"custom outputs:{out_sel} names unknown signature "
                    f"outputs {sorted(unknown)} (available: "
                    f"{sorted(self._fn.structured_outputs)})")
            self._output_names = names
        else:
            self._output_names = sorted(self._fn.structured_outputs)
        logger.info(
            "tensorflow backend loaded %s sig=%s in=%s out=%s",
            props.model, sig_key, self._input_names, self._output_names,
        )

    def _open_graphdef(self, path: str, opts) -> None:
        """Frozen GraphDef → pruned concrete function (reference: TF-C API
        session over an imported graph-def)."""
        import tensorflow as tf

        gd = tf.compat.v1.GraphDef()
        with open(path, "rb") as fh:
            gd.ParseFromString(fh.read())

        def _tensor_names(key, default):
            """(names, used_auto): explicit custom names, else the
            auto-detected defaults."""
            given = opts.get(key)
            names = [n.strip() if ":" in n else f"{n.strip()}:0"
                     for n in (given or "").split(";") if n.strip()]
            if names:
                return names, False
            return default, True

        placeholders = [n.name for n in gd.node if n.op == "Placeholder"]
        consumed = set()
        for n in gd.node:
            for i in n.input:
                consumed.add(i.split(":")[0].lstrip("^"))
        sinks = [n.name for n in gd.node
                 if n.name not in consumed
                 and n.op not in ("Const", "Placeholder", "NoOp", "Assert")]
        wrapped = tf.compat.v1.wrap_function(
            lambda: tf.compat.v1.import_graph_def(gd, name=""), [])

        def _resolve(names, auto):
            """Map names → graph tensors; auto-detected candidates that
            yield no tensor (stray zero-output sinks) are skipped instead
            of crashing the load."""
            out_names, tensors = [], []
            for n in names:
                try:
                    tensors.append(wrapped.graph.get_tensor_by_name(n))
                    out_names.append(n)
                except (KeyError, ValueError):
                    if not auto:
                        raise
                    logger.debug("skipping non-tensor graph endpoint %s", n)
            return out_names, tensors

        feeds, feeds_auto = _tensor_names("inputs", [f"{p}:0" for p in placeholders])
        fetches, fetches_auto = _tensor_names("outputs", [f"{s}:0" for s in sinks])
        feeds, feed_tensors = _resolve(feeds, auto=feeds_auto)
        fetches, fetch_tensors = _resolve(fetches, auto=fetches_auto)
        if not feeds or not fetches:
            raise ValueError(
                f"{path}: cannot determine graph endpoints (feeds={feeds}, "
                f"fetches={fetches}) — pass custom=inputs:...,outputs:...")
        self._pruned = wrapped.prune(feeds=feed_tensors, fetches=fetch_tensors)
        self._fn = self._pruned
        self._loaded = wrapped
        self._input_names = feeds
        self._output_names = fetches
        logger.info("tensorflow backend loaded frozen graph %s in=%s out=%s",
                    path, feeds, fetches)

    def close(self) -> None:
        self._fn = None
        self._loaded = None
        self._pruned = None
        super().close()

    def _spec_of(self, tensor_spec) -> Optional[TensorSpec]:
        shape = tensor_spec.shape
        if shape.rank is None or any(d is None for d in shape.as_list()):
            return None
        return TensorSpec(
            tuple(int(d) for d in shape.as_list()),
            DataType.from_any(tensor_spec.dtype.as_numpy_dtype),
        )

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        if self._pruned is not None:
            # graph Tensors expose the same .shape/.dtype API _spec_of reads
            ins = [self._spec_of(t) for t in self._pruned.inputs]
            outs = [self._spec_of(t) for t in self._pruned.outputs]
        else:
            _, kwargs_sig = self._fn.structured_input_signature
            ins = [self._spec_of(kwargs_sig[n]) for n in self._input_names]
            outs = [self._spec_of(self._fn.structured_outputs[n])
                    for n in self._output_names]
        in_info = TensorsInfo.of(*ins) if all(s is not None for s in ins) else None
        out_info = TensorsInfo.of(*outs) if all(s is not None for s in outs) else None
        return in_info, out_info

    def invoke(self, inputs: List[Any]) -> List[Any]:
        import tensorflow as tf

        if self._fn is None:
            raise RuntimeError("tensorflow backend: invoke before open")
        if len(inputs) != len(self._input_names):
            raise ValueError(
                f"signature takes {len(self._input_names)} inputs "
                f"({self._input_names}), got {len(inputs)}"
            )
        inputs = [_host(x, self.NAME) for x in inputs]
        if self._pruned is not None:
            out = self._pruned(*(tf.constant(x) for x in inputs))
            return [o.numpy() for o in out]
        feed = {
            name: tf.constant(x)
            for name, x in zip(self._input_names, inputs)
        }
        out = self._fn(**feed)
        return [out[n].numpy() for n in self._output_names]
