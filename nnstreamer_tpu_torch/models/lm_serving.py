"""LM serving entries: autoregressive generation as a ``tensor_filter``
stage.

The port of nnstreamer_tpu's ``models/lm_serving.py`` for one device:

    appsrc ! tensor_filter framework=torch
        model=nnstreamer_tpu_torch.models.lm_serving:base ! tensor_sink

serves batched greedy generation, decoding through the hand-written CUDA
attention kernel on the card.

Entry protocol (backends/torch_backend.py): ``make(device)`` builds the
served callable on ``device`` (default the card). The callable carries
``output_info(in_info)``, the shape rule caps negotiation uses instead of
running a generate.

The filter contract: input ``(B, P) int32`` prompt tokens → output
``(B, P + steps) int32`` (prompt echoed, ``steps`` greedy continuations).
``steps`` comes from the entry (env ``NNS_LM_STEPS`` overrides).

Weights are random, from ``seed``, unless the entry carries ``params``:
nnstreamer_tpu's parameter pytree as numpy arrays, converted by
``models/convert.py`` — the same weights then serve through both packages.

Not in this package yet: ``make_sharded`` (mesh), ``make_streaming``,
``make_session`` and ``make_continuous``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

import torch

from ..core import DataType, TensorSpec, TensorsInfo
from ..utils.hw_accel import resolve_device
from .convert import params_from_jax
from .decoding import make_generate
from .transformer import TransformerConfig, init_params


def _steps(default: int) -> int:
    raw = os.environ.get("NNS_LM_STEPS", str(default))
    try:
        steps = int(raw)
    except ValueError:
        raise ValueError(f"NNS_LM_STEPS={raw!r} is not an integer")
    if steps < 1:
        raise ValueError(f"NNS_LM_STEPS={steps} must be >= 1")
    return steps


def _serve_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"serve_dtype {name!r} is not a torch float dtype")
    return dt


@dataclass(frozen=True)
class _LMServingEntry:
    cfg: TransformerConfig
    default_steps: int = 8
    seed: int = 0
    # serving-efficiency knobs (models/decoding.py rationale): weights AND
    # KV cache in this dtype (activations stay f32); cache sized to the
    # actual serving length instead of cfg.max_seq. None/0 = train config.
    serve_dtype: Optional[str] = None
    cache_len: int = 0
    # nnstreamer_tpu parameter pytree (numpy leaves); None = init_params(seed)
    params: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                             repr=False)

    @property
    def _cfg_serve(self) -> TransformerConfig:
        if self.cache_len:
            if self.cache_len > self.cfg.max_seq:
                raise ValueError(
                    f"cache_len {self.cache_len} exceeds max_seq "
                    f"{self.cfg.max_seq}")
            return replace(self.cfg, max_seq=self.cache_len)
        return self.cfg

    def build_params(self, device: torch.device) -> Dict[str, Any]:
        dtype = _serve_dtype(self.serve_dtype) if self.serve_dtype else None
        if self.params is not None:
            return params_from_jax(self.params, device, dtype)
        params = init_params(self.cfg, seed=self.seed, device=device)
        if dtype is None:
            return params
        cast = lambda t: t.to(dtype)  # noqa: E731
        return {**{k: cast(params[k]) for k in ("embed", "pos", "out_norm")},
                "blocks": [{k: cast(t) for k, t in b.items()}
                           for b in params["blocks"]]}

    def make(self, device=None):
        device = resolve_device(device)
        max_seq = self._cfg_serve.max_seq
        params = self.build_params(device)
        gen = make_generate(self.cfg, cache_len=self.cache_len)
        steps = _steps(self.default_steps)

        def serve(tokens: torch.Tensor):
            return (gen(params, tokens, steps),)

        def output_info(in_info: TensorsInfo) -> TensorsInfo:
            specs = in_info.specs
            if (len(specs) != 1 or len(specs[0].shape) != 2
                    or specs[0].dtype is not DataType.INT32):
                raise ValueError(
                    f"LM serving takes one (B, P) int32 tensor, got "
                    f"{in_info.describe()}")
            B, P = specs[0].shape
            if P + steps > max_seq:
                raise ValueError(
                    f"prompt ({P}) + steps ({steps}) exceeds max_seq {max_seq}")
            return TensorsInfo.of(TensorSpec((B, P + steps), DataType.INT32))

        serve.output_info = output_info
        return serve


# test-size entry
tiny = _LMServingEntry(
    TransformerConfig(vocab=64, dim=32, heads=4, layers=2, max_seq=64,
                      decode_attn="kernel"))

# draft-size companion to ``tiny`` (same vocab, half the width, one layer)
tiny_draft = _LMServingEntry(
    TransformerConfig(vocab=64, dim=16, heads=2, layers=1, max_seq=64,
                      decode_attn="kernel"))

# full-width serving entry (~186M parameters)
base = _LMServingEntry(
    TransformerConfig(vocab=32000, dim=1024, heads=16, layers=12,
                      max_seq=2048, decode_attn="kernel"),
    default_steps=64)
