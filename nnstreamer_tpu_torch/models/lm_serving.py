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

Streaming (the ``tensor_generate`` element, elements/generate.py):
``make_streaming(device)`` returns ``stream(tokens, steps)``, which prefills
once and yields each token as it is picked; ``make_session(device)`` keeps
the KV cache across calls for multi-turn conversations.

Weights are random, from ``seed``, unless the entry carries ``params``:
nnstreamer_tpu's parameter pytree as numpy arrays, converted by
``models/convert.py`` — the same weights then serve through both packages.

Continuous batching (the serving layer, serving/): ``make_continuous(slots,
paged=..., draft=..., device=...)`` builds the slot engine a
``serving.DecodeScheduler`` drives — requests join and retire between
decode steps, each slot at its own position.

Not in this package yet: ``make_sharded`` (mesh).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..core import DataType, TensorSpec, TensorsInfo
from ..utils.hw_accel import resolve_device
from .convert import params_from_jax
from .decoding import (
    decode_step,
    init_cache,
    make_generate,
    pick_token,
    prefill,
    prefill_continue,
)
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


def with_serve_knobs(entry, serve_dtype: Optional[str] = None,
                     cache_len: int = 0, model: str = ""):
    """``entry`` rebuilt with the serving knobs: ``serve_dtype`` (weights
    and KV cache in that dtype) and ``cache_len`` (the KV cache's length;
    0 = the model's max_seq). Unset knobs leave ``entry`` as it is. The
    entry must be a dataclass instance with those fields; ``model`` names
    it in errors. Shared by ``tensor_filter`` (``custom=``) and
    ``tensor_generate`` (properties)."""
    if cache_len < 0:
        raise ValueError(
            f"cache_len must be >= 0 (0 = model max_seq), got {cache_len}")
    kw: Dict[str, Any] = {}
    if serve_dtype:
        kw["serve_dtype"] = serve_dtype
    if cache_len:
        kw["cache_len"] = cache_len
    if not kw:
        return entry
    fields = ({f.name for f in dataclasses.fields(entry)}
              if dataclasses.is_dataclass(entry)
              and not isinstance(entry, type) else set())
    if not fields >= kw.keys():
        raise ValueError(
            f"serve_dtype/cache_len need a dataclass model entry with "
            f"those fields; {model} is {type(entry).__name__}")
    return replace(entry, **kw)


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

    def make_streaming(self, device=None, temperature: float = 0.0):
        """Per-token generation for the ``tensor_generate`` element:
        returns ``stream(tokens (B, P), steps, rng=None)``, which yields
        (B,) int32 on ``device`` (default the card) — prefill once, then
        one ``decode_step`` per yielded token. A host loop is the point:
        each token leaves the model as it is picked, so downstream
        elements render or forward it at once. ``temperature`` 0 = greedy;
        > 0 = sampling from a ``torch.Generator`` seeded with ``rng`` (an
        int, default 0); a continuation turn folds the session position
        into the seed, so it never repeats turn 1's draws."""
        device = resolve_device(device)
        cfg = self._cfg_serve
        params = self.build_params(device)
        cache_dtype = params["embed"].dtype

        @torch.inference_mode()
        def first(tokens, gen):
            cache = init_cache(cfg, tokens.shape[0], cache_dtype, device)
            logits, cache, pos = prefill(cfg, params, tokens, cache)
            return pick_token(logits, temperature, gen), pos, cache

        @torch.inference_mode()
        def step(token, pos, cache, gen):
            logits, cache = decode_step(cfg, params, token, pos, cache)
            return pick_token(logits, temperature, gen), pos + 1, cache

        @torch.inference_mode()
        def ingest(feed, cache, start, gen):
            logits, cache, pos = prefill_continue(cfg, params, feed, cache,
                                                  start)
            return pick_token(logits, temperature, gen), pos, cache

        def stream(tokens, steps: int, _session: "Optional[_StreamSession]"
                   = None, rng=None) -> Iterator[torch.Tensor]:
            """Yield ``steps`` tokens for ``tokens`` (B, P). With
            ``_session`` the KV cache continues from the previous turn:
            the new prompt is ingested in one chunked prefill, then
            generation resumes — no re-prefill of the history."""
            if steps < 1:
                raise ValueError(f"steps={steps} must be >= 1")
            if not isinstance(tokens, torch.Tensor):
                tokens = torch.from_numpy(np.array(tokens, np.int32))
            tokens = tokens.to(device, torch.int32)
            if tokens.dim() != 2:
                raise ValueError(f"tokens must be (B, P), got "
                                 f"{tuple(tokens.shape)}")
            state = _session.state if _session is not None else None
            gen = None
            if temperature > 0.0:
                if not isinstance(rng, (int, np.integer, type(None))):
                    raise TypeError(f"rng must be an int seed, got "
                                    f"{type(rng).__name__}")
                seed = int(rng or 0)
                if state is not None:
                    # a continuation turn must never repeat turn 1's draws
                    seed = seed * 0x9E3779B97F4A7C15 + state[1] + 1
                gen = torch.Generator(device=device).manual_seed(
                    seed % 2**64)
            if state is None:
                if tokens.shape[1] + steps > cfg.max_seq:
                    raise ValueError(
                        f"prompt ({tokens.shape[1]}) + steps ({steps}) "
                        f"exceeds max_seq {cfg.max_seq}")
                token, pos, cache = first(tokens, gen)
            else:
                pending, pos, cache = state
                if tokens.shape[0] != pending.shape[0]:
                    raise ValueError(
                        f"conversation batch changed: session has "
                        f"batch {pending.shape[0]}, new prompt has "
                        f"{tokens.shape[0]} (reset() to start over)")
                if pos + tokens.shape[1] + steps > cfg.max_seq:
                    raise ValueError(
                        f"conversation at pos {pos} + prompt "
                        f"({tokens.shape[1]}) + steps ({steps}) exceeds "
                        f"max_seq {cfg.max_seq}")
                # the previous turn's final sample is still pending (its
                # K/V was never written: generation stopped at its
                # prediction), so it leads the chunk; the chunk's last
                # prediction opens generation
                feed = torch.cat([pending[:, None], tokens], dim=1)
                token, pos, cache = ingest(feed, cache, pos, gen)
            # the state is kept after every step, so an abandoned
            # generator leaves a session that continues where it stopped
            if _session is not None:
                _session.state = (token, pos, cache)
            yield token
            for _ in range(steps - 1):
                token, pos, cache = step(token, pos, cache, gen)
                if _session is not None:
                    _session.state = (token, pos, cache)
                yield token

        return stream

    def make_continuous(self, slots: int = 4, mesh=None,
                        paged: bool = False, draft=None,
                        spec_k: int = 4, device=None, **paged_kw):
        """Continuous-batching decode state for the serving layer: a
        fixed-``slots`` engine on ``device`` (default the card) where
        sequences join and retire independently between decode steps
        (``serving.DecodeScheduler`` drives it). Params honor the entry's
        serve knobs (serve_dtype, cache_len). ``mesh`` raises: one device
        only.

        ``paged=True`` builds the block-table
        :class:`~..serving.PagedLMEngine` (``paged_kw``: page_size / pages
        / chunk / share_prefixes). ``draft`` additionally wraps it in
        :class:`~..serving.SpeculativeLMEngine`: pass a draft object
        (``NgramDraft()``), a draft ``_LMServingEntry`` (becomes a
        ``ModelDraft`` over its own params, on the same device), or the
        string ``"ngram"``; ``spec_k`` is the draft burst length verified
        per target pass."""
        from ..serving.lm_engine import from_entry

        device = resolve_device(device)
        eng = from_entry(self, slots=slots, mesh=mesh, paged=paged,
                         device=device, **paged_kw)
        if draft is None:
            return eng
        if not paged:
            raise ValueError(
                "speculative decode rides the paged engine "
                "(verify() needs block tables); pass paged=True")
        from ..serving.speculative import (
            ModelDraft,
            NgramDraft,
            SpeculativeLMEngine,
        )

        if isinstance(draft, str):
            if draft != "ngram":
                raise ValueError(f"unknown draft spec {draft!r}")
            draft = NgramDraft()
        elif isinstance(draft, _LMServingEntry):
            dcfg = draft._cfg_serve
            if dcfg.vocab != self._cfg_serve.vocab:
                raise ValueError(
                    f"draft vocab {dcfg.vocab} != target vocab "
                    f"{self._cfg_serve.vocab}: speculative verify "
                    "compares token ids, the vocabularies must match")
            draft = ModelDraft(dcfg, draft.build_params(device))
        return SpeculativeLMEngine(eng, draft, k=spec_k)

    def make_session(self, device=None, temperature: float = 0.0):
        """Stateful multi-turn serving: ``session.generate(tokens, steps)``
        yields like the stream form, but the KV cache persists across
        calls (turn 2's prompt is ingested at the current position, not
        re-prefilled). ``session.reset()`` starts a new conversation."""
        return _StreamSession(self.make_streaming(device, temperature))


class _StreamSession:
    def __init__(self, stream):
        self._stream = stream
        self.state = None  # (last token, pos, cache) after each step

    def generate(self, tokens, steps: int, rng=None):
        return self._stream(tokens, steps, _session=self, rng=rng)

    def reset(self) -> None:
        self.state = None

    @property
    def position(self) -> int:
        """Sequence position after the last step (0 = fresh session)."""
        return self.state[1] if self.state is not None else 0


# test-size entry
tiny = _LMServingEntry(
    TransformerConfig(vocab=64, dim=32, heads=4, layers=2, max_seq=64,
                      decode_attn="kernel", prefill_attn="kernel"))

# draft-size companion to ``tiny`` (same vocab, half the width, one layer)
tiny_draft = _LMServingEntry(
    TransformerConfig(vocab=64, dim=16, heads=2, layers=1, max_seq=64,
                      decode_attn="kernel", prefill_attn="kernel"))

# full-width serving entry (~186M parameters)
base = _LMServingEntry(
    TransformerConfig(vocab=32000, dim=1024, heads=16, layers=12,
                      max_seq=2048, decode_attn="kernel",
                      prefill_attn="kernel"),
    default_steps=64)
