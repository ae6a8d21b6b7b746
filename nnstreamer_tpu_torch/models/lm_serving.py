"""LM serving entries: autoregressive generation as a ``tensor_filter``
stage.

The port of nnstreamer_tpu's ``models/lm_serving.py``:

    appsrc ! tensor_filter framework=torch
        model=nnstreamer_tpu_torch.models.lm_serving:base [custom=mesh:DxT]
    ! tensor_sink

serves batched greedy generation, decoding through the hand-written CUDA
attention kernels on the card.

Entry protocol (backends/torch_backend.py): ``make(device)`` builds the
served callable on ``device`` (default the card); ``make_sharded(mesh)``
builds it against the filter's mesh (``custom=mesh:...``): SPMD, every
rank of the world runs the same line, its parameters Megatron shards over
``tp`` (replicated on a dp-only mesh), its input the dp block of the batch
the backend hands it. The callable carries ``output_info(in_info)``, the
shape rule caps negotiation uses instead of running a generate, and, under
a mesh, ``whole_batch``: the same generation for a batch that dp does not
divide, run whole on every rank.

The filter contract: input ``(B, P) int32`` prompt tokens → output
``(B, P + steps) int32`` (prompt echoed, ``steps`` greedy continuations).
``steps`` comes from the entry (env ``NNS_LM_STEPS`` overrides).

Streaming (the ``tensor_generate`` element, elements/generate.py):
``make_streaming(device, mesh=)`` returns ``stream(tokens, steps)``, which
prefills once and yields each token as it is picked; ``make_session(device,
mesh=)`` keeps the KV cache across calls for multi-turn conversations.
Under a mesh each rank takes its dp block of the prompt (when dp divides
the batch) and every step's tokens are all-gathered over dp, so every rank
yields the global batch's.

Weights are random, from ``seed``, unless the entry carries ``params``:
nnstreamer_tpu's parameter pytree as numpy arrays, converted by
``models/convert.py`` — the same weights then serve through both packages.

Continuous batching (the serving layer, serving/): ``make_continuous(slots,
paged=..., draft=..., device=...)`` builds the slot engine a
``serving.DecodeScheduler`` drives — requests join and retire between
decode steps, each slot at its own position. It takes no mesh (nor does
the reference's).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..core import DataType, TensorSpec, TensorsInfo
from ..parallel import collectives as C
from ..parallel.mesh import axis_group, axis_index, axis_size, mesh_device
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
from ..utils.tree import tree_map
from .transformer import TransformerConfig, init_params, shard_params


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


def _serving_device(device, mesh) -> torch.device:
    return resolve_device(device) if mesh is None \
        else mesh_device(mesh, device)


def _tp_mesh(mesh):
    """``mesh`` without its dp axis: the batch whole on every rank, heads
    still split over tp (None without a tp axis)."""
    if mesh is None or "tp" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh["tp"]


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
        return tree_map(lambda t: t.to(dtype), params)

    def _shard_params(self, mesh, device: torch.device) -> Dict[str, Any]:
        """This rank's parameters: Megatron shards when ``mesh`` has a tp
        axis of more than one rank, else the whole (replicated on a
        dp-only mesh). The one definition the whole-sequence and the
        streaming builds share."""
        params = self.build_params(device)
        tp = axis_size(mesh, "tp")
        if tp > 1:
            if self.cfg.heads % tp:
                raise ValueError(
                    f"lm_serving: heads={self.cfg.heads} not divisible by "
                    f"mesh tp={tp}")
            params = shard_params(self.cfg, mesh, params)
        return params

    def _build(self, mesh=None, device=None):
        device = _serving_device(device, mesh)
        max_seq = self._cfg_serve.max_seq
        params = self._shard_params(mesh, device)
        gen = make_generate(self.cfg, cache_len=self.cache_len, mesh=mesh)
        steps = _steps(self.default_steps)

        def serve(tokens: torch.Tensor):
            return (gen(params, tokens, steps),)

        if mesh is not None:
            whole = make_generate(self.cfg, cache_len=self.cache_len,
                                  mesh=_tp_mesh(mesh))
            serve.whole_batch = lambda tokens: (whole(params, tokens, steps),)

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

    def make(self, device=None):
        return self._build(None, device)

    def make_sharded(self, mesh, device=None):
        """The served callable against ``mesh`` (a dp or dp × tp
        ``DeviceMesh``, every rank building it together): this rank's
        shards, generating for its dp block of the batch."""
        return self._build(mesh, device)

    def make_streaming(self, device=None, temperature: float = 0.0, *,
                       mesh=None):
        """Per-token generation for the ``tensor_generate`` element:
        returns ``stream(tokens (B, P), steps, rng=None)``, which yields
        (B,) int32 on ``device`` (default the card) — prefill once, then
        one ``decode_step`` per yielded token. A host loop is the point:
        each token leaves the model as it is picked, so downstream
        elements render or forward it at once. ``temperature`` 0 = greedy;
        > 0 = sampling from a ``torch.Generator`` seeded with ``rng`` (an
        int, default 0); a continuation turn folds the session position
        into the seed, so it never repeats turn 1's draws.

        With ``mesh`` (dp, tp; every rank streams together, fed the same
        prompts) each rank decodes its dp block of the batch when dp
        divides it, else the whole batch, with its tp shards; each step's
        tokens are all-gathered over dp, so every rank yields (B,)."""
        device = _serving_device(device, mesh)
        cfg = self._cfg_serve
        params = self._shard_params(mesh, device)
        cache_dtype = params["embed"].dtype
        whole_mesh = _tp_mesh(mesh)

        @torch.inference_mode()
        def first(tokens, gen, m):
            cache = init_cache(cfg, tokens.shape[0] * axis_size(m, "dp"),
                               cache_dtype, device, mesh=m)
            logits, cache, pos = prefill(cfg, params, tokens, cache, m)
            return pick_token(logits, temperature, gen), pos, cache

        @torch.inference_mode()
        def step(token, pos, cache, gen, m):
            logits, cache = decode_step(cfg, params, token, pos, cache, m)
            return pick_token(logits, temperature, gen), pos + 1, cache

        @torch.inference_mode()
        def ingest(feed, cache, start, gen, m):
            logits, cache, pos = prefill_continue(cfg, params, feed, cache,
                                                  start, m)
            return pick_token(logits, temperature, gen), pos, cache

        def rows(t: torch.Tensor, m) -> torch.Tensor:
            """This rank's dp block of a global (B, ...) tensor."""
            return t.chunk(axis_size(m, "dp"))[axis_index(m, "dp")]

        @torch.inference_mode()
        def everyone(token: torch.Tensor, m) -> torch.Tensor:
            return C.all_gather_plain(token, axis_group(m, "dp"), 0)

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
            m = mesh if tokens.shape[0] % axis_size(mesh, "dp") == 0 \
                else whole_mesh
            if state is None:
                if tokens.shape[1] + steps > cfg.max_seq:
                    raise ValueError(
                        f"prompt ({tokens.shape[1]}) + steps ({steps}) "
                        f"exceeds max_seq {cfg.max_seq}")
                token, pos, cache = first(rows(tokens, m), gen, m)
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
                token, pos, cache = ingest(rows(feed, m), cache, pos, gen, m)
            # the state (the global tokens) is kept after every step, so
            # an abandoned generator leaves a session that continues where
            # it stopped
            token = everyone(token, m)
            if _session is not None:
                _session.state = (token, pos, cache)
            yield token
            for _ in range(steps - 1):
                token, pos, cache = step(rows(token, m), pos, cache, gen, m)
                token = everyone(token, m)
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

    def make_session(self, device=None, temperature: float = 0.0, *,
                     mesh=None):
        """Stateful multi-turn serving: ``session.generate(tokens, steps)``
        yields like the stream form, but the KV cache persists across
        calls (turn 2's prompt is ingested at the current position, not
        re-prefilled). ``session.reset()`` starts a new conversation."""
        return _StreamSession(self.make_streaming(device, temperature,
                                                  mesh=mesh))


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

# the full-width entry with every FFN a switch MoE of 8 experts (the
# reference's ``moe_experts`` field; no reference entry names such a model)
base_moe = _LMServingEntry(replace(base.cfg, moe_experts=8),
                           default_steps=64)
