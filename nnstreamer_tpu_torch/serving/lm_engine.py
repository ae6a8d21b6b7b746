"""Slot-based continuous-decode engines over the LM decoding primitives
(L6 serving ← models/decoding.py).

The port of nnstreamer_tpu's ``serving/lm_engine.py``. The batched paths
in ``models/lm_serving.py`` decode a FIXED batch: everyone prefills
together, everyone steps together. Continuous batching needs per-slot
independence — each sequence has its own position and lifetime.
nnstreamer_tpu gets it by vmapping ``decode_step`` over a slot axis; the
port calls ONE batched :func:`models.decoding.decode_step` with a ``(slots,)``
position vector, so each layer launches the decode-attention kernel once
for every slot, each slot at its own position.

Join protocol (driven by ``DecodeScheduler``):

* ``admit(slot, prompt, steps)`` — prefill the prompt in isolation
  (batch 1, the flash kernel on the card), writing its K/V straight into
  the slot's rows of the batched cache.
* ``step()`` — one decode step over ALL slots. Inactive slots compute at
  their stale position (0 after a release) and are ignored; ``admit``
  overwrites their state. The token and position carry stays on the
  device and advances there under the active mask: one device-to-host
  copy per step, the (slots,) tokens the scheduler needs.
* ``release(slot)`` — host bookkeeping plus the carry's upload; device
  cache rows are dead until the next admit overwrites them.

``compile_count`` keeps nnstreamer_tpu's meaning (one XLA trace per
program signature) as the number of distinct (program, input shape)
signatures the engine has run: the prefill per prompt length, the step,
the paged engine's fixed chunk.

Greedy (argmax) decoding only — the scheduler contract is deterministic
token streams.

Not in this package yet: the AOT-cache attach of the paged engine's
executables (``from_entry``), which comes with the AOT port.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional

import numpy as np
import torch

from ..models.decoding import _ffn, _split_heads, decode_step, prefill
from ..models.transformer import _mm, _rmsnorm
from ..obs import memory as obs_memory
from .request import ServingError

_engine_ids = itertools.count()


class ContinuousLMEngine:
    """Fixed-slot continuous decoder for a transformer config + params
    (build via ``lm_serving._LMServingEntry.make_continuous``). The state
    lives on the params' device."""

    def __init__(self, cfg, params, slots: int = 4):
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        # distinct (program, shape) signatures run: compile_count
        self._sigs: set = set()
        dev = self.device = params["embed"].device
        dtype = params["embed"].dtype
        shape = (slots, cfg.heads, cfg.max_seq, cfg.head_dim)
        # batched state: one (slots, H, T, D) K/V cache per layer
        self._cache = [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                        "v": torch.zeros(shape, dtype=dtype, device=dev)}
                       for _ in range(cfg.layers)]
        # host mirrors: authoritative for admit/release bookkeeping and
        # the scheduler's append/retire reads
        self._tok = np.zeros((slots,), np.int32)
        self._pos = np.zeros((slots,), np.int32)
        self._mask = np.zeros((slots,), bool)
        # memory accounting (obs/memory.py): the slot cache is static
        # (slots × max_seq), so one measurement at build is the truth
        self.cache_bytes = obs_memory.tree_nbytes(self._cache)
        self.param_bytes = obs_memory.tree_nbytes(params)
        self._mem_name = f"lm_engine#{next(_engine_ids)}"
        obs_memory.track_serving(self)
        self._sync_device_state()

    @property
    def compile_count(self) -> int:
        return len(self._sigs)

    def _sync_device_state(self) -> None:
        """Upload the decode carry (token/position/mask) from the host
        mirrors. Called at build, admit and release — the join protocol's
        slot edits — never per token: steady decode advances the carry on
        the device."""
        dev = self.device
        self._tok_dev = torch.from_numpy(self._tok.copy()).to(dev)
        self._pos_dev = torch.from_numpy(self._pos.copy()).to(dev)
        self._mask_dev = torch.from_numpy(self._mask.copy()).to(dev)

    # -- scheduler contract --------------------------------------------------
    def validate(self, tokens: np.ndarray, steps: int) -> None:
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError(
                f"prompt must be non-empty 1-D tokens, got {tokens.shape}")
        if tokens.size + steps > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({tokens.size}) + steps ({steps}) exceeds "
                f"max_seq {self.cfg.max_seq}")

    @torch.no_grad()
    def admit(self, slot: int, tokens: np.ndarray, steps: int) -> int:
        if self._mask[slot]:
            raise ServingError(f"slot {slot} already active")
        tokens = np.asarray(tokens, np.int32)
        self.validate(tokens, steps)
        self._sigs.add(("prefill", tokens.size))
        prompt = torch.from_numpy(tokens[None, :]).to(self.device)
        # the slot's rows of the batched cache, as a batch-1 cache: the
        # prefill writes positions [0, P) in place (later positions hold
        # the previous tenant's K/V, never visible before overwritten)
        view = [{"k": c["k"][slot:slot + 1], "v": c["v"][slot:slot + 1]}
                for c in self._cache]
        logits, _, pos = prefill(self.cfg, self.params, prompt, view)
        first = int(torch.argmax(logits[0]))
        self._tok[slot] = first
        self._pos[slot] = pos
        self._mask[slot] = True
        self._sync_device_state()
        return first

    @torch.no_grad()
    def step(self) -> np.ndarray:
        """One decode step over every slot; returns (slots,) int32 (only
        active-slot entries are meaningful)."""
        self._sigs.add(("step", self.slots))
        logits, _ = decode_step(self.cfg, self.params, self._tok_dev,
                                self._pos_dev, self._cache)
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        # advance the carry ON DEVICE: inactive slots keep their token and
        # position, active ones take the new token and step forward
        self._tok_dev = torch.where(self._mask_dev, out, self._tok_dev)
        self._pos_dev += self._mask_dev.to(torch.int32)
        tok = out.cpu().numpy()  # the step's one device-to-host copy
        self._pos = self._pos + self._mask.astype(np.int32)
        self._tok[self._mask] = tok[self._mask]
        return tok

    def release(self, slot: int) -> None:
        self._mask[slot] = False
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._sync_device_state()

    # -- introspection --------------------------------------------------------
    @property
    def active_slots(self) -> int:
        return int(self._mask.sum())

    def memory_bytes(self) -> dict:
        """Serving-plane byte source (obs/memory.py ``track_serving``):
        the slot KV cache + params this engine keeps resident, and how
        many slots are live in it."""
        return {"name": self._mem_name, "kind": "kv_cache",
                "bytes": self.cache_bytes,
                "param_bytes": self.param_bytes,
                "slots": self.slots, "active_slots": self.active_slots}


class PagedLMEngine:
    """Block-table paged continuous decoder.

    Where :class:`ContinuousLMEngine` gives every slot a dense ``max_seq``
    cache, this engine draws fixed-size pages from a
    :class:`~.kv_pool.KVPagePool` and addresses them through per-slot
    block tables, gathered and scattered on the device:

    * **pool layout** — ``k/v: (layers, pages+1, heads, page, head_dim)``;
      page 0 is the null sink inactive and pad writes route to (no
      branches in the scatter). A slot's logical position ``p`` lives at
      ``(block_table[p // page], p % page)``.
    * **chunked prefill** — ``admit_start`` queues the prompt and
      ``prefill_tick`` ingests ONE fixed-size chunk per call, so a long
      prompt interleaves with running decode, and the chunk is the only
      prefill shape (``compile_count`` is flat across prompt lengths).
    * **COW prefix sharing** — identical prompt prefixes resolve to the
      same pages via the pool's registry; ``_ensure_writable`` copies a
      shared page before any write lands in it.
    * **preempt/restore** — ``preempt`` pulls a slot's pages to the host
      and frees them; ``restore`` re-allocates and uploads them
      byte-exact.

    Attention is gather-then-dense, as in nnstreamer_tpu (no hand kernel
    there either). Parity contract: masked scores sit at -1e30 →
    exact-zero softmax weight, and the gathered context length equals
    ``max_seq``, so the paged step is token-exact against the dense
    engine.

    Indices are clamped where JAX clamps them: a position past the cache
    reads and writes its last entry, and a write that is not a live
    slot's goes to page 0.
    """

    def __init__(self, cfg, params, slots: int = 4, page_size: int = 16,
                 pages: Optional[int] = None, chunk: int = 32,
                 share_prefixes: bool = True, pool_name: Optional[str] = None):
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        page_size = min(page_size, cfg.max_seq)
        if cfg.max_seq % page_size:
            raise ValueError(
                f"max_seq {cfg.max_seq} must divide by page_size {page_size}")
        from .kv_pool import KVPagePool

        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.page_size = page_size
        self.blocks_per_slot = cfg.max_seq // page_size
        self.chunk = min(chunk, cfg.max_seq)
        self.share_prefixes = share_prefixes
        # distinct (program, shape) signatures run: compile_count
        self._sigs: set = set()
        dev = self.device = params["embed"].device

        if pages is None:
            pages = slots * self.blocks_per_slot  # dense-equivalent pool
        self._mem_name = pool_name or f"lm_engine#{next(_engine_ids)}"
        self.pool = KVPagePool(pages, page_size, name=self._mem_name)

        dtype = params["embed"].dtype
        L, H, Dh = cfg.layers, cfg.heads, cfg.head_dim
        pool_shape = (L, pages + 1, H, page_size, Dh)  # +1: null page 0
        self._kpool = torch.zeros(pool_shape, dtype=dtype, device=dev)
        self._vpool = torch.zeros(pool_shape, dtype=dtype, device=dev)
        NB = self.blocks_per_slot

        # host mirrors (authoritative; device copies re-synced on change)
        self._bt = np.zeros((slots, NB), np.int32)
        self._bt_dev: Optional[torch.Tensor] = None  # None = stale
        self._tok = np.zeros((slots,), np.int32)
        self._pos = np.zeros((slots,), np.int32)
        self._mask = np.zeros((slots,), bool)
        self._pending: "dict[int, dict]" = {}  # slot -> chunked-prefill state

        self.cache_bytes = obs_memory.tree_nbytes([self._kpool, self._vpool])
        self.page_bytes = int(2 * L * H * page_size * Dh
                              * self._kpool.element_size())
        self.param_bytes = obs_memory.tree_nbytes(params)
        obs_memory.track_serving(self)
        self._sync_device_state()

    @property
    def compile_count(self) -> int:
        return len(self._sigs)

    def _sync_device_state(self) -> None:
        """Re-upload the decode carry from the host mirrors
        (admit/release/preempt edits only — never per token)."""
        dev = self.device
        self._tok_dev = torch.from_numpy(self._tok.copy()).to(dev)
        self._pos_dev = torch.from_numpy(self._pos.copy()).to(dev)
        self._mask_dev = torch.from_numpy(self._mask.copy()).to(dev)

    def _block_tables(self) -> torch.Tensor:
        """The block tables on the device, uploaded again only after an
        edit (a page crossing, an admit, a release)."""
        if self._bt_dev is None:
            self._bt_dev = torch.from_numpy(self._bt.astype(np.int64)).to(
                self.device)
        return self._bt_dev

    def _set_block(self, slot: int, block, page) -> None:
        self._bt[slot, block] = page
        self._bt_dev = None

    # -- device programs ------------------------------------------------------
    def _gather_ctx(self, pool: torch.Tensor, li: int,
                    bt: torch.Tensor) -> torch.Tensor:
        """bt (S, NB) → (S, H, ctx, Dh): logical position p of slot s is
        element (s, :, p, :) — the layout of a dense cache."""
        g = pool[li][bt]                              # (S, NB, H, pg, Dh)
        S, NB, H, pg, Dh = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(S, H, NB * pg, Dh)

    def _attend(self, q, li, bt, visible):
        """Masked dense attention of q (S, H, n, Dh) over the gathered
        context; ``visible`` (S, 1, n, ctx)."""
        ck = self._gather_ctx(self._kpool, li, bt).float()
        cv = self._gather_ctx(self._vpool, li, bt).float()
        att = (q @ ck.transpose(-1, -2)) / math.sqrt(self.cfg.head_dim)
        att = torch.softmax(att.masked_fill(~visible, -1e30), dim=-1)
        return att @ cv                                # (S, H, n, Dh)

    def _forward_rows(self, toks, q_pos, dest, offs, bt, visible):
        """The model over tokens (S, n) at positions ``q_pos`` (S, n):
        each layer scatters the tokens' K/V to (dest, offs) and attends
        the gathered context. Returns the final hidden states (S, n, D)."""
        cfg, p = self.cfg, self.params
        S, n = toks.shape
        lp = q_pos.clamp(0, cfg.max_seq - 1)
        x = (p["embed"][toks.long()] + p["pos"][lp]).float()
        for li, blk in enumerate(p["blocks"]):
            h = _rmsnorm(x, blk["ln1"])
            q, k, v = (_split_heads(cfg, t)
                       for t in _mm(h, blk["wqkv"]).split(cfg.dim, dim=-1))
            # (S, H, n, Dh) -> (S, n, H, Dh) rows at (dest, offs)
            self._kpool[li][dest, :, offs] = k.transpose(1, 2).to(
                self._kpool.dtype)
            self._vpool[li][dest, :, offs] = v.transpose(1, 2).to(
                self._vpool.dtype)
            o = self._attend(q, li, bt, visible)
            o = o.transpose(1, 2).reshape(S, n, cfg.dim)
            x = x + _mm(o, blk["wo"])
            x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]))
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params
        return _mm(_rmsnorm(x, p["out_norm"]), p["embed"].T)

    def _slot_rows(self, q_pos: torch.Tensor, live: torch.Tensor,
                   bt: torch.Tensor):
        """(dest page, offset) of positions ``q_pos`` (S, n) of slots whose
        rows are ``live``; writes past the cache or not live go to the
        null page 0."""
        cfg, pg = self.cfg, self.page_size
        lp = q_pos.clamp(0, cfg.max_seq - 1)
        rows = torch.arange(bt.shape[0], device=bt.device)[:, None]
        dest = torch.where(live & (q_pos < cfg.max_seq),
                           bt[rows, lp // pg], torch.zeros_like(lp))
        return dest, lp % pg

    def _visible(self, q_pos: torch.Tensor) -> torch.Tensor:
        """(S, 1, n, ctx): context position <= the query's position."""
        ctx = torch.arange(self.cfg.max_seq, device=q_pos.device)
        return (ctx[None, None, :] <= q_pos[:, :, None])[:, None]

    def _step_program(self, bt: torch.Tensor) -> torch.Tensor:
        q_pos = self._pos_dev.long()[:, None]                   # (S, 1)
        dest, offs = self._slot_rows(q_pos, self._mask_dev[:, None], bt)
        x = self._forward_rows(self._tok_dev[:, None], q_pos, dest, offs,
                               bt, self._visible(q_pos))
        out = torch.argmax(self._logits(x[:, 0]), dim=-1).to(torch.int32)
        self._tok_dev = torch.where(self._mask_dev, out, self._tok_dev)
        self._pos_dev += self._mask_dev.to(torch.int32)
        return out

    # -- page bookkeeping -----------------------------------------------------
    def _ensure_writable(self, slot: int, lo: int, hi: int) -> None:
        """Make blocks covering logical positions [lo, hi) exclusively
        owned by ``slot``: allocate missing pages, COW-copy shared ones.
        Raises PagePoolExhausted (caller sheds or preempts)."""
        if hi <= lo:
            return
        for b in range(lo // self.page_size,
                       (hi - 1) // self.page_size + 1):
            page = int(self._bt[slot, b])
            if page == 0:
                # ownership lands in the block table atomically with the
                # alloc: release(slot) walks _bt on every exit path
                self._set_block(slot, b, self.pool.alloc(1)[0])  # pairs-with: release (slot exit)
            elif self.pool.is_shared(page):
                new = self.pool.alloc(1)[0]  # pairs-with: release (slot exit)
                try:
                    self._sigs.add(("copy_page",))
                    self._kpool[:, new] = self._kpool[:, page]
                    self._vpool[:, new] = self._vpool[:, page]
                except BaseException:
                    self.pool.release([new])  # copy failed: page never owned
                    raise
                self.pool.release([page])  # drop OUR ref; sibling keeps its page
                self._set_block(slot, b, new)
                self.pool.note_cow()

    def projected_page_bytes(self, tokens: int, steps: int) -> int:
        """Worst-case pool bytes a request needs (no sharing assumed) —
        the AdmissionGuard reservation unit (pages, not dense slots)."""
        n = -(-(tokens + steps) // self.page_size)
        return n * self.page_bytes

    # -- scheduler contract ---------------------------------------------------
    def validate(self, tokens: np.ndarray, steps: int) -> None:
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError(
                f"prompt must be non-empty 1-D tokens, got {tokens.shape}")
        if tokens.size + steps > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({tokens.size}) + steps ({steps}) exceeds "
                f"max_seq {self.cfg.max_seq}")

    def admit_start(self, slot: int, tokens: np.ndarray, steps: int) -> None:
        """Queue a prompt for chunked prefill (``prefill_tick`` drives
        it). Shared-prefix pages are mapped in immediately; only the
        uncovered tail is recomputed."""
        if self._mask[slot] or slot in self._pending:
            raise ServingError(f"slot {slot} already active")
        tokens = np.asarray(tokens, np.int32)
        self.validate(tokens, steps)
        covered = 0
        if self.share_prefixes:
            pages, covered = self.pool.lookup_prefix(tokens)
            if pages:
                self._set_block(slot, slice(0, len(pages)), pages)
                # always recompute >=1 position: the final prompt token's
                # logits seed the first generated token
                covered = min(covered, tokens.size - 1)
        self._pending[slot] = {"tokens": tokens, "next": covered,
                               "steps": steps}

    @torch.no_grad()
    def prefill_tick(self) -> "list[tuple[int, int]]":
        """Ingest ONE chunk of ONE pending prompt (oldest first);
        returns [(slot, first_token)] when that prompt completes, else
        []. The scheduler calls this once per loop pass so prefill
        interleaves with running decode instead of stalling it."""
        if not self._pending:
            return []
        slot = next(iter(self._pending))
        st = self._pending[slot]
        tokens, start = st["tokens"], st["next"]
        C = self.chunk
        n_valid = min(C, tokens.size - start)
        self._ensure_writable(slot, start, start + n_valid)
        self._sigs.add(("prefill_chunk", C))
        padded = np.zeros((1, C), np.int32)
        padded[0, :n_valid] = tokens[start:start + n_valid]
        dev = self.device
        bt = self._block_tables()[slot:slot + 1]                # (1, NB)
        q_pos = start + torch.arange(C, device=dev)[None]       # (1, C)
        valid = torch.arange(C, device=dev)[None] < n_valid
        dest, offs = self._slot_rows(q_pos, valid, bt)
        x = self._forward_rows(torch.from_numpy(padded).to(dev), q_pos,
                               dest, offs, bt, self._visible(q_pos))
        st["next"] = start + n_valid
        if st["next"] < tokens.size:
            return []
        # prompt complete: seed the decode carry from the last REAL row
        del self._pending[slot]
        first = int(torch.argmax(self._logits(x[0, n_valid - 1])))
        self._tok[slot] = first
        self._pos[slot] = tokens.size
        self._mask[slot] = True
        if self.share_prefixes:
            # register FULL pages only: registered pages are immutable —
            # this stream's later writes land at positions >= tokens.size,
            # past every registered page (COW guards the page-aligned
            # case where position size-1 is in the last registered page)
            nb_full = tokens.size // self.page_size
            if nb_full:
                self.pool.register_prefix(
                    tokens,
                    [int(p) for p in self._bt[slot, :nb_full] if p],
                    nb_full * self.page_size)
        self._sync_device_state()
        return [(slot, first)]

    def admit(self, slot: int, tokens: np.ndarray, steps: int) -> int:
        """Blocking admit (contract-compatible with the dense engine):
        runs the chunked prefill to completion before returning."""
        self.admit_start(slot, tokens, steps)
        while slot in self._pending:
            done = self.prefill_tick()
            for s, first in done:
                if s == slot:
                    return first
        raise ServingError(f"slot {slot} prefill did not complete")

    @torch.no_grad()
    def step(self) -> np.ndarray:
        """One paged decode step over every slot; may raise
        PagePoolExhausted when an active slot crosses into a page the
        pool cannot supply (scheduler preempts a victim and retries)."""
        for s in np.flatnonzero(self._mask):
            if self._pos[s] < self.cfg.max_seq:
                self._ensure_writable(int(s), int(self._pos[s]),
                                      int(self._pos[s]) + 1)
        self._sigs.add(("step", self.slots))
        out = self._step_program(self._block_tables())
        tok = out.cpu().numpy()  # the step's one device-to-host copy
        self._pos = self._pos + self._mask.astype(np.int32)
        self._tok[self._mask] = tok[self._mask]
        return tok

    def _verify_logits(self, draft: np.ndarray) -> torch.Tensor:
        """Score K tokens per slot in ONE pass — toks (S, K) = [carry,
        draft...] at positions pos..pos+K-1 — writing their K/V (rejected
        positions are hidden by the ``<= pos`` mask until overwritten).
        Returns logits (S, K, V)."""
        K = draft.shape[1]
        for s in np.flatnonzero(self._mask):
            lo = int(self._pos[s])
            self._ensure_writable(int(s), lo,
                                  min(lo + K, self.cfg.max_seq))
        bt = self._block_tables()
        toks = torch.from_numpy(np.ascontiguousarray(draft, np.int32)).to(
            self.device)
        q_pos = (self._pos_dev.long()[:, None]
                 + torch.arange(K, device=self.device)[None])   # (S, K)
        dest, offs = self._slot_rows(q_pos, self._mask_dev[:, None], bt)
        x = self._forward_rows(toks, q_pos, dest, offs, bt,
                               self._visible(q_pos))
        return self._logits(x)

    @torch.no_grad()
    def verify(self, draft: np.ndarray) -> np.ndarray:
        """Score ``draft`` (slots, K) token blocks in one call → logits
        (slots, K, vocab) on the host. Column 0 must be each slot's carry
        token; columns 1.. are proposals."""
        self._sigs.add(("verify", draft.shape[1]))
        return self._verify_logits(draft).float().cpu().numpy()

    @torch.no_grad()
    def verify_commit(self, draft: np.ndarray):
        """Fused speculative round: verify ``draft`` (slots, K) AND
        resolve greedy acceptance + carry advance on the device. Returns
        ``(pred, n_emit)`` — slot ``s`` emitted ``pred[s, :n_emit[s]]``
        (accepted drafts equal the target argmax by definition; the last
        entry is the correction). The carry stays on the device: one
        (slots, K+1) int copy to the host per round."""
        S, K = draft.shape
        self._sigs.add(("verify_commit", K))
        logits = self._verify_logits(draft)
        dev = self.device
        toks = torch.from_numpy(np.ascontiguousarray(draft, np.int32)).to(dev)
        pred = torch.argmax(logits, dim=-1).to(torch.int32)   # (S, K)
        budget = self.cfg.max_seq - self._pos_dev               # emit ceiling
        # accept proposal i (column i+1) while every earlier one matched
        # and the emit budget allows position i+1
        ok = ((toks[:, 1:] == pred[:, :-1])
              & (torch.arange(K - 1, device=dev)[None] < (budget - 1)[:, None]))
        j = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        n_emit = torch.where(self._mask_dev & (budget > 0), j + 1,
                             torch.zeros_like(j)).to(torch.int32)
        last = pred[torch.arange(S, device=dev),
                    (n_emit - 1).clamp(min=0).long()]
        self._tok_dev = torch.where(n_emit > 0, last, self._tok_dev)
        self._pos_dev += n_emit
        # [n_emit | pred] in ONE (S, K+1) array: one copy per round
        packed = torch.cat([n_emit[:, None], pred], dim=1).cpu().numpy()
        n_emit, pred = packed[:, 0], packed[:, 1:]
        for s in np.flatnonzero(n_emit):
            n = int(n_emit[s])
            self._pos[s] += n
            self._tok[s] = int(pred[s, n - 1])
        return pred, n_emit

    def release(self, slot: int) -> None:
        self._pending.pop(slot, None)
        self.pool.release([int(p) for p in self._bt[slot] if p])  # pairs-with: alloc/ref (admit path)
        self._set_block(slot, slice(None), 0)
        self._mask[slot] = False
        self._tok[slot] = 0
        self._pos[slot] = 0
        self._sync_device_state()

    # -- preemption -----------------------------------------------------------
    @torch.no_grad()
    def preempt(self, slot: int) -> dict:
        """Evict a slot to the host: copy its pages out, free them,
        deactivate. The returned blob restores the request byte-exact
        later — memory pressure never DROPS work."""
        if not self._mask[slot]:
            raise ServingError(f"slot {slot} not active")
        used = self._bt[slot] != 0
        pages = torch.from_numpy(self._bt[slot][used].astype(np.int64)).to(
            self.device)
        # the used pages' bytes, (L, n_used, H, page, Dh), on the host
        blob = {"k": self._kpool[:, pages].cpu(),
                "v": self._vpool[:, pages].cpu(),
                "used": used.copy(), "tok": int(self._tok[slot]),
                "pos": int(self._pos[slot])}
        self.pool.release([int(p) for p in self._bt[slot] if p])  # pairs-with: alloc/ref (admit path)
        self._set_block(slot, slice(None), 0)
        self._mask[slot] = False
        self._sync_device_state()
        self.pool.note_preemption()
        return blob

    @torch.no_grad()
    def restore(self, slot: int, blob: dict) -> None:
        """Re-admit a preempted request: fresh pages, byte-exact upload,
        decode resumes mid-sequence. Raises PagePoolExhausted if the pool
        still cannot hold it (scheduler keeps it queued)."""
        if self._mask[slot]:
            raise ServingError(f"slot {slot} already active")
        used = blob["used"]
        fresh = self.pool.alloc(int(used.sum()))  # pairs-with: release (slot exit)
        row = np.zeros_like(self._bt[slot])
        row[used] = fresh
        self._set_block(slot, slice(None), row)
        dest = torch.from_numpy(np.asarray(fresh, np.int64)).to(self.device)
        self._kpool[:, dest] = blob["k"].to(self.device)
        self._vpool[:, dest] = blob["v"].to(self.device)
        self._tok[slot] = blob["tok"]
        self._pos[slot] = blob["pos"]
        self._mask[slot] = True
        self._sync_device_state()
        self.pool.note_restore()

    def slot_pages(self, slot: int) -> torch.Tensor:
        """The K and V bytes of ``slot``'s used pages, (2, L, n, H, page,
        Dh) on the device — what preempt/restore must keep byte-exact."""
        used = torch.from_numpy(
            self._bt[slot][self._bt[slot] != 0].astype(np.int64)).to(
                self.device)
        return torch.stack([self._kpool[:, used], self._vpool[:, used]])

    # -- introspection --------------------------------------------------------
    @property
    def active_slots(self) -> int:
        return int(self._mask.sum())

    def memory_bytes(self) -> dict:
        """Serving-plane byte source (obs/memory.py ``track_serving``):
        the page pool is the engine's resident buffer; page occupancy
        rides along."""
        s = self.pool.stats()
        return {"name": self._mem_name, "kind": "kv_pool",
                "bytes": self.cache_bytes,
                "param_bytes": self.param_bytes,
                "slots": self.slots, "active_slots": self.active_slots,
                "pages_total": s["pages_total"],
                "pages_used": s["pages_used"],
                "pages_shared": s["pages_shared"],
                "page_bytes": self.page_bytes}

    def close(self) -> None:
        for slot in range(self.slots):
            if self._mask[slot] or self._bt[slot].any():
                self.release(slot)
        self.pool.close()


def from_entry(entry, slots: int = 4, mesh=None, paged: bool = False,
               device=None, **paged_kw):
    """Build an engine from an ``lm_serving`` entry (params initialized /
    dtype-cast per the entry's serve knobs) on ``device`` (default the
    card). ``mesh`` is reserved for sharded slot state — one device only
    today. ``paged=True`` builds the block-table :class:`PagedLMEngine`
    (``paged_kw``: page_size/pages/chunk/share_prefixes)."""
    if mesh is not None:
        raise NotImplementedError(
            "continuous decode is single-device today; shard the batch "
            "with the whole-sequence lm_serving paths instead")
    from ..utils.hw_accel import resolve_device

    cfg = entry._cfg_serve
    params = entry.build_params(resolve_device(device))
    if paged:
        return PagedLMEngine(cfg, params, slots=slots, **paged_kw)
    return ContinuousLMEngine(cfg, params, slots=slots)


__all__: List[str] = ["ContinuousLMEngine", "PagedLMEngine", "from_entry"]
