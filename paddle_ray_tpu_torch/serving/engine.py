"""Continuous-batching paged serving engine with chunked-prefill mixed
steps and a cross-request prefix cache (the port of
``paddle_ray_tpu/serving/engine.py``, synchronous path).

Two layers:

* **functional steps** -- :func:`paged_mixed_step` runs ragged chunks of
  tokens (a decode token here, a prefill slice there) through the whole
  model in one step, with ONE ragged paged-attention kernel launch per
  layer; :func:`paged_decode_step` is its ``C == 1`` view.
* :class:`ServingEngine` -- host-side continuous batching with a
  token-budget scheduler: every iteration packs one decode token per live
  decoding slot plus chunked prefill slices of admitted requests into one
  mixed step, so a long prompt never stalls the decoders.

Scheduler knobs: ``token_budget`` (max tokens per step, decode first),
``chunk_size`` (max prefill tokens one slot takes per step); the step's
query width is padded to a power-of-two bucket (:meth:`token_budget_buckets`)
so step shapes match the JAX engine's executable family.  The prefix
cache (on by default) shares full KV pages across requests with a common
prompt prefix and copies a partially matched page on write.

Sampling is per request (``temperature`` / ``top_k`` / ``top_p`` /
``seed`` on :meth:`ServingEngine.submit`) and runs on the device with
JAX's threefry keys ``fold_in(PRNGKey(seed), position)``, so a request's
stream depends only on its seed and its positions.  A step whose rows are
all greedy takes the argmax alone (the same tokens, without the sampling
work).  ``kv_cache_dtype="int8"`` keeps the pool int8 per (token, head).

Where the JAX step donated the pool buffers, these steps update the pool
tensors in place.  Not ported yet: async double-buffered dispatch,
speculative decoding, cancel/deadline/preemption, fault injection,
telemetry, the page sanitizer and TP sharding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.generation import (_block_decode, _block_prefill, _embed_at,
                                 _embed_chunk, _head_logits, _kv_quant,
                                 _qkv_chunk, fold_sample_keys, sample_tokens)
from ..ops.paged_attention import DEFAULT_PAGE_SIZE, paged_ragged_attention
from .page_pool import PagePool
from .prefix_cache import PrefixCache, PrefixMatch

__all__ = ["RequestStatus", "ServingEngine", "ServingStats", "RequestStats",
           "paged_decode_step", "paged_mixed_step", "paged_prefill"]

_MIN_CHUNK_BUCKET = 8
# times a pool-pressure-blocked request may rotate behind the queue
# (the JAX engine's default ``retry_budget``)
_RETRY_BUDGET = 3


def percentile(sorted_vals, q: float) -> float:
    """Percentile of an ascending-sorted sequence (0.0 when empty), with
    the index convention of the JAX package's telemetry."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


# ---------------------------------------------------------------------------
# functional paged model steps
# ---------------------------------------------------------------------------
def _scatter_rows(pools: Tuple, layer: int, page_ids: torch.Tensor,
                  slots: torch.Tensor, k_t: torch.Tensor,
                  v_t: torch.Tensor) -> Tuple:
    """Write one KV row per (sequence, token) into the layer's pages, in
    place (an int8 pool takes the rows quantized per (token, head)).  Rows
    routed to the null page 0 are the masked writes: several may hit the
    same row of page 0 and land in any order, which is harmless there -- a
    live page never receives two rows at one index."""
    if len(pools) == 4:
        for (dst_q, dst_s), x in zip((pools[:2], pools[2:]), (k_t, v_t)):
            xq, xs = _kv_quant(x)
            dst_q[layer, page_ids, slots] = xq
            dst_s[layer, page_ids, slots] = xs[..., 0]
        return pools
    k, v = pools
    k[layer, page_ids, slots] = k_t.to(k.dtype)
    v[layer, page_ids, slots] = v_t.to(v.dtype)
    return pools


def paged_prefill(model, ids, t0: int, page_table,
                  pools: Tuple) -> Tuple[Tuple, torch.Tensor]:
    """One-shot prompt prefill into pages: full causal attention over
    ``ids`` ``[B, L]`` (right-padded; ``t0`` is the true prompt length),
    K/V rows ``t < t0`` scattered into each sequence's pages, pad rows
    routed to the null page.  Returns ``(pools, logits [B, V])`` at the
    last true prompt token.  The static-batch surface of
    ``generate(kv_layout="paged")``; the engine prefills through
    :func:`paged_mixed_step` chunks."""
    b, length = ids.shape
    page = pools[0].shape[2]
    h = _embed_at(model, ids.long(), slice(0, length))
    tpos = torch.arange(length, device=ids.device)
    block = (tpos // page).clamp(max=page_table.shape[1] - 1)
    page_ids = torch.where(tpos[None, :] < t0,
                           page_table.long()[:, block],
                           torch.zeros((), dtype=torch.long,
                                       device=ids.device))
    slots = (tpos % page).expand(b, length)
    for layer, blk in enumerate(model.blocks):
        h, k, v = _block_prefill(blk, h)        # k/v: [B, L, h_kv, d]
        pools = _scatter_rows(pools, layer, page_ids, slots, k, v)
    return pools, _head_logits(model, h[:, t0 - 1:t0])[:, 0]


def paged_decode_step(model, toks, positions, lengths, page_table,
                      pools: Tuple) -> Tuple[Tuple, torch.Tensor]:
    """One ragged decode step for the whole slot set -- the ``C == 1``
    view of :func:`paged_mixed_step`.  toks/positions/lengths ``[S]``;
    ``lengths == 0`` marks a dead slot.  Returns ``(pools, logits [S, V])``."""
    q_lens = (lengths > 0).to(torch.int32)
    return paged_mixed_step(model, toks[:, None], positions[:, None],
                            q_lens, lengths, page_table, pools)


def paged_mixed_step(model, toks, positions, q_lens, lengths, page_table,
                     pools: Tuple, host_lengths=None
                     ) -> Tuple[Tuple, torch.Tensor]:
    """One mixed serving step through the whole model, one ragged
    paged-attention launch per layer.

    toks ``[S, C]`` right-padded token chunks per slot; positions
    ``[S, C]`` each token's absolute position (pad rows: anything in
    range); q_lens ``[S]`` int32 valid tokens per slot (0 = dead slot);
    lengths ``[S]`` int32 tokens in cache after this chunk's append;
    page_table ``[S, P]`` int32; pools ``(k, v)`` ``[L, N, page, h, d]``,
    updated in place; host_lengths: optional host copy of ``lengths``
    (sizes the int8 pool's split-K).  Returns ``(pools, logits [S, V])`` at
    each slot's last valid row -- the LM head projects only those rows."""
    s, c = toks.shape
    page = pools[0].shape[2]
    toks, positions = toks.long(), positions.long()
    valid = torch.arange(c, device=toks.device)[None, :] < q_lens[:, None]
    block = (positions // page).clamp(0, page_table.shape[1] - 1)
    page_ids = torch.where(valid, torch.gather(page_table.long(), 1, block),
                           torch.zeros_like(block))
    slots = positions % page
    scale = 1.0 / (model.cfg.head_dim ** 0.5)
    x = _embed_chunk(model, toks, positions)
    for layer, blk in enumerate(model.blocks):
        def attn_fn(attn, xin, pools, _pos, *, layer=layer):
            q, k, v = _qkv_chunk(attn, xin, positions)  # [S, C, h, d]
            pools = _scatter_rows(pools, layer, page_ids, slots, k, v)
            pool_l = tuple(p[layer] for p in pools)
            o = paged_ragged_attention(q, pool_l, page_table, lengths,
                                       q_lens, scale=scale,
                                       host_lengths=host_lengths)
            return attn.out(o.reshape(s, c, -1)), pools

        x, pools = _block_decode(blk, x, pools, None, attn_fn)
    last = (q_lens.long() - 1).clamp(0, c - 1)
    x_last = x[torch.arange(s, device=x.device), last]
    return pools, _head_logits(model, x_last[:, None])[:, 0]


def _mixed_step(model, toks, positions, q_lens, lengths, table, pools,
                sampling: Optional[Tuple] = None, host_lengths=None
                ) -> Tuple[Tuple, torch.Tensor]:
    """The engine's serving step: the mixed forward, then the tokens on
    the device.  ``sampling`` is ``(temps, top_ks, top_ps, seeds)``, all
    ``[S]``, with keys ``fold_in(PRNGKey(seed), lengths)`` per row; None
    when every row is greedy (the argmax alone, the same tokens).  Returns
    ``(pools, tokens [S] int32)``."""
    pools, logits = paged_mixed_step(model, toks, positions, q_lens,
                                     lengths, table, pools, host_lengths)
    if sampling is None:
        return pools, torch.argmax(logits, dim=-1).to(torch.int32)
    temps, top_ks, top_ps, seeds = sampling
    keys = fold_sample_keys(seeds, lengths)
    return pools, sample_tokens(logits, keys, temps, top_ks, top_ps)


def _copy_page_all_layers(src: int, dst: int, pools: Tuple) -> Tuple:
    """Whole-page copy (all layers, both operands), in place."""
    for a in pools:
        a[:, dst].copy_(a[:, src])
    return pools


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class RequestStatus:
    """Terminal request states.  This engine retires every request
    ``OK``; cancel, deadline and failure states arrive with the request
    lifecycle."""
    OK = "OK"


@dataclasses.dataclass
class ServingStats:
    """The JAX engine's stats schema.  The speculation and lifecycle
    counters stay zero until those features are ported."""
    prefill_tokens: int = 0            # true prompt tokens prefilled
    padded_prefill_tokens: int = 0     # bucket-padded tokens computed
    decode_tokens: int = 0             # tokens produced by decode lanes
    prefix_hit_tokens: int = 0         # prompt tokens served from cache
    draft_tokens: int = 0
    accepted_tokens: int = 0
    # throughput pairs: tokens and seconds both exclude each width's
    # first step (kernel build, library warm-up)
    timed_prefill_tokens: int = 0
    timed_decode_tokens: int = 0
    prefill_s: float = 0.0             # warm step time, prefill share
    decode_s: float = 0.0              # warm step time, decode share
    decode_step_s: List[float] = dataclasses.field(default_factory=list)
    decode_step_width: List[int] = dataclasses.field(default_factory=list)
    mixed_steps: int = 0
    requests_finished: int = 0
    blocked_pool_pressure: int = 0     # admission waits: not enough pages
    blocked_no_slot: int = 0           # admission waits: batch is full
    preempted_total: int = 0
    cancelled_total: int = 0
    deadline_expired_total: int = 0
    step_failures: int = 0
    retries_total: int = 0             # blocked-admission rotations

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.draft_tokens, 1)

    def to_dict(self) -> Dict:
        """Raw totals plus the derived throughput pairs and step-time
        percentiles, in the JAX engine's schema."""
        steps = sorted(1e3 * t for t in self.decode_step_s)
        return {
            "prefill_tokens": self.prefill_tokens,
            "padded_prefill_tokens": self.padded_prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "timed_prefill_tokens": self.timed_prefill_tokens,
            "timed_decode_tokens": self.timed_decode_tokens,
            "prefill_s": round(self.prefill_s, 6),
            "decode_s": round(self.decode_s, 6),
            "prefill_tokens_per_s": round(
                self.timed_prefill_tokens / max(self.prefill_s, 1e-9), 1),
            "decode_tokens_per_s": round(
                self.timed_decode_tokens / max(self.decode_s, 1e-9), 1),
            "p50_token_ms": round(percentile(steps, 0.5), 3),
            "p99_token_ms": round(percentile(steps, 0.99), 3),
            "mixed_steps": self.mixed_steps,
            "requests_finished": self.requests_finished,
            "blocked_pool_pressure": self.blocked_pool_pressure,
            "blocked_no_slot": self.blocked_no_slot,
            "preempted_total": self.preempted_total,
            "cancelled_total": self.cancelled_total,
            "deadline_expired_total": self.deadline_expired_total,
            "step_failures": self.step_failures,
            "retries_total": self.retries_total,
        }


@dataclasses.dataclass
class RequestStats:
    """Per-request lifecycle record, ``engine.request_stats[rid]`` once
    the request retired."""
    rid: int
    prompt_tokens: int = 0
    prefix_hit_tokens: int = 0         # prompt rows shared/copied, not computed
    decode_tokens: int = 0             # tokens generated (incl. first)
    draft_tokens: int = 0
    accepted_tokens: int = 0
    submitted_t: float = 0.0
    admitted_t: float = 0.0
    first_token_t: float = 0.0
    finished_t: float = 0.0
    status: str = RequestStatus.OK
    retries: int = 0
    preemptions: int = 0
    # commit timestamp of every generated token
    token_t: List[float] = dataclasses.field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def itl_s(self) -> List[float]:
        """Inter-token latencies (seconds) between consecutive commits."""
        return [max(b - a, 0.0)
                for a, b in zip(self.token_t, self.token_t[1:])]

    @property
    def queue_s(self) -> float:
        return max(self.admitted_t - self.submitted_t, 0.0)

    @property
    def ttft_s(self) -> float:
        """Submit -> first token."""
        return max(self.first_token_t - self.submitted_t, 0.0)

    @property
    def total_s(self) -> float:
        return max(self.finished_t - self.submitted_t, 0.0)

    def to_dict(self) -> Dict:
        itl = sorted(1e3 * g for g in self.itl_s)
        return {
            "rid": self.rid,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "decode_tokens": self.decode_tokens,
            "draft_tokens": self.draft_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "queue_s": round(self.queue_s, 6),
            "ttft_s": round(self.ttft_s, 6),
            "total_s": round(self.total_s, 6),
            "itl_p50_ms": round(percentile(itl, 0.5), 3),
            "itl_p99_ms": round(percentile(itl, 0.99), 3),
            "status": self.status,
            "retries": self.retries,
            "preemptions": self.preemptions,
        }


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    stats: RequestStats
    retries: int = 0                   # blocked-admission rotations
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0                      # effective seed (user's, or rid)


@dataclasses.dataclass
class _Slot:
    req: _Request
    pages: List[int]                   # owned refs (shared pages incref'd)
    length: int                        # tokens in cache
    fill: int                          # next prompt row to prefill
    pending: int = -1                  # sampled token not yet appended
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.fill < len(self.req.prompt)


@dataclasses.dataclass
class _Lane:
    """One slot's share of one dispatched step."""
    idx: int                           # batch slot index
    slot: _Slot
    take: int                          # rows appended by this step
    prefilling: bool = False           # was a prefill lane at dispatch
    completes: bool = False            # prefill completes this step


@dataclasses.dataclass
class _Dispatched:
    """A dispatched step: the device token result plus what the commit
    needs."""
    lanes: List[_Lane]
    tokens: torch.Tensor               # [S] int32, on the device
    width: int
    warm: bool
    t_start: float
    n_dec: int
    n_pre: int


class ServingEngine:
    """Continuous-batching decode over a paged KV pool.

    ``submit()`` enqueues prompts; ``step()`` admits what fits, runs ONE
    mixed step (decode tokens + prefill chunks packed under
    ``token_budget``) and commits its tokens; ``run()`` drives to drain.

    Knobs: ``page_size``, ``max_batch``, ``num_pages`` (default: every slot
    at ``max_seq_len``, plus the null page), ``max_seq_len``,
    ``kv_cache_dtype`` (``"model"``, or ``"int8"`` per (token, head)),
    ``eos_token_id``, ``chunk_size`` (max prefill tokens one slot takes
    per step; default ``2 * page_size``), ``token_budget`` (max tokens per
    step; default ``max_batch + chunk_size``), ``prefix_cache``
    (cross-request prompt-prefix page sharing, default on) and ``device``
    (default CUDA; the model must live there).
    """

    def __init__(self, model, *, page_size: int = DEFAULT_PAGE_SIZE,
                 max_batch: int = 8, num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 kv_cache_dtype: str = "model",
                 eos_token_id: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = True, device=None):
        if kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
        device = resolve_device(device)
        if model.device.type != device.type or (
                device.index is not None and model.device != device):
            raise ValueError(f"model is on {model.device}, engine on {device}")
        self.device = model.device
        cfg = model.cfg
        self.model = model
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.eos_token_id = eos_token_id
        self.chunk_size = chunk_size or min(2 * page_size, self.max_seq_len)
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.token_budget = token_budget or (max_batch + self.chunk_size)
        if self.token_budget <= max_batch:
            # a full decode batch would starve prefill forever
            raise ValueError(
                f"token_budget {self.token_budget} must exceed max_batch "
                f"{max_batch} so prefill chunks can make progress")
        self.blocks_per_seq = -(-self.max_seq_len // page_size)
        if num_pages is None:
            num_pages = 1 + max_batch * self.blocks_per_seq
        self.pool = PagePool(cfg.num_layers, num_pages, page_size,
                             cfg.num_heads, cfg.head_dim, dtype=model.dtype,
                             quantized=kv_cache_dtype == "int8",
                             device=self.device)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self._table = np.zeros((max_batch, self.blocks_per_seq), np.int32)
        self._slots: List[Optional[_Slot]] = [None] * max_batch
        self._queue: List[_Request] = []
        self._results: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._widths_run: set = set()
        self.stats = ServingStats()
        self.request_stats: Dict[int, RequestStats] = {}
        self.admission_blocked: Optional[str] = None
        # (head rid, cache generation, free pages, active) of the last
        # failed admission: while none of these change, retrying cannot
        # succeed, so _admit skips the re-match
        self._blocked_state: Optional[tuple] = None

    # -- public surface --------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: Optional[int] = None) -> int:
        """Enqueue a request; returns its rid.

        ``temperature <= 0`` (the default) is greedy; ``temperature > 0``
        samples, with optional ``top_k`` / ``top_p`` cuts, from
        ``fold_in(PRNGKey(seed), position)`` keys -- deterministic given
        ``seed`` (default: the rid, folded to uint32 like any seed) and
        independent of batching and admission order."""
        if temperature < 0 or top_k < 0 or not 0.0 < top_p <= 1.0:
            raise ValueError(
                f"bad sampling params: temperature={temperature} (>=0), "
                f"top_k={top_k} (>=0), top_p={top_p} (in (0, 1])")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) == 0 or max_new_tokens <= 0:
            raise ValueError("need a non-empty prompt and max_new_tokens>0")
        vocab = self.model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            # an out-of-range id would fault the embedding gather on the
            # device, taking every co-batched request down with it
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"rejected: prompt {len(prompt)} + max_new_tokens "
                f"{max_new_tokens} exceeds max_seq_len {self.max_seq_len}")
        # worst case caches t0 + max_new - 1 rows (the last sampled token
        # never lands in cache) -- the same formula as admission
        need = -(-(len(prompt) + max_new_tokens - 1) // self.page_size)
        if need > self.pool.num_pages - 1:
            raise ValueError(
                f"rejected: pool pressure can never clear -- request needs "
                f"{need} pages worst-case; the pool only has "
                f"{self.pool.num_pages - 1}")
        rid = self._next_rid
        self._next_rid += 1
        rstats = RequestStats(rid, prompt_tokens=len(prompt),
                              submitted_t=time.perf_counter())
        self._queue.append(_Request(
            rid, prompt, max_new_tokens, rstats,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            seed=int(rid if seed is None else seed) & 0xFFFFFFFF))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    def token_budget_buckets(self) -> List[int]:
        """The mixed step's padded chunk widths: 1 (pure decode) plus
        powers of two up to ``chunk_size``."""
        out, b = [1], _MIN_CHUNK_BUCKET
        while b < self.chunk_size:
            out.append(b)
            b *= 2
        if self.chunk_size > 1:
            out.append(self.chunk_size)
        return out

    def pool_stats(self) -> Dict:
        """Pool snapshot with the engine's live-token knowledge folded in
        (each distinct physical page counts once)."""
        page = self.page_size
        rows: Dict[int, int] = {}
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            for b in range(-(-slot.length // page) if slot.length else 0):
                pid = int(self._table[i, b])
                rows[pid] = max(rows.get(pid, 0),
                                min(page, slot.length - b * page))
        if self.prefix is not None:
            for pid in self.prefix.pages():     # cached pages are full
                rows[pid] = page
        return self.pool.stats(live_tokens=sum(rows.values()))

    def clear_prefix_cache(self) -> int:
        """Drop every cache-held page; pages shared with live requests
        survive under their own refs."""
        return self.prefix.clear() if self.prefix is not None else 0

    def step(self) -> List[Tuple[int, np.ndarray]]:
        """Admit what fits, run one mixed decode+prefill step, and commit
        its tokens.  Returns the requests that finished."""
        finished: List[Tuple[int, np.ndarray]] = []
        self._admit()
        if self.active:
            plan, n_dec, n_pre = self._schedule()
            self._reconcile(self._dispatch(plan, n_dec, n_pre), finished)
        return finished

    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted request finished.
        Returns ``{rid: generated tokens}`` (prompt not included)."""
        for _ in range(max_steps):
            if not self._queue and not self.active:
                break
            self.step()
        if self._queue or self.active:
            raise RuntimeError("serving did not drain; raise max_steps")
        return dict(self._results)

    # -- admission -------------------------------------------------------
    def _chunk_bucket(self, c: int) -> int:
        """Smallest declared bucket >= c."""
        return min(b for b in self.token_budget_buckets() if b >= c)

    def _worst_case_pages(self, slot: _Slot) -> int:
        """Pages this slot may still need: its constant worst-case
        footprint (``t0 + max_new - 1`` cached rows) minus what it owns.
        It must not shrink with decode progress, or admission would
        double-book the pool."""
        total = -(-(len(slot.req.prompt) + slot.req.max_new_tokens - 1)
                  // self.page_size)
        return max(total - len(slot.pages), 0)

    def _alloc(self, n: int) -> List[int]:
        """Pool alloc with cache back-pressure: under shortage the prefix
        cache gives back LRU pages first."""
        short = n - self.pool.num_free
        if short > 0 and self.prefix is not None:
            self.prefix.evict(short)
        return self.pool.alloc(n)

    def _admission_state(self) -> tuple:
        return (self._queue[0].rid if self._queue else None,
                self.prefix.generation if self.prefix is not None else 0,
                self.pool.num_free, self.active)

    def _admit(self) -> None:
        if self._admission_state() == self._blocked_state:
            return                      # nothing changed; still blocked
        self.admission_blocked = None
        self._blocked_state = None
        attempts = len(self._queue)     # each queued request tried once
        while self._queue and attempts > 0:
            attempts -= 1
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            if not free_slots:
                self.admission_blocked = (
                    f"no free slot: all {self.max_batch} batch slots busy")
                self.stats.blocked_no_slot += 1
                self._blocked_state = self._admission_state()
                return
            req = self._queue[0]
            # safe admission: this request's full worst case plus every
            # running sequence's remaining growth must fit the pool (free
            # pages + what the cache can give back).  _gate locks the
            # match first so its pages stop counting as reclaimable.
            m: Optional[PrefixMatch] = None
            if self.prefix is not None:
                cand = self.prefix.match(req.prompt)
                if self._gate(req, cand):
                    m = cand
            if m is None:
                # no cache, or the locked match pinned pages a tight pool
                # needs: degrade to a cold admission
                cold = PrefixMatch(shared=[])
                if not self._gate(req, cold):
                    self.stats.blocked_pool_pressure += 1
                    if (len(self._queue) > 1
                            and req.retries < _RETRY_BUDGET):
                        # rotate behind the queue so smaller requests
                        # can try this step
                        self._requeue_blocked(req)
                        continue
                    self._blocked_state = self._admission_state()
                    return
                m = cold
            self._queue.pop(0)
            self._place(free_slots[0], req, m)

    def _requeue_blocked(self, req: _Request) -> None:
        req.retries += 1
        req.stats.retries += 1
        self.stats.retries_total += 1
        self._queue.pop(0)
        self._queue.append(req)

    def _gate(self, req: _Request, m: PrefixMatch) -> bool:
        """Take the match and pass the capacity gate; on failure roll the
        lock back, record why, and return False."""
        if self.prefix is not None:
            self.prefix.lock(m)
        need = (-(-(len(req.prompt) + req.max_new_tokens - 1)
                  // self.page_size) - len(m.shared))
        committed = sum(self._worst_case_pages(s)
                        for s in self._slots if s is not None)
        avail = self.pool.num_free + (
            self.prefix.evictable_pages() if self.prefix is not None
            else 0)
        if need + committed > avail:
            if self.prefix is not None:
                self.prefix.unlock(m)
            self.admission_blocked = (
                f"pool pressure: request {req.rid} needs {need} pages "
                f"worst-case + {committed} committed to running "
                f"sequences, only {avail} reclaimable")
            return False
        self.admission_blocked = None
        return True

    def _place(self, slot_idx: int, req: _Request, m: PrefixMatch) -> None:
        """Map a request into a batch slot: shared prefix pages straight
        into the page table, a copy-on-write page if the hit ends
        mid-page, fresh pages for the rest of the prompt."""
        t0 = len(req.prompt)
        n_prompt_pages = -(-t0 // self.page_size)
        fresh = self._alloc(n_prompt_pages - len(m.shared))
        pages = list(m.shared) + fresh
        self._table[slot_idx] = 0
        self._table[slot_idx, :len(pages)] = pages
        if m.copy_src is not None:
            # rows past the hit are overwritten by the suffix prefill or
            # masked by length; lock() pinned the source against eviction
            self._copy_page(m.copy_src, fresh[0])
            self.prefix.release_copy_src(m)
        self._slots[slot_idx] = _Slot(req, pages, length=m.hit_tokens,
                                      fill=m.hit_tokens)
        req.stats.admitted_t = time.perf_counter()
        req.stats.prefix_hit_tokens += m.hit_tokens
        self.stats.prefix_hit_tokens += m.hit_tokens
        if self.prefix is not None:
            self.prefix.record(m)

    # -- the mixed step --------------------------------------------------
    def _schedule(self) -> Tuple[List[Tuple[int, int]], int, int]:
        """Deal this step's token budget: one decode token per decoding
        slot first, then prefill chunks in admission (rid) order.
        Returns ``([(slot_idx, q_len), ...], n_decode, n_prefill)``."""
        budget = self.token_budget
        plan: List[Tuple[int, int]] = []
        n_dec = n_pre = 0
        for i, slot in enumerate(self._slots):
            if slot is None or slot.prefilling:
                continue
            plan.append((i, 1))
            budget -= 1
            n_dec += 1
        # rid order, not slot order: slot indices recycle, and index order
        # would let fresh short prompts in low slots starve an older long
        # prefill parked in a high one
        prefilling = sorted(
            (i for i, s in enumerate(self._slots)
             if s is not None and s.prefilling),
            key=lambda i: self._slots[i].req.rid)
        for i in prefilling:
            if budget <= 0:
                break
            slot = self._slots[i]
            take = min(self.chunk_size, len(slot.req.prompt) - slot.fill,
                       budget)
            plan.append((i, take))
            budget -= take
            n_pre += take
        return plan, n_dec, n_pre

    def _dispatch(self, plan, n_dec: int, n_pre: int) -> _Dispatched:
        """Build one mixed step from the plan, advance the slots (lengths
        and fills move now; tokens commit in :meth:`_reconcile`) and run
        the step on the device."""
        s, page = self.max_batch, self.page_size
        width = self._chunk_bucket(max(q for _, q in plan))
        toks = np.zeros((s, width), np.int32)
        positions = np.zeros((s, width), np.int32)
        q_lens = np.zeros((s,), np.int32)
        lengths = np.zeros((s,), np.int32)
        temps = np.zeros((s,), np.float32)
        top_ks = np.zeros((s,), np.int32)
        top_ps = np.ones((s,), np.float32)
        seeds = np.zeros((s,), np.int64)
        lanes: List[_Lane] = []
        for i, take in plan:
            slot = self._slots[i]
            start = slot.length        # first new cache row
            end = start + take
            # grow the slot's page run to cover the new rows (admission
            # reserved them)
            while len(slot.pages) * page < end:
                (new_page,) = self._alloc(1)
                self._table[i, len(slot.pages)] = new_page
                slot.pages.append(new_page)
            lane = _Lane(i, slot, take, prefilling=slot.prefilling)
            if slot.prefilling:
                toks[i, :take] = slot.req.prompt[slot.fill:slot.fill + take]
                slot.fill += take
                lane.completes = not slot.prefilling
            else:
                toks[i, 0] = slot.pending
            slot.length = end
            positions[i, :take] = np.arange(start, end)
            q_lens[i] = take
            lengths[i] = end
            req = slot.req
            temps[i], top_ks[i], top_ps[i], seeds[i] = (
                req.temperature, req.top_k, req.top_p, req.seed)
            lanes.append(lane)
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (toks, positions, q_lens, lengths, self._table)]
        sampling = (tuple(torch.from_numpy(a).to(dev)
                          for a in (temps, top_ks, top_ps, seeds))
                    if (temps > 0).any() else None)
        warm = width in self._widths_run
        self._widths_run.add(width)
        t_start = time.perf_counter()
        with torch.no_grad():
            _, tokens = _mixed_step(self.model, *args, self.pool.arrays,
                                    sampling, lengths.tolist())
        self.stats.mixed_steps += 1
        return _Dispatched(lanes, tokens, width, warm, t_start, n_dec, n_pre)

    def _emit(self, slot: _Slot, tokens, now: float) -> None:
        """Commit generated tokens to the request, with their commit
        timestamps."""
        for t in tokens:
            slot.out.append(int(t))
            slot.req.stats.token_t.append(now)

    def _reconcile(self, inf: _Dispatched, finished) -> None:
        """Settle a dispatched step: fetch its tokens (the one
        device->host sync), commit them, retire what finished, and book
        the step time."""
        tokens = inf.tokens.cpu().numpy()
        now = time.perf_counter()
        emitted_total = 0
        for lane in inf.lanes:
            slot, i = lane.slot, lane.idx
            rst = slot.req.stats
            if lane.prefilling:
                self.stats.prefill_tokens += lane.take
                self.stats.padded_prefill_tokens += inf.width
                if not lane.completes:
                    continue           # more prompt chunks to go
                # prefill just completed: the sampled row is the first
                # token, and the prompt pages are complete -> publish them
                # to the cache.  Not counted into emitted_total: the
                # decode tok/s pair divides decode commits by decode time
                rst.first_token_t = now
                slot.pending = int(tokens[i])
                self._emit(slot, [slot.pending], now)
                if self.prefix is not None:
                    self.prefix.insert(slot.req.prompt, slot.pages)
            else:
                slot.pending = int(tokens[i])
                self._emit(slot, [slot.pending], now)
                self.stats.decode_tokens += 1
                emitted_total += 1
            rst.decode_tokens = len(slot.out)
            if self._done(slot):
                self._retire(i, finished)
        dt = now - inf.t_start
        if inf.warm:
            # time split by computed rows (one row == one budget token)
            n_dec, n_pre = inf.n_dec, inf.n_pre
            self.stats.prefill_s += dt * n_pre / max(n_dec + n_pre, 1)
            self.stats.decode_s += dt * n_dec / max(n_dec + n_pre, 1)
            self.stats.timed_prefill_tokens += n_pre
            self.stats.timed_decode_tokens += emitted_total
            if n_dec:
                self.stats.decode_step_s.append(dt)
                self.stats.decode_step_width.append(emitted_total)

    # -- retirement ------------------------------------------------------
    def _done(self, slot: _Slot) -> bool:
        return bool(slot.out) and (
            len(slot.out) >= slot.req.max_new_tokens
            or (self.eos_token_id is not None
                and slot.out[-1] == self.eos_token_id))

    def _retire(self, slot_idx: int, finished) -> None:
        slot = self._slots[slot_idx]
        req = slot.req
        out = np.asarray(slot.out, np.int32)
        self._results[req.rid] = out
        finished.append((req.rid, out))
        for p in slot.pages:           # shared pages survive under the
            self.pool.decref(p)        # cache's (or other slots') refs
        self._table[slot_idx] = 0
        self._slots[slot_idx] = None
        rst = req.stats
        rst.finished_t = time.perf_counter()
        rst.decode_tokens = len(out)
        self.request_stats[req.rid] = rst
        self.stats.requests_finished += 1

    def _copy_page(self, src: int, dst: int) -> None:
        """The prefix cache's copy-on-write page copy (in place)."""
        with torch.no_grad():
            _copy_page_all_layers(src, dst, self.pool.arrays)
