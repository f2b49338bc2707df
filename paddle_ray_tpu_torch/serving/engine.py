"""Continuous-batching paged serving engine with chunked-prefill mixed
steps, a cross-request prefix cache, speculative decoding, double-buffered
dispatch and failure containment (the port of
``paddle_ray_tpu/serving/engine.py``, single device).

Two layers:

* **functional steps** -- :func:`paged_mixed_step` runs ragged chunks of
  tokens (a decode token here, a prefill slice there, a verify chunk of
  drafts) through the whole model in one step, with ONE ragged
  paged-attention kernel launch per layer; :func:`paged_decode_step` is
  its ``C == 1`` view.  ``all_logits=True`` projects every chunk row
  through the LM head (the verify surface of speculative decoding).
* :class:`ServingEngine` -- host-side continuous batching with a
  token-budget scheduler: every iteration packs one decode token per live
  decoding slot, chunked prefill slices of admitted requests and (with
  speculation) draft rows into one mixed step.

Scheduler knobs: ``token_budget`` (max tokens per step, decode first,
then prefill, then drafts), ``chunk_size`` (max prefill tokens one slot
takes per step); the step's query width is padded to a power-of-two
bucket (:meth:`~ServingEngine.token_budget_buckets`), the JAX engine's
executable family.  The prefix cache shares full KV pages across requests
with a common prompt prefix and copies a partially matched page on write.

Sampling is per request and runs on the device with JAX's threefry keys
``fold_in(PRNGKey(seed), position)``, so a request's stream depends only
on its seed and its positions.  A step whose rows are all greedy takes the
argmax alone.  ``kv_cache_dtype="int8"`` keeps the pool int8 per (token,
head).

What the engine does besides (each held to the JAX engine):

* **speculative decoding** (``spec_decode="ngram"`` or a
  :class:`~.spec.DraftSource`): a decoding slot packs its pending token
  and up to ``spec_k`` drafts as one chunk; the spec step returns every
  row's argmax and the slot's sampled last-row token, and
  :func:`~.spec.greedy_accept` commits the verified prefix plus a bonus
  token.  Rejected rows roll back: the length watermark retreats and
  emptied pages return.  Sampled requests never draft, and a spec engine
  runs its one step family for every step.
* **double-buffered dispatch** (``async_dispatch=True``): step N+1 is
  scheduled from N's predicted state and launched before N's tokens are
  fetched; a decode lane whose input token is N's still-on-device sample
  gathers it inside the step (``use_prev``).  On CUDA every step's inputs
  go through pinned staging buffers copied with ``non_blocking=True`` (two
  sets, each guarded by the event recorded after its step's result
  copies), and the token result comes back by a ``non_blocking`` copy into
  pinned memory: :meth:`ServingEngine._fetch`, which waits on that event,
  is the loop's one device-to-host sync.  Commits reconcile one step late;
  a slot that finished while its next lane was in flight retires as a
  zombie when that lane rolls back.
* **the request lifecycle**: ``submit(priority=, deadline_s=, stream=,
  on_token=, committed=)``, :meth:`ServingEngine.cancel`, a terminal
  :class:`RequestStatus` on every request, preempt-and-restore under pool
  pressure (the victim's committed prefix parks in the prefix cache),
  :meth:`ServingEngine.park_all` for a move to another engine.
* **failure containment**: a :class:`~.chaos.FaultPlan` (``chaos=``)
  injects allocator, dispatch and fetch faults, fetch delays and pool
  spikes; a contained failure discards the in-flight step(s) whole, rolls
  every lane back and retries under a per-request ledger
  (``retry_budget``), and ``max_step_failures`` consecutive failures
  drain the engine with every live request ``FAILED``.  As in the JAX
  engine, the dispatch and the fetch contain every exception but a
  :class:`~.pagesan.PageSanError` (a device OOM, a kernel's launch error),
  a placement only the injected :class:`~.chaos.ChaosError` and the
  pool's ``MemoryError``; a CUDA error that leaves the context unusable
  fails every retry and ends in the drain.  ``run(max_stall_s=)`` raises
  :class:`~.chaos.EngineStallError` on a loop that stops making
  progress.
* **pagesan** (``sanitize=True``): :class:`~.pagesan.PageSanitizer` shadow
  books of every page the scheduler touches, settled per step.

Where the JAX step donated the pool buffers, these steps update the pool
tensors in place on one stream; a discarded lane has already written its
rows, which then sit past the slot's length where attention never reads
them, and stream order makes the reuse of a freed page safe.  Not ported
yet: the engine's telemetry (spans, metrics, flight recorder, step
budgets, goodput, profiling), ``sanitize_threads`` and TP sharding.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.generation import (_block_decode, _block_prefill, _embed_at,
                                 _embed_chunk, _head_logits, _kv_quant,
                                 _qkv_chunk, fold_sample_keys, sample_tokens)
from ..ops.paged_attention import DEFAULT_PAGE_SIZE, paged_ragged_attention
from .chaos import ChaosError, EngineStallError, FaultPlan
from .page_pool import PagePool
from .pagesan import PageSanError, PageSanitizer
from .prefix_cache import PrefixCache, PrefixMatch
from .spec import DraftSource, NGramDrafter, greedy_accept

__all__ = ["RequestStatus", "ServingEngine", "ServingStats", "RequestStats",
           "paged_decode_step", "paged_mixed_step", "paged_prefill"]

_MIN_CHUNK_BUCKET = 8
# the failures a placement contains (the JAX engine's): the chaos plan's
# injected faults and the pool's exhaustion.  The dispatch and the fetch
# contain every Exception but a PageSanError, as the JAX engine does: a
# device OOM (torch.OutOfMemoryError) or a kernel's launch error becomes a
# discarded step whose rows retry.  A CUDA error that leaves the context
# unusable fails again on every retry, so it ends in the FAILED drain after
# max_step_failures consecutive discards, never in a hang.
_CONTAINED = (ChaosError, MemoryError)


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
                     pools: Tuple, host_lengths=None, *,
                     all_logits: bool = False
                     ) -> Tuple[Tuple, torch.Tensor]:
    """One mixed serving step through the whole model, one ragged
    paged-attention launch per layer.

    toks ``[S, C]`` right-padded token chunks per slot; positions
    ``[S, C]`` each token's absolute position (pad rows: anything in
    range); q_lens ``[S]`` int32 valid tokens per slot (0 = dead slot);
    lengths ``[S]`` int32 tokens in cache after this chunk's append;
    page_table ``[S, P]`` int32; pools ``(k, v)`` ``[L, N, page, h, d]``,
    updated in place; host_lengths: optional host copy of ``lengths``
    (sizes the kernel's split-K).  Returns ``(pools, logits [S, V])`` at
    each slot's last valid row -- the LM head projects only those rows --
    or, with ``all_logits`` (the speculative verify surface), ``(pools,
    logits [S, C, V])`` over every chunk row: row ``j`` of a draft chunk
    is the model's next-token distribution after rows ``<= j``."""
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
    if all_logits:
        return pools, _head_logits(model, x)
    last = (q_lens.long() - 1).clamp(0, c - 1)
    x_last = x[torch.arange(s, device=x.device), last]
    return pools, _head_logits(model, x_last[:, None])[:, 0]


def _gather_prev(toks, prev_toks, use_prev):
    """The double-buffered dispatch hook: where ``use_prev`` is set, a
    slot's column-0 input is the previous step's still-on-device sampled
    token instead of the host-built one.  None when no lane uses it."""
    if use_prev is None:
        return toks
    col0 = torch.where(use_prev, prev_toks, toks[:, 0])
    return torch.cat([col0[:, None], toks[:, 1:]], dim=1)


def _sample_last(logits, lengths, sampling):
    """Each slot's token from its last-row ``logits [S, V]``: the argmax
    alone when ``sampling`` is None (every row greedy), else
    :func:`sample_tokens` with keys ``fold_in(PRNGKey(seed), lengths)``."""
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    temps, top_ks, top_ps, seeds = sampling
    keys = fold_sample_keys(seeds, lengths)
    return sample_tokens(logits, keys, temps, top_ks, top_ps)


def _mixed_step(model, toks, positions, q_lens, lengths, table, pools,
                prev_toks=None, use_prev=None,
                sampling: Optional[Tuple] = None, host_lengths=None
                ) -> Tuple[Tuple, torch.Tensor]:
    """The engine's serving step: the mixed forward, then the tokens on
    the device.  ``sampling`` is ``(temps, top_ks, top_ps, seeds)``, all
    ``[S]``; None when every row is greedy (the argmax alone, the same
    tokens).  Returns ``(pools, tokens [S] int32)``."""
    toks = _gather_prev(toks, prev_toks, use_prev)
    pools, logits = paged_mixed_step(model, toks, positions, q_lens,
                                     lengths, table, pools, host_lengths)
    return pools, _sample_last(logits, lengths, sampling)


def _mixed_step_spec(model, toks, positions, q_lens, lengths, table, pools,
                     prev_toks=None, use_prev=None,
                     sampling: Optional[Tuple] = None, host_lengths=None
                     ) -> Tuple[Tuple, torch.Tensor, torch.Tensor]:
    """The spec-mode step: :func:`_mixed_step`'s forward with the LM head
    over every chunk row; returns ``(pools, row argmax [S, C] int32,
    sampled [S] int32)`` -- the verify rows for decode slots, and each
    slot's last-valid-row token (sampled where its request samples; such
    requests never draft).  A spec engine runs this one family for every
    step (the JAX engine's one-family rule)."""
    toks = _gather_prev(toks, prev_toks, use_prev)
    pools, logits = paged_mixed_step(model, toks, positions, q_lens,
                                     lengths, table, pools, host_lengths,
                                     all_logits=True)
    row_argmax = torch.argmax(logits, dim=-1).to(torch.int32)
    s, c = toks.shape
    last = (q_lens.long() - 1).clamp(0, c - 1)
    rows = torch.arange(s, device=logits.device)
    if sampling is None:
        return pools, row_argmax, row_argmax[rows, last]
    return pools, row_argmax, _sample_last(logits[rows, last], lengths,
                                           sampling)


def _copy_page_all_layers(src: int, dst: int, pools: Tuple) -> Tuple:
    """Whole-page copy (all layers, both operands), in place."""
    for a in pools:
        a[:, dst].copy_(a[:, src])
    return pools


class _StepBuffers:
    """One set of a step's host staging.  The int32 operands (tokens,
    positions, q_lens, lengths, use_prev, top_k, seeds, the page table)
    share one buffer and the float32 ones (temperature, top_p) another, so
    a step's inputs are two host-to-device copies; the token results come
    back into ``out``.  On CUDA the buffers are pinned, every copy is
    ``non_blocking`` on the current stream, and ``event`` -- recorded after
    the result copies -- guards the whole set: the host rewrites it only
    once that event completed.  On the CPU the device copies are
    clones."""

    def __init__(self, s: int, width: int, blocks: int,
                 device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.s, self.blocks = s, blocks
        _, n = self._layout(width)
        self.i32 = torch.zeros(n, dtype=torch.int32, pin_memory=self.cuda)
        self.f32 = torch.zeros(2 * s, dtype=torch.float32,
                               pin_memory=self.cuda)
        self.out = torch.zeros(s * width + s, dtype=torch.int32,
                               pin_memory=self.cuda)
        self._i32, self._f32 = self.i32.numpy(), self.f32.numpy()
        self.event = torch.cuda.Event() if self.cuda else None
        self.recorded = False

    def _layout(self, width: int):
        s = self.s
        shapes = (("toks", (s, width)), ("positions", (s, width)),
                  ("q_lens", (s,)), ("lengths", (s,)),
                  ("use_prev", (s,)), ("top_ks", (s,)), ("seeds", (s,)),
                  ("table", (s, self.blocks)))
        out, o = [], 0
        for name, shape in shapes:
            n = int(np.prod(shape))
            out.append((name, o, n, shape))
            o += n
        return out, o

    def host(self, width: int) -> Dict[str, np.ndarray]:
        """Zeroed numpy views of the set for a step of ``width``; waits
        (on CUDA) until the set's previous step released it."""
        if self.recorded:
            self.event.synchronize()    # done already in steady state
            self.recorded = False
        layout, n = self._layout(width)
        self._i32[:n] = 0
        self._f32[:self.s] = 0.0
        self._f32[self.s:] = 1.0
        views = {name: self._i32[o:o + k].reshape(shape)
                 for name, o, k, shape in layout}
        views["temps"] = self._f32[:self.s]
        views["top_ps"] = self._f32[self.s:]
        self._n, self._width = n, width
        return views

    def upload(self) -> Dict[str, torch.Tensor]:
        """The device copies of the views :meth:`host` handed out."""
        if self.cuda:
            i32 = self.i32[:self._n].to(self.device, non_blocking=True)
            f32 = self.f32.to(self.device, non_blocking=True)
        else:
            i32, f32 = self.i32[:self._n].clone(), self.f32.clone()
        layout, _ = self._layout(self._width)
        dev = {name: i32[o:o + k].view(shape)
               for name, o, k, shape in layout}
        dev["temps"], dev["top_ps"] = f32[:self.s], f32[self.s:]
        return dev

    def download(self, tokens: torch.Tensor,
                 sampled: torch.Tensor) -> Optional[Tuple]:
        """Start the copies of a step's results into the pinned ``out``
        and record the set's event (CUDA); returns the host views, or None
        on the CPU (the results are host tensors already)."""
        if not self.cuda:
            return None
        n = tokens.numel()
        host_tok = self.out[:n].view(tokens.shape)
        host_tok.copy_(tokens, non_blocking=True)
        host_smp = host_tok
        if sampled is not tokens:
            host_smp = self.out[n:n + sampled.numel()]
            host_smp.copy_(sampled, non_blocking=True)
        self.event.record()
        self.recorded = True
        return host_tok, host_smp


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
class RequestStatus:
    """Terminal request states (plain strings).  ``OK`` -- drained
    normally (eos or max_new).  ``CANCELLED`` -- :meth:`ServingEngine.
    cancel`.  ``DEADLINE`` -- ``submit(deadline_s=)`` expired first.
    ``PREEMPTED_RETRY_EXHAUSTED`` -- a preempted request spent its retry
    budget.  ``FAILED`` -- step failures spent the budget, the engine
    drained on consecutive failures, or the stall watchdog tripped.  Every
    non-``OK`` status still delivers the tokens committed so far."""
    OK = "OK"
    CANCELLED = "CANCELLED"
    DEADLINE = "DEADLINE"
    PREEMPTED_RETRY_EXHAUSTED = "PREEMPTED_RETRY_EXHAUSTED"
    FAILED = "FAILED"


@dataclasses.dataclass
class ServingStats:
    """The JAX engine's stats schema."""
    prefill_tokens: int = 0            # true prompt tokens prefilled
    padded_prefill_tokens: int = 0     # bucket-padded tokens computed
    decode_tokens: int = 0             # tokens produced by decode lanes
    prefix_hit_tokens: int = 0         # prompt tokens served from cache
    draft_tokens: int = 0              # draft rows packed into verify steps
    accepted_tokens: int = 0           # draft rows the argmax verified
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
    preempted_total: int = 0           # preempt-and-restore evictions
    cancelled_total: int = 0           # cancel() retirements
    deadline_expired_total: int = 0    # submit(deadline_s=) expiries
    step_failures: int = 0             # dispatched steps discarded whole
    retries_total: int = 0             # requeues: preempt + step failure
                                       # + blocked-admission rotations

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
    status: str = RequestStatus.OK     # terminal state at retirement
    retries: int = 0                   # requeues this request survived
    preemptions: int = 0               # preempt-and-restore round trips
    # commit timestamp of every generated token (tokens of one verify
    # step share one)
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
    prompt: np.ndarray                 # the original prompt, immutable
    max_new_tokens: int                # total budget across attempts
    stats: RequestStats
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0                      # effective seed (user's, or rid)
    on_token: Optional[Callable[[int, int], None]] = None
    priority: int = 0                  # higher preempts lower (aged)
    deadline_t: float = 0.0            # absolute perf_counter; 0 = none
    # tokens committed by prior attempts: the current attempt runs with
    # effective prompt ``run_prompt`` = prompt + committed
    committed: List[int] = dataclasses.field(default_factory=list)
    run_prompt: Optional[np.ndarray] = None
    retries: int = 0                   # shared ledger: preempt + step
                                       # failure + blocked admission
    preemptions: int = 0
    next_eligible_t: float = 0.0       # backoff gate for re-admission

    def __post_init__(self):
        if self.run_prompt is None:
            self.run_prompt = self.prompt

    @property
    def remaining_new(self) -> int:
        """Generation budget left for the current attempt."""
        return self.max_new_tokens - len(self.committed)


@dataclasses.dataclass
class _Slot:
    req: _Request
    pages: List[int]                   # owned refs (shared pages incref'd)
    length: int                        # tokens in cache (incl. in-flight)
    fill: int                          # next prompt row to prefill
    pending: int = -1                  # sampled token not yet appended
    out: List[int] = dataclasses.field(default_factory=list)
    # double-buffered bookkeeping: tokens this slot will emit from
    # dispatched-but-unreconciled steps, the step whose on-device sample
    # is this slot's next pending token, and the zombie flag of a slot
    # that finished while a next lane was in flight
    inflight_emits: int = 0
    pending_step: int = -1
    zombie: bool = False
    # lifecycle: the status a zombie retires with, the newest step holding
    # any lane of this slot, and the deferred-preemption flag
    finish_status: str = RequestStatus.OK
    lane_step: int = -1
    preempt_pending: bool = False

    @property
    def prefilling(self) -> bool:
        return self.fill < len(self.req.run_prompt)


@dataclasses.dataclass
class _Lane:
    """One slot's share of one dispatched step, captured at dispatch (the
    commit may settle it after the slot's host state moved on)."""
    idx: int                           # batch slot index
    slot: _Slot
    take: int                          # rows appended by this step
    drafts: Optional[np.ndarray]       # verify chunk's draft tokens
    start: int = 0                     # first appended cache row
    prefilling: bool = False           # was a prefill lane at dispatch
    completes: bool = False            # prefill completes this step
    emits: int = 0                     # worst-case tokens this lane emits
    # what _undo_lane needs to restore the pre-dispatch host state
    pages_added: int = 0               # pages the grow loop took
    prev_pending_step: int = -1
    prev_lane_step: int = -1


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unreconciled step."""
    step_id: int
    plan: List[_Lane]
    tokens: torch.Tensor               # [S] plain, [S, C] spec; on device
    sampled: torch.Tensor              # [S] (tokens itself, plain)
    host: Optional[Tuple]              # pinned result views (CUDA)
    buffers: Optional[_StepBuffers]
    width: int
    warm: bool
    t_start: float
    n_dec: int
    n_pre: int


class ServingEngine:
    """Continuous-batching decode over a paged KV pool.

    ``submit()`` enqueues prompts; ``step()`` admits what fits, runs ONE
    mixed step (decode tokens, prefill chunks and drafts packed under
    ``token_budget``) and commits tokens; ``run()`` drives to drain.

    Knobs: ``page_size``, ``max_batch``, ``num_pages`` (default: every slot
    at ``max_seq_len``, plus the null page), ``max_seq_len``,
    ``kv_cache_dtype`` (``"model"``, or ``"int8"`` per (token, head)),
    ``eos_token_id``, ``chunk_size`` (max prefill tokens one slot takes
    per step; default ``2 * page_size``), ``token_budget`` (max tokens per
    step; default ``max_batch + chunk_size``), ``prefix_cache`` (default
    on), ``sanitize`` (pagesan), ``async_dispatch`` (double-buffered
    steps; a spec engine keeps the synchronous cadence, its drafter needs
    each step's commits), ``spec_decode`` / ``spec_k`` / ``spec_ngram``
    (speculative decoding), ``chaos`` (a :class:`~.chaos.FaultPlan`),
    ``retry_budget`` / ``retry_backoff_s`` / ``max_step_failures`` /
    ``max_stall_s`` (failure containment) and ``device`` (default CUDA;
    the model must live there).  See the module docstring.
    """

    def __init__(self, model, *, page_size: int = DEFAULT_PAGE_SIZE,
                 max_batch: int = 8, num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 kv_cache_dtype: str = "model",
                 eos_token_id: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = True,
                 sanitize: bool = False,
                 async_dispatch: bool = False,
                 spec_decode=None,
                 spec_k: int = 4,
                 spec_ngram: int = 3,
                 chaos: Optional[FaultPlan] = None,
                 retry_budget: int = 3,
                 retry_backoff_s: float = 0.0,
                 max_step_failures: int = 8,
                 max_stall_s: Optional[float] = None,
                 device=None):
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
        if spec_decode is None:
            self.spec: Optional[DraftSource] = None
        elif isinstance(spec_decode, str):
            if spec_decode != "ngram":
                raise ValueError(
                    f"unknown spec_decode {spec_decode!r}; pass 'ngram' "
                    "or a DraftSource instance")
            self.spec = NGramDrafter(max_ngram=spec_ngram)
        else:
            self.spec = spec_decode
        if self.spec is not None:
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1 with spec_decode on")
            if spec_k + 1 > self.chunk_size:
                # the verify chunk must fit the declared width buckets
                raise ValueError(
                    f"spec_k {spec_k} + 1 exceeds chunk_size "
                    f"{self.chunk_size}: the verify chunk would leave "
                    "the bounded executable family")
        self.spec_k = spec_k
        self.blocks_per_seq = -(-self.max_seq_len // page_size)
        if num_pages is None:
            num_pages = 1 + max_batch * self.blocks_per_seq
        self.pool = PagePool(cfg.num_layers, num_pages, page_size,
                             cfg.num_heads, cfg.head_dim, dtype=model.dtype,
                             quantized=kv_cache_dtype == "int8",
                             device=self.device)
        # the sanitizer wraps the pool before the cache holds it, so the
        # cache's own refcount traffic updates the shadow books too
        self.sanitizer = PageSanitizer(self.pool) if sanitize else None
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.async_dispatch = bool(async_dispatch)
        # a host-side drafter needs each step's commits before it can
        # propose the next chunk: a spec engine settles every step
        self._pipelined = self.async_dispatch and self.spec is None
        self._inflight: Optional[_Inflight] = None
        self._step_id = 0
        self._last_reconcile_t = 0.0
        self._streams: Dict[int, "queue.Queue"] = {}
        # stream() queues are drained by consumer threads: registration,
        # lookup and close take this lock
        self._streams_lock = threading.Lock()
        self._table = np.zeros((max_batch, self.blocks_per_seq), np.int32)
        self._slots: List[Optional[_Slot]] = [None] * max_batch
        self._queue: List[_Request] = []
        self._results: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        # width buckets run (("mixed", w)) and the page copy (("pagecopy",)):
        # the JAX engine's executable keys
        self._compiled: set = set()
        self._steady = False
        self.recompiles = 0
        # two staging sets, alternated step by step
        width_max = max(self.token_budget_buckets())
        self._buffers = [_StepBuffers(max_batch, width_max,
                                      self.blocks_per_seq, self.device)
                         for _ in range(2)]
        self.stats = ServingStats()
        self.request_stats: Dict[int, RequestStats] = {}
        self.admission_blocked: Optional[str] = None
        # (head rid, cache generation, free pages, active) of the last
        # failed admission: while none of these change, retrying cannot
        # succeed, so _admit skips the re-match
        self._blocked_state: Optional[tuple] = None
        if retry_budget < 0 or max_step_failures < 1:
            raise ValueError("retry_budget must be >= 0 and "
                             "max_step_failures >= 1")
        self.chaos = chaos
        self.retry_budget = retry_budget
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_step_failures = max_step_failures
        self.max_stall_s = max_stall_s
        self.failed_drain: Optional[str] = None
        self.chaos_fired = 0           # injected events that fired
        self._iter = 0                 # engine iterations (chaos index)
        self._consec_failures = 0
        self._phase = "idle"           # dispatch | fetch | commit
        self._stepping = False         # inside step(): defer cancels
        self._pending_cancels: List[Tuple[int, str]] = []
        self._spikes: List[Tuple[int, List[int]]] = []  # (release, pages)
        self._in_spike_alloc = False
        self._failed_rids: List[int] = []   # lanes hit by the last abort
        self._deadline_live = 0        # requests with a deadline set
        self._ledger_live = False      # any backoff/requeue ever issued
        if chaos is not None:
            # admission placement, dispatch grow and CoW allocations all
            # pass through pool.alloc
            self.pool.fault_injector = self._pool_fault

    # -- public surface --------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               stream: bool = False, priority: int = 0,
               deadline_s: Optional[float] = None,
               committed: Optional[List[int]] = None) -> int:
        """Enqueue a request; returns its rid.

        ``temperature <= 0`` (the default) is greedy; ``temperature > 0``
        samples, with optional ``top_k`` / ``top_p`` cuts, from
        ``fold_in(PRNGKey(seed), position)`` keys (``seed`` default: the
        rid, folded to uint32 like any seed).  Sampled requests never
        draft.  ``on_token(rid, token)`` fires at every commit;
        ``stream=True`` feeds the queue :meth:`stream` returns (``None``
        terminated).  ``priority`` orders admission (higher first, FIFO
        within a tier) and arms preempt-and-restore; ``deadline_s``
        (seconds from submit) expires the request wherever it is.
        ``committed``: tokens a prior attempt on another engine already
        delivered -- the request runs with effective prompt ``prompt +
        committed`` and a ``max_new_tokens`` total budget, and its output
        is committed + the new tokens (:meth:`park_all`'s tickets)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) == 0 or max_new_tokens <= 0:
            raise ValueError("need a non-empty prompt and max_new_tokens>0")
        prior = [int(t) for t in committed] if committed is not None else []
        if prior and len(prior) >= max_new_tokens:
            raise ValueError(
                f"committed carries {len(prior)} tokens but "
                f"max_new_tokens is {max_new_tokens}: nothing left to "
                "generate -- the restore is already complete, deliver "
                "the committed tokens instead of resubmitting")
        if temperature < 0 or top_k < 0 or not 0.0 < top_p <= 1.0:
            raise ValueError(
                f"bad sampling params: temperature={temperature} (>=0), "
                f"top_k={top_k} (>=0), top_p={top_p} (in (0, 1])")
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
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        rstats = RequestStats(rid, prompt_tokens=len(prompt),
                              submitted_t=now)
        req = _Request(
            rid, prompt, max_new_tokens, rstats,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            seed=int(rid if seed is None else seed) & 0xFFFFFFFF,
            on_token=on_token, priority=int(priority),
            deadline_t=(now + deadline_s) if deadline_s else 0.0,
            committed=prior,
            run_prompt=(np.concatenate(
                [prompt, np.asarray(prior, np.int32)]) if prior
                else None))
        if deadline_s:
            self._deadline_live += 1
        self._queue_insert(req)
        if stream:
            with self._streams_lock:
                self._streams[rid] = queue.Queue()
        return rid

    def _eff_priority(self, req: _Request) -> int:
        """Admission/preemption rank: the submitted priority aged up by
        every preemption the request already suffered."""
        return req.priority + req.preemptions

    def _queue_insert(self, req: _Request) -> None:
        """Higher effective priority first, FIFO within a tier."""
        eff = self._eff_priority(req)
        k = len(self._queue)
        while k > 0 and self._eff_priority(self._queue[k - 1]) < eff:
            k -= 1
        self._queue.insert(k, req)

    def stream(self, rid: int) -> "queue.Queue":
        """The token queue of a ``submit(..., stream=True)`` request: every
        committed token in order, then ``None``.  Safe to drain from
        another thread."""
        with self._streams_lock:
            return self._streams[rid]

    def stream_status(self, rid: int) -> Optional[str]:
        """The terminal :class:`RequestStatus` behind a stream's ``None``;
        ``None`` while the request is in flight (or after
        :meth:`park_all` moved it); ``KeyError`` for a rid this engine
        never issued."""
        if not 0 <= int(rid) < self._next_rid:
            raise KeyError(f"unknown rid {rid}")
        rs = self.request_stats.get(rid)
        return None if rs is None else rs.status

    def _close_streams(self) -> None:
        """Unblock the stream consumers of every unfinished request."""
        with self._streams_lock:
            pending = [q for rid, q in self._streams.items()
                       if rid not in self._results]
        for q in pending:
            q.put(None)

    # -- request lifecycle -----------------------------------------------
    def cancel(self, rid: int,
               status: str = RequestStatus.CANCELLED) -> bool:
        """Cancel a request wherever it is.  Queued: removed at once.
        Mid-flight: its in-flight lane is discarded at the next reconcile
        (zombie rollback), committed tokens are kept, and the stream ends
        with ``None``.  Returns True iff the request was live.  Safe from
        an ``on_token`` callback (applied at the next step boundary)."""
        if status not in (RequestStatus.CANCELLED, RequestStatus.DEADLINE):
            raise ValueError(f"cancel() status must be CANCELLED or "
                             f"DEADLINE, got {status!r}")
        if self._stepping:
            if any(r.rid == rid for r in self._queue) or any(
                    s is not None and s.req.rid == rid and not s.zombie
                    for s in self._slots):
                self._pending_cancels.append((rid, status))
                return True
            return False
        return self._cancel_now(rid, status, [])

    def _cancel_now(self, rid: int, status: str, finished: List) -> bool:
        for k, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(k)
                self._finish_queued(req, status, finished)
                return True
        for i, slot in enumerate(self._slots):
            if (slot is not None and slot.req.rid == rid
                    and not slot.zombie):
                self._cancel_slot(i, slot, status, finished)
                return True
        return False

    def _cancel_slot(self, i: int, slot: _Slot, status: str,
                     finished: List) -> None:
        """Terminate a placed slot: at once when nothing is in flight,
        else as a zombie whose lane rolls back when it settles."""
        slot.finish_status = status
        if self._lane_in_flight(slot):
            slot.zombie = True
        else:
            self._retire(i, finished, status=status)

    def _finish_queued(self, req: _Request, status: str,
                       finished: List) -> None:
        """Terminal state for a request not in a slot; prior attempts'
        committed tokens are its output."""
        rst = req.stats
        rst.status = status
        rst.finished_t = time.perf_counter()
        out = np.asarray(req.committed, np.int32)
        self._results[req.rid] = out
        finished.append((req.rid, out))
        self.request_stats[req.rid] = rst
        self.stats.requests_finished += 1
        self._count_status(status)
        if req.deadline_t:
            self._deadline_live -= 1
        q = self._streams.get(req.rid)
        if q is not None:
            q.put(None)

    def _count_status(self, status: str) -> None:
        if status == RequestStatus.CANCELLED:
            self.stats.cancelled_total += 1
        elif status == RequestStatus.DEADLINE:
            self.stats.deadline_expired_total += 1

    def _process_lifecycle(self, finished: List) -> None:
        """Step-boundary housekeeping: deferred cancels, deadline expiry
        (queued and mid-flight), deferred preemptions whose victim's last
        lane settled, and zombies with nothing left in flight."""
        if self._pending_cancels:
            pend, self._pending_cancels = self._pending_cancels, []
            for rid, status in pend:
                self._cancel_now(rid, status, finished)
        if self._deadline_live:
            now = time.perf_counter()
            for k in range(len(self._queue) - 1, -1, -1):
                req = self._queue[k]
                if req.deadline_t and now >= req.deadline_t:
                    self._queue.pop(k)
                    self._finish_queued(req, RequestStatus.DEADLINE,
                                        finished)
            for i, slot in enumerate(self._slots):
                if (slot is not None and not slot.zombie
                        and slot.req.deadline_t
                        and now >= slot.req.deadline_t):
                    self._cancel_slot(i, slot, RequestStatus.DEADLINE,
                                      finished)
        for i, slot in enumerate(self._slots):
            if slot is None or self._lane_in_flight(slot):
                continue
            if slot.zombie:
                self._retire(i, finished, status=slot.finish_status)
            elif slot.preempt_pending:
                if slot.prefilling or not slot.out:
                    # a rollback reverted the victim into prefill: it has
                    # no committed prefix to park; un-mark it
                    slot.preempt_pending = False
                else:
                    self._do_preempt(i)

    def _lane_in_flight(self, slot: _Slot) -> bool:
        return (self._inflight is not None
                and slot.lane_step == self._inflight.step_id)

    # -- fault hooks and step-failure containment ------------------------
    def _pool_fault(self, n: int) -> None:
        """``PagePool.fault_injector`` target (installed only with
        ``chaos``): raises before the free list moves."""
        if self._in_spike_alloc:
            return                      # the spike's own alloc never fails
        ev = self.chaos.take("pool_alloc", self._iter)
        if ev is not None:
            self.chaos_fired += 1
            raise ChaosError(
                f"injected pool-alloc failure at iter {self._iter} "
                f"(want {n} page(s))")

    def _chaos_spikes(self) -> None:
        """Apply and expire pool spikes: an event hides up to ``pages``
        free pages for ``hold_steps`` iterations (allocated through the
        pool, so the books stay exact), then hands them back."""
        if self._spikes:
            due = [s for s in self._spikes if s[0] <= self._iter]
            if due:
                self._spikes = [s for s in self._spikes
                                if s[0] > self._iter]
                for _, pages in due:
                    self.pool.free(pages)
        ev = self.chaos.take("pool_spike", self._iter)
        if ev is not None:
            n = min(ev.pages, self.pool.num_free)
            if n > 0:
                self._in_spike_alloc = True
                try:
                    pages = self.pool.alloc(n)
                finally:
                    self._in_spike_alloc = False
                self._spikes.append(
                    (self._iter + max(ev.hold_steps, 1), pages))
            self.chaos_fired += 1

    def _release_spikes(self) -> None:
        """Hand every outstanding spike page back (drain, failure, stall,
        park)."""
        for _, pages in self._spikes:
            self.pool.free(pages)
        self._spikes = []

    def _undo_lane(self, lane: _Lane) -> None:
        """Restore one dispatched lane's pre-dispatch host state: the
        sanitizer's watermarks retreat first, pages the grow loop took
        return, and the slot's predicted state rewinds."""
        slot, i = lane.slot, lane.idx
        end = lane.start + lane.take
        if self.sanitizer is not None:
            self.sanitizer.note_rollback(slot.req.rid, slot.pages,
                                         lane.start, end, self.page_size)
        self._drop_grown_pages(slot, i, lane.pages_added)
        slot.length = lane.start
        if lane.prefilling:
            slot.fill -= lane.take
        slot.inflight_emits -= lane.emits
        slot.pending_step = lane.prev_pending_step
        slot.lane_step = lane.prev_lane_step

    def _drop_grown_pages(self, slot: _Slot, slot_idx: int,
                          n: int) -> None:
        """Return the last ``n`` pages a dispatch's grow loop took (they
        hold no committed row) and re-null their table entries."""
        if n <= 0:
            return
        drop = slot.pages[-n:]
        del slot.pages[-n:]
        self.pool.free(drop)
        self._table[slot_idx, len(slot.pages):len(slot.pages) + n] = 0

    def _abort_unreconciled(self, inf: _Inflight, err, finished,
                            count: bool = True) -> None:
        """Discard ``inf`` and any successor dispatched against its
        predicted state, rolling every lane back to the last reconciled
        state; pagesan's ledger settles the aborts oldest first."""
        steps = [inf]
        if self._inflight is not None and self._inflight is not inf:
            steps.append(self._inflight)
            self._inflight = None
        for s in reversed(steps):       # newest rows roll back first
            for lane in reversed(s.plan):
                self._undo_lane(lane)
        if self.sanitizer is not None:
            for s in steps:
                self.sanitizer.note_abort(s.step_id)
        if count:
            rids = sorted({lane.slot.req.rid
                           for s in steps for lane in s.plan})
            self._note_step_failure(err, None, finished, rids=rids)

    def _note_step_failure(self, err, protected_inf: Optional[_Inflight],
                           finished, rids: Optional[List[int]] = None
                           ) -> None:
        """Book one discarded step: counters and the shared retry ledger
        of every affected request (past its budget it fails terminally);
        ``max_step_failures`` consecutive discards drain the engine."""
        self.stats.step_failures += 1
        self._consec_failures += 1
        if rids is None:
            rids, self._failed_rids = self._failed_rids, []
        for rid in rids:
            idx = next((i for i, s in enumerate(self._slots)
                        if s is not None and s.req.rid == rid), None)
            if idx is None:
                continue
            slot = self._slots[idx]
            req = slot.req
            req.retries += 1
            req.stats.retries += 1
            self.stats.retries_total += 1
            if req.retries > self.retry_budget and not slot.zombie:
                status = (RequestStatus.PREEMPTED_RETRY_EXHAUSTED
                          if req.preemptions else RequestStatus.FAILED)
                self._fail_slot(idx, slot, status, protected_inf,
                                finished)
        if self._consec_failures >= self.max_step_failures:
            self._drain_failed(err, protected_inf, finished)

    def _fail_slot(self, idx: int, slot: _Slot, status: str,
                   protected_inf: Optional[_Inflight], finished) -> None:
        """Terminal failure for a placed slot: at once when no lane is
        outstanding, else through the zombie path."""
        if (protected_inf is not None
                and slot.lane_step == protected_inf.step_id):
            slot.zombie = True
            slot.finish_status = status
        else:
            self._retire(idx, finished, status=status)

    def _drain_failed(self, err, protected_inf: Optional[_Inflight],
                      finished) -> None:
        """``max_step_failures`` consecutive discarded steps: every live
        request fails (keeping its committed tokens) and spike pages
        return; ``run()`` then drains instead of looping."""
        if self.failed_drain is not None:
            return
        self.failed_drain = repr(err)
        for i, slot in enumerate(self._slots):
            if slot is not None and not slot.zombie:
                self._fail_slot(i, slot, RequestStatus.FAILED,
                                protected_inf, finished)
        while self._queue:
            self._finish_queued(self._queue.pop(0), RequestStatus.FAILED,
                                finished)
        self._release_spikes()

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def executable_count(self) -> int:
        """Width buckets run plus the page copy once used: the JAX
        engine's executable count for the same traffic."""
        return len(self._compiled)

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

    @property
    def executable_budget(self) -> int:
        """Upper bound on :attr:`executable_count`: one step family member
        per bucket, plus the page copy."""
        return len(self.token_budget_buckets()) + 1

    def mark_steady(self, steady: bool = True) -> None:
        """Declare the width family complete: from here on a width first
        run counts in :attr:`recompiles`.  ``run()`` sets this after the
        first clean drain."""
        self._steady = bool(steady)

    @property
    def steady(self) -> bool:
        return self._steady

    def _note_key(self, key: tuple) -> bool:
        """Record a run of ``key``; True iff it ran before (warm)."""
        warm = key in self._compiled
        if not warm:
            self._compiled.add(key)
            if self._steady and key[0] == "mixed":
                self.recompiles += 1
        return warm

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

    def step(self) -> List[Tuple[int, np.ndarray]]:
        """Admit what fits, dispatch one mixed step, and reconcile.  Sync
        mode settles the dispatched step at once; async mode reconciles
        the previous step only after this call's dispatch is on the
        device.  Returns the requests that finished."""
        finished: List[Tuple[int, np.ndarray]] = []
        self._stepping = True
        try:
            self._iter += 1
            if self.chaos is not None:
                self._chaos_spikes()
            self._process_lifecycle(finished)
            self._admit()
            plan, n_dec, n_pre = (self._schedule() if self.active
                                  else ([], 0, 0))
            prev = self._inflight
            # dispatch before reconciling prev: its use_prev lanes read
            # prev's still-on-device tokens
            try:
                self._phase = "dispatch"
                self._inflight = (self._dispatch(plan, n_dec, n_pre)
                                  if plan else None)
            except PageSanError:
                raise
            except Exception as err:  # noqa: BLE001 -- containment zone
                # _dispatch restored the pre-dispatch host state; keep
                # prev (independent of the failed successor)
                self._inflight = None
                self._note_step_failure(err, prev, finished)
            if prev is not None:
                self._reconcile_guarded(prev, finished)
            if self._inflight is not None and not self._pipelined:
                nxt, self._inflight = self._inflight, None
                self._reconcile_guarded(nxt, finished)
        finally:
            self._stepping = False
            self._phase = "idle"
        if self.sanitizer is not None:
            self.sanitizer.verify_pool()
        return finished

    def _reconcile_guarded(self, inf: _Inflight, finished) -> None:
        """Reconcile with fetch-failure containment: only a contained
        failure of the fetch phase discards the step (its rows retry and
        regenerate the same tokens); a commit-phase exception propagates."""
        try:
            self._reconcile(inf, finished)
        except PageSanError:
            raise
        except Exception as err:  # noqa: BLE001 -- containment zone
            if self._phase != "fetch":
                raise
            self._abort_unreconciled(inf, err, finished)

    def run(self, max_steps: int = 100_000,
            max_stall_s: Optional[float] = None) -> Dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted request finished.
        Returns ``{rid: generated tokens}`` (prompt not included).  If the
        drive fails, every unfinished request's stream still gets its
        ``None`` before the error propagates.  ``max_stall_s`` (or the
        engine's) arms the watchdog: no progress for that long fails every
        live request and raises :class:`~.chaos.EngineStallError`."""
        stall = max_stall_s if max_stall_s is not None else self.max_stall_s
        marker = None
        last_t = time.perf_counter()
        try:
            for _ in range(max_steps):
                if (not self._queue and not self.active
                        and self._inflight is None):
                    break
                self.step()
                if stall is not None:
                    m = self._progress_marker()
                    now = time.perf_counter()
                    if m != marker:
                        marker, last_t = m, now
                    elif now - last_t > stall:
                        if any(r.next_eligible_t > now
                               for r in self._queue):
                            continue    # a retry backoff, not a stall
                        self._stall_abort(now - last_t)
        except BaseException:
            self._close_streams()
            raise
        if self._queue or self.active:
            self._close_streams()
            raise RuntimeError("serving did not drain; raise max_steps")
        self._release_spikes()
        if self.sanitizer is not None:
            # drained: only the prefix cache may still hold pages
            self.sanitizer.check_drain(
                self.prefix.pages() if self.prefix is not None else ())
            self.sanitizer.verify_pool()
        self._steady = True
        return dict(self._results)

    def _progress_marker(self) -> tuple:
        st = self.stats
        return (st.decode_tokens, st.prefill_tokens, st.prefix_hit_tokens,
                st.requests_finished, st.preempted_total,
                st.cancelled_total, st.deadline_expired_total,
                st.retries_total, st.step_failures,
                self.pending, self.active)

    def _stall_abort(self, stalled_s: float) -> None:
        """The watchdog tripped: fail every live request and raise."""
        scratch: List = []
        if self._inflight is not None:
            self._abort_unreconciled(self._inflight, None, scratch,
                                     count=False)
            self._inflight = None
        for i, slot in enumerate(self._slots):
            if slot is not None:
                # a zombie keeps its decided terminal state
                self._retire(i, scratch,
                             status=(slot.finish_status if slot.zombie
                                     else RequestStatus.FAILED))
        while self._queue:
            self._finish_queued(self._queue.pop(0), RequestStatus.FAILED,
                                scratch)
        self._release_spikes()
        raise EngineStallError(
            f"engine made no progress for {stalled_s:.3f}s "
            f"(max_stall_s watchdog): {self.stats.requests_finished} "
            "finished, live requests failed")

    def clear_prefix_cache(self) -> int:
        """Drop every cache-held page; pages shared with live requests
        survive under their own refs."""
        return self.prefix.clear() if self.prefix is not None else 0

    def prune_finished(self, keep_last: int = 0) -> int:
        """Drop retained outputs and stats of all but the ``keep_last``
        most recent finished requests (retention is otherwise unbounded).
        Returns how many records were dropped."""
        rids = sorted(self._results)
        drop = rids[:max(len(rids) - keep_last, 0)]
        for rid in drop:
            self._results.pop(rid, None)
            self.request_stats.pop(rid, None)
            with self._streams_lock:
                self._streams.pop(rid, None)
        return len(drop)

    def park_all(self) -> Tuple[List[Dict], List[Tuple[int, np.ndarray]]]:
        """Stop this engine and hand every live request back as a restore
        ticket for ``submit(..., committed=...)`` on another engine.

        Any unreconciled step is discarded whole; each placed decoding
        request's committed prompt+generation prefix parks in the prefix
        cache (the preemption path); every slot's pages return.  Returns
        ``(tickets, finished)``: ``finished`` holds zombies (their end was
        decided one step back), which retire here.  Ticketed requests'
        streams get ``None`` and :meth:`stream_status` stays ``None``."""
        if self._stepping:
            raise RuntimeError("park_all() may not be called from "
                               "inside step() (defer to the step "
                               "boundary)")
        finished: List[Tuple[int, np.ndarray]] = []
        if self._inflight is not None:
            self._abort_unreconciled(self._inflight, None, finished,
                                     count=False)
            self._inflight = None
        tickets: List[Dict] = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.zombie:
                self._retire(i, finished, status=slot.finish_status)
                continue
            req = slot.req
            if self.prefix is not None and slot.out and not slot.prefilling:
                # rows in cache: run_prompt + out[:-1] (the newest sampled
                # token was never appended)
                cached = np.asarray(
                    list(req.run_prompt) + slot.out[:-1], np.int32)
                self.prefix.insert(cached, slot.pages)
            for p in slot.pages:
                self.pool.decref(p)     # cache-held pages live on
            self._table[i] = 0
            self._slots[i] = None
            if self.sanitizer is not None:
                self.sanitizer.note_release(req.rid)
            if self.spec is not None:
                self.spec.release(req.rid)
            tickets.append(self._park_ticket(
                req, list(req.committed) + [int(t) for t in slot.out]))
        while self._queue:
            req = self._queue.pop(0)
            tickets.append(self._park_ticket(req, list(req.committed)))
        self._release_spikes()
        self._blocked_state = None
        return tickets, finished

    def _park_ticket(self, req: _Request, committed: List[int]) -> Dict:
        """One restore ticket: the original prompt and total budget, the
        tokens committed so far, the sampling and lifecycle fields."""
        if req.deadline_t:
            self._deadline_live -= 1
        q = self._streams.get(req.rid)
        if q is not None:
            q.put(None)                 # this engine's stream ends here
        return {"rid": req.rid, "prompt": req.prompt,
                "max_new_tokens": req.max_new_tokens,
                "committed": committed,
                "temperature": req.temperature, "top_k": req.top_k,
                "top_p": req.top_p, "seed": req.seed,
                "priority": req.priority, "deadline_t": req.deadline_t,
                "preemptions": req.preemptions}

    # -- admission -------------------------------------------------------
    def _chunk_bucket(self, c: int) -> int:
        """Smallest declared bucket >= c."""
        return min(b for b in self.token_budget_buckets() if b >= c)

    def _worst_case_pages(self, slot: _Slot) -> int:
        """Pages this slot may still need: its constant worst-case
        footprint (``t0 + max_new - 1`` cached rows) minus what it owns.
        It must not shrink with decode progress, or admission would
        double-book the pool (a restored request's ``run_prompt +
        remaining_new`` equals the original ``prompt + max_new``)."""
        total = -(-(len(slot.req.run_prompt) + slot.req.remaining_new - 1)
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
        now = time.perf_counter()
        # the blocked-state memo holds only while blockage can clear by a
        # state change alone: backoff clears by the clock and chaos faults
        # are transient, so either disables it
        if (not self._ledger_live and self.chaos is None
                and self._admission_state() == self._blocked_state):
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
            # first backoff-eligible request (priority-then-FIFO order)
            k = next((j for j, r in enumerate(self._queue)
                      if r.next_eligible_t <= now), None)
            if k is None:
                return                  # everyone is waiting out a backoff
            req = self._queue[k]
            # safe admission: this request's worst case plus every running
            # sequence's remaining growth must fit the pool (free pages +
            # what the cache can give back).  _gate locks the match first
            # so its pages stop counting as reclaimable.
            m: Optional[PrefixMatch] = None
            if self.prefix is not None:
                cand = self.prefix.match(req.run_prompt)
                if self._gate(req, cand):
                    m = cand
            if m is None:
                # no cache, or the locked match pinned pages a tight pool
                # needs: degrade to a cold admission
                cold = PrefixMatch(shared=[])
                if not self._gate(req, cold):
                    self.stats.blocked_pool_pressure += 1
                    if self._try_preempt(req):
                        continue        # capacity moved; retry the gate
                    if (len(self._queue) > 1
                            and req.retries < self.retry_budget):
                        # rotate behind its tier so smaller requests can
                        # try this step
                        self._requeue_blocked(k, req, now)
                        continue
                    self._blocked_state = self._admission_state()
                    return
                m = cold
            self._queue.pop(k)
            try:
                self._place(free_slots[0], req, m)
            except _CONTAINED as err:
                # an allocator failure mid-placement: _place raises before
                # any slot or table change, so unlocking and requeueing
                # undoes it.  Not memoized: the fault clears by itself
                if self.prefix is not None:
                    self.prefix.unlock(m)
                self._queue.insert(k, req)
                self.stats.blocked_pool_pressure += 1
                self.admission_blocked = f"placement failed: {err!r}"
                return

    def _requeue_blocked(self, k: int, req: _Request, now: float) -> None:
        """Rotate a pool-pressure-blocked request behind its priority tier,
        with retry-ledger bookkeeping and exponential backoff."""
        req.retries += 1
        req.stats.retries += 1
        self.stats.retries_total += 1
        if self.retry_backoff_s:
            req.next_eligible_t = now + self.retry_backoff_s * (
                2 ** min(req.retries - 1, 6))
            self._ledger_live = True
        self._queue.pop(k)
        self._queue_insert(req)

    def _try_preempt(self, req: _Request) -> bool:
        """Preempt the lowest-ranked decoding victim strictly below
        ``req``'s effective priority (victims past their retry budget are
        pinned).  True iff capacity was reclaimed now; a victim with a
        lane in flight is marked and released when the lane settles."""
        eff = self._eff_priority(req)
        best = None
        for i, slot in enumerate(self._slots):
            if (slot is None or slot.prefilling or slot.zombie
                    or slot.preempt_pending):
                continue
            victim = slot.req
            if victim.retries >= self.retry_budget:
                continue                # pinned: must run to completion
            ve = self._eff_priority(victim)
            if ve >= eff:
                continue
            key = (ve, -victim.rid)     # lowest rank, newest first
            if best is None or key < best[0]:
                best = (key, i, slot)
        if best is None:
            return False
        _, i, slot = best
        if self._lane_in_flight(slot):
            slot.preempt_pending = True
            return False
        self._do_preempt(i)
        return True

    def _do_preempt(self, i: int) -> None:
        """Evict a decoding slot restorably: park its committed
        prompt+generation prefix in the prefix cache, return its pages,
        and requeue it with aged priority and backoff.  Re-prefilling
        rows ``[0, t0+m)`` rebuilds the KV the decode steps wrote, and the
        next sample uses the unpreempted step's ``fold_in(seed,
        position)`` key."""
        slot = self._slots[i]
        req = slot.req
        rid = req.rid
        # rows in cache: run_prompt + out[:-1]
        cached = np.asarray(list(req.run_prompt) + slot.out[:-1], np.int32)
        if self.prefix is not None:
            self.prefix.insert(cached, slot.pages)
        for p in slot.pages:
            self.pool.decref(p)         # cache-held pages live on
        self._table[i] = 0
        self._slots[i] = None
        if self.sanitizer is not None:
            self.sanitizer.note_release(rid)
        if self.spec is not None:
            self.spec.release(rid)
        req.committed.extend(slot.out)
        req.run_prompt = np.asarray(list(req.prompt) + req.committed,
                                    np.int32)
        req.retries += 1
        req.preemptions += 1
        req.stats.retries += 1
        req.stats.preemptions += 1
        self.stats.preempted_total += 1
        self.stats.retries_total += 1
        if self.retry_backoff_s:
            req.next_eligible_t = time.perf_counter() + (
                self.retry_backoff_s * 2 ** min(req.preemptions - 1, 6))
            self._ledger_live = True
        self._queue_insert(req)
        self._blocked_state = None      # capacity moved: re-evaluate

    def _gate(self, req: _Request, m: PrefixMatch) -> bool:
        """Take the match and pass the capacity gate; on failure roll the
        lock back, record why, and return False."""
        if self.prefix is not None:
            self.prefix.lock(m)
        need = (-(-(len(req.run_prompt) + req.remaining_new - 1)
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
        mid-page, fresh pages for the rest of the (run) prompt."""
        t0 = len(req.run_prompt)
        n_prompt_pages = -(-t0 // self.page_size)
        fresh = self._alloc(n_prompt_pages - len(m.shared))
        pages = list(m.shared) + fresh
        self._table[slot_idx] = 0
        self._table[slot_idx, :len(pages)] = pages
        if self.sanitizer is not None:
            for p in m.shared:
                self.sanitizer.note_share(req.rid, p)
        if m.copy_src is not None:
            # rows past the hit are overwritten by the suffix prefill or
            # masked by length; lock() pinned the source against eviction
            self._copy_page(m.copy_src, fresh[0])
            if self.sanitizer is not None:
                self.sanitizer.note_copy(req.rid, m.copy_src, fresh[0],
                                         m.copy_rows)
            self.prefix.release_copy_src(m)
        self._slots[slot_idx] = _Slot(req, pages, length=m.hit_tokens,
                                      fill=m.hit_tokens)
        if self.spec is not None:
            self.spec.register(req.rid, req.run_prompt)
        req.stats.admitted_t = time.perf_counter()
        req.stats.prefix_hit_tokens += m.hit_tokens
        self.stats.prefix_hit_tokens += m.hit_tokens
        if self.prefix is not None:
            self.prefix.record(m)

    # -- the mixed step --------------------------------------------------
    def _schedule(self) -> Tuple[List[List], int, int]:
        """Deal this step's token budget: one decode token per decoding
        slot first, then prefill chunks in admission (rid) order, then --
        speculation on -- draft rows from what is left.  Returns
        ``([[slot_idx, q_len, drafts-or-None], ...], n_decode_rows,
        n_prefill_rows)``."""
        budget = self.token_budget
        plan: List[List] = []
        dec_pos: List[int] = []            # plan indices of decode lanes
        n_dec = n_pre = 0
        for i, slot in enumerate(self._slots):
            if (slot is None or slot.prefilling or slot.zombie
                    or slot.preempt_pending):
                continue
            if (len(slot.out) + slot.inflight_emits
                    >= slot.req.remaining_new):
                # the predicted state fills the budget already: the slot
                # retires at reconcile
                continue
            dec_pos.append(len(plan))
            plan.append([i, 1, None])
            budget -= 1
            n_dec += 1
        # rid order, not slot order: slot indices recycle, and index order
        # would let fresh short prompts in low slots starve an older long
        # prefill parked in a high one
        prefilling = sorted(
            (i for i, s in enumerate(self._slots)
             if s is not None and s.prefilling and not s.zombie
             and not s.preempt_pending),
            key=lambda i: self._slots[i].req.rid)
        for i in prefilling:
            if budget <= 0:
                break
            slot = self._slots[i]
            take = min(self.chunk_size,
                       len(slot.req.run_prompt) - slot.fill, budget)
            plan.append([i, take, None])
            budget -= take
            n_pre += take
        if self.spec is not None and budget > 0:
            for pos in sorted(dec_pos,
                              key=lambda p: self._slots[plan[p][0]].req.rid):
                if budget <= 0:
                    break
                slot = self._slots[plan[pos][0]]
                if slot.req.temperature > 0:
                    continue           # verify is greedy-only
                # never draft past the request's remaining tokens, which
                # also keeps draft appends inside the admission reservation
                rem = slot.req.remaining_new - len(slot.out)
                cap = min(self.spec_k, rem - 1, budget)
                if cap <= 0:
                    continue
                drafts = np.asarray(
                    self.spec.propose(slot.req.rid, cap),
                    np.int32).reshape(-1)[:cap]
                if len(drafts) == 0:
                    continue
                plan[pos][1] += len(drafts)
                plan[pos][2] = drafts
                budget -= len(drafts)
                n_dec += len(drafts)
        return plan, n_dec, n_pre

    def _dispatch(self, plan, n_dec: int, n_pre: int) -> _Inflight:
        """Build one mixed step from the plan in a staging set, advance the
        scheduler's predicted slot state (lengths and fills move now;
        tokens commit in :meth:`_reconcile`) and launch the step, fetching
        nothing back.  Decode lanes whose input token is the unreconciled
        previous step's sample set ``use_prev`` and gather it on the
        device."""
        s, page = self.max_batch, self.page_size
        spec = self.spec is not None
        prev = self._inflight              # still the unreconciled step
        width = self._chunk_bucket(max(q for _, q, _ in plan))
        self._step_id += 1
        step_id = self._step_id
        buf = self._buffers[step_id % 2]
        h = buf.host(width)
        toks, positions, use_prev = h["toks"], h["positions"], h["use_prev"]
        lanes: List[_Lane] = []
        partial_rid: Optional[int] = None
        try:
            for i, take, drafts in plan:
                slot = self._slots[i]
                req = slot.req
                start = slot.length        # first new cache row
                end = start + take
                # grow the slot's page run to cover the new rows
                # (admission reserved them; an injected fault can still
                # raise here, and a partial grow is undone in place)
                n_before = len(slot.pages)
                try:
                    while len(slot.pages) * page < end:
                        (new_page,) = self._alloc(1)
                        self._table[i, len(slot.pages)] = new_page
                        slot.pages.append(new_page)
                except Exception:
                    self._drop_grown_pages(slot, i,
                                           len(slot.pages) - n_before)
                    partial_rid = req.rid
                    raise
                lane = _Lane(i, slot, take, drafts, start=start,
                             prefilling=slot.prefilling,
                             pages_added=len(slot.pages) - n_before,
                             prev_pending_step=slot.pending_step,
                             prev_lane_step=slot.lane_step)
                if slot.prefilling:
                    toks[i, :take] = req.run_prompt[slot.fill:
                                                    slot.fill + take]
                    slot.fill += take
                    lane.completes = not slot.prefilling
                    if lane.completes:
                        # this step samples the request's first token
                        lane.emits = 1
                        slot.inflight_emits += 1
                        slot.pending_step = step_id
                else:
                    if (prev is not None
                            and slot.pending_step == prev.step_id):
                        # column 0 is prev's still-on-device sample
                        use_prev[i] = 1
                    else:
                        toks[i, 0] = slot.pending
                    if drafts is not None:
                        toks[i, 1:take] = drafts
                    lane.emits = take      # worst case (spec reconciles)
                    slot.inflight_emits += take
                    slot.pending_step = step_id
                slot.lane_step = step_id
                slot.length = end
                positions[i, :take] = np.arange(start, end)
                h["q_lens"][i] = take
                h["lengths"][i] = end
                h["temps"][i] = req.temperature
                h["top_ks"][i] = req.top_k
                h["top_ps"][i] = req.top_p
                h["seeds"][i] = np.uint32(req.seed).view(np.int32)
                if self.sanitizer is not None:
                    # the step appends rows [start, end) and gathers every
                    # cached row [0, end) of this slot
                    self.sanitizer.note_append(req.rid, slot.pages, start,
                                               end, page)
                    self.sanitizer.note_gather(req.rid,
                                               slot.pages[:-(-end // page)])
                lanes.append(lane)
            if self.chaos is not None:
                ev = self.chaos.take("dispatch", self._iter)
                if ev is not None:
                    self.chaos_fired += 1
                    raise ChaosError(
                        f"injected dispatch failure at iter {self._iter} "
                        f"(step {step_id})")
        except PageSanError:
            raise
        except Exception:
            # restore the pre-dispatch host state and hand the affected
            # rids to step()'s failure bookkeeping
            for lane in reversed(lanes):
                self._undo_lane(lane)
            self._failed_rids = sorted(
                {l.slot.req.rid for l in lanes}
                | ({partial_rid} if partial_rid is not None else set()))
            raise
        # the table snapshot: the host mutates self._table right after
        h["table"][:] = self._table
        host_lengths = h["lengths"].tolist()
        sampled_any = bool((h["temps"] > 0).any())
        any_prev = bool(use_prev.any())
        d = buf.upload()
        sampling = ((d["temps"], d["top_ks"], d["top_ps"], d["seeds"])
                    if sampled_any else None)
        prev_args = ((prev.sampled, d["use_prev"] != 0) if any_prev
                     else (None, None))
        warm = self._note_key(("mixed", width))
        t_start = time.perf_counter()
        step_fn = _mixed_step_spec if spec else _mixed_step
        try:
            with torch.no_grad():
                out = step_fn(self.model, d["toks"], d["positions"],
                              d["q_lens"], d["lengths"], d["table"],
                              self.pool.arrays, *prev_args, sampling,
                              host_lengths)
        except Exception:
            for lane in reversed(lanes):
                self._undo_lane(lane)
            self._failed_rids = sorted({l.slot.req.rid for l in lanes})
            raise
        if spec:
            _, tokens, sampled = out
        else:
            _, sampled = out
            tokens = sampled
        host = buf.download(tokens, sampled)
        if self.sanitizer is not None:
            self.sanitizer.note_defer(step_id)
        self.stats.mixed_steps += 1
        return _Inflight(step_id, lanes, tokens, sampled, host, buf, width,
                         warm, t_start, n_dec, n_pre)

    def _fetch(self, inf: _Inflight) -> Tuple[np.ndarray, np.ndarray]:
        """The deliberate device-to-host sync: wait for a dispatched
        step's result copies (on CUDA the event recorded after them, and
        nothing else) and read its tokens.  Chaos may delay or fail it."""
        if self.chaos is not None:
            ev = self.chaos.take("fetch_delay", self._iter)
            if ev is not None:
                self.chaos_fired += 1
                time.sleep(ev.delay_s)  # a slow transfer, not an error
            ev = self.chaos.take("fetch", self._iter)
            if ev is not None:
                self.chaos_fired += 1
                raise ChaosError(
                    f"injected fetch failure at iter {self._iter} "
                    f"(step {inf.step_id})")
        if inf.host is None:
            tokens, sampled = inf.tokens, inf.sampled
        else:
            inf.buffers.event.synchronize()
            tokens, sampled = inf.host
        tokens = tokens.numpy().copy()
        sampled = (tokens if inf.sampled is inf.tokens
                   else sampled.numpy().copy())
        return tokens, sampled

    def _emit(self, slot: _Slot, tokens, now: float) -> None:
        """Commit generated tokens: output list, stream queue and callback
        delivery, per-token commit timestamps."""
        req = slot.req
        q = self._streams.get(req.rid)
        for t in tokens:
            t = int(t)
            slot.out.append(t)
            req.stats.token_t.append(now)
            if req.on_token is not None:
                req.on_token(req.rid, t)
            if q is not None:
                q.put(t)

    def _reconcile(self, inf: _Inflight, finished) -> None:
        """Settle a dispatched step: fetch its tokens (the one sync),
        commit them, retire what finished, and roll back what the commit
        rejects: draft rows the verify argmax disagreed with, and the lane
        of a zombie slot."""
        spec = self.spec is not None
        self._phase = "fetch"          # the recoverable window
        row_toks, sampled = self._fetch(inf)
        self._phase = "commit"
        now = time.perf_counter()
        emitted_total = 0
        for lane in inf.plan:
            slot, i = lane.slot, lane.idx
            rst = slot.req.stats
            if slot.zombie:
                # the request ended while this lane was in flight: discard
                # the lane whole and retire once nothing newer is in flight
                slot.inflight_emits -= lane.emits
                if lane.prefilling:
                    slot.fill -= lane.take
                self._rollback(i, slot, lane.start,
                               lane.start + lane.take)
                slot.length = lane.start
                if slot.lane_step == inf.step_id:
                    self._retire(i, finished, status=slot.finish_status)
                continue
            if lane.prefilling:
                self.stats.prefill_tokens += lane.take
                self.stats.padded_prefill_tokens += inf.width
                if not lane.completes:
                    continue           # more prompt chunks to go
                # prefill completed: the sampled row is the first token,
                # and the prompt pages are complete -> publish them.  Not
                # counted into emitted_total: the decode tok/s pair divides
                # decode commits by decode time
                slot.inflight_emits -= lane.emits
                tok = int(sampled[i])
                slot.pending = tok
                if rst.first_token_t == 0.0:
                    # a restored request's TTFT is its first attempt's
                    rst.first_token_t = now
                self._emit(slot, [tok], now)
                if spec:
                    self.spec.observe(slot.req.rid, [tok])
                if self.prefix is not None:
                    self.prefix.insert(slot.req.run_prompt, slot.pages)
            else:
                slot.inflight_emits -= lane.emits
                if lane.drafts is not None:
                    acc, emitted = greedy_accept(lane.drafts,
                                                 row_toks[i, :lane.take])
                    self.stats.draft_tokens += len(lane.drafts)
                    rst.draft_tokens += len(lane.drafts)
                    self.stats.accepted_tokens += acc
                    rst.accepted_tokens += acc
                else:
                    emitted = np.asarray([int(sampled[i])], np.int32)
                # truncate to the request's budget and stop at eos the way
                # token-by-token decoding would
                emitted = emitted[:slot.req.remaining_new - len(slot.out)]
                if self.eos_token_id is not None:
                    hit = np.nonzero(emitted == self.eos_token_id)[0]
                    if len(hit):
                        emitted = emitted[:int(hit[0]) + 1]
                m = len(emitted)                # >= 1 (bonus always lands)
                if m < lane.take:
                    # rejected (or budget/eos-clipped) draft rows: retreat
                    self._rollback(i, slot, lane.start + m,
                                   lane.start + lane.take)
                    slot.length = lane.start + m
                slot.pending = int(emitted[-1])
                self._emit(slot, emitted, now)
                self.stats.decode_tokens += m
                emitted_total += m
                if spec:
                    self.spec.observe(slot.req.rid, emitted)
            rst.decode_tokens = len(slot.req.committed) + len(slot.out)
            if self._done(slot):
                if self._lane_in_flight(slot):
                    # finished while the successor (with a lane for this
                    # slot) is in flight: retire when that lane rolls back
                    slot.zombie = True
                else:
                    self._retire(i, finished)
        if self.sanitizer is not None:
            self.sanitizer.note_reconcile(inf.step_id)
        self._consec_failures = 0      # a settled commit resets the drain
        # serialized step time: async steps overlap by design -- clock each
        # from the later of its dispatch and the previous reconcile
        dt = now - max(inf.t_start, self._last_reconcile_t)
        self._last_reconcile_t = now
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

    # -- speculative rollback --------------------------------------------
    def _rollback(self, slot_idx: int, slot: _Slot, new_end: int,
                  old_end: int) -> None:
        """Retreat a slot past uncommitted rows ``[new_end, old_end)``:
        the sanitizer's watermark first, then the pages the retreat
        emptied return to the pool.  Rows left on the kept tail page sit
        past ``slot.length``, where attention's length masking never reads
        them and the next append overwrites them."""
        page = self.page_size
        if self.sanitizer is not None:
            self.sanitizer.note_rollback(slot.req.rid, slot.pages,
                                         new_end, old_end, page)
        keep = -(-new_end // page)         # pages with >=1 committed row
        drop = slot.pages[keep:]
        if drop:
            # strict free: appends only land on exclusive pages
            self.pool.free(drop)
            self._table[slot_idx, keep:keep + len(drop)] = 0
            del slot.pages[keep:]

    # -- retirement ------------------------------------------------------
    def _done(self, slot: _Slot) -> bool:
        return bool(slot.out) and (
            len(slot.out) >= slot.req.remaining_new
            or (self.eos_token_id is not None
                and slot.out[-1] == self.eos_token_id))

    def _retire(self, slot_idx: int, finished,
                status: str = RequestStatus.OK) -> None:
        slot = self._slots[slot_idx]
        req = slot.req
        out = np.asarray(slot.out, np.int32)
        if req.committed:
            # a restored request's output spans attempts
            out = np.concatenate([np.asarray(req.committed, np.int32), out])
        rid = req.rid
        self._results[rid] = out
        finished.append((rid, out))
        for p in slot.pages:           # shared pages survive under the
            self.pool.decref(p)        # cache's (or other slots') refs
        self._table[slot_idx] = 0
        self._slots[slot_idx] = None
        if self.sanitizer is not None:
            self.sanitizer.note_release(rid)
        if self.spec is not None:
            self.spec.release(rid)
        rst = req.stats
        rst.finished_t = time.perf_counter()
        rst.status = status
        rst.decode_tokens = len(out)
        self.request_stats[rid] = rst
        self.stats.requests_finished += 1
        self._count_status(status)
        if req.deadline_t:
            self._deadline_live -= 1
        q = self._streams.get(rid)
        if q is not None:
            q.put(None)                # end-of-stream sentinel

    def _copy_page(self, src: int, dst: int) -> None:
        """The prefix cache's copy-on-write page copy (in place)."""
        self._note_key(("pagecopy",))
        with torch.no_grad():
            _copy_page_all_layers(src, dst, self.pool.arrays)
