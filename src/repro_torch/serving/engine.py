"""Continuous-batching serving engine: chunked in-place admission waves
interleaved with multi-tick decode blocks, on a contiguous or a paged KV
cache, in bf16/f32 or int8, scheduled on the device or by the host, with
the JAX engine's robustness layers.

Counterpart of ``repro/serving/engine.py``:

  * **chunked admission waves** — every pending admission advances by one
    ``prefill_chunk``-token chunk per wave, all rows in one
    ``transformer.prefill_chunk`` call that writes each chunk's KV in place
    at its row's offset (rows of decoding or idle lanes are masked).  A
    final chunk that would run past the cache row is shifted back to end at
    ``max_seq``; its leading overlap rewrites positions the previous chunk
    already wrote, with the same tokens at the same positions.  Rows whose
    prompt ends in the wave sample their first token on the device.
  * **whole-prompt admission** (``hymba``, ``xlstm_pair``: a recurrent
    state cannot resume chunk to chunk) — one admission a wave:
    ``transformer.prefill_step`` on a one-row cache of the prompt's
    length, then the adopt step copies it into the slot's rows (K/V rows
    [0, plen) and every state plane whole) and samples the first token.
    Idle lanes' decode ticks integrate their padding token into their
    state, which the next adopt step overwrites, as in JAX.
  * **decode blocks** — ``decode_block`` single-token ticks per block with
    per-slot sampling, cache writes and ``cache_len``/``emitted``
    bookkeeping on the device; the host reads the block's tokens and emit
    masks back once per block.  A lane that finishes mid-block keeps
    ticking under the mask: it emits nothing, and its KV write is parked at
    position ``max_seq``, which the contiguous cache write clamps to row
    position ``max_seq - 1`` (masked by the live length, or never attended
    again before the slot is retired — checked after every block) and the
    paged write resolves through the lane's table row: to the null page
    when ``max_seq`` is a whole number of pages, else to the final page's
    slack row past ``max_seq - 1`` (or the null page while that page is
    not yet owned).
  * **device-resident scheduling** (``device_sched=True``, the default, as
    in JAX) — the scheduler state (``last_token``, ``cache_len``,
    ``emitted``, the active mask, per-slot ``max_new``/``temps``/``seeds``)
    lives in (slots,) tensors on the engine's device, carried from block to
    block; admissions merge into it in place, their first tokens going
    straight from the wave into ``last_token``.  Block N+1 is dispatched
    from that state before block N's tokens are read back (one block
    behind), so the host never stands between two blocks in steady state.
    On a CUDA device the block is one ``torch.cuda.CUDAGraph``
    (``serving/graphs.py``), captured at the first block after that block
    ran eagerly and replayed for every later one; on the CPU the same code
    runs eagerly.  Each block's outputs are copied to pinned host memory on
    the engine's stream before the next replay overwrites them.  The host
    mirror lags by one block, so a lane that finished on the device ticks
    through one more fully masked block before the host retires it; the
    tokens are those of the host-driven engine (``device_sched=False``,
    which reads every block back before dispatching the next).  Paged
    lanes are granted their whole reservation at admission, so decode
    never allocates and the block table changes only at admission and
    retirement.  ``stats["host_block_syncs"]`` counts the readbacks a
    dispatch waited on (every block host-driven; on the device only those
    that retire a lane), and ``stats["steady_state_syncs_per_block"]``
    charges them to blocks dispatched with no wave or retirement since the
    previous one: 1.0 host-driven, 0.0 on the device.
  * **bounded interleaving** — one beat (``step()``) runs at most one
    admission wave and one decode block, so in-flight lanes stall for at
    most one chunk between blocks
    (``stats["max_chunks_between_decode_blocks"]``).
  * **paged KV** (``paged=True``) — a global pool of ``kv_pages`` pages of
    ``page_size`` tokens (page 0 the null page) and one block-table row
    per slot, so KV memory follows live tokens instead of
    ``slots x max_seq``.  A refcounted host allocator hands pages out
    under FIFO admission gated by each request's worst-case reservation
    (``worst_case_pages``): a request whose reservation does not fit waits
    (``admissions_deferred_pages``), so growth never runs dry mid-flight.
    Host-driven scheduling grows a lane's pages lazily (the admission
    chunk's span, then each decode block's appends).  Retirement drops the
    lane's page references and zeroes its table row.  The block table lives
    on the device as one (slots, pages_per_slot) int32 tensor, updated row
    by row on the engine's stream in both modes.  Paged serving emits the
    contiguous engine's tokens exactly: its kernels walk keys in the
    contiguous kernels' order.
  * **paged prefix sharing** (``enable_prefix_sharing=True``) — a radix
    trie over fully written prompt pages (``_PrefixIndex``) maps an
    admitted prompt to its longest cached prefix; the slot's block table
    aliases those pages (one pool reference each) and its prefill starts at
    the share base, a ``prefill_chunk`` multiple, so its chunk schedule and
    its tokens are the plain paged engine's.  A base inside a page copies
    that page first (copy-on-write, ``transformer.copy_paged_page``).  An
    admission whose prefix a pending admission is prefilling waits for it
    (``admissions_held_for_prefix``).  Completed admissions register their
    full prompt pages, which the trie keeps alive; under pool pressure
    least recently used leaves are evicted.  The reservation counts only pages the slot may
    still allocate, and pages kept alive by sharers after their owner
    retired are added to the admission gate.
  * **int8 KV** (``kv_quant=True``, contiguous or paged) — K/V stored as
    int8 with per-(token, head) absmax scales; chunk attention reads them as
    f32(int8) * f32(scale), decode through bf16, as the JAX model does.
  * **split-K decode** (``kv_splits=K``) — every decode attention read goes
    through K-chunk split-K (plain PyTorch, ``Ctx.kv_splits``) instead of
    the decode kernels, as in JAX; its tokens are the engine's without it.
  * **multi-rank serving** (``mesh=``, a ``torch.distributed``
    ``DeviceMesh`` with axes ("data", "model"); ``shard_slots=True``,
    ``shard_kv=False``) — every rank runs this host scheduler over all
    lanes (it must be deterministic: the same requests, the same fault
    schedule, no clock-driven decision that ranks could take apart: once
    a beat every rank reads its clock for the deadlines and retry backoffs
    it holds, and one MAX all-reduce over a gloo group of the world
    combines the flags, which every rank then acts on; the idle wait
    before a retry is the least over ranks; the ``block_deadline_s``
    watchdog, which could fire while a collective is stuck, is refused on
    a world of more than one), and
    its device holds only its data shard's lanes: scheduler state, block
    table rows and contiguous cache rows (``runtime/sharding.py``); a paged
    pool is whole on every rank but written only for its own lanes, so
    prefix sharing keeps one namespace a data shard and a copy-on-write
    split runs on the owning shard.  A slot count that ``data`` does not
    divide is padded with lanes never assigned (``requested_slots``
    against ``slots``; ``slots_per_device``).  The decode block gathers its
    outputs (tokens, emit masks, the non-finite latch) and a wave its first
    tokens over ``data``, so every rank reads the same readback, one block
    behind as before.  With ``shard_kv`` the ranks of one data index split
    the split-K chunks over ``model`` (``kv_splits`` defaults to its size
    and must tile it) and all-gather the partials in rank order: the
    tokens are the single-device engine's.  On the card the groups are
    NCCL (and the captured block then holds its collectives) or, for ranks
    sharing one card, gloo: each collective staged through host memory,
    the block's gather run after the captured block, and no ``shard_kv``;
    on the CPU gloo.  An MoE layer routes a rank's rows (its slots, idle
    and padded lanes included), as JAX's ``shard_map`` engine does.

**Robustness** (the JAX engine's, JAX PRs 7-9).  Every request ends with a
``RequestStatus``: an invalid one is REJECTED at ``submit()``; ``cancel()``
and ``deadline_s`` retire a queued, pending or live request CANCELLED or
TIMEOUT at the next beat; a fault retires only its own lane FAILED (the
pages roll back refcount-exact, a faulted lane's prefix registrations are
withdrawn).  The integrity guards are the block's non-finite latch (an
active lane whose logits are not finite on any tick, read back with the
block's tokens) and a host check of the token range.  A
``FaultInjector`` (``serving/faultinject.py``) schedules faults at four
seams: page allocation, dispatch (before anything is launched or
replayed, so ``with_retries`` may re-issue it), a NaN lane mask that the
block reads from a persistent device buffer, and the readback.  A
device-resident dispatch that still fails after ``dispatch_retries``, or a
block past ``block_deadline_s``, degrades the engine: the in-flight blocks
are drained (the host mirror is then exact) and it serves host-driven,
completions DEGRADED; with ``repromote`` a tick-paced circuit breaker
sends a canary (a small op on the engine's stream, never the captured
block) and, when it passes, writes the host mirror into the same state
tensors the captured graph reads and replays it again.  With
``max_retries`` a FAILED (or, with ``retry_timeouts``, TIMEOUT) request
re-queues after a seeded backoff and prefills its prompt plus the tokens
it already emitted, so it continues token for token; a second breaker
stops retry storms.  ``submit()``/``step()``/``drain()``/``close()`` are
the resident lifecycle (``run()`` = a fresh stats window, submit all,
drain); ``on_token`` streams each committed token once, after the guards;
``on_block`` runs after every block; ``stats`` is a window, ``lifetime``
sums windows; ``audit()`` re-derives the pool's refcounts from the block
tables and the trie.

The host retires a lane one block behind the device, so when it
force-retires one (a guard, a cancellation, a deadline) the next block,
already dispatched, still ran that lane.  Its tokens there belong to the
retired request: a block's readback keeps each lane's occupancy count at
dispatch (``_Slot.gen``) and drops lanes whose occupant changed since.
(The JAX engine has no such guard; see ROADMAP section C.)

The JAX engine unpacks the base-3 codes again at every dispatch.  Weights
are immutable while serving, so this engine pre-decodes them ONCE when it is
built (``transformer.predecode_packed``); every GEMM then computes exactly
what the packed path computes.  Attention runs the chunk and decode kernels
of ``ctx`` (the kernel path by default).

Sampling (``sample``): greedy is ``argmax`` (the first maximum, as in JAX).
With a temperature the draw is a function of (request seed, emit index,
logits) alone — Gumbel-max noise from a counter-based hash of (seed, emit
index, vocabulary index), computed by tensor ops on the device — so a
request samples the same tokens whatever slot, schedule or scheduling mode
it gets, and a retry continues its draws.  It does not reproduce JAX's
threefry draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import validate_num_splits
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.runtime import sharding
from repro_torch.runtime.fault import (CircuitBreaker, Watchdog,
                                       backoff_delay, with_retries)
from repro_torch.serving import graphs
from repro_torch.serving.faultinject import FaultInjector, InjectedFault

_SEED_MOD = 2 ** 31 - 1


class RequestStatus(enum.Enum):
    """Terminal disposition of a served request, set once, when ``done``
    turns True.  Anything short of OK names the containment path that
    retired the lane; none of them touches another lane."""

    OK = "ok"                # completed normally
    REJECTED = "rejected"    # failed validation at submit(); never ran
    TIMEOUT = "timeout"      # deadline_s expired (queued or in flight)
    CANCELLED = "cancelled"  # cancel(request), observed at a beat
    FAILED = "failed"        # a fault confined to this lane (non-finite
    #                          logits, corrupt readback, page allocation)
    DEGRADED = "degraded"    # correct tokens, finished after the engine
    #                          fell back to host-driven scheduling


class AuditError(RuntimeError):
    """A page-pool / prefix-trie / block-table invariant is violated
    (``ServingEngine.audit``)."""


# the stats key charged per terminal status; all six are always present,
# and recounted from the window's requests at finalize
_STATUS_COUNTERS = {
    RequestStatus.OK: "requests_completed",
    RequestStatus.REJECTED: "requests_rejected",
    RequestStatus.TIMEOUT: "requests_timed_out",
    RequestStatus.CANCELLED: "requests_cancelled",
    RequestStatus.FAILED: "requests_failed",
    RequestStatus.DEGRADED: "requests_degraded",
}


@dataclasses.dataclass
class StepOutcome:
    """What one beat (``ServingEngine.step``) did.  ``worked`` is False
    only when the engine had nothing to do; ``remaining`` counts requests
    still owed a terminal status (queued, pending, live, waiting to retry);
    ``idle_until`` (a ``time.perf_counter()`` time), when set, says that no
    beat can progress before then: only retry backoff is left, so the
    caller should sleep."""

    worked: bool
    remaining: int
    idle_until: Optional[float] = None


@dataclasses.dataclass(eq=False)   # identity: queue removal must find THIS
class Request:                     # object, and a prompt array has no ==
    prompt: np.ndarray              # (prompt_len,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy
    seed: Optional[int] = None      # sampling seed; the engine assigns one
    deadline_s: Optional[float] = None   # wall-clock budget from submit();
    #                                      a retry's restarts at its requeue
    max_retries: Optional[int] = None    # overrides the engine's budget
    # filled by the engine:
    output: Optional[np.ndarray] = None
    ttft_s: Optional[float] = None  # submit() to first token
    done: bool = False
    status: Optional[RequestStatus] = None
    error: Optional[str] = None     # the cause of a status other than OK
    cancelled: bool = False         # set by ServingEngine.cancel()
    attempts: int = 0               # admissions started (1 = no retry)
    retries: int = 0                # requeues granted
    retry_errors: List[str] = dataclasses.field(default_factory=list)
    #                                 errors of the withdrawn attempts


class _Slot:
    """Host-side state of one decode lane of the shared cache."""

    __slots__ = ("request", "tokens", "cache_len", "last_token", "gen")

    def __init__(self):
        self.request: Optional[Request] = None
        self.tokens: List[int] = []
        self.cache_len = 0
        self.last_token = 0
        self.gen = 0   # retirements so far: tells occupants apart

    @property
    def active(self) -> bool:
        return self.request is not None

    def free(self, status: RequestStatus = RequestStatus.OK,
             error: Optional[str] = None) -> None:
        r = self.request
        r.output = np.asarray(self.tokens, np.int32)
        r.done = True
        r.status = status
        if error is not None:
            r.error = error
        self.request = None
        self.tokens = []
        self.cache_len = 0
        self.last_token = 0
        self.gen += 1


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------
#
# A 32-bit hash whose lanes live in int64 tensors: every value stays below
# 2^32 and every product below 2^49, so nothing overflows, every right
# shift is of a non-negative value, and the CPU and the card compute the
# same integers.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for 0 <= x, c < 2^32, in two 16-bit halves of x."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) that scrambles every bit into every other
    (the "lowbias32" finalizer)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, emit_idx: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """(b,) request seeds and emit indices -> (b, vocab) f32 standard
    Gumbel noise, entry (i, v) a function of (seeds[i], emit_idx[i], v)
    alone: a 24-bit uniform in (0, 1) from the hash, then -log(-log(u))."""
    key = _mix32(_mix32(seeds.long() & _M32) ^ (emit_idx.long() & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _mix32(key[:, None] ^ _mix32(_mul32(v, 0x9E3779B9))[None, :])
    u = ((h >> 8).float() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, seeds, emit_idx, temps) -> torch.Tensor:
    """(b, vocab) logits -> (b,) int64 tokens.  ``seeds``, ``emit_idx`` and
    ``temps`` are (b,) tensors (or sequences) on the logits' device.
    Greedy rows (temperature <= 0) take the first maximum; a row with
    temperature t > 0 takes argmax(logits / t + gumbel_noise(seed, emit
    index)).  The noise is computed for every row and selected per row, so
    nothing branches on a value (the block runs inside a CUDA graph)."""
    dev = logits.device
    seeds = torch.as_tensor(seeds, device=dev)
    emit_idx = torch.as_tensor(emit_idx, device=dev)
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    greedy = torch.argmax(logits, dim=-1)
    noisy = (logits.float() / temps.clamp_min(1e-6)[:, None]
             + gumbel_noise(seeds, emit_idx, logits.shape[-1]))
    return torch.where(temps > 0, torch.argmax(noisy, dim=-1), greedy)


# ---------------------------------------------------------------------------
# Paged KV: refcounted page pool and the prefix index (host side)
# ---------------------------------------------------------------------------

class _PagePool:
    """Host-side refcounted allocator over the global KV page pool (the JAX
    engine's).  Page 0 is the reserved null page and is never handed out.
    ``alloc`` hands pages out at refcount 1, prefix sharing adds one
    reference per aliasing reader (a slot's table entry or the prefix
    index) with ``incref``, and ``decref`` frees a page when its last
    reader drops it, so ``used_pages`` counts each page once however many
    readers alias it.  Dropping a reference nobody holds (double free) and
    referencing a free page fail fast.  The free list is LIFO, so a retired
    page is reused first."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("page pool needs >= 2 pages (one is the "
                             "reserved null page)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs: dict = {}   # page id -> refcount >= 1 (absent = free)

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages aliased by more than one reader."""
        return sum(1 for c in self._refs.values() if c >= 2)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: asked {n}, have {len(self._free)} "
                "(reservation-gated admission should make this unreachable)")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, page: int) -> None:
        if page not in self._refs:
            raise RuntimeError(f"incref of free page {page}")
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True when that freed the page."""
        c = self._refs.get(page)
        if c is None:
            raise RuntimeError(f"double free of page {page}")
        if c == 1:
            del self._refs[page]
            self._free.append(page)
            return True
        self._refs[page] = c - 1
        return False

    def free(self, pages: List[int]) -> None:
        for p in pages:
            self.decref(p)


class _PrefixNode:
    """One fully written prompt page: ``key`` its ``page_size`` token ids,
    ``page`` the pool page holding their KV.  A root-to-node path spells a
    cached prefix."""

    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict = {}
        self.last_use = 0


class _PrefixIndex:
    """Radix trie over cached prompt prefixes at page granularity (the JAX
    engine's).  Each node is a fully written prompt page; partial trailing
    pages are never indexed, which also keeps decode appends and parked
    writes out of every indexed page.  Eviction removes least recently used
    leaves, so a cached prefix goes tail first.

    ``ns`` is the sharing namespace, the data shard of the slot (0 without
    a mesh): node keys are ``(ns,) + page tokens``, so a prompt matches only
    pages its own shard registered.  Each shard writes only its own slots'
    pages into its copy of the pool; another shard's page holds other
    data there."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _PrefixNode(None, None, None)
        self._clock = 0
        self.n_pages = 0   # live nodes == pages the index references

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt, ns: int = 0) -> tuple:
        """Longest cached prefix of ``prompt`` in namespace ``ns``: the chain
        of matched full-page nodes and, where the next page diverges inside
        the page, the child sharing most leading tokens with it and that
        count (the copy-on-write donor).  Touches the matched nodes."""
        ps = self.page_size
        now = self._tick()
        node, chain = self.root, []
        n_full = len(prompt) // ps
        while len(chain) < n_full:
            j = len(chain)
            key = (ns,) + tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            chain.append(child)
            node = child
        rest = [int(t) for t in prompt[len(chain) * ps:]]
        boundary, blcp = None, 0
        for key, child in node.children.items():
            if key[0] != ns:
                continue
            lcp = 0
            for a, b in zip(key[1:], rest):
                if a != b:
                    break
                lcp += 1
            if lcp > blcp:
                boundary, blcp = child, lcp
        if boundary is not None:
            boundary.last_use = now
        return chain, boundary, blcp

    def insert(self, prompt, pages, ns: int = 0) -> list:
        """Index ``pages[j]`` as the KV of prompt page j in namespace
        ``ns``; returns the new nodes (the caller takes one pool reference
        for each).  A page whose tokens are already cached keeps the first
        registrant's page."""
        ps = self.page_size
        now = self._tick()
        node, new = self.root, []
        for j in range(len(pages)):
            key = (ns,) + tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(key, pages[j], node)
                node.children[key] = child
                new.append(child)
                self.n_pages += 1
            child.last_use = now
            node = child
        return new

    def evict_coldest(self, evictable, force: bool = False):
        """Remove the least recently used leaf whose page satisfies
        ``evictable(page)`` and return its page (None when there is none).
        With ``force``, fall back to the coldest leaf: dropping the index
        reference of a page a slot still reads frees nothing now but makes
        its parent a leaf, so eviction under pressure always progresses."""
        for pred in ((evictable, lambda p: True) if force else (evictable,)):
            best = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (node is not self.root and not node.children
                        and pred(node.page)
                        and (best is None or node.last_use < best.last_use)):
                    best = node
            if best is not None:
                del best.parent.children[best.key]
                self.n_pages -= 1
                return best.page
        return None


def reference_decode(cfg: ModelConfig, params: nn.ModuleDict, ctx: Ctx,
                     prompt, max_new: int, max_seq: int,
                     cache_dtype: torch.dtype = torch.bfloat16, follow=None,
                     logits: list | None = None):
    """Unbatched greedy prefill + decode on the given (packed) parameters —
    the oracle the engine is held against.  Returns (tokens, margins):
    tokens[i] is the oracle's argmax at step i and margins[i] its top-1
    minus top-2 logit.

    With ``follow`` (another decoder's max_new tokens) the oracle is fed
    those tokens instead of its own (teacher forcing), so every step of the
    other decoder is judged on the same history, and margins[i] is the
    oracle's top logit minus its logit of follow[i]: 0 where the two agree,
    otherwise how far from the oracle's choice the other decoder's was.
    With a ``logits`` list, each step's (vocab,) logits row is appended."""
    dev = transformer.param_device(params)
    cache = transformer.init_cache(cfg, 1, max_seq, cache_dtype, dev)
    toks, margins = [], []

    def take(step_logits):
        row = step_logits[0].float()
        if logits is not None:
            logits.append(row)
        toks.append(int(torch.argmax(row)))
        if follow is None:
            top = torch.topk(row, 2).values
            margins.append(float(top[0] - top[1]))
        else:
            margins.append(float(row.max() - row[int(follow[len(toks) - 1])]))
        return toks[-1] if follow is None else int(follow[len(toks) - 1])

    prompt_t = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
    step, cache = transformer.prefill_step(cfg, params, prompt_t[None], ctx,
                                           cache)
    nxt = take(step)
    pos = len(prompt)
    for _ in range(max_new - 1):
        step, cache = transformer.decode_step(
            cfg, params, torch.tensor([[nxt]], device=dev), ctx, cache, pos)
        nxt = take(step)
        pos += 1
    return toks, margins


def _check_mesh_names(mesh) -> None:
    names = tuple(mesh.mesh_dim_names or ())
    if names != ("data", "model"):
        raise ValueError("ServingEngine mesh must have axis_names "
                         f"('data', 'model'); got {names}")


def _refuse_recurrent(cfg: ModelConfig, mesh, paged: bool,
                      kv_quant: bool) -> None:
    """What the recurrent kinds cannot serve, with the JAX engine's
    messages and in its order: a mesh, int8 KV, a paged cache."""
    kind = cfg.block_kind
    if mesh is not None:
        _check_mesh_names(mesh)
        raise ValueError(
            "multi-device serving requires block_kind='attn' (recurrent "
            f"kinds keep the single-device engine); got {kind!r}")
    if kv_quant:
        raise ValueError(
            "kv_quant=True (int8 KV + per-(token, head) scales) requires "
            f"block_kind='attn'; got {kind!r}")
    if paged:
        raise ValueError(
            "paged KV cache requires block_kind='attn' (recurrent kinds "
            f"keep O(1) state per slot); got {kind!r}")


def check_mesh(mesh, device: torch.device) -> tuple:
    """A serving mesh's (data, model) sizes, after checking its axis names
    (the JAX engine's message) and that its process groups can run on
    ``device``: gloo on the CPU; NCCL or gloo on the card (gloo: ranks
    sharing one card, which NCCL refuses, each collective staged through
    host memory)."""
    _check_mesh_names(mesh)
    names = tuple(mesh.mesh_dim_names)
    want = ("nccl", "gloo") if device.type == "cuda" else ("gloo",)
    backends = {dist.get_backend(mesh.get_group(axis)) for axis in names}
    if not backends <= set(want) or len(backends) > 1:
        raise ValueError(
            f"a mesh engine on {device.type} needs {' or '.join(want)} "
            f"process groups; the mesh's groups run {sorted(backends)}")
    return mesh.size(0), mesh.size(1)


def _adopt(cache: dict, one: dict, i: int) -> None:
    """Copy a one-row cache into row ``i`` of ``cache`` in place, each plane
    at (layer 0, row i, 0, ...) over the one-row plane's extent: K/V rows
    [0, plen) and every state plane whole (JAX's adopt step)."""
    for name, plane in cache.items():
        src = one[name]
        if isinstance(plane, dict):
            _adopt(plane, src, i)
            continue
        region = (slice(None), slice(i, i + 1)) + tuple(
            slice(0, n) for n in src.shape[2:])
        plane[region].copy_(src)


class ServingEngine:
    """Token-level continuous batching over ``batch_slots`` lanes of up to
    ``max_seq`` positions.  ``params`` are packed parameters
    (``transformer.pack_params`` or ``convert.from_jax_packed``) on
    ``device``; the engine runs on the card unless ``device="cpu"``.  It
    serves token-frontend models of every block kind: attention blocks,
    dense or MoE (whose expert banks stay packed and run through ``tlmm``;
    on a mesh each rank routes its data shard's rows, as JAX's
    ``shard_map`` engine does), and the recurrent hymba and
    xLSTM, whose prompts are admitted whole, one a wave, on a contiguous
    bf16 or f32 cache on one rank (no paged cache, int8 KV or mesh, as in
    JAX).

    ``device_sched`` (default True) keeps the scheduler state on the device
    and, on a CUDA device, replays each decode block as one captured CUDA
    graph; ``device_sched=False`` is the host-driven loop.  ``paged=True``
    keeps KV in a pool of ``kv_pages`` pages of ``page_size`` tokens
    (default: every slot can reach ``max_seq``, plus the null page), with
    prefix sharing under ``enable_prefix_sharing``; ``kv_quant=True``
    stores int8 KV with f32 scales.  ``kv_splits``, ``mesh``,
    ``shard_slots`` and ``shard_kv`` are the JAX engine's split-K and
    multi-device options (module docstring), with its validation messages;
    ``mesh_shape``, ``slots_per_device`` and ``requested_slots`` report the
    layout.

    Robustness keywords, with the JAX engine's defaults:
    ``block_deadline_s`` bounds one block's dispatch and the readback it
    waits on (a watchdog that only records); ``dispatch_retries`` and
    ``dispatch_backoff_s`` re-issue a failed dispatch; ``max_retries``,
    ``retry_timeouts`` and ``retry_backoff_s`` set the request retry
    budget; ``repromote`` and ``probe_cooldown_blocks`` pace the return to
    device-resident scheduling after a degrade; ``retry_breaker_*`` the
    breaker over retries; ``fault_injector`` schedules faults;
    ``audit_on_retire`` runs ``audit()`` after every fault-path retirement
    and promotion; ``on_block(engine, block)`` runs after every decode
    block and ``on_token(request, token)`` once per committed token."""

    def __init__(self, cfg: ModelConfig, params: nn.ModuleDict, *,
                 max_seq: int, batch_slots: int = 4,
                 ctx: Optional[Ctx] = None, seed: int = 0,
                 prefill_chunk: int = 32, decode_block: int = 8,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 paged: bool = False, page_size: int = 16,
                 kv_pages: Optional[int] = None,
                 enable_prefix_sharing: bool = False,
                 device_sched: bool = True, kv_quant: bool = False,
                 mesh=None, shard_slots: bool = True, shard_kv: bool = False,
                 kv_splits: Optional[int] = None,
                 block_deadline_s: Optional[float] = None,
                 dispatch_retries: int = 2,
                 dispatch_backoff_s: float = 0.0,
                 max_retries: int = 0, retry_timeouts: bool = False,
                 retry_backoff_s: float = 0.02, repromote: bool = True,
                 probe_cooldown_blocks: int = 2,
                 retry_breaker_threshold: int = 4,
                 retry_breaker_window: int = 16,
                 retry_breaker_cooldown: int = 8,
                 fault_injector: Optional[FaultInjector] = None,
                 audit_on_retire: bool = False,
                 on_block: Optional[Callable] = None,
                 on_token: Optional[Callable] = None,
                 device: str | torch.device = "cuda"):
        if cfg.block_kind != "attn":
            _refuse_recurrent(cfg, mesh, paged, kv_quant)
        if cfg.frontend != "token":
            raise ValueError(
                f"ServingEngine serves token ids; {cfg.name} takes "
                f"precomputed embeddings (frontend={cfg.frontend!r}): call "
                "transformer.prefill_step / decode_step with (b, s, d_model) "
                "inputs instead")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        pdev = transformer.param_device(params)
        if pdev.type != dev.type or (dev.index is not None
                                     and pdev.index != dev.index):
            raise ValueError(f"params live on {pdev}, the engine on {dev}")
        if enable_prefix_sharing and not paged:
            raise ValueError("enable_prefix_sharing requires paged=True "
                             "(prefix reuse aliases KV pool pages through "
                             "the block table)")
        self.cfg = cfg
        self.device = pdev
        self.params = transformer.predecode_packed(cfg, params)
        self.max_seq = max_seq
        self.slots = batch_slots
        self.prefill_chunk = max(1, min(prefill_chunk, max_seq))
        # chunked admission waves; the recurrent kinds admit whole prompts
        self._chunked = cfg.block_kind == "attn"
        self.decode_block = max(1, decode_block)
        self.cache_dtype = cache_dtype
        self.kv_quant = bool(kv_quant)
        self.device_sched = bool(device_sched)
        self.paged = bool(paged)
        self.enable_prefix_sharing = bool(enable_prefix_sharing)
        self._init_mesh(mesh, shard_slots, shard_kv, kv_splits)
        # MoE on a mesh: each rank routes the rows of its data shard (its
        # slots, idle and padded lanes included), as the JAX mesh engine's
        # shard_map does, so capacity counts a shard's rows
        world = self.mesh_shape[0] * self.mesh_shape[1]
        if world > 1 and block_deadline_s is not None:
            raise ValueError(
                f"ServingEngine: block_deadline_s on a mesh of {world} ranks "
                "is not supported: the watchdog fires while a collective may "
                "be stuck, so ranks could not agree on it without hanging")
        # clock-driven decisions are agreed once a beat over this group
        self._clock_group = (dist.new_group(backend="gloo")
                             if world > 1 else None)
        self._clock_flags = None
        if self.paged:
            self.page_size = max(1, min(int(page_size), max_seq))
            self.pages_per_slot = -(-max_seq // self.page_size)
            self.kv_pages = (int(kv_pages) if kv_pages is not None
                             else batch_slots * self.pages_per_slot + 1)
        self.ctx = ctx or Ctx()
        if self.kv_splits:
            # split-K decode attention: the formulation whose result does
            # not depend on how its chunks are spread over ranks
            self.ctx = dataclasses.replace(
                self.ctx, kv_splits=self.kv_splits,
                kv_group=self._model_group,
                kv_group_size=self.mesh_shape[1] if self.shard_kv else 1)
        self.seed = seed
        self.block_deadline_s = block_deadline_s
        self.dispatch_retries = max(0, int(dispatch_retries))
        self.dispatch_backoff_s = float(dispatch_backoff_s)
        self.max_retries = max(0, int(max_retries))
        self.retry_timeouts = bool(retry_timeouts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.repromote = bool(repromote)
        self.probe_cooldown_blocks = max(1, int(probe_cooldown_blocks))
        self.retry_breaker_threshold = max(1, int(retry_breaker_threshold))
        self.retry_breaker_window = max(1, int(retry_breaker_window))
        self.retry_breaker_cooldown = max(1, int(retry_breaker_cooldown))
        self.fault_injector = fault_injector
        self.audit_on_retire = bool(audit_on_retire)
        self.on_block = on_block
        self.on_token = on_token
        # the engine's own stream on the card: waves, table copies, block
        # replays and readbacks keep one order on it
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # engine-lifetime counters: summed over windows, never reset
        self.lifetime = {"arrivals": 0, "windows": 0, "faults_injected": 0,
                         "admissions": 0, "decode_blocks": 0,
                         "decode_tokens": 0, "total_new_tokens": 0,
                         "requests_retried": 0, "retries_total": 0,
                         "graph_captures": 0}
        self.lifetime.update({k: 0 for k in _STATUS_COUNTERS.values()})
        self._closed = False
        self._reset_engine_state()
        self.reset_stats()

    def _init_mesh(self, mesh, shard_slots: bool, shard_kv: bool,
                   kv_splits: Optional[int]) -> None:
        """Check the mesh options (the JAX engine's messages) and set the
        rank's share of the slots.  Every rank runs this host scheduler over
        all ``slots`` lanes; its device holds only its ``data`` shard's
        lanes, ``[_lo, _lo + slots_per_device)``, and ranks of one ``data``
        index split only the decode attention chunks over ``model``."""
        self.mesh = mesh
        dd, mm = check_mesh(mesh, self.device) if mesh is not None else (1, 1)
        self._data_group = self._model_group = None
        self.shard_slots = bool(shard_slots) and dd > 1
        self.shard_kv = bool(shard_kv) and mm > 1
        self.requested_slots = self._usable_slots = self.slots
        if self.shard_slots and self.slots % dd:
            # pad the slot axis to a data-axis multiple; the padded lanes
            # are never assigned and tick fully masked
            self.slots = -(-self.slots // dd) * dd
        self.mesh_shape = (dd, mm)
        self.slots_per_device = self.slots
        if mesh is not None:
            specs = sharding.serving_specs(
                mesh, slots=self.slots, paged=self.paged,
                kv_quant=self.kv_quant, shard_slots=self.shard_slots)
            (self.slots_per_device,) = sharding.local_shape(
                mesh, specs["state"], (self.slots,))
        if kv_splits is None:
            self.kv_splits = mm if self.shard_kv else 0
        else:
            self.kv_splits = int(kv_splits)
            if self.kv_splits < 1:
                raise ValueError("kv_splits must be >= 1 when set")
        if self.shard_kv:
            validate_num_splits(self.kv_splits, mm)
            self._model_group = mesh.get_group("model")
        # gloo groups on the card: each collective staged through host
        # memory, so none may sit inside the captured block (the decode
        # block's gather then runs after it)
        self._staged = (mesh is not None and self.device.type == "cuda"
                        and dist.get_backend(mesh.get_group("data"))
                        == "gloo")
        if self._staged and self.shard_kv:
            raise ValueError(
                "shard_kv on a gloo mesh on the card: the split-K partials' "
                "gather would sit inside the captured decode block; use "
                "NCCL groups")
        self._lo = (mesh.get_local_rank("data") * self.slots_per_device
                    if self.shard_slots else 0)
        # the block's outputs are gathered over 'data' (an identity on a
        # one-rank axis, kept so that a mesh engine always runs its
        # collectives); lanes replicated over 'data' need no gather
        if mesh is not None and (self.shard_slots or dd == 1):
            self._data_group = mesh.get_group("data")

    def _slot_shard(self, i: int) -> int:
        """The data shard owning slot i (0 when slots are not sharded): the
        prefix-sharing namespace."""
        return i // self.slots_per_device if self.shard_slots else 0

    def _local(self, i: int) -> Optional[int]:
        """Slot i's row in this rank's device tensors, or None when another
        data shard holds it."""
        j = i - self._lo
        return j if 0 <= j < self.slots_per_device else None

    def _mine(self, arr: np.ndarray) -> np.ndarray:
        """A copy of this rank's rows of a (slots, ...) host array (on the
        CPU an upload shares its memory, and the host mirror changes)."""
        return arr[self._lo:self._lo + self.slots_per_device].copy()

    def _upload_mine(self, arr: np.ndarray) -> torch.Tensor:
        """This rank's rows of a (slots, ...) host array, on the device."""
        return self._upload(self._mine(arr))

    def _gather_slots(self, *parts: torch.Tensor) -> tuple:
        """(slots_per_device, ...) tensors of this rank -> (slots, ...) in
        shard order, all-gathered over the 'data' group in one collective
        (packed as int64 side by side); as given without a mesh."""
        if self._data_group is None:
            return parts
        n = self.slots_per_device
        packed = torch.cat([p.reshape(n, -1).to(torch.int64) for p in parts],
                           dim=1)
        dev = packed.device
        if self._staged:
            packed = packed.cpu()
        out = packed.new_empty((self.slots, packed.shape[1]))
        sharding.all_gather_rows(out, packed, self._data_group)
        out = out.to(dev)
        res, col = [], 0
        for p in parts:
            w = p[0].numel()
            res.append(out[:, col:col + w].reshape((self.slots,) + p.shape[1:])
                       .to(p.dtype))
            col += w
        return tuple(res)

    # -- lifecycle ---------------------------------------------------------

    def _reset_engine_state(self) -> None:
        """(Re)build the engine-lifetime serving state: lanes, the request
        pools, the page pool, block table and prefix trie, the breakers and
        the arrival counter.  The cache, the device state and the captured
        block are rebuilt at the next beat (a graph holds the addresses of
        the tensors it was captured on).  Called from ``__init__``; calling
        it again abandons every request in flight."""
        self._sched_epoch = 0   # bumps on every wave and retirement
        self._inflight: deque = deque()   # dispatched, not yet read back
        # the live scheduling mode: False after a degrade (device_sched is
        # the configured mode and never changes); _degraded stamps later
        # completions DEGRADED
        self._dev_active = self.device_sched
        self._degraded = False
        # the device breaker trips at the first degrade and paces canary
        # probes; the retry breaker turns a burst of retryable failures
        # into fail-fast statuses.  Both tick once a beat.
        self._retryq: List[dict] = []
        self._dev_breaker = CircuitBreaker(
            threshold=1, window=1, cooldown=self.probe_cooldown_blocks)
        self._retry_breaker = CircuitBreaker(
            threshold=self.retry_breaker_threshold,
            window=self.retry_breaker_window,
            cooldown=self.retry_breaker_cooldown)
        self._prefix = None
        if self.paged:
            self._pool = _PagePool(self.kv_pages)
            if self.enable_prefix_sharing:
                self._prefix = _PrefixIndex(self.page_size)
            # host block table (its device copy is built with the cache);
            # dead entries: page 0
            self._bt = np.zeros((self.slots, self.pages_per_slot), np.int32)
            self._bt_dev = None
            self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
            self._slot_shared_n = [0] * self.slots   # aliased leading pages
            self._page_slot_refs: dict = {}   # page -> live slot references
            self._backed: set = set()   # pages inside an active reservation
            self._slot_reserved = [0] * self.slots
            self._reserved_total = 0
        # trie nodes each slot's current occupant registered (withdrawn if
        # that occupant faults)
        self._slot_reg_nodes: List[list] = [[] for _ in range(self.slots)]
        self._lanes = [_Slot() for _ in range(self.slots)]
        self._queue: deque = deque()
        self._pending: dict = {}     # slot -> in-progress admission
        self._cache = None           # built at the first beat
        self._state = None           # device scheduler state (device_sched)
        self._nan_dev = None         # the NaN-lane fault seam, (slots,) bool
        self._graph = None           # the captured decode block (CUDA)
        self._arrivals = 0
        self._chunks_since_block = 0
        self._deferred_head = None   # queue head counted as deferred
        self._held_head = None       # queue head counted as held

    def reset_stats(self) -> None:
        """Open a fresh stats window (``run()`` opens one per batch);
        ``lifetime`` and the serving state are untouched."""
        self.stats = {"admissions": 0, "mid_flight_admissions": 0,
                      "prefill_chunks": 0, "prefill_chunk_rows": 0,
                      "decode_steps": 0, "decode_blocks": 0,
                      "decode_tokens": 0, "decode_wall_s": 0.0,
                      "max_chunks_between_decode_blocks": 0,
                      "host_block_syncs": 0, "steady_state_blocks": 0,
                      "graph_captures": 0,
                      "scheduler_beats": 0, "idle_sleeps": 0,
                      "idle_wait_s": 0.0,
                      # robustness gauges, every mode
                      "requests_completed": 0, "requests_rejected": 0,
                      "requests_failed": 0, "requests_timed_out": 0,
                      "requests_cancelled": 0, "requests_degraded": 0,
                      "degraded_blocks": 0, "faults_injected": 0,
                      "watchdog_trips": 0, "sched_fallbacks": 0,
                      "integrity_faults": 0,
                      # recovery gauges, every mode
                      "requests_retried": 0, "retries_total": 0,
                      "retry_backoff_s": 0.0, "retries_denied_breaker": 0,
                      "repromotions": 0, "canary_probes": 0,
                      "breaker_state": self._dev_breaker.state,
                      "retry_breaker_state": self._retry_breaker.state}
        if self.paged:
            self.stats.update({"kv_pages_peak": 0, "kv_live_tokens_peak": 0,
                               "kv_reserved_pages_peak": 0,
                               "admissions_deferred_pages": 0,
                               # prefix sharing (zero when it is off)
                               "prefix_hits": 0, "prefill_tokens_skipped": 0,
                               "kv_pages_shared": 0,
                               "kv_pages_shared_peak": 0, "kv_cow_splits": 0,
                               "prefix_evictions": 0,
                               "admissions_held_for_prefix": 0})
        # the first block of a window is never counted as steady
        self._last_dispatch_epoch = None
        self._syncs_since_dispatch = 0
        self._steady_syncs = 0
        self._window_requests: List[Request] = []
        self._window_t0 = time.perf_counter()
        self._window_contrib: Optional[dict] = None
        fi = self.fault_injector
        self._fi_events0 = len(fi.events) if fi is not None else 0

    def submit(self, req: Request) -> Request:
        """Queue one request, at any time.  Here the request is validated
        (an invalid one is REJECTED and never queued), its seed defaults to
        a function of the engine seed and the engine-lifetime arrival count,
        and its TTFT and deadline clocks start.  Returns the request."""
        if self._closed:
            raise RuntimeError("submit() on a closed ServingEngine")
        now = time.perf_counter()
        req.seed = ((self.seed * 1000003 + self._arrivals)
                    if req.seed is None else int(req.seed)) % _SEED_MOD
        self._arrivals += 1
        self.lifetime["arrivals"] += 1
        req._arrival_t = now
        req._deadline_t0 = now
        self._window_requests.append(req)
        err = self._validate(req)
        if err is not None:
            self._end_unstarted(req, RequestStatus.REJECTED, err)
            return req
        self._queue.append(req)
        return req

    def cancel(self, req: Request) -> None:
        """Cancel a request at the next beat: queued or waiting to retry, it
        never runs (again); pending, its admission aborts; live, it keeps
        its tokens so far.  Status CANCELLED."""
        req.cancelled = True

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._pending or self._inflight
                    or self._retryq or any(s.active for s in self._lanes))

    def step(self) -> StepOutcome:
        """One scheduler beat: police (cancellations, deadlines) -> breaker
        ticks -> retry pump -> promotion probe -> admission wave -> decode
        block (device-resident: dispatch it, then read back the block
        before it)."""
        if not self.has_work:
            return StepOutcome(worked=False, remaining=0)
        with self._on_stream():
            return self._beat()

    def drain(self) -> dict:
        """Step until every submitted request is terminal, sleeping through
        pure retry backoff; returns the stats of the window.  The caller's
        stream then waits for the engine's."""
        while self.has_work:
            out = self.step()
            if out.idle_until is not None:
                wait = self._agreed_wait(out.idle_until - time.perf_counter())
                if wait > 0:
                    self.stats["idle_sleeps"] += 1
                    self.stats["idle_wait_s"] += wait
                    time.sleep(wait)
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self._finalize_window()
        return self.stats

    def close(self) -> None:
        """Drain, then refuse further ``submit()`` calls."""
        self.drain()
        self._closed = True

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a batch: a fresh stats window, submit all, drain.  A window
        that ended degraded starts the next one device-resident again."""
        self.reset_stats()
        self._restore_device_residency()
        fi = self.fault_injector
        if fi is not None:
            fi.reset_run()   # ordinals count from 0 in every run
        for r in requests:
            self.submit(r)
        self.drain()
        return requests

    @contextlib.contextmanager
    def _on_stream(self):
        """Run on the engine's stream (after whatever the caller queued on
        its own); on the CPU, as is."""
        if self._stream is None:
            yield
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            yield

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card through pinned
        memory, queued on the current stream without waiting for it."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _beat(self) -> StepOutcome:
        slots, pending, queue = self._lanes, self._pending, self._queue
        self._ensure_cache()
        self.stats["scheduler_beats"] += 1
        self._agree_clock(slots, pending, queue)
        self._police(slots, pending, queue)
        self._dev_breaker.tick()
        self._retry_breaker.tick()
        self._pump_retries(queue)
        if (self.device_sched and self.repromote and not self._dev_active
                and (queue or pending or any(s.active for s in slots))):
            self._try_promote(slots)
        self._admit(slots, pending, queue)
        if pending:
            others_active = any(s.active for s in slots)
            self._prefill_wave(pending, slots)
            if others_active:
                self._chunks_since_block += 1
                self.stats["max_chunks_between_decode_blocks"] = max(
                    self.stats["max_chunks_between_decode_blocks"],
                    self._chunks_since_block)
        if any(s.active for s in slots):
            # device-resident: a lane the host still sees active may have
            # finished on the device; its extra block ticks fully masked
            self._decode_block(slots)
            self._chunks_since_block = 0
            if self.on_block is not None:
                self.on_block(self, self.stats["decode_blocks"])
        elif self._inflight:
            self._drain_blocks(slots, depth=0)
        idle_until = None
        if (self._retryq and not queue and not pending and not self._inflight
                and not any(s.active for s in slots)):
            idle_until = min(e["not_before"] for e in self._retryq)
        remaining = (len(queue) + len(pending) + len(self._retryq)
                     + sum(1 for s in slots if s.active))
        return StepOutcome(worked=True, remaining=remaining,
                           idle_until=idle_until)

    def _ensure_cache(self) -> None:
        if self._cache is not None:
            return
        if self.paged:
            # the whole pool on every rank, written only for its own slots
            self._cache = transformer.init_paged_cache(
                self.cfg, self.kv_pages, self.page_size, self.cache_dtype,
                self.device, kv_quant=self.kv_quant)
            self._bt_dev = self._upload_mine(self._bt)
        else:
            self._cache = transformer.init_cache(
                self.cfg, self.slots_per_device, self.max_seq,
                self.cache_dtype, self.device, kv_quant=self.kv_quant)

        def z(dtype):
            return torch.zeros((self.slots_per_device,), dtype=dtype,
                               device=self.device)
        self._nan_dev = z(torch.bool)
        if self.device_sched:
            self._state = {"last_token": z(torch.int64),
                           "cache_len": z(torch.int32),
                           "emitted": z(torch.int32), "active": z(torch.bool),
                           "max_new": z(torch.int32),
                           "temps": z(torch.float32), "seeds": z(torch.int64)}

    # -- admission ---------------------------------------------------------

    def _validate(self, req: Request) -> Optional[str]:
        """The reason to reject ``req``, or None.  Checks the effective
        prompt (prompt plus carried tokens for a retry), shape first."""
        p = np.asarray(self._eff_prompt(req))
        if p.ndim != 1 or len(p) < 1:
            return "prompt must have at least one token (a 1-D token array)"
        if len(p) > self.max_seq:
            return f"prompt length {len(p)} > max_seq {self.max_seq}"
        if req.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        if self.cfg.frontend == "token" and (
                int(p.min()) < 0 or int(p.max()) >= self.cfg.vocab_size):
            return f"prompt token ids must be in [0, {self.cfg.vocab_size})"
        if self.paged and self.worst_case_pages(req) > self._pool.usable:
            return (f"request needs {self.worst_case_pages(req)} KV pages "
                    f"worst-case but the pool only has {self._pool.usable}; "
                    "raise kv_pages or shrink the request")
        return None

    def _admit(self, slots, pending: dict, queue) -> None:
        """Assign free slots to queued requests, FIFO; paged admission is
        gated by each request's worst-case reservation."""
        # padded lanes (past _usable_slots) are never assigned
        for i, s in enumerate(slots[:self._usable_slots]):
            if not queue:
                break
            if s.active or i in pending:
                continue
            # anything requeued internally is validated again here
            while queue:
                err = self._validate(queue[0])
                if err is None:
                    break
                self._end_unstarted(queue.popleft(),
                                    RequestStatus.REJECTED, err)
            if not queue:
                break
            head = queue[0]
            grant = None
            if self.paged:
                ns = self._slot_shard(i)
                if self._prefix is not None:
                    grant = self._prefix_lookup(self._eff_prompt(head), ns)
                if self._held_for_pending_prefix(
                        head, pending, grant["base"] if grant else 0, ns):
                    # a pending admission is prefilling this head's prefix:
                    # wait for it to register its pages (once per head)
                    if head is not self._held_head:
                        self.stats["admissions_held_for_prefix"] += 1
                        self._held_head = head
                    break
                # the reservation counts the pages this slot may allocate:
                # aliased pages exist already, a CoW copy does not
                reserve = self.worst_case_pages(head) - (
                    len(grant["pages"]) if grant else 0)
                # a grant turns index-only (evictable) pages into pinned
                # ones: the gate counts them like pages sharers keep alive
                newly_pinned = (sum(1 for p in grant["pages"]
                                    if p not in self._page_slot_refs)
                                if grant else 0)
                if (self._reserved_total + self._pinned_unreserved()
                        + newly_pinned + reserve > self._pool.usable):
                    if head is not self._deferred_head:   # once per head
                        self.stats["admissions_deferred_pages"] += 1
                        self._deferred_head = head
                    break   # page-starved: FIFO waits for lanes to retire
                self._slot_reserved[i] = reserve
                self._reserved_total += reserve
                self.stats["kv_reserved_pages_peak"] = max(
                    self.stats["kv_reserved_pages_peak"],
                    self._reserved_total)
                if grant is not None and grant["base"]:
                    try:
                        self._grant_prefix(i, grant)
                    except InjectedFault as e:
                        self._reject_started_head(
                            queue, i, "KV page allocation failed during "
                            f"prefix grant: {e}")
                        continue
            req = queue.popleft()
            pending[i] = self._start_admission(
                i, req, grant["base"] if grant else 0)
            if self.paged and self._dev_active:
                # the whole reservation now: decode never allocates, so
                # block N+1 needs nothing from the host allocator
                try:
                    self._grow_pages(i, min(len(req.prompt)
                                            + req.max_new_tokens - 1,
                                            self.max_seq))
                except InjectedFault as e:
                    self._abort_admission(
                        pending, i, RequestStatus.FAILED,
                        f"KV page allocation failed at admission pre-grant: "
                        f"{e}")
                    continue
            if any(o.active for o in slots):
                self.stats["mid_flight_admissions"] += 1

    def _start_admission(self, i: int, req: Request, base: int = 0) -> dict:
        """Prefill covers [base, plen) of the effective prompt: a shared
        prefix [0, base) is already in granted pages."""
        prompt = np.asarray(self._eff_prompt(req))
        plen = len(prompt)
        req.attempts += 1
        n_chunks = (-(-(plen - base) // self.prefill_chunk) if self._chunked
                    else 1)
        self.stats["prefill_chunk_rows"] += n_chunks
        return {"slot": i, "req": req, "prompt": prompt,
                "carried": self._carried(req), "plen": plen, "next": 0,
                "n_chunks": n_chunks, "base": base}

    def _prefill_wave(self, pending: dict, slots) -> None:
        """Advance every pending admission by one chunk in one batched
        ``prefill_chunk`` call; rows whose prompt ends in this chunk sample
        their first token on the device, at emit index = the tokens a
        retry carries (0 for a fresh request)."""
        self.stats["prefill_chunks"] += 1
        self._sched_epoch += 1
        if not self._chunked:
            self._prefill_whole(pending, slots)
            return
        n, c = self.slots, self.prefill_chunk
        toks = np.zeros((n, c), np.int64)
        offs = np.zeros((n,), np.int32)
        mask = np.zeros((n,), bool)
        last = np.zeros((n,), np.int64)
        seeds = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        emit0 = np.zeros((n,), np.int64)
        completing = []
        for i in list(pending):
            adm = pending[i]
            plen, req = adm["plen"], adm["req"]
            # a shifted final chunk never crosses below the share base
            # (base <= max_seq - c), so shared pages are never rewritten
            lo = min(adm["base"] + adm["next"] * c, self.max_seq - c)
            if self.paged:
                # cover the chunk's prompt span; its slack past the prompt
                # lands in the owned final page's tail or the null page.
                # A fault here aborts this admission only: its row stays
                # out of the wave.
                try:
                    self._grow_pages(i, min(lo + c, plen))
                except InjectedFault as e:
                    self._abort_admission(
                        pending, i, RequestStatus.FAILED,
                        f"KV page allocation failed during admission: {e}")
                    continue
            seg = adm["prompt"][lo:lo + c]
            toks[i, :len(seg)] = seg
            offs[i] = lo
            mask[i] = True
            last[i] = max(0, min(plen - 1 - lo, c - 1))
            seeds[i] = req.seed
            temps[i] = req.temperature
            emit0[i] = len(adm["carried"])
            adm["next"] += 1
            if adm["next"] >= adm["n_chunks"]:
                completing.append(i)
        if not mask.any():
            return   # every admission of this wave aborted
        up = self._upload_mine
        logits, _ = transformer.prefill_chunk(
            self.cfg, self.params, up(toks), self.ctx, self._cache,
            offsets=up(offs), admit_mask=up(mask), last_index=up(last),
            page_table=self._page_table())
        if not completing:
            return
        seeds_d, temps_d = up(seeds), up(temps)
        first = sample(logits, seeds_d, up(emit0), temps_d)
        if self._dev_active:
            # the first tokens go into the device state before the host
            # reads them: the read below is bookkeeping only
            self._merge_admissions([pending[i] for i in completing], first,
                                   seeds_d, temps_d)
        # every shard's first tokens (a sync only when an admission
        # completes)
        ft = self._gather_slots(first)[0].cpu().numpy()
        for i in completing:
            self._finish_admission(slots, pending.pop(i), int(ft[i]))

    def _prefill_whole(self, pending: dict, slots) -> None:
        """Whole-prompt admission (the recurrent kinds: a state cannot
        resume chunk to chunk), one admission a wave: ``prefill_step`` on a
        one-row cache of the prompt's length, then the adopt step copies
        that cache into the slot's rows (K/V rows [0, plen) and the whole
        state), and the first token is sampled at emit index = the tokens a
        retry carries.  A retry prefills its prompt plus those tokens."""
        i = next(iter(pending))
        adm = pending.pop(i)
        req, plen = adm["req"], adm["plen"]
        one = transformer.init_cache(self.cfg, 1, plen, self.cache_dtype,
                                     self.device)
        logits, one = transformer.prefill_step(
            self.cfg, self.params,
            self._upload(np.asarray(adm["prompt"], np.int64)[None]),
            self.ctx, one)
        _adopt(self._cache, one, i)
        k = len(adm["carried"])
        up = self._upload
        first = sample(logits, up(np.asarray([req.seed], np.int64)),
                       up(np.asarray([k], np.int64)),
                       up(np.asarray([req.temperature], np.float32)))
        if self._dev_active:
            n = self.slots
            seeds = np.zeros((n,), np.int64)
            temps = np.zeros((n,), np.float32)
            seeds[i], temps[i] = req.seed, req.temperature
            first_all = torch.zeros((n,), dtype=first.dtype,
                                    device=self.device)
            first_all[i] = first[0]
            self._merge_admissions([adm], first_all, up(seeds), up(temps))
        self._finish_admission(slots, adm, int(first.cpu()[0]))

    def _merge_admissions(self, admits, first, seeds, temps) -> None:
        """Fold completed admissions into the device state in place (this
        rank's rows; ``first``, ``seeds`` and ``temps`` are the wave's, on
        those rows).  A lane whose request finished at prefill (its budget
        reached or a full row) is merged inactive: a tick emits before it
        checks done.  A retry resumes at emit index carried + 1."""
        n = self.slots
        upd = np.zeros((n,), bool)
        activate = np.zeros((n,), bool)
        clens = np.zeros((n,), np.int32)
        emit0 = np.zeros((n,), np.int32)
        mnew = np.zeros((n,), np.int32)
        for adm in admits:
            i, req, plen = adm["slot"], adm["req"], adm["plen"]
            k = len(adm["carried"])
            upd[i] = True
            clens[i] = plen
            emit0[i] = k + 1
            mnew[i] = req.max_new_tokens
            activate[i] = not (req.max_new_tokens <= k + 1
                               or plen >= self.max_seq)
        up = self._upload_mine
        u = up(upd)
        st = self._state
        for name, new in (("last_token", first), ("cache_len", up(clens)),
                          ("emitted", up(emit0)), ("active", up(activate)),
                          ("max_new", up(mnew)), ("temps", temps),
                          ("seeds", seeds)):
            st[name].copy_(torch.where(u, new.to(st[name].dtype), st[name]))

    def _finish_admission(self, slots, adm: dict, tok: int) -> None:
        req, i = adm["req"], adm["slot"]
        if req.ttft_s is None:   # a retry keeps its first attempt's TTFT
            req.ttft_s = time.perf_counter() - req._arrival_t
        s = slots[i]
        s.request = req
        # a retry resumes mid-output: its carried tokens are committed
        s.tokens = list(adm["carried"]) + [tok]
        s.cache_len = adm["plen"]
        s.last_token = tok
        if self.on_token is not None:
            self.on_token(req, tok)   # the new token only
        self.stats["admissions"] += 1
        if self._prefix is not None:
            # the prompt's full pages are written: make them reusable
            # (before a retirement at prefill, so such a request seeds too)
            self._register_prefix(i, adm["prompt"], adm["plen"])
        if len(s.tokens) >= req.max_new_tokens or s.cache_len >= self.max_seq:
            self._free_slot(slots, i)   # finished at prefill

    # -- decode ------------------------------------------------------------

    def _ticks(self, tokens, cache_len, emitted, active, max_new, temps,
               seeds, nan_mask, gather: bool = True):
        """``decode_block`` ticks of decode_step + sample + bookkeeping over
        this rank's (slots_per_device,) tensors -> their values after the
        block, and every shard's (slots, decode_block) tokens and emit masks
        and (slots,) non-finite latch (gathered over 'data' under a mesh;
        this rank's alone without ``gather``).  Reads no host value: the
        device-resident block runs it inside a CUDA graph, its collectives
        included."""
        outs, masks = [], []
        bad = torch.zeros_like(active)
        for _ in range(self.decode_block):
            # park inactive lanes' write at max_seq (clamped to the row tail)
            step_len = torch.where(active, cache_len, self.max_seq)
            logits, _ = transformer.decode_step(
                self.cfg, self.params, tokens[:, None], self.ctx, self._cache,
                step_len, page_table=self._page_table())
            # the fault seam: all-False in service, an exact identity then
            logits = torch.where(nan_mask[:, None], float("nan"), logits)
            # the integrity latch: an active lane whose logits are not
            # finite on any tick of the block
            bad = bad | (active & ~torch.isfinite(logits).all(-1))
            nxt = sample(logits, seeds, emitted, temps)
            outs.append(torch.where(active, nxt, 0))
            masks.append(active)
            tokens = torch.where(active, nxt, tokens)
            cache_len = torch.where(active, cache_len + 1, cache_len)
            emitted = torch.where(active, emitted + 1, emitted)
            done = (emitted >= max_new) | (cache_len >= self.max_seq)
            active = active & ~done
        outs = (torch.stack(outs, 1), torch.stack(masks, 1), bad)
        return (tokens, cache_len, emitted, active,
                *(self._gather_slots(*outs) if gather else outs))

    def _device_block(self):
        """One block from the device state, which it advances in place;
        returns (tokens, masks, bad), this rank's alone on a staged (gloo)
        mesh on the card, whose gather runs after the block."""
        st = self._state
        *new, blk, mask, bad = self._ticks(
            st["last_token"], st["cache_len"], st["emitted"], st["active"],
            st["max_new"], st["temps"], st["seeds"], self._nan_dev,
            gather=not self._staged)
        for name, value in zip(("last_token", "cache_len", "emitted",
                                "active"), new):
            st[name].copy_(value)
        return blk, mask, bad

    def _note_dispatch(self) -> None:
        """Classify this dispatch for the sync counters: a block dispatched
        with no wave or retirement since the previous one is steady, and is
        charged the dispatch-gating readbacks of that interval."""
        steady = (self._last_dispatch_epoch is not None
                  and self._sched_epoch == self._last_dispatch_epoch)
        if steady:
            self.stats["steady_state_blocks"] += 1
            self._steady_syncs += self._syncs_since_dispatch
        self._syncs_since_dispatch = 0
        self._last_dispatch_epoch = self._sched_epoch

    def _nan_mask_for_block(self) -> Optional[np.ndarray]:
        """The injector's NaN lanes for the block about to dispatch (keyed
        on the window's block ordinal), or None."""
        fi = self.fault_injector
        if fi is None:
            return None
        return fi.nan_mask(self.stats["decode_blocks"] - 1, self.slots)

    def _decode_block(self, slots) -> None:
        st = self.stats
        if self.paged:
            if not self._dev_active:
                # cover every append this block can make, bounded by each
                # lane's remaining budget (so within its reservation);
                # device-resident lanes hold their reservation already.  A
                # fault retires the lane that hit it.
                for i, s in enumerate(slots):
                    if s.active:
                        remaining = s.request.max_new_tokens - len(s.tokens)
                        try:
                            self._grow_pages(i, min(s.cache_len + min(
                                self.decode_block, remaining), self.max_seq))
                        except InjectedFault as e:
                            self._fault_retire(
                                slots, i, RequestStatus.FAILED,
                                f"KV page growth failed mid-decode: {e}")
            self._note_live_tokens(
                sum(s.cache_len for s in slots if s.active))
        if not any(s.active for s in slots):
            return   # growth faults emptied the batch
        self._note_dispatch()
        st["decode_blocks"] += 1
        st["decode_steps"] += self.decode_block
        if self._degraded:
            st["degraded_blocks"] += 1
        nan = self._nan_mask_for_block()
        wd = (Watchdog(self.block_deadline_s)
              if self.block_deadline_s is not None else None)
        try:
            # the watchdog bounds the dispatch and the readback it waits on;
            # it only records
            with wd or contextlib.nullcontext():
                self._dispatch_block(slots, nan)
            if wd is not None and wd.fired:
                st["watchdog_trips"] += 1
                if self._dev_active:
                    self._degrade(slots)
        except InjectedFault as e:
            # a dispatch that still fails after its retries: the device
            # scheduler is wedged, so fall back to the host; host-driven
            # there is no lower level, so the live batch fails
            if self._dev_active:
                self._degrade(slots)
            else:
                for i, s in enumerate(slots):
                    if s.active:
                        self._fault_retire(
                            slots, i, RequestStatus.FAILED,
                            f"decode dispatch failed on host path: {e}")

    def _dispatch_block(self, slots, nan) -> None:
        """Issue one decode block behind the injector's dispatch seam, which
        fires before anything is launched or replayed, so ``with_retries``
        may re-issue it."""
        t0 = time.perf_counter()
        st, fi = self.stats, self.fault_injector
        if self._dev_active:
            gens = tuple(s.gen for s in slots)

            def dispatch():
                if fi is not None:
                    fi.on_dispatch(device=True)
                return self._dispatch_device_block(nan)

            self._inflight.append((*with_retries(
                dispatch, max_retries=self.dispatch_retries,
                retry_on=(InjectedFault,), backoff_s=self.dispatch_backoff_s,
                seed=self.seed)(), gens))
            st["decode_wall_s"] += time.perf_counter() - t0
            # read back one block behind: block N while block N+1 runs
            self._drain_blocks(slots, depth=1)
            return
        dev, reqs = self.device, [s.request for s in slots]
        lo, hi = self._lo, self._lo + self.slots_per_device

        def col(values, dtype):   # this rank's lanes
            return torch.tensor(values[lo:hi], dtype=dtype, device=dev)

        def dispatch():
            if fi is not None:
                fi.on_dispatch(device=False)
            return self._ticks(
                col([s.last_token for s in slots], torch.int64),
                col([s.cache_len for s in slots], torch.int32),
                col([len(s.tokens) for s in slots], torch.int32),
                col([s.active for s in slots], torch.bool),
                col([r.max_new_tokens if r else 0 for r in reqs], torch.int32),
                col([r.temperature if r else 0.0 for r in reqs],
                    torch.float32),
                col([r.seed if r else 0 for r in reqs], torch.int64),
                self._nan_dev if nan is None else self._upload_mine(nan))

        *_, blk, mask, bad = with_retries(
            dispatch, max_retries=self.dispatch_retries,
            retry_on=(InjectedFault,), backoff_s=self.dispatch_backoff_s,
            seed=self.seed)()
        # the block's one sync, which the next dispatch waits on
        self._process_block(slots, blk.cpu().numpy(), mask.cpu().numpy(),
                            bad.cpu().numpy(), gating=True)
        st["decode_wall_s"] += time.perf_counter() - t0

    def _dispatch_device_block(self, nan):
        """Queue one device-resident block and its readback; returns what
        ``_drain_blocks`` reads.  On the card the first block runs eagerly
        and is then captured; every later block is one graph replay.  A NaN
        lane mask goes into the buffer the block reads, before it, and is
        cleared after it, on the engine's stream."""
        if nan is not None:
            src = torch.from_numpy(self._mine(nan))
            self._nan_dev.copy_(src.pin_memory() if self._stream is not None
                                else src, non_blocking=True)
        staged = self._gather_slots if self._staged else (lambda *o: o)
        if self._graph is None:
            out = self._readback(*staged(*self._device_block()))
            if self._stream is not None:
                self._graph = graphs.CapturedBlock(
                    self._device_block, self._stream,
                    collectives=self.mesh is not None and not self._staged)
                self.stats["graph_captures"] += 1
        else:
            with torch.profiler.record_function("ServingEngine.replay_block"):
                out = self._readback(*staged(*self._graph.replay()))
        if nan is not None:
            self._nan_dev.zero_()
        return out

    def _readback(self, blk: torch.Tensor, mask: torch.Tensor,
                  bad: torch.Tensor):
        """Copy a block's outputs to the host.  On the card: into fresh
        pinned memory, queued on the engine's stream before the next replay
        overwrites the graph's outputs, with one event to wait on."""
        if self._stream is None:
            return blk, mask, bad, None
        out = []
        for t in (blk, mask, bad):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        ev = torch.cuda.Event()
        ev.record()
        return (*out, ev)

    def _drain_blocks(self, slots, depth: int) -> None:
        """Read back dispatched blocks until ``depth`` remain in flight."""
        t0 = time.perf_counter()
        while len(self._inflight) > depth:
            blk, mask, bad, ev, gens = self._inflight.popleft()
            if ev is not None:
                ev.synchronize()
            self._process_block(slots, blk.numpy(), mask.numpy(),
                                bad.numpy(), gating=False, gens=gens)
        self.stats["decode_wall_s"] += time.perf_counter() - t0

    def _process_block(self, slots, blk: np.ndarray, mask: np.ndarray,
                       bad: np.ndarray, *, gating: bool, gens=None) -> None:
        """Fold one block's readback into the host mirror: run the integrity
        guards, extend outputs, advance lengths, retire finished lanes.
        ``gating`` marks a readback the next dispatch waits on (every
        host-driven block); a device-resident readback gates only when it
        retires a lane.  ``gens`` are the lanes' occupancy counts when the
        block was dispatched: a lane retired since then is skipped.  A lane
        that fails a guard retires FAILED with the tokens it had before
        this block; every other lane is untouched."""
        fi = self.fault_injector
        if fi is not None:
            blk = fi.on_readback(blk, mask, bad_token=self.cfg.vocab_size + 7)
        st = self.stats
        retired = False
        live_after = 0
        for i, s in enumerate(slots):
            if not s.active or (gens is not None and gens[i] != s.gen):
                continue
            if bad[i]:
                st["integrity_faults"] += 1
                self._fault_retire(
                    slots, i, RequestStatus.FAILED,
                    "non-finite logits in decode block (lane isolated; the "
                    "block's tokens for this lane are discarded)",
                    rollback_prefix=True)
                retired = True
                continue
            new = blk[i][mask[i]]
            if new.size and (int(new.min()) < 0
                             or int(new.max()) >= self.cfg.vocab_size):
                st["integrity_faults"] += 1
                self._fault_retire(
                    slots, i, RequestStatus.FAILED,
                    "emitted token id out of range (corrupt readback; lane "
                    "isolated)", rollback_prefix=True)
                retired = True
                continue
            new = new.tolist()
            # only the tokens kept count: a stale, NaN or corrupt lane's
            # discarded ones are left out (JAX counts every masked token)
            st["decode_tokens"] += len(new)
            s.tokens.extend(new)
            s.cache_len += len(new)
            live_after += s.cache_len
            if new:
                s.last_token = new[-1]
                if self.on_token is not None:
                    for t in new:   # after the guards: never withdrawn
                        self.on_token(s.request, t)
            if (len(s.tokens) >= s.request.max_new_tokens
                    or s.cache_len >= self.max_seq):
                self._free_slot(slots, i)
                retired = True
        if self.paged:   # the entry sample misses the block's own appends
            self._note_live_tokens(live_after)
        if gating or retired:
            st["host_block_syncs"] += 1
            self._syncs_since_dispatch += 1
        # the parked-write contract: a lane that filled its row parks its
        # remaining ticks on its own last KV entry, which is only safe
        # because it retires here, before any later block reads that row
        if any(s.cache_len >= self.max_seq for s in slots if s.active):
            raise RuntimeError("active lane at cache_len >= max_seq: parked "
                               "decode writes could clobber a live token")

    # -- retirement --------------------------------------------------------

    def _free_slot(self, slots, i: int,
                   status: RequestStatus = RequestStatus.OK,
                   error: Optional[str] = None) -> None:
        """Retire slot i with ``status``: output, pages and reservation
        back.  An OK completion while degraded is stamped DEGRADED."""
        if status is RequestStatus.OK and self._degraded:
            status = RequestStatus.DEGRADED
            self.stats["requests_degraded"] += 1
        req = slots[i].request
        self._release_slot_pages(i)
        slots[i].free(status, error)
        if req.retries and status in (RequestStatus.OK,
                                      RequestStatus.DEGRADED):
            # a retried request completing: transient faults are clearing
            self._retry_breaker.record_success()

    def _fault_retire(self, slots, i: int, status: RequestStatus,
                      error: str, rollback_prefix: bool = False) -> None:
        """Retire live slot i on a containment event: the request keeps its
        tokens so far; device-resident, the lane is deactivated in the
        device state on the engine's stream (outside the graph, after the
        blocks already queued there).  ``rollback_prefix`` withdraws the
        prefix pages this occupant registered (faulted KV)."""
        if rollback_prefix:
            self._unregister_prefix(i)
        j = self._local(i)
        if self._dev_active and self._state is not None and j is not None:
            self._state["active"][j] = False
        req = slots[i].request
        self._free_slot(slots, i, status, error)
        self.stats[_STATUS_COUNTERS[status]] += 1
        self._maybe_retry(req)
        if self.audit_on_retire:
            self.audit()

    def _end_unstarted(self, req: Request, status: RequestStatus,
                       error: str) -> None:
        """Stamp a request that holds no lane terminal: it keeps only the
        tokens an earlier attempt carried."""
        req.output = np.asarray(self._carried(req), np.int32)
        req.done = True
        req.status = status
        req.error = error
        self.stats[_STATUS_COUNTERS[status]] += 1

    def _abort_admission(self, pending: dict, i: int, status: RequestStatus,
                         error: str) -> None:
        """Abort a pending admission: granted and owned pages and the
        reservation roll back, the slot is free again."""
        req = pending.pop(i)["req"]
        self._release_slot_pages(i)
        self._end_unstarted(req, status, error)
        self._maybe_retry(req)
        if self.audit_on_retire:
            self.audit()

    def _reject_started_head(self, queue, i: int, error: str) -> None:
        """A fault between reservation and admission (the CoW allocation
        of a prefix grant): the queue head fails, slot i's grant and
        reservation roll back."""
        req = queue.popleft()
        self._release_slot_pages(i)
        self._end_unstarted(req, RequestStatus.FAILED, error)
        self._maybe_retry(req)
        if self.audit_on_retire:
            self.audit()

    def _expired(self, req: Request, now: Optional[float] = None) -> bool:
        if req.deadline_s is None:
            return False
        if self._clock_flags is not None and now is None:
            return id(req) in self._clock_flags[0]   # agreed this beat
        # measured from submit(), or from a retry's requeue
        now = time.perf_counter() if now is None else now
        return now - req._deadline_t0 > req.deadline_s

    def _agree_clock(self, slots, pending: dict, queue) -> None:
        """On a world of more than one rank: read this rank's clock once for
        every deadline it holds (queued, pending, live requests) and every
        retry backoff, combine the flags of all ranks by one MAX
        all-reduce, and keep them for this beat's police sweep and retry
        pump (``_expired``, ``_pump_retries``).  Every rank holds the same
        requests in the same order, so the flags line up.  A retry queued
        during the beat waits for the next one."""
        if self._clock_group is None:
            return
        reqs = ([r for r in queue]
                + [pending[i]["req"] for i in sorted(pending)]
                + [s.request for s in slots if s.active])
        reqs = [r for r in reqs if r.deadline_s is not None]
        entries = list(self._retryq)
        self._clock_flags = (set(), set())
        if not reqs and not entries:
            return   # the same on every rank: nothing to agree on
        now = time.perf_counter()
        flags = torch.tensor(
            [self._expired(r, now) for r in reqs]
            + [e["not_before"] <= now for e in entries], dtype=torch.int32)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self._clock_group)
        f = flags.tolist()
        self._clock_flags = (
            {id(r) for r, x in zip(reqs, f) if x},
            {id(e["req"]) for e, x in zip(entries, f[len(reqs):]) if x})

    def _agreed_wait(self, wait: float) -> float:
        """The idle wait before a retry: this rank's, or on a world of more
        than one rank the least over ranks (a MAX all-reduce of its
        negation), so no rank sleeps past a backoff another rank's clock
        already saw elapse."""
        if self._clock_group is None:
            return wait
        t = torch.tensor([-wait], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._clock_group)
        return -float(t[0])

    def _police(self, slots, pending: dict, queue) -> None:
        """The cancellation and deadline sweep over the four pools: queued,
        waiting to retry, pending, live.  Host only; a live lane's
        deactivation is one element written on the engine's stream."""
        for r in list(queue):
            why = (RequestStatus.CANCELLED if r.cancelled else
                   RequestStatus.TIMEOUT if self._expired(r) else None)
            if why is not None:
                queue.remove(r)
                self._end_unstarted(
                    r, why, "cancelled before admission"
                    if why is RequestStatus.CANCELLED
                    else f"deadline_s={r.deadline_s} expired in queue")
                self._maybe_retry(r)
        for e in list(self._retryq):
            # a deadline restarts at the requeue; a cancellation is seen
            if e["req"].cancelled:
                self._retryq.remove(e)
                self._end_unstarted(e["req"], RequestStatus.CANCELLED,
                                    "cancelled while waiting to retry")
        for i in list(pending):
            r = pending[i]["req"]
            if r.cancelled:
                self._abort_admission(pending, i, RequestStatus.CANCELLED,
                                      "cancelled during admission")
            elif self._expired(r):
                self._abort_admission(
                    pending, i, RequestStatus.TIMEOUT,
                    f"deadline_s={r.deadline_s} expired during admission")
        for i, s in enumerate(slots):
            if not s.active:
                continue
            r = s.request
            if r.cancelled:
                self._fault_retire(slots, i, RequestStatus.CANCELLED,
                                   "cancelled mid-decode")
            elif self._expired(r):
                self._fault_retire(
                    slots, i, RequestStatus.TIMEOUT,
                    f"deadline_s={r.deadline_s} expired mid-decode")

    # -- retries with progress replay --------------------------------------

    @staticmethod
    def _carried(req: Request) -> list:
        """Tokens a withdrawn attempt committed (empty for a fresh one)."""
        return getattr(req, "_replay_tokens", None) or []

    @staticmethod
    def _eff_prompt(req: Request):
        """What the current attempt prefills: the prompt, or for a retry
        the prompt plus the tokens emitted so far, so its first sampled
        token continues the output.  The worst-case reservation is the
        same either way: eff_plen + remaining - 1 == plen + max_new - 1."""
        p = getattr(req, "_replay_prompt", None)
        return p if p is not None else req.prompt

    def _retry_budget(self, req: Request) -> int:
        return (int(req.max_retries) if req.max_retries is not None
                else self.max_retries)

    def _maybe_retry(self, req: Request) -> None:
        """Called right after ``req`` was stamped terminal.  A FAILED (or,
        with ``retry_timeouts``, TIMEOUT) request with budget left, while
        the retry breaker allows, has its stamp withdrawn and waits out a
        seeded exponential backoff, then re-enters the queue with its
        progress replayed (``_eff_prompt``)."""
        status = req.status
        if status not in (RequestStatus.FAILED, RequestStatus.TIMEOUT):
            return
        if status is RequestStatus.TIMEOUT and not self.retry_timeouts:
            return
        if self._retry_budget(req) <= 0:
            return
        # every retryable failure is breaker evidence, budget left or not
        self._retry_breaker.record_failure()
        if req.retries >= self._retry_budget(req):
            return
        st = self.stats
        if not self._retry_breaker.allow():
            st["retries_denied_breaker"] += 1
            return
        st[_STATUS_COUNTERS[status]] -= 1   # the stamp is withdrawn
        tokens = req.output.tolist() if req.output is not None else []
        req.retry_errors.append(
            f"attempt {req.attempts} [{status.value}]: {req.error}")
        req.done = False
        req.status = None
        req.error = None
        req.output = None
        req.retries += 1
        st["retries_total"] += 1
        req._replay_tokens = tokens
        req._replay_prompt = np.concatenate(
            [np.asarray(req.prompt, np.int32), np.asarray(tokens, np.int32)])
        delay = backoff_delay(self.retry_backoff_s, req.retries - 1,
                              seed=self.seed * 1000003 + req.seed)
        st["retry_backoff_s"] += delay
        now = time.perf_counter()
        req._deadline_t0 = now + delay   # the deadline is per attempt
        self._retryq.append({"req": req, "not_before": now + delay})

    def _pump_retries(self, queue) -> None:
        """Requests whose backoff elapsed join the queue's tail (on a world
        of more than one rank, as this beat's agreed flags say)."""
        if not self._retryq:
            return
        if self._clock_flags is not None:
            due = self._clock_flags[1]
            ready = [e for e in self._retryq if id(e["req"]) in due]
            self._retryq = [e for e in self._retryq
                            if id(e["req"]) not in due]
            queue.extend(e["req"] for e in ready)
            return
        now = time.perf_counter()
        ready = [e for e in self._retryq if e["not_before"] <= now]
        self._retryq = [e for e in self._retryq if e["not_before"] > now]
        queue.extend(e["req"] for e in ready)

    # -- degrade and re-promotion ------------------------------------------

    def _degrade(self, slots) -> None:
        """Fall back to host-driven scheduling: drain every block in flight
        (the host mirror is then exact) and stop dispatching from the device
        state.  The state tensors and the captured block stay: promotion
        writes the mirror back into them."""
        self.stats["sched_fallbacks"] += 1
        self._drain_blocks(slots, depth=0)
        self._degraded = True
        self._dev_active = False
        self._sched_epoch += 1
        # trips the device breaker (threshold 1): promotion waits out the
        # probe cooldown, then a half-open canary
        self._dev_breaker.record_failure()

    def _canary_probe(self) -> bool:
        """A small op on the engine's stream, waited for, behind the same
        seams as a block (the injector's dispatch hook, the watchdog) but
        never the captured block, whose state a failing probe must not
        touch.  True when the device answered in time."""
        self.stats["canary_probes"] += 1
        fi = self.fault_injector

        def probe():
            if fi is not None:
                fi.on_dispatch(device=True)
            x = torch.arange(8, dtype=torch.int32, device=self.device)
            return int((x * 2 + 1).sum())   # waits for the device

        wd = (Watchdog(self.block_deadline_s)
              if self.block_deadline_s is not None else None)
        try:
            with wd or contextlib.nullcontext():
                probe()
            if wd is not None and wd.fired:
                self.stats["watchdog_trips"] += 1
                return False
        except InjectedFault:
            return False
        return True

    def _try_promote(self, slots) -> None:
        """The device breaker's half-open trial: a canary, then promotion
        on success or a re-opened breaker with a doubled cooldown."""
        br = self._dev_breaker
        if not br.allow():
            return
        if self._canary_probe():
            br.record_success()
            self._promote(slots)
        else:
            br.record_failure()

    def _promote(self, slots) -> None:
        """Hand scheduling back to the device mid-run: top live paged lanes
        and pending admissions up to their whole reservation
        (device-resident decode never allocates), write the host mirror
        into the state tensors in place (the captured block reads them at
        their addresses), and restart the steady-state sync gauge.  The
        device block table follows every host row change in both modes, so
        it is exact already."""
        st = self.stats
        if self.paged:
            for i, s in enumerate(slots):
                if not s.active:
                    continue
                upto = min(s.cache_len + (s.request.max_new_tokens
                                          - len(s.tokens)), self.max_seq)
                try:
                    self._grow_pages(i, upto)
                except InjectedFault as e:
                    self._fault_retire(
                        slots, i, RequestStatus.FAILED,
                        f"KV page allocation failed at re-promotion: {e}")
            # an admission started host-driven holds only the pages its
            # chunks have covered: once it completes, device-resident
            # decode would write past them, into the null page, and read
            # that back (the JAX engine's promotion misses these too)
            for i, adm in list(self._pending.items()):
                req = adm["req"]
                try:
                    self._grow_pages(i, min(len(req.prompt)
                                            + req.max_new_tokens - 1,
                                            self.max_seq))
                except InjectedFault as e:
                    self._abort_admission(
                        self._pending, i, RequestStatus.FAILED,
                        f"KV page allocation failed at re-promotion: {e}")
        reqs = [s.request for s in slots]
        host = {"last_token": ([s.last_token for s in slots], np.int64),
                "cache_len": ([s.cache_len for s in slots], np.int32),
                "emitted": ([len(s.tokens) for s in slots], np.int32),
                "active": ([s.active for s in slots], bool),
                "max_new": ([r.max_new_tokens if r else 0 for r in reqs],
                            np.int32),
                "temps": ([r.temperature if r else 0.0 for r in reqs],
                          np.float32),
                "seeds": ([r.seed if r else 0 for r in reqs], np.int64)}
        for name, (values, dtype) in host.items():
            self._state[name].copy_(
                self._upload_mine(np.asarray(values, dtype)))
        self._dev_active = True
        self._degraded = False
        self._sched_epoch += 1
        st["repromotions"] += 1
        st["steady_state_blocks"] = 0
        self._steady_syncs = 0
        self._last_dispatch_epoch = None
        if self.audit_on_retire:
            self.audit()

    def _restore_device_residency(self) -> None:
        """At a window boundary after a degraded window, with nothing live,
        pending or in flight, a zeroed device state is exact: return to
        device-resident scheduling without a canary.  The device breaker
        keeps its cooldown."""
        if not self.device_sched or self._dev_active:
            return
        if (self._pending or self._inflight
                or any(s.active for s in self._lanes)):
            return
        if self._state is not None:
            with self._on_stream():
                for t in self._state.values():
                    t.zero_()
        self._dev_active = True
        self._degraded = False
        self._sched_epoch += 1

    # -- paged KV (host side) ----------------------------------------------

    def worst_case_pages(self, req: Request) -> int:
        """Pages the request can ever need, its admission reservation: the
        row holds at most min(prompt + max_new - 1, max_seq) KV entries (the
        last emitted token's KV is never written)."""
        if not self.paged:
            raise ValueError("worst_case_pages is only meaningful on a paged "
                             "engine (paged=True)")
        total = min(len(req.prompt) + req.max_new_tokens - 1, self.max_seq)
        return -(-total // self.page_size)

    def _page_table(self) -> Optional[torch.Tensor]:
        return self._bt_dev if self.paged else None

    def _alloc_pages(self, n: int) -> List[int]:
        """Pool allocation; when the free list is short, least recently
        used cached prefixes are evicted first (the admission gate makes
        this always succeed).  The injector's allocation seam fires before
        anything changes, so a fault rolls back from a consistent pool."""
        if self.fault_injector is not None:
            self.fault_injector.on_alloc()
        if self._prefix is not None:
            while self._pool.free_pages < n and self._evict_one_prefix():
                pass
        out = self._pool.alloc(n)
        self.stats["kv_pages_peak"] = max(self.stats["kv_pages_peak"],
                                          self._pool.used_pages)
        return out

    def _own_page(self, i: int, pid: int, j: int) -> None:
        """Install a fresh page (refcount 1: the slot's writable frontier)
        at table column j of slot i; the caller pushes the row."""
        self._bt[i, j] = pid
        self._slot_pages[i].append(pid)
        self._page_slot_refs[pid] = self._page_slot_refs.get(pid, 0) + 1
        self._backed.add(pid)

    def _grow_pages(self, i: int, upto_tokens: int) -> None:
        """Extend slot i's pages to cover flat positions [0, upto_tokens);
        granted pages count toward the coverage."""
        pages = self._slot_pages[i]
        need = -(-upto_tokens // self.page_size)
        if need <= len(pages):
            return
        for j, pid in enumerate(self._alloc_pages(need - len(pages)),
                                start=len(pages)):
            self._own_page(i, pid, j)
        self._push_bt_row(i)

    def _pinned_unreserved(self) -> int:
        """Pages slots still read that no active reservation covers (their
        allocating slot retired while sharers read on)."""
        return sum(1 for p in self._page_slot_refs if p not in self._backed)

    def _release_slot_pages(self, i: int) -> None:
        """Every retirement's bookkeeping: a scheduler event; paged, drop
        slot i's page references (shared pages live on while the index or
        other slots read them), return its reservation and zero its table
        row, so a later write of the dead lane lands in the null page."""
        self._sched_epoch += 1
        self._slot_reg_nodes[i] = []   # registrations outlive the slot
        if not self.paged:
            return
        pages, self._slot_pages[i] = self._slot_pages[i], []
        shared_n, self._slot_shared_n[i] = self._slot_shared_n[i], 0
        self._reserved_total -= self._slot_reserved[i]
        self._slot_reserved[i] = 0
        self._bt[i, :] = 0
        self._push_bt_row(i)
        for j, p in enumerate(pages):
            if j >= shared_n:
                self._backed.discard(p)
            self._page_slot_refs[p] -= 1
            if not self._page_slot_refs[p]:
                del self._page_slot_refs[p]
            self._pool.decref(p)

    def _push_bt_row(self, i: int) -> None:
        """Copy slot i's table row to the device table, on the current
        stream (the engine's), in order with waves and blocks, on the rank
        that holds slot i.  Before the first beat the whole table is
        uploaded with the cache."""
        j = self._local(i)
        if self._bt_dev is not None and j is not None:
            self._bt_dev[j].copy_(self._upload(self._bt[i]))

    def _note_live_tokens(self, live: int) -> None:
        self.stats["kv_live_tokens_peak"] = max(
            self.stats["kv_live_tokens_peak"], live)

    def audit(self) -> dict:
        """Check the page pool, prefix trie and block tables and return a
        summary; raise ``AuditError`` at the first violation.  Every page
        is free or referenced, never both (no leak, no double free), the
        null page never enters the allocator or a slot, each slot's table
        row mirrors its page list, and the pool's refcounts equal the slot
        plus trie references recounted from scratch.  Host state only."""
        if not self.paged:
            return {"ok": True, "paged": False}
        pool = self._pool

        def fail(msg):
            raise AuditError(f"serving audit failed: {msg}")

        free, live = pool._free, pool._refs
        if len(set(free)) != len(free):
            fail("duplicate entries in the free list (double free)")
        if 0 in live or 0 in free:
            fail("null page entered the allocator")
        if set(free) & set(live):
            fail("page both free and referenced")
        if set(free) | set(live) != set(range(1, pool.num_pages)):
            fail("pages leaked: neither free nor referenced")
        if any(c < 1 for c in live.values()):
            fail("nonpositive refcount on a live page")
        expected: dict = {}
        for i, pages in enumerate(self._slot_pages):
            row = self._bt[i]
            for j, p in enumerate(pages):
                if p == 0:
                    fail(f"slot {i} owns the null page")
                if int(row[j]) != p:
                    fail(f"block-table row {i} diverged from the slot's "
                         f"page list at column {j}")
                expected[p] = expected.get(p, 0) + 1
            if any(int(x) != 0 for x in row[len(pages):]):
                fail(f"block-table row {i} has live entries past the "
                     "slot's page list")
        if expected != self._page_slot_refs:
            fail("slot page-reference map diverged from the block tables")
        n_index = 0
        if self._prefix is not None:
            stack = [self._prefix.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node.page is not None:
                    n_index += 1
                    if node.page == 0:
                        fail("null page registered in the prefix index")
                    expected[node.page] = expected.get(node.page, 0) + 1
            if n_index != self._prefix.n_pages:
                fail("prefix-index page count diverged from its nodes")
        if expected != live:
            fail("pool refcounts diverged from the block-table + "
                 "prefix-index oracle")
        if sum(self._slot_reserved) != self._reserved_total:
            fail("reservation sum diverged from per-slot reservations")
        if not self._backed <= set(live):
            fail("reservation-backed page is not referenced")
        return {"ok": True, "paged": True, "used_pages": pool.used_pages,
                "free_pages": pool.free_pages,
                "shared_pages": pool.shared_pages, "index_pages": n_index}

    # -- prefix sharing (host side) ----------------------------------------

    def _prefix_lookup(self, prompt, ns: int = 0) -> dict:
        """The longest cached prefix of ``prompt`` (the effective prompt:
        a retry's replay may find the pages its failed attempt registered)
        at the engine's sharing granularity.  The share base is a
        ``prefill_chunk`` multiple (the sharer's chunk schedule is the plain
        engine's, so its tokens are too), at most ``max_seq -
        prefill_chunk`` (a shifted final chunk never rewrites a shared
        position) and at most ``plen - 1`` (the last prompt token runs
        through prefill for its logits).  Returns the full pages to alias
        and, for a base inside a page, the page to copy.  ``ns`` is the
        slot's sharing namespace (``_slot_shard``)."""
        chain, boundary, blcp = self._prefix.lookup(prompt, ns)
        ps, c = self.page_size, self.prefill_chunk
        base = min(len(chain) * ps + blcp, len(prompt) - 1, self.max_seq - c)
        base -= base % c
        n_full, cow = divmod(base, ps)
        cow_src = None
        if cow:
            cow_src = (chain[n_full].page if n_full < len(chain)
                       else boundary.page)
        return {"base": base, "pages": [n.page for n in chain[:n_full]],
                "cow_src": cow_src}

    def _held_for_pending_prefix(self, req: Request, pending: dict,
                                 have: int, ns: int = 0) -> bool:
        """Whether the head shares more full pages with a pending
        admission's prompt than the index grants now (``have``): then it
        waits for that donor to register its pages rather than prefill the
        prefix twice.  Donors finish in finitely many waves.  Only donors
        of the same data shard (``ns``) count: another shard's pages could
        never be granted here."""
        if self._prefix is None or not pending:
            return False
        prompt = np.asarray(self._eff_prompt(req))
        ps, c = self.page_size, self.prefill_chunk
        for adm in pending.values():
            if self._slot_shard(adm["slot"]) != ns:
                continue
            donor = adm["prompt"]
            lcp = 0
            for a, b in zip(donor, prompt):
                if int(a) != int(b):
                    break
                lcp += 1
            # the donor will index floor(plen / ps) full pages; the clamps
            # are _prefix_lookup's
            pot = min((lcp // ps) * ps, (len(donor) // ps) * ps,
                      len(prompt) - 1, self.max_seq - c)
            pot -= pot % c
            if pot >= ps and pot > have:
                return True
        return False

    def _grant_prefix(self, i: int, grant: dict) -> None:
        """Alias the granted pages into slot i's table (one reference each)
        and, for a base inside a page, allocate and fill a private copy of
        the boundary page.  Aliased pages are referenced before anything is
        allocated, so eviction cannot reclaim them in between."""
        st = self.stats
        for j, p in enumerate(grant["pages"]):
            self._pool.incref(p)
            self._page_slot_refs[p] = self._page_slot_refs.get(p, 0) + 1
            self._slot_pages[i].append(p)
            self._bt[i, j] = p
        self._slot_shared_n[i] = len(grant["pages"])
        if grant["cow_src"] is not None:
            # pinned across the allocation and the copy: an index-only
            # source could be evicted and handed straight back as dst
            src = grant["cow_src"]
            self._pool.incref(src)
            try:
                (dst,) = self._alloc_pages(1)
                self._own_page(i, dst, len(grant["pages"]))
                if self._local(i) is not None:   # the owning shard's pool
                    transformer.copy_paged_page(self._cache, src, dst)
            finally:
                self._pool.decref(src)
            st["kv_cow_splits"] += 1
        self._push_bt_row(i)
        st["prefix_hits"] += 1
        st["prefill_tokens_skipped"] += grant["base"]
        st["kv_pages_shared"] += len(grant["pages"])
        st["kv_pages_shared_peak"] = max(st["kv_pages_shared_peak"],
                                         self._pool.shared_pages)

    def _register_prefix(self, i: int, prompt, plen: int) -> None:
        """Index slot i's fully written prompt pages; each new node takes a
        pool reference, so the cached prefix outlives the slot.  The new
        nodes are remembered, so a fault of this occupant can withdraw
        exactly them."""
        m = plen // self.page_size
        if not m:
            return
        new = self._prefix.insert(prompt, self._slot_pages[i][:m],
                                  ns=self._slot_shard(i))
        for node in new:
            self._pool.incref(node.page)
        self._slot_reg_nodes[i] = new

    def _unregister_prefix(self, i: int) -> None:
        """Withdraw the trie nodes slot i's occupant registered, deepest
        first.  A node another prompt has since extended stays (its page
        was fully written before the fault); every leaf this slot added
        drops its index reference."""
        if self._prefix is None:
            return
        nodes, self._slot_reg_nodes[i] = self._slot_reg_nodes[i], []
        for node in reversed(nodes):
            if node.children or node.parent.children.get(node.key) is not node:
                continue   # extended, or already evicted
            del node.parent.children[node.key]
            self._prefix.n_pages -= 1
            self._pool.decref(node.page)

    def _evict_one_prefix(self) -> bool:
        page = self._prefix.evict_coldest(
            lambda p: self._pool.refcount(p) == 1, force=True)
        if page is None:
            return False
        self._pool.decref(page)   # frees it iff the index read it alone
        self.stats["prefix_evictions"] += 1
        return True

    # -- stats -------------------------------------------------------------

    def _finalize_window(self) -> None:
        """Close the window over the requests submitted since
        ``reset_stats()``: wall clock, throughput, TTFT, the status counters
        recounted from the requests (a retried request counts once, under
        its final status), pool gauges; then fold the window into
        ``lifetime`` once (finalizing again replaces its contribution)."""
        reqs = self._window_requests
        st = self.stats
        wall = time.perf_counter() - self._window_t0
        total = sum(len(r.output) for r in reqs if r.output is not None)
        ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
        counts = {s: 0 for s in RequestStatus}
        for r in reqs:
            if r.status is not None:
                counts[r.status] += 1
        for status, key in _STATUS_COUNTERS.items():
            st[key] = counts[status]
        st["requests_retried"] = sum(1 for r in reqs if r.retries)
        st["retries_total"] = sum(r.retries for r in reqs)
        st["breaker_state"] = self._dev_breaker.state
        st["retry_breaker_state"] = self._retry_breaker.state
        fi = self.fault_injector
        if fi is not None:
            st["faults_injected"] = max(0, len(fi.events) - self._fi_events0)
        st.update({
            "wall_s": wall,
            "total_new_tokens": total,
            "tokens_per_s": total / wall if wall > 0 else float("inf"),
            "decode_tok_s": (st["decode_tokens"] / st["decode_wall_s"]
                             if st["decode_wall_s"] > 0 else float("inf")),
            "ttft_s": ttfts,
            "ttft_p50_s": float(np.percentile(ttfts, 50)) if ttfts else None,
            "ttft_p95_s": float(np.percentile(ttfts, 95)) if ttfts else None,
            # dispatch-gating readbacks charged to steady blocks: 1.0
            # host-driven, 0.0 device-resident
            "steady_state_syncs_per_block": (
                self._steady_syncs / st["steady_state_blocks"]
                if st["steady_state_blocks"] else 0.0),
            "host_syncs_per_block": (
                st["host_block_syncs"] / st["decode_blocks"]
                if st["decode_blocks"] else 0.0),
        })
        if self.paged:
            st.update({
                "kv_page_size": self.page_size,
                "kv_pool_pages": self._pool.usable,
                # after a drain only the prefix cache holds pages
                "kv_pages_in_use": self._pool.used_pages,
                "kv_prefix_cached_pages": (self._prefix.n_pages
                                           if self._prefix else 0),
                "prefix_hit_rate": (st["prefix_hits"] / st["admissions"]
                                    if st["admissions"] else 0.0),
            })
        contrib = {"windows": 1, "total_new_tokens": total}
        for key in (*_STATUS_COUNTERS.values(), "faults_injected",
                    "admissions", "decode_blocks", "decode_tokens",
                    "requests_retried", "retries_total", "graph_captures"):
            contrib[key] = st[key]
        prev = self._window_contrib or {}
        for k, v in contrib.items():
            self.lifetime[k] += v - prev.get(k, 0)
        self._window_contrib = contrib
