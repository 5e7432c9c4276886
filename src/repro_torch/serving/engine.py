"""Continuous-batching serving engine: chunked in-place admission waves
interleaved with multi-tick decode blocks, on a contiguous or a paged KV
cache, in bf16/f32 or int8, scheduled on the device or by the host.

Counterpart of the core of ``repro/serving/engine.py``:

  * **chunked admission waves** — every pending admission advances by one
    ``prefill_chunk``-token chunk per wave, all rows in one
    ``transformer.prefill_chunk`` call that writes each chunk's KV in place
    at its row's offset (rows of decoding or idle lanes are masked).  A
    final chunk that would run past the cache row is shifted back to end at
    ``max_seq``; its leading overlap rewrites positions the previous chunk
    already wrote, with the same tokens at the same positions.  Rows whose
    prompt ends in the wave sample their first token on the device.
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
    by row on the engine's stream.  Paged serving emits the contiguous
    engine's tokens exactly: its kernels walk keys in the contiguous
    kernels' order.
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
it gets.  It does not reproduce JAX's threefry draws.

Left out of this engine: fault handling and retries, deadlines and
cancellation, streaming callbacks, and the mesh.  An invalid request — one
whose worst-case KV pages exceed the pool among them — raises
``ValueError`` at ``submit()`` (the JAX engine stamps it REJECTED).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import graphs

_SEED_MOD = 2 ** 31 - 1


@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray              # (prompt_len,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy
    seed: Optional[int] = None      # sampling seed; the engine assigns one
    # filled by the engine:
    output: Optional[np.ndarray] = None
    ttft_s: Optional[float] = None  # submit() to first token
    done: bool = False


class _Slot:
    """Host-side state of one decode lane of the shared cache."""

    __slots__ = ("request", "tokens", "cache_len", "last_token")

    def __init__(self):
        self.request: Optional[Request] = None
        self.tokens: List[int] = []
        self.cache_len = 0
        self.last_token = 0

    @property
    def active(self) -> bool:
        return self.request is not None

    def free(self) -> None:
        r = self.request
        r.output = np.asarray(self.tokens, np.int32)
        r.done = True
        self.request = None
        self.tokens = []
        self.cache_len = 0
        self.last_token = 0


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
    engine's, with one sharing namespace).  Each node is a fully written
    prompt page; partial trailing pages are never indexed, which also keeps
    decode appends and parked writes out of every indexed page.  Eviction
    removes least recently used leaves, so a cached prefix goes tail
    first."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _PrefixNode(None, None, None)
        self._clock = 0
        self.n_pages = 0   # live nodes == pages the index references

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt) -> tuple:
        """Longest cached prefix of ``prompt``: the chain of matched
        full-page nodes and, where the next page diverges inside the page,
        the child sharing most leading tokens with it and that count (the
        copy-on-write donor).  Touches the matched nodes."""
        ps = self.page_size
        now = self._tick()
        node, chain = self.root, []
        n_full = len(prompt) // ps
        while len(chain) < n_full:
            j = len(chain)
            key = tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            chain.append(child)
            node = child
        rest = [int(t) for t in prompt[len(chain) * ps:]]
        boundary, blcp = None, 0
        for key, child in node.children.items():
            lcp = 0
            for a, b in zip(key, rest):
                if a != b:
                    break
                lcp += 1
            if lcp > blcp:
                boundary, blcp = child, lcp
        if boundary is not None:
            boundary.last_use = now
        return chain, boundary, blcp

    def insert(self, prompt, pages) -> list:
        """Index ``pages[j]`` as the KV of prompt page j; returns the new
        nodes (the caller takes one pool reference for each).  A page whose
        tokens are already cached keeps the first registrant's page."""
        ps = self.page_size
        now = self._tick()
        node, new = self.root, []
        for j in range(len(pages)):
            key = tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
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


class ServingEngine:
    """Token-level continuous batching over ``batch_slots`` lanes of up to
    ``max_seq`` positions.  ``params`` are packed parameters
    (``transformer.pack_params`` or ``convert.from_jax_packed``) on
    ``device``; the engine runs on the card unless ``device="cpu"``.

    ``device_sched`` (default True) keeps the scheduler state on the device
    and, on a CUDA device, replays each decode block as one captured CUDA
    graph; ``device_sched=False`` is the host-driven loop.  ``paged=True``
    keeps KV in a pool of ``kv_pages`` pages of ``page_size`` tokens
    (default: every slot can reach ``max_seq``, plus the null page), with
    prefix sharing under ``enable_prefix_sharing``; ``kv_quant=True``
    stores int8 KV with f32 scales."""

    def __init__(self, cfg: ModelConfig, params: nn.ModuleDict, *,
                 max_seq: int, batch_slots: int = 4,
                 ctx: Optional[Ctx] = None, seed: int = 0,
                 prefill_chunk: int = 32, decode_block: int = 8,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 paged: bool = False, page_size: int = 16,
                 kv_pages: Optional[int] = None,
                 enable_prefix_sharing: bool = False,
                 device_sched: bool = True, kv_quant: bool = False,
                 device: str | torch.device = "cuda"):
        transformer.require_attn(cfg)
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
        self.decode_block = max(1, decode_block)
        self.cache_dtype = cache_dtype
        self.kv_quant = bool(kv_quant)
        self.device_sched = bool(device_sched)
        self.paged = bool(paged)
        self.enable_prefix_sharing = bool(enable_prefix_sharing)
        self._prefix = None
        if self.paged:
            self.page_size = max(1, min(int(page_size), max_seq))
            self.pages_per_slot = -(-max_seq // self.page_size)
            self.kv_pages = (int(kv_pages) if kv_pages is not None
                             else batch_slots * self.pages_per_slot + 1)
            self._pool = _PagePool(self.kv_pages)
            if self.enable_prefix_sharing:
                self._prefix = _PrefixIndex(self.page_size)
            # host block table (its device copy is built with the cache);
            # dead entries: page 0
            self._bt = np.zeros((batch_slots, self.pages_per_slot), np.int32)
            self._bt_dev = None
            self._slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
            self._slot_shared_n = [0] * batch_slots   # aliased leading pages
            self._page_slot_refs: dict = {}   # page -> live slot references
            self._backed: set = set()   # pages inside an active reservation
            self._slot_reserved = [0] * batch_slots
            self._reserved_total = 0
        self.ctx = ctx or Ctx()
        self.seed = seed
        # the engine's own stream on the card: waves, table copies, block
        # replays and readbacks keep one order on it
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._lanes = [_Slot() for _ in range(batch_slots)]
        self._queue: deque = deque()
        self._pending: dict = {}     # slot -> in-progress admission
        self._cache = None           # built at the first beat
        self._state = None           # device scheduler state (device_sched)
        self._graph = None           # the captured decode block (CUDA)
        self._inflight: deque = deque()   # dispatched, not yet read back
        self._sched_epoch = 0   # bumps on every wave and retirement
        self._arrivals = 0
        self._chunks_since_block = 0
        self._deferred_head = None   # queue head counted as deferred
        self._held_head = None       # queue head counted as held
        self.reset_stats()

    # -- lifecycle ---------------------------------------------------------

    def reset_stats(self) -> None:
        """Open a fresh stats window (``run()`` opens one per batch)."""
        self.stats = {"admissions": 0, "mid_flight_admissions": 0,
                      "prefill_chunks": 0, "prefill_chunk_rows": 0,
                      "decode_steps": 0, "decode_blocks": 0,
                      "decode_tokens": 0, "decode_wall_s": 0.0,
                      "max_chunks_between_decode_blocks": 0,
                      "host_block_syncs": 0, "steady_state_blocks": 0}
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

    def _validate(self, req: Request) -> Optional[str]:
        p = np.asarray(req.prompt)
        if p.ndim != 1 or len(p) < 1:
            return "prompt must be a non-empty 1-D token array"
        if len(p) > self.max_seq:
            return f"prompt length {len(p)} > max_seq {self.max_seq}"
        if req.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        if int(p.min()) < 0 or int(p.max()) >= self.cfg.vocab_size:
            return f"prompt token ids must be in [0, {self.cfg.vocab_size})"
        if self.paged and self.worst_case_pages(req) > self._pool.usable:
            return (f"request needs {self.worst_case_pages(req)} KV pages "
                    f"worst-case but the pool only has {self._pool.usable}; "
                    "raise kv_pages or shrink the request")
        return None

    def submit(self, req: Request) -> Request:
        """Queue one request (validated here; the seed defaults to a function
        of the engine seed and the arrival count; TTFT counts from here)."""
        err = self._validate(req)
        if err is not None:
            raise ValueError(err)
        req.seed = ((self.seed * 1000003 + self._arrivals)
                    if req.seed is None else int(req.seed)) % _SEED_MOD
        self._arrivals += 1
        req._arrival_t = time.perf_counter()
        self._window_requests.append(req)
        self._queue.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._pending or self._inflight
                    or any(s.active for s in self._lanes))

    def step(self) -> bool:
        """One scheduler beat: assign free slots to queued requests, run one
        admission wave, then one decode block (device-resident: dispatch it,
        then read back the block before it).  Returns whether there was
        work."""
        if not self.has_work:
            return False
        with self._on_stream():
            self._beat()
        return True

    def drain(self) -> dict:
        """Step until every submitted request is done; returns the stats of
        the window.  The caller's stream then waits for the engine's."""
        while self.step():
            pass
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self._finalize_window()
        return self.stats

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a batch: a fresh stats window, submit all, drain."""
        self.reset_stats()
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

    def _beat(self) -> None:
        slots, pending, queue = self._lanes, self._pending, self._queue
        self._ensure_cache()
        for i, s in enumerate(slots):
            if not queue:
                break
            if s.active or i in pending:
                continue
            head = queue[0]
            grant = None
            if self.paged:
                if self._prefix is not None:
                    grant = self._prefix_lookup(head.prompt)
                if self._held_for_pending_prefix(
                        head, pending, grant["base"] if grant else 0):
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
                    self._grant_prefix(i, grant)
            req = queue.popleft()
            pending[i] = self._start_admission(
                i, req, grant["base"] if grant else 0)
            if self.paged and self.device_sched:
                # the whole reservation now: decode never allocates, so
                # block N+1 needs nothing from the host allocator
                self._grow_pages(i, min(len(req.prompt)
                                        + req.max_new_tokens - 1,
                                        self.max_seq))
            if any(o.active for o in slots):
                self.stats["mid_flight_admissions"] += 1
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
        elif self._inflight:
            self._drain_blocks(slots, depth=0)

    def _ensure_cache(self) -> None:
        if self._cache is not None:
            return
        if self.paged:
            self._cache = transformer.init_paged_cache(
                self.cfg, self.kv_pages, self.page_size, self.cache_dtype,
                self.device, kv_quant=self.kv_quant)
            self._bt_dev = self._upload(self._bt.copy())
        else:
            self._cache = transformer.init_cache(
                self.cfg, self.slots, self.max_seq, self.cache_dtype,
                self.device, kv_quant=self.kv_quant)
        if self.device_sched:
            def z(dtype):
                return torch.zeros((self.slots,), dtype=dtype,
                                   device=self.device)
            self._state = {"last_token": z(torch.int64),
                           "cache_len": z(torch.int32),
                           "emitted": z(torch.int32), "active": z(torch.bool),
                           "max_new": z(torch.int32),
                           "temps": z(torch.float32), "seeds": z(torch.int64)}

    # -- admission ---------------------------------------------------------

    def _start_admission(self, i: int, req: Request, base: int = 0) -> dict:
        """Prefill covers [base, plen): a shared prefix [0, base) is already
        in granted pages."""
        plen = len(req.prompt)
        n_chunks = -(-(plen - base) // self.prefill_chunk)
        self.stats["prefill_chunk_rows"] += n_chunks
        return {"slot": i, "req": req, "prompt": np.asarray(req.prompt),
                "plen": plen, "next": 0, "n_chunks": n_chunks, "base": base}

    def _prefill_wave(self, pending: dict, slots) -> None:
        """Advance every pending admission by one chunk in one batched
        ``prefill_chunk`` call; rows whose prompt ends in this chunk sample
        their first token on the device."""
        self.stats["prefill_chunks"] += 1
        self._sched_epoch += 1
        n, c = self.slots, self.prefill_chunk
        toks = np.zeros((n, c), np.int64)
        offs = np.zeros((n,), np.int32)
        mask = np.zeros((n,), bool)
        last = np.zeros((n,), np.int64)
        seeds = np.zeros((n,), np.int64)
        temps = np.zeros((n,), np.float32)
        completing = []
        for i, adm in pending.items():
            plen, req = adm["plen"], adm["req"]
            # a shifted final chunk never crosses below the share base
            # (base <= max_seq - c), so shared pages are never rewritten
            lo = min(adm["base"] + adm["next"] * c, self.max_seq - c)
            if self.paged:
                # cover the chunk's prompt span; its slack past the prompt
                # lands in the owned final page's tail or the null page
                self._grow_pages(i, min(lo + c, plen))
            seg = adm["prompt"][lo:lo + c]
            toks[i, :len(seg)] = seg
            offs[i] = lo
            mask[i] = True
            last[i] = max(0, min(plen - 1 - lo, c - 1))
            seeds[i] = req.seed
            temps[i] = req.temperature
            adm["next"] += 1
            if adm["next"] >= adm["n_chunks"]:
                completing.append(i)
        up = self._upload
        logits, _ = transformer.prefill_chunk(
            self.cfg, self.params, up(toks), self.ctx, self._cache,
            offsets=up(offs), admit_mask=up(mask), last_index=up(last),
            page_table=self._page_table())
        if not completing:
            return
        seeds_d, temps_d = up(seeds), up(temps)
        first = sample(logits, seeds_d, torch.zeros_like(seeds_d), temps_d)
        if self.device_sched:
            # the first tokens go into the device state before the host
            # reads them: the read below is bookkeeping only
            self._merge_admissions([pending[i] for i in completing], first,
                                   seeds_d, temps_d)
        ft = first.cpu().numpy()   # a sync only when an admission completes
        for i in completing:
            self._finish_admission(slots, pending.pop(i), int(ft[i]))

    def _merge_admissions(self, admits, first, seeds, temps) -> None:
        """Fold completed admissions into the device state in place.  A
        lane whose request finished at prefill (max_new == 1 or a full row)
        is merged inactive: a tick emits before it checks done."""
        n = self.slots
        upd = np.zeros((n,), bool)
        activate = np.zeros((n,), bool)
        clens = np.zeros((n,), np.int32)
        mnew = np.zeros((n,), np.int32)
        for adm in admits:
            i, req, plen = adm["slot"], adm["req"], adm["plen"]
            upd[i] = True
            clens[i] = plen
            mnew[i] = req.max_new_tokens
            activate[i] = not (req.max_new_tokens <= 1
                               or plen >= self.max_seq)
        u = self._upload(upd)
        st = self._state
        for name, new in (("last_token", first), ("cache_len", self._upload(
                clens)), ("emitted", torch.ones_like(st["emitted"])),
                ("active", self._upload(activate)),
                ("max_new", self._upload(mnew)), ("temps", temps),
                ("seeds", seeds)):
            st[name].copy_(torch.where(u, new.to(st[name].dtype), st[name]))

    def _finish_admission(self, slots, adm: dict, tok: int) -> None:
        req, i = adm["req"], adm["slot"]
        req.ttft_s = time.perf_counter() - req._arrival_t
        s = slots[i]
        s.request = req
        s.tokens = [tok]
        s.cache_len = adm["plen"]
        s.last_token = tok
        self.stats["admissions"] += 1
        if self._prefix is not None:
            # the prompt's full pages are written: make them reusable
            # (before a retirement at prefill, so such a request seeds too)
            self._register_prefix(i, adm["prompt"], adm["plen"])
        if len(s.tokens) >= req.max_new_tokens or s.cache_len >= self.max_seq:
            self._retire(i)   # finished at prefill (budget or row exhausted)

    # -- decode ------------------------------------------------------------

    def _ticks(self, tokens, cache_len, emitted, active, max_new, temps,
               seeds):
        """``decode_block`` ticks of decode_step + sample + bookkeeping over
        (slots,) tensors -> their values after the block and the block's
        (slots, decode_block) tokens and emit masks.  Reads no host value:
        the device-resident block runs it inside a CUDA graph."""
        outs, masks = [], []
        for _ in range(self.decode_block):
            # park inactive lanes' write at max_seq (clamped to the row tail)
            step_len = torch.where(active, cache_len, self.max_seq)
            logits, _ = transformer.decode_step(
                self.cfg, self.params, tokens[:, None], self.ctx, self._cache,
                step_len, page_table=self._page_table())
            nxt = sample(logits, seeds, emitted, temps)
            outs.append(torch.where(active, nxt, 0))
            masks.append(active)
            tokens = torch.where(active, nxt, tokens)
            cache_len = torch.where(active, cache_len + 1, cache_len)
            emitted = torch.where(active, emitted + 1, emitted)
            done = (emitted >= max_new) | (cache_len >= self.max_seq)
            active = active & ~done
        return (tokens, cache_len, emitted, active, torch.stack(outs, 1),
                torch.stack(masks, 1))

    def _device_block(self):
        """One block from the device state, which it advances in place;
        returns (tokens, masks)."""
        st = self._state
        *new, blk, mask = self._ticks(
            st["last_token"], st["cache_len"], st["emitted"], st["active"],
            st["max_new"], st["temps"], st["seeds"])
        for name, value in zip(("last_token", "cache_len", "emitted",
                                "active"), new):
            st[name].copy_(value)
        return blk, mask

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

    def _decode_block(self, slots) -> None:
        t0 = time.perf_counter()
        st = self.stats
        if self.paged:
            if not self.device_sched:
                # cover every append this block can make, bounded by each
                # lane's remaining budget (so within its reservation);
                # device-resident lanes hold their reservation already
                for i, s in enumerate(slots):
                    if s.active:
                        remaining = s.request.max_new_tokens - len(s.tokens)
                        self._grow_pages(i, min(s.cache_len + min(
                            self.decode_block, remaining), self.max_seq))
            self._note_live_tokens(
                sum(s.cache_len for s in slots if s.active))
        self._note_dispatch()
        st["decode_blocks"] += 1
        st["decode_steps"] += self.decode_block
        if self.device_sched:
            self._inflight.append(self._dispatch_device_block())
            st["decode_wall_s"] += time.perf_counter() - t0
            # read back one block behind: block N while block N+1 runs
            self._drain_blocks(slots, depth=1)
            return
        dev, reqs = self.device, [s.request for s in slots]

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=dev)

        *_, blk, mask = self._ticks(
            col([s.last_token for s in slots], torch.int64),
            col([s.cache_len for s in slots], torch.int32),
            col([len(s.tokens) for s in slots], torch.int32),
            col([s.active for s in slots], torch.bool),
            col([r.max_new_tokens if r else 0 for r in reqs], torch.int32),
            col([r.temperature if r else 0.0 for r in reqs], torch.float32),
            col([r.seed if r else 0 for r in reqs], torch.int64))
        # the block's one sync, which the next dispatch waits on
        self._process_block(slots, blk.cpu().numpy(), mask.cpu().numpy(),
                            gating=True)
        st["decode_wall_s"] += time.perf_counter() - t0

    def _dispatch_device_block(self):
        """Queue one device-resident block and its readback; returns what
        ``_drain_blocks`` reads.  On the card the first block runs eagerly
        and is then captured; every later block is one graph replay."""
        if self._graph is None:
            out = self._readback(*self._device_block())
            if self._stream is not None:
                self._graph = graphs.CapturedBlock(self._device_block,
                                                   self._stream)
            return out
        with torch.profiler.record_function("ServingEngine.replay_block"):
            return self._readback(*self._graph.replay())

    def _readback(self, blk: torch.Tensor, mask: torch.Tensor):
        """Copy a block's outputs to the host.  On the card: into fresh
        pinned memory, queued on the engine's stream before the next replay
        overwrites the graph's outputs, with an event to wait on."""
        if self._stream is None:
            return blk, mask, None
        hb = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
        hm = torch.empty(mask.shape, dtype=mask.dtype, pin_memory=True)
        hb.copy_(blk, non_blocking=True)
        hm.copy_(mask, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return hb, hm, ev

    def _drain_blocks(self, slots, depth: int) -> None:
        """Read back dispatched blocks until ``depth`` remain in flight."""
        t0 = time.perf_counter()
        while len(self._inflight) > depth:
            blk, mask, ev = self._inflight.popleft()
            if ev is not None:
                ev.synchronize()
            self._process_block(slots, blk.numpy(), mask.numpy(),
                                gating=False)
        self.stats["decode_wall_s"] += time.perf_counter() - t0

    def _process_block(self, slots, blk: np.ndarray, mask: np.ndarray, *,
                       gating: bool) -> None:
        """Fold one block's readback into the host mirror: extend outputs,
        advance lengths, retire finished lanes.  ``gating`` marks a readback
        the next dispatch waits on (every host-driven block); a
        device-resident readback gates only when it retires a lane."""
        st = self.stats
        st["decode_tokens"] += int(mask.sum())
        retired = False
        live_after = 0
        for i, s in enumerate(slots):
            if not s.active:
                continue
            new = blk[i][mask[i]].tolist()
            s.tokens.extend(new)
            s.cache_len += len(new)
            live_after += s.cache_len
            if new:
                s.last_token = new[-1]
            if (len(s.tokens) >= s.request.max_new_tokens
                    or s.cache_len >= self.max_seq):
                self._retire(i)
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

    def _retire(self, i: int) -> None:
        self._sched_epoch += 1
        self._lanes[i].free()
        if self.paged:
            self._release_slot_pages(i)

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
        this always succeed)."""
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
        """Drop slot i's page references (shared pages live on while the
        index or other slots read them), return its reservation and zero its
        table row, so a later write of the dead lane lands in the null
        page."""
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
        stream (the engine's), in order with waves and blocks.  Before the
        first beat the whole table is uploaded with the cache."""
        if self._bt_dev is not None:
            self._bt_dev[i].copy_(self._upload(self._bt[i]))

    def _note_live_tokens(self, live: int) -> None:
        self.stats["kv_live_tokens_peak"] = max(
            self.stats["kv_live_tokens_peak"], live)

    # -- prefix sharing (host side) ----------------------------------------

    def _prefix_lookup(self, prompt) -> dict:
        """The longest cached prefix of ``prompt`` at the engine's sharing
        granularity.  The share base is a ``prefill_chunk`` multiple (the
        sharer's chunk schedule is the plain engine's, so its tokens are
        too), at most ``max_seq - prefill_chunk`` (a shifted final chunk
        never rewrites a shared position) and at most ``plen - 1`` (the
        last prompt token runs through prefill for its logits).  Returns
        the full pages to alias and, for a base inside a page, the page to
        copy."""
        chain, boundary, blcp = self._prefix.lookup(prompt)
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
                                 have: int) -> bool:
        """Whether the head shares more full pages with a pending
        admission's prompt than the index grants now (``have``): then it
        waits for that donor to register its pages rather than prefill the
        prefix twice.  Donors finish in finitely many waves."""
        if self._prefix is None or not pending:
            return False
        prompt = np.asarray(req.prompt)
        ps, c = self.page_size, self.prefill_chunk
        for adm in pending.values():
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
            (dst,) = self._alloc_pages(1)
            self._own_page(i, dst, len(grant["pages"]))
            transformer.copy_paged_page(self._cache, src, dst)
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
        pool reference, so the cached prefix outlives the slot."""
        m = plen // self.page_size
        if not m:
            return
        new = self._prefix.insert(prompt, self._slot_pages[i][:m])
        for node in new:
            self._pool.incref(node.page)

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
        reqs = self._window_requests
        st = self.stats
        wall = time.perf_counter() - self._window_t0
        total = sum(len(r.output) for r in reqs if r.output is not None)
        ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
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
