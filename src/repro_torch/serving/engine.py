"""Continuous-batching serving engine: chunked in-place admission waves
interleaved with multi-tick decode blocks, on a contiguous or a paged KV
cache, in bf16/f32 or int8.

Counterpart of the core of ``repro/serving/engine.py`` with host-driven
scheduling (JAX's ``device_sched=False``):

  * **chunked admission waves** — every pending admission advances by one
    ``prefill_chunk``-token chunk per wave, all rows in one
    ``transformer.prefill_chunk`` call that writes each chunk's KV in place
    at its row's offset (rows of decoding or idle lanes are masked).  A
    final chunk that would run past the cache row is shifted back to end at
    ``max_seq``; its leading overlap rewrites positions the previous chunk
    already wrote, with the same tokens at the same positions.
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
  * **bounded interleaving** — one beat (``step()``) runs at most one
    admission wave and one decode block, so in-flight lanes stall for at
    most one chunk between blocks
    (``stats["max_chunks_between_decode_blocks"]``).
  * **paged KV** (``paged=True``) — a global pool of ``kv_pages`` pages of
    ``page_size`` tokens (page 0 the null page) and one block-table row
    per slot, so KV memory follows live tokens instead of
    ``slots x max_seq``.  A host allocator hands out pages lazily (the
    admission chunk's span, then each decode block's appends) under FIFO
    admission gated by each request's worst-case reservation
    (``worst_case_pages``): a request whose reservation does not fit waits
    (``admissions_deferred_pages``), so growth never runs dry mid-flight.
    Retirement frees the pages and zeroes the table row.  The block table
    lives on the device as one (slots, pages_per_slot) int32 tensor,
    updated row by row.  Paged serving emits the contiguous engine's tokens
    exactly: its kernels walk keys in the contiguous kernels' order.
  * **int8 KV** (``kv_quant=True``, contiguous or paged) — K/V stored as
    int8 with per-(token, head) absmax scales; chunk attention reads them as
    f32(int8) * f32(scale), decode through bf16, as the JAX model does.

The JAX engine unpacks the base-3 codes again at every dispatch.  Weights
are immutable while serving, so this engine pre-decodes them ONCE when it is
built (``transformer.predecode_packed``); every GEMM then computes exactly
what the packed path computes.  Attention runs the chunk and decode kernels
of ``ctx`` (the kernel path by default).

Sampling: greedy is ``argmax`` (the first maximum, as in JAX).  With a
temperature the draw is a function of (request seed, emit index, logits)
alone — Gumbel-max noise from a ``torch.Generator`` seeded with the pair —
so a request samples the same tokens whatever slot or schedule it gets.
It does not reproduce JAX's threefry draws.

Left out of this engine: prefix sharing, device-resident scheduling, fault
handling and retries, and the mesh.  An invalid request — one whose
worst-case KV pages exceed the pool among them — raises ``ValueError`` at
``submit()`` (the JAX engine stamps it REJECTED).
"""

from __future__ import annotations

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


_MASK64 = (1 << 64) - 1


def draw_seed(seed: int, emit_idx: int) -> int:
    """A generator seed for one draw: the (request seed, emit index) pair
    packed into 64 bits and scrambled (splitmix64 finalizer), so that every
    bit — the CPU generator reads only the low 32 — depends on both."""
    z = ((int(seed) << 32) | (int(emit_idx) & 0xFFFFFFFF)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sample(logits: torch.Tensor, seeds, emit_idx, temps) -> torch.Tensor:
    """(b, vocab) logits -> (b,) int64 tokens.  Greedy rows take the first
    maximum; a row with temperature t > 0 takes argmax(logits / t + Gumbel
    noise), the noise drawn from a generator seeded by
    ``draw_seed(seeds[i], emit_idx[i])`` on the logits' device."""
    tokens = torch.argmax(logits, dim=-1)
    for i, t in enumerate(temps):
        if t <= 0.0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(draw_seed(seeds[i], emit_idx[i]))
        u = torch.rand(logits.shape[-1], generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        tokens[i] = torch.argmax(logits[i].float() / max(t, 1e-6) + gumbel)
    return tokens


class _PagePool:
    """Host-side allocator over the global KV page pool (the JAX engine's,
    without the reference counts that prefix sharing adds).  Page 0 is the
    reserved null page and is never handed out; the free list is LIFO, so a
    retired page is reused first.  Freeing a page that is not allocated
    fails fast."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("page pool needs >= 2 pages (one is the "
                             "reserved null page)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._owned: set = set()

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: asked {n}, have {len(self._free)} "
                "(reservation-gated admission should make this unreachable)")
        out = [self._free.pop() for _ in range(n)]
        self._owned.update(out)
        return out

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._owned:
                raise RuntimeError(f"double free of page {p}")
            self._owned.remove(p)
            self._free.append(p)


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

    ``paged=True`` keeps KV in a pool of ``kv_pages`` pages of
    ``page_size`` tokens (default: every slot can reach ``max_seq``, plus
    the null page); ``kv_quant=True`` stores int8 KV with f32 scales."""

    def __init__(self, cfg: ModelConfig, params: nn.ModuleDict, *,
                 max_seq: int, batch_slots: int = 4,
                 ctx: Optional[Ctx] = None, seed: int = 0,
                 prefill_chunk: int = 32, decode_block: int = 8,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 paged: bool = False, page_size: int = 16,
                 kv_pages: Optional[int] = None, kv_quant: bool = False,
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
        self.cfg = cfg
        self.device = pdev
        self.params = transformer.predecode_packed(cfg, params)
        self.max_seq = max_seq
        self.slots = batch_slots
        self.prefill_chunk = max(1, min(prefill_chunk, max_seq))
        self.decode_block = max(1, decode_block)
        self.cache_dtype = cache_dtype
        self.kv_quant = bool(kv_quant)
        self.paged = bool(paged)
        if self.paged:
            self.page_size = max(1, min(int(page_size), max_seq))
            self.pages_per_slot = -(-max_seq // self.page_size)
            self.kv_pages = (int(kv_pages) if kv_pages is not None
                             else batch_slots * self.pages_per_slot + 1)
            self._pool = _PagePool(self.kv_pages)
            # host block table and its device copy; dead entries: page 0
            self._bt = np.zeros((batch_slots, self.pages_per_slot), np.int32)
            self._bt_dev = torch.zeros(self._bt.shape, dtype=torch.int32,
                                       device=self.device)
            self._slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
            self._slot_reserved = [0] * batch_slots
            self._reserved_total = 0
            self._deferred_head = None
        self.ctx = ctx or Ctx()
        self.seed = seed
        self._lanes = [_Slot() for _ in range(batch_slots)]
        self._queue: deque = deque()
        self._pending: dict = {}     # slot -> in-progress admission
        self._cache = None           # built at the first beat
        self._arrivals = 0
        self._chunks_since_block = 0
        self.reset_stats()

    # -- lifecycle ---------------------------------------------------------

    def reset_stats(self) -> None:
        """Open a fresh stats window (``run()`` opens one per batch)."""
        self.stats = {"admissions": 0, "mid_flight_admissions": 0,
                      "prefill_chunks": 0, "decode_steps": 0,
                      "decode_blocks": 0, "decode_tokens": 0,
                      "decode_wall_s": 0.0,
                      "max_chunks_between_decode_blocks": 0}
        if self.paged:
            self.stats.update({"kv_pages_peak": 0, "kv_live_tokens_peak": 0,
                               "kv_reserved_pages_peak": 0,
                               "admissions_deferred_pages": 0})
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
        return bool(self._queue or self._pending
                    or any(s.active for s in self._lanes))

    def step(self) -> bool:
        """One scheduler beat: assign free slots to queued requests, run one
        admission wave, then one decode block.  Returns whether there was
        work."""
        slots, pending, queue = self._lanes, self._pending, self._queue
        if not self.has_work:
            return False
        if self._cache is None:
            if self.paged:
                self._cache = transformer.init_paged_cache(
                    self.cfg, self.kv_pages, self.page_size, self.cache_dtype,
                    self.device, kv_quant=self.kv_quant)
            else:
                self._cache = transformer.init_cache(
                    self.cfg, self.slots, self.max_seq, self.cache_dtype,
                    self.device, kv_quant=self.kv_quant)
        for i, s in enumerate(slots):
            if not queue:
                break
            if not s.active and i not in pending:
                if self.paged and not self._reserve(i, queue[0]):
                    break   # page-starved: FIFO waits for lanes to retire
                req = queue.popleft()
                plen = len(req.prompt)
                pending[i] = {"slot": i, "req": req,
                              "prompt": np.asarray(req.prompt), "plen": plen,
                              "next": 0,
                              "n_chunks": -(-plen // self.prefill_chunk)}
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
            self._decode_block(slots)
            self._chunks_since_block = 0
        return True

    def drain(self) -> dict:
        """Step until every submitted request is done; returns the stats of
        the window."""
        while self.step():
            pass
        self._finalize_window()
        return self.stats

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a batch: a fresh stats window, submit all, drain."""
        self.reset_stats()
        for r in requests:
            self.submit(r)
        self.drain()
        return requests

    # -- admission ---------------------------------------------------------

    def _prefill_wave(self, pending: dict, slots) -> None:
        """Advance every pending admission by one chunk in one batched
        ``prefill_chunk`` call; rows whose prompt ends in this chunk sample
        their first token."""
        self.stats["prefill_chunks"] += 1
        n, c = self.slots, self.prefill_chunk
        toks = np.zeros((n, c), np.int64)
        offs = np.zeros((n,), np.int32)
        mask = np.zeros((n,), bool)
        last = np.zeros((n,), np.int64)
        completing = []
        for i, adm in pending.items():
            plen = adm["plen"]
            lo = min(adm["next"] * c, self.max_seq - c)   # shifted final chunk
            if self.paged:
                # cover the chunk's prompt span; its slack past the prompt
                # lands in the owned final page's tail or the null page
                self._grow_pages(i, min(lo + c, plen))
            seg = adm["prompt"][lo:lo + c]
            toks[i, :len(seg)] = seg
            offs[i] = lo
            mask[i] = True
            last[i] = max(0, min(plen - 1 - lo, c - 1))
            adm["next"] += 1
            if adm["next"] >= adm["n_chunks"]:
                completing.append(i)
        dev = self.device
        logits, _ = transformer.prefill_chunk(
            self.cfg, self.params, torch.from_numpy(toks).to(dev), self.ctx,
            self._cache, offsets=torch.from_numpy(offs).to(dev),
            admit_mask=torch.from_numpy(mask).to(dev),
            last_index=torch.from_numpy(last).to(dev),
            page_table=self._page_table())
        if not completing:
            return
        reqs = [pending[i]["req"] if i in completing else None
                for i in range(n)]
        first = sample(logits, [r.seed if r else 0 for r in reqs], [0] * n,
                       [r.temperature if r else 0.0 for r in reqs]).cpu()
        for i in completing:
            self._finish_admission(slots, pending.pop(i), int(first[i]))

    def _finish_admission(self, slots, adm: dict, tok: int) -> None:
        req, i = adm["req"], adm["slot"]
        req.ttft_s = time.perf_counter() - req._arrival_t
        s = slots[i]
        s.request = req
        s.tokens = [tok]
        s.cache_len = adm["plen"]
        s.last_token = tok
        self.stats["admissions"] += 1
        if len(s.tokens) >= req.max_new_tokens or s.cache_len >= self.max_seq:
            self._retire(i)   # finished at prefill (budget or row exhausted)

    # -- decode ------------------------------------------------------------

    def _decode_block(self, slots) -> None:
        t0 = time.perf_counter()
        st = self.stats
        if self.paged:
            # cover every append this block can make, bounded by each
            # lane's remaining budget (so within its reservation)
            for i, s in enumerate(slots):
                if s.active:
                    remaining = s.request.max_new_tokens - len(s.tokens)
                    self._grow_pages(i, min(s.cache_len + min(
                        self.decode_block, remaining), self.max_seq))
            self._note_live_tokens(
                sum(s.cache_len for s in slots if s.active))
        st["decode_blocks"] += 1
        st["decode_steps"] += self.decode_block
        dev, reqs = self.device, [s.request for s in slots]

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=dev)

        tokens = col([s.last_token for s in slots], torch.int64)
        cache_len = col([s.cache_len for s in slots], torch.int32)
        emitted = col([len(s.tokens) for s in slots], torch.int32)
        max_new = col([r.max_new_tokens if r else 0 for r in reqs], torch.int32)
        active = col([s.active for s in slots], torch.bool)
        seeds = [r.seed if r else 0 for r in reqs]
        temps = [r.temperature if r else 0.0 for r in reqs]
        outs, masks = [], []
        for tick in range(self.decode_block):
            # park inactive lanes' write at max_seq (clamped to the row tail)
            step_len = torch.where(active, cache_len, self.max_seq)
            logits, _ = transformer.decode_step(
                self.cfg, self.params, tokens[:, None], self.ctx, self._cache,
                step_len, page_table=self._page_table())
            nxt = sample(logits, seeds, [len(s.tokens) + tick for s in slots],
                         temps)
            outs.append(torch.where(active, nxt, 0))
            masks.append(active)
            tokens = torch.where(active, nxt, tokens)
            cache_len = torch.where(active, cache_len + 1, cache_len)
            emitted = torch.where(active, emitted + 1, emitted)
            done = (emitted >= max_new) | (cache_len >= self.max_seq)
            active = active & ~done
        blk = torch.stack(outs, 1).cpu().numpy()      # the block's one sync
        mask = torch.stack(masks, 1).cpu().numpy()
        st["decode_tokens"] += int(mask.sum())
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
        if self.paged:   # the entry sample misses the block's own appends
            self._note_live_tokens(live_after)
        # the parked-write contract: a lane that filled its row parks its
        # remaining ticks on its own last KV entry, which is only safe
        # because it retires here, before any later block reads that row
        if any(s.cache_len >= self.max_seq for s in slots if s.active):
            raise RuntimeError("active lane at cache_len >= max_seq: parked "
                               "decode writes could clobber a live token")
        st["decode_wall_s"] += time.perf_counter() - t0

    def _retire(self, i: int) -> None:
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

    def _reserve(self, i: int, req: Request) -> bool:
        """Reserve the head request's worst case for slot i, or count one
        deferral episode per starved head and refuse."""
        need = self.worst_case_pages(req)
        if self._reserved_total + need > self._pool.usable:
            if req is not self._deferred_head:
                self.stats["admissions_deferred_pages"] += 1
                self._deferred_head = req
            return False
        self._slot_reserved[i] = need
        self._reserved_total += need
        self.stats["kv_reserved_pages_peak"] = max(
            self.stats["kv_reserved_pages_peak"], self._reserved_total)
        return True

    def _grow_pages(self, i: int, upto_tokens: int) -> None:
        """Extend slot i's pages to cover flat positions [0, upto_tokens)."""
        pages = self._slot_pages[i]
        need = -(-upto_tokens // self.page_size)
        if need <= len(pages):
            return
        new = self._pool.alloc(need - len(pages))
        self._bt[i, len(pages):need] = new
        pages.extend(new)
        self._push_bt_row(i)
        self.stats["kv_pages_peak"] = max(self.stats["kv_pages_peak"],
                                          self._pool.used_pages)

    def _release_slot_pages(self, i: int) -> None:
        """Return slot i's pages and reservation; zero its table row so any
        later write of the dead lane lands in the null page."""
        pages, self._slot_pages[i] = self._slot_pages[i], []
        self._reserved_total -= self._slot_reserved[i]
        self._slot_reserved[i] = 0
        self._bt[i, :] = 0
        self._push_bt_row(i)
        self._pool.free(pages)

    def _push_bt_row(self, i: int) -> None:
        self._bt_dev[i].copy_(torch.from_numpy(self._bt[i]))

    def _note_live_tokens(self, live: int) -> None:
        self.stats["kv_live_tokens_peak"] = max(
            self.stats["kv_live_tokens_peak"], live)

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
        })
        if self.paged:
            st.update({"kv_page_size": self.page_size,
                       "kv_pool_pages": self._pool.usable,
                       "kv_pages_in_use": self._pool.used_pages})
