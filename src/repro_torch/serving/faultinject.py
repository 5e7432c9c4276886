"""Deterministic fault injection for the serving engine.

The port's own copy of ``repro/serving/faultinject.py`` (importing that
module would load the JAX package); the schedules, ordinals and hooks are
the same, so one schedule plays out the same way on both engines.

The robustness layer's contract — a poisoned request retires only its own
lane, pages roll back refcount-exact, a device-scheduler fault degrades to
the host-driven path with token-identical survivors — is only testable if
faults can be *scheduled*: fail exactly the Nth page allocation, corrupt
exactly the Nth block readback, flip lane i's logits to NaN at decode
block k, hang exactly one dispatch.  ``FaultInjector`` is that seam.  The
engine calls its ``on_*`` hooks at four well-defined points of the hot
loop; an unscheduled hook is a no-op, so a ``None`` injector and an empty
injector are behaviourally identical and the fault-free path stays
bit-identical (the NaN mask enters the decode block as an all-False
``torch.where`` select).

Addressing is by *event ordinal*, not wall time: allocation calls, decode
dispatches and block readbacks are each counted from 0 for the run, which
makes a schedule reproducible across hosts and warm-up runs.  ``events``
records every fault actually fired (kind + ordinal + detail), so tests and
the ``--inject-faults`` benchmark can assert a schedule fully played out.

Hook -> engine call site -> failure it models:

  * ``on_alloc``     — ``ServingEngine._alloc_pages`` — a transient KV-pool
    allocation fault (HBM pressure, defrag stall).  Raises
    ``InjectedFault``; the engine aborts only the admission or lane whose
    growth hit it.
  * ``on_dispatch``  — entry of every fused decode-block dispatch — a hung
    or failed device dispatch.  A *hang* sleeps (the serving watchdog's
    deadline sees it); a *fail* raises ``InjectedFault`` host-side BEFORE
    the block is launched or replayed (so nothing has been consumed and
    ``with_retries`` can legally re-issue it).  Persistent fails
    (scheduled on consecutive ordinals) exhaust the retry budget and model
    a wedged device scheduler.
  * ``nan_mask``     — built per dispatch, consumed inside the fused block
    — a NaN-producing lane (bad accumulator, corrupted weights slice).
    The mask NaNs lane i's logits for every tick of block k; the in-block
    integrity guard flags the lane in the same readback.
  * ``on_readback``  — ``ServingEngine._process_block`` — an interconnect /
    DMA corruption: one token of the Nth readback is rewritten to an
    out-of-range id, which the host-side token-range check must catch.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

import numpy as np


class InjectedFault(RuntimeError):
    """A scheduled fault fired.  Subclasses RuntimeError so the engine's
    retry wrapper (``runtime.fault.with_retries``) treats it as transient
    by default."""

    def __init__(self, kind: str, detail: str):
        super().__init__(f"injected fault [{kind}]: {detail}")
        self.kind = kind


class FaultInjector:
    """Schedule-addressable, deterministic fault source for ``ServingEngine``.

    Schedules are built either explicitly (``fail_alloc(3)``,
    ``inject_nan(lane=1, block=2)``, ...) or randomly-but-seeded via
    ``random_schedule`` (the property tests' entry point).  All counters
    reset per ``ServingEngine.run`` via ``reset_run`` so one injector can
    be reused across warmup + measured runs without warmup consuming the
    schedule.
    """

    def __init__(self, count_warmup: bool = False):
        # schedules (ordinals are 0-based per run)
        self._fail_allocs: Set[int] = set()
        self._fail_dispatches: Set[int] = set()
        self._hang_dispatches: Dict[int, float] = {}
        self._nan_lanes: Dict[int, Set[int]] = {}  # block -> {lane}
        self._corrupt_readbacks: Dict[int, Optional[int]] = {}  # n -> lane
        self._wedge_device_from: Optional[int] = None
        self.count_warmup = count_warmup
        self.armed = True
        self.events: List[dict] = []  # faults that actually fired
        self.reset_run()

    # -- schedule construction --------------------------------------------

    def fail_alloc(self, nth: int) -> "FaultInjector":
        """Fail the nth page-pool allocation call of the run."""
        self._fail_allocs.add(int(nth))
        return self

    def fail_dispatch(self, nth: int, persistent: int = 1) -> "FaultInjector":
        """Fail the nth decode-block dispatch; ``persistent`` consecutive
        ordinals fail (>= the engine's retry budget + 1 models a wedged
        device scheduler and forces degradation)."""
        for k in range(int(persistent)):
            self._fail_dispatches.add(int(nth) + k)
        return self

    def hang_dispatch(self, nth: int, seconds: float) -> "FaultInjector":
        """Stall the nth decode-block dispatch for ``seconds`` (what the
        serving watchdog's block deadline is for)."""
        self._hang_dispatches[int(nth)] = float(seconds)
        return self

    # -- transient / self-clearing schedules --------------------------------
    #
    # Containment only needed faults that *fire*; recovery needs
    # faults that fire and then *stop* — the retry / canary-probe /
    # re-promotion layer is exactly the machinery that must notice the
    # clearing.  Everything ordinal-addressed is already self-clearing once
    # its ordinals are consumed; these helpers make the common transient
    # shapes explicit.

    def dispatch_outage(self, start: int, n: int = 1) -> "FaultInjector":
        """Transient device outage: fail every dispatch ordinal in
        ``[start, start + n)``, then recover.  With ``n`` > the engine's
        dispatch retry budget the run degrades to the host path mid-outage;
        canary probes consume dispatch ordinals too, so a probe issued
        during the outage fails and the first probe after it succeeds —
        which is what lets the engine re-promote."""
        for k in range(int(n)):
            self._fail_dispatches.add(int(start) + k)
        return self

    def hang_once(self, nth: int, seconds: float) -> "FaultInjector":
        """Hang exactly one dispatch (ordinal ``nth``) and then recover —
        the transient spelling of ``hang_dispatch`` (which already only
        fires once; the alias documents intent in recovery schedules)."""
        return self.hang_dispatch(nth, seconds)

    def wedge_device(self, nth: int = 0) -> "FaultInjector":
        """Persistently wedge the *device* scheduler: every device-path
        dispatch (fused blocks under ``device_sched``, canary probes) from
        ordinal ``nth`` on fails, while host-path dispatches still succeed.
        Models a wedged device scheduler whose host fallback works — the
        recovery layer must converge to stable host-driven service (breaker
        open, exponentially rarer canary probes) instead of thrashing."""
        self._wedge_device_from = int(nth)
        return self

    def inject_nan(self, lane: int, block: int) -> "FaultInjector":
        """NaN lane ``lane``'s logits for every tick of decode block
        ``block`` (block ordinal counts dispatches, like ``fail_dispatch``)."""
        self._nan_lanes.setdefault(int(block), set()).add(int(lane))
        return self

    def corrupt_readback(self, nth: int,
                         lane: Optional[int] = None) -> "FaultInjector":
        """Rewrite one emitted token of the nth block readback to an
        out-of-range id (``lane`` None picks the first lane that emitted)."""
        self._corrupt_readbacks[int(nth)] = (None if lane is None
                                             else int(lane))
        return self

    @classmethod
    def random_schedule(cls, seed: int, *, slots: int, n_faults: int = 3,
                        max_block: int = 8, max_alloc: int = 12,
                        kinds=("alloc", "nan", "corrupt", "dispatch"),
                        transient: bool = False) -> "FaultInjector":
        """Seeded random fault schedule over the first ``max_block`` blocks
        / ``max_alloc`` allocations — the property tests' generator.

        With ``transient=True`` every generated fault is self-clearing
        (single-ordinal alloc/NaN/corrupt faults plus bounded dispatch
        outages of 1..4 consecutive ordinals), so a retry / re-promotion
        layer is guaranteed to eventually see the fault clear — the
        recovery property tests' generator."""
        rng = np.random.default_rng(seed)
        fi = cls()
        if transient:
            kinds = ("alloc", "nan", "corrupt", "outage")
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "alloc":
                fi.fail_alloc(int(rng.integers(max_alloc)))
            elif kind == "nan":
                fi.inject_nan(int(rng.integers(slots)),
                              int(rng.integers(max_block)))
            elif kind == "corrupt":
                fi.corrupt_readback(int(rng.integers(max_block)))
            elif kind == "outage":
                fi.dispatch_outage(int(rng.integers(max_block)),
                                   int(rng.integers(1, 5)))
            else:
                fi.fail_dispatch(int(rng.integers(max_block)))
        return fi

    # -- run lifecycle -----------------------------------------------------

    def reset_run(self) -> None:
        """Zero the per-run ordinals (called by ``ServingEngine.run``)."""
        self._alloc_calls = 0
        self._dispatch_calls = 0
        self._readback_calls = 0

    @property
    def faults_fired(self) -> int:
        return len(self.events)

    def _fire(self, kind: str, detail: str) -> None:
        self.events.append({"kind": kind, "detail": detail,
                            "alloc": self._alloc_calls,
                            "dispatch": self._dispatch_calls,
                            "readback": self._readback_calls})

    # -- engine-facing hooks ----------------------------------------------

    def on_alloc(self) -> None:
        n = self._alloc_calls
        self._alloc_calls += 1
        if self.armed and n in self._fail_allocs:
            self._fire("alloc", f"page allocation #{n}")
            raise InjectedFault("alloc", f"page allocation #{n} failed")

    def on_dispatch(self, device: bool = True) -> int:
        """Called at the entry of each decode-block dispatch (and each
        canary probe); returns the block ordinal (which ``nan_mask`` keys
        on).  ``device`` says which scheduling path issued the dispatch —
        ordinal-addressed schedules fire on either path, the persistent
        ``wedge_device`` schedule only on the device path."""
        n = self._dispatch_calls
        self._dispatch_calls += 1
        if not self.armed:
            return n
        if n in self._hang_dispatches:
            self._fire("hang", f"dispatch #{n} "
                       f"stalled {self._hang_dispatches[n]}s")
            time.sleep(self._hang_dispatches[n])
        wedged = (self._wedge_device_from is not None and device
                  and n >= self._wedge_device_from)
        if wedged or n in self._fail_dispatches:
            tag = " (device wedge)" if wedged else ""
            self._fire("dispatch", f"dispatch #{n}{tag}")
            raise InjectedFault("dispatch", f"decode dispatch #{n}{tag} failed")
        return n

    def nan_mask(self, block: int, slots: int) -> Optional[np.ndarray]:
        """Per-dispatch NaN lane mask, or None when nothing is scheduled
        (the engine then passes its cached all-False mask — zero overhead
        and bit-identical arithmetic)."""
        lanes = self._nan_lanes.get(block) if self.armed else None
        if not lanes:
            return None
        mask = np.zeros((slots,), bool)
        for i in lanes:
            if i < slots:
                mask[i] = True
                self._fire("nan", f"lane {i} @ block {block}")
        return mask if mask.any() else None

    def on_readback(self, blk: np.ndarray, mask: np.ndarray,
                    bad_token: int) -> np.ndarray:
        """Possibly corrupt one emitted token of this readback (rewritten
        to ``bad_token``, an out-of-range id the host-side range check
        must flag)."""
        n = self._readback_calls
        self._readback_calls += 1
        if not self.armed or n not in self._corrupt_readbacks:
            return blk
        lane = self._corrupt_readbacks[n]
        if lane is None:
            emitted = np.flatnonzero(mask.any(axis=1))
            if not len(emitted):
                return blk  # nothing emitted: nothing to corrupt
            lane = int(emitted[0])
        if lane >= blk.shape[0] or not mask[lane].any():
            return blk
        blk = blk.copy()
        blk[lane, int(np.flatnonzero(mask[lane])[0])] = bad_token
        self._fire("corrupt", f"readback #{n} lane {lane}")
        return blk
