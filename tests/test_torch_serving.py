"""The port's serving engine: token identity with its own unbatched oracle
(``reference_decode``) on a ragged batch, with the JAX engine on the same
weights, request-local temperature sampling, and the card-by-default rule.

The engine pre-decodes the packed weights once and runs the chunk and
decode attention paths; the oracle runs the packed weights through
``prefill_step`` + ``decode_step``.  Both compute the same integer GEMMs;
their float paths differ only where chunked admission reads earlier chunks'
K/V back from the bf16 cache, so greedy tokens must agree except at a
near-tie (the first flip's oracle top-2 margin below ``NEAR_TIE``, printed).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models.layers import Ctx
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import reference_decode, sample

NEAR_TIE = 1e-2


@pytest.fixture(scope="module")
def served():
    j_cfg = j_get_config("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


def _agree(got, want, margins):
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            print(f"greedy flip at emit index {i}: oracle top-2 margin "
                  f"{margins[i]:.2e}")
            assert margins[i] < NEAR_TIE, (got, want, margins)
            return
    assert len(got) == len(want)


def _ragged(vocab):
    rng = np.random.default_rng(5)
    lens_new = [(5, 6), (3, 3), (13, 7), (2, 5), (29, 5), (4, 12)]
    return [Request(prompt=rng.integers(0, vocab, plen), max_new_tokens=n)
            for plen, n in lens_new]


def test_engine_matches_reference_decode(served):
    """6 ragged requests over 3 slots, chunk 7 over max_seq 30:
      * mid-flight admissions into freed slots;
      * the 29-token prompt's final chunk is shifted back to end at max_seq
        (chunks at 0, 7, 14, 21, then 23 instead of 28);
      * the same request hits the capacity edge: 1 + (30 - 29) = 2 tokens;
      * the 12-token request fills its row mid-block (parked writes)."""
    _, _, cfg, ours = served
    max_seq = 30
    eng = ServingEngine(cfg, ours, max_seq=max_seq, batch_slots=3,
                        prefill_chunk=7, decode_block=4, device="cpu")
    reqs = eng.run(_ragged(cfg.vocab_size))
    st = eng.stats
    assert st["mid_flight_admissions"] >= 1
    assert st["max_chunks_between_decode_blocks"] == 1
    assert st["admissions"] == len(reqs)
    assert st["decode_tokens"] == st["total_new_tokens"] - st["admissions"]
    assert st["ttft_p50_s"] <= st["ttft_p95_s"]
    for r in reqs:
        cap = 1 + max_seq - len(r.prompt)
        assert r.done and len(r.output) == min(r.max_new_tokens, cap)
        want, margins = reference_decode(cfg, ours, Ctx(), r.prompt,
                                         len(r.output), max_seq)
        _agree(r.output.tolist(), want, margins)
        # every engine token judged on the engine's own history
        _, gaps = reference_decode(cfg, ours, Ctx(), r.prompt, len(r.output),
                                   max_seq, follow=r.output)
        assert max(gaps) < NEAR_TIE, gaps
    assert len(reqs[4].output) == 2
    # following the oracle's own tokens leaves no gap
    toks, _ = reference_decode(cfg, ours, Ctx(), reqs[0].prompt, 6, max_seq)
    _, gaps = reference_decode(cfg, ours, Ctx(), reqs[0].prompt, 6, max_seq,
                               follow=toks)
    assert gaps == [0.0] * 6


def test_engine_matches_jax_engine(served):
    """Same weights, same requests: the JAX engine on its kernel ctx
    (Pallas attention, host-driven scheduling) and the port's engine emit
    the same greedy tokens."""
    j_cfg, packed, cfg, ours = served
    reqs = _ragged(cfg.vocab_size)[:4]
    j_reqs = [JRequest(prompt=np.asarray(r.prompt, np.int32),
                       max_new_tokens=r.max_new_tokens) for r in reqs]
    JServingEngine(j_cfg, packed, max_seq=30, batch_slots=3,
                   ctx=JCtx(mode="packed", group_size=j_cfg.group_size,
                            attn_impl="pallas"),
                   prefill_chunk=7, decode_block=4,
                   device_sched=False).run(j_reqs)
    ServingEngine(cfg, ours, max_seq=30, batch_slots=3, prefill_chunk=7,
                  decode_block=4, device="cpu").run(reqs)
    for r, jr in zip(reqs, j_reqs):
        if r.output.tolist() != jr.output.tolist():
            _, margins = reference_decode(cfg, ours, Ctx(), r.prompt,
                                          len(r.output), 30)
            _agree(r.output.tolist(), jr.output.tolist(), margins)


def test_temperature_draw_depends_only_on_seed_and_emit_index(served):
    _, _, cfg, ours = served

    def probe(seed=123):
        return Request(prompt=np.asarray([2, 7, 1, 8]), max_new_tokens=8,
                       temperature=0.9, seed=seed)

    def filler(n):
        return Request(prompt=np.asarray([5, 3, 1]) * n % cfg.vocab_size,
                       max_new_tokens=n + 3)

    kw = dict(max_seq=32, batch_slots=2, prefill_chunk=4, decode_block=4,
              device="cpu")
    a = probe()
    ServingEngine(cfg, ours, **kw).run([a, filler(1), filler(2)])
    b = probe()     # admitted last, into a recycled slot, other engine seed
    ServingEngine(cfg, ours, seed=99, **kw).run([filler(1), filler(2), b])
    np.testing.assert_array_equal(a.output, b.output)
    c = probe(seed=124)
    ServingEngine(cfg, ours, **kw).run([c])
    assert not np.array_equal(a.output, c.output)

    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    t1 = sample(logits, [7, 7, 7], [0, 1, 0], [1.0, 1.0, 1.0])
    t2 = sample(logits, [7, 0, 7], [0, 5, 0], [1.0, 0.0, 1.0])
    assert t1[0] == t2[0] and t1[2] == t2[2]
    assert t2[1] == torch.argmax(logits[1])       # greedy row: first maximum


def test_engine_runs_on_the_card_by_default(served):
    _, _, cfg, ours = served
    expected = RuntimeError if not torch.cuda.is_available() else ValueError
    with pytest.raises(expected):
        ServingEngine(cfg, ours, max_seq=16)    # device="cuda" by default
    with pytest.raises(ValueError, match="prompt length"):
        ServingEngine(cfg, ours, max_seq=4, device="cpu").submit(
            Request(prompt=np.arange(5)))
