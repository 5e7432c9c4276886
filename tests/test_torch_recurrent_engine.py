"""The serving engine on the recurrent kinds (reduced hymba-1.5b and
xlstm-350m, JAX's weights carried by ``convert.from_jax_packed``):
whole-prompt admission, one admission a wave (``prefill_step`` on a
one-row cache, then the adopt step into the slot's rows), and the decode
block on the state planes.

What is held:
  * lockstep with the JAX engine (its Pallas attention in interpret mode),
    token for token, on f32 and bf16 caches, host-driven and
    device-resident, with prompts of 3 to 30 tokens (hymba's past its
    reduced 16-token window); hymba with ``kv_splits=2``; a request retried
    after an injected NaN lane, replaying its prompt and carried tokens,
    on the same injector schedule in both packages;
  * device-resident == host-driven, and on f32 caches every request's
    tokens are ``reference_decode``'s, 2-token hymba prompts included
    (the JAX engine gets those wrong: ROADMAP C, so they stay out of the
    lockstep);
  * the refusals are JAX's: chunked prefill and a paged cache in the model
    (NotImplementedError), and a paged cache, int8 KV or a mesh in the
    engine (ValueError, JAX's message word for word).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro.models.layers import Ctx as JCtx
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_jax_packed
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.serving import (FaultInjector, Request, RequestStatus,
                                 ServingEngine)
from repro_torch.serving.engine import reference_decode

KINDS = ["hymba-1.5b", "xlstm-350m"]
ENGINE_KW = dict(max_seq=40, batch_slots=2, decode_block=4)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
LENGTHS = (3, 20, 7, 30, 12)
NEWS = (6, 5, 8, 4, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _models(name):
    j_cfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    packed = jtf.pack_params(j_cfg, jtf.init_params(j_cfg,
                                                    jax.random.PRNGKey(1)))
    ours = from_jax_packed(cfg, jax.tree_util.tree_map(np.array, packed),
                           device="cpu")
    return j_cfg, packed, cfg, ours


@pytest.fixture(params=KINDS)
def served(request):
    return _models(request.param)


def _prompts(cfg, seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def _j_ctx(j_cfg):
    return JCtx(mode="packed", group_size=j_cfg.group_size,
                attn_impl="pallas")


def _jax_run(served, prompts, news, fi=None, **kw):
    j_cfg, packed, _, _ = served
    eng = JServingEngine(j_cfg, packed, ctx=_j_ctx(j_cfg), fault_injector=fi,
                         **dict(ENGINE_KW, **kw))
    reqs = eng.run([JRequest(prompt=p, max_new_tokens=n)
                    for p, n in zip(prompts, news)])
    return eng, reqs


def _port_run(served, prompts, news, fi=None, **kw):
    _, _, cfg, ours = served
    eng = ServingEngine(cfg, ours, device="cpu", fault_injector=fi,
                        **dict(ENGINE_KW, **kw))
    reqs = eng.run([Request(prompt=p, max_new_tokens=n)
                    for p, n in zip(prompts, news)])
    return eng, reqs


def _tokens(reqs):
    return [r.output.tolist() for r in reqs]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("device_sched", [False, True])
def test_engine_lockstep_with_jax(served, dtype, device_sched):
    """Five prompts over two slots: admissions mid-flight, one a wave."""
    _, _, cfg, _ = served
    t_dtype, j_dtype = DTYPES[dtype]
    prompts = _prompts(cfg)
    j_eng, j_reqs = _jax_run(served, prompts, NEWS,
                             device_sched=device_sched, cache_dtype=j_dtype)
    eng, reqs = _port_run(served, prompts, NEWS, device_sched=device_sched,
                          cache_dtype=t_dtype)
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert _tokens(reqs) == _tokens(j_reqs)
    st = eng.stats
    assert st["admissions"] == len(prompts) == st["prefill_chunks"]
    assert st["prefill_chunk_rows"] == len(prompts)
    for key in ("admissions", "prefill_chunks", "mid_flight_admissions",
                "decode_blocks"):
        assert st[key] == j_eng.stats[key], key


def test_hymba_kv_splits_lockstep_with_jax():
    """hymba with split-K decode (K = 2), both scheduling modes, as the JAX
    engine accepts it."""
    served = _models("hymba-1.5b")
    prompts = _prompts(served[2], seed=1)
    for dev in (False, True):
        _, j_reqs = _jax_run(served, prompts, NEWS, kv_splits=2,
                             device_sched=dev)
        eng, reqs = _port_run(served, prompts, NEWS, kv_splits=2,
                              device_sched=dev)
        assert eng.ctx.kv_splits == 2
        assert _tokens(reqs) == _tokens(j_reqs), dev


@pytest.mark.parametrize("device_sched", [False, True])
def test_retry_after_fault_lockstep_with_jax(served, device_sched):
    """A NaN lane at the second block fails its request; with one retry it
    re-queues and prefills its prompt plus the tokens it carried, then ends
    OK with the fault-free tokens, in both packages alike, with the same
    statuses and counters.  Every request's tokens are the port's
    fault-free run's.  Device-resident, the JAX engine leaks the retired
    lane's in-flight block into the slot's next occupant (ROADMAP C), so
    there only the retried request is held to JAX's tokens."""
    prompts = _prompts(served[2], seed=2, lengths=(9, 4, 22))
    news = (10, 6, 9)
    kw = dict(device_sched=device_sched, max_retries=1, retry_backoff_s=0.0)
    jfi = JFaultInjector().inject_nan(lane=0, block=1)
    j_eng, j_reqs = _jax_run(served, prompts, news, fi=jfi, **kw)
    fi = FaultInjector().inject_nan(lane=0, block=1)
    eng, reqs = _port_run(served, prompts, news, fi=fi, **kw)
    _, clean = _port_run(served, prompts, news, device_sched=device_sched)
    assert ([r.status.value for r in reqs]
            == [r.status.value for r in j_reqs])
    for key in ("integrity_faults", "requests_retried", "retries_total"):
        assert eng.stats[key] == j_eng.stats[key] == 1, key
    assert _tokens(reqs) == _tokens(clean)
    (i,) = [i for i, r in enumerate(reqs) if r.retries]
    assert reqs[i].attempts == 2 and reqs[i].status is RequestStatus.OK
    assert j_reqs[i].retries == 1
    assert reqs[i].output.tolist() == j_reqs[i].output.tolist()
    if not device_sched:
        assert _tokens(reqs) == _tokens(j_reqs)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_device_resident_equals_host_and_oracle(served, dtype):
    """The port's own invariants, with 1- and 2-token prompts (shorter
    than hymba's 3-row conv ring) among them: device-resident ==
    host-driven; on the f32 cache every request's greedy tokens are
    ``reference_decode``'s."""
    _, _, cfg, ours = served
    t_dtype = DTYPES[dtype][0]
    prompts = _prompts(cfg, seed=3, lengths=(2, 17, 1, 5, 2))
    runs = {dev: _tokens(_port_run(served, prompts, NEWS, device_sched=dev,
                                   cache_dtype=t_dtype)[1])
            for dev in (False, True)}
    assert runs[False] == runs[True]
    if t_dtype != torch.float32:
        return
    for p, n, toks in zip(prompts, NEWS, runs[True]):
        want, _ = reference_decode(cfg, ours, Ctx(), p, n,
                                   ENGINE_KW["max_seq"], torch.float32)
        assert toks == want, (len(p), toks, want)


def test_model_refuses_chunked_prefill_and_paged_cache(served):
    """As JAX's model: a recurrent state cannot resume chunk to chunk, and
    it has nothing to page."""
    _, _, cfg, ours = served
    with pytest.raises(NotImplementedError,
                       match="chunked prefill requires block_kind='attn'"):
        transformer.prefill_chunk(
            cfg, ours, torch.zeros((1, 4), dtype=torch.long), Ctx(),
            transformer.init_cache(cfg, 1, 8, device="cpu"), offsets=[0],
            admit_mask=[True], last_index=[3])
    with pytest.raises(NotImplementedError,
                       match="paged KV cache requires block_kind='attn'"):
        transformer.init_paged_cache(cfg, 8, 4, device="cpu")


class _Mesh:
    """Stands in for a ("data", "model") device mesh: the refusal reads
    only its axis names."""
    mesh_dim_names = ("data", "model")


@pytest.mark.parametrize("option", ["paged", "kv_quant", "mesh"])
def test_engine_refusals_are_jax_messages(served, option):
    j_cfg, packed, cfg, ours = served
    if option == "mesh":
        j_kw = {"mesh": jax.sharding.Mesh(
            np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))}
        kw = {"mesh": _Mesh()}
    else:
        j_kw = kw = {option: True}
    with pytest.raises(ValueError) as j_err:
        JServingEngine(j_cfg, packed, ctx=_j_ctx(j_cfg), max_seq=16, **j_kw)
    with pytest.raises(ValueError) as err:
        ServingEngine(cfg, ours, max_seq=16, device="cpu", **kw)
    assert str(err.value) == str(j_err.value)
    assert "block_kind='attn'" in str(err.value)
