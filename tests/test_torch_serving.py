"""The port's serving layer on the CPU: allocator and scheduler invariants,
the engine's token streams and stats against the JAX ServingEngine, the
serve entry point, and the copied config registry."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.common import ModelConfig as JModelConfig
from repro.serving.cache import PagedCacheConfig as JPagedCacheConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.common import ModelConfig
from repro_torch.obs.trace import Tracer
from repro_torch.serving.cache import BlockAllocator, PagedCacheConfig, kv_bytes_per_token
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig

SV = dict(name="sv", arch_type="dense", num_layers=3, d_model=32, num_heads=4,
          num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
          param_dtype="float32")


# ---------------------------------------------------------------------------
# Block allocator invariants (mirrors tests/test_serving.py)
# ---------------------------------------------------------------------------
def test_allocator_basics():
    a = BlockAllocator(4)
    got = a.alloc(3)
    assert len(got) == 3 and a.available == 1
    assert a.alloc(2) is None               # all-or-nothing
    a.free(got[:2])
    assert a.available == 3
    with pytest.raises(ValueError):
        a.free(got[:1] + got[:1])           # double free in one call
    a.free(got[2:])
    with pytest.raises(ValueError):
        a.free(got[2:])                     # double free across calls
    assert a.available == 4


def test_allocator_properties():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(st.lists(st.tuples(st.booleans(), st.integers(0, 6)), max_size=60))
    def run(ops):
        cap = 12
        a = BlockAllocator(cap)
        held: list[int] = []
        for is_alloc, n in ops:
            if is_alloc:
                got = a.alloc(n)
                if n > cap - len(held):
                    assert got is None
                else:
                    assert got is not None and len(got) == n
                    assert not set(got) & set(held)       # never double-issued
                    held.extend(got)
            elif held:
                k = min(n, len(held))
                a.free(held[:k])
                del held[:k]
            assert a.available == cap - len(held)
            assert a.used == len(held)
        a.free(held)
        assert a.available == cap

    run()


def test_submit_rejects_unservable_requests():
    pcfg = PagedCacheConfig(num_blocks=2, block_size=4, max_blocks_per_seq=8)
    s = Scheduler(SchedulerConfig(cache=pcfg, max_batch=2))
    with pytest.raises(ValueError):        # exceeds the table capacity
        s.submit(Request(rid=0, prompt=tuple(range(30)), max_new_tokens=8))
    with pytest.raises(ValueError):        # bigger than the whole pool
        s.submit(Request(rid=1, prompt=(1, 2, 3, 4), max_new_tokens=8))


def test_kv_bytes_per_token_yi_6b():
    # 2 (K, V) * 32 layers * 4 KV heads * 128 * 2 bytes = 64 KiB
    assert kv_bytes_per_token(configs.get_config("yi-6b")) == 64 * 1024


# ---------------------------------------------------------------------------
# Engine against the JAX engine
# ---------------------------------------------------------------------------
def _engines(num_layers, pool, max_batch, reqs):
    """Run the JAX and the port's engine on the same weights and requests;
    returns ((tokens, engine) for JAX, (tokens, engine) for the port)."""
    fields = dict(SV, num_layers=num_layers)
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    jeng = JServingEngine(jcfg, jparams, JSchedulerConfig(
        cache=JPagedCacheConfig(**pool), max_batch=max_batch))
    teng = ServingEngine(tcfg, tparams, SchedulerConfig(
        cache=PagedCacheConfig(**pool), max_batch=max_batch))
    jeng.submit_all([JRequest(**r) for r in reqs])
    teng.submit_all([Request(**r) for r in reqs])
    return (jeng.run(max_steps=500), jeng), (teng.run(max_steps=500), teng)


def test_staggered_arrivals_match_jax_engine():
    """The workload of test_serving.py::test_continuous_batching_matches_sequential:
    the port emits exactly the JAX engine's tokens and keeps the same stats."""
    rng = np.random.default_rng(3)
    specs = [(5, 6, 0), (8, 5, 1), (3, 7, 2), (11, 4, 4), (2, 8, 5)]
    reqs = [dict(rid=i, prompt=tuple(int(x) for x in rng.integers(0, 64, pl)),
                 max_new_tokens=mn, arrival=arr)
            for i, (pl, mn, arr) in enumerate(specs)]
    (jgot, jeng), (tgot, teng) = _engines(
        3, dict(num_blocks=32, block_size=4, max_blocks_per_seq=5), 3, reqs)
    assert sorted(tgot) == list(range(len(specs)))
    assert tgot == jgot
    assert teng.stats == jeng.stats
    assert teng.sched.alloc.used == 0


def test_preemption_under_block_pressure_matches_jax_engine():
    """A pool too small for all live contexts forces eviction; everything
    completes, the allocator drains, and the streams equal the JAX engine's."""
    reqs = [dict(rid=i, prompt=(1 + i, 2 + i, 3 + i, 4 + i), max_new_tokens=8,
                 arrival=0) for i in range(3)]
    (jgot, jeng), (tgot, teng) = _engines(
        2, dict(num_blocks=7, block_size=4, max_blocks_per_seq=4), 3, reqs)
    assert sorted(tgot) == [0, 1, 2]
    assert all(len(v) == 8 for v in tgot.values())
    assert teng.stats["preemptions"] > 0
    assert teng.sched.alloc.used == 0 and teng.sched.alloc.available == 7
    assert tgot == jgot and teng.stats == jeng.stats


def test_latency_summary_counts_finished_requests():
    tcfg = ModelConfig(**dict(SV, num_layers=1))
    from repro_torch.models import transformer as T
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(tcfg, params, SchedulerConfig(
        cache=PagedCacheConfig(num_blocks=16, block_size=4, max_blocks_per_seq=4),
        max_batch=2))
    eng.submit_all([Request(rid=i, prompt=(1, 2, 3), max_new_tokens=4, arrival=i)
                    for i in range(3)])
    eng.run(max_steps=50)
    lat = eng.latency_summary()
    assert lat["n_requests"] == 3
    assert set(lat["ttft_ms"]) == {"p50", "p95", "p99"} and lat["itl_ms"]["p50"] >= 0
    assert set(lat["queue_ms"]) == {"p50", "p95", "p99"} and lat["queue_ms"]["p50"] >= 0


def _tiny_engine(tracer=None, *, num_blocks=16, block_size=4, max_blocks=4, max_batch=2,
                 layers=1):
    from repro_torch.models import transformer as T
    tcfg = ModelConfig(**dict(SV, num_layers=layers))
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    return ServingEngine(tcfg, params, SchedulerConfig(
        cache=PagedCacheConfig(num_blocks=num_blocks, block_size=block_size,
                               max_blocks_per_seq=max_blocks),
        max_batch=max_batch), tracer=tracer)


def test_queue_stamps_and_the_engines_two_spans():
    """A request whose arrival step has come is seen at ``submit``; one
    submitted ahead of it when the engine reaches that step.  Its first
    admission is stamped once: a preemption's re-admission keeps the stamp,
    and every queue wait (admitted less seen) is >= 0.  The tracer holds
    only ``prefill`` and ``decode`` complete events, one a prefill call and
    one a decode step, each split into ``launch_ms`` and ``wait_ms`` within
    its duration."""
    tracer = Tracer()
    eng = _tiny_engine(tracer, num_blocks=7, max_blocks=4, max_batch=3, layers=2)
    now, later = (Request(rid=i, prompt=(1 + i, 2 + i, 3 + i, 4 + i), max_new_tokens=8,
                          arrival=a) for i, a in ((0, 0), (1, 2)))
    eng.submit(now)
    assert now.wall_visible is not None and now.wall_admitted is None
    reqs = [now, later, Request(rid=2, prompt=(3, 4, 5, 6), max_new_tokens=8, arrival=0)]
    eng.submit_all(reqs[1:])
    assert later.wall_visible is None
    first = {}
    for _ in range(200):
        if not eng.sched.has_work:
            break
        eng.step()
        if eng.t <= 2:
            assert later.wall_visible is None
        first.update({r.rid: r.wall_admitted for r in reqs
                      if r.wall_admitted is not None and r.rid not in first})
    assert eng.stats["preemptions"] > 0 and len(eng.finished) == 3
    assert {rid: r.wall_admitted for rid, r in eng.finished.items()} == first
    for r in eng.finished.values():
        assert r.wall_admitted >= r.wall_visible
    spans = [e for e in tracer.events if e["ph"] == "X"]
    assert {e["name"] for e in spans} == {"prefill", "decode"}
    assert sum(e["name"] == "decode" for e in spans) == eng.stats["decode_steps"]
    assert sum(e["name"] == "prefill" for e in spans) == eng.stats["prefill_calls"]
    for e in spans:
        a = e["args"]
        assert a["launch_ms"] >= 0 and a["wait_ms"] >= 0
        assert a["launch_ms"] + a["wait_ms"] <= e["dur"] / 1e3 + 1e-9


def test_prefill_args_count_the_pow2_padding():
    """Prompts of 5, 9 and 3 tokens at blocks of 4: rows pow2(3) = 4, the
    bucket 4 x pow2(3 blocks) = 16, so 64 slot tokens for 17 real ones."""
    tracer = Tracer()
    eng = _tiny_engine(tracer, num_blocks=32, max_blocks=8, max_batch=4)
    eng.submit_all([Request(rid=i, prompt=tuple(range(1, n + 1)), max_new_tokens=2)
                    for i, n in enumerate((5, 9, 3))])
    eng.step()
    (args,) = [e["args"] for e in tracer.events if e["name"] == "prefill"]
    assert (args["rows"], args["bucket"], args["real_tokens"], args["slot_tokens"]) == \
        (4, 16, 17, 64)
    assert eng.stats["prefill_tokens"] == 17


# ---------------------------------------------------------------------------
# Entry point and config registry
# ---------------------------------------------------------------------------
def test_serve_smoke_on_cpu(capsys):
    res = serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                      "--requests", "4", "--rate", "1.0", "--prompt-lens", "5,9",
                      "--max-new", "3,4", "--num-blocks", "32"])
    assert res["device"] == "cpu" and res["requests"] == 4
    assert res["emitted_tokens"] == 3 + 4 + 3 + 4
    assert res["prefill_calls"] >= 1 and res["decode_steps"] >= 3
    assert set(res["queue_ms"]) == {"p50", "p95", "p99"} and res["queue_ms"]["p50"] >= 0
    assert '"tok_per_s"' in capsys.readouterr().out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", configs.list_archs())
def test_configs_equal_jax_registry(arch, smoke):
    assert dataclasses.asdict(configs.get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
