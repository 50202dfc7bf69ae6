"""The comparison that decides ``correct`` fails what it must.  A whole
run is driven on the CPU at a small size, past the harness's look for a
card, with the timed path broken underneath: a training step that
returns its state unchanged, half of each batch left out (the mean over
the rest), a served token altered where the engine emits it, a decode
step whose cache writes are dropped.  (A one-card
cell has no exchange between cards to leave out.)  And the control, the
reference computed with its products in fp8 in the port's place, fails
the cell's limits.  The limits were set on the card at the cells' sizes
(PERF.md); the readings of sound runs grow as the widths shrink, so no
test here holds a sound small run to them."""
import time

import pytest
import torch

from bench.harness import compare, runner
from bench.reference import serve as ref_serve
from bench.reference import train as ref_train

TRAIN = ["granite-20b.train_layered", "yi-6b.train_long16k"]
SEED = 2 ** 36 + 5


def run(cell):
    r = runner.run_cell(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    return r["correct"], r["checks"]


def break_step(monkeypatch, wrap):
    from repro_torch.core import stepfn
    build = stepfn.build_train_step

    def broken(*a, **kw):
        return wrap(build(*a, **kw))
    monkeypatch.setattr(stepfn, "build_train_step", broken)


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(tiny, monkeypatch, name):
    def wrap(step):
        def frozen(storage, opt, batch):
            _, metrics = step.grad_fn(storage, batch)
            return storage, opt, dict(metrics, lr=torch.zeros(()), grad_norm=torch.zeros(()))
        return frozen
    break_step(monkeypatch, wrap)
    ok, checks = run(tiny(name))
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_fails(tiny, monkeypatch, name):
    def wrap(step):
        def half(storage, opt, batch):
            return step(storage, opt, {k: v[:, :v.shape[1] // 2] if v.shape[1] > 1 else v[:1]
                                       for k, v in batch.items()})
        return half
    break_step(monkeypatch, wrap)
    ok, checks = run(tiny(name))
    assert not ok, checks


def test_sound_serving_run_is_correct(tiny):
    ok, checks = run(tiny("granite-20b.serve_code"))
    assert ok, checks


def test_dropped_cache_writes_fail(tiny):
    """Decode steps that keep none of their K and V writes: the tokens they
    serve barely move at this size, the rows the cache holds do."""
    from bench.controls import drop_cache_writes
    with drop_cache_writes():
        ok, checks = run(tiny("granite-20b.serve_code"))
    assert not ok, checks
    assert checks["kv_gap"]["value"] > 0.5, checks


def test_altered_token_fails(tiny, monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    emit = ServingEngine._emit

    def altered(self, req, tok):
        if len(req.generated) == 1:
            tok = (tok + 1) % self.cfg.vocab_size
        emit(self, req, tok)
    monkeypatch.setattr(ServingEngine, "_emit", altered)
    ok, checks = run(tiny("granite-20b.serve_code"))
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_fp8_control_fails_a_training_cell(tiny, name):
    cell = tiny(name)
    w = cell.workload
    args = (cell.config, w["optimizer"], cell.traffic, SEED, w["check"]["steps"], "cpu")
    ref = ref_train.run(*args)
    ctl = ref_train.run(*args, prec="fp8")
    ok, checks = compare.checks(compare.train_numbers(ctl, ref), w["check"]["limits"])
    assert not ok, checks


def test_fp8_control_fails_the_serving_cell(tiny):
    """At granite's head dim and MQA, two layers of width 2048: the widest
    gap of the token the control puts first, over prompts continued by the
    fp32 reference's own argmax, passes the cell's limit on every seed, as it
    does at the cell's size on the card; and so does the gap between the
    control's K and V rows and the reference's."""
    cell = tiny("granite-20b.serve_code")
    conf = dict(cell.config, hidden_size=2048, num_hidden_layers=2, head_dim=128,
                num_attention_heads=16, intermediate_size=8192, vocab_size=4096)
    limit = cell.workload["check"]["limits"]["logit_gap"]
    kv_limit = cell.workload["check"]["limits"]["kv_gap"]
    worst, kv_worst = [], []
    for seed in (5, 6, 7):
        g = torch.Generator().manual_seed(seed)
        samples = [(torch.randint(0, 4096, (n,), generator=g).numpy(), [0] * 16)
                   for n in (40, 64, 90, 120, 50, 70)]
        for _ in range(2):       # greedy continuations of the fp32 reference
            z = ref_serve.served_logits(conf, seed, samples, "cpu")["fp32"]
            samples = [(p, [int(t) for t in zz.argmax(-1)]) for (p, _), zz in zip(samples, z)]
        z = ref_serve.served_logits(conf, seed, samples, "cpu", ("fp32", "fp8"))
        firsts = [zz.argmax(-1).tolist() for zz in z["fp8"]]
        worst.append(max(ref_serve.gaps(z["fp32"], firsts)))
        kv_worst.append(max(g for g, _ in z["kv"]["fp8"]))
    assert min(worst) > limit, (worst, limit)
    assert min(kv_worst) > kv_limit, (kv_worst, kv_limit)
