"""The inputs a run is given: reproducible from the seed, and drawn from
the distributions the traffic files state."""
import statistics

import numpy as np
import torch

from bench.harness import inputs, spec

BIG = 2 ** 33 + 12345          # seeds above 32 bits


def code_traffic():
    return spec.load_cell("granite-20b.serve_code").traffic


def test_weights_repeat_from_the_seed_and_differ_between_seeds():
    conf = spec.load_cell("yi-6b.train_long16k").config
    conf = dict(conf, hidden_size=32, num_attention_heads=2, num_key_value_heads=1,
                head_dim=16, intermediate_size=48, vocab_size=64)
    a = inputs.layer_weights(conf, BIG, 1, "cpu")
    b = inputs.layer_weights(conf, BIG, 1, "cpu")
    c = inputs.layer_weights(conf, BIG + 1, 1, "cpu")
    d = inputs.layer_weights(conf, BIG, 2, "cpu")
    assert torch.equal(a["attn"]["wq"], b["attn"]["wq"])
    assert not torch.equal(a["attn"]["wq"], c["attn"]["wq"])
    assert not torch.equal(a["attn"]["wq"], d["attn"]["wq"])
    # N(0, 1/fan_in)
    w = inputs.layer_weights(dict(conf, hidden_size=256), BIG, 0, "cpu")["mlp"]["w_up"]
    assert abs(float(w.std()) * 16 - 1) < 0.05
    bf = inputs.layer_weights(conf, BIG, 1, "cpu", dtype=torch.bfloat16)
    assert torch.equal(bf["attn"]["wq"], a["attn"]["wq"].to(torch.bfloat16))
    assert bf["ln1"]["scale"].dtype == torch.float32


def test_train_batches_repeat_and_every_row_differs():
    t = spec.load_cell("granite-20b.train_layered").traffic
    t = dict(t, seq_len=64)
    a = inputs.train_batch(t, 1000, BIG, 3, "cpu")
    assert torch.equal(a["tokens"], inputs.train_batch(t, 1000, BIG, 3, "cpu")["tokens"])
    assert a["tokens"].shape == (4, 2, 64)
    rows = a["tokens"].reshape(8, 64)
    assert len({tuple(r.tolist()) for r in rows}) == 8
    b = inputs.train_batch(t, 1000, BIG, 4, "cpu")
    assert not torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"][..., :-1], a["tokens"][..., 1:])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 1000


def test_requests_repeat_from_the_seed():
    t = code_traffic()
    a = inputs.requests(t, 49152, BIG, 40.0)
    b = inputs.requests(t, 49152, BIG, 40.0)
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))


def test_every_seed_gets_the_same_work():
    t = code_traffic()
    a = inputs.requests(t, 49152, 7, 40.0)
    b = inputs.requests(t, 49152, BIG, 40.0)
    assert [len(r["prompt"]) for r in a] == [len(r["prompt"]) for r in b]
    assert [r["max_new"] for r in a] == [r["max_new"] for r in b]
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert not np.array_equal(a[0]["prompt"], b[0]["prompt"])


def test_requests_follow_the_stated_distributions():
    t = code_traffic()
    rs = inputs.requests(t, 49152, BIG, 50.0)
    assert len(rs) == round(t["rate_per_s"] * 50.0)
    due = [r["due"] for r in rs]
    assert due[0] == 0.0 and all(0 <= d < 50.0 for d in due) and due == sorted(due)
    gaps = np.diff(due)
    # exponential gaps: mean about 1 / rate, standard deviation about the mean
    assert abs(gaps.mean() * t["rate_per_s"] - 1) < 0.05
    assert abs(gaps.std() / gaps.mean() - 1) < 0.15
    p = np.array([len(r["prompt"]) for r in rs])
    o = np.array([r["max_new"] for r in rs])
    assert p.min() >= 256 and p.max() <= 4096 and o.min() >= 8 and o.max() <= 64
    assert abs(np.median(p) - t["prompt"]["median"]) <= 40
    assert abs(np.median(o) - t["output"]["median"]) <= 1
    logs = np.log(p[(p > 256) & (p < 4096)])
    assert abs(statistics.stdev(logs) - t["prompt"]["sigma"]) < 0.1


def test_sample_holds_the_longest_and_enough_tokens():
    lengths = [100, 900, 300, 400, 50]
    served = [10, 5, 8, 20, 30]
    s = inputs.sample_indices(BIG, lengths, served, 25)
    assert 1 in s and sum(served[i] for i in s) >= 25
    assert s == inputs.sample_indices(BIG, lengths, served, 25)
    assert inputs.sample_indices(BIG, lengths, served, 10 ** 6) == [0, 1, 2, 3, 4]
