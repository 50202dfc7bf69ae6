"""The reference against the port's plain path (its kernels' plain
versions, on the CPU, in fp32) on the same weights and tokens, for a
granite-like and a Yi-like stack at smoke sizes."""
import dataclasses

import pytest
import torch

from bench.harness import inputs, spec
from bench.reference import model as ref
from bench.reference import serve as ref_serve
from bench.reference import train as ref_train

CELLS = ["granite-20b.train_layered", "yi-6b.train_long16k"]


def port_params(conf, seed):
    outer = inputs.outer_weights(conf, seed, "cpu")
    return dict(outer, layers=[inputs.layer_weights(conf, seed, l, "cpu")
                               for l in range(conf["num_hidden_layers"])])


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_gradients_match_the_port(tiny, name):
    from repro_torch.models import transformer as T
    cell = tiny(name)
    conf = dict(cell.config, dtype="float32")
    cfg = dataclasses.replace(spec.model_config(conf), dtype="float32")
    seed, S = 2 ** 40 + 3, 32
    batch = inputs.train_batch(dict(cell.traffic, seq_len=S), conf["vocab_size"], seed, 0, "cpu")
    tokens, labels = batch["tokens"].reshape(-1, S), batch["labels"].reshape(-1, S)

    p = port_params(conf, seed)
    leaves = [p["embed"], p["head"], p["layers"][1]["attn"]["wq"], p["layers"][0]["mlp"]["w_down"],
              p["layers"][0]["ln1"]["scale"]]
    for t in leaves:
        t.requires_grad_()
    loss, _ = T.loss_fn(cfg, p, {"tokens": tokens, "labels": labels,
                                 "mask": torch.ones_like(tokens)}, remat=False)
    want = torch.autograd.grad(loss / tokens.numel(), leaves)

    r = ref_train.initial_params(conf, seed, "cpu")
    rl = [r["embed"], r["head"], r["layers"][1]["attn"]["wq"], r["layers"][0]["mlp"]["w_down"],
          r["layers"][0]["ln1"]["scale"]]
    for t in rl:
        t.requires_grad_()
    tables = ref.rope_tables(conf, S, "cpu")
    total = sum(ref.sequence_nll(conf, r, tk, lb, "fp32", tables)
                for tk, lb in zip(tokens, labels))
    got = torch.autograd.grad(total / tokens.numel(), rl)
    assert float(total.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["granite-20b.serve_code"] + CELLS)
def test_served_logits_match_the_port(tiny, name):
    from repro_torch.models import transformer as T
    from repro_torch.models.common import lm_logits
    cell = tiny(name)
    conf = dict(cell.config, dtype="float32")
    cfg = dataclasses.replace(spec.model_config(conf), dtype="float32")
    seed = 99
    prompt = torch.randint(0, conf["vocab_size"], (20,), generator=torch.Generator().manual_seed(1))
    served = [3, 7, 11, 5]
    seq = torch.tensor(prompt.tolist() + served[:-1])[None]
    p = port_params(conf, seed)
    with torch.no_grad():
        x, _ = T.forward(cfg, p, {"tokens": seq}, remat=False)
        want = lm_logits(cfg, p["head"], x)[0, len(prompt) - 1:]
    got = ref_serve.served_logits(conf, seed, [(prompt.numpy(), served)], "cpu")["fp32"][0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    gaps = ref_serve.gaps([want], [want.argmax(-1).tolist()])
    assert gaps == [0.0]


def test_blocked_attention_matches_dense_with_gradients():
    torch.manual_seed(0)
    S, H, Hkv, hd = 300, 4, 2, 8
    q = torch.randn(S, H, hd, dtype=torch.float64, requires_grad=True)
    k = torch.randn(S, Hkv, hd, dtype=torch.float64, requires_grad=True)
    v = torch.randn(S, Hkv, hd, dtype=torch.float64, requires_grad=True)
    old = ref._block
    ref._block = lambda h, s: 64          # several blocks
    try:
        out = ref.Attention.apply(q, k, v, "fp32")
    finally:
        ref._block = old
    ke, ve = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    s = torch.einsum("qhd,khd->hqk", q, ke) * hd ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("hqk,khd->qhd", s.softmax(-1), ve)
    torch.testing.assert_close(out, want)
    g = torch.randn_like(out)
    torch.testing.assert_close(torch.autograd.grad(out, (q, k, v), g),
                               torch.autograd.grad(want, (q, k, v), g))


def test_fp8_control_rounds_every_product():
    a = torch.randn(16, 16)
    assert not torch.equal(ref.mm(a, a, "fp8"), a @ a)
    assert torch.equal(ref.mm(a, a, "fp32"), a @ a)
