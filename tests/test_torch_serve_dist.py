"""Serving over a data x model grid of processes (gloo, on the CPU) against
the JAX package's single-device chains, with its kernels off, and against
the port's own one-rank run.

The cases of ``tests/test_serve_distributed.py`` (whose mesh versions fail
inside JAX here: the vma error with kernels on, a ``ShardingTypeError`` in
its prefill with them off) at 2x2: dense-cache decode for GQA, MQA with the
KV head replicated over the model group and MoE with its experts over the
data group (all-to-all); a prefill and one decode step; paged decode from an
empty pool, a MoE paged decode, a ragged paged prefill and 3 decode steps;
sequence-sharded decode over the data group, from an empty cache and from a
prefilled one cut into shards.  At 1x2: zamba2-7b, rwkv6-3b, gemma2-9b (its
sliding-window rings wrap) and dbrx-132b (every expert local, the hidden dim
split) smoke, prefill and 4 decode steps; a sequence-sharded decode over a
seq group of one.

Each case's weights are the JAX tree, carried to each rank's block by
``convert.params_from_numpy(..., axis=)``; its tokens are fed to both sides (not
the argmax).  Every call's logits are held to JAX's at 3e-3 (the mirrored
test's tolerance) and to the port's one-rank run at 1e-4, and its collective
counts are exact.  Every case of a mesh runs in one spawn
(``tests/torch_serve_ranks.py``); both spawns start with the module's
first group test and the JAX references are computed meanwhile.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core import stepfn as jstepfn
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.models.common import ModelConfig as JModelConfig
from repro.serving import steps as jsteps
from repro.serving.cache import PagedCacheConfig as JPagedCacheConfig
from repro.serving.cache import init_paged_cache as jinit_paged_cache
from repro_torch import configs, tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.core.dist import LOCAL, AxisCtx
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.serving import steps
from repro_torch.serving.cache import local_kv_heads
import torch_serve_ranks
from test_torch_dist import Spawn

WORKER = pathlib.Path(__file__).resolve().parent / "torch_serve_ranks.py"
AX = JAxisCtx()
JAX_TOL = 3e-3          # tests/test_serve_distributed.py's rtol and atol
PORT_TOL = 1e-4         # the port's group run against its one-rank run

# tests/test_serve_distributed.py's CFG and its two variants
CFG = dict(name="sd", arch_type="dense", num_layers=3, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32",
           kernels=False)
DENSE = {"gqa": CFG, "mqa-replicated-kv": dict(CFG, name="sd-mqa", num_kv_heads=1),
         "moe-ep": dict(CFG, name="sd-moe", num_experts=2, experts_per_token=2)}
FAMILIES = ("zamba2-7b", "rwkv6-3b", "gemma2-9b", "dbrx-132b")
PAGED = dict(num_blocks=8, block_size=4, max_blocks_per_seq=2)
PAGED_PREFILL = dict(num_blocks=12, block_size=4, max_blocks_per_seq=3)
PROMPT_LENS = np.array([8, 5, 3, 6], np.int32)


def _cfg(name: str) -> dict:
    if name in DENSE:
        return DENSE[name]
    c = dataclasses.asdict(configs.get_config(name, smoke=True))
    assert dataclasses.asdict(jconfigs.get_config(name, smoke=True)) == c
    return dict(c, kernels=False)


def _tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _case(i: int, name: str, kind: str, **kw) -> dict:
    """A case of config ``name``: the JAX weights from key ``i``."""
    cfg = _cfg(name)
    params = jax.tree.map(np.asarray, JT.init_params(JModelConfig(**cfg), jax.random.PRNGKey(i)))
    return dict(kind=kind, cfg=cfg, params=params, **kw)


def _cases() -> dict:
    """mesh -> {case id: case}."""
    v = CFG["vocab_size"]
    mesh22 = {f"decode-{n}": _case(i, n, "dense", tokens=_tokens(i, (4, 8), v), max_seq=8)
              for i, n in enumerate(DENSE)}
    mesh22["prefill-gqa"] = _case(0, "gqa", "dense", tokens=_tokens(10, (4, 9), v),
                                  max_seq=10, prefill=8)
    for i, n in enumerate(("gqa", "moe-ep")):
        mesh22[f"paged-decode-{n}"] = _case(
            20 + i, n, "paged", pcfg=PAGED, tokens=_tokens(20 + i, (4, 8), v),
            tables=np.arange(8, dtype=np.int32).reshape(4, 2))
    mesh22["paged-prefill-gqa"] = _case(
        30, "gqa", "paged", pcfg=PAGED_PREFILL, prompt=_tokens(30, (4, 8), v),
        lens=PROMPT_LENS, tokens=_tokens(31, (4, 3), v),
        tables=np.arange(12, dtype=np.int32).reshape(4, 3))
    mesh22["seq-gqa"] = _case(40, "gqa", "dense", tokens=_tokens(40, (2, 8), v), max_seq=8,
                              seq_shard=True)
    # a prefilled cache (the port's one-rank prefill of 6 tokens), cut into
    # shards by stepfn.shard_cache, then 2 sequence-sharded decode steps
    mesh22["seq-prefix-gqa"] = _case(41, "gqa", "dense", tokens=_tokens(41, (2, 8), v),
                                     max_seq=8, seq_shard=True, from_prefill=6)
    mesh12 = {f"family-{n}": _case(50 + i, n, "dense", max_seq=12, prefill=8,
                                   tokens=_tokens(50 + i, (2, 12), 512))
              for i, n in enumerate(FAMILIES)}
    mesh12["seq-one-shard-gqa"] = _case(60, "gqa", "dense", tokens=_tokens(60, (2, 8), v),
                                        max_seq=8, seq_shard=True)
    return {"2x2": mesh22, "1x2": mesh12}


def _whole_prefix_cache(case: dict) -> dict:
    """The port's one-rank cache after a prefill of the case's first
    ``from_prefill`` tokens (numpy leaves)."""
    cfg = ModelConfig(**case["cfg"])
    params = params_from_numpy(cfg, case["params"])
    cache = T.init_cache(cfg, case["tokens"].shape[0], case["max_seq"])
    prefix = torch.from_numpy(case["tokens"][:, :case["from_prefill"]])
    _, cache = T.prefill_step(cfg, params, cache, {"tokens": prefix})
    return {k: (v if k == "pos" else v.numpy()) for k, v in cache.items()}


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """Both meshes' ranks, started now; the cases by mesh."""
    tmp = tmp_path_factory.mktemp("serve_dist")
    cases = _cases()
    for c in cases["2x2"].values():
        if "from_prefill" in c:
            c["cache"] = _whole_prefix_cache(c)
    runs = {mesh: Spawn(tmp, f"serve{mesh}", tuple(int(n) for n in mesh.split("x")),
                        list(cs.values()), None, None, worker=WORKER)
            for mesh, cs in cases.items()}
    yield cases, runs
    for r in runs.values():
        r.kill()


def _jax_dense(case: dict) -> np.ndarray:
    """JAX's single-device chain: [B, calls, V]."""
    jcfg = JModelConfig(**case["cfg"])
    params = jax.tree.map(jnp.asarray, case["params"])
    toks = jnp.asarray(case["tokens"])
    n_pre = case.get("prefill", 0) or case.get("from_prefill", 0)
    cache = JT.init_cache(jcfg, toks.shape[0], case["max_seq"], AX)
    out = []
    if n_pre:
        lg, cache = jax.jit(lambda p, c, t: JT.prefill_step(jcfg, p, c, {"tokens": t}, AX))(
            params, cache, toks[:, :n_pre])
        if case.get("prefill"):
            out.append(lg)
    dec = jax.jit(lambda p, c, t: JT.decode_step(jcfg, p, c, t, AX))
    for t in range(n_pre, toks.shape[1]):
        lg, cache = dec(params, cache, toks[:, t])
        out.append(lg)
    return np.stack([np.asarray(o) for o in out], 1)


def _jax_paged(case: dict) -> np.ndarray:
    jcfg = JModelConfig(**case["cfg"])
    params = jax.tree.map(jnp.asarray, case["params"])
    pool = jinit_paged_cache(jcfg, JPagedCacheConfig(**case["pcfg"]), AX)
    tables, toks = jnp.asarray(case["tables"]), jnp.asarray(case["tokens"])
    lens = jnp.zeros(toks.shape[0], jnp.int32)
    out = []
    if "prompt" in case:
        lens = jnp.asarray(case["lens"])
        prefill = jsteps.build_paged_prefill_fn(jcfg, AX, use_pallas=False, donate=False)
        lg, pool = prefill(params, pool, {"tokens": jnp.asarray(case["prompt"]), "lens": lens},
                           tables)
        out.append(lg)
    dec = jsteps.build_paged_decode_fn(jcfg, AX, use_pallas=False, donate=False)
    for i in range(toks.shape[1]):
        lg, pool = dec(params, pool, tables, lens + i, toks[:, i])
        out.append(lg)
    return np.stack([np.asarray(o) for o in out], 1)


@pytest.fixture(scope="module")
def references(spawns):
    """case id -> (JAX's logits, the port's one-rank logits), computed while
    the ranks run."""
    cases, _ = spawns
    out = {}
    for cs in cases.values():
        for cid, c in cs.items():
            jax_fn = _jax_paged if c["kind"] == "paged" else _jax_dense
            local = torch_serve_ranks.RUNNERS[c["kind"]](None, c, LOCAL)["logits"]
            out[cid] = (jax_fn(c), local)
    return out


def _want_counts(case: dict, mesh: str, call: int) -> dict:
    """(group, op) -> calls of call ``call`` of a case: the model group's
    all-reduces (the embedding, each attention or recurrent block's output,
    each MLP or MoE), one all-gather of the logits, two all-to-alls an MoE
    layer with its experts over the data group, the sequence-sharded
    softmax's max, sum and weighted sum on each attention layer."""
    cfg = ModelConfig(**case["cfg"])
    ndata = int(mesh.split("x")[0])
    L = cfg.num_layers
    n_sh = sum(cfg.attn_layer_flags()) if cfg.hybrid_attn_period > 0 else 0
    reduces = {"mamba": 1 + L + 2 * n_sh, "rwkv": 1 + 2 * L}.get(cfg.block_kind, 1 + 2 * L)
    want = {("model", "all_reduce"): reduces, ("model", "all_gather"): 1}
    if cfg.is_moe and ndata > 1:
        want[("expert", "all_to_all")] = 2 * L
    decoding = call >= (1 if case.get("prefill") or "prompt" in case else 0)
    if case.get("seq_shard") and decoding:
        want[("seq", "all_reduce")] = 3 * L
    return want


def _assemble(case: dict, results: list, cid: str) -> np.ndarray:
    """The mesh's logits: every model rank of a data row the same, bit for
    bit; the rows of the data ranks in order, or under ``seq_shard`` and on
    the paged pool (every rank serves every row) every rank the same."""
    rows = {}
    every_rank = case.get("seq_shard") or case["kind"] == "paged"
    for r in results:
        got = r["results"][cid]["logits"]
        key = 0 if every_rank else r["data_index"]
        if key in rows:
            assert np.array_equal(got, rows[key]), f"{cid}: ranks disagree"
        rows[key] = got
    return np.concatenate([rows[k] for k in sorted(rows)], 0)


MESH_IDS = {"2x2": ["decode-gqa", "decode-mqa-replicated-kv", "decode-moe-ep", "prefill-gqa",
                    "paged-decode-gqa", "paged-decode-moe-ep", "paged-prefill-gqa", "seq-gqa",
                    "seq-prefix-gqa"],
            "1x2": [f"family-{n}" for n in FAMILIES] + ["seq-one-shard-gqa"]}


@pytest.mark.parametrize("mesh,cid", [(m, c) for m, ids in MESH_IDS.items() for c in ids])
def test_group_serving_matches_single_device(spawns, references, mesh, cid):
    cases, runs = spawns
    case = cases[mesh][cid]
    idx = list(cases[mesh]).index(cid)
    results = [dict(r, results={cid: r["results"][idx]}) for r in runs[mesh].result()]
    got = _assemble(case, results, cid)
    want_jax, want_port = references[cid]
    assert got.shape == want_jax.shape, (got.shape, want_jax.shape)
    np.testing.assert_allclose(got, want_port, rtol=PORT_TOL, atol=PORT_TOL,
                               err_msg=f"{cid}: group vs the port's one rank")
    np.testing.assert_allclose(got, want_jax, rtol=JAX_TOL, atol=JAX_TOL,
                               err_msg=f"{cid}: group vs JAX's single device")
    for r in results:
        res = r["results"][cid]
        for call, counts in enumerate(res["counts"]):
            assert {k: v[0] for k, v in counts.items()} == _want_counts(case, mesh, call), \
                (cid, r["rank"], call, counts)
            rows = got.shape[0] if (case.get("seq_shard") or case["kind"] == "paged") \
                else got.shape[0] // int(mesh.split("x")[0])
            assert counts[("model", "all_gather")][1] == rows * got.shape[-1] * 4
        if case["kind"] == "paged":
            assert res["pool_heads"] == local_kv_heads(ModelConfig(**case["cfg"]), 2)


# ---------------------------------------------------------------------------
# In one process: the layouts against the JAX package's, the seq group of
# none, the weights' and the cache's blocks
# ---------------------------------------------------------------------------
SPEC_ARCHS = ("yi-6b", "gemma2-9b", "granite-20b", "zamba2-7b", "rwkv6-3b", "dbrx-132b",
              "arctic-480b")
# a rank of a 2x2 grid without process groups: the layouts read only the
# groups' presence, the sizes and the indices
GRID22 = AxisCtx(data=object(), model=object(), tp=2, ndata=2, data_index=1, model_index=1)


def _spec(sp) -> tuple:
    """A JAX PartitionSpec as the port's tuple (a one-axis tuple entry, the
    data axis of a mesh without pods, as its name)."""
    return tuple((e[0] if len(e) == 1 else (e or None)) if isinstance(e, tuple) else e
                 for e in sp)


def _flat_specs(specs: dict) -> dict:
    return {p: _spec(sp) for p, sp in tree.leaves_with_path(
        {k: v for k, v in specs.items() if k != "shared" or v})}


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_layouts_match_jax(mesh22, arch):
    """``serve_param_specs``, ``cache_specs`` (both ways) and
    ``paged_cache_specs`` at 2x2 are the JAX package's."""
    jcfg, tcfg = jconfigs.get_config(arch, smoke=True), configs.get_config(arch, smoke=True)
    jaxis = jstepfn.axis_ctx(mesh22)
    jflat = lambda t: _flat_specs(jax.tree.map(  # noqa: E731
        lambda s: tuple(s), t, is_leaf=lambda x: isinstance(x, P)))
    assert _flat_specs(T.serve_param_specs(tcfg, 2)) == jflat(JT.serve_param_specs(jcfg, 2))
    for seq in (False, True):
        got = _flat_specs(stepfn.cache_specs(tcfg, GRID22, seq_shard=seq))
        assert got == jflat(jstepfn.cache_specs(jcfg, jaxis, seq_shard=seq)), seq
    if tcfg.block_kind == "attn":
        assert steps.paged_cache_specs(tcfg, GRID22) == {
            k: _spec(v) for k, v in jsteps.paged_cache_specs(jcfg, jaxis).items()}


def test_seq_shard_without_a_data_group_is_one_shard():
    """``seq_shard`` with no data group: one shard of the whole cache, as
    the JAX package's data axis of size 1 gives; the decode equals the
    unsharded one bit for bit."""
    cfg = ModelConfig(**CFG)
    assert stepfn.serve_axis(cfg, LOCAL, seq_shard=True) is LOCAL
    assert stepfn.cache_specs(cfg, seq_shard=True) == stepfn.cache_specs(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(3, (2, 8), CFG["vocab_size"]))
    out = []
    for seq in (False, True):
        serve = stepfn.build_serve_step(cfg, seq_shard=seq)
        cache = T.init_cache(cfg, 2, 8, stepfn.serve_axis(cfg, LOCAL, seq_shard=seq))
        assert cache["k"].shape[3] == 8
        lg = [serve(params, cache, toks[:, t])[0] for t in range(8)]
        out.append(torch.stack(lg))
    assert torch.equal(out[0], out[1])


def test_decode_past_an_unsharded_cache_raises():
    """A decode step past the end of an unsharded cache fails, as the JAX
    package's has no shard to leave the write to: only a shard of a seq
    group skips a position that it does not hold."""
    cfg = ModelConfig(**CFG)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(4, (2, 5), CFG["vocab_size"]))
    serve = stepfn.build_serve_step(cfg)
    cache = T.init_cache(cfg, 2, 4)
    for t in range(4):
        serve(params, cache, toks[:, t])
    with pytest.raises(IndexError):
        serve(params, cache, toks[:, 4])


@pytest.mark.parametrize("arch", ["yi-6b", "dbrx-132b", "zamba2-7b"])
def test_serving_weights_are_blocks(arch):
    """``transformer.init_params`` at each position of a 2x2 grid holds the
    blocks of its whole weights for the same seed, and
    ``convert.params_from_numpy`` cuts the same blocks of a numpy
    tree (yi-6b: KV heads replicated at tp 2; dbrx: 2 of 4 experts a data
    rank, their hidden dim halved; zamba2: the shared block)."""
    cfg = configs.get_config(arch, smoke=True)
    whole = T.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tree_np = _numpy_tree(whole)
    specs = T.serve_param_specs(cfg, 2)
    for d in range(2):
        for m in range(2):
            axis = dataclasses.replace(GRID22, data_index=d, model_index=m)
            a = T.init_params(cfg, torch.Generator().manual_seed(5), "cpu", axis)
            b = params_from_numpy(cfg, tree_np, axis=axis)
            for (name, x), (_, y), (_, w) in zip(T.named_parameters(a), T.named_parameters(b),
                                                 T.named_parameters(whole)):
                path = name.split(".")
                sp = _spec_at(specs, path)
                want = zp.block_of(w, sp, axis)
                assert torch.equal(x, want), (name, d, m)
                assert torch.equal(y, want.to(y.dtype)), (name, d, m)
    if cfg.is_moe:
        assert a["layers"][0]["moe"]["w_up"].shape == (2, cfg.d_model, cfg.d_ff // 2)


def _numpy_tree(params: dict) -> dict:
    """The port's parameters in the JAX tree's layout (layers stacked), numpy."""
    out = {k: tree.tree_map(lambda t: t.float().numpy(), v) for k, v in params.items()
           if k != "layers"}
    out["layers"] = tree.tree_map(lambda *ls: np.stack([t.float().numpy() for t in ls]),
                                  *params["layers"])
    return out


def _spec_at(specs: dict, path: list) -> tuple:
    node = specs
    if path[0] == "layers":
        node, path = specs["layers"], path[2:]
        for k in path:
            node = node[k]
        return node[1:]
    for k in path:
        node = node[k]
    return node


def test_shard_cache_cuts_rows_heads_and_sequence():
    """``stepfn.shard_cache``: rows over the data group, KV heads over the
    model group (a replicated KV head: this rank's GQA group's head), the
    sequence over the data group under ``seq_shard``."""
    cfg = ModelConfig(**dict(CFG, num_heads=4, num_kv_heads=2))
    whole = T.init_cache(cfg, 4, 8)
    whole["k"].copy_(torch.arange(whole["k"].numel(), dtype=torch.float32).view_as(whole["k"]))
    whole["pos"] = 5
    for d in range(2):
        ax = dataclasses.replace(GRID22, data_index=d, model_index=1)
        got = stepfn.shard_cache(cfg, whole, ax)
        assert torch.equal(got["k"], whole["k"][:, 2 * d:2 * d + 2, 1:2]) and got["pos"] == 5
        got = stepfn.shard_cache(cfg, whole, ax, seq_shard=True)
        assert torch.equal(got["k"], whole["k"][:, :, 1:2, 4 * d:4 * d + 4])
    for m in range(4):                       # tp 4 over 2 KV heads: each rank's copy
        ax = AxisCtx(model=object(), tp=4, model_index=m)
        got = stepfn.shard_cache(cfg, whole, ax)
        assert torch.equal(got["k"], whole["k"][:, :, m // 2:m // 2 + 1])
