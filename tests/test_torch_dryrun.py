"""The dry run (``core/roofline.py`` ``Costs`` / ``analyze``,
``launch/dryrun.py``) against the JAX package's (``repro/core/roofline.py``,
``repro/launch/dryrun.py``).

One rank's step runs on ``meta`` tensors over a fake process group
(``core/dist.py:fake_grid``); the JAX side is built as its ``run_one``
builds it, from ``repro.launch.dryrun``'s ``storage_sds`` / ``params_sds`` /
``cache_sds`` / ``input_specs`` with kernels off, on the tests' meshes, and
traced only.  Each case holds:

- argument bytes: exactly the per-device bytes of JAX's inputs (their
  shardings' ``shard_shape``), less the 4 bytes of JAX's cache position,
  which the port keeps as a Python int;
- dot flops: exact for the dense configs once the attention is counted as
  the walk counts JAX's kernels-off attention (the port's count leaves the
  flash attention's work out; the walk counts 8 products of ``[S, S, hd]``
  a layer and micro-batch of a train step, the forward's 2, the
  recompute's 2 and the backward's 4, and 2 of a prefill), within the
  recorded gaps for MoE and RWKV-6, and for the hybrid exactly the pure
  Mamba stack's gap once JAX's branches are weighted by the layers that ran;
- wire bytes: exact, calls and bytes, where the ops match (the ZeRO
  all-gathers, reduce-scatters and all-to-alls on ``data`` and ``pod``, the
  checkpoints' all-gathers on ``model``, the decode softmax's reductions);
  the all-reduces at their reckoned difference (ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import configs as jconfigs
from repro.configs import paper_x as jpaper_x
from repro.core import roofline as jroofline
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.data import synthetic as jsynthetic
from repro.optim.adam import AdamConfig as JAdamConfig

from repro_torch import configs as pconfigs
from repro_torch.configs import paper_x
from repro_torch.core import dist as D
from repro_torch.core import roofline
from repro_torch.data import synthetic
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun

META = torch.device("meta")

# small shapes, added to both packages' SHAPES
TINY = {"t_train": {"kind": "train", "seq": 64, "batch": 4},
        "t_prefill": {"kind": "prefill", "seq": 64, "batch": 4},
        "t_decode": {"kind": "decode", "seq": 64, "batch": 4},
        "t_long": {"kind": "decode_long", "seq": 64, "batch": 2}}


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun``: importing it sets ``XLA_FLAGS`` to 512
    devices, so the backend is brought up first and the variable restored
    at once (nothing later in the worker inherits it)."""
    jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    try:
        from repro.launch import dryrun as jd
    finally:
        mp.undo()
    return jd


@pytest.fixture
def tiny(jdry, monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(jdry.SHAPES, k, v)
        monkeypatch.setitem(dryrun.SHAPES, k, v)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# (a) Costs and analyze (tests/test_roofline.py's cases)
# ---------------------------------------------------------------------------
def test_dot_flops_exact():
    c = roofline.analyze(lambda a, b: a @ b, _meta(8, 16), _meta(16, 32))
    assert c.dot_flops == 2 * 8 * 16 * 32


def test_python_loop_multiplies():
    """The counterpart of the walk's scan: a loop of 5 layers counts 5x."""
    def f(x, w):
        for l in range(w.shape[0]):
            x = torch.tanh(x @ w[l])
        return x
    c = roofline.analyze(f, _meta(4, 8), _meta(5, 8, 8))
    assert c.dot_flops == 5 * 2 * 4 * 8 * 8


def test_collective_axes_and_wire_bytes():
    """An all-gather on ``data`` and an all-reduce on ``model`` of a
    ``[4, 8]`` fp32 tensor on a fake 2x2 grid: the model wire is 128 B,
    JAX's figure, the data wire (n-1)/n of the gathered 128 B."""
    def f(x, axis):
        g = torch.empty((4, 8), device=META)
        axis.all_gather(g, x, "data")
        axis.all_reduce(g, "model")
        return g
    with D.fake_grid(2, 2) as axis:
        c = roofline.analyze(f, _meta(2, 8), axis, axis=axis)
    assert dict(c.coll_bytes) == {"data": 64.0, "model": 128.0}
    assert dict(c.coll_counts) == {("data", "all_gather"): 1, ("model", "all_reduce"): 1}
    # in and out of each: the gather reads 64 B and writes 128, the
    # all-reduce reads and writes 128
    assert c.hbm_bytes == 64 + 128 + 2 * 128
    assert not tdist.is_initialized()


def test_dominant_term_under_h100_constants():
    c = roofline.Costs(dot_flops=1e15, hbm_bytes=1.0)
    assert c.dominant() == "compute"
    assert c.compute_s() == 1e15 / 989e12
    c = roofline.Costs(dot_flops=1.0, hbm_bytes=1e13)
    assert c.dominant() == "memory"
    assert c.memory_s() == 1e13 / 3.35e12
    c = roofline.Costs(dot_flops=1.0, coll_bytes={"model": 450e9, "pod": 50e9})
    assert c.dominant() == "collective"
    assert c.collective_s() == 2.0       # the pod axis at the pod link, 50e9 B/s
    assert set(c.summary()) == {"dot_flops", "hbm_bytes", "coll_bytes", "compute_s",
                                "memory_s", "collective_s", "dominant"}


def test_a_pod_x_data_collective_counts_on_both_axes():
    """A collective over ``part`` (pod x data) counts on ``pod`` and on
    ``data``, each at its own size, as the walk counts one over
    ``("pod", "data")``; the expert group is the data group."""
    def f(x, axis):
        g = torch.empty((16,), device=META)
        axis.all_gather(g, x, "part")
        e = D.with_expert_group(axis)
        e.all_to_all(torch.empty_like(g), g, "expert")
        return g
    with D.fake_grid(2, 2, npod=2) as axis:
        c = roofline.analyze(f, _meta(4), axis, axis=axis)
    assert dict(c.coll_bytes) == {"pod": 32.0, "data": 32.0 + 32.0}
    assert c.coll_counts[("pod", "all_gather")] == 1
    assert c.coll_counts[("data", "all_to_all")] == 1


# ---------------------------------------------------------------------------
# (b) the whole step against JAX's roofline.analyze
# ---------------------------------------------------------------------------
def _jax_ops(jpr, sizes: dict, w: float) -> dict:
    """(axis, collective) -> [calls, wire bytes] of JAX's walk (its
    ``walk_jaxpr`` rules, kept apart by collective)."""
    out: dict = {}

    def walk(jaxpr, mult):
        for eqn in jaxpr.eqns:
            name, prm = eqn.primitive.name, eqn.params
            if name == "scan":
                walk(prm["jaxpr"].jaxpr, mult * prm["length"])
            elif name == "while":
                walk(prm["body_jaxpr"].jaxpr, mult)
            elif name == "cond":
                for br in prm["branches"]:
                    walk(br.jaxpr, mult * w)
            elif name == "shard_map" or name in jroofline._INNER_JAXPR_PRIMS:
                inner = prm.get("jaxpr") or prm.get("call_jaxpr") or prm.get("fun_jaxpr")
                if inner is not None:
                    walk(inner.jaxpr if hasattr(inner, "jaxpr") else inner, mult)
            elif name in jroofline.COLLECTIVES:
                base = max(sum(jroofline._aval_bytes(v.aval) for v in eqn.invars),
                           sum(jroofline._aval_bytes(v.aval) for v in eqn.outvars))
                for ax in jroofline._axis_names(eqn):
                    if sizes.get(ax, 1) > 1:
                        c = out.setdefault((ax, name), [0.0, 0.0])
                        c[0] += mult
                        c[1] += mult * jroofline.COLLECTIVES[name](sizes[ax]) * base
    walk(jpr.jaxpr, 1.0)
    return out


def _jax_case(jd, arch, shape, mesh, *, method="layered", span_pods=False, ep=False,
              layers=None, pure=False, weights=()):
    """JAX's step of a case as its ``run_one`` builds it (kernels off),
    traced once: ({cond weight: dot flops}, its collectives by op at
    ``run_one``'s weight, per-device input bytes less the cache's int32
    position)."""
    cfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), kernels=False)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if pure:
        cfg = dataclasses.replace(cfg, hybrid_attn_period=0)
    axis = jstepfn.axis_ctx(mesh)
    cfg = cfg.padded_for_tp(axis.tp)
    info = jd.SHAPES[shape]
    kind = info["kind"]
    pos = 0
    if kind == "train":
        M = max(info["batch"] // axis.dp, 1)
        acc = JAccumConfig(method=method, partitioned=True, n_microbatches=M,
                           span_pods=span_pods, expert_parallel=ep)
        fn = jstepfn.build_train_step(cfg, mesh, acc, JAdamConfig(moment_dtype="bfloat16",
                                                                  grad_clip=1.0), donate=True)
        storage, _ = jd.storage_sds(cfg, mesh, True, span_pods=span_pods,
                                    expert_resident=ep and cfg.is_moe)
        mom = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, jnp.bfloat16,
                                                          sharding=l.sharding), storage)
        opt = {"mu": mom, "nu": mom,
               "step": jax.ShapeDtypeStruct((), jnp.int32, sharding=NamedSharding(mesh, P()))}
        args = (storage, opt, jd.input_specs(cfg, shape, mesh, n_microbatches=M))
    else:
        seq_shard = kind == "decode_long"
        fn = (jstepfn.build_prefill_step(cfg, mesh) if kind == "prefill"
              else jstepfn.build_serve_step(cfg, mesh, seq_shard=seq_shard))
        cache, _ = jd.cache_sds(cfg, mesh, info["batch"], info["seq"], seq_shard=seq_shard)
        args = (jd.params_sds(cfg, mesh), cache,
                jd.input_specs(cfg, shape, mesh, n_microbatches=1))
        pos = 4
    jpr = jax.make_jaxpr(fn)(*args)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    p = cfg.hybrid_attn_period
    w0 = 1.0 / p if p else 0.5                     # run_one's cond weight
    flops = {}
    for w in (w0, *weights):
        c = jroofline.Costs()
        jroofline.walk_jaxpr(jpr.jaxpr, 1.0, c, sizes, w)
        flops[w] = c.dot_flops
    nb = sum(math.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
             for l in jax.tree.leaves(args))
    return flops, _jax_ops(jpr, sizes, w0), nb - pos


def _port_case(arch, shape, grid, *, layers=None, pure=False, **kw):
    """The port's ``dryrun.build`` step of a case under ``analyze``, with
    the dry run's own ``see`` (the flash attention's work left out):
    (Costs, config, data-parallel width)."""
    npod, nd, tp = grid
    with D.fake_grid(nd, tp, npod=npod) as axis:
        cfg = pconfigs.get_config(arch, smoke=True)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if pure:
            cfg = dataclasses.replace(cfg, hybrid_attn_period=0)
        cfg = cfg.padded_for_tp(axis.tp)
        step, args = dryrun.build(cfg, shape, axis, **kw)
        return roofline.analyze(step, *args, axis=axis), cfg, axis.dp


def walk_attention_flops(cfg, shape: str, dp: int, tp: int = 2) -> float:
    """The attention dots JAX's walk counts where the port's count leaves
    the flash attention out: F = 2 x 2 x rows x Hq/tp x S x S x hd for one
    forward call's QK^T and PV; a train step's layer and micro-batch runs
    the forward, the recompute (F each) and the backward (4 products, 2F);
    a prefill's layer one forward; decode attends without the kernel."""
    info = dryrun.SHAPES[shape]
    S, B = info["seq"], info["batch"]
    n = (sum(cfg.attn_layer_flags()) if cfg.hybrid_attn_period
         else cfg.num_layers if cfg.block_kind == "attn" else 0)
    if info["kind"] == "train":
        M = max(B // dp, 1)
        F = 4.0 * (B // M // dp) * (cfg.num_heads // tp) * S * S * cfg.head_dim
        return 4 * F * n * M
    if info["kind"] == "prefill":
        return 4.0 * (B // dp) * (cfg.num_heads // tp) * S * S * cfg.head_dim * n
    return 0.0


def _family(ops: dict, axis: str, names) -> tuple:
    calls = sum(v[0] for (a, o), v in ops.items() if a == axis and o in names)
    wire = sum(v[1] for (a, o), v in ops.items() if a == axis and o in names)
    return calls, wire


def _port_ops(costs) -> dict:
    return {k: [costs.coll_counts[k], costs.coll_op_bytes[k]] for k in costs.coll_counts}


CASES = {
    "yi-6b layered": ("yi-6b", "t_train", (None, 2, 2), {}),
    "yi-6b standard": ("yi-6b", "t_train", (None, 2, 2), {"method": "standard"}),
    "dbrx-132b": ("dbrx-132b", "t_train", (None, 2, 2), {}),
    "dbrx-132b expert-parallel": ("dbrx-132b", "t_train", (None, 2, 2),
                                  {"expert_parallel": True}),
    "zamba2-7b 3 layers": ("zamba2-7b", "t_train", (None, 2, 2), {"layers": 3}),
    "rwkv6-3b": ("rwkv6-3b", "t_train", (None, 2, 2), {}),
    "yi-6b span_pods": ("yi-6b", "t_train", (2, 2, 2), {"span_pods": True}),
    "yi-6b prefill": ("yi-6b", "t_prefill", (None, 2, 2), {}),
    "yi-6b decode": ("yi-6b", "t_decode", (None, 2, 2), {}),
    "gemma2-9b seq-sharded decode": ("gemma2-9b", "t_long", (None, 2, 2), {}),
}

# JAX's model-axis reductions less the port's, wire bytes, at the tests'
# cut, measured; ROADMAP.md §3 names the ops.  The dense attention cases
# are reckoned term by term (``reckoned_model_gap``).
MODEL_REDUCTION_GAP = {
    "dbrx-132b": -50164.0,
    "dbrx-132b expert-parallel": 918540.0,
    "zamba2-7b 3 layers": 2851852.0,
    "rwkv6-3b": 1039372.0,
}


def reckoned_model_gap(cfg, method: str, M: int) -> float:
    """JAX's model-axis reductions less the port's for a dense attention
    stack with a replicated KV head (yi-6b's smoke config at tp 2, so every
    psum's wire factor 2(n-1)/n is 1; one row of 64 positions a micro-batch),
    term by term:
    - one more [mb, S, d] psum a layer and micro-batch: JAX's AD sums the
      normed input's cotangent once for each product that reads it
      (wq, w_gate, w_up), Megatron's f in the port once a block (2);
    - the replicated KV head: JAX sums the [mb, S, 1, hd] cotangents of k
      and v a layer and micro-batch; the port all-reduces the [d, hd]
      fp32 gradients of wk and wv, once a layer in the layered schedule,
      once a layer and micro-batch in the standard one;
    - the vocab-parallel loss: per micro-batch two more [mb, S] psums and a
      scalar one (the vma loss's invariance); JAX's max, an all-gather of
      the local maxima, moves what the port's max all-reduce moves;
    - JAX's norm psums the resident-expert share, 0 here, over model."""
    L, mb, S, d, hd = cfg.num_layers, 1, 64, cfg.d_model, cfg.head_dim
    isz = 4                                        # the smoke configs compute in fp32
    kv_port = 2 * L * d * hd * 4 * (M if method == "standard" else 1)
    return (L * M * mb * S * d * isz
            + 2 * L * M * mb * S * hd * isz - kv_port
            + M * (2 * mb * S * 4 + 4) + 4)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_the_jax_dry_run(case, tiny, jdry, mesh22, mesh_pod):
    arch, shape, grid, kw = CASES[case]
    mesh = mesh_pod if grid[0] else mesh22
    kind = dryrun.SHAPES[shape]["kind"]
    hybrid = "layers" in kw
    pc, cfg, dp = _port_case(arch, shape, grid, **kw)
    ran = sum(cfg.attn_layer_flags()) / cfg.num_layers if hybrid else None
    jflops, jops, jbytes = _jax_case(
        jdry, arch, shape, mesh, method=kw.get("method", "layered"),
        span_pods=kw.get("span_pods", False), ep=kw.get("expert_parallel", False),
        layers=kw.get("layers"), weights=(ran,) if hybrid else ())
    w0 = next(iter(jflops))
    pops = _port_ops(pc)

    # argument bytes
    assert pc.memory["argument_bytes"] == jbytes
    assert pc.memory["temp_bytes"] > 0

    # dot flops
    mine = pc.dot_flops + walk_attention_flops(cfg, shape, dp)
    if arch == "dbrx-132b":               # one-hot dispatch dots with no contracting dim
        assert 0 <= jflops[w0] - mine <= 1.2e-4 * jflops[w0]
    elif arch == "rwkv6-3b":              # RWKV-6's products with no contracting dim
        assert 0 < jflops[w0] - mine <= 0.032 * jflops[w0]
    elif hybrid:
        # JAX at the weight of the layers that ran; the rest is the Mamba
        # stack's own gap, the same without the shared block
        pure, _, _ = _port_case(arch, shape, grid, pure=True, **kw)
        jpure, _, _ = _jax_case(jdry, arch, shape, mesh, layers=kw["layers"], pure=True)
        assert mine - jflops[ran] == pure.dot_flops - next(iter(jpure.values()))
        assert jflops[w0] > jflops[ran]   # run_one's 1/period counts 1.5 uses of 1
    else:
        assert mine == jflops[w0]

    # wire bytes where the ops match: exact calls and bytes
    for ax in ("data", "pod"):
        for jn, pn in ((("all_gather", "all_gather_invariant"), ("all_gather",)),
                       (("reduce_scatter", "psum_scatter"), ("reduce_scatter",)),
                       (("all_to_all",), ("all_to_all",))):
            assert _family(jops, ax, jn) == _family(pops, ax, pn), (ax, jn)
    reductions = ("psum", "psum_invariant", "psum2", "pmax", "pmin")
    if kind == "train":
        # the checkpoints' all-gathers on model: JAX's gathers every
        # micro-batch's at once
        assert _family(jops, "model", ("all_gather_invariant",))[1] == \
            _family(pops, "model", ("all_gather",))[1]
        # data: JAX's norm also psums the resident-expert share (4 B)
        assert _family(jops, "data", reductions)[1] - \
            _family(pops, "data", ("all_reduce",))[1] == 4
        assert _family(jops, "pod", reductions)[1] == _family(pops, "pod", ("all_reduce",))[1]
        gap = (_family(jops, "model", reductions + ("all_gather",))[1]
               - _family(pops, "model", ("all_reduce",))[1])
        want = MODEL_REDUCTION_GAP.get(case)
        if arch == "yi-6b":
            want = reckoned_model_gap(cfg, kw.get("method", "layered"),
                                      max(dryrun.SHAPES[shape]["batch"] // dp, 1))
        assert gap == want, gap
    else:
        # serving: the same reductions; the port's step also gathers the
        # whole [rows, V] fp32 logits over model (JAX's out_specs does)
        rows = dryrun.SHAPES[shape]["batch"] // (1 if kind == "decode_long" else dp)
        assert _family(pops, "model", ("all_gather",)) == (1, 0.5 * rows * cfg.vocab_size * 4)
        for ax in ("data", "model"):
            assert _family(jops, ax, reductions)[1] == _family(pops, ax, ("all_reduce",))[1]


def test_layered_checkpoints_keep_a_model_share_of_one_row(tiny):
    """A layered step's (layer, micro-batch) checkpoint keeps this rank's
    1/tp of the sequence, as JAX's ``ckpt_slice`` does, also with one row a
    micro-batch, where the share is a contiguous view of the activation: two
    more layers add their checkpoints' shares and their gradient chunks to
    the peak, and no more.  (Kept as the view, each checkpoint held its
    whole activation, tp times its share.)"""
    peaks = {}
    for L in (2, 4):
        pc, cfg, dp = _port_case("yi-6b", "t_train", (None, 1, 4), layers=L)
        peaks[L] = pc.memory["temp_bytes"]
        layer_chunk = pc.memory["argument_bytes"]      # for the per-layer share below
    M, S, d = 4, 64, cfg.d_model                       # 4 rows on one data rank
    with D.fake_grid(1, 4) as axis:
        store = dryrun.storage_specs(dataclasses.replace(cfg, num_layers=1), axis, True)
    layer_chunk = sum(t.numel() * 4 for t in jax.tree.leaves(store["layers"]))
    assert peaks[4] - peaks[2] == 2 * (M * (S // 4) * d * 4 + layer_chunk)


# ---------------------------------------------------------------------------
# (c) the CLI, in-process, at full width
# ---------------------------------------------------------------------------
JAX_KEYS = {"arch", "shape", "multi_pod", "method", "partitioned", "status", "n_chips",
            "seconds", "memory", "roofline", "coll_counts", "model_flops_global",
            "model_flops_per_chip", "useful_flops_ratio", "notes"}


def test_cli_reports_a_production_rank(tmp_path):
    """``main`` writes one rank's report of the 16 x 16 grid with JAX's
    keys (no ``xla_cost_analysis``: the port compiles nothing); under
    ``--multi-pod`` the grid has 512 ranks.  No group is left behind."""
    for extra, n in (([], 256), (["--multi-pod"], 512)):
        rep = dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--save",
                           str(tmp_path), *extra])
        saved = json.loads((tmp_path / f"yi-6b_decode_32k_pod{1 + bool(extra)}.json").read_text())
        assert set(saved) == JAX_KEYS | {"constants"}
        assert saved["n_chips"] == rep["n_chips"] == n and saved["status"] == "ok"
        mem = saved["memory"]
        assert mem["device_bytes"] == mem["temp_bytes"] + mem["argument_bytes"]
        # the rank's bf16 weights (model-sharded over 16; wk and wv whole:
        # 4 KV heads are replicated over 16 ranks), its rows of a
        # 32768-position KV cache (one KV head a rank) and their tokens
        V, d, f, L, hd = 64000, 4096, 11008, 32, 128
        w = 2 * (2 * V * d // 16 + d + L * (2 * d * d // 16 + 2 * d * 4 * hd
                                             + 3 * d * f // 16 + 2 * d))
        rows = 128 // (n // 16)                   # the batch over the data ranks
        kv = 2 * L * rows * 32768 * hd * 2
        assert mem["argument_bytes"] == w + kv + rows * 4
        assert set(saved["roofline"]) == {"dot_flops", "hbm_bytes", "coll_bytes", "compute_s",
                                          "memory_s", "collective_s", "dominant"}
        assert saved["roofline"]["dominant"] == "memory"
        assert saved["constants"] == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                                      "link_bw": 450e9, "pod_bw": 50e9}
        assert saved["coll_counts"]["model:all_reduce"] == 2 * L + 1
        assert not tdist.is_initialized()


def test_cli_skips_long_context_for_full_attention(jdry):
    rep = dryrun.main(["--arch", "yi-6b", "--shape", "long_500k"])
    assert rep["status"] == "skipped"
    assert rep["reason"] == jdry.arch_shape_supported("yi-6b", "long_500k")[1]
    assert dryrun.LONG_OK == jdry.LONG_OK
    assert {k: v for k, v in dryrun.SHAPES.items() if not k.startswith("t_")} == \
        {k: v for k, v in jdry.SHAPES.items() if not k.startswith("t_")}


def test_cli_adopts_a_plan(tmp_path, monkeypatch):
    """``--plan`` takes the plan's arch, method, partition and a mesh that
    splits the 256 ranks; flags on the command line win."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"execution": {"arch": "yi-6b", "method": "standard",
                                              "partitioned": False, "mesh": "32x8"}}))
    seen = []
    monkeypatch.setattr(dryrun, "run_one", lambda arch, shape, **kw: seen.append(
        dict(kw, arch=arch, shape=shape)))
    dryrun.main(["--plan", str(plan), "--shape", "train_4k"])
    dryrun.main(["--plan", str(plan), "--shape", "train_4k", "--method", "layered",
                 "--mesh-shape", "16x16"])
    assert [(s["arch"], s["method"], s["partitioned"], s["mesh_shape"]) for s in seen] == \
        [("yi-6b", "standard", False, "32x8"), ("yi-6b", "layered", False, "16x16")]


def test_sweep_writes_a_report_or_a_failure_for_each(tmp_path, monkeypatch):
    """``--all``'s sweep: one ``.json`` per combination (a skipped one too)
    or one ``.FAILED``; a report that exists is not run again.  Each
    subprocess here runs ``main`` in-process."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        try:
            dryrun.main(cmd[3:])
            return subprocess.CompletedProcess(cmd, 0, "", "")
        except Exception as e:             # noqa: BLE001 - the subprocess's failure
            return subprocess.CompletedProcess(cmd, 1, "", repr(e))
    monkeypatch.setattr(dryrun.subprocess, "run", run)
    dryrun.run_all(str(tmp_path), archs=["yi-6b"], shapes=["long_500k"], meshes=(False, True))
    fails = dryrun.run_all(str(tmp_path), archs=["no-such-arch"], shapes=["decode_32k"],
                           meshes=(False,))
    assert fails == ["no-such-arch_decode_32k_pod1"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "no-such-arch_decode_32k_pod1.FAILED", "yi-6b_long_500k_pod1.json",
        "yi-6b_long_500k_pod2.json"]
    n = len(calls)
    dryrun.run_all(str(tmp_path), archs=["yi-6b"], shapes=["long_500k"], meshes=(False, True))
    assert len(calls) == n
    assert not tdist.is_initialized()


def test_expert_parallelism_with_pods_is_refused(tiny):
    """As ``stepfn.build_train_step`` refuses it (JAX's step does not
    trace there)."""
    from repro_torch.core.accumulation import EP_PODS_REFUSAL
    with D.fake_grid(2, 1, npod=2) as axis:
        cfg = pconfigs.get_config("dbrx-132b", smoke=True)
        with pytest.raises(ValueError, match=EP_PODS_REFUSAL[:40]):
            dryrun.build(cfg, "t_train", axis, span_pods=True, expert_parallel=True)
    assert not tdist.is_initialized()


def test_a_dry_run_never_joins_a_group():
    with D.fake_grid(1, 1):
        with pytest.raises(RuntimeError, match="already exists"):
            with D.fake_grid(1, 1):
                pass
    assert not tdist.is_initialized()
    with pytest.raises(ValueError, match="not a split of 256"):
        D.production_grid(mesh_shape="8x8")


# ---------------------------------------------------------------------------
# (d) the tracker
# ---------------------------------------------------------------------------
def test_tracker_counts_a_kernels_outputs_not_its_plain_temporaries():
    """A flash attention at S = 4096 on ``meta``, forward and backward:
    the peak is what the kernels write (out and lse; dq and delta; dk and
    dv), not the plain version's [B, H, S, S] scores; a K6 update writes
    in place and adds nothing."""
    S, H, hd = 4096, 8, 128
    q = _meta(1, S, H, hd, dtype=torch.bfloat16).requires_grad_()
    k = _meta(1, S, 1, hd, dtype=torch.bfloat16).requires_grad_()
    v = _meta(1, S, 1, hd, dtype=torch.bfloat16).requires_grad_()
    do = _meta(1, S, H, hd, dtype=torch.bfloat16)

    def step(q, k, v, do):
        out = kops.flash_attention(q, k, v)
        return out, *torch.autograd.grad(out, (q, k, v), do)
    c = roofline.analyze(step, q, k, v, do)
    qb, kb = S * H * hd * 2, S * hd * 2
    lse = H * S * 4
    # out and lse, then dq and delta (K4's), dk and dv (K5's)
    assert c.memory["temp_bytes"] == qb + lse + qb + lse + 2 * kb
    assert c.memory["temp_bytes"] < S * S * 4                   # one head's scores
    assert c.memory["output_bytes"] == 2 * qb + 2 * kb
    assert c.dot_flops == 0                                     # the kernel's own work

    n = 1 << 20
    p, g = _meta(n), _meta(n)
    m, vv = _meta(n, dtype=torch.bfloat16), _meta(n, dtype=torch.bfloat16)
    c = roofline.analyze(lambda *a: kops.fused_adamw(*a, b1=0.9, b2=0.95, eps=1e-8, wd=0.1),
                         p, m, vv, g, _meta(4))
    assert c.memory == {"device_bytes": c.memory["argument_bytes"], "temp_bytes": 0,
                        "argument_bytes": 4 * n + 2 * 2 * n + 4 * n + 16, "output_bytes": 0}


def test_marks_leave_the_dot_counts_alone():
    """Every kernel's work is marked now; only the flash attention's plain
    version holds matrix products, so only it leaves the counts."""
    x = torch.randn(4, 8, 16)
    scale = torch.randn(16)
    assert roofline.count_dots(lambda: kops.rmsnorm(x, scale).sum()) == 0.0
    w = torch.randn(16, 16)
    assert roofline.count_dots(lambda: kops.rmsnorm(x @ w, scale)) == 2 * 4 * 8 * 16 * 16


# ---------------------------------------------------------------------------
# the three small functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x", [8, 32, 160])
def test_paper_x_sequence_and_critical_batch(x):
    assert paper_x.seq_len(x) == jpaper_x.seq_len(x)
    assert paper_x.critical_batch(x) == jpaper_x.critical_batch(x)


def test_batches_match_jax():
    cfg = synthetic.DataConfig(vocab_size=97, seq_len=16, global_batch=4, n_microbatches=2,
                               seed=3)
    jcfg = jsynthetic.DataConfig(vocab_size=97, seq_len=16, global_batch=4,
                                 n_microbatches=2, seed=3)
    mine, ref = list(synthetic.batches(cfg, 3, start=5)), list(jsynthetic.batches(jcfg, 3,
                                                                                 start=5))
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
