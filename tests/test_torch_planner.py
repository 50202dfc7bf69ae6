"""The port's planner (``core/calculator.py``, ``planner/{simulator,search,
plan,validate}.py``, ``core/roofline.py``'s counter, ``launch/plan.py`` and
``launch.train --plan`` / ``launch.serve --plan``) against the JAX package.

Exact equality (``==`` on floats, no tolerance) wherever the two run the same
arithmetic: the calculator, the event simulator over a grid of its knobs,
the search and the serving search, the per-unit costs the counter measures
(five dense archs, smoke and full width, kernels on and off) and the
executable plan documents given JAX's TPU constants.  The composition of a
step the planner predicts is held against the port's counted work on gloo
within the JAX package's 20% (``tests/test_planner.py:243``).  Plans written
by either package drive the port's trainer; a plan-driven run equals the
same run given by flags bit for bit.
"""
import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from repro import configs as jconfigs
from repro.core import calculator as jcalc
from repro.core import roofline as jroofline
from repro.core.schedules import PipeSpec as JPipeSpec
from repro.launch import plan as jplan_cli
from repro.launch import serve as jserve
from repro.planner import plan as jplan
from repro.planner import search as jsearch
from repro.planner import simulator as jsim
from repro.planner import validate as jvalidate
from repro_torch import configs
from repro_torch.core import calculator as calc
from repro_torch.core import roofline
from repro_torch.core.schedules import PipeSpec
from repro_torch.kernels import ops as kops
from repro_torch.launch import plan as plan_cli
from repro_torch.launch import serve, train
from repro_torch.obs import trace as obs_trace
from repro_torch.planner import plan as planlib
from repro_torch.planner import search as searchlib
from repro_torch.planner import simulator as sim
from repro_torch.planner import validate as V
from test_torch_dist import ROOT, Procs, Spawn

WORKER = ROOT / "tests" / "torch_planner_ranks.py"
TOL = 0.20          # the JAX package's: each term within 20% (tests/test_planner.py:243)
TPU = dict(peak_flops=197e12, link_bw=50e9)     # the JAX roofline's constants
# tests/test_planner.py's smoke_cfg: 8 layers, 4 q / 2 KV heads
SMOKE = dict(name="p", arch_type="dense", num_layers=8, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32")
ACCUM_CASES = [dict(kind="accum", method="layered", part=True, M=4, mb=2, seq=16),
               dict(kind="accum", method="layered", part=False, M=4, mb=2, seq=16),
               dict(kind="accum", method="standard", part=True, M=4, mb=2, seq=16)]
PIPE_CASES = [dict(kind="pipe", schedule=s, M=8, mb=2, seq=16) for s in ("modular", "naive")]
PIPE_PLAN = ["--arch", "gemma-2b", "--smoke", "--devices", "4", "--stages", "2",
             "--microbatches", "2,4", "--global-batch", "4", "--seq-len", "32", "--steps", "2"]


def _json(doc):
    return json.loads(json.dumps(doc, default=str))


@pytest.fixture(scope="module", autouse=True)
def spawns(tmp_path_factory):
    """The gloo ranks, started before the module's first test: the accumulation checks at 2 data
    ranks, the pipeline's at 4 stages, and a pipelined plan whose embedded
    table is split (its execution says unsplit) under
    ``torch.distributed.run``."""
    tmp = tmp_path_factory.mktemp("planner")
    doc = plan_cli.main([*PIPE_PLAN, "--out", str(tmp / "pipe.json")])
    ex = doc["execution"]
    K = configs.get_config("gemma-2b", smoke=True).num_layers // ex["stages"]
    split = PipeSpec(ex["stages"], K, ex["microbatches"], ex["schedule"],
                     split_backward=True).tick_table()
    doc["execution"]["tick_table"] = split.to_json()
    planlib.save_plan(doc, str(tmp / "split.json"))
    d, m = (int(v) for v in ex["mesh"].split("x"))
    out = {"accum": Spawn(tmp, "accum", (2, 1), ACCUM_CASES, None, None, worker=WORKER,
                          cfg=SMOKE),
           "pipe": Spawn(tmp, "pipe", (4, 1, 1), PIPE_CASES, None, None, worker=WORKER,
                         cfg=SMOKE),
           "cli": Procs(tmp, "cli", [[
               sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ex["stages"] * d * m), "-m", "repro_torch.launch.train",
               "--plan", str(tmp / "split.json"), "--device", "cpu",
               "--trace", str(tmp / "trace.json"), "--drift-report", str(tmp / "drift.json")]])}
    out["tmp"], out["split"] = tmp, split
    yield out
    for p in out["cli"].procs:
        # the launcher stops its ranks on SIGTERM; killed outright it would
        # leave them waiting for each other
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
    for k in ("accum", "pipe", "cli"):
        out[k].kill()


# ---------------------------------------------------------------------------
# The paper's calculator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x", [32, 64, 160])
def test_calculator_matches_jax(x):
    assert calc.table_6_1(x) == jcalc.table_6_1(x)
    m, hw = calc.XModel(x), calc.Hardware()
    jm, jhw = jcalc.XModel(x), jcalc.Hardware()
    for method in ("baseline", "partitioned", "improved"):
        for net in (None, hw.ethernet):
            a = calc.fastest(m, hw, method=method, net=net)
            b = jcalc.fastest(jm, jhw, method=method, net=net)
            assert a.row() == b.row() and a.memory == b.memory
            for part in (False, True):
                assert calc.memory_breakdown(m, a, partitioned=part) == \
                    jcalc.memory_breakdown(jm, b, partitioned=part)
    assert calc.offload_intensities(x) == jcalc.offload_intensities(x)
    xs = (16, 32, 64, 128, 160, 256)
    assert calc.scaling_curve(xs) == jcalc.scaling_curve(xs)
    assert calc.scaling_curve(xs, net=hw.ethernet) == jcalc.scaling_curve(xs, net=jhw.ethernet)


# ---------------------------------------------------------------------------
# The event simulator
# ---------------------------------------------------------------------------
COST = dict(flops_fwd_layer=2.0, flops_bwd_layer=6.0, act_bytes=64.0,
            layer_param_bytes=256.0, layer_grad_bytes=512.0, flops_rate=1.0,
            p2p_bw=100.0, coll_bw=50.0, t_head=0.5, opt_bytes_per_layer=640.0, hbm_bw=64.0)
OVERLAPS = [dict(), dict(overlap_p2p=False), dict(overlap_coll=False), dict(shared_link=True)]


@pytest.mark.parametrize("S,K,M", [(1, 4, 4), (2, 2, 4), (4, 2, 8), (3, 4, 6)])
@pytest.mark.parametrize("sched", ["gpipe", "modular", "1f1b", "interleaved"])
def test_simulate_matches_jax(sched, S, K, M):
    """Every knob of the training mode: the result, its summary and the
    timeline equal JAX's, as does the SPMD composition of the same spec."""
    n = 0
    for split in (False, True):
        for fused in (False, True):
            for method in ("layered", "standard"):
                for part in (False, True):
                    for ov in OVERLAPS:
                        kw = dict(n_stages=S, layers_per_stage=K, n_microbatches=M,
                                  schedule=sched, method=method, partitioned=part, n_data=4,
                                  split_backward=split, fused_optimizer=fused, **ov)
                        a = sim.simulate(sim.SimConfig(**kw), sim.CostModel(**COST),
                                         record_timeline=True)
                        b = jsim.simulate(jsim.SimConfig(**kw), jsim.CostModel(**COST),
                                          record_timeline=True)
                        assert dataclasses.asdict(a) == dataclasses.asdict(b), kw
                        assert a.summary() == b.summary()
                        n += 1
    assert n == 2 * 2 * 2 * 2 * len(OVERLAPS)
    cost = sim.CostModel(**COST)
    for split in (False, True):
        spec = PipeSpec(S, K, M, "naive" if sched == "gpipe" else sched, split_backward=split)
        jspec = JPipeSpec(S, K, M, "naive" if sched == "gpipe" else sched,
                          split_backward=split)
        assert sim.predict_spmd_composition(spec, cost, head_flops=3.0, extra_coll_bytes=7.0) \
            == jsim.predict_spmd_composition(jspec, jsim.CostModel(**COST), head_flops=3.0,
                                             extra_coll_bytes=7.0)


@pytest.mark.parametrize("sched", ["gpipe", "modular", "1f1b", "interleaved"])
def test_simulate_forward_only_matches_jax(sched):
    """``include_backward=False`` (the forward pass alone) and the assert
    that tick tables describe full passes."""
    kw = dict(n_stages=4, layers_per_stage=2, n_microbatches=8, schedule=sched)
    for extra in (dict(), dict(partitioned=False, n_data=2, method="standard")):
        a = sim.simulate(sim.SimConfig(**kw, **extra, include_backward=False),
                         sim.CostModel(**COST), record_timeline=True)
        b = jsim.simulate(jsim.SimConfig(**kw, **extra, include_backward=False),
                          jsim.CostModel(**COST), record_timeline=True)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.counts["bwd_units"] == 0
    with pytest.raises(AssertionError, match="full grad passes"):
        sim.build_tick_table(sim.SimConfig(**kw, include_backward=False))


def test_simulate_serving_matches_jax():
    cost = dict(flops_fwd_layer=0.0, flops_bwd_layer=0.0, act_bytes=0.0,
                layer_param_bytes=1e6, layer_grad_bytes=0.0, flops_rate=1e12, p2p_bw=1e9,
                coll_bw=5e9, hbm_bw=2e12, kv_bytes_per_token=4096.0,
                serve_flops_per_token=1e8, serve_coll_bytes_per_token=512.0)
    for batch in (1, 8, 64):
        for block in (0, 16, 64):
            kw = dict(n_stages=1, layers_per_stage=8, n_microbatches=1, schedule="gpipe",
                      serving=True, serve_batch=batch, serve_ctx=1000, serve_block=block,
                      serve_max_seq=4096)
            a = sim.simulate(sim.SimConfig(**kw), sim.CostModel(**cost))
            b = jsim.simulate(jsim.SimConfig(**kw), jsim.CostModel(**cost))
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_tick_table_json_unchanged():
    """The table JSON stays the JAX package's key for key, split or not."""
    for sched in ("modular", "naive", "1f1b", "interleaved"):
        for split in (False, True):
            a = PipeSpec(2, 4, 4, sched, split_backward=split).tick_table().to_json()
            b = JPipeSpec(2, 4, 4, sched, split_backward=split).tick_table().to_json()
            assert a == b


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def x160():
    kw = dict(grid="reduced", simulate_top=8, max_sims=24)
    return searchlib.search(160, **kw), jsearch.search(160, **kw)


def test_search_matches_jax(x160):
    """The ranked rows and the paper document equal JAX's; the winner is
    Table 6.1's (modular/layered/part, n_a 16, n_l = n_mu = 5, 38640 GPUs)
    at about the paper's 1.9x over the conventional 3d baseline."""
    mine, ref = x160
    assert [p.row() for p in mine] == [p.row() for p in ref]
    doc = planlib.paper_plan_document(160, mine)
    assert _json(doc) == _json(jplan.paper_plan_document(160, ref))
    win = mine[0]
    assert (win.family, win.n_a, win.n_l, win.n_mu, win.n_gpu) == \
        ("modular/layered/part", 16, 5, 5, 38640)
    assert 1.9 * 0.9 <= doc["speedup_vs_3d_baseline"] <= 1.9 * 1.1


def test_plan_cli_paper_mode_matches_jax(tmp_path):
    argv = ["--arch", "paper-x", "--size", "160", "--grid", "reduced", "--simulate-top", "6",
            "--max-sims", "16"]
    doc = plan_cli.main([*argv, "--out", str(tmp_path / "p.json")])
    assert _json(doc) == _json(jplan_cli.main(argv))
    assert doc["winner"]["n_gpu"] == 38640
    assert json.loads((tmp_path / "p.json").read_text())["winner"]["family"] == \
        "modular/layered/part"


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-9b", "dbrx-132b", "arctic-480b",
                                  "rwkv6-3b", "zamba2-7b"])
def test_search_serving_matches_jax(arch):
    a = [p.row() for p in searchlib.search_serving(configs.get_config(arch))]
    assert a == [p.row() for p in jsearch.search_serving(jconfigs.get_config(arch))]
    assert serve.main(["--arch", arch, "--plan"]) == jserve.main(["--arch", arch, "--plan"])


@pytest.mark.parametrize("arch", ["yi-6b", "dbrx-132b", "arctic-480b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_model_flops_match_jax(arch):
    """6ND and 2ND at the active parameters (an MoE layer's routed experts
    and its router), as the JAX roofline counts them."""
    for smoke in (False, True):
        cfg, jcfg = configs.get_config(arch, smoke=smoke), jconfigs.get_config(arch, smoke=smoke)
        assert roofline.model_flops_train(cfg, 8, 2048) == \
            jroofline.model_flops_train(jcfg, 8, 2048)
        assert roofline.model_flops_decode(cfg, 16) == jroofline.model_flops_decode(jcfg, 16)
    if cfg.is_moe:
        assert cfg.param_count(active_only=True) < cfg.param_count()


# ---------------------------------------------------------------------------
# The counter and the traced costs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b", "gemma2-9b", "granite-20b", "paper-x32"])
def test_traced_layer_costs_match_jax(arch, smoke, kernels):
    """The counter counts what the JAX walk counts: the flash attention's
    dots left out while the kernel runs, counted at S×S when it does not."""
    mb, seq = (2, 64) if smoke else (1, 512)
    tc = V.traced_layer_costs(dataclasses.replace(configs.get_config(arch, smoke=smoke),
                                                  kernels=kernels), mb, seq)
    ref = jvalidate.traced_layer_costs(
        dataclasses.replace(jconfigs.get_config(arch, smoke=smoke), kernels=kernels), mb, seq)
    assert dataclasses.asdict(tc) == dataclasses.asdict(ref)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_recurrent_layer_costs_against_jax(smoke):
    """RWKV-6: the counter counts the JAX walk's dot flops less the two
    elementwise products of the chunked engine that JAX's einsum lowers to
    dot_generals with no contracting dim (q_t k_s over every pair of a chunk,
    the pairwise decays then contracted; and q_t u k_t of the bonus): 2 B t s
    H dk and 2 B S H dk a layer (ROADMAP.md §3, 3.2% of the smoke layer,
    0.18% at full width).  Mamba-2 hybrid: the JAX walk fails on a hybrid
    layer (it passes an empty shared block, whose branch ``lax.cond``
    traces); the port's counts a layer without its shared block, as JAX's
    would, and leaves the shared block out of the outer bytes, as JAX's
    does."""
    mb, seq = (2, 64) if smoke else (1, 512)
    cfg = configs.get_config("rwkv6-3b", smoke=smoke)
    tc = V.traced_layer_costs(cfg, mb, seq)
    ref = jvalidate.traced_layer_costs(jconfigs.get_config("rwkv6-3b", smoke=smoke), mb, seq)
    chunk, H, dk = min(64, seq), cfg.rwkv_heads, cfg.ssm_head_dim
    extra = 2 * mb * seq * chunk * H * dk + 2 * mb * seq * H * dk
    assert tc.flops_fwd_layer + extra == ref.flops_fwd_layer
    assert dataclasses.asdict(dataclasses.replace(tc, flops_fwd_layer=ref.flops_fwd_layer)) \
        == dataclasses.asdict(ref)
    z = configs.get_config("zamba2-7b", smoke=smoke)
    with pytest.raises(KeyError):
        jvalidate.traced_layer_costs(jconfigs.get_config("zamba2-7b", smoke=smoke), mb, seq)
    zc = V.traced_layer_costs(z, mb, seq)
    d, f, st, heads = z.d_model, z.d_ff, z.ssm_state, z.d_ff // z.ssm_head_dim
    proj = 2 * mb * seq * (2 * d * f + d * (2 * st + heads) + f * d)
    assert zc.flops_fwd_layer > proj and zc.outer_bytes == 4 * 2 * z.vocab_size * d + 4 * d


def test_recurrent_plan_documents():
    """``launch.plan``'s one-card documents for both families: rwkv6-3b's
    ranks as JAX's (same winner, scores within the counter's 3.2% above);
    zamba2-7b's builds, where the JAX package's fails on the hybrid layer."""
    kw = dict(devices=1, stage_options=(1, 2))
    doc = planlib.smoke_plan_document("rwkv6-3b", **kw, **TPU)
    jdoc = jplan.smoke_plan_document("rwkv6-3b", **kw)
    assert doc["execution"] == jdoc["execution"]
    for a, b in zip(doc["plans"], jdoc["plans"]):
        assert a["score_step_s"] == pytest.approx(b["score_step_s"], rel=0.033)
    z = planlib.smoke_plan_document("zamba2-7b", **kw, **TPU)
    assert z["execution"]["arch"] == "zamba2-7b" and z["plans"][0]["score_step_s"] > 0
    with pytest.raises(KeyError):
        jplan.smoke_plan_document("zamba2-7b", **kw)


def test_counter_sees_kernels_as_opaque_calls():
    """On CPU tensors the kernels' plain versions run, and their dots are
    not counted unless asked for; on ``meta`` tensors the same counts, with
    nothing computed.  The yi-6b smoke layer (mb 2, seq 64) gives the JAX
    walk's 142,606,336 with its kernel and 150,994,944 without."""
    cfg = configs.get_config("yi-6b", smoke=True)
    q = torch.randn(2, 64, cfg.num_heads, cfg.head_dim)
    k = torch.randn(2, 64, cfg.num_kv_heads, cfg.head_dim)
    dots = 2 * 2 * 2 * cfg.num_heads * 64 * 64 * cfg.head_dim      # QKᵀ and PV
    for dev in ("cpu", "meta"):
        qq, kk = q.to(dev), k.to(dev)
        assert roofline.count_dots(kops.flash_attention, qq, kk, kk) == 0.0
        assert roofline.count_dots(kops.flash_attention, qq, kk, kk,
                                   see=("flash_attention",)) == dots
    assert kops.current_kernel() is None
    assert V.traced_layer_costs(cfg, 2, 64).flops_fwd_layer == 142_606_336
    assert V.traced_layer_costs(dataclasses.replace(cfg, kernels=False), 2,
                                64).flops_fwd_layer == 150_994_944
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)
    assert roofline.count_dots(lambda: (x @ w).sum().backward()) == 3 * 2 * 4 * 8 * 3


def test_wire_bytes_use_the_jax_factors():
    counts = {("data", "all_gather"): [3, 400], ("data", "reduce_scatter"): [1, 100],
              ("model", "all_reduce"): [2, 64], ("stage", "send"): [4, 80],
              ("stage", "recv"): [4, 80], ("stage", "all_reduce"): [1, 8]}
    got = roofline.wire_bytes(counts, {"data": 4, "model": 2, "stage": 1})
    assert got == {"data": 0.75 * 500, "model": 64.0}


# ---------------------------------------------------------------------------
# Executable plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices", [1, 2, 4])
def test_smoke_plan_document_matches_jax(devices):
    """Given JAX's TPU constants the port's document is JAX's: rows, winner
    and embedded tick table."""
    kw = dict(devices=devices, stage_options=(1, 2))
    doc = planlib.smoke_plan_document("yi-6b", **kw, **TPU)
    assert _json(doc) == _json(jplan.smoke_plan_document("yi-6b", **kw))
    if devices == 4:
        assert "tick_table" in doc["execution"]


def test_full_width_plan_matches_jax_and_records_layers():
    """The card's plan at full width: JAX's document at JAX's constants
    (every row ties, the first wins); at the H100's a nonzero ``layers`` is
    recorded and the scores are the H100's."""
    kw = dict(devices=1, global_batch=8, seq_len=2048, microbatch_options=(1, 2, 4, 8),
              smoke=False)
    assert _json(planlib.smoke_plan_document("yi-6b", **kw, **TPU)) == \
        _json(jplan.smoke_plan_document("yi-6b", **kw))
    doc = planlib.smoke_plan_document("yi-6b", layers=8, **kw)
    assert doc["execution"]["layers"] == 8
    row = doc["plans"][0]
    assert row["compute_s"] == row["score_step_s"] > 0
    tc = V.traced_layer_costs(dataclasses.replace(configs.get_config("yi-6b"), num_layers=8),
                              8, 2048)
    assert row["compute_s"] == (4.0 * 8 * tc.flops_fwd_layer + 3.0 * tc.flops_head) / 989e12


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons of CPU runs: one intra-op thread, so that no
    reduction's order depends on how the work was split between threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags_of(ex: dict) -> list:
    out = ["--arch", ex["arch"], "--mesh", ex["mesh"], "--method", ex["method"],
           "--microbatches", str(ex["microbatches"]), "--global-batch", str(ex["global_batch"]),
           "--seq-len", str(ex["seq_len"]), "--steps", str(ex["steps"])]
    out += ["--smoke"] if ex["smoke"] else []
    out += [] if ex["partitioned"] else ["--no-partition"]
    return out + (["--layers", str(ex["layers"])] if ex.get("layers") else [])


def _history(res: dict) -> list:
    return [(r["loss"], r["grad_norm"]) for r in res["records"]]


def test_plan_roundtrips_through_train_bit_for_bit(tmp_path, one_thread):
    """Port plan -> port trainer: the resolved execution is the plan's and
    the losses and grad norms equal the flag-given run's bit for bit; flags
    given beside the plan win."""
    p = str(tmp_path / "p.json")
    doc = plan_cli.main(["--arch", "gemma-2b", "--smoke", "--devices", "1", "--global-batch",
                         "4", "--seq-len", "32", "--steps", "2", "--layers", "2",
                         "--microbatches", "1,2", "--out", p])
    ex = doc["execution"]
    planned = train.main(["--plan", p, "--device", "cpu"])
    assert planned["execution"] == ex
    flags = train.main([*_flags_of(ex), "--device", "cpu"])
    assert _history(planned) == _history(flags)
    over = train.main(["--plan", p, "--device", "cpu", "--steps", "1", "--method", "standard"])
    assert over["execution"] == dict(ex, steps=1, method="standard")


def test_jax_plan_runs_through_the_port(tmp_path, one_thread):
    """A plan JAX's ``launch.plan`` wrote drives the port's trainer, and a
    port plan without ``--layers`` loads through JAX's ``execution_of`` to
    the same execution."""
    p = str(tmp_path / "jax.json")
    jdoc = jplan_cli.main(["--arch", "yi-6b", "--smoke", "--devices", "1", "--global-batch",
                           "4", "--seq-len", "32", "--steps", "2", "--out", p])
    res = train.main(["--plan", p, "--device", "cpu"])
    assert res["execution"] == jdoc["execution"]
    assert _history(res) == _history(train.main([*_flags_of(jdoc["execution"]),
                                                 "--device", "cpu"]))
    q = str(tmp_path / "port.json")
    doc = plan_cli.main(["--arch", "yi-6b", "--smoke", "--devices", "1", "--global-batch", "4",
                         "--seq-len", "32", "--steps", "2", "--out", q])
    assert jplan.execution_of(jplan.load_plan(q)) == planlib.execution_of(planlib.load_plan(q))
    assert "layers" not in doc["execution"]


@pytest.mark.parametrize("field", ["n_stages", "n_microbatches"])
def test_train_refuses_a_mismatched_tick_table(tmp_path, capsys, field):
    """The embedded table replaced by the table of twice the stages or
    micro-batches of the same schedule."""
    doc = plan_cli.main([*PIPE_PLAN, "--out", str(tmp_path / "p.json")])
    tt = doc["execution"]["tick_table"]
    shape = {"n_stages": tt["n_stages"], "n_microbatches": tt["n_microbatches"]}
    shape[field] *= 2
    doc["execution"]["tick_table"] = PipeSpec(
        shape["n_stages"], tt["n_chunks"] * tt["layers_per_chunk"], shape["n_microbatches"],
        tt["schedule"]).tick_table().to_json()
    planlib.save_plan(doc, str(tmp_path / "bad.json"))
    with pytest.raises(SystemExit):
        train.main(["--plan", str(tmp_path / "bad.json"), "--device", "cpu"])
    assert "does not match the resolved execution" in capsys.readouterr().err


def test_train_refuses_a_table_it_cannot_execute(tmp_path, capsys):
    doc = plan_cli.main([*PIPE_PLAN, "--out", str(tmp_path / "p.json")])
    doc["execution"]["tick_table"]["kind"][0][0] = 7
    planlib.save_plan(doc, str(tmp_path / "bad.json"))
    with pytest.raises(SystemExit):
        train.main(["--plan", str(tmp_path / "bad.json"), "--device", "cpu"])
    assert "plan tick table is not executable" in capsys.readouterr().err


def test_plan_devices_zero_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        plan_cli.main(["--arch", "yi-6b", "--smoke"])
    assert "pass --devices N" in capsys.readouterr().err


def test_pipelined_plan_executes_its_embedded_table(spawns):
    """Under torch.distributed.run on gloo: the plan's execution says
    unsplit and its table is split; the run follows the table, whose every
    unit the tick profiler measures once."""
    spawns["cli"].wait()
    doc = obs_trace.load_chrome(str(spawns["tmp"] / "trace.json"))
    measured = sorted(e[:4] for e in obs_trace.timeline_from_chrome(doc, pid=1))
    assert measured == sorted(e[:4] for e in spawns["split"].timeline())
    assert {e[1] for e in measured} == {"F", "Bd", "Bw"}
    rep = json.loads((spawns["tmp"] / "drift.json").read_text())
    assert rep["overall"]["missing"] == rep["overall"]["extra"] == 0


# ---------------------------------------------------------------------------
# Predicted against counted composition, on gloo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(ACCUM_CASES)),
                         ids=[f"{c['method']}-{'part' if c['part'] else 'repl'}"
                              for c in ACCUM_CASES])
def test_accum_composition_agrees(spawns, i):
    for rank in spawns["accum"].result():
        r = rank["results"][i]
        assert abs(r["agreement"]["compute"] - 1.0) < TOL, r
        assert abs(r["agreement"]["collective"] - 1.0) < TOL, r


@pytest.mark.parametrize("i", range(len(PIPE_CASES)), ids=[c["schedule"] for c in PIPE_CASES])
def test_pipeline_composition_agrees(spawns, i):
    """Every stage's counted flops and wire bytes against the event
    simulator's for that stage; the JAX executor's lock-step prediction is
    carried beside it and runs every tick on every stage, so it is larger."""
    for rank in spawns["pipe"].result():
        r = rank["results"][i]
        assert abs(r["agreement"]["compute"] - 1.0) < TOL, r
        assert abs(r["agreement"]["collective"] - 1.0) < TOL, r
        assert r["predicted_spmd"]["dot_flops"] > r["predicted"]["dot_flops"]
