"""The port's failure-shrink (``resilience/supervisor.py``: a ``lose_replica``
fault drains the last data row's ZeRO chunks to the survivors, which go on
at ``data - 1`` with no step lost) against the JAX package's supervisor,
its kernels off (its mesh paths need that, ROADMAP.md §3), on gloo.

Every run starts from one checkpoint of seeded weights at step 0 (a copy
under each run's root; each supervisor reshards it onto its grid), so the
port's runs and JAX's take the same steps.  Two spawns of
``tests/torch_shrink_ranks.py`` run every case on grids of their ranks:

  * 2 ranks, data 2: JAX's ``test_failure_shrink_continues_and_matches``
    (``lose_replica`` at step 3 of 6): losses at rtol 1e-4 (its tolerance),
    the counters, the final layout, the survivor's final state against
    JAX's at rtol 3e-4 / atol 3e-5; its second half, a fresh one-process
    run from the pre-shrink checkpoint; the replicated layout; a plan that
    ``shrink_execution`` rejects (JAX's message, the state untouched);
    bf16 moments, which stay bf16 through the drain, a checkpoint and its
    restore;
  * 4 ranks: data 2 x model 2 -> 1 x 2 (against JAX's supervisor at the
    same grid too), then a crash two steps after the shrink, which restores
    the checkpoint the survivors wrote (it records data 1) with no hang;
    2 stages x data 2 -> 2 x 1; and data 3 -> 2 -> 1 on three of the four
    ranks, two shrinks in one run.

Each shrunk layout's final weights and moments are held to its unshrunk
run's, assembled in the full layout, at rtol 3e-4 / atol 3e-5.

The leaving ranks drain, leave the run and go on to the next case; every
process exits 0.  ``launch.train --faults`` with a ``lose_replica`` fault
runs the shrink under ``torch.distributed.run``, where the leaving rank's
process ends with code 0 while the survivor trains on.

Alone, this file takes about 45 s on an 8-core host.
"""
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest

from repro.data.synthetic import DataConfig as JDataConfig
from repro.models.common import ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.planner import plan as jplan
from repro.resilience import faults as jflt
from repro.resilience.reshard import MeshLayout as JMeshLayout
from repro.resilience.supervisor import Supervisor as JSupervisor
from repro.resilience.supervisor import SupervisorConfig as JSupervisorConfig
from repro.resilience.supervisor import SupervisorError as JSupervisorError
from repro_torch import tree
from repro_torch.checkpointing import store
from repro_torch.data.synthetic import DataConfig
from repro_torch.launch import train
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adam import AdamConfig
from repro_torch.resilience import faults as flt
from repro_torch.resilience import reshard
from repro_torch.resilience.reshard import MeshLayout
from repro_torch.resilience.supervisor import (Supervisor, SupervisorConfig, SupervisorError,
                                               state_digest)
from test_torch_dist import ROOT, Procs, Spawn, numpy_params

WORKER = ROOT / "tests" / "torch_shrink_ranks.py"
# tests/test_resilience.py's configuration
RES = dict(name="res", arch_type="dense", num_layers=4, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32")
CFG = ModelConfig(**RES)
OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=100)
BF16 = dict(opt=dict(OPT, moment_dtype="bfloat16"))
DATA = dict(vocab_size=64, seq_len=16, global_batch=8, n_microbatches=2, seed=0)
DATA3 = dict(DATA, global_batch=12)          # 6 rows a micro-batch: splits 3, 2 and 1 ways
SUP = dict(checkpoint_every=2, keep_checkpoints=3)
SEED = MeshLayout(1, 1, 1, partitioned=True, n_microbatches=2)
LOSE3 = [dict(kind="lose_replica", step=3)]
# a plan whose batch does not split into its micro-batches: shrink_execution
# rejects any shrink of it
BAD_PLAN = {"mesh": "2x1", "global_batch": 8, "microbatches": 3}


def _lay(stages=1, data=2, model=1, partitioned=True) -> dict:
    return MeshLayout(stages, data, model, partitioned, n_microbatches=2).to_meta()


# name -> (grid (stages, data, model), global ranks, layout, faults, steps, data,
# the case's other settings: a plan, an optimizer); the two spawns' cases, in order
TWO = {"shrink": ((1, 2, 1), [0, 1], _lay(), LOSE3, 6, DATA, {}),
       "unshrunk": ((1, 2, 1), [0, 1], _lay(), [], 6, DATA, {}),
       "two steps": ((1, 2, 1), [0, 1], _lay(), [], 2, DATA, {}),
       "plan refusal": ((1, 2, 1), [0, 1], _lay(), [dict(kind="lose_replica", step=2)], 4,
                        DATA, dict(plan=BAD_PLAN)),
       "replicated": ((1, 2, 1), [0, 1], _lay(partitioned=False), LOSE3, 6, DATA, {}),
       "replicated, unshrunk": ((1, 2, 1), [0, 1], _lay(partitioned=False), [], 6, DATA, {}),
       "bf16 moments": ((1, 2, 1), [0, 1], _lay(), LOSE3, 6, DATA, BF16),
       "bf16 moments, unshrunk": ((1, 2, 1), [0, 1], _lay(), [], 6, DATA, BF16),
       "bf16 moments, crash": ((1, 2, 1), [0, 1], _lay(), LOSE3 + [dict(kind="crash", step=5)],
                               6, DATA, BF16)}
FOUR = {"tp 2": ((1, 2, 2), [0, 1, 2, 3], _lay(model=2), LOSE3, 6, DATA, {}),
        "tp 2, unshrunk": ((1, 2, 2), [0, 1, 2, 3], _lay(model=2), [], 6, DATA, {}),
        "tp 2, crash": ((1, 2, 2), [0, 1, 2, 3], _lay(model=2),
                        LOSE3 + [dict(kind="crash", step=5)], 6, DATA, {}),
        "stages 2": ((2, 2, 1), [0, 1, 2, 3], _lay(stages=2), LOSE3, 6, DATA, {}),
        "stages 2, unshrunk": ((2, 2, 1), [0, 1, 2, 3], _lay(stages=2), [], 6, DATA, {}),
        "data 3, unshrunk": ((1, 3, 1), [0, 1, 2], _lay(data=3), [], 6, DATA3, {}),
        # last: the rank that leaves first makes no group of the second
        # shrink (a process that has left need not), so its count of groups
        # made falls behind the others' and it can share no later group
        "data 3, twice": ((1, 3, 1), [0, 1, 2], _lay(data=3),
                          [dict(kind="lose_replica", step=2), dict(kind="lose_replica", step=4)],
                          6, DATA3, {})}
# the layouts held against the port's unshrunk run: (shrunk case, unshrunk case,
# spawn); each ends at data 1
LAYOUTS = {"tp 2": ("tp 2", "tp 2, unshrunk", "four"),
           "replicated": ("replicated", "replicated, unshrunk", "two"),
           "stages 2": ("stages 2", "stages 2, unshrunk", "four"),
           "data 3, twice": ("data 3, twice", "data 3, unshrunk", "four")}


def _seed(root) -> None:
    """Weights (``numpy_params``) and zero moments as a step-0 checkpoint of
    layout ``SEED``, from which every run of both packages starts."""
    params = reshard.from_full_state(numpy_params(CFG, 0), CFG, SEED)
    zeros = tree.tree_map(np.zeros_like, params)
    store.save_checkpoint(str(root), {"params": params, "mu": zeros, "nu": zeros,
                                      "opt_step": np.asarray(0, np.int32)},
                          step=0, meta={"layout": SEED.to_meta(), "moment_dtype": "float32"})


def _roots(tmp, seed, names) -> dict:
    out = {}
    for name in names:
        out[name] = tmp / name.replace(" ", "_").replace(",", "")
        shutil.copytree(seed, out[name])
    return out


def _cases(table: dict, roots: dict) -> list:
    return [dict(dict(kind="sup", grid=grid, ranks=ranks, layout=lay, faults=faults,
                      steps=steps, data=data, plan=None, opt=OPT, sup=SUP,
                      root=str(roots[name])), **extra)
            for name, (grid, ranks, lay, faults, steps, data, extra) in table.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The seed checkpoint, both spawns and the launcher, started together;
    meanwhile the JAX supervisor's shrunk runs at data 2 and at data 2 x
    model 2."""
    tmp = tmp_path_factory.mktemp("shrink")
    jcfg = dataclasses.replace(JModelConfig(**RES), kernels=False)
    _seed(tmp / "seed")
    roots = _roots(tmp, tmp / "seed", [*TWO, *FOUR, "jax", "jax tp 2"])
    out = {"tmp": tmp, "roots": roots,
           "two": Spawn(tmp, "two", (2, 1), _cases(TWO, roots), None, None, worker=WORKER,
                        cfg=RES),
           "four": Spawn(tmp, "four", (4, 1), _cases(FOUR, roots), None, None, worker=WORKER,
                         cfg=RES)}
    fpath = tmp / "lose.json"
    flt.FaultPlan([flt.Fault("lose_replica", 2)]).save(str(fpath))
    out["cli"] = Procs(tmp, "cli", [[
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "-m", "repro_torch.launch.train", *CLI, "--mesh", "2x1", "--faults", str(fpath),
        "--checkpoint-dir", str(tmp / "cli_ck")]])
    for name, model in (("jax", 1), ("jax tp 2", 2)):
        sv = JSupervisor(jcfg, JAdamConfig(**OPT), JDataConfig(**DATA),
                         JMeshLayout(1, 2, model, n_microbatches=2),
                         ckpt_root=str(roots[name]), sup=JSupervisorConfig(**SUP),
                         fault_plan=jflt.FaultPlan([jflt.Fault("lose_replica", 3)]))
        out[name] = (sv, sv.run(6))
    out["jcfg"] = jcfg
    yield out
    for k in ("two", "four", "cli"):
        out[k].kill()


def _by_name(runs, spawn: str) -> dict:
    """case name -> every rank's output for it (None: the rank sat it out)."""
    table = TWO if spawn == "two" else FOUR
    outs = runs[spawn].result()
    return {name: [o["results"][i] for o in outs] for i, name in enumerate(table)}


def _losses(h: dict) -> list:
    return [h[s]["loss"] for s in sorted(h)]


def _full(outs: list) -> dict:
    """A run's final bundle in the full layout, from its grid's first rank."""
    return next(o["full"] for o in outs if o is not None and o.get("full"))


def _assert_states_close(got: dict, want: dict, what: str) -> None:
    """Weights and moments, leaf by leaf, at rtol 3e-4 / atol 3e-5
    (``tests/test_accumulation.py``'s)."""
    for part in ("params", "mu", "nu"):
        paths = [p for p, _ in tree.leaves_with_path(want[part])]
        assert [p for p, _ in tree.leaves_with_path(got[part])] == paths, what
        for path, g, w in zip(paths, tree.leaves(got[part]), tree.leaves(want[part])):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=3e-4, atol=3e-5,
                                       err_msg=f"{what}: {part} {path}")


def test_shrink_matches_jax(runs):
    """JAX's case on two ranks: the survivor goes on at data 1, zero steps
    lost, losses at JAX's rtol 1e-4; the leaver reports ``left`` at step 3
    and carries no state; the survivor's final weights and moments equal
    JAX's final state at rtol 3e-4 / atol 3e-5."""
    survivor, leaver = _by_name(runs, "two")["shrink"]
    r = survivor["result"]
    assert r["shrinks"] == 1 and r["restarts"] == r["lost_steps"] == r["skipped_steps"] == 0, r
    assert r["final_layout"]["data"] == 1 and survivor["grid"][:3] == (1, 1, 1)
    assert leaver["result"]["left"] == 3 and "state" not in leaver
    assert sorted(leaver["history"]) == [0, 1, 2]
    jsv, jr = runs["jax"]
    assert jr["shrinks"] == 1 and jr["lost_steps"] == 0
    h, jh = survivor["history"], jsv.history_by_step()
    assert sorted(h) == sorted(jh) == list(range(6))
    np.testing.assert_allclose(_losses(h), _losses(jh), rtol=1e-4)
    want = {"params": jsv.storage, "mu": jsv.opt["mu"], "nu": jsv.opt["nu"]}
    for (path, got), w in zip(tree.leaves_with_path(survivor["state"]), tree.leaves(want)):
        np.testing.assert_allclose(got, np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=str(path))


def test_resume_from_the_pre_shrink_checkpoint(runs, tmp_path):
    """The test's second half: a fresh one-process data=1 run seeded with the
    shrunk run's pre-shrink (data=2) checkpoint reshards it on restore,
    resumes at step 2 and retraces the shrunk run (rtol 1e-4)."""
    shrunk = _by_name(runs, "two")["shrink"][0]["history"]
    pre = [d for s, d in store.checkpoint_steps(str(runs["roots"]["shrink"])) if s <= 3][-1]
    assert reshard.saved_layout(store.load_manifest(pre), None).data == 2
    shutil.copytree(pre, tmp_path / os.path.basename(pre))
    sv = Supervisor(CFG, AdamConfig(**OPT), DataConfig(**DATA),
                    MeshLayout(1, 1, 1, n_microbatches=2), ckpt_root=str(tmp_path),
                    sup=SupervisorConfig(**SUP))
    sv.run(6)
    h = sv.history_by_step()
    assert sorted(h) == [2, 3, 4, 5]
    np.testing.assert_allclose(_losses(h), [shrunk[s]["loss"] for s in sorted(h)], rtol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_shrink_as_the_unshrunk_run(runs, layout):
    """Tensor parallel, replicated, pipelined, and two shrinks in one run:
    every survivor ends at the smaller grid with no step lost, the unshrunk
    run's losses (rtol 1e-4, the same ranks and weights) and its final
    weights and moments, assembled in the full layout (rtol 3e-4 / atol
    3e-5), so that a chunk drained to the wrong place shows.  Every leaver
    reports where it left.  (JAX's supervisor runs tp 2 in
    ``test_tp2_shrink_matches_jax``; each layout more costs two JAX
    compiles, ~10 s.)"""
    shrunk, unshrunk, spawn = LAYOUTS[layout]
    by = _by_name(runs, spawn)
    ref = next(o for o in by[unshrunk] if o is not None)["history"]
    n_shrinks = sum(f["kind"] == "lose_replica" for f in (TWO | FOUR)[shrunk][3])
    for o in by[shrunk]:
        if o is None:
            continue
        if "left" in o["result"]:
            assert o["result"]["left"] in (2, 3, 4) and "state" not in o
            continue
        r = o["result"]
        assert r["shrinks"] == n_shrinks and r["lost_steps"] == r["restarts"] == 0, r
        assert r["final_layout"]["data"] == 1
        assert sorted(o["history"]) == list(range(6))
        np.testing.assert_allclose(_losses(o["history"]), _losses(ref), rtol=1e-4)
    _assert_states_close(_full(by[shrunk]), _full(by[unshrunk]), layout)


def test_tp2_shrink_matches_jax(runs):
    """Data 2 x model 2 -> 1 x 2 against JAX's supervisor on the same grid
    and fault: zero steps lost on both, losses at rtol 1e-4, and the
    survivors' final weights and moments, assembled in the full layout,
    equal to JAX's at rtol 3e-4 / atol 3e-5."""
    from repro.resilience import reshard as jreshard

    outs = _by_name(runs, "four")["tp 2"]
    jsv, jr = runs["jax tp 2"]
    assert jr["shrinks"] == 1 and jr["lost_steps"] == 0 and jr["final_layout"]["data"] == 1
    for o in outs:
        if "left" not in o["result"]:
            np.testing.assert_allclose(_losses(o["history"]), _losses(jsv.history_by_step()),
                                       rtol=1e-4)
    want = {k: jreshard.to_full_state(v, runs["jcfg"], jsv.layout)
            for k, v in (("params", jsv.storage), ("mu", jsv.opt["mu"]), ("nu", jsv.opt["nu"]))}
    _assert_states_close(_full(outs), want, "tp 2 against JAX")


def test_bf16_moments_stay_bf16_through_the_shrink_and_a_restore(runs):
    """``AdamConfig(moment_dtype="bfloat16")``: the drained moments come
    back bf16 (``partition_local`` widens to fp32), the survivors'
    checkpoint holds bf16 moment files under a ``bfloat16`` meta, a crash
    after the shrink restores it and retraces the uncrashed run bit for
    bit, and the losses stay within rtol 1e-4 of the unshrunk run's."""
    by = _by_name(runs, "two")
    survivor, leaver = by["bf16 moments"]
    assert "left" in leaver["result"] and survivor["result"]["shrinks"] == 1
    assert survivor["moment_dtypes"] == ["torch.bfloat16"]
    for name in ("bf16 moments", "bf16 moments, crash"):
        manifest = store.load_manifest(os.path.join(runs["roots"][name], "step_00000004"))
        assert manifest["meta"]["moment_dtype"] == "bfloat16"
        assert manifest["meta"]["layout"]["data"] == 1
        assert {e["dtype"] for e in manifest["entries"]
                if e["name"].split("__")[0] in ("mu", "nu")} == {"bfloat16"}, name
    crashed = by["bf16 moments, crash"][0]
    r = crashed["result"]
    assert (r["shrinks"], r["restarts"], r["lost_steps"]) == (1, 1, 1), r
    assert "restore" in crashed["events"] and crashed["moment_dtypes"] == ["torch.bfloat16"]
    assert _losses(crashed["history"]) == _losses(survivor["history"])
    assert crashed["digest"] == survivor["digest"]
    ref = by["bf16 moments, unshrunk"][0]
    np.testing.assert_allclose(_losses(survivor["history"]), _losses(ref["history"]), rtol=1e-4)


def test_crash_after_the_shrink_restores_the_survivors_checkpoint(runs):
    """A crash two steps after the shrink: the survivors restore the step-4
    checkpoint they wrote on their own group (it records data=1), lose one
    step, and every step equals the shrunk run's without the crash, bit for
    bit; no collective of the default group, which still holds the ranks
    that left, is waited on."""
    by = _by_name(runs, "four")
    manifest = store.load_manifest(os.path.join(runs["roots"]["tp 2, crash"], "step_00000004"))
    assert MeshLayout.from_meta(manifest["meta"]["layout"]) == \
        MeshLayout(1, 1, 2, n_microbatches=2)
    for crashed, clean in zip(by["tp 2, crash"], by["tp 2"]):
        if "left" in crashed["result"]:
            continue
        r = crashed["result"]
        assert (r["shrinks"], r["restarts"], r["lost_steps"]) == (1, 1, 1), r
        assert "restore" in crashed["events"]
        assert _losses(crashed["history"]) == _losses(clean["history"])
        assert crashed["digest"] == clean["digest"]


def test_shrink_below_one_replica_is_refused(tmp_path):
    """JAX's first refusal, with its message; the state as an unfaulted run
    leaves it after the same steps."""
    lay = MeshLayout(1, 1, 1, n_microbatches=2)
    sup = SupervisorConfig(checkpoint_every=100)
    sv = Supervisor(CFG, AdamConfig(**OPT), DataConfig(**DATA), lay, ckpt_root=str(tmp_path / "a"),
                    sup=sup, fault_plan=flt.FaultPlan([flt.Fault("lose_replica", 2)]))
    with pytest.raises(SupervisorError, match=r"^cannot shrink below one data replica "
                                              r"\(step 2\)$"):
        sv.run(4)
    ok = Supervisor(CFG, AdamConfig(**OPT), DataConfig(**DATA), lay,
                    ckpt_root=str(tmp_path / "b"), sup=sup)
    ok.run(2)
    assert state_digest(sv._bundle()) == state_digest(ok._bundle())
    # JAX's own shrink refuses before it touches the state it is handed
    jsv = JSupervisor(dataclasses.replace(JModelConfig(**RES), kernels=False),
                      JAdamConfig(**OPT), JDataConfig(**DATA),
                      JMeshLayout(1, 1, 1, n_microbatches=2), ckpt_root=str(tmp_path / "j"))
    with pytest.raises(JSupervisorError, match=r"^cannot shrink below one data replica "
                                               r"\(step 2\)$"):
        jsv._shrink(None, None, 2)


def test_a_plan_that_rejects_the_shrink_refuses_it(runs):
    """JAX's second refusal: ``shrink_execution`` rejects the plan before any
    tensor moves; the message is JAX's, and every rank's state is the one
    an unfaulted run has after the same two steps."""
    by = _by_name(runs, "two")
    with pytest.raises(ValueError) as jerr:
        jplan.shrink_execution(BAD_PLAN, data=1)
    for refused, ok in zip(by["plan refusal"], by["two steps"]):
        assert refused["error"] == f"failure-shrink to data=1 rejected by the plan: {jerr.value}"
        assert refused["digest"] == ok["digest"]
        assert sorted(refused["history"]) == [0, 1]


CLI = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "4", "--global-batch",
       "4", "--seq-len", "16", "--microbatches", "2", "--checkpoint-every", "2",
       "--log-every", "10"]


def test_train_cli_shrinks_and_the_leaver_exits_zero(runs, capsys, tmp_path):
    """``launch.train --mesh 2x1 --faults`` (``lose_replica`` before step 2)
    under ``torch.distributed.run``: the launcher exits 0, so the leaving
    rank's process did too; the survivor reports one shrink and no lost
    step, its step-4 checkpoint records data=1, and its history is one
    process's ``--mesh 1x1`` run's (1e-6: fp32 sums in another order)."""
    (stdout,) = runs["cli"].wait()
    got = json.loads(stdout.splitlines()[-1])
    assert got["shrinks"] == 1 and got["lost_steps"] == got["restarts"] == 0
    assert got["final_layout"]["data"] == 1
    manifest = store.load_manifest(str(runs["tmp"] / "cli_ck" / "step_00000004"))
    assert manifest["meta"]["layout"]["data"] == 1
    want = train.main(CLI + ["--mesh", "1x1", "--resume", "auto", "--checkpoint-dir",
                             str(tmp_path / "ck1")])
    capsys.readouterr()
    g = {h["step"]: h for h in got["history"]}
    w = {h["step"]: h for h in want["history"]}
    assert sorted(g) == sorted(w) == [0, 1, 2, 3]
    for s in w:
        np.testing.assert_allclose([g[s]["loss"], g[s]["grad_norm"]],
                                   [w[s]["loss"], w[s]["grad_norm"]], rtol=1e-6)
