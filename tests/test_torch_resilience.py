"""The port's supervised training loop (``resilience/supervisor.py``) and the
pre-update gate of its train steps, as ``tests/test_resilience.py`` holds
the JAX package's, on the CPU.

A crashed run resumes and retraces the unkilled trajectory bit for bit; a
corrupt checkpoint is rejected (``restore_rejected``) and the run falls back
a step; nan and spike steps are skipped and leave the state bit for bit as
it was; the restart budget holds; a checkpoint the JAX supervisor wrote on a
data=2 mesh resumes on the port's one rank through a reshard, and the next
steps are those JAX takes from it; and ``launch.train --faults --resume
auto`` mirrors JAX's CLI case, in one process and as two gloo ranks under
``torch.distributed.run``.  The failure-shrink (``lose_replica``) is
``tests/test_torch_shrink.py``'s.
"""
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from repro.data.synthetic import DataConfig as JDataConfig
from repro.models.common import ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.resilience.reshard import MeshLayout as JMeshLayout
from repro.resilience.supervisor import Supervisor as JSupervisor
from repro.resilience.supervisor import SupervisorConfig as JSupervisorConfig
from repro_torch import tree
from repro_torch.checkpointing import store
from repro_torch.core import stepfn
from repro_torch.core.accumulation import AccumConfig
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.launch import train
from repro_torch.models.common import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.resilience import faults as flt
from repro_torch.resilience.reshard import MeshLayout
from repro_torch.resilience.supervisor import Supervisor, SupervisorConfig, SupervisorError
from test_torch_dist import Procs

# tests/test_resilience.py's configuration
RES = dict(name="res", arch_type="dense", num_layers=4, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32")
CFG = ModelConfig(**RES)
OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=100)
DATA = dict(vocab_size=64, seq_len=16, global_batch=8, n_microbatches=2, seed=0)
SUP = SupervisorConfig(checkpoint_every=2, keep_checkpoints=3)
FLAT = MeshLayout(1, 1, 1, partitioned=False, n_microbatches=2)


def _run(root, layout=FLAT, fault_list=None, steps=8, sup=SUP, metrics=None):
    plan = flt.FaultPlan(fault_list) if fault_list is not None else None
    sink = obs_metrics.MetricsSink(str(metrics) if metrics else None)
    sv = Supervisor(CFG, AdamConfig(**OPT), DataConfig(**DATA), layout, ckpt_root=str(root),
                    sup=sup, fault_plan=plan, sink=sink)
    try:
        return sv, sv.run(steps)
    finally:
        sink.close()


def _state(sv) -> list:
    return [t.clone() for t in tree.leaves(sv._bundle())]


@pytest.mark.parametrize("layout", [FLAT, MeshLayout(1, 1, 1, n_microbatches=2)],
                         ids=["replicated", "partitioned"])
def test_crash_resume_trajectory_parity(tmp_path, layout):
    """A crash before step 5 restores step 4 (one lost step) into the
    tensors the run holds; the history and the final state equal the
    unkilled run's bit for bit."""
    sv_kill, r_kill = _run(tmp_path / "kill", layout, [flt.Fault("crash", 5)])
    sv_ok, r_ok = _run(tmp_path / "ok", layout, [])
    assert r_kill["restarts"] == 1 and r_kill["lost_steps"] == 1
    h_kill, h_ok = sv_kill.history_by_step(), sv_ok.history_by_step()
    assert sorted(h_kill) == sorted(h_ok) == list(range(8))
    for s in h_ok:
        assert (h_kill[s]["loss"], h_kill[s]["grad_norm"]) == \
            (h_ok[s]["loss"], h_ok[s]["grad_norm"]), s
    for a, b in zip(_state(sv_kill), _state(sv_ok)):
        assert torch.equal(a, b)
    assert [io["op"] for io in sv_kill.io].count("restore") == 1


def test_corrupt_checkpoint_falls_back_a_step(tmp_path):
    """The step-6 checkpoint is corrupted and the run crashes before step
    7: the restore rejects step 6 (logged) and resumes from step 4."""
    mpath = tmp_path / "m.jsonl"
    sv, r = _run(tmp_path / "ck", FLAT, [flt.Fault("corrupt_checkpoint", 5),
                                         flt.Fault("crash", 7)], steps=10, metrics=mpath)
    assert r["restarts"] == 1 and r["lost_steps"] == 3, r
    assert sorted(sv.history_by_step()) == list(range(10))
    events = [rec for rec in obs_metrics.read_jsonl(str(mpath)) if rec["event"] != "step"]
    names = [e["event"] for e in events]
    assert names[:3] == ["injected_corruption", "restore_rejected", "restart"], names
    assert events[1]["dir"].endswith("step_00000006") and "checksum" in events[1]["error"]
    assert events[2]["resume_step"] == 4
    _, r_ok = _run(tmp_path / "ok", FLAT, [], steps=10)
    assert r["last_loss"] == r_ok["last_loss"]


@pytest.mark.parametrize("fault,layout", [
    (flt.Fault("nan_grad", 3), FLAT),
    (flt.Fault("nan_grad", 3), MeshLayout(1, 1, 1, n_microbatches=2)),
    (flt.Fault("grad_spike", 5, scale=1e6), FLAT)], ids=["nan", "nan-partitioned", "spike"])
def test_anomalous_step_is_skipped_state_unchanged(tmp_path, fault, layout):
    """The gate refuses the step before any write: no history record, an
    ``anomaly`` event, the same state digest before and after; the run's
    later steps are those of a run that never saw that batch."""
    mpath = tmp_path / "m.jsonl"
    sv, r = _run(tmp_path / "ck", layout, [fault], steps=fault.step + 2, metrics=mpath)
    assert r["skipped_steps"] == 1 and r["restarts"] == 0, r
    assert fault.step not in sv.history_by_step()
    (skip,) = sv.skipped
    assert skip["step"] == fault.step and skip["digest_before"] == skip["digest_after"]
    (anom,) = [e for e in obs_metrics.read_jsonl(str(mpath)) if e["event"] == "anomaly"]
    assert anom["step"] == fault.step and set(anom) >= {"loss", "grad_norm", "reason"}
    assert np.isfinite(r["last_loss"])


@pytest.mark.parametrize("part", [False, True], ids=["replicated", "partitioned"])
def test_refused_update_writes_nothing(part):
    """``build_train_step(gate=...)`` refusing: storage, moments and the
    step count bit for bit as before, the same opt dict, ``skipped`` set;
    the gate sees the step's loss and grad norm."""
    storage = stepfn.init_storage(CFG, 0, partitioned=part, device="cpu")
    opt = adam_init(storage)
    seen = []
    step = stepfn.build_train_step(CFG, AccumConfig("layered", part, 2), AdamConfig(**OPT),
                                   gate=lambda loss, gn: seen.append((loss, gn)) and False)
    ok = stepfn.build_train_step(CFG, AccumConfig("layered", part, 2), AdamConfig(**OPT))
    batch = make_batch(DataConfig(**DATA), 0)
    before = [t.clone() for t in tree.leaves({"s": storage, "o": opt})]
    s2, o2, m = step(storage, opt, batch)
    assert m["skipped"] and o2 is opt and len(seen) == 1
    for a, b in zip(before, tree.leaves({"s": s2, "o": o2})):
        assert torch.equal(a, b)
    _, _, m_ok = ok(storage, opt, batch)
    assert seen[0][0].item() == m_ok["loss"].item()
    assert seen[0][1].item() == m_ok["grad_norm"].item()


def test_restart_budget_is_bounded(tmp_path):
    sup = SupervisorConfig(max_restarts=0, checkpoint_every=2)
    with pytest.raises(SupervisorError, match="giving up after 0 restarts"):
        _run(tmp_path, FLAT, [flt.Fault("crash", 3)], steps=6, sup=sup)


def test_resume_reshards_across_layouts(tmp_path):
    """The JAX supervisor trains 4 steps on a data=2 mesh (kernels off) and
    checkpoints; the port's supervisor on one rank restores that checkpoint
    (the manifest's layout drives the reshard) and takes steps 4 and 5 as
    the JAX supervisor does on its own one-device mesh from the same files."""
    jcfg = dataclasses.replace(JModelConfig(**RES), kernels=False)
    jsup = JSupervisorConfig(checkpoint_every=2, keep_checkpoints=3)
    JSupervisor(jcfg, JAdamConfig(**OPT), JDataConfig(**DATA),
                JMeshLayout(1, 2, 1, partitioned=True, n_microbatches=2),
                ckpt_root=str(tmp_path / "j2"), sup=jsup).run(4)
    for name in ("port", "jax1"):
        shutil.copytree(tmp_path / "j2", tmp_path / name)
    sv, r = _run(tmp_path / "port", MeshLayout(1, 1, 1, n_microbatches=2), [], steps=6)
    jsv = JSupervisor(jcfg, JAdamConfig(**OPT), JDataConfig(**DATA),
                      JMeshLayout(1, 1, 1, partitioned=True, n_microbatches=2),
                      ckpt_root=str(tmp_path / "jax1"), sup=jsup)
    jsv.run(6)
    got, want = sv.history_by_step(), jsv.history_by_step()
    assert sorted(got) == sorted(want) == [4, 5]
    for s in want:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[s][k], want[s][k], rtol=1e-5, err_msg=f"{s} {k}")


# ---------------------------------------------------------------------------
# The entry point: kill at step k -> auto-resume -> parity
# ---------------------------------------------------------------------------
CLI = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "4", "--global-batch",
       "4", "--seq-len", "16", "--microbatches", "1", "--mesh", "1x1", "--no-partition",
       "--checkpoint-every", "2", "--log-every", "10"]


def test_train_cli_faults_auto_resume(tmp_path, capsys):
    """tests/test_resilience.py's CLI case on the port."""
    fpath = tmp_path / "faults.json"
    flt.FaultPlan([flt.Fault("crash", 3)]).save(str(fpath))
    mpath = tmp_path / "metrics.jsonl"
    r_kill = train.main(CLI + ["--checkpoint-dir", str(tmp_path / "ck"), "--resume", "auto",
                               "--faults", str(fpath), "--metrics", str(mpath)])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["restarts"] == 1
    r_ok = train.main(CLI + ["--checkpoint-dir", str(tmp_path / "ck2"), "--resume", "auto"])
    assert r_kill["restarts"] == 1 and r_kill["lost_steps"] == 1
    assert r_kill["last_loss"] == r_ok["last_loss"]
    recs = obs_metrics.read_jsonl(str(mpath))
    events = {r.get("event") for r in recs}
    assert "restart" in events and "summary" in events
    restart = next(r for r in recs if r.get("event") == "restart")
    assert restart["lost_steps"] == 1 and restart["resume_step"] == 2
    assert [s for s, _ in store.checkpoint_steps(str(tmp_path / "ck"))] == [2, 4]


def test_train_cli_faults_need_a_checkpoint_dir(capsys):
    with pytest.raises(SystemExit):
        train.main(CLI + ["--resume", "auto"])
    assert "require --checkpoint-dir" in capsys.readouterr().err


def test_train_cli_auto_resume_across_two_ranks(tmp_path, capsys):
    """``--mesh 2x1`` under ``torch.distributed.run`` (gloo): rank 0 writes
    each checkpoint from both ranks' chunks, both restore after the crash,
    and the history equals one process's ``--mesh 1x1`` run (1e-6: fp32 sums
    in another order), crash and all."""
    fpath = tmp_path / "faults.json"
    flt.FaultPlan([flt.Fault("crash", 3)]).save(str(fpath))
    argv = [a for a in CLI if a != "--no-partition"] + ["--resume", "auto", "--faults",
                                                         str(fpath)]
    argv[argv.index("--microbatches") + 1] = "2"
    two = list(argv)
    two[two.index("--mesh") + 1] = "2x1"
    proc = Procs(tmp_path, "sup2", [[
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
        "2", "-m", "repro_torch.launch.train", *two, "--checkpoint-dir", str(tmp_path / "ck2")]])
    want = train.main(argv + ["--checkpoint-dir", str(tmp_path / "ck1")])
    capsys.readouterr()
    (stdout,) = proc.wait()
    got = json.loads(stdout.splitlines()[-1])
    assert got["restarts"] == want["restarts"] == 1 and got["lost_steps"] == 1
    g = {h["step"]: h for h in got["history"]}
    w = {h["step"]: h for h in want["history"]}
    assert sorted(g) == sorted(w) == [0, 1, 2, 3]
    for s in w:
        np.testing.assert_allclose([g[s]["loss"], g[s]["grad_norm"]],
                                   [w[s]["loss"], w[s]["grad_norm"]], rtol=1e-6)
    assert os.path.exists(tmp_path / "ck2" / "step_00000004" / "manifest.json")
