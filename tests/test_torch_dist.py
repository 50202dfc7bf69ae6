"""The port over a data x model grid of processes (gloo, on the CPU) against
the JAX package: gradients of both schedules in both layouts at meshes 2x1,
1x2, 2x2 and 1x4 (the last replicates the KV heads); at 1x2, 2x2 and 1x4
the same for the other dense configs' smoke variants; the recurrent families
(rwkv6-3b and zamba2-7b smoke, rwkv with TP-padded heads at 1x2 and 1x4)
against the JAX package's own mesh run at 2x1, 1x2, 2x2 and 1x4; at 2x2
the exact collective schedule, a bf16 reduce wire, the storage layout, a
3-step trajectory and the §C.3 fused step; a group of one against no group;
and ``launch.train --mesh 2x1`` under ``torch.distributed.run``.

Every rank of one mesh runs all its cases in one spawn
(``tests/torch_dist_ranks.py``, one thread each, a file store); all spawns
and the launcher start together.  A spawn fails when none of its processes
has written a line for ``STALL_S`` seconds (a hang), or after ``LIMIT_S``
in all; a slow host only makes it take longer.  The JAX side runs in this
process meanwhile.
"""
import dataclasses
import json
import math
import os
import pathlib
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import stepfn as jstepfn
from repro.core.accumulation import AccumConfig as JAccumConfig
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.models import transformer as JT
from repro.models.common import AxisCtx as JAxisCtx
from repro.models.common import ModelConfig as JModelConfig
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as jadam_init
from repro_torch import configs, tree
from repro_torch.core import partition as zp
from repro_torch.core import stepfn
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_ranks.py"
# a spawn's hang guard: no process of it has written a line (each rank
# prints one a case) for STALL_S seconds; LIMIT_S bounds it in all.  Sized
# for a host running six test files at once (pytest -n 6), where a spawn's
# ranks share the cores with every other file's
STALL_S, LIMIT_S = 180, 600

# the CFG of tests/test_accumulation.py: 3 layers, 4 q / 2 KV heads
ACC = dict(name="t", arch_type="dense", num_layers=3, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
           param_dtype="float32")
JCFG, TCFG = JModelConfig(**ACC), ModelConfig(**ACC)
M, L = 4, ACC["num_layers"]
N_LAYER_LEAVES, N_OUTER_LEAVES = 9, 3        # ln1, ln2, wq/wk/wv/wo, 3 MLP; embed, head, norm
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
GRAD_CASES = [dict(kind="grads", method=m, part=p)
              for m in ("standard", "layered") for p in (False, True)]
DATA = dict(vocab_size=64, seq_len=16, global_batch=8, n_microbatches=M)
OPT = dict(lr=3e-3, warmup_steps=1, decay_steps=4)
# small enough that the fused step's per-leaf clip engages on most leaves
FUSED_CLIP = 0.05
TRAIN_CASES = [
    dict(kind="train", fused=False, steps=3, data=DATA, opt=OPT),
    dict(kind="train", fused=True, steps=3, data=DATA, opt=dict(OPT, grad_clip=FUSED_CLIP)),
    dict(kind="train", fused=False, steps=3, data=DATA, opt=dict(OPT, grad_clip=0.0)),
    dict(kind="train", fused=True, steps=3, data=DATA, opt=dict(OPT, grad_clip=0.0)),
]
# 2x2 only, after the train cases: a bf16 wire for the reduce-scatter, and
# the storage layout both ways with gather_params
BF16_REDUCE = dict(kind="grads", method="layered", part=True, reduce_dtype="bfloat16")
EXTRA_CASES = [BF16_REDUCE, dict(kind="layout")]
# 1x2, 2x2 and 1x4, last: both schedules in both layouts on the smoke
# variants of the other dense configs (MQA replicated over the model group,
# tied and scaled embedding, rmsnorm_p1, window and softcaps, LayerNorm,
# plain GELU; at 1x4 the KV heads of all but paper-x32 are replicated); each
# case brings its config, weights and batch
OTHER_ARCHS = ("gemma-2b", "gemma2-9b", "granite-20b", "paper-x32")
OTHER_CASES = [dict(kind="grads", method=m, part=p, arch=a)
               for a in OTHER_ARCHS for m in ("standard", "layered") for p in (True, False)]
OTHER_MESHES = ("1x2", "2x2", "1x4")
# the recurrent families, last: rwkv6-3b's smoke config (40 heads), zamba2-7b's
# at 4 layers (the shared block after layers 1 and 3), and rwkv with 6 heads
# padded for tp 4 (8 heads, at tp 2 and 4); both schedules in both layouts
RECURRENT = {"rwkv6-3b": ("2x1", "1x2", "2x2"), "zamba2-7b": ("2x1", "1x2", "2x2"),
             "rwkv6-3b-padded": ("1x2", "1x4")}
RECURRENT_CASES = {mesh: [dict(kind="grads", method=m, part=p, arch=a)
                          for a, meshes in RECURRENT.items() if mesh in meshes
                          for m in ("standard", "layered") for p in (True, False)]
                   for mesh in MESHES}
# relative part of the recurrent gradients' tolerance, of each leaf's scale
# (tests/test_torch_ssm.py's GRAD_TOL; rwkv's group norm amplifies rounding:
# the JAX package's own 2x2 run and its one-device gradient differ by 1.0e-3
# of w_r's scale)
RECURRENT_TOL = {"rwkv6-3b": 3e-3, "zamba2-7b": 3e-4, "rwkv6-3b-padded": 3e-3}
CASES = {"2x1": GRAD_CASES, "1x2": GRAD_CASES + OTHER_CASES,
         "2x2": GRAD_CASES + TRAIN_CASES + EXTRA_CASES + OTHER_CASES,
         "1x4": GRAD_CASES + OTHER_CASES}
CASES = {mesh: c + RECURRENT_CASES[mesh] for mesh, c in CASES.items()}


def numpy_params(cfg, seed: int) -> dict:
    """A dense config's weights as the JAX package's ``init_params`` draws
    them in kind (matrices at 1/sqrt(fan-in), the embedding and head at
    0.02, norm scales 1), from numpy's seeded generator: the weights a test
    gives both packages, without a JAX compile."""
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        if path[-1] == "scale":
            return np.ones(shape, np.float32)
        scale = 0.02 if path[-1] in ("embed", "head") else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(tree.tree_map_with_path(draw, stepfn.full_template(cfg)), shared={})


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


class Procs:
    """Processes started now; ``wait`` joins them under the hang guard
    (``STALL_S``, ``LIMIT_S``), and a nonzero exit fails the test with its
    output (every later ``wait`` fails the same way)."""

    def __init__(self, tmp: pathlib.Path, name: str, cmds: list[list[str]]):
        self.name, self.t0 = name, time.monotonic()
        self.files = [(open(tmp / f"{name}.{i}.out", "w+"), open(tmp / f"{name}.{i}.err", "w+"))
                      for i in range(len(cmds))]
        self.procs = [subprocess.Popen(cmd, env=_env(), cwd=tmp, stdout=out, stderr=err)
                      for cmd, (out, err) in zip(cmds, self.files)]
        self.stdout = None
        self.failed = None

    def _join(self) -> None:
        """Until every process has ended: the output files' sizes are the
        progress, and a stall or the whole limit fails the spawn."""
        size, seen = -1, time.monotonic()
        while any(p.poll() is None for p in self.procs):
            now = time.monotonic()
            grown = sum(os.fstat(f.fileno()).st_size for pair in self.files for f in pair)
            if grown != size:
                size, seen = grown, now
            if now - seen > STALL_S or now - self.t0 > LIMIT_S:
                self.kill()
                self.failed = (f"{self.name}: no progress for {now - seen:.0f} s, "
                               f"{now - self.t0:.0f} s after its start (hang guard "
                               f"{STALL_S} s, limit {LIMIT_S} s)")
                pytest.fail(self.failed)
            time.sleep(0.2)

    def wait(self) -> list[str]:
        """Every process's standard output, in order."""
        if self.failed:
            pytest.fail(self.failed)
        if self.stdout is None:
            self._join()
            texts = []
            for i, (p, files) in enumerate(zip(self.procs, self.files)):
                for f in files:
                    f.seek(0)
                out, err = (f.read() for f in files)
                for f in files:
                    f.close()
                if p.returncode != 0 and self.failed is None:
                    self.failed = f"{self.name} process {i} exited {p.returncode}:\n{out}\n{err}"
                texts.append(out)
            if self.failed:
                pytest.fail(self.failed)
            self.stdout = texts
        return self.stdout

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class Spawn(Procs):
    """The ranks of one mesh (``worker``: ``tests/torch_dist_ranks.py``, or
    another worker that reads its job), started now; with ``pods``, a 3-dim
    mesh is ``(pod, data, model)``."""

    def __init__(self, tmp: pathlib.Path, name: str, mesh, cases, params, batch, *,
                 worker: pathlib.Path = WORKER, cfg: dict = ACC, pods: bool = False):
        self.job = tmp / f"{name}.job"
        with open(self.job, "wb") as f:
            pickle.dump({"mesh": mesh, "store": str(tmp / f"{name}.store"), "cfg": cfg,
                         "params": params, "batch": batch, "cases": cases, "pods": pods}, f)
        self.world = math.prod(mesh)
        super().__init__(tmp, name, [[sys.executable, str(worker), str(self.job), str(r)]
                                     for r in range(self.world)])
        self._out = None

    def result(self) -> list[dict]:
        """Every rank's output, in rank order."""
        if self._out is None:
            self.wait()
            outs = []
            for r in range(self.world):
                with open(f"{self.job}.{r}", "rb") as f:
                    outs.append(pickle.load(f))
            self._out = outs
        return self._out


CLI_ARGV = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "32",
            "--global-batch", "4"]


@pytest.fixture(scope="module")
def weights(mesh22):
    """The JAX weights (numpy, global), the JAX partitioned storage on the
    2x2 mesh, and a micro-batched batch."""
    jcfg = dataclasses.replace(JCFG, kernels=False)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jstepfn.init_storage(jcfg, mesh22, key,
                                                           partitioned=False))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (M, 2, 16), 0, 64), np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1), "mask": np.ones_like(toks)}
    return params, batch


@pytest.fixture(scope="module")
def other_configs():
    """arch -> (the JAX config with its kernels off, the port's, the JAX
    weights as numpy, a micro-batched batch) for the smoke variants."""
    out = {}
    for i, arch in enumerate(OTHER_ARCHS):
        jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), kernels=False)
        tcfg = configs.get_config(arch, smoke=True)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jconfigs.get_config(arch, smoke=True))
        params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(10 + i)))
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(20 + i), (M, 2, 16), 0,
                                             tcfg.vocab_size), np.int32)
        out[arch] = (jcfg, tcfg, params, {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
                                          "mask": np.ones_like(toks)})
    return out


def _recurrent_cfg(arch: str):
    """(JAX config with its kernels off, the port's) of a recurrent case."""
    name = arch.removesuffix("-padded")
    j, t = jconfigs.get_config(name, smoke=True), configs.get_config(name, smoke=True)
    if name == "zamba2-7b":
        j, t = (dataclasses.replace(c, num_layers=4) for c in (j, t))
    if arch.endswith("-padded"):
        j, t = (dataclasses.replace(c, rwkv_heads=6).padded_for_tp(4) for c in (j, t))
        assert t.rwkv_heads == 8
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return dataclasses.replace(j, kernels=False), t


@pytest.fixture(scope="module")
def recurrent_configs():
    """arch -> (JAX config, port config, JAX weights as numpy, a micro-batched
    batch with a few masked tokens)."""
    out = {}
    for i, arch in enumerate(RECURRENT):
        jcfg, tcfg = _recurrent_cfg(arch)
        params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(30 + i)))
        toks = np.random.default_rng(40 + i).integers(0, tcfg.vocab_size, (M, 2, 17))
        mask = np.ones((M, 2, 16), np.int32)
        mask[:, 1, 12:] = 0
        out[arch] = (jcfg, tcfg, params, {"tokens": toks[..., :-1].astype(np.int32),
                                          "labels": toks[..., 1:].astype(np.int32),
                                          "mask": mask})
    return out


@pytest.fixture(scope="module")
def spawns(tmp_path_factory, weights, other_configs, recurrent_configs):
    """Every mesh's ranks, started together."""
    tmp = tmp_path_factory.mktemp("dist")
    params, batch = weights

    def expand(c):
        if "arch" not in c:
            return c
        _, tcfg, p, b = (recurrent_configs if c["arch"] in RECURRENT else other_configs)[c["arch"]]
        return dict(c, cfg=dataclasses.asdict(tcfg), params=p, batch=b)

    out = {name: Spawn(tmp, name, mesh, [expand(c) for c in CASES[name]], params, batch)
           for name, mesh in MESHES.items()}
    local = [dict(c, local=True) for c in GRAD_CASES + TRAIN_CASES[:1]]
    out["1x1"] = Spawn(tmp, "1x1", (1, 1), GRAD_CASES + TRAIN_CASES[:1] + local, params,
                       batch)
    out["cli"] = Procs(tmp, "cli", [[
        sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
        "-m", "repro_torch.launch.train", *CLI_ARGV, "--mesh", "2x1"]])
    yield out
    for s in out.values():
        s.kill()


# ---------------------------------------------------------------------------
# The partition specs (no processes needed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("part", [False, True])
def test_specs_match_jax(tp, part):
    """``param_specs`` and ``storage_specs`` name the dims the JAX package's
    PartitionSpecs do (tp 4 replicates the 2 KV heads)."""
    from repro_torch.core.dist import AxisCtx
    jaxis = JAxisCtx(data="data", model="model", tp=tp, dp=2, ndata=2)
    want = jstepfn.storage_specs(JCFG, jaxis, part)
    got = stepfn.storage_specs(TCFG, AxisCtx(tp=tp, ndata=2), part)
    wants = {tuple(p.key for p in path): tuple(sp)
             for path, sp in jax.tree_util.tree_leaves_with_path(
                 want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert dict(tree.leaves_with_path(got)) == wants


# ---------------------------------------------------------------------------
# Reassembling the ranks' shares into global leaves
# ---------------------------------------------------------------------------
def _global(outs: list[dict], leaves_of, tp: int, partitioned: bool, cfg=TCFG) -> dict:
    """The ranks' storage-layout trees -> global numpy leaves in the JAX
    tree's layout.  Ranks that must hold equal shares are checked equal."""
    specs = T.param_specs(cfg, tp)
    tmpl = stepfn.full_template(cfg)
    ndata = max(o["data_index"] for o in outs) + 1
    by = {(o["data_index"], o["model_index"]): leaves_of(o) for o in outs}

    def one(path, shape, spec):
        def get(d, m):
            t = by[d, m]
            for k in path:
                t = t[k]
            return t
        dim = zp.model_dim(spec)
        stacked = path[0] == "layers"
        ms = range(tp) if dim is not None else [0]
        for d in range(ndata):          # replicated leaves: equal on every model rank
            for m in range(tp):
                if dim is None:
                    np.testing.assert_array_equal(get(d, m), get(d, 0), err_msg=str(path))
        if partitioned:
            blocks = np.concatenate(
                [np.concatenate([get(d, m) for d in range(ndata)], axis=-2) for m in ms],
                axis=-3)
            return zp.host_unpartition_leaf(blocks, shape, tp, stacked=stacked,
                                            model_dim=dim)
        for d in range(1, ndata):       # replicated storage: equal on every data rank
            for m in ms:
                np.testing.assert_array_equal(get(d, m), get(0, m), err_msg=str(path))
        return np.concatenate([get(0, m) for m in ms], axis=dim or 0)

    return tree.tree_map_with_path(one, tmpl, specs)


def _compare(got: dict, want, **tol):
    wants = {tuple(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    pairs = list(tree.leaves_with_path(got))
    assert sorted(p for p, _ in pairs) == sorted(wants)
    for path, leaf in pairs:
        np.testing.assert_allclose(leaf, wants[path], err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# Gradients at every mesh, both schedules, both layouts
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(weights):
    """``jax.grad`` of the mean token loss, one device, the kernels on
    (Pallas interpret), as tests/test_accumulation.py's ``_reference``."""
    params, batch = weights
    flat = {k: jnp.asarray(v).reshape(M * 2, 16) for k, v in batch.items()}

    def loss(p):
        _, (nll, n) = JT.loss_fn(JCFG, p, flat, JAxisCtx(), remat=False)
        return nll / n

    grads = jax.grad(loss)(jax.tree.map(jnp.asarray, params))
    return {k: v for k, v in grads.items() if k != "shared"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", range(len(GRAD_CASES)),
                         ids=[f"{c['method']}-{'part' if c['part'] else 'repl'}"
                              for c in GRAD_CASES])
def test_grads_match_reference(spawns, reference, mesh, case):
    """Tolerance of tests/test_accumulation.py (rtol 3e-4, atol 3e-5)."""
    outs = spawns[mesh].result()
    tp = MESHES[mesh][1]
    c = GRAD_CASES[case]
    got = _global(outs, lambda o: o["results"][case]["grads"], tp, c["part"])
    _compare(got, reference, rtol=3e-4, atol=3e-5)
    losses = {o["results"][case]["loss"] for o in outs}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert all(o["results"][case]["ntok"] == M * 2 * 16 for o in outs)


@pytest.fixture(scope="module")
def other_references(other_configs):
    """arch -> (loss, ``jax.grad``) of the JAX mean token loss, one device,
    kernels off."""
    out = {}
    for arch, (jcfg, _, params, batch) in other_configs.items():
        flat = {k: jnp.asarray(v).reshape(M * 2, 16) for k, v in batch.items()}

        def loss(p, jcfg=jcfg, flat=flat):
            _, (nll, n) = JT.loss_fn(jcfg, p, flat, JAxisCtx(), remat=False)
            return nll / n

        p = jax.tree.map(jnp.asarray, params)
        out[arch] = float(loss(p)), {k: v for k, v in jax.grad(loss)(p).items()
                                     if k != "shared"}
    return out


def _jax_mesh_grads(jcfg, mesh_shape, params: dict, batch: dict) -> dict:
    """The JAX package's own layered, partitioned gradient on a (data, model)
    mesh of virtual CPU devices (its kernels off), unpartitioned to global
    numpy leaves."""
    from repro import compat
    from repro.core.accumulation import make_grad_fn as jmake_grad_fn
    from repro.core.partition import host_unpartition_leaf
    mesh = jax.make_mesh(mesh_shape, ("data", "model"))
    axis = jstepfn.axis_ctx(mesh)
    tmpl = jstepfn.full_template(jcfg)
    grad_fn = jmake_grad_fn(jcfg, axis, JAccumConfig("layered", True, M), tmpl)
    sspecs = jstepfn.storage_specs(jcfg, axis, True)
    fn = jax.jit(compat.shard_map(lambda s, b: grad_fn(s, b)[0], mesh=mesh,
                                  in_specs=(sspecs, jstepfn.batch_specs(jcfg, axis,
                                                                        microbatched=True)),
                                  out_specs=sspecs))
    specs = JT.param_specs(jcfg, axis.tp)
    storage = jax.tree_util.tree_map_with_path(
        lambda path, a, sp: zp.host_partition_leaf(a, axis.tp, axis.ndata,
                                                   stacked=path[0].key == "layers",
                                                   model_dim=zp.model_dim(tuple(sp))),
        params, specs)
    grads = fn(storage, batch)
    return jax.tree_util.tree_map_with_path(
        lambda path, c, t, sp: host_unpartition_leaf(np.asarray(c), t.shape, sp, axis.tp,
                                                     stacked=path[0].key == "layers"),
        grads, tmpl, specs)


@pytest.mark.parametrize("mesh,arch", [(m, a) for a, ms in RECURRENT.items() for m in ms])
def test_recurrent_grads_match_jax_mesh(spawns, recurrent_configs, mesh, arch):
    """rwkv6-3b and zamba2-7b (and rwkv with TP-padded heads at 1x2 and 1x4) over
    data x model ranks, both schedules in both layouts, against the JAX
    package's own layered partitioned gradient on the same mesh (its kernels
    off): every leaf at ``RECURRENT_TOL`` of its scale plus 3e-5, the loss
    equal on every rank; layered and partitioned over a data group, the
    exact gather and reduce-scatter counts (the outer leaves, a hybrid's
    shared block among them, once a step).  Which replicated leaves take a
    partial gradient on a model rank (Mamba's ``w_B``/``w_C``, RWKV's
    ``mix``; ``transformer.model_partial_leaves``) is what this holds."""
    jcfg, tcfg, params, batch = recurrent_configs[arch]
    want = _jax_mesh_grads(jcfg, MESHES[mesh], params, batch)
    want = {k: v for k, v in want.items() if k != "shared" or v}
    outs = spawns[mesh].result()
    tol = RECURRENT_TOL[arch]
    for i, case in enumerate(CASES[mesh]):
        if case.get("arch") != arch:
            continue
        got = _global(outs, lambda o: o["results"][i]["grads"], MESHES[mesh][1],
                      case["part"], tcfg)
        wants = {tuple(p.key for p in path): np.asarray(leaf)
                 for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
        pairs = dict(tree.leaves_with_path(got))
        assert sorted(pairs) == sorted(wants)
        for path, leaf in pairs.items():
            w = wants[path]
            np.testing.assert_array_less(np.abs(leaf - w), 3e-5 + tol * np.abs(w).max(),
                                         err_msg=f"{case['method']} {case['part']} {path}")
        assert len({o["results"][i]["loss"] for o in outs}) == 1
        if case["method"] == "layered" and case["part"] and MESHES[mesh][0] > 1:
            # one gather per layer leaf and pass, and the outer leaves (a
            # hybrid's shared block among them) gathered and reduced once
            n_layer = len(tree.leaves(stepfn.full_template(tcfg)["layers"]))
            n_outer = len(tree.leaves(stepfn.full_template(tcfg))) - n_layer
            counts = outs[0]["results"][i]["counts"]
            L_ = tcfg.num_layers
            assert counts[("data", "all_gather")][0] == 2 * n_layer * L_ + n_outer
            assert counts[("data", "reduce_scatter")][0] == n_layer * L_ + n_outer


@pytest.mark.parametrize("mesh", OTHER_MESHES)
@pytest.mark.parametrize("case", OTHER_CASES,
                         ids=[f"{c['arch']}-{c['method']}{'' if c['part'] else '-repl'}"
                              for c in OTHER_CASES])
def test_other_configs_grads_match_reference(spawns, other_configs, other_references, mesh,
                                             case):
    """The other dense configs' smoke variants at 1x2, 2x2 and 1x4, both
    schedules, partitioned and replicated: gradients against ``jax.grad`` of
    the JAX loss with its kernels off, at tests/test_accumulation.py's
    tolerance (rtol 3e-4, atol 3e-5); the loss to 1e-5."""
    tcfg = other_configs[case["arch"]][1]
    want_loss, want = other_references[case["arch"]]
    outs = spawns[mesh].result()
    i = CASES[mesh].index(case)
    got = _global(outs, lambda o: o["results"][i]["grads"], MESHES[mesh][1], case["part"],
                  tcfg)
    _compare(got, want, rtol=3e-4, atol=3e-5)
    losses = {o["results"][i]["loss"] for o in outs}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), want_loss, rtol=1e-5)


# ---------------------------------------------------------------------------
# The collective schedule (the port's test_collective_schedule_claim)
# ---------------------------------------------------------------------------
def _case(outs, method, part, rank=0):
    i = GRAD_CASES.index(dict(kind="grads", method=method, part=part))
    return outs[rank]["results"][i]["counts"]


@pytest.mark.parametrize("rank", range(4))
def test_collective_schedule_claim(spawns, rank):
    """At 2x2, exactly: partitioned, 3 * L * M data-group collectives per
    layer leaf in the standard schedule against 3 * L in the layered one
    (the outer leaves: M gathers and M scatters against one each), the
    standard's bytes M times the layered's; replicated, the same bytes in
    more, smaller all-reduces for layered (one per layer leaf against one
    per stacked leaf).  Each schedule also all-reduces the token count and
    the metrics over the data group."""
    outs = spawns["2x2"].result()
    std, lay = _case(outs, "standard", True, rank), _case(outs, "layered", True, rank)
    ag, rs, ar = ("data", "all_gather"), ("data", "reduce_scatter"), ("data", "all_reduce")
    assert lay[ag][0] == 2 * N_LAYER_LEAVES * L + N_OUTER_LEAVES
    assert lay[rs][0] == N_LAYER_LEAVES * L + N_OUTER_LEAVES
    assert std[ag][0] == M * (2 * N_LAYER_LEAVES * L + N_OUTER_LEAVES)
    assert std[rs][0] == M * (N_LAYER_LEAVES * L + N_OUTER_LEAVES)
    per_leaf = lambda c, n_outer: (c[ag][0] + c[rs][0] - 2 * n_outer) / N_LAYER_LEAVES  # noqa: E731
    assert per_leaf(std, M * N_OUTER_LEAVES) == 3 * L * M
    assert per_leaf(lay, N_OUTER_LEAVES) == 3 * L
    assert std[ag][1] == M * lay[ag][1] and std[rs][1] == M * lay[rs][1]
    assert std[ar][0] == lay[ar][0] == 2
    std, lay = _case(outs, "standard", False, rank), _case(outs, "layered", False, rank)
    assert ag not in std and rs not in std and ag not in lay and rs not in lay
    assert std[ar][0] == N_LAYER_LEAVES + N_OUTER_LEAVES + 2
    assert lay[ar][0] == N_LAYER_LEAVES * L + N_OUTER_LEAVES + 2
    assert std[ar][1] == lay[ar][1]


def test_bf16_reduce_halves_the_wire(spawns):
    """``reduce_dtype="bfloat16"`` at 2x2: the reduce-scatters move half the
    bytes of the fp32 ones, and the gradients stay within bf16 rounding of
    the fp32-reduced ones (2**-7 of each leaf's largest |g|: each rank's
    gradient and the sum are rounded once each)."""
    outs = spawns["2x2"].result()
    i = len(GRAD_CASES) + len(TRAIN_CASES) + EXTRA_CASES.index(BF16_REDUCE)
    rs = ("data", "reduce_scatter")
    for o in outs:
        fp32 = _case(outs, "layered", True, o["rank"])
        bf16 = o["results"][i]["counts"]
        assert bf16[rs][0] == fp32[rs][0] and 2 * bf16[rs][1] == fp32[rs][1]
    got = _global(outs, lambda o: o["results"][i]["grads"], 2, True)
    want = _global(outs, lambda o: o["results"][GRAD_CASES.index(
        dict(kind="grads", method="layered", part=True))]["grads"], 2, True)
    for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -7 * np.abs(b).max(),
                                   err_msg=str(path))


def test_storage_layout_two_ways(spawns):
    """At 2x2 each rank's storage made from the numpy tree through
    ``host_partition_leaf`` (the JAX package's layout, bit for bit) equals
    the one ``storage_from_params`` makes from torch tensors on the rank, as
    ``init_storage`` does, in both layouts."""
    outs = spawns["2x2"].result()
    i = len(GRAD_CASES) + len(TRAIN_CASES) + 1
    for o in outs:
        for part, (a, b) in o["results"][i]["storage"].items():
            for (path, x), y in zip(tree.leaves_with_path(a), tree.leaves(b)):
                np.testing.assert_array_equal(x, y, err_msg=f"{part} {path}")


def test_gather_params_gives_each_rank_its_shards(spawns, weights):
    """``gather_params`` at 2x2: every rank gets its model shard of every
    leaf (the full leaf where it is replicated), layer by layer."""
    params, _ = weights
    outs = spawns["2x2"].result()
    i = len(GRAD_CASES) + len(TRAIN_CASES) + 1
    specs = T.param_specs(TCFG, 2)
    for o in outs:
        got = o["results"][i]["params"]
        for path, spec in tree.leaves_with_path(specs):
            full = params
            for k in path:
                full = full[k]
            dim = zp.model_dim(spec)
            if dim is not None:
                full = np.split(full, 2, dim)[o["model_index"]]
            if path[0] == "layers":
                for l in range(L):
                    g = got["layers"][l]
                    for k in path[1:]:
                        g = g[k]
                    np.testing.assert_array_equal(g, full[l], err_msg=str(path))
            else:
                g = got
                for k in path:
                    g = g[k]
                np.testing.assert_array_equal(g, full, err_msg=str(path))


# ---------------------------------------------------------------------------
# Train steps at 2x2 against the JAX package's
# ---------------------------------------------------------------------------
def _jax_run(mesh22, fused: bool, opt: dict):
    jcfg = dataclasses.replace(JCFG, kernels=False)
    build = jstepfn.build_fused_train_step if fused else jstepfn.build_train_step
    step = build(jcfg, mesh22, JAccumConfig("layered", True, M), JAdamConfig(**opt),
                 donate=False)
    storage = jstepfn.init_storage(jcfg, mesh22, jax.random.PRNGKey(0), partitioned=True)
    opt_state = jadam_init(storage)
    recs = []
    for i in range(3):
        storage, opt_state, m = step(storage, opt_state, jmake_batch(JDataConfig(**DATA), i))
        recs.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return recs, jax.tree.map(np.asarray, storage)


def _check_chunks(outs, storage_j, atol: float):
    """Each rank's final chunks against block [..., m, d, :] of the JAX
    storage's."""
    for o in outs:
        d, m = o["data_index"], o["model_index"]
        for path, got in tree.leaves_with_path(o["_storage"]):
            want = storage_j
            for k in path:
                want = want[k]
            mi = m if want.shape[-3] > 1 else 0
            np.testing.assert_allclose(got, want[..., mi:mi + 1, d:d + 1, :], rtol=0,
                                       atol=atol, err_msg=f"rank ({d}, {m}) {path}")


TRAIN_I = len(GRAD_CASES)


def _train_outs(outs, which: int):
    return [dict(o, _storage=o["results"][TRAIN_I + which]["storage"]) for o in outs]


def _records(outs, which: int) -> list[dict]:
    recs = [o["results"][TRAIN_I + which]["records"] for o in outs]
    for r in recs[1:]:                         # every rank reports the same metrics
        assert [x["loss"] for x in r] == [x["loss"] for x in recs[0]]
    return recs[0]


def test_train_trajectory_matches_jax(spawns, mesh22):
    """3 layered steps at 2x2 against JAX ``build_train_step`` on the 2x2
    mesh with its kernels off: loss, grad norm and lr per step to 1e-5
    relative, the final chunks rank by rank to 1e-5 absolute (the tolerances
    of tests/test_torch_train_step.py's one-process trajectory)."""
    want, storage_j = _jax_run(mesh22, fused=False, opt=OPT)
    outs = spawns["2x2"].result()
    got = _records(outs, 0)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"step {i} {k}")
    _check_chunks(_train_outs(outs, 0), storage_j, atol=1e-5)


def test_fused_step_matches_jax(spawns, mesh22):
    """The §C.3 fused step (per-leaf clip by each rank's own chunk of each
    layer, as the JAX package clips) against JAX ``build_fused_train_step``
    at 2x2, its kernels off: losses to 1e-5 relative, final chunks to 1e-5."""
    want, storage_j = _jax_run(mesh22, fused=True, opt=dict(OPT, grad_clip=FUSED_CLIP))
    outs = spawns["2x2"].result()
    got = _records(outs, 1)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=f"step {i}")
        assert g["grad_norm"] == w["grad_norm"] == 0.0
    _check_chunks(_train_outs(outs, 1), storage_j, atol=1e-5)
    # one reduce-scatter, then one update, per layer leaf and layer and outer leaf
    assert all(r["counts"][("data", "reduce_scatter")][0] == N_LAYER_LEAVES * L
               + N_OUTER_LEAVES for r in got)


def test_fused_step_matches_classic(spawns):
    """With grad_clip=0 the fused step's arithmetic is the classic step's:
    the same losses and the same final chunks (1e-6)."""
    outs = spawns["2x2"].result()
    classic, fused = _records(outs, 2), _records(outs, 3)
    np.testing.assert_allclose([r["loss"] for r in fused], [r["loss"] for r in classic],
                               rtol=1e-6)
    for o in outs:
        a, b = o["results"][TRAIN_I + 2]["storage"], o["results"][TRAIN_I + 3]["storage"]
        for (path, x), y in zip(tree.leaves_with_path(a), tree.leaves(b)):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6, err_msg=str(path))


# ---------------------------------------------------------------------------
# A group of one, and the entry point
# ---------------------------------------------------------------------------
def test_group_of_one_equals_no_group(spawns):
    """Every collective on a group of one moves nothing: gradients, metrics
    and a 3-step trajectory equal the no-group path's bit for bit."""
    (out,) = spawns["1x1"].result()
    res = out["results"]
    n = len(GRAD_CASES) + 1
    for grp, loc in zip(res[:n], res[n:]):
        if "grads" in grp:
            for (path, a), b in zip(tree.leaves_with_path(grp["grads"]),
                                    tree.leaves(loc["grads"])):
                np.testing.assert_array_equal(a, b, err_msg=str(path))
            assert grp["loss"] == loc["loss"] and grp["counts"] and not loc["counts"]
        else:
            assert [r["loss"] for r in grp["records"]] == [r["loss"] for r in loc["records"]]
            assert ([r["grad_norm"] for r in grp["records"]]
                    == [r["grad_norm"] for r in loc["records"]])
            for (path, a), b in zip(tree.leaves_with_path(grp["storage"]),
                                    tree.leaves(loc["storage"])):
                np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_train_cli_mesh_2x1_under_the_launcher(spawns, capsys):
    """``launch.train --mesh 2x1 --device cpu`` under torch.distributed.run
    (gloo, two processes, started with the spawns) takes the steps ``--mesh
    1x1`` takes in one process: equal losses (1e-6 relative; fp32 sums in
    another order)."""
    (stdout,) = spawns["cli"].wait()
    lines = stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2      # rank 0 alone prints
    got = json.loads(lines[-1])
    want = train.main(CLI_ARGV + ["--mesh", "1x1"])
    capsys.readouterr()
    assert got["mesh"] == "2x1" and got["steps"] == 2
    np.testing.assert_allclose([got["first_loss"], got["last_loss"]],
                               [want["first_loss"], want["last_loss"]], rtol=1e-6)
