"""The port's checkpoint store and layouts (``checkpointing/store.py``,
``resilience/reshard.py``) against the JAX package's.

The store: round trip, atomic overwrite, per-file checksums, step dirs,
garbage collection, the fallback over a corrupt checkpoint and legible
errors, as ``tests/test_checkpoint.py`` and the store cases of
``tests/test_resilience.py`` hold the JAX store; the same tree written by
both stores gives the same bytes, file by file; each store reads the
other's files, a bf16 leaf included (the JAX store writes one it cannot
read back).

The layouts: ``storage_template`` gives JAX's global shapes and
``from_full_state`` / ``to_full_state`` / ``reshard_state`` JAX's arrays bit
for bit, over JAX's acceptance pairs and a grid.  On gloo
(``tests/torch_ckpt_ranks.py``), at 2x1 and 2x2 (flat, partitioned), 1x2
(flat, replicated) and 2x1x1 (the pipeline): the global bundle rank 0 writes
from every rank's blocks, read back by the JAX store, equals JAX's
``from_full_state`` bit for bit, and every rank restores exactly its blocks.

End to end through both trainers (the JAX one with its kernels off, as the
port's other parity tests run it): a JAX checkpoint seeds the port's
``launch.train``, whose next steps are JAX's, and the other way round.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpointing import store as jstore
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.models.common import ModelConfig as JModelConfig
from repro.obs import metrics as jmetrics
from repro.resilience import faults as jflt
from repro.resilience import reshard as jreshard
from repro_torch import tree
from repro_torch.checkpointing import store
from repro_torch.launch import train
from repro_torch.models.common import ModelConfig
from repro_torch.resilience import faults as flt
from repro_torch.resilience import reshard
from repro_torch.resilience.reshard import Leaf, MeshLayout
from test_torch_dist import ROOT, Spawn

WORKER = ROOT / "tests" / "torch_ckpt_ranks.py"

# the CFG of tests/test_resilience.py: 4 layers, width 32, 4 q / 2 KV heads
RES = dict(name="res", arch_type="dense", num_layers=4, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", param_dtype="float32")
JCFG, TCFG = JModelConfig(**RES), ModelConfig(**RES)


def _jlayout(lay: MeshLayout) -> jreshard.MeshLayout:
    return jreshard.MeshLayout(**lay.to_meta())


@pytest.fixture(scope="module")
def full():
    """JAX's full parameter tree as numpy (``shared`` is empty here)."""
    return jax.tree.map(np.asarray, JT.init_params(JCFG, jax.random.PRNGKey(0)))


def _pairs(t) -> dict:
    """Leaves by key path as numpy, for nested dicts of either package."""
    return {path: leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for path, leaf in tree.leaves_with_path(t)}


def _assert_bit_identical(got, want):
    g, w = _pairs(got), _pairs(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


# ---------------------------------------------------------------------------
# The store, as tests/test_checkpoint.py holds the JAX one
# ---------------------------------------------------------------------------
def _state(gen=None):
    gen = gen or torch.Generator().manual_seed(0)
    return {"embed": torch.randn(8, 4, generator=gen),
            "layers": {"w": torch.randn(3, 4, 4, generator=gen), "b": torch.zeros(3, 4)},
            "final_norm": {"scale": torch.ones(4)}}


def test_roundtrip(tmp_path):
    state = _state()
    store.save_state(str(tmp_path), state, step=7, meta={"note": "t"})
    for f in ("layers__w.L0.npy", "layers__w.L2.npy", "embed.npy"):
        assert os.path.exists(tmp_path / f)
    loaded, step = store.load_state(str(tmp_path), state)
    assert step == 7
    for (path, a), b in zip(tree.leaves_with_path(loaded), tree.leaves(state)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=str(path))


def test_atomic_overwrite(tmp_path):
    store.save_state(str(tmp_path), {"w": torch.zeros(4)}, step=1)
    store.save_state(str(tmp_path), {"w": torch.ones(4)}, step=2)
    loaded, step = store.load_state(str(tmp_path), {"w": torch.zeros(4)})
    assert step == 2
    np.testing.assert_array_equal(loaded["w"], np.ones(4, np.float32))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_manifest_records_per_file_checksums(tmp_path):
    store.save_state(str(tmp_path), {"w": torch.ones(4), "layers": {"k": torch.zeros(2, 3)}},
                     step=1)
    manifest = store.load_manifest(str(tmp_path))
    assert sorted(manifest["files"]) == ["layers__k.L0.npy", "layers__k.L1.npy", "w.npy"]
    # the hash taken while writing is the file's
    for rel, h in manifest["files"].items():
        assert h == store._sha256(str(tmp_path / rel))
    assert store.verify_files(str(tmp_path)) == []


def test_step_scoped_dirs_and_templates(tmp_path):
    d = store.save_checkpoint(str(tmp_path), {"w": torch.arange(4.0)}, step=3)
    assert d.endswith("step_00000003")
    assert store.checkpoint_steps(str(tmp_path)) == [(3, d)]
    loaded, step = store.load_state(d, {"w": Leaf((4,), "float32")})
    assert step == 3
    np.testing.assert_array_equal(loaded["w"], np.arange(4.0, dtype=np.float32))


def test_load_state_errors_are_legible(tmp_path):
    store.save_checkpoint(str(tmp_path), {"embed": np.zeros((4, 3), np.float32)}, step=1,
                          meta={"layout": {"stages": 2, "data": 2, "model": 2}})
    d = store.checkpoint_steps(str(tmp_path))[0][1]
    with pytest.raises(store.CheckpointError) as ei:
        store.load_state(d, {"embed": np.zeros((8, 3), np.float32)})
    msg = str(ei.value)
    assert "'embed'" in msg and "(4, 3)" in msg and "(8, 3)" in msg
    assert "stages" in msg and "reshard" in msg
    with pytest.raises(store.CheckpointError, match="has no leaf 'nope'"):
        store.load_state(d, {"nope": np.zeros((1,), np.float32)})
    with pytest.raises(store.CheckpointError, match="no checkpoint manifest"):
        store.load_manifest(str(tmp_path / "absent"))


def _tiny_state(val=0.0):
    return {"embed": np.full((4, 3), val, np.float32),
            "layers": {"w": np.full((2, 3, 3), val, np.float32)}}


def test_checksums_detect_corruption(tmp_path):
    d = store.save_checkpoint(str(tmp_path), _tiny_state(1.0), step=2)
    assert store.verify_files(d) == []
    flt.corrupt_checkpoint_file(d, file_index=0, byte_offset=100)
    assert store.verify_files(d) != []


def test_load_latest_falls_back_over_corruption(tmp_path):
    for s, v in ((2, 2.0), (4, 4.0)):
        store.save_checkpoint(str(tmp_path), _tiny_state(v), step=s)
    newest = store.checkpoint_steps(str(tmp_path))[-1][1]
    flt.corrupt_checkpoint_file(newest, file_index=1, byte_offset=90)
    state, step, _ = store.load_latest(str(tmp_path), _tiny_state())
    assert step == 2
    np.testing.assert_array_equal(state["embed"], np.full((4, 3), 2.0, np.float32))
    with pytest.raises(store.CheckpointError, match="no valid checkpoint"):
        store.load_latest(str(tmp_path), _tiny_state(), max_rollback=0)


def test_load_latest_flat_layout(tmp_path):
    store.save_state(str(tmp_path), _tiny_state(3.0), step=9)
    state, step, d = store.load_latest(str(tmp_path), _tiny_state())
    assert step == 9 and d == str(tmp_path)
    np.testing.assert_array_equal(state["embed"], np.full((4, 3), 3.0, np.float32))


def test_gc_keeps_last_n_valid(tmp_path):
    for s in (2, 4, 6, 8, 10):
        store.save_checkpoint(str(tmp_path), _tiny_state(float(s)), step=s)
    store.gc_checkpoints(str(tmp_path), keep=2)
    assert [s for s, _ in store.checkpoint_steps(str(tmp_path))] == [8, 10]
    newest = store.checkpoint_steps(str(tmp_path))[-1][1]
    flt.corrupt_checkpoint_file(newest, byte_offset=80)
    store.save_checkpoint(str(tmp_path), _tiny_state(12.0), step=12)
    store.gc_checkpoints(str(tmp_path), keep=2)
    assert [s for s, _ in store.checkpoint_steps(str(tmp_path))] == [8, 10, 12]


# ---------------------------------------------------------------------------
# The same bytes as the JAX store, and each reads the other's files
# ---------------------------------------------------------------------------
def _mixed(rng):
    """A bundle-like tree (fp32 leaves, stacked layers under ``params``, a
    bf16 moment, the 0-d int32 step) beside a top-level ``layers`` subtree,
    which alone is split into one file per layer."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bits = rng.integers(-2 ** 15, 2 ** 15, size=(3, 5), dtype=np.int16)
    return {"params": {"embed": f32(6, 4), "layers": {"w": f32(2, 3, 4)}},
            "layers": {"v": f32(3, 2)},
            "mu": {"embed": bits},
            "opt_step": np.int32(11)}


def _jax_tree(t):
    return {"params": jax.tree.map(jnp.asarray, t["params"]),
            "layers": jax.tree.map(jnp.asarray, t["layers"]),
            "mu": {"embed": jax.lax.bitcast_convert_type(jnp.asarray(t["mu"]["embed"]),
                                                         jnp.bfloat16)},
            "opt_step": jnp.asarray(t["opt_step"])}


def _torch_tree(t):
    return {"params": tree.tree_map(torch.from_numpy, t["params"]),
            "layers": tree.tree_map(torch.from_numpy, t["layers"]),
            "mu": {"embed": torch.from_numpy(t["mu"]["embed"]).view(torch.bfloat16)},
            "opt_step": torch.tensor(t["opt_step"])}


def test_same_bytes_as_the_jax_store(tmp_path):
    """Every file of the two checkpoints, manifest included, is equal."""
    t = _mixed(np.random.default_rng(0))
    jstore.save_state(str(tmp_path / "jax"), _jax_tree(t), step=5, meta={"arch": "t"})
    store.save_state(str(tmp_path / "port"), _torch_tree(t), step=5, meta={"arch": "t"})
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert "mu__embed.npy" in files and "params__layers__w.npy" in files
    assert "layers__v.L2.npy" in files
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def test_reads_a_bf16_leaf_the_jax_store_wrote(tmp_path):
    """The JAX store writes a bf16 leaf as '<V2' and its own ``load_state``
    cannot cast it back (``src/repro/checkpointing/store.py:211``); the
    port's reads the exact bits whenever the template says bf16."""
    t = _mixed(np.random.default_rng(1))
    jstore.save_state(str(tmp_path), _jax_tree(t), step=5)
    like = _torch_tree(t)
    got, step = store.load_state(str(tmp_path), like)
    assert step == 5 and got["mu"]["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["mu"]["embed"].view(torch.int16).numpy(),
                                  t["mu"]["embed"])
    assert got["opt_step"].shape == () and int(got["opt_step"]) == 11
    with pytest.raises(store.CheckpointError, match="bf16 bits"):
        store.load_state(str(tmp_path), {"mu": {"embed": Leaf((3, 5), "float32")}})


def test_jax_store_reads_the_port_checkpoint(tmp_path):
    t = _mixed(np.random.default_rng(2))
    store.save_state(str(tmp_path), _torch_tree(t), step=5)
    like = {"params": jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                   t["params"]),
            "layers": {"v": jax.ShapeDtypeStruct((3, 2), jnp.float32)},
            "opt_step": jax.ShapeDtypeStruct((), jnp.int32)}
    got, step = jstore.load_state(str(tmp_path), like)
    assert step == 5
    _assert_bit_identical(got, {"params": t["params"], "layers": t["layers"],
                                "opt_step": np.int32(11)})


# ---------------------------------------------------------------------------
# Layouts: JAX's shapes and JAX's arrays, bit for bit
# ---------------------------------------------------------------------------
ACCEPTANCE_PAIRS = [     # tests/test_resilience.py's
    (MeshLayout(2, 2, 2, n_microbatches=2), MeshLayout(2, 1, 2, n_microbatches=2)),
    (MeshLayout(2, 2, 2, n_microbatches=2), MeshLayout(1, 4, 1)),
    (MeshLayout(1, 2, 1), MeshLayout(4, 1, 1, n_microbatches=4)),
    (MeshLayout(2, 1, 2, partitioned=False, n_microbatches=2), MeshLayout(1, 3, 1)),
    (MeshLayout(4, 2, 1, n_microbatches=4, schedule="interleaved"),
     MeshLayout(2, 2, 1, n_microbatches=2, schedule="1f1b")),
    (MeshLayout(1, 1, 1, partitioned=False), MeshLayout(1, 5, 2)),
]
LAYOUTS = sorted({lay for pair in ACCEPTANCE_PAIRS for lay in pair}, key=str)
LAYOUT_IDS = [f"S{l.stages}d{l.data}m{l.model}{'p' if l.partitioned else 'r'}-{l.schedule}"
              for l in LAYOUTS]


@pytest.mark.parametrize("lay", LAYOUTS, ids=LAYOUT_IDS)
def test_templates_and_layouts_match_jax(full, lay):
    """``storage_template`` / ``bundle_template`` give JAX's global shapes
    and dtypes, and ``from_full_state`` JAX's arrays bit for bit; its
    inverse gives the full tree back."""
    jl = _jlayout(lay)
    want = jreshard.bundle_template(JCFG, jl)
    got = reshard.bundle_template(TCFG, lay)
    wants = {tuple(k.key for k in p): (tuple(l.shape), str(l.dtype))
             for p, l in jax.tree_util.tree_leaves_with_path(want)}
    assert {p: (tuple(l.shape), store.dtype_name(l.dtype))
            for p, l in tree.leaves_with_path(got)} == wants
    on = reshard.from_full_state(full, TCFG, lay)
    _assert_bit_identical(on, jreshard.from_full_state(full, JCFG, jl))
    back = reshard.to_full_state(on, TCFG, lay)
    _assert_bit_identical(back, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                             {k: v for k, v in full.items() if k != "shared"}))


@pytest.mark.parametrize("src,dst", ACCEPTANCE_PAIRS,
                         ids=[f"{a}-{b}" for a, b in (("222", "212"), ("222", "141"),
                                                      ("121", "411"), ("212r", "131"),
                                                      ("421i", "2211f1b"), ("111r", "152"))])
def test_reshard_matches_direct_save(full, src, dst):
    """tests/test_resilience.py's acceptance pairs: save on A, reshard to B
    == save directly on B, and equal to JAX's reshard."""
    moved = reshard.reshard_state(reshard.from_full_state(full, TCFG, src), TCFG, src, dst)
    _assert_bit_identical(moved, reshard.from_full_state(full, TCFG, dst))
    _assert_bit_identical(moved, jreshard.reshard_state(
        jreshard.from_full_state(full, JCFG, _jlayout(src)), JCFG, _jlayout(src),
        _jlayout(dst)))


def test_reshard_grid(full):
    """A sweep of (S, n_data, n_model, partitioned) from one source."""
    layouts = [MeshLayout(s, d, m, partitioned=p, n_microbatches=s * 2)
               for s in (1, 2, 4) for d in (1, 2, 3) for m in (1, 2) for p in (True, False)]
    ref = {lay: reshard.from_full_state(full, TCFG, lay) for lay in layouts}
    src = layouts[5]
    for dst in layouts:
        _assert_bit_identical(reshard.reshard_state(ref[src], TCFG, src, dst), ref[dst])


def test_reshard_bundle_preserves_moment_dtype(full):
    """bf16 moments (CPU torch tensors on the host) widen exactly and come
    back bf16; the step passes through."""
    src, dst = MeshLayout(1, 2, 1), MeshLayout(1, 3, 1)
    params = reshard.from_full_state(full, TCFG, src)
    mom = tree.tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), params)
    out = reshard.reshard_bundle({"params": params, "mu": mom, "nu": mom,
                                  "opt_step": np.int32(7)}, TCFG, src, dst)
    assert all(leaf.dtype == torch.bfloat16 for leaf in tree.leaves(out["mu"]))
    assert all(leaf.dtype == np.float32 for leaf in tree.leaves(out["params"]))
    assert int(out["opt_step"]) == 7 and reshard.moment_dtype_of(out) == "bfloat16"
    want = reshard.from_full_state(
        reshard.to_full_state(mom, TCFG, src), TCFG, dst)
    for a, b in zip(tree.leaves(out["mu"]), tree.leaves(want)):
        np.testing.assert_array_equal(a.float().numpy(), b)


def test_meshlayout_meta_roundtrip_and_errors():
    lay = MeshLayout(2, 3, 1, partitioned=False, schedule="1f1b", n_microbatches=4)
    assert MeshLayout.from_meta(lay.to_meta()) == lay
    assert lay.to_meta() == _jlayout(lay).to_meta()
    with pytest.raises(reshard.ReshardError, match="missing key"):
        MeshLayout.from_meta({"stages": 2})
    with pytest.raises(reshard.ReshardError, match="must be >= 1"):
        MeshLayout(0, 1, 1)
    with pytest.raises(reshard.ReshardError, match="does not divide"):
        MeshLayout(3, 1, 1, n_microbatches=3).pipe_spec(TCFG)


# ---------------------------------------------------------------------------
# Ranks <-> the global bundle, on gloo
# ---------------------------------------------------------------------------
RANK_LAYOUTS = {"2x1": MeshLayout(1, 2, 1, n_microbatches=2),
                "2x2": MeshLayout(1, 2, 2, n_microbatches=2),
                "1x2r": MeshLayout(1, 1, 2, partitioned=False, n_microbatches=2),
                "2x1x1": MeshLayout(2, 1, 1, n_microbatches=2)}
GATE_DATA = dict(vocab_size=64, seq_len=16, global_batch=8, n_microbatches=2)


@pytest.fixture(scope="module")
def rank_spawns(tmp_path_factory, full):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    batch = {"tokens": np.zeros((2, 2, 16), np.int32)}
    out = {}
    for name, lay in RANK_LAYOUTS.items():
        cases = [dict(kind="bundle", layout=lay.to_meta(), root=str(tmp / f"{name}.ck"))]
        if lay.stages > 1:
            cases.append(dict(kind="gate", layout=lay.to_meta(), data=GATE_DATA))
        mesh = ((lay.stages, lay.data, lay.model) if lay.stages > 1
                else (lay.data, lay.model))
        out[name] = (Spawn(tmp, name, mesh, cases, full, batch, worker=WORKER, cfg=RES),
                     cases[0]["root"])
    yield out
    for s, _ in out.values():
        s.kill()


@pytest.mark.parametrize("name", list(RANK_LAYOUTS))
def test_global_bundle_from_ranks_matches_jax(rank_spawns, full, name):
    """The bundle rank 0 wrote from every rank's blocks, read by the JAX
    store with JAX's template, is JAX's ``from_full_state`` bit for bit
    (moments 2p + 1 and p*p of it); every rank restored its blocks exactly."""
    spawn, root = rank_spawns[name]
    outs = spawn.result()
    assert all(o["results"][0]["equal"] and o["results"][0]["step"] == 3 for o in outs)
    lay = _jlayout(RANK_LAYOUTS[name])
    (step, d), = jstore.checkpoint_steps(root)
    got, s = jstore.load_state(d, jreshard.bundle_template(JCFG, lay))
    assert s == step == 3 and int(got["opt_step"]) == 7
    want = jreshard.from_full_state(full, JCFG, lay)
    _assert_bit_identical(got["params"], want)
    p = jax.tree.map(np.asarray, want)
    _assert_bit_identical(got["mu"], jax.tree.map(lambda x: 2 * x + np.float32(1), p))
    _assert_bit_identical(got["nu"], jax.tree.map(lambda x: x * x, p))
    assert json.load(open(os.path.join(d, "manifest.json")))["meta"]["layout"] == lay.to_meta()


def test_refused_pipeline_update_writes_nothing(rank_spawns):
    """A pipelined step whose gate refuses the update (2x1x1) leaves every
    tensor of the state, the step count included, bit for bit as it was."""
    outs = rank_spawns["2x1x1"][0].result()
    for o in outs:
        r = o["results"][1]
        assert r["skipped"] and r["same_opt"] and r["unchanged"], (o["rank"], r)


# ---------------------------------------------------------------------------
# End to end: a JAX run seeds the port's, and the other way round
# ---------------------------------------------------------------------------
COMMON = ["--arch", "yi-6b", "--smoke", "--global-batch", "4", "--seq-len", "32",
          "--microbatches", "2", "--log-every", "100"]


@pytest.fixture
def jax_no_kernels(monkeypatch):
    """The JAX trainer with its kernels off: with them on, its shard_map
    step does not trace on this JAX (ROADMAP, North star)."""
    orig = jconfigs.get_config
    monkeypatch.setattr(jtrain.configs, "get_config",
                        lambda *a, **k: dataclasses.replace(orig(*a, **k), kernels=False))


def _steps(path) -> dict:
    return {r["step"]: r for r in jmetrics.read_jsonl(str(path)) if r["event"] == "step"}


def _seed_dir(src_root, dst, step: int):
    d = os.path.join(src_root, store.step_dir_name(step))
    shutil.copytree(d, os.path.join(dst, store.step_dir_name(step)))
    return str(dst)


def _close(got: dict, want: dict, steps):
    """tests/test_torch_train_step.py's trajectory tolerance (1e-5)."""
    for i in steps:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[i][k], want[i][k], rtol=1e-5, err_msg=f"{i} {k}")


def test_jax_checkpoint_seeds_the_port(tmp_path, jax_no_kernels, capsys):
    """JAX trains 4 steps, saving at 2 and 4.  From its step-2 checkpoint the
    port's ``--resume auto --steps 4`` takes steps 2 and 3 as JAX did; and
    the port's ``--resume latest --steps 2`` takes the steps JAX's own
    ``--resume latest --steps 2`` takes from the same checkpoint (there
    ``--steps`` also sets the lr schedule's length, so neither is the
    4-step run's)."""
    jtrain.main(COMMON + ["--steps", "4", "--checkpoint-dir", str(tmp_path / "j"),
                          "--checkpoint-every", "2", "--metrics", str(tmp_path / "j.jsonl")])
    jax_run = _steps(tmp_path / "j.jsonl")
    seed = lambda name: _seed_dir(tmp_path / "j", tmp_path / name, 2)  # noqa: E731
    cpu = ["--device", "cpu"]
    r = train.main(COMMON + cpu + ["--steps", "4", "--checkpoint-dir", seed("auto"),
                                   "--resume", "auto"])
    assert [h["step"] for h in r["history"]] == [2, 3] and r["restarts"] == 0
    _close({h["step"]: h for h in r["history"]}, jax_run, (2, 3))
    train.main(COMMON + cpu + ["--steps", "2", "--checkpoint-dir", seed("latest"),
                               "--resume", "latest", "--metrics", str(tmp_path / "p.jsonl")])
    jtrain.main(COMMON + ["--steps", "2", "--checkpoint-dir", seed("jlatest"), "--resume",
                          "latest", "--metrics", str(tmp_path / "jl.jsonl")])
    got, want = _steps(tmp_path / "p.jsonl"), _steps(tmp_path / "jl.jsonl")
    assert sorted(got) == sorted(want) == [2, 3]
    _close(got, want, (2, 3))
    assert "resumed from step 2" in capsys.readouterr().out


def test_port_checkpoint_seeds_jax(tmp_path, jax_no_kernels):
    """The port trains 4 steps, saving at 2 and 4; JAX's supervised
    ``--resume auto --steps 4`` from the port's step-2 checkpoint takes
    steps 2 and 3 as the port did; and the two runs' step-4 checkpoints
    hold the same arrays to the trajectory tolerance."""
    train.main(COMMON + ["--device", "cpu", "--steps", "4", "--checkpoint-dir",
                         str(tmp_path / "p"), "--checkpoint-every", "2", "--metrics",
                         str(tmp_path / "p.jsonl")])
    port = _steps(tmp_path / "p.jsonl")
    seeded = _seed_dir(tmp_path / "p", tmp_path / "j", 2)
    r = jtrain.main(COMMON + ["--steps", "4", "--checkpoint-dir", seeded, "--resume", "auto",
                              "--checkpoint-every", "2"])
    assert [h["step"] for h in r["history"]] == [2, 3]
    _close({h["step"]: h for h in r["history"]}, port, (2, 3))
    cfg = dataclasses.replace(jconfigs.get_config("yi-6b", smoke=True), kernels=False)
    like = jreshard.bundle_template(cfg, jreshard.MeshLayout(n_microbatches=2))
    a, _ = jstore.load_state(os.path.join(tmp_path / "p", "step_00000004"), like)
    b, _ = jstore.load_state(os.path.join(seeded, "step_00000004"), like)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-5)


def test_fault_plan_json_is_the_jax_one(tmp_path):
    """Plans written by either package load in the other, field for field."""
    doc = {"faults": [{"kind": "crash", "step": 5}, {"kind": "nan_grad", "step": 3},
                      {"kind": "grad_spike", "step": 4, "scale": 1e4},
                      {"kind": "corrupt_checkpoint", "step": 6, "file_index": 0,
                       "byte_offset": 7}, {"kind": "lose_replica", "step": 8}]}
    plan = flt.FaultPlan.from_json(doc)
    assert plan.to_json() == jflt.FaultPlan.from_json(doc).to_json() == doc
    plan.save(str(tmp_path / "p.json"))
    assert jflt.FaultPlan.load(str(tmp_path / "p.json")).to_json() == doc
    with pytest.raises(flt.FaultPlanError, match="unknown fault kind"):
        flt.Fault("meteor", 1)
    with pytest.raises(flt.FaultPlanError, match="unknown keys"):
        flt.FaultPlan.from_json({"faults": [{"kind": "crash", "step": 1, "sev": 9}]})
    with pytest.raises(flt.FaultPlanError, match="'faults' list"):
        flt.FaultPlan.from_json([1, 2])
    (f,) = tuple(flt.FaultPlan([flt.Fault("crash", 2)]).pending_at(2))
    assert f.to_json() == {"kind": "crash", "step": 2}


MOE = ["--arch", "dbrx-132b", "--smoke", "--global-batch", "4", "--seq-len", "32",
       "--microbatches", "2", "--log-every", "100"]


def _entries(d) -> list:
    """A checkpoint's leaves: (name, layers, shape, dtype), file hashes aside."""
    return [(e["name"], e["layers"], e["shape"], e["dtype"])
            for e in store.load_manifest(d)["entries"]]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_moe_checkpoints_interchange(tmp_path, jax_no_kernels, first):
    """dbrx-132b smoke (4 experts, top 2): one package trains 4 steps,
    saving at 2 and 4; the other, ``--resume auto --steps 4`` from its step-2
    checkpoint, takes steps 2 and 3 as the first did (the trajectory
    tolerance, 1e-5).  Both step-4 checkpoints hold the same leaves (names,
    shapes, dtypes; the router fp32 ``[L, D, E]`` and the expert stacks
    ``[L, E, D, F]`` as ZeRO chunks), their arrays to 1e-4: where an
    expert's gradient is near zero, Adam's per-element normalisation turns
    its fp32 rounding into a few percent of one step (lr 3e-3), as in
    ``tests/test_torch_moe.py``."""
    runs = {"jax": lambda argv: jtrain.main(MOE + argv),
            "port": lambda argv: train.main(MOE + ["--device", "cpu"] + argv)}
    second = "port" if first == "jax" else "jax"
    runs[first](["--steps", "4", "--checkpoint-dir", str(tmp_path / "a"), "--checkpoint-every",
                 "2", "--metrics", str(tmp_path / "a.jsonl")])
    ref = _steps(tmp_path / "a.jsonl")
    seeded = _seed_dir(tmp_path / "a", tmp_path / "b", 2)
    r = runs[second](["--steps", "4", "--checkpoint-dir", seeded, "--resume", "auto",
                      "--checkpoint-every", "2"])
    assert [h["step"] for h in r["history"]] == [2, 3] and r["restarts"] == 0
    _close({h["step"]: h for h in r["history"]}, ref, (2, 3))
    a, b = (os.path.join(d, "step_00000004") for d in (tmp_path / "a", seeded))
    assert _entries(a) == _entries(b)
    cfg = dataclasses.replace(jconfigs.get_config("dbrx-132b", smoke=True), kernels=False)
    names = {e[0]: e for e in _entries(a)}
    L, D, E = cfg.num_layers, cfg.d_model, cfg.num_experts
    assert names["params__layers__moe__router"][2:] == ([L, 1, 1, D * E], "float32")
    assert names["params__layers__moe__w_up"][2:] == ([L, 1, 1, E * D * cfg.d_ff], "float32")
    like = jreshard.bundle_template(cfg, jreshard.MeshLayout(n_microbatches=2))
    x, _ = jstore.load_state(a, like)
    y, _ = jstore.load_state(b, like)
    assert x["params"]["layers"]["moe"]["router"].dtype == np.float32
    for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=0, atol=1e-4)


# (loss, grad norm) relative tolerances after the first resumed step:
# tests/test_torch_ssm.py's TRAIN_TOL (rwkv's group norm at init amplifies
# rounding; Adam's first normalised update does the rest)
RECURRENT_TOL = {"rwkv6-3b": (1e-3, 5e-2), "zamba2-7b": (1e-4, 1e-4)}


@pytest.mark.parametrize("arch,first", [("rwkv6-3b", "jax"), ("zamba2-7b", "port")])
def test_recurrent_checkpoints_interchange(tmp_path, jax_no_kernels, arch, first):
    """A JAX checkpoint of the rwkv6-3b smoke config seeds the port's
    trainer, and a port checkpoint of zamba2-7b's (its ``shared`` block an
    outer leaf) seeds JAX's: the second package, ``--resume auto --steps 4``
    from the first's step-2 checkpoint, takes step 2 with the loss the first
    took (1e-6) and step 3 within ``RECURRENT_TOL``; both step-4
    checkpoints hold the same leaves (names, shapes, dtypes)."""
    argv = ["--arch", arch, "--smoke", "--global-batch", "4", "--seq-len", "16",
            "--microbatches", "2", "--log-every", "100"]
    runs = {"jax": lambda a: jtrain.main(argv + a),
            "port": lambda a: train.main(argv + ["--device", "cpu"] + a)}
    second = "port" if first == "jax" else "jax"
    runs[first](["--steps", "4", "--checkpoint-dir", str(tmp_path / "a"), "--checkpoint-every",
                 "2", "--metrics", str(tmp_path / "a.jsonl")])
    ref = _steps(tmp_path / "a.jsonl")
    seeded = _seed_dir(tmp_path / "a", tmp_path / "b", 2)
    r = runs[second](["--steps", "4", "--checkpoint-dir", seeded, "--resume", "auto",
                      "--checkpoint-every", "2"])
    got = {h["step"]: h for h in r["history"]}
    assert sorted(got) == [2, 3] and r["restarts"] == 0
    loss_tol, norm_tol = RECURRENT_TOL[arch]
    np.testing.assert_allclose(got[2]["loss"], ref[2]["loss"], rtol=1e-6)
    np.testing.assert_allclose(got[2]["grad_norm"], ref[2]["grad_norm"], rtol=norm_tol)
    np.testing.assert_allclose(got[3]["loss"], ref[3]["loss"], rtol=loss_tol)
    a, b = (os.path.join(d, "step_00000004") for d in (tmp_path / "a", seeded))
    assert _entries(a) == _entries(b)
    names = [e[0] for e in _entries(a)]
    assert ("params__shared__attn__wq" in names) == (arch == "zamba2-7b")
    assert ("params__layers__rwkv__u_bonus" in names) == (arch == "rwkv6-3b")
