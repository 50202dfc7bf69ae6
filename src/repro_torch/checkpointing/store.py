"""Layer-wise streaming checkpoints (paper §8.2), in the JAX package's format
(counterpart of ``repro/checkpointing/store.py``; it reads and writes the
same files).

A checkpoint is a directory: one ``.npy`` file per leaf, named by the leaf's
dict keys joined with ``__`` (``params__layers__attn__wq.npy``), and one per
layer (``name.L{l}.npy``) for leaves under a top-level ``layers`` key; a
``manifest.json`` with the step, an entry per leaf (name, layer count,
shape, dtype), the caller's meta and a sha256 per file, written last.  Files
go to a temporary name and are renamed into place, so a crash mid-save
leaves the previous file whole; checkpoints live in step-scoped directories
(``step_00000123/``), ``save_checkpoint`` keeps the newest N valid ones, and
``load_latest`` walks them newest first, skipping any whose checksums fail.

Leaves are numpy arrays or torch tensors (on any device: each is copied to
the host as it is written, one leaf or one layer at a time).  A bf16 leaf is
written through an int16 view with the ``'<V2'`` header the JAX package's
``np.save`` of a bfloat16 array writes, so the bytes are the same; it is
read back by viewing those bytes as bf16 whenever the template says bf16,
and comes back as a CPU ``torch.bfloat16`` tensor (numpy has no bf16).
Every other leaf comes back as a numpy array of the template's dtype.  The
sha256 of a file is taken from the bytes as they are written, not by
reading the file again, and ``WRITERS`` files are written, or verified, at
a time (the manifest keeps the tree's order).

Every failure raises ``CheckpointError`` naming the leaf, the saved and the
expected shape and the manifest's recorded layout.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import tempfile
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Iterable, Iterator

import numpy as np
import torch
from numpy.lib import format as npy_format

from repro_torch import tree as ptree

PyTree = Any

MANIFEST = "manifest.json"
STEP_DIR_RE = re.compile(r"^step_(\d{8})$")
BF16_DESCR = "<V2"          # what numpy writes for a bfloat16 array
# files written (and checksums verified) at once: sha256 and the writes
# release the GIL, so a save or a verify runs on this many cores
WRITERS = 4


class CheckpointError(RuntimeError):
    """A checkpoint could not be saved, verified, or restored."""


def step_dir_name(step: int) -> str:
    return f"step_{step:08d}"


def _leaf_name(path: tuple) -> str:
    return "__".join(str(k) for k in path)


def _sha256(fname: str) -> str:
    h = hashlib.sha256()
    with open(fname, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def dtype_name(dtype) -> str:
    """The manifest's name of a numpy dtype, a torch dtype or a dtype name
    (``"float32"``, ``"bfloat16"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype


def is_bf16(dtype) -> bool:
    return dtype_name(dtype) == "bfloat16"


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a template leaf's dtype (not for bf16)."""
    return np.dtype(dtype_name(dtype))


def to_numpy(leaf) -> np.ndarray:
    """A leaf on the host as a C-contiguous numpy array; a bf16 tensor as its
    int16 bits (the caller writes those under the bf16 header)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return np.require(t.cpu().numpy(), requirements="C")
    return np.require(np.asarray(leaf), requirements="C")


def _atomic_save(fname: str, leaf) -> tuple[str, list, str]:
    """Write one leaf as ``.npy`` (the header ``np.save`` writes, then the
    array's bytes) through a temporary file and an atomic rename, hashing
    the bytes as they go out.  Returns (sha256 of the file, shape, dtype
    name)."""
    bf16 = is_bf16(leaf.dtype)
    arr = to_numpy(leaf)
    header = npy_format.header_data_from_array_1_0(arr)
    if bf16:
        header["descr"] = BF16_DESCR
    head = io.BytesIO()
    npy_format.write_array_header_1_0(head, header)
    body = memoryview(arr.reshape(-1).view(np.uint8))
    h = hashlib.sha256(head.getvalue())
    h.update(body)
    d = os.path.dirname(fname)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(head.getvalue())
            f.write(body)
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return h.hexdigest(), list(arr.shape), "bfloat16" if bf16 else str(arr.dtype)


def save_leaf(root: str, name: str, arr, *, layer: int | None = None) -> str:
    """Stream one leaf (optionally one layer's slice of a stacked leaf)."""
    sub = f"{name}.L{layer}.npy" if layer is not None else f"{name}.npy"
    fname = os.path.join(root, sub)
    _atomic_save(fname, arr)
    return fname


def save_state(root: str, state, *, step: int, layerwise_key: str = "layers",
               meta: dict | None = None) -> None:
    """Write a full checkpoint in the streaming layout.

    ``state`` is a tree of leaves, or an iterable of ``(key path, leaf)``
    pairs in the tree's sorted order (``tree.leaves_with_path``), consumed
    one leaf at a time: the unit a rank-0 writer receives from the ranks'
    blocks (``resilience.reshard.global_leaves``).  Leaves under
    ``layerwise_key`` are split along their leading (layer) dim into one
    file each.  The manifest, written last and atomically, records a sha256
    per file."""
    os.makedirs(root, exist_ok=True)
    entries = []           # (entry, [(file, future)]) in the tree's order
    pairs: Iterable = ptree.leaves_with_path(state) if isinstance(state, dict) else state
    with ThreadPoolExecutor(WRITERS) as pool:
        pending: list = []

        def submit(sub: str, leaf):
            while sum(not f.done() for f in pending) >= 2 * WRITERS:
                wait(pending, return_when=FIRST_COMPLETED)
            fut = pool.submit(_atomic_save, os.path.join(root, sub), leaf)
            pending.append(fut)
            return sub, fut

        for path, leaf in pairs:
            name = _leaf_name(path)
            if path[0] == layerwise_key and len(leaf.shape) >= 1:
                subs = [submit(f"{name}.L{l}.npy", leaf[l]) for l in range(leaf.shape[0])]
                entries.append(({"name": name, "layers": int(leaf.shape[0]),
                                 "shape": list(leaf.shape), "dtype": None}, subs))
            else:
                entries.append(({"name": name, "layers": 0, "shape": None, "dtype": None},
                                [submit(f"{name}.npy", leaf)]))
    files: dict[str, str] = {}
    for e, subs in entries:
        for sub, fut in subs:
            files[sub], shape, e["dtype"] = fut.result()
            if not e["layers"]:
                e["shape"] = shape
    manifest = {"step": step, "entries": [e for e, _ in entries], "meta": meta or {},
                "files": files}
    with open(os.path.join(root, MANIFEST + ".tmp"), "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(os.path.join(root, MANIFEST + ".tmp"), os.path.join(root, MANIFEST))


def load_manifest(root: str) -> dict:
    fname = os.path.join(root, MANIFEST)
    if not os.path.exists(fname):
        raise CheckpointError(f"no checkpoint manifest at {fname}")
    try:
        with open(fname) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointError(f"torn/corrupt manifest at {fname}: {e}") from e


def verify_files(root: str, manifest: dict | None = None) -> list[str]:
    """Relative names of files that are missing or fail their manifest
    checksum.  Empty list == checkpoint is intact.  Pre-checksum manifests
    (no ``files`` map) have nothing to verify and return []."""
    manifest = manifest if manifest is not None else load_manifest(root)
    files = manifest.get("files", {})

    def ok(rel: str) -> bool:
        fname = os.path.join(root, rel)
        return os.path.exists(fname) and _sha256(fname) == files[rel]

    with ThreadPoolExecutor(WRITERS) as pool:
        return sorted(rel for rel, good in zip(files, pool.map(ok, files)) if not good)


def _layout_note(manifest: dict) -> str:
    meta = manifest.get("meta", {})
    layout = meta.get("layout")
    return (f"; manifest records step {manifest.get('step')}, "
            f"mesh/layout {layout}" if layout is not None
            else f"; manifest records step {manifest.get('step')}")


def _path_str(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def check_like(root: str, manifest: dict, like: PyTree) -> None:
    """Raise the ``CheckpointError`` that ``load_state`` would for a leaf of
    ``like`` the manifest lacks or records at another shape, without
    reading a leaf file."""
    by_name = {e["name"]: e for e in manifest["entries"]}
    for path, leaf in ptree.leaves_with_path(like):
        e = _entry(root, manifest, by_name, path)
        _check_shape(manifest, path, tuple(e["shape"]), tuple(leaf.shape))


def _entry(root: str, manifest: dict, by_name: dict, path: tuple) -> dict:
    name = _leaf_name(path)
    if name not in by_name:
        known = ", ".join(sorted(by_name)) or "<none>"
        raise CheckpointError(
            f"checkpoint at {root} has no leaf {name!r} (tree path "
            f"{_path_str(path)}); saved leaves: {known}{_layout_note(manifest)}")
    return by_name[name]


def _check_shape(manifest: dict, path: tuple, saved: tuple, want: tuple) -> None:
    if saved != want:
        raise CheckpointError(
            f"checkpoint leaf {_leaf_name(path)!r} (tree path {_path_str(path)}): saved "
            f"shape {saved} does not match expected {want}{_layout_note(manifest)}; to "
            f"restore onto a different mesh, reshard via repro_torch.resilience.reshard")


def iter_state(root: str, like: PyTree, manifest: dict | None = None
               ) -> Iterator[tuple[tuple, Any]]:
    """``(key path, leaf)`` of ``like``'s leaves read from the checkpoint at
    ``root``, one at a time, in the tree's sorted order: what
    ``load_state`` assembles, for callers that copy each leaf away (into
    device tensors) before reading the next."""
    manifest = manifest if manifest is not None else load_manifest(root)
    by_name = {e["name"]: e for e in manifest["entries"]}

    def read(fname: str) -> np.ndarray:
        try:
            return np.load(fname)
        except (OSError, ValueError) as e:
            raise CheckpointError(f"unreadable checkpoint file {fname}: {e}"
                                  f"{_layout_note(manifest)}") from e

    def load(path: tuple, leaf):
        name = _leaf_name(path)
        e = _entry(root, manifest, by_name, path)
        if e["layers"]:
            arr = np.stack([read(os.path.join(root, f"{name}.L{l}.npy"))
                            for l in range(e["layers"])])
        else:
            arr = read(os.path.join(root, f"{name}.npy"))
        _check_shape(manifest, path, tuple(arr.shape), tuple(leaf.shape))
        return _as_template_dtype(manifest, path, arr, leaf.dtype)

    # the next WRITERS leaves are read while the caller takes this one
    with ThreadPoolExecutor(WRITERS) as pool:
        ahead: deque = deque()
        for path, leaf in ptree.leaves_with_path(like):
            ahead.append((path, pool.submit(load, path, leaf)))
            if len(ahead) > WRITERS:
                p, fut = ahead.popleft()
                yield p, fut.result()
        while ahead:
            p, fut = ahead.popleft()
            yield p, fut.result()


def _as_template_dtype(manifest: dict, path: tuple, arr: np.ndarray, dtype):
    void = arr.dtype.kind == "V"
    if is_bf16(dtype):
        if void and arr.dtype.itemsize == 2:
            return torch.from_numpy(np.require(arr, requirements="C").view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)
    if void:
        raise CheckpointError(
            f"checkpoint leaf {_leaf_name(path)!r} holds {arr.dtype.itemsize}-byte raw "
            f"values (bf16 bits), but the template asks {dtype_name(dtype)}"
            f"{_layout_note(manifest)}")
    return np.asarray(arr, dtype=numpy_dtype(dtype))


def _set(out: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        out = out.setdefault(k, {})
    out[path[-1]] = value


def load_state(root: str, like: PyTree) -> tuple[PyTree, int]:
    """Restore a checkpoint into the structure of ``like`` (shape-checked).

    ``like`` leaves only need ``.shape`` and ``.dtype`` (tensors, arrays or
    ``reshard.Leaf`` templates).  Mismatches raise ``CheckpointError`` naming
    the leaf path, saved vs expected shape, and the manifest's recorded
    mesh/layout (a restore onto a different mesh goes through
    ``repro_torch.resilience.reshard``)."""
    manifest = load_manifest(root)
    out: dict = {}
    for path, leaf in iter_state(root, like, manifest):
        _set(out, path, leaf)
    return out, manifest["step"]


# ---------------------------------------------------------------------------
# Step-scoped checkpoint directories (atomicity + GC + rollback restore)
# ---------------------------------------------------------------------------
def checkpoint_steps(root: str) -> list[tuple[int, str]]:
    """(step, dir) of every step-scoped checkpoint under ``root``, ascending.
    Only directories with a manifest count."""
    out = []
    if not os.path.isdir(root):
        return out
    for entry in os.listdir(root):
        m = STEP_DIR_RE.match(entry)
        d = os.path.join(root, entry)
        if m and os.path.exists(os.path.join(d, MANIFEST)):
            out.append((int(m.group(1)), d))
    return sorted(out)


def save_checkpoint(root: str, state, *, step: int, meta: dict | None = None,
                    keep: int | None = None) -> str:
    """Save ``state`` (a tree or ``(path, leaf)`` pairs) under
    ``root/step_<step>/`` and GC old checkpoints (``keep`` newest valid)."""
    d = os.path.join(root, step_dir_name(step))
    save_state(d, state, step=step, meta=meta)
    if keep is not None:
        gc_checkpoints(root, keep=keep)
    return d


def gc_checkpoints(root: str, *, keep: int) -> list[str]:
    """Delete step dirs older than the ``keep`` newest *valid* checkpoints.
    Corrupt checkpoints do not count toward ``keep``; a corrupt dir newer
    than the keep-set stays for inspection.  Returns the removed paths."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    removed = []
    valid_seen = 0
    for _, d in reversed(checkpoint_steps(root)):
        if valid_seen >= keep:
            shutil.rmtree(d)
            removed.append(d)
            continue
        try:
            if not verify_files(d):
                valid_seen += 1
        except CheckpointError:
            pass
    return removed


def restorable(root: str, *, max_rollback: int | None = None
               ) -> Iterator[tuple[int, str, dict]]:
    """Yield (step, dir, manifest) of *intact* checkpoints, newest first;
    corrupt or torn ones are skipped, ``max_rollback`` bounds how many
    older-than-newest steps are tried."""
    for step, d, manifest, bad in candidates(root, max_rollback=max_rollback):
        if not bad:
            yield step, d, manifest


def candidates(root: str, *, max_rollback: int | None = None
               ) -> Iterator[tuple[int, str, dict | None, str]]:
    """Every step dir ``restorable`` looks at, newest first, as (step, dir,
    manifest or None, why it is not intact or "")."""
    steps = list(reversed(checkpoint_steps(root)))
    if max_rollback is not None:
        steps = steps[:max_rollback + 1]
    for step, d in steps:
        try:
            manifest = load_manifest(d)
        except CheckpointError as e:
            yield step, d, None, str(e)
            continue
        bad = verify_files(d, manifest)
        yield step, d, manifest, (f"checksum verification failed for {bad}" if bad else "")


def load_latest(root: str, like: PyTree, *, max_rollback: int | None = None
                ) -> tuple[PyTree, int, str]:
    """Restore the newest checkpoint that passes checksum verification,
    falling back over corrupt ones (bounded by ``max_rollback``) and then to
    a flat checkpoint directly under ``root``.  Returns ``(state, step,
    dir)``; raises ``CheckpointError`` naming every rejected candidate."""
    tried = []
    for _, d, _ in restorable(root, max_rollback=max_rollback):
        try:
            state, s = load_state(d, like)
            return state, s, d
        except CheckpointError as e:
            tried.append(f"{d}: {e}")
    if os.path.exists(os.path.join(root, MANIFEST)):     # flat layout
        if not verify_files(root):
            state, s = load_state(root, like)
            return state, s, root
        tried.append(f"{root}: checksum verification failed")
    detail = "; ".join(tried) if tried else "no step_* checkpoint dirs found"
    raise CheckpointError(f"no valid checkpoint under {root}: {detail}")
