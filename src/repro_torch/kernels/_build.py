"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The output lives
in ``build/repro_torch_kernels/<hash of the sources>/`` under the checkout, so
a change to any source builds afresh and an unchanged tree reuses the
library.  A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_LL3 = ctypes.POINTER(ctypes.c_longlong)
# (name, argtypes) of every C entry point; each returns an int status
ENTRY_POINTS = {
    "rt_rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rt_rmsnorm_bwd": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    "rt_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _LL3, _LL3, _LL3, _I, _I, _I, _F, _I, _P],
    "rt_flash_attention_bwd_dq": [_P] * 8 + [_I] * 5 + [_LL3] * 5
                                 + [_I, _I, _I, _F, _I, _P],
    "rt_flash_attention_bwd_dkv_split": [_I] * 6,
    "rt_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 6 + [_LL3] * 4
                                  + [_I, _I, _I, _F, _I, _P],
    "rt_paged_attention_decode": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    "rt_adamw": [_P, _P, _P, _P, _P, _LL, _F, _F, _F, _F, _F, _F, _I, _P],
}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
                      "toolkit is needed to build the port's kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile (if needed) and return (library path, seconds spent building)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib, 0.0
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=BUILD_ROOT))
    cus = sorted(CSRC.glob("*.cu"))
    procs = [(cu, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(tmp / (cu.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for cu in cus]
    log, failed = [], []
    for cu, p in procs:
        text, _ = p.communicate()
        log.append(f"== {cu.name}\n{text}")
        if p.returncode != 0:
            failed.append(cu.name)
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp / lib.name),
                               *[str(tmp / (cu.stem + ".o")) for cu in cus]],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise KernelError(f"kernel build failed ({', '.join(failed)}):\n" + "\n".join(log))
    try:
        tmp.rename(out_dir)
    except OSError:              # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    if status == -1:
        raise KernelError(f"{name}: arguments the kernel does not take")
    if status != 0:
        raise KernelError(f"{name}: CUDA error {status} at launch")


def build_log() -> str:
    return (BUILD_ROOT / source_hash() / "build.log").read_text()
