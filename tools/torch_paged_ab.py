#!/usr/bin/env python3
"""Time the port's paged-decode kernel (K7) against an earlier version of
its CUDA source, both in one process on one NVIDIA GPU.

    git archive <rev> src/repro_torch/kernels/csrc | tar -x -C build/k7_old
    python3 tools/torch_paged_ab.py build/k7_old/src/repro_torch/kernels/csrc

The earlier source is the single-pass kernel, whose ``rt_paged_attention_decode``
takes no scratch arguments.  It is compiled alone with the port's nvcc flags.
Both kernels run at ``chip_smoke.py``'s phase-2 shape: 8 requests, 32 q and
4 KV heads, hd 128, bf16, 16-token blocks, contexts 65-577.  They are timed in
turns (old, new, new, old), each in two ways:

  * back to back: CUDA events around 200 calls from Python.  This is how
    ``chip_smoke.py`` times every kernel.  Where the host's cost of a call
    exceeds the kernel's, it times the host.
  * graph: a CUDA graph of 50 launches, replayed, which leaves out the host.

Each version is timed through a bare ctypes call with no checks, and the new
one also through its wrapper ``paged_attention_cuda``.  Before any timing,
both outputs are checked against the plain version.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OLD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                             ctypes.c_void_p]


def main(argv: list[str]) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    old_src = os.path.join(argv[0], "paged_attention.cu")
    out_dir = os.path.join(ROOT, "build", "k7_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "old.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, old_src],
                   check=True, capture_output=True, text=True)
    old = ctypes.CDLL(so).rt_paged_attention_decode
    old.argtypes = OLD_ARGTYPES
    new = _build.library().rt_paged_attention_decode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ctx = [577, 65, 301, 512, 130, 449, 96, 260]
    R, Hq, Hkv, D, bs, N = len(ctx), 32, 4, 128, 16, 2049
    maxb = -(-max(ctx) // bs) + 1
    q = torch.randn(R, Hq, D, generator=g, device=dev).bfloat16()
    kp, vp = (torch.randn(N, Hkv, bs, D, generator=g, device=dev).bfloat16() for _ in range(2))
    bt = torch.randperm(N - 1, generator=g, device=dev)[:R * maxb].view(R, maxb).int()
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    n_splits = -(-maxb * bs // pa.KEYS_PER_SPLIT)
    part = pa._buffer(R * Hq * n_splits * (D + 2), torch.float32, dev)
    counters = pa._buffer(R * Hq, torch.int32, dev)
    ptrs = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(), cl.data_ptr(),
            out.data_ptr())
    shape = (R, Hq, Hkv, D, N, bs, maxb, 0, 0.0, 1)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call_old():
        _build.check(old(*ptrs, *shape, stream()), "old")

    def call_new():
        _build.check(new(*ptrs, part.data_ptr(), counters.data_ptr(), *shape, stream()), "new")

    def wrapper():
        pa.paged_attention_cuda(q, kp, vp, bt, cl)

    want = pa.plain(q, kp, vp, bt, cl)
    tol = cs.bf16_ulp(want.float().abs().max().item())
    for name, fn in (("old", call_old), ("new", call_new)):
        fn()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        print(f"{name}: max abs err against the plain version {err:.3e} (one ulp {tol:.3e})")
        if not err <= tol:
            return 1

    res = {}
    for name, fn in (("old", call_old), ("new", call_new), ("new", call_new), ("old", call_old)):
        res.setdefault(name, []).append({"back_to_back_ms": cs.cuda_ms(torch, fn, 200),
                                         "graph_ms": cs.graph_ms(torch, fn)})
    res["new wrapper"] = [{"back_to_back_ms": cs.cuda_ms(torch, wrapper, 200),
                           "graph_ms": cs.graph_ms(torch, wrapper)}]
    for name, runs in res.items():
        print(f"{name:12s}" + "  ".join(f"back to back {r['back_to_back_ms']:.4f} ms, graph "
                                       f"{r['graph_ms']:.4f} ms" for r in runs))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
