#!/usr/bin/env python3
"""K5 (``flash_attention_bwd_dkv``) and the split of a KV head's query heads
over blocks, on one NVIDIA GPU:

    git archive <rev> src/repro_torch/kernels/csrc | tar -x -C build/k5_old
    python3 tools/torch_dkv_split.py [build/k5_old/src/repro_torch/kernels/csrc]

(a) At granite-20b's training micro-batch, q [2, 2048, 48, 128] and k/v
    [2, 2048, 1, 128] in bf16, causal (64 key tiles for the card's SMs),
    K5 runs at every G that divides its 48 query heads from 1 to 8.  Each G
    is held to the plain version (2e-2 of each output's scale, phase 2's
    tolerance), five calls must give equal bits, and the G are timed in
    turns (``chip_smoke.in_turns``: 5 rounds of a, b, .., b, a).  Printed
    beside them: K5's bound, SDPA's backward (dq, dk and dv together) and the
    G that ``dkv_split`` chooses.
(b) Given the csrc directory of an earlier tree, its ``flash_attention_bwd.cu``
    is compiled alone with the port's nvcc flags.  At every shape where the
    key tiles alone give each SM a block (Yi-6B's, llava's, musicgen's,
    dbrx-132b's, arctic-480b's and zamba2-7b's training micro-batches), K5
    must choose G = 1 and give the earlier source's bits; so must G = 1 at
    granite's shape.  At Yi-6B's shape both are timed in turns.

Exits nonzero if a check fails.  Lines go to the standard output, and the
readings as one JSON line at the end.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

GRANITE = (2, 2048, 48, 1, 128)             # B, S, Hq, Hkv, D
SPLITS = (1, 2, 3, 4, 6, 8)
# (label, B, S, Hq, Hkv, D): the key tiles give every SM a block
NO_SPLIT = (("yi-6b", 2, 2048, 32, 4, 128), ("yi-6b planned, M = 1", 8, 2048, 32, 4, 128),
            ("llava", 1, 4096, 32, 8, 128),
            ("musicgen", 2, 2048, 32, 32, 64), ("dbrx-132b", 2, 2048, 48, 8, 128),
            ("arctic-480b", 1, 2048, 56, 8, 128), ("arctic-480b prefill", 4, 512, 56, 8, 128),
            ("zamba2-7b", 2, 2048, 32, 32, 112))
ROUNDS = 5


def main(argv: list[str]) -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if len(argv) > 1 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    new = _build.library().rt_flash_attention_bwd_dkv
    old = None
    if argv:
        out_dir = os.path.join(ROOT, "build", "k5_ab")
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, "old.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                        os.path.join(argv[0], "flash_attention_bwd.cu")],
                       check=True, capture_output=True, text=True)
        old = ctypes.CDLL(so).rt_flash_attention_bwd_dkv
        old.argtypes = _build.ENTRY_POINTS["rt_flash_attention_bwd_dkv"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    failures, res = [], {"card": smi}

    def inputs(B, S, Hq, Hkv, D):
        q, do = (torch.randn(B, S, Hq, D, generator=g, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        out, lse = fa.flash_attention_fwd_cuda(q, k, v)
        _, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, out, lse, do)
        return q, k, v, do, lse, delta

    def caller(lib, split, q, k, v, do, lse, delta):
        """A K5 call through ``lib``'s C entry at ``split``, into fixed outputs."""
        B, S, Hq, D = q.shape
        Hkv = k.shape[2]
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        ws = (torch.empty((split, 2, B, S, Hkv, D), dtype=torch.float32, device="cuda")
              if split > 1 else None)
        strides = [fa._strides(t, "k5") for t in (q, k, v, do)]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if ws is None else ws.data_ptr(), split, B, S, Hq, Hkv, D, *strides,
                S, 1, 0, 0.0, fa.DTYPES[torch.bfloat16])

        def call():
            _build.check(lib(*args, torch.cuda.current_stream().cuda_stream), "K5")
            return dk, dv
        return call

    # (a) every G at granite's shape
    B, S, Hq, Hkv, D = GRANITE
    q, k, v, do, lse, delta = inputs(*GRANITE)
    chosen = fa.dkv_split(B, S, Hq, Hkv, D, fa.DTYPES[torch.bfloat16])
    want = fa.plain_bwd_dkv(q, k, v, do, lse, delta)
    calls = {}
    for G in SPLITS:
        call = caller(new, G, q, k, v, do, lse, delta)
        first = [t.clone() for t in call()]
        same = all(all(torch.equal(a, b) for a, b in zip(call(), first)) for _ in range(4))
        errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(first, want)]
        tols = [cs.BF16_BWD_TOL * max(1.0, w.float().abs().max().item()) for w in want]
        ok = same and all(e <= t for e, t in zip(errs, tols))
        print(f"granite G={G}: max abs err dk {errs[0]:.3e} dv {errs[1]:.3e} (tol "
              f"{tols[0]:.3e}, {tols[1]:.3e}); 5 calls {'equal' if same else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"granite G={G}")
        calls[G] = call
        res[f"granite_G{G}_first"] = first
    del want
    turns = cs.in_turns(torch, {f"G={G}": (calls[G], 1) for G in SPLITS}, 20, ROUNDS)
    pairs = B * Hq * cs.live_pairs(S)
    es = q.element_size()
    bound = cs.bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * B * Hq * S, 8 * D * pairs,
                     "bfloat16")
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), [qt, kt, vt], dot)

    sdpa_bwd = cs.cuda_ms(torch, sdpa_fwd_bwd, 10) - cs.cuda_ms(torch, sdpa, 10)
    print(f"K5 at granite-20b's shape q [{B}, {S}, {Hq}, {D}] k/v [{B}, {S}, {Hkv}, {D}] bf16 "
          f"causal on {smi}, {ROUNDS} rounds in turns; bound {bound[0]:.4f} ms ({bound[1]}); "
          f"SDPA backward {sdpa_bwd:.4f} ms; dkv_split chooses G = {chosen}")
    for name, ms in turns.items():
        print(f"  {name}: min {min(ms):.4f} median {statistics.median(ms):.4f} max "
              f"{max(ms):.4f} ms", flush=True)
    res.update(granite_turns=turns, granite_bound_ms=bound[0], granite_sdpa_bwd_ms=sdpa_bwd,
               granite_chosen=chosen)
    if old is not None:
        first = res["granite_G1_first"]
        got = caller(old, 1, q, k, v, do, lse, delta)()
        same = all(torch.equal(a, b) for a, b in zip(got, first))
        print(f"granite G=1 against the earlier source: {'bit for bit' if same else 'DIFFER'}")
        if not same:
            failures.append("granite G=1 differs from the earlier source")
    for key in [k_ for k_ in res if k_.endswith("_first")]:
        del res[key]
    del q, k, v, do, lse, delta, qt, kt, vt, dot, calls
    torch.cuda.empty_cache()

    # (b) G = 1 and the earlier source's bits where the key tiles fill the card
    for label, *shape in NO_SPLIT:
        B, S, Hq, Hkv, D = shape
        split = fa.dkv_split(B, S, Hq, Hkv, D, fa.DTYPES[torch.bfloat16])
        line = f"{label} q [{B}, {S}, {Hq}, {D}] kv heads {Hkv}: dkv_split {split}"
        if split != 1:
            failures.append(f"{label}: split {split}")
        if old is not None:
            q, k, v, do, lse, delta = inputs(*shape)
            a = caller(old, 1, q, k, v, do, lse, delta)
            b = caller(new, 1, q, k, v, do, lse, delta)
            got_a = [t.clone() for t in a()]
            got_b = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
            same = all(torch.equal(x, y) for x, y in zip(got_a, got_b))
            line += f"; the wrapper's dk, dv against the earlier source: " \
                    f"{'bit for bit' if same else 'DIFFER'}"
            if not same:
                failures.append(f"{label}: differs from the earlier source")
            if label == "yi-6b":
                t = cs.in_turns(torch, {"earlier": (a, 1), "this": (b, 1)}, 20, ROUNDS)
                res["yi_turns"] = t
                line += "; in turns " + ", ".join(
                    f"{n} median {statistics.median(ms):.4f} ms (min {min(ms):.4f}, max "
                    f"{max(ms):.4f})" for n, ms in t.items())
            del q, k, v, do, lse, delta, got_a, got_b
            torch.cuda.empty_cache()
        print(line, flush=True)
    print(json.dumps(res))
    if failures:
        print(f"FAILED: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
