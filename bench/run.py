#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``<cell>`` names ``bench/workloads/<cell>.json``.
With ``--trace 0`` the last line of standard output is the cell's
end-to-end metrics; with ``--trace 1``, its per-layer metrics from the
readers in ``bench/metrics``.  The run needs as many CUDA cards as the cell
asks for and exits with a code other than 0, printing no result, without
them.  Kernel builds and caches stay under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.harness import runner, spec
    cell = spec.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails in a directory without the port)
    try:
        result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), T_START)
    except runner.BannedModules as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
