"""Model flops of the window's training steps (``counts.train_step_flops``)
over the window's wall time, the cards and the bf16 peak."""
from bench.harness import counts

UNIT = "%"


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    t = run.traffic
    flops = counts.train_step_flops(run.conf, t["global_batch"], t["seq_len"]) * run.steps
    return 100.0 * flops / (run.window_s * run.chips * counts.PEAK_BF16_FLOPS)
