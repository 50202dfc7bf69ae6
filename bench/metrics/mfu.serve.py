"""Model flops of every prefill and decoded token the engine produced in the
window (``counts.prefill_flops`` at the prompt's length for a first token,
``counts.decode_flops`` at its live context for each later one) over the
window's wall time, the cards and the bf16 peak."""
from bench.harness import counts

UNIT = "%"


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    flops = 0.0
    for prompt, _, walls in run.requests:
        for i, t in enumerate(walls):
            if 0.0 <= t <= run.window_s:
                flops += (counts.prefill_flops(run.conf, prompt) if i == 0
                          else counts.decode_flops(run.conf, prompt + i))
    return 100.0 * flops / (run.window_s * run.chips * counts.PEAK_BF16_FLOPS)
