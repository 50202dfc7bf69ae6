"""The decode steps' share of the chip's peak: model flops of every token
decoded in the window (``counts.decode_flops`` at its live context) over
the engine's ``decode`` spans in the window (its own tracer), the cards and
the bf16 peak."""
from bench.harness import counts

UNIT = "%"


def read(run):
    if run.kind != "serve" or not run.requests or not run.decode_spans:
        return None
    flops = sum(counts.decode_flops(run.conf, prompt + i)
                for prompt, _, walls in run.requests
                for i, t in enumerate(walls) if i > 0 and 0.0 <= t <= run.window_s)
    return 100.0 * flops / (sum(run.decode_spans) * run.chips * counts.PEAK_BF16_FLOPS)
