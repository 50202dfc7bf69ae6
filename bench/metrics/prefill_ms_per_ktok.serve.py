"""The engine's ``prefill`` spans in the window (its own tracer), per 1000
real prompt tokens prefilled (its own counter)."""
UNIT = "ms"


def read(run):
    if run.kind != "serve" or not run.prefill_spans or not run.prefill_tokens:
        return None
    return 1e3 * sum(run.prefill_spans) / (run.prefill_tokens / 1000.0)
