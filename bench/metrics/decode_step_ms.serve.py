"""Mean of the engine's ``decode`` spans in the window (its own tracer)."""
UNIT = "ms"


def read(run):
    if run.kind != "serve" or not run.decode_spans:
        return None
    return 1e3 * sum(run.decode_spans) / len(run.decode_spans)
