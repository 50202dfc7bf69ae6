"""Share of the traced training steps' window with no device operation
running."""
UNIT = "%"


def read(run):
    if run.kind != "train" or run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
