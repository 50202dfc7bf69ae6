"""Share of the traced replay's stretch (not the window; see
``attn_roofline.serve``) with no device operation running."""
UNIT = "%"


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
