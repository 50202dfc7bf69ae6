"""Idle device ms per decode step of the traced replay that fall inside the
engine's model steps: the gaps (``Trace.gaps``) under the host ranges
``serve.prefill`` and ``serve.decode`` that its tracer's spans open on the
profiler's clock, over the count of ``serve.decode`` ranges.  That idle is
the host launching and waiting inside a step, which a captured step could
remove; the idle between steps is the engine's bookkeeping.  The profiler
slows the host (``device_idle.serve``), so this reads the replay's steps,
not the window's.  None from an engine that opens no such range."""
UNIT = "ms"

STEPS = ("serve.prefill", "serve.decode")


def read(run):
    if run.kind != "serve" or run.trace is None or not run.trace.device:
        return None
    steps = sorted((a, b) for n, a, b in run.trace.host if n in STEPS)
    decodes = sum(1 for n, _, _ in run.trace.host if n == "serve.decode")
    if not decodes:
        return None
    inside, i = 0.0, 0
    for a, b in run.trace.gaps():     # both lists ordered and each disjoint
        while i < len(steps) and steps[i][1] <= a:
            i += 1
        j = i
        while j < len(steps) and steps[j][0] < b:
            inside += min(b, steps[j][1]) - max(a, steps[j][0])
            j += 1
    return 1e3 * inside / decodes
