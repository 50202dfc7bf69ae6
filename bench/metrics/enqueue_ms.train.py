"""Host milliseconds from calling the training step to its return, before
the loss's sync: the mean over the window's steps."""
UNIT = "ms"


def read(run):
    if run.kind != "train" or not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
