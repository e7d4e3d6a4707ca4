"""Mean host time of one tile's enqueue, the ``plcore.dispatch`` span of
the engine's tracer (upload, K2's launch, the copy back and its event),
over the dispatches in the traced window."""


def read(run):
    if not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)
