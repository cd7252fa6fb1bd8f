"""optimizer_ms.train: device milliseconds per training step of the operations launched
inside torch.optim's ``Optimizer.step#<Class>.step`` records of the traced window (the
span ``optimizer_step``, whatever the optimizer)."""

from harness.trace import OPTIMIZER_SPAN


def read(run):
    busy = run.trace.get("span_device_s", {}).get(OPTIMIZER_SPAN)
    n = run.trace.get("span_count", {}).get("train_step")
    if not busy or not n:
        return None
    return 1e3 * busy / n
