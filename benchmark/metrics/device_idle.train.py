"""device_idle.train: the share (%) of the measured window in which the device had nothing
to run, from the traced part's device seconds a unit (``harness.trace.idle_share``)."""

from harness.trace import idle_share as read  # noqa: F401
