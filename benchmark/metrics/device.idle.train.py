"""Share (%) of the traced slice of training in which no device operation
ran: the union of the operations' intervals over the slice's host time,
from the device-only trace."""


def read(rec):
    tr = rec["device_trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.busy_s else None
