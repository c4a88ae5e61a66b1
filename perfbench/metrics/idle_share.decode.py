"""idle_share.decode: the share of the traced window in which no device
operation ran: 1 - (union of device-op intervals) / window."""


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
