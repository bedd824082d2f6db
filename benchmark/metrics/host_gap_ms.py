"""Host time of one `consensus_predict` call in which the device was idle,
in ms: the sum of the harness's spans around the calls less the device's
busy time in the traced window (the loop does nothing between calls, and
each call ends on a fetch, so the device works only inside them), per
call."""


def read(r):
    spans = r.spans.get("consensus")
    if not spans or r.trace is None:
        return None
    return 1e3 * (sum(spans) - r.trace.busy_s) / len(spans)
