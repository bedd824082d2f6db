"""Mean host time of one `InferenceRunner.dispatch` (the harness's span
around each call: stacking the windows, the pinned staging copy, the
upload and the forward's enqueue), in ms."""


def read(r):
    spans = r.spans.get("dispatch")
    return 1e3 * sum(spans) / len(spans) if spans else None
