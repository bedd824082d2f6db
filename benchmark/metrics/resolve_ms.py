"""Mean host time of one `InferenceRunner.resolve` (the harness's span
around each call: the wait for the batch's event, the fetch of its
probabilities and the building of its predictions), in ms."""


def read(r):
    spans = r.spans.get("resolve")
    return 1e3 * sum(spans) / len(spans) if spans else None
