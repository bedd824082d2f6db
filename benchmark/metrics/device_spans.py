"""What the per-layer metrics of a kernel's device time read: the port's
device-timed spans (`pepper_tpu_torch/utils/profiling.py:device_spans()`,
a CUDA event pair around each launch), which the program records only
while a torch.profiler session is active, in a run the traced window's.
Without that session, or from a program that records no device spans, each
reads None."""


def seconds(name: str) -> list:
    """The device seconds of each of the span's launches, or []."""
    from pepper_tpu_torch.utils import profiling

    read = getattr(profiling, "device_spans", None)
    return read().get(name, []) if read is not None else []
