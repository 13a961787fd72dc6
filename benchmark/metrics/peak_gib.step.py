"""``peak_gib.step``: the peak of allocated device memory over the traced
gradient steps (``torch.cuda.max_memory_allocated``), in GiB."""


def read(probe):
    return probe.peak_bytes / 2 ** 30 if probe.unit == "step" and probe.peak_bytes else None
