"""The run's peak of allocated device memory over set-up and window
(``torch.cuda.max_memory_allocated``), read when the window closes."""


def read(run):
    peak = run.facts.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
