"""The training run's peak of allocated device memory over set-up and
window (``torch.cuda.max_memory_allocated``), read when the window closes.
A metric apart from the eval cells' ``peak_mem_gib``: the learner prepares
and copies up to two tasks ahead of the step on its prefetch thread, so how
much of the next tasks' frames is on the card at the largest step depends
on the host's pace, and the peak takes one of a few values (PERF.md)."""


def read(run):
    peak = run.facts.get("peak_bytes")
    return peak / 2 ** 30 if peak and "step_s" in run.facts else None
