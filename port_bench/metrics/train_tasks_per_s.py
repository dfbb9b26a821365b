"""LITE task steps completed over the whole window's host time, updates
included."""
from port_bench import measure


def read(run):
    return measure.per_second(run, "tasks") if "step_s" in run.facts else None
