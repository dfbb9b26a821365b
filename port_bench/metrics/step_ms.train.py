"""The mean of the learner's task-step timer (ended by a device sync) over the
window."""
from port_bench import measure


def read(run):
    return measure.mean_ms(run, "step_s")
