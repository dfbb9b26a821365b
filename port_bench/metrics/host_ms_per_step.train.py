"""Window time outside the learner's task-step timer (updates, evaluator,
prefetch wait), per step."""
from port_bench import measure


def read(run):
    return measure.host_ms(run, ["step_s"]) if "step_s" in run.facts else None
