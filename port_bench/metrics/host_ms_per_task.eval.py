"""Window time outside the protocol's personalise and predict timers, per task."""
from port_bench import measure


def read(run):
    if "personalise_s" not in run.facts:
        return None
    return measure.host_ms(run, ["personalise_s", "predict_s"])
