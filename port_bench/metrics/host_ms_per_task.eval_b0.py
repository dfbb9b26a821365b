"""Window time outside the protocol's personalise and predict timers, per task.
As its ``.eval`` twin, in the B0 SimpleCNAPs cell, whose throughput is
``query_frames_per_s.b0``."""
from port_bench import measure


def read(run):
    if "personalise_s" not in run.facts:
        return None
    return measure.host_ms(run, ["personalise_s", "predict_s"])
