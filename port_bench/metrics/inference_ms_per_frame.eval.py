"""The protocol's own inference timer (predict through the logits on the host,
ended by the copy) summed over the window's tasks, per real query frame."""


def read(run):
    f = run.facts
    return 1e3 * sum(f["predict_s"]) / f["query_frames"] if "predict_s" in f else None
