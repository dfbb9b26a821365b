"""Seconds from the process's start to the window's opening: imports, the
kernels' build or load, weights, frame bank and warm-up."""


def read(run):
    return run.facts.get("setup_s")
