"""Arithmetic the metric readers share over a run's facts and trace."""
from __future__ import annotations

import sys
import statistics
from typing import Optional


def per_second(run, count: str) -> Optional[float]:
    if count not in run.facts or "window_s" not in run.facts:
        return None
    return run.facts[count] / run.facts["window_s"]


def host_ms(run, busy: list) -> Optional[float]:
    """Window time outside ``busy`` (the loop's own timed regions), per
    task, in ms."""
    f = run.facts
    spent = sum(sum(f[k]) for k in busy if k in f)
    return 1e3 * (f["window_s"] - spent) / f["tasks"] if "window_s" in f else None


def mean_ms(run, key: str) -> Optional[float]:
    return 1e3 * statistics.mean(run.facts[key]) if run.facts.get(key) else None


def _derived(run) -> Optional[dict]:
    """The traced span's summary where its work was derived from shapes;
    None (and why, on standard error) without a trace or where the
    configuration's calls are not derived."""
    t = run.trace
    if t and "unpredicted" in t:
        print(f"no roofline or MFU: {t['unpredicted']}", file=sys.stderr)
        return None
    return t or None


def roofline_pct(run) -> Optional[float]:
    """The traced span's summed kernel bounds over the device time of the
    port's kernels; None without a trace, without port kernels, or where a
    launch counter disagrees with the calls the shapes predict, whichever
    side has the kernel."""
    t = _derived(run)
    if not t or t["port_kernel_s"] <= 0:
        return None
    expected = t["expected_launches"]
    wrong = {k: (t["launches"].get(k, 0), expected.get(k, 0))
             for k in set(t["launches"]) | set(expected)
             if t["launches"].get(k, 0) != expected.get(k, 0)}
    if wrong:
        print(f"kernel launches (counted, expected from shapes) disagree: {wrong}",
              file=sys.stderr)
        return None
    return 100.0 * t["bound_s"] / t["port_kernel_s"]


def idle_pct(run) -> Optional[float]:
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None


def mfu_pct(run) -> Optional[float]:
    t = _derived(run)
    return 100.0 * t["model_flops"] / (t["window_s"] * t["peak_flops"]) if t else None
