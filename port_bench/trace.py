"""The traced part of a ``--trace 1`` window: ``torch.profiler`` over a
fixed number of whole tasks, reduced to what the per-layer readers need.

- ``window_s``: host seconds from the profiler's start to its stop (after
  a device sync);
- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``port_kernel_s``: device seconds of the port's own kernels
  (``roofline.PORT_KERNELS``);
- ``launches``: the port's launch counters (``kernels.build.LAUNCHES``)
  over the span;
- ``breakdown``: the ten device operations that took most time, and the
  ten host operations under which the device sat idle longest (the
  innermost torch operation of the launching thread that covers each gap's
  middle, or "host Python, no torch op").

The span starts and stops at task boundaries on the loop's own thread,
from the hooks the loop modules install; nothing inside the program is
annotated.
"""
from __future__ import annotations

import re
import time
from collections import Counter
import numpy as np
import torch

from port_bench import setup
from port_bench.roofline import PORT_KERNELS

NO_OP = "host Python, no torch op"


def _device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


class Tracer:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.launches0 = self.launches = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        from orbit_tpu_torch.kernels import build as kbuild
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.launches0 = dict(kbuild.LAUNCHES)
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        from orbit_tpu_torch.kernels import build as kbuild

        setup.sync()
        self.t1 = time.perf_counter()
        self.launches = {k: v - self.launches0.get(k, 0) for k, v in kbuild.LAUNCHES.items()}
        self.prof.stop()

    def summarise(self) -> dict:
        """Reduce the trace once the window has closed."""
        events = list(self.prof.events())
        dev = [e for e in events if _device(e) and e.time_range.end > e.time_range.start]
        spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy_us = sum(e - s for s, e in merged)
        port = re.compile(PORT_KERNELS)
        port_us = sum(e.time_range.end - e.time_range.start for e in dev if port.search(e.name))
        by_op = Counter()
        for e in dev:
            by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        summary = {
            "window_s": self.t1 - self.t0,
            "busy_s": busy_us / 1e6,
            "port_kernel_s": port_us / 1e6,
            "launches": self.launches,
            "breakdown": {"device_ops": [[n[:200], s] for n, s in by_op.most_common(10)],
                          "idle_gaps": self._gaps(events, merged)},
        }
        self.prof = None
        return summary

    @staticmethod
    def _gaps(events, merged):
        """Idle device time by the host operation that covered it."""
        host = [e for e in events if not _device(e) and e.time_range.end > e.time_range.start]
        if len(merged) < 2 or not host:
            return []
        launcher = Counter(e.thread for e in host
                           if "cudaLaunch" in e.name or "LaunchKernel" in e.name)
        thread = launcher.most_common(1)[0][0] if launcher else Counter(
            e.thread for e in host).most_common(1)[0][0]
        host = [e for e in host if e.thread == thread]
        starts = np.array([e.time_range.start for e in host], np.float64)
        ends = np.array([e.time_range.end for e in host], np.float64)
        gaps = [(merged[i + 1][0] - merged[i][1], 0.5 * (merged[i + 1][0] + merged[i][1]))
                for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        total = Counter()
        for length, mid in gaps[:2000]:
            cover = np.flatnonzero((starts <= mid) & (ends >= mid))
            if cover.size:
                inner = cover[np.argmin(ends[cover] - starts[cover])]
                total[host[inner].name[:200]] += length / 1e6
            else:
                total[NO_OP] += length / 1e6
        return [[n, s] for n, s in total.most_common(10)]
