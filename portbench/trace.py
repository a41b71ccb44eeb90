"""The traced window: a ``torch.profiler`` capture and what is read from it.

The capture records every thread's torch ops (the node's rx thread,
feeder and completer) and, through CUPTI, every kernel, copy and fill on
the card. :func:`summarize` reduces its Chrome trace to the numbers the
per-layer readers and the result's ``device`` and ``breakdown`` use:

* ``busy_s``: the union of the device's records over the window;
* ``kernel_s``: the summed time of the kernel records (copies and fills
  left out), the time a roofline share is taken over;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the ten longest gaps between device records, each named
  by the longest host op that was running at its middle
  (``host:no_torch_op`` where none was).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Window:
    """A profiler window over the whole process; :meth:`stop` synchronizes
    the card first, so every launch of the window has run."""

    def __init__(self, torch_mod):
        from torch._C._profiler import _ExperimentalConfig

        self.torch = torch_mod
        acts = [torch_mod.profiler.ProfilerActivity.CPU, torch_mod.profiler.ProfilerActivity.CUDA]
        self.prof = torch_mod.profiler.profile(
            activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> Dict[str, object]:
        self.torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events, self.t1 - self.t0)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: list, window_s: float) -> Dict[str, object]:
    """The numbers of one Chrome trace (times in µs) over a window of
    ``window_s`` seconds by the host's clock."""
    dev, host = [], []
    by_name: Dict[str, float] = {}
    kernel_us = 0.0
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            dev.append(span)
            name = str(ev.get("name", "?"))[:96]
            by_name[name] = by_name.get(name, 0.0) + float(ev["dur"])
            if cat == "kernel":
                kernel_us += float(ev["dur"])
        elif cat == "cpu_op":
            host.append((span[0], span[1], str(ev.get("name", "?"))))
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    host.sort(key=lambda h: h[1] - h[0], reverse=True)
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        what = next((h[2] for h in host if h[0] <= mid <= h[1]), None)
        idle.append(["host:" + what if what else "host:no_torch_op", length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_records": len(dev),
        "device_ops": [[n, us / 1e6] for n, us in ops],
        "idle_gaps": idle,
    }
