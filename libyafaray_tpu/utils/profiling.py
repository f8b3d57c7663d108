"""Render profiling & tracing.

The reference has no profiler — only named Timer events ("rendert",
src/integrator/surface/integrator_tiled.cc:149-150,228), a render-stats
string (ImageFilm::printRenderStats, include/render/imagefilm.h:153) and
kd-tree build counters (include/accelerator/accelerator_kdtree.h:85-97).
This module provides the equivalents:

  - RenderStats: per-pass wall times + ray counts + rays/s, with a
    printable summary (printRenderStats analogue).
  - trace(): context manager around jax.profiler for XLA device traces.
  - device_op_summary(): parses the captured chrome trace and returns the
    top ops on the GPU's streams by total time — per-kernel attribution.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class RenderStats:
    """Accumulates render timings (Timer/"rendert" + printRenderStats
    analogue)."""
    pass_times: List[float] = field(default_factory=list)
    pass_rays: List[int] = field(default_factory=list)
    events: Dict[str, float] = field(default_factory=dict)
    _t0: Optional[float] = None

    # --- named events (reference common/timer.h addEvent/start/stop) ---
    def start(self, name: str = "rendert") -> None:
        self.events[name + ".__start"] = time.time()

    def stop(self, name: str = "rendert") -> float:
        t0 = self.events.pop(name + ".__start", None)
        if t0 is None:
            return 0.0
        dt = time.time() - t0
        self.events[name] = self.events.get(name, 0.0) + dt
        return dt

    def get_time(self, name: str = "rendert") -> float:
        return self.events.get(name, 0.0)

    # --- per-pass accounting ---
    def begin_pass(self) -> None:
        self._t0 = time.time()

    def end_pass(self, rays: int) -> None:
        if self._t0 is None:
            return
        self.pass_times.append(time.time() - self._t0)
        self.pass_rays.append(int(rays))
        self._t0 = None

    @property
    def total_time(self) -> float:
        return sum(self.pass_times)

    @property
    def total_rays(self) -> int:
        return sum(self.pass_rays)

    @property
    def rays_per_sec(self) -> float:
        t = self.total_time
        return self.total_rays / t if t > 0 else 0.0

    def summary(self) -> str:
        """printRenderStats analogue: one human-readable line per metric."""
        lines = [
            f"passes: {len(self.pass_times)}",
            f"total render time: {self.total_time:.3f} s",
            f"camera rays: {self.total_rays}",
            f"rays/sec: {self.rays_per_sec:,.0f}",
        ]
        if self.pass_times:
            lines.append(
                f"per-pass time: min {min(self.pass_times):.3f} s, "
                f"max {max(self.pass_times):.3f} s, "
                f"mean {self.total_time / len(self.pass_times):.3f} s")
        for k, v in sorted(self.events.items()):
            if not k.endswith(".__start"):
                lines.append(f"timer '{k}': {v:.3f} s")
        return "\n".join(lines)


class trace:
    """Context manager capturing a device trace via jax.profiler.

    Usage:
        with profiling.trace("/tmp/mytrace"):
            film = render(scene, cfg, spp=4)
        top = profiling.device_op_summary("/tmp/mytrace")
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._cm = None

    def __enter__(self):
        import jax
        self._cm = jax.profiler.trace(self.log_dir)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


DEVICE_PREFIX = "/device:GPU"


def device_op_summary(log_dir: str, top: int = 20
                      ) -> List[Tuple[str, float, int]]:
    """Parse the chrome trace(s) under `log_dir` and return the top device
    ops as (name, total_ms, count), heaviest first. Only events of trace
    processes whose name starts with DEVICE_PREFIX count (the card's
    streams); host threads, whose spans would otherwise be mixed into
    device time, are left out."""
    totals: Dict[str, float] = collections.Counter()
    counts: Dict[str, int] = collections.Counter()
    for f in glob.glob(f"{log_dir}/**/*.trace.json.gz", recursive=True):
        with gzip.open(f) as fh:
            data = json.load(fh)
        events = data.get("traceEvents", [])
        device_pids = {
            e.get("pid") for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and str(e.get("args", {}).get("name", "")).startswith(
                DEVICE_PREFIX)}
        for e in events:
            if (e.get("ph") != "X" or "dur" not in e
                    or e.get("pid") not in device_pids):
                continue
            name = e.get("name", "?")
            totals[name] += e["dur"]
            counts[name] += 1
    return [(n, t / 1000.0, counts[n])
            for n, t in collections.Counter(totals).most_common(top)]
