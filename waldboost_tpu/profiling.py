"""Observability: device profiling traces and cascade efficiency counters.

The reference's only perf instrument is the ``Model.eval_cost`` running
average (/root/reference/waldboost/model.py:69-89), which this framework
keeps as a first-class on-device counter (see ops.cascade's ``n_weak``).
This module adds the device-side tracing the reference lacks: jax.profiler
trace annotations around pipeline phases and a simple wall-clock/throughput
meter for benchmarking loops.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax

__all__ = ["trace_annotation", "start_trace", "stop_trace", "Meter"]


def trace_annotation(name: str):
    """Context manager: annotate a region in the device profiler timeline.

    Usage::
        with trace_annotation("channels"):
            canvas = compute_canvas(image)
    """
    return jax.profiler.TraceAnnotation(name)


def start_trace(log_dir: str) -> None:
    """Start capturing a device trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)


def stop_trace() -> None:
    jax.profiler.stop_trace()


@dataclass
class Meter:
    """Wall-clock throughput meter with named phases.

    Blocks on device results at phase boundaries so the numbers mean what
    they say.  Example::

        meter = Meter()
        with meter.phase("detect", items=batch, pixels=batch*h*w):
            out = fn(images)
        print(meter.report())
    """

    totals: Dict[str, float] = field(default_factory=dict)
    items: Dict[str, float] = field(default_factory=dict)
    pixels: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    def note_model(self, model, name: str = "detector") -> None:
        """Fold a Model's cascade-efficiency counters (running average +
        worst-case scan + survivor histogram, Model.cost_stats) into the
        report — the observability the reference's roadmap asked for
        ("Keep worst case eval. cost", /root/reference/NOTES.md:70)."""
        stats = model.cost_stats()
        self.counters[f"{name}.eval_cost"] = stats["eval_cost"]
        self.counters[f"{name}.worst_eval_cost"] = stats["worst_eval_cost"]
        self.counters[f"{name}.n_images"] = stats["n_images"]
        surv = stats["stage_survivors"]
        if surv is not None and len(surv) and surv[0] > 0:
            # survivor curve summary: depth at which survivors fall below
            # 10% / 1% of scanned windows (full histogram via cost_stats)
            frac = surv / float(surv[0])
            for q, lbl in ((0.1, "depth_10pct"), (0.01, "depth_1pct")):
                below = (frac < q).nonzero()[0]
                self.counters[f"{name}.{lbl}"] = float(
                    below[0] if len(below) else len(surv))

    @contextlib.contextmanager
    def phase(self, name: str, items: float = 0, pixels: float = 0,
              block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.items[name] = self.items.get(name, 0.0) + items
            self.pixels[name] = self.pixels.get(name, 0.0) + pixels

    def report(self) -> str:
        lines = []
        for name, dt in sorted(self.totals.items()):
            parts = [f"{name}: {dt * 1e3:.2f} ms"]
            if self.items.get(name):
                parts.append(f"{self.items[name] / dt:.1f} items/s")
            if self.pixels.get(name):
                parts.append(f"{self.pixels[name] / dt / 1e6:.1f} MP/s")
            lines.append("  ".join(parts))
        for name, val in sorted(self.counters.items()):
            lines.append(f"{name}: {val:g}")
        return "\n".join(lines)
