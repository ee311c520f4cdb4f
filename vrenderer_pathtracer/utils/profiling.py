"""Timing and throughput instrumentation.

The reference's only performance tooling is a wall-clock HUD (fps, ms/frame,
spp — ``src/NGLScene.cpp:256-261,324-342``).  Their equivalents here (SURVEY
§5.1): a ``block_until_ready`` timing harness, Mrays/s / Mpaths/s counters,
and a ``jax.profiler`` trace context for xprof/Perfetto timelines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import jax


def timeit(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kw) -> float:
    """Median-free mean seconds per call, after warmup, fully synchronized."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@dataclasses.dataclass
class RenderStats:
    """Throughput bookkeeping for a render workload.

    Rays are counted the way BASELINE.md specifies: pixels x spp x bounces
    (every bounce wave traces one ray per live lane; masked lanes still
    occupy the device, so this is the honest device-work number).
    """

    width: int
    height: int
    samples_per_pass: int
    bounces: int
    seconds_per_pass: float

    @property
    def rays_per_pass(self) -> int:
        return self.width * self.height * self.samples_per_pass * self.bounces

    @property
    def mrays_per_s(self) -> float:
        return self.rays_per_pass / self.seconds_per_pass / 1e6

    @property
    def mpaths_per_s(self) -> float:
        return (self.width * self.height * self.samples_per_pass
                / self.seconds_per_pass / 1e6)

    @property
    def ms_per_pass(self) -> float:
        return self.seconds_per_pass * 1e3

    def hud_line(self, spp_total: int) -> str:
        """The reference HUD, one line: fps / ms / spp."""
        fps = 1.0 / self.seconds_per_pass
        return (f"{fps:6.1f} fps  {self.ms_per_pass:7.2f} ms/frame  "
                f"{spp_total} spp  {self.mrays_per_s:8.1f} Mrays/s")


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """jax.profiler trace (view with xprof / tensorboard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure_renderer(renderer, warmup: int = 1, iters: int = 5) -> RenderStats:
    """Time progressive passes of a Renderer and return throughput stats."""
    for _ in range(warmup):
        renderer.render()
    jax.block_until_ready(renderer._accum)
    t0 = time.perf_counter()
    for _ in range(iters):
        renderer.render()
    jax.block_until_ready(renderer._accum)
    s = renderer.settings
    return RenderStats(
        width=s.width, height=s.height, samples_per_pass=s.samples_per_pass,
        bounces=s.bounces,
        seconds_per_pass=(time.perf_counter() - t0) / iters,
    )
