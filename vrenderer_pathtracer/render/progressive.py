"""Progressive-sample scheduler with checkpoint/resume.

The reference's progressive state is exactly (accumulation buffer, frame
counter): ``clearBuffer()`` resets both (``src/vRendererCuda.cpp:100-105``),
display scales by ``accum/frame`` (``cuda/src/PathTracer.cu:858-859``), and
spp = samples_per_pass * frames (``src/NGLScene.cpp:331``).  It has NO
checkpointing (SURVEY §5.4) — this module adds it: that state triple plus
the RNG seed and camera/fresnel parameters fully determine the render, so a
preempted job resumes at the exact sample count, bit-identically (the
counter-based RNG keys draws by (pixel, sample, bounce), never by wall
clock).

A checkpoint is a directory holding one ``state.npz`` (numpy only), written
to a temporary file and renamed into place, so a preempted write never
leaves a half-written ``state.npz`` behind.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vrenderer_pathtracer.render.renderer import Renderer


def checkpoint_state(renderer: Renderer) -> dict:
    """The minimal state that determines the rest of the render.

    Leaves are materialised to host numpy so restore needs no sharding
    specs; restoring onto a device mesh re-shards via ``shard_pixels``.
    """
    state = {
        "accum": renderer._accum,
        "frame": np.int64(renderer.frame),
        "seed": np.int64(renderer.seed),
        "camera": renderer.camera._asdict(),
        "fresnel_coef": renderer.fresnel_coef,
        "fresnel_pow": renderer.fresnel_pow,
    }
    if renderer._last_depth is not None:
        state["depth"] = renderer._last_depth
    return jax.tree.map(np.asarray, state)


_STATE_FILE = "state.npz"


def save_checkpoint(renderer: Renderer, path) -> None:
    """Write the checkpoint directory ``path`` (created if missing)."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = checkpoint_state(renderer)
    flat = {k: v for k, v in state.items() if k != "camera"}
    flat.update({f"camera.{k}": v for k, v in state["camera"].items()})
    tmp = path / (_STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path / _STATE_FILE)


def restore_checkpoint(renderer: Renderer, path) -> Renderer:
    """Restore progressive state in place (scene/settings must match)."""
    from vrenderer_pathtracer.core.camera import Camera

    with np.load(pathlib.Path(path) / _STATE_FILE, allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    renderer._accum = jnp.asarray(state["accum"])
    renderer.frame = int(state["frame"])
    renderer.seed = int(state["seed"])
    renderer.camera = Camera(**{
        k[len("camera."):]: jnp.asarray(v) for k, v in state.items()
        if k.startswith("camera.")
    })
    renderer.fresnel_coef = jnp.asarray(state["fresnel_coef"])
    renderer.fresnel_pow = jnp.asarray(state["fresnel_pow"])
    depth = state.get("depth")
    renderer._last_depth = None if depth is None else jnp.asarray(depth)
    return renderer


@dataclasses.dataclass
class ProgressiveScheduler:
    """Drive a renderer to a target sample count with periodic checkpoints.

    The reference's 0-ms QTimer loop (``src/NGLScene.cpp:234-247``) rendered
    forever; here the loop has a goal (target spp), optional periodic
    checkpointing, and a per-pass callback (HUD role: fps / ms / spp,
    ``src/NGLScene.cpp:324-342``).
    """

    renderer: Renderer
    target_spp: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # passes between checkpoints; 0 = off
    on_pass: Optional[Callable[[int, int], None]] = None  # (pass_idx, spp)
    metrics_path: Optional[str] = None  # JSONL event log (SURVEY §5.5)

    def _metrics(self):
        if not hasattr(self, "_metrics_logger"):
            from vrenderer_pathtracer.utils.metrics import MetricsLogger

            self._metrics_logger = (
                MetricsLogger(self.metrics_path) if self.metrics_path
                else None)
        return self._metrics_logger

    def resume_if_possible(self) -> bool:
        """Restore the latest checkpoint if one exists.

        Failure recovery (SURVEY §5.3): a corrupt or half-written
        checkpoint — the realistic preemption artifact — must not take the
        job down with it.  Restore errors are logged and the render starts
        fresh instead of crashing.
        """
        if not self.checkpoint_dir:
            return False
        path = pathlib.Path(self.checkpoint_dir) / "latest"
        if not path.exists():
            return False
        try:
            restore_checkpoint(self.renderer, path)
        except Exception as e:  # corrupt/partial checkpoint -> fresh start
            import sys

            msg = f"{type(e).__name__}: {e}"
            if self._metrics():
                self._metrics().log("resume_failed", path=str(path),
                                    error=msg)
            print(f"checkpoint restore failed ({msg}); starting fresh",
                  file=sys.stderr)
            return False
        if self._metrics():
            self._metrics().log("resumed", path=str(path),
                                frame=self.renderer.frame,
                                spp=self.renderer.samples_per_pixel)
        return True

    def run(self):
        """Render until target_spp; returns (image01, depth)."""
        import time

        r = self.renderer
        met = self._metrics()
        img = depth = None
        i = 0
        while r.samples_per_pixel < self.target_spp:
            t0 = time.perf_counter()
            img, depth = r.render()
            i += 1
            if met or self.on_pass:
                # Block first so wall-clock reads (metrics and the callback)
                # are honest: dispatch is async, and unblocked prints
                # report near-zero pass times.
                jax.block_until_ready(img)
            if met:
                dt = time.perf_counter() - t0
                rays = (r.settings.n_pixels * r.settings.samples_per_pass
                        * r.settings.bounces)
                met.log("pass", idx=i, spp=r.samples_per_pixel,
                        ms=round(dt * 1e3, 3),
                        mrays_per_s=round(rays / dt / 1e6, 5))
            if self.on_pass:
                self.on_pass(i, r.samples_per_pixel)
            if (
                self.checkpoint_dir
                and self.checkpoint_every
                and i % self.checkpoint_every == 0
            ):
                jax.block_until_ready(r._accum)
                save_checkpoint(r, pathlib.Path(self.checkpoint_dir) / "latest")
                if met:
                    met.log("checkpoint", spp=r.samples_per_pixel)
        if img is None:
            # Already at/past target (e.g. restored): display the existing
            # accumulation without advancing a pass beyond the requested
            # sample count.
            img, depth = r.current_frame()
        if met:
            met.log("done", spp=r.samples_per_pixel)
        return np.asarray(img), np.asarray(depth)
