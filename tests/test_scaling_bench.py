"""Scaling harness (bench_scaling.py) runs on the virtual CPU mesh.

The BASELINE scaling-efficiency metric needs a harness that produces
rays/s-vs-device-count numbers; these tests run its worker in-process on
1 and 4 of the 8 virtual CPU devices (conftest) and check the records are
well-formed and the weak-scaling workload actually scales the pixel count.
"""

import pathlib
import sys

import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from bench_scaling import _worker  # noqa: E402


def test_worker_strong_1_and_4_devices():
    devs = jax.devices("cpu")
    r1 = _worker(1, "strong", False, 64, 64, 2, 2, 2, devices=devs)
    r4 = _worker(4, "strong", False, 64, 64, 2, 2, 2, devices=devs)
    for r in (r1, r4):
        assert r["pass_ms"] > 0 and r["mrays_per_s"] > 0
        assert r["height"] == 64  # strong: fixed global shape
    assert r1["n_devices"] == 1 and r4["n_devices"] == 4


def test_worker_weak_scales_pixels():
    devs = jax.devices("cpu")
    r2 = _worker(2, "weak", False, 64, 32, 2, 2, 2, devices=devs)
    assert r2["height"] == 64  # weak: height = base_h * n


def test_worker_train_step():
    devs = jax.devices("cpu")
    r = _worker(2, "strong", True, 64, 64, 2, 2, 2, devices=devs)
    assert r["train"] and r["pass_ms"] > 0
