"""Test configuration: pin computations to (virtual) CPU devices.

Tests run on the CPU (the suite is run with ``JAX_PLATFORMS=cpu``).
``XLA_FLAGS`` is extended *before* the CPU client is created so multi-device
tests get 8 virtual CPU devices (SURVEY §4.4: distributed tests without a
cluster).  Tests that need a GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when no GPU is present.
"""

import os

_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture(autouse=True)
def _on_cpu(request):
    if request.node.get_closest_marker("gpu"):
        yield
        return
    with jax.default_device(cpu_devices()[0]):
        yield


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when there is none (decided here, at
    run time, never while test modules are imported)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
    return devices[0]


@pytest.fixture
def kernel_in_interpreter(monkeypatch):
    """A function that, once called, routes the integrator's mesh search
    (accel/traverse.py ``nearest_hit``) to the Triton kernel in the Pallas
    interpreter for the rest of the test: how CPU tests reach the kernel
    through ``render_pass``."""

    def enable():
        import functools

        from vrenderer_pathtracer.accel import traverse, triton_traverse

        monkeypatch.setattr(
            traverse, "nearest_hit",
            functools.partial(triton_traverse.traverse_triton,
                              interpret=True))

    return enable
