"""Numerical sanitizers.

SURVEY §5.2: the reference ships no sanitizers (races are structural
non-issues there, and here too — JAX is functional).  What carries over is
the *discipline*: NaN/Inf guards on the shading path via ``checkify``.
"""

from __future__ import annotations

import functools

import jax
from jax.experimental import checkify


def checked(fn, *, errors=checkify.float_checks):
    """Wrap a jittable function with NaN/Inf checking.

    Returns ``wrapped(*args) -> out`` that RAISES on the first NaN/Inf/OOB
    produced anywhere inside ``fn`` (device-side checks, host-side throw).
    Debug tool — the checks serialize some fusion, so never leave it on a
    hot path.

        step = checked(render_pass)
        rgb, depth = step(scene, settings, ...)
    """
    cfn = checkify.checkify(fn, errors=errors)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        err, out = cfn(*args, **kw)
        checkify.check_error(err)
        return out

    return wrapped


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finite check over a pytree (post-hoc debugging)."""
    import numpy as np

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = (~np.isfinite(arr)).sum()
            raise AssertionError(
                f"{name}{jax.tree_util.keystr(path)}: {bad} non-finite values"
            )
