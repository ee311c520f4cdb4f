from vrenderer_pathtracer.utils.profiling import (
    RenderStats,
    measure_renderer,
    profiler_trace,
    timeit,
)

__all__ = ["RenderStats", "measure_renderer", "profiler_trace", "timeit"]

from vrenderer_pathtracer.utils.debug import (  # noqa: E402
    assert_finite_tree,
    checked,
)

__all__ += ["assert_finite_tree", "checked"]
