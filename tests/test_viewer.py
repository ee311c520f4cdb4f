"""Terminal viewer: display loop, key handling, CLI integration.

The reference's interactive affordances (NGLScene 0-ms repaint, mouse
orbit/dolly, Return channel toggle, HUD) re-expressed — exercised headless
through an in-memory stream.
"""

import io

import numpy as np

from vrenderer_pathtracer import Renderer, RenderSettings
from vrenderer_pathtracer.view import TerminalViewer

SETTINGS = RenderSettings(
    use_cornell_box=True, has_hdr=False, samples_per_pass=1, bounces=2)


def _viewer(w=16, h=16):
    r = Renderer(w, h, settings=SETTINGS)
    out = io.StringIO()
    return TerminalViewer(r, out=out, max_cols=24, max_rows=10), r, out


def test_headless_loop_draws_frames():
    v, r, out = _viewer()
    v.run(max_passes=3, interactive=False)
    assert r.get_frame_count() == 4  # 3 passes
    text = out.getvalue()
    assert "\x1b[38;2;" in text and "▀" in text  # truecolor half-blocks
    assert "spp" in text  # HUD line
    assert "3 spp" in text.split("\n")[-2] or "spp" in text


def test_orbit_keys_restart_accumulation():
    v, r, out = _viewer()
    v.step()
    assert r.get_frame_count() == 2
    yaw0 = float(r.camera.yaw)
    v.step(keys=["right"])
    # Camera moved by the reference drag constant * ORBIT_PX px and the
    # progressive state restarted (clearBuffer semantics).
    from vrenderer_pathtracer.view import ORBIT_PX

    assert np.isclose(float(r.camera.yaw) - yaw0,
                      r.camera.DRAG_RAD_PER_PX * ORBIT_PX)
    assert r.get_frame_count() == 2  # cleared to 1, then one pass

    origin0 = np.asarray(r.camera.origin)
    v.step(keys=["w"])
    assert not np.allclose(np.asarray(r.camera.origin), origin0)


def test_depth_toggle_and_quit():
    v, r, out = _viewer()
    v.step(keys=["enter"])
    assert v.show_depth
    hud = v.hud()
    assert "depth" in hud
    v.step(keys=["enter"])
    assert not v.show_depth
    v.step(keys=["q"])
    assert v.quit


def test_fresnel_keys_update_sliders():
    v, r, _ = _viewer()
    c0 = float(r.fresnel_coef)
    v.handle_key("]")
    assert float(r.fresnel_coef) > c0
    v.handle_key("[")
    assert np.isclose(float(r.fresnel_coef), c0)
    p0 = float(r.fresnel_pow)
    v.handle_key("'")
    assert float(r.fresnel_pow) > p0


def test_cli_view_headless(capsys):
    from vrenderer_pathtracer.cli import main

    rc = main([
        "view", "--cornell", "--width", "16", "--height", "16",
        "--samples-per-pass", "1", "--bounces", "2",
        "--passes", "2", "--headless", "--cpu",
        "--cols", "20", "--rows", "8",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "▀" in out and "spp" in out


def test_mouse_drag_orbits_with_reference_constant():
    """SGR mouse drags map to the reference's drag semantics
    (src/NGLSceneMouseControls.cpp): LMB yaw(-diffx*rad/px) /
    pitch(diffy*rad/px), RMB moveForward(diffY); release ends the drag."""
    from vrenderer_pathtracer.view import CELL_PX_X, CELL_PX_Y, TerminalViewer

    v, r, _ = _viewer()
    ev = TerminalViewer._parse_sgr_mouse("32;10;5M")   # motion, LMB held
    assert ev == ("mouse", 0, 10, 5, True)
    assert TerminalViewer._parse_sgr_mouse("0;3;4m") == ("mouse", 0, 3, 4, False)
    assert TerminalViewer._parse_sgr_mouse("garbage") is None

    yaw0, pitch0 = float(r.camera.yaw), float(r.camera.pitch)
    v.handle_key(("mouse", 0, 10, 5, True))     # press: anchors, no motion
    assert float(r.camera.yaw) == yaw0
    v.handle_key(("mouse", 0, 13, 7, True))     # drag +3 cols, +2 rows
    s = r.camera.DRAG_RAD_PER_PX
    np.testing.assert_allclose(float(r.camera.yaw),
                               yaw0 - 3 * CELL_PX_X * s, rtol=1e-6)
    np.testing.assert_allclose(float(r.camera.pitch),
                               pitch0 + 2 * CELL_PX_Y * s, rtol=1e-6)
    assert r.frame == 1                          # camera edits clear accum

    v.handle_key(("mouse", 0, 13, 7, False))    # release
    yaw1 = float(r.camera.yaw)
    v.handle_key(("mouse", 0, 20, 9, True))     # new press: no jump
    assert float(r.camera.yaw) == yaw1

    z0 = float(r.camera.origin[2])
    v.handle_key(("mouse", 2, 5, 5, True))      # RMB press
    v.handle_key(("mouse", 2, 5, 8, True))      # drag down 3 rows
    assert float(r.camera.origin[2]) != z0      # dollied along view dir
