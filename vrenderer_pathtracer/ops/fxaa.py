"""FXAA 3.11 post-process (PC quality path) as a JAX image pass.

Re-implementation of the algorithm the reference applies as a GLSL screen
pass (``shaders/screenQuadFXAA.frag``, NVIDIA FXAA 3.11): quality preset 29
(12 search steps 1, 1.5, 2x8, 4, 8 — ``screenQuadFXAA.frag:601-615``),
green-as-luma (``:6``), UI defaults subpix quality 0.75 / edge threshold
0.166 (``src/NGLScene.cpp:42-44``).  The reference's "sharpness" slider only
feeds the console path, which the PC shader ignores — kept out here.

Every pixel runs the full algorithm with masked lanes (no early-exit
branches).  GATHER-FREE BY CONSTRUCTION: a lane only advances along the
edge while it has advanced at every previous step (``done`` is monotone),
so the live sample at search step k sits at the STATIC cumulative offset
c_k = sum(steps[:k+1]) — every texture fetch in the algorithm is therefore
a static integer shift (pad+slice, clamp-to-edge) of the whole image, with
the ±half-texel bilinear parts expressed as averages of two shifts and the
horizontal/vertical variants merged by per-lane selects.  XLA fuses them
into a few elementwise passes with no gathers.  Differentiable like
everything else.
"""

from __future__ import annotations

import jax.numpy as jnp

QUALITY_STEPS = (1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0)
EDGE_THRESHOLD_MIN = 0.0833  # FXAA_QUALITY__EDGE_THRESHOLD_MIN default


def _shift2d(a, dy: int, dx: int):
    """Static integer shift with clamp-to-edge borders: out[y,x] =
    a[clip(y+dy), clip(x+dx)].  Pure pad+slice — no gather."""
    h, w = a.shape[0], a.shape[1]
    rest = ((0, 0),) * (a.ndim - 2)
    if dy > 0:
        a = jnp.pad(a, ((0, dy), (0, 0)) + rest, mode="edge")[dy:]
    elif dy < 0:
        a = jnp.pad(a, ((-dy, 0), (0, 0)) + rest, mode="edge")[:h]
    if dx > 0:
        a = jnp.pad(a, ((0, 0), (0, dx)) + rest, mode="edge")[:, dx:]
    elif dx < 0:
        a = jnp.pad(a, ((0, 0), (-dx, 0)) + rest, mode="edge")[:, :w]
    return a


def fxaa(
    img,
    subpix_quality: float = 0.75,
    edge_threshold: float = 0.166,
    edge_threshold_min: float = EDGE_THRESHOLD_MIN,
):
    """Antialias a display-space image.  img [H,W,3] in [0,1] -> [H,W,3]."""
    luma = img[..., 1]  # green as luma

    l_m = luma
    l_n = _shift2d(luma, -1, 0)
    l_s = _shift2d(luma, 1, 0)
    l_w = _shift2d(luma, 0, -1)
    l_e = _shift2d(luma, 0, 1)
    l_nw = _shift2d(luma, -1, -1)
    l_ne = _shift2d(luma, -1, 1)
    l_sw = _shift2d(luma, 1, -1)
    l_se = _shift2d(luma, 1, 1)

    range_max = jnp.maximum(l_m, jnp.maximum(jnp.maximum(l_n, l_s), jnp.maximum(l_w, l_e)))
    range_min = jnp.minimum(l_m, jnp.minimum(jnp.minimum(l_n, l_s), jnp.minimum(l_w, l_e)))
    lrange = range_max - range_min
    early_exit = lrange < jnp.maximum(edge_threshold_min, range_max * edge_threshold)

    # --- edge orientation --------------------------------------------------
    edge_horz = (
        jnp.abs(l_nw - 2 * l_w + l_sw)
        + 2 * jnp.abs(l_n - 2 * l_m + l_s)
        + jnp.abs(l_ne - 2 * l_e + l_se)
    )
    edge_vert = (
        jnp.abs(l_nw - 2 * l_n + l_ne)
        + 2 * jnp.abs(l_w - 2 * l_m + l_e)
        + jnp.abs(l_sw - 2 * l_s + l_se)
    )
    horz_span = edge_horz >= edge_vert

    luma1 = jnp.where(horz_span, l_n, l_w)   # candidates perpendicular to edge
    luma2 = jnp.where(horz_span, l_s, l_e)
    grad1 = jnp.abs(luma1 - l_m)
    grad2 = jnp.abs(luma2 - l_m)
    pair1 = grad1 >= grad2
    gradient_scaled = 0.25 * jnp.maximum(grad1, grad2)
    # Perpendicular step direction: -1 towards N/W, +1 towards S/E (texels).
    length_sign = jnp.where(pair1, -1.0, 1.0)
    luma_nn = jnp.where(pair1, luma1, luma2) + l_m
    luma_nn_half = luma_nn * 0.5

    # --- end-of-edge search --------------------------------------------------
    # Edge rows half a texel perpendicular from the pixel: avg of two shifts.
    perp_n = 0.5 * (luma + l_n)      # horz span, length_sign = -1
    perp_s = 0.5 * (luma + l_s)      # horz span, length_sign = +1
    perp_w = 0.5 * (luma + l_w)      # vert span, length_sign = -1
    perp_e = 0.5 * (luma + l_e)      # vert span, length_sign = +1

    def edge_luma(c: float, sign: int):
        """Edge-row luma at static offset sign*c along the span (per-lane
        orientation/perpendicular-direction resolved by selects)."""
        m = int(c)
        frac = c - m

        def along(pa, pb, axis):
            dy, dx = (0, sign * m) if axis == 0 else (sign * m, 0)
            va = _shift2d(pa, dy, dx)
            vb = _shift2d(pb, dy, dx)
            if frac:
                dy2, dx2 = (0, sign * (m + 1)) if axis == 0 else (sign * (m + 1), 0)
                va = 0.5 * (va + _shift2d(pa, dy2, dx2))
                vb = 0.5 * (vb + _shift2d(pb, dy2, dx2))
            return jnp.where(pair1, va, vb)

        return jnp.where(horz_span, along(perp_n, perp_s, 0),
                         along(perp_w, perp_e, 1))

    cum = QUALITY_STEPS[0]
    end_n = edge_luma(cum, -1) - luma_nn_half
    end_p = edge_luma(cum, +1) - luma_nn_half
    done_n = jnp.abs(end_n) >= gradient_scaled
    done_p = jnp.abs(end_p) >= gradient_scaled
    dst_n = jnp.full_like(luma, cum)
    dst_p = jnp.full_like(luma, cum)

    for step in QUALITY_STEPS[1:]:
        cum += step
        adv_n = ~done_n
        adv_p = ~done_p
        new_end_n = edge_luma(cum, -1) - luma_nn_half
        new_end_p = edge_luma(cum, +1) - luma_nn_half
        end_n = jnp.where(adv_n, new_end_n, end_n)
        end_p = jnp.where(adv_p, new_end_p, end_p)
        dst_n = jnp.where(adv_n, cum, dst_n)
        dst_p = jnp.where(adv_p, cum, dst_p)
        done_n = done_n | (jnp.abs(end_n) >= gradient_scaled)
        done_p = done_p | (jnp.abs(end_p) >= gradient_scaled)

    direction_n = dst_n < dst_p
    dst = jnp.minimum(dst_n, dst_p)
    span_length = dst_p + dst_n

    luma_m_lt = (l_m - luma_nn_half) < 0.0
    good_span_n = (end_n < 0.0) != luma_m_lt
    good_span_p = (end_p < 0.0) != luma_m_lt
    good_span = jnp.where(direction_n, good_span_n, good_span_p)
    pixel_offset = -dst / jnp.maximum(span_length, 1e-6) + 0.5
    pixel_offset_good = jnp.where(good_span, pixel_offset, 0.0)

    # --- sub-pixel aliasing removal ---------------------------------------
    subpix_a = 2.0 * (l_n + l_s + l_w + l_e) + (l_nw + l_sw + l_ne + l_se)
    subpix_b = subpix_a * (1.0 / 12.0) - l_m
    subpix_c = jnp.clip(jnp.abs(subpix_b) / jnp.maximum(lrange, 1e-6), 0.0, 1.0)
    subpix_d = -2.0 * subpix_c + 3.0
    subpix_f = subpix_d * subpix_c * subpix_c
    subpix_h = subpix_f * subpix_f * subpix_quality

    # --- final resample: fractional offset o perpendicular to the edge.
    # Bilinear at (center + o) is the hat-weighted sum of the -1/0/+1
    # shifted images (weight of shift k is max(0, 1-|o-k|)) — per-lane
    # WEIGHTS, static SHIFTS.  |o| <= max(0.5, subpix_quality) < 1, so
    # three taps cover every case.
    offset = jnp.maximum(pixel_offset_good, subpix_h) * length_sign
    u = offset[..., None]

    def hat(k):
        return jnp.maximum(0.0, 1.0 - jnp.abs(u - k))

    w_m1, w_0, w_p1 = hat(-1.0), hat(0.0), hat(1.0)
    row_mix = (_shift2d(img, -1, 0) * w_m1 + img * w_0
               + _shift2d(img, 1, 0) * w_p1)
    col_mix = (_shift2d(img, 0, -1) * w_m1 + img * w_0
               + _shift2d(img, 0, 1) * w_p1)
    filtered = jnp.where(horz_span[..., None], row_mix, col_mix)

    return jnp.where(early_exit[..., None], img, filtered)
