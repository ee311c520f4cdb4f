"""Wavefront path integrator: the re-design of the reference megakernel.

The reference traces each pixel in one divergent megakernel
(``trace`` at ``cuda/src/PathTracer.cu:597-770``).  Here we run *wavefront
passes over flat ray batches* instead — every bounce is one vectorized step
over ``[B]`` SoA arrays (origins, directions, throughput, radiance), with
terminated lanes masked by ``jnp.where``.  The bounce budget is static
(reference: literal 4), so the loop unrolls and XLA fuses each bounce into a
handful of elementwise kernels.

Estimator parity (constants from the reference, re-derived not copied):

* miss -> HDRI: ``accum += mask * 2 * hdr[latlong]`` (``:632-647``); in
  Cornell mode a miss returns pure black, *discarding* prior emission
  (``:649-652``) — replicated faithfully.
* depth = ``|origin - hit| / 150`` at the first bounce (``:656-661``).
* ``accum += mask * emission`` then material scatter (see ops/shading.py).

Differentiability: the whole function is pure JAX, so ``jax.grad`` flows from
radiance back to camera, sphere albedos/emissions, Fresnel parameters,
textures, the MERL table and the environment map.  Discrete events (hit
selection, Fresnel branch) follow the detached-sampling convention.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vrenderer_pathtracer.config import RenderSettings
from vrenderer_pathtracer.core import rng
from vrenderer_pathtracer.ops import texture as tex_ops
from vrenderer_pathtracer.ops.envmap import sample_env_bilinear, sample_env_nearest
from vrenderer_pathtracer.ops.intersect import INF, intersect_spheres
from vrenderer_pathtracer.ops.shading import ORIGIN_OFFSET, scatter
from vrenderer_pathtracer.scene.scene import Scene
from vrenderer_pathtracer.scene.spheres import BRDF, DIFF
from vrenderer_pathtracer.scene.spheres import EXAMPLE_SPHERE_POS, EXAMPLE_SPHERE_RADIUS


class HitData(NamedTuple):
    """SoA hit record, one entry per ray lane (reference ``vHitData``)."""

    hit: jnp.ndarray        # [B] bool
    t: jnp.ndarray          # [B]
    point: jnp.ndarray      # [B,3]
    normal: jnp.ndarray     # [B,3]
    tangent: jnp.ndarray    # [B,3]
    color: jnp.ndarray      # [B,3]
    spec_color: jnp.ndarray # [B,3]
    emission: jnp.ndarray   # [B,3]
    hit_type: jnp.ndarray   # [B] int32


def _norm(x):
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-20)


def _intersect_sphere_set(scene: Scene, ray_o, ray_d):
    """Nearest analytic-sphere hit per lane.

    Unrolled running-min over the (static, tiny) sphere list instead of a
    materialized [B,N] distance matrix: every step is [B]-wide elementwise
    math XLA fuses into one pass, with no [B,N] intermediate in device
    memory.  Strict ``<`` keeps the reference's tie-break
    (earlier sphere wins, ``cuda/src/PathTracer.cu:149-190``).
    """
    s = scene.spheres
    n = s.count
    b = ray_o.shape[0]

    best_t = jnp.full((b,), INF, jnp.float32)
    best_pos = jnp.zeros((b, 3), jnp.float32)
    color = jnp.zeros((b, 3), jnp.float32)
    spec = jnp.zeros((b, 3), jnp.float32)
    emission = jnp.zeros((b, 3), jnp.float32)
    refl = jnp.zeros((b,), jnp.int32)
    for i in range(n):
        dist = intersect_spheres(ray_o, ray_d, s.pos[i][None, :], s.radius[i][None])[:, 0]
        closer = dist < best_t
        c3 = closer[:, None]
        best_t = jnp.where(closer, dist, best_t)
        best_pos = jnp.where(c3, s.pos[i][None, :], best_pos)
        color = jnp.where(c3, s.color[i][None, :], color)
        spec = jnp.where(c3, s.spec_color[i][None, :], spec)
        emission = jnp.where(c3, s.emission[i][None, :], emission)
        refl = jnp.where(closer, s.refl[i], refl)

    hit = best_t < INF
    # Miss lanes carry t=INF; computing the (masked-out) hit point with it
    # overflows |point|^2 to inf and 0*NaN then poisons jnp.where's backward
    # (the standard where-gradient leak).  Clamp t on dead lanes — forward
    # results are unchanged (all consumers mask by `hit`).
    t_safe = jnp.where(hit, best_t, 0.0)
    point = ray_o + ray_d * t_safe[:, None]
    normal = _norm(point - best_pos)
    return HitData(
        hit=hit,
        t=best_t,
        point=point,
        normal=normal,
        tangent=jnp.zeros_like(normal),
        color=color,
        spec_color=spec,
        emission=emission,
        hit_type=refl,
    )


def _example_sphere_hit(scene: Scene, settings: RenderSettings, ray_o, ray_d, prev: HitData):
    """Example-sphere intersection with texture/normal-map shading.

    Reference ``cuda/src/PathTracer.cu:192-268``.  Deliberate divergence
    (SURVEY §7 "reference bugs not to replicate"): UVs are computed from the
    *fresh* surface normal; the reference reads a stale normal (``:202-204``).
    The spherical tangent estimate (``:232-235``) is reproduced as-is and also
    used as the BRDF tangent (uninitialised/UB in the reference).
    """
    pos = jnp.array(EXAMPLE_SPHERE_POS, jnp.float32)
    r = jnp.float32(EXAMPLE_SPHERE_RADIUS)
    dist = intersect_spheres(ray_o, ray_d, pos[None, :], r[None])[:, 0]
    closer = (dist < prev.t)

    dist_safe = jnp.where(dist < INF, dist, 0.0)  # see sphere-set note
    point = ray_o + ray_d * dist_safe[:, None]
    normal = _norm(point - pos[None, :])
    u = jnp.arctan2(normal[:, 0], normal[:, 2]) / (2.0 * jnp.pi) + 0.5
    v = normal[:, 1] * 0.5 + 0.5

    use_tex = not settings.use_brdf
    # One combined gather for all maps at this uv (see shade_mesh_hit).
    texd, texn, texs = tex_ops.fetch_maps(
        [scene.diffuse_map if settings.has_diffuse_map and use_tex else None,
         scene.normal_map if settings.has_normal_map else None,
         scene.specular_map if settings.has_specular_map and use_tex
         else None],
        u, v, settings.texture_filter)
    color = texd if texd is not None else jnp.ones_like(point)

    # Spherical tangent estimate (reference's formula, kept for parity).
    pr = jnp.maximum(jnp.linalg.norm(point, axis=-1), 1e-12)
    theta = jnp.arccos(jnp.clip(point[:, 2] / pr, -1.0, 1.0))
    phi = jnp.arctan2(point[:, 1], point[:, 0])
    tangent = jnp.stack(
        [jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi), jnp.cos(theta)],
        axis=-1,
    )

    if settings.has_normal_map:
        n_ts = tex_ops.decode_normal_map(texn)
        normal = tex_ops.apply_tbn(normal, tangent, n_ts)

    spec = texs if texs is not None else jnp.zeros_like(point)

    hit_type = jnp.full(dist.shape, BRDF if settings.use_brdf else DIFF, jnp.int32)

    def sel3(a, b):
        return jnp.where(closer[:, None], a, b)

    return HitData(
        hit=prev.hit | closer,
        t=jnp.where(closer, dist, prev.t),
        point=sel3(point, prev.point),
        normal=sel3(normal, prev.normal),
        tangent=sel3(tangent, prev.tangent),
        color=sel3(color, prev.color),
        spec_color=sel3(spec, prev.spec_color),
        emission=sel3(jnp.zeros_like(point), prev.emission),
        hit_type=jnp.where(closer, hit_type, prev.hit_type),
    )


def intersect_scene(scene: Scene, settings: RenderSettings, ray_o, ray_d,
                    alive=None) -> HitData:
    """Scene intersection in the reference's priority order
    (``cuda/src/PathTracer.cu:136-468``): cornell+analytic spheres, then the
    example sphere *or* the mesh, later hits winning only if strictly closer.

    ``alive`` ([B] bool, optional): lanes already terminated.  Their hit
    record is masked out by every consumer, but without a hint they would
    still RE-TRAVERSE their stale ray at full miss cost every remaining
    bounce.  Dead lanes get a zero search bound instead, which the Triton
    kernel skips at once, while live-lane results stay bit-identical.
    """
    hd = _intersect_sphere_set(scene, ray_o, ray_d)
    if settings.use_example_sphere:
        hd = _example_sphere_hit(scene, settings, ray_o, ray_d, hd)
    elif settings.has_mesh:
        from vrenderer_pathtracer.accel.traverse import mesh_hit

        if alive is not None:
            hd = hd._replace(t=jnp.where(alive, hd.t, 0.0))
        hd = mesh_hit(scene, settings, ray_o, ray_d, hd)
    return hd


def radiance(
    scene: Scene,
    settings: RenderSettings,
    ray_o,
    ray_d,
    pixel_ids,
    sample_ids,
    frame,
    fresnel_coef,
    fresnel_pow,
    seed: int = 0,
):
    """Trace a ray batch for ``settings.bounces`` bounces.

    Returns ``(rgb [B,3], depth [B])`` — the per-sample radiance estimate and
    the reference's normalized first-hit depth.
    """
    import functools

    n_rays = ray_o.shape[0]
    # Lobe importance sampler for measured BRDFs (opt-in): built once per
    # pass from the detached table — 90 numbers, CSE'd across bounces.
    brdf_sampler = None
    if settings.brdf_importance_sampling and settings.has_brdf \
            and scene.brdf is not None:
        from vrenderer_pathtracer.ops.brdf_sampling import build_merl_sampler

        brdf_sampler = build_merl_sampler(scene.brdf)
    mask = jnp.ones((n_rays, 3), jnp.float32)
    accum = jnp.zeros((n_rays, 3), jnp.float32)
    depth = jnp.ones((n_rays,), jnp.float32)
    alive = jnp.ones((n_rays,), bool)
    killed = jnp.zeros((n_rays,), bool)  # Cornell-mode miss kills the path
    # Env-fetch collapse: a path misses at most once, so the per-bounce
    # HDRI gathers fold into ONE fetch after the loop — (weight-at-miss,
    # dir-at-miss) ride the carry: one gather per path instead of one per
    # bounce, with identical estimator values.
    use_env = (not settings.use_cornell_box and settings.has_hdr
               and scene.hdr is not None)
    env_w = jnp.zeros((n_rays, 3), jnp.float32)
    env_dir = ray_d

    def bounce_step(carry, *, bounce, hd=None):
        ray_o, ray_d, mask, accum, depth, alive, killed, env_w, env_dir = carry
        if hd is None:
            hd = intersect_scene(
                scene, settings, ray_o, ray_d,
                alive=None if bounce == 0 else alive)
        miss = alive & ~hd.hit
        live_hit = alive & hd.hit

        if settings.use_cornell_box:
            killed = killed | miss
        elif use_env:
            env_w = env_w + jnp.where(miss[:, None], mask, 0.0)
            env_dir = jnp.where(miss[:, None], ray_d, env_dir)

        if bounce == 0:
            d0 = jnp.linalg.norm(ray_o - hd.point, axis=-1) / settings.depth_scale
            depth = jnp.where(live_hit, d0, depth)

        accum = accum + jnp.where(live_hit[:, None], mask * hd.emission, 0.0)

        u_reflect, _ = rng.uniform2(seed, pixel_ids, rng.make_stream(frame, sample_ids, bounce, 0))
        u_phi, u_r = rng.uniform2(seed, pixel_ids, rng.make_stream(frame, sample_ids, bounce, 1))
        u_b1 = u_b2 = None
        if brdf_sampler is not None:
            u_b1, u_b2 = rng.uniform2(
                seed, pixel_ids, rng.make_stream(frame, sample_ids, bounce, 2))

        new_dir, mult = scatter(
            ray_d,
            hd.normal,
            hd.tangent,
            hd.color,
            hd.spec_color,
            hd.hit_type,
            u_reflect,
            u_phi,
            u_r,
            fresnel_coef,
            fresnel_pow,
            brdf_table=scene.brdf if settings.has_brdf else None,
            brdf_sampler=brdf_sampler,
            u_b1=u_b1,
            u_b2=u_b2,
        )

        lh = live_hit[:, None]
        ray_o = jnp.where(lh, hd.point + ORIGIN_OFFSET * hd.normal, ray_o)
        ray_d = jnp.where(lh, new_dir, ray_d)
        mask = jnp.where(lh, mask * mult, mask)
        return (ray_o, ray_d, mask, accum, depth, live_hit, killed,
                env_w, env_dir)

    def wrap(fn):
        if settings.remat_bounces:
            # Recompute this bounce's intermediates during the backward pass
            # instead of storing them: memory per bounce drops to the carry
            # (jax.checkpoint — the FLOPs-for-memory trade, SURVEY §7).
            return jax.checkpoint(fn)
        return fn

    cap = -(-int(n_rays * settings.compact_capacity_frac) // 1024) * 1024
    do_compact = (settings.compact_waves and settings.has_mesh
                  and not settings.use_example_sphere
                  and 0 < cap < n_rays)

    carry = (ray_o, ray_d, mask, accum, depth, alive, killed, env_w, env_dir)
    if not do_compact:
        for bounce in range(settings.bounces):
            carry = wrap(functools.partial(bounce_step, bounce=bounce))(carry)
        ray_o, ray_d, mask, accum, depth, alive, killed, env_w, env_dir = carry
    else:
        # --- compact shading + bounce tail --------------------------------
        # Only the primary TRAVERSAL needs full width; everything after it
        # only matters for lanes that hit something, yet the full-width path
        # pays every shading/RNG/scatter fusion and the bounce traversals at
        # width B.  Split at the traversal/shading boundary: detached mesh search at
        # full width, then gather the hit lanes into a dense [cap] array
        # and run bounce-0 shading AND the whole remaining tail at that
        # width.  Per-lane arithmetic is identical (same RNG streams via
        # gathered pixel/sample ids, same shade_mesh_hit recompute), so
        # results match the full path exactly; a lax.cond falls back to
        # the full-width chain when the hit count exceeds capacity.
        # Gathers use mode="fill" (filler index B -> zeros, alive=False)
        # and scatters mode="drop", so fillers can never alias a lane.
        from vrenderer_pathtracer.accel.traverse import (
            mesh_search, shade_mesh_hit)

        hd_sph = _intersect_sphere_set(scene, ray_o, ray_d)
        slot0, _t0 = mesh_search(scene, settings, ray_o, ray_d, hd_sph.t)
        hit_full = hd_sph.hit | (slot0 >= 0)

        def chain_compact(op, start=0):
            """Run bounces ``start..bounces-1`` at compact width.  At
            start=0 the mesh slots are already searched (full width) and
            bounce 0 shades from them; at start>=1 the live set is the
            carry's ``alive`` and depth is already final."""
            (ray_o, ray_d, mask, accum, depth, alive, killed, env_w,
             env_dir), slot0 = op
            sel = hit_full if start == 0 else alive
            if start == 0:
                # Bounce-0 misses stay full-width (cheap where-ops): env
                # weight/direction capture and the cornell kill.
                miss0 = ~hit_full
                if settings.use_cornell_box:
                    killed = killed | miss0
                elif use_env:
                    env_w = env_w + jnp.where(miss0[:, None], mask, 0.0)
                    env_dir = jnp.where(miss0[:, None], ray_d, env_dir)

            idx = jnp.nonzero(sel, size=cap, fill_value=n_rays)[0]

            def g(a, fill=0):
                return a.at[idx].get(mode="fill", fill_value=fill)

            o_c, d_c, mask_c = g(ray_o), g(ray_d), g(mask)
            alive_c = g(sel, fill=False)
            pix_c = g(pixel_ids)
            samp_c = g(sample_ids)
            slot_c = g(slot0, fill=-1) if start == 0 else None

            # Contributions accumulate COMPACTLY across the tail (radiance,
            # env weight/dir, cornell kill — all per-lane) and scatter into
            # the full-width arrays ONCE at the end: a full-width scatter
            # costs a [B]-array copy.
            acc_c = jnp.zeros((cap, 3), jnp.float32)
            envw_c = jnp.zeros((cap, 3), jnp.float32)
            envdir_c = d_c
            kill_c = jnp.zeros((cap,), bool)
            depth_c = jnp.ones((cap,), jnp.float32)

            def cstep(cc, *, bounce):
                (o_c, d_c, mask_c, alive_c, acc_c, envw_c, envdir_c,
                 kill_c, depth_c) = cc
                if bounce == 0:
                    # Primary hits were already found at full width; shade
                    # from the gathered winning slots (sphere prev is an
                    # exact recompute — same function, same inputs).
                    prev_c = _intersect_sphere_set(scene, o_c, d_c)
                    hd = shade_mesh_hit(scene, settings, o_c, d_c, slot_c,
                                        prev_c)
                else:
                    hd = intersect_scene(
                        scene, settings, o_c, d_c, alive=alive_c)
                miss = alive_c & ~hd.hit
                live_hit = alive_c & hd.hit
                if bounce == 0:
                    d0 = (jnp.linalg.norm(o_c - hd.point, axis=-1)
                          / settings.depth_scale)
                    depth_c = jnp.where(live_hit, d0, depth_c)
                if settings.use_cornell_box:
                    kill_c = kill_c | miss
                elif use_env:
                    envw_c = envw_c + jnp.where(miss[:, None], mask_c, 0.0)
                    envdir_c = jnp.where(miss[:, None], d_c, envdir_c)
                acc_c = acc_c + jnp.where(
                    live_hit[:, None], mask_c * hd.emission, 0.0)

                u_reflect, _ = rng.uniform2(
                    seed, pix_c, rng.make_stream(frame, samp_c, bounce, 0))
                u_phi, u_r = rng.uniform2(
                    seed, pix_c, rng.make_stream(frame, samp_c, bounce, 1))
                u_b1 = u_b2 = None
                if brdf_sampler is not None:
                    u_b1, u_b2 = rng.uniform2(
                        seed, pix_c, rng.make_stream(frame, samp_c, bounce, 2))
                new_dir, mult = scatter(
                    d_c, hd.normal, hd.tangent, hd.color, hd.spec_color,
                    hd.hit_type, u_reflect, u_phi, u_r, fresnel_coef,
                    fresnel_pow,
                    brdf_table=scene.brdf if settings.has_brdf else None,
                    brdf_sampler=brdf_sampler, u_b1=u_b1, u_b2=u_b2)
                lh = live_hit[:, None]
                o_c = jnp.where(lh, hd.point + ORIGIN_OFFSET * hd.normal, o_c)
                d_c = jnp.where(lh, new_dir, d_c)
                mask_c = jnp.where(lh, mask_c * mult, mask_c)
                return (o_c, d_c, mask_c, live_hit, acc_c, envw_c, envdir_c,
                        kill_c, depth_c)

            cc = (o_c, d_c, mask_c, alive_c, acc_c, envw_c, envdir_c, kill_c,
                  depth_c)
            for b in range(start, settings.bounces):
                cc = wrap(functools.partial(cstep, bounce=b))(cc)
            acc_c, envw_c, envdir_c, kill_c, depth_c = cc[4:9]

            if use_env:
                # Tail lanes' env fetch happens compactly (a [cap]-row
                # gather instead of widening the full-width env arrays);
                # the full-width epilogue fetch still covers bounce-0
                # misses, whose env_w/env_dir are untouched here.
                env_fetch_c = (sample_env_bilinear
                               if settings.texture_filter == "bilinear"
                               else sample_env_nearest)
                missed_c = jnp.any(envw_c != 0.0, axis=-1, keepdims=True)
                acc_c = acc_c + jnp.where(
                    missed_c, envw_c * env_fetch_c(scene.hdr, envdir_c), 0.0)
            accum = accum.at[idx].add(acc_c, mode="drop")
            if start == 0:
                depth = depth.at[idx].set(depth_c, mode="drop")
            if settings.use_cornell_box:
                killed = killed.at[jnp.where(kill_c, idx, n_rays)].set(
                    True, mode="drop")
            return accum, depth, killed, env_w, env_dir

        def run_from(carry, b):
            """Compact-ladder dispatch: at each bounce boundary, compact
            the moment the live count fits ``cap`` (a scene whose primary
            hit rate exceeds capacity — e.g. a view-filling mesh — still
            compacts at the first bounce where enough paths have died);
            otherwise run this bounce full-width and try again."""
            if b == settings.bounces:
                return carry[3], carry[4], carry[6], carry[7], carry[8]
            if b == 0:
                def full0(op):
                    c, s0 = op
                    hd0 = shade_mesh_hit(scene, settings, c[0], c[1], s0,
                                         hd_sph)
                    c = wrap(functools.partial(
                        bounce_step, bounce=0, hd=hd0))(c)
                    return run_from(c, 1)

                if settings.compact_mode == "forced":
                    # Static specialization: the cond copies its branch
                    # operands, so once the renderer has MEASURED that this
                    # camera's primary hit count fits capacity — the hit
                    # set is exactly constant across progressive passes
                    # (fixed jitter) — it recompiles with the compact chain
                    # hard-wired (render/renderer.py adaptive switch).
                    return chain_compact((carry, slot0), start=0)
                return jax.lax.cond(
                    jnp.sum(hit_full) <= cap,
                    functools.partial(chain_compact, start=0),
                    full0, (carry, slot0))

            def fullb(op, b=b):
                c = wrap(functools.partial(bounce_step, bounce=b))(op[0])
                return run_from(c, b + 1)

            return jax.lax.cond(
                jnp.sum(carry[5]) <= cap,
                functools.partial(chain_compact, start=b),
                fullb, (carry, slot0))

        accum, depth, killed, env_w, env_dir = run_from(carry, 0)

    if use_env:
        env_fetch = (sample_env_bilinear
                     if settings.texture_filter == "bilinear"
                     else sample_env_nearest)
        # Guard the collapsed fetch: paths that never missed carry env_w=0
        # with env_dir = a stale direction; EXR HDR assets may legally hold
        # inf/NaN texels, and 0*inf would poison those paths (the
        # per-bounce form zeroed via where() before accumulating).
        ever_missed = jnp.any(env_w != 0.0, axis=-1, keepdims=True)
        accum = accum + jnp.where(
            ever_missed, env_w * env_fetch(scene.hdr, env_dir), 0.0)
    if settings.use_cornell_box:
        accum = jnp.where(killed[:, None], 0.0, accum)
        depth = jnp.where(killed, 0.0, depth)
    return accum, depth


def render_pass(
    scene: Scene,
    settings: RenderSettings,
    ray_o,
    ray_d,
    pixel_ids,
    frame,
    fresnel_coef,
    fresnel_pow,
    seed: int = 0,
    sample_offset=None,
):
    """One progressive pass: ``samples_per_pass`` estimates per pixel.

    Samples are batched into the lane dimension (B = N * S) so small frames
    still fill the device; reference equivalent is the ``kSamps`` loop at
    ``cuda/src/PathTracer.cu:839-855``.  Returns ``(rgb_mean [N,3], depth [N])``.

    ``sample_offset`` shifts the sample-id counter stream — used when the
    sample axis is sharded across devices so each draws disjoint RNG
    streams (parallel/sharding.py).
    """
    n = ray_o.shape[0]
    s = settings.samples_per_pass
    off = jnp.asarray(sample_offset, jnp.uint32) if sample_offset is not None \
        else jnp.uint32(0)

    # Memory control: trace `samples_per_chunk` sample batches at a time so
    # the lane dimension stays bounded at high spp (config-5 scale).  The
    # chunks are a true dependency-free sum, so this is pure peak-memory
    # shaping — results are identical to the single-chunk path.
    chunk = settings.samples_per_chunk or s
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"samples_per_pass={s} not divisible by chunk={chunk}")

    rgb_sum = jnp.zeros((n, 3), jnp.float32)
    depth = None
    for c0 in range(0, s, chunk):
        big_o = jnp.tile(ray_o, (chunk, 1))
        big_d = jnp.tile(ray_d, (chunk, 1))
        big_ids = jnp.tile(pixel_ids, (chunk,))
        base = jnp.arange(c0, c0 + chunk, dtype=jnp.uint32) + off
        sample_ids = jnp.repeat(base, n)
        rgb_c, depth_c = radiance(
            scene, settings, big_o, big_d, big_ids, sample_ids, frame,
            fresnel_coef, fresnel_pow, seed,
        )
        rgb_sum = rgb_sum + rgb_c.reshape(chunk, n, 3).sum(axis=0)
        depth = depth_c.reshape(chunk, n)[-1]  # same primary ray: last write
    return rgb_sum / s, depth
