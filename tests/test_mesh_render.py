"""End-to-end mesh rendering through the Renderer façade (config-3 shape).

Generates a procedural UV-sphere OBJ, loads it via the native loader + SBVH,
and renders it inside the Cornell box — checking the mesh is actually visible
(center depth closer than walls) and the image is finite and lit.
"""

import numpy as np
import pytest

from vrenderer_pathtracer import Renderer, RenderSettings


def write_uv_sphere(path, radius=12.0, n_theta=12, n_phi=18):
    verts, uvs, faces = [], [], []
    for i in range(n_theta + 1):
        theta = np.pi * i / n_theta
        for j in range(n_phi + 1):
            phi = 2 * np.pi * j / n_phi
            verts.append((
                radius * np.sin(theta) * np.cos(phi),
                radius * np.cos(theta),
                radius * np.sin(theta) * np.sin(phi),
            ))
            uvs.append((j / n_phi, 1 - i / n_theta))
    cols = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * cols + j
            b = a + 1
            c = a + cols
            d = c + 1
            if i > 0:
                faces.append((a, b, c))
            if i < n_theta - 1:
                faces.append((b, d, c))
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for u in uvs:
            f.write(f"vt {u[0]:.6f} {u[1]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a+1}/{a+1} {b+1}/{b+1} {c+1}/{c+1}\n")


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    p = tmp_path_factory.mktemp("mesh") / "sphere.obj"
    write_uv_sphere(p)
    return str(p)


def test_mesh_in_cornell(sphere_obj):
    r = Renderer(
        64, 64,
        settings=RenderSettings(
            use_cornell_box=True, has_hdr=False, samples_per_pass=2, bounces=2
        ),
    )
    r.load_mesh(sphere_obj)
    assert r.settings.has_mesh
    img, depth = r.render_frames(2)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # lit scene

    # Sphere (r=12 at origin) spans the image center; camera at z=150.
    # Its depth ~ (150-12)/150 = 0.92 < wall depth ~ (150+100)/150 = 1.0 (capped).
    center = depth[28:36, 28:36].mean()
    corner = depth[:6, :6].mean()
    assert center < corner - 0.05, (center, corner)


def test_mesh_progressive_noise_drops(sphere_obj):
    r = Renderer(
        32, 32,
        settings=RenderSettings(
            use_cornell_box=True, has_hdr=False, samples_per_pass=2, bounces=2
        ),
    )
    r.load_mesh(sphere_obj)
    img1, _ = r.render()
    imgs = [np.asarray(img1)]
    for _ in range(6):
        imgs.append(np.asarray(r.render()[0]))
    # Variance between consecutive progressive frames must shrink.
    d_early = np.abs(imgs[1] - imgs[0]).mean()
    d_late = np.abs(imgs[-1] - imgs[-2]).mean()
    assert d_late < d_early
