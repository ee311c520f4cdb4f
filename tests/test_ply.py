"""PLY loader: ascii + binary_little_endian round-trips vs the OBJ path.

The reference imports obj/ply/fbx through Assimp into one pipeline
(``src/MeshLoader.cpp:19``); here the PLY reader must produce the same
HostMesh as the OBJ reader for identical geometry (same recentering,
v-flip, smooth normals and tangent conventions).
"""

import struct

import numpy as np
import pytest

from vrenderer_pathtracer.native import load_mesh_file, load_obj, load_ply
from tests.test_mesh_render import write_uv_sphere


def _sphere_arrays(n_theta=6, n_phi=8, radius=5.0):
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
    return np.array(verts, np.float32), np.array(uvs, np.float32), faces


def _write_ply_ascii(path, verts, uvs, faces):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment test sphere\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float u\nproperty float v\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v, uv in zip(verts, uvs):
            # Same %.6f precision as write_uv_sphere's OBJ output, so the
            # parsed coordinates are bitwise identical across formats.
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                    f"{uv[0]:.6f} {uv[1]:.6f}\n")
        for a, b, c in faces:
            f.write(f"3 {a} {b} {c}\n")


def _write_ply_binary(path, verts, uvs, faces):
    with open(path, "wb") as f:
        hdr = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float u\nproperty float v\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        )
        f.write(hdr.encode())
        for v, uv in zip(verts, uvs):
            f.write(struct.pack("<5f", v[0], v[1], v[2], uv[0], uv[1]))
        for a, b, c in faces:
            f.write(struct.pack("<B3i", 3, a, b, c))


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    d = tmp_path_factory.mktemp("ply")
    verts, uvs, faces = _sphere_arrays()
    # Quantize to the %.6f text precision used by all three writers so the
    # parsed geometry is bitwise identical across formats.
    verts = np.array([[float(f"{c:.6f}") for c in v] for v in verts],
                     np.float32)
    uvs = np.array([[float(f"{c:.6f}") for c in u] for u in uvs], np.float32)
    pa = d / "sphere_ascii.ply"
    pb = d / "sphere_bin.ply"
    po = d / "sphere.obj"
    _write_ply_ascii(pa, verts, uvs, faces)
    _write_ply_binary(pb, verts, uvs, faces)
    write_uv_sphere(po, radius=5.0, n_theta=6, n_phi=8)
    return str(pa), str(pb), str(po)


def test_ascii_binary_identical(sphere):
    pa, pb, _ = sphere
    ma = load_ply(pa)
    mb = load_ply(pb)
    for fa, fb in zip(ma, mb):
        np.testing.assert_array_equal(fa, fb)


def test_ply_matches_obj_pipeline(sphere):
    pa, _, po = sphere
    mp = load_ply(pa)
    mo = load_obj(po)
    assert mp.tris.shape == mo.tris.shape

    # Vertex INDEXING may differ (the OBJ path dedups referenced corners,
    # dropping unreferenced grid vertices), so compare per-triangle corner
    # data in a canonical order.
    def corner_table(m):
        rows = np.concatenate([
            m.verts[m.tris],     # [T,3,3]
            m.normals[m.tris],
            m.tangents[m.tris],
            m.uvs[m.tris],       # [T,3,2]
        ], axis=-1).reshape(len(m.tris), -1)
        order = np.lexsort(rows.T[::-1])
        return rows[order]

    np.testing.assert_allclose(
        corner_table(mp), corner_table(mo), atol=1e-5)


def test_dispatch_and_errors(sphere, tmp_path):
    pa, _, po = sphere
    assert load_mesh_file(pa).tris.shape == load_mesh_file(po).tris.shape
    with pytest.raises(IOError, match="cannot open"):
        load_mesh_file(tmp_path / "x.fbx")  # dispatches to load_fbx
    with pytest.raises(IOError, match="unknown mesh format"):
        load_mesh_file(tmp_path / "x.stl")
    bad = tmp_path / "bad.ply"
    bad.write_text("ply\nformat binary_big_endian 1.0\nend_header\n")
    with pytest.raises(IOError, match="unsupported PLY"):
        load_ply(bad)
    with pytest.raises(IOError, match="cannot open"):
        load_ply(tmp_path / "missing.ply")


def test_renderer_loads_ply(sphere):
    from vrenderer_pathtracer import Renderer, RenderSettings

    pa, _, _ = sphere
    r = Renderer(32, 32, settings=RenderSettings(
        use_cornell_box=True, has_hdr=False, samples_per_pass=1, bounces=2))
    r.load_mesh(pa)
    assert r.settings.has_mesh
    img, _ = r.render_frames(1)
    assert np.isfinite(img).all()
