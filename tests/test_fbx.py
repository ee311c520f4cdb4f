"""Binary FBX import (native/csrc/fbx.cc).

The reference ingests FBX through Assimp (``/root/reference/src/MeshLoader.cpp:19``,
file dialog ``src/NGLScene.cpp:348``).  Fixtures are generated here with a
minimal binary-FBX writer covering both record layouts (32-bit pre-7500 and
64-bit 7500+), raw and zlib-deflated arrays, Direct and IndexToDirect
layers, and multi-geometry files (last mesh wins, reference parity).
"""

import struct
import zlib

import numpy as np
import pytest

from vrenderer_pathtracer.native import load_fbx, load_mesh_file


class _W:
    """Tiny binary-FBX node writer."""

    def __init__(self, version=7400):
        self.version = version
        self.big = version >= 7500

    def _prop_scalar(self, code, fmt, v):
        return code.encode() + struct.pack("<" + fmt, v)

    def p_str(self, s):
        b = s.encode()
        return b"S" + struct.pack("<I", len(b)) + b

    def p_long(self, v):
        return self._prop_scalar("L", "q", v)

    def p_int(self, v):
        return self._prop_scalar("I", "i", v)

    def p_arr(self, code, vals, compress=False):
        fmt = {"d": "d", "f": "f", "i": "i", "l": "q"}[code]
        raw = struct.pack("<%d%s" % (len(vals), fmt), *vals)
        if compress:
            data = zlib.compress(raw)
            enc = 1
        else:
            data = raw
            enc = 0
        return (code.encode() + struct.pack("<III", len(vals), enc, len(data))
                + data)

    def node(self, name, props=b"", children=b"", nprops=0):
        name_b = name.encode()
        if self.big:
            hdr = 25
            if children:
                children += b"\0" * 25
            body = props + children
            end_is_rel = len(body) + hdr + len(name_b)
            rec = struct.pack("<QQQB", 0, nprops, len(props), len(name_b))
        else:
            hdr = 13
            if children:
                children += b"\0" * 13
            body = props + children
            end_is_rel = len(body) + hdr + len(name_b)
            rec = struct.pack("<IIIB", 0, nprops, len(props), len(name_b))
        self._pending = (rec, name_b, body, end_is_rel)
        return self  # finalized by at()

    def emit(self, name, props=b"", children=b"", nprops=0, offset=0):
        """Serialize one node record given its absolute start offset."""
        name_b = name.encode()
        pad = b"\0" * (25 if self.big else 13)
        if children:
            children = children + pad
        hdr = 25 if self.big else 13
        end = offset + hdr + len(name_b) + len(props) + len(children)
        if self.big:
            rec = struct.pack("<QQQB", end, nprops, len(props), len(name_b))
        else:
            rec = struct.pack("<III B".replace(" ", ""), end, nprops,
                              len(props), len(name_b))
        return rec + name_b + props + children, end

    def file(self, top_nodes):
        """top_nodes: list of (name, props, nprops, children_builder) where
        children_builder(offset) -> bytes of already-emitted child records."""
        out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack(
            "<I", self.version)
        for build in top_nodes:
            blob, _ = build(len(out))
            out += blob
        out += b"\0" * (25 if self.big else 13)  # top-level terminator
        return out


def _geometry_blob(w, offset, verts, pvi, normals=None, nmap="ByPolygonVertex",
                   nref="Direct", uv=None, uvidx=None, compress=False,
                   name="Geometry"):
    """Emit a Geometry node (with its children) starting at `offset`."""
    hdr = 25 if w.big else 13

    props = w.p_long(1000) + w.p_str("Geometry::mesh") + w.p_str("Mesh")
    child_start = offset + hdr + len(name.encode()) + len(props)
    children = b""
    pos = child_start

    def child(nm, pr, np_, sub=b""):
        nonlocal children, pos
        blob, end = w.emit(nm, pr, sub, np_, pos)
        children += blob
        pos = end

    child("Vertices", w.p_arr("d", list(verts), compress), 1)
    child("PolygonVertexIndex", w.p_arr("i", list(pvi), compress), 1)
    if normals is not None:
        sub_start = None

        def layer_children(base):
            b1, e1 = w.emit("MappingInformationType", w.p_str(nmap),
                            nprops=1, offset=base)
            b2, e2 = w.emit("ReferenceInformationType", w.p_str(nref),
                            nprops=1, offset=e1)
            b3, e3 = w.emit("Normals", w.p_arr("d", list(normals), compress),
                            nprops=1, offset=e2)
            return b1 + b2 + b3

        pr = w.p_int(0)
        base = pos + hdr + len(b"LayerElementNormal") + len(pr)
        child("LayerElementNormal", pr, 1, layer_children(base))
    if uv is not None:
        pr = w.p_int(0)
        base = pos + hdr + len(b"LayerElementUV") + len(pr)
        b1, e1 = w.emit("MappingInformationType", w.p_str("ByPolygonVertex"),
                        nprops=1, offset=base)
        b2, e2 = w.emit("ReferenceInformationType", w.p_str("IndexToDirect"),
                        nprops=1, offset=e1)
        b3, e3 = w.emit("UV", w.p_arr("d", list(uv), compress),
                        nprops=1, offset=e2)
        b4, e4 = w.emit("UVIndex", w.p_arr("i", list(uvidx), compress),
                        nprops=1, offset=e3)
        child("LayerElementUV", pr, 1, b1 + b2 + b3 + b4)
    return w.emit(name, props, children, 3, offset)


def _write_quad_fbx(path, version=7400, compress=False, with_normals=True,
                    extra_first_mesh=False):
    """One quad in the xy plane, z=0, as a single 4-corner polygon."""
    w = _W(version)
    verts = [0, 0, 0, 2, 0, 0, 2, 2, 0, 0, 2, 0]
    pvi = [0, 1, 2, ~3]
    normals = [0, 0, 1] * 4 if with_normals else None
    uv = [0, 0, 1, 0, 1, 1, 0, 1]
    uvidx = [0, 1, 2, 3]

    def objects(offset):
        hdr = 25 if w.big else 13
        inner = offset + hdr + len(b"Objects")
        blobs = b""
        pos = inner
        if extra_first_mesh:
            # A decoy first mesh: a single triangle far away.  The loader
            # must keep the LAST geometry (reference parity).
            blob, pos = _geometry_blob(
                w, pos, [10, 10, 10, 11, 10, 10, 10, 11, 10], [0, 1, ~2])
            blobs += blob
        blob, pos = _geometry_blob(w, pos, verts, pvi, normals=normals,
                                   uv=uv, uvidx=uvidx, compress=compress)
        blobs += blob
        return w.emit("Objects", b"", blobs, 0, offset)

    data = w.file([objects])
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("version,compress", [(7400, False), (7500, True)])
def test_fbx_quad_roundtrip(tmp_path, version, compress):
    p = tmp_path / "quad.fbx"
    _write_quad_fbx(p, version=version, compress=compress)
    m = load_fbx(p)
    assert m.tris.shape == (2, 3)          # quad fan-triangulated
    assert m.verts.shape[0] == 4           # corners dedup to control points
    # Centroid recentering: quad center (1,1,0) removed.
    np.testing.assert_allclose(sorted(m.verts[:, 0]), [-1, -1, 1, 1])
    np.testing.assert_allclose(m.verts[:, 2], 0, atol=1e-6)
    # Authored normals survive.
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 4)
    # v-flip parity with the OBJ/PLY loaders (reference MeshLoader.cpp:74).
    uvs = {tuple(np.round(r, 5)) for r in m.uvs}
    assert uvs == {(0, 1), (1, 1), (1, 0), (0, 0)}
    # Tangents follow +u in the plane.
    np.testing.assert_allclose(np.abs(m.tangents[:, 0]), 1, atol=1e-5)


def test_fbx_smooth_normals_when_absent(tmp_path):
    p = tmp_path / "quad_nonorm.fbx"
    _write_quad_fbx(p, with_normals=False)
    m = load_fbx(p)
    # Planar quad -> generated smooth normals are the face normal.
    np.testing.assert_allclose(np.abs(m.normals[:, 2]), 1, atol=1e-5)


def test_fbx_last_mesh_wins(tmp_path):
    p = tmp_path / "two.fbx"
    _write_quad_fbx(p, extra_first_mesh=True)
    m = load_fbx(p)
    assert m.tris.shape == (2, 3)  # the quad, not the decoy triangle


def test_fbx_dispatch_and_errors(tmp_path):
    p = tmp_path / "quad.fbx"
    _write_quad_fbx(p)
    m = load_mesh_file(p)
    assert m.tris.shape == (2, 3)
    ascii_p = tmp_path / "ascii.fbx"  # ascii is parsed; no geometry = error
    ascii_p.write_text("; FBX 7.4.0 project file\nObjects: {\n}\n")
    with pytest.raises(IOError, match="no mesh geometry"):
        load_fbx(ascii_p)
    trunc = tmp_path / "trunc.fbx"
    trunc.write_bytes(b"Kaydara FBX Binary  \x00\x1a\x00" + b"\x00" * 8)
    with pytest.raises(IOError, match="corrupt|no mesh"):
        load_fbx(trunc)


def test_fbx_renders_through_pipeline(tmp_path):
    """The imported mesh goes through SBVH + packet traversal cleanly."""
    import jax.numpy as jnp

    from vrenderer_pathtracer.accel.mesh import pack_mesh
    from vrenderer_pathtracer.accel.traverse import traverse

    p = tmp_path / "quad.fbx"
    _write_quad_fbx(p)
    mesh = pack_mesh(load_fbx(p))
    o = jnp.asarray([[0.5, 0.25, 5.0], [5.0, 5.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    slot, t = traverse(mesh, o, d, jnp.full((2,), 1e6, jnp.float32))
    assert int(slot[0]) >= 0 and np.isclose(float(t[0]), 5.0, atol=1e-4)
    assert int(slot[1]) < 0  # misses the recentered quad


# ---------------------------------------------------------------------------
# ASCII FBX (text form) — same quad through the text parser.
# ---------------------------------------------------------------------------


_ASCII_QUAD = """; FBX 7.4.0 project file
FBXHeaderExtension:  {
    FBXHeaderVersion: 1003
    FBXVersion: 7400
}
Objects:  {
    Geometry: 1000, "Geometry::decoy", "Mesh" {
        Vertices: *9 {
            a: 10,10,10,11,10,10,10,11,10
        }
        PolygonVertexIndex: *3 {
            a: 0,1,-3
        }
    }
    Geometry: 1001, "Geometry::mesh", "Mesh" {
        Vertices: *12 {
            a: 0,0,0,2,0,0,2,2,0,
               0,2,0
        }
        PolygonVertexIndex: *4 {
            a: 0,1,2,-4
        }
        LayerElementNormal: 0 {
            Version: 102
            Name: ""
            MappingInformationType: "ByPolygonVertex"
            ReferenceInformationType: "Direct"
            Normals: *12 {
                a: 0,0,1,0,0,1,0,0,1,0,0,1
            }
        }
        LayerElementUV: 0 {
            Version: 101
            MappingInformationType: "ByPolygonVertex"
            ReferenceInformationType: "IndexToDirect"
            UV: *8 {
                a: 0,0,1,0,1,1,0,1
            }
            UVIndex: *4 {
                a: 0,1,2,3
            }
        }
    }
}
Connections:  {
    C: "OO",1001,0
}
"""


def test_fbx_ascii_quad(tmp_path):
    p = tmp_path / "quad_ascii.fbx"
    p.write_text(_ASCII_QUAD)
    m = load_fbx(p)
    assert m.tris.shape == (2, 3)
    assert m.verts.shape[0] == 4
    np.testing.assert_allclose(sorted(m.verts[:, 0]), [-1, -1, 1, 1])
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 4)
    uvs = {tuple(np.round(r, 5)) for r in m.uvs}
    assert uvs == {(0, 1), (1, 1), (1, 0), (0, 0)}  # v flipped


def test_fbx_ascii_not_fbx_rejected(tmp_path):
    p = tmp_path / "nope.fbx"
    p.write_text("solid ascii_stl\nendsolid\n" * 4)
    with pytest.raises(IOError):
        load_fbx(p)
