"""ctypes bindings for the native host library (SBVH builder + loaders).

Mirrors the reference's host/device split: algorithmically serious host code
(SBVH src/SBVH.cpp, mesh import src/MeshLoader.cpp, MERL src/BRDFLoader.cpp,
EXR src/NGLScene.cpp:205-231) runs native; everything device-side is JAX.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from vrenderer_pathtracer.native.build import ensure_built

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    lib = ctypes.CDLL(str(path))

    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int)

    lib.vt_build_sbvh.restype = ctypes.c_int
    lib.vt_build_sbvh.argtypes = [
        c_fp, ctypes.c_int, c_ip, ctypes.c_int,
        ctypes.POINTER(c_fp), ctypes.POINTER(c_ip), c_ip,
        ctypes.POINTER(c_ip), c_ip, c_ip,
    ]
    lib.vt_load_obj.restype = ctypes.c_int
    lib.vt_load_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(c_fp), ctypes.POINTER(c_fp), ctypes.POINTER(c_fp),
        ctypes.POINTER(c_fp), c_ip, ctypes.POINTER(c_ip), c_ip,
    ]
    lib.vt_load_ply.restype = ctypes.c_int
    lib.vt_load_ply.argtypes = lib.vt_load_obj.argtypes
    lib.vt_load_fbx.restype = ctypes.c_int
    lib.vt_load_fbx.argtypes = lib.vt_load_obj.argtypes
    lib.vt_load_merl.restype = ctypes.c_int
    lib.vt_load_merl.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_fp), c_ip]
    lib.vt_load_exr.restype = ctypes.c_int
    lib.vt_load_exr.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_fp), c_ip, c_ip]
    lib.vt_write_exr.restype = ctypes.c_int
    lib.vt_write_exr.argtypes = [ctypes.c_char_p, c_fp, ctypes.c_int, ctypes.c_int]
    lib.vt_write_exr_c.restype = ctypes.c_int
    lib.vt_write_exr_c.argtypes = [ctypes.c_char_p, c_fp, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.vt_free.restype = None
    lib.vt_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


# Native return codes -> human-readable reasons, so loader failures surface
# with filename + cause (SURVEY §5.3 — the reference at least printed errors
# and wrote errorlog.txt; bare ints would be a regression on that).
_OBJ_ERRORS = {
    1: "cannot open file",
    2: "no geometry found (empty or not an OBJ)",
}
_PLY_ERRORS = {
    1: "cannot open file",
    2: "truncated or invalid geometry",
    3: "unsupported PLY flavour (need ascii or binary_little_endian 1.0 "
       "with x/y/z vertex properties)",
}
_FBX_ERRORS = {
    1: "cannot open file",
    2: "corrupt container or no mesh geometry",
    3: "not an FBX file (foreign format: convert to FBX, OBJ or PLY)",
}
_MERL_ERRORS = {
    1: "cannot open file",
    2: "truncated header (expected 3 int32 dims)",
    3: "wrong dimensions (MERL tables must be 90x90x180)",
    4: "truncated data (expected 3*90*90*180 doubles)",
}
_EXR_ERRORS = {
    1: "cannot open file",
    2: "not an EXR (bad magic/version)",
    3: "bad header (missing/invalid channels or dataWindow)",
    4: "unsupported feature (deep data, compression beyond "
       "NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB, UINT channels, "
       "or no R/G/B/Y channels; multipart files read their first "
       "regular-image part)",
    5: "truncated or corrupt pixel data",
}


def _reason(table, rc):
    return table.get(rc, f"unknown error {rc}")


def _take(ptr, shape, dtype, lib):
    """Copy a malloc'd C array into numpy and free the C side."""
    n = int(np.prod(shape))
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_int
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,))
    out = np.array(arr, dtype=dtype).reshape(shape)
    lib.vt_free(ptr)
    return out


class HostMesh(NamedTuple):
    """Indexed triangle mesh as loaded (pre-BVH)."""

    verts: np.ndarray     # [V,3] float32, centered at centroid
    normals: np.ndarray   # [V,3]
    tangents: np.ndarray  # [V,3]
    uvs: np.ndarray       # [V,2] (v flipped, reference parity)
    tris: np.ndarray      # [T,3] int32


class FlatBVH(NamedTuple):
    """SBVH in the SoA layout (see csrc/sbvh.cc header comment)."""

    nodes_f: np.ndarray    # [M,12] float32 — child AABBs (lo0,hi0,lo1,hi1)
    nodes_i: np.ndarray    # [M,4]  int32   — (ref,count) per child
    tri_order: np.ndarray  # [R] int32 — original tri index per leaf slot
    max_depth: int = 0     # deepest inner node (root = 0): stack-bound proof


def load_obj(path: str) -> HostMesh:
    lib = _load()
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int)
    pv, pn, pt, puv = c_fp(), c_fp(), c_fp(), c_fp()
    ptris = c_ip()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_load_obj(
        str(path).encode(), ctypes.byref(pv), ctypes.byref(pn),
        ctypes.byref(pt), ctypes.byref(puv), ctypes.byref(nv),
        ctypes.byref(ptris), ctypes.byref(nt),
    )
    if rc != 0:
        raise IOError(f"load_obj({path}): {_reason(_OBJ_ERRORS, rc)} (code {rc})")
    v = nv.value
    t = nt.value
    return HostMesh(
        verts=_take(pv, (v, 3), np.float32, lib),
        normals=_take(pn, (v, 3), np.float32, lib),
        tangents=_take(pt, (v, 3), np.float32, lib),
        uvs=_take(puv, (v, 2), np.float32, lib),
        tris=_take(ptris, (t, 3), np.int32, lib),
    )


def load_ply(path: str) -> HostMesh:
    """PLY import (ascii / binary_little_endian) with the same
    post-processing contract as :func:`load_obj`."""
    lib = _load()
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int)
    pv, pn, pt, puv = c_fp(), c_fp(), c_fp(), c_fp()
    ptris = c_ip()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_load_ply(
        str(path).encode(), ctypes.byref(pv), ctypes.byref(pn),
        ctypes.byref(pt), ctypes.byref(puv), ctypes.byref(nv),
        ctypes.byref(ptris), ctypes.byref(nt),
    )
    if rc != 0:
        raise IOError(f"load_ply({path}): {_reason(_PLY_ERRORS, rc)} (code {rc})")
    v = nv.value
    t = nt.value
    return HostMesh(
        verts=_take(pv, (v, 3), np.float32, lib),
        normals=_take(pn, (v, 3), np.float32, lib),
        tangents=_take(pt, (v, 3), np.float32, lib),
        uvs=_take(puv, (v, 2), np.float32, lib),
        tris=_take(ptris, (t, 3), np.int32, lib),
    )


def load_fbx(path: str) -> HostMesh:
    """FBX import, binary or ascii (csrc/fbx.cc): last Mesh geometry,
    layer-0 normals/UVs, same post-processing contract as
    :func:`load_obj`."""
    lib = _load()
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int)
    pv, pn, pt, puv = c_fp(), c_fp(), c_fp(), c_fp()
    ptris = c_ip()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_load_fbx(
        str(path).encode(), ctypes.byref(pv), ctypes.byref(pn),
        ctypes.byref(pt), ctypes.byref(puv), ctypes.byref(nv),
        ctypes.byref(ptris), ctypes.byref(nt),
    )
    if rc != 0:
        raise IOError(f"load_fbx({path}): {_reason(_FBX_ERRORS, rc)} (code {rc})")
    v = nv.value
    t = nt.value
    return HostMesh(
        verts=_take(pv, (v, 3), np.float32, lib),
        normals=_take(pn, (v, 3), np.float32, lib),
        tangents=_take(pt, (v, 3), np.float32, lib),
        uvs=_take(puv, (v, 2), np.float32, lib),
        tris=_take(ptris, (t, 3), np.int32, lib),
    )


def load_mesh_file(path: str) -> HostMesh:
    """Extension-dispatching mesh import (reference file dialog accepts
    *.obj *.ply *.fbx, ``src/NGLScene.cpp:348``)."""
    p = str(path).lower()
    if p.endswith(".obj"):
        return load_obj(path)
    if p.endswith(".ply"):
        return load_ply(path)
    if p.endswith(".fbx"):
        return load_fbx(path)
    raise IOError(f"load_mesh_file({path}): unknown mesh format")


def build_sbvh(verts: np.ndarray, tris: np.ndarray) -> FlatBVH:
    """Spatial-split BVH over an indexed triangle mesh (csrc/sbvh.cc)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    c_fp = ctypes.POINTER(ctypes.c_float)
    c_ip = ctypes.POINTER(ctypes.c_int)
    pf, pi, po = c_fp(), c_ip(), c_ip()
    n_nodes, n_refs = ctypes.c_int(), ctypes.c_int()
    max_depth = ctypes.c_int()
    rc = lib.vt_build_sbvh(
        verts.ctypes.data_as(c_fp), len(verts),
        tris.ctypes.data_as(c_ip), len(tris),
        ctypes.byref(pf), ctypes.byref(pi), ctypes.byref(n_nodes),
        ctypes.byref(po), ctypes.byref(n_refs), ctypes.byref(max_depth),
    )
    if rc != 0:
        raise RuntimeError(
            f"vt_build_sbvh failed with code {rc} "
            f"({ {1: 'no triangles', 2: 'out of memory'}.get(rc, 'unknown')})"
        )
    m = n_nodes.value
    r = n_refs.value
    return FlatBVH(
        nodes_f=_take(pf, (m, 12), np.float32, lib),
        nodes_i=_take(pi, (m, 4), np.int32, lib),
        tri_order=_take(po, (r,), np.int32, lib),
        max_depth=max_depth.value,
    )


def load_exr(path: str) -> np.ndarray:
    """Read an EXR (scanline, half/float, none/zip) -> [H,W,3] float32.

    Native replacement for the reference's OpenEXR RgbaInputFile path
    (src/NGLScene.cpp:368-401)."""
    lib = _load()
    c_fp = ctypes.POINTER(ctypes.c_float)
    pd = c_fp()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_load_exr(str(path).encode(), ctypes.byref(pd),
                         ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"load_exr({path}): {_reason(_EXR_ERRORS, rc)} (code {rc})")
    return _take(pd, (h.value, w.value, 3), np.float32, lib)


def write_exr(path: str, rgb: np.ndarray, compression: str = "none") -> None:
    """Write [H,W,3] float32 as a half EXR.

    ``compression`` — "none", "rle" (run-length), "zips"/"zip" (deflate +
    half-interleave filter, 1/16-line blocks), "piz" (wavelet+Huffman, the
    common wild format; csrc/piz.cc), "pxr24" (per-line byte-plane deltas
    + deflate; lossless for HALF data), "b44" (lossy fixed-rate 4x4 half
    blocks), "dwaa" or "dwab" (lossy DCT at 32/256-line chunks;
    csrc/dwa.cc)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, np.float32)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H,W,3], got {rgb.shape}")
    codes = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4,
             "pxr24": 5, "b44": 6, "dwaa": 8, "dwab": 9}
    if compression not in codes:
        raise ValueError(f"unsupported compression {compression!r}")
    c_fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.vt_write_exr_c(str(path).encode(), rgb.ctypes.data_as(c_fp),
                            rgb.shape[1], rgb.shape[0], codes[compression])
    if rc != 0:
        raise IOError(f"write_exr({path}) failed with code {rc}")


def load_merl(path: str) -> np.ndarray:
    """MERL table as [3, 90*90*180] float32 (reference scale factors NOT
    applied here — they live in ops/brdf.py)."""
    lib = _load()
    c_fp = ctypes.POINTER(ctypes.c_float)
    pd = c_fp()
    n = ctypes.c_int()
    rc = lib.vt_load_merl(str(path).encode(), ctypes.byref(pd), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"load_merl({path}): {_reason(_MERL_ERRORS, rc)} (code {rc})")
    return _take(pd, (3, n.value), np.float32, lib)

