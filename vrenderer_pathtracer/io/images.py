"""Image I/O: PNG output with the standard library, EXR/MERL/OBJ via the
native library, LDR texture input via PIL when it is installed.

Replaces the reference's Qt/OpenEXR/Assimp ingestion (QImage at
``src/NGLScene.cpp:403-424``, RgbaInputFile at ``:368-401``, Assimp at
``src/MeshLoader.cpp:19``) with the dependency-free C++ loaders in
``native/``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from vrenderer_pathtracer.native import (  # noqa: F401  (re-exports)
    load_exr,
    load_fbx,
    load_merl,
    load_mesh_file,
    load_obj,
    load_ply,
    write_exr,
)


def load_image(path) -> np.ndarray:
    """LDR image -> [H,W,3] float32 in [0,1] (no gamma handling here; the
    Renderer linearises diffuse maps at load, reference parity).  Needs
    the optional PIL package."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "load_image needs PIL (the Pillow package) to decode LDR "
            "images; pass textures as float arrays instead") from e

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(rgb8: np.ndarray, level: int = 6) -> bytes:
    """[H,W,3] uint8 -> PNG bytes (8-bit RGB, filter type 0 rows)."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"expected [H,W,3] uint8, got {rgb8.shape} {rgb8.dtype}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def save_png(path, img01, flip_y: bool = True) -> None:
    """[H,W,3] float in [0,1] -> 8-bit PNG.  ``flip_y`` converts the
    renderer's y-up row order to image convention."""
    arr = np.asarray(img01)
    if flip_y:
        arr = arr[::-1]
    arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))


def save_depth_png(path, depth, flip_y: bool = True) -> None:
    """Depth channel the reference way: (1 - depth) greyscale
    (``cuda/src/PathTracer.cu:850-851``)."""
    d = np.asarray(depth)
    save_png(path, np.repeat((1.0 - d)[..., None], 3, axis=-1), flip_y=flip_y)
