"""The compile-cache location, the .npz checkpoint and the PNG writer."""

import os
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import jax
import pytest

from vrenderer_pathtracer import Renderer, RenderSettings
from vrenderer_pathtracer.io import images
from vrenderer_pathtracer.render.progressive import (
    restore_checkpoint, save_checkpoint)
from vrenderer_pathtracer.utils import cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_follows_environment(monkeypatch, tmp_path,
                                           restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # sets no other


def test_compile_cache_env_reaches_jax_in_a_fresh_process(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; from vrenderer_pathtracer.utils.cache import "
         "enable_compile_cache as e; print(e()); "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


def _render(n=2):
    r = Renderer(12, 8, settings=RenderSettings(
        use_cornell_box=True, has_hdr=False, samples_per_pass=2, bounces=2))
    r.set_fresnel_coef(0.3)
    r.update_camera(yaw=0.1)
    for _ in range(n):
        r.render()
    return r


def test_npz_checkpoint_roundtrip(tmp_path):
    r = _render()
    save_checkpoint(r, tmp_path / "ckpt")
    files = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert files == ["state.npz"]  # no temporary file left behind
    with np.load(tmp_path / "ckpt" / "state.npz", allow_pickle=False) as z:
        assert set(z.files) == {
            "accum", "frame", "seed", "fresnel_coef", "fresnel_pow", "depth",
            "camera.origin", "camera.yaw", "camera.pitch", "camera.fov_deg"}
    r2 = restore_checkpoint(Renderer(12, 8, settings=r.settings), tmp_path
                            / "ckpt")
    assert r2.frame == r.frame and r2.seed == r.seed
    np.testing.assert_array_equal(np.asarray(r2._accum), np.asarray(r._accum))
    np.testing.assert_array_equal(np.asarray(r2._last_depth),
                                  np.asarray(r._last_depth))
    for a, b in zip(r2.camera, r.camera):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(r2.fresnel_coef) == pytest.approx(0.3)


def test_checkpoint_overwrite_is_atomic(tmp_path, monkeypatch):
    """A write that dies midway leaves the previous checkpoint intact."""
    r = _render(1)
    save_checkpoint(r, tmp_path / "ckpt")
    r.render()

    def boom(f, **kw):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        save_checkpoint(r, tmp_path / "ckpt")
    monkeypatch.undo()
    r2 = restore_checkpoint(Renderer(12, 8, settings=r.settings),
                            tmp_path / "ckpt")
    assert r2.frame == 2


def _decode_png(data):
    """Minimal PNG reader for 8-bit RGB, filter type 0 (what we write)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_writer_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (7, 11, 3)).astype(np.float32)
    images.save_png(tmp_path / "a.png", img)
    got = _decode_png((tmp_path / "a.png").read_bytes())
    want = (np.clip(img[::-1], 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    images.save_png(tmp_path / "b.png", img, flip_y=False)
    np.testing.assert_array_equal(_decode_png((tmp_path / "b.png").read_bytes()),
                                  want[::-1])


def test_depth_png_is_inverted_grey(tmp_path):
    depth = np.linspace(0, 1, 20, dtype=np.float32).reshape(4, 5)
    images.save_depth_png(tmp_path / "d.png", depth)
    got = _decode_png((tmp_path / "d.png").read_bytes())
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()
    want = ((1 - depth[::-1]) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)


def test_load_image_names_pil_when_missing(monkeypatch, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        images.load_image(tmp_path / "x.png")


def test_render_path_imports_no_orbax_or_pil():
    code = ("import sys; from vrenderer_pathtracer.render import progressive;"
            "from vrenderer_pathtracer import io, cli;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('orbax', 'PIL')]; print(bad); assert not bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, JAX_PLATFORMS="cpu",
                            PYTHONPATH=str(REPO)))


def test_chip_smoke_refuses_cpu(tmp_path):
    """Off a GPU chip_smoke.py exits non-zero and prints no result line."""
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repo, it cannot import the
    program and fails."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        env=dict(env, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
