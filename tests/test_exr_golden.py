"""EXR codec validation against the SYSTEM OpenEXR library.

Compiles tests/tools/exr_tool.cpp (linking the image's libOpenEXR) on
demand and cross-checks the repo's dependency-free codec
(native/csrc/exr.cc) against real library output — strictly stronger than
roundtrip tests, which cannot catch a consistent encode/decode bug pair.
This harness caught two real ones: PXR24 per-plane delta accumulation
(carries must propagate across byte planes) and the B44 encoder quantizing
a full step off OpenEXR's quality (lattice anchoring to tMax).

Skips cleanly when the library or toolchain is unavailable.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from vrenderer_pathtracer.native import load_exr, write_exr

TOOL_SRC = pathlib.Path(__file__).parent / "tools" / "exr_tool.cpp"

COMPRESSIONS = {
    0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
    5: "PXR24", 6: "B44", 7: "B44A",
}
DWA = {8: "DWAA", 9: "DWAB"}


@pytest.fixture(scope="module")
def exr_tool(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = tmp_path_factory.mktemp("tools") / "exr_tool"
    cmd = [
        "g++", "-O1", "-I/usr/include/OpenEXR", "-I/usr/include/Imath",
        str(TOOL_SRC), "-o", str(out),
        "-lOpenEXR-3_1", "-lImath-3_1", "-lIex-3_1", "-lIlmThread-3_1",
    ]
    r = subprocess.run(cmd, capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"system OpenEXR unavailable: {r.stderr.decode()[:200]}")
    return str(out)


def _dump(tool, path, tmp):
    b = str(tmp / "dump.bin")
    subprocess.run([tool, "dump", path, b], check=True)
    raw = open(b, "rb").read()
    w, h = np.frombuffer(raw[:8], np.int32)
    return np.frombuffer(raw[8:], np.float32).reshape(h, w, 3)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
def test_decode_matches_openexr(exr_tool, tmp_path, comp):
    """Our decoder reproduces the system OpenEXR decode BIT-EXACTLY for
    every scanline compression (lossy schemes decode deterministically —
    both readers see the same stored data)."""
    f = str(tmp_path / f"g{comp}.exr")
    subprocess.run([exr_tool, "write", f, str(comp), "67", "41"], check=True)
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    np.testing.assert_array_equal(ours, ref,
                                  err_msg=COMPRESSIONS[comp])


@pytest.mark.parametrize("comp", list(DWA))
def test_decode_dwa_matches_openexr(exr_tool, tmp_path, comp):
    """DWAA/DWAB decode vs the system OpenEXR.  The library's decoder runs
    float32 DCT/CSC with generated half LUTs; ours computes the same curve
    directly, so a small fraction of pixels round to a neighbouring half at
    fp boundaries — require >= 95% bit-exact and everything within a few
    half ULPs."""
    f = str(tmp_path / f"g{comp}.exr")
    subprocess.run([exr_tool, "write", f, str(comp), "67", "41"], check=True)
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    assert (ours == ref).mean() > 0.95, DWA[comp]
    np.testing.assert_allclose(ours, ref, rtol=8e-3, atol=1e-4,
                               err_msg=DWA[comp])


@pytest.mark.parametrize("name,tol", [
    ("none", 2.5e-3), ("rle", 2.5e-3), ("zips", 2.5e-3), ("zip", 2.5e-3),
    ("piz", 2.5e-3), ("pxr24", 2.5e-3),
])
def test_write_read_by_openexr(exr_tool, tmp_path, name, tol):
    """Files from our writer load in the real library with only
    half-rounding error."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 4, (41, 67, 3)).astype(np.float32)
    f = str(tmp_path / f"w_{name}.exr")
    write_exr(f, img, compression=name)
    ref = _dump(exr_tool, f, tmp_path)
    assert np.abs(ref - img).max() < tol


def test_b44_write_quality_matches_openexr(exr_tool, tmp_path):
    """Our B44 encoder's loss equals the system encoder's on the same
    image (lattice anchored to tMax + nearest-code feedback)."""
    f_none = str(tmp_path / "p0.exr")
    f_b44 = str(tmp_path / "p6.exr")
    subprocess.run([exr_tool, "write", f_none, "0", "64", "48"], check=True)
    subprocess.run([exr_tool, "write", f_b44, "6", "64", "48"], check=True)
    src = np.asarray(load_exr(f_none))
    their_loss = np.abs(src - np.asarray(load_exr(f_b44))).max()

    f_ours = str(tmp_path / "ours.exr")
    write_exr(f_ours, src, compression="b44")
    our_loss = np.abs(src - _dump(exr_tool, f_ours, tmp_path)).max()
    assert our_loss <= their_loss * 1.5 + 1e-4, (our_loss, their_loss)


def test_dwaa_write_read_by_openexr(exr_tool, tmp_path):
    """The system OpenEXR decodes our DWAA files bit-identically to our own
    decoder, and close to the source."""
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (41, 67, 3)) ** 2 * 4).astype(np.float32)
    f = str(tmp_path / "w_dwaa.exr")
    write_exr(f, img, compression="dwaa")
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    np.testing.assert_array_equal(ref, ours)
    assert np.abs(ref - img).max() < 0.06 * max(1.0, img.max())


def test_decode_float_dwaa_matches_openexr(exr_tool, tmp_path):
    """FLOAT-typed channels under DWA are LOSSY_DCT too (per-type rules);
    decode must match the library, not silently produce zeros."""
    f = str(tmp_path / "float_dwaa.exr")
    subprocess.run([exr_tool, "writef", f, "8", "67", "41"], check=True)
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    assert np.abs(ref).max() > 0.1  # the file genuinely has content
    assert (ours == ref).mean() > 0.95
    np.testing.assert_allclose(ours, ref, rtol=8e-3, atol=1e-4)


def test_writeraw_custom_image_roundtrip(exr_tool, tmp_path):
    """A custom image through the SYSTEM encoder (writeraw) decodes the
    same through both readers — covers content our deterministic pattern
    misses (flat + impulse + full-range rows)."""
    img = np.zeros((24, 40, 3), np.float32)
    img[:8] = 0.5
    img[10, 20] = (1000.0, -3.0, 0.001)
    img[16:] = np.linspace(0, 60, 40, dtype=np.float32)[None, :, None]
    raw = str(tmp_path / "img.bin")
    np.ascontiguousarray(img).tofile(raw)
    f = str(tmp_path / "custom_dwaa.exr")
    subprocess.run([exr_tool, "writeraw", f, "8", "40", "24", raw],
                   check=True)
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    assert (ours == ref).mean() > 0.95
    np.testing.assert_allclose(ours, ref, rtol=8e-3, atol=1e-3)


def test_corrupt_dwa_header_is_an_error_not_a_crash(exr_tool, tmp_path):
    """Oversized counts/sizes in the DWA chunk header must surface as a
    clean load error — with -fno-exceptions an unchecked allocation would
    abort the whole process (advisor-style hardening, verified by fuzz)."""
    import struct

    f = str(tmp_path / "g8.exr")
    subprocess.run([exr_tool, "write", f, "8", "64", "48"], check=True)
    data = bytearray(open(f, "rb").read())
    # Find the chunk: parse header attrs then the one-entry offset table.
    off = 8
    while data[off] != 0:
        e = data.index(b"\0", off); off = e + 1
        e = data.index(b"\0", off); off = e + 1
        size = struct.unpack("<i", bytes(data[off:off + 4]))[0]
        off += 4 + size
    off += 1
    (co,) = struct.unpack("<Q", bytes(data[off:off + 8]))
    hdr_base = co + 8  # past (y, dsize)
    for field, val in ((8, 0x7FFFFFFFFFFF), (3, 0xFFFFFFFFFFFFFF00),
                       (9, 1 << 60), (7, 1 << 60)):
        fuzzed = bytearray(data)
        struct.pack_into("<Q", fuzzed, hdr_base + 8 * field, val)
        p = tmp_path / f"fuzz{field}.exr"
        p.write_bytes(bytes(fuzzed))
        with pytest.raises(IOError):
            load_exr(str(p))


@pytest.mark.parametrize("comp", list(COMPRESSIONS) + list(DWA))
def test_corrupted_files_error_cleanly(exr_tool, tmp_path, comp):
    """Truncations and byte flips of valid files across every codec must
    surface as clean IOErrors — never crash or hang (the library is built
    with -fno-exceptions, so an unchecked allocation aborts the process)."""
    import random

    f = str(tmp_path / f"g{comp}.exr")
    subprocess.run([exr_tool, "write", f, str(comp), "64", "48"], check=True)
    base = open(f, "rb").read()
    rng = random.Random(comp)
    for trial in range(24):
        b = bytearray(base)
        if trial % 3 == 0:
            b = b[:rng.randrange(8, len(b))]
        else:
            lo = 0 if trial % 3 == 1 else min(300, len(b) - 1)
            for _ in range(6):
                b[rng.randrange(lo, len(b))] = rng.randrange(256)
        p = tmp_path / "fz.exr"
        p.write_bytes(bytes(b))
        try:
            load_exr(str(p))
        except IOError:
            pass  # clean surfaced error — the contract


@pytest.mark.parametrize("comp", [0, 3, 4, 5, 6, 8])
def test_tiled_decode_matches_openexr(exr_tool, tmp_path, comp):
    """ONE_LEVEL tiled files (tile chunks share the per-chunk codec) decode
    identically to the library — bit-exact except DWA's half-ULP boundary
    rounding."""
    f = str(tmp_path / f"t{comp}.exr")
    subprocess.run([exr_tool, "writetiled", f, str(comp), "100", "70", "32"],
                   check=True)
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    if comp == 8:
        assert (ours == ref).mean() > 0.95
        np.testing.assert_allclose(ours, ref, rtol=8e-3, atol=1e-4)
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("comp", [0, 4, 8])
def test_y_channel_decode_matches_openexr(exr_tool, tmp_path, comp):
    """Y-only (grayscale) files, including Y as a SOLO lossy-DCT channel
    under DWA (no CSC set), decode to the library's broadcast gray."""
    f = str(tmp_path / f"y{comp}.exr")
    subprocess.run([exr_tool, "writey", f, str(comp), "64", "48"], check=True)
    ref = _dump(exr_tool, f, tmp_path)
    ours = np.asarray(load_exr(f))
    if comp == 8:
        assert (ours == ref).mean() > 0.95
        np.testing.assert_allclose(ours, ref, rtol=8e-3, atol=1e-4)
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("comp", [0, 3, 4])
def test_multipart_reads_first_image_part(exr_tool, tmp_path, comp):
    """Multipart EXR (version flag 0x1000): the reader selects the first
    regular-image part and returns its RGB bit-exactly (VERDICT r4 #8 —
    the reference reads whatever its linked OpenEXR reads).  The dump
    path of the system tool reads part 0 too, so the comparison target is
    a single-part file with the same pixel pattern."""
    mp = str(tmp_path / f"mp{comp}.exr")
    r = subprocess.run([exr_tool, "writemp", mp, str(comp), "53", "37", "3"],
                       capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"library lacks multipart write: {r.stderr.decode()[:120]}")
    single = str(tmp_path / f"sp{comp}.exr")
    subprocess.run([exr_tool, "write", single, str(comp), "53", "37"],
                   check=True)
    ref = _dump(exr_tool, single, tmp_path)
    ours = np.asarray(load_exr(mp))
    # writemp stores the same pattern as write, through HALF channels (the
    # rgba 'write' path also stores HALF) — bit-exact match expected.
    np.testing.assert_array_equal(ours, ref)
