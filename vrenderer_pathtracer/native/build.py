"""Build the native host library (libvtrace_host.so).

The reference's host-side native code (SBVH builder src/SBVH.cpp, loaders
src/MeshLoader.cpp / src/BRDFLoader.cpp) is rebuilt here as one C++ shared
library with a C ABI, bound via ctypes (no pybind11 in this image).

Usage:  python -m vrenderer_pathtracer.native.build
The package auto-builds on first import of ``native`` if the .so is missing
or older than any source file.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc"
LIB = HERE / "libvtrace_host.so"

SOURCES = ["sbvh.cc", "loaders.cc", "fbx.cc", "exr.cc", "piz.cc", "dwa.cc"]
CXXFLAGS = [
    "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
    "-Wall", "-Wextra", "-fno-exceptions",
]


def needs_build() -> bool:
    if not LIB.exists():
        return True
    lib_mtime = LIB.stat().st_mtime
    deps = [CSRC / s for s in SOURCES if (CSRC / s).exists()]
    deps += list(CSRC.glob("*.h"))
    return any(d.stat().st_mtime > lib_mtime for d in deps)


def build(verbose: bool = False) -> pathlib.Path:
    srcs = [str(CSRC / s) for s in SOURCES if (CSRC / s).exists()]
    cmd = ["g++", *CXXFLAGS, *srcs, "-o", str(LIB), "-lz"]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    return LIB


def ensure_built() -> pathlib.Path:
    if needs_build():
        build()
    return LIB


if __name__ == "__main__":
    build(verbose=True)
    print(f"built {LIB}")
    sys.exit(0)
