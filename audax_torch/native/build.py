"""Build the port's host C++ libraries with ``g++`` (port of
``audax/native/build.py``).

Two libraries, so that their dependencies stay apart:

  * ``sf2synth`` -- the SF2 soundfont synth (``src/sf2synth.cpp``), self
    contained;
  * ``audio_decode`` -- compressed-audio decode and encode
    (``src_decode/audio_decode.cpp``), linked against the system
    libavformat, libavcodec and libavutil.

Each is built at first use into ``audax_torch/build/`` (listed in
``.gitignore``), named by a hash of its source and flags, as the CUDA
libraries are (``ops/native.py:lib_path``): an edited source builds anew,
an unchanged one is reused. A missing compiler, header or library raises
the build's own error with the compiler's output; there is no quiet route
and no ``ffmpeg`` subprocess.

    python -m audax_torch.native.build      # build both, print their paths
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["LIBRARIES", "CXX_FLAGS", "lib_path", "build"]

_HERE = Path(__file__).resolve().parent
BUILD = _HERE.parent / "build"

#: g++ flags of both libraries (the JAX package's, so both render alike)
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wall")

#: library -> (source under native/, the libraries it links)
LIBRARIES = {
    "sf2synth": ("src/sf2synth.cpp", ()),
    "audio_decode": ("src_decode/audio_decode.cpp",
                     ("-lavformat", "-lavcodec", "-lavutil")),
}


def lib_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built: keyed by a hash of its
    source and flags."""
    src, links = LIBRARIES[name]
    digest = hashlib.sha256((_HERE / src).read_bytes() + " ".join(
        CXX_FLAGS + links).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """The path of library ``name``, compiled first if it is not built
    yet. Raises ``RuntimeError`` with the compiler's output when ``g++`` is
    missing or the compile or link fails."""
    out = lib_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the port's host library {name!r} "
                           "is built from audax_torch/native at first use")
    src, links = LIBRARIES[name]
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_HERE / src),
                           *links], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {name} (exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)              # atomic: a reader never sees half
    return out


if __name__ == "__main__":
    for lib in LIBRARIES:
        print(build(lib))
