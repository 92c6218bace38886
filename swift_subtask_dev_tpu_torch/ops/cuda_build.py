"""Build and load the port's CUDA kernel libraries (nvcc + ctypes).

Each library is one ``csrc/<name>.cu`` file plus the headers it includes,
with the library's own preprocessor flags (``flags``, e.g. the flat
kernel's mode libraries: one SPH scheme under one smoothing kernel).
It is compiled at first use by nvcc for sm_90a (IEEE math: no fast math,
no FMA contraction) into the gitignored ``build/`` directory, under a name
keyed by its sources, its flags, ``NVCC_FLAGS`` and the compiler's
version, so a change to any of them rebuilds it.  Its entries have plain
C interfaces, are bound with ctypes and return ``cudaGetLastError()``.
:func:`build_all` starts one nvcc per library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


class KernelLibrary:
    """One kernel library: ``sources[0]`` is compiled, the rest are the
    headers it includes (they key the build too), with the nvcc ``flags``
    of this library.  ``bind(cdll)`` sets the entries' ctypes
    signatures."""

    def __init__(self, name: str, sources: Tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None],
                 flags: Tuple[str, ...] = ()):
        self.name = name
        self.sources = sources
        self.flags = tuple(flags)
        self._bind = bind
        self.handle: Optional[ctypes.CDLL] = None
        self.build_log = ""
        self.build_seconds = 0.0

    def path(self, nvcc_path: str) -> Path:
        """``build/lib<name>-<key>.so``."""
        key = hashlib.sha256()
        for src in self.sources:
            key.update((CSRC / src).read_bytes())
        key.update(" ".join(NVCC_FLAGS + list(self.flags)).encode())
        ver = subprocess.run([nvcc_path, "--version"], capture_output=True,
                             text=True, check=True).stdout
        key.update(ver.encode())
        return BUILD / f"lib{self.name}-{key.hexdigest()[:16]}.so"

    def build(self) -> Path:
        return build_all([self])[0]

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if it is not there."""
        if self.handle is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self.handle = lib
        return self.handle


def build_all(libs: Sequence[KernelLibrary],
              force: bool = False) -> List[Path]:
    """Compile every library of ``libs`` that is not built yet (all of
    them with ``force``), one nvcc process each, all started together.
    Raises on any compiler error."""
    nv = nvcc()
    paths = [lib.path(nv) for lib in libs]
    jobs = []
    BUILD.mkdir(parents=True, exist_ok=True)
    for lib, path in zip(libs, paths):
        if path.exists() and not force:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nv, *NVCC_FLAGS, *lib.flags, "-o", tmp,
               str(CSRC / lib.sources[0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((lib, path, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for lib, path, tmp, cmd, proc, t0 in jobs:
        lib.build_log = proc.communicate()[0]
        lib.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n"
                          f"{lib.build_log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths
