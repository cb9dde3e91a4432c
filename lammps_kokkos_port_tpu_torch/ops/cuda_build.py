"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each source in `csrc/` is compiled on its own into a shared library with a
plain C interface, `_build/lib<stem>-<hash>.so`, where the hash covers the
source's bytes, the shared headers and the flags: an edited source or
header builds anew. A library is
built at first use and then loaded from disk; `build(*sources)` starts one
nvcc per missing library, all at once, so a process that needs every
kernel waits for the slowest build only. The compiler's log (`-Xptxas -v`:
registers and shared memory per kernel) is kept beside each library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
# the sorted layout's re-bin kernels (ops/rebin_kernels), which every run of
# the layout launches beside its force kernels: built in the batch of any
# other source, so that a checkout's first run waits for no nvcc of theirs
COMPANIONS = (CSRC / "sorted_rebin.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def lib_path(source: Path) -> Path:
    """Library path keyed by a hash of the source, the headers beside it
    (`*.cuh`, which any source may include) and the flags."""
    source = Path(source)
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return nvcc


def build(*sources: Path) -> dict[str, str]:
    """Build every library that is not on disk yet, one nvcc process per
    source, all started together, with the missing `COMPANIONS` among them
    where anything is built. Returns {source name: compiler log} of
    `sources`."""
    todo = [Path(s) for s in sources if not lib_path(s).exists()]
    if todo:
        todo += [s for s in COMPANIONS
                 if s not in todo and not lib_path(s).exists()]
        nvcc = _nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        jobs = []
        try:
            for src in todo:
                # build under a temporary name, then rename: concurrent
                # processes never load a half-written library
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs.append((src, tmp, proc))
            failed = []
            for src, tmp, proc in jobs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {src.name}:\n{out}")
                    continue
                lib = lib_path(src)
                lib.with_suffix(".log").write_text(out)
                os.replace(tmp, lib)
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            for _, tmp, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    logs = {}
    for src in sources:
        log = lib_path(src).with_suffix(".log")
        logs[Path(src).name] = log.read_text() if log.exists() else ""
    return logs


@functools.cache
def _load(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of `source`, built first if it is not on disk."""
    build(source)
    return _load(lib_path(source))
