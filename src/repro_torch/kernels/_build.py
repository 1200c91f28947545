"""Build and load the hand-written CUDA kernels.

Each source in ``repro_torch/csrc`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, on first use, into
``build/kernels/`` at the root of the checkout. The file name carries a
hash of the source, of the ``csrc`` headers it includes and of the flags,
so an edited source or header is rebuilt and a built one is reused.
``build()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load()`` builds one source if needed and opens it with ``ctypes``.
Nothing is compiled at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "library_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
SOURCES = ("bsp_spmv", "segment_combine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build this
#: process ran, by source name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> List[Path]:
    """The source ``csrc/<name>.cu`` and every file of ``csrc`` it includes
    with ``#include "..."``, directly or through another include."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and CSRC in dep.parents:
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the library of ``name`` is built: the name carries a hash of
    the source, of every ``csrc`` header it includes and of the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_sources_of(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns the seconds each build took (0.0 for a
    library that was already there); raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)      # atomic: concurrent builders never see a
                                  # half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
