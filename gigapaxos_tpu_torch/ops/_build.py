"""Builds the port's CUDA sources (``ops/csrc/*.cu``) with ``nvcc``.

Each source becomes its own shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Libraries go to ``ops/_build/`` (listed in ``.gitignore``), named by a
hash of the source, the headers beside it and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  Nothing is
built when the module is imported: :func:`load` builds at first use,
and :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from gigapaxos_tpu_torch.utils.engineledger import EngineLedger

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every kernel source by name (``accept`` for ``csrc/accept.cu``)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """``nvcc`` on the PATH, else in the toolkit torch itself finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME and cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    """Where the library for ``name`` lives at the current sources."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [sources()[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named source that is not built yet, one ``nvcc``
    process per source, all started together.  Returns the seconds each
    build took (0.0 for one already built); raises on any failure, with
    the compiler's output.  The ptxas report (registers, spills) goes to
    ``<lib>.log`` beside each library."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.monotonic())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        EngineLedger.note_build(f"cuda:{name}", secs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_source(src: Path, out: Path, extra: Iterable[str] = ()) -> str:
    """Build one source file (say, an older checkout's, or a variant of
    this one's with ``extra`` flags such as ``-DNAME=VALUE``) into
    ``out`` with the flags above; returns the compiler's output, raises
    on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, *extra, "-o", str(out),
                           str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    text = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit "
                           f"{proc.returncode}):\n{text}")
    return text


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            built = build_all([name])[name] > 0
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
            EngineLedger.note_load(f"cuda:{name}", built)
        return lib


def ptxas_report(name: str) -> str:
    """What ptxas said about the library's kernels (registers, shared
    memory, spills), from the build log."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
