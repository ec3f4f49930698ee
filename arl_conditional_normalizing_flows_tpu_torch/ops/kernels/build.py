"""Build the port's native sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch header, so
``nvcc`` compiles it in seconds into ``_build/lib<name>-<hash>.so`` (a
directory git ignores) at first use. Host C++ sources (the record loader,
``native/cnfrec_loader.cc`` at the repository root) are built the same way
with ``g++`` (:func:`load_host_library`). ``<hash>`` covers the source and
the flags, so a changed source is rebuilt and an unchanged one is not.
Several CUDA sources build concurrently, one ``nvcc`` each. A failed build
raises with the compiler's stderr; nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
BUILD_TIMEOUT_S = 120

_loaded: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the PATH's."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {candidate} or on PATH; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return found


def gxx_path() -> str:
    """``g++`` on the PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the record loader needs a C++ compiler")
    return found


def _keyed_path(source: Path, flags) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by content + flags."""
    return _keyed_path(CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def host_library_path(source: Path) -> Path:
    """Where the ``g++`` build of the host source ``source`` goes."""
    return _keyed_path(Path(source), GXX_FLAGS)


def load_libraries(*names: str) -> dict:
    """Build (where needed, concurrently) and load ``csrc/<name>.cu`` for each
    name; returns ``{name: ctypes.CDLL}``. Loaded libraries are kept for the
    life of the process."""
    with _lock:
        missing = [n for n in names if n not in _loaded]
        targets = {n: library_path(n) for n in missing}
        to_build = {n: p for n, p in targets.items() if not p.is_file()}
        if to_build:
            _build(to_build)
        for n, p in targets.items():
            _loaded[n] = ctypes.CDLL(str(p))
        return {n: _loaded[n] for n in names}


def load_host_library(source) -> ctypes.CDLL:
    """Build (where needed) and load the host C++ source ``source`` with
    ``g++`` (:data:`GXX_FLAGS`); kept for the life of the process."""
    source = Path(source)
    key = str(source.resolve())
    with _lock:
        if key not in _loaded:
            path = host_library_path(source)
            if not path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _compile([gxx_path(), *GXX_FLAGS], source, path)
            _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]


def _build(targets: dict) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = [nvcc_path(), *NVCC_FLAGS]
    with ThreadPoolExecutor(max_workers=len(targets)) as pool:
        futures = [pool.submit(_compile, nvcc, CSRC_DIR / f"{n}.cu", p)
                   for n, p in targets.items()]
        for f in futures:
            f.result()


def _compile(compiler: list, source: Path, out: Path) -> None:
    # build under a private name, then rename: a concurrent loader never sees
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [*compiler, "-o", str(tmp), str(source)]
    try:
        subprocess.run(cmd, capture_output=True, text=True,
                       timeout=BUILD_TIMEOUT_S, check=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"{Path(compiler[0]).name} failed on {source.parent.name}/{source.name} "
            f"(exit {e.returncode}):\n{e.stderr}"
        ) from e
    finally:
        tmp.unlink(missing_ok=True)
