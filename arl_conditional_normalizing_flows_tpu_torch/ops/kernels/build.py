"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch header, so
``nvcc`` compiles it in seconds into ``_build/lib<name>-<hash>.so`` (a
directory git ignores) at first use. ``<hash>`` covers the source and the
flags, so a changed source is rebuilt and an unchanged one is not. Several
sources build concurrently, one ``nvcc`` each. A failed build raises with
nvcc's stderr; nothing here falls back to another path.
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


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by content + flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


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


def _build(targets: dict) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with ThreadPoolExecutor(max_workers=len(targets)) as pool:
        futures = [pool.submit(_build_one, nvcc, n, p) for n, p in targets.items()]
        for f in futures:
            f.result()


def _build_one(nvcc: str, name: str, out: Path) -> None:
    # build under a private name, then rename: a concurrent loader never sees
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    try:
        subprocess.run(cmd, capture_output=True, text=True,
                       timeout=BUILD_TIMEOUT_S, check=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {e.returncode}):\n{e.stderr}"
        ) from e
    finally:
        tmp.unlink(missing_ok=True)
