"""Run-reproducibility metadata (port of the JAX ``utils/run_metadata.py``).

The reference records a run's configuration only in the hand-edited block at
the top of each script and in an arch-encoded filename (conv_cINN.py:22-141,
:519). Every driver writes ``run.json`` into its output directory: the CLI
arguments, the device it ran on, torch's and CUDA's versions and (when the
package sits in a git checkout) the commit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch


def _git_commit() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, timeout=5, text=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def write_run_metadata(outdir: str, args, device, extra: dict | None = None) -> str:
    """Write ``<outdir>/run.json`` describing this invocation on ``device``
    (a ``torch.device``); ``args`` is the parsed argparse namespace,
    ``extra`` driver-specific fields. Returns the path written."""
    device = torch.device(device)
    meta = {
        "argv": sys.argv,
        "args": {k: v for k, v in sorted(vars(args).items())},
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "python": sys.version.split()[0],
        "git_commit": _git_commit(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
    }
    if extra:
        meta.update(extra)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "run.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path
