"""The serving call's share of the card's peak, in %: the conv operations
of one inverse pass a sample (the default lowering's count, the same work
whatever lowering runs it, ``counts.py``) times the samples of the traced
window, over the same calls' time untraced (the profiler stretches the
traced window) and the peak of the configuration's compute dtype
(TF32's for float32)."""

import sys

from cnfbench import counts


def read(record):
    if record.get("kind") != "serve":
        return None
    cfg = record["config"]
    dtype = cfg["compute_dtype"]
    sample = sum(c.flops for c in counts.model_convs(cfg, 1))
    print(f"mfu.serve: {sample:.6g} conv FLOP a sample, peak {counts.PEAK_FLOPS[dtype]:.6g} "
          f"FLOP/s ({dtype}, H100 SXM data sheet)", file=sys.stderr)
    seconds = record["untraced_window_s"]
    return 100.0 * sample * record["samples"] / seconds / counts.PEAK_FLOPS[dtype]
