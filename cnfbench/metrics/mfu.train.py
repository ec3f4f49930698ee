"""The train step's share of the card's peak, in %: the default lowering's
conv operations for a step at the card's rows (forward, input and weight
gradients, counted in ``counts.py``) times the steps of the traced window,
over the same calls' time untraced (the profiler stretches the
traced window) and the peak of the configuration's compute dtype."""

import sys

from cnfbench import counts


def read(record):
    if record.get("kind") != "train":
        return None
    cfg = record["config"]
    dtype = cfg["compute_dtype"]
    step = sum(c.flops for c in counts.model_convs(cfg, record["rows"], train=True))
    print(f"mfu, train step: {step:.6g} conv FLOP a step of {record['rows']} rows, peak "
          f"{counts.PEAK_FLOPS[dtype]:.6g} FLOP/s ({dtype}, H100 SXM data sheet)",
          file=sys.stderr)
    seconds = record["untraced_window_s"]
    return 100.0 * step * record["steps"] / seconds / counts.PEAK_FLOPS[dtype]
