"""K3's share of its roofline in the traced serving calls, in %: the sum
over its launches of max(operations / peak, bytes / 3.35 TB/s) (the frozen
counts of ``counts.py``, the peak of the compute dtype), over the device
time of K3's kernels (every kernel whose name holds ``fused_subnet``). The
profiler drops an occasional record of a graph replay, so the bound is
scaled to the launches that the trace recorded; the number lost is printed."""

import sys

from cnfbench import counts


def read(record):
    if record.get("kind") != "serve" or record["traffic"].get("lowering") != "pallas_subnet":
        return None
    k3 = [(t, n) for name, (t, n) in record["by_name"].items() if "fused_subnet" in name]
    launches = sum(n for _, n in k3)
    if not launches:
        return None
    chains = [c for _, c in counts.chains(record["config"])]
    expected = len(chains) * record["calls"]
    bound = sum(counts.chain_bound_s(c, record["rows"]) for c in chains) * record["calls"]
    dtype = record["config"]["compute_dtype"]
    print(f"k3_roofline.serve: {launches} of {expected} launches recorded "
          f"({expected - launches} lost); peak {counts.PEAK_FLOPS[dtype]:.6g} FLOP/s ({dtype}), "
          f"{counts.HBM_BYTES_PER_S:.6g} B/s (H100 SXM data sheet)", file=sys.stderr)
    return 100.0 * bound * launches / expected / sum(t for t, _ in k3)
