"""NCCL's exchange a train step, in microseconds, without the wait for the
slowest process: the gradient all-reduce inside each step, with the loss's
mean and the harness's one-float broadcast once a call. Every process's
traced window holds its NCCL kernels in the order they ran, the same
collectives on every process; a collective's exchange is its least device
time over the processes (the last to arrive waits for no one). Those are
summed over the window and divided by its steps. A run of one process
records no collectives and reads nothing."""

import sys


def read(record):
    ranks = record.get("collectives_by_rank")
    if record.get("kind") != "train" or not ranks or not all(ranks):
        return None
    times = [[t for _, t in c] for c in ranks]
    if len({len(t) for t in times}) == 1:
        exchange = sum(min(each) for each in zip(*times))
    else:  # a record lost: the least process's total, which is no less
        exchange = min(sum(t) for t in times)
    steps = record["steps"]
    print(f"nccl_us_per_step.dp4: NCCL kernels a process {[len(t) for t in times]}; "
          f"NCCL us a step by process, with the wait for the slowest: "
          + " ".join(f"{1e6 * sum(t) / steps:.3f}" for t in times), file=sys.stderr)
    return 1e6 * exchange / steps
