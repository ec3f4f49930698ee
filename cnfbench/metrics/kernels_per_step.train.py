"""CUDA kernels a train step: the kernel records of the traced window
(copies and sets left out) over its steps (rank 0's card)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["kernels"] / record["steps"]
