"""The device's idle share of the traced window, in %: 1 - the union of
the card's operation intervals (rank 0's card in a multi-process cell) over
the window (``trace.py``)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
