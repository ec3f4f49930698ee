"""Metric tracking and history logging (port of the JAX
``train/metrics.py``).

The reference tracks four ``keras.metrics.Mean``s — loss, z_loss, y_loss,
detJ_loss — reset each epoch (TOYcINN_make_model.py:220-246,
conv_cINN_make_model.py:1692-1718) and appends history rows with
``CSVLogger(append=True)`` (conv_cINN.py:529-536). Here: a running-mean
accumulator plus CSV/JSONL writers with a pinned column order (the
reference's CSV column order can change between resumes,
conv_cINN.py:538-554), and Keras-style early stopping whose best weights
are an on-device copy of the parameters.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

import torch

LOSS_KEYS = ("loss", "z_loss", "y_loss", "detJ_loss")


class MeanMetrics:
    """Running means over an epoch for the four loss components."""

    def __init__(self, keys=LOSS_KEYS):
        self.keys = tuple(keys)
        self.reset()

    def reset(self):
        self._sums = {k: 0.0 for k in self.keys}
        self._count = 0

    def update(self, values: Dict[str, float]):
        for k in self.keys:
            self._sums[k] += float(values[k])
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def result(self) -> Dict[str, float]:
        n = max(self._count, 1)
        return {k: self._sums[k] / n for k in self.keys}


class HistoryLogger:
    """Epoch-history logger: in-memory list + optional CSV and JSONL files
    (append mode, surviving resumes). The files are byte for byte those of
    the JAX ``HistoryLogger`` given the same rows."""

    def __init__(self, csv_path: Optional[str] = None, jsonl_path: Optional[str] = None):
        self.rows: List[Dict[str, float]] = []
        self.csv_path = csv_path
        self.jsonl_path = jsonl_path
        self._columns: Optional[List[str]] = None

    def log(self, epoch: int, metrics: Dict[str, float]):
        row = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        self.rows.append(row)
        if self.csv_path:
            self._append_csv(row)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def _append_csv(self, row):
        if self._columns is None:
            if os.path.exists(self.csv_path) and os.path.getsize(self.csv_path):
                with open(self.csv_path) as f:
                    self._columns = next(csv.reader(f))
            else:
                self._columns = list(row.keys())
                with open(self.csv_path, "w", newline="") as f:
                    csv.writer(f).writerow(self._columns)
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(c, "") for c in self._columns])


def clone_params(model) -> Dict[str, torch.Tensor]:
    """An on-device copy of ``model``'s parameters by name (the counterpart
    of the JAX ``_tree_copy``): the train step updates the live tensors in
    place, so keeping references to them would keep nothing."""
    with torch.no_grad():
        return {name: p.detach().clone() for name, p in model.named_parameters()}


def restore_params(model, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` (from :func:`clone_params`) into ``model``'s live
    parameter tensors. In place: a captured CUDA graph holds the tensors'
    addresses, so rebinding them would leave the graph training stale ones."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


class EarlyStopping:
    """Keras-style EarlyStopping(monitor, patience, restore_best_weights=True)
    (TOYcINN.py:118-122, conv_cINN.py:140-141): stop after ``patience``
    consecutive epochs without improvement. ``best_state`` is an on-device
    copy of the best epoch's parameters (:func:`clone_params`)."""

    def __init__(self, patience: int, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.best_state = None
        self.wait = 0

    def update(self, value: float, model) -> bool:
        """Record this epoch's monitored value for ``model``; returns True
        to STOP."""
        if value < self.best - self.min_delta:
            self.best = value
            self.best_state = clone_params(model)
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.patience
