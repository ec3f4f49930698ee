"""Image datasets and the class-conditional and super-resolution batch
sources (port of the JAX ``data/images.py``).

- class-conditional ("DISCRETE"): per-class sources, each truncated to a
  multiple of the batch size so every batch is CLASS-PURE
  (conv_cINN.py:271-304); optional fudged-logit pixel transform; the class
  label becomes a constant H x W x 1 plane concatenated onto x
  (conv_cINN.py:250-268); labels are the class INDICES rescaled to [0,1]
  (conv_cINN.py:222-228); the permanent 2% instance-noise floor
  (alpha=0.98, conv_cINN.py:307-315) is drawn anew every epoch;
- super-resolution ("CONTINUOUS"): one combined source mapped through the
  down/up resampling pairs of :func:`preprocess_sr`, with an optional
  residual target (conv_cINN_base_functions.py:233-279), shuffled at the
  example level, with the same noise floor.

Each source's ``epoch_distributed(generator, num_shards, shard_id)`` is one
process's slice of a multi-process epoch (JAX ``data/images.py:249-290,
327-355``): every process draws the same order, permutation and noise from
an identically seeded generator, so the generators stay in lockstep, and
keeps its own slot of each global batch group; ``epoch`` is its
``num_shards == 1`` case, so the two agree bit for bit.

Dataset acquisition: a cached ``mnist.npz``/``fashion_mnist.npz`` archive is
used when present (nothing is downloaded); otherwise :func:`synthetic_digits`
gives a deterministic class-structured stand-in with the same shapes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from arl_conditional_normalizing_flows_tpu_torch.ops import resample
from arl_conditional_normalizing_flows_tpu_torch.ops.logit import logitify_np


# ---------------------------------------------------------------------------
# acquisition
# ---------------------------------------------------------------------------


def _find_cached_mnist(name: str) -> Optional[str]:
    """A cached keras-format archive (``{x,y}_{train,test}`` arrays, the
    layout keras.datasets.mnist.load_data caches, create_tfrecords.py:76-88):
    ``$ARL_CNF_DATA_DIR/<name>.npz`` first, then keras's cache directory."""
    bases = []
    env = os.environ.get("ARL_CNF_DATA_DIR")
    if env:
        bases.append(env)
    bases.append(os.path.expanduser("~/.keras/datasets"))
    for base in bases:
        p = os.path.join(base, f"{name}.npz")
        if os.path.exists(p):
            return p
    return None


def synthetic_digits(
    num_per_class: int = 256,
    num_classes: int = 10,
    size: int = 28,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped synthetic data: each class is a distinct
    blob/stroke pattern with jitter, pixel values in [0,1], mostly-zero
    background (so the 2% noise-floor rationale applies just as it does to
    MNIST, conv_cINN.py:309). The same arrays as the JAX function's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    images, labels = [], []
    for c in range(num_classes):
        ang = 2 * np.pi * c / num_classes
        cx, cy = 0.5 + 0.25 * np.cos(ang), 0.5 + 0.25 * np.sin(ang)
        for _ in range(num_per_class):
            jx, jy = rng.normal(0, 0.03, 2)
            sigma = 0.08 + 0.02 * (c % 3)
            blob = np.exp(
                -(((xx - cx - jx) ** 2) + ((yy - cy - jy) ** 2)) / (2 * sigma**2)
            )
            # a class-dependent stroke through the centre
            t = np.abs(
                np.cos(ang) * (yy - 0.5) - np.sin(ang) * (xx - 0.5)
            )
            stroke = np.exp(-(t**2) / (2 * 0.03**2)) * (c % 2 == 0)
            img = np.clip(blob + 0.6 * stroke, 0.0, 1.0)
            images.append(img.astype(np.float32))
            labels.append(c)
    images = np.stack(images)[..., None]
    labels = np.asarray(labels, np.int32)
    perm = rng.permutation(len(labels))
    return images[perm], labels[perm]


def load_image_dataset(
    name: str = "mnist", split: str = "train", synthetic_fallback: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(images in [0,1] shaped (N, 28, 28, 1), int labels): a cached npz
    archive when one is found, else synthesised."""
    path = _find_cached_mnist(name)
    if path is not None:
        with np.load(path, allow_pickle=False) as d:
            if split == "train":
                x, y = d["x_train"], d["y_train"]
            else:
                x, y = d["x_test"], d["y_test"]
        x = (x.astype(np.float32) / 255.0)[..., None] if x.ndim == 3 else x
        return x, y.astype(np.int32)
    if not synthetic_fallback:
        raise FileNotFoundError(f"no cached archive for {name}")
    n = 256 if split == "train" else 64
    return synthetic_digits(num_per_class=n, seed=0 if split == "train" else 1)


def class_labels_01(num_classes: int) -> np.ndarray:
    """Evenly spaced class labels rescaled to [0,1] (conv_cINN.py:222-228)."""
    idx = np.arange(num_classes, dtype=np.float32)
    return idx / max(idx[-1], 1.0)


def preprocess_sr(x_hires, model_type: str, residual: bool = True):
    """SR pair construction (conv_cINN_base_functions.py:233-279), on a
    tensor or numpy array of high-res images (..., H, W, D); returns a
    tensor xy = concat([x, y], -1).

    'SR4,2': x = down(hires) (14x14), y = up(down(down(hires)));
    'SR2,1': x = hires (28x28),       y = up(down(hires)).
    With ``residual``, x -= y (2x2 blocks of the residual sum to ~0,
    conv_cINN.py:44-45).
    """
    x_hires = torch.as_tensor(x_hires)
    if model_type == "SR4,2":
        x = resample.down(x_hires)
        y = resample.up(resample.down(resample.down(x_hires)))
    elif model_type == "SR2,1":
        x = x_hires
        y = resample.up(resample.down(x_hires))
    else:
        raise ValueError(f"unknown SR model_type {model_type!r}")
    if residual:
        x = x - y
    return torch.cat([x, y], dim=-1)


# ---------------------------------------------------------------------------
# epoch feeders
# ---------------------------------------------------------------------------


def class_slot_groups(class_slots, num_shards: int):
    """Class-pure slot groups for ``num_shards`` processes: each group is
    ``num_shards`` consecutive slots of ONE class (``class_slots``: each
    class's slots, in order), so the global batch the processes' slots make
    stays class-pure, the multi-process form of the reference's
    class-segregated batching (conv_cINN.py:271-304). A class's remainder of
    fewer than ``num_shards`` slots is dropped."""
    groups = []
    for slots in class_slots:
        slots = list(slots)
        for g in range(len(slots) // num_shards):
            groups.append(slots[g * num_shards:(g + 1) * num_shards])
    return groups


def check_shard(num_shards: int, shard_id: int) -> None:
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard {shard_id} is not in [0, {num_shards})")


def shard_noise(generator, shape, num_shards: int, shard_id: int, dtype=torch.float32):
    """Shard ``shard_id``'s rows of one N(0,1) draw for all ``num_shards``
    slots of a global batch group, ``(num_shards * shape[0], *shape[1:])``
    in slot order: every process makes the same draw, so that the
    generators stay in lockstep. With one shard it is the plain draw of
    ``shape``."""
    b = shape[0]
    eps = torch.randn((num_shards * b,) + tuple(shape[1:]), generator=generator, dtype=dtype,
                      device=generator.device)
    return eps[shard_id * b:(shard_id + 1) * b]


@dataclasses.dataclass
class ClassConditionalSource:
    """Class-pure batch feeder for discrete (class) conditioning."""

    images: np.ndarray  # (N, H, W, 1) in [0,1]
    labels: np.ndarray  # (N,) ints
    which_classes: Sequence[int]
    batch_size: int
    use_logits: bool = False
    logit_a: float = 0.01
    noise_floor_alpha: float = 0.98

    def __post_init__(self):
        self.which_classes = [int(c) for c in self.which_classes]
        label_values = class_labels_01(len(self.which_classes))
        xs, ys = [], []
        for i, c in enumerate(self.which_classes):
            x = self.images[self.labels == c]
            # truncate to a multiple of batch_size -> class-pure batches
            # (conv_cINN.py:271-304)
            n = (len(x) // self.batch_size) * self.batch_size
            x = np.asarray(x[:n], np.float32)
            if self.use_logits:
                x = logitify_np(x, self.logit_a)
            xs.append(x)
            ys.append(np.full((n,), label_values[i], np.float32))
        if not all(len(x) > 0 for x in xs):
            raise ValueError(
                "a class has fewer images than batch_size - it would contribute ZERO "
                "class-pure batches (per-class truncation, conv_cINN.py:271-304); "
                f"per-class counts: {[len(x) for x in xs]}, batch_size={self.batch_size}")
        self._x = np.concatenate(xs)
        self._y = np.concatenate(ys)
        # per-class row ranges: batch membership is reshuffled within each
        # class every epoch (the reference reshuffles examples per
        # iteration, conv_cINN.py:271-304)
        bounds, start = [], 0
        for x in xs:
            bounds.append((start, start + len(x)))
            start += len(x)
        self._class_bounds = bounds
        self.num_batches = len(self._x) // self.batch_size
        h, w = self._x.shape[1:3]
        self.xy_shape = (h, w, self._x.shape[3] + 1)
        self._on_device = {}

    def _arrays(self, device):
        """The examples and their labels on ``device``, moved there once."""
        if device not in self._on_device:
            self._on_device[device] = (torch.from_numpy(self._x).to(device),
                                       torch.from_numpy(self._y).to(device))
        return self._on_device[device]

    def epoch(self, generator):
        """Yield the epoch's shuffled class-pure xy batches ``(B, H, W, 2)``
        on the generator's device, with a fresh noise floor. Everything
        random — the batch order, the example shuffle within each class, the
        noise — is drawn from ``generator``, whose state carries one epoch
        to the next (JAX keys each epoch with ``fold_in(key, epoch)``, so
        the order is not JAX's)."""
        return self.epoch_distributed(generator, 1, 0)

    def slot_groups(self, num_shards: int):
        """The class-pure slot groups of a ``num_shards``-process epoch
        (:func:`class_slot_groups`), JAX's list for list."""
        b = self.batch_size
        return class_slot_groups([range(s // b, e // b) for s, e in self._class_bounds],
                                 num_shards)

    def epoch_distributed(self, generator, num_shards: int, shard_id: int):
        """Process ``shard_id``'s slice of a ``num_shards``-process epoch: the
        global batches are the slot groups (:meth:`slot_groups`) in an order
        drawn from ``generator``, and this process yields its slot of each.
        The draws: the group order, the example shuffle within each class,
        then for each group the noise of all its rows (:func:`shard_noise`).
        With ``num_shards == 1`` this is :meth:`epoch`."""
        check_shard(num_shards, shard_id)
        groups = self.slot_groups(num_shards)
        if not groups:
            raise ValueError(
                f"no class has {num_shards} class-pure batches an epoch: every global batch "
                "group would be empty (per-class slot counts: "
                f"{[(e - s) // self.batch_size for s, e in self._class_bounds]})")
        device = generator.device
        x_all, y_all = self._arrays(device)
        b = self.batch_size
        h, w = self.xy_shape[:2]
        order = torch.randperm(len(groups), generator=generator, device=device).tolist()
        # example-level shuffle within each class: slots stay class-pure
        # (class ranges are multiples of batch_size) but change membership
        perm = torch.cat([s + torch.randperm(e - s, generator=generator, device=device)
                          for s, e in self._class_bounds])
        a = self.noise_floor_alpha
        for gi in order:
            slot = groups[gi][shard_id]
            idx = perm[slot * b:(slot + 1) * b]
            yplane = y_all[idx].view(b, 1, 1, 1).expand(b, h, w, 1)
            xy = torch.cat([x_all[idx], yplane], dim=-1)
            if a < 1.0:
                xy = a * xy + (1 - a) * shard_noise(generator, xy.shape, num_shards, shard_id,
                                                    xy.dtype)
            yield xy


@dataclasses.dataclass
class SRSource:
    """Example-shuffled batch feeder for continuous (super-resolution)
    conditioning (conv_cINN.py:412-508)."""

    images: np.ndarray  # (N, H, W, 1) hires in [0,1]
    model_type: str  # 'SR4,2' | 'SR2,1'
    batch_size: int
    residual: bool = True
    noise_floor_alpha: float = 0.98

    def __post_init__(self):
        xy = preprocess_sr(np.asarray(self.images, np.float32), self.model_type, self.residual)
        n = (len(xy) // self.batch_size) * self.batch_size
        if n == 0:
            raise ValueError(f"dataset ({len(xy)} examples) smaller than batch_size "
                             f"({self.batch_size}) - zero batches")
        self._xy = xy[:n].contiguous()
        self.num_batches = n // self.batch_size
        self.xy_shape = tuple(self._xy.shape[1:])
        self._on_device = {}

    def epoch(self, generator):
        """Yield the epoch's shuffled xy batches ``(B, H, W, 2*D)`` on the
        generator's device, with a fresh noise floor. The permutation and
        the noise are drawn from ``generator``, as
        :meth:`ClassConditionalSource.epoch` draws them (so not JAX's
        order)."""
        return self.epoch_distributed(generator, 1, 0)

    def epoch_distributed(self, generator, num_shards: int, shard_id: int):
        """Process ``shard_id``'s slice of a ``num_shards``-process epoch:
        each global batch is ``num_shards`` consecutive batches of the
        shared example permutation (SR conditioning is continuous, with no
        class to keep pure, conv_cINN.py:412-508), this process's the
        ``shard_id``-th; a trailing group of fewer is dropped. With
        ``num_shards == 1`` this is :meth:`epoch`."""
        check_shard(num_shards, shard_id)
        num_groups = self.num_batches // num_shards
        if num_groups == 0:
            raise ValueError(f"{self.num_batches} batches an epoch are fewer than the "
                             f"{num_shards} processes: every global batch would be empty")
        device = generator.device
        if device not in self._on_device:
            self._on_device[device] = self._xy.to(device)
        xy_all = self._on_device[device]
        order = torch.randperm(len(xy_all), generator=generator, device=device)
        b, a = self.batch_size, self.noise_floor_alpha
        for g in range(num_groups):
            i = g * num_shards + shard_id
            xy = xy_all[order[i * b:(i + 1) * b]]
            if a < 1.0:
                xy = a * xy + (1 - a) * shard_noise(generator, xy.shape, num_shards, shard_id,
                                                    xy.dtype)
            yield xy
