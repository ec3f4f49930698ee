"""Toy 2-D point-cloud datasets as batch samplers on the generator's device
(port of the JAX ``data/toy_datasets.py``; the reference's
TOYcINN_make_datasets.py).

Each dataset is a function ``(generator, class_index, n) -> (n, 3)`` that
draws fresh points every call (the reference's reason for generator
datasets, TOYcINN_make_datasets.py:146-147); an epoch is a permutation of
class-pure batch slots. Every function takes an explicit
``torch.Generator`` and draws on its device.

CRITICAL batching invariant kept from the reference: every batch is
CLASS-PURE (data is batched before shuffling, so each class maps
independently to the full N(0,1) prior, TOYcINN_make_datasets.py:30,
:265-268).

Standardization statistics (TOYcINN_make_datasets.py:108-126): at the
drivers' defaults (crescents and overlapping crescents at noise 0.05, the
mixed shapes 0, 1 and 4) they are the JAX package's own, pinned as float32
constants (:data:`PINNED_STATS`, held bit for bit to JAX's
``_standardize_stats`` by ``tests/test_torch_toy_data.py``), so that a
JAX-trained model sees the inputs it was trained on. Any other setting
draws them once from 10^4 points a class on the CPU from a ``torch.Generator``
seeded 1234: torch's random numbers are not ``jax.random``'s, so those
statistics differ from JAX's (by up to 2% of a std) and agree only in
distribution; ``ToyDataset.stats_pinned`` says which. The points themselves
are torch's draws everywhere. ``epoch_iterator_distributed`` (the
multi-host epoch) waits for multi-device runs (ROADMAP A.10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import torch

PI = math.pi

# noise scales (TOYcINN_make_datasets.py:317-322)
CIRCLE_NOISE = 0.05
SLASH_NOISE = 0.05
BLOBS_NOISE = 0.15
THREE_NOISE = 0.05
GRID_NOISE = 0.05
CCIRC_NOISE = 0.05
CCIRC_FACTOR = 0.6

MIXED_CLASS_NAMES = (
    "circle",
    "slash",
    "blobs",
    "three",
    "square",
    "grid",
    "concentric_circles",
)


# ---------------------------------------------------------------------------
# per-class point samplers (vectorized over n points)
# ---------------------------------------------------------------------------


def _uniform(g, shape, low, high):
    return low + (high - low) * torch.rand(shape, generator=g, device=g.device)


def _normal(g, shape):
    return torch.randn(shape, generator=g, device=g.device)


def _signs(g, n):
    """+-1.0 with equal odds."""
    return 2.0 * torch.randint(0, 2, (n,), generator=g, device=g.device).float() - 1.0


def _moon_points(g, n, class_id, noise, overlapping):
    """One crescent (TOYcINN_make_datasets.py:149-209). class_id 0 = left
    concave-down; 1/2 = right concave-up (2 = shifted to overlap)."""
    angle = _uniform(g, (n,), 0.0, PI)
    if class_id == 0:
        x0, x1 = torch.cos(angle), torch.sin(angle)
    elif not overlapping:
        x0, x1 = 1.0 - torch.cos(angle), 1.0 - torch.sin(angle) - 0.5
    else:
        x0, x1 = 1.0 - torch.cos(angle), 1.0 - torch.sin(angle) + 0.25
    return torch.stack([x0, x1], dim=-1) + noise * _normal(g, (n, 2))


def _circle_points(g, n):
    angle = _uniform(g, (n,), 0.0, 2 * PI)
    pts = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    return pts + CIRCLE_NOISE * _normal(g, (n, 2))


def _slash_points(g, n):
    line = _uniform(g, (n,), -1.0, 1.0)
    return torch.stack([line, line], dim=-1) + SLASH_NOISE * _normal(g, (n, 2))


def _blobs_points(g, n):
    sign = _signs(g, n)
    pts = torch.stack([-0.5 * sign, 0.5 * sign], dim=-1)
    return pts + BLOBS_NOISE * _normal(g, (n, 2))


def _three_points(g, n):
    which = _signs(g, n)
    angle = _uniform(g, (n,), 0.0, PI)
    x0 = (torch.cos(angle) + which) / 2.0
    x1 = torch.sin(angle) * 2.0 - 1.0
    return torch.stack([x0, x1], dim=-1) + THREE_NOISE * _normal(g, (n, 2))


def _square_points(g, n):
    return _uniform(g, (n, 2), -1.0, 1.0)


def _grid_points(g, n):
    which = torch.randint(-1, 2, (n, 2), generator=g, device=g.device).float()
    return 0.8 * which + GRID_NOISE * _normal(g, (n, 2))


def _ccirc_points(g, n):
    angle = _uniform(g, (n,), 0.0, 2 * PI)
    inner = torch.randint(0, 2, (n,), generator=g, device=g.device) > 0
    r = torch.where(inner, CCIRC_FACTOR, 1.0)
    pts = torch.stack([r * torch.cos(angle), r * torch.sin(angle)], dim=-1)
    return pts + CCIRC_NOISE * _normal(g, (n, 2))


_MIXED_SAMPLERS = (
    _circle_points,
    _slash_points,
    _blobs_points,
    _three_points,
    _square_points,
    _grid_points,
    _ccirc_points,
)


def _sector_points(g, n, center, sector_width):
    """Uniform point in a unit-circle sector centred at angle ``center``
    (TOYcINN_make_datasets.py:1137-1176)."""
    angle = _uniform(g, (n,), center - sector_width / 2, center + sector_width / 2)
    radius = torch.sqrt(torch.rand(n, generator=g, device=g.device))
    return torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)], dim=-1)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ToyDataset:
    """A class-conditional toy dataset: class-pure batch sampler plus the
    dataset-level standardization stats. ``raw_points(generator,
    class_index, n)`` draws unstandardized (n, 2) points of one class."""

    name: str
    class_labels: Tuple[float, ...]  # raw (pre-standardization) label values
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    #: True when mean and std are JAX's pinned statistics, False when drawn
    #: by the port
    stats_pinned: bool = False
    raw_points: Callable = dataclasses.field(compare=False, repr=False, default=None)

    def sample_class_batch(self, generator, class_index, batch_size):
        """One class-pure standardized batch, (batch_size, 3) float32 on the
        generator's device."""
        device = generator.device
        pts = self.raw_points(generator, int(class_index), batch_size)
        lab = torch.full((batch_size, 1), self.class_labels[int(class_index)], device=device)
        xy = torch.cat([pts, lab], dim=1)
        mean = torch.tensor(self.mean, device=device)
        std = torch.tensor(self.std, device=device)
        return (xy - mean) / std

    def _slot_order(self, generator, num_batches_per_class):
        """The epoch's batch slots in shuffled order; slot s holds class
        ``s % n_classes``, so each class fills ``num_batches_per_class``."""
        num_batches = num_batches_per_class * len(self.class_labels)
        return torch.randperm(num_batches, generator=generator,
                              device=generator.device).tolist()

    def epoch_iterator(self, generator, num_batches_per_class, batch_size):
        """Yield class-pure batches in shuffled order: the reference's
        batch-then-shuffle (TOYcINN_make_datasets.py:265-268)."""
        n_classes = len(self.class_labels)
        for slot in self._slot_order(generator, num_batches_per_class):
            yield self.sample_class_batch(generator, slot % n_classes, batch_size)

    def epoch_array(self, generator, num_batches_per_class, batch_size):
        """Whole epoch at once: (num_batches, batch_size, 3), batches
        class-pure, order shuffled."""
        return torch.stack(list(self.epoch_iterator(generator, num_batches_per_class,
                                                    batch_size)))


#: JAX's ``_standardize_stats`` (``jax.random.PRNGKey(1234)``, 10^4 points a
#: class) at the drivers' defaults, as float32 values in ``float.hex``:
#: (mean, std) of the (x0, x1, label) columns, keyed by dataset and setting
PINNED_STATS = {
    ("crescents", 0.05, False): (
        ("0x1.f37130p-2", "0x1.fd77fap-3", "0x1.000000p-1"),
        ("0x1.bd295cp-1", "0x1.fddb34p-2", "0x1.000000p-1")),
    ("crescents", 0.05, True): (
        ("0x1.f37130p-2", "0x1.3f5e48p-1", "0x1.000000p+0"),
        ("0x1.bd295cp-1", "0x1.403e48p-2", "0x1.000000p+0")),
    ("mixed", (0, 1, 4)): (
        ("-0x1.cef622p-12", "-0x1.09efe6p-7", "0x1.000000p+0"),
        ("0x1.3f8b2cp-1", "0x1.403972p-1", "0x1.a20bd8p-1")),
}


def _stats(key, raw_points, labels):
    """(mean, std, pinned): JAX's pinned statistics for ``key``, else the
    port's own draw."""
    if key in PINNED_STATS:
        mean, std = (tuple(float.fromhex(v) for v in col) for col in PINNED_STATS[key])
        return mean, std, True
    return (*_standardize_stats(raw_points, labels), False)


def _standardize_stats(raw_points, labels, n=10_000, seed=1234):
    """Dataset mean/std from one large draw on the CPU
    (TOYcINN_make_datasets.py:108-126); population std, as ``np.std``."""
    g = torch.Generator().manual_seed(seed)
    rows = []
    for i, lab in enumerate(labels):
        pts = raw_points(g, i, n)
        rows.append(torch.cat([pts, torch.full((n, 1), lab)], dim=1))
    xy = torch.cat(rows).double()
    mean = xy.mean(0).float().tolist()
    std = xy.std(0, correction=0).float().tolist()
    return tuple(mean), tuple(std)


def make_moons_dataset(noise=0.05, overlapping=False) -> ToyDataset:
    """Crescents (TOYcINN_make_datasets.py:17-270). Classes: 0 = left moon;
    1 (or 2 when overlapping) = right moon."""
    labels = (0.0, 2.0) if overlapping else (0.0, 1.0)

    def raw_points(g, class_index, n):
        class_id = 0 if class_index == 0 else (2 if overlapping else 1)
        return _moon_points(g, n, class_id, noise, overlapping)

    mean, std, pinned = _stats(("crescents", float(noise), bool(overlapping)), raw_points,
                               labels)
    return ToyDataset("crescents", labels, mean, std, pinned, raw_points)


def make_mixed_dataset(which_classes: Sequence[int]) -> ToyDataset:
    """Mixed shapes (TOYcINN_make_datasets.py:274-1110). ``which_classes``
    selects shapes 0-6; training labels are the REMAPPED indices 0..N-1 so
    they are evenly spaced (TOYcINN_make_datasets.py:338-344)."""
    which = tuple(int(c) for c in which_classes)
    labels = tuple(float(i) for i in range(len(which)))

    def raw_points(g, class_index, n):
        return _MIXED_SAMPLERS[which[class_index]](g, n)

    mean, std, pinned = _stats(("mixed", which), raw_points, labels)
    return ToyDataset("mixed", labels, mean, std, pinned, raw_points)


def sample_continuous_sectors(generator, num_points, sector_width):
    """Continuous-condition dataset: y ~ U[0, 2pi), x uniform in the sector
    centred at y (TOYcINN_make_datasets.py:1114-1205). NOT standardized
    (the reference skips it, :1177-1178). Returns (num_points, 3)."""
    g = generator
    y = _uniform(g, (num_points,), 0.0, 2 * PI)
    angle = y + _uniform(g, (num_points,), -sector_width / 2, sector_width / 2)
    radius = torch.sqrt(torch.rand(num_points, generator=g, device=g.device))
    return torch.stack([radius * torch.cos(angle), radius * torch.sin(angle), y], dim=-1)


def sample_discrete_sectors(generator, num_points_per_sector, which_sectors, sector_width):
    """Pinned-condition sectors for eval sweeps
    (TOYcINN_make_datasets.py:1207-1300). Returns a list of per-sector
    class-pure batches, each (num_points_per_sector, 3)."""
    out = []
    for center in which_sectors:
        pts = _sector_points(generator, num_points_per_sector, center, sector_width)
        lab = torch.full((num_points_per_sector, 1), float(center), device=generator.device)
        out.append(torch.cat([pts, lab], dim=1))
    return out
