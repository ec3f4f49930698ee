"""The port's toy datasets on the CPU: class-pure batches, each batch slot
once an epoch, per-class moments and standardization statistics against the
JAX package's samplers, and sector points inside their sectors and the unit
disk.

torch's random numbers are not ``jax.random``'s, so the two packages' points
differ draw by draw; they are held to agree in distribution: each moment
within 5 standard errors of the difference at 10^4 points a class."""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.data import toy_datasets as jtoy  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data import toy_datasets as toy  # noqa: E402

N = 10_000


def _moments(pts):
    """(mean, std, standard error of the mean, standard error of the std)
    of each column, the std's error from the fourth central moment."""
    pts = np.asarray(pts, np.float64)
    mean, std = pts.mean(0), pts.std(0)
    m4 = ((pts - mean) ** 4).mean(0)
    se_var = np.sqrt(np.maximum(m4 - std**4, 0.0) / len(pts))
    return mean, std, std / math.sqrt(len(pts)), se_var / np.maximum(2 * std, 1e-12)


def assert_same_distribution(mine, theirs, what):
    m1, s1, em1, es1 = _moments(mine)
    m2, s2, em2, es2 = _moments(theirs)
    for name, a, b, ea, eb in (("mean", m1, m2, em1, em2), ("std", s1, s2, es1, es2)):
        se = np.sqrt(ea**2 + eb**2)
        # a column without spread (a class label) must agree exactly
        ok = np.where(se > 0, np.abs(a - b) <= 5 * se, a == b)
        assert ok.all(), f"{what} {name}: {a} vs {b} (5 standard errors: {5 * se})"


MOON_CLASSES = [(c, o) for o in (False, True) for c in ((0, 1) if not o else (0, 2))]


@pytest.mark.parametrize("class_id,overlapping", MOON_CLASSES)
def test_moon_points_match_jax_in_distribution(class_id, overlapping):
    g = torch.Generator().manual_seed(class_id + 10 * overlapping)
    mine = toy._moon_points(g, N, class_id, 0.05, overlapping).numpy()
    theirs = np.asarray(jtoy._moon_points(jax.random.PRNGKey(class_id), N, class_id, 0.05,
                                          overlapping))
    assert mine.shape == theirs.shape == (N, 2) and mine.dtype == np.float32
    assert_same_distribution(mine, theirs, f"moon {class_id} overlapping={overlapping}")


@pytest.mark.parametrize("shape", range(len(toy.MIXED_CLASS_NAMES)))
def test_mixed_shapes_match_jax_in_distribution(shape):
    g = torch.Generator().manual_seed(shape)
    mine = toy._MIXED_SAMPLERS[shape](g, N).numpy()
    theirs = np.asarray(jtoy._MIXED_SAMPLERS[shape](jax.random.PRNGKey(shape), N))
    assert toy.MIXED_CLASS_NAMES[shape] == jtoy.MIXED_CLASS_NAMES[shape]
    assert mine.shape == theirs.shape == (N, 2)
    assert_same_distribution(mine, theirs, toy.MIXED_CLASS_NAMES[shape])


@pytest.mark.parametrize("make", [
    pytest.param(lambda m: m.make_moons_dataset(), id="crescents"),
    pytest.param(lambda m: m.make_moons_dataset(overlapping=True), id="crescents_overlapping"),
    pytest.param(lambda m: m.make_mixed_dataset([0, 1, 4]), id="mixed"),
])
def test_standardization_stats_match_jax(make):
    """Both packages standardize with statistics of 10^4 points a class
    (seed 1234, each its own RNG): the labels' exactly, the points' within
    5 standard errors of the difference of two such estimates."""
    mine, theirs = make(toy), make(jtoy)
    assert mine.class_labels == theirs.class_labels
    # the standard errors of one such estimate, from a pooled draw of its size
    g = torch.Generator().manual_seed(1)
    pooled = np.concatenate([mine.raw_points(g, i, N).numpy()
                             for i in range(len(mine.class_labels))])
    _, _, se_mean, se_std = _moments(pooled)
    for i in range(2):
        assert abs(mine.mean[i] - theirs.mean[i]) <= 5 * math.sqrt(2) * se_mean[i], (
            i, mine.mean, theirs.mean)
        assert abs(mine.std[i] - theirs.std[i]) <= 5 * math.sqrt(2) * se_std[i], (
            i, mine.std, theirs.std)
    np.testing.assert_allclose(mine.mean[2], theirs.mean[2], rtol=1e-6)
    np.testing.assert_allclose(mine.std[2], theirs.std[2], rtol=1e-6)
    # a standardized class batch has the raw class moments, standardized
    g = torch.Generator().manual_seed(0)
    batch = mine.sample_class_batch(g, 1, N).numpy()
    labs = (np.asarray(mine.class_labels[1]) - mine.mean[2]) / mine.std[2]
    np.testing.assert_allclose(batch[:, 2], labs, rtol=1e-6)
    want = np.asarray(theirs.sample_class_batch(jax.random.PRNGKey(0), 1, N))
    assert_same_distribution(batch[:, :2] * np.asarray(mine.std[:2]) + np.asarray(mine.mean[:2]),
                             want[:, :2] * np.asarray(theirs.std[:2])
                             + np.asarray(theirs.mean[:2]), "class 1, raw")


@pytest.mark.parametrize("ds", [toy.make_moons_dataset(), toy.make_mixed_dataset([0, 1, 4])],
                         ids=["crescents", "mixed"])
def test_epochs_are_class_pure_with_each_slot_once(ds):
    n_classes, per_class, b = len(ds.class_labels), 3, 16
    g = torch.Generator().manual_seed(0)
    batches = list(ds.epoch_iterator(g, per_class, b))
    assert len(batches) == per_class * n_classes
    labs = [(np.asarray(lab) - ds.mean[2]) / ds.std[2] for lab in ds.class_labels]
    seen = []
    for batch in batches:
        assert batch.shape == (b, 3) and batch.dtype == torch.float32
        y = batch[:, 2].numpy()
        assert np.all(y == y[0]), "a batch mixes classes"
        seen.append(int(np.argmin([abs(y[0] - lab) for lab in labs])))
    assert sorted(seen) == sorted(list(range(n_classes)) * per_class)
    # the order is shuffled: over a few epochs it is not always sorted by slot
    orders = [ds._slot_order(g, per_class) for _ in range(4)]
    assert all(sorted(o) == list(range(per_class * n_classes)) for o in orders)
    assert any(o != sorted(o) for o in orders)
    arr = ds.epoch_array(g, per_class, b)
    assert arr.shape == (per_class * n_classes, b, 3)
    assert all(bool((a[:, 2] == a[0, 2]).all()) for a in arr)


def _angle_error(x, center):
    ang = np.arctan2(x[:, 1], x[:, 0])
    return np.abs((ang - center + np.pi) % (2 * np.pi) - np.pi)


def test_sector_points_lie_in_their_sector_and_the_unit_disk():
    g = torch.Generator().manual_seed(0)
    width = np.pi / 4
    pts = toy.sample_continuous_sectors(g, N, width).numpy()
    assert pts.shape == (N, 3)
    assert np.all(np.hypot(pts[:, 0], pts[:, 1]) <= 1.0 + 1e-6)
    assert np.all(_angle_error(pts, pts[:, 2]) <= width / 2 + 1e-5)
    assert np.all((pts[:, 2] >= 0) & (pts[:, 2] < 2 * np.pi))
    theirs = np.asarray(jtoy.sample_continuous_sectors(jax.random.PRNGKey(0), N, width))
    assert_same_distribution(pts, theirs, "continuous sectors")
    centers = [0.0, 1.0, 4.0]
    for c, s in zip(centers, toy.sample_discrete_sectors(g, 500, centers, width)):
        s = s.numpy()
        assert s.shape == (500, 3) and np.all(s[:, 2] == np.float32(c))
        assert np.all(np.hypot(s[:, 0], s[:, 1]) <= 1.0 + 1e-6)
        assert np.all(_angle_error(s, c) <= width / 2 + 1e-5)
