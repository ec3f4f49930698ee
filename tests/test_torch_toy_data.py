"""The port's toy datasets on the CPU: class-pure batches, each batch slot
once an epoch, per-class moments and standardization statistics against the
JAX package's samplers, and sector points inside their sectors and the unit
disk.

torch's random numbers are not ``jax.random``'s, so the two packages' points
differ draw by draw; they are held to agree in distribution: each moment
within 5 standard errors of the difference at 10^4 points a class. The
standardization statistics at the drivers' defaults are JAX's own, pinned
(ROADMAP C.4), and held to JAX's ``_standardize_stats`` bit for bit; other
settings keep the port's own draw, held in distribution."""

import math

import jax
import jax.numpy as jnp
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


#: the drivers' defaults (JAX drivers/toy.py:30-32), whose statistics the
#: port pins to JAX's
PINNED = [
    pytest.param(lambda m: m.make_moons_dataset(), ("crescents", 0.05, False), id="crescents"),
    pytest.param(lambda m: m.make_moons_dataset(overlapping=True), ("crescents", 0.05, True),
                 id="crescents_overlapping"),
    pytest.param(lambda m: m.make_mixed_dataset([0, 1, 4]), ("mixed", (0, 1, 4)), id="mixed"),
]


@pytest.mark.parametrize("make,key", PINNED)
def test_pinned_stats_equal_jax_bit_for_bit(make, key):
    """At the drivers' defaults the port standardizes with JAX's statistics:
    each pinned float32 constant equals JAX's ``_standardize_stats`` (its
    jax.random draw seeded 1234) bit for bit, and the dataset uses them."""
    theirs = make(jtoy)
    raw = {("crescents", 0.05, False): lambda k, i, n: jtoy._moon_points(k, n, i, 0.05, False),
           ("crescents", 0.05, True): lambda k, i, n: jtoy._moon_points(k, n, 2 * i, 0.05, True),
           ("mixed", (0, 1, 4)): lambda k, i, n: jtoy._MIXED_SAMPLERS[(0, 1, 4)[i]](k, n)}[key]
    mean, std = jtoy._standardize_stats(raw, theirs.class_labels)
    pinned = [np.asarray([float.fromhex(v) for v in col], np.float32)
              for col in toy.PINNED_STATS[key]]
    for got, want in zip(pinned, (mean, std)):
        want = np.asarray(want, np.float32)
        assert got.tobytes() == want.tobytes(), (key, got, want)
    mine = make(toy)
    assert mine.stats_pinned and mine.class_labels == theirs.class_labels
    np.testing.assert_array_equal(np.asarray(mine.mean, np.float32), mean)
    np.testing.assert_array_equal(np.asarray(mine.std, np.float32), std)
    g = torch.Generator().manual_seed(0)
    batch = mine.sample_class_batch(g, 1, 8).numpy()
    want_y = np.asarray((jnp.float32(theirs.class_labels[1]) - jnp.asarray(theirs.mean[2]))
                        / jnp.asarray(theirs.std[2]))
    assert np.all(batch[:, 2] == want_y)


def test_other_settings_draw_their_own_stats_and_the_toy_driver_says_so(tmp_path, capsys):
    from arl_conditional_normalizing_flows_tpu_torch.drivers import toy as cnf_toy

    assert not toy.make_moons_dataset(noise=0.1).stats_pinned
    assert not toy.make_mixed_dataset([0, 1]).stats_pinned
    flags = ["--cpu", "--coupling-blocks", "1", "--intermediate-dims", "4", "--num-layers",
             "1", "--batch-size", "16", "--batches-per-class", "1", "--eval-samples", "8",
             "--epochs", "1", "--annealing-epochs", "0"]
    cnf_toy.main(flags + ["--outdir", str(tmp_path / "a")])
    assert "standardization statistics drawn by the port" not in capsys.readouterr().out
    cnf_toy.main(flags + ["--noise", "0.1", "--outdir", str(tmp_path / "b")])
    assert "standardization statistics drawn by the port" in capsys.readouterr().out


@pytest.mark.parametrize("make", [
    pytest.param(lambda m: m.make_moons_dataset(noise=0.1), id="crescents"),
    pytest.param(lambda m: m.make_moons_dataset(noise=0.1, overlapping=True),
                 id="crescents_overlapping"),
    pytest.param(lambda m: m.make_mixed_dataset(range(7)), id="mixed"),
])
def test_standardization_stats_match_jax(make):
    """Off the pinned defaults both packages standardize with statistics of
    10^4 points a class (seed 1234, each its own RNG): the labels' exactly,
    the points' within 5 standard errors of the difference of two such
    estimates."""
    mine, theirs = make(toy), make(jtoy)
    assert not mine.stats_pinned
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
