"""The port's data slice on the CPU: ``synthetic_digits``,
``load_image_dataset``, ``class_labels_01``, ``logitify_np``, the SR
resampling and ``preprocess_sr`` against the JAX package's;
``ClassConditionalSource``'s batches (class-pure, the right shape, the noise
floor, every example once an epoch) and ``SRSource``'s; and
``evaluation/stats.py`` against JAX's on the same arrays. Batch orders and
noise are drawn from a ``torch.Generator``, so they are not JAX's; the
semantics are."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.data import images as jimages  # noqa: E402
from arl_conditional_normalizing_flows_tpu.evaluation import stats as jstats  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import logit as jlogit  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import resample as jresample  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data import images  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.evaluation import stats  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import logit, resample  # noqa: E402


def test_synthetic_digits_and_labels_match_jax():
    for kw in (dict(num_per_class=24, num_classes=2, size=8, seed=3), dict(num_per_class=4)):
        x, y = images.synthetic_digits(**kw)
        jx, jy = jimages.synthetic_digits(**kw)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    for n in (1, 2, 10):
        np.testing.assert_array_equal(images.class_labels_01(n), jimages.class_labels_01(n))


def test_load_image_dataset_reads_a_cache_or_synthesises(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("ARL_CNF_DATA_DIR", raising=False)
    x, y = images.load_image_dataset("mnist", "test")
    jx, jy = jimages.synthetic_digits(num_per_class=64, seed=1)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(FileNotFoundError):
        images.load_image_dataset("mnist", synthetic_fallback=False)

    rng = np.random.default_rng(0)
    arrays = {f"{a}_{s}": rng.integers(0, 256, size=(5, 28, 28) if a == "x" else (5,))
              .astype(np.uint8) for a in "xy" for s in ("train", "test")}
    np.savez(tmp_path / "mnist.npz", **arrays)
    monkeypatch.setenv("ARL_CNF_DATA_DIR", str(tmp_path))
    for split in ("train", "test"):
        x, y = images.load_image_dataset("mnist", split)
        jx, jy = jimages.load_image_dataset("mnist", split)
        assert x.shape == (5, 28, 28, 1) and y.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_logitify_np_matches_jax_and_torch():
    x = np.random.default_rng(1).uniform(size=(64, 28)).astype(np.float32)
    got = logit.logitify_np(x)
    np.testing.assert_array_equal(got, jlogit.logitify_np(x))
    np.testing.assert_allclose(got, logit.logitify(torch.from_numpy(x)).numpy(), rtol=1e-6,
                               atol=1e-6)


def source(batch=8, noise=1.0, use_logits=False):
    imgs, labels = images.synthetic_digits(num_per_class=24, num_classes=3, size=8)
    return images.ClassConditionalSource(imgs, labels, [0, 2], batch, use_logits=use_logits,
                                         noise_floor_alpha=noise)


def test_class_conditional_batches_are_class_pure_and_cover_the_epoch():
    src = source()
    assert src.num_batches == 6 and src.xy_shape == (8, 8, 2)
    imgs, labels = images.synthetic_digits(num_per_class=24, num_classes=3, size=8)
    g = torch.Generator().manual_seed(0)
    signatures = []
    for _ in range(2):
        seen = {0.0: [], 1.0: []}
        batches = list(src.epoch(g))
        assert len(batches) == src.num_batches
        for xy in batches:
            assert xy.shape == (8, 8, 8, 2) and xy.dtype == torch.float32
            label = xy[..., 1].unique()
            assert label.numel() == 1  # class-pure
            seen[label.item()] += [x for x in xy[..., 0].numpy()]
        # every example of each class exactly once (24 = 3 whole batches)
        for value, c in ((0.0, 0), (1.0, 2)):
            want = sorted(float(x.sum()) for x in imgs[labels == c, ..., 0])
            assert sorted(float(x.sum()) for x in seen[value]) == want
        signatures.append([tuple(sorted(xy[..., 0].sum(dim=(1, 2)).tolist())) for xy in batches])
    # membership is reshuffled from one epoch to the next
    assert set(signatures[0]) != set(signatures[1])


def test_class_conditional_noise_floor_and_logits():
    clean = list(source().epoch(torch.Generator().manual_seed(4)))
    noisy = list(source(noise=0.98).epoch(torch.Generator().manual_seed(4)))
    # the same generator state draws the same order and shuffle; the floor
    # adds 0.02*N(0,1) to 0.98*xy
    for c, n in zip(clean, noisy):
        resid = (n - 0.98 * c) / 0.02
        assert abs(resid.mean().item()) < 0.1 and abs(resid.std().item() - 1.0) < 0.05
    logits = next(source(use_logits=True).epoch(torch.Generator().manual_seed(4)))
    np.testing.assert_allclose(logits[..., 0].numpy(), logit.logitify_np(clean[0][..., 0].numpy()),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="fewer images than batch_size"):
        source(batch=32)


def test_resample_and_preprocess_sr_match_jax():
    """``down``/``up`` on channel-last batches, and both SR pairings with and
    without the residual target, at 1e-7."""
    hires, _ = images.synthetic_digits(num_per_class=3)
    x = hires[:12]
    for fn, jfn in ((resample.down, jresample.down), (resample.up, jresample.up)):
        got = fn(torch.from_numpy(x)).numpy()
        want = np.asarray(jfn(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    for model_type in ("SR4,2", "SR2,1"):
        for residual in (True, False):
            got = images.preprocess_sr(x, model_type, residual)
            want = np.asarray(jimages.preprocess_sr(x, model_type, residual))
            assert got.shape == want.shape == ((12, 14, 14, 2) if model_type == "SR4,2"
                                               else (12, 28, 28, 2))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="SR model_type"):
        images.preprocess_sr(x, "SR8,4")


@pytest.mark.parametrize("model_type", ["SR4,2", "SR2,1"])
def test_sr_source_batches_and_noise_floor(model_type):
    """Batch count and shapes; every example once an epoch; the residual
    target's 2x2 blocks sum to ~0; the floor adds 0.02*N(0,1) to 0.98*xy."""
    hires, _ = images.synthetic_digits(num_per_class=5)  # 50 images
    clean = images.SRSource(hires, model_type, 8, noise_floor_alpha=1.0)
    noisy = images.SRSource(hires, model_type, 8)
    hw = 14 if model_type == "SR4,2" else 28
    assert clean.num_batches == 6 and clean.xy_shape == (hw, hw, 2)
    batches = list(clean.epoch(torch.Generator().manual_seed(0)))
    assert len(batches) == 6 and all(b.shape == (8, hw, hw, 2) for b in batches)
    seen = sorted(float(b[i].sum()) for b in batches for i in range(8))
    pairs = images.preprocess_sr(hires, model_type)[:48]
    assert seen == sorted(float(p.sum()) for p in pairs)
    sums = stats.sr_residual_block_sums(torch.cat(batches)[..., :1])
    assert sums["max_abs_block_sum"] < 1e-5
    for c, n in zip(batches, noisy.epoch(torch.Generator().manual_seed(0))):
        resid = (n - 0.98 * c) / 0.02
        assert abs(resid.mean().item()) < 0.1 and abs(resid.std().item() - 1.0) < 0.1
    with pytest.raises(ValueError, match="zero batches"):
        images.SRSource(hires[:4], model_type, 8)


def test_evaluation_stats_match_jax():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(64, 4, 4, 1)).astype(np.float32)
    ref = rng.normal(loc=0.1, size=(64, 4, 4, 1)).astype(np.float32)
    xy = rng.normal(size=(16, 4, 4, 2)).astype(np.float32)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    cases = [
        ("latent_normality_stats", (z,)),
        ("moment_match_report", (z, ref)),
        ("y_identity_error", (xy, 0.5, 1)),
        ("sr_residual_block_sums", (z,)),
        ("sector_fidelity", (pts, 1.0, 0.8)),
    ]
    for name, args in cases:
        want = getattr(jstats, name)(*args)
        for conv in (np.asarray, torch.from_numpy):
            got = getattr(stats, name)(*(conv(a) if isinstance(a, np.ndarray) else a
                                         for a in args))
            assert set(got) == set(want), name
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=f"{name} {k}")
    assert stats.bits_per_dim(100.0, 784) == jstats.bits_per_dim(100.0, 784)
