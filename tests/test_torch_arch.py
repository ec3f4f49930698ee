"""The port's ``models/arch.py`` equals the JAX one over a config sweep:
``derive_blocks``, ``_dilation_schedule`` and ``arch_string`` (the checkpoint
compatibility contract), and the same configs are rejected."""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.models import arch as jarch  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models import arch as tarch  # noqa: E402


def _sweep(seed, n=40):
    """Random configs from the space of tools/fuzz_arch.py, valid or not."""
    r = random.Random(seed)
    for _ in range(n):
        nb = r.choice([1, 2, 3, 4])
        yield dict(
            io_shape=(r.choice([4, 8, 12, 16, 20, 28]), r.choice([4, 8, 16, 28]),
                      r.choice([2, 3, 4, 5])),
            x_d=r.choice([1, 2]),
            squeeze_factor_blocks=tuple(r.choice([0, 1]) for _ in range(nb)),
            res_blocks=tuple(r.choice([1, 2, 3]) for _ in range(nb)),
            num_kernels=tuple(r.choice([4, 8, 12, 16, 32, 64]) for _ in range(nb)),
            cardinality=tuple(r.choice([2, 4, 8]) for _ in range(nb)),
            ksize=r.choice([1, 2, 3, 4, 5]),
            dilations=r.choice([True, True, False]),
            layer_norm=r.choice([False, True]),
            fused_subnet=r.choice([False, True]),
            experimental_lowering=r.choice(
                [None, "pallas_coupling", "fused_dilated", "dense_groups",
                 "pallas_subnet"]),
        )


def _outcome(mod, kw):
    try:
        cfg = mod.ConvFlowConfig(**kw)
        blocks = mod.derive_blocks(cfg)
    except AssertionError:
        return "rejected"
    return mod.arch_string(cfg), [dataclasses.astuple(b) for b in blocks]


@pytest.mark.parametrize("seed", range(6))
def test_config_sweep_matches_jax(seed):
    for kw in _sweep(seed):
        assert _outcome(tarch, kw) == _outcome(jarch, kw), kw


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 7])
def test_dilation_schedule_matches_jax(ksize):
    for h in range(2, 40, 2):
        for w in (h, h + 2, 2 * h):
            shape = (h, w, 2)
            assert tarch._dilation_schedule(shape, ksize) == jarch._dilation_schedule(
                shape, ksize), (shape, ksize)


def test_flagship_arch_string_and_fields():
    kw = dict(io_shape=(28, 28, 2), x_d=1, squeeze_factor_blocks=(0, 1, 0, 0),
              res_blocks=(3, 3, 3, 3), num_kernels=(64, 64, 32, 32),
              cardinality=(8, 8, 4, 4), ksize=3, fused_subnet=True,
              compute_dtype="bfloat16", experimental_lowering="pallas_coupling")
    cfg = tarch.ConvFlowConfig(**kw)
    assert tarch.arch_string(cfg) == (
        "SqFa0100_NRB3333_C8.8.4.4_NK64.64.32.32_KS3_D1_LN0_IO28x28x2_XD1")
    assert tarch.arch_string(cfg) == jarch.arch_string(jarch.ConvFlowConfig(**kw))
    # every JAX field carries across
    assert [f.name for f in dataclasses.fields(tarch.ConvFlowConfig)] == [
        f.name for f in dataclasses.fields(jarch.ConvFlowConfig)]
    assert tarch.BLOCK_MASK_ORDER == jarch.BLOCK_MASK_ORDER
    blocks = tarch.derive_blocks(cfg)
    assert [b.dilations_channelwise for b in blocks] == [(1, 2, 4)] * 2 + [(1, 2)] * 2
