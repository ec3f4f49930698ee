"""The frozen counts equal the program's own at both configurations: the
conv count of ``utils/roofline.py::model_convs`` (forward and train step)
and K3's ``flops`` and ``io_bytes`` at every subnet's spec."""

import dataclasses

import pytest

from cnfbench import cells, counts, program

CONFIGS = ("flagship-bf16", "preset-f32")


def config(name):
    for c in cells.benchmark()["configs"]:
        if c["name"] == name:
            return cells._read(cells.ROOT / c["file"])["model"]
    raise KeyError(name)


def port_model(cfg, lowering=None):
    cell = cells.Cell(name="count", chips=1, config={"model": cfg},
                      traffic={"lowering": lowering}, limits={}, end_to_end=[], per_layer=[])
    return program.build_model(cell, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("train", [False, True])
def test_conv_count_equals_the_programs(name, train):
    from arl_conditional_normalizing_flows_tpu_torch.utils import roofline

    cfg = config(name)
    model = port_model(cfg)
    theirs = [(c.name, c.flops, c.bytes) for c in roofline.model_convs(model, 128, train=train)]
    ours = [(c.name, c.flops, c.bytes) for c in counts.model_convs(cfg, 128, train=train)]
    assert ours == theirs
    statics = roofline.roofline_statics(model, 128, "NVIDIA H100 80GB HBM3", train=train)
    assert sum(c.flops for c in counts.model_convs(cfg, 128, train=train)) == \
        statics["default_lowering_conv_flops"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("batch", [128, 2048])
def test_chain_counts_equal_the_programs(name, batch):
    from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import fused_subnet

    cfg = config(name)
    model = port_model(cfg, "pallas_subnet")
    specs = [layer.net_ab.spec for layer in model.couplings]
    ours = [c for _, c in counts.chains(cfg)]
    assert [dataclasses.astuple(c) for c in ours] == [dataclasses.astuple(s) for s in specs]
    for spec, chain in zip(specs, ours):
        assert counts.chain_flops(chain, batch) == fused_subnet.flops(spec, batch)
        assert counts.chain_bytes(chain, batch) == fused_subnet.io_bytes(spec, batch)


def test_peaks_by_dtype():
    assert counts.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12


def test_flagship_size():
    cfg = config("flagship-bf16")
    assert sum(p.numel() for p in port_model(cfg).parameters()) == 389800
    assert sum(p.numel() for p in port_model(config("preset-f32")).parameters()) == 2141512
