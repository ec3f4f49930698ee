"""Cells cut to a size that the CPU tests can run: the configurations'
layout at 8 x 8 with one residual block a scale, batches of 8."""

from cnfbench import cells

SMALL = dict(io_shape=[8, 8, 2], x_d=1, squeeze_factor_blocks=[0, 1], res_blocks=[1, 1],
             num_kernels=[16, 16], cardinality=[2, 2], ksize=3, dilations=True,
             layer_norm=False, lambda_y=100.0, fused_subnet=True)


def small_cell(traffic, dtype, limits=None, **overrides):
    """A cell of the traffic mix ``traffic`` (a file of ``traffic/``) on the
    small configuration in ``dtype``, with ``overrides`` of the mix."""
    mix = cells._read(cells.HERE / "traffic" / f"{traffic}.json")
    mix.update(batch=8, draws=2, **overrides)
    if mix["kind"] == "train":
        mix["steps_a_call"] = overrides.get("steps_a_call", 4)
    return cells.Cell(name=f"small.{traffic}", chips=1,
                      config={"model": dict(SMALL, compute_dtype=dtype)}, traffic=mix,
                      limits=dict(limits or {}), end_to_end=[], per_layer=[])
