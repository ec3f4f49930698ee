"""The port's ``utils/roofline.py`` and ``utils/profiling.py`` against the
JAX package's: the conv FLOPs the port counts from a model equal the count
JAX's ``parse_hlo_convs`` reads from the model's compiled HLO on the CPU,
exactly, under the default, ``dense_groups`` and ``fused_dilated``
lowerings, for the small arch and for the flagship at batch 1, forward and
train step; the report keeps JAX's keys; the step timer's summary is JAX's.

XLA's CPU compiler turns the 1x1 convs into dot products, which
``parse_hlo_convs`` does not read: the k x k convs are compared op for op
with the HLO convolutions, and the 1x1 convs' FLOPs with the HLO dots'
(and, in a train step, with the few 1x1 backward convs XLA keeps as
convolutions)."""

import collections
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import create_train_state as j_create  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import make_step_fns as j_step_fns  # noqa: E402
from arl_conditional_normalizing_flows_tpu.utils import profiling as jprofiling  # noqa: E402
from arl_conditional_normalizing_flows_tpu.utils import roofline as jroofline  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.utils import profiling, roofline  # noqa: E402

SMALL = dict(io_shape=(16, 16, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
             num_kernels=(16, 16), cardinality=(2, 2), ksize=3, fused_subnet=True)
FLAGSHIP = dict(io_shape=(28, 28, 2), x_d=1, squeeze_factor_blocks=(0, 1, 0, 0),
                res_blocks=(3, 3, 3, 3), num_kernels=(64, 64, 32, 32), cardinality=(8, 8, 4, 4),
                ksize=3, compute_dtype="bfloat16", fused_subnet=True)
LOWERINGS = [None, "dense_groups", "fused_dilated"]
#: the flagship's forward k x k conv GFLOP at batch 128 in JAX's HLO count
FLAGSHIP_GFLOP = {None: 19.92, "dense_groups": 133.78, "fused_dilated": 1512.93}
H100 = "NVIDIA H100 80GB HBM3"

_DOT_RE = re.compile(r"(%[\w.\-]+)\s*=\s*[a-z0-9]+\[([0-9,]*)\][^=]*?\bdot\("
                     r"\s*(%[\w.\-]+)\s*,\s*(%[\w.\-]+)\s*\)(.*)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def hlo_dot_flops(hlo_text):
    """FLOPs of each ``dot`` in an HLO module: 2 * output elements * the
    contracted size of the lhs."""
    shapes = {m.group(1): jroofline._shape_of(m.group(3))
              for m in jroofline._DEF_RE.finditer(hlo_text)}
    out = []
    for m in _DOT_RE.finditer(hlo_text):
        _, dims, lhs, _, rest = m.groups()
        contract = [int(d) for d in _CONTRACT_RE.search(rest).group(1).split(",")]
        size = np.prod([shapes[lhs][d] for d in contract])
        out.append(2.0 * np.prod(jroofline._shape_of(dims)) * size)
    return out


def port_ops(arch, lowering, batch, train=False):
    tm = ConvCFlow(ConvFlowConfig(**dict(arch, experimental_lowering=lowering)), device="cpu")
    ops = roofline.model_convs(tm, batch, train=train)
    return ([o for o in ops if o.kernel_shape[0] > 1], [o for o in ops if o.kernel_shape[0] == 1])


@pytest.mark.parametrize("lowering", LOWERINGS, ids=str)
@pytest.mark.parametrize("arch", ["small", "flagship"])
def test_forward_conv_flops_equal_jaxs_hlo_count(arch, lowering):
    kw = dict(SMALL if arch == "small" else FLAGSHIP, experimental_lowering=lowering)
    jm = JConvCFlow(JConfig(**kw))
    xy = jax.ShapeDtypeStruct((1,) + kw["io_shape"], jnp.float32)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), xy)
    hlo = jax.jit(jm.apply).lower(params, xy).compile().as_text()
    convs = jroofline.parse_hlo_convs(hlo)
    kxk, one = port_ops(kw, lowering, 1)
    assert len(kxk) == len(convs)
    assert sorted(o.flops for o in kxk) == sorted(c.flops for c in convs)
    assert sorted((o.out_shape, o.kernel_shape) for o in kxk) == sorted(
        (tuple(c.out_shape), tuple(c.kernel_shape)) for c in convs)
    dots = hlo_dot_flops(hlo)
    assert len(dots) == len(one) and sum(dots) == sum(o.flops for o in one)
    if arch == "flagship":
        gflop = sum(o.flops for o in kxk) * 128 / 1e9
        assert round(gflop, 2) == FLAGSHIP_GFLOP[lowering]


@pytest.mark.parametrize("lowering", LOWERINGS, ids=str)
def test_train_step_conv_flops_equal_jaxs_hlo_count(lowering):
    """Every k x k conv of the port's count (forward, input and weight
    gradients, no input gradient for the first coupling's entry conv) is an
    HLO convolution of JAX's compiled step, and the HLO convolutions left
    over are 1x1 backward convs: each has the FLOPs of one of the port's
    1x1 convs, and with the HLO dots they sum to the port's 1x1 count."""
    kw = dict(SMALL, experimental_lowering=lowering)
    batch = 4
    jm = JConvCFlow(JConfig(**kw))
    xy = jnp.zeros((batch,) + kw["io_shape"], jnp.float32)
    state = j_create(jm, xy[:1], 3e-4)
    step, _ = j_step_fns(jm, noise_mode="none")
    hlo = step.lower(state, xy, jax.random.PRNGKey(0), jnp.float32(1.0)).compile().as_text()
    hlo_convs = collections.Counter(c.flops for c in jroofline.parse_hlo_convs(hlo))
    kxk, one = port_ops(kw, lowering, batch, train=True)
    port_kxk = collections.Counter(o.flops for o in kxk)
    assert not port_kxk - hlo_convs
    left = hlo_convs - port_kxk
    assert set(left) <= {o.flops for o in one}
    assert sum(f * n for f, n in left.items()) + sum(hlo_dot_flops(hlo)) == sum(
        o.flops for o in one)
    names = [o.name for o in kxk + one]
    assert not any(n.startswith("couplings.0.") and n.endswith("conv_in.grad_input")
                   for n in names)
    assert any(n.endswith("conv_in.grad_input") for n in names)


def test_report_keeps_jaxs_keys_and_divides_the_default_count():
    tm = ConvCFlow(ConvFlowConfig(**dict(SMALL, experimental_lowering="fused_dilated")),
                   device="cpu")
    statics = roofline.roofline_statics(tm, 8, H100, train=True)
    cached = json.loads(json.dumps(statics))
    rep = roofline.roofline_from_statics(cached, 1e-3, batch=8)
    assert rep == roofline.roofline_report(tm, 8, 1e-3, H100, train=True)
    for k in ("conv_ops", "conv_flops", "conv_bytes", "total_flops", "total_bytes",
              "peak_bf16_flops", "hbm_bytes_per_sec", "conv_bound_seconds",
              "rest_bound_seconds", "roofline_lower_bound_seconds", "conv_ops_memory_bound",
              "measured_step_seconds", "mfu", "conv_hbm_utilization", "fraction_of_roofline",
              "bound_samples_per_sec"):
        assert k in rep, k
    assert rep["default_lowering_conv_flops"] < rep["conv_flops"]
    assert rep["mfu"] == rep["default_lowering_conv_flops"] / 1e-3 / 989e12
    ops = roofline.model_convs(tm, 8, train=True)
    assert rep["roofline_lower_bound_seconds"] == sum(
        max(o.flops / 989e12, o.bytes / 3.35e12) for o in ops)
    assert rep["fraction_of_roofline"] == rep["roofline_lower_bound_seconds"] / 1e-3
    assert "spec-sheet" in rep["note"]
    # the default lowering's own report counts what it runs
    default = ConvCFlow(ConvFlowConfig(**SMALL), device="cpu")
    drep = roofline.roofline_statics(default, 8, H100, train=True)
    assert drep["conv_flops"] == drep["default_lowering_conv_flops"] == rep[
        "default_lowering_conv_flops"]


def test_device_peaks_table():
    assert roofline.device_peaks(H100) == (989e12, 3.35e12)
    assert not roofline.peaks_validated(H100)
    assert roofline.device_peaks("cpu") is None
    for kind in ("TPU v5 lite", "TPU v5e", "TPU v4", "TPU v3", "TPU v2", "TPU v6e", "TPU v5p"):
        assert roofline.device_peaks(kind) == jroofline.device_peaks(kind)
        assert roofline.peaks_validated(kind) == jroofline.peaks_validated(kind)
    rep = roofline.roofline_statics(ConvCFlow(ConvFlowConfig(**SMALL), device="cpu"), 2, "cpu")
    assert "unknown device kind" in rep["note"] and "conv_bound_seconds" not in rep


def test_step_timer_summary_is_jaxs():
    for n in (1, 2, 19, 20, 21, 100):
        times = list(np.random.default_rng(n).uniform(size=n))
        mine, theirs = profiling.step_timer(), jprofiling.step_timer()
        mine.times, theirs.times = list(times), list(times)
        assert mine.summary() == theirs.summary()
    # nearest-rank p95 of 20 is the 19th value, not the max
    t = profiling.step_timer()
    t.times = [float(i) for i in range(1, 21)]
    assert t.summary()["p95_s"] == 19.0 and t.summary()["p50_s"] == 11.0
    assert profiling.step_timer().summary() == {}
    with t:
        pass
    assert len(t.times) == 21 and t.times[-1] >= 0


def test_profile_trace_and_annotate(tmp_path):
    """A span inside ``profile_trace`` lands in its sums and in its Chrome
    trace; one outside any profiler leaves nothing behind."""
    with profiling.span("cnf.outside"):
        torch.ones(8) * 2
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        with profiling.span("cnf.coupling_law"):
            torch.ones(8) * 2
    names = {e.key for e in prof.key_averages()}
    assert "cnf.coupling_law" in names and "cnf.outside" not in names
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "cnf.coupling_law" for e in events)
