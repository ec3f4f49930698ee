"""The port's spans (``utils/profiling.py::span``): with no profiler
recording a span enters no ``record_function``; under a profiler the spans
nest as the code does, and the serving call and the train call leave one
span a call on the CPU. On a card (skipped without one): the serving
replay's span holds its graph launch, which the replay's kernels follow on
the trace's shared clock; a graphed train call of N steps leaves N replay
spans; and no capture span follows the first call.

Imports no JAX. The card's cases run where jax is absent, without the
repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.serve import export  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import loop  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.utils import profiling  # noqa: E402

SMALL = dict(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
             num_kernels=(8, 8), cardinality=(2, 2), ksize=3, fused_subnet=True)
DRAWS, STEPS, CALLS = 2, 3, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _events(fn, card=False):
    """The profiler's raw events of ``fn()``: ``(start ns, end ns, name,
    on the card, correlation id)``, host and card alike."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        fn()
        if card:
            torch.cuda.synchronize()
    return [(e.start_ns(), e.end_ns(), e.name(), e.device_type() == DeviceType.CUDA,
             e.correlation_id()) for e in prof.profiler.kineto_results.events()]


def _spans(events, name):
    return sorted((s, e) for s, e, n, on_card, _ in events if n == name and not on_card)


def _count(events, name):
    return len(_spans(events, name))


def _model(device):
    return ConvCFlow(ConvFlowConfig(**SMALL), device=device, seed=0)


def _artifact(device):
    fn = export.make_image_serving_fn(_model(device), 1, de_logit=True, quantize_uint8=True)
    return export.export_seeded_multidraw_sampler(fn, DRAWS, (8, 8, 1), (8, 8, 1))


def _planes(device, b=4):
    return torch.linspace(0, 1, b, device=device).view(b, 1, 1, 1).expand(b, 8, 8, 1)


def _stack(device, n=STEPS):
    g = torch.Generator().manual_seed(0)
    return torch.randn((n, 4, 8, 8, 2), generator=g).to(device)


def test_a_span_enters_no_record_function_while_no_profiler_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for _ in range(3):
        with profiling.span("cnf.a"), profiling.span("cnf.b"):
            torch.ones(2) + 1
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("cnf.a"):
            torch.ones(2) + 1
    assert entered == ["cnf.a"]  # the same spans record under a profiler


def test_nested_spans_come_out_in_order_inside_their_parent():
    def nested():
        with profiling.span("cnf.outer"):
            with profiling.span("cnf.first"):
                torch.ones(4) * 2
            with profiling.span("cnf.second"):
                torch.ones(4) * 3

    events = _events(nested)
    (outer,), (first,), (second,) = (_spans(events, f"cnf.{n}")
                                     for n in ("outer", "first", "second"))
    assert outer[0] <= first[0] <= first[1] <= second[0] <= second[1] <= outer[1]


def test_the_cpu_serving_call_and_scan_step_leave_one_span_a_call():
    cpu = torch.device("cpu")
    art, y = _artifact(cpu), _planes(cpu)
    events = _events(lambda: [art.call(seed, y) for seed in range(CALLS)])
    assert _count(events, "cnf.serve.call") == _count(events, "cnf.serve.args") == CALLS
    # the CPU runs the entry eagerly: no graph to replay, no output to copy
    assert _count(events, "cnf.serve.replay") == _count(events, "cnf.serve.copy_out") == 0
    (call, *_), (args, *_) = _spans(events, "cnf.serve.call"), _spans(events, "cnf.serve.args")
    assert call[0] <= args[0] <= args[1] <= call[1]

    model = _model(cpu)
    state = loop.create_train_state(model, 1e-3)
    multi = loop.make_scan_train_step(model, STEPS, noise_mode="none")
    xy = _stack(cpu)
    events = _events(lambda: [multi(state, xy) for _ in range(CALLS)])
    assert _count(events, "cnf.train.call") == CALLS


@pytest.mark.gpu
def test_the_serving_replay_span_holds_its_graph_launch(cuda):
    """The replay's span encloses ``cudaGraphLaunch``, and the kernels of
    that launch (the same correlation id) start after the span starts: the
    host's spans and the card's kernels share one clock. A call after the
    first captures nothing."""
    art, y = _artifact(cuda), _planes(cuda)
    art.call(1, y)  # captures
    torch.cuda.synchronize()
    events = _events(lambda: art.call(2, y), card=True)
    for name in ("cnf.serve.call", "cnf.serve.args", "cnf.serve.draw", "cnf.serve.replay",
                 "cnf.serve.copy_out"):
        assert _count(events, name) == 1, name
    assert _count(events, "cnf.graph.capture") == 0
    (s, e), = _spans(events, "cnf.serve.replay")
    launches = [(ls, le, c) for ls, le, n, on_card, c in events
                if n == "cudaGraphLaunch" and not on_card]
    assert len(launches) == 1
    ls, le, corr = launches[0]
    assert s <= ls <= le <= e
    kernels = [ks for ks, _, _, on_card, c in events if on_card and c == corr]
    assert kernels and min(kernels) >= s


@pytest.mark.gpu
def test_a_graphed_train_call_leaves_a_replay_span_a_step(cuda):
    model = _model(cuda)
    state = loop.create_train_state(model, 1e-3)
    multi = loop.make_scan_train_step(model, STEPS, noise_mode="none")
    xy = _stack(cuda)
    events = _events(lambda: multi(state, xy))  # the host's alone around a capture
    assert _count(events, "cnf.graph.capture") == 1  # the first call captures
    events = _events(lambda: [multi(state, xy) for _ in range(CALLS)], card=True)
    assert _count(events, "cnf.train.replay") == STEPS * CALLS
    for name in ("cnf.train.call", "cnf.train.key", "cnf.train.versions",
                 "cnf.train.loss_mean"):
        assert _count(events, name) == CALLS, name
    assert _count(events, "cnf.graph.capture") == 0
