"""The port's multi-process training against the JAX package's, on the CPU:
processes over gloo (``parallel.launch.run_ranks``, a ``file://``
rendezvous a test), each with one torch thread.

- a 2-process data-parallel step against JAX's data-parallel step on the
  8-device virtual mesh (``tests/conftest.py``), under the default,
  ``pallas_coupling`` (JAX's kernels in interpret mode, the port's plain
  K1) and ``pallas_subnet`` lowerings;
- 4-process (2, 2) FSDP steps against JAX's
  ``test_fsdp_2d_mesh_train_step_matches_single_device``, at its
  tolerances, under the default lowering and ``pallas_subnet`` and as
  ``make_scan_train_step``, each process's Adam moments a shard's;
- the distributed epochs' slot groups against JAX's, list for list, for the
  in-RAM and streaming class sources and the toy;
- the port against itself: ``num_shards=1`` is the epoch, shards are
  class-pure across processes, streamed equals in RAM, a 2-process step
  with instance noise equals one process's step on the concatenated batch,
  the sharded fan-out equals one process's sample, ``dryrun_multichip(4)``.

The port's 2-process runs share one group (``checks.jobs_rank``), and so do
its 4-process FSDP runs; each group runs in the background while the JAX
side compiles.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
import math
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_flow as flow  # noqa: E402
import test_torch_train as train_tests  # noqa: E402
from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.data import images as jimages  # noqa: E402
from arl_conditional_normalizing_flows_tpu.data import toy_datasets as jtoy  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops.pallas import affine_coupling as jac  # noqa: E402
from arl_conditional_normalizing_flows_tpu.parallel import mesh as jmesh  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import loop as jloop  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.data import native_loader, records  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data import toy_datasets  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.data.images import (  # noqa: E402
    ClassConditionalSource,
    SRSource,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (  # noqa: E402
    ConvFlowConfig,
    ToyConfig,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.parallel import checks, launch  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip,
)

LR = train_tests.LR
#: ``flow.models`` (a JAX init each call) once a lowering
models = functools.lru_cache(maxsize=None)(flow.models)
STEPS = 3
#: seconds a multi-process run may take before it is killed
TIMEOUT = 240


def config_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def assert_params_close(got: dict, want: dict, tight, fraction, steps, lr):
    """Every element within ``2 * steps * lr`` (Adam's sign flips on
    near-zero gradients), the fraction ``fraction`` within ``tight``."""
    err = np.concatenate([(got[k] - want[k]).abs().numpy().ravel() for k in want])
    assert np.mean(err <= tight) >= fraction, np.quantile(err, [0.9, 0.99, 0.999])
    assert err.max() <= 2 * lr * steps, err.max()


# ---------------------------------------------------------------------------
# launcher and mesh helpers
# ---------------------------------------------------------------------------


def test_run_ranks_returns_each_rank_result_and_raises_a_rank_error(tmp_path):
    assert launch.run_ranks(operator.add, 2, "gloo", str(tmp_path / "a")) == [2, 3]
    with pytest.raises(Exception, match="sqrt"):
        launch.run_ranks(math.sqrt, 2, "gloo", str(tmp_path / "b"), timeout=TIMEOUT)


def test_initialize_distributed_without_a_coordinator():
    """No coordinator and no --data-parallel: nothing (as JAX ignores
    --num-processes and --process-id alone); --data-parallel alone: a group
    of one, ended by ``distributed``."""
    import torch.distributed as dist

    assert not mesh.initialize_distributed(None, 2, 1, cpu=True)
    assert not dist.is_initialized() and mesh.process_count() == 1
    with mesh.distributed(cpu=True, data_parallel=True):
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (mesh.process_count(), mesh.process_index()) == (1, 0)
        m = mesh.make_mesh()
        assert m.mesh_dim_names == ("data",) and mesh.data_axis(m)[1:] == (1, 0)
        assert mesh.local_batch_slice(8, m) == slice(0, 8)
    assert not dist.is_initialized()


class Mesh2x2:
    """What ``fsdp_placement`` reads of a (2, 2) ``("data", "model")`` mesh."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return 2


@pytest.mark.parametrize("shape", [(8, 3, 3, 2), (16,), (3, 3, 5, 7), (), (6, 4), (1, 2)])
def test_fsdp_placement_is_jaxs_rule(shape):
    """The dim ``fsdp_placement`` shards is the dim JAX's ``_fsdp_rule``
    shards on a model axis of 2; where JAX replicates, None."""
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    spec = jmesh._fsdp_rule(jm, np.zeros(shape, np.float32), "model").spec
    placement = mesh.fsdp_placement(Mesh2x2())(torch.zeros(shape))
    want = [d for d, a in enumerate(spec) if a == "model"]
    assert placement == (want[0] if want else None)


# ---------------------------------------------------------------------------
# distributed epochs
# ---------------------------------------------------------------------------


def unequal_digits(size=8):
    """Three classes of 27, 18 and 27 synthetic digits (JAX's generator)."""
    imgs, labels = jimages.synthetic_digits(num_per_class=27, num_classes=3, size=size)
    keep = np.ones(len(labels), bool)
    keep[np.flatnonzero(labels == 1)[:9]] = False
    return np.asarray(imgs)[keep], np.asarray(labels)[keep]


@pytest.fixture(scope="module")
def class_files(tmp_path_factory):
    imgs, labels = unequal_digits()
    d = str(tmp_path_factory.mktemp("records"))
    records.write_class_sorted_dataset(d, "train", imgs, labels, [0, 1, 2], combined=False)
    return imgs, labels, [records.class_file(d, "train", c) for c in (0, 1, 2)]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_slot_groups_equal_jaxs(class_files, num_shards):
    imgs, labels, paths = class_files
    want = jimages.ClassConditionalSource(imgs, labels, [0, 1, 2], 8).slot_groups(num_shards)
    ram = ClassConditionalSource(imgs, labels, [0, 1, 2], 8)
    stream = native_loader.StreamingClassSource(paths, [0, 1, 2], 8)
    assert ram.slot_groups(num_shards) == want
    assert stream.slot_groups(num_shards) == want
    stream.close()


def jax_toy_groups(ds, key, batches_per_class, num_shards):
    """JAX's toy slot groups, read back from ``epoch_iterator_distributed``:
    each shard's batch keys name its slots, and JAX's own group order puts
    them back into its list."""
    n_classes = len(ds.class_labels)
    k_perm, k_data = jax.random.split(key)
    keys = np.asarray(jax.random.split(k_data, batches_per_class * n_classes))
    recorder = dataclasses.replace(ds, _sample_class_fn=lambda k, c, b: np.asarray(k))
    shards = [list(recorder.epoch_iterator_distributed(key, batches_per_class, 4, num_shards, s))
              for s in range(num_shards)]
    slot = {tuple(k.ravel()): i for i, k in enumerate(keys)}
    found = [[slot[tuple(shards[s][i].ravel())] for s in range(num_shards)]
             for i in range(len(shards[0]))]
    order = np.asarray(jax.random.permutation(k_perm, len(found)))
    groups = [None] * len(found)
    for i, gi in enumerate(order):
        groups[int(gi)] = found[i]
    return groups


@pytest.mark.parametrize("batches_per_class,num_shards", [(5, 2), (6, 3), (4, 4)])
def test_toy_slot_groups_equal_jaxs(batches_per_class, num_shards):
    want = jax_toy_groups(jtoy.make_moons_dataset(), jax.random.PRNGKey(3), batches_per_class,
                          num_shards)
    got = toy_datasets.make_moons_dataset().slot_groups(batches_per_class, num_shards)
    assert got == want


def same_epochs(a, b):
    a, b = list(a), list(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_one_shard_is_the_epoch(class_files, tmp_path):
    imgs, labels, paths = class_files
    sr_imgs = np.asarray(imgs[:40], np.float32)
    sr_file = records.write_class_sorted_dataset(str(tmp_path), "train", sr_imgs,
                                                 np.zeros(40, np.int64), [0], combined=True)[0]
    sources = [ClassConditionalSource(imgs, labels, [0, 1, 2], 8, use_logits=True),
               native_loader.StreamingClassSource(paths, [0, 1, 2], 8, use_logits=True),
               SRSource(sr_imgs, "SR2,1", 8),
               native_loader.StreamingSRSource(sr_file, "SR2,1", 8)]
    for src in sources:
        g, h = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        assert same_epochs(src.epoch(g), src.epoch_distributed(h, 1, 0)), type(src).__name__
        assert torch.equal(g.get_state(), h.get_state())
    ds = toy_datasets.make_moons_dataset()
    g, h = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert same_epochs(ds.epoch_iterator(g, 3, 16), ds.epoch_iterator_distributed(h, 3, 16, 1, 0))
    for src in sources[1::2]:
        src.close()


def shard_epochs(epoch_fn, num_shards, seed=6):
    """Every shard's epoch from identically seeded generators, and the
    generators' states after it."""
    gens = [torch.Generator().manual_seed(seed) for _ in range(num_shards)]
    epochs = [list(epoch_fn(g, s)) for s, g in enumerate(gens)]
    return epochs, [g.get_state() for g in gens]


@pytest.mark.parametrize("num_shards", [2, 3])
def test_shards_are_class_pure_across_processes(class_files, num_shards):
    """Every global batch (the shards' batches at one position) holds one
    class; the shards hold other examples; the generators stay in lockstep;
    the toy's global batches too."""
    imgs, labels, _ = class_files
    src = ClassConditionalSource(imgs, labels, [0, 1, 2], 8, noise_floor_alpha=1.0)
    epochs, states = shard_epochs(lambda g, s: src.epoch_distributed(g, num_shards, s),
                                  num_shards)
    assert all(torch.equal(states[0], st) for st in states)
    assert {len(e) for e in epochs} == {len(src.slot_groups(num_shards))}
    for group in zip(*epochs):
        planes = torch.cat([b[..., -1] for b in group])
        assert planes.unique().numel() == 1
        rows = torch.cat([b[..., 0].flatten(1) for b in group])
        assert rows.unique(dim=0).shape[0] == rows.shape[0]
    ds = toy_datasets.make_moons_dataset()
    epochs, states = shard_epochs(
        lambda g, s: ds.epoch_iterator_distributed(g, 4, 16, num_shards, s), num_shards)
    assert all(torch.equal(states[0], st) for st in states)
    for group in zip(*epochs):
        assert torch.cat([b[:, 2] for b in group]).unique().numel() == 1


def test_streamed_equals_in_ram_distributed_batches(class_files, tmp_path):
    imgs, labels, paths = class_files
    ram = ClassConditionalSource(imgs, labels, [0, 1, 2], 8, use_logits=True)
    stream = native_loader.StreamingClassSource(paths, [0, 1, 2], 8, use_logits=True)
    sr_imgs = np.asarray(imgs[:48], np.float32)
    sr_file = records.write_class_sorted_dataset(str(tmp_path), "train", sr_imgs,
                                                 np.zeros(48, np.int64), [0], combined=True)[0]
    sr_ram, sr_stream = SRSource(sr_imgs, "SR4,2", 8), native_loader.StreamingSRSource(
        sr_file, "SR4,2", 8)
    for shard in (0, 1):
        a, _ = shard_epochs(lambda g, s: ram.epoch_distributed(g, 2, shard), 1)
        b, _ = shard_epochs(lambda g, s: stream.epoch_distributed(g, 2, shard), 1)
        assert same_epochs(a[0], b[0])
        a, _ = shard_epochs(lambda g, s: sr_ram.epoch_distributed(g, 2, shard), 1)
        b, _ = shard_epochs(lambda g, s: sr_stream.epoch_distributed(g, 2, shard), 1)
        assert len(a[0]) == len(b[0]) == 3
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    stream.close()
    sr_stream.close()


# ---------------------------------------------------------------------------
# the data-parallel step against JAX's and against one process, the sharded
# fan-out; the port's side of each runs in one 2-process group, started in
# the background while the JAX side computes
# ---------------------------------------------------------------------------

LOWERINGS = [pytest.param(None, id="default"), pytest.param(flow.PALLAS, id="pallas_coupling"),
             pytest.param(flow.SUBNET, id="pallas_subnet")]


def dp_config(lowering):
    return ConvFlowConfig(**dict(flow.ARCH, fused_subnet=True, experimental_lowering=lowering))


def dp_batches(seed):
    """:data:`STEPS` global batches of 8 rows, 4 a process."""
    return list(torch.from_numpy(train_tests.stack(seed, batch=2 * flow.B)))


def noise_args():
    """A port model at the small arch, and instance noise at alpha 0.5."""
    cfg = dp_config(None)
    return (config_dict(cfg), ConvCFlow(cfg, device="cpu", seed=2).state_dict(), dp_batches(4),
            LR, "full", 0.5, 7)


def fan_out_args(kind):
    if kind == "toy":
        cfg = ToyConfig(num_coupling_layers=6, intermediate_dims=8, num_layers=1)
        state_dict = ToyCINN(cfg, device="cpu", seed=1).state_dict()
    else:
        cfg = dp_config(None)
        state_dict = ConvCFlow(cfg, device="cpu", seed=1).state_dict()
    return kind, config_dict(cfg), state_dict, 16, 9


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """The port's 2-process runs, started at once in the background:
    ``{job: [rank 0's result, rank 1's]}``."""
    jobs = {}
    for lowering in (None, flow.PALLAS, flow.SUBNET):
        params = models(True, lowering)[1]
        cfg = dp_config(lowering)
        jobs[("dp", lowering)] = ("train_steps_rank", (
            config_dict(cfg), state_dict_from_flax(params, ConvCFlow(cfg, device="cpu")),
            dp_batches(0), LR))
    for scan in (False, True):
        jobs[("noise", scan)] = ("train_steps_rank", noise_args() + (None, scan))
    for kind in ("toy", "conv"):
        jobs[("fan_out", kind)] = ("sample_rank", fan_out_args(kind))
    path = str(tmp_path_factory.mktemp("two_process") / "rendezvous")
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch.run_ranks, checks.jobs_rank, 2, "gloo", path,
                             (list(jobs.values()),), timeout=TIMEOUT)

        def results(job):
            by_rank = future.result()
            return [r[list(jobs).index(job)] for r in by_rank]

        yield results


@functools.lru_cache(maxsize=None)
def jax_dp_run(lowering):
    """JAX's data-parallel ``make_step_fns(noise_mode="none")`` on the
    8-device mesh for :data:`STEPS` global batches of 8 (2 processes x
    ``flow.B``), from ``flow.models``'s weights under ``lowering`` (its
    coupling kernels in interpret mode): (flax params, losses, params
    after)."""
    jm, params, _ = models(True, lowering)
    m = jmesh.make_mesh()
    repl = jax.sharding.NamedSharding(m, jax.sharding.PartitionSpec())
    state = jax.device_put(train_tests.jax_state(jm, params), repl)
    step, _ = jloop.make_step_fns(jm, mesh=m, noise_mode="none")
    key = jax.device_put(jax.random.PRNGKey(0), repl)
    old = jac.INTERPRET
    jac.INTERPRET = True
    try:
        losses = []
        for xy in train_tests.stack(0, batch=2 * flow.B):
            state, out = step(state, jmesh.shard_batch(jnp.asarray(xy), m), key,
                              jnp.float32(1.0))
            losses.append(float(out["loss"]))
    finally:
        jac.INTERPRET = old
    return params, losses, flow.to_numpy_tree(state.params["params"])


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_two_process_step_matches_jaxs_data_parallel_step(two_process, lowering):
    """Two processes of 4 rows over gloo against JAX's step of the 8 rows
    over 8 devices, 3 steps, at ``STEP_TOLS["float32"]``."""
    _, want_losses, want_params = jax_dp_run(lowering)
    tm = ConvCFlow(dp_config(lowering), device="cpu")
    want = state_dict_from_flax(want_params, tm)
    want = {k: want[k] for k, _ in tm.named_parameters()}
    loss_rtol, tight, fraction = train_tests.STEP_TOLS["float32"]
    results = two_process(("dp", lowering))
    for r in results:
        assert r["losses"] == results[0]["losses"]
        np.testing.assert_allclose(r["losses"], want_losses, rtol=loss_rtol)
        assert_params_close(r["params"], want, tight, fraction, STEPS, LR)


@pytest.mark.parametrize("scan", [False, True], ids=["steps", "scan"])
def test_two_process_step_with_noise_equals_one_process_on_the_whole_batch(two_process, scan):
    """Instance noise drawn for the global batch from the shared generator,
    each process keeping its rows: 2 processes of 4 rows take one process's
    steps on the 8 rows (every step alone, or the ``make_scan_train_step``
    call of all of them, whose losses are averaged once)."""
    want = checks.train_steps(*noise_args(), scan=scan)
    loss_rtol, tight, fraction = train_tests.STEP_TOLS["float32"]
    for r in two_process(("noise", scan)):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=loss_rtol)
        assert_params_close(r["params"], want["params"], tight, fraction, STEPS, LR)


@pytest.mark.parametrize("kind", ["toy", "conv"])
def test_sharded_fan_out_equals_one_process_sample(two_process, kind):
    want = checks.sample(*fan_out_args(kind))
    for got in two_process(("fan_out", kind)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# FSDP against JAX's, and the dry run
# ---------------------------------------------------------------------------

FSDP_ARCH = dict(io_shape=(4, 4, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
                 num_kernels=(8, 8), cardinality=(2, 2), ksize=3)
FSDP_LR = 1e-3
#: the steps of the ``make_scan_train_step`` case
FSDP_SCAN = 2
#: (lowering, scan): JAX's FSDP steps under the default lowering and under
#: pallas_subnet, and JAX's scanned FSDP steps
FSDP_CASES = [pytest.param(None, False, id="default"),
              pytest.param(flow.SUBNET, False, id="pallas_subnet"),
              pytest.param(None, True, id="scan")]


def fsdp_arch(lowering):
    return dict(FSDP_ARCH, fused_subnet=lowering is not None, experimental_lowering=lowering)


def fsdp_xy():
    return np.random.default_rng(0).normal(size=(16, 4, 4, 2)).astype(np.float32)


def fsdp_init(lowering):
    """JAX's model and a fresh train state (its steps donate it) at
    :func:`fsdp_arch`, and the port's state dict of the same weights."""
    jm = JConvCFlow(JConfig(**fsdp_arch(lowering)))
    jstate = jloop.create_train_state(jm, jnp.asarray(fsdp_xy()[:1]), FSDP_LR, seed=0)
    tm = ConvCFlow(ConvFlowConfig(**fsdp_arch(lowering)), device="cpu", seed=0)
    return jm, jstate, state_dict_from_flax(flow.to_numpy_tree(jstate.params["params"]), tm)


@pytest.fixture(scope="module")
def four_process(tmp_path_factory):
    """The port's FSDP runs of :data:`FSDP_CASES` in one 4-process group on
    a (2, 2) mesh, started at once in the background: ``{(lowering, scan):
    every rank's result}``."""
    jobs = {}
    for lowering, scan in [c.values for c in FSDP_CASES]:
        cfg = ConvFlowConfig(**fsdp_arch(lowering))
        batches = [torch.from_numpy(fsdp_xy())] * (FSDP_SCAN if scan else STEPS)
        jobs[(lowering, scan)] = ("train_steps_rank", (
            config_dict(cfg), fsdp_init(lowering)[2], batches, FSDP_LR, "none", 1.0, 0, (2, 2),
            scan))
    path = str(tmp_path_factory.mktemp("four_process") / "rendezvous")
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch.run_ranks, checks.jobs_rank, 4, "gloo", path,
                             (list(jobs.values()),), timeout=TIMEOUT)

        def results(job):
            return [r[list(jobs).index(job)] for r in future.result()]

        yield results


def jax_fsdp_run(lowering, scan):
    """JAX's FSDP steps on a (2, 2) mesh of 4 CPU devices (JAX's
    ``test_fsdp_2d_mesh_train_step_matches_single_device``): the losses
    (each step's, or the scanned call's mean) and the flax params after."""
    jm, jstate, _ = fsdp_init(lowering)
    xy = jnp.asarray(fsdp_xy())
    m = jmesh.make_2d_mesh(2, 2, jax.devices()[:4])
    ss = jmesh.state_shardings(m, jstate)
    jstate = jax.device_put(jstate, ss)
    if scan:
        multi = jloop.make_scan_train_step(jm, FSDP_SCAN, mesh=m, noise_mode="none",
                                           state_sharding=ss)
        stack = jmesh.shard_batch(jnp.stack([xy] * FSDP_SCAN), m,
                                  spec=jax.sharding.PartitionSpec(None, "data"))
        jstate, out = multi(jstate, stack, jax.random.PRNGKey(3), jnp.float32(1.0))
        losses = [float(out["loss"])]
    else:
        step, _ = jloop.make_step_fns(jm, mesh=m, noise_mode="none", state_sharding=ss)
        losses = []
        for i in range(STEPS):
            jstate, out = step(jstate, jmesh.shard_batch(xy, m),
                               jax.random.fold_in(jax.random.PRNGKey(3), i), jnp.float32(1.0))
            losses.append(float(out["loss"]))
    return losses, flow.to_numpy_tree(jstate.params["params"])


@pytest.mark.parametrize("lowering,scan", FSDP_CASES)
def test_four_process_fsdp_step_matches_jaxs(four_process, lowering, scan):
    """``test_sharding.py::test_fsdp_2d_mesh_train_step_matches_single_device``
    on a (2, 2) mesh: JAX's FSDP steps (or its scanned FSDP steps), and the
    port's in 4 processes (each parameter sharded on ``model``, the scalars
    replicated), at that test's tolerances. Each process's Adam moments hold
    half of every sharded parameter and all of a replicated one."""
    want_losses, want_params = jax_fsdp_run(lowering, scan)
    tm = ConvCFlow(ConvFlowConfig(**fsdp_arch(lowering)), device="cpu", seed=0)
    want = state_dict_from_flax(want_params, tm)
    place = mesh.fsdp_placement(Mesh2x2())
    halves = {k: (p.numel() // 2 if place(p) is not None else p.numel())
              for k, p in tm.named_parameters()}
    assert sum(halves.values()) < 0.6 * sum(p.numel() for p in tm.parameters())
    steps = FSDP_SCAN if scan else STEPS
    results = four_process((lowering, scan))
    for r in results:
        assert r["losses"] == results[0]["losses"]
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-4)
        for k, v in r["params"].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=2 * steps * FSDP_LR, err_msg=k)
        assert r["moments"] == halves


def test_dryrun_multichip_four_processes():
    """The (2, 2) FSDP mesh: two Adam steps from the class-pure distributed
    feed, then the fan-out of 8 samples, 4 rows a data slice."""
    results = dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    for r in results:
        assert r["mesh"] == {"data": 2, "model": 2} and r["depth"] == 1
        assert r["fsdp_sharded_params"] > 0 and len(r["losses"]) == 2
        assert r["samples"] == 8 and r["sample_rows"] == [4 * r["data_index"],
                                                          4 * r["data_index"] + 4]
    assert [r["data_index"] for r in results] == [0, 0, 1, 1]
