"""Training engine for joint-NLL flow training (port of the JAX
``train/loop.py``).

The reference's Keras ``model.fit`` with a custom ``train_step``
(TOYcINN_make_model.py:453-506, conv_cINN_make_model.py:1850-1904) becomes:

- ``train_step(state, xy, generator, alpha) -> (state, out)``: instance noise
  (alpha ramp 0 -> 1, TOYcINN.py:249-287, conv_cINN.py:589-628) drawn on the
  device from a ``torch.Generator``, the joint NLL's gradient and one Adam
  update, in place;
- ``make_scan_train_step``: N steps for one call. On the card one step is
  captured as a CUDA graph and replayed N times (the counterpart of the JAX
  ``lax.scan`` program); on the CPU it is a plain loop;
- ``fit``: annealing epochs, then clean epochs with early stopping (best
  parameters restored), a NaN guard, validation, history and checkpoints.

With a ``mesh`` (``parallel/mesh.py``) each process feeds its slice of the
global batch (JAX ``train/loop.py:81-229``): the instance noise is drawn
for the global batch from the shared generator and each process keeps its
rows, the gradients are averaged over the ``data`` axis by one all-reduce
after backward and before Adam (inside the CUDA graph on the card), and the
losses are averaged once a call; with a ``state_sharding`` from
``parallel.mesh.state_shardings`` (FSDP) the optimizer steps this process's
shards, between one reduce-scatter of the gradients and one all-gather of
the parameters (``parallel.mesh.FlatShards``), in the CUDA graph too.

PyTorch idiom in place of JAX's: the state holds an ``nn.Module`` and its
``torch.optim.Adam``, and a step updates both in place and returns the same
state (JAX donates the old state; here the old and new state are one
object). Parameters are only ever written in place (``restore_params``),
because a captured graph holds their addresses.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn
from torch.autograd.graph import increment_version

from arl_conditional_normalizing_flows_tpu_torch.models.init_compat import shared_shape_reinit
from arl_conditional_normalizing_flows_tpu_torch.ops import noise as noise_ops
from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib
from arl_conditional_normalizing_flows_tpu_torch.train.metrics import (
    LOSS_KEYS,
    EarlyStopping,
    HistoryLogger,
    MeanMetrics,
    restore_params,
)
from arl_conditional_normalizing_flows_tpu_torch.utils import graphs
from arl_conditional_normalizing_flows_tpu_torch.utils.profiling import span

#: eager steps on a side stream before a step is captured: they make every
#: lazy first use (Adam's state, cuDNN plans, the conv-chain kernel's
#: shared-memory attribute and its index tables on the card) happen outside
#: the capture. The state is restored afterwards.
_WARMUP_STEPS = 3


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (both updated in place by a step) and the
    step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def step(self) -> int:
        """Optimizer steps taken (Adam's count; 0 before the first)."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                state = self.optimizer.state.get(p)
                if state:
                    return int(state["step"])
        return 0


def _device(model) -> torch.device:
    return next(model.parameters()).device


def create_train_state(model, learning_rate, seed=0, tx=None) -> TrainState:
    """The train state of ``model`` (already built on its device).

    ``tx``: a function ``params -> torch.optim.Optimizer`` (the counterpart
    of an unbound optax transformation); by default Adam at
    ``learning_rate`` with optax.adam's constants (b1 0.9, b2 0.999, eps
    1e-8, bias-corrected). On the card Adam is ``capturable``, so its step
    count stays on the device and a CUDA graph can capture the update.

    When the model's config sets ``ref_compat_shared_init``, its conv
    kernels are rewritten in place into the reference's shared-instance
    init distribution (``models.init_compat.shared_shape_reinit``),
    deterministic in ``seed``. The model's own init seed is the one it was
    built with.

    A model sharded by ``parallel.mesh.state_shardings`` gets an optimizer
    over this process's shards and the replicated parameters
    (``FlatShards.optimizer_params``), as JAX's ``state_shardings`` shards
    the optimizer's moments with their parameters.
    """
    if getattr(getattr(model, "cfg", None), "ref_compat_shared_init", False):
        shared_shape_reinit(model, seed)
    shards = getattr(model, "fsdp_shards", None)
    params = shards.optimizer_params() if shards is not None else model.parameters()
    if tx is None:
        optimizer = torch.optim.Adam(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            capturable=_device(model).type == "cuda")
    else:
        optimizer = tx(params)
    return TrainState(model=model, optimizer=optimizer)


def _noise_fn(noise_mode: str, x_d: Optional[int]):
    """``(generator, xy, alpha) -> xy`` with instance noise, or None."""
    if noise_mode == "none":
        return None
    if noise_mode == "x_only":
        if x_d is None:
            raise ValueError(
                "noise_mode='x_only' requires x_d (the toy variant noises only the "
                "leading x_d dims, TOYcINN_make_datasets.py:1324-1329)")
        return lambda g, xy, alpha: noise_ops.instance_noise_x_only(g, xy, alpha, x_d)
    if noise_mode == "full":
        return noise_ops.instance_noise
    raise ValueError(f"unknown noise_mode {noise_mode!r}")


def _global_noise(add_noise, mesh):
    """``add_noise`` for this process's rows of a global batch: the noise is
    drawn for all the ``data`` axis's slices (this process's rows stand in
    for the others') from the shared generator, and this process keeps its
    own. So a step equals one process's step on the concatenated batch, as
    under JAX's replicated key, and the generators stay in lockstep."""
    if add_noise is None or mesh is None:
        return add_noise
    _, size, index = mesh_lib.data_axis(mesh)
    if size == 1:
        return add_noise

    def add(generator, xy, alpha):
        b = xy.shape[0]
        full = xy.repeat((size,) + (1,) * (xy.dim() - 1))
        return add_noise(generator, full, alpha)[index * b:(index + 1) * b]

    return add


class _Parallel:
    """What a step does across processes for ``mesh`` and
    ``state_sharding``: nothing without a mesh; over a data-parallel mesh,
    average the gradients after backward (:meth:`reduce_grads`); under FSDP
    (``state_sharding``), reduce-scatter the gradients into the shards after
    backward and all-gather the parameters after the optimizer
    (``parallel.mesh.FlatShards``). Either way the losses are averaged over
    the ``data`` axis (:meth:`mean`)."""

    def __init__(self, model, mesh, state_sharding):
        self.mesh = mesh
        self.shards = getattr(model, "fsdp_shards", None)
        if state_sharding is not None and (mesh is None or self.shards is None):
            raise ValueError("a state_sharding needs its mesh and a model sharded by "
                             "parallel.mesh.state_shardings")
        if self.shards is not None and state_sharding is None:
            raise ValueError("an FSDP-sharded model needs its mesh and state_sharding")
        self.group = mesh_lib.data_axis(mesh)[0] if mesh is not None else None

    def reduce_grads(self, state: TrainState) -> None:
        if self.shards is not None:
            self.shards.reduce_gradients()
        elif self.mesh is not None:
            mesh_lib.all_reduce_gradients(_state_tensors(state)[0], self.group)

    def after_update(self) -> None:
        if self.shards is not None:
            self.shards.gather()

    def mean(self, t):
        """``t`` averaged over the ``data`` axis (in place); ``t`` itself
        without a mesh."""
        return t if self.mesh is None else mesh_lib.all_reduce_mean(t, self.group)


def _apply_step(state: TrainState, xy, add_noise, generator, alpha, parallel=None):
    """One optimizer step on ``xy``; the four loss components of this
    process's rows, detached."""
    if add_noise is not None:
        xy = add_noise(generator, xy, alpha)
    state.optimizer.zero_grad(set_to_none=True)
    out = state.model.log_loss(xy)
    out["loss"].backward()
    if parallel is not None:
        parallel.reduce_grads(state)
    state.optimizer.step()
    if parallel is not None:
        parallel.after_update()
    return {k: out[k].detach() for k in LOSS_KEYS}


def _check_model(state: TrainState, model) -> None:
    if state.model is not model:
        raise ValueError("the train state holds another model than the step was made for")


def make_step_fns(model, mesh=None, noise_mode: str = "full", x_d: Optional[int] = None,
                  state_sharding=None):
    """``(train_step, eval_step)`` for ``model``.

    ``train_step(state, xy, generator=None, alpha=1.0) -> (state, out)``
    applies instance noise ``alpha*xy + (1-alpha)*N(0,1)`` drawn from
    ``generator`` (on xy's device), takes the gradient of ``log_loss`` and
    one optimizer step, in place. ``eval_step(state, xy) -> out`` runs
    ``log_loss`` without gradients on this process's rows (``fit`` averages
    an epoch's validation over the processes). ``out`` maps the four loss
    components (``LOSS_KEYS``) to 0-d tensors.

    ``noise_mode``: "full" (conv: noise the whole xy tensor), "x_only" (toy,
    needs ``x_d``) or "none".

    ``mesh``: ``xy`` is this process's slice of the global batch; the noise
    is the global batch's (every process passes an identically seeded
    generator), the gradients are averaged over the ``data`` axis before
    the update, and ``out`` is the global batch's mean. ``state_sharding``
    (``parallel.mesh.state_shardings``, on a 2-D mesh): the model is
    FSDP-sharded; the gradients are reduce-scattered into this process's
    shards, which the optimizer steps, and the parameters all-gathered after
    it.
    """
    parallel = _Parallel(model, mesh, state_sharding)
    add_noise = _global_noise(_noise_fn(noise_mode, x_d), mesh)

    def train_step(state, xy, generator=None, alpha=1.0):
        _check_model(state, model)
        out = _apply_step(state, xy, add_noise, generator, alpha, parallel)
        if mesh is not None:
            out = dict(zip(LOSS_KEYS, parallel.mean(
                torch.stack([out[k] for k in LOSS_KEYS])).unbind()))
        return state, out

    @torch.no_grad()
    def eval_step(state, xy):
        _check_model(state, model)
        out = state.model.log_loss(xy)
        return {k: out[k] for k in LOSS_KEYS}

    return train_step, eval_step


def _state_tensors(state: TrainState):
    """The optimizer's parameters (under FSDP, this process's shards and the
    replicated parameters) and its state tensors, in a fixed order."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    opt = [t for p in params for t in state.optimizer.state.get(p, {}).values()
           if torch.is_tensor(t)]
    return params, opt


def _snapshot(state: TrainState):
    with torch.no_grad():
        params = [p.detach().clone() for p in state.model.parameters()]
    opt = {p: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
           for p, s in state.optimizer.state.items()}
    return params, opt


@torch.no_grad()
def _restore(state: TrainState, saved) -> None:
    """Write a :func:`_snapshot` back in place. Optimizer state made since
    (a fresh Adam's, by the warm-up) goes back to Adam's initial zeros."""
    params, opt = saved
    for p, v in zip(state.model.parameters(), params):
        p.copy_(v)
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            if not torch.is_tensor(v):
                continue
            if p in opt:
                v.copy_(opt[p][k])
            else:
                v.zero_()


class _GraphedSteps:
    """``multi(state, xy_stack, generator=None, alpha=1.0) -> (state,
    mean_out)`` on the card: one optimizer step captured as a CUDA graph,
    replayed once for each of the ``num_inner`` batches of ``xy_stack``.

    The captured step reads a static ``(B, H, W, D)`` input and a static 0-d
    alpha, draws its noise from ``generator`` (registered with the graph, so
    that every replay draws anew) and adds its four losses into a static
    accumulator. A call copies ``xy_stack[i]`` into the input and replays
    once per step, then divides the sums by ``num_inner``. One step is
    captured rather than all N: N steps would hold N times the step's
    kernels (6,425 a step at the flagship, batch 128, on an NVIDIA H100
    80GB HBM3 at 700 W: 1.6 million at the JAX bench's N = 256), while one
    step's graph serves every N and the host's work between replays is a
    copy and a launch.

    The first call captures (:meth:`capture`); a later call captures again
    when the state, the generator, the input's shape or the address of any
    parameter or optimizer state tensor has changed. A failed capture
    raises: nothing falls back to eager steps.
    """

    def __init__(self, model, num_inner: int, add_noise, parallel=None):
        self.model, self.num_inner, self.add_noise = model, num_inner, add_noise
        self.parallel = parallel
        self.graph = None
        # the hand-written kernels' launches a replay (see capture)
        self.launches = None
        # the collectives a replay launches (parallel.mesh.LAUNCHES, counted
        # at the capture)
        self.collectives = None
        # the capture's key, static input, loss sums and alpha
        self._key = self._xy = self._acc = self._alpha = None

    def _capture_key(self, state, xy_stack, generator):
        params, opt = _state_tensors(state)
        # the model's parameters too: under FSDP the optimizer holds shards
        tensors = [*state.model.parameters(), *params, *opt]
        return (id(state.model), id(state.optimizer), id(generator), tuple(xy_stack.shape),
                xy_stack.dtype, xy_stack.device, tuple(t.data_ptr() for t in tensors))

    def _step(self, state, generator):
        out = _apply_step(state, self._xy, self.add_noise, generator, self._alpha,
                          self.parallel)
        self._acc.add_(torch.stack([out[k] for k in LOSS_KEYS]))

    def capture(self, state: TrainState, xy_stack, generator=None) -> None:
        """Warm up on a side stream, capture one step (``utils.graphs.capture``),
        and restore the state (parameters and optimizer state, in place) and
        the generator to what they were before the warm-up, so that where
        the capture falls (a resumed run captures at its first epoch) does
        not move the noise stream. :attr:`launches` is what each replay
        launches of the hand-written kernels, :attr:`collectives` of the
        collectives (the warm-up's eager ones have made their communicators
        before the capture)."""
        _check_model(state, self.model)
        device = xy_stack.device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a stack on the card, not {device}")
        self.graph = None
        self._xy = xy_stack[0].clone()
        self._acc = torch.zeros(len(LOSS_KEYS), device=device)
        self._alpha = torch.ones((), device=device)
        saved = _snapshot(state)
        rng = generator.get_state() if generator is not None else None
        collectives_before = {}

        def before_capture():
            params, _ = _state_tensors(state)
            if not all(state.optimizer.state.get(p) for p in params):
                raise RuntimeError(
                    "CUDA graph capture of a train step needs a warm-up step first: the "
                    "optimizer has no state yet for some parameters")
            if rng is not None:
                generator.set_state(rng)
            state.optimizer.zero_grad(set_to_none=True)
            collectives_before.update(mesh_lib.LAUNCHES)

        try:
            graph, _, self.launches = graphs.capture(
                lambda: self._step(state, generator), device, warmup=_WARMUP_STEPS,
                generator=generator if self.add_noise is not None else None,
                before_capture=before_capture)
        finally:
            _restore(state, saved)
        self.collectives = {k: v - collectives_before[k] for k, v in mesh_lib.LAUNCHES.items()}
        self.graph = graph
        self._key = self._capture_key(state, xy_stack, generator)

    def __call__(self, state: TrainState, xy_stack, generator=None, alpha=1.0):
        with span("cnf.train.call"):
            _check_stack(xy_stack, self.num_inner)
            with span("cnf.train.key"):
                stale = (self.graph is None
                         or self._capture_key(state, xy_stack, generator) != self._key)
            if stale:
                self.capture(state, xy_stack, generator)
            self._acc.zero_()
            if self.add_noise is not None:
                if torch.is_tensor(alpha):
                    self._alpha.copy_(alpha)
                else:
                    self._alpha.fill_(alpha)
            for xy in xy_stack:
                with span("cnf.train.replay"):
                    self._xy.copy_(xy)
                    self.graph.replay()
            # the replays wrote the parameters in place behind autograd's back;
            # bump their versions so that caches keyed on them (the conv-chain
            # kernel's packed weights) see the change
            with span("cnf.train.versions"):
                for p in state.model.parameters():
                    increment_version(p)
            with span("cnf.train.loss_mean"):
                acc = self._acc if self.parallel is None else self.parallel.mean(self._acc.clone())
                mean = acc / self.num_inner
            return state, dict(zip(LOSS_KEYS, mean.unbind()))


def _check_stack(xy_stack, num_inner):
    if xy_stack.dim() < 2 or xy_stack.shape[0] != num_inner:
        raise ValueError(f"xy_stack {tuple(xy_stack.shape)} is not ({num_inner}, B, ...)")


def make_scan_train_step(model, num_inner: int, mesh=None, noise_mode: str = "full",
                         x_d: Optional[int] = None, state_sharding=None):
    """``num_inner`` optimizer steps in one call:
    ``multi(state, xy_stack, generator=None, alpha=1.0) -> (state,
    mean_out)``, ``xy_stack`` shaped ``(num_inner, B, H, W, D)``, the four
    losses averaged over the inner steps (the JAX ``make_scan_train_step``,
    ``lax.scan`` over the steps in one XLA program).

    For a model on the card the steps are replays of one captured CUDA
    graph (:class:`_GraphedSteps`), which removes the host's per-launch cost
    from all but the first call; a model on the CPU gets a plain loop over
    ``train_step``. The JAX function's ``unroll`` (a scheduling window
    across scanned steps) has no counterpart in a graph and is left out.

    ``mesh`` and ``state_sharding`` as for :func:`make_step_fns`;
    ``xy_stack`` holds this process's rows of each step, the gradients are
    averaged every step (in the graph, on the card; under FSDP its
    reduce-scatter and all-gather too) and the loss sums once a call.
    """
    parallel = _Parallel(model, mesh, state_sharding)
    add_noise = _global_noise(_noise_fn(noise_mode, x_d), mesh)
    if _device(model).type == "cuda":
        return _GraphedSteps(model, num_inner, add_noise, parallel if mesh is not None else None)

    def multi(state, xy_stack, generator=None, alpha=1.0):
        with span("cnf.train.call"):
            _check_stack(xy_stack, num_inner)
            _check_model(state, model)
            outs = [_apply_step(state, xy, add_noise, generator, alpha, parallel)
                    for xy in xy_stack]
            mean = torch.stack([torch.stack([o[k] for o in outs]).mean() for k in LOSS_KEYS])
            return state, dict(zip(LOSS_KEYS, parallel.mean(mean).unbind()))

    return multi


def epoch_stacks(batches: Iterable, num_inner: int):
    """Group an epoch's batches into ``(num_inner, B, ...)`` stacks for
    :func:`make_scan_train_step`. A trailing partial group is DROPPED to
    keep shapes static; with shuffled class-pure batches this loses at most
    ``num_inner - 1`` random batches an epoch."""
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == num_inner:
            yield torch.stack(buf)
            buf = []


def noise_batches(generator, num_batches, batch_size, shape, dtype=torch.float32):
    """Data source for noise pre-training: fresh N(0,1) xy batches on the
    generator's device (conv_pre_training_cINN_on_noise.py:100-115)."""
    for _ in range(num_batches):
        yield noise_ops.renew_noise(generator, (batch_size,) + tuple(shape), dtype)


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: HistoryLogger
    completed_epochs: int
    stopped_early: bool
    #: the step function ``fit`` drove; a graphed one's ``launches`` are
    #: what each replay launches of the hand-written kernels
    train_step: Optional[Callable] = None


def _mean_over_data(mesh, values: dict, device) -> dict:
    """``values`` (floats) averaged over ``mesh``'s ``data`` axis, in
    float64."""
    t = torch.tensor([values[k] for k in values], dtype=torch.float64, device=device)
    mesh_lib.all_reduce_mean(t, mesh_lib.data_axis(mesh)[0])
    return dict(zip(values, t.tolist()))


def _floats(out) -> dict:
    """The loss components as Python floats, one device read."""
    return dict(zip(LOSS_KEYS, torch.stack([out[k] for k in LOSS_KEYS]).tolist()))


def fit(
    state: TrainState,
    train_step,
    data_epoch_fn: Callable[[torch.Generator, int], Iterable],
    *,
    generator,
    num_epochs: int,
    eval_step=None,
    val_epoch_fn: Optional[Callable[[torch.Generator, int], Iterable]] = None,
    num_annealing_epochs: int = 0,
    patience: Optional[int] = None,
    monitor: str = "loss",
    history: Optional[HistoryLogger] = None,
    initial_epoch: int = 0,
    checkpoint_fn: Optional[Callable[[int, TrainState], None]] = None,
    checkpoint_every: int = 0,
    verbose: bool = True,
    mesh=None,
) -> FitResult:
    """Run the full schedule: the annealing ramp, then clean epochs with
    early stopping (the reference's two-phase driver, TOYcINN.py:249-293,
    conv_cINN.py:589-636).

    ``data_epoch_fn(generator, epoch)`` yields the epoch's xy batches (or
    stacks, for a ``train_step`` from :func:`make_scan_train_step`);
    annealing epoch i uses alpha = i / num_annealing_epochs, later epochs
    alpha = 1 (plus whatever noise floor the data source bakes in). The one
    ``generator`` feeds the data, the steps' noise and validation; its state
    advances as they draw. A non-finite epoch loss stops training and
    restores the best parameters seen (when early stopping kept any); early
    stopping counts only after annealing. Restores copy into the live
    parameters.

    ``mesh``: every process calls ``fit`` with an identically seeded
    generator, its own slice of each epoch (``epoch_distributed``) and a
    ``train_step`` made for the mesh, whose losses are already the global
    batch's. An epoch's validation means are averaged over the ``data``
    axis before they are logged and before early stopping decides, so that
    every process stops at the same epoch.
    """
    history = history or HistoryLogger()
    stopper = EarlyStopping(patience) if patience is not None else None
    metrics = MeanMetrics()
    stopped = False
    completed = initial_epoch
    for epoch in range(initial_epoch, num_annealing_epochs + num_epochs):
        alpha = epoch / float(num_annealing_epochs) if epoch < num_annealing_epochs else 1.0
        alpha = float(np.float32(alpha))  # the float32 alpha the JAX step receives
        metrics.reset()
        t0 = time.time()
        for xy in data_epoch_fn(generator, epoch):
            state, out = train_step(state, xy, generator, alpha)
            metrics.update(_floats(out))
        if metrics.count == 0:
            # an empty epoch would otherwise log loss=0.0 and "converge":
            # typically num_inner larger than the batches an epoch
            # (epoch_stacks drops the trailing partial group)
            raise ValueError(
                f"fit: data_epoch_fn yielded no batches at epoch {epoch}; if using "
                "scanned steps, reduce num_inner below the number of batches per epoch")
        completed = epoch + 1
        row = metrics.result()
        row["seconds"] = time.time() - t0
        row["alpha"] = alpha

        if eval_step is not None and val_epoch_fn is not None:
            vmetrics = MeanMetrics()
            for xy in val_epoch_fn(generator, epoch):
                vmetrics.update(_floats(eval_step(state, xy)))
            val = vmetrics.result()
            if mesh is not None:
                val = _mean_over_data(mesh, val, _device(state.model))
            row.update({f"val_{k}": v for k, v in val.items()})

        history.log(epoch, row)
        if verbose:
            msg = " ".join(f"{k}={v:.4f}" for k, v in row.items() if k != "epoch")
            print(f"epoch {epoch}: {msg}", flush=True)

        # failure detection, which the reference lacks (SURVEY.md §5)
        if not math.isfinite(row["loss"]):
            best = stopper.best_state if stopper is not None else None
            if best is not None:
                restore_params(state.model, best)
            print(f"fit: non-finite loss at epoch {epoch} — stopping"
                  + (" and restoring best params" if best is not None else ""), flush=True)
            stopped = True
            break

        if checkpoint_fn is not None and checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            checkpoint_fn(epoch, state)

        # early stopping only once annealing is done (the reference's clean
        # fit phase owns the EarlyStopping callback, TOYcINN.py:289-293)
        if stopper is not None and epoch >= num_annealing_epochs:
            if stopper.update(row.get(monitor, row["loss"]), state.model):
                if stopper.best_state is not None:
                    restore_params(state.model, stopper.best_state)
                stopped = True
                break

    return FitResult(state=state, history=history, completed_epochs=completed,
                     stopped_early=stopped, train_step=train_step)
