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
from arl_conditional_normalizing_flows_tpu_torch.train.metrics import (
    LOSS_KEYS,
    EarlyStopping,
    HistoryLogger,
    MeanMetrics,
    restore_params,
)
from arl_conditional_normalizing_flows_tpu_torch.utils import graphs

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
    """
    if getattr(getattr(model, "cfg", None), "ref_compat_shared_init", False):
        shared_shape_reinit(model, seed)
    if tx is None:
        optimizer = torch.optim.Adam(
            model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            capturable=_device(model).type == "cuda")
    else:
        optimizer = tx(model.parameters())
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


def _apply_step(state: TrainState, xy, add_noise, generator, alpha):
    """One optimizer step on ``xy``; the four loss components, detached."""
    if add_noise is not None:
        xy = add_noise(generator, xy, alpha)
    state.optimizer.zero_grad(set_to_none=True)
    out = state.model.log_loss(xy)
    out["loss"].backward()
    state.optimizer.step()
    return {k: out[k].detach() for k in LOSS_KEYS}


def _check_model(state: TrainState, model) -> None:
    if state.model is not model:
        raise ValueError("the train state holds another model than the step was made for")


def make_step_fns(model, noise_mode: str = "full", x_d: Optional[int] = None):
    """``(train_step, eval_step)`` for ``model``.

    ``train_step(state, xy, generator=None, alpha=1.0) -> (state, out)``
    applies instance noise ``alpha*xy + (1-alpha)*N(0,1)`` drawn from
    ``generator`` (on xy's device), takes the gradient of ``log_loss`` and
    one optimizer step, in place. ``eval_step(state, xy) -> out`` runs
    ``log_loss`` without gradients. ``out`` maps the four loss components
    (``LOSS_KEYS``) to 0-d tensors.

    ``noise_mode``: "full" (conv: noise the whole xy tensor), "x_only" (toy,
    needs ``x_d``) or "none".
    """
    add_noise = _noise_fn(noise_mode, x_d)

    def train_step(state, xy, generator=None, alpha=1.0):
        _check_model(state, model)
        return state, _apply_step(state, xy, add_noise, generator, alpha)

    @torch.no_grad()
    def eval_step(state, xy):
        _check_model(state, model)
        out = state.model.log_loss(xy)
        return {k: out[k] for k in LOSS_KEYS}

    return train_step, eval_step


def _state_tensors(state: TrainState):
    """The parameters and the optimizer's state tensors, in a fixed order."""
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

    def __init__(self, model, num_inner: int, add_noise):
        self.model, self.num_inner, self.add_noise = model, num_inner, add_noise
        self.graph = None
        # the hand-written kernels' launches a replay (see capture)
        self.launches = None
        # the capture's key, static input, loss sums and alpha
        self._key = self._xy = self._acc = self._alpha = None

    def _capture_key(self, state, xy_stack, generator):
        params, opt = _state_tensors(state)
        return (id(state.model), id(state.optimizer), id(generator), tuple(xy_stack.shape),
                xy_stack.dtype, xy_stack.device, tuple(t.data_ptr() for t in params + opt))

    def _step(self, state, generator):
        out = _apply_step(state, self._xy, self.add_noise, generator, self._alpha)
        self._acc.add_(torch.stack([out[k] for k in LOSS_KEYS]))

    def capture(self, state: TrainState, xy_stack, generator=None) -> None:
        """Warm up on a side stream, capture one step (``utils.graphs.capture``),
        and restore the state (parameters and optimizer state, in place) and
        the generator to what they were before the warm-up, so that where
        the capture falls (a resumed run captures at its first epoch) does
        not move the noise stream. :attr:`launches` is what each replay
        launches of the hand-written kernels."""
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

        def before_capture():
            params, _ = _state_tensors(state)
            if not all(state.optimizer.state.get(p) for p in params):
                raise RuntimeError(
                    "CUDA graph capture of a train step needs a warm-up step first: the "
                    "optimizer has no state yet for some parameters")
            if rng is not None:
                generator.set_state(rng)
            state.optimizer.zero_grad(set_to_none=True)

        try:
            graph, _, self.launches = graphs.capture(
                lambda: self._step(state, generator), device, warmup=_WARMUP_STEPS,
                generator=generator if self.add_noise is not None else None,
                before_capture=before_capture)
        finally:
            _restore(state, saved)
        self.graph = graph
        self._key = self._capture_key(state, xy_stack, generator)

    def __call__(self, state: TrainState, xy_stack, generator=None, alpha=1.0):
        _check_stack(xy_stack, self.num_inner)
        if self.graph is None or self._capture_key(state, xy_stack, generator) != self._key:
            self.capture(state, xy_stack, generator)
        self._acc.zero_()
        if self.add_noise is not None:
            if torch.is_tensor(alpha):
                self._alpha.copy_(alpha)
            else:
                self._alpha.fill_(alpha)
        for xy in xy_stack:
            self._xy.copy_(xy)
            self.graph.replay()
        # the replays wrote the parameters in place behind autograd's back;
        # bump their versions so that caches keyed on them (the conv-chain
        # kernel's packed weights) see the change
        for p in _state_tensors(state)[0]:
            increment_version(p)
        mean = self._acc / self.num_inner
        return state, dict(zip(LOSS_KEYS, mean.unbind()))


def _check_stack(xy_stack, num_inner):
    if xy_stack.dim() < 2 or xy_stack.shape[0] != num_inner:
        raise ValueError(f"xy_stack {tuple(xy_stack.shape)} is not ({num_inner}, B, ...)")


def make_scan_train_step(model, num_inner: int, noise_mode: str = "full",
                         x_d: Optional[int] = None):
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
    """
    if _device(model).type == "cuda":
        return _GraphedSteps(model, num_inner, _noise_fn(noise_mode, x_d))
    train_step, _ = make_step_fns(model, noise_mode, x_d)

    def multi(state, xy_stack, generator=None, alpha=1.0):
        _check_stack(xy_stack, num_inner)
        outs = [train_step(state, xy, generator, alpha)[1] for xy in xy_stack]
        return state, {k: torch.stack([o[k] for o in outs]).mean() for k in LOSS_KEYS}

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
            row.update({f"val_{k}": v for k, v in vmetrics.result().items()})

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
