"""Serving entries and artifacts (port of the JAX ``serve/export.py``).

The JAX package exports the sampling function (inverse flow plus
post-processing) as a StableHLO artifact through ``jax.export``: parameters
baked in, the batch dimension symbolic, compiled at the first call. The port
keeps that interface with PyTorch's means:

- an export (:func:`export_sampler`, :func:`export_multidraw_sampler`,
  :func:`export_seeded_multidraw_sampler`) returns a :class:`ServingArtifact`
  holding its own copy of the model, so training the model further does not
  change what the artifact serves (JAX bakes the parameters in);
- on the card, the first :meth:`ServingArtifact.call` for an input shape
  captures the whole entry (``sample_xy``, post-processing and the uint8
  cast) as one CUDA graph, after one eager warm-up call of that shape on a
  side stream; later calls of the shape copy their inputs into the graph's
  static buffers and replay it. Graphs are cached by shape, the counterpart
  of JAX's symbolic batch. On the CPU the entry runs eagerly;
- :func:`save_artifact` writes one file that ``torch.load(...,
  weights_only=True)`` reads (tensors and plain containers, no pickled code)
  plus the JAX package's JSON sidecar. Unlike JAX's StableHLO, loading it
  needs this package's model code (:func:`load_artifact` rebuilds the model
  from the stored config and weights). ``torch.export`` is not used: the
  coupling and conv-chain kernels are ``ctypes`` calls, which it cannot
  trace.

Two entries: :func:`make_image_serving_fn` for a ``ConvCFlow`` and
:func:`make_toy_serving_fn` for a ``ToyCINN``. An artifact serves either,
and its file records which model family it holds.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig, ToyConfig
from arl_conditional_normalizing_flows_tpu_torch.sample.sampler import (
    postprocess_sampled_xy,
)
from arl_conditional_normalizing_flows_tpu_torch.utils import graphs

FORMAT = "arl_conditional_normalizing_flows_tpu_torch.ServingArtifact/1"
PLATFORMS = ("cuda", "cpu")
KINDS = ("sampler", "multidraw", "seeded_multidraw")


@dataclasses.dataclass(frozen=True, eq=False)
class ImageServingFn:
    """``f(z, y) -> x`` for a port ``ConvCFlow`` (see
    :func:`make_image_serving_fn`); its fields are what an artifact stores."""

    model: nn.Module
    x_d: int
    de_logit: bool = False
    residual: bool = False
    logit_a: float = 0.01
    quantize_uint8: bool = False

    family = "conv"

    @torch.inference_mode()
    def __call__(self, z, y):
        xy = self.model.sample_xy(z, y)
        x = postprocess_sampled_xy(xy, y, self.x_d, de_logit=self.de_logit,
                                   residual=self.residual, logit_a=self.logit_a)
        if self.quantize_uint8:
            x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
        return x

    def out_aval(self, z_shape, y_shape):
        """(dtype name, shape without the leading batch) of the result."""
        return "uint8" if self.quantize_uint8 else "float32", tuple(z_shape[:-1]) + (self.x_d,)


def make_image_serving_fn(model, x_d: int, *, de_logit: bool = False,
                          residual: bool = False, logit_a: float = 0.01,
                          quantize_uint8: bool = False) -> ImageServingFn:
    """``f(z, y) -> x`` for a port ``ConvCFlow``: z (B,H,W,x_d) latent draw,
    y (B,H,W,y_d) condition plane, on the model's device; x (B,H,W,x_d)
    after the same post-processing as local sampling. ``quantize_uint8``
    returns round(clip(x, 0, 1) * 255) as uint8, a 4x smaller readback."""
    return ImageServingFn(model, x_d, de_logit=de_logit, residual=residual,
                          logit_a=logit_a, quantize_uint8=quantize_uint8)


@dataclasses.dataclass(frozen=True, eq=False)
class ToyServingFn:
    """``f(z, y) -> xy`` for a port ``ToyCINN`` (see
    :func:`make_toy_serving_fn`)."""

    model: nn.Module
    x_d: int

    family = "toy"

    @torch.inference_mode()
    def __call__(self, z, y):
        if z.shape[-1] != self.x_d:
            raise ValueError(f"z has {z.shape[-1]} features, not x_d = {self.x_d}")
        return self.model.inverse(torch.cat([z, y], dim=-1))

    def out_aval(self, z_shape, y_shape):
        return "float32", tuple(z_shape[:-1]) + (z_shape[-1] + y_shape[-1],)


def make_toy_serving_fn(model, x_d: int) -> ToyServingFn:
    """``f(z, y) -> xy`` for a port ``ToyCINN``: z (B, x_d), y (B, y_d) on
    the model's device; xy (B, x_d + y_d), the inverse of concat(z, y)."""
    return ToyServingFn(model, x_d)


#: the serving functions an artifact holds, by model family
_FAMILIES = {"conv": ImageServingFn, "toy": ToyServingFn}


def make_multidraw_fn(fn):
    """``g(z_stack, y) -> x_stack``: D draws (z_stack (D, B, ...)) for the
    same B conditions (y (B, ...)) in one pass of batch D*B. The draws are
    folded into the batch axis by a reshape, not a loop over calls, so the
    device sees one large batch and the per-call cost is paid once."""

    def multi(z_stack, y):
        d, b = z_stack.shape[:2]
        flat_z = z_stack.reshape((d * b,) + tuple(z_stack.shape[2:]))
        flat_y = y.unsqueeze(0).expand((d,) + tuple(y.shape)).reshape(
            (d * b,) + tuple(y.shape[1:]))
        x = fn(flat_z, flat_y)
        return x.reshape((d, b) + tuple(x.shape[1:]))

    return multi


def draw_latent(seed: int, shape, device, out=None):
    """The seeded entry's latent: N(0, 1) of ``shape`` from a fresh
    ``torch.Generator`` on ``device`` seeded with ``seed`` (into ``out`` when
    given)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g, device=device, out=out)


def make_seeded_multidraw_fn(fn, draws: int, z_shape: Tuple[int, ...]):
    """``g(seed, y) -> x_stack`` (draws, B, ...): the multidraw entry with
    the latent drawn on y's device from one integer seed, so a call sends a
    seed instead of D*B latents.

    The same seed, shapes and device give the same samples whatever calls
    came before (each call seeds a fresh generator). The CPU and the card
    draw different z for one seed, and JAX's ``jax.random.normal`` draws
    others again: exact agreement with JAX goes through the entries that
    take z as an input."""
    multi = make_multidraw_fn(fn)

    def g(seed, y):
        z = draw_latent(seed, (draws, y.shape[0]) + tuple(z_shape), y.device)
        return multi(z, y)

    return g


class _Graphed:
    """One CUDA graph of ``entry`` at one input shape, with its own static
    input buffers and output: one eager warm-up call of that shape on a side
    stream, then the capture (``utils.graphs.capture``, shared with
    ``train/loop.py``'s train steps), into ``pool``. :attr:`launches` is
    what each replay launches of the hand-written kernels."""

    def __init__(self, entry, inputs, pool=None):
        self.inputs = list(inputs)
        with torch.inference_mode():
            self.graph, self.output, self.launches = graphs.capture(
                lambda: entry(*self.inputs), self.inputs[0].device, pool=pool)

    def replay(self, inputs):
        """Copy ``inputs`` into the static buffers and replay, on the current
        stream; returns the static output, which the next replay overwrites."""
        for static, t in zip(self.inputs, inputs):
            if t is not static:
                static.copy_(t)
        self.graph.replay()
        return self.output


def _aval(dtype: str, dims) -> str:
    return f"{dtype}[{','.join(str(d) for d in dims)}]"


class ServingArtifact:
    """A serving entry with its model: ``call(*args)`` as JAX's
    ``Exported.call``. Made by the ``export_*`` functions and
    :func:`load_artifact`.

    Args of ``call`` by ``kind``: "sampler" ``(z (b, *z_shape), y (b,
    *y_shape))``; "multidraw" ``(z (d, b, *z_shape), y (b, *y_shape))``;
    "seeded_multidraw" ``(seed, y (b, *y_shape))``, returning ``(draws, b,
    ...)``. Inputs may be numpy arrays or tensors; they go to the artifact's
    device as float32. The result is a tensor on that device, a copy that a
    later call does not overwrite. With ``symbolic`` False, ``b`` (and ``d``)
    must be 1."""

    def __init__(self, fn, kind: str, z_shape, y_shape, *,
                 symbolic: bool = True, draws: Optional[int] = None,
                 platforms: Optional[Sequence[str]] = None):
        if not isinstance(fn, tuple(_FAMILIES.values())):
            raise TypeError("an artifact serves a make_image_serving_fn or "
                            f"make_toy_serving_fn entry, got {type(fn).__name__}")
        if kind not in KINDS:
            raise ValueError(f"unknown entry kind {kind!r}")
        if kind == "seeded_multidraw" and not (isinstance(draws, int) and draws >= 1):
            raise ValueError(f"a seeded multidraw entry needs draws >= 1, got {draws!r}")
        # the artifact's own model: later training of the caller's does not
        # reach it, as JAX bakes the parameters into the artifact
        self.fn = dataclasses.replace(fn, model=copy.deepcopy(fn.model))
        self.kind, self.draws, self.symbolic = kind, draws, symbolic
        self.z_shape, self.y_shape = tuple(z_shape), tuple(y_shape)
        self.device = self.fn.model.device
        self.platforms = list(platforms) if platforms is not None else [self.device.type]
        bad = [p for p in self.platforms if p not in PLATFORMS]
        if bad:
            raise ValueError(f"platforms {bad}: the port serves on {PLATFORMS}")
        if self.device.type not in self.platforms:
            raise ValueError(f"the model lies on {self.device}, which platforms "
                             f"{self.platforms} leave out")
        # what a graph captures: z and y in, x out (the seeded entry draws
        # its z into the graph's static buffer before each replay)
        self._zy_fn = self.fn if kind == "sampler" else make_multidraw_fn(self.fn)
        self.entry = (make_seeded_multidraw_fn(self.fn, draws, self.z_shape)
                      if kind == "seeded_multidraw" else self._zy_fn)
        # call's graphs, one a shape, (z shape, y shape) -> _Graphed; they
        # share one memory pool (see graph)
        self._graphs = {}
        self._pool = None

    @property
    def fun_name(self) -> str:
        return {"sampler": "fn", "multidraw": "multi", "seeded_multidraw": "g"}[self.kind]

    @property
    def in_avals(self):
        b = "b" if self.symbolic else 1
        y = _aval("float32", (b,) + self.y_shape)
        if self.kind == "sampler":
            return [_aval("float32", (b,) + self.z_shape), y]
        if self.kind == "multidraw":
            return [_aval("float32", ("d" if self.symbolic else 1, b) + self.z_shape), y]
        return ["int32[]", y]

    @property
    def out_avals(self):
        b = "b" if self.symbolic else 1
        lead = {"sampler": (b,), "multidraw": ("d" if self.symbolic else 1, b),
                "seeded_multidraw": (self.draws, b)}[self.kind]
        dtype, tail = self.fn.out_aval(self.z_shape, self.y_shape)
        return [_aval(dtype, lead + tail)]

    def _tensor(self, a, want_tail, what):
        t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        if tuple(t.shape[-len(want_tail):]) != want_tail:
            raise ValueError(f"{what}: shape {tuple(t.shape)} does not end in {want_tail}")
        return t.contiguous()

    def _check_batch(self, y, z=None):
        b = y.shape[0]
        if y.dim() != 1 + len(self.y_shape):
            raise ValueError(f"y: shape {tuple(y.shape)} is not (b, *{self.y_shape})")
        lead = () if z is None else tuple(z.shape[:z.dim() - len(self.z_shape)])
        if z is not None and lead[-1:] != (b,):
            raise ValueError(f"z {tuple(z.shape)} and y {tuple(y.shape)}: batches differ")
        if not self.symbolic and (b != 1 or any(d != 1 for d in lead)):
            raise ValueError(f"this artifact was exported with a fixed batch of 1; got "
                             f"{tuple(y.shape) if z is None else tuple(z.shape)}")

    def _args(self, args):
        """(seed or None, z or None, y) checked and on the device."""
        if len(args) != 2:
            raise TypeError(f"call takes 2 arguments, got {len(args)}")
        a0, y = args
        y = self._tensor(y, self.y_shape, "y")
        if self.kind == "seeded_multidraw":
            seed = int(a0.item() if torch.is_tensor(a0) else a0)
            self._check_batch(y)
            return seed, None, y
        z = self._tensor(a0, self.z_shape, "z")
        if z.dim() != len(self.z_shape) + (1 if self.kind == "sampler" else 2):
            raise ValueError(f"z: shape {tuple(z.shape)} has the wrong rank for a "
                             f"{self.kind} entry")
        self._check_batch(y, z)
        return None, z, y

    def _key(self, y_shape, z_shape=None):
        if z_shape is None:  # the seeded entry: its latent shape is fixed
            z_shape = (self.draws, y_shape[0]) + self.z_shape
        return tuple(z_shape), tuple(y_shape)

    def capture(self, y_shape, z_shape=None, pool=None) -> _Graphed:
        """A new CUDA graph of the entry at these input shapes, with its own
        static inputs, captured into ``pool`` (a private one when None)."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the artifact on the card, not {self.device}")
        key = self._key(y_shape, z_shape)
        return _Graphed(self._zy_fn, [torch.zeros(shape, device=self.device) for shape in key],
                        pool=pool)

    def graph(self, y_shape, z_shape=None) -> _Graphed:
        """:meth:`call`'s graph at these input shapes, captured at the first
        call of the shapes. All of them share one memory pool, so that the
        graphs of many batch sizes hold their outputs and the intermediates
        of the largest, not the sum of every graph's intermediates. A replay
        may therefore overwrite another graph's static output; that is safe
        because :meth:`call` replays one graph at a time on one stream and
        copies its output out before the next."""
        key = self._key(y_shape, z_shape)
        if key not in self._graphs:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[key] = self.capture(y_shape, z_shape, pool=self._pool)
        return self._graphs[key]

    def _replay(self, graphed, seed, z, y):
        """One replay of ``graphed`` for these inputs (z drawn from ``seed``
        when given); returns its static output."""
        if seed is not None:
            z = draw_latent(seed, graphed.inputs[0].shape, self.device, out=graphed.inputs[0])
        return graphed.replay([z, y])

    def call(self, *args):
        seed, z, y = self._args(args)
        if self.device.type == "cpu":
            return self.entry(seed, y) if seed is not None else self.entry(z, y)
        graphed = self.graph(y.shape, None if z is None else z.shape)
        return self._replay(graphed, seed, z, y).clone()


def export_sampler(fn, arg_shapes: Sequence[Tuple[int, ...]], *,
                   symbolic_batch: bool = True,
                   platforms: Optional[Sequence[str]] = None) -> ServingArtifact:
    """The artifact of ``fn(z, y)``; ``arg_shapes`` are z's and y's shapes
    without the shared leading batch, which is free ("symbolic") by default
    or fixed at 1. ``platforms`` (``cuda``/``cpu``) default to the model's
    device; a file saved from the artifact loads on any of them."""
    z_shape, y_shape = arg_shapes
    return ServingArtifact(fn, "sampler", z_shape, y_shape, symbolic=symbolic_batch,
                           platforms=platforms)


def export_multidraw_sampler(fn, z_shape, y_shape, *,
                             symbolic: bool = True,
                             platforms: Optional[Sequence[str]] = None) -> ServingArtifact:
    """The artifact of :func:`make_multidraw_fn` ``(fn)``: z (d, b, *z_shape)
    and y (b, *y_shape), ``d`` and ``b`` both free by default."""
    return ServingArtifact(fn, "multidraw", z_shape, y_shape, symbolic=symbolic,
                           platforms=platforms)


def export_seeded_multidraw_sampler(fn, draws: int, z_shape, y_shape, *,
                                    symbolic: bool = True,
                                    platforms: Optional[Sequence[str]] = None
                                    ) -> ServingArtifact:
    """The artifact of :func:`make_seeded_multidraw_fn` ``(fn, draws,
    z_shape)``: a seed and y (b, *y_shape); ``draws`` is fixed."""
    return ServingArtifact(fn, "seeded_multidraw", z_shape, y_shape, symbolic=symbolic,
                           draws=draws, platforms=platforms)


class PipelinedSampler:
    """Throughput wrapper for a seeded multidraw artifact: chunk k of a
    request uses seed ``start_seed + k``, so the result is that of
    sequential calls, bit for bit.

    JAX keeps ``n_in_flight`` calls outstanding from threads so that
    transport overlaps compute. On one card the port keeps ``n_in_flight``
    CUDA graphs of the entry for each input shape it has served, each with
    its own static buffers and its own memory pool (a replay must not
    overwrite an output that is still being copied out): the replays
    queue on the current stream while a second stream copies each finished
    chunk into pinned host memory (``non_blocking``, one event a chunk); a
    graph is replayed again only after its last chunk has been copied out.
    On the CPU the calls run one after another.

    Args:
        artifact: an ``export_seeded_multidraw_sampler`` artifact.
        draws_per_call: the D baked into it.
        n_in_flight: graphs in rotation (1 = sequential replays).
    """

    def __init__(self, artifact: ServingArtifact, draws_per_call: int, n_in_flight: int = 4):
        if artifact.kind != "seeded_multidraw":
            raise ValueError(f"PipelinedSampler needs a seeded multidraw artifact, not "
                             f"{artifact.kind!r}")
        if draws_per_call != artifact.draws:
            raise ValueError(f"draws_per_call {draws_per_call} != the artifact's "
                             f"{artifact.draws}")
        self._artifact = artifact
        self._draws = draws_per_call
        self._n = max(1, n_in_flight)
        self._graphs = {}  # y shape -> the graphs in rotation

    def sample(self, y, total_draws: int, start_seed: int = 0) -> np.ndarray:
        """>= ``total_draws`` samples for each condition row of ``y``: a
        numpy array (ceil(total/D)*D, B, ...) in seed order."""
        if total_draws < 1:
            raise ValueError(f"total_draws must be >= 1, got {total_draws}")
        art = self._artifact
        n_calls = -(-total_draws // self._draws)
        if art.device.type == "cpu":
            return np.concatenate([art.call(start_seed + k, y).numpy()
                                   for k in range(n_calls)])
        _, _, y = art._args((start_seed, y))
        graphs = self._graphs.get(tuple(y.shape))
        if graphs is None:
            graphs = [art.capture(y.shape) for _ in range(self._n)]
            self._graphs[tuple(y.shape)] = graphs
        first = graphs[0].output
        host = torch.empty((n_calls * self._draws,) + tuple(first.shape[1:]),
                           dtype=first.dtype, pin_memory=True)
        compute = torch.cuda.current_stream(art.device)
        copier = torch.cuda.Stream(art.device)
        copied = [None] * len(graphs)  # when each graph's last chunk was copied out
        for k in range(n_calls):
            i = k % len(graphs)
            if copied[i] is not None:
                compute.wait_event(copied[i])
            out = art._replay(graphs[i], start_seed + k, None, y)
            done = torch.cuda.Event()
            done.record(compute)
            copier.wait_event(done)
            with torch.cuda.stream(copier):
                host[k * self._draws:(k + 1) * self._draws].copy_(out, non_blocking=True)
            copied[i] = torch.cuda.Event()
            copied[i].record(copier)
        copier.synchronize()
        return host.numpy()


def save_artifact(path: str, artifact: ServingArtifact, metadata: Optional[dict] = None):
    """Write ``<path>`` (one ``torch.save`` file of tensors and plain
    containers: the config, the weights and the entry) and the
    ``<path>.json`` sidecar with the JAX sidecar's keys; returns the
    sidecar. ``family`` names the model the file holds ("conv" or "toy")."""
    fn = artifact.fn
    payload = {
        "format": FORMAT,
        "family": fn.family,
        "config": dataclasses.asdict(fn.model.cfg),
        "state_dict": {k: v.detach().cpu() for k, v in fn.model.state_dict().items()},
        "entry": {
            "kind": artifact.kind, "draws": artifact.draws, "symbolic": artifact.symbolic,
            "z_shape": artifact.z_shape, "y_shape": artifact.y_shape,
            "platforms": list(artifact.platforms),
            # the serving function's own fields (x_d, and the conv
            # post-processing)
            **{f.name: getattr(fn, f.name) for f in dataclasses.fields(fn)
               if f.name != "model"},
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)
    side = {
        "format": FORMAT,
        "fun_name": artifact.fun_name,
        "platforms": list(artifact.platforms),
        "in_avals": artifact.in_avals,
        "out_avals": artifact.out_avals,
        "nr_bytes": os.path.getsize(path),
        # nested, so that it can never clobber the fields above
        "metadata": dict(metadata or {}),
    }
    with open(path + ".json", "w") as f:
        json.dump(side, f, indent=2)
    return side


def load_artifact(path: str, device=None) -> ServingArtifact:
    """The artifact :func:`save_artifact` wrote, its model rebuilt on
    ``device`` (the card unless ``device="cpu"``): a ``ToyCINN`` or a
    ``ConvCFlow`` as the file's ``family`` says (files written before it
    was recorded hold a ``ConvCFlow``); call it with
    ``loaded.call(*args)``."""
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    device = resolve_device(device)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a serving artifact of this package "
                         f"(format {payload.get('format')!r})")
    entry = payload["entry"]
    if device.type not in entry["platforms"]:
        raise ValueError(f"{path} was exported for {entry['platforms']}, not {device.type}")
    family = payload.get("family", "conv")
    if family not in _FAMILIES:
        raise ValueError(f"{path}: unknown model family {family!r}")
    config_cls, model_cls = {"conv": (ConvFlowConfig, ConvCFlow),
                             "toy": (ToyConfig, ToyCINN)}[family]
    cfg = config_cls(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in payload["config"].items()})
    model = model_cls(cfg, device=device)
    model.load_state_dict(payload["state_dict"])
    fn_cls = _FAMILIES[family]
    fn = fn_cls(model, **{f.name: entry[f.name] for f in dataclasses.fields(fn_cls)
                          if f.name != "model"})
    return ServingArtifact(fn, entry["kind"], entry["z_shape"], entry["y_shape"],
                           symbolic=entry["symbolic"], draws=entry["draws"],
                           platforms=entry["platforms"])
