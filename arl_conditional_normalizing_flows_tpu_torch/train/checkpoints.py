"""Checkpoint / resume with architecture metadata (port of the JAX
``train/checkpoints.py``).

The reference encodes the architecture into checkpoint FILENAMES
(conv_cINN.py:519, 639-641). Here, as in the JAX package, the config is
stored as ``arch.json`` inside the checkpoint directory and checked on
restore. Each epoch is a subdirectory ``<epoch>/`` holding one
``torch.save`` file with the parameters, the optimizer's state and the step,
and the training generator's state when the caller passes it.

JAX writes orbax directories, which need orbax to read. Weights move between
the two packages through the flat ``.npz`` of :func:`save_params_npz`, whose
keys are ``jax.tree_util.keystr`` paths of the flax tree
(``['params']['couplings_0']['net_ab']['Conv_0']['kernel']``) plus
``__extra__*`` values: an ``.npz`` written by either package loads into the
other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (
    flax_from_state_dict,
    state_dict_from_flax,
)

STATE_FILE = "state.pt"
#: optimizer flags that describe where the optimizer runs, not its state:
#: a restore keeps the live optimizer's (a checkpoint written on the CPU
#: restores into a capturable Adam on the card)
_PLACEMENT_KEYS = ("capturable", "foreach", "fused", "differentiable")


def _config_to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


# arch.json dicts written before the four lowering booleans collapsed into
# the single ``experimental_lowering`` knob carry the old keys; they describe
# the identical architecture
_LEGACY_LOWERING_KEYS = {
    "use_pallas_coupling": "pallas_coupling",
    "fuse_dilated_conv": "fused_dilated",
    "dense_masked_groups": "dense_groups",
    "fused_pallas_subnet": "pallas_subnet",
}


def _normalize_meta(d: dict, config=None) -> dict:
    """``d`` with legacy lowering keys mapped to ``experimental_lowering``
    and, when ``config`` (a dataclass or its instance) is given, fields
    added to it after ``d`` was written filled with their defaults (as JSON
    values, so that they compare equal to a JSON-loaded dict)."""
    if any(k in d for k in _LEGACY_LOWERING_KEYS):
        lowering = None
        for old_key, value in _LEGACY_LOWERING_KEYS.items():
            if d.pop(old_key, False):
                lowering = value
        d.setdefault("experimental_lowering", lowering)
    if config is not None:
        for f in dataclasses.fields(config):
            if f.name in d:
                continue
            if f.default is not dataclasses.MISSING:
                default = f.default
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                default = f.default_factory()  # type: ignore[misc]
            else:
                continue
            d[f.name] = json.loads(json.dumps(default))
    return d


def read_arch(directory: str, config_cls) -> object:
    """The config stored in ``<directory>/arch.json`` as a ``config_cls``
    (legacy keys and later-added fields normalized, lists back to tuples)."""
    with open(os.path.join(directory, "arch.json")) as f:
        raw = _normalize_meta(json.load(f), config_cls)
    return config_cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()})


class CheckpointManager:
    """Checkpoints of (parameters, optimizer state, step) by epoch, with the
    architecture in ``arch.json``.

    ``create=False`` opens an EXISTING checkpoint directory for restore: a
    missing directory, or one without an epoch of this package, raises
    ``FileNotFoundError`` instead of being created and then "restored" into
    an untrained model. ``max_to_keep`` epochs are kept, the highest.
    """

    def __init__(self, directory: str, config=None, max_to_keep: int = 3,
                 create: bool = True):
        self.directory = os.path.abspath(directory)
        if not create and not os.path.isdir(self.directory):
            raise FileNotFoundError(f"checkpoint directory does not exist: {self.directory}")
        os.makedirs(self.directory, exist_ok=True)
        self.config = config
        self.max_to_keep = max_to_keep
        if not create and self.latest_epoch() is None:
            raise FileNotFoundError(
                f"no checkpoint epochs of this package in {self.directory} (each is an "
                f"<epoch>/{STATE_FILE}); a JAX orbax checkpoint directory cannot be read "
                "without orbax: export its weights with the JAX package's save_params_npz "
                "and load the .npz")
        self._meta_path = os.path.join(self.directory, "arch.json")
        if config is not None:
            self._write_or_check_meta(write=create)

    def _write_or_check_meta(self, write: bool = True):
        meta = _config_to_json(self.config)
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                existing = f.read()
            if _normalize_meta(json.loads(existing), self.config) != _normalize_meta(
                    json.loads(meta)):
                raise ValueError(
                    "checkpoint directory was written with a different architecture:\n"
                    f"  stored: {existing}\n  current: {meta}\n"
                    "(the reference encodes this contract in filenames, conv_cINN.py:519; "
                    "here it is enforced)")
        elif write:
            with open(self._meta_path, "w") as f:
                f.write(meta)

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, str(int(epoch)))

    def all_epochs(self):
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)):
                out.append(int(name))
        return sorted(out)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state, generator=None) -> None:
        """Write ``state`` (a port ``TrainState``) as ``epoch``, replacing an
        epoch of that number: the final best-parameters save after early
        stopping may land on an epoch a cadence checkpoint already wrote.
        With ``generator``, its state is saved too, so that a resumed run
        goes on drawing where this one stopped (JAX keys each epoch by its
        number instead)."""
        payload = {
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "opt_state": state.optimizer.state_dict(),
            "step": state.step,
        }
        if generator is not None:
            payload["generator"] = generator.get_state()
        path = self._epoch_dir(epoch)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        for old in self.all_epochs()[:-self.max_to_keep]:
            shutil.rmtree(self._epoch_dir(old))

    def restore(self, state, epoch: Optional[int] = None, generator=None):
        """Load ``epoch`` (default: the latest) into ``state``, a freshly
        created ``TrainState`` of the same architecture, in place, and into
        ``generator`` the state saved with the epoch (an epoch saved without
        one raises); returns ``(epoch, state)``, or ``(None, state)`` when
        there is no epoch."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            return None, state
        payload = torch.load(os.path.join(self._epoch_dir(epoch), STATE_FILE),
                             map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["params"])
        opt = payload["opt_state"]
        for saved, live in zip(opt["param_groups"], state.optimizer.param_groups):
            for k in _PLACEMENT_KEYS:
                if k in live:
                    saved[k] = live[k]
        state.optimizer.load_state_dict(opt)
        if generator is not None:
            if "generator" not in payload:
                raise ValueError(f"epoch {epoch} in {self.directory} was saved without the "
                                 "generator's state, so a run cannot resume its draws")
            generator.set_state(payload["generator"])
        return epoch, state


_KEY_PART = re.compile(r"\['([^']*)'\]")


def _keystr(path) -> str:
    return "".join(f"['{p}']" for p in path)


def _parse_keystr(key: str):
    parts = _KEY_PART.findall(key)
    if _keystr(parts) != key:
        raise ValueError(f"not a jax.tree_util.keystr path of dict keys: {key!r}")
    return parts


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def save_params_npz(path: str, model, extra: Optional[dict] = None) -> None:
    """Flat single-file export of ``model``'s weights in the JAX package's
    format: the flax variables ``{"params": ...}`` (``flax_from_state_dict``)
    under ``keystr`` keys, plus ``__extra__<k>`` for each ``extra`` value."""
    tree = {"params": flax_from_state_dict(model.state_dict(), model)}
    arrays = {_keystr(p): np.asarray(v) for p, v in _flatten(tree)}
    for k, v in (extra or {}).items():
        arrays[f"__extra__{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_npz_extras(path: str) -> dict:
    """The ``__extra__*`` values of a :func:`save_params_npz` file (e.g. the
    ``arch`` string), by name."""
    prefix = "__extra__"
    with np.load(path, allow_pickle=False) as data:
        return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


def load_params_npz(path: str, model):
    """Load a :func:`save_params_npz` file (written by this package or the
    JAX package) into ``model``'s parameters in place; returns ``model``.
    Raises on a key the model lacks, a parameter left unset or a shape
    mismatch (``state_dict_from_flax``)."""
    tree = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key.startswith("__extra__"):
                continue
            *parents, leaf = _parse_keystr(key)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    if set(tree) != {"params"}:
        raise KeyError(f"{path}: expected one top-level 'params' tree, got {sorted(tree)}")
    model.load_state_dict(state_dict_from_flax(tree["params"], model))
    return model
