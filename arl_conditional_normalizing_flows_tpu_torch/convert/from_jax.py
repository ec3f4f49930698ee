"""Flax params <-> the port's state_dicts, for ``ConvCFlow`` and ``ToyCINN``.

The flax tree is given as nested dicts of numpy arrays (e.g. a JAX
checkpoint loaded with numpy), so this module needs neither jax nor flax.
Conv name map, per coupling ``couplings_i`` and subnet ``net_ab``/``net_a``/
``net_b``:

==============================================  =============================
flax                                            port
==============================================  =============================
``Conv_0``                                      ``conv_in``
``DilatedResidualBlock_r/Conv_0``               ``blocks.r.conv_pre``
``DilatedResidualBlock_r/Conv_j`` (1 <= j <= n) ``blocks.r.branches.{j-1}``
``DilatedResidualBlock_r/Conv_{n+1}``           ``blocks.r.conv_post``
``DilatedResidualBlock_r/FlatLayerNorm_i``      ``blocks.r.norms.i``
``FlatLayerNorm_0``                             ``norm``
``Conv_1``                                      ``head``
``tanh_scale``                                  ``tanh_scale``
==============================================  =============================

with ``n`` the block's number of dilated branches. Conv kernels go from
HWIO ``(k, k, cin/g, cout)`` to OIHW ``(cout, cin/g, k, k)`` (at cardinality
1 a branch's kernel is ``(k, k, K, K/d)``, dense over the whole trunk); LayerNorm
``LayerNorm_0/scale`` and ``bias`` become ``weight`` and ``bias``. The
``pallas_subnet`` lowering's subnets keep the same leaves under dotted names
(``DilatedResidualBlock_0.Conv_1.kernel``); each is split into its path
parts, so both trees map to the same port parameters.

The other two lowerings name a block's leaves otherwise. Under
``dense_groups`` a block with grouped branches holds ``Conv_0`` (pre),
``DenseMaskedGroupConv_i`` (branch ``i``, the grouped kernel's shape) and
``Conv_1`` (post); under ``fused_dilated`` a block with more than one
dilation holds ``Conv_0``, ``fused_dil_kernel`` (HWIO ``(K, K, nb,
sum(nb/d))`` to the port's OIHW), ``fused_dil_bias`` and ``Conv_1``, which are
``blocks.r.fused_dil_kernel`` and ``blocks.r.fused_dil_bias`` in the port.

Toy: ``couplings_j/Dense_i`` is ``couplings.j.dense.i``, the Dense layers
numbered in flax's creation order (the b stack, the b head, the A stack, the
A head, ``models/subnets.py::DenseCouplingNet``); kernels go from ``(in,
out)`` to ``(out, in)``.

:func:`flax_from_state_dict` maps back, for ``.npz`` files that the JAX
package reads.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        path = prefix + tuple(k.split("."))
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


def _index(name, stem):
    m = re.fullmatch(rf"{stem}_(\d+)", name)
    return None if m is None else int(m.group(1))


def _leaf(path, value, n_convs):
    """(port key, tensor) for one flax leaf, or None when unmapped.

    ``n_convs`` maps a residual block's flax path to its number of
    ``Conv_*`` modules (branches + 2)."""
    if len(path) < 3 or _index(path[0], "couplings") is None:
        return None
    if path[1] not in ("net_ab", "net_a", "net_b"):
        return None
    prefix = f"couplings.{_index(path[0], 'couplings')}.{path[1]}"
    rest = path[2:]
    if rest == ("tanh_scale",):
        return f"{prefix}.tanh_scale", np.asarray(value, np.float32)

    r = _index(rest[0], "DilatedResidualBlock")
    if r is not None:
        prefix, rest = f"{prefix}.blocks.{r}", rest[1:]
        if rest in (("fused_dil_kernel",), ("fused_dil_bias",)):
            arr = np.asarray(value, np.float32)
            if rest[0] == "fused_dil_kernel":
                if arr.ndim != 4:
                    return None
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            return f"{prefix}.{rest[0]}", arr
        j = _index(rest[0], "Conv") if rest else None
        nc = n_convs.get(path[:3], 0)
        module = (None if j is None else
                  "conv_pre" if j == 0 else
                  "conv_post" if j == nc - 1 else
                  f"branches.{j - 1}")
        i = _index(rest[0], "DenseMaskedGroupConv") if rest else None
        if i is not None:
            module = f"branches.{i}"
        i = _index(rest[0], "FlatLayerNorm") if rest else None
        if i is not None:
            module = f"norms.{i}"
    else:
        j = _index(rest[0], "Conv")
        module = {0: "conv_in", 1: "head"}.get(j)
        if rest[0] == "FlatLayerNorm_0":
            module = "norm"
    if module is None:
        return None
    rest = rest[1:]
    if module.startswith("norm"):
        param = {("LayerNorm_0", "scale"): "weight", ("LayerNorm_0", "bias"): "bias"}.get(rest)
        arr = np.asarray(value, np.float32)
    else:
        param = {("kernel",): "weight", ("bias",): "bias"}.get(rest)
        arr = np.asarray(value, np.float32)
        if param == "weight":
            if arr.ndim != 4:
                return None
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if param is None:
        return None
    return f"{prefix}.{module}.{param}", arr


def _toy_leaf(path, value):
    """(port key, array) for one leaf of a flax ``ToyCINN``, or None."""
    if len(path) != 3:
        return None
    j, i = _index(path[0], "couplings"), _index(path[1], "Dense")
    if j is None or i is None:
        return None
    arr = np.asarray(value, np.float32)
    if path[2] == "kernel" and arr.ndim == 2:
        return f"couplings.{j}.dense.{i}.weight", arr.T  # (in, out) -> (out, in)
    if path[2] == "bias":
        return f"couplings.{j}.dense.{i}.bias", arr
    return None


def _is_toy(model) -> bool:
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    return isinstance(model, ToyCINN)


def state_dict_from_flax(params, model) -> dict:
    """The state_dict for ``model`` (a port ``ConvCFlow`` or ``ToyCINN``)
    holding the flax ``params`` tree (``variables["params"]``, nested dicts
    of arrays).

    Raises ``KeyError`` on a flax leaf it does not map or a port parameter
    left unset, and ``ValueError`` on a shape mismatch.
    """
    leaves = list(_flatten(params))
    n_convs = {}
    for path, _ in leaves:
        if len(path) >= 5 and _index(path[2], "DilatedResidualBlock") is not None:
            if _index(path[3], "Conv") is not None:
                n_convs[path[:3]] = n_convs.get(path[:3], set()) | {path[3]}
    n_convs = {k: len(v) for k, v in n_convs.items()}
    toy = _is_toy(model)

    target = model.state_dict()
    out = {}
    unmapped = []
    for path, value in leaves:
        mapped = _toy_leaf(path, value) if toy else _leaf(path, value, n_convs)
        if mapped is None or mapped[0] not in target:
            unmapped.append("/".join(path))
            continue
        key, arr = mapped
        if key in out:
            raise KeyError(f"two flax params map to {key}: {'/'.join(path)}")
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"{'/'.join(path)} -> {key}: shape {arr.shape} "
                             f"!= {tuple(target[key].shape)}")
        # np.array, not np.ascontiguousarray, which turns a 0-d tanh_scale
        # into shape (1,); and a writable copy for torch
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(
            device=target[key].device, dtype=target[key].dtype)
    if unmapped:
        raise KeyError(f"flax params with no port counterpart: {unmapped}")
    unset = sorted(set(target) - set(out))
    if unset:
        raise KeyError(f"port parameters not set from the flax params: {unset}")
    return out


def _flax_path(key, nets, conv_branches):
    """The flax path of the port parameter ``key``: the inverse of
    :func:`_leaf`. ``nets`` maps a ``couplings.i.<net>`` prefix to whether
    its leaves are dotted (the ``pallas_subnet`` lowering's subnets);
    ``conv_branches`` maps a residual block's prefix to the number of its
    branches that flax names ``Conv_*`` (none for dense-masked branches or
    a fused dilated conv)."""
    parts = key.split(".")
    net = ".".join(parts[:3])
    head = (f"couplings_{parts[1]}", parts[2])
    rest, param = parts[3:-1], parts[-1]
    if not rest:  # tanh_scale
        return head + (param,)
    if rest[0] == "blocks":
        block = f"DilatedResidualBlock_{rest[1]}"
        if len(rest) == 2:  # fused_dil_kernel, fused_dil_bias
            inner = (block, param)
            return head + ((".".join(inner),) if nets[net] else inner)
        kind = rest[2]
        n_conv = conv_branches[".".join(parts[:5])]
        if kind == "norms":
            inner = (block, f"FlatLayerNorm_{rest[3]}", "LayerNorm_0")
        elif kind == "branches" and not n_conv:
            inner = (block, f"DenseMaskedGroupConv_{rest[3]}")
        else:
            j = {"conv_pre": 0, "conv_post": n_conv + 1}.get(kind)
            inner = (block, f"Conv_{int(rest[3]) + 1 if j is None else j}")
    elif rest[0] == "norm":
        inner = ("FlatLayerNorm_0", "LayerNorm_0")
    else:
        inner = ({"conv_in": "Conv_0", "head": "Conv_1"}[rest[0]],)
    leaf = {"weight": "scale" if "LayerNorm_0" in inner else "kernel", "bias": "bias"}[param]
    inner = inner + (leaf,)
    return head + ((".".join(inner),) if nets[net] else inner)


def _toy_flax_from_state_dict(state_dict) -> dict:
    tree = {}
    for key, value in state_dict.items():
        _, j, _, i, param = key.split(".")  # couplings.j.dense.i.<param>
        arr = value.detach().cpu().float().numpy()
        leaf = {"weight": "kernel", "bias": "bias"}[param]
        node = tree.setdefault(f"couplings_{j}", {}).setdefault(f"Dense_{i}", {})
        node[leaf] = np.array(arr.T if leaf == "kernel" else arr, order="C")
    return tree


def flax_from_state_dict(state_dict, model) -> dict:
    """The flax ``params`` tree (``variables["params"]``: nested dicts of
    float32 numpy arrays) holding ``state_dict`` of ``model`` (a port
    ``ConvCFlow`` or ``ToyCINN``, or any module whose parameters sit at the
    same paths): the exact inverse of :func:`state_dict_from_flax`. Conv
    kernels go from OIHW back to HWIO, the subnets of the ``pallas_subnet``
    lowering get flax's dotted leaf names; toy kernels go back to ``(in,
    out)``."""
    from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (
        DenseMaskedGroupConv,
        FusedChainCouplingNet,
    )

    if _is_toy(model):
        return _toy_flax_from_state_dict(state_dict)
    nets, conv_branches = {}, {}
    for name, module in model.named_modules():
        parts = name.split(".")
        if len(parts) == 3 and parts[0] == "couplings":
            nets[name] = isinstance(module, FusedChainCouplingNet)
        if len(parts) == 5 and parts[3] == "blocks":
            conv_branches[name] = sum(not isinstance(b, DenseMaskedGroupConv)
                                      for b in module.branches)
    tree = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().float().numpy()
        if arr.ndim == 4:  # conv kernels and fused_dil_kernel
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = tree
        *path, leaf = _flax_path(key, nets, conv_branches)
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(arr, order="C")
    return tree


def load_optax_adam_state(state, mu, nu, count):
    """Carry an optax Adam state across into ``state`` (a port ``TrainState``
    whose optimizer is ``torch.optim.Adam``), in place, so that a JAX run in
    the middle of training continues in the port; returns ``state``.

    ``mu``, ``nu`` and ``count`` are the fields of optax's
    ``ScaleByAdamState`` (``opt_state[0]`` of ``optax.adam``): ``mu`` and
    ``nu`` are trees shaped like the flax params (``variables["params"]``,
    nested dicts of arrays) and are mapped as :func:`state_dict_from_flax`
    maps the weights; they become Adam's ``exp_avg`` and ``exp_avg_sq``, and
    ``count`` its ``step``. Existing state tensors are written in place (a
    captured CUDA graph holds their addresses).
    """
    model, optimizer = state.model, state.optimizer
    mus, nus = state_dict_from_flax(mu, model), state_dict_from_flax(nu, model)
    group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        group = group_of[p]
        on_device = group.get("capturable")
        step = torch.tensor(float(np.asarray(count)), dtype=torch.float32,
                            device=p.device if on_device else "cpu")
        s = optimizer.state[p]
        for key, value in (("step", step), ("exp_avg", mus[name]), ("exp_avg_sq", nus[name])):
            if key in s:
                s[key].copy_(value)
            else:
                s[key] = value.clone()
    return state
