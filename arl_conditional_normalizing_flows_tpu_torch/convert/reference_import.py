"""TF-free importer for reference-trained checkpoints (port of the JAX
``convert/reference_import.py``).

Users migrating from the reference hold:

- **conv**: Keras ``save_weights`` files, ``weights_{type}_{dataset}_
  {h}x{w}x{d}_SqFa…_NRB…_C…_NK…_KS…_D…_LN….h5`` (conv_cINN.py:639-641) or the
  cadence checkpoints ``checkpoint_… .e{epoch}.hdf5`` (conv_cINN.py:517-526),
  in the TF2/Keras-2 flat HDF5 layout or the Keras-3 nested one;
- **toy**: an object-array ``weights_….npy`` of per-coupling-layer
  ``get_weights()`` lists plus the ``mask_indices_….npy`` layer-order
  permutation (TOYcINN.py:306-317), which is part of the model's identity
  (TOYcINN.py:228-235).

Both are converted into the flax-layout parameter tree (nested dicts of
float32 numpy arrays, ``{"params": ...}``) that ``save_params_npz`` writes
and both packages' ``load_params_npz`` read, with h5py (imported only when a
conv file is read) and numpy alone, from the reference's deterministic layer
creation order:

- toy coupling: the b-stack Dense layers first, then the A stack
  (TOYcINN_make_model.py:52-95);
- conv coupling: model_b's convs first, then model_A's
  (conv_cINN_make_model.py:1115-1205); a subnet: trunk conv, then per res
  block [LN?, 1x1-in, LN?, per-dilation x per-cardinality group convs, LN?,
  1x1-out] (conv_cINN_base_functions.py:573-627), then the top-level LN?,
  the head conv, and (A only) the tanh_scaling_layer scalar;
- per-group Conv2D kernels concatenate along the output axis into one
  grouped conv.

The template is the flax-layout tree of a port model built on the CPU
(``convert/from_jax.py::flax_from_state_dict``), so nothing of JAX is
needed. Every placement is shape-checked against it, and a leaf the file
does not fill raises: the port's initial weights are not JAX's, so a leaf
left at them would load a model that is neither.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Keras h5 readers (both layouts), normalized to
#   [ per coupling: {"A": {"convs": [(k, b), ...], "lns": [(g, be), ...],
#                          "scale": s|None},
#                    "b": {...}} ]
# ---------------------------------------------------------------------------


def _suffix_index(name: str) -> int:
    """Keras auto-names: 'conv2d' -> 0, 'conv2d_7' -> 7."""
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else 0


def _read_keras3(f) -> List[dict]:
    """Keras 3 ``.weights.h5``: nested groups
    ``layers/coupling_layer_{j}/model_{A,b}/layers/<layer>/vars/{0,1}``."""
    layers = f["layers"]
    couplings = []
    names = [k for k in layers.keys() if k.startswith("coupling_layer")]
    for cname in sorted(names, key=_suffix_index):
        group = layers[cname]
        entry = {}
        for side, gname in (("A", "model_A"), ("b", "model_b")):
            sub = group[gname]["layers"]
            convs, lns, scale = [], [], None
            for lname in sorted(sub.keys(), key=_suffix_index):
                v = sub[lname].get("vars")
                if v is None or len(v) == 0:
                    continue
                arrs = [np.asarray(v[str(i)]) for i in range(len(v))]
                if lname.startswith("conv2d"):
                    convs.append((arrs[0], arrs[1]))
                elif lname.startswith("layer_normalization"):
                    lns.append((arrs[0], arrs[1]))
                elif lname.startswith("tanh_scaling"):
                    scale = arrs[0]
            entry[side] = {"convs": convs, "lns": lns, "scale": scale}
        couplings.append(entry)
    return couplings


def _read_keras2(f) -> List[dict]:
    """TF2/Keras-2 ``save_weights`` HDF5: root (or 'model_weights') groups per
    top-level layer, attr ``weight_names`` holding full variable paths like
    ``coupling_layer_3/model_A/conv2d_41/kernel:0`` in ``layer.weights``
    (creation) order."""
    root = f["model_weights"] if "model_weights" in f else f
    layer_names = [
        n.decode() if isinstance(n, bytes) else n
        for n in root.attrs["layer_names"]
    ]
    # accumulate (coupling_name, side, layer_name, var_kind) -> arrays in
    # file (creation) order
    per_coupling: Dict[str, dict] = {}
    order: List[str] = []
    for lname in layer_names:
        g = root[lname]
        wnames = [
            n.decode() if isinstance(n, bytes) else n
            for n in g.attrs.get("weight_names", [])
        ]
        for wn in wnames:
            parts = wn.split("/")
            cpart = next(
                (p for p in parts if p.startswith("coupling_layer")), None
            )
            mpart = next((p for p in parts if p.startswith("model_")), None)
            if cpart is None or mpart is None:
                continue
            side = "A" if mpart == "model_A" else "b"
            if cpart not in per_coupling:
                per_coupling[cpart] = {
                    "A": {"convs": [], "lns": [], "scale": None, "_half": {}},
                    "b": {"convs": [], "lns": [], "scale": None, "_half": {}},
                }
                order.append(cpart)
            dst = per_coupling[cpart][side]
            arr = np.asarray(g[wn])
            lkey = parts[-2]  # e.g. conv2d_41 / layer_normalization_3
            kind = parts[-1].split(":")[0]  # kernel/bias/gamma/beta/...
            if lkey.startswith("conv2d"):
                half = dst["_half"].setdefault(lkey, {})
                half[kind] = arr
                if "kernel" in half and "bias" in half:
                    dst["convs"].append((half["kernel"], half["bias"]))
                    del dst["_half"][lkey]
            elif lkey.startswith("layer_normalization"):
                half = dst["_half"].setdefault(lkey, {})
                half[kind] = arr
                if "gamma" in half and "beta" in half:
                    dst["lns"].append((half["gamma"], half["beta"]))
                    del dst["_half"][lkey]
            elif lkey.startswith("tanh_scaling") or "tanh_scaling" in wn:
                dst["scale"] = arr
    for c in per_coupling.values():
        for side in ("A", "b"):
            if c[side].pop("_half"):
                raise ValueError("unpaired conv/LN weights in the h5 file")
    return [per_coupling[c] for c in sorted(order, key=_suffix_index)]


def read_keras_h5(path: str) -> List[dict]:
    """Read a reference ``cFlow`` weights file (either Keras layout) into the
    normalized per-coupling structure. Needs h5py."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading a reference .h5/.hdf5 checkpoint needs h5py, which is "
                          "not installed") from e

    with h5py.File(path, "r") as f:
        if "layers" in f and "layer_names" not in f.attrs:
            return _read_keras3(f)
        return _read_keras2(f)


# ---------------------------------------------------------------------------
# conv mapping into the flax-layout tree of ConvCFlow
# ---------------------------------------------------------------------------


def _f32(arr, shape, where) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.shape != tuple(shape):
        raise ValueError(f"{where}: reference array {arr.shape} does not fit {tuple(shape)}")
    return arr


def _fill_conv_slot(slot: dict, convs: List[Tuple[np.ndarray, np.ndarray]],
                    where: str) -> dict:
    """Fill one conv param dict from the head of ``convs``; grouped
    branches (the slot's out-width a multiple of the reference's per-group
    kernels) concatenate ``n`` reference convs along the output axis."""
    kshape = np.shape(slot["kernel"])
    bshape = np.shape(slot["bias"])
    if not convs:
        raise ValueError(f"{where}: ran out of reference conv weights")
    k0 = convs[0][0]
    if k0.shape == kshape:
        k, b = convs.pop(0)
        return {"kernel": _f32(k, kshape, where), "bias": _f32(b, bshape, where)}
    # grouped: n per-group kernels (k,k,cin/g,cout/g) -> one (k,k,cin/g,cout)
    if not (k0.shape[:3] == kshape[:3] and kshape[3] % k0.shape[3] == 0):
        raise ValueError(f"{where}: reference conv {k0.shape} does not fit slot {kshape}")
    n = kshape[3] // k0.shape[3]
    if len(convs) < n:
        raise ValueError(f"{where}: ran out of reference conv weights")
    group = [convs.pop(0) for _ in range(n)]
    if any(k.shape != k0.shape for k, _ in group):
        raise ValueError(f"{where}: group kernels {[k.shape for k, _ in group]} differ")
    return {"kernel": _f32(np.concatenate([k for k, _ in group], axis=-1), kshape, where),
            "bias": _f32(np.concatenate([b for _, b in group], axis=-1), bshape, where)}


def _fill_ln_slot(slot: dict, lns: List[Tuple[np.ndarray, np.ndarray]],
                  where: str) -> dict:
    if not lns:
        raise ValueError(f"{where}: ran out of reference LayerNorm weights")
    gamma, beta = lns.pop(0)
    inner = slot["LayerNorm_0"]
    return {"LayerNorm_0": {"scale": _f32(gamma, np.shape(inner["scale"]), where),
                            "bias": _f32(beta, np.shape(inner["bias"]), where)}}


def _fill_subnet(sub: dict, ref: dict, where: str) -> dict:
    """Map one reference coupling sub-model onto one subnet's subtree,
    consuming convs and LayerNorms in the reference's creation order."""
    convs = list(ref["convs"])
    lns = list(ref["lns"])
    out = dict(sub)
    out["Conv_0"] = _fill_conv_slot(sub["Conv_0"], convs, f"{where}/trunk")
    block_keys = sorted((k for k in sub if k.startswith("DilatedResidualBlock")),
                        key=_suffix_index)
    has_ln = any(k.startswith("FlatLayerNorm") for k in sub)
    for bkey in block_keys:
        bsub = sub[bkey]
        bout = dict(bsub)
        conv_keys = sorted((k for k in bsub if k.startswith("Conv_")), key=_suffix_index)
        ln_keys = sorted((k for k in bsub if k.startswith("FlatLayerNorm")), key=_suffix_index)
        # creation order: [LN?, conv-in, LN?, branches..., LN?, conv-out]
        # (conv_cINN_base_functions.py:573-627)
        if ln_keys:
            bout[ln_keys[0]] = _fill_ln_slot(bsub[ln_keys[0]], lns, f"{where}/{bkey}/ln0")
        bout[conv_keys[0]] = _fill_conv_slot(bsub[conv_keys[0]], convs, f"{where}/{bkey}/in")
        if ln_keys:
            bout[ln_keys[1]] = _fill_ln_slot(bsub[ln_keys[1]], lns, f"{where}/{bkey}/ln1")
        for ck in conv_keys[1:-1]:
            bout[ck] = _fill_conv_slot(bsub[ck], convs, f"{where}/{bkey}/{ck}")
        if ln_keys:
            bout[ln_keys[2]] = _fill_ln_slot(bsub[ln_keys[2]], lns, f"{where}/{bkey}/ln2")
        bout[conv_keys[-1]] = _fill_conv_slot(bsub[conv_keys[-1]], convs,
                                              f"{where}/{bkey}/out")
        out[bkey] = bout
    if has_ln:
        out["FlatLayerNorm_0"] = _fill_ln_slot(sub["FlatLayerNorm_0"], lns, f"{where}/top_ln")
    out["Conv_1"] = _fill_conv_slot(sub["Conv_1"], convs, f"{where}/head")
    if convs:
        raise ValueError(f"{where}: {len(convs)} reference convs left over")
    if lns:
        raise ValueError(f"{where}: {len(lns)} reference LayerNorms left over")
    if ref.get("scale") is not None:
        if "tanh_scale" not in sub:
            raise ValueError(f"{where}: unexpected tanh scale")
        out["tanh_scale"] = _f32(np.asarray(ref["scale"]).reshape(()), (), where)
    return out


def _check_filled(template: dict, filled: dict) -> None:
    """Raise on any leaf of ``filled`` that is still the template's own
    array: the import left it at the port model's initial value."""
    left = []

    def walk(t, f, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f[k], f"{path}/{k}")
            elif f[k] is v:
                left.append(f"{path}/{k}")

    walk(template, filled, "")
    if left:
        raise ValueError(f"the reference file left {len(left)} parameters unfilled (e.g. "
                         f"{left[:4]}): a wrong architecture?")


def _template(model) -> dict:
    from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (
        flax_from_state_dict,
    )

    return flax_from_state_dict(model.state_dict(), model)


def import_conv_h5(path: str, cfg) -> dict:
    """Reference conv ``.h5``/``.hdf5`` weights -> ``{"params": tree}``, the
    flax-layout tree of ``ConvCFlow(cfg)``.

    ``cfg`` (a port ``ConvFlowConfig``) must describe the SAME architecture
    (:func:`parse_conv_filename` derives it from the reference's
    filename-encoded contract, conv_cINN.py:639-641); otherwise this raises.
    Needs h5py.
    """
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

    if cfg.fused_subnet:
        raise ValueError("reference checkpoints have separate A/b trunks; import with "
                         "fused_subnet=False")
    couplings = read_keras_h5(path)
    template = _template(ConvCFlow(cfg, device="cpu"))
    p = dict(template)
    our_keys = sorted((k for k in p if k.startswith("couplings_")), key=_suffix_index)
    if len(our_keys) != len(couplings):
        raise ValueError(
            f"architecture mismatch: the file has {len(couplings)} coupling layers, the "
            f"config builds {len(our_keys)}: check the arch flags (the reference's contract: "
            "the filename, conv_cINN.py:639-641)")
    for key, ref in zip(our_keys, couplings):
        layer = dict(p[key])
        layer["net_a"] = _fill_subnet(layer["net_a"], ref["A"], f"{key}/A")
        layer["net_b"] = _fill_subnet(layer["net_b"], ref["b"], f"{key}/b")
        p[key] = layer
    _check_filled(template, p)
    return {"params": p}


# ---------------------------------------------------------------------------
# toy import
# ---------------------------------------------------------------------------


def import_toy_npy(weights_path: str, mask_indices_path: str, cfg=None):
    """Reference toy checkpoint (object-array ``.npy`` of per-coupling
    ``get_weights()`` plus ``mask_indices.npy``, TOYcINN.py:306-317) ->
    ``({"params": tree}, mask_indices, cfg)``: the flax-layout tree of
    ``ToyCINN(cfg)``, the layer order, and the port ``ToyConfig`` (inferred
    from the file when ``cfg`` is None). The caller saves the layer order
    with the weights: it is part of the model's identity
    (TOYcINN.py:228-235)."""
    import dataclasses

    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ToyConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    ref = np.load(weights_path, allow_pickle=True)
    mask_indices = tuple(int(i) for i in np.load(mask_indices_path))
    n_couplings = len(ref)
    if n_couplings != len(mask_indices):
        raise ValueError(f"{n_couplings} couplings in {weights_path} but "
                         f"{len(mask_indices)} entries in {mask_indices_path}")
    # per coupling: 2 * (num_layers + 2) Dense (kernel, bias) pairs
    n_pairs = len(ref[0]) // 2
    num_layers = n_pairs // 2 - 2
    if cfg is None:
        cfg = ToyConfig(num_coupling_layers=n_couplings,
                        intermediate_dims=int(np.shape(ref[0][0])[1]),
                        num_layers=num_layers, mask_indices=mask_indices)
    else:
        cfg = dataclasses.replace(cfg, mask_indices=mask_indices)
    template = _template(ToyCINN(cfg, device="cpu"))
    p = dict(template)
    for j in range(n_couplings):
        flat = [np.asarray(w) for w in ref[j]]
        layer = dict(p[f"couplings_{j}"])
        dense_keys = sorted((k for k in layer if k.startswith("Dense_")), key=_suffix_index)
        if len(flat) != 2 * len(dense_keys):
            raise ValueError(f"couplings_{j}: the file has {len(flat)} arrays, the model "
                             f"{len(dense_keys)} Dense layers: wrong NL/ID architecture?")
        pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]
        # Keras functional Model.get_weights() orders layers by GRAPH DEPTH
        # (distance to the outputs), not creation order. The A chain is one
        # layer deeper than the b chain (its head feeds a tanh Activation,
        # TOYcINN_make_model.py:69-95), so the stacks come out INTERLEAVED:
        # [A_dense0, b_dense0, A_dense1, b_dense1, ..., A_head, b_head].
        # Dense_0..Dense_{NL+1} are the b stack, the rest the A stack.
        nl1 = num_layers + 1  # hidden Dense layers a stack
        order = ([2 * i + 1 for i in range(nl1)] + [2 * nl1 + 1]
                 + [2 * i for i in range(nl1)] + [2 * nl1])
        for dk, pi in zip(dense_keys, order):
            k, b = pairs[pi]
            where = f"couplings_{j}/{dk}"
            layer[dk] = {"kernel": _f32(k, np.shape(layer[dk]["kernel"]), where),
                         "bias": _f32(b, np.shape(layer[dk]["bias"]), where)}
        p[f"couplings_{j}"] = layer
    _check_filled(template, p)
    return {"params": p}, mask_indices, cfg


# ---------------------------------------------------------------------------
# filename-convention parsing (the reference's arch contract)
# ---------------------------------------------------------------------------


def _split_digit_string(s: str, n: int, valid) -> Optional[List[int]]:
    """Split a concatenated digit string into ``n`` numbers such that
    ``valid(parts)`` holds; returns the unique solution or None."""
    sols = []

    def rec(i, parts):
        if len(parts) == n:
            if i == len(s) and valid(parts):
                sols.append(list(parts))
            return
        for j in range(i + 1, len(s) + 1):
            part = s[i:j]
            if len(part) > 1 and part[0] == "0":
                continue
            rec(j, parts + [int(part)])

    rec(0, [])
    uniq = {tuple(x) for x in sols}
    if len(uniq) == 1:
        return list(next(iter(uniq)))
    return None


def parse_conv_filename(name: str) -> dict:
    """Parse the reference's arch-encoding filename
    (``…_{h}x{w}x{d}_SqFa…_NRB…_C…_NK…_KS…_D…_LN{bool}…``,
    conv_cINN.py:519,639-641) into ConvFlowConfig kwargs.

    The NK/C digit strings are concatenated without separators; the split is
    disambiguated by the model's own divisibility constraints
    (conv_cINN_make_model.py:1472-1479,1612-1617). Raises on genuine
    ambiguity — pass explicit arch flags then.
    """
    m = re.search(
        r"_(\d+)x(\d+)x(\d+)_SqFa([01]+)_NRB(\d+)_C(\d+)_NK(\d+)_KS(\d+)"
        r"_D(\d+)_LN(True|False)",
        name,
    )
    if not m:
        raise ValueError(f"filename does not match the reference arch convention: {name!r}")
    h, w, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    sqfa = [int(c) for c in m.group(4)]
    n = len(sqfa)
    nrb_s, c_s, nk_s = m.group(5), m.group(6), m.group(7)
    ksize = int(m.group(8))
    dilations = tuple(int(c) for c in m.group(9))
    layer_norm = m.group(10) == "True"
    if len(nrb_s) != n:
        raise ValueError(f"NRB digits ({nrb_s}) != number of blocks ({n}); multi-digit "
                         "res-block counts need explicit flags")
    nrb = [int(c) for c in nrb_s]
    card = _split_digit_string(c_s, n, lambda ps: all(p % 2 == 0 for p in ps))
    if card is None:
        raise ValueError(f"ambiguous cardinality string C{c_s}; pass --cardinality explicitly")

    def nk_valid(ps):
        # kernels even, divisible by cardinality and by cardinality*dilation
        # for every dilation level (conv_cINN_make_model.py:1612-1617)
        return all(
            p % 2 == 0 and p % c == 0
            and all((p // dl) % c == 0 for dl in dilations if p % dl == 0)
            for p, c in zip(ps, card)
        )

    nk = _split_digit_string(nk_s, n, nk_valid)
    if nk is None:
        raise ValueError(f"ambiguous kernel string NK{nk_s}; pass --kernels explicitly")
    return dict(
        io_shape=(h, w, d),
        squeeze_factor_blocks=tuple(sqfa),
        res_blocks=tuple(nrb),
        num_kernels=tuple(nk),
        cardinality=tuple(card),
        ksize=ksize,
        # the D digits record the derived base schedule (conv_cINN.py:85);
        # our config's bool re-derives the same per-block levels
        dilations=len(dilations) > 1 or dilations[0] > 1,
        layer_norm=layer_norm,
    )


def parse_toy_filename(name: str) -> dict:
    """``weights_{dataset}_NCL{n}_ID{d}_NL{l}.npy`` (TOYcINN.py:306-317)."""
    m = re.search(r"NCL(\d+)_ID(\d+)_NL(\d+)", name)
    if not m:
        raise ValueError(f"filename does not match the toy convention: {name!r}")
    return dict(
        num_coupling_layers=int(m.group(1)),
        intermediate_dims=int(m.group(2)),
        num_layers=int(m.group(3)),
    )
