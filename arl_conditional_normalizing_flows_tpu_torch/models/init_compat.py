"""Reference-faithful shared-shape initialization for the conv flow (port of
the JAX ``models/init_compat.py``).

The reference driver creates ONE ``tf.keras.initializers.Orthogonal(0.1)``
instance and passes it to every Conv2D (conv_cINN.py:90-91 ->
conv_cINN_make_model.py:1119 -> conv_cINN_base_functions.py:415-498). The
instance is stateless, so the reference's epoch-0 weights hold ONE
orthogonal draw per unique kernel shape, replicated across every conv of
that shape and across the groups of every grouped conv (each group is its
own square Conv2D, conv_cINN_base_functions.py:399-411): a grouped kernel is
``cardinality`` copies of one square block, with singular values
0.1*sqrt(cardinality).

:func:`shared_shape_reinit` rewrites a port ``ConvCFlow``'s conv weights in
place into that distribution, deterministic in ``seed``: one draw per unique
flax kernel shape ``(k, k, cin, cout)`` (the torch weight ``(cout, cin, k,
k)`` maps one to one onto it), grouped branch kernels tiled along dim 0 from
the square ``(k, k, d, d)`` draw, the two halves of a fused A/b head given
the single-head draw. Biases, LayerNorm and ``tanh_scale`` are untouched.
The RNG is torch's, so the draw matches JAX's in structure, not in values;
:func:`check_shared_draw` tests that structure on any parameter mapping.
``train.create_train_state`` applies the rewrite when the config sets
``ref_compat_shared_init``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (
    ConvCouplingNet,
    DenseMaskedGroupConv,
    orthogonal,
)

_NETS = ("net_ab", "net_a", "net_b")


def _flax_shape(weight):
    cout, cin, k0, k1 = weight.shape
    return (k0, k1, cin, cout)


def _to_torch(hwio):
    return hwio.permute(3, 2, 0, 1)


class _ShapeMemo:
    """One orthogonal draw per flax shape, each from a generator of its own
    seeded by ``(seed, shape)`` — the analogue of the Keras instance's fixed
    seed: same shape, same draw, anywhere in the model."""

    def __init__(self, seed: int, scale: float):
        self.seed, self.scale, self.cache = seed, scale, {}

    def draw(self, shape):
        shape = tuple(int(s) for s in shape)
        if shape not in self.cache:
            digest = hashlib.sha256(f"shared-init/{self.seed}/{shape}".encode()).digest()
            g = torch.Generator().manual_seed(int.from_bytes(digest[:8], "little") >> 1)
            self.cache[shape] = orthogonal(shape, self.scale, g)
        return self.cache[shape]


def _refuse(what):
    raise ValueError(
        f"ref_compat_shared_init (shared_init) supports the standard ConvCouplingNet "
        f"lowering only; found {what} (disable the fused_dilated/dense_groups/"
        "pallas_subnet lowerings)")


def _unknown_leaves(blk):
    """The flax leaf names of ``blk`` that are neither a ``Conv_*`` nor a
    LayerNorm: what JAX's ``shared_shape_reinit`` refuses
    (init_compat.py:82-92). The block builds them only where the lowering
    really changes its modules: a fused dilated conv (more than one
    dilation), a dense-masked grouped branch (cardinality > 1)."""
    if blk.fused:
        return ["fused_dil_bias", "fused_dil_kernel"]
    return [f"DenseMaskedGroupConv_{i}" for i, conv in enumerate(blk.branches)
            if isinstance(conv, DenseMaskedGroupConv)]


def _rewrite_net(net, memo: _ShapeMemo) -> None:
    net.conv_in.weight.copy_(_to_torch(memo.draw(_flax_shape(net.conv_in.weight))))
    for blk in net.blocks:
        convs = [blk.conv_pre, *blk.branches, blk.conv_post]
        for idx, conv in enumerate(convs):
            k0, k1, cin, cout = _flax_shape(conv.weight)
            if idx in (0, len(convs) - 1) or cout % cin:
                # the 1x1 bottlenecks, and a cardinality-1 branch (a standard
                # full-input Conv2D in the reference): direct draws
                new = memo.draw((k0, k1, cin, cout))
            else:
                # the reference's per-group Conv2D is square (d -> d); every
                # group shares the one (k, k, d, d) draw
                new = memo.draw((k0, k1, cin, cin)).repeat(1, 1, 1, cout // cin)
            conv.weight.copy_(_to_torch(new))
    k0, k1, cin, cout = _flax_shape(net.head.weight)
    if net.n_heads == 2:
        # the reference's two separate same-shape heads get the same draw
        half = memo.draw((k0, k1, cin, cout // 2))
        new = torch.cat([half, half], dim=-1)
    else:
        new = memo.draw((k0, k1, cin, cout))
    net.head.weight.copy_(_to_torch(new))


@torch.no_grad()
def shared_shape_reinit(model, seed: int, scale: float = 0.1):
    """Rewrite ``model``'s (a port ``ConvCFlow``) conv kernels in place into
    the reference's shared-instance init distribution; returns ``model``.
    Raises ``ValueError`` (naming ``shared_init``) where JAX's does: for
    subnets other than the standard ``ConvCouplingNet`` (``pallas_subnet``)
    and for residual blocks that hold a fused dilated conv or dense-masked
    grouped branches (``fused_dilated``, ``dense_groups``). The check runs
    over every subnet before any weight is written."""
    memo = _ShapeMemo(seed, scale)
    nets = [getattr(layer, name) for layer in model.couplings for name in _NETS
            if getattr(layer, name, None) is not None]
    for net in nets:
        if type(net) is not ConvCouplingNet:
            _refuse(type(net).__name__)
        for blk in net.blocks:
            unknown = _unknown_leaves(blk)
            if unknown:
                _refuse(f"{unknown} in a residual block")
    for net in nets:
        _rewrite_net(net, memo)
    return model


def check_shared_draw(params, scale: float = 0.1) -> dict:
    """Raise ``ValueError`` unless ``params`` (port parameter name ->
    tensor, e.g. ``model.state_dict()``) hold a shared-shape draw:

    - every directly drawn kernel is an orthogonal(``scale``) matrix over
      ``(prod(shape[:-1]), shape[-1])``, and all kernels of one flax shape
      are the same draw;
    - every grouped branch kernel is ``card`` copies of one square block,
      that shape's draw, with singular values ``scale*sqrt(card)`` (and the
      rest 0);
    - the two halves of every fused A/b head are equal, the half shape's draw;
    - biases are 0, LayerNorm scales 1, ``tanh_scale`` 1 (untouched inits);
    - fewer unique draws than kernels (the sharing is exercised).

    Returns counts of what was checked."""
    draws, problems = {}, []
    counts = dict(kernels=0, grouped=0, fused_heads=0, biases_and_norms=0)

    def expect(ok, what):
        if not ok:
            problems.append(what)

    def one_draw(shape, value, name):
        if shape in draws:
            expect(np.array_equal(draws[shape], value), f"{name}: not the one {shape} draw")
            return
        draws[shape] = value
        sv = np.linalg.svd(value.reshape(-1, shape[-1]), compute_uv=False)
        expect(np.allclose(sv, scale, atol=1e-5), f"{name}: not orthogonal({scale})")

    for name, t in params.items():
        arr = t.detach().cpu().double().numpy()
        if name.endswith(".weight") and arr.ndim == 4:
            counts["kernels"] += 1
            hwio = arr.transpose(2, 3, 1, 0)
            k0, k1, cin, cout = hwio.shape
            if ".branches." in name and cout % cin == 0:
                card = cout // cin
                counts["grouped"] += card > 1
                blocks = [hwio[..., g * cin:(g + 1) * cin] for g in range(card)]
                expect(all(np.array_equal(b, blocks[0]) for b in blocks),
                       f"{name}: groups are not copies of one block")
                sv = np.linalg.svd(hwio.reshape(-1, cout), compute_uv=False)
                expect(np.allclose(sv[:cin], scale * np.sqrt(card), atol=1e-5)
                       and np.allclose(sv[cin:], 0.0, atol=1e-6),
                       f"{name}: singular values are not {scale}*sqrt({card}) and 0")
                one_draw((k0, k1, cin, cin), blocks[0], name)
            elif ".net_ab.head." in name:
                counts["fused_heads"] += 1
                half = cout // 2
                expect(np.array_equal(hwio[..., :half], hwio[..., half:]),
                       f"{name}: fused head halves differ")
                one_draw((k0, k1, cin, half), hwio[..., :half], name)
            else:
                one_draw((k0, k1, cin, cout), hwio, name)
        else:
            counts["biases_and_norms"] += 1
            is_scale = name.endswith("tanh_scale") or (
                (".norms." in name or ".norm." in name) and name.endswith(".weight"))
            expect(np.all(arr == (1.0 if is_scale else 0.0)), f"{name}: not its init value")
    counts["unique_draws"] = len(draws)
    expect(len(draws) < counts["kernels"], "no two kernels share a draw")
    if problems:
        raise ValueError("not a shared-shape draw: " + "; ".join(problems[:10]))
    return counts
