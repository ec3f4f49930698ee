"""Weights of the default lowering carried into the ``dense_groups`` and
``fused_dilated`` lowerings of the same config, so that the three compute
one function (JAX tests/test_models.py:290-398 do this transplant by hand).

Under ``dense_groups`` every parameter keeps its name and shape. Under
``fused_dilated`` a block's branch kernels are written into the live taps of
its ``fused_dil_kernel`` (the entries ``dilated_branch_mask`` keeps; the rest
are zeroed) and their biases concatenated into ``fused_dil_bias``.
"""

from __future__ import annotations

import torch


def _fused_from_branches(blk, prefix, state):
    """(fused_dil_kernel, fused_dil_bias) of ``blk`` holding the branch
    parameters ``state[prefix + "branches.i.*"]`` (grouped branches: the
    config's cardinality is even)."""
    kernel = torch.zeros_like(blk.fused_dil_kernel)
    big = kernel.shape[-1]
    biases, off = [], 0
    for i, (d, w) in enumerate(zip(blk.dilations, blk.widths)):
        bk = state[f"{prefix}branches.{i}.weight"]  # (w, w/card, k, k)
        biases.append(state[f"{prefix}branches.{i}.bias"])
        taps = [(big - 1) // 2 + (t - (blk.ksize - 1) // 2) * d for t in range(blk.ksize)]
        card = blk.cardinality
        gsz = w // card
        for g in range(card):
            outs = slice(off + g * gsz, off + (g + 1) * gsz)
            ins = slice(g * gsz, (g + 1) * gsz)
            for a, ty in enumerate(taps):
                for b, tx in enumerate(taps):
                    kernel[outs, ins, ty, tx] = bk[g * gsz:(g + 1) * gsz, :, a, b]
        off += w
    return kernel, torch.cat(biases)


def state_dict_from_default_lowering(model, default_state: dict) -> dict:
    """The state_dict for ``model`` (a port ``ConvCFlow`` under any
    lowering of the config of ``default_state``'s model, e.g.
    ``fused_dilated`` or ``dense_groups``) computing what the default
    lowering's ``default_state`` computes."""
    out = {}
    target = model.state_dict()
    for name, module in model.named_modules():
        if getattr(module, "fused", False):
            prefix = name + "."
            kernel, bias = _fused_from_branches(module, prefix, default_state)
            out[prefix + "fused_dil_kernel"], out[prefix + "fused_dil_bias"] = kernel, bias
    for key in target:
        if key not in out:
            out[key] = default_state[key]
    return out
