"""Conv coupling masks 0-3 as strided slices, ``stack`` and ``reshape``,
and the toy's 6-mask system of feature index sets.

Port of ``arl_conditional_normalizing_flows_tpu/ops/masks.py``. No scatter
anywhere: conv compress is a strided slice, combine interleaves the two
compressed halves back; the toy's gather and combine are index selections
with index tensors on the data's device.

Mask semantics (conv_cINN_make_model.py:370-389):

- mask 0: spatial checkerboard, live at (even,even) and (odd,odd);
- mask 1: spatial checkerboard, live at (even,odd) and (odd,even);
- mask 2: channel mask, live channels ``0::2`` (ceil for odd depth);
- mask 3: channel mask, live channels ``1::2`` (floor).

Compressed layouts (conv_cINN_make_model.py:723-759): checkerboard grids are
concatenated channel-wise into ``(B, H/2, W/2, 2D)``, row-parity-0 grid
first; channel masks are the strided channel slice.
"""

from __future__ import annotations

import numpy as np
import torch

CHECKERBOARD_MASKS = (0, 1)
CHANNEL_MASKS = (2, 3)

#: complement mask giving u2 for a u1 mask (conv_cINN_make_model.py:432-440)
COMPLEMENT = {0: 1, 1: 0, 2: 3, 3: 2}


def compressed_shape(shape_hwd, which_mask):
    """Shape of the masked+compressed tensor (conv_cINN_make_model.py:474-498)."""
    h, w, d = shape_hwd
    if which_mask in CHECKERBOARD_MASKS:
        assert h % 2 == 0 and w % 2 == 0, "checkerboard needs even H, W"
        return (h // 2, w // 2, 2 * d)
    elif which_mask == 2:
        return (h, w, -(-d // 2))  # ceil
    elif which_mask == 3:
        return (h, w, d // 2)  # floor
    raise ValueError(f"bad mask index {which_mask}")


def compress(uv, which_mask):
    """Live elements of ``uv`` (..., H, W, D) under ``which_mask``."""
    if which_mask == 0:
        return torch.cat([uv[..., 0::2, 0::2, :], uv[..., 1::2, 1::2, :]], dim=-1)
    elif which_mask == 1:
        return torch.cat([uv[..., 0::2, 1::2, :], uv[..., 1::2, 0::2, :]], dim=-1)
    elif which_mask == 2:
        return uv[..., 0::2]
    elif which_mask == 3:
        return uv[..., 1::2]
    raise ValueError(f"bad mask index {which_mask}")


def combine(u1_compressed, u2_compressed, which_mask):
    """Rebuild the full tensor from ``u1`` (live under ``which_mask``) and
    ``u2`` (live under ``COMPLEMENT[which_mask]``) by interleaving."""
    if which_mask in CHECKERBOARD_MASKS:
        d2 = u1_compressed.shape[-1]
        assert d2 % 2 == 0
        d = d2 // 2
        a0, a1 = u1_compressed[..., :d], u1_compressed[..., d:]
        b0, b1 = u2_compressed[..., :d], u2_compressed[..., d:]
        if which_mask == 0:
            # a0 at (0,0), a1 at (1,1); b0 at (0,1), b1 at (1,0)
            q00, q01, q10, q11 = a0, b0, b1, a1
        else:
            # mask 1: a0 at (0,1), a1 at (1,0); b0 at (0,0), b1 at (1,1)
            q00, q01, q10, q11 = b0, a0, a1, b1
        return _interleave_quadrants(q00, q01, q10, q11)
    elif which_mask in CHANNEL_MASKS:
        if which_mask == 2:
            even, odd = u1_compressed, u2_compressed
        else:
            even, odd = u2_compressed, u1_compressed
        return interleave_channels(even, odd)
    raise ValueError(f"bad mask index {which_mask}")


def _interleave_quadrants(q00, q01, q10, q11):
    """(..., H, W, D) from the four (..., H/2, W/2, D) parity grids; q_ab
    sits at rows ``a::2`` and cols ``b::2``."""
    *lead, hh, hw, d = q00.shape
    row0 = torch.stack([q00, q01], dim=-2).reshape(*lead, hh, 2 * hw, d)
    row1 = torch.stack([q10, q11], dim=-2).reshape(*lead, hh, 2 * hw, d)
    return torch.stack([row0, row1], dim=-3).reshape(*lead, 2 * hh, 2 * hw, d)


def interleave_channels(even, odd):
    """result[..., 0::2] = even, result[..., 1::2] = odd; ``even`` may hold
    one channel more (conv_cINN_make_model.py:1049-1060)."""
    de, do = even.shape[-1], odd.shape[-1]
    *lead, h, w, _ = even.shape
    if de == do:
        return torch.stack([even, odd], dim=-1).reshape(*lead, h, w, de + do)
    assert de == do + 1, (de, do)
    body = torch.stack([even[..., :do], odd], dim=-1).reshape(*lead, h, w, 2 * do)
    return torch.cat([body, even[..., do:]], dim=-1)


# ---------------------------------------------------------------------------
# Toy (dense) 6-mask system — TOYcINN_make_model.py:154-217
# ---------------------------------------------------------------------------

#: u1 index sets for the 6 partitions of {0,1,2} (TOYcINN_make_model.py:156-161)
TOY_MASK_U1 = {
    0: (0,),
    1: (1,),
    2: (2,),
    3: (0, 1),
    4: (0, 2),
    5: (1, 2),
}
#: complementary u2 index sets (TOYcINN_make_model.py:163-166)
TOY_MASK_U2 = {
    0: (1, 2),
    1: (0, 2),
    2: (0, 1),
    3: (2,),
    4: (1,),
    5: (0,),
}


def toy_partition(io_shape, mask_id):
    """(u1_indices, u2_indices) numpy arrays for a toy mask id: the 3-D
    table for io_shape == 3, else an alternating split keyed by mask_id
    parity (the reference supports only io_shape == 3,
    TOYcINN_make_model.py:152)."""
    if io_shape == 3:
        m = mask_id % 6
        return np.array(TOY_MASK_U1[m]), np.array(TOY_MASK_U2[m])
    idx = np.arange(io_shape)
    u1 = idx[(idx + mask_id) % 2 == 0]
    u2 = idx[(idx + mask_id) % 2 == 1]
    return u1, u2


def toy_combine_order(u1_indices, u2_indices):
    """The permutation that puts ``cat([u1, u2])`` back in feature order."""
    return np.argsort(np.concatenate([np.asarray(u1_indices), np.asarray(u2_indices)]))


def _index(indices, device):
    if torch.is_tensor(indices):
        return indices.to(device)
    return torch.as_tensor(np.asarray(indices), dtype=torch.long, device=device)


def toy_gather(u, indices):
    """u1 = M1 @ u as a column gather (TOYcINN_make_model.py:320-323).
    ``indices``: a numpy array, a sequence or a long tensor; a tensor already
    on ``u``'s device costs no host-to-device copy (a CUDA graph cannot
    capture one)."""
    return torch.index_select(u, -1, _index(indices, u.device))


def toy_scatter_combine(u1, u2, u1_indices, u2_indices, io_shape, order=None):
    """u = M1^T u1 + M2^T u2 as a static permutation of a concat
    (TOYcINN_make_model.py:369-397 without the matvecs). ``order``: the
    :func:`toy_combine_order` of the indices, as a long tensor on the data's
    device, to spare its copy."""
    if order is None:
        order = toy_combine_order(u1_indices, u2_indices)
    assert u1.shape[-1] + u2.shape[-1] == io_shape, (u1.shape, u2.shape, io_shape)
    return torch.index_select(torch.cat([u1, u2], dim=-1), -1, _index(order, u1.device))
