"""The affine coupling law and its per-sample log-det as Hopper kernels.

Replaces the Pallas TPU kernels of the JAX package's
``ops/pallas/affine_coupling.py``:

- :func:`fused_affine_forward` — ``_fwd_kernel`` via ``_fwd_pallas_2d``
  (reached by ``fused_affine_forward``): ``v2 = exp(a)*u2 + b`` and
  ``ld = sum(a)`` per sample, accumulated in float32;
- :func:`fused_affine_inverse` — ``_inv_kernel`` in ``fused_affine_inverse``:
  ``u2 = exp(-a)*(v2 - b)``.

The CUDA source is ``csrc/affine_coupling.cu``, built by ``build.py``.

Bound on an H100 (3.35 TB/s): both are bound by device memory. The forward
reads a, b, u2 and writes v2 (plus 4 bytes of log-det a row); the inverse
reads three tensors and writes one. At the flagship's (128, 784) float32 that
is 1.61 MB each, 0.48 us; at (128, 392), 0.24 us — under a launch's floor, so
a coupling law costs one launch and one memory round trip for each element.
The design (the note in the source): no padded copies, the log-det summed in
the same pass instead of a second read of ``a``, 16-byte accesses with every
load of a thread issued before its arithmetic, one block a row for the
forward and a one-wave grid for the inverse. A misaligned view or a row that
is not a whole number of 16-byte vectors takes the kernels' scalar path.

Dispatch: a CPU tensor goes to the plain version beside the kernel; a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
:data:`LAUNCHES`.

Gradients: :func:`fused_affine_forward` is a ``torch.autograd.Function``
whose backward is :func:`affine_forward_vjp`, the JAX custom VJP
``_forward_bwd`` in PyTorch ops (JAX computes it with XLA, outside any
Pallas kernel). CPU and CUDA tensors take the same backward; the forward
launches the kernel on the card whether or not a gradient will flow. The JAX
``fused_affine_inverse`` defines no gradient, so a CUDA call of
:func:`fused_affine_inverse` that would need one raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"affine_forward": 0, "affine_inverse": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def affine_forward_reference(a, b, u2):
    """Plain ``(v2, ld)``: the law in float32 rounded once to the inputs'
    dtype, the log-det (B,) in float32."""
    shape, B = a.shape, a.shape[0]
    a2 = a.reshape(B, -1).float()
    v2 = torch.exp(a2) * u2.reshape(B, -1).float() + b.reshape(B, -1).float()
    return v2.to(u2.dtype).reshape(shape), a2.sum(dim=1)


def affine_inverse_reference(a, b, v2):
    """Plain ``u2 = exp(-a)*(v2 - b)`` in float32, rounded to v2's dtype."""
    u2 = torch.exp(-a.float()) * (v2.float() - b.float())
    return u2.to(v2.dtype)


def affine_forward_vjp(a, u2, g_v2, g_ld):
    """``(da, db, du2)`` of ``(v2, ld)`` = :func:`fused_affine_forward` for
    the cotangents ``g_v2`` of v2 and ``g_ld`` (B,) of the log-det: the JAX
    ``_forward_bwd`` (``ops/pallas/affine_coupling.py:148-159``) in a's
    dtype — ``g_ld`` broadcast over the non-batch axes, ``exp(a)``
    recomputed instead of saved. ``da = g_v2*exp(a)*u2 + g_ld``,
    ``db = g_v2``, ``du2 = g_v2*exp(a)``."""
    g_ld = g_ld.reshape((a.shape[0],) + (1,) * (a.dim() - 1)).to(a.dtype)
    g_ea = g_v2 * torch.exp(a)
    return g_ea * u2 + g_ld, g_v2, g_ea


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@functools.cache
def _library():
    lib = build.load_libraries("affine_coupling")["affine_coupling"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.affine_forward.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.affine_forward.restype = i
    lib.affine_inverse.argtypes = [p, p, p, p, i, i, i, p]
    lib.affine_inverse.restype = i
    return lib


def _is_cpu(*ts) -> bool:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"coupling inputs lie on different devices: {devices}")
    return next(iter(devices)).type == "cpu"


def _check_cuda(name, *ts):
    """(rows, n, dtype code) for kernel inputs, or raise on what the kernel
    does not take. Alignment is not asked for: the C entries send a
    misaligned pointer to the scalar path."""
    a = ts[0]
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {a.device}")
    if any(t.shape != a.shape for t in ts) or a.dim() < 2:
        raise ValueError(f"{name}: need equal shapes of rank >= 2, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if any(t.dtype != a.dtype for t in ts) or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: need one dtype of float32/bfloat16, got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    rows, n = a.shape[0], a.numel() // max(a.shape[0], 1)
    if rows == 0 or n == 0 or rows > _INT_MAX or n > _INT_MAX:
        raise ValueError(f"{name}: unsupported size {tuple(a.shape)}")
    return rows, n, _DTYPE_CODE[a.dtype]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


class _AffineForward(torch.autograd.Function):
    """K1 with the JAX custom VJP's residuals ``(a, u2)`` and backward."""

    @staticmethod
    def forward(ctx, a, b, u2):
        ctx.save_for_backward(a, u2)
        return _affine_forward(a, b, u2)

    @staticmethod
    def backward(ctx, g_v2, g_ld):
        a, u2 = ctx.saved_tensors
        return affine_forward_vjp(a, u2, g_v2, g_ld)


def fused_affine_forward(a, b, u2):
    """``v2 = exp(a)*u2 + b`` and the per-sample log-det ``sum(a)`` (B,)
    float32. a, b, u2: one shape ``(B, ...)``, one dtype. Differentiable
    (:func:`affine_forward_vjp`)."""
    return _AffineForward.apply(a, b, u2)


def _affine_forward(a, b, u2):
    if _is_cpu(a, b, u2):
        return affine_forward_reference(a, b, u2)
    rows, n, code = _check_cuda("affine_forward", a, b, u2)
    v2 = torch.empty_like(u2)
    ld = torch.empty(rows, dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.affine_forward(a.data_ptr(), b.data_ptr(), u2.data_ptr(),
                                 v2.data_ptr(), ld.data_ptr(), rows, n, code, stream)
    _raise_on(err, "affine_forward")
    LAUNCHES["affine_forward"] += 1
    return v2, ld


def fused_affine_inverse(a, b, v2):
    """``u2 = exp(-a)*(v2 - b)``; a, b, v2: one shape, one dtype. No
    gradient on the card, as the JAX function has none."""
    if _is_cpu(a, b, v2):
        return affine_inverse_reference(a, b, v2)
    rows, n, code = _check_cuda("affine_inverse", a, b, v2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, v2)):
        raise NotImplementedError(
            "affine_inverse: the JAX fused_affine_inverse defines no gradient (its "
            "Pallas call has no VJP), and neither does this kernel; call it under "
            "torch.no_grad()")
    u2 = torch.empty_like(v2)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.affine_inverse(a.data_ptr(), b.data_ptr(), v2.data_ptr(),
                                 u2.data_ptr(), rows, n, code, stream)
    _raise_on(err, "affine_inverse")
    LAUNCHES["affine_inverse"] += 1
    return u2
