"""The coupling kernels against their plain versions on a CUDA card.

Needs a card and imports no JAX, so it runs on a machine with a card and
without jax, skipping the repo's conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test here skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    affine_coupling as tac,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, dtype, device):
    rng = np.random.default_rng(0)
    a = np.tanh(rng.normal(size=shape))
    b, u = rng.normal(size=shape), rng.normal(size=shape)
    return [torch.from_numpy(v.astype(np.float32)).to(device, dtype) for v in (a, b, u)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 784), (128, 392), (3, 1000), (3, 5, 7, 3)])
def test_kernels_match_plain_versions(cuda, shape, dtype):
    a, b, u = _inputs(shape, getattr(torch, dtype), cuda)
    before = dict(tac.LAUNCHES)
    with torch.no_grad():
        v2, ld = tac.fused_affine_forward(a, b, u)
        v2r, ldr = tac.affine_forward_reference(a, b, u)
        u2 = tac.fused_affine_inverse(a, b, v2)
        u2r = tac.affine_inverse_reference(a, b, v2)
    torch.cuda.synchronize()
    assert tac.LAUNCHES["affine_forward"] == before["affine_forward"] + 1
    assert tac.LAUNCHES["affine_inverse"] == before["affine_inverse"] + 1
    assert v2.dtype == a.dtype and ld.dtype == torch.float32 and ld.shape == (shape[0],)
    # float32: expf against torch.exp, a few ulps; bf16: the same float32
    # value rounded once, at most one bf16 ulp apart
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(v2, v2r, rtol=tol, atol=tol)
    torch.testing.assert_close(ld, ldr, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(u2, u2r, rtol=tol, atol=tol)


def test_kernels_reject_what_they_do_not_take(cuda):
    a, b, u = _inputs((4, 6), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tac.fused_affine_forward(a.t(), b.t(), u.t())
    with pytest.raises(ValueError, match="dtype"):
        tac.fused_affine_forward(a.half(), b.half(), u.half())
    with pytest.raises(ValueError, match="dtype"):
        tac.fused_affine_inverse(a, b, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        tac.fused_affine_inverse(a, b, u[:2])
    with pytest.raises(NotImplementedError, match="backward"):
        tac.fused_affine_forward(a.requires_grad_(), b, u)
