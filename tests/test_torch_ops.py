"""The port's masks, squeeze/factor, coupling law and logit against the JAX
functions, and the coupling kernels' plain versions against the JAX Pallas
kernels run in interpret mode. Inputs come from numpy with a seed."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.ops import coupling as jcoupling  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import logit as jlogit  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import masks as jmasks  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import squeeze as jsqueeze  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops.pallas import affine_coupling as jac  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import coupling as tcoupling  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import logit as tlogit  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import masks as tmasks  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import squeeze as tsqueeze  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    affine_coupling as tac,
)


@pytest.fixture
def interpret():
    old = jac.INTERPRET
    jac.INTERPRET = True
    yield
    jac.INTERPRET = old


def _pair(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x, torch.from_numpy(x)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# masks and squeeze: pure data movement, bit-exact
# ---------------------------------------------------------------------------


# channel masks need depth >= 2 (mask 3 of one channel is empty)
@pytest.mark.parametrize(
    "m,depth", [(m, d) for m in range(4) for d in range(1 if m < 2 else 2, 6)])
def test_masks_bit_exact(rng, m, depth):
    x, xt = _pair(rng, (3, 6, 4, depth))
    shape = (6, 4, depth)
    assert tmasks.compressed_shape(shape, m) == jmasks.compressed_shape(shape, m)
    mc = tmasks.COMPLEMENT[m]
    assert mc == jmasks.COMPLEMENT[m]
    u1t, u2t = tmasks.compress(xt, m), tmasks.compress(xt, mc)
    u1j, u2j = jmasks.compress(jnp.asarray(x), m), jmasks.compress(jnp.asarray(x), mc)
    _eq(u1t, u1j)
    _eq(u2t, u2j)
    assert tuple(u1t.shape[1:]) == tmasks.compressed_shape(shape, m)
    full = tmasks.combine(u1t, u2t, m)
    _eq(full, jmasks.combine(u1j, u2j, m))
    _eq(full, x)
    # the complementary-pair identities the pair fusion relies on
    # (JAX models/conv.py:235-263)
    _, v2t = _pair(rng, u2t.shape)
    mixed = tmasks.combine(u1t, v2t, m)
    _eq(tmasks.compress(mixed, mc), v2t.numpy())
    _eq(tmasks.compress(mixed, m), u1t.numpy())


@pytest.mark.parametrize("shape", [(2, 4, 6, 1), (3, 8, 8, 3), (1, 2, 2, 4)])
def test_squeeze_bit_exact(rng, shape):
    x, xt = _pair(rng, shape)
    st = tsqueeze.squeeze(xt)
    _eq(st, jsqueeze.squeeze(jnp.asarray(x)))
    _eq(tsqueeze.unsqueeze(st), x)
    _eq(tsqueeze.unsqueeze(st), jsqueeze.unsqueeze(jnp.asarray(st.numpy())))


@pytest.mark.parametrize("num_prev_factors", [0, 1, 2])
def test_factor_ops_bit_exact(rng, num_prev_factors):
    u, ut = _pair(rng, (2, 4, 4, 6))
    z, zt = _pair(rng, (2, 4, 4, 3))
    for zy, zyt in ((None, None), (jnp.asarray(z), zt)):
        vt, acct = tsqueeze.factor_out(ut, zyt)
        vj, accj = jsqueeze.factor_out(jnp.asarray(u), zy)
        _eq(vt, vj)
        _eq(acct, accj)
        rt, restt = tsqueeze.factor_in(vt, acct, num_prev_factors)
        rj, restj = jsqueeze.factor_in(vj, accj, num_prev_factors)
        _eq(rt, rj)
        _eq(restt, restj)
    # the final all-zy layer: v is None, split = depth // 2**npf
    acc, acct = _pair(rng, (2, 4, 4, 8))
    rt, restt = tsqueeze.factor_in(None, acct, num_prev_factors)
    rj, restj = jsqueeze.factor_in(None, jnp.asarray(acc), num_prev_factors)
    _eq(rt, rj)
    _eq(restt, restj)


# ---------------------------------------------------------------------------
# coupling law
# ---------------------------------------------------------------------------


def _law_inputs(rng, shape):
    a = np.tanh(rng.normal(size=shape)).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    u = rng.normal(size=shape).astype(np.float32)
    return a, b, u


@pytest.mark.parametrize("shape", [(8, 4, 4, 2), (3, 5, 7, 3)])
def test_plain_law_matches_jax(rng, shape):
    a, b, u = _law_inputs(rng, shape)
    t = [torch.from_numpy(v) for v in (a, b, u)]
    v2t, ldt = tcoupling.affine_forward(*t)
    v2j, ldj = jcoupling.affine_forward(*map(jnp.asarray, (a, b, u)))
    np.testing.assert_allclose(v2t.numpy(), np.asarray(v2j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-6, atol=1e-6)
    ut = tcoupling.affine_inverse(t[0], t[1], v2t)
    uj = jcoupling.affine_inverse(jnp.asarray(a), jnp.asarray(b), v2j)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6, atol=1e-6)


def test_plain_law_logdet_is_float32_and_promotes(rng):
    """bf16 heads with a float32 flow run the law in float32; the log-det
    is float32 whatever the input dtype."""
    a, b, u = _law_inputs(rng, (2, 4, 4, 2))
    ab = torch.from_numpy(a).to(torch.bfloat16)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    v2, ld = tcoupling.affine_forward(ab, bb, torch.from_numpy(u))
    assert v2.dtype == torch.float32 and ld.dtype == torch.float32
    v2j, ldj = jcoupling.affine_forward(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), jnp.asarray(u))
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel module: the plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 4, 4, 2), (3, 5, 7, 3), (16, 14, 14, 2), (4, 1280)])
def test_kernel_plain_versions_match_pallas_interpret(rng, interpret, shape):
    a, b, u = _law_inputs(rng, shape)
    t = [torch.from_numpy(v) for v in (a, b, u)]
    v2t, ldt = tac.affine_forward_reference(*t)
    v2j, ldj = jac.fused_affine_forward(*map(jnp.asarray, (a, b, u)))
    assert ldt.dtype == torch.float32 and ldt.shape == (shape[0],)
    np.testing.assert_allclose(v2t.numpy(), np.asarray(v2j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-5, atol=1e-5)
    ut = tac.affine_inverse_reference(t[0], t[1], v2t)
    uj = jac.fused_affine_inverse(jnp.asarray(a), jnp.asarray(b), v2j)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ut.numpy(), u, rtol=1e-5, atol=1e-5)


def test_kernel_plain_version_bf16_logdet_f32(rng, interpret):
    """bf16 a/b/u2 give bf16 v2 and a float32 log-det, as the TPU kernel.
    The port rounds the float32 law once; the Pallas kernel rounds after
    each bf16 op, so v2 agrees to a few bf16 ulps (2**-8 relative)."""
    a, b, u = _law_inputs(rng, (4, 256))
    tb = [torch.from_numpy(v).to(torch.bfloat16) for v in (a, b, u)]
    v2t, ldt = tac.affine_forward_reference(*tb)
    assert v2t.dtype == torch.bfloat16 and ldt.dtype == torch.float32
    jb = [jnp.asarray(v, jnp.bfloat16) for v in (a, b, u)]
    v2j, ldj = jac.fused_affine_forward(*jb)
    assert ldj.dtype == jnp.float32
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v2t.float().numpy(), np.asarray(v2j, np.float32),
                               rtol=2e-2, atol=2e-2)
    ut = tac.affine_inverse_reference(tb[0], tb[1], v2t)
    assert ut.dtype == torch.bfloat16


def test_wrappers_take_the_plain_version_on_cpu(rng):
    a, b, u = (torch.from_numpy(v) for v in _law_inputs(rng, (3, 5, 7, 3)))
    before = dict(tac.LAUNCHES)
    v2, ld = tac.fused_affine_forward(a, b, u)
    v2r, ldr = tac.affine_forward_reference(a, b, u)
    assert torch.equal(v2, v2r) and torch.equal(ld, ldr)
    assert torch.equal(tac.fused_affine_inverse(a, b, v2), tac.affine_inverse_reference(a, b, v2))
    assert tac.LAUNCHES == before  # no kernel ran


def test_wrappers_reject_mixed_devices(rng):
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        tac.fused_affine_forward(a, a, a.to("meta"))


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    """A failed nvcc build raises with the compiler's stderr, and leaves no
    library behind (a stand-in compiler fails here: there is no nvcc)."""
    from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: stand-in compiler refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="stand-in compiler refused"):
        build.load_libraries("affine_coupling")
    assert list((tmp_path / "_build").iterdir()) == []
    assert "affine_coupling" not in build._loaded


def test_build_is_keyed_by_source_and_flags(monkeypatch):
    from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build

    path = build.library_path("affine_coupling")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libaffine_coupling-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("affine_coupling") != path


# ---------------------------------------------------------------------------
# logit
# ---------------------------------------------------------------------------


def test_logit_matches_jax(rng):
    x = rng.uniform(size=(4, 6, 6, 1)).astype(np.float32)
    lt = tlogit.logitify(torch.from_numpy(x))
    lj = jlogit.logitify(jnp.asarray(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6, atol=1e-6)
    back = tlogit.de_logitify(lt)
    np.testing.assert_allclose(back.numpy(), np.asarray(jlogit.de_logitify(lj)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
