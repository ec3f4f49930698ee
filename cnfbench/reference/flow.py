"""The plain reference of the conv cINN: forward, loss, Adam and the seeded
sampler, in plain PyTorch.

It follows the published model (ARL_Conditional_Normalizing_Flows,
conv_cINN_make_model.py:337-1904, conv_cINN_base_functions.py:174-627) and
imports nothing of the program under test: masks, squeeze and factor-out,
the coupling law, the dilated grouped-conv subnets, the fudged logit and
Adam are written out here again. It reads its weights by the parameter
names that the benchmark generates (``weights.py``), the shapes of which
carry the architecture: a branch of width ``w`` in a trunk of ``K`` has the
dilation ``K / w``, and its groups are ``w`` over the kernel's input
channels.

Everything runs at float32 with TF32 off (``exact()``). ``precision``
rounds the operands of every subnet convolution before the float32 product,
as the controls ask: ``"tf32"`` to TF32 (10 mantissa bits, round to
nearest), ``"fp8"`` to float8 e4m3 with one scale a tensor (its largest
magnitude to 448). The coupling law, the log-det and the loss stay float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.3
MASK_ORDER = (0, 1, 2, 3)
COMPLEMENT = {0: 1, 1: 0, 2: 3, 3: 2}
PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0


@contextlib.contextmanager
def exact():
    """float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class Plan:
    """The flow's static layout from the configuration's fields."""

    io_shape: Tuple[int, int, int]
    x_d: int
    squeeze_factor_blocks: Tuple[int, ...]
    fused_subnet: bool
    lambda_y: float = 100.0

    @property
    def couplings(self) -> int:
        return 4 * len(self.squeeze_factor_blocks)


def plan_of(cfg: dict) -> Plan:
    return Plan(io_shape=tuple(cfg["io_shape"]), x_d=int(cfg["x_d"]),
                squeeze_factor_blocks=tuple(cfg["squeeze_factor_blocks"]),
                fused_subnet=bool(cfg["fused_subnet"]),
                lambda_y=float(cfg.get("lambda_y", 100.0)))


def _round(t, precision):
    if precision == "float32":
        return t
    if precision == "tf32":
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")


def _lrelu(t):
    return torch.where(t > 0, t, LEAKY_SLOPE * t)


def _conv(x, w, b, dilation, groups, precision):
    """SAME, stride-1 conv of NCHW ``x`` with the OIHW kernel ``w``: total
    padding ``dilation * (k - 1)``, the smaller half before."""
    k = w.shape[-1]
    total = dilation * (k - 1)
    lo = total // 2
    x = F.pad(_round(x, precision), (lo, total - lo, lo, total - lo))
    y = F.conv2d(x, _round(w, precision), dilation=dilation, groups=groups)
    return y + b[:, None, None]


def subnet(params, prefix, u1, precision="float32"):
    """The head (B, h, w, out) of one coupling subnet for ``u1`` (B, h, w,
    cin): entry k x k conv, dilated grouped residual blocks, LeakyReLU, k x k
    head (conv_cINN_base_functions.py:330-627)."""
    def p(name):
        return params[f"{prefix}.{name}"]

    y = _conv(u1.permute(0, 3, 1, 2), p("conv_in.weight"), p("conv_in.bias"), 1, 1, precision)
    trunk = y.shape[1]
    r = 0
    while f"{prefix}.blocks.{r}.conv_pre.weight" in params:
        blk = f"blocks.{r}"
        t = _lrelu(_conv(_lrelu(y), p(f"{blk}.conv_pre.weight"), p(f"{blk}.conv_pre.bias"),
                         1, 1, precision))
        outs, j = [], 0
        while f"{prefix}.{blk}.branches.{j}.weight" in params:
            w = p(f"{blk}.branches.{j}.weight")
            width = w.shape[0]
            outs.append(_conv(t[:, :width], w, p(f"{blk}.branches.{j}.bias"),
                              trunk // width, width // w.shape[1], precision))
            j += 1
        y = y + _conv(_lrelu(torch.cat(outs, dim=1)), p(f"{blk}.conv_post.weight"),
                      p(f"{blk}.conv_post.bias"), 1, 1, precision)
        r += 1
    head = _conv(_lrelu(y), p("head.weight"), p("head.bias"), 1, 1, precision)
    return head.permute(0, 2, 3, 1)


def coupling_heads(plan, params, i, u1, precision):
    """(A, b) of coupling ``i``: A = tanh(head) * scale."""
    if plan.fused_subnet:
        head = subnet(params, f"couplings.{i}.net_ab", u1, precision)
        c = head.shape[-1] // 2
        scale = params[f"couplings.{i}.net_ab.tanh_scale"]
        return torch.tanh(head[..., :c]) * scale, head[..., c:]
    a = subnet(params, f"couplings.{i}.net_a", u1, precision)
    b = subnet(params, f"couplings.{i}.net_b", u1, precision)
    return torch.tanh(a) * params[f"couplings.{i}.net_a.tanh_scale"], b


# -- masks, squeeze, factor-out (conv_cINN_make_model.py:179-321, 370-759) --


def compress(u, m):
    if m == 0:
        return torch.cat([u[..., 0::2, 0::2, :], u[..., 1::2, 1::2, :]], dim=-1)
    if m == 1:
        return torch.cat([u[..., 0::2, 1::2, :], u[..., 1::2, 0::2, :]], dim=-1)
    return u[..., 0::2] if m == 2 else u[..., 1::2]


def combine(u1, u2, m, shape):
    """The full (B, H, W, D) tensor from the live half ``u1`` under mask
    ``m`` and the other half ``u2``."""
    out = u1.new_empty(shape)
    if m in (0, 1):
        d = shape[-1]
        live = ((0, 0), (1, 1)) if m == 0 else ((0, 1), (1, 0))
        dead = ((0, 1), (1, 0)) if m == 0 else ((0, 0), (1, 1))
        for k, (r, c) in enumerate(live):
            out[..., r::2, c::2, :] = u1[..., k * d:(k + 1) * d]
        for k, (r, c) in enumerate(dead):
            out[..., r::2, c::2, :] = u2[..., k * d:(k + 1) * d]
    else:
        even, odd = (u1, u2) if m == 2 else (u2, u1)
        out[..., 0::2] = even
        out[..., 1::2] = odd
    return out


def squeeze(u):
    """space_to_depth: channel (2 dy + dx) D + d of pixel (i, j) is pixel
    (2i + dy, 2j + dx), channel d."""
    return torch.cat([u[..., dy::2, dx::2, :] for dy in (0, 1) for dx in (0, 1)], dim=-1)


def unsqueeze(v):
    b, h, w, d4 = v.shape
    d = d4 // 4
    out = v.new_empty((b, 2 * h, 2 * w, d))
    for k, (dy, dx) in enumerate((dy, dx) for dy in (0, 1) for dx in (0, 1)):
        out[..., dy::2, dx::2, :] = v[..., k * d:(k + 1) * d]
    return out


def _ops(plan):
    """The flow's steps: ("couple", i, mask) | ("squeeze",) | ("factor", n)
    with n the factor-outs before this one."""
    ops, factors = [], 0
    for blk, sf in enumerate(plan.squeeze_factor_blocks):
        for j, m in enumerate(MASK_ORDER):
            ops.append(("couple", 4 * blk + j, m))
        if sf:
            ops += [("squeeze",), ("factor", factors)]
            factors += 1
    return ops


def _factor_in(v, zy, factors):
    split = zy.shape[-1] // 2 ** factors if v is None else v.shape[-1]
    back = zy[..., zy.shape[-1] - split:]
    return (back if v is None else torch.cat([back, v], dim=-1)), zy[..., :zy.shape[-1] - split]


def forward(plan, params, xy, precision="float32"):
    """xy (B, H, W, D) -> (zy in xy's layout, per-sample log|det J|)."""
    uv, zy = xy, None
    log_det = xy.new_zeros(xy.shape[0])
    ops = _ops(plan)
    for op in ops:
        if op[0] == "couple":
            _, i, m = op
            u1, u2 = compress(uv, m), compress(uv, COMPLEMENT[m])
            a, b = coupling_heads(plan, params, i, u1, precision)
            uv = combine(u1, torch.exp(a) * u2 + b, m, uv.shape)
            log_det = log_det + a.sum(dim=(1, 2, 3))
        elif op[0] == "squeeze":
            uv = squeeze(uv)
            zy = None if zy is None else squeeze(zy)
        else:
            half = uv.shape[-1] // 2
            zy = uv[..., :half] if zy is None else torch.cat([zy, uv[..., :half]], dim=-1)
            uv = uv[..., half:]
    if zy is None:
        return uv, log_det
    # back to xy's layout through the squeeze and factor steps alone
    zy, vu = torch.cat([zy, uv], dim=-1), None
    for op in reversed([op for op in ops if op[0] != "couple"]):
        if op[0] == "factor":
            vu, zy = _factor_in(vu, zy, op[1])
        else:
            vu = unsqueeze(vu)
            zy = zy if zy.shape[-1] == 0 else unsqueeze(zy)
    return vu, log_det


def inverse(plan, params, zy, precision="float32"):
    """zy (xy's layout) -> xy."""
    ops = _ops(plan)
    uv, acc = zy, None
    for op in ops:
        if op[0] == "squeeze":
            uv = squeeze(uv)
            acc = None if acc is None else squeeze(acc)
        elif op[0] == "factor":
            half = uv.shape[-1] // 2
            acc = uv[..., :half] if acc is None else torch.cat([acc, uv[..., :half]], dim=-1)
            uv = uv[..., half:]
    for op in reversed(ops):
        if op[0] == "couple":
            _, i, m = op
            v1, v2 = compress(uv, m), compress(uv, COMPLEMENT[m])
            a, b = coupling_heads(plan, params, i, v1, precision)
            uv = combine(v1, torch.exp(-a) * (v2 - b), m, uv.shape)
        elif op[0] == "squeeze":
            uv = unsqueeze(uv)
            acc = acc if acc is None or acc.shape[-1] == 0 else unsqueeze(acc)
        else:
            uv, acc = _factor_in(uv, acc, op[1])
    return uv


def loss(plan, params, xy, precision="float32"):
    """The joint NLL (conv_cINN_make_model.py:1800-1845): the mean over the
    batch of -(log N(z; 0, 1) summed over pixels - lambda_y |y - y'| summed
    + log|det J|)."""
    zy, log_det = forward(plan, params, xy, precision)
    z, y = zy[..., :plan.x_d], zy[..., plan.x_d:]
    ll_z = (-0.5 * z * z - 0.5 * math.log(2 * math.pi)).sum(dim=(1, 2, 3))
    ll_y = -plan.lambda_y * (y - xy[..., plan.x_d:]).abs().sum(dim=(1, 2, 3))
    return -(ll_z + ll_y + log_det).mean()


class Adam:
    """Adam as optax.adam and torch.optim.Adam define it (b1 0.9, b2 0.999,
    eps 1e-8, bias-corrected)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k].sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def train_steps(plan, params, batches, lr, precision="float32"):
    """Adam steps from ``params`` (left unchanged), one a batch: (the
    losses, the first step's gradients, the parameters after the last)."""
    params = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for xy in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with exact(), torch.enable_grad():
            value = loss(plan, leaves, xy, precision)
            grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
    return losses, first, params


def de_logit(x, a=0.01):
    """The inverse of the fudged logit (conv_cINN_base_functions.py:287-318)."""
    b = (1.0 - 2.0 * a) / (1.0 - a)
    lo = math.log(a / (1.0 - a))
    z = x * (-2.0 * lo) + lo
    return (torch.sigmoid(z) - a) / (b * (1.0 - a))


def latent(seed: int, shape, device):
    """N(0, 1) of ``shape`` from a generator on ``device`` seeded with
    ``seed``: the draw that the seeded serving entry defines."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g, device=device)


@torch.no_grad()
def sample_pixels(plan, params, seed, y, draws, precision="float32", block=512):
    """The seeded entry's pixels before quantisation: ``draws`` latents for
    each condition plane of ``y`` (B, H, W, y_d), inverted, x de-logited and
    clipped to [0, 255]. Returns (draws, B, H, W, x_d) float32, computed in
    blocks of ``block`` samples."""
    b, h, w, _ = y.shape
    z = latent(seed, (draws, b, h, w, plan.x_d), y.device).reshape(draws * b, h, w, plan.x_d)
    ys = y.unsqueeze(0).expand(draws, *y.shape).reshape(draws * b, *y.shape[1:])
    out: List[torch.Tensor] = []
    with exact():
        for s in range(0, draws * b, block):
            xy = inverse(plan, params, torch.cat([z[s:s + block], ys[s:s + block]], dim=-1),
                         precision)
            out.append(torch.clamp(de_logit(xy[..., :plan.x_d]), 0.0, 1.0) * 255.0)
    return torch.cat(out).reshape(draws, b, h, w, plan.x_d)
