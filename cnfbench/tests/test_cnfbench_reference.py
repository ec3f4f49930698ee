"""The plain reference against the program's CPU path at a small size, in
float32: the loss, every gradient, one Adam step, and the seeded serving
call (latent, inverse, de-logit, uint8)."""

import pytest
import torch

from cnfbench import checks, program, weights
from cnfbench.reference import flow as reference
from cnfbench.tests.small import small_cell

SEED = 2**40 + 17


def model_and_weights(cell):
    model = program.build_model(cell, "cpu")
    made = program.load_weights(model, weights.streams(SEED)[0], "cpu")
    return model, made


def batch(cell, rows=8):
    return weights.train_stacks(weights.streams(SEED)[1], 1, 1, rows, cell.model["io_shape"],
                                cell.model["x_d"], 10, "cpu")[0, 0]


@pytest.mark.parametrize("lowering", [None, "pallas_subnet"])
def test_loss_and_gradients_match_the_program(lowering):
    cell = small_cell("train", "float32", lowering=lowering)
    model, made = model_and_weights(cell)
    xy = batch(cell)
    loss = model.log_loss(xy)["loss"]
    grads = dict(zip([k for k, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    plan = reference.plan_of(cell.model)
    leaves = {k: v.clone().requires_grad_(True) for k, v in made.items()}
    ref = reference.loss(plan, leaves, xy)
    ref_grads = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(ref.detach()), rel=1e-6)
    assert set(grads) == set(ref_grads)
    assert checks.leaf_gap(grads, ref_grads, sorted(grads)) < 1e-4


def test_adam_steps_match_the_program():
    from arl_conditional_normalizing_flows_tpu_torch.train.loop import (
        create_train_state,
        make_step_fns,
    )

    cell = small_cell("train", "float32")
    model, made = model_and_weights(cell)
    state = create_train_state(model, 3e-4)
    step, _ = make_step_fns(model, noise_mode="none")
    xys = [batch(cell), batch(cell).flip(0)]
    losses = [float(step(state, xy)[1]["loss"]) for xy in xys]
    ref_losses, _, ref_after = reference.train_steps(reference.plan_of(cell.model), made,
                                                     xys, 3e-4)
    assert losses == pytest.approx(ref_losses, rel=1e-6)
    after = dict(model.named_parameters())
    change = {k: after[k].detach() - made[k] for k in made}
    ref_change = {k: ref_after[k] - made[k] for k in made}
    assert checks.leaf_gap(change, ref_change, sorted(made)) < 1e-3


@pytest.mark.parametrize("lowering", [None, "pallas_subnet"])
def test_the_seeded_call_matches_the_program(lowering):
    from arl_conditional_normalizing_flows_tpu_torch.serve.export import (
        export_seeded_multidraw_sampler,
        make_image_serving_fn,
    )

    cell = small_cell("serve", "float32", lowering=lowering)
    model, made = model_and_weights(cell)
    fn = make_image_serving_fn(model, 1, de_logit=True, quantize_uint8=True)
    art = export_seeded_multidraw_sampler(fn, 3, (8, 8, 1), (8, 8, 1))
    y = weights.condition_sets(5, 1, 4, (8, 8, 2), 10, "cpu")[0]
    got = art.call(SEED, y)
    want = reference.sample_pixels(reference.plan_of(cell.model), made, SEED, y, 3)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (3, 4, 8, 8, 1)
    numbers = checks.serve_numbers([got], [want])
    assert numbers["worst_sample_excess"] < 1e-3
    assert 0 < float(want.std())


def test_the_inverse_undoes_the_forward():
    cell = small_cell("train", "float32")
    _, made = model_and_weights(cell)
    plan = reference.plan_of(cell.model)
    xy = batch(cell)
    zy, _ = reference.forward(plan, made, xy)
    assert torch.allclose(reference.inverse(plan, made, zy), xy, atol=1e-4)
