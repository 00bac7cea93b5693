"""Backbone rematerialisation (nn/resnet.py ``remat``) and ``freeze_bn``
(models/deeplab.py) of the port against the JAX package, on a tiny
DeepLabV2 (layers 1,1,1,1) at 64x128 with dropout off.

Remat: one train step with ``remat`` 'none', 'dots' and 'full' (and 'full'
at grad_accum 2) against the JAX step built with the same ``remat``: the
loss rtol 1e-5, the gradients 5e-4 absolute and the running statistics
5e-4, the tolerances of tests/test_torch_train.py. The statistics are
folded once a step: every BatchNorm's ``num_batches_tracked`` counts one a
microbatch, and the running statistics equal those of the port's own
'none' step within 1e-6 (a second fold would move them by about 10%).

freeze_bn: three steps under Adam and SGD, with and without ``lr_groups``,
against the JAX ``FrozenBNModel``: every BatchNorm weight and bias ends
exactly where it started on both sides, the running statistics move, the
losses agree within rtol 1e-5 and every other parameter stays inside the
3 x lr envelope of JAX's (x10 for the head with ``lr_groups``) but for an
outlier count, as tests/test_torch_train.py holds the step.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_deeplab import HW, TINY, jax_deeplab_with_twin  # noqa: E402,E501
from tests.test_torch_train import (  # noqa: E402
    GRAD_ATOL, IGNORE, LOSS_RTOL, LR, STATS_ATOL, as_state_dict, jax_grads,
    make_batch, no_dropout)
from thermal_semantic_segmentation_tpu.models.deeplab import (  # noqa: E402
    FrozenBNModel, create_deeplab as jax_create_deeplab)
from thermal_semantic_segmentation_tpu.train import (  # noqa: E402
    seg as jax_seg)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    DeepLabV2, backbone_and_head_params, create_deeplab,
    freeze_batchnorm_affine)
from thermal_semantic_segmentation_torch.nn.resnet import (  # noqa: E402
    BatchNorm2d)
from thermal_semantic_segmentation_torch.train import seg  # noqa: E402

STEPS = 3
FOLD_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    model, variables, twin = jax_deeplab_with_twin(9)
    return variables, {k: v.clone() for k, v in twin.state_dict().items()}


def twin_of(state_dict, remat="none"):
    twin = DeepLabV2(num_channels=1, remat=remat, **TINY)
    twin.load_state_dict(state_dict, strict=True)
    twin = twin.to(memory_format=torch.channels_last)
    twin.layer5.head[0].p = 0.0
    return twin


def port_step(twin, image, label, grad_accum=1):
    state = seg.create_seg_state(twin, learning_rate=LR, device="cpu")
    step = seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, grad_accum=grad_accum,
                                   device="cpu")
    return float(step(state, torch.from_numpy(image),
                      torch.from_numpy(label)))


@pytest.mark.parametrize("remat,grad_accum", [
    ("none", 1), ("dots", 1), ("full", 1), ("full", 2)])
def test_remat_step_matches_jax_and_folds_once(tiny, remat, grad_accum):
    variables, state_dict = tiny
    image, label = make_batch(30)
    model, _ = jax_create_deeplab(jax.random.key(0), num_channels=1,
                                  image_size=HW, remat=remat, abstract=True,
                                  **TINY)
    jstate = jax_seg.create_seg_state(
        model, jax.tree.map(jnp.asarray, variables), learning_rate=LR)
    jstep = jax_seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                        base_lr=LR, grad_accum=grad_accum)
    with fnn.intercept_methods(no_dropout):
        jstate, want_loss = jstep(jstate, jnp.asarray(image),
                                  jnp.asarray(label))
    want_g = as_state_dict(
        jax_grads(model, variables, image, label, grad_accum),
        variables["batch_stats"])
    want_sd = as_state_dict(jax.device_get(jstate.params),
                            jax.device_get(jstate.batch_stats))

    twin = twin_of(state_dict, remat)
    loss = port_step(twin, image, label, grad_accum)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    for name, p in twin.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)

    plain = twin_of(state_dict)
    port_step(plain, image, label, grad_accum)
    plain_sd = plain.state_dict()
    n_bn = 0
    for k, v in twin.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k], rtol=0,
                                       atol=STATS_ATOL, err_msg=k)
            np.testing.assert_allclose(v.numpy(), plain_sd[k].numpy(),
                                       rtol=0, atol=FOLD_ATOL, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(v) == grad_accum, k
            n_bn += 1
    assert n_bn == sum(isinstance(m, BatchNorm2d) for m in twin.modules())


def test_remat_model_outside_autograd_runs_blocks_straight(tiny):
    """Outside autograd (eval, inference) a remat model runs its blocks
    straight: the same output as 'none', no buffer touched in eval."""
    _, state_dict = tiny
    x = torch.from_numpy(make_batch(31)[0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = twin_of(state_dict).eval()(x)["out"]
        model = twin_of(state_dict, "full").eval()
        got = model(x)["out"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(model.bn1.num_batches_tracked) == 0
    with pytest.raises(ValueError, match="remat"):
        create_deeplab(0, device="cpu", layers=(1, 1, 1, 1), remat="some")


@pytest.mark.parametrize("optimizer,lr_groups", [
    ("adam", False), ("adam", True), ("sgd", False), ("sgd", True)])
def test_freeze_bn_matches_frozen_bn_model(tiny, optimizer, lr_groups):
    variables, state_dict = tiny
    model, _ = jax_create_deeplab(jax.random.key(0), num_channels=1,
                                  image_size=HW, freeze_bn=True,
                                  abstract=True, **TINY)
    assert isinstance(model, FrozenBNModel)
    jstate = jax_seg.create_seg_state(
        model, jax.tree.map(jnp.asarray, variables), learning_rate=LR,
        optimizer=optimizer, lr_groups=lr_groups)
    jstep = jax_seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                        base_lr=LR)
    twin = twin_of(state_dict)
    freeze_batchnorm_affine(twin)
    state = seg.create_seg_state(twin, learning_rate=LR, optimizer=optimizer,
                                 lr_groups=lr_groups, device="cpu")
    step = seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, device="cpu")
    got, want = [], []
    for i in range(STEPS):
        image, label = make_batch(40 + i)
        with fnn.intercept_methods(no_dropout):
            jstate, loss = jstep(jstate, jnp.asarray(image),
                                 jnp.asarray(label))
        want.append(float(loss))
        got.append(float(step(state, torch.from_numpy(image),
                               torch.from_numpy(label))))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

    want_sd = as_state_dict(jax.device_get(jstate.params),
                            jax.device_get(jstate.batch_stats))
    got_sd = twin.state_dict()
    bn = {f"{n}.{p}" for n, m in twin.named_modules()
          if isinstance(m, BatchNorm2d) for p in ("weight", "bias")}
    assert bn
    for k in bn:
        assert torch.equal(got_sd[k], state_dict[k]), k
        np.testing.assert_array_equal(want_sd[k], state_dict[k].numpy(), k)
        stats = k.rsplit(".", 1)[0] + ".running_mean"
        assert not torch.equal(got_sd[stats], state_dict[stats]), stats
    names = dict(twin.named_parameters())
    head = {id(p) for p in backbone_and_head_params(twin)[1]}
    outside = total = 0
    worst = 0.0
    for k, p in names.items():
        if k in bn:
            continue
        mult = 10.0 if lr_groups and id(p) in head else 1.0
        ratio = np.abs(got_sd[k].numpy() - want_sd[k]) / (STEPS * LR * mult)
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        total += ratio.size
    print(f"{optimizer} lr_groups={lr_groups}: {outside} of {total} "
          f"parameters outside the envelope, worst {worst:.3f} of it")
    assert outside <= 1e-4 * total and worst <= 2.0


def test_create_deeplab_freeze_bn_freezes_only_batchnorm():
    model = create_deeplab(0, device="cpu", layers=(1, 1, 1, 1),
                           bn_clr=True, freeze_bn=True)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    want = {f"{n}.{p}" for n, m in model.named_modules()
            if isinstance(m, torch.nn.BatchNorm2d) for p in ("weight", "bias")}
    assert frozen == want and "bn_pretrain.weight" in frozen
    assert all(p.requires_grad for n, p in model.layer5.named_parameters())
