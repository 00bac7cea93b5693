"""The port's train step (train/seg.py, nn/resnet.BatchNorm2d,
nn/aspp.Dropout2d, models/deeplab.backbone_and_head_params,
core/schedule.py) against the JAX package, on a tiny DeepLabV2
(layers 1,1,1,1) at 64x128.

Weights cross from JAX through ``models/convert.jax_variables_to_state_dict``.
Dropout is off on both sides: in JAX by intercepting ``nn.Dropout`` (the
jitted step is traced inside the context), in the port by ``p = 0``.
Tolerances: a train-mode forward's outputs 5e-4 and the BatchNorm running
statistics it folds in 1e-5 (1e-6 for one BatchNorm), which the unbiased
variance of stock ``nn.BatchNorm2d`` misses; loss rtol 1e-5 at each of 3
steps; the first step's gradients 5e-4 absolute and its running statistics
5e-4; parameters after 3 steps inside the 3 x lr envelope (x10
for the head with ``lr_groups``) but for an outlier count: Adam moves a
parameter whose gradient sits at float noise by about lr in the noise's
direction, so a few elements land up to 2 x outside it. The counts are
printed (run with ``-s``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_deeplab import HW, jax_deeplab_with_twin  # noqa: E402
from thermal_semantic_segmentation_tpu.core.schedule import (  # noqa: E402
    ReduceLROnPlateau as JaxPlateau)
from thermal_semantic_segmentation_tpu.losses import (  # noqa: E402
    cross_entropy as jax_cross_entropy)
from thermal_semantic_segmentation_tpu.models.deeplab import (  # noqa: E402
    backbone_and_head_masks)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    upsample_logits as jax_upsample_logits)
from thermal_semantic_segmentation_tpu.train import (  # noqa: E402
    seg as jax_seg)
from thermal_semantic_segmentation_torch.core.schedule import (  # noqa: E402
    ReduceLROnPlateau, poly_lr)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.models.convert import (  # noqa: E402
    jax_variables_to_state_dict)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    backbone_and_head_params)
from thermal_semantic_segmentation_torch.nn.aspp import Dropout2d  # noqa: E402
from thermal_semantic_segmentation_torch.nn.resnet import (  # noqa: E402
    BatchNorm2d)
from thermal_semantic_segmentation_torch.train import seg  # noqa: E402

LR = 1e-4
STEPS = 3
IGNORE = 12
LOSS_RTOL = 1e-5
GRAD_ATOL = 5e-4
STATS_ATOL = 5e-4
# one train-mode forward from the same weights: tight enough that torch's
# unbiased running variance (0.1 * var / n more) falls outside it
ONE_STEP_STATS_ATOL = 1e-5


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: ``nn.Dropout`` returns its input."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def make_batch(seed: int, n: int = 2):
    """Images in [0, 1] and labels 0..12 with about 5% 255 (dropped by the
    loss), as numpy."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (n, *HW, 1)).astype(np.float32)
    label = rng.integers(0, 13, (n, *HW))
    label[rng.random((n, *HW)) < 0.05] = 255
    return image, label



@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on a
    few cores, where more threads only wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax variables, a state_dict of the same weights)."""
    model, variables, twin = jax_deeplab_with_twin(5)
    return model, variables, {k: v.clone() for k, v in
                              twin.state_dict().items()}


def port_twin(state_dict):
    from thermal_semantic_segmentation_torch.models.deeplab import DeepLabV2
    twin = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
    twin.load_state_dict(state_dict, strict=True)
    twin = twin.to(memory_format=torch.channels_last)
    twin.layer5.head[0].p = 0.0
    return twin


def as_state_dict(params, batch_stats):
    return {k: v.numpy() for k, v in jax_variables_to_state_dict(
        {"params": params, "batch_stats": batch_stats}).items()}


def jax_grads(model, variables, image, label, grad_accum):
    """The JAX step's gradients (microbatch mean, BatchNorm statistics
    threaded through the microbatches), by the JAX step's own loss."""
    def loss_fn(params, stats, im, lab):
        out, mutated = model.apply({"params": params, "batch_stats": stats},
                                   im, train=True, mutable=["batch_stats"])
        logits = jax_upsample_logits(out["out"], *HW)
        return (jax_cross_entropy(logits, lab, ignore_index=IGNORE),
                mutated["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    stats, total = variables["batch_stats"], None
    with fnn.intercept_methods(no_dropout):
        for im, lab in zip(np.split(image, grad_accum),
                           np.split(label, grad_accum)):
            g, stats = grad_fn(variables["params"], stats, jnp.asarray(im),
                               jnp.asarray(lab))
            total = g if total is None else jax.tree.map(jnp.add, total, g)
    return jax.tree.map(lambda g: np.asarray(g) / grad_accum, total)


def test_batchnorm_running_var_follows_flax():
    """One train-mode forward folds the biased batch variance into
    running_var, as flax does; stock nn.BatchNorm2d folds the unbiased
    one and misses by 0.1 * var / n."""
    x = np.random.default_rng(0).normal(1.0, 1.0, (2, 4, 8, 3)).astype(
        np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    variables = flax_bn.init(jax.random.key(0), jnp.asarray(x))
    want_y, mutated = flax_bn.apply(variables, jnp.asarray(x),
                                    mutable=["batch_stats"])
    want_var = np.asarray(mutated["batch_stats"]["var"])
    want_mean = np.asarray(mutated["batch_stats"]["mean"])

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bn = BatchNorm2d(3, eps=1e-5).train()
    y = bn(xt)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y), rtol=0, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var", "num_batches_tracked"}

    stock = torch.nn.BatchNorm2d(3, eps=1e-5).train()
    stock(xt)
    print(f"running_var[0]: flax {want_var[0]}, port {bn.running_var[0]}, "
          f"stock nn.BatchNorm2d {stock.running_var[0]}")
    gap = np.abs(stock.running_var.numpy() - want_var)
    n = x.size // x.shape[-1]
    np.testing.assert_allclose(gap, 0.1 * x.reshape(-1, 3).var(0, ddof=1) / n,
                               rtol=1e-3)
    assert gap.max() > 1e-6


def test_batchnorm_train_forward_backward_is_stock_normalisation():
    """The rescaled update leaves the output and gradients of the stock
    module, and autograd takes the in-place buffer update."""
    x = torch.randn(4, 6, 5, 7, generator=torch.Generator().manual_seed(1))
    ours, stock = BatchNorm2d(6).train(), torch.nn.BatchNorm2d(6).train()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = ours(xa), stock(xb)
    (ya * ya).sum().backward()
    (yb * yb).sum().backward()
    torch.testing.assert_close(ya, yb)
    torch.testing.assert_close(xa.grad, xb.grad)
    torch.testing.assert_close(ours.weight.grad, stock.weight.grad)


def test_train_mode_forward_and_bn_stats_match_jax(tiny):
    model, variables, state_dict = tiny
    image, _ = make_batch(1)
    with fnn.intercept_methods(no_dropout):
        want, mutated = model.apply(variables, jnp.asarray(image), train=True,
                                    mutable=["batch_stats"])
    twin = port_twin(state_dict).train()
    got = twin(torch.from_numpy(image).permute(0, 3, 1, 2))
    for key in ("out", "feat"):
        np.testing.assert_allclose(
            got[key].detach().permute(0, 2, 3, 1).numpy(),
            np.asarray(want[key]), rtol=0, atol=5e-4, err_msg=key)
    want_sd = as_state_dict(variables["params"], mutated["batch_stats"])
    got_sd = twin.state_dict()
    n_stats = 0
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[k].numpy(), v, rtol=0,
                                       atol=ONE_STEP_STATS_ATOL, err_msg=k)
            n_stats += 1
        if k.endswith("running_var"):
            assert int(got_sd[k.replace("running_var",
                                        "num_batches_tracked")]) == 1
    assert n_stats == 2 * sum(isinstance(m, BatchNorm2d)
                              for m in twin.modules())


@pytest.mark.parametrize("optimizer,lr_groups,grad_accum", [
    ("adam", False, 1), ("sgd", False, 1), ("adam", True, 1),
    ("adam", False, 2)])
def test_train_step_matches_jax(tiny, optimizer, lr_groups, grad_accum):
    model, variables, state_dict = tiny
    batches = [make_batch(10 + i) for i in range(STEPS)]

    jstate = jax_seg.create_seg_state(
        model, jax.tree.map(jnp.asarray, variables), learning_rate=LR,
        optimizer=optimizer, lr_groups=lr_groups)
    jstep = jax_seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                        base_lr=LR, grad_accum=grad_accum)
    twin = port_twin(state_dict)
    state = seg.create_seg_state(twin, learning_rate=LR, optimizer=optimizer,
                                 lr_groups=lr_groups, device="cpu")
    step = seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, grad_accum=grad_accum,
                                   device="cpu")
    names = dict(twin.named_parameters())
    got_losses, want_losses = [], []
    for i, (image, label) in enumerate(batches):
        with fnn.intercept_methods(no_dropout):
            jstate, loss = jstep(jstate, jnp.asarray(image),
                                 jnp.asarray(label))
        want_losses.append(float(loss))
        loss = step(state, torch.from_numpy(image), torch.from_numpy(label))
        got_losses.append(float(loss))
        if i:
            continue
        # the first step runs from the same weights: its gradients and the
        # running statistics it folds in are the algorithm's parity (later
        # steps run from weights that Adam's noise has moved apart)
        want_g = as_state_dict(
            jax_grads(model, variables, image, label, grad_accum),
            variables["batch_stats"])
        for name, p in names.items():
            np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=0,
                                       atol=GRAD_ATOL, err_msg=name)
        want_sd = as_state_dict(jax.device_get(jstate.params),
                                jax.device_get(jstate.batch_stats))
        for k, v in twin.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want_sd[k], rtol=0,
                                           atol=STATS_ATOL, err_msg=k)
    assert state.step == STEPS
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)

    want_sd = as_state_dict(jax.device_get(jstate.params),
                            jax.device_get(jstate.batch_stats))
    got_sd = twin.state_dict()
    _, head = backbone_and_head_params(twin)
    head_ids = {id(p) for p in head}
    apart = outside = total = 0
    worst = 0.0
    for k, want in want_sd.items():
        if k not in names:            # BatchNorm running statistics
            continue
        got = got_sd[k].numpy()
        mult = 10.0 if lr_groups and id(names[k]) in head_ids else 1.0
        ratio = np.abs(got - want) / (STEPS * LR * mult)
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        apart += int((ratio > 1e-3).sum())
        total += ratio.size
    print(f"{optimizer} lr_groups={lr_groups} grad_accum={grad_accum}: "
          f"{outside} of {total} parameters outside the envelope, {apart} "
          f"apart by more than 1e-3 of it, worst {worst:.3f} of it")
    assert outside <= 1e-4 * total and worst <= 2.0


def test_lr_scale_zero_moves_no_parameter(tiny):
    _, _, state_dict = tiny
    twin = port_twin(state_dict)
    before = {k: v.clone() for k, v in twin.named_parameters()}
    state = seg.create_seg_state(twin, learning_rate=LR, device="cpu")
    state.lr_scale = 0.0
    step = seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, device="cpu")
    image, label = make_batch(3)
    step(state, torch.from_numpy(image), torch.from_numpy(label))
    for k, p in twin.named_parameters():
        assert torch.equal(p, before[k]), k
    assert int(twin.bn1.num_batches_tracked) == 1


def test_indivisible_grad_accum_raises(tiny):
    _, _, state_dict = tiny
    state = seg.create_seg_state(port_twin(state_dict), learning_rate=LR,
                                 device="cpu")
    step = seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, grad_accum=2, device="cpu")
    image, label = make_batch(4, n=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, torch.from_numpy(image), torch.from_numpy(label))


@pytest.mark.parametrize("kw", [
    {}, {"patience": 2, "factor": 0.5}, {"patience": 1, "cooldown": 2},
    {"patience": 0, "threshold": 0.1}, {"mode": "max", "patience": 1},
    {"patience": 0, "min_scale": 1e-3}])
def test_plateau_scheduler_follows_jax(kw):
    losses = np.random.default_rng(len(kw)).uniform(0.5, 1.0, 40)
    losses[::7] *= 0.5
    ours, theirs = ReduceLROnPlateau(**kw), JaxPlateau(**kw)
    assert [ours.step(v) for v in losses] == [theirs.step(v) for v in losses]


def test_plateau_scale_keeps_falling_where_torch_stops():
    """From lr 1e-4, torch's own scheduler skips the fifth reduction (its
    eps 1e-8); the scale keeps falling, as in the JAX package."""
    ours = ReduceLROnPlateau(patience=0)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1e-4)
    theirs = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, patience=0)
    for _ in range(7):
        scale = ours.step(1.0)
        theirs.step(1.0)
    np.testing.assert_allclose(1e-4 * scale, 1e-10, rtol=1e-9)
    assert opt.param_groups[0]["lr"] > 1e-9
    assert poly_lr(1e-3, 5, 10) == 1e-3 * 0.5 ** 0.9


def test_head_param_split_matches_jax_masks(tiny):
    model, variables, state_dict = tiny
    _, head_mask = backbone_and_head_masks(variables["params"])
    want_head = sum(int(np.size(p)) for p, m in zip(
        jax.tree.leaves(variables["params"]), jax.tree.leaves(head_mask))
        if m)
    twin = port_twin(state_dict)
    backbone, head = backbone_and_head_params(twin)
    assert sum(p.numel() for p in head) == want_head
    by_id = {id(p): n for n, p in twin.named_parameters()}
    assert all(by_id[id(p)].startswith("layer5.") for p in head)
    assert all(by_id[id(p)].split(".")[0] in
               ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")
               for p in backbone)
    assert len(backbone) + len(head) == len(by_id)


def test_dropout_draws_whole_channels_from_the_seeded_generator():
    drop = Dropout2d().train()
    x = torch.ones(4, 64, 3, 5)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 1, 1), drop)
    seg.seed_dropout(model, 0, 7)
    a = drop(x)
    seg.seed_dropout(model, 0, 7)
    b = drop(x)
    seg.seed_dropout(model, 0, 8)
    c = drop(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a[:, :, 0, 0] != 0
    assert torch.equal(a, kept[:, :, None, None] / 0.9 * x)
    assert 0.75 < float(kept.float().mean()) < 0.99
    assert torch.equal(drop.eval()(x), x)


def test_eval_step_scores_a_train_mode_model_in_eval_mode(tiny):
    """seg_validate sets eval mode for the forward (JAX applies
    train=False whatever the state): a model left in train() scores as in
    eval(), its BatchNorm buffers untouched, and it is left in train()."""
    _, _, state_dict = tiny
    twin = port_twin(state_dict)
    twin.layer5.head[0].p = 0.1
    batches = [dict(zip(("image", "label"), make_batch(20 + i)))
               for i in range(2)]
    want = seg_validate(twin.eval(), batches, device="cpu")
    buffers = {k: v.clone() for k, v in twin.named_buffers()}
    got = seg_validate(twin.train(), batches, device="cpu")
    assert twin.training and twin.layer5.training
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]
    for k, v in twin.named_buffers():
        assert torch.equal(v, buffers[k]), k
