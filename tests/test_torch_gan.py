"""The port's GAN stack (nn/generators.py, nn/patchgan.py, nn/norms.py,
nn/canny.py, ops/image_pool.py, the GAN losses, models/convert.py's GAN
converters and train/gan.py) against the JAX package, on the same
numpy-seeded inputs and the same weights (JAX variables crossed with the
port's own converters).

Sizes are the JAX tests': ``unet_32`` and the PatchGAN at ngf/ndf 8 on
(2, 32, 64, C), ``unet_256`` at (1, 256, 512, 3), module2 sem nets with
layers 1,1,1,1. Tolerances: forwards and their BatchNorm statistics 1e-5;
converters equal keys and arrays; losses 1e-6 (rtol and atol); Canny exact outside the pixels where a
decision sits on its boundary (an orientation within float noise of a bin
edge, a magnitude within it of the threshold), which must be under 0.5%
of the pixels, and its card path (conv filters) within rtol 1e-5 there; the host pool draws as the JAX pool. One GAN
step (the oracle is JAX ``make_gan_steps`` with ``fused_passes=False`` and
the host pool): each metric rtol 1e-4, the BatchNorm statistics 1e-5, the
parameters inside one Adam step's lr envelope (at most 5e-4 outside,
where float noise flips the sign of a near-zero gradient, none past 2 x
lr), D's buffers unchanged by the G pass, and the t2s ids equal to JAX's
argmax outside top-2 near-ties.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_deeplab import (  # noqa: E402
    jax_deeplab_with_twin, jax_legacy_deeplab_with_twin)
from thermal_semantic_segmentation_tpu import losses as jax_losses  # noqa: E402
from thermal_semantic_segmentation_tpu.models import (  # noqa: E402
    factory as jax_factory, torch_convert)
from thermal_semantic_segmentation_tpu.nn import canny as jax_canny  # noqa: E402
from thermal_semantic_segmentation_tpu.ops import (  # noqa: E402
    image_pool as jax_pool)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    upsample_logits as jax_upsample_logits)
from thermal_semantic_segmentation_tpu.train import gan as jax_gan  # noqa: E402
from thermal_semantic_segmentation_torch import losses  # noqa: E402
from thermal_semantic_segmentation_torch.models import (  # noqa: E402
    convert, factory)
from thermal_semantic_segmentation_torch.nn.canny import (  # noqa: E402
    canny_edges)
from thermal_semantic_segmentation_torch.nn.generators import (  # noqa: E402
    weight_init)
from thermal_semantic_segmentation_torch.ops.image_pool import (  # noqa: E402
    DevicePool, ImagePool)
from thermal_semantic_segmentation_torch.train import gan  # noqa: E402

FORWARD_ATOL, STATS_ATOL, LOSS_TOL = 1e-5, 1e-5, 1e-6
METRIC_RTOL = 1e-4
LR = 1e-4
HW = (32, 64)
C, IGNORE = 13, 12
# the contour thresholds of the step and CLI tests (not the defaults)
RGB_TH, THERMAL_TH = 2.0, 0.5
ORIENT_NOISE, MAG_NOISE = 1e-4, 1e-5
CONV_PATH_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on a
    few cores, where more threads only wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_net(kind: str, seed: int, shape, **kw):
    """(JAX module, its variables with randomised BatchNorm statistics)."""
    model = getattr(jax_factory, kind)(**kw)
    variables = _np(jax_factory.init_gan_net(model, jax.random.key(seed),
                                             shape))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.05, v.shape) if p[-1].key == "mean"
                      else rng.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    return model, {"params": variables["params"], "batch_stats": stats}


def _state_dict(kind: str, variables):
    """The port's state_dict of JAX variables of a net of ``kind``."""
    if kind.startswith("unet"):
        return convert.unet_variables_to_state_dict(variables)
    if kind == "patchgan":
        return convert.patchgan_variables_to_state_dict(variables)
    return convert.resnet_generator_variables_to_state_dict(
        variables, n_blocks=int(kind.split("_")[1]))


def port_net(kind: str, variables, **kw):
    """The port's net of ``kind`` with the JAX variables, on the CPU."""
    net = getattr(factory, kind)(**kw)
    net.load_state_dict(_state_dict(kind, variables), strict=True)
    return net.to(memory_format=torch.channels_last)


def _stats_of(net):
    return {k: v.numpy() for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


NETS = [("unet_32", dict(ngf=8, output_nc=1), (2, *HW, 3)),
        ("unet_256", dict(ngf=8, output_nc=1), (1, 256, 512, 3)),
        ("resnet_6", dict(ngf=8, output_nc=3), (2, *HW, 1)),
        ("patchgan", dict(ndf=8), (2, 64, 128, 1))]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind,kw,shape", NETS, ids=[n[0] for n in NETS])
def test_forward_matches_jax(kind, kw, shape, train):
    model, variables = jax_net(kind, 3, (1, *shape[1:]), **kw)
    x = np.random.default_rng(4).uniform(-1, 1, shape).astype(np.float32)
    if train:
        want, mut = model.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    else:
        want = model.apply(variables, jnp.asarray(x), train=False)
    port_kw = dict(kw, input_nc=shape[-1])
    net = port_net(kind, variables, **port_kw).train(train)
    with torch.no_grad():
        got = net(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FORWARD_ATOL)
    if train:
        want_stats = _state_dict(kind, {"params": variables["params"],
                                        "batch_stats": _np(mut["batch_stats"])})
        got_stats = _stats_of(net)
        assert got_stats and all(k in want_stats for k in got_stats)
        for k, v in got_stats.items():
            np.testing.assert_allclose(v, want_stats[k].numpy(), rtol=0,
                                       atol=STATS_ATOL, err_msg=k)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_converters_match_the_jax_package():
    """Each port converter gives the JAX package's own export: the same
    keys and the same arrays; and the port's nets load it strictly."""
    _, unet = jax_net("unet_32", 0, (1, *HW, 3), ngf=8, output_nc=1)
    _assert_same(convert.unet_variables_to_state_dict(unet),
                 torch_convert.unet_flax_to_torch_state_dict(unet,
                                                             num_downs=5))
    _, d = jax_net("patchgan", 1, (1, *HW, 1), ndf=8)
    _assert_same(convert.patchgan_variables_to_state_dict(d),
                 torch_convert.patchgan_flax_to_torch_state_dict(d))
    _, res = jax_net("resnet_6", 2, (1, *HW, 1), ngf=8, output_nc=3)
    _assert_same(
        convert.resnet_generator_variables_to_state_dict(res, n_blocks=6),
        torch_convert.resnet_generator_flax_to_torch_state_dict(
            res, n_blocks=6))
    ckpt = {"epoch": 3, "g_vars": {"s2t": unet, "t2s": unet},
            "d_vars": {"t": d, "s": d}}
    got = convert.jax_gan_checkpoint_to_torch(ckpt)
    want = torch_convert.flax_gan_checkpoint_to_torch(ckpt, num_downs=5)
    assert sorted(got) == sorted(want) and got["epoch"] == 3
    for key in want:
        if key != "epoch":
            _assert_same(got[key], want[key])
    one_way = convert.jax_gan_checkpoint_to_torch(
        {"epoch": 0, "g_vars": {"s2t": unet}, "d_vars": {"t": d}})
    assert sorted(one_way) == ["epoch", "net_d_t_state_dict",
                               "net_g_s2t_state_dict"]
    factory.unet_32(ngf=8, output_nc=1).load_state_dict(
        got["net_g_s2t_state_dict"], strict=True)
    factory.patchgan(ndf=8).load_state_dict(got["net_d_t_state_dict"],
                                            strict=True)
    with pytest.raises(ValueError, match="unconverted"):
        convert.unet_variables_to_state_dict(unet, num_downs=4)


def _boundary_pixels(img, threshold):
    """Pixels where a decision of Canny sits within float noise of its
    boundary, from the JAX op's own intermediates: orientation / 45 near
    a .5 (the bin), or the magnitude near the threshold."""
    c = img.shape[-1]
    gxs, gys, mags = [], [], []
    for ch in range(c):
        _, gx, gy = jax_canny._blur_sobel(jnp.asarray(img[..., ch:ch + 1]))
        gxs.append(np.asarray(gx))
        gys.append(np.asarray(gy))
        mags.append(np.asarray(jax_canny._safe_magnitude(gx, gy)))
    gx, gy, mag = sum(gxs), sum(gys), sum(mags)
    q = (np.arctan2(gy, gx) * (180.0 / 3.14159) + 180.0) / 45.0
    near_bin = np.abs(q - np.floor(q) - 0.5) < ORIENT_NOISE
    near_th = np.abs(mag - threshold) < MAG_NOISE * max(1.0, threshold)
    return (near_bin | near_th)[..., 0]


@pytest.mark.parametrize("channels,threshold", [(1, 1.0), (3, 2.5),
                                                (1, 2.5), (3, 1.0)])
def test_canny_matches_jax(channels, threshold):
    rng = np.random.default_rng(channels * 10 + int(threshold))
    for scale in (1.0, 100.0):
        x = (rng.uniform(-1, 1, (3, *HW, channels)) * scale).astype(
            np.float32)
        want = np.asarray(jax_canny.canny_edges(jnp.asarray(x),
                                                threshold=threshold))[..., 0]
        got = canny_edges(_t(x), threshold=threshold).numpy()[..., 0]
        boundary = _boundary_pixels(x, threshold)
        differ = got != want
        print(f"C={channels} threshold={threshold} scale={scale}: "
              f"{int(differ.sum())} pixels differ, {int(boundary.sum())} "
              f"of {boundary.size} on a boundary, "
              f"{int((want > 0).sum())} edges")
        assert boundary.mean() < 0.005
        assert not (differ & ~boundary).any()
        assert (want > 0).mean() > 0.05


@pytest.mark.parametrize("channels", [1, 3])
def test_canny_gradient_is_nan_free_on_flat_regions(channels):
    """sqrt'(0) and atan2'(0, 0) are not finite; flat and banded frames hit
    them, and the contour loss backpropagates through the edges."""
    flat = torch.full((1, 16, 32, channels), 0.3)
    banded = torch.cat([torch.zeros(2, 16, 16, channels),
                        torch.ones(2, 16, 16, channels)], dim=2)
    for img in (flat, banded):
        img = img.clone().requires_grad_(True)
        canny_edges(img, threshold=1.0).abs().mean().backward()
        assert torch.isfinite(img.grad).all()
    assert float(canny_edges(banded * 100.0, threshold=1.0).max()) > 0


@pytest.mark.parametrize("channels,threshold", [(1, 1.0), (3, 2.5)])
def test_canny_conv_path_matches_jax(channels, threshold):
    """The card's way (``exact=False``: conv filters, float32 root), run
    here on the CPU: the same pixels kept outside the boundary pixels, the
    kept magnitudes within rtol ``CONV_PATH_RTOL``, and a finite gradient
    on flat and banded frames."""
    rng = np.random.default_rng(channels * 10 + int(threshold) + 5)
    for scale in (1.0, 100.0):
        x = (rng.uniform(-1, 1, (3, *HW, channels)) * scale).astype(
            np.float32)
        want = np.asarray(jax_canny.canny_edges(jnp.asarray(x),
                                                threshold=threshold))[..., 0]
        got = canny_edges(_t(x), threshold=threshold,
                          exact=False).numpy()[..., 0]
        boundary = _boundary_pixels(x, threshold)
        parted = (got > 0) != (want > 0)
        far = ~np.isclose(got, want, rtol=CONV_PATH_RTOL, atol=0.0)
        print(f"C={channels} threshold={threshold} scale={scale}: "
              f"{int(parted.sum())} pixels parted, {int(boundary.sum())} "
              f"of {boundary.size} on a boundary, "
              f"max rel err {float(np.abs(got - want).max() / np.abs(want).max()):.3g}")
        assert boundary.mean() < 0.005
        assert not ((parted | far) & ~boundary).any()
        assert (want > 0).mean() > 0.05
    flat = torch.full((1, 16, 32, channels), 0.3)
    banded = torch.cat([torch.zeros(2, 16, 16, channels),
                        torch.ones(2, 16, 16, channels)], dim=2)
    for img in (flat, banded):
        img = img.clone().requires_grad_(True)
        canny_edges(img, threshold=1.0, exact=False).abs().mean().backward()
        assert torch.isfinite(img.grad).all()


def test_host_pool_draws_as_jax():
    want_pool, got_pool = jax_pool.ImagePool(6, seed=3), ImagePool(6, seed=3)
    rng = np.random.default_rng(5)
    for _ in range(8):
        batch = rng.normal(size=(4, 2, 3, 1)).astype(np.float32)
        want = want_pool.query(batch)
        got = got_pool.query(_t(batch))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
    assert got_pool.num_imgs == want_pool.num_imgs == 6
    assert ImagePool(0).query(_t(batch)) is not None


def test_device_pool_semantics():
    """The device ring: fill first (the batch passes and is stored), then
    each output is the incoming image or a stored one, about half of each;
    pool_size 0 passes through (JAX tests/test_gan.py's semantics)."""
    p = 6
    pool = DevicePool(p, (2, 2, 1), device="cpu", seed=0)
    first = _t(np.random.default_rng(1).normal(size=(p, 2, 2, 1)).astype(
        np.float32))
    assert torch.equal(pool.query(first), first)
    assert int(pool.count) == p and torch.equal(pool.buffer, first)
    stored = set(first.reshape(p, -1)[:, 0].tolist())
    swaps = 0
    for step in range(20):
        batch = torch.full((4, 2, 2, 1), 100.0 + step)
        out = pool.query(batch)[:, 0, 0, 0].tolist()
        for v in out:
            if v != 100.0 + step:
                assert v in stored or 100.0 <= v < 100.0 + step
                swaps += 1
        stored |= {100.0 + step}
    assert 10 <= swaps <= 70, swaps
    assert int(pool.count) == p
    assert torch.equal(DevicePool(0, (2, 2, 1), device="cpu").query(first),
                       first)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(2, 6, 14, 1)).astype(np.float32)
    for name in ("lsgan", "vanilla", "wgan"):
        for real in (True, False):
            np.testing.assert_allclose(
                float(losses.GAN_LOSSES[name](_t(pred), real)),
                float(jax_losses.GAN_LOSSES[name](jnp.asarray(pred), real)),
                rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"{name} {real}")
    a, b = (rng.normal(size=(2, 8, 8, 3)).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(float(losses.l1_loss(_t(a), _t(b))),
                               float(jax_losses.l1_loss(a, b)), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    logits = rng.normal(size=(2, 8, 16, C)).astype(np.float32) * 3
    labels = rng.integers(0, C, (2, 8, 16))
    labels[0, :2] = 255
    labels[1, 3] = 5
    for kw in ({}, {"ignore_classes": (5, 11)}):
        np.testing.assert_allclose(
            float(losses.semantic_consistency(_t(logits), _t(labels), **kw)),
            float(jax_losses.semantic_consistency(logits, labels, **kw)),
            rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=str(kw))
    alpha = rng.uniform(0.5, 1.5, C).astype(np.float32)
    for kw in ({}, {"gamma": 2.0}, {"gamma": 2.0, "alpha": alpha},
               {"gamma": 0.5, "ignore_index": IGNORE}):
        got = losses.focal_loss(_t(logits), _t(labels), **kw)
        want = jax_losses.focal_loss(logits, labels, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=str(kw))


@pytest.mark.parametrize("mode", ["legacy", "module2"])
@pytest.mark.parametrize("domain,c", [("source", 3), ("target", 1)])
def test_gan_to_seg_tensor_matches_jax(mode, domain, c):
    x = np.random.default_rng(2).uniform(-1, 1, (2, 4, 6, c)).astype(
        np.float32)
    np.testing.assert_array_equal(
        gan.gan_to_seg_tensor(_t(x), domain, mode).numpy(),
        np.asarray(jax_gan.gan_to_seg_tensor(jnp.asarray(x), domain, mode)))
    gray = np.asarray(jax_gan._gray(jnp.asarray(x)))
    np.testing.assert_allclose(gan._gray(_t(x)).numpy(), gray, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
def test_weight_init_draws_from_the_seed(init_type):
    def build(seed):
        net = factory.unet_32(ngf=8, output_nc=1, init_type=init_type)
        return factory.init_gan_net(net, seed, device="cpu")

    a, b, c = build(0), build(0), build(1)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.model.model[0].weight
    assert not torch.equal(w, c.model.model[0].weight)
    if init_type == "normal":
        assert abs(float(w.detach().std()) - 0.02) < 0.004
    bn = a.model.model[1].model[2]
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.bias, torch.zeros_like(bn.bias))
    with pytest.raises(NotImplementedError):
        weight_init("uniform")


def _gan_world(cycle: bool, sem_mode: str = "module2"):
    """JAX and port nets with the same weights, tiny sem nets (layers
    1,1,1,1; module2, or the legacy 19-class nets) and one batch."""
    nets = {"s2t": ("unet_32", dict(ngf=8, output_nc=1), 3),
            "t2s": ("unet_32", dict(ngf=8, output_nc=3), 1),
            "t": ("patchgan", dict(ndf=8), 1),
            "s": ("patchgan", dict(ndf=8), 3)}
    if not cycle:
        nets = {k: nets[k] for k in ("s2t", "t")}
    jax_models, jax_vars, port = {}, {}, {}
    for i, (name, (kind, kw, in_c)) in enumerate(nets.items()):
        jax_models[name], jax_vars[name] = jax_net(kind, 20 + i,
                                                   (1, *HW, in_c), **kw)
        port[name] = port_net(kind, jax_vars[name], input_nc=in_c, **kw)
    sem_models, sem_vars, sem_port = {}, {}, {}
    twin = jax_legacy_deeplab_with_twin if sem_mode == "legacy" \
        else jax_deeplab_with_twin
    for name, (seed, c) in {"s": (30, 3), "t": (31, 1)}.items():
        sem_models[name], sem_vars[name], sem_port[name] = twin(
            seed, num_channels=c)
        sem_port[name].requires_grad_(False)
    rng = np.random.default_rng(9)
    batch = {"real_s": rng.uniform(-1, 1, (2, *HW, 3)).astype(np.float32),
             "real_t": rng.uniform(-1, 1, (2, *HW, 1)).astype(np.float32),
             "label_s": rng.integers(0, C, (2, *HW))}
    return jax_models, jax_vars, port, sem_models, sem_vars, sem_port, batch


def _port_sd(port_nets, names):
    return {n: {k: v.detach().clone() for k, v in
                port_nets[n].state_dict().items()} for n in names}


def _jax_sd(name, variables):
    return _state_dict("unet" if name in ("s2t", "t2s") else "patchgan",
                       variables)


@pytest.mark.parametrize("cycle,sem_mode", [
    (True, "module2"), (False, "module2"), (True, "legacy")],
    ids=["cycle", "one_way", "legacy"])
def test_gan_step_matches_jax(cycle, sem_mode, monkeypatch):
    """The legacy case: the 19-class legacy sem nets on BGR
    mean-subtracted [0, 255] input, their 19-class t2s ids against the
    13-class source labels' CE as the JAX step takes them."""
    (jax_models, jax_vars, port, sem_models, sem_vars, sem_port,
     batch) = _gan_world(cycle, sem_mode)
    g_names = [n for n in ("s2t", "t2s") if n in port]
    d_names = [n for n in ("t", "s") if n in port]
    kw = dict(cycle=cycle, with_contour=True,
              canny_rgb_threshold=RGB_TH, canny_thermal_threshold=THERMAL_TH,
              sem_norm=sem_mode)

    jstate = jax_gan.create_gan_state(
        g_vars={n: jax_vars[n] for n in g_names},
        d_vars={n: jax_vars[n] for n in d_names}, learning_rate=LR)
    jg_step, jd_step = jax_gan.make_gan_steps(
        g_apply={n: jax_models[n].apply for n in g_names},
        d_apply={n: jax_models[n].apply for n in d_names},
        sem_apply={k: m.apply for k, m in sem_models.items()},
        fused_passes=False, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jmetrics, jouts = jg_step(jstate, jb["real_s"], jb["real_t"],
                                      jb["label_s"], sem_vars, with_sem=True)
    jpools = {n: jax_pool.ImagePool(50, seed=i)
              for i, n in enumerate(d_names)}
    jreals = {"t": jb["real_t"], "s": jb["real_s"]}
    jfakes = {n: jnp.asarray(jpools[n].query(jouts[f"fake_{n}"]))
              for n in d_names}
    jstate, jd_metrics = jd_step(jstate, {n: jreals[n] for n in d_names},
                                 jfakes)
    want = {k: float(v) for k, v in {**jmetrics, **jd_metrics}.items()}

    seen_ids = []
    real_kernel = gan.upsample_argmax

    def recording(logits, h, w):
        out = real_kernel(logits, h, w)
        seen_ids.append((logits.detach().clone(), out[0]))
        return out

    monkeypatch.setattr(gan, "upsample_argmax", recording)
    state = gan.create_gan_state(g_nets={n: port[n] for n in g_names},
                                 d_nets={n: port[n] for n in d_names},
                                 learning_rate=LR, device="cpu")
    g_step, d_step = gan.make_gan_steps(sem_nets=sem_port, **kw)
    tb = {k: _t(v) for k, v in batch.items()}
    d_before = _port_sd(port, d_names)
    stages = []
    metrics, outs = g_step(state, tb["real_s"], tb["real_t"], tb["label_s"],
                           with_sem=True, mark=stages.append)
    assert stages == ["g_forward", "canny", "sem", "g_backward", "g_adam"]
    assert state.step == 1
    for n in d_names:      # the G pass ran D in train mode, read-only
        for k, v in port[n].state_dict().items():
            assert torch.equal(v, d_before[n][k]), (n, k)
        assert all(p.requires_grad for p in port[n].parameters())
        assert all(p.grad is None for p in port[n].parameters())
    pools = {n: ImagePool(50, seed=i) for i, n in enumerate(d_names)}
    treals = {"t": tb["real_t"], "s": tb["real_s"]}
    metrics.update(d_step(state, {n: treals[n] for n in d_names},
                          {n: pools[n].query(outs[f"fake_{n}"])
                           for n in d_names}))
    got = {k: float(v) for k, v in metrics.items()}
    print(f"cycle={cycle}: port {got}\nJAX {want}")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   err_msg=k)

    # the t2s labels: the kernel's path (its plain version on the CPU) on
    # the frozen thermal net's logits, against JAX's argmax of the
    # upsampled logits outside top-2 near-ties
    assert len(seen_ids) == (1 if cycle else 0)
    if cycle:
        logits, ids = seen_ids[0]
        jlogits = sem_models["t"].apply(
            sem_vars["t"], jax_gan.gan_to_seg_tensor(
                jnp.asarray(batch["real_t"]), "target", sem_mode))["out"]
        up = np.asarray(jax_upsample_logits(jlogits, *HW))
        top2 = np.sort(up, axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 1e-5
        assert decided.mean() > 0.99
        np.testing.assert_array_equal(ids.numpy()[decided],
                                      up.argmax(-1)[decided])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=5e-4)

    jax_g = {n: jax.device_get({"params": jstate.g_params[n],
                                "batch_stats": jstate.g_stats[n]})
             for n in g_names}
    jax_d = {n: jax.device_get({"params": jstate.d_params[n],
                                "batch_stats": jstate.d_stats[n]})
             for n in d_names}
    outside = total = 0
    worst = 0.0
    for n, variables in {**jax_g, **jax_d}.items():
        want_sd = _jax_sd(n, variables)
        params = dict(port[n].named_parameters())
        for k, v in port[n].state_dict().items():
            if k.endswith("num_batches_tracked"):
                # G: two passes per generator with cycle, one without; D:
                # real and fake in its own step only
                assert int(v) == (2 if cycle or n in ("t", "s") else 1), k
                continue
            if k in params:
                ratio = np.abs(v.numpy() - want_sd[k].numpy()) / LR
                worst = max(worst, float(ratio.max()))
                outside += int((ratio > 1.0).sum())
                total += ratio.size
            else:
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                           rtol=0, atol=STATS_ATOL,
                                           err_msg=f"{n} {k}")
    print(f"{outside} of {total} parameters outside the lr envelope, worst "
          f"{worst:.3f} of it")
    assert outside <= 5e-4 * total and worst <= 2.0 + 1e-3


def test_device_step_runs_the_pools():
    """``make_gan_step``: G, the device pools, D in one call; the fakes fill
    the pools; the metrics are the two-step form's keys. (With the sem
    loss it runs in tests/test_torch_gan_cli.py's resume test.)"""
    port = {"s2t": factory.unet_32(ngf=8, output_nc=1),
            "t2s": factory.unet_32(ngf=8, input_nc=1, output_nc=3),
            "t": factory.patchgan(ndf=8), "s": factory.patchgan(ndf=8,
                                                                input_nc=3)}
    for i, net in enumerate(port.values()):
        factory.init_gan_net(net, i, device="cpu")
    rng = np.random.default_rng(9)
    batch = {"real_s": rng.uniform(-1, 1, (2, *HW, 3)).astype(np.float32),
             "real_t": rng.uniform(-1, 1, (2, *HW, 1)).astype(np.float32)}
    state = gan.create_gan_state(
        g_nets={n: port[n] for n in ("s2t", "t2s")},
        d_nets={n: port[n] for n in ("t", "s")}, learning_rate=LR,
        device="cpu")
    step, make_pools = gan.make_gan_step(pool_size=3, cycle=True,
                                         with_contour=True)
    pools = make_pools({"t": (*HW, 1), "s": (*HW, 3)}, device="cpu", seed=0)
    tb = {k: _t(v) for k, v in batch.items()}
    stages = []
    for i in range(2):
        metrics, outs = step(state, pools, tb["real_s"], tb["real_t"],
                             mark=stages.append if i else None)
    assert stages == ["g_forward", "canny", "g_backward", "g_adam", "pool",
                      "d_step"]
    assert sorted(metrics) == sorted(
        ["g_s2t", "g_t2s", "cycle_s", "cycle_t", "con_s2t", "con_t2s",
         "loss_g", "d_t", "d_s"])
    assert sorted(outs) == ["fake_s", "fake_t"]
    assert all(torch.isfinite(v) for v in metrics.values())
    assert int(pools["t"].count) == int(pools["s"].count) == 3
    assert state.step == 2


def test_create_gan_state_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gan.create_gan_state(g_nets={}, d_nets={}, learning_rate=LR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.init_gan_net(factory.patchgan(ndf=8), 0)
