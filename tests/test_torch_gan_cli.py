"""The port's GAN CLIs (cli/main.py, cli/main_gan.py, cli/translator.py,
cli/options.train_parse and translation_parse, cli/_common's GAN
checkpoints) against the JAX CLIs, on one synthetic Freiburg tree.

Both packages' ``unet_256`` and ``patchgan`` are narrowed to ``unet_32``
at ngf 8 and the PatchGAN at ndf 8, and their ``_gan_transform`` crops
32x64 (the JAX CLI on its one-device mesh, as tests/test_gan_cli.py runs
it). Both runs start from one JAX msgpack GAN checkpoint with
``-load_model true`` (the packages' random inits differ) and take
``-max_steps 2 -lr 1e-3`` with non-default Canny thresholds, the contour
and the module2 semantic losses on (tiny sem nets, layers 1,1,1,1), and
the host pool: the JAX device pool is sized for 256x512 crops. So a flag
passed wrongly moves the weights.

Tolerances: the saved generator and discriminator parameters inside the
Adam envelope of 2 steps x lr (at most 5e-4 of them outside, none past
twice it), the BatchNorm statistics 1e-4; the trained generators' outputs
on one fixed input rtol 1e-3 (the gap observed is printed); each
package's generator from the other's checkpoint 1e-5 of the other's own;
the translator's files at the JAX translator's paths, within one grey
level of its pixels.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tests.synthetic import make_freiburg_tree  # noqa: E402
from tests.test_torch_isolation import one_process_group  # noqa: E402,F401
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common, main as jax_main, main_gan as jax_main_gan,
    translator as jax_translator)
from thermal_semantic_segmentation_tpu.core.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint, save_checkpoint)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    transforms as JT)
from thermal_semantic_segmentation_tpu.models import (  # noqa: E402
    factory as jax_factory)
from thermal_semantic_segmentation_tpu.models.deeplab import (  # noqa: E402
    create_deeplab as jax_create_deeplab)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, main, main_gan, translator)
from thermal_semantic_segmentation_torch.data import transforms as T  # noqa: E402
from thermal_semantic_segmentation_torch.models import factory  # noqa: E402
from thermal_semantic_segmentation_torch.models.convert import (  # noqa: E402
    GAN_KEYS, jax_gan_checkpoint_to_torch)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)

LR, STEPS = 1e-3, 2
STATS_ATOL, OUT_RTOL, CROSS_ATOL = 1e-4, 1e-3, 1e-5
HW = (32, 64)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _crop(transforms):
    return lambda normalize: transforms.Compose([
        transforms.RandomResizedCrop(size=HW, ratio=(1.5, 8 / 3.),
                                     scale=(0.5, 1.0)),
        transforms.RandomHorizontalFlip(), transforms.ToArray(),
        transforms.Normalize(tuple(normalize), tuple(normalize))])


@pytest.fixture
def narrow(monkeypatch):
    import thermal_semantic_segmentation_tpu.parallel.mesh as pmesh

    monkeypatch.setattr(jax_main, "unet_256", lambda ngf=64, **kw:
                        jax_factory.unet_32(ngf=8, **kw))
    monkeypatch.setattr(jax_main, "patchgan", lambda input_nc, dtype:
                        jax_factory.patchgan(ndf=8, input_nc=input_nc,
                                             dtype=dtype))
    monkeypatch.setattr(jax_main, "_gan_transform", _crop(JT))
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **k: pmesh.Mesh(
        np.asarray(jax.devices()[:1]), ("data",)))
    # the JAX translator builds unet_256 of the checkpoint's width
    monkeypatch.setattr(jax_factory, "unet_256", lambda ngf=64, **kw:
                        jax_factory.unet_32(ngf=ngf, **kw))
    monkeypatch.setattr(main, "unet_256", lambda ngf=64, **kw:
                        factory.unet_32(ngf=8, **kw))
    monkeypatch.setattr(main, "patchgan", lambda input_nc:
                        factory.patchgan(ndf=8, input_nc=input_nc))
    monkeypatch.setattr(main, "_gan_transform", _crop(T))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tree, the two tiny module2 sem checkpoints (JAX msgpack) and
    the JAX start checkpoint of both GAN shapes."""
    root = tmp_path_factory.mktemp("gan_cli")
    tree = make_freiburg_tree(str(root / "freiburg"), n_train=5, n_test=1)
    for name, c, seed in (("sem_s.pth", 3, 0), ("sem_t.pth", 1, 1)):
        _, variables = jax_create_deeplab(jax.random.key(seed),
                                          num_classes=13, num_channels=c,
                                          layers=(1, 1, 1, 1))
        jax_common.save_seg_checkpoint(str(root / name), variables, epoch=0,
                                       layers=[1, 1, 1, 1], num_channels=c,
                                       num_classes=13)
    # the tiny legacy sem nets in the reference legacy layout: RGB as a
    # bare state_dict, thermal under sem_net_state_dict
    for name, c, seed in (("s", 3, 2), ("t", 1, 3)):
        sd = create_deeplab(seed, device="cpu", num_classes=19,
                            num_channels=c, head="legacy",
                            layers=(1, 1, 1, 1)).state_dict()
        torch.save(sd if name == "s" else {"sem_net_state_dict": sd},
                   str(root / f"legacy_{name}.pth"))
    nets = {"s2t": (jax_factory.unet_32(ngf=8, output_nc=1), 3),
            "t2s": (jax_factory.unet_32(ngf=8, output_nc=3), 1),
            "t": (jax_factory.patchgan(ndf=8), 1),
            "s": (jax_factory.patchgan(ndf=8), 3)}
    v = {k: jax.tree.map(np.asarray, jax_factory.init_gan_net(
        m, jax.random.key(10 + i), (1, *HW, c)))
        for i, (k, (m, c)) in enumerate(nets.items())}
    save_checkpoint(str(root / "start.pth"), {
        "epoch": 0, "g_vars": {k: v[k] for k in ("s2t", "t2s")},
        "d_vars": {k: v[k] for k in ("t", "s")}})
    return dict(root=str(root), tree=tree)


def _argv(world, ckpt_dir, new_name, *extra):
    os.makedirs(ckpt_dir, exist_ok=True)
    start = os.path.join(ckpt_dir, "start.pth")
    if not os.path.exists(start):
        os.link(os.path.join(world["root"], "start.pth"), start)
    return ["-source_dataset", "freiburg_rgb", "-target_dataset",
            "freiburg_ir", "-batch_size", "2", "-num_epoch", "1",
            "-max_steps", str(STEPS), "-lr", str(LR), "-load_model", "true",
            "-checkpoint_name", "start.pth", "-new_checkpoint_name", new_name,
            "-with_contour", "true", "-canny_rgb_threshold", "2.0",
            "-canny_thermal_threshold", "0.5", "-sem_loss", "true",
            "-sem_mode", "module2",
            "-sem_checkpoint_s", os.path.join(world["root"], "sem_s.pth"),
            "-sem_checkpoint_t", os.path.join(world["root"], "sem_t.pth"),
            "-host_pool", "true", "--freiburg_root", world["tree"],
            "--gan_model_root_path", ckpt_dir, *extra]


def _generator_out(sd, x, in_nc, out_nc):
    net = factory.unet_32(ngf=8, input_nc=in_nc, output_nc=out_nc)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()


def _jax_generator_out(variables, x, out_nc):
    model = jax_factory.unet_32(ngf=8, output_nc=out_nc)
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False))


@pytest.mark.parametrize("cycle", [True, False], ids=["main", "main_gan"])
def test_gan_cli_matches_jax_cli(world, narrow, tmp_path, cycle, capsys):
    _compare_gan_clis(world, tmp_path, cycle, capsys)


def _tiny_legacy(monkeypatch):
    """Both packages' legacy sem-net factories at layers 1,1,1,1 (the JAX
    factories hard-code ResNet-101)."""
    from thermal_semantic_segmentation_tpu.models.deeplab import DeepLabV2

    for name, c in (("deeplabv2_resnet101", 3),
                    ("deeplabv2_resnet101_thermal", 1)):
        monkeypatch.setattr(jax_main, name, lambda num_classes=19, c=c,
                            dtype=jnp.float32: DeepLabV2(
                                num_classes=num_classes, num_channels=c,
                                head="legacy", layers=(1, 1, 1, 1),
                                dtype=dtype))
        monkeypatch.setattr(main, name, lambda num_classes=19, c=c, seed=0,
                            device=None: create_deeplab(
                                seed, device=device, num_classes=num_classes,
                                num_channels=c, head="legacy",
                                layers=(1, 1, 1, 1)))


@pytest.mark.parametrize("cycle", [True, False], ids=["main", "main_gan"])
def test_gan_cli_legacy_sem_nets_match_jax_cli(world, narrow, monkeypatch,
                                               tmp_path, cycle, capsys):
    """The default -sem_mode legacy: both CLIs load the two tiny 19-class
    legacy sem nets from reference legacy .pth files (a bare state_dict
    and one under sem_net_state_dict) and train alike."""
    _tiny_legacy(monkeypatch)
    _compare_gan_clis(world, tmp_path, cycle, capsys, legacy=True)


def _compare_gan_clis(world, tmp_path, cycle, capsys, legacy=False):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")

    def argv(ckpt_dir, new_name, *extra):
        out = _argv(world, ckpt_dir, new_name, *extra)
        if legacy:
            out[out.index("-sem_mode") + 1] = "legacy"
            for flag in ("-sem_checkpoint_s", "-sem_checkpoint_t"):
                out[out.index(flag) + 1] = os.path.join(
                    world["root"], f"legacy_{flag[-1]}.pth")
        return out

    (jax_main if cycle else jax_main_gan).main(argv(jax_dir, "jax.pth"))
    state, history = (main if cycle else main_gan).main(
        argv(port_dir, "port.pth", "--device", "cpu"))
    out = capsys.readouterr().out
    if legacy:
        assert all(f"loaded frozen sem net '{n}' from " in out
                   for n in "st")
    assert [h["steps"] for h in history] == [STEPS]
    assert all(np.isfinite(v).all() for v in history[0]["metrics"].values())
    want_keys = {"g_s2t", "con_s2t", "sem_s2t", "loss_g", "d_t"}
    if cycle:
        want_keys |= {"g_t2s", "cycle_s", "cycle_t", "con_t2s", "sem_t2s",
                      "d_s"}
    assert set(history[0]["metrics"]) == want_keys

    got = _common.load_gan_checkpoint(os.path.join(port_dir, "port.pth"))
    jax_ckpt = jax_load_checkpoint(os.path.join(jax_dir, "jax.pth"))
    want = jax_gan_checkpoint_to_torch(jax_ckpt)
    names = [("s2t", "t2s"), ("t", "s")] if cycle else [("s2t",), ("t",)]
    keys = [key for group, which in zip(names, "gd")
            for name, key in GAN_KEYS[which] if name in group]
    assert sorted(k for k in got if k != "epoch") == sorted(keys)
    assert got["epoch"] == want["epoch"] == 0
    outside = total = 0
    worst = stats_err = 0.0
    for key in keys:
        for k, v in got[key].items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = np.abs(v.numpy() - want[key][k].numpy())
            if k.endswith(("running_mean", "running_var")):
                stats_err = max(stats_err, float(diff.max()))
                continue
            ratio = diff / (STEPS * LR)
            worst = max(worst, float(ratio.max()))
            outside += int((ratio > 1.0).sum())
            total += ratio.size
    x = np.random.default_rng(3).uniform(-1, 1, (2, *HW, 3)).astype(
        np.float32)
    port_out = _generator_out(got["net_g_s2t_state_dict"], x, 3, 1)
    jax_out = _generator_out(want["net_g_s2t_state_dict"], x, 3, 1)
    gap = np.abs(port_out - jax_out)
    print(f"cycle={cycle}: {outside} of {total} parameters outside the "
          f"{STEPS} x lr envelope (worst {worst:.3f} of it), BatchNorm "
          f"statistics max abs err {stats_err:.3g}; s2t outputs max abs gap "
          f"{gap.max():.3g}, max rel gap "
          f"{float((gap / np.abs(jax_out).clip(1e-6)).max()):.3g} "
          f"(outputs up to {np.abs(jax_out).max():.3g})")
    assert outside <= 5e-4 * total and worst <= 2.0
    assert stats_err <= STATS_ATOL
    np.testing.assert_allclose(port_out, jax_out, rtol=OUT_RTOL,
                               atol=OUT_RTOL * np.abs(jax_out).max())

    # each package's generator from the other's checkpoint
    jax_from_port = jax_main._load_gan_checkpoint(
        os.path.join(port_dir, "port.pth"))
    np.testing.assert_allclose(
        _jax_generator_out(jax_from_port["g_vars"]["s2t"], x, 1), port_out,
        rtol=0, atol=CROSS_ATOL)
    model, ngf = _common.build_generator_from_gan_checkpoint(
        os.path.join(jax_dir, "jax.pth"), "s2t", input_nc=3, output_nc=1,
        device="cpu")
    assert ngf == 8 and not model.training
    with torch.no_grad():
        port_from_jax = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(
        port_from_jax.permute(0, 2, 3, 1).numpy(),
        _jax_generator_out(jax_ckpt["g_vars"]["s2t"], x, 1), rtol=0,
        atol=CROSS_ATOL)


def test_gan_cli_resumes_its_own_checkpoint(world, narrow, tmp_path, capsys):
    """A run saves epoch 0; a resumed run (the device pool, the default)
    restarts at that epoch, as the reference does, and moves the
    weights; ``-save_interval`` skips an epoch but not the last."""
    ckpt_dir = str(tmp_path / "ckpt")
    argv = _argv(world, ckpt_dir, "g.pth")
    argv[argv.index("-host_pool") + 1] = "false"
    argv[argv.index("-num_epoch") + 1] = "2"
    main.main(argv + ["--device", "cpu", "-save_interval", "5"])
    path = os.path.join(ckpt_dir, "g.pth")
    first = _common.load_gan_checkpoint(path)
    assert first["epoch"] == 1          # the last epoch saves
    argv[argv.index("-checkpoint_name") + 1] = "g.pth"
    argv[argv.index("-num_epoch") + 1] = "1"
    _, history = main.main(argv + ["--device", "cpu"])
    assert [h["epoch"] for h in history] == [1]
    resumed = _common.load_gan_checkpoint(path)
    assert resumed["epoch"] == 1
    moved = [k for k, v in resumed["net_g_s2t_state_dict"].items()
             if not torch.equal(v, first["net_g_s2t_state_dict"][k])]
    assert moved
    capsys.readouterr()


def test_gan_cli_preempts_to_a_resumable_checkpoint(world, narrow, tmp_path,
                                                   monkeypatch, capsys):
    """A shutdown requested after the first step: the loop stops, writes
    ``preempt_g.pth`` with the epoch before the interrupted one, as the
    JAX CLI does, and not the epoch's own checkpoint; a resume from it
    starts at that saved epoch, -1, as every GAN resume starts at its
    checkpoint's epoch (ROADMAP.md §3)."""
    from tests.test_torch_preempt import StopAfter
    monkeypatch.setattr(main, "GracefulShutdown", StopAfter)
    ckpt_dir = str(tmp_path / "ckpt")
    argv = _argv(world, ckpt_dir, "g.pth") + ["--device", "cpu"]
    _, history = main.main(argv)
    assert [(h["epoch"], h["steps"], h["preempted"]) for h in history] == [
        (0, 1, True)]
    preempt = _common.load_gan_checkpoint(os.path.join(ckpt_dir,
                                                       "preempt_g.pth"))
    assert preempt["epoch"] == -1
    assert not os.path.exists(os.path.join(ckpt_dir, "g.pth"))
    monkeypatch.undo()
    narrow_again = argv.index("-checkpoint_name") + 1
    argv[narrow_again] = "preempt_g.pth"
    monkeypatch.setattr(main, "unet_256", lambda ngf=64, **kw:
                        factory.unet_32(ngf=8, **kw))
    monkeypatch.setattr(main, "patchgan", lambda input_nc:
                        factory.patchgan(ndf=8, input_nc=input_nc))
    monkeypatch.setattr(main, "_gan_transform", _crop(T))
    _, history = main.main(argv)
    assert [(h["epoch"], h["preempted"]) for h in history] == [(-1, False)]
    capsys.readouterr()


def test_translator_matches_jax_translator(world, narrow, tmp_path):
    """Both translators on one JAX msgpack checkpoint: the same files, the
    port's pixels within one grey level of the JAX translator's (PIL's
    BICUBIC resize against the port's two rounded passes); a tail batch of
    one frame runs at its own size."""
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    os.link(os.path.join(world["root"], "start.pth"),
            os.path.join(ckpt_dir, "g.pth"))
    out_dir = os.path.join(world["tree"], "translation", "seq_00_day", "00",
                           "fl_rgb")
    files = {}
    for name, run in (("jax", jax_translator.main), ("port", lambda a:
                      translator.main(a + ["--device", "cpu"]))):
        run(["-dataset", "freiburg_rgb", "-batch_size", "2",
             "-checkpoint_name", "g.pth", "-input_nc", "3", "-output_nc",
             "1", "-save_image_size", "40", "72", "-translation_name_suffix",
             name, "--freiburg_root", world["tree"],
             "--gan_model_root_path", ckpt_dir])
        files[name] = sorted(f for f in os.listdir(out_dir)
                             if f.endswith(f"_{name}.png"))
    assert files["jax"] == [f"{i:04d}_jax.png" for i in range(5)]
    assert [f.replace("_port", "_jax") for f in files["port"]] == files["jax"]
    worst = 0
    for f in files["jax"]:
        want = np.asarray(Image.open(os.path.join(out_dir, f)), np.int32)
        got = np.asarray(Image.open(os.path.join(
            out_dir, f.replace("_jax", "_port"))), np.int32)
        assert got.shape == want.shape == (40, 72)
        worst = max(worst, int(np.abs(got - want).max()))
    print(f"translator: port pixels at most {worst} grey levels from JAX's")
    assert worst <= 1


def test_legacy_sem_nets_load_from_each_source(world, monkeypatch, tmp_path,
                                              capsys):
    """``load_sem_nets`` in legacy mode: a resumed GAN checkpoint's
    ``net_seg_*`` dicts win over the flags; the flags read a reference
    legacy .pth (bare or under sem_net_state_dict) and the JAX package's
    msgpack ({'variables'} or bare); without either the nets are random
    from --seed. A JAX GAN checkpoint's ``sem_vars`` cross to the
    ``net_seg_*`` keys and back to the JAX package's converter exactly."""
    from thermal_semantic_segmentation_tpu.models.torch_convert import (
        torch_gan_checkpoint_to_flax)

    _tiny_legacy(monkeypatch)
    sds = {n: torch.load(os.path.join(world["root"], f"legacy_{n}.pth"))
           for n in "st"}
    sds["t"] = sds["t"]["sem_net_state_dict"]
    ref = {"epoch": 3, "net_seg_s_state_dict": sds["s"],
           "net_seg_t_state_dict": sds["t"]}
    jax_ckpt = torch_gan_checkpoint_to_flax(ref)
    assert set(jax_ckpt["sem_vars"]) == {"s", "t"}
    ported = jax_gan_checkpoint_to_torch(jax_ckpt)
    for n in "st":
        got = ported[f"net_seg_{n}_state_dict"]
        assert got.keys() == {k for k in sds[n]
                              if not k.endswith("num_batches_tracked")}
        for k, v in got.items():
            assert torch.equal(v, sds[n][k]), k
    save_checkpoint(str(tmp_path / "bare_t.msgpack"), jax_ckpt["sem_vars"]["t"])
    save_checkpoint(str(tmp_path / "vars_s.msgpack"),
                    {"variables": jax_ckpt["sem_vars"]["s"]})
    args = main.train_parse().parse_args([
        "-sem_loss", "true", "-sem_checkpoint_s",
        os.path.join(world["root"], "legacy_s.pth"),
        "-sem_checkpoint_t", os.path.join(world["root"], "legacy_t.pth")])

    def weights(nets):
        return {n: net.classifier.conv2d_list[0].weight.detach().clone()
                for n, net in nets.items()}

    from_flags = weights(main.load_sem_nets(args, "cpu"))
    for n in "st":
        assert torch.equal(from_flags[n],
                           sds[n]["classifier.conv2d_list.0.weight"])
    args.sem_checkpoint_s = str(tmp_path / "vars_s.msgpack")
    args.sem_checkpoint_t = str(tmp_path / "bare_t.msgpack")
    from_msgpack = main.load_sem_nets(args, "cpu")
    assert all(torch.equal(weights(from_msgpack)[n], from_flags[n])
               for n in "st")
    assert all(not p.requires_grad and not net.training
               for net in from_msgpack.values() for p in net.parameters())
    other = {f"net_seg_{n}_state_dict": create_deeplab(
        9, device="cpu", num_classes=19, num_channels=c, head="legacy",
        layers=(1, 1, 1, 1)).state_dict() for n, c in (("s", 3), ("t", 1))}
    resumed = weights(main.load_sem_nets(args, "cpu", {"epoch": 0, **other}))
    for n in "st":
        assert torch.equal(
            resumed[n],
            other[f"net_seg_{n}_state_dict"]["classifier.conv2d_list.0.weight"])
    args.sem_checkpoint_s = args.sem_checkpoint_t = ""
    random = weights(main.load_sem_nets(args, "cpu"))
    assert "random weights" in capsys.readouterr().out
    assert not torch.equal(random["t"], from_flags["t"])


@pytest.mark.parametrize("cycle", [True, False], ids=["main", "main_gan"])
def test_gan_cli_accepts_distributed(world, narrow, tmp_path, cycle,
                                     one_process_group, capsys):
    """``--distributed true`` as one gloo process, with the device pools:
    the plain run's metrics and checkpoint, bit for bit. (Two processes:
    tests/test_torch_dist_train.py.)"""
    run = main.main if cycle else main_gan.main
    out = {}
    for name, extra in (("one", []), ("dist", one_process_group)):
        argv = _argv(world, str(tmp_path / name), "g.pth")
        argv[argv.index("-host_pool") + 1] = "false"
        _, history = run(argv + ["--device", "cpu"] + extra)
        out[name] = (history[0]["metrics"], _common.load_gan_checkpoint(
            str(tmp_path / name / "g.pth")))
    assert out["dist"][0] == out["one"][0]
    for key, sd in out["one"][1].items():
        if key != "epoch":
            for k, v in sd.items():
                assert torch.equal(out["dist"][1][key][k], v), (key, k)
    capsys.readouterr()


@pytest.mark.parametrize("flag", ["distributed", "data_parallel"])
def test_translator_accepts_multi_device_flags(world, narrow, tmp_path,
                                               one_process_group,
                                               monkeypatch, flag):
    """``--distributed true`` as one gloo process (its slice is the whole
    set) and ``--data_parallel true`` over two CPU replicas (batches of 2
    and a tail of 1): the one-device translator's files, byte for byte."""
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    os.link(os.path.join(world["root"], "start.pth"),
            os.path.join(ckpt_dir, "g.pth"))
    out_dir = os.path.join(world["tree"], "translation", "seq_00_day", "00",
                           "fl_rgb")
    extra = (one_process_group if flag == "distributed"
             else ["--data_parallel", "true"])
    for suffix, more in ((f"one{flag}", []), (flag, extra)):
        summary = translator.main(
            ["-dataset", "freiburg_rgb", "-batch_size", "2",
             "-checkpoint_name", "g.pth", "-input_nc", "3", "-output_nc",
             "1", "-save_image_size", "40", "72", "-translation_name_suffix",
             suffix, "--freiburg_root", world["tree"],
             "--gan_model_root_path", ckpt_dir, "--device", "cpu", *more])
        assert summary["images"] == 5
    for i in range(5):
        with open(os.path.join(out_dir, f"{i:04d}_{flag}.png"), "rb") as f:
            got = f.read()
        with open(os.path.join(out_dir, f"{i:04d}_one{flag}.png"), "rb") as f:
            assert got == f.read(), i
