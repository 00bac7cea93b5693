"""The port's accuracy-gate runner (``recipes/gates.py``) and its trees
(``recipes/synthetic_trees.py``) against the JAX repo's (``bench_all.py``,
``tests/synthetic.py``), on the CPU at small sizes.

- the tree makers write the same files as ``tests/synthetic.py``, whose
  pixels decode equal (PIL reads both);
- ``run_stage_once``, ``gan_checkpoint_trained``, ``ensure_tree`` and the
  mIoU parse behave as ``bench_all.py``'s on the same inputs;
- ``per_class_fidelity`` equals ``bench_all._per_class_fidelity`` on the
  same files (identity and permuted translations, and translations at
  another size: the resize branch, the port's BILINEAR against PIL's);
- the gate's measuring chain (``translator`` -> ``distance_evaluate`` ->
  ``per_class_fidelity``) through both packages from one generator
  (unet_32 at ngf 8, as tests/test_torch_gan_cli.py narrows both): L1,
  SSIM and each class's L1 within 2e-3 (the translated PNGs are 8-bit and
  may round one level apart), the slot maps equal;
- the ``--smoke --device cpu`` chain of both gates runs, every stage's
  outputs in place and the final mIoU the eval CLI's (the CLIs' crops,
  nets and frames shrunk as the CLI tests shrink them, one step a
  training stage, the smoke tree at 64x192);
- with no card and no ``--device cpu`` the runner runs nothing.
"""

import glob
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

import bench_all  # noqa: E402
import jax  # noqa: E402
from recipes.assert_miou import parse_miou as jax_parse_miou  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_gan_cli import _crop, narrow  # noqa: E402,F401
from tests.test_torch_pseudo_proto_cli import _tiny  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    distance_evaluate as jax_distance, translator as jax_translator)
from thermal_semantic_segmentation_tpu.models import (  # noqa: E402
    factory as jax_factory)
from thermal_semantic_segmentation_tpu.core.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, cal_prototype, distance_evaluate, generate_pseudo_label, main,
    segmentation_evaluate, segmentation_train, self_train_main, translator)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    freiburg, transforms as T)
from thermal_semantic_segmentation_torch.data.cache import (  # noqa: E402
    decode_cache)
from thermal_semantic_segmentation_torch.models import factory  # noqa: E402
from thermal_semantic_segmentation_torch.models.convert import (  # noqa: E402
    jax_gan_checkpoint_to_torch)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)
from thermal_semantic_segmentation_torch.recipes import (  # noqa: E402
    gates, synthetic_trees)
from thermal_semantic_segmentation_torch.recipes.assert_miou import (  # noqa: E402,E501
    parse_miou)

CHAIN_ATOL = 2e-3
SMALL_HW = (64, 192)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*.*"), recursive=True))


MAKERS = {"make_learnable_freiburg_tree": dict(n_train=3, n_test=2, seed=3),
          "make_selftrain_freiburg_tree": dict(n_train=3, n_test=2, seed=3),
          "make_gan_freiburg_tree": dict(n_train=4, n_test=2, seed=5)}


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_tree_makers_match_jax(maker, tmp_path):
    kwargs = dict(MAKERS[maker], hw=SMALL_HW)
    jax_root = getattr(synthetic, maker)(str(tmp_path / "jax"), **kwargs)
    port_root = getattr(synthetic_trees, maker)(str(tmp_path / "port"),
                                                **kwargs)
    names = _files(jax_root)
    assert names == _files(port_root) and len(names) > 8
    for rel in names:
        a, b = os.path.join(jax_root, rel), os.path.join(port_root, rel)
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
            continue
        with Image.open(a) as x, Image.open(b) as y:
            assert x.mode == y.mode, rel
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_run_stage_once_matches_bench_all(tmp_path):
    for name, run in (("jax", bench_all._run_stage_once),
                      ("port", gates.run_stage_once)):
        calls = []
        base = str(tmp_path / f"{name}.pth")
        run(base, lambda: calls.append(1))
        run(base, lambda: calls.append(2))       # the marker: skipped
        crash = str(tmp_path / f"{name}_crash.pth")
        with pytest.raises(RuntimeError):
            run(crash, lambda: (_ for _ in ()).throw(RuntimeError()))
        assert not os.path.exists(crash + ".done")
        run(crash, lambda: calls.append(3))      # no marker: runs again
        assert calls == [1, 3], name


def test_gan_checkpoint_trained_matches_bench_all(tmp_path):
    path = str(tmp_path / "g.pth")
    cases = []

    def both(min_epoch=5):
        cases.append((bench_all._gan_checkpoint_trained(path, min_epoch),
                      gates.gan_checkpoint_trained(path, min_epoch)))

    both()                                        # absent
    for epoch, min_epoch in ((0, 5), (4, 5), (5, 5), (19, 19)):
        jax_save_checkpoint(path, {"epoch": epoch, "g_vars": {}})
        both(min_epoch)
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    both()
    assert [j for j, _ in cases] == [False, False, False, True, True, False]
    assert [p for _, p in cases] == [j for j, _ in cases]
    # the port's own .pth: the last 0-based epoch, 19 after 20 epochs
    net = factory.unet_32(ngf=4, output_nc=1)
    _common.save_gan_checkpoint(path, {"s2t": net}, {}, epoch=19)
    assert gates.gan_checkpoint_trained(path, 19)
    assert not gates.gan_checkpoint_trained(path, 20)


def test_ensure_tree_reuses_regenerates_and_invalidates(tmp_path):
    kwargs = dict(n_train=2, n_test=1, seed=3, hw=(32, 96))
    results = {}
    for name, ensure, maker in (
            ("jax", bench_all.ensure_tree, synthetic.make_gan_freiburg_tree),
            ("port", gates.ensure_tree,
             synthetic_trees.make_gan_freiburg_tree)):
        base = tmp_path / name
        root = str(base / "tree")
        ensure(root, maker, **kwargs)
        manifest = os.path.join(root, "_tree_manifest.json")
        with open(manifest) as f:
            first = json.load(f)
        mtime = os.path.getmtime(manifest)
        ensure(root, maker, **kwargs)             # same args: reused
        reused = os.path.getmtime(manifest) == mtime
        stale = [str(base / "ckpt"), str(base / "baseline.json")]
        os.makedirs(stale[0])
        open(os.path.join(stale[0], "old.pth"), "w").close()
        open(stale[1], "w").close()
        ensure(root, maker, invalidate=stale, **dict(kwargs, n_train=3))
        frames = os.listdir(os.path.join(root, "train", "seq_00_day", "00",
                                         "fl_rgb"))
        results[name] = (first["maker"], first["kwargs"], reused,
                         [os.path.exists(p) for p in stale], len(frames))
    assert results["port"] == results["jax"]
    assert results["port"][2:] == (True, [False, False], 3)
    with open(synthetic_trees.__file__, "rb") as f:
        src = f.read()
    want = hashlib.sha256(repr((
        "make_gan_freiburg_tree", sorted(kwargs.items()))).encode()
        + src).hexdigest()[:16]
    assert gates.tree_fingerprint(synthetic_trees.make_gan_freiburg_tree,
                                  kwargs) == want


def test_evaluate_miou_parses_as_bench_all():
    for text in ("target set class IoU road: 0.9\nmean iou score: 0.8125\n",
                 "checkpoint name: s.pth\nmean iou score: "
                 "[0.6012345678901234]. val_loss: [0.25]\n",
                 "mean iou score: [1e-05]."):
        assert parse_miou(text) == jax_parse_miou(text)
    with pytest.raises(ValueError):
        parse_miou("no score here")


def _write_translations(root, permute=None, hw=None):
    """Translations made from the real IR (tests/test_gate_helpers.py's
    construction), the band slots optionally permuted, optionally saved at
    ``hw`` instead of the crop window's size."""
    base = os.path.join(root, "train", "seq_00_day", "00")
    t_dir = os.path.join(root, "translation", "seq_00_day", "00", "fl_rgb")
    os.makedirs(t_dir, exist_ok=True)
    for name in sorted(os.listdir(os.path.join(base, "fl_ir_aligned"))):
        ir = np.asarray(Image.open(
            os.path.join(base, "fl_ir_aligned", name)), np.float32)
        ir01 = (np.clip(ir, 21800.0, 25000.0) - 21800.0) / 3200.0
        if permute is not None:
            n = len(permute)
            slot = np.clip(np.floor(ir01 * n), 0, n - 1).astype(np.int64)
            frac = np.clip(ir01 * n - slot, 0, 1)
            ir01 = (np.asarray(permute, np.float32)[slot] + frac) / n
        h, w = ir01.shape
        c0, c1 = round(w * 150 / 960), round(w * 850 / 960)
        out = Image.fromarray((ir01[:, c0:c1] * 255).astype(np.uint8))
        if hw is not None:
            out = out.resize((hw[1], hw[0]), Image.BICUBIC)
        out.save(os.path.join(t_dir, name))


@pytest.mark.parametrize("permute,hw", [
    (None, None), ([1, 0, 2, 3, 4], None), (None, (80, 175)),
    ([0, 1, 4, 3, 2], (120, 300))],
    ids=["identity", "permuted", "resized", "permuted_resized"])
def test_per_class_fidelity_matches_bench_all(tmp_path, permute, hw):
    root = synthetic.make_gan_freiburg_tree(str(tmp_path / "tree"),
                                            n_train=3, seed=7, hw=SMALL_HW)
    _write_translations(root, permute, hw)
    want_l1, want_slots = bench_all._per_class_fidelity(root)
    got_l1, got_slots = gates.per_class_fidelity(root)
    assert got_slots == want_slots
    np.testing.assert_allclose(got_l1, want_l1, rtol=0, atol=1e-6)
    if permute is None:
        assert got_slots == [0, 1, 2, 3, 4]
    else:
        assert got_slots == permute


def test_measuring_chain_matches_jax(narrow, tmp_path):  # noqa: F811
    """translator -> distance_evaluate -> per_class_fidelity through both
    packages, from one JAX s2t generator (unet_32, ngf 8, in a JAX msgpack
    GAN checkpoint as tests/test_torch_gan_cli.py's ``world`` makes it)
    and its conversion by the port's converter."""
    jax_root = synthetic.make_gan_freiburg_tree(
        str(tmp_path / "jax" / "freiburg"), n_train=10, seed=9, hw=SMALL_HW)
    port_root = str(tmp_path / "port" / "freiburg")
    shutil.copytree(jax_root, port_root)
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    g_vars = jax.tree.map(np.asarray, jax_factory.init_gan_net(
        jax_factory.unet_32(ngf=8, output_nc=1), jax.random.key(10),
        (1, 32, 64, 3)))
    jax_save_checkpoint(os.path.join(ckpt, "start.pth"),
                        {"epoch": 0, "g_vars": {"s2t": g_vars}})
    converted = jax_gan_checkpoint_to_torch(jax_load_checkpoint(
        os.path.join(ckpt, "start.pth")))
    torch.save(converted, os.path.join(ckpt, "start_port.pth"))
    flags = ["-dataset", "freiburg_rgb", "-batch_size", "8", "-input_nc",
             "3", "-output_nc", "1", "-save_image_size", "320", "700",
             "-translation_name_suffix", "", "--gan_model_root_path", ckpt]
    jax_translator.main([*flags, "-checkpoint_name", "start.pth",
                         "--freiburg_root", jax_root])
    translator.main([*flags, "-checkpoint_name", "start_port.pth",
                     "--freiburg_root", port_root, "--device", "cpu"])
    dist = ["-checkpoint_name", "translation.pth", "-batch_size", "8"]
    jax_l1, jax_ssim = jax_distance.main([*dist, "--freiburg_root",
                                          jax_root])
    l1, ssim = distance_evaluate.main([*dist, "--freiburg_root", port_root,
                                       "--device", "cpu"])
    jax_cls, jax_slots = bench_all._per_class_fidelity(jax_root)
    cls, slots = gates.per_class_fidelity(port_root)
    print(f"L1 {l1} / {jax_l1}, SSIM {ssim} / {jax_ssim}, per class "
          f"{cls} / {jax_cls}, slots {slots} / {jax_slots}")
    assert abs(float(l1) - float(jax_l1)) <= CHAIN_ATOL
    assert abs(float(ssim) - float(jax_ssim)) <= CHAIN_ATOL
    np.testing.assert_allclose(cls, jax_cls, rtol=0, atol=CHAIN_ATOL)
    assert slots == jax_slots


def _small_val():
    return T.Compose([T.Resize((64, 32)), T.ToArray()])


def _small_train():
    return T.Compose([
        T.RandomResizedCrop(size=(32, 64), ratio=(1.5, 8 / 3.),
                            scale=(0.5, 1.0)),
        T.RandomHorizontalFlip(), T.ToArray()])


@pytest.fixture
def tiny_clis(monkeypatch):
    """The CLIs' crops and resizes shrunk to 32x64, the prototypes' to
    64x128, the GAN's nets narrowed to unet_32 and a PatchGAN at ndf 8,
    the self-training augmentation at 64 / 64x32 and its full frames at
    40x88, one step a training stage, and the smoke tree at 64x192: the
    chain's wiring at CPU cost."""
    for module in (segmentation_train, self_train_main):
        monkeypatch.setattr(module, "train_transform", _small_train)
    for module in (segmentation_train, segmentation_evaluate,
                   generate_pseudo_label, self_train_main):
        monkeypatch.setattr(module, "val_transform", _small_val)
    monkeypatch.setattr(cal_prototype, "T", _tiny(T))
    monkeypatch.setattr(main, "_gan_transform", _crop(T))
    monkeypatch.setattr(main, "unet_256", lambda ngf=64, **kw:
                        factory.unet_32(ngf=8, **kw))
    monkeypatch.setattr(main, "patchgan", lambda input_nc:
                        factory.patchgan(ndf=8, input_nc=input_nc))
    # the frames the earlier stages decoded at 320x700 dropped from the
    # cache, so the teacher's full frames are decoded at the smaller size
    inner_st = self_train_main.main

    def small_frames(argv=None):
        decode_cache().clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(freiburg, "RAW_SIZE", (120, 40))
            mp.setattr(freiburg, "COL_CROP", (19, 106))
            return inner_st(argv)
    monkeypatch.setattr(self_train_main, "main", small_frames)
    parse = self_train_main.self_train_parse

    def small_aug():
        parser = parse()
        parser.set_defaults(resize=64, rcrop=[64, 32])
        return parser
    monkeypatch.setattr(self_train_main, "self_train_parse", small_aug)

    def small_tree(root, **kwargs):
        return synthetic_trees.make_gan_freiburg_tree(root, hw=SMALL_HW,
                                                      **kwargs)
    small_tree.__name__ = "make_gan_freiburg_tree"
    monkeypatch.setattr(gates, "make_gan_freiburg_tree", small_tree)
    monkeypatch.setattr(gates, "SMOKE_STEPS", ["-max_steps", "1"])


def test_smoke_chain_of_both_gates(tiny_clis, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(gates, "REPO", str(tmp_path))
    work = str(tmp_path / "gate")
    gates.main(["gan", "--smoke", "--device", "cpu", "--workdir", work])
    gates.main(["pipeline", "--smoke", "--device", "cpu", "--workdir",
                work])
    out = capsys.readouterr().out
    stages = [json.loads(line)["stage"] for line in out.splitlines()
              if line.startswith('{"stage"')]
    assert stages == [
        "sem_s_pretrain", "sem_t_pretrain", "gan_baseline",
        "translate_baseline", "distance_baseline", "baseline", "gan_train",
        "gan_oneway", "translate_trained", "distance_trained", "fidelity",
        "sem_s_pretrain", "sem_t_pretrain", "translation_fidelity",
        "seg_on_translations", "seg_eval", "pseudo_soft", "pseudo_hard",
        "prototypes", "self_train", "final_eval"], stages
    smoke = work + "_smoke"
    tree = os.path.join(smoke, "datasets", "freiburg")
    frames = 16
    assert len(glob.glob(os.path.join(
        tree, "translation", "seq_00_day", "00", "fl_rgb", "*.png"))) == \
        frames
    labels = os.path.join(smoke, "pseudo_labels")
    for pattern, n in (("soft/pipeline_seg/*.npy", frames),
                       ("hard/pipeline_seg/*_color.png", frames),
                       ("hard/pipeline_seg/*_conf.npy", frames),
                       ("hard/pipeline_seg/*.png", 2 * frames)):
        assert len(glob.glob(os.path.join(labels, pattern))) == n, pattern
    protos = jax_load_checkpoint(os.path.join(
        smoke, "prototypes", "prototypes_on_freiburg_ir_from_pipeline_seg"))
    assert np.asarray(protos["objective_vectors"]).shape == (13, 256)
    ckpt = os.path.join(smoke, "ckpt")
    for name in ("g_gate_base.pth", "g_gate.pth", "g_oneway.pth"):
        _common.load_gan_checkpoint(os.path.join(ckpt, name))
    for name in ("sem_s.pth", "sem_t.pth", "pipeline_seg.pth",
                 "bestpipeline_st.pth", "lastpipeline_st.pth"):
        _common.load_seg_checkpoint(os.path.join(ckpt, name))
    # the stages' mIoU is the eval CLI's own, parsed from its output
    final = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"stage": "final_eval"')][0]
    cli_iu = segmentation_evaluate.main([
        "-dataset", "freiburg_ir", "--freiburg_root", tree,
        "-checkpoint_name", "bestpipeline_st.pth", "--model_root_path", ckpt,
        "-val_batch_size", "8", "--device", "cpu"])[0]
    assert final["miou"] == round(float(cli_iu), 4)
    # a smoke run writes no gate JSON
    assert not glob.glob(str(tmp_path / "*GATE_TORCH.json"))


@pytest.mark.parametrize("gate", ["gan", "pipeline", "selftrain",
                                  "convergence"])
def test_gate_refuses_to_run_without_a_card(gate, tmp_path, monkeypatch):
    """No card and no ``--device cpu``: the runner stops before any stage
    (no tree, no CPU run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        gates.main([gate, "--workdir", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "w")
