"""The port's one-process data parallelism (``--data_parallel``:
parallel/mesh.LocalMesh, local_data_mesh, replicate, split_rows, and the
meshes of eval/validate.py, train/pseudo.py, train/prototypes.py, the
translator's batch loop, serving/batcher.py and data/device_pipeline.py)
against the JAX package's ``local_data_mesh`` over the 8 CPU devices that
tests/conftest.py makes, on the same seeded inputs and weights.

The port's mesh is two CPU replicas (``[cpu, cpu]``), or three that the
batch of 4 shrinks to two. Every batch divides over the JAX mesh, so
JAX's padded-tail fault (ROADMAP.md §3) stays out. Tolerances are the
one-device tests': mIoU and class IoUs 1e-6, val_loss rtol 1e-5
(tests/test_torch_eval.py); pseudo-label ids equal outside top-2
near-ties (gap < 1e-5), confidences within one float16 ulp, soft maps the
forward's 5e-4 (tests/test_torch_pseudo.py); prototypes 5e-4, counts
exact (tests/test_torch_prototypes.py); translated frames within one grey
level of the JAX translator's (tests/test_torch_gan_cli.py); served ids
equal outside near-ties (tests/test_torch_serve.py).
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_deeplab import HW, jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_pseudo import (  # noqa: E402
    assert_pseudo_dirs_match, decided_pixels)
from thermal_semantic_segmentation_tpu.eval.validate import (  # noqa: E402
    seg_validate as jax_seg_validate)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    upsample_logits as jax_upsample_logits)
from thermal_semantic_segmentation_tpu.parallel import (  # noqa: E402
    mesh as jax_mesh)
from thermal_semantic_segmentation_tpu.serving import (  # noqa: E402
    batcher as jax_batcher)
from thermal_semantic_segmentation_tpu.train.prototypes import (  # noqa: E402
    calc_prototypes as jax_calc_prototypes)
from thermal_semantic_segmentation_tpu.train.pseudo import (  # noqa: E402
    generate_pseudo_labels as jax_generate)
from thermal_semantic_segmentation_torch.data.device_pipeline import (  # noqa: E402,E501
    device_prefetch)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.parallel import mesh  # noqa: E402
from thermal_semantic_segmentation_torch.serving import batcher  # noqa: E402
from thermal_semantic_segmentation_torch.train.prototypes import (  # noqa: E402
    calc_prototypes)
from thermal_semantic_segmentation_torch.train.pseudo import (  # noqa: E402
    generate_pseudo_labels)

C, IGNORE = 13, 12
BATCH, N_BATCHES = 4, 2
TIE_GAP = 1e-5
CPU = torch.device("cpu")
MESHES = {"two": [CPU] * 2, "three_shrunk": [CPU] * 3}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    return jax_deeplab_with_twin(31)


@pytest.fixture(scope="module")
def jax_local():
    """JAX ``local_data_mesh`` for the batch: 4 of the 8 CPU devices."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_mesh.local_data_mesh(batch_size=BATCH)


def port_mesh(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mesh.local_data_mesh(batch_size=BATCH, devices=MESHES[name])


class Loader:
    """``N_BATCHES`` seeded batches of ``BATCH`` images, labels (5%
    ignored) and paths; each iteration is one epoch."""

    def __len__(self):
        return N_BATCHES

    def __iter__(self):
        rng = np.random.default_rng(32)
        for i in range(N_BATCHES):
            label = rng.integers(0, C, (BATCH, *HW))
            label[rng.random(label.shape) < 0.05] = 255
            yield {"image": rng.uniform(0, 1, (BATCH, *HW, 1)).astype(
                       np.float32), "label": label,
                   "img_path": [f"dir/im_{i}_{k}.png" for k in range(BATCH)]}


@pytest.mark.parametrize("n,batch", [(3, 4), (8, 4), (8, 6), (8, 16),
                                     (2, 5)])
def test_local_mesh_shrinks_as_jax_make_mesh(n, batch):
    """The device count kept and the warning given, as JAX ``make_mesh``
    over ``n`` devices."""
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jax_mesh.make_mesh(jax.devices()[:n], batch_size=batch)
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = mesh.local_data_mesh(batch_size=batch, devices=[CPU] * n)
    assert got.size == want.size
    assert [str(w.message) for w in got_w] == [str(w.message)
                                               for w in want_w]


@pytest.mark.parametrize("n", [1, 4, 5, 7])
def test_split_rows_partitions_in_row_order(n):
    """Contiguous shares in row order, equal where the mesh divides the
    batch, at most one row apart otherwise; device_prefetch sends each
    replica its share."""
    two = mesh.LocalMesh((CPU, CPU))
    rows = mesh.split_rows(two, n)
    got = [i for r in rows for i in range(n)[r]]
    assert got == list(range(n))
    sizes = [r.stop - r.start for r in rows]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]
    batch = {"x": np.arange(n * 3).reshape(n, 3), "name": "b"}
    (out,) = device_prefetch([batch], "cpu", mesh=two)
    assert out["name"] == "b" and len(out["x"]) == 2
    np.testing.assert_array_equal(torch.cat(out["x"]).numpy(), batch["x"])


def test_replicate_makes_one_copy_per_device(tiny):
    """Entries on the model's device share the model; another device
    (here ``meta``) gets one deep copy, shared by its entries."""
    _, _, twin = tiny
    meta = torch.device("meta")
    copies = mesh.replicate(mesh.LocalMesh((CPU, meta, CPU, meta)), twin)
    assert copies[0] is copies[2] is twin
    assert copies[1] is copies[3] and copies[1] is not twin
    assert copies[1].training == twin.training
    assert all(p.device == meta for p in copies[1].parameters())
    assert [k for k in copies[1].state_dict()] == list(twin.state_dict())


@pytest.mark.parametrize("name", list(MESHES))
def test_validate_matches_jax_local_mesh(tiny, jax_local, name):
    model, variables, twin = tiny
    want = jax_seg_validate(model, jax_mesh.replicate(jax_local, variables),
                            Loader(), num_classes=C, ignore_index=IGNORE,
                            label_hw=HW, pad_to_batch=BATCH, mesh=jax_local)
    m = port_mesh(name)
    assert m.size == 2
    got = seg_validate(twin.eval(), Loader(), num_classes=C,
                       ignore_index=IGNORE, device="cpu", mesh=m)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    np.testing.assert_allclose(list(got[2].values()), list(want[2].values()),
                               rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_pseudo_labels_match_jax_local_mesh(tiny, jax_local, tmp_path, mode):
    model, variables, twin = tiny
    soft = mode == "soft"
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    n_jax = jax_generate(model, jax_mesh.replicate(jax_local, variables),
                         Loader(), save_path=str(jax_dir), soft=soft,
                         pad_to_batch=BATCH, mesh=jax_local)
    n_port = generate_pseudo_labels(twin, Loader(), save_path=str(port_dir),
                                    soft=soft, device="cpu",
                                    mesh=port_mesh("two"))
    assert n_jax == n_port == BATCH * N_BATCHES
    decided = decided_pixels(model, variables, Loader(), False)
    assert_pseudo_dirs_match(port_dir, jax_dir, decided, soft)


def test_prototypes_match_jax_local_mesh(tiny, jax_local):
    model, variables, twin = tiny
    want_p, want_n = jax_calc_prototypes(
        model, jax_mesh.replicate(jax_local, variables), Loader(),
        num_classes=C, mesh=jax_local)
    got_p, got_n = calc_prototypes(twin, Loader(), num_classes=C,
                                   device="cpu", mesh=port_mesh("two"))
    np.testing.assert_array_equal(got_n, np.asarray(want_n))
    assert got_n.sum() > 0
    np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=0, atol=5e-4)


def test_batcher_matches_jax_local_mesh(tiny, jax_local):
    """One coalesced batch of 4 over the meshes: the ids of both servers'
    ``_predict``, equal outside near-ties."""
    model, variables, twin = tiny
    x = np.random.default_rng(33).uniform(0, 1, (BATCH, *HW, 1)).astype(
        np.float32)
    jax_srv = jax_batcher.InferenceServer(model, variables, batch_size=BATCH,
                                          label_hw=HW, mesh=jax_local)
    want = np.asarray(jax_srv._predict(jax_srv._variables, jnp.asarray(x)))
    port_srv = batcher.InferenceServer(twin, batch_size=BATCH, label_hw=HW,
                                       device="cpu", mesh=port_mesh("two"))
    got = port_srv._predict(x)
    up = np.asarray(jax_upsample_logits(
        model.apply(variables, jnp.asarray(x), train=False)["out"], *HW))
    top2 = np.sort(up, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] >= TIE_GAP
    assert decided.mean() > 0.99 and got.shape == want.shape
    np.testing.assert_array_equal(got[decided], want[decided])


def test_translator_matches_jax_local_mesh(tmp_path, monkeypatch):
    """Both translator CLIs with ``--data_parallel true`` on one JAX
    msgpack checkpoint (unet_32 ngf 8) and 5 frames at batch 2 (JAX pads
    its tail of 1; the port splits it 1 + 0): the same files, within one
    grey level."""
    from PIL import Image

    from tests.synthetic import make_freiburg_tree
    from thermal_semantic_segmentation_tpu.cli import (
        translator as jax_translator)
    from thermal_semantic_segmentation_tpu.core.checkpoint import (
        save_checkpoint)
    from thermal_semantic_segmentation_tpu.models import (
        factory as jax_factory)
    from thermal_semantic_segmentation_torch.cli import translator

    tree = make_freiburg_tree(str(tmp_path / "freiburg"), n_train=5,
                              n_test=0)
    net = jax_factory.unet_32(ngf=8, output_nc=1)
    save_checkpoint(str(tmp_path / "g.pth"), {
        "epoch": 0, "g_vars": {"s2t": jax.tree.map(
            np.asarray, jax_factory.init_gan_net(net, jax.random.key(3),
                                                 (1, 32, 64, 3)))},
        "d_vars": {}})
    monkeypatch.setattr(jax_factory, "unet_256", lambda ngf=64, **kw:
                        jax_factory.unet_32(ngf=ngf, **kw))
    monkeypatch.setattr(mesh, "default_devices", lambda: [CPU, CPU])
    out_dir = os.path.join(tree, "translation", "seq_00_day", "00", "fl_rgb")
    for name, run in (("jax", jax_translator.main), ("port", lambda a:
                      translator.main(a + ["--device", "cpu"]))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run(["-dataset", "freiburg_rgb", "-batch_size", "2",
                 "-checkpoint_name", "g.pth", "-input_nc", "3",
                 "-output_nc", "1", "-save_image_size", "40", "72",
                 "-translation_name_suffix", name, "--freiburg_root", tree,
                 "--gan_model_root_path", str(tmp_path), "--data_parallel",
                 "true"])
    worst = 0
    for i in range(5):
        want = np.asarray(Image.open(os.path.join(out_dir,
                                                  f"{i:04d}_jax.png")),
                          np.int32)
        got = np.asarray(Image.open(os.path.join(out_dir,
                                                 f"{i:04d}_port.png")),
                         np.int32)
        assert got.shape == want.shape == (40, 72)
        worst = max(worst, int(np.abs(got - want).max()))
    print(f"translator: port pixels at most {worst} grey levels from JAX's")
    assert worst <= 1
