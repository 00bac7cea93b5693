"""The port's ``cli/export_torch.py`` against the JAX package's: from one JAX
msgpack checkpoint each, the seg and GAN ``.pth`` files hold the same keys
and equal tensors and numbers (exactly), and the port's own ``.pth`` exports
again to the same file contents."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_gan import jax_net  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    export_torch as jax_export_torch)
from thermal_semantic_segmentation_tpu.cli._common import (  # noqa: E402
    save_seg_checkpoint as jax_save_seg_checkpoint)
from thermal_semantic_segmentation_tpu.core.checkpoint import (  # noqa: E402
    save_checkpoint as jax_save_checkpoint)
from thermal_semantic_segmentation_torch.cli import export_torch  # noqa: E402


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _assert_same(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _assert_same(g, w, f"{where}{key}.")
        else:
            np.testing.assert_array_equal(
                np.asarray(g, dtype=np.float64), np.asarray(w, np.float64),
                err_msg=f"{where}{key}")


def test_seg_export_matches_jax(tmp_path):
    """A self-training checkpoint: epoch, val_loss, highest_mean_iu and the
    prototypes carried through with the weights."""
    _, variables, _ = jax_deeplab_with_twin(4)
    src = str(tmp_path / "s.msgpack")
    protos = np.random.default_rng(0).standard_normal((13, 256)).astype(
        np.float32)
    jax_save_seg_checkpoint(src, variables, epoch=5, val_loss=0.25,
                            highest_mean_iu=0.5, objective_vectors=protos,
                            layers=[1, 1, 1, 1], num_channels=1,
                            num_classes=13)
    jax_export_torch.main(["--kind", "seg", "--src", src, "--dst",
                           str(tmp_path / "jax.pth")])
    export_torch.main(["--kind", "seg", "--src", src, "--dst",
                       str(tmp_path / "port.pth")])
    want, got = _load(tmp_path / "jax.pth"), _load(tmp_path / "port.pth")
    assert {"epoch", "sem_net_state_dict", "val_loss", "highest_mean_iu",
            "objective_vectors"} <= set(want)
    _assert_same(got, want)
    # the port's own .pth exports to the same contents
    export_torch.main(["--kind", "seg", "--src", str(tmp_path / "port.pth"),
                       "--dst", str(tmp_path / "again.pth")])
    _assert_same(_load(tmp_path / "again.pth"), want)


def test_gan_export_matches_jax(tmp_path):
    _, g = jax_net("unet_256", 6, (1, 256, 512, 3), ngf=4, output_nc=1)
    _, d = jax_net("patchgan", 7, (1, 256, 512, 1), ndf=4)
    src = str(tmp_path / "g.msgpack")
    jax_save_checkpoint(src, {"epoch": 7,
                              "g_vars": jax.tree.map(np.asarray, {"s2t": g}),
                              "d_vars": jax.tree.map(np.asarray, {"t": d})})
    jax_export_torch.main(["--kind", "gan", "--src", src, "--dst",
                           str(tmp_path / "jax.pth")])
    export_torch.main(["--kind", "gan", "--src", src, "--dst",
                       str(tmp_path / "port.pth")])
    want, got = _load(tmp_path / "jax.pth"), _load(tmp_path / "port.pth")
    assert set(want) == {"epoch", "net_g_s2t_state_dict",
                         "net_d_t_state_dict"}
    _assert_same(got, want)
