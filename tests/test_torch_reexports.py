"""The port's subpackages re-export the JAX subpackages' public names.

Each case compares a port subpackage's ``__all__`` with the JAX one's,
under the port's renames (a subpackage's ``RENAMED``), less the names the
port documents as having no counterpart (its ``LEFT_OUT``, each with its
reason), and imports every name. The data package imports without PIL,
and the one PIL read the port keeps (a JPEG, ``data/image.read_image``)
decodes a truncated file as the JAX package does
(``ImageFile.LOAD_TRUNCATED_IMAGES``, set by the JAX ``data/__init__``).
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from PIL import Image  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["data", "eval", "models", "nn", "ops", "parallel", "serving",
               "train", "utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_the_jax_names(sub):
    jax_mod = importlib.import_module(f"thermal_semantic_segmentation_tpu.{sub}")
    port = importlib.import_module(f"thermal_semantic_segmentation_torch.{sub}")
    renamed = getattr(port, "RENAMED", {})
    left_out = getattr(port, "LEFT_OUT", {})
    assert set(left_out) <= set(jax_mod.__all__), sorted(left_out)
    assert all(isinstance(r, str) and r for r in left_out.values())
    assert set(renamed) <= set(jax_mod.__all__) - set(left_out)
    want = [renamed.get(n, n) for n in jax_mod.__all__ if n not in left_out]
    assert sorted(port.__all__) == sorted(want)
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    # a star import gives exactly the listed names
    space = {}
    exec(f"from thermal_semantic_segmentation_torch.{sub} import *", space)
    assert set(space) - {"__builtins__"} == set(port.__all__)


def _child(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_data_package_imports_without_pil():
    proc = _child(
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "from thermal_semantic_segmentation_torch.data import Freiburg, "
        "DataLoader, SelfTrainAugment\n"
        "import thermal_semantic_segmentation_torch.data as d\n"
        "missing = [n for n in d.__all__ if getattr(d, n, None) is None]\n"
        "built = [line for line in open('/proc/self/maps') "
        "if '_build/lib' in line]\n"
        "print(Freiburg.__name__, missing, built)\n"
        "sys.exit(1 if missing or built else 0)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("Freiburg [] []"), proc.stdout


def test_truncated_jpeg_decodes_as_the_jax_package(tmp_path):
    """A JPEG cut short: the port's read (in a fresh process, before any
    other code has set PIL's flag) equals the JAX package's PIL read with
    ``LOAD_TRUNCATED_IMAGES``; without the flag PIL refuses the file."""
    rng = np.random.default_rng(4)
    pixels = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    full = tmp_path / "full.jpg"
    Image.fromarray(pixels).save(full, quality=90)
    cut = tmp_path / "cut.jpg"
    data = full.read_bytes()
    cut.write_bytes(data[:len(data) * 2 // 3])
    out = tmp_path / "arrays.npz"
    proc = _child(
        "import numpy as np\n"
        "from PIL import Image, ImageFile\n"
        "assert not ImageFile.LOAD_TRUNCATED_IMAGES\n"
        "try:\n"
        f"    Image.open({str(cut)!r}).convert('RGB')\n"
        "    refused = False\n"
        "except OSError:\n"
        "    refused = True\n"
        "from thermal_semantic_segmentation_torch.data import image\n"
        f"port = image.open_image({str(cut)!r}, 'RGB')\n"
        f"port_l = image.open_image({str(cut)!r}, 'L')\n"
        "import thermal_semantic_segmentation_tpu.data  # sets the flag\n"
        f"jax = np.asarray(Image.open({str(cut)!r}).convert('RGB'))\n"
        f"jax_l = np.asarray(Image.open({str(cut)!r}).convert('L'))\n"
        f"np.savez({str(out)!r}, port=port, jax=jax, port_l=port_l, "
        "jax_l=jax_l, refused=refused)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(out)
    assert bool(got["refused"])
    assert got["port"].shape == (64, 96, 3)
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port_l"], got["jax_l"])
    # the decoded part is the image, the rest PIL's fill
    assert not np.array_equal(got["port"], np.asarray(
        Image.open(full).convert("RGB")))
