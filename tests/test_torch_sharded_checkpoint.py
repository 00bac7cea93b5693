"""The port's sharded checkpoints (core/checkpoint.py ``save_sharded``,
``abstract_like``, ``load_sharded`` on ``torch.distributed.checkpoint`` and
``DTensor``) against the JAX package's orbax ones: the cases of JAX
tests/test_checkpoint.py::test_sharded_checkpoint_roundtrip (a leaf sharded
over the batch axis, a replicated leaf, an int32 step; the reload
replicated), in one process without a process group and on two gloo
ranks.

The worker is this file run as a script: ``python
tests/test_torch_sharded_checkpoint.py <rank> <world> <port> <out>``. It
joins a gloo group of two, saves the tree with ``w`` ``Shard(0)`` over a
``DeviceMesh`` of both ranks, loads it back into its own placements and
into ``Replicate()``, and writes what it read to ``<out>``; it imports no
JAX. One run of the workers serves every test of the file. Values are
compared exactly: a checkpoint moves bytes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

WORLD = 2
RUN_TIMEOUT = 240
W_SHAPE = (8, 64)              # rows 0-3 on rank 0, 4-7 on rank 1


def full_tree():
    """The JAX test's tree as numpy: w (arange, float32), mu (ones) and an
    int32 step of 7."""
    return {"params": {"w": np.arange(np.prod(W_SHAPE), dtype=np.float32
                                      ).reshape(W_SHAPE)},
            "opt": {"mu": np.ones((3, 3), np.float32)},
            "step": np.asarray(7, np.int32)}


def placements(t) -> list:
    """A DTensor's placements as names: "shard<dim>" or "replicate"."""
    return [f"shard{p.dim}" if p.is_shard() else "replicate"
            for p in t.placements]


def worker(rank: int, world: int, port: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from thermal_semantic_segmentation_torch.core.checkpoint import (
        abstract_like, load_sharded, save_sharded)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        init_distributed)

    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = DeviceMesh("cpu", list(range(world)))
    full = full_tree()
    rows = W_SHAPE[0] // world
    tree = {"params": {"w": DTensor.from_local(torch.from_numpy(
                full["params"]["w"][rank * rows:(rank + 1) * rows]).clone(),
                mesh, [Shard(0)], run_check=False)},
            "opt": {"mu": DTensor.from_local(torch.from_numpy(
                full["opt"]["mu"]), mesh, [Replicate()], run_check=False)},
            "step": torch.from_numpy(full["step"])}
    path = os.path.join(out, "sharded")
    save_sharded(path, tree)
    dist.barrier()
    meta = {"files": sorted(os.listdir(path))}
    arrays = {}
    for name, target in (("own", abstract_like(tree)),
                         ("replicated", abstract_like(
                             tree, sharding=(mesh, [Replicate()])))):
        got = load_sharded(path, target)
        assert got is target
        w, mu = got["params"]["w"], got["opt"]["mu"]
        meta[name] = {"w": placements(w), "mu": placements(mu),
                      "step": int(got["step"]),
                      "step_dtype": str(got["step"].dtype)}
        arrays[f"{name}/w"] = w.to_local().numpy()
        arrays[f"{name}/mu"] = mu.to_local().numpy()
    np.savez(os.path.join(out, f"worker{rank}.npz"), **arrays)
    with open(os.path.join(out, f"worker{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from thermal_semantic_segmentation_tpu.core import (  # noqa: E402
    checkpoint as jax_checkpoint)
from thermal_semantic_segmentation_tpu.parallel.mesh import (  # noqa: E402
    make_mesh)
from thermal_semantic_segmentation_torch.core import checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One run of two gloo workers: (the checkpoint directory, each rank's
    (arrays, meta))."""
    out = tmp_path_factory.mktemp("sharded")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(port), str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    results = []
    for r in range(WORLD):
        with open(out / f"worker{r}.json") as f:
            results.append((dict(np.load(out / f"worker{r}.npz")),
                            json.load(f)))
    return out / "sharded", results


def jax_roundtrip(path):
    """JAX's own case: the tree on the 8-device mesh, w sharded over
    'data', saved by its ``save_sharded`` and restored into its own
    shardings and replicated."""
    mesh = make_mesh()
    data_sh, repl_sh = NamedSharding(mesh, P("data")), NamedSharding(mesh,
                                                                     P())
    full = full_tree()
    tree = {"params": {"w": jax.device_put(jnp.asarray(full["params"]["w"]),
                                           data_sh)},
            "opt": {"mu": jax.device_put(jnp.asarray(full["opt"]["mu"]),
                                         repl_sh)},
            "step": jax.device_put(jnp.asarray(full["step"]), repl_sh)}
    jax_checkpoint.save_sharded(path, tree)
    own = jax_checkpoint.load_sharded(path,
                                      jax_checkpoint.abstract_like(tree))
    replicated = jax_checkpoint.load_sharded(
        path, jax_checkpoint.abstract_like(tree, sharding=repl_sh))
    return jax.device_get(own), jax.device_get(replicated)


def test_two_ranks_reload_their_shards_and_the_replicated_leaves(ranks):
    """Each rank gets its own rows of w back as ``Shard(0)``, mu as
    ``Replicate()``, the step as an int32 7: the values JAX's round trip
    restores."""
    _, results = ranks
    full = full_tree()
    rows = W_SHAPE[0] // WORLD
    for r, (arrays, meta) in enumerate(results):
        assert meta["own"] == {"w": ["shard0"], "mu": ["replicate"],
                               "step": 7, "step_dtype": "torch.int32"}
        np.testing.assert_array_equal(
            arrays["own/w"], full["params"]["w"][r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(arrays["own/mu"], full["opt"]["mu"])


def test_two_ranks_reshard_to_replicated_on_load(ranks, tmp_path):
    """A target replicated over the mesh (``abstract_like(tree,
    sharding=(mesh, [Replicate()]))``, JAX's ``sharding=`` override) reads
    every rank's shard: each rank holds the whole w, equal to what JAX's
    resharding restore gives."""
    _, results = ranks
    _, jax_replicated = jax_roundtrip(str(tmp_path / "orbax"))
    for arrays, meta in results:
        assert meta["replicated"]["w"] == ["replicate"]
        assert meta["replicated"]["step"] == 7
        np.testing.assert_array_equal(arrays["replicated/w"],
                                      np.asarray(jax_replicated["params"]["w"]))
        np.testing.assert_array_equal(arrays["replicated/mu"],
                                      np.asarray(jax_replicated["opt"]["mu"]))


def test_each_rank_writes_only_its_own_shard(ranks):
    """A file a rank, ``__<rank>_0.distcp``, and ``.metadata``; rank r's
    file holds the bytes of its rows of w and not the other rank's: no
    rank gathered."""
    path, results = ranks
    assert results[0][1]["files"] == [".metadata"] + [
        f"__{r}_0.distcp" for r in range(WORLD)]
    w = full_tree()["params"]["w"]
    rows = W_SHAPE[0] // WORLD
    shards = [w[r * rows:(r + 1) * rows].tobytes() for r in range(WORLD)]
    for r in range(WORLD):
        data = (path / f"__{r}_0.distcp").read_bytes()
        assert shards[r] in data
        assert all(shards[q] not in data for q in range(WORLD) if q != r)


def test_one_process_roundtrip_matches_jax(tmp_path):
    """Without a process group (one process, as the JAX functions run on
    one host): plain tensors and a Python scalar saved and restored into
    ``abstract_like``'s empty tensors, equal to JAX's round trip."""
    full = full_tree()
    tree = {"params": {"w": torch.from_numpy(full["params"]["w"])},
            "opt": {"mu": torch.from_numpy(full["opt"]["mu"])},
            "step": torch.from_numpy(full["step"]), "epoch": 3}
    path = tmp_path / "one"
    checkpoint.save_sharded(str(path), tree)
    target = checkpoint.abstract_like(tree)
    assert target["params"]["w"].shape == W_SHAPE
    assert target["step"].dtype == torch.int32 and target["epoch"] == 3
    got = checkpoint.load_sharded(str(path), target)
    assert got is target and sorted(os.listdir(path)) == [".metadata",
                                                          "__0_0.distcp"]
    jax_own, _ = jax_roundtrip(str(tmp_path / "orbax"))
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.asarray(jax_own["params"]["w"]))
    np.testing.assert_array_equal(got["opt"]["mu"].numpy(),
                                  np.asarray(jax_own["opt"]["mu"]))
    assert int(got["step"]) == int(jax_own["step"]) == 7
    assert got["epoch"] == 3


def test_relative_path_is_made_absolute(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    checkpoint.save_sharded("rel", {"v": torch.arange(3)})
    got = checkpoint.load_sharded(str(tmp_path / "rel"),
                                  {"v": torch.empty(3, dtype=torch.int64)})
    assert torch.equal(got["v"], torch.arange(3))


def test_orbax_directory_is_refused_with_its_reason(tmp_path):
    """A directory the JAX package's ``save_sharded`` wrote (orbax) is
    refused by name, not with a stack trace from inside the reader."""
    path = str(tmp_path / "orbax")
    jax_roundtrip(path)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        checkpoint.load_sharded(path, {"params": {"w": torch.empty(W_SHAPE)}})
    with pytest.raises(FileNotFoundError, match="no sharded checkpoint"):
        checkpoint.load_sharded(str(tmp_path / "none"), {})
