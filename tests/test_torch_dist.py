"""The port's multi-process path (parallel/mesh.py, the DDP train step of
train/seg.py with the synchronised BatchNorm of nn/resnet.py, the sharded
loader, utils/preempt.py, the cross-process reductions of eval/validate.py,
eval/distance.py and train/prototypes.py, the process-0 checkpoint funnel
and the train CLI's preemption) in two processes over gloo on the CPU,
against the JAX package in this one.

The worker is this file run as a script: ``python tests/test_torch_dist.py
<rank> <world> <port> <out>``. It joins the group through the train CLI's
own parser (``--distributed true --coordinator_address ...``), runs every
case and writes its results to ``<out>``; it imports no JAX. One run of two
workers serves every test; it has its own timeout (``RUN_TIMEOUT``), and
each test another (``TEST_TIMEOUT``).

Tolerances: losses rtol 1e-5; the first step's gradients 5e-4 absolute
(their global norm rtol 1e-3) and the running statistics it folds 5e-4;
the parameters after two steps inside
the 2 x lr envelope but for an outlier count (tests/test_torch_train.py
says why); the two ranks' state bit-equal. Validation against JAX's batch-1
whole-set run: mIoU and class IoUs rtol 1e-6, val_loss 1e-5; against the
port's one process: mIoU exact, val_loss 1e-6. Distance: L1 rtol 1e-6, SSIM
1e-5 absolute, per-class L1 1e-5. Prototypes 5e-4 absolute, counts exact.
"""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np

WORLD = 2
HW = (64, 128)
LR = 1e-4
IGNORE = 12
STEPS = 2
LOCAL = 2                      # each rank's batch
# (bn_mode, grad_accum, remat) of the DDP steps
MODES = [("sync", 1, "none"), ("sync", 2, "none"), ("per_replica", 1, "none"),
         ("per_replica", 2, "none"), ("sync", 1, "full"), ("sync", 1, "dots")]
VAL_IMAGES, VAL_BATCH = 5, 2   # shards of 3 (batches 2, 1) and 2 images
PROTO_IMAGES, PROTO_BATCH = 8, 2
DIST_PAIRS = 5
SHARD_N, SHARD_BATCH = 11, 2
SHARD_CASES = [(True, True, True), (True, False, False), (False, True, False),
               (False, False, True)]     # (shuffle, lockstep, drop_last)
# the train CLI's labels are 256x512 (its step's label size); the images
# half that, which the logits' upsampling takes
CLI_SOURCE, CLI_TARGET, CLI_HW, CLI_LABEL_HW = 10, 2, (128, 256), (256, 512)
RUN_TIMEOUT, TEST_TIMEOUT = 600, 300
GRAD_NORM_RTOL = 1e-3


class Arrays:
    """An in-memory dataset (``len``, ``get(index, rng)``) of arrays that
    share their first axis."""

    def __init__(self, **arrays):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def get(self, index, rng):
        return {k: v[index] for k, v in self.arrays.items()}


def step_batches():
    """``STEPS`` global batches of ``WORLD * LOCAL`` images: rank 1's rows
    have half their pixels ignored, rank 0's 2%, so a mean of the ranks'
    mean CEs is not the global batch's CE."""
    rng = np.random.default_rng(50)
    out = []
    for _ in range(STEPS):
        image = rng.uniform(0, 1, (WORLD * LOCAL, *HW, 1)).astype(np.float32)
        label = rng.integers(0, 13, (WORLD * LOCAL, *HW))
        share = np.where(np.arange(WORLD * LOCAL) >= LOCAL, 0.5, 0.02)
        label[rng.random(label.shape) < share[:, None, None]] = 255
        out.append((image, label))
    return out


def val_set():
    rng = np.random.default_rng(51)
    label = rng.integers(0, 13, (VAL_IMAGES, *HW))
    label[rng.random(label.shape) < 0.05] = 255
    return Arrays(image=rng.uniform(0, 1, (VAL_IMAGES, *HW, 1)).astype(
        np.float32), label=label)


def distance_set(n):
    rng = np.random.default_rng(52)
    ori = rng.uniform(0, 1, (n, 32, 48, 1)).astype(np.float32)
    trans = np.clip(ori + rng.normal(0, 0.2, ori.shape), 0, 1).astype(
        np.float32)
    label = rng.integers(0, 12, (n, 32, 48)).astype(np.int32)
    label[:, :4] = 255
    return Arrays(original=ori, translated=trans, label=label)


def proto_images():
    return np.random.default_rng(53).uniform(
        0, 1, (PROTO_IMAGES, *HW, 1)).astype(np.float32)


def cli_sets():
    """(source, target) in-memory sets for the train CLI."""
    rng = np.random.default_rng(54)

    def images(n):
        return Arrays(image=rng.uniform(0, 1, (n, *CLI_HW, 1)).astype(
            np.float32), label=rng.integers(0, 13, (n, *CLI_LABEL_HW)))
    return images(CLI_SOURCE), images(CLI_TARGET)


def key_of(mode, ga, remat):
    return f"{mode}{ga}" + ("" if remat == "none" else f"-{remat}")


def worker(rank: int, world: int, port: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.cli import segmentation_train
    from thermal_semantic_segmentation_torch.cli._common import (
        primary_host, save_seg_checkpoint)
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.eval.distance import (
        evaluate_distance)
    from thermal_semantic_segmentation_torch.eval.validate import (
        seg_validate)
    from thermal_semantic_segmentation_torch.models.deeplab import DeepLabV2
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        host_shard, make_mesh)
    from thermal_semantic_segmentation_torch.train.prototypes import (
        calc_prototypes)
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)
    from thermal_semantic_segmentation_torch.utils.logging import get_logger
    from thermal_semantic_segmentation_torch.utils.preempt import (
        GracefulShutdown, cross_process)

    torch.set_num_threads(2)
    dist_flags = ["--distributed", "true", "--coordinator_address",
                  f"localhost:{port}", "--num_processes", str(world),
                  "--process_id", str(rank), "--device", "cpu"]
    seg_parse().parse_args(dist_flags)          # the CLI's bring-up
    assert dist.get_backend() == "gloo" and dist.get_rank() == rank
    mesh = make_mesh("cpu")
    start = torch.load(os.path.join(out, "start.pt"))
    arrays, meta = {}, {"rank": rank, "shard": list(host_shard())}

    def model_of(remat="none"):
        model = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1),
                          remat=remat)
        model.load_state_dict(start, strict=True)
        model = model.to(memory_format=torch.channels_last)
        model.layer5.head[0].p = 0.0
        return model

    rows = slice(rank * LOCAL, (rank + 1) * LOCAL)
    for mode, ga, remat in MODES:
        key = key_of(mode, ga, remat)
        model = model_of(remat)
        state = create_seg_state(model, learning_rate=LR, device="cpu")
        step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, bn_mode=mode, mesh=mesh,
                                   grad_accum=ga, device="cpu")
        losses = []
        for k, (image, label) in enumerate(step_batches()):
            losses.append(float(step(state, torch.from_numpy(image[rows]),
                                     torch.from_numpy(label[rows]))))
            if k == 0:
                for name, p in model.named_parameters():
                    arrays[f"{key}/grad/{name}"] = p.grad.numpy().copy()
                for name, b in model.named_buffers():
                    arrays[f"{key}/step1/{name}"] = b.numpy().copy()
        for name, v in model.state_dict().items():
            arrays[f"{key}/final/{name}"] = v.numpy().copy()
        meta[f"{key}/losses"] = losses

    model = model_of().eval()
    val = DataLoader(val_set(), VAL_BATCH, drop_last=False,
                     shard=host_shard(), shard_lockstep=False)
    meta["val_local"] = sum(len(b) for b in val._batches())
    miou, loss, cls = seg_validate(model, val, device="cpu",
                                   reduce_processes=True)
    meta["val"] = [miou, loss, list(cls.values())]

    for name, n in (("distance", DIST_PAIRS), ("distance_one", 1),
                    ("distance_none", 0)):
        loader = DataLoader(distance_set(n), 1, shuffle=True, drop_last=True,
                            shard=host_shard(), shard_lockstep=False)
        l1, s, per_class = evaluate_distance(loader, num_classes=13,
                                             device="cpu",
                                             reduce_processes=True)
        meta[name] = [l1, s, per_class.tolist()]

    loader = DataLoader(Arrays(image=proto_images()), PROTO_BATCH,
                        shuffle=True, drop_last=True, shard=host_shard(),
                        shard_lockstep=False)
    arrays["proto"], arrays["proto_counts"] = calc_prototypes(
        model_of(), loader, num_classes=13, device="cpu")

    index = Arrays(i=np.arange(SHARD_N))
    for shuffle, lockstep, drop_last in SHARD_CASES:
        loader = DataLoader(index, SHARD_BATCH, shuffle=shuffle, seed=3,
                            drop_last=drop_last, shard=host_shard(),
                            shard_lockstep=lockstep)
        meta[f"shard/{shuffle}/{lockstep}/{drop_last}"] = [
            [b["i"].tolist() for b in loader] for _ in range(2)] + [
            len(loader)]

    # shutdown: only rank 1 is signalled, every rank stops
    with GracefulShutdown() as shutdown:
        agreed = cross_process(shutdown)
        polls = [agreed.requested]
        if rank == 1:
            signal.raise_signal(signal.SIGTERM)
        polls += [agreed.requested, agreed.requested]
        meta["shutdown"] = {"polls": polls, "local": shutdown.requested,
                            "signum": agreed.signum}

    meta["primary_host"] = primary_host()
    save_seg_checkpoint(os.path.join(out, f"funnel_{rank}.pth"),
                        model.state_dict(), epoch=0)

    # the train CLI's loop: rank 1 signalled before its second step, the
    # preempt checkpoint from rank 0, then a resume from it
    class SignalAtPoll:
        def __init__(self, inner, at):
            self.inner, self.at, self.polls = inner, at, 0

        @property
        def requested(self):
            self.polls += 1
            if self.polls == self.at:
                signal.raise_signal(signal.SIGTERM)
            return self.inner.requested

        @property
        def signum(self):
            return self.inner.signum

    source, target = cli_sets()
    root = os.path.join(out, "cli")
    logger = get_logger(os.path.join(root, f"logs{rank}"))

    def run(*flags, shutdown=None):
        args = seg_parse().parse_args(
            ["-batch_size", "2", "-val_batch_size", "2", "--layers",
             "1,1,1,1", "--model_root_path", root, "-new_checkpoint_name",
             "n.pth", *flags, *dist_flags])
        args.logdir = os.path.join(root, f"logs{rank}")
        return segmentation_train.train_epochs(
            args, logger, *segmentation_train.make_loaders(
                args, source, target), shutdown=shutdown)[1]

    with GracefulShutdown() as shutdown:
        first = run("-epochs", "1", shutdown=SignalAtPoll(
            shutdown, 2 if rank == 1 else 0))
    dist.barrier()              # rank 0 has written the preempt checkpoint
    second = run("-epochs", "1", "-load_model", "true", "-checkpoint_name",
                 "preempt_n.pth")
    meta["cli"] = {"first": first, "second": second}

    dist.barrier()
    # rank 0 keeps every array, the others their digests (a run holds
    # ~250 MB of arrays a mode and rank)
    meta["digests"] = {k: hashlib.sha256(
        np.ascontiguousarray(v).tobytes()).hexdigest()
        for k, v in arrays.items()}
    if rank:
        arrays = {k: v for k, v in arrays.items() if k.startswith("proto")}
    np.savez(os.path.join(out, f"worker{rank}.npz"), **arrays)
    with open(os.path.join(out, f"worker{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


import flax.linen as fnn  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tests.test_torch_deeplab import (  # noqa: E402
    TINY, jax_deeplab_with_twin)
from tests.test_torch_train import (  # noqa: E402
    GRAD_ATOL, LOSS_RTOL, STATS_ATOL, as_state_dict, jax_grads, no_dropout)
from thermal_semantic_segmentation_tpu.data.loader import (  # noqa: E402
    DataLoader as JaxDataLoader)
from thermal_semantic_segmentation_tpu.eval.distance import (  # noqa: E402
    evaluate_distance as jax_evaluate_distance)
from thermal_semantic_segmentation_tpu.eval.validate import (  # noqa: E402
    seg_validate as jax_seg_validate)
from thermal_semantic_segmentation_tpu.models.deeplab import (  # noqa: E402
    create_deeplab as jax_create_deeplab)
from thermal_semantic_segmentation_tpu.parallel.mesh import (  # noqa: E402
    replicate, shard_batch)
from thermal_semantic_segmentation_tpu.train import (  # noqa: E402
    seg as jax_seg)
from thermal_semantic_segmentation_tpu.train.prototypes import (  # noqa: E402
    calc_prototypes as jax_calc_prototypes)
from thermal_semantic_segmentation_torch.data.loader import (  # noqa: E402
    DataLoader)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def test_timeout():
    """Each test's own limit: SIGALRM ends one that hangs."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT} s")
    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module")
def tiny():
    model, variables, twin = jax_deeplab_with_twin(21)
    twin.layer5.head[0].p = 0.0
    return model, variables, twin


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    """One run of ``WORLD`` workers: their (arrays, meta), rank by rank,
    and the output directory."""
    out = tmp_path_factory.mktemp("dist")
    torch.save(tiny[2].state_dict(), str(out / "start.pt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(port), str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
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
            meta = json.load(f)
        results.append((dict(np.load(out / f"worker{r}.npz")), meta))
        os.remove(out / f"worker{r}.npz")
    return results, out


def _jax_state(model, variables, mesh=None):
    state = jax_seg.create_seg_state(
        model, jax.tree.map(jnp.asarray, variables), learning_rate=LR)
    return state if mesh is None else replicate(mesh, state)


def _check_envelope(got, want_params, names):
    outside = total = 0
    worst = 0.0
    for k in names:
        ratio = np.abs(got[k] - want_params[k]) / (STEPS * LR)
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        total += ratio.size
    print(f"{outside} of {total} parameters outside the envelope, worst "
          f"{worst:.3f} of it")
    assert outside <= 1e-4 * total and worst <= 2.0


def _jax_model(remat):
    return jax_create_deeplab(jax.random.key(0), num_channels=1,
                              image_size=HW, remat=remat, abstract=True,
                              **TINY)[0]


def _jax_step(model, variables, mode, ga, **state_kw):
    """A fresh JAX state and step: the one-process step for 'sync', the
    ``shard_map`` step on a 2-device mesh for 'per_replica'; and that
    mesh (or None)."""
    mesh = None
    kw = {}
    if mode == "per_replica":
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
        kw = {"bn_mode": "per_replica", "mesh": mesh}
    state = jax_seg.create_seg_state(
        model, jax.tree.map(jnp.asarray, variables),
        **{"learning_rate": LR, **state_kw})
    if mesh is not None:
        state = replicate(mesh, state)
    step = jax_seg.make_seg_train_step(
        ignore_index=IGNORE, label_hw=HW,
        base_lr=state_kw.get("learning_rate", LR), grad_accum=ga, **kw)

    def run(state, image, label):
        batch = (jnp.asarray(image), jnp.asarray(label))
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        with fnn.intercept_methods(no_dropout):
            return step(state, *batch)
    return state, run


def _run_jax(model, variables, mode, ga):
    """The JAX steps on the global batches. Returns (losses, step-1 state
    dict, final state dict)."""
    state, run = _jax_step(model, variables, mode, ga)
    losses, first = [], None
    for image, label in step_batches():
        state, loss = run(state, image, label)
        losses.append(float(loss))
        sd = as_state_dict(jax.device_get(state.params),
                           jax.device_get(state.batch_stats))
        first = sd if first is None else first
    return losses, first, sd


def _jax_step_grads(model, variables, mode, ga):
    """The gradients that the JAX step applies on the first global batch:
    one plain SGD step at lr 1 from zero momentum moves each parameter by
    minus its gradient."""
    state, run = _jax_step(model, variables, mode, ga, optimizer="sgd",
                           learning_rate=1.0)
    state, _ = run(state, *step_batches()[0])
    after = jax.device_get(state.params)
    return jax.tree.map(lambda p0, p1: np.asarray(p0) - np.asarray(p1),
                        variables["params"], after)


def _check_grads(arrays, key, want, names):
    """Every tensor within GRAD_ATOL, and the gradients' global norm
    within GRAD_NORM_RTOL (a gradient scaled by the world size fails)."""
    got_sq = want_sq = 0.0
    for name in names:
        got = arrays[f"{key}/grad/{name}"]
        np.testing.assert_allclose(got, want[name], rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)
        got_sq += float(np.square(got, dtype=np.float64).sum())
        want_sq += float(np.square(want[name], dtype=np.float64).sum())
    np.testing.assert_allclose(np.sqrt(got_sq), np.sqrt(want_sq),
                               rtol=GRAD_NORM_RTOL)


def _check_step(runs, tiny, mode, ga, remat="none"):
    arrays, meta = runs[0][0]
    model, variables, twin = tiny
    if remat != "none":
        model = _jax_model(remat)
    losses, first, final = _run_jax(model, variables, mode, ga)
    key = key_of(mode, ga, remat)
    np.testing.assert_allclose(meta[f"{key}/losses"], losses, rtol=LOSS_RTOL)
    for k, v in first.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(arrays[f"{key}/step1/{k}"], v, rtol=0,
                                       atol=STATS_ATOL, err_msg=k)
    final_got = {k[len(key) + 7:]: v for k, v in arrays.items()
                 if k.startswith(f"{key}/final/")}
    _check_envelope(final_got, final, dict(twin.named_parameters()))
    return arrays


@pytest.mark.parametrize("ga", [1, 2])
def test_sync_step_matches_jax_global_batch(runs, tiny, ga):
    """Two ranks of 2 images each, BatchNorm synchronised and the CE
    normalised by the global count of valid pixels (rank 1 ignores half its
    pixels): the JAX step on the 4-image global batch, its microbatches
    those of the global batch."""
    arrays = _check_step(runs, tiny, "sync", ga)
    model, variables, twin = tiny
    image, label = step_batches()[0]
    want = as_state_dict(jax_grads(model, variables, image, label, ga),
                         variables["batch_stats"])
    _check_grads(arrays, f"sync{ga}", want, dict(twin.named_parameters()))


@pytest.mark.parametrize("ga", [1, 2])
def test_per_replica_step_matches_jax_shard_map(runs, tiny, ga):
    """Local BatchNorm, the loss and gradients averaged (not summed), the
    running statistics averaged after the step: JAX's ``shard_map`` step
    over two CPU devices, its gradients included."""
    arrays = _check_step(runs, tiny, "per_replica", ga)
    model, variables, twin = tiny
    want = as_state_dict(
        _jax_step_grads(model, variables, "per_replica", ga),
        variables["batch_stats"])
    _check_grads(arrays, f"per_replica{ga}", want,
                 dict(twin.named_parameters()))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_sync_remat_step_matches_jax_and_folds_once(runs, tiny, remat):
    """'sync' with a rematerialised backbone: the recomputed blocks issue
    the synchronised BatchNorm's all-reduces again inside DDP's backward.
    The JAX remat step on the global batch (loss, gradients, running
    statistics), and every BatchNorm's ``num_batches_tracked`` one fold a
    step."""
    arrays = _check_step(runs, tiny, "sync", 1, remat)
    _, variables, twin = tiny
    image, label = step_batches()[0]
    want = as_state_dict(jax_grads(_jax_model(remat), variables, image,
                                   label, 1), variables["batch_stats"])
    key = key_of("sync", 1, remat)
    _check_grads(arrays, key, want, dict(twin.named_parameters()))
    tracked = [k for k in arrays if k.startswith(f"{key}/step1/")
               and k.endswith("num_batches_tracked")]
    assert len(tracked) == sum(isinstance(m, torch.nn.BatchNorm2d)
                               for m in twin.modules())
    for k in tracked:
        assert int(arrays[k]) == 1, k
        assert int(arrays[k.replace("/step1/", "/final/")]) == STEPS, k


@pytest.mark.parametrize("mode,ga,remat", MODES,
                         ids=[key_of(*m) for m in MODES])
def test_ranks_hold_identical_state(runs, mode, ga, remat):
    """Both ranks' losses, and their parameters and buffers after each
    step, bit for bit (by their sha256)."""
    (a0, m0), (_, m1) = runs[0]
    key = key_of(mode, ga, remat)
    assert m0[f"{key}/losses"] == m1[f"{key}/losses"]
    names = [k for k in a0 if k.startswith(f"{key}/")]
    assert len(names) > 100
    for k in names:
        if "/grad/" not in k:
            assert m0["digests"][k] == m1["digests"][k], k


def test_validate_reduces_to_the_whole_set(runs, tiny):
    """Shards of 3 and 2 images (batches 2 + 1 and 2): JAX's whole-set
    batch-1 scores, and the port's own one-process scores."""
    (_, m0), (_, m1) = runs[0]
    model, variables, twin = tiny
    assert [m0["val_local"], m1["val_local"]] == [3, 2]
    assert m0["val"] == m1["val"]
    miou, loss, cls = m0["val"]
    want = jax_seg_validate(model, variables,
                            JaxDataLoader(val_set(), 1, drop_last=False),
                            num_classes=13, ignore_index=IGNORE, label_hw=HW)
    np.testing.assert_allclose(miou, want[0], rtol=1e-6)
    np.testing.assert_allclose(loss, want[1], rtol=1e-5)
    np.testing.assert_allclose(cls, list(want[2].values()), rtol=1e-6,
                               equal_nan=True)
    one = seg_validate(twin.eval(), DataLoader(val_set(), VAL_BATCH,
                                               drop_last=False),
                       device="cpu")
    assert miou == one[0]
    np.testing.assert_allclose(loss, one[1], rtol=1e-6)


@pytest.mark.parametrize("name,n", [("distance", DIST_PAIRS),
                                    ("distance_one", 1)])
def test_distance_reduces_to_the_whole_set(runs, name, n):
    """Batch-1 shards of 3 and 2 pairs, or of 1 and none (the empty shard
    adds nothing): JAX's whole-set scores."""
    (_, m0), (_, m1) = runs[0]
    assert m0[name] == m1[name]
    l1, s, per_class = m0[name]
    pairs = distance_set(n).arrays
    want = jax_evaluate_distance(
        [{k: v[i:i + 1] for k, v in pairs.items()} for i in range(n)],
        num_classes=13)
    np.testing.assert_allclose(l1, want[0], rtol=1e-6)
    np.testing.assert_allclose(s, want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(per_class, want[2], rtol=1e-5, equal_nan=True)


def test_distance_of_no_pairs_is_nan_on_every_rank(runs):
    for _, meta in runs[0]:
        l1, s, per_class = meta["distance_none"]
        assert np.isnan(l1) and np.isnan(s) and np.isnan(per_class).all()


def test_prototype_merge_matches_the_whole_set(runs, tiny):
    """Each rank folds 4 of the 8 images; the merge equals JAX's fold of
    all 8 in one process."""
    (a0, _), (a1, _) = runs[0]
    model, variables, _ = tiny
    np.testing.assert_array_equal(a0["proto"], a1["proto"])
    np.testing.assert_array_equal(a0["proto_counts"], a1["proto_counts"])
    want_p, want_n = jax_calc_prototypes(
        model, variables, JaxDataLoader(Arrays(image=proto_images()),
                                        PROTO_BATCH, drop_last=True),
        num_classes=13)
    assert a0["proto_counts"].sum() > 0
    np.testing.assert_array_equal(a0["proto_counts"], want_n)
    np.testing.assert_allclose(a0["proto"], want_p, rtol=0, atol=5e-4)


@pytest.mark.parametrize("case", SHARD_CASES,
                         ids=[f"shuffle{s}-lockstep{l}-droplast{d}"
                              for s, l, d in SHARD_CASES])
def test_loader_shard_order_matches_jax(runs, case):
    """Each rank's batches over two epochs, index for index, are those of
    JAX's ``DataLoader(shard=(rank, 2))``; so is its length."""
    shuffle, lockstep, drop_last = case
    key = f"shard/{shuffle}/{lockstep}/{drop_last}"
    seen = []
    for rank, (_, meta) in enumerate(runs[0]):
        loader = JaxDataLoader(Arrays(i=np.arange(SHARD_N)), SHARD_BATCH,
                               shuffle=shuffle, seed=3, drop_last=drop_last,
                               shard=(rank, WORLD), shard_lockstep=lockstep)
        want = [[b["i"].tolist() for b in loader] for _ in range(2)]
        assert meta[key] == want + [len(loader)]
        seen += [i for batch in want[0] for i in batch]
    if not lockstep and not drop_last:
        assert sorted(seen) == list(range(SHARD_N))   # an exact partition


def test_shutdown_agreement_with_one_rank_signalled(runs):
    (_, m0), (_, m1) = runs[0]
    assert m0["shutdown"] == {"polls": [False, True, True], "local": False,
                              "signum": None}
    assert m1["shutdown"] == {"polls": [False, True, True], "local": True,
                              "signum": int(signal.SIGTERM)}


def test_checkpoint_funnel_writes_from_process_zero(runs):
    (_, m0), (_, m1) = runs[0]
    out = runs[1]
    assert m0["primary_host"] and not m1["primary_host"]
    assert (out / "funnel_0.pth").exists()
    assert not (out / "funnel_1.pth").exists()


def test_train_cli_preempts_together_and_resumes(runs):
    """Rank 1 alone is signalled before its second step: both ranks stop
    after one step, rank 0 writes ``preempt_n.pth`` at epoch -1 without
    validating, and ``-load_model`` resumes it at epoch 0."""
    from thermal_semantic_segmentation_torch.cli._common import (
        load_seg_checkpoint)
    out = runs[1]
    for _, meta in runs[0]:
        first, second = meta["cli"]["first"], meta["cli"]["second"]
        assert [h["preempted"] for h in first] == [True]
        assert len(first[0]["train_losses"]) == 1
        assert "val_loss" not in first[0]
        assert [h["epoch"] for h in second] == [0]
        assert not second[0]["preempted"]
        assert len(second[0]["train_losses"]) == 2
        assert np.isfinite(second[0]["val_loss"])
    (_, m0), (_, m1) = runs[0]
    for run in ("first", "second"):
        for a, b in zip(m0["cli"][run], m1["cli"][run]):
            assert a["train_losses"] == b["train_losses"]
            assert a.get("val_loss") == b.get("val_loss")
    _, meta = load_seg_checkpoint(str(out / "cli" / "preempt_n.pth"))
    assert meta["epoch"] == -1 and meta["val_loss"] == float("inf")
    assert (out / "cli" / "n.pth").exists()
