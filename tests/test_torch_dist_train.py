"""The port's multi-process self-training and CycleGAN steps
(train/self_train.py and train/gan.py under a ``DataMesh``: synchronised
BatchNorm, losses over the global counts, ``all_reduce_grads``, the
all-gathered prototypes and pools) and the two CLIs under
``--distributed``, in two processes over gloo on the CPU, against the JAX
package in this one.

The worker is this file run as a script: ``python
tests/test_torch_dist_train.py <rank> <world> <port> <out>``. It joins the
group through the self-training CLI's own parser, runs every case and
writes its results to ``<out>``; it imports no JAX. One run of two
workers serves every test; it has its own timeout (``RUN_TIMEOUT``), and
each test another (``TEST_TIMEOUT``). The JAX oracles run in this process
while the workers run.

Sizes: DeepLab layers 1,1,1,1 at label_hw 64x128 (tests/
test_torch_self_train.py's); UNet-32 ngf 8 and PatchGAN ndf 8 at 32x64
with tiny module2 sem nets; a global batch of 4, two rows a rank. Rank
1's rows ignore half their source-label pixels and most of their pseudo
labels, so a mean of the ranks' means is not the global mean.

Tolerances (those of tests/test_torch_self_train.py,
tests/test_torch_gan.py and tests/test_torch_dist.py): losses rtol 1e-5
(self-train) and metrics rtol 1e-4 (GAN); gradients 5e-4 absolute per
tensor (reported in units of the largest gradient), their global norm
rtol 1e-3; the parameters inside one step's lr envelope, at most 5e-4 of
them outside and none past 2 x lr (the self-train parameters with a
gradient of at least 1e-4 all inside); the self-train BatchNorm buffers,
EMA buffers and prototypes 5e-4, counts exact; the GAN BatchNorm
statistics 1e-5; the two ranks' state bit-equal (sha256). In the pools'
swap regime the two ranks are held to the port's own one-process step on
the joined batch: metrics rtol 1e-5, pools 1e-5, parameters inside the lr
envelope as above.
"""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np

WORLD, LOCAL = 2, 2
C, IGNORE = 13, 12
ST_HW, ST_FULL = (64, 128), (80, 176)
GAN_HW = (32, 64)
LR = 1e-4
ST_STEPS = GAN_STEPS = 2
PROTO_MOMENTUM, EMA_DECAY = 0.5, 0.5
FILL_POOL, SWAP_POOL = 64, 2        # 8 inserts stay under 64; 2 fill at once
RUN_TIMEOUT, TEST_TIMEOUT = 420, 300
LOSS_RTOL, METRIC_RTOL, GRAD_ATOL, STATE_ATOL, STATS_ATOL = (
    1e-5, 1e-4, 5e-4, 5e-4, 1e-5)
GRAD_NORM_RTOL, GRAD_DECIDED = 1e-3, 1e-4
SWAP_RTOL = 1e-5
WEAK_PARAMS = {"resized_hw": np.array([[96, 160], [120, 200]] * 2, np.int32),
               "crop": np.array([[8, 72, 16, 144], [4, 68, 8, 136]] * 2,
                                np.int32),
               "flip": np.array([True, False, False, True])}


class Arrays:
    """An in-memory dataset (``len``, ``get(index, rng)``) of arrays that
    share their first axis; a dict of such arrays gives a nested dict."""

    def __init__(self, **arrays):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def get(self, index, rng):
        return {k: ({kk: vv[index] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[index])
                for k, v in self.arrays.items()}


def st_batches():
    """``ST_STEPS`` global self-training batches of ``WORLD * LOCAL``
    rows. Hard labels mostly ignored with blobs of classes 5 and 11; the
    soft maps of rank 0's rows peaked (their rectified maximum clears
    ``train_thred``), rank 1's flat (most of their pixels ignored)."""
    rng = np.random.default_rng(60)
    n = WORLD * LOCAL
    out = []
    for _ in range(ST_STEPS):
        hard = np.full((n, *ST_HW), IGNORE, np.int64)
        hard[0, 10:30, 20:60] = 5
        hard[3, 40:60, 90:120] = 11
        soft = rng.random((n, C, *ST_HW)).astype(np.float32)
        soft[:LOCAL] **= 6
        soft /= soft.sum(1, keepdims=True)
        label = rng.integers(0, C, (n, *ST_HW))
        share = np.where(np.arange(n) >= LOCAL, 0.5, 0.02)
        label[rng.random(label.shape) < share[:, None, None]] = 255
        out.append(dict(
            source_image=rng.uniform(0, 1, (n, *ST_HW, 1)).astype(np.float32),
            source_label=label,
            target_image=rng.uniform(0, 1, (n, *ST_HW, 1)).astype(np.float32),
            target_image_full=rng.uniform(0, 1, (n, *ST_FULL, 1)).astype(
                np.float32),
            target_lp_soft=soft, target_lp_hard=hard,
            weak_params=WEAK_PARAMS))
    return out


def st_prototypes():
    return (np.random.default_rng(9).standard_normal((C, 256)) * 0.1
            ).astype(np.float32)


ST_KW = dict(num_classes=C, ignore_index=IGNORE, base_lr=LR, train_thred=0.3,
             label_hw=ST_HW, proto_momentum=PROTO_MOMENTUM,
             ema_decay=EMA_DECAY)


def gan_batches():
    """``GAN_STEPS`` global (real_s, real_t, label_s) batches; rank 1's
    source labels half ignored."""
    rng = np.random.default_rng(61)
    n = WORLD * LOCAL
    out = []
    for _ in range(GAN_STEPS):
        label = rng.integers(0, C, (n, *GAN_HW))
        share = np.where(np.arange(n) >= LOCAL, 0.5, 0.0)
        label[rng.random(label.shape) < share[:, None, None]] = 255
        out.append(dict(
            real_s=rng.uniform(-1, 1, (n, *GAN_HW, 3)).astype(np.float32),
            real_t=rng.uniform(-1, 1, (n, *GAN_HW, 1)).astype(np.float32),
            label_s=label))
    return out


GAN_KW = dict(cycle=True, with_contour=True, canny_rgb_threshold=2.0,
              canny_thermal_threshold=0.5, sem_norm="module2")
GAN_NETS = ("s2t", "t2s", "t", "s")


def port_gan_world(start):
    """The port's G, D and sem nets from the saved state dicts."""
    import torch

    from thermal_semantic_segmentation_torch.models import factory
    from thermal_semantic_segmentation_torch.models.deeplab import DeepLabV2
    nets = {"s2t": factory.unet_32(ngf=8, input_nc=3, output_nc=1),
            "t2s": factory.unet_32(ngf=8, input_nc=1, output_nc=3),
            "t": factory.patchgan(ndf=8, input_nc=1),
            "s": factory.patchgan(ndf=8, input_nc=3)}
    for k, net in nets.items():
        net.load_state_dict(start[k], strict=True)
        nets[k] = net.to(memory_format=torch.channels_last)
    sem = {}
    for k, c in (("s", 3), ("t", 1)):
        sem[k] = DeepLabV2(num_channels=c, num_classes=C, layers=(1, 1, 1, 1))
        sem[k].load_state_dict(start[f"sem_{k}"], strict=True)
        sem[k] = sem[k].to(memory_format=torch.channels_last).eval() \
            .requires_grad_(False)
    return nets, sem


def run_gan_steps(start, batches, *, pool_size, mesh=None, rows=slice(None)):
    """The port's ``make_gan_step`` over ``batches`` (this rank's
    ``rows``). Returns (metrics per step, step-1 gradients, step-1 state,
    final state, pools)."""
    import torch

    from thermal_semantic_segmentation_torch.train import gan
    nets, sem = port_gan_world(start)
    state = gan.create_gan_state(
        g_nets={k: nets[k] for k in ("s2t", "t2s")},
        d_nets={k: nets[k] for k in ("t", "s")}, learning_rate=LR,
        device="cpu")
    step, make_pools = gan.make_gan_step(pool_size=pool_size, sem_nets=sem,
                                         mesh=mesh, **GAN_KW)
    pools = make_pools({"t": (*GAN_HW, 1), "s": (*GAN_HW, 3)}, device="cpu",
                       seed=0)
    metrics, grads, first = [], {}, {}
    for k, b in enumerate(batches):
        m, _ = step(state, pools, *(torch.from_numpy(b[x][rows]) for x in
                                    ("real_s", "real_t", "label_s")),
                    with_sem=True)
        metrics.append({n: float(v) for n, v in m.items()})
        if k == 0:
            for n in GAN_NETS:
                for name, p in nets[n].named_parameters():
                    grads[f"{n}/{name}"] = p.grad.numpy().copy()
                for name, v in nets[n].state_dict().items():
                    first[f"{n}/{name}"] = v.numpy().copy()
    final = {f"{n}/{name}": v.numpy().copy() for n in GAN_NETS
             for name, v in nets[n].state_dict().items()}
    pools = {f"pool/{n}/{f}": getattr(p, f).numpy().copy()
             for n, p in pools.items() for f in ("buffer", "count")}
    return metrics, grads, first, final, pools


def worker(rank: int, world: int, port: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.cli import main as gan_cli
    from thermal_semantic_segmentation_torch.cli import self_train_main
    from thermal_semantic_segmentation_torch.cli.options import (
        self_train_parse, train_parse)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.models import factory
    from thermal_semantic_segmentation_torch.models.deeplab import DeepLabV2
    from thermal_semantic_segmentation_torch.nn import aspp
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        host_shard, make_mesh)
    from thermal_semantic_segmentation_torch.train import self_train
    from thermal_semantic_segmentation_torch.utils.logging import get_logger
    from thermal_semantic_segmentation_torch.utils.preempt import (
        GracefulShutdown)

    torch.set_num_threads(2)
    dist_flags = ["--distributed", "true", "--coordinator_address",
                  f"localhost:{port}", "--num_processes", str(world),
                  "--process_id", str(rank), "--device", "cpu"]
    self_train_parse().parse_args(dist_flags)      # the CLI's bring-up
    assert dist.get_backend() == "gloo" and dist.get_rank() == rank
    mesh = make_mesh("cpu")
    arrays, meta = {}, {"rank": rank}
    rows = slice(rank * LOCAL, (rank + 1) * LOCAL)

    # -- the self-training step ------------------------------------------
    student = DeepLabV2(num_channels=1, num_classes=C, layers=(1, 1, 1, 1))
    student.load_state_dict(torch.load(os.path.join(out, "st_start.pt")),
                            strict=True)
    student = student.to(memory_format=torch.channels_last)
    student.layer5.head[0].p = 0.0
    state = self_train.create_self_train_state(
        student, prototypes=st_prototypes(), learning_rate=LR, device="cpu")
    step = self_train.make_self_train_step(mesh=mesh, device="cpu", **ST_KW)
    losses = []
    for k, b in enumerate(st_batches()):
        b = {n: ({kk: torch.from_numpy(vv[rows]) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v[rows]))
             for n, v in b.items()}
        losses.append([float(x) for x in step(state, **b)])
        if k == 0:
            for name, p in student.named_parameters():
                arrays[f"st/grad/{name}"] = p.grad.numpy().copy()
            for name, v in student.state_dict().items():
                arrays[f"st/step1/{name}"] = v.numpy().copy()
            for name, v in state.teacher.state_dict().items():
                arrays[f"st/ema1/{name}"] = v.numpy().copy()
            arrays["st/proto1"] = state.prototypes.numpy().copy()
            arrays["st/counts1"] = state.proto_counts.numpy().copy()
    for name, v in student.state_dict().items():
        arrays[f"st/final/{name}"] = v.numpy().copy()
    arrays["st/proto"] = state.prototypes.numpy().copy()
    arrays["st/counts"] = state.proto_counts.numpy().copy()
    meta["st/losses"] = losses

    # -- the CycleGAN step, the pools filling and swapping ------------------
    start = torch.load(os.path.join(out, "gan_start.pt"))
    for regime, size in (("fill", FILL_POOL), ("swap", SWAP_POOL)):
        metrics, grads, first, final, pools = run_gan_steps(
            start, gan_batches(), pool_size=size, mesh=mesh, rows=rows)
        meta[f"gan/{regime}/metrics"] = metrics
        for prefix, d in (("grad", grads), ("step1", first),
                          ("final", final)):
            arrays.update({f"gan/{regime}/{prefix}/{k}": v
                           for k, v in d.items()})
        arrays.update({f"gan/{regime}/{k}": v for k, v in pools.items()})

    # -- the two CLIs, rank 1 signalled before its second step -------------
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

    saves = []
    real_save = torch.save

    def counting_save(obj, f, *a, **kw):
        saves.append(sorted(obj) if isinstance(obj, dict) else None)
        return real_save(obj, f, *a, **kw)

    torch.save = counting_save
    aspp.DROPRATE = 0.0
    root = os.path.join(out, "cli")
    sb = st_batches()[0]
    rng = np.random.default_rng(62)
    st_source = Arrays(image=np.concatenate([sb["source_image"]] * 4),
                       label=np.concatenate([sb["source_label"]] * 4))
    st_target = Arrays(
        image=np.concatenate([sb["target_image"]] * 4),
        image_full=np.concatenate([sb["target_image_full"]] * 4),
        label_hard=np.concatenate([sb["target_lp_hard"]] * 4),
        label_soft=np.concatenate([sb["target_lp_soft"]] * 4),
        weak_params={k: np.concatenate([v] * 4)
                     for k, v in WEAK_PARAMS.items()})
    st_val = Arrays(image=rng.uniform(0, 1, (3, *ST_HW, 1)).astype(
        np.float32), label=rng.integers(0, C, (3, *ST_HW)))
    args = self_train_parse().parse_args(
        ["--root", root, "--model_root_path", root, "-checkpoint_name",
         "st_start.pth", "-new_checkpoint_name", "st.pth", "--epochs", "1",
         "-batch_size", str(LOCAL), "--rcrop", "128", "64", "--val_interval",
         "1000", "--layers", "1,1,1,1", *dist_flags])
    logger = get_logger(os.path.join(root, f"logs{rank}"))
    loaders = [DataLoader(ds, LOCAL, shuffle=True, drop_last=True,
                          seed=args.seed + i, shard=host_shard())
               for i, ds in enumerate((st_source, st_target))]
    loaders.append(DataLoader(st_val, LOCAL, drop_last=False))
    with GracefulShutdown() as shutdown:
        _, history = self_train_main.self_train_epochs(
            args, logger, *loaders,
            shutdown=SignalAtPoll(shutdown, 2 if rank == 1 else 0))
    meta["st_cli"] = {"history": [{k: h[k] for k in (
        "epoch", "steps", "preempted", "losses", "validations")}
        for h in history], "saves": saves[:]}
    dist.barrier()
    saves.clear()

    gan_cli.unet_256 = lambda ngf=64, **kw: factory.unet_32(ngf=8, **kw)
    gan_cli.patchgan = lambda input_nc: factory.patchgan(ndf=8,
                                                         input_nc=input_nc)
    args = train_parse().parse_args(
        ["-batch_size", str(LOCAL), "-num_epoch", "1",
         "--gan_model_root_path", root, "-new_checkpoint_name", "g.pth",
         "-source_dataset", "freiburg_rgb", *dist_flags])
    gb = gan_batches()[0]
    loaders = [DataLoader(Arrays(image=np.concatenate([gb[k]] * 4)), LOCAL,
                          shuffle=True, drop_last=True, seed=args.seed + i,
                          shard=host_shard())
               for i, k in enumerate(("real_s", "real_t"))]
    with GracefulShutdown() as shutdown:
        _, history = gan_cli.gan_epochs(
            args, *loaders,
            shutdown=SignalAtPoll(shutdown, 2 if rank == 1 else 0))
    meta["gan_cli"] = {"history": [{k: h[k] for k in (
        "epoch", "steps", "preempted", "metrics")} for h in history],
        "saves": saves[:]}
    args.host_pool = True
    try:
        gan_cli.gan_epochs(args, *loaders)
        meta["host_pool_refused"] = ""
    except ValueError as e:
        meta["host_pool_refused"] = str(e)
    torch.save = real_save

    dist.barrier()
    meta["digests"] = {k: hashlib.sha256(
        np.ascontiguousarray(v).tobytes()).hexdigest()
        for k, v in arrays.items()}
    if rank:
        arrays = {}
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
import optax  # noqa: E402

from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_gan import _jax_sd, jax_net, port_net  # noqa: E402
from tests.test_torch_self_train import _Grads  # noqa: E402
from tests.test_torch_train import as_state_dict, no_dropout  # noqa: E402
from thermal_semantic_segmentation_tpu.train import gan as jax_gan  # noqa: E402
from thermal_semantic_segmentation_tpu.train import (  # noqa: E402
    self_train as jax_st)
from thermal_semantic_segmentation_torch.cli._common import (  # noqa: E402
    load_seg_checkpoint, save_seg_checkpoint)

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


def _recording(tx):
    """``tx`` with a transform ahead of it that keeps the gradients it is
    given in its state."""
    record = optax.GradientTransformation(
        lambda params: _Grads(jax.tree.map(jnp.zeros_like, params)),
        lambda updates, state, params=None: (updates, _Grads(updates)))
    return optax.chain(record, tx)


def _jax_self_train(model, variables):
    """The JAX step on the global batches: (losses, step-1 state dicts of
    the student and the EMA teacher, step-1 gradients, prototypes and
    counts after steps 1 and 2)."""
    tx = optax.inject_hyperparams(lambda learning_rate: _recording(
        optax.adam(learning_rate)))(learning_rate=LR)
    state = jax_st.create_self_train_state(
        model, jax.tree.map(jnp.asarray, variables),
        prototypes=st_prototypes(), learning_rate=LR)
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    step = jax_st.make_self_train_step(model, fused_student=False, **ST_KW)
    out = {"losses": []}
    for k, b in enumerate(st_batches()):
        jb = {n: jax.tree.map(jnp.asarray, v) for n, v in b.items()}
        with fnn.intercept_methods(no_dropout):
            state, lp, ls = step(state, **jb)
        out["losses"].append([float(lp), float(ls)])
        s = jax.device_get(state)
        if k == 0:
            out["step1"] = as_state_dict(s.params, s.batch_stats)
            out["ema1"] = as_state_dict(s.ema_params, s.ema_stats)
            out["grads"] = as_state_dict(s.opt_state.inner_state[0].grads,
                                         s.batch_stats)
            out["proto1"] = np.asarray(s.prototypes)
            out["counts1"] = np.asarray(s.proto_counts)
    out["proto"], out["counts"] = (np.asarray(s.prototypes),
                                   np.asarray(s.proto_counts))
    return out


def _gan_world():
    """JAX G, D and module2 sem nets with their variables, and the port's
    state dicts of the same weights."""
    specs = {"s2t": ("unet_32", dict(ngf=8, output_nc=1), 3),
             "t2s": ("unet_32", dict(ngf=8, output_nc=3), 1),
             "t": ("patchgan", dict(ndf=8), 1),
             "s": ("patchgan", dict(ndf=8), 3)}
    models, variables, start = {}, {}, {}
    for i, (name, (kind, kw, in_c)) in enumerate(specs.items()):
        models[name], variables[name] = jax_net(kind, 40 + i,
                                                (1, *GAN_HW, in_c), **kw)
        start[name] = port_net(kind, variables[name], input_nc=in_c,
                               **kw).state_dict()
    sem_models, sem_vars = {}, {}
    for name, (seed, c) in {"s": (50, 3), "t": (51, 1)}.items():
        sem_models[name], sem_vars[name], twin = jax_deeplab_with_twin(
            seed, num_channels=c)
        start[f"sem_{name}"] = twin.state_dict()
    return models, variables, sem_models, sem_vars, start


def _jax_gan(models, variables, sem_models, sem_vars):
    """JAX ``make_fused_gan_step`` (its passes in the reference order) on
    the global batches, the pools filling: (metrics per step, step-1 G
    and D gradients, step-1 state dicts)."""
    tx = _recording(optax.adam(LR))
    state = jax_gan.create_gan_state(
        g_vars={n: variables[n] for n in ("s2t", "t2s")},
        d_vars={n: variables[n] for n in ("t", "s")}, learning_rate=LR)
    state = state.replace(tx_g=tx, tx_d=tx, opt_g=tx.init(state.g_params),
                          opt_d=tx.init(state.d_params))
    step, make_pools = jax_gan.make_fused_gan_step(
        pool_size=FILL_POOL,
        g_apply={n: models[n].apply for n in ("s2t", "t2s")},
        d_apply={n: models[n].apply for n in ("t", "s")},
        sem_apply={k: m.apply for k, m in sem_models.items()},
        fused_passes=False, **GAN_KW)
    pools = make_pools({"t": (*GAN_HW, 1), "s": (*GAN_HW, 3)}, seed=0)
    out = {"metrics": []}
    for k, b in enumerate(gan_batches()):
        jb = {n: jnp.asarray(v) for n, v in b.items()}
        state, pools, m = step(state, pools, jb["real_s"], jb["real_t"],
                               jb["label_s"], sem_vars, with_sem=True)
        out["metrics"].append({n: float(v) for n, v in m.items()})
        if k == 0:
            s = jax.device_get(state)
            out["grads"], out["step1"] = {}, {}
            for n in GAN_NETS:
                g, o = ((s.g_params, s.opt_g) if n in ("s2t", "t2s")
                        else (s.d_params, s.opt_d))
                stats = s.g_stats if n in ("s2t", "t2s") else s.d_stats
                got = _jax_sd(n, {"params": o[0].grads[n],
                                  "batch_stats": stats[n]})
                out["grads"].update({f"{n}/{k2}": v.numpy()
                                     for k2, v in got.items()})
                got = _jax_sd(n, {"params": g[n], "batch_stats": stats[n]})
                out["step1"].update({f"{n}/{k2}": v.numpy()
                                     for k2, v in got.items()})
    out["pool_counts"] = {n: int(p.count) for n, p in pools.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of ``WORLD`` workers and, while they run, the JAX oracles:
    ((arrays, meta) rank by rank, the output directory, the oracles)."""
    out = tmp_path_factory.mktemp("dist_train")
    st_model, st_vars, st_twin = jax_deeplab_with_twin(8)
    torch.save(st_twin.state_dict(), str(out / "st_start.pt"))
    os.makedirs(out / "cli")
    save_seg_checkpoint(str(out / "cli" / "st_start.pth"),
                        st_twin.state_dict(), epoch=0, highest_mean_iu=0.0,
                        objective_vectors=st_prototypes())
    models, variables, sem_models, sem_vars, start = _gan_world()
    torch.save(start, str(out / "gan_start.pt"))
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
        oracles = {"st": _jax_self_train(st_model, st_vars),
                   "gan": _jax_gan(models, variables, sem_models, sem_vars),
                   "start": start}
        oracles["swap"] = run_gan_steps(start, gan_batches(),
                                        pool_size=SWAP_POOL)
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
    return results, out, oracles


def _check_grads(got, want, names):
    """Every tensor within GRAD_ATOL, and the global norm within
    GRAD_NORM_RTOL; prints the worst error in units of the largest
    gradient."""
    largest = max(float(np.abs(want[n]).max()) for n in names)
    worst = 0.0
    got_sq = want_sq = 0.0
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=GRAD_ATOL,
                                   err_msg=n)
        worst = max(worst, float(np.abs(got[n] - want[n]).max()) / largest)
        got_sq += float(np.square(got[n], dtype=np.float64).sum())
        want_sq += float(np.square(want[n], dtype=np.float64).sum())
    print(f"gradients: worst error {worst:.2e} of the largest gradient "
          f"({largest:.3e})")
    np.testing.assert_allclose(np.sqrt(got_sq), np.sqrt(want_sq),
                               rtol=GRAD_NORM_RTOL)


def _check_envelope(got, want, names, steps=1, grads=None):
    """Parameters within ``steps`` Adam steps' lr envelope: at most 5e-4
    of them outside, none past 2 x; with ``grads``, every one whose
    gradient is at least GRAD_DECIDED inside."""
    outside = total = 0
    worst = 0.0
    for n in names:
        ratio = np.abs(got[n] - want[n]) / (steps * LR)
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        total += ratio.size
        if grads is not None:
            sure = np.abs(grads[n]) >= GRAD_DECIDED
            assert (ratio[sure] <= 1.0).all(), n
    print(f"{outside} of {total} parameters outside the lr envelope, worst "
          f"{worst:.3f} of it")
    assert outside <= 5e-4 * total and worst <= 2.0 + 1e-3


def _sub(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def test_self_train_step_matches_jax_global_batch(runs):
    """Two ranks of 2 rows each, the student's BatchNorm synchronised and
    the three losses over the global counts: the JAX step on the 4-row
    global batch (losses, gradients, parameters, the student's and the
    EMA teacher's buffers, prototypes and counts)."""
    (arrays, meta), _ = runs[0]
    want = runs[2]["st"]
    np.testing.assert_allclose(meta["st/losses"], want["losses"],
                               rtol=LOSS_RTOL)
    names = [k for k in _sub(arrays, "st/grad/")]
    grads = _sub(arrays, "st/grad/")
    _check_grads(grads, want["grads"], names)
    step1, ema1 = _sub(arrays, "st/step1/"), _sub(arrays, "st/ema1/")
    _check_envelope(step1, want["step1"], names, grads=want["grads"])
    for k, v in step1.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ema1[k]) == 2, k    # source, then target
        elif k not in grads:
            np.testing.assert_allclose(v, want["step1"][k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
            np.testing.assert_allclose(ema1[k], want["ema1"][k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
    for suffix in ("1", ""):
        np.testing.assert_array_equal(arrays[f"st/counts{suffix}"],
                                      want[f"counts{suffix}"])
        np.testing.assert_allclose(arrays[f"st/proto{suffix}"],
                                   want[f"proto{suffix}"], rtol=0,
                                   atol=STATE_ATOL)
    assert arrays["st/counts"].sum() > arrays["st/counts1"].sum() > 0


def test_gan_step_matches_jax_global_batch(runs):
    """The CycleGAN step with contour and module2 sem losses, the pools
    filling: the JAX fused step on the global batch (metrics of both
    steps, step-1 gradients, parameters and BatchNorm statistics of G and
    D, the pools' counts)."""
    (arrays, meta), _ = runs[0]
    want = runs[2]["gan"]
    for got_m, want_m in zip(meta["gan/fill/metrics"], want["metrics"]):
        assert got_m.keys() == want_m.keys()
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=METRIC_RTOL,
                                       err_msg=k)
    grads = _sub(arrays, "gan/fill/grad/")
    _check_grads(grads, want["grads"], list(grads))
    step1 = _sub(arrays, "gan/fill/step1/")
    _check_envelope(step1, want["step1"], list(grads))
    for k, v in step1.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v, want["step1"][k], rtol=0,
                                       atol=STATS_ATOL, err_msg=k)
    for n in ("t", "s"):
        assert int(arrays[f"gan/fill/pool/{n}/count"]) == \
            want["pool_counts"][n] == GAN_STEPS * WORLD * LOCAL


def test_gan_swap_regime_matches_one_process_joined_batch(runs):
    """Pools of 2 (the swap draws from the second image on): the two ranks
    equal the port's own one-process step on the joined batch (metrics,
    pools, parameters)."""
    (arrays, meta), _ = runs[0]
    metrics, _, _, final, pools = runs[2]["swap"]
    for got_m, want_m in zip(meta["gan/swap/metrics"], metrics):
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=SWAP_RTOL,
                                       err_msg=k)
    for k, v in pools.items():
        np.testing.assert_allclose(arrays[f"gan/swap/{k}"], v, rtol=0,
                                   atol=SWAP_RTOL, err_msg=k)
    got = _sub(arrays, "gan/swap/final/")
    names = list(_sub(arrays, "gan/swap/grad/"))
    _check_envelope(got, final, names, steps=GAN_STEPS)


def test_ranks_hold_identical_state(runs):
    """Both ranks' losses and metrics, and every array they kept
    (parameters, gradients, buffers, EMA teacher, prototypes, pools), bit
    for bit."""
    (_, m0), (_, m1) = runs[0]
    assert m0["st/losses"] == m1["st/losses"]
    for regime in ("fill", "swap"):
        assert m0[f"gan/{regime}/metrics"] == m1[f"gan/{regime}/metrics"]
    assert len(m0["digests"]) > 300
    assert m0["digests"] == m1["digests"]


@pytest.mark.parametrize("cli", ["st_cli", "gan_cli"])
def test_cli_preempts_together_and_rank_zero_writes(runs, cli):
    """Rank 1 alone is signalled before its second step: both ranks stop
    after one step, with the same losses, and process 0 alone writes (the
    self-trainer its best checkpoint after the first validation, then
    the preempt checkpoint, with the previous epoch and the prototypes)."""
    (_, m0), (_, m1) = runs[0]
    out = runs[1]
    for meta in (m0, m1):
        hist = meta[cli]["history"]
        assert [(h["steps"], h["preempted"]) for h in hist] == [(1, True)]
    assert m0[cli]["history"] == m1[cli]["history"]
    assert m1[cli]["saves"] == []
    if cli == "st_cli":
        assert len(m0[cli]["saves"]) == 2        # best, then preempt
        assert m0[cli]["history"][0]["validations"][0]["saved"]
        _, meta = load_seg_checkpoint(str(out / "cli" / "preempt_st.pth"))
        assert meta["epoch"] == 0 and "objective_vectors" in meta
        assert (out / "cli" / "bestst.pth").exists()
    else:
        assert len(m0[cli]["saves"]) == 1
        from thermal_semantic_segmentation_torch.cli._common import (
            load_gan_checkpoint)
        assert load_gan_checkpoint(str(out / "cli" / "preempt_g.pth"))[
            "epoch"] == -1


def test_gan_cli_refuses_the_host_pool_across_processes(runs):
    """The CLI's refusal comes from ``make_gan_steps`` itself, so a
    library caller meets it too."""
    for _, meta in runs[0]:
        assert "(-host_pool true) cannot run with several processes" in \
            meta["host_pool_refused"]
