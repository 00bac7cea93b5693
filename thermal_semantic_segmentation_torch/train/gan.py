"""GAN translation training, CycleGAN and one-direction (counterpart of the
JAX ``train/gan.py``; reference train.py:87-262, train_gan.py:87-186).

The state is PyTorch's own: the generators ('s2t', 't2s') and the
discriminators ('t', 's') as modules, one Adam over the chained generator
parameters and one over the chained discriminator parameters. Images are
(N, H, W, C) float32 in [-1, 1], on the device; the nets are NCHW modules
in ``channels_last``, which an NHWC tensor's permuted view already is.

One update, in the reference's order (the JAX package's
``fused_passes=False``; its vmap-merged passes are a TPU rewrite that
``tests/test_gan.py::test_fused_passes_match_sequential`` shows equal):

  G: s2t(real_s) -> fake_t; with ``cycle``, t2s(fake_t) -> rec_s,
     t2s(real_t) -> fake_s, s2t(fake_s) -> rec_t. So the running
     statistics fold s2t's real_s then fake_s, and t2s's fake_t then
     real_t. The adversarial terms run D in train mode on batch
     statistics, but D's buffers stay as they are and its parameters take
     no gradient (the reference's ``set_requires_grad(d, False)``); the
     gradient still flows through D into the generators. Then the cycle
     L1s, the contour L1s (Canny edges; the gradient flows through the
     generated image's edges, the real image's are constants) and the
     semantic-consistency terms of the frozen sem nets (eval mode, no
     parameter gradient; their input's gradient flows). One backward, one
     Adam step.
  pool: the fakes go through the image pool.
  D: per discriminator, real then the pooled fake (detached), 0.5 x the
     sum of the two adversarial losses; one backward, one Adam step.

With ``cycle`` and ``sem``, the t2s semantic term labels each real thermal
frame with the frozen thermal net's classes: the ``upsample_argmax``
kernel on its stride-8 logits (the JAX package's ``argmax`` of the
upsampled logits). The s2t and t2s terms that need a gradient upsample
with ``ops/resize.upsample_logits``. Nothing waits for the device: the
metrics come back as device tensors.

Under a ``mesh`` (``parallel/mesh.DataMesh``, one rank per card) the step
is the JAX step on the global batch, the ranks' batches in rank order:
- every BatchNorm of G and D normalises over the global batch
  (``nn/resnet.synchronised``), D's read-only pass in G's update too; the
  frozen sem nets run in eval mode and need nothing;
- each rank's loss is its share of the global batch's: the LSGAN, cycle
  and contour means are over equal-sized rank batches, so the global mean
  is the ranks' means averaged and each rank takes its mean / world; the
  semantic terms are CEs with ignored pixels, whose share is the rank's
  NLL sum over the all-reduced valid count;
- G is used twice in the cycle and D takes no gradient in G's update, so
  no DDP wrapper: after each backward ``all_reduce_grads`` sums the
  ranks' gradients;
- the device pools: every rank all-gathers the detached fakes into
  global order and queries an identically seeded pool with them, then
  feeds its own rows to D, so the pools' contents and counts stay
  bit-equal on every rank. The host pool (``make_gan_steps``) has no
  cross-process form in the JAX package, so the CLIs refuse it there.
The metrics come back as the global batch's on every rank.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..losses import GAN_LOSSES, l1_loss, semantic_consistency_terms
from ..nn.canny import canny_edges
from ..nn.resnet import synchronised
from ..ops.image_pool import DevicePool
from ..ops.resize import upsample_logits
from ..parallel import mesh as pmesh
from .seg import forward_nhwc

_BGR_MEAN = (104.00698793, 116.66876762, 122.67891434)
_THERMAL_MEAN = 116.66876762


@dataclass
class GanTrainState:
    g: Dict[str, nn.Module]
    d: Dict[str, nn.Module]
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0


def create_gan_state(*, g_nets: Dict[str, nn.Module],
                     d_nets: Dict[str, nn.Module], learning_rate: float,
                     device=None) -> GanTrainState:
    """Adam (optax's defaults: 0.9, 0.999, eps 1e-8) over the chained
    generator parameters and over the chained discriminator parameters.
    The nets must lie on ``device`` (default: the CUDA device; raises
    without one)."""
    device = resolve_device(device)
    nets = [*g_nets.values(), *d_nets.values()]
    if any(p.device != device for net in nets for p in net.parameters()):
        raise ValueError(f"the GAN nets' parameters are not all on {device}")

    def adam(group):
        return torch.optim.Adam([p for net in group.values()
                                 for p in net.parameters()],
                                lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)

    return GanTrainState(g=dict(g_nets), d=dict(d_nets), opt_g=adam(g_nets),
                         opt_d=adam(d_nets))


def _gray(x: torch.Tensor) -> torch.Tensor:
    """torchvision Grayscale luminance of NHWC RGB (1 channel passes)."""
    if x.shape[-1] == 1:
        return x
    return (x[..., 0:1] * 0.299 + x[..., 1:2] * 0.587) + x[..., 2:3] * 0.114


def gan_to_seg_tensor(x: torch.Tensor, domain: str,
                      mode: str = "legacy") -> torch.Tensor:
    """The reference's tensor_transmit (train.py:60-75): de-normalise a GAN
    image (mean = std = 0.5) for a frozen sem net. 'module2' gives the
    seg trainer's [0, 1] scale; 'legacy' the reference's zoo nets' input
    ([0, 255], source RGB -> BGR minus the ImageNet mean, target minus the
    thermal mean)."""
    if domain not in ("source", "target"):
        raise ValueError(domain)
    if mode == "module2":
        return x * 0.5 + 0.5
    x = (x * 0.5 + 0.5) * 255.0
    if domain == "source":
        return x.flip(-1) - torch.tensor(_BGR_MEAN, dtype=x.dtype,
                                         device=x.device)
    return x - _THERMAL_MEAN


def _nhwc(net: nn.Module, x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """An NCHW net on an NHWC image: the channels_last view in, the float32
    NHWC view out."""
    with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
        out = net(x.permute(0, 3, 1, 2))
    return out.float().permute(0, 2, 3, 1)


@contextlib.contextmanager
def _read_only(nets):
    """Train-mode forwards of ``nets`` on batch statistics that leave every
    buffer as it was, with no gradient for their parameters."""
    norms = [m for net in nets for m in net.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    params = [p for net in nets for p in net.parameters()]
    for m in norms:
        m.track_running_stats = False
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for m in norms:
            m.track_running_stats = True
        for p in params:
            p.requires_grad_(True)


def _make_gan_cores(*, cycle: bool = True, gan_loss: str = "lsgan",
                    cycle_weight: float = 10.0, with_contour: bool = False,
                    grayscale_source: bool = False,
                    canny_rgb_threshold: float = 2.5,
                    canny_thermal_threshold: float = 1.0,
                    contour_detached: bool = False,
                    sem_nets: Optional[Dict[str, nn.Module]] = None,
                    sem_ignore_classes: Sequence[int] = (),
                    sem_norm: str = "legacy", bf16: bool = False,
                    mesh=None):
    """(g_core, d_core), the updates shared by ``make_gan_steps`` and
    ``make_gan_step``; the arguments are the JAX ``_make_gan_cores``'s,
    with the frozen sem nets as modules ({'s': RGB net, 't': thermal
    net}, eval mode), and ``mesh`` as the module docstring says."""
    gan_adv = GAN_LOSSES[gan_loss]
    world = mesh.size if mesh is not None else 1
    group = mesh.group if mesh is not None else None

    def share(mean):
        """This rank's share of a mean over the global batch."""
        return mean if world == 1 else mean / world

    def adv(prediction, real):
        return share(gan_adv(prediction, real))

    def l1(a, b):
        return share(l1_loss(a, b))

    def global_metrics(metrics):
        """The global batch's metrics: the sum of the ranks' shares."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is None:
            return metrics
        total = pmesh.all_reduce(torch.stack(list(metrics.values())),
                                 group=group)
        return dict(zip(metrics, total.unbind()))

    def all_reduce_grads(nets):
        if mesh is not None:
            pmesh.all_reduce_grads(
                [p for net in nets for p in net.parameters()], group)

    def g_core(state: GanTrainState, real_s, real_t, label_s=None, *,
               with_sem: bool = False, mark: Callable[[str], None]):
        g, d = state.g, state.d
        for net in (*g.values(), *d.values()):
            net.train()
        state.opt_g.zero_grad(set_to_none=True)
        metrics, outs = {}, {}
        with _read_only(d.values()), synchronised(
                [*g.values(), *d.values()], group):
            fake_t = _nhwc(g["s2t"], real_s, bf16)
            if cycle:
                rec_s = _nhwc(g["t2s"], fake_t, bf16)
                fake_s = _nhwc(g["t2s"], real_t, bf16)
                rec_t = _nhwc(g["s2t"], fake_s, bf16)
                outs["fake_s"] = fake_s
            outs["fake_t"] = fake_t
            loss = metrics["g_s2t"] = adv(_nhwc(d["t"], fake_t, bf16), True)
            if cycle:
                metrics["g_t2s"] = adv(_nhwc(d["s"], fake_s, bf16), True)
                metrics["cycle_s"] = l1(rec_s, real_s) * cycle_weight
                metrics["cycle_t"] = l1(rec_t, real_t) * cycle_weight
                loss = (loss + metrics["g_t2s"] + metrics["cycle_s"]
                        + metrics["cycle_t"])
            mark("g_forward")

            if with_contour:
                with torch.no_grad():
                    contour_real_s = canny_edges(
                        real_s if grayscale_source else _gray(real_s),
                        threshold=canny_rgb_threshold)
                    contour_real_t = canny_edges(
                        real_t, threshold=canny_thermal_threshold)
                edges = canny_edges(fake_t, threshold=canny_thermal_threshold)
                if contour_detached:
                    edges = edges.detach()
                metrics["con_s2t"] = l1(contour_real_s, edges)
                loss = loss + metrics["con_s2t"]
                if cycle:
                    edges = canny_edges(
                        fake_s if grayscale_source else _gray(fake_s),
                        threshold=canny_rgb_threshold)
                    if contour_detached:
                        edges = edges.detach()
                    metrics["con_t2s"] = l1(contour_real_t, edges)
                    loss = loss + metrics["con_t2s"]
                mark("canny")

            if with_sem:
                h, w = real_s.shape[1:3]

                def sem_logits(name, x, domain):
                    return forward_nhwc(sem_nets[name], gan_to_seg_tensor(
                        x, domain, sem_norm), bf16=bf16)["out"]

                terms = {"sem_s2t": semantic_consistency_terms(
                    upsample_logits(sem_logits("t", fake_t, "target"), h, w),
                    label_s, ignore_classes=sem_ignore_classes)}
                if cycle:
                    with torch.no_grad():
                        ids, _ = upsample_argmax(
                            sem_logits("t", real_t, "target"), h, w)
                    terms["sem_t2s"] = semantic_consistency_terms(
                        upsample_logits(sem_logits("s", fake_s, "source"),
                                        h, w),
                        ids, ignore_classes=sem_ignore_classes)
                counts = torch.stack([c for _, c in terms.values()])
                if mesh is not None:
                    counts = pmesh.all_reduce(counts, group=group)
                for (k, (nll_sum, _)), count in zip(terms.items(), counts):
                    # the NLL sum over the global batch's valid count
                    metrics[k] = nll_sum / count.clamp_min(1)
                    loss = loss + metrics[k]
                mark("sem")

            loss.backward()
        all_reduce_grads(g.values())
        mark("g_backward")
        state.opt_g.step()
        mark("g_adam")
        state.step += 1
        metrics["loss_g"] = loss
        return (global_metrics(metrics),
                {k: v.detach() for k, v in outs.items()})

    def d_core(state: GanTrainState, reals: Dict[str, torch.Tensor],
               pooled_fakes: Dict[str, torch.Tensor], *,
               mark: Callable[[str], None]):
        state.opt_d.zero_grad(set_to_none=True)
        metrics, total = {}, 0.0
        with synchronised(state.d.values(), group):
            for which, real in reals.items():
                net = state.d[which]
                out_real = _nhwc(net, real, bf16)
                out_fake = _nhwc(net, pooled_fakes[which].detach(), bf16)
                loss_d = 0.5 * (adv(out_real, True) + adv(out_fake, False))
                metrics[f"d_{which}"] = loss_d
                total = total + loss_d
            total.backward()
        all_reduce_grads(state.d.values())
        state.opt_d.step()
        mark("d_step")
        return global_metrics(metrics)

    return g_core, d_core


def _no_mark(stage: str) -> None:
    pass


def make_gan_steps(**kwargs):
    """(g_step, d_step), the two updates with a host pool between them
    (the reference's loop, ``-host_pool true``); a ``mesh`` of more than
    one rank is refused, since the JAX host pool has no cross-process
    form:

      g_step(state, real_s, real_t, label_s=None, *, with_sem=False,
             mark=None) -> (metrics, outs)
      d_step(state, reals, pooled_fakes, *, mark=None) -> metrics

    ``outs`` holds the detached 'fake_t' (and 'fake_s'). See
    ``_make_gan_cores`` for the arguments."""
    mesh = kwargs.get("mesh")
    if mesh is not None and mesh.size > 1:
        raise ValueError(
            "the host pool (-host_pool true) cannot run with several "
            "processes: the JAX host pool has no cross-process form (see "
            "ROADMAP.md); use make_gan_step's device pools, which every "
            "rank keeps equal")
    g_core, d_core = _make_gan_cores(**kwargs)

    def g_step(state, real_s, real_t, label_s=None, *, with_sem=False,
               mark=None):
        return g_core(state, real_s, real_t, label_s, with_sem=with_sem,
                      mark=mark or _no_mark)

    def d_step(state, reals, pooled_fakes, *, mark=None):
        return d_core(state, reals, pooled_fakes, mark=mark or _no_mark)

    return g_step, d_step


def make_gan_step(*, pool_size: int = 50, **kwargs):
    """One update: G, the device pools, D (counterpart of the JAX
    ``make_fused_gan_step``, whose passes it runs in the reference's
    order). Returns (step, make_pools):

      step(state, pools, real_s, real_t, label_s=None, *, with_sem=False,
           mark=None) -> (metrics, outs)
      make_pools(shapes: {name: (H, W, C)}, *, device, seed=0)
           -> {name: DevicePool}

    ``mark``, when given, is called with each stage's name once the stage
    is queued: 'g_forward', 'canny' (with the contour loss), 'sem' (with
    the sem loss), 'g_backward', 'g_adam', 'pool', 'd_step'. Nothing waits
    for the device. Under a ``mesh`` every rank's pools see the global
    batch's fakes (the module docstring)."""
    cycle = kwargs.get("cycle", True)
    mesh = kwargs.get("mesh")
    g_core, d_core = _make_gan_cores(**kwargs)

    def query(pool, fakes):
        if mesh is None:
            return pool.query(fakes)
        n = fakes.shape[0]
        pooled = pool.query(pmesh.gather_rows(fakes, mesh.group))
        return pooled[mesh.rank * n:(mesh.rank + 1) * n]

    def step(state, pools, real_s, real_t, label_s=None, *, with_sem=False,
             mark=None):
        mark = mark or _no_mark
        metrics, outs = g_core(state, real_s, real_t, label_s,
                               with_sem=with_sem, mark=mark)
        reals = {"t": real_t}
        fakes = {"t": query(pools["t"], outs["fake_t"])}
        if cycle:
            reals["s"] = real_s
            fakes["s"] = query(pools["s"], outs["fake_s"])
        mark("pool")
        metrics.update(d_core(state, reals, fakes, mark=mark))
        return metrics, outs

    def make_pools(shapes, *, device, seed: int = 0):
        return {name: DevicePool(pool_size, shape, device=device,
                                 seed=seed + i)
                for i, (name, shape) in enumerate(sorted(shapes.items()))}

    return step, make_pools
