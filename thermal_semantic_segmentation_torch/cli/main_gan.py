"""One-direction s2t GAN training (counterpart of the JAX
``cli/main_gan.py``; reference main_gan.py / train_gan.py): ``cli/main``'s
loop with the cycle off, one generator and one discriminator.

    python -m thermal_semantic_segmentation_torch.cli.main_gan [flags]
"""

from __future__ import annotations

from ..device import resolve_device
from ..utils.preempt import GracefulShutdown
from .main import gan_main
from .options import train_parse


def main(argv=None):
    args = train_parse().parse_args(argv)
    args.cycle = False
    resolve_device(args.device or None)   # no card and no --device: raise
    with GracefulShutdown() as shutdown:
        return gan_main(args, shutdown=shutdown)


if __name__ == "__main__":
    main()
