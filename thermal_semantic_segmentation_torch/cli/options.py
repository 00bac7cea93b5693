"""Argparse pieces shared by the port's entry points (counterpart of the JAX
``cli/options.py``).

Flag names and defaults follow the JAX package, so a command line written for
it keeps its meaning. Flags whose host-side mode the port does not have yet
are refused at parse time, never silently ignored.
"""

from __future__ import annotations

import argparse

# host-side modes of the JAX package that the port has not ported yet
NOT_YET_PORTED = ("data_parallel",)


class HostConfigParser(argparse.ArgumentParser):
    """ArgumentParser that applies host-side settings at parse time: a flag
    of ``NOT_YET_PORTED`` set to true is an error, so no command line runs a
    different configuration than it asked for."""

    def parse_args(self, *a, **kw):  # type: ignore[override]
        args = super().parse_args(*a, **kw)
        for flag in NOT_YET_PORTED:
            if getattr(args, flag, False):
                self.error(f"--{flag} is not yet ported to the PyTorch "
                           f"package (see ROADMAP.md)")
        return args


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0", ""):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _add_roots(parser: argparse.ArgumentParser):
    parser.add_argument('--model_root_path', type=str,
                        default='./checkpoints/semantic_segmentation')
    parser.add_argument('--device', type=str, default='',
                        help='torch device to run on; empty = the CUDA '
                             'device (fails without one), "cpu" runs on the '
                             'CPU.')
    parser.add_argument('--bf16', type=str2bool, default=False,
                        help='run the forward under bfloat16 autocast.')
    parser.add_argument('--layers', type=lambda s: tuple(
                            int(x) for x in s.split(',')),
                        default=(3, 4, 23, 3),
                        help='ResNet backbone block counts, comma-separated '
                             '(default 3,4,23,3 = ResNet-101). A checkpoint '
                             'overrides it with its own.')
    parser.add_argument('--data_parallel', type=str2bool, default=False,
                        help='not yet ported: refused when true.')
    parser.add_argument('--seed', type=int, default=0)
