"""Argparse pieces shared by the port's entry points (counterpart of the JAX
``cli/options.py``).

Flag names and defaults follow the JAX package, so a command line written for
it keeps its meaning. Flags whose host-side mode the port does not have yet
are refused at parse time, never silently ignored.
"""

from __future__ import annotations

import argparse

# host-side modes of the JAX package that the port has not ported yet: the
# flag and a test of its value that is true when the mode is asked for
NOT_YET_PORTED = {
    "data_parallel": bool,
    "distributed": bool,
    "native_decode": bool,
    "native_encode": bool,
    "wire": lambda v: v == "packed_bf16",
    "decode_cache_mb": bool,
    "decode_cache_dir": bool,
    "device_aug": bool,
    "bn_mode": lambda v: v == "per_replica",
    "remat": lambda v: v != "none",
}


class HostConfigParser(argparse.ArgumentParser):
    """ArgumentParser that applies host-side settings at parse time: a flag
    of ``NOT_YET_PORTED`` set to one of its refused values is an error, so
    no command line runs a different configuration than it asked for."""

    def parse_args(self, *a, **kw):  # type: ignore[override]
        args = super().parse_args(*a, **kw)
        for flag, refused in NOT_YET_PORTED.items():
            value = getattr(args, flag, None)
            if value is not None and refused(value):
                option = next(a.option_strings[0] for a in self._actions
                              if a.dest == flag)
                self.error(f"{option} {value} is not yet ported to the "
                           f"PyTorch package (see ROADMAP.md)")
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
    parser.add_argument('--freiburg_root', type=str, default='datasets/freiburg')
    parser.add_argument('--source_root', type=str,
                        default='datasets/source_dataset')
    parser.add_argument('--kitti_root', type=str, default='datasets/kitti')
    parser.add_argument('--flir_root', type=str,
                        default='datasets/target_dataset')
    parser.add_argument('--model_root_path', type=str,
                        default='./checkpoints/semantic_segmentation')
    parser.add_argument('--device', type=str, default='',
                        help='torch device to run on; empty = the CUDA '
                             'device (fails without one), "cpu" runs on the '
                             'CPU.')
    parser.add_argument('--bf16', type=str2bool, default=False,
                        help='run the forward under bfloat16 autocast.')
    parser.add_argument('--native_decode', type=str2bool, default=False,
                        help='not yet ported: refused when true.')
    parser.add_argument('--native_encode', type=str2bool, default=False,
                        help='not yet ported: refused when true.')
    parser.add_argument('--wire', type=str, default='packed',
                        choices=['none', 'packed', 'packed_bf16'],
                        help='host->device batch transfer: none and packed '
                             '(default) are both lossless and take the same '
                             'path here (pinned memory, non_blocking '
                             'copies); packed_bf16 is not yet ported.')
    parser.add_argument('--decode_cache_mb', type=float, default=0.0,
                        help='not yet ported: refused when not 0.')
    parser.add_argument('--decode_cache_dir', type=str, default='',
                        help='not yet ported: refused when set.')
    parser.add_argument('--remat', type=str, default='none',
                        choices=['none', 'dots', 'full'],
                        help='backbone rematerialization: only none is '
                             'ported; dots and full are refused.')
    parser.add_argument('--layers', type=lambda s: tuple(
                            int(x) for x in s.split(',')),
                        default=(3, 4, 23, 3),
                        help='ResNet backbone block counts, comma-separated '
                             '(default 3,4,23,3 = ResNet-101). A checkpoint '
                             'overrides it with its own.')
    parser.add_argument('--data_parallel', type=str2bool, default=False,
                        help='not yet ported: refused when true.')
    parser.add_argument('--distributed', type=str2bool, default=False,
                        help='not yet ported: refused when true.')
    parser.add_argument('--seed', type=int, default=0)


def seg_parse():
    """Segmentation training options (reference options.py:51-80)."""
    parser = HostConfigParser(description='segmentation options')
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('-load_model', type=str2bool, default=False)
    parser.add_argument('-epochs', type=int, default=50)
    parser.add_argument('-batch_size', type=int, default=8)
    parser.add_argument('-val_batch_size', type=int, default=8)
    parser.add_argument('-checkpoint_name', type=str,
                        default='256_cityscapes_rgb2freiburg_ir_segmentation.pth')
    parser.add_argument('-new_checkpoint_name', type=str,
                        default='256_cityscapes_rgb2freiburg_ir_segmentation.pth')
    parser.add_argument('-num_samples_show', type=int, default=3)
    parser.add_argument('-net_mode', type=str, default='one_channel')
    parser.add_argument('-dataset', type=str, default='cityscapes_translation')
    parser.add_argument('-num_classes', type=int, default=13)
    parser.add_argument('-lr', type=float, default=0.0001)
    parser.add_argument('-data_split', type=str2bool, default=False)
    parser.add_argument('-translation_name', type=str,
                        default='freiburg_rgb2ir_130epochs')
    parser.add_argument('-visualize_prediction', type=str2bool, default=False)
    parser.add_argument('-ignore_index', type=int, default=12)
    parser.add_argument('-generator_type', type=str, default='s2t')
    parser.add_argument('-t2s_folder', type=str,
                        default='test_cityscapes_rgb2freiburg_ir/')
    parser.add_argument('-baseline', type=str2bool, default=False)
    parser.add_argument('-source_domain', type=str, default='Thermal')
    parser.add_argument('-target_domain', type=str, default='Grayscale')
    parser.add_argument('-with_feat', type=str2bool, default=False)
    parser.add_argument('-logdir', type=str, default='./logs')
    parser.add_argument('-grayscale', type=str2bool, default=False)
    parser.add_argument('-log_interval', type=int, default=10)
    parser.add_argument('-max_steps', type=int, default=0)
    parser.add_argument('-device_aug', type=str2bool, default=False,
                        help='not yet ported: refused when true.')
    parser.add_argument('-lr_groups', type=str2bool, default=False,
                        help='1x backbone / 10x head LR split.')
    parser.add_argument('-bn_mode', type=str, default='sync',
                        choices=['sync', 'per_replica'],
                        help="batch-norm statistics: 'sync' (the one card's "
                             "batch); 'per_replica' is not yet ported.")
    parser.add_argument('-grad_accum', type=int, default=1,
                        help='microbatches per optimizer step (grads '
                             'averaged, BN statistics in sequence).')
    _add_roots(parser)
    return parser


def evaluation_parse():
    """Evaluation options (reference options.py:83-103)."""
    parser = HostConfigParser(description='segmentation options')
    parser.add_argument('--root', default='')
    parser.add_argument('-val_batch_size', type=int, default=1)
    parser.add_argument('-checkpoint_name', type=str,
                        default='256_freiburg_rgb2ir_segmentation.pth')
    parser.add_argument('-new_checkpoint_name', type=str, default='')
    parser.add_argument('-num_samples_show', type=int, default=3)
    parser.add_argument('-net_mode', type=str, default='one_channel')
    parser.add_argument('-dataset', type=str, default='freiburg_ir')
    parser.add_argument('-grayscale', type=str2bool, default=False)
    parser.add_argument('-num_classes', type=int, default=13)
    parser.add_argument('-data_split', type=str2bool, default=False)
    parser.add_argument('-translation_name', type=str,
                        default='cityscapes_rgb2freiburg_ir')
    parser.add_argument('-visualize_prediction', default=None)
    parser.add_argument('-ignore_index', type=int, default=12)
    parser.add_argument('-generator_type', type=str, default='s2t')
    parser.add_argument('-t2s_folder', type=str,
                        default='test_cityscapes_rgb2freiburg_ir/')
    parser.add_argument('-baseline', type=str2bool, default=False)
    parser.add_argument('-source_domain', type=str, default='Thermal')
    parser.add_argument('-target_domain', type=str, default='Grayscale')
    _add_roots(parser)
    return parser


def calc_proto_parse():
    """Prototype computation options (reference options.py:105-118).
    ``-normalize`` and ``-with_feat`` are accepted and unused, as in the JAX
    package."""
    parser = HostConfigParser(description='prototype computation options.')
    parser.add_argument('-normalize', type=float, nargs='+', default=[0.5])
    parser.add_argument('-net_mode', type=str, default='one_channel')
    parser.add_argument('-dataset', type=str, default='freiburg_ir')
    parser.add_argument('-num_classes', type=int, default=13)
    parser.add_argument('-root', type=str, default='')
    parser.add_argument('-epochs', type=int, default=4)
    parser.add_argument('-batch_size', type=int, default=64)
    parser.add_argument('-checkpoint_name', type=str,
                        default='freiburg_rgb2ir_cityscapes_segmentation.pth')
    parser.add_argument('-with_feat', type=str2bool, default=True)
    parser.add_argument('-max_steps', type=int, default=0)
    _add_roots(parser)
    return parser


def pseudo_generation_parse():
    """Pseudo-label generation options (reference
    generate_pseudo_label.py:101-108)."""
    parser = HostConfigParser(description="config")
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('--soft', type=str2bool, default=False)
    parser.add_argument('--flip', type=str2bool, default=False)
    parser.add_argument('-checkpoint_name',
                        default='256_freiburg_rgb2ir_segmentation.pth')
    parser.add_argument('-batch_size', type=int, default=4)
    parser.add_argument('--dataset', default='freiburg_ir')
    parser.add_argument('-pseudo_type', default='hard')
    parser.add_argument('-translation_name', type=str,
                        default='freiburg_rgb2ir_130epochs')
    parser.add_argument('-grayscale', type=str2bool, default=False)
    parser.add_argument('-max_steps', type=int, default=0)
    _add_roots(parser)
    return parser
