"""Argparse pieces shared by the port's entry points (counterpart of the JAX
``cli/options.py``).

Flag names and defaults follow the JAX package, so a command line written for
it keeps its meaning.
"""

from __future__ import annotations

import argparse


class HostConfigParser(argparse.ArgumentParser):
    """ArgumentParser that applies host-side settings at parse time, as the
    JAX parser does: ``--decode_cache_mb`` and ``--decode_cache_dir`` set the
    process's decode cache (``data/cache.py``); a command line with only
    ``--decode_cache_mb`` keeps a disk tier set before it.

    ``--distributed true`` joins the job's process group here, before any
    device use, as the JAX parser calls ``jax.distributed.initialize``
    (``parallel/mesh.init_distributed``: NCCL on the card, gloo with
    ``--device cpu``). An entry point whose JAX counterpart reads
    ``--data_parallel`` nowhere builds its parser with
    ``data_parallel=False`` and refuses that flag, as a flag that would
    change nothing."""

    def __init__(self, *a, data_parallel: bool = True, **kw):
        super().__init__(*a, **kw)
        self.data_parallel = data_parallel

    def parse_args(self, *a, **kw):  # type: ignore[override]
        args = super().parse_args(*a, **kw)
        if not self.data_parallel and getattr(args, "data_parallel", False):
            self.error("--data_parallel true is read nowhere by this entry "
                       "point, in the JAX package as here; --distributed "
                       "true spreads its work over cards")
        if getattr(args, "distributed", False):
            from ..parallel.mesh import init_distributed
            init_distributed(args.coordinator_address, args.num_processes,
                             args.process_id, device=args.device or None)
        mb = getattr(args, "decode_cache_mb", 0.0)
        disk = getattr(args, "decode_cache_dir", None)
        if mb or disk:
            from ..data.cache import set_decode_cache
            if disk:
                set_decode_cache(mb, disk_dir=disk)
            else:
                # no --decode_cache_dir here: keep a disk tier set earlier
                # in this process (None would clear it)
                set_decode_cache(mb)
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
    parser.add_argument('--gan_model_root_path', type=str,
                        default='./checkpoints')
    parser.add_argument('--device', type=str, default='',
                        help='torch device to run on; empty = the CUDA '
                             'device (fails without one), "cpu" runs on the '
                             'CPU.')
    parser.add_argument('--bf16', type=str2bool, default=False,
                        help='run the forward under bfloat16 autocast.')
    parser.add_argument('--native_decode', type=str2bool, default=False,
                        help='decode Freiburg frames a batch at a time with '
                             'the native C++ IO (data/native_loader.py; '
                             'bilinear resize, PIL BICUBIC stays the parity '
                             'default). Without the library: the port\'s own '
                             'PNG reader, sample by sample.')
    parser.add_argument('--native_encode', type=str2bool, default=False,
                        help='write translator frames and pseudo-label PNGs '
                             'a batch at a time with the native C++ IO. '
                             'Without the library: the Python writers.')
    parser.add_argument('--wire', type=str, default='packed',
                        choices=['none', 'packed', 'packed_bf16'],
                        help='host->device batch transfer: none and packed '
                             '(default) are both lossless and take the same '
                             'path here (pinned memory, non_blocking '
                             'copies); packed_bf16 ships float32 arrays as '
                             'bfloat16 (round to nearest even) and restores '
                             'float32 on the device: for --bf16 runs only, '
                             'others fall back to packed with a warning.')
    parser.add_argument('--decode_cache_mb', type=float, default=0.0,
                        help='in-RAM LRU of decoded frames (data/cache.py), '
                             'in MiB: epoch 2 on decodes nothing. 0 = off.')
    parser.add_argument('--decode_cache_dir', type=str, default='',
                        help='disk tier of the decode cache: decoded frames '
                             'kept as .npy under this directory, so a fresh '
                             'process decodes nothing either. Unbounded; '
                             'delete the directory to drop it. Empty = off.')
    parser.add_argument('--remat', type=str, default='none',
                        choices=['none', 'dots', 'full'],
                        help='backbone rematerialization in the backward '
                             'pass: none (default), dots (keep only the '
                             'convolution outputs), full (keep only block '
                             'inputs). Entry points that train no DeepLab '
                             'accept it and ignore it, as the JAX ones do.')
    parser.add_argument('--layers', type=lambda s: tuple(
                            int(x) for x in s.split(',')),
                        default=(3, 4, 23, 3),
                        help='ResNet backbone block counts, comma-separated '
                             '(default 3,4,23,3 = ResNet-101). A checkpoint '
                             'overrides it with its own.')
    parser.add_argument('--data_parallel', type=str2bool, default=False,
                        help='inference over every card this process '
                             'sees (CUDA_VISIBLE_DEVICES narrows them): '
                             'each batch split into contiguous shares, one '
                             'model copy per card; a batch that does not '
                             'divide over the cards shrinks the set with a '
                             'warning. The trainers shard their validation '
                             'with it: over the ranks under --distributed, '
                             'else over the cards.')
    parser.add_argument('--compile_cache_dir', type=str, default='auto',
                        help='accepted for the JAX package\'s command lines '
                             '(its persistent XLA compilation cache) and '
                             'changes nothing here: the port runs eagerly '
                             'and has no torch.compile to cache.')
    parser.add_argument('--distributed', type=str2bool, default=False,
                        help='join a multi-process job at parse time, one '
                             'process per card (NCCL; gloo with --device '
                             'cpu): trainers shard their data per process '
                             'and train data-parallel, offline CLIs '
                             'partition their datasets. From torchrun\'s '
                             'environment, or --coordinator_address/'
                             '--num_processes/--process_id.')
    parser.add_argument('--coordinator_address', type=str, default='',
                        help='with --distributed: "host:port" of process 0 '
                             '(empty = torchrun\'s environment, env://).')
    parser.add_argument('--num_processes', type=int, default=None,
                        help='with --distributed: the number of processes.')
    parser.add_argument('--process_id', type=int, default=None,
                        help='with --distributed: this process\'s rank.')
    parser.add_argument('--seed', type=int, default=0)


def train_parse():
    """GAN translation training options (reference options.py:4-24, with
    the JAX package's additions)."""
    parser = HostConfigParser(description='train options',
                              data_parallel=False)
    parser.add_argument('-batch_size', type=int, default=4)
    parser.add_argument('-sem_loss', type=str2bool, default=False)
    parser.add_argument('-load_model', type=str2bool, default=False)
    parser.add_argument('-checkpoint_name', type=str,
                        default='freiburg_rgb2ir.pth')
    parser.add_argument('-new_checkpoint_name', type=str,
                        default='cityscapes_rgb2freiburg_ir.pth')
    parser.add_argument('-source_dataset', type=str, default='kitti')
    parser.add_argument('-target_dataset', type=str, default='freiburg_ir')
    parser.add_argument('-lr', type=float, default=0.0001)
    parser.add_argument('-num_epoch', type=int, default=65)
    parser.add_argument('-grayscale', type=str2bool, default=False)
    parser.add_argument('-s2t_input_nc', type=int, default=3)
    parser.add_argument('-t2s_input_nc', type=int, default=1)
    parser.add_argument('-normalize', type=float, nargs='+',
                        default=[0.5, 0.5, 0.5])
    parser.add_argument('-with_contour', type=str2bool, default=False)
    parser.add_argument('-canny_thermal_threshold', type=float, default=1)
    parser.add_argument('-canny_rgb_threshold', type=float, default=2.5)
    parser.add_argument('-cycle', type=str2bool, default=True,
                        help='CycleGAN (main.py) vs one-direction GAN '
                             '(main_gan.py).')
    parser.add_argument('-host_pool', type=str2bool, default=False,
                        help='the host image pool between separate G and D '
                             'updates (the reference loop); default is one '
                             'update with the pool on the device. Refused '
                             'with --distributed true: the host pool has no '
                             'cross-process form.')
    parser.add_argument('-sem_checkpoint_s', type=str, default='',
                        help='the frozen RGB sem net: with -sem_mode legacy '
                             'a reference legacy .pth or the JAX package\'s '
                             'msgpack of one; with module2 a '
                             'segmentation_train checkpoint (.pth or '
                             'msgpack).')
    parser.add_argument('-sem_checkpoint_t', type=str, default='',
                        help='the frozen thermal sem net, likewise.')
    parser.add_argument('-sem_mode', type=str, default='legacy',
                        choices=('legacy', 'module2'),
                        help="frozen sem-net architecture: 'legacy' = the "
                             "reference's 19-class zoo DeepLabs (BGR "
                             "mean-subtracted [0, 255] input; random from "
                             "--seed without a checkpoint); 'module2' = the "
                             "seg trainer's checkpoints (architecture from "
                             "each checkpoint, [0, 1] input scale).")
    parser.add_argument('-log_interval', type=int, default=10)
    parser.add_argument('-ngf', type=int, default=64,
                        help='U-Net generator base width (the reference '
                             'hardcodes 64); the translator reads it from '
                             'the checkpoint.')
    parser.add_argument('-max_steps', type=int, default=0,
                        help='cap on steps per epoch (0 = unlimited).')
    parser.add_argument('-save_interval', type=int, default=1,
                        help='checkpoint every N epochs (the final epoch '
                             'always saves).')
    _add_roots(parser)
    return parser


def translation_parse():
    """Offline translator options (reference options.py:27-48)."""
    parser = HostConfigParser(description='translation options')
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('-dataset', type=str, default='Cityscapes')
    parser.add_argument('-batch_size', type=int, default=1)
    parser.add_argument('-checkpoint_name', type=str,
                        default='cityscapes_rgb2freiburg_ir.pth')
    parser.add_argument('-input_nc', type=int, default=3)
    parser.add_argument('-output_nc', type=int, default=1)
    parser.add_argument('-save_image_size', type=int, nargs=2,
                        default=[1024, 2048])
    parser.add_argument('-normalize', type=float, nargs='+',
                        default=[0.5, 0.5, 0.5])
    parser.add_argument('-denormalize', type=float, nargs='+', default=[0.5])
    parser.add_argument('-grayscale', type=str2bool, default=False)
    parser.add_argument('-generator_type', type=str, default='s2t')
    parser.add_argument('-translation_name_suffix', type=str,
                        default='cityscapes')
    _add_roots(parser)
    return parser


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
                        help='RandomResizedCrop + flip on the device inside '
                             'the train step (ops/augment.py): the host only '
                             'decodes full frames; validation resizes.')
    parser.add_argument('-lr_groups', type=str2bool, default=False,
                        help='1x backbone / 10x head LR split.')
    parser.add_argument('-bn_mode', type=str, default='sync',
                        choices=['sync', 'per_replica'],
                        help="batch-norm statistics under --distributed: "
                             "'sync' (the global batch's: the step is the "
                             "one-process step on the ranks' batches put "
                             "together) or 'per_replica' (each rank's own; "
                             "the running statistics averaged after each "
                             "step).")
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


def self_train_parse():
    """Self-training options (reference self_train_main.py:145-181), with
    the two the JAX ``cli/self_train_main.main`` adds:
    ``--initial_best_miou`` and ``--early_stop_patience``."""
    parser = HostConfigParser(description="config")
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('--resize', type=int, default=1200)
    parser.add_argument('--rcrop', type=int, nargs=2, default=[512, 256])
    parser.add_argument('--hflip', type=float, default=0.5)
    parser.add_argument('--proto_rectify', type=str2bool, default=True)
    parser.add_argument('--load_model', type=str2bool, default=True)
    parser.add_argument('-checkpoint_name',
                        default='256_freiburg_rgb2ir_segmentation.pth')
    parser.add_argument(
        '-new_checkpoint_name',
        default='256_freiburg_rgb2ir_tem_0.5_thres_0.3_segmentation.pth')
    parser.add_argument('-batch_size', type=int, default=4)
    parser.add_argument('--use_saved_pseudo', type=str2bool, default=True)
    parser.add_argument('--self_train', type=str2bool, default=True)
    parser.add_argument('--path_soft', type=str, default='')
    parser.add_argument('--path_lp', type=str, default='')
    parser.add_argument('-pseudo_type', default='soft')
    parser.add_argument('-translation_name', type=str,
                        default='freiburg_rgb2ir_130epochs')
    parser.add_argument('--epochs', type=int, default=10)
    parser.add_argument('--lr', type=float, default=0.000001)
    parser.add_argument('--num_classes', type=int, default=13)
    parser.add_argument('--ignore_index', type=int, default=12)
    parser.add_argument('--ema', type=str2bool, default=True)
    parser.add_argument('--proto_temperature', type=float, default=0.5)
    parser.add_argument('--train_thred', type=float, default=0)
    parser.add_argument('--rce', type=str2bool, default=True)
    parser.add_argument('--rce_alpha', type=float, default=0.1)
    parser.add_argument('--rce_beta', type=float, default=1.0)
    parser.add_argument('--moving_prototype', type=str2bool, default=True)
    parser.add_argument('--proto_momentum', type=float, default=0.0001)
    parser.add_argument('--visualize_prediction', default='save_one')
    parser.add_argument('--iter_counter', type=int, default=0)
    parser.add_argument('--baseline', type=str2bool, default=False)
    parser.add_argument('--generator_type', default=None)
    parser.add_argument('--target_dataset', default='freiburg_ir')
    parser.add_argument('--threshold', type=float, default=0.3)
    parser.add_argument('--val_interval', type=int, default=500)
    parser.add_argument('-max_steps', type=int, default=0)
    parser.add_argument('--initial_best_miou', type=float, default=0.0,
                        help='save threshold (the reference hardcodes 0.52, '
                             'self_train_main.py:53).')
    parser.add_argument('--early_stop_patience', type=int, default=0,
                        help='stop after N consecutive non-improving target '
                             'validations (0 = off, the reference '
                             'behaviour).')
    _add_roots(parser)
    return parser
