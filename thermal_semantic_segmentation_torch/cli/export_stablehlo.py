"""Export a segmentation or generator checkpoint as a self-contained
``torch.export`` artifact (the JAX ``cli/export_stablehlo.py``'s module name
and flags, so that a JAX command line maps onto this module; the artifact it
writes is a ``torch.export`` program, not StableHLO).

    python -m thermal_semantic_segmentation_torch.cli.export_stablehlo \
        -checkpoint_name best_256_freiburg_segmentation.pth \
        --out model_ids.pt2 --batch dynamic --check true

The artifact holds the weights and the whole eval-protocol forward
(align-corners upsample to 256x512 and the argmax, through the
``upsample_argmax`` kernel) and runs through ``core/export.load_exported``
with no model code and no checkpoint; ``cli/serve.py --artifact`` serves it.
``--batch dynamic`` (default) exports a symbolic batch. A ``<out>.json``
sidecar records the calling convention. The export runs on ``--device``
(the CUDA device by default); the program runs on CUDA and on the CPU. See
core/export.py.
"""

from __future__ import annotations

import json
import os

from ..core.export import PLATFORMS

JAX_DEFAULT_PLATFORMS = "tpu,cpu"


def export_stablehlo_parse():
    from .options import HostConfigParser, _add_roots, str2bool

    parser = HostConfigParser(
        description="export a seg/generator checkpoint to a torch.export "
                    "artifact", data_parallel=False)
    parser.add_argument("--kind", type=str, default="seg",
                        choices=["seg", "generator"],
                        help="'seg': eval-protocol segmenter forward; "
                             "'generator': GAN translator forward "
                             "(normalized image in, tanh image out)")
    parser.add_argument("-checkpoint_name", type=str,
                        default="256_freiburg_segmentation.pth")
    parser.add_argument("-net_mode", type=str, default="one_channel")
    parser.add_argument("-num_classes", type=int, default=13)
    parser.add_argument("-generator_type", type=str, default="s2t",
                        choices=["s2t", "t2s"],
                        help="which generator to export from a GAN ckpt")
    parser.add_argument("-input_nc", type=int, default=3)
    parser.add_argument("-output_nc", type=int, default=1)
    parser.add_argument("--out", type=str, default="",
                        help="artifact path (default: <ckpt-stem>_<output>"
                             ".pt2 next to the checkpoint)")
    parser.add_argument("--output", type=str, default="ids",
                        choices=["ids", "logits"],
                        help="'ids': uint8 argmax classes (serving payload); "
                             "'logits': float32 upsampled logits")
    parser.add_argument("--batch", type=str, default="dynamic",
                        help="'dynamic' (symbolic batch dim) or a fixed int")
    parser.add_argument("--quantize", type=str, default="",
                        choices=["", "int8"],
                        help="weight-only storage quantization: conv/dense "
                             "weights become int8 + per-channel scales in a "
                             "container beside the program (~4x smaller); "
                             "compute stays float, the weights are "
                             "dequantized once at load (core/export.py)")
    parser.add_argument("--platforms", type=str,
                        default=JAX_DEFAULT_PLATFORMS,
                        help="the JAX package's lowering targets: a program "
                             "of this package runs on cuda and cpu and "
                             "records both. Any subset of cuda,cpu is "
                             "accepted, and tpu,cpu (the JAX default) so "
                             "that a JAX command line runs; any other value "
                             "naming tpu is refused.")
    parser.add_argument("--check", type=str2bool, default=True,
                        help="load the written artifact back and compare it "
                             "against the direct forward on random pixels "
                             "(on --device)")
    _add_roots(parser)
    return parser


def check_platforms(value: str, parser) -> None:
    """Refuse a ``--platforms`` value that asks for more than a program of
    this package runs on (the sidecar records cuda and cpu whatever the
    value)."""
    asked = [p.strip() for p in value.split(",") if p.strip()]
    if ",".join(asked) == JAX_DEFAULT_PLATFORMS:
        return
    if "tpu" in asked:
        parser.error(f"--platforms {value}: a torch.export program runs on "
                     f"cuda and cpu, not on a TPU (tpu,cpu, the JAX "
                     f"package's default, is accepted and records "
                     f"cuda,cpu)")
    unknown = sorted(set(asked) - set(PLATFORMS))
    if unknown or not asked:
        parser.error(f"--platforms {value}: expected a subset of "
                     f"{','.join(PLATFORMS)}")


def main(argv=None):
    """Export, write and (``--check``) self-check; returns {'artifact',
    'sidecar', 'export_s', 'save_s', 'check'} (the self-check's number,
    None without ``--check``)."""
    import time

    from ..core.export import (HW, _self_check, default_artifact_name,
                               dequantized_model, export_generator_forward,
                               export_seg_forward, load_exported,
                               save_exported)

    parser = export_stablehlo_parse()
    args = parser.parse_args(argv)
    check_platforms(args.platforms, parser)
    batch = None if args.batch == "dynamic" else int(args.batch)
    quantize = args.quantize or None
    device = args.device or None

    start = time.perf_counter()
    if args.kind == "seg":
        from ._common import (apply_model_meta, build_deeplab,
                              load_seg_checkpoint)

        state_dict, meta = load_seg_checkpoint(
            os.path.join(args.model_root_path, args.checkpoint_name))
        apply_model_meta(args, meta)
        model = build_deeplab(args, device=device)
        model.load_state_dict(state_dict, strict=True)
        channels = 1 if args.net_mode == "one_channel" else 3
        exported = export_seg_forward(
            model, channels=channels, batch=batch, output=args.output,
            quantize=quantize, bf16=args.bf16)
        extra = {"output_kind": args.output,
                 "num_classes": int(args.num_classes), "channels": channels}
        stem = args.output + ("_int8" if quantize else "")
    else:
        from ._common import build_generator_from_gan_checkpoint

        model, ngf = build_generator_from_gan_checkpoint(
            os.path.join(args.gan_model_root_path, args.checkpoint_name),
            args.generator_type, input_nc=args.input_nc,
            output_nc=args.output_nc, device=device)
        channels = args.input_nc
        exported = export_generator_forward(
            model, channels=channels, batch=batch, quantize=quantize,
            bf16=args.bf16)
        extra = {"output_kind": "translation",
                 "generator_type": args.generator_type, "ngf": ngf,
                 "channels": channels, "output_nc": args.output_nc}
        stem = f"g_{args.generator_type}" + ("_int8" if quantize else "")

    export_s = time.perf_counter() - start
    out = args.out or os.path.join(
        args.model_root_path if args.kind == "seg"
        else args.gan_model_root_path,
        default_artifact_name(args.checkpoint_name, stem))
    start = time.perf_counter()
    sidecar = save_exported(exported, out, meta={
        "checkpoint": args.checkpoint_name, "bf16": bool(args.bf16),
        **extra})
    save_s = time.perf_counter() - start
    print(json.dumps({"artifact": out, **sidecar}))
    result = {"artifact": out, "sidecar": sidecar, "export_s": export_s,
              "save_s": save_s, "check": None}

    if args.check:
        output = args.output if args.kind == "seg" else "image"
        # bf16 compute rounds with ~2^-8 relative precision on the tanh
        # range; float32 exports must agree far tighter
        tol = 1e-2 if args.bf16 else 1e-4
        # an int8 container's contract is the DEQUANTIZED model: the drift
        # from float32 is the user's accuracy trade, not an export defect
        check_model = dequantized_model(model) if quantize else model
        diff = _self_check(load_exported(out), channels, HW, batch,
                           check_model, output, tol=tol, bf16=args.bf16)
        kind = {"ids": "near-tie argmax flips",
                "logits": "max abs logit diff",
                "image": "max abs image diff"}[output]
        print(f"self-check passed ({kind}: {diff:.3e})")
        result["check"] = diff
    return result


if __name__ == "__main__":
    main()
