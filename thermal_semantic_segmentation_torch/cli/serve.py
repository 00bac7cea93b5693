"""Batch inference server, on the CUDA device (counterpart of the JAX
``cli/serve.py``): load a checkpoint or an exported artifact once, keep it on
the card, and serve over HTTP with micro-batching (concurrent requests
coalesce into fixed-size padded batches, up to a latency budget).

    python -m thermal_semantic_segmentation_torch.cli.serve \
        -checkpoint_name s.pth --port 8756 -batch_size 8

Endpoints:
  GET  /healthz            -> {"status": "ok", ...}
  POST /segment            -> palette PNG of the predicted classes
  POST /segment?format=ids -> 8-bit PNG of raw class ids
  POST /segment?format=json-> {"class_counts": {...}, "shape": [H, W]}
  POST /segment_stream     -> many images in ONE request, results streamed
                              back in order (chunked encoding; framing in
                              serving/codec.py)

With ``--kind translator`` the server loads a GAN generator from a GAN
checkpoint (a ``.pth`` or the JAX package's msgpack) and serves ``POST
/translate`` and ``POST /translate_stream`` (a PNG of the translated image),
the online counterpart of the offline ``cli/translator.py``: the same
``(x - m) / m`` input and ``clip((y * d + d) * 255)`` output.

With ``--artifact <file>`` it serves an artifact of
``cli/export_stablehlo.py`` (a ``torch.export`` program; no model code or
checkpoint): the sidecar's ``output_kind`` selects the endpoints, ``ids``
as the seg kind, ``translation`` as the translator kind.

Input: PNG bytes, read by the port's own decoder (no PIL); JPEG bytes need
PIL on the host, and without it are answered 400. 16-bit images get the
Freiburg IR radiometric window; 8-bit images are scaled to [0, 1];
everything is resized to 256x512.
``--data_parallel true`` splits every coalesced batch over the cards this
process sees (``parallel/mesh.LocalMesh``, shrunk to a count that divides
``-batch_size``), one model or program copy on each. ``--distributed true``
joins the job's process group at parse time, as every CLI of the package
does; each process then serves its own card (its cards under
``--data_parallel``) on its own ``--port``, as the JAX server only joins the
runtime.
"""

from __future__ import annotations

import os
from http.server import ThreadingHTTPServer

from ..serving.batcher import InferenceServer
from ..serving.endpoints import make_handler

TRANSLATE_ENDPOINTS = ("/translate", "/translate_stream")
TRANSLATE_FORMATS = ("palette", "png")     # both mean PNG here


def serve_parse():
    from .options import HostConfigParser, _add_roots
    parser = HostConfigParser(description="segmentation/translation "
                                          "inference server")
    parser.add_argument("--kind", type=str, default="seg",
                        choices=["seg", "translator"],
                        help="'seg': POST /segment[_stream] class maps; "
                             "'translator': POST /translate[_stream] GAN-"
                             "translated images (online cli/translator.py)")
    parser.add_argument("--artifact", type=str, default="",
                        help="serve an artifact of cli/export_stablehlo.py "
                             "instead of a checkpoint: the weights live in "
                             "it, its sidecar selects the endpoints")
    parser.add_argument("-checkpoint_name", type=str,
                        default="256_freiburg_segmentation.pth")
    parser.add_argument("-net_mode", type=str, default="one_channel")
    parser.add_argument("-num_classes", type=int, default=13)
    parser.add_argument("-generator_type", type=str, default="s2t",
                        choices=["s2t", "t2s"])
    parser.add_argument("-input_nc", type=int, default=3)
    parser.add_argument("-output_nc", type=int, default=1)
    parser.add_argument("-normalize", type=float, nargs="+",
                        default=[0.5, 0.5, 0.5])
    parser.add_argument("-denormalize", type=float, nargs="+", default=[0.5])
    parser.add_argument("-batch_size", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=10.0,
                        help="micro-batching latency budget after the first "
                             "request of a batch arrives.")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8756)
    _add_roots(parser)
    return parser


def _mesh(args):
    from ._common import maybe_data_parallel
    return maybe_data_parallel(args, args.batch_size, "serving")


def build_seg_server(args) -> InferenceServer:
    """Checkpoint -> model on ``args.device`` -> a (not yet started)
    InferenceServer; what ``main`` serves for ``--kind seg``."""
    from ._common import (apply_model_meta, build_deeplab,
                          load_seg_checkpoint)

    state_dict, meta = load_seg_checkpoint(
        os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)
    device = args.device or None
    model = build_deeplab(args, device=device)
    model.load_state_dict(state_dict, strict=True)
    return InferenceServer(
        model, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        channels=1 if args.net_mode == "one_channel" else 3,
        bf16=args.bf16, device=device, mesh=_mesh(args))


def build_translation_server(args):
    """GAN checkpoint -> generator on ``args.device`` -> (a not yet started
    InferenceServer, the handler's keyword arguments) for ``--kind
    translator``."""
    from ..serving.codec import make_translation_fns
    from ._common import build_generator_from_gan_checkpoint

    device = args.device or None
    model, _ = build_generator_from_gan_checkpoint(
        os.path.join(args.gan_model_root_path, args.checkpoint_name),
        args.generator_type, input_nc=args.input_nc,
        output_nc=args.output_nc, device=device)
    pre, predict, encode = make_translation_fns(
        channels=args.input_nc, normalize=args.normalize,
        denormalize=args.denormalize, bf16=args.bf16)
    server = InferenceServer(
        model, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        channels=args.input_nc, device=device, mesh=_mesh(args),
        predict_fn=predict, preprocess_fn=pre)
    return server, dict(encode=encode, endpoints=TRANSLATE_ENDPOINTS,
                        formats=TRANSLATE_FORMATS)


def server_from_artifact(args):
    """Serve an artifact of ``cli/export_stablehlo.py`` (JAX
    ``_server_from_artifact``): no model code or checkpoint, the weights
    live in it. Its sidecar's ``output_kind`` selects the endpoints:
    ``ids`` serves ``/segment``, ``translation`` serves ``/translate``;
    ``logits`` is refused. A fixed-batch artifact is refused unless
    ``-batch_size`` equals its batch. ``--data_parallel`` needs a symbolic
    batch and loads one program copy for each device of the mesh. The
    wire dtype follows the artifact's input, not ``--bf16``. Returns (a not
    yet started InferenceServer, the handler's keyword arguments)."""
    from ..core.export import exported_sidecar, load_exported
    from ..device import resolve_device
    from ..serving.codec import make_translation_fns

    sidecar = exported_sidecar(args.artifact)
    spec = sidecar["input"][0]
    batch_dim = spec["shape"][0]
    if batch_dim != "b" and int(batch_dim) != args.batch_size:
        raise SystemExit(
            f"artifact has a fixed batch of {batch_dim}; pass "
            f"-batch_size {batch_dim} or re-export with --batch dynamic")
    if spec["dtype"] != "float32":
        raise SystemExit(f"artifact input dtype {spec['dtype']!r}: the "
                         f"server feeds float32")
    hw = (int(spec["shape"][1]), int(spec["shape"][2]))
    channels = int(spec["shape"][3])
    device = resolve_device(args.device or None)
    mesh = _mesh(args)
    if mesh is not None and mesh.size > 1 and batch_dim != "b":
        raise SystemExit(
            "--data_parallel artifact serving needs a symbolic batch (each "
            "device runs batch_size/n_devices rows): re-export with "
            "--batch dynamic")
    kind = sidecar.get("output_kind", "ids")
    if kind not in ("ids", "translation"):
        raise SystemExit(f"artifact output_kind {kind!r} is not servable "
                         f"(logits artifacts are for downstream soft use)")
    first = load_exported(args.artifact, device=device)
    programs = {d: first.to(d) for d in
                (mesh.devices if mesh is not None else (device,))}
    server_kw = dict(batch_size=args.batch_size,
                     max_wait_ms=args.max_wait_ms, label_hw=hw,
                     channels=channels, device=device, mesh=mesh)

    def run(_, x):      # the program copy on the device of this share
        return programs[x.device].call(x)

    if kind == "ids":
        return InferenceServer(None, predict_fn=run, **server_kw), {}
    # the artifact's program is the forward; the rest is the translator's
    pre, predict, encode = make_translation_fns(
        channels=channels, normalize=args.normalize,
        denormalize=args.denormalize, hw=hw, forward=run)
    server = InferenceServer(
        None, predict_fn=predict, preprocess_fn=pre, **server_kw)
    return server, dict(encode=encode, endpoints=TRANSLATE_ENDPOINTS,
                        formats=TRANSLATE_FORMATS)


def build_server(args):
    """(a not yet started InferenceServer, the handler's keyword
    arguments) for the artifact or the kind ``args`` ask for."""
    if args.artifact:
        return server_from_artifact(args)
    if args.kind == "seg":
        return build_seg_server(args), {}
    return build_translation_server(args)


def start_http(args):
    """Build the server ``args`` asks for, warm it up and start its batch
    worker; returns (the HTTP server, not yet serving, the batcher)."""
    server, handler_kw = build_server(args)
    print("warming up...", flush=True)
    server.warmup()
    server.start()
    info = {
        # when serving an artifact the (defaulted) checkpoint flag means
        # nothing
        "checkpoint": "" if args.artifact else args.checkpoint_name,
        "batch_size": args.batch_size, "kind": args.kind,
        "artifact": args.artifact, "bf16": args.bf16,
        "device": str(server.device), "devices": server.mesh.size}
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(server, info, **handler_kw))
    return httpd, server


def main(argv=None):
    args = serve_parse().parse_args(argv)
    httpd, server = start_http(args)
    print(f"serving on http://{args.host}:{args.port} "
          f"(batch {args.batch_size}, wait {args.max_wait_ms} ms)", flush=True)
    # production schedulers stop services with SIGTERM: turn it into a
    # SystemExit out of serve_forever so the finally runs server.stop(),
    # which fails queued requests explicitly instead of hanging clients
    import signal
    import sys
    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
