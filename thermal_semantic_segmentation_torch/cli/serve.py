"""Batch inference server for segmentation checkpoints, on the CUDA device.

Counterpart of the JAX ``cli/serve.py`` for ``--kind seg``: load a
reference-schema ``.pth`` once, keep the model on the card, and serve
segmentation over HTTP with micro-batching (concurrent requests coalesce
into fixed-size padded batches, up to a latency budget).

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

Input: PNG/JPEG bytes. 16-bit images get the Freiburg IR radiometric window;
8-bit images are scaled to [0, 1]; everything is resized to 256x512.
``--data_parallel true`` splits every coalesced batch over the cards this
process sees (``parallel/mesh.LocalMesh``, shrunk to a count that divides
``-batch_size``), one model copy on each. ``--kind translator`` and
``--artifact`` are not yet ported and exit with an error.
"""

from __future__ import annotations

import os
from http.server import ThreadingHTTPServer

from ..serving.batcher import InferenceServer
from ..serving.endpoints import make_handler


def serve_parse():
    from .options import HostConfigParser, _add_roots
    parser = HostConfigParser(description="segmentation inference server",
                              distributed=False)
    parser.add_argument("--kind", type=str, default="seg",
                        choices=["seg", "translator"],
                        help="'seg': POST /segment[_stream] class maps; "
                             "'translator' is not yet ported")
    parser.add_argument("--artifact", type=str, default="",
                        help="not yet ported: refused when set")
    parser.add_argument("-checkpoint_name", type=str,
                        default="256_freiburg_segmentation.pth")
    parser.add_argument("-net_mode", type=str, default="one_channel")
    parser.add_argument("-num_classes", type=int, default=13)
    parser.add_argument("-batch_size", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=10.0,
                        help="micro-batching latency budget after the first "
                             "request of a batch arrives.")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8756)
    _add_roots(parser)
    return parser


def build_seg_server(args) -> InferenceServer:
    """Checkpoint -> model on ``args.device`` -> a (not yet started)
    InferenceServer; what ``main`` serves."""
    from ._common import (apply_model_meta, build_deeplab,
                          load_seg_checkpoint, maybe_data_parallel)

    state_dict, meta = load_seg_checkpoint(
        os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)
    device = args.device or None
    model = build_deeplab(args, device=device)
    model.load_state_dict(state_dict, strict=True)
    return InferenceServer(
        model, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        channels=1 if args.net_mode == "one_channel" else 3,
        bf16=args.bf16, device=device,
        mesh=maybe_data_parallel(args, args.batch_size, "serving"))


def main(argv=None):
    parser = serve_parse()
    args = parser.parse_args(argv)
    if args.kind != "seg":
        parser.error(f"--kind {args.kind} is not yet ported to the PyTorch "
                     f"package (see ROADMAP.md)")
    if args.artifact:
        parser.error("--artifact is not yet ported to the PyTorch package "
                     "(see ROADMAP.md)")
    server = build_seg_server(args)
    print("warming up...", flush=True)
    server.warmup()
    server.start()
    info = {"checkpoint": args.checkpoint_name, "batch_size": args.batch_size,
            "kind": args.kind, "bf16": args.bf16, "device": str(server.device)}
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(server, info))
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
