"""The port's seg server (serving/, cli/serve.py, cli/_common.py) against the
JAX package's server: same weights, same request bytes, same HTTP surface.

Class ids must be equal except where the JAX top-2 logit gap is below 1e-5
(a genuine near-tie that float32 reassociation may flip); ``preprocess`` must
match exactly; status codes and stream framing must be the same.
"""

import http.client
import io
import json
import struct
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tests.test_torch_deeplab import FORWARD_ATOL, jax_deeplab_with_twin  # noqa: E402
from thermal_semantic_segmentation_tpu.cli._common import (  # noqa: E402
    save_seg_checkpoint)
from thermal_semantic_segmentation_tpu.cli.export_torch import (  # noqa: E402
    export_seg)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    upsample_logits as jax_upsample_logits)
from thermal_semantic_segmentation_tpu.serving import (  # noqa: E402
    batcher as jax_batcher, endpoints as jax_endpoints)
from thermal_semantic_segmentation_torch.cli import serve  # noqa: E402
from thermal_semantic_segmentation_torch.cli._common import (  # noqa: E402
    load_seg_checkpoint)
from thermal_semantic_segmentation_torch.serving import (  # noqa: E402
    batcher, endpoints)
from thermal_semantic_segmentation_torch.serving.codec import (  # noqa: E402
    stream_segment)

HW = (64, 128)
TIE_GAP = 1e-5


def _png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _payload(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "u16":
        return _png(rng.integers(21000, 26000, (40, 120)).astype(np.uint16))
    if kind == "u8_gray":
        return _png(rng.integers(0, 256, (40, 120)).astype(np.uint8))
    return _png(rng.integers(0, 256, (40, 120, 3)).astype(np.uint8))


def _serve_http(srv, handler_factory):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                handler_factory(srv, {"checkpoint": "t"}))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def pair():
    model, variables, twin = jax_deeplab_with_twin(0)
    jax_srv = jax_batcher.InferenceServer(model, variables, batch_size=4,
                                          max_wait_ms=30, label_hw=HW)
    port_srv = batcher.InferenceServer(twin, batch_size=4, max_wait_ms=30,
                                       label_hw=HW, device="cpu")
    for srv in (jax_srv, port_srv):
        srv.warmup()
        srv.start()
    jax_http = _serve_http(jax_srv, jax_endpoints.make_handler)
    port_http = _serve_http(port_srv, endpoints.make_handler)
    yield dict(model=model, variables=variables, jax_srv=jax_srv,
               port_srv=port_srv,
               jax_url=f"http://127.0.0.1:{jax_http.server_address[1]}",
               port_url=f"http://127.0.0.1:{port_http.server_address[1]}",
               jax_port=jax_http.server_address[1],
               port_port=port_http.server_address[1])
    for httpd in (jax_http, port_http):
        httpd.shutdown()
        httpd.server_close()
    for srv in (jax_srv, port_srv):
        srv.stop()


def _decided(pair, payload):
    """Pixels whose JAX top-2 logit gap is at least TIE_GAP."""
    x = jax_batcher.preprocess(payload, HW)[None]
    out = pair["model"].apply(pair["variables"], jnp.asarray(x), train=False)
    up = np.asarray(jax_upsample_logits(out["out"], *HW))[0]
    top2 = np.sort(up, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) >= TIE_GAP


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers.get("Content-Type"), r.read()


def _ids(png_bytes):
    return np.asarray(Image.open(io.BytesIO(png_bytes)))


@pytest.mark.parametrize("kind,channels", [
    ("u16", 1), ("u8_gray", 1), ("u8_rgb", 1), ("u8_rgb", 3)])
def test_preprocess_matches_jax(kind, channels):
    payload = _payload(kind, seed=1)
    got = batcher.preprocess(payload, HW, channels)
    want = jax_batcher.preprocess(payload, HW, channels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_preprocess_rejects_channel_mismatch():
    payload = _payload("u16", seed=2)
    for fn in (batcher.preprocess, jax_batcher.preprocess):
        with pytest.raises(ValueError, match="channel"):
            fn(payload, HW, 3)


@pytest.mark.parametrize("kind", ["u16", "u8_gray"])
def test_segment_ids_match_jax(pair, kind):
    payload = _payload(kind, seed=3)
    ctype, body = _post(f"{pair['port_url']}/segment?format=ids", payload)
    assert ctype == "image/png"
    got = _ids(body)
    want = _ids(_post(f"{pair['jax_url']}/segment?format=ids", payload)[1])
    assert got.shape == want.shape == HW and got.dtype == np.uint8
    decided = _decided(pair, payload)
    np.testing.assert_array_equal(got[decided], want[decided])


def test_segment_json_and_palette_match_jax(pair):
    payload = _payload("u16", seed=4)
    port_ids = _ids(_post(f"{pair['port_url']}/segment?format=ids",
                          payload)[1])
    ctype, body = _post(f"{pair['port_url']}/segment?format=json", payload)
    assert ctype == "application/json"
    stats = json.loads(body)
    ids, counts = np.unique(port_ids, return_counts=True)
    assert stats == {"class_counts": {str(int(i)): int(c)
                                      for i, c in zip(ids, counts)},
                     "shape": list(HW)}
    jax_stats = json.loads(_post(f"{pair['jax_url']}/segment?format=json",
                                 payload)[1])
    flips = int((~_decided(pair, payload)).sum())
    keys = set(stats["class_counts"]) | set(jax_stats["class_counts"])
    diff = sum(abs(stats["class_counts"].get(k, 0)
                   - jax_stats["class_counts"].get(k, 0)) for k in keys)
    assert diff <= 2 * flips
    port_png = Image.open(io.BytesIO(_post(f"{pair['port_url']}/segment",
                                           payload)[1]))
    jax_png = Image.open(io.BytesIO(_post(f"{pair['jax_url']}/segment",
                                          payload)[1]))
    assert port_png.mode == jax_png.mode == "P"
    assert port_png.size == jax_png.size == (HW[1], HW[0])
    assert port_png.getpalette() == jax_png.getpalette()


def test_stream_matches_jax(pair):
    frames = [_payload("u16", seed=10 + i) for i in range(6)]
    frames.insert(2, b"this is not an image")
    before = pair["port_srv"].requests_served
    got = list(stream_segment(f"{pair['port_url']}/segment_stream?format=ids",
                              frames))
    want = list(stream_segment(f"{pair['jax_url']}/segment_stream?format=ids",
                               frames))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 0, 1, 0, 0, 0, 0]
    assert b"bad frame" in got[2][1]
    assert pair["port_srv"].requests_served - before == 6
    for frame, (status, g), (_, w) in zip(frames, got, want):
        if status == 0:
            decided = _decided(pair, frame)
            np.testing.assert_array_equal(_ids(g)[decided], _ids(w)[decided])


def _status(port, method, path, body, chunked):
    headers = {}
    if chunked:
        body, headers = iter([body]), {"Transfer-Encoding": "chunked"}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


@pytest.mark.parametrize("method,path,body,chunked,code", [
    ("POST", "/segment", b"not a png", False, 400),
    ("POST", "/segment?format=bogus", b"x", False, 400),
    ("POST", "/segment_stream", struct.pack(">Q", 10_000) + b"short", False,
     400),
    ("POST", "/nope", b"x", False, 404),
    ("GET", "/nope", None, False, 404),
    ("POST", "/segment", b"\0" * 16, True, 411),
    ("POST", "/segment_stream", b"\0" * 16, True, 411),
])
def test_error_statuses_match_jax(pair, method, path, body, chunked, code):
    port_code = _status(pair["port_port"], method, path, body, chunked)
    jax_code = _status(pair["jax_port"], method, path, body, chunked)
    assert port_code == jax_code == code


def test_healthz_and_keepalive(pair):
    with urllib.request.urlopen(f"{pair['port_url']}/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["checkpoint"] == "t"
    assert {"batches_run", "requests_served"} <= set(health)
    payload = _payload("u16", seed=5)
    conn = http.client.HTTPConnection("127.0.0.1", pair["port_port"],
                                      timeout=60)
    try:
        conn.request("POST", "/nope", body=payload)
        assert conn.getresponse().read() == b"not found"
        conn.request("POST", "/segment?format=ids", body=payload)
        resp = conn.getresponse()
        assert resp.status == 200 and _ids(resp.read()).shape == HW
    finally:
        conn.close()


def test_micro_batching_coalesces(pair):
    srv = pair["port_srv"]
    arr = batcher.preprocess(_payload("u16", seed=6), HW)
    before = srv.batches_run
    waiters = [srv.submit(arr) for _ in range(8)]
    preds = [w.get(timeout=120) for w in waiters]
    for p in preds:
        assert p.shape == HW and p.dtype == np.uint8 and p.max() < 13
    assert srv.batches_run - before < 8
    np.testing.assert_array_equal(preds[0], preds[-1])


def test_stop_fails_pending_requests_instead_of_hanging():
    _, _, twin = jax_deeplab_with_twin(1)
    srv = batcher.InferenceServer(twin, batch_size=4, max_wait_ms=5,
                                  label_hw=HW, device="cpu")
    arr = np.zeros((*HW, 1), np.float32)
    waiters = [srv.submit(arr) for _ in range(3)]   # never started
    srv.stop()
    for w in waiters:
        assert isinstance(w.get(timeout=5), batcher.InferenceError)
    assert isinstance(srv.submit(arr).get(timeout=5), batcher.InferenceError)


def test_bf16_server_answers():
    _, _, twin = jax_deeplab_with_twin(2)
    srv = batcher.InferenceServer(twin, batch_size=2, label_hw=HW,
                                  bf16=True, device="cpu")
    ids = srv._predict(np.random.default_rng(0).uniform(
        0, 1, (2, *HW, 1)).astype(np.float32))
    assert ids.shape == (2, *HW) and ids.dtype == np.uint8 and ids.max() < 13


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A native JAX checkpoint and its reference-schema .pth export."""
    root = tmp_path_factory.mktemp("ckpt")
    model, variables, _ = jax_deeplab_with_twin(3)
    save_seg_checkpoint(str(root / "s.msgpack"), variables, epoch=3,
                        val_loss=0.5)
    export_seg(str(root / "s.msgpack"), str(root / "s.pth"))
    return root, model, variables


def test_exported_checkpoint_loads_and_serves(exported):
    root, model, variables = exported
    state_dict, meta = load_seg_checkpoint(str(root / "s.pth"))
    assert int(meta["epoch"]) == 3 and float(meta["val_loss"]) == 0.5
    assert meta["layers"] == [1, 1, 1, 1] and meta["num_channels"] == 1
    args = serve.serve_parse().parse_args(
        ["-checkpoint_name", "s.pth", "--model_root_path", str(root),
         "--device", "cpu", "-batch_size", "2"])
    srv = serve.build_seg_server(args)
    assert args.layers == (1, 1, 1, 1) and srv.batch_size == 2
    x = np.random.default_rng(8).uniform(0, 1, (2, *HW, 1)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  train=False)["out"])
    with torch.no_grad():
        got = srv.model(torch.from_numpy(x).permute(0, 3, 1, 2))["out"]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=FORWARD_ATOL)


def test_native_msgpack_checkpoint_is_refused(exported, tmp_path):
    """A native msgpack checkpoint is no longer refused: it loads into the
    same state_dict and meta as its .pth export. A file that is neither
    checkpoint format still is."""
    root, _, _ = exported
    native_sd, native_meta = load_seg_checkpoint(str(root / "s.msgpack"))
    export_sd, export_meta = load_seg_checkpoint(str(root / "s.pth"))
    assert native_sd.keys() == export_sd.keys()
    for k, v in export_sd.items():
        assert torch.equal(native_sd[k], v), k
    assert int(native_meta["epoch"]) == 3
    assert float(native_meta["val_loss"]) == 0.5
    assert native_meta["layers"] == export_meta["layers"] == [1, 1, 1, 1]
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch .pth nor"):
        load_seg_checkpoint(str(tmp_path / "notes.txt"))


@pytest.mark.parametrize("argv", [
    ["--kind", "translator"], ["--artifact", "model.stablehlo"],
    ["--data_parallel", "true"]])
def test_serve_main_refuses_what_is_not_yet_ported(argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        serve.main(argv + ["--device", "cpu"])
    assert exit_info.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_concurrent_http_clients_coalesce(pair):
    srv = pair["port_srv"]
    payload = _payload("u16", seed=9)
    before_b, before_r = srv.batches_run, srv.requests_served
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(
            lambda _: _post(f"{pair['port_url']}/segment?format=ids",
                            payload), range(32)))
    assert all(_ids(body).shape == HW for _, body in results)
    assert srv.requests_served - before_r == 32
    assert srv.batches_run - before_b <= 24     # well below one per request
