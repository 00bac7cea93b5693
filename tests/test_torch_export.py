"""The port's ``torch.export`` artifacts (core/export.py,
cli/export_stablehlo.py, cli/serve.py ``--artifact``) against the JAX
package's StableHLO artifacts' contract and outputs, the cases of
tests/test_stablehlo_export.py.

One tiny DeepLab (layers 1,1,1,1) and one tiny U-Net (unet_256, ngf 4),
their JAX weights converted by ``models/convert``; each artifact is
exported once for the module. Tolerances: ids equal except where the JAX
top-2 logit gap is below 1e-5 (a genuine near-tie that float32
reassociation may flip); logits within 5e-4 (PARITY.md:17); the generator
within 1e-4 of the JAX generator; the int8 round trip's weights exactly
JAX's; an int8 container's ids equal to the port's model on the
dequantized weights outside that model's near-ties.
"""

import io
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_gan import jax_net  # noqa: E402
from thermal_semantic_segmentation_tpu.cli._common import (  # noqa: E402
    save_seg_checkpoint as jax_save_seg_checkpoint)
from thermal_semantic_segmentation_tpu.core import (  # noqa: E402
    stablehlo as jax_stablehlo)
from thermal_semantic_segmentation_tpu.core.checkpoint import (  # noqa: E402
    save_checkpoint as jax_save_checkpoint)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    upsample_logits as jax_upsample_logits)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    export_stablehlo, serve)
from thermal_semantic_segmentation_torch.cli._common import (  # noqa: E402
    save_seg_checkpoint)
from thermal_semantic_segmentation_torch.core import export  # noqa: E402
from thermal_semantic_segmentation_torch.models.convert import (  # noqa: E402
    jax_variables_to_state_dict)
from thermal_semantic_segmentation_torch.serving.batcher import (  # noqa: E402
    preprocess)
from thermal_semantic_segmentation_torch.serving.endpoints import (  # noqa: E402
    make_handler)

HW = (256, 512)
SMALL_HW = (64, 128)
TIE_GAP = 1e-5
LOGITS_ATOL = 5e-4
IMAGE_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on a
    few cores, where more threads only wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX model, its variables, the port's twin, a directory holding the
    JAX msgpack checkpoint ``s.msgpack`` and the port's ``s.pth``)."""
    model, variables, twin = jax_deeplab_with_twin(0)
    root = tmp_path_factory.mktemp("ckpt")
    jax_save_seg_checkpoint(str(root / "s.msgpack"), variables, epoch=1,
                            layers=[1, 1, 1, 1], num_channels=1,
                            num_classes=13)
    save_seg_checkpoint(str(root / "s.pth"), twin.state_dict(), epoch=1)
    return model, variables, twin, root


def _cli(root, out, *extra):
    export_stablehlo.main(["--model_root_path", str(root), "--out", str(out),
                           "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def ids_artifact(tiny, tmp_path_factory):
    """The CLI's default export from the JAX msgpack checkpoint: ids, a
    symbolic batch, self-checked."""
    _, _, _, root = tiny
    out = tmp_path_factory.mktemp("ids") / "ids.pt2"
    _cli(root, out, "-checkpoint_name", "s.msgpack", "--batch", "dynamic",
         "--check", "true")
    return str(out)


@pytest.fixture(scope="module")
def int8_artifact(tiny, tmp_path_factory):
    """The CLI's int8 container from the port's .pth, self-checked
    against the dequantized model."""
    _, _, _, root = tiny
    out = tmp_path_factory.mktemp("int8") / "ids_int8.pt2"
    _cli(root, out, "-checkpoint_name", "s.pth", "--quantize", "int8",
         "--check", "true")
    return str(out)


@pytest.fixture(scope="module")
def logits_artifact(tiny, tmp_path_factory):
    """Logits at a fixed batch of 4 at 64x128, through the library."""
    _, _, twin, _ = tiny
    path = str(tmp_path_factory.mktemp("logits") / "logits.pt2")
    exp = export.export_seg_forward(twin, label_hw=SMALL_HW, batch=4,
                                    output="logits")
    export.save_exported(exp, path, meta={"output_kind": "logits",
                                          "channels": 1})
    return path


def _jax_logits(model, variables, x, hw=HW):
    out = model.apply(variables, jnp.asarray(x), train=False)
    return np.asarray(jax_upsample_logits(out["out"], *hw))


def _assert_ids_match(got, logits):
    """``got`` equals the argmax of ``logits`` wherever their top-2 gap is
    at least TIE_GAP."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= TIE_GAP
    assert got.shape == logits.shape[:-1] and got.dtype == np.uint8
    np.testing.assert_array_equal(got[decided], logits.argmax(-1)[decided])


def _images(n, seed, hw=HW, channels=1, lo=0.0):
    return np.random.default_rng(seed).uniform(
        lo, 1, (n, *hw, channels)).astype(np.float32)


def test_cli_export_records_the_calling_convention(ids_artifact):
    sidecar = export.exported_sidecar(ids_artifact)
    assert sidecar["format"] == export.FORMAT
    assert sidecar["platforms"] == ["cuda", "cpu"]
    assert sidecar["input"] == [{"shape": ["b", "256", "512", "1"],
                                 "dtype": "float32"}]
    assert sidecar["output"] == [{"shape": ["b", "256", "512"],
                                  "dtype": "uint8"}]
    assert sidecar["rows_per_call"] == 8       # the ASPP split at 33x65
    assert sidecar["checkpoint"] == "s.msgpack"
    assert sidecar["output_kind"] == "ids" and sidecar["channels"] == 1
    assert sidecar["bytes"] == os.path.getsize(ids_artifact)


@pytest.fixture(scope="module")
def nine_images(tiny):
    """Nine images and the JAX logits of them, one JAX forward."""
    model, variables, _, _ = tiny
    x = _images(9, seed=9)
    return x, _jax_logits(model, variables, x)


@pytest.mark.parametrize("batch", [3, 9])
def test_symbolic_batch_ids_match_jax(ids_artifact, nine_images, batch):
    """One artifact, any batch: 9 rows run as chunks of 8 and 1."""
    art = export.load_exported(ids_artifact)
    assert art.rows_per_call == 8 and not art.fixed_batch
    x, logits = nine_images
    got = art.call(x[:batch]).numpy()
    _assert_ids_match(got, logits[:batch])


def test_logits_at_a_fixed_batch_match_jax(tiny, logits_artifact):
    model, variables, _, _ = tiny
    art = export.load_exported(logits_artifact)
    assert art.fixed_batch and art.rows_per_call == 4
    x = _images(4, seed=1, hw=SMALL_HW)
    got = art.call(x).numpy()
    want = _jax_logits(model, variables, x, SMALL_HW)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)
    with pytest.raises(Exception):
        art.call(_images(3, seed=2, hw=SMALL_HW))   # a fixed batch


def test_quantize_state_dict_matches_jax(tiny):
    """The same counts as JAX ``quantize_variables``, and dequantized
    weights equal to JAX's, converted, bit for bit."""
    _, variables, twin, _ = tiny
    qtree, scales, stats = jax_stablehlo.quantize_variables(variables)
    want = jax_variables_to_state_dict(
        jax_stablehlo.dequantize_variables_np(qtree, scales))
    qdict, port_scales, port_stats = export.quantize_state_dict(
        twin.state_dict())
    assert port_stats == stats and port_stats["tensors"] > 0
    assert all(qdict[k].dtype == np.int8 for k in port_scales)
    got = export.dequantize_state_dict(qdict, port_scales)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_int8_container_is_small_and_matches_the_dequantized_model(
        tiny, ids_artifact, int8_artifact):
    _, _, twin, _ = tiny
    sidecar = export.exported_sidecar(int8_artifact)
    float_bytes = export.exported_sidecar(ids_artifact)["bytes"]
    assert sidecar["bytes"] < 0.4 * float_bytes, (sidecar["bytes"],
                                                  float_bytes)
    assert sidecar["container"] == "program+weights"
    assert sidecar["quantize"] == "int8" and sidecar["quantized_tensors"] > 0
    assert sidecar["quantized_params"] > sidecar["float_params"]
    assert len(sidecar["input"]) == 1      # the image argument only
    x = _images(3, seed=4)
    got = export.load_exported(int8_artifact).call(x).numpy()
    model = export.dequantized_model(twin)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))["out"]
        logits = torch.nn.functional.interpolate(
            out, size=HW, mode="bilinear", align_corners=True)
    _assert_ids_match(got, logits.permute(0, 2, 3, 1).numpy())


def test_load_dispatch_survives_missing_sidecar(ids_artifact, int8_artifact,
                                                tmp_path):
    x = _images(1, seed=9)
    want = export.load_exported(ids_artifact).call(x)
    for src in (ids_artifact, int8_artifact):
        path = tmp_path / os.path.basename(src)
        os.link(src, path)
        art = export.load_exported(str(path))
        assert art.rows_per_call == 8
        assert art.call(x).shape == want.shape


def test_generator_export_cli_matches_jax(tmp_path):
    """``--kind generator`` from a JAX msgpack GAN checkpoint: the program
    within 1e-4 of the JAX generator, then served from the artifact on the
    translator's endpoints."""
    model, variables = jax_net("unet_256", 5, (1, *HW, 3), ngf=4,
                               output_nc=1)
    jax_save_checkpoint(str(tmp_path / "g.msgpack"),
                        {"epoch": 0, "g_vars": {"s2t": variables}})
    out = str(tmp_path / "g.pt2")
    export_stablehlo.main([
        "--kind", "generator", "-checkpoint_name", "g.msgpack",
        "-input_nc", "3", "-output_nc", "1", "--gan_model_root_path",
        str(tmp_path), "--out", out, "--batch", "dynamic", "--check", "true",
        "--device", "cpu"])
    sidecar = export.exported_sidecar(out)
    assert sidecar["output_kind"] == "translation" and sidecar["ngf"] == 4
    assert sidecar["rows_per_call"] == export.GENERATOR_ROWS[1]
    x = _images(2, seed=3, channels=3, lo=-1.0)
    art = export.load_exported(out)
    assert art.min_rows == export.GENERATOR_ROWS[0]
    y = art.call(x).numpy()
    # a single row is padded to the program's least batch
    np.testing.assert_array_equal(art.call(x[1:]).numpy(), y[1:])
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False,
                                  mutable=False))
    assert y.shape == (2, *HW, 1) and y.dtype == np.float32
    np.testing.assert_allclose(y, want, rtol=0, atol=IMAGE_ATOL)
    srv, handler_kw = serve.build_server(serve.serve_parse().parse_args(
        ["--artifact", out, "-batch_size", "2", "--device", "cpu"]))
    assert handler_kw["endpoints"] == ("/translate", "/translate_stream")
    rows = srv._predict(x)
    v = (want.astype(np.float64) * 0.5 + 0.5) * 255.0
    near = np.abs(v - np.round(v)) <= 1e-4
    ref = np.clip(v, 0, 255).astype(np.uint8)
    assert rows.dtype == np.uint8 and rows.shape == ref.shape
    assert (rows[~near] == ref[~near]).all()
    assert np.abs(rows.astype(int) - ref.astype(int)).max() <= 1


def _u16_png(seed):
    u16 = np.random.default_rng(seed).integers(21000, 26000, (40, 120)
                                               ).astype(np.uint16)
    buf = io.BytesIO()
    Image.fromarray(u16).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_from_artifact_over_http(ids_artifact):
    """The server's answer is the artifact's own (which the test above
    holds to JAX)."""
    args = serve.serve_parse().parse_args(
        ["--artifact", ids_artifact, "-batch_size", "4", "--device", "cpu",
         "--max_wait_ms", "20"])
    server, handler_kw = serve.build_server(args)
    assert server.model is None and handler_kw == {}
    server.warmup()
    server.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(
        server, {"artifact": ids_artifact}, **handler_kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    payload = _u16_png(6)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/segment?format=ids",
            data=payload, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            ids = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    x = preprocess(payload, HW, 1)[None]
    np.testing.assert_array_equal(
        ids, export.load_exported(ids_artifact).call(x).numpy()[0])


@pytest.mark.parametrize("argv,match", [
    (["-batch_size", "8"], "fixed batch of 4"),
    (["-batch_size", "4"], "not servable"),
    (["-batch_size", "4", "--data_parallel", "true"], "symbolic batch")],
    ids=["fixed_batch_mismatch", "logits", "data_parallel_fixed_batch"])
def test_serve_refuses_what_an_artifact_cannot_serve(logits_artifact, argv,
                                                     match, monkeypatch):
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)
    args = serve.serve_parse().parse_args(
        ["--artifact", logits_artifact, "--device", "cpu", *argv])
    with pytest.raises(SystemExit, match=match):
        serve.build_server(args)


def test_load_refuses_a_jax_stablehlo_artifact(tiny, tmp_path):
    model, variables, _, _ = tiny
    path = str(tmp_path / "m.stablehlo")
    jax_stablehlo.save_exported(jax_stablehlo.export_seg_forward(
        model, variables, label_hw=SMALL_HW, batch=1, platforms=("cpu",)),
        path)
    with pytest.raises(ValueError, match="jax.export serialized StableHLO"):
        export.load_exported(path)
    os.remove(path + ".json")
    with pytest.raises(ValueError, match="not a torch.export artifact"):
        export.load_exported(path)


@pytest.mark.parametrize("value,accepted", [
    ("tpu,cpu", True), ("cuda,cpu", True), ("cuda", True), ("cpu", True),
    ("tpu", False), ("cpu,tpu", False), ("gpu", False)])
def test_export_cli_platforms(value, accepted, capsys):
    parser = export_stablehlo.export_stablehlo_parse()
    if accepted:
        export_stablehlo.check_platforms(value, parser)
        return
    with pytest.raises(SystemExit) as exit_info:
        export_stablehlo.check_platforms(value, parser)
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert ("not on a TPU" if "tpu" in value else "subset of cuda,cpu") in err


def test_serve_artifact_data_parallel(ids_artifact, monkeypatch, capsys):
    """``--data_parallel`` over two CPU replicas: one program a device (the
    two entries share the CPU's), each batch of 4 split 2 + 2, the ids one
    replica's."""
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)
    argv = ["--artifact", ids_artifact, "-batch_size", "4", "--device",
            "cpu"]
    one, _ = serve.build_server(serve.serve_parse().parse_args(argv))
    two, _ = serve.build_server(serve.serve_parse().parse_args(
        argv + ["--data_parallel", "true"]))
    assert "serving data-parallel over 2 devices" in capsys.readouterr().out
    assert two.mesh.size == 2
    x = _images(4, seed=11)
    np.testing.assert_array_equal(two._predict(x), one._predict(x))


def test_export_bf16_keeps_its_autocast(tiny, tmp_path):
    """``--bf16``: ``torch.export`` keeps the autocast casts, so the program
    runs its convolutions in bfloat16 and matches the model under the same
    autocast."""
    _, _, twin, _ = tiny
    exp = export.export_seg_forward(twin, label_hw=SMALL_HW, batch=2,
                                    output="logits", bf16=True)
    convs = [n for n in exp.program.run_decompositions().graph.nodes
             if "convolution" in str(n.target)]
    assert convs and all(n.meta["val"].dtype == torch.bfloat16
                         for n in convs)
    path = str(tmp_path / "bf16.pt2")
    sidecar = export.save_exported(exp, path)
    with open(path + ".json") as f:
        assert json.load(f) == sidecar
    diff = export._self_check(export.load_exported(path), 1, SMALL_HW, 2,
                              twin, "logits", tol=1e-2, bf16=True)
    assert diff >= 0.0
