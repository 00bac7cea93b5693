"""The port's ``cli/profile_step.py`` on the CPU against the JAX package's
CLI: the same flags, and a final JSON line with exactly the JAX CLI's keys
(the JAX CLI writes one key set for every step, so its eval step at the
same arguments gives them); the trace's aggregation names a convolution
op; the
device events of a card's trace are summed and sorted into the categories
(a synthetic Chrome trace: the CPU tests have no card)."""

import json

import pytest

torch = pytest.importorskip("torch")

from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    profile_step)
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    profile_step as jax_profile_step)

TINY = ["--batch_size", "2", "--image_size", "32", "64", "--layers",
        "1,1,1,1", "--bf16", "false", "--steps", "2", "--warmup", "1"]


def _final_line(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The keys of the JAX CLI's final line (its eval step at TINY)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_profile_step.main(["--step", "eval", *TINY, "--logdir",
                               str(tmp_path_factory.mktemp("jax"))])
    return set(json.loads(out.getvalue().strip().splitlines()[-1]))


@pytest.mark.parametrize("step", ["seg", "eval"])
def test_final_line_has_the_jax_keys(step, jax_keys, tmp_path, capsys):
    """Exactly the JAX CLI's keys at the same arguments; device time within
    the wall time; the categories sum to the device time (each rounded to
    0.001 ms); the trace kept under --logdir names a convolution op."""
    logdir = str(tmp_path / "port")
    got = _final_line(profile_step.main, ["--step", step, *TINY,
                                          "--logdir", logdir,
                                          "--device", "cpu"], capsys)
    assert set(got) == jax_keys
    assert set(got["categories_ms_per_step"]) <= {
        name for name, _ in profile_step.CATEGORIES} | {"other"}
    assert got["step"] == step and got["batch_size"] == 2
    assert 0 < got["device_ms_per_step"] <= got["wall_ms_per_step"]
    cats = got["categories_ms_per_step"]
    assert abs(sum(cats.values()) - got["device_ms_per_step"]) <= \
        1e-3 * (len(cats) + 1)
    per_op, per_cat = profile_step._aggregate_trace(logdir)
    assert any("conv" in op for op in per_op), sorted(per_op)[:10]
    assert per_cat["convolution"] > 0


def test_device_events_are_summed_by_category(tmp_path):
    """A card's trace: only the kernel, memcpy and memset events count
    (the CPU ops and runtime calls around them are not summed), each
    kernel in its category by name."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 500, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "ts": 10, "dur": 100, "pid": 0,
         "tid": 7, "name": "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32"},
        {"ph": "X", "cat": "kernel", "ts": 120, "dur": 30, "pid": 0,
         "tid": 7, "name": "void cudnn::detail::dgrad_engine<float, 512>"},
        {"ph": "X", "cat": "kernel", "ts": 160, "dur": 8, "pid": 0,
         "tid": 7, "name": "void cudnn::bn_fw_inf_1C11_kernel_NHWC<float>"},
        {"ph": "X", "cat": "kernel", "ts": 170, "dur": 4, "pid": 0,
         "tid": 7, "name": "void cudnn::engines_precompiled::"
                           "nhwcToNchwKernel<float>"},
        {"ph": "X", "cat": "kernel", "ts": 180, "dur": 2, "pid": 0,
         "tid": 7, "name": "void at::native::vectorized_elementwise_kernel"
                           "<4, at::native::CUDAFunctor_add<float>>"},
        {"ph": "X", "cat": "kernel", "ts": 190, "dur": 1, "pid": 0,
         "tid": 7, "name": "void upsample_argmax_kernel<13>(Params)"},
        {"ph": "X", "cat": "kernel", "ts": 200, "dur": 6, "pid": 0,
         "tid": 7, "name": "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 210, "dur": 3, "pid": 0,
         "tid": 8, "name": "Memcpy HtoD (Pinned -> Device)"},
        {"ph": "X", "cat": "gpu_memset", "ts": 215, "dur": 1, "pid": 0,
         "tid": 8, "name": "Memset (Device)"},
        {"ph": "X", "cat": "kernel", "ts": 220, "dur": 5, "pid": 0,
         "tid": 7, "name": "void some_kernel_of_its_own<float>"},
    ]
    with open(tmp_path / profile_step.TRACE_NAME, "w") as f:
        json.dump({"traceEvents": events}, f)
    per_op, per_cat = profile_step._aggregate_trace(str(tmp_path))
    assert dict(per_cat) == {"convolution": 130.0, "reduction/norm": 8.0,
                             "copy/memset": 8.0, "elementwise": 2.0,
                             "port kernels": 1.0, "gemm": 6.0, "other": 5.0}
    assert "aten::conv2d" not in per_op and len(per_op) == 10


def test_profile_step_rejects_unknown():
    with pytest.raises(SystemExit):
        profile_step._build("nope", None)


def test_profile_step_takes_the_jax_flags():
    """Every flag of the JAX CLI (the recipe's fidelity GAN configuration
    among them), plus the port's --device."""
    def dests(parser):
        return {a.dest for a in parser._actions if a.dest != "help"}
    assert dests(jax_profile_step.profile_parse()) | {"device"} == dests(
        profile_step.profile_parse())
    args = profile_step.profile_parse().parse_args(
        ["--step", "gan", "--gan_cycle", "true", "--with_contour", "true",
         "--sem_loss", "true", "--ngf", "8", "--layers", "1,1,1,1"])
    assert args.gan_cycle and args.with_contour and args.sem_loss
    assert args.layers == (1, 1, 1, 1) and args.device == ""


def test_profile_step_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_step.main(["--step", "eval", *TINY])
