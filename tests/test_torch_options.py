"""The port's command lines take every flag of the JAX package's: each JAX
parse function's option dests are a subset of its port counterpart's, so a
JAX command line parses, and no host flag is refused at any value (where
each lands: test_torch_isolation.py). Also the flags this comparison found
missing, and the seg checkpoint refusal's reason."""

import importlib

import pytest

torch = pytest.importorskip("torch")

from thermal_semantic_segmentation_torch.cli import _common  # noqa: E402
from thermal_semantic_segmentation_torch.cli import options  # noqa: E402
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)

# (module under cli/, parse function): the same names in both packages
PARSERS = [("options", "train_parse"), ("options", "translation_parse"),
           ("options", "seg_parse"), ("options", "evaluation_parse"),
           ("options", "calc_proto_parse"),
           ("options", "pseudo_generation_parse"),
           ("options", "self_train_parse"), ("serve", "serve_parse"),
           ("export_stablehlo", "export_stablehlo_parse"),
           ("doctor", "doctor_parse")]
# the JAX package's host flags at a value that asks for their mode, and the
# value the parsed args must hold
HOST_FLAGS = {"native_decode": (["--native_decode", "true"], True),
              "native_encode": (["--native_encode", "true"], True),
              "wire": (["--wire", "packed_bf16"], "packed_bf16"),
              "decode_cache_mb": (["--decode_cache_mb", "512"], 512.0),
              "decode_cache_dir": (["--decode_cache_dir", "dc"], "dc"),
              "device_aug": (["-device_aug", "true"], True)}


def _parser(package, module, name):
    return getattr(importlib.import_module(
        f"thermal_semantic_segmentation_{package}.cli.{module}"), name)()


def _dests(parser):
    return {a.dest for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("module,name", PARSERS,
                         ids=[name for _, name in PARSERS])
def test_port_parser_takes_every_jax_flag(module, name):
    jax_dests = _dests(_parser("tpu", module, name))
    port_dests = _dests(_parser("torch", module, name))
    assert jax_dests <= port_dests, sorted(jax_dests - port_dests)


@pytest.mark.parametrize("module,name", PARSERS,
                         ids=[name for _, name in PARSERS])
def test_no_host_flag_is_refused(module, name):
    """Every host flag of the JAX parser parses in the port's at the value
    that asks for its mode, and holds that value; the decode cache the
    parse set is turned off again."""
    from thermal_semantic_segmentation_torch.data.cache import (
        decode_cache, set_decode_cache)
    jax_dests = _dests(_parser("tpu", module, name))
    flags = {k: v for k, v in HOST_FLAGS.items() if k in jax_dests}
    if module == "options" or module == "doctor":
        assert set(flags) >= set(HOST_FLAGS) - {"device_aug"}
    try:
        for dest, (argv, value) in flags.items():
            args = _parser("torch", module, name).parse_args(
                argv + ["--device", "cpu"])
            assert getattr(args, dest) == value, dest
        assert decode_cache().disk_dir == "dc"
    finally:
        set_decode_cache(0, disk_dir=None)
    assert decode_cache().max_bytes == 0


@pytest.mark.parametrize("module,name", PARSERS,
                         ids=[name for _, name in PARSERS])
def test_compile_cache_dir_is_accepted(module, name):
    """JAX's spelling and default; the value changes nothing in the port
    (it has no torch.compile), so every value parses."""
    parser = _parser("torch", module, name)
    assert parser.parse_args(["--device", "cpu"]).compile_cache_dir == "auto"
    args = parser.parse_args(["--compile_cache_dir", "off",
                              "--device", "cpu"])
    assert args.compile_cache_dir == "off"


def test_evaluation_parse_takes_compile_cache_dir():
    """The command that exited 2 ("unrecognized arguments") before."""
    args = options.evaluation_parse().parse_args(
        ["--compile_cache_dir", "off", "--device", "cpu"])
    assert args.compile_cache_dir == "off"


def test_legacy_seg_checkpoint_refusal_gives_its_reason():
    """The seg CLIs build the module2 head only, as the JAX package's do;
    the legacy head is ported, for the GAN's frozen sem nets."""
    legacy = create_deeplab(0, device="cpu", head="legacy", num_classes=19,
                            num_channels=3, layers=(1, 1, 1, 1))
    with pytest.raises(ValueError) as info:
        _common.model_meta_from_state_dict(legacy.state_dict())
    msg = str(info.value)
    assert "the seg CLIs build the module2 head only" in msg
    assert "not yet ported" not in msg
