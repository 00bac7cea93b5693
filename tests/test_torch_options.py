"""The port's command lines take every flag of the JAX package's: each JAX
parse function's option dests are a subset of its port counterpart's, so a
JAX command line parses (a flag whose mode is not ported is then refused by
its value, with a reason: test_torch_isolation.py). Also the flags this
comparison found missing, and the seg checkpoint refusal's reason."""

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
           ("export_stablehlo", "export_stablehlo_parse")]


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
