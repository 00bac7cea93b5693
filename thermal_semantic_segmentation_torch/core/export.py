"""Self-contained ``torch.export`` deployment artifacts (counterpart of the JAX
``core/stablehlo.py``).

The artifact is the whole inference function, the eval-mode DeepLab forward
plus the protocol's align-corners upsample of the logits to 256x512 and the
argmax, or a GAN generator's forward, as one ``torch.export`` program with
the checkpoint's weights inside: ``load_exported(path).call(images)`` runs it
with no model code and no checkpoint. The ids come out of the hand-written
``upsample_argmax`` kernel, which the program calls as the op
``tss::upsample_argmax``. A program runs on CUDA and on the CPU: it is moved
at load to the device asked for.

The contract and the sidecar keys follow the JAX artifact's, so the server's
logic maps line for line: NHWC float32 input ``(b, 256, 512, C)``; the batch
dimension symbolic (``--batch dynamic``) or fixed; a ``<path>.json`` sidecar
with the calling convention; an int8 weight-only storage container
(``program.pt2`` + ``weights.npz``) dequantized once at load.

One difference: the program's symbolic batch is bounded. The ASPP head runs
its dilated branches on at most ``nn/aspp.MAX_BRANCH_PIXELS`` feature-map
pixels a call (cuDNN's fast algorithm stops past it), a split that
``torch.export`` cannot keep symbolic, so the seg program is exported for
batches of at most ``rows_per_call`` rows (8 at 256x512) and its ``call``
runs a larger batch in chunks of that many rows: any batch size still works.
"""

from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# registers the op tss::upsample_argmax, which the ids programs call: it
# must exist before a program that calls it is exported or loaded
from ..kernels import upsample_argmax as _upsample_argmax  # noqa: F401
from ..models.forward import generator_forward, seg_forward

HW = (256, 512)
# the generator program's batch range: cuDNN's convolutions on the card
# guard at most 65535 rows, and a batch of one row takes another path than
# the traced one, so ``call`` pads a single row to two
GENERATOR_ROWS = (2, 65535)
FORMAT = "torch.export program"
CONTAINER = "program+weights"
PLATFORMS = ("cuda", "cpu")


def quantize_state_dict(state_dict, *, min_size: int = 4096):
    """Weight-only int8 quantization for export artifacts (JAX
    ``quantize_variables``).

    Float tensors of at least 2 dimensions and ``min_size`` elements (the
    conv and dense weights) become int8 with symmetric per-output-channel
    scales, the output channel being axis 0 in torch's layout (flax's last
    axis); every other tensor stays as it is. The arithmetic is JAX's, in
    numpy float32, so the dequantized weights equal the JAX package's bit
    for bit. A storage format only: the weights are dequantized once at
    load and every operation stays in float.

    Returns ``(qdict, scales, stats)``: the state_dict with quantized
    entries as int8 numpy arrays (the rest as numpy arrays too), a ``{name:
    scale}`` dict, and the counts for the sidecar (``tensors``, ``params``
    quantized, ``float_params`` left in float).
    """
    qdict, scales = {}, {}
    stats = {"tensors": 0, "params": 0, "float_params": 0}
    for name, value in state_dict.items():
        arr = value.detach().cpu().numpy() if torch.is_tensor(value) \
            else np.asarray(value)
        if arr.dtype.kind != "f" or arr.ndim < 2 or arr.size < min_size:
            if arr.dtype.kind == "f":
                stats["float_params"] += int(arr.size)
            qdict[name] = arr
            continue
        w = arr.astype(np.float32)
        s = np.max(np.abs(w), axis=tuple(range(1, arr.ndim)),
                   keepdims=True) / 127.0
        s = np.where(s == 0, 1.0, s).astype(np.float32)
        qdict[name] = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        scales[name] = s
        stats["tensors"] += 1
        stats["params"] += int(arr.size)
    return qdict, scales, stats


def dequantize_state_dict(qdict, scales):
    """Float tensors from :func:`quantize_state_dict`'s output, computed on
    the host in numpy float32 (``q * s``), as the JAX package's
    ``dequantize_variables_np``."""
    out = {}
    for name, arr in qdict.items():
        s = scales.get(name)
        if s is not None:
            arr = np.asarray(arr, np.float32) * s
        out[name] = torch.from_numpy(np.array(arr))
    return out


class _Forward(torch.nn.Module):
    """The exported function: ``models/forward.seg_forward`` or
    ``generator_forward`` of ``model`` (held as a child, so that its
    weights go into the program) with ``kw``."""

    def __init__(self, forward, model, **kw):
        super().__init__()
        self._forward = forward
        self.model = model
        self.kw = kw

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self._forward(self.model, images, **self.kw)


class _WeightsAsArguments(torch.nn.Module):
    """``forward(images, weights)``: the wrapped function with every entry
    of its model's state_dict passed in, in order, so that the exported
    program holds no weights (the int8 container carries them). The
    function is kept out of this module's children on purpose: its tensors
    would otherwise be exported with the program."""

    def __init__(self, fn: torch.nn.Module):
        super().__init__()
        self._fn = (fn,)
        self.names = ["model." + k for k in fn.model.state_dict()]

    def forward(self, images, weights):
        return torch.func.functional_call(
            self._fn[0], dict(zip(self.names, weights)), (images,))


@dataclass
class ExportedForward:
    """An export before it is saved: the program, the batch it takes
    (``batch``: a fixed size, or None for a symbolic one of at most
    ``rows_per_call`` rows a call) and, for an int8
    container, its payload (``q{i}``/``s{i}`` or ``w{i}`` per weight
    argument, in the program's order) and counts."""
    program: torch.export.ExportedProgram
    batch: Optional[int]
    rows_per_call: Optional[int]
    payload: Optional[dict] = None
    stats: Optional[dict] = None


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _export(fn, model, *, hw, channels, batch, rows_per_call, quantize,
            min_rows: int = 1) -> ExportedForward:
    """``torch.export`` of ``fn`` (which holds ``model``) on NHWC float32
    input ``(b, *hw, channels)`` on the model's device, a symbolic batch
    from ``min_rows`` to ``rows_per_call`` rows unless ``batch`` fixes it;
    with ``quantize`` the weights become arguments and an int8 payload."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be 'int8' or None, got {quantize!r}")
    device = _device_of(model)
    if batch is None and rows_per_call == 1:
        batch_spec, example_rows = None, 1   # one row a call: a fixed 1
    elif batch is None:
        batch_spec = torch.export.Dim("b", min=min_rows, max=rows_per_call)
        example_rows = 2
    else:
        batch_spec, example_rows = None, int(batch)
    images = torch.zeros((example_rows, *hw, channels), device=device)
    image_shapes = {0: batch_spec} if batch_spec is not None else None
    payload = stats = None
    if quantize:
        qdict, scales, stats = quantize_state_dict(model.state_dict())
        payload = {}
        for i, (name, arr) in enumerate(qdict.items()):
            if name in scales:
                payload[f"q{i}"], payload[f"s{i}"] = arr, scales[name]
            else:
                payload[f"w{i}"] = arr
        wrapped = _WeightsAsArguments(fn)
        weights = [t.detach() for t in model.state_dict().values()]
        program = torch.export.export(
            wrapped, (images, weights),
            dynamic_shapes=(image_shapes, [None] * len(weights)))
    else:
        program = torch.export.export(fn, (images,),
                                      dynamic_shapes=(image_shapes,))
    # torch.export.save would write the example inputs too: the weights,
    # for a container
    program.example_inputs = None
    return ExportedForward(program, batch, rows_per_call if batch is None
                           else int(batch), payload, stats)


def seg_rows_per_call(model, hw=HW, channels: int = 1) -> int:
    """The most rows the seg program takes a call: as many as keep the
    ASPP branches in one call (``nn/aspp.split_branches``), read from the
    model's stride-8 map size at ``hw``."""
    from ..nn.aspp import MAX_BRANCH_PIXELS
    with torch.inference_mode():
        out = model(torch.zeros((1, channels, *hw),
                                device=_device_of(model)))["out"]
    return max(1, MAX_BRANCH_PIXELS // (out.shape[2] * out.shape[3]))


def export_seg_forward(model, *, label_hw=HW, channels: int = 1,
                       batch: Optional[int] = None, output: str = "ids",
                       quantize: Optional[str] = None,
                       bf16: bool = False) -> ExportedForward:
    """Export the eval-protocol forward of the DeepLab ``model`` (eval
    mode, on its device): NHWC float32 ``(b, *label_hw, channels)`` ->
    ``output`` 'ids' (uint8 classes from ``tss::upsample_argmax``, the
    serving payload) or 'logits' (float32 upsampled logits). ``batch``: a
    fixed size, or None for a symbolic batch. ``quantize='int8'``: the
    int8 storage container. ``bf16``: the forward under bfloat16 autocast
    (``torch.export`` keeps its casts in the program)."""
    if output not in ("ids", "logits"):
        raise ValueError(f"output must be 'ids' or 'logits', got {output!r}")
    model = model.eval()
    fn = _Forward(seg_forward, model, label_hw=tuple(label_hw),
                  output=output, bf16=bf16)
    return _export(fn, model, hw=label_hw, channels=channels, batch=batch,
                   rows_per_call=seg_rows_per_call(model, label_hw, channels),
                   quantize=quantize)


def export_generator_forward(model, *, hw=HW, channels: int = 3,
                             batch: Optional[int] = None,
                             quantize: Optional[str] = None,
                             bf16: bool = False) -> ExportedForward:
    """Export a GAN generator (normalised NHWC image in, tanh image out),
    with :func:`export_seg_forward`'s contract; its symbolic batch takes
    ``GENERATOR_ROWS``."""
    model = model.eval()
    return _export(_Forward(generator_forward, model, bf16=bf16), model,
                   hw=hw, channels=channels, batch=batch,
                   rows_per_call=GENERATOR_ROWS[1], quantize=quantize,
                   min_rows=GENERATOR_ROWS[0])


def _avals(nodes, batch_dim) -> list:
    """Shapes (as strings, the symbolic batch as ``"b"``) and dtypes of
    graph nodes' values, as the JAX sidecar writes them."""
    out = []
    for node in nodes:
        val = node.meta["val"]
        shape = [str(d) if isinstance(d, int) else "b" for d in val.shape]
        if batch_dim:
            shape[0] = "b"
        out.append({"shape": shape,
                    "dtype": str(val.dtype).replace("torch.", "")})
    return out


def _signature(program, n_images: int = 1, batch_dim: bool = False):
    """(input avals of the first ``n_images`` user inputs, output avals)."""
    user = set(program.graph_signature.user_inputs)
    inputs = [n for n in program.graph.nodes
              if n.op == "placeholder" and n.name in user][:n_images]
    outputs = list(program.graph.output_node().args[0])
    return _avals(inputs, batch_dim), _avals(outputs, batch_dim)


def save_exported(exp: ExportedForward, path: str,
                  meta: Optional[dict] = None) -> dict:
    """Write ``exp`` to ``path`` with a ``<path>.json`` sidecar describing
    the calling convention. A plain export becomes one ``.pt2``
    (``torch.export.save``); an int8 one a zip container (``program.pt2``
    + ``weights.npz``) whose sidecar input and output describe the image
    argument only."""
    dynamic = exp.batch is None
    extra = {}
    if exp.payload is not None:
        program_bytes = io.BytesIO()
        torch.export.save(exp.program, program_bytes)
        npz = io.BytesIO()
        np.savez(npz, **exp.payload)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            z.writestr("program.pt2", program_bytes.getvalue())
            z.writestr("weights.npz", npz.getvalue())
        extra = {"container": CONTAINER, "quantize": "int8",
                 "weight_args": sum(1 for k in exp.payload
                                    if k[0] in "qw"),
                 "quantized_tensors": exp.stats["tensors"],
                 "quantized_params": exp.stats["params"],
                 "float_params": exp.stats["float_params"]}
    else:
        torch.export.save(exp.program, path)
    inputs, outputs = _signature(exp.program, 1, dynamic)
    sidecar = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": list(PLATFORMS),
        "input": inputs,
        "output": outputs,
        "bytes": os.path.getsize(path),
        "rows_per_call": exp.rows_per_call,
        **extra,
        **(meta or {}),
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    return sidecar


def exported_sidecar(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


class LoadedArtifact:
    """A loaded artifact on one device: ``call(images)`` takes (n, H, W, C)
    float32 images (numpy or a tensor) and returns the program's output on
    ``device``: for a symbolic batch in chunks of at most ``rows_per_call``
    rows, a batch under the program's least (``min_rows``) padded with
    zero rows that are dropped from the output (eval-mode nets treat each
    row alone); ``to(device)`` is a copy of it on another device."""

    def __init__(self, program, weights, sidecar: dict, device):
        self.program = program
        self.sidecar = sidecar
        self.device = torch.device(device)
        self.min_rows, self.rows_per_call = _batch_range(program)
        self.fixed_batch = sidecar["input"][0]["shape"][0] != "b"
        self._module = program.module()
        self._weights = None if weights is None else [
            w.to(self.device, memory_format=torch.channels_last)
            if w.dim() == 4 else w.to(self.device) for w in weights]

    def to(self, device) -> "LoadedArtifact":
        device = torch.device(device)
        if device == self.device:
            return self
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(copy.deepcopy(self.program), device)
        return LoadedArtifact(program, self._weights, self.sidecar, device)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        if self._weights is None:
            return self._module(x)
        return self._module(x, self._weights)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if self.fixed_batch or n >= self.min_rows:
            return self._run(x)
        pad = x.new_zeros((self.min_rows - n, *x.shape[1:]))
        return self._run(torch.cat([x, pad]))[:n]

    def call(self, images) -> torch.Tensor:
        x = (images if torch.is_tensor(images)
             else torch.from_numpy(np.array(images))).to(self.device)
        with torch.inference_mode():
            if self.fixed_batch or x.shape[0] <= self.rows_per_call:
                return self._rows(x)
            return torch.cat([self._rows(part)
                              for part in x.split(self.rows_per_call)])


def _image_node(program):
    return next(n for n in program.graph.nodes if n.op == "placeholder"
                and n.name in set(program.graph_signature.user_inputs))


def _program_device(program) -> torch.device:
    return _image_node(program).meta["val"].device


def _batch_range(program) -> tuple:
    """(least, most) rows the program takes a call: its symbolic batch's
    bounds, or its fixed batch twice."""
    rows = _image_node(program).meta["val"].shape[0]
    if isinstance(rows, int):
        return rows, rows
    bounds = program.range_constraints[rows.node.expr]
    return int(bounds.lower), int(bounds.upper)


def _refuse(path: str, what: str):
    raise ValueError(
        f"{path!r} is {what}, not a torch.export artifact of the PyTorch "
        f"package: re-export the checkpoint with python -m "
        f"thermal_semantic_segmentation_torch.cli.export_stablehlo")


def load_exported(path: str, device=None) -> LoadedArtifact:
    """Load an artifact written by :func:`save_exported` onto ``device``
    (default: the device it was exported on). A container's weights are
    dequantized once, on the host. The JAX package's StableHLO artifacts
    are refused with the reason (their sidecar's ``format``); the sidecar,
    where present, names the format, and the file's zip members do where
    it is missing."""
    sidecar = None
    if os.path.exists(path + ".json"):
        sidecar = exported_sidecar(path)
        if sidecar.get("format") != FORMAT:
            _refuse(path, f"a {sidecar.get('format')!r} artifact")
    if not zipfile.is_zipfile(path):
        _refuse(path, "a raw serialized blob (a JAX StableHLO artifact)")
    with zipfile.ZipFile(path) as z:
        members = set(z.namelist())
        if "program.bin" in members:
            _refuse(path, "a JAX StableHLO container")
        weights = None
        if "program.pt2" in members:
            program = torch.export.load(io.BytesIO(z.read("program.pt2")))
            with np.load(io.BytesIO(z.read("weights.npz"))) as npz:
                weights = _payload_to_weights(npz)
    if weights is None:
        program = torch.export.load(path)
    if sidecar is None:
        inputs, outputs = _signature(program)
        sidecar = {"format": FORMAT, "input": inputs, "output": outputs}
    artifact = LoadedArtifact(program, weights, sidecar,
                              _program_device(program))
    return artifact if device is None else artifact.to(device)


def _payload_to_weights(npz) -> list:
    """A container's payload, dequantized, as the program's weight
    arguments in order."""
    weights, i = [], 0
    while f"w{i}" in npz or f"q{i}" in npz:
        if f"w{i}" in npz:
            weights.append(torch.from_numpy(np.array(npz[f"w{i}"])))
        else:
            weights.append(torch.from_numpy(
                npz[f"q{i}"].astype(np.float32) * npz[f"s{i}"]))
        i += 1
    return weights


def near_tie_flips(ids, logits, *, rel_gap: float = 1e-4):
    """Where ``ids`` differ from the argmax of the float32 ``logits``
    (numpy, (n, H, W) and (n, H, W, C)): (fraction of pixels that differ,
    the largest top-2 logit gap among them relative to the logit scale).
    Raises AssertionError unless every difference is a near-tie, a gap of
    at most ``rel_gap`` of the scale: reassociated float arithmetic flips
    only those."""
    ref = logits.argmax(-1)
    differ = ids != ref
    if not differ.any():
        return 0.0, 0.0
    got_l = np.take_along_axis(logits, ids[..., None].astype(np.int64),
                               -1)[..., 0]
    ref_l = np.take_along_axis(logits, ref[..., None].astype(np.int64),
                               -1)[..., 0]
    gap = float(np.abs(ref_l - got_l)[differ].max())
    scale = float(np.abs(logits).max()) + 1e-30
    if gap / scale > rel_gap:
        raise AssertionError(
            f"ids disagree with the direct forward on "
            f"{float(differ.mean()):.3%} of pixels with relative logit gap "
            f"up to {gap / scale:.2e} (not near-ties)")
    return float(differ.mean()), gap / scale


def _self_check(artifact: LoadedArtifact, channels: int, label_hw,
                batch: Optional[int], model, output: str, *,
                tol: float = 1e-4, bf16: bool = False) -> float:
    """The loaded artifact against the direct forward of ``model`` (on
    the artifact's device) on random pixels (JAX ``_self_check``). Returns
    the argmax-flip fraction ('ids'; raises unless every flip is a logit
    near-tie), the max abs logit difference ('logits'; raises beyond
    ``tol`` of the logit scale) or the max abs pixel difference ('image';
    raises beyond ``tol``)."""
    n = batch or 3    # any size exercises a symbolic batch
    lo = -1 if output == "image" else 0   # generators eat normalised pixels
    x = np.random.default_rng(0).uniform(
        lo, 1, size=(n, *label_hw, channels)).astype(np.float32)
    got = artifact.call(x).cpu().numpy()
    xt = torch.from_numpy(x).to(artifact.device)
    model = model.eval()
    with torch.inference_mode():
        if output == "image":
            ref = generator_forward(model, xt, bf16).cpu().numpy()
        else:
            logits = seg_forward(model, xt, label_hw, "logits",
                                 bf16).cpu().numpy()
    if output == "image":
        diff = float(np.max(np.abs(got - ref)))
        if diff > tol:
            raise AssertionError(f"exported generator diverges from the "
                                 f"direct forward: max abs diff {diff:.3e}")
        return diff
    if output == "ids":
        return near_tie_flips(got, logits)[0]
    diff = float(np.max(np.abs(got - logits)))
    scale = float(np.abs(logits).max()) + 1e-30
    if diff / scale > tol:
        raise AssertionError(
            f"exported logits diverge from the direct forward: max abs "
            f"diff {diff:.3e} ({diff / scale:.2e} of the logit scale)")
    return diff


def dequantized_model(model):
    """A copy of ``model`` carrying its int8 round-trip weights: what an
    int8 container computes, and what its self-check holds it to."""
    qdict, scales, _ = quantize_state_dict(model.state_dict())
    twin = copy.deepcopy(model)
    twin.load_state_dict(dequantize_state_dict(qdict, scales))
    return twin


def default_artifact_name(checkpoint_name: str, output: str) -> str:
    stem = os.path.splitext(os.path.basename(checkpoint_name))[0]
    return f"{stem}_{output}.pt2"
