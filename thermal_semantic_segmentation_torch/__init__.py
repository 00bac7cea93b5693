"""PyTorch/CUDA port of the thermal semantic segmentation framework.

A second package beside ``thermal_semantic_segmentation_tpu`` (the JAX
reference). Module names mirror the reference so each counterpart is easy
to find. Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`.device`); every hand-written kernel lives under
``kernels/`` with its CUDA source under ``csrc/`` and a plain PyTorch version
beside it.
"""
