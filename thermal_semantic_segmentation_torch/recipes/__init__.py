"""Recipes: the accuracy gates (``gates.py``) on the synthetic trees of
``synthetic_trees.py``, the full shell pipeline (``full_pipeline.sh``) and
its mIoU check (``assert_miou.py``)."""
