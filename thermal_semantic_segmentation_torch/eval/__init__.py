"""Evaluation: metrics, validation loops, translation distance."""

from .distance import evaluate_distance
from .metrics import SegScores, evaluate, scores_from_hist
from .validate import seg_validate

__all__ = ["evaluate_distance", "SegScores", "evaluate", "scores_from_hist",
           "seg_validate"]
