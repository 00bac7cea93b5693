"""Recipe gate: parse 'mean iou score: [x]' from an eval log and assert it
clears a threshold.

Usage: python assert_miou.py <eval_log_path> <min_miou>

The log is the port's segmentation_evaluate CLI's output (the reference's
print, segmentation_evaluate.py:151-155); 0.52 is the reference's own
best-run save threshold (self_train_main.py:53).
"""

import re
import sys


def parse_miou(text: str) -> float:
    """The eval CLI's 'mean iou score' line as a float."""
    m = re.search(r"mean iou score: \[?([0-9.eE+-]+)\]?", text)
    if m is None:
        raise ValueError(f"no mean iou in eval output:\n{text}")
    return float(m.group(1))


def main(log_path: str, min_miou: float) -> float:
    with open(log_path) as f:
        miou = parse_miou(f.read())
    print(f"[recipe] final mIoU = {miou:.4f} (threshold {min_miou})")
    if miou < min_miou:
        raise SystemExit(f"mIoU {miou:.4f} below threshold {min_miou}")
    print("[recipe] PASSED")
    return miou


if __name__ == "__main__":
    main(sys.argv[1], float(sys.argv[2]))
