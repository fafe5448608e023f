"""Accuracy evaluation: the COCO evaluator and the sanity-artifact mAP."""
