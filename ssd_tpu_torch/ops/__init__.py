"""Tensor ops of the port: geometry, anchors, ingest, NMS, postprocess,
matching, targets, losses, and the fused early blocks."""
