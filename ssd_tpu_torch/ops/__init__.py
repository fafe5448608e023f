"""Tensor ops of the port: geometry, anchors, ingest, NMS, postprocess."""
