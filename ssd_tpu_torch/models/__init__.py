"""The port's models: MobileNet-v1 (dense4 and reference schedules), FPN,
RetinaNet head."""
