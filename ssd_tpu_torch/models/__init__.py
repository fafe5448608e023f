"""The port's models: MobileNet-v1 (dense4), FPN, RetinaNet head."""
