"""Training utilities of the port: checkpoints and metric logs."""
