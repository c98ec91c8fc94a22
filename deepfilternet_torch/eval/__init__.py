"""Evaluation metrics and loops: the port's copy of `deepfilternet_tpu.eval`."""
