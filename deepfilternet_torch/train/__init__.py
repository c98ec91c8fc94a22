"""Training: losses, the learning-rate schedule and the train step."""
