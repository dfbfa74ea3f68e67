"""Training: optimizers and the train step."""
