"""Training state and the single-GPU train step."""
