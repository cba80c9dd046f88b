"""Training state, the train and eval steps, and data parallelism over torch.distributed."""
