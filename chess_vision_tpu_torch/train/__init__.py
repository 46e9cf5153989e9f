"""Training of the port: losses, metric sums, schedule, optimizer state, the
train and eval steps, and the ``python -m chess_vision_tpu_torch.train`` CLI."""
