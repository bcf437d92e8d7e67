"""Training: schedules, state, the train and eval steps, checkpoints and
the training loop (port of the JAX package's ``train/``)."""
