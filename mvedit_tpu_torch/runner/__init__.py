"""The training loop and its hooks."""
