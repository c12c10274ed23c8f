"""Command-line entry points of the port (`serve`: batched LM decode with
the continuous-batching engine; `train`: the training loop)."""
