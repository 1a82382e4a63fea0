"""repro_torch.optim -- the reference's optimizers and gradient
compression over dicts of tensors, updating in place."""
