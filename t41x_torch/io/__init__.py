from t41x_torch.io import signals, wav  # noqa: F401
