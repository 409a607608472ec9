"""Dense transformer in PyTorch, parameters as stacked dicts."""
