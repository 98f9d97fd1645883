"""Plain PyTorch and CUDA ops of the port."""
