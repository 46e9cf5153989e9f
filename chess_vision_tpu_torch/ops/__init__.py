"""Device ops of the port: each holds a hand-written CUDA kernel and the plain
PyTorch version it is tested against."""
