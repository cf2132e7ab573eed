"""Plain PyTorch references of the benchmark's configurations (float32, no
kernels), independent of the program under test."""
