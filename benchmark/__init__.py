"""The benchmark of the PyTorch and CUDA port (``temporalalignnet_torch``)."""
