"""Device kernels: plain PyTorch versions and their Hopper kernels."""
