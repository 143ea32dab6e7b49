"""tflops.n16384: :func:`benchmark_torch.readers.tflops`, in the n = 16384
cells."""

from benchmark_torch.readers import tflops as read  # noqa: F401
