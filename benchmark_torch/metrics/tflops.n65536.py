"""tflops.n65536: :func:`benchmark_torch.readers.tflops`, in the n = 65536
cells."""

from benchmark_torch.readers import tflops as read  # noqa: F401
