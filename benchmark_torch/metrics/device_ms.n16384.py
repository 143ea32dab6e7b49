"""device_ms.n16384: :func:`benchmark_torch.readers.device_ms`, in the n = 16384
cells (moves tflops.n16384)."""

from benchmark_torch.readers import device_ms as read  # noqa: F401
