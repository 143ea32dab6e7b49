"""exchange_ms.n65536: :func:`benchmark_torch.readers.exchange_ms`, in the n =
65536 cells (moves tflops.n65536)."""

from benchmark_torch.readers import exchange_ms as read  # noqa: F401
