"""idle_pct.n16384: :func:`benchmark_torch.readers.idle_pct`, in the n = 16384
cells (moves tflops.n16384)."""

from benchmark_torch.readers import idle_pct as read  # noqa: F401
