"""idle_pct.n65536: :func:`benchmark_torch.readers.idle_pct`, in the n = 65536
cells (moves tflops.n65536)."""

from benchmark_torch.readers import idle_pct as read  # noqa: F401
