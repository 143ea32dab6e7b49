"""masked_panel_ms.n16384: :func:`benchmark_torch.masked_work.masked_panel_ms`,
device ms per factorization of kernels 7, 8 and 9, in the masked n = 16384
cell (moves tflops.n16384)."""

from benchmark_torch.masked_work import masked_panel_ms as read  # noqa: F401
