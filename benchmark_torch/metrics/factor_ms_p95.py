"""factor_ms_p95: :func:`benchmark_torch.readers.factor_ms_p95`."""

from benchmark_torch.readers import factor_ms_p95 as read  # noqa: F401
