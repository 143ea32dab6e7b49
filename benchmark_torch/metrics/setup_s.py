"""setup_s: :func:`benchmark_torch.readers.setup_s`."""

from benchmark_torch.readers import setup_s as read  # noqa: F401
