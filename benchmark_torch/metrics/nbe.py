"""nbe: :func:`benchmark_torch.readers.nbe`."""

from benchmark_torch.readers import nbe as read  # noqa: F401
