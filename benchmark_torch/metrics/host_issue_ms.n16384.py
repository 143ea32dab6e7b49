"""host_issue_ms.n16384: :func:`benchmark_torch.readers.host_issue_ms`, in the
n = 16384 cells (moves tflops.n16384)."""

from benchmark_torch.readers import host_issue_ms as read  # noqa: F401
