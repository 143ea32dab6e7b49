"""trailing_roofline.n16384: :func:`benchmark_torch.readers.trailing_roofline`,
in the n = 16384 cells (moves tflops.n16384)."""

from benchmark_torch.readers import trailing_roofline as read  # noqa: F401
