"""trailing_roofline.n65536: :func:`benchmark_torch.readers.trailing_roofline`,
in the n = 65536 cells (moves tflops.n65536)."""

from benchmark_torch.readers import trailing_roofline as read  # noqa: F401
