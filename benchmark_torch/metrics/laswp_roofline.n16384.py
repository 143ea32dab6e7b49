"""laswp_roofline.n16384: :func:`benchmark_torch.masked_work.laswp_roofline`,
kernel 9's share of its roofline, in the masked n = 16384 cell (moves
tflops.n16384)."""

from benchmark_torch.masked_work import laswp_roofline as read  # noqa: F401
