"""prepivot_roofline.n16384:
:func:`benchmark_torch.masked_work.prepivot_roofline`, kernel 7's share of
its roofline, in the masked n = 16384 cell (moves tflops.n16384)."""

from benchmark_torch.masked_work import prepivot_roofline as read  # noqa: F401
