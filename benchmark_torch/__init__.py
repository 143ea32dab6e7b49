"""The benchmark of `mpf_tpu_torch`, the PyTorch and CUDA port, on NVIDIA cards.

    python3 -m benchmark_torch.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of the
checkout.  Everything that belongs to one cell, configuration, traffic mix or
metric is a file of its own, found by its name:

* ``configs/<config>.json``: the deployment as it is run (size, block, panel
  width, precision policy, the loop's knobs), its source and its cuts;
* ``traffic/<traffic>.json``: the matrix class and the loop, read by the one
  generator of :mod:`benchmark_torch.traffic`;
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

The yardstick (the generator, the fp64 oracle and the plain reference LU of
:mod:`benchmark_torch.reference`, the peaks, operation and byte counts of
:mod:`benchmark_torch.yardstick`, the trace reduction of
:mod:`benchmark_torch.trace`) lives here, apart from the program.  Nothing
here imports JAX or the JAX package.
"""
