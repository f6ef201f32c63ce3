"""The benchmark of ``repro_torch``, the ARCHES port to PyTorch and CUDA.

``python -m arches_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card: the
campaigns of the program its configuration names (``programs/``; by
default closed-loop ARCHES campaigns through ``ArchesSession.run()``) back
to back for ``--seconds``, then one of them checked against the program's
plain reference.  It imports neither JAX nor the JAX package.
"""
