"""The benchmark of ``repro_torch``, the ARCHES port to PyTorch and CUDA.

``python -m arches_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card: closed-loop
campaigns back to back through ``ArchesSession.run()`` for ``--seconds``,
then one of them checked against the plain reference in
``arches_bench/reference``.  It imports neither JAX nor the JAX package.
"""
