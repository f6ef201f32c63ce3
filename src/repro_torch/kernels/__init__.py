"""Hand-written Hopper kernels for the ARCHES hot spots (sources in
``repro_torch/csrc``), each with a plain PyTorch version beside its wrapper:

* ``mmse_interp``   -- MMSE/Wiener frequency interpolation (fp32 tiled GEMM)
* ``switch_select`` -- the per-UE zero-gap switch and the GATED
  un-compaction scatter, in place
* ``gated_expert``  -- the fused GATED hot path: gather, residual CNN and
  scatter in one kernel
* ``tree_infer``    -- decision-tree policy inference, one thread per row
"""
