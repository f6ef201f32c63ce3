"""Hand-written Hopper kernels for the ARCHES hot spots (sources in
``repro_torch/csrc``), each with a plain PyTorch version beside its wrapper:

* ``mmse_interp``   -- MMSE/Wiener frequency interpolation (fp32 tiled GEMM)
* ``switch_select`` -- the zero-gap switch: the host loop's scalar switch
  (in place), the per-UE switch and the GATED un-compaction scatter (out of
  place)
* ``gated_expert``  -- the fused GATED hot path: gather, residual CNN and
  scatter in one kernel
* ``tree_infer``    -- decision-tree policy inference, one thread per row,
  and the closed loop's whole decision phase for a tree in one launch
  (``policy_step``)
"""
