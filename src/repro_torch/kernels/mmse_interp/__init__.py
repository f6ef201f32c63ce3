from repro_torch.kernels.mmse_interp.ops import mmse_interp, mmse_interp_ref

__all__ = ["mmse_interp", "mmse_interp_ref"]
