from repro_torch.data.tokens import TokenStream, make_batch_specs

__all__ = ["TokenStream", "make_batch_specs"]
