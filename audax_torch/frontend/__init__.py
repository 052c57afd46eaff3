from audax_torch.frontend.features import LogMelFrontend, pad_or_trim

__all__ = ["LogMelFrontend", "pad_or_trim"]
