from gim_tpu_torch.models.loftr.model import FinePreprocess, LoFTRMatcher

__all__ = ["FinePreprocess", "LoFTRMatcher"]
