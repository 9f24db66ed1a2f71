from gim_tpu_torch.models.loftr.model import (FinePreprocess, LoFTRMatcher,
                                              init_weights)

__all__ = ["FinePreprocess", "LoFTRMatcher", "init_weights"]
