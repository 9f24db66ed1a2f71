from gim_tpu_torch.models.roma.model import RoMaMatcher, cls_to_flow_refine

__all__ = ["RoMaMatcher", "cls_to_flow_refine"]
