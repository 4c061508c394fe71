"""GROR initial alignment (port of psulvsb_tpu.gror)."""

from psulvsb_tpu_torch.gror.gror import GRORInitialAlignment, GRORResult, gror_align

__all__ = ["GRORInitialAlignment", "GRORResult", "gror_align"]
