# _library registers the forward kernels' operators (torch.ops.wm)
from . import _library, boxes, hfc, rel_pos, windows

__all__ = ["boxes", "hfc", "rel_pos", "windows"]
