from . import boxes, hfc, rel_pos, windows

__all__ = ["boxes", "hfc", "rel_pos", "windows"]
