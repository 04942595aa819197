"""Export of the detector's forward for serving; counterpart of
wildlifemapper_tpu/compat/export.py (the analog of the reference's ONNX
export, utils/onnx.py / SamOnnxModel).

`torch.export` traces the forward into an ExportedProgram; on the card the
hand-written kernels enter it as the `wm::` operators of ops/_library.py
(fake implementations give their shapes while tracing), so the program
launches them, and counts their launches, when it runs. `torch.export.save`
writes it as a `.pt2` file that a process without the model code loads
after importing `wildlifemapper_tpu_torch.ops`, which registers the
operators (`load_exported`).

Unlike the JAX artifact, which takes `(params, images)`, the program
carries its weights, as torch's idiom has it: the loaded callable takes
`images` alone and returns {"pred_logits", "pred_boxes"}.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
from torch.export import Dim


def export_forward(model, batch_size: Optional[int] = 1,
                   img_size: Optional[int] = None
                   ) -> torch.export.ExportedProgram:
    """The forward `model(images)` on (batch, img_size, img_size, 3) float32
    images, traced under no_grad on the model's device. batch_size=None
    exports a symbolic batch (Dim "batch"): one program for every batch
    size. The spatial size stays static (default the model's img_size): the
    window partition and the rel-pos tables are shaped by it."""
    img_size = img_size or model.config.img_size
    device = next(model.parameters()).device
    # a symbolic batch is traced at 2: 0 and 1 would be specialised
    x = torch.zeros((2 if batch_size is None else batch_size, img_size,
                     img_size, 3), device=device)
    dynamic = ({"images": {0: Dim("batch")}} if batch_size is None
               else None)
    with torch.no_grad():
        return torch.export.export(model, (x,), dynamic_shapes=dynamic)


def save_exported(model, path: str, batch_size: Optional[int] = 1,
                  img_size: Optional[int] = None) -> Path:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(export_forward(model, batch_size, img_size), str(out))
    return out


def load_exported(path: str):
    """The saved program as a callable module: images -> outputs."""
    from ..ops import _library  # noqa: F401  (registers the wm:: operators)

    return torch.export.load(str(path)).module()
