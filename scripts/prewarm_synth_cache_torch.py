#!/usr/bin/env python
"""Pre-render the synthetic tile cache (WM_SYNTH_CACHE) for a coco_path
with the PyTorch port's loader; counterpart of scripts/prewarm_synth_cache.py.

The port's loader keys its disk cache as the JAX loader does (the
annotation file's name, size and mtime, the renderer's version, the resize
and synthetic sizes), so either loader reads the tiles this writes.
Rendering a split ahead of a training run keeps the first epoch from
waiting on the renderer (data/loader.py); a run whose tiles are warm
measures the loop and not the loader. Idempotent: cached tiles are skipped
through the loader's own key. Needs neither jax nor PIL.

Usage: python scripts/prewarm_synth_cache_torch.py --coco_path DIR \
           [--splits train,val] [--synthetic_size 1024]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coco_path", required=True)
    p.add_argument("--splits", default="train,val")
    p.add_argument("--synthetic_size", type=int, default=None)
    p.add_argument("--device_normalize", action="store_true", default=True)
    args = p.parse_args(argv)

    from wildlifemapper_tpu_torch.config import DataConfig
    from wildlifemapper_tpu_torch.data.loader import build_dataset

    for split in args.splits.split(","):
        cfg = DataConfig(coco_path=args.coco_path, image_root="",
                         synthetic=True, synthetic_size=args.synthetic_size,
                         device_normalize=args.device_normalize)
        ds = build_dataset(split, cfg)
        t0 = time.time()
        for i in range(len(ds)):
            ds._raw(i)
            if (i + 1) % 50 == 0 or i + 1 == len(ds):
                dt = time.time() - t0
                print(f"[{split}] {i + 1}/{len(ds)} tiles "
                      f"({dt:.0f}s, {(i + 1) / max(dt, 1e-9):.2f}/s)",
                      flush=True)
    print("PREWARM_DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
