"""Scaled proxy of the trained-weights crop-drift measurement, for the
PyTorch port; counterpart of scripts/drift_proxy_cpu.py.

The north-star conjunction needs drift-as-mAP between the full-canvas
function and the checkpoint-compat crop tier measured with TRAINED weights
(random init is a worst-case bound). scripts/conjunction_torch.py measures
it at 1024 px on one checkpoint; this proxy runs the whole experiment,
training included, at 1/16 of the pixels:

  * same geometry ratio: 192-px content in a 256-px canvas (vs 768-in-1024),
    a 16x16 token grid cropped to 12x12, so the crop drops the same 44 % of
    pad tokens;
  * same training recipe: synthetic ellipse tiles from the annotation
    geometry (boxes scaled --box_scale x), AdamW + StepLR, clip 1.0, bf16,
    the encoder trained;
  * same measurement: f32 full-canvas detections as pseudo ground truth,
    each tier scored with the port's COCOeval (scripts/drift_map_torch.py
    methodology), and each tier's AP against the annotations.

The proxy runs the plain path (use_flash=False), as the JAX script does: no
kernel takes its shapes (head dim 32 at 256 tokens, the adaptor's 24).
Runs on the card unless --device says otherwise; writes checkpoints under
--work_dir and prints per-tier drift lines, the device, and one JSON verdict
line (or, with --checkpoint_trend, one JSON line of rows), with the JAX
script's keys. Two differences from the JAX script: the random-init
contrast draws from a torch.Generator seeded 7 where the JAX script uses
PRNGKey(7), so its draws differ by construction; and --checkpoint_every
(default 10, the JAX script's fixed cadence) sets which checkpoint_epoch_N
files a run leaves for --checkpoint_trend.

Usage:
  python scripts/drift_proxy_torch.py --box_scale 16 --n_train 32 \\
      [--epochs 60] [--eval_every 10] [--n_imgs 64] [--device cpu]
  python scripts/drift_proxy_torch.py --skip_train --checkpoint_trend 4,9
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wildlifemapper_tpu_torch.config import (Config, DataConfig,  # noqa: E402
                                             DecoderConfig, HFCConfig,
                                             MatchCriterionConfig,
                                             TrainConfig, ViTConfig,
                                             model_config)


def proxy_model_config(dtype="float32", content_size=None,
                       use_flash=False, aux_loss=False):
    base = model_config("vit_b", dtype=dtype, use_flash_attention=use_flash,
                        content_size=content_size)
    return dataclasses.replace(
        base, img_size=256, patch_size=16,
        vit=ViTConfig(embed_dim=192, depth=6, num_heads=6,
                      global_attn_indexes=(2, 5), window_size=4,
                      out_chans=128),
        # ffn_dim must equal proj_dim (the adaptor's FFN residual adds the
        # proj_dim stream; the reference uses 1024 for both)
        hfc=HFCConfig(embed_dim=96, proj_dim=96, num_heads=4, ffn_dim=96),
        decoder=DecoderConfig(transformer_dim=128, mlp_dim=256,
                              num_queries=51, num_heads=4,
                              aux_loss=aux_loss))


# Scaled-box annotation sets live under <tmp>/prof/proxy_ann{factor}[_n{N}]
# (<tmp> the temporary directory, TMPDIR).
#
# Why scaled boxes: the bundled geometry is ~49 px animals on 5472 px
# frames, ~7 px after the DETR resize at full scale (768 content), i.e.
# sub-patch at patch 16. The reference only localizes these on top of
# SAM-pretrained features; trained from scratch the loss plateaus at GIoU
# <= 0 on them. `--box_scale` sets the object-to-patch ratio of the proxy:
# 4x matches the reference's true (sub-patch) ratio, 16x gives ~1.7 patches
# an animal, the convergence-feasible configuration. The drift methodology
# is unchanged: the synthetic renderer draws whatever geometry the
# annotations carry.
PROXY_ANN_ROOT = os.path.join(tempfile.gettempdir(), "prof", "proxy_ann")


def proxy_ann_dir(factor, n_train=None):
    if factor == 4.0 and n_train is None:
        return PROXY_ANN_ROOT
    tag = f"{factor:g}" + (f"_n{n_train}" if n_train else "")
    return f"{PROXY_ANN_ROOT}{tag}"


def proxy_data_config(ann_dir=PROXY_ANN_ROOT):
    coco = ann_dir if os.path.exists(f"{ann_dir}/train.json") \
        else DataConfig.coco_path
    return DataConfig(coco_path=coco, synthetic=True, synthetic_size=256,
                      resize_size=192, canvas_size=256, batch_size=8,
                      flip_prob=0.5, num_workers=0)


def build_scaled_annotations(src_dir, out_dir=PROXY_ANN_ROOT, factor=4.0,
                             n_train=None):
    """Derive the proxy annotation set: boxes scaled `factor`x around their
    centers (capped at 30% of the image side, clamped in-bounds). With
    `n_train`, the train split keeps only its first n images (fast
    convergence runs); val is never subset."""
    from wildlifemapper_tpu_torch.data.coco import load_ann_json

    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "val"):
        # load_ann_json, not open(): it resolves these to the gzipped
        # vendored bundle (assets/coco_annotations/*.json.gz)
        d = load_ann_json(f"{src_dir}/{split}.json")
        if split == "train" and n_train:
            d["images"] = d["images"][:n_train]
            keep = {im["id"] for im in d["images"]}
            d["annotations"] = [a for a in d["annotations"]
                                if a["image_id"] in keep]
        dims = {im["id"]: (im["width"], im["height"]) for im in d["images"]}
        for a in d["annotations"]:
            x, y, w, h = a["bbox"]
            cx, cy = x + w / 2, y + h / 2
            iw, ih = dims[a["image_id"]]
            w2, h2 = min(w * factor, iw * 0.3), min(h * factor, ih * 0.3)
            x2 = min(max(cx - w2 / 2, 0), iw - w2)
            y2 = min(max(cy - h2 / 2, 0), ih - h2)
            a["bbox"] = [x2, y2, w2, h2]
            a["area"] = w2 * h2
        with open(f"{out_dir}/{split}.json", "w") as f:
            json.dump(d, f)


def train_proxy(workdir, epochs, eval_every, resume, ann_dir=PROXY_ANN_ROOT,
                aux_loss=False, lr_drop=40, checkpoint_every=10,
                device=None):
    from wildlifemapper_tpu_torch.train.loop import train

    cfg = Config(model=proxy_model_config("bfloat16", aux_loss=aux_loss),
                 data=proxy_data_config(ann_dir),
                 train=TrainConfig(lr=1e-4, epochs=epochs, lr_drop=lr_drop,
                                   clip_max_norm=1.0, use_amp=True,
                                   freeze_encoder=False,
                                   eval_every=eval_every,
                                   checkpoint_every=checkpoint_every),
                 criterion=MatchCriterionConfig())
    t0 = time.time()
    stats = train(cfg, workdir=workdir, resume=resume, device=device)
    print(f"training done in {time.time()-t0:.0f}s; final stats:")
    for k, v in sorted(stats.items()):
        print(f"  {k}: {v:.4f}")
    return stats


def val_tiles(n, ann_dir=PROXY_ANN_ROOT):
    from wildlifemapper_tpu_torch.data.loader import build_dataset

    dc = dataclasses.replace(proxy_data_config(ann_dir), flip_prob=0.0)
    ds = build_dataset("val", dc)
    n = min(n, len(ds))
    return np.stack([ds.get(i)["image"] for i in range(n)]).astype(np.float32)


def eval_ap_vs_gt(mc, weights, ann_dir, device=None):
    """Val-split AP against the real (scaled) annotations for one tier, the
    conjunction's metric of record (crop/full AP ratio), complementing the
    stricter detections-vs-detections drift below. `weights` is the port's
    state dict."""
    from wildlifemapper_tpu_torch.data.loader import DataLoader, build_dataset
    from wildlifemapper_tpu_torch.eval.evaluate import evaluate
    from wildlifemapper_tpu_torch.train.step import StepBuilder

    dc = dataclasses.replace(proxy_data_config(ann_dir), flip_prob=0.0)
    cfg = Config(model=mc, data=dc,
                 train=TrainConfig(use_amp=mc.dtype == "bfloat16"))
    ds = build_dataset("val", dc)
    builder = StepBuilder(cfg, device=device)
    builder.model.load_state_dict(weights)
    loader = DataLoader(ds, dc.batch_size, shuffle=False, drop_last=False,
                        pin_memory=builder.device.type == "cuda")
    try:
        stats = evaluate(builder.eval_step, builder.model, loader, ds.index,
                         cfg, print_fn=lambda *a, **k: None)
    finally:
        loader.close()
    return stats["coco/AP"], stats["coco/AP50"]


def run_tier(cfg, weights, tiles, batch=8, device=None):
    """Detections of configuration `cfg` holding the state dict `weights`
    over `tiles`."""
    from wildlifemapper_tpu_torch.eval.drift import run_detections
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    model = WildlifeMapper(cfg, device=device).eval()
    model.load_state_dict(weights)
    return run_detections(model, tiles, batch=batch)


def drift_ap(gt_dets, pred_dets, n, gt_thresh=0.3):
    from wildlifemapper_tpu_torch.eval.drift import drift_summary

    return drift_summary(gt_dets, pred_dets, n, gt_thresh=gt_thresh)["AP"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work_dir", default=os.path.join(
        tempfile.gettempdir(), "prof", "proxy_train"))
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--eval_every", type=int, default=10)
    ap.add_argument("--checkpoint_every", type=int, default=10,
                    help="write checkpoint_epoch_N every this many epochs "
                         "(and at the last)")
    ap.add_argument("--n_imgs", type=int, default=64)
    ap.add_argument("--box_scale", type=float, default=4.0,
                    help="annotation box scale factor: 4 = the reference's "
                         "true sub-patch ratio, 16 = ~1.7 patches/animal "
                         "(convergence-feasible)")
    ap.add_argument("--n_train", type=int, default=None,
                    help="subset the train split to its first N images")
    ap.add_argument("--aux_loss", action="store_true",
                    help="deep supervision on the intermediate decoder layer")
    ap.add_argument("--lr_drop", type=int, default=40)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--skip_train", action="store_true",
                    help="measure drift on an existing work_dir checkpoint")
    ap.add_argument("--checkpoint_trend", default=None,
                    help="comma-separated epoch numbers: instead of the "
                         "single best-checkpoint verdict, measure the "
                         "crop/full parity ratio + drift at each "
                         "checkpoint_epoch_N in work_dir; the trend over "
                         "training is the mechanism evidence (pad-token "
                         "contribution -> 0 as the model converges)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "CUDA), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")

    ann_dir = proxy_ann_dir(args.box_scale, args.n_train)
    if not os.path.exists(f"{ann_dir}/train.json"):
        from wildlifemapper_tpu_torch.data.coco import resolve_ann_file
        src = os.path.dirname(resolve_ann_file(
            DataConfig.coco_path + "/train.json"))
        build_scaled_annotations(src, ann_dir, args.box_scale, args.n_train)

    if not args.skip_train:
        train_proxy(args.work_dir, args.epochs, args.eval_every, args.resume,
                    ann_dir=ann_dir, aux_loss=args.aux_loss,
                    lr_drop=args.lr_drop,
                    checkpoint_every=args.checkpoint_every, device=dev)

    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.train.checkpoints import CheckpointManager

    print("device: " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"), flush=True)
    cfg32 = proxy_model_config("float32")
    m32 = WildlifeMapper(cfg32, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).eval()

    def run(cfg, weights, tiles):
        return run_tier(cfg, weights, tiles, device=dev)

    def ap_vs_gt(cfg, weights):
        return eval_ap_vs_gt(cfg, weights, ann_dir, device=dev)

    if args.checkpoint_trend:
        cfg_crop = proxy_model_config("bfloat16", content_size=192)
        cfg_full = proxy_model_config("bfloat16")
        tiles = val_tiles(args.n_imgs, ann_dir)
        rows = []
        for ep in (int(e) for e in args.checkpoint_trend.split(",")):
            p = CheckpointManager.load_params(
                f"{args.work_dir}/checkpoint_epoch_{ep}", m32).state_dict()
            gt = run(cfg32, p, tiles)
            crop_dets = run(cfg_crop, p, tiles)
            drift = drift_ap(gt, crop_dets, len(tiles))
            drift05 = drift_ap(gt, crop_dets, len(tiles), gt_thresh=0.5)
            full_ap = ap_vs_gt(cfg_full, p)
            crop_ap = ap_vs_gt(cfg_crop, p)
            ratio = crop_ap[0] / full_ap[0] if full_ap[0] > 0 else float("nan")
            r50 = crop_ap[1] / full_ap[1] if full_ap[1] > 0 else float("nan")
            rows.append({"epoch": ep, "crop_drift_ap": drift,
                         "crop_drift_serve05": drift05,
                         "full_ap": full_ap[0], "crop_ap": crop_ap[0],
                         "parity_ratio": ratio, "parity_ratio_ap50": r50})
            print(f"epoch {ep}: crop-drift={drift:.4f} "
                  f"(@serve0.5 {drift05:.4f}) "
                  f"full-AP={full_ap[0]:.4f} crop-AP={crop_ap[0]:.4f} "
                  f"ratio={ratio:.4f} ratio@50={r50:.4f}", flush=True)
        print(json.dumps({"experiment": "cpu_proxy_parity_trend",
                          "rows": rows}))
        return

    params = CheckpointManager.load_params(
        f"{args.work_dir}/best_checkpoint", m32).state_dict()
    print("loaded trained proxy params", flush=True)

    tiles = val_tiles(args.n_imgs, ann_dir)
    n = len(tiles)
    gt = run(cfg32, params, tiles)
    print(f"pseudo-GT detections: {int((gt['scores'] > 0.3).sum())}",
          flush=True)

    tiers = [("f32-self", cfg32),
             ("bf16-full", proxy_model_config("bfloat16")),
             ("bf16-crop", proxy_model_config("bfloat16",
                                              content_size=192))]
    results, results_serve = {}, {}
    for tag, cfg in tiers:
        dets = run(cfg, params, tiles)
        results[tag] = drift_ap(gt, dets, n)
        # the serving threshold's pseudo-GT (0.5, visualize_prediction.py:150),
        # the same rows drift_map_torch.py reports
        results_serve[tag] = drift_ap(gt, dets, n, gt_thresh=0.5)
        print(f"{tag}: drift-AP={results[tag]:.4f} "
              f"(@serve0.5 {results_serve[tag]:.4f})", flush=True)

    # AP against the real (scaled) annotations, per tier: the parity metric
    # of record; its crop/full ratio is the conjunction's gate
    ap_gt = {}
    for tag, cfg in tiers:
        ap_gt[tag] = ap_vs_gt(cfg, params)
        print(f"{tag}: AP-vs-GT={ap_gt[tag][0]:.4f} "
              f"AP50={ap_gt[tag][1]:.4f}", flush=True)
    full_ap, crop_ap = ap_gt["bf16-full"][0], ap_gt["bf16-crop"][0]
    ratio = crop_ap / full_ap if full_ap > 0 else float("nan")
    print(f"crop/full AP-vs-GT parity ratio: {ratio:.4f}", flush=True)

    # the random-init contrast on the same proxy (the worst-case bound)
    rand = WildlifeMapper(cfg32, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev).state_dict()
    gt_r = run(cfg32, rand, tiles)
    crop_r = run(proxy_model_config("bfloat16", content_size=192), rand,
                 tiles)
    rand_drift = drift_ap(gt_r, crop_r, n)
    print(f"random-init bf16-crop contrast: drift-AP={rand_drift:.4f}",
          flush=True)

    print(json.dumps({
        "experiment": "cpu_proxy_trained_weights_crop_drift",
        "geometry": "192-content in 256-canvas (1/16 px of 768-in-1024)",
        "trained": results, "trained_serve05": results_serve,
        "random_init_crop": rand_drift,
        "ap_vs_gt": {k: list(v) for k, v in ap_gt.items()},
        "map_parity_ratio": ratio,
    }))


if __name__ == "__main__":
    main()
