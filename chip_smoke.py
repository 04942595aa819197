"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port's paths at the full ViT-B width, through its
hand-written CUDA kernels, and checks them: serving (wildlifemapper_tpu_torch:
HFC -> ViT-B -> box decoder -> postprocess + NMS) and training (train/step.py:
forward, set criterion with the Hungarian match, backward through the
backward kernels, clip, AdamW), each in both layouts of the attention
kernels: attn_impl="packed" (K1 windowed, K2 global, K3 MLP, K4 adaptor) and
attn_impl="grouped" (K6 windowed, K5 global, K4; plain MLP). Also serves
ViT-L and ViT-H through the packed kernels (ViT-H also in f32), and trains
the ViT-H fine-tune with remat_blocks at its full width and depth (the path
of the head-dim-80 Hopper and resident backward) in both layouts, and runs
the training loop (train/loop.py: loader, checkpoints, resume, per-epoch
COCO evaluation) in two configurations, and serves surveys (a reference
.pth, orthomosaic detection of a full-size frame, drift-as-mAP, the native
matcher), and drives the compat surface (the predictor, the exported
forward through the kernels' `wm::` operators, the operators themselves),
and runs the data-parallel path (torchrun, DDP, two ranks on the card), and
trains ViT-L and ViT-H from scratch and runs the scripts users run, and
trains over a model axis of two ranks (tensor parallelism) on the card.
Phases, one JSON line each; any failure raises and exits non-zero:

  1. device: the card's name and power limit; build the kernels from
     wildlifemapper_tpu_torch/csrc (timed), registers and spills of every
     instantiation, the Hopper (wgmma + TMA) and the resident (windowed)
     bodies included, the latter, the Hopper forward and backward, the K3
     GEMM body, the f32 K3 GEMM body (also to at most 128 registers, two
     blocks an SM) and every head-dim-80
     instantiation (the tile bodies, the Hopper forward and backward, the
     resident forward and backward) held to no spill, the f32 streaming
     backward's twelve instantiations (csrc/attention_bwd_f32.cuh), the
     f32 window backward's twelve (csrc/attention_bwd_f32_window.cuh), the
     f32 window forward's twelve (csrc/attention_fwd_f32_window.cuh),
     K4's f32 body at d 128, its forward and its backward's delta, dk/dv
     and dq kernels (csrc/attention_fwd_f32.cuh, attention_bwd_f32_d128.cuh)
     and the f32 forward of K2 and K5 at d 64 and 80, packed and grouped
     (the same header's four other instantiations) too, and no line of
     ptxas saying it serialized the wgmma products of a
     kernel (C7515); TF32 off.
  2. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it, f32 at atol 2e-5 / rtol 1e-4 and
     bf16 (against the plain version in f32 on the same bf16-rounded
     inputs) at 2e-2, and the bf16 forward of the Hopper body (K2, K4, K5)
     and of the resident body (K1, K6), and K4's f32 forward on the f32 body
     (N = M 4096 and 2304, ragged N != M, a tensor-parallel rank's 4 heads)
     and that of K2 and K5 (d 64 and 80: N 4096 and 2304, ViT-H's B 1, H 16,
     N 4096, ragged 25x40 grids, a tensor-parallel rank's 6 heads and, at
     the launcher, N != M without tables, every grid width the f32 backward
     takes and an 8x65 grid; O and the lse against the plain version),
     twice at the launcher at every shape it takes, O and the lse
     bit-identical; the f32 forward of K1 and K6 on the f32 window body (d 64
     and 80: the wrappers' window shapes in f32, and at the launcher every
     window of F32_WINDOW_LAUNCHER in both families; O and the lse against
     the plain version, twice, bit-identical); K5 and K6 also at d = 128
     and 32, where their scale on the f32 scores rounds differently from a
     scaled q; K2, K4 and K5
     also at shapes that are ragged against the Hopper bodies' 128-row
     blocks and 64- or 128-key tiles (N = 1000 on 25x40 and 20x50 grids,
     N != M, a last tile of 6 keys, d = 128 with tables); K1 and K6 also at
     windows that are ragged against the resident bodies' 16-row tiles (49 =
     7x7 with odd table widths, 100 = 10x10, one window-head, a window count
     that is a multiple of nothing); K3 at R = 16384 and 9216 and at rows
     ragged against the GEMM body's 128-row tiles (1, 129, 1000), ViT-L and
     ViT-H widths (both dtypes, also ViT-H at R = 4096 and a
     tensor-parallel rank's F 2560 / 1536 at R = 1000), every K3 case in
     both dtypes run twice, bit-identical; K1,
     K2, K5 and K6 at head dim 80 at ViT-H's shapes (25 windows of 196 and
     4096 tokens, 16 heads, batch 1; bf16 through the Hopper and the
     resident bodies) and ragged against them (K2 on a 25x40 grid, K5 on
     20x50, K1 on windows of 7x7, K6 on 10x10); and at the large encoders'
     training shapes at batch 4 (phase 14): K1 on 100 windows of 196 and
     64 of 144 with 16 heads of 64, and on 64 windows of 144 at head dim
     80, K2 at 16 heads of 64 on N = 4096 and 2304 and at d 80 on 2304,
     K6 at d 80 on 1024 window-heads of 144, K5 on 64 heads of 2304 at d
     64 and 80, K3 at R = 9216 with D 1024 / F 4096 and D 1280 / F 5120,
     in bf16 (14c holds their f32 path end to end); and at a rank's shapes
     over a model axis of 2 (phase 15, "(TP rank"), in bf16: K1 on 64
     windows of 144 with 8 heads of 80 and on 100 windows of 196 with 6
     of 64, K2 at 8 heads of 80 on 2304 and 6 of 64 on 4096, K3 at R =
     9216 with D 1280 / F 2560 and R = 16384 with D 768 / F 1536, K4 at 4
     heads of 128 on 2304 and 4096, K5 on 24 heads of 4096, K6 on 600
     window-heads of 196.
  3. end to end: the f32 forward with kernels, in each layout, against the
     PyTorch reference's logits and boxes in tests/goldens/full_model.npz
     (weights regenerated from their names), at atol 1e-4 / rtol 1e-3, and
     the launch counts of one forward (packed: K1 8, K2 4, K3 12, K4 1;
     grouped: K6 8, K5 4, K4 1 and none of the others).
  4. serving: bf16, batch 4, three batches of 768-px content in a 1024
     canvas through forward + postprocess + NMS in each of the three
     configurations (packed) and in full_canvas and from_scratch (grouped),
     each layout a run of its own with the counts set to 0 before and read
     after; finite detections, boxes in range, launch counts; the
     bf16-kernel against f32-plain drift, and grouped against packed.
  5. times: each configuration with kernels and with the plain path, the
     grouped layout beside the packed one, and each kernel against its
     plain version, with CUDA events.
 4b. large models: ViT-B, ViT-L and ViT-H (head dim 80, D 1280) in bf16 at
     batch 1 through the packed kernels (seeded random weights) against the
     plain path with the same weights: finite detections, the image
     embedding's relative error, class-probability and box drift and label
     agreement, ViT-L's and ViT-H's held to limits scaled from ViT-B's; the
     launch counts of each run (ViT-H's d = 80 attention runs the Hopper
     body in its global blocks and the resident body in its windows, K3 the
     GEMM body), the forward's time beside the card's name and power limit.
     Then ViT-B and ViT-H in f32 at batch 1 through the packed kernels (K3's
     f32 GEMM body, at D 1280 for ViT-H; the tile attention bodies) against the
     plain path with the same weights, logits and boxes at the full model's
     atol 1e-4 / rtol 1e-3, with their launch counts.
  6. kernels, backward: the forward's lse, and the gradients that autograd
     takes through each public wrapper on the card, against the plain
     backward at the training shapes of both configurations (K1 and K6
     N = 196 and 144; K2, K4 and K5 N = 4096 and 2304; K3 R = 16384 and
     9216, ragged at R = 1000 and at ViT-H's widths; all five attention
     kernels also ragged as in phase 2, K1, K2, K5 and K6 also at head dim
     80 at ViT-H's shapes, K2 and K5 there through the Hopper body both ways
     at N = 4096 and 2304 and ragged (25x40, 20x50), K1 and K6 through the
     resident body both ways at N = 196 and ragged (7x7 with odd tables,
     10x10); K3 in f32 also at ViT-H's widths; the large encoders'
     training shapes of phase 2, K1, K2, K5, K6 and K3, in bf16; a rank's
     shapes over a model axis of 2, in bf16: K1, K2 and K3 at ViT-H's and
     ViT-B's, K4 at 4 heads of 128 on 2304, K5 and K6 at ViT-B's): once with
     every input requiring a gradient (dqkv written by stride into one
     packed tensor, drel, the MLP's weight gradients; K5 with 4-D and with
     3-D tables) and once with the activations alone
     (the frozen encoder), f32 at atol 5e-4 / rtol 1e-3 and bf16 at 2e-2 of
     each output's largest element; K3's bf16 weight gradients also against
     the f32 product of the same operands. The bf16 backward of the
     resident bodies (K1, K6: one kernel) and of the Hopper body (K2, K4,
     K5: the dq kernel with delta inside, then dk/dv) twice at the launcher
     at every shape they take, every gradient bit-identical; the same for
     the f32 backward of K2 and K5 at every shape that takes the
     register-tiled f32 body (d 64 and 80, at least 512 keys: B 4 at N 4096
     and 2304, BH 48, ViT-H's B 1, H 16, N 4096 and BH 16 at d 80), and of
     K1 and K6 at every shape that takes the f32 window body (d 64 and 80,
     N = M <= 208: the main paths' windows of 196 and 144, ViT-H's, ragged
     7x7 and 10x10; one kernel a backward, delta inside), and of K4 at every
     shape that takes its f32 body (d 128: N = M 4096 and 2304, ragged N !=
     M, a rank's 4 heads in f32 as in bf16; a delta kernel, the dk/dv kernel
     that leaves ds, the dq kernel).
  7. train step, parity: f32, one step with kernels against the same step on
     the plain path (same weights, batch and dropout seed) in each training
     configuration and each layout: losses, grad_norm and every trainable
     gradient at atol 5e-4 / rtol 1e-3 and within 1e-3 of its own norm;
     launch counts (f32: the windowed backward of K1 / K6 is one kernel of
     the f32 window body a launch, every other attention backward a dq and a
     dk/dv kernel; the windows' forward runs the f32 window forward, whose lse
     that backward reads).
  8. training: bf16, batch 4, three steps on a synthetic uint8 batch in each
     of the two training configurations (train/synthetic.py), once for each
     layout: finite losses, trainable parameters moved and frozen ones
     bit-identical, launch counts forward and backward (bf16: the windowed
     backward of K1 / K6 is one kernel a launch, 8 a step, and no dq or dk/dv
     kernel of theirs runs), peak memory, the loss falling, and one wait for
     the device per step (the matcher's copy).
 8b. the ViT-H fine-tune (train/synthetic.py, variant vit_h: frozen D 1280
     encoder, 32 blocks, 16 heads of 80, seeded weights) with remat_blocks,
     bf16, batch 4, three steps in each layout: finite, falling loss, frozen
     parameters bit-identical, launch counts with the recomputed attention
     forwards counted (K2 / K5 backward on the Hopper body at d = 80, K1 /
     K6 one resident launch a block and no plain delta pass), one wait a
     step, peak memory; the same first
     step without remat_blocks (losses and gradients against it, whether
     bit-identical, its peak memory) and both steps' times in turns.
  9. times, training: ms per step with kernels and on the plain path
     (packed) or beside the packed layout (grouped), the matcher's share,
     each backward kernel against its plain version and against one PyTorch
     library call where there is one (a yardstick here only), the kernels
     that run a Hopper body (K2, K4, K5, forward and backward) or a resident
     body (K1, K6: forward, and the whole backward with the tile bodies'
     delta pass counted in) beside the mma.sync body on the same inputs in
     turns, at the full-canvas shape and, for K1 / K6, at the N = 144 shape
     too, for K2 / K4 / K5 at the N = 2304 shape (the whole backward, dq
     with and without the table gradients, dk/dv), the Hopper forward of
     K2 / K4 / K5 at both shapes over 20 launches a turn with one library
     call over 20 launches and the card's name and power limit beside it
     (`forward_time`), ViT-H's K1, K2, K5 and K6 (head dim 80) at batch 1
     and 4 the same way in turns with the tile body, the whole backward of
     K2 and K5 (the Hopper body) and of K1 and K6 (the resident body) in
     turns with the tile bodies' at batch 1 and 4, beside the plain version
     (the forward at batch 1 and 4, the backward at batch 1) and the library
     call; every kernel beside its
     bound (the larger of its FLOPs over 989
     TFLOP/s and its bytes over 3.35 TB/s); K3 forward and dh at R = 16384
     and 9216 (ViT-B) and at ViT-L's and ViT-H's widths over 20 launches in
     turns with their library yardsticks (bf16 F.linear -> F.gelu ->
     F.linear; F.linear and the GELU-gradient product), the forward's two
     passes alone, and the host time of one wrapper call of each; the
     large encoders' attention shapes of phase 2, forward and whole
     backward, each in turns with the library call, beside the plain
     versions and the bounds, and K3 at R = 9216 with ViT-L's and ViT-H's
     widths (the kernels' "large_shapes"). 9b the f32 bodies
     (scripts/time_f32_kernels.py, F32_ITERS launches a turn): K3's f32 GEMM
     body forward and dh at R = 16384 and 9216 with D 768 and 1024, R = 4096
     and 9216 with D 1280, each in turns with its f32 library call (cuBLAS
     SGEMM chains, TF32 off) beside its bound (f32 operations over 67
     TFLOP/s) and its plain version; the f32 attention bodies (K1, K2, K4,
     K5, K6) forward and whole backward at the main paths' shapes in turns
     with SDPA (the bias as attn_mask) and autograd through it
     (`f32_kernel_time`); the f32 ViT-B full-canvas forward at batch 4
     under the profiler, its device ms and K3's share (`f32_forward_device`;
     phase 10 reads the same for its f32 steps, `loop_f32_device`). The
     "kernels" line gains the f32 K3 body's forward and dh, their launches
     those of the f32 paths (phases 3, 4b, 7 and 14c), and the f32
     streaming backward of K2 and K5 (the register-tiled body: its time at
     the full canvas beside the tile body's, the plain version's, the
     library call's and the bound, ViT-H's d 80 beside; its launches those
     of the f32 steps of phases 7 and 14c, whose global blocks all take it),
     and the f32 window backward of K1 and K6 the same way (the full
     canvas's windows of 196, ViT-H's d-80 windows beside at batch 1 and 4;
     its launches those of the same f32 steps, whose windows all take it),
     and K4's f32 body forward and backward (d 128: N = M 4096, the
     48-grid's 2304 beside, each beside the tile body's time, the plain
     version's, the library call's and the bound; its launches those of the
     f32 paths, phases 3, 4b, 7 and 14c), and the f32 forward of K2 and K5
     on the same body (d 64: N 4096, the 48-grid's 2304 and ViT-H's d 80 at
     batch 1 beside, each beside the tile body's time, the plain version's
     at 4096, the library call's and the bound; its launches those of the
     same f32 paths, whose global blocks all take it), and the f32 forward of
     K1 and K6 on the f32 window forward (the full canvas's windows of 196
     and the from-scratch 144, ViT-H's d-80 windows at batch 1 and 4 (K6:
     batch 1) beside, each beside the tile body's time, the plain
     version's, the library call's and the bound; its launches those of the
     same f32 paths, whose windows all take it).

 10. the training loop (train/loop.py through cli/train.py's Config, the
     vendored annotation bundle, synthetic tiles at 1024 cached in a
     temporary WM_SYNTH_CACHE, bf16, batch 4, full ViT-B): 10a the CLI's
     fine-tune from the golden weights, 2 epochs of 8 steps with evaluation
     on 4 val batches and a checkpoint every epoch, then a resumed third
     epoch in the same process and an unbroken 3-epoch run: every file
     written, the restored state bit for bit the saved one (parameters,
     Adam's state, the lr, step, the dropout generator), COCO stats in
     [0, 1] or -1, the resumed first loss within 2e-2 of the unbroken run's
     (whether bit-identical printed); 10b from scratch from the port's own
     initialisation (--train_encoder --content_size 768 --crop_prologue
     --window_size 12, hfc.dropout 0), 24 steps, the mean loss of the last 6
     below that of the first 6. The counts are set to 0 before 10a and read
     after 10b (the kernels' "launches_loop"); one loop step's launches of
     each configuration exactly those of a bf16 train step, and its waits
     for the device (sync debug mode, from the end of one step to the end
     of the next) at most 2. Read, not gated: the loop's ms a step and
     tiles/s (CUDA events, first step excluded), the same step bare on a
     resident batch, eval tiles/s, peak memory, the loader's host ms a
     batch (thread and process mode, 2 workers, cold and warm, 4 batches
     each), 10 steps of the fine-tune in bf16 beside f32 from the same
     weights and batches,
     and one whole epoch through cli.train.main over the bundle's first 192
     train and 32 val images (48 steps) with the host's RSS a step
     (/proc/self/status).
 11. serving surveys (ViT-B, bf16 unless said): 11a the .pth reader
     (compat/torch_convert.py): a trained WildlifeMapper checkpoint
     ({model, optimizer, epoch}, `module.` prefixes) of the golden weights
     loads into a fresh model bit for bit with nothing missing, and a raw SAM
     file (no hfc key, decoder heads) loads its encoder and decoder
     transformer bit for bit, the surgery cutting the heads and the fresh
     hfc_* and head entries kept bit for bit and named; 11b orthomosaic
     detection (eval/orthomosaic.py) of a 5472 x 3648 frame rendered by the
     loader's synthetic renderer with the boxes of the val image of that
     frame that has most, tile 1024, overlap 256, tile_batch 4 (35 tiles
     in 9 batches), weights from a trained .pth of seeded weights whose class head is
     scaled (CLASS_HEAD_SCALE): detect bit-identical to a synchronous loop
     over the same batches, the launches of 9 forwards (the counts set to 0
     before that detect and read after, the kernels' "launches_mosaic"),
     finite detections within a tile of the frame, and f32 through the
     kernels against f32 on the plain path with drift-as-mAP AP50 1.000 at
     pseudo-GT 0.3 and 0.5; read: ms a mosaic and tiles/s (CUDA events and
     wall, 3 turns), the host's ms extracting, launching, waiting and in
     the NMS, the synchronous loop beside it, the device's busy ms and the
     idle share (torch.profiler, in a pass of its own); 11c
     drift-as-mAP (eval/drift.py) over 16 val tiles from the loader against
     f32 on the plain path at the full canvas, pseudo-GT 0.3 and 0.5, with
     fast_ap50 on the card beside each AP50: f32 with kernels gated at
     1.000, bf16 with kernels in the three serving configurations and the
     grouped full canvas, and ViT-H bf16 with kernels against ViT-H f32
     plain at batch 1 over 4 tiles, read; 11d native.available() on the card
     and the same 12 COCO stats through the C++ matcher as through
     match_greedy.

 12. the compat surface (ViT-B, bf16, seeded weights with the class head
     scaled): 12a the predictor (compat/predictor.py) on a 3648 x 5472 uint8
     frame: set_image launches K1 8, K2 4, K3 12 (24 GEMM launches), K4 1
     and predict none (the counts set to 0 before each and read after);
     its detections at score 0.05 and 0.5 and its embedding bit for bit
     those of forward + postprocess(hw_swap_compat=False) + batched_nms on
     the canvas it made; both calls timed (CUDA events and wall). 12b the
     forward exported (compat/export.py) with a symbolic batch, packed and
     grouped: the graph's `wm::` nodes (packed K1 8, K2 4, K3 12, K4 1;
     grouped K6 8, K5 4, K4 1) and no scaled_dot_product_attention node,
     the export's seconds and the artifact's bytes; both artifacts loaded
     in a fresh process that imports wildlifemapper_tpu_torch.ops and not
     the models, run at batch 1 and 4: bit for bit eager's outputs (else
     held to bf16 2e-2, the reason printed) and eager's launch counts;
     eager against the loaded program at batch 4 in turns. 12c every `wm::`
     operator overload under torch.library.opcheck on the card at a small
     shape. 12d the host's microseconds a call of K1 and K3 through the
     wrapper, the operator and the operator's CUDA implementation (the
     dispatcher's cost the difference within a turn, the median of seven
     turns), phase 4's full-canvas packed serving
     wall ms, and the dispatch's share of it against the 2 % that decides
     the route (the operators, or the launchers with the operators only
     under export).
 13. data parallel (parallel/, the criterion over the global batch, the
     step through DistributedDataParallel; bf16 ViT-B, golden weights, the
     first 32 train / 16 val images of the vendored bundle as synthetic
     tiles at 1024): 13a in this process 3 fine-tune steps through DDP
     over NCCL at world 1 against the same steps with no process group,
     bit for bit (losses, every parameter), DDP's ms a step against none in
     turns, the f32 gradient bytes all-reduced a step (fine-tune, from
     scratch) and the launches of those steps (the counts set to 0 just
     before and read after); then, side by side with 13b-13d's ranks and
     phase 15's (none of them timed against another), `python -m
     torch.distributed.run --nproc_per_node 1 -m
     wildlifemapper_tpu_torch.cli.train` for one epoch of 8 steps with
     evaluation (NCCL at world 1, the real entry point); 13b-13d two ranks
     on this card over gloo (this script with --rank-worker, each under a
     timeout): 13b 3 steps of the fine-tune and from scratch
     (hfc.dropout 0), 2 of phase 8's 4 rows a rank: losses, grad_norm and
     every parameter identical on both ranks, and against one process at
     batch 4 from the same weights and batches each step's loss and
     grad_norm, the parameters' change and the last gradient within the
     DIST_*_TOL relative gaps, which an unchanged state and one process on
     half the batch must both exceed (with 2 cards or more, NCCL over cards
     0 and 1 as well); 13c train/loop.py for 2 epochs of 4 steps with evaluation, then
     a resumed third epoch: only rank 0 writes, both ranks the same COCO
     stats, which one process's evaluation of the last checkpoint gives
     within 1e-3 (bit for bit expected), every evaluation over the whole
     val split; 13d phase 11b's frame and .pth split over the two ranks,
     bit for bit one process's detect. The workers report their launch
     counts, which join 13a's (the kernels' "launches_dist"). The gloo times
     are not those of NCCL across cards.
 14. the large encoders and the scripts users run (seeded weights, bf16,
     packed, remat_blocks): 14a ViT-L (D 1024, 24 blocks, 16 heads of 64)
     at batch 4, 3 steps of the fine-tune and of from scratch
     (train/synthetic.py: crop prologue, windows of 12): finite, falling
     losses, frozen parameters bit-identical and every trainable one moved
     (the encoder's from scratch), the launch counts forward and backward
     with the recomputed attention forwards counted, one wait a step, peak
     memory, ms a step; the first from-scratch step without remat against
     the remat step (whether bit-identical, each gradient within 1e-3 of
     its norm) with its peak memory, both steps in turns, and the matrix
     products of proj's and qkv's shapes one profiled step of each
     dispatches (the recompute repeats qkv's, not proj's); 14b ViT-H from
     scratch (D 1280, 32 blocks, 16 heads of 80) at batch 1 and 4, the
     same, with AdamW's ms over the step's gradients, and one step of the
     grouped layout at batch 1 (K6 on windows of 144, K5 on 2304 at d 80);
     the counts set to 0 just before each of these runs and read just
     after (the kernels' "launches_large"); 14c one f32 from-scratch step
     of ViT-L and of ViT-H at batch 1 through the kernels against the plain
     path, phase 7's tolerances; 14d the scripts: prewarm_synth_cache_torch
     .py fills a temporary WM_SYNTH_CACHE over the bundle's first 16 train
     and 8 val images, cli.train from scratch with ViT-L and --remat runs
     two epochs of 4 steps with their evaluations on that cache (tiles/s,
     the host's RSS a step over the second epoch), eval_checkpoint_series_
     torch.sh scores the last epoch's checkpoint (its coco/AP within 1e-3 of
     the loop's), val_curve.py reads the run's log (a row an epoch), and
     drift_map_torch.py over 4 val
     tiles: f32 through the kernels against f32 plain at AP50 1.000 at
     pseudo-GT 0.3 and 0.5.
 15. tensor parallelism (parallel/mesh.py's model axis,
     parallel/tensor_parallel.py), run after phase 13 and before 14: two
     ranks on this card over gloo (this script with --tp-worker, under a
     timeout, started beside phase 13's subprocesses; NCCL refuses two
     ranks on one device), a model axis of 2 and one data rank. 15a ViT-B's
     fine-tune (packed and grouped) and from scratch (packed), bf16,
     golden weights, hfc.dropout 0, phase 8's batch of 4 on both ranks, 3
     steps against one process: 13b's four relative gaps (loss, grad_norm,
     the parameters' change, the last gradient, over the whole trainable
     parameters gathered from the ranks), the ranks in lock step (losses,
     and every whole parameter bit-identical), each rank's launches those
     of one process; a control that the checks must refuse: the fine-tune
     with block 0's qkv input losing its gradient's sum over the ranks
     (patched in the worker). 15b ViT-H from scratch with remat_blocks at
     full width and depth, batch 4, 2 steps and a third with remat off on
     the same model: finite losses, the whole parameters bit-identical
     across the ranks, the all-reduces of a step as many with remat as
     without, each rank's first-step peak above its start and its exact
     bytes of parameters, gradients and AdamW moments against the count
     the sharding rules give (from the whole model's shapes on the meta
     device). 15c (a rank's kernel shapes) runs in phases 2 and 6. 15d
     train/loop.py over the two ranks for one epoch of 4 steps with
     evaluation; its checkpoint (the one-process format) resumed in this
     process at a model axis of 1 for a second epoch: each epoch's loss
     within 2e-2 of one process's unbroken run. The workers report their
     launch counts (the kernels' "launches_tp"); the step times over gloo
     bound nothing of NCCL across cards.

The last line is {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 4
N_BATCHES = 3
TRAIN_STEPS = 3
PEAK_FLOPS = 989e12   # H100 SXM, bf16 dense
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
PEAK_F32 = 67e12      # H100 SXM, float32 outside the tensor cores
# registers a thread of the f32 K3 GEMM body: 256 threads, two blocks an SM
F32_GEMM_REGISTERS = 128
# the f32 K3 GEMM body's kernel, as the profiler names it
K3_F32_KERNEL = "fused_mlp_gemm_f32_kernel"
# launches a turn when phase 9 times the f32 bodies beside their library
# calls (scripts/time_f32_kernels.py; each call takes 0.3-80 ms)
F32_ITERS = 3
# the f32 streaming backward's rows of the "kernels" line: (kernel, shape)
# of scripts/time_f32_kernels.py at the full canvas, and ViT-H's d-80 shape
F32_BWD_MAIN = {"flash_attention_packed": ("K2", "B=4 N=4096"),
                "flash_attention_rel_pos": ("K5", "BH=4*12 N=4096")}
F32_BWD_D80 = {"K2": "B=1 H=16 N=4096 d=80", "K5": "BH=16 N=4096 d=80"}
# the f32 forward's rows on the 48-grid (the from-scratch step's)
F32_FWD_2304 = {"K2": "B=4 N=2304", "K5": "BH=4*12 N=2304"}
# the f32 window backward's rows of the "kernels" line: (kernel, shape) of
# scripts/time_f32_kernels.py at the full canvas, and ViT-H's d-80 window
# at batch 1 and 4 (K6: batch 1)
F32_WIN_MAIN = {"windowed_attention_packed": ("K1", "BW=4*25 N=196"),
                "windowed_attention_rel_pos": ("K6", "BWH=4*25*12 N=196")}
F32_WIN_D80 = {"K1": ("BW=25 H=16 N=196 d=80", "BW=4*25 H=16 N=196 d=80"),
               "K6": ("BWH=25*16 N=196 d=80",)}
# the f32 window bodies' kernels, as ptxas names them
F32_WINDOW_KERNEL = "attn_bwd_f32_window_kernel"
F32_WINDOW_FORWARD_KERNEL = "attn_fwd_f32_window_kernel"
# the f32 window forward's rows of the "kernels" line beside the full
# canvas's: the from-scratch windows of 144 (tag, kernel's shape)
F32_WIN_144 = {"K1": "BW=4*16 N=144", "K6": "BWH=4*16*12 N=144"}
# the f32 window forward at the launcher in phase 2: windows (window-heads
# in the grouped family: times the heads), heads, grid, head dim, scale
# (None: d ** -0.5): the card tests' F32_WINDOW (tests/test_torch_cuda.py),
# ragged against its slabs, warps and halves of the queries
F32_WINDOW_LAUNCHER = [(100, 2, (14, 14), 64, None),
                       (37, 3, (12, 12), 64, None),
                       (5, 2, (10, 10), 64, None), (3, 1, (7, 7), 64, None),
                       (3, 1, (2, 3), 64, None), (2, 2, (13, 16), 64, None),
                       (2, 1, (16, 13), 64, None),
                       (141, 1, (12, 12), 64, 0.3),
                       (3, 2, (13, 13), 64, None),
                       (2, 1, (12, 15), 80, None),
                       (25, 4, (14, 14), 80, None),
                       (9, 2, (12, 12), 80, None), (4, 2, (10, 10), 80, None),
                       (3, 2, (14, 14), 80, 0.3)]
# K4's f32 body at head dim 128 (csrc/attention_fwd_f32.cuh,
# attention_bwd_f32_d128.cuh): its kernels as ptxas names them
F32_D128_KERNELS = ("attn_fwd_f32_kernel<128,128>",
                    "attn_bwd_f32_d128_delta_kernel<128>",
                    "attn_bwd_f32_d128_dkv_kernel<128>",
                    "attn_bwd_f32_d128_dq_kernel<128>")
# the f32 forward of K2 / K5 at the launcher in phase 2: batch, heads,
# queries, keys, head dim, rel grid, scale (None: d ** -0.5)
F32_FORWARD_LAUNCHER = [(2, 2, 1000, 700, 64, None, None),
                        (1, 2, 1000, 700, 80, None, None),
                        (1, 2, 1024, 1024, 64, (64, 16), 0.3),
                        (1, 2, 600, 600, 80, (25, 24), None),
                        (1, 2, 1024, 1024, 80, (32, 32), 0.25),
                        (1, 2, 1008, 1008, 64, (21, 48), None),
                        (1, 2, 520, 520, 80, (8, 65), None)]
# K4's f32 rows of the "kernels" line: (kernel, shape) of
# scripts/time_f32_kernels.py at the full canvas, the 48-grid beside
F32_K4 = ("K4", "B=4 N=M=4096")
F32_K4_2304 = ("K4", "B=4 N=M=2304")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_query() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


SM90_FLAGS = {"attn_fwd_sm90_kernel": ("scale_scores", "rel"),
              "attn_bwd_dq_sm90_kernel": ("scale_scores", "rel", "drel"),
              "attn_bwd_dkv_sm90_kernel": ("scale_scores", "rel")}


def ptxas_summary(log: str) -> list:
    """'kernel<type,width,...>: registers, spill bytes' for each kernel that
    nvcc's -Xptxas -v compiled. The Hopper bodies are <d, tile, stages> with
    the flags that are set; their register count is the one at entry, before
    setmaxnreg moves the producer's registers to the consumers."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"\d((?:attn|fused_mlp|mlp_dh)[a-z_0-9]*kernel)I(.*?)EEv",
                      line)
        if m and "entry function" in line:
            args = re.findall(r"Li(\d+)", m.group(2))
            flags = re.findall(r"Lb([01])", m.group(2))
            if m.group(2).startswith("f"):
                args.insert(0, "float")
            if m.group(1) in SM90_FLAGS:
                args += [n for n, f in zip(SM90_FLAGS[m.group(1)], flags)
                         if f == "1"]
            elif "1" in flags:             # the grouped family's bodies
                args.append("scale_scores")
            name = f"{m.group(1)}<{','.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return out


def serialized_wgmma(log: str) -> list:
    """The lines of nvcc's -Xptxas -v output that say wgmma products were
    serialized (C7515, or any 'wgmma ... serialized' line), each with the
    kernel it names."""
    return [line.strip() for line in log.splitlines()
            if "C7515" in line or re.search(r"wgmma.*serializ", line)]


def time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn() in ms, from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(fn_a, fn_b, iters: int = 5):
    """Time two versions in turns (a, b, b, a) and average each."""
    a1 = time_ms(fn_a, iters)
    b1 = time_ms(fn_b, iters)
    b2 = time_ms(fn_b, iters)
    a2 = time_ms(fn_a, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call of fn() in microseconds: the wall clock around
    `calls` calls that only queue work for an idle card (no wait between
    them; the queue does not fill), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_ms_and_share(fn, name_part: str, calls: int = 1):
    """fn() `calls` times under torch.profiler (the device's activity
    alone): (the last call's result, the device's kernel ms a call, the ms
    a call of the kernels whose names hold `name_part`, their share of the
    device's kernel time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            res = fn()
        torch.cuda.synchronize()
    total = part = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += e.self_device_time_total
            if name_part in e.key:
                part += e.self_device_time_total
    return (res, total / 1e3 / calls, part / 1e3 / calls,
            part / total if total else 0.0)


def bound_ms(flops: float, nbytes: float, f32_flops: float = 0.0):
    """The least time the card could take: (ms, 'operations' | 'bytes').
    `flops` run on the tensor cores in bf16, `f32_flops` outside them."""
    t_ops = (flops / PEAK_FLOPS + f32_flops / PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_backward_bound(products: int, mac: float, scores: float,
                             tables: bool, table_grads: bool, nbytes: float):
    """bound_ms of an attention backward (or of one of its kernels) that
    needs `products` products of `mac` multiply-adds each (the whole
    backward five: S, dP, dV, dK, dQ; a design that computes S and dP in
    two kernels does more, which is not counted) and, with rel tables, the
    two table entries added to each of its `scores` scores and, with their
    gradients, each score's dS summed into the two tables' gradients, in
    f32 outside the tensor cores."""
    f32 = scores * (2 * tables + 2 * table_grads)
    return bound_ms(2 * products * mac, nbytes, f32)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def trees_equal(a, b, where="") -> list:
    """The paths at which two nested dicts / lists of tensors and numbers
    differ (tensors compared bit for bit)."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{where}: keys"]
        return [p for k in a for p in trees_equal(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{where}: length"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in trees_equal(x, y, f"{where}/{i}")]
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [where]
    return [] if a == b else [where]


# phase 10's CLI epoch: the first LOOP_CLI_TRAIN_IMAGES / LOOP_CLI_VAL_IMAGES
# images of the bundle (48 steps of BATCH and 8 evaluation batches; the whole
# bundle would take 232 and 28)
LOOP_CLI_TRAIN_IMAGES = 192
LOOP_CLI_VAL_IMAGES = 32
# the loader's batches timed in each mode and cache state (the first one
# apart), and the fine-tune's steps in bf16 beside f32
LOOP_LOADER_BATCHES = 4
LOOP_DTYPE_STEPS = 10


def loop_phase(gpu, golden_sd, reset_counts, all_counts, per_step) -> dict:
    """10. The training loop on the card (train/loop.py through the CLI's
    config, the vendored annotation bundle, synthetic tiles at 1024, bf16,
    batch 4, full ViT-B). Returns the launch counts of its main path: the
    fine-tune runs of 10a and the from-scratch run of 10b, counted from 0
    just before the first and read just after the last."""
    import argparse
    import os
    import shutil
    import tempfile
    import warnings

    import torch

    from wildlifemapper_tpu_torch.cli import train as cli_train
    from wildlifemapper_tpu_torch.data.loader import DataLoader, build_dataset
    from wildlifemapper_tpu_torch.train import loop as loop_mod
    from wildlifemapper_tpu_torch.train.checkpoints import CheckpointManager
    from wildlifemapper_tpu_torch.train.profiling import StepWatch
    from wildlifemapper_tpu_torch.train.step import StepBuilder

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="wm_loop_"))
    env_cache = os.environ.get("WM_SYNTH_CACHE")
    os.environ["WM_SYNTH_CACHE"] = str(work / "synth")

    def config(*flags, amp=True):
        """The CLI's Config for these flags (its defaults: the fine-tune)."""
        argv = ["--synthetic_data", "--synthetic_size", "1024",
                "--batch_size", str(BATCH), "--checkpoint_every", "1",
                *(["--use_amp"] if amp else []), *flags]
        args = cli_train.add_config_args(
            argparse.ArgumentParser()).parse_args(argv)
        return cli_train.config_from_args(args)

    def train_run(cfg, workdir, watch_at=None, count_at=None, **kw):
        """loop.train, watched (train/profiling.py::StepWatch): the launches
        of step `count_at`, and the waits for the device of one loop
        iteration, from the end of step `watch_at` - 1 to the end of step
        `watch_at`: the read of an earlier step's metrics, the next batch,
        its copy to the card and the step."""
        r = {}

        def before(k):
            if k == count_at:
                r["counts_before"] = all_counts()

        def after(k):
            if k == count_at:
                now, was = all_counts(), r.pop("counts_before")
                r["step_launches"] = {
                    a: {n: now[a][n] - was[a][n] for n in now[a]}
                    for a in now}
            if k == watch_at:
                torch.cuda.set_sync_debug_mode("default")
                r["catcher"].__exit__(None, None, None)
            if k + 1 == watch_at:
                # the mode's own notice comes before the recording starts
                torch.cuda.set_sync_debug_mode("warn")
                r["catcher"] = warnings.catch_warnings(record=True)
                r["caught"] = r["catcher"].__enter__()
                warnings.simplefilter("always")

        watch = StepWatch(before, after)
        t0 = time.perf_counter()
        stats = loop_mod.train(cfg, workdir=str(workdir),
                               print_fn=lambda *a, **k: None, watch=watch,
                               **kw)
        torch.cuda.synchronize()
        r.update(watch=watch, seconds=time.perf_counter() - t0, stats=stats,
                 losses=[m["loss"].item() for m in watch.metrics],
                 eval_batches=kw.get("max_eval_batches"))
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"non-finite loop losses {r['losses']}")
        return r

    def eval_rate(r):
        return BATCH * r["eval_batches"] / r["watch"].eval_seconds[-1]

    def coco_ok(stats):
        coco = {k: v for k, v in stats.items() if k.startswith("val/coco/")}
        bad = {k: v for k, v in coco.items()
               if not (v == -1.0 or 0.0 <= v <= 1.0)}
        if not coco or bad:
            raise AssertionError(f"COCO stats out of range: {bad or coco}")
        return coco

    try:
        # ---- 10a. fine-tune from the golden weights, checkpoints, resume ----
        ft = config()
        reset_counts()                 # the loop's main path starts here
        torch.cuda.reset_peak_memory_stats()
        a = train_run(ft, work / "a", epochs=2, max_steps_per_epoch=8,
                      max_eval_batches=4, init_state_dict=golden_sd,
                      watch_at=5, count_at=3)
        peak_ft = torch.cuda.max_memory_allocated()
        written = sorted(os.listdir(work / "a"))
        for f in ("checkpoint_epoch_0", "checkpoint_epoch_1",
                  "best_checkpoint", "config.json", "best_loss.json"):
            if f not in written:
                raise AssertionError(f"10a: {f} not written: {written}")
        waits = [str(w.message)[:200] for w in a["caught"]
                 if "synchroniz" in str(w.message).lower()]
        emit("loop_step_host_waits", config="fine_tune", waits=len(waits),
             limit=2, messages=waits)
        if len(waits) > 2:
            raise AssertionError(f"a loop step waited for the device "
                                 f"{len(waits)} times, at most 2: {waits}")
        want = per_step(False, "packed")
        emit("loop_step_launches", config="fine_tune",
             launches=a["step_launches"], want=want)
        if a["step_launches"] != want:
            raise AssertionError(f"fine-tune loop step: launches "
                                 f"{a['step_launches']}, want {want}")

        # the restored state is the saved one, bit for bit
        fresh = StepBuilder(ft)
        restored = fresh.init_state(steps_per_epoch=8)
        gen = torch.Generator(device="cuda")
        CheckpointManager(str(work / "a")).restore("checkpoint_epoch_1",
                                                   restored, gen)
        _, live, _, live_gen = a["watch"].last
        diffs = (trees_equal(live.model.state_dict(),
                             restored.model.state_dict(), "model")
                 + trees_equal(live.optimizer.state_dict(),
                               restored.optimizer.state_dict(), "optimizer")
                 + trees_equal(live.scheduler.get_last_lr(),
                               restored.scheduler.get_last_lr(), "lr")
                 + trees_equal(live.step, restored.step, "step")
                 + trees_equal(live_gen.get_state(), gen.get_state(),
                               "generator"))
        emit("loop_restore", checkpoint="checkpoint_epoch_1",
             bit_identical=not diffs, differing=diffs[:10],
             step=restored.step, lr=restored.scheduler.get_last_lr(),
             adam_states=len(restored.optimizer.state_dict()["state"]))
        if diffs:
            raise AssertionError(f"restored state differs: {diffs[:10]}")
        del fresh, restored

        a_stats = coco_ok(a["stats"])
        a_ms = a["watch"].ms_per_step(8)
        a_eval = eval_rate(a)
        a_losses = a["losses"]
        # timed bare after the main path's counts are read (below)
        a_bare = a["watch"].last
        del live, live_gen, a

        b = train_run(ft, work / "a", epochs=3, resume=True,
                      max_steps_per_epoch=8, max_eval_batches=4,
                      init_state_dict=golden_sd)
        if "checkpoint_epoch_2" not in os.listdir(work / "a"):
            raise AssertionError("10a: the resumed run wrote no "
                                 "checkpoint_epoch_2")
        coco_ok(b["stats"])
        # the unbroken run reads the tiles that the runs above rendered
        # (WM_SYNTH_CACHE): its steps time the loop on warm tiles
        c = train_run(ft, work / "c", epochs=3, max_steps_per_epoch=8,
                      max_eval_batches=1, init_state_dict=golden_sd)
        c_ms = c["watch"].ms_per_step(8)
        resumed, unbroken = b["losses"][0], c["losses"][16]
        gap = abs(resumed - unbroken) / abs(unbroken)
        emit("loop_resume", gpu=gpu, resumed_first_loss=resumed,
             unbroken_epoch2_first_loss=unbroken,
             bit_identical=resumed == unbroken, relative_gap=gap, limit=2e-2,
             resumed_losses=b["losses"], unbroken_losses=c["losses"])
        if gap > 2e-2:
            raise AssertionError(f"resumed loss {resumed} against unbroken "
                                 f"{unbroken}: {gap:.3g} relative")
        del b, c
        torch.cuda.empty_cache()

        # ---- 10b. from scratch from the port's own initialisation ----------
        fs = config("--train_encoder", "--content_size", "768",
                    "--crop_prologue", "--window_size", "12")
        # hfc.dropout 0, as train/synthetic.py's from_scratch: the adaptor's
        # attention then trains through its kernel (K4)
        fs = dataclasses.replace(fs, model=dataclasses.replace(
            fs.model, hfc=dataclasses.replace(fs.model.hfc, dropout=0.0)))
        torch.cuda.reset_peak_memory_stats()
        d = train_run(fs, work / "d", epochs=1, max_steps_per_epoch=24,
                      max_eval_batches=2, count_at=5)
        peak_fs = torch.cuda.max_memory_allocated()
        loop_counts = all_counts()     # ... and ends here
        first, last = np.mean(d["losses"][:6]), np.mean(d["losses"][-6:])
        want = per_step(True, "packed")
        emit("loop_from_scratch", gpu=gpu, losses=d["losses"],
             mean_first_6=first, mean_last_6=last,
             step_launches=d["step_launches"], want=want)
        if not last < first:
            raise AssertionError(f"from scratch: the loss did not fall, "
                                 f"{first} -> {last}")
        if d["step_launches"] != want:
            raise AssertionError(f"from-scratch loop step: launches "
                                 f"{d['step_launches']}, want {want}")
        coco_ok(d["stats"])
        d_ms = d["watch"].ms_per_step(24)
        d_eval = eval_rate(d)

        def bare(sb, st, bt, g):
            """The same step unwatched on a resident batch (as phase 9)."""
            return time_ms(lambda: StepBuilder.train_step(sb, st, bt, g),
                           iters=10, warmup=2)

        bare_ft = bare(*a_bare)
        bare_fs = bare(*d["watch"].last)
        del a_bare, d
        torch.cuda.empty_cache()

        emit("loop_times", gpu=gpu, batch=BATCH, dtype="bfloat16",
             fine_tune_ms_per_step_by_epoch=a_ms,
             fine_tune_tiles_per_s=[BATCH * 1000 / x for x in a_ms],
             fine_tune_warm_tiles_ms_per_step_by_epoch=c_ms,
             fine_tune_warm_tiles_tiles_per_s=[BATCH * 1000 / x
                                               for x in c_ms],
             fine_tune_bare_step_ms=bare_ft,
             fine_tune_eval_tiles_per_s=a_eval,
             fine_tune_peak_memory_bytes=peak_ft,
             fine_tune_losses=a_losses, fine_tune_coco=a_stats,
             from_scratch_ms_per_step=d_ms[0],
             from_scratch_tiles_per_s=BATCH * 1000 / d_ms[0],
             from_scratch_bare_step_ms=bare_fs,
             from_scratch_eval_tiles_per_s=d_eval,
             from_scratch_peak_memory_bytes=peak_fs)

        # ---- bf16 against f32 over LOOP_DTYPE_STEPS steps, same weights and
        # batches; the f32 run under the profiler (device time alone): its
        # device ms a step and the share of the f32 K3 GEMM body
        curves = {}
        for name, amp in (("bfloat16", True), ("float32", False)):
            def run():
                return train_run(config(amp=amp), work / name, epochs=1,
                                 max_steps_per_epoch=LOOP_DTYPE_STEPS,
                                 max_eval_batches=1,
                                 init_state_dict=golden_sd)
            if amp:
                r = run()
            else:
                r, f32_ms, f32_k3_ms, f32_k3_share = device_ms_and_share(
                    run, K3_F32_KERNEL)
            curves[name] = r["losses"]
            del r
            torch.cuda.empty_cache()
        emit("loop_f32_device", gpu=gpu, config="fine_tune", batch=BATCH,
             steps=LOOP_DTYPE_STEPS, eval_batches=1,
             device_ms_per_step=f32_ms / LOOP_DTYPE_STEPS,
             k3_ms_per_step=f32_k3_ms / LOOP_DTYPE_STEPS,
             k3_share=f32_k3_share,
             note="device kernel time of the run (its steps and one "
                  "evaluation batch) over its steps")
        rel = [abs(x - y) / abs(y) for x, y in
               zip(curves["bfloat16"], curves["float32"])]
        emit("loop_bf16_vs_f32", gpu=gpu, config="fine_tune",
             steps=LOOP_DTYPE_STEPS,
             batch=BATCH, loss_bf16=curves["bfloat16"],
             loss_f32=curves["float32"], relative_gap=rel,
             largest_relative_gap=max(rel))

        # ---- the loader: host ms a batch (the wait in next()) --------------
        loader_ms = {}
        for mode in ("thread", "process"):
            os.environ["WM_SYNTH_CACHE"] = str(work / f"synth_{mode}")
            loader = DataLoader(build_dataset("train", ft.data), BATCH,
                                shuffle=True, seed=ft.train.seed,
                                num_workers=2, worker_mode=mode,
                                pin_memory=True)
            try:
                for cache in ("cold", "warm"):
                    it = loader.epoch(5)
                    waits_ms = []
                    for _ in range(LOOP_LOADER_BATCHES):
                        t0 = time.perf_counter()
                        next(it)
                        waits_ms.append((time.perf_counter() - t0) * 1e3)
                    it.close()
                    loader_ms[f"{mode}_{cache}"] = {
                        "first_ms": waits_ms[0],
                        "ms_per_batch": float(np.mean(waits_ms[1:]))}
            finally:
                loader.close()
        emit("loader", gpu=gpu, batch=BATCH, num_workers=2,
             synthetic_size=1024, resize_size=768, canvas_size=1024,
             host_ms=loader_ms,
             fine_tune_step_ms=a_ms[-1], from_scratch_step_ms=d_ms[0])
        os.environ["WM_SYNTH_CACHE"] = str(work / "synth")

        # ---- the CLI once: one whole epoch, the host's RSS a step ---------
        rss = []
        watch = StepWatch(after=lambda k: rss.append(vm_rss_mb()))
        t0 = time.perf_counter()
        cli_coco = coco_subset(work / "cli_coco", LOOP_CLI_TRAIN_IMAGES,
                               LOOP_CLI_VAL_IMAGES)
        cli_stats = cli_train.main([
            "--synthetic_data", "--synthetic_size", "1024", "--use_amp",
            "--batch_size", str(BATCH), "--epochs", "1", "--num_workers",
            "4", "--coco_path", str(cli_coco),
            "--work_dir", str(work / "cli")], watch=watch)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        n = len(watch.metrics)
        cli_losses = [m["loss"].item() for m in watch.metrics]
        if not (n == LOOP_CLI_TRAIN_IMAGES // BATCH
                and np.isfinite(cli_losses).all()
                and np.isfinite(cli_stats["train/loss"])):
            raise AssertionError(f"cli: {n} steps, train/loss "
                                 f"{cli_stats.get('train/loss')}")
        coco_ok(cli_stats)
        emit("loop_cli", gpu=gpu, steps=n, seconds=cli_s,
             ms_per_step=watch.ms_per_step(n)[0],
             eval_seconds=watch.eval_seconds[-1],
             train_loss=cli_stats["train/loss"],
             first_losses=cli_losses[:4], last_losses=cli_losses[-4:],
             coco_AP=cli_stats["val/coco/AP"], host_rss=rss_reading(rss),
             written=sorted(os.listdir(work / "cli")))
    finally:
        if env_cache is None:
            os.environ.pop("WM_SYNTH_CACHE", None)
        else:
            os.environ["WM_SYNTH_CACHE"] = env_cache
        shutil.rmtree(work, ignore_errors=True)
    emit("loop_phase", seconds=time.perf_counter() - t_phase)
    return loop_counts


# survey-facing constants of phase 11
MOSAIC_TILE = 1024
MOSAIC_OVERLAP = 256
# the survey frame (27 of the bundle's 111 val images are 5472 x 3648): 35
# tiles in 9 batches of 4, the last one tile of zeros
MOSAIC_FRAME = (5472, 3648)
# The golden weights give 51 identical queries (one box, class probability
# 0.126 each), and the port's seeded initialisation none above 0.3, so a
# pseudo ground truth at the thresholds of record (0.3, 0.5) would be empty:
# the drift readings use seeded weights with the class head's output layer
# scaled by this factor, which gives confident, distinct detections.
CLASS_HEAD_SCALE = 4.0


def forward_launches(name: str, counts: dict) -> int:
    """A report entry's launches in a ViT-B serving run (the mosaic's,
    phase 12's): forward kernels only, and no head-dim-80 one."""
    if "_backward" in name or name.endswith("_d80"):
        return 0
    return counts.get(name, 0)


def survey_phase(gpu, golden_sd, reset_counts, counts, per_forward) -> dict:
    """11. Serving surveys: the .pth reader (11a), orthomosaic detection of
    a full-size frame (11b), drift-as-mAP (11c) and the native matcher
    (11d). Returns the launch counts of the mosaic's main path, 11b's one
    detect, counted from 0 just before it and read just after."""
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from wildlifemapper_tpu_torch import native
    from wildlifemapper_tpu_torch.compat.torch_convert import \
        convert_checkpoint
    from wildlifemapper_tpu_torch.config import DataConfig, model_config
    from wildlifemapper_tpu_torch.data import tiler
    from wildlifemapper_tpu_torch.data.loader import build_dataset
    from wildlifemapper_tpu_torch.eval.drift import (drift_summary,
                                                     run_detections)
    from wildlifemapper_tpu_torch.eval.fast_ap import fast_ap50
    from wildlifemapper_tpu_torch.eval.orthomosaic import (
        OrthomosaicDetector, _nms_numpy)
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    work = Path(tempfile.mkdtemp(prefix="wm_survey_"))
    b_cfg = model_config("vit_b", dtype="bfloat16", use_flash_attention=True)

    def fresh(cfg, seed):
        return WildlifeMapper(cfg, generator=torch.Generator(
            device=dev).manual_seed(seed)).eval()

    def confident_sd(cfg):
        m = fresh(cfg, 0)
        with torch.no_grad():
            m.mask_decoder.class_embed.layers[-1].weight.mul_(
                CLASS_HEAD_SCALE)
        sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
        del m
        return sd

    def trained_file(sd, name):
        """A trained WildlifeMapper checkpoint as the reference's trainer
        writes it (train.py:350-354): DDP prefixes, optimizer, epoch."""
        torch.save({"model": {"module." + k: v for k, v in sd.items()},
                    "optimizer": {}, "epoch": 3}, work / name)
        return str(work / name)

    try:
        # ---- 11a. the .pth reader ---------------------------------------------
        golden = {k: torch.from_numpy(np.asarray(v))
                  for k, v in golden_sd.items()}
        m = fresh(b_cfg, 1)
        rep = convert_checkpoint(trained_file(golden, "trained.pth"), m)
        differ = [k for k, v in m.state_dict().items()
                  if not torch.equal(v.cpu(), golden[k])]
        emit("survey_weights", file="trained WildlifeMapper",
             loaded=len(rep["loaded"]), missing=rep["missing"],
             unexpected=rep["unexpected"], bit_identical=not differ,
             differing=differ[:10])
        if differ or rep["missing"]:
            raise AssertionError(f"trained .pth: {len(differ)} entries "
                                 f"differ, missing {rep['missing']}")
        # raw SAM: no hfc key, decoder heads the surgery drops
        cut = {k for k in m.state_dict() if "hfc" in k or (
            k.startswith("mask_decoder.") and "transformer" not in k)}
        sam = {k: v for k, v in golden.items() if k not in cut}
        sam.update({"mask_decoder.iou_token.weight": torch.ones(1, 256),
                    "mask_decoder.mask_tokens.weight": torch.ones(4, 256),
                    "mask_decoder.output_upscaling.0.weight":
                        torch.ones(256, 64, 2, 2),
                    "mask_decoder.iou_prediction_head.layers.0.weight":
                        torch.ones(256, 256)})
        torch.save(sam, work / "sam.pth")
        m = fresh(b_cfg, 2)
        before = {k: v.clone() for k, v in m.state_dict().items()}
        rep = convert_checkpoint(str(work / "sam.pth"), m)
        after = m.state_dict()
        enc_differ = [k for k in after if k not in cut
                      and not torch.equal(after[k].cpu(), golden[k])]
        kept_differ = [k for k in cut if not torch.equal(after[k], before[k])]
        emit("survey_weights", file="raw SAM (surgery)",
             loaded=len(rep["loaded"]), missing=rep["missing"],
             unexpected=rep["unexpected"], kept_fresh=sorted(cut),
             encoder_bit_identical=not enc_differ,
             kept_bit_identical=not kept_differ)
        if enc_differ or kept_differ or sorted(rep["missing"]) != sorted(cut):
            raise AssertionError(f"raw SAM .pth: encoder differs at "
                                 f"{enc_differ[:5]}, kept entries differ at "
                                 f"{kept_differ[:5]}, missing "
                                 f"{rep['missing']}")
        del m, before, after

        # ---- 11b. orthomosaic detection of a full-size frame ------------------
        seeded = confident_sd(b_cfg)
        m = fresh(b_cfg, 3)
        rep = convert_checkpoint(trained_file(seeded, "survey.pth"), m)
        if rep["missing"]:
            raise AssertionError(f"survey .pth: missing {rep['missing']}")
        t0 = time.perf_counter()
        mosaic, image_id, anns = survey_frame()
        render_s = time.perf_counter() - t0
        h, w = mosaic.shape[:2]
        grid = tiler.make_tile_grid(h, w, MOSAIC_TILE, MOSAIC_OVERLAP)
        n_batches = -(-grid.num_tiles // BATCH)

        def detector(model, cfg, conf=0.5):
            return OrthomosaicDetector(model, cfg, tile_batch=BATCH,
                                       overlap=MOSAIC_OVERLAP,
                                       confidence_threshold=conf,
                                       nms_iou=0.4)

        def sync_loop(det):
            """The same batches one at a time: extract, copy, run, wait,
            uncrop; then the host NMS."""
            found = []
            for idxs in tiler.batched(range(grid.num_tiles), BATCH):
                batch = np.zeros((BATCH, MOSAIC_TILE, MOSAIC_TILE, 3),
                                 np.uint8)
                batch[:len(idxs)] = tiler.extract_tiles(mosaic, grid, idxs)
                dets = det.run(torch.from_numpy(batch).to(dev))
                torch.cuda.synchronize()
                dets = {k: v.cpu().numpy() for k, v in dets.items()}
                for j, ti in enumerate(idxs):
                    keep = dets["keep"][j]
                    found.append((tiler.uncrop_boxes(dets["boxes"][j][keep],
                                                     grid.origins[ti]),
                                  dets["scores"][j][keep],
                                  dets["labels"][j][keep]))
            boxes, scores, labels = (np.concatenate(c) for c in zip(*found))
            keep = _nms_numpy(boxes, scores, det.nms_iou)
            return {"boxes": boxes[keep], "scores": scores[keep],
                    "labels": labels[keep]}

        det = detector(m, b_cfg)
        det.detect(mosaic)                     # builds and warms the kernels
        torch.cuda.synchronize()
        reset_counts()                 # the mosaic's main path starts here
        out = det.detect(mosaic)
        torch.cuda.synchronize()
        mosaic_counts = counts()
        mlp_kernels = fused_mlp.kernel_launches
        want = {n: v * n_batches for n, v in per_forward["packed"].items()}
        emit("path_launches", path="orthomosaic detect, bf16 packed",
             launches=mosaic_counts, want=want,
             mlp_kernel_launches=mlp_kernels)
        if mosaic_counts != want or mlp_kernels != 2 * want["fused_mlp"]:
            raise AssertionError(f"mosaic: launches {mosaic_counts} (K3 "
                                 f"kernels {mlp_kernels}), want {want}")
        sync = sync_loop(det)
        same = all(np.array_equal(out[k], sync[k]) for k in out)
        b = out["boxes"]
        in_range = bool(np.isfinite(b).all() and np.isfinite(
            out["scores"]).all() and (b[:, [0, 2]] >= -MOSAIC_TILE).all()
            and (b[:, [0, 2]] <= w + MOSAIC_TILE).all()
            and (b[:, [1, 3]] >= -MOSAIC_TILE).all()
            and (b[:, [1, 3]] <= h + MOSAIC_TILE).all())
        emit("mosaic", frame=[w, h], image_id=image_id, gt_boxes=len(anns),
             tiles=grid.num_tiles, batches=n_batches,
             padded=n_batches * BATCH - grid.num_tiles,
             detections=len(b), render_s=render_s,
             bit_identical_to_sync_loop=same, finite_in_range=in_range)
        if not same or not in_range or not len(b):
            raise AssertionError(f"mosaic: detect against the synchronous "
                                 f"loop bit-identical {same}, finite and in "
                                 f"range {in_range}, {len(b)} detections")

        def clocked(fn):
            """(CUDA-event ms, wall ms) of one call."""
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

        sync_loop(det)                         # its warm-up
        turns = {"detect": [], "sync_loop": []}
        host = []
        for _ in range(3):
            turns["detect"].append(clocked(lambda: det.detect(mosaic)))
            host.append(dict(det.timing))
            turns["sync_loop"].append(clocked(lambda: sync_loop(det)))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            det.detect(mosaic)
            torch.cuda.synchronize()
            profiled_wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1000
        wall = [t[1] for t in turns["detect"]]
        emit("mosaic_time", gpu=gpu, config="vit_b bf16 packed",
             tiles=grid.num_tiles, tile_batch=BATCH,
             detect_event_ms=[t[0] for t in turns["detect"]],
             detect_wall_ms=wall,
             tiles_per_s=[grid.num_tiles / (t / 1e3) for t in wall],
             sync_loop_event_ms=[t[0] for t in turns["sync_loop"]],
             sync_loop_wall_ms=[t[1] for t in turns["sync_loop"]],
             host_extract_ms=[t["extract_ms"] for t in host],
             host_launch_ms=[t["launch_ms"] for t in host],
             host_wait_ms=[t["wait_ms"] for t in host],
             host_nms_ms=[t.get("nms_ms", 0.0) for t in host],
             # busy comes from the profiled pass: its idle share against
             # that pass's own wall, and (unclamped) against the unprofiled
             # turns' mean wall
             device_busy_ms_profiled=busy,
             profiled_wall_ms=profiled_wall,
             idle_share_profiled=1 - busy / profiled_wall,
             idle_share_busy_over_unprofiled_wall=1 - busy / np.mean(wall))
        del det, m, out, sync

        # f32 through the kernels against f32 on the plain path: the same
        # mosaic's fused detections as drift-as-mAP
        f32 = model_config("vit_b", dtype="float32", use_flash_attention=True)
        fused = {}
        for name, cfg in (("plain", dataclasses.replace(
                f32, use_flash_attention=False)), ("kernels", f32)):
            m = WildlifeMapper(cfg).eval()
            m.load_state_dict(seeded)
            d = detector(m, cfg, conf=0.05).detect(mosaic)
            fused[name] = {k: v[None] for k, v in d.items()}
            del m
        torch.cuda.empty_cache()
        mosaic_drift = {}
        for thr in (0.3, 0.5):
            s = drift_summary(fused["plain"], fused["kernels"], 1,
                              gt_thresh=thr)
            mosaic_drift[thr] = s["AP50"]
        emit("mosaic_drift", config="vit_b f32 kernels against f32 plain",
             gpu=gpu, detections={k: int(v["boxes"].shape[1])
                                  for k, v in fused.items()},
             pseudo_gt={thr: int((fused["plain"]["scores"] > thr).sum())
                        for thr in (0.3, 0.5)},
             ap50=mosaic_drift)
        if any(v != 1.0 for v in mosaic_drift.values()):
            raise AssertionError(f"mosaic f32 drift-as-mAP {mosaic_drift}")

        # ---- 11c. drift-as-mAP over val tiles ---------------------------------
        vds = build_dataset("val", DataConfig(synthetic=True,
                                              synthetic_size=1024,
                                              flip_prob=0.0))
        tiles = np.stack([vds.get(i)["image"] for i in range(16)]
                         ).astype(np.float32)

        def detections(cfg, sd, x, batch):
            m = WildlifeMapper(cfg).eval()
            load_reference_state_dict(m, sd)
            d = run_detections(m, x, batch)
            del m
            torch.cuda.empty_cache()
            return d

        def on_card(dets, thr):
            return {k: torch.as_tensor(v, device=dev) for k, v in (
                ("boxes", dets["boxes"]), ("scores", dets["scores"]),
                ("labels", dets["labels"]),
                ("keep", dets["scores"] > thr))}

        def read(name, ref, dets, n, gate=False):
            row = {}
            for thr in (0.3, 0.5):
                s = drift_summary(ref, dets, n, gt_thresh=thr)
                g, p = on_card(ref, thr), on_card(dets, 0.05)
                fast = fast_ap50(p["boxes"], p["scores"], p["labels"],
                                 p["keep"], g["boxes"], g["labels"],
                                 g["keep"])
                row[thr] = dict(ap50=s["AP50"], ap=s["AP"],
                                fast_ap50=float(fast),
                                pseudo_gt=int((ref["scores"] > thr).sum()))
            emit("drift_map", candidate=name, gpu=gpu, tiles=n,
                 reference="f32 plain, full canvas", record=1.0,
                 gated=gate, **{f"at_{t}": v for t, v in row.items()})
            if gate and any(v["ap50"] != 1.0 for v in row.values()):
                diff = np.argwhere(np.abs(ref["scores"] - dets["scores"])
                                   > 1e-5)
                emit("drift_map_differing", candidate=name,
                     where=diff[:20].tolist(),
                     ref_scores=[float(ref["scores"][i, j])
                                 for i, j in diff[:20]],
                     scores=[float(dets["scores"][i, j])
                             for i, j in diff[:20]])
                raise AssertionError(f"{name}: drift-as-mAP "
                                     f"{ {t: v['ap50'] for t, v in row.items()} }")
            return row

        full_f32 = model_config("vit_b", dtype="float32",
                                use_flash_attention=False)
        ref = detections(full_f32, seeded, tiles, BATCH)
        scratch = dataclasses.replace(
            b_cfg, content_size=768, crop_prologue=True,
            vit=dataclasses.replace(b_cfg.vit, window_size=12),
            hfc=dataclasses.replace(b_cfg.hfc,
                                    compat_scrambled_reshape=False))
        candidates = {
            "f32 kernels, full canvas": (f32, True),
            "bf16 kernels, full canvas": (b_cfg, False),
            "bf16 kernels, compat crop": (dataclasses.replace(
                b_cfg, content_size=768), False),
            "bf16 kernels, from scratch": (scratch, False),
            "bf16 kernels, full canvas, grouped": (dataclasses.replace(
                b_cfg, attn_impl="grouped"), False)}
        drift_rows = {}
        bf16_full = None
        for name, (cfg, gate) in candidates.items():
            dets = detections(cfg, seeded, tiles, BATCH)
            drift_rows[name] = read(name, ref, dets, len(tiles), gate)
            if name == "bf16 kernels, full canvas":
                bf16_full = dets
        # ViT-H: bf16 with kernels against f32 plain, batch 1, 4 tiles
        vit_h = model_config("vit_h", dtype="bfloat16",
                             use_flash_attention=True)
        seeded_h = confident_sd(vit_h)
        ref_h = detections(model_config("vit_h", dtype="float32",
                                        use_flash_attention=False),
                           seeded_h, tiles[:4], 1)
        drift_rows["vit_h bf16 kernels"] = read(
            "vit_h bf16 kernels, batch 1", ref_h,
            detections(vit_h, seeded_h, tiles[:4], 1), 4)
        del seeded_h

        # ---- 11d. the native matcher ------------------------------------------
        if not native.available():
            raise AssertionError("native.available() is False on the card")
        with_native = drift_summary(ref, bf16_full, len(tiles), gt_thresh=0.3)
        coco_match = native.coco_match
        native.coco_match = lambda *a: None
        try:
            with_numpy = drift_summary(ref, bf16_full, len(tiles),
                                       gt_thresh=0.3)
        finally:
            native.coco_match = coco_match
        emit("native", available=True, library=str(native.library_path()),
             stats_equal=with_native == with_numpy, stats=with_native)
        if with_native != with_numpy:
            raise AssertionError(f"native matcher {with_native} against "
                                 f"match_greedy {with_numpy}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("survey_phase", seconds=time.perf_counter() - t_phase)
    return mosaic_counts


def loop_launches(name: str, counts: dict) -> int:
    """A report entry's launches in the loop's run: the ViT-B loop runs no
    head-dim-80 kernel."""
    if name.endswith("_d80"):
        return 0
    for suffix, attr in (("_backward_dq", "backward_dq_launches"),
                         ("_backward_dkv", "backward_dkv_launches"),
                         ("_backward_dh", "backward_launches"),
                         ("_backward", "backward_launches")):
        if name.endswith(suffix):
            return counts[attr][name[:-len(suffix)]]
    return counts["launches"][name]


# the compat surface of phase 12: the frame a user hands the predictor (H x W
# of 27 of the bundle's 111 val images), the calls a forward makes to the
# forward kernels' operators (packed ViT-B: K1 8, K2 4, K3 12, K4 1), and the
# share of phase 4's serving wall the operators' dispatch may take before
# the wrappers would call the launchers directly (outside an export)
COMPAT_FRAME_HW = (3648, 5472)
OP_CALLS_PER_FORWARD = 25
DISPATCH_SHARE_LIMIT = 0.02


def compat_phase(gpu, golden_sd, reset_counts, counts, per_forward) -> dict:
    """12. The compat surface on the card (ViT-B, bf16, seeded weights with
    the class head scaled): 12a the predictor, 12b the exported forward in
    both layouts (a fresh process loads it with the operators alone), 12c
    each `wm::` operator under torch.library.opcheck, 12d the host's cost
    of entering the kernels through the operators. Returns the launch
    counts of the phase's main path: 12a's set_image and the exported
    programs' runs at batch 4 in this process, each counted from 0 just
    before it and read just after."""
    import collections
    import shutil
    import tempfile

    import torch
    from torch.library import opcheck

    from wildlifemapper_tpu_torch.compat.export import (export_forward,
                                                        load_exported)
    from wildlifemapper_tpu_torch.compat.predictor import \
        WildlifeMapperPredictor
    from wildlifemapper_tpu_torch.config import model_config
    from wildlifemapper_tpu_torch.eval.postprocess import (batched_nms,
                                                           postprocess)
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.ops import _library
    from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import \
        windowed_attention_packed
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="wm_compat_"))
    cfg = model_config("vit_b", dtype="bfloat16", use_flash_attention=True)
    phase_counts = collections.Counter()

    def event_ms(fn):
        """(result, device ms, wall ms) of one call, synchronised."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3

    def nonzero(c):
        return {k: v for k, v in c.items() if v}

    try:
        model = WildlifeMapper(cfg, generator=torch.Generator(
            device=dev).manual_seed(0)).eval()
        with torch.no_grad():
            model.mask_decoder.class_embed.layers[-1].weight.mul_(
                CLASS_HEAD_SCALE)

        # ---- 12a. the predictor -----------------------------------------------
        frame = np.random.default_rng(12).integers(
            0, 256, (*COMPAT_FRAME_HW, 3), dtype=np.uint8)
        pred = WildlifeMapperPredictor(model)
        pred.set_image(frame)                        # warm-up, not counted
        pred.predict()
        reset_counts()
        _, set_ms, set_wall = event_ms(lambda: pred.set_image(frame))
        set_counts = counts()
        set_mlp_kernels = fused_mlp.kernel_launches
        reset_counts()
        dets, predict_ms, predict_wall = event_ms(
            lambda: pred.predict(score_threshold=0.05))
        predict_counts = counts()
        phase_counts.update(set_counts)
        want = per_forward["packed"]
        emit("compat_predictor_launches", set_image=set_counts,
             set_image_mlp_kernel_launches=set_mlp_kernels,
             predict=predict_counts, want_set_image=want)
        if (set_counts != want or set_mlp_kernels != 2 * want["fused_mlp"]
                or any(predict_counts.values())):
            raise AssertionError(f"predictor launches: set_image "
                                 f"{set_counts}, predict {predict_counts}")
        # the same canvas through the forward, postprocess and NMS
        canvas = pred.preprocess(frame)
        sizes = torch.tensor([COMPAT_FRAME_HW], device=dev)
        same = {}
        with torch.inference_mode():
            out = model(canvas)
            for thr in (0.05, 0.5):
                got = pred.predict(score_threshold=thr)
                ref = postprocess(out, sizes, thr, hw_swap_compat=False)
                keep = batched_nms(ref["boxes"], ref["scores"],
                                   ref["labels"], ref["keep"], 0.4,
                                   class_aware=False)[0]
                same[thr] = (len(got["boxes"]), all(
                    np.array_equal(got[k], ref[k][0][keep].cpu().numpy())
                    for k in ("boxes", "scores", "labels")))
            emb_same = torch.equal(pred.get_image_embedding(),
                                   model.encode(canvas))
        set_times = [event_ms(lambda: pred.set_image(frame))[1:]
                     for _ in range(3)]
        predict_times = [event_ms(lambda: pred.predict())[1:]
                         for _ in range(3)]
        emit("compat_predictor", frame_hw=list(COMPAT_FRAME_HW), gpu=gpu,
             detections={str(t): n for t, (n, _) in same.items()},
             bit_identical_to_forward_postprocess_nms={
                 str(t): s for t, (_, s) in same.items()},
             embedding_bit_identical=emb_same,
             set_image_ms=[set_ms] + [t[0] for t in set_times],
             set_image_wall_ms=[set_wall] + [t[1] for t in set_times],
             predict_ms=[predict_ms] + [t[0] for t in predict_times],
             predict_wall_ms=[predict_wall] + [t[1] for t in predict_times],
             first_predict_kept=int(len(dets["boxes"])))
        if not emb_same or not all(s for _, s in same.values()):
            raise AssertionError(f"predictor against forward + postprocess "
                                 f"+ NMS: {same}, embedding {emb_same}")
        del out, canvas

        # ---- 12b. the exported forward, both layouts ---------------------------
        grouped = WildlifeMapper(dataclasses.replace(
            cfg, attn_impl="grouped")).eval()
        grouped.load_state_dict(model.state_dict())
        models = {"packed": model, "grouped": grouped}
        rng = np.random.default_rng(13)
        xs = {b: torch.from_numpy(rng.standard_normal(
            size=(b, 1024, 1024, 3), dtype=np.float32)) for b in (1, 4)}
        torch.save(xs, work / "inputs.pt")
        paths, eager = {}, {}
        for layout, m in models.items():
            t0 = time.perf_counter()
            program = export_forward(m, batch_size=None)
            export_s = time.perf_counter() - t0
            nodes = collections.Counter(
                str(n.target).split(".")[1] for n in program.graph.nodes
                if str(n.target).startswith("wm."))
            library = [str(n.target) for n in program.graph.nodes
                       if "scaled_dot_product" in str(n.target)]
            calls = collections.Counter(
                str(n.target) for n in program.graph.nodes
                if n.op == "call_function")
            paths[layout] = work / f"{layout}.pt2"
            t0 = time.perf_counter()
            torch.export.save(program, str(paths[layout]))
            save_s = time.perf_counter() - t0
            want = nonzero(per_forward[layout])
            emit("compat_export", layout=layout, dtype="bfloat16",
                 batch="Dim('batch')", export_seconds=export_s,
                 save_seconds=save_s,
                 artifact_bytes=paths[layout].stat().st_size,
                 wm_nodes=dict(nodes), want=want,
                 call_nodes=sum(calls.values()),
                 most_called=calls.most_common(6),
                 library_attention_nodes=library,
                 range_constraints=str(program.range_constraints))
            if dict(nodes) != want or library:
                raise AssertionError(f"{layout} export: wm:: nodes {nodes}, "
                                     f"want {want}; library {library}")
            del program
            eager[layout] = {}
            with torch.no_grad():
                for b, x in xs.items():
                    reset_counts()
                    o = m(x.to(dev))
                    torch.cuda.synchronize()
                    eager[layout][b] = ({k: v.cpu() for k, v in o.items()},
                                        nonzero(counts()))
        # a fresh process: the operators alone, no models module
        fresh = work / "fresh.pt"
        code = "\n".join([
            "import sys, torch",
            f"sys.path.insert(0, {str(root)!r})",
            "import wildlifemapper_tpu_torch.ops",
            "from wildlifemapper_tpu_torch.ops._library import WRAPPERS",
            f"xs = torch.load({str(work / 'inputs.pt')!r})",
            "res = {}",
            f"for layout, path in {({k: str(v) for k, v in paths.items()})!r}"
            ".items():",
            "    program = torch.export.load(path).module()",
            "    for b, x in xs.items():",
            "        for w in WRAPPERS.values():",
            "            w.launches = 0",
            "        with torch.no_grad():",
            "            out = program(x.cuda())",
            "        torch.cuda.synchronize()",
            "        res[layout, b] = ({k: v.cpu() for k, v in out.items()},",
            "                          {n: w.launches for n, w in "
            "WRAPPERS.items() if w.launches})",
            "res['models_imported'] = 'wildlifemapper_tpu_torch.models' in "
            "sys.modules",
            f"torch.save(res, {str(fresh)!r})"])
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            # ---- 12c. each operator under opcheck on the card, while the
            # fresh process loads and runs the programs ---------------------
            gen = torch.Generator(device=dev).manual_seed(14)

            def r(*shape, dt=torch.bfloat16, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=dev)
                        * scale).to(dt)

            op_args = {
                "windowed_attention_packed": (r(2, 16, 3 * 128),
                                              r(2, 16, 2, 4, scale=0.5),
                                              r(2, 16, 2, 4, scale=0.5), 0.125,
                                              2),
                "cross_attention_packed": (r(2, 16, 256), r(2, 24, 256),
                                           r(2, 24, 256), 128 ** -0.5, 2),
                "flash_attention_rel_pos": (r(4, 16, 64), r(4, 16, 64),
                                            r(4, 16, 64),
                                            r(4, 16, 1, 4, scale=0.5),
                                            r(4, 16, 1, 4, scale=0.5), 0.125),
                "fused_mlp": (r(32, 64), r(128, 64, scale=0.125),
                              r(128, dt=torch.float32, scale=0.1),
                              r(64, 128, scale=128 ** -0.5),
                              r(64, dt=torch.float32, scale=0.1)),
            }
            op_args["flash_attention_packed"] = op_args[
                "windowed_attention_packed"]
            op_args["windowed_attention_rel_pos"] = op_args[
                "flash_attention_rel_pos"]
            checked = {}
            for name in sorted(_library.IMPLS):
                packet, _, overload = name.partition(".")
                fn = getattr(getattr(torch.ops.wm, packet),
                             overload or "default")
                checked[name] = opcheck(fn, op_args[packet])
            emit("compat_opcheck", device=torch.cuda.get_device_name(0),
                 results=checked)
            if any(v != "SUCCESS" for res_ in checked.values()
                   for v in res_.values()):
                raise AssertionError(f"opcheck on the card: {checked}")

            _, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        fresh_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fresh process failed:\n"
                                 f"{stderr[-4000:]}")
        res = torch.load(fresh, weights_only=False)
        if res.pop("models_imported"):
            raise AssertionError("the fresh process imported the models")
        for (layout, b), (outs, fresh_counts) in res.items():
            ref, eager_counts = eager[layout][b]
            diffs = {k: (outs[k].float() - ref[k].float()).abs().max().item()
                     for k in ("pred_logits", "pred_boxes")}
            bit = all(torch.equal(outs[k], ref[k]) for k in diffs)
            close = all(torch.allclose(outs[k], ref[k], atol=2e-2, rtol=2e-2)
                        for k in diffs)
            emit("compat_exported_run", layout=layout, batch=b,
                 process="fresh, wildlifemapper_tpu_torch.ops only",
                 bit_identical_to_eager=bit, max_abs_diff=diffs,
                 reason=None if bit else "held to bf16 2e-2: the program's "
                 "aten graph rounds other than the eager modules",
                 launches=fresh_counts, eager_launches=eager_counts,
                 process_seconds=fresh_s)
            if not close or fresh_counts != eager_counts:
                raise AssertionError(f"exported {layout} at batch {b}: "
                                     f"diff {diffs}, launches {fresh_counts}"
                                     f" against eager's {eager_counts}")
        # eager against the loaded program at batch 4, in turns; one
        # counted run of each program
        x4 = xs[4].to(dev)
        for layout, m in models.items():
            program = load_exported(paths[layout])
            reset_counts()
            with torch.no_grad():
                program(x4)
                torch.cuda.synchronize()
            run_counts = counts()
            phase_counts.update(run_counts)
            with torch.no_grad():
                eager_ms, exported_ms = paired_ms(lambda: m(x4),
                                                  lambda: program(x4))
            emit("compat_exported_time", layout=layout, batch=4, gpu=gpu,
                 eager_forward_ms=eager_ms, exported_forward_ms=exported_ms,
                 launches=nonzero(run_counts))
            if nonzero(run_counts) != nonzero(per_forward[layout]):
                raise AssertionError(f"loaded {layout} program: launches "
                                     f"{run_counts}")
            del program
        del grouped, models, xs, x4, eager, res
        torch.cuda.empty_cache()

        # ---- 12d. the host's cost of the operators -----------------------------
        g = torch.Generator(device=dev).manual_seed(15)

        def rb(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device=dev)
                    * scale).to(torch.bfloat16)

        qkv, rh, rw = (rb(100, 196, 3 * 768), rb(100, 196, 12, 14, scale=0.5),
                       rb(100, 196, 12, 14, scale=0.5))
        x, w1, w2 = (rb(4 * 4096, 768), rb(3072, 768, scale=768 ** -0.5),
                     rb(768, 3072, scale=3072 ** -0.5))
        b1 = torch.randn(3072, generator=g, device=dev) * 0.1
        b2 = torch.randn(768, generator=g, device=dev) * 0.1
        k1_args, k3_args = (qkv, rh, rw, 0.125, 12), (x, w1, b1, w2, b2)
        host = {}
        with torch.inference_mode():
            for kid, name, wrapper_call, args in (
                    ("K1", "windowed_attention_packed",
                     lambda: windowed_attention_packed(qkv, rh, rw, 0.125, 12,
                                                       (14, 14)), k1_args),
                    ("K3", "fused_mlp", lambda: fused_mlp(*k3_args),
                     k3_args)):
                impl = _library.IMPLS[name][1]
                op = getattr(torch.ops.wm, name).default
                rows = {"wrapper": [], "operator": [], "implementation": []}
                hops = []
                # the host is shared and its speed drifts between turns, so
                # the hop is read within a turn (implementation, operator,
                # operator, implementation) and its median over the turns
                for _ in range(7):
                    a1 = host_us(lambda: impl(*args), 200)
                    b1 = host_us(lambda: op(*args), 200)
                    b2 = host_us(lambda: op(*args), 200)
                    a2 = host_us(lambda: impl(*args), 200)
                    rows["implementation"] += [a1, a2]
                    rows["operator"] += [b1, b2]
                    rows["wrapper"].append(host_us(wrapper_call, 200))
                    hops.append((b1 + b2 - a1 - a2) / 2)
                host[kid] = {k: float(np.median(v)) for k, v in rows.items()}
                host[kid]["dispatch"] = float(np.median(hops))
                host[kid]["least"] = {k: min(v) for k, v in rows.items()}
                host[kid]["dispatch_turns"] = hops
                host[kid]["turns"] = rows
        del qkv, rh, rw, x, w1, w2, b1, b2
        # phase 4's full-canvas packed serving, golden weights, batch 4
        serving = WildlifeMapper(cfg)
        load_reference_state_dict(serving, golden_sd)
        serving.eval()
        xb = np.zeros((BATCH, 1024, 1024, 3), np.float32)
        xb[:, :768, :768, :] = np.random.default_rng(100).standard_normal(
            size=(BATCH, 768, 768, 3), dtype=np.float32)
        xb = torch.from_numpy(xb).to(dev)
        sizes4 = torch.full((BATCH, 2), 1024, dtype=torch.int32, device=dev)

        def serve():
            out = serving(xb)
            dets = postprocess(out, sizes4, confidence_threshold=0.05)
            dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                       dets["labels"], dets["keep"], 0.4,
                                       class_aware=False)
            return dets

        walls = []
        with torch.inference_mode():
            for _ in range(2):
                serve()
            torch.cuda.synchronize()
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(10):
                    serve()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) / 10 * 1e3)
            events_ms = time_ms(serve, iters=10)
        wall = float(np.median(walls))
        dispatch_us = max(host["K1"]["dispatch"], host["K3"]["dispatch"])
        share = OP_CALLS_PER_FORWARD * dispatch_us * 1e-3 / wall
        route = ("operators" if share <= DISPATCH_SHARE_LIMIT
                 else "launchers, operators only under export")
        emit("compat_host_cost", gpu=gpu, host_us=host,
             serving_full_canvas_packed_wall_ms=walls,
             serving_full_canvas_packed_events_ms=events_ms,
             op_calls_per_forward=OP_CALLS_PER_FORWARD,
             dispatch_share_of_serving=share,
             share_limit=DISPATCH_SHARE_LIMIT, route_kept="operators",
             route_the_share_calls_for=route)
        del serving, xb
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("compat_phase", seconds=time.perf_counter() - t_phase)
    return dict(phase_counts), host


# the data-parallel path of phase 13: two ranks, each with BATCH // 2 rows of
# phase 8's batch of BATCH, or with phase 10's batch of BATCH in the loop;
# small splits of the vendored bundle (synthetic tiles at 1024): 4 steps of
# BATCH a rank over two ranks, 2 eval batches a rank (8 and 4 at world 1)
DIST_WORLD = 2
DIST_TIMEOUT_S = 420
DIST_TRAIN_IMAGES = 32
DIST_VAL_IMAGES = 16
# 13b against one process at batch BATCH, each a relative gap: every step's
# loss and grad_norm, ||change of the parameters over the steps|| and
# ||gradient of the last step|| (L2 over every trainable parameter). Read on
# an H100 (fine-tune / from scratch): 4.4e-7 / 2.5e-7, 1.4e-3, 2.5e-3 /
# 3.5e-3, 1.2e-3; one process on half the batch: 1.9e-2, 5.7e-2, 0.17-0.18,
# 0.41. Each limit lies about a decade from both.
DIST_LOSS_TOL = 1e-4
DIST_NORM_TOL = 1e-2
DIST_CHANGE_TOL = 2.5e-2
DIST_GRAD_TOL = 2e-2
COUNT_NAMES = ("launches", "backward_launches", "backward_dq_launches",
               "backward_dkv_launches")


def port_wrappers() -> dict:
    """The kernels' public wrappers, by report name: their launch counters."""
    from wildlifemapper_tpu_torch.ops.cross_attention import \
        cross_attention_packed
    from wildlifemapper_tpu_torch.ops.flash_attention import \
        flash_attention_rel_pos
    from wildlifemapper_tpu_torch.ops.flash_attention_v2 import \
        flash_attention_packed
    from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp
    from wildlifemapper_tpu_torch.ops.windowed_attention import \
        windowed_attention_rel_pos
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import \
        windowed_attention_packed

    return {"windowed_attention_packed": windowed_attention_packed,
            "flash_attention_packed": flash_attention_packed,
            "fused_mlp": fused_mlp,
            "cross_attention_packed": cross_attention_packed,
            "flash_attention_rel_pos": flash_attention_rel_pos,
            "windowed_attention_rel_pos": windowed_attention_rel_pos}


def relative_gap(got: dict, want: dict) -> float:
    """||got - want|| / ||want||, L2 over every tensor of `want` together."""
    num = den = 0.0
    for n, w in want.items():
        w = w.double()
        num += float((got[n].double() - w).square().sum())
        den += float(w.square().sum())
    return math.sqrt(num / max(den, 1e-300))


def worst_element_gap(got: dict, want: dict) -> float:
    """max over tensors of max|got - want| / max|want|."""
    return max(float((got[n].double() - w.double()).abs().max())
               / max(float(w.abs().max()), 1e-300) for n, w in want.items())


def step_readings(losses, norms, change, grad, want) -> dict:
    """A run's gaps to one process's (`want`: losses, grad_norms, change,
    grad), and whether 13b's limits pass it."""
    r = {"loss": max(abs(a - b) / abs(b) for a, b in
                     zip(losses, want["losses"])),
         "grad_norm": max(abs(a - b) / abs(b) for a, b in
                          zip(norms, want["grad_norms"])),
         "change": relative_gap(change, want["change"]),
         "grad": relative_gap(grad, want["grad"])}
    limits = {"loss": DIST_LOSS_TOL, "grad_norm": DIST_NORM_TOL,
              "change": DIST_CHANGE_TOL, "grad": DIST_GRAD_TOL}
    r["over_limit"] = sorted(k for k in limits if not r[k] <= limits[k])
    return r


def trainable(model, grads=False) -> dict:
    """The trainable parameters (or their gradients), on the host."""
    return {n: (p.grad if grads else p).detach().float().cpu().clone()
            for n, p in model.named_parameters() if p.requires_grad}


def wrapper_counts(wrappers: dict) -> dict:
    return {a: {n: getattr(w, a) for n, w in wrappers.items()
                if hasattr(w, a)} for a in COUNT_NAMES}


def add_counts(a: dict, b: dict) -> dict:
    return {attr: {n: a[attr].get(n, 0) + b[attr].get(n, 0)
                   for n in set(a[attr]) | set(b[attr])} for attr in a}


def sub_counts(a: dict, b: dict) -> dict:
    """The launches counted in `a` and not yet in `b` (an earlier read)."""
    return {attr: {n: a[attr].get(n, 0) - b[attr].get(n, 0)
                   for n in a[attr]} for attr in a}


def coco_subset(dst: Path, n_train: int = DIST_TRAIN_IMAGES,
                n_val: int = DIST_VAL_IMAGES) -> Path:
    """The first n_train / n_val images of the vendored bundle's train / val
    splits, with their annotations, as a coco_path."""
    from wildlifemapper_tpu_torch.data.coco import ASSETS_DIR, load_ann_json

    dst.mkdir(parents=True)
    for split, n in (("train", n_train), ("val", n_val)):
        d = load_ann_json(str(ASSETS_DIR / f"{split}.json"))
        images = d["images"][:n]
        ids = {im["id"] for im in images}
        d = dict(d, images=images, annotations=[
            a for a in d["annotations"] if a["image_id"] in ids])
        (dst / f"{split}.json").write_text(json.dumps(d))
    return dst


def dist_step_config(name: str):
    """Phase 8's bf16 training configuration `name` at batch BATCH, with
    hfc.dropout 0: ranks draw their own masks, so a run over two ranks and
    one over one process compare only without dropout."""
    from wildlifemapper_tpu_torch.train.synthetic import training_config

    cfg = training_config(name)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, hfc=dataclasses.replace(cfg.model.hfc, dropout=0.0)))


def dist_batch(step: int, rows=slice(None)):
    """Step `step`'s synthetic batch of BATCH (its `rows`), on the card."""
    import torch

    from wildlifemapper_tpu_torch.train.synthetic import synthetic_batch

    return {k: torch.from_numpy(v[rows]).cuda()
            for k, v in synthetic_batch(BATCH, seed=40 + step).items()}


def loop_cli_config(coco: Path):
    """Phase 10's fine-tune configuration (the CLI's) over `coco`."""
    import argparse

    from wildlifemapper_tpu_torch.cli import train as cli_train

    argv = ["--synthetic_data", "--synthetic_size", "1024", "--use_amp",
            "--batch_size", str(BATCH), "--checkpoint_every", "1",
            "--coco_path", str(coco)]
    args = cli_train.add_config_args(argparse.ArgumentParser()).parse_args(
        argv)
    return cli_train.config_from_args(args)


def survey_model(cfg, path):
    """A fresh bf16 model on the card holding the weights of .pth `path`."""
    import torch

    from wildlifemapper_tpu_torch.compat.torch_convert import \
        convert_checkpoint
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    model = WildlifeMapper(cfg, generator=torch.Generator(
        device="cuda").manual_seed(3)).eval()
    rep = convert_checkpoint(str(path), model)
    if rep["missing"]:
        raise AssertionError(f"survey .pth: missing {rep['missing']}")
    return model


def survey_frame():
    """Phase 11b's frame: the loader's synthetic rendering, at 5472 x 3648,
    of the boxes of the val image of that size that has most. Returns the
    uint8 frame, its image id and its annotations."""
    from wildlifemapper_tpu_torch.config import DataConfig
    from wildlifemapper_tpu_torch.data.loader import (_synthetic_image,
                                                      build_dataset)

    index = build_dataset("val", DataConfig(synthetic=True)).index
    image_id = max((i for i in index.ids if (
        index.image_info(i)["width"], index.image_info(i)["height"])
        == MOSAIC_FRAME), key=lambda i: len(index.annotations(i)))
    info, anns = index.image_info(image_id), index.annotations(image_id)
    return (_synthetic_image(image_id, info["width"], info["height"], anns),
            image_id, anns)


def detections_digest(evaluator) -> str:
    """sha256 of the detections a COCO evaluator scores, in its order."""
    import hashlib

    h = hashlib.sha256()
    for i in evaluator.img_ids:
        h.update(str(i).encode())
        for k in ("scores", "labels", "boxes"):
            h.update(np.ascontiguousarray(evaluator._dts[i][k]).tobytes())
    return h.hexdigest()


def param_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for n, p in model.named_parameters():
        h.update(n.encode())
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_worker(spec_path: str) -> int:
    """One rank of phase 13 (`python3 chip_smoke.py --rank-worker
    <spec.json>`, started by distributed_phase): 13b the train steps, 13c
    the loop, 13d the mosaic, as the spec's tasks say; its results and its
    kernels' launch counts into the spec's directory."""
    import os
    import torch

    from wildlifemapper_tpu_torch.config import model_config
    from wildlifemapper_tpu_torch.eval import coco_eval
    from wildlifemapper_tpu_torch.eval.orthomosaic import OrthomosaicDetector
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.parallel.mesh import make_mesh
    from wildlifemapper_tpu_torch.train import loop as loop_mod
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    spec = json.loads(Path(spec_path).read_text())
    rank, work, tag = spec["rank"], Path(spec["work"]), spec["tag"]
    dist.init_distributed_mode(
        init_method=f"tcp://127.0.0.1:{spec['port']}",
        world_size=spec["world"], rank=rank, local_rank=spec["local_rank"],
        backend=spec["backend"])
    assert make_mesh() is torch.distributed.group.WORLD
    wrappers = port_wrappers()
    res = {"rank": rank, "backend": torch.distributed.get_backend(),
           "device": torch.cuda.current_device(),
           "device_name": torch.cuda.get_device_name()}
    golden = torch.load(work / "golden.pt", weights_only=True)
    per_rank = BATCH // spec["world"]
    rows = slice(rank * per_rank, (rank + 1) * per_rank)

    if "steps" in spec["tasks"]:                   # 13b
        res["steps"] = {}
        for name in ("fine_tune", "from_scratch"):
            sb = StepBuilder(dist_step_config(name))
            load_reference_state_dict(sb.model, golden)
            state = sb.init_state(steps_per_epoch=100)
            before = trainable(sb.model) if rank == 0 else None
            losses, norms, ms = [], [], []
            for i in range(TRAIN_STEPS):
                batch = dist_batch(i, rows)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = sb.train_step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(metrics["loss"].item())
                norms.append(metrics["grad_norm"].item())
            if rank == 0:
                after = trainable(sb.model)
                torch.save({"change": {n: after[n] - p
                                       for n, p in before.items()},
                            "grad": trainable(sb.model, grads=True)},
                           work / f"{tag}_{name}.pt")
                del before, after
            res["steps"][name] = {"losses": losses, "grad_norms": norms,
                                  "ms": ms, "digest": param_digest(sb.model)}
            del sb, state, batch
            torch.cuda.empty_cache()

    if "loop" in spec["tasks"]:                    # 13c
        writes, scored = [], []
        save, write_text = torch.save, Path.write_text
        accumulate = coco_eval.CocoEvaluator.accumulate

        def recording_save(obj, f, *a, **k):
            if isinstance(f, (str, os.PathLike)):  # not the gathers' buffers
                writes.append(Path(f).name)
            return save(obj, f, *a, **k)

        def recording_write_text(self, *a, **k):
            writes.append(self.name)
            return write_text(self, *a, **k)

        def recording_accumulate(self):
            scored.append((sorted(self.img_ids), detections_digest(self)))
            return accumulate(self)

        torch.save, Path.write_text = recording_save, recording_write_text
        coco_eval.CocoEvaluator.accumulate = recording_accumulate
        try:
            cfg = loop_cli_config(Path(spec["coco"]))
            quiet = dict(print_fn=lambda *a, **k: None,
                         init_state_dict=golden, max_steps_per_epoch=4)
            t0 = time.perf_counter()
            first = loop_mod.train(cfg, workdir=spec["workdir"], epochs=2,
                                   **quiet)
            resumed = loop_mod.train(cfg, workdir=spec["workdir"], epochs=3,
                                     resume=True, **quiet)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            torch.save, Path.write_text = save, write_text
            coco_eval.CocoEvaluator.accumulate = accumulate
        res["loop"] = {"first": first, "resumed": resumed, "writes": writes,
                       "scored": scored, "seconds": seconds}
        torch.cuda.empty_cache()

    if "mosaic" in spec["tasks"]:                  # 13d
        b_cfg = model_config("vit_b", dtype="bfloat16",
                             use_flash_attention=True)
        det = OrthomosaicDetector(
            survey_model(b_cfg, work / "survey.pth"), b_cfg,
            tile_batch=BATCH, overlap=MOSAIC_OVERLAP,
            confidence_threshold=0.5, nms_iou=0.4)
        frame = np.load(work / "frame.npy")
        det.detect(frame)                          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.detect(frame)
        torch.cuda.synchronize()
        res["mosaic"] = {"detections": len(out["boxes"]),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "timing": det.timing}
        np.savez(work / f"{tag}_mosaic_rank{rank}.npz", **out)

    torch.cuda.synchronize()
    res["counts"] = wrapper_counts(wrappers)
    (work / f"{tag}_rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Worker processes of this script (`flag` <spec.json>, one a rank),
    started together, each logging to <work>/<tag>_rank<r>.log and
    reporting to <work>/<tag>_rank<r>.json, all under one timeout."""

    def __init__(self, work: Path, tag: str, flag: str, specs: list,
                 timeout_s: float):
        import os

        self.work, self.tag, self.procs = work, tag, []
        self.deadline = time.monotonic() + timeout_s
        env = dict(os.environ, WM_SYNTH_CACHE="0")
        try:
            for r, spec in enumerate(specs):
                path = work / f"{tag}_spec{r}.json"
                path.write_text(json.dumps(spec))
                log = open(work / f"{tag}_rank{r}.log", "w")
                self.procs.append((subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), flag,
                     str(path)], stdout=log, stderr=subprocess.STDOUT,
                    env=env, cwd=str(Path(__file__).resolve().parent)), log))
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        """Kill what still runs (a hung rank) and close the logs."""
        for p, log in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()

    def wait(self) -> list:
        """Their results in rank order; a rank that fails or hangs fails
        the phase."""
        try:
            for p, _ in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            self.stop()
        bad = [(r, p.returncode) for r, (p, _) in enumerate(self.procs)
               if p.returncode != 0]
        if bad:
            tails = {r: (self.work / f"{self.tag}_rank{r}.log").read_text()[
                -3000:] for r, _ in bad}
            raise AssertionError(f"{self.tag}: ranks failed or hung (rank, "
                                 f"exit code) {bad}: {tails}")
        return [json.loads((self.work / f"{self.tag}_rank{r}.json")
                           .read_text()) for r in range(len(self.procs))]


def start_ranks(work: Path, tag: str, backend: str, one_card: bool,
                tasks, coco: Path) -> Workers:
    """DIST_WORLD rank workers of phase 13 (this script, --rank-worker)."""
    port = free_port()
    return Workers(work, tag, "--rank-worker", [{
        "rank": r, "world": DIST_WORLD, "port": port,
        "local_rank": 0 if one_card else r, "backend": backend,
        "tasks": list(tasks), "work": str(work), "tag": tag,
        "coco": str(coco), "workdir": str(work / f"{tag}_loop")}
        for r in range(DIST_WORLD)], DIST_TIMEOUT_S)


def distributed_phase(gpu, golden_sd, reset_counts, all_counts,
                      alongside=None, while_waiting=None) -> dict:
    """13. Data parallel (parallel/, the criterion over the global batch,
    the step through DistributedDataParallel, the loop and the mosaic over
    ranks). Returns the launch counts of its main path: 13a's world-1 DDP
    steps in this process, counted from 0 just before them and read just
    after, plus those of the two-rank workers of 13b-13d, each counted over
    its own run. Once 13a's timed steps are done its subprocesses (the CLI
    under torchrun, the two ranks) run side by side, and `alongside()`
    starts phase 15's ranks beside them; `while_waiting()` runs once this
    process's references are made, before it waits for the
    subprocesses."""
    import os
    import shutil
    import tempfile

    import torch

    from wildlifemapper_tpu_torch.config import model_config
    from wildlifemapper_tpu_torch.data.loader import DataLoader, build_dataset
    from wildlifemapper_tpu_torch.eval import coco_eval
    from wildlifemapper_tpu_torch.eval.evaluate import evaluate
    from wildlifemapper_tpu_torch.eval.orthomosaic import OrthomosaicDetector
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.parallel.mesh import make_mesh
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.train.synthetic import training_config
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    work = Path(tempfile.mkdtemp(prefix="wm_dist_"))
    env_cache = os.environ.get("WM_SYNTH_CACHE")
    os.environ["WM_SYNTH_CACHE"] = "0"
    golden = {k: torch.from_numpy(np.asarray(v)) for k, v in golden_sd.items()}
    cli = gloo = None
    try:
        coco = coco_subset(work / "coco")
        torch.save(golden, work / "golden.pt")

        # ---- 13a. NCCL at world 1 in this process: DDP against no group -------
        batches = [dist_batch(i) for i in range(TRAIN_STEPS)]

        def trainer(name="fine_tune"):
            sb = StepBuilder(training_config(name))
            load_reference_state_dict(sb.model, golden)
            return sb, sb.init_state(steps_per_epoch=100), torch.Generator(
                device=dev).manual_seed(11)

        plain = trainer()              # built before the group: one process
        dist.init_distributed_mode(
            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
            rank=0, local_rank=0)
        if make_mesh() is None or plain[1].data_parallel is not None:
            raise AssertionError("13a: the data axis is the process group")

        def three_steps(sb, state, gen):
            losses = []
            for b in batches:
                state, m = sb.train_step(state, b, gen)
                losses.append(m["loss"])
            return [x.item() for x in losses]

        ddp = trainer()
        torch.cuda.synchronize()
        reset_counts()                 # the phase's main path starts here
        ddp_losses = three_steps(*ddp)
        torch.cuda.synchronize()
        path_counts = all_counts()
        plain_losses = three_steps(*plain)
        differ = trees_equal(dict(ddp[0].model.named_parameters()),
                             dict(plain[0].model.named_parameters()),
                             "param")
        step_bytes = {"fine_tune": sum(
            p.numel() * 4 for p in ddp[0].model.parameters()
            if p.requires_grad)}
        plain_ms, ddp_ms = paired_ms(
            lambda: plain[0].train_step(plain[1], batches[0], plain[2]),
            lambda: ddp[0].train_step(ddp[1], batches[0], ddp[2]))
        del ddp, plain
        torch.cuda.empty_cache()
        scratch = trainer("from_scratch")
        step_bytes["from_scratch"] = sum(
            p.numel() * 4 for p in scratch[0].model.parameters()
            if p.requires_grad)
        del scratch
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
        identical = ddp_losses == plain_losses and not differ
        emit("dist_world1_ddp", gpu=gpu, backend="nccl", config="fine_tune",
             dtype="bfloat16", batch=BATCH, steps=TRAIN_STEPS,
             losses_ddp=ddp_losses, losses_no_group=plain_losses,
             bit_identical=identical, differing=differ[:10],
             ms_per_step_ddp=ddp_ms, ms_per_step_no_group=plain_ms,
             ddp_cost_ms=ddp_ms - plain_ms,
             bytes_all_reduced_per_step=step_bytes,
             launches=path_counts)
        if not identical:
            raise AssertionError(f"13a: DDP at world 1 differs from no "
                                 f"group: losses {ddp_losses} against "
                                 f"{plain_losses}, params {differ[:10]}")

        # ---- the subprocesses, side by side: 13a's CLI under torchrun, the
        # two ranks of 13b-13d (the .pth and the frame of 13d first), and
        # phase 15's ranks; the references of this process meanwhile
        b_cfg = model_config("vit_b", dtype="bfloat16",
                             use_flash_attention=True)
        seeded = WildlifeMapper(b_cfg, generator=torch.Generator(
            device=dev).manual_seed(0))
        with torch.no_grad():
            seeded.mask_decoder.class_embed.layers[-1].weight.mul_(
                CLASS_HEAD_SCALE)
        torch.save({"model": {"module." + k: v.detach().cpu() for k, v in
                              seeded.state_dict().items()},
                    "optimizer": {}, "epoch": 3}, work / "survey.pth")
        del seeded
        frame = survey_frame()[0]
        np.save(work / "frame.npy", frame)
        t_cli = time.perf_counter()
        cli_log = open(work / "cli.log", "w")
        cli = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "wildlifemapper_tpu_torch.cli.train",
             "--synthetic_data", "--synthetic_size", "1024", "--use_amp",
             "--batch_size", str(BATCH), "--epochs", "1", "--coco_path",
             str(coco), "--work_dir", str(work / "cli")],
            stdout=cli_log, stderr=subprocess.STDOUT,
            cwd=str(Path(__file__).resolve().parent),
            env=dict(os.environ, WM_SYNTH_CACHE="0"))
        gloo = start_ranks(work, "gloo", "gloo", True,
                           ("steps", "loop", "mosaic"), coco)
        if alongside is not None:
            alongside()

        # ---- references in one process: 13b's steps, 13d's detect -------------
        # the whole batch, and the control: rank 0's rows alone (a gradient
        # from half the batch), which 13b's limits must refuse
        def one_process(name, rows=slice(None)):
            sb = StepBuilder(dist_step_config(name))
            load_reference_state_dict(sb.model, golden)
            state = sb.init_state(steps_per_epoch=100)
            before = trainable(sb.model)
            losses, norms = [], []
            for i in range(TRAIN_STEPS):
                state, m = sb.train_step(state, dist_batch(i, rows))
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
            after = trainable(sb.model)
            run = {"losses": losses, "grad_norms": norms,
                   "change": {n: after[n] - p for n, p in before.items()},
                   "grad": trainable(sb.model, grads=True)}
            del sb, state, before, after
            torch.cuda.empty_cache()
            return run

        one = {name: one_process(name)
               for name in ("fine_tune", "from_scratch")}
        half = {name: one_process(name, slice(0, BATCH // 2))
                for name in one}
        want_mosaic = OrthomosaicDetector(
            survey_model(b_cfg, work / "survey.pth"), b_cfg,
            tile_batch=BATCH, overlap=MOSAIC_OVERLAP,
            confidence_threshold=0.5, nms_iou=0.4).detect(frame)
        torch.cuda.empty_cache()
        if while_waiting is not None:
            while_waiting()

        # ---- 13a. NCCL at world size 1: the CLI under torchrun ---------------
        try:
            returncode = cli.wait(timeout=max(1.0, DIST_TIMEOUT_S - (
                time.perf_counter() - t_cli)))
        except subprocess.TimeoutExpired:
            returncode = "timeout"
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
            cli_log.close()
        cli_s = time.perf_counter() - t_cli
        cli_out = (work / "cli.log").read_text()
        written = sorted(os.listdir(work / "cli")) if (
            work / "cli").exists() else []
        done = [line for line in cli_out.splitlines()
                if line.startswith("Epoch 0 done")]
        emit("dist_torchrun_cli", gpu=gpu, returncode=returncode,
             seconds=cli_s, steps=DIST_TRAIN_IMAGES // BATCH, epoch_line=done,
             written=written, note="beside phase 13's and 15's ranks")
        if (returncode != 0 or not done
                or not {"checkpoint_epoch_0", "config.json"} <= set(written)):
            raise AssertionError(f"13a torchrun: exit {returncode}, "
                                 f"written {written}: {cli_out[-3000:]}")

        # ---- 13b-13d. two ranks on this card over gloo ------------------------
        ranks = gloo.wait()
        for r in ranks:
            path_counts = add_counts(path_counts, r["counts"])
        reports = {"gloo": ranks}
        if torch.cuda.device_count() >= 2:
            reports["nccl"] = start_ranks(work, "nccl", "nccl", False,
                                          ("steps",), coco).wait()
            for r in reports["nccl"]:
                path_counts = add_counts(path_counts, r["counts"])
        emit("dist_two_ranks_run", gpu=gpu, backends=sorted(reports),
             nccl_two_cards=("run" if "nccl" in reports else
                             f"not run: {torch.cuda.device_count()} card"),
             devices=[[r["device"], r["device_name"]] for rs in
                      reports.values() for r in rs])

        # 13b: lock-step ranks, within the limits of one process at batch
        # BATCH; the controls (an unchanged state, half the batch's
        # gradient) over them, the second over every one
        problems = []
        for tag, rs in reports.items():
            for name, want in one.items():
                r0, r1 = (r["steps"][name] for r in rs)
                got = torch.load(work / f"{tag}_{name}.pt",
                                 weights_only=True)
                gaps = step_readings(r0["losses"], r0["grad_norms"],
                                     got["change"], got["grad"], want)
                h = half[name]
                controls = {
                    "unchanged_state": relative_gap(
                        {n: 0 * c for n, c in want["change"].items()},
                        want["change"]),
                    "half_batch": step_readings(h["losses"], h["grad_norms"],
                                                h["change"], h["grad"], want)}
                lock = (r0["losses"] == r1["losses"]
                        and r0["grad_norms"] == r1["grad_norms"]
                        and r0["digest"] == r1["digest"])
                emit("dist_two_ranks_steps", gpu=gpu, backend=tag,
                     config=name, dtype="bfloat16", rows_per_rank=BATCH // 2,
                     losses=[r0["losses"], r1["losses"]],
                     losses_one_process=want["losses"],
                     grad_norms=r0["grad_norms"],
                     grad_norms_one_process=want["grad_norms"],
                     lock_step=lock, gaps=gaps,
                     change_worst_element_gap=worst_element_gap(
                         got["change"], want["change"]),
                     controls=controls,
                     limits={"loss": DIST_LOSS_TOL,
                             "grad_norm": DIST_NORM_TOL,
                             "change": DIST_CHANGE_TOL,
                             "grad": DIST_GRAD_TOL},
                     ms_per_step=[r0["ms"], r1["ms"]],
                     note=("gloo stages the gradients through the host: "
                           "not representative of NCCL" if tag == "gloo"
                           else "NCCL over two cards"))
                if not lock or gaps["over_limit"]:
                    problems.append(f"13b {tag} {name}: lock-step {lock}, "
                                    f"gaps {gaps}")
                if (controls["unchanged_state"] <= DIST_CHANGE_TOL
                        or len(controls["half_batch"]["over_limit"]) < 4):
                    problems.append(f"13b {tag} {name}: the limits pass a "
                                    f"control: {controls}")
            del got

        # 13c: rank 0 alone writes; both ranks the same mAP; one process's
        # evaluation of the last checkpoint over the same split
        (l0, l1) = (r["loop"] for r in ranks)
        cfg = loop_cli_config(coco)
        sb = StepBuilder(cfg)
        raw = torch.load(work / "gloo_loop" / "checkpoint_epoch_2",
                         map_location="cpu", weights_only=True)
        sb.model.load_state_dict(raw["model"])
        ds = build_dataset("val", cfg.data)
        loader = DataLoader(ds, BATCH, shuffle=False, drop_last=False,
                            pin_memory=True)
        accumulate = coco_eval.CocoEvaluator.accumulate
        one_digest = []

        def recording_accumulate(self):
            one_digest.append(detections_digest(self))
            return accumulate(self)

        coco_eval.CocoEvaluator.accumulate = recording_accumulate
        try:
            stats = evaluate(sb.eval_step, sb.model, loader, ds.index, cfg,
                             print_fn=lambda *a, **k: None)
        finally:
            coco_eval.CocoEvaluator.accumulate = accumulate
            loader.close()
        del sb, raw
        torch.cuda.empty_cache()
        one_coco = {f"val/{k}": v for k, v in stats.items()
                    if k.startswith("coco/")}
        rank_coco = {k: v for k, v in l0["resumed"].items()
                     if k.startswith("val/coco/")}
        coco_gap = max(abs(one_coco[k] - rank_coco[k]) for k in one_coco)
        want_files = {"config.json", "best_loss.json", "checkpoint_epoch_0",
                      "checkpoint_epoch_1", "checkpoint_epoch_2",
                      "best_checkpoint"}
        rank0_files = {w.split(".")[1] if w.startswith(".") else w
                       for w in l0["writes"]}
        ids = sorted(ds.index.ids)
        # the last evaluation of each rank (the resumed epoch's) against the
        # one process's: the same detections in the same order
        same_dets = [r["scored"][-1][1] == one_digest[0] for r in (l0, l1)]
        whole = all(s[0] == ids for r in (l0, l1) for s in r["scored"])
        emit("dist_two_ranks_loop", gpu=gpu, backend="gloo",
             steps_per_epoch=4, epochs="2 + 1 resumed",
             rank0_wrote=sorted(rank0_files), rank1_wrote=l1["writes"],
             same_stats_on_both=l0["resumed"] == l1["resumed"],
             AP=[l0["resumed"]["val/coco/AP"], l1["resumed"]["val/coco/AP"]],
             AP_one_process=one_coco["val/coco/AP"],
             coco_gap_one_process=coco_gap, coco_limit=1e-3,
             bit_identical_one_process=one_coco == rank_coco,
             detections_bit_identical_one_process=same_dets,
             scored_whole_split=whole, val_images=len(ids),
             seconds=[l0["seconds"], l1["seconds"]],
             note="gloo two ranks on one card: not representative of NCCL")
        if (l1["writes"] or not want_files <= rank0_files
                or l0["first"] != l1["first"] or l0["resumed"] != l1["resumed"]
                or coco_gap > 1e-3 or not all(same_dets) or not whole):
            problems.append(
                f"13c: rank 0 wrote {sorted(rank0_files)}, rank 1 "
                f"{l1['writes']}; stats equal {l0['resumed'] == l1['resumed']}"
                f"; one-process gap {coco_gap}, detections {same_dets}, "
                f"whole split {whole}")

        # 13d: the mosaic over the ranks is one process's detect
        same = []
        for r in range(DIST_WORLD):
            got = np.load(work / f"gloo_mosaic_rank{r}.npz")
            same.append(all(np.array_equal(got[k], v)
                            for k, v in want_mosaic.items()))
        emit("dist_two_ranks_mosaic", gpu=gpu, backend="gloo",
             detections=len(want_mosaic["boxes"]),
             bit_identical_one_process=same,
             ms=[r["mosaic"]["ms"] for r in ranks],
             host_timing=[r["mosaic"]["timing"] for r in ranks],
             note="gloo two ranks on one card: not representative of NCCL")
        if not all(same) or not len(want_mosaic["boxes"]):
            problems.append(f"13d: the mosaic over two ranks equals one "
                            f"process's detect: {same}")
        if problems:
            raise AssertionError("; ".join(problems))
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait()
        if gloo is not None:
            gloo.stop()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        if env_cache is None:
            os.environ.pop("WM_SYNTH_CACHE", None)
        else:
            os.environ["WM_SYNTH_CACHE"] = env_cache
        shutil.rmtree(work, ignore_errors=True)
    emit("distributed_phase", seconds=time.perf_counter() - t_phase)
    return path_counts


# the tensor-parallel path of phase 15: a model axis of TP_RANKS ranks on
# this card over gloo (NCCL refuses two ranks on one device), each rank with
# the whole batch of BATCH (one data rank)
TP_RANKS = 2
TP_TIMEOUT_S = 480
TP_LAYOUTS = (("fine_tune", "packed"), ("fine_tune", "grouped"),
              ("from_scratch", "packed"))
TP_VIT_H_STEPS = 2
# 15d: the loop's epochs of TP_LOOP_STEPS steps and TP_LOOP_EVAL_BATCHES
# evaluation batches; each epoch's mean loss against one process's unbroken
# run (phase 10's limit for a resumed epoch)
TP_LOOP_STEPS = 4
TP_LOOP_EVAL_BATCHES = 2
TP_LOOP_TOL = 2e-2


def tp_config(name: str, layout: str = "packed",
              model_parallel: int = TP_RANKS):
    """13b's bf16 configuration `name` (hfc.dropout 0) in `layout`, over a
    model axis of `model_parallel`."""
    from wildlifemapper_tpu_torch.config import MeshConfig

    cfg = dist_step_config(name)
    return dataclasses.replace(
        cfg, mesh=MeshConfig(model_parallel_size=model_parallel),
        model=dataclasses.replace(cfg.model, attn_impl=layout))


def tp_vit_h_config(remat: bool = True, model_parallel: int = TP_RANKS):
    """Phase 14b's ViT-H from scratch at BATCH over a model axis."""
    from wildlifemapper_tpu_torch.config import MeshConfig
    from wildlifemapper_tpu_torch.train.synthetic import training_config

    cfg = training_config("from_scratch", "bfloat16", True, BATCH,
                          variant="vit_h", remat_blocks=remat)
    return dataclasses.replace(
        cfg, mesh=MeshConfig(model_parallel_size=model_parallel))


def tp_memory_rule(cfg) -> dict:
    """What the sharding rules say a rank holds of `cfg`'s model, counted
    from the whole model's shapes (built on the meta device): elements of
    every parameter and of the trainable ones, one process's and a rank's
    (a split parameter's numel / P)."""
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.parallel.mesh import param_pspec
    from wildlifemapper_tpu_torch.train.optimizer import param_group

    model = WildlifeMapper(cfg.model, device="meta")
    p = cfg.mesh.model_parallel_size
    specs = param_pspec(model, p)
    out = dict.fromkeys(("params", "trainable", "params_rank",
                         "trainable_rank"), 0)
    for n, t in model.named_parameters():
        rank_n = t.numel() // p if specs[n] else t.numel()
        train = param_group(n, cfg.train.freeze_encoder) != "frozen"
        out["params"] += t.numel()
        out["params_rank"] += rank_n
        out["trainable"] += t.numel() * train
        out["trainable_rank"] += rank_n * train
    return out


def tp_worker(spec_path: str) -> int:
    """One rank of phase 15 (`python3 chip_smoke.py --tp-worker
    <spec.json>`, started by tp_phase): 15a the three configurations' steps
    at P = 2, 15b ViT-H from scratch, 15d the loop, then the control (one
    block's copy_to_model without its backward sum); its results and its
    kernels' launch counts on the main path (15a, 15b, 15d) into the spec's
    directory."""
    import hashlib

    import torch

    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.parallel.mesh import make_mesh
    from wildlifemapper_tpu_torch.parallel.tensor_parallel import \
        all_reduce_model
    from wildlifemapper_tpu_torch.train import loop as loop_mod
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    spec = json.loads(Path(spec_path).read_text())
    rank, work = spec["rank"], Path(spec["work"])
    dist.init_distributed_mode(
        init_method=f"tcp://127.0.0.1:{spec['port']}",
        world_size=TP_RANKS, rank=rank, local_rank=0, backend="gloo")
    mesh = make_mesh(TP_RANKS)
    wrappers = port_wrappers()
    res = {"rank": rank, "model_rank": mesh.model_rank,
           "data_size": mesh.data_size,
           "device_name": torch.cuda.get_device_name()}
    golden = torch.load(work / "golden.pt", weights_only=True)

    def digests(model, whole_only=False):
        out = {}
        for n, p in model.named_parameters():
            if whole_only and hasattr(p, "model_parallel_split"):
                continue
            out[n] = hashlib.sha256(
                p.detach().float().cpu().numpy().tobytes()).hexdigest()
        return out

    def gathered(state, grads=False):
        """The trainable parameters (or gradients) of the whole model,
        gathered over the model group, on the host."""
        named = {n: (p.grad if grads else p).detach()
                 for n, p in state.model.named_parameters()
                 if p.requires_grad}
        return {n: t.float().cpu() for n, t in
                state.model_parallel.gather(named).items()}

    def steps(name, layout, tag, patch=None):
        """TRAIN_STEPS steps of 15a's configuration: losses, norms, ms, the
        digests of every parameter; rank 0 writes the change of the whole
        trainable parameters and the last gradients."""
        sb = StepBuilder(tp_config(name, layout))
        load_reference_state_dict(sb.model, golden)
        state = sb.init_state(steps_per_epoch=100)
        if patch is not None:
            patch(sb.model)
        before = gathered(state)
        counts = wrapper_counts(wrappers)
        losses, norms, ms = [], [], []
        for i in range(TRAIN_STEPS):
            batch = dist_batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = sb.train_step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        counts = sub_counts(wrapper_counts(wrappers), counts)
        after, grad = gathered(state), gathered(state, grads=True)
        if rank == 0:
            torch.save({"change": {n: after[n] - p
                                   for n, p in before.items()},
                        "grad": grad}, work / f"tp_{tag}.pt")
        out = {"losses": losses, "grad_norms": norms, "ms": ms,
               "counts": counts,
               "digests": digests(sb.model, whole_only=True),
               "split": sum(hasattr(p, "model_parallel_split")
                            for p in sb.model.parameters())}
        del sb, state, before, after, grad
        torch.cuda.empty_cache()
        return out

    # ---- 15a. ViT-B, three configurations --------------------------------
    seconds = res["seconds"] = {}
    t_section = time.perf_counter()
    res["steps"] = {f"{n}_{lay}": steps(n, lay, f"{n}_{lay}")
                    for n, lay in TP_LAYOUTS}
    counts_a = wrapper_counts(wrappers)
    seconds["15a"] = time.perf_counter() - t_section
    t_section = time.perf_counter()

    # ---- 15b. ViT-H from scratch, remat, full depth ----------------------
    # TP_VIT_H_STEPS steps with remat_blocks, then one more with it off on
    # the same model (the all-reduces a step either way)
    from wildlifemapper_tpu_torch.train.synthetic import synthetic_batch

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic_batch(BATCH, seed=11).items()}
    sb = StepBuilder(tp_vit_h_config(), generator=torch.Generator(
        device="cuda").manual_seed(0))
    state = sb.init_state(steps_per_epoch=100)
    gen = torch.Generator(device="cuda").manual_seed(13)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    vit_h = {}
    for remat in (True, False):
        for blk in sb.model.image_encoder.blocks:
            blk.remat = blk.attn.remat = remat
        torch.cuda.reset_peak_memory_stats()
        losses, ms, reduces, peaks = [], [], [], []
        for _ in range(TP_VIT_H_STEPS if remat else 1):
            before = all_reduce_model.count
            t0 = time.perf_counter()
            _, m = sb.train_step(state, batch, gen)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            reduces.append(all_reduce_model.count - before)
            peaks.append(torch.cuda.max_memory_allocated() - start)
        vit_h["remat" if remat else "none"] = {
            "losses": losses, "ms": ms, "all_reduces": reduces,
            "peak_above_start_bytes": peaks}
        if remat:
            params = list(sb.model.parameters())
            moments = [v for st in state.optimizer.state.values()
                       for k, v in st.items()
                       if k in ("exp_avg", "exp_avg_sq")]
            vit_h["remat"].update(
                allocated_at_start_bytes=start,
                param_bytes=sum(p.numel() * p.element_size()
                                for p in params),
                grad_bytes=sum(p.grad.numel() * p.grad.element_size()
                               for p in params if p.grad is not None),
                moment_bytes=sum(v.numel() * v.element_size()
                                 for v in moments),
                whole_digests=digests(sb.model, whole_only=True))
            del params, moments
    res["vit_h"] = vit_h
    del sb, state, batch
    torch.cuda.empty_cache()
    counts_b = wrapper_counts(wrappers)
    seconds["15b"] = time.perf_counter() - t_section

    # ---- 15d. the loop over the two ranks --------------------------------
    cfg = dataclasses.replace(
        loop_cli_config(Path(spec["coco"])),
        mesh=tp_config("fine_tune").mesh)
    t0 = time.perf_counter()
    res["loop"] = loop_mod.train(
        cfg, workdir=spec["workdir"], epochs=1, init_state_dict=golden,
        max_steps_per_epoch=TP_LOOP_STEPS,
        max_eval_batches=TP_LOOP_EVAL_BATCHES,
        print_fn=lambda *a, **k: None)
    torch.cuda.synchronize()
    seconds["15d"] = time.perf_counter() - t0
    counts_d = wrapper_counts(wrappers)           # the main path ends here
    # by encoder: ViT-B's (15a and the loop), ViT-H's (15b, head dim 80)
    res["counts"] = {
        "vit_b": add_counts(counts_a, sub_counts(counts_d, counts_b)),
        "vit_h": sub_counts(counts_b, counts_a)}

    # ---- 15a's control: block 0's qkv input without its backward sum -----
    def no_backward_sum(model):
        model.image_encoder.blocks[0].attn.qkv.group = None

    t0 = time.perf_counter()
    res["control"] = steps("fine_tune", "packed", "control",
                           patch=no_backward_sum)
    seconds["control"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    (work / f"tp_rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def start_tp_phase(golden_sd) -> dict:
    """Phase 15's work directory (the bundle's subset, the golden weights)
    and its TP_RANKS workers (this script, --tp-worker), started."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="wm_tp_"))
    coco = coco_subset(work / "coco")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in golden_sd.items()}, work / "golden.pt")
    port = free_port()
    workers = Workers(work, "tp", "--tp-worker", [{
        "rank": r, "port": port, "work": str(work), "coco": str(coco),
        "workdir": str(work / "tp_loop")} for r in range(TP_RANKS)],
        TP_TIMEOUT_S)
    return {"t0": t0, "work": work, "coco": coco, "workers": workers}


def tp_references(started, golden_sd, reset_counts, all_counts) -> dict:
    """Phase 15's references in this process, made while its ranks run:
    15a's three configurations at P = 1 (TRAIN_STEPS steps at batch BATCH:
    losses, norms, the trainable parameters' change, the last gradients,
    the launches) and 15d's loop, two epochs unbroken (each epoch's
    stats)."""
    import os

    import torch

    from wildlifemapper_tpu_torch.train import loop as loop_mod
    from wildlifemapper_tpu_torch.train.logging import NoOpLogger
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    work, coco = started["work"], started["coco"]
    golden = {k: torch.from_numpy(np.asarray(v)) for k, v in golden_sd.items()}
    env_cache = os.environ.get("WM_SYNTH_CACHE")
    os.environ["WM_SYNTH_CACHE"] = "0"
    try:
        # 15a's: one process at batch BATCH
        def one_process(name, layout):
            sb = StepBuilder(tp_config(name, layout, model_parallel=1))
            load_reference_state_dict(sb.model, golden)
            state = sb.init_state(steps_per_epoch=100)
            before = trainable(sb.model)
            losses, norms = [], []
            reset_counts()
            for i in range(TRAIN_STEPS):
                state, m = sb.train_step(state, dist_batch(i))
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
            counts = all_counts()
            after = trainable(sb.model)
            run = {"losses": losses, "grad_norms": norms,
                   "change": {n: after[n] - p for n, p in before.items()},
                   "grad": trainable(sb.model, grads=True), "counts": counts}
            del sb, state, before, after
            torch.cuda.empty_cache()
            return run

        wants = {f"{n}_{lay}": one_process(n, lay) for n, lay in TP_LAYOUTS}

        # 15d's: the loop's two epochs in one process, unbroken
        cfg = dataclasses.replace(loop_cli_config(coco), mesh=tp_config(
            "fine_tune", model_parallel=1).mesh)
        quiet = dict(init_state_dict=golden, print_fn=lambda *a, **k: None,
                     max_steps_per_epoch=TP_LOOP_STEPS,
                     max_eval_batches=TP_LOOP_EVAL_BATCHES)

        class Epochs(NoOpLogger):
            def __init__(self):
                self.stats = []

            def log_epoch(self, epoch, stats):
                self.stats.append(stats)

        unbroken = Epochs()
        loop_mod.train(cfg, workdir=str(work / "tp_unbroken"), epochs=2,
                       logger_backend=unbroken, **quiet)
    finally:
        if env_cache is None:
            os.environ.pop("WM_SYNTH_CACHE", None)
        else:
            os.environ["WM_SYNTH_CACHE"] = env_cache
    return {"wants": wants, "unbroken": unbroken.stats}


def tp_phase(gpu, golden_sd, reset_counts, all_counts, started=None) -> dict:
    """15. Tensor parallelism (the model axis of parallel/mesh.py) over two
    ranks on this card: 15a ViT-B's three configurations against one
    process, with a control the limits must refuse; 15b ViT-H from scratch
    at full width and depth; 15d the loop and its checkpoint resumed in one
    process. (15c, the kernels at a rank's shapes, runs in phases 2 and
    6.) Returns the launch counts of its main path by encoder (ViT-B: 15a
    and 15d; ViT-H: 15b), over both ranks, each counted over its own
    run. `started` is start_tp_phase's, when the ranks run already (beside
    phase 13's)."""
    import os
    import shutil

    import torch

    from wildlifemapper_tpu_torch.train import loop as loop_mod

    started = started or start_tp_phase(golden_sd)
    work, coco = started["work"], started["coco"]
    env_cache = os.environ.get("WM_SYNTH_CACHE")
    os.environ["WM_SYNTH_CACHE"] = "0"
    golden = {k: torch.from_numpy(np.asarray(v)) for k, v in golden_sd.items()}
    problems = []
    try:
        refs = started.get("refs") or tp_references(
            started, golden_sd, reset_counts, all_counts)
        wants, unbroken = refs["wants"], refs["unbroken"]
        ranks = started["workers"].wait()
        path_counts = {v: ranks[0]["counts"][v] for v in ("vit_b", "vit_h")}
        for r in ranks[1:]:
            path_counts = {v: add_counts(c, r["counts"][v])
                           for v, c in path_counts.items()}

        # ---- 15a. against one process at batch BATCH --------------------
        for name, layout in TP_LAYOUTS:
            key = f"{name}_{layout}"
            want = wants.pop(key)
            r0, r1 = (r["steps"][key] for r in ranks)
            got = torch.load(work / f"tp_{key}.pt", weights_only=True)
            gaps = step_readings(r0["losses"], r0["grad_norms"],
                                 got["change"], got["grad"], want)
            whole = [n for n in r0["digests"]
                     if r0["digests"][n] == r1["digests"][n]]
            lock = (r0["losses"] == r1["losses"]
                    and r0["grad_norms"] == r1["grad_norms"])
            # each rank launches every kernel a layer, as one process does
            same_launches = r0["counts"] == r1["counts"] == want["counts"]
            emit("tp_steps", gpu=gpu, backend="gloo", config=name,
                 layout=layout, dtype="bfloat16", batch=BATCH,
                 model_parallel=TP_RANKS, steps=TRAIN_STEPS,
                 losses=[r0["losses"], r1["losses"]],
                 losses_one_process=want["losses"],
                 grad_norms=r0["grad_norms"],
                 grad_norms_one_process=want["grad_norms"], gaps=gaps,
                 change_worst_element_gap=worst_element_gap(
                     got["change"], want["change"]),
                 limits={"loss": DIST_LOSS_TOL, "grad_norm": DIST_NORM_TOL,
                         "change": DIST_CHANGE_TOL, "grad": DIST_GRAD_TOL},
                 split_parameters=r0["split"],
                 whole_parameters=len(r0["digests"]),
                 whole_identical_across_ranks=len(whole), lock_step=lock,
                 launches_rank=r0["counts"],
                 launches_equal_one_process=same_launches,
                 ms_per_step=[r0["ms"], r1["ms"]],
                 note="two gloo ranks on one card: the sums over the "
                      "model group stage through the host; not NCCL")
            if (gaps["over_limit"] or not lock or not r0["split"]
                    or not same_launches or len(whole) != len(r0["digests"])):
                problems.append(f"15a {key}: gaps {gaps}, lock-step {lock}, "
                                f"{len(whole)} of {len(r0['digests'])} "
                                f"identical, {r0['split']} split, launches "
                                f"{r0['counts']} against {want['counts']}")
            if key == "fine_tune_packed":
                want_ft = want
            del got, want
        ctl = [r["control"] for r in ranks]
        got = torch.load(work / "tp_control.pt", weights_only=True)
        gaps = step_readings(ctl[0]["losses"], ctl[0]["grad_norms"],
                             got["change"], got["grad"], want_ft)
        apart = sum(ctl[0]["digests"][n] != ctl[1]["digests"][n]
                    for n in ctl[0]["digests"])
        emit("tp_control", gpu=gpu, config="fine_tune", layout="packed",
             patched="block 0's qkv input: copy_to_model without its "
                     "backward sum over the model group",
             gaps=gaps, whole_parameters_apart=apart)
        if not gaps["over_limit"] and apart == 0:
            problems.append(f"15a: the control passes the checks: {gaps}")
        del got, want_ft

        # ---- 15b. ViT-H from scratch -------------------------------------
        rule = tp_memory_rule(tp_vit_h_config())
        h0, h1 = (r["vit_h"] for r in ranks)
        want_bytes = {"param_bytes": 4 * rule["params_rank"],
                      "grad_bytes": 4 * rule["trainable_rank"],
                      "moment_bytes": 8 * rule["trainable_rank"]}
        got_bytes = [{k: h["remat"][k] for k in want_bytes} for h in (h0, h1)]
        same_whole = h0["remat"]["whole_digests"] == \
            h1["remat"]["whole_digests"]
        finite = all(np.isfinite(x) for h in (h0, h1)
                     for run in h.values() for x in run["losses"])
        reduces = [[h["remat"]["all_reduces"][0], h["none"]["all_reduces"][0]]
                   for h in (h0, h1)]
        peaks = [h["remat"]["peak_above_start_bytes"] for h in (h0, h1)]
        emit("tp_vit_h", gpu=gpu, backend="gloo", config="from_scratch",
             variant="vit_h", remat_blocks=True, dtype="bfloat16",
             batch=BATCH, model_parallel=TP_RANKS,
             losses=[h["remat"]["losses"] for h in (h0, h1)],
             loss_without_remat=[h["none"]["losses"] for h in (h0, h1)],
             ms_per_step=[h["remat"]["ms"] for h in (h0, h1)],
             ms_per_step_without_remat=[h["none"]["ms"] for h in (h0, h1)],
             all_reduces_per_step_remat_and_none=reduces,
             first_step_peak_above_start_bytes=[p[0] for p in peaks],
             peak_above_start_bytes_by_step=peaks,
             step3_without_remat_peak_above_start_bytes=[
                 h["none"]["peak_above_start_bytes"][0] for h in (h0, h1)],
             allocated_at_start_bytes=[h["remat"]["allocated_at_start_bytes"]
                                       for h in (h0, h1)],
             rank_bytes=got_bytes, rule_bytes=want_bytes,
             one_process_elements={"params": rule["params"],
                                   "trainable": rule["trainable"]},
             rank_share=rule["params_rank"] / rule["params"],
             whole_parameters=len(h0["remat"]["whole_digests"]),
             whole_parameters_identical=same_whole,
             note="two gloo ranks share one card and its host: the step "
                  "times bound nothing of NCCL across cards")
        if (not finite or not same_whole
                or any(g != want_bytes for g in got_bytes)
                or any(a != b for a, b in reduces)):
            problems.append(f"15b: finite {finite}, whole parameters "
                            f"identical {same_whole}, bytes {got_bytes} "
                            f"against {want_bytes}, all-reduces {reduces}")

        # ---- 15d. the loop's checkpoint resumed in one process -----------
        # the ranks ran epoch 0 at P = 2; one process resumes its
        # checkpoint (the whole model) for epoch 1, and runs both epochs
        # unbroken from the same weights
        l0, l1 = ranks[0]["loop"], ranks[1]["loop"]
        cfg = dataclasses.replace(loop_cli_config(coco), mesh=tp_config(
            "fine_tune", model_parallel=1).mesh)
        quiet = dict(init_state_dict=golden, print_fn=lambda *a, **k: None,
                     max_steps_per_epoch=TP_LOOP_STEPS,
                     max_eval_batches=TP_LOOP_EVAL_BATCHES)
        resume = work / "tp_resume"
        resume.mkdir()
        shutil.copy(work / "tp_loop" / "checkpoint_epoch_0", resume)
        resumed = loop_mod.train(cfg, workdir=str(resume), epochs=2,
                                 resume=True, **quiet)
        want = [e["train/loss"] for e in unbroken]
        got = [l0["train/loss"], resumed["train/loss"]]
        gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        emit("tp_loop", gpu=gpu, backend="gloo",
             steps_per_epoch=TP_LOOP_STEPS,
             eval_batches=TP_LOOP_EVAL_BATCHES, model_parallel=TP_RANKS,
             loss_epoch0_ranks=[l0["train/loss"], l1["train/loss"]],
             AP_ranks=[l0["val/coco/AP"], l1["val/coco/AP"]],
             loss_epoch1_resumed_one_process=resumed["train/loss"],
             loss_unbroken_one_process=want, relative_gaps=gaps,
             limit=TP_LOOP_TOL, same_stats_on_both=l0 == l1)
        emit("tp_rank_seconds", seconds=[r["seconds"] for r in ranks])
        if l0 != l1 or not max(gaps) <= TP_LOOP_TOL:
            problems.append(f"15d: stats equal {l0 == l1}, the loss gaps to "
                            f"one unbroken process {gaps}")
        if problems:
            raise AssertionError("; ".join(problems))
    finally:
        started["workers"].stop()
        if env_cache is None:
            os.environ.pop("WM_SYNTH_CACHE", None)
        else:
            os.environ["WM_SYNTH_CACHE"] = env_cache
        shutil.rmtree(work, ignore_errors=True)
    emit("tp_phase", seconds=time.perf_counter() - started["t0"],
         note="its ranks ran beside phase 13's subprocesses")
    return path_counts


# the large encoders' paths of phase 14: 14d's CLI epoch over the first
# LARGE_TRAIN_IMAGES / LARGE_VAL_IMAGES images of the bundle (4 steps of
# BATCH, 2 eval batches), the drift script over LARGE_DRIFT_TILES tiles
LARGE_TRAIN_IMAGES = 16
LARGE_VAL_IMAGES = 8
LARGE_DRIFT_TILES = 4
LARGE_SCRIPT_TIMEOUT_S = 300


def vm_rss_mb() -> float:
    """This process's resident set on the host in MB (/proc/self/status)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS line in /proc/self/status")


def rss_reading(rss: list) -> dict:
    """A loop's host RSS a step: the first, the last, and the growth a step
    (least squares over the steps after the first quarter, where the loader
    and the allocator have warmed up)."""
    tail = rss[len(rss) // 4:]
    slope = (float(np.polyfit(np.arange(len(tail)), tail, 1)[0])
             if len(tail) > 1 else 0.0)
    return {"steps": len(rss), "first_mb": rss[0], "last_mb": rss[-1],
            "max_mb": max(rss), "growth_mb_per_step": slope}


def block_forward(cfg) -> dict:
    """The launches of one forward of `cfg`'s encoder blocks, by wrapper:
    each windowed block's attention, each global block's and, in the packed
    layout, each block's MLP (the adaptor's, K4, per_step adds)."""
    v = cfg.model.vit
    glob = len(v.global_attn_indexes)
    packed = cfg.model.attn_impl == "packed"
    out = dict.fromkeys(port_wrappers(), 0)
    out["flash_attention_packed" if packed else
        "flash_attention_rel_pos"] = glob
    out["windowed_attention_packed" if packed else
        "windowed_attention_rel_pos"] = v.depth - glob
    out["fused_mlp"] = v.depth if packed else 0
    return out


def large_launches(name: str, counts: dict) -> int:
    """A report entry's launches on phase 14's main path (`counts` by
    variant): the forward and K3 / K4 entries count both encoders, the
    head-dim-80 backward entries ViT-H's, the others ViT-L's (head dim 64).
    The grouped layout runs at d 80 only."""
    vit_l, vit_h = counts["vit_l"], counts["vit_h"]
    if name.endswith("_backward_d80"):
        base = name[:-len("_backward_d80")]
        return vit_h["backward_launches" if base.startswith("windowed")
                     else "backward_dq_launches"][base]
    if "_backward" in name and not name.startswith(("fused_mlp",
                                                    "cross_attention")):
        return loop_launches(name, vit_l)
    return loop_launches(name, add_counts(vit_l, vit_h))


def tp_launches(name: str, counts: dict) -> int:
    """A report entry's launches on phase 15's main path (`counts` by
    encoder): the head-dim-80 backward entries ViT-H's (packed; the
    grouped d-80 entries none), the other backward entries of the
    attention kernels ViT-B's, the forward and K3 / K4 entries both's."""
    if name.endswith("_backward_d80"):
        base = name[:-len("_backward_d80")]
        if base.endswith("rel_pos"):
            return 0
        return counts["vit_h"]["backward_launches" if base.startswith(
            "windowed") else "backward_dq_launches"][base]
    if "_backward" in name and not name.startswith(("fused_mlp",
                                                    "cross_attention")):
        return loop_launches(name, counts["vit_b"])
    return loop_launches(name, add_counts(counts["vit_b"], counts["vit_h"]))


def large_phase(gpu, reset_counts, all_counts, per_step, one_wait,
                step_parity, batch4) -> dict:
    """14. The large encoders' training paths and the scripts users run.
    Returns the launch counts of its main path by variant: 14a's bf16 steps
    (ViT-L) and 14b's (ViT-H), each run counted from 0 just before it and
    read just after."""
    import argparse
    import contextlib
    import io
    import os
    import shutil
    import subprocess
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wildlifemapper_tpu_torch.cli import train as cli_train
    from wildlifemapper_tpu_torch.config import model_config
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.train.profiling import StepWatch
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.train.synthetic import training_config

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)   # the timed steps'
    zero = {a: dict.fromkeys(port_wrappers(), 0) for a in COUNT_NAMES}
    path_counts = {"vit_l": zero, "vit_h": zero}

    def trainer(name, variant, batch, remat=True, layout="packed"):
        cfg = training_config(name, "bfloat16", True, batch,
                              variant=variant, remat_blocks=remat)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attn_impl=layout))
        sb = StepBuilder(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0))
        return sb, sb.init_state(steps_per_epoch=100)

    def rows(batch):
        return {k: v[:batch] for k, v in batch4.items()}

    def want_counts(cfg, steps):
        """per_step's counts at the encoder's depth (K4 without the
        adaptor's dropout, the from-scratch set-up); with remat every
        block's attention forward twice, the MLP's once."""
        fwd = block_forward(cfg)
        per = per_step(cfg.model.hfc.dropout == 0.0, cfg.model.attn_impl,
                       forward=fwd)
        blocks = {n for n in fwd if n.startswith(("windowed", "flash"))}
        if cfg.model.remat_blocks:
            per["launches"] = {n: v * (2 if n in blocks else 1)
                               for n, v in per["launches"].items()}
        return {a: {n: v * steps for n, v in d.items()}
                for a, d in per.items()}

    def grads_of(sb):
        return {n: p.grad.detach().clone()
                for n, p in sb.model.named_parameters() if p.grad is not None}

    def run(tag, name, variant, batch, layout="packed", steps=TRAIN_STEPS,
            keep_first=False):
        """`steps` bf16 steps with remat_blocks, seeded weights: the counts
        set to 0 just before and read just after, finite (and, over several
        steps, falling) losses, trainable parameters moved and frozen ones
        bit-identical, peak memory. Returns the trainer, its state, the
        batch, the metrics, the first step's gradients (keep_first) and its
        peak above what was allocated before the steps."""
        sb, state = trainer(name, variant, batch, layout=layout)
        batch_ = rows(batch)
        before = {n: p.detach().clone()
                  for n, p in sb.model.named_parameters()}
        gen = torch.Generator(device=dev).manual_seed(13)
        torch.cuda.synchronize()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        metrics, first = [], None
        reset_counts()                 # the run starts here
        for i in range(steps):
            _, m = sb.train_step(state, batch_, gen)
            metrics.append(m)
            if i == 0:
                # the first step's peak: its activations, gradients and the
                # AdamW moments it makes (the clone below not counted)
                torch.cuda.synchronize()
                first_peak = torch.cuda.max_memory_allocated() - start_bytes
                if keep_first:
                    first = grads_of(sb)
        torch.cuda.synchronize()
        got = all_counts()
        # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        path_counts[variant] = add_counts(path_counts[variant], got)
        want = want_counts(sb.cfg, steps)
        emit("large_training_launches", run=tag, launches=got, want=want)
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, want {want}")
        ms = [{k: v.item() for k, v in m.items()} for m in metrics]
        unmoved, changed, encoder = [], [], 0
        for n, p in sb.model.named_parameters():
            same = torch.equal(p.detach(), before[n])
            if p.requires_grad and same:
                unmoved.append(n)
            if not p.requires_grad and not same:
                changed.append(n)
            encoder += (p.requires_grad
                        and n.startswith("image_encoder.blocks."))
        del before
        finite = all(np.isfinite(v) for m in ms for v in m.values())
        falling = steps == 1 or ms[-1]["loss"] < ms[0]["loss"]
        trainable_n = sum(p.requires_grad for p in sb.model.parameters())
        emit("large_training", run=tag, variant=variant, config=name,
             layout=layout, remat_blocks=True, dtype="bfloat16", batch=batch,
             steps=steps, gpu=gpu, loss=[m["loss"] for m in ms],
             grad_norm=[m["grad_norm"] for m in ms],
             parameters_trainable=trainable_n,
             encoder_block_parameters_trainable=encoder,
             trainable_elements=sum(p.numel() for p in sb.model.parameters()
                                    if p.requires_grad),
             parameters_moved=trainable_n - len(unmoved),
             parameters_frozen_identical=sum(
                 not p.requires_grad for p in sb.model.parameters())
             - len(changed),
             peak_memory_bytes=peak,
             peak_above_start_bytes=peak - start_bytes,
             first_step_peak_above_start_bytes=first_peak,
             allocated_at_start_bytes=start_bytes)
        if (not finite or not falling or unmoved or changed
                or (name == "from_scratch") != (encoder > 0)):
            raise AssertionError(f"{tag}: losses {[m['loss'] for m in ms]}, "
                                 f"trainable unmoved {unmoved[:5]}, frozen "
                                 f"changed {changed[:5]}, {encoder} encoder "
                                 "block parameters trainable")
        return sb, state, batch_, ms, first, first_peak

    def against_none(tag, variant, batch, first_ms, first_grads, above):
        """The same first step without remat_blocks (same weights, batch
        and dropout seed): losses and gradients against the remat step's,
        whether bit-identical, and its peak memory. Returns its trainer."""
        sb, state = trainer("from_scratch", variant, batch, remat=False)
        torch.cuda.synchronize()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, m = sb.train_step(state, rows(batch),
                             torch.Generator(device=dev).manual_seed(13))
        torch.cuda.synchronize()
        above_none = torch.cuda.max_memory_allocated() - start_bytes
        loss = m["loss"].item()
        grads = grads_of(sb)
        same = (set(grads) == set(first_grads) and all(
            torch.equal(first_grads[n], g) for n, g in grads.items())
            and loss == first_ms["loss"])
        worst = max(((first_grads[n] - g).norm()
                     / g.norm().clamp_min(1e-30)).item()
                    for n, g in grads.items())
        emit("large_remat_against_none", run=tag, variant=variant,
             config="from_scratch", dtype="bfloat16", batch=batch, gpu=gpu,
             loss_remat=first_ms["loss"], loss_without=loss,
             grad_norm_remat=first_ms["grad_norm"],
             grad_norm_without=m["grad_norm"].item(), gradients=len(grads),
             bit_identical=same, max_relative_grad_err=worst,
             first_step_peak_above_start_bytes_remat=above,
             first_step_peak_above_start_bytes_without=above_none,
             saved_by_remat_bytes=above_none - above)
        if worst > 1e-3 or not np.isclose(first_ms["loss"], loss, rtol=1e-4):
            raise AssertionError(f"{tag}: remat_blocks changed the step "
                                 f"(loss {first_ms['loss']} against {loss}, "
                                 f"relative gradient error {worst})")
        del grads
        return sb, state

    def products(sb, state, batch_, dim):
        """The matrix products of proj's and of qkv's shape (aten::addmm of
        an (R, dim) input) one profiled step dispatches, the backward's
        recompute included."""
        r = batch_["image"].shape[0] * (768 // 16) ** 2
        shapes = {"proj": [[dim], [r, dim], [dim, dim]],
                  "qkv": [[3 * dim], [r, dim], [dim, 3 * dim]]}
        found = dict.fromkeys(shapes, 0)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            sb.train_step(state, batch_,
                          torch.Generator(device=dev).manual_seed(17))
            torch.cuda.synchronize()
        for e in prof.events():
            if e.name == "aten::addmm":
                got = [list(s) for s in e.input_shapes[:3]]
                for k, s in shapes.items():
                    found[k] += got == s
        return found

    # ---- 14a. ViT-L: the fine-tune and from scratch, remat ----------------
    sb, state, batch_, ms, _, above = run("14a vit_l fine_tune", "fine_tune",
                                          "vit_l", BATCH)
    one_wait("vit_l fine_tune remat", "packed", sb, state)
    step_ms = time_ms(lambda: sb.train_step(state, batch_, gen), iters=3)
    emit("large_step_time", run="14a vit_l fine_tune", batch=BATCH, gpu=gpu,
         ms_per_step=step_ms, tiles_per_s=BATCH * 1000 / step_ms)
    del sb, state
    torch.cuda.empty_cache()
    sb, state, batch_, ms, first, above = run(
        "14a vit_l from_scratch", "from_scratch", "vit_l", BATCH,
        keep_first=True)
    one_wait("vit_l from_scratch remat", "packed", sb, state)
    sb_n, state_n = against_none("14a", "vit_l", BATCH, ms[0], first, above)
    del first
    ms_none, ms_remat = paired_ms(
        lambda: sb_n.train_step(state_n, batch_, gen),
        lambda: sb.train_step(state, batch_, gen), iters=2)
    # proj's GEMM in the recompute: the products of each shape in one step
    # with remat and without; the recompute repeats qkv's (one a block) and
    # must not repeat proj's
    prod_remat = products(sb, state, batch_, 1024)
    prod_none = products(sb_n, state_n, batch_, 1024)
    emit("large_step_time", run="14a vit_l from_scratch", batch=BATCH,
         gpu=gpu, ms_per_step_remat=ms_remat, ms_per_step_without=ms_none,
         tiles_per_s_remat=BATCH * 1000 / ms_remat,
         addmm_remat=prod_remat, addmm_without=prod_none)
    depth = sb.cfg.model.vit.depth
    if (prod_remat["proj"] != prod_none["proj"] or prod_none["proj"] < depth
            or prod_remat["qkv"] != prod_none["qkv"] + depth):
        raise AssertionError(f"14a: the recompute's products {prod_remat} "
                             f"against {prod_none} without remat: want "
                             f"{depth} more of qkv's shape and as many of "
                             "proj's")
    del sb, state, sb_n, state_n
    torch.cuda.empty_cache()

    # ---- 14b. ViT-H from scratch, remat, batch 1 and 4; grouped -----------
    for batch in (1, BATCH):
        tag = f"14b vit_h from_scratch batch {batch}"
        sb, state, batch_, ms, first, above = run(
            tag, "from_scratch", "vit_h", batch, keep_first=batch == BATCH)
        # AdamW over the trained parameters (the last step's gradients)
        adamw_ms = time_ms(state.optimizer.step, iters=3)
        if batch == BATCH:
            one_wait("vit_h from_scratch remat", "packed", sb, state)
            sb_n, state_n = against_none("14b", "vit_h", batch, ms[0], first,
                                         above)
            del first
            ms_none, step_ms = paired_ms(
                lambda: sb_n.train_step(state_n, batch_, gen),
                lambda: sb.train_step(state, batch_, gen), iters=2)
            del sb_n, state_n
        else:
            step_ms, ms_none = time_ms(
                lambda: sb.train_step(state, batch_, gen), iters=3), None
        emit("large_step_time", run=tag, batch=batch, gpu=gpu,
             ms_per_step_remat=step_ms, ms_per_step_without=ms_none,
             tiles_per_s_remat=batch * 1000 / step_ms, adamw_ms=adamw_ms,
             adamw_share=adamw_ms / step_ms)
        del sb, state
        torch.cuda.empty_cache()
    run("14b vit_h from_scratch grouped batch 1", "from_scratch", "vit_h", 1,
        layout="grouped", steps=1)
    torch.cuda.empty_cache()

    # ---- 14c. f32 parity through the kernels, from scratch, batch 1 -------
    for variant in ("vit_l", "vit_h"):
        step_parity("from_scratch", 1, with_k4=True, variant=variant)
        torch.cuda.empty_cache()

    # ---- 14d. the scripts on the card ---------------------------------------
    repo = Path(__file__).resolve().parent
    scripts = repo / "scripts"
    work = Path(tempfile.mkdtemp(prefix="wm_large_"))
    env_cache = os.environ.get("WM_SYNTH_CACHE")
    try:
        coco = coco_subset(work / "coco", LARGE_TRAIN_IMAGES, LARGE_VAL_IMAGES)
        cache = work / "synth"
        env = dict(os.environ, WM_SYNTH_CACHE=str(cache))
        t0 = time.perf_counter()
        pre = subprocess.run(
            [sys.executable, str(scripts / "prewarm_synth_cache_torch.py"),
             "--coco_path", str(coco), "--synthetic_size", "1024"],
            env=env, capture_output=True, text=True,
            timeout=LARGE_SCRIPT_TIMEOUT_S)
        prewarm_s = time.perf_counter() - t0
        tiles = sorted(p.name for p in cache.glob("*.npz"))
        emit("large_script", script="prewarm_synth_cache_torch.py",
             returncode=pre.returncode, seconds=prewarm_s, tiles=len(tiles),
             tail=pre.stdout.splitlines()[-2:], stderr=pre.stderr[-500:])
        if (pre.returncode or "PREWARM_DONE" not in pre.stdout
                or len(tiles) != LARGE_TRAIN_IMAGES + LARGE_VAL_IMAGES):
            raise AssertionError(f"prewarm: rc {pre.returncode}, "
                                 f"{len(tiles)} tiles")

        # the CLI from scratch with ViT-L and remat: two epochs with their
        # evaluations over the warm disk cache; the host's RSS a step, read
        # over the second epoch, when the loader's in-memory tile cache
        # holds every tile (the first epoch grows it by its new tiles)
        os.environ["WM_SYNTH_CACHE"] = str(cache)
        rss = []
        watch = StepWatch(after=lambda k: rss.append(vm_rss_mb()))
        run_dir = work / "run"
        log = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            stats = cli_train.main([
                "--model_type", "vit_l", "--train_encoder", "--content_size",
                "768", "--crop_prologue", "--window_size", "12", "--remat",
                "--synthetic_data", "--synthetic_size", "1024", "--use_amp",
                "--device_normalize", "--batch_size", str(BATCH),
                "--epochs", "2", "--checkpoint_every", "2", "--best_every",
                "2", "--coco_path", str(coco), "--work_dir", str(run_dir)],
                watch=watch)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_counts = all_counts()
        (run_dir / "train.log").write_text(log.getvalue())
        steps = len(watch.metrics)
        per_epoch = LARGE_TRAIN_IMAGES // BATCH
        losses = [m["loss"].item() for m in watch.metrics]
        loop_ap = stats["val/coco/AP"]        # the last epoch's
        epoch_ms = watch.ms_per_step(per_epoch)
        emit("large_cli", gpu=gpu, steps=steps, seconds=cli_s,
             ms_per_step=epoch_ms, tiles_per_s=BATCH * 1000 / epoch_ms[-1],
             eval_seconds=watch.eval_seconds,
             eval_tiles_per_s=LARGE_VAL_IMAGES / watch.eval_seconds[-1],
             losses=losses, coco_AP=loop_ap, launches=cli_counts,
             host_rss_mb=rss, host_rss_second_epoch=rss_reading(
                 rss[per_epoch:]),
             written=sorted(p.name for p in run_dir.iterdir()))
        if steps != 2 * per_epoch or not np.isfinite(losses).all() or not (
                loop_ap == -1.0 or 0 <= loop_ap <= 1):
            raise AssertionError(f"cli: {steps} steps, losses {losses}, "
                                 f"coco/AP {loop_ap}")

        # the drift script (seeded ViT-B weights, class head scaled, as a
        # bare state dict) beside the checkpoint series over the run
        drift_model = WildlifeMapper(model_config("vit_b"),
                                     generator=torch.Generator(device=dev)
                                     .manual_seed(0))
        with torch.no_grad():
            drift_model.mask_decoder.class_embed.layers[-1].weight.mul_(
                CLASS_HEAD_SCALE)
        torch.save({k: v.cpu() for k, v in drift_model.state_dict().items()},
                   work / "drift_weights.pt")
        del drift_model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        drift = subprocess.Popen(
            [sys.executable, str(scripts / "drift_map_torch.py"), "--n_imgs",
             str(LARGE_DRIFT_TILES), "--val_tiles", "--coco_path", str(coco),
             "--torch_checkpoint", str(work / "drift_weights.pt")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            series = subprocess.run(
                ["bash", str(scripts / "eval_checkpoint_series_torch.sh")],
                env=dict(env, RUN=str(run_dir), BATCH=str(BATCH), EPOCHS="1",
                         CONFIG_JSON=str(run_dir / "config.json"),
                         EXTRA_ARGS=" ".join([
                             "--synthetic_data", "--synthetic_size", "1024",
                             "--use_amp", "--device_normalize",
                             "--coco_path", str(coco)])),
                capture_output=True, text=True,
                timeout=LARGE_SCRIPT_TIMEOUT_S)
            series_s = time.perf_counter() - t0
            drift_out, drift_err = drift.communicate(
                timeout=LARGE_SCRIPT_TIMEOUT_S)
            drift_s = time.perf_counter() - t0
        finally:
            if drift.poll() is None:
                drift.kill()
                drift.wait()
        series_ap = [float(x) for x in re.findall(
            r"^coco/AP: ([-\d.]+)$", series.stdout, re.M)]
        emit("large_script", script="eval_checkpoint_series_torch.sh",
             returncode=series.returncode, seconds=series_s,
             lines=series.stdout.splitlines()[-8:], coco_AP=series_ap,
             loop_coco_AP=loop_ap, stderr=series.stderr[-500:])
        if (series.returncode or "SERIES_DONE" not in series.stdout
                or "FAILED" in series.stdout or len(series_ap) != 1
                or abs(series_ap[0] - loop_ap) > 1e-3):
            raise AssertionError(f"checkpoint series: coco/AP {series_ap} "
                                 f"against the loop's {loop_ap}")

        curve = subprocess.run(
            [sys.executable, str(scripts / "val_curve.py"),
             str(run_dir / "train.log")], capture_output=True, text=True,
            timeout=60)
        curve_rows = [line.split() for line in curve.stdout.splitlines()
                      if line.split() and line.split()[0].isdigit()]
        emit("large_script", script="val_curve.py",
             returncode=curve.returncode, rows=curve_rows)
        if (curve.returncode or [r[0] for r in curve_rows] != ["0", "1"]
                or any(len(r) != 5 for r in curve_rows)
                or abs(float(curve_rows[-1][3]) - loop_ap) > 1e-3):
            raise AssertionError(f"val_curve: {curve_rows}, rc "
                                 f"{curve.returncode}")

        drift_rows = {m[0]: (float(m[1]), float(m[2])) for m in re.findall(
            r"^(\S+) *: AP=([-\d.]+) AP50=([-\d.]+)$", drift_out, re.M)}
        n_gt = re.search(r"pseudo-GT detections: (\d+)", drift_out)
        emit("large_script", script="drift_map_torch.py",
             returncode=drift.returncode, seconds=drift_s,
             n_imgs=LARGE_DRIFT_TILES,
             pseudo_gt=int(n_gt.group(1)) if n_gt else None,
             rows=drift_rows, stderr=drift_err[-500:])
        gate = [drift_rows.get(k, (None, None))[1]
                for k in ("f32+kernels", "f32+kernels@serve0.5")]
        if drift.returncode or not n_gt or int(n_gt.group(1)) == 0 \
                or gate != [1.0, 1.0]:
            raise AssertionError(f"drift map: f32 with kernels against f32 "
                                 f"plain AP50 {gate}, want 1.000")
    finally:
        if env_cache is None:
            os.environ.pop("WM_SYNTH_CACHE", None)
        else:
            os.environ["WM_SYNTH_CACHE"] = env_cache
        shutil.rmtree(work, ignore_errors=True)
    emit("large_phase", seconds=time.perf_counter() - t_phase)
    return path_counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2

    # by path: an installed package named "tests" may shadow the repo's
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from golden_common import meta_to_state_dict, padded_canvas
    from wildlifemapper_tpu_torch.config import model_config
    from wildlifemapper_tpu_torch.eval.postprocess import (batched_nms,
                                                           postprocess)
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.ops import _attention, _build
    from wildlifemapper_tpu_torch.ops._attention import (
        _backward_kernel_launch, _sm90_backward_launch,
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_delta, attention_launch, attention_plain, sm90_scratch)
    from wildlifemapper_tpu_torch.ops.cross_attention import (
        cross_attention_packed, cross_attention_packed_plain)
    from wildlifemapper_tpu_torch.ops.flash_attention import (
        flash_attention_rel_pos, grouped_attention_backward_plain,
        grouped_attention_plain)
    from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
        flash_attention_packed, flash_attention_packed_plain)
    from wildlifemapper_tpu_torch.ops.fused_mlp import (
        _BIAS, _BIAS_GELU, _gemm, fused_mlp, fused_mlp_backward_plain,
        fused_mlp_dh, fused_mlp_dh_plain, fused_mlp_plain)
    from wildlifemapper_tpu_torch.ops.windowed_attention import \
        windowed_attention_rel_pos
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
        windowed_attention_packed, windowed_attention_packed_plain)
    from wildlifemapper_tpu_torch.train.criterion import hungarian_match
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.train.synthetic import (synthetic_batch,
                                                          training_config)
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_query()

    # ---- 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    build_log = (lib_path.parent / "build.log").read_text()
    ptxas = ptxas_summary(build_log)
    emit("device", kind=kind, gpu=gpu, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(build_s, 2), ptxas=ptxas)
    # the resident forward and backward at d = 64 and 80, two instantiations
    # (key tiles) each in each family
    resident_ptxas = [line for line in ptxas if "resident_kernel" in line]
    spilling = [line for line in resident_ptxas if ", 0 B spilled" not in line]
    if len(resident_ptxas) < 16 or spilling:
        raise AssertionError(f"resident bodies: {len(resident_ptxas)} ptxas "
                             f"lines, spilling: {spilling}")
    # the K3 GEMM body's instantiations and the f32 K3 GEMM body's three
    # (fc1 + GELU, fc2, dh), the latter also at most F32_GEMM_REGISTERS
    # registers a thread (two blocks an SM); head dim 80: the tile bodies (the
    # f32 forward, the bf16 and f32 backward), the Hopper forward (with and
    # without tables), the Hopper backward (the dq kernel with tables and
    # table gradients, with tables, without; the dk/dv kernel with and
    # without tables) and the resident forward and backward (two key-tile
    # counts each), each in both families; the Hopper forward's seven a
    # family and the Hopper backward's fifteen
    gemm_ptxas = [line for line in ptxas if "fused_mlp_gemm_sm90" in line]
    k3_f32 = [line for line in ptxas
              if line.startswith("fused_mlp_gemm_f32_kernel<")]
    k3_f32_regs = [int(re.search(r": (\d+) registers", line).group(1))
                   for line in k3_f32]
    d80 = {"tile": [], "hopper": [], "resident": []}
    for line in ptxas:
        if re.search(r"kernel<(float,)?80[,>]", line):
            d80["hopper" if "_sm90_" in line else
                "resident" if "resident" in line else "tile"].append(line)
    fwd_ptxas = [line for line in ptxas
                 if line.startswith("attn_fwd_sm90")]
    bwd_ptxas = [line for line in ptxas
                 if line.startswith(("attn_bwd_dq_sm90", "attn_bwd_dkv_sm90"))]
    spilling = [line for line in gemm_ptxas + k3_f32
                + sum(d80.values(), []) + fwd_ptxas + bwd_ptxas
                if ", 0 B spilled" not in line]
    emit("ptxas_held_to_no_spill", gemm=gemm_ptxas, k3_f32=k3_f32,
         head_dim_80=d80, hopper_forward=fwd_ptxas, hopper_backward=bwd_ptxas)
    if (len(gemm_ptxas) < 3 or len(k3_f32) < 3
            or max(k3_f32_regs) > F32_GEMM_REGISTERS
            or len(d80["tile"]) < 12
            or len(d80["hopper"]) < 14 or len(d80["resident"]) < 8
            or len(fwd_ptxas) < 14 or len(bwd_ptxas) < 30 or spilling):
        raise AssertionError(f"K3 GEMM body: {len(gemm_ptxas)} ptxas lines, "
                             f"f32 K3 GEMM body: {k3_f32}, "
                             f"d = 80 bodies: "
                             f"{ {k: len(v) for k, v in d80.items()} }, "
                             f"Hopper forward: {len(fwd_ptxas)}, backward: "
                             f"{len(bwd_ptxas)}, spilling: {spilling}")
    # the f32 streaming backward (csrc/attention_bwd_f32.cuh): the dq kernel
    # at d 64 and 80 with 64- and 48-key tiles, the dk/dv kernel at d 64 and
    # 80, each in both families, none spilling
    f32_bwd_ptxas = [line for line in ptxas
                     if line.startswith("attn_bwd_f32_")
                     and not line.startswith(F32_WINDOW_KERNEL)
                     and not line.startswith(F32_D128_KERNELS)]
    emit("ptxas_f32_backward", lines=f32_bwd_ptxas)
    if (len(f32_bwd_ptxas) != 12
            or any(", 0 B spilled" not in line for line in f32_bwd_ptxas)):
        raise AssertionError(f"f32 backward body: {f32_bwd_ptxas}")
    # the f32 windows' backward (csrc/attention_bwd_f32_window.cuh): d 64
    # and 80, 5 warps of 8 rows a thread and 7 warps of 7 or 8, each in both
    # families, none spilling
    f32_win_ptxas = [line for line in ptxas
                     if line.startswith(F32_WINDOW_KERNEL)]
    emit("ptxas_f32_window_backward", lines=f32_win_ptxas)
    if (len(f32_win_ptxas) != 12
            or any(", 0 B spilled" not in line for line in f32_win_ptxas)):
        raise AssertionError(f"f32 window backward body: {f32_win_ptxas}")
    # the f32 windows' forward (csrc/attention_fwd_f32_window.cuh): d 64 and
    # 80, two blocks of 3 warps a window-head, at d 64 two of 4 warps of 7 or
    # 8 rows a thread, at d 80 one of 7, each in both families, none spilling
    f32_win_fwd_ptxas = [line for line in ptxas
                         if line.startswith(F32_WINDOW_FORWARD_KERNEL)]
    emit("ptxas_f32_window_forward", lines=f32_win_fwd_ptxas)
    if (len(f32_win_fwd_ptxas) != 12
            or any(", 0 B spilled" not in line for line in f32_win_fwd_ptxas)):
        raise AssertionError(f"f32 window forward body: {f32_win_fwd_ptxas}")
    # K4's f32 body at d 128: the forward, and the backward's delta, dk/dv
    # and dq kernels, none spilling
    f32_d128_ptxas = [line for line in ptxas
                      if line.startswith(F32_D128_KERNELS)]
    emit("ptxas_f32_d128", lines=f32_d128_ptxas)
    if (len(f32_d128_ptxas) != len(F32_D128_KERNELS)
            or any(", 0 B spilled" not in line for line in f32_d128_ptxas)):
        raise AssertionError(f"K4's f32 body: {f32_d128_ptxas}")
    # the f32 forward of K2 and K5 (csrc/attention_fwd_f32.cuh): d 64 and
    # 80, packed and grouped, none spilling
    f32_fwd_ptxas = [line for line in ptxas
                     if line.startswith("attn_fwd_f32_kernel<")
                     and not line.startswith(F32_D128_KERNELS)]
    emit("ptxas_f32_forward", lines=f32_fwd_ptxas)
    if (len(f32_fwd_ptxas) != 4
            or any(", 0 B spilled" not in line for line in f32_fwd_ptxas)):
        raise AssertionError(f"f32 forward of K2 / K5: {f32_fwd_ptxas}")
    # ptxas says only in an info line (C7515) that it serialized every wgmma
    # of a kernel, which undoes what the Hopper bodies stand on
    serialized = serialized_wgmma(build_log)
    emit("ptxas_serialized_wgmma", lines=serialized)
    if serialized:
        raise AssertionError("ptxas serialized the wgmma products: "
                             + " | ".join(serialized))

    kernels = {
        "windowed_attention_packed": dict(
            wrapper=windowed_attention_packed,
            plain=windowed_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention_resident.cu",
            replaces="wildlifemapper_tpu/ops/windowed_attention_v2.py:200"),
        "flash_attention_packed": dict(
            wrapper=flash_attention_packed,
            plain=flash_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/flash_attention_v2.py:183"),
        "fused_mlp": dict(
            wrapper=fused_mlp, plain=fused_mlp_plain,
            source="wildlifemapper_tpu_torch/csrc/mlp_gemm_sm90.cu",
            replaces="wildlifemapper_tpu/ops/fused_mlp.py:97"),
        "cross_attention_packed": dict(
            wrapper=cross_attention_packed,
            plain=cross_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/cross_attention.py:150"),
        "flash_attention_rel_pos": dict(
            wrapper=flash_attention_rel_pos, plain=grouped_attention_plain,
            source="wildlifemapper_tpu_torch/csrc/grouped_attention.cu",
            replaces="wildlifemapper_tpu/ops/flash_attention.py:207"),
        "windowed_attention_rel_pos": dict(
            wrapper=windowed_attention_rel_pos, plain=grouped_attention_plain,
            source="wildlifemapper_tpu_torch/csrc/"
                   "grouped_attention_resident.cu",
            replaces="wildlifemapper_tpu/ops/windowed_attention.py:111"),
    }

    # ---- 2. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(0)

    def randn(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(size=shape, dtype=np.float32) * scale)
        ).to(dev)

    def attn_args(bw, hw, heads=12, d=64):
        n = hw[0] * hw[1]
        return [randn((bw, n, 3 * heads * d)),
                randn((bw, n, heads, hw[0]), 0.5),
                randn((bw, n, heads, hw[1]), 0.5), d ** -0.5, heads, hw]

    def grouped_args(bh, hw, d=64):
        """q, k, v (BH, N, d) per head and the (BH, N, g) tables, as the
        grouped layout hands them to K5 and K6."""
        n = hw[0] * hw[1]
        return [randn((bh, n, d)), randn((bh, n, d)), randn((bh, n, d)),
                randn((bh, n, hw[0]), 0.5), randn((bh, n, hw[1]), 0.5),
                d ** -0.5, hw]

    def mlp_args(r, d=768, f=3072):
        return [randn((r, d)), randn((f, d), d ** -0.5), randn((f,), 0.1),
                randn((d, f), f ** -0.5), randn((d,), 0.1)]

    # the large encoders' training shapes at batch 4 (phase 14): ViT-L's 16
    # heads of 64 on the full canvas and on the 48-grid, ViT-H's from-scratch
    # windows of 144 and 48-grid at head dim 80 (both layouts), K3 at
    # ViT-L's and ViT-H's widths at R 9216
    large_cases = [
        ("windowed_attention_packed", "BW=4*25 H=16 N=196 (ViT-L)",
         lambda: attn_args(100, (14, 14), heads=16)),
        ("windowed_attention_packed", "BW=4*16 H=16 N=144 (ViT-L scratch)",
         lambda: attn_args(64, (12, 12), heads=16)),
        ("windowed_attention_packed",
         "BW=4*16 H=16 N=144 d=80 (ViT-H scratch)",
         lambda: attn_args(64, (12, 12), heads=16, d=80)),
        ("flash_attention_packed", "B=4 H=16 N=4096 (ViT-L)",
         lambda: attn_args(4, (64, 64), heads=16)),
        ("flash_attention_packed", "B=4 H=16 N=2304 (ViT-L scratch)",
         lambda: attn_args(4, (48, 48), heads=16)),
        ("flash_attention_packed", "B=4 H=16 N=2304 d=80 (ViT-H scratch)",
         lambda: attn_args(4, (48, 48), heads=16, d=80)),
        ("windowed_attention_rel_pos",
         "BWH=4*16*16 N=144 d=80 (ViT-H scratch)",
         lambda: grouped_args(4 * 16 * 16, (12, 12), d=80)),
        ("flash_attention_rel_pos", "BH=4*16 N=2304 (ViT-L scratch)",
         lambda: grouped_args(4 * 16, (48, 48))),
        ("flash_attention_rel_pos", "BH=4*16 N=2304 d=80 (ViT-H scratch)",
         lambda: grouped_args(4 * 16, (48, 48), d=80)),
        ("fused_mlp", "R=4*2304 D=1024 F=4096 (ViT-L scratch)",
         lambda: mlp_args(4 * 2304, 1024, 4096)),
        ("fused_mlp", "R=4*2304 D=1280 F=5120 (ViT-H scratch)",
         lambda: mlp_args(4 * 2304, 1280, 5120)),
    ]
    # a rank's shapes at a model axis of 2 (phase 15): half of every block's
    # heads and of its MLP's hidden width, half of the adaptor's heads
    tp_cases = [
        ("windowed_attention_packed", "BW=4*16 H=8 N=144 d=80 (TP rank ViT-H)",
         lambda: attn_args(64, (12, 12), heads=8, d=80)),
        ("windowed_attention_packed", "BW=4*25 H=6 N=196 (TP rank ViT-B)",
         lambda: attn_args(100, (14, 14), heads=6)),
        ("flash_attention_packed", "B=4 H=8 N=2304 d=80 (TP rank ViT-H)",
         lambda: attn_args(4, (48, 48), heads=8, d=80)),
        ("flash_attention_packed", "B=4 H=6 N=4096 (TP rank ViT-B)",
         lambda: attn_args(4, (64, 64), heads=6)),
        ("fused_mlp", "R=4*2304 D=1280 F=2560 (TP rank ViT-H)",
         lambda: mlp_args(4 * 2304, 1280, 2560)),
        ("fused_mlp", "R=4*4096 D=768 F=1536 (TP rank ViT-B)",
         lambda: mlp_args(4 * 4096, 768, 1536)),
        ("cross_attention_packed", "B=4 H=4 N=M=2304 (TP rank)",
         lambda: [randn((4, 2304, c // 2)), randn((4, 2304, c // 2)),
                  randn((4, 2304, c // 2)), hd ** -0.5, c // hd // 2]),
        ("cross_attention_packed", "B=4 H=4 N=M=4096 (TP rank)",
         lambda: [randn((4, 4096, c // 2)), randn((4, 4096, c // 2)),
                  randn((4, 4096, c // 2)), hd ** -0.5, c // hd // 2]),
        ("flash_attention_rel_pos", "BH=4*6 N=4096 (TP rank ViT-B)",
         lambda: grouped_args(4 * 6, (64, 64))),
        ("windowed_attention_rel_pos", "BWH=4*25*6 N=196 (TP rank ViT-B)",
         lambda: grouped_args(4 * 25 * 6, (14, 14))),
    ]

    def dtypes(shape):
        """f32 and bf16; the large encoders' training shapes bf16 alone,
        the dtype phase 14 trains in (14c holds their f32 path end to end
        through the kernels)."""
        # f32 too at a rank's K4 and its K2 / K5 of ViT-B (the f32 bodies)
        f32_rank = shape.startswith(("B=4 H=4 N=M", "B=4 H=6 N=4096",
                                     "BH=4*6 N=4096"))
        if ("(ViT-L" in shape or "scratch)" in shape
                or ("(TP rank" in shape and not f32_rank)):
            return (torch.bfloat16,)
        return (torch.float32, torch.bfloat16)

    def launcher_args(name, args):
        """An attention wrapper's arguments as the launcher takes them: q, k,
        v, scale, heads, the tables (the grouped family's as (BH, N, 1, g))
        and where the scale enters; None for K3."""
        if name in ("flash_attention_packed", "windowed_attention_packed"):
            qkv, rh, rw, scale, heads, _ = args
            q, k, v = qkv.chunk(3, dim=-1)
            return (q, k, v, scale, heads, rh, rw), {}
        if name == "cross_attention_packed":
            q, k, v, scale, heads = args
            return (q, k, v, scale, heads, None, None), {}
        if name in ("flash_attention_rel_pos", "windowed_attention_rel_pos"):
            q, k, v, rh, rw, scale, _ = args
            return ((q, k, v, scale, 1, rh[:, :, None], rw[:, :, None]),
                    dict(scale_scores=True))
        return None

    def forward_repeat(name, shape, args, la=None):
        """The Hopper, the resident or the f32 forward twice on the same
        operands (a wrapper's `args`, or the launcher's `la`), with the lse:
        every output element has one owner and a fixed order of sums, so O
        and the lse are bit-identical."""
        la = la or launcher_args(name, args)
        if la is None:
            return
        (q, k, v, scale, heads, rh, rw), kw = la
        body = attention_body(q.dtype, q.shape[-1] // heads, q.shape[1],
                              k.shape[1], rh is not None,
                              None if rh is None else (rh.shape[-1],
                                                       rw.shape[-1]))
        if body == "mma":
            return
        first = attention_launch(*la[0], return_lse=True, **kw)
        second = attention_launch(*la[0], return_lse=True, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        emit("forward_repeat", kernel=name, shape=shape, body=body,
             bit_identical=same, outputs=["out", "lse"])
        if not same:
            raise AssertionError(f"{name} {shape}: two forward runs differ")
        if body in ("f32", "f32_window"):
            f32_forward_check(name, shape, la, first, body)

    def f32_launcher_case(fam, batch, heads, n, m, d, hw, scale):
        """One F32_FORWARD_LAUNCHER case of the f32 forward at the launcher,
        in the packed family or (its heads as batches) the grouped one."""
        grouped = fam == "flash_attention_rel_pos"
        if grouped:
            batch, heads = batch * heads, 1
        width = heads * d
        q = randn((batch, n, width))
        k, v = randn((batch, m, width)), randn((batch, m, width))
        rh = rw = None
        if hw:
            rh = randn((batch, n, heads, hw[0]), 0.5)
            rw = randn((batch, n, heads, hw[1]), 0.5)
        shape = (f"B={batch} H={heads} N={n} M={m} d={d}"
                 + (f" ({hw[0]}x{hw[1]})" if hw else " no tables"))
        if attention_body(torch.float32, d, n, m, hw is not None,
                          hw) != "f32":
            raise AssertionError(f"{fam} {shape}: not the f32 body")
        forward_repeat(fam, shape, None, la=(
            (q, k, v, scale or d ** -0.5, heads, rh, rw),
            dict(scale_scores=grouped)))

    def f32_window_launcher_case(fam, bw, heads, hw, d, scale):
        """One F32_WINDOW_LAUNCHER case of the f32 window forward at the
        launcher: the packed family's q, k, v as column blocks of one qkv,
        or (its heads as window-heads) the grouped family's."""
        grouped = fam == "windowed_attention_rel_pos"
        if grouped:
            bw, heads = bw * heads, 1
        n, width = hw[0] * hw[1], heads * d
        q, k, v = randn((bw, n, 3 * width)).split(width, -1)
        rh = randn((bw, n, heads, hw[0]), 0.5)
        rw = randn((bw, n, heads, hw[1]), 0.5)
        shape = f"BW={bw} H={heads} N={n} ({hw[0]}x{hw[1]}) d={d}"
        if attention_body(torch.float32, d, n, n, True, hw) != "f32_window":
            raise AssertionError(f"{fam} {shape}: not the f32 window body")
        forward_repeat(fam, shape, None, la=(
            (q, k, v, scale or d ** -0.5, heads, rh, rw),
            dict(scale_scores=grouped)))

    def f32_forward_check(name, shape, la, got, body):
        """An f32 body's forward, O and the lse, against the plain version
        at 2e-5 / 1e-4; its error goes into the kernels line (`name`_f32)."""
        (q, k, v, scale, heads, rh, rw), kw = la
        want = attention_plain(q, k, v, scale, heads, rh, rw,
                               return_lse=True, **kw)
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        ok = all(bool(torch.allclose(g, w, atol=2e-5, rtol=1e-4))
                 and bool(torch.isfinite(g).all()) for g, w in zip(got, want))
        emit("f32_forward_check", kernel=name, shape=shape, body=body,
             max_abs_err=errs[0], lse_max_abs_err=errs[1], atol=2e-5,
             rtol=1e-4)
        if not ok:
            raise AssertionError(f"{name} {shape}: the f32 forward disagrees "
                                 f"with its plain version ({errs})")
        errors[name + "_f32"] = max(errors.get(name + "_f32", 0.0), errs[0])

    c, hd = 1024, 128
    cases = [
        ("windowed_attention_packed", "BW=4*25 N=196",
         lambda: attn_args(4 * 25, (14, 14))),
        ("windowed_attention_packed", "BW=4*16 N=144",
         lambda: attn_args(4 * 16, (12, 12))),
        ("flash_attention_packed", "B=4 N=4096", lambda: attn_args(4, (64, 64))),
        ("flash_attention_packed", "B=4 N=2304", lambda: attn_args(4, (48, 48))),
        ("fused_mlp", "R=4*4096", lambda: mlp_args(4 * 4096)),
        ("fused_mlp", "R=4*2304", lambda: mlp_args(4 * 2304)),
        ("cross_attention_packed", "B=4 N=M=4096",
         lambda: [randn((4, 4096, c)), randn((4, 4096, c)),
                  randn((4, 4096, c)), hd ** -0.5, c // hd]),
        ("cross_attention_packed", "B=4 N=M=2304",
         lambda: [randn((4, 2304, c)), randn((4, 2304, c)),
                  randn((4, 2304, c)), hd ** -0.5, c // hd]),
        ("windowed_attention_rel_pos", "BWH=4*25*12 N=196",
         lambda: grouped_args(4 * 25 * 12, (14, 14))),
        ("windowed_attention_rel_pos", "BWH=4*16*12 N=144",
         lambda: grouped_args(4 * 16 * 12, (12, 12))),
        ("flash_attention_rel_pos", "BH=4*12 N=4096",
         lambda: grouped_args(4 * 12, (64, 64))),
        ("flash_attention_rel_pos", "BH=4*12 N=2304",
         lambda: grouped_args(4 * 12, (48, 48))),
        # d = 128 and 32: scaling the f32 scores and scaling q before the
        # product round differently in bf16 (they agree at d = 64)
        ("flash_attention_rel_pos", "BH=8 N=2304 d=128",
         lambda: grouped_args(8, (48, 48), d=128)),
        ("windowed_attention_rel_pos", "BWH=96 N=196 d=32",
         lambda: grouped_args(96, (14, 14), d=32)),
        # ragged against the 128-row blocks and the 64- and 128-key tiles of
        # the Hopper bodies: grids that are no multiple of 8, N != M, a last
        # tile that is nearly empty, d = 128 with rel tables
        ("flash_attention_packed", "B=2 H=3 N=1000 (25x40)",
         lambda: attn_args(2, (25, 40), heads=3)),
        ("flash_attention_rel_pos", "BH=6 N=1000 (20x50)",
         lambda: grouped_args(6, (20, 50))),
        ("flash_attention_rel_pos", "BH=4 N=513 (27x19) d=128",
         lambda: grouped_args(4, (27, 19), d=128)),
        ("cross_attention_packed", "B=2 N=200 M=1000",
         lambda: [randn((2, 200, c)), randn((2, 1000, c)),
                  randn((2, 1000, c)), hd ** -0.5, c // hd]),
        ("cross_attention_packed", "B=1 N=300 M=1030",
         lambda: [randn((1, 300, c)), randn((1, 1030, c)),
                  randn((1, 1030, c)), hd ** -0.5, c // hd]),
        # ragged against the 16-row tiles of the resident bodies: odd table
        # widths, a window of 100, one window-head, 37 windows of 3 heads
        ("windowed_attention_packed", "BW=3 H=3 N=49 (7x7)",
         lambda: attn_args(3, (7, 7), heads=3)),
        ("windowed_attention_packed", "BW=37 H=3 N=100 (10x10)",
         lambda: attn_args(37, (10, 10), heads=3)),
        ("windowed_attention_packed", "BW=1 H=1 N=196",
         lambda: attn_args(1, (14, 14), heads=1)),
        ("windowed_attention_rel_pos", "BWH=7 N=49 (7x7)",
         lambda: grouped_args(7, (7, 7))),
        ("windowed_attention_rel_pos", "BWH=111 N=100 (10x10)",
         lambda: grouped_args(111, (10, 10))),
        ("windowed_attention_rel_pos", "BWH=1 N=144",
         lambda: grouped_args(1, (12, 12))),
        # ragged against the K3 GEMM bodies' 128-row tiles and 256- (bf16)
        # or 128-column (f32) tiles; ViT-L and ViT-H widths; a
        # tensor-parallel rank's F in both dtypes (F 2560 at ViT-H, 1536 at
        # ViT-B, neither a multiple of the f32 body's raster group)
        ("fused_mlp", "R=1000", lambda: mlp_args(1000)),
        ("fused_mlp", "R=129 D=1024 F=4096", lambda: mlp_args(129, 1024, 4096)),
        ("fused_mlp", "R=1 D=1280 F=5120", lambda: mlp_args(1, 1280, 5120)),
        ("fused_mlp", "R=1000 D=1280 F=5120",
         lambda: mlp_args(1000, 1280, 5120)),
        ("fused_mlp", "R=4096 D=1280 F=5120 (ViT-H at batch 1)",
         lambda: mlp_args(4096, 1280, 5120)),
        ("fused_mlp", "R=1000 D=1280 F=2560 (a rank's F)",
         lambda: mlp_args(1000, 1280, 2560)),
        ("fused_mlp", "R=1000 D=768 F=1536 (a rank's F)",
         lambda: mlp_args(1000, 768, 1536)),
        # head dim 80 (ViT-H: D 1280, 16 heads) at ViT-H's serving shapes
        # at batch 1: bf16 through the Hopper and the resident bodies, f32
        # through the tile bodies; then ragged against the Hopper body's
        # blocks and tiles (grids no multiple of 8) and the resident body's
        # 16-row tiles (odd table widths, a window of 100)
        ("windowed_attention_packed", "BW=25 H=16 N=196 d=80 (ViT-H)",
         lambda: attn_args(25, (14, 14), heads=16, d=80)),
        ("flash_attention_packed", "B=1 H=16 N=4096 d=80 (ViT-H)",
         lambda: attn_args(1, (64, 64), heads=16, d=80)),
        ("windowed_attention_rel_pos", "BWH=25*16 N=196 d=80",
         lambda: grouped_args(25 * 16, (14, 14), d=80)),
        ("flash_attention_rel_pos", "BH=16 N=4096 d=80",
         lambda: grouped_args(16, (64, 64), d=80)),
        ("flash_attention_packed", "B=2 H=3 N=1000 (25x40) d=80",
         lambda: attn_args(2, (25, 40), heads=3, d=80)),
        ("flash_attention_rel_pos", "BH=6 N=1000 (20x50) d=80",
         lambda: grouped_args(6, (20, 50), d=80)),
        ("windowed_attention_packed", "BW=3 H=3 N=49 (7x7) d=80",
         lambda: attn_args(3, (7, 7), heads=3, d=80)),
        ("windowed_attention_rel_pos", "BWH=10 N=100 (10x10) d=80",
         lambda: grouped_args(10, (10, 10), d=80)),
    ] + large_cases + tp_cases
    # fused_mlp keeps its biases in f32 whatever the compute dtype
    f32_positions = {"fused_mlp": (2, 4)}
    tol = {torch.float32: dict(atol=2e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    errors = {name: 0.0 for name in kernels}
    kernel_inputs = {}
    with torch.inference_mode():
        for name, shape, make in cases:
            base = make()
            for dt in dtypes(shape):
                keep32 = f32_positions.get(name, ())
                args = [a.to(dt) if torch.is_tensor(a) and i not in keep32
                        else a for i, a in enumerate(base)]
                got = kernels[name]["wrapper"](*args)
                torch.cuda.synchronize()
                ref = kernels[name]["plain"](*[
                    a.float() if torch.is_tensor(a) else a for a in args])
                err = (got.float() - ref).abs().max().item()
                bad = ~torch.isclose(got.float(), ref, **tol[dt])
                emit("kernel_check", kernel=name, shape=shape,
                     dtype=str(dt).replace("torch.", ""), max_abs_err=err,
                     atol=tol[dt]["atol"], rtol=tol[dt]["rtol"],
                     mismatched=int(bad.sum().item()))
                if bad.any() or not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {shape} {dt}: kernel "
                                         f"disagrees with its plain version "
                                         f"(max abs err {err})")
                errors[name] = max(errors[name], err)
                if dt == torch.float32 and name in ("fused_mlp",
                                                    "cross_attention_packed"):
                    errors[name + "_f32"] = max(
                        errors.get(name + "_f32", 0.0), err)
                if name == "fused_mlp":
                    # both GEMM bodies: one owner and one order of sums for
                    # every element, so a second call is bit-identical
                    same = torch.equal(got, kernels[name]["wrapper"](*args))
                    emit("forward_repeat", kernel=name, shape=shape,
                         dtype=str(dt).replace("torch.", ""),
                         bit_identical=same, outputs=["out"])
                    if not same:
                        raise AssertionError(f"{name} {shape} {dt}: two "
                                             f"forward runs differ")
                else:
                    forward_repeat(name, shape, args)
                if dt == torch.bfloat16 and name not in kernel_inputs:
                    kernel_inputs[name] = (shape, args)
            del base, args, got, ref
            torch.cuda.empty_cache()
        # the f32 forward of K2 / K5 at the launcher where the wrappers do
        # not reach: N != M without tables (a last key tile of 60), every
        # grid width the f32 backward takes (16, 24, 32, 48, 64) and an 8 x
        # 65 grid (the last tile 8 keys), d 64 and 80, both families, a
        # scale that is no power of two
        for case in F32_FORWARD_LAUNCHER:
            for fam in ("flash_attention_packed", "flash_attention_rel_pos"):
                f32_launcher_case(fam, *case)
        # the f32 forward of K1 / K6 on the f32 window body at the launcher:
        # the card tests' windows, ragged against its 32-key slabs, its warps
        # of 28 and 32 rows and its two blocks a window-head, d 64 and 80,
        # both families, scales that are no power of two
        for case in F32_WINDOW_LAUNCHER:
            for fam in ("windowed_attention_packed",
                        "windowed_attention_rel_pos"):
                f32_window_launcher_case(fam, *case)
        torch.cuda.empty_cache()

    count_names = COUNT_NAMES

    def counts(attr="launches"):
        return {n: getattr(k["wrapper"], attr) for n, k in kernels.items()
                if hasattr(k["wrapper"], attr)}

    def reset_counts():
        for k in kernels.values():
            for attr in count_names:
                if hasattr(k["wrapper"], attr):
                    setattr(k["wrapper"], attr, 0)
        fused_mlp.kernel_launches = 0

    def check_mlp_kernels(what, per_call):
        """K3's kernel launches of a run: per_call for each wrapper call
        (the GEMM body's two passes in bf16 and in f32)."""
        got, calls = fused_mlp.kernel_launches, fused_mlp.launches
        emit("mlp_kernel_launches", path=what, wrapper_calls=calls,
             kernel_launches=got, want=per_call * calls)
        if got != per_call * calls:
            raise AssertionError(f"{what}: {got} K3 kernel launches for "
                                 f"{calls} calls, want {per_call} a call")

    # launches of one forward: the packed layout (K1, K2, K3, K4) and the
    # grouped one (K6, K5, K4; its MLP is the plain one)
    per_forward = {
        "packed": {"windowed_attention_packed": 8,
                   "flash_attention_packed": 4, "fused_mlp": 12,
                   "cross_attention_packed": 1, "flash_attention_rel_pos": 0,
                   "windowed_attention_rel_pos": 0},
        "grouped": {"windowed_attention_packed": 0,
                    "flash_attention_packed": 0, "fused_mlp": 0,
                    "cross_attention_packed": 1, "flash_attention_rel_pos": 4,
                    "windowed_attention_rel_pos": 8}}

    def check_launches(what, got, want):
        """The counts of one run of a path: exactly `want`, and every kernel
        of the path launched."""
        emit("path_launches", path=what, launches=got, want=want)
        if got != want or not any(want.values()):
            raise AssertionError(f"{what}: launches {got}, want {want}")

    # the f32 K3 GEMM body's wrapper calls on the f32 paths, each read just
    # after a run that started from counts of 0: phase 3's forwards, phase
    # 4b's f32 forwards, and the f32 steps of phases 7 and 14c
    f32_k3 = {"forward": 0, "dh": 0}
    # the f32 streaming backward's launches (its dq and its dk/dv kernel, one
    # of each a backward) on the same paths' f32 steps (phases 7 and 14c):
    # every global block's backward there takes the f32 body
    f32_bwd = {"flash_attention_packed": 0, "flash_attention_rel_pos": 0}
    # the f32 window body's launches (one a backward) on the same steps:
    # every window's backward there takes it
    f32_win = {"windowed_attention_packed": 0,
               "windowed_attention_rel_pos": 0}
    # K4's f32 body (d 128): its forward launches on the same paths, and its
    # backward's two counters as read on the f32 steps (a backward calls the
    # dk/dv entry, which launches the delta kernel and then the dk/dv
    # kernel, and then the dq entry)
    f32_k4 = {"forward": 0, "backward_dq": 0, "backward_dkv": 0}
    # the f32 forward of K2 and K5 (d 64 / 80) and that of K1 and K6 (the f32
    # window forward): their wrappers' forward launches on the same paths,
    # whose global blocks and windows all take them
    f32_fwd = {"flash_attention_packed": 0, "flash_attention_rel_pos": 0,
               "windowed_attention_packed": 0,
               "windowed_attention_rel_pos": 0}

    # ---- 3. end to end against the PyTorch reference -----------------------
    npz = np.load(Path(__file__).resolve().parent / "tests" / "goldens"
                  / "full_model.npz")
    golden_sd = meta_to_state_dict(npz["meta"])
    x = torch.from_numpy(padded_canvas(seed=107)).to(dev)
    for layout in ("packed", "grouped"):
        model = WildlifeMapper(model_config(
            "vit_b", use_flash_attention=True, attn_impl=layout))
        load_reference_state_dict(model, golden_sd)
        model.eval()
        reset_counts()
        with torch.inference_mode():
            out = model(x)
            torch.cuda.synchronize()
        e2e_counts = counts()
        d_logits = float(np.abs(out["pred_logits"].cpu().numpy()
                                - npz["logits"]).max())
        d_boxes = float(np.abs(out["pred_boxes"].cpu().numpy()
                               - npz["boxes"]).max())
        emit("end_to_end", config=f"vit_b f32 full canvas, {layout} kernels",
             max_abs_diff_logits=d_logits, max_abs_diff_boxes=d_boxes,
             atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(out["pred_logits"].cpu().numpy(),
                                   npz["logits"], atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(out["pred_boxes"].cpu().numpy(),
                                   npz["boxes"], atol=1e-4, rtol=1e-3)
        check_launches(f"one f32 forward, {layout}", e2e_counts,
                       per_forward[layout])
        check_mlp_kernels(f"one f32 forward, {layout}", 2)
        f32_k3["forward"] += e2e_counts["fused_mlp"]
        f32_k4["forward"] += e2e_counts["cross_attention_packed"]
        for wname in f32_fwd:
            f32_fwd[wname] += e2e_counts[wname]
        del model, out
        torch.cuda.empty_cache()

    # ---- 4. serving in bf16: the main path ---------------------------------
    base_cfg = model_config("vit_b", dtype="bfloat16",
                            use_flash_attention=True)
    scratch = dataclasses.replace(
        base_cfg, content_size=768, crop_prologue=True,
        vit=dataclasses.replace(base_cfg.vit, window_size=12),
        hfc=dataclasses.replace(base_cfg.hfc, compat_scrambled_reshape=False))
    configs = {
        "full_canvas": base_cfg,
        "compat_crop": dataclasses.replace(base_cfg, content_size=768),
        "from_scratch": scratch,
    }

    def make_batch(seed):
        xb = np.zeros((BATCH, 1024, 1024, 3), np.float32)
        xb[:, :768, :768, :] = np.random.default_rng(seed).standard_normal(
            size=(BATCH, 768, 768, 3), dtype=np.float32)
        return torch.from_numpy(xb).to(dev)

    batches = [make_batch(100 + i) for i in range(N_BATCHES)]
    sizes = torch.full((BATCH, 2), 1024, dtype=torch.int32, device=dev)

    def build(cfg):
        m = WildlifeMapper(cfg)
        load_reference_state_dict(m, golden_sd)
        return m.eval()

    def serve(m, images):
        out = m(images)
        dets = postprocess(out, sizes, confidence_threshold=0.05)
        dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                   dets["labels"], dets["keep"], 0.4,
                                   class_aware=False)
        return out, dets

    def serve_all(ms):
        """One run of a serving path: the counts set to 0 just before it and
        read just after."""
        reset_counts()
        outs = {}
        with torch.inference_mode():
            for name, m in ms.items():
                outs[name] = [serve(m, xb) for xb in batches]
                torch.cuda.synchronize()
        return outs, counts()

    # the grouped layout serves the two configurations whose shapes differ:
    # N = 196 / 4096 and N = 144 / 2304
    grouped_configs = {
        name: dataclasses.replace(configs[name], attn_impl="grouped")
        for name in ("full_canvas", "from_scratch")}
    models = {name: build(cfg) for name, cfg in configs.items()}
    grouped_models = {name: build(cfg)
                      for name, cfg in grouped_configs.items()}
    served, main_counts = serve_all(models)
    check_mlp_kernels("serving, packed", 2)
    serving_mlp_kernel_launches = fused_mlp.kernel_launches
    grouped_served, grouped_counts = serve_all(grouped_models)
    for name, outs in list(served.items()) + [
            (f"{n} grouped", o) for n, o in grouped_served.items()]:
        for out, dets in outs:
            pb, bx = out["pred_boxes"], dets["boxes"]
            ok = (torch.isfinite(out["pred_logits"]).all()
                  and torch.isfinite(bx).all()
                  and pb.min() >= 0 and pb.max() <= 1
                  and bx.min() >= -512 and bx.max() <= 1536)
            if not ok:
                raise AssertionError(f"{name}: non-finite or out-of-range "
                                     "detections")
        keep = sum(int(d["keep"].sum()) for _, d in outs)
        emit("serving", config=name, batch=BATCH, batches=len(outs),
             detections_kept=keep,
             pred_shape=list(outs[0][0]["pred_logits"].shape))
    check_launches("serving, packed", main_counts, {
        n: v * N_BATCHES * len(configs)
        for n, v in per_forward["packed"].items()})
    check_launches("serving, grouped", grouped_counts, {
        n: v * N_BATCHES * len(grouped_configs)
        for n, v in per_forward["grouped"].items()})

    def drift(out, ref):
        p_a = torch.softmax(out["pred_logits"].float(), -1)[..., :-1]
        p_b = torch.softmax(ref["pred_logits"].float(), -1)[..., :-1]
        return dict(
            max_class_prob_diff=(p_a - p_b).abs().max().item(),
            max_box_diff_px=((out["pred_boxes"].float()
                              - ref["pred_boxes"].float())
                             .abs().max().item() * 1024),
            label_agreement=(p_a.argmax(-1) == p_b.argmax(-1))
            .float().mean().item())

    # the two layouts are one function: same weights, same batch, bf16
    for name, outs in grouped_served.items():
        emit("grouped_against_packed", config=name, dtype="bfloat16",
             **drift(outs[0][0], served[name][0][0]))

    # bf16 with kernels against f32 on the plain path, same weights/input
    with torch.inference_mode():
        for name, cfg in configs.items():
            ref_m = build(dataclasses.replace(cfg, dtype="float32",
                                              use_flash_attention=False))
            ref = ref_m(batches[0])
            emit("bf16_drift", config=name,
                 **drift(served[name][0][0], ref))
            if name in grouped_served:
                emit("bf16_drift", config=f"{name} grouped",
                     **drift(grouped_served[name][0][0], ref))
            del ref_m, ref
            torch.cuda.empty_cache()

    import torch.nn.functional as F

    def heads_view(t, heads):
        b, n, cw = t.shape
        return t.view(b, n, heads, cw // heads).transpose(1, 2)

    def sdpa_pair(q, k, v, rh, rw, heads, scale):
        """(forward fn, backward fn) of one scaled_dot_product_attention
        call on the same inputs, the decomposed bias built beforehand and
        passed as attn_mask: the library's yardstick, used nowhere in the
        port. The backward is autograd through that call for dq, dk, dv."""
        qh, kh, vh = (heads_view(t, heads).detach().requires_grad_()
                      for t in (q, k, v))
        bias = None
        if rh is not None:
            b, n = q.shape[:2]
            bias = (rh.permute(0, 2, 1, 3)[..., :, None]
                    + rw.permute(0, 2, 1, 3)[..., None, :]
                    ).reshape(b, heads, n, -1).contiguous()

        def fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  scale=scale)

        out = fwd()
        dout = torch.randn_like(out)
        return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), dout,
                                                retain_graph=True)

    # ---- 4b. large models: ViT-L and ViT-H through the packed kernels ------
    # Seeded random weights (no checkpoint is at hand); the plain path gets
    # the same weights. ViT-H's head dim 80 runs the Hopper body in its
    # global blocks and the resident body in its windows, its D 1280 the K3
    # GEMM body.
    sizes1 = sizes[:1]

    def serve1(m, images):
        out = m(images)
        dets = postprocess(out, sizes1, confidence_threshold=0.05)
        dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                   dets["labels"], dets["keep"], 0.4,
                                   class_aware=False)
        return out, dets

    x1 = batches[0][:1]
    drift_b = None          # ViT-B's, in the same setting: the limits' scale
    for variant in ("vit_b", "vit_l", "vit_h"):
        cfg = model_config(variant, dtype="bfloat16", use_flash_attention=True)
        kern_m = WildlifeMapper(
            cfg, generator=torch.Generator(device=dev).manual_seed(0)).eval()
        plain_m = WildlifeMapper(dataclasses.replace(
            cfg, use_flash_attention=False)).eval()
        plain_m.load_state_dict(kern_m.state_dict())
        v = cfg.vit
        d = v.embed_dim // v.num_heads
        glob = len(v.global_attn_indexes)
        # the encoder's output (the image embedding) of each path
        emb = {}
        hooks = [m.image_encoder.register_forward_hook(
            lambda mod, args, out, key=key: emb.__setitem__(key, out.float()))
            for key, m in (("kernels", kern_m), ("plain", plain_m))]
        reset_counts()                 # the large model's run starts here
        with torch.inference_mode():
            out, dets = serve1(kern_m, x1)
            torch.cuda.synchronize()
        check_launches(f"{variant} bf16 serving, batch 1", counts(),
                       {"windowed_attention_packed": v.depth - glob,
                        "flash_attention_packed": glob,
                        "fused_mlp": v.depth, "cross_attention_packed": 1,
                        "flash_attention_rel_pos": 0,
                        "windowed_attention_rel_pos": 0})
        check_mlp_kernels(f"{variant} bf16 serving, batch 1", 2)
        n_win, n_glob = v.window_size ** 2, cfg.grid_size ** 2
        bodies = {
            "windowed": attention_body(torch.bfloat16, d, n_win, n_win, True,
                                       (v.window_size, v.window_size)),
            "global": attention_body(torch.bfloat16, d, n_glob, n_glob, True,
                                     (cfg.grid_size, cfg.grid_size))}
        if bodies != {"windowed": "resident", "global": "sm90"}:
            raise AssertionError(f"{variant}: bf16 forward bodies {bodies}")
        with torch.inference_mode():
            ref, _ = serve1(plain_m, x1)
            for h in hooks:
                h.remove()
            ms_plain, ms_kern = paired_ms(lambda: serve1(plain_m, x1),
                                          lambda: serve1(kern_m, x1), iters=3)
        pb, bx = out["pred_boxes"], dets["boxes"]
        if not (torch.isfinite(out["pred_logits"]).all()
                and torch.isfinite(bx).all() and pb.min() >= 0
                and pb.max() <= 1):
            raise AssertionError(f"{variant}: non-finite or out-of-range "
                                 "detections")
        got = dict(drift(out, ref), embedding_rel_err=(
            (emb["kernels"] - emb["plain"]).norm()
            / emb["plain"].norm()).item())
        # ViT-B sets the scale: the same bf16 rounding through 24 / 32
        # blocks in place of 12 grows the embedding's error by sqrt(depth)
        # to depth times (1.4-2.7x), so 4x; a box may move by two bf16
        # steps of a coordinate (4 px each at 1024 px); the labels may flip
        # on 5 % more of the queries (near ties of random weights)
        limits = None if drift_b is None else dict(
            embedding_rel_err=4 * drift_b["embedding_rel_err"],
            max_class_prob_diff=4 * drift_b["max_class_prob_diff"],
            max_box_diff_px=max(2 * drift_b["max_box_diff_px"], 8.0),
            min_label_agreement=drift_b["label_agreement"] - 0.05)
        emit("large_model", config=f"{variant} bf16 full canvas", batch=1,
             head_dim=d, embed_dim=v.embed_dim, depth=v.depth,
             attention_bodies=bodies, detections_kept=int(dets["keep"].sum()),
             kernels_against_plain=got, limits_from_vit_b=limits, gpu=gpu,
             ms_per_tile_kernels=ms_kern, ms_per_tile_plain=ms_plain)
        if limits is None:
            drift_b = got
        elif not (got["embedding_rel_err"] <= limits["embedding_rel_err"]
                  and got["max_class_prob_diff"]
                  <= limits["max_class_prob_diff"]
                  and got["max_box_diff_px"] <= limits["max_box_diff_px"]
                  and got["label_agreement"]
                  >= limits["min_label_agreement"]):
            raise AssertionError(f"{variant}: kernels drift from the plain "
                                 f"path {got} beyond {limits}")
        del kern_m, plain_m, out, ref, dets, emb
        torch.cuda.empty_cache()

    # f32 through the packed kernels (K3's f32 GEMM body, at D 1280 for
    # ViT-H, and the f32 attention bodies) against the plain path with the same
    # seeded weights, at the full model's tolerance of record; ViT-B's error
    # from the same check beside ViT-H's
    f32_err = {}
    for variant in ("vit_b", "vit_h"):
        cfg = model_config(variant, dtype="float32", use_flash_attention=True)
        kern_m = WildlifeMapper(
            cfg, generator=torch.Generator(device=dev).manual_seed(0)).eval()
        plain_m = WildlifeMapper(dataclasses.replace(
            cfg, use_flash_attention=False)).eval()
        plain_m.load_state_dict(kern_m.state_dict())
        v = cfg.vit
        glob = len(v.global_attn_indexes)
        reset_counts()
        with torch.inference_mode():
            out = kern_m(x1)
            torch.cuda.synchronize()
        check_launches(f"{variant} f32 forward, batch 1", counts(),
                       {"windowed_attention_packed": v.depth - glob,
                        "flash_attention_packed": glob,
                        "fused_mlp": v.depth, "cross_attention_packed": 1,
                        "flash_attention_rel_pos": 0,
                        "windowed_attention_rel_pos": 0})
        check_mlp_kernels(f"{variant} f32 forward, batch 1", 2)
        f32_k3["forward"] += fused_mlp.launches
        f32_k4["forward"] += cross_attention_packed.launches
        f32_fwd["flash_attention_packed"] += flash_attention_packed.launches
        f32_fwd["windowed_attention_packed"] += (
            windowed_attention_packed.launches)
        with torch.inference_mode():
            ref = plain_m(x1)
        keys = ("pred_logits", "pred_boxes")
        f32_err[variant] = dict(
            {f"max_abs_diff_{k[5:]}": (out[k] - ref[k]).abs().max().item()
             for k in keys},
            within=all(bool(torch.allclose(out[k], ref[k], atol=1e-4,
                                           rtol=1e-3)) for k in keys))
        emit("large_model_f32", config=f"{variant} f32 full canvas", batch=1,
             embed_dim=v.embed_dim, depth=v.depth, atol=1e-4, rtol=1e-3,
             kernels_against_plain=f32_err[variant],
             vit_b_same_check=f32_err["vit_b"])
        del kern_m, plain_m, out, ref
        torch.cuda.empty_cache()
    if not all(e["within"] for e in f32_err.values()):
        raise AssertionError(f"f32 forward with kernels against the plain "
                             f"path beyond atol 1e-4 / rtol 1e-3: {f32_err}")

    # ---- 5. times ------------------------------------------------------------
    del served, grouped_served
    with torch.inference_mode():
        for name, cfg in configs.items():
            plain_m = build(dataclasses.replace(cfg,
                                                use_flash_attention=False))
            kern_m = models[name]
            ms_plain, ms_kern = paired_ms(
                lambda: serve(plain_m, batches[0]),
                lambda: serve(kern_m, batches[0]), iters=3)
            emit("serving_time", config=name, dtype="bfloat16", batch=BATCH,
                 gpu=gpu, ms_per_batch_kernels=ms_kern,
                 ms_per_batch_plain=ms_plain,
                 tiles_per_s_kernels=BATCH * 1000 / ms_kern,
                 tiles_per_s_plain=BATCH * 1000 / ms_plain)
            del plain_m
            torch.cuda.empty_cache()
        for name, grouped_m in grouped_models.items():
            kern_m = models[name]
            ms_packed, ms_grouped = paired_ms(
                lambda: serve(kern_m, batches[0]),
                lambda: serve(grouped_m, batches[0]), iters=3)
            emit("serving_time", config=f"{name} grouped", dtype="bfloat16",
                 batch=BATCH, gpu=gpu, ms_per_batch_grouped=ms_grouped,
                 ms_per_batch_packed=ms_packed,
                 tiles_per_s_grouped=BATCH * 1000 / ms_grouped,
                 tiles_per_s_packed=BATCH * 1000 / ms_packed)

        kernel_ms = {}
        for name, (shape, args) in kernel_inputs.items():
            k = kernels[name]
            ms_plain, ms_kern = paired_ms(lambda: k["plain"](*args),
                                          lambda: k["wrapper"](*args))
            kernel_ms[name] = (ms_kern, ms_plain)
            emit("kernel_time", kernel=name, shape=shape, dtype="bfloat16",
                 gpu=gpu, ms=ms_kern, plain_ms=ms_plain)
    serving_counts = {n: main_counts[n] + grouped_counts[n]
                      for n in main_counts}
    del models, grouped_models
    torch.cuda.empty_cache()

    # ---- 6. backward kernels against their plain versions -------------------
    # name -> entry of the final "kernels" line
    report = {}

    def entry(name, source, replaces, **fields):
        report[name] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, **fields)

    attn_cu = "wildlifemapper_tpu_torch/csrc/attention.cu"
    bwd_cu = "wildlifemapper_tpu_torch/csrc/attention_bwd.cu"
    mlp_cu = "wildlifemapper_tpu_torch/csrc/mlp_gemm_sm90.cu"
    jax_ops = "wildlifemapper_tpu/ops/"

    def grads_close(what, got, ref, dt, names):
        """f32: atol 5e-4 / rtol 1e-3; bf16: 2e-2 of the largest element."""
        worst = 0.0
        for nm, g, r in zip(names, got, ref):
            g, r = g.float(), r.float()
            err = (g - r).abs().max().item()
            worst = max(worst, err)
            if dt == torch.float32:
                ok = bool(torch.isclose(g, r, atol=5e-4, rtol=1e-3).all())
                bound = "atol 5e-4 rtol 1e-3"
            else:
                lim = 2e-2 * max(r.abs().max().item(), 1e-6)
                ok, bound = err <= lim, f"{lim:.3e}"
            emit("backward_check", kernel=what, output=nm,
                 dtype=str(dt).replace("torch.", ""), max_abs_err=err,
                 bound=bound)
            if not ok or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{what} {nm} {dt}: backward kernel "
                                     f"disagrees with its plain version "
                                     f"(max abs err {err}, bound {bound})")
        return worst

    def leaves(tensors, dt, frozen, keep32=()):
        """Fresh leaves in dtype dt; with `frozen` only the first (the
        activations) requires a gradient, as under a frozen encoder."""
        return [t.to(torch.float32 if i in keep32 else dt).detach()
                .requires_grad_(i == 0 or not frozen)
                for i, t in enumerate(tensors)]

    def through_wrapper(wrapper, tensors, rest, dout, counters):
        """Gradients of the public wrapper on the card by autograd, for the
        inputs that require one; each of `counters` must go up by one and
        the wrapper's other counters not at all."""
        own = [c for c in count_names if hasattr(wrapper, c)]
        before = [getattr(wrapper, c) for c in own]
        out = wrapper(*tensors, *rest)
        got = torch.autograd.grad(
            out, [t for t in tensors if t.requires_grad], dout)
        torch.cuda.synchronize()
        after = [getattr(wrapper, c) for c in own]
        if after != [n + (c in counters) for c, n in zip(own, before)]:
            raise AssertionError(f"{wrapper.__name__}: counters {own} went "
                                 f"{before} -> {after} in one backward, "
                                 f"want one more of each of {counters}")
        return got

    bwd_err = {}
    bwd_inputs = {}
    attn_counters = ("launches", "backward_dq_launches",
                     "backward_dkv_launches")

    def backward_counters(dt, d, n, m, hw):
        """The counters one forward and backward of an attention wrapper
        move: the resident body's backward and the f32 window body's are one
        kernel, the others' two."""
        if attention_body(dt, d, n, m, hw is not None, hw,
                          "backward") in ("resident", "f32_window"):
            return ("launches", "backward_launches")
        return attn_counters

    def repeat_check(kid, shape, launch, body):
        """The backward of the resident or the Hopper body twice on the same
        operands: every element of dq, dk, dv and the table gradients has
        one owner and a fixed order of sums, so bit-identical."""
        with torch.no_grad():
            first, second = launch(), launch()
            torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second)
                   if a is not None)
        emit("backward_repeat", kernel=kid, shape=shape, body=body,
             bit_identical=same,
             outputs=sum(a is not None for a in first))
        if not same:
            raise AssertionError(f"{kid} {shape}: two backward runs differ")

    def timing_key(kid, shape):
        """Which of phase 9's timings a shape feeds: the first shape of each
        kernel, and the second main-path shape of the windowed (N = 144)
        and the streaming kernels (N = 2304)."""
        if kid not in bwd_inputs:
            return kid
        for n in ("144", "2304"):
            key = f"{kid} N={n}"
            if (re.search(rf"\bN=(M=)?{n}\b", shape)
                    and not shape.startswith("BWH=1 ")
                    and key not in bwd_inputs):
                return key
        return None
    # (id, shape, heads, head dim, grid, inputs): K1 and K2 take the packed
    # qkv and the rel tables, K4 separate q, k, v as the adaptor's
    # projections give them
    attn_cases = [
        ("K1", "BW=4*25 N=196", 12, 64, (14, 14),
         lambda: attn_args(4 * 25, (14, 14))[:3]),
        ("K1", "BW=4*16 N=144", 12, 64, (12, 12),
         lambda: attn_args(4 * 16, (12, 12))[:3]),
        ("K2", "B=4 N=4096", 12, 64, (64, 64),
         lambda: attn_args(4, (64, 64))[:3]),
        ("K2", "B=4 N=2304", 12, 64, (48, 48),
         lambda: attn_args(4, (48, 48))[:3]),
        ("K4", "B=4 N=M=4096", 8, 128, None,
         lambda: [randn((4, 4096, c)) for _ in range(3)]),
        ("K4", "B=4 N=M=2304", 8, 128, None,
         lambda: [randn((4, 2304, c)) for _ in range(3)]),
        # ragged against the Hopper bodies' blocks and tiles
        ("K2", "B=2 H=3 N=1000 (25x40)", 3, 64, (25, 40),
         lambda: attn_args(2, (25, 40), heads=3)[:3]),
        ("K4", "B=2 N=200 M=1000", 8, 128, None,
         lambda: [randn((2, 200, c)), randn((2, 1000, c)),
                  randn((2, 1000, c))]),
        ("K4", "B=1 N=1030 M=577", 8, 128, None,
         lambda: [randn((1, 1030, c)), randn((1, 577, c)),
                  randn((1, 577, c))]),
        # ragged against the resident bodies' 16-row tiles
        ("K1", "BW=3 H=3 N=49 (7x7)", 3, 64, (7, 7),
         lambda: attn_args(3, (7, 7), heads=3)[:3]),
        ("K1", "BW=37 H=3 N=100 (10x10)", 3, 64, (10, 10),
         lambda: attn_args(37, (10, 10), heads=3)[:3]),
        ("K1", "BW=1 H=1 N=196", 1, 64, (14, 14),
         lambda: attn_args(1, (14, 14), heads=1)[:3]),
        # head dim 80 at ViT-H's shapes, batch 1: the resident body both
        # ways (K1), also on windows ragged against its 16-row tiles (odd
        # table widths, a window of 100), the Hopper bodies both ways (K2),
        # also on the 48-grid and ragged against their blocks and tiles
        ("K1", "BW=25 H=16 N=196 d=80 (ViT-H)", 16, 80, (14, 14),
         lambda: attn_args(25, (14, 14), heads=16, d=80)[:3]),
        ("K1", "BW=3 H=3 N=49 (7x7) d=80", 3, 80, (7, 7),
         lambda: attn_args(3, (7, 7), heads=3, d=80)[:3]),
        ("K1", "BW=10 H=2 N=100 (10x10) d=80", 2, 80, (10, 10),
         lambda: attn_args(10, (10, 10), heads=2, d=80)[:3]),
        ("K2", "B=1 H=16 N=4096 d=80 (ViT-H)", 16, 80, (64, 64),
         lambda: attn_args(1, (64, 64), heads=16, d=80)[:3]),
        ("K2", "B=1 H=16 N=2304 d=80 (48-grid)", 16, 80, (48, 48),
         lambda: attn_args(1, (48, 48), heads=16, d=80)[:3]),
        ("K2", "B=2 H=3 N=1000 d=80 (25x40)", 3, 80, (25, 40),
         lambda: attn_args(2, (25, 40), heads=3, d=80)[:3]),
        # the large encoders' training shapes at batch 4 (phase 14)
        ("K1", "BW=4*25 H=16 N=196 (ViT-L)", 16, 64, (14, 14),
         lambda: attn_args(100, (14, 14), heads=16)[:3]),
        ("K1", "BW=4*16 H=16 N=144 d=80 (ViT-H scratch)", 16, 80, (12, 12),
         lambda: attn_args(64, (12, 12), heads=16, d=80)[:3]),
        ("K2", "B=4 H=16 N=4096 (ViT-L)", 16, 64, (64, 64),
         lambda: attn_args(4, (64, 64), heads=16)[:3]),
        ("K2", "B=4 H=16 N=2304 (ViT-L scratch)", 16, 64, (48, 48),
         lambda: attn_args(4, (48, 48), heads=16)[:3]),
        ("K2", "B=4 H=16 N=2304 d=80 (ViT-H scratch)", 16, 80, (48, 48),
         lambda: attn_args(4, (48, 48), heads=16, d=80)[:3]),
        # a rank's shapes at a model axis of 2 (phase 15)
        ("K1", "BW=4*16 H=8 N=144 d=80 (TP rank ViT-H)", 8, 80, (12, 12),
         lambda: attn_args(64, (12, 12), heads=8, d=80)[:3]),
        ("K1", "BW=4*25 H=6 N=196 (TP rank ViT-B)", 6, 64, (14, 14),
         lambda: attn_args(100, (14, 14), heads=6)[:3]),
        ("K2", "B=4 H=8 N=2304 d=80 (TP rank ViT-H)", 8, 80, (48, 48),
         lambda: attn_args(4, (48, 48), heads=8, d=80)[:3]),
        ("K2", "B=4 H=6 N=4096 (TP rank ViT-B)", 6, 64, (64, 64),
         lambda: attn_args(4, (64, 64), heads=6)[:3]),
        ("K4", "B=4 H=4 N=M=2304 (TP rank)", 4, 128, None,
         lambda: [randn((4, 2304, c // 2)) for _ in range(3)]),
    ]
    wrappers = {"K1": windowed_attention_packed,
                "K2": flash_attention_packed, "K4": cross_attention_packed}
    for kid, shape, heads, d, hw, make in attn_cases:
        base = make()
        cw, scale = heads * d, d ** -0.5
        dout32 = randn(base[0].shape[:2] + (cw,))
        rest = (scale, heads) + ((hw,) if hw else ())
        for dt in dtypes(shape):
            dout = dout32.to(dt)
            ref = None
            body = attention_body(dt, d, base[0].shape[1], base[1].shape[1],
                                  hw is not None, hw, "backward")
            f32_body = (body if dt == torch.float32
                        and body in ("f32", "f32_window") else None)
            for frozen in (False, True):
                tensors = leaves(base, dt, frozen)
                got = through_wrapper(
                    wrappers[kid], tensors, rest, dout,
                    backward_counters(dt, d, base[0].shape[1],
                                      base[1].shape[1], hw))
                if ref is None:
                    with torch.no_grad():
                        if hw:
                            qkv, rh, rw = (t.detach() for t in tensors)
                            q, k, v = (qkv[..., i * cw:(i + 1) * cw]
                                       for i in range(3))
                        else:
                            q, k, v = (t.detach() for t in tensors)
                            rh = rw = None
                        # the (out, lse) the wrapper's forward saved
                        out, lse = attention_launch(q, k, v, scale, heads,
                                                    rh, rw, return_lse=True)
                        _, lse_ref = attention_plain(q, k, v, scale, heads,
                                                     rh, rw, return_lse=True)
                        lse_tol = 2e-5 if dt == torch.float32 else 2e-2
                        lse_err = (lse - lse_ref).abs().max().item()
                        emit("backward_check", kernel=f"{kid} forward",
                             output="lse", shape=shape,
                             dtype=str(dt).replace("torch.", ""),
                             max_abs_err=lse_err,
                             bound=f"atol=rtol={lse_tol}")
                        if not torch.allclose(lse, lse_ref, atol=lse_tol,
                                              rtol=lse_tol):
                            raise AssertionError(
                                f"{kid} {shape} {dt}: lse disagrees (max "
                                f"abs err {lse_err})")
                        ref = attention_backward_plain(
                            q, k, v, out, lse, dout, scale, heads, rh, rw)
                        del lse_ref
                if hw:      # packed dqkv: its three column blocks
                    parts = [got[0][..., i * cw:(i + 1) * cw]
                             for i in range(3)] + list(got[1:])
                else:
                    parts = list(got)
                names = ("dq", "dk", "dv", "drel_h", "drel_w")[:len(parts)]
                if len(parts) != (1 if frozen and not hw else
                                  3 if frozen or not hw else 5):
                    raise AssertionError(f"{kid}: {len(parts)} gradients")
                what = (f"{kid} {shape} through the wrapper, "
                        + ("activations only" if frozen else "every input"))
                errs = {nm: grads_close(what, (g,), (r,), dt, (nm,))
                        for nm, g, r in zip(names, parts, ref)}
                dq_err = max(e for n, e in errs.items()
                             if n not in ("dk", "dv"))
                dkv = [errs[n] for n in ("dk", "dv") if n in errs]
                bwd_err[f"{kid}_dq"] = max(bwd_err.get(f"{kid}_dq", 0.0),
                                           dq_err)
                if dkv:
                    bwd_err[f"{kid}_dkv"] = max(
                        bwd_err.get(f"{kid}_dkv", 0.0), *dkv)
                if d == 80 and dt == torch.bfloat16:
                    bwd_err[f"{kid}_d80"] = max(bwd_err.get(f"{kid}_d80", 0.0),
                                                *errs.values())
                if f32_body:
                    key = f"{kid}_{f32_body}"
                    bwd_err[key] = max(bwd_err.get(key, 0.0), *errs.values())
                del got, parts, tensors
            if f32_body:
                repeat_check(kid, shape, lambda: attention_backward_launch(
                    q, k, v, out, lse, dout, scale, heads, rh, rw), f32_body)
            if dt == torch.bfloat16:
                body = attention_body(dt, d, q.shape[1], k.shape[1],
                                      rh is not None, hw, "backward")
                if body in ("resident", "sm90"):
                    repeat_check(kid, shape, lambda: attention_backward_launch(
                        q, k, v, out, lse, dout, scale, heads, rh, rw), body)
                key = timing_key(kid, shape)
                if key:
                    bwd_inputs[key] = (shape, heads, d, scale,
                                       (q, k, v, out, lse, dout, rh, rw))
            del ref, out, lse, q, k, v, rh, rw
        del base, dout32, dout
        torch.cuda.empty_cache()

    # K5 and K6: q, k, v per head and the tables; K5 once with the encoder's
    # 4-D tables (BH, qh, qw, W), whose gradients must come back 4-D, and
    # once with 3-D ones. "Activations only" here is q, k and v: without a
    # table gradient the dq kernel skips the drel reduction.
    grouped_cases = [
        ("K6", "BWH=4*25*12 N=196", (14, 14), 4 * 25 * 12, 3, 64),
        ("K6", "BWH=4*16*12 N=144", (12, 12), 4 * 16 * 12, 3, 64),
        ("K5", "BH=4*12 N=4096", (64, 64), 4 * 12, 4, 64),
        ("K5", "BH=4*12 N=2304", (48, 48), 4 * 12, 3, 64),
        ("K5", "BH=6 N=1000 (20x50)", (20, 50), 6, 3, 64),
        ("K6", "BWH=7 N=49 (7x7)", (7, 7), 7, 3, 64),
        ("K6", "BWH=111 N=100 (10x10)", (10, 10), 111, 3, 64),
        ("K6", "BWH=1 N=144", (12, 12), 1, 3, 64),
        # head dim 80 at ViT-H's shapes, batch 1: the resident body both
        # ways (K6), also ragged, the Hopper bodies both ways (K5), also on
        # the 48-grid and ragged
        ("K6", "BWH=25*16 N=196 d=80", (14, 14), 25 * 16, 3, 80),
        ("K6", "BWH=7 N=49 (7x7) d=80", (7, 7), 7, 3, 80),
        ("K6", "BWH=20 N=100 (10x10) d=80", (10, 10), 20, 3, 80),
        ("K5", "BH=16 N=4096 d=80", (64, 64), 16, 4, 80),
        ("K5", "BH=16 N=2304 d=80 (48-grid)", (48, 48), 16, 3, 80),
        ("K5", "BH=6 N=1000 d=80 (20x50)", (20, 50), 6, 3, 80),
        # the large encoders' training shapes at batch 4 (phase 14)
        ("K6", "BWH=4*16*16 N=144 d=80 (ViT-H scratch)", (12, 12),
         4 * 16 * 16, 3, 80),
        ("K5", "BH=4*16 N=2304 (ViT-L scratch)", (48, 48), 4 * 16, 3, 64),
        ("K5", "BH=4*16 N=2304 d=80 (ViT-H scratch)", (48, 48), 4 * 16, 3,
         80),
        # a rank's shapes at a model axis of 2 (phase 15)
        ("K5", "BH=4*6 N=4096 (TP rank ViT-B)", (64, 64), 4 * 6, 4, 64),
        ("K6", "BWH=4*25*6 N=196 (TP rank ViT-B)", (14, 14), 4 * 25 * 6, 3,
         64),
    ]
    wrappers.update(K5=flash_attention_rel_pos, K6=windowed_attention_rel_pos)
    grad_names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for kid, shape, hw, bh, table_dims, d in grouped_cases:
        base = grouped_args(bh, hw, d)[:5]
        if table_dims == 4:
            base[3] = base[3].reshape(bh, *hw, hw[0])
            base[4] = base[4].reshape(bh, *hw, hw[1])
        scale, n = d ** -0.5, hw[0] * hw[1]
        dout32 = randn(base[0].shape)
        for dt in dtypes(shape):
            dout = dout32.to(dt)
            ref = None
            body = attention_body(dt, d, n, n, True, hw, "backward")
            f32_body = (body if dt == torch.float32
                        and body in ("f32", "f32_window") else None)
            for frozen in (False, True):
                tensors = [t.to(dt).detach().requires_grad_(
                    i < 3 or not frozen) for i, t in enumerate(base)]
                got = through_wrapper(wrappers[kid], tensors, (scale, hw),
                                      dout,
                                      backward_counters(dt, d, n, n, hw))
                if ref is None:
                    with torch.no_grad():
                        q, k, v, rh, rw = (t.detach() for t in tensors)
                        # the kernels' own operands: one head, BH batches
                        rh4 = rh.reshape(bh, n, 1, hw[0])
                        rw4 = rw.reshape(bh, n, 1, hw[1])
                        out, lse = attention_launch(
                            q, k, v, scale, 1, rh4, rw4, return_lse=True,
                            scale_scores=True)
                        _, lse_ref = grouped_attention_plain(
                            q, k, v, rh, rw, scale, hw, return_lse=True)
                        lse_tol = 2e-5 if dt == torch.float32 else 2e-2
                        lse_err = (lse[..., 0] - lse_ref).abs().max().item()
                        emit("backward_check", kernel=f"{kid} forward",
                             output="lse", shape=shape,
                             dtype=str(dt).replace("torch.", ""),
                             max_abs_err=lse_err,
                             bound=f"atol=rtol={lse_tol}")
                        if not torch.allclose(lse[..., 0], lse_ref,
                                              atol=lse_tol, rtol=lse_tol):
                            raise AssertionError(
                                f"{kid} {shape} {dt}: lse disagrees (max "
                                f"abs err {lse_err})")
                        ref = grouped_attention_backward_plain(
                            q, k, v, rh, rw, out, lse[..., 0], dout, scale,
                            hw)
                        del lse_ref
                if len(got) != (3 if frozen else 5):
                    raise AssertionError(f"{kid}: {len(got)} gradients")
                for g, t in zip(got, tensors):
                    if g.shape != t.shape or g.dtype != t.dtype:
                        raise AssertionError(
                            f"{kid} {shape}: gradient {tuple(g.shape)} "
                            f"{g.dtype} for input {tuple(t.shape)} {t.dtype}")
                what = (f"{kid} {shape} through the wrapper, {table_dims}-D "
                        "tables, " + ("q, k, v only" if frozen
                                      else "every input"))
                errs = {nm: grads_close(what, (g,), (r,), dt, (nm,))
                        for nm, g, r in zip(grad_names, got, ref)}
                bwd_err[f"{kid}_dq"] = max(
                    bwd_err.get(f"{kid}_dq", 0.0),
                    *(e for nm, e in errs.items() if nm not in ("dk", "dv")))
                bwd_err[f"{kid}_dkv"] = max(bwd_err.get(f"{kid}_dkv", 0.0),
                                            errs["dk"], errs["dv"])
                if d == 80 and dt == torch.bfloat16:
                    bwd_err[f"{kid}_d80"] = max(bwd_err.get(f"{kid}_d80", 0.0),
                                                *errs.values())
                if f32_body:
                    key = f"{kid}_{f32_body}"
                    bwd_err[key] = max(bwd_err.get(key, 0.0), *errs.values())
                del got, tensors
            if f32_body:
                repeat_check(kid, shape, lambda: attention_backward_launch(
                    q, k, v, out, lse, dout, scale, 1, rh4, rw4,
                    scale_scores=True), f32_body)
            if dt == torch.bfloat16:
                body = attention_body(dt, d, n, n, True, hw, "backward")
                if body in ("resident", "sm90"):
                    repeat_check(kid, shape, lambda: attention_backward_launch(
                        q, k, v, out, lse, dout, scale, 1, rh4, rw4,
                        scale_scores=True), body)
                key = timing_key(kid, shape)
                if key:
                    bwd_inputs[key] = (shape, 1, d, scale,
                                       (q, k, v, out, lse, dout, rh4, rw4))
            del ref, out, lse, q, k, v, rh, rw, rh4, rw4
        del base, dout32, dout
        torch.cuda.empty_cache()

    mlp_names = ("dx", "dw1", "db1", "dw2", "db2")
    mlp_counters = ("launches", "backward_launches")
    # the training shapes, rows ragged against the GEMM bodies' tiles, and
    # ViT-L's and ViT-H's widths, and (in both dtypes) a tensor-parallel
    # rank's F
    for shape, rows, dmod, fmod in (
            ("R=4*4096", 4 * 4096, 768, 3072),
            ("R=4*2304", 4 * 2304, 768, 3072),
            ("R=1000", 1000, 768, 3072),
            ("R=130 D=1280 F=5120", 130, 1280, 5120),
            ("R=257 D=1024 F=4096", 257, 1024, 4096),
            ("R=1000 D=1280 F=2560 (a rank's F)", 1000, 1280, 2560),
            ("R=1000 D=768 F=1536 (a rank's F)", 1000, 768, 1536),
            ("R=4*2304 D=1024 F=4096 (ViT-L scratch)", 4 * 2304, 1024, 4096),
            ("R=4*2304 D=1280 F=5120 (ViT-H scratch)", 4 * 2304, 1280, 5120),
            # a rank's shapes at a model axis of 2 (phase 15)
            ("R=4*2304 D=1280 F=2560 (TP rank ViT-H)", 4 * 2304, 1280, 2560),
            ("R=4*4096 D=768 F=1536 (TP rank ViT-B)", 4 * 4096, 768, 1536)):
        base = mlp_args(rows, dmod, fmod)
        g32, da32 = randn((rows, dmod)), randn((rows, fmod))
        for dt in dtypes(shape):
            g, da = g32.to(dt), da32.to(dt)
            with torch.no_grad():
                xx, ww, bb = base[0].to(dt), base[1].to(dt), base[2]
                got = fused_mlp_dh(xx, ww, bb, da)
                torch.cuda.synchronize()
                ref = fused_mlp_dh_plain(xx, ww, bb, da)
                key = "K3_dh" if dt == torch.bfloat16 else "K3_dh_f32"
                bwd_err[key] = max(
                    bwd_err.get(key, 0.0),
                    grads_close(f"K3 {shape}", got, ref, dt, ("a", "dh")))
                # without a: the same dh; the forward twice: bit-identical,
                # since every element of either GEMM body has one owner and
                # a fixed order of sums
                no_act, dh_again = fused_mlp_dh(xx, ww, bb, da, False)
                out1 = fused_mlp(xx, ww, bb, base[3].to(dt), base[4])
                out2 = fused_mlp(xx, ww, bb, base[3].to(dt), base[4])
                same = {"dh_without_a": (dh_again - got[1]).abs().max().item(),
                        "second_forward": (out1 - out2).abs().max().item()}
                emit("mlp_repeat", shape=shape,
                     dtype=str(dt).replace("torch.", ""), a_left_out=no_act
                     is None, max_abs_diff=same)
                if no_act is not None or any(same.values()):
                    raise AssertionError(f"K3 {shape} {dt}: dh without a or "
                                         f"a second forward differs {same}")
                del no_act, dh_again, out1, out2
                if dt == torch.bfloat16 and "K3" not in bwd_inputs:
                    bwd_inputs["K3"] = (shape, (xx, ww, bb, da))
                ref = fused_mlp_backward_plain(
                    *leaves(base, dt, True, keep32=(2, 4)), g)
            for frozen in (False, True):
                tensors = leaves(base, dt, frozen, keep32=(2, 4))
                got = through_wrapper(fused_mlp, tensors, (), g,
                                      mlp_counters)
                what = (f"K3 {shape} through the wrapper, "
                        + ("activations only" if frozen else "every input"))
                bwd_err["K3_wrapper"] = max(
                    bwd_err.get("K3_wrapper", 0.0),
                    grads_close(what, got, ref, dt, mlp_names[:len(got)]))
                if len(got) != (1 if frozen else 5):
                    raise AssertionError(f"K3: {len(got)} gradients")
                if dt == torch.bfloat16 and not frozen:
                    # the weight gradients against the products of the
                    # same operands raised to f32 first
                    with torch.no_grad():
                        act, dh = fused_mlp_dh_plain(xx, ww, bb, torch.matmul(
                            g, tensors[3].detach()))
                        exact = (torch.matmul(dh.float().t(), xx.float()),
                                 torch.matmul(g.float().t(), act.float()))
                    grads_close(f"K3 {shape} bf16 GEMM against the f32 "
                                "product", (got[1], got[3]), exact, dt,
                                ("dw1", "dw2"))
                    del act, dh, exact
                del got, tensors
            del ref
        del base, g32, da32, g, da
        torch.cuda.empty_cache()

    # ---- 7. one f32 train step: kernels against the plain path --------------
    def train_batch(batch_size, seed):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                synthetic_batch(batch_size, seed).items()}

    def build_trainer(name, dtype, use_kernels, batch_size, clip=None,
                      layout="packed", variant="vit_b"):
        """ViT-B from the golden weights; ViT-L and ViT-H from seeded
        weights (the same with and without kernels)."""
        cfg = training_config(name, dtype=dtype, use_kernels=use_kernels,
                              batch_size=batch_size, variant=variant)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attn_impl=layout))
        if clip is not None:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, clip_max_norm=clip))
        if variant == "vit_b":
            sb = StepBuilder(cfg)
            load_reference_state_dict(sb.model, golden_sd)
        else:
            sb = StepBuilder(cfg, generator=torch.Generator(device=dev)
                             .manual_seed(0))
        return sb, sb.init_state(steps_per_epoch=100)

    # kernel launches of one train step, by counter: each attention
    # backward launches its dq kernel and its dk/dv kernel, K3's its one;
    # the windowed backward of K1 / K6 is one kernel (the resident body in
    # bf16, the f32 window body in f32) and none of their dq or dk/dv
    # kernels runs
    windowed = ("windowed_attention_packed", "windowed_attention_rel_pos")

    def per_step(with_k4, layout="packed", forward=None):
        fwd = dict(forward or per_forward[layout],
                   cross_attention_packed=int(with_k4))
        attn = {n: v for n, v in fwd.items() if n != "fused_mlp"}
        one_kernel = {n: (v if n in windowed else 0)
                      for n, v in attn.items()
                      if n != "cross_attention_packed"}
        two_kernels = {n: (0 if n in windowed else v)
                       for n, v in attn.items()}
        return {"launches": fwd,
                "backward_launches": {"fused_mlp": fwd["fused_mlp"],
                                      **one_kernel},
                "backward_dq_launches": two_kernels,
                "backward_dkv_launches": two_kernels}

    def all_counts():
        return {attr: counts(attr) for attr in count_names}

    def step_parity(name, batch_size, with_k4, layout="packed",
                    variant="vit_b"):
        """One f32 step with kernels against the same step on the plain
        path: same weights, batch and dropout seed, no clipping (so that
        the raw gradients stay in .grad)."""
        batch = train_batch(batch_size, seed=7)
        parity = {}
        for path, use_kernels in (("kernels", True), ("plain", False)):
            sb, state = build_trainer(name, "float32", use_kernels,
                                      batch_size, clip=1e9, layout=layout,
                                      variant=variant)
            reset_counts()
            _, metrics = sb.train_step(
                state, batch, torch.Generator(device=dev).manual_seed(5))
            torch.cuda.synchronize()
            if use_kernels:
                got_counts = all_counts()
                want = per_step(with_k4, layout, forward=block_forward(
                    sb.cfg))
                if got_counts != want:
                    raise AssertionError(f"{variant} {name} {layout}: f32 "
                                         f"step launches {got_counts}, want "
                                         f"{want}")
                f32_k3["forward"] += got_counts["launches"]["fused_mlp"]
                f32_k3["dh"] += got_counts["backward_launches"]["fused_mlp"]
                f32_k4["forward"] += got_counts["launches"][
                    "cross_attention_packed"]
                for wname in f32_fwd:
                    f32_fwd[wname] += got_counts["launches"].get(wname, 0)
                for way in ("dq", "dkv"):
                    f32_k4["backward_" + way] += got_counts[
                        f"backward_{way}_launches"]["cross_attention_packed"]
                for wname in f32_bwd:
                    dq_n = got_counts["backward_dq_launches"].get(wname, 0)
                    if dq_n != got_counts["backward_dkv_launches"].get(
                            wname, 0):
                        raise AssertionError(f"{wname}: f32 step's dq and "
                                             "dk/dv launches differ")
                    f32_bwd[wname] += dq_n
                for wname in f32_win:
                    f32_win[wname] += got_counts["backward_launches"].get(
                        wname, 0)
            parity[path] = (
                {k: v.item() for k, v in metrics.items()},
                {n: p.grad.clone() for n, p in sb.model.named_parameters()
                 if p.grad is not None})
            del sb, state
            torch.cuda.empty_cache()
        (m_k, g_k), (m_p, g_p) = parity["kernels"], parity["plain"]
        # Each gradient elementwise at the stated tolerance and, since many
        # are far smaller than the atol at these random weights, also by its
        # own norm: |g_k - g_p| <= 1e-3 |g_p| for every parameter whose
        # gradient is more than rounding noise. An attention key bias's
        # exact gradient is zero (the softmax is invariant to a bias added
        # to every key), so it is held elementwise only.
        worst, worst_name, worst_rel, worst_rel_name = 0.0, "", 0.0, ""
        smallest_checked = float("inf")
        for pname, gp in g_p.items():
            err = (g_k[pname] - gp).abs().max().item()
            rel_p = 0.0
            if (not pname.endswith("k_proj.bias")
                    and gp.norm().item() > 1e-10 * m_p["grad_norm"]):
                rel_p = ((g_k[pname] - gp).norm() / gp.norm()).item()
                smallest_checked = min(smallest_checked, gp.norm().item())
            if err > worst:
                worst, worst_name = err, pname
            if rel_p > worst_rel:
                worst_rel, worst_rel_name = rel_p, pname
            if (not torch.allclose(g_k[pname], gp, atol=5e-4, rtol=1e-3)
                    or rel_p > 1e-3):
                raise AssertionError(
                    f"{name}: f32 train step: gradient of {pname} with "
                    f"kernels differs from the plain path's (max abs err "
                    f"{err}, relative {rel_p})")
        num = sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p).sqrt().item()
        rel = num / max(m_p["grad_norm"], 1e-12)
        emit("train_step_parity",
             config=f"{variant} {name} {layout} f32 batch {batch_size}",
             gpu=gpu,
             metrics_kernels=m_k, metrics_plain=m_p, gradients=len(g_p),
             max_abs_grad_err=worst, worst_gradient=worst_name,
             max_relative_err_of_one_gradient=worst_rel,
             worst_relative_gradient=worst_rel_name,
             smallest_gradient_norm_checked=smallest_checked,
             relative_grad_err=rel, atol=5e-4, rtol=1e-3)
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
            if not np.isclose(m_k[key], m_p[key], atol=5e-4, rtol=1e-3):
                raise AssertionError(f"{name}: f32 train step: {key} "
                                     f"{m_k[key]} with kernels, {m_p[key]} "
                                     "on the plain path")
        if set(g_k) != set(g_p) or rel > 1e-3:
            raise AssertionError(f"{name}: f32 train step: relative "
                                 f"gradient error {rel}")

    # the f32 steps' global blocks take the f32 body both ways of the grid:
    # d 64 (ViT-B, ViT-L) and 80 (ViT-H) on the 64- and the 48-grid
    f32_bodies = {f"d={hd} grid={g}x{g}": attention_body(
        torch.float32, hd, g * g, g * g, True, (g, g), "backward")
        for hd in (64, 80) for g in (64, 48)}
    emit("f32_backward_body", bodies=f32_bodies)
    if set(f32_bodies.values()) != {"f32"}:
        raise AssertionError(f"f32 global blocks' backward: {f32_bodies}")
    # and the f32 forward (csrc/attention_fwd_f32.cuh), so that every f32
    # forward launch of K2 and K5 counted on these paths is the f32 body's
    f32_fwd_bodies = {f"d={hd} grid={g}x{g}": attention_body(
        torch.float32, hd, g * g, g * g, True, (g, g))
        for hd in (64, 80) for g in (64, 48)}
    emit("f32_forward_body", bodies=f32_fwd_bodies)
    if set(f32_fwd_bodies.values()) != {"f32"}:
        raise AssertionError(f"f32 global blocks' forward: {f32_fwd_bodies}")
    # and their windows the f32 window bodies both ways, so that the window
    # backward reads the lse of the f32 window forward: 14 and 12 wide at
    # d 64 and 80
    f32_win_bodies = {f"{way} d={hd} window={w}x{w}": attention_body(
        torch.float32, hd, w * w, w * w, True, (w, w), way)
        for way in ("forward", "backward") for hd in (64, 80)
        for w in (14, 12)}
    emit("f32_window_bodies", bodies=f32_win_bodies)
    if set(f32_win_bodies.values()) != {"f32_window"}:
        raise AssertionError(f"f32 windows' bodies: {f32_win_bodies}")
    # every gradient, rel tables and MLP weights included; then the frozen
    # encoder, where the backward kernels write activation gradients only
    for layout in ("packed", "grouped"):
        step_parity("from_scratch", 2, with_k4=True, layout=layout)
        step_parity("fine_tune", 1, with_k4=False, layout=layout)
    torch.cuda.empty_cache()

    # ---- 8. training in bf16: the second main path, once for each layout -----
    # ---- 9. times: train steps and the matcher -------------------------------
    import warnings

    batch4 = train_batch(BATCH, seed=11)
    gen = torch.Generator(device=dev).manual_seed(3)

    def one_wait(name, layout, sb, state):
        """One more step under PyTorch's sync debug mode, which warns at
        every call that waits for the device: the copy of the matching cost
        to the host (ops/lsap.py) must be the only one."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sb.train_step(state, batch4, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [str(w.message)[:200] for w in caught
                 if "synchroniz" in str(w.message).lower()]
        emit("train_step_host_waits", config=name, layout=layout,
             waits=len(waits), want=1, messages=waits)
        if len(waits) != 1:
            raise AssertionError(f"{name}: a train step waited for the "
                                 f"device {len(waits)} times, want 1: "
                                 f"{waits}")

    def training_path(layout):
        """Three bf16 steps at batch 4 in both training configurations with
        the kernels of `layout`: the counts set to 0 just before the run and
        read just after, the checks of what came out, one more step under
        the sync debug mode, and the step's time beside the other path's
        (the plain path for the packed layout, the packed layout for the
        grouped one). Returns the run's counts."""
        trainers, train_metrics, train_mem, snapshots = {}, {}, {}, {}
        # what the earlier phases still hold (kernel inputs kept for the
        # timings): part of every peak below
        resident = torch.cuda.memory_allocated()
        for name in ("fine_tune", "from_scratch"):
            trainers[name] = build_trainer(name, "bfloat16", True, BATCH,
                                           layout=layout)
            snapshots[name] = {n: p.detach().clone() for n, p in
                               trainers[name][0].model.named_parameters()}
        reset_counts()             # the training path's run starts here
        for name, (sb, state) in trainers.items():
            torch.cuda.reset_peak_memory_stats()
            steps = []
            for _ in range(TRAIN_STEPS):
                _, metrics = sb.train_step(state, batch4, gen)
                steps.append(metrics)
            torch.cuda.synchronize()
            train_metrics[name] = [{k: v.item() for k, v in m.items()}
                                   for m in steps]
            train_mem[name] = torch.cuda.max_memory_allocated()
        train_counts = all_counts()
        # ... and ends here
        want_counts = {}
        for with_k4 in (False, True):          # fine_tune, from_scratch
            for attr, per in per_step(with_k4, layout).items():
                tot = want_counts.setdefault(attr, {})
                for n, v in per.items():
                    tot[n] = tot.get(n, 0) + v * TRAIN_STEPS
        emit("training_path_launches", layout=layout, launches=train_counts,
             want=want_counts)
        if train_counts != want_counts:
            raise AssertionError(f"training path, {layout}: launches "
                                 f"{train_counts}, want {want_counts}")
        for name, (sb, state) in trainers.items():
            ms = train_metrics[name]
            moved = frozen_same = 0
            for n, p in sb.model.named_parameters():
                same = torch.equal(p.detach(), snapshots[name][n])
                if p.requires_grad and same:
                    raise AssertionError(f"{name}: trainable {n} did not "
                                         "move")
                if not p.requires_grad and not same:
                    raise AssertionError(f"{name}: frozen {n} changed")
                moved += p.requires_grad
                frozen_same += not p.requires_grad
            finite = all(np.isfinite(v) for m in ms for v in m.values())
            emit("training", config=name, layout=layout, dtype="bfloat16",
                 batch=BATCH, steps=TRAIN_STEPS, gpu=gpu,
                 loss=[m["loss"] for m in ms],
                 grad_norm=[m["grad_norm"] for m in ms],
                 num_boxes=ms[0]["num_boxes"], parameters_moved=moved,
                 parameters_frozen_identical=frozen_same,
                 peak_memory_bytes=train_mem[name],
                 allocated_before_the_trainers_bytes=resident)
            if not finite:
                raise AssertionError(f"{name}: non-finite training metrics "
                                     f"{ms}")
            if name == "from_scratch" and not ms[-1]["loss"] < ms[0]["loss"]:
                raise AssertionError(f"from_scratch: loss did not fall over "
                                     f"{TRAIN_STEPS} steps on one batch: "
                                     f"{[m['loss'] for m in ms]}")
        del snapshots

        for name, (sb, state) in trainers.items():
            one_wait(name, layout, sb, state)

        other = "plain" if layout == "packed" else "packed"
        for name, (sb, state) in trainers.items():
            other_sb, other_state = build_trainer(
                name, "bfloat16", other == "packed", BATCH)
            torch.cuda.reset_peak_memory_stats()
            ms_other, ms_kern = paired_ms(
                lambda: other_sb.train_step(other_state, batch4, gen),
                lambda: sb.train_step(state, batch4, gen), iters=2)
            with torch.no_grad():
                out = sb.model(sb.images(batch4))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    hungarian_match(out, batch4, sb.cfg.criterion)
                torch.cuda.synchronize()
                matcher_ms = (time.perf_counter() - t0) * 1000 / 5
            emit("train_step_time", config=name, layout=layout,
                 dtype="bfloat16", batch=BATCH, gpu=gpu,
                 ms_per_step_kernels=ms_kern,
                 tiles_per_s_kernels=BATCH * 1000 / ms_kern,
                 matcher_host_ms=matcher_ms,
                 matcher_share=matcher_ms / ms_kern,
                 peak_memory_bytes_kernels=train_mem[name],
                 peak_memory_bytes_both_paths=torch.cuda
                 .max_memory_allocated(),
                 **{f"ms_per_step_{other}": ms_other,
                    f"tiles_per_s_{other}": BATCH * 1000 / ms_other})
            del other_sb, other_state, out
            torch.cuda.empty_cache()
        return train_counts

    path_counts = {layout: training_path(layout)
                   for layout in ("packed", "grouped")}
    torch.cuda.empty_cache()
    train_counts = {
        attr: {n: path_counts["packed"][attr][n]
               + path_counts["grouped"][attr][n] for n in per}
        for attr, per in path_counts["packed"].items()}

    # ---- 8b. ViT-H fine-tune with remat_blocks: the d-80 backward's path ----
    # The frozen ViT-H encoder (D 1280, 32 blocks, 16 heads of 80; seeded
    # random weights, no checkpoint is at hand) under the trainable adaptor
    # and decoder, bf16, batch 4, in each layout. Each block keeps its input
    # and its attention output and recomputes the rest in the backward: its
    # attention forward is launched again (counted), the MLP's forward is
    # not. The global blocks' backward is the Hopper body at d = 80 (K2 or
    # K5), the windows' the resident body (K1 or K6): one launch a block and
    # no plain delta pass, counted where the tile bodies would run one.
    def vit_h_trainer(layout, remat):
        cfg = training_config("fine_tune", "bfloat16", True, BATCH,
                              variant="vit_h", remat_blocks=remat)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attn_impl=layout))
        sb = StepBuilder(cfg, generator=torch.Generator().manual_seed(0))
        return sb, sb.init_state(steps_per_epoch=100)

    def vit_h_want(layout):
        """The counts of TRAIN_STEPS remat steps: per_step's at ViT-H's depth
        (4 global blocks, 28 windowed, 32 MLPs, no K4; a d-80 window's
        backward is one resident kernel), every attention forward twice."""
        glob, win = (("flash_attention_packed", "windowed_attention_packed")
                     if layout == "packed" else
                     ("flash_attention_rel_pos", "windowed_attention_rel_pos"))
        fwd = dict({n: 0 for n in per_forward[layout]}, **{
            glob: 4, win: 28, "fused_mlp": 32 if layout == "packed" else 0})
        per = per_step(False, layout, forward=fwd)
        per["launches"] = {n: v * (1 if n == "fused_mlp" else 2)
                           for n, v in per["launches"].items()}
        return {attr: {n: v * TRAIN_STEPS for n, v in d.items()}
                for attr, d in per.items()}

    def trainable_grads(sb):
        return {n: p.grad.detach().clone()
                for n, p in sb.model.named_parameters() if p.grad is not None}

    def counted_delta(*args):
        delta_passes[0] += 1
        return real_delta(*args)

    vit_h_counts, delta_passes, real_delta = {}, [0], _attention.attention_delta
    for layout in ("packed", "grouped"):
        sb_r, state_r = vit_h_trainer(layout, remat=True)
        frozen = {n: p.detach().clone()
                  for n, p in sb_r.model.named_parameters()
                  if not p.requires_grad}
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen_h = torch.Generator(device=dev).manual_seed(13)
        steps = []
        reset_counts()             # the ViT-H path's run starts here
        delta_passes[0] = 0
        _attention.attention_delta = counted_delta
        try:
            for i in range(TRAIN_STEPS):
                _, metrics = sb_r.train_step(state_r, batch4, gen_h)
                steps.append(metrics)
                if i == 0 and layout == "packed":
                    first_grads = trainable_grads(sb_r)
            torch.cuda.synchronize()
        finally:
            _attention.attention_delta = real_delta
        vit_h_counts[layout] = all_counts()
        # ... and ends here
        peak_remat = torch.cuda.max_memory_allocated()
        want = vit_h_want(layout)
        emit("vit_h_training_launches", layout=layout,
             launches=vit_h_counts[layout], want=want,
             plain_delta_passes=delta_passes[0])
        if vit_h_counts[layout] != want or delta_passes[0]:
            raise AssertionError(f"ViT-H fine-tune, {layout}: launches "
                                 f"{vit_h_counts[layout]}, want {want}; "
                                 f"{delta_passes[0]} plain delta passes")
        ms = [{k: v.item() for k, v in m.items()} for m in steps]
        changed = [n for n, p in sb_r.model.named_parameters()
                   if not p.requires_grad and not torch.equal(p, frozen[n])]
        finite = all(np.isfinite(v) for m in ms for v in m.values())
        emit("vit_h_training", config="fine_tune", variant="vit_h",
             layout=layout, remat_blocks=True, dtype="bfloat16", batch=BATCH,
             steps=TRAIN_STEPS, gpu=gpu, loss=[m["loss"] for m in ms],
             grad_norm=[m["grad_norm"] for m in ms],
             parameters_frozen_identical=len(frozen) - len(changed),
             parameters_trainable=sum(p.requires_grad for p in
                                      sb_r.model.parameters()),
             peak_memory_bytes=peak_remat,
             allocated_at_start_bytes=start_bytes)
        if not finite or changed or not ms[-1]["loss"] < ms[0]["loss"]:
            raise AssertionError(f"ViT-H fine-tune, {layout}: losses "
                                 f"{[m['loss'] for m in ms]}, frozen "
                                 f"parameters changed: {changed[:5]}")
        del frozen
        if layout == "grouped":
            del sb_r, state_r
            torch.cuda.empty_cache()
            continue
        one_wait("fine_tune vit_h remat", layout, sb_r, state_r)
        vit_h_remat = (sb_r, state_r, ms[0], peak_remat - start_bytes)

    # the same first step without remat_blocks (same weights, batch and
    # dropout seed): the same function, and the memory remat saves
    sb_r, state_r, first_remat, above_remat = vit_h_remat
    sb_n, state_n = vit_h_trainer("packed", remat=False)
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, metrics = sb_n.train_step(state_n, batch4,
                                 torch.Generator(device=dev).manual_seed(13))
    torch.cuda.synchronize()
    above_none = torch.cuda.max_memory_allocated() - start_bytes
    first_none = {k: v.item() for k, v in metrics.items()}
    grads_none = trainable_grads(sb_n)
    same = (set(grads_none) == set(first_grads) and all(
        torch.equal(first_grads[n], g) for n, g in grads_none.items()))
    worst_rel = max(((first_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
                    .item() for n, g in grads_none.items())
    emit("vit_h_remat_against_none", config="fine_tune", variant="vit_h",
         dtype="bfloat16", batch=BATCH, gpu=gpu,
         loss_remat=first_remat["loss"], loss_without=first_none["loss"],
         grad_norm_remat=first_remat["grad_norm"],
         grad_norm_without=first_none["grad_norm"],
         gradients=len(grads_none), bit_identical=same,
         max_relative_grad_err=worst_rel,
         peak_memory_above_start_bytes_remat=above_remat,
         peak_memory_above_start_bytes_without=above_none,
         saved_by_remat_bytes=above_none - above_remat)
    if (worst_rel > 1e-3 or not np.isclose(first_remat["loss"],
                                           first_none["loss"], rtol=1e-4)):
        raise AssertionError(f"ViT-H: remat_blocks changed the step (loss "
                             f"{first_remat['loss']} against "
                             f"{first_none['loss']}, relative gradient "
                             f"error {worst_rel})")
    del first_grads, grads_none
    # the step's time with remat_blocks and without, in turns
    ms_none, ms_remat = paired_ms(
        lambda: sb_n.train_step(state_n, batch4, gen),
        lambda: sb_r.train_step(state_r, batch4, gen), iters=2)
    emit("train_step_time", config="fine_tune", variant="vit_h",
         layout="packed", dtype="bfloat16", batch=BATCH, gpu=gpu,
         ms_per_step_remat=ms_remat, ms_per_step_without_remat=ms_none,
         tiles_per_s_remat=BATCH * 1000 / ms_remat)
    del sb_r, state_r, sb_n, state_n, vit_h_remat
    torch.cuda.empty_cache()

    ids = {"K1": "windowed_attention_packed", "K2": "flash_attention_packed",
           "K4": "cross_attention_packed", "K5": "flash_attention_rel_pos",
           "K6": "windowed_attention_rel_pos"}
    replaces_fwd = {"K1": "windowed_attention_v2.py:227",
                    "K2": "flash_attention_v2.py:199",
                    "K4": "cross_attention.py:160",
                    "K5": "flash_attention.py:230",
                    "K6": "windowed_attention.py:144"}
    # K5's one Pallas backward kernel became the two kernels here; K1's and
    # K6's are one kernel again (the resident bodies)
    replaces_bwd = {"K1": ("windowed_attention_v2.py:260",) * 2,
                    "K2": ("flash_attention_v2.py:364",
                           "flash_attention_v2.py:392"),
                    "K4": ("cross_attention.py:208", "cross_attention.py:227"),
                    "K5": ("flash_attention.py:268",) * 2,
                    "K6": ("windowed_attention.py:173",) * 2}
    grouped_cu = "wildlifemapper_tpu_torch/csrc/grouped_attention.cu"
    grouped_bwd_cu = "wildlifemapper_tpu_torch/csrc/grouped_attention_bwd.cu"
    timed = [(kid, kid) for kid in ("K1", "K2", "K4", "K5", "K6")] + [
        ("K1", "K1 N=144"), ("K6", "K6 N=144"), ("K2", "K2 N=2304"),
        ("K4", "K4 N=2304"), ("K5", "K5 N=2304")]
    for kid, key in timed:
        # K5 and K6 arrive as their kernels take them: (BH, N, d) is the
        # family's layout with one head, tables (BH, N, 1, g), lse (BH, N, 1).
        # The first shape of a kernel makes its entries of the "kernels"
        # line; the windowed kernels' second shape a line of its own.
        primary = key == kid
        shape, heads, d, scale, tensors = bwd_inputs.pop(key)
        q, k, v, out, lse, dout, rh, rw = tensors
        b, n, m = q.shape[0], q.shape[1], k.shape[1]
        wname = ids[kid]
        ss = kid in ("K5", "K6")       # the scale goes on the f32 scores
        fwd_cu, back_cu = ((grouped_cu, grouped_bwd_cu) if ss
                           else (attn_cu, bwd_cu))
        lib_fwd, lib_bwd = sdpa_pair(q, k, v, rh, rw, heads, scale)
        with torch.no_grad():
            lib_fwd_ms = time_ms(lib_fwd, iters=20)
        lib_bwd_ms = time_ms(lib_bwd)
        del lib_fwd, lib_bwd
        torch.cuda.empty_cache()
        mac = b * heads * n * m * d
        stats = [lse, lse]             # lse and delta, (B, N, H) f32 each
        fb, fby = bound_ms(4 * mac, nbytes(q, k, v, out, rh, rw))
        # The body these shapes take, and, where it is a Hopper or a
        # resident body, the time of the mma.sync body that ran them before,
        # on the same inputs in this run, in turns (old, new, new, old), at
        # the launcher.
        hw = (rh.shape[-1], rw.shape[-1]) if rh is not None else None
        body = attention_body(q.dtype, d, n, m, rh is not None, hw)
        redesigned = body != "mma"
        if body == "sm90":
            fwd_cu, back_cu = (fwd_cu.replace(".cu", "_sm90.cu"),
                               back_cu.replace(".cu", "_{}_sm90.cu"))
        elif body == "resident":
            fwd_cu, back_cu = (fwd_cu.replace(".cu", "_resident.cu"),
                               back_cu.replace(".cu", "_resident.cu"))

        def forward(which_body):
            return lambda: attention_launch(q, k, v, scale, heads, rh, rw,
                                            scale_scores=ss, body=which_body)

        old_fwd_ms = new_fwd_ms = None
        with torch.no_grad():
            if redesigned:
                # the Hopper forward takes 0.2-0.6 ms: 20 launches a turn
                old_fwd_ms, new_fwd_ms = paired_ms(
                    forward("mma"), forward(body),
                    iters=20 if body == "sm90" else 5)
            if not primary:
                plain_fwd_ms = time_ms(lambda: attention_plain(
                    q, k, v, scale, heads, rh, rw, scale_scores=ss))
        if body == "sm90":
            emit("forward_time", kernel=kid, shape=shape, dtype="bfloat16",
                 gpu=gpu, body=body, launches_timed=20, ms=new_fwd_ms,
                 earlier_body="mma", earlier_body_ms=old_fwd_ms,
                 bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
                 over_bound=new_fwd_ms / fb, over_library=new_fwd_ms
                 / lib_fwd_ms)
        if primary:
            entry(wname, fwd_cu, jax_ops + replaces_fwd[kid], body=body,
                  earlier_body_ms=old_fwd_ms, launcher_ms=new_fwd_ms,
                  launches=serving_counts[wname]
                  + train_counts["launches"][wname],
                  launches_serving=serving_counts[wname],
                  launches_training=train_counts["launches"][wname],
                  shape=shape, max_abs_err=errors[wname],
                  ms=kernel_ms[wname][0], plain_ms=kernel_ms[wname][1],
                  bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
                  library="F.scaled_dot_product_attention"
                  + (" with the bias as attn_mask" if rh is not None
                     else ""))
        else:
            emit("kernel_time", kernel=wname, shape=shape, dtype="bfloat16",
                 gpu=gpu, body=body, ms=new_fwd_ms,
                 earlier_body_ms=old_fwd_ms, plain_ms=plain_fwd_ms,
                 bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms)

        def whole(which_body=None, want_drel=True):
            """The whole backward at the launcher: one kernel for the
            resident body, two for the Hopper body (delta inside the dq
            kernel), the delta pass and two kernels for the tile bodies."""
            return lambda: attention_backward_launch(
                q, k, v, out, lse, dout, scale, heads, rh, rw,
                want_drel=want_drel, scale_scores=ss, body=which_body)

        def one(kernel, want_drel=True, which_body=None):
            """One kernel of a two-kernel backward alone, on buffers made
            beforehand: the tile bodies' kernels with the plain delta pass's
            delta, the Hopper dk/dv kernel with what its dq kernel left
            (run once here, untimed)."""
            grads = [torch.empty_like(t) for t in (q, k, v)]
            drel = ([torch.empty_like(t) for t in (rh, rw)]
                    if rh is not None and want_drel else [None, None])
            grid = hw if hw else (0, 0)
            which = which_body or (body if body != "resident" else "mma")
            if which == "sm90":
                scratch = sm90_scratch(q, heads, scale, ss, rh is not None)

                def launch(kern):
                    _sm90_backward_launch(kern, q, k, v, dout, out, lse,
                                          scratch, rh, rw, *grads, *drel,
                                          scale, heads, d, *grid,
                                          scale_scores=ss)
                if kernel == 1:
                    launch(0)
                return lambda: launch(kernel)
            delta = attention_delta(dout, out, heads).contiguous()
            return lambda: _backward_kernel_launch(
                kernel, q, k, v, dout, lse, delta, rh, rw, *grads, *drel,
                scale, heads, d, *grid, scale_scores=ss)

        def plain():
            return attention_backward_plain(q, k, v, out, lse, dout, scale,
                                            heads, rh, rw, scale_scores=ss)

        with torch.no_grad():
            ms_plain, ms_both = paired_ms(plain, whole())
            delta_ms = time_ms(lambda: attention_delta(dout, out, heads)
                               .contiguous())
            old_dq = old_dkv = old_both = ms_nodrel = None
            if body == "resident":
                # the earlier bodies' whole backward, delta pass included,
                # and its pieces
                old_both, ms_both = paired_ms(whole("mma"), whole())
                ms_nodrel = time_ms(whole(want_drel=False))
                old_dq, old_dkv = time_ms(one(0)), time_ms(one(1))
                ms_dq = ms_dkv = ms_dq_nodrel = None
            else:
                if redesigned:
                    old_dq, ms_dq = paired_ms(one(0, which_body="mma"),
                                              one(0))
                    old_dkv, ms_dkv = paired_ms(one(1, which_body="mma"),
                                                one(1))
                else:
                    ms_dq, ms_dkv = time_ms(one(0)), time_ms(one(1))
                ms_dq_nodrel = (time_ms(one(0, False)) if rh is not None
                                else None)
        # the dq kernel: 3 products (S, dP, dQ); reads q, k, v, do, lse,
        # the tables and (the Hopper body, delta inside) o, writes dq, delta
        # and the tables' gradients. The dk/dv kernel: 4 products (S, dP,
        # dK, dV); reads q, k, v, do, the tables, lse and delta, writes dk
        # and dv.
        tabs = rh is not None
        scores = b * heads * n * m
        dq_b = attention_backward_bound(
            3, mac, scores, tabs, tabs,
            nbytes(q, k, v, dout, q, rh, rw, rh, rw, *stats)
            + (nbytes(out) if body == "sm90" else 0))
        dkv_b = attention_backward_bound(
            4, mac, scores, tabs, False,
            nbytes(q, k, v, dout, k, v, rh, rw, *stats))
        # the whole backward reads q, k, v, do, o, lse and the tables and
        # writes dq, dk, dv and the tables' gradients: 5 products (S, dP,
        # dq, dk, dv), whichever body
        both_b = attention_backward_bound(
            5, mac, scores, tabs, tabs,
            nbytes(q, k, v, dout, out, lse, q, k, v, rh, rw, rh, rw))
        emit("backward_kernel_time", kernel=kid, shape=shape, dtype="bfloat16",
             gpu=gpu, body=body, dq_ms=ms_dq,
             dq_without_drel_ms=ms_dq_nodrel, dkv_ms=ms_dkv,
             earlier_body_dq_ms=old_dq, earlier_body_dkv_ms=old_dkv,
             earlier_body_whole_ms=old_both, delta_pass_ms=delta_ms,
             both_ms=ms_both, without_drel_ms=ms_nodrel, plain_ms=ms_plain,
             bound_ms=both_b[0], bound_by=both_b[1], dq_bound_ms=dq_b[0],
             dkv_bound_ms=dkv_b[0], over_bound=ms_both / both_b[0],
             library_forward_ms=lib_fwd_ms, library_backward_ms=lib_bwd_ms)
        tc = train_counts
        if not primary:
            pass
        elif kid in ("K1", "K6"):
            if body != "resident":
                raise AssertionError(f"{kid} {shape}: body {body}, want "
                                     "the resident one")
            entry(wname + "_backward", back_cu,
                  jax_ops + replaces_bwd[kid][0], body=body,
                  earlier_body_ms=old_both,
                  earlier_body_delta_ms=delta_ms,
                  earlier_body_dq_ms=old_dq, earlier_body_dkv_ms=old_dkv,
                  launches=tc["backward_launches"][wname], shape=shape,
                  max_abs_err=max(bwd_err[f"{kid}_dq"],
                                  bwd_err[f"{kid}_dkv"]),
                  ms=ms_both, without_drel_ms=ms_nodrel, plain_ms=ms_plain,
                  bound_ms=both_b[0], bound_by=both_b[1],
                  library_ms=lib_bwd_ms,
                  library="autograd through scaled_dot_product_attention "
                          "(dq, dk, dv; no rel-table gradient)",
                  kernels_per_backward=1)
        else:
            entry(wname + "_backward_dq", back_cu.format("dq"),
                  jax_ops + replaces_bwd[kid][0], body=body,
                  earlier_body_ms=old_dq,
                  launches=tc["backward_dq_launches"][wname], shape=shape,
                  max_abs_err=bwd_err[f"{kid}_dq"], ms=ms_dq,
                  delta_pass_ms=delta_ms,
                  plain_ms=ms_plain, plain_covers="dq + dk/dv",
                  bound_ms=dq_b[0], bound_by=dq_b[1], library_ms=lib_bwd_ms,
                  library="autograd through scaled_dot_product_attention",
                  library_covers="dq + dk/dv (one call)")
            entry(wname + "_backward_dkv", back_cu.format("dkv"),
                  jax_ops + replaces_bwd[kid][1], body=body,
                  earlier_body_ms=old_dkv,
                  launches=tc["backward_dkv_launches"][wname], shape=shape,
                  max_abs_err=bwd_err[f"{kid}_dkv"], ms=ms_dkv,
                  plain_ms=ms_plain, plain_covers="dq + dk/dv",
                  bound_ms=dkv_b[0], bound_by=dkv_b[1], library_ms=None,
                  library_covers="see the dq entry")
        del tensors, q, k, v, out, lse, dout, rh, rw
        torch.cuda.empty_cache()

    # ViT-H's attention (head dim 80, 16 heads) at batch 1 and 4: the bf16
    # forward of the Hopper body (K2, K5 on the 64-grid) and of the resident
    # body (K1, K6 on 25 windows of 14 an image) in turns with the tile body
    # over 20 launches a turn, beside one library call and the bound; the
    # whole backward of K2 and K5 (the Hopper body: the dq kernel with delta
    # inside, then dk/dv) and of K1 and K6 (the resident body: one kernel) in
    # turns with the tile bodies' (the delta pass and two kernels) at batch 1
    # and 4, beside autograd through the library call.
    vit_h = {}
    for batch in (1, 4):
        for kid in ("K2", "K5", "K1", "K6"):
            hw = (14, 14) if kid in ("K1", "K6") else (64, 64)
            n, ss = hw[0] * hw[1], kid in ("K5", "K6")
            nb = batch * (25 if kid in ("K1", "K6") else 1)
            heads, scale = (1 if ss else 16), 80 ** -0.5
            if ss:      # the grouped operands: one head, BH batches
                q, k, v = (randn((nb * 16, n, 80)).to(torch.bfloat16)
                           for _ in range(3))
                rh, rw = (randn((nb * 16, n, 1, g), 0.5).to(torch.bfloat16)
                          for g in hw)
            else:
                qkv = randn((nb, n, 3 * 1280)).to(torch.bfloat16)
                q, k, v = qkv.split(1280, dim=-1)
                rh, rw = (randn((nb, n, 16, g), 0.5).to(torch.bfloat16)
                          for g in hw)
            shape = {"K1": f"BW={nb} H=16", "K6": f"BWH={nb * 16}",
                     "K2": f"B={nb} H=16", "K5": f"BH={nb * 16}"}[kid]
            shape += f" N={n} d=80"
            body = attention_body(torch.bfloat16, 80, n, n, True, hw)

            def forward(which_body, lse=False):
                return lambda: attention_launch(
                    q, k, v, scale, heads, rh, rw, return_lse=lse,
                    scale_scores=ss, body=which_body)

            mac = nb * 16 * n * n * 80
            fb, fby = bound_ms(4 * mac, nbytes(q, k, v, q, rh, rw))
            lib_fwd, lib_bwd = sdpa_pair(q, k, v, rh, rw, heads, scale)
            with torch.no_grad():
                old_ms, new_ms = paired_ms(forward("mma"), forward(body),
                                           iters=20)
                lib_ms = time_ms(lib_fwd, iters=20)
                plain_ms = time_ms(lambda: attention_plain(
                    q, k, v, scale, heads, rh, rw, scale_scores=ss))
            emit("forward_time", kernel=kid, shape=shape, dtype="bfloat16",
                 gpu=gpu, body=body, launches_timed=20, ms=new_ms,
                 earlier_body="mma", earlier_body_ms=old_ms, bound_ms=fb,
                 bound_by=fby, library_ms=lib_ms, plain_ms=plain_ms,
                 over_bound=new_ms / fb, over_library=new_ms / lib_ms)
            row = dict(shape=shape, body=body, ms=new_ms,
                       earlier_body_ms=old_ms, library_ms=lib_ms,
                       plain_ms=plain_ms, bound_ms=fb, bound_by=fby)
            bwd_body = attention_body(torch.bfloat16, 80, n, n, True, hw,
                                      "backward")
            with torch.no_grad():
                out, lse = forward(body, lse=True)()
                dout = torch.randn_like(out)

                def backward(which_body):
                    return lambda: attention_backward_launch(
                        q, k, v, out, lse, dout, scale, heads, rh, rw,
                        scale_scores=ss, body=which_body)
                # in turns with the tile bodies
                tile_bwd_ms, bwd_ms = paired_ms(backward("mma"),
                                                backward(bwd_body))
                bwd_plain_ms = (time_ms(lambda: attention_backward_plain(
                    q, k, v, out, lse, dout, scale, heads, rh, rw,
                    scale_scores=ss)) if batch == 1 else None)
            lib_bwd_ms = time_ms(lib_bwd)
            bb = attention_backward_bound(
                5, mac, nb * 16 * n * n, True, True,
                nbytes(q, k, v, dout, out, lse, q, k, v, rh, rw, rh, rw))
            emit("backward_kernel_time", kernel=kid, shape=shape,
                 dtype="bfloat16", gpu=gpu, body=bwd_body,
                 both_ms=bwd_ms, earlier_body="mma",
                 earlier_body_ms=tile_bwd_ms, plain_ms=bwd_plain_ms,
                 bound_ms=bb[0], bound_by=bb[1],
                 library_backward_ms=lib_bwd_ms,
                 over_library=bwd_ms / lib_bwd_ms,
                 over_bound=bwd_ms / bb[0])
            vit_h.setdefault(kid, {})[f"backward_batch_{batch}"] = dict(
                shape=shape, body=bwd_body, ms=bwd_ms,
                earlier_body_ms=tile_bwd_ms, plain_ms=bwd_plain_ms,
                library_ms=lib_bwd_ms, bound_ms=bb[0], bound_by=bb[1])
            del out, lse, dout
            vit_h.setdefault(kid, {})[f"forward_batch_{batch}"] = row
            del q, k, v, rh, rw, lib_fwd, lib_bwd
            torch.cuda.empty_cache()
    for kid, rows in vit_h.items():
        report[ids[kid]]["vit_h_d80"] = {
            "batch_1": rows["forward_batch_1"],
            "batch_4": rows["forward_batch_4"]}
        # the d-80 backward, launched by the ViT-H fine-tune (phase 8b; K5 and
        # K6 in its grouped run): the whole backward at batch 1, batch 4
        # beside it; the Hopper body's two kernels (K2, K5), the resident
        # body's one (K1, K6)
        layout = "grouped" if kid in ("K5", "K6") else "packed"
        wname = ids[kid]
        one = rows["backward_batch_1"]
        cu = ("wildlifemapper_tpu_torch/csrc/"
              + ("grouped_" if kid in ("K5", "K6") else ""))
        counts_h = vit_h_counts[layout]
        if kid in ("K1", "K6"):
            kernel_fields = dict(
                body="resident", source=cu + "attention_bwd_resident.cu",
                launches=counts_h["backward_launches"][wname],
                covers="delta, dq, dk, dv and the table gradients in one "
                       "kernel", kernels_per_backward=1)
        else:
            kernel_fields = dict(
                body="sm90", source=cu + "attention_bwd_dq_sm90.cu",
                source_dkv=cu + "attention_bwd_dkv_sm90.cu",
                replaces_dkv=jax_ops + replaces_bwd[kid][1],
                launches=counts_h["backward_dq_launches"][wname],
                launches_dkv=counts_h["backward_dkv_launches"][wname],
                covers="dq + delta, then dk/dv")
        source = kernel_fields.pop("source")
        entry(wname + "_backward_d80", source,
              jax_ops + replaces_bwd[kid][0], head_dim=80,
              launches_from="ViT-H fine-tune, remat_blocks, " + layout,
              shape=one["shape"], max_abs_err=bwd_err[f"{kid}_d80"],
              ms=one["ms"], earlier_body="mma",
              earlier_body_ms=one["earlier_body_ms"],
              plain_ms=one["plain_ms"], bound_ms=one["bound_ms"],
              bound_by=one["bound_by"], library_ms=one["library_ms"],
              library="autograd through scaled_dot_product_attention "
                      "(dq, dk, dv)",
              batch_4=rows["backward_batch_4"], **kernel_fields)

    # The large encoders' attention shapes at batch 4 (phase 14): the bf16
    # forward in turns with one library call over 20 launches a turn, the
    # whole backward in turns with autograd through that call, the plain
    # versions beside them, and the bounds.
    large_timed = [
        ("K1", "BW=100 H=16 N=196 (ViT-L)", 100, 64, (14, 14)),
        ("K1", "BW=64 H=16 N=144 (ViT-L scratch)", 64, 64, (12, 12)),
        ("K1", "BW=64 H=16 N=144 d=80 (ViT-H scratch)", 64, 80, (12, 12)),
        ("K2", "B=4 H=16 N=4096 (ViT-L)", 4, 64, (64, 64)),
        ("K2", "B=4 H=16 N=2304 (ViT-L scratch)", 4, 64, (48, 48)),
        ("K2", "B=4 H=16 N=2304 d=80 (ViT-H scratch)", 4, 80, (48, 48)),
        ("K6", "BWH=1024 N=144 d=80 (ViT-H scratch)", 64, 80, (12, 12)),
        ("K5", "BH=64 N=2304 (ViT-L scratch)", 4, 64, (48, 48)),
        ("K5", "BH=64 N=2304 d=80 (ViT-H scratch)", 4, 80, (48, 48)),
    ]
    for kid, shape, nb, d, hw in large_timed:
        n, ss = hw[0] * hw[1], kid in ("K5", "K6")
        heads, scale, cw = (1 if ss else 16), d ** -0.5, 16 * d
        if ss:          # the grouped operands: one head, BH batches
            q, k, v = (randn((nb * 16, n, d)).to(torch.bfloat16)
                       for _ in range(3))
            rh, rw = (randn((nb * 16, n, 1, g), 0.5).to(torch.bfloat16)
                      for g in hw)
        else:
            q, k, v = randn((nb, n, 3 * cw)).to(torch.bfloat16).split(cw, -1)
            rh, rw = (randn((nb, n, 16, g), 0.5).to(torch.bfloat16)
                      for g in hw)
        mac = nb * 16 * n * n * d
        fb = bound_ms(4 * mac, nbytes(q, k, v, q, rh, rw))
        lib_fwd, lib_bwd = sdpa_pair(q, k, v, rh, rw, heads, scale)
        with torch.no_grad():
            def kern_fwd():
                return attention_launch(q, k, v, scale, heads, rh, rw,
                                        scale_scores=ss)
            lib_ms, fwd_ms = paired_ms(lib_fwd, kern_fwd, iters=20)
            fwd_plain_ms = time_ms(lambda: attention_plain(
                q, k, v, scale, heads, rh, rw, scale_scores=ss), iters=2)
            out, lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                        return_lse=True, scale_scores=ss)
            dout = torch.randn_like(out)

            def kern_bwd():
                return attention_backward_launch(
                    q, k, v, out, lse, dout, scale, heads, rh, rw,
                    scale_scores=ss)
            bwd_plain_ms = time_ms(lambda: attention_backward_plain(
                q, k, v, out, lse, dout, scale, heads, rh, rw,
                scale_scores=ss), iters=1)
        lib_bwd_ms, bwd_ms = paired_ms(lib_bwd, kern_bwd)
        bb = attention_backward_bound(
            5, mac, nb * 16 * n * n, True, True,
            nbytes(q, k, v, dout, out, lse, q, k, v, rh, rw, rh, rw))
        row = dict(
            shape=shape, head_dim=d,
            body=attention_body(torch.bfloat16, d, n, n, True, hw),
            backward_body=attention_body(torch.bfloat16, d, n, n, True, hw,
                                         "backward"),
            ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=lib_ms,
            bound_ms=fb[0], bound_by=fb[1], backward_ms=bwd_ms,
            backward_plain_ms=bwd_plain_ms, backward_library_ms=lib_bwd_ms,
            backward_bound_ms=bb[0], backward_bound_by=bb[1])
        emit("large_kernel_time", kernel=kid, dtype="bfloat16", gpu=gpu,
             launches_timed=20, **row)
        report[ids[kid]].setdefault("large_shapes", []).append(row)
        del q, k, v, rh, rw, out, lse, dout, lib_fwd, lib_bwd
        torch.cuda.empty_cache()

    # K3 in bf16 at the main paths' two row counts and at ViT-L's and
    # ViT-H's widths: the forward in turns with the library chain, dh in
    # turns with F.linear and the GELU-gradient product (yardsticks only),
    # 20 launches a turn since the kernels take 0.1-0.3 ms; the forward's
    # two passes alone; the host time of a wrapper call (its tensor maps and
    # launches); at R = 16384 the plain versions as for the other kernels.
    shape, (xx, ww, bb, dd) = bwd_inputs.pop("K3")

    def dh_library(x_, w1_, b1_, da_):
        h = F.linear(x_, w1_, b1_)
        cdf = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
        return da_ * (cdf + h * torch.exp(-0.5 * h * h)
                      * (2.0 * math.pi) ** -0.5)

    k3 = {}
    for rows, dmod, fdim in ((4 * 4096, 768, 3072), (4 * 2304, 768, 3072),
                             (4 * 4096, 1024, 4096), (4096, 1280, 5120),
                             (4 * 2304, 1024, 4096), (4 * 2304, 1280, 5120)):
        if (rows, dmod) == tuple(xx.shape):
            x_, w1, b1, da_ = xx, ww, bb, dd
        else:
            x_ = randn((rows, dmod)).to(torch.bfloat16)
            w1 = randn((fdim, dmod), dmod ** -0.5).to(torch.bfloat16)
            b1 = randn((fdim,), 0.1)
            da_ = randn((rows, fdim)).to(torch.bfloat16)
        w2 = randn((dmod, fdim), fdim ** -0.5).to(torch.bfloat16)
        b2 = randn((dmod,), 0.1)
        b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
        hidden = torch.empty_like(da_)
        out2 = torch.empty_like(x_)
        with torch.no_grad():
            chain_ms, fwd_ms = paired_ms(
                lambda: F.linear(F.gelu(F.linear(x_, w1, b1h)), w2, b2h),
                lambda: fused_mlp(x_, w1, b1, w2, b2), iters=20)
            lib_dh_ms, dh_ms = paired_ms(
                lambda: dh_library(x_, w1, b1h, da_),
                lambda: fused_mlp_dh(x_, w1, b1, da_), iters=20)
            fc1_ms = time_ms(lambda: _gemm(_BIAS_GELU, x_, w1, b1, hidden),
                             iters=20)
            fc2_ms = time_ms(lambda: _gemm(_BIAS, hidden, w2, b2, out2),
                             iters=20)
            fwd_host = host_us(lambda: fused_mlp(x_, w1, b1, w2, b2))
            dh_host = host_us(lambda: fused_mlp_dh(x_, w1, b1, da_))
            dh_plain_ms = (paired_ms(
                lambda: fused_mlp_dh_plain(x_, w1, b1, da_),
                lambda: fused_mlp_dh(x_, w1, b1, da_))[0]
                if x_ is xx else None)
        fb = bound_ms(4 * rows * dmod * fdim, nbytes(x_, x_, w1, w2, b1, b2))
        db = bound_ms(2 * rows * dmod * fdim,
                      nbytes(x_, w1, b1, da_, da_, da_))
        k3[rows, dmod] = dict(
            fwd=fwd_ms, chain=chain_ms, dh=dh_ms, lib_dh=lib_dh_ms,
            dh_plain=dh_plain_ms, fb=fb, db=db,
            dh_bytes_ms=nbytes(x_, w1, b1, da_, da_, da_) / PEAK_BYTES * 1e3)
        emit("kernel_time", kernel="fused_mlp and its dh",
             shape=f"R={rows} D={dmod} F={fdim}", dtype="bfloat16", gpu=gpu,
             forward_ms=fwd_ms, fc1_gelu_ms=fc1_ms, fc2_ms=fc2_ms,
             library_chain_ms=chain_ms, forward_bound_ms=fb[0],
             forward_host_us=fwd_host, dh_ms=dh_ms, dh_library_ms=lib_dh_ms,
             dh_bound_ms=db[0], dh_bound_by=db[1], dh_host_us=dh_host)
        del x_, w1, b1, da_, w2, b2, hidden, out2
        torch.cuda.empty_cache()
    dmod, fdim = xx.shape[1], ww.shape[0]
    big, small = k3[4 * 4096, 768], k3[4 * 2304, 768]
    entry("fused_mlp", mlp_cu, jax_ops + "fused_mlp.py:103",
          launches=serving_counts["fused_mlp"]
          + train_counts["launches"]["fused_mlp"],
          launches_serving=serving_counts["fused_mlp"],
          launches_training=train_counts["launches"]["fused_mlp"],
          kernel_launches_serving_packed=serving_mlp_kernel_launches,
          shape=shape, max_abs_err=errors["fused_mlp"],
          ms=big["fwd"], plain_ms=kernel_ms["fused_mlp"][1],
          bound_ms=big["fb"][0], bound_by=big["fb"][1],
          library_ms=big["chain"],
          library="bf16 F.linear -> F.gelu -> F.linear (three calls)",
          ms_r9216=small["fwd"], library_ms_r9216=small["chain"],
          bound_ms_r9216=small["fb"][0],
          r9216_over_r16384=small["fwd"] / big["fwd"],
          ms_phase5=kernel_ms["fused_mlp"][0],
          large_shapes=[dict(
              shape=f"R={rows} D={dmod} F={4 * dmod}", ms=r["fwd"],
              library_ms=r["chain"], bound_ms=r["fb"][0],
              bound_by=r["fb"][1], dh_ms=r["dh"],
              dh_linear_gelu_grad_ms=r["lib_dh"], dh_bound_ms=r["db"][0],
              dh_bound_by=r["db"][1])
              for (rows, dmod), r in k3.items() if rows == 4 * 2304
              and dmod > 768])
    entry("fused_mlp_backward_dh", mlp_cu, jax_ops + "fused_mlp.py:148",
          launches=train_counts["backward_launches"]["fused_mlp"],
          shape=shape, max_abs_err=bwd_err["K3_dh"], ms=big["dh"],
          max_abs_err_of="a, dh",
          max_abs_err_wrapper_gradients=bwd_err["K3_wrapper"],
          plain_ms=big["dh_plain"], bound_ms=big["db"][0],
          bound_by=big["db"][1], library_ms=big["lib_dh"],
          library="bf16 F.linear and the GELU-gradient product",
          bound_operations_ms=2 * 4 * 4096 * dmod * fdim / PEAK_FLOPS * 1e3,
          bound_bytes_ms=big["dh_bytes_ms"],
          ms_r9216=small["dh"], library_ms_r9216=small["lib_dh"],
          bound_ms_r9216=small["db"][0],
          r9216_over_r16384=small["dh"] / big["dh"])

    # ---- 9b. the f32 bodies beside their library calls ----------------------
    # K3's f32 GEMM body forward and dh at the shapes above, the f32
    # attention bodies (K1, K2, K4, K5, K6: the tile bodies) forward and
    # backward at the main paths' shapes, each in turns with its library
    # call (scripts/time_f32_kernels.py, which also times an older tree);
    # then the f32 ViT-B full-canvas forward at batch 4 (packed, golden
    # weights) under the profiler, with K3's share of its device time
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import time_f32_kernels

    f32_rows = {}
    for row in (*time_f32_kernels.k3_rows(
                    dev, F32_ITERS,
                    plain_for=time_f32_kernels.K3_SHAPES[:1]),
                *time_f32_kernels.attention_rows(
                    dev, F32_ITERS, plain_for=tuple(F32_BWD_MAIN.values())
                    + tuple(F32_WIN_MAIN.values())
                    + tuple(F32_WIN_144.items())
                    + tuple((kid, s) for kid, shapes in F32_WIN_D80.items()
                            for s in shapes) + (F32_K4, F32_K4_2304))):
        emit("f32_kernel_time", gpu=gpu, **row)
        f32_rows[row["kernel"], row["shape"]] = row
    f32_model = build(dataclasses.replace(base_cfg, dtype="float32"))
    with torch.inference_mode():
        f32_model(batches[0])                   # warm-up
        _, fwd_dev_ms, fwd_k3_ms, fwd_k3_share = device_ms_and_share(
            lambda: f32_model(batches[0]), K3_F32_KERNEL, calls=3)
    emit("f32_forward_device", gpu=gpu, config="vit_b f32 full canvas packed",
         batch=BATCH, device_ms=fwd_dev_ms, k3_ms=fwd_k3_ms,
         k3_share=fwd_k3_share)
    del f32_model
    torch.cuda.empty_cache()
    k3_row = f32_rows["K3", "R=16384 D=768 F=3072"]
    f32_cu = "wildlifemapper_tpu_torch/csrc/fused_mlp{}.cu"
    # the f32 body's entries of the "kernels" line, added after the later
    # phases' launch readings (which count by the bf16 entries' names)
    f32_report = {
        "fused_mlp_f32": dict(
            name="fused_mlp_f32", route="cuda", source=f32_cu.format(""),
            replaces=jax_ops + "fused_mlp.py:103", dtype="float32",
            shape="R=16384 D=768 F=3072", max_abs_err=errors["fused_mlp_f32"],
            ms=k3_row["forward_ms"], plain_ms=k3_row["forward_plain_ms"],
            bound_ms=k3_row["forward_bound_ms"],
            bound_by=k3_row["forward_bound_by"],
            library_ms=k3_row["library_chain_ms"],
            library="f32 F.linear -> F.gelu -> F.linear (three calls)",
            forward_device_ms_vit_b_batch4=fwd_dev_ms,
            k3_share_of_forward=fwd_k3_share),
        "fused_mlp_backward_dh_f32": dict(
            name="fused_mlp_backward_dh_f32", route="cuda",
            source=f32_cu.format("_bwd"),
            replaces=jax_ops + "fused_mlp.py:148", dtype="float32",
            shape="R=16384 D=768 F=3072",
            max_abs_err=bwd_err["K3_dh_f32"], max_abs_err_of="a, dh",
            ms=k3_row["dh_ms"], plain_ms=k3_row["dh_plain_ms"],
            bound_ms=k3_row["dh_bound_ms"], bound_by=k3_row["dh_bound_by"],
            library_ms=k3_row["dh_library_ms"],
            library="f32 F.linear and the GELU-gradient product")}
    # the f32 streaming backward of K2 and K5 (csrc/attention_bwd_f32.cuh):
    # its time, the tile body's and the plain version's at the main path's
    # full canvas, ViT-H's d 80 beside
    for wname, (kid, shape) in F32_BWD_MAIN.items():
        row = f32_rows[kid, shape]
        d80 = f32_rows[kid, F32_BWD_D80[kid]]
        if row["backward_body"] != "f32" or d80["backward_body"] != "f32":
            raise AssertionError(f"{kid}: f32 backward body "
                                 f"{row['backward_body']}")
        f32_report[wname + "_backward_f32"] = dict(
            name=wname + "_backward_f32", route="cuda",
            source=("wildlifemapper_tpu_torch/csrc/"
                    + ("grouped_" if kid == "K5" else "")
                    + "attention_bwd_f32.cu"),
            replaces=(jax_ops + "flash_attention.py:268" if kid == "K5" else
                      jax_ops + "flash_attention_v2.py:364, :392"),
            dtype="float32", shape=shape, kernels_per_backward=2,
            max_abs_err=bwd_err[f"{kid}_f32"], max_abs_err_of=(
                "dq, dk, dv, drel_h, drel_w through the wrapper, every f32 "
                "shape of phase 6 that takes the body"),
            ms=row["backward_ms"], earlier_body_ms=row["backward_tile_ms"],
            plain_ms=row["backward_plain_ms"],
            bound_ms=row["backward_bound_ms"],
            bound_by=row["backward_bound_by"],
            library_ms=row["backward_library_ms"],
            library="f32 autograd through scaled_dot_product_attention "
                    "with the bias as attn_mask (dq, dk, dv)",
            bit_identical=row["backward_bit_identical"],
            d80_shape=F32_BWD_D80[kid], d80_ms=d80["backward_ms"],
            d80_earlier_body_ms=d80["backward_tile_ms"],
            d80_bound_ms=d80["backward_bound_ms"],
            d80_library_ms=d80["backward_library_ms"])
    # the f32 window backward of K1 and K6
    # (csrc/attention_bwd_f32_window.cuh): its time, the tile body's and the
    # plain version's at the full canvas's windows, ViT-H's d-80 windows
    # beside (K1 at batch 1 and 4)
    for wname, (kid, shape) in F32_WIN_MAIN.items():
        row = f32_rows[kid, shape]
        d80 = [f32_rows[kid, s] for s in F32_WIN_D80[kid]]
        bodies = {r["shape"]: r["backward_body"] for r in (row, *d80)}
        if set(bodies.values()) != {"f32_window"}:
            raise AssertionError(f"{kid}: f32 backward body {bodies}")
        entry = dict(
            name=wname + "_backward_f32", route="cuda",
            source=("wildlifemapper_tpu_torch/csrc/"
                    + ("grouped_" if kid == "K6" else "")
                    + "attention_bwd_f32_window.cu"),
            replaces=(jax_ops + "windowed_attention.py:173" if kid == "K6"
                      else jax_ops + "windowed_attention_v2.py:260"),
            dtype="float32", shape=shape, kernels_per_backward=1,
            max_abs_err=bwd_err[f"{kid}_f32_window"], max_abs_err_of=(
                "dq, dk, dv, drel_h, drel_w through the wrapper, every f32 "
                "shape of phase 6 that takes the body"),
            ms=row["backward_ms"], earlier_body_ms=row["backward_tile_ms"],
            plain_ms=row["backward_plain_ms"],
            bound_ms=row["backward_bound_ms"],
            bound_by=row["backward_bound_by"],
            library_ms=row["backward_library_ms"],
            library="f32 autograd through scaled_dot_product_attention "
                    "with the bias as attn_mask (dq, dk, dv)",
            bit_identical=row["backward_bit_identical"])
        for tag, r in zip(("d80", "d80_batch4"), d80):
            entry.update({f"{tag}_shape": r["shape"],
                          f"{tag}_ms": r["backward_ms"],
                          f"{tag}_earlier_body_ms": r["backward_tile_ms"],
                          f"{tag}_bound_ms": r["backward_bound_ms"],
                          f"{tag}_bound_by": r["backward_bound_by"],
                          f"{tag}_library_ms": r["backward_library_ms"]})
        f32_report[wname + "_backward_f32"] = entry
    # K4's f32 body at d 128 both ways (csrc/attention_fwd_f32.cuh,
    # attention_bwd_f32_d128.cuh): its time, the tile body's and the plain
    # version's at the full canvas, the 48-grid (the from-scratch step's)
    # beside
    k4_rows = (f32_rows[F32_K4], f32_rows[F32_K4_2304])
    bodies = {r[w + "_body"] for r in k4_rows for w in ("forward", "backward")}
    if bodies != {"f32"}:
        raise AssertionError(f"K4: f32 bodies {bodies}")
    for way, src, where, err in (
            ("forward", "attention_fwd_f32.cu", "cross_attention.py:160",
             errors["cross_attention_packed_f32"]),
            ("backward", "attention_bwd_f32_d128.cu",
             "cross_attention.py:208, :227", bwd_err["K4_f32"])):
        row, row48 = k4_rows
        wname = "cross_attention_packed" + (
            "_backward" if way == "backward" else "") + "_f32"
        f32_report[wname] = dict(
            name=wname, route="cuda",
            source="wildlifemapper_tpu_torch/csrc/" + src,
            replaces=jax_ops + where, dtype="float32", shape=row["shape"],
            max_abs_err=err, max_abs_err_of=(
                "out (phase 2)" if way == "forward" else
                "dq, dk, dv through the wrapper (phase 6)")
            + ", every f32 shape that takes the body",
            ms=row[way + "_ms"], earlier_body_ms=row[way + "_tile_ms"],
            plain_ms=row[way + "_plain_ms"],
            bound_ms=row[way + "_bound_ms"], bound_by=row[way + "_bound_by"],
            library_ms=row[way + "_library_ms"],
            library="f32 scaled_dot_product_attention" + (
                "" if way == "forward" else ", autograd (dq, dk, dv)"),
            bit_identical=row[way + "_bit_identical"],
            n2304_shape=row48["shape"], n2304_ms=row48[way + "_ms"],
            n2304_earlier_body_ms=row48[way + "_tile_ms"],
            n2304_plain_ms=row48[way + "_plain_ms"],
            n2304_bound_ms=row48[way + "_bound_ms"],
            n2304_library_ms=row48[way + "_library_ms"])

    # the f32 forward of K2 and K5 (csrc/attention_fwd_f32.cuh at d 64 /
    # 80): its time, the tile body's and the plain version's at the full
    # canvas, the 48-grid and ViT-H's d 80 (batch 1) beside
    for wname, (kid, shape) in F32_BWD_MAIN.items():
        row = f32_rows[kid, shape]
        rows = {"n2304": f32_rows[kid, F32_FWD_2304[kid]],
                "d80": f32_rows[kid, F32_BWD_D80[kid]]}
        bodies = {r["forward_body"] for r in (row, *rows.values())}
        if bodies != {"f32"}:
            raise AssertionError(f"{kid}: f32 forward bodies {bodies}")
        entry = dict(
            name=wname + "_f32", route="cuda",
            source=("wildlifemapper_tpu_torch/csrc/"
                    + ("grouped_" if kid == "K5" else "")
                    + "attention_fwd_f32.cu"),
            replaces=(jax_ops + "flash_attention.py:230" if kid == "K5" else
                      jax_ops + "flash_attention_v2.py:199"),
            dtype="float32", shape=shape, max_abs_err=errors[wname + "_f32"],
            max_abs_err_of="out (phase 2), every f32 shape that takes the "
                           "body, the lse checked beside it",
            ms=row["forward_ms"], earlier_body_ms=row["forward_tile_ms"],
            plain_ms=row["forward_plain_ms"],
            bound_ms=row["forward_bound_ms"],
            bound_by=row["forward_bound_by"],
            library_ms=row["forward_library_ms"],
            library="f32 scaled_dot_product_attention with the bias as "
                    "attn_mask",
            bit_identical=row["forward_bit_identical"])
        for tag, r in rows.items():
            entry.update({f"{tag}_shape": r["shape"],
                          f"{tag}_ms": r["forward_ms"],
                          f"{tag}_earlier_body_ms": r["forward_tile_ms"],
                          f"{tag}_bound_ms": r["forward_bound_ms"],
                          f"{tag}_library_ms": r["forward_library_ms"]})
        f32_report[wname + "_f32"] = entry

    # the f32 forward of K1 and K6 (csrc/attention_fwd_f32_window.cuh): its
    # time, the tile body's, the plain version's, the library call's and the
    # bound at the full canvas's windows of 196, the from-scratch 144 and
    # ViT-H's d-80 windows (K1 at batch 1 and 4, K6 at batch 1) beside
    for wname, (kid, shape) in F32_WIN_MAIN.items():
        row = f32_rows[kid, shape]
        rows = {"n144": f32_rows[kid, F32_WIN_144[kid]]}
        rows.update({tag: f32_rows[kid, s] for tag, s in
                     zip(("d80", "d80_batch4"), F32_WIN_D80[kid])})
        bodies = {r["shape"]: r["forward_body"]
                  for r in (row, *rows.values())}
        emit("f32_window_forward_body", kernel=kid, bodies=bodies)
        if set(bodies.values()) != {"f32_window"}:
            raise AssertionError(f"{kid}: f32 window forward bodies {bodies}")
        entry = dict(
            name=wname + "_f32", route="cuda",
            source=("wildlifemapper_tpu_torch/csrc/"
                    + ("grouped_" if kid == "K6" else "")
                    + "attention_fwd_f32_window.cu"),
            replaces=(jax_ops + "windowed_attention.py:144" if kid == "K6"
                      else jax_ops + "windowed_attention_v2.py:227"),
            dtype="float32", shape=shape, max_abs_err=errors[wname + "_f32"],
            max_abs_err_of="out (phase 2), every f32 shape that takes the "
                           "body, the lse checked beside it",
            ms=row["forward_ms"], earlier_body_ms=row["forward_tile_ms"],
            plain_ms=row["forward_plain_ms"],
            bound_ms=row["forward_bound_ms"],
            bound_by=row["forward_bound_by"],
            library_ms=row["forward_library_ms"],
            library="f32 scaled_dot_product_attention with the bias as "
                    "attn_mask",
            bit_identical=row["forward_bit_identical"])
        for tag, r in rows.items():
            entry.update({f"{tag}_shape": r["shape"],
                          f"{tag}_ms": r["forward_ms"],
                          f"{tag}_earlier_body_ms": r["forward_tile_ms"],
                          f"{tag}_plain_ms": r["forward_plain_ms"],
                          f"{tag}_bound_ms": r["forward_bound_ms"],
                          f"{tag}_bound_by": r["forward_bound_by"],
                          f"{tag}_library_ms": r["forward_library_ms"]})
        f32_report[wname + "_f32"] = entry

    order = ["windowed_attention_packed", "windowed_attention_packed_backward",
             "windowed_attention_packed_backward_d80",
             "flash_attention_packed", "flash_attention_packed_backward_dq",
             "flash_attention_packed_backward_dkv",
             "flash_attention_packed_backward_d80", "fused_mlp",
             "fused_mlp_backward_dh", "cross_attention_packed",
             "cross_attention_packed_backward_dq",
             "cross_attention_packed_backward_dkv",
             "flash_attention_rel_pos", "flash_attention_rel_pos_backward_dq",
             "flash_attention_rel_pos_backward_dkv",
             "flash_attention_rel_pos_backward_d80",
             "windowed_attention_rel_pos",
             "windowed_attention_rel_pos_backward",
             "windowed_attention_rel_pos_backward_d80"]
    for e in report.values():
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']}: not launched on the main path")

    # ---- 10. the training loop on the card ----------------------------------
    loop_counts = loop_phase(gpu, golden_sd, reset_counts, all_counts,
                             per_step)
    grouped = ("flash_attention_rel_pos", "windowed_attention_rel_pos")
    for name, e in report.items():
        e["launches_loop"] = loop_launches(name, loop_counts)
        on_path = not name.endswith("_d80") and not name.startswith(grouped)
        if on_path and e["launches_loop"] <= 0:
            raise AssertionError(f"{name}: not launched on the loop's path")

    # ---- 11. serving surveys: .pth, orthomosaic, drift-as-mAP, native -------
    mosaic_counts = survey_phase(gpu, golden_sd, reset_counts, counts,
                                 per_forward)
    for name, e in report.items():
        e["launches_mosaic"] = forward_launches(name, mosaic_counts)
        on_path = not ("_backward" in name or name.endswith("_d80")
                       or name.startswith(grouped))
        if on_path and e["launches_mosaic"] <= 0:
            raise AssertionError(f"{name}: not launched on the mosaic's path")

    # ---- 12. the compat surface: predictor, export, operators ---------------
    compat_counts, compat_host = compat_phase(gpu, golden_sd, reset_counts,
                                              counts, per_forward)
    for name, e in report.items():
        e["launches_compat"] = forward_launches(name, compat_counts)
        on_path = not ("_backward" in name or name.endswith("_d80"))
        if on_path and e["launches_compat"] <= 0:
            raise AssertionError(f"{name}: not launched on the compat path")
    for name, kid in (("windowed_attention_packed", "K1"),
                      ("fused_mlp", "K3")):
        report[name]["host_us_compat"] = {
            k: compat_host[kid][k]
            for k in ("wrapper", "operator", "implementation", "dispatch")}
    # ---- 13. data parallel: torchrun, DDP at world 1, two ranks ------------
    # ---- 15. tensor parallelism: a model axis of two ranks ------------------
    # 15's ranks run beside 13's subprocesses, started once 13's timed steps
    # are done
    tp_started = []

    def tp_refs():
        """15's references in this process while the ranks run."""
        for started in tp_started:
            started["refs"] = tp_references(started, golden_sd,
                                            reset_counts, all_counts)

    try:
        dist_counts = distributed_phase(
            gpu, golden_sd, reset_counts, all_counts,
            alongside=lambda: tp_started.append(start_tp_phase(golden_sd)),
            while_waiting=tp_refs)
        for name, e in report.items():
            e["launches_dist"] = loop_launches(name, dist_counts)
            on_path = (not name.endswith("_d80")
                       and not name.startswith(grouped))
            if on_path and e["launches_dist"] <= 0:
                raise AssertionError(f"{name}: not launched on the "
                                     f"distributed path")
        tp_counts = tp_phase(gpu, golden_sd, reset_counts, all_counts,
                             tp_started[0] if tp_started else None)
    finally:
        for started in tp_started:
            started["workers"].stop()
    for name, e in report.items():
        e["launches_tp"] = tp_launches(name, tp_counts)
        on_path = not (name.endswith("_d80") and "rel_pos" in name)
        if on_path and e["launches_tp"] <= 0:
            raise AssertionError(f"{name}: not launched on the tensor-"
                                 f"parallel path")
    # ---- 14. the large encoders' training paths and the scripts -----------
    large_counts = large_phase(gpu, reset_counts, all_counts, per_step,
                               one_wait, step_parity, batch4)
    d64_grouped_backward = ("flash_attention_rel_pos_backward",
                            "windowed_attention_rel_pos_backward")
    for name, e in report.items():
        e["launches_large"] = large_launches(name, large_counts)
        on_path = (not name.startswith(d64_grouped_backward)
                   or name.endswith("_d80"))
        if on_path and e["launches_large"] <= 0:
            raise AssertionError(f"{name}: not launched on the large "
                                 f"encoders' path")
    for name, key in (("fused_mlp_f32", "forward"),
                      ("fused_mlp_backward_dh_f32", "dh")):
        f32_report[name]["launches"] = f32_k3[key]
        if f32_k3[key] <= 0:
            raise AssertionError(f"{name}: not launched on the f32 paths")
    for wname, n in f32_bwd.items():
        # one dq and one dk/dv launch a backward
        f32_report[wname + "_backward_f32"]["launches"] = 2 * n
        if n <= 0:
            raise AssertionError(f"{wname}: the f32 backward body was not "
                                 "launched on the f32 steps")
    k4_f32 = f32_report["cross_attention_packed_f32"]
    k4_f32["launches"] = f32_k4["forward"]
    k4_f32_bwd = f32_report["cross_attention_packed_backward_f32"]
    k4_f32_bwd.update(
        launches=f32_k4["backward_dq"] + f32_k4["backward_dkv"],
        launches_dq=f32_k4["backward_dq"],
        launches_dkv=f32_k4["backward_dkv"],
        launches_are=(
            "calls of the body's C entry, each counter as read: "
            "backward_dkv_launches (a call launches the delta kernel, then "
            "the dk/dv kernel) and backward_dq_launches (the dq kernel); "
            "kernel launches are dq + 2 x dkv"))
    for wname, n in (("cross_attention_packed_f32", f32_k4["forward"]),
                     ("cross_attention_packed_backward_f32 (dq)",
                      f32_k4["backward_dq"]),
                     ("cross_attention_packed_backward_f32 (dk/dv)",
                      f32_k4["backward_dkv"])):
        if n <= 0:
            raise AssertionError(f"{wname}: K4's f32 body was not launched "
                                 "on the f32 paths")
    for wname, n in f32_fwd.items():
        # the f32 forward of K2 / K5 and the f32 window forward of K1 / K6
        f32_report[wname + "_f32"]["launches"] = n
        if n <= 0:
            raise AssertionError(f"{wname}: its f32 forward body was not "
                                 "launched on the f32 paths")
    for wname, n in f32_win.items():
        # one launch a backward
        f32_report[wname + "_backward_f32"]["launches"] = n
        if n <= 0:
            raise AssertionError(f"{wname}: the f32 window backward body was "
                                 "not launched on the f32 steps")
    report.update(f32_report)
    order += list(f32_report)
    emit("script", seconds=time.perf_counter() - t_script, gpu=gpu)
    print(json.dumps({"kernels": [report[n] for n in order], "gpu": gpu}),
          flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2]))
    sys.exit(main())
