#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --int8-compare DIR   # K4 and int8 serving: DIR's checkout, then this

Builds the port's CUDA kernels from dmayolo_tpu_torch/csrc (one nvcc per
source, all at once), then:

1. K2 (greedy NMS, csrc/nms_greedy.cu) against its plain PyTorch version at
   the serving shape (128, 512) and on edge cases: clustered near-duplicates,
   equal-score ties, all-masked rows, a deep chain, K = 64 < max_det,
   K = 200 and 1024, the serving set shuffled (scores unsorted) and
   near-threshold pairs: keep_idx and keep_valid must be equal everywhere.
   Timed at (128, 512), and alone at (8, 1024).
2. K3 (fixpoint keep flags, csrc/nms_fixpoint.cu) against its plain
   version on the same candidate sets (K <= 512) and on a near-threshold
   set (pairs whose IoU falls within a few ulps of the threshold), in both
   comparison forms (inter / union > t and inter > t * union): the keep
   flags must be equal.  Timed at (128, 512), and in the divide form at
   (32, 512).  NMS kernels are timed as calls (`cuda_ms`) and alone
   (`graph_ms`: one call captured in a CUDA graph and replayed), since at
   these sizes a call's host work can take as long as its kernel.
3. K3's blocked entry (`fixpoint_keep_blocked`, the whole of
   `nms_matrix_blocked` in one launch) against its plain version on the
   K2-streaming sets at K = 1025, 4000 and 30,000 with max_det 20 and 300,
   and on a near-threshold set split across two blocks: keep flags, blocks
   walked, keep_idx and keep_valid equal.  `nms_matrix_blocked` runs once
   under `torch.cuda.set_sync_debug_mode("error")`: no host sync.  Timed at
   (32, 30000, 300), the bound counted from the blocks, pairs and cross
   tests that run's data needs.
   Then K2's streaming variant against the plain version: the cluster
   kernel on every streaming set (K = 1025, 4096 and 30,000, max_det 300,
   IoU 0.6), the global-memory kernel above the cluster's capacity (B = 2,
   K = 100,000), equal everywhere.  Timed at (32, 30000) on both kernels
   and on every cluster size that fits.
4. K1 (3x3 conv, csrc/conv3x3_s1.cu: wgmma and TMA, bf16 inputs as they
   are, f32 inputs as 3xTF32) against its plain version at four of the
   flagship's C3/SCConv shapes in f32 (|kernel - plain| <= 1e-4 (1 +
   |plain|), TF32 off; bound on the 3xTF32 rate) and bf16 (2e-2), the call
   and the kernel alone timed beside cuDNN (`F.conv2d`, the library
   yardstick only); untimed on ragged shapes in all four dtype pairs.
   Then at every 3x3 stride-1 conv shape of the flagship, found by forward
   hooks at bs128 640 px, at batch 128 in bf16: images 0-1 against the
   plain version, K1 and cuDNN timed, and both summed over one step's
   convs, each shape weighted by its count; and at batch 2 in f32,
   untimed.
5. The serving main path: the full-width flagship (nc 10, seeded random
   weights with the head priors, BN statistics calibrated on two random
   images) behind `MicroBatcher` (640 px, bf16), 8 requests of different
   native sizes from several threads, once with NMS backend "pallas" (K2)
   and once with the default backend, "matrix" (K3).  Launch counters are
   zeroed just before each and read just after; K2, then K3, must have
   launched.  Then one batch of 32 at conf 0.0, where all 512 candidates
   per image are live, through the three NMS backends: the detections must
   be identical.  A small f32 input must give the same raw head on the
   card as on the CPU.  Last, bs128 640 px serving is timed with CUDA
   events for "pallas" and "matrix", and one step of each is profiled by
   kernel.
6. The eval protocol: the same weights (unfolded), a batch of 32 640 px
   images of filled rectangles drawn from a numpy seed, with their labels
   as targets, through `make_infer_fn` (bf16, conf 0.001, IoU 0.6,
   multi-label, max_det 300, max_nms 30,000) on the backends "pallas"
   (K2 streaming on a cluster), "matrix" (K3's blocked entry, one launch)
   and "scan".  Counters are zeroed before each and read after; the valid
   detections must be identical across the three.  The detections go through the
   validator's host helpers to P, R, mAP@.5 and mAP@.5:.95 (near zero
   with random weights: the plumbing is what is checked).  The step is
   timed by part (forward, candidate top-k, NMS per backend), and one TTA
   batch of 8 runs.
7. The training path (no kernel of K1-K3 on it; convs through cuDNN by
   autograd): the full-width flagship (nc 10, `init_with_priors` from a
   seeded generator) takes one SGD step at batch 2, 640 px, f32 with TF32
   off, on the card and on the host CPU from the same weights and batch:
   loss and items, every gradient and every updated parameter must agree
   (`TRAIN_F32_TOL`); the same step in bf16 must give the f32 loss within
   `TRAIN_BF16_LOSS_TOL`, and each conv's and BN's backward in it must
   match its formula in f32 on the layer's own operands
   (`TRAIN_BF16_LAYER_TOL`; the whole step's bf16 grads are read, not
   held: at random init the train-mode forward amplifies rounding), while
   a control with the BN backward computed in bf16 must fail that check.
   Then the author's recipe (train.sh:5-9: 1536
   px, batch 4, Adam, hyp VisDrone, 128 target rows, bf16 over f32 master
   weights, no remat) through the port's `Trainer` over one epoch of 16
   in-memory batches of filled rectangles: every loss finite, optimizer
   steps and EMA updates equal to the reference's cadence.  Train img/s
   from CUDA events over the 14 batches after 2 warm-up, peak memory, ms
   per optimizer step at accumulate 1 and 16, one step profiled by group.
   Last, the EMA checkpoint the Trainer wrote (`last.npz`) is read back
   with `load_jax_checkpoint`: every tensor must be the EMA's rounded to
   f16, and the model on it must give the EMA's raw head within
   `TRAIN_CKPT_HEAD_TOL` (train-mode BN), which a control with the 3x3
   kernels transposed must exceed.  Then fused and served one batch on
   "matrix" at a conf below every image's best score: K3 must launch, and
   the detections be non-empty and equal to the plain "scan" backend's.
7b. The JAX package's Orbax checkpoint (`orbax_phase`, inside 7 after
   its timed steps; `utils/orbax_ckpt.py`, without orbax or tensorstore,
   zstd through the system's libzstd): the recipe Trainer's full state
   (`state_trees`: params, stats, their EMA, both optimizer moments; 78.26
   M parameters a model tree) written by the port's
   `AsyncTrainCheckpointer` into build/orbax_smoke/ (the call and the
   write until `wait` timed) and restored onto the card (timed; GB/s of
   the raw trees), every leaf equal to the last bit; the model built from
   the restored meta and EMA trees, BN-folded, serving one bs128 640 px
   bf16 batch on "matrix" (K3
   counted) with the same detections as the in-memory EMA model; then
   the JAX package's own save committed in tests/fixtures/orbax_jax_tiny
   (8-device mesh, chunked, zstd) read onto the card equal to its
   `expected.npz`.  A crc, zstd or shape error fails the run.
8. The SPD-Conv family on four scales (P2-P5, strides 4-32): C3CASPD2
   (anchor-based Detect, its `anchors: 4` placeholders replaced by
   autoanchor on the labels of seeded rectangle images) and CASPD_ODRTA
   (anchor-free TDetect with DFL), full width at depth 0.33
   (`EARLIER_DEPTH`), nc 10, built as the flagship is.  Each is served as in 5 (K2, then K3 counted; TDetect's
   serving tails counted on the lazy route, `decode_topk` then
   `nms_from_topk`, every Detect tail on the eager one), its three
   serving tails identical at conf 0.0, its raw head on the card within
   1e-3 of the CPU's, bs128 timed and profiled; evaluated as in 6 (one TTA
   batch of 8 for TDetect); and trained at the author's recipe through the
   `Trainer` over 5 in-memory batches (img/s over the last 3, ms per
   optimizer step at accumulate 1, peak memory, one step profiled):
   C3CASPD2 at train.sh:10-13 (1024 px, batch 8, Adam, hyp scratch,
   autoanchor), CASPD_ODRTA at train.sh:15-19 (1536 px, batch 4, Adam, hyp
   VisDrone, TAL), whose f32 step at batch 2, 640 px is held against the
   host CPU's as in 7, on the CPU step's assignment (`ReplayedAssignment`),
   its grads and parameters within `TRAIN_F32_NOISE_FACTOR` times the
   CPU's own one-thread noise where that exceeds `TRAIN_F32_TOL`.  Each
   trained checkpoint is checked and served on "matrix" as in 7.  Last, K1 at every 3x3 stride-1 conv shape of both
   models at bs128 640 px bf16, as in 4, each model's count-weighted sum
   beside cuDNN's and the bound.

9. The data path on disk, without OpenCV (the port's own image library,
   built with g++ at first use), after a probe of what the host offers
   it (image modules found, not imported; JPEG, PNG and zlib headers and
   libraries; nvJPEG; g++): the port's generator writes a
   VisDrone-analog set at 1536 px (64 train and 64 val images, JPEG at
   quality 85 through the machine's JPEG route: nvJPEG on the card) under
   build/data_smoke/ (removed at the end); the val passes read each val
   file through 5 symlinked copies (320 images, 10 batches of 32), so
   that 8 loader threads, each taking a whole batch, stay busy.  The
   loader alone: decode ms, img/s at 1 worker (to the last batch's
   arrival) and at min(8, cpu_count) workers (the whole pass, and after
   the first round of batches) for the val pipeline (letterbox to 640,
   bs32) and the train one (hyp VisDrone at 1536 px, bs4), the batches
   the same bytes at both; the val targets mapped back to native pixels
   equal the label files' boxes within 1e-3 px; `build_coco_gt_from_yolo`
   on the val set, its annotations fed back as detections: COCOeval's mAP
   1.0.  Then the val labels are rewritten as the flagship's own top 20
   detections an image, and `run_validation` of the flagship (as in 5)
   at bs32 640 px runs on "scan", "matrix" and "pallas", counted: mAP@.5
   strictly between 0 and 1, the metrics identical across the three,
   K3's blocked entry once a batch on "matrix", K2's cluster kernel once
   a batch on "pallas", img/s of the whole run beside the device step
   alone of 6.  The train loader at 1 thread over 1 batch with the
   VisDrone hyp and with `clahe: 1.0` added (CLAHE's cost an image).
   12 val files written as BMP, LZW TIFF (by the port), their JPEG
   under EXIF orientations 3, 6 and 8 (labels turned into the rotated
   frame), lossless webp (two) and q80 webp (one, through cv2's libwebp)
   and a DNG whose IFD0 is the RGB image, beside the same decoded arrays
   as PNG: `run_validation` on "matrix" over both (K3's blocked entry
   once; the same txt rows and metrics), and `cli.detect` at 1536 px over
   the copies but the DNG (detect takes no `.dng` from a folder, as JAX's)
   against `serve_detections` of the same arrays (the same label lines;
   K3 counted; its images written under their own names and formats).
   Then the recipe's `Trainer` built from a data yaml (1536
   px, bs4, Adam, hyp VisDrone, one epoch of 64 batches over the train
   files read 4x at accumulate 4, validated on 32 val images), with device_aug off
   (on is the CLI phase's `--device-aug` run), from the eval weights as
   `pretrained` and validated on its
   EMA's own detections written as the val labels (a fresh init scores
   under the conf gate and keeps no best.npz): finite losses, validation
   at the epoch's end, last.npz and best.npz and the CSV's metrics; img/s
   over batches 8-31 unprofiled (after the fill and the first two
   optimizer steps, while the loader still works), with the time the
   loop waited for the loader and the rate at which the loader made
   samples, and the device's busy share over batches 32-39 under
   torch.profiler;
   best.npz served on
   "matrix", K3 counted.  Last, device_aug on the card against its CPU
   version on the same batch, gains and flips (1e-5).
10. The zoo (`zoo_phase`, run between 8 and 9): the whole DMA-YOLO, `yolov5l-ca-sppfcspc-
   bifpn-scconv` (DMA-full: the flagship's backbone, BiFPN AdConcat2/3 in
   the neck, C3STR Swin stacks on P3-P5), TPH-YOLOv5, `yolov5l-xs-tph`
   (C3STR on P2-P5), DMA-HorNet, `ca-sppfcspc-bifpn-scconv-adapt-hornet`
   (DMA-full with C3HB HorNet stacks in place of the Swin ones), CADMM
   (DMMConv downsampling, C3CA on P2-P5) and ghostnet (C3GhostV2 with the
   DFC bilinear gate on P2-P5), full width at depth 0.33, nc 10, built as
   the flagship is, `anchors: 4` placeholders replaced by autoanchor.  Each is served as
   in 5 (K2, then K3 counted), its three serving tails identical at conf
   0.0, its raw head on the card within 1e-3 of the CPU's at 256 px, bs128
   timed and profiled (kernel groups, and the profiler ranges "attention",
   "layernorm"/"gelu"/"window shuffle", "depthwise conv", "gnconv" and
   "horblock" of the port); and evaluated as in 6 with one TTA batch of 8.
   DMA-full and DMA-HorNet are trained at the flagship's recipe
   (train.sh:5-9) through the `Trainer` over 5 in-memory batches, as the
   SPD models are, each checkpoint served on "matrix"; `TrainProbe` checks
   that every BiFPN `w` moved, that the frozen parameters (the Swin bias
   tables, HorBlock's LayerScale gammas) did not and every gamma stayed
   at its 1e-6 init, that each DropPath above rate 0 (DMA-full's P5
   stack: 512 hidden channels, 16 heads, 0.1) ran in train mode and
   dropped samples, and that one generator seed gives one loss.
11. The sweep (`sweep_model`, after 10): the other 22 yamls that came
   with DMA-HorNet (the DM/SM downsamplers, HorNet, ConvMixer, the
   adaptive fusions, Ghost v1, yolov3-tiny), each at full width, depth
   0.33, nc 10,
   built on the card as in 10, BN calibrated and folded, one bs8 640 px
   bf16 batch served through `MicroBatcher`'s step on "matrix" (K3
   counted: one launch), and its f32 raw head at 256 px on the card
   within 1e-3 of the CPU's; parameters, peak memory and seconds printed.

12. The CLIs (`cli_phase`, after 9, on its files): `cli.model` (the
   flagship's layer table, 78.26 M parameters at nc 10, GFLOPs at 640
   px; then its per-layer profile at bs128 640 px bf16 fused, 3
   iterations a prefix, the five slowest layers printed); `cli.train` at
   the author's recipe (train.sh:5-9: 1536 px, bs4, Adam, hyp VisDrone,
   --fastload --device-aug --remat) from the eval weights on the 64 train
   files, validated on 16 val files labelled with the EMA's own
   detections, stopped after its first epoch (as a kill between epochs
   would) and `--resume`d for the second: the resumed run continues the
   step count and `main` returns the fitness best.npz records; remat's
   1536 px bs4 bf16 step against the plain one from one state (grads and
   BN statistics within `REMAT_TOL` or twice the plain step's own spread;
   peak GiB of both, remat's not larger; ms a step); `--batch-size -1` at
   the recipe, probed at accumulate 1 against the card's memory budget
   (the probe ladder, the chosen batch, and one real step at it, at the
   recipe's accumulate, peaking under 0.9 of the budget); `cli.val` at the author's eval
   recipe (val.sh:4-6: 1996 px, rounded to 2016, TTA, bs8, --save-txt
   --save-conf --verbose) on the first 32 val files from the trained best.npz,
   then `--save-json` on "scan" and one run each on "pallas" and "matrix"
   at 1536 px on the first 32 (each run's img/s for the whole run and
   after its first batch; counted: K2's cluster kernel and K3's blocked entry once a
   batch; the three backends' label files identical); last, best.npz
   written as the reference's own `.pt` (stub classes, f16, EMA and
   model, its anchors x1.3) and loaded through
   `load_model_from_checkpoint`: one served batch on "matrix" (K3
   counted) equal to the `.npz` path's with the anchors swapped.

0. JPEG (`jpeg_phase`, right after the build): this machine's JPEG route
   (`imageio.jpeg_codec()`; nvJPEG on the card, whose machine has no
   libjpeg) decodes every fixture of tests/torch_data/jpeg (baseline 4:2:0
   and 4:4:4, grey, progressive, restart markers, 37x23, a 1536x864
   VisDrone-analog frame at q85) against libjpeg's pixels (pixels.npz):
   max and mean |difference| and the share over 2 levels, within
   `JPEG_BOUNDS` (the two libraries upsample 4:2:0 chroma differently);
   the frame's decode time beside PNG's of the same pixels; the encoder's
   q95 round trip (PSNR at least `JPEG_PSNR_MIN`).  The fixtures of
   tests/torch_data/formats (BMP, TIFF, PNG with eXIf: cv2's pixels
   exactly; JPEG under EXIF orientations 1-8 and an MPO: through this
   route within the 4:2:0 bounds, at the rotated shape; `image_shape`
   of each).  The data phase (9) writes its sets as JPEG through the
   same route and times PNG beside it.
13. The inference tools (`tools_phase`, after 12, on its files): on the
   CLI phase's trained flagship (its EMA `last.npz`) over 32 of the 64
   val JPEGs, `cli.detect` at 1536 px bs16 (conf 0.25, max_det 1000,
   --save-txt --save-conf --save-crop): img/s of the run and after its
   first batch, K3's blocked entry counted once a batch and held against
   its plain version on the run's own first (16, 30,000) candidates at
   max_det 1000 (timed, with its bound), the labels equal to
   `serve_detections` of the same batches; the frame decoded by nvJPEG
   and by libjpeg served to the same detections; `--augment` on 2
   files; `cli.export --include torch_export npz torch` at bs2, detect on
   the `.pt2` on 2 files (equal to its model's decode through `batched_nms`; the
   exported program equal to the model), the `.pt` loaded back to the
   same weights and the fused `.npz` to the same head; video
   (`video_checks`): 12 val files letterboxed to 1920x1080 into an `mp4v`
   clip (OpenCV's codec, as the JAX CLI's), `cli.detect --source
   clip0.mp4` (each model input the letterbox of the decoded frame, each
   frame's detections the same sets as `serve_detections` of it at batch
   1, K3 once a frame and held against its plain version on frame 0's
   (1, 30,000) candidates, `clip0_det.mp4` read back with 12 frames; FPS
   and ms a frame by part after the first frame), then three such clips
   as a `.streams` list, the reads paced against the steps so that both
   runs serve exactly 8 steps of 3 frames, on the native model (K3 once
   a step) and through the `.pt2`, whose batch 2 the CLI chunks and pads
   to (aggregate FPS after the first step); `hub.load`, `AutoShape` on 2
   files, `Detections.crop`, `save`, `tolist`; the REST
   server on 127.0.0.1 (`--batch-serve 16`, 640 px): 16 concurrent JPEG
   uploads through `example_request.detect` against the batcher called
   directly (p50, p99, the batch histogram), a few per request against
   `AutoShape`, an undecodable upload a 400; `cli.gradcam` on 1 image at
   640 px for `model_17_cv3_act`, both methods, in f32 with TF32 off,
   the first CAM against the host CPU's (`CAM_TOL`); `cli.wbf` over the
   detect run's labels and a second run's at 1280 px, on 2 files.

14. int8 PTQ (`int8_phase`, after 7): K4 (csrc/conv_int8.cu: routes (a)
   1x1, (b) 3x3 stride 1 and (c) 3x3 stride 2 on wgmma s8 with TMA loads
   and the bf16 input quantized in the kernel, (d) every other geometry
   on mma.sync after `quantize_s8`) against the plain versions at every
   int8-eligible conv shape (one group, C1 >= 16, not DFL) of the
   flagship, yolov5s and C3CASPD2 at bs8 640 px, found by forward hooks
   on the meta device, at CASMM's route-(d) shapes (5x5), and at
   off-model shapes (`INT8_OFF_MODEL`: each route's edges; a 1x1 conv
   whose s32 sums sit above 2^24 at double-rounding points): x_q from
   bf16 and f32, and both entries (`conv_int8` on s8, `quantize_conv_int8`
   on bf16 and f32) to the s32 sums and the f32 and bf16 outputs, at max
   |err| 0; at the flagship's and CASMM's bs8 shapes timed beside the
   plain versions.  K4 timed at the flagship's and yolov5s's bs128 step
   shapes (the bf16 call as served and its kernels alone, cuDNN's bf16
   conv and, for the 1x1 convs that `torch._int_mm` takes, `_int_mm` on
   the same s8 product beside the route's s8 form and the quantize that
   input needs), count-weighted over a step and by route, the bound the
   sum of each conv's own (int8 rate, bf16 input read once, no s8 copy,
   on every route).  Then int8 serving as
   bench.py:188-270 times it: each model calibrated on 8 random 640 px
   images at f32, bs128 bf16 on "matrix", driven once counted (each conv
   once on its route, the quantize only where a route does not quantize
   itself, K3 once), timed beside bf16 in turns and both steps profiled;
   the flagship's f32 int8 raw head on the card against the host CPU's
   (`INT8_HEAD_TOL`, which the card's float head must fail); CASMM served
   int8 once at bs8, so that route (d) runs on a main path.
   Last, the tiny model trained as tests/test_int8_serve.py trains it
   but for 28 epochs, not 32 (256 px, f32): int8 mAP@.5 within 0.05 of
   float at f32 and
   bf16 (counted), and `cli.val --int8 --ncalib 8` on its checkpoint.
   The CLI phase (12) runs its train recipe with `--ckpt-async`, holds
   `results.csv`'s header to the JAX trainer's columns, and times one
   epoch's save and train steps with synchronous and async saving.
15. Data parallelism (`dist_phase`, after 13, on 9's files;
   `parallel/mesh.py`): the flagship's f32 step (batch 2, 640 px, TF32
   off) through the data-parallel step at world 1 over NCCL in this
   process, and at world 2 over gloo in two spawned ranks on cuda:0, one
   image each (NCCL refuses two ranks on one card), each against the
   plain step on the card within `TRAIN_F32_TOL` (loss and items, every
   gradient, every updated parameter, the BN buffers); the flagship
   recipe's step (1536 px, bs4, Adam, bf16) through the `Trainer` on the
   world-1 group beside the plain `Trainer`, ms a step in turns, one step
   of each profiled (NCCL kernels, all-reduce calls, host syncs), and a
   BN-width all-reduce's host cost; `run_validation` on 48 of the data
   phase's val files on "matrix" at world 2 (each rank counting K3) and
   at world 1 with the same 16 images a forward: the same detection sets
   (`same_sets`) and P, R and mAP within `DIST_EVAL_TOL`; `cli.train` for
   two steps under `python -m torch.distributed.run --standalone
   --nproc-per-node 1`, beside the world-2 ranks; `evolve` for 2
   generations (the tiny model, f32, 640 px, one epoch of 8 train files
   from a checkpoint whose own detections label 8 val files) in the
   world-2 ranks and at world 1: the same hyps on every rank as world 1,
   the fitness within `DIST_EVAL_TOL` and above 0, `evolve.csv` written
   once.  A rank that fails fails the run.
16. The spatial H-sharding (`spatial_phase`, after 15, on 9's files;
   `parallel/spatial.py`): the full-width flagship at 1 data x 2 spatial
   over gloo, both ranks on cuda:0 (a correctness check of full-width
   shapes and the kernels, not a speed figure), against world 1 in this
   process on the same inputs, every pass counted: the eval protocol on
   two 1536 px images in bf16 on "matrix" (K3's blocked entry in each
   rank) and "pallas" (K2's cluster kernel), each rank's peak memory
   beside world 1's, the halo exchanges of a forward beside the yaml's
   count of ops that read along H, the detection sets within world 1's
   own bf16 noise (each image alone against the pair) plus
   `SPATIAL_BF16_BAND`, and the bf16 raw head of one image beside world
   1's own bf16 noise; in f32 (TF32 off) the same detection sets
   (`same_sets`) on "matrix", the raw head of one image
   (`SPATIAL_HEAD_TOL`), TTA on one image (its 0.67 scale: 1029 rows
   padded to 1056, split unevenly from P4 down) and
   `run_validation(spatial=True)` on 32 of 9's val files at 640 px,
   labelled with world 1's own f32 detections (the same detection sets,
   file by file, and P, R and mAP within `DIST_EVAL_TOL` or one label's
   share; world 1's own metric move under a 1e-7 change of its weights
   printed beside them); int8 eval (bf16, world 1's scales)
   on one image: the same detection sets, K4 on world 1's routes, and
   every int8 conv whose input rows equal world 1's gives equal output
   rows (exact checksums); the f32 step at 640 px, two images, through
   the H-sharded step against the plain one within `TRAIN_F32_TOL`, the
   plain step's own move under a 1e-7 change of its weights printed
   beside it.

Every phase's seconds are printed before the kernels line.
Prints, before the last line, a `{"kernels": [...]}` JSON line and the
card's name and power limit from nvidia-smi; the last line is
`{"ok": true, "device": {...}}`.  Exits non-zero, printing no result, when
there is no CUDA device, when the port's package is missing, or when any
check fails.  Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peak rates of one H100 SXM (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
# f32 outside the tensor cores; "tf32x3": f32 products as three TF32
# products each (K1's f32 route), a third of the dense TF32 rate
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 494.7e12 / 3, "int8": 1979e12}

FLAGSHIP = "ablation-ca-scconv-sppfcspc"
K1_SHAPES = [(8, 320, 320, 64, 64), (8, 80, 80, 128, 128),
             (8, 40, 40, 256, 256), (8, 20, 20, 512, 512)]
# ragged tiles, channel tails and C2 beyond one 64-channel block
K1_RAGGED = [(2, 37, 53, 12, 70), (1, 5, 3, 3, 130), (3, 17, 16, 64, 64)]
K1_TOL = {"f32": 1e-4, "bf16": 2e-2}
# kernel-name marks that sort the serving profile into groups; first match wins
PROFILE_GROUPS = [
    ("nms_greedy (K2)", ("nms_greedy",)),
    ("nms_fixpoint (K3)", ("nms_fixpoint",)),
    ("int8 conv (K4)", ("conv_int8_kernel", "conv_int8_wgmma_kernel")),
    ("int8 quantize (K4)", ("quantize_s8_kernel",)),
    ("conv and matmul (cuDNN, cuBLAS)", ("xmma", "fprop", "cutlass", "nvjet", "gemm", "conv")),
    ("top-k and sort", ("topk", "sort", "Radix", "radix")),
    # the broadcast bias add after each of the 120 folded convs
    ("conv bias add (non-vectorized elementwise)", ("elementwise_kernel<128, 4",)),
    ("silu", ("silu",)),
    ("sigmoid", ("sigmoid",)),
    ("upsample", ("upsample",)),
    ("max pool", ("max_pool",)),
    ("concat", ("CatArray",)),
]
# profiler ranges of nn/transformer.py (device time of the kernels inside),
# an overlay on the groups above
PROFILE_RANGES = [("attention matmuls and softmax", ("attention",)),
                  ("LayerNorm / GELU / window shuffles", ("layernorm", "gelu", "window shuffle")),
                  # nn/primitives.py's Conv2d, nn/hornet.py; a HorBlock holds a GnConv,
                  # which holds a depthwise conv
                  ("depthwise convs", ("depthwise conv",)),
                  ("GnConv", ("gnconv",)),
                  ("HorBlock (GnConv included)", ("horblock",)),
                  # nn/primitives.py's Conv2d on the int8 path: K4 and the quantize
                  ("int8 convs (K4 and its quantize)", ("int8 conv",))]
# every record_function name of the port (nn/transformer.py, nn/primitives.py,
# nn/hornet.py, train/step.py)
RANGE_KEYS = {k for _, keys in PROFILE_RANGES for k in keys} | {"loss", "optimizer", "ema"}
NATIVE_SIZES = [(1080, 1920), (375, 500), (480, 640), (720, 1280),
                (640, 640), (100, 100), (1000, 300), (333, 777)]
STREAM_KS = (1025, 4096, 30000)  # K2 streaming: just past one block, to the eval's max_nms
STREAM_BIG = (2, 100000)  # above what a cluster of 8 blocks holds: the global kernel
BLOCKED_KS = (1025, 4000, 30000)  # K3's blocked entry: two blocks, eight, the eval's 59
BLOCKED_MAX_DETS = (20, 300)  # a stop in the first block or two, and the eval's
# the eval protocol's defaults (dmayolo_tpu_torch/eval/validator.py)
PROTOCOL = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000)
EVAL_BACKENDS = ("pallas", "matrix", "scan")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


class Counter:
    """A launch count kept on a kernel wrapper under another attribute
    than `launches`, read and zeroed as the wrappers' own counts are."""

    def __init__(self, fn, attr, name):
        self.fn, self.attr, self.__name__ = fn, attr, name

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def bound(nbytes, ops, kind):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters, warmup=1):
    """Mean device time of fn() in ms, by CUDA events around `iters` runs."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Device time of fn() in ms without the host's share: one call
    captured in a CUDA graph, the graph replayed `iters` times between
    events (the calls of `cuda_ms` at small sizes time the host)."""
    import torch

    fn()  # builds, plans and allocator pools before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


# ---------------------------------------------------------------------------
# K2: greedy NMS
# ---------------------------------------------------------------------------

def nms_cases(device, b=128, k=512, seed=0):
    """(name, boxes, scores, max_det, iou_thres) candidate sets."""
    import torch

    from dmayolo_tpu_torch.core.nms import MAX_WH, NEG_INF

    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g)

    cls = torch.randint(0, 10, (b, k), generator=g).float()
    xy = rand(b, k, 2) * 600
    boxes = torch.cat([xy, xy + 8 + rand(b, k, 2) * 150], -1) + cls[..., None] * MAX_WH
    scores = rand(b, k)
    scores[scores < 0.2] = NEG_INF
    scores = scores.sort(dim=1, descending=True).values  # rank-sorted, as top-k gives
    cases = [("random", boxes, scores, 300, 0.45)]

    centres = rand(b, 8, 2) * 500
    pick = torch.randint(0, 8, (b, k), generator=g)
    c = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) + torch.randn(b, k, 2, generator=g) * 3
    wh = 40 + rand(b, k, 2) * 20
    cases.append(("clustered", torch.cat([c - wh / 2, c + wh / 2], -1),
                  rand(b, k).sort(dim=1, descending=True).values, 300, 0.45))

    ties = (rand(b, k) * 6).round() / 6
    ties[ties < 0.1] = NEG_INF
    cases.append(("ties", boxes, ties, 300, 0.45))

    masked = scores.clone()
    masked[::3] = NEG_INF  # every third image has no live candidate
    cases.append(("masked_rows", boxes, masked, 300, 0.45))

    i = torch.arange(k, dtype=torch.float32)
    chain = torch.stack([i * 5, torch.zeros(k), i * 5 + 10, torch.full((k,), 10.0)], -1)
    cases.append(("chain", chain[None].repeat(4, 1, 1),
                  torch.linspace(1, 0.5, k)[None].repeat(4, 1), 300, 0.3))
    cases.append(("k64", boxes[:, :64].contiguous(), scores[:, :64].contiguous(), 300, 0.45))
    cases.append(("k77", boxes[:8, :77].contiguous(), scores[:8, :77].contiguous(), 100, 0.45))
    cases.append(("k200", boxes[:8, :200].contiguous(), scores[:8, :200].contiguous(), 300, 0.45))
    # the most one block holds: more candidates than threads
    big = torch.cat([boxes[:8], boxes[:8] + 3], 1)
    cases.append(("k1024", big, torch.cat([scores[:8], scores[:8]], 1), 300, 0.45))
    return [(n, bx.to(device).contiguous(), sc.to(device).contiguous(), md, t)
            for n, bx, sc, md, t in cases]


def check_nms(device):
    """K2 against its plain version on `nms_cases`, near-threshold pairs and
    the random set shuffled (scores unsorted); timed at (128, 512), and
    alone at (8, 1024)."""
    import torch

    from dmayolo_tpu_torch.core.nms_kernel import nms_greedy, nms_greedy_plain

    out = {"cases": {}, "max_abs_err": 0.0}
    cases = nms_cases(device)
    name, boxes, scores, max_det, thr = cases[0]
    g = torch.Generator().manual_seed(8)
    perm = torch.stack([torch.randperm(boxes.shape[1], generator=g)
                        for _ in range(boxes.shape[0])]).to(device)
    cases.append(("shuffled", boxes.gather(1, perm[..., None].expand(-1, -1, 4)).contiguous(),
                  scores.gather(1, perm).contiguous(), max_det, thr))
    cases.append(("near_threshold", *near_threshold_case(device, 0.45), 300, 0.45))
    for name, boxes, scores, max_det, thr in cases:
        pi, pv = nms_greedy_plain(boxes, scores, thr, max_det)
        ki, kv = nms_greedy(boxes, scores, thr, max_det)
        same = torch.equal(ki, pi) and torch.equal(kv, pv)
        out["cases"][name] = {"picks": int(kv.sum()), "equal": same}
        # largest difference of keep_idx or keep_valid anywhere
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((ki.long() - pi.long()).abs().max()),
                                 float((kv.long() - pv.long()).abs().max()))
        check(same, f"K2 differs from its plain version on case '{name}'")
    name, boxes, scores, max_det, thr = cases[0]
    b, k, _ = boxes.shape
    kv = nms_greedy(boxes, scores, thr, max_det)[1]
    picks = int(kv.sum())
    # data-dependent work: each pick is one argmax over K and one IoU
    # against K candidates (~15 flops a candidate); each input read once
    ops = picks * k * 15
    nbytes = b * k * (16 + 4) + b * max_det * (4 + 1)
    out.update(shape=[b, k, max_det], picks=picks, ops=ops, bytes=nbytes)
    if device.type == "cuda":
        out["ms"] = cuda_ms(lambda: nms_greedy(boxes, scores, thr, max_det), 20)
        out["kernel_ms"] = graph_ms(lambda: nms_greedy(boxes, scores, thr, max_det), 20)
        out["plain_ms"] = cuda_ms(lambda: nms_greedy_plain(boxes, scores, thr, max_det), 3)
        out["bound_ms"], out["bound_by"] = bound(nbytes, ops, "f32")
        # the most one block holds: eight slots a lane
        _, bx, sc, md, t = next(c for c in cases if c[0] == "k1024")
        out["k1024_kernel_ms"] = graph_ms(lambda: nms_greedy(bx, sc, t, md), 20)
    return out


# ---------------------------------------------------------------------------
# K3: fixpoint keep flags
# ---------------------------------------------------------------------------

def near_threshold_pairs(n, thr, phase=0):
    """n pairs (A_p, B_p) of 10 x 10 boxes, B_p shifted along x so that
    their IoU in f32 falls within a few ulps of `thr`: the shift steps
    through consecutive f32 values around 10 (1 - t) / (1 + t), +-16 ulps
    for half the pairs (IoU within ~16 ulps of t, some exactly at it) and
    +-80 for the rest (past the band in which K3's divide form divides).
    The pairs sit 20 px apart in y: no two overlap.  Returns A, B (n, 4)."""
    import numpy as np
    import torch

    i = np.arange(n)
    step = np.where(i < n // 2, (i + phase) % 33 - 16, (i + phase) % 161 - 80)
    base = np.array([10 * (1 - thr) / (1 + thr)], np.float32).view(np.int32)
    d = (base.astype(np.int64) + step).astype(np.int32).view(np.float32)
    y = (20 * i).astype(np.float32)
    a = np.stack([np.zeros(n, np.float32), y, np.full(n, 10, np.float32), y + 10], -1)
    b = np.stack([d, y, d + np.float32(10), y + 10], -1)
    return torch.from_numpy(a), torch.from_numpy(b)


def near_threshold_case(device, thr, b=4, k=512, split=False):
    """(boxes, scores) of b images of k // 2 near-threshold pairs, rank
    order A_0, B_0, A_1, ... (each pair within one block), or with `split`
    all A then all B, so that each pair straddles two blocks of k // 2."""
    import torch

    rows = []
    for i in range(b):
        a, bb = near_threshold_pairs(k // 2, thr, phase=5 * i)
        rows.append(torch.cat([a, bb]) if split else torch.stack([a, bb], 1).reshape(k, 4))
    scores = torch.linspace(1, 0.5, k).expand(b, k)
    return torch.stack(rows).to(device).contiguous(), scores.to(device).contiguous()


def check_fixpoint(device, b=128):
    """K3 against its plain version in both comparison forms, on the K2
    candidate sets that fit one block and a near-threshold set; timed at
    (b, 512)."""
    import torch

    from dmayolo_tpu_torch.core.fixpoint_kernel import (MAX_K, fixpoint_keep,
                                                        fixpoint_keep_plain)
    from dmayolo_tpu_torch.core.nms import NEG_INF

    out = {"cases": {}, "max_abs_err": 0.0}
    cases = [c for c in nms_cases(device, b=b) if c[1].shape[1] <= MAX_K]
    cases.append(("near_threshold", *near_threshold_case(device, 0.45), 300, 0.45))
    for name, boxes, scores, _, thr in cases:
        valid = scores > NEG_INF / 2
        for form, divide in (("divide-free", False), ("divide", True)):
            got = fixpoint_keep(boxes, valid, thr, divide=divide)
            want = fixpoint_keep_plain(boxes, valid, thr, divide)
            same = torch.equal(got, want)
            out["cases"][f"{name}/{form}"] = {"keep": int(got.sum()), "equal": same}
            out["max_abs_err"] = max(out["max_abs_err"],
                                     float((got.int() - want.int()).abs().max()))
            check(same, f"K3 differs from its plain version on case '{name}' ({form})")
    name, boxes, scores, _, thr = cases[0]
    bb, k, _ = boxes.shape
    valid = scores > NEG_INF / 2
    # data-dependent work: one IoU test (~15 flops) for each pair i < j
    # whose suppressor i is valid; 17 bytes in and 1 out per candidate
    pairs = int(((k - 1 - torch.arange(k, device=device)) * valid).sum())
    ops = pairs * 15
    nbytes = bb * k * (16 + 1 + 1)
    out.update(shape=[bb, k], pairs=pairs, ops=ops, bytes=nbytes)
    if device.type == "cuda":
        for form, divide in (("", False), ("_divide", True)):
            out["ms" + form] = cuda_ms(lambda: fixpoint_keep(boxes, valid, thr, divide), 20)
            out["kernel_ms" + form] = graph_ms(lambda: fixpoint_keep(boxes, valid, thr, divide),
                                               20)
            out["plain_ms" + form] = cuda_ms(
                lambda: fixpoint_keep_plain(boxes, valid, thr, divide), 3)
        out["bound_ms"], out["bound_by"] = bound(nbytes, ops, "f32")
        # the eval's "matrix" backend launches the divide form at (32, 512)
        bs, vs = boxes[:32].contiguous(), valid[:32].contiguous()
        pairs = int(((k - 1 - torch.arange(k, device=device)) * vs).sum())
        out["eval_shape"] = [bs.shape[0], k]
        out["eval_ms_divide"] = cuda_ms(lambda: fixpoint_keep(bs, vs, thr, True), 50)
        out["eval_kernel_ms_divide"] = graph_ms(lambda: fixpoint_keep(bs, vs, thr, True), 50)
        out["eval_plain_ms_divide"] = cuda_ms(lambda: fixpoint_keep_plain(bs, vs, thr, True), 3)
        out["eval_bound_ms"], out["eval_bound_by"] = bound(bs.shape[0] * k * 18, pairs * 15, "f32")
    return out


# ---------------------------------------------------------------------------
# K2 streaming: greedy NMS above one block's candidates
# ---------------------------------------------------------------------------

def stream_cases(device, b=32, ks=STREAM_KS, seed=3):
    """(name, boxes, scores) eval-like candidate sets at (b, K), K > 1024:
    10 classes, rank-sorted scores, most of them live."""
    import torch

    from dmayolo_tpu_torch.core.nms import MAX_WH, NEG_INF

    g = torch.Generator().manual_seed(seed)
    cases = []
    for k in ks:
        cls = torch.randint(0, 10, (b, k), generator=g).float()
        xy = torch.rand(b, k, 2, generator=g) * 600
        boxes = torch.cat([xy, xy + 8 + torch.rand(b, k, 2, generator=g) * 150], -1)
        boxes = boxes + cls[..., None] * MAX_WH
        scores = torch.rand(b, k, generator=g)
        scores[scores < 0.02] = NEG_INF
        cases.append((f"random{k}", boxes, scores.sort(dim=1, descending=True).values))
    k = ks[1]
    centres = torch.rand(b, 8, 2, generator=g) * 500
    pick = torch.randint(0, 8, (b, k), generator=g)
    c = (torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
         + torch.randn(b, k, 2, generator=g) * 3)
    wh = 40 + torch.rand(b, k, 2, generator=g) * 20
    clustered = torch.cat([c - wh / 2, c + wh / 2], -1)
    cases.append((f"clustered{k}", clustered,
                  torch.rand(b, k, generator=g).sort(dim=1, descending=True).values))
    ties = (torch.rand(b, k, generator=g) * 6).round() / 6
    ties[ties < 0.1] = NEG_INF
    cases.append((f"ties{k}", cases[1][1], ties))
    masked = cases[0][2].clone()
    masked[::3] = NEG_INF  # every third image has no live candidate
    cases.append((f"masked_rows{ks[0]}", cases[0][1], masked))
    return [(n, bx.to(device).contiguous(), sc.to(device).contiguous()) for n, bx, sc in cases]


def blocked_work(keep, walked, alive, valid, block):
    """What K3's blocked entry must do for these inputs, from its plain
    version's outputs: (blocks walked, pairs i < j of alive candidates
    within a walked block, cross tests: each alive candidate of a walked
    block against every earlier keeper, each valid but suppressed one
    against at least one)."""
    import torch

    b, k = keep.shape
    before = torch.cat([torch.zeros(b, 1, dtype=torch.long, device=keep.device),
                        keep.cumsum(1)], 1)
    pairs = cross = 0
    for m, start in enumerate(range(0, k, block)):
        end = min(start + block, k)
        on = walked > m
        n_alive = alive[:, start:end].sum(1)
        n_sup = (valid[:, start:end] & ~alive[:, start:end]).sum(1)
        kb = before[:, start]
        pairs += int((on * n_alive * (n_alive - 1) // 2).sum())
        cross += int((on * (kb * n_alive + (kb > 0) * n_sup)).sum())
    return int(walked.sum()), pairs, cross


def check_fixpoint_blocked(device, b=32, ks=BLOCKED_KS, max_dets=BLOCKED_MAX_DETS, thr=0.6,
                           block=512):
    """K3's blocked entry against its plain version: keep flags, blocks
    walked, and the `nms_matrix_blocked` outputs built from them; one
    `nms_matrix_blocked` call with host syncs made errors; timed at
    (b, max(ks), max(max_dets))."""
    import torch

    from dmayolo_tpu_torch.core.fixpoint_kernel import (fixpoint_keep_blocked,
                                                        fixpoint_keep_blocked_plain)
    from dmayolo_tpu_torch.core.nms import NEG_INF, _keep_to_idx, nms_matrix_blocked

    out = {"cases": {}, "max_abs_err": 0.0}
    # rank-sorted, as top-k hands them over (the ties set comes unsorted)
    sets = [(name, bx, sc.sort(dim=1, descending=True).values, md)
            for name, bx, sc in stream_cases(device, b, ks) for md in max_dets]
    sets.append(("near_threshold_split", *near_threshold_case(device, thr, k=1024, split=True),
                 1024))
    for name, boxes, scores, max_det in sets:
        valid = scores > NEG_INF / 2
        got = fixpoint_keep_blocked(boxes, valid, thr, max_det, block)
        want = fixpoint_keep_blocked_plain(boxes, valid, thr, max_det, block)
        # keep_idx, keep_valid as the stable sort by score orders them
        by_score = _keep_to_idx(want[0], scores, max_det)
        pairs = list(zip(got, want)) + list(zip(got[2:], by_score))
        same = all(torch.equal(x, y) for x, y in pairs)
        out["cases"][f"{name}/max_det{max_det}"] = {
            "keep": int(got[0].sum()), "walked_mean": float(got[1].float().mean()),
            "equal": same}
        out["max_abs_err"] = max(out["max_abs_err"], *(
            float((x.long() - y.long()).abs().max()) for x, y in pairs))
        check(same, f"K3 blocked differs from its plain version on case '{name}' "
                    f"(max_det {max_det})")
    name, boxes, scores = next(c for c in stream_cases(device, b, ks) if c[0] == f"random{max(ks)}")
    max_det = max(max_dets)
    valid = scores > NEG_INF / 2
    if device.type == "cuda":
        # the whole of nms_matrix_blocked, with any host sync an error
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ki, kv = nms_matrix_blocked(boxes, scores, thr, max_det, block)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = fixpoint_keep_blocked_plain(boxes, valid, thr, max_det, block)
        check(torch.equal(ki, want[2]) and torch.equal(kv, want[3]),
              "nms_matrix_blocked differs from its plain version under sync debug mode")
        out["no_host_sync"] = True
    # timed on the eval's shape (a random set: the stop comes in the first
    # block) and on the clustered set, which walks every block
    timed = [(name, boxes, scores)] + [c for c in stream_cases(device, b, ks)
                                       if c[0] == f"clustered{ks[1]}"]
    for name, boxes, scores in timed:
        res = blocked_timing(device, name, boxes, scores > NEG_INF / 2, thr, max_det, block)
        if device.type == "cuda":
            res["nms_ms"] = cuda_ms(lambda: nms_matrix_blocked(boxes, scores, thr, max_det,
                                                               block), 20)
        if name == timed[0][0]:
            out.update(res)
        else:
            out["walk_all"] = res
    return out


def blocked_timing(device, name, boxes, valid, thr, max_det, block):
    """The work K3's blocked entry must do on these inputs (from its plain
    version) and, on the card, its time as a call and alone, the plain
    version's, and the bound."""
    from dmayolo_tpu_torch.core.fixpoint_kernel import (_blocked_plain, fixpoint_keep_blocked,
                                                        fixpoint_keep_blocked_plain)

    keep, walked, alive = _blocked_plain(boxes, valid, thr, max_det, block)
    bb, k, _ = boxes.shape
    blocks, pairs, cross = blocked_work(keep, walked, alive, valid, block)
    # each IoU test ~15 flops; the walked blocks' boxes and flags read
    # once, every keep flag and the walked counts written once
    ops = (pairs + cross) * 15
    nbytes = int(sum(min(block, k - m * block) * 17 for w in walked.tolist()
                     for m in range(w))) + bb * k + bb * 4
    res = dict(case=name, shape=[bb, k, max_det], blocks_walked=blocks, pairs=pairs,
               cross_tests=cross, keepers=int(keep.sum()), ops=ops, bytes=nbytes)
    if device.type == "cuda":
        res["ms"] = cuda_ms(lambda: fixpoint_keep_blocked(boxes, valid, thr, max_det, block), 20)
        res["kernel_ms"] = graph_ms(
            lambda: fixpoint_keep_blocked(boxes, valid, thr, max_det, block), 20)
        res["plain_ms"] = cuda_ms(
            lambda: fixpoint_keep_blocked_plain(boxes, valid, thr, max_det, block), 3)
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops, "f32")
    return res


def check_nms_stream(device, b=32, ks=STREAM_KS, max_det=300, thr=0.6, big=STREAM_BIG):
    """K2's streaming variants (through the `nms_greedy` router) against
    the plain version: the cluster kernel on every streaming set, the
    global-memory kernel above the cluster's capacity; timed at the
    largest K on both kernels and on every cluster size that fits."""
    import torch

    from dmayolo_tpu_torch.core.nms import MAX_WH
    from dmayolo_tpu_torch.core.nms_kernel import (MAX_K, _device_limits, _launch, _stream_plan,
                                                   cluster_occupancy, cluster_sizes, nms_greedy,
                                                   nms_greedy_plain)

    def compare(name, boxes, scores, route):
        ki, kv = nms_greedy(boxes, scores, thr, max_det)
        pi, pv = nms_greedy_plain(boxes, scores, thr, max_det)
        same = torch.equal(ki, pi) and torch.equal(kv, pv)
        out["cases"][name] = {"picks": int(kv.sum()), "route": route, "equal": same}
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((ki.long() - pi.long()).abs().max()),
                                 float((kv.long() - pv.long()).abs().max()))
        check(same, f"K2 streaming differs from its plain version on case '{name}' ({route})")

    def route_of(boxes):
        if device.type != "cuda":
            return "plain"
        plan = _stream_plan(boxes.device, *boxes.shape[:2])
        return "global" if plan is None else f"cluster of {plan[0]}"

    out = {"cases": {}, "max_abs_err": 0.0}
    cases = stream_cases(device, b, ks)
    for name, boxes, scores in cases:
        check(boxes.shape[1] > MAX_K, f"case '{name}' does not reach the streaming variant")
        route = route_of(boxes)
        check(route != "global", f"case '{name}' is not on the cluster route")
        compare(name, boxes, scores, route)
    # above the cluster's capacity: the global-memory kernel
    nb, nk = big
    g = torch.Generator().manual_seed(7)
    cls = torch.randint(0, 10, (nb, nk), generator=g).float()
    xy = torch.rand(nb, nk, 2, generator=g) * 600
    big_boxes = (torch.cat([xy, xy + 8 + torch.rand(nb, nk, 2, generator=g) * 150], -1)
                 + cls[..., None] * MAX_WH).to(device)
    big_scores = torch.rand(nb, nk, generator=g).sort(dim=1, descending=True).values.to(device)
    route = route_of(big_boxes)
    check(route in ("global", "plain"), f"K = {nk} is not on the global route ({route})")
    compare(f"random{nk}_b{nb}", big_boxes, big_scores, route)

    name, boxes, scores = next(c for c in cases if c[0] == f"random{max(ks)}")
    bb, k, _ = boxes.shape
    picks = int(nms_greedy(boxes, scores, thr, max_det)[1].sum())
    ops = picks * k * 15  # as K2: one argmax and one IoU pass over K a pick
    nbytes = bb * k * (16 + 4) + bb * max_det * (4 + 1)
    out.update(shape=[bb, k, max_det], route=route_of(boxes), picks=picks, ops=ops, bytes=nbytes)
    if device.type == "cuda":
        out["ms"] = cuda_ms(lambda: nms_greedy(boxes, scores, thr, max_det), 10)
        out["kernel_ms"] = graph_ms(lambda: nms_greedy(boxes, scores, thr, max_det), 10)
        out["plain_ms"] = cuda_ms(lambda: nms_greedy_plain(boxes, scores, thr, max_det), 2)
        out["bound_ms"], out["bound_by"] = bound(nbytes, ops, "f32")
        # the global-memory kernel on the same inputs, and each
        # cluster size that fits: the plan against the alternatives
        want = nms_greedy_plain(boxes, scores, thr, max_det)
        out["ms_by_route"] = {}
        for r in ("global", *cluster_sizes(k, _device_limits(device)[1])):
            got = _launch("nms_greedy_stream", boxes, scores, thr, max_det, r)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"K2 streaming route {r} differs from its plain version")
            out["ms_by_route"][str(r)] = cuda_ms(
                lambda r=r: _launch("nms_greedy_stream", boxes, scores, thr, max_det, r), 10)
        out["global_ms"] = out["ms_by_route"]["global"]
        # one image by cluster size: a step's fixed part and its cost a
        # candidate, to which `plan_stream`'s cost model is fitted
        out["max_clusters"] = {str(c): n for c, n in cluster_occupancy(device, k).items()}
        b1, s1 = boxes[:1].contiguous(), scores[:1].contiguous()
        out["one_image_ms_by_cluster"] = {
            str(c): cuda_ms(lambda c=c: _launch("nms_greedy_stream", b1, s1, thr, max_det, c), 5)
            for c in cluster_sizes(k, _device_limits(device)[1])}
        bpicks = int(nms_greedy(big_boxes, big_scores, thr, max_det)[1].sum())
        out["global_big"] = {
            "shape": [nb, nk, max_det], "picks": bpicks,
            "ms": cuda_ms(lambda: nms_greedy(big_boxes, big_scores, thr, max_det), 3),
            "plain_ms": cuda_ms(lambda: nms_greedy_plain(big_boxes, big_scores, thr, max_det), 1)}
        out["global_big"]["bound_ms"], out["global_big"]["bound_by"] = bound(
            nb * nk * 20 + nb * max_det * 5, bpicks * nk * 15, "f32")
    return out


# ---------------------------------------------------------------------------
# K1: 3x3 conv
# ---------------------------------------------------------------------------

def check_conv(device, shapes=K1_SHAPES, timed=True):
    """K1 against its plain version at `shapes` (B, H, W, C1, C2); with
    `timed`, f32 and bf16 timed beside cuDNN, else untimed checks that
    include mixed input and output dtypes."""
    import torch
    import torch.nn.functional as F

    from dmayolo_tpu_torch.nn.conv3x3 import conv3x3_s1, conv3x3_s1_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    combos = [("f32", f32, f32), ("bf16", bf16, bf16)]
    if not timed:
        combos += [("bf16->f32", bf16, f32), ("f32->bf16", f32, bf16)]
    g = torch.Generator().manual_seed(1)
    cases = []
    for b, h, w, c1, c2 in shapes:
        x32 = torch.randn(b, h, w, c1, generator=g)
        w32 = torch.randn(3, 3, c1, c2, generator=g) / (9 * c1) ** 0.5
        for kind, dt, out_dt in combos:
            x, wt = x32.to(device, dt), w32.to(device, dt)
            got = conv3x3_s1(x, wt, out_dtype=out_dt)
            want = conv3x3_s1_plain(x, wt, out_dt)
            check(got.dtype == out_dt and got.shape == want.shape,
                  f"K1 gave {got.dtype} {tuple(got.shape)} at {kind} {(b, h, w, c1, c2)}")
            err = (got.float() - want.float()).abs()
            # |kernel - plain| <= tol * (1 + |plain|): atol = rtol = tol,
            # the tolerance of the output dtype
            scaled = float((err / (1 + want.float().abs())).max())
            tol = K1_TOL["bf16" if out_dt == bf16 else "f32"]
            case = {"shape": [b, h, w, c1, c2], "dtype": kind,
                    "max_abs_err": float(err.max()), "max_scaled_err": scaled, "tol": tol}
            check(scaled <= tol, f"K1 differs from its plain version beyond {tol} at {case}")
            if timed and device.type == "cuda":
                item = x.element_size()
                ops = 2 * b * h * w * 9 * c1 * c2
                nbytes = (b * h * w * (c1 + c2) + 9 * c1 * c2) * item
                xn = x.permute(0, 3, 1, 2)  # channels_last view for cuDNN
                wo = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                case["ms"] = cuda_ms(lambda: conv3x3_s1(x, wt), 50)
                case["kernel_ms"] = kernel_ms(x, wt, 50)
                case["plain_ms"] = cuda_ms(lambda: conv3x3_s1_plain(x, wt), 5)
                case["library_ms"] = cuda_ms(lambda: F.conv2d(xn, wo, padding=1), 50)
                case["bound_ms"], case["bound_by"] = bound(
                    nbytes, ops, "bf16" if dt == bf16 else "tf32x3")
                case["bytes"], case["ops"] = nbytes, ops
                case["tflops"] = ops / case["ms"] / 1e9
            cases.append(case)
            del x, wt, got, want, err
    return cases


def kernel_ms(x, wt, iters):
    """K1's kernel alone: `conv3x3_s1` less its per-call host side (channel
    padding, the K-major weight copy, f32's TF32 split of the weights),
    timed on prepared inputs."""
    import torch

    from dmayolo_tpu_torch.nn.conv3x3 import launch_tc, prepare

    prep = prepare(x, wt)
    out = torch.empty(*x.shape[:3], wt.shape[3], dtype=x.dtype, device=x.device)
    return cuda_ms(lambda: check(launch_tc(*prep, out) == 0, "K1 launch failed"), iters)


def conv3x3_sites(model, x, dtype):
    """{(H, W, C1, C2): count} of the model's 3x3 stride-1 convs (k 3, s 1,
    g 1, d 1) in one forward of x, read by forward hooks."""
    import collections

    import torch

    from dmayolo_tpu_torch.nn.primitives import Conv2d

    sites = collections.Counter()

    def hook(conv, args, _):
        _, c, h, w = args[0].shape  # NCHW (channels_last memory) inside the model
        sites[(h, w, c, conv.weight.shape[0])] += 1

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d) and m.k == (3, 3) and m.s == (1, 1)
               and m.g == 1 and m.d == (1, 1)]
    try:
        with torch.inference_mode():
            model.apply(x, dtype=dtype)
    finally:
        for h in handles:
            h.remove()
    return dict(sorted(sites.items(), key=lambda kv: (-kv[0][0], kv[0][2], kv[0][3])))


def check_conv_flagship(device, sites, batch=128, iters=10, dtype="bf16"):
    """K1 at each of the flagship's 3x3 stride-1 conv shapes (`sites`).

    bf16, at the serving batch: images 0-1 of the full-batch call held
    against the plain version on those two images (it cannot run the
    whole batch: its unfold alone is 30 GB at 320x320x64), and timed
    beside cuDNN (`F.conv2d` on the channels_last view, the yardstick
    only) and the bound; the sums weight each shape by its count in one
    forward.  f32 (the 3xTF32 route): the whole batch against the plain
    version (TF32 off), untimed."""
    import torch
    import torch.nn.functional as F

    from dmayolo_tpu_torch.nn.conv3x3 import conv3x3_s1, conv3x3_s1_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    timed = dtype == "bf16" and device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(4)
    rows = []
    for (h, w, c1, c2), count in sites.items():
        x = torch.randn(batch, h, w, c1, device=device, generator=g).to(dt)
        wt = (torch.randn(3, 3, c1, c2, device=device, generator=g) / (9 * c1) ** 0.5).to(dt)
        got = conv3x3_s1(x, wt)
        want = conv3x3_s1_plain(x[:2], wt).float()
        err = (got[:2].float() - want).abs()
        row = {"shape": [batch, h, w, c1, c2], "count": count, "max_abs_err": float(err.max()),
               "max_scaled_err": float((err / (1 + want.abs())).max()), "tol": K1_TOL[dtype]}
        check(got.shape == (batch, h, w, c2) and row["max_scaled_err"] <= row["tol"],
              f"K1 differs from its plain version on images 0-1 at {row} ({dtype})")
        if timed:
            xn = x.permute(0, 3, 1, 2)  # channels_last view for cuDNN
            wo = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            row["ms"] = cuda_ms(lambda: conv3x3_s1(x, wt), iters)
            row["kernel_ms"] = kernel_ms(x, wt, iters)
            row["library_ms"] = cuda_ms(lambda: F.conv2d(xn, wo, padding=1), iters)
            row["ops"] = 2 * batch * h * w * 9 * c1 * c2
            row["bytes"] = (batch * h * w * (c1 + c2) + 9 * c1 * c2) * 2
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"], "bf16")
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            del xn, wo
        rows.append(row)
        del x, wt, got, want, err
    out = {"batch": batch, "dtype": dtype, "convs": sum(sites.values()), "shapes": rows,
           "max_scaled_err": max(r["max_scaled_err"] for r in rows)}
    if timed:
        for key in ("ms", "kernel_ms", "library_ms", "bound_ms"):
            out[f"step_{key}"] = sum(r["count"] * r[key] for r in rows)
    return out


# ---------------------------------------------------------------------------
# serving main path
# ---------------------------------------------------------------------------

def native_image(h, w, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (yy[..., None] * (seed + 1) + xx[..., None] * 3 + rng.integers(0, 40, (h, w, 3))) % 256
    return img.astype(np.uint8)


def serve_requests(batcher, sizes, nc):
    """Submit one request per size from its own thread; check each answer."""
    import numpy as np

    imgs = [native_image(h, w, i) for i, (h, w) in enumerate(sizes)]
    results = [None] * len(imgs)
    errors = []

    def client(i):
        try:
            results[i] = batcher.submit(imgs[i]).result(timeout=300)
        except Exception as e:  # reported below, per request
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "a serving request never returned")
    check(not errors, f"serving requests failed: {errors}")
    counts = []
    for img, d in zip(imgs, results):
        h, w = img.shape[:2]
        check(d.ndim == 2 and d.shape[1] == 6, f"bad detections shape {d.shape}")
        check(np.isfinite(d).all(), "non-finite detections")
        check(((d[:, [0, 2]] >= 0) & (d[:, [0, 2]] <= w)).all()
              and ((d[:, [1, 3]] >= 0) & (d[:, [1, 3]] <= h)).all(),
              "detections outside the native image")
        check(((d[:, 5] >= 0) & (d[:, 5] < nc)).all(), "class out of range")
        counts.append(len(d))
    return counts


def calibrate_bn(model, x):
    """Set every BN's running mean and variance to those of its input on
    `x`, layer by layer.  With torch's default init alone the activations
    shrink by ~3x a layer and the raw head is its bias to 1e-9, so every
    candidate ties and a card-vs-CPU comparison of the head is empty."""
    import torch

    from dmayolo_tpu_torch.nn.primitives import BatchNorm2d

    def hook(bn, args):
        v = args[0].float()
        bn.running_mean.copy_(v.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(v.var(dim=(0, 2, 3)))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    try:
        with torch.no_grad():
            model.apply(x)
    finally:
        for h in handles:
            h.remove()


def build_model(device, imgsz=640, cfg=None, nc=10):
    """The flagship from a seed, head priors set, BN statistics calibrated
    on two random images; unfolded."""
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel, model_config

    model = DetectionModel(cfg or model_config(FLAGSHIP), nc=nc, device=device)
    g = torch.Generator().manual_seed(0)
    model.init_with_priors(g)
    calibrate_bn(model, torch.rand(2, imgsz, imgsz, 3, generator=g).to(device))
    return model


def drive_batcher(model, device, imgsz, max_batch, dtype, nc, counters, **kw):
    """A `MicroBatcher` (NMS backend from `kw`, else its default) answers
    the requests; the launch counters are zeroed just before and read just
    after.  Returns the closed batcher, whose serve step still works."""
    from dmayolo_tpu_torch.serve.batcher import MicroBatcher

    for c in counters:
        c.launches = 0
    batcher = MicroBatcher(model, imgsz=imgsz, max_batch=max_batch, dtype=dtype,
                           device=device, **kw)
    try:
        batcher.warmup()
        dets = serve_requests(batcher, NATIVE_SIZES, nc)
    finally:
        batcher.close()
    out = {"backend": batcher._serve_kw["backend"], "detections_per_request": dets,
           "launches": {c.__name__: c.launches for c in counters},
           "lazy_tails": batcher.model.lazy_tails,
           "stats_counters": {k: (dict(v) if isinstance(v, dict) else v)
                              for k, v in batcher.stats_counters.items()}}
    check(out["stats_counters"]["requests"] == len(NATIVE_SIZES), "requests lost")
    return batcher, out


def serving(device, model, imgsz=640, max_batch=32, timed_batch=128, nc=10,
            counters=(), check_imgsz=64):
    import torch

    torch.backends.cudnn.allow_tf32 = False  # f32 card-vs-CPU check below
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"params": sum(p.numel() for p in model.parameters())}
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    # ---- the main paths, counted: K2 by name, then the default backend
    batchers = {}
    for name, kw in (("pallas", {"nms_backend": "pallas"}), ("default", {})):
        batchers[name], out[f"batcher_{name}"] = drive_batcher(
            model, device, imgsz, max_batch, dtype, nc, counters, **kw)
    fused = batchers["pallas"].model

    # ---- conf 0.0: every candidate live; the three NMS backends must agree
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (max_batch, imgsz, imgsz, 3), generator=g,
                      dtype=torch.uint8).to(device)
    with torch.inference_mode():
        raw = fused.apply(x.to(dtype) / 255.0, dtype=dtype, fused=True)
        dp, vp = fused.serve_detections(raw, conf_thres=0.0, backend="pallas")
        for backend in ("scan", "matrix"):
            d, v = fused.serve_detections(raw, conf_thres=0.0, backend=backend)
            check(torch.equal(vp, v) and torch.equal(dp, d),
                  f"'pallas' and '{backend}' serving tails differ at conf 0.0")
    out["conf0_valid"] = int(vp.sum())
    check(bool(torch.isfinite(dp).all()), "non-finite detections at conf 0.0")

    # ---- the card against the CPU on a small f32 input
    xs = torch.rand(1, check_imgsz, check_imgsz, 3, generator=g)
    with torch.inference_mode():
        want = [r.float() for r in fused.to("cpu").apply(xs, fused=True)]
        fused.to(device)
        got = [r.float().cpu() for r in fused.apply(xs.to(device), fused=True)]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    out["f32_card_vs_cpu_max_abs_err"], out["f32_raw_max_abs"] = err, scale
    check(err <= 1e-3 * max(1.0, scale), f"raw head on the card differs from the CPU by {err}")

    # ---- bs128 serving time: uint8 in, (B, 300, 6) out, per backend, in
    # turns (pallas, matrix, matrix, pallas) with the card's clocks beside
    if device.type == "cuda":
        xb = torch.randint(0, 256, (timed_batch, imgsz, imgsz, 3), generator=g,
                           dtype=torch.uint8).to(device)
        out["serve_batch"] = timed_batch
        steps = {}
        for name, batcher in batchers.items():
            def step(batcher=batcher):
                with torch.inference_mode():
                    return batcher._serve(xb)

            d, v = step()
            check(d.shape == (timed_batch, 300, 6) and bool(torch.isfinite(d).all()),
                  f"bad bs128 serving output ({name})")
            steps["" if name == "pallas" else "_" + out[f"batcher_{name}"]["backend"]] = step
        windows = {sfx: [] for sfx in steps}
        for sfx in list(steps) + list(steps)[::-1]:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(steps[sfx], 5, warmup=2)
            windows[sfx].append({"ms": ms, "card": card_state()})
            out[f"peak_mem_gib{sfx}"] = torch.cuda.max_memory_allocated() / 2**30
        for sfx, ws in windows.items():
            ms = sum(w["ms"] for w in ws) / len(ws)
            out.update({f"serve_ms{sfx}": ms, f"serve_img_per_s{sfx}": timed_batch / ms * 1e3,
                        f"serve_windows{sfx}": ws})
            out[f"profile{sfx}"] = profile_step(steps[sfx])
    return out


def card_state():
    """SM clock, power draw and temperature, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()


def annotation(e):
    """A profiler range's own device-side event (`record_function` marks
    its span on the card too): its time is its kernels', counted once."""
    return e.key in RANGE_KEYS


def range_ms(averages):
    """Device time of the kernels inside each of `PROFILE_RANGES`, from
    its host-side event."""
    import torch

    ops = {e.key: e.device_time_total / 1e3 for e in averages
           if e.device_type == torch.autograd.DeviceType.CPU}
    return {name: sum(ops.get(k, 0.0) for k in keys) for name, keys in PROFILE_RANGES}


def profile_step(step, top=12):
    """Device time of one serving step by kernel name (torch.profiler),
    and the device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not annotation(e)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {}
    for k, ms, _ in rows:
        group = next((g for g, marks in PROFILE_GROUPS if any(m in k for m in marks)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "kernels": len(rows), "launches": sum(r[2] for r in rows),
            "groups_ms": groups, "ranges_ms": range_ms(prof.key_averages()),
            "top": [{"kernel": k[:90], "ms": ms, "count": n, "share": ms / device_ms}
                    for k, ms, n in rows[:top]]}


# ---------------------------------------------------------------------------
# the eval protocol
# ---------------------------------------------------------------------------

def rectangles(b, imgsz, nc, seed, max_objects=8):
    """Images of filled rectangles on grey, drawn from a numpy seed, and
    their labels as targets: cls (b, M), box xywhn (b, M, 4), mask (b, M)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    imgs = np.full((b, imgsz, imgsz, 3), 114, np.uint8)
    cls = np.zeros((b, max_objects), np.float32)
    box = np.zeros((b, max_objects, 4), np.float32)
    mask = np.zeros((b, max_objects), bool)
    for i in range(b):
        for j in range(int(rng.integers(1, max_objects + 1))):
            w, h = (rng.uniform(0.05, 0.4, 2) * imgsz).astype(int)
            x1, y1 = int(rng.integers(0, imgsz - w)), int(rng.integers(0, imgsz - h))
            imgs[i, y1:y1 + h, x1:x1 + w] = rng.integers(0, 256, 3)
            cls[i, j] = rng.integers(0, nc)
            box[i, j] = np.array([x1 + w / 2, y1 + h / 2, w, h]) / imgsz
            mask[i, j] = True
    return imgs, (cls, box, mask)


def evaluate(device, model, imgsz=640, batch=32, tta_batch=8, nc=10, counters=(),
             iters=3, seed=5):
    """The eval protocol through `make_infer_fn` on each backend (counted),
    the host mAP of its detections, the step's time by part, one TTA batch
    (none when `tta_batch` is 0)."""
    import numpy as np
    import torch

    from dmayolo_tpu_torch.core.nms import MAX_WH, NEG_INF, _nms_idx, select_candidates
    from dmayolo_tpu_torch.eval.validator import (_match_batch, _summarize, make_infer_fn,
                                                  with_obj_column)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    imgs, (t_cls, t_box, t_mask) = rectangles(batch, imgsz, nc, seed)
    x = torch.from_numpy(imgs).to(device)
    out = {"batch": batch, "imgsz": imgsz, "labels": int(t_mask.sum()), "backends": {}}
    first = None
    for backend in EVAL_BACKENDS:
        infer = make_infer_fn(model, dtype=dtype, nms_backend=backend, **PROTOCOL)
        for c in counters:
            c.launches = 0
        dets, valid = infer(x)
        dets, valid = dets.cpu(), valid.cpu()
        res = {"launches": {c.__name__: c.launches for c in counters},
               "detections": int(valid.sum())}
        check(dets.shape == (batch, PROTOCOL["max_det"], 6)
              and bool(torch.isfinite(dets).all()), f"bad eval output ({backend})")
        if first is None:
            first = (backend, dets, valid)
        else:
            check(torch.equal(valid, first[2]) and torch.equal(dets, first[1]),
                  f"eval detections differ between '{first[0]}' and '{backend}'")
        if device.type == "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                infer(x)[0].cpu()
            res["step_ms"] = (time.perf_counter() - t0) / iters * 1e3
            res["img_per_s"] = batch / res["step_ms"] * 1e3
        out["backends"][backend] = res

    # ---- the host half: match at 10 IoU thresholds, P, R and mAP
    stats, _ = _match_batch(first[1].numpy(), first[2].numpy(), (imgsz, imgsz),
                            t_cls, t_box, t_mask)
    res = _summarize(stats, nc)
    metrics = {k: getattr(res, k) for k in ("mp", "mr", "map50", "map75", "map")}
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()) and res.nt
          == out["labels"], f"bad eval metrics {metrics} ({res.nt} labels)")
    out["metrics"] = metrics
    # the helpers on a known answer: the labels as conf-1.0 detections
    xywh = t_box * imgsz
    lab = np.concatenate([xywh[..., :2] - xywh[..., 2:] / 2, xywh[..., :2] + xywh[..., 2:] / 2,
                          np.ones_like(t_cls)[..., None], t_cls[..., None]], -1)
    stats, _ = _match_batch(lab, t_mask, (imgsz, imgsz), t_cls, t_box, t_mask)
    res = _summarize(stats, nc)
    out["metrics_labels_as_detections"] = {k: getattr(res, k) for k in metrics}
    check(res.mp == res.mr == 1.0 and res.map50 > 0.99 and res.map > 0.99,
          f"the labels as detections do not score 1: {out['metrics_labels_as_detections']}")
    # the reference's --save-hybrid: the labels join the candidates as
    # conf-1.0 rows; reported, not checked, since random weights can
    # saturate scores at 1.0 too
    infer = make_infer_fn(model, dtype=dtype, hybrid=True, nms_backend="pallas", **PROTOCOL)
    dets, valid = infer(x, *(torch.from_numpy(t).to(device) for t in (t_cls, t_box, t_mask)))
    dets, valid = dets.cpu(), valid.cpu()
    check(dets.shape == (batch, PROTOCOL["max_det"], 6) and bool(torch.isfinite(dets).all()),
          "bad hybrid eval output")
    stats, _ = _match_batch(dets.numpy(), valid.numpy(), (imgsz, imgsz), t_cls, t_box, t_mask)
    res = _summarize(stats, nc)
    out["metrics_hybrid"] = {k: getattr(res, k) for k in metrics}

    # ---- the step by part: forward + decode, candidates (top-k), NMS
    with torch.inference_mode():
        xf = x.to(dtype) / 255.0
        dec = with_obj_column(model.decode(model.apply(xf, dtype=dtype)), nc)
        cand = select_candidates(dec, PROTOCOL["conf_thres"], True, PROTOCOL["max_nms"])
        top_boxes, top_scores, top_cls, _ = cand
        nms_boxes = top_boxes + (top_cls * MAX_WH)[..., None]
        live = (top_scores > NEG_INF / 2).sum(1)
        out.update(candidates=dec.shape[1] * (dec.shape[2] - 5), k=top_scores.shape[1],
                   live_min=int(live.min()), live_mean=float(live.float().mean()),
                   conf1_mean=float((top_scores >= 1.0).sum(1).float().mean()))
        if device.type == "cuda":
            parts = {"forward+decode": cuda_ms(
                lambda: with_obj_column(model.decode(model.apply(xf, dtype=dtype)), nc), iters),
                "candidates (conf gate, top-k)": cuda_ms(
                lambda: select_candidates(dec, PROTOCOL["conf_thres"], True,
                                          PROTOCOL["max_nms"]), iters)}
            for backend in EVAL_BACKENDS:
                parts[f"nms {backend}"] = cuda_ms(lambda: _nms_idx(
                    nms_boxes, top_scores, PROTOCOL["iou_thres"], PROTOCOL["max_det"],
                    backend), iters)
            out["parts_ms"] = parts

    # ---- one TTA batch
    if not tta_batch:
        return out
    infer = make_infer_fn(model, dtype=dtype, augment=True, nms_backend="matrix", **PROTOCOL)
    t0 = time.perf_counter()
    dets, valid = infer(x[:tta_batch])
    dets = dets.cpu()
    out["tta"] = {"batch": tta_batch, "ms": (time.perf_counter() - t0) * 1e3,
                  "detections": int(valid.sum())}
    check(dets.shape == (tta_batch, PROTOCOL["max_det"], 6) and bool(torch.isfinite(dets).all())
          and int(valid.sum()) > 0, "bad TTA eval output")
    return out


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

# the author's recipe (train.sh:5-9): 1536 px, batch 4, Adam, hyp VisDrone
RECIPE = dict(imgsz=1536, batch=4, adam=True, hyp="visdrone", max_targets=128,
              assignment="anchor", autoanchor=False)
TRAIN_BATCHES = 16  # one epoch of the in-memory loader (the accumulate-16 step's batches)
TRAIN_WARMUP_BATCHES = 2  # before the timed window
TRAIN_ACCS = (1, 16)  # the ramp's start, and the recipe's accumulate after warmup
# card (f32, TF32 off) against the host CPU, one step at batch 2, 640 px:
# loss and items relative; every grad and updated parameter scaled by
# 1 + max |x| of its tensor
TRAIN_F32_TOL = {"loss": 1e-4, "grad": 1e-3, "param": 1e-5}
# TAL's step (CASPD_ODRTA): its grads and updated parameters are held
# within this factor of the CPU's own rounding noise, the difference
# between its steps on one thread and on all, where that is the larger
# bound.  Those of TRAIN_F32_TOL cannot hold here: the CPU's noise alone
# is 1.6e-3 in the grads and 4.8e-6 in the parameters (the backward's
# large reductions, summed in another order), and the card, whose kernels
# order them otherwise again, lies 3.6-3.7 times that from it; on the
# flagship the same ratio is 3.0 (chip_conditioning.py on one H100 80GB
# HBM3, 700 W)
TRAIN_F32_NOISE_FACTOR = 8
TRAIN_BF16_LOSS_TOL = 1e-2  # bf16 step's loss against the f32 CPU loss, relative
# each conv's and BN's backward in the bf16 step against its formula in f32
# on the layer's own operands, relative L2 over each grad tensor: those it
# gives in bf16 (within bf16's rounding, 2^-8) and those in f32
TRAIN_BF16_LAYER_TOL = {"low_grads": 2 ** -8, "f32_grads": 1e-4}
# the model on the EMA checkpoint (f16) against the live EMA: the raw head
# (f32, train-mode BN) relative L2 to its spread over images and cells (the
# head's per-output means are mostly the prior biases)
TRAIN_CKPT_HEAD_TOL = 0.5
# kernel time of one step by group, from the profiler's CPU-side ops (device
# time of the kernels each launched, children included); the rest is "other"
TRAIN_PROFILE_GROUPS = [
    ("conv forward", "aten::cudnn_convolution"),
    ("conv dgrad/wgrad", "aten::convolution_backward"),
    ("BN train forward", "_BatchNormTrain"),
    ("BN train backward", "_BatchNormTrainBackward"),
    ("loss (forward)", "loss"),
    ("optimizer", "optimizer"),
    ("EMA", "ema"),
    # the port's profiler ranges; their backward is in "other"
    ("attention matmuls and softmax (forward)", ("attention",)),
    ("LayerNorm / GELU / window shuffles (forward)", ("layernorm", "gelu", "window shuffle")),
    ("HorBlock (forward, GnConv and its depthwise conv included)", ("horblock",)),
]


def ref_cadence_steps(n_batches, nw, acc):
    """The reference's stepping rule with the warmup accumulate ramp
    (train.py:409-412, 448-454): optimizer steps over `n_batches`."""
    import numpy as np

    pending, steps = 0, 0
    for ni in range(n_batches):
        pending += 1
        if pending >= max(1, min(acc, round(float(np.interp(ni, [0, nw], [1, acc]))))):
            steps += 1
            pending = 0
    return steps


def train_batches(n, b, imgsz, nc, max_targets, seed):
    """`n` loader batches of filled rectangles (up to 64 an image), their
    boxes as targets padded to `max_targets` rows."""
    import numpy as np

    from dmayolo_tpu_torch.train.loss import Targets
    from dmayolo_tpu_torch.train.trainer import Batch

    out = []
    for i in range(n):
        imgs, (cls, box, mask) = rectangles(b, imgsz, nc, seed + i, max_objects=64)
        pad = max_targets - cls.shape[1]
        out.append(Batch(imgs, Targets(np.pad(cls, ((0, 0), (0, pad))),
                                       np.pad(box, ((0, 0), (0, pad), (0, 0))),
                                       np.pad(mask, ((0, 0), (0, pad))))))
    return out


def labels_of(batches):
    """A dataset's `shapes` (N, 2) as (h, w) and `labels`, one (n, 5)
    [cls, x, y, w, h] array an image, from loader batches."""
    import numpy as np

    shapes, labels = [], []
    for b in batches:
        cls, box, mask = (np.asarray(t) for t in b.targets)
        for i in range(len(cls)):
            shapes.append(b.images.shape[1:3])
            labels.append(np.concatenate([cls[i, mask[i], None], box[i, mask[i]]], 1))
    return np.asarray(shapes), labels


class TimedLoader:
    """The batches, with a CUDA event recorded when batch `start` is
    handed out and when the loader runs dry (before the epoch's save);
    untimed on the CPU.  `shapes` and `labels` are the dataset's, as
    autoanchor reads them: every image (h, w), and its [cls, x, y, w, h]
    rows."""

    def __init__(self, batches, start, timed=True):
        import torch

        self.batches, self.start = batches, start
        self.shapes, self.labels = labels_of(batches)
        self.t0, self.t1 = ((torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True)) if timed else (None, None))

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.start and self.t0:
                self.t0.record()
            yield b
        if self.t1:
            self.t1.record()


def make_loss(model, h, nc, assignment):
    """The recipe's loss: SIoU ComputeLoss on the head's anchors, or TAL."""
    from dmayolo_tpu_torch.train.loss import ComputeLoss
    from dmayolo_tpu_torch.train.tal import ComputeLossTAL

    if assignment == "tal":
        return ComputeLossTAL(model.stride, nc=nc, hyp=h)
    return ComputeLoss(model.head.anchors, h, nc=nc)


class ReplayedAssignment:
    """TAL's assigner for the card-vs-CPU step: the assignment is a
    discontinuous function of the predictions (a top-k and an argmax), so
    the two devices' forward rounding can move a cell across a near-tie.
    The first step (the host CPU's) keeps the assigner's inputs and
    outputs; a later one (the card's) runs the assigner on the kept inputs
    (`report`: how far that is from the kept outputs), counts the cells
    whose foreground differs on its own inputs (read), and returns the kept
    outputs, so both steps' losses and grads read one assignment."""

    def __init__(self):
        self.assigner = self.kept = None
        self.report = {}

    def install(self, loss):
        self.assigner = self.assigner or loss.assigner
        loss.assigner = self

    def __call__(self, *args):
        import torch

        if self.kept is None:
            out = self.assigner(*args)
            self.kept = ([a.detach().cpu() for a in args], [o.cpu() for o in out])
            return out
        dev = args[0].device
        ins, want = self.kept
        got = [o.cpu() for o in self.assigner(*(a.to(dev) for a in ins))]
        own_fg = self.assigner(*args)[3].cpu()
        self.report = {
            "fg_cells": int(want[3].sum()),
            "labels_and_fg_equal_on_the_cpu_inputs": bool(torch.equal(got[0], want[0])
                                                          and torch.equal(got[3], want[3])),
            "boxes_max_abs_err": float((got[1] - want[1]).abs().max()),
            "scores_max_abs_err": float((got[2] - want[2]).abs().max()),
            "fg_cells_differing_on_own_inputs": int((own_fg != want[3]).sum())}
        return [o.to(dev) for o in want]


def one_train_step(device, cfg, state_dict, batch, dtype, nc=10, layers=False,
                   recipe=RECIPE, anchors=None, replay=None, mesh=None, with_buffers=False,
                   spatial=False):
    """One SGD step past warmup (lr and momentum at their base values) of
    the model of `cfg` (`anchors`: its head's, stride units, where the
    yaml's are placeholders) from `state_dict` on `batch`, with the
    recipe's hyp and loss (TAL's assignment through `replay`, a
    `ReplayedAssignment`, where given): (metrics, grads, updated
    parameters, layer errors), all on the host.  SGD moves each parameter
    in proportion to its gradient, so the updated parameters compare as
    the grads do (Adam's first step moves each by +-lr whatever the
    gradient's size).  With `layers`, every conv's and BN's backward is
    held against its formula on its own operands (`layer_grad_errs`), and
    the dtypes of the master weights and their grads are kept; else None.
    `mesh` (`parallel/mesh.py`) with a group: this rank's share of the
    step over `batch` (its rows), through the data-parallel step; with
    `spatial`, also its H rows, through the H-sharded step.  With
    `with_buffers`, a fifth item: the BN running statistics after it."""
    import torch

    from dmayolo_tpu_torch.parallel.mesh import shard_batch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.train.loss import Targets
    from dmayolo_tpu_torch.train.optim import Schedule, param_groups
    from dmayolo_tpu_torch.train.step import init_train_state, make_train_step
    from dmayolo_tpu_torch.train.trainer import load_hyp, scale_hyp

    model = DetectionModel(cfg, nc=nc, device=device)
    model.load_state_dict(state_dict)
    if anchors is not None:
        model.head.anchors = anchors
    h = scale_hyp(load_hyp(recipe["hyp"]), model.head.nl, nc, batch.images.shape[1])
    sched = Schedule(h, epochs=1, steps_per_epoch=1, batch_size=batch.images.shape[0])
    state = init_train_state(model, param_groups(model), h["weight_decay"],
                             momentum=h["momentum"])
    loss = make_loss(model, h, nc, recipe["assignment"])
    if replay is not None:
        replay.install(loss)
    step = make_train_step(loss, sched, dtype=dtype, mesh=mesh, spatial=spatial)
    imgs = torch.from_numpy(batch.images).to(device)
    tg = Targets(*(torch.from_numpy(t).to(device) for t in batch.targets))
    if mesh is not None and mesh.distributed:
        imgs, tg = shard_batch(mesh, imgs, spatial=spatial), shard_batch(mesh, tg)
    records, handles = layer_grad_hooks(model) if layers else ({}, [])
    grads, errs = {}, None

    def pre_step(*_):  # read before the update: CUDA's foreach SGD adds momentum into .grad
        nonlocal errs
        grads.update({k: p.grad.float().cpu() for k, p in model.named_parameters()})
        if layers:
            with torch.no_grad():
                errs = layer_grad_errs(records, dtype)
            errs["master_dtypes"] = sorted({str(t.dtype) for p in model.parameters()
                                            for t in (p, p.grad)})
            records.clear()

    state.optimizer.register_step_pre_hook(pre_step)
    metrics = step(state, imgs, tg, ni=float(sched.nw + 1))
    for hd in handles:
        hd.remove()
    out = ({k: float(v) for k, v in metrics.items()}, grads,
           {k: p.detach().float().cpu() for k, p in model.named_parameters()}, errs)
    if with_buffers:
        out += ({k: b.detach().float().cpu() for k, b in model.named_buffers()},)
    return out


def layer_grad_hooks(model):
    """Hooks that keep, for every Conv2d and BatchNorm2d of `model`, its
    input and the grads of its output and input as the backward computes
    them: ({module: record}, hook handles)."""
    from dmayolo_tpu_torch.nn.primitives import BatchNorm2d, Conv2d

    records, handles = {}, []

    def fwd(m, inp, out):
        records[m] = {"x": inp[0]}

    def bwd(m, grad_in, grad_out):
        records[m].update(dx=grad_in[0], dy=grad_out[0])

    for m in model.modules():
        if isinstance(m, (Conv2d, BatchNorm2d)):
            handles += [m.register_forward_hook(fwd), m.register_full_backward_hook(bwd)]
    return records, handles


def layer_grad_errs(records, dtype):
    """Each recorded layer's backward against its formula in f32 (TF32
    off) on the layer's own operands, upcast: the largest relative L2 error
    over the layers of the grads the layers give in the compute `dtype`
    (conv dgrad, wgrad and bias grad; BN's input grad) and of those they
    give in f32 (BN's scale and bias grads).  On its own operands a layer
    is not chaotic, so this sees a wrong backward that the whole step's
    bf16 grads, far off the f32 ones at random init, would hide."""
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    from dmayolo_tpu_torch.nn.primitives import BatchNorm2d

    def rel(got, want):
        return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))

    low, f32 = [], []
    for m, r in records.items():
        x, dy = r["x"].to(dtype).float(), r["dy"].float()
        if isinstance(m, BatchNorm2d):
            n = x.numel() // x.shape[1]
            mean = x.mean(dim=(0, 2, 3))
            var = (x.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0)
            rstd = torch.rsqrt(var + m.eps)
            xhat = (x - mean[:, None, None]) * rstd[:, None, None]
            dbias, dscale = dy.sum(dim=(0, 2, 3)), (dy * xhat).sum(dim=(0, 2, 3))
            dx = (dy - (dbias / n)[:, None, None] - xhat * (dscale / n)[:, None, None]) \
                * (rstd * m.weight.detach())[:, None, None]
            low.append(rel(r["dx"], dx))
            f32 += [rel(m.weight.grad, dscale), rel(m.bias.grad, dbias)]
            continue
        w = m.weight.detach().to(dtype).float()
        low.append(rel(m.weight.grad, conv2d_weight(x, w.shape, dy, m.s, m.p, m.d, m.g)))
        if m.bias is not None:
            low.append(rel(m.bias.grad, dy.sum(dim=(0, 2, 3))))
        if r["dx"] is not None:
            low.append(rel(r["dx"], conv2d_input(x.shape, w, dy, m.s, m.p, m.d, m.g)))
    return {"layers": len(records), "low_grads": max(low), "f32_grads": max(f32)}


@contextlib.contextmanager
def bn_backward_in(dtype):
    """The control of the bf16 backward check, a known fault: the BN train
    backward computed in `dtype` instead of f32."""
    import torch

    from dmayolo_tpu_torch.nn.primitives import _BatchNormTrain

    sound = _BatchNormTrain.backward

    def faulty(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        g = dy.to(dtype)
        xhat = (x.to(dtype) - mean.to(dtype)[:, None, None]) * rstd.to(dtype)[:, None, None]
        dbias, dscale = g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        dx = (g - (dbias / n)[:, None, None] - xhat * (dscale / n)[:, None, None]) \
            * (rstd * scale).to(dtype)[:, None, None]
        return dx.to(x.dtype), dscale.float(), dbias.float(), None, None

    _BatchNormTrain.backward = staticmethod(faulty)
    try:
        yield
    finally:
        _BatchNormTrain.backward = sound


def scaled_err(got, want):
    """max over tensors of max |got - want| / (1 + max |want|)."""
    return max(float((got[k] - w).abs().max()) / (1 + float(w.abs().max()))
               for k, w in want.items())


def profile_train_step(step, groups=TRAIN_PROFILE_GROUPS, top=15):
    """One train step under torch.profiler: kernel time by group, the
    device's busy share of the step's wall time, and the CPU-side ops that
    launched the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in avg
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not annotation(e)) / 1e3
    ops = {e.key: e.device_time_total / 1e3 for e in avg
           if e.device_type == torch.autograd.DeviceType.CPU and e.device_time_total > 0}
    by_group = {name: sum(ops.get(k, 0.0) for k in ((key,) if isinstance(key, str) else key))
                for name, key in groups}
    by_group["other"] = device_ms - sum(by_group.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms, "groups_ms": by_group,
            "top_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:top]}


def train_checks(device, cfg, nc, recipe, check_imgsz, seed, bf16_checks=True):
    """One f32 step (batch 2, `check_imgsz`, TF32 off) of the recipe's loss
    on the card against the host CPU's; with `bf16_checks`, the bf16 step's
    loss against it and its backward layer by layer, with a control fault."""
    import numpy as np
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel

    out = {}
    # ---- one step, f32 on the card (TF32 off) against f32 on the host CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = DetectionModel(cfg, nc=nc, device="cpu")
    sd = cpu_model.init_with_priors(torch.Generator().manual_seed(seed)).state_dict()
    small = train_batches(1, 2, check_imgsz, nc, recipe["max_targets"], seed)[0]
    replay = ReplayedAssignment() if recipe["assignment"] == "tal" else None
    kw = dict(nc=nc, recipe=recipe, replay=replay)
    t0 = time.perf_counter()
    want = one_train_step(torch.device("cpu"), cfg, sd, small, torch.float32, **kw)
    out["cpu_step_s"] = time.perf_counter() - t0
    tol = dict(TRAIN_F32_TOL)
    if replay is not None:  # the CPU's noise: the same step on one thread
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            other = one_train_step(torch.device("cpu"), cfg, sd, small, torch.float32, **kw)
        finally:
            torch.set_num_threads(n)
        noise = {"grad": scaled_err(other[1], want[1]), "param": scaled_err(other[2], want[2])}
        out["f32_cpu_noise"] = noise
        tol.update({k: max(tol[k], TRAIN_F32_NOISE_FACTOR * v) for k, v in noise.items()})
    got = one_train_step(device, cfg, sd, small, torch.float32, **kw)
    if replay is not None:
        out["tal_assignment"] = ta = replay.report
        check(ta["labels_and_fg_equal_on_the_cpu_inputs"] and ta["boxes_max_abs_err"] <= 1e-4
              and ta["scores_max_abs_err"] <= 1e-5 and ta["fg_cells"] > 0,
              f"TAL's assignment on the card differs from the CPU's on the same inputs: {ta}")
    f32 = {"loss_rel_err": max(abs(got[0][k] - want[0][k]) / abs(want[0][k]) for k in want[0]),
           "grad_scaled_err": scaled_err(got[1], want[1]),
           "param_scaled_err": scaled_err(got[2], want[2]), "metrics_cpu": want[0],
           "metrics_card": got[0], "tol": tol}
    out["f32_card_vs_cpu"] = f32
    check(all(np.isfinite(v) for v in want[0].values()), f"non-finite CPU loss {want[0]}")
    check(f32["loss_rel_err"] <= tol["loss"] and f32["grad_scaled_err"] <= tol["grad"]
          and f32["param_scaled_err"] <= tol["param"],
          f"the f32 train step on the card differs from the CPU's: {f32}")
    if not bf16_checks:
        return out
    bf16 = one_train_step(device, cfg, sd, small, torch.bfloat16, layers=True, **kw)
    with bn_backward_in(torch.bfloat16):
        control = one_train_step(device, cfg, sd, small, torch.bfloat16, layers=True, **kw)[3]
    sq = lambda gs: sum(float(g.double().square().sum()) for g in gs)  # noqa: E731
    b16 = out["bf16_vs_f32"] = {
        "metrics_bf16": bf16[0],
        "loss_rel_err": abs(bf16[0]["loss"] - want[0]["loss"]) / want[0]["loss"],
        # read, not checked: the train-mode forward at random init amplifies
        # bf16 rounding layer by layer, so the whole step's grads are far
        # off the f32 ones whatever the backward does
        "grad_rel_l2": (sq(bf16[1][k] - g for k, g in want[1].items()) / sq(want[1].values()))
        ** 0.5,
        "layers": bf16[3], "control_bn_backward_in_bf16": control}
    check(b16["loss_rel_err"] <= TRAIN_BF16_LOSS_TOL,
          f"the bf16 step's loss is off the f32 one: {b16}")
    check(bf16[3]["master_dtypes"] == ["torch.float32"]
          and all(bf16[3][k] <= tol for k, tol in TRAIN_BF16_LAYER_TOL.items()),
          f"a layer's bf16 backward is off its formula: {b16}")
    check(any(control[k] > tol for k, tol in TRAIN_BF16_LAYER_TOL.items()),
          f"the bf16 backward check misses the control's fault: {b16}")
    return out


def train(device, cfg=None, nc=10, recipe=RECIPE, imgsz=None, check_imgsz=640,
          n_batches=TRAIN_BATCHES, warmup_batches=TRAIN_WARMUP_BATCHES, accs=TRAIN_ACCS,
          counters=(), seed=7, checks=("f32", "bf16"), probe=None, orbax=None):
    """The training path: the `checks` of `train_checks` ("f32": the card's
    f32 step against the host's; "bf16": the bf16 step's loss against f32
    and its backward layer by layer, with a control fault), the recipe's
    Trainer over an in-memory epoch (finite losses, the reference cadence,
    img/s after `warmup_batches`, peak memory), step times at `accs`, one
    step profiled, and the EMA checkpoint held against the live EMA and
    served on "matrix" (K3 counted) equal to "scan".  A `probe`
    (`TrainProbe`) watches the Trainer's model over the epoch (`before`,
    `after`; its findings in "probe").  `orbax` (`ORBAX`'s keys) runs
    `orbax_phase` on the state after the timed steps (its findings in
    "orbax").  On the
    CPU (a rehearsal at a small `cfg` and size) nothing is timed."""
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel, model_config
    from dmayolo_tpu_torch.nn.primitives import lend_generator
    from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp
    from dmayolo_tpu_torch.utils.weights import load_jax_checkpoint

    cfg = cfg or model_config(FLAGSHIP)
    imgsz = imgsz or recipe["imgsz"]
    on_card = device.type == "cuda"
    out = {"recipe": dict(recipe, imgsz=imgsz), "batches": n_batches}

    if checks:
        out.update(train_checks(device, cfg, nc, recipe, check_imgsz, seed, "bf16" in checks))

    # ---- the recipe: Trainer over an in-memory epoch, bf16, Adam
    b = recipe["batch"]
    batches = train_batches(n_batches, b, imgsz, nc, recipe["max_targets"], seed + 1)
    loader = TimedLoader(batches, warmup_batches, timed=on_card)
    run_dir = ROOT / "build" / "train_smoke"
    shutil.rmtree(run_dir, ignore_errors=True)
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        np.random.seed(seed)  # autoanchor's draws
        tr = Trainer(cfg, loader, load_hyp(recipe["hyp"]), nc=nc, epochs=1,
                     batch_size=b, img_size=imgsz, adam=recipe["adam"], out_dir=str(run_dir),
                     dtype=torch.bfloat16, seed=seed, device=device,
                     assignment=recipe["assignment"], autoanchor=recipe["autoanchor"])
        if recipe["autoanchor"]:
            out["anchors_px"] = (tr.model.head.anchors
                                 * tr.model.stride.reshape(-1, 1, 1)).round(2).tolist()
            check(float(np.min(tr.model.head.anchors)) > 0, "autoanchor left degenerate anchors")
        losses, step_for = [], tr.get_step

        def recorded(acc):  # the Trainer's steps, each one's metrics kept
            step = step_for(acc)

            def run(*args, **kw):
                losses.append(step(*args, **kw))
                return losses[-1]
            return run

        tr.get_step = recorded
        if probe is not None:
            probe.before(tr)
        tr.train(log_every=n_batches)
        state = tr.state
        tr.get_step = step_for
        if probe is not None:
            out["probe"] = probe.after(tr, state, batches[0], dtype=torch.bfloat16
                                       if on_card else torch.float32)
        # the EMA's and the model's tensors as `last.npz` holds them (the
        # timed steps below advance the state)
        ema_sd = {k: v.clone() for k, v in state.ema.state_dict().items()}
        model_sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        out["trainer_s"] = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
            out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            window_ms = loader.t0.elapsed_time(loader.t1)
            n_img = (n_batches - warmup_batches) * b
            out.update(window_batches=n_batches - warmup_batches, window_ms=window_ms,
                       img_per_s=n_img / window_ms * 1e3, card=card_state())
        out["losses"] = [{k: float(v) for k, v in m.items()} for m in losses]
        check(all(np.isfinite(v) for m in out["losses"] for v in m.values()),
              "a non-finite training loss")
        want_steps = ref_cadence_steps(n_batches, tr.sched.nw, tr.accumulate)
        out.update(accumulate=tr.accumulate, nw=tr.sched.nw, opt_steps=state.step,
                   ema_updates=state.ema_updates, ref_steps=want_steps)
        check(state.step == state.ema_updates == want_steps == len(losses),
              f"optimizer steps {state.step} / EMA updates {state.ema_updates} / "
              f"reference cadence {want_steps}")

        # ---- ms per optimizer step at two accumulates, and one profiled step
        if on_card:
            imgs, tg = tr.to_device(batches[:max(accs)])
            gen = torch.Generator(device=device).manual_seed(seed)  # for Dropout and DropPath
            out["step_ms"] = {}
            for acc in accs:
                n = acc * b
                step = tr.get_step(acc)
                out["step_ms"][acc] = cuda_ms(
                    lambda: step(tr.state, imgs[:n], type(tg)(*(t[:n] for t in tg)), gen), 2)
            step1 = tr.get_step(1)
            out["profile"] = profile_train_step(
                lambda: step1(tr.state, imgs[:b], type(tg)(*(t[:b] for t in tg)), gen))
            del imgs, tg
        if orbax is not None:  # after the peak memory and the step times are read
            out["orbax"] = orbax_phase(device, tr, counters, nc=nc, **orbax)
        anchors = getattr(tr.model.head, "anchors", None)
        del tr, state

        # ---- the EMA checkpoint (`last.npz`, written by save_checkpoint),
        # read back: the EMA's tensors rounded to f16, exactly; the model on
        # them gives the EMA's head within that rounding, a 3x3 layout fault
        # does not.  Both heads in train mode: at these few steps the
        # running statistics are far from the batch's, and in eval mode the
        # features fade to a head of nearly its biases alone (the statistics
        # are held by the exact check).  Then fused and served one batch on
        # "matrix" (K3), at a conf below every image's best score, equal to
        # the plain "scan"
        sd, meta = load_jax_checkpoint(run_dir / "last.npz", device=device)
        f16 = lambda t: t.half().float()  # noqa: E731
        served = DetectionModel(cfg, nc=nc, device=device).train()
        check((anchors is None) == ("anchors" not in meta), "anchors missing or extra in meta")
        if anchors is not None:  # the trained anchors, autoanchor's where it ran
            served.head.anchors = np.asarray(meta["anchors"], np.float32)
            check(np.array_equal(served.head.anchors, anchors), "meta anchors are not the head's")
        x, _ = rectangles(8, check_imgsz, nc, seed + 2)
        xf = torch.from_numpy(x).to(device).float() / 255.0

        def head(state_dict):  # raw head, f32, unfused, BN on the batch's moments, the
            # same DropPath masks each time
            served.load_state_dict(state_dict, strict=True)
            g = torch.Generator(device=device).manual_seed(seed)
            with torch.inference_mode(), lend_generator(served, g):
                return served(xf, torch.float32)

        ema_head = head(ema_sd)

        def head_err(state_dict):  # relative L2 to the head's spread over images and cells
            return max(float((g - w).norm() / (w - w.mean(dim=(0, 1, 2))).norm())
                       for g, w in zip(head(state_dict), ema_head))

        flipped = {k: v.transpose(2, 3) if v.dim() == 4 and v.shape[2] == 3 else v
                   for k, v in sd.items()}
        ck = out["checkpoint"] = {
            "tensors": len(sd),
            "not_ema_f16": sum(not torch.equal(sd[k], f16(v)) for k, v in ema_sd.items()),
            # read: how many tensors tell the EMA from the model in f16 here
            "model_differs_from_ema_f16": sum(not torch.equal(f16(v), f16(ema_sd[k]))
                                              for k, v in model_sd.items()),
            "control_3x3_transposed_head_err": head_err(flipped),
            "head_err": head_err(sd), "meta_epoch": meta["epoch"]}
        check(not ck["not_ema_f16"] and ck["head_err"] <= TRAIN_CKPT_HEAD_TOL
              < ck["control_3x3_transposed_head_err"],
              f"the checkpoint does not hold the EMA model: {ck}")
        del ema_head, ema_sd, model_sd, flipped
        served.load_state_dict(sd, strict=True)
        served.eval().fuse()
        dtype = torch.bfloat16 if on_card else torch.float32
        with torch.inference_mode():
            raw = served.apply(xf.to(dtype), dtype=dtype, fused=True)
            conf = min(0.25, 0.5 * float(served.decode_parts(raw)[1].amax(1).min()))
            for c in counters:
                c.launches = 0
            lazy = served.lazy_tails
            dets, valid = served.serve_detections(raw, conf_thres=conf, backend="matrix")
            launches = {c.__name__: c.launches for c in counters}
            lazy = served.lazy_tails - lazy
            want_dets, want_valid = served.serve_detections(raw, conf_thres=conf,
                                                            backend="scan")
        out["checkpoint_serve"] = {"launches": launches, "conf_thres": conf,
                                   "detections": int(valid.sum()), "lazy_tails": lazy}
        check(bool(torch.isfinite(dets).all()) and dets.shape == (8, 300, 6)
              and int(valid.sum()) > 0 and torch.equal(valid, want_valid)
              and torch.equal(dets, want_dets),
              f"bad detections from the trained checkpoint: {out['checkpoint_serve']}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the JAX package's Orbax checkpoints, read and written by the port
# ---------------------------------------------------------------------------

ORBAX = dict(batch=128, imgsz=640)
ORBAX_DIR = ROOT / "build" / "orbax_smoke"
ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "orbax_jax_tiny"


def same_bits(a, t) -> bool:
    """A numpy array and a tensor (any device) hold the same bytes,
    compared where the tensor lies."""
    import torch

    w = torch.from_numpy(a)
    return (w.shape == t.shape and w.dtype == t.dtype
            and torch.equal(w.reshape(-1).view(torch.uint8).to(t.device),
                            t.reshape(-1).view(torch.uint8)))


def orbax_phase(device, tr, counters, batch=128, imgsz=640, nc=10, seed=19):
    """The `Trainer`'s full state (`state_trees`: six trees) through the
    port's Orbax checkpoint (`utils/orbax_ckpt.py`): written by
    `AsyncTrainCheckpointer` under build/orbax_smoke/ (timed: the call,
    and until `wait` returns), restored onto `device` (timed), every leaf
    equal to the last bit and the meta the Trainer's; the model built from
    the restored meta (cfg, nc, anchors) and EMA trees, BN-folded, serving
    one `batch` of
    `imgsz` rectangle images on "matrix" (K3 counted) at a conf under
    every image's best score: the same detections as the in-memory EMA
    model's.  Then the committed JAX fixture (tests/fixtures/
    orbax_jax_tiny: chunked by device, zstd) read onto `device`, every leaf
    equal to its `expected.npz`.  The directory is removed."""
    import copy
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.train.step import state_trees
    from dmayolo_tpu_torch.utils import zstd
    from dmayolo_tpu_torch.utils.orbax_ckpt import AsyncTrainCheckpointer, restore
    from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

    on_card = device.type == "cuda"
    t_phase = t0 = time.perf_counter()
    trees = state_trees(tr.state)
    meta = tr.checkpoint_meta(0)
    out = {"pull_s": time.perf_counter() - t0, "zstd_version": zstd.version(),
           "leaves": sum(len(t) for t in trees.values()),
           "params": sum(a.size for a in trees["params"].values()),
           "raw_bytes": sum(a.nbytes for t in trees.values() for a in t.values())}
    path = ORBAX_DIR / "last_orbax"
    shutil.rmtree(ORBAX_DIR, ignore_errors=True)
    try:
        ck = AsyncTrainCheckpointer()
        t0 = time.perf_counter()
        ck.save(path, trees, meta=meta)
        out["write_call_s"] = time.perf_counter() - t0
        ck.wait()
        out["write_s"] = time.perf_counter() - t0
        ck.close()
        out["dir_bytes"] = ck.last_bytes
        t0 = time.perf_counter()
        got, got_meta = restore(path, device=device)
        if on_card:
            torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["write_gb_per_s"] = out["raw_bytes"] / out["write_s"] / 1e9
        out["restore_gb_per_s"] = out["raw_bytes"] / out["restore_s"] / 1e9
        check(got_meta == json.loads(json.dumps(meta)), f"restored meta {got_meta} is not {meta}")
        check(sorted(got) == sorted(trees) and all(sorted(got[n]) == sorted(t)
                                                   for n, t in trees.items()),
              "the restored trees' keys are not the state's")
        out["unequal_leaves"] = [f"{n} {k}" for n, t in trees.items() for k, a in t.items()
                                 if not same_bits(a, got[n][k])]
        check(not out["unequal_leaves"], f"restored leaves differ: {out['unequal_leaves'][:5]}")
        del trees

        # ---- the model from the restored trees against the in-memory EMA model
        ema = [{k: v.cpu().numpy() for k, v in got[n].items()} for n in ("ema_params", "ema_stats")]
        del got
        restored = DetectionModel(got_meta["cfg"], nc=got_meta["nc"], device=device)
        restored.load_state_dict(state_dict_from_jax(*ema, device=device), strict=True)
        if "anchors" in got_meta:
            restored.head.anchors = np.asarray(got_meta["anchors"], np.float32)
        del ema
        live = copy.deepcopy(tr.state.ema)
        dtype = torch.bfloat16 if on_card else torch.float32
        x, _ = rectangles(batch, imgsz, nc, seed)
        x = torch.from_numpy(x).to(device).to(dtype) / 255.0
        sets = {}
        with torch.inference_mode():
            for name, model in (("live", live), ("restored", restored)):
                model.eval().fuse()
                raw = model.apply(x, dtype=dtype, fused=True)
                if name == "live":
                    conf = min(0.25, 0.5 * float(model.decode_parts(raw)[1].amax(1).min()))
                for c in counters:
                    c.launches = 0
                sets[name] = model.serve_detections(raw, conf_thres=conf, backend="matrix")
                launches = {c.__name__: c.launches for c in counters}
                del raw
        (d, v), (wd, wv) = sets["restored"], sets["live"]
        out["serve"] = {"batch": batch, "imgsz": imgsz, "conf_thres": conf,
                        "detections": int(v.sum()), "launches": launches}
        check(bool(torch.isfinite(d).all()) and int(v.sum()) > 0 and torch.equal(v, wv)
              and torch.equal(d, wd),
              f"the restored model's detections differ from the in-memory model's: {out['serve']}")
        del live, restored, sets, x, d, v, wd, wv
    finally:
        shutil.rmtree(ORBAX_DIR, ignore_errors=True)

    # ---- the JAX package's own save, committed: chunks assembled, zstd
    t0 = time.perf_counter()
    got, fmeta = restore(ORBAX_FIXTURE / "last_orbax", device=device)
    with np.load(ORBAX_FIXTURE / "expected.npz") as z:
        want = {k: z[k] for k in z.files}
    have = {"|".join((n, *k)): v for n, t in got.items() for k, v in t.items()}
    out["fixture"] = {"leaves": len(have), "nc": fmeta.get("nc"), "s": time.perf_counter() - t0,
                      "unequal": sorted(k for k in want if k not in have
                                        or not same_bits(want[k], have[k]))}
    check(sorted(have) == sorted(want) and not out["fixture"]["unequal"],
          f"the JAX fixture reads wrong: {out['fixture']}")
    out["s"] = time.perf_counter() - t_phase
    return out


def print_orbax(ob, smi):
    print(f"orbax: the flagship Trainer's state, {ob['leaves']} leaves, {ob['params'] / 1e6:.2f} M "
          f"parameters a model tree, {ob['raw_bytes'] / 1e9:.3f} GB raw, {ob['dir_bytes'] / 1e9:.3f} "
          f"GB on disk (zstd 1, libzstd {ob['zstd_version']}); pull {ob['pull_s']:.2f} s; write "
          f"call {ob['write_call_s']:.3f} s, until wait {ob['write_s']:.2f} s "
          f"({ob['write_gb_per_s']:.3f} GB/s); restore onto the card {ob['restore_s']:.2f} s "
          f"({ob['restore_gb_per_s']:.3f} GB/s); every leaf bit-equal; the restored model's "
          f"bs{ob['serve']['batch']} {ob['serve']['imgsz']} px serve on 'matrix' "
          f"{ob['serve']['detections']} detections equal to the in-memory model's, K3 "
          f"{ob['serve']['launches']['fixpoint_keep']} launch; the JAX fixture's "
          f"{ob['fixture']['leaves']} leaves equal to expected.npz; phase {ob['s']:.1f} s; on {smi}",
          flush=True)


# ---------------------------------------------------------------------------
# the SPD-Conv family (P2-P5 heads): C3CASPD2 and CASPD_ODRTA
# ---------------------------------------------------------------------------

# the depth the SPD, zoo and sweep models run at (their yamls' is 1.0):
# each path runs as before at full width, a third of the repeats (the
# spatial phase's cut; the flagship, the main path, keeps its depth)
EARLIER_DEPTH = 0.33


def at_earlier_depth(name):
    """The yaml of `name` as a dict, at `EARLIER_DEPTH`."""
    import yaml

    from dmayolo_tpu_torch.graph import model_config

    with open(model_config(name)) as f:
        cfg = yaml.safe_load(f)
    cfg["depth_multiple"] = min(cfg["depth_multiple"], EARLIER_DEPTH)
    return cfg


SPD_MODELS = ("C3CASPD2", "CASPD_ODRTA")
# the author's recipes, train.sh:10-13 (C3CASPD2 on UAVDT) and :15-19
# (CASPD_ODRTA on VisDrone), from init_with_priors: their yolov5l.npz start
# is not in the repo
SPD_RECIPES = {
    "C3CASPD2": dict(imgsz=1024, batch=8, adam=True, hyp="scratch", max_targets=128,
                     assignment="anchor", autoanchor=True),
    "CASPD_ODRTA": dict(imgsz=1536, batch=4, adam=True, hyp="visdrone", max_targets=128,
                        assignment="tal", autoanchor=False),
}
SPD_TRAIN_BATCHES, SPD_WARMUP_BATCHES = 5, 2  # 3 timed loader batches
SPD_TRAIN_CHECKS = {"C3CASPD2": (), "CASPD_ODRTA": ("f32",)}  # TAL's f32 step vs the CPU
SPD_TTA_BATCH = {"C3CASPD2": 0, "CASPD_ODRTA": 8}  # TTA over TDetect's four levels


def spd_model(device, name, cfg=None, imgsz=640, nc=10, seed=0, n_images=64, hyp=None,
              anchor_cache=None):
    """`build_model` of an SPD or zoo yaml (or `cfg`); an anchor head's
    placeholders (`anchors: n`) are replaced by autoanchor on the labels
    of `n_images` seeded rectangle images first (global NumPy seed `seed`,
    threshold from `hyp`, else the model's SPD recipe).  With an
    `anchor_cache` dict, a head whose levels, anchors a level and strides
    were autoanchored before takes that result (autoanchor's anchors
    depend on nothing else here).  Returns (model, recall kept or None)."""
    import types

    import numpy as np

    from dmayolo_tpu_torch.graph import model_config
    from dmayolo_tpu_torch.nn.heads import Detect
    from dmayolo_tpu_torch.train.autoanchor import maybe_autoanchor
    from dmayolo_tpu_torch.train.trainer import load_hyp

    model = build_model(device, imgsz=imgsz, cfg=cfg or model_config(name), nc=nc)
    if not isinstance(model.head, Detect) or float(np.min(model.head.anchors)) > 0:
        return model, None
    head, strides = model.head, model.stride.reshape(-1, 1, 1)
    key = (head.nl, head.na, tuple(model.stride.tolist()))
    if anchor_cache is not None and key in anchor_cache:
        px, bpr = anchor_cache[key]
        head.anchors = (px / strides).astype(np.float32)
        return model, bpr
    shapes, labels = labels_of(train_batches(1, n_images, imgsz, nc, 128, seed))
    np.random.seed(seed)
    bpr = maybe_autoanchor(model, types.SimpleNamespace(shapes=shapes, labels=labels), imgsz,
                           thr=load_hyp(hyp or SPD_RECIPES[name]["hyp"])["anchor_t"],
                           verbose=False)
    check(float(np.min(head.anchors)) > 0, f"{name}: autoanchor left degenerate anchors")
    if anchor_cache is not None:
        anchor_cache[key] = (head.anchors * strides, bpr)
    return model, bpr


def serve_and_evaluate(device, label, model, counters, smi, imgsz, batch, tta_batch,
                       check_imgsz):
    """A model's serving on both kernels (K2, then K3 counted; a TDetect
    head's serving tails counted on the lazy route, every Detect tail on
    the eager one), the three serving tails identical, the raw head on the
    card against the CPU's at `check_imgsz`, bs128 timed and profiled;
    then the eval protocol on the three backends (identical, K2 streaming
    and K3's blocked entry counted) with `tta_batch` TTA images.  Prints
    the summary lines; returns (serving, eval)."""
    from dmayolo_tpu_torch.nn.heads import TDetect

    on_card = device.type == "cuda"
    tdetect = isinstance(model.head, TDetect)
    srv = serving(device, model, imgsz=imgsz, max_batch=batch, counters=counters,
                  check_imgsz=check_imgsz)
    print(f"{label} serving: " + json.dumps(srv), flush=True)
    check(not on_card or srv["batcher_pallas"]["launches"]["nms_greedy"] > 0,
          f"{label}: K2 did not launch on the serving path with backend 'pallas'")
    check(srv["batcher_default"]["backend"] == "matrix"
          and (not on_card or srv["batcher_default"]["launches"]["fixpoint_keep"] > 0),
          f"{label}: K3 did not launch on the serving path with the default backend")
    for key in ("batcher_pallas", "batcher_default"):
        check((srv[key]["lazy_tails"] > 0) == tdetect,
              f"{label}: the serving tail took the wrong route: {srv[key]['lazy_tails']} lazy")
    for sfx, backend in (("", "pallas"), ("_matrix", "matrix")) if "serve_batch" in srv else ():
        prof = srv["profile" + sfx]
        print(f"{label} serving bs{srv['serve_batch']} 640px bf16 NMS '{backend}'"
              f"{' (lazy tail)' if tdetect else ''}: {srv['serve_img_per_s' + sfx]:.1f} img/s "
              f"({srv['serve_ms' + sfx]:.2f} ms/batch), peak {srv['peak_mem_gib' + sfx]:.2f} "
              f"GiB; raw head card vs CPU f32 {srv['f32_card_vs_cpu_max_abs_err']:.2e} (max "
              f"|head| {srv['f32_raw_max_abs']:.1f}); on {smi}", flush=True)
        print(f"{label} serving profile ('{backend}'), device ms: "
              + ", ".join(f"{g} {ms:.2f}" for g, ms in prof["groups_ms"].items())
              + "; ranges: " + ", ".join(f"{g} {ms:.2f}" for g, ms in prof["ranges_ms"].items())
              + f"; device {prof['device_ms']:.2f} ms, busy {prof['device_busy_share']:.3f}; "
              f"on {smi}", flush=True)
    ev = evaluate(device, model, imgsz=imgsz, batch=batch, counters=counters,
                  tta_batch=tta_batch)
    print(f"{label} eval: " + json.dumps(ev), flush=True)
    if on_card:
        check_eval_launches(label, ev)
        print(f"{label} eval parts, ms: "
              + ", ".join(f"{p} {ms:.2f}" for p, ms in ev["parts_ms"].items()), flush=True)
    for backend, res in ev["backends"].items() if on_card else ():
        print(f"{label} eval bs{ev['batch']} 640px bf16 max_nms 30000 NMS '{backend}': "
              f"{res['img_per_s']:.1f} img/s ({res['step_ms']:.2f} ms/batch), "
              f"{res['detections']} detections; P {ev['metrics']['mp']:.4f} R "
              f"{ev['metrics']['mr']:.4f} mAP@.5 {ev['metrics']['map50']:.4f}; on {smi}",
              flush=True)
    return srv, ev


def spd_phase(device, name, counters, smi, sites, cfg=None, imgsz=640, batch=32,
              site_batch=128, train_kw=None):
    """One SPD model (its yaml, or `cfg`): serving on both kernels (K2,
    then K3; TDetect's lazy tail counted), the three serving tails and eval
    backends identical, eval with its host mAP (TTA for TDetect), its 3x3
    stride-1 conv sites at `site_batch` into `sites`, then the author's
    recipe through the Trainer (`train_kw` to `train`) and the trained
    checkpoint served on "matrix".  The sizes are for a CPU rehearsal."""
    import torch

    from dmayolo_tpu_torch.graph import model_config
    from dmayolo_tpu_torch.nn.heads import TDetect

    cfg = cfg or model_config(name)
    model, bpr = spd_model(device, name, cfg, imgsz)
    tdetect = isinstance(model.head, TDetect)
    out = {"head": type(model.head).__name__, "autoanchor_bpr": bpr,
           "anchors_px": (None if tdetect else
                          (model.head.anchors * model.stride.reshape(-1, 1, 1)).round(2).tolist())}
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    xs = torch.rand(site_batch, imgsz, imgsz, 3, device=device,
                    generator=torch.Generator(device=device).manual_seed(6)).to(dtype)
    sites[name] = conv3x3_sites(model, xs, dtype)
    del xs
    # the raw head at 256 px: at 64 and 128 px C3CASPD2's head, on BN
    # statistics of 640 px inputs, moves by 8.3e-4 and 2.9e-3 of its largest
    # value between f32 and f64 on the CPU alone, at 256 px by 3.1e-5
    # (chip_conditioning.py)
    out["serving"], out["eval"] = serve_and_evaluate(
        device, name, model, counters, smi, imgsz=imgsz, batch=batch,
        tta_batch=min(SPD_TTA_BATCH[name], batch), check_imgsz=min(256, imgsz))
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kw = dict(dict(n_batches=SPD_TRAIN_BATCHES, warmup_batches=SPD_WARMUP_BATCHES, accs=(1,),
                   checks=SPD_TRAIN_CHECKS[name]), **(train_kw or {}))
    out["train"] = tr = train(device, cfg=cfg, recipe=SPD_RECIPES[name], counters=counters,
                              **kw)
    print(f"{name} train: " + json.dumps(tr), flush=True)
    check((tr["checkpoint_serve"]["lazy_tails"] > 0) == tdetect
          and (device.type != "cuda" or tr["checkpoint_serve"]["launches"]["fixpoint_keep"] > 0),
          f"{name}: the trained checkpoint's serving on 'matrix': {tr['checkpoint_serve']}")
    if device.type == "cuda":
        print_train(f"{name} train", tr, smi)
        torch.cuda.empty_cache()
    return out


def check_eval_launches(name, ev):
    check(ev["backends"]["pallas"]["launches"]["nms_greedy_stream_cluster"] > 0,
          f"{name}: K2 streaming did not launch its cluster kernel on the eval path")
    matrix = ev["backends"]["matrix"]["launches"]
    check(matrix["fixpoint_keep_blocked"] == 1 and matrix["fixpoint_keep"] == 0,
          f"{name}: the eval on 'matrix' should launch K3's blocked entry once a batch, and "
          f"its one-block entry never: {matrix}")


def union_sites(sites):
    """{shape: count} over several models' conv sites (the larger count)."""
    out = {}
    for s in sites.values():
        for shape, n in s.items():
            out[shape] = max(out.get(shape, 0), n)
    return dict(sorted(out.items(), key=lambda kv: (-kv[0][0], kv[0][2], kv[0][3])))


def site_sums(rows, sites):
    """K1's, cuDNN's and the bound's ms over one model's conv `sites`, each
    shape weighted by its count, from the timed `rows` of
    `check_conv_flagship`."""
    by_shape = {tuple(r["shape"][1:]): r for r in rows}
    out = {"convs": sum(sites.values()), "shapes": len(sites)}
    for key in ("ms", "kernel_ms", "library_ms", "bound_ms"):
        out[f"step_{key}"] = sum(n * by_shape[shape][key] for shape, n in sites.items())
    return out


def print_train(label, tr, smi):
    """The train phase's summary lines."""
    rc = tr["recipe"]
    if "f32_card_vs_cpu" in tr:
        f32 = tr["f32_card_vs_cpu"]
        tol, noise = f32["tol"], tr.get("f32_cpu_noise")
        print(f"{label} f32 step ({rc['assignment']}), card (TF32 off) vs CPU, bs2 640px: loss "
              f"rel err {f32['loss_rel_err']:.2e} (tol {tol['loss']:.2e}), grads scaled err "
              f"{f32['grad_scaled_err']:.2e} (tol {tol['grad']:.2e}), updated params "
              f"{f32['param_scaled_err']:.2e} (tol {tol['param']:.2e})"
              + (f"; the CPU's own noise (1 thread vs all): grads {noise['grad']:.2e}, params "
                 f"{noise['param']:.2e}, tol {TRAIN_F32_NOISE_FACTOR}x it where above "
                 f"{TRAIN_F32_TOL['grad']} / {TRAIN_F32_TOL['param']}" if noise else "")
              + f"; CPU step {tr['cpu_step_s']:.1f} s", flush=True)
    if "tal_assignment" in tr:
        ta = tr["tal_assignment"]
        print(f"{label} TAL assignment on the card from the CPU step's inputs: labels and "
              f"foreground equal {ta['labels_and_fg_equal_on_the_cpu_inputs']} ({ta['fg_cells']} "
              f"foreground cells), boxes {ta['boxes_max_abs_err']:.2e} px, scores "
              f"{ta['scores_max_abs_err']:.2e}; on the card's own predictions "
              f"{ta['fg_cells_differing_on_own_inputs']} cells differ (read); both steps use the "
              f"CPU's assignment", flush=True)
    if "bf16_vs_f32" in tr:
        b16 = tr["bf16_vs_f32"]
        print(f"{label} bf16 step loss vs f32 {b16['loss_rel_err']:.2e} (tol "
              f"{TRAIN_BF16_LOSS_TOL}); each of {b16['layers']['layers']} convs' and BNs' "
              f"backward vs its f32 formula on its own operands, rel L2: bf16 grads "
              f"{b16['layers']['low_grads']:.2e} (tol {TRAIN_BF16_LAYER_TOL['low_grads']:.2e}), "
              f"f32 grads {b16['layers']['f32_grads']:.2e} (tol "
              f"{TRAIN_BF16_LAYER_TOL['f32_grads']}); control (BN backward in bf16): "
              f"{b16['control_bn_backward_in_bf16']['low_grads']:.2e}, "
              f"{b16['control_bn_backward_in_bf16']['f32_grads']:.2e}; the whole step's grads "
              f"vs f32, rel L2 {b16['grad_rel_l2']:.3f} (read)")
    print(f"{label} {rc['imgsz']}px bs{rc['batch']} Adam bf16 hyp {rc['hyp']} "
          f"({rc['assignment']}{', autoanchor' if rc['autoanchor'] else ''}): "
          f"{tr['img_per_s']:.1f} img/s over {tr['window_batches']} loader batches "
          f"({tr['opt_steps']} optimizer steps in the epoch, accumulate ramp from 1 toward "
          f"{tr['accumulate']}); ms per optimizer step: "
          + ", ".join(f"accumulate {a} {ms:.1f}" for a, ms in tr["step_ms"].items())
          + f"; peak memory {tr['peak_mem_gib']:.2f} GiB; on {smi}", flush=True)
    ck, cs = tr["checkpoint"], tr["checkpoint_serve"]
    print(f"{label} checkpoint: {ck['tensors']} tensors, the EMA's in f16 exactly "
          f"({ck['model_differs_from_ema_f16']} differ from the model's); head rel err "
          f"{ck['head_err']:.3e} (tol {TRAIN_CKPT_HEAD_TOL}), control (3x3 kernels transposed) "
          f"{ck['control_3x3_transposed_head_err']:.3f}; served {cs['detections']} detections "
          f"at conf {cs['conf_thres']:.3g} on 'matrix' ({cs['lazy_tails']} lazy tails), equal "
          f"to 'scan'", flush=True)
    prof = tr["profile"]
    print(f"{label} step profile (accumulate 1, bs{rc['batch']} {rc['imgsz']}px), ms: "
          + ", ".join(f"{g} {ms:.2f}" for g, ms in prof["groups_ms"].items())
          + f"; device busy {prof['device_busy_share']:.3f} of {prof['wall_ms']:.1f} ms wall; "
          f"on {smi}", flush=True)



# ---------------------------------------------------------------------------
# the zoo: the whole DMA-YOLO and TPH-YOLOv5 (Swin, BiFPN)
# ---------------------------------------------------------------------------

DMA_HORNET = "ca-sppfcspc-bifpn-scconv-adapt-hornet"
ZOO_MODELS = {"yolov5l-ca-sppfcspc-bifpn-scconv": "DMA-full", "yolov5l-xs-tph": "TPH",
              DMA_HORNET: "DMA-HorNet", "CADMM": "CADMM", "ghostnet": "ghostnet"}
# DMA-full and DMA-HorNet train at the flagship's recipe (train.sh:5-9); the
# others are served and evaluated only.  `anchors: 4` placeholders (TPH,
# CADMM, ghostnet) are autoanchored at hyp VisDrone's anchor_t (TPH-YOLOv5
# is a VisDrone model)
ZOO_RECIPES = {"yolov5l-ca-sppfcspc-bifpn-scconv": RECIPE, DMA_HORNET: RECIPE}
# the other new yamls of the zoo, each built at full width on the card,
# served once on "matrix" and its raw head held against the CPU's at 256
# px, as `zoo_phase` holds its models': at 128 px CADM's head (C3CASPD2's
# layout: a 3x3 conv then space-to-depth at each stride) differed by 1.9%
# of its largest value (on an H100 80GB HBM3 at 700 W), the
# ill-conditioning that chip_conditioning.py measured for C3CASPD2 at
# 64-128 px on BN statistics calibrated at 640 px
SWEEP_MODELS = ("C3CASPD6", "CADM", "CADMM2", "CASMM", "CASMMsiou", "CMCA", "CSPCM", "ConvMix",
                "DM", "adaptadd", "adaptca", "adaptconcat",
                "ca-sppfcspc-bifpn-scconv-adapt-gnconv", "hornet", "hornet2", "hornet3",
                "spdconv", "spdconv2", "yolo_convmix", "yolo_cspcm", "yolov3-tiny",
                "yolov5s-ghost")
SWEEP_BATCH, SWEEP_CHECK_IMGSZ = 8, 256
# where a head is ill-conditioned even at 256 px (CMCA: the CPU's f32 and
# f64 heads 7.5e-3 of the largest value apart, the card's f32 head 7.3e-3
# from the f64 one, on an H100 80GB HBM3 at 700 W), the card's f32 head is
# held within this factor of the CPU's own f32-to-f64 distance (each f32
# forward lies about one such distance from f64; in the f64 forward only
# AdConcat's products round through f32)
SWEEP_F64_FACTOR = 2
# autoanchor's result by (levels, anchors a level, strides), for the zoo's
# and the sweep's placeholder heads (one hyp, one label set: one result)
ANCHOR_CACHE = {}
HORBLOCK_GAMMA = 1e-6  # HorBlock's LayerScale init, never optimized (optimizer group "frozen")
ZOO_HYP = "visdrone"
ZOO_TTA_BATCH = 8
SAME_SEED_LOSS_TOL = 1e-6  # relative, two train-mode losses from one generator seed


class TrainProbe:
    """What the zoo's training must show: every BiFPN `w` (AdConcat,
    Adapt_Add; optimizer group g1) moved, every frozen parameter (the Swin
    bias tables, HorBlock's gammas) stayed, each HorBlock gamma at its
    1e-6 init, each DropPath above rate 0 ran in train mode and dropped
    whole samples, and one generator seed gives one loss (a train-mode
    forward and loss of one batch, under `lend_generator`, twice from one
    seed and once from another, on a copy of the trained model)."""

    def before(self, tr):
        import torch

        from dmayolo_tpu_torch.nn.primitives import DropPath
        from dmayolo_tpu_torch.train.optim import param_groups

        labels = param_groups(tr.model)
        named = dict(tr.model.named_parameters())
        self.frozen = {k: named[k].detach().clone() for k, g in labels.items() if g == "frozen"}
        self.bifpn = {k: named[k].detach().clone() for k, g in labels.items()
                      if g == "g1" and k.endswith(".w")}
        self.calls, self.dropped = {}, {}

        def hook(name):
            def count(m, args, out):
                if m.training:
                    self.calls[name] = self.calls.get(name, 0) + 1
                    self.dropped[name] = (self.dropped.get(name, 0)
                                          + (out.flatten(1) == 0).all(1).sum())
            return count

        self.handles = [m.register_forward_hook(hook(n)) for n, m in tr.model.named_modules()
                        if isinstance(m, DropPath) and m.rate > 0]
        self.rates = sorted({m.rate for m in tr.model.modules() if isinstance(m, DropPath)})

    def after(self, tr, state, batch, dtype):
        import copy

        import torch

        from dmayolo_tpu_torch.nn.primitives import lend_generator

        for h in self.handles:
            h.remove()
        named = dict(state.model.named_parameters())
        gammas = [t for k, t in named.items() if k.endswith((".gamma1", ".gamma2"))]
        out = {"horblock_gamma_tensors": len(gammas),
               "horblock_gamma_off_init": sum(int((t != HORBLOCK_GAMMA).sum()) for t in gammas),
               "bifpn_w": {k: named[k].detach().cpu().tolist() for k in self.bifpn},
               "bifpn_w_moved": sum(not torch.equal(named[k], v) for k, v in self.bifpn.items()),
               "bifpn_w_tensors": len(self.bifpn), "frozen_tensors": len(self.frozen),
               "frozen_changed": sum(not torch.equal(named[k], v)
                                     for k, v in self.frozen.items()),
               "droppath_rates": self.rates,
               "droppath_layers": len(self.handles), "droppath_calls": sum(self.calls.values()),
               "droppath_dropped_samples": int(sum(int(d) for d in self.dropped.values()))}
        model = copy.deepcopy(state.model).train()
        imgs, tg = tr.to_device([batch])
        x = imgs.to(dtype) / 255.0
        losses = []
        with torch.no_grad():
            for seed in (11, 11, 12):
                g = torch.Generator(device=x.device).manual_seed(seed)
                with lend_generator(model, g):
                    losses.append(float(tr.loss(model(x, dtype), tg)[0]))
        del model
        out["seed_losses"] = losses
        out["same_seed_rel_diff"] = abs(losses[1] - losses[0]) / abs(losses[0])
        out["other_seed_rel_diff"] = abs(losses[2] - losses[0]) / abs(losses[0])
        return out


def zoo_phase(device, name, counters, smi, cfg=None, imgsz=640, batch=32, train_kw=None,
              check_imgsz=256):
    """One zoo model (its yaml, or `cfg`): serving on both kernels (K2,
    then K3), the three serving tails and eval backends identical, the raw
    head on the card against the CPU's at `check_imgsz`, eval with its
    host mAP and one TTA batch; where it has a recipe, the Trainer over
    in-memory batches watched by `TrainProbe` and the trained checkpoint
    served on "matrix".  The sizes are for a CPU rehearsal."""
    import torch

    from dmayolo_tpu_torch.graph import model_config
    from dmayolo_tpu_torch.nn.hornet import HorBlock
    from dmayolo_tpu_torch.nn.transformer import SwinTransformerLayer, TransformerLayer

    label = ZOO_MODELS.get(name, name)
    cfg = cfg or model_config(name)
    on_card = device.type == "cuda"
    model, bpr = spd_model(device, name, cfg, imgsz, hyp=ZOO_HYP, anchor_cache=ANCHOR_CACHE)
    out = {"label": label, "params": sum(p.numel() for p in model.parameters()),
           "swin_layers": sum(isinstance(m, SwinTransformerLayer) for m in model.modules()),
           "vit_layers": sum(isinstance(m, TransformerLayer) for m in model.modules()),
           "horblocks": sum(isinstance(m, HorBlock) for m in model.modules()),
           "depthwise_convs": sum(getattr(m, "depthwise", False) for m in model.modules()),
           "autoanchor_bpr": bpr,
           "anchors_px": (model.head.anchors * model.stride.reshape(-1, 1, 1)).round(2).tolist()}
    out["serving"], out["eval"] = serve_and_evaluate(
        device, label, model, counters, smi, imgsz=imgsz, batch=batch,
        tta_batch=min(ZOO_TTA_BATCH, batch), check_imgsz=min(check_imgsz, imgsz))
    del model
    if on_card:
        torch.cuda.empty_cache()
    if name not in ZOO_RECIPES:
        return out
    probe = TrainProbe()
    kw = dict(dict(n_batches=SPD_TRAIN_BATCHES, warmup_batches=SPD_WARMUP_BATCHES, accs=(1,),
                   checks=()), **(train_kw or {}))
    out["train"] = tr = train(device, cfg=cfg, recipe=ZOO_RECIPES[name], counters=counters,
                              probe=probe, **kw)
    print(f"{label} train: " + json.dumps(tr), flush=True)
    pr = tr["probe"]
    # each check where the model has the layers it reads; a model without
    # any of them shows it in its counts
    check(pr["bifpn_w_moved"] == pr["bifpn_w_tensors"],
          f"{label}: a BiFPN w did not move in training: {pr}")
    check(pr["frozen_tensors"] > 0 and pr["frozen_changed"] == 0,
          f"{label}: a frozen parameter moved in training: {pr}")
    check(pr["horblock_gamma_off_init"] == 0,
          f"{label}: a HorBlock gamma left its init {HORBLOCK_GAMMA} in training: {pr}")
    # a Swin layer's DropPath runs twice a forward: after the attention and the MLP
    check(pr["droppath_calls"] == 2 * pr["droppath_layers"] * tr["batches"]
          and (not on_card or pr["droppath_layers"] == 0
               or pr["droppath_dropped_samples"] > 0),
          f"{label}: DropPath did not run in train mode: {pr}")
    check(pr["same_seed_rel_diff"] <= SAME_SEED_LOSS_TOL,
          f"{label}: one seed gave two losses: {pr['seed_losses']}")
    check(not on_card or tr["checkpoint_serve"]["launches"]["fixpoint_keep"] > 0,
          f"{label}: the trained checkpoint's serving on 'matrix': {tr['checkpoint_serve']}")
    if on_card:
        print_train(f"{label} train", tr, smi)
        print(f"{label} train probe: {pr['bifpn_w_moved']}/{pr['bifpn_w_tensors']} BiFPN w "
              f"moved, {pr['frozen_changed']}/{pr['frozen_tensors']} frozen tensors changed, "
              f"{pr['horblock_gamma_off_init']} elements of {pr['horblock_gamma_tensors']} "
              f"HorBlock gammas off {HORBLOCK_GAMMA}; "
              f"DropPath rates {pr['droppath_rates']}: {pr['droppath_layers']} layers above 0 "
              f"ran {pr['droppath_calls']} times in train mode, dropped "
              f"{pr['droppath_dropped_samples']} samples; one seed's losses differ by "
              f"{pr['same_seed_rel_diff']:.2e}, another seed's by "
              f"{pr['other_seed_rel_diff']:.2e} (read)", flush=True)
        torch.cuda.empty_cache()
    return out


def sweep_model(device, name, counters, cfg=None, imgsz=640, batch=SWEEP_BATCH,
                check_imgsz=SWEEP_CHECK_IMGSZ):
    """One yaml (or `cfg`) of the zoo at its own width: built on the card
    as the zoo's models are (seeded weights, head priors, BN calibrated,
    placeholder anchors autoanchored), one uint8 batch served through
    `MicroBatcher`'s serving step on "matrix" (BN folded; K3 counted from 0
    just before), and the f32 raw head on the card against the host CPU's
    at `check_imgsz`: within 1e-3 of max(1, the head's largest value), or,
    where the CPU's f32 head lies further than that from its f64 one,
    within `SWEEP_F64_FACTOR` times that distance.  Returns
    its parameters, build and serve seconds, peak memory and launches."""
    import copy

    import torch

    from dmayolo_tpu_torch.serve.batcher import MicroBatcher

    torch.backends.cudnn.allow_tf32 = False  # the f32 card-vs-CPU check below
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    model, bpr = spd_model(device, name, cfg, imgsz, hyp=ZOO_HYP, anchor_cache=ANCHOR_CACHE)
    out = {"params": sum(p.numel() for p in model.parameters()), "levels": len(model.stride),
           "autoanchor_bpr": bpr, "build_s": time.perf_counter() - t0}
    dtype = torch.bfloat16 if on_card else torch.float32
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (batch, imgsz, imgsz, 3), generator=g, dtype=torch.uint8).to(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    batcher = MicroBatcher(model, imgsz=imgsz, max_batch=batch, dtype=dtype, device=device)
    del model
    try:
        t1 = time.perf_counter()
        for c in counters:
            c.launches = 0
        d, v = batcher._serve(x)
        valid = int(v.sum())
        out["launches"] = {c.__name__: c.launches for c in counters}
        out["serve_s"] = time.perf_counter() - t1
    finally:
        batcher.close()
    out["backend"], out["detections"] = batcher._serve_kw["backend"], valid
    check(d.shape == (batch, 300, 6) and bool(torch.isfinite(d).all()),
          f"{name}: bad serving output {tuple(d.shape)}")
    check(out["backend"] == "matrix" and (not on_card or out["launches"]["fixpoint_keep"] == 1),
          f"{name}: K3 did not launch once serving one batch on 'matrix': {out['launches']}")
    if on_card:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    fused = batcher.model
    xs = torch.rand(1, check_imgsz, check_imgsz, 3, generator=g)
    with torch.inference_mode():
        want = [r.float() for r in fused.to("cpu").apply(xs, fused=True)]
        fused.to(device)
        got = [r.float().cpu() for r in fused.apply(xs.to(device), fused=True)]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    out["f32_card_vs_cpu_max_abs_err"], out["f32_raw_max_abs"] = err, scale
    tol = 1e-3 * max(1.0, scale)
    if err > tol:
        # an ill-conditioned head: the CPU's own f32 rounding, its distance
        # to the f64 forward, bounds what any f32 forward can hold to
        m64 = copy.deepcopy(fused).to("cpu").double()
        with torch.inference_mode():
            f64 = m64.apply(xs.double(), dtype=torch.float64, fused=True)
        out["cpu_f32_vs_f64_max_abs"] = max(float((a.double() - b).abs().max())
                                            for a, b in zip(want, f64))
        tol = max(tol, SWEEP_F64_FACTOR * out["cpu_f32_vs_f64_max_abs"])
        del m64
    out["f32_tol"] = tol
    check(err <= tol, f"{name}: raw head on the card differs from the CPU by {err} (tol {tol}, "
          f"max |head| {scale})")
    del batcher, fused
    if on_card:
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the data path: a dataset on disk, the loader, run_validation, the Trainer
# ---------------------------------------------------------------------------

# VisDrone's pixel scale on VisDrone-size frames: the train recipe's 1536 px;
# 128 images, so that generation stays under 30 s on a slow host (192 took
# 19.6-30.5 s on 8 threads).  The val passes read the 64 val files through
# `val_copies` symlinked copies each: 10 batches of 32, so that 8 loader
# threads (each takes a whole batch) stay busy past a round.  The
# Trainer reads `train_copies` copies of the train files: an epoch of 64
# batches, at accumulate 4, so that the optimizer steps 16 times as a
# 16-batch epoch at accumulate 1 would (the warmup's bias lr of 0.1 pulls
# the objectness down each step; then no score passes the protocol's
# conf gate and no best.npz is kept).  The loader runs up to 24 batches
# ahead (16 queued, 8 in its threads) and finishes its last sample near
# batch 40, after which the steps run without it: the epoch is timed
# unprofiled over batches `train_timed` (after the fill and the first two
# optimizer steps) and profiled over `train_profiled`, both while the
# loader still works.
DATA = dict(img_size=1536, n_train=64, n_val=64, val_copies=5, train_copies=4, val_imgsz=640,
            val_batch=32, train_batch=4, train_accumulate=4, train_val=32,
            one_worker_batches={"val": 1, "train": 1}, train_timed=(8, 32),
            train_profiled=(32, 40), train_device_aug=(False,),  # on: cli.train --device-aug
            clahe_batches=1, mixed_detect_imgsz=1536)
DATA_DIR = ROOT / "build" / "data_smoke"
DEVICE_AUG_TOL = 1e-5  # device_aug on the card against its CPU version, same gains and flips
TARGET_TOL_PX = 1e-3  # the loader's targets mapped back to native pixels, against the labels


def loader_pass(ds, batch, workers, n_batches, shuffle, seed=0):
    """The first `n_batches` batches of one epoch of a `DataLoader` over
    `ds` with `workers` threads, and the seconds from the iterator's start
    at which each arrived (read before the loop stops the loader, whose
    threads may be busy with later batches)."""
    from dmayolo_tpu_torch.data.loader import DataLoader

    loader = DataLoader(ds, batch, max_targets=256, shuffle=shuffle, workers=workers,
                        seed=seed, drop_last=False)
    out, at = [], []
    t0 = time.perf_counter()
    for b in loader:
        at.append(time.perf_counter() - t0)
        out.append(b)
        if len(out) == n_batches:
            break
    return out, at


def loader_rates(one, at1, many, at_n, workers):
    """img/s at 1 worker (to the last batch's arrival), and at `workers`:
    over the whole pass (the pipeline's fill included) and after its first
    round of `workers` batches."""
    def n_img(batches):
        return sum(len(b.indices) for b in batches)

    check(len(many) > workers, f"{len(many)} batches do not outlast {workers} loader threads")
    return {"img_per_s_1": n_img(one) / at1[-1], f"img_per_s_{workers}": n_img(many) / at_n[-1],
            f"img_per_s_{workers}_after_first_round":
                n_img(many[workers:]) / (at_n[-1] - at_n[workers - 1]),
            "batches_1": len(one), f"batches_{workers}": len(many)}


def replicate_split(root, split, copies):
    """`root`'s split (images and label files) as `copies` symlinked copies
    of each file, under `root/<split>_x<copies>`; the image directory."""
    dst = root / f"{split}_x{copies}"
    for kind, suffix in (("images", None), ("labels", ".txt")):
        d = dst / kind / split
        d.mkdir(parents=True)
        for f in sorted((root / kind / split).iterdir()):
            if suffix is None or f.suffix == suffix:
                for k in range(copies):
                    (d / f"r{k}_{f.name}").symlink_to(f)
    return dst / "images" / split


def same_batches(a, b):
    import numpy as np

    return len(a) == len(b) and all(
        x.indices == y.indices and np.array_equal(x.images, y.images)
        and all(np.array_equal(u, v) for u, v in zip(x.targets, y.targets)) for x, y in zip(a, b))


def targets_vs_labels(ds, batches, imgsz):
    """The largest distance in native pixels between the loader's targets,
    mapped back through the letterbox, and the label files' boxes (clipped
    to the image as the loader clips them)."""
    import numpy as np

    from dmayolo_tpu_torch.eval.validator import _scale_to_native

    worst = 0.0
    for b in batches:
        h, w = b.images.shape[1:3]
        for i, idx in enumerate(b.indices):
            m = b.targets.mask[i]
            xywh = b.targets.box[i][m].astype(np.float64) * [w, h, w, h]
            got = _scale_to_native(np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2,
                                                   xywh[:, :2] + xywh[:, 2:] / 2], 1),
                                   (h, w), tuple(ds.shapes[idx]))
            nh, nw = ds.shapes[idx]
            rows = np.loadtxt(ds.label_files[idx], ndmin=2)
            lb = rows[:, 1:5] * [nw, nh, nw, nh]
            want = np.concatenate([lb[:, :2] - lb[:, 2:] / 2, lb[:, :2] + lb[:, 2:] / 2], 1)
            gain = min(h / nh, w / nw)  # the loader keeps boxes 1e-3 px inside its image
            want = np.clip(want, 0, [(w - 1e-3) / gain, (h - 1e-3) / gain] * 2)
            check(len(rows) == len(got) and np.array_equal(rows[:, 0], b.targets.cls[i][m]),
                  f"targets of {ds.im_files[idx]} are not its labels")
            worst = max(worst, float(np.abs(got - want).max()) if len(got) else 0.0)
    return worst


def coco_known_answer(val_path, nc):
    """`build_coco_gt_from_yolo` on the val set, its annotations fed back
    as detections at score 1: COCOeval's mAP must be 1."""
    from dmayolo_tpu_torch.eval.coco_json import build_coco_gt_from_yolo
    from dmayolo_tpu_torch.eval.cocoeval import NpCOCOeval

    gt = json.loads(json.dumps(build_coco_gt_from_yolo(val_path, nc=nc)))  # as a file holds it
    preds = [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"],
              "score": 1.0} for a in gt["annotations"]]
    stats = NpCOCOeval(gt, preds).evaluate().summarize(verbose=False)
    m, m50 = float(stats[0]), float(stats[1])
    check(m == m50 == 1.0, f"COCOeval of the labels as detections: mAP {m}, mAP@.5 {m50}")
    return {"images": len(gt["images"]), "annotations": len(gt["annotations"]),
            "map": m, "map50": m50}


class WindowedLoader:
    """A loader whose epoch is measured on the card in two windows of
    batches, each from a synchronised mark when its first batch arrives to
    one when the batch after its last arrives (its steps done): `timed`,
    unprofiled (wall time, the time the training loop waited for the
    loader in it, and the samples the loader made in it), then `profiled`,
    under torch.profiler (the device's kernel time, and so its busy share
    of that window's wall time).  The batches before `timed` are timed
    from the iterator's start (the pipeline's fill).  Untimed on the
    CPU."""

    def __init__(self, loader, on_card, timed, profiled):
        self.loader, self.on_card = loader, on_card
        self.timed, self.profiled = timed, profiled
        self.windows = None

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):  # sample_weights and the rest
        return getattr(self.loader, name)

    def __iter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not self.on_card:
            yield from self.loader
            return
        (a, b), (p, q) = self.timed, self.profiled
        check(b <= p < q <= len(self.loader), f"windows {self.timed} {self.profiled} do not fit "
                                              f"an epoch of {len(self.loader)} batches")
        def mark(key):
            torch.cuda.synchronize()
            marks[key] = time.perf_counter()

        ds, made = self.loader.ds, []
        get = ds.get

        def timed_get(*args):  # when each sample is made, on the loader's threads
            sample = get(*args)
            made.append(time.perf_counter())
            return sample

        marks, waits, handed, prof = {}, [], [], profile(activities=[ProfilerActivity.CUDA])
        ds.get = timed_get
        try:
            mark("start")
            it = iter(self.loader)
            for i in range(len(self.loader)):
                t = time.perf_counter()
                batch = next(it)
                handed.append(time.perf_counter())
                waits.append(handed[-1] - t)
                if i == q:  # the profiled window ends before its trace is read
                    mark("q")
                    prof.__exit__(None, None, None)
                if i in (a, b):
                    mark(i)
                if i == p:  # and starts once the profiler runs
                    prof.__enter__()
                    mark("p")
                yield batch
            if q == len(self.loader):
                mark("q")
                prof.__exit__(None, None, None)
        finally:
            del ds.get
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        bs, fill, timed, profiled = (self.loader.bs, marks[a] - marks["start"],
                                     marks[b] - marks[a], marks["q"] - marks["p"])
        self.windows = {
            "fill": {"batches": a, "wall_s": fill, "img_per_s": a * bs / fill},
            "timed": {"batches": [a, b], "wall_s": timed, "img_per_s": (b - a) * bs / timed,
                      "loader_wait_s": sum(waits[a + 1:b + 1]),
                      "loader_img_per_s": sum(marks[a] <= t < marks[b] for t in made) / timed},
            "profiled": {"batches": [p, q], "wall_s": profiled,
                         "img_per_s_under_profiler": (q - p) * bs / profiled,
                         "loader_wait_s": sum(waits[p + 1:q + 1]), "device_ms": device_ms,
                         "device_busy_share": device_ms / (profiled * 1e3)},
            "loader_done_s": max(made) - marks["start"],
            "loader_wait_s_by_batch": waits,
            "handed_out_s_by_batch": [t - marks["start"] for t in handed]}
        self.windows["profiled"]["loader_done_before_end"] = max(made) < marks["q"]


def own_labels(model, val_dir, imgsz, batch, dtype, workers, max_det=20):
    """Rewrite the label files of `val_dir` as `model`'s top `max_det`
    detections an image (conf 0, NMS IoU 0.6), in native pixels."""
    import numpy as np

    from dmayolo_tpu_torch.data.datasets import DetectionDataset
    from dmayolo_tpu_torch.data.loader import DataLoader
    from dmayolo_tpu_torch.eval.validator import _scale_to_native, make_infer_fn

    ds = DetectionDataset(val_dir, img_size=imgsz, nc=model.nc, stride=int(model.stride.max()))
    was_training = model.training
    model.eval()
    infer = make_infer_fn(model, 0.0, 0.6, max_det, dtype=dtype)
    for b in DataLoader(ds, batch, shuffle=False, drop_last=False, workers=workers):
        dets, valid = infer(b.images)
        dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
        for i, idx in enumerate(b.indices):
            nh, nw = ds.shapes[idx]
            d = dets[i][valid[i]]
            xy = _scale_to_native(d[:, :4].astype(np.float64), b.images.shape[1:3], (nh, nw))
            keep = (xy[:, 2] > xy[:, 0]) & (xy[:, 3] > xy[:, 1])
            with open(ds.label_files[idx], "w") as f:
                for (x1, y1, x2, y2), c in zip(xy[keep], d[keep, 5]):
                    f.write(f"{int(c)} {(x1 + x2) / 2 / nw:.6f} {(y1 + y2) / 2 / nh:.6f} "
                            f"{(x2 - x1) / nw:.6f} {(y2 - y1) / nh:.6f}\n")
    model.train(was_training)


def data_train(device, data_yaml, cfg, sizes, counters, device_aug, workers, pretrained,
               seed=7):
    """The recipe's Trainer built from the data yaml, one epoch from the
    `pretrained` checkpoint: finite losses, validation at the epoch's end,
    last.npz and best.npz, the CSV's metrics; img/s over an unprofiled
    window and the device's busy share over a profiled one
    (`WindowedLoader`); best.npz served on "matrix" (K3 counted)."""
    import csv
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.data.loader import DataLoader
    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.train import trainer as trainer_mod
    from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp
    from dmayolo_tpu_torch.utils.weights import load_jax_checkpoint

    on_card = device.type == "cuda"
    out_dir = DATA_DIR / f"train_device_aug_{int(device_aug)}"
    shutil.rmtree(out_dir, ignore_errors=True)
    dtype = torch.bfloat16 if on_card else torch.float32
    parts, t0 = {}, time.perf_counter()
    tr = Trainer(cfg, data=str(data_yaml), hyp=load_hyp("visdrone"), epochs=1,
                 batch_size=sizes["train_batch"], img_size=sizes["img_size"], adam=True,
                 accumulate=sizes["train_accumulate"], dtype=dtype, seed=seed, device=device,
                 out_dir=str(out_dir), workers=workers, device_aug=device_aug,
                 pretrained=str(pretrained))
    check(isinstance(tr.loader, DataLoader), "the data-built Trainer has no DataLoader")
    parts["build_s"] = time.perf_counter() - t0
    tr.loader = WindowedLoader(tr.loader, on_card, sizes["train_timed"], sizes["train_profiled"])
    vals, real, save = [], trainer_mod.run_validation, tr._save
    parts.update(val_s=0.0, own_labels_s=0.0, save_s=0.0)

    def counted(model, data_path, **k):
        # the known answer: the val split labelled with the validated
        # model's own detections just before validation (random weights
        # score 0 on the generated labels, and then no best.npz is kept)
        t1 = time.perf_counter()
        own_labels(model, data_path, k["img_size"], k["batch_size"], k["dtype"], workers)
        t2 = time.perf_counter()
        vals.append(real(model, data_path, **k))
        parts["own_labels_s"] += t2 - t1
        parts["val_s"] += time.perf_counter() - t2
        return vals[-1]

    def timed_save(*a):
        t1 = time.perf_counter()
        save(*a)
        parts["save_s"] += time.perf_counter() - t1

    tr._save = timed_save

    trainer_mod.run_validation = counted
    losses, step_for = [], tr.get_step

    def recorded(acc):
        step = step_for(acc)

        def run(*args, **kw):
            losses.append(step(*args, **kw))
            return losses[-1]
        return run

    tr.get_step = recorded
    try:
        t0 = time.perf_counter()
        tr.train(log_every=len(tr.loader))
        total_s = time.perf_counter() - t0
    finally:
        trainer_mod.run_validation = real
    out = {"device_aug": device_aug, "batches": len(tr.loader), "trainer_s": total_s,
           "parts_s": parts,
           "losses": [{k: float(v) for k, v in m.items()} for m in losses],
           "best_fitness": tr.best_fitness}
    check(len(vals) == 1, f"validation ran {len(vals)} times in one epoch")
    check(all(np.isfinite(v) for m in out["losses"] for v in m.values()) and losses,
          "a non-finite training loss on data")
    out["val"] = {k: getattr(vals[0], k) for k in ("mp", "mr", "map50", "map75", "map", "nt")}
    rows = list(csv.DictReader(open(out_dir / "results.csv")))
    check(len(rows) == 1 and rows[0]["metrics/mAP_0.5"] != "" and "fitness" in rows[0],
          f"the CSV lacks the metrics: {rows}")
    check((out_dir / "last.npz").exists() and (out_dir / "best.npz").exists(),
          f"last.npz and best.npz not both written (best fitness {tr.best_fitness})")
    if tr.loader.windows is not None:
        out["windows"] = dict(tr.loader.windows, card=card_state())
    # best.npz served: fused, one val batch on "matrix", K3 counted
    t1 = time.perf_counter()
    sd, meta = load_jax_checkpoint(out_dir / "best.npz", device=device)
    served = DetectionModel(cfg, nc=meta["nc"], device=device)
    served.head.anchors = np.asarray(meta["anchors"], np.float32)
    served.load_state_dict(sd, strict=True)
    served.eval().fuse()
    b = next(iter(DataLoader(tr.train_ds, sizes["train_batch"], shuffle=False, workers=workers)))
    x = torch.from_numpy(b.images).to(device).to(dtype) / 255.0
    with torch.inference_mode():
        raw = served.apply(x, dtype=dtype, fused=True)
        conf = min(0.25, 0.5 * float(served.decode_parts(raw)[1].amax(1).min()))
        for c in counters:
            c.launches = 0
        dets, valid = served.serve_detections(raw, conf_thres=conf, backend="matrix")
        launches = {c.__name__: c.launches for c in counters}
    out["best_serve"] = {"launches": launches, "conf_thres": conf, "detections": int(valid.sum()),
                         "best_epoch": meta["epoch"]}
    check(bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0,
          f"bad detections from best.npz: {out['best_serve']}")
    if on_card:
        check(launches["fixpoint_keep"] > 0, "K3 did not launch serving best.npz on 'matrix'")
    parts["serve_best_s"] = time.perf_counter() - t1
    shutil.rmtree(out_dir, ignore_errors=True)
    return out


def device_aug_check(device, images):
    """device_aug on the card against its plain CPU version on the same
    uint8 batch, gains and flips."""
    import torch

    from dmayolo_tpu_torch.data.device_aug import apply_hsv_flip, augment_batch

    x = torch.from_numpy(images).to(device)
    g = torch.Generator(device=device).manual_seed(11)
    got, flipped = augment_batch(x, g, hgain=0.4, sgain=0.3, vgain=0.5)
    u = torch.rand((x.shape[0], 3), generator=torch.Generator(device=device).manual_seed(11),
                   device=device)  # the gains augment_batch drew, drawn again
    gains = u * 2.0 - 1.0
    gains = gains * torch.tensor([0.4, 0.3, 0.5], device=device) + 1.0
    want = apply_hsv_flip(x.cpu(), gains.cpu(), flipped.cpu())
    err = float((got.cpu() - want).abs().max())
    check(err <= DEVICE_AUG_TOL, f"device_aug on {device} vs the CPU: {err}")
    return {"images": int(x.shape[0]), "flipped": int(flipped.sum()), "max_abs_err": err,
            "tol": DEVICE_AUG_TOL}


def video_probe(libs):
    """OpenCV as the port reaches it (`imageio._cv2()`, the one place it is
    imported): its version, the "Video I/O" lines of its build
    information, whether an `mp4v` write -> read round trip and a webp
    encode -> decode round trip work (each reported, not raised: the
    video and format checks fail on their own), and whether `ldconfig`
    lists NVDEC's `libnvcuvid` (a fact for a later decode route)."""
    import numpy as np

    from dmayolo_tpu_torch.data import imageio, video

    cv2 = imageio._cv2()
    info = cv2.getBuildInformation().splitlines()
    at = next(i for i, ln in enumerate(info) if ln.strip() == "Video I/O:")
    indent = len(info[at]) - len(info[at].lstrip())
    vio = [info[at].strip()]
    for ln in info[at + 1:]:
        if not ln.strip() or len(ln) - len(ln.lstrip()) <= indent:
            break
        vio.append(" ".join(ln.split()))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, 120, 160, 3), dtype=np.uint8)
    path = ROOT / "build" / "video_probe.mp4"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        w = video.Writer(path, 10, (160, 120))
        for f in frames:
            w.write(f)
        w.release()
        mp4v = {"frames_written": len(frames), "frames_read": video.count_frames(path)}
    except OSError as err:  # reported here; the tools' video part fails on it
        mp4v = {"error": str(err)}
    finally:
        path.unlink(missing_ok=True)
    img = frames[0]
    webp = imageio.imdecode(imageio._webp_encode(img, "probe"))
    return {"cv2": cv2.__version__, "video_io": vio,
            "mp4v_round_trip": mp4v.get("frames_read") == len(frames), "mp4v": mp4v,
            "webp_lossless_round_trip": bool(np.array_equal(webp, img)),
            "libnvcuvid": sorted({ln.split()[0] for ln in libs.splitlines() if "nvcuvid" in ln})}


def machine_probe():
    """What the host offers the data path: which image modules are
    installed (found, not imported, but cv2 through `video_probe`), the CPU
    count, the JPEG and PNG headers and libraries, nvJPEG, g++, whether
    the port's host library was built with JPEG, and OpenCV's video and
    webp codecs."""
    import importlib.util
    import os
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    from dmayolo_tpu_torch.data.imageio import jpeg_available, jpeg_codec

    cuda = Path(CUDA_HOME or "/usr/local/cuda")
    libs = ""
    if shutil.which("ldconfig"):
        libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    return {
        "modules_found": {m: importlib.util.find_spec(m) is not None
                          for m in ("cv2", "PIL", "torchvision", "triton", "matplotlib",
                                    "pandas", "onnx")},
        "cpu_count": os.cpu_count(),
        "headers": {h: Path(h).exists() for h in ("/usr/include/jpeglib.h",
                                                   "/usr/include/turbojpeg.h",
                                                   "/usr/include/png.h", "/usr/include/zlib.h",
                                                   str(cuda / "include" / "nvjpeg.h"))},
        "ldconfig": sorted({line.split()[0] for line in libs.splitlines()
                            if any(k in line for k in ("jpeg", "png", "libz."))}),
        "nvjpeg_libs": sorted(p.name for p in (cuda / "lib64").glob("libnvjpeg*")),
        "gxx": gxx.stdout.splitlines()[0],
        "jpeg": jpeg_available() and jpeg_codec(),
        "video": video_probe(libs),
    }


def clahe_cost(train_dir, sizes, stride, nc):
    """The train loader at 1 thread over the same first batches with the
    VisDrone hyp and with `clahe: 1.0` added (CLAHE on every image, on
    LAB's L at a clip limit drawn in [1, 4)): img/s of each, one after the
    other."""
    import numpy as np

    from dmayolo_tpu_torch.data.datasets import DetectionDataset
    from dmayolo_tpu_torch.train.trainer import load_hyp

    out = {"batches": sizes["clahe_batches"], "batch": sizes["train_batch"]}
    for name, extra in (("plain", {}), ("clahe", {"clahe": 1.0})):
        ds = DetectionDataset(train_dir, img_size=sizes["img_size"], augment=True,
                              hyp={**load_hyp("visdrone"), **extra}, stride=stride, nc=nc)
        got, at = loader_pass(ds, sizes["train_batch"], 1, sizes["clahe_batches"], True)
        n = sum(len(b.indices) for b in got)
        check(len(got) == sizes["clahe_batches"]
              and all(np.asarray(b.images).shape[1:3] == (sizes["img_size"],) * 2 for b in got),
              f"the train loader with {name}: {len(got)} batches")
        out[f"img_per_s_{name}"] = n / at[-1]
        out[f"ms_an_image_{name}"] = at[-1] / n * 1e3
    out["clahe_ms_an_image"] = out["ms_an_image_clahe"] - out["ms_an_image_plain"]
    return out


# the data phase's val copies in other formats: BMP and TIFF as the port
# writes them, the JPEG itself under an EXIF orientation (its labels
# turned into the frame that orientation gives), lossless webp (cv2's
# default) and a lossy one at q80 (through cv2's libwebp), and a DNG
# whose IFD0 is the RGB image (an LZW TIFF with DNGVersion; `cli.detect`
# takes no `.dng` from a folder, as JAX's)
MIXED_KINDS = ("bmp", "bmp", "tif", "tif", "tif", "o3", "o6", "o8", "webp", "webp", "dng",
               "webpq80")
MIXED_WEBP_QUALITY = 80


def with_dng_version(tiff: bytes) -> bytes:
    """A little-endian TIFF with DNGVersion (50706) added to its IFD0 (the
    IFD rewritten at the end, its entries kept in tag order)."""
    import struct

    buf = bytearray(tiff)
    ifd = struct.unpack("<I", buf[4:8])[0]
    n = struct.unpack("<H", buf[ifd:ifd + 2])[0]
    entries = [bytes(buf[ifd + 2 + 12 * k:ifd + 14 + 12 * k]) for k in range(n)]
    entries.append(struct.pack("<HHI", 50706, 1, 4) + bytes([1, 4, 0, 0]))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    new_ifd = len(buf) + (len(buf) & 1)
    buf += b"\0" * (len(buf) & 1) + struct.pack("<H", n + 1) + b"".join(entries) + b"\0" * 4
    buf[4:8] = struct.pack("<I", new_ifd)
    return bytes(buf)


def exif_app1(jpeg: bytes, orientation: int) -> bytes:
    """`jpeg` with an APP1 Exif segment whose IFD0 holds the orientation
    (big-endian TIFF), right after its SOI."""
    import struct

    tiff = (b"MM\0*" + struct.pack(">IH", 8, 1) + struct.pack(">HHIH", 0x0112, 3, 1, orientation)
            + b"\0\0" + b"\0" * 4)
    body = b"Exif\0\0" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def turned_labels(rows, orientation):
    """YOLO rows (cls, x, y, w, h) in the frame an EXIF orientation (3, 6
    or 8) turns the image to."""
    import numpy as np

    c, x, y, w, h = rows.T
    if orientation == 3:
        x, y = 1 - x, 1 - y
    elif orientation == 6:  # 90 degrees clockwise
        x, y, w, h = 1 - y, x, h, w
    elif orientation == 8:  # 90 degrees counter-clockwise
        x, y, w, h = y, 1 - x, h, w
    return np.stack([c, x, y, w, h], 1)


def mixed_formats(device, counters, model, weights, cfg, files, sizes, nc, workers):
    """Copies of `files` (val JPEGs and their labels) written as
    `MIXED_KINDS`, and the same decoded arrays as PNG beside them:
    `run_validation` on "matrix" over both (K3 counted; the same txt rows
    and metrics), then `cli.detect` of `weights` (`model`'s checkpoint)
    over the copies at the recipe's size against `serve_detections` of the
    same decoded arrays (the same label lines; K3 counted), its images
    written under their own names and formats (the DNG not among them:
    detect takes no `.dng` from a folder, as JAX's)."""
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.cli import common as cli_common
    from dmayolo_tpu_torch.cli import detect as cli_detect
    from dmayolo_tpu_torch.data import imageio
    from dmayolo_tpu_torch.data.letterbox import letterbox_host
    from dmayolo_tpu_torch.eval.validator import run_validation

    on_card = device.type == "cuda"
    root = DATA_DIR / "mixed"
    shutil.rmtree(root, ignore_errors=True)
    out = {"files": len(files), "kinds": list(MIXED_KINDS[:len(files)])}
    arrays = {}
    t0 = time.perf_counter()
    for tree in ("mixed", "png"):
        for kind in ("images", "labels"):
            (root / tree / kind / "val").mkdir(parents=True)
    for f, kind in zip(files, MIXED_KINDS):
        lb = DATA_DIR / "labels" / "val" / f"{f.stem}.txt"
        rows = np.array([ln.split() for ln in lb.read_text().splitlines() if ln.strip()],
                        np.float64).reshape(-1, 5)
        if kind in ("bmp", "tif", "webp"):
            dst = root / "mixed" / "images" / "val" / f"{f.stem}.{kind}"
            imageio.imwrite(dst, imageio.imread(f))
        elif kind == "webpq80":
            dst = root / "mixed" / "images" / "val" / f"{f.stem}.webp"
            cv2 = imageio._cv2()
            ok, buf = cv2.imencode(".webp", imageio.imread(f),
                                   [cv2.IMWRITE_WEBP_QUALITY, MIXED_WEBP_QUALITY])
            check(ok, f"cv2 could not encode {dst.name} at q{MIXED_WEBP_QUALITY}")
            dst.write_bytes(buf.tobytes())
        elif kind == "dng":
            dst = root / "mixed" / "images" / "val" / f"{f.stem}.dng"
            dst.write_bytes(with_dng_version(imageio._tiff_encode(imageio.imread(f))))
        else:
            dst = root / "mixed" / "images" / "val" / f"{f.stem}.jpg"
            dst.write_bytes(exif_app1(f.read_bytes(), int(kind[1])))
            rows = turned_labels(rows, int(kind[1]))
        arrays[f.stem] = imageio.imread(dst)
        if kind in ("bmp", "tif", "webp", "dng"):  # lossless: the JPEG's own pixels
            check(np.array_equal(arrays[f.stem], imageio.imread(f)),
                  f"{dst.name} does not read back to the pixels written")
        imageio.imwrite(root / "png" / "images" / "val" / f"{f.stem}.png", arrays[f.stem])
        for tree in ("mixed", "png"):
            np.savetxt(root / tree / "labels" / "val" / f"{f.stem}.txt", rows,
                       fmt=["%d"] + ["%.6f"] * 4)
        if kind[0] == "o" and kind != "o3":
            check(arrays[f.stem].shape[:2] == imageio.imread(f).shape[1::-1],
                  f"{dst.name}: EXIF orientation {kind[1]} not applied")
    out["write_s"] = time.perf_counter() - t0
    dtype = torch.bfloat16 if on_card else torch.float32

    def zero():
        for c in counters:
            c.launches = 0

    res = {}
    for tree in ("mixed", "png"):
        zero()
        r = run_validation(model, str(root / tree / "images" / "val"),
                           img_size=sizes["val_imgsz"], batch_size=len(files), nc=nc, dtype=dtype,
                           nms_backend="matrix", save_txt_dir=root / tree / "txt", save_conf=True,
                           workers=workers, device=device)
        res[tree] = {"launches": {c.__name__: c.launches for c in counters},
                     **{k: getattr(r, k) for k in ("mp", "mr", "map50", "map", "nt")}}
    a, b = label_lines(root / "mixed" / "txt"), label_lines(root / "png" / "txt")
    out["run_validation"] = res
    out["run_validation_same_rows"] = a == b and len(a) == len(files)
    check(out["run_validation_same_rows"] and res["mixed"] == res["png"]
          and 0 < res["mixed"]["map50"] < 1,
          f"run_validation on the mixed formats differs from the same arrays as PNG: {res}")
    if on_card:
        check(res["mixed"]["launches"]["fixpoint_keep_blocked"] == 1,
              f"run_validation on the mixed formats: K3's blocked entry once? {res['mixed']}")

    # cli.detect over the copies, against the same decoded arrays served
    cfg_arg = root / "model.yaml"
    if isinstance(cfg, dict):
        cfg_arg.write_text(json.dumps(cfg))  # JSON is YAML
    else:
        cfg_arg = Path(cfg)
    imgsz = sizes["mixed_detect_imgsz"]
    zero()
    t0 = time.perf_counter()
    run = cli_detect.main(["--weights", str(weights), "--cfg", str(cfg_arg), "--source",
                           str(root / "mixed" / "images" / "val"), "--imgsz", str(imgsz),
                           "--batch-size", str(len(files)), "--save-txt", "--save-conf",
                           "--project", str(root / "detect"), "--name", "mixed", "--exist-ok",
                           *(() if on_card else ("--fp32", "--device", "cpu"))])
    out["detect_s"] = time.perf_counter() - t0
    out["detect_launches"] = {c.__name__: c.launches for c in counters}
    labels = label_lines(run / "labels")
    served = cli_common.load_model_from_checkpoint(weights, str(cfg_arg), device=device).fuse()
    sources = sorted(p for p in (root / "mixed" / "images" / "val").iterdir()
                     if p.suffix.lower() in cli_detect.IMG_EXTS)
    names = [p.stem for p in sources]
    x = np.stack([letterbox_host(arrays[k], imgsz, auto=False, stride=int(served.stride.max()))[0]
                  [:, :, ::-1] for k in names])
    with torch.inference_mode():
        xt = torch.as_tensor(x, device=device).to(dtype) / 255.0
        dets, valid = served.serve_detections(served.apply(xt, dtype=dtype, fused=True),
                                              conf_thres=0.25, iou_thres=0.45, max_det=1000,
                                              max_nms=30000)
    dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
    mismatched = [k for i, k in enumerate(names)
                  if det_lines(dets[i][valid[i]], x.shape[1:3], arrays[k].shape[:2])
                  != labels.get(k)]
    out["detect_mismatched"] = mismatched
    out["detections"] = sum(len(v) for v in labels.values())
    written = sorted(p.name for p in run.iterdir() if p.is_file())
    out["detect_written"] = written
    check(not mismatched and out["detections"] > 0,
          f"cli.detect on the mixed formats differs from serving the same arrays: {mismatched}")
    check(len(sources) == len(files) - MIXED_KINDS[:len(files)].count("dng")
          and written == [p.name for p in sources]
          and all(imageio.imread(run / n).shape == arrays[Path(n).stem].shape for n in written),
          f"cli.detect wrote {written}")
    if on_card:
        k3 = out["detect_launches"]
        check(k3["fixpoint_keep_blocked"] + k3["fixpoint_keep"] == 1,
              f"cli.detect on the mixed formats: K3 once? {k3}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def data_phase(device, counters, model, cfg=None, sizes=DATA, nc=10, workers=None):
    """The data path on disk: generate, time the loader alone, run
    `run_validation` on the three backends (counted), check known answers
    on the files, train from the data yaml (`sizes["train_device_aug"]`), and
    hold device_aug against its CPU version.  Writes under build/
    (DATA_DIR), which the caller removes once the CLI phase has read it
    (this phase removes it only when it fails)."""
    import os
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.data.datasets import DetectionDataset
    from dmayolo_tpu_torch.data.imageio import imread, imwrite, jpeg_codec
    from dmayolo_tpu_torch.data.synthetic import generate_visdrone_analog
    from dmayolo_tpu_torch.eval.validator import run_validation
    from dmayolo_tpu_torch.graph import model_config
    from dmayolo_tpu_torch.train.trainer import load_hyp
    from dmayolo_tpu_torch.utils.checkpoint import save_checkpoint
    from dmayolo_tpu_torch.utils.weights import jax_from_state_dict

    on_card = device.type == "cuda"
    cpus = os.cpu_count() or 1
    workers = workers or min(8, cpus)
    # JPEG through this machine's route (nvJPEG on the card); raises where
    # there is none: no PNG set in its place
    ext = "jpg"
    out = {"cpu_count": cpus, "workers": workers, "format": ext, "jpeg_codec": jpeg_codec(),
           "sizes": dict(sizes), "probe": machine_probe()}
    print("data probe: " + json.dumps(out["probe"]), flush=True)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        # ---- 1. the dataset, drawn by the port's generator
        t0 = time.perf_counter()
        data_yaml = generate_visdrone_analog(DATA_DIR, n_train=sizes["n_train"],
                                             n_val=sizes["n_val"], img_size=sizes["img_size"],
                                             seed=0, ext=ext, workers=workers)
        out["generate_s"] = time.perf_counter() - t0
        val_dir, train_dir = str(DATA_DIR / "images" / "val"), str(DATA_DIR / "images" / "train")
        val_many = str(replicate_split(DATA_DIR, "val", sizes["val_copies"]))
        train_many = replicate_split(DATA_DIR, "train", sizes["train_copies"])
        n_val = sizes["n_val"] * sizes["val_copies"]
        files = sorted((DATA_DIR / "images" / "val").iterdir())[:8]
        t0 = time.perf_counter()
        for f in files:
            imread(f)
        out["decode_ms"] = (time.perf_counter() - t0) / len(files) * 1e3
        out["file_mb"] = sum(f.stat().st_size for f in files) / len(files) / 2 ** 20
        # the same pixels as PNG, decoded in the same way, for the comparison
        pngs = DATA_DIR / "png_probe"
        pngs.mkdir()
        for f in files:
            imwrite(pngs / f"{f.stem}.png", imread(f))
        t0 = time.perf_counter()
        for f in files:
            imread(pngs / f"{f.stem}.png")
        out["png_decode_ms"] = (time.perf_counter() - t0) / len(files) * 1e3
        shutil.rmtree(pngs)

        # ---- 2. the loader alone: val (letterbox) and train (the recipe's hyp)
        stride = int(model.stride.max())
        val_ds = DetectionDataset(val_many, img_size=sizes["val_imgsz"], stride=stride, nc=nc)
        train_ds = DetectionDataset(train_dir, img_size=sizes["img_size"], augment=True,
                                    hyp=load_hyp("visdrone"), stride=stride, nc=nc)
        rates = {}
        for name, ds, bs, shuffle in (("val", val_ds, sizes["val_batch"], False),
                                      ("train", train_ds, sizes["train_batch"], True)):
            n1 = sizes["one_worker_batches"][name]
            one, at1 = loader_pass(ds, bs, 1, n1, shuffle)
            many, at_n = loader_pass(ds, bs, workers, -(-len(ds) // bs), shuffle)
            check(same_batches(one, many[:n1]),
                  f"{name} batches differ between 1 and {workers} workers")
            rates[name] = {"batch": bs, **loader_rates(one, at1, many, at_n, workers)}
            if name == "val":
                out["targets_vs_labels_px"] = targets_vs_labels(ds, many, sizes["val_imgsz"])
                check(out["targets_vs_labels_px"] <= TARGET_TOL_PX,
                      f"loader targets vs label files: {out['targets_vs_labels_px']} px")
                val_images = many[0].images
            del one, many
        out["loader"] = rates
        print("data loader: " + json.dumps(rates), flush=True)

        # ---- 3. known answers on the files: COCO's ground truth fed back
        out["coco_known_answer"] = coco_known_answer(val_dir, nc)

        # ---- 4. run_validation on the three backends, the loader included,
        # on the model's own detections written as the labels (the random
        # weights score 0 on the generated ones): a K2 or K3 that kept other
        # boxes than "scan" moves the metrics
        dtype = torch.bfloat16 if on_card else torch.float32
        own_labels(model, val_dir, sizes["val_imgsz"], sizes["val_batch"], dtype, workers)
        t0 = time.perf_counter()  # the label cache, rebuilt for the new labels: not timed below
        DetectionDataset(val_many, img_size=sizes["val_imgsz"], stride=stride, nc=nc)
        out["val_rescan_s"] = time.perf_counter() - t0
        n_batches = -(-n_val // sizes["val_batch"])
        out["run_validation"] = {}
        first = None
        for backend in EVAL_BACKENDS:
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            res = run_validation(model, val_many, img_size=sizes["val_imgsz"],
                                 batch_size=sizes["val_batch"], nc=nc, dtype=dtype,
                                 nms_backend=backend, workers=workers, device=device)
            wall = time.perf_counter() - t0
            r = {"images": n_val, "wall_s": wall, "img_per_s": n_val / wall,
                 "speed_ms": res.speed_ms, "launches": {c.__name__: c.launches for c in counters},
                 **{k: getattr(res, k) for k in ("mp", "mr", "map50", "map75", "map", "nt")}}
            out["run_validation"][backend] = r
            metrics = tuple(r[k] for k in ("mp", "mr", "map50", "map75", "map"))
            check(all(np.isfinite(v) for v in metrics) and r["nt"] > 0
                  and 0 < r["map50"] < 1, f"bad run_validation result on '{backend}': {r}")
            if first is None:
                first = (backend, metrics)
            else:
                check(metrics == first[1], f"run_validation metrics differ between "
                                           f"'{first[0]}' and '{backend}'")
        if on_card:
            lm = out["run_validation"]["matrix"]["launches"]
            lp = out["run_validation"]["pallas"]["launches"]
            check(lm["fixpoint_keep_blocked"] == n_batches and lm["fixpoint_keep"] == 0,
                  f"run_validation on 'matrix': K3's blocked entry once a batch? {lm}")
            check(lp["nms_greedy_stream_cluster"] == n_batches,
                  f"run_validation on 'pallas': K2's cluster kernel once a batch? {lp}")

        print("data run_validation: " + json.dumps(out["run_validation"]), flush=True)

        # ---- 4b. CLAHE's cost in the train loader, at 1 thread
        out["clahe"] = clahe_cost(train_dir, sizes, stride, nc)
        # ---- 4c. 12 val files as BMP, TIFF, EXIF-rotated JPEG, webp and DNG:
        # run_validation and cli.detect against the same decoded arrays
        # (files whose own labels are not empty: a model's boxes that fall in
        # the letterbox's padding are dropped, and some files keep none)
        labelled = [f for f in sorted((DATA_DIR / "images" / "val").iterdir())
                    if (DATA_DIR / "labels" / "val" / f"{f.stem}.txt").read_text().strip()]
        check(len(labelled) >= len(MIXED_KINDS), f"only {len(labelled)} val files have labels")
        start = DATA_DIR / "start.npz"  # the eval weights, also the Trainer's below
        save_checkpoint(start, meta={"nc": nc}, **dict(zip(("params", "stats"),
                                                          jax_from_state_dict(model))))
        out["mixed"] = mixed_formats(device, counters, model, start,
                                     cfg or model_config(FLAGSHIP), labelled[:len(MIXED_KINDS)], sizes,
                                     nc,
                                     workers)
        print("data clahe: " + json.dumps(out["clahe"]) + " mixed formats: "
              + json.dumps(out["mixed"]), flush=True)

        # ---- 5. the Trainer from the data yaml, device_aug off (and on, if asked), each
        # from the eval weights above as its pretrained checkpoint: a fresh
        # init's head priors keep every score under the protocol's conf
        # gate, so no fitness above 0 and no best.npz
        cfg = cfg or model_config(FLAGSHIP)
        val_list = DATA_DIR / "val_train.txt"  # the Trainer validates on the first images
        val_list.write_text("".join(f"{f}\n" for f in
                                    sorted((DATA_DIR / "images" / "val").iterdir())
                                    [:sizes["train_val"]]))
        train_yaml = DATA_DIR / "train.yaml"
        train_yaml.write_text(f"path: {DATA_DIR}\ntrain: {train_many}\nval: {val_list}\n"
                              f"nc: {nc}\n")
        out["train"] = []
        for aug in sizes["train_device_aug"]:  # repeat the pair to see the spread
            out["train"].append(data_train(device, train_yaml, cfg, sizes, counters, aug,
                                           workers, start))
            print("data train: " + json.dumps({k: v for k, v in out["train"][-1].items()
                                                if k != "losses"}), flush=True)

        # ---- 6. device_aug on the card against its CPU version
        out["device_aug"] = device_aug_check(device, val_images)
    except BaseException:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        raise
    return out


def print_data(dp, ev, tr_mem, smi):
    """The data phase's summary lines; `ev` and `tr_mem` are the eval and
    train phases' results (the device step alone, the in-memory Trainer)."""
    s, w, pr = dp["sizes"], dp["workers"], dp["probe"]
    print(f"data probe of the card's host: found {pr['modules_found']} (none imported); "
          f"headers {[h for h, ok in pr['headers'].items() if ok]}; libraries "
          f"{pr['ldconfig']} {pr['nvjpeg_libs']}; {pr['gxx']}; JPEG through "
          f"{pr['jpeg'] or 'nothing'}; on {smi}", flush=True)
    print(f"data: host cpu_count {dp['cpu_count']}, {w} loader workers; "
          f"{s['n_train']} train + {s['n_val']} val VisDrone-analog images at {s['img_size']} px "
          f"as {dp['format'].upper()} ({dp['file_mb']:.2f} MiB each), generated in "
          f"{dp['generate_s']:.1f} s; decode {dp['decode_ms']:.1f} ms an image on one thread "
          f"({dp['jpeg_codec']}; the same pixels as PNG {dp['png_decode_ms']:.1f} ms)",
          flush=True)
    for name, r in dp["loader"].items():
        what = (f"val: letterbox to {s['val_imgsz']}" if name == "val"
                else f"train: hyp VisDrone at {s['img_size']} (mosaic, warp, mixup 0.2, HSV, "
                     "flip)")
        print(f"data loader alone, {what}, bs{r['batch']}: {r['img_per_s_1']:.2f} img/s at 1 "
              f"worker ({r['batches_1']} batches), {r[f'img_per_s_{w}']:.2f} img/s at {w} "
              f"({r[f'batches_{w}']} batches, the fill included), "
              f"{r[f'img_per_s_{w}_after_first_round']:.2f} after the first {w}; the same "
              f"bytes at both; on {smi}", flush=True)
    print(f"data loader targets mapped back to native pixels vs the label files: max "
          f"{dp['targets_vs_labels_px']:.2e} px (tol {TARGET_TOL_PX}); COCOeval of the "
          f"labels fed back: mAP {dp['coco_known_answer']['map']}", flush=True)
    for b, r in dp["run_validation"].items():
        step = ev["backends"][b]["img_per_s"] if ev else float("nan")
        print(f"run_validation bs{s['val_batch']} {s['val_imgsz']}px bf16 NMS '{b}' on "
              f"{s['n_val']} files read {s['val_copies']}x ({r['images']} images, {w} loader "
              f"threads): {r['img_per_s']:.1f} img/s whole run, loader included "
              f"(device step alone, eval phase: {step:.1f} img/s); P {r['mp']:.4g} R "
              f"{r['mr']:.4g} mAP@.5 {r['map50']:.4g} mAP@.5:.95 {r['map']:.4g}, identical "
              f"across backends; on {smi}", flush=True)
    mem = tr_mem.get("img_per_s", float("nan"))
    mem16 = 64e3 / tr_mem["step_ms"][16] if "step_ms" in tr_mem else float("nan")
    for t in dp["train"]:
        fill, tw, pw = (t["windows"][k] for k in ("fill", "timed", "profiled"))
        (a, b), (p, q) = tw["batches"], pw["batches"]
        print(f"data Trainer {s['img_size']}px bs{s['train_batch']} accumulate "
              f"{s['train_accumulate']} Adam bf16 hyp VisDrone, device_aug "
              f"{'on' if t['device_aug'] else 'off'}: {tw['img_per_s']:.2f} img/s over batches "
              f"{a}-{b - 1} unprofiled (the loop waited {tw['loader_wait_s']:.2f} of "
              f"{tw['wall_s']:.2f} s for the loader, which made {tw['loader_img_per_s']:.2f} "
              f"img/s; batches 0-{a - 1}, the fill and the first steps, "
              f"{fill['img_per_s']:.2f} img/s); device busy {pw['device_busy_share']:.3f}"
              f" over batches {p}-{q - 1} under torch.profiler ({pw['img_per_s_under_profiler']:.2f}"
              f" img/s, waited {pw['loader_wait_s']:.2f} of {pw['wall_s']:.2f} s); in memory, "
              f"train phase: {mem:.2f} img/s at accumulate 1, {mem16:.2f} a step of accumulate "
              f"16; val at the epoch's end mAP@.5 {t['val']['map50']:.4g}; best.npz served on "
              f"'matrix' ({t['best_serve']['detections']} detections); on {smi}", flush=True)
    da = dp["device_aug"]
    print(f"device_aug on the card vs its CPU version: max abs err {da['max_abs_err']:.2e} "
          f"(tol {da['tol']})", flush=True)
    c, m = dp["clahe"], dp["mixed"]
    print(f"data train loader at 1 worker, {s['img_size']} px hyp VisDrone, "
          f"{c['batches']} batches of {c['batch']}: {c['img_per_s_plain']:.2f} img/s, with "
          f"clahe 1.0 {c['img_per_s_clahe']:.2f} img/s ({c['clahe_ms_an_image']:.1f} ms an "
          f"image more) on {smi}", flush=True)
    rv = m["run_validation"]["mixed"]
    print(f"data mixed formats ({m['files']} val files as {', '.join(m['kinds'])}; written in "
          f"{m['write_s']:.1f} s): run_validation 'matrix' mAP@.5 {rv['map50']:.4g}, the same "
          f"rows and metrics as the same arrays in PNG, K3 blocked "
          f"{rv['launches'].get('fixpoint_keep_blocked')}; cli.detect at "
          f"{s['mixed_detect_imgsz']} px {m['detect_s']:.1f} s, {m['detections']} detections "
          f"equal to serving the decoded arrays, images written as {m['detect_written']} "
          f"on {smi}", flush=True)


# ---------------------------------------------------------------------------
# the CLI core: model, train (resume, remat, autobatch), val, the .pt load
# ---------------------------------------------------------------------------

# val.sh's recipe reads the data phase's `recipe_val` unique val files; the
# --save-json and backend runs the first `n_val` of them
CLI = dict(train_imgsz=1536, train_batch=4, epochs=2, train_val=16, val_imgsz=1996,
           val_batch=8, recipe_val=32, n_val=32, backend_imgsz=1536, profile_batch=128,
           profile_iters=3, remat_imgsz=1536, remat_batch=4, model_nc=10)
CLI_DIR = DATA_DIR / "cli"
PT_ANCHOR_SCALE = 1.3  # the .pt's trained anchors: the checkpoint's, scaled
# remat's step against the plain one, both bf16 from one state: within
# twice the plain step's own spread between two runs (cuDNN's backward
# adds in a nondeterministic order), or this much (max |a - b| over 1 +
# max |b|) where the spread is smaller
REMAT_TOL = 1e-3
AUTOBATCH_FRACTION = 0.9


class BatchClock:
    """`run_validation`'s loader, clocked from the loop: `asked[i]` is when
    the loop asked for batch i (the one before it checked, its detections
    on the host), the last entry when the loop ended.  The images after the
    first batch (which carries the builds and cuDNN's autotuning) over the
    time from asking for the second batch to the end is the run's rate
    after the first batch, the loader included."""

    def __init__(self, loader):
        self.loader, self.asked, self.sizes = loader, [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            self.asked.append(time.perf_counter())
            try:
                batch = next(it)
            except StopIteration:
                return
            self.sizes.append(batch.images.shape[0])
            yield batch

    def rate_after_first(self):
        if len(self.sizes) < 2:
            return None
        return sum(self.sizes[1:]) / (self.asked[-1] - self.asked[1])


# the JAX trainer's results.csv columns, every epoch validated
# (dmayolo_tpu/train/trainer.py: epoch, the step's metrics, the metrics of
# the validation, time_s; the step's: loss and the loss items box, obj, cls)
JAX_RESULTS_COLUMNS = ["epoch", "train/loss", "train/box", "train/obj", "train/cls",
                       "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
                       "metrics/mAP_0.5:0.95", "fitness", "time_s"]
ASYNC_ORDER = (False, True, True, False)  # epoch windows: sync, async, async, sync


def async_save_cost(tr, device, imgsz, batch, nc, epoch_steps):
    """What `--ckpt-async` gains end to end, on a trained recipe Trainer:
    one epoch's wall time as the training thread sees it, a checkpoint
    save and then the epoch's `epoch_steps` train steps (accumulate 1, one
    batch of rectangles), in windows synchronous, async, async,
    synchronous.  An async window ends when its write is on disk (the
    next save would wait for it).  Each window keeps the time `_save`
    holds the thread (the pull of the state, plus the f16 conversion and
    the write when synchronous), its steps' ms and that wait."""
    import torch

    from dmayolo_tpu_torch.train.trainer import Trainer

    step = Trainer.get_step(tr, 1)
    images, targets = tr.to_device(train_batches(1, batch, imgsz, nc, 128, seed=31))
    gen = torch.Generator(device=device).manual_seed(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run_step():
        sync()
        t0 = time.perf_counter()
        step(tr.state, images, targets, gen)
        sync()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):  # built and tuned
        run_step()
    windows = []
    for mode in ASYNC_ORDER:
        tr.ckpt_async, tr._pulled = mode, None
        sync()
        t0 = time.perf_counter()
        tr._save("save_probe", 0)
        save_s = time.perf_counter() - t0
        steps_ms = [run_step() for _ in range(epoch_steps)]
        t1 = time.perf_counter()
        if mode:
            tr._async_ckptr.wait()
        windows.append({"async": mode, "s": time.perf_counter() - t0, "save_s": save_s,
                        "steps_ms": steps_ms, "wait_s": time.perf_counter() - t1})
    (tr.out / "save_probe.npz").unlink()
    out = {"epoch_steps": epoch_steps, "windows": windows}
    for mode, name in ((False, "sync"), (True, "async")):
        ws = [w for w in windows if w["async"] == mode]
        out[f"epoch_s_{name}"] = sum(w["s"] for w in ws) / len(ws)
        out[f"save_s_{name}"] = sum(w["save_s"] for w in ws) / len(ws)
        out[f"steps_s_{name}"] = sum(sum(w["steps_ms"]) for w in ws) / len(ws) / 1e3
    out["async_gain_s"] = out["epoch_s_sync"] - out["epoch_s_async"]
    return out


class Interrupted(Exception):
    """Stops the first CLI training run after its first epoch, as a kill
    between epochs would: last.npz keeps the optimizer state."""


def reference_pt(model, path, anchor_scale=PT_ANCHOR_SCALE):
    """`model`'s weights written as the reference's own training
    checkpoint: {'epoch', 'model', 'ema'} of modules whose classes cannot
    be imported when the file is read (a module made for the write and
    removed after it), f16, with the yaml, BN `num_batches_tracked`, and
    the Detect layer's `anchors` (stride units, x `anchor_scale`) and
    `anchor_grid` buffers.  'model' holds the weights halved, so a reader
    that takes it over the EMA serves other detections."""
    import types

    import numpy as np
    import torch
    import torch.nn as nn

    mod = types.ModuleType("reference_models_stub")
    exec("import torch.nn as nn\nclass Model(nn.Module):\n    pass\n"
         "class Layer(nn.Module):\n    pass\n", mod.__dict__)
    sys.modules[mod.__name__] = mod
    try:
        buffers = {k for k, _ in model.named_buffers()}

        def tree(scale):
            root = mod.Model()
            for key, v in model.state_dict().items():
                *parents, leaf = key.split(".")
                m = root
                for part in parents:
                    if not hasattr(m, part):
                        m.add_module(part, mod.Layer())
                    m = getattr(m, part)
                v = v.detach().cpu()
                if key in buffers:
                    m.register_buffer(leaf, v.clone())
                    if leaf == "running_var":
                        m.register_buffer("num_batches_tracked", torch.tensor(100))
                else:
                    m.register_parameter(leaf, nn.Parameter(v * scale))
            head = root.model.get_submodule(str(len(model.model) - 1))
            head.register_buffer("anchors", torch.from_numpy(
                np.asarray(model.head.anchors, np.float32) * anchor_scale))
            head.register_buffer("anchor_grid", torch.zeros(1))
            root.yaml = dict(model.yaml)
            return root.half()

        torch.save({"epoch": 1, "model": tree(0.5), "ema": tree(1.0)}, path)
    finally:
        del sys.modules[mod.__name__]


def remat_step(device, cfg, nc, sd, batch, remat, dtype, timed_steps):
    """One step of the recipe's program (Adam, hyp VisDrone, device_aug)
    from the weights `sd` on `batch`, with or without remat: grads and BN
    running statistics on the host, the step's peak GiB above what the
    process held before the step's model was built (so with the model,
    EMA and Adam state), then ms a step over `timed_steps` more."""
    import gc

    import torch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.train.loss import Targets
    from dmayolo_tpu_torch.train.optim import Schedule, param_groups
    from dmayolo_tpu_torch.train.step import init_train_state, make_train_step
    from dmayolo_tpu_torch.train.trainer import load_hyp, scale_hyp

    on_card = device.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
    model = DetectionModel(cfg, nc=nc, device=device)
    model.load_state_dict(sd)
    model.remat = remat
    imgsz = batch.images.shape[1]
    h = scale_hyp(load_hyp("visdrone"), model.head.nl, nc, imgsz)
    state = init_train_state(model, param_groups(model), h["weight_decay"], adam=True,
                             momentum=h["momentum"])
    aug = {"hgain": h["hsv_h"], "sgain": h["hsv_s"], "vgain": h["hsv_v"], "fliplr": h["fliplr"]}
    step = make_train_step(make_loss(model, h, nc, "anchor"),
                           Schedule(h, epochs=1, steps_per_epoch=1, adam=True,
                                    batch_size=imgsz), dtype=dtype, device_aug=aug)
    imgs = torch.from_numpy(batch.images).to(device)
    tg = Targets(*(torch.from_numpy(t).to(device) for t in batch.targets))
    grads = {}

    def pre_step(*_):
        grads.update({k: p.grad.float().cpu() for k, p in model.named_parameters()
                      if p.grad is not None})

    hook = state.optimizer.register_step_pre_hook(pre_step)
    gen = torch.Generator(device=device).manual_seed(3)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step(state, imgs, tg, gen)
    hook.remove()
    out = {"grads": grads, "stats": {k: v.float().cpu() for k, v in model.named_buffers()
                                     if "running_" in k}}
    if on_card:
        torch.cuda.synchronize()
        out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        out["ms"] = cuda_ms(lambda: step(state, imgs, tg, gen), timed_steps, warmup=1)
    del state, model, step, imgs, tg
    if on_card:
        torch.cuda.empty_cache()
    return out


def remat_check(device, cfg, nc, imgsz, batch, timed_steps=3):
    """The recipe's step at `imgsz`, batch `batch`, with and without
    remat from one state: grads and BN statistics within REMAT_TOL (or
    twice the plain step's spread), peak memory not larger with remat."""
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel

    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    model = DetectionModel(cfg, nc=nc, device="cpu").init_with_priors(
        torch.Generator().manual_seed(4))
    sd = model.state_dict()
    b = train_batches(1, batch, imgsz, nc, 128, seed=21)[0]
    runs = {name: remat_step(device, cfg, nc, sd, b, remat, dtype, timed_steps)
            for name, remat in (("plain", False), ("plain_again", False), ("remat", True))}
    p, q, r = runs["plain"], runs["plain_again"], runs["remat"]
    out = {"imgsz": imgsz, "batch": batch, "dtype": str(dtype),
           "grads_spread": scaled_err(q["grads"], p["grads"]),
           "grads_err": scaled_err(r["grads"], p["grads"]),
           "stats_spread": scaled_err(q["stats"], p["stats"]),
           "stats_err": scaled_err(r["stats"], p["stats"])}
    for kind in ("grads", "stats"):
        tol = max(2 * out[f"{kind}_spread"], REMAT_TOL)
        out[f"{kind}_tol"] = tol
        check(out[f"{kind}_err"] <= tol,
              f"remat's {kind} off the plain step's: {out[f'{kind}_err']} > {tol}")
    if on_card:
        out.update(peak_gib=p["peak_gib"], remat_peak_gib=r["peak_gib"], ms=p["ms"],
                   remat_ms=r["ms"])
        check(r["peak_gib"] <= p["peak_gib"], f"remat's peak is larger: {out}")
    return out


def cli_phase(device, counters, smi, data_dir=DATA_DIR, cfg=None, sizes=CLI, nc=10,
              workers=None):
    """The CLIs driven in process through their `main(argv)` on the data
    phase's set (its files, labels and `start.npz`), as a user runs them:
    `cli.model` (the layer table, parameters, GFLOPs, the bs128 bf16 fused
    profile); `cli.train` at the flagship's recipe with `--remat`, stopped
    after its first epoch and resumed for the second; remat's step against
    the plain one; `--batch-size -1`; `cli.val` at the author's eval
    recipe (1996 px, TTA) from the trained best.npz, with `--save-json`,
    and on "pallas" and "matrix" at `backend_imgsz` (counted; the three
    backends' detections identical); and the same weights as a
    reference-layout `.pt` loaded and served against the `.npz` path."""
    import os
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.cli import common as cli_common
    from dmayolo_tpu_torch.cli import model as cli_model
    from dmayolo_tpu_torch.cli import train as cli_train
    from dmayolo_tpu_torch.cli import val as cli_val
    from dmayolo_tpu_torch.data.datasets import DetectionDataset
    from dmayolo_tpu_torch.data.loader import DataLoader
    from dmayolo_tpu_torch.eval import validator as validator_mod
    from dmayolo_tpu_torch.train import autobatch as autobatch_mod
    from dmayolo_tpu_torch.train import trainer as trainer_mod
    from dmayolo_tpu_torch.utils import model_info
    from dmayolo_tpu_torch.utils.checkpoint import load_checkpoint

    on_card = device.type == "cuda"
    workers = workers or min(8, os.cpu_count() or 1)
    dev = [] if on_card else ["--device", "cpu"]
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    if cfg is None:
        cfg_arg = f"{FLAGSHIP}.yaml"  # resolved by name, as the recipe does
    else:
        cfg_arg = str(CLI_DIR / "model.yaml")
        Path(cfg_arg).write_text(json.dumps(cfg))  # JSON is YAML
    cfg_path = cli_common.resolve_config(cfg_arg, "models")
    val_files = sorted((data_dir / "images" / "val").iterdir())
    train_val = CLI_DIR / "train_val.txt"
    train_val.write_text("".join(f"{f}\n" for f in val_files[:sizes["train_val"]]))
    check(len(val_files) >= sizes["recipe_val"] >= sizes["n_val"],
          f"{len(val_files)} val files for the CLI's val runs")
    cli_val_list = CLI_DIR / "val.txt"
    cli_val_list.write_text("".join(f"{f}\n" for f in val_files[:sizes["n_val"]]))
    recipe_val_list = CLI_DIR / "val_recipe.txt"
    recipe_val_list.write_text("".join(f"{f}\n" for f in val_files[:sizes["recipe_val"]]))
    data_yaml = CLI_DIR / "data.yaml"
    data_yaml.write_text(f"path: {data_dir}\ntrain: images/train\nval: {train_val}\n"
                         f"nc: {nc}\n")
    val_yaml = CLI_DIR / "val.yaml"
    val_yaml.write_text(f"path: {data_dir}\nval: {cli_val_list}\nnc: {nc}\n")
    recipe_yaml = CLI_DIR / "val_recipe.yaml"
    recipe_yaml.write_text(f"path: {data_dir}\nval: {recipe_val_list}\nnc: {nc}\n")
    out, t_phase = {}, time.perf_counter()

    # ---- 1. cli.model: the table, parameters, GFLOPs; the layer profile
    printed = []
    real_info, real_profile = model_info.model_info, model_info.profile_layers
    try:
        model_info.model_info = lambda *a, **k: printed.append(real_info(*a, **k)) or printed[-1]
        t0 = time.perf_counter()
        m = cli_model.main(["--cfg", cfg_arg, "--nc", str(sizes["model_nc"]), "--verbose",
                            *dev])
        out["model"] = {"s": time.perf_counter() - t0, "info": printed[-1],
                        "params": sum(p.numel() for p in m.parameters())}
        del m
        profiles = []
        model_info.profile_layers = lambda *a, **k: profiles.append(
            real_profile(*a, **{**k, "iters": sizes["profile_iters"]})) or profiles[-1]
        t0 = time.perf_counter()
        cli_model.main(["--cfg", cfg_arg, "--nc", str(sizes["model_nc"]), "--profile",
                        "--batch", str(sizes["profile_batch"]), "--bf16", "--fused", *dev])
        rows = profiles[-1]
        out["model"].update(profile_s=time.perf_counter() - t0, profile_batch=sizes[
            "profile_batch"], profile_total_ms=rows[-1][3],
            slowest=[{"i": i, "name": n, "ms": d} for i, n, d, _ in
                     sorted(rows, key=lambda r: -r[2])[:5]])
    finally:
        model_info.model_info, model_info.profile_layers = real_info, real_profile
    if on_card:
        torch.cuda.empty_cache()
    print("cli model: " + json.dumps(out["model"]), flush=True)

    # ---- 2. cli.train: the recipe, stopped after epoch 0, then --resume
    trainers, vals, steps = [], [], []
    real_make, real_val = cli_train._make_trainer, trainer_mod.run_validation

    def make(opt, hyp, out_dir, *mesh):
        tr = real_make(opt, hyp, out_dir, *mesh)
        trainers.append(tr)
        get_step = tr.get_step

        def timed(acc):  # each optimizer step's end, on the host clock after a sync
            s = get_step(acc)

            def run(*a, **k):
                r = s(*a, **k)
                if on_card:
                    torch.cuda.synchronize()
                steps.append((len(trainers), time.perf_counter(), a[1].shape[0]))
                return r
            return run

        tr.get_step = timed
        if len(trainers) == 1:  # the first run ends after its first epoch
            log = tr._log_csv

            def log_then_stop(row):
                epoch = row["epoch"]  # the logger takes it out of the row
                log(row)
                raise Interrupted(f"stopped after epoch {epoch}")

            tr._log_csv = log_then_stop
        return tr

    def labelled(model, data_path, **k):
        # the known answer: the EMA's own detections as the labels (the
        # start weights score under the conf gate on the generated ones)
        own_labels(model, data_path, k["img_size"], k["batch_size"], k["dtype"], workers)
        vals.append(real_val(model, data_path, **k))
        return vals[-1]

    def recipe(batch):  # train.sh:5-9, the epochs, data and names aside
        return ["--imgsz", str(sizes["train_imgsz"]), "--adam", "--batch-size", str(batch),
                "--hyp", "visdrone", "--fastload", "--device-aug", "--remat"]

    run_dir = CLI_DIR / "runs" / "flagship"
    # --ckpt-async: the stopped run writes its checkpoints on a background
    # thread, and the resumed one does too (the run's opt.yaml keeps it)
    argv = ["--cfg", cfg_arg, "--data", str(data_yaml), "--epochs", str(sizes["epochs"]),
            *recipe(sizes["train_batch"]), "--weights", str(data_dir / "start.npz"), "--project",
            str(CLI_DIR / "runs"), "--name", "flagship", "--workers", str(workers),
            "--ckpt-async", *dev]
    cli_train._make_trainer, trainer_mod.run_validation = make, labelled
    try:
        t0 = time.perf_counter()
        try:
            cli_train.main(argv)
            check(False, "the first training run was not stopped after its first epoch")
        except Interrupted:
            pass
        first_s = time.perf_counter() - t0
        trees, meta0 = load_checkpoint(run_dir / "last.npz")
        check("opt_mom" in trees and meta0["epoch"] == 0,
              f"the stopped run's last.npz is not resumable: epoch {meta0.get('epoch')}")
        t0 = time.perf_counter()
        best = cli_train.main(["--resume", str(run_dir / "last.npz"), *dev])
        resume_s = time.perf_counter() - t0
    finally:
        cli_train._make_trainer, trainer_mod.run_validation = real_make, real_val
    first, second = trainers
    _, best_meta = load_checkpoint(run_dir / "best.npz")
    n_train = len(first.train_ds)
    out["train"] = {
        "first_s": first_s, "resume_s": resume_s, "images_an_epoch": n_train,
        "steps_first": meta0["step"], "resumed_at_epoch": second.start_epoch,
        "steps_after_resume": second.state.step, "returned_fitness": best,
        "best_meta": {k: best_meta.get(k) for k in ("epoch", "best_fitness")},
        "val": [{k: getattr(v, k) for k in ("mp", "mr", "map50", "map")} for v in vals],
        "remat": bool(first.model.remat and second.model.remat),
        "accumulate": first.accumulate}
    for run in (1, 2):
        t = [(ts, n) for r, ts, n in steps if r == run]
        if len(t) > 2:  # after the first step (builds, cuDNN's autotuning)
            out["train"][f"img_per_s_run{run}"] = sum(n for _, n in t[1:]) / (t[-1][0] - t[0][0])
    check(second.start_epoch == 1 and second.state.step > meta0["step"] > 0,
          f"the resumed run does not continue the first: {out['train']}")
    check(best == best_meta["best_fitness"] and best > 0,
          f"main's return is not best.npz's fitness: {best} vs {best_meta}")
    check(out["train"]["remat"], "--remat did not reach the Trainer's model")
    header = (run_dir / "results.csv").read_text().splitlines()
    out["train"]["results_csv"] = {"header": header[0].split(","), "rows": len(header) - 1}
    check(header[0].split(",") == JAX_RESULTS_COLUMNS and len(header) == 3,
          f"results.csv is not the JAX trainer's: {out['train']['results_csv']}")
    check(first.ckpt_async and second.ckpt_async, "--ckpt-async did not reach both Trainers")
    # half an epoch's steps a window (the time limit's share)
    out["train"]["ckpt_async"] = async_save_cost(second, device, sizes["train_imgsz"],
                                                 sizes["train_batch"], nc,
                                                 n_train // sizes["train_batch"] // 2)
    print("cli train: " + json.dumps(out["train"]), flush=True)
    del first, second, trainers
    if on_card:
        torch.cuda.empty_cache()

    # ---- 3. remat against the plain step, one state
    t0 = time.perf_counter()
    out["remat"] = remat_check(device, cfg or cli_common.resolve_config(cfg_arg, "models"), nc,
                               sizes["remat_imgsz"], sizes["remat_batch"])
    out["remat"]["s"] = time.perf_counter() - t0
    print("cli remat: " + json.dumps(out["remat"]), flush=True)

    # ---- 4. --batch-size -1 at the recipe (--epochs 0: the search and the
    # Trainer's build, no training)
    real_find, found = autobatch_mod.find_train_batch_size, {}

    def logged(model, *a, **k):
        found["budget"] = autobatch_mod.device_memory_budget(next(model.parameters()).device)
        found["ladder"] = []
        found["batch"] = real_find(model, *a, **{**k, "log": found["ladder"]})
        return found["batch"]

    autobatch_mod.find_train_batch_size = logged
    try:
        t0 = time.perf_counter()
        # probed at accumulate 1: a step's peak is its microbatch's (the
        # gradients accumulate in place), at a sixth of the recipe's images
        cli_train.main(["--cfg", cfg_arg, "--data", str(data_yaml), "--epochs", "0",
                        *recipe(-1), "--accumulate", "1",
                        "--project", str(CLI_DIR / "runs"), "--name", "autobatch",
                        "--workers", str(workers), *dev])
        ab = {"s": time.perf_counter() - t0, "batch": found.get("batch")}
    finally:
        autobatch_mod.find_train_batch_size = real_find
    if on_card:
        bs = found["batch"]
        ab.update(budget_gib=found["budget"] / 2 ** 30,
                  ladder=[{"bs": b, "status": s, "gib": None if m is None else m / 2 ** 30}
                          for b, s, m in found["ladder"]])
        # one real step at the chosen batch, at the deployed accumulate
        acc = max(round(64 / bs), 1)
        peak = autobatch_step(device, cfg_path, nc, sizes["train_imgsz"], bs, acc)
        ab.update(step_accumulate=acc, step_peak_gib=peak,
                  limit_gib=AUTOBATCH_FRACTION * found["budget"] / 2 ** 30)
        check(peak < AUTOBATCH_FRACTION * found["budget"] / 2 ** 30,
              f"autobatch's batch {bs} peaks over {AUTOBATCH_FRACTION} of the budget: {ab}")
    else:
        check(found.get("batch") == 16, f"--batch-size -1 off the card is not 16: {found}")
    out["autobatch"] = ab
    print("cli autobatch: " + json.dumps(ab), flush=True)

    # ---- 5. cli.val: the author's eval recipe, --save-json, the kernels
    best_npz = str(run_dir / "best.npz")
    vals_out = {}

    clocks, real_loader = [], validator_mod.DataLoader

    def clocked(*a, **k):
        clocks.append(BatchClock(real_loader(*a, **k)))
        return clocks[-1]

    def val(name, yaml_file, n, *flags):
        for c in counters:
            c.launches = 0
        validator_mod.DataLoader = clocked
        try:
            t0 = time.perf_counter()
            res = cli_val.main(["--weights", best_npz, "--data", str(yaml_file), "--project",
                                str(CLI_DIR / "val"), "--name", name, "--exist-ok", *flags,
                                *dev])
            wall = time.perf_counter() - t0
        finally:
            validator_mod.DataLoader = real_loader
        check(sum(clocks[-1].sizes) == n, f"val '{name}' read {clocks[-1].sizes}, not {n} images")
        r = {"images": n, "s": wall, "img_per_s": n / wall,
             "img_per_s_after_first_batch": clocks[-1].rate_after_first(),
             "speed_ms": res.speed_ms, "launches": {c.__name__: c.launches for c in counters},
             **{k: getattr(res, k) for k in ("mp", "mr", "map50", "map", "nt")}}
        check(all(np.isfinite(r[k]) for k in ("mp", "mr", "map50", "map")) and r["nt"] > 0,
              f"bad val result '{name}': {r}")
        vals_out[name] = r
        return res

    val("recipe", recipe_yaml, sizes["recipe_val"], "--imgsz", str(sizes["val_imgsz"]),
        "--augment", "--save-txt", "--save-conf", "--task", "val", "--batch-size",
        str(sizes["val_batch"]), "--verbose")
    at = ("--imgsz", str(sizes["backend_imgsz"]), "--batch-size", str(sizes["val_batch"]),
          "--save-txt", "--save-conf")
    res = val("json", val_yaml, sizes["n_val"], *at, "--save-json")
    check(res.used_image_ids is not None and len(res.used_image_ids) == sizes["n_val"]
          and (CLI_DIR / "val" / "json" / "coco_gt.json").exists(),
          "--save-json wrote no COCO ground truth or scoped no images")
    for backend in ("pallas", "matrix"):
        val(backend, val_yaml, sizes["n_val"], *at, "--nms-backend", backend)
    txt = {name: {p.name: p.read_text() for p in (CLI_DIR / "val" / name / "labels").iterdir()}
           for name in ("json", "pallas", "matrix")}
    check(txt["json"] == txt["pallas"] == txt["matrix"] and txt["json"],
          "the val CLI's detections differ between 'scan', 'pallas' and 'matrix'")
    n_batches = -(-sizes["n_val"] // sizes["val_batch"])
    if on_card:
        lp, lm = vals_out["pallas"]["launches"], vals_out["matrix"]["launches"]
        check(lp["nms_greedy_stream_cluster"] == n_batches,
              f"val on 'pallas': K2's cluster kernel once a batch? {lp}")
        check(lm["fixpoint_keep_blocked"] == n_batches,
              f"val on 'matrix': K3's blocked entry once a batch? {lm}")
    out["val"] = vals_out
    print("cli val: " + json.dumps(vals_out), flush=True)

    # ---- 6. the same weights as the reference's .pt, through the loader
    t0 = time.perf_counter()
    npz_model = cli_common.load_model_from_checkpoint(best_npz, device=device)
    pt = CLI_DIR / "best.pt"
    reference_pt(npz_model, pt)
    pt_model = cli_common.load_model_from_checkpoint(str(pt), device=device)
    want_anchors = (np.asarray(npz_model.head.anchors, np.float32)
                    * PT_ANCHOR_SCALE).astype(np.float16).astype(np.float32)
    check(np.array_equal(pt_model.head.anchors, want_anchors),
          "the .pt's trained anchors did not reach the head")
    npz_model.head.anchors = pt_model.head.anchors.copy()
    dtype = torch.bfloat16 if on_card else torch.float32
    b = next(iter(DataLoader(
        DetectionDataset(str(cli_val_list), img_size=sizes["backend_imgsz"],
                         stride=int(npz_model.stride.max()), nc=nc),
        sizes["val_batch"], shuffle=False, workers=workers)))
    x = torch.from_numpy(b.images).to(device).to(dtype) / 255.0
    served = {}
    with torch.inference_mode():
        for name, m in (("npz", npz_model), ("pt", pt_model)):
            m.fuse()
            raw = m.apply(x, dtype=dtype, fused=True)
            conf = min(0.25, 0.5 * float(m.decode_parts(raw)[1].amax(1).min()))
            for c in counters:
                c.launches = 0
            dets, valid = m.serve_detections(raw, conf_thres=conf, backend="matrix")
            served[name] = (dets[valid].float().cpu(), int(valid.sum()),
                            {c.__name__: c.launches for c in counters}, conf)
    out["pt"] = {"s": time.perf_counter() - t0, "detections": served["pt"][1],
                 "conf_thres": served["pt"][3], "launches": served["pt"][2],
                 "file_mb": pt.stat().st_size / 2 ** 20}
    check(served["pt"][1] > 0 and served["pt"][1] == served["npz"][1]
          and torch.equal(served["pt"][0], served["npz"][0]),
          f"the .pt and the .npz serve other detections: {out['pt']}")
    if on_card:
        check(served["pt"][2]["fixpoint_keep"] > 0, "K3 did not launch serving the .pt")
    print("cli pt: " + json.dumps(out["pt"]), flush=True)
    out["s"] = time.perf_counter() - t_phase
    return out


def autobatch_step(device, cfg_path, nc, imgsz, bs, acc):
    """Peak GiB of one step of the recipe's program at batch `bs` and
    accumulate `acc`, from a fresh state (the model, EMA and Adam state
    included)."""
    import gc

    import torch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.train.autobatch import probe_targets
    from dmayolo_tpu_torch.train.optim import Schedule, param_groups
    from dmayolo_tpu_torch.train.step import init_train_state, make_train_step
    from dmayolo_tpu_torch.train.trainer import load_hyp, scale_hyp

    gc.collect()
    torch.cuda.empty_cache()
    model = DetectionModel(cfg_path, nc=nc, device=device).init_with_priors(
        torch.Generator().manual_seed(0))
    model.remat = True
    h = scale_hyp(load_hyp("visdrone"), model.head.nl, nc, imgsz)
    state = init_train_state(model, param_groups(model), h["weight_decay"], adam=True,
                             momentum=h["momentum"])
    aug = {"hgain": h["hsv_h"], "sgain": h["hsv_s"], "vgain": h["hsv_v"], "fliplr": h["fliplr"]}
    step = make_train_step(make_loss(model, h, nc, "anchor"),
                           Schedule(h, epochs=1, steps_per_epoch=1, adam=True, batch_size=bs,
                                    step_scale=acc),
                           dtype=torch.bfloat16, accumulate=acc, device_aug=aug)
    gen = torch.Generator(device=device).manual_seed(0)
    n = acc * bs
    imgs = torch.randint(0, 256, (n, imgsz, imgsz, 3), dtype=torch.uint8, device=device,
                         generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, imgs, probe_targets(n, 128, device), gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, model, step, imgs
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def print_cli(cp, smi):
    """The CLI phase's summary lines."""
    md, tr, ab, vl = cp["model"], cp["train"], cp["autobatch"], cp["val"]
    print(f"cli model: {md['info'].splitlines()[-1]}; profile bs{md['profile_batch']} 640px "
          f"bf16 fused, whole graph {md['profile_total_ms']:.2f} ms; slowest layers: "
          + ", ".join(f"{r['i']} {r['name']} {r['ms']:.2f} ms" for r in md["slowest"])
          + f" (cli.model {md['s']:.1f} s, profile {md['profile_s']:.1f} s); on {smi}")
    print(f"cli train (recipe, --remat, {tr['images_an_epoch']} images an epoch, accumulate "
          f"{tr['accumulate']}): epoch 0 {tr['first_s']:.1f} s at "
          f"{tr.get('img_per_s_run1', float('nan')):.2f} img/s, resumed epoch 1 "
          f"{tr['resume_s']:.1f} s at {tr.get('img_per_s_run2', float('nan')):.2f} img/s; "
          f"steps {tr['steps_first']} -> {tr['steps_after_resume']}; returned fitness "
          f"{tr['returned_fitness']:.5f} = best.npz's; on {smi}")
    ca = tr["ckpt_async"]
    waits = ", ".join(f"{w['wait_s']:.2f}" for w in ca["windows"] if w["async"])
    print(f"cli train --ckpt-async, one epoch ({ca['epoch_steps']} steps) after a save, windows "
          f"sync/async/async/sync: {ca['epoch_s_sync']:.2f} s synchronous, "
          f"{ca['epoch_s_async']:.2f} s async (gain {ca['async_gain_s']:.2f} s); _save holds "
          f"the thread {ca['save_s_sync']:.2f} s / {ca['save_s_async']:.2f} s; the steps "
          f"{ca['steps_s_sync']:.2f} s / {ca['steps_s_async']:.2f} s; the write's wait after "
          f"them {waits} s; "
          f"results.csv header = the JAX trainer's, {tr['results_csv']['rows']} rows; on {smi}")
    rm = cp["remat"]
    print(f"cli remat {rm['imgsz']}px bs{rm['batch']} {rm['dtype']}: peak "
          f"{rm.get('peak_gib', float('nan')):.2f} GiB plain, "
          f"{rm.get('remat_peak_gib', float('nan')):.2f} GiB remat; "
          f"{rm.get('ms', float('nan')):.1f} / {rm.get('remat_ms', float('nan')):.1f} ms a step; "
          f"grads {rm['grads_err']:.2e} (plain's spread {rm['grads_spread']:.2e}, tol "
          f"{rm['grads_tol']:.1e}), BN stats {rm['stats_err']:.2e} (spread "
          f"{rm['stats_spread']:.2e}); on {smi}")
    if "ladder" in ab:
        print(f"cli --batch-size -1: budget {ab['budget_gib']:.2f} GiB, ladder "
              + ", ".join(f"bs{r['bs']} {r['status']}"
                          + ("" if r["gib"] is None else f" {r['gib']:.2f} GiB")
                          for r in ab["ladder"])
              + f"; chose {ab['batch']}; one step at it (accumulate {ab['step_accumulate']}) "
              f"peaks {ab['step_peak_gib']:.2f} GiB < {ab['limit_gib']:.2f}; {ab['s']:.1f} s; "
              f"on {smi}")
    for name, r in vl.items():
        print(f"cli val '{name}': {r['images']} images, {r['img_per_s']:.2f} img/s "
              f"({r['s']:.1f} s), {r['img_per_s_after_first_batch'] or float('nan'):.2f} img/s "
              f"after the first batch, mAP@.5 {r['map50']:.4f}, speed {r['speed_ms']}; on {smi}")


# ---------------------------------------------------------------------------
# JPEG on the card: nvJPEG against libjpeg's pixels
# ---------------------------------------------------------------------------
JPEG_FIXTURES = ROOT / "tests" / "torch_data" / "jpeg"
FORMAT_FIXTURES = ROOT / "tests" / "torch_data" / "formats"
JPEG_FRAME = "visdrone_1536x864"
# nvJPEG's pixels against libjpeg's, bounds set from the first run on an
# H100.  Against libjpeg's default decode (pixels.npz; 4:2:0 chroma
# upsampled by its "fancy" triangle filter): up to 3 levels, a mean of
# 0.52 and 0.03% over 2 levels where no chroma is upsampled; 82 levels, a
# mean of 7.5 and 56% over 2 levels at the colour edges of the small 4:2:0
# fixtures; 36, 0.043 and 0.2% on the VisDrone-analog frame.  Against
# libjpeg with chroma replicated (pixels_box.npz, the small fixtures),
# nvJPEG's upsampling: 3 levels, a mean of 0.52, 0.16% over 2 levels, on
# every fixture (the IDCTs' rounding).
JPEG_BOUNDS = {"full chroma": dict(max_abs=4, mean_abs=1.0, share_over_2=0.002),
               "4:2:0": dict(max_abs=96, mean_abs=8.0, share_over_2=0.6),
               "frame": dict(max_abs=48, mean_abs=0.1, share_over_2=0.005),
               "box upsampled": dict(max_abs=4, mean_abs=1.0, share_over_2=0.005)}
JPEG_PSNR_MIN = 40.0  # dB, nvJPEG's q95 encode decoded again


def jpeg_kind(name):
    if name == JPEG_FRAME:
        return "frame"
    return "full chroma" if name in ("gray", "baseline_444") else "4:2:0"


def jpeg_phase():
    """Every JPEG fixture decoded by this machine's route (`jpeg_codec()`:
    nvJPEG on the card) against libjpeg's pixels, within `JPEG_BOUNDS`;
    the BMP, TIFF, PNG, EXIF and MPO fixtures against cv2's (exact but
    the JPEG-coded ones, within the 4:2:0 bounds at the rotated shape);
    the 1536 px frame's decode time beside PNG's of the same pixels; the
    encoder's q95 round trip.  Returns (results, the frame's libjpeg
    pixels)."""
    import numpy as np

    from dmayolo_tpu_torch.data import imageio

    out = {"codec": imageio.jpeg_codec(), "fixtures": {}}
    t0 = time.perf_counter()
    if out["codec"] == "nvjpeg":
        imageio.nvlib()  # build and handle
    out["codec_load_s"] = time.perf_counter() - t0
    with np.load(JPEG_FIXTURES / "pixels.npz") as d:
        want = {k: d[k] for k in d.files}
    with np.load(JPEG_FIXTURES / "pixels_box.npz") as d:
        box = {k: d[k] for k in d.files}

    def held(name, got, ref, kind):
        check(got.shape == ref.shape, f"JPEG fixture {name}: shape {got.shape} != {ref.shape}")
        diff = np.abs(got.astype(np.int16) - ref)
        r = {"kind": kind, "max_abs": int(diff.max()), "mean_abs": float(diff.mean()),
             "share_over_2": float((diff > 2).mean())}
        for k, lim in JPEG_BOUNDS[kind].items():
            check(r[k] <= lim, f"JPEG fixture {name}: {k} {r[k]} above {lim} ({out['codec']} "
                               f"against libjpeg, {kind})")
        return r

    for name, ref in want.items():
        got = imageio.imread(JPEG_FIXTURES / f"{name}.jpg")
        out["fixtures"][name] = held(name, got, ref, jpeg_kind(name))
        if out["codec"] == "libjpeg":  # the route pixels.npz was made by
            check(np.array_equal(got, ref), f"JPEG fixture {name}: libjpeg's pixels moved")
        elif name in box:  # nvJPEG against libjpeg with its chroma upsampling
            out["fixtures"][name]["box_upsampled"] = held(name, got, box[name], "box upsampled")
    # BMP, TIFF, PNG with eXIf, EXIF-rotated JPEG and MPO: cv2's pixels,
    # exact where no JPEG is decoded; the JPEG ones by this route within
    # the 4:2:0 bounds, at the rotated shape
    with np.load(FORMAT_FIXTURES / "pixels.npz") as d:
        fmt_want = {k: d[k] for k in d.files}
    fmt = out["formats"] = {"exact": 0, "jpeg": {}}
    for name, ref in fmt_want.items():
        (path,) = [p for p in FORMAT_FIXTURES.iterdir() if p.stem == name]
        got = imageio.imread(path)
        check(imageio.image_shape(path) == ref.shape[:2],
              f"format fixture {name}: image_shape {imageio.image_shape(path)} != {ref.shape[:2]}")
        if path.suffix in (".jpg", ".mpo"):
            fmt["jpeg"][name] = held(name, got, ref, "4:2:0")
        else:
            check(np.array_equal(got, ref), f"format fixture {name}: not cv2's pixels")
            fmt["exact"] += 1
    buf = (JPEG_FIXTURES / f"{JPEG_FRAME}.jpg").read_bytes()
    tmp = ROOT / "build" / "jpeg_phase"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        imageio.imwrite(tmp / "frame.png", want[JPEG_FRAME])
        png = (tmp / "frame.png").read_bytes()
        for key, data in (("decode_ms", buf), ("png_decode_ms", png)):
            for _ in range(3):
                imageio.imdecode(data)
            t0 = time.perf_counter()
            for _ in range(20):
                imageio.imdecode(data)
            out[key] = (time.perf_counter() - t0) / 20 * 1e3
        t0 = time.perf_counter()
        imageio.imwrite(tmp / "q95.jpg", want[JPEG_FRAME], quality=95)
        out["encode_ms"] = (time.perf_counter() - t0) * 1e3
        back = imageio.imread(tmp / "q95.jpg")
        mse = float(((back.astype(np.float64) - want[JPEG_FRAME]) ** 2).mean())
        out["q95_bytes"] = (tmp / "q95.jpg").stat().st_size
        out["q95_psnr_db"] = 10 * np.log10(255 ** 2 / max(mse, 1e-12))
        check(out["q95_psnr_db"] >= JPEG_PSNR_MIN,
              f"JPEG q95 round trip at {out['q95_psnr_db']:.1f} dB, under {JPEG_PSNR_MIN}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    out["frame_shape"] = list(want[JPEG_FRAME].shape)
    return out, want[JPEG_FRAME]


# ---------------------------------------------------------------------------
# The inference tools: detect, export, hub, REST, Grad-CAM, WBF
# ---------------------------------------------------------------------------
TOOLS = dict(imgsz=1536, batch=16, detect_files=32, live=4000, crop_files=2, augment_files=2,
             export_batch=2, pt2_files=2, video_frames=12, video_size=(1920, 1080),
             stream_sources=3, stream_steps=8, hub_files=2, rest_imgsz=640, rest_batch=16,
             rest_requests=16, rest_single=2, gradcam_files=1,
             gradcam_imgsz=640, gradcam_max_dets=4, gradcam_layer="model_17_cv3_act",
             frame_top=100, wbf_imgsz=1280, wbf_files=2)
TOOLS_DIR = DATA_DIR / "tools"
VIDEO_FPS = 30
# the streams' paced reads: a reader at most STREAM_AHEAD frames ahead of
# the steps served; a read held past the timeout fails the check
STREAM_AHEAD, STREAM_PACE_TIMEOUT = 1, 120.0
# the CAM on the card (f32, TF32 off) against the host CPU's of the same
# weights, image and detection: the normalised map's max |difference|
CAM_TOL = {"gradcam": 1e-3, "gradcampp": 1e-2}
# two detection sets "the same": every detection scoring above
# SAME_SET_BAND times the conf gate in one set pairs with one of the other
# (of the same class, within the box and relative score tolerances); a
# detection in the band just above the gate may cross it on a last-bit
# change of its score
SAME_SET_BAND = 1.5


def det_lines(dets, lb_shape, native_shape, save_conf=True):
    """Detections in a letterboxed frame -> detect's txt lines (xywhn, conf)."""
    from dmayolo_tpu_torch.eval.validator import _scale_to_native

    d = dets.copy()
    d[:, :4] = _scale_to_native(d[:, :4], lb_shape, native_shape)
    h, w = native_shape
    lines = []
    for x1, y1, x2, y2, conf, cls in d:
        row = [int(cls), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
               (x2 - x1) / w, (y2 - y1) / h] + ([conf] if save_conf else [])
        lines.append(" ".join(f"{v:.6g}" if j else str(int(v)) for j, v in enumerate(row)))
    return sorted(lines)


def label_lines(d):
    return {p.stem: sorted(ln for ln in p.read_text().split("\n") if ln)
            for p in sorted(Path(d).glob("*.txt"))}


def rows_of(lines):
    import numpy as np

    return np.array([ln.split() for ln in lines], np.float64).reshape(-1, 6)


def same_sets(a, b, box_tol, score_tol, conf, by_class=True):
    """(n, 6) rows [cls, 4 box, conf]: the larger of the two sets'
    unmatched-above-`conf` counts (0 when they are the same sets),
    matching each row to one row of the other (of the same class, with
    `by_class`) within the box tolerance and the relative score one: the
    nearest such row in box and score, so that near-duplicates pair with
    their own."""
    import numpy as np

    def unmatched(x, y):
        free = np.ones(len(y), bool)
        miss = 0
        for row in x[np.argsort(-x[:, -1])]:
            dist = np.abs(y[:, 1:5] - row[1:5]).max(1) if len(y) else np.zeros(0)
            ok = free & ((y[:, 0] == row[0]) | (not by_class)) & (dist <= box_tol) \
                & (np.abs(y[:, 5] - row[5]) <= score_tol * np.maximum(y[:, 5], row[5]))
            if ok.any():
                cost = dist + np.abs(y[:, 5] - row[5])
                free[np.argmin(np.where(ok, cost, np.inf))] = False
            elif row[5] > conf:
                miss += 1
        return miss

    return max(unmatched(a, b), unmatched(b, a))


def write_clip(path, sources, size, fps=VIDEO_FPS):
    """An `mp4v` clip of `sources` (image files), each letterboxed to
    `size` (width, height) on the host library, through the port's writer."""
    from dmayolo_tpu_torch.data import imageio, video
    from dmayolo_tpu_torch.data.letterbox import letterbox_host

    w = video.Writer(path, fps, size)
    try:
        for f in sources:
            w.write(letterbox_host(imageio.imread(f), (size[1], size[0]), auto=False)[0])
    finally:
        w.release()
    return path


def video_checks(device, counters, files, weights, model, pt2, gate, sizes, prec, dev):
    """`cli.detect` on a 1080p `mp4v` clip of `sizes["video_frames"]` val
    files (the tools' conf gate, their size): its model inputs the
    letterbox of the decoded frames, each frame's detections the same
    sets as `serve_detections` of that frame at batch 1 on `model`
    (`weights` folded), K3 once a frame and held against its plain
    version on frame 0's own candidates, `{stem}_det.mp4` read back with
    the input's frame count; FPS and ms a frame by part (decode,
    letterbox, infer synchronised, draw, encode: the CLI's own calls,
    clocked) over the frames after the first.  Then `stream_sources` such
    clips as a `.streams` list whose reads are paced against the served
    steps (a reader at most STREAM_AHEAD frames ahead), so that every run
    serves exactly `sizes["stream_steps"]` steps of every source: on the
    native model (K3 once a step) and through `pt2`, whose static batch
    `sizes["export_batch"]` is under the sources, so that the CLI chunks
    and pads;
    aggregate FPS over the steps after the first."""
    import numpy as np
    import torch

    from dmayolo_tpu_torch.cli import backends as cli_backends
    from dmayolo_tpu_torch.cli import detect as cli_detect
    from dmayolo_tpu_torch.core import nms as nms_mod
    from dmayolo_tpu_torch.core.fixpoint_kernel import (fixpoint_keep_blocked,
                                                        fixpoint_keep_blocked_plain)
    from dmayolo_tpu_torch.data import letterbox as lb_mod
    from dmayolo_tpu_torch.data import video

    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    n, size, imgsz = sizes["video_frames"], tuple(sizes["video_size"]), sizes["imgsz"]
    n_src, n_steps, export_batch = (sizes["stream_sources"], sizes["stream_steps"],
                                    sizes["export_batch"])
    # a clip must outlast the paced steps: no source ends before the last
    check(n > n_steps + STREAM_AHEAD and export_batch < n_src,
          f"video sizes: {n} frames for {n_steps} steps, a batch-{export_batch} program for "
          f"{n_src} sources")
    root = TOOLS_DIR / "video"
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    clips = [write_clip(root / f"clip{i}.mp4", files[i * n:(i + 1) * n], size)
             for i in range(n_src)]
    out = {"frames": n, "size": list(size), "imgsz": imgsz, "write_s": time.perf_counter() - t0}

    def zero():
        for c in counters:
            c.launches = 0

    def counted():
        return {c.__name__: c.launches for c in counters}

    def argv(source, name, w=weights):
        return ["--weights", str(w), "--source", str(source), "--imgsz", str(imgsz),
                "--conf-thres", repr(gate), "--project", str(root / "detect"), "--name", name,
                "--exist-ok", *prec, *dev]

    # ---- the clip through cli.detect, its calls clocked, its model inputs
    # and outputs kept, and frame 0's candidates to K3 recorded
    parts = {k: [] for k in ("decode", "letterbox", "infer", "draw", "encode")}
    inputs, outputs, loop, recorded = [], [], [], {}

    def clocked(name, fn, sync=False):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                r = fn(*a, **k)
                if sync and on_card:
                    torch.cuda.synchronize()
                return r
            finally:
                parts[name].append((t, time.perf_counter()))
        return run

    real = (cli_detect._run_video, video.Capture.read, lb_mod.letterbox_host, cli_detect.draw,
            video.Writer.write, nms_mod.fixpoint_keep_blocked)

    def run_video(opt, infer, *a, **k):
        timed = clocked("infer", infer, sync=True)

        def kept(x):
            dets, valid = timed(x)
            inputs.append(x.copy())
            outputs.append((dets.float().cpu().numpy(), valid.cpu().numpy()))
            return dets, valid
        t = time.perf_counter()
        try:
            return real[0](opt, kept, *a, **k)
        finally:
            loop.append(time.perf_counter() - t)

    def recording(boxes, valid, thr, max_det, block=512):
        recorded.setdefault("args", (boxes.clone(), valid.clone(), thr, max_det, block))
        return real[5](boxes, valid, thr, max_det, block)

    cli_detect._run_video, video.Capture.read = run_video, clocked("decode", real[1])
    lb_mod.letterbox_host, cli_detect.draw = clocked("letterbox", real[2]), clocked("draw", real[3])
    video.Writer.write, nms_mod.fixpoint_keep_blocked = clocked("encode", real[4]), recording
    zero()
    try:
        t0 = time.perf_counter()
        run = cli_detect.main(argv(clips[0], "clip"))
        wall = time.perf_counter() - t0
    finally:
        (cli_detect._run_video, video.Capture.read, lb_mod.letterbox_host, cli_detect.draw,
         video.Writer.write, nms_mod.fixpoint_keep_blocked) = real
    launches = counted()
    written = video.count_frames(run / "clip0_det.mp4")
    check(len(inputs) == n and written == n and len(parts["decode"]) == n + 1,
          f"cli.detect on the clip: {len(inputs)} frames served, {written} written, of {n}")
    # the frames after the first (its call builds and tunes): read i starts
    # frame i, read n (the end of the clip) ends frame n - 1
    reads = [t for t, _ in parts["decode"]]
    steady = reads[n] - reads[1]
    ms = {k: 1e3 * sum(b - a for a, b in v[1:n]) / (n - 1) for k, v in parts.items()}
    ms["other"] = 1e3 * steady / (n - 1) - sum(ms.values())
    out["detect"] = {"main_s": wall, "s": loop[0], "fps": (n - 1) / steady,
                     "fps_with_first": n / loop[0],
                     "first_frame_ms": 1e3 * (reads[1] - reads[0]), "ms_a_frame": ms,
                     "frames": len(inputs), "frames_written": written, "launches": launches}
    if on_card:
        check(launches["fixpoint_keep_blocked"] + launches["fixpoint_keep"] == n,
              f"cli.detect on the clip: K3 once a frame? {launches}")
    # K3 blocked on frame 0's own candidates, at the CLI's max_det
    check("args" in recorded, "cli.detect on the clip did not reach K3's blocked entry")
    boxes, valid, thr, max_det, block = recorded["args"]
    check(max_det == 1000 and boxes.shape[0] == 1 and boxes.shape[1] > 512,
          f"the clip's NMS took max_det {max_det}, candidates {tuple(boxes.shape)}")
    got = fixpoint_keep_blocked(boxes, valid, thr, max_det, block)
    want = fixpoint_keep_blocked_plain(boxes, valid, thr, max_det, block)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "K3 blocked differs from its plain version on the clip's frame 0 (max_det 1000)")
    out["k3_blocked"] = {"max_abs_err": max(float((a.long() - b.long()).abs().max())
                                            for a, b in zip(got, want)),
                         "live_candidates": int(valid.sum()),
                         **blocked_timing(device, "video frame 0", boxes, valid, thr, max_det,
                                          block)}
    # the same decoded frames served at batch 1
    cap = video.Capture(clips[0])
    unmatched, exact, dets_n, i = [], 0, 0, 0
    try:
        with torch.inference_mode():
            while (f := cap.read()) is not None:
                x = np.ascontiguousarray(lb_mod.letterbox_host(f, imgsz, auto=False)[0]
                                         [None, :, :, ::-1])
                check(i < n and np.array_equal(x, inputs[i]),
                      f"cli.detect's model input {i} is not the letterbox of decoded frame {i}")
                xt = torch.as_tensor(x, device=device)
                d, v = model.serve_detections(model.apply(xt.to(dtype) / 255.0, dtype=dtype,
                                                          fused=True), conf_thres=gate,
                                              iou_thres=0.45, max_det=1000, max_nms=30000)
                want = det_lines(d.float().cpu().numpy()[0][v.cpu().numpy()[0]], x.shape[1:3],
                                 f.shape[:2])
                got = det_lines(outputs[i][0][0][outputs[i][1][0]], x.shape[1:3], f.shape[:2])
                exact += got == want
                dets_n += len(got)
                unmatched.append(same_sets(rows_of(got), rows_of(want), 1e-5, 1e-5,
                                           SAME_SET_BAND * gate))
                i += 1
    finally:
        cap.release()
    out["detect"].update(vs_serve_unmatched=max(unmatched), vs_serve_exact_frames=exact,
                         detections=dets_n)
    check(i == n and max(unmatched) == 0 and dets_n > 0,
          f"cli.detect on the clip differs from serve_detections: {out['detect']}")
    del inputs, outputs

    # ---- the clips as streams, natively and through the .pt2, each
    # capture's reads paced against the served steps until the last
    streams = root / "clips.streams"
    streams.write_text("".join(f"{c}\n" for c in clips))
    real_parser, real_streams, real_load = (cli_detect.build_parser, cli_detect._run_streams,
                                            cli_backends.load_backend)
    pace, served, late = threading.Condition(), [0], []

    def paced_read(cap):
        k = getattr(cap, "paced_reads", 0)
        with pace:
            if not pace.wait_for(lambda: served[0] >= n_steps or k <= served[0] + STREAM_AHEAD,
                                 timeout=STREAM_PACE_TIMEOUT):
                late.append((cap.source, k))
        cap.paced_reads = k + 1
        return real[1](cap)

    def parser():
        p = real_parser()
        p.set_defaults(max_stream_steps=n_steps)
        return p

    out["streams"] = {"sources": n_src, "export_batch": export_batch}
    for label, w in (("native", weights), ("pt2", pt2)):
        steps, starts, program, loop = [], [], [], []
        served[0] = 0

        def run_streams(opt, infer, *a, **k):
            def step(x):
                steps.append(x.shape[0])
                starts.append(time.perf_counter())
                try:
                    return infer(x)
                finally:
                    with pace:
                        served[0] += 1
                        pace.notify_all()
            t = time.perf_counter()
            try:
                return real_streams(opt, step, *a, **k)
            finally:
                loop.append(time.perf_counter() - t)

        def load(*a, **k):
            fn, meta = real_load(*a, **k)

            def called(x):
                program.append(x.shape[0])
                return fn(x)
            return called, meta

        cli_detect.build_parser, cli_detect._run_streams = parser, run_streams
        cli_backends.load_backend, video.Capture.read = load, paced_read
        zero()
        try:
            t0 = time.perf_counter()
            cli_detect.main(argv(streams, f"streams_{label}", w))
            wall = time.perf_counter() - t0
        finally:
            cli_detect.build_parser, cli_detect._run_streams = real_parser, real_streams
            cli_backends.load_backend, video.Capture.read = real_load, real[1]
        # step 1 builds and tunes the batch's shapes: the aggregate FPS is
        # over the cycles from step 2's call to the last step's
        r = out["streams"][label] = {
            "main_s": wall, "s": loop[0], "steps": len(steps), "batches": steps,
            "fps_aggregate": sum(steps[1:-1]) / (starts[-1] - starts[1]),
            "first_step_ms": 1e3 * (starts[1] - starts[0]),
            "program_batches": program, "late_reads": late[:], "launches": counted()}
        check(steps == [n_src] * n_steps and not late,
              f"streams {label}: steps of {steps}, reads past the pace {late}")
        if label == "pt2":
            check(program == [export_batch] * (-(-n_src // export_batch) * n_steps),
                  f"streams on the .pt2: program calls at {program}")
        elif on_card:
            k3 = r["launches"]
            check(k3["fixpoint_keep_blocked"] + k3["fixpoint_keep"] == n_steps,
                  f"streams: K3 once a step? {k3}")
    return out


def tools_phase(device, counters, smi, frame, data_dir=DATA_DIR, cfg=None, sizes=TOOLS,
                nc=10):
    """The inference tools on the CLI phase's trained flagship (its EMA
    `last.npz`) over the data phase's val files (JPEG), as a user runs
    them: `cli.detect` (timed, K3 counted, held against `serve_detections`
    of the same batches; `fixpoint_keep_blocked` held against its plain
    version on the run's own candidates at max_det 1000), `--augment`,
    `cli.export` and detect on the `.pt2`, the `.pt` and fused `.npz`
    exports read back, a 1080p clip and three streams (`video_checks`), the
    frame decoded by nvJPEG and by libjpeg served to the same detections, `hub.load` and `Detections`, the REST server
    (batched and per request), `cli.gradcam` (held against the host CPU),
    and `cli.wbf` over two detect runs."""
    import shutil
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from dmayolo_tpu_torch import hub
    from dmayolo_tpu_torch.cli import common as cli_common
    from dmayolo_tpu_torch.cli import detect as cli_detect
    from dmayolo_tpu_torch.cli import export as cli_export
    from dmayolo_tpu_torch.cli import gradcam as cli_gradcam
    from dmayolo_tpu_torch.cli import wbf as cli_wbf
    from dmayolo_tpu_torch.core import nms as nms_mod
    from dmayolo_tpu_torch.core.fixpoint_kernel import (fixpoint_keep_blocked,
                                                        fixpoint_keep_blocked_plain)
    from dmayolo_tpu_torch.data import imageio
    from dmayolo_tpu_torch.data.letterbox import letterbox_host
    from dmayolo_tpu_torch.eval.gradcam import cam_for_detection, resolve_target_layer
    from dmayolo_tpu_torch.eval.validator import with_obj_column
    from dmayolo_tpu_torch.serve import example_request, restapi
    from dmayolo_tpu_torch.serve.batcher import MicroBatcher

    on_card = device.type == "cuda"
    dev = [] if on_card else ["--device", "cpu"]
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    weights = TOOLS_DIR / "last.npz"
    shutil.copy(CLI_DIR / "runs" / "flagship" / "last.npz", weights)
    if cfg is None:
        cfg_arg = f"{FLAGSHIP}.yaml"
    else:
        cfg_arg = str(TOOLS_DIR / "model.yaml")
        Path(cfg_arg).write_text(json.dumps(cfg))  # JSON is YAML
    files = sorted((data_dir / "images" / "val").iterdir())
    val_dir = data_dir / "images" / "val"
    dtype = torch.bfloat16 if on_card else torch.float32
    prec = [] if on_card else ["--fp32"]
    imgsz, bs = sizes["imgsz"], sizes["batch"]
    out = {"files": len(files), "imgsz": imgsz, "crop_files": sizes["crop_files"]}
    t_phase = time.perf_counter()

    def subset(name, n):
        d = TOOLS_DIR / "src" / name
        d.mkdir(parents=True)
        for f in files[:n]:
            (d / f.name).symlink_to(f)
        return d

    def zero():
        for c in counters:
            c.launches = 0

    def counted():
        return {c.__name__: c.launches for c in counters}

    def detect(name, *flags, source=val_dir, weights=weights):
        return cli_detect.main(["--weights", str(weights), "--source", str(source),
                                "--project", str(TOOLS_DIR / "detect"), "--name", name,
                                "--exist-ok", *flags, *prec, *dev])

    def letterboxed(chunk, size):
        ims0 = [imageio.imread(f) for f in chunk]
        x = np.stack([letterbox_host(im, size, auto=False, stride=32)[0][:, :, ::-1]
                      for im in ims0])
        return ims0, torch.as_tensor(x, device=device)

    def serve(model, x, conf, max_nms=30000):
        raw = model.apply(x.to(dtype) / 255.0, dtype=dtype, fused=True)
        dets, valid = model.serve_detections(raw, conf_thres=conf, iou_thres=0.45, max_det=1000,
                                             max_nms=max_nms)
        return dets.float().cpu().numpy(), valid.cpu().numpy()

    # ---- 0. the conf gate: the trained weights score every candidate far
    # under detect's default 0.25 (the CLI's two epochs), so the gate is set
    # under every first-batch image's `live`-th best candidate: detect's
    # NMS then sees thousands of live candidates and fills max_det 1000
    model = cli_common.load_model_from_checkpoint(weights, device=device).fuse()
    with torch.inference_mode():
        _, x = letterboxed(files[:bs], imgsz)
        _, scores, _ = model.decode_parts(model.apply(x.to(dtype) / 255.0, dtype=dtype,
                                                      fused=True))
        kth = scores.float().topk(min(sizes["live"], scores.shape[1]), dim=1).values[:, -1]
        top = float(scores.float().max())
    gate = float(kth.min()) * 0.99
    conf = ["--conf-thres", repr(gate)]
    out["conf"] = {"gate": gate, "best_score": top, "live_target": sizes["live"]}

    # ---- 1. cli.detect at the recipe's size: K3's blocked entry at max_det
    # 1000, its first call's candidates kept for the check below
    recorded, reads = {}, []
    real_blocked, real_imread = nms_mod.fixpoint_keep_blocked, imageio.imread

    def recording(boxes, valid, thr, max_det, block=512):
        recorded.setdefault("args", (boxes.clone(), valid.clone(), thr, max_det, block))
        return real_blocked(boxes, valid, thr, max_det, block)

    def clocked_imread(path):
        reads.append(time.perf_counter())
        return real_imread(path)

    main_files = files[:sizes["detect_files"]]
    main_src = subset("main", sizes["detect_files"])
    nms_mod.fixpoint_keep_blocked, imageio.imread = recording, clocked_imread
    zero()
    try:
        t0 = time.perf_counter()
        run = detect("main", "--imgsz", str(imgsz), "--batch-size", str(bs), "--save-txt",
                     "--save-conf", *conf, source=main_src)
        t1 = time.perf_counter()
    finally:
        nms_mod.fixpoint_keep_blocked, imageio.imread = real_blocked, real_imread
    n_batches = -(-len(main_files) // bs)
    labels = label_lines(run / "labels")
    n_dets = sum(len(v) for v in labels.values())
    out["detect"] = {"s": t1 - t0, "files": len(main_files),
                     "img_per_s": len(main_files) / (t1 - t0),
                     "img_per_s_after_first_batch": (len(main_files) - bs) / (t1 - reads[bs])
                     if len(reads) > bs else None,
                     "batch": bs, "batches": n_batches, "detections": n_dets,
                     "images_written": len(list(run.glob("*.jpg"))), "launches": counted()}
    check(len(labels) == len(main_files) and n_dets > 0, f"detect wrote {len(labels)} label files "
                                                    f"with {n_dets} detections")
    if on_card:
        check(out["detect"]["launches"]["fixpoint_keep_blocked"] == n_batches,
              f"detect: K3's blocked entry once a batch? {out['detect']['launches']}")
    # --save-crop on a few files (a crop a detection, up to 1000 an image)
    crops = detect("crops", "--imgsz", str(imgsz), "--batch-size", str(bs), "--save-crop",
                   "--nosave", *conf, source=subset("crops", sizes["crop_files"]))
    out["detect"]["crops"] = sum(1 for _ in (crops / "crops").rglob("*.jpg"))
    check(out["detect"]["crops"] == sum(len(labels[f.stem]) for f in files[:sizes["crop_files"]]),
          f"--save-crop wrote {out['detect']['crops']} crops")
    # the same batches through serve_detections: the same sets
    mismatched = []
    with torch.inference_mode():
        for start in range(0, len(main_files), bs):
            chunk = main_files[start:start + bs]
            ims0, x = letterboxed(chunk, imgsz)
            dets, valid = serve(model, x, gate)
            for i, (f, im0) in enumerate(zip(chunk, ims0)):
                if det_lines(dets[i][valid[i]], x.shape[1:3], im0.shape[:2]) != labels[f.stem]:
                    mismatched.append(f.name)
    out["detect"]["vs_serve_detections_mismatched"] = mismatched
    check(not mismatched, f"detect's labels differ from serve_detections on {mismatched[:4]}")
    # K3 blocked on the run's own candidates, at its max_det
    boxes, valid, thr, max_det, block = recorded["args"]
    check(max_det == 1000 and boxes.shape[1] > 512,
          f"detect's NMS took max_det {max_det}, K {boxes.shape[1]}")
    got = fixpoint_keep_blocked(boxes, valid, thr, max_det, block)
    want = fixpoint_keep_blocked_plain(boxes, valid, thr, max_det, block)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "K3 blocked differs from its plain version on detect's candidates (max_det 1000)")
    out["k3_blocked"] = {"max_abs_err": max(float((a.long() - b.long()).abs().max())
                                            for a, b in zip(got, want)),
                         "live_candidates": int(valid.sum()),
                         **blocked_timing(device, "detect", boxes, valid, thr, max_det, block)}
    print("tools detect: " + json.dumps(out["detect"]) + " K3 blocked: "
          + json.dumps(out["k3_blocked"]), flush=True)

    # ---- 2. the frame decoded by this machine's JPEG route and by libjpeg
    # (the fixture's pixels): the same detections above the libjpeg
    # decode's `frame_top`-th best score
    with torch.inference_mode():
        xs = [torch.as_tensor(letterbox_host(np.ascontiguousarray(im), imgsz, auto=False,
                                             stride=32)[0][None, :, :, ::-1].copy(), device=device)
              for im in (imageio.imread(JPEG_FIXTURES / f"{JPEG_FRAME}.jpg"), frame)]
        _, sc, _ = model.decode_parts(model.apply(xs[1].to(dtype) / 255.0, dtype=dtype,
                                                  fused=True))
        frame_gate = float(sc.float().topk(sizes["frame_top"], dim=1).values[0, -1]) * 0.99
        served = []
        for x in xs:
            d, v = serve(model, x, frame_gate)
            served.append(rows_of(det_lines(d[0][v[0]], x.shape[1:3], frame.shape[:2])))
    out["frame"] = {"gate": frame_gate, "detections": [len(r) for r in served],
                    "unmatched": same_sets(served[0], served[1], 2e-3, 0.05,
                                           SAME_SET_BAND * frame_gate)}
    check(out["frame"]["unmatched"] == 0 and len(served[1]) > 0,
          f"the frame decoded two ways serves other detections: {out['frame']}")
    del model

    # ---- 3. --augment (TTA, batched_nms) on one batch
    zero()
    t0 = time.perf_counter()
    aug = detect("augment", "--imgsz", str(imgsz), "--batch-size", str(bs), "--augment",
                 "--save-txt", "--save-conf", "--nosave", *conf,
                 source=subset("augment", sizes["augment_files"]))
    aug_labels = label_lines(aug / "labels")
    out["augment"] = {"s": time.perf_counter() - t0, "files": len(aug_labels),
                      "detections": sum(len(v) for v in aug_labels.values()),
                      "launches": counted()}
    check(len(aug_labels) == sizes["augment_files"], f"--augment: {out['augment']}")

    # ---- 4. cli.export, detect on the .pt2, the .pt and fused .npz read back
    t0 = time.perf_counter()
    exported = cli_export.main(["--weights", str(weights), "--imgsz", str(imgsz),
                                "--batch-size", str(sizes["export_batch"]), "--include",
                                "torch_export", "npz", "torch", *prec, *dev])
    out["export"] = {"s": time.perf_counter() - t0,
                     "files": {p.name: p.stat().st_size for p in exported}}
    fused_npz, pt, pt2 = exported
    src32 = subset("pt2", sizes["pt2_files"])
    eb = str(sizes["export_batch"])
    zero()
    t0 = time.perf_counter()
    via_pt2 = label_lines(detect("pt2", "--save-txt", "--save-conf", "--nosave", *conf,
                                 source=src32, weights=pt2) / "labels")
    out["export"]["pt2_detect_s"] = time.perf_counter() - t0
    out["export"]["pt2_launches"] = counted()
    native = label_lines(detect("native_pt2_batch", "--imgsz", str(imgsz), "--batch-size", eb,
                                "--save-txt", "--save-conf", "--nosave", *conf,
                                source=src32) / "labels")
    check(via_pt2.keys() == native.keys(), "the .pt2 run labelled other files")
    # the program against the model it was exported from, and the .pt2
    # run's labels against that model's decode through the .pt2 route's
    # NMS (`batched_nms`, as JAX's detect on an exported program)
    program = torch.export.load(str(pt2)).module()
    npz_model = cli_common.load_model_from_checkpoint(weights, device=device).fuse()
    err, mismatched, eb_n = 0.0, [], sizes["export_batch"]
    with torch.inference_mode():
        for start in range(0, sizes["pt2_files"], eb_n):
            chunk = files[start:start + eb_n]
            ims0 = [imageio.imread(f) for f in chunk]
            x = torch.as_tensor(np.stack([letterbox_host(im, imgsz, auto=False, stride=32)[0]
                                          [:, :, ::-1] for im in ims0]), device=device)
            dec = npz_model.decode(npz_model.apply(x.to(dtype) / 255.0, dtype=dtype, fused=True))
            err = max(err, float((program(x) - dec).abs().max()))
            dets, valid = nms_mod.batched_nms(with_obj_column(dec, nc), conf_thres=gate,
                                              iou_thres=0.45, max_det=1000)
            dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
            for i, (f, im0) in enumerate(zip(chunk, ims0)):
                if det_lines(dets[i][valid[i]], x.shape[1:3], im0.shape[:2]) != via_pt2[f.stem]:
                    mismatched.append(f.name)
    out["export"]["program_vs_model_max_abs_err"] = err
    out["export"]["pt2_vs_batched_nms_mismatched"] = mismatched
    check(err == 0 and not mismatched, f"detect on the .pt2 differs from its model's decode "
                                       f"and batched_nms: {out['export']}")
    # against the native run (nms_parts on decode_parts): the same boxes and
    # scores, but where a class's probability rounds to its neighbour's
    # (saturated logits), batched_nms' argmax on the products picks the
    # first class and decode_parts' on the logits the larger one: counted
    out["export"]["pt2_vs_native_exact_files"] = sum(via_pt2[k] == native[k] for k in native)
    for key, by_class in (("pt2_vs_native_unmatched", False),
                          ("pt2_vs_native_unmatched_by_class", True)):
        out["export"][key] = max(same_sets(rows_of(via_pt2[k]), rows_of(native[k]), 1e-5,
                                           1e-5, 0.0, by_class=by_class) for k in native)
    del program
    npz_model = cli_common.load_model_from_checkpoint(weights, device=device)
    pt_model = cli_common.load_model_from_checkpoint(pt, cfg=cfg_arg, nc=nc, device=device)
    a, b = npz_model.state_dict(), pt_model.state_dict()
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          "the .pt export does not load back to the .npz's weights")
    fz_model = cli_common.load_model_from_checkpoint(fused_npz, device=device)
    npz_model.fuse()
    x = torch.rand(2, 256, 256, 3, device=device, generator=torch.Generator(
        device=device).manual_seed(12))
    with torch.inference_mode():
        same = all(torch.equal(p, q) for p, q in zip(fz_model.apply(x, fused=True),
                                                      npz_model.apply(x, fused=True)))
    check(same, "the fused .npz export serves another head than the folded .npz")
    out["export"]["pt_and_fused_npz_read_back"] = True
    del pt_model, fz_model

    # ---- 4b. video: a 1080p mp4v clip of val frames through cli.detect,
    # frame by frame against serve_detections (on the folded .npz model);
    # three clips as streams, on the native model and through the .pt2
    # (batch 2, under the 3 sources: chunked and padded)
    out["video"] = video_checks(device, counters, files, weights, npz_model, pt2, gate, sizes,
                                prec, dev)
    del npz_model
    print("tools video: " + json.dumps(out["video"]), flush=True)

    # ---- 5. hub.load, AutoShape, Detections
    zero()
    t0 = time.perf_counter()
    auto = hub.load(str(weights), device=device)
    auto.dtype, auto.conf = dtype, gate
    res = auto([str(f) for f in files[:sizes["hub_files"]]], size=imgsz)
    crops = res.crop(save_dir=TOOLS_DIR / "hub" / "crops")
    saved = res.save(TOOLS_DIR / "hub" / "saved")
    out["hub"] = {"s": time.perf_counter() - t0, "detections": [len(d) for d in res.xyxy],
                  "crops": len(crops), "saved": len(list(saved.glob("*.jpg"))),
                  "tolist": len(res.tolist()), "launches": counted()}
    check(out["hub"]["crops"] == sum(out["hub"]["detections"]) > 0
          and out["hub"]["saved"] == out["hub"]["tolist"] == sizes["hub_files"],
          f"hub: {out['hub']}")
    if on_card:
        check(out["hub"]["launches"]["fixpoint_keep_blocked"] == 1, f"hub: {out['hub']}")
    del auto, res, crops

    # ---- 6. the REST server: 16 concurrent requests batched, then a few
    # per request; each answer against the same path called directly
    rest_model = cli_common.load_model_from_checkpoint(weights, device=device)
    batcher = MicroBatcher(rest_model, imgsz=sizes["rest_imgsz"], max_batch=sizes["rest_batch"],
                           max_wait_ms=50.0, conf_thres=gate, iou_thres=0.45, max_det=1000,
                           max_nms=4096, dtype=dtype, device=device)
    batcher.warmup()
    single = hub.load(str(weights), device=device)
    single.dtype, single.conf = dtype, gate
    # where a request's time goes, by the server's clock: the handler whole,
    # the upload's decode, the wait for its answer, and the batcher's batches
    spans = {"handler": [], "decode": [], "answer": [], "batch": []}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans[name].append((time.perf_counter() - t) * 1e3)
        return run

    class TimedBatcher:
        names = batcher.names
        __call__ = staticmethod(timed("answer", batcher))

    real_post, real_decode = restapi.Handler.do_POST, restapi.imdecode
    restapi.Handler.do_POST = timed("handler", real_post)
    restapi.imdecode = timed("decode", real_decode)
    batcher._run = timed("batch", batcher._run)
    servers = [restapi.make_server("127.0.0.1", 0, batcher=TimedBatcher()),
               restapi.make_server("127.0.0.1", 0, model=single, imgsz=sizes["rest_imgsz"])]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    keys = ("xmin", "ymin", "xmax", "ymax", "confidence", "class")
    try:
        urls = [f"http://127.0.0.1:{s.server_address[1]}/v1/object-detection" for s in servers]
        reqs = [files[i % len(files)] for i in range(sizes["rest_requests"])]
        answers, lat = [None] * len(reqs), [None] * len(reqs)

        def post(i):
            t = time.perf_counter()
            answers[i] = example_request.detect(str(reqs[i]), urls[0])
            lat[i] = (time.perf_counter() - t) * 1e3

        def burst():
            posts = [threading.Thread(target=post, args=(i,)) for i in range(len(reqs))]
            t0 = time.perf_counter()
            for t in posts:
                t.start()
            for t in posts:
                t.join(120)
            check(not any(t.is_alive() for t in posts) and all(a is not None for a in answers),
                  "REST: a batched request did not come back")
            return time.perf_counter() - t0

        # a first burst makes the server's per-request JPEG contexts (one a
        # concurrent request, kept for later ones): its latency is reported,
        # the second burst's is the server's steady state
        cold_wall = burst()
        cold = sorted(lat)
        answers, lat = [None] * len(reqs), [None] * len(reqs)
        hist0 = dict(batcher.stats_counters["batch_hist"])
        for v in spans.values():
            v.clear()
        zero()
        wall = burst()
        server = {k: {"n": len(v), "p50_ms": float(np.percentile(v, 50)),
                      "max_ms": float(max(v))} for k, v in spans.items() if v}
        launches = counted()
        hist = {int(k): v - hist0.get(k, 0) for k, v in batcher.stats_counters["batch_hist"].items()
                if v - hist0.get(k, 0)}
        # the same images submitted at once to the batcher: batches of the
        # same bucket, so the same sums
        pending = [batcher.submit(imageio.imread(f)[:, :, ::-1].copy()) for f in reqs]
        direct = [restapi.batch_records(p.result(120), batcher.names) for p in pending]
        exact = sum(a == json.loads(json.dumps(d)) for a, d in zip(answers, direct))
        unmatched = max(same_sets(*(np.array([[r["class"]] + [r[k] for k in keys[:5]] for r in x],
                                             np.float64).reshape(-1, 6) for x in (a, d)),
                                  1.0, 0.05, SAME_SET_BAND * gate) for a, d in zip(answers, direct))
        lat_s = sorted(lat)
        out["rest"] = {"requests": len(reqs), "wall_s": wall, "req_per_s": len(reqs) / wall,
                       "p50_ms": float(np.percentile(lat_s, 50)),
                       "p99_ms": float(np.percentile(lat_s, 99)), "batch_hist": hist,
                       "first_burst": {"wall_s": cold_wall, "p50_ms": float(np.percentile(cold, 50)),
                                       "p99_ms": float(np.percentile(cold, 99))},
                       "server": server,
                       "exact_answers": exact, "unmatched": unmatched, "launches": launches,
                       "detections": sum(len(a) for a in answers)}
        check(unmatched == 0 and out["rest"]["detections"] > 0,
              f"REST batched answers differ from the batcher's: {out['rest']}")
        if on_card:
            check(launches["fixpoint_keep_blocked"] == sum(hist.values()),
                  f"REST: K3's blocked entry once a batch? {out['rest']}")
        singles, lat1 = [], []
        for f in files[:sizes["rest_single"]]:
            t = time.perf_counter()
            got = example_request.detect(str(f), urls[1])
            lat1.append((time.perf_counter() - t) * 1e3)
            want = single(imageio.imread(f)[:, :, ::-1].copy(), size=sizes["rest_imgsz"]).records(0)
            singles.append(got == json.loads(json.dumps(want)))
        out["rest"]["per_request"] = {"requests": len(singles), "equal": sum(singles),
                                      "p50_ms": float(np.percentile(lat1, 50))}
        check(all(singles), f"REST per-request answers differ from AutoShape's: {singles}")
        bad = urllib.request.Request(urls[0], data=b"not an image",
                                     headers={"Content-Type": "application/octet-stream"})
        try:
            urllib.request.urlopen(bad)
            check(False, "REST answered an undecodable upload")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"REST: an undecodable upload gave {e.code}")
    finally:
        restapi.Handler.do_POST, restapi.imdecode = real_post, real_decode
        for s in servers:
            s.shutdown()
            s.server_close()
        batcher.close()
    del rest_model, batcher, single
    print("tools rest: " + json.dumps(out["rest"]), flush=True)

    # ---- 7. cli.gradcam at f32 (TF32 off), held against the host CPU
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out["gradcam"] = {}
    cam_src = subset("gradcam", sizes["gradcam_files"])
    cpu_model = cli_common.load_model_from_checkpoint(weights, device="cpu")
    layer = resolve_target_layer(cpu_model, sizes["gradcam_layer"])
    try:
        for method in ("gradcam", "gradcampp"):
            t0 = time.perf_counter()
            results = cli_gradcam.main(
                ["--model-path", str(weights), "--img-path", str(cam_src), "--output-dir",
                 str(TOOLS_DIR / "gradcam"), "--img-size", str(sizes["gradcam_imgsz"]),
                 "--target-layer", sizes["gradcam_layer"], "--method", method,
                 "--max-dets", str(sizes["gradcam_max_dets"]), *conf, *dev])
            r = {"s": time.perf_counter() - t0, "cams": [len(x["cams"]) for x in results]}
            check(len(results) == sizes["gradcam_files"] and r["cams"][0] > 0,
                  f"gradcam {method}: {r}")
            first = results[0]
            lb = letterbox_host(imageio.imread(first["path"]),
                                (sizes["gradcam_imgsz"],) * 2, auto=False)[0]
            x = torch.as_tensor(lb[None, :, :, ::-1].astype(np.float32) / 255.0)
            cam = cam_for_detection(cpu_model, x, layer, int(first["cands"][0]),
                                    int(first["dets"][0][5]), method=method)
            r["cam_shape"] = list(cam.shape)
            r["card_vs_cpu_max_abs_err"] = float(np.abs(first["cams"][0] - cam).max())
            r["tol"] = CAM_TOL[method]
            check(r["card_vs_cpu_max_abs_err"] <= CAM_TOL[method],
                  f"gradcam {method}: card vs CPU {r['card_vs_cpu_max_abs_err']:.2e}")
            out["gradcam"][method] = r
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del cpu_model

    # ---- 8. cli.wbf over the first run's labels and a second run's at
    # another size, on the files WBF fuses
    zero()
    t0 = time.perf_counter()
    second = detect("wbf_second", "--imgsz", str(sizes["wbf_imgsz"]), "--batch-size", str(bs),
                    "--save-txt", "--save-conf", "--nosave", *conf,
                    source=subset("wbf", sizes["wbf_files"]))
    out["wbf"] = {"second_detect_s": time.perf_counter() - t0, "second_launches": counted()}
    t0 = time.perf_counter()
    # WBF's clustering is a host loop over every pair of boxes an image
    # (JAX's, line for line): on `wbf_files` images of up to 2,000 boxes;
    # the trained weights' scores sit far under its default skip (0.01)
    dirs = []
    for name, d in (("first", run), ("second", second)):
        dirs.append(TOOLS_DIR / "wbf_in" / name)
        dirs[-1].mkdir(parents=True)
        for f in files[:sizes["wbf_files"]]:
            (dirs[-1] / f"{f.stem}.txt").symlink_to(d / "labels" / f"{f.stem}.txt")
    cli_wbf.main([*map(str, dirs), "--out", str(TOOLS_DIR / "wbf"), "--no-one-indexed-cls",
                  "--skip-box-thr", repr(gate)])
    fused = label_lines(TOOLS_DIR / "wbf")
    rows = [rows_of(v) for v in fused.values() if v]
    out["wbf"].update(s=time.perf_counter() - t0, files=len(fused),
                      boxes=sum(len(r) for r in rows))
    # scores are written to 6 decimals (JAX's format): the gate's scale
    # rounds some to 0
    check(len(fused) == sizes["wbf_files"] and rows and all(
        ((r[:, 1:5] >= 0) & (r[:, 1:5] <= 1)).all() and (r[:, 5] >= 0).all() for r in rows)
        and any((r[:, 5] > 0).any() for r in rows), f"wbf: {out['wbf']}")
    out["s"] = time.perf_counter() - t_phase
    return out


def print_tools(jp, tp, smi):
    """The jpeg and tools phases' summary lines."""
    fx = jp["fixtures"]
    print(f"jpeg ({jp['codec']}) against libjpeg's pixels: " + "; ".join(
        f"{n} max {r['max_abs']} mean {r['mean_abs']:.4f} >2: {r['share_over_2']:.4f}"
        + (f" (box-upsampled: max {r['box_upsampled']['max_abs']} mean "
           f"{r['box_upsampled']['mean_abs']:.4f} >2: {r['box_upsampled']['share_over_2']:.4f})"
           if "box_upsampled" in r else "")
        for n, r in fx.items()) + f"; bounds {JPEG_BOUNDS}", flush=True)
    print(f"jpeg: {jp['frame_shape'][1]}x{jp['frame_shape'][0]} frame decode "
          f"{jp['decode_ms']:.2f} ms ({jp['codec']}), PNG of the same pixels "
          f"{jp['png_decode_ms']:.2f} ms; q95 encode {jp['encode_ms']:.2f} ms, "
          f"{jp['q95_bytes']} bytes, PSNR {jp['q95_psnr_db']:.2f} dB; on {smi}", flush=True)
    d, k = tp["detect"], tp["k3_blocked"]
    print(f"tools conf gate {tp['conf']['gate']:.3e} (best score {tp['conf']['best_score']:.3e}; "
          f"the default 0.25 keeps nothing)", flush=True)
    print(f"tools detect {d['files']} JPEG files at {tp['imgsz']} px bs{d['batch']}: "
          f"{d['img_per_s']:.2f} img/s whole run, {d['img_per_s_after_first_batch']:.2f} after "
          f"the first batch; {d['detections']} detections, {d['crops']} crops from "
          f"{tp['crop_files']} files; K3 blocked "
          f"{d['launches']['fixpoint_keep_blocked']} launches; on {smi}", flush=True)
    print(f"tools K3 blocked {tuple(k['shape'])} on detect's candidates ({k['live_candidates']} "
          f"live, {k['blocks_walked']} blocks walked): call {k['ms']:.4f} ms, kernel "
          f"{k['kernel_ms']:.4f} ms, plain {k['plain_ms']:.2f} ms, bound {k['bound_ms']:.4f} ms "
          f"({k['bound_by']}); on {smi}", flush=True)
    v, vd, vk = tp["video"], tp["video"]["detect"], tp["video"]["k3_blocked"]
    vs = {k: r for k, r in v["streams"].items() if k in ("native", "pt2")}
    print(f"tools video: {v['size'][0]}x{v['size'][1]} mp4v clip of {vd['frames']} val frames "
          f"through cli.detect at {v['imgsz']} px: {vd['fps']:.2f} FPS after the first frame "
          f"({vd['first_frame_ms']:.1f} ms; {vd['fps_with_first']:.2f} FPS with it); ms a frame "
          + ", ".join(f"{k} {x:.2f}" for k, x in vd["ms_a_frame"].items())
          + f"; {vd['detections']} detections, {vd['vs_serve_exact_frames']} of {vd['frames']} "
          f"frames' label lines equal to serve_detections' at batch 1 (unmatched "
          f"{vd['vs_serve_unmatched']}); K3 blocked {vd['launches']['fixpoint_keep_blocked']} "
          f"launches, on frame 0's {tuple(vk['shape'])} ({vk['live_candidates']} live) call "
          f"{vk['ms']:.4f} ms, kernel {vk['kernel_ms']:.4f} ms, plain {vk['plain_ms']:.2f} ms, "
          f"bound {vk['bound_ms']:.4f} ms ({vk['bound_by']}), max |err| {vk['max_abs_err']}; "
          f"{vd['frames_written']} frames written back; streams over {v['streams']['sources']} "
          f"clips, paced: "
          + "; ".join(f"{k} {r['steps']} steps of {r['batches'][0]}, {r['fps_aggregate']:.2f} "
                      f"FPS aggregate after the first step ({r['first_step_ms']:.1f} ms), "
                      f"{r['s']:.1f} s" for k, r in vs.items())
          + f" (the batch-{v['streams']['export_batch']} .pt2's program called "
          f"{len(vs['pt2']['program_batches'])} times); clips written in {v['write_s']:.1f} s; "
          f"on {smi}", flush=True)
    r = tp["rest"]
    print(f"tools rest {r['requests']} concurrent requests: p50 {r['p50_ms']:.1f} ms, p99 "
          f"{r['p99_ms']:.1f} ms, {r['req_per_s']:.1f} req/s, batches {r['batch_hist']} (the "
          f"first burst: p50 {r['first_burst']['p50_ms']:.1f}, p99 "
          f"{r['first_burst']['p99_ms']:.1f} ms), "
          f"{r['exact_answers']} answers bit-equal to the batcher's; server side "
          + ", ".join(f"{k} p50 {v['p50_ms']:.1f} ms (n {v['n']})" for k, v in r["server"].items())
          + "; per request p50 "
          f"{r['per_request']['p50_ms']:.1f} ms; on {smi}", flush=True)
    e = tp["export"]
    print(f"tools export {e['s']:.1f} s ({', '.join(e['files'])}); detect on the .pt2 "
          f"{e['pt2_detect_s']:.1f} s, equal to its model's decode and batched_nms; against "
          f"the native run {e['pt2_vs_native_exact_files']} label files byte-equal, unmatched "
          f"{e['pt2_vs_native_unmatched']} without the class, "
          f"{e['pt2_vs_native_unmatched_by_class']} with it; augment {tp['augment']['detections']} detections "
          f"in {tp['augment']['s']:.1f} s; hub {sum(tp['hub']['detections'])} detections; "
          f"frame both ways {tp['frame']['detections']}; gradcam "
          + ", ".join(f"{m} card vs CPU {g['card_vs_cpu_max_abs_err']:.1e} (tol {g['tol']})"
                      for m, g in tp["gradcam"].items())
          + f"; wbf {tp['wbf']['boxes']} boxes over {tp['wbf']['files']} files; phase "
          f"{tp['s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# int8 PTQ serving and eval: K4 (conv_int8) and its input quantize
# ---------------------------------------------------------------------------

INT8_CHECKED = (FLAGSHIP, "yolov5s", "C3CASPD2")  # every eligible shape held at bs8
INT8_SERVED = (FLAGSHIP, "yolov5s")  # served at bs128 (bench.py:188-270), timed at their shapes
# off-model K4 cases (B, H, W, C1, C2, k, s, p, d), each route's edges:
# C1 24 and 40 (padded channel tails), C1 20 (a bf16 row TMA cannot
# stride: quantize_s8 and the s8 form), C1 136 (a second, partial
# 128-channel chunk), C2 45, 8, 130, 200 and 300 (ragged BN tiles), H or W
# of 1, ragged patches, stride 2 on odd sizes; route (d): k 5 with d 2, a
# 1x1 at stride 2 and a 3x3 without pad
INT8_OFF_MODEL = [(2, 37, 53, 24, 45, 3, 1, 1, 1), (1, 21, 19, 32, 60, 5, 1, 4, 2),
                  (3, 17, 15, 16, 200, 3, 2, 1, 1), (2, 11, 13, 48, 8, 1, 1, 0, 1),
                  (1, 29, 31, 64, 130, 1, 1, 0, 1), (2, 1, 37, 40, 24, 3, 1, 1, 1),
                  (3, 23, 1, 24, 45, 1, 1, 0, 1), (1, 9, 1, 136, 300, 3, 2, 1, 1),
                  (2, 13, 9, 20, 16, 3, 1, 1, 1), (2, 15, 17, 32, 64, 1, 2, 0, 1),
                  (1, 12, 10, 48, 72, 3, 1, 0, 1)]
# a zoo model whose int8 convs take route (d) (four 5x5 convs): served
# int8 once a run, so that the route runs on a main path
INT8_GENERAL_MODEL = "CASMM"
INT8_CAL_IMAGES = 8  # random 640 px calibration images, as bench.py calibrates
# f32 int8 head, card vs CPU (equal to the bit on an H100): room for a
# flip, and none for a float head (off at ~all values; int8_head_vs_cpu)
INT8_HEAD_TOL = dict(close=1e-6, share=0.01, worst=0.005)
INT8_HEAD_IMGSZ = 128
INT8_MAP_TOL = 0.05  # |int8 - float| mAP@.5 of the trained tiny model (tests/test_int8_serve.py)
INT8_MAP_FLOOR = 0.15
INT8_DIR = ROOT / "build" / "int8_smoke"
# tests/test_e2e_train.py's tiny model and hyp, trained as tests/test_int8_serve.py:21-32
TINY_CFG = {"nc": 3, "depth_multiple": 0.33, "width_multiple": 0.25,
            "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]],
            "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]],
                         [-1, 2, "C3", [128]], [-1, 1, "Conv", [256, 3, 2]],
                         [-1, 2, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
                         [-1, 1, "C3", [512]], [-1, 1, "SPPF", [512, 5]]],
            "head": [[[4, 6, 7], 1, "Detect", ["nc", "anchors"]]]}
TINY_HYP = {"lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005,
            "warmup_epochs": 0.5, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
            "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
            "anchor_t": 4.0, "fl_gamma": 0.0, "label_smoothing": 0.0,
            "hsv_h": 0.015, "hsv_s": 0.5, "hsv_v": 0.3, "degrees": 0.0, "translate": 0.1,
            "scale": 0.3, "shear": 0.0, "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
            "mosaic": 0.5, "mixup": 0.0}
INT8_TINY = dict(img_size=256, n_train=48, n_val=24, epochs=28, batch=8, warmup_min_iters=60,
                 ncalib=8)
INT8 = dict(imgsz=640, check_batch=8, step_batch=128, serve_batch=128, tiny=INT8_TINY)


def int8_sites(cfg, imgsz=640, nc=10):
    """{(H, W, C1, C2, k, s, p, d): count} of a model's int8-eligible convs
    (`nn/quant.py`) in one forward at `imgsz`, read by forward hooks on the
    meta device (no weights, no card)."""
    import collections

    import torch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.nn.quant import eligible_conv_paths

    model = DetectionModel(cfg, nc=nc, device="meta")
    sites = collections.Counter()

    def hook(conv, args, _):
        _, c, h, w = args[0].shape
        sites[(h, w, c, conv.c2, conv.k[0], conv.s[0], conv.p[0], conv.d[0])] += 1

    handles = [m.register_forward_hook(hook) for m in eligible_conv_paths(model).values()]
    try:
        model.apply(torch.empty(1, imgsz, imgsz, 3, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return dict(sorted(sites.items(), key=lambda kv: (-kv[0][0], kv[0][2], kv[0][3])))


def int8_bytes_ops(b, h, w, c1, c2, k, s, p, d):
    """The least traffic and the operations of one int8 conv of a bf16
    input, and of the quantize alone.  The conv: the bf16 input read once
    and no s8 copy of it, the s8 weights, the bf16 output written once and
    the f32 scale and bias; 2 operations a multiply-add on the real C1, not
    the padded one.  The quantize: bf16 in, s8 out; one multiply, round and
    clip a value."""
    from dmayolo_tpu_torch.nn.conv_int8 import out_size

    ho, wo = out_size(h, k, s, p, d), out_size(w, k, s, p, d)
    conv = (b * h * w * c1 * 2 + c2 * k * k * c1 + b * ho * wo * c2 * 2 + 2 * c2 * 4,
            2 * b * ho * wo * c2 * k * k * c1)
    return conv, (b * h * w * c1 * 3, 3 * b * h * w * c1)


def int8_route(b, h, w, c1, c2, k, s, p, d):
    """The K4 route that serves a bf16 input of this conv, and whether it
    quantizes inside the conv kernel."""
    from dmayolo_tpu_torch.nn.conv_int8 import plan_int8

    import torch

    plan = plan_int8(b, h, w, c1, c2, (k, k), (s, s), (p, p), (d, d), torch.bfloat16)
    return plan.route, plan.convert


def int8_bound(b, h, w, c1, c2, k, s, p, d):
    """(bound_ms, bound_by) of one bf16-input int8 conv: the function's
    least time, whatever route serves it (route (d) quantizes first, in a
    kernel of its own, and is held to the same bound)."""
    return bound(*int8_bytes_ops(b, h, w, c1, c2, k, s, p, d)[0], "int8")


def tie_case(device):
    """A 1x1 conv (C1 2112 -> 8) whose s32 sums sit above 2^24 at the
    points where s32 -> f32 -> bf16 rounds twice: integer x at s_x 1 and
    integer weights of max 127 quantize to themselves, and channel 0's sum
    is 127 * (the sum of x but the last) + the last x (as the CPU test
    builds it)."""
    import torch

    c1, c2 = 2112, 8
    targets = [2 ** 24 + 2 ** 16 + 1, 2 ** 24 + 2 ** 16 - 1, 2 ** 24 + 2 ** 16 + 3,
               2 ** 25 + 2 ** 17 + 1, 2 ** 25 + 2 ** 17 + 2, 2 ** 24 + 1, 2 ** 24 + 3,
               2 ** 25 + 3, 2 ** 25 + 2, 33_000_001, 20_000_001, 2 ** 24 + 2 ** 17 + 2 ** 16 + 1]
    targets += [-t for t in targets[:4]]
    x = torch.zeros(1, 4, 4, c1)
    for i, t in enumerate(targets):
        s, last = divmod(abs(t), 127)
        full, rest = divmod(s, 127)
        row = torch.zeros(c1)
        row[:full], row[full], row[-1] = 127, rest, last
        x[0, i // 4, i % 4] = row if t > 0 else -row
    w = torch.full((c2, c1, 1, 1), 127.0)
    w[:, -1, 0, 0] = torch.arange(1, c2 + 1, dtype=torch.float32)
    return x.to(device), w, torch.linspace(-3, 3, c2), 1.0


def check_int8_case(device, x, w, bias, s_x, s, p, d, timed=False, iters=10):
    """K4 and the quantize against their plain versions on one input, at
    max |err| 0: the quantized input from bf16 and from f32 (`quantize_s8`),
    then both entries at every output: `conv_int8` on the s8 input (the
    route's s8 form) and `quantize_conv_int8` on the bf16 and the f32
    input (routes (a)-(c) quantize a bf16 input inside the conv), each to
    the s32 sums and the f32 and bf16 outputs.  `timed`: the bf16 call
    (bf16 in and out, as served), its kernels alone (CUDA-graph replay)
    and its plain version; where the route quantizes first, the quantize
    alone and its plain version; where `_int_mm` takes the conv, `_int_mm`
    on the same s8 product (held equal to the sums).  `max_abs_err`: the
    largest |K4 - plain| over the sums and the outputs;
    `quantize_max_abs_err`, the quantize's."""
    import torch

    from dmayolo_tpu_torch.nn.conv_int8 import (conv_int8, conv_int8_plain, dequant_params,
                                                dequant_plain, prepare_weight, quantize_conv_int8,
                                                quantize_conv_int8_plain, quantize_s8,
                                                quantize_s8_plain, reciprocal_f32)

    inv = reciprocal_f32(s_x)
    wq, s_w = prepare_weight(w.to(device))
    c1p = wq.shape[3]
    xq, q_err, sums = {}, 0, {}
    geo = ((s, s), (p, p), (d, d))
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        xq[dt] = quantize_s8(xd, inv, c1p)
        q_plain = quantize_s8_plain(xd, inv, c1p)
        q_err = max(q_err, int((xq[dt].short() - q_plain.short()).abs().max()))
        check(torch.equal(xq[dt], q_plain),
              f"quantize_s8 differs from its plain version from {dt} at {tuple(x.shape)}")
        sums[dt] = conv_int8_plain(q_plain, wq, None, None, *geo, torch.int32)
    c2, k = w.shape[0], w.shape[2]
    route, convert = int8_route(*x.shape, c2, k, s, p, d)
    row = {"route": route,
           "max_abs_sum": int(sums[torch.bfloat16].abs().max()),
           "sums_over_2_24": int((sums[torch.bfloat16].abs() > 2 ** 24).sum()),
           "max_abs_err": 0.0, "quantize_max_abs_err": float(q_err)}
    params = {torch.int32: (None, None)}
    for dt in (torch.float32, torch.bfloat16):
        params[dt] = dequant_params(s_x, s_w, bias.to(device), dt)
    calls = [("conv_int8 s8 -> ", torch.bfloat16,
              lambda out: conv_int8(xq[torch.bfloat16], wq, *params[out], *geo, out))]
    calls += [(f"quantize_conv_int8 {dt} -> ", dt,
               lambda out, dt=dt: quantize_conv_int8(x.to(dt), inv, wq, *params[out], *geo, out))
              for dt in (torch.bfloat16, torch.float32)]
    for label, dt, call in calls:
        for out in (torch.int32, torch.float32, torch.bfloat16):
            y = call(out)
            want = dequant_plain(sums[dt], *params[out], out)
            err = float((y.double() - want.double()).abs().max())
            row["max_abs_err"] = max(row["max_abs_err"], err)
            check(y.dtype == out and torch.equal(y, want),
                  f"K4 {label}{out} ({row['route']}) differs from the plain version at "
                  f"{tuple(x.shape)} k{w.shape[2]} s{s} p{p} d{d}: max {err}")
    if timed and device.type == "cuda":
        scale, b = params[torch.bfloat16]
        xb = x.to(torch.bfloat16)
        call = lambda: quantize_conv_int8(xb, inv, wq, scale, b, *geo, torch.bfloat16)  # noqa: E731
        row.update(ms=cuda_ms(call, iters), kernel_ms=graph_ms(call, iters),
                   plain_ms=cuda_ms(lambda: quantize_conv_int8_plain(
                       xb, inv, wq, scale, b, *geo, torch.bfloat16), 2))
        if not convert:
            quant = lambda: quantize_s8(xb, inv, c1p)  # noqa: E731
            row.update(quantize_ms=cuda_ms(quant, iters), quantize_kernel_ms=graph_ms(quant, iters),
                       quantize_plain_ms=cuda_ms(lambda: quantize_s8_plain(xb, inv, c1p), iters))
        if int_mm_takes(c2, k, s, p):
            a, bt = xq[torch.bfloat16].view(-1, c1p), wq.view(c2, c1p).t()
            check(torch.equal(torch._int_mm(a, bt), sums[torch.bfloat16].view(-1, c2)),
                  f"_int_mm and the plain sums disagree at {tuple(x.shape)} -> {c2}")
            row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(a, bt), iters)
    return row


def int_mm_takes(c2, k, s, p):
    """Whether `torch._int_mm` computes this conv's s8 product: a 1x1
    conv at stride 1 without pad, C2 a multiple of 8 (its shape rule)."""
    return k == 1 and s == 1 and p == 0 and c2 % 8 == 0


# keys of a timed row that `route_sums` adds up, where the row has them
ROUTE_SUM_KEYS = ("ms", "kernel_ms", "plain_ms", "bound_ms", "cudnn_bf16_ms", "int_mm_ms",
                  "s8_kernel_ms", "quantize_ms", "quantize_kernel_ms", "quantize_plain_ms",
                  "quantize_bound_ms")


def route_sums(rows, weight="count"):
    """Per K4 route: the convs (`weight` each shape: its count, or 1) and
    the weighted sums of each timed key (`ROUTE_SUM_KEYS`), the bound's
    sum and the share of it that the kernels reach; the convs `_int_mm`
    takes and the route's kernels on those alone."""
    out = {}
    for r in rows:
        n = r["count"] if weight == "count" else 1
        g = out.setdefault(r["route"], {"convs": 0, "shapes": 0, "bytes_bound_ms": 0.0})
        g["convs"] += n
        g["shapes"] += 1
        for key in ROUTE_SUM_KEYS:
            if r.get(key) is not None:
                g[key] = g.get(key, 0.0) + n * r[key]
        if r.get("int_mm_ms") is not None:
            g["int_mm_convs"] = g.get("int_mm_convs", 0) + n
            g["kernel_ms_on_int_mm_convs"] = g.get("kernel_ms_on_int_mm_convs", 0.0) + n * r[
                "kernel_ms"]
        if r.get("bound_by") == "bytes":
            g["bytes_bound_ms"] += n * r["bound_ms"]
    for g in out.values():
        if "bound_ms" in g:
            g["bound_by"] = "bytes" if 2 * g["bytes_bound_ms"] >= g["bound_ms"] else "operations"
        if "kernel_ms" in g:
            g["share_of_bound"] = g["bound_ms"] / g["kernel_ms"]
    return out


def check_int8_shapes(device, sites, batch=8, timed=False, seed=0):
    """`check_int8_case` at each eligible shape of `sites` at `batch`,
    random inputs and weights from a seed; with `timed`, the sums over the
    shapes (each once), their bound (the sum of each conv's own), the
    quantize's bound where a route quantizes first, and the same by
    route."""
    import torch

    g = torch.Generator().manual_seed(seed)
    rows = []
    for (h, w, c1, c2, k, s, p, d), count in sites.items():
        x = (torch.randn(batch, h, w, c1, generator=g) * 2).to(device)
        wt = torch.randn(c2, c1, k, k, generator=g) * (k * k * c1) ** -0.5
        bias = torch.randn(c2, generator=g)
        row = {"shape": [batch, h, w, c1, c2, k, s, p, d], "count": count,
               **check_int8_case(device, x, wt, bias, float(x.abs().max()) / 127.0, s, p, d,
                                 timed=timed)}
        row["bound_ms"], row["bound_by"] = int8_bound(batch, h, w, c1, c2, k, s, p, d)
        if "quantize_ms" in row:
            qb, qo = int8_bytes_ops(batch, h, w, c1, c2, k, s, p, d)[1]
            row["quantize_bound_ms"] = bound(qb, qo, "bf16")[0]
        rows.append(row)
        del x
    out = {"batch": batch, "shapes": rows,
           **{k: max(r[k] for r in rows) for k in ("max_abs_err", "quantize_max_abs_err")}}
    if timed and device.type == "cuda":
        for key in ("ms", "kernel_ms", "plain_ms", "bound_ms"):
            out[key] = sum(r[key] for r in rows)
        out["routes"] = route_sums(rows, weight="once")
    return out


def time_int8_step(device, sites, batch=128, iters=10, seed=0):
    """K4 at each eligible shape of one step at `batch`, as served: the
    bf16 call (bf16 in, bf16 out; routes (a)-(c) quantize inside the
    conv) and its kernels alone (CUDA-graph replay), and cuDNN's bf16
    `F.conv2d` on the same shape (channels_last, the context).  On the
    convs `torch._int_mm` takes (`int_mm_takes`), `_int_mm` on the same
    s8 product beside the route's s8 form alone and the quantize that its
    s8 input needs.  Each conv's bound (`int8_bound`); the sums over the
    step's convs, each shape weighted by its count, the bound as the sum
    of each conv's own, and the same by route."""
    import torch
    import torch.nn.functional as F

    from dmayolo_tpu_torch.nn.conv_int8 import (conv_int8, padded_channels, quantize_conv_int8,
                                                quantize_s8)

    g = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for (h, w, c1, c2, k, s, p, d), count in sites.items():
        c1p = padded_channels(c1)
        xb = torch.randn(batch, h, w, c1, device=device, generator=g).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (c2, k, k, c1p), device=device, generator=g,
                           dtype=torch.int8)
        scale = torch.rand(c2, device=device, generator=g).to(torch.bfloat16)
        bias = torch.rand(c2, device=device, generator=g).to(torch.bfloat16)
        geo = ((s, s), (p, p), (d, d))
        call = lambda: quantize_conv_int8(xb, 0.5, wq, scale, bias, *geo,  # noqa: E731
                                          torch.bfloat16)
        row = {"shape": [batch, h, w, c1, c2, k, s, p, d], "count": count,
               "route": int8_route(batch, h, w, c1, c2, k, s, p, d)[0],
               "ms": cuda_ms(call, iters), "kernel_ms": graph_ms(call, iters)}
        row["bound_ms"], row["bound_by"] = int8_bound(batch, h, w, c1, c2, k, s, p, d)
        xn = xb.permute(0, 3, 1, 2)  # channels_last view for cuDNN
        wn = torch.randn(c2, c1, k, k, device=device, generator=g).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        row["cudnn_bf16_ms"] = cuda_ms(lambda: F.conv2d(xn, wn, None, s, p, d), iters)
        row["int_mm_ms"] = None
        if int_mm_takes(c2, k, s, p):
            xq = quantize_s8(xb, 0.5, c1p)
            a, bt = xq.view(-1, c1p), wq.view(c2, c1p).t()
            sums = conv_int8(xq, wq, None, None, *geo, torch.int32).view(-1, c2)
            check(torch.equal(torch._int_mm(a[:64], bt), sums[:64]),
                  f"_int_mm and K4 disagree at {row['shape']}")
            del sums
            row.update(int_mm_ms=cuda_ms(lambda: torch._int_mm(a, bt), iters),
                       s8_kernel_ms=graph_ms(lambda: conv_int8(xq, wq, scale, bias, *geo,
                                                               torch.bfloat16), iters),
                       quantize_ms=graph_ms(lambda: quantize_s8(xb, 0.5, c1p), iters))
            del xq, a, bt
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        del xb, wq, xn, wn
    weighted = lambda key, rs=rows: sum(r["count"] * r[key] for r in rs)  # noqa: E731
    ones = [r for r in rows if r["int_mm_ms"] is not None]
    out = {"batch": batch, "convs": sum(sites.values()), "shapes": rows,
           **{f"step_{key}": weighted(key) for key in (
               "ms", "kernel_ms", "cudnn_bf16_ms", "bound_ms")},
           "step_1x1_convs": sum(r["count"] for r in ones),
           **{f"step_1x1_{key}": weighted(key, ones) for key in (
               "kernel_ms", "s8_kernel_ms", "quantize_ms", "int_mm_ms")},
           "routes": route_sums(rows)}
    out["step_share_of_bound"] = out["step_bound_ms"] / out["step_kernel_ms"]
    return out


def int8_serving(device, cfg, name, counters, batch=128, imgsz=640, nc=10, head_check=False):
    """int8 serving as bench.py:188-270 times it: the model (seeded, head
    priors, BN calibrated) folded, int8 input scales calibrated on
    `INT8_CAL_IMAGES` random 640 px images at f32, then uint8 in, bf16,
    conf 0.25, IoU 0.45, max_nms 512 on "matrix", (B, 300, 6) out.  The
    int8 step is driven once with the counters zeroed before and read
    after (K4 and the quantize once an eligible conv, K3 once), timed
    beside the bf16 step in turns (bf16, int8, int8, bf16), and profiled
    by group.  With `head_check`, the f32 int8 raw head on the card
    against the host CPU's (the plain versions) at `INT8_HEAD_IMGSZ`."""
    import numpy as np
    import torch

    from dmayolo_tpu_torch.nn.quant import calibrate_act_scales, quant_coverage

    t0 = time.perf_counter()
    model = build_model(device, imgsz, cfg=cfg, nc=nc).fuse()
    rng = np.random.default_rng(8)
    cal = [rng.integers(0, 256, (INT8_CAL_IMAGES, imgsz, imgsz, 3), dtype=np.uint8)]
    t1 = time.perf_counter()
    scales = calibrate_act_scales(model, cal, dtype=torch.float32)
    out = {"model": name, "coverage": quant_coverage(model, scales), "int8_convs": len(scales),
           "calibration_s": time.perf_counter() - t1, "build_s": t1 - t0}
    bf16 = torch.bfloat16
    xb = torch.from_numpy(rng.integers(0, 256, (batch, imgsz, imgsz, 3),
                                       dtype=np.uint8)).to(device)

    def step(quant):
        with torch.inference_mode():
            raw = model.apply(xb.to(bf16) / 255.0, bf16, fused=True, quant=quant)
            return model.serve_detections(raw, conf_thres=0.25, iou_thres=0.45, max_det=300,
                                          max_nms=512, backend="matrix")

    for c in counters:
        c.launches = 0
    d, v = step(scales)
    out["launches"] = {c.__name__: c.launches for c in counters}
    check(d.shape == (batch, 300, 6) and bool(torch.isfinite(d).all()),
          f"bad int8 serving output ({name})")
    with torch.inference_mode():  # the int8 raw head beside the bf16 one
        x1 = xb[:INT8_CAL_IMAGES].to(bf16) / 255.0
        r8 = model.apply(x1, bf16, fused=True, quant=scales)
        rf = model.apply(x1, bf16, fused=True)
    out["int8_vs_bf16_head"] = max(float((a.float() - b.float()).abs().max()) for a, b in
                                   zip(r8, rf)) / max(float(b.float().abs().max()) for b in rf)
    if head_check:
        out["head"] = int8_head_vs_cpu(model, scales, device)
    if device.type == "cuda":
        steps = {"bf16": lambda: step(None), "int8": lambda: step(scales)}
        windows = {k: [] for k in steps}
        for k in ("bf16", "int8", "int8", "bf16"):
            windows[k].append({"ms": cuda_ms(steps[k], 5, warmup=2), "card": card_state()})
        for k, ws in windows.items():
            ms = sum(w["ms"] for w in ws) / len(ws)
            out[k] = {"ms": ms, "img_per_s": batch / ms * 1e3, "windows": ws}
        for k, st in steps.items():
            out[k]["profile"] = profile_step(st)
    del model, xb
    return out


def int8_head_vs_cpu(model, scales, device, seed=9):
    """The f32 int8 raw head of `model` on the card (K4, the quantize
    kernel) against the host CPU's (their plain versions) on one
    `INT8_HEAD_IMGSZ` image: the share of values off by more than
    `close` of the head's spread, and the largest difference, within
    `INT8_HEAD_TOL` (a float conv that differs in its last bits may move
    an activation across a quantize rounding boundary).  The card's f32
    float head, held to the CPU's int8 head the same way, must fall
    outside it: the bound tells an int8 head from a float one."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(1, INT8_HEAD_IMGSZ, INT8_HEAD_IMGSZ, 3,
                   generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        got = [r.float().cpu() for r in model.apply(x.to(device), fused=True, quant=scales)]
        got_float = [r.float().cpu() for r in model.apply(x.to(device), fused=True)]
        model.to("cpu")
        want = [r.float() for r in model.apply(x, fused=True, quant=scales)]
        model.to(device)
    spread = max(float(w.abs().max()) for w in want)
    tol = INT8_HEAD_TOL

    def off(heads):
        err = torch.cat([((g - w).abs() / spread).flatten() for g, w in zip(heads, want)])
        share, worst = float((err > tol["close"]).float().mean()), float(err.max())
        return share, worst, share <= tol["share"] and worst <= tol["worst"]

    (share, worst, ok), (fshare, fworst, fok) = off(got), off(got_float)
    out = {"imgsz": INT8_HEAD_IMGSZ, "share_off": share, "max_err": worst, "tol": tol,
           "float_head_share_off": fshare, "float_head_max_err": fworst}
    check(ok, f"the f32 int8 raw head on the card differs from the CPU's: {out}")
    check(not fok, f"INT8_HEAD_TOL passes the card's float head too: {out}")
    return out


def int8_tiny(device, counters, sizes=INT8_TINY):
    """The tiny model trained as tests/test_int8_serve.py trains it (48 + 24
    synthetic images at 256 px, f32), but for `sizes["epochs"]` (28, where
    the test takes 32), then its EMA folded and
    calibrated on 16 train images: `run_validation` float and int8 at f32
    and at bf16 (|int8 - float| mAP@.5 within `INT8_MAP_TOL`, float above
    `INT8_MAP_FLOOR`; the int8 runs counted), and `cli.val --int8 --ncalib
    8` on its checkpoint, its calibration line kept."""
    import copy
    import io
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.cli import val as cli_val
    from dmayolo_tpu_torch.data.datasets import _scan_images, check_dataset
    from dmayolo_tpu_torch.data.imageio import imread
    from dmayolo_tpu_torch.data.letterbox import letterbox_host
    from dmayolo_tpu_torch.data.synthetic import generate
    from dmayolo_tpu_torch.eval.validator import run_validation
    from dmayolo_tpu_torch.nn.quant import calibrate_act_scales
    from dmayolo_tpu_torch.train.trainer import Trainer
    from dmayolo_tpu_torch.utils.checkpoint import save_checkpoint
    from dmayolo_tpu_torch.utils.weights import jax_from_state_dict

    shutil.rmtree(INT8_DIR, ignore_errors=True)
    sz = sizes["img_size"]
    t0 = time.perf_counter()
    data = generate(INT8_DIR / "shapes", n_train=sizes["n_train"], n_val=sizes["n_val"],
                    img_size=sz, seed=2)
    tr = Trainer(TINY_CFG, data=str(data), hyp=TINY_HYP, epochs=sizes["epochs"],
                 batch_size=sizes["batch"], img_size=sz, out_dir=str(INT8_DIR / "exp"),
                 dtype=torch.float32, workers=2, max_targets=32, val_interval=100, seed=0,
                 accumulate=1, device=device)
    # tests/test_int8_serve.py's warmup_min_iters=60 (the Trainer keeps 1000)
    tr.sched.nw = max(round(TINY_HYP["warmup_epochs"] * tr.sched.spe), sizes["warmup_min_iters"])
    with contextlib.redirect_stdout(io.StringIO()):
        tr.train(log_every=1000)
    out = {"train_s": time.perf_counter() - t0}
    model = copy.deepcopy(tr.state.ema).fuse()
    d = check_dataset(str(data))
    imgs = [letterbox_host(imread(f), sz, auto=False)[0][..., ::-1]
            for f in _scan_images(d["train"])[:16]]
    scales = calibrate_act_scales(model, [np.stack(imgs)])
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kw = dict(img_size=sz, batch_size=8, nc=3, dtype=dt, fused=True, max_targets=64,
                  device=device)
        r_float = run_validation(model, d["val"], **kw)
        for c in counters:
            c.launches = 0
        r_int8 = run_validation(model, d["val"], quant=scales, **kw)
        out[name] = {"float_map50": r_float.map50, "int8_map50": r_int8.map50,
                     "launches": {c.__name__: c.launches for c in counters}}
        check(r_float.map50 > INT8_MAP_FLOOR,
              f"the tiny model is undertrained at {name}: {r_float.summary()}")
        check(abs(r_float.map50 - r_int8.map50) < INT8_MAP_TOL,
              f"int8 mAP@.5 moved by more than {INT8_MAP_TOL} at {name}: "
              f"{r_float.map50} -> {r_int8.map50}")
    params, stats = jax_from_state_dict(tr.state.ema)
    save_checkpoint(INT8_DIR / "trained", params=params, stats=stats, meta={})
    (INT8_DIR / "tiny.yaml").write_text(json.dumps(TINY_CFG))  # JSON is YAML
    printed = io.StringIO()
    for c in counters:
        c.launches = 0
    with contextlib.redirect_stdout(printed):
        res = cli_val.main(["--weights", str(INT8_DIR / "trained.npz"), "--cfg",
                            str(INT8_DIR / "tiny.yaml"), "--data", str(data), "--img", str(sz),
                            "--batch-size", "8", "--fp32", "--int8", "--ncalib",
                            str(sizes["ncalib"]), "--project", str(INT8_DIR / "val"), "--name",
                            "exp", "--exist-ok", *([] if device.type == "cuda" else
                                                   ["--device", "cpu"])])
    lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("int8 calibration:")]
    out["cli_val"] = {"calibration": lines, "map50": res.map50,
                      "launches": {c.__name__: c.launches for c in counters}}
    check(lines == [f"int8 calibration: {sizes['ncalib']} images, int8 convs: 23/24"],
          f"cli.val --int8 printed {lines}")
    check(abs(res.map50 - out["f32"]["float_map50"]) < INT8_MAP_TOL,
          f"cli.val --int8 mAP@.5 {res.map50} against float {out['f32']['float_map50']}")
    out["s"] = time.perf_counter() - t0
    return out


def int8_general(device, cfg, name, counters, batch=8, imgsz=640, nc=10):
    """Route (d) on a main path: a model with such convs (5x5) served int8
    once, bf16 at `batch` on "matrix", calibrated on two random images,
    counted."""
    import numpy as np
    import torch

    from dmayolo_tpu_torch.nn.quant import calibrate_act_scales

    t0 = time.perf_counter()
    model = build_model(device, imgsz, cfg=cfg, nc=nc).fuse()
    rng = np.random.default_rng(8)
    scales = calibrate_act_scales(model, [rng.integers(0, 256, (2, imgsz, imgsz, 3),
                                                        dtype=np.uint8)], dtype=torch.float32)
    xb = torch.from_numpy(rng.integers(0, 256, (batch, imgsz, imgsz, 3),
                                       dtype=np.uint8)).to(device)
    for c in counters:
        c.launches = 0
    with torch.inference_mode():
        raw = model.apply(xb.to(torch.bfloat16) / 255.0, torch.bfloat16, fused=True, quant=scales)
        d, _ = model.serve_detections(raw, conf_thres=0.25, iou_thres=0.45, max_det=300,
                                      max_nms=512, backend="matrix")
    out = {"model": name, "batch": batch, "int8_convs": len(scales),
           "launches": {c.__name__: c.launches for c in counters}}
    check(d.shape == (batch, 300, 6) and bool(torch.isfinite(d).all()),
          f"bad int8 serving output ({name})")
    del model, xb
    out["s"] = time.perf_counter() - t0
    return out


def int8_expected_launches(sites, batch):
    """{counter name: launches} that one int8 forward over `sites` makes:
    each conv on its route, and the separate quantize where the route does
    not quantize inside the conv."""
    from dmayolo_tpu_torch.nn.conv_int8 import ROUTES

    want = {f"conv_int8_{r}": 0 for r in ROUTES}
    want["quantize_s8"] = 0
    for key, n in sites.items():
        route, convert = int8_route(batch, *key)
        want[f"conv_int8_{route}"] += n
        want["quantize_s8"] += 0 if convert else n
    return want


def int8_phase(device, counters, smi, cfgs=None, sizes=INT8):
    """K4's routes and its quantize against their plain versions at every
    eligible shape of the flagship, yolov5s and C3CASPD2 at bs8 640 px, at
    the route-(d) shapes of `INT8_GENERAL_MODEL` and off the models, the
    flagship's and the route-(d) shapes timed beside the plain versions;
    K4 timed at the served models' bs128 step shapes; int8 serving of the
    flagship and yolov5s at bs128 beside bf16,
    and of `INT8_GENERAL_MODEL` once; the trained tiny model's int8 mAP at
    f32 and bf16 and `cli.val --int8`.  `cfgs` and `sizes` replace the
    yamls and the sizes for a rehearsal on the CPU (untimed there)."""
    import shutil

    import torch

    from dmayolo_tpu_torch.graph import model_config

    t0 = time.perf_counter()
    names = (*INT8_CHECKED, INT8_GENERAL_MODEL)
    cfgs = cfgs or {name: model_config(name) for name in names}
    on_card = device.type == "cuda"
    out = {"sites": {}}
    sites = {name: int8_sites(cfgs[name], sizes["imgsz"]) for name in names}
    for name, s in sites.items():
        out["sites"][name] = {"convs": sum(s.values()), "shapes": len(s)}
    union = {}
    for name in INT8_CHECKED[1:]:
        for key, n in sites[name].items():
            if key not in sites[FLAGSHIP]:
                union[key] = union.get(key, 0) + n
    general = {key: n for key, n in sites[INT8_GENERAL_MODEL].items()
               if int8_route(sizes["check_batch"], *key)[0] == "general"}
    out["check_flagship"] = check_int8_shapes(device, sites[FLAGSHIP], sizes["check_batch"],
                                              timed=True)
    out["check_others"] = check_int8_shapes(device, union, sizes["check_batch"], seed=1)
    out["check_general"] = check_int8_shapes(device, general, sizes["check_batch"], timed=True,
                                             seed=2)
    off = [check_int8_case(device, torch.randn(b, h, w, c1, generator=torch.Generator()
                                               .manual_seed(i)).to(device) * 3,
                           torch.randn(c2, c1, k, k, generator=torch.Generator().manual_seed(i))
                           * (k * k * c1) ** -0.5, torch.randn(c2), 3.0 * 3 / 127, s, p, d)
           for i, (b, h, w, c1, c2, k, s, p, d) in enumerate(INT8_OFF_MODEL)]
    x, w, bias, s_x = tie_case(device)
    tie = check_int8_case(device, x, w, bias, s_x, 1, 0, 1)
    check(tie["sums_over_2_24"] >= 16 * 8, f"the tie case's sums are not above 2^24: {tie}")
    out["off_model"] = off + [tie]
    checked = [*out["check_flagship"]["shapes"], *out["check_others"]["shapes"],
               *out["check_general"]["shapes"], *out["off_model"]]
    out["checked_shapes"] = len(checked)
    out["checked_by_route"] = {}
    for r in checked:
        out["checked_by_route"][r["route"]] = out["checked_by_route"].get(r["route"], 0) + 1
    for key in ("max_abs_err", "quantize_max_abs_err"):  # over every checked shape
        out[key] = max(r[key] for r in checked)
    out["max_abs_err_by_route"] = {}
    for r in checked:
        e = out["max_abs_err_by_route"]
        e[r["route"]] = max(e.get(r["route"], 0.0), r["max_abs_err"])
    print(f"K4: x_q, the s32 sums and the f32/bf16 outputs of both entries equal to the plain "
          f"versions at {out['checked_shapes']} shapes ("
          f"{', '.join(f'{n} {v}' for n, v in out['sites'].items())}; by route "
          f"{out['checked_by_route']}; off-model {len(out['off_model'])}, one with sums above "
          f"2^24)", flush=True)
    if on_card:
        for name in ("check_flagship", "check_general"):
            for route, g in out[name]["routes"].items():
                print(f"K4 route {route} at bs{sizes['check_batch']} ({g['shapes']} shapes, each "
                      f"once): call {g['ms']:.3f} ms, kernels alone {g['kernel_ms']:.3f} ms, "
                      f"plain {g['plain_ms']:.2f} ms, bound {g['bound_ms']:.3f} ms "
                      f"({g['bound_by']}), {g['share_of_bound']:.3f} of it; on {smi}", flush=True)
    part_s = out["part_s"] = {"checks": time.perf_counter() - t0}
    out["step"] = ({name: time_int8_step(device, sites[name], sizes["step_batch"])
                    for name in INT8_SERVED} if on_card else {})
    for name, st in out["step"].items():
        print(f"K4 over {name}'s {st['convs']} int8 convs at bs{st['batch']} 640px "
              f"({len(st['shapes'])} shapes, count-weighted): call {st['step_ms']:.3f} ms, "
              f"kernels alone {st['step_kernel_ms']:.3f} ms, bound {st['step_bound_ms']:.3f} ms "
              f"(the sum of each conv's), {st['step_share_of_bound']:.3f} of it; cuDNN bf16 "
              f"{st['step_cudnn_bf16_ms']:.3f} ms; the {st['step_1x1_convs']} 1x1 convs _int_mm "
              f"takes: K4 {st['step_1x1_kernel_ms']:.3f} ms, its s8 form "
              f"{st['step_1x1_s8_kernel_ms']:.3f} ms, _int_mm {st['step_1x1_int_mm_ms']:.3f} ms + "
              f"quantize {st['step_1x1_quantize_ms']:.3f} ms; on {smi}", flush=True)
        for route, g in st["routes"].items():
            print(f"  route {route}: {g['convs']} convs ({g['shapes']} shapes), kernels "
                  f"{g['kernel_ms']:.3f} ms, bound {g['bound_ms']:.3f} ms ({g['bound_by']}), "
                  f"{g['share_of_bound']:.3f} of it", flush=True)
    part_s["bs128 steps"] = time.perf_counter() - t0 - sum(part_s.values())
    out["serving"] = {name: int8_serving(device, cfgs[name], name, counters, sizes["serve_batch"],
                                         sizes["imgsz"], head_check=name == FLAGSHIP)
                      for name in INT8_SERVED}
    part_s["serving"] = time.perf_counter() - t0 - sum(part_s.values())
    out["general"] = int8_general(device, cfgs[INT8_GENERAL_MODEL], INT8_GENERAL_MODEL,
                                  counters, sizes["check_batch"], sizes["imgsz"])
    for name, sv in (*out["serving"].items(), (INT8_GENERAL_MODEL, out["general"])):
        want = int8_expected_launches(sites[name], sizes["check_batch"])
        got = {k: sv["launches"][k] for k in want}
        check(not on_card or (got == want and sum(v for k, v in got.items() if k != "quantize_s8")
                              == sv["int8_convs"] and sv["launches"]["fixpoint_keep"] == 1),
              f"the int8 serving step of {name} did not launch each K4 route once a conv: "
              f"{sv['launches']} for {sv['int8_convs']} convs, want {want}")
        if "int8" in sv:
            pi, pb = sv["int8"]["profile"], sv["bf16"]["profile"]
            conv, quant = (pi["groups_ms"].get(g, 0.0) for g in ("int8 conv (K4)",
                                                                 "int8 quantize (K4)"))
            print(f"int8 serving {name} bs128 640px bf16 'matrix': {sv['int8']['img_per_s']:.1f} "
                  f"img/s ({sv['int8']['ms']:.2f} ms/batch) against bf16 "
                  f"{sv['bf16']['img_per_s']:.1f} img/s ({sv['bf16']['ms']:.2f} ms/batch); "
                  f"{sv['coverage']}; int8 step device ms: int8 conv {conv:.2f}, quantize "
                  f"{quant:.2f}, other {pi['device_ms'] - conv - quant:.2f} (busy "
                  f"{pi['device_busy_share']:.3f}); bf16 step: convs "
                  f"{pb['groups_ms'].get('conv and matmul (cuDNN, cuBLAS)', 0.0):.2f} of "
                  f"{pb['device_ms']:.2f} (busy {pb['device_busy_share']:.3f}); launches "
                  f"{got}; on {smi}", flush=True)
        if "head" in sv:
            hd = sv["head"]
            print(f"int8 raw head of {name} at f32 {hd['imgsz']} px, card vs CPU: "
                  f"{hd['share_off']:.4f} of values off by more than {hd['tol']['close']:g} of "
                  f"the spread, max {hd['max_err']:.2e} (tol {hd['tol']}); the card's float "
                  f"head: {hd['float_head_share_off']:.4f}, max {hd['float_head_max_err']:.2e}",
                  flush=True)
    print(f"int8 serving {INT8_GENERAL_MODEL} bs{out['general']['batch']}: launches {got} "
          f"({out['general']['s']:.1f} s)", flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    part_s[INT8_GENERAL_MODEL] = time.perf_counter() - t0 - sum(part_s.values())
    out["tiny"] = tiny = int8_tiny(device, counters, sizes["tiny"])
    part_s["tiny model"] = time.perf_counter() - t0 - sum(part_s.values())
    k4 = [c.__name__ for c in counters if c.__name__.startswith("conv_int8_")]
    for name in ("f32", "bf16"):
        check(not on_card or sum(tiny[name]["launches"][k] for k in k4) > 0,
              f"int8 eval at {name} did not launch K4: {tiny[name]['launches']}")
    check(not on_card or tiny["f32"]["launches"]["quantize_s8"] > 0,
          f"int8 eval at f32 did not launch the quantize: {tiny['f32']['launches']}")
    check(not on_card or sum(tiny["cli_val"]["launches"][k] for k in k4) > 0,
          "cli.val --int8 did not launch K4")
    print(f"int8 tiny model: mAP@.5 float / int8 at f32 {tiny['f32']['float_map50']:.4f} / "
          f"{tiny['f32']['int8_map50']:.4f}, at bf16 {tiny['bf16']['float_map50']:.4f} / "
          f"{tiny['bf16']['int8_map50']:.4f}; cli.val --int8: {tiny['cli_val']['calibration'][0]}, "
          f"mAP@.5 {tiny['cli_val']['map50']:.4f}; trained in {tiny['train_s']:.1f} s", flush=True)
    shutil.rmtree(INT8_DIR, ignore_errors=True)
    out["s"] = time.perf_counter() - t0
    print(f"int8 phase: {out['s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()) + ")", flush=True)
    return out


INT8_DESIGN = {
    "1x1": "route (a): GEMM on wgmma m64nBNk32 s8, TMA loads, the bf16 input quantized in the "
           "kernel, persistent, warp-specialised",
    "3x3s1": "route (b): K1's haloed tile on wgmma s8 (nine row-shifted views), quantized once "
             "a tile in the kernel",
    "3x3s2": "route (c): four TMA loads a chunk with element strides 2, one an input phase, "
             "its taps row-shifted views, wgmma s8, quantized once a load in the kernel",
    "general": "route (d): implicit GEMM on mma.sync m16n8k32 s8, cp.async 4 stages, on "
               "quantize_s8's output",
}


def int8_kernel_entries(i8, launches):
    """The kernels line's K4 entries, one a route, and the quantize's.
    Each entry's times, bound and plain time are over one set of shapes:
    the route's bs8 shapes, each once, of the flagship (routes (a)-(c)) or
    of `INT8_GENERAL_MODEL` (route (d), which it serves at bs8);
    `library_ms` is `_int_mm` on the shapes it takes (route (a)).  Beside
    them, under "steps", each route's sums over the served models' bs128
    steps, count-weighted.  The quantize's entry: over the route-(d)
    shapes' bf16 inputs, the ones that take it on the bf16 path."""
    from dmayolo_tpu_torch.nn.conv_int8 import ROUTE_COUNTS, quantize_s8

    entries = []
    for route, counter in ROUTE_COUNTS.items():
        general = route == "general"
        check_set = i8["check_general"] if general else i8["check_flagship"]
        c = check_set["routes"][route]
        entry = {
            "name": counter.__name__, "route": "cuda", "design": INT8_DESIGN[route],
            "source": "dmayolo_tpu_torch/csrc/conv_int8.cu",
            "replaces": "dmayolo_tpu/nn/primitives.py:134 (an XLA int8 conv; no TPU kernel)",
            **launches(counter), "max_abs_err": i8["max_abs_err_by_route"][route],
            **{k: c[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                 "share_of_bound")},
            "library_ms": c.get("int_mm_ms"),
            "shapes": f"{INT8_GENERAL_MODEL if general else FLAGSHIP} eligible, "
                      f"bs{check_set['batch']}, {c['shapes']} shapes each once",
            "checked_shapes": i8["checked_by_route"][route]}
        if c.get("int_mm_ms") is not None:
            entry.update(library="torch._int_mm on the same s8 product, on the shapes it takes "
                                 "(1x1, C2 % 8 == 0)", library_shapes=c["int_mm_convs"],
                         kernel_ms_on_library_shapes=c["kernel_ms_on_int_mm_convs"])
        entry["steps"] = {f"{name}_bs{st['batch']}": {k: v for k, v in st["routes"][route].items()
                                                      if k != "bytes_bound_ms"}
                          for name, st in i8["step"].items() if route in st["routes"]}
        entries.append(entry)
    q = i8["check_general"]["routes"]["general"]
    entries.append({
        "name": "quantize_s8", "route": "cuda", "design": "one thread 8 channels",
        "source": "dmayolo_tpu_torch/csrc/conv_int8.cu",
        "replaces": "dmayolo_tpu/nn/primitives.py:149 (x_q, an XLA op; no TPU kernel)",
        **launches(quantize_s8), "max_abs_err": i8["quantize_max_abs_err"],
        "ms": q["quantize_ms"], "kernel_ms": q["quantize_kernel_ms"],
        "plain_ms": q["quantize_plain_ms"], "bound_ms": q["quantize_bound_ms"],
        "bound_by": "bytes", "share_of_bound": q["quantize_bound_ms"] / q["quantize_kernel_ms"],
        "library_ms": None,
        "shapes": f"{INT8_GENERAL_MODEL}'s route-(d) conv inputs, bf16, "
                  f"bs{i8['check_general']['batch']}, {q['shapes']} shapes each once (f32 inputs "
                  f"take it on every route)"})
    return entries


# One round of `int8_compare`, run in a fresh process from the root of a
# checkout (this one or another commit's), with that checkout's own
# `time_int8_step` and `int8_serving`: K4 timed at the served models'
# bs128 step shapes, then int8 serving beside bf16.  Each tree reports the
# step sums it times (`step_*`): `step_kernel_ms` is what the served call
# launches, its separate quantize included where the design has one and
# times it under `step_quantize_ms`.
INT8_COMPARE_ROUND = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from dmayolo_tpu_torch.graph import model_config
dev = torch.device("cuda", 0)
out = {}
for name in cs.INT8_SERVED:
    st = cs.time_int8_step(dev, cs.int8_sites(model_config(name)), 128)
    row = {k: v for k, v in st.items() if k.startswith("step_") or k == "routes"}
    sv = cs.int8_serving(dev, model_config(name), name, (), 128, 640)
    row["serving"] = {k: {"img_per_s": sv[k]["img_per_s"], "ms": sv[k]["ms"],
                          "device_ms": sv[k]["profile"]["device_ms"],
                          "groups_ms": sv[k]["profile"]["groups_ms"]} for k in ("bf16", "int8")}
    out[name] = row
print(json.dumps(out))
"""


def int8_compare(other, order=("other", "change", "change", "other")):
    """K4's bs128 step timing and int8 serving of another checkout
    (`other`, e.g. the parent commit from `git archive`) and of this one,
    in turns, each round in its own process (each builds its own kernels
    under its own build/).  Returns {"rounds": [...]}, each round the
    tree, the card's state and the round's numbers."""
    trees = {"other": Path(other).resolve(), "change": ROOT}
    rounds = []
    for which in order:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", INT8_COMPARE_ROUND, str(trees[which])],
                              cwd=trees[which], capture_output=True, text=True)
        check(proc.returncode == 0, f"int8 compare round on {which} failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rounds.append({"tree": which, "s": time.perf_counter() - t0, "card": card_state(),
                       **res})
        for name, r in res.items():
            steps = ", ".join(f"{k[5:]} {v:.3f}" for k, v in r.items()
                              if k.startswith("step_") and k.endswith("_ms"))
            print(f"int8 compare {which} {name} bs128 step ms: {steps}; serving int8 "
                  f"{r['serving']['int8']['img_per_s']:.1f} img/s, bf16 "
                  f"{r['serving']['bf16']['img_per_s']:.1f}", flush=True)
    return {"rounds": rounds}


# ---------------------------------------------------------------------------
# data parallelism (parallel/mesh.py)
# ---------------------------------------------------------------------------

DIST = dict(check_imgsz=640, check_batch=2, recipe_steps=2, recipe_warmup=1, val_images=48,
            val_imgsz=640, val_batch=16, torchrun_imgsz=256, torchrun_batch=2,
            torchrun_train=4, torchrun_val=2, workers=4, evolve_generations=2,
            evolve_imgsz=640, evolve_batch=4, evolve_images=8)
DIST_DIR = ROOT / "build" / "dist_smoke"
DIST_EVAL_TOL = 1e-3  # P, R and mAP of world 2 against world 1
DIST_SEED = 7
STEP_NOISE_REL = 1e-7  # the weights' relative move that measures a step's conditioning


def dist_step_check(device, cfg, nc, sizes, seed, mesh, spatial=False, reference=True):
    """The flagship's f32 step (TF32 off) at `check_batch` x `check_imgsz`
    through `mesh`'s data-parallel step (with `spatial`, the H-sharded
    one) against the plain step on the same card: the errors of the loss
    and items, every gradient, every updated parameter and the BN
    buffers, and whether they hold `TRAIN_F32_TOL` (the buffers the
    parameters' tolerance).  With `spatial` also the step's own
    conditioning, read beside the errors and not used in the check: how
    far the plain step's grads and parameters move when its weights move
    by `STEP_NOISE_REL` (the H-sharded step reorders every conv's and BN's
    reductions, and the step amplifies such rounding most in the first
    layers' grads).  Without
    `reference`, only this rank's share of the step runs (another rank of
    the group holds it against the plain one), and None is returned."""
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = DetectionModel(cfg, nc=nc, device="cpu").init_with_priors(
        torch.Generator().manual_seed(seed)).state_dict()
    small = train_batches(1, sizes["check_batch"], sizes["check_imgsz"], nc,
                          RECIPE["max_targets"], seed)[0]
    if not reference:
        one_train_step(device, cfg, sd, small, torch.float32, nc=nc, mesh=mesh, spatial=spatial)
        return None
    want = one_train_step(device, cfg, sd, small, torch.float32, nc=nc, with_buffers=True)
    got = one_train_step(device, cfg, sd, small, torch.float32, nc=nc, mesh=mesh,
                         with_buffers=True, spatial=spatial)
    errs = {"loss_rel_err": max(abs(got[0][k] - want[0][k]) / abs(want[0][k]) for k in want[0]),
            "grad_scaled_err": scaled_err(got[1], want[1]),
            "param_scaled_err": scaled_err(got[2], want[2]),
            "buffer_scaled_err": scaled_err(got[4], want[4]),
            "metrics": got[0], "metrics_plain": want[0], "rows": small.images.shape[0]
            // mesh.n_data}
    tol = dict(TRAIN_F32_TOL)
    if spatial:
        g = torch.Generator().manual_seed(seed + 1)
        moved = {k: v * (1 + STEP_NOISE_REL * torch.randn(v.shape, generator=g))
                 if v.is_floating_point() else v for k, v in sd.items()}
        ref = one_train_step(device, cfg, moved, small, torch.float32, nc=nc)
        errs["grad_noise"] = scaled_err(ref[1], want[1])
        errs["param_noise"] = scaled_err(ref[2], want[2])
    errs["tol"] = tol
    errs["ok"] = (errs["loss_rel_err"] <= tol["loss"]
                  and errs["grad_scaled_err"] <= tol["grad"]
                  and max(errs["param_scaled_err"], errs["buffer_scaled_err"]) <= tol["param"])
    return errs


def dist_eval(device, model, val_list, sizes, nc, out_dir, mesh=None):
    """`run_validation` on "matrix" (bf16, the protocol) of `model` over
    `val_list` at `mesh`'s world (global batch `val_batch` times the world
    size, so that every forward holds `val_batch` images, the same at
    every world); the txt rows to `out_dir` (rank 0), the metrics and the
    K3 launches this process made."""
    from dmayolo_tpu_torch.core.fixpoint_kernel import fixpoint_keep, fixpoint_keep_blocked
    from dmayolo_tpu_torch.eval.validator import run_validation

    counters = (fixpoint_keep, fixpoint_keep_blocked)
    world = 1 if mesh is None else mesh.world
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = run_validation(model, str(val_list), img_size=sizes["val_imgsz"],
                         batch_size=sizes["val_batch"] * world, nc=nc, nms_backend="matrix",
                         save_txt_dir=out_dir, save_conf=True, workers=sizes["workers"],
                         device=device, mesh=mesh, **PROTOCOL)
    return {"launches": {c.__name__: c.launches for c in counters},
            "s": time.perf_counter() - t0, "nt": res.nt,
            **{k: getattr(res, k) for k in ("mp", "mr", "map50", "map75", "map")}}


def evolve_data(data_dir, device, sizes, nc):
    """DIST_DIR/evolve for `evolve_run`: the first `evolve_images` train
    files with their labels, as many val files labelled with the tiny
    model's own top-20 detections (so that a generation's fitness is not
    0), that model's weights as `start.npz` and a data yaml."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from dmayolo_tpu_torch.data.imageio import imread
    from dmayolo_tpu_torch.data.letterbox import letterbox_host
    from dmayolo_tpu_torch.utils.checkpoint import save_checkpoint
    from dmayolo_tpu_torch.utils.weights import jax_from_state_dict

    root = DIST_DIR / "evolve"
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for f in sorted((data_dir / "images" / split).iterdir())[:sizes["evolve_images"]]:
            (root / "images" / split / f.name).symlink_to(f)
            lb = root / "labels" / split / f"{f.stem}.txt"
            if split == "train":
                shutil.copy(data_dir / "labels" / split / lb.name, lb)
            else:
                lb.write_text("")
    tiny = build_model(device, imgsz=sizes["evolve_imgsz"], cfg=TINY_CFG, nc=nc)
    # BN calibrated on the train images: a step's batch statistics then
    # move the running ones little, and the labels below stay its own
    train = sorted((root / "images" / "train").iterdir())
    calibrate_bn(tiny, torch.as_tensor(np.stack([
        letterbox_host(imread(f), sizes["evolve_imgsz"], auto=False)[0][:, :, ::-1]
        for f in train]).astype(np.float32) / 255.0, device=device))
    own_labels(tiny, str(root / "images" / "val"), sizes["evolve_imgsz"],
               sizes["evolve_images"], torch.float32, 2)
    save_checkpoint(root / "start.npz", meta={"nc": nc},
                    **dict(zip(("params", "stats"), jax_from_state_dict(tiny))))
    (root / "data.yaml").write_text(yaml.safe_dump(
        {"path": str(root), "train": str(root / "images" / "train"),
         "val": str(root / "images" / "val"), "nc": nc, "names": [f"c{i}" for i in range(nc)]}))
    return root


def evolve_run(mesh, root, sizes, nc, seed):
    """`evolve` (train/evolve.py) on `mesh` for `evolve_generations`
    generations, each an f32 `Trainer` of the tiny model from `start.npz`
    over root's data (one epoch, `evolve_batch` images a step, validated
    on root's val files).  The global `random`, which the GA's parent
    choice draws from, is seeded by rank: only rank 0's may count.
    Returns this rank's trained hyps, their fitness and the best hyp."""
    import random

    import torch

    from dmayolo_tpu_torch.train.evolve import evolve
    from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    random.seed(seed + 1000 * mesh.rank)
    out = {"hyps": [], "fitness": []}
    name = f"w{mesh.world}"
    t0 = time.perf_counter()

    def train_fn(h):
        out["hyps"].append(dict(h))
        tr = Trainer(TINY_CFG, data=str(root / "data.yaml"), hyp=h, nc=nc, epochs=1,
                     batch_size=sizes["evolve_batch"], img_size=sizes["evolve_imgsz"],
                     out_dir=str(root / name / "run"), dtype=torch.float32, seed=seed,
                     device=mesh.device, mesh=mesh, pretrained=str(root / "start.npz"),
                     autoanchor=False, nosave=True, workers=2)
        out["fitness"].append(tr.train())
        return out["fitness"][-1]

    # lr0 at META's floor and no warmup bias lr: each generation stays near
    # start.npz, so the val split's own labels give a fitness above 0
    base = {**load_hyp("scratch"), "lr0": 1e-5, "warmup_bias_lr": 0.0}
    out["best"] = evolve(train_fn, base, generations=sizes["evolve_generations"],
                         out_dir=str(root / name), seed=0, autoanchor=False, mesh=mesh)
    out["s"] = time.perf_counter() - t0
    return out


def dist_rank(mesh, cfg, nc, sizes, seed, model_path, val_list, out_dir, evolve_root):
    """One rank of world 2 (gloo, both ranks on cuda:0): the f32 step
    against the plain one, the recipe's step timed on the card (its
    global batch of 4, two images a rank), the data-parallel eval, then
    `evolve` in the group."""
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp

    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend}
    t0 = time.perf_counter()
    out["step"] = dist_step_check(mesh.device, cfg, nc, sizes, seed, mesh)
    out["step_s"] = time.perf_counter() - t0
    if mesh.device.type == "cuda":
        batches = train_batches(1, RECIPE["batch"], RECIPE["imgsz"], nc, RECIPE["max_targets"],
                                seed)
        tr = Trainer(cfg, batches, load_hyp(RECIPE["hyp"]), nc=nc, epochs=1,
                     batch_size=RECIPE["batch"], img_size=RECIPE["imgsz"], adam=RECIPE["adam"],
                     out_dir=str(DIST_DIR / f"recipe_rank{mesh.rank}"), dtype=torch.bfloat16,
                     seed=seed, device=mesh.device, mesh=mesh)
        imgs, tg = tr.to_device(batches)
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        step = tr.get_step(1)
        out["recipe_ms"] = cuda_ms(lambda: step(tr.state, imgs, tg, gen), 2)
        del tr, imgs, tg
    model = DetectionModel(cfg, nc=nc, device=mesh.device)
    model.load_state_dict(torch.load(model_path, map_location=mesh.device))
    out["eval"] = dist_eval(mesh.device, model.eval(), val_list, sizes, nc, out_dir, mesh)
    del model
    out["evolve"] = evolve_run(mesh, Path(evolve_root), sizes, nc, seed)
    return out


def collectives_profile(step):
    """One step under torch.profiler: its device time, the NCCL kernels'
    device time and launches, the collectives the host issued, and the
    host's syncs with the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    cuda = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA
            and not annotation(e)]
    nccl = [e for e in cuda if "nccl" in e.key.lower()]
    cpu = [e for e in avg if e.device_type == torch.autograd.DeviceType.CPU]
    host = {e.key: e.count for e in cpu}
    return {"wall_ms": wall_ms, "device_ms": sum(e.self_device_time_total for e in cuda) / 1e3,
            "cuda_launches": sum(e.count for e in cuda),
            "host_top_ms": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count) for e in
                            sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]],
            "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
            "nccl_launches": sum(e.count for e in nccl),
            "nccl_kernels": sorted({e.key[:80] for e in nccl}),
            "all_reduce_calls": sum(n for k, n in host.items()
                                    if "all_reduce" in k.lower() or "allreduce" in k.lower()),
            "host_syncs": sum(host.get(k, 0) for k in ("cudaStreamSynchronize",
                                                        "cudaDeviceSynchronize",
                                                        "cudaEventSynchronize"))}


def dist_recipe_timing(device, mesh, cfg, nc, sizes, seed):
    """The flagship recipe (train.sh:5-9: 1536 px, bs4, Adam, bf16, no
    remat) through the `Trainer`'s step on `mesh` (world 1) and through the
    plain `Trainer`, from the same seed: ms a step (accumulate 1) by CUDA
    events in turns, plain, mesh, local, local, mesh, plain, where "local"
    is the mesh's step with each all-reduce taken as the identity it is
    at world 1 (the same arithmetic without the NCCL calls); then one step
    of plain and mesh profiled."""
    import shutil

    import torch

    from dmayolo_tpu_torch.parallel.mesh import Mesh
    from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp

    def identity(self, t):
        return t

    n = sizes["recipe_steps"] + sizes["recipe_warmup"]
    batches = train_batches(n, RECIPE["batch"], RECIPE["imgsz"], nc, RECIPE["max_targets"],
                            seed)
    out, trainers = {}, {}
    try:
        # the plain Trainer's mesh has no group, although this process is in one
        for name, m in (("plain", Mesh(device=device)), ("mesh", mesh)):
            tr = Trainer(cfg, batches, load_hyp(RECIPE["hyp"]), nc=nc, epochs=1,
                         batch_size=RECIPE["batch"], img_size=RECIPE["imgsz"],
                         adam=RECIPE["adam"], out_dir=str(DIST_DIR / f"recipe_{name}"),
                         dtype=torch.bfloat16, seed=seed, device=device, mesh=m)
            imgs, tg = tr.to_device(batches[:1])
            gen = torch.Generator(device=device).manual_seed(seed)
            step = tr.get_step(1)
            trainers[name] = (lambda step=step, tr=tr, imgs=imgs, tg=tg, gen=gen:
                              step(tr.state, imgs, tg, gen))
        ms = {"plain": [], "mesh": [], "local": []}
        real = Mesh.all_reduce
        for name in ("plain", "mesh", "local", "local", "mesh", "plain"):
            Mesh.all_reduce = identity if name == "local" else real
            try:
                ms[name].append(cuda_ms(trainers["plain" if name == "plain" else "mesh"],
                                        sizes["recipe_steps"], warmup=sizes["recipe_warmup"]))
            finally:
                Mesh.all_reduce = real
        out["ms"] = {k: sum(v) / len(v) for k, v in ms.items()}
        out["ms_rounds"] = ms
        out["profile"] = {name: collectives_profile(trainers[name]) for name in ("plain", "mesh")}
    finally:
        trainers.clear()
        for name in ("plain", "mesh"):
            shutil.rmtree(DIST_DIR / f"recipe_{name}", ignore_errors=True)
    return out


def torchrun_train(data_dir, sizes, nc, on_card=True):
    """Start `cli.train` for two optimizer steps under `python -m
    torch.distributed.run --standalone --nproc-per-node 1` (the reference's
    DDP launch) on the data phase's files: the tiny model, one epoch of
    `torchrun_train` images at `torchrun_batch`, validated on
    `torchrun_val`.  Returns `finish()`, which waits for it and checks it."""
    import os

    import yaml

    from dmayolo_tpu_torch.utils.checkpoint import load_checkpoint

    run = DIST_DIR / "torchrun"
    run.mkdir(parents=True, exist_ok=True)
    files = lambda split, k: "".join(  # noqa: E731
        f"{f}\n" for f in sorted((data_dir / "images" / split).iterdir())[:k])
    (run / "train.txt").write_text(files("train", sizes["torchrun_train"]))
    (run / "val.txt").write_text(files("val", sizes["torchrun_val"]))
    (run / "data.yaml").write_text(yaml.safe_dump(
        {"path": str(data_dir), "train": str(run / "train.txt"), "val": str(run / "val.txt"),
         "nc": nc, "names": [f"c{i}" for i in range(nc)]}))
    (run / "tiny.yaml").write_text(yaml.safe_dump(TINY_CFG))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "dmayolo_tpu_torch.cli.train", "--cfg", str(run / "tiny.yaml"),
           "--data", str(run / "data.yaml"), "--epochs", "1", "--batch-size",
           str(sizes["torchrun_batch"]), "--imgsz", str(sizes["torchrun_imgsz"]),
           "--accumulate", "1", "--no-accum-ramp", "--noautoanchor", "--workers", "2",
           "--project", str(run), "--name", "exp", "--exist-ok", "--sync-bn",
           *(() if on_card else ("--device", "cpu"))]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def finish():
        try:
            printed, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        out = {"rc": proc.returncode, "s": time.perf_counter() - t0,
               "tail": printed.strip().splitlines()[-6:]}
        check(proc.returncode == 0, f"cli.train under torchrun failed: {out}")
        _, meta = load_checkpoint(run / "exp" / "last.npz")  # stripped: no step count
        want = sizes["torchrun_train"] // sizes["torchrun_batch"]
        out.update(epoch=int(meta.get("epoch", -1)),
                   results_csv=(run / "exp" / "results.csv").exists(),
                   steps_logged=f"epoch 0 [{want}/{want}]" in printed, step=want)
        check(out["epoch"] == 0 and out["results_csv"] and out["steps_logged"],
              f"cli.train under torchrun did not take its {want} steps: {out}")
        return out

    finish.proc = proc
    return finish


def collective_call_us(mesh, n=235, width=513, thread=False):
    """Host microseconds a SUM all-reduce of a BN's width takes on
    `mesh`'s group, over `n` calls (a flagship step's count), and with the
    card drained after them; from a second thread with `thread` (BN's
    backward all-reduces run on the autograd engine's)."""
    import torch

    if thread:
        out = {}
        th = threading.Thread(target=lambda: out.update(collective_call_us(mesh, n, width)))
        th.start()
        th.join()
        return out
    t = torch.zeros(width, device=mesh.device)
    for _ in range(10):
        mesh.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        mesh.all_reduce(t)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"calls": n, "width": width, "host_us": host / n * 1e6,
            "drained_us": (time.perf_counter() - t0) / n * 1e6}


def dist_phase(device, smi, data_dir=DATA_DIR, cfg=None, sizes=DIST, nc=10):
    """Data parallelism (`parallel/mesh.py`) on the one card: the f32 step
    at world 1 over NCCL (in this process) and at world 2 over gloo (two
    ranks on cuda:0, one image each) against the plain step;
    `run_validation` on the data phase's val images at world 2 against
    world 1 (K3 counted in each rank); `cli.train` under torchrun, beside
    those (untimed); last, alone on the card, the recipe's ms a step at
    world 1 beside the plain `Trainer`, one step each profiled."""
    import shutil

    import numpy as np
    import torch

    from dmayolo_tpu_torch.graph import model_config
    from dmayolo_tpu_torch.parallel.mesh import close_group, init_group, spawn

    cfg = cfg or model_config(FLAGSHIP)
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out = {"sizes": dict(sizes)}
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    torchrun_done = None
    try:
        # ---- cli.train under torchrun (the tiny model), beside the checks
        torchrun_done = torchrun_train(data_dir, sizes, nc, on_card)
        # ---- world 1 over NCCL (gloo on the CPU), in this process
        mesh = init_group(0, 1, "nccl" if on_card else "gloo", device,
                          store_path=str(DIST_DIR / "store_w1"))
        try:
            t0 = time.perf_counter()
            out["world1_step"] = dist_step_check(device, cfg, nc, sizes, DIST_SEED, mesh)
            check(out["world1_step"]["ok"],
                  f"the world-1 step differs from the plain one: {out['world1_step']}")
            out["world1_s"] = time.perf_counter() - t0

            # ---- world 2 over gloo, both ranks on the card: the step, its
            # time, then eval
            t0 = time.perf_counter()
            model = build_model(device, cfg=cfg, nc=nc).eval()
            model_path = DIST_DIR / "model.pt"
            torch.save(model.state_dict(), model_path)
            val_list = DIST_DIR / "val.txt"
            val_list.write_text("".join(f"{f}\n" for f in sorted(
                (data_dir / "images" / "val").iterdir())[:sizes["val_images"]]))
            evolve_root = evolve_data(data_dir, device, sizes, nc)
            ranks = spawn(dist_rank, 2, args=(cfg, nc, sizes, DIST_SEED, str(model_path),
                                              str(val_list), str(DIST_DIR / "w2"),
                                              str(evolve_root)),
                          device=device.type, backend="gloo", share_device=on_card,
                          threads=None if on_card else torch.get_num_threads())
            out["world2_spawn_s"] = time.perf_counter() - t0
            out["world2"] = ranks
            for r in ranks:
                check(r["step"]["ok"], f"rank {r['rank']}'s world-2 step differs from the "
                                       f"plain one: {r['step']}")
            # world 1 on the same forwards (`val_batch` images each)
            out["world1_eval"] = w1 = dist_eval(device, model, val_list, sizes, nc,
                                                DIST_DIR / "w1")
            del model
            w2 = ranks[0]["eval"]
            a, b = label_lines(DIST_DIR / "w2"), label_lines(DIST_DIR / "w1")
            unmatched = [same_sets(rows_of(a.get(k, [])), rows_of(b[k]), 2e-3, 0.05,
                                   SAME_SET_BAND * PROTOCOL["conf_thres"]) for k in b]
            out["eval"] = {"files": [len(a), len(b)],
                           "detections": [sum(map(len, a.values())),
                                          sum(map(len, b.values()))],
                           "unmatched": max(unmatched, default=0),
                           "metric_err": max(abs(w2[k] - w1[k])
                                             for k in ("mp", "mr", "map50", "map"))}
            check(len(a) == len(b) == sizes["val_images"] and out["eval"]["unmatched"] == 0
                  and out["eval"]["metric_err"] <= DIST_EVAL_TOL
                  and all(r["eval"]["nt"] == w1["nt"] for r in ranks) and 0 < w1["map50"] < 1
                  and all(np.isfinite(w1[k]) for k in ("mp", "mr", "map")),
                  f"world-2 eval differs from world 1: {out['eval']}, {w1}, {w2}")
            if on_card:
                check(all(r["eval"]["launches"]["fixpoint_keep_blocked"] > 0 for r in ranks),
                      f"K3 did not launch in a world-2 rank: {[r['eval'] for r in ranks]}")
            # ---- evolve: world 1 in this process against the two ranks' GA
            out["evolve_world1"] = e1 = evolve_run(mesh, evolve_root, sizes, nc, DIST_SEED)
            e2 = [r["evolve"] for r in ranks]
            rows = (evolve_root / "w2" / "evolve.csv").read_text().splitlines()
            out["evolve"] = {
                "generations": sizes["evolve_generations"], "world1_s": e1["s"],
                "rank_s": [e["s"] for e in e2], "fitness_world1": e1["fitness"],
                "fitness_world2": e2[0]["fitness"], "csv_rows": len(rows) - 1,
                "fitness_err": max(abs(a - b) for a, b in zip(e2[0]["fitness"], e1["fitness"]))}
            check(all(e["hyps"] == e1["hyps"] and e["best"] == e2[0]["best"]
                      and e["fitness"] == e2[0]["fitness"] for e in e2)
                  and len(e1["hyps"]) == sizes["evolve_generations"]
                  and len(rows) == 1 + sizes["evolve_generations"]
                  and (evolve_root / "w2" / "hyp_evolve.yaml").exists()
                  and out["evolve"]["fitness_err"] <= DIST_EVAL_TOL
                  and min(e1["fitness"]) > 0,
                  f"evolve in the group differs from world 1: {out['evolve']}, hyps "
                  f"{[e['hyps'] for e in e2]} vs {e1['hyps']}")
            out["torchrun"] = torchrun_done()

            # ---- the recipe's step at world 1, timed with the card to itself
            if on_card:
                t0 = time.perf_counter()
                out["recipe"] = dist_recipe_timing(device, mesh, cfg, nc, sizes, DIST_SEED)
                out["collective_call"] = collective_call_us(mesh)
                out["collective_call_thread"] = collective_call_us(mesh, thread=True)
                out["recipe_s"] = time.perf_counter() - t0
        finally:
            close_group()
    finally:
        if torchrun_done is not None and torchrun_done.proc.poll() is None:
            torchrun_done.proc.kill()
            torchrun_done.proc.wait()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    out["s"] = time.perf_counter() - t_phase
    return out


def print_dist(dp, smi):
    w1, rec = dp["world1_step"], dp.get("recipe")
    for label, st in [("world 1, NCCL", w1)] + [
            (f"world 2, gloo, rank {r['rank']} on {r['device']}", r["step"]) for r in dp["world2"]]:
        print(f"dist f32 step ({label}, {st['rows']} image(s) a rank) vs the plain step: loss "
              f"{st['loss_rel_err']:.2e}, grads {st['grad_scaled_err']:.2e}, params "
              f"{st['param_scaled_err']:.2e}, BN buffers {st['buffer_scaled_err']:.2e} "
              f"(tol {TRAIN_F32_TOL}) on {smi}", flush=True)
    if rec:
        p = rec["profile"]
        print(f"dist recipe (1536 px bs4 Adam bf16, accumulate 1): world 1 over NCCL "
              f"{rec['ms']['mesh']:.2f} ms a step, its all-reduces as the identity "
              f"{rec['ms']['local']:.2f}, plain Trainer {rec['ms']['plain']:.2f} ms "
              f"(rounds {rec['ms_rounds']}); profiled: device {p['mesh']['device_ms']:.2f} ms "
              f"(plain {p['plain']['device_ms']:.2f}), NCCL kernels {p['mesh']['nccl_ms']:.3f} "
              f"ms over {p['mesh']['nccl_launches']} launches, wall {p['mesh']['wall_ms']:.2f} "
              f"ms (plain {p['plain']['wall_ms']:.2f}), kernels {p['mesh']['cuda_launches']} "
              f"(plain {p['plain']['cuda_launches']}), {p['mesh']['all_reduce_calls']} "
              f"all-reduce calls, host syncs {p['mesh']['host_syncs']} (plain "
              f"{p['plain']['host_syncs']}); one all-reduce of {dp['collective_call']['width']} "
              f"floats {dp['collective_call']['host_us']:.1f} us of host time "
              f"({dp['collective_call']['drained_us']:.1f} drained), from a second thread "
              f"{dp['collective_call_thread']['host_us']:.1f} us on {smi}", flush=True)
    ev, w1e = dp["eval"], dp["world1_eval"]
    sz = dp["sizes"]
    print(f"dist eval ({sz['val_images']} val images, {sz['val_imgsz']} px, 'matrix', "
          f"{sz['val_batch']} images a forward): world 2 P/R/mAP@.5/mAP "
          + "/".join(f"{dp['world2'][0]['eval'][k]:.4f}" for k in ("mp", "mr", "map50", "map"))
          + " vs world 1 " + "/".join(f"{w1e[k]:.4f}" for k in ("mp", "mr", "map50", "map"))
          + f", unmatched {ev['unmatched']}, K3 blocked launches by rank "
          f"{[r['eval']['launches']['fixpoint_keep_blocked'] for r in dp['world2']]} "
          f"(world 1 {w1e['launches']['fixpoint_keep_blocked']}); {w1e['s']:.1f} s at world 1, "
          f"{[round(r['eval']['s'], 1) for r in dp['world2']]} s a rank at world 2", flush=True)
    if "recipe_ms" in dp["world2"][0]:
        print(f"dist recipe at world 2 over gloo, both ranks on the one card, 2 images a rank: "
              f"{[round(r['recipe_ms'], 2) for r in dp['world2']]} ms a step by rank (host-"
              f"staged: no target) on {smi}", flush=True)
    e = dp["evolve"]
    print(f"dist evolve ({e['generations']} generations of the tiny model at "
          f"{sz['evolve_imgsz']} px, f32): world 2 over gloo trained world 1's hyps, fitness "
          f"{[round(f, 6) for f in e['fitness_world2']]} vs "
          f"{[round(f, 6) for f in e['fitness_world1']]} (max err {e['fitness_err']:.2e}, tol "
          f"{DIST_EVAL_TOL}), evolve.csv {e['csv_rows']} rows; {e['world1_s']:.1f} s at world "
          f"1, {[round(t, 1) for t in e['rank_s']]} s a rank on {smi}", flush=True)
    tr = dp["torchrun"]
    print(f"dist cli.train under torchrun: {tr['step']} steps, {tr['s']:.1f} s; phase "
          f"{dp['s']:.1f} s (world-1 step {dp['world1_s']:.1f}, world-2 spawn "
          f"{dp['world2_spawn_s']:.1f}, recipe timing {dp.get('recipe_s', 0.0):.1f})",
          flush=True)


# ---------------------------------------------------------------------------
# the spatial H-sharding (parallel/spatial.py)
# ---------------------------------------------------------------------------

SPATIAL = dict(imgsz=1536, images=2, check_imgsz=640, check_batch=2, val_images=32,
               val_imgsz=640, val_batch=16, workers=4)
SPATIAL_DIR = ROOT / "build" / "spatial_smoke"
SPATIAL_HEAD_TOL = 1e-4  # the f32 raw head at 1 x 2 against world 1, over 1 + max |head|
# bf16 detection sets at 1 x 2 against world 1's: unmatched rows an image
# beyond world 1's own bf16 noise (each image alone against the pair), 1%
# of max_det (a split map's convs run at other shapes, so cuDNN may round
# other ways, as it does for a batch of one)
SPATIAL_BF16_BAND = 3
SPATIAL_SEED = 11


def h_reading_ops(model):
    """The ops of `model` that read along H, counted from its modules (the
    yaml's count): each conv with a kernel, stride or padding along H,
    each max pool of SPPF and SPPFCSPC, SCConv's pool and its resize back,
    each Upsample."""
    from dmayolo_tpu_torch.nn.blocks import SPPF, SPPFCSPC, SCConv, Upsample
    from dmayolo_tpu_torch.nn.primitives import Conv2d

    n = 0
    for m in model.modules():
        if isinstance(m, Conv2d):
            n += (m.k[0], m.s[0], m.p[0]) != (1, 1, 0)
        elif isinstance(m, (SPPF, SPPFCSPC)):
            n += 3
        elif isinstance(m, SCConv):
            n += 2
        elif isinstance(m, Upsample):
            n += 1
    return n


def digests(t):
    """Two exact checksums of a map's bytes in NHWC order, on its device:
    the sum of its values read as integers, and that sum weighted by
    position (int64, wrapping alike in any order)."""
    import torch

    v = t.permute(0, 2, 3, 1).contiguous()
    v = v.view(torch.int16 if v.element_size() == 2 else torch.int32).reshape(-1).long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return int(v.sum()), int((v * w).sum())


def int8_row_digests(model, split):
    """Forward hooks on every conv that runs its int8 form: its route and
    the digests of its input and output rows, this rank's (`split`) or
    those of each of two spatial ranks' rows (one process)."""
    from dmayolo_tpu_torch.nn.conv_int8 import route_of
    from dmayolo_tpu_torch.nn.primitives import Conv2d
    from dmayolo_tpu_torch.parallel.spatial import row_bounds

    rec = {}

    def hook(name):
        def fn(m, args, y):
            if m.int8 is None:
                return
            x = args[0]
            if split:
                rows = {"own": (digests(x), digests(y))}
            else:
                rows = {r: (digests(x[:, :, a:b]), digests(y[:, :, c:d])) for r, ((a, b), (c, d))
                        in enumerate(zip(row_bounds(x.shape[2], 2), row_bounds(y.shape[2], 2)))}
            rec[name] = {"route": route_of(m.k, m.s, m.p, m.d), "rows": rows}
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, Conv2d)]
    return rec, handles


def det_rows(dets, valid, imgsz):
    """Each image's valid detections as `same_sets` rows [cls, box / imgsz,
    conf]."""
    import numpy as np

    out = []
    for d, v in zip(dets.float().cpu().numpy(), valid.cpu().numpy()):
        d = d[v]
        out.append(np.concatenate([d[:, 5:6], d[:, :4] / imgsz, d[:, 4:5]], 1))
    return out


def unmatched_sets(got, want):
    """`same_sets` of each image's detection rows (2e-3 of the image in
    box, 5% in score), the largest count over the images.  Rows within 5%
    of the lowest score of a set that `max_det` cut may be unmatched: at
    the cut a row can trade places with the first one below it."""
    band = SAME_SET_BAND * PROTOCOL["conf_thres"]
    worst = 0
    for g, w in zip(got, want):
        cut = band if len(w) < PROTOCOL["max_det"] else max(band, 1.05 * float(w[:, -1].min()))
        worst = max(worst, same_sets(g, w, 2e-3, 0.05, cut))
    return worst


def spatial_checks(device, model, images, scales, val_list, sizes, nc, txt_dir, mesh=None):
    """The spatial phase's passes on one process (`mesh` None) or on this
    rank of a 1 x 2 (data, spatial) mesh (`images` split by rows), each
    with the launch counters zeroed just before and read just after:
    the eval protocol in bf16 on "matrix" and on "pallas" (its peak
    memory and halo exchanges) and in f32 on "matrix" (TF32 off, as
    every f32 pass), the f32 and bf16 raw heads of image 0 (one process
    also image 0's bf16 head in the pair), f32 TTA on image 0,
    f32 `run_validation` over `val_list` (its txt rows to `txt_dir`, from
    the main rank), and int8 eval (bf16, the model
    fused, `scales`) on image 0 with each int8 conv's row digests."""
    import gc

    import torch

    from dmayolo_tpu_torch.core.fixpoint_kernel import fixpoint_keep, fixpoint_keep_blocked
    from dmayolo_tpu_torch.core.nms_kernel import nms_greedy, nms_greedy_stream
    from dmayolo_tpu_torch.eval.validator import make_infer_fn, run_validation
    from dmayolo_tpu_torch.nn.conv_int8 import ROUTE_COUNTS, quantize_s8
    from dmayolo_tpu_torch.parallel import spatial as sp
    from dmayolo_tpu_torch.parallel.mesh import shard_batch

    on_card = device.type == "cuda"
    counters = (nms_greedy, nms_greedy_stream, Counter(nms_greedy_stream, "cluster_launches",
                                                       "nms_greedy_stream_cluster"),
                fixpoint_keep, fixpoint_keep_blocked, *ROUTE_COUNTS.values(), quantize_s8)

    def counted(fn):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        r = fn()
        if on_card:
            torch.cuda.synchronize()
        return r, {c.__name__: c.launches for c in counters}, time.perf_counter() - t0

    split = mesh is not None
    xl = (shard_batch(mesh, images, spatial=True) if split
          else torch.from_numpy(images).to(device))
    kw = dict(mesh=mesh, spatial=True) if split else {}
    imgsz = images.shape[1]
    out = {"rows": xl.shape[1]}
    f32 = torch.float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for backend, dtype in (("matrix", torch.bfloat16), ("pallas", torch.bfloat16),
                           ("matrix", f32)):
        infer = make_infer_fn(model, dtype=dtype, nms_backend=backend, **PROTOCOL, **kw)
        gc.collect()
        base = 0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        e0, f0 = sp.EXCHANGES[0], sp.FETCHES[0]
        (dets, valid), launches, s = counted(lambda: infer(xl))
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        out[f"eval_{backend}" + ("_f32" if dtype == f32 else "")] = {
            "dets": det_rows(dets, valid, imgsz), "launches": launches, "s": s,
            "peak_gib": peak / 2 ** 30, "above_model_gib": (peak - base) / 2 ** 30,
            "exchanges": sp.EXCHANGES[0] - e0, "fetches": sp.FETCHES[0] - f0}
    if not split:  # a control: world 1's own bf16 noise, each image in a batch of its own
        infer = make_infer_fn(model, dtype=torch.bfloat16, nms_backend="matrix", **PROTOCOL)
        out["eval_matrix_alone"] = {"dets": sum((det_rows(*infer(xl[i:i + 1]), imgsz)
                                                 for i in range(len(xl))), [])}
    with torch.inference_mode(), sp.spatial_scope(mesh):
        for name, dtype in (("head_f32", f32), ("head_bf16", torch.bfloat16)):
            out[name] = [r.float().cpu().numpy() for r in
                         model.apply(xl[:1].to(dtype) / 255.0, dtype)]
        if not split:  # world 1's own bf16 noise: image 0 in the pair
            out["head_bf16_pair"] = [r[:1].float().cpu().numpy() for r in
                                     model.apply(xl.to(torch.bfloat16) / 255.0, torch.bfloat16)]
    infer = make_infer_fn(model, dtype=f32, augment=True, nms_backend="matrix", **PROTOCOL, **kw)
    (dets, valid), launches, s = counted(lambda: infer(xl[:1]))
    out["tta"] = {"dets": det_rows(dets, valid, imgsz), "launches": launches, "s": s}
    res, launches, s = counted(lambda: run_validation(
        model, str(val_list), img_size=sizes["val_imgsz"], batch_size=sizes["val_batch"], nc=nc,
        dtype=f32, nms_backend="matrix", workers=sizes["workers"], device=device, mesh=mesh,
        spatial=split, save_txt_dir=txt_dir, save_conf=True, **PROTOCOL))
    out["val"] = {"launches": launches, "s": s, "nt": res.nt,
                  **{k: getattr(res, k) for k in ("mp", "mr", "map50", "map75", "map")}}
    model.fuse()
    rec, handles = int8_row_digests(model, split)
    infer = make_infer_fn(model, dtype=torch.bfloat16, fused=True, quant=scales,
                          nms_backend="matrix", **PROTOCOL, **kw)
    try:
        (dets, valid), launches, s = counted(lambda: infer(xl[:1]))
    finally:
        for h in handles:
            h.remove()
    out["int8"] = {"dets": det_rows(dets, valid, imgsz), "launches": launches, "s": s,
                   "convs": rec}
    return out


def spatial_rank(mesh, cfg, nc, sizes, seed, model_path, images, scales, val_list, txt_dir):
    """One rank of 1 data x 2 spatial (gloo, both ranks on the card): the
    passes of `spatial_checks` on its rows, then the f32 step through the
    H-sharded step against the plain one."""
    import torch

    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.parallel.mesh import make_mesh

    sm = make_mesh(1, 2, device=mesh.device)
    model = DetectionModel(cfg, nc=nc, device=mesh.device)
    model.load_state_dict(torch.load(model_path, map_location=mesh.device))
    out = spatial_checks(mesh.device, model.eval(), images, scales, val_list, sizes, nc,
                         txt_dir, sm)
    del model
    t0 = time.perf_counter()
    # rank 0 holds the step against the plain one; rank 1 runs its share
    out["step"] = dist_step_check(mesh.device, cfg, nc, sizes, seed, sm, spatial=True,
                                  reference=sm.spatial_rank == 0)
    out.update(step_s=time.perf_counter() - t0, rank=sm.rank, spatial_rank=sm.spatial_rank,
               device=str(mesh.device))
    return out


def spatial_phase(device, smi, data_dir=DATA_DIR, cfg=None, sizes=SPATIAL, nc=10):
    """The spatial H-sharding (`parallel/spatial.py`) at 1 data x 2
    spatial over gloo, both ranks on the one card (NCCL refuses two ranks
    on one device; a correctness check at full width, not a speed figure):
    the full-width flagship at `imgsz` px on `images` images of
    rectangles, against world 1 in this process on the same images: the
    eval protocol in bf16 on "matrix" (K3's blocked entry in each rank)
    and "pallas" (K2's cluster kernel), each rank's peak memory beside
    world 1's, the halo exchanges of a forward beside the yaml's count,
    the detection sets within world 1's own bf16 noise (each image alone
    against the pair: cuDNN rounds other shapes otherwise) plus
    `SPATIAL_BF16_BAND`, the bf16 head of one image beside that noise;
    in f32 (TF32 off) the same detection sets (`unmatched_sets`) on
    "matrix", the raw head of one image (`SPATIAL_HEAD_TOL`), TTA on one
    image (its 0.67 scale: 1029 rows padded to 1056, whose P4-P5 maps and
    SCConv windows split unevenly) and `run_validation(spatial=True)` on
    the data phase's first `val_images` val files, labelled with world 1's
    own f32 detections (the same detection sets file by file, from the
    txt rows; P, R and mAP within `DIST_EVAL_TOL` or one label's share,
    1 / nt, with world 1's own move under a `STEP_NOISE_REL` change of its
    weights beside them); int8 eval (bf16, world 1's scales) on one image:
    the same detection sets, K4 on world 1's routes, and every int8 conv
    whose input rows equal world 1's giving equal output rows; the f32
    step at `check_batch` x `check_imgsz` against the plain one within
    `TRAIN_F32_TOL` (`dist_step_check`).  Prints its lines (`print_spatial`) before its
    checks."""
    import gc
    import shutil

    import torch

    from dmayolo_tpu_torch.eval.validator import run_validation
    from dmayolo_tpu_torch.graph import DetectionModel, model_config
    from dmayolo_tpu_torch.nn.quant import calibrate_act_scales
    from dmayolo_tpu_torch.parallel.mesh import spawn

    cfg = cfg or model_config(FLAGSHIP)
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out = {"sizes": dict(sizes)}
    shutil.rmtree(SPATIAL_DIR, ignore_errors=True)
    SPATIAL_DIR.mkdir(parents=True)
    try:
        model = build_model(device, cfg=cfg, nc=nc).eval()
        model_path = SPATIAL_DIR / "model.pt"
        torch.save(model.state_dict(), model_path)
        out["h_reading_ops"] = h_reading_ops(model)
        images, _ = rectangles(sizes["images"], sizes["imgsz"], nc, SPATIAL_SEED)
        fused = DetectionModel(cfg, nc=nc, device=device)
        fused.load_state_dict(model.state_dict())
        scales = calibrate_act_scales(fused.eval().fuse(), [images[:1]])
        del fused
        val_list = SPATIAL_DIR / "val.txt"
        val_list.write_text("".join(f"{f}\n" for f in sorted(
            (data_dir / "images" / "val").iterdir())[:sizes["val_images"]]))
        # those files' labels: world 1's own f32 detections, so that its
        # mAP is far from 0 and the spatial run's is held to it
        own_labels(model, str(val_list), sizes["val_imgsz"], sizes["val_batch"], torch.float32,
                   sizes["workers"])
        t0 = time.perf_counter()
        # world 1's own metric noise: run_validation with its weights moved
        # by STEP_NOISE_REL (a reading beside the split's, not a check)
        g = torch.Generator().manual_seed(SPATIAL_SEED)
        moved = DetectionModel(cfg, nc=nc, device=device)
        moved.load_state_dict({k: v * (1 + STEP_NOISE_REL * torch.randn(v.shape, generator=g)
                                       .to(v.device)) if v.is_floating_point() else v
                               for k, v in model.state_dict().items()})
        res = run_validation(moved.eval(), str(val_list), img_size=sizes["val_imgsz"],
                             batch_size=sizes["val_batch"], nc=nc, dtype=torch.float32,
                             nms_backend="matrix", workers=sizes["workers"], device=device,
                             **PROTOCOL)
        out["world1_moved_val"] = {k: getattr(res, k) for k in ("mp", "mr", "map50", "map")}
        del moved
        w1 = spatial_checks(device, model, images, scales, val_list, sizes, nc,
                            SPATIAL_DIR / "txt_w1")
        out["world1_s"] = time.perf_counter() - t0
        del model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(spatial_rank, 2, args=(cfg, nc, sizes, SPATIAL_SEED, str(model_path),
                                             images, scales, str(val_list),
                                             str(SPATIAL_DIR / "txt_1x2")),
                      device=device.type, backend="gloo", share_device=on_card,
                      threads=None if on_card else torch.get_num_threads())
        out["spawn_s"] = time.perf_counter() - t0
        # run_validation's detection sets, file by file (the main rank's rows)
        a, b = label_lines(SPATIAL_DIR / "txt_1x2"), label_lines(SPATIAL_DIR / "txt_w1")
        out["val_sets"] = {"files": [len(a), len(b)],
                           "detections": [sum(map(len, a.values())), sum(map(len, b.values()))],
                           "unmatched": unmatched_sets([rows_of(a.get(k, [])) for k in b],
                                                       [rows_of(b[k]) for k in b])}
    finally:
        shutil.rmtree(SPATIAL_DIR, ignore_errors=True)
    def summary(res):  # what the report keeps: no detection rows, heads or digests
        return {k: {a: b for a, b in v.items() if a not in ("dets", "convs")}
                if isinstance(v, dict) else v for k, v in res.items()
                if not k.startswith("head_")}

    def head_err(got, want):  # max |got - want| over 1 + max |want|, over the levels
        scale = 1.0 + max(float(abs(w).max()) for w in want)
        return max(float(abs(g - w).max()) for g, w in zip(got, want)) / scale

    out["world1"] = summary(w1)
    out["ranks"] = [summary(r) for r in ranks]
    out["world1_bf16_alone_unmatched"] = unmatched_sets(w1["eval_matrix_alone"]["dets"],
                                                        w1["eval_matrix"]["dets"])
    out["world1_bf16_pair_head_err"] = head_err(w1["head_bf16_pair"], w1["head_bf16"])
    cmp = out["compare"] = []
    for r in ranks:
        c = {"rank": r["rank"]}
        for key in ("eval_matrix", "eval_pallas", "eval_matrix_f32", "tta", "int8"):
            c[f"{key}_unmatched"] = unmatched_sets(r[key]["dets"], w1[key]["dets"])
            c[f"{key}_detections"] = [sum(map(len, r[key]["dets"])),
                                      sum(map(len, w1[key]["dets"]))]
        c["head_f32_scaled_err"] = head_err(r["head_f32"], w1["head_f32"])
        c["head_bf16_scaled_err"] = head_err(r["head_bf16"], w1["head_bf16"])
        c["val_metric_err"] = max(abs(r["val"][k] - w1["val"][k])
                                  for k in ("mp", "mr", "map50", "map"))
        c["val_metric_err_world1_moved"] = max(abs(out["world1_moved_val"][k] - w1["val"][k])
                                               for k in ("mp", "mr", "map50", "map"))
        routes = {k: v for k, v in r["int8"]["launches"].items() if k.startswith("conv_int8")}
        c["int8_routes"] = routes
        c["int8_routes_world1"] = {k: w1["int8"]["launches"][k] for k in routes}
        same_in = [(name, conv["route"]) for name, conv in r["int8"]["convs"].items()
                   if conv["rows"]["own"][0] == w1["int8"]["convs"][name]["rows"][
                       r["spatial_rank"]][0]]
        c["int8_convs"] = len(r["int8"]["convs"])
        c["int8_equal_inputs"] = len(same_in)
        c["int8_equal_inputs_by_route"] = {rt: sum(1 for _, q in same_in if q == rt)
                                           for rt in sorted({q for _, q in same_in})}
        c["int8_unequal_outputs"] = [name for name, _ in same_in
                                     if r["int8"]["convs"][name]["rows"]["own"][1]
                                     != w1["int8"]["convs"][name]["rows"][r["spatial_rank"]][1]]
        cmp.append(c)
    out["s"] = time.perf_counter() - t_phase
    print_spatial(out, smi)
    check(ranks[0]["step"] is not None, "no spatial rank held the f32 step")
    vs = out["val_sets"]
    check(vs["files"][0] == vs["files"][1] == sizes["val_images"] and vs["unmatched"] == 0,
          f"spatial run_validation's detection sets differ from world 1's: {vs}")
    for r, c in zip(ranks, cmp):
        check(all(c[f"{k}_unmatched"] == 0 for k in ("eval_matrix_f32", "tta", "int8")),
              f"spatial rank {r['rank']}'s detections differ from world 1's: {c}")
        bf16_limit = out["world1_bf16_alone_unmatched"] + SPATIAL_BF16_BAND
        check(all(c[f"{k}_unmatched"] <= bf16_limit for k in ("eval_matrix", "eval_pallas")),
              f"spatial rank {r['rank']}'s bf16 detections differ from world 1's beyond its "
              f"own bf16 noise plus {SPATIAL_BF16_BAND}: {c}")
        check(c["head_f32_scaled_err"] <= SPATIAL_HEAD_TOL,
              f"spatial rank {r['rank']}'s f32 raw head differs from world 1's: {c}")
        # at f32 the split forward differs from world 1's in its last bits
        # (the head within SPATIAL_HEAD_TOL), so one detection at a score
        # tie or an IoU threshold may flip: one label's share of a metric
        check(c["val_metric_err"] <= max(DIST_EVAL_TOL, 1 / w1["val"]["nt"])
              and r["val"]["nt"] == w1["val"]["nt"] and 0 < w1["val"]["map50"],
              f"spatial run_validation differs from world 1: {c}, {r['val']}, {w1['val']}")
        check(r["step"] is None or r["step"]["ok"],
              f"spatial rank {r['rank']}'s f32 step differs from the plain one: {r['step']}")
        check(c["int8_convs"] == len(w1["int8"]["convs"]) > 0
              and c["int8_equal_inputs"] > 0 and not c["int8_unequal_outputs"],
              f"spatial int8 rows differ from world 1's: {c}")
        check(c["int8_routes"] == c["int8_routes_world1"],
              f"K4's routes at 1 x 2 are not world 1's: {c}")
        check(r["eval_matrix"]["exchanges"] > 0, f"no halo exchange in a spatial forward: {c}")
        if on_card:
            check(r["eval_matrix"]["launches"]["fixpoint_keep_blocked"] > 0
                  and r["tta"]["launches"]["fixpoint_keep_blocked"] > 0
                  and r["val"]["launches"]["fixpoint_keep_blocked"] > 0
                  and r["int8"]["launches"]["fixpoint_keep_blocked"] > 0,
                  f"K3 did not launch in spatial rank {r['rank']}: {r['eval_matrix']}")
            check(r["eval_pallas"]["launches"]["nms_greedy_stream_cluster"] > 0,
                  f"K2's cluster kernel did not launch in spatial rank {r['rank']}")
            check(sum(c["int8_routes"].values()) > 0,
                  f"K4 did not launch in spatial rank {r['rank']}")
    return out


def print_spatial(sp, smi):
    w1, sz = sp["world1"], sp["sizes"]
    ev = w1["eval_matrix"]
    for r, c in zip(sp["ranks"], sp["compare"]):
        e = r["eval_matrix"]
        print(f"spatial 1x2 rank {r['rank']} ({r['rows']} of {sz['imgsz']} rows, gloo on "
              f"{r['device']}): eval bs{sz['images']} {sz['imgsz']} px bf16 peak "
              f"{e['peak_gib']:.2f} GiB ({e['above_model_gib']:.2f} above the weights) against "
              f"world 1's {ev['peak_gib']:.2f} ({ev['above_model_gib']:.2f}); "
              f"{e['exchanges']} halo exchanges in a forward ({e['fetches']} ops read along "
              f"H; the yaml's count {sp['h_reading_ops']}); unmatched detections: f32 "
              f"matrix {c['eval_matrix_f32_unmatched']}, f32 TTA {c['tta_unmatched']}, int8 "
              f"(bf16) {c['int8_unmatched']}; bf16 matrix {c['eval_matrix_unmatched']}, "
              f"pallas {c['eval_pallas_unmatched']} (limit: world 1's own bf16, each image "
              f"alone against the pair, {sp['world1_bf16_alone_unmatched']}, plus "
              f"{SPATIAL_BF16_BAND}; detections {c['eval_matrix_detections']}, TTA "
              f"{c['tta_detections']}); f32 head {c['head_f32_scaled_err']:.2e} (tol "
              f"{SPATIAL_HEAD_TOL}); bf16 head {c['head_bf16_scaled_err']:.2e} (world 1's "
              f"own, image 0 alone against the pair: {sp['world1_bf16_pair_head_err']:.2e}); "
              f"run_validation "
              f"P/R/mAP@.5/mAP " + "/".join(f"{r['val'][k]:.4f}" for k in ("mp", "mr", "map50",
                                                                            "map"))
              + " (f32; world 1 " + "/".join(f"{w1['val'][k]:.4f}" for k in ("mp", "mr",
                                                                             "map50", "map"))
              + f", err {c['val_metric_err']:.2e}; world 1's own under a {STEP_NOISE_REL} "
              f"change of its weights {c['val_metric_err_world1_moved']:.2e}; detection sets "
              f"unmatched {sp['val_sets']['unmatched']} over {sp['val_sets']['files'][1]} files, "
              f"{sp['val_sets']['detections']} rows); int8: K4 routes {c['int8_routes']} (world 1 "
              f"{c['int8_routes_world1']}), {c['int8_equal_inputs']} of {c['int8_convs']} convs "
              f"with world 1's input rows {c['int8_equal_inputs_by_route']}, their outputs "
              f"equal: {not c['int8_unequal_outputs']}; f32 step at {sz['check_batch']} x "
              f"{sz['check_imgsz']} px: "
              + (f"its share (rank 0 holds it)" if r["step"] is None else
                 f"loss {r['step']['loss_rel_err']:.2e}, grads "
                 f"{r['step']['grad_scaled_err']:.2e}, params {r['step']['param_scaled_err']:.2e}, "
                 f"BN buffers {r['step']['buffer_scaled_err']:.2e} (tol {r['step']['tol']}; the "
                 f"plain step itself moves its grads {r['step']['grad_noise']:.2e} and params "
                 f"{r['step']['param_noise']:.2e} under a {STEP_NOISE_REL} change of its "
                 f"weights)")
              + f"; K3 blocked "
              f"launches eval/TTA/val/int8 {e['launches']['fixpoint_keep_blocked']}/"
              f"{r['tta']['launches']['fixpoint_keep_blocked']}/"
              f"{r['val']['launches']['fixpoint_keep_blocked']}/"
              f"{r['int8']['launches']['fixpoint_keep_blocked']}; on {smi}", flush=True)
    print(f"spatial phase {sp['s']:.1f} s (world 1 {sp['world1_s']:.1f}, the 1x2 spawn "
          f"{sp['spawn_s']:.1f}; eval s world 1 {ev['s']:.2f}, ranks "
          f"{[round(r['eval_matrix']['s'], 2) for r in sp['ranks']]}; step s "
          f"{[round(r['step_s'], 1) for r in sp['ranks']]})", flush=True)


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8-compare", metavar="DIR",
                    help="only time K4 and int8 serving of the checkout in DIR and of this one, "
                         "in turns (DIR, this, this, DIR)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.int8_compare:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"card: {smi}", flush=True)
        res = int8_compare(args.int8_compare)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "int8_compare.json").write_text(json.dumps({"card": smi, **res}, indent=1))
        print(json.dumps({"int8_compare": [{k: r[k] for k in ("tree", "s")} for r in
                                           res["rounds"]], "card": smi}))
        return 0
    from dmayolo_tpu_torch.core.fixpoint_kernel import fixpoint_keep, fixpoint_keep_blocked
    from dmayolo_tpu_torch.core.nms_kernel import nms_greedy, nms_greedy_stream
    from dmayolo_tpu_torch.nn.conv3x3 import conv3x3_s1
    from dmayolo_tpu_torch.nn.conv_int8 import ROUTE_COUNTS, quantize_s8
    from dmayolo_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = cuda_build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({', '.join(cuda_build.SOURCES)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line:
                print(f"  {name}: {line.strip()[:150]}")
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    report = {"card": smi, "build_s": build_s}
    phases = report["phase_s"] = {"build": build_s}
    t0 = time.perf_counter()
    report["jpeg"], frame = jpeg_phase()
    phases["jpeg"] = time.perf_counter() - t0
    print("jpeg: " + json.dumps(report["jpeg"]), flush=True)
    fj = report["jpeg"]["formats"]
    print(f"image formats: {fj['exact']} BMP/TIFF/PNG fixtures equal to cv2's pixels; "
          f"{len(fj['jpeg'])} EXIF JPEG and MPO fixtures through {report['jpeg']['codec']} at "
          f"their rotated shapes, max |diff| {max(r['max_abs'] for r in fj['jpeg'].values())} "
          f"(4:2:0 bound {JPEG_BOUNDS['4:2:0']['max_abs']})", flush=True)
    t0 = time.perf_counter()
    report["k2"] = k2 = check_nms(device)
    print("K2 nms_greedy: " + json.dumps(k2), flush=True)
    report["k3"] = k3 = check_fixpoint(device)
    print("K3 nms_fixpoint: " + json.dumps(k3), flush=True)
    report["k3_blocked"] = k3b = check_fixpoint_blocked(device)
    print("K3 nms_fixpoint blocked: " + json.dumps(k3b), flush=True)
    report["k2_stream"] = k2s = check_nms_stream(device)
    print("K2 nms_greedy_stream: " + json.dumps(k2s), flush=True)
    for label, ms, kms, res in (
            ("K3 (128, 512) divide-free", k3["ms"], k3["kernel_ms"], k3),
            ("K3 (128, 512) divide", k3["ms_divide"], k3["kernel_ms_divide"], k3),
            ("K3 (32, 512) divide", k3["eval_ms_divide"], k3["eval_kernel_ms_divide"],
             {"bound_ms": k3["eval_bound_ms"]}),
            (f"K3 blocked {tuple(k3b['shape'])}, {k3b['blocks_walked']} blocks walked",
             k3b["ms"], k3b["kernel_ms"], k3b),
            (f"K2 streaming {tuple(k2s['shape'])}, {k2s['route']}", k2s["ms"],
             k2s["kernel_ms"], k2s),
            (f"K2 {tuple(k2['shape'])}", k2["ms"], k2["kernel_ms"], k2)):
        print(f"{label}: call {ms:.4f} ms, kernel {kms:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"on {smi}", flush=True)
    print(f"K2 (8, 1024): kernel {k2['k1024_kernel_ms']:.4f} ms on {smi}", flush=True)
    phases["K2, K3 checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["k1"] = k1 = check_conv(device)
    for c in k1:
        print("K1 conv3x3_s1: " + json.dumps(c), flush=True)
        print(f"K1 {c['dtype']} {tuple(c['shape'])}: call {c['ms']:.4f} ms, kernel "
              f"{c['kernel_ms']:.4f} ms, cuDNN {c['library_ms']:.4f} ms (TF32 off), bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']}) on {smi}", flush=True)
    report["k1_ragged"] = k1_ragged = check_conv(device, K1_RAGGED, timed=False)
    print("K1 conv3x3_s1 ragged: " + json.dumps(
        {"cases": len(k1_ragged), "max_scaled_err": max(c["max_scaled_err"] for c in k1_ragged)}),
        flush=True)

    phases["K1 checks"] = time.perf_counter() - t0
    stream_cluster = Counter(nms_greedy_stream, "cluster_launches", "nms_greedy_stream_cluster")
    counters = (nms_greedy, nms_greedy_stream, stream_cluster, fixpoint_keep,
                fixpoint_keep_blocked, conv3x3_s1, *ROUTE_COUNTS.values(), quantize_s8)
    t_phase = t0 = time.perf_counter()
    model = build_model(device)
    report["model_build_s"] = time.perf_counter() - t0
    # the flagship's 3x3 stride-1 convs at the serving batch, for the
    # question whether K1 should replace cuDNN inside the port's Conv2d
    xs = torch.rand(128, 640, 640, 3, device=device, dtype=torch.bfloat16,
                    generator=torch.Generator(device=device).manual_seed(6))
    sites = conv3x3_sites(model, xs, torch.bfloat16)
    del xs
    report["k1_flagship"] = k1f = check_conv_flagship(device, sites)
    for r in k1f["shapes"]:
        b, h, w, c1, c2 = r["shape"]
        print(f"K1 flagship bs{b} {h}x{w} {c1}->{c2} x{r['count']}: K1 {r['ms']:.4f} ms "
              f"(kernel {r['kernel_ms']:.4f}), cuDNN {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['share_of_bound']:.3f} of bound, max scaled err {r['max_scaled_err']:.2e}",
              flush=True)
    print(f"K1 over the step's {k1f['convs']} 3x3 convs ({len(sites)} shapes, count-weighted): "
          f"{k1f['step_ms']:.3f} ms (kernel {k1f['step_kernel_ms']:.3f}); "
          f"cuDNN over the same: {k1f['step_library_ms']:.3f} ms; "
          f"bound {k1f['step_bound_ms']:.3f} ms; on {smi}", flush=True)
    report["k1_flagship_f32"] = k1f32 = check_conv_flagship(device, sites, batch=2, dtype="f32")
    print(f"K1 f32 (3xTF32) at the flagship's {len(sites)} 3x3 shapes, batch 2: max scaled err "
          f"{k1f32['max_scaled_err']:.2e} (tol {K1_TOL['f32']})", flush=True)
    report["serving"] = srv = serving(device, model, counters=counters)
    print("serving: " + json.dumps(srv), flush=True)
    check(srv["batcher_pallas"]["launches"]["nms_greedy"] > 0,
          "K2 did not launch on the serving path with backend 'pallas'")
    check(srv["batcher_default"]["backend"] == "matrix"
          and srv["batcher_default"]["launches"]["fixpoint_keep"] > 0,
          "K3 did not launch on the serving path with the default backend")
    for sfx, name in (("", "pallas"), ("_matrix", "matrix")):
        print(f"serving bs{srv['serve_batch']} 640px bf16 NMS '{name}': "
              f"{srv['serve_img_per_s' + sfx]:.1f} img/s ({srv['serve_ms' + sfx]:.2f} ms/batch) "
              f"on {smi}")
    report["eval"] = ev = evaluate(device, model, counters=counters)
    print("eval: " + json.dumps(ev), flush=True)
    check_eval_launches(FLAGSHIP, ev)
    for name, res in ev["backends"].items():
        print(f"eval bs{ev['batch']} 640px bf16 max_nms 30000 NMS '{name}': "
              f"{res['img_per_s']:.1f} img/s ({res['step_ms']:.2f} ms/batch) on {smi}")
    del model
    torch.cuda.empty_cache()
    phases["flagship: K1 at its convs, serving, eval"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    report["train"] = tr = train(device, counters=counters, orbax=ORBAX)
    print("train: " + json.dumps(tr), flush=True)
    check(tr["checkpoint_serve"]["launches"]["fixpoint_keep"] > 0,
          "K3 did not launch serving the trained checkpoint on 'matrix'")
    check(tr["orbax"]["serve"]["launches"]["fixpoint_keep"] > 0,
          "K3 did not launch serving the model restored from the Orbax checkpoint")
    print_train("train", tr, smi)
    print_orbax(tr["orbax"], smi)

    phases["flagship: train"] = time.perf_counter() - t0 - tr["orbax"]["s"]
    phases["orbax"] = tr["orbax"]["s"]

    # ---- int8 PTQ: K4 at every eligible shape, int8 serving, the tiny model
    report["int8"] = i8 = int8_phase(device, counters, smi)
    phases["int8"] = i8["s"]

    # ---- the SPD-Conv family: both models served, evaluated and trained
    t0 = time.perf_counter()
    spd, spd_sites = {}, {}
    for name in SPD_MODELS:
        t1 = time.perf_counter()
        spd[name] = spd_phase(device, name, counters, smi, spd_sites,
                              cfg=at_earlier_depth(name))
        spd[name]["s"] = time.perf_counter() - t1
    report["spd"] = spd
    report["k1_spd"] = k1s = check_conv_flagship(device, union_sites(spd_sites))
    k1_spd = {name: site_sums(k1s["shapes"], sites) for name, sites in spd_sites.items()}
    for name, sums in k1_spd.items():
        print(f"K1 over {name}'s {sums['convs']} 3x3 stride-1 convs at bs128 640px bf16 "
              f"({sums['shapes']} shapes, count-weighted): {sums['step_ms']:.3f} ms (kernel "
              f"{sums['step_kernel_ms']:.3f}); cuDNN {sums['step_library_ms']:.3f} ms; bound "
              f"{sums['step_bound_ms']:.3f} ms; max scaled err {k1s['max_scaled_err']:.2e} "
              f"(images 0-1); on {smi}", flush=True)

    phases["SPD models"] = time.perf_counter() - t0

    # ---- the zoo: DMA-full and DMA-HorNet served, evaluated and trained;
    # TPH, CADMM and ghostnet served and evaluated (before the data phase:
    # run after it in one call, the zoo's training read 9.0 img/s against
    # 15.9 run before it; the cause is not measured)
    zoo = {}
    for name in ZOO_MODELS:
        t1 = time.perf_counter()
        zoo[name] = zoo_phase(device, name, counters, smi, cfg=at_earlier_depth(name))
        zoo[name]["s"] = phases[ZOO_MODELS[name]] = time.perf_counter() - t1
        print(f"{ZOO_MODELS[name]} phase: {zoo[name]['s']:.1f} s", flush=True)
    report["zoo"] = zoo

    # ---- the sweep: every other new yaml built, served once, its head held
    t0 = time.perf_counter()
    sweep = report["sweep"] = {}
    for name in SWEEP_MODELS:
        sweep[name] = r = sweep_model(device, name, counters, cfg=at_earlier_depth(name))
        print(f"sweep {name}: {r['params'] / 1e6:.2f} M parameters, {r['levels']} levels; "
              f"bs{SWEEP_BATCH} 640px bf16 on 'matrix': {r['detections']} detections, K3 "
              f"{r['launches']['fixpoint_keep']} launch, peak {r['peak_mem_gib']:.2f} GiB; raw "
              f"head card vs CPU f32 at {SWEEP_CHECK_IMGSZ}px "
              f"{r['f32_card_vs_cpu_max_abs_err']:.2e} (tol {r['f32_tol']:.2e}, max |head| "
              f"{r['f32_raw_max_abs']:.1f}); build {r['build_s']:.1f} s, serve "
              f"{r['serve_s']:.2f} s, all {r['s']:.1f} s; on {smi}", flush=True)
    phases["sweep"] = time.perf_counter() - t0

    # ---- the data path on disk: loader, run_validation, the data-built
    # Trainer; then the CLIs on the same files
    import shutil

    try:
        t1 = time.perf_counter()
        model = build_model(device)
        report["data"] = dp = data_phase(device, counters, model)
        dp["s"] = phases["data"] = time.perf_counter() - t1
        del model
        torch.cuda.empty_cache()
        print_data(dp, ev, tr, smi)
        report["cli"] = cp = cli_phase(device, counters, smi)
        phases["cli"] = cp["s"]
        print_cli(cp, smi)
        report["tools"] = tp = tools_phase(device, counters, smi, frame)
        phases["tools"] = tp["s"]
        print_tools(report["jpeg"], tp, smi)
        report["dist"] = dist = dist_phase(device, smi)
        phases["dist"] = dist["s"]
        print_dist(dist, smi)
        report["spatial"] = spt = spatial_phase(device, smi)
        phases["spatial"] = spt["s"]
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        print("phase seconds so far: " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()),
              flush=True)

    # K1's headline: one bf16 call at each of the four shapes, summed; the
    # bound of that sum is the larger of its summed byte and operation
    # times.  The f32 route's sums beside it, on the 3xTF32 rate.
    k1_sums = {}
    for kind, rate in (("bf16", "bf16"), ("f32", "tf32x3")):
        cs = [c for c in k1 if c["dtype"] == kind]
        k1_sums[kind] = {k: sum(c[k] for c in cs)
                         for k in ("ms", "kernel_ms", "plain_ms", "library_ms")}
        k1_sums[kind]["max_abs_err"] = max(c["max_abs_err"] for c in cs)
        k1_sums[kind]["bound_ms"], k1_sums[kind]["bound_by"] = bound(
            sum(c["bytes"] for c in cs), sum(c["ops"] for c in cs), rate)
    # launches on each main path: the two serving batchers and the eval
    # protocol's three backends
    paths = {f"serving {r['backend']}": r["launches"]
             for r in (srv["batcher_pallas"], srv["batcher_default"])}
    paths.update({f"eval {b}": r["launches"] for b, r in ev["backends"].items()})
    paths["trained checkpoint served, matrix"] = tr["checkpoint_serve"]["launches"]
    paths["Orbax-restored flagship served, matrix"] = tr["orbax"]["serve"]["launches"]
    for name, res in spd.items():
        paths.update({f"{name} serving {r['backend']}": r["launches"]
                      for r in (res["serving"]["batcher_pallas"],
                                res["serving"]["batcher_default"])})
        paths.update({f"{name} eval {b}": r["launches"]
                      for b, r in res["eval"]["backends"].items()})
        paths[f"{name} trained checkpoint served, matrix"] = \
            res["train"]["checkpoint_serve"]["launches"]
    for name, res in zoo.items():
        label = ZOO_MODELS[name]
        paths.update({f"{label} serving {r['backend']}": r["launches"]
                      for r in (res["serving"]["batcher_pallas"],
                                res["serving"]["batcher_default"])})
        paths.update({f"{label} eval {b}": r["launches"] for b, r in res["eval"]["backends"].items()})
        if "train" in res:
            paths[f"{label} trained checkpoint served, matrix"] = \
                res["train"]["checkpoint_serve"]["launches"]
    paths.update({f"sweep {name} serving matrix": r["launches"] for name, r in sweep.items()})
    paths.update({f"run_validation {b}": r["launches"] for b, r in dp["run_validation"].items()})
    paths["run_validation matrix, BMP/TIFF/EXIF/webp/DNG copies"] = \
        dp["mixed"]["run_validation"]["mixed"]["launches"]
    paths["cli.detect, BMP/TIFF/EXIF/webp copies"] = dp["mixed"]["detect_launches"]
    for t in dp["train"]:
        paths[f"data-trained best.npz served, matrix, device_aug {int(t['device_aug'])}"] = \
            t["best_serve"]["launches"]
    paths.update({f"cli val {name}": r["launches"] for name, r in cp["val"].items()})
    paths["cli .pt served, matrix"] = cp["pt"]["launches"]
    paths.update({"tools detect": tp["detect"]["launches"],
                  "tools detect --augment": tp["augment"]["launches"],
                  "tools detect on the .pt2": tp["export"]["pt2_launches"],
                  "tools detect on the 1080p clip": tp["video"]["detect"]["launches"],
                  "tools streams, three clips": tp["video"]["streams"]["native"]["launches"],
                  "tools streams on the .pt2": tp["video"]["streams"]["pt2"]["launches"],
                  "tools hub": tp["hub"]["launches"], "tools rest batched": tp["rest"]["launches"],
                  "tools detect for wbf": tp["wbf"]["second_launches"]})

    paths["dist eval world 1, matrix"] = dist["world1_eval"]["launches"]
    paths.update({f"dist eval world 2 rank {r['rank']}, matrix": r["eval"]["launches"]
                  for r in dist["world2"]})
    for who, res in [("world 1", spt["world1"])] + [(f"rank {r['rank']}", r)
                                                     for r in spt["ranks"]]:
        paths.update({f"spatial {who} {key}": res[key]["launches"]
                      for key in ("eval_matrix", "eval_pallas", "tta", "val", "int8")})
    paths.update({f"int8 serving {name}": r["launches"] for name, r in i8["serving"].items()})
    paths[f"int8 serving {INT8_GENERAL_MODEL}"] = i8["general"]["launches"]
    paths.update({f"int8 eval tiny {dt}": i8["tiny"][dt]["launches"] for dt in ("f32", "bf16")})
    paths["int8 cli val tiny"] = i8["tiny"]["cli_val"]["launches"]

    def launches(counter):
        by_path = {p: n[counter.__name__] for p, n in paths.items() if n.get(counter.__name__)}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def timed(res):
        return {k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}

    kernels = [
        {"name": "nms_greedy", "route": "cuda",
         "design": "four warps an image, candidates in registers",
         "source": "dmayolo_tpu_torch/csrc/nms_greedy.cu",
         "replaces": "dmayolo_tpu/core/pallas_nms.py:77",
         **launches(nms_greedy), **timed(k2), "library_ms": None, "shape": k2["shape"],
         "kernel_ms": k2["kernel_ms"], "k1024_kernel_ms": k2["k1024_kernel_ms"]},
        # the cluster kernel, the eval's route; the global-memory kernel
        # (K above the cluster's capacity) in "global_route"
        {"name": "nms_greedy_stream", "route": "cuda",
         "design": "thread-block cluster an image, winners pushed by st.async",
         "source": "dmayolo_tpu_torch/csrc/nms_greedy.cu",
         "replaces": "dmayolo_tpu/core/pallas_nms.py:77",
         **launches(stream_cluster), **timed(k2s), "library_ms": None,
         "shape": k2s["shape"], "kernel_ms": k2s["kernel_ms"], "cluster": k2s["route"],
         "ms_by_route": k2s["ms_by_route"],
         "global_route": {"ms_at_shape": k2s["global_ms"], **k2s["global_big"]}},
        {"name": "nms_fixpoint", "route": "cuda",
         "design": "one block an image, S as bits in shared memory, one-warp scan",
         "source": "dmayolo_tpu_torch/csrc/nms_fixpoint.cu",
         "replaces": "experiments/exp_pallas_fixpoint.py:87",
         **launches(fixpoint_keep), **timed(k3), "library_ms": None, "shape": k3["shape"],
         **{k: k3[k] for k in ("kernel_ms", "ms_divide", "kernel_ms_divide", "plain_ms_divide",
                               "eval_shape", "eval_ms_divide", "eval_kernel_ms_divide",
                               "eval_plain_ms_divide", "eval_bound_ms", "eval_bound_by")}},
        {"name": "nms_fixpoint_blocked", "route": "cuda",
         "design": "the blocked walk in one launch, keeper list in shared memory",
         "source": "dmayolo_tpu_torch/csrc/nms_fixpoint.cu",
         "replaces": "experiments/exp_pallas_fixpoint.py:87",
         **launches(fixpoint_keep_blocked), **timed(k3b), "library_ms": None,
         "shape": k3b["shape"], "kernel_ms": k3b["kernel_ms"],
         "nms_matrix_blocked_ms": k3b["nms_ms"],
         **{k: k3b[k] for k in ("blocks_walked", "pairs", "cross_tests", "walk_all")},
         # the tools' shapes: detect's own candidates at max_det 1000, and
         # the 1080p clip's frame 0 at batch 1
         **{name: {k: res[k] for k in (
             "shape", "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "blocks_walked", "pairs", "cross_tests", "live_candidates")}
            for name, res in (("tools_detect", tp["k3_blocked"]),
                              ("tools_video_frame", tp["video"]["k3_blocked"]))}},
        {"name": "conv3x3_s1", "route": "cuda",
         "design": "implicit GEMM on wgmma with TMA loads: bf16, and f32 as 3xTF32",
         "source": "dmayolo_tpu_torch/csrc/conv3x3_s1.cu",
         "replaces": "dmayolo_tpu/nn/pallas_conv.py:75",
         **launches(conv3x3_s1), **k1_sums["bf16"], "f32": k1_sums["f32"],
         "cases": [{k: c.get(k) for k in ("shape", "dtype", "max_abs_err", "ms", "kernel_ms",
                                          "plain_ms", "library_ms", "bound_ms", "bound_by")}
                   for c in k1],
         "flagship_bs128": {k: k1f[k] for k in ("convs", "step_ms", "step_kernel_ms",
                                                 "step_library_ms", "step_bound_ms")},
         "spd_bs128": k1_spd,
         "flagship_f32_b2_max_scaled_err": k1f32["max_scaled_err"]},
    ]
    kernels += int8_kernel_entries(i8, launches)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
