#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                # needs one CUDA card

Phases, in order; any failure exits non-zero before the final line:
  1. build the CUDA kernels (K1 crop_resize, K2 warp_patches, K3
     gallery_topk, K4 gallery_topk_int8, K3 on float32 rows
     gallery_topk_f32, K5 nms_fixpoint) with nvcc, all at once (each
     source its own nvcc), and print
     what the assembler reports (registers, spills) for every list length;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving step gives it, and time kernel, plain version and a
     PyTorch yardstick (F.grid_sample; matmul + topk with the similarity
     matrix stored) beside the kernel's bound. K1 and K2 must equal their
     plain versions to the bit, there and at odd shapes (channel counts,
     non-square frames, boxes off the frame, rotations to 90 degrees, more
     faces than SMs; a patch too large for shared memory, off a 16-byte
     address or not a multiple of 16 bytes long is refused); their
     device time alone is read from torch.profiler, warm and with the L2
     cache flushed, beside the host's cost of one wrapper call. K3 and K4
     run at 128 queries x 1 048 576 gallery rows (K3 also at 64 queries),
     at one small shape and at odd ones (query counts around the tile sizes,
     a gallery that ends inside a tile, depths that end inside a K-panel,
     top_k 1 and 8, no valid row, a gallery view off a 16-byte address
     refused); the device time of their stream and merge kernels alone and
     of the query preparation around them is read from torch.profiler. K3
     on float32 rows at 128 x 1 048 576 x 512 within 1e-5 of its plain
     version, timed beside its bound (operations on CUDA cores) and a stored
     float32 matmul + topk; K3 (bf16 and float32 rows) and K4 at top_k 16
     (lists in shared memory), 33 (lists in device memory) and 64, 65,
     128, 256, 1024, 1025, 4096 and 14 528 (the pool route: a sample, a
     per-query threshold, one gather pass, one select) against their plain
     versions, each with its route, resolved and unresolved queries, peak
     memory and every kernel's device time (sample, T_q's select, gather,
     select, device lists, merge), beside the other route forced in the
     same run (the crossover at 33-256; the device lists the pool route
     replaces) and, on the pool route, every query sent on to its unresolved
     route (the same answer); both routes forced at the labeler's query
     counts (512 to 16 384 queries at top_k 64, 256 and 1024: the pool
     route in blocks of queries, held to the device lists' answer) beside
     the route `pool_pays` picks; a
     gallery whose rows tie past the pool for two
     queries (two unresolved, counted on the card); MAX_TOP_K + 1 refused
     naming the merge's shared-memory bound; K2's channel-planar output equal to its plain
     version and to the channels-last one transposed, to the bit; K5 (NMS
     from the score-sorted boxes: IoUs, conflict bits and loop on one
     thread-block cluster per frame) equal to nms_sorted_plain to the bit
     at [8, 1152], [8, 1408], [8, 256], [8, 96] and at B=1, in both modes,
     on suppression chains of depth 1, 7, 8, 9 and 64 built from boxes, one
     of every box (its loop ends at the it < n cap), an all-invalid frame
     and clustered proposals with pairs within ulps of IoU 0.7, zero-area,
     inverted, NaN and infinite boxes, and at [2, 6000] (packed rows in
     device memory); timed beside its bound (the IoUs' float32 operations
     over the valid pairs), the floor its sweeps' cluster barriers set (the
     barrier timed alone) and the torch ops it absorbs (pairwise_iou and
     the mask); nms_mask's three calls of a step traced with torch.profiler
     (no IoU elementwise kernel);
  3. the fused serving step at the server's build: ir_101 (seeded random
     weights), bf16, det_size 640x640, 16 face slots, min face 40, top-3,
     a 1024-row float32 gallery (dense match), B=8 frames composed from the
     in-repo smoke fixture. Checks detection recall against the fixture's
     ground truth, planted gallery matches, finite outputs, and that every
     step launched K1 three times, K2 once and K5 three times; times the
     step, and reads K1's and K2's device time inside the step from
     torch.profiler. From here on `process_frames` replays one CUDA graph
     per key (pipeline/step_graph.py); each gallery's graph is captured
     before a phase counts launches, and a replay adds what its capture
     recorded;
  4. 16 requests from two client threads through DeviceBatcher, each held
     against the direct step on the same frame;
  5. the same step against a DeviceGallery of 1 048 576 identities, once
     bf16 (K3) and once quantize='int8' (K4), gallery_impl='auto': planted
     rows come back top-1 and every step launched its streaming kernel
     once; one embed_budget=4 step on the int8 gallery;
  6. requests through DeviceBatcher with a GalleryManager (add, save, load)
     as the gallery provider;
  7. the HTTP server on the card, at the same build (ir_101 bf16, 640x640,
     16 face slots, batch_max 8, buckets (1, 8)), made by
     FaceRecognitionServer's constructor and served on 127.0.0.1: students
     enrolled through a GalleryManager file and POST /reload_gallery, then
     the port's own client over all three transports (base64 PNG to
     /process_frame, raw rgb24 and raw I420 to /process_frame_raw, the last
     against a server built with transport='i420'), each from one client
     (200 requests) and from four client threads at once (100 each). Every
     answer is held against a direct step of the server's engine on the
     same frame (face count, boxes within
     1 px, the enrolled students and no others, attendance.json), the launch
     counts against the steps dispatched (K1 x3, K2 x1 per step; fewer steps
     than requests under four clients), /stats against torch.cuda, bad
     requests against their 400s on a kept-alive connection. Then one server
     per compact gallery of 262 144 of phase 5's identities and the rows it
     planted, each loading one
     GalleryManager file through its constructor's gallery_path (bf16: K3
     once per step; gallery_quantize='int8': K4 once per step), 120 requests
     from one client and 60 each from four. Prints request latency
     p50/p95 as the client saw it, requests per second, steps dispatched and
     frames per step, the server monitor's own p50, the share of a request
     that is not the device step, the host stages timed alone, and the host
     cost of GalleryManager.device_snapshot;
  8. the int8 tier at the same build: MTCNNDetector(quantize='int8') and
     FaceEmbedder(quantize='int8') calibrated on their synthetic defaults.
     The int8 product (im2col + cuBLASLt s8 x s8 -> s32) at every distinct
     int8 layer shape of the step and at odd ones (fewer than 17 rows,
     K = 27, N = 28) equals its plain version (float64 sums) to the bit,
     timed apart from its im2col beside a bf16 cuDNN conv of the same shape
     and the bound by operations; the int8 step: recall, planted rows
     top-1, K1 x3 and K2 x1 per step, identical embeddings with the plain
     product, cosine against the bf16 embeddings of the same faces, p50,
     device time, embed and detect alone beside the bf16 step's; the int8
     step against 1 048 576 int8 rows (K4 once per step); one server built
     with quantize='int8' serving 200 raw rgb24 requests, every answer held
     against its direct int8 step;
  9. enrolment and offline matching with the weight formats users have:
     seeded ir_101 weights written as an AdaFace Lightning .ckpt (the port's
     save_adaface_checkpoint) and a JAX-format .npz, seeded iresnet_100
     weights as an ArcFace .onnx (an initializer-only protobuf written
     here); 8 students x 4 photos rendered with render_identity_scene (each
     checked through a bf16 FaceProcessor, K1 twice per image, timed as
     images per second), enrolled through cli/enroll_students on the card
     from the .ckpt and from the .npz (the two galleries within 1e-5);
     face_matcher --single_image and FaceMatcher.match_single_image return
     each student top-1 at confidence > 0.99; the .onnx embedder on the card
     against the CPU; FaceMatcher.match_faces_batch against 1 048 576
     identities, bf16 (K3) then int8 (K4), at top_k 5, 16 and 64: enrolled
     students top-1, one launch per search, answers equal to the plain
     version on the same compact rows; the step with gallery_impl=
     'streaming' on a float32 gallery launches K3 on float32 rows once per
     step and equals the dense step.
  10. the offline dataset and evaluation path: a classroom dataset of 48
     enrolled identities (a one-shot photo, 5 few-shot photos and 4 session
     photos each) and 48 visitors (one photo each), 528 renders of
     render_identity_scene; seeded ir_101 weights (.npz), the bf16 cascade
     with pretrained/mtcnn_synthetic.npz; through the CLIs with --device
     cuda: dataset_preprocessor (K1 twice per photo; images/s),
     lfw_impostor_helper and segment_dataset over the reviewed labels,
     embedding_generator (all seven corpus pickles with their JSON twins and
     generation_summary.json; K1 twice per gallery photo), probe_labeler
     against the 48 students (dense, against a float32 product), then
     ProbeLabeler (probe_labeler's class) against 1 048 576 identities, bf16
     (K3) and int8 (K4), at top_k 5, 65 and 1024 (the last two on the pool
     route, no query unresolved), one launch per search, labels
     and top matches equal to the plain version on the same compact rows; evaluate_models (its files, thresholds 0.20-0.90,
     max/mean/topk), and evaluate_model on the card against the CPU (scores
     within 1e-5; counts and rates differ only by decisions within 1e-5 of a
     threshold or a rival); identity_scores_batch alone at 4096 probes x
     10 000 identities x 5 x 512 within 1e-5 of float64, timed beside its
     bound; run_stress_suite over 4 categories with a bf16 cascade (K1).
     `python3 chip_smoke.py --offline-only` builds the kernels and runs this
     phase alone.
  11. training on the card: cli/train_embedder at ir_101, B=128, 1024
     synthetic classes, bf16 (30 steps with checkpoints every 10, then
     --resume to 40 with the .npz export: finite losses, the resumed run
     going from 30 to 40, 3 checkpoints kept) and at float32 (10 steps);
     the step on a fixed batch at bf16, float32 and with the int8 forward
     (p50 from CUDA events, images/s, TFLOP/s of the conv and dense work
     from their shapes, fwd + bwd = 3 x fwd, beside the peak for each
     configuration's types: 67 TFLOP/s float32, 989 bf16, the int8
     forward's res convs at 1979 TOPS and the rest at bf16's; the
     device's busy share from torch.profiler over 3 steps, peak memory);
     the SGD update alone, fused against unfused; 10 steps on one
     repeated batch (the loss falls); one float32 step at ir_18, B=16, on
     the card against the CPU from the same state, batch and mask, within
     the CPU parity tests' tolerances; the int8 forward's s32 sums at every
     res-conv shape of the step equal to the plain version's and its codes
     to the CPU's; the exported ir_101 weights in FaceEmbedder (bf16,
     folded) against the trainer's float32 eval-mode forward (cosine
     distance <= 1e-3) and in the fused serving step (K1 x3, K2 x1 per
     step); the accuracy recipe (ir_micro trained on the card, 400 steps
     at B=64 bf16, e2e_rank1 over 24 trials through bf16 processors, at
     least 0.75); train_detector(50 steps, batch 256, OHEM 0.7) with each
     net's loss falling, its weights in MTCNNDetector, and run_ood_suite
     through a bf16 cascade (K1); the fused int8 body at ir_101 against the
     unfused int8 embedder (cosine > 0.9999 in float32) and its embed time.
     `python3 chip_smoke.py --train-only` builds the kernels and runs this
     phase alone.
  12. the mesh on one card: `make_mesh(data=2)` over two entries of the
     card (one process drives a list of devices; on one card the shards run
     one after the other, so this proves the per-shard launches, the merge,
     the class-sharded head and the bucket rules, and claims no scaling).
     At phase 3's build: the dense step data parallel (12 steps, K1 x3 and
     K2 x1 per shard) and an embed_budget=4 step, each held to the
     single-device step of the same run (face_valid equal, boxes and
     landmarks within 1 px, embedding cosine >= 0.999, top-1 equal where the
     margin is clear) with their p50 beside it; phase 5's 1 048 576
     identities in two row shards of 524 288, bf16 then int8: the
     shard_gallery step launches K3 (K4) once per gallery shard, the
     replicated gallery on the mesh once per data shard, planted rows come
     back top-1, both held to the single-device step; DeviceGallery(mesh)
     .search at top_k 5 equals one device's (K3/K4 once per shard); a
     FaceRecognitionServer on the mesh engine (buckets multiples of 2)
     answers 40 raw rgb24 requests as the direct mesh step; the trainer at
     ir_101, B=128, 1024 classes, float32 on (2, 2) and (2, 1) meshes of
     the card, 3 steps each on phase 11's batch: losses within 1e-4 + 5e-4
     |loss|, parameters within 1e-3 after step 1 and 3e-3 after step 3,
     batch_stats within 5e-3; a classifier gradient scaled by 1/2 (the
     fault a class-sharded head can carry) must move step 1 by more than
     the step-1 bound plus the gap measured. Every mesh and single-device
     step of the phase runs through its engine's graphs (one per data
     shard) and is held to that engine's eager step bit for bit.
     `python3 chip_smoke.py --mesh-only`
     builds the kernels and runs phase 12 alone on phase 3's build;
     `--mesh-only --cards` makes the mesh of distinct cards (two for
     serving, four for the (2, 2) trainer).
  13. the compiled step at phase 3's build, on six routes (the dense
     1024-row gallery, 1 048 576 bf16 rows (K3), 1 048 576 int8 rows (K4),
     embed_budget=4 at rotations 0, 1, 2 and 2**28 + 3, I420 input, and
     phase 8's quantize='int8' build): an eager step under
     torch.cuda.set_sync_debug_mode("error") raises nothing; the graphs at
     B=1 and B=8 equal the eager step bit for bit on all 12 result fields;
     a torch.profiler trace of one replay holds K1 x3, K2 x1, K5 x3 and K3
     or K4 once where the gallery streams; two replays back to back leave
     the first answer, copied on a side stream, alone; eager and graph
     step p50 at B=1 and B=8 with device time and busy share; one client's
     raw rgb24 request p50 over 120 requests with the server's engine on
     its graphs and then on the eager step (bound by the script); a
     /reload_gallery followed by one request makes one capture; every
     capture's seconds and pool bytes. `python3 chip_smoke.py --graph-only`
     builds the kernels and runs phase 13 alone on phase 3's build.
  14. the open-set protocol at a small scale (`train/open_set.py`,
     `evalharness/open_set.py`): train_open_set at ir_18, 40 identities x 16
     crops, 200 steps at B=128 bf16 (finite losses, the loss at step 200
     below that at step 10) and the held-out probe once on its final state;
     run_open_set on those weights, the full 200 + 60 held-out identities
     under clean and noise, fp32 and int8 (the report's keys are the JAX
     report's, reports/openset_ir_50/report.json, every value finite); the
     weights in FaceEmbedder (bf16, folded) and in the fused serving step at
     phase 3's build through its graphs (K1 x3, K2 x1, K5 x3 per step), and
     e2e_rank1 over 24 trials with them beside phase 11's ir_micro figure; no
     accuracy floor at this size; seconds per stage.
     `python3 chip_smoke.py --openset-only [ir_50 | ir_18]` builds the
     kernels and runs the recorded recipe at full scale instead (ir_50: 360
     identities x 72 crops, 4500 steps at B=256, lr 0.1, 300 warm-up steps,
     seed 0; ir_18: 6000 steps; about half an hour on one H100): the
     weights to pretrained/<arch>_synthetic_torch.npz (+ .meta.json), the
     protocol under all six conditions and both tiers into
     reports/openset_torch_<arch>/report.json, each number beside the JAX
     report's (tests/test_torch_port_open_set.py holds the committed report
     to the floors of tests/test_open_set_trained.py), then the trained
     weights served as above; any other name after the flag is refused
     before the build.
  15. the detector's training protocol at a small scale
     (`train/detector_recipes.py`, `evalharness/detector_reports.py`):
     train_recipe of the stress and the domain-randomized recipes for 50
     steps a net, each net in its own process (losses finite and falling;
     seconds per net and os.cpu_count()); the trained tree assigned to a
     detector built on mtcnn_synthetic.npz (MTCNNDetector.variables)
     detects as one built with variables=; the base rows of both reports
     (the stress suite on mtcnn_synthetic.npz, the OOD suite on
     mtcnn_stress.npz; 12 scenes a category, float32, K5 x3 per detect),
     each number beside the committed JAX report's and within one face
     (in AP and recall 1 / the category's faces, at least 0.03; 0.25 false
     positives a scene); the trained
     tree assigned to the detector of an engine at phase 3's build whose
     graph was captured on mtcnn_dr.npz: the same graph replays (K1 x3, K2
     x1, K5 x3 per step) equal to the eager step.
     `python3 chip_smoke.py --detector-only [stress | ood | all]` builds the
     kernels and runs the recorded recipes at full scale instead (stress:
     1500 steps a net, batch 256, OHEM 0.7; DR: 2500 steps, class balance
     0.24/0.23), writing reports/detector_{stress,ood}_torch/report.json
     and pretrained/mtcnn_{stress,dr}_torch.npz (+ .meta.json), every row
     beside the JAX report's (tests/test_torch_port_detector_reports.py
     gates them with the floors); then the stress suite through a bf16
     cascade (K1 x2 per detect) of the last weights trained beside their
     float32 row, and those weights served as above beside the shipped
     mtcnn_dr.npz's recall (at least 0.8); any other name after the flag is
     refused before the build.
  16. the server as it is deployed (`serve/soak.py`): phase 3's server build
     as CLI flags (ir_101 seeded, bf16, 640x640, 16 face slots, batch_max 8,
     --transport i420, mtcnn_dr.npz), the fixture's faces enrolled among
     seeded ids to 65 536 rows with --gallery_quantize int8; the same build
     made in this process from the same flags, whose direct steps launch K1
     x3, K2 x1, K4 x1 and K5 x3 each (counted) and are the reference for
     the answers; then
     `python -m facerecognitionpipeline_tpu_torch.cli.face_recognition_server`
     under its --max_requests supervisor as a process of its own, 60 raw
     I420 requests of one fixture mosaic from one client process (spawned,
     no torch) at --max_requests 24: three worker generations with their
     own pids, every answer equal to the direct step (faces, boxes within 1
     px, the enrolled students and no others), attendance.json after
     /finalize, session.json's summed faces equal to the answers', the
     worker's RSS (/proc) and /stats device memory every 4 answers, each
     sample on a fresh connection so that no idle client holds a drain
     (each later generation's first RSS within 10% of the first's, growth per
     request below half the payload), start seconds, downtime and drain per
     recycle, the supervisor gone after SIGTERM with no worker left, the
     card's memory.used back within 1%, the supervisor holding no device
     file or memory. Each worker prints its own kernel launches since it
     was ready and the steps it dispatched on its way out (after its drain,
     or at SIGTERM); every worker's launches must be the direct step's per
     step times its steps, and the steps summed over the generations the
     requests answered: these sums are phase 16's launches.
     `python3 chip_smoke.py --soak-only [example | deployment | all]` builds
     the kernels and runs instead `examples/recycle_soak.py`'s run (ir_18,
     300 base64 PNG noise frames, --max_requests 120) and/or the
     deployment soak at full size (2 client processes, 1200 requests,
     --max_requests 400, the workers' launches held as in phase 16 but
     for the steps, which two clients share: at most one a request),
     writing reports/serving_recycle_soak_torch.json; any other name
     after the flag is refused before the build.
  17. the repo's remaining protocols cut to size
     (`evalharness/synthetic_demo.py`, `evalharness/quantize_transfer.py`,
     `train/profile.py`): on phase 11's ir_micro (kept in the run's work
     directory, build/chip_smoke/), the demo's enrolment (4 detector-aligned
     crops a identity through the float32 cascade on mtcnn_synthetic.npz),
     its 20 scenes in fp32 and with the int8 embedder calibrated on the
     enrolment crops (rank-1 at least 0.6 in both) and the drift over 32
     probes; the calibration-transfer sweep over 96 probes (brightness,
     contrast, noise; tests/test_quantize_transfer.py's bounds: contrast 0.7
     mean cosine >= 0.995 and min >= 0.97, clean mean >= 0.995, int8 rank-1
     within 0.1 of fp32 on every row), each row beside the TPU report's;
     the train step's marginal attribution at ir_18, B=128, 3 samples a
     variant (full, no_opt, fwd_train, fwd_infer, dummy_head, the conv
     stack; every key of the JAX report; the recomposed loss within
     LOSS_CHECK_TOL of the trainer's); the int8-forward probe at ir_18 with
     50 steps to converge (losses finite and falling). K5 three times a
     detect of the float32 cascade and no other kernel in the whole phase.
     `python3 chip_smoke.py --protocols-only [demo | transfer | train_profile
     | all]` builds the kernels and runs instead the JAX scripts' sizes,
     writing the committed reports: the demo with a 400-step ir_micro of its
     own into reports/synthetic_e2e_torch/ (the weights to
     pretrained/ir_micro_synthetic_torch.npz), the sweep on them into
     reports/quantize_transfer_torch/, train_profile at ir_101 / B=128 and
     the int8 probes (ir_18 200 steps, ir_101 100) into
     reports/train_profile_torch/; any other name after the flag is
     refused before the build.
  18. the serving measurements (`serve/bench.py`,
     `pipeline/budget_profile.py`), cut to size: the JAX bench's server
     (ir_101 seeded, bf16, 640 px, 16 face slots, batch_max 8, 23 students
     of seeded embeddings, the shipped detector) over --transport i420,
     driven by 1 and then 4 client processes (spawned, no torch) posting the
     bench's four seeded 720p frames and a fixture mosaic as raw I420, 8 s
     a row: requests/s, latency p50/p95, the server's own request count
     (equal to the clients'), steps, frames a step, each dispatched step's
     CUDA-event time and the share of the window the steps fill, the CPU
     seconds of the clients and of this process, the cores it may use;
     every step launched K1 x3, K2 x1, K5 x3 and nothing else (the direct
     step's count); each client's first answer to each payload equal to a
     direct step on the same canvas (faces, boxes within 1 px; the
     mosaic's at least 8 faces, from shared B=8 steps at 4 clients), and the
     mosaic posted alone too; the host ceiling (`ZeroCostEngine` on the
     card) at 4 clients for 4 s, launching nothing; the budget sweep at B=8,
     32 slots, dense and budget 8, 2 samples: embeds a step B x (budget or
     32), the budget's p50 at or below the dense step's.
     `python3 chip_smoke.py --serving-only [bench | curve | ceiling | budget
     | all]` builds the kernels and runs instead the JAX scripts' sizes: the
     bench at png, jpeg and raw over rgb and jpeg over i420, from 1, 4, 8
     and 12 clients, and raw-i420 over i420 with --quantize int8
     --embed_budget 8 from 4 and 12 (int8 products a step held to the
     build's quantized layers), 20 s a row after a 5 s settle; the curve:
     the raw-i420 server over i420 and the stub on the card, both
     listening, driven in turn from 1, 4, 8, 12, 16 and 24 clients for 12 s
     a row, three rounds (a 5 s settle before a count's first real row),
     with the median, least and most requests/s of each count and the count
     where the real curve stops climbing (its first within 0.9 of its top);
     the ceiling at 1, 4, 8 and 12 clients for 12 s with the stub on the
     CPU; the budget sweep at dense, 16, 8 and 4 with 4 samples; the rows to
     reports/serving_bench_torch/{bench,curve,ceiling,budget}.jsonl; any
     other name after the flag is refused before the build.
  19. the stage bisects (`pipeline/stage_profile.py`) at the JAX scripts'
     build (B=8, 640 px, 32 slots, ir_101 bf16), 3 chained replays a
     window, 2 windows: the fused step's stages (detect, its three stages,
     the matmul alignment beside the engine's K1+K2 one, the gate, the
     embedder, the 1024-id top-k) each its own CUDA graph, and the full
     step through the engine's graph; the detect bisect's nine cumulative
     programs; the full step at 1024 ids dense and 131 072 bf16 ids
     streaming. Every graph's replay equal to its eager call bit for bit
     (the full step to the engine's eager step); the kernels one replay
     launched: K1 x2 and K5 x3 a detect, K1 x1 and K2 x1 the alignment, K1
     x3, K2 x1 and K5 x3 the full step, K3 x1 a streaming step and no K3 or
     K4 a dense one; the sum of stages printed beside the full step.
     `python3 chip_smoke.py --profile-only [fused | detect | gallery | all]`
     builds the kernels and runs instead the JAX scripts' defaults (5
     chained replays; the fused step in bf16 and with the int8 embedder, 3
     windows; detect, 3 windows; the gallery at 1024, 131 072 and 1 048 576
     ids, dense, streaming and streaming_int8, 4 windows) with the same
     checks, writing reports/stage_profile_torch/{fused_step,
     fused_step_int8,detect,gallery_scale}.jsonl; any other name after the
     flag is refused before the build.
  20. bench.py's headline on the port (`pipeline/step_bench.py`, what
     `bench_torch.py` prints) at its build (B=8, 640 px, 32 slots, ir_101
     bf16, 1024 float32 ids, 5 chained steps a window, 8 windows by the host
     clock, fetch-ended, the round trip subtracted by bench.py's rule): the
     headline step and embed_budget=8, each through its engine's graph.
     Each route's first replay equal to its eager step on all 12 result
     fields, K1 x3, K2 x1, K5 x3 a step, its keys non-null, and its
     host-clock p50 not below the CUDA-event p50 of the same windows by more
     than the round trip over the chain (a guard of the round-trip
     correction: the events' span counts the card's waits for the host
     too). `python3 chip_smoke.py
     --bench-only` builds the kernels and runs instead every route of
     bench.py's line (the int8 embedder, full int8, budget 8 on full int8,
     1 048 576 bf16 ids with K3 and their int8 pair with K4 once a step)
     and e2e_rank1 with the port's ir_micro weights (trained first through
     the synthetic demo where pretrained/ir_micro_synthetic_torch.npz is
     absent), fails below phase 11's E2E_FLOOR or on any check above,
     prints the line and appends it to reports/bench_line_torch.jsonl.
`python3 chip_smoke.py --full-sizes` runs the default phases with phase 7's
servers on a gallery file of 1 048 576 ids and phase 11's train_detector at
100 steps, the sizes the default run's 1200 s limit cut.
Then it prints the card's name and power limit, JSON lines of phase 8's, 9's,
10's, 11's, 12's, 13's, 14's, 15's, 16's, 17's, 18's, 19's and 20's numbers, a JSON line
describing the kernels, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# what one run keeps between its phases (git-ignored, inside the checkout)
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet), used for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # CUDA cores
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
INT8_OPS_PER_S = 1979e12  # tensor cores, dense

DEVICE = "cuda"
ARCH = "ir_101"
DET_SIZE = (640, 640)
MAX_FACES = 16
BATCH = 8
GALLERY_ROWS = 1024
STEP_ITERS = 12
BIG_GALLERY_ROWS = 1 << 20
BIG_STEP_ITERS = 6
STREAM_CHUNK = 4096
K3_TOL = 2e-5  # two-part bf16 query split, float32 sums in another order
# top_k of phase 2's long lists: in shared memory (16), in device memory
# (33), on the pool route (64 = POOL_MIN_K, 65, 128, 256, 1024, 1025, 4096;
# and gallery_kernel.MAX_TOP_K, the longest the merge's shared memory holds)
LONG_TOP_KS = (16, 33, 64, 65, 128, 256, 1024, 1025, 4096)
# the labeler's query counts (ProbeLabeler sends a whole probe directory as
# one search) and top_k at which phase 2 times both routes of the long lists
LABELER_QS = (512, 1024, 2048, 4096, 16384)
LABELER_TOP_KS = (64, 256, 1024)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, match: str, iters: int = 10, flush=None):
    """Device time per call of `fn` spent in kernels whose name contains
    `match`, from torch.profiler (None where the profiler saw none). With
    `flush`, that runs before every call to evict the L2 cache; its own
    kernels do not match and are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and match in e.key
    )
    return us / iters / 1e3 if us > 0 else None


def host_enqueue_ms(fn, iters: int = 50) -> float:
    """Host-clock time of one call of `fn` with no synchronisation inside
    the loop: what the wrapper costs the host to enqueue its launch."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return ms


def resampler_times(kernel, library, plain, kernel_name: str, plain_iters: int,
                    flush) -> dict:
    """Times of one resampler call shape: kernel, library call and kernel
    again in turns (CUDA events over 20 back-to-back calls, inputs warm in
    L2 where they fit), the kernel's device time alone warm and with the
    L2 cache evicted by `flush` before every launch, and the host's enqueue
    cost."""
    ms = cuda_time_ms(kernel)
    library_ms = cuda_time_ms(library)
    return {
        "ms": ms, "library_ms": library_ms, "ms_again": cuda_time_ms(kernel),
        "plain_ms": cuda_time_ms(plain, iters=plain_iters),
        "device_ms": device_time_ms(kernel, kernel_name),
        "cold_device_ms": device_time_ms(kernel, kernel_name, flush=flush),
        "library_device_ms": device_time_ms(library, "grid_sampler"),
        "host_ms": host_enqueue_ms(kernel),
    }


def mosaics(fixture: dict, n: int):
    """n 640x640 frames, each a 4x4 mosaic of the 16 fixture tiles (rolled
    by the frame index), with their ground-truth boxes."""
    import numpy as np

    tiles, boxes, counts = fixture["tiles"], fixture["boxes"], fixture["counts"]
    t = tiles.shape[1]
    frames = np.zeros((n, 4 * t, 4 * t, 3), np.uint8)
    gts = []
    for f in range(n):
        gt = []
        for p in range(16):
            i = (p + f) % 16
            r, c = divmod(p, 4)
            frames[f, r * t:(r + 1) * t, c * t:(c + 1) * t] = tiles[i]
            off = np.array([c * t, r * t, c * t, r * t], np.float32)
            gt.extend(boxes[i, j] + off for j in range(counts[i]))
        gts.append(np.array(gt, np.float32))
    return frames, gts


def iou(a, b):
    import numpy as np

    x1 = np.maximum(a[0], b[:, 0])
    y1 = np.maximum(a[1], b[:, 1])
    x2 = np.minimum(a[2], b[:, 2])
    y2 = np.minimum(a[3], b[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = lambda z: (z[..., 2] - z[..., 0]) * (z[..., 3] - z[..., 1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def detection_recall(out, gts):
    """Recall of a step's detections against the fixture's ground truth at
    IoU >= 0.5: (recall, hits, faces)."""
    valid = out["face_valid"].cpu().numpy()
    boxes = out["bboxes"].cpu().numpy()
    hits = total = 0
    for f in range(len(gts)):
        pb = boxes[f][valid[f]]
        for gt in gts[f]:
            total += 1
            hits += bool(len(pb)) and float(iou(gt, pb).max()) >= 0.5
    return hits / total, hits, total


def grid_for_boxes(boxes, k, h, w):
    """F.grid_sample grid [B, N*k, k, 2] sampling each box like K1."""
    import torch

    t = (torch.arange(k, device=boxes.device, dtype=torch.float32) + 0.5) / k
    x1, y1, x2, y2 = boxes.unbind(-1)
    px = x1[..., None] + (x2 - x1)[..., None] * t - 0.5  # [B,N,k]
    py = y1[..., None] + (y2 - y1)[..., None] * t - 0.5
    gx = (px + 0.5) / w * 2 - 1
    gy = (py + 0.5) / h * 2 - 1
    b, n = boxes.shape[:2]
    grid = torch.stack(
        [gx[:, :, None, :].expand(b, n, k, k), gy[:, :, :, None].expand(b, n, k, k)],
        dim=-1,
    )
    return grid.reshape(b, n * k, k, 2)


def grid_for_coeffs(coeffs, k, oh, ow):
    """F.grid_sample grid [F, oh, ow, 2] sampling each patch like K2."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import _pixel_coords

    px, py = _pixel_coords(coeffs, oh, ow)
    gx = (px + 0.5) / k * 2 - 1
    gy = (py + 0.5) / k * 2 - 1
    return torch.stack([gx, gy], dim=-1).reshape(-1, oh, ow, 2)


def kernel_phase(fixture) -> dict:
    """Phase 2: kernels vs plain versions at the serving step's shapes (held
    to max |kernel - plain| = 0) and at odd shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
        crop_resize_kernel,
        crop_resize_plain,
    )
    from facerecognitionpipeline_tpu_torch.ops.warp import (
        reference_template,
        similarity_transform,
        warp_coeffs,
    )
    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
        warp_patches_kernel,
        warp_patches_plain,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(0)
    frames_u8, _ = mosaics(fixture, BATCH)
    frames = torch.from_numpy(frames_u8).to(dev).float()  # raw 0..255
    img = (frames - 127.5) / 128.0  # the cascade's normalized frame
    h, w = DET_SIZE

    def rand_boxes(n, size_lo, size_hi, extent):
        side = size_lo + (size_hi - size_lo) * torch.rand((BATCH, n), generator=g)
        x1 = -8 + (extent - side + 16) * torch.rand((BATCH, n), generator=g)
        y1 = -8 + (extent - side + 16) * torch.rand((BATCH, n), generator=g)
        return torch.stack([x1, y1, x1 + side, y1 + side], -1).to(dev)

    # alignment stage A: integer-snapped windows from the fixture's faces
    lm = np.zeros((BATCH, MAX_FACES, 5, 2), np.float32)
    for f in range(BATCH):
        for p in range(16):
            i = (p + f) % 16
            r, c = divmod(p, 4)
            lm[f, p] = fixture["landmarks"][i, 0] + np.array([c * 160, r * 160])
    mats = similarity_transform(
        torch.from_numpy(lm).to(dev).reshape(-1, 5, 2),
        torch.from_numpy(reference_template(112)).to(dev),
    )
    align_boxes, coeffs = warp_coeffs(mats, 112, 112, 128)

    small = crop_resize_plain(
        img, img.new_tensor([0.0, 0.0, w, h]).expand(BATCH, 1, 4), h // 2
    )[:, 0].contiguous()
    k1_cases = [
        # (label, frames, boxes, k, tolerance)
        ("rnet k=24", small, rand_boxes(256, 12.0, 160.0, h // 2), 24, 0.0),
        ("onet k=48", img, rand_boxes(96, 24.0, 320.0, h), 48, 0.0),
        ("align_a k=128", frames, align_boxes.reshape(BATCH, MAX_FACES, 4), 128, 0.0),
    ]
    report = {"crop_resize": [], "warp_patches": []}
    patches = None
    # five times the 50 MB L2: reading and writing it evicts what was there
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.add_(1)  # noqa: E731
    for label, src, boxes, k, tol in k1_cases:
        out = crop_resize_kernel(src, boxes, k)
        ref = crop_resize_plain(src, boxes, k)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        print(f"[kernels] K1 crop_resize {label}: frames {tuple(src.shape)} boxes "
              f"{tuple(boxes.shape)} max|kernel-plain| {err:.3g} (tol {tol:g})")
        if not err <= tol or not torch.isfinite(out).all():
            fail(f"K1 {label} disagrees with its plain version: {err}")
        if label.startswith("align_a"):
            patches = out.reshape(-1, 128, 128, 3)
        hh, ww = src.shape[1:3]
        nbytes = 4 * (src.numel() + boxes.numel() + out.numel())
        flops = out.numel() * 12  # 2 columns x (2 row taps x mul+add, mul+add)
        src_nchw = src.permute(0, 3, 1, 2).contiguous()
        grid = grid_for_boxes(boxes, k, hh, ww)
        report["crop_resize"].append({
            "shape": label, "err": err,
            **resampler_times(
                lambda: crop_resize_kernel(src, boxes, k),
                lambda: F.grid_sample(src_nchw, grid, align_corners=False),
                lambda: crop_resize_plain(src, boxes, k),
                "crop_resize", plain_iters=5, flush=flush,
            ),
            "bytes": nbytes, "flops": flops, "peak": F32_FLOPS_PER_S,
        })

    tol = 0.0  # every sum has at most two exact products: equal to the bit
    out = warp_patches_kernel(patches, coeffs, 112, 112)
    ref = warp_patches_plain(patches, coeffs, 112, 112)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    print(f"[kernels] K2 warp_patches: patches {tuple(patches.shape)} coeffs "
          f"{tuple(coeffs.shape)} max|kernel-plain| {err:.3g} (tol {tol:g})")
    if not err <= tol or not torch.isfinite(out).all():
        fail(f"K2 disagrees with its plain version: {err}")
    p_nchw = patches.permute(0, 3, 1, 2).contiguous()
    grid = grid_for_coeffs(coeffs, 128, 112, 112)
    report["warp_patches"].append({
        "shape": "align_b 128->112", "err": err,
        **resampler_times(
            lambda: warp_patches_kernel(patches, coeffs, 112, 112),
            lambda: F.grid_sample(p_nchw, grid, align_corners=False),
            lambda: warp_patches_plain(patches, coeffs, 112, 112),
            "warp_patches", plain_iters=3, flush=flush,
        ),
        "bytes": 4 * (patches.numel() + coeffs.numel() + out.numel()),
        "flops": out.numel() * 12, "peak": F32_FLOPS_PER_S,
    })
    # the channel-planar output [F,C,112,112] of the same warp
    out_p = warp_patches_kernel(patches, coeffs, 112, 112, planar=True)
    ref_p = warp_patches_plain(patches, coeffs, 112, 112, planar=True)
    torch.cuda.synchronize()
    if not (torch.equal(out_p, ref_p) and torch.equal(out_p, out.permute(0, 3, 1, 2))):
        fail(f"K2 planar disagrees with its plain version "
             f"({float((out_p - ref_p).abs().max())}) or with its channels-last output")
    print(f"[kernels] K2 warp_patches planar=True: out {tuple(out_p.shape)} equal to its plain "
          f"version and to the channels-last output transposed, to the bit")
    print_bounds(report, "F.grid_sample")
    odd_shape_phase()
    report["nms_fixpoint"] = nms_kernel_phase()
    return report


# stage 1 of the server build (9 scales x 128 proposals at 640x640, min face
# 40) and at the default min face 20 (11 scales), stages 2 and 3 (mode min),
# at B=8 and at the server's B=1 bucket; each also checked in the other mode
NMS_SHAPES = ((BATCH, 1152, "union"), (BATCH, 1408, "union"), (BATCH, 256, "union"),
              (BATCH, 96, "min"), (1, 1152, "union"), (1, 256, "union"), (1, 96, "min"))
NMS_STEP = ((1152, "union"), (256, "union"), (96, "min"))  # the three calls of one step
NMS_DEPTHS = (1, 7, 8, 9, 64)  # suppression chains, in sweeps to converge
NMS_THR = 0.7
NMS_SCRATCH_SHAPE = (2, 6000)  # packed rows past a block's shared memory: device scratch
IOU_FLOPS = 14  # float32 operations of one IoU and its threshold (csrc/nms_fixpoint.cu)


def nms_sweeps(boxes, v, mode) -> int:
    """Sweeps the NMS loop runs on these inputs (the slowest element's,
    as the batched plain loop runs them)."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.nms_kernel import pairwise_iou

    n = v.shape[-1]
    idx = torch.arange(n, device=v.device)
    conflict = (pairwise_iou(boxes, mode) > NMS_THR) & (idx[None, :] < idx[:, None])

    def sweep(keep):
        return v & ~(conflict & keep[..., None, :]).any(dim=-1)

    keep, prev, sweeps = sweep(v), v, 1
    for _ in range(6):
        keep, prev, sweeps = sweep(keep), keep, sweeps + 1
    while sweeps < n and bool((keep != prev).any()):
        keep, prev, sweeps = sweep(sweep(keep)), keep, sweeps + 2
    return sweeps


def nms_edge_boxes(mode: str):
    """Boxes at the edges of the IoU's arithmetic (numpy float32 [m, 4],
    each pair 20 px from the next): 16 pairs whose IoU lies within a few
    ulps of 0.7 on either side (a box 10 px wide and one shifted by t, t
    stepped by ulps around the IoU's root), a zero-area and an inverted box
    over a third box, a NaN coordinate, and two boxes reaching infinity
    (inf - inf: NaN inside the IoU)."""
    import numpy as np

    root = np.float32(3.0 if mode == "min" else 30.0 / 17.0)  # IoU(t) = 0.7
    out = []
    for k in range(16):
        t = root
        for _ in range(abs(k - 8)):
            t = np.nextafter(t, np.float32(np.inf if k > 8 else -np.inf))
        y = np.float32(20 * k)
        out += [(0, y, 10, y + 10), (t, y, t + 10, y + 10)]
    y = 400
    out += [(0, y, 10, y + 10), (3, y, 3, y + 10), (8, y, 2, y + 10),
            (np.nan, y, 10, y + 10), (-np.inf, y, np.inf, y + 10),
            (-np.inf, y + 2, np.inf, y + 8)]
    return np.array(out, np.float32)


def nms_sorted_inputs(b: int, n: int, seed: int, mode: str):
    """What nms_mask hands K5 for b frames of n proposals in clusters of
    jittered boxes, as the cascade's stages see them: score-sorted boxes
    [b, n, 4] and v [b, n] on the card. The last frame's last slots hold
    `nms_edge_boxes`, valid."""
    import torch

    g = torch.Generator().manual_seed(seed)
    centres = torch.rand((b, n // 8 + 1, 2), generator=g) * 600 + 20
    pick = torch.randint(0, centres.shape[1], (b, n), generator=g)
    c = torch.gather(centres, 1, pick[..., None].expand(b, n, 2))
    side = 20 + 60 * torch.rand((b, n, 1), generator=g)
    c = c + 4 * torch.randn((b, n, 2), generator=g)
    boxes = torch.cat([c - side / 2, c + side / 2], -1)
    scores = torch.rand((b, n), generator=g)
    valid = scores > 0.3
    masked = torch.where(valid, scores, torch.full_like(scores, -1e9))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    sb = torch.gather(boxes, -2, order[..., None].expand(b, n, 4))
    v = torch.gather(valid, -1, order)
    edge = torch.from_numpy(nms_edge_boxes(mode))[:n]
    sb[-1, n - len(edge):] = edge + 1000.0
    v[-1, n - len(edge):] = True
    return sb.to(DEVICE), v.to(DEVICE)


def nms_chains(b: int, n: int, mode: str):
    """Sorted boxes built to converge at known depths: in frame e a chain of
    NMS_DEPTHS[e] boxes (each 10 px wide, shifted so that only neighbours
    conflict in this mode) at slots spread over the n, the other slots
    valid boxes apart from everything; then one chain of all n boxes (the
    loop ends at its `it < n` cap), one frame with no valid box, and the
    rest `nms_sorted_inputs`. Returns (boxes, v, depths)."""
    import numpy as np
    import torch

    boxes, v = nms_sorted_inputs(b, n, seed=n, mode=mode)
    boxes, v = boxes.cpu(), v.cpu()
    step = 2.5 if mode == "min" else 1.25
    s = np.arange(n)
    apart = np.stack([20 * (s % 64), 100 + 20 * (s // 64), 20 * (s % 64) + 10,
                      110 + 20 * (s // 64)], 1).astype(np.float32)
    depths = [d for d in NMS_DEPTHS if d <= n] + [n]
    depths = depths[:b - 1]
    for e, d in enumerate(depths):
        frame = apart.copy()
        pos = np.round(np.linspace(0, n - 1, d)).astype(int)
        k = np.arange(d, dtype=np.float32)
        frame[pos] = np.stack([step * k, 0 * k, step * k + 10, 0 * k + 10], 1)
        boxes[e] = torch.from_numpy(frame)
        v[e] = True
    v[len(depths)] = False
    return boxes.to(DEVICE), v.to(DEVICE), depths


def nms_barrier_us(cluster: int, threads: int, frames: int) -> float:
    """Device microseconds of one cluster barrier of `frames` clusters of
    `cluster` blocks (the probe in csrc/nms_fixpoint.cu: a kernel of 1 and
    of 1001 barriers, timed with CUDA events; their difference / 1000)."""
    import ctypes

    import torch

    from facerecognitionpipeline_tpu_torch.ops import cuda_build

    fn = cuda_build.function("nms_fixpoint", "frp_nms_barrier_probe",
                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def run(iters):
        rc = fn(frames, cluster, threads, iters, stream)
        if rc != 0:
            fail(f"the cluster barrier probe did not launch (cudaError {rc})")

    return 1e3 * (cuda_time_ms(lambda: run(1001)) - cuda_time_ms(lambda: run(1))) / 1000


# kernels of the IoU and the conflict mask as torch runs them (pairwise_iou,
# the threshold, the below-diagonal mask; not its arange, which torch's
# stable sort launches too): none may run in nms_mask on the card
NMS_ABSORBED_KERNELS = ("maximum_kernel", "minimum_kernel", "clamp_min", "div_true",
                        "DivFunctor", "CompareFunctor", "BitwiseAndFunctor", "MulFunctor",
                        "CUDAFunctor_add")


def nms_layer_trace() -> dict:
    """nms_mask's three calls of one B=8 step of the server build (stage 1
    union, stage 2 union, stage 3 min; masked score, sort, gathers, K5,
    scatter) on clustered proposals, under torch.profiler: the layer's device
    ms per step, K5's share, and every kernel name, none of them one of the
    IoU's elementwise ops (NMS_ABSORBED_KERNELS)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from facerecognitionpipeline_tpu_torch.ops.nms import nms_mask

    calls = []
    for n, mode in NMS_STEP:
        g = torch.Generator().manual_seed(n)
        boxes, _ = nms_sorted_inputs(BATCH, n, seed=n, mode=mode)
        scores = torch.rand((BATCH, n), generator=g).to(DEVICE)
        calls.append((boxes, scores, scores > 0.3, mode))

    def layer():
        return [nms_mask(bx, sc, va, NMS_THR, mode) for bx, sc, va, mode in calls]

    iters = 10
    layer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            layer()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    absorbed = [k for k in kernels if any(a in k for a in NMS_ABSORBED_KERNELS)]
    if absorbed:
        fail(f"nms_mask on the card ran the IoU's elementwise kernels: {absorbed[:4]}")
    # the names do catch those ops: the plain conflict mask runs them
    from facerecognitionpipeline_tpu_torch.ops.nms_kernel import pairwise_iou

    boxes, _, _, mode = calls[0]
    idx = torch.arange(boxes.shape[-2], device=DEVICE)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (pairwise_iou(boxes, mode) > NMS_THR) & (idx[None, :] < idx[:, None])
        torch.cuda.synchronize()
    seen = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    caught = sorted({a for a in NMS_ABSORBED_KERNELS for k in seen if a in k})
    if len(caught) < 4:
        fail(f"the absorbed-kernel names match only {caught} of the plain mask's kernels "
             f"{sorted(k[:60] for k in seen)}")
    total = sum(kernels.values()) / iters / 1e3
    k5 = sum(v for k, v in kernels.items() if "nms_fixpoint" in k) / iters / 1e3
    print(f"[timing] nms_mask, the three calls of a B={BATCH} step: {total:.4f} ms of device "
          f"time, K5 {k5:.4f} of it; {len(kernels)} kernel names, none of the IoU's "
          f"elementwise ops: {sorted(k[:60] for k in kernels)}")
    return {"device_ms": total, "k5_device_ms": k5, "kernel_names": len(kernels),
            "names_caught_in_the_plain_mask": caught}


def nms_clusters_fit(geo) -> int:
    """How many clusters of K5's geometry `geo` the card holds at once
    (cudaOccupancyMaxActiveClusters, through csrc/nms_fixpoint.cu)."""
    import ctypes

    from facerecognitionpipeline_tpu_torch.ops import cuda_build

    fn = cuda_build.function("nms_fixpoint", "frp_nms_max_clusters", [ctypes.c_int] * 4)
    n = fn(geo.cluster, geo.threads, geo.smem_bytes, int(geo.rows_in_smem))
    if n < 0:
        fail(f"cudaOccupancyMaxActiveClusters failed for K5's geometry {geo} (cudaError {-n})")
    return n


def nms_kernel_phase() -> list:
    """K5 against its plain version (bit for bit) at every stage shape and
    in both modes: on chains of known depth, at the `it < n` cap, on an
    all-invalid frame, on clustered proposals with boxes at the edges of the
    IoU's arithmetic; at a shape whose rows take the device scratch. Timed
    on clustered proposals beside its bound, the floor its sweeps' barriers
    set, and the torch ops it absorbs (pairwise_iou and the conflict mask)."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.nms_kernel import (
        nms_launch_geometry,
        nms_sorted_kernel,
        nms_sorted_plain,
        pairwise_iou,
    )

    def check(boxes, v, mode, what):
        got = nms_sorted_kernel(boxes, v, NMS_THR, mode)
        want = nms_sorted_plain(boxes, v, NMS_THR, mode)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).any(dim=-1).nonzero().flatten().tolist()
            fail(f"K5 {what} disagrees with its plain version in frames {bad}")
        return got

    rows = []
    for b, n, step_mode in NMS_SHAPES:
        for mode in ("union", "min"):
            what = f"[{b}, {n}] {mode}"
            if b > 1:
                boxes, v, depths = nms_chains(b, n, mode)
                got = check(boxes, v, mode, f"{what} (chains)")
                for e, d in enumerate(depths):
                    if int(got[e].sum()) != (n - d) + (d + 1) // 2:
                        fail(f"K5 {what}: a chain of {d} kept {int(got[e].sum())} boxes")
            check(*nms_sorted_inputs(b, n, seed=7 * n + b, mode=mode), mode,
                  f"{what} (clustered, edge boxes)")
        geo = nms_launch_geometry(b, n)
        print(f"[kernels] K5 nms_fixpoint [{b}, {n}]: equal to its plain version to the bit in "
              f"both modes on {'chains of depth ' + str(depths) + ' (the last at the it < n cap), an all-invalid frame and ' if b > 1 else ''}"
              f"clustered proposals with boxes at the IoU's edges; cluster of {geo.cluster} "
              f"blocks x {geo.threads} threads per frame, packed rows "
              f"{'in shared memory' if geo.rows_in_smem else 'in device memory'}, "
              f"{geo.smem_bytes} bytes of shared memory")
        boxes, v = nms_sorted_inputs(b, n, seed=7 * n + b, mode=step_mode)
        idx = torch.arange(n, device=DEVICE)

        def absorbed(boxes=boxes, mode=step_mode, idx=idx):
            return (pairwise_iou(boxes, mode) > NMS_THR) & (idx[None, :] < idx[:, None])

        def kernel(boxes=boxes, v=v, mode=step_mode):
            return nms_sorted_kernel(boxes, v, NMS_THR, mode)

        sweeps = nms_sweeps(boxes, v, step_mode)
        # clusters of this geometry the card holds at once, and of the same
        # cluster with 1024-thread blocks (one block per SM; the threads do
        # not enter the shared memory)
        wide = geo._replace(threads=1024)
        fit = [nms_clusters_fit(g) for g in (geo, wide)]
        rows.append({
            "shape": f"[{b}, {n}]", "mode": step_mode, "err": 0.0,
            "in_step": b == BATCH and (n, step_mode) in NMS_STEP,
            "cluster": geo.cluster, "threads": geo.threads,
            "ms": cuda_time_ms(kernel),
            "plain_ms": cuda_time_ms(lambda: nms_sorted_plain(boxes, v, NMS_THR, step_mode),
                                     iters=5),
            "device_ms": device_time_ms(kernel, "nms_fixpoint"),
            "absorbed_ms": cuda_time_ms(absorbed),
            "absorbed_device_ms": device_time_ms(absorbed, ""),
            "library_ms": None, "sweeps": sweeps,
            "barrier_us": nms_barrier_us(geo.cluster, geo.threads, b),
            "clusters_fit": fit[0], "clusters_fit_1024_threads": fit[1],
            # boxes and v read once, keep written once: 18 bytes per box;
            # IOU_FLOPS per pair j < i of valid boxes (what this data needs:
            # no other pair can suppress)
            "bytes": 18 * b * n,
            "flops": IOU_FLOPS * sum(k * (k - 1) // 2 for k in v.sum(-1).tolist()),
            "peak": F32_FLOPS_PER_S,
        })
    b, n = NMS_SCRATCH_SHAPE
    for mode in ("union", "min"):
        check(*nms_sorted_inputs(b, n, seed=n, mode=mode), mode, f"[{b}, {n}] {mode}")
    geo = nms_launch_geometry(b, n)
    if geo.rows_in_smem:
        fail(f"K5 at [{b}, {n}] was meant to take the device scratch")
    print(f"[kernels] K5 nms_fixpoint [{b}, {n}]: equal to its plain version to the bit in both "
          f"modes with the packed rows in device memory (cluster of {geo.cluster} x "
          f"{geo.threads})")
    nms_layer = nms_layer_trace()
    for r in rows:
        r["layer"] = nms_layer
        by_bytes = r["bytes"] / HBM_BYTES_PER_S
        by_ops = r["flops"] / r["peak"]
        r["bound_ms"] = 1e3 * max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        # the chain of sweeps: one cluster barrier each, and one before them
        r["sweep_floor_ms"] = (r["sweeps"] + 1) * r["barrier_us"] / 1e3
        dev_ms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        print(f"[timing] nms_fixpoint {r['shape']} {r['mode']} ({r['sweeps']} sweeps, cluster "
              f"{r['cluster']} x {r['threads']}): kernel {r['ms']:.4f} ms (device time alone "
              f"{dev_ms}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}; the sweeps' "
              f"barriers {r['sweep_floor_ms']:.4f} ms at {r['barrier_us']:.3f} us each), plain "
              f"{r['plain_ms']:.4f} ms; the torch ops it absorbs (pairwise_iou + mask) "
              f"{r['absorbed_ms']:.4f} ms (device {r['absorbed_device_ms']}); no library call "
              f"computes it; {r['clusters_fit']} such clusters fit the card at once "
              f"({r['clusters_fit_1024_threads']} with 1024-thread blocks)")
    return rows


def rotation_coeffs(n: int, k: int, out: int, max_deg: float, g, shift: float = 0.0):
    """[n,6] coefficients that rotate an out x out face about the centre of
    a k x k patch by angles spread over [-max_deg, max_deg], scaled so the
    face covers most of the patch, and moved by `shift` patch pixels."""
    import math

    import torch

    th = torch.linspace(-max_deg, max_deg, n) * (math.pi / 180.0)
    sc = (k / out) * (0.8 + 0.2 * torch.rand(n, generator=g))
    a0, a1 = sc * torch.cos(th), -sc * torch.sin(th)
    b0, b1 = sc * torch.sin(th), sc * torch.cos(th)
    mid = (out - 1) / 2.0
    a2 = (k - 1) / 2.0 - (a0 + a1) * mid + shift
    b2 = (k - 1) / 2.0 - (b0 + b1) * mid + shift
    return torch.stack([a0, a1, a2, b0, b1, b2], dim=1).float()


def odd_shape_phase() -> None:
    """Phase 2, the shapes the serving step does not use: every one must
    equal its plain version to the bit (K2's shapes take both of its store
    paths), and K2 must refuse the patches its bulk copy cannot take."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
        crop_resize_kernel,
        crop_resize_plain,
    )
    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
        warp_patches_kernel,
        warp_patches_plain,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(3)

    def frames(b, h, w, c):
        return (255 * torch.rand((b, h, w, c), generator=g)).to(dev)

    def boxes(b, n, h, w):
        x1 = -6 + (w - 2) * torch.rand((b, n), generator=g)
        y1 = -6 + (h - 2) * torch.rand((b, n), generator=g)
        bw = 3 + w * torch.rand((b, n), generator=g)
        bh = 3 + h * torch.rand((b, n), generator=g)
        return torch.stack([x1, y1, x1 + bw, y1 + bh], -1).to(dev)

    edge = torch.tensor([[
        [-50.0, -50.0, -10.0, -10.0],  # wholly outside, up and left
        [70.0, 10.0, 90.0, 30.0],  # wholly outside, to the right
        [-7.5, -3.25, 20.0, 18.0],  # hangs over two edges
        [40.0, 30.0, 70.5, 55.0],  # hangs over the other two
        [30.0, 20.0, 10.0, 5.0],  # degenerate: x2 < x1, y2 < y1
        [-1e30, -1e30, 1e30, 1e30],  # far larger than the frame
        [8.0, 4.0, 32.0, 28.0],  # an integer 24-pixel window
    ]]).to(dev)
    k1_cases = [
        ("k=7 C=3, 33x45 frames", frames(2, 33, 45, 3), None, 7),
        ("C=1", frames(2, 40, 56, 1), None, 12),
        ("C=4", frames(1, 24, 31, 4), None, 8),
        ("N=1", frames(3, 64, 64, 3), 1, 24),
        ("boxes outside, degenerate, integer window", frames(1, 48, 64, 3), edge, 24),
    ]
    for label, src, bx, k in k1_cases:
        b, h, w, c = src.shape
        if bx is None or isinstance(bx, int):
            bx = boxes(b, bx or 5, h, w)
        ref = crop_resize_plain(src, bx, k)
        out = crop_resize_kernel(src, bx, k)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if err != 0.0 or not torch.isfinite(out).all():
            fail(f"K1 odd shape '{label}': max|kernel-plain| {err}")
        if bx is edge:  # the integer window is a pixel copy of bf16(frame)
            want = src[0, 4:28, 8:32].to(torch.bfloat16).float()
            if not torch.equal(out[0, 6], want) or float(out[0, :2].abs().max()) != 0.0:
                fail("K1: the integer window is not a copy, or an outside box is not 0")
    print(f"[kernels] K1 crop_resize: {len(k1_cases)} odd shapes equal their plain "
          f"version to the bit")

    def patches(f, k, c):
        return (255 * torch.rand((f, k, k, c), generator=g)).to(dev)

    unaligned = torch.empty(2 * 16 * 16 * 3 + 1, device=dev)
    unaligned[1:] = patches(2, 16, 3).reshape(-1)
    k2_cases = [
        # (label, patches, coeffs, out size)
        ("128->112, rotations to 90 deg", patches(16, 128, 3),
         rotation_coeffs(16, 128, 112, 90.0, g), 112),
        ("128->112, pixels outside the patch", patches(8, 128, 3),
         rotation_coeffs(8, 128, 112, 30.0, g, shift=-40.0), 112),
        ("K=64", patches(4, 64, 3), rotation_coeffs(4, 64, 112, 20.0, g), 112),
        ("F=1", patches(1, 128, 3), rotation_coeffs(1, 128, 112, 10.0, g), 112),
        ("F=130", patches(130, 128, 3), rotation_coeffs(130, 128, 112, 45.0, g), 112),
        ("K=8 C=3 -> 5x5 (75 floats per face: direct stores)", patches(3, 8, 3),
         rotation_coeffs(3, 8, 5, 15.0, g), 5),
        ("C=1 -> 27x27 (direct stores)", patches(2, 32, 1),
         rotation_coeffs(2, 32, 27, 25.0, g), 27),
        ("C=4", patches(2, 32, 4), rotation_coeffs(2, 32, 28, 25.0, g), 28),
    ]
    for label, pt, cf, o in k2_cases:
        cf = cf.to(dev)
        ref = warp_patches_plain(pt, cf, o, o)
        out = warp_patches_kernel(pt, cf, o, o)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if err != 0.0 or not torch.isfinite(out).all():
            fail(f"K2 odd shape '{label}': max|kernel-plain| {err}")
    refused = [
        # (label, patches, out size, what the message must name)
        ("a 160x160x3 patch", patches(1, 160, 3), 112, "shared memory"),
        ("a patch off a 16-byte address", unaligned[1:].view(2, 16, 16, 3), 12,
         "16-byte address"),
        ("a 7x7x3 patch (588 bytes)", patches(3, 7, 3), 5, "multiple of 16 bytes"),
    ]
    for label, pt, o, names in refused:
        cf = rotation_coeffs(pt.shape[0], pt.shape[1], o, 5.0, g).to(dev)
        try:
            warp_patches_kernel(pt, cf, o, o)
        except ValueError as e:
            if names not in str(e):
                fail(f"K2 refused {label} without naming the rule: {e}")
        else:
            fail(f"K2 took {label}, which its kernel cannot")
    print(f"[kernels] K2 warp_patches: {len(k2_cases)} odd shapes equal their plain "
          f"version to the bit; refused: {', '.join(r[0] for r in refused)}")


def print_bounds(report: dict, library: str) -> None:
    """Fill each row's bound (the larger of bytes over the memory rate and
    operations over the peak rate for their type) and print its times."""
    for name, rows in report.items():
        for r in rows:
            by_bytes = r["bytes"] / HBM_BYTES_PER_S
            by_ops = r["flops"] / r["peak"]
            r["bound_ms"] = 1e3 * max(by_bytes, by_ops)
            r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
            print(f"[timing] {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, {library} {r['library_ms']:.4f} ms")
            if r.get("lists_bytes"):
                # the bound above counts the device lists' traffic, which is
                # the design's; the top-k function itself moves the rest
                own = (r["bytes"] - r["lists_bytes"]) / HBM_BYTES_PER_S
                print(f"[timing] {name} {r['shape']}: bound of the function without "
                      f"the lists' bytes {1e3 * max(own, by_ops):.4f} ms")
            if "device_ms" in r:
                def ms(v):
                    return "not measured" if v is None else f"{v:.4f} ms"

                print(f"[timing] {name} {r['shape']}: kernel again after the library "
                      f"call {r['ms_again']:.4f} ms; device time of the kernel alone "
                      f"{ms(r['device_ms'])} warm in L2, {ms(r['cold_device_ms'])} with "
                      f"L2 flushed before each launch ({library} alone "
                      f"{ms(r['library_device_ms'])}); host enqueue {r['host_ms']:.4f} ms "
                      f"per wrapper call")


def print_build_report(name: str, log: str) -> None:
    """What `-Xptxas -v` said of each kernel of one library: registers,
    shared memory, stack and spills. A spill in a streaming kernel (its
    accumulators live in registers) is printed as a warning."""
    entry = "?"
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((n for n in ("stream_topk_kernel", "merge_topk_kernel",
                                      "merge_lists_kernel", "crop_resize", "warp_patches",
                                      "nms_fixpoint_kernel", "barrier_probe_kernel")
                          if n in mangled), mangled)
            if entry == "nms_fixpoint_kernel":  # its two routes
                entry += "<rows in shared memory>" if "ILb1E" in mangled else "<rows in scratch>"
            kind = re.search(r"(Bf16|Int8|F32)Traits", mangled)
            length = re.search(r"TraitsELi(\d+)E", mangled)
            if kind:
                entry += f"<{kind.group(1).lower()}"
            if length:  # the list length this instance of the kernel keeps
                n = length.group(1)
                entry += ", lists in device memory>" if n == "0" else f", list of {n}>"
        elif "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {name} {entry}: {line.replace('ptxas info    : ', '')}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line \
                    and entry.startswith("stream_topk"):
                print(f"[build] WARNING: {name} {entry} spills registers: {line}")
        elif "warning" in line.lower():
            print(f"[build] {name}: {line}")


def make_gallery(rows: int, seed: int = 0):
    """rows x 512 float32 unit rows on the card, from a seed."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t = torch.randn((rows, 512), generator=g, device=DEVICE)
    t /= torch.linalg.vector_norm(t, dim=1, keepdim=True)
    return t


def gallery_kernel_phase(gal) -> dict:
    """Phase 2, K3 and K4: the streaming top-k kernels against their plain
    versions at the serving shape (128 queries x the whole gallery, k=3)
    and at one small odd shape (1 query, k=8, 8192 rows)."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    big = gal.shape[0]
    n_bad = 1000
    dup_lo, dup_hi = 100, big - 300_000  # two exact duplicate rows
    t = gal.clone()
    t[-n_bad:] = 0
    t[dup_hi] = t[dup_lo]
    valid = torch.ones(big, dtype=torch.bool, device=DEVICE)
    valid[-n_bad:] = False
    g = torch.Generator(device=DEVICE).manual_seed(1)
    queries = torch.randn((128, 512), generator=g, device=DEVICE)
    rows_q = [dup_lo] + [5 + 131_071 * i for i in range(1, 8)]
    queries[:8] = t[rows_q] * 3.0  # eight queries equal to gallery rows
    tb = t.to(torch.bfloat16)
    codes, scales = gk.quantize_templates(t)

    def agree(label, kv, ki, pv, pi, tol):
        """Values within tol; indices equal on the clear slots, those whose
        neighbours in the plain version lie more than 2 tol away. The plain
        version may hold one entry more than the kernel's k: then the last
        slot's neighbour below is known too (else it counts as clear)."""
        k = kv.shape[1]
        gap = (pv[:, :-1] - pv[:, 1:]).abs() > 2 * tol
        clear = torch.ones_like(pi, dtype=torch.bool)
        clear[:, :-1] &= gap
        clear[:, 1:] &= gap
        pv, pi, clear = pv[:, :k], pi[:, :k], clear[:, :k]
        err = float((kv - pv).abs().max())
        same = bool(torch.equal(ki[clear], pi[clear]))
        if not same:
            bad = (ki != pi) & clear
            print(f"[kernels] {label}: indices differ on clear slots at "
                  f"{bad.nonzero()[:8].tolist()}")
        print(f"[kernels] {label}: max|kernel-plain| {err:.3g} (tol {tol:g}), indices "
              f"equal on {int(clear.sum())}/{clear.numel()} clear slots: {same}")
        if not err <= tol or not same:
            fail(f"{label} disagrees with its plain version")
        return err

    report = {"gallery_topk": [], "gallery_topk_int8": []}
    for label, q, rows, k in (("serving", queries, big, 3), ("small", queries[:1], 8192, 8)):
        tb_s, codes_s, scales_s, valid_s = tb[:rows], codes[:rows], scales[:rows], valid[:rows]
        if rows < big:  # keep some invalid rows and the duplicate in play
            valid_s = valid_s.clone()
            valid_s[-50:] = False
            tb_s, codes_s, scales_s = tb_s.clone(), codes_s.clone(), scales_s.clone()
            tb_s[rows - 100], codes_s[rows - 100] = tb_s[dup_lo], codes_s[dup_lo]
            scales_s[rows - 100] = scales_s[dup_lo]
        dup = dup_hi if rows == big else rows - 100
        last_valid = rows - (n_bad if rows == big else 50)
        shape = f"{label} Q={q.shape[0]} G={rows} k={k}"

        kv, ki = gk.streaming_cosine_topk(q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
        pv, pi = gk.streaming_cosine_topk_plain(q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
        torch.cuda.synchronize()
        err3 = agree(f"K3 gallery_topk {shape}", kv, ki, pv, pi, K3_TOL)
        kv8, ki8 = gk.streaming_cosine_topk_int8(
            q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK
        )
        pv8, pi8 = gk.streaming_cosine_topk_int8_plain(
            q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK
        )
        torch.cuda.synchronize()
        err4 = float((kv8 - pv8).abs().max())
        print(f"[kernels] K4 gallery_topk_int8 {shape}: max|kernel-plain| {err4:.3g} "
              f"(must be 0), indices equal: {bool(torch.equal(ki8, pi8))}")
        if err4 != 0.0 or not torch.equal(ki8, pi8):
            fail(f"K4 {shape} is not equal to its plain version to the bit")
        for name, v, i in (("K3", kv, ki), ("K4", kv8, ki8)):
            if i[0, :2].tolist() != [dup_lo, dup]:
                fail(f"{name} {shape}: duplicate rows came back as {i[0, :2].tolist()}, "
                     f"expected [{dup_lo}, {dup}]")
            if int(i.max()) >= last_valid or float(v.min()) < -1.0:
                fail(f"{name} {shape}: a masked row was returned")
            if not torch.isfinite(v).all():
                fail(f"{name} {shape}: non-finite scores")
        n_self = min(8, q.shape[0])
        if ki[:n_self, 0].tolist() != rows_q[:n_self] or float(kv[:n_self, 0].min()) < 0.99:
            fail(f"K3 {shape}: queries equal to gallery rows did not come back top-1")
        if ki8[:n_self, 0].tolist() != rows_q[:n_self] or float(kv8[:n_self, 0].min()) < 0.98:
            fail(f"K4 {shape}: queries equal to gallery rows did not come back top-1")

        # yardsticks: one matmul with the [Q, G] matrix stored, then topk
        qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        qb = qn.to(torch.bfloat16)
        neg = torch.tensor(-1e9, device=DEVICE)

        def lib3():
            sims = torch.where(valid_s, torch.matmul(qb, tb_s.T).float(), neg)
            return torch.topk(sims, k)

        qq = torch.round(qn * (127.0 / qn.abs().amax(dim=1, keepdim=True))).to(torch.int8)
        # torch._int_mm needs more than 16 rows; the small shape pads to 32
        qq_mm = qq if qq.shape[0] > 16 else torch.cat([qq, qq.new_zeros((32 - qq.shape[0], 512))])
        int_mm = getattr(torch, "_int_mm", None)
        if int_mm is not None:
            try:  # the yardstick only: which library call this PyTorch offers
                int_mm(qq_mm[:32], codes_s[:64].T)
            except RuntimeError as e:
                print(f"[kernels] torch._int_mm refused the layout ({e}); the K4 "
                      f"yardstick is the dequantised bf16 matmul")
                int_mm = None

        def lib4():
            if int_mm is not None:
                dots = int_mm(qq_mm, codes_s.T)[: qq.shape[0]].float()
            else:
                dots = torch.matmul(qq.to(torch.bfloat16), codes_s.to(torch.bfloat16).T).float()
            return torch.topk(torch.where(valid_s, dots * scales_s, neg), k)

        # the yardsticks answer the same question (torch.topk promises no
        # tie order, so query 0 may come back as either duplicate)
        for name, lib, ref in (("K3", lib3, ki), ("K4", lib4, ki8)):
            lv, li = lib()
            if li[0, 0] not in (dup_lo, dup) or not torch.equal(li[1:n_self, 0], ref[1:n_self, 0]):
                fail(f"the {name} yardstick disagrees on the planted queries ({shape})")
        qd = q.shape[0] * 512
        out_bytes = q.shape[0] * k * 8
        report["gallery_topk"].append({
            "shape": shape, "err": err3, "in_step": rows == big,
            "ms": cuda_time_ms(lambda: gk.streaming_cosine_topk(
                q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)),
            "plain_ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_plain(
                q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK), iters=2, warmup=1),
            "library_ms": cuda_time_ms(lib3, iters=5, warmup=1),
            "bytes": 4 * qd + rows * (512 * 2 + 1) + out_bytes,
            "flops": 2 * q.shape[0] * rows * 512, "peak": BF16_FLOPS_PER_S,
        })
        report["gallery_topk_int8"].append({
            "shape": shape, "err": err4, "in_step": rows == big,
            "ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_int8(
                q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK)),
            "plain_ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_int8_plain(
                q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK), iters=2, warmup=1),
            "library_ms": cuda_time_ms(lib4, iters=5, warmup=1),
            "bytes": 4 * qd + rows * (512 + 4 + 1) + out_bytes,
            "flops": 2 * q.shape[0] * rows * 512, "peak": INT8_OPS_PER_S,
        })
        if rows == big:
            k3 = lambda: gk.streaming_cosine_topk(  # noqa: E731
                q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
            k3_q64 = lambda: gk.streaming_cosine_topk(  # noqa: E731
                q[:64], tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
            k4 = lambda: gk.streaming_cosine_topk_int8(  # noqa: E731
                q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
            prep3 = lambda: gk.normalize_queries(q).contiguous()  # noqa: E731
            prep4 = lambda: gk._quantize_rows(gk.normalize_queries(q))  # noqa: E731
            for name, fn, prep in (("gallery_topk", k3, prep3), ("gallery_topk_int8", k4, prep4)):
                report[name][-1].update({
                    "ms_again": cuda_time_ms(fn),
                    "stream_device_ms": device_time_ms(fn, "stream_topk_kernel"),
                    "merge_device_ms": device_time_ms(fn, "merge_"),
                    "prep_device_ms": device_time_ms(prep, ""),
                    "prep_host_ms": host_enqueue_ms(prep),
                    "host_ms": host_enqueue_ms(fn),
                })
            report["gallery_topk"][-1].update({
                "q64_ms": cuda_time_ms(k3_q64),
                "q64_stream_device_ms": device_time_ms(k3_q64, "stream_topk_kernel"),
            })
    long_lists_and_float32_rows(gk, report, queries, t, tb, codes, scales, valid,
                                rows_q, agree)
    del t
    gallery_odd_shapes(gk, tb, codes, scales)
    print_bounds({k: v for k, v in report.items() if isinstance(v, list)},
                 "matmul+topk" if int_mm is None else "matmul/_int_mm+topk")
    for name in ("gallery_topk", "gallery_topk_int8"):
        r = report[name][0]

        def ms(v):
            return "not measured" if v is None else f"{v:.4f} ms"

        print(f"[timing] {name} {r['shape']}: the call again {r['ms_again']:.4f} ms; device "
              f"time alone: stream kernel {ms(r['stream_device_ms'])}, merge kernel "
              f"{ms(r['merge_device_ms'])}, the query preparation around them "
              f"{ms(r['prep_device_ms'])} (host {r['prep_host_ms']:.4f} ms); host enqueue "
              f"{r['host_ms']:.4f} ms per wrapper call")
    r = report["gallery_topk"][0]
    print(f"[timing] gallery_topk at Q=64 (one block per gallery tile): {r['q64_ms']:.4f} ms, "
          f"stream kernel {'not measured' if r['q64_stream_device_ms'] is None else format(r['q64_stream_device_ms'], '.4f')} ms; "
          f"at Q=128 two blocks read each tile")
    return report


def long_lists_and_float32_rows(gk, report, q, t, tb, codes, scales, valid, rows_q,
                                agree) -> None:
    """Phase 2, K3 on float32 rows (`csrc/gallery_topk_f32.cu` on the shared
    body) at the serving shape, held within 1e-5 of its plain version and
    timed beside its bound (operations on CUDA cores) and the stored float32
    matmul + topk; then K3 (bf16 and float32 rows) and K4 at every top_k of
    LONG_TOP_KS, against their plain versions, each with where its lists
    live, the ring depth that leaves, the call's peak device memory and the
    device time of its stream and merge kernels."""
    import numpy as np
    import torch

    big = t.shape[0]
    qd = q.shape[0] * 512
    neg = torch.tensor(-1e9, device=DEVICE)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    k = 3

    def k3f(k=k):
        return gk.streaming_cosine_topk(q, t, valid, top_k=k, chunk=STREAM_CHUNK)

    def lib_f32(k=k):
        return torch.topk(torch.where(valid, torch.matmul(qn, t.T), neg), k)

    kv, ki = k3f()
    pv, pi = gk.streaming_cosine_topk_plain(q, t, valid, top_k=k, chunk=STREAM_CHUNK)
    torch.cuda.synchronize()
    shape = f"serving Q={q.shape[0]} G={big} k={k}"
    err = agree(f"K3 gallery_topk_f32 {shape}", kv, ki, pv, pi, 1e-5)
    if ki[:8, 0].tolist() != rows_q[:8] or float(kv[:8, 0].min()) < 0.99:
        fail("K3 on float32 rows: queries equal to gallery rows did not come back top-1")
    report["gallery_topk_f32"] = [{
        "shape": shape, "err": err, "in_step": True,
        "ms": cuda_time_ms(k3f, iters=10),
        "plain_ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_plain(
            q, t, valid, top_k=k, chunk=STREAM_CHUNK), iters=2, warmup=1),
        "library_ms": cuda_time_ms(lib_f32, iters=5, warmup=1),
        "bytes": 4 * qd + big * (512 * 4 + 1) + q.shape[0] * k * 8,
        "flops": 2 * q.shape[0] * big * 512, "peak": F32_FLOPS_PER_S,
        "stream_device_ms": device_time_ms(k3f, "stream_topk_kernel", iters=5),
        "merge_device_ms": device_time_ms(k3f, "merge_", iters=5),
    }]
    r = report["gallery_topk_f32"][0]
    print(f"[timing] gallery_topk_f32 {shape}: stream kernel "
          f"{'not measured' if r['stream_device_ms'] is None else format(r['stream_device_ms'], '.4f')}"
          f" ms device, merge "
          f"{'not measured' if r['merge_device_ms'] is None else format(r['merge_device_ms'], '.4f')}"
          f" ms")

    report["long_lists"] = long_lists(gk, report, q, t, tb, codes, scales, valid, rows_q,
                                      agree)


def device_split_ms(fn, iters: int):
    """Device ms per call of `fn` by kernel, from torch.profiler: the pool
    route's sample pass, its select of T_q, the gather pass and the select
    of the pools; the device lists' stream kernel and their merge (None
    where the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = dict.fromkeys(("sample", "threshold", "gather", "select", "lists", "merge"), 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key
        if "stream_topk_kernel" in key:  # its mode is its second template argument
            part = "sample" if ", -1>" in key else "gather" if ", -2>" in key else "lists"
        elif "sample_threshold_kernel" in key:
            part = "threshold"
        elif "select_pool_kernel" in key:
            part = "select"
        elif "merge_" in key:
            part = "merge"
        else:
            continue
        parts[part] += e.self_device_time_total / iters / 1e3
    return parts if any(parts.values()) else None


def long_lists(gk, report, q, t, tb, codes, scales, valid, rows_q, agree) -> dict:
    """Phase 2, the long lists: K3 (bf16 and float32 rows) and K4 at every
    top_k of LONG_TOP_KS and MAX_TOP_K at 128 x 1 048 576 x 512, each held
    to its plain version with the route it took (device lists up to
    POOL_MIN_K - 1, the pool route from it), its unresolved queries (none on
    this random gallery), the call's peak memory and each kernel's device
    time; beside it the other route forced in the same run (its answer, time
    and peak memory: the crossover at 33-256, the device lists the pool
    route replaces from 256), and on the pool route every query sent on to
    the unresolved route (the same answer); then a gallery whose rows tie
    past the pool for two queries (those two unresolved, counted on the
    card), and MAX_TOP_K + 1 refused. Returns the launches of the pool
    route, counted from 0 over the loop, and the crossover it measured."""
    import torch

    big = t.shape[0]
    nq = q.shape[0]
    qd = nq * 512
    neg = torch.tensor(-1e9, device=DEVICE)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_long = time.perf_counter()
    kinds = (("gallery_topk", K3_TOL, "bf16"), ("gallery_topk_f32", 1e-5, "f32"),
             ("gallery_topk_int8", 0.0, "int8"))

    def search(kind, k, route=None, rows=None, qq=q, vv=valid):
        """The public wrapper's search, or with `route` the route forced
        through the wrappers' card half."""
        if kind == "int8":
            c, sc = (codes, scales) if rows is None else rows
            if route is not None:
                return gk._card_search(qq, c, vv, k, sc, route)
            return gk.streaming_cosine_topk_int8(qq, c, sc, vv, top_k=k, chunk=STREAM_CHUNK)
        r = rows if rows is not None else (tb if kind == "bf16" else t)
        if route is not None:
            return gk._card_search(qq, r, vv, k, route=route)
        return gk.streaming_cosine_topk(qq, r, vv, top_k=k, chunk=STREAM_CHUNK)

    def plain(kind, k, rows=None, qq=q, vv=valid):
        if kind == "int8":
            c, sc = (codes, scales) if rows is None else rows
            return gk.streaming_cosine_topk_int8_plain(qq, c, sc, vv, top_k=k,
                                                       chunk=STREAM_CHUNK)
        return gk.streaming_cosine_topk_plain(qq, rows if rows is not None else
                                              (tb if kind == "bf16" else t), vv, top_k=k,
                                              chunk=STREAM_CHUNK)

    def held(label, kind, kv, ki, pv, pi, tol):
        """The call's answer against the plain version's k + 1 best."""
        k = kv.shape[1]
        if kind == "int8":
            if not torch.equal(kv, pv[:, :k]) or not torch.equal(ki, pi[:, :k]):
                fail(f"K4 {label} is not equal to its plain version to the bit")
            return 0.0
        return agree(f"K3 {label}", kv, ki, pv, pi, tol)

    def peak_call(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**20

    for c in gk.POOL_LAUNCHES.values():
        c.reset()
    for k in (*LONG_TOP_KS, gk.MAX_TOP_K):
        shape = f"long list Q={nq} G={big} k={k}"
        few = k > 1024  # the device lists take up to half a second a call there
        out_bytes = nq * k * 12  # float32 scores, int64 indices
        for name, tol, kind in kinds:
            geo = gk.gallery_launch_geometry(nq, big, 512, kind, sms, k)
            gk.reset_unresolved()
            (kv, ki), peak_mib = peak_call(lambda: search(kind, k))
            unresolved = gk.unresolved_queries()
            pv, pi = plain(kind, k + 1)  # one more: the last slot's neighbour below
            torch.cuda.synchronize()
            err = held(f"{name} {shape}", kind, kv, ki, pv, pi, tol)
            if ki[0, 0] != rows_q[0] or not torch.isfinite(kv).all():
                fail(f"{name} {shape}: the planted row did not come back first")
            if geo.lists == "pool" and unresolved != 0:
                fail(f"{name} {shape}: {unresolved} queries of a random gallery were "
                     f"unresolved on the pool route")
            elem = {"bf16": 2, "f32": 4, "int8": 1}[kind]
            fn = (lambda kind=kind, k=k: search(kind, k))  # noqa: E731
            r = {
                "shape": shape, "err": err, "in_step": False, "k": k, "kind": kind,
                "route": geo.lists, "unresolved": unresolved,
                "resolved": nq - unresolved if geo.lists == "pool" else None,
                "ms": cuda_time_ms(fn, iters=3, warmup=1),
                "plain_ms": cuda_time_ms(lambda: plain(kind, k), iters=1, warmup=0),
                "library_ms": cuda_time_ms(
                    (lambda k=k: torch.topk(torch.where(valid, torch.matmul(
                        qn.to(torch.bfloat16), tb.T).float(), neg), k)) if kind != "f32"
                    else (lambda k=k: torch.topk(torch.where(valid, torch.matmul(qn, t.T),
                                                             neg), k)), iters=3, warmup=1),
                # the function's bytes: each input read once, each output
                # written once (the lists and pools are the design's)
                "bytes": 4 * qd + big * (512 * elem + 1 + (4 if kind == "int8" else 0))
                + out_bytes,
                "flops": 2 * nq * big * 512,
                "peak": {"bf16": BF16_FLOPS_PER_S, "f32": F32_FLOPS_PER_S,
                         "int8": INT8_OPS_PER_S}[kind],
                "split": device_split_ms(fn, 3), "peak_mib": peak_mib,
                "stages": geo.stages, "scratch_mib": geo.scratch_bytes / 2**20,
            }
            if geo.lists == "pool":
                r.update(sample_tiles=geo.sample_tiles, sample_rank=geo.sample_rank,
                         pool_cap=geo.pool_cap)
            if k > 16:  # the other route of the same call, forced in this run
                other = "device" if geo.lists == "pool" else "pool"
                ofn = (lambda kind=kind, k=k, other=other: search(kind, k, other))  # noqa: E731
                (ov, oi), opeak = peak_call(ofn)
                held(f"{name} {shape} ({other} route forced)", kind, ov, oi, pv, pi, tol)
                slow = few and other == "device"
                r.update({f"{other}_route_ms": cuda_time_ms(ofn, iters=1 if slow else 3,
                                                            warmup=0 if slow else 1),
                          f"{other}_route_peak_mib": opeak,
                          f"{other}_route_split": device_split_ms(ofn, 1 if slow else 3)})
            if geo.lists == "pool":  # every query on to the unresolved route
                gk.reset_unresolved()
                fv, fi = search(kind, k, "pool_unresolved")
                torch.cuda.synchronize()
                sent = gk.unresolved_queries()
                if sent != nq:
                    fail(f"{name} {shape}: the forced unresolved route counted {sent} of {nq}")
                held(f"{name} {shape} (every query unresolved)", kind, fv, fi, pv, pi, tol)
                r["forced_unresolved_ms"] = cuda_time_ms(
                    lambda kind=kind, k=k: search(kind, k, "pool_unresolved"), iters=1, warmup=0)
            report[name].append(r)

            def ms(v):
                return "not measured" if v is None else f"{v:.4f}"

            split = r["split"] or {}
            print(f"[long] {name} {shape}: route {geo.lists}"
                  + (f" (sample {geo.sample_tiles} tiles, T_q at rank {geo.sample_rank}, "
                     f"pool {geo.pool_cap}; resolved {r['resolved']}, unresolved {unresolved})"
                     if geo.lists == "pool" else "")
                  + f"; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, matmul+topk "
                  f"{r['library_ms']:.4f}; device ms "
                  + ", ".join(f"{p} {ms(split.get(p))}" for p in split if split.get(p))
                  + f"; peak {peak_mib:.1f} MiB (the [Q, G] matrix would be "
                  f"{nq * big * 4 / 2**20:.0f} MiB)")
            for other in ("device", "pool"):
                if f"{other}_route_ms" in r:
                    osplit = r[f"{other}_route_split"] or {}
                    print(f"[long] {name} {shape}: the {other} route forced: "
                          f"{r[f'{other}_route_ms']:.4f} ms, peak "
                          f"{r[f'{other}_route_peak_mib']:.1f} MiB; device ms "
                          + ", ".join(f"{p} {ms(osplit.get(p))}" for p in osplit
                                      if osplit.get(p))
                          + f"; {r[f'{other}_route_ms'] / r['ms']:.2f}x this call's time")
            if "forced_unresolved_ms" in r:
                print(f"[long] {name} {shape}: every query sent on to the unresolved "
                      f"route: {r['forced_unresolved_ms']:.4f} ms, the same answer")
    pool_launches = {kind: c.count for kind, c in gk.POOL_LAUNCHES.items()}

    # the crossover: both routes at 33-256, timed in this run
    crossover = {}
    for name, _, kind in kinds:
        sweep = {r["k"]: (r["ms"] if r["route"] == "pool" else r["pool_route_ms"],
                          r["ms"] if r["route"] == "device" else r["device_route_ms"])
                 for r in report[name] if r.get("k") in (33, 64, 65, 128, 256)}
        wins = [k for k, (p, d) in sorted(sweep.items()) if p < d]
        crossover[kind] = {"pool_ms": {k: p for k, (p, _) in sweep.items()},
                           "device_ms": {k: d for k, (_, d) in sweep.items()},
                           "pool_faster_from": wins[0] if wins else None}
        print(f"[long] crossover {kind}: " + "; ".join(
            f"k={k} pool {p:.4f} ms, device lists {d:.4f} ms" for k, (p, d) in
            sorted(sweep.items())) + f"; POOL_MIN_K is {gk.POOL_MIN_K}")
    for name, _, kind in kinds:
        top = next(r for r in report[name] if r.get("k") == gk.MAX_TOP_K)
        if not top["peak_mib"] < top["device_route_peak_mib"]:
            fail(f"{name} at MAX_TOP_K: the pool route's peak memory {top['peak_mib']:.1f} MiB "
                 f"is not below the device lists' {top['device_route_peak_mib']:.1f} MiB")

    # the labeler's query counts: both routes forced, and the one the rule picks
    by_q = {kind: [] for _, _, kind in kinds}
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    for nq_l in LABELER_QS:
        q_l = torch.randn((nq_l, 512), generator=gen, device=DEVICE)
        for k in LABELER_TOP_KS:
            for name, tol, kind in kinds:
                shape = f"labeler Q={nq_l} G={big} k={k}"
                geo = gk.gallery_launch_geometry(nq_l, big, 512, kind, sms, k, "pool")
                gk.reset_unresolved()
                (kv, ki), peak_mib = peak_call(lambda: search(kind, k, "pool", qq=q_l))
                unresolved = gk.unresolved_queries()
                (dv, di), dpeak = peak_call(lambda: search(kind, k, "device", qq=q_l))
                torch.cuda.synchronize()
                if not torch.isfinite(kv).all():
                    fail(f"{name} {shape}: scores not finite")
                err = held(f"{name} {shape} (pool route against the device lists)", kind,
                           kv, ki, dv, di, tol)
                del kv, ki, dv, di
                r = {"q": nq_l, "k": k, "block": geo.block, "blocks": -(-nq_l // geo.block),
                     "unresolved": unresolved, "err": err,
                     "rule": gk.gallery_launch_geometry(nq_l, big, 512, kind, sms, k).lists,
                     "pool_route_ms": cuda_time_ms(lambda: search(kind, k, "pool", qq=q_l),
                                                   iters=2, warmup=0),
                     "device_route_ms": cuda_time_ms(
                         lambda: search(kind, k, "device", qq=q_l), iters=2, warmup=0),
                     "pool_route_peak_mib": peak_mib, "device_route_peak_mib": dpeak,
                     "scratch_mib": geo.scratch_bytes / 2**20}
                faster = "pool" if r["pool_route_ms"] < r["device_route_ms"] else "device"
                r["rule_took_the_faster"] = r["rule"] == faster
                by_q[kind].append(r)
                print(f"[long] {name} {shape}: the pool route in {r['blocks']} blocks of "
                      f"{geo.block}, unresolved {unresolved}: {r['pool_route_ms']:.4f} ms, "
                      f"peak {peak_mib:.1f} MiB; the device lists: "
                      f"{r['device_route_ms']:.4f} ms, peak {dpeak:.1f} MiB "
                      f"({r['device_route_ms'] / r['pool_route_ms']:.2f}x); the same answer; "
                      f"the rule takes the {r['rule']} route "
                      f"({'the faster' if r['rule_took_the_faster'] else 'NOT the faster'})")
        del q_l
    for _, _, kind in kinds:
        missed = [(r["q"], r["k"]) for r in by_q[kind] if not r["rule_took_the_faster"]]
        print(f"[long] labeler sweep {kind}: the rule took the faster route at "
              f"{len(by_q[kind]) - len(missed)} of {len(by_q[kind])} points"
              + (f"; not at (Q, k) {missed}" if missed else ""))

    # adversarial: two queries whose best 5001 rows tie (past a pool of 4096)
    rows_adv = 65536
    t_adv = t[:rows_adv].clone()
    t_adv[100:5100] = t_adv[3]
    q_adv = q[:8].clone()
    q_adv[:2] = 2.0 * t_adv[3]
    v_adv = torch.ones(rows_adv, dtype=torch.bool, device=DEVICE)
    adv = {}
    for name, tol, kind in kinds:
        rows = (gk.quantize_templates(t_adv) if kind == "int8"
                else t_adv.to(torch.bfloat16) if kind == "bf16" else t_adv)
        adv_kw = dict(rows=rows, qq=q_adv, vv=v_adv)
        gk.reset_unresolved()
        kv, ki = search(kind, 1024, **adv_kw)
        torch.cuda.synchronize()
        adv[kind] = gk.unresolved_queries()
        pv, pi = plain(kind, 1025, **adv_kw)
        held(f"{name} adversarial", kind, kv, ki, pv, pi, tol)
        if adv[kind] != 2 or ki[0, :3].tolist() != [3, 100, 101]:
            fail(f"{name}: the tied gallery sent {adv[kind]} queries on (expected 2), "
                 f"first indices {ki[0, :3].tolist()}")
        print(f"[long] {name} Q=8 G={rows_adv} k=1024, queries 0-1 with 5001 rows tied for "
              f"their best: {adv[kind]} unresolved (counted on the card), 6 resolved; equal "
              f"to the plain version")
    del t_adv

    k = gk.MAX_TOP_K + 1
    try:
        gk.streaming_cosine_topk(q, tb, valid, top_k=k, chunk=STREAM_CHUNK)
    except ValueError as e:
        if "shared memory" not in str(e):
            fail(f"top_k={k} raised a ValueError that does not name the shared-memory bound: {e}")
        print(f"[kernels] top_k={k} on the card: ValueError naming its bound ({e})")
    else:
        fail(f"top_k={k} on the card did not raise")
    seconds = time.perf_counter() - t_long
    print(f"[long] the long lists took {seconds:.1f} s")
    return {"pool_launches": pool_launches, "crossover": crossover, "adversarial": adv,
            "by_q": by_q, "seconds": seconds}


def gallery_odd_shapes(gk, tb, codes, scales) -> None:
    """Phase 2, K3 and K4 at the shapes the serving step does not use: query
    counts around the kernels' tiles of 64 and 128, a gallery that ends
    inside a 64-row tile, depths that end inside a 128-byte K-panel, top_k 1
    and 8, fewer valid rows than top_k and none. K4 must equal its plain
    version to the bit, K3 within K3_TOL with equal indices on clear slots."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(5)
    cases = [
        # (Q, G, D, top_k, valid rows: None = all but the last 10)
        (64, 4096 + 32, 512, 3, None), (65, 4096 + 32, 512, 8, None),
        (129, 32, 512, 1, None), (200, 4096 + 32, 512, 5, None),
        (128, 8192, 96, 3, None), (128, 8192, 160, 3, None),
        (7, 256, 32, 4, [3, 200]), (5, 4096, 512, 3, []),
    ]
    for nq, rows, d, k, keep in cases:
        q = torch.randn((nq, d), generator=g, device=DEVICE)
        valid = torch.ones(rows, dtype=torch.bool, device=DEVICE)
        if keep is None:
            valid[-10:] = False
        else:
            valid[:] = False
            valid[keep] = True
        shape = f"Q={nq} G={rows} D={d} k={k}" + ("" if keep is None else f" valid={len(keep)}")
        chunk = 32
        t3, c4 = tb[:rows, :d].contiguous(), codes[:rows, :d].contiguous()
        s4 = scales[:rows].contiguous()
        if rows > 16:
            t3[rows - 9], c4[rows - 9] = t3[1], c4[1]  # an invalid twin of row 1
            q[0] = t3[1].float() * 2.0
        kv, ki = gk.streaming_cosine_topk(q, t3, valid, top_k=k, chunk=chunk)
        pv, pi = gk.streaming_cosine_topk_plain(q, t3, valid, top_k=k, chunk=chunk)
        torch.cuda.synchronize()
        err = float((kv - pv).abs().max())
        gap = (pv[:, :-1] - pv[:, 1:]).abs() > 2 * K3_TOL
        clear = torch.ones_like(pi, dtype=torch.bool)
        clear[:, :-1] &= gap
        clear[:, 1:] &= gap
        if not err <= K3_TOL or not torch.equal(ki[clear], pi[clear]):
            fail(f"K3 odd shape {shape}: max|kernel-plain| {err}")
        kv8, ki8 = gk.streaming_cosine_topk_int8(q, c4, s4, valid, top_k=k, chunk=chunk)
        pv8, pi8 = gk.streaming_cosine_topk_int8_plain(q, c4, s4, valid, top_k=k, chunk=chunk)
        torch.cuda.synchronize()
        if not torch.equal(kv8, pv8) or not torch.equal(ki8, pi8):
            fail(f"K4 odd shape {shape}: not equal to its plain version to the bit")
        for name, v, i in (("K3", kv, ki), ("K4", kv8, ki8)):
            n_valid = int(valid.sum())
            if n_valid < k and not (bool((v[:, n_valid:] == -1e9).all())
                                    and bool((i[:, n_valid:] == 0).all())):
                fail(f"{name} odd shape {shape}: surplus slots are not (-1e9, 0)")
            if not bool(valid[i[v > -1e9]].all()):
                fail(f"{name} odd shape {shape}: a masked row was returned")
    # a gallery view that starts off a 16-byte address is refused, not copied
    flat = torch.zeros(64 * 512 + 1, dtype=torch.int8, device=DEVICE)
    off = flat[1:].view(64, 512)
    ones = torch.ones(64, device=DEVICE)
    try:
        gk.streaming_cosine_topk_int8(
            torch.randn((2, 512), device=DEVICE), off, ones, ones.bool(), top_k=2, chunk=32)
    except ValueError as e:
        if "16-byte" not in str(e):
            fail(f"K4 refused a gallery off a 16-byte address without naming the rule: {e}")
    else:
        fail("K4 took a gallery view that starts off a 16-byte address")
    print(f"[kernels] K3/K4: {len(cases)} odd shapes agree with their plain versions (K4 to "
          f"the bit); a gallery off a 16-byte address is refused")


def breakdown(engine, frames, templates, valid, iters: int = 5,
              match_label: str = "match (dense top-k)", tag: str = "breakdown") -> dict:
    """Where the step's time goes: each layer timed alone (host clock
    around synchronized calls, median of `iters`), then the device's busy
    share over whole steps from torch.profiler (kernel time / wall time).
    Returns the device time per step of K1 (its three launches) and K2
    inside the profiled steps, in ms by kernel name, and under "layers",
    "device_ms" and "busy" the layer medians, the device time per step and
    the busy share."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.image import normalize_face_batch
    from facerecognitionpipeline_tpu_torch.ops.warp import align_faces_batch

    f32 = frames.float()
    with torch.inference_mode():
        det = engine.detector.detect_device(f32)
        b, f = det["valid"].shape
        layers = {
            "detect (cascade, K1 x2)": lambda: engine.detector.detect_device(f32),
            "align (K1 stage A + K2)": lambda: align_faces_batch(
                f32, det["landmarks"], engine._shards[0].template, 112, 128
            ),
            f"embed ({ARCH}, B*F faces)": lambda: engine.embedder.forward(
                normalize_face_batch(
                    torch.zeros((b * f, 112, 112, 3), device=f32.device),
                    dtype=engine.embedder._dtype,
                )
            ),
            match_label: lambda: engine._match(
                torch.randn((b, f, 512), device=f32.device), templates, valid, 3
            ),
        }
        layer_ms = {}
        for name, fn in layers.items():
            times = []
            for _ in range(iters):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - s0))
            layer_ms[name] = sorted(times)[iters // 2]
            print(f"[{tag}] {name}: {layer_ms[name]:.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(3):
            engine.process_frames(frames, templates, valid)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - s0)
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies, sets); the CPU ops that
    # launched them carry the same time again
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"[{tag}] device busy share: not measured (profiler saw no device time)")
        return {"layers": layer_ms, "device_ms": None, "busy": None}
    launches = sum(e.count for e in events)
    print(f"[{tag}] device busy {dev_us / wall_us:.3f} of wall over 3 profiled steps "
          f"({dev_us / 3e3:.3f} ms device time and {launches / 3:.0f} device events per "
          f"step; profiled wall {wall_us / 3e3:.3f} ms per step)")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[{tag}]   {e.self_device_time_total / 3e3:8.3f} ms/step  "
              f"x{e.count // 3:<5d} {e.key[:90]}")
    in_step = {"layers": layer_ms, "device_ms": dev_us / 3e3, "busy": dev_us / wall_us}
    for name in ("crop_resize", "warp_patches", "stream_topk_kernel", "merge_topk_kernel"):
        mine = [e for e in events if name in e.key]
        if not mine and name.endswith("topk_kernel"):
            continue  # the dense match launches no streaming kernel
        in_step[name] = sum(e.self_device_time_total for e in mine) / 3e3
        print(f"[{tag}]   {name} inside the step: {in_step[name]:.4f} ms device time "
              f"per step over {sum(e.count for e in mine) // 3} launches per step")
    return in_step


def serving_build(fixture) -> dict:
    """The server's build on the card: the bf16 detector with
    pretrained/mtcnn_dr.npz, the seeded ir_101 embedder, the engine, and
    BATCH frames composed from the fixture with their ground truth."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    detector = MTCNNDetector(
        det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES, min_face_size=40,
        dtype=torch.bfloat16, device=DEVICE,
        weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
    )
    embedder = FaceEmbedder(
        ARCH, dtype=torch.bfloat16, random_ok=True, init_seed=0, device=DEVICE
    )
    engine = RecognitionEngine(detector, embedder, top_k=3)
    if detector.crop_impl != "kernel" or engine.align_impl != "kernel":
        fail("the serving build did not select the kernels")
    frames_np, gts = mosaics(fixture, BATCH)
    return {"detector": detector, "embedder": embedder, "engine": engine,
            "frames_np": frames_np, "frames": torch.from_numpy(frames_np).to(DEVICE),
            "gts": gts}


def planted_slots(out, n: int = 8):
    """The first n valid face slots of a step's output and its embeddings
    (numpy): what the phases plant into their galleries."""
    valid = out["face_valid"].cpu().numpy()
    emb = out["embeddings"].float().cpu().numpy()
    return [(f, s) for f in range(BATCH) for s in range(MAX_FACES) if valid[f, s]][:n], emb


def serving_phases(fixture, report) -> dict:
    """Phases 3 and 4: the fused step and the request batcher. Returns what
    the later phases reuse (the engine's parts, the frames, the planted
    slots)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.ops import (
        crop_kernel,
        gallery_kernel,
        nms_kernel,
        warp_kernel,
    )
    from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

    t0 = time.perf_counter()
    build = serving_build(fixture)
    detector, embedder, engine = build["detector"], build["embedder"], build["engine"]
    frames, frames_np, gts = build["frames"], build["frames_np"], build["gts"]
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    gallery = DeviceGallery(device=DEVICE)
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)], gal)
    t, v, _ = gallery.device_snapshot()
    if t.dtype != torch.float32:
        fail(f"a {GALLERY_ROWS}-row gallery must stay float32, got {t.dtype}")
    out = engine.process_frames(frames, t, v)
    torch.cuda.synchronize()
    print(f"[step] built and warmed in {time.perf_counter() - t0:.1f} s")

    # detection recall against the fixture's ground truth
    recall, hits, total = detection_recall(out, gts)
    print(f"[step] detection recall {recall:.3f} ({hits}/{total} faces, IoU>=0.5)")
    if recall < 0.8:
        fail(f"recall {recall} < 0.8")
    for key in ("bboxes", "landmarks", "embeddings", "match_scores", "embedding_norms"):
        if not torch.isfinite(out[key]).all():
            fail(f"non-finite {key}")
    shapes = {
        "bboxes": (BATCH, MAX_FACES, 4), "landmarks": (BATCH, MAX_FACES, 5, 2),
        "aligned": (BATCH, MAX_FACES, 112, 112, 3),
        "embeddings": (BATCH, MAX_FACES, 512), "match_idx": (BATCH, MAX_FACES, 3),
    }
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            fail(f"{key} shape {tuple(out[key].shape)} != {shape}")

    # planted matches: step embeddings written into known gallery rows
    slots, emb = planted_slots(out)
    planted = gal.copy()
    rows = [100 + 37 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        planted[row] = emb[f, s]
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)], planted)
    t, v, _ = gallery.device_snapshot()
    engine.process_frames(frames, t, v)  # this gallery's graph, captured before the counts

    crop_kernel.LAUNCHES.reset()
    warp_kernel.LAUNCHES.reset()
    nms_kernel.LAUNCHES.reset()
    gallery_kernel.LAUNCHES.reset()
    gallery_kernel.LAUNCHES_INT8.reset()
    out, ms = timed_steps(engine, frames, t, v, STEP_ITERS)
    if gallery_kernel.LAUNCHES.count or gallery_kernel.LAUNCHES_INT8.count:
        fail("a 1024-row float32 gallery must take the dense match")
    launches = {
        "crop_resize": crop_kernel.LAUNCHES.count,
        "warp_patches": warp_kernel.LAUNCHES.count,
        "nms_fixpoint": nms_kernel.LAUNCHES.count,
    }
    print(f"[step] launches over {STEP_ITERS} steps through the step's CUDA graph (each "
          f"replay adds what its capture recorded): {launches}")
    if launches != {"crop_resize": 3 * STEP_ITERS, "warp_patches": STEP_ITERS,
                    "nms_fixpoint": 3 * STEP_ITERS}:
        fail(f"expected K1 x3, K2 x1 and K5 x3 per step, got {launches}")
    idx = out["match_idx"].cpu().numpy()
    sc = out["match_scores"].cpu().numpy()
    for row, (f, s) in zip(rows, slots):
        if idx[f, s, 0] != row or sc[f, s, 0] <= 0.99:
            fail(f"planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
    print(f"[step] {len(slots)} planted embeddings came back top-1 "
          f"(min score {min(sc[f, s, 0] for f, s in slots):.5f})")
    p50 = ms[len(ms) // 2]
    print(f"[timing] fused step B={BATCH} {DET_SIZE[0]}x{DET_SIZE[1]} {ARCH} bf16, "
          f"{GALLERY_ROWS}-row float32 gallery: "
          f"p50 {p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {STEP_ITERS} "
          f"steps ({BATCH * 1e3 / p50:.1f} frames/s)")
    report["launches"] = launches
    report["step_p50_ms"] = p50
    report["in_step_device_ms"] = breakdown(engine, frames, t, v)

    # phase 4: requests through the batcher, from two client threads
    direct = engine.process_frames(frames, t, v)
    batcher = DeviceBatcher(
        engine, gallery.device_snapshot, max_batch=BATCH, max_wait_ms=5.0,
        top_k=3, bucket_sizes=(BATCH,),
    )
    batcher.warmup(DET_SIZE)
    batcher.start()
    n_req = 16
    futs = [None] * n_req
    try:
        def client(offset):
            for i in range(offset, n_req, 2):
                futs[i] = batcher.submit(frames_np[i % BATCH])

        threads = [threading.Thread(target=client, args=(o,)) for o in (0, 1)]
        r0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        results = [fu.result(timeout=120) for fu in futs]
        r_s = time.perf_counter() - r0
    finally:
        batcher.stop()
    direct = tuple(
        direct[k].cpu().numpy() for k in ("face_valid", "bboxes", "match_idx", "match_scores")
    )
    for i, r in enumerate(results):
        check_request(i, r, direct, i % BATCH)
    print(f"[requests] {n_req} DeviceBatcher requests from 2 threads answered in "
          f"{r_s:.3f} s, each equal to the direct step")
    return {
        "detector": detector, "embedder": embedder, "engine": engine,
        "frames": frames, "frames_np": frames_np, "slots": slots, "gts": gts,
        "emb": torch.from_numpy(emb).to(DEVICE),
    }


def check_request(i, r, direct, f) -> None:
    """One batcher result against frame `f` of the direct step's outputs
    (numpy): same detections, same top-1 where the margin is clear."""
    import numpy as np

    dv, db, di, ds = direct
    if not np.array_equal(r["face_valid"], dv[f]):
        fail(f"request {i}: face_valid differs from the direct step")
    if np.abs(r["bboxes"][dv[f]] - db[f][dv[f]]).max(initial=0) > 0.5:
        fail(f"request {i}: boxes differ from the direct step")
    clear = (ds[f, :, 0] - ds[f, :, 1]) > 5e-3
    if not np.array_equal(r["match_idx"][clear, 0], di[f][clear, 0]):
        fail(f"request {i}: top-1 matches differ from the direct step")
    if np.asarray(r["aligned"]).shape != (MAX_FACES, 112, 112, 3):
        fail(f"request {i}: aligned crops have the wrong shape")


def timed_steps(engine, frames, t, v, iters):
    """`iters` synchronized steps -> (last output, sorted times in ms)."""
    import torch

    times = []
    out = None
    for _ in range(iters):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = engine.process_frames(frames, t, v)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - s0))
    return out, sorted(times)


def large_gallery_phase(ctx, gal, report) -> None:
    """Phase 5: the step against 1 048 576 identities, bf16 then int8."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    engine, frames, slots = ctx["engine"], ctx["frames"], ctx["slots"]
    if engine.gallery_impl != "auto":
        fail("the serving build does not route the gallery with 'auto'")
    big = gal.shape[0]
    ids = [f"id{i}" for i in range(big)]
    rows = [4099 + 131_101 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        gal[row] = ctx["emb"][f, s]  # the step's own embeddings, planted
    counters = {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
    }
    for quantize, kernel, floor in ((None, "gallery_topk", 0.99), ("int8", "gallery_topk_int8", 0.98)):
        label = quantize or "bf16"
        t0 = time.perf_counter()
        gallery = DeviceGallery(device=DEVICE, quantize=quantize)
        gallery.rebuild(ids, gal)
        t, v, snap_ids = gallery.device_snapshot()
        torch.cuda.synchronize()
        rows_pad = (t[0] if isinstance(t, tuple) else t).shape[0]
        dtype = "int8 codes + f32 scales" if isinstance(t, tuple) else str(t.dtype)
        print(f"[big-gallery {label}] DeviceGallery of {len(snap_ids)} identities rebuilt in "
              f"{time.perf_counter() - t0:.2f} s: {rows_pad} rows, {dtype}")
        if rows_pad != big or (quantize is None and t.dtype != torch.bfloat16):
            fail(f"unexpected compact gallery for {label}")
        engine.process_frames(frames, t, v)  # warm
        for c in counters.values():
            c.reset()
        out, ms = timed_steps(engine, frames, t, v, BIG_STEP_ITERS)
        got = {k: c.count for k, c in counters.items()}
        want = {k: 0 for k in counters}
        want.update({"crop_resize": 3 * BIG_STEP_ITERS, "warp_patches": BIG_STEP_ITERS,
                     kernel: BIG_STEP_ITERS})
        print(f"[big-gallery {label}] launches over {BIG_STEP_ITERS} steps: {got} (the "
              f"merge kernel that follows each streaming launch is not counted)")
        if got != want:
            fail(f"expected {want}, got {got}")
        report["launches"][kernel] = got[kernel]
        idx = out["match_idx"].cpu().numpy()
        sc = out["match_scores"].cpu().numpy()
        if out["match_idx"].dtype != torch.int64 or not np.isfinite(sc).all():
            fail(f"{label}: match outputs have the wrong type or are not finite")
        for row, (f, s) in zip(rows, slots):
            if idx[f, s, 0] != row or sc[f, s, 0] <= floor:
                fail(f"{label}: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
        p50 = ms[len(ms) // 2]
        print(f"[big-gallery {label}] {len(slots)} planted embeddings came back top-1 (min "
              f"score {min(sc[f, s, 0] for f, s in slots):.5f}, floor {floor})")
        print(f"[timing] fused step B={BATCH} {ARCH} bf16, {big}-row {label} gallery: p50 "
              f"{p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {BIG_STEP_ITERS} steps "
              f"({BATCH * 1e3 / p50:.1f} frames/s)")
        report[f"step_p50_ms_1m_{label}"] = p50
        breakdown(engine, frames, t, v, iters=3,
                  match_label=f"match (streaming {label}, {big} rows)")
        if quantize == "int8":
            full_idx, full_sc = idx, sc
            budget = RecognitionEngine(
                ctx["detector"], ctx["embedder"], top_k=3, embed_budget=4
            )
            budget.process_frames(frames, t, v)  # its graph, captured before the counts
            for c in counters.values():
                c.reset()
            bout = budget.process_frames(frames, t, v)
            torch.cuda.synchronize()
            if counters["gallery_topk_int8"].count != 1 or counters["gallery_topk"].count:
                fail("the embed_budget step did not launch K4 exactly once")
            emb = bout["embedded"].cpu().numpy()
            bidx = bout["match_idx"].cpu().numpy()
            bsc = bout["match_scores"].cpu().numpy()
            if not emb.any() or (emb.sum(axis=1) > 4).any():
                fail("embed_budget=4 embedded no slot, or more than 4 in a frame")
            n_planted = 0
            for row, (f, s) in zip(rows, slots):
                if emb[f, s]:
                    n_planted += 1
                    if bidx[f, s, 0] != row or bsc[f, s, 0] <= floor:
                        fail(f"budget step: planted row {row} came back as {bidx[f, s, 0]}")
            clear = emb & ((full_sc[..., 0] - full_sc[..., 1]) > 5e-3)
            if not np.array_equal(bidx[clear, 0], full_idx[clear, 0]):
                fail("budget step: embedded slots match other rows than the full step")
            if (bsc[~emb] != -1.0).any() or (bidx[~emb] != 0).any():
                fail("budget step: unembedded slots must report score -1 and index 0")
            print(f"[big-gallery int8] embed_budget=4 step: {int(emb.sum())} slots embedded, "
                  f"{n_planted} of them planted and top-1, {int(clear.sum())} clear slots "
                  f"equal to the full step")
        del gallery, t, v, out
        torch.cuda.empty_cache()


def manager_phase(ctx) -> None:
    """Phase 6: requests through DeviceBatcher with a GalleryManager that
    was filled, saved and loaded again as the gallery provider."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

    engine, frames, frames_np, slots = ctx["engine"], ctx["frames"], ctx["frames_np"], ctx["slots"]
    rng = np.random.default_rng(2)
    emb = ctx["emb"].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gallery", "students.pkl")
        writer = GalleryManager(path, verbose=False, device=DEVICE)
        for i in range(200):
            samples = rng.normal(size=(2, 512)).astype(np.float32)
            if i < len(slots):  # enrolled from the step's own embeddings
                samples = np.repeat(emb[slots[i][0], slots[i][1]][None], 2, axis=0)
            writer.add_student(f"s{i:03d}", f"Student {i}", samples)
        writer.update_embeddings("s150", rng.normal(size=(1, 512)).astype(np.float32))
        writer.delete_student("s199")
        writer.save()
        manager = GalleryManager(path, verbose=False, device=DEVICE)  # loads the files
    if manager.get_statistics()["num_students"] != 199:
        fail("the loaded gallery does not hold the saved students")
    t, v, ids = manager.device_snapshot()
    if t.dtype != torch.float32 or t.shape != (256, 512) or len(ids) != 199:
        fail(f"unexpected manager snapshot {t.dtype} {tuple(t.shape)} {len(ids)}")
    direct = engine.process_frames(frames, t, v)
    direct = tuple(
        direct[k].cpu().numpy() for k in ("face_valid", "bboxes", "match_idx", "match_scores")
    )
    for i, (f, s) in enumerate(slots):
        if ids[direct[2][f, s, 0]] != f"s{i:03d}" or direct[3][f, s, 0] <= 0.99:
            fail(f"enrolled slot {(f, s)} matched {ids[direct[2][f, s, 0]]}")
    hit = manager.search(emb[slots[0][0], slots[0][1]], top_k=2)
    if hit[0][:2] != ("s000", "Student 0") or hit[0][2] <= 0.99:
        fail(f"GalleryManager.search returned {hit}")
    batcher = DeviceBatcher(
        engine, manager.device_snapshot, max_batch=BATCH, max_wait_ms=5.0,
        top_k=3, bucket_sizes=(BATCH,),
    )
    batcher.warmup(DET_SIZE)
    batcher.start()
    try:
        futs = [batcher.submit(frames_np[i % BATCH]) for i in range(8)]
        results = [fu.result(timeout=120) for fu in futs]
    finally:
        batcher.stop()
    for i, r in enumerate(results):
        if r["gallery_ids"] != ids:
            fail(f"request {i}: the result carries another generation's ids")
        check_request(i, r, direct, i % BATCH)
    print(f"[requests] 8 DeviceBatcher requests with a GalleryManager provider (199 "
          f"students, saved and loaded) answered, each equal to the direct step")


# ------------------------------------------------------------ phase 7

SERVER_THRESHOLD = 0.9
# requests of one timed run: (clients, requests each). A p95 is read from at
# least 200 requests at the enrolled gallery and 120 at the large one.
SERVER_RUNS = ((1, 200), (4, 100))
BIG_SERVER_RUNS = ((1, 120), (4, 60))
# the servers' large gallery file: the first 262 144 of phase 5's identities
# and its planted rows (a quarter of 1 048 576: writing and loading the
# file is most of phase 7, and the run has a time limit)
BIG_SERVER_ROWS = 1 << 18


def pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def start_server(tmp, name, **kw):
    """A FaceRecognitionServer built by its constructor (it makes its own
    detector, embedder, engine and batcher on the card) and served on a
    thread. Returns (server, httpd, thread, url)."""
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer, serve

    t0 = time.perf_counter()
    server = FaceRecognitionServer(
        similarity_threshold=SERVER_THRESHOLD,
        output_dir=os.path.join(tmp, name, "sessions"),
        architecture=ARCH,
        detector_weights=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
        det_size=DET_SIZE, max_faces=MAX_FACES, batch_max=BATCH,
        batch_buckets=(1, BATCH), device=DEVICE, **kw,
    )
    if server.device.type != "cuda" or server.engine.detector.crop_impl != "kernel":
        fail(f"server {name}: not on the card with the kernels selected")
    if server.batcher.bucket_sizes != [1, BATCH]:
        fail(f"server {name}: buckets {server.batcher.bucket_sizes}")
    httpd = serve(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    print(f"[server {name}] built, warmed (buckets {server.batcher.bucket_sizes}) and "
          f"listening in {time.perf_counter() - t0:.1f} s")
    return server, httpd, thread, url


def stop_server(server, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    thread.join(timeout=30)
    if thread.is_alive():
        fail("a server thread did not stop")


def direct_faces(server, canvas):
    """One direct step of the server's engine on one prepared canvas, against
    the snapshot the batcher would dispatch with: per quality-passing face
    its box, detection score, embedding and top-1 (id, score)."""
    import torch

    t, v, ids = server.gallery.device_snapshot()
    out = server.engine.process_frames(canvas[None], t, v, gallery_k=3)
    torch.cuda.synchronize()
    ok = (out["face_valid"][0] & out["quality_ok"][0]).cpu().numpy()
    boxes = out["bboxes"][0].cpu().numpy()
    det = out["det_scores"][0].cpu().numpy()
    emb = out["embeddings"][0].float().cpu().numpy()
    idx = out["match_idx"][0].cpu().numpy()
    sc = out["match_scores"][0].cpu().numpy()
    faces = []
    for s in range(len(ok)):
        if ok[s]:
            i = int(idx[s, 0])
            faces.append({
                "bbox": boxes[s], "det": float(det[s]), "emb": emb[s],
                "top1": ids[i] if 0 <= i < len(ids) else None, "score": float(sc[s, 0]),
            })
    return faces


def expected_students(faces):
    """Students the tracker must end up recognizing for these direct faces
    (the gate attempts a track whose detection score exceeds 0.6), and those
    it may or may not (a score within 0.01 of a threshold: the served batch
    is another size than the direct step's, and bf16 sums differ with it)."""
    sure, maybe = set(), set()
    for f in faces:
        if f["top1"] is None or f["det"] <= 0.59 or f["score"] < SERVER_THRESHOLD - 0.01:
            continue
        firm = f["det"] > 0.61 and f["score"] >= SERVER_THRESHOLD + 0.01
        (sure if firm else maybe).add(f["top1"])
    return sure, maybe - sure


def check_response(tag, body, faces, scale) -> None:
    import numpy as np

    if body["faces_detected"] != len(faces):
        fail(f"{tag}: faces_detected {body['faces_detected']} != direct step's {len(faces)}")
    got = np.array([t["bbox"] for t in body["tracks"]], np.float32).reshape(-1, 4)
    for f in faces:
        want = f["bbox"] / scale
        if not len(got) or np.abs(got - want).max(axis=1).min() > 1.0:
            fail(f"{tag}: no served box within 1 px of the direct step's {want}")


def drive_clients(tag, server, url, tmp, image_format, frame, n_clients, n_each,
                  faces, enrolled):
    """One session: `n_clients` client threads, `n_each` frames each, every
    answer checked. Returns the numbers of the run."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.ops import (
        crop_kernel,
        gallery_kernel,
        int8_gemm,
        nms_kernel,
        warp_kernel,
    )
    from facerecognitionpipeline_tpu_torch.serve.bench import StepEvents
    from facerecognitionpipeline_tpu_torch.serve.client import FaceRecognitionClient

    session = f"{tag.replace(' ', '_').replace('/', '-')}"
    clients = [
        FaceRecognitionClient(
            server_url=url, session_name=session, synthetic=True, frame_skip=1,
            display=False, output_dir=os.path.join(tmp, "client", f"c{i}"),
            image_format=image_format, det_size=DET_SIZE,
        )
        for i in range(n_clients)
    ]
    if not clients[0].check_server() or not clients[0].init_session():
        fail(f"{tag}: /health or /init_session failed")
    counters = {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8, "int8_products": int8_gemm.PRODUCTS,
        "nms_fixpoint": nms_kernel.LAUNCHES,
    }
    # every bucket's graph of the gallery as it now is (a reload made a new
    # generation), captured before the counts
    server.batcher.warmup(DET_SIZE)
    for c in counters.values():
        c.reset()
    steps0 = server.batcher._dispatch_count
    lat = [[] for _ in clients]
    bodies = [[] for _ in clients]
    errors = []

    def run(i):
        try:
            for _ in range(n_each):
                t0 = time.perf_counter()
                body = clients[i].process_frame(frame)
                lat[i].append(1e3 * (time.perf_counter() - t0))
                if body is None:
                    raise RuntimeError("a frame request was not answered with 200")
                bodies[i].append(body)
        except Exception as e:  # noqa: BLE001 - reported below, fails the run
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    with StepEvents(server.engine) as timer:
        w0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - w0
    step_ms = timer.ms()
    if errors or any(th.is_alive() for th in threads):
        fail(f"{tag}: {errors or 'a client thread hung'}")
    got = {k: c.count for k, c in counters.items()}
    steps = server.batcher._dispatch_count - steps0
    n_req = n_clients * n_each

    for i in range(n_clients):
        for j, body in enumerate(bodies[i]):
            check_response(f"{tag} client {i} frame {j}", body, faces, 1.0)
    sure, maybe = expected_students(faces)
    if not enrolled <= sure | maybe:
        fail(f"{tag}: enrolled {sorted(enrolled - sure - maybe)} not expected from the direct step")
    # by the third frame any client sent, every expected student is there
    for i in range(n_clients):
        rec = {r["student_id"] for r in bodies[i][2]["recognized_tracks"].values()}
        if not sure <= rec or not rec <= sure | maybe:
            fail(f"{tag} client {i}: recognized {sorted(rec)} by the third frame, "
                 f"expected {sorted(sure)} (+ maybe {sorted(maybe)})")
    want = {"crop_resize": 3 * steps, "warp_patches": steps, "nms_fixpoint": 3 * steps}
    if any(got[k] != n for k, n in want.items()) or steps < 1 or steps > n_req \
            or len(step_ms) != steps:
        fail(f"{tag}: {steps} steps for {n_req} requests launched {got}")
    if n_clients > 1 and steps >= n_req:
        fail(f"{tag}: {n_clients} clients at once, yet {steps} steps for {n_req} requests")

    clients[0].finalize_session()
    for c in clients[1:]:
        c._session.close()
    session_dir = os.path.join(server.output_dir, session)
    with open(os.path.join(session_dir, "attendance.json")) as f:
        attendance = json.load(f)
    listed = {r["student_id"] for r in attendance["recognized"]}
    if not sure <= listed or not listed <= sure | maybe:
        fail(f"{tag}: attendance.json lists {sorted(listed)}, expected {sorted(sure)}")
    with open(os.path.join(session_dir, "performance_report_server.json")) as f:
        perf = json.load(f)
    if perf["request_statistics"]["total_requests_processed"] != n_req:
        fail(f"{tag}: the server's report counts "
             f"{perf['request_statistics']['total_requests_processed']} of {n_req} requests")
    if not perf["memory_usage"]["gpu_vram"]["available"] or \
            perf["memory_usage"]["gpu_vram"]["peak_mb"] <= 0:
        fail(f"{tag}: the report has no device memory from torch.cuda")
    all_lat = [x for row in lat for x in row]
    return {
        "tag": tag, "clients": n_clients, "requests": n_req, "steps": steps,
        "launches": got, "p50": pct(all_lat, 50), "p95": pct(all_lat, 95),
        "rps": n_req / wall, "step_p50": pct(step_ms, 50),
        "server_p50": perf["latency_metrics"]["end_to_end_server"]["p50_ms"],
        "recognized": len(listed), "unrecognized": len(attendance["unrecognized"]),
    }


def print_run(r) -> None:
    """One run's line. The share of a request that is not the device step:
    1 - (p50 of the steps dispatched in this run, from CUDA events) / (p50 of
    the request as the client saw it)."""
    share = 1.0 - r["step_p50"] / r["p50"]
    print(f"[serve] {r['tag']}: {r['requests']} requests from {r['clients']} client(s): "
          f"client p50 {r['p50']:.3f} ms, p95 {r['p95']:.3f} ms, {r['rps']:.2f} requests/s; "
          f"{r['steps']} steps, {r['requests'] / r['steps']:.2f} frames per step, step p50 "
          f"{r['step_p50']:.3f} ms inside the run; server monitor latency_e2e_server_ms "
          f"p50 {r['server_p50']:.3f}; {share:.3f} of a request is not the device step; "
          f"launches {r['launches']}; {r['recognized']} students recognized, "
          f"{r['unrecognized']} tracks unrecognized")


def host_stage_times(frame, response) -> None:
    """The host stages of a request, each timed alone (median of 20): what
    the server pays besides the queue and the step."""
    import base64

    import numpy as np

    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import _encode_image_base64
    from facerecognitionpipeline_tpu_torch.serve.server import _decode_image_b64

    def med(fn):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[10]

    b64 = _encode_image_base64(frame)
    body = json.dumps({"frame": b64, "frame_count": 1, "timestamp": "t"}).encode()
    canvas, _ = rawproto.letterbox_rgb(frame, DET_SIZE)
    yuv = rawproto.rgb_to_i420(canvas)
    raw = canvas.tobytes()
    stages = {
        "client: PNG encode + base64": lambda: _encode_image_base64(frame),
        "client: letterbox": lambda: rawproto.letterbox_rgb(frame, DET_SIZE),
        "client: RGB -> I420": lambda: rawproto.rgb_to_i420(canvas),
        "server: JSON parse of the PNG body": lambda: json.loads(body),
        "server: base64 + PNG decode": lambda: _decode_image_b64(b64),
        "server: letterbox": lambda: rawproto.letterbox_rgb(frame, DET_SIZE),
        "server: frombuffer + reshape (raw)": lambda: np.frombuffer(raw, np.uint8).reshape(
            DET_SIZE[0], DET_SIZE[1], 3),
        "server: JSON encode of the response": lambda: json.dumps(response).encode(),
    }
    print(f"[serve-host] image codec: cv2; PNG body {len(body)} bytes, rgb24 "
          f"{len(raw)} bytes, i420 {yuv.nbytes} bytes, response {len(json.dumps(response))} "
          f"bytes; base64 alone {med(lambda: base64.b64decode(b64)):.3f} ms")
    for name, fn in stages.items():
        print(f"[serve-host] {name}: {med(fn):.3f} ms")


def snapshot_cost(label, manager) -> None:
    manager.device_snapshot()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        snap = manager.device_snapshot()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"[serve-host] GalleryManager.device_snapshot with {len(snap[2])} ids "
          f"({label}): p50 {sorted(times)[10]:.4f} ms, max {max(times):.4f} ms of host "
          f"time per call (it copies the id list)")


def bad_requests(url) -> None:
    """A bad session name and a short raw body get 400, and the next request
    on the same connection still parses."""
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    http = HTTPSession()
    try:
        if http.get(f"{url}/health", timeout=10).status_code != 200:
            fail("/health did not answer 200")
        conn = next(iter(http._conns.values()))
        r = http.post(f"{url}/init_session", json={"session_name": "../escape"}, timeout=10)
        if r.status_code != 400 or "invalid session_name" not in r.text:
            fail(f"a session name with '..' got {r.status_code}: {r.text[:200]}")
        r = http.post(
            f"{url}/process_frame_raw", data=b"\x00" * 1000, timeout=10,
            headers={rawproto.HEADER_FORMAT: "rgb24",
                     rawproto.HEADER_WIDTH: str(DET_SIZE[1]),
                     rawproto.HEADER_HEIGHT: str(DET_SIZE[0]),
                     rawproto.HEADER_SCALE: "1.0"},
        )
        if r.status_code != 400 or "must be exactly" not in r.text:
            fail(f"a short raw body got {r.status_code}: {r.text[:200]}")
        r = http.post(f"{url}/process_frame", json={"frame": "AAAA"}, timeout=10)
        if r.status_code != 400 or "could not decode frame" not in r.text:
            fail(f"an undecodable frame got {r.status_code}: {r.text[:200]}")
        r = http.get(f"{url}/health", timeout=10)
        if r.status_code != 200 or r.json()["status"] != "ok":
            fail("the request after the bad ones did not parse")
        if next(iter(http._conns.values())) is not conn:
            fail("the connection did not survive the 400s")
        times = []
        for _ in range(30):
            t0 = time.perf_counter()
            http.get(f"{url}/health", timeout=10)
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"[serve-host] GET /health round trip on a kept-alive connection: p50 "
              f"{sorted(times)[15]:.3f} ms, max {max(times):.3f} ms (host clock)")
    finally:
        http.close()
    print("[serve] a '..' session name, a short raw body and an undecodable frame got "
          "400; the next request on the same connection parsed")


def enrol_students(name, server, url, canvas, gallery_path, rng):
    """Enrol through the manager's file: every other face of the server's
    direct step that the tracker's gate will attempt, among 200 seeded
    others; POST /reload_gallery twice (reloaded, then unchanged). Returns
    the direct step's faces after the reload, the enrolled ids and the first
    reload's answer."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    faces = direct_faces(server, canvas)
    strong = [f for f in faces if f["det"] > 0.7]
    if len(strong) < 8:
        fail(f"{name}: only {len(strong)} of {len(faces)} faces pass the gate")
    writer = GalleryManager(gallery_path, verbose=False, device=DEVICE)
    enrolled = set()
    for i in range(200):
        writer.add_student(
            f"other{i:03d}", f"Other {i}",
            rng.normal(size=(2, 512)).astype(np.float32),
        )
        if i % 25 == 0 and i // 25 < len(strong[::2]):
            sid = f"face{i // 25:02d}"
            writer.add_student(
                sid, f"Face {i // 25}",
                np.repeat(strong[::2][i // 25]["emb"][None], 2, axis=0),
            )
            enrolled.add(sid)
    writer.save()
    http = HTTPSession()
    try:
        first = http.post(f"{url}/reload_gallery", json={}, timeout=60).json()
        second = http.post(f"{url}/reload_gallery", json={}, timeout=60).json()
    finally:
        http.close()
    if (first.get("status"), second.get("status")) != ("reloaded", "unchanged") \
            or first["num_students"] != 200 + len(enrolled):
        fail(f"{name}: /reload_gallery answered {first} then {second}")
    faces = direct_faces(server, canvas)
    own = {f["top1"] for f in faces if f["score"] > 0.99}
    if not enrolled <= own:
        fail(f"{name}: enrolled faces {sorted(enrolled - own)} are not their "
             f"own top-1 in the direct step")
    return faces, enrolled, first


def server_phase(ctx, gal, report) -> None:
    """Phase 7: the HTTP server on the card (see the module docstring)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.bench import StepEvents
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    frame = ctx["frames_np"][0]
    rng = np.random.default_rng(5)
    report["server_launches"] = {}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for transport, formats in (("rgb", ("png", "raw")), ("i420", ("raw-i420",))):
            name = f"transport={transport}"
            gallery_path = os.path.join(tmp, name, "gallery", "students.pkl")
            server, httpd, thread, url = start_server(
                tmp, name, gallery_path=gallery_path, transport=transport,
            )
            try:
                canvas, scale = rawproto.letterbox_rgb(frame, DET_SIZE)
                if scale != 1.0 or not np.array_equal(canvas, frame):
                    fail("a frame at det_size must letterbox to itself")
                if transport == "i420":
                    canvas = rawproto.rgb_to_i420(canvas)
                faces, enrolled, first = enrol_students(
                    name, server, url, canvas, gallery_path, rng)
                print(f"[server {name}] {len(enrolled)} of {len(faces)} faces enrolled among "
                      f"{first['num_students']} students; /reload_gallery: reloaded, then "
                      f"unchanged")
                times = []
                with StepEvents(server.engine) as timer:
                    for _ in range(100):
                        t0 = time.perf_counter()
                        server.batcher.submit(canvas).result(timeout=120)
                        times.append(1e3 * (time.perf_counter() - t0))
                print(f"[serve-host] {name}: DeviceBatcher.submit().result() alone, 100 "
                      f"frames one at a time (upload, the {server.batcher.max_wait_s * 1e3:.0f} ms "
                      f"batching window, the step at B=1, results to the host): p50 "
                      f"{pct(times, 50):.3f} ms, p95 {pct(times, 95):.3f} ms; the step "
                      f"inside it p50 {pct(timer.ms(), 50):.3f} ms (CUDA events)")
                for image_format in formats:
                    for n_clients, n_each in SERVER_RUNS:
                        tag = f"{image_format} x{n_clients}"
                        r = drive_clients(tag, server, url, tmp, image_format, frame,
                                          n_clients, n_each, faces, enrolled)
                        print_run(r)
                        runs.append(r)
                http = HTTPSession()
                try:
                    stats = http.get(f"{url}/stats", timeout=10).json()
                finally:
                    http.close()
                allocated = torch.cuda.memory_allocated() / (1024 * 1024)
                if not stats["current_gpu_vram_mb"] > 0 or \
                        abs(stats["current_gpu_vram_mb"] - allocated) > 0.5 * allocated:
                    fail(f"{name}: /stats reports {stats['current_gpu_vram_mb']} MB, "
                         f"torch.cuda {allocated:.1f} MB")
                print(f"[server {name}] /stats: current_gpu_vram_mb "
                      f"{stats['current_gpu_vram_mb']:.1f} (torch.cuda.memory_allocated "
                      f"{allocated:.1f} MB), peak_gpu_vram_mb {stats['peak_gpu_vram_mb']:.1f}")
                if transport == "rgb":
                    bad_requests(url)
                    snapshot_cost("the enrolled gallery", server.gallery)
                    http = HTTPSession()
                    try:
                        body = http.post(
                            f"{url}/process_frame_raw", data=frame.tobytes(), timeout=60,
                            headers={rawproto.HEADER_FORMAT: "rgb24",
                                     rawproto.HEADER_WIDTH: str(DET_SIZE[1]),
                                     rawproto.HEADER_HEIGHT: str(DET_SIZE[0]),
                                     rawproto.HEADER_SCALE: "1.0"},
                        ).json()
                    finally:
                        http.close()
                    host_stage_times(frame, body)
            finally:
                stop_server(server, httpd, thread)
            del server
            torch.cuda.empty_cache()
        for k in ("crop_resize", "warp_patches", "nms_fixpoint"):
            report["server_launches"][k] = sum(r["launches"][k] for r in runs)
        report["serve_runs"] = runs
        if any(r["launches"]["gallery_topk"] or r["launches"]["gallery_topk_int8"] for r in runs):
            fail("a gallery of a few hundred students must take the dense match")

        # the compact galleries behind the server: BIG_SERVER_ROWS of phase
        # 5's identities and the rows it planted. The records are made in
        # bulk as views of the matrix (what add_student stores for one
        # unit-norm sample) and saved to the manager's pickle once; each
        # server then loads that file through its own constructor
        # (gallery_path, gallery_quantize) and makes the device copy itself.
        gal = gal.cpu().numpy()
        # phase 5 planted the direct step's embeddings of these faces
        planted = [4099 + 131_101 * i for i in range(len(ctx["slots"]))
                   if ctx["slots"][i][0] == 0]
        planted_rows = {f"id{i}" for i in planted}
        keep = list(range(BIG_SERVER_ROWS)) + [i for i in planted if i >= BIG_SERVER_ROWS]
        big = len(keep)
        now = "2026-01-01T00:00:00"
        big_path = os.path.join(tmp, "big", "students.pkl")
        t0 = time.perf_counter()
        writer = GalleryManager(big_path, verbose=False, device=DEVICE)
        writer.students = {
            f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", gal[i:i + 1], gal[i], 1, now, now)
            for i in keep
        }
        writer.save()
        del writer
        print(f"[server big] GalleryManager file of {big} identities written in "
              f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(big_path) / 2**30:.2f} GiB)")
        for quantize, kernel in ((None, "gallery_topk"), ("int8", "gallery_topk_int8")):
            label = quantize or "bf16"
            server, httpd, thread, url = start_server(
                tmp, f"big-{label}", gallery_path=big_path, gallery_quantize=quantize,
                transport="rgb",
            )
            try:
                t, v, ids = server.gallery.device_snapshot()
                if server.gallery.gallery_path != big_path or len(ids) != big or \
                        (quantize is None and t.dtype != torch.bfloat16) or \
                        (quantize == "int8" and not (isinstance(t, tuple)
                                                     and t[0].dtype == torch.int8)):
                    fail(f"big-{label}: the server's own gallery is not the {label} compact "
                         f"copy of the file")
                del t, v, ids
                snapshot_cost(f"{label} compact copy", server.gallery)
                faces = direct_faces(server, frame)
                planted = planted_rows & expected_students(faces)[0]
                if len(planted) < 4:
                    fail(f"big-{label}: only {sorted(planted)} of the planted rows "
                         f"{sorted(planted_rows)} are firm top-1 matches of the direct step")
                for n_clients, n_each in BIG_SERVER_RUNS:
                    r = drive_clients(f"raw x{n_clients} {big} ids {label}", server, url, tmp,
                                      "raw", frame, n_clients, n_each, faces, planted)
                    other = "gallery_topk_int8" if kernel == "gallery_topk" else "gallery_topk"
                    if r["launches"][kernel] != r["steps"] or r["launches"][other]:
                        fail(f"big-{label}: {r['steps']} steps launched {r['launches']}")
                    print_run(r)
                    report["server_launches"][kernel] = \
                        report["server_launches"].get(kernel, 0) + r["launches"][kernel]
            finally:
                stop_server(server, httpd, thread)
            del server
            torch.cuda.empty_cache()
    for name, n in report["server_launches"].items():
        if n < 1:
            fail(f"the server's path never launched {name}")
    print(f"[serve] launches on the server's path: {report['server_launches']}")


# ------------------------------------------------------------ phase 8

INT8_STEP_ITERS = 12
INT8_SERVER_REQUESTS = 200
# int8 layers' shapes that no serving step gives, each held to its plain
# version as well: one row (K = 45, N = 28), K = 27 with N = 28 (27 rows), and
# a dense layer of 5 rows with K = 27 and N = 28
INT8_ODD_SHAPES = (("conv", 1, 3, 3, 5, 3, 1, 0, 28), ("conv", 3, 5, 5, 3, 3, 1, 0, 28),
                   ("dense", 5, 27, 28))


def quant_layers(*modules):
    from facerecognitionpipeline_tpu_torch.models.irse import QuantConv, QuantDense

    return [m for mod in modules for m in mod.modules() if isinstance(m, (QuantConv, QuantDense))]


def int8_step_shapes(engine, frames, t, v) -> dict:
    """The int8 layers' input shapes in one step of `engine`, with how many
    layers of the step take each: {("conv", B, H, W, C, k, stride, padding,
    N) or ("dense", M, K, N): count}."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.irse import QuantConv

    seen: dict = {}

    def hook(module, inputs):
        x = inputs[0]
        if isinstance(module, QuantConv):
            b, c, h, w = x.shape
            key = ("conv", b, h, w, c, module.ksize[0], module.stride, module.padding,
                   module.features)
        else:
            key = ("dense", x.shape[0], x.shape[1], module.features)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook)
             for m in quant_layers(engine.detector.nets, engine.embedder.model)]
    try:
        # the eager step: a graph's replay calls no module, so runs no hook
        engine.step(t, v, frames, 3)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return seen


def int8_product_phase(shapes: dict) -> dict:
    """The int8 product at every distinct shape of the step and at the odd
    ones: the card route (im2col + cuBLASLt int8) against its plain version
    (the same im2col, float64 sums) on the same random codes, which must be
    equal; the im2col and the product timed apart (CUDA events), beside a
    bf16 cuDNN conv (or matmul) of the same shape and the bound by
    operations. Returns the sums over one step's layers."""
    import torch
    import torch.nn.functional as F

    from facerecognitionpipeline_tpu_torch.ops import int8_gemm

    g = torch.Generator(device=DEVICE).manual_seed(8)
    total = {"im2col_ms": 0.0, "product_ms": 0.0, "cudnn_bf16_ms": 0.0, "bound_ms": 0.0,
             "layers": 0}
    for key, count in list(shapes.items()) + [(k, 0) for k in INT8_ODD_SHAPES]:
        def codes(*shape):
            return torch.randint(-127, 128, shape, generator=g, device=DEVICE,
                                 dtype=torch.int8)

        if key[0] == "conv":
            _, b, h, w, c, k, stride, pad, n = key
            x = codes(b, h, w, c)
            wq = codes(k * k * c, n)
            packed = int8_gemm.pack_weight(wq)
            ho = (h + 2 * pad - k) // stride + 1
            wo = (w + 2 * pad - k) // stride + 1
            m, kk = b * ho * wo, k * k * c

            def col(x=x, k=k, stride=stride, pad=pad, kp=packed.shape[1]):
                return int8_gemm.im2col(x, (k, k), stride, pad, kp)

            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # NCHW view, channels last
            wb = wq.reshape(k, k, c, n).permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()

            def lib(xb=xb, wb=wb, stride=stride, pad=pad):
                return F.conv2d(xb, wb, stride=stride, padding=pad)

            desc = f"conv {k}x{k}/{stride} pad {pad} [{b},{h},{w},{c}] -> {n}"
        else:
            _, m, kk, n = key
            x = codes(m, kk)
            wq = codes(kk, n)
            packed = int8_gemm.pack_weight(wq)

            def col(x=x, kp=packed.shape[1]):
                return torch.cat([x, x.new_zeros((x.shape[0], kp - x.shape[1]))], dim=1) \
                    if kp > x.shape[1] else x

            xb = x.to(torch.bfloat16)
            wb = wq.t().to(torch.bfloat16).contiguous()

            def lib(xb=xb, wb=wb):
                return F.linear(xb, wb)

            desc = f"dense [{m},{kk}] -> {n}"
        a = col()
        int8_gemm.PRODUCTS.reset()
        got = int8_gemm.int8_product(a, packed, n)
        if int8_gemm.PRODUCTS.count != 1:
            fail(f"int8 product {desc} did not take the card route")
        want = int8_gemm.int8_product(a, packed, n, plain=True)
        err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
        if got.dtype != torch.int32 or tuple(got.shape) != (m, n) or not torch.equal(got, want):
            fail(f"int8 product {desc}: card route differs from its plain version "
                 f"(max |card - plain| {err})")
        ms_col = cuda_time_ms(col) if a is not x else 0.0
        ms_prod = cuda_time_ms(lambda a=a, packed=packed, n=n: int8_gemm.int8_product(a, packed, n))
        ms_lib = cuda_time_ms(lib)
        bound = 2.0 * m * kk * n / INT8_OPS_PER_S * 1e3
        print(f"[int8] product {desc} (x{count} per step; M={m} K={kk} N={n}): im2col "
              f"{ms_col:.4f} ms, product {ms_prod:.4f} ms, bf16 cuDNN "
              f"{'conv' if key[0] == 'conv' else 'matmul'} {ms_lib:.4f} ms, bound "
              f"{bound:.4f} ms (operations at 1979 TOPS); max |card - plain| {err}")
        total["im2col_ms"] += count * ms_col
        total["product_ms"] += count * ms_prod
        total["cudnn_bf16_ms"] += count * ms_lib
        total["bound_ms"] += count * bound
        total["layers"] += count
        del a, got, want, x, wq, packed, xb, wb
    torch.cuda.empty_cache()
    share = total["im2col_ms"] / (total["im2col_ms"] + total["product_ms"])
    print(f"[int8] the step's {total['layers']} int8 layers, summed: im2col "
          f"{total['im2col_ms']:.3f} ms + product {total['product_ms']:.3f} ms (im2col share "
          f"{share:.3f}); the same shapes as bf16 cuDNN {total['cudnn_bf16_ms']:.3f} ms; bound "
          f"{total['bound_ms']:.3f} ms; every shape equal to its plain version")
    return {**total, "im2col_share": share}


def int8_phase(ctx, gal, report) -> None:
    """Phase 8: the int8 tier (see the module docstring)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, int8_gemm
    from facerecognitionpipeline_tpu_torch.ops import warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    res: dict = {}
    t0 = time.perf_counter()
    detector = MTCNNDetector(
        det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES, min_face_size=40,
        dtype=torch.bfloat16, device=DEVICE, quantize="int8",
        weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
    )
    torch.cuda.synchronize()
    res["detector_calibration_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    embedder = FaceEmbedder(ARCH, dtype=torch.bfloat16, random_ok=True, init_seed=0,
                            quantize="int8", device=DEVICE)
    torch.cuda.synchronize()
    res["embedder_calibration_s"] = time.perf_counter() - t0
    print(f"[int8] MTCNNDetector(quantize='int8') calibrated on 6 synthetic frames and "
          f"quantized in {res['detector_calibration_s']:.1f} s; FaceEmbedder({ARCH}, "
          f"quantize='int8') on 64 synthetic crops in {res['embedder_calibration_s']:.1f} s")
    engine = RecognitionEngine(detector, embedder, top_k=3)
    if not (detector.quantized and embedder.quantized) or detector.crop_impl != "kernel" \
            or engine.align_impl != "kernel":
        fail("the int8 build is not quantized or did not select the kernels")
    frames, frames_np = ctx["frames"], ctx["frames_np"]
    rng = np.random.default_rng(8)
    rows_f32 = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    rows_f32 /= np.linalg.norm(rows_f32, axis=1, keepdims=True)
    ids = [f"id{i}" for i in range(GALLERY_ROWS)]
    gallery = DeviceGallery(device=DEVICE)
    gallery.rebuild(ids, rows_f32)
    t, v, _ = gallery.device_snapshot()

    # 8a: the int8 product at the step's shapes
    shapes = int8_step_shapes(engine, frames, t, v)
    per_step = sum(shapes.values())
    res["int8_layers_per_step"] = per_step
    res["product"] = int8_product_phase(shapes)

    # 8b: the quantized step
    out = engine.process_frames(frames, t, v)
    recall, hits, total = detection_recall(out, ctx["gts"])
    print(f"[int8] detection recall {recall:.3f} ({hits}/{total} faces, IoU>=0.5) with the "
          f"int8 R-net and O-net")
    if recall < 0.8:
        fail(f"int8 recall {recall} < 0.8")
    for key in ("bboxes", "landmarks", "embeddings", "match_scores", "embedding_norms"):
        if not torch.isfinite(out[key]).all():
            fail(f"int8 step: non-finite {key}")
    valid = out["face_valid"].cpu().numpy()
    emb = out["embeddings"].float().cpu().numpy()
    slots = [(f, s) for f in range(BATCH) for s in range(MAX_FACES) if valid[f, s]][:8]
    planted = rows_f32.copy()
    rows = [100 + 37 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        planted[row] = emb[f, s]
    gallery.rebuild(ids, planted)
    t, v, _ = gallery.device_snapshot()
    engine.process_frames(frames, t, v)  # this gallery's graph, captured before the counts
    counters = {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8, "int8_products": int8_gemm.PRODUCTS,
    }
    for c in counters.values():
        c.reset()
    out, ms8 = timed_steps(engine, frames, t, v, INT8_STEP_ITERS)
    got = {k: c.count for k, c in counters.items()}
    want = {"crop_resize": 3 * INT8_STEP_ITERS, "warp_patches": INT8_STEP_ITERS,
            "gallery_topk": 0, "gallery_topk_int8": 0,
            "int8_products": per_step * INT8_STEP_ITERS}
    print(f"[int8] launches over {INT8_STEP_ITERS} int8 steps: {got}")
    if got != want:
        fail(f"int8 step: expected {want}, got {got}")
    res["launches"] = got
    idx = out["match_idx"].cpu().numpy()
    sc = out["match_scores"].cpu().numpy()
    for row, (f, s) in zip(rows, slots):
        if idx[f, s, 0] != row or sc[f, s, 0] <= 0.99:
            fail(f"int8 step: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
    print(f"[int8] {len(slots)} planted int8 embeddings came back top-1 (min score "
          f"{min(sc[f, s, 0] for f, s in slots):.5f})")

    # the same step with every int8 layer on the plain product: both sums are
    # exact, so the embeddings must be identical (cuDNN held deterministic
    # for the float layers around them)
    layers = quant_layers(detector.nets, embedder.model)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # eager steps: a layer's `plain` switch is read when the step runs
        # its Python, which a graph's replay does not
        card = engine.step(t, v, frames, 3)
        for m in layers:
            m.plain = True
        int8_gemm.PRODUCTS.reset()
        plain = engine.step(t, v, frames, 3)
        torch.cuda.synchronize()
    finally:
        for m in layers:
            m.plain = False
        torch.backends.cudnn.deterministic = deterministic
    if int8_gemm.PRODUCTS.count:
        fail("the plain step still took the card route")
    diff = (card["embeddings"].float() - plain["embeddings"].float()).abs().max().item()
    if not (torch.equal(card["face_valid"], plain["face_valid"])
            and torch.equal(card["bboxes"], plain["bboxes"])
            and torch.equal(card["embeddings"], plain["embeddings"])):
        fail(f"int8 step: the card's product and the plain product give different answers "
             f"(embeddings max |diff| {diff})")
    print("[int8] the same step with the plain product (float64 sums) on the card: identical "
          "detections and embeddings")

    # int8 against bf16 on the same detected faces
    ok = card["face_valid"]
    faces = card["aligned"][ok].float()
    with torch.inference_mode():
        e8 = embedder.embed_batch_device(faces)[0]
        e16 = ctx["embedder"].embed_batch_device(faces)[0]
    cos = (e8 * e16).sum(-1).float().cpu().numpy()
    res["cos_int8_bf16_min"] = float(cos.min())
    res["cos_int8_bf16_median"] = float(np.median(cos))
    print(f"[int8] cosine of int8 against bf16 embeddings of the same {len(cos)} detected "
          f"faces: min {cos.min():.5f}, median {np.median(cos):.5f} (random {ARCH} weights; "
          f"no limit set)")

    # timing, bf16 then int8 again, in this run
    _, ms16 = timed_steps(ctx["engine"], frames, t, v, INT8_STEP_ITERS)
    _, ms8b = timed_steps(engine, frames, t, v, INT8_STEP_ITERS)
    for label, ms in (("int8", ms8), ("bf16", ms16), ("int8 again", ms8b)):
        p50 = ms[len(ms) // 2]
        res[f"step_p50_ms_{label.replace(' ', '_')}"] = p50
        print(f"[int8] fused step B={BATCH} {ARCH} {label}, {GALLERY_ROWS}-row gallery: p50 "
              f"{p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {INT8_STEP_ITERS} steps")
    bd8 = breakdown(engine, frames, t, v, tag="int8 breakdown")
    bd16 = breakdown(ctx["engine"], frames, t, v, tag="bf16 breakdown")
    for label, bd in (("int8", bd8), ("bf16", bd16)):
        res[f"device_ms_{label}"] = bd["device_ms"]
        res[f"busy_{label}"] = bd["busy"]
        for name, ms in bd["layers"].items():
            res[f"{name.split(' ')[0]}_ms_{label}"] = ms
    print(f"[int8] device time per step (torch.profiler): int8 {bd8['device_ms']} ms, bf16 "
          f"{bd16['device_ms']} ms; embed alone {res['embed_ms_int8']:.3f} against "
          f"{res['embed_ms_bf16']:.3f} ms, detect alone {res['detect_ms_int8']:.3f} against "
          f"{res['detect_ms_bf16']:.3f} ms")
    del gallery, t, v, out, card, plain

    # 8c: the all-int8 deployment: the int8 step against 1 048 576 int8 rows
    big = gal.shape[0]
    big_rows = [7001 + 131_101 * i for i in range(len(slots))]
    for row, (f, s) in zip(big_rows, slots):
        gal[row] = torch.from_numpy(emb[f, s]).to(DEVICE)
    t0 = time.perf_counter()
    big_gallery = DeviceGallery(device=DEVICE, quantize="int8")
    big_gallery.rebuild([f"id{i}" for i in range(big)], gal)
    t, v, _ = big_gallery.device_snapshot()
    torch.cuda.synchronize()
    if not (isinstance(t, tuple) and t[0].dtype == torch.int8):
        fail("the 1 048 576-row gallery is not the int8 pair")
    print(f"[int8] int8 DeviceGallery of {big} identities rebuilt in "
          f"{time.perf_counter() - t0:.2f} s")
    engine.process_frames(frames, t, v)  # warm
    for c in counters.values():
        c.reset()
    out, ms = timed_steps(engine, frames, t, v, BIG_STEP_ITERS)
    got = {k: c.count for k, c in counters.items()}
    want = {"crop_resize": 3 * BIG_STEP_ITERS, "warp_patches": BIG_STEP_ITERS,
            "gallery_topk": 0, "gallery_topk_int8": BIG_STEP_ITERS,
            "int8_products": per_step * BIG_STEP_ITERS}
    if got != want:
        fail(f"all-int8 step: expected {want}, got {got}")
    idx = out["match_idx"].cpu().numpy()
    sc = out["match_scores"].cpu().numpy()
    for row, (f, s) in zip(big_rows, slots):
        if idx[f, s, 0] != row or sc[f, s, 0] <= 0.98:
            fail(f"all-int8 step: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
    p50 = ms[len(ms) // 2]
    res["step_p50_ms_1m_int8_gallery"] = p50
    res["launches_1m_int8_gallery"] = got
    print(f"[int8] all-int8 step against {big} int8 rows: {len(slots)} planted rows top-1 (min "
          f"score {min(sc[f, s, 0] for f, s in slots):.5f}, floor 0.98); launches {got}; p50 "
          f"{p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {BIG_STEP_ITERS} steps")
    ctx["int8_engine"] = engine  # phase 13's quantize='int8' route
    del big_gallery, t, v, out, engine, detector, embedder
    torch.cuda.empty_cache()

    # 8d: one int8 server, built by its constructor, one raw rgb24 client
    frame = frames_np[0]
    with tempfile.TemporaryDirectory() as tmp:
        gallery_path = os.path.join(tmp, "int8", "gallery", "students.pkl")
        server, httpd, thread, url = start_server(
            tmp, "int8", gallery_path=gallery_path, transport="rgb", quantize="int8")
        try:
            if not (server.engine.detector.quantized and server.engine.embedder.quantized):
                fail("the server's quantize='int8' build is not quantized")
            faces, enrolled, first = enrol_students(
                "int8", server, url, frame, gallery_path, np.random.default_rng(5))
            print(f"[int8] server: {len(enrolled)} of {len(faces)} faces of its direct int8 step "
                  f"enrolled among {first['num_students']} students")
            r = drive_clients("raw x1 int8", server, url, tmp, "raw", frame, 1,
                              INT8_SERVER_REQUESTS, faces, enrolled)
            if r["launches"]["int8_products"] != per_step * r["steps"]:
                fail(f"int8 server: {r['launches']['int8_products']} int8 products over "
                     f"{r['steps']} steps, expected {per_step} per step")
            print_run(r)
        finally:
            stop_server(server, httpd, thread)
        del server
        torch.cuda.empty_cache()
    bf16 = next(x for x in report["serve_runs"] if x["tag"] == "raw x1")
    res["server"] = {k: r[k] for k in ("requests", "steps", "p50", "p95", "rps", "step_p50",
                                       "server_p50", "launches")}
    res["server_bf16_phase7"] = {k: bf16[k] for k in ("requests", "p50", "p95", "rps",
                                                      "step_p50")}
    print(f"[int8] server raw rgb24 x1, {r['requests']} requests: int8 p50 {r['p50']:.3f} ms, "
          f"p95 {r['p95']:.3f} ms, {r['rps']:.2f} requests/s; bf16 (phase 7) p50 "
          f"{bf16['p50']:.3f} ms, p95 {bf16['p95']:.3f} ms, {bf16['rps']:.2f} requests/s")
    report["int8"] = res


# ------------------------------------------------------------ phase 9

ENROL_STUDENTS = 8
ENROL_PHOTOS = 4
MATCH_TOP_KS = (5, 16, 64)


def onnx_initializers_bytes(tensors: dict) -> bytes:
    """A minimal ONNX ModelProto whose graph holds only initializers: per
    tensor a TensorProto with its dims (field 1), data type float32 (2),
    name (8) and little-endian raw data (9), written from the protobuf wire
    format (no onnx package). What `models/onnx_import.py` reads."""
    import numpy as np

    def varint(v):
        out = b""
        while True:
            b, v = v & 0x7F, v >> 7
            if v:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def tag(field, wire):
        return varint((field << 3) | wire)

    def field(num, payload):
        return tag(num, 2) + varint(len(payload)) + payload

    parts = []
    for name, arr in tensors.items():
        arr = np.asarray(arr, np.float32)
        body = b"".join(tag(1, 0) + varint(d) for d in arr.shape)
        body += tag(2, 0) + varint(1) + field(8, name.encode()) + field(9, arr.tobytes())
        parts.append(field(5, body))
    graph = b"".join(parts)
    return tag(1, 0) + varint(7) + field(7, graph)


def seeded_unfolded_tree(arch: str, seed: int) -> dict:
    """JAX-format {'params', 'batch_stats'} of the port's unfolded `arch`,
    weights from a seed."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.convert import backbone_variables_from_state
    from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
    from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_

    model = build_backbone(arch, folded=False)
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    return backbone_variables_from_state(model.state_dict())


def render_students(tmp: str, gate) -> list:
    """ENROL_STUDENTS directories of ENROL_PHOTOS photos. A student is one
    `render_identity_scene` face, upscaled 3x so it meets the enrolment gate
    (faces of 60 px, blur 100); the photos differ in a 40 px corner patch, as
    the JAX package's enrolment tests vary theirs. A face whose best detection
    fails the gate is drawn again. Returns the photo paths per student."""
    import cv2
    import numpy as np

    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_scene,
    )

    rng = np.random.default_rng(9)
    paths, seed = [], 0
    while len(paths) < ENROL_STUDENTS:
        img, *_ = render_identity_scene([make_identity(1000 + seed)], rng, size=160)
        seed += 1
        if seed > 200:
            fail("could not render enough students that pass the enrolment gate")
        img = cv2.resize(img, (480, 480), interpolation=cv2.INTER_LINEAR)
        faces = gate.process_numpy(img)
        if not faces or not faces[0]["is_valid"] or \
                faces[0]["quality_metrics"]["blur_score"] < 120:
            continue
        d = os.path.join(tmp, "enrol", f"student_{len(paths)}")
        os.makedirs(d)
        mine = []
        for i in range(ENROL_PHOTOS):
            photo = img.copy()
            photo[:40, :40] = rng.integers(0, 256, (40, 40, 3))
            mine.append(os.path.join(d, f"photo_{i}.png"))
            cv2.imwrite(mine[-1], cv2.cvtColor(photo, cv2.COLOR_RGB2BGR))
        paths.append(mine)
    return paths


def run_cli(main, argv) -> tuple[int, str]:
    """A CLI's main(argv) with its standard output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def enrolment_phase(ctx, gal, report) -> None:
    """Phase 9: enrolment and offline matching with the weight formats users
    have. Seeded ir_101 weights written as an AdaFace Lightning .ckpt (the
    port's save_adaface_checkpoint) and as a JAX-format .npz, seeded
    iresnet_100 weights as an ArcFace .onnx; students rendered and enrolled
    through cli/enroll_students on the card; face_matcher --single_image;
    the .onnx embedder on the card against the CPU; FaceMatcher against
    1 048 576 identities, bf16 (K3) then int8 (K4), at top_k 5, 16 and 64;
    the engine with gallery_impl='streaming' on a float32 gallery (K3 on
    float32 rows)."""
    import re as _re
    import shutil

    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.cli import enroll_students, face_matcher
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.models import detector as detector_module
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.models.torch_export import (
        export_iresnet_statedict,
        save_adaface_checkpoint,
    )
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.pipeline.enrollment import ENROLLMENT_QUALITY_CONFIG
    from facerecognitionpipeline_tpu_torch.pipeline.matcher import FaceMatcher
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
    from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables

    t_phase = time.perf_counter()
    res = {}
    det_path = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_enrol_")
    try:
        # 9a: the weight files
        t0 = time.perf_counter()
        tree = seeded_unfolded_tree(ARCH, 9)
        ckpt = os.path.join(tmp, "adaface_ir101.ckpt")
        save_adaface_checkpoint(tree, ARCH, ckpt)
        npz = os.path.join(tmp, "ir101.npz")
        save_npz_variables(npz, tree)
        del tree
        isd = export_iresnet_statedict(seeded_unfolded_tree("iresnet_100", 10), "iresnet_100")
        onnx = os.path.join(tmp, "arcface_ir101.onnx")
        with open(onnx, "wb") as f:
            f.write(onnx_initializers_bytes(
                {k: v for k, v in isd.items() if not k.endswith("num_batches_tracked")}))
        del isd
        mb = {p: os.path.getsize(p) / 2**20 for p in (ckpt, npz, onnx)}
        print(f"[enrol] weights written in {time.perf_counter() - t0:.1f} s: AdaFace .ckpt "
              f"{mb[ckpt]:.0f} MiB, .npz {mb[npz]:.0f} MiB, ArcFace .onnx {mb[onnx]:.0f} MiB")

        # 9b: the students, through a bf16 processor (K1 crops) on the card
        gate = FaceProcessor(
            output_size=224, quality_filter_config=dict(ENROLLMENT_QUALITY_CONFIG),
            detector=MTCNNDetector(weights_path=det_path, dtype=torch.bfloat16, device=DEVICE),
            device=DEVICE,
        )
        if gate.detector.crop_impl != "kernel":
            fail("a bf16 cascade must take the K1 crop")
        photos = render_students(tmp, gate)
        flat = [p for mine in photos for p in mine]
        for c in (crop_kernel.LAUNCHES, warp_kernel.LAUNCHES):
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in flat:
            if not gate.process_image(p):
                fail(f"the bf16 processor found no face in {p}")
        torch.cuda.synchronize()
        res["process_image_per_s"] = len(flat) / (time.perf_counter() - t0)
        res["launches_k1"] = crop_kernel.LAUNCHES.count
        if res["launches_k1"] != 2 * len(flat) or warp_kernel.LAUNCHES.count:
            fail(f"the bf16 processor launched K1 {res['launches_k1']} times for "
                 f"{len(flat)} images (want 2 each) and K2 {warp_kernel.LAUNCHES.count}")
        print(f"[enrol] {len(flat)} photos of {ENROL_STUDENTS} students through "
              f"FaceProcessor.process_image (bf16 cascade, 640x640): "
              f"{res['process_image_per_s']:.2f} images/s; K1 launched {res['launches_k1']} "
              f"times (R-net and O-net crops of each detect)")

        # 9c: enrol through the CLI, from the .ckpt and from the .npz. The CLI
        # has no detector flag: its processor takes the first default weights
        # file, which here is set to the synthetic cascade.
        galleries = {}
        saved = detector_module.DEFAULT_DETECTOR_WEIGHTS
        detector_module.DEFAULT_DETECTOR_WEIGHTS = (det_path,)
        try:
            for name, path in (("ckpt", ckpt), ("npz", npz)):
                gpath = os.path.join(tmp, f"gallery_{name}", "students.pkl")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc, out = run_cli(enroll_students.main, [
                    "--enrollment_dir", os.path.join(tmp, "enrol"), "--gallery_path", gpath,
                    "--model_path", path, "--architecture", ARCH, "--augmentations", "1",
                    "--device", DEVICE])
                secs = time.perf_counter() - t0
                summary = [ln for ln in out.splitlines()
                           if ln.startswith(("ENROLLMENT SUMMARY", "Verification"))]
                if rc != 0 or not summary:
                    fail(f"enroll_students --model_path {name} failed:\n{out[-3000:]}")
                print(f"[enrol] enroll_students --model_path .{name}: {secs:.1f} s "
                      f"({secs / ENROL_STUDENTS:.2f} s per student, the {ARCH} load and the "
                      f"detector build included); " + "; ".join(summary))
                res[f"enrol_s_per_student_{name}"] = secs / ENROL_STUDENTS
                galleries[name] = GalleryManager(gpath, verbose=False, device=DEVICE)
        finally:
            detector_module.DEFAULT_DETECTOR_WEIGHTS = saved
        a, b = (g.get_all_students() for g in (galleries["ckpt"], galleries["npz"]))
        want_ids = [f"STU{i + 1:04d}" for i in range(ENROL_STUDENTS)]
        if sorted(a) != want_ids or sorted(b) != want_ids:
            fail(f"enrolled ids {sorted(a)} / {sorted(b)}, expected {want_ids}")
        err = max(float(np.abs(a[s].template_embedding - b[s].template_embedding).max())
                  for s in a)
        names = {s: a[s].name for s in a}
        if err > 1e-5 or any(a[s].name != b[s].name for s in a):
            fail(f"the .ckpt and .npz galleries differ: max |template diff| {err}")
        res["ckpt_vs_npz_template_err"] = err
        print(f"[enrol] the .ckpt and .npz galleries agree: {len(a)} students, same names, "
              f"max |template difference| {err:.3g} (limit 1e-5)")

        # 9d: face_matcher --single_image re-detects enrolment photos (the CLI
        # for two students, the same FaceMatcher build for all of them)
        pattern = _re.compile(r"Face 1: Recognized: (\S+) \((STU\d{4})\) - ([0-9.]+)")
        gpath = galleries["ckpt"].gallery_path
        for s in (0, ENROL_STUDENTS - 1):
            rc, out = run_cli(face_matcher.main, [
                "--single_image", photos[s][1], "--gallery_path", gpath, "--model_path", ckpt,
                "--architecture", ARCH, "--detector_weights", det_path, "--top_k", "3",
                "--device", DEVICE])
            m = pattern.search(out)
            if rc != 0 or not m or m.group(2) != want_ids[s] or float(m.group(3)) <= 0.99:
                fail(f"face_matcher --single_image on student {s}: {out[-2000:]}")
            print(f"[match] face_matcher --single_image {os.path.basename(photos[s][1])} of "
                  f"student_{s}: {m.group(0)}")
        embedder = FaceEmbedder(ARCH, model_path=ckpt, device=DEVICE)
        matcher = FaceMatcher(embedder=embedder, gallery=galleries["ckpt"],
                              detector_weights=det_path, device=DEVICE)
        confidences, crops = [], []
        for s in range(ENROL_STUDENTS):
            r = matcher.match_single_image(photos[s][2], top_k=3, save_visualization=False)
            top = r["matches"][0]["top_matches"][0] if r["num_faces"] else {}
            if top.get("student_id") != want_ids[s] or top.get("score", 0) <= 0.99:
                fail(f"student_{s} came back as {top} from its own photo")
            confidences.append(top["score"])
            crops.append(matcher._get_processor().process_image(photos[s][2])[0]["aligned_face"])
        res["single_image_min_confidence"] = min(confidences)
        print(f"[match] all {ENROL_STUDENTS} students top-1 from their own photos "
              f"(min confidence {min(confidences):.5f}, limit 0.99)")

        # 9e: the ArcFace .onnx embedder, card against CPU
        t0 = time.perf_counter()
        e_card = FaceEmbedder(ARCH, model_type="arcface", model_path=onnx, device=DEVICE)
        e_cpu = FaceEmbedder(ARCH, model_type="arcface", model_path=onnx, device="cpu")
        if e_card._build_arch != "iresnet_100":
            fail(f"an ArcFace .onnx must build iresnet_100, got {e_card._build_arch}")
        x_card = e_card.extract_embeddings_batch(crops)
        x_cpu = e_cpu.extract_embeddings_batch(crops)
        err = float(np.abs(x_card - x_cpu).max())
        cos = float(np.sum(x_card * x_cpu, axis=1).min())
        res["onnx_card_vs_cpu_err"] = err
        if not np.isfinite(x_card).all() or err > 1e-4:
            fail(f"the .onnx embedder on the card and on the CPU differ by {err}")
        print(f"[enrol] ArcFace .onnx (iresnet_100) embeddings of {len(crops)} crops: card "
              f"against CPU max |difference| {err:.3g} (limit 1e-4: float32 sums in "
              f"other orders), min cosine {cos:.7f}; both built and run in "
              f"{time.perf_counter() - t0:.1f} s")
        del e_card, e_cpu

        # 9f: the matcher against 1 048 576 identities, bf16 then int8
        queries = embedder.extract_embeddings_batch(crops)
        big = gal.shape[0]
        others = gal[: big - ENROL_STUDENTS].cpu().numpy()
        now = "2026-01-01T00:00:00"
        enrolled = galleries["ckpt"].get_all_students()
        records = {
            f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", others[i:i + 1], others[i],
                                    1, now, now)
            for i in range(len(others))
        }
        records.update(enrolled)
        counters = {"gallery_topk": gallery_kernel.LAUNCHES,
                    "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8}
        res["matcher_launches"] = {}
        for quantize, kernel, floor in ((None, "gallery_topk", 0.99),
                                        ("int8", "gallery_topk_int8", 0.98)):
            label = quantize or "bf16"
            gm = GalleryManager(os.path.join(tmp, f"big_{label}.pkl"), verbose=False,
                                device=DEVICE, quantize=quantize)
            gm.students = dict(records)
            gm._dirty = True
            t0 = time.perf_counter()
            _, v, ids = gm.device_snapshot()
            torch.cuda.synchronize()
            compact = gm._device.snapshot()[3]
            print(f"[match {label}] {len(ids)} identities ({ENROL_STUDENTS} enrolled, the rest "
                  f"seeded) on the card in {time.perf_counter() - t0:.1f} s")
            m = FaceMatcher(embedder=embedder, gallery=gm, device=DEVICE)
            launches = 0
            for k in MATCH_TOP_KS:
                for c in counters.values():
                    c.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = m.match_faces_batch(crops, top_k=k)
                ms = 1e3 * (time.perf_counter() - t0)
                n = {name: c.count for name, c in counters.items()}
                launches += n[kernel]
                if n[kernel] != 1 or sum(n.values()) != 1:
                    fail(f"{label} k={k}: one search launched {n}")
                if [r[0][0] for r in got] != want_ids or min(r[0][2] for r in got) <= floor:
                    fail(f"{label} k={k}: enrolled students did not come back top-1: "
                         f"{[r[0] for r in got]}")
                # the same compact rows through the plain version
                q = torch.from_numpy(queries).to(DEVICE)
                if quantize:
                    pv, pi = gallery_kernel.streaming_cosine_topk_int8_plain(
                        q, compact[0], compact[1], v, top_k=k, chunk=STREAM_CHUNK)
                else:
                    pv, pi = gallery_kernel.streaming_cosine_topk_plain(
                        q, compact, v, top_k=k, chunk=STREAM_CHUNK)
                pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
                sv = np.array([[x[2] for x in r] for r in got], np.float32)
                si = [[x[0] for x in r] for r in got]
                err = float(np.abs(sv - pv).max())
                tol = 0.0 if quantize else K3_TOL
                clear = np.ones(pv.shape, bool)
                gap = np.abs(pv[:, :-1] - pv[:, 1:]) > 2 * max(tol, 1e-7)
                clear[:, :-1] &= gap
                clear[:, 1:] &= gap
                same = all(si[r][j] == ids[pi[r, j]] for r, j in zip(*np.nonzero(clear)))
                if err > tol or not same:
                    fail(f"{label} k={k}: the matcher differs from the plain version "
                         f"(max |score difference| {err}, ids equal on clear slots: {same})")
                print(f"[match {label}] match_faces_batch of {len(crops)} crops, top_k={k}: "
                      f"{ms:.1f} ms host clock (embed, one search, results); "
                      f"{kernel} launched once; enrolled students top-1 (min "
                      f"{min(r[0][2] for r in got):.5f}); equal to the plain version on the "
                      f"same compact rows (max |score difference| {err:.3g}, ids equal on "
                      f"{int(clear.sum())}/{clear.size} clear slots)")
            res["matcher_launches"][kernel] = launches
            del gm, m, compact, v, ids
            torch.cuda.empty_cache()

        # 9g: gallery_impl='streaming' on a float32 gallery: K3 on float32 rows
        eng = RecognitionEngine(ctx["detector"], ctx["embedder"], top_k=3,
                                gallery_impl="streaming", gallery_chunk=128)
        dense = ctx["engine"]
        rng = np.random.default_rng(3)
        small = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
        small /= np.linalg.norm(small, axis=1, keepdims=True)
        emb = ctx["emb"].cpu().numpy()
        slots = ctx["slots"]
        for i, (f, s) in enumerate(slots):
            small[7 + 97 * i] = emb[f, s]
        t = torch.from_numpy(small).to(DEVICE)
        vv = torch.ones(GALLERY_ROWS, dtype=torch.bool, device=DEVICE)
        want = dense.process_frames(ctx["frames"], t, vv)
        eng.process_frames(ctx["frames"], t, vv)  # its graph, captured before the counts
        gallery_kernel.LAUNCHES_F32.reset()
        steps = 3
        for _ in range(steps):
            got = eng.process_frames(ctx["frames"], t, vv)
        torch.cuda.synchronize()
        res["matcher_launches"]["gallery_topk_f32"] = gallery_kernel.LAUNCHES_F32.count
        if gallery_kernel.LAUNCHES_F32.count != steps:
            fail(f"gallery_impl='streaming' on float32 rows launched K3-f32 "
                 f"{gallery_kernel.LAUNCHES_F32.count} times in {steps} steps")
        fv = got["face_valid"].cpu().numpy()
        gs, ws = got["match_scores"].cpu().numpy(), want["match_scores"].cpu().numpy()
        gi, wi = got["match_idx"].cpu().numpy(), want["match_idx"].cpu().numpy()
        err = float(np.abs(gs[fv] - ws[fv]).max())
        gap = np.abs(ws[..., :-1] - ws[..., 1:]) > 1e-5
        clear = fv[..., None] & np.concatenate([gap, np.ones_like(gap[..., :1])], -1) & \
            np.concatenate([np.ones_like(gap[..., :1]), gap], -1)
        if err > 1e-5 or not np.array_equal(gi[clear], wi[clear]):
            fail(f"the streaming float32 step differs from the dense step ({err})")
        for i, (f, s) in enumerate(slots):
            if gi[f, s, 0] != 7 + 97 * i:
                fail("the streaming float32 step lost a planted row")
        print(f"[match f32] the step with gallery_impl='streaming' on a {GALLERY_ROWS}-row "
              f"float32 gallery: K3 on float32 rows launched once per step ({steps} steps), "
              f"scores within {err:.3g} of the dense step (limit 1e-5), planted rows top-1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[enrol] phase 9 took {res['seconds']:.1f} s")
    report["enrol"] = res



# ------------------------------------------------------------ phase 10

# the classroom dataset: a large lecture's roster
OFFLINE_ENROLLED = 48
OFFLINE_VISITORS = 48
OFFLINE_FEW_SHOT = 5
OFFLINE_SESSIONS = 4  # probe photos per enrolled identity, one per session
OFFLINE_ANGLES = ("center", "center", "left", "right")  # per session
OFFLINE_TOP_K = 5
OFFLINE_LONG_TOP_K = 65  # the pool route (from POOL_MIN_K, 64)
OFFLINE_POOL_TOP_K = 1024  # a campus-scale labeling run: the pool route
EVAL_TOL = 1e-5
SCORER_SHAPE = (4096, 10000, 5)  # probes, identities, embeddings per identity
STRESS_RUN = ("baseline", "crowded", "occlusion", "hard_negatives")
STRESS_SCENES = 6


def offline_name(prefix: str, i: int) -> str:
    """'Student_AB': letters only after the prefix, so the corpus's name
    rule (split at the first numeric part) gives the name back."""
    return f"{prefix}_{chr(65 + i // 26)}{chr(65 + i % 26)}"


def render_offline_dataset(tmp: str) -> tuple:
    """The classroom dataset: for each enrolled identity a one-shot photo,
    OFFLINE_FEW_SHOT few-shot photos (dataset/enrollment/{one-shot,few-shot}/
    <name>/) and one photo per session (raw/<session>/<angle>/<name>.png);
    each visitor once in one session. Every photo is its own
    `render_identity_scene` of the identity at 160 px, upscaled 3x."""
    import cv2
    import numpy as np

    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_scene,
    )

    rng = np.random.default_rng(10)
    count = 0

    def photo(path, seed):
        nonlocal count
        img, *_ = render_identity_scene([make_identity(seed)], rng, size=160)
        img = cv2.resize(img, (480, 480), interpolation=cv2.INTER_LINEAR)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        count += 1

    enrolled = [offline_name("Student", i) for i in range(OFFLINE_ENROLLED)]
    visitors = [offline_name("Visitor", i) for i in range(OFFLINE_VISITORS)]
    for i, name in enumerate(enrolled):
        photo(os.path.join(tmp, "dataset", "enrollment", "one-shot", name, "photo_0.png"),
              2000 + i)
        for j in range(OFFLINE_FEW_SHOT):
            photo(os.path.join(tmp, "dataset", "enrollment", "few-shot", name,
                               f"photo_{j}.png"), 2000 + i)
        for s in range(OFFLINE_SESSIONS):
            photo(os.path.join(tmp, "raw", f"{s + 1:02d}", OFFLINE_ANGLES[s], f"{name}.png"),
                  2000 + i)
    for i, name in enumerate(visitors):
        s = i % OFFLINE_SESSIONS
        photo(os.path.join(tmp, "raw", f"{s + 1:02d}", OFFLINE_ANGLES[s], f"{name}.png"),
              3000 + i)
    return enrolled, visitors, count


def probe_score_matrix(gallery: dict, probes: dict, aggregation: str):
    """The [P, I] score matrix an identification run computes, on the CPU,
    with the true identity index of every probe (-1 when not enrolled)."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.evalharness.identification import _score_probes
    from facerecognitionpipeline_tpu_torch.evalharness.metrics import pack_gallery

    names, packed, mask = pack_gallery(gallery, "cpu")
    data = probes.get("all", probes)
    rows, truth = [], []
    for name, d in data.items():
        for e in np.atleast_2d(np.asarray(d["embeddings"], np.float32)):
            rows.append(e)
            truth.append(names.index(name) if name in names else -1)
    return _score_probes(np.stack(rows), packed, mask, aggregation, 3), np.array(truth)


def near_decisions(scores, truth, thresholds) -> int:
    """Probes whose decision a last-bit difference in a score may flip: the
    best score within EVAL_TOL of a threshold or of the runner-up, or the
    true identity's score within EVAL_TOL of another identity's."""
    import numpy as np

    top = np.sort(scores, axis=1)[:, ::-1]
    near = np.abs(top[:, :1] - np.asarray(thresholds)[None, :]).min(axis=1) < EVAL_TOL
    if scores.shape[1] > 1:
        near |= top[:, 0] - top[:, 1] < EVAL_TOL
        t = scores[np.arange(len(truth)), np.clip(truth, 0, None)]
        close = np.abs(scores - t[:, None]) < EVAL_TOL
        close[np.arange(len(truth)), np.clip(truth, 0, None)] = False
        near |= (truth >= 0) & close.any(axis=1)
    return int(near.sum())


def close_pairs(values) -> int:
    """Adjacent pairs of sorted values within EVAL_TOL (an ROC curve's order
    can swap there)."""
    import numpy as np

    v = np.sort(np.asarray(values, np.float64))
    return int((np.diff(v) < EVAL_TOL).sum())


def compare_results(tag, got, want, n, near, pairs) -> float:
    """One evaluation result on the card against the CPU's: score lists
    within EVAL_TOL; threshold-table counts within `near` probes and rates
    within near / n; bootstrap CIs within EVAL_TOL; ROC-AUC, AP, d' and EER
    within EVAL_TOL plus what `near` decisions and `pairs` close pairs may
    move. Returns the largest score difference."""
    import numpy as np

    err = 0.0
    for key in ("genuine_scores", "impostor_scores"):
        if key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            if a.shape != b.shape:
                fail(f"{tag}: {key} has {a.shape} against {b.shape} on the CPU")
            if a.size:
                err = max(err, float(np.abs(a - b).max()))
    for p, q in zip(got.get("all_predictions", []), want.get("all_predictions", [])):
        err = max(err, abs(p["score"] - q["score"]))
    if err > EVAL_TOL:
        fail(f"{tag}: scores differ from the CPU's by {err} (limit {EVAL_TOL})")
    slack = EVAL_TOL + near / max(n, 1)
    gd, wd = got["threshold_results"], want["threshold_results"]
    if list(gd.columns) != list(wd.columns) or len(gd) != len(wd):
        fail(f"{tag}: threshold tables of different shapes")
    for col in wd.columns:
        a, b = gd[col].to_numpy(np.float64), wd[col].to_numpy(np.float64)
        limit = near if col in ("tp", "fp", "fn", "tn") else slack
        if np.abs(a - b).max() > limit:
            fail(f"{tag}: threshold table column {col} differs by {np.abs(a - b).max()} "
                 f"(limit {limit}, {near} near decisions)")
    for key in ("genuine_ci", "impostor_ci"):
        if key in want and max(abs(x - y) for x, y in zip(got[key], want[key])) > EVAL_TOL:
            fail(f"{tag}: {key} {got[key]} against {want[key]} on the CPU")
    for key in ("roc_auc", "average_precision", "dprime", "eer", "separation",
                "tar_at_far_0.01", "mean_impostor_score"):
        if key not in want or want[key] is None or got[key] is None:
            if key in want and (want[key] is None) != (got[key] is None):
                fail(f"{tag}: {key} defined on one device only")
            continue
        limit = slack + pairs / max(n, 1) + EVAL_TOL * abs(want[key])
        if abs(got[key] - want[key]) > limit:
            fail(f"{tag}: {key} {got[key]} against {want[key]} on the CPU (limit {limit})")
    return err


def compare_evaluations(card: dict, cpu: dict, corpus: dict, thresholds) -> dict:
    """evaluate_model on the card against the CPU, result by result."""
    import numpy as np

    probes, negatives = corpus["probe_positive"], corpus["probe_negative"]
    seg = corpus["probe_positive_segmented"]
    worst, n_results, n_near = 0.0, 0, 0
    for gname, gallery in corpus["galleries"].items():
        for agg in card["basic_probe"][gname]:
            scores, truth = probe_score_matrix(gallery, probes, agg)
            near = near_decisions(scores, truth, thresholds)
            pairs = close_pairs(scores.max(axis=1))
            worst = max(worst, compare_results(
                f"basic_probe {gname} {agg}", card["basic_probe"][gname][agg],
                cpu["basic_probe"][gname][agg], len(truth), near, pairs))
            n_near += near
            n_results += 1
            if gname in card["impostor"]:
                neg, _ = probe_score_matrix(
                    gallery, {n: d for n, d in negatives.items() if len(d["embeddings"])},
                    agg)
                best = neg.max(axis=1)
                near_i = int((np.abs(best[:, None] - np.asarray(thresholds)[None, :])
                              .min(axis=1) < EVAL_TOL).sum())
                worst = max(worst, compare_results(
                    f"impostor {gname} {agg}", card["impostor"][gname][agg],
                    cpu["impostor"][gname][agg], len(best), near_i, 0))
                genuine = scores[np.arange(len(truth)), np.clip(truth, 0, None)][truth >= 0]
                both = np.r_[genuine, best]
                near_v = int((np.abs(both[:, None] - np.asarray(thresholds)[None, :])
                              .min(axis=1) < EVAL_TOL).sum())
                worst = max(worst, compare_results(
                    f"verification {gname} {agg}", card["verification"][gname][agg],
                    cpu["verification"][gname][agg], min(len(genuine), len(best)), near_v,
                    close_pairs(both)))
                n_near += near_i + near_v
                n_results += 2
        for segment, res in card["segmented"].get(gname, {}).items():
            scores, truth = probe_score_matrix(gallery, {"all": seg[segment]}, "mean")
            near = near_decisions(scores, truth, thresholds)
            worst = max(worst, compare_results(
                f"segmented {gname} {segment}", res, cpu["segmented"][gname][segment],
                len(truth), near, close_pairs(scores.max(axis=1))))
            n_near += near
            n_results += 1
    return {"results_compared": n_results, "max_score_err": worst, "near_decisions": n_near}


def scorer_alone(res: dict) -> None:
    """identity_scores_batch at SCORER_SHAPE x 512 on the card: within
    EVAL_TOL of the same function in float64, timed beside its bound (the
    larger of the float32 operations over the CUDA cores' peak, TF32 off,
    and the bytes of its inputs and output over the memory rate)."""
    import torch

    from facerecognitionpipeline_tpu_torch.evalharness.metrics import identity_scores_batch

    p, i, m = SCORER_SHAPE
    d = 512
    g = torch.Generator(device=DEVICE).manual_seed(10)
    probes = torch.randn((p, d), generator=g, device=DEVICE)
    gallery = torch.randn((i, m, d), generator=g, device=DEVICE)
    gallery /= torch.linalg.vector_norm(gallery, dim=2, keepdim=True)
    mask = torch.arange(m, device=DEVICE)[None, :] <= (torch.arange(i, device=DEVICE) % m)[:, None]
    gallery *= mask[..., None]  # identity j holds 1 + j % 5 embeddings
    flops = 2.0 * p * i * m * d
    nbytes = 4.0 * (p * d + i * m * d + p * i) + i * m
    bound = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    res["scorer"] = {"shape": [p, i, m, d], "bound_ms": bound,
                     "bound_by": "operations" if flops / F32_FLOPS_PER_S >
                     nbytes / HBM_BYTES_PER_S else "bytes"}
    g64 = gallery.double()
    for agg in ("max", "mean", "topk"):
        out = identity_scores_batch(probes, gallery, mask, agg, 3)
        ref = identity_scores_batch(probes.double(), g64, mask, agg, 3, dtype=torch.float64)
        err = float((out.double() - ref).abs().max())
        if not torch.isfinite(out).all() or out.shape != (p, i) or err > EVAL_TOL:
            fail(f"identity_scores_batch ({agg}) at {p}x{i}x{m}x{d} is {err} from float64")
        del out, ref
        ms = cuda_time_ms(lambda: identity_scores_batch(probes, gallery, mask, agg, 3),
                          iters=5, warmup=1)
        res["scorer"][agg] = {"ms": ms, "max_abs_err_vs_f64": err}
        print(f"[offline] identity_scores_batch {agg} at {p} probes x {i} identities x {m} x "
              f"{d}: {ms:.3f} ms (bound {bound:.3f} ms by {res['scorer']['bound_by']}), "
              f"max |float32 - float64| {err:.3g} (limit {EVAL_TOL})")
    del probes, gallery, g64, mask
    torch.cuda.empty_cache()


def offline_phase(gal, report) -> None:
    """Phase 10: the offline dataset and evaluation path through its CLIs on
    the card (dataset_preprocessor, segment_dataset, embedding_generator,
    probe_labeler, evaluate_models), the labeler against 1 048 576
    identities (bf16 then int8), the evaluation on the card against the CPU,
    the device scorer alone at a large shape, and the detector stress
    suite."""
    import pickle
    import shutil

    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.cli import (
        dataset_preprocessor,
        embedding_generator,
        evaluate_models,
        lfw_impostor_helper,
        probe_labeler,
        segment_dataset,
    )
    from facerecognitionpipeline_tpu_torch.evalharness.detection import run_stress_suite
    from facerecognitionpipeline_tpu_torch.evalharness.pipeline import (
        DEFAULT_THRESHOLDS,
        evaluate_model,
        load_model_corpus,
    )
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.labeling import ProbeLabeler
    from facerecognitionpipeline_tpu_torch.utils.io import (
        imread_rgb,
        list_images,
        save_npz_variables,
    )
    from facerecognitionpipeline_tpu_torch.utils.xlsx import read_xlsx_rows

    t_phase = time.perf_counter()
    res = {"launches": {"crop_resize": 0, "warp_patches": 0, "gallery_topk": 0,
                        "gallery_topk_int8": 0, "gallery_topk_f32": 0},
           "pool_launches": {"bf16": 0, "int8": 0}}
    counters = {"crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
                "gallery_topk": gallery_kernel.LAUNCHES,
                "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
                "gallery_topk_f32": gallery_kernel.LAUNCHES_F32}

    def reset():
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()

    def read():
        torch.cuda.synchronize()
        n = {k: c.count for k, c in counters.items()}
        for k, v in n.items():
            res["launches"][k] += v
        return n

    det_path = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
    det_flags = ["--detector_weights", det_path, "--detector_dtype", "bfloat16",
                 "--device", DEVICE]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        t0 = time.perf_counter()
        enrolled, visitors, n_photos = render_offline_dataset(tmp)
        weights = os.path.join(tmp, "ir101.npz")
        save_npz_variables(weights, seeded_unfolded_tree(ARCH, 10))
        print(f"[offline] {n_photos} photos of {len(enrolled)} enrolled identities and "
              f"{len(visitors)} visitors rendered, seeded {ARCH} weights written, in "
              f"{time.perf_counter() - t0:.1f} s")
        raw, prep, out = (os.path.join(tmp, d) for d in ("raw", "prep", "out"))
        meta_path = os.path.join(prep, "probe_positive_metadata.json")
        crops_dir = os.path.join(prep, "probe_positive")

        # 10a: dataset_preprocessor, bf16 cascade (K1 twice per photo)
        n_raw = sum(len(list_images(os.path.join(raw, s, a)))
                    for s in os.listdir(raw) for a in os.listdir(os.path.join(raw, s)))
        reset()
        t0 = time.perf_counter()
        rc, log = run_cli(dataset_preprocessor.main,
                          ["--input_dir", raw, "--output_dir", prep] + det_flags)
        secs = time.perf_counter() - t0
        n = read()
        with open(meta_path) as f:
            meta = json.load(f)
        first = [e for e in meta if e["face_index"] == 0]  # one per photo with a face
        if rc != 0 or n["crop_resize"] != 2 * n_raw or n["warp_patches"]:
            fail(f"dataset_preprocessor: rc {rc}, launches {n} for {n_raw} photos "
                 f"(want K1 twice each):\n{log[-2000:]}")
        if len(first) < 0.95 * n_raw:
            fail(f"dataset_preprocessor found a face in {len(first)} of {n_raw} photos")
        res["preprocess_images_per_s"] = n_raw / secs
        print(f"[offline] dataset_preprocessor: {n_raw} photos in {secs:.1f} s "
              f"({res['preprocess_images_per_s']:.2f} images/s, the detector build "
              f"included), {len(meta)} crops, a face in {len(first)} photos; K1 launched "
              f"{n['crop_resize']} times")

        # 10b: the reviewed labels (what label_rename_utility fixes by hand
        # comes from the photos' names here), visitors half as an LFW-style
        # tree sampled by lfw_impostor_helper, half as real impostors
        positive = os.path.join(out, "probe_labeled", "positive")
        negative = os.path.join(out, "probe_labeled", "negative")
        lfw_tree = os.path.join(tmp, "lfw")
        for d in (positive, negative):
            os.makedirs(d)
        truth = {e["filename"]: e["source_image"][:-4] for e in meta if e["face_index"] == 0}
        for fname, who in truth.items():
            src = os.path.join(crops_dir, fname)
            if who in enrolled:
                shutil.copy(src, os.path.join(positive, f"{who}_{fname}"))
            elif visitors.index(who) % 2:
                shutil.copy(src, os.path.join(negative, f"{who}_{fname}"))
            else:
                os.makedirs(os.path.join(lfw_tree, who))
                shutil.copy(src, os.path.join(lfw_tree, who, fname))
        n_lfw = len(os.listdir(lfw_tree))
        rc, log = run_cli(lfw_impostor_helper.main, [
            "--lfw_dir", lfw_tree, "--output_dir", negative, "--num_identities", str(n_lfw)])
        if rc != 0 or len([f for f in os.listdir(negative) if f.startswith("lfw_")]) != n_lfw:
            fail(f"lfw_impostor_helper: {log[-1000:]}")

        # 10c: segment_dataset over the reviewed positives
        rc, log = run_cli(segment_dataset.main, [
            "--input_dir", positive, "--metadata_file", meta_path, "--output_dir",
            os.path.join(out, "probe_labeled", "segmented"), "--device", DEVICE])
        done = [ln for ln in log.splitlines() if ln.startswith("SEGMENTATION COMPLETE")]
        if rc != 0 or not done:
            fail(f"segment_dataset: {log[-2000:]}")
        print(f"[offline] segment_dataset: {done[0]}")

        # 10d: embedding_generator (K1 twice per gallery photo, base and
        # augmented passes)
        model = f"adaface_{ARCH}"
        emb_dir = os.path.join(out, "embeddings", model)
        n_gallery = 2 * len(enrolled) * (1 + OFFLINE_FEW_SHOT)
        reset()
        t0 = time.perf_counter()
        rc, log = run_cli(embedding_generator.main, [
            "--dataset_root", os.path.join(tmp, "dataset"), "--output_root", out,
            "--model_type", "adaface", "--architecture", ARCH, "--model_path", weights,
        ] + det_flags)
        secs = time.perf_counter() - t0
        n = read()
        if rc != 0 or n["crop_resize"] != 2 * n_gallery:
            fail(f"embedding_generator: rc {rc}, launches {n} for {n_gallery} gallery "
                 f"photos (want K1 twice each):\n{log[-2000:]}")
        stems = ["gallery_one-shot_base", "gallery_one-shot_augmented",
                 "gallery_few-shot_base", "gallery_few-shot_augmented",
                 "probe_positive_unsegmented", "probe_positive_segmented", "probe_negative"]
        artifacts = {}
        for stem in stems:
            with open(os.path.join(emb_dir, f"{stem}.pkl"), "rb") as f:
                artifacts[stem] = pickle.load(f)
            with open(os.path.join(emb_dir, f"{stem}.json")) as f:
                json.load(f)
        with open(os.path.join(emb_dir, "generation_summary.json")) as f:
            summary = json.load(f)
        n_probe_embs = 0
        for stem, blob in artifacts.items():
            groups = blob.values() if stem.startswith(("gallery", "probe_negative")) else \
                [d for cat in blob.values() for d in cat.values()]
            for d in groups:
                e = np.asarray(d["embeddings"])
                if len(e) and (e.dtype != np.float32 or e.shape[1] != 512
                               or not np.isfinite(e).all()):
                    fail(f"{stem}: embeddings {e.dtype} {e.shape}")
                if stem.startswith("probe"):
                    n_probe_embs += len(e)
        want = {"one_shot_base_persons": len(enrolled), "few_shot_base_persons": len(enrolled),
                "one_shot_augmented_persons": len(enrolled),
                "few_shot_augmented_persons": len(enrolled)}
        if summary["gallery"] != want or artifacts["gallery_few-shot_augmented"][
                enrolled[0]]["embeddings"].shape[0] != 8 * OFFLINE_FEW_SHOT:
            fail(f"embedding_generator galleries: {summary['gallery']}")
        res["corpus_images_per_s"] = (n_gallery + n_probe_embs) / secs
        print(f"[offline] embedding_generator: {n_gallery} gallery photos (detect, align, "
              f"embed; x8 augmented) and {n_probe_embs} probe crops in {secs:.1f} s "
              f"({res['corpus_images_per_s']:.2f} images/s, the {ARCH} load included); "
              f"K1 launched {n['crop_resize']} times; 7 pickles with their JSON twins and "
              f"generation_summary.json: {summary['probe_negative']}, segmented "
              f"{summary['probe_positive']['segmented_categories']}")

        # 10e: probe_labeler against the 48 students (dense match)
        few = artifacts["gallery_few-shot_base"]
        g48 = os.path.join(tmp, "gallery48", "students.pkl")
        gm = GalleryManager(g48, verbose=False, device=DEVICE)
        for j, name in enumerate(enrolled):
            gm.add_student(f"STU{j + 1:04d}", name, few[name]["embeddings"])
        gm.save()
        reset()
        t0 = time.perf_counter()
        rc, log = run_cli(probe_labeler.main, [
            "--probe_dir", crops_dir, "--metadata_file", meta_path, "--gallery_path", g48,
            "--architecture", ARCH, "--model_path", weights, "--top_k", str(OFFLINE_TOP_K),
            "--output_dir", os.path.join(tmp, "labeled48"), "--device", DEVICE])
        secs = time.perf_counter() - t0
        n = read()
        if rc != 0 or any(n.values()):
            fail(f"probe_labeler (48 students): rc {rc}, launches {n}:\n{log[-2000:]}")
        with open(os.path.join(tmp, "labeled48", "labeling_results.json")) as f:
            blob = json.load(f)
        embedder = FaceEmbedder(ARCH, model_path=weights, device=DEVICE)
        paths = list_images(crops_dir)
        queries = embedder.extract_embeddings_batch([imread_rgb(p) for p in paths])
        t, ids = gm.get_gallery_embeddings()
        dense = queries @ (t / np.linalg.norm(t, axis=1, keepdims=True)).T
        order = np.argsort(-dense, axis=1, kind="stable")[:, :OFFLINE_TOP_K]
        err, n_ok = 0.0, 0
        for r, (p, row) in enumerate(zip(paths, blob["results"])):
            top = row["top_matches"]
            err = max(err, max(abs(m["score"] - dense[r, j]) for m, j in zip(top, order[r])))
            if row["filename"] != os.path.basename(p) or top[0]["student_id"] != ids[order[r, 0]]:
                if dense[r, order[r, 0]] - dense[r, order[r, 1]] > 2 * EVAL_TOL:
                    fail(f"probe_labeler (48): {row['filename']} matched {top[0]}")
            n_ok += truth.get(row["filename"]) == row["matched_name"]
        if err > EVAL_TOL or blob["summary"]["processed"] != len(paths):
            fail(f"probe_labeler (48): scores {err} from a float32 dense product")
        res["labeler_ms_48"] = 1e3 * secs
        res["labeler_truth_top1_48"] = n_ok / len(paths)
        print(f"[offline] probe_labeler --top_k {OFFLINE_TOP_K} against {len(enrolled)} "
              f"students: {len(paths)} crops in {secs:.1f} s (the {ARCH} load included), "
              f"labels {blob['summary']['label_distribution']}, scores within {err:.3g} of a "
              f"dense float32 product; matched name = true name for {n_ok}/{len(paths)} "
              f"(random weights); no streaming kernel (dense match)")

        # 10f: the labeler against 1 048 576 identities, bf16 (K3) then int8 (K4)
        big = gal.shape[0]
        others = gal[: big - len(enrolled)].cpu().numpy()
        now = "2026-01-01T00:00:00"
        records = {
            f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", others[i:i + 1], others[i],
                                    1, now, now)
            for i in range(len(others))
        }
        records.update(gm.get_all_students())
        del others
        q = torch.from_numpy(queries).to(DEVICE)
        for quantize, kernel in ((None, "gallery_topk"), ("int8", "gallery_topk_int8")):
            label = quantize or "bf16"
            big_gm = GalleryManager(os.path.join(tmp, f"big_{label}.pkl"), verbose=False,
                                    device=DEVICE, quantize=quantize)
            big_gm.students = dict(records)
            big_gm._dirty = True
            _, v, big_ids = big_gm.device_snapshot()
            compact = big_gm._device.snapshot()[3]
            labeler = ProbeLabeler(embedder=embedder, gallery=big_gm, architecture=ARCH)
            for top_k in (OFFLINE_TOP_K, OFFLINE_LONG_TOP_K, OFFLINE_POOL_TOP_K):
                tag = label if top_k == OFFLINE_TOP_K else f"{label}_k{top_k}"
                reset()
                pool = gallery_kernel.POOL_LAUNCHES[label]
                pool.reset()
                gallery_kernel.reset_unresolved()
                t0 = time.perf_counter()
                labeler.process_probe_directory(
                    crops_dir, output_dir=os.path.join(tmp, f"labeled_{tag}"),
                    metadata_file=meta_path, copy_files=False, top_k=top_k)
                secs = time.perf_counter() - t0
                n = read()
                res["pool_launches"][label] += pool.count
                if n[kernel] != 1 or sum(n.values()) != 1:
                    fail(f"probe_labeler --top_k {top_k} against {big} ({label}): one search "
                         f"launched {n}")
                if pool.count != int(top_k >= gallery_kernel.POOL_MIN_K):
                    fail(f"probe_labeler --top_k {top_k} ({label}) took the pool route "
                         f"{pool.count} times")
                if gallery_kernel.unresolved_queries():
                    fail(f"probe_labeler --top_k {top_k} ({label}): unresolved queries")
                with open(os.path.join(tmp, f"labeled_{tag}", "labeling_results.json")) as f:
                    rows = json.load(f)["results"]
                if quantize:
                    pv, pi = gallery_kernel.streaming_cosine_topk_int8_plain(
                        q, compact[0], compact[1], v, top_k=top_k, chunk=STREAM_CHUNK)
                else:
                    pv, pi = gallery_kernel.streaming_cosine_topk_plain(
                        q, compact, v, top_k=top_k, chunk=STREAM_CHUNK)
                pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
                sv = np.array([[m["score"] for m in r["top_matches"]] for r in rows],
                              np.float32)
                tol = 0.0 if quantize else K3_TOL
                err = float(np.abs(sv - pv).max())
                clear = np.ones(pv.shape, bool)
                gap = np.abs(pv[:, :-1] - pv[:, 1:]) > 2 * max(tol, 1e-7)
                clear[:, :-1] &= gap
                clear[:, 1:] &= gap
                same = all(rows[r]["top_matches"][j]["student_id"] == big_ids[pi[r, j]]
                           for r, j in zip(*np.nonzero(clear)))
                labels_ok = all(
                    r["label"] == labeler.determine_label(float(pv[i, 0]))
                    for i, r in enumerate(rows)
                    if min(abs(pv[i, 0] - labeler.sure_threshold),
                           abs(pv[i, 0] - labeler.unsure_threshold)) > 2 * max(tol, 1e-7))
                if err > tol or not same or not labels_ok or sv.shape[1] != top_k:
                    fail(f"probe_labeler --top_k {top_k} against {big} ({label}) differs from "
                         f"the plain version (score {err}, ids on clear slots {same}, labels "
                         f"{labels_ok}, {sv.shape[1]} matches)")
                res[f"labeler_ms_{tag}"] = 1e3 * secs
                print(f"[offline] ProbeLabeler.process_probe_directory (probe_labeler's "
                      f"class) --top_k {top_k} against {big} identities ({label}): "
                      f"{len(rows)} crops in {1e3 * secs:.1f} ms; {kernel} launched once"
                      f"{' on the pool route' if pool.count else ''}; "
                      f"equal to the plain version on the same compact rows (max |score "
                      f"difference| {err:.3g}, ids equal on {int(clear.sum())}/{clear.size} "
                      f"clear slots, labels equal)")
            for c in counters.values():
                c.reset()
            t1 = time.perf_counter()
            big_gm.search_batch(queries, top_k=OFFLINE_TOP_K)
            torch.cuda.synchronize()
            search_ms = 1e3 * (time.perf_counter() - t1)
            res[f"search_ms_{label}"] = search_ms
            print(f"[offline] the search alone against {big} identities ({label}), top_k "
                  f"{OFFLINE_TOP_K}: {search_ms:.2f} ms")
            del big_gm, labeler, compact, v, big_ids
            torch.cuda.empty_cache()
        del records, q

        # 10g: evaluate_models on the card, then the same corpus on the card
        # and on the CPU in process
        eval_dir = os.path.join(out, "evaluation")
        argv = ["--models", model, "--embeddings_root", os.path.join(out, "embeddings"),
                "--output_dir", eval_dir, "--device", DEVICE]
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            argv.append("--no_plots")
        t0 = time.perf_counter()
        rc, log = run_cli(evaluate_models.main, argv)
        res["evaluate_models_s"] = time.perf_counter() - t0
        files = ["identification_summary.csv", "identification_summary.tex",
                 "verification_summary.csv", "verification_summary.tex",
                 "gallery_strategies.csv", "gallery_strategies.tex",
                 "evaluation_results.json", "evaluation_results.xlsx", "executive_summary.txt"]
        missing = [f for f in files if not os.path.exists(os.path.join(eval_dir, f))]
        if rc != 0 or missing:
            fail(f"evaluate_models: rc {rc}, missing {missing}:\n{log[-2000:]}")
        sheets = read_xlsx_rows(os.path.join(eval_dir, "evaluation_results.xlsx"))
        with open(os.path.join(eval_dir, "executive_summary.txt")) as f:
            exec_summary = f.read()
        print(f"[offline] evaluate_models --device {DEVICE}: {res['evaluate_models_s']:.1f} s; "
              f"{len(files)} files, sheets {sorted(sheets)}")
        print("[offline] " + exec_summary.strip().replace("\n", "\n[offline] "))

        corpus = load_model_corpus(emb_dir)
        t0 = time.perf_counter()
        card = evaluate_model(corpus, device=DEVICE)
        res["evaluate_model_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = evaluate_model(corpus, device="cpu")
        res["evaluate_model_cpu_s"] = time.perf_counter() - t0
        res["card_vs_cpu"] = compare_evaluations(card, cpu, corpus, DEFAULT_THRESHOLDS)
        print(f"[offline] evaluate_model on the card ({res['evaluate_model_card_s']:.1f} s) "
              f"against the CPU ({res['evaluate_model_cpu_s']:.1f} s): "
              f"{res['card_vs_cpu']['results_compared']} results, threshold tables, rank "
              f"metrics and CIs equal, scores within {res['card_vs_cpu']['max_score_err']:.3g} "
              f"(limit {EVAL_TOL}); {res['card_vs_cpu']['near_decisions']} decisions within "
              f"{EVAL_TOL} of a threshold or a rival")
        del card, cpu, corpus

        # 10h: the device scorer alone at a large shape
        scorer_alone(res)

        # 10i: the detector stress suite through a bf16 cascade (K1)
        detector = MTCNNDetector(weights_path=det_path, dtype=torch.bfloat16, device=DEVICE)
        reset()
        t0 = time.perf_counter()
        stress = run_stress_suite(detector, categories=STRESS_RUN, n_scenes=STRESS_SCENES)
        secs = time.perf_counter() - t0
        n = read()
        if n["crop_resize"] != 2 * len(STRESS_RUN) * STRESS_SCENES:
            fail(f"run_stress_suite launched {n} for {len(STRESS_RUN) * STRESS_SCENES} scenes")
        res["stress"] = stress["summary"]
        for cat, s in stress["summary"].items():
            if s["recall"] is not None and not 0.0 <= s["recall"] <= 1.0:
                fail(f"run_stress_suite {cat}: recall {s['recall']}")
        print(f"[offline] run_stress_suite ({STRESS_SCENES} scenes x {len(STRESS_RUN)} "
              f"categories, 320 px, bf16 cascade) in {secs:.1f} s, K1 launched "
              f"{n['crop_resize']} times: " + "; ".join(
                  f"{c} AP {s['ap'] if s['ap'] is None else round(s['ap'], 4)} recall "
                  f"{s['recall'] if s['recall'] is None else round(s['recall'], 4)} fp/img "
                  f"{s['fp_per_image']:.3f}" for c, s in stress["summary"].items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[offline] phase 10 took {res['seconds']:.1f} s; launches {res['launches']}")
    report["offline"] = res


TRAIN_ARCH = "ir_101"
TRAIN_BATCH = 128
TRAIN_CLASSES = 1024
TRAIN_STEPS = 30  # CLI run, then --resume to TRAIN_RESUME_STEPS
TRAIN_RESUME_STEPS = 40
TRAIN_EVERY = 10  # checkpoint and log interval of the CLI runs
TRAIN_F32_STEPS = 10
TRAIN_TIMED = 8  # steps timed per configuration, after 2 of warm-up
PARITY = {"architecture": "ir_18", "batch": 16, "classes": 64}
E2E_STEPS, E2E_BATCH, E2E_FLOOR = 400, 64, 0.75
# 50 steps: phase 15 trains the recipes' nets as well (the run's time limit)
DET_STEPS, DET_BATCH, DET_OHEM = 50, 256, 0.7
OOD_SCENES = 3
FUSED_FACES = 64


def conv_dense_macs(arch: str) -> tuple[int, int]:
    """Multiply-accumulates of one forward of `arch` at 112x112 per image,
    over its convolutions and dense layers, counted from their shapes: (all
    of them, the two 3x3 res convs' share, which the int8 forward takes)."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.irse import build_backbone

    model = build_backbone(arch).eval()
    macs = {"all": 0, "res": 0}

    def hook(name):
        def count(m, inputs, out):
            if isinstance(m, torch.nn.Conv2d):
                n = out[0].numel() * m.in_channels // m.groups * m.kernel_size[0] * \
                    m.kernel_size[1]
            else:
                n = m.in_features * m.out_features
            macs["all"] += n
            if name.endswith(("res_conv1", "res_conv2")):
                macs["res"] += n
        return count

    hooks = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(1, 112, 112, 3))
    for h in hooks:
        h.remove()
    return macs["all"], macs["res"]


def train_peak_ms(macs: tuple[int, int], dtype_name: str) -> float:
    """The least time the card's peaks allow for one step's conv and dense
    work (fwd + bwd = 3 x fwd), each part at the peak of its own type:
    float32 on the CUDA cores (TF32 is off), bf16 on the tensor cores, and
    with the int8 forward the res convs' forward at the int8 peak and the
    rest (their backward, every other layer) at bf16's."""
    total, res = (2 * m * TRAIN_BATCH for m in macs)
    if dtype_name == "float32":
        return 3 * total / F32_FLOPS_PER_S * 1e3
    if dtype_name == "bf16":
        return 3 * total / BF16_FLOPS_PER_S * 1e3
    if dtype_name == "int8_forward":
        return (res / INT8_OPS_PER_S + (3 * total - res) / BF16_FLOPS_PER_S) * 1e3
    raise ValueError(f"no peak for {dtype_name}")


def step_times_ms(trainer, state, x, y, iters: int, warmup: int = 2, seed: int = 0):
    """Sorted CUDA-event times of `iters` train steps on a batch already on
    the card (after `warmup` steps), and the last loss."""
    import torch

    from facerecognitionpipeline_tpu_torch.train.trainer import dropout_generator

    for i in range(warmup):
        state, m = trainer.train_step(state, x, y, dropout_generator(seed, i, DEVICE))
    evs = []
    for i in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trainer.train_step(state, x, y, dropout_generator(seed, warmup + i, DEVICE))
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in evs), state, float(m["loss"])


def step_device_ms(trainer, state, x, y, steps: int = 3) -> float:
    """Device time per train step summed over every CUDA kernel, from
    torch.profiler over `steps` steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from facerecognitionpipeline_tpu_torch.train.trainer import dropout_generator

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            state, _ = trainer.train_step(state, x, y, dropout_generator(9, i, DEVICE))
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / steps / 1e3


def train_config_run(label, res, macs, dtype, int8_forward=False, fused=True) -> dict:
    """One training configuration at ir_101, B=128, 1024 classes on a fixed
    synthetic batch on the card: step p50, images/s, TFLOP/s (conv and
    dense operations, fwd + bwd = 3 x fwd) and its share of the peak for
    the configuration's types (`train_peak_ms`), the device's busy share
    from torch.profiler, peak memory."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.train.data import synthetic_batches
    from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(architecture=TRAIN_ARCH, num_classes=TRAIN_CLASSES,
                                  dtype=dtype, int8_forward=int8_forward,
                                  fused_optimizer=fused), device=DEVICE)
    state = trainer.init_state(0)
    x, y = next(synthetic_batches(TRAIN_CLASSES, TRAIN_BATCH, seed=1))
    x, y = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ms, state, loss = step_times_ms(trainer, state, x, y, TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(loss):
        fail(f"{label}: non-finite loss {loss}")
    p50 = ms[len(ms) // 2]
    dev_ms = step_device_ms(trainer, state, x, y)
    flops = 3 * 2 * macs[0] * TRAIN_BATCH
    peak_ms = train_peak_ms(macs, label)
    out = {"step_p50_ms": p50, "step_ms": ms, "images_per_s": TRAIN_BATCH * 1e3 / p50,
           "tflops": flops / p50 / 1e9, "peak_tflops": flops / peak_ms / 1e9,
           "peak_ms": peak_ms, "peak_share": peak_ms / p50, "device_ms_per_step": dev_ms,
           "busy_share": dev_ms / p50, "peak_gib": peak, "loss": loss}
    print(f"[train] {label}: step p50 {p50:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}, "
          f"{TRAIN_TIMED} steps), {out['images_per_s']:.0f} images/s, "
          f"{out['tflops']:.1f} TFLOP/s of conv+dense work ({flops / 1e12:.2f} TFLOP per "
          f"step), {100 * out['peak_share']:.1f}% of the {out['peak_tflops']:.0f} TFLOP/s "
          f"peak for its types (least time {peak_ms:.2f} ms), device busy "
          f"{dev_ms:.2f} ms per step ({100 * out['busy_share']:.1f}% of the step, "
          f"torch.profiler over 3 steps), peak memory {peak:.2f} GiB")
    res[label] = out
    return {"trainer": trainer, "state": state, "x": x, "y": y}


def optimizer_alone(res, run) -> None:
    """The update alone on ir_101's state: fused foreach chain against the
    unfused optax-style chain, CUDA events over 20 updates each, in turns."""
    import torch

    from facerecognitionpipeline_tpu_torch.train.trainer import (
        _leaves,
        chain_sgd_apply,
        fused_sgd_apply,
    )

    state = run["state"]
    params = [p.detach() for p in _leaves(state["params"])]
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    trace = [torch.zeros_like(p) for p in params]
    lr = torch.tensor(1e-9, device=DEVICE)
    fused = lambda: fused_sgd_apply(params, grads, trace, lr, 0.9, 5e-4)  # noqa: E731
    chain = lambda: chain_sgd_apply(params, grads, trace, lr, 0.9, 5e-4)  # noqa: E731
    times = {"fused_ms": cuda_time_ms(fused), "unfused_ms": cuda_time_ms(chain)}
    times["fused_ms_again"] = cuda_time_ms(fused)
    times["unfused_ms_again"] = cuda_time_ms(chain)
    n = sum(p.numel() for p in params)
    times["leaves"], times["parameters"] = len(params), n
    # bound: read p, g, mu and write p, mu once, float32
    times["bound_ms"] = 5 * 4 * n / HBM_BYTES_PER_S * 1e3
    res["optimizer"] = times
    print(f"[train] the SGD update alone over {len(params)} leaves ({n / 1e6:.1f} M float32 "
          f"parameters): fused {times['fused_ms']:.3f} / {times['fused_ms_again']:.3f} ms, "
          f"unfused {times['unfused_ms']:.3f} / {times['unfused_ms_again']:.3f} ms, bound "
          f"by bytes {times['bound_ms']:.3f} ms")


def grads_worst(got: dict, want: dict) -> tuple[float, float]:
    """(whole-tree relative difference, worst per-leaf relative difference
    over leaves above 1e-4 of the whole tree's norm), as the CPU tests
    measure gradients."""
    import numpy as np

    keys = sorted(want)
    w = np.concatenate([want[k].ravel() for k in keys])
    d = np.concatenate([(got[k] - want[k]).ravel() for k in keys])
    floor = 1e-4 * np.linalg.norm(w)
    leaf = max(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
               for k in keys if np.linalg.norm(want[k]) > floor)
    return float(np.linalg.norm(d) / np.linalg.norm(w)), float(leaf)


def to_device(tree, dev):
    """A train state's tensors on `dev`, grad flags kept."""
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev).requires_grad_(tree.requires_grad)
    return tree


def card_against_cpu(res) -> None:
    """One float32 step at ir_18, B=16, 64 classes on the card and on the
    CPU from the same state, batch and dropout mask, held to the CPU parity
    tests' tolerances (tests/test_torch_port_train.py)."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(architecture=PARITY["architecture"], num_classes=PARITY["classes"],
                      learning_rate=0.05)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (PARITY["batch"], 112, 112, 3)).astype(np.float32)
    y = rng.integers(0, PARITY["classes"], PARITY["batch"]).astype(np.int32)
    mask = torch.rand((PARITY["batch"], 512, 7, 7), generator=torch.Generator().manual_seed(5)) < 0.6
    out = {}
    for dev in ("cpu", DEVICE):
        t = Trainer(cfg, device=dev)
        state = to_device(Trainer(cfg, device="cpu").init_state(0), dev)
        t0 = time.perf_counter()
        loss, _, grads = t.loss_and_grads(state, x, y, dropout_mask=mask.to(dev))
        state, _ = t.train_step(state, x, y, dropout_mask=mask.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        flat = lambda tree: {k: v.detach().double().cpu().numpy() for k, v in tree.items()}  # noqa: E731
        out[dev] = {"loss": float(loss),
                    "grads": {**flat(grads["backbone"]), "classifier": grads["classifier"]
                              .detach().double().cpu().numpy()},
                    "params": {**flat(state["params"]["backbone"]),
                               "classifier": state["params"]["classifier"].detach().double()
                               .cpu().numpy()},
                    "stats": flat(state["batch_stats"]), "seconds": secs}
    c, g = out["cpu"], out[DEVICE]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    whole, leaf = grads_worst(g["grads"], c["grads"])
    param_abs = max(float(np.abs(g["params"][k] - c["params"][k]).max()) for k in c["params"])
    stats_rel = max(float(np.linalg.norm(g["stats"][k] - c["stats"][k])
                          / (np.linalg.norm(c["stats"][k]) + 1e-5 * np.sqrt(c["stats"][k].size)))
                    for k in c["stats"])
    r = {"loss_rel": loss_rel, "grad_whole_rel": whole, "grad_leaf_rel": leaf,
         "param_abs": param_abs, "batch_stats_rel": stats_rel,
         "cpu_s": c["seconds"], "card_s": g["seconds"]}
    res["card_vs_cpu"] = r
    print(f"[train] float32 step {PARITY['architecture']} B={PARITY['batch']} "
          f"{PARITY['classes']} classes, card against CPU from one state, batch and mask: "
          f"loss {loss_rel:.2e} relative (limit 1e-5), gradients {whole:.2e} over the tree "
          f"(limit 1e-3) and {leaf:.2e} worst leaf (limit 1e-2), parameters {param_abs:.2e} "
          f"absolute (limit 1e-3), batch_stats {stats_rel:.2e} (limit 1e-3)")
    if loss_rel > 1e-5 or whole > 1e-3 or leaf > 1e-2 or param_abs > 1e-3 or stats_rel > 1e-3:
        fail(f"the float32 step on the card differs from the CPU's: {r}")


def int8_forward_sums(res, run) -> None:
    """At every res-conv shape of the ir_101 B=128 step, the int8 forward's
    codes on the card equal the CPU's (counted off-by-one flips allowed),
    and its s32 sums equal the plain version's float64 sums exactly."""
    import torch

    from facerecognitionpipeline_tpu_torch.models import irse

    trainer, state = run["trainer"], run["state"]
    seen = {}

    def grab(m, inputs):
        key = (tuple(inputs[0].shape), m.stride)
        if key not in seen:
            seen[key] = (inputs[0].detach(), m.weight.detach().to(inputs[0].dtype), m.stride)

    hooks = [m.register_forward_pre_hook(grab) for m in trainer.model.modules()
             if isinstance(m, irse.Int8FwdConv)]
    try:
        with torch.no_grad():
            torch.func.functional_call(trainer.model, state["params"]["backbone"], (run["x"],),
                                       {"train": True, "dtype": torch.bfloat16,
                                        "dropout_mask": torch.ones((TRAIN_BATCH, 512, 7, 7),
                                                                   dtype=torch.bool,
                                                                   device=DEVICE)})
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for (shape, stride), (x, w, _) in sorted(seen.items()):
        xq, wq, ax, aw = irse.int8_forward_codes(x, w)
        cq = irse.int8_forward_codes(x.cpu(), w.cpu())
        dx, dw = (xq.cpu().int() - cq[0].int()).abs(), (wq.cpu().int() - cq[1].int()).abs()
        flips = int(dx.gt(0).sum()) + int(dw.gt(0).sum())
        worst = max(int(dx.max()), int(dw.max()))
        card = irse.int8_forward_sums(xq, wq, stride, 1)
        plain = irse.int8_forward_sums(xq, wq, stride, 1, plain=True)
        exact = bool(torch.equal(card, plain))
        rows.append({"x": list(shape), "w": list(w.shape), "stride": stride, "flips": flips,
                     "max_code_diff": worst, "sums_equal": exact})
        if not exact or worst > 1 or flips > max(2, xq.numel() // 10_000):
            fail(f"int8 forward at {shape} stride {stride}: sums equal {exact}, "
                 f"{flips} code flips (largest {worst})")
        del card, plain
    res["int8_forward_shapes"] = rows
    print(f"[train] int8 forward: at all {len(rows)} res-conv shapes of the step the s32 "
          f"sums equal the plain version's float64 sums, codes card vs CPU differ at "
          f"{sum(r['flips'] for r in rows)} elements (off by one at most)")


def export_into_serving(res, fixture, npz, ck) -> None:
    """The exported ir_101 weights in FaceEmbedder on the card against the
    trainer's own eval-mode forward of the state it exported (the last
    checkpoint under `ck` in the unfolded float32 backbone, BatchNorm from
    its running statistics), then one fused serving step at phase 3's
    build."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.ops.image import normalize_face_batch
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.train.checkpoint import restore_checkpoint
    from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer

    embedder = FaceEmbedder(TRAIN_ARCH, model_path=npz, dtype=torch.bfloat16, device=DEVICE)
    trainer = Trainer(TrainConfig(architecture=TRAIN_ARCH, num_classes=TRAIN_CLASSES),
                      device=DEVICE)
    state = restore_checkpoint(ck, trainer.init_state(0))
    if int(state["step"]) != TRAIN_RESUME_STEPS:
        fail(f"the last checkpoint is at step {int(state['step'])}")
    ref = build_backbone(TRAIN_ARCH)
    missing, unexpected = ref.load_state_dict(
        {**state["params"]["backbone"], **state["batch_stats"]}, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        fail(f"the train state does not fill the backbone: missing {missing}, "
             f"unexpected {unexpected}")
    del state, trainer
    ref = ref.to(DEVICE).eval()
    faces = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (32, 112, 112, 3)).astype(np.float32)).to(DEVICE)
    with torch.no_grad():
        want, _ = ref(normalize_face_batch(faces, dtype=torch.float32))
        got, _ = embedder.embed_batch_device(faces)
    dist = float((1 - (want * got.float()).sum(1)).max())
    res["export_cosine_distance"] = dist
    print(f"[train] exported ir_101 .npz in FaceEmbedder (bf16, folded) against the trainer's "
          f"float32 eval-mode forward of its step-{TRAIN_RESUME_STEPS} checkpoint: largest cosine distance {dist:.2e} over 32 faces "
          f"(limit 1e-3)")
    if dist > 1e-3:
        fail(f"exported weights embed {dist} away from the trainer's forward")

    detector = MTCNNDetector(det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES,
                             min_face_size=40, dtype=torch.bfloat16, device=DEVICE,
                             weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"))
    engine = RecognitionEngine(detector, embedder, top_k=3)
    gallery = DeviceGallery(device=DEVICE)
    g = np.random.default_rng(0).normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)],
                    g / np.linalg.norm(g, axis=1, keepdims=True))
    frames = torch.from_numpy(mosaics(fixture, BATCH)[0]).to(DEVICE)
    t, v, _ = gallery.device_snapshot()
    engine.process_frames(frames, t, v)
    k1, k2 = crop_kernel.LAUNCHES.count, warp_kernel.LAUNCHES.count
    out, ms = timed_steps(engine, frames, t, v, 4)
    launches = {"crop_resize": crop_kernel.LAUNCHES.count - k1,
                "warp_patches": warp_kernel.LAUNCHES.count - k2}
    if launches != {"crop_resize": 12, "warp_patches": 4}:
        fail(f"the serving step with the trained weights launched {launches} in 4 steps")
    for key in ("bboxes", "embeddings", "match_scores", "embedding_norms"):
        if not torch.isfinite(out[key]).all():
            fail(f"the serving step with the trained weights gave non-finite {key}")
    res["serving_launches"] = launches
    res["serving_step_p50_ms"] = ms[len(ms) // 2]
    print(f"[train] the fused serving step (B={BATCH}, {DET_SIZE[0]}x{DET_SIZE[1]}, "
          f"{GALLERY_ROWS}-row gallery) with the trained weights: finite outputs, "
          f"{int(out['face_valid'].sum())} faces, p50 {ms[len(ms) // 2]:.2f} ms, launches "
          f"over 4 steps {launches}")
    del engine, detector, embedder, ref


def accuracy_recipe(res) -> None:
    """bench.py's e2e_rank1 on the card with ir_micro weights the port
    trains here (examples/synthetic_end_to_end.py's recipe, bf16)."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.evalharness import e2e_accuracy as E
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.train.checkpoint import export_backbone

    idents = E.identities()
    k1 = crop_kernel.LAUNCHES.count
    t0 = time.perf_counter()
    pool = E.aligned_pool(idents, E.make_processor(
        os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz"), dtype=torch.bfloat16,
        device=DEVICE))
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, state, losses = E.train_synthetic_embedder(idents, pool, steps=E2E_STEPS,
                                                  batch=E2E_BATCH, dtype=torch.bfloat16,
                                                  device=DEVICE)
    train_s = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        fail("the accuracy recipe's training gave a non-finite loss")
    # kept in the run's work directory: phase 17 enrols and sweeps with it
    os.makedirs(WORK, exist_ok=True)
    npz = os.path.join(WORK, "ir_micro_synthetic.npz")
    export_backbone(state, npz)
    embedder = FaceEmbedder("ir_micro", model_path=npz, dtype=torch.bfloat16, device=DEVICE)
    t0 = time.perf_counter()
    r = E.e2e_rank1(embedder, E.make_processor(os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
                                               dtype=torch.bfloat16, device=DEVICE),
                    idents, device=DEVICE)
    score_s = time.perf_counter() - t0
    res["e2e"] = {"e2e_rank1": r["e2e_rank1"], "e2e_rank1_n": r["e2e_rank1_n"],
                  "pool_s": pool_s, "train_s": train_s, "score_s": score_s,
                  "first_loss": losses[0], "last_loss": float(np.mean(losses[-20:])),
                  "k1_launches": crop_kernel.LAUNCHES.count - k1,
                  "pool_crops": sum(len(v) for v in pool.values()), "weights": npz}
    print(f"[train] accuracy recipe: e2e_rank1 {r['e2e_rank1']} over n={r['e2e_rank1_n']} "
          f"trials (floor {E2E_FLOOR}), ir_micro trained on the card in {train_s:.1f} s "
          f"({E2E_STEPS} steps at B={E2E_BATCH}, bf16; loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-20:]):.3f}), aligned pool {res['e2e']['pool_crops']} crops in "
          f"{pool_s:.1f} s, enrol + score {score_s:.1f} s, K1 launched "
          f"{res['e2e']['k1_launches']} times")
    if r["e2e_rank1"] < E2E_FLOOR:
        fail(f"e2e_rank1 {r['e2e_rank1']} < {E2E_FLOOR}")


def detector_training(res) -> None:
    """train_detector on the card, the weights into MTCNNDetector, and the
    OOD suite through a bf16 cascade on the shipped synthetic weights."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.evalharness.detection_ood import (
        OOD_CATEGORIES,
        run_ood_suite,
    )
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel
    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        render_scene,
        train_detector,
    )

    import contextlib
    import io

    history: dict = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        variables = train_detector(steps=DET_STEPS, batch=DET_BATCH, ohem_fraction=DET_OHEM,
                                   device=DEVICE, history=history, log_every=DET_STEPS)
    secs = time.perf_counter() - t0
    rows = {}
    for net, losses in history.items():
        first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
        rows[net] = {"first20": first, "last20": last}
        if not np.isfinite(losses).all() or not last < first:
            fail(f"train_detector {net}: losses first 20 {first}, last 20 {last}")
    det = MTCNNDetector(det_size=(160, 160), variables=variables, dtype=torch.bfloat16,
                        device=DEVICE)
    found = det.detect(render_scene(np.random.default_rng(3))[0])
    res["detector_training"] = {"seconds": secs, "nets": rows, "faces_found": len(found)}
    print(f"[train] train_detector({DET_STEPS} steps, batch {DET_BATCH}, OHEM {DET_OHEM}) on "
          f"the card in {secs:.1f} s: " + "; ".join(
              f"{n} loss {r['first20']:.4f} -> {r['last20']:.4f}" for n, r in rows.items())
          + f"; loaded into MTCNNDetector, {len(found)} faces on a rendered scene")

    ood_det = MTCNNDetector(weights_path=os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz"),
                            dtype=torch.bfloat16, device=DEVICE)
    k1 = crop_kernel.LAUNCHES.count
    t0 = time.perf_counter()
    ood = run_ood_suite(ood_det, n_scenes=OOD_SCENES)
    secs = time.perf_counter() - t0
    n = crop_kernel.LAUNCHES.count - k1
    if n != 2 * len(OOD_CATEGORIES) * OOD_SCENES:
        fail(f"run_ood_suite launched K1 {n} times for {len(OOD_CATEGORIES) * OOD_SCENES} scenes")
    res["ood"] = {"summary": ood["summary"], "seconds": secs, "k1_launches": n}
    print(f"[train] run_ood_suite ({OOD_SCENES} scenes x {len(OOD_CATEGORIES)} categories, "
          f"320 px, bf16 cascade on mtcnn_synthetic.npz) in {secs:.1f} s, K1 launched {n} "
          f"times: " + "; ".join(
              f"{c} AP {None if s['ap'] is None else round(s['ap'], 4)} recall "
              f"{None if s['recall'] is None else round(s['recall'], 4)} fp/img "
              f"{s['fp_per_image']:.3f}" for c, s in ood["summary"].items()))


def fused_int8_body(res, npz) -> None:
    """FaceEmbedder(quantize='int8', int8_fused=True) at ir_101 on the card
    with the trained weights: embeddings against the unfused int8
    embedder's within the CPU test's bound (float32), embed p50 of both
    (bf16)."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.models.quantize import default_calibration_faces
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    calib = default_calibration_faces()
    faces = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (FUSED_FACES, 112, 112, 3)).astype(np.float32)).to(DEVICE)
    emb = {}
    for dt in (torch.float32, torch.bfloat16):
        for fused in (False, True):
            e = FaceEmbedder(TRAIN_ARCH, model_path=npz, dtype=dt, quantize="int8",
                             int8_fused=fused, calib_faces=calib, device=DEVICE)
            with torch.no_grad():
                f = e.embed_batch_device(faces)[0].float()
            ms = cuda_time_ms(lambda: e.embed_batch_device(faces), iters=10) \
                if dt == torch.bfloat16 else None
            emb[(dt, fused)] = (f, ms)
            del e
    cos32 = float((emb[(torch.float32, False)][0] * emb[(torch.float32, True)][0]).sum(1).min())
    cos16 = float((emb[(torch.bfloat16, False)][0] * emb[(torch.bfloat16, True)][0]).sum(1).min())
    res["fused_int8"] = {"min_cosine_f32": cos32, "min_cosine_bf16": cos16,
                         "embed_ms_unfused": emb[(torch.bfloat16, False)][1],
                         "embed_ms_fused": emb[(torch.bfloat16, True)][1]}
    print(f"[train] fused int8 body at ir_101 ({FUSED_FACES} faces): cosine to the unfused "
          f"int8 embedder >= {cos32:.6f} in float32 (CPU test bound 0.9999), >= {cos16:.5f} "
          f"in bf16; embed {FUSED_FACES} faces bf16: fused "
          f"{res['fused_int8']['embed_ms_fused']:.3f} ms, unfused "
          f"{res['fused_int8']['embed_ms_unfused']:.3f} ms")
    if cos32 <= 0.9999:
        fail(f"fused int8 body {cos32} from the unfused one")


def train_phase(fixture, report) -> None:
    """Phase 11: training on the card (see the module docstring)."""
    import numpy as np

    import shutil

    import torch

    from facerecognitionpipeline_tpu_torch.cli import train_embedder
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.train.checkpoint import latest_step
    from facerecognitionpipeline_tpu_torch.train.trainer import (
        TrainConfig,
        Trainer,
        dropout_generator,
    )

    t_phase = time.perf_counter()
    res: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # 11a: the CLI at full width, resume, export
        ck, npz = os.path.join(tmp, "ck"), os.path.join(tmp, "ir_101.npz")
        argv = ["--device", DEVICE, "--synthetic_classes", str(TRAIN_CLASSES),
                "--architecture", TRAIN_ARCH, "--batch_size", str(TRAIN_BATCH), "--bf16",
                "--checkpoint_every", str(TRAIN_EVERY), "--log_every", str(TRAIN_EVERY),
                "--prefetch", "2",
                "--checkpoint_dir", ck]
        cli = {}
        for tag, extra in (("first", ["--steps", str(TRAIN_STEPS)]),
                           ("resume", ["--steps", str(TRAIN_RESUME_STEPS), "--resume",
                                       "--export_path", npz])):
            t0 = time.perf_counter()
            rc, out = run_cli(train_embedder.main, argv + extra)
            secs = time.perf_counter() - t0
            logs = [ln for ln in out.splitlines() if ln.startswith("step ")]
            losses = [float(ln.split("loss ")[1].split()[0]) for ln in logs]
            rates = [float(ln.split("(")[1].split()[0]) for ln in logs]
            cli[tag] = {"seconds": secs, "losses": losses, "images_per_s": rates}
            print(f"[train] train_embedder {tag}: rc {rc} in {secs:.1f} s; " + "; ".join(logs)
                  + "; " + out.strip().splitlines()[-1])
            if rc != 0 or not losses or not np.isfinite(losses).all():
                fail(f"train_embedder {tag}: rc {rc}, losses {losses}")
        if f"Resumed from step {TRAIN_STEPS}" not in out or \
                f"Training done at step {TRAIN_RESUME_STEPS}" not in out:
            fail(f"the resumed run did not go from step {TRAIN_STEPS} to {TRAIN_RESUME_STEPS}")
        kept = sorted(os.listdir(ck))
        if latest_step(ck) != TRAIN_RESUME_STEPS or len(kept) != 3:
            fail(f"checkpoints after resume: {kept}")
        t0 = time.perf_counter()
        rc, out = run_cli(train_embedder.main, [
            a for a in argv if a != "--bf16"] + ["--steps", str(TRAIN_F32_STEPS),
                                                 "--checkpoint_dir", os.path.join(tmp, "f32")])
        logs = [ln for ln in out.splitlines() if ln.startswith("step ")]
        cli["float32"] = {"seconds": time.perf_counter() - t0,
                          "losses": [float(ln.split("loss ")[1].split()[0]) for ln in logs]}
        print(f"[train] train_embedder float32, {TRAIN_F32_STEPS} steps: rc {rc} in "
              f"{cli['float32']['seconds']:.1f} s; " + "; ".join(logs))
        if rc != 0 or not np.isfinite(cli["float32"]["losses"]).all():
            fail("train_embedder at float32 failed")
        res["cli"] = cli
        shutil.rmtree(os.path.join(tmp, "f32"), ignore_errors=True)

        # 11b: the step's numbers, bf16, float32, int8 forward; the update alone
        macs = conv_dense_macs(TRAIN_ARCH)
        res["macs_per_image"], res["res_conv_macs_per_image"] = macs
        run = train_config_run("bf16", res, macs, torch.bfloat16)
        optimizer_alone(res, run)
        # the JAX package's learning test (tests/test_train.py:46-69): lr 0.01
        learner = Trainer(TrainConfig(architecture=TRAIN_ARCH, num_classes=TRAIN_CLASSES,
                                      learning_rate=0.01, dtype=torch.bfloat16), device=DEVICE)
        learn_state = learner.init_state(0)
        losses = []
        for i in range(10):
            learn_state, m = learner.train_step(learn_state, run["x"], run["y"],
                                                dropout_generator(0, i, DEVICE))
            losses.append(m["loss"])
        losses = torch.stack(losses).cpu().tolist()
        res["learning"] = losses
        print(f"[train] 10 steps at {TRAIN_ARCH} B={TRAIN_BATCH} bf16, lr 0.01, on one "
              f"repeated batch: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail(f"the loss did not fall on a repeated batch: {losses}")
        del run, learner, learn_state
        torch.cuda.empty_cache()
        train_config_run("float32", res, macs, torch.float32)
        torch.cuda.empty_cache()
        int8_run = train_config_run("int8_forward", res, macs, torch.bfloat16, int8_forward=True)
        int8_forward_sums(res, int8_run)
        del int8_run
        torch.cuda.empty_cache()
        card_against_cpu(res)

        # 11c: export into serving, the accuracy recipe, the detector side
        crop_kernel.LAUNCHES.reset()
        warp_kernel.LAUNCHES.reset()
        export_into_serving(res, fixture, npz, ck)
        shutil.rmtree(ck, ignore_errors=True)
        accuracy_recipe(res)
        detector_training(res)
        res["launches"] = {"crop_resize": crop_kernel.LAUNCHES.count,
                           "warp_patches": warp_kernel.LAUNCHES.count}
        fused_int8_body(res, npz)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[train] phase 11 took {res['seconds']:.1f} s")
    report["train"] = res


MESH_DATA = 2  # data shards of the mesh, every one on the same card
MESH_STEP_ITERS = 12
MESH_BIG_ITERS = 4
MESH_REQUESTS = 40
MESH_TRAIN_STEPS = 3


def mesh_counters():
    from facerecognitionpipeline_tpu_torch.ops import (
        crop_kernel,
        gallery_kernel,
        nms_kernel,
        warp_kernel,
    )

    return {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "nms_fixpoint": nms_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
        "gallery_topk_f32": gallery_kernel.LAUNCHES_F32,
    }


def same_step(tag, a, b) -> dict:
    """A mesh step's outputs `a` against one device's `b` on the same frames:
    the same detections (boxes and landmarks within 1 px), embeddings of
    the valid embedded slots within cosine 0.999, the same top-1 where b's
    margin is clear, the same embedded slots. Returns the largest
    differences."""
    import torch

    valid = b["face_valid"]
    if not torch.equal(a["face_valid"], valid) or not torch.equal(a["embedded"], b["embedded"]):
        fail(f"{tag}: face_valid or embedded differ from the single-device step")
    box = (a["bboxes"] - b["bboxes"])[valid].abs().max().item() if valid.any() else 0.0
    lmk = (a["landmarks"] - b["landmarks"])[valid].abs().max().item() if valid.any() else 0.0
    embedded = valid & b["embedded"]
    ea, eb = a["embeddings"].float()[embedded], b["embeddings"].float()[embedded]
    cos = torch.nn.functional.cosine_similarity(ea, eb, dim=-1).min().item() \
        if embedded.any() else 1.0
    sb = b["match_scores"]
    clear = b["embedded"] & ((sb[..., 0] - sb[..., 1]) > 5e-3)
    if box > 1.0 or lmk > 1.0 or cos < 0.999 or not torch.equal(
            a["match_idx"][..., 0][clear], b["match_idx"][..., 0][clear]):
        fail(f"{tag}: boxes {box}, landmarks {lmk}, embedding cosine {cos} or top-1 "
             f"differ from the single-device step")
    bit = all(torch.equal(a[k], b[k]) for k in a if k != "quality_metrics")
    score = (a["match_scores"] - sb).abs().max().item()
    print(f"[mesh] {tag}: equal to the single-device step (bit for bit: {bit}; boxes "
          f"{box:.3g} px, landmarks {lmk:.3g} px, min embedding cosine {cos:.6f}, match "
          f"scores {score:.3g}, top-1 of {int(clear.sum())} clear slots equal)")
    return {"bit_equal": bit, "box_px": box, "landmark_px": lmk, "min_cosine": cos,
            "score": score}


def mesh_context(fixture) -> dict:
    """What phase 12 takes from phase 3, built without phase 3's checks:
    the server's build and the planted slots of one step."""
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery

    ctx = serving_build(fixture)
    gallery = DeviceGallery(device=DEVICE)
    gallery.rebuild(["id0"], make_gallery(1))
    t, v, _ = gallery.device_snapshot()
    slots, emb = planted_slots(ctx["engine"].process_frames(ctx["frames"], t, v))
    ctx.update({"slots": slots, "emb": torch.from_numpy(emb).to(DEVICE)})
    return ctx


def mesh_phase(ctx, gal, report, cards: bool = False) -> None:
    """Phase 12: the mesh of MESH_DATA entries of the one card, or with
    `cards` of distinct cards (see the module docstring)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.parallel.mesh import make_mesh
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer, serve
    from facerecognitionpipeline_tpu_torch.train.data import synthetic_batches
    from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)

    def entries(n):
        """n mesh entries: the card n times, or with `cards` n cards."""
        if not cards:
            return [dev] * n
        if torch.cuda.device_count() < n:
            fail(f"--cards needs {n} cards, have {torch.cuda.device_count()}")
        return [torch.device("cuda", i) for i in range(n)]

    mesh = make_mesh(data=MESH_DATA, devices=entries(MESH_DATA))
    where = f"{MESH_DATA} cards" if cards else "one card"
    used = set(entries(MESH_DATA * 2))

    def sync():
        for d in used:
            torch.cuda.synchronize(d)
    detector, embedder, frames, slots = (ctx["detector"], ctx["embedder"], ctx["frames"],
                                         ctx["slots"])
    single = ctx["engine"]
    counters = mesh_counters()
    totals = {k: 0 for k in counters}
    res: dict = {"mesh": str(mesh)}
    graphed = [0]  # runs held to their eager step

    def run(engine, t, v, iters, rotation=0):
        """`iters` steps with the counts from 0: (last output, sorted ms,
        launches). The mesh's launches also go to the phase's totals."""
        engine.process_frames(frames, t, v, rotation=rotation)  # warm
        for c in counters.values():
            c.reset()
        times, out = [], None
        for _ in range(iters):
            sync()
            s0 = time.perf_counter()
            out = engine.process_frames(frames, t, v, rotation=rotation)
            sync()
            times.append(1e3 * (time.perf_counter() - s0))
        got = {k: c.count for k, c in counters.items()}
        if engine.mesh is not None:
            for k in totals:
                totals[k] += got[k]
        # the steps went through the engine's graphs (one per data shard):
        # held to its eager step on the same frames, bit for bit
        diffs = tree_diff(out, engine.step(t, v, frames, 3, rotation))
        if diffs:
            fail(f"{'mesh' if engine.mesh is not None else 'single-device'} step through "
                 f"its graphs differs from its eager step in {diffs}")
        graphed[0] += 1
        return out, sorted(times), got

    def expect(tag, got, iters, **per_step):
        want = {k: 0 for k in counters}
        want.update({"crop_resize": 3 * MESH_DATA * iters, "warp_patches": MESH_DATA * iters,
                     "nms_fixpoint": 3 * MESH_DATA * iters})
        want.update({k: n * iters for k, n in per_step.items()})
        if got != want:
            fail(f"{tag}: launches {got}, expected {want}")

    def planted(tag, out, rows, floor):
        idx = out["match_idx"].cpu().numpy()
        sc = out["match_scores"].cpu().numpy()
        for row, (f, s) in zip(rows, slots):
            if idx[f, s, 0] != row or sc[f, s, 0] <= floor:
                fail(f"{tag}: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")

    meshed = RecognitionEngine(detector, embedder, top_k=3, mesh=mesh)
    for sh in meshed._shards:
        own = sh.device == meshed.device
        if (sh.detector is detector) != own or (sh.embedder is embedder) != own:
            fail("a replica must be the detector and embedder themselves exactly on "
                 "the weights' own device")

    # 12a: the dense step data parallel, 1024 float32 rows with planted rows
    emb = ctx["emb"].float()
    small = make_gallery(GALLERY_ROWS, seed=3)
    rows_small = [100 + 37 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows_small, slots):
        small[row] = emb[f, s]
    g_small = DeviceGallery(device=DEVICE)
    g_small.rebuild([f"id{i}" for i in range(GALLERY_ROWS)], small)
    t, v, _ = g_small.device_snapshot()
    out_m, ms_m, got = run(meshed, t, v, MESH_STEP_ITERS)
    expect("dense mesh step", got, MESH_STEP_ITERS)
    out_s, ms_s, _ = run(single, t, v, MESH_STEP_ITERS)
    res["dense"] = same_step("dense step, 1024 float32 rows", out_m, out_s)
    planted("dense mesh step", out_m, rows_small, 0.99)
    p50_m, p50_s = ms_m[len(ms_m) // 2], ms_s[len(ms_s) // 2]
    res["dense"].update({"p50_ms": p50_m, "single_p50_ms": p50_s,
                         "launches_per_step": {k: n / MESH_STEP_ITERS for k, n in got.items()}})
    print(f"[timing] mesh step ({MESH_DATA} data shards on {where}) B={BATCH} {ARCH} bf16, "
          f"{GALLERY_ROWS}-row float32 gallery: p50 {p50_m:.3f} ms (min {ms_m[0]:.3f}) beside "
          f"the single-device step's {p50_s:.3f} ms (min {ms_s[0]:.3f}) in this run, "
          f"{MESH_STEP_ITERS} steps each; launches per mesh step "
          f"{ {k: n / MESH_STEP_ITERS for k, n in got.items() if n} }")

    # 12b: embed_budget=4 data parallel
    budget_m = RecognitionEngine(detector, embedder, top_k=3, mesh=mesh, embed_budget=4)
    budget_s = RecognitionEngine(detector, embedder, top_k=3, embed_budget=4)
    out_m, ms_m, got = run(budget_m, t, v, 3, rotation=1)
    expect("budget mesh step", got, 3)
    out_s, _, _ = run(budget_s, t, v, 3, rotation=1)
    res["budget"] = same_step("embed_budget=4 step, rotation 1", out_m, out_s)
    res["budget"]["p50_ms"] = ms_m[len(ms_m) // 2]
    del g_small, t, v, small

    # 12c/12d: 1 048 576 identities, bf16 (K3) and int8 (K4), rows sharded
    big = gal.shape[0]
    ids = [f"id{i}" for i in range(big)]
    rows = [(4099 + 131_101 * i) % big for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        gal[row] = emb[f, s]  # as phase 5 plants them
    sharded = RecognitionEngine(detector, embedder, top_k=3, mesh=mesh, shard_gallery=True)
    for quantize, kernel, floor in ((None, "gallery_topk", 0.99),
                                    ("int8", "gallery_topk_int8", 0.98)):
        label = quantize or "bf16"
        t0 = time.perf_counter()
        g_one = DeviceGallery(device=DEVICE, quantize=quantize)
        g_one.rebuild(ids, gal)
        g_mesh = DeviceGallery(mesh=mesh, quantize=quantize)
        g_mesh.rebuild(ids, gal)
        t1, v1, _ = g_one.device_snapshot()
        ts, vs, _ = g_mesh.device_snapshot()
        blocks = (ts[0] if isinstance(ts, tuple) else ts).blocks
        if [tuple(b.shape)[0] for b in blocks] != [big // MESH_DATA] * MESH_DATA or \
                len({b.data_ptr() for b in blocks}) != MESH_DATA:
            fail(f"{label}: the sharded gallery is not {MESH_DATA} tensors of its own")
        sync()
        print(f"[mesh] {label}: DeviceGallery of {big} identities, one device and "
              f"{MESH_DATA} row shards of {big // MESH_DATA}, rebuilt in "
              f"{time.perf_counter() - t0:.2f} s")
        out_sh, ms_sh, got = run(sharded, ts, vs, MESH_BIG_ITERS)
        expect(f"{label} shard_gallery step", got, MESH_BIG_ITERS, **{kernel: MESH_DATA})
        planted(f"{label} shard_gallery step", out_sh, rows, floor)
        out_rep, ms_rep, got = run(meshed, t1, v1, MESH_BIG_ITERS)
        expect(f"{label} replicated-gallery mesh step", got, MESH_BIG_ITERS,
               **{kernel: MESH_DATA})
        out_s, ms_s, _ = run(single, t1, v1, MESH_BIG_ITERS)
        cmp_sh = same_step(f"{label} shard_gallery step", out_sh, out_s)
        cmp_rep = same_step(f"{label} replicated-gallery mesh step", out_rep, out_s)
        p50 = {"shard_gallery": ms_sh[len(ms_sh) // 2], "replicated": ms_rep[len(ms_rep) // 2],
               "single": ms_s[len(ms_s) // 2]}
        print(f"[timing] {big}-row {label} gallery, B={BATCH}: p50 shard_gallery "
              f"{p50['shard_gallery']:.3f} ms, replicated gallery on the mesh "
              f"{p50['replicated']:.3f}, single device {p50['single']:.3f} "
              f"({MESH_BIG_ITERS} steps each); {kernel} {MESH_DATA} launches per mesh step")
        res[f"big_{label}"] = {"p50_ms": p50, "shard_gallery": cmp_sh, "replicated": cmp_rep}
        # DeviceGallery.search under the mesh against one device, top_k 5
        q = torch.cat([emb[[f for f, _ in slots], [s for _, s in slots]],
                       make_gallery(8, seed=11)]).cpu().numpy()
        for c in counters.values():
            c.reset()
        s_mesh, n_mesh = g_mesh.search(q, top_k=5)
        sync()
        if counters[kernel].count != MESH_DATA:
            fail(f"{label}: the sharded search launched {kernel} {counters[kernel].count} times")
        totals[kernel] += counters[kernel].count
        s_one, n_one = g_one.search(q, top_k=5)
        err = float(np.abs(s_mesh - s_one).max())
        if n_mesh != n_one or err > 1e-6:
            fail(f"{label}: the sharded search differs from one device's ({err})")
        if [n[0] for n in n_mesh[:len(rows)]] != [f"id{r}" for r in rows]:
            fail(f"{label}: the sharded search did not find the planted rows")
        print(f"[mesh] {label}: DeviceGallery(mesh).search at top_k 5 ({len(q)} queries) "
              f"equals one device's (ids equal, scores within {err:.3g}), {kernel} once per "
              f"shard")
        res[f"big_{label}"]["search_err"] = err
        del g_one, g_mesh, t1, v1, ts, vs, out_sh, out_rep, out_s
        torch.cuda.empty_cache()

    # 12e: a server built on the mesh engine, raw rgb24 requests
    frame = ctx["frames_np"][0]
    with tempfile.TemporaryDirectory() as tmp:
        manager = GalleryManager(os.path.join(tmp, "g.pkl"), verbose=False, device=DEVICE)
        for i, (f, s) in enumerate(slots):
            manager.add_student(f"s{i:03d}", f"Student {i}",
                                emb[f, s].cpu().numpy()[None].repeat(2, axis=0))
        t0 = time.perf_counter()
        server = FaceRecognitionServer(
            similarity_threshold=SERVER_THRESHOLD, output_dir=os.path.join(tmp, "sessions"),
            engine=meshed, gallery=manager, det_size=DET_SIZE, batch_max=BATCH,
            batch_buckets=(1, MESH_DATA, BATCH), device=DEVICE,
        )
        if server.batcher.bucket_sizes != [MESH_DATA, BATCH]:
            fail(f"mesh server: buckets {server.batcher.bucket_sizes}, expected "
                 f"{[MESH_DATA, BATCH]} (multiples of the data axis)")
        httpd = serve(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        http = HTTPSession()
        try:
            print(f"[mesh] server on the mesh engine built and listening in "
                  f"{time.perf_counter() - t0:.1f} s (buckets {server.batcher.bucket_sizes})")
            if http.post(f"{url}/init_session", json={"session_name": "mesh"},
                         timeout=60).status_code != 200:
                fail("mesh server: /init_session failed")
            tv, vv, sids = manager.device_snapshot()
            direct = meshed.process_frames(np.stack([frame] * MESH_DATA), tv, vv, gallery_k=3)
            ok = (direct["face_valid"][0] & direct["quality_ok"][0]).cpu().numpy()
            faces = [{"bbox": b} for b, o in zip(direct["bboxes"][0].cpu().numpy(), ok) if o]
            for c in counters.values():
                c.reset()
            steps0 = server.batcher._dispatch_count
            lat = []
            for j in range(MESH_REQUESTS):
                s0 = time.perf_counter()
                r = http.post(
                    f"{url}/process_frame_raw", data=frame.tobytes(), timeout=120,
                    headers={rawproto.HEADER_FORMAT: "rgb24",
                             rawproto.HEADER_WIDTH: str(DET_SIZE[1]),
                             rawproto.HEADER_HEIGHT: str(DET_SIZE[0]),
                             rawproto.HEADER_SCALE: "1.0"})
                lat.append(1e3 * (time.perf_counter() - s0))
                if r.status_code != 200:
                    fail(f"mesh server: request {j} answered {r.status_code}")
                check_response(f"mesh server request {j}", r.json(), faces, 1.0)
            steps = server.batcher._dispatch_count - steps0
            got = {k: c.count for k, c in counters.items()}
            expect("mesh server", got, steps)
            for k in totals:
                totals[k] += got[k]
            res["server"] = {"requests": MESH_REQUESTS, "steps": steps,
                             "p50_ms": pct(lat, 50), "p95_ms": pct(lat, 95)}
            print(f"[mesh] server on the mesh engine: {MESH_REQUESTS} raw rgb24 requests "
                  f"answered as the direct mesh step ({len(faces)} faces, boxes within 1 px) "
                  f"in {steps} steps, request p50 {pct(lat, 50):.3f} ms, p95 "
                  f"{pct(lat, 95):.3f} ms; launches {got}")
        finally:
            http.close()
            stop_server(server, httpd, thread)

    # 12f: the trainer on (2, 2) and (2, 1) meshes of the card, float32, on
    # phase 11's batch. A repeated batch falls to a loss of ~0.1 in 3 steps,
    # so the loss is held within 1e-4 + 5e-4 |loss|; parameters within 1e-3
    # after step 1 and 3e-3 after the last. The fault this comparison is
    # for, a classifier gradient scaled by 1 / n_model (the JAX step's factor
    # for shard_map's replicated loss), moves step 1's classifier by lr |g| /
    # 2, g the (2, 1) trainer's first classifier gradient (its trace less the
    # weight decay): that must clear the step-1 bound by more than the gap
    # measured, or the check could not see the fault.
    x, y = (torch.from_numpy(a).to(DEVICE)
            for a in next(synthetic_batches(TRAIN_CLASSES, TRAIN_BATCH, seed=1)))
    cfg = TrainConfig(architecture=TRAIN_ARCH, num_classes=TRAIN_CLASSES)
    runs = {}
    for m in (2, 1):
        trainer = Trainer(cfg, make_mesh(data=MESH_DATA, model=m, devices=entries(MESH_DATA * m)))
        state = trainer.init_state(0)
        states, losses, times = [state], [], []
        for i in range(MESH_TRAIN_STEPS):
            sync()
            s0 = time.perf_counter()
            state, met = trainer.train_step(state, x, y, trainer.dropout_generators(0, i))
            sync()
            times.append(1e3 * (time.perf_counter() - s0))
            losses.append(met["loss"])
            states.append(state)
        runs[m] = {"states": states, "loss": [float(v) for v in losses], "ms": times}
        del trainer

    def flat_params(st):
        blocks = st["params"]["classifier"]
        home = blocks[0].device  # blocks may lie on several cards
        return {**st["params"]["backbone"],
                "classifier": torch.cat([blk.to(home) for blk in blocks], 1)}

    def param_gap(step):
        pa, pb = flat_params(runs[2]["states"][step]), flat_params(runs[1]["states"][step])
        return max((pa[k] - pb[k].to(pa[k].device)).abs().max().item() for k in pb)

    param1, param = param_gap(1), param_gap(MESH_TRAIN_STEPS)
    first, second = runs[1]["states"][0], runs[1]["states"][1]
    g = (second["opt_state"]["trace"]["classifier"][0]
         - cfg.weight_decay * first["params"]["classifier"][0])
    fault = cfg.learning_rate / 2 * g.abs().max().item()
    a, b = runs[2]["states"][-1], runs[1]["states"][-1]
    loss_abs = [abs(p - q) for p, q in zip(runs[2]["loss"], runs[1]["loss"])]
    loss_ok = all(d <= 1e-4 + 5e-4 * abs(q) for d, q in zip(loss_abs, runs[1]["loss"]))
    stats = max(((a["batch_stats"][k] - v).norm() / (v.norm() + 1e-5 * v.numel() ** 0.5)).item()
                for k, v in b["batch_stats"].items())
    if not all(np.isfinite(runs[m]["loss"]).all() for m in runs) or not loss_ok or \
            param1 > 1e-3 or param > 3e-3 or stats > 5e-3:
        fail(f"train (2, 2) vs (2, 1): losses {runs[2]['loss']} vs {runs[1]['loss']}, "
             f"params {param1} (step 1), {param}, batch_stats {stats}")
    if fault - param1 <= 1e-3:
        fail(f"train (2, 2) vs (2, 1): a classifier gradient scaled by 1/2 would move step 1 "
             f"by {fault}, within the 1e-3 bound plus the gap measured ({param1})")
    res["train"] = {"loss_abs": loss_abs, "param_abs_step1": param1, "param_abs": param,
                    "fault_step1": fault, "batch_stats_rel": stats,
                    "losses": runs[2]["loss"], "ms_2x2": runs[2]["ms"], "ms_2x1": runs[1]["ms"]}
    print(f"[mesh] train {TRAIN_ARCH} B={TRAIN_BATCH} {TRAIN_CLASSES} classes float32, "
          f"{MESH_TRAIN_STEPS} steps on phase 11's batch on (2, 2) and (2, 1) meshes "
          f"({'4 and 2 cards' if cards else 'one card'}): losses "
          f"{[round(v, 4) for v in runs[2]['loss']]}, (2, 2) vs (2, 1) loss "
          f"{max(loss_abs):.3g} absolute (bound 1e-4 + 5e-4 |loss|), parameters "
          f"{param1:.3g} after step 1 (bound 1e-3) and {param:.3g} after step "
          f"{MESH_TRAIN_STEPS} (bound 3e-3), batch_stats {stats:.3g} relative; a classifier "
          f"gradient scaled by 1/2 would move step 1 by {fault:.3g}; step ms (host clock, "
          f"every card synchronized) (2, 2) {[round(v, 1) for v in runs[2]['ms']]}, (2, 1) "
          f"{[round(v, 1) for v in runs[1]['ms']]}")
    del runs, a, b, first, second, g
    torch.cuda.empty_cache()
    res["launches"] = totals
    res["graph_runs_equal_to_eager"] = graphed[0]
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[mesh] {graphed[0]} runs of mesh and single-device steps through per-shard graphs, "
          f"each equal to its engine's eager step bit for bit")
    print(f"[mesh] phase 12 launches {totals}; took {res['seconds']:.1f} s")
    report["mesh"] = res


# ------------------------------------------------------------ phase 13

GRAPH_ITERS = 20  # timed steps per (mode, batch)
GRAPH_REQUESTS = 120  # raw rgb24 requests per mode
GRAPH_ROTATIONS = (0, 1, 2, (1 << 28) + 3)  # the last: rotation * 4 wraps int32


def tree_diff(got, want, prefix="") -> list:
    """(field, largest |difference|) of every leaf where two result trees
    are not equal bit for bit."""
    import torch

    if isinstance(want, dict):
        out = []
        for k in want:
            out += tree_diff(got[k], want[k], f"{prefix}{k}.")
        return out
    if got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want):
        return []
    gap = (got.double() - want.double()).abs().max().item() if got.shape == want.shape else None
    return [(prefix[:-1], gap)]


def step_stats(fn, iters: int) -> dict:
    """p50 of `iters` synchronized calls of `fn` (host clock), then the
    device time per call and the busy share over 3 profiled calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - s0))
    times.sort()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - s0)
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    return {"p50_ms": times[iters // 2], "min_ms": times[0],
            "device_ms": dev_us / 3e3 if dev_us > 0 else None,
            "busy": dev_us / wall_us if dev_us > 0 else None}


def pool_total_bytes(engine):
    """Bytes of the segments of the engine's graph pools (its graphs kept:
    those of the newest gallery), from the allocator's snapshot; None where
    the snapshot names no pool."""
    import torch

    graphs = engine._graphs
    if graphs is None:
        return 0
    ids = {tuple(p) for p in getattr(graphs._capture, "_pools", {}).values()}
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) in ids)


def replay_kernels(engine, frames, t, v, rotation=0) -> dict:
    """Kernel launches in a torch.profiler trace of one step through the
    engine's graph (its key captured before the trace), by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.process_frames(frames, t, v, rotation=rotation)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.process_frames(frames, t, v, rotation=rotation)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    counts = {name: sum(e.count for e in events if name in e.key)
              for name in ("crop_resize", "warp_patches", "nms_fixpoint", "stream_topk_kernel")}
    counts["all"] = sum(e.count for e in events)
    return counts


def eager_process_frames(engine):
    """`engine.process_frames` through the eager step: the yardstick the
    script binds on an engine (the package has no switch for it)."""
    import torch

    def run(frames, gallery_templates, gallery_valid, gallery_k=None, rotation=0):
        frames = torch.as_tensor(frames).to(engine.device, non_blocking=True)
        return engine.step(gallery_templates, gallery_valid, frames,
                           gallery_k or engine.top_k, rotation)

    return run


def int8_build():
    """The int8 detector and embedder of phase 8, calibrated again."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    detector = MTCNNDetector(
        det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES, min_face_size=40,
        dtype=torch.bfloat16, device=DEVICE, quantize="int8",
        weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
    )
    embedder = FaceEmbedder(ARCH, dtype=torch.bfloat16, random_ok=True, init_seed=0,
                            quantize="int8", device=DEVICE)
    return RecognitionEngine(detector, embedder, top_k=3)


def graph_phase(ctx, gal, report) -> None:
    """Phase 13: the compiled step. Per route, an eager step under
    torch.cuda.set_sync_debug_mode("error"), the graphs at B=1 and B=8
    against the eager step bit for bit, and a profiler trace of one replay;
    then eager against graph step times, raw rgb24 requests through a
    server with the engine on its graphs and then eager, and every capture's
    pool bytes and seconds."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.ops import (
        crop_kernel,
        gallery_kernel,
        nms_kernel,
        warp_kernel,
    )
    from facerecognitionpipeline_tpu_torch.ops.image import rgb_to_i420_host
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.serve.client import (
        FaceRecognitionClient,
        HTTPSession,
    )
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer, serve

    t_phase = time.perf_counter()
    detector, embedder, engine = ctx["detector"], ctx["embedder"], ctx["engine"]
    frames, frames_np = ctx["frames"], ctx["frames_np"]
    res: dict = {"routes": {}}
    ids = [f"id{i}" for i in range(GALLERY_ROWS)]
    dense = DeviceGallery(device=DEVICE)
    dense.rebuild(ids, make_gallery(GALLERY_ROWS, seed=13))
    big_ids = [f"id{i}" for i in range(gal.shape[0])]
    big = {}
    for quantize in (None, "int8"):
        big[quantize] = DeviceGallery(device=DEVICE, quantize=quantize)
        big[quantize].rebuild(big_ids, gal)
    int8_engine = ctx.get("int8_engine") or int8_build()
    budget = RecognitionEngine(detector, embedder, top_k=3, embed_budget=4)
    i420 = RecognitionEngine(detector, embedder, top_k=3, input_format="i420")
    frames_i420 = torch.from_numpy(
        np.stack([rgb_to_i420_host(f) for f in frames_np])).to(DEVICE)
    routes = (
        ("dense", engine, frames, dense, 0, (0,)),
        ("1m_bf16", engine, frames, big[None], 1, (0,)),
        ("1m_int8", engine, frames, big["int8"], 1, (0,)),
        ("embed_budget=4", budget, frames, dense, 0, GRAPH_ROTATIONS),
        ("i420", i420, frames_i420, dense, 0, (0,)),
        ("quantize=int8", int8_engine, frames, dense, 0, (0,)),
    )
    counters = {"crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
                "nms_fixpoint": nms_kernel.LAUNCHES, "gallery_topk": gallery_kernel.LAUNCHES,
                "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8}
    launches = {k: 0 for k in counters}
    for name, eng, fr, gallery, streamed, rotations in routes:
        t, v, _ = gallery.device_snapshot()
        eng.step(t, v, fr, 3, 0)  # first use of this build's shapes, eagerly
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step(t, v, fr, 3, rotations[-1])
        except RuntimeError as e:
            fail(f"{name}: the eager step synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        for b in (1, BATCH):
            for rot in rotations:
                want = eng.step(t, v, fr[:b], 3, rot)
                got = eng.process_frames(fr[:b], t, v, rotation=rot)
                diffs = tree_diff(got, want)
                if diffs or len(got) != 12:
                    fail(f"{name} B={b} rotation {rot}: the graph differs from the eager step "
                         f"in {diffs} ({len(got)} fields)")
        for c in counters.values():
            c.reset()
        seen = replay_kernels(eng, fr, t, v, rotations[-1])
        for k, c in counters.items():
            launches[k] += c.count
        want = {"crop_resize": 3, "warp_patches": 1, "nms_fixpoint": 3,
                "stream_topk_kernel": streamed}
        if any(seen[k] != n for k, n in want.items()):
            fail(f"{name}: a profiler trace of one replay saw {seen}, expected {want}")
        res["routes"][name] = {"trace": seen, "rotations": list(rotations)}
        print(f"[graph] {name}: the eager step ran under set_sync_debug_mode('error'); graphs "
              f"at B=1 and B={BATCH} equal the eager step bit for bit on all 12 fields at "
              f"rotation {list(rotations)}; one replay's trace: {seen['crop_resize']} K1, "
              f"{seen['warp_patches']} K2, {seen['nms_fixpoint']} K5, "
              f"{seen['stream_topk_kernel']} K3/K4 of {seen['all']} device events")
    del big

    # two replays back to back: the first answer, copied on a side stream,
    # is not touched by the second replay
    t, v, _ = dense.device_snapshot()
    a_want = engine.step(t, v, frames, 3, 0)["embeddings"].cpu()
    side = torch.cuda.Stream()
    a = engine.process_frames(frames, t, v)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        host = torch.empty(a["embeddings"].shape, dtype=a["embeddings"].dtype, pin_memory=True)
        host.copy_(a["embeddings"], non_blocking=True)
        a["embeddings"].record_stream(side)
    engine.process_frames(torch.flip(frames, dims=[0]), t, v)
    side.synchronize()
    torch.cuda.synchronize()
    if not torch.equal(host, a_want):
        fail("a replay changed the answer of the one before it")
    print("[graph] two replays back to back: the first answer, copied on a side stream, "
          "is unchanged by the second")

    # eager against graph, in turns, at B=1 and B=8 (dense gallery)
    eager = eager_process_frames(engine)
    timing = {}
    for b, order in ((1, ("eager", "graph")), (BATCH, ("graph", "eager"))):
        fb = frames[:b]
        fns = {"eager": lambda fb=fb: eager(fb, t, v),
               "graph": lambda fb=fb: engine.process_frames(fb, t, v)}
        for mode in order:
            timing[f"{mode}_b{b}"] = step_stats(fns[mode], GRAPH_ITERS)
    for key, r in timing.items():
        dev_ms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms"
        busy = "not measured" if r["busy"] is None else f"{r['busy']:.3f}"
        print(f"[timing] step {key.replace('_b', ' B=')} ({ARCH} bf16, {GALLERY_ROWS}-row "
              f"float32 gallery): p50 {r['p50_ms']:.3f} ms, min {r['min_ms']:.3f} over "
              f"{GRAPH_ITERS} steps; device {dev_ms} per step, busy {busy}")
    res["steps"] = timing

    # raw rgb24 requests of one client: the server's engine on its graphs,
    # then on the eager step
    with tempfile.TemporaryDirectory() as tmp:
        gallery_path = os.path.join(tmp, "gallery", "students.pkl")
        server = FaceRecognitionServer(
            similarity_threshold=SERVER_THRESHOLD, output_dir=os.path.join(tmp, "sessions"),
            det_size=DET_SIZE, max_faces=MAX_FACES, batch_max=BATCH,
            batch_buckets=(1, BATCH), engine=engine, gallery_path=gallery_path,
            device=DEVICE,
        )
        httpd = serve(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            writer = GalleryManager(gallery_path, verbose=False, device=DEVICE)
            rng = np.random.default_rng(13)
            for i in range(50):
                writer.add_student(f"s{i:02d}", f"S {i}",
                                   rng.normal(size=(2, 512)).astype(np.float32))
            writer.save()
            before = len(engine._graphs.captures)
            http = HTTPSession()
            try:
                reload = http.post(f"{url}/reload_gallery", json={}, timeout=60).json()
            finally:
                http.close()
            requests = {}
            for mode in ("graph", "eager"):
                if mode == "eager":
                    engine.process_frames = eager
                client = FaceRecognitionClient(
                    server_url=url, session_name=f"graph_{mode}", synthetic=True,
                    frame_skip=1, display=False, output_dir=os.path.join(tmp, mode),
                    image_format="raw", det_size=DET_SIZE)
                if not client.check_server() or not client.init_session():
                    fail("phase 13: /health or /init_session failed")
                lat = []
                for i in range(GRAPH_REQUESTS):
                    s0 = time.perf_counter()
                    body = client.process_frame(frames_np[0])
                    lat.append(1e3 * (time.perf_counter() - s0))
                    if body is None:
                        fail(f"phase 13: request {i} ({mode}) was not answered")
                    if mode == "graph" and i == 0:
                        captured = len(engine._graphs.captures) - before
                        if reload.get("status") != "reloaded" or captured != 1:
                            fail(f"phase 13: /reload_gallery ({reload}) then one request "
                                 f"made {captured} captures, expected 1")
                client.finalize_session()
                requests[mode] = {"p50_ms": pct(lat, 50), "p95_ms": pct(lat, 95),
                                  "requests": len(lat)}
        finally:
            if "process_frames" in vars(engine):
                del engine.process_frames
            stop_server(server, httpd, thread)
    for mode, r in requests.items():
        print(f"[serve] raw rgb24 x1, {r['requests']} requests, the step {mode}: p50 "
              f"{r['p50_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms")
    print("[graph] /reload_gallery, then one request: one capture, printed")
    res["requests"] = requests

    captures = []
    pools = {}
    for label, eng in (("serving", engine), ("embed_budget=4", budget), ("i420", i420),
                       ("quantize=int8", int8_engine)):
        captures += eng._graphs.captures if eng._graphs is not None else []
        pools[label] = pool_total_bytes(eng)
    res["captures"] = {
        "count": len(captures),
        "pool_bytes": [c["pool_bytes"] for c in captures],
        "seconds": [round(c["seconds"], 3) for c in captures],
        "pool_total_bytes": pools,
    }
    for c in captures:
        print(f"[graph] capture: {c['key']}: {c['seconds']:.2f} s, "
              f"{c['pool_bytes'] / 2**20:.1f} MiB reserved for the engine's pool")
    print(f"[graph] each engine's pool now holds (MiB): "
          f"{ {k: None if b is None else round(b / 2**20, 1) for k, b in pools.items()} } "
          f"(the graphs of its newest gallery)")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[graph] phase 13 took {res['seconds']:.1f} s")
    report["graph"] = res


OPENSET_ARCH = "ir_18"  # phase 14: the open-set path at a small scale
OPENSET_IDS, OPENSET_PER_ID = 40, 16
OPENSET_STEPS, OPENSET_BATCH, OPENSET_WARMUP = 200, 128, 15
OPENSET_CONDITIONS = ("clean", "noise")
OPENSET_SERVE_STEPS = 4
# the recorded recipes (pretrained/ir_{50,18}_synthetic.meta.json), run by
# --openset-only at full scale
OPENSET_RECIPES = {
    "ir_50": dict(n_ids=360, per_id=72, steps=4500, batch=256, lr=0.1, warmup=300, seed=0),
    "ir_18": dict(n_ids=360, per_id=72, steps=6000, batch=256, lr=0.1, warmup=300, seed=0),
}
JAX_OPENSET_REPORT = os.path.join(REPO, "reports", "openset_ir_50", "report.json")


def openset_counters():
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, nms_kernel, warp_kernel

    return {"crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
            "nms_fixpoint": nms_kernel.LAUNCHES}


def check_openset_report(rep: dict, conditions) -> None:
    """The report's keys are the JAX report's for the conditions run, and
    every number in it is finite."""
    import numpy as np

    with open(JAX_OPENSET_REPORT) as f:
        want = json.load(f)
    if list(rep) != list(want) or rep["protocol"] != want["protocol"]:
        fail(f"open-set report keys {list(rep)} / protocol {rep['protocol']} are not the "
             f"JAX report's")
    if list(rep["int8_drift_cosine"]) != list(want["int8_drift_cosine"]):
        fail(f"int8_drift_cosine keys {list(rep['int8_drift_cosine'])}")
    values = list(rep["int8_drift_cosine"].values())
    for tier in ("fp32", "int8"):
        if list(rep[tier]) != list(conditions):
            fail(f"open-set report {tier}: conditions {list(rep[tier])}")
        for cond in conditions:
            if list(rep[tier][cond]) != list(want[tier][cond]):
                fail(f"open-set report {tier} {cond}: keys {list(rep[tier][cond])}")
            values += list(rep[tier][cond].values())
    if not np.isfinite(values).all():
        fail("the open-set report holds a non-finite number")


def openset_serving(res, fixture, npz: str, arch: str) -> None:
    """The trained weights in FaceEmbedder (bf16, folded) and in the fused
    serving step at phase 3's build through its CUDA graphs (K1 x3, K2 x1,
    K5 x3 per step), then e2e_rank1 over 24 trials with them."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.evalharness import e2e_accuracy as E
    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    embedder = FaceEmbedder(arch, model_path=npz, dtype=torch.bfloat16, device=DEVICE)
    if not embedder.folded:
        fail("the trained weights did not load folded")
    detector = MTCNNDetector(det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES,
                             min_face_size=40, dtype=torch.bfloat16, device=DEVICE,
                             weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"))
    engine = RecognitionEngine(detector, embedder, top_k=3)
    gallery = DeviceGallery(device=DEVICE)
    g = np.random.default_rng(0).normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)],
                    g / np.linalg.norm(g, axis=1, keepdims=True))
    frames = torch.from_numpy(mosaics(fixture, BATCH)[0]).to(DEVICE)
    t, v, _ = gallery.device_snapshot()
    engine.process_frames(frames, t, v)  # captures this key's graph
    counters = openset_counters()
    before = {k: c.count for k, c in counters.items()}
    out, ms = timed_steps(engine, frames, t, v, OPENSET_SERVE_STEPS)
    per_step = {k: (c.count - before[k]) / OPENSET_SERVE_STEPS for k, c in counters.items()}
    if per_step != {"crop_resize": 3, "warp_patches": 1, "nms_fixpoint": 3}:
        fail(f"the serving step with the trained {arch} launched {per_step} per step")
    for key in ("bboxes", "embeddings", "match_scores", "embedding_norms"):
        if not torch.isfinite(out[key]).all():
            fail(f"the serving step with the trained {arch} gave non-finite {key}")
    del engine, detector
    t0 = time.perf_counter()
    e2e = E.e2e_rank1(embedder, E.make_processor(
        os.path.join(REPO, "pretrained", "mtcnn_dr.npz"), dtype=torch.bfloat16, device=DEVICE),
        E.identities(), device=DEVICE)
    res["serving"] = {"launches_per_step": per_step, "step_p50_ms": ms[len(ms) // 2],
                      "faces": int(out["face_valid"].sum()), "e2e_rank1": e2e["e2e_rank1"],
                      "e2e_rank1_n": e2e["e2e_rank1_n"],
                      "e2e_seconds": time.perf_counter() - t0}
    print(f"[openset] the trained {arch} served (FaceEmbedder bf16 folded, B={BATCH}, "
          f"{DET_SIZE[0]}x{DET_SIZE[1]}, {GALLERY_ROWS}-row gallery, graph replays): "
          f"{res['serving']['faces']} faces, finite outputs, p50 {ms[len(ms) // 2]:.2f} ms, "
          f"launches per step {per_step}; e2e_rank1 {e2e['e2e_rank1']} over "
          f"n={e2e['e2e_rank1_n']} trials (no floor)")


def openset_train(res, arch: str, npz: str, **recipe) -> None:
    """train_open_set on the card: finite losses, falling; the held-out
    probe once on the final state."""
    import numpy as np

    import torch

    from facerecognitionpipeline_tpu_torch.train import open_set as T

    t0 = time.perf_counter()
    trainer, state, meta, losses = T.train_open_set(arch, out=npz, device=DEVICE, **recipe)
    train_s = time.perf_counter() - t0
    if not np.isfinite(losses).all() or len(losses) != recipe["steps"]:
        fail(f"train_open_set gave {len(losses)} losses, finite: {np.isfinite(losses).all()}")
    if not losses[-1] < losses[9]:
        fail(f"train_open_set: loss at step {len(losses)} {losses[-1]} not below step 10's "
             f"{losses[9]}")
    t0 = time.perf_counter()
    images, labels = T.holdout_probe_sets()
    sep = T.holdout_separation(T.embed_for_probe(trainer, state, images), labels)
    probe_s = time.perf_counter() - t0
    if not np.isfinite(list(sep.values())).all():
        fail(f"held-out probe: {sep}")
    res["train"] = {"seconds": train_s, "train_seconds": meta["train_seconds"],
                    "s_per_step": meta["train_seconds"] / recipe["steps"],
                    "loss_step10": losses[9], "loss_last": losses[-1],
                    "history": meta["holdout_probe_history"], "final_probe": sep,
                    "probe_seconds": probe_s}
    print(f"[openset] train_open_set {arch}, {recipe['n_ids']} ids x {recipe['per_id']} crops, "
          f"{recipe['steps']} steps at B={recipe['batch']} bf16 in {train_s:.1f} s "
          f"({meta['train_seconds']:.1f} s from the first step, "
          f"{1e3 * res['train']['s_per_step']:.1f} ms per step): loss step 10 "
          f"{losses[9]:.4f} -> step {recipe['steps']} {losses[-1]:.4f}; held-out probe on "
          f"the final state: genuine {sep['genuine_mean']:.3f} impostor "
          f"{sep['impostor_mean']:.3f} EER {sep['eer']:.4f} ({probe_s:.1f} s)")
    del trainer, state
    torch.cuda.empty_cache()


def openset_phase(fixture, report) -> None:
    """Phase 14 (see the module docstring): the open-set path at a small
    scale."""
    import shutil

    from facerecognitionpipeline_tpu_torch.evalharness import open_set as O

    t_phase = time.perf_counter()
    res: dict = {}
    counters = openset_counters()
    for c in counters.values():
        c.reset()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_openset_")
    try:
        npz = os.path.join(tmp, f"{OPENSET_ARCH}_synthetic_torch.npz")
        openset_train(res, OPENSET_ARCH, npz, n_ids=OPENSET_IDS, per_id=OPENSET_PER_ID,
                      steps=OPENSET_STEPS, batch=OPENSET_BATCH, lr=0.1, warmup=OPENSET_WARMUP,
                      seed=0)
        t0 = time.perf_counter()
        rep = O.run_open_set(OPENSET_ARCH, npz, OPENSET_CONDITIONS, False, device=DEVICE)
        res["protocol_seconds"] = time.perf_counter() - t0
        check_openset_report(rep, OPENSET_CONDITIONS)
        res["report"] = {t: rep[t] for t in ("fp32", "int8", "int8_drift_cosine")}
        print(f"[openset] run_open_set ({O.N_GALLERY} + {O.N_UNKNOWN} identities, "
              f"{', '.join(OPENSET_CONDITIONS)}, fp32 and int8) in "
              f"{res['protocol_seconds']:.1f} s: keys are the JAX report's, every value "
              f"finite; " + "; ".join(
                  f"{t} {c} rank1 {rep[t][c]['rank1']} EER {rep[t][c]['eer']}"
                  for t in ("fp32", "int8") for c in OPENSET_CONDITIONS)
              + f"; drift cosine {rep['int8_drift_cosine']}")
        t0 = time.perf_counter()
        openset_serving(res, fixture, npz, OPENSET_ARCH)
        res["serving_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["e2e_rank1_ir_micro"] = report.get("train", {}).get("e2e", {}).get("e2e_rank1")
    res["launches"] = {k: c.count for k, c in counters.items()}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[openset] e2e_rank1 with the {OPENSET_ARCH} trained here "
          f"{res['serving']['e2e_rank1']} beside phase 11's ir_micro "
          f"{res['e2e_rank1_ir_micro']}; stages: train {res['train']['seconds']:.1f} s, "
          f"protocol {res['protocol_seconds']:.1f} s, serving {res['serving_seconds']:.1f} s; "
          f"phase 14 took {res['seconds']:.1f} s; launches {res['launches']}")
    report["openset"] = res


def openset_full(fixture, arch: str) -> dict:
    """--openset-only: the recorded recipe of `arch` on the card, the whole
    protocol (six conditions, fp32 and int8) into
    reports/openset_torch_<arch>/report.json, its numbers beside the JAX
    report's (tests/test_torch_port_open_set.py gates the report with the
    floors), then the trained weights served."""
    from facerecognitionpipeline_tpu_torch.evalharness import open_set as O

    res: dict = {}
    npz = os.path.join(REPO, "pretrained", f"{arch}_synthetic_torch.npz")
    openset_train(res, arch, npz, **OPENSET_RECIPES[arch])
    t0 = time.perf_counter()
    rep = O.run_open_set(arch, os.path.relpath(npz), O.CONDITIONS, False, device=DEVICE)
    res["protocol_seconds"] = time.perf_counter() - t0
    check_openset_report(rep, O.CONDITIONS)
    out = O.write_report(rep, os.path.join(REPO, "reports", f"openset_torch_{arch}"))
    path = os.path.join(REPO, "reports", f"openset_{arch}", "report.json")
    with open(path) as f:
        jax_rep = json.load(f)
    print(f"[openset] {arch}: the port on this card beside the JAX package's report "
          f"({os.path.relpath(path, REPO)}, taken on a TPU): port / JAX")
    for tier in ("fp32", "int8"):
        for cond in O.CONDITIONS:
            p, j = rep[tier][cond], jax_rep[tier][cond]
            print(f"[openset] {tier} {cond:9s} " + "  ".join(
                f"{k} {p[k]} / {j[k]}" for k in ("rank1", "rank5", "eer", "tar_at_far_0.01",
                                                   "dir_at_far_0.01", "dprime", "roc_auc")))
    print(f"[openset] int8 drift cosine {rep['int8_drift_cosine']} / "
          f"{jax_rep['int8_drift_cosine']}")
    openset_serving(res, fixture, npz, arch)
    res["report"] = os.path.relpath(out, REPO)
    return res


DETECTOR_STEPS = 50  # phase 15: each recipe's three nets, 50 steps each
DETECTOR_SCENES = 12  # scenes per category of the base rows (the reports' 12)
DETECTOR_SERVE_STEPS = 4
DETECTOR_ONLY = ("stress", "ood", "all")  # what --detector-only takes
# a base row's largest distance to the JAX report's: 0.03 in AP and recall,
# 3 false positives in 12 scenes
DETECTOR_TOL = {"ap": 0.03, "recall": 0.03, "fp_per_image": 0.25}
# The base categories where the JAX report, taken on a TPU, is farther than
# DETECTOR_TOL from the JAX package's float32 cascade on the CPU (its
# matmul precision): there the port is held to the CPU's row, which
# tests/test_torch_port_detector_reports.py recomputes with the JAX package.
JAX_CPU_BASE = {
    ("ood", "facegen+jpeg"): {"ap": 0.15942028985507245, "recall": 0.17391304347826086,
                              "fp_per_image": 0.25},
}
JAX_DETECTOR_REPORTS = {
    "stress": os.path.join(REPO, "reports", "detector_stress", "report.json"),
    "ood": os.path.join(REPO, "reports", "detector_ood", "report.json"),
}


def detector_recipe(res, recipe) -> dict:
    """train_recipe on the card, its three nets in three processes: each
    net's losses finite and falling (the mean of the last 10 below the first
    10's at 50 steps, of 20 in a full recipe). Returns the variables."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.train.detector_recipes import train_recipe

    history: dict = {}
    seconds: dict = {}
    t0 = time.perf_counter()
    variables = train_recipe(recipe, device=DEVICE, log_every=recipe.steps,
                             history=history, seconds=seconds)
    total = time.perf_counter() - t0
    rows = {}
    for net, losses in history.items():
        n = min(20, len(losses) // 5)
        first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
        rows[net] = {"first": first, "last": last, "seconds": seconds[net]}
        if len(losses) != recipe.steps or not np.isfinite(losses).all() or not last < first:
            fail(f"train_recipe {recipe.name} {net}: {len(losses)} losses, first {n} {first}, "
                 f"last {n} {last}")
    res[f"train_{recipe.name}"] = {"steps": recipe.steps, "seconds": total, "nets": rows}
    print(f"[detector] train_recipe({recipe.name}, {recipe.steps} steps a net, batch "
          f"{recipe.batch}, OHEM {recipe.ohem_fraction}, class balance "
          f"{recipe.class_balance}) in 3 processes, os.cpu_count() {os.cpu_count()}: "
          f"{total:.1f} s; " + "; ".join(
              f"{net} {r['seconds']:.1f} s, loss {r['first']:.4f} -> {r['last']:.4f}"
              for net, r in rows.items()))
    return variables


def same_faces(a, b) -> bool:
    """Two detect() lists with equal boxes and scores, face for face."""
    return len(a) == len(b) and all(
        (x["bbox"] == y["bbox"]).all() and x["det_score"] == y["det_score"]
        for x, y in zip(a, b))


def detector_setter(res, variables) -> None:
    """The repaired setter on the card: a detector built on
    mtcnn_synthetic.npz, then given `variables` by assignment, detects as
    one built with `variables=`."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.evalharness.detection import render_stress_scene
    from facerecognitionpipeline_tpu_torch.evalharness.detector_reports import make_detector

    rng = np.random.default_rng(0)
    scenes = [render_stress_scene(rng, "baseline", size=320)[0] for _ in range(3)]
    det = make_detector(os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz"), device=DEVICE)
    before = [det.detect(s) for s in scenes]
    det.variables = variables
    after = [det.detect(s) for s in scenes]
    want = [make_detector(variables=variables, device=DEVICE).detect(s) for s in scenes]
    if not all(same_faces(a, w) for a, w in zip(after, want)):
        fail("a detector given the trained variables by assignment detects otherwise than one "
             "built with variables=")
    changed = sum(not same_faces(b, a) for b, a in zip(before, after))
    res["setter"] = {"scenes": len(scenes), "changed_by_assignment": changed}
    print(f"[detector] MTCNNDetector.variables = the trained tree on the card: detections "
          f"equal to variables= on {len(scenes)} scenes, {changed} of them changed by the "
          f"assignment")


def detector_rows(tag, got: dict, want: dict, report: str = "") -> dict:
    """Print each category of a report row's summary beside the JAX
    report's row (`want`: the row); given `report` (stress or ood), fail
    where a category is farther than DETECTOR_TOL from it, or from JAX on
    the CPU where JAX_CPU_BASE holds the category. Returns the largest
    distances from the JAX report."""
    worst = {k: 0.0 for k in DETECTOR_TOL}
    for cat, w in want["summary"].items():
        g = got[cat]
        ref = JAX_CPU_BASE.get((report, cat), w)
        for key, tol in DETECTOR_TOL.items():
            if (g[key] is None) != (w[key] is None):
                fail(f"{tag} {cat}: {key} {g[key]} against the JAX report's {w[key]}")
            if w[key] is not None:
                worst[key] = max(worst[key], abs(g[key] - w[key]))
                if report and abs(g[key] - ref[key]) > tol + 1e-9:
                    fail(f"{tag} {cat}: {key} {g[key]} against "
                         f"{'the JAX report' if ref is w else 'JAX on the CPU'}'s "
                         f"{ref[key]}, more than {tol} apart")
        print(f"[detector] {tag} {cat:20s} " + "  ".join(
            f"{k} {g[k] if g[k] is None else round(g[k], 4)} / "
            f"{w[k] if w[k] is None else round(w[k], 4)}"
            for k in ("ap", "recall", "precision", "fp_per_image"))
            + ("" if ref is w else "  (held to JAX on the CPU: " + ", ".join(
                f"{k} {round(v, 4)}" for k, v in ref.items()) + ")"))
    return worst


def counted_suite(tag, run, n_detects: int, k1_per_detect: int = 0) -> tuple:
    """run() -> (its result, seconds), holding K5's launches to 3 per
    detect and K1's to k1_per_detect (counted from 0 around it)."""
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, nms_kernel

    k1, k5 = crop_kernel.LAUNCHES.count, nms_kernel.LAUNCHES.count
    t0 = time.perf_counter()
    out = run()
    secs = time.perf_counter() - t0
    k1, k5 = crop_kernel.LAUNCHES.count - k1, nms_kernel.LAUNCHES.count - k5
    if k5 != 3 * n_detects or k1 != k1_per_detect * n_detects:
        fail(f"{tag}: K5 launched {k5} and K1 {k1} times for {n_detects} detects")
    return out, secs


def detector_base_rows(res, n_scenes: int) -> None:
    """The base rows of both reports on the card (float32 cascades of the
    JAX reports' base weights), beside the JAX reports' rows."""
    from facerecognitionpipeline_tpu_torch.evalharness.detection import (
        STRESS_CATEGORIES,
        run_stress_suite,
    )
    from facerecognitionpipeline_tpu_torch.evalharness.detection_ood import (
        OOD_CATEGORIES,
        run_ood_suite,
    )
    from facerecognitionpipeline_tpu_torch.evalharness.detector_reports import make_detector

    for name, suite, cats in (("stress", run_stress_suite, STRESS_CATEGORIES),
                              ("ood", run_ood_suite, OOD_CATEGORIES)):
        with open(JAX_DETECTOR_REPORTS[name]) as f:
            want = json.load(f)["base"]
        det = make_detector(os.path.join(REPO, want["weights"]), device=DEVICE)
        rep, secs = counted_suite(f"{name} base", lambda: suite(det, n_scenes=n_scenes, seed=0),
                                  n_scenes * len(cats))
        worst = detector_rows(f"{name} base ({want['weights']}, {n_scenes} scenes)",
                              rep["summary"], want, report=name if n_scenes == 12 else "")
        res[f"{name}_base"] = {"seconds": secs, "worst": worst, "summary": rep["summary"]}
        print(f"[detector] {name} base row on the card in {secs:.1f} s "
              f"({n_scenes * len(cats)} detects, K5 x3 each); farthest from the JAX report: "
              f"{worst}")


def detector_serving(res, fixture, variables, label: str, floor) -> None:
    """The cascade `variables` at phase 3's build through its CUDA graphs:
    an engine on the shipped mtcnn_dr.npz captures its graph; then the
    detector is given `variables` by assignment and the same graph replays
    (no new capture) with K1 x3, K2 x1 and K5 x3 per step, equal to the
    eager step of the engine bit for bit; recall on the smoke fixture
    beside the shipped cascade's, at least `floor` where one is given."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    detector = MTCNNDetector(det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES,
                             min_face_size=40, dtype=torch.bfloat16, device=DEVICE,
                             weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"))
    embedder = FaceEmbedder(ARCH, dtype=torch.bfloat16, random_ok=True, init_seed=0,
                            device=DEVICE)
    engine = RecognitionEngine(detector, embedder, top_k=3)
    gallery = DeviceGallery(device=DEVICE)
    g = np.random.default_rng(0).normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)],
                    g / np.linalg.norm(g, axis=1, keepdims=True))
    frames_np, gts = mosaics(fixture, BATCH)
    frames = torch.from_numpy(frames_np).to(DEVICE)
    t, v, _ = gallery.device_snapshot()
    shipped = engine.process_frames(frames, t, v)  # captures this key's graph
    shipped_recall = detection_recall(shipped, gts)[0]
    captures = len(engine._graphs.captures)
    detector.variables = variables
    counters = openset_counters()
    before = {k: c.count for k, c in counters.items()}
    out, ms = timed_steps(engine, frames, t, v, DETECTOR_SERVE_STEPS)
    per_step = {k: (c.count - before[k]) / DETECTOR_SERVE_STEPS for k, c in counters.items()}
    if per_step != {"crop_resize": 3, "warp_patches": 1, "nms_fixpoint": 3}:
        fail(f"the serving step with {label} launched {per_step} per step")
    if len(engine._graphs.captures) != captures:
        fail(f"assigning {label} to the detector made the engine capture a new graph")
    diff = tree_diff(out, engine.step(t, v, frames, engine.top_k))
    if diff:
        fail(f"the replayed graph with {label} assigned differs from the eager step: {diff}")
    if not tree_diff(out, shipped):
        fail(f"the replayed graph with {label} assigned still computes the shipped cascade")
    recall, hits, faces = detection_recall(out, gts)
    if floor is not None and recall < floor:
        fail(f"{label} served: recall {recall} below {floor}")
    res["serving"] = {"launches_per_step": per_step, "step_p50_ms": ms[len(ms) // 2],
                      "recall": recall, "shipped_recall": shipped_recall}
    print(f"[detector] {label} served at phase 3's build (B={BATCH}, {DET_SIZE[0]}x"
          f"{DET_SIZE[1]}, bf16) by assignment into a captured engine: the same graph "
          f"replayed, equal to the eager step, launches per step {per_step}, p50 "
          f"{ms[len(ms) // 2]:.2f} ms; recall {recall:.4f} ({hits}/{faces}) beside the "
          f"shipped mtcnn_dr.npz's {shipped_recall:.4f} in this run"
          + ("" if floor is None else f" (floor {floor})"))
    del engine, detector, embedder
    torch.cuda.empty_cache()


def detector_phase(fixture, report) -> None:
    """Phase 15 (see the module docstring): the detector's training
    protocol at a small scale. The two recipes train at once (six worker
    processes)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from facerecognitionpipeline_tpu_torch.train.detector_recipes import (
        DR_RECIPE,
        STRESS_RECIPE,
    )

    t_phase = time.perf_counter()
    res: dict = {}
    counters = openset_counters()
    for c in counters.values():
        c.reset()
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(detector_recipe, res, dataclasses.replace(r, steps=DETECTOR_STEPS))
                for r in (STRESS_RECIPE, DR_RECIPE)]
        variables = [run.result() for run in runs][1]
    res["train_seconds"] = time.perf_counter() - t_phase
    detector_setter(res, variables)
    detector_base_rows(res, DETECTOR_SCENES)
    detector_serving(res, fixture, variables, f"the {DETECTOR_STEPS}-step DR cascade", None)
    res["launches"] = {k: c.count for k, c in counters.items()}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[detector] phase 15 took {res['seconds']:.1f} s; launches {res['launches']}")
    report["detector"] = res


def detector_full(fixture, which: str) -> dict:
    """--detector-only: the recorded recipes on the card through
    train_recipe, the reports into reports/detector_{stress,ood}_torch/ and
    the weights into pretrained/mtcnn_{stress,dr}_torch.npz (+ .meta.json),
    every row beside the JAX report's (tests/test_torch_port_detector_
    reports.py gates the reports with the floors); the stress suite through
    a bf16 cascade (K1 twice per detect) of the last weights trained, and
    those weights served."""
    import torch

    from facerecognitionpipeline_tpu_torch.evalharness import detector_reports as D
    from facerecognitionpipeline_tpu_torch.evalharness.detection import (
        STRESS_CATEGORIES,
        run_stress_suite,
    )
    from facerecognitionpipeline_tpu_torch.evalharness.detection_ood import OOD_CATEGORIES
    from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

    t_start = time.perf_counter()
    res: dict = {}
    counters = openset_counters()
    for c in counters.values():
        c.reset()
    n_stress, n_ood = 12 * len(STRESS_CATEGORIES), 12 * len(OOD_CATEGORIES)
    runs = []
    if which in ("stress", "all"):
        runs.append(("stress", D.STRESS_REPORT_DIR, D.STRESS_WEIGHTS, "stress_retrained",
                     lambda: D.run_stress_report(
                         os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz"), True,
                         device=DEVICE), 2 * n_stress))
    if which in ("ood", "all"):
        # the JAX report's base row is of mtcnn_stress.npz (discover_default_
        # weights() now finds mtcnn_dr.npz first)
        runs.append(("ood", D.OOD_REPORT_DIR, D.DR_WEIGHTS, "dr_retrained_stress",
                     lambda: D.run_ood_report(
                         os.path.join(REPO, "pretrained", "mtcnn_stress.npz"), True,
                         device=DEVICE), 2 * n_ood + n_stress))
    for name, out_dir, weights, stress_row, run, n_detects in runs:
        rep, secs = counted_suite(f"the {name} report", run, n_detects)
        path = D.write_report(rep, out_dir)
        with open(weights.replace(".npz", ".meta.json")) as f:
            meta = json.load(f)
        with open(JAX_DETECTOR_REPORTS[name]) as f:
            want = json.load(f)
        print(f"[detector] {name}: {os.path.relpath(path, REPO)} in {secs:.1f} s "
              f"(training {meta['train_seconds']:.1f} s: " + ", ".join(
                  f"{k} {s:.1f} s" for k, s in meta["seconds_per_net"].items())
              + f"; os.cpu_count() {meta['cpu_count']}); port on this card / JAX report "
              f"({os.path.relpath(JAX_DETECTOR_REPORTS[name], REPO)}, taken on a TPU)")
        for row in rep:
            detector_rows(f"{name} {row}", rep[row]["summary"], want[row],
                          report=name if row == "base" else "")
        res[name] = {"report": os.path.relpath(path, REPO), "seconds": secs,
                     "train_seconds": meta["train_seconds"],
                     "seconds_per_net": meta["seconds_per_net"],
                     "summary": {row: rep[row]["summary"] for row in rep}}
        last = (weights, rep[stress_row])
    weights, f32_row = last
    label = os.path.relpath(weights, REPO)
    det = D.make_detector(weights, device=DEVICE, dtype=torch.bfloat16, crop_impl="kernel")
    rep, secs = counted_suite(f"the bf16 stress suite on {label}",
                              lambda: run_stress_suite(det, n_scenes=12, seed=0), n_stress,
                              k1_per_detect=2)
    print(f"[detector] the stress suite through a bf16 cascade (K1) on {label} in "
          f"{secs:.1f} s, K1 x2 and K5 x3 per detect: bf16 / float32")
    res["bf16_stress"] = {"weights": label, "seconds": secs,
                          "worst": detector_rows("bf16", rep["summary"], f32_row),
                          "summary": rep["summary"]}
    detector_serving(res, fixture, load_npz_variables(weights), label, 0.8)
    res["launches"] = {k: c.count for k, c in counters.items()}
    res["seconds"] = time.perf_counter() - t_start
    print(f"[detector] --detector-only {which} took {res['seconds']:.1f} s after the build; "
          f"launches {res['launches']}")
    return res


# ------------------------------------------------------------ phase 16

SOAK_ONLY = ("example", "deployment", "all")  # what --soak-only takes
SOAK_GALLERY_ROWS = 1 << 16  # int8 rows (compact from 32 768): K4 once per step
# phase 16 (the default run) and --soak-only deployment: clients, frames in
# all, --max_requests, RSS sampled every so many answers
SOAK_PHASE = {"clients": 1, "frames": 60, "max_requests": 24, "sample_every": 4}
SOAK_DEPLOYMENT = {"clients": 2, "frames": 1200, "max_requests": 400, "sample_every": 10}
SOAK_DIRECT_STEPS = 3
SOAK_REPORT = os.path.join(REPO, "reports", "serving_recycle_soak_torch.json")


def soak_argv(gallery_path: str) -> list:
    """Phase 3's server build as CLI flags (bf16, 640x640 and buckets
    (1, batch_max) are the CLI's defaults; ir_101 seeded by init_seed 0),
    I420 transport and the gallery stored int8."""
    return ["--gallery_path", gallery_path, "--architecture", ARCH,
            "--max_faces", str(MAX_FACES), "--batch_max", str(BATCH), "--transport", "i420",
            "--gallery_quantize", "int8", "--threshold", str(SERVER_THRESHOLD),
            "--detector_weights", os.path.join(REPO, "pretrained", "mtcnn_dr.npz")]


def print_soak(tag: str, rep: dict) -> None:
    """One line per worker process, then the process and card figures.
    Growth per request is the least over a generation's intervals between
    samples (`soak.check_soak`)."""
    half_kib = rep["payload_bytes"] / 2 / 1024
    gens = {g["pid"]: g for g in rep["generations"]}

    def sec(x):
        return "n/a" if x is None else f"{x:.2f} s"

    for i, w in enumerate(rep["workers"], 1):
        g = gens.get(w["pid"])
        line = (f"[soak {tag}] worker {i} (pid {w['pid']}): started {sec(w['seen_s'])} after "
                f"the supervisor, first answer {sec(w['start_s'])} after its start, "
                f"{w['requests']} requests, p50 "
                + ("n/a" if w["request_p50_ms"] is None else f"{w['request_p50_ms']:.2f} ms")
                + f"; downtime before it {sec(w['downtime_s'])}, its drain "
                f"{sec(w['drain_s'])}, gone {sec(w['gone_s'])} after the supervisor's start; "
                f"its own launches {w['launches']} in {w['steps']} steps")
        if g is not None:
            growth = g.get("growth_per_request_mb")
            line += (f"; RSS {g['rss_first_mb']} -> {g['rss_last_mb']} MB over "
                     f"{g['n_samples']} samples ("
                     + ("not measured" if growth is None else f"{growth * 1024:.1f} KiB a request")
                     + f", bound {half_kib:.1f}); /stats device {g['gpu_vram_first_mb']} -> "
                     f"{g['gpu_vram_last_mb']} MB")
        print(line)
    from facerecognitionpipeline_tpu_torch.serve import soak

    workers = rep["workers"]
    probes = [w["probe"] for w in workers if w["probe"]]
    print(f"[soak {tag}] samples (answers, pid, RSS MB, /stats device MB): "
          f"{[(x['frame'], x['pid'], x['rss_mb'], x['gpu_vram_mb']) for x in rep['samples']]}")
    print(f"[soak {tag}] {rep['answered']} answers from {rep['clients']} client process(es) "
          f"(torch imported there: {rep['clients_imported_torch']}), --max_requests "
          f"{rep['max_requests']}, {len(workers)} workers, payload {rep['payload_bytes']} B; "
          f"session.json frames {rep['statistics']['total_frames_processed']}, faces "
          f"{rep['statistics']['total_faces_detected']} (answers' {rep['faces_answered']}); "
          f"supervisor returned {rep['supervisor_rc']} after SIGTERM, no worker left")
    if "card" not in rep:
        return
    print(f"[soak {tag}] card memory.used {rep['card_used_mb_before']} MiB before the "
          f"supervisor, {rep['card_used_mb_after']} after it exited ("
          f"{rep['card_release_s']:.2f} s after SIGTERM); at each generation's first sample "
          f"{[p['card_used_mb'] for p in probes]}; the supervisor's device files "
          f"{[p['supervisor_device_files'] for p in probes]}; nvidia-smi compute apps "
          f"{[p['compute_apps'] for p in probes]} ("
          + ("worker pids visible" if soak.pids_visible(rep) else
             "the container hides pids: no listed pid is a worker's")
          + f"); {rep['card']}")


def soak_deployment(fixture, clients: int, frames: int, max_requests: int,
                    sample_every: int) -> dict:
    """The deployment soak (see the module docstring): the build in this
    process from the same flags, the fixture's students enrolled among
    seeded ids to SOAK_GALLERY_ROWS int8 rows, the direct step's launches
    counted, then the supervised CLI; every answer held to the direct step,
    every worker's launches to the direct step's per step. Returns the
    soak's report with "direct_launches", "worker_launches" (summed over
    the workers), "worker_steps", "enrolled" and "failures" (the bounds of
    soak.check_soak it missed, judged by the caller after it has written
    the report)."""
    import gc

    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.serve import rawproto, soak
    from facerecognitionpipeline_tpu_torch.serve import server as tserver

    tmp = tempfile.mkdtemp(prefix="soak_deployment_")
    gallery_path = os.path.join(tmp, "students.pkl")
    argv = soak_argv(gallery_path)
    t0 = time.perf_counter()
    server = tserver.build_server(tserver.build_parser().parse_args(argv + ["--device", DEVICE]))
    build_s = time.perf_counter() - t0
    canvas = rawproto.rgb_to_i420(mosaics(fixture, 1)[0][0])  # 640x640 letterboxes to itself
    strong = [f for f in direct_faces(server, canvas) if f["det"] > 0.7]
    if len(strong) < 8:
        fail(f"soak: only {len(strong)} faces of the direct step pass the gate")
    rng = np.random.default_rng(16)
    others = rng.normal(size=(SOAK_GALLERY_ROWS - len(strong[::2]), 512)).astype(np.float32)
    others /= np.linalg.norm(others, axis=1, keepdims=True)
    now = "2026-01-01T00:00:00"
    writer = GalleryManager(gallery_path, verbose=False, device="cpu")
    writer.students = {
        f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", others[i:i + 1], others[i], 1, now, now)
        for i in range(len(others))
    }
    enrolled = set()
    for j, f in enumerate(strong[::2]):
        writer.add_student(f"face{j:02d}", f"Face {j}", np.repeat(f["emb"][None], 2, axis=0))
        enrolled.add(f"face{j:02d}")
    writer.save()
    del writer, others
    reloaded = server.reload_gallery()
    t, _, ids = server.gallery.device_snapshot()
    if reloaded.get("status") != "reloaded" or len(ids) != SOAK_GALLERY_ROWS or \
            not (isinstance(t, tuple) and t[0].dtype == torch.int8):
        fail(f"soak: the reloaded gallery is not {SOAK_GALLERY_ROWS} int8 rows ({reloaded})")
    del t, ids
    server.batcher.warmup(DET_SIZE)  # this gallery's graphs, captured before the counts
    at = tserver.launch_counts()
    for _ in range(SOAK_DIRECT_STEPS):
        faces = direct_faces(server, canvas)
    launches = {k: c - at[k] for k, c in tserver.launch_counts().items()}
    n = SOAK_DIRECT_STEPS
    want = {"crop_resize": 3 * n, "warp_patches": n, "gallery_topk": 0,
            "gallery_topk_int8": n, "gallery_topk_f32": 0, "nms_fixpoint": 3 * n}
    if launches != want:
        fail(f"soak: {n} direct steps launched {launches}, want {want}")
    own = {f["top1"] for f in faces if f["score"] > 0.98}
    sure, maybe = expected_students(faces)
    if not enrolled <= own or not enrolled <= sure | maybe:
        fail(f"soak: enrolled {sorted(enrolled)}, own top-1 {sorted(own & enrolled)}, "
             f"expected from the direct step {sorted(sure)} (+ maybe {sorted(maybe)})")
    print(f"[soak deployment] the build in this process from the CLI's flags in "
          f"{build_s:.1f} s; {len(enrolled)} fixture faces enrolled among "
          f"{SOAK_GALLERY_ROWS} int8 rows; {n} direct steps launched {launches} (K1 x3, K2 "
          f"x1, K4 x1, K5 x3 a step)")
    server.shutdown()
    del server
    gc.collect()
    torch.cuda.empty_cache()

    request = {"path": "/process_frame_raw", "data": canvas.tobytes(), "headers": {
        "Content-Type": "application/octet-stream", rawproto.HEADER_FORMAT: "i420",
        rawproto.HEADER_WIDTH: str(DET_SIZE[1]), rawproto.HEADER_HEIGHT: str(DET_SIZE[0]),
        rawproto.HEADER_SCALE: "1.0"}}
    try:
        rep = soak.run_recycle_soak(argv, request, frames, max_requests, clients=clients,
                                    sample_every=sample_every, device=DEVICE,
                                    workdir=os.path.join(tmp, "soak"))
    except soak.SoakError as e:
        fail(f"soak deployment: {e}")
    rep["failures"] = soak.check_soak(rep)
    rep["direct_launches"] = launches
    rep["enrolled"] = sorted(enrolled)
    print_soak("deployment", rep)
    # each worker's own launches (its line in the supervisor's log): the
    # direct step's per step times the steps it dispatched
    serving = [w for w in rep["workers"] if w["requests"]]
    for w in serving:
        if w["steps"] is None:
            fail(f"soak: worker {w['pid']} printed no launch line")
        want = {k: v // n * w["steps"] for k, v in launches.items()}
        if w["launches"] != want:
            fail(f"soak: worker {w['pid']} launched {w['launches']} in {w['steps']} steps, "
                 f"want {want}")
    rep["worker_steps"] = sum(w["steps"] for w in serving)
    rep["worker_launches"] = {k: sum(w["launches"][k] for w in serving) for k in launches}
    if rep["worker_steps"] > rep["answered"] or \
            (clients == 1 and rep["worker_steps"] != rep["answered"]):
        fail(f"soak: the workers dispatched {rep['worker_steps']} steps for "
             f"{rep['answered']} requests from {clients} client(s)")
    for c, rows in enumerate(rep["answers"]):
        for j, (_, _, text) in enumerate(rows):
            body = json.loads(text)
            check_response(f"soak client {c} answer {j}", body, faces, 1.0)
            rec = {r["student_id"] for r in body["recognized_tracks"].values()}
            if not rec <= sure | maybe:
                fail(f"soak client {c} answer {j}: recognized {sorted(rec - sure - maybe)}, "
                     f"not expected from the direct step")
    listed = set(rep["attendance"])
    if not sure <= listed <= sure | maybe:
        fail(f"soak: attendance.json lists {sorted(listed)}, expected {sorted(sure)} "
             f"(+ maybe {sorted(maybe)})")
    if rep["clients_imported_torch"]:
        fail("soak: a client process imported torch")
    print(f"[soak deployment] all {rep['answered']} answers equal the direct step (faces, "
          f"boxes within 1 px, students); attendance.json after /finalize lists "
          f"{sorted(listed)} (enrolled {sorted(enrolled)}); the workers' own launches "
          f"{[(w['pid'], w['steps'], w['launches']) for w in serving]}, summed "
          f"{rep['worker_launches']} in {rep['worker_steps']} steps (the direct step's per "
          f"step in each)")
    return rep


def soak_phase(fixture, report) -> None:
    """Phase 16 (see the module docstring): the deployment soak cut to one
    client, 60 requests and --max_requests 24 (three generations)."""
    t_phase = time.perf_counter()
    rep = soak_deployment(fixture, **SOAK_PHASE)
    if rep["failures"]:
        fail("phase 16: " + "; ".join(rep["failures"]))
    res = {k: rep.get(k) for k in ("direct_launches", "worker_steps", "generations",
                                   "answered", "card_used_mb_before", "card_used_mb_after",
                                   "supervisor_rc")}
    res["launches"] = rep["worker_launches"]
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[soak] phase 16 took {res['seconds']:.1f} s; the workers' launches "
          f"{res['launches']} in {res['worker_steps']} steps")
    report["soak"] = res


def soak_full(fixture, which: str) -> dict:
    """--soak-only: the example's run (examples/recycle_soak.py's defaults)
    and/or the deployment run at full size, each written into SOAK_REPORT
    before its bounds are judged."""
    from facerecognitionpipeline_tpu_torch.serve import soak

    out = {}
    if which in ("example", "all"):
        t0 = time.perf_counter()
        try:
            rep = soak.example_soak(device=DEVICE)
        except soak.SoakError as e:
            fail(f"soak example: {e}")
        rep["failures"] = soak.check_soak(rep)
        soak.write_report(SOAK_REPORT, example=rep)
        print_soak("example", rep)
        out["example_seconds"] = time.perf_counter() - t0
        if rep["failures"]:
            fail("soak example: " + "; ".join(rep["failures"]))
    if which in ("deployment", "all"):
        t0 = time.perf_counter()
        rep = soak_deployment(fixture, **SOAK_DEPLOYMENT)
        soak.write_report(SOAK_REPORT, deployment=rep)
        out["deployment_seconds"] = time.perf_counter() - t0
        if rep["failures"]:
            fail("soak deployment: " + "; ".join(rep["failures"]))
    print(f"[soak] --soak-only {which}: {out}; report {os.path.relpath(SOAK_REPORT, REPO)}")
    return out


# ------------------------------------------------------------ phase 17

PROTOCOLS_ONLY = ("demo", "transfer", "train_profile", "all")  # what --protocols-only takes
# phase 17's cuts: the profile at ir_18 with 3 samples a variant, the int8
# probe at ir_18 converging 50 steps; --protocols-only runs the scripts' sizes
PROFILE_PHASE = {"batch": 128, "arch": "ir_18", "samples": 3}
PROBE_PHASE = {"arch": "ir_18", "converge_steps": 50}
PROFILE_FULL = {"batch": 128, "arch": "ir_101"}
PROBES_FULL = (("int8_probe.json", {"arch": "ir_18", "converge_steps": 200}),
               ("int8_probe_ir101.json", {"arch": "ir_101", "converge_steps": 100}))
# the recomposed loss against the trainer's, relative: bit for bit (bf16
# backbone, float32 head; measured equal at ir_101 and ir_18 on an H100)
LOSS_CHECK_TOL = 0.0
TRAIN_PROFILE_DIR = os.path.join(REPO, "reports", "train_profile_torch")
JAX_PROFILE_REPORT = os.path.join(REPO, "reports", "train_profile", "ir_101_b128.json")
JAX_TRANSFER_REPORT = os.path.join(REPO, "reports", "quantize_transfer", "report.json")
# the TPU report's figures (reports/synthetic_e2e/report.txt), accuracy only
JAX_DEMO = {"rank1_fp32": "20/20", "rank1_int8": "20/20", "drift_min": 0.99844,
            "drift_mean": 0.99952}
# --full-sizes: what phase 7 and phase 11 ran before the run's time limit
# cut them (a 1 048 576-id gallery file, train_detector at 100 steps)
FULL_SIZES = {"server_rows": 1 << 20, "det_steps": 100}


def protocol_counters():
    from facerecognitionpipeline_tpu_torch.ops import (
        crop_kernel,
        gallery_kernel,
        nms_kernel,
        warp_kernel,
    )

    return {"crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
            "gallery_topk": gallery_kernel.LAUNCHES,
            "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
            "gallery_topk_f32": gallery_kernel.LAUNCHES_F32,
            "nms_fixpoint": nms_kernel.LAUNCHES}


def check_demo(tag: str, rep: dict, launches: dict) -> None:
    """The demo held to the example's exit condition (rank-1 >= 0.6, fp32
    and int8), finite drift, and its kernels: the float32 cascade launches
    K5 three times a detect and nothing else (its crops are matmuls, the
    processor aligns by a gather, 16 identities match densely)."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo as D

    fp32, int8 = rep["rank1_fp32"], rep["rank1_int8"]
    drift = rep["int8_drift_cosine"]
    print(f"[protocols] {tag}: rank-1 fp32 {fp32['correct']}/{fp32['total']}, int8 "
          f"{int8['correct']}/{int8['total']}; int8 drift cosine min {drift['min']} mean "
          f"{drift['mean']} over {len(drift['values'])} probes (TPU report: "
          f"{JAX_DEMO['rank1_fp32']}, {JAX_DEMO['rank1_int8']}, {JAX_DEMO['drift_min']} / "
          f"{JAX_DEMO['drift_mean']}); {rep['detects']} detects, launches {launches}; "
          f"{rep['seconds']:.1f} s")
    for name, r in (("fp32", fp32), ("int8", int8)):
        if r["total"] < 1 or r["correct"] / r["total"] < D.FLOOR:
            fail(f"{tag}: rank-1 {name} {r['correct']}/{r['total']} below {D.FLOOR}")
    if not np.isfinite(drift["values"]).all():
        fail(f"{tag}: non-finite drift cosines")
    want = {k: 0 for k in launches}
    want["nms_fixpoint"] = 3 * rep["detects"]
    if launches != want or rep["detects"] < 1:
        fail(f"{tag}: {rep['detects']} detects of the float32 cascade launched {launches}, "
             f"not {want}")


def check_transfer(tag: str, summary: dict) -> None:
    """The sweep held to tests/test_quantize_transfer.py's bounds, each row
    printed beside the TPU report's."""
    from facerecognitionpipeline_tpu_torch.evalharness import quantize_transfer as QT

    with open(JAX_TRANSFER_REPORT) as f:
        jax_rows = {(r["shift"], r["level"]): r for r in json.load(f)["rows"]}
    for r in summary["rows"]:
        j = jax_rows.get((r["shift"], r["level"]), {})
        print(f"[protocols] {tag} {r['shift']:10s} {r['level']:6g}: " + "  ".join(
            f"{k} {r[k]} / {j.get(k)}" for k in ("cosine_synthcal_mean", "cosine_synthcal_min",
                                                  "cosine_oracle_mean", "transfer_gap",
                                                  "rank1_fp32", "rank1_int8"))
              + " (port / TPU)")
    failures = QT.check_bounds(summary)
    if failures:
        fail(f"{tag}: " + "; ".join(failures))


def check_profile(tag: str, rep: dict) -> None:
    """Every key of the JAX report, finite times, the margins the
    differences of the p50s, and the recomposed loss the trainer's."""
    import numpy as np

    with open(JAX_PROFILE_REPORT) as f:
        jax_rep = json.load(f)
    missing = [k for k in jax_rep if k not in rep] + \
        [k for k in jax_rep["p50_ms"] if k not in rep["p50_ms"]] + \
        [k for k in jax_rep["p50_ms"]["conv_microbench"]
         if k not in rep["p50_ms"]["conv_microbench"]] + \
        [k for k in jax_rep["margins_ms"] if k not in rep["margins_ms"]]
    p50 = rep["p50_ms"]
    times = [v for v in p50.values() if not isinstance(v, dict)] + \
        list(p50["conv_microbench"].values())
    check = rep["loss_check"]
    bound = LOSS_CHECK_TOL * max(1.0, abs(check["trainer"]))
    print(f"[protocols] {tag} ({rep['arch']}, B={rep['batch']}, {rep['dtype']}, "
          f"{rep['samples']} x {rep['chain']} chained calls): p50 ms {p50}; margins ms "
          f"{rep['margins_ms']}; recomposed loss {check['recomposed']!r} against the "
          f"trainer's {check['trainer']!r} (|diff| {check['abs_diff']:.3g}, bound "
          f"{bound:.3g})")
    if missing:
        fail(f"{tag}: keys of the JAX report missing: {missing}")
    if not np.isfinite(times).all() or min(times) <= 0:
        fail(f"{tag}: times {p50}")
    if not np.isfinite([check["trainer"], check["recomposed"]]).all() or \
            check["abs_diff"] > bound:
        fail(f"{tag}: the recomposed loss {check['recomposed']} is not the trainer's "
             f"{check['trainer']} (bound {bound})")


def check_probe(tag: str, rep: dict) -> None:
    import numpy as np

    print(f"[protocols] {tag} ({rep['arch']}, B={rep['batch']}, {rep['converge_steps']} "
          f"steps): " + "; ".join(
              f"{n} p50 {rep[n]['p50_step_ms']} ms, {rep[n]['imgs_per_sec']} images/s, loss "
              f"every 25 {rep[n]['loss_every_25']}" for n in ("bf16", "int8_fwd"))
          + f"; speedup of the int8 forward {rep['speedup_int8_fwd']}")
    for n in ("bf16", "int8_fwd"):
        losses = rep[n]["loss_every_25"]
        if len(losses) < 2 or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail(f"{tag} {n}: losses every 25 steps {losses} are not finite and falling")


def write_json(path: str, obj: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def protocols_phase(report) -> None:
    """Phase 17 (see the module docstring): the three protocols cut to
    size, on phase 11's ir_micro."""
    from facerecognitionpipeline_tpu_torch.evalharness import quantize_transfer as QT
    from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo as D
    from facerecognitionpipeline_tpu_torch.train import profile as P

    t_phase = time.perf_counter()
    res: dict = {"cuts": [
        "the demo and the sweep on phase 11's ir_micro (its aligned pool from a bf16 "
        "processor, the demo's from a float32 one), not a 400-step ir_micro of their own",
        f"train_profile at {PROFILE_PHASE['arch']}, B={PROFILE_PHASE['batch']}, "
        f"{PROFILE_PHASE['samples']} samples a variant (ir_101, 6)",
        f"the int8 probe at {PROBE_PHASE['arch']}, {PROBE_PHASE['converge_steps']} steps "
        f"to converge (200)"]}
    npz = report["train"]["e2e"]["weights"]
    counters = protocol_counters()
    for c in counters.values():
        c.reset()
    rep = D.run_demo(device=DEVICE, weights=npz, out_dir=os.path.join(WORK, "synthetic_e2e"))
    launches = {k: c.count for k, c in counters.items()}
    check_demo("phase 17 demo", rep, launches)
    res["demo"] = {k: rep[k] for k in ("rank1_fp32", "rank1_int8", "int8_drift_cosine",
                                       "detects", "seconds")}
    t0 = time.perf_counter()
    summary = QT.run_transfer("ir_micro", npz, device=DEVICE,
                              out_dir=os.path.join(WORK, "quantize_transfer"))
    res["transfer"] = {**summary, "seconds": time.perf_counter() - t0}
    check_transfer("phase 17 sweep", summary)
    t0 = time.perf_counter()
    prof = P.train_profile(device=DEVICE, **PROFILE_PHASE)
    res["train_profile"] = {**prof, "seconds": time.perf_counter() - t0}
    check_profile("phase 17 train_profile", prof)
    t0 = time.perf_counter()
    probe = P.int8_probe(device=DEVICE, **PROBE_PHASE)
    res["int8_probe"] = {**probe, "seconds": time.perf_counter() - t0}
    check_probe("phase 17 int8 probe", probe)
    res["launches"] = {k: c.count for k, c in counters.items()}
    if res["launches"] != launches:
        fail(f"phase 17: the sweep or the train probes launched kernels: "
             f"{res['launches']} after the demo's {launches}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[protocols] phase 17 took {res['seconds']:.1f} s (demo {rep['seconds']:.1f}, "
          f"sweep {res['transfer']['seconds']:.1f}, profile "
          f"{res['train_profile']['seconds']:.1f}, probe {res['int8_probe']['seconds']:.1f}); "
          f"launches {res['launches']}; cuts: " + "; ".join(res["cuts"]))
    report["protocols"] = res


def protocols_full(which: str) -> dict:
    """--protocols-only: the JAX scripts' sizes, writing the committed
    reports: the demo with a 400-step ir_micro of its own (exported to
    pretrained/ir_micro_synthetic_torch.npz), the sweep on those weights,
    train_profile at ir_101 / B=128 and both int8 probes."""
    from facerecognitionpipeline_tpu_torch.evalharness import quantize_transfer as QT
    from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo as D
    from facerecognitionpipeline_tpu_torch.train import profile as P

    out: dict = {}
    counters = protocol_counters()
    if which in ("demo", "all"):
        for c in counters.values():
            c.reset()
        rep = D.run_demo(device=DEVICE, retrain=True)
        launches = {k: c.count for k, c in counters.items()}
        check_demo("demo", rep, launches)
        out["demo"] = {k: rep[k] for k in ("rank1_fp32", "rank1_int8", "int8_drift_cosine",
                                           "detects", "seconds", "train_seconds")}
        out["demo_launches"] = launches
    if which in ("transfer", "all"):
        t0 = time.perf_counter()
        summary = QT.run_transfer("ir_micro", D.EMBEDDER_WEIGHTS, device=DEVICE)
        check_transfer("sweep", summary)
        out["transfer_seconds"] = time.perf_counter() - t0
    if which in ("train_profile", "all"):
        t0 = time.perf_counter()
        prof = P.train_profile(device=DEVICE, **PROFILE_FULL)
        write_json(os.path.join(TRAIN_PROFILE_DIR, "ir_101_b128.json"), prof)
        check_profile("train_profile", prof)
        out["profile_seconds"] = time.perf_counter() - t0
        for name, kw in PROBES_FULL:
            t0 = time.perf_counter()
            probe = P.int8_probe(device=DEVICE, **kw)
            write_json(os.path.join(TRAIN_PROFILE_DIR, name), probe)
            check_probe(name, probe)
            out[f"{name}_seconds"] = time.perf_counter() - t0
    print(f"[protocols] --protocols-only {which}: {out}")
    return out


# ------------------------------------------------------------ phase 18

SERVING_ONLY = ("bench", "curve", "ceiling", "budget", "all")  # what --serving-only takes
SERVING_DIR = os.path.join(REPO, "reports", "serving_bench_torch")
BUDGET_FACES = 32  # examples/profile_budget.py's face slots
BUDGET_CHAIN = 5
# phase 18 (the default run) and --serving-only (the JAX scripts' sizes).
# Bench servers: (image formats, transport, quantize, embed_budget, clients)
# mosaic_payload: a fixture mosaic posted among the noise frames, so that
# answers with faces come from shared B=8 steps under concurrent clients.
# The curve: the raw I420 server and the stub on the card, both listening,
# measured in turn at each client count, `curve_rounds` times.
SERVING_PHASE = {
    "servers": ((("raw-i420",), "i420", None, None, (1, 4)),),
    "seconds": 8.0, "settle": 0.0, "mosaic_payload": True,
    "ceiling_clients": (4,), "ceiling_seconds": 4.0, "ceiling_devices": ("cuda",),
    "budgets": (8,), "budget_samples": 2,
}
SERVING_FULL = {
    "servers": ((("png", "jpeg", "raw"), "rgb", None, None, (1, 4, 8, 12)),
                (("jpeg",), "i420", None, None, (1, 4, 8, 12)),
                (("raw-i420",), "i420", "int8", 8, (4, 12))),
    "seconds": 20.0, "settle": 5.0, "mosaic_payload": False,
    "curve_clients": (1, 4, 8, 12, 16, 24), "curve_rounds": 3,
    "curve_seconds": 12.0, "curve_settle": 5.0,
    "ceiling_clients": (1, 4, 8, 12), "ceiling_seconds": 12.0, "ceiling_devices": ("cpu",),
    "budgets": (16, 8, 4), "budget_samples": 4,
}
CURVE_FLAT = 0.9  # the curve stops climbing at the first count within this of its top
# a step of the bench's build: K1 x3, K2 x1, K5 x3, no gallery kernel (23
# students match densely)
BENCH_STEP = {"crop_resize": 3, "warp_patches": 1, "gallery_topk": 0, "gallery_topk_int8": 0,
              "gallery_topk_f32": 0, "nms_fixpoint": 3}


def served_canvas(payload, transport: str):
    """The canvas the server dispatches for one bench payload, prepared as
    its request path prepares it (decode, letterbox, the transport's
    colour format), and the scale it divides boxes by."""
    import base64

    import numpy as np

    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.utils.io import decode_image_rgb

    path, body, headers = payload
    if headers is None:
        canvas, scale = rawproto.letterbox_rgb(decode_image_rgb(base64.b64decode(body)),
                                               DET_SIZE)
        return (rawproto.rgb_to_i420(canvas) if transport == "i420" else canvas), scale
    h, w = int(headers[rawproto.HEADER_HEIGHT]), int(headers[rawproto.HEADER_WIDTH])
    arr = np.frombuffer(body, np.uint8)
    if headers[rawproto.HEADER_FORMAT] == "rgb24":
        rgb = arr.reshape(h, w, 3)
        canvas = rawproto.rgb_to_i420(rgb) if transport == "i420" else rgb
    else:
        yuv = arr.reshape(h * 3 // 2, w)
        canvas = yuv if transport == "i420" else rawproto.i420_to_rgb(yuv)
    return canvas, float(headers[rawproto.HEADER_SCALE])


def bench_direct(tag, server, payloads, transport, int8: bool):
    """A direct step of the server's engine on each payload's canvas:
    (faces per payload, scale per payload, launches per step). The step
    must launch BENCH_STEP, and the int8 build as many int8 products as its
    eager step has quantized layers (phase 8's count), the bf16 build
    none."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.ops.launches import launch_counts

    canvases = [served_canvas(p, transport) for p in payloads]
    at = launch_counts()
    faces = [direct_faces(server, c) for c, _ in canvases]
    n = len(canvases)
    got = {k: c - at[k] for k, c in launch_counts().items()}
    per = {k: c // n for k, c in got.items()}
    if any(c % n for c in got.values()) or {k: per[k] for k in BENCH_STEP} != BENCH_STEP:
        fail(f"{tag}: {n} direct steps launched {got}, want {BENCH_STEP} a step")
    want_products = 0
    if int8:
        t, v, _ = server.gallery.device_snapshot()
        batch = torch.from_numpy(np.stack([c for c, _ in canvases])).to(server.device)
        want_products = sum(int8_step_shapes(server.engine, batch, t, v).values())
        if want_products < 1:
            fail(f"{tag}: the int8 build's step has no quantized layer")
    if per["int8_products"] != want_products:
        fail(f"{tag}: {per['int8_products']} int8 products a direct step, want {want_products}")
    return faces, [s for _, s in canvases], per


def print_bench_row(tag: str, r: dict) -> None:
    def ms(x):
        return "n/a" if x is None else f"{x:.3f} ms"

    print(f"[bench] {tag} x{r['clients']}: {r['req_per_sec']:.3f} requests/s, p50 "
          f"{r['latency_p50_ms']:.3f} ms, p95 {r['latency_p95_ms']:.3f} ms; {r['requests']} "
          f"requests (the server counted {r['server_requests']}) in {r['wall_s']:.3f} s; "
          f"{r['steps']} steps, {r['frames_per_step']:.3f} frames a step, step p50 "
          f"{ms(r['step_p50_ms'])}, steps fill "
          + ("n/a" if r["step_busy_share"] is None else f"{r['step_busy_share']:.3f}")
          + f" of the window; CPU s: clients {r['client_cpu_s']:.3f}, this process "
          f"{r['host_cpu_s']:.3f} ({r['cpu_count']} cores); clients ready in "
          f"{r['clients_start_s']:.3f} s, done {r['clients_end_s']:.3f} s after the deadline; "
          f"launches {r['launches']}")


def bench_group(cfg: dict, group, fixture, res: dict) -> None:
    """One bench server (`serve/bench.py::bench_server`) through its image
    formats and client counts; every row held to the direct step."""
    import gc
    import json as _json

    import torch

    from facerecognitionpipeline_tpu_torch.serve import bench as B
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    formats, transport, quantize, budget, clients = group
    label = transport + (" int8" if quantize else "") + (f" budget {budget}" if budget else "")
    t0 = time.perf_counter()
    server, rng = B.bench_server(ARCH, DET_SIZE[0], BATCH, transport, quantize, budget,
                                 device=DEVICE)
    if server.device.type != DEVICE or server.engine.detector.crop_impl != "kernel" or \
            server.batcher.bucket_sizes != [1, BATCH]:
        fail(f"bench server {label}: not on {DEVICE} with the kernels selected and buckets "
             f"(1, {BATCH}) ({server.batcher.bucket_sizes})")
    frames = B.camera_frames(rng)
    mosaic = mosaics(fixture, 1)[0][0]
    served = B.ServedBench(server)
    print(f"[bench] server {label} ({ARCH}, {DET_SIZE[0]} px, batch_max {BATCH}) built, "
          f"warmed and listening in {time.perf_counter() - t0:.1f} s")
    try:
        for fmt in formats:
            tag = f"{fmt}/{label}"
            payloads = [B.encode_frame(f, fmt, DET_SIZE[0])
                        for f in frames + ([mosaic] if cfg["mosaic_payload"] else [])]
            faces, scales, per = bench_direct(tag, server, payloads, transport, bool(quantize))
            if cfg["mosaic_payload"] and len(faces[-1]) < 8:
                fail(f"bench {tag}: the mosaic payload's direct step found {len(faces[-1])} faces")
            for n in clients:
                row = served.run(n, cfg["seconds"], payloads, settle=cfg["settle"],
                                 keep_answers=True)
                answers = row.pop("answers")
                row.update(B.bench_fields(row, fmt, transport, quantize, budget, ARCH))
                row["direct_faces"] = [len(f) for f in faces]
                print_bench_row(tag, row)
                check_bench_row(f"bench {tag} x{n}", row, per)
                for c, j, text in answers:
                    check_response(f"bench {tag} x{n} client {c} payload {j}",
                                   _json.loads(text), faces[j], scales[j])
                for k, c in row["launches"].items():
                    res["launches"][k] = res["launches"].get(k, 0) + c
                res["bench"].append(row)
        # one frame with faces posted alone: a fixture mosaic, held to the direct step
        payload = B.encode_frame(mosaic, "raw-i420" if transport == "i420" else "raw",
                                 DET_SIZE[0])
        canvas, scale = served_canvas(payload, transport)
        want_faces = direct_faces(server, canvas)
        http = HTTPSession()
        try:
            r = http.post(served.url + payload[0], data=payload[1], headers=payload[2],
                          timeout=120)
        finally:
            http.close()
        if r.status_code != 200 or len(want_faces) < 8:
            fail(f"bench {label}: the mosaic answered {r.status_code}, its direct step found "
                 f"{len(want_faces)} faces")
        check_response(f"bench {label} mosaic", r.json(), want_faces, scale)
        report = {**served.report(), "transport": transport, "quantize": quantize,
                  "embed_budget": budget}
    finally:
        served.close()
    print(f"[bench] server {label}: {len(want_faces)} faces of a fixture mosaic answered as "
          f"the direct step; launch report {report}")
    res["servers"].append(report)
    del server, served
    gc.collect()
    torch.cuda.empty_cache()


def check_bench_row(tag: str, row: dict, per: dict) -> None:
    """A real server's row: the server's count equal to the clients', no
    torch in a client, `per` launches (the direct step's) a dispatched step."""
    if row["requests"] != row["server_requests"] or row["clients_imported_torch"]:
        fail(f"{tag}: {row['requests']} requests, the server counted "
             f"{row['server_requests']}; torch in a client: {row['clients_imported_torch']}")
    want = {k: c * row["steps"] for k, c in per.items()}
    if row["launches"] != want or not 1 <= row["steps"] <= row["requests"]:
        fail(f"{tag}: {row['steps']} steps for {row['requests']} requests launched "
             f"{row['launches']}, want {want}")


def check_stub_row(tag: str, r: dict) -> None:
    """A stub server's row: no launch, the server's count equal to the
    clients', no torch in a client."""
    if any(r["launches"].values()) or r["requests"] != r["server_requests"] or \
            r["clients_imported_torch"]:
        fail(f"{tag} x{r['clients']}: launches {r['launches']}, {r['requests']} requests "
             f"against the server's {r['server_requests']}")


def curve_summary(rows) -> dict:
    """Per client count the median, least and most requests/s of the real
    server's and the stub's rounds, the real steps' p50 and fill, frames a
    step; where the real curve stops climbing (the first count whose
    median is within CURVE_FLAT of the highest median) and the stub's top."""
    import numpy as np

    out = {"counts": []}
    for n in sorted({r["clients"] for r in rows}):
        at = {e: [r for r in rows if r["clients"] == n and r["engine_kind"] == e]
              for e in ("real", "stub")}
        entry = {"clients": n}
        for e, rs in at.items():
            rate = [r["req_per_sec"] for r in rs]
            entry[e] = {"median": float(np.median(rate)), "min": min(rate), "max": max(rate),
                        "frames_per_step": float(np.median([r["frames_per_step"] for r in rs])),
                        "p50_ms": float(np.median([r["latency_p50_ms"] for r in rs]))}
        real = at["real"]
        entry["real"]["step_p50_ms"] = float(np.median([r["step_p50_ms"] for r in real]))
        entry["real"]["step_busy_share"] = float(np.median([r["step_busy_share"] for r in real]))
        entry["real_over_stub"] = entry["real"]["median"] / entry["stub"]["median"]
        out["counts"].append(entry)
    top = max(e["real"]["median"] for e in out["counts"])
    flat = next(e for e in out["counts"] if e["real"]["median"] >= CURVE_FLAT * top)
    out["real_top"] = top
    out["real_flat_clients"] = flat["clients"]
    out["real_flat_req_s"] = flat["real"]["median"]
    out["stub_top"] = max(e["stub"]["median"] for e in out["counts"])
    return out


def curve_runs(cfg: dict, res: dict) -> None:
    """The raw I420 server (bf16, the bench's build) and the stub on the
    card, both listening, driven in turn at each of `curve_clients` for
    `curve_rounds` rounds (a settle run before each count's first round):
    the real curve beside the host's ceiling in one run, with each count's
    spread over the rounds."""
    import gc

    import torch

    from facerecognitionpipeline_tpu_torch.serve import bench as B

    real, rng = B.bench_server(ARCH, DET_SIZE[0], BATCH, "i420", device=DEVICE)
    if real.device.type != DEVICE or real.engine.detector.crop_impl != "kernel" or \
            real.batcher.bucket_sizes != [1, BATCH]:
        fail(f"curve server: not on {DEVICE} with the kernels selected and buckets (1, {BATCH}) "
             f"({real.batcher.bucket_sizes})")
    payloads = [B.encode_frame(f, "raw-i420", DET_SIZE[0]) for f in B.camera_frames(rng)]
    _, _, per = bench_direct("curve raw-i420/i420", real, payloads, "i420", False)
    stub, stub_payload = B.ceiling_server(DET_SIZE[0], "i420", device=DEVICE)
    served = {"real": B.ServedBench(real), "stub": B.ServedBench(stub, session="ceiling")}
    rows = []
    try:
        for rnd in range(cfg["curve_rounds"]):
            for n in cfg["curve_clients"]:
                row = served["real"].run(n, cfg["curve_seconds"], payloads,
                                         settle=cfg["curve_settle"] if rnd == 0 else 0.0)
                row.update(B.bench_fields(row, "raw-i420", "i420", None, None, ARCH))
                row.update({"engine_kind": "real", "round": rnd})
                print_bench_row(f"curve round {rnd} raw-i420/i420", row)
                check_bench_row(f"curve round {rnd} raw-i420/i420 x{n}", row, per)
                for k, c in row["launches"].items():
                    res["launches"][k] = res["launches"].get(k, 0) + c
                rows.append(row)
                srow = served["stub"].run(n, cfg["curve_seconds"], [stub_payload])
                srow.update({"engine": B.CEILING_ENGINE, "transport": "i420",
                             "engine_kind": "stub", "round": rnd})
                print_bench_row(f"curve round {rnd} stub on {DEVICE}", srow)
                check_stub_row(f"curve round {rnd} stub", srow)
                rows.append(srow)
            # launch reports count this process's launches, both servers' together
        # (each row above holds its own window's)
        reports = {e: {k: v for k, v in sb.report().items() if k != "launches"}
                   for e, sb in served.items()}
    finally:
        for sb in served.values():
            sb.close()
    summary = curve_summary(rows)
    for e in summary["counts"]:
        print(f"[curve] x{e['clients']}: real {e['real']['median']:.3f} req/s "
              f"({e['real']['min']:.3f}-{e['real']['max']:.3f}; {e['real']['frames_per_step']:.3f}"
              f" frames a step, step p50 {e['real']['step_p50_ms']:.3f} ms, steps fill "
              f"{e['real']['step_busy_share']:.3f}), stub {e['stub']['median']:.3f} "
              f"({e['stub']['min']:.3f}-{e['stub']['max']:.3f}); real/stub "
              f"{e['real_over_stub']:.3f}")
    print(f"[curve] the real curve stops climbing at {summary['real_flat_clients']} clients, "
          f"{summary['real_flat_req_s']:.3f} req/s (its top {summary['real_top']:.3f}); the "
          f"stub's top {summary['stub_top']:.3f} req/s")
    res["curve"] = rows
    res["curve_summary"] = summary
    res["servers"].append({**reports["real"], "transport": "i420", "quantize": None,
                           "embed_budget": None, "part": "curve"})
    res["servers"].append({**reports["stub"], "engine": B.CEILING_ENGINE, "device": DEVICE,
                           "part": "curve"})
    del real, stub, served
    gc.collect()
    torch.cuda.empty_cache()


def ceiling_runs(cfg: dict, res: dict) -> None:
    """`run_host_ceiling` with the stub on each of `ceiling_devices`: no
    kernel may launch."""
    from facerecognitionpipeline_tpu_torch.serve import bench as B

    for dev in cfg["ceiling_devices"]:
        out = B.run_host_ceiling(cfg["ceiling_clients"], cfg["ceiling_seconds"], DET_SIZE[0],
                                 "i420", device=dev)
        for r in out["rows"]:
            print(f"[ceiling] stub on {dev} x{r['clients']}: {r['req_s']:.3f} requests/s, p50 "
                  f"{r['p50_ms']:.3f} ms, p95 {r['latency_p95_ms']:.3f} ms; {r['requests']} "
                  f"requests (the server counted {r['server_requests']}), {r['steps']} steps, "
                  f"{r['frames_per_step']:.3f} frames a step; CPU s: clients "
                  f"{r['client_cpu_s']:.3f}, this process {r['host_cpu_s']:.3f} "
                  f"({r['cpu_count']} cores); launches {r['launches']}")
            check_stub_row(f"ceiling on {dev}", r)
        if any(out["server"]["launches"].values()):
            fail(f"ceiling on {dev}: the stub server launched {out['server']['launches']}")
        res["ceiling"].extend(out["rows"])
        res["servers"].append({**out["server"], "engine": B.CEILING_ENGINE, "device": dev})


def budget_runs(cfg: dict, res: dict) -> None:
    """`profile_budget` at the JAX script's build: embeds per step B x
    (budget or F), every budget's p50 at or below the dense step's."""
    from facerecognitionpipeline_tpu_torch.pipeline.budget_profile import profile_budget

    rows = profile_budget(b=BATCH, faces=BUDGET_FACES, det=DET_SIZE[0], budgets=cfg["budgets"],
                          chain=BUDGET_CHAIN, samples=cfg["budget_samples"], architecture=ARCH,
                          device=DEVICE)
    dense = rows[0]["p50_step_ms"]
    for r in rows:
        print(f"[budget] {r['budget'] or 'dense'}: p50 {r['p50_step_ms']:.3f} ms, "
              f"{r['frames_per_sec']:.2f} frames/s, device "
              + ("n/a" if r["device_ms"] is None else f"{r['device_ms']:.3f} ms")
              + f" a step, {r['embeds_per_step']} embeds a step")
        if r["embeds_per_step"] != BATCH * (r["budget"] or BUDGET_FACES):
            fail(f"budget {r['budget']}: {r['embeds_per_step']} embeds a step, want "
                 f"{BATCH * (r['budget'] or BUDGET_FACES)}")
        if r["p50_step_ms"] > dense:
            fail(f"budget {r['budget']}: p50 {r['p50_step_ms']:.3f} ms above the dense "
                 f"step's {dense:.3f}")
    res["budget"] = rows


def write_jsonl(path: str, rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def bench_runs(fixture, cfg: dict, which: str = "all") -> dict:
    """The bench, the ceiling and the budget sweep at `cfg`'s sizes."""
    t_all = time.perf_counter()
    res = {"bench": [], "curve": [], "ceiling": [], "budget": [], "servers": [],
           "launches": {}, "seconds": {}}
    if which in ("bench", "all"):
        t0 = time.perf_counter()
        for group in cfg["servers"]:
            bench_group(cfg, group, fixture, res)
        res["seconds"]["bench"] = time.perf_counter() - t0
    if which in ("curve", "all") and "curve_clients" in cfg:
        t0 = time.perf_counter()
        curve_runs(cfg, res)
        res["seconds"]["curve"] = time.perf_counter() - t0
    if which in ("ceiling", "all"):
        t0 = time.perf_counter()
        ceiling_runs(cfg, res)
        res["seconds"]["ceiling"] = time.perf_counter() - t0
    if which in ("budget", "all"):
        t0 = time.perf_counter()
        budget_runs(cfg, res)
        res["seconds"]["budget"] = time.perf_counter() - t0
    res["seconds"]["all"] = time.perf_counter() - t_all
    return res


def bench_phase(fixture, report) -> None:
    """Phase 18 (see the module docstring)."""
    res = bench_runs(fixture, SERVING_PHASE)
    print(f"[serving] phase 18 took {res['seconds']['all']:.1f} s ({res['seconds']}); the "
          f"bench servers' launches {res['launches']}")
    report["serving"] = res


def bench_full(fixture, which: str) -> dict:
    """--serving-only: the JAX scripts' sizes, each part's rows (and its
    servers' launch reports) written to SERVING_DIR/<part>.jsonl."""
    res = bench_runs(fixture, SERVING_FULL, which)
    servers = {"bench": [s for s in res["servers"] if "engine" not in s and "part" not in s],
               "curve": [s for s in res["servers"] if "part" in s],
               "ceiling": [s for s in res["servers"] if "engine" in s and "part" not in s],
               "budget": []}
    for part in ("bench", "curve", "ceiling", "budget"):
        if which in (part, "all"):
            extra = [{"summary": res["curve_summary"]}] if part == "curve" else []
            write_jsonl(os.path.join(SERVING_DIR, f"{part}.jsonl"),
                        res[part] + extra + [{"server": s} for s in servers[part]])
    print(f"[serving] --serving-only {which}: {res['seconds']}; rows in "
          f"{os.path.relpath(SERVING_DIR, REPO)}")
    return res


# ------------------------------------------------------------ phase 19

PROFILE_ONLY = ("fused", "detect", "gallery", "all")  # what --profile-only takes
STAGE_DIR = os.path.join(REPO, "reports", "stage_profile_torch")
STAGE_FACES = 32  # the JAX bisects' face slots
# phase 19 (the default run) and --profile-only (the JAX scripts' defaults)
STAGE_PHASE = {"chain": 3, "samples": 2, "gallery_samples": 2,
               "gallery": (((1024,), ("dense",)), ((131072,), ("streaming",))),
               "int8": False}
STAGE_FULL = {"chain": 5, "samples": 3, "gallery_samples": 4,
              "gallery": (((1024, 131072, 1 << 20), ("dense", "streaming", "streaming_int8")),),
              "int8": True}
# launches of one replay of each stage program (K1 x2 and K5 x3 a detect, K1
# x1 and K2 x1 an alignment, K3 or K4 once a streaming step)
STAGE_LAUNCHES = {
    "detect (cascade)": {"crop_resize": 2, "nms_fixpoint": 3},
    "  stage1 (pnet pyramid+nms)": {"nms_fixpoint": 1},
    "  stage2 (rnet)": {"crop_resize": 1, "nms_fixpoint": 1},
    "  stage3 (onet)": {"crop_resize": 1, "nms_fixpoint": 1},
    "  align (matmul warp, alt)": {},
    "align (kernel K1+K2)": {"crop_resize": 1, "warp_patches": 1},
    "quality gate": {},
    "gallery topk (1024)": {},
    "FULL fused step": {"crop_resize": 3, "warp_patches": 1, "nms_fixpoint": 3},
    "pyramid progressive": {},
    "pyramid direct (old)": {},
    "stage1 (full s1)": {"nms_fixpoint": 1},
    "+ s2 crops": {"crop_resize": 1, "nms_fixpoint": 1},
    "+ rnet conv": {"crop_resize": 1, "nms_fixpoint": 1},
    "+ s2 nms/topk (full s2)": {"crop_resize": 1, "nms_fixpoint": 2},
    "+ s3 crops": {"crop_resize": 2, "nms_fixpoint": 2},
    "+ onet conv": {"crop_resize": 2, "nms_fixpoint": 2},
    "+ final nms (full cascade)": {"crop_resize": 2, "nms_fixpoint": 3},
}
STAGE_MATCH = {"dense": {}, "streaming": {"gallery_topk": 1},
               "streaming_int8": {"gallery_topk_int8": 1}}


def check_stage_row(tag: str, name: str, row: dict, want: dict) -> None:
    """A stage row: its replay equal to its eager call bit for bit, the
    kernels one replay launched (int8 products aside) equal to `want`, and
    a time. The profiler's device time may be missing: late in the default
    run it has seen no kernel of a 0.05 ms graph's three replays."""
    if row["replay_equals_eager"] is not True:
        fail(f"{tag} {name!r}: the graph's replay differs from the eager call")
    got = {k: n for k, n in row["launches"].items() if k != "int8_products"}
    if got != want:
        fail(f"{tag} {name!r}: one replay launched {row['launches']}, want {want}")
    if not row["ms"] > 0:
        fail(f"{tag} {name!r}: no time ({row['ms']} ms)")


def ms_text(ms) -> str:
    return "n/a" if ms is None else f"{ms:.3f}"


def fused_rows(tag: str, cfg: dict, quantize=None) -> dict:
    """The fused-step bisect at the JAX script's build, every row checked;
    the sum of stages printed beside the full step."""
    from facerecognitionpipeline_tpu_torch.pipeline import stage_profile as SP

    rows = SP.profile_fused_step(b=BATCH, faces=STAGE_FACES, det=DET_SIZE[0],
                                 chain=cfg["chain"], samples=cfg["samples"], quantize=quantize,
                                 architecture=ARCH, device=DEVICE)
    for r in rows:
        want = STAGE_LAUNCHES.get(r["stage"], {})  # the embedder launches none of them
        check_stage_row(tag, r["stage"], r, want)
        if quantize and r["stage"].startswith(("embed", "FULL")) and \
                not r["launches"].get("int8_products"):
            fail(f"{tag} {r['stage']!r}: the int8 embedder ran no int8 product")
        print(f"[stages] {tag} {r['stage']:34s} {r['ms']:8.3f} ms  device "
              f"{ms_text(r['device_ms'])} ms  launches {r['launches']}")
    full = rows[-1]
    summed = {"stage": "sum of stages", "ms": SP.sum_of_stages(rows),
              "device_ms": SP.sum_of_stages(rows, "device_ms"),
              **{k: full[k] for k in ("config", "device", "card", "power_limit")}}
    print(f"[stages] {tag} sum of stages {summed['ms']:.3f} ms (device "
          f"{ms_text(summed['device_ms'])}) against the FULL fused step {full['ms']:.3f} ms "
          f"(device {ms_text(full['device_ms'])})")
    return {"rows": rows, "sum": summed}


def detect_rows(tag: str, cfg: dict) -> list:
    from facerecognitionpipeline_tpu_torch.pipeline import stage_profile as SP

    rows = SP.profile_detect(b=BATCH, det=DET_SIZE[0], chain=cfg["chain"],
                             samples=cfg["samples"], device=DEVICE)
    for r in rows:
        check_stage_row(tag, r["program"], r, STAGE_LAUNCHES[r["program"]])
        print(f"[stages] {tag} {r['program']:28s} {r['ms']:8.3f} ms (delta "
              f"{r['delta_ms']:+.3f}, median {r['median_ms']:.3f}, device "
              f"{ms_text(r['device_ms'])})  launches {r['launches']}")
    return rows


def gallery_rows(tag: str, cfg: dict) -> list:
    from facerecognitionpipeline_tpu_torch.pipeline import stage_profile as SP

    rows = []
    for sizes, impls in cfg["gallery"]:
        rows += SP.profile_gallery_scale(b=BATCH, faces=STAGE_FACES, det=DET_SIZE[0],
                                         sizes=sizes, impls=impls, chain=cfg["chain"],
                                         samples=cfg["gallery_samples"], architecture=ARCH,
                                         device=DEVICE)
    for r in rows:
        name = f"{r['gallery_size']} {r['gallery_impl']}"
        check_stage_row(tag, name, r | {"ms": r["p50_step_ms"]}, {
            **STAGE_LAUNCHES["FULL fused step"], **STAGE_MATCH[r["gallery_impl"]]})
        print(f"[stages] {tag} gallery {name}: p50 {r['p50_step_ms']:.3f} ms, "
              f"{r['faces_per_sec']:.1f} faces/s, device {ms_text(r['device_ms'])} ms, "
              f"launches {r['launches']}")
    return rows


def stage_runs(cfg: dict, which: str = "all") -> dict:
    """The three bisects at `cfg`'s sizes, the kernels' counts set to 0
    before and read after."""
    counters = protocol_counters()
    for c in counters.values():
        c.reset()
    t_all = time.perf_counter()
    res: dict = {"seconds": {}}
    for part, run in (("fused", lambda: fused_rows("fused bf16", cfg)),
                      ("fused_int8", lambda: fused_rows("fused int8", cfg, "int8")),
                      ("detect", lambda: detect_rows("detect", cfg)),
                      ("gallery", lambda: gallery_rows("gallery", cfg))):
        if which not in (part.split("_")[0], "all") or (part == "fused_int8" and
                                                         not cfg["int8"]):
            continue
        t0 = time.perf_counter()
        res[part] = run()
        res["seconds"][part] = time.perf_counter() - t0
    res["seconds"]["all"] = time.perf_counter() - t_all
    res["launches"] = {k: c.count for k, c in counters.items()}
    return res


def stage_phase(report) -> None:
    """Phase 19 (see the module docstring)."""
    res = stage_runs(STAGE_PHASE)
    for name in ("crop_resize", "warp_patches", "nms_fixpoint", "gallery_topk"):
        if res["launches"][name] < 1:
            fail(f"phase 19 never launched {name}")
    print(f"[stages] phase 19 took {res['seconds']['all']:.1f} s ({res['seconds']}); "
          f"launches {res['launches']}")
    report["stages"] = res


def stage_full(which: str) -> dict:
    """--profile-only: the JAX scripts' defaults, each bisect's rows written
    to STAGE_DIR/<name>.jsonl."""
    res = stage_runs(STAGE_FULL, which)
    files = {"fused": ("fused_step.jsonl", lambda v: v["rows"] + [v["sum"]]),
             "fused_int8": ("fused_step_int8.jsonl", lambda v: v["rows"] + [v["sum"]]),
             "detect": ("detect.jsonl", lambda v: v),
             "gallery": ("gallery_scale.jsonl", lambda v: v)}
    for part, (name, rows) in files.items():
        if part in res:
            write_jsonl(os.path.join(STAGE_DIR, name), rows(res[part]))
    print(f"[stages] --profile-only {which}: {res['seconds']}; launches {res['launches']}; "
          f"rows in {os.path.relpath(STAGE_DIR, REPO)}")
    return res


# ------------------------------------------------------------ phase 20

BENCH_RECORD = os.path.join(REPO, "reports", "bench_line_torch.jsonl")
# launches of one step of every route of bench.py's line: K1 x3, K2 x1, K5
# x3, and K3 (bf16 rows) or K4 (their int8 pair) once against 1 048 576 ids
BENCH_LAUNCHES = {"crop_resize": 3, "warp_patches": 1, "nms_fixpoint": 3}
BENCH_MATCH = {"gallery_1m_bf16": {"gallery_topk": 1},
               "gallery_1m_int8": {"gallery_topk_int8": 1}}
BENCH_PHASE_ROUTES = ("bf16", "embed_budget8")  # phase 20: the headline and budget 8


def check_headline(tag: str, res: dict, names) -> None:
    """Every route of `names`: built and measured, its first step (the
    graph's first replay) equal to its eager step on all 12 result fields,
    the launches of one step as BENCH_LAUNCHES / BENCH_MATCH say, int8
    products only on the routes with the int8 embedder, its keys in the
    line (`step_bench.LINE_KEYS`) non-null, and its host-clock p50 not
    below the CUDA-event p50 of the same windows by more than the round
    trip it was corrected by, over the chain. The events' span also counts
    the card's waits for the host, so this last check guards the
    round-trip correction only: it cannot show the host holding the card
    back."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.pipeline import step_bench as SB

    line, routes = res["line"], res["routes"]
    slack = routes["bf16"]["correction"] * 1e3 / res["chain"]
    for name in names:
        rec = routes.get(name, {})
        if "error" in rec or "launches" not in rec:
            fail(f"{tag} {name}: the route failed ({rec.get('error')})")
        if len(rec["fields"]) != 12 or rec["differs"]:
            fail(f"{tag} {name}: the graph's first replay differs from the eager step in "
                 f"{rec['differs']} of {rec['fields']}")
        got = {k: n for k, n in rec["launches"].items() if k != "int8_products"}
        want = {**BENCH_LAUNCHES, **BENCH_MATCH.get(name, {})}
        if got != want:
            fail(f"{tag} {name}: one step launched {rec['launches']}, want {want}")
        if bool(rec["launches"].get("int8_products")) != rec["options"]["embedder_quantized"]:
            fail(f"{tag} {name}: int8 products a step {rec['launches'].get('int8_products')}")
        for key, _ in SB.LINE_KEYS[name]:
            if line[key] is None:
                fail(f"{tag} {name}: {key} is null")
        events = float(np.percentile(rec["event_ms"], 50))
        if rec["p50_ms"] < events - slack:
            fail(f"{tag} {name}: host-clock p50 {rec['p50_ms']:.4f} ms below the CUDA events' "
                 f"{events:.4f} ms of the same windows (slack {slack:.4f})")
        print(f"[bench] {tag} {name}: p50 {rec['p50_ms']:.3f} ms host clock, {events:.3f} ms "
              f"CUDA events; launches a step {rec['launches']}; replay = eager on 12 fields")


def headline_runs(tag: str, **kw) -> dict:
    """`step_bench.run` on the card, the kernels' counts set to 0 before
    and read after."""
    from facerecognitionpipeline_tpu_torch.pipeline import step_bench as SB

    counters = protocol_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    res = SB.run(device=DEVICE, **kw)
    res["launches"] = {k: c.count for k, c in counters.items()}
    print(f"[bench] {tag} took {time.perf_counter() - t0:.1f} s; launches {res['launches']}")
    return res


def headline_summary(res: dict) -> dict:
    """The routes' figures without their windows' raw walls."""
    keys = ("p50_ms", "faces_per_sec", "event_ms", "step_ms", "launches", "seconds",
            "peak_mib", "options", "error")
    return {"line": res["line"], "launches": res["launches"], "seconds": res["seconds"],
            "routes": {n: {k: r[k] for k in keys if k in r} for n, r in res["routes"].items()}}


def headline_phase(report) -> None:
    """Phase 20 (see the module docstring)."""
    res = headline_runs("phase 20", aux=BENCH_PHASE_ROUTES[1:], accuracy=False)
    check_headline("phase 20", res, BENCH_PHASE_ROUTES)
    for name in BENCH_LAUNCHES:
        if res["launches"][name] < 1:
            fail(f"phase 20 never launched {name}")
    report["headline"] = headline_summary(res)


def headline_full() -> dict:
    """--bench-only: bench.py's line at its sizes, every route checked,
    e2e_rank1 at or above E2E_FLOOR; the line printed and appended to
    BENCH_RECORD. The port's ir_micro weights are trained first (the
    synthetic demo, its report under WORK) where they are absent."""
    from facerecognitionpipeline_tpu_torch.pipeline import step_bench as SB

    if not os.path.exists(SB.EMBEDDER_WEIGHTS):
        print(f"[bench] {os.path.relpath(SB.EMBEDDER_WEIGHTS, REPO)} is absent: training it "
              f"first through the port's synthetic demo (evalharness/synthetic_demo.py)")
        from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo

        t0 = time.perf_counter()
        synthetic_demo.run_demo(DEVICE, out_dir=os.path.join(WORK, "bench_demo"))
        print(f"[bench] the demo trained and exported the weights in "
              f"{time.perf_counter() - t0:.1f} s")
    res = headline_runs("--bench-only")
    check_headline("--bench-only", res, ("bf16",) + SB.AUX)
    for name in protocol_counters():
        if name != "gallery_topk_f32" and res["launches"][name] < 1:
            fail(f"--bench-only never launched {name}")
    line = res["line"]
    if line["e2e_rank1"] is None or line["e2e_rank1"] < E2E_FLOOR:
        fail(f"--bench-only: e2e_rank1 {line['e2e_rank1']} below {E2E_FLOOR} "
             f"({line['accuracy_skipped']})")
    print(json.dumps(line))
    os.makedirs(os.path.dirname(BENCH_RECORD), exist_ok=True)
    with open(BENCH_RECORD, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(f"[bench] line appended to {os.path.relpath(BENCH_RECORD, REPO)}")
    return headline_summary(res)


def nms_entry(report, source) -> dict:
    """The kernels line's entry of K5: times and bounds summed over the
    three calls of one step (stages 1-3 of the server build at B=8),
    launches of phases 3 (the timed steps), 7 (the served requests), 12 (the
    mesh), 13 (one replay per route), 14, 15, 16, 17, 18 and 19; beside them the torch ops it
    absorbs (pairwise_iou + mask), the floor of its sweeps' barriers, its
    cluster per shape and nms_mask's device time per step."""
    rows = report["nms_fixpoint"]
    step = [r for r in rows if r["in_step"]]
    by_bytes = sum(r["bytes"] for r in step) / HBM_BYTES_PER_S
    by_ops = sum(r["flops"] / r["peak"] for r in step)
    entry = {
        "name": "nms_fixpoint", "route": "cuda", "source": source[0], "replaces": source[1],
        "launches": report["launches"]["nms_fixpoint"],
        "server_launches": report["server_launches"]["nms_fixpoint"],
        "mesh_launches": report["mesh"]["launches"]["nms_fixpoint"],
        "graph_launches": report["graph"]["launches"]["nms_fixpoint"],
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in step),
        "plain_ms": sum(r["plain_ms"] for r in step),
        "bound_ms": sum(r["bound_ms"] for r in step),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None,
        "device_ms": None if any(r["device_ms"] is None for r in step)
        else sum(r["device_ms"] for r in step),
        "absorbed_ms": sum(r["absorbed_ms"] for r in step),
        "absorbed_device_ms": None if any(r["absorbed_device_ms"] is None for r in step)
        else sum(r["absorbed_device_ms"] for r in step),
        "sweep_floor_ms": sum(r["sweep_floor_ms"] for r in step),
        "nms_mask_device_ms": step[0]["layer"]["device_ms"],
        "shapes": [f"{r['shape']} {r['mode']}" for r in rows],
        "by_shape": {f"{r['shape']} {r['mode']}": {
            k: r[k] for k in ("ms", "plain_ms", "bound_ms", "device_ms", "sweeps", "cluster",
                              "threads", "absorbed_ms", "absorbed_device_ms", "barrier_us",
                              "sweep_floor_ms", "clusters_fit", "clusters_fit_1024_threads")}
            for r in rows},
    }
    entry["openset_launches"] = report["openset"]["launches"]["nms_fixpoint"]
    entry["detector_launches"] = report["detector"]["launches"]["nms_fixpoint"]
    entry["soak_launches"] = report["soak"]["launches"]["nms_fixpoint"]
    entry["protocol_launches"] = report["protocols"]["launches"]["nms_fixpoint"]
    entry["bench_launches"] = report["serving"]["launches"]["nms_fixpoint"]
    entry["stage_launches"] = report["stages"]["launches"]["nms_fixpoint"]
    for key in ("launches", "server_launches", "mesh_launches", "graph_launches",
                "openset_launches", "detector_launches", "soak_launches",
                "protocol_launches", "bench_launches", "stage_launches"):
        if entry[key] < 1:
            fail(f"{key}: a main path never launched nms_fixpoint")
    return entry


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi gave no card name and power limit: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from facerecognitionpipeline_tpu_torch.ops import cuda_build
    from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # pins the TF32 settings
    if "--openset-only" in sys.argv[1:]:
        # the architecture after the flag names a recorded recipe (ir_50 when
        # nothing follows); anything else is refused before the build
        args = sys.argv[sys.argv.index("--openset-only") + 1:]
        openset_arch = args[0] if args else "ir_50"
        if openset_arch not in OPENSET_RECIPES:
            print(f"chip_smoke: --openset-only takes one of {sorted(OPENSET_RECIPES)}, "
                  f"not {openset_arch!r}", file=sys.stderr)
            return 2
    if "--detector-only" in sys.argv[1:]:
        # stress, ood or all (all when nothing follows); anything else is
        # refused before the build
        args = sys.argv[sys.argv.index("--detector-only") + 1:]
        detector_only = args[0] if args else "all"
        if detector_only not in DETECTOR_ONLY:
            print(f"chip_smoke: --detector-only takes one of {list(DETECTOR_ONLY)}, "
                  f"not {detector_only!r}", file=sys.stderr)
            return 2
    if "--soak-only" in sys.argv[1:]:
        # example, deployment or all (all when nothing follows); anything
        # else is refused before the build
        args = sys.argv[sys.argv.index("--soak-only") + 1:]
        soak_only = args[0] if args else "all"
        if soak_only not in SOAK_ONLY:
            print(f"chip_smoke: --soak-only takes one of {list(SOAK_ONLY)}, "
                  f"not {soak_only!r}", file=sys.stderr)
            return 2
    if "--protocols-only" in sys.argv[1:]:
        # demo, transfer, train_profile or all (all when nothing follows);
        # anything else is refused before the build
        args = sys.argv[sys.argv.index("--protocols-only") + 1:]
        protocols_only = args[0] if args else "all"
        if protocols_only not in PROTOCOLS_ONLY:
            print(f"chip_smoke: --protocols-only takes one of {list(PROTOCOLS_ONLY)}, "
                  f"not {protocols_only!r}", file=sys.stderr)
            return 2
    if "--serving-only" in sys.argv[1:]:
        # bench, curve, ceiling, budget or all (all when nothing follows); anything
        # else is refused before the build
        args = sys.argv[sys.argv.index("--serving-only") + 1:]
        serving_only = args[0] if args else "all"
        if serving_only not in SERVING_ONLY:
            print(f"chip_smoke: --serving-only takes one of {list(SERVING_ONLY)}, "
                  f"not {serving_only!r}", file=sys.stderr)
            return 2
    if "--profile-only" in sys.argv[1:]:
        # fused, detect, gallery or all (all when nothing follows); anything
        # else is refused before the build
        args = sys.argv[sys.argv.index("--profile-only") + 1:]
        profile_only = args[0] if args else "all"
        if profile_only not in PROFILE_ONLY:
            print(f"chip_smoke: --profile-only takes one of {list(PROFILE_ONLY)}, "
                  f"not {profile_only!r}", file=sys.stderr)
            return 2
    if "--full-sizes" in sys.argv[1:]:
        # phase 7's servers on 1 048 576 ids, phase 11's train_detector at
        # 100 steps: the default run without the cuts its time limit made
        global BIG_SERVER_ROWS, DET_STEPS
        BIG_SERVER_ROWS, DET_STEPS = FULL_SIZES["server_rows"], FULL_SIZES["det_steps"]
        print(f"[env] --full-sizes: phase 7's gallery file {BIG_SERVER_ROWS} ids, phase 11's "
              f"train_detector {DET_STEPS} steps")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    import importlib

    found = []
    for lib in ("cv2", "requests", "psutil", "PIL", "pandas", "scipy", "sklearn", "matplotlib"):
        try:
            found.append(f"{lib} {getattr(importlib.import_module(lib), '__version__', '?')}")
        except ImportError:
            found.append(f"{lib} missing")
    print(f"[env] optional host libraries: {', '.join(found)} (the port's host codecs need "
          f"cv2; it reads process memory through psutil where that imports; the evaluation "
          f"harness needs pandas and scipy, computes ROC-AUC and AP without sklearn, and "
          f"plots only with matplotlib, else evaluate_models runs with --no_plots)")
    t0 = time.perf_counter()
    took = cuda_build.build_all()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(per kernel, from the parallel start: "
          f"{ {k: round(s, 1) for k, s in took.items()} })")
    for name, log in cuda_build.BUILD_LOGS.items():
        print_build_report(name, log)
    with np.load(os.path.join(
        REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
    )) as z:
        fixture = {k: z[k] for k in z.files}

    if "--gallery-only" in sys.argv[1:]:
        # phase 2 alone (K3, K4, K3 on float32 rows: serving shape, odd
        # shapes, long lists), after the build, the same way
        report = gallery_kernel_phase(make_gallery(BIG_GALLERY_ROWS))
        print(card_line())
        print(json.dumps({"long_lists": report["long_lists"]}, default=str))
        return 0
    if "--offline-only" in sys.argv[1:]:
        # phase 10 alone, after the build: for work on that phase; prints no
        # kernels line and no result line
        report = {}
        offline_phase(make_gallery(BIG_GALLERY_ROWS), report)
        print(json.dumps({"offline": report["offline"]}))
        return 0
    if "--train-only" in sys.argv[1:]:
        # phase 11 alone, after the build, the same way
        report = {}
        train_phase(fixture, report)
        print(card_line())
        print(json.dumps({"train": report["train"]}))
        return 0
    if "--graph-only" in sys.argv[1:]:
        # phase 13 alone on phase 3's build, the same way (its int8 route
        # calibrates its own int8 build)
        report = {}
        graph_phase(mesh_context(fixture), make_gallery(BIG_GALLERY_ROWS), report)
        print(card_line())
        print(json.dumps({"graph": report["graph"]}))
        return 0
    if "--openset-only" in sys.argv[1:]:
        # the recorded open-set recipe at full scale (ir_50, or the
        # architecture named after the flag), after the build
        res = openset_full(fixture, openset_arch)
        print(card_line())
        print(json.dumps({"openset": res}))
        return 0
    if "--detector-only" in sys.argv[1:]:
        # the recorded detector recipes at full scale, after the build
        res = detector_full(fixture, detector_only)
        print(card_line())
        print(json.dumps({"detector": res}))
        return 0
    if "--soak-only" in sys.argv[1:]:
        # the recycle soak at full size, after the build: every worker
        # loads the libraries this process built
        res = soak_full(fixture, soak_only)
        print(card_line())
        print(json.dumps({"soak": res}))
        return 0
    if "--protocols-only" in sys.argv[1:]:
        # the demo, the sweep and the training attribution at the JAX
        # scripts' sizes, after the build, writing the committed reports
        res = protocols_full(protocols_only)
        print(card_line())
        print(json.dumps({"protocols": res}))
        return 0
    if "--serving-only" in sys.argv[1:]:
        # the serving bench, the host ceiling and the budget sweep at the JAX
        # scripts' sizes, after the build, writing the committed rows
        res = bench_full(fixture, serving_only)
        print(card_line())
        print(json.dumps({"serving": res}))
        return 0
    if "--profile-only" in sys.argv[1:]:
        # the stage bisects at the JAX scripts' defaults, after the build,
        # writing the committed rows
        res = stage_full(profile_only)
        print(card_line())
        print(json.dumps({"stages": res}))
        return 0
    if "--bench-only" in sys.argv[1:]:
        # bench.py's line at its sizes, after the build, appended to the
        # committed record
        res = headline_full()
        print(card_line())
        print(json.dumps({"headline": res}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--mesh-only" in sys.argv[1:]:
        # phase 12 alone on phase 3's build, the same way; with --cards its
        # mesh entries are distinct cards (2 for serving, 4 for the (2, 2)
        # trainer) instead of cuda:0 repeated
        report = {}
        mesh_phase(mesh_context(fixture), make_gallery(BIG_GALLERY_ROWS), report,
                   cards="--cards" in sys.argv[1:])
        print(card_line())
        print(json.dumps({"mesh": report["mesh"]}))
        return 0

    report = kernel_phase(fixture)
    gal = make_gallery(BIG_GALLERY_ROWS)
    report.update(gallery_kernel_phase(gal))
    ctx = serving_phases(fixture, report)
    large_gallery_phase(ctx, gal, report)
    manager_phase(ctx)
    server_phase(ctx, gal, report)
    int8_phase(ctx, gal, report)
    enrolment_phase(ctx, gal, report)
    offline_phase(gal, report)
    train_phase(fixture, report)
    mesh_phase(ctx, gal, report)
    graph_phase(ctx, gal, report)
    del gal, ctx
    openset_phase(fixture, report)
    detector_phase(fixture, report)
    soak_phase(fixture, report)
    protocols_phase(report)
    bench_phase(fixture, report)
    stage_phase(report)
    t0 = time.perf_counter()
    headline_phase(report)
    print(f"[timing] phase 20 took {time.perf_counter() - t0:.1f} s")
    print(f"[timing] phases 1-20 took {time.perf_counter() - t_start:.1f} s")

    print(card_line())

    sources = {
        "crop_resize": ("facerecognitionpipeline_tpu_torch/csrc/crop_resize.cu",
                        "facerecognitionpipeline_tpu/ops/pallas_crop.py:186"),
        "warp_patches": ("facerecognitionpipeline_tpu_torch/csrc/warp_patches.cu",
                         "facerecognitionpipeline_tpu/ops/pallas_warp.py:150"),
        "gallery_topk": ("facerecognitionpipeline_tpu_torch/csrc/gallery_topk.cu",
                         "facerecognitionpipeline_tpu/ops/pallas_gallery.py:277"),
        "gallery_topk_int8": ("facerecognitionpipeline_tpu_torch/csrc/gallery_topk_int8.cu",
                              "facerecognitionpipeline_tpu/ops/pallas_gallery.py:207"),
        # K3's float32-row case of the same Pallas kernel, on the shared body
        "gallery_topk_f32": ("facerecognitionpipeline_tpu_torch/csrc/gallery_topk_f32.cu",
                             "facerecognitionpipeline_tpu/ops/pallas_gallery.py:277"),
        # no pallas_call: the device-side while_loop of nms_mask
        "nms_fixpoint": ("facerecognitionpipeline_tpu_torch/csrc/nms_fixpoint.cu",
                         "facerecognitionpipeline_tpu/ops/nms.py:96"),
    }
    enrol = report["enrol"]
    offline_launches = report["offline"]["launches"]
    train_launches = report["train"]["launches"]
    mesh_launches = report["mesh"]["launches"]
    openset_launches = report["openset"]["launches"]
    detector_launches = report["detector"]["launches"]
    soak_launches = report["soak"]["launches"]
    protocol_launches = report["protocols"]["launches"]
    bench_launches = report["serving"]["launches"]
    stage_launches = report["stages"]["launches"]
    matcher_launches = {"crop_resize": enrol["launches_k1"], "warp_patches": 0,
                        **enrol["matcher_launches"]}
    # K1's and K2's first designs (one thread per output pixel), as timed when
    # they were the port's kernels: NVIDIA H100 80GB HBM3, 700 W, the same
    # shapes and the same 20-launch event timing. History, not of this run.
    print("[history] first design, ms per step: crop_resize 0.1703, warp_patches 0.0430")
    # K3's and K4's earlier design (wmma on 32-row tiles, a cp.async ring of
    # two, the score tile folded out of shared memory), same card model and
    # limit, same shapes and timing.
    print("[history] earlier design, ms per call: gallery_topk 2.4066, gallery_topk_int8 1.3388")
    # K3 on float32 rows in its first design (its own body: register-staged
    # panels, the wgmma layout's 2 x 16 tile), same card model and limit,
    # 128 x 1 048 576 x 512, k = 3, the same event timing.
    print("[history] first design, ms per call: gallery_topk_f32 5.3435")
    kernels = []
    for name in sources:
        if name == "nms_fixpoint":
            kernels.append(nms_entry(report, sources[name]))
            continue
        # times and bounds are of the shapes one serving step calls the
        # kernel with; the error is the largest over every shape checked
        all_rows = report[name]
        rows = [r for r in all_rows if r.get("in_step", True)]
        bound = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
        by_ops = sum(r["flops"] / r["peak"] for r in rows)
        f32 = name == "gallery_topk_f32"
        kernels.append({
            "name": "k3_f32" if f32 else name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            # launches: over the timed steps of phases 3 (K1, K2) and 5 (K3,
            # K4), and for K3 on float32 rows over phase 9's steps with
            # gallery_impl='streaming'; server_launches: over phase 7's
            # served requests (no server path streams float32 rows);
            # matcher_launches: phase 9 (K1 in the bf16 processor's
            # process_image, K3 and K4 in FaceMatcher.match_faces_batch
            # against 1 048 576 identities); offline_launches: phase 10 (K1
            # in dataset_preprocessor, embedding_generator and
            # run_stress_suite; K3 and K4 in ProbeLabeler against 1 048 576
            # identities). The counts were set to 0 before each of those and
            # read after.
            "launches": matcher_launches[name] if f32 else report["launches"][name],
            "server_launches": None if f32 else report["server_launches"][name],
            "matcher_launches": matcher_launches[name],
            "offline_launches": offline_launches[name],
            # phase 11 (K1 and K2 in the serving step with the trained ir_101
            # weights; K1 in the accuracy recipe's bf16 processors and in the
            # OOD suite's cascade), counted from 0 over 11c
            "train_launches": train_launches.get(name, 0),
            # phase 12 (the mesh of two entries of the card): its mesh steps,
            # the sharded searches and the server on the mesh engine, counted
            # from 0 before each and read after
            "mesh_launches": mesh_launches[name],
            # phase 14 (K1 and K2 in the serving steps with the ir_18 trained
            # there, K1 in its e2e_rank1 processors), counted from 0 over it
            "openset_launches": openset_launches.get(name, 0),
            # phase 15 (K1 and K2 in the serving steps of the cascade trained
            # there, assigned into a captured engine), counted from 0 over it
            "detector_launches": detector_launches.get(name, 0),
            # phase 16 (the served steps of the CLI's worker processes against
            # 65 536 int8 rows, each worker's own counts since it was ready,
            # summed over the generations)
            "soak_launches": soak_launches[name],
            # phase 17 (the demo's float32 cascade, the sweep, the train
            # probes), counted from 0 over it: K5 alone
            "protocol_launches": protocol_launches[name],
            # phase 18 (the bench servers' measured runs: raw I420 from 1 and
            # 4 client processes), counted from 0 over each run: K1, K2 and
            # K5; the bench's 23 students match densely
            "bench_launches": bench_launches[name],
            # phase 19 (the stage bisects: every stage graph's replays and
            # eager calls, the full step's, the gallery rows' steps; 131 072
            # bf16 rows stream through K3), counted from 0 over it
            "stage_launches": stage_launches[name],
            "max_abs_err": max(r["err"] for r in all_rows),
            # ms, plain_ms, bound_ms and library_ms are sums over the call
            # shapes of one serving step (K1: R-net, O-net, align stage A)
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "shapes": [r["shape"] for r in all_rows],
        })
        if name in ("crop_resize", "warp_patches"):
            kernels[-1].update({
                "in_step_device_ms": report["in_step_device_ms"].get(name),
                **{key: (None if any(r[key] is None for r in rows)
                         else sum(r[key] for r in rows))
                   for key in ("ms_again", "device_ms", "cold_device_ms",
                               "library_device_ms", "host_ms")},
            })
        else:  # K3, K4: one call shape per step
            kernels[-1].update({
                key: rows[0].get(key) for key in (
                    "ms_again", "stream_device_ms", "merge_device_ms", "prep_device_ms",
                    "prep_host_ms", "host_ms", "q64_ms", "q64_stream_device_ms")
                if key in rows[0]
            })
        if kernels[-1]["launches"] < 1 or (not f32 and kernels[-1]["server_launches"] < 1):
            fail(f"a main path never launched {name}")
        if name != "warp_patches" and matcher_launches[name] < 1:
            fail(f"phase 9 never launched {name}")
        if name in ("crop_resize", "gallery_topk", "gallery_topk_int8") and \
                offline_launches[name] < 1:
            fail(f"phase 10 never launched {name}")
        if name in ("crop_resize", "warp_patches") and train_launches[name] < 1:
            fail(f"phase 11 never launched {name}")
        if not f32 and mesh_launches[name] < 1:
            fail(f"phase 12 never launched {name}")
        if name in ("crop_resize", "warp_patches") and openset_launches[name] < 1:
            fail(f"phase 14 never launched {name}")
        if name in ("crop_resize", "warp_patches") and detector_launches[name] < 1:
            fail(f"phase 15 never launched {name}")
        if name in ("crop_resize", "warp_patches", "gallery_topk_int8") and \
                soak_launches[name] < 1:
            fail(f"phase 16 never launched {name}")
        if name in ("crop_resize", "warp_patches") and bench_launches[name] < 1:
            fail(f"phase 18 never launched {name}")
        if name in ("crop_resize", "warp_patches", "gallery_topk") and \
                stage_launches[name] < 1:
            fail(f"phase 19 never launched {name}")
    # the pool route (the long lists of K3, K4 and K3 on float32 rows from
    # POOL_MIN_K): its times at top_k 1024 (every top_k in by_k); launches
    # over phase 2's long lists (counted from 0 before them, read after) and
    # phase 10's ProbeLabeler at top_k 65 and 1024
    long = report["long_lists"]
    for name, kind, label in (("gallery_topk", "bf16", "gallery_topk_pool"),
                              ("gallery_topk_int8", "int8", "gallery_topk_int8_pool"),
                              ("gallery_topk_f32", "f32", "k3_f32_pool")):
        rows = [r for r in report[name] if r.get("route") == "pool"]
        at = next(r for r in rows if r["k"] == 1024)
        keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_route_ms",
                "forced_unresolved_ms", "peak_mib", "device_route_peak_mib", "split",
                "device_route_split", "unresolved", "sample_tiles", "sample_rank", "pool_cap")
        kernels.append({
            "name": label, "route": "cuda",
            "source": "facerecognitionpipeline_tpu_torch/csrc/gallery_topk.cuh",
            "replaces": sources[name][1],
            "launches": long["pool_launches"][kind],
            "offline_launches": report["offline"]["pool_launches"].get(kind),
            "max_abs_err": max(r["err"] for r in rows),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "shape": at["shape"],
            "by_k": {r["k"]: {key: r.get(key) for key in keys} for r in rows},
            "crossover": long["crossover"][kind],
            "by_q": long["by_q"][kind],
            "adversarial_unresolved": long["adversarial"][kind],
        })
        if kernels[-1]["launches"] < 1 or (kind != "f32" and
                                          report["offline"]["pool_launches"][kind] < 1):
            fail(f"a main path never took the pool route of {name}")
    print(f"[long] phase 2's long lists took {long['seconds']:.1f} s")
    print(json.dumps({"int8": report["int8"]}))
    print(json.dumps({"enrol": enrol}))
    print(json.dumps({"offline": report["offline"]}))
    print(json.dumps({"train": report["train"]}))
    print(json.dumps({"mesh": report["mesh"]}))
    print(json.dumps({"graph": report["graph"]}))
    print(json.dumps({"openset": report["openset"]}))
    print(json.dumps({"detector": report["detector"]}))
    print(json.dumps({"soak": report["soak"]}))
    print(json.dumps({"protocols": report["protocols"]}))
    print(json.dumps({"serving": report["serving"]}))
    print(json.dumps({"stages": report["stages"]}))
    print(json.dumps({"headline": report["headline"]}))
    print(json.dumps({
        "kernels": kernels,
        **{k: v for k, v in report.items() if k.startswith("step_p50_ms")},
    }))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
