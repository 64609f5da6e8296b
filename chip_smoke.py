#!/usr/bin/env python3
"""Drive metrics_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA device

Phases, each of which raises on failure (exit code 1):

1. The card's name and power limit (nvidia-smi), and the build of every CUDA
   kernel from ``metrics_tpu_torch/csrc`` with nvcc.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it and at edge shapes: the bincount on its dispatched
   path and on each of its two paths (shared-memory, global), at the
   shared-memory threshold and one bin above it, with hot bins, on memory
   full of junk, at N=0 and N=1. Then a sweep of six shapes the port gives
   the bincount (main, large-L, multilabel, binary, one-bin, segmentation),
   both paths:
   device time and device operations per call (torch.profiler; a session that
   records fewer device operations than calls is tried again, and after three
   such sessions the row's device time is null), one launch per call (the wrapper's counter),
   wrapper time (CUDA events) and host time per call, beside the plain
   version, ``torch.bincount`` and the bound. One JSON line
   ``{"bincount_sweep": ...}``. Then the batched form (``mt_bincount_batched``,
   what ``torch.func.vmap`` makes of the bincount) against its plain version,
   bit for bit, in its three regimes (packed, cluster, global) and at their
   edges, ids per row and shared, weighted, more rows than the grid's row axis
   takes; and at ``BATCHED_SHAPES`` (phase 24 (c)'s vmapped suites, a block of
   phase 15's row deltas, clones sharing one id row, phase 25 (b)'s largest
   arena chunk) its plan (regime and split), its time (CUDA events and the
   profiler's device time), the plain version's, one ``torch.bincount`` over
   ids offset by ``row * length`` and the bound. One JSON line
   ``{"bincount_batched_sweep": ...}``.
3. The main path: the headline suite of ``bench.py`` (Accuracy, F1Score,
   ConfusionMatrix, Precision; macro, C=128) on batches of B=8192 softmax
   rows, 5 warm-up and 50 timed ``update`` steps, then ``compute()``, in
   validation modes "first" and "full". Every state and value must equal the
   same suite run on the CPU on the same batches, the kernel launch count
   must equal the ConfusionMatrix update count, and F1Score and Precision
   must share a compute group.
4. The large-L path: the same suite at C=1000 (L = 10**6 bins), B=4096, 10 steps,
   checked against the CPU the same way.
5. The multilabel path: ConfusionMatrix(multilabel=True) at B=8192, C=128
   (2**20 ids into 512 bins a step), 10 steps, its state equal to the CPU's
   and one kernel launch per update.
6. The agreement path, ImageNet-1k width: CohenKappa, MatthewsCorrCoef,
   JaccardIndex (C=1000, L = 10**6 bins), Specificity (macro) and
   HammingDistance in one collection, B=4096 softmax rows a step. The three
   confusion-matrix metrics must share one compute group: the first update
   runs every member to find the groups (three launches), every later one
   launches the kernel once.
7. The segmentation path, Cityscapes width: JaccardIndex (mIoU) and Dice
   (macro, global) with C=19 on B=2 images of 1024 x 2048, preds a float32
   softmax (2, 19, 1024, 2048): N = 4,194,304 ids into L = 361 bins a step,
   one launch a step.
8. The aggregation path: MeanMetric (weighted), SumMetric, MaxMetric,
   MinMetric and CatMetric on per-step loss tensors with NaNs, under each
   ``nan_strategy`` and validation mode, against the CPU; then the five in
   one collection, timed.
9. The curve paths. ``curves_binary``: AUROC, AveragePrecision, ROC and
   PrecisionRecallCurve (binary) in one collection over 64 updates of
   262,144 scores (2**24 in all; Bernoulli(0.03) labels, scores rounded to
   multiples of 2**-12, so long tie runs form), one ``compute()``.
   ``curves_imagenet``: AUROC and AveragePrecision (macro, C=1000),
   CalibrationError (15 bins) and BinnedAveragePrecision (100 thresholds)
   over 50 updates of 1000 softmax rows (the 50,000 ImageNet-1k validation
   rows), one ``compute()``, then the weighted functional AUROC and AP on the
   same arrays (one bincount each). A CPU twin takes every update and holds
   the timed suite's states bit for bit and its calibration error within
   ``CURVE_AREA_ATOL``; the exact curves and areas of the first
   ``CURVES_TWIN_STEPS`` updates' rows (16 of 64, 10 of 50), the weighted
   areas too, are computed on both sides from those rows: curves bit for bit,
   areas within ``CURVE_AREA_ATOL``. The full-data weighted areas are held
   against ``sorted_curves``' on the same arrays (``SORTED_AREA_ATOL``), as
   9c holds the unweighted ones. The binned updates' CPU twin
   runs every batch only if it takes about ``CPU_TWIN_BINNED_S``, else the
   first 5. The ImageNet ``compute()`` is profiled on the device alone (its
   host ops are not traced: the profiler took a minute over them). Reported: update
   ms per step (median of 3 runs, mode "first"), ``compute()`` ms, device
   busy time and idle share of both, the host reads of the device a
   ``compute()`` makes, the 2**24 sort's device time and the binned update's
   (with bounds and peak memory). Then ``sorted_curves``: the sort-based
   binary and multi-class AUROC and AP on both paths' arrays against the
   eager values (``SORTED_AREA_ATOL``), timed against the eager calls.
10. The sync path: the headline, agreement, segmentation and aggregator suites
   (full width, two updates each; the segmentation suite one, ``SYNC_STEPS_OF``:
   its CPU reference takes 9 s an update), a binary AUROC + AveragePrecision suite
   buffering rows of shapes (n,) and (n, 1), a regression suite (Pearson's
   moments of spec None, stacked by the sync; Spearman's ``cat`` rows) and a
   retrieval suite (rows of int64 query ids in list states of spec None, which
   decline the packed lane and sync row by row, as in JAX), a BootStrapper of
   100 Accuracy clones (a wrapper tree: 600 states in one payload), an SSIM
   and UQI suite (buffered image rows), a MeanAveragePrecision (five list
   states of spec None, a row an image), a FrechetInceptionDistance (its
   two feature buffers, spec None), a text suite (WER and BLEU float32 sums,
   chrF's packed uint8 sentences, ROUGE's rows of spec None) and an audio
   suite (PIT and SDR sums) synced across
   processes. First through
   NCCL in a process group of one rank, the sync forced: every state after a
   sync equals the state before it bit for bit, ``unsync`` puts the local
   states back, a coalesced sync is one payload collective (plus one metadata
   collective where a ``cat`` state is packed), and the per-state protocol,
   forced with an explicit ``dist_sync_fn``, gives the same states with two
   collectives a state; both protocols timed. Then two spawned ranks on the
   one card joined by Gloo with CUDA tensors (NCCL refuses two ranks on one
   device), each fed its own batches and losses of an uneven length: their
   ``compute()`` (which syncs) must equal one CPU instance fed every batch of
   both, counts bit-exact and values within atol 1e-6 and rtol 1e-5.
11. ``ranking_imagenet`` (run after phase 9, before the sync): CoverageError,
   LabelRankingAveragePrecision and LabelRankingLoss on multi-label targets
   (1 to 3 positives a row), HingeLoss (Crammer-Singer and one-vs-all, the
   first positive as the class) and KLDivergence (against a second model's
   softmax) over 50 updates of (1000, 1000) softmax rows, one update's scores
   rounded to 2**-12 for ties. LRAP's compare runs in blocks under 256 MiB.
12. ``regression_2p24``: all twelve regression metrics (Tweedie at power 1.5)
   in one collection over 64 updates of 262,144 rows (2**24; targets >= 0
   with 30% zeros, preds > 0), one ``compute()`` (Spearman sorts 2**24 twice);
   then R2Score, ExplainedVariance and MeanSquaredError per output over 16
   updates of (65,536, 16). Spearman's ranks (one sort and its runs) are timed
   beside the two ``searchsorted`` passes they replaced (equal on these rows),
   and with every 97th prediction NaN the card's ranks equal the CPU twin's
   bit for bit and the coefficient is within ``SPEARMAN_ATOL``.
13. ``pairwise_embeddings``: the four pairwise functions on x (4096, 768)
   against y (8192, 768), reduction None and "mean", then x against itself
   (zero diagonal); Manhattan in row blocks under 256 MiB. The CPU twin
   computes the first ``PAIRWISE_CPU_ROWS`` rows.
14. ``retrieval_msmarco``: ten retrieval metrics in one collection over
   6,980 queries x 1,000 candidates (MS MARCO dev-small re-ranking; 70
   updates of 100 queries, the last of 80; scores rounded to 2**-10; about 1% of queries
   with no relevant passage), one ``compute()`` and a second that must give
   the same bits; a graded NDCG (0 to 3); the nine one-query functions on
   100 queries. Each query grouping counts its rows with the bincount kernel.
   The CPU twin computes all 70 updates only if that takes about
   ``RETRIEVAL_CPU_TWIN_S``, else the first 10 against a card suite fed the
   same 10.
15. ``wrappers_imagenet`` (after phase 14): over the same 50 x 1000 x 1000
   ImageNet-1k rows, BootStrapper(Accuracy, macro) with 100 clones under each
   sampling strategy (quantiles 0.025 and 0.975, raw values), BootStrapper
   (ConfusionMatrix) with 20 clones (one bincount launch a clone's update),
   ClasswiseWrapper(Accuracy, per class) with 1000 label names, MinMaxMetric
   (Accuracy) driven by ``forward``, and 2PR / (P + R) of macro Precision and
   Recall; a MetricTracker over a collection of such metrics for 5 epochs of
   10 updates and its ``best_metric(return_step=True)``; then
   MultioutputWrapper(R2Score) over phase 12's multi-output rows with a NaN in
   1% of the rows (``remove_nans``). The bootstrap draws come from the card's
   generator and are recorded and replayed to the CPU twin. The BootStrappers,
   MinMaxMetric and the MultioutputWrapper take their fused paths (one program
   over the clones, ``torch.func.vmap``; the Poisson and ``remove_nans`` paths as
   weighted per-row deltas, certified on their first steps): three timed runs in
   mode "first" and one with the fused path turned off, each with its ms/step
   (and the steady state's from update ``WRAPPER_STEADY_FROM``), launches
   (unbatched and batched), peak extra device memory and, for the fused path,
   a steady update's host reads; the CPU twin runs in mode "full" (the eager
   path, which the fused paths decline), and at the end every fused path is
   still engaged, healthy and undemoted.
16. ``image_restoration``: PSNR (range 1, and the observed range), SSIM,
   MS-SSIM and UQI in one collection over 200 image pairs of 3 x 512 x 512 in
   20 updates (DIV2K's 100 validation images as two crops each; a noisy
   target near 30 dB), the three buffering metrics one compute group; SSIM's
   depthwise convolution at (1000, 3, 522, 522) and MS-SSIM's pyramid beside
   their bounds; then ERGAS, SAM and D-lambda over 32 four-band 256 x 256
   pan-sharpening patches. The CPU twin takes every image only if that takes
   about ``IMAGE_CPU_TWIN_S``, else the first updates that fit.

17. ``generative_ffhq256`` (after phase 16): an FID-10k evaluation of a 256 x 256
   generator (FFHQ-256, LSUN): 10,000 real and 10,000 generated uint8 images
   of 3 x 256 x 256 made on the card from a seed, in updates of 200, through
   FrechetInceptionDistance(2048), KernelInceptionDistance (its defaults: 100
   subsets of 1,000) and InceptionScore (``logits_unbiased``, 10 splits, over
   the generated half), each InceptionV3 with the same seeded random weights
   (``allow_random_weights=True``: published weights are not in the
   repository); LPIPS ``alex`` over 2,000 pairs of 3 x 256 x 256 in [-1, 1]
   (updates of 100), ``vgg`` and ``squeeze`` over 200 each; one extractor call
   of 3 x 512 x 512 images (the antialiased downsampling). Reported: update ms,
   extractor images/s, each ``compute()`` (first and again) with its peak extra
   memory, host reads and copies, the InceptionV3 forward, FID's float64
   ``eigh`` and a KID subset's products beside their bounds. The CPU twins:
   the same weights moved to the CPU featurise ``GEN_FEATURE_TWIN`` images of
   the first update and the 512 x 512 images (``FEATURE_RTOL`` of the scale)
   and score each backbone's first ``LPIPS_TWIN_PAIRS`` pairs (``LPIPS_ATOL``);
   FID, KID (``KID_CPU_SUBSETS`` subsets, against the card's KID at as many)
   and IS run on the CPU from the card's own features (``GEN_RTOL``,
   ``IS_RTOL`` relative; IS's spread ``IS_STD_ATOL`` absolute).
18. ``detection_coco``: COCO val2017 bbox evaluation of a detector's top-100
   output: 5,000 images, 80 classes, Poisson(7.36) ground-truth boxes an image
   in COCO's small/medium/large mix, 100 scored detections an image (jittered
   ground truth and false positives), ``xywh``, updates of 8 images,
   ``class_metrics``; then ``iou_type="segm"`` over 100 images of 480 x 640
   instance masks (up to 20 an image). Reported: update ms, ``compute()`` s,
   host reads and copies, how many (image, class) IoU cells took the device.
   The same inputs through the port on the CPU must give every value within
   ``MAP_ATOL`` (bit for bit expected).
19. ``text_eval`` (after phase 18): the host text library built from
   ``csrc/text_kernels.cpp`` (timed), then, every input made from a seed:
   ASR at LibriSpeech test-clean shape (2,620 utterances of about 20 words,
   10% edits; WER, CER, MER, WIL, WIP in updates of 32); MT at WMT14
   newstest2014 en-de shape (3,003 sentences of about 27 words; BLEU-4,
   SacreBLEU 13a, chrF++, TER, EED in updates of 64); ROUGE-1/2/L/Lsum at
   CNN/DailyMail test shape (11,490 pairs of 3 to 4 sentences, cut to
   ``SUMM_CUT_PAIRS`` if all would take more than ``SUMM_FULL_S``); SQuAD v1.1
   dev shape (10,570 questions); Perplexity at GPT-2 small's shape (16
   updates of 8 x 1024 x 50,257 float32 logits, 5% ignored, then one bfloat16
   batch) beside its bytes bound and ``F.cross_entropy``; BERTScore over the
   3,003 MT pairs through a seeded 1,024-wide word table; InfoLM over 256
   pairs through a seeded stub masked LM (not a transformer). Each family
   against its CPU twin (``TEXT_HOST_RTOL``, ``TEXT_DEVICE_RTOL``; states bit
   for bit), with update and ``compute()`` ms, host reads and copies, the
   library's dynamic programs, and 0 bincount launches.
20. ``audio_separation``: PIT(SI-SDR) with SI-SNR and SNR of the permuted
   estimates at WSJ0-2mix shape (3,000 mixtures of 2 x 32,000 samples) and
   WSJ0-3mix (500), every permutation the true one and the CPU's; SDR (512
   taps) over 500 clips by the solve and by 10 conjugate-gradient steps, 50
   clips in float64, the solve and the FFTs beside their bounds; STOI over 100
   clips of 3 s at 16 kHz and ESTOI over 20; PESQ's ``ModuleNotFoundError``
   where ``pesq`` is absent. Tolerances in dB beside their constants.

21. ``observability_journal`` (after the sync): the headline suite of phase 3
   with telemetry armed and disarmed (``set_telemetry``), alternating for 3
   trials: ms/step of each, spans per step by site, none when disarmed, one
   bincount launch a ConfusionMatrix update, states equal to the CPU twin bit
   for bit. The state journal at real sizes: (a) that suite, (b) phase 9's
   ImageNet curves suite after all 50,000 x 1000 rows, (c) phase 15's
   BootStrapper of 100 clones: save and load ms, record bytes and the copy
   calls of each (one device-to-host copy a save, one host-to-device copy a
   load); every state of the restored tree byte for byte, its ``compute()``
   equal to the uninterrupted run, the record loaded into a CPU twin (equal to
   the CPU run for (a)), and for (c) 5 more updates after the restore drawing
   what the uninterrupted BootStrapper draws. Fault drills: ``sync-pack``
   injected into the suite and its members in a NCCL world of one (the sync
   falls back to the per-state protocol, two collectives a state, with the
   coalesced sync's states, and re-promotes to one payload collective after
   ``recovery_steps()`` clean syncs); ``journal-write`` (the generation ring
   byte-identical); ``journal-load`` and a flipped byte in the newest
   generation (each restores generation 1, one load demotion). Then
   ``prometheus_text()`` and ``export_trace()`` timed, with their bytes. Under
   60 s.
22. ``sync_planes`` (after phase 21), under 90 s: (a) phase 3's headline suite
   (C=128, B=8192) in a NCCL world of one: the ``sync-gather`` retry drill
   (two injected faults under ``METRICS_TPU_SYNC_RETRIES=3``, states bit-equal
   to the clean sync); the deadline drill (the payload seam slowed past
   ``METRICS_TPU_SYNC_DEADLINE_MS``, without touching NCCL, raises
   ``SyncTimeoutFault``, the states stay, the next sync is clean); the
   ``local`` degraded tier (``compute()`` serves the local values,
   ``sync_health()`` reads degraded, the suite re-promotes on its
   ``recovery_steps()``-th ``compute()``); ``sync_async`` with 5 updates in
   flight (the forced states bit-equal to a blocking sync at dispatch, the
   updates back after ``unsync``; blocking and async ms and the share of the
   wire hidden); the bf16 and int8 tiers on phase 12's regression and
   multi-output suites (bytes shipped against the exact lane, integer states
   exact, values within ``PLANES_QUANT_ATOL``/``PLANES_QUANT_RTOL``) and both
   encodes of 2**24 floats beside their byte bounds. (b) Three spawned Gloo
   ranks with CUDA tensors on the one card, uneven batches: a
   ``checkpoint_barrier`` stamps one (epoch, barrier_step) in every manifest;
   rank 2 stops (its heartbeat file goes, it parks without closing its
   sockets); the survivors' ``compute()`` times out twice, the prober
   declares rank 2 dead, and the ``quorum`` tier's values equal one CPU suite
   fed ranks 0 and 1 (counts bit-exact, floats within atol 1e-6 and rtol
   1e-5); a fresh process ``rejoin``s from rank 2's record into the epoch the
   survivors reach. (c) Four spawned Gloo ranks, two a node
   (``METRICS_TPU_SYNC_HIER=2``, seams bound to ``dist.new_subgroups`` and a
   group of the node leaders): the headline suite's integer states on the
   psum lane bit-equal to the flat gather with half its inter-node bytes.
   (d) Phase 9's 2**24 binary scores through AUROC and AveragePrecision with
   ``compute_on_cpu=True`` and without: peak device memory of the updates
   and of ``compute()``, ms an update, the values bit-equal.
23. ``engine`` (after phase 22), under 60 s, validation mode "first": (a)
   phase 3's headline suite (B=8192, C=128) over 5 warm-up and 128 timed
   updates three ways: per call (deferral off), deferred (``compute()`` in
   the timed window) and one ``update_many`` over the (128, 8192, 128)
   stack; each way's ms per step, bincount launches (128 each), host reads
   of 16 updates (a flush of 16, a chunk of 16: no more than per call),
   deferred steps and flushes, and peak extra device memory (the queue's
   copies); the three ways' states bit-equal, and a deferred card suite's
   equal to the CPU twin over the first steps that fit ``CPU_TWIN_S``. (b)
   32 forwards under deferral: the lazy values, read after, bit-equal to
   per-call forwards. (c) ``forward_many`` over phase 9's ImageNet-1k rows
   (50 x 1000 x 1000) through the suite at C=1000, each step's values equal
   to 50 forwards. (d) The host lanes: phase 9's binary curve suite and phase
   14's MS MARCO suite (16 updates each), phase 19's SQuAD updates: host µs
   a lane update against the first, validated one, SQuAD's copies to the
   card an update, the rows and sums bit-equal to the CPU twin. (e) The
   device probe at every=1 on (a)'s flushes: the device-inclusive walls
   beside the host walls. (f) ``flush-chunk-2`` injected (an eager replay,
   one fallback, states bit-equal) and ``compile`` injected on a cache miss
   (counted, the updates run).

24. ``functional_core`` (after phase 23), under 60 s, validation mode "first": (a)
   phase 3's headline suite (B=8192, C=128) through ``init``, ``apply_update`` x 128
   and ``apply_compute``: ms/step, 128 launches, host reads of 16 updates (0), the
   states and values bit-equal to the stateful per-call path and to the CPU twin
   over the first steps that fit ``CPU_TWIN_S``. (b) The same ``apply_update``
   captured once in a ``torch.cuda.CUDAGraph`` and replayed for every batch (the
   inputs copied into the captured buffers): ms/step, the states bit-equal. (c)
   ``torch.func.vmap`` of ``apply_update`` over ``FUNCORE_STACK`` stacked suites
   for ``FUNCORE_VMAP_STEPS`` calls: each suite bit-equal to its own run, one
   batched bincount launch a call. (d) ``apply_compute(axis_name=...)`` in the NCCL
   world of one (a ``ProcessGroup``, a ``DeviceMesh``, a ``(mesh, dim)`` pair; a
   bare string raises ``SyncConfigFault``) and in a spawned two-rank Gloo world on
   the card: one functional collective a state, no host read in the merge, the
   merged states and the values equal ``sync_pytree``'s. (e) ``host_handoff``
   merged (``compute()`` then issues 0 collectives in a world that syncs) and with
   a stale epoch (``EpochFault``, the states intact).

25. ``tenant_planes`` (after phase 24), under 90 s, validation mode "first": (a)
   a ``MetricArena`` of ``Accuracy(num_classes=2)`` + ``MeanMetric`` at
   ``TENANT_TIERS`` (100,000 and 1,000,000 tenants, 8 rows a tenant an update,
   slab 1024: bench.py's tiers), ``TENANT_STEPS`` timed updates of every
   tenant: ms a step, tenant-updates/s, the engine's builds (one a chunk size:
   bounded by the buckets and chunk sizes, not the tenants), peak extra device
   memory, device ms a step and idle share; the first ``TENANT_TWIN`` tenants
   equal a CPU twin. (b) A ``ConfusionMatrix(10)`` arena of 100,000 tenants:
   one batched bincount launch a pow2 chunk, the counts bit-equal to the CPU
   twin, against a per-instance loop over 256 metrics. (c) One-at-a-time adds
   across slab boundaries (``retraces_per_add``), ``reset(mask)``, ``save`` and
   ``restore`` of every slab bit for bit (``slab_record_bytes``) with a torn
   slab falling back to its previous generation, ``close_window``,
   ``decay_tick`` and ``cohort_drift`` over two cohorts against a CPU twin.
   (d) ``Windowed(headline suite, window=8)`` over 32 updates of phase 3's
   shape: 4 closes, the window value and its journal restore equal a fresh
   suite's; ``Decayed`` refuses the suite's integer counts and runs over a
   ``MeanMetric`` of the confidences; ``drift_report`` between the first and
   the last window's confidences through the plain kernel. (e)
   ``IngestGateway`` into a ``MeanMetric`` arena at bench.py's setting (256
   tenants, 64 payloads, a 2x overload): admitted rows/s (the admitted count of
   the timed window over its time), offer p50/p99 us, the shed fraction, the
   settlement identity exactly. (f) The headline suite's states placed by
   ``shard_states`` on a NCCL ``DeviceMesh`` of one, updated and computed equal
   to the unsharded run; a spawned two-rank Gloo world on the CPU splits
   ``ConfusionMatrix(1000)`` on its class axis, half on each rank: with each
   rank's own batches the values equal an unsharded run of both ranks' rows,
   and with the same batches replicated they equal one rank's unsharded run;
   PearsonCorrCoef's moments (reduction None, placed by
   ``infer_state_pspecs``) updated with each rank's own rows equal an unsharded
   run of both ranks' rows within 1e-5.
26. ``planes_ledger_autotune`` (after phase 25), under 90 s: (a) ``perf_report``
   over phase 3's suite (94 updates, a queue of 4, telemetry armed, a device
   probe every 8 program runs): its coverage of the measured wall within
   ``perf.TOLERANCE``, its phase columns, the probed states bit-equal to an
   unprobed run's. (b) ``roofline_peaks()`` calibrated on the card and
   ``program_report(analyze=True)`` with each program's bound class. (c) The
   autotuner's sweeps, each installed winner held to the reference under its
   contract: ``binned_counts`` at ImageNet width (N = C = 1000, T = 100; each
   variant's device time by the profiler, the hand kernel's launches in the
   ``segment_sum`` candidate and in the selected path, TP/FP/FN bit for bit),
   ``auroc_sort``/``ap_sort`` at 2**20 scores, ``fid_sqrtm`` at 2048 x 2048
   float64, ``map_box_iou`` through mAP's call site over 24 COCO-like images.
   (d) The program cache across three fresh spawned processes on the card,
   each timing its first headline update: the first stores (cold: nothing
   warmed), the second boots warm with the store on (``precompile`` of small
   batches acquires the programs, ``warm_programs`` runs every stored shape;
   ``autotune_restores`` > 0, ``autotune_sweeps`` = 0; then ``precompile`` of
   the stored shapes finds them all), the third is the control with the store
   off (``precompile`` of the update's own shapes). (e) ``fleet_snapshot``, ``fleet_perf_report`` and
   ``fleet_prometheus_text`` over two spawned Gloo ranks with CUDA tensors,
   rank 1's pack slowed: the straggler report names it; ``fleet_health`` of a
   world of one issues no collective.

Deferral is on by default (the engine queues calls in every validation mode
but "full"), so every timed window that updates in mode "first" ends with
``settle(owners)``: the owners' queues flush, then the card synchronises,
and the times, launch counts and memory peaks include the queued work.

Phases 15 and 16 report what phases 11 to 14 do, and hold every state and
value against a CPU twin fed the same batches and the same bootstrap draws:
counts and buffered rows bit for bit, floats within the tolerances stated
beside their constants.

Paths 6 and 7 run in validation modes "first" and "full" (3 alternating
trials each), equal the CPU on the same batches (counts bit-exact, values
within rtol 1e-5) and report steps/s, device ms/step by kernel and the
device's idle share. Paths 11 to 14 hold every state and value against a CPU
twin fed the same batches (counts, ranks and hits bit for bit; floats within
the tolerances stated beside their constants) and report update ms per step
(median of 3 runs, mode "first"), ``compute()`` ms (the first and the next),
device time and idle share (torch.profiler), the host reads a ``compute()``
makes, peak extra device memory and bincount launches, and the device time
of the grouping sort, the segmented scan, the LRAP compare and the Spearman
sort beside their bounds.

Output: labelled lines, then a JSON line ``{"kernels": [...]}`` (``bincount``
and ``bincount_batched``), then the nvidia-smi line, then ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4  # weighted bincount: float32 atomics in run-dependent order
PROFILE_ATTEMPTS = 3  # profiler sessions tried before a sweep row's device time is "not measured"


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call of ``fn`` on the card, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels(native, histogram) -> float:
    t0 = time.perf_counter()
    path = native.build(histogram.SOURCE)
    seconds = time.perf_counter() - t0
    log(f"build: {histogram.SOURCE} -> {path.relative_to(HERE)} in {seconds:.2f} s")
    log(path.with_suffix(".log").read_text().strip())
    return seconds


# ------------------------------------------------------------------ phase 2
def multilabel_ids(g, batch: int, num_classes: int):
    """The multilabel ConfusionMatrix's ids: ``(2*target + preds) + 4*class``, N = B*C into L = 4C."""
    dev = torch.device("cuda")
    target = torch.randint(0, 2, (batch, num_classes), generator=g, device=dev)
    preds = torch.randint(0, 2, (batch, num_classes), generator=g, device=dev)
    return ((2 * target + preds) + 4 * torch.arange(num_classes, device=dev)).reshape(-1)


def dirty_call(histogram, x, length, weights):
    """``fused_bincount`` on memory full of junk: a same-size block is filled,
    freed and handed back by the allocator as the counts."""
    dtype = torch.int32 if weights is None else torch.float32
    junk = torch.full((length,), -12345, dtype=dtype, device=x.device)
    ptr = junk.data_ptr()
    del junk
    got = histogram.fused_bincount(x, length, weights=weights)
    assert got.data_ptr() == ptr, "dirty memory: the allocator did not hand back the junk block"
    return got


def check_bincount(histogram) -> float:
    """Hold the kernel against its plain version on both paths at every shape.
    Returns the largest |error| of a weighted sum."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = []  # (label, ids, length, weights, weighted sums exact)

    def rand_ids(n, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dtype)

    def rand_w(n):
        return torch.rand(n, generator=g, device=dev)

    def dyadic(n):  # multiples of 1/2: every partial sum here is exact in float32, in any order
        return torch.randint(1, 5, (n,), generator=g, device=dev).float() * 0.5

    big = 1 << 20
    top = histogram.SHARED_MAX_BINS
    # the main path's shape and dtype: ConfusionMatrix, C=128, B=8192, argmax labels (int64)
    main_x = rand_ids(8192, 0, 128**2)
    cases.append(("main N=8192 L=16384 int64", main_x, 128**2, rand_w(8192), False))
    cases.append(("main N=8192 L=16384 int32", main_x.to(torch.int32), 128**2, rand_w(8192), False))
    cases.append(("imagenet N=8192 L=1e6", rand_ids(8192, 0, 10**6), 10**6, rand_w(8192), False))
    cases.append((f"threshold L={top}", rand_ids(big, -5, top + 5), top, rand_w(big), False))
    cases.append((f"threshold+1 L={top + 1}", rand_ids(big, -5, top + 6), top + 1, rand_w(big), False))
    cases.append(("multilabel N=2**20 L=512", multilabel_ids(g, 8192, 128), 512, rand_w(big), False))
    cases.append(("binary N=2**20 L=4", rand_ids(big, 0, 4), 4, dyadic(big), True))
    # one bin takes every id: worst-case contention
    same = torch.full((big,), 7, dtype=torch.int64, device=dev)
    cases.append(("contention N=2**20 one bin", same, 128**2, dyadic(big), True))
    cases.append(("out of range N=8192", rand_ids(8192, -(128**2), 2 * 128**2, torch.int32), 128**2, rand_w(8192), False))
    wide = torch.tensor([2**32 + 5, 2**31, 2**31 + 7, -(2**40), 5, 2**33], dtype=torch.int64, device=dev)
    wide = torch.cat([wide, rand_ids(4096, 0, 64)])
    cases.append(("int64 beyond 2**31", wide, 64, rand_w(wide.numel()), False))
    cases.append(("N=1", rand_ids(1, 0, 10), 10, rand_w(1), False))
    cases.append(("N=0", rand_ids(0, 0, 10), 10, rand_w(0), False))

    max_abs_err = 0.0
    for label, x, length, w, exact in cases:
        want = histogram._bincount_plain(x, length)
        want_w = histogram._bincount_plain(x, length, w)
        # the dispatched path (what the main path calls), then the global path at the same shape
        runs = [("dispatched", lambda w_: histogram.fused_bincount(x, length, weights=w_))]
        runs.append(("global", lambda w_: histogram._launch(x, length, w_, False)))
        if length <= histogram.SHARED_MAX_BINS:
            runs.append(("shared", lambda w_: histogram._launch(x, length, w_, True)))
        errs = []
        for path, run in runs:
            before = histogram.KERNEL_LAUNCHES
            got, got_w = run(None), run(w)
            assert histogram.KERNEL_LAUNCHES == before + 2, f"bincount {label} ({path}): not one launch per call"
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), f"bincount {label} ({path}): counts differ"
            if exact:
                assert torch.equal(got_w, want_w), f"bincount {label} ({path}): dyadic weighted sums differ"
            else:
                torch.testing.assert_close(got_w, want_w, rtol=RTOL, atol=ATOL, msg=f"bincount {label} ({path})")
            errs.append(float((got_w - want_w).abs().max()) if length else 0.0)
        max_abs_err = max(max_abs_err, *errs)
        log(f"bincount {label}: unweighted exact on {len(runs)} paths, weighted max |err| {max(errs):.3g}"
            + (" (dyadic: exact)" if exact else ""))
    wide_counts = histogram.fused_bincount(wide, 64)
    assert int(wide_counts[5]) == 1 + int((wide[6:] == 5).sum()), "an int64 id beyond 2**31 was counted"

    # dirty memory: the counts come from torch.empty, so the kernel must write every bin
    for label, x, length in (("main (shared path)", main_x, 128**2), ("L=1e6 (global path)", cases[2][1], 10**6)):
        for w in (None, torch.ones(x.numel(), device=dev)):
            got = dirty_call(histogram, x, length, w)
            torch.cuda.synchronize()
            assert torch.equal(got, histogram._bincount_plain(x, length, w)), f"dirty memory {label}: differs"
        log(f"bincount dirty memory {label}: the junk block was handed back and overwritten exactly")
    return max_abs_err


def host_us_per_call(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host microseconds per call of ``fn`` over ``iters`` calls that end in one synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def sweep_bincount(histogram, card: str) -> list:
    """Both paths of the kernel, the plain version and torch.bincount at the shapes the port
    gives it, unweighted and with int64 ids, as the ConfusionMatrix calls it."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    big = 1 << 20
    shapes = [
        ("main", torch.randint(0, 128**2, (8192,), generator=g, device=dev), 128**2),
        ("large-L", torch.randint(0, 10**6, (4096,), generator=g, device=dev), 10**6),
        ("multilabel", multilabel_ids(g, 8192, 128), 512),
        ("binary", torch.randint(0, 4, (big,), generator=g, device=dev), 4),
        ("one-bin", torch.full((big,), 7, dtype=torch.int64, device=dev), 128**2),
        # JaccardIndex at Cityscapes width: 2 x 1024 x 2048 pixel ids into 19**2 bins
        ("segmentation", torch.randint(0, 19**2, (2 * 1024 * 2048,), generator=g, device=dev), 19**2),
    ]
    rows = []
    for name, x, length in shapes:
        bytes_moved = x.numel() * x.element_size() + 4 * length  # ids read once, counts written once
        # bytes bound it: a compare and an add an id are far below the card's operation rate
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, 2 * x.numel() / FP32_OPS_PER_S) * 1e3
        row = {"shape": name, "n": x.numel(), "length": length, "bytes": bytes_moved, "bound_ms": bound_ms,
               "dispatched_path": histogram.kernel_path(length)}
        paths = [("dispatched", lambda: histogram.fused_bincount(x, length))]
        if row["dispatched_path"] != "global":
            paths.append(("global", lambda: histogram._launch(x, length, None, False)))
        for path, fn in paths:
            # A profiler session now and then records no device rows, or loses some of them
            # (fewer device operations than calls: every call launches once, as the launch
            # counter, not the profiler, proves); such a session is taken again.
            for attempt in range(1, PROFILE_ATTEMPTS + 1):
                before = histogram.KERNEL_LAUNCHES
                prof = device_profile([fn] * 52)
                assert histogram.KERNEL_LAUNCHES - before == 52, f"bincount sweep {name} ({path}): not one launch per call"
                seen = sum(k for _, k in prof.values())
                if seen >= 50:
                    break
                log(f"bincount sweep {name} ({path}): the profiler saw {seen} device operations of 50 calls "
                    f"(attempt {attempt})")
                prof = {}
            # None: no session recorded every call's device operation, so it was not measured
            device_ms = sum(ms for ms, _ in prof.values()) / 50 if prof else None
            ops = sum(k for _, k in prof.values()) / 50 if prof else None
            if prof and path == "dispatched":
                assert ops == 1.0, f"bincount sweep {name}: {ops} device operations per call, not 1: {prof}"
            row[path] = {
                "device_ms": device_ms,
                "device_ops_per_call": ops,
                "share_of_bound": bound_ms / device_ms if device_ms else None,
                "wrapper_ms": cuda_time_ms(fn),
                "host_us_per_call": host_us_per_call(fn),
                "device_rows": {k[:60]: v for k, v in prof.items()},
            }
        row["plain_ms"] = cuda_time_ms(lambda: histogram._bincount_plain(x, length))
        # every swept id is in range, so torch.bincount computes the same function on them
        row["library_ms"] = cuda_time_ms(lambda: torch.bincount(x, minlength=length))
        rows.append(row)
        summary = {p: {k: row[p][k] for k in ("device_ms", "device_ops_per_call", "wrapper_ms", "host_us_per_call")}
                   for p in ("dispatched", "global") if p in row}
        log(f"bincount sweep {name} N={x.numel()} L={length}: {json.dumps(summary)}, plain {row['plain_ms']:.5f} ms, "
            f"torch.bincount {row['library_ms']:.5f} ms, bound {bound_ms:.6f} ms  [{card}]")
    return rows


def kernel_entry(sweep: list, max_abs_err: float) -> dict:
    """The kernels line's entry: the dispatched path at the main-path shape."""
    main = next(r for r in sweep if r["shape"] == "main")
    return {
        "name": "bincount",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/bincount.cu",
        "replaces": "metrics_tpu/ops/histogram.py:36",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_abs_err,
        "ms": main["dispatched"]["wrapper_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }


# ---- the batched form (phase 2): what torch.func.vmap makes of the bincount
# (name, rows, ids a row, bins, ids shared by every row): phase 24 (c)'s vmapped suites, a block of
# BootStrapper(ConfusionMatrix(1000))'s row deltas (phase 15), clones sharing one id row, and the largest
# pow2 chunk of phase 25 (b)'s ConfusionMatrix(10) arena of 100,000 tenants
BATCHED_SHAPES = [("vmap_suites", 8, 8192, 128**2, False), ("row_deltas_confmat", 33, 1, 10**6, False),
                  ("shared_ids", 100, 1000, 1000, True), ("arena_chunk", 65536, 8, 100, False)]


def check_batched_bincount(histogram) -> float:
    """The batched kernel against its plain version in its three regimes and at their edges (a packed row of
    2048 bins and 2048 ids and one more of either, 64 ids a bin and one fewer between the cluster and global
    regimes, k x 32768 bins and one more for the card's largest cluster k, more rows than the grid's row axis
    takes, one id a row, no ids), shared and per-row ids, int32 and int64, weighted (dyadic weights: every sum
    exact in any order), and a cluster slice above 32768 bins refused; the largest absolute difference (0
    expected, asserted)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    k, top = histogram.max_cluster(0), histogram.SHARED_MAX_BINS
    regimes = set()
    for rows, n, length in ((1, 0, 5), (3, 1000, 361), (8, 8192, 32768), (8, 8192, 32769), (5, 4096, 10**6),
                            (70000, 16, 4), (33, 1, 10**6), (2, 2048, 2048), (2, 2049, 2048), (2, 2048, 2049),
                            (4, 2048, k * top), (4, 2048, k * top + 1), (65536, 8, 100), (70000, 2, 2100),
                            (100, 1000, 1000), (4, 4096, 64), (4, 4095, 64), (8, 2**17, 4), (132, 16384, 1000)):
        regimes.add(histogram.batched_plan(rows, n, length, k).regime)
        for shared in (False, True):
            for dtype in (torch.int64, torch.int32):
                x = torch.randint(-3, length + 3, (1 if shared else rows, n), generator=g, device=dev).to(dtype)
                w = torch.randint(1, 5, x.shape, generator=g, device=dev).float() * 0.5
                for weights in (None, w):
                    got = histogram.bincount_batched_cuda(x, length, weights, rows)
                    want = histogram._bincount_batched_plain(x, length, weights, rows)
                    assert got.dtype == want.dtype and got.shape == want.shape, (rows, n, length)
                    worst = max(worst, float((got.double() - want.double()).abs().max()) if got.numel() else 0.0)
    # the cluster regime's shared-memory edge, forced: k x 32768 bins in k slices of 32768, and a refusal above
    x = torch.randint(-3, k * top + 3, (4, 2048), generator=g, device=dev)
    plan = histogram.BatchedPlan("cluster", k, 4, top)
    got = histogram._launch_batched(x, k * top, None, 4, plan)
    worst = max(worst, float((got.double() - histogram._bincount_batched_plain(x, k * top, None, 4).double()).abs().max()))
    try:
        histogram._launch_batched(x, k * top + 1, None, 4, plan._replace(slice=top + 4))
        raise AssertionError("batched bincount: a cluster slice above 32768 bins was launched")
    except RuntimeError:
        pass
    torch.cuda.synchronize()
    assert worst == 0.0, f"batched bincount: max |kernel - plain| {worst}"
    assert regimes == {"packed", "cluster", "global"}, regimes
    log(f"batched bincount: bit-exact against the plain version on every shape, in regimes {sorted(regimes)} "
        f"(largest cluster {k}; max |err| {worst})")
    return worst


def sweep_batched_bincount(histogram, card: str) -> list:
    """The batched kernel at ``BATCHED_SHAPES``: its plan (regime and split), wrapper ms (CUDA events, one
    launch a call), device ms (the profiler), the plain version, one ``torch.bincount`` over ids offset by
    ``row * length`` (the same function) and the bytes bound (ids read once, ``4 * rows * length`` bytes of
    counts written)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for name, rows, n, length, shared in BATCHED_SHAPES:
        x = torch.randint(0, length, (1 if shared else rows, n), generator=g, device=dev)
        bytes_moved = x.numel() * x.element_size() + 4 * rows * length
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, 2 * rows * n / FP32_OPS_PER_S) * 1e3
        call = lambda: histogram.bincount_batched_cuda(x, length, None, rows)  # noqa: E731
        before = histogram.BATCHED_LAUNCHES
        ms = cuda_time_ms(call, iters=50, warmup=5)
        assert histogram.BATCHED_LAUNCHES - before == 55, f"batched bincount {name}: not one launch a call"
        prof = {}
        for _ in range(PROFILE_ATTEMPTS):  # a session that lost device rows is taken again, as in the sweep above
            prof = device_profile([call] * 52)
            if sum(k for _, k in prof.values()) >= 50:
                break
            prof = {}
        offsets = torch.arange(rows, device=dev).unsqueeze(1) * length
        flat = (x.expand(rows, n) + offsets).reshape(-1)
        plan = histogram.batched_plan(rows, n, length, histogram.max_cluster(0))
        row = {"shape": name, "rows": rows, "n": n, "length": length, "shared_ids": shared, "bytes": bytes_moved,
               "bound_ms": bound_ms, "regime": plan.regime, "split": plan.split, "plan": plan._asdict(), "ms": ms,
               # None: no session recorded every call's device operation
               "device_ms": sum(v for v, _ in prof.values()) / 50 if prof else None,
               "device_ops_per_call": sum(k for _, k in prof.values()) / 50 if prof else None,
               "plain_ms": cuda_time_ms(lambda: histogram._bincount_batched_plain(x, length, None, rows), 50, 5),
               "library_ms": cuda_time_ms(lambda: torch.bincount(flat, minlength=rows * length), 50, 5)}
        out.append(row)
        log(f"batched bincount {name}: rows={rows} n={n} L={length} ({plan.regime}, split {plan.split}: "
            f"{'rows a block' if plan.regime == 'packed' else 'CTAs a row'}): {ms:.5f} ms (device "
            f"{row['device_ms']} ms, {row['device_ops_per_call']} operations a call), plain "
            f"{row['plain_ms']:.5f} ms, torch.bincount {row['library_ms']:.5f} ms, bound {bound_ms:.6f} ms  [{card}]")
    return out


def batched_kernel_entry(sweep: list, max_abs_err: float) -> dict:
    """The kernels line's entry for the batched form, at phase 24 (c)'s shape."""
    main = next(r for r in sweep if r["shape"] == "vmap_suites")
    return {
        "name": "bincount_batched",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/bincount.cu",
        "replaces": "metrics_tpu/ops/histogram.py:36",
        "launches": None,  # filled from the paths' runs
        "max_abs_err": max_abs_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }


# ------------------------------------------------------------------ phases 3 and 4
def make_suite(mt, num_classes: int, device: str):
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=num_classes, average="macro", device=device),
            "f1": mt.F1Score(num_classes=num_classes, average="macro", device=device),
            "confmat": mt.ConfusionMatrix(num_classes=num_classes, device=device),
            "precision": mt.Precision(num_classes=num_classes, average="macro", device=device),
        }
    )


def make_batches(batch: int, num_classes: int, steps: int, seed: int, signal: float = 0.0, spatial=(),
                 device: str = "cuda"):
    """Softmax preds (B, C, *spatial) and int64 targets (B, *spatial); ``signal`` is
    added to the target's logit, so that preds agree with targets more than by chance."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(steps):
        logits = torch.randn((batch, num_classes) + tuple(spatial), generator=g, device=device)
        target = torch.randint(0, num_classes, (batch,) + tuple(spatial), generator=g, device=device)
        if signal:
            logits.scatter_add_(1, target.unsqueeze(1), torch.full(target.unsqueeze(1).shape, signal, device=device))
        out.append((torch.softmax(logits, dim=1), target))
        del logits
    return out


def settle(*owners) -> None:
    """The end of a timed window: the owners' deferred calls flush (the engine queues
    them in every validation mode but "full"), then the card finishes, so that the
    time, the launch counts and the memory peaks include the deferred work."""
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch.ops import engine
    from metrics_tpu_torch.parallel.bucketing import tree_nodes

    def nodes(owner):  # every metric that may hold a queue: a wrapper's clones, a suite's members' trees
        if isinstance(owner, dict):  # phases 11 to 16 drive some metrics as a dict of members
            return [n for m in owner.values() for n in nodes(m)]
        if isinstance(owner, MetricCollection):
            return [owner] + [n for m in owner._modules.values() for n in nodes(m)]
        return tree_nodes(owner)

    engine.flush_barrier([n for owner in owners for n in nodes(owner)])
    torch.cuda.synchronize()


def run_suite(suite, batches, warmup: int) -> float:
    """Update over every batch; returns the seconds of the steps after ``warmup``."""
    for preds, target in batches[:warmup]:
        suite.update(preds, target)
    settle(suite)
    t0 = time.perf_counter()
    for preds, target in batches[warmup:]:
        suite.update(preds, target)
    settle(suite)
    return time.perf_counter() - t0


def assert_suites_equal(gpu_suite, cpu_suite, label: str, rtol: float = 0.0) -> dict:
    """Every state bit-exact, every value within atol 1e-6 (and ``rtol``); returns the values."""
    gpu_members = dict(gpu_suite.items(keep_base=True, copy_state=False))
    for name, cpu_m in cpu_suite.items(keep_base=True, copy_state=False):
        for state, value in cpu_m.metric_state.items():
            got = getattr(gpu_members[name], state).cpu()
            assert got.dtype == value.dtype and torch.equal(got, value), f"{label}: state {name}.{state} differs"
    gpu_res, cpu_res = gpu_suite.compute(), cpu_suite.compute()
    for key, want in cpu_res.items():
        got = gpu_res[key].cpu()
        assert torch.isfinite(got.float()).all(), f"{label}: {key} is not finite"
        if want.is_floating_point():
            torch.testing.assert_close(got, want, atol=1e-6, rtol=rtol, msg=f"{label}: {key}")
        else:
            assert got.dtype == torch.int32 and torch.equal(got, want), f"{label}: {key} differs"
    return {k: v.cpu().tolist() for k, v in gpu_res.items()}


def device_us(event) -> float:
    """A profiler row's own device time in µs, under the name this torch gives it."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0.0)


def device_profile(steps, warmup: int = 2, owners=()) -> dict:
    """Device-side time by kernel over ``steps`` (callables), from torch.profiler.

    The first ``warmup`` steps run in the profiler's warm-up cycle, which
    traces and discards them: device events launched just after tracing
    starts can be lost, whole sessions of short calls among them. Only
    device-side rows (kernels, memsets, copies: rows with device time and
    no CPU time of their own) are kept, so no time is counted twice.
    ``owners``' deferred calls flush at the end of each cycle. Returns key -> [device ms, count].
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in steps[:warmup]:
            step()
        settle(*owners)
        prof.step()
        for step in steps[warmup:]:
            step()
        settle(*owners)
        prof.step()

    rows = prof.key_averages()
    # "ProfilerStep*" is the schedule's own span, mirrored on the device timeline
    kept = {e.key: [device_us(e) / 1e3, e.count] for e in rows
            if device_us(e) > 0 and e.self_cpu_time_total == 0 and not e.key.startswith("ProfilerStep")}
    if not kept:
        seen = [(e.key[:50], e.self_cpu_time_total, device_us(e)) for e in rows][:15]
        log(f"profiler: no device-side rows; {len(rows)} rows, first ones (key, self cpu us, device us): {seen}")
    return kept


def profile_steps(update, batches, warmup: int = 2, owners=()) -> dict:
    """Device time per steady step ``update(*batch)``, in all and by kernel (``owners`` flushed in each cycle)."""
    active = len(batches) - warmup
    rows = device_profile([lambda b=b: update(*b) for b in batches], warmup, owners)
    busy_ms = sum(ms for ms, _ in rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "steps": active,
        # None: the profiler saw no device time, so device busy time was not measured
        "device_ms_per_step": busy_ms / active if busy_ms else None,
        "device_ops_per_step": sum(n for _, n in rows.values()) / active,
        "top_device_ms_per_step": {k[:80]: [ms / active, n / active] for k, (ms, n) in top},
    }


def member_breakdown(suite, batches) -> dict:
    """Milliseconds per update of each member alone (a clone, so the suite is untouched)."""
    out = {}
    for name, member in suite.items(keep_base=True, copy_state=False):
        clone = member.clone()
        settle(clone)
        t0 = time.perf_counter()
        for preds, target in batches:
            clone.update(preds, target)
        settle(clone)
        out[name] = (time.perf_counter() - t0) / len(batches) * 1e3
    return out


def main_path(mt, checks, histogram, card: str, trials: int = 3) -> dict:
    """The headline suite, timed ``trials`` times in each validation mode, the modes alternating."""
    batch, num_classes, warmup, timed = 8192, 128, 5, 50
    batches = make_batches(batch, num_classes, warmup + timed, seed=0)
    reference = make_suite(mt, num_classes, "cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    result = {"batch": batch, "num_classes": num_classes, "timed_steps": timed, "trials": trials, "card": card}
    seconds = {"first": [], "full": []}
    for trial in range(trials):
        for mode in ("first", "full"):
            checks.set_validation_mode(mode)
            suite = make_suite(mt, num_classes, "cuda")
            histogram.KERNEL_LAUNCHES = 0
            seconds[mode].append(run_suite(suite, batches, warmup))
            launches = histogram.KERNEL_LAUNCHES
            # one bincount a compute group an update (acc; f1 with precision; confmat: the class pairs or the
            # confusion matrix), and one a member on the first update, before the groups are found
            assert launches == 3 * (warmup + timed) + 1, f"{mode}: {launches} kernel launches for {warmup + timed} updates"
            if trial == 0:
                groups = sorted(sorted(g) for g in suite.compute_groups.values())
                assert groups == [["acc"], ["confmat"], ["f1", "precision"]], groups
                assert_suites_equal(suite, reference, f"main path ({mode})")
                result[mode] = {"kernel_launches": launches}
                if mode == "first":
                    first_suite = suite
    for mode, runs in seconds.items():
        per_step = sorted(s / timed * 1e3 for s in runs)
        median = per_step[len(per_step) // 2]
        result[mode].update(
            ms_per_step_runs=per_step,
            ms_per_step=median,
            steps_per_s=1e3 / median,
            samples_per_s=batch * 1e3 / median,
        )
        log(f"main path B={batch} C={num_classes} mode={mode}: {1e3 / median:.2f} steps/s, "
            f"{batch * 1e3 / median:.1f} samples/s (median of {trials}; ms/step {per_step}), "
            f"{result[mode]['kernel_launches']} launches  [{card}]")
    checks.set_validation_mode("first")
    prof = profile_steps(first_suite.update, batches[:12], owners=(first_suite,))
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / result["first"]["ms_per_step"]
    result["profile_first"] = prof
    result["member_ms_per_update_first"] = member_breakdown(first_suite, batches[warmup:warmup + 20])
    log(f"profile (mode=first): {json.dumps(prof)}")
    log(f"member ms per update (mode=first): {json.dumps(result['member_ms_per_update_first'])}")
    return result


def large_l_path(mt, histogram) -> dict:
    batch, num_classes, steps = 4096, 1000, 10
    batches = make_batches(batch, num_classes, steps, seed=1)
    suite = make_suite(mt, num_classes, "cuda")
    histogram.KERNEL_LAUNCHES = 0
    seconds = run_suite(suite, batches, 0)
    assert histogram.KERNEL_LAUNCHES == 3 * steps + 1, f"large-L path: {histogram.KERNEL_LAUNCHES} launches for {steps}"
    reference = make_suite(mt, num_classes, "cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    assert_suites_equal(suite, reference, "large-L path")
    log(f"large-L path B={batch} C={num_classes}: {steps / seconds:.2f} steps/s")
    return {"batch": batch, "num_classes": num_classes, "steps": steps, "steps_per_s": steps / seconds}


def multilabel_path(mt, histogram) -> dict:
    """ConfusionMatrix(multilabel=True) at B=8192, C=128: N = 2**20 ids into L = 512 bins a step."""
    batch, num_classes, steps = 8192, 128, 10
    g = torch.Generator(device="cuda").manual_seed(3)
    batches = [
        (torch.rand(batch, num_classes, generator=g, device="cuda"),
         torch.randint(0, 2, (batch, num_classes), generator=g, device="cuda"))
        for _ in range(steps)
    ]
    metric = mt.ConfusionMatrix(num_classes=num_classes, multilabel=True, device="cuda")
    histogram.KERNEL_LAUNCHES = 0
    seconds = run_suite(metric, batches, 0)
    assert histogram.KERNEL_LAUNCHES == steps, f"multilabel path: {histogram.KERNEL_LAUNCHES} launches for {steps}"
    reference = mt.ConfusionMatrix(num_classes=num_classes, multilabel=True, device="cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    got, want = metric.confmat.cpu(), reference.confmat
    assert got.dtype == torch.int32 and torch.equal(got, want), "multilabel path: confmat differs from the CPU"
    assert int(got.sum()) == steps * batch * num_classes
    assert torch.equal(metric.compute().cpu(), reference.compute())
    log(f"multilabel path B={batch} C={num_classes}: {steps / seconds:.2f} steps/s, state equals the CPU")
    return {"batch": batch, "num_classes": num_classes, "steps": steps, "steps_per_s": steps / seconds}


# ------------------------------------------------------------------ phases 6 and 7
def agreement_suite(mt, device: str, num_classes: int = 1000):
    return mt.MetricCollection(
        {
            "kappa": mt.CohenKappa(num_classes, device=device),
            "mcc": mt.MatthewsCorrCoef(num_classes, device=device),
            "jaccard": mt.JaccardIndex(num_classes, device=device),
            "specificity": mt.Specificity(num_classes=num_classes, average="macro", device=device),
            "hamming": mt.HammingDistance(device=device),
        }
    )


def segmentation_suite(mt, device: str, num_classes: int = 19):
    return mt.MetricCollection(
        {
            "miou": mt.JaccardIndex(num_classes=num_classes, device=device),
            "dice": mt.Dice(num_classes=num_classes, average="macro", mdmc_average="global", device=device),
        }
    )


def confmat_path(label, make_suite_fn, checks, histogram, batches, cpu_steps, warmup, timed, confmat_group, card,
                 pair_members=(), trials: int = 3) -> dict:
    """A collection whose confusion-matrix members share one compute group, on the card.

    Equality: the suite on the card and on the CPU over the first ``cpu_steps``
    batches. Then ``trials`` timed runs in each validation mode, the modes
    alternating: ``warmup`` + ``timed`` updates cycling over ``batches``. The
    launch count is set to 0 before each run and read after its first update
    (every member updates once, to find the groups: one launch per member of
    ``confmat_group``) and after the rest (one launch a step)."""
    checks.set_validation_mode("full")
    gpu, cpu = make_suite_fn("cuda"), make_suite_fn("cpu")
    for preds, target in batches[:cpu_steps]:
        gpu.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
    groups = sorted(sorted(g) for g in gpu.compute_groups.values())
    assert sorted(confmat_group) in groups, f"{label}: {confmat_group} do not share a compute group: {groups}"
    values = assert_suites_equal(gpu, cpu, label, rtol=1e-5)
    del gpu, cpu
    log(f"{label}: states equal the CPU over {cpu_steps} steps, values within rtol 1e-5; groups {groups}")

    steps = warmup + timed
    stream = [batches[i % len(batches)] for i in range(steps)]
    result = {"steps": steps, "timed_steps": timed, "trials": trials, "cpu_steps": cpu_steps, "groups": groups,
              "values": values, "card": card}
    seconds = {"first": [], "full": []}
    for trial in range(trials):
        for mode in ("first", "full"):
            checks.set_validation_mode(mode)
            suite = make_suite_fn("cuda")
            histogram.KERNEL_LAUNCHES = 0
            suite.update(*stream[0])
            first_launches = histogram.KERNEL_LAUNCHES
            histogram.KERNEL_LAUNCHES = 0
            seconds[mode].append(run_suite(suite, stream[1:], warmup - 1))
            rest_launches = histogram.KERNEL_LAUNCHES
            # the first update runs every member: each confusion-matrix member and each stat-scores member of
            # ``pair_members`` (a class-pair histogram) launches once; then one a compute group a step
            first_want, rest_want = len(confmat_group) + len(pair_members), (1 + len(pair_members)) * (steps - 1)
            assert first_launches == first_want, f"{label} ({mode}): {first_launches} launches on the first update"
            assert rest_launches == rest_want, f"{label} ({mode}): {rest_launches} launches in {steps - 1} steps"
            if trial == 0:
                result[mode] = {"kernel_launches": first_launches + rest_launches,
                                "first_update_launches": first_launches,
                                "launches_per_step_after_first": rest_launches / (steps - 1)}
                if mode == "first":
                    first_suite = suite
            del suite
    for mode, runs in seconds.items():
        per_step = sorted(t / timed * 1e3 for t in runs)
        median = per_step[len(per_step) // 2]
        result[mode].update(ms_per_step_runs=per_step, ms_per_step=median, steps_per_s=1e3 / median)
    checks.set_validation_mode("first")
    prof = profile_steps(first_suite.update, stream[:8], owners=(first_suite,))
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / result["first"]["ms_per_step"]
    result["profile_first"] = prof
    settle(first_suite)
    torch.cuda.reset_peak_memory_stats()
    first_suite.update(*stream[0])
    settle(first_suite)
    result["peak_device_bytes_one_step"] = torch.cuda.max_memory_allocated()
    log(f"profile {label} (mode=first): {json.dumps(prof)}")
    return result


def layer_profile(histogram, preds, target, num_classes: int, calls: int = 10) -> dict:
    """Device ms per call of each layer a member's update runs, on one batch of a path
    (torch.profiler, ``calls`` calls after 2 untimed): input canonicalisation (each
    group leader runs it once a step), the confusion matrix's pair ids, the bincount
    kernel, and the macro stat scores with the (N, C, X) -> (N*X, C) layout copy."""
    from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores
    from metrics_tpu_torch.utils.checks import _input_format_classification

    p, t, _ = _input_format_classification(preds, target)
    ids = t.argmax(dim=1).reshape(-1) * num_classes + p.argmax(dim=1).reshape(-1)
    stages = {
        "canonicalise": lambda: _input_format_classification(preds, target),
        "pair_ids": lambda: t.argmax(dim=1).reshape(-1) * num_classes + p.argmax(dim=1).reshape(-1),
        "bincount": lambda: histogram.fused_bincount(ids, num_classes**2),
        "stat_scores": lambda: _stat_scores(p.movedim(1, -1).reshape(-1, num_classes),
                                            t.movedim(1, -1).reshape(-1, num_classes), reduce="macro"),
    }
    out = {}
    for name, fn in stages.items():
        rows = device_profile([fn] * (calls + 2))
        # None: the profiler saw no device time, so it was not measured
        out[name] = {"device_ms": sum(ms for ms, _ in rows.values()) / calls if rows else None,
                     "device_ops": sum(n for _, n in rows.values()) / calls if rows else None}
    return out


def agreement_path(mt, checks, histogram, card) -> dict:
    """ImageNet-1k width: C=1000, B=4096 softmax rows a step; the confusion matrix has 10**6 bins."""
    batch, num_classes = 4096, 1000
    batches = make_batches(batch, num_classes, 8, seed=5, signal=4.0)
    result = confmat_path("agreement path", lambda dev: agreement_suite(mt, dev, num_classes), checks, histogram,
                          batches, cpu_steps=8, warmup=4, timed=20, confmat_group=["jaccard", "kappa", "mcc"],
                          card=card, pair_members=["specificity"])
    result.update(batch=batch, num_classes=num_classes,
                  device_ms_per_call_by_layer=layer_profile(histogram, *batches[0], num_classes))
    log(f"agreement path, device ms per call by layer: {json.dumps(result['device_ms_per_call_by_layer'])}  [{card}]")
    for mode in ("first", "full"):
        r = result[mode]
        r["samples_per_s"] = batch * r["steps_per_s"]
        log(f"agreement path B={batch} C={num_classes} mode={mode}: {r['steps_per_s']:.2f} steps/s, "
            f"{r['samples_per_s']:.1f} samples/s (ms/step {r['ms_per_step_runs']}), launches {r['kernel_launches']} "
            f"(first update {r['first_update_launches']}, then {r['launches_per_step_after_first']} a step)  [{card}]")
    return result


def segmentation_path(mt, checks, histogram, card) -> dict:
    """Cityscapes width: C=19, B=2 images of 1024 x 2048; 4,194,304 pixel ids into 361 bins a step."""
    batch, num_classes, spatial = 2, 19, (1024, 2048)
    batches = make_batches(batch, num_classes, 3, seed=6, signal=3.0, spatial=spatial)
    result = confmat_path("segmentation path", lambda dev: segmentation_suite(mt, dev, num_classes), checks,
                          histogram, batches, cpu_steps=3, warmup=2, timed=10, confmat_group=["miou"], card=card,
                          pair_members=["dice"])
    pixels = batch * spatial[0] * spatial[1]
    result.update(batch=batch, num_classes=num_classes, spatial=list(spatial), pixels_per_step=pixels,
                  device_ms_per_call_by_layer=layer_profile(histogram, *batches[0], num_classes))
    log(f"segmentation path, device ms per call by layer: {json.dumps(result['device_ms_per_call_by_layer'])}  [{card}]")
    for mode in ("first", "full"):
        r = result[mode]
        r["pixels_per_s"] = pixels * r["steps_per_s"]
        log(f"segmentation path B={batch} {spatial[0]}x{spatial[1]} C={num_classes} mode={mode}: "
            f"{r['steps_per_s']:.2f} steps/s, {r['pixels_per_s']:.4g} pixels/s (ms/step {r['ms_per_step_runs']}), "
            f"launches {r['kernel_launches']}  [{card}]")
    return result


# ------------------------------------------------------------------ phase 8
AGGREGATORS = ("MeanMetric", "SumMetric", "MaxMetric", "MinMetric", "CatMetric")


def _update_outcome(metric, args) -> str:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            metric.update(*args)
        except RuntimeError as err:
            return f"RuntimeError: {err}"
    return "ok"


def aggregation_path(mt, checks, card) -> dict:
    """Per-step loss tensors (B=4096) with NaNs in some steps' values and others' weights:
    every aggregator under every nan_strategy and validation mode, on the card and on the CPU."""
    batch, steps = 4096, 12
    g = torch.Generator(device="cuda").manual_seed(7)
    stream = []
    for step in range(steps):
        loss = torch.rand(batch, generator=g, device="cuda") * 3
        weight = torch.rand(batch, generator=g, device="cuda")
        if step % 3 == 1:
            loss[::97] = float("nan")
        if step % 4 == 2:
            weight[::89] = float("nan")
        stream.append((loss, weight))
    checked = 0
    for mode in ("full", "first", "off"):
        checks.set_validation_mode(mode)
        for strategy in ("error", "warn", "ignore", 0.5):
            for name in AGGREGATORS:
                gpu = getattr(mt, name)(nan_strategy=strategy, device="cuda")
                cpu = getattr(mt, name)(nan_strategy=strategy, device="cpu")
                for loss, weight in stream:
                    args = (loss, weight) if name == "MeanMetric" else (loss,)
                    outcome = _update_outcome(gpu, args)
                    assert outcome == _update_outcome(cpu, [a.cpu() for a in args]), f"{name}/{strategy}/{mode}: {outcome}"
                for state, want in cpu.metric_state.items():
                    got = getattr(gpu, state)
                    got = torch.cat([v.cpu() for v in got]) if isinstance(got, list) else got.cpu()
                    want = torch.cat(want) if isinstance(want, list) else want
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True,
                                               msg=f"aggregation {name}/{strategy}/{mode}: state {state}")
                torch.testing.assert_close(gpu.compute().cpu(), cpu.compute(), rtol=1e-5, atol=1e-6, equal_nan=True,
                                           msg=f"aggregation {name}/{strategy}/{mode}: compute")
                checked += 1
    log(f"aggregation path: {checked} aggregator x nan_strategy x mode runs of {steps} steps equal the CPU")

    checks.set_validation_mode("first")
    suite = mt.MetricCollection({name: getattr(mt, name)(device="cuda") for name in AGGREGATORS}, compute_groups=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for loss, weight in stream[:2]:
            suite.update(loss, weight=weight)
        settle(suite)
        t0 = time.perf_counter()
        for loss, weight in stream[2:]:
            suite.update(loss, weight=weight)
        settle(suite)
        seconds = time.perf_counter() - t0
        values = {k: (v.numel() if k == "CatMetric" else float(v)) for k, v in suite.compute().items()}
        prof = profile_steps(lambda loss, weight: suite.update(loss, weight=weight), stream[:8], owners=(suite,))
    ms = seconds / (steps - 2) * 1e3
    assert all(v == v for k, v in values.items()), f"aggregation suite: NaN in {values}"
    result = {"batch": batch, "steps": steps, "runs_checked": checked, "ms_per_step": ms, "steps_per_s": 1e3 / ms,
              "values": values, "profile_first": prof, "card": card}
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / ms
    log(f"aggregation path (mode=first, default nan_strategy 'warn'): {1e3 / ms:.2f} steps/s; "
        f"profile {json.dumps(prof)}  [{card}]")
    return result


# ------------------------------------------------------------------ phase 9
CURVE_AREA_ATOL = {"binary": 1e-6, "multiclass": 1e-5}  # eager areas, card against CPU (the JAX tests' tolerances)
SORTED_AREA_ATOL = {"binary": 1e-4, "multiclass": 1e-5}  # sort-based areas against the eager curves on the card
CONF_SUM_RTOL = 1e-5  # CalibrationError's float32 confidence sums: another order of addition on each side
CPU_TWIN_BINNED_S = 6.0  # the CPU twin of the binned updates runs all batches only if it takes about this long
CURVES_TWIN_STEPS = (16, 10)  # updates of phase 9a (of 64) and 9b (of 50) whose rows the CPU's curves and areas take
HOST_READ_OPS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero")
CURVES_DEVICE = "cuda"  # where the curve paths run
CURVES_BINARY_SHAPE = (64, 262_144)  # updates, scores an update: 2**24 scores
CURVES_IMAGENET_SHAPE = (50, 1000, 1000)  # updates, rows an update, classes: the ImageNet-1k validation set


def curves_binary_suite(mt, device: str):
    """A CTR or fraud model's evaluation metrics: exact AUROC, AP, ROC and PR curve over every score."""
    return mt.MetricCollection(
        {
            "auroc": mt.AUROC(pos_label=1, device=device),
            "ap": mt.AveragePrecision(pos_label=1, device=device),
            "roc": mt.ROC(pos_label=1, device=device),
            "pr_curve": mt.PrecisionRecallCurve(pos_label=1, device=device),
        }
    )


def curves_imagenet_suite(mt, device: str, num_classes: int, binned: bool = True):
    """The ImageNet-1k validation pass's ranking and calibration metrics."""
    members = {
        "auroc": mt.AUROC(num_classes=num_classes, average="macro", device=device),
        "ap": mt.AveragePrecision(num_classes=num_classes, average="macro", device=device),
        "ece": mt.CalibrationError(n_bins=15, norm="l1", device=device),
    }
    if binned:
        members["binned_ap"] = mt.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, device=device)
    return mt.MetricCollection(members)


def curves_binary_batches(seed: int = 20) -> list:
    """Bernoulli(0.03) labels (int64) and float32 scores with signal, rounded to multiples
    of 2**-12, so that long tie runs form: ``steps * batch`` = 2**24 scores."""
    steps, batch = CURVES_BINARY_SHAPE
    g = torch.Generator(device=CURVES_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        target = (torch.rand(batch, generator=g, device=CURVES_DEVICE) < 0.03).to(torch.int64)
        logits = torch.randn(batch, generator=g, device=CURVES_DEVICE) + 2.0 * target - 1.5
        out.append((torch.round(torch.sigmoid(logits) * 4096) / 4096, target))
    return out


def curves_imagenet_batches(seed: int = 21) -> list:
    """Softmax rows (B, C) and int64 labels: the row's arg-max 75% of the time, else uniform."""
    steps, batch, num_classes = CURVES_IMAGENET_SHAPE
    g = torch.Generator(device=CURVES_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        probs = torch.softmax(torch.randn(batch, num_classes, generator=g, device=CURVES_DEVICE) * 2.0, dim=1)
        uniform = torch.randint(0, num_classes, (batch,), generator=g, device=CURVES_DEVICE)
        keep = torch.rand(batch, generator=g, device=CURVES_DEVICE) < 0.75
        out.append((probs, torch.where(keep, probs.argmax(dim=1), uniform)))
    return out


def compute_profile(fn, warmup_fn=None, host_ops: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler, after one call (of ``warmup_fn`` where it is given: a
    slow ``fn`` runs once) in the warm-up cycle: device ms and operations, and the host ops that read
    the device (``HOST_READ_OPS``) with their counts. ``host_ops=False`` traces the device alone (a
    call of many thousand host ops costs the profiler a minute): the host reads are then not measured."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        (warmup_fn or fn)()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()

    rows = [e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")]
    device = [e for e in rows if device_us(e) > 0 and e.self_cpu_time_total == 0]
    counts = {e.key: e.count for e in rows}
    return {
        # None: the profiler saw no device time, so it was not measured
        "device_ms": sum(device_us(e) for e in device) / 1e3 if device else None,
        "device_ops": sum(e.count for e in device),
        "host_reads": {k: counts.get(k, 0) for k in HOST_READ_OPS} if host_ops else None,
        # every copy to the host, ``item`` and ``tolist`` alike, as the device timeline shows it
        "device_to_host_copies": sum(e.count for e in device if "DtoH" in e.key),
        "host_to_device_copies": sum(e.count for e in device if "HtoD" in e.key),
        # the copy calls as the host makes them, which a session that loses device rows still records
        "memcpy_calls": sum(e.count for e in rows if e.key in ("cudaMemcpyAsync", "cudaMemcpy")),
        "top_device_ms": {e.key[:60]: [device_us(e) / 1e3, e.count]
                          for e in sorted(device, key=lambda e: -device_us(e))[:8]},
    }


def timed_ms(fn, repeats: int = 1) -> float:
    """Host milliseconds of ``fn`` (the best of ``repeats``), each run ending in a synchronise."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def fresh_compute(suite):
    """``suite.compute()`` with every member's cached value dropped, so that it computes again."""
    for _, m in suite.items(keep_base=True, copy_state=False):
        m._computed = None
    return suite.compute()


def assert_curve_close(got, want, label: str, atol, rtol: float = 0.0) -> float:
    """A result on the card against the CPU's, recursing into lists and tuples: bit for bit when
    ``atol`` and ``rtol`` are 0 or None, else within them. Returns the largest |difference| of the
    finite values."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), f"{label}: {type(got)} of {len(got)}"
        return max([assert_curve_close(g, w, label, atol, rtol) for g, w in zip(got, want)], default=0.0)
    g = got.cpu()
    assert g.dtype == want.dtype and g.shape == want.shape, f"{label}: {g.dtype} {tuple(g.shape)}"
    torch.testing.assert_close(g, want, atol=atol or 0.0, rtol=rtol, equal_nan=True, msg=lambda m: f"{label}: {m}")
    finite = torch.isfinite(want)
    return float((g[finite].double() - want[finite].double()).abs().max()) if finite.any() else 0.0


def assert_state_close(got, want, label: str, rtol: float = 0.0, atol: float = 0.0) -> None:
    """A state (a tensor or a list of rows) on the card against the CPU's: bit for bit, or for
    floats within ``rtol``/``atol`` where they are given."""
    got, want = (got, want) if isinstance(want, list) else ([got], [want])
    assert len(got) == len(want), f"{label}: {len(got)} rows, not {len(want)}"
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {g.dtype} {tuple(g.shape)}"
        if w.is_floating_point() and (rtol or atol):
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True, msg=lambda m: f"{label}: {m}")
        else:
            assert torch.equal(g, w), f"{label}: differs from the CPU"


def assert_member_states_equal(gpu_members: dict, cpu_members: dict, label: str) -> None:
    """Every state of every CPU member's twin on the card bit for bit; a float sum state
    (CalibrationError's ``conf_bin``) within ``CONF_SUM_RTOL``."""
    for name, cpu_m in cpu_members.items():
        for state, want in cpu_m.metric_state.items():
            assert_state_close(getattr(gpu_members[name], state), want, f"{label}: {name}.{state}",
                               rtol=CONF_SUM_RTOL if state == "conf_bin" else 0.0)


def time_runs(make, update, batches, checks, histogram, trials: int = 3) -> tuple:
    """``trials`` runs of ``update(obj, batch)`` over every batch on a new ``make()``, mode "first":
    (ms per step of each run, sorted; bincount launches of the first run; the first run's object)."""
    checks.set_validation_mode("first")
    runs, launches, first = [], None, None
    for trial in range(trials):
        obj = make()
        histogram.KERNEL_LAUNCHES = 0
        settle(obj)
        t0 = time.perf_counter()
        for batch in batches:
            update(obj, batch)
        settle(obj)
        runs.append((time.perf_counter() - t0) / len(batches) * 1e3)
        if trial == 0:
            launches, first = histogram.KERNEL_LAUNCHES, obj
    return sorted(runs), launches, first


def update_batch(metric, batch) -> None:
    metric.update(*batch)


def peak_extra_bytes(fn) -> int:
    """Device memory ``fn`` allocates above what was allocated before it, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def op_profile(fn, bytes_moved: int, ops: int, peak_ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """Device ms per call of ``fn`` (5 calls after 2 in the warm-up cycle) beside its bound: the
    larger of its bytes at the memory rate and its operations at ``peak_ops_per_s`` (float32's by
    default). A session whose
    device rows the profiler lost is tried again, ``PROFILE_ATTEMPTS`` times in all; then the time
    comes from CUDA events around 5 calls (``timed_by``)."""
    for _ in range(PROFILE_ATTEMPTS):
        rows = device_profile([fn] * 7)
        if rows:
            break
    device_ms = sum(ms for ms, _ in rows.values()) / 5 if rows else cuda_time_ms(fn, iters=5, warmup=2)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / peak_ops_per_s) * 1e3
    # CUDA events around 5 calls as well: a session can lose some device rows and still keep others
    return {"device_ms": device_ms, "timed_by": "profiler" if rows else "cuda_events",
            "event_ms": cuda_time_ms(fn, iters=5, warmup=1), "bytes": bytes_moved,
            "ops": ops, "bound_ms": bound_ms,
            "bound_by": "operations" if ops / peak_ops_per_s > bytes_moved / HBM_BYTES_PER_S else "bytes",
            "share_of_bound": bound_ms / device_ms,
            "device_rows": {k[:60]: v for k, v in sorted(rows.items(), key=lambda kv: -kv[1][0])[:6]}}


def sort_profile(preds) -> dict:
    """The eager curve's descending stable argsort of ``preds``, beside its bound from bytes (the
    float32 keys read once, the int64 indices written once)."""
    return {"n": preds.numel(),
            **op_profile(lambda: torch.argsort(-preds, stable=True), bytes_moved=12 * preds.numel(), ops=0)}


def binned_profile(preds, target, thresholds) -> dict:
    """One binned update's compare and contraction beside its bound, and its peak extra memory."""
    from metrics_tpu_torch.ops.binned import binned_curve_counts, threshold_chunk

    n, c = preds.shape
    t = thresholds.numel()
    t01 = (target == 1).to(torch.float32)
    run = lambda: binned_curve_counts(preds, t01, thresholds)  # noqa: E731
    # scores and 0/1 targets read, three (C, T) counts written; a compare, a multiply and an add for
    # TP, an add for the >= total
    out = {"n": n, "c": c, "t": t, "threshold_chunk": threshold_chunk(n, c, t),
           **op_profile(run, bytes_moved=4 * (2 * n * c + t + 3 * c * t), ops=4 * n * c * t)}
    out["peak_extra_bytes"] = peak_extra_bytes(run)
    return out


def curves_binary_path(mt, checks, histogram, card: str) -> dict:
    """Phase 9a: AUROC, AP, ROC and the PR curve over 2**24 binary scores in 64 updates, one compute."""
    batches = curves_binary_batches()
    n = sum(p.numel() for p, _ in batches)
    runs, launches, suite = time_runs(lambda: curves_binary_suite(mt, CURVES_DEVICE), update_batch, batches, checks,
                                      histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert groups == [["ap", "auroc", "pr_curve", "roc"]], f"curves_binary: groups {groups}"
    assert launches == 0, f"curves_binary: {launches} bincount launches in its updates"
    # on a suite of its own: the profiled updates must not reach the suite held against the CPU
    spare = curves_binary_suite(mt, CURVES_DEVICE)
    update_prof = profile_steps(spare.update, batches[:10], owners=(spare,))
    result = {"n": n, "batch": batches[0][0].numel(), "steps": len(batches), "groups": groups, "card": card,
              "update_ms_per_step_runs": runs, "update_ms_per_step": runs[len(runs) // 2],
              "update_profile": update_prof, "kernel_launches": launches}
    if update_prof["device_ms_per_step"] is not None:
        update_prof["device_idle_share"] = 1.0 - update_prof["device_ms_per_step"] / result["update_ms_per_step"]
    leader = dict(suite.items(keep_base=True, copy_state=False))["ap"]
    result["state_bytes_on_card"] = sum(t.numel() * t.element_size() for t in leader.preds + leader.target)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = suite.compute()
    torch.cuda.synchronize()
    result["compute_ms"] = (time.perf_counter() - t0) * 1e3
    result["compute_again_ms"] = timed_ms(lambda: fresh_compute(suite))  # the allocator warm from the first
    prof = compute_profile(lambda: fresh_compute(suite))
    result["compute_profile"] = prof
    if prof["device_ms"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / result["compute_ms"]

    # the CPU twin takes every update (its appends are cheap) and holds the timed suite's states bit for
    # bit; its curves and areas come from the first CURVES_TWIN_STEPS[0] updates' rows (a CPU sort of all
    # 2**24 scores takes about 12 s), against the card's on the same rows of the suite's own states
    twin_steps = CURVES_TWIN_STEPS[0]
    cpu = curves_binary_suite(mt, "cpu")
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    gpu_members = dict(suite.items(keep_base=True, copy_state=False))
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    assert_member_states_equal(gpu_members, cpu_members, "curves_binary")
    F = mt.functional
    on_rows = {"roc": lambda p, t: F.roc(p, t, pos_label=1),
               "pr_curve": lambda p, t: F.precision_recall_curve(p, t, pos_label=1),
               "auroc": lambda p, t: F.auroc(p, t, pos_label=1),
               "ap": lambda p, t: F.average_precision(p, t, pos_label=1)}
    t0 = time.perf_counter()
    want = {k: fn(*twin_rows(cpu_members["ap"], twin_steps)) for k, fn in on_rows.items()}
    result["cpu_compute_ms"] = (time.perf_counter() - t0) * 1e3
    twin_values = {k: fn(*twin_rows(gpu_members["ap"], twin_steps)) for k, fn in on_rows.items()}
    err = {}
    for key in ("roc", "pr_curve"):
        err[key] = assert_curve_close(twin_values[key], want[key], f"curves_binary {key}", None)
    for key in ("auroc", "ap"):
        err[key] = assert_curve_close(twin_values[key], want[key], f"curves_binary {key}", CURVE_AREA_ATOL["binary"])
    assert all(torch.isfinite(values[k]) for k in ("auroc", "ap")), "curves_binary: an area is not finite"
    result.update(values={k: float(values[k]) for k in ("auroc", "ap")}, curve_points=values["roc"][0].numel(),
                  max_abs_err_vs_cpu=err, cpu_twin_steps=twin_steps)
    all_preds = torch.cat([p for p, _ in batches])
    result["sort"] = sort_profile(all_preds)
    log(f"curves_binary N={n} ({len(batches)} x {result['batch']}): update {result['update_ms_per_step']:.4f} ms/step "
        f"(runs {runs}), compute {result['compute_ms']:.2f} ms (again {result['compute_again_ms']:.2f} ms; CPU "
        f"{result['cpu_compute_ms']:.1f} ms over {twin_steps} updates), "
        f"values {result['values']}, {result['curve_points']} ROC points; over the first {twin_steps} updates curves "
        f"bit for bit and areas within {CURVE_AREA_ATOL['binary']} of the CPU (max |err| {err})  [{card}]")
    log(f"curves_binary profiles: update {json.dumps(update_prof)}; compute {json.dumps(prof)}; "
        f"sort {json.dumps(result['sort'])}  [{card}]")
    return result, batches, values


def twin_rows(leader, steps: int) -> tuple:
    """The rows of a curve member's first ``steps`` updates: its ``preds`` and ``target`` rows concatenated."""
    return torch.cat(leader.preds[:steps]), torch.cat(leader.target[:steps])


def curves_imagenet_path(mt, checks, histogram, card: str) -> dict:
    """Phase 9b: AUROC, AP (macro, C=1000), CalibrationError and BinnedAveragePrecision (T=100)
    over the 50,000 ImageNet-1k validation rows in 50 updates, one compute, then the weighted
    functional AUROC and AP on the same arrays."""
    num_classes = CURVES_IMAGENET_SHAPE[2]
    laps, t_lap = {}, [time.perf_counter()]

    def lap(label):  # seconds of each part of the path, logged with its result
        now = time.perf_counter()
        laps[label], t_lap[0] = now - t_lap[0], now
    batches = curves_imagenet_batches()
    n = sum(p.shape[0] for p, _ in batches)
    runs, launches, suite = time_runs(lambda: curves_imagenet_suite(mt, CURVES_DEVICE, num_classes), update_batch,
                                      batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert groups == [["ap", "auroc"], ["binned_ap"], ["ece"]], f"curves_imagenet: groups {groups}"
    assert launches == len(batches), f"curves_imagenet: {launches} bincount launches in {len(batches)} updates"
    lap("runs")
    spare = curves_imagenet_suite(mt, CURVES_DEVICE, num_classes)
    update_prof = profile_steps(spare.update, batches[:8], owners=(spare,))
    result = {"n": n, "batch": batches[0][0].shape[0], "num_classes": num_classes, "steps": len(batches),
              "groups": groups, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": runs[len(runs) // 2], "update_profile": update_prof, "kernel_launches": launches}
    if update_prof["device_ms_per_step"] is not None:
        update_prof["device_idle_share"] = 1.0 - update_prof["device_ms_per_step"] / result["update_ms_per_step"]
    lap("update_profile")
    leader = dict(suite.items(keep_base=True, copy_state=False))["ap"]
    result["state_bytes_on_card"] = sum(t.numel() * t.element_size() for t in leader.preds + leader.target)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = suite.compute()
    torch.cuda.synchronize()
    result["compute_ms"] = (time.perf_counter() - t0) * 1e3
    result["compute_again_ms"] = timed_ms(lambda: fresh_compute(suite))  # the allocator warm from the first
    # one compute under the profiler, the device alone (a slow call of 1000 classes' host ops: its warm-up
    # cycle runs a synchronise, and the host ops are not traced)
    prof = compute_profile(lambda: fresh_compute(suite), warmup_fn=torch.cuda.synchronize, host_ops=False)
    result["compute_profile"] = prof
    if prof["device_ms"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / result["compute_ms"]

    lap("compute_and_profile")
    # the CPU twin: every batch through the exact and calibration members (appends and sums: cheap), which
    # holds the timed suite's states bit for bit; the exact areas come from the first CURVES_TWIN_STEPS[1]
    # batches' rows on each side (1000 classes' sorts on the CPU take about 30 s for all 50); the binned
    # member's batches as far as CPU_TWIN_BINNED_S allows
    twin_steps = CURVES_TWIN_STEPS[1]
    cpu = curves_imagenet_suite(mt, "cpu", num_classes, binned=False)
    for preds, target in batches:
        cpu.update(preds.cpu(), target.cpu())
    lap("cpu_twin_updates")
    cpu_binned = mt.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, device="cpu")
    t0 = time.perf_counter()
    cpu_binned.update(batches[0][0].cpu(), batches[0][1].cpu())
    per_update_s = time.perf_counter() - t0
    binned_steps = len(batches) if per_update_s * len(batches) <= CPU_TWIN_BINNED_S else 5
    for preds, target in batches[1:binned_steps]:
        cpu_binned.update(preds.cpu(), target.cpu())
    gpu_binned = mt.BinnedAveragePrecision(num_classes=num_classes, thresholds=100, device=CURVES_DEVICE)
    for preds, target in batches[:binned_steps]:
        gpu_binned.update(preds, target)
    lap("binned_twins")
    gpu_members = dict(suite.items(keep_base=True, copy_state=False))
    if binned_steps == len(batches):
        for state in ("TPs", "FPs", "FNs"):  # the suite's member ran the same updates on the card
            assert torch.equal(getattr(gpu_members["binned_ap"], state), getattr(gpu_binned, state))
    for state in ("TPs", "FPs", "FNs"):
        assert torch.equal(getattr(gpu_binned, state).cpu(), getattr(cpu_binned, state)), f"binned {state} differs"
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    assert_member_states_equal(gpu_members, cpu_members, "curves_imagenet")
    F = mt.functional
    on_rows = {"auroc": lambda p, t: F.auroc(p, t, num_classes=num_classes, average="macro"),
               "ap": lambda p, t: F.average_precision(p, t, num_classes=num_classes, average="macro")}
    t0 = time.perf_counter()
    want = {k: fn(*twin_rows(cpu_members["ap"], twin_steps)) for k, fn in on_rows.items()}
    result["cpu_compute_ms"] = (time.perf_counter() - t0) * 1e3
    twin_values = {k: fn(*twin_rows(gpu_members["ap"], twin_steps)) for k, fn in on_rows.items()}
    lap("twin_computes")
    err = {k: assert_curve_close(twin_values[k], want[k], f"curves_imagenet {k}", CURVE_AREA_ATOL["multiclass"])
           for k in ("auroc", "ap")}
    # calibration over every row: the CPU twin's member alone computes it
    err["ece"] = assert_curve_close(values["ece"], cpu_members["ece"].compute(), "curves_imagenet ece",
                                    CURVE_AREA_ATOL["binary"])
    assert all(torch.isfinite(values[k]) for k in ("auroc", "ap", "ece")), "curves_imagenet: a value is not finite"
    err["binned_ap"] = assert_curve_close(gpu_binned.compute(), cpu_binned.compute(), "curves_imagenet binned_ap",
                                          CURVE_AREA_ATOL["binary"])
    assert len(values["binned_ap"]) == num_classes and all(torch.isfinite(v) for v in values["binned_ap"][:10])
    result.update(values={k: float(values[k]) for k in ("auroc", "ap", "ece")},
                  binned_ap_mean=float(torch.stack(values["binned_ap"]).mean()), max_abs_err_vs_cpu=err,
                  cpu_twin_binned_steps=binned_steps, cpu_binned_s_per_update=per_update_s, cpu_twin_steps=twin_steps)

    lap("twin_checks")
    # the weighted functional areas on the same arrays: the class support is one bincount each
    all_preds = torch.cat([p for p, _ in batches])
    all_target = torch.cat([t for _, t in batches])
    histogram.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_auroc = mt.functional.auroc(all_preds, all_target, num_classes=num_classes, average="weighted")
    w_ap = mt.functional.average_precision(all_preds, all_target, num_classes=num_classes, average="weighted")
    torch.cuda.synchronize()
    result["weighted_ms"] = (time.perf_counter() - t0) * 1e3
    result["weighted_launches"] = histogram.KERNEL_LAUNCHES
    assert result["weighted_launches"] == 2, f"weighted areas: {result['weighted_launches']} bincount launches"
    assert torch.isfinite(w_auroc) and torch.isfinite(w_ap), "weighted areas: not finite"
    # the full-data weighted areas against the sort-based ones on the same arrays, as phase 9c holds the
    # unweighted areas
    from metrics_tpu_torch.ops import sorted_curves

    for key, got, sort_fn in (("weighted_auroc_sorted", w_auroc, sorted_curves.multiclass_auroc_sorted),
                              ("weighted_ap_sorted", w_ap, sorted_curves.multiclass_average_precision_sorted)):
        sorted_value = sort_fn(all_preds, all_target, num_classes, "weighted")
        err[key] = abs(float(sorted_value) - float(got))
        assert err[key] <= SORTED_AREA_ATOL["multiclass"], f"{key}: {float(sorted_value)} against {float(got)}"
    lap("weighted_card")
    # the CPU twin's rows, against the card on the same rows
    rows = sum(p.shape[0] for p, _ in batches[:twin_steps])
    twin_preds, twin_target = all_preds[:rows], all_target[:rows]
    cpu_preds, cpu_target = twin_preds.cpu(), twin_target.cpu()
    err["weighted_auroc"] = assert_curve_close(
        mt.functional.auroc(twin_preds, twin_target, num_classes=num_classes, average="weighted"),
        mt.functional.auroc(cpu_preds, cpu_target, num_classes=num_classes, average="weighted"),
        "weighted auroc", CURVE_AREA_ATOL["multiclass"])
    err["weighted_ap"] = assert_curve_close(
        mt.functional.average_precision(twin_preds, twin_target, num_classes=num_classes, average="weighted"),
        mt.functional.average_precision(cpu_preds, cpu_target, num_classes=num_classes, average="weighted"),
        "weighted ap", CURVE_AREA_ATOL["multiclass"])
    result["weighted_values"] = {"auroc": float(w_auroc), "ap": float(w_ap)}

    lap("weighted_cpu")
    thresholds = torch.from_numpy(gpu_binned.thresholds).to(CURVES_DEVICE)
    onehot = torch.nn.functional.one_hot(batches[0][1], num_classes)
    result["binned"] = binned_profile(batches[0][0], onehot, thresholds)
    lap("binned_profile")
    log(f"curves_imagenet N={n} C={num_classes}: update {result['update_ms_per_step']:.4f} ms/step (runs {runs}), "
        f"{launches} bincount launches; compute {result['compute_ms']:.1f} ms (again {result['compute_again_ms']:.1f} "
        f"ms; CPU {result['cpu_compute_ms']:.1f} ms over {twin_steps} updates); "
        f"values {result['values']}, binned AP mean {result['binned_ap_mean']:.6f}; weighted AUROC and AP "
        f"{result['weighted_values']} in {result['weighted_ms']:.1f} ms, 2 launches; CPU twin of the binned updates "
        f"over {binned_steps} of {len(batches)} batches ({per_update_s:.2f} s an update on the CPU); max |err| vs "
        f"CPU {err}  [{card}]")
    result["seconds"] = laps
    log(f"curves_imagenet seconds: {json.dumps(laps)}")
    log(f"curves_imagenet profiles: update {json.dumps(update_prof)}; compute {json.dumps(prof)}; "
        f"binned update {json.dumps(result['binned'])}  [{card}]")
    return result, (all_preds, all_target), values


def sorted_curves_path(binary, imagenet, binary_values, imagenet_values, card: str) -> dict:
    """Phase 9c: the sort-based exact areas on both paths' arrays, each against the eager curve's
    value on the card, each timed against the eager path's functional call."""
    import metrics_tpu_torch.functional as F
    from metrics_tpu_torch.ops import sorted_curves

    (bp, bt), (mp, mt_) = binary, imagenet
    num_classes = mp.shape[1]
    cases = {
        "binary_auroc_sorted": (lambda: sorted_curves.binary_auroc_sorted(bp, bt),
                                lambda: F.auroc(bp, bt, pos_label=1), binary_values["auroc"], "binary"),
        "binary_average_precision_sorted": (lambda: sorted_curves.binary_average_precision_sorted(bp, bt),
                                            lambda: F.average_precision(bp, bt, pos_label=1), binary_values["ap"],
                                            "binary"),
        "multiclass_auroc_sorted": (lambda: sorted_curves.multiclass_auroc_sorted(mp, mt_, num_classes, "macro"),
                                    lambda: F.auroc(mp, mt_, num_classes=num_classes), imagenet_values["auroc"],
                                    "multiclass"),
        "multiclass_average_precision_sorted": (
            lambda: sorted_curves.multiclass_average_precision_sorted(mp, mt_, num_classes, "macro"),
            lambda: F.average_precision(mp, mt_, num_classes=num_classes), imagenet_values["ap"], "multiclass"),
    }
    out = {"card": card}
    for name, (fn, eager_fn, eager_value, kind) in cases.items():
        got = fn()
        err = abs(float(got) - float(eager_value))
        assert err <= SORTED_AREA_ATOL[kind], f"{name}: {float(got)} against the eager {float(eager_value)}"
        ms = timed_ms(fn, repeats=3)
        eager_ms = timed_ms(eager_fn, repeats=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[name] = {"value": float(got), "eager_value": float(eager_value), "abs_err": err,
                     "atol": SORTED_AREA_ATOL[kind], "ms": ms, "eager_ms": eager_ms,
                     "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}
        log(f"sorted_curves {name}: {float(got):.8f} (eager {float(eager_value):.8f}, |err| {err:.3g} <= "
            f"{SORTED_AREA_ATOL[kind]}), {ms:.3f} ms against the eager path's {eager_ms:.1f} ms  [{card}]")
    return out


def curves_path(mt, checks, histogram, card: str) -> dict:
    """Phase 9: the two curve paths and the sort-based areas on their arrays."""
    t0 = time.perf_counter()
    binary, binary_batches, binary_values = curves_binary_path(mt, checks, histogram, card)
    t1 = time.perf_counter()
    imagenet, imagenet_arrays, imagenet_values = curves_imagenet_path(mt, checks, histogram, card)
    t2 = time.perf_counter()
    binary_arrays = (torch.cat([p for p, _ in binary_batches]), torch.cat([t for _, t in binary_batches]))
    del binary_batches
    sorted_result = sorted_curves_path(binary_arrays, imagenet_arrays, binary_values, imagenet_values, card)
    seconds = {"binary": t1 - t0, "imagenet": t2 - t1, "sorted": time.perf_counter() - t2}
    log(f"curves phase seconds: {json.dumps(seconds)}")
    return {"seconds": seconds, "curves_binary": binary, "curves_imagenet": imagenet, "sorted_curves": sorted_result,
            "kernel_launches": binary["kernel_launches"] + imagenet["kernel_launches"] + imagenet["weighted_launches"]}


# ------------------------------------------------------------------ phases 11 to 14
EVAL_DEVICE = "cuda"  # where phases 11 to 14 run
CPU_TWIN_S = 6.0  # a CPU twin runs every batch where that takes about this long, else the first ones that fit
RANKING_SHAPE = (50, 1000, 1000)  # updates, rows an update, labels: the ImageNet-1k validation set
RANKING_RTOL = 1e-5  # float sums of per-row values (LRAP, ranking loss, hinge, KL) in another order on each side
REGRESSION_SHAPE = (64, 262_144)  # updates, rows an update: 2**24 rows
MULTIOUTPUT_SHAPE = (16, 65_536, 16)  # updates, rows an update, outputs
# float32 sums of 2**24 terms, in another order on each side, through moment formulas that subtract
# such sums (E[x²] - E[x]²), which multiplies their relative error
REGRESSION_RTOL = 1e-4
# Spearman: both sides rank alike (the same integer positions, made float32 the same way), but the
# means and products of 2**24 ranks near 8.4e6 (a float32 ulp of 1 there) are summed in another order
SPEARMAN_ATOL = 1e-4
PAIRWISE_SHAPE = (4096, 8192, 768)  # rows of x, rows of y, width: sentence embeddings of BERT-base width
PAIRWISE_CPU_ROWS = 256  # rows of x the CPU twin computes, all columns
# float32 sums of 768 products in another order on each side (|values| up to about 1e3 for Manhattan,
# 40 for Euclidean); Euclidean's expansion cancels only where rows coincide, whose zeroed diagonal is exact
PAIRWISE_ATOL, PAIRWISE_RTOL = 1e-3, 1e-5
RETRIEVAL_SHAPE = (6980, 100, 1000)  # queries, queries an update, candidates a query: MS MARCO dev-small re-ranking
RETRIEVAL_ATOL = 1e-6  # means over queries of exact per-query values, in another order on each side
RETRIEVAL_CPU_TWIN_S = 10.0  # the retrieval CPU twin computes all 70 updates only if that takes about this long


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def cpu_twin_steps(update_cpu_once_s: float, steps: int) -> int:
    """Every step if the CPU twin takes about ``CPU_TWIN_S`` for them, else the first ones that fit (at least 2)."""
    return steps if update_cpu_once_s * steps <= CPU_TWIN_S else max(2, int(CPU_TWIN_S / update_cpu_once_s))


def compute_all(members: dict) -> dict:
    """Every member's ``compute()``, its cached value dropped first."""
    out = {}
    for name, m in members.items():
        m._computed = None
        out[name] = m.compute()
    return out


def timed_compute(members: dict, result: dict) -> dict:
    """The first ``compute()`` of every member timed, then again, then profiled; the values of the first."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    values = compute_all(members)
    torch.cuda.synchronize()
    result["compute_ms"] = (time.perf_counter() - t0) * 1e3
    result["compute_again_ms"] = timed_ms(lambda: compute_all(members))
    prof = compute_profile(lambda: compute_all(members))
    if prof["device_ms"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms"] / result["compute_again_ms"]
    result["compute_profile"] = prof
    return values


def update_profile(make, update, batches, ms_per_step: float, warm: int = 0) -> dict:
    """Device time per update step on a new ``make()`` (the first 2 steps in the profiler's warm-up), after
    ``warm`` untimed steps."""
    obj = make()
    for batch in batches[:warm]:
        update(obj, batch)
    prof = profile_steps(lambda *b: update(obj, b), batches[warm:], owners=(obj,))
    if prof["device_ms_per_step"] is not None:
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / ms_per_step
    return prof


# ---- phase 11: ranking_imagenet
def ranking_batches(seed: int = 30) -> list:
    """ImageNet-1k validation rows as softmax scores (B, C) with multi-label targets of 1 to 3
    positives a row (the ImageNet-ReaL relabelling gives some images several), the first positive
    (the row's arg-max 75% of the time) as the class, and a second seeded model's softmax as ``q``.
    Update 7's scores are rounded to multiples of 2**-12, so that tie runs form."""
    steps, batch, labels = RANKING_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    rows = torch.arange(batch, device=EVAL_DEVICE)
    out = []
    for step in range(steps):
        logits = torch.randn(batch, labels, generator=g, device=EVAL_DEVICE) * 2.0
        uniform = torch.randint(0, labels, (batch,), generator=g, device=EVAL_DEVICE)
        keep = torch.rand(batch, generator=g, device=EVAL_DEVICE) < 0.75
        cls = torch.where(keep, logits.argmax(dim=1), uniform)
        n_pos = torch.randint(1, 4, (batch, 1), generator=g, device=EVAL_DEVICE)
        extra = torch.randint(0, labels, (batch, 2), generator=g, device=EVAL_DEVICE)
        target = torch.zeros(batch, labels, dtype=torch.int64, device=EVAL_DEVICE)
        target[rows, cls] = 1
        target.scatter_reduce_(1, extra, (n_pos > torch.arange(1, 3, device=EVAL_DEVICE)).to(torch.int64), "amax")
        preds = torch.softmax(logits, dim=1)
        if step == 7:
            preds = torch.round(preds * 4096) / 4096
        q = torch.softmax(logits * 0.5 + torch.randn(batch, labels, generator=g, device=EVAL_DEVICE), dim=1)
        out.append((preds, target, cls, q))
    return out


def ranking_members(mt, device) -> dict:
    return {
        "coverage": mt.CoverageError(device=device),
        "lrap": mt.LabelRankingAveragePrecision(device=device),
        "ranking_loss": mt.LabelRankingLoss(device=device),
        "hinge_cs": mt.HingeLoss(multiclass_mode="crammer-singer", device=device),
        "hinge_ova": mt.HingeLoss(multiclass_mode="one-vs-all", device=device),
        "kl": mt.KLDivergence(device=device),
    }


def ranking_update(members: dict, batch) -> None:
    preds, target, cls, q = batch
    for name in ("coverage", "lrap", "ranking_loss"):
        members[name].update(preds, target)
    members["hinge_cs"].update(preds, cls)
    members["hinge_ova"].update(preds, cls)
    members["kl"].update(preds, q)


def ranking_path(mt, checks, histogram, card: str) -> dict:
    """Phase 11: the multi-label ranking metrics, HingeLoss (both modes) and KLDivergence over the
    50,000 ImageNet-1k validation rows in 50 updates."""
    from metrics_tpu_torch.functional.classification import ranking as ranking_fn

    batches = ranking_batches()
    steps, batch, labels = RANKING_SHAPE
    make = lambda: ranking_members(mt, EVAL_DEVICE)  # noqa: E731
    runs, launches, members = time_runs(make, ranking_update, batches, checks, histogram)
    result = {"n": steps * batch, "labels": labels, "steps": steps, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": median(runs), "kernel_launches": launches}
    result["update_profile"] = update_profile(make, ranking_update, batches[:8], result["update_ms_per_step"])
    result["update_peak_extra_bytes"] = peak_extra_bytes(lambda: ranking_update(make(), batches[0]))
    preds, target = batches[0][0], batches[0][1]
    result["lrap_block_rows"] = max(1, ranking_fn.LRAP_BLOCK_BYTES // (2 * labels * labels))  # int16 counts
    result["lrap_peak_extra_bytes"] = peak_extra_bytes(lambda: ranking_fn._lrap_rank_counts(preds, target == 1))
    assert result["lrap_block_rows"] * 2 * labels * labels <= 256 * 2**20, "an LRAP block over 256 MiB"
    result["lrap_compare"] = op_profile(lambda: ranking_fn._lrap_rank_counts(preds, target == 1),
                                        bytes_moved=batch * labels * (4 + 8 + 2 * 4), ops=4 * batch * labels * labels)
    values = timed_compute(members, result)

    # the CPU twin: every batch if it fits CPU_TWIN_S, else the first ones against a card twin fed the same
    cpu = ranking_members(mt, "cpu")
    cpu_batches = [tuple(t.cpu() for t in b) for b in batches[:1]]
    t0 = time.perf_counter()
    ranking_update(cpu, cpu_batches[0])
    once = time.perf_counter() - t0
    twin_steps = cpu_twin_steps(once, steps)
    for b in batches[1:twin_steps]:
        ranking_update(cpu, tuple(t.cpu() for t in b))
    card_twin = members
    if twin_steps < steps:
        card_twin = ranking_members(mt, EVAL_DEVICE)
        for b in batches[:twin_steps]:
            ranking_update(card_twin, b)
    for name, cpu_m in cpu.items():
        for state, want in cpu_m.metric_state.items():
            # counts and the coverage sums (integers below 2**24 in every order) bit for bit
            exact = state in ("total", "sample_weight") or name == "coverage"
            assert_state_close(getattr(card_twin[name], state), want, f"ranking {name}.{state}",
                               rtol=0.0 if exact else RANKING_RTOL, atol=0.0 if exact else 1e-6)
    err = {name: assert_curve_close(compute_all(card_twin)[name], value, f"ranking {name}", atol=1e-6, rtol=RANKING_RTOL)
           for name, value in compute_all(cpu).items()}
    result.update(values={k: (float(v) if v.numel() == 1 else float(v.mean())) for k, v in values.items()},
                  cpu_twin_steps=twin_steps, cpu_s_per_update=once, max_abs_err_vs_cpu=err)
    assert launches == 0, f"ranking: {launches} bincount launches"
    log(f"ranking_imagenet N={result['n']} L={labels}: update {result['update_ms_per_step']:.3f} ms/step (runs {runs}), "
        f"compute {result['compute_ms']:.3f} ms (again {result['compute_again_ms']:.3f}); values {result['values']}; "
        f"peak extra {result['update_peak_extra_bytes']} bytes an update (LRAP blocks of {result['lrap_block_rows']} "
        f"rows, {result['lrap_peak_extra_bytes']} bytes); CPU twin over {twin_steps} of {steps} updates "
        f"({once:.2f} s an update on the CPU), max |err| {err}  [{card}]")
    log(f"ranking_imagenet profiles: update {json.dumps(result['update_profile'])}; compute "
        f"{json.dumps(result['compute_profile'])}; LRAP compare {json.dumps(result['lrap_compare'])}  [{card}]")
    return result


# ---- phase 12: regression_2p24
def regression_batches(seed: int = 31, shape=None) -> list:
    """The evaluation shard of a demand-forecasting or claims model: targets >= 0 with about 30%
    exact zeros, predictions > 0 (a Tweedie objective with 1 < power < 2 is the usual loss)."""
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    steps, rows = (shape or REGRESSION_SHAPE)[0], (shape or REGRESSION_SHAPE)[1:]
    out = []
    for _ in range(steps):
        level = torch.exp(torch.randn(rows, generator=g, device=EVAL_DEVICE) * 0.8)
        zero = torch.rand(rows, generator=g, device=EVAL_DEVICE) < 0.3
        target = torch.where(zero, 0.0, level * torch.exp(torch.randn(rows, generator=g, device=EVAL_DEVICE) * 0.3))
        out.append((level * 0.7 + 0.05, target))
    return out


def regression_suite(mt, device):
    return mt.MetricCollection({
        "mse": mt.MeanSquaredError(device=device),
        "mae": mt.MeanAbsoluteError(device=device),
        "msle": mt.MeanSquaredLogError(device=device),
        "mape": mt.MeanAbsolutePercentageError(device=device),
        "smape": mt.SymmetricMeanAbsolutePercentageError(device=device),
        "wmape": mt.WeightedMeanAbsolutePercentageError(device=device),
        "cosine": mt.CosineSimilarity(device=device),
        "explained_variance": mt.ExplainedVariance(device=device),
        "r2": mt.R2Score(device=device),
        "pearson": mt.PearsonCorrCoef(device=device),
        "spearman": mt.SpearmanCorrCoef(device=device),
        "tweedie": mt.TweedieDevianceScore(power=1.5, device=device),
    })


def multioutput_suite(mt, device):
    outputs = MULTIOUTPUT_SHAPE[2]
    return mt.MetricCollection({
        "r2": mt.R2Score(num_outputs=outputs, multioutput="raw_values", device=device),
        "explained_variance": mt.ExplainedVariance(multioutput="raw_values", device=device),
        "mse": mt.MeanSquaredError(num_outputs=outputs, device=device),
    })


def regression_path(mt, checks, histogram, card: str) -> dict:
    """Phase 12: all twelve regression metrics over 2**24 rows in 64 updates, one compute; then
    R2Score, ExplainedVariance and MeanSquaredError per output over 16 updates of (65,536, 16)."""
    from metrics_tpu_torch.functional.regression.correlation import _rank_data

    batches = regression_batches()
    n = sum(p.numel() for p, _ in batches)
    make = lambda: regression_suite(mt, EVAL_DEVICE)  # noqa: E731
    runs, launches, suite = time_runs(make, update_batch, batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert ["cosine", "spearman"] in groups, f"regression: groups {groups}"
    result = {"n": n, "steps": len(batches), "groups": groups, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": median(runs), "kernel_launches": launches}
    result["update_profile"] = update_profile(make, update_batch, batches[:10], result["update_ms_per_step"])
    members = dict(suite.items(keep_base=True, copy_state=False))
    spearman = members["spearman"]
    result["buffered_bytes_on_card"] = sum(t.numel() * t.element_size() for t in spearman.preds + spearman.target)
    result["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all(members))
    values = timed_compute(members, result)
    all_preds = torch.cat([p for p, _ in batches])
    result["spearman_sort"] = op_profile(lambda: torch.sort(all_preds), bytes_moved=(4 + 4 + 8) * n, ops=0)
    result["spearman_rank"] = op_profile(lambda: _rank_data(all_preds), bytes_moved=(4 + 4) * n, ops=0)
    result["spearman_rank_searchsorted"] = op_profile(lambda: searchsorted_ranks(all_preds), bytes_moved=(4 + 4) * n,
                                                      ops=0)
    assert torch.equal(_rank_data(all_preds), searchsorted_ranks(all_preds)), "regression: the two rankings differ"
    result["spearman_nan"] = spearman_nan_case(mt, all_preds, torch.cat([t for _, t in batches]))

    cpu = regression_suite(mt, "cpu")
    t0 = time.perf_counter()
    for p, t in batches:
        cpu.update(p.cpu(), t.cpu())
    result["cpu_update_s"] = time.perf_counter() - t0
    cpu_members = dict(cpu.items(keep_base=True, copy_state=False))
    for name, cpu_m in cpu_members.items():
        for state, want in cpu_m.metric_state.items():
            exact = isinstance(want, list) or not want.is_floating_point() or state == "n_obs"
            assert_state_close(getattr(members[name], state), want, f"regression {name}.{state}",
                               rtol=0.0 if exact else REGRESSION_RTOL, atol=0.0 if exact else 1e-6)
    t0 = time.perf_counter()
    want = {k: m.compute() for k, m in cpu_members.items()}
    result["cpu_compute_s"] = time.perf_counter() - t0
    err = {k: assert_curve_close(values[k], w, f"regression {k}", atol=SPEARMAN_ATOL if k == "spearman" else 1e-6,
                                 rtol=0.0 if k == "spearman" else REGRESSION_RTOL) for k, w in want.items()}
    result.update(values={k: float(v) for k, v in values.items()}, max_abs_err_vs_cpu=err)

    mo_batches = regression_batches(seed=32, shape=MULTIOUTPUT_SHAPE)
    mo = multioutput_suite(mt, EVAL_DEVICE)
    mo_cpu = multioutput_suite(mt, "cpu")
    settle(mo)
    t0 = time.perf_counter()
    for p, t in mo_batches:
        mo.update(p, t)
    settle(mo)
    result["multioutput_update_ms_per_step"] = (time.perf_counter() - t0) / len(mo_batches) * 1e3
    for p, t in mo_batches:
        mo_cpu.update(p.cpu(), t.cpu())
    mo_values, mo_want = mo.compute(), mo_cpu.compute()
    result["multioutput_max_abs_err_vs_cpu"] = {
        k: assert_curve_close(mo_values[k], w, f"multioutput {k}", atol=1e-6, rtol=REGRESSION_RTOL) for k, w in mo_want.items()}
    assert all(v.shape == (MULTIOUTPUT_SHAPE[2],) for v in mo_values.values())
    assert launches == 0, f"regression: {launches} bincount launches"
    log(f"regression_2p24 N={n}: update {result['update_ms_per_step']:.4f} ms/step (runs {runs}), compute "
        f"{result['compute_ms']:.2f} ms (again {result['compute_again_ms']:.2f}; CPU {result['cpu_compute_s']:.1f} s), "
        f"peak extra {result['compute_peak_extra_bytes']} bytes; values {result['values']}; max |err| vs CPU {err}; "
        f"multi-output (16 x 65,536 x 16) {result['multioutput_update_ms_per_step']:.4f} ms/step, max |err| "
        f"{result['multioutput_max_abs_err_vs_cpu']}  [{card}]")
    log(f"regression_2p24 profiles: update {json.dumps(result['update_profile'])}; compute "
        f"{json.dumps(result['compute_profile'])}; sort {json.dumps(result['spearman_sort'])}; ranks "
        f"{json.dumps(result['spearman_rank'])}; ranks by searchsorted {json.dumps(result['spearman_rank_searchsorted'])}"
        f"; NaN case {json.dumps(result['spearman_nan'])}  [{card}]")
    return result


def searchsorted_ranks(data):
    """Average-tie ranks by one sort and two ``searchsorted`` passes, the form the ranks took before
    (and take in the JAX package): timed beside the sort-run ranks; they agree where there is no NaN."""
    sorted_data = torch.sort(data).values
    lower = torch.searchsorted(sorted_data, data, side="left")
    upper = torch.searchsorted(sorted_data, data, side="right")
    return (lower + upper - 1) / 2.0 + 1.0


def spearman_nan_case(mt, preds, target) -> dict:
    """Spearman over the 2**24 rows with every 97th prediction NaN: the card's ranks equal the CPU
    twin's bit for bit, and the coefficient is finite and within ``SPEARMAN_ATOL`` of the CPU's."""
    from metrics_tpu_torch.functional.regression.correlation import _rank_data

    nan_preds = preds.clone()
    nan_preds[::97] = float("nan")
    ranks = _rank_data(nan_preds)
    assert torch.equal(ranks.cpu(), _rank_data(nan_preds.cpu())), "spearman NaN: the card's ranks differ from the CPU's"
    got = mt.functional.spearman_corrcoef(nan_preds, target)
    want = mt.functional.spearman_corrcoef(nan_preds.cpu(), target.cpu())
    err = assert_curve_close(got, want, "spearman NaN", atol=SPEARMAN_ATOL)
    assert torch.isfinite(got), "spearman NaN: not finite"
    return {"nan_rows": int(torch.isnan(nan_preds).sum()), "value": float(got), "cpu_value": float(want),
            "abs_err": err, "ranks_bit_equal": True}


# ---- phase 13: pairwise_embeddings
def pairwise_path(mt, card: str) -> dict:
    """Phase 13: the four pairwise functions on x (4096, 768) against y (8192, 768), reduction None
    and "mean", then x against itself with its zero diagonal; Manhattan in its row blocks."""
    from metrics_tpu_torch.functional.pairwise import distances

    n, m, d = PAIRWISE_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(33)
    x = torch.randn(n, d, generator=g, device=EVAL_DEVICE)
    y = torch.randn(m, d, generator=g, device=EVAL_DEVICE)
    x_cpu, y_cpu = x.cpu(), y.cpu()
    rows = PAIRWISE_CPU_ROWS
    result = {"n": n, "m": m, "d": d, "cpu_rows": rows, "card": card}
    block_rows = max(1, distances.MANHATTAN_BLOCK_BYTES // (4 * m * d))
    assert block_rows * m * d * 4 <= 256 * 2**20, "a Manhattan block over 256 MiB"
    result["manhattan_block_rows"] = block_rows
    for name in ("cosine_similarity", "euclidean_distance", "linear_similarity", "manhattan_distance"):
        fn = getattr(mt.functional, f"pairwise_{name}")
        out = {}
        for label, args, cpu_args in (("xy", (x, y), (x_cpu[:rows], y_cpu)), ("xx", (x,), (x_cpu[:rows], x_cpu))):
            full = fn(*args)
            want = fn(*cpu_args, zero_diagonal=True) if label == "xx" else fn(*cpu_args)
            err = assert_curve_close(full[:rows], want, f"pairwise {name} {label}", atol=PAIRWISE_ATOL, rtol=PAIRWISE_RTOL)
            mean = fn(*args, reduction="mean")
            torch.testing.assert_close(mean, full.mean(dim=-1), rtol=1e-5, atol=1e-5, msg=f"pairwise {name} mean")
            if label == "xx":
                assert bool((torch.diagonal(full) == 0).all()), f"pairwise {name}: the diagonal is not zero"
            out[label] = {"ms": timed_ms(lambda: fn(*args), repeats=3),
                          "mean_ms": timed_ms(lambda: fn(*args, reduction="mean"), repeats=3),
                          "max_abs_err_vs_cpu": err,
                          "peak_extra_bytes": peak_extra_bytes(lambda: fn(*args))}
            del full
        cols = m
        flops = (3 if name == "manhattan_distance" else 2) * n * cols * d
        out["xy"]["profile"] = op_profile(lambda: fn(x, y), bytes_moved=4 * (n * d + m * d + n * m), ops=flops)
        result[name] = out
        log(f"pairwise {name}: x·y {out['xy']['ms']:.3f} ms (mean {out['xy']['mean_ms']:.3f}), x·x "
            f"{out['xx']['ms']:.3f} ms, peak extra {out['xy']['peak_extra_bytes']} bytes, max |err| vs CPU "
            f"({rows} rows) {out['xy']['max_abs_err_vs_cpu']:.3g} / {out['xx']['max_abs_err_vs_cpu']:.3g}; device "
            f"{json.dumps(out['xy']['profile'])}  [{card}]")
    return result


# ---- phase 14: retrieval_msmarco
def retrieval_batches(seed: int = 34, graded: bool = False, steps: int = 0) -> list:
    """MS MARCO passage re-ranking, dev-small shape: 6,980 queries of 1,000 candidates, 100 queries
    an update (the last 80), int64 query ids, float32 scores rounded to multiples of 2**-10 (ties),
    int64 relevance: one relevant passage for most queries, two for about 5%, none for about 1%
    (graded 0 to 3, as in the TREC DL qrels, with ``graded``). ``steps`` cuts it to the first ones."""
    total, per_update, cands = RETRIEVAL_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    out = []
    for step in range(steps or -(-total // per_update)):
        queries = min(per_update, total - step * per_update)
        qid = torch.arange(step * per_update, step * per_update + queries, device=EVAL_DEVICE) * 1009 + 524_288
        indexes = qid.repeat_interleave(cands)
        scores = torch.randn(queries, cands, generator=g, device=EVAL_DEVICE)
        first = torch.randint(0, cands, (queries,), generator=g, device=EVAL_DEVICE)
        second = torch.randint(0, cands, (queries,), generator=g, device=EVAL_DEVICE)
        u = torch.rand(queries, generator=g, device=EVAL_DEVICE)
        rel = torch.zeros(queries, cands, dtype=torch.int64, device=EVAL_DEVICE)
        rows = torch.arange(queries, device=EVAL_DEVICE)
        rel[rows, first] = (u >= 0.01).to(torch.int64)
        rel[rows, second] = torch.maximum(rel[rows, second], (u >= 0.95).to(torch.int64))
        if graded:
            rel = rel * torch.randint(1, 4, rel.shape, generator=g, device=EVAL_DEVICE)
            rel = torch.maximum(rel, (torch.rand(rel.shape, generator=g, device=EVAL_DEVICE) < 0.01).to(torch.int64))
        scores = scores + 2.0 * (rel > 0)
        preds = torch.round(torch.sigmoid(scores) * 1024) / 1024
        out.append((preds.reshape(-1), rel.reshape(-1), indexes))
    return out


def retrieval_suite(mt, device):
    return mt.MetricCollection({
        "mrr": mt.RetrievalMRR(device=device),
        "map": mt.RetrievalMAP(device=device),
        "ndcg@10": mt.RetrievalNormalizedDCG(k=10, device=device),
        "p@10": mt.RetrievalPrecision(k=10, device=device),
        "r@100": mt.RetrievalRecall(k=100, device=device),
        "hit@10": mt.RetrievalHitRate(k=10, device=device),
        "r_precision": mt.RetrievalRPrecision(device=device),
        "fallout@10": mt.RetrievalFallOut(k=10, device=device),
        "pr_curve": mt.RetrievalPrecisionRecallCurve(max_k=100, device=device),
        "recall@p0.1": mt.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100, device=device),
    })


def retrieval_path(mt, checks, histogram, card: str) -> dict:
    """Phase 14: ten retrieval metrics in one collection over 6,980 queries x 1,000 candidates in
    70 updates, one compute (twice: the same bits), graded NDCG, and the nine one-query functions."""
    from metrics_tpu_torch.functional.retrieval.kernels import _descending_order
    from metrics_tpu_torch.ops import segments
    from metrics_tpu_torch.retrieval.base import group_rows

    batches = retrieval_batches()
    total, queries, cands = RETRIEVAL_SHAPE
    steps, n = len(batches), total * cands
    make = lambda: retrieval_suite(mt, EVAL_DEVICE)  # noqa: E731
    runs, _, suite = time_runs(make, update_batch, batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert len(groups) == 1, f"retrieval: groups {groups}"
    result = {"n": n, "queries": total, "steps": steps, "card": card, "update_ms_per_step_runs": runs,
              "update_ms_per_step": median(runs)}
    result["update_profile"] = update_profile(make, update_batch, batches[:10], result["update_ms_per_step"])
    members = dict(suite.items(keep_base=True, copy_state=False))
    leader = members["mrr"]
    result["buffered_bytes_on_card"] = sum(t.numel() * t.element_size() for t in leader.preds + leader.target + leader.indexes)

    histogram.KERNEL_LAUNCHES = 0
    result["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all(members))
    result["kernel_launches"] = histogram.KERNEL_LAUNCHES
    assert result["kernel_launches"] == len(members), f"retrieval: {result['kernel_launches']} bincount launches"
    values = timed_compute(members, result)
    again = compute_all(members)
    for k, v in values.items():  # a second compute() gives the same bits
        for a, b in zip(v if isinstance(v, tuple) else (v,), again[k] if isinstance(v, tuple) else (again[k],)):
            assert a.dtype == b.dtype and torch.equal(a, b), f"retrieval {k}: a second compute() differs"

    graded = mt.RetrievalNormalizedDCG(k=10, device=EVAL_DEVICE)
    graded_batches = retrieval_batches(seed=35, graded=True)
    for b in graded_batches:
        graded.update(*b)
    histogram.KERNEL_LAUNCHES = 0
    graded_value = graded.compute()
    result["kernel_launches"] += histogram.KERNEL_LAUNCHES
    graded._computed = None
    assert torch.equal(graded.compute(), graded_value), "graded NDCG: a second compute() differs"

    # the grouping's sort, its counts and the segmented scan on every row, beside their bounds
    preds = torch.cat([b[0] for b in batches])
    target = torch.cat([b[1] for b in batches])
    indexes = torch.cat([b[2] for b in batches])
    ctx = group_rows(indexes, preds, target)
    seg_raw = torch.unique(indexes, return_inverse=True)[1]

    def lexsort():
        order1 = _descending_order(preds)
        return order1[torch.argsort(seg_raw[order1], stable=True)]

    result["grouping_sort"] = op_profile(lexsort, bytes_moved=(4 + 8 + 8) * n, ops=0)
    result["segmented_scan"] = op_profile(lambda: segments.segment_cumsum(ctx.rel, ctx.seg, ctx.num_groups),
                                          bytes_moved=(4 + 8 + 4) * n, ops=n * max(1, (n - 1).bit_length()))
    result["segment_count"] = op_profile(lambda: segments.segment_count(ctx.seg, ctx.num_groups),
                                         bytes_moved=8 * n + 4 * ctx.num_groups, ops=0)

    # the CPU twin: every update if that fits RETRIEVAL_CPU_TWIN_S, else the first 10, against a
    # card suite fed the same 10
    cpu = retrieval_suite(mt, "cpu")
    twin = retrieval_suite(mt, EVAL_DEVICE)
    for b in batches[:10]:
        cpu.update(*(t.cpu() for t in b))
        twin.update(*b)
    t0 = time.perf_counter()
    want = cpu.compute()
    cpu_once = time.perf_counter() - t0
    twin_steps = 10
    if cpu_once * steps / 10 <= RETRIEVAL_CPU_TWIN_S:
        cpu, twin_steps = retrieval_suite(mt, "cpu"), steps
        for b in batches:
            cpu.update(*(t.cpu() for t in b))
        want = cpu.compute()
        got = values
    else:
        got = twin.compute()
    err = {k: assert_curve_close(got[k], w, f"retrieval {k}", atol=RETRIEVAL_ATOL) for k, w in want.items()}
    if twin_steps == steps:
        cpu_graded = mt.RetrievalNormalizedDCG(k=10, device="cpu")
        for b in graded_batches:
            cpu_graded.update(*(t.cpu() for t in b))
        err["graded_ndcg@10"] = assert_curve_close(graded_value, cpu_graded.compute(), "graded ndcg", atol=RETRIEVAL_ATOL)
    cpu_ctx = group_rows(indexes[: 10 * queries * cands].cpu(), preds[: 10 * queries * cands].cpu(),
                         target[: 10 * queries * cands].cpu())
    twin_ctx = group_rows(indexes[: 10 * queries * cands], preds[: 10 * queries * cands], target[: 10 * queries * cands])
    for field in ("seg", "preds", "rel", "ranks", "cumrel", "counts", "starts", "n_pos"):
        assert torch.equal(getattr(twin_ctx, field).cpu(), getattr(cpu_ctx, field)), f"retrieval grouping {field} differs"

    # the nine one-query functions on 100 queries, against the CPU
    functional = {
        "retrieval_average_precision": {}, "retrieval_reciprocal_rank": {}, "retrieval_precision": {"k": 10},
        "retrieval_recall": {"k": 100}, "retrieval_fall_out": {"k": 10}, "retrieval_hit_rate": {"k": 10},
        "retrieval_r_precision": {}, "retrieval_normalized_dcg": {"k": 10},
        "retrieval_precision_recall_curve": {"max_k": 100},
    }
    q_preds, q_target = batches[0][0].reshape(queries, cands), batches[0][1].reshape(queries, cands)
    t0 = time.perf_counter()
    fn_err = {}
    for name, kwargs in functional.items():
        fn = getattr(mt.functional, name)
        for q in range(queries):
            fn_err[name] = max(fn_err.get(name, 0.0), assert_curve_close(
                fn(q_preds[q], q_target[q], **kwargs), fn(q_preds[q].cpu(), q_target[q].cpu(), **kwargs),
                f"{name} query {q}", atol=RETRIEVAL_ATOL))
    result["functional_s"] = time.perf_counter() - t0
    result.update(values={k: (float(v) if not isinstance(v, tuple) else [float(x.float().mean()) for x in v])
                          for k, v in values.items()},
                  graded_ndcg=float(graded_value), cpu_twin_steps=twin_steps, cpu_compute_s_10_updates=cpu_once,
                  max_abs_err_vs_cpu=err, functional_max_abs_err=fn_err, deterministic=True)
    log(f"retrieval_msmarco {total} queries x {cands} in {steps} updates: update {result['update_ms_per_step']:.4f} ms/step "
        f"(runs {runs}), compute {result['compute_ms']:.1f} ms (again {result['compute_again_ms']:.1f}), "
        f"{result['kernel_launches']} bincount launches, peak extra {result['compute_peak_extra_bytes']} bytes; "
        f"a second compute() the same bits; values {result['values']}; graded NDCG@10 {result['graded_ndcg']:.6f}; "
        f"CPU twin over {twin_steps} of {steps} updates (10 updates: {cpu_once:.1f} s to compute on the CPU); "
        f"max |err| {err}; functional on {queries} queries {fn_err}  [{card}]")
    log(f"retrieval_msmarco profiles: update {json.dumps(result['update_profile'])}; compute "
        f"{json.dumps(result['compute_profile'])}; grouping sort {json.dumps(result['grouping_sort'])}; segmented scan "
        f"{json.dumps(result['segmented_scan'])}; segment count {json.dumps(result['segment_count'])}  [{card}]")
    return result


def eval_paths(mt, checks, histogram, card: str) -> dict:
    """Phases 11 to 14."""
    out = {"ranking_imagenet": ranking_path(mt, checks, histogram, card),
           "regression_2p24": regression_path(mt, checks, histogram, card),
           "pairwise_embeddings": pairwise_path(mt, card),
           "retrieval_msmarco": retrieval_path(mt, checks, histogram, card)}
    out["kernel_launches"] = sum(out[k]["kernel_launches"] for k in ("ranking_imagenet", "regression_2p24",
                                                                     "retrieval_msmarco"))
    return out


# ------------------------------------------------------------------ phases 15 and 16
WRAPPERS_SHAPE = CURVES_IMAGENET_SHAPE  # updates, rows an update, classes: the ImageNet-1k validation set
BOOT_CLONES = 100  # BootStrapper clones over Accuracy
BOOT_CONFMAT_CLONES = 20  # BootStrapper clones over ConfusionMatrix
BOOT_QUANTILES = [0.025, 0.975]
TRACKER_EPOCHS = 5  # MetricTracker: epochs of TRACKER_STEPS updates
TRACKER_STEPS = 10
TRACKER_BOOT_CLONES = 10  # clones of the BootStrapper inside the tracked collection
MULTIOUTPUT_NAN_SHARE = 0.01  # rows of each multi-output update with a NaN in one column
# the bootstrap statistics (mean, std, linear quantiles of 100 clones' float32 values) reduce in
# another order on each side; the clones' counts are bit for bit
WRAPPER_ATOL, WRAPPER_RTOL = 1e-6, 1e-5
IMAGE_SHAPE = (20, 10, 3, 512, 512)  # updates, images an update, channels, height, width: DIV2K val as 2 crops each
SPECTRAL_SHAPE = (4, 8, 4, 256, 256)  # updates, patches an update, bands, height, width: 4-band pan-sharpening
IMAGE_ATOL = 1e-4  # the JAX package's image tests (tests/image/test_image.py:53)
ERGAS_ATOL = 1e-2  # tests/image/test_image.py:202
IMAGE_CPU_TWIN_S = 10.0  # the image CPU twin computes every image only if that takes about this long


class DrawLog:
    """BootStrapper's draw matrices on the card, recorded, then replayed to a CPU twin: the two samplers
    get the same matrices (the fused and the eager path both draw through ``_draw_matrix``); no two
    generators are trusted to agree."""

    def __init__(self):
        from metrics_tpu_torch.wrappers import bootstrapping

        self.module, self.real, self.draws = bootstrapping, bootstrapping._draw_matrix, []

    def record(self):
        def draw(*args):
            out = self.real(*args)
            self.draws.append(out.cpu())
            return out

        self.module._draw_matrix = draw

    def replay(self, start: int = 0):
        queue = iter(list(self.draws[start:]))
        self.module._draw_matrix = lambda size, clones, strategy, generator: next(queue).to(generator.device)

    def restore(self):
        self.module._draw_matrix = self.real


def tree_states(metric) -> dict:
    """(node, state) -> state of every metric in a tree, a list state concatenated."""
    out = {}
    for name, node in suite_nodes({"m": metric}).items():
        for state, value in node.metric_state.items():
            out[(name, state)] = torch.cat(value) if isinstance(value, list) and value else value
    return out


def assert_tree_close(got, want, label: str, float_rtol: float = 0.0) -> None:
    """Every state of a metric tree on the card against its CPU twin's: counts bit for bit, floats
    within ``float_rtol`` where it is given."""
    got_states, want_states = tree_states(got), tree_states(want)
    assert got_states.keys() == want_states.keys(), f"{label}: trees differ"
    for key, w in want_states.items():
        if isinstance(w, list):
            assert got_states[key] == [], f"{label} {key}: rows on one side only"
            continue
        assert_state_close(got_states[key], w, f"{label} {key}", rtol=float_rtol if w.is_floating_point() else 0.0,
                           atol=1e-6 if float_rtol and w.is_floating_point() else 0.0)


def assert_values_close(got, want, label: str, atol: float, rtol: float) -> float:
    """A result (a tensor, or a dict or list of them) on the card against the CPU's."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), f"{label}: keys differ"
        return max((assert_values_close(got[k], w, f"{label} {k}", atol, rtol) for k, w in want.items()), default=0.0)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{label}: {len(got)} values, not {len(want)}"
        return max((assert_values_close(g, w, label, atol, rtol) for g, w in zip(got, want)), default=0.0)
    got, want = torch.as_tensor(got), torch.as_tensor(want)  # Python numbers (BERTScore's lists) as tensors
    exact = not want.is_floating_point()
    return assert_curve_close(got, want, label, atol=0.0 if exact else atol, rtol=0.0 if exact else rtol)


def wrapper_batches(seed: int = 40) -> list:
    """Softmax rows (B, C) and int64 labels: the row's arg-max 75% of the time, else uniform."""
    steps, batch, num_classes = WRAPPERS_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        probs = torch.softmax(torch.randn(batch, num_classes, generator=g, device=EVAL_DEVICE) * 2.0, dim=1)
        uniform = torch.randint(0, num_classes, (batch,), generator=g, device=EVAL_DEVICE)
        keep = torch.rand(batch, generator=g, device=EVAL_DEVICE) < 0.75
        out.append((probs, torch.where(keep, probs.argmax(dim=1), uniform)))
    return out


def f1_of(mt, device, num_classes):
    """2PR / (P + R) of macro Precision and Recall."""
    p = mt.Precision(num_classes=num_classes, average="macro", device=device)
    r = mt.Recall(num_classes=num_classes, average="macro", device=device)
    return 2 * p * r / (p + r)


WRAPPER_MEMBERS = ("boot_poisson", "boot_multinomial", "boot_confmat", "classwise", "minmax", "f1")


def wrapper_member(mt, name: str, device):
    """One of phase 15's wrapped metrics, each fed every batch."""
    c = WRAPPERS_SHAPE[2]
    acc = lambda **kw: mt.Accuracy(num_classes=c, device=device, **kw)  # noqa: E731
    if name.startswith("boot_") and name != "boot_confmat":
        return mt.BootStrapper(acc(average="macro"), num_bootstraps=BOOT_CLONES, quantile=BOOT_QUANTILES, raw=True,
                               sampling_strategy=name[len("boot_"):])
    if name == "boot_confmat":
        return mt.BootStrapper(mt.ConfusionMatrix(num_classes=c, device=device), num_bootstraps=BOOT_CONFMAT_CLONES)
    if name == "classwise":
        return mt.ClasswiseWrapper(acc(average=None), labels=[f"class_{i:04d}" for i in range(c)])
    if name == "minmax":
        return mt.MinMaxMetric(acc())
    return f1_of(mt, device, c)


def forward_batch(metric, batch) -> None:
    metric(*batch)


def tracked_collection(mt, device):
    c = WRAPPERS_SHAPE[2]
    return mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=c, average="macro", device=device),
        "f1": f1_of(mt, device, c),
        "classwise": mt.ClasswiseWrapper(mt.Accuracy(num_classes=c, average=None, device=device)),
        "minmax": mt.MinMaxMetric(mt.Accuracy(num_classes=c, device=device)),
        "boot": mt.BootStrapper(mt.Accuracy(num_classes=c, average="macro", device=device),
                                num_bootstraps=TRACKER_BOOT_CLONES),
    })


def run_tracker(tracker, batches) -> None:
    for epoch in range(TRACKER_EPOCHS):
        tracker.increment()
        for batch in batches[epoch * TRACKER_STEPS:(epoch + 1) * TRACKER_STEPS]:
            tracker.update(*batch)


def multioutput_nan_batches(seed: int = 41) -> list:
    """The regression phase's multi-output rows with a NaN in one column of 1% of the rows."""
    out = []
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    for preds, target in regression_batches(seed=seed, shape=MULTIOUTPUT_SHAPE):
        rows, outputs = preds.shape
        n_nan = int(rows * MULTIOUTPUT_NAN_SHARE)
        idx = torch.randperm(rows, generator=g, device=EVAL_DEVICE)[:n_nan]
        col = torch.randint(0, outputs, (n_nan,), generator=g, device=EVAL_DEVICE)
        preds = preds.clone()
        preds[idx, col] = float("nan")
        out.append((preds, target))
    return out


# a wrapper run's steady state starts after the first, eager call and the certified fused steps
WRAPPER_STEADY_FROM = 5
# The wrappers with a fused path: the attribute that turns it off (the eager run sets it False), and the
# program attribute that shows it engaged
FUSED_ATTRS = {"boot_poisson": ("_boot_ok", "_boot_program"), "boot_multinomial": ("_boot_ok", "_boot_program"),
               "boot_confmat": ("_boot_ok", "_boot_program"), "minmax": ("_mm_ok", "_mm_program"),
               "multioutput_r2": ("_mo_ok", "_mo_program")}


@contextmanager
def eager_clone_rows():
    """While open, the rows of each eager BootStrapper clone update, in a list that fills (the clone's
    resampled batch: its first, eager update and the oracles of the certified fused steps)."""
    from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper

    real, rows = BootStrapper._eager_resampled_update, []

    def spy(metric, sample_idx, args, kwargs):
        rows.append(sample_idx.numel())
        return real(metric, sample_idx, args, kwargs)

    BootStrapper._eager_resampled_update = staticmethod(spy)
    try:
        yield rows
    finally:
        BootStrapper._eager_resampled_update = staticmethod(real)


def pair_histogram_updates(rows, num_classes: int) -> int:
    """Of eager clone updates of ``rows`` rows each over a stat-scores base of ``num_classes`` classes, those
    whose (C + 1)**2 class pairs are no more than the one-hot's rows x C entries: each takes the class ids
    and launches one bincount; the others keep the one-hot and launch none."""
    return sum(1 for r in rows if (num_classes + 1) ** 2 <= r * num_classes)


def wrapper_runs(name, make, update, batches, checks, histogram) -> tuple:
    """Three runs over every batch on a new ``make()`` in mode "first" (the fused path where ``name`` has
    one), then one with the fused path turned off: ms per step of each, launches and peak extra device
    memory of the first fused run and of the eager run, the rows of each eager clone update of the first
    fused run; the first fused run's object."""
    checks.set_validation_mode("first")
    out, first = {"runs": []}, None
    ok_attr = FUSED_ATTRS.get(name, (None,))[0]
    for trial in range(3 + (ok_attr is not None)):
        eager = trial == 3
        obj = make()
        if eager:
            object.__setattr__(obj, ok_attr, False)
        histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
        settle(obj)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eager_clone_rows() as clone_rows:
            for i, batch in enumerate(batches):
                if i == WRAPPER_STEADY_FROM:
                    settle(obj)
                    t_steady = time.perf_counter()
                update(obj, batch)
        settle(obj)
        t1 = time.perf_counter()
        record = {"launches": histogram.KERNEL_LAUNCHES, "batched_launches": histogram.BATCHED_LAUNCHES,
                  "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
                  "ms_per_step": (t1 - t0) / len(batches) * 1e3,
                  "steady_ms_per_step": (t1 - t_steady) / (len(batches) - WRAPPER_STEADY_FROM) * 1e3}
        ms = record["ms_per_step"]
        if trial == 0 and ok_attr is not None:  # one steady step's host reads (the fused path's, here)
            record["steady_host_reads"] = host_read_count(lambda: (update(obj, batches[-1]), settle(obj)))
        if eager:
            out["eager"] = record
        else:
            out["runs"].append(ms)
            if trial == 0:
                out["fused"], out["fused_clone_rows"], first = record, clone_rows, obj
    out["runs"].sort()
    return out, first


def assert_fused_engaged(name: str, obj) -> dict:
    """A wrapper's fused path ran and is still healthy: its program exists, its flag is True and none of its
    ladder lanes is demoted (a fused path that quietly demoted would otherwise pass)."""
    ok_attr, program_attr = FUSED_ATTRS[name]
    demoted = [lane for lane, lad in obj.__dict__.get("_fault_ladders", {}).items() if lad.demoted]
    assert getattr(obj, ok_attr) and getattr(obj, program_attr) is not None and not demoted, (
        f"wrappers {name}: fused path {ok_attr}={getattr(obj, ok_attr)}, program "
        f"{getattr(obj, program_attr) is not None}, demoted lanes {demoted}")
    return {ok_attr: True, "demoted_lanes": 0}


def wrapper_component(name, make_card, make_cpu, step, batches, checks, histogram, float_rtol: float = 0.0):
    """One wrapped metric driven by ``step(metric, batch)``: timed steps (fused and, where there is a
    fused path, eager), device profile, host reads a step, then the CPU twin (in mode "full", which the
    fused paths decline: the eager oracle, fed the card's bootstrap draws) over every batch where that
    fits ``CPU_TWIN_S``, else the first ones, against a card instance in mode "first" fed the same; then
    ``compute()`` timed and profiled on the timed run's instance."""
    timing, obj = wrapper_runs(name, make_card, step, batches, checks, histogram)
    runs = timing["runs"]
    out = {"update_ms_per_step_runs": runs, "update_ms_per_step": median(runs),
           "kernel_launches": timing["fused"]["launches"], "batched_launches": timing["fused"]["batched_launches"],
           "peak_extra_bytes": timing["fused"]["peak_extra_bytes"]}
    if timing["fused_clone_rows"]:  # a BootStrapper: its eager clone updates' rows, for the launch count
        out["eager_clone_rows"] = timing["fused_clone_rows"]
    if "eager" in timing:
        out["eager"] = timing["eager"]
        out["steady_ms_per_step"] = timing["fused"]["steady_ms_per_step"]
        out["steady_host_reads"] = timing["fused"]["steady_host_reads"]
        # the fused path's steady state: after the eager first call and the certified steps
        out["update_profile"] = update_profile(make_card, step, batches[:WRAPPER_STEADY_FROM + 6],
                                               out["steady_ms_per_step"], warm=WRAPPER_STEADY_FROM)
    else:
        out["update_profile"] = update_profile(make_card, step, batches[:6], out["update_ms_per_step"])
    probe = make_card()
    probe_profile = compute_profile(lambda: step(probe, batches[0]))
    out["update_host_reads"] = {**probe_profile["host_reads"],
                                "device_to_host_copies": probe_profile["device_to_host_copies"]}
    draws, cpu, twin = DrawLog(), make_cpu(), make_card()
    try:
        draws.record()
        step(twin, batches[0])
        draws.replay()
        checks.set_validation_mode("full")
        t0 = time.perf_counter()
        step(cpu, tuple(t.cpu() for t in batches[0]))
        once = time.perf_counter() - t0
        twin_steps = cpu_twin_steps(once, len(batches))
        draws.record()
        checks.set_validation_mode("first")
        for b in batches[1:twin_steps]:
            step(twin, b)
        settle(twin)
        draws.replay(start=1)  # the first step's draws went to the CPU already
        checks.set_validation_mode("full")
        for b in batches[1:twin_steps]:
            step(cpu, tuple(t.cpu() for t in b))
    finally:
        draws.restore()
        checks.set_validation_mode("first")
    assert_tree_close(twin, cpu, f"wrappers {name}", float_rtol)
    if name in FUSED_ATTRS:
        out["fused_health"] = assert_fused_engaged(name, obj)
        assert_fused_engaged(name, twin)
    twin._computed = None
    err = assert_values_close(twin.compute(), cpu.compute(), f"wrappers {name}", WRAPPER_ATOL,
                              max(WRAPPER_RTOL, float_rtol))
    out["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all({name: obj}))
    timed_compute({name: obj}, out)
    out.update(cpu_twin_steps=twin_steps, cpu_s_per_update=once, max_abs_err_vs_cpu=err)
    return out


def wrappers_path(mt, checks, histogram, card: str) -> dict:
    """Phase 15: the wrappers over the 50,000 ImageNet-1k validation rows in 50 updates, a tracker
    over 5 epochs, and MultioutputWrapper(R2Score) over the multi-output rows with NaNs."""
    batches = wrapper_batches()
    steps, batch, c = WRAPPERS_SHAPE
    result = {"n": steps * batch, "classes": c, "steps": steps, "card": card}
    for name in WRAPPER_MEMBERS:
        make = lambda name=name: wrapper_member(mt, name, EVAL_DEVICE)  # noqa: E731
        make_cpu = lambda name=name: wrapper_member(mt, name, "cpu")  # noqa: E731
        step = forward_batch if name == "minmax" else update_batch  # MinMaxMetric is driven by forward
        result[name] = wrapper_component(name, make, make_cpu, step, batches, checks, histogram)
    # boot_confmat, Poisson, fused from its second update: the first update and the oracles of the
    # certified steps launch once a clone, each fused update once a block of row deltas
    from metrics_tpu_torch.wrappers._fanout import DELTA_BLOCK_BYTES
    from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper

    cert = BootStrapper._POISSON_CERT_STEPS
    blocks = -(-batch // max(1, min(batch, DELTA_BLOCK_BYTES // (8 * c * c))))
    want = (BOOT_CONFMAT_CLONES * (1 + cert), blocks * (steps - 1))
    got = (result["boot_confmat"]["kernel_launches"], result["boot_confmat"]["batched_launches"])
    assert got == want, f"boot_confmat: (unbatched, batched) bincount launches {got}, not {want}"
    eager = result["boot_confmat"]["eager"]
    assert eager["launches"] == BOOT_CONFMAT_CLONES * steps and eager["batched_launches"] == 0, eager
    # Accuracy over 1000 rows of 1000 classes keeps the one-hot, its (C + 1)**2 class pairs outnumbering the
    # one-hot's entries; so do the Poisson path's per-row deltas. A Poisson clone's eager update (the first,
    # the certified steps' oracles) that drew enough rows takes the class ids: one launch each
    for name, updates in (("boot_poisson", BOOT_CLONES * (1 + cert)), ("boot_multinomial", BOOT_CLONES)):
        rows = result[name].pop("eager_clone_rows")
        assert len(rows) == updates, f"{name}: {len(rows)} eager clone updates, not {updates}"
        want = pair_histogram_updates(rows, c)
        assert result[name]["kernel_launches"] == want, f"{name}: {result[name]['kernel_launches']} launches, not {want}"
    result["boot_confmat"].pop("eager_clone_rows")
    assert all(result[k]["batched_launches"] == 0 for k in WRAPPER_MEMBERS if k != "boot_confmat")
    assert all(result[k]["kernel_launches"] == 0 for k in WRAPPER_MEMBERS if not k.startswith("boot_"))
    for name in ("boot_poisson", "boot_multinomial"):
        # the resampled rows every clone reads once (its index_select and its update) beside the update's time
        bytes_moved = BOOT_CLONES * batch * (c * 4 + 8 + 8)
        profile = result[name]["update_profile"]
        result[name]["clone_update"] = {
            "device_ms_per_clone": profile["device_ms_per_step"] / BOOT_CLONES if profile["device_ms_per_step"] else None,
            "bound_ms_per_clone": bytes_moved / HBM_BYTES_PER_S * 1e3 / BOOT_CLONES, "bound_by": "bytes"}

    # the tracker: 5 epochs of 10 updates, the best of every value and its epoch
    tracker_draws = DrawLog()
    tracker = mt.MetricTracker(tracked_collection(mt, EVAL_DEVICE), maximize=True)
    cpu_tracker = mt.MetricTracker(tracked_collection(mt, "cpu"), maximize=True)
    try:
        tracker_draws.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_tracker(tracker, batches)
        settle(tracker._history[-1])  # the earlier epochs flushed where the tracker packed them
        result["tracker_update_ms_per_step"] = (time.perf_counter() - t0) / (TRACKER_EPOCHS * TRACKER_STEPS) * 1e3
        tracker_draws.replay()
        run_tracker(cpu_tracker, [tuple(t.cpu() for t in b) for b in batches])
    finally:
        tracker_draws.restore()
    assert tracker.n_steps == cpu_tracker.n_steps == TRACKER_EPOCHS
    for step in range(tracker.n_steps):  # a finished step is a packed journal record: read it back
        a, b = tracker._step_metric(step), cpu_tracker._step_metric(step)
        for (name, m), (_, m_cpu) in zip(a.items(keep_base=True, copy_state=False),
                                         b.items(keep_base=True, copy_state=False)):
            assert_tree_close(m, m_cpu, f"tracker step {step} {name}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, best_step = tracker.best_metric(return_step=True)
    torch.cuda.synchronize()
    result["tracker_best_metric_ms"] = (time.perf_counter() - t0) * 1e3
    want_best, want_step = cpu_tracker.best_metric(return_step=True)
    assert best.keys() == want_best.keys() and best_step == want_step, "tracker: best steps differ"
    result["tracker_best_max_abs_err"] = max(abs(best[k] - want_best[k]) for k in best if best[k] == best[k])
    assert result["tracker_best_max_abs_err"] <= WRAPPER_ATOL + WRAPPER_RTOL, result["tracker_best_max_abs_err"]
    result["tracker_best"] = {k: [best[k], best_step[k]] for k in ("acc", "f1", "max", "mean")}

    # MultioutputWrapper(R2Score) over the regression phase's rows with NaNs, remove_nans=True
    mo_batches = multioutput_nan_batches()
    make_mo = lambda device=EVAL_DEVICE: mt.MultioutputWrapper(  # noqa: E731
        mt.R2Score(device=device), num_outputs=MULTIOUTPUT_SHAPE[2], remove_nans=True)
    result["multioutput_r2"] = wrapper_component("multioutput_r2", make_mo, lambda: make_mo("cpu"), update_batch,
                                                 mo_batches, checks, histogram, float_rtol=REGRESSION_RTOL)
    result["kernel_launches"] = result["boot_confmat"]["kernel_launches"]
    result["batched_launches"] = sum(result[k]["batched_launches"] for k in WRAPPER_MEMBERS + ("multioutput_r2",))
    for name in WRAPPER_MEMBERS + ("multioutput_r2",):
        r = result[name]
        eager = r.get("eager")
        fused = (f"; fused path: steady {r['steady_ms_per_step']:.3f} ms/step (from update {WRAPPER_STEADY_FROM}), "
                 f"{r['steady_host_reads']} host reads a steady update, {r['peak_extra_bytes']} bytes peak extra, "
                 f"{r['batched_launches']} batched launches; eager {eager['ms_per_step']:.3f} ms/step (steady "
                 f"{eager['steady_ms_per_step']:.3f}), {eager['launches']} launches, {eager['peak_extra_bytes']} "
                 f"bytes peak extra" if eager else "")
        log(f"wrappers_imagenet {name}: update {r['update_ms_per_step']:.3f} ms/step (runs "
            f"{[round(x, 3) for x in r['update_ms_per_step_runs']]}){fused}, device {r['update_profile']['device_ms_per_step']} "
            f"ms/step, idle share {r['update_profile'].get('device_idle_share')}, host reads an update "
            f"{r['update_host_reads']}; compute {r['compute_ms']:.3f} ms (again {r['compute_again_ms']:.3f}), host reads "
            f"{r['compute_profile']['host_reads']}, peak extra {r['compute_peak_extra_bytes']} bytes; "
            f"{r['kernel_launches']} bincount launches; CPU twin over {r['cpu_twin_steps']} updates, max |err| "
            f"{r['max_abs_err_vs_cpu']}  [{card}]")
    log(f"wrappers_imagenet tracker: {TRACKER_EPOCHS} epochs x {TRACKER_STEPS} updates at "
        f"{result['tracker_update_ms_per_step']:.3f} ms/step, best_metric {result['tracker_best_metric_ms']:.2f} ms, "
        f"best {result['tracker_best']}, max |err| {result['tracker_best_max_abs_err']}  [{card}]")
    log("wrappers_imagenet profiles: " + json.dumps({k: {"update": result[k]["update_profile"],
                                                          "compute": result[k]["compute_profile"]}
                                                      for k in WRAPPER_MEMBERS + ("multioutput_r2",)})
        + f"  [{card}]")
    return result


# ---- phase 16: image_restoration
def restoration_batches(seed: int = 50, shape=None) -> list:
    """A restoration model's outputs and their ground truth: smooth random textures with fine detail,
    in [0, 1], and a target that is a noisy copy (PSNR near 30 dB), so every MS-SSIM scale correlates."""
    steps, batch, channels, h, w = shape or IMAGE_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        coarse = torch.rand(batch, channels, h // 16, w // 16, generator=g, device=EVAL_DEVICE)
        base = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        detail = 0.08 * torch.randn(batch, channels, h, w, generator=g, device=EVAL_DEVICE)
        target = (base + detail).clamp(0, 1)
        preds = (target + 0.03 * torch.randn(batch, channels, h, w, generator=g, device=EVAL_DEVICE)).clamp(0, 1)
        out.append((preds, target))
    return out


def restoration_suite(mt, device):
    return mt.MetricCollection({
        "psnr": mt.PeakSignalNoiseRatio(data_range=1.0, device=device),
        "psnr_observed_range": mt.PeakSignalNoiseRatio(device=device),
        "ssim": mt.StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        "ms_ssim": mt.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        "uqi": mt.UniversalImageQualityIndex(device=device),
    })


def spectral_batches(seed: int = 51) -> list:
    """Pan-sharpened 4-band patches (blue, green, red, near infrared reflectances in (0.02, 0.6)) and
    their reference: the fusion's error is a smooth band bias and per-pixel noise."""
    steps, batch, bands, h, w = SPECTRAL_SHAPE
    g = torch.Generator(device=EVAL_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        coarse = torch.rand(batch, bands, h // 8, w // 8, generator=g, device=EVAL_DEVICE)
        target = 0.02 + 0.5 * torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        bias = 1.0 + 0.05 * torch.randn(batch, bands, 1, 1, generator=g, device=EVAL_DEVICE)
        preds = (target * bias + 0.01 * torch.randn(batch, bands, h, w, generator=g, device=EVAL_DEVICE)).clamp(0.01, 1)
        out.append((preds, target))
    return out


def spectral_suite(mt, device):
    return mt.MetricCollection({
        "ergas": mt.ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device=device),
        "sam": mt.SpectralAngleMapper(device=device),
        "d_lambda": mt.SpectralDistortionIndex(device=device),
    })


def image_path(mt, checks, histogram, card: str) -> dict:
    """Phase 16: PSNR (both ranges), SSIM, MS-SSIM and UQI over 200 image pairs of 3 x 512 x 512 in
    20 updates, one compute(); then ERGAS, SAM and D-lambda over 32 four-band 256 x 256 patches."""
    from metrics_tpu_torch.functional.image.helper import _depthwise_conv, _gaussian_kernel_2d

    batches = restoration_batches()
    steps, batch, channels, h, w = IMAGE_SHAPE
    n_images = steps * batch
    make = lambda: restoration_suite(mt, EVAL_DEVICE)  # noqa: E731
    runs, launches, suite = time_runs(make, update_batch, batches, checks, histogram)
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    assert ["ms_ssim", "ssim", "uqi"] in groups, f"image: groups {groups}"
    result = {"images": n_images, "shape": [channels, h, w], "steps": steps, "groups": groups, "card": card,
              "update_ms_per_step_runs": runs, "update_ms_per_step": median(runs), "kernel_launches": launches}
    result["update_profile"] = update_profile(make, update_batch, batches[:6], result["update_ms_per_step"])
    members = dict(suite.items(keep_base=True, copy_state=False))
    ssim = members["ssim"]
    result["buffered_bytes_on_card"] = sum(t.numel() * t.element_size() for t in ssim.preds + ssim.target)
    result["compute_peak_extra_bytes"] = {k: peak_extra_bytes(lambda m=m: compute_all({k: m})) for k, m in members.items()}
    values = timed_compute(members, result)
    result["member_compute_ms"] = {k: timed_ms(lambda m=m: compute_all({k: m})) for k, m in members.items()}

    # SSIM's depthwise convolution of the five stacked statistics, 11 x 11 taps, against its bound
    pad = 5
    stack = torch.empty(5 * n_images, channels, h + 2 * pad, w + 2 * pad, device=EVAL_DEVICE).uniform_()
    kernel = _gaussian_kernel_2d([11, 11], [1.5, 1.5], torch.float32, stack.device)
    out_numel = 5 * n_images * channels * h * w
    result["ssim_conv"] = op_profile(lambda: _depthwise_conv(stack, kernel), bytes_moved=4 * (stack.numel() + out_numel),
                                     ops=2 * 121 * out_numel)
    result["ssim_conv"]["shape"] = list(stack.shape)
    del stack
    # MS-SSIM: five scales of the same conv, the pools between them
    ms_ops = sum(2 * 121 * 5 * n_images * channels * (h >> s) * (w >> s) for s in range(5))
    ms_bytes = 2 * 4 * n_images * channels * h * w  # the function reads preds and target once; its result is a scalar
    ms = members["ms_ssim"]
    preds_all, target_all = ms._cat_states()
    result["ms_ssim_pyramid"] = op_profile(
        lambda: mt.functional.multiscale_structural_similarity_index_measure(preds_all, target_all, data_range=1.0),
        bytes_moved=ms_bytes, ops=ms_ops)
    del preds_all, target_all

    # the CPU twin: every image where that fits IMAGE_CPU_TWIN_S, else the first updates that fit, against
    # a card suite fed the same
    cpu = restoration_suite(mt, "cpu")
    cpu.update(*(t.cpu() for t in batches[0]))
    t0 = time.perf_counter()
    fresh_compute(cpu)
    once = time.perf_counter() - t0
    twin_steps = steps if once * steps <= IMAGE_CPU_TWIN_S else max(1, int(IMAGE_CPU_TWIN_S / once))
    for b in batches[1:twin_steps]:
        cpu.update(*(t.cpu() for t in b))
    twin = suite if twin_steps == steps else make()
    if twin_steps < steps:
        for b in batches[:twin_steps]:
            twin.update(*b)
    twin_members = dict(twin.items(keep_base=True, copy_state=False))
    for name, cpu_m in cpu.items(keep_base=True, copy_state=False):
        for state, want in cpu_m.metric_state.items():
            # the buffered rows bit for bit; PSNR's float32 sums of squared errors in another order
            assert_state_close(getattr(twin_members[name], state), want, f"image {name}.{state}",
                               rtol=0.0 if isinstance(want, list) else 1e-5)
    t0 = time.perf_counter()
    want = fresh_compute(cpu)
    result["cpu_compute_s"] = time.perf_counter() - t0
    got = values if twin_steps == steps else fresh_compute(twin)
    err = {k: assert_curve_close(got[k], w, f"image {k}", atol=IMAGE_ATOL, rtol=1e-5) for k, w in want.items()}
    for k, v in values.items():
        assert torch.isfinite(v).all() and v.shape == (), f"image {k}: {v}"
    result.update(values={k: float(v) for k, v in values.items()}, cpu_twin_images=twin_steps * batch,
                  cpu_compute_s_one_update=once, max_abs_err_vs_cpu=err)

    # ERGAS, SAM and D-lambda over the pan-sharpening patches, against the CPU on every patch
    sp_batches = spectral_batches()
    sp = spectral_suite(mt, EVAL_DEVICE)
    sp_cpu = spectral_suite(mt, "cpu")
    settle(sp)
    t0 = time.perf_counter()
    for b in sp_batches:
        sp.update(*b)
    settle(sp)
    result["spectral_update_ms_per_step"] = (time.perf_counter() - t0) / len(sp_batches) * 1e3
    sp_members = dict(sp.items(keep_base=True, copy_state=False))
    sp_result: dict = {}
    sp_values = timed_compute(sp_members, sp_result)
    for b in sp_batches:
        sp_cpu.update(*(t.cpu() for t in b))
    sp_want = fresh_compute(sp_cpu)
    sp_err = {k: assert_curve_close(sp_values[k], w, f"spectral {k}", atol=ERGAS_ATOL if k == "ergas" else IMAGE_ATOL,
                                    rtol=1e-5) for k, w in sp_want.items()}
    result["spectral"] = {"patches": SPECTRAL_SHAPE[0] * SPECTRAL_SHAPE[1], "shape": list(SPECTRAL_SHAPE[2:]),
                          "values": {k: float(v) for k, v in sp_values.items()}, "max_abs_err_vs_cpu": sp_err,
                          **sp_result}
    assert launches == 0, f"image: {launches} bincount launches"
    log(f"image_restoration {n_images} pairs of {channels}x{h}x{w} in {steps} updates: update "
        f"{result['update_ms_per_step']:.4f} ms/step (runs {runs}), compute {result['compute_ms']:.1f} ms (again "
        f"{result['compute_again_ms']:.1f}; members {result['member_compute_ms']}), peak extra "
        f"{result['compute_peak_extra_bytes']} bytes, {result['buffered_bytes_on_card']} bytes buffered; values "
        f"{result['values']}; CPU twin over {result['cpu_twin_images']} images (one update {once:.2f} s), max |err| {err}"
        f"  [{card}]")
    log(f"image_restoration SSIM conv {json.dumps(result['ssim_conv'])}; MS-SSIM {json.dumps(result['ms_ssim_pyramid'])}"
        f"; compute profile {json.dumps(result['compute_profile'])}  [{card}]")
    log(f"image_restoration spectral ({result['spectral']['patches']} patches of {SPECTRAL_SHAPE[2:]}): update "
        f"{result['spectral_update_ms_per_step']:.4f} ms/step, compute {sp_result['compute_ms']:.2f} ms (again "
        f"{sp_result['compute_again_ms']:.2f}); values {result['spectral']['values']}; max |err| {sp_err}  [{card}]")
    return result


def wrapper_image_paths(mt, checks, histogram, card: str) -> dict:
    """Phases 15 and 16."""
    out = {"wrappers_imagenet": wrappers_path(mt, checks, histogram, card),
           "image_restoration": image_path(mt, checks, histogram, card)}
    out["kernel_launches"] = out["wrappers_imagenet"]["kernel_launches"] + out["image_restoration"]["kernel_launches"]
    return out



# ------------------------------------------------------------------ phases 17 and 18
GEN_SHAPE = (50, 200, 3, 256, 256)  # updates of each half, images an update: 10,000 real and 10,000 generated (FID-10k)
KID_SUBSETS, KID_SUBSET_SIZE = 100, 1000  # KernelInceptionDistance's defaults
IS_SPLITS = 10
GEN_FEATURE_TWIN = 16  # images of the first update the CPU twin featurises (a stated cut: a CPU forward is slow)
GEN_DOWNSAMPLE_SHAPE = (16, 3, 512, 512)  # one extractor call of 512 x 512 images: the antialiased downsampling
KID_CPU_SUBSETS = 10  # the KID twin's subsets (a stated cut), against the card's KID recomputed at as many
LPIPS_SHAPES = {"alex": (20, 100, 3, 256, 256), "vgg": (2, 100, 3, 256, 256), "squeeze": (2, 100, 3, 256, 256)}
LPIPS_TWIN_PAIRS = 8  # pairs of each backbone's first batch the CPU twin scores (a stated cut)
FEATURE_RTOL = 1e-4  # card features within this share of their mean |value| of the CPU's: float32 convs in another order
GEN_RTOL = 1e-6  # FID and KID from the same features: float64 on both sides
IS_RTOL = 1e-5  # InceptionScore's mean from the same logits: float32 softmax sums in another order
IS_STD_ATOL = 1e-5  # its spread, absolute: a difference of ten float32 values near 1 (means over 1,000 rows), which
                    # cancels, so it is held to the values' own rounding, not to a share of itself
LPIPS_ATOL = 1e-5  # the JAX package's LPIPS parity (tests/models/test_lpips_parity.py)
FP64_OPS_PER_S = 67e12  # H100 SXM float64 on the tensor cores (NVIDIA's data sheet; not in the float32 table)
GEN_DEVICE = "cuda"  # where phases 17 and 18 run


def texture_images(g, n: int, h: int, w: int, blur: int, tint: float, device) -> torch.Tensor:
    """uint8 images (n, 3, h, w): smooth colour fields at scale ``h // blur`` with fine grain, as a
    generator's samples or a dataset's photographs look to a random network; ``tint`` shifts the colours."""
    coarse = torch.rand(n, 3, max(1, h // blur), max(1, w // blur), generator=g, device=device)
    base = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    grain = 0.06 * torch.randn(n, 3, h, w, generator=g, device=device)
    shift = torch.tensor([tint, 0.0, -tint], device=device).view(1, 3, 1, 1)
    return ((base + grain + shift).clamp(0, 1) * 255).round().to(torch.uint8)


def generative_batches(seed: int = 70, shape=None) -> tuple:
    """FID-10k of a 256 x 256 generator (FFHQ-256, LSUN): the real half and the generated half,
    uint8 on the card; the generated images are blurrier and tinted."""
    steps, batch, _, h, w = shape or GEN_SHAPE
    g = torch.Generator(device=GEN_DEVICE).manual_seed(seed)
    real = [texture_images(g, batch, h, w, 16, 0.0, GEN_DEVICE) for _ in range(steps)]
    fake = [texture_images(g, batch, h, w, 32, 0.04, GEN_DEVICE) for _ in range(steps)]
    return real, fake


def lpips_pairs(seed: int, shape) -> list:
    """(img1, img2) pairs in [-1, 1] on the card: a reconstruction and its reference."""
    steps, batch, _, h, w = shape
    g = torch.Generator(device=GEN_DEVICE).manual_seed(seed)
    out = []
    for _ in range(steps):
        ref = texture_images(g, batch, h, w, 16, 0.0, GEN_DEVICE).float() / 127.5 - 1
        out.append(((ref + 0.1 * torch.randn(ref.shape, generator=g, device=GEN_DEVICE)).clamp(-1, 1), ref))
    return out


def inception_ops_per_image(size: int = 299) -> int:
    """Operations of one InceptionV3 forward at ``size`` x ``size``: 2 per multiply-add of every
    convolution and of the classifier, from the output shapes of a forward on the meta device."""
    from metrics_tpu_torch.models import inception
    from metrics_tpu_torch.models.manifest import meta_module

    model = meta_module(inception.InceptionV3)
    total = [0]

    def hook(module, _inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            total[0] += 2 * out.numel() * module.weight[0].numel()
        elif isinstance(module, torch.nn.Linear):
            total[0] += 2 * module.weight.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.empty(1, 3, size, size, device="meta"))
    for h in handles:
        h.remove()
    return total[0]


def scaled_err(got, want) -> float:
    """max |got - want| over the mean |want| (both moved to the CPU)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    assert got.shape == want.shape, f"{tuple(got.shape)} against {tuple(want.shape)}"
    return float((got - want).abs().max() / (want.abs().mean() + 1e-30))


def cpu_copies(fn):
    """(``fn()``, how many ``Tensor.cpu()`` calls it made on device tensors): the copies to the host
    of code that copies only that way (mAP's ``compute()``), counted at the call, which a profiler
    session can lose."""
    real, count = torch.Tensor.cpu, [0]

    def counting(self, *args, **kwargs):
        count[0] += self.device.type != "cpu"
        return real(self, *args, **kwargs)

    torch.Tensor.cpu = counting
    try:
        out = fn()
    finally:
        torch.Tensor.cpu = real
    return out, count[0]


def update_reads(fn) -> dict:
    """The host reads and copies to the host of one call of ``fn`` (a second call in the warm-up cycle)."""
    prof = compute_profile(fn)
    reads = prof["host_reads"]  # ``item`` reads through ``_local_scalar_dense``: one read, two rows
    return {"host_reads": reads["aten::_local_scalar_dense"] + reads["aten::nonzero"], "by_op": reads,
            "device_to_host_copies": prof["device_to_host_copies"],
            "host_to_device_copies": prof["host_to_device_copies"], "memcpy_calls": prof["memcpy_calls"],
            "device_ms": prof["device_ms"]}


def generative_path(mt, checks, histogram, card: str) -> dict:
    """Phase 17: FID-10k (FID 2048, KID at its defaults, IS over the generated half) of a 256 x 256
    generator with the networks' seeded random weights, the LPIPS backbones, the extractor on 512 x 512
    images; every network held against its CPU twin (the same weights, moved to the CPU), FID, KID and
    IS against the CPU on the card's own features."""
    import copy

    from metrics_tpu_torch.models import inception

    steps, batch, channels, h, w = GEN_SHAPE
    real, fake = generative_batches()
    histogram.KERNEL_LAUNCHES = 0
    kw = dict(allow_random_weights=True, seed=0, device=GEN_DEVICE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fid = mt.FrechetInceptionDistance(feature=2048, **kw)
        kid = mt.KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, **kw)
        iscore = mt.InceptionScore(feature="logits_unbiased", splits=IS_SPLITS, **kw)
    members = {"fid": fid, "kid": kid, "is": iscore}
    result = {"images": {"real": steps * batch, "generated": steps * batch}, "shape": [channels, h, w],
              "update_images": batch, "card": card}
    # the first update of each builds its network (seeded, on the CPU, then moved): timed apart
    t0 = time.perf_counter()
    fid.update(real[0], real=True)
    kid.update(real[0], real=True)
    iscore.update(fake[0])
    torch.cuda.synchronize()
    result["first_updates_s"] = time.perf_counter() - t0
    plan = [("fid", fid, fake[0], (False,)), ("kid", kid, fake[0], (False,))]
    for i in range(1, steps):
        plan += [("fid", fid, real[i], (True,)), ("kid", kid, real[i], (True,)), ("fid", fid, fake[i], (False,)),
                 ("kid", kid, fake[i], (False,)), ("is", iscore, fake[i], ())]
    ms = {"fid": [], "kid": [], "is": []}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for name, metric, imgs, args in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(imgs, *args)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    result["update_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    result["update_ms"] = {k: median(v) for k, v in ms.items()}
    result["update_ms_runs"] = {k: [min(v), max(v), len(v)] for k, v in ms.items()}
    result["extractor_images_per_s"] = batch / (median(ms["is"]) / 1e3)
    assert len(fid.real_features) == len(fid.fake_features) == steps and len(iscore.features) == steps
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spare = mt.FrechetInceptionDistance(feature=2048, **kw)
        spare.update(real[0], real=True)
    result["update_reads"] = update_reads(lambda: spare.update(real[1], real=True))
    result["update_profile"] = profile_steps(lambda x: spare.update(x, real=True), [(r,) for r in real[:6]])
    if result["update_profile"]["device_ms_per_step"] is not None:
        result["update_profile"]["device_idle_share"] = 1 - result["update_profile"]["device_ms_per_step"] / \
            result["update_ms"]["fid"]
    del spare

    # every compute(): the first, again, its peak extra memory, its host reads and copies
    values = {}
    for name, metric in members.items():
        r: dict = {}
        values[name] = timed_compute({name: metric}, r)[name]
        r["peak_extra_bytes"] = peak_extra_bytes(lambda m=metric: compute_all({"m": m}))
        result[f"{name}_compute"] = r
    fid_v, (kid_mean, kid_std), (is_mean, is_std) = values["fid"], values["kid"], values["is"]
    for v in (fid_v, kid_mean, kid_std, is_mean, is_std):
        assert v.shape == () and v.dtype == torch.float32 and torch.isfinite(v) and v.device.type == torch.device(GEN_DEVICE).type, v
    assert float(fid_v) > 0 and float(is_mean) >= 1.0, (fid_v, is_mean)
    result["values"] = {"fid": float(fid_v), "kid_mean": float(kid_mean), "kid_std": float(kid_std),
                        "is_mean": float(is_mean), "is_std": float(is_std)}

    # the CPU twins: the same weights moved to the CPU; the first update's first images featurised there
    twin = copy.deepcopy(fid.inception).to("cpu")
    for key, value in twin.params.items():
        assert torch.equal(value, fid.inception.params[key].cpu()), f"twin weights differ: {key}"
    err = {}
    sample = real[0][:GEN_FEATURE_TWIN]
    err["2048"] = scaled_err(fid.real_features[0][:GEN_FEATURE_TWIN], twin(sample.cpu()))
    twin.feature = "logits_unbiased"
    err["logits_unbiased"] = scaled_err(iscore.features[0][:GEN_FEATURE_TWIN], twin(fake[0][:GEN_FEATURE_TWIN].cpu()))
    # one extractor call of 512 x 512 images: the antialiased downsampling on both sides
    big = texture_images(torch.Generator(device=GEN_DEVICE).manual_seed(71), *GEN_DOWNSAMPLE_SHAPE[:1],
                         *GEN_DOWNSAMPLE_SHAPE[2:], 16, 0.0, GEN_DEVICE)
    twin.feature = "2048"
    err["2048_from_512"] = scaled_err(fid.inception(big), twin(big.cpu()))
    for k, e in err.items():
        assert e < FEATURE_RTOL, f"generative: {k} features off the CPU twin by {e:.3g} of their scale"
    result["feature_err_vs_cpu"] = err

    # FID, KID (KID_CPU_SUBSETS subsets) and IS on the CPU from the card's own features
    ident = lambda x: x  # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu = {"fid": mt.FrechetInceptionDistance(feature=ident, device="cpu"),
               "kid": mt.KernelInceptionDistance(feature=ident, subsets=KID_CPU_SUBSETS,
                                                 subset_size=KID_SUBSET_SIZE, device="cpu"),
               "is": mt.InceptionScore(feature=ident, splits=IS_SPLITS, device="cpu")}
    for rows_r, rows_f in zip(fid.real_features, fid.fake_features):
        cpu["fid"].update(rows_r.cpu(), real=True)
        cpu["fid"].update(rows_f.cpu(), real=False)
    for rows_r, rows_f in zip(kid.real_features, kid.fake_features):
        cpu["kid"].update(rows_r.cpu(), real=True)
        cpu["kid"].update(rows_f.cpu(), real=False)
    for rows in iscore.features:
        cpu["is"].update(rows.cpu())
    t0 = time.perf_counter()
    want = {k: m.compute() for k, m in cpu.items()}
    result["cpu_compute_s"] = time.perf_counter() - t0
    kid.subsets = KID_CPU_SUBSETS
    kid._computed = None
    kid_cut = kid.compute()
    kid.subsets = KID_SUBSETS
    kid._computed = None
    rel = {"fid": abs(float(fid_v) - float(want["fid"])) / abs(float(want["fid"])),
           "kid_mean": abs(float(kid_cut[0]) - float(want["kid"][0])) / abs(float(want["kid"][0])),
           "kid_std": abs(float(kid_cut[1]) - float(want["kid"][1])) / abs(float(want["kid"][1])),
           "is_mean": abs(float(is_mean) - float(want["is"][0])) / abs(float(want["is"][0]))}
    for k, r in rel.items():
        assert r <= (IS_RTOL if k.startswith("is") else GEN_RTOL), f"generative: {k} off the CPU by {r:.3g} (relative)"
    is_std_err = abs(float(is_std) - float(want["is"][1]))
    assert is_std_err <= IS_STD_ATOL, f"generative: is_std off the CPU by {is_std_err:.3g}"
    result["rel_err_vs_cpu"] = rel
    result["is_std_abs_err_vs_cpu"] = is_std_err

    # the network and the f64 linear algebra beside their bounds
    ops = inception_ops_per_image()
    x = inception._resize_bilinear(real[0].float()) / 255.0 * 2.0 - 1.0
    fwd = op_profile(lambda: inception._apply(fid.inception.model, x), bytes_moved=x.numel() * 4, ops=ops * batch)
    fwd["images"] = batch
    result["inception_forward"] = fwd
    feats = torch.cat(fid.real_features).double()
    d = feats.shape[1]
    cov = torch.cov(feats.T)
    result["fid_eigh"] = op_profile(lambda: torch.linalg.eigh(cov), bytes_moved=8 * 2 * d * d,
                                    ops=9 * d**3, peak_ops_per_s=FP64_OPS_PER_S)
    f1 = feats[:KID_SUBSET_SIZE]
    result["kid_subset_mmd"] = op_profile(lambda: mt.image.generative.poly_mmd(f1, f1), bytes_moved=8 * 2 * f1.numel(),
                                          ops=3 * 2 * KID_SUBSET_SIZE**2 * d, peak_ops_per_s=FP64_OPS_PER_S)
    del feats, cov, f1, x

    # LPIPS: alex over 2,000 pairs, vgg and squeeze over 200, each against its CPU twin's first pairs
    result["lpips"] = {}
    for seed, (net_type, shape) in enumerate(LPIPS_SHAPES.items(), start=72):
        pairs = lpips_pairs(seed, shape)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            metric = mt.LearnedPerceptualImagePatchSimilarity(net_type=net_type, **kw)
        metric.update(*pairs[0])  # builds the network
        times = []
        for p in pairs[1:]:
            settle(metric)
            t0 = time.perf_counter()
            metric.update(*p)
            settle(metric)
            times.append((time.perf_counter() - t0) * 1e3)
        value = metric.compute()
        assert torch.isfinite(value) and float(value) > 0, f"lpips {net_type}: {value}"
        twin_net = copy.deepcopy(metric.net).to("cpu")
        a, b = (t[:LPIPS_TWIN_PAIRS] for t in pairs[0])
        got, want_l = metric.net(a, b).cpu(), twin_net(a.cpu(), b.cpu())
        torch.testing.assert_close(got, want_l, atol=LPIPS_ATOL, rtol=0, msg=lambda m: f"lpips {net_type}: {m}")
        reads = update_reads(lambda: metric.update(*pairs[1]))
        result["lpips"][net_type] = {
            "pairs": shape[0] * shape[1], "update_pairs": shape[1], "update_ms": median(times) if times else None,
            "pairs_per_s": shape[1] / (median(times) / 1e3) if times else None, "value": float(value),
            "max_abs_err_vs_cpu": float((got - want_l).abs().max()), "update_reads": reads}
    result["kernel_launches"] = histogram.KERNEL_LAUNCHES
    assert result["kernel_launches"] == 0, f"generative: {result['kernel_launches']} bincount launches"
    log(f"generative_ffhq256 {steps * batch} real + {steps * batch} generated of {channels}x{h}x{w} in updates of "
        f"{batch}: update ms {result['update_ms']}, extractor {result['extractor_images_per_s']:.1f} images/s, "
        f"update peak extra {result['update_peak_extra_bytes']} bytes, reads an update {result['update_reads']}; "
        f"compute ms fid {result['fid_compute']['compute_ms']:.1f} (again {result['fid_compute']['compute_again_ms']:.1f}),"
        f" kid {result['kid_compute']['compute_ms']:.1f} ({result['kid_compute']['compute_again_ms']:.1f}), is "
        f"{result['is_compute']['compute_ms']:.1f} ({result['is_compute']['compute_again_ms']:.1f}); values "
        f"{result['values']}; features vs CPU {err}; FID/KID/IS vs CPU {rel}, IS std {is_std_err:.3g}  [{card}]")
    log(f"generative_ffhq256 inception forward {json.dumps(fwd)}; fid eigh {json.dumps(result['fid_eigh'])}; kid "
        f"subset {json.dumps(result['kid_subset_mmd'])}; lpips {json.dumps(result['lpips'])}  [{card}]")
    return result


DETECTION_IMAGES = 5000  # COCO val2017
DETECTION_CLASSES = 80
DETECTION_GT_MEAN = 7.36  # ground-truth boxes an image: 36,781 / 5,000 in COCO val2017
DETECTION_AREA_MIX = (0.41, 0.34, 0.25)  # COCO's small / medium / large share of boxes
DETECTION_TOP_K = 100  # a detector's top-100 output an image
DETECTION_UPDATE = 8  # images an update
DETECTION_SIZE = (640, 480)  # width, height
SEGM_IMAGES, SEGM_MAX_INSTANCES = 100, 20


def coco_detections(n_images: int, seed: int = 80) -> list:
    """(preds, target) of each image, xywh float32, numpy from a seed: ground truth Poisson(7.36) an
    image, classes Zipf-like over 80, areas in COCO's small/medium/large mix; 100 detections an image,
    90% of the ground truth found (jittered by 10% of its size, 95% of the right class, scores
    in [0.3, 1)), the rest false positives (60% of an image's classes, scores in [0, 0.6))."""
    import numpy as np

    rng = np.random.RandomState(seed)
    width, height = DETECTION_SIZE
    class_p = 1.0 / np.arange(1, DETECTION_CLASSES + 1) ** 0.8
    class_p /= class_p.sum()

    def boxes(n):
        cat = rng.choice(3, size=n, p=DETECTION_AREA_MIX)
        lo = np.array([4.0**2, 32.0**2, 96.0**2])[cat]
        hi = np.array([32.0**2, 96.0**2, 400.0**2])[cat]
        area = np.exp(rng.uniform(np.log(lo), np.log(hi)))
        aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
        w = np.minimum(np.sqrt(area * aspect), width - 1)
        h = np.minimum(np.sqrt(area / aspect), height - 1)
        return np.stack([rng.uniform(0, width - w), rng.uniform(0, height - h), w, h], 1).astype(np.float32)

    out = []
    for _ in range(n_images):
        n_gt = rng.poisson(DETECTION_GT_MEAN)
        gt, gl = boxes(n_gt), rng.choice(DETECTION_CLASSES, n_gt, p=class_p)
        found = rng.rand(n_gt) < 0.9
        tp = gt[found] + rng.randn(found.sum(), 4).astype(np.float32) * 0.1 * np.repeat(gt[found][:, 2:], 2, 1)
        tp[:, 2:] = np.maximum(tp[:, 2:], 1.0)
        tl = np.where(rng.rand(found.sum()) < 0.95, gl[found], rng.choice(DETECTION_CLASSES, found.sum(), p=class_p))
        n_fp = max(DETECTION_TOP_K - len(tp), 0)
        own = (rng.rand(n_fp) < 0.6) & (n_gt > 0)
        fl = np.where(own, rng.choice(gl, n_fp) if n_gt else 0, rng.choice(DETECTION_CLASSES, n_fp, p=class_p))
        scores = np.concatenate([rng.uniform(0.3, 1.0, len(tp)), rng.uniform(0.0, 0.6, n_fp)]).astype(np.float32)
        preds = dict(boxes=np.concatenate([tp, boxes(n_fp)])[:DETECTION_TOP_K], scores=scores[:DETECTION_TOP_K],
                     labels=np.concatenate([tl, fl])[:DETECTION_TOP_K].astype(np.int64))
        out.append((preds, dict(boxes=gt, labels=gl.astype(np.int64))))
    return out


def ellipse_masks(boxes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(n, height, width) boolean ellipses inscribed in xywh ``boxes``, drawn on their device."""
    ys = torch.arange(height, device=boxes.device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(width, device=boxes.device, dtype=torch.float32)[None, None, :]
    x, y, w, h = (boxes[:, i, None, None] for i in range(4))
    return ((xs - x - w / 2) / (w / 2)) ** 2 + ((ys - y - h / 2) / (h / 2)) ** 2 <= 1


def coco_masks(seed: int = 81) -> list:
    """Instance masks of 480 x 640 images on the card: 1 to 20 ground-truth ellipses an image over 1 to
    3 of its classes, the detections shifted copies of them (85% found) plus 5 false positives."""
    g = torch.Generator(device=GEN_DEVICE).manual_seed(seed)
    width, height = DETECTION_SIZE
    out = []

    def rand(*shape):
        return torch.rand(shape, generator=g, device=GEN_DEVICE)

    for _ in range(SEGM_IMAGES):
        n = int(torch.randint(1, SEGM_MAX_INSTANCES + 1, (1,), generator=g, device=GEN_DEVICE))
        classes = torch.randint(0, DETECTION_CLASSES, (3,), generator=g, device=GEN_DEVICE)
        gl = classes[torch.randint(0, int(torch.randint(1, 4, (1,), generator=g, device=GEN_DEVICE)), (n,),
                                   generator=g, device=GEN_DEVICE)]
        wh = 16 + rand(n, 2) * torch.tensor([200.0, 150.0], device=GEN_DEVICE)
        xy = rand(n, 2) * (torch.tensor([width, height], device=GEN_DEVICE) - wh)
        gt = torch.cat([xy, wh], 1)
        found = rand(n) < 0.85
        det = gt[found] + torch.cat([rand(int(found.sum()), 2) * 12 - 6, torch.zeros(int(found.sum()), 2,
                                                                                      device=GEN_DEVICE)], 1)
        fp_wh = 16 + rand(5, 2) * 150
        det = torch.cat([det, torch.cat([rand(5, 2) * (torch.tensor([width, height], device=GEN_DEVICE) - fp_wh),
                                         fp_wh], 1)])
        dl = torch.cat([gl[found], classes[torch.randint(0, 3, (5,), generator=g, device=GEN_DEVICE)]])
        out.append((dict(masks=ellipse_masks(det, width, height), scores=rand(len(dl)), labels=dl),
                    dict(masks=ellipse_masks(gt, width, height), labels=gl)))
    return out


def map_values_equal(got: dict, want: dict, label: str) -> float:
    """Every mAP/mAR value of the card equal to the CPU's within MAP_ATOL; the largest |difference|."""
    assert sorted(got) == sorted(want), f"{label}: keys {sorted(got)}"
    err = 0.0
    for key, value in want.items():
        g = got[key].cpu()
        assert g.dtype == value.dtype == torch.float32 and g.shape == value.shape, f"{label}: {key}"
        err = max(err, float((g - value).abs().max()))
    assert err <= MAP_ATOL, f"{label}: off the CPU by {err}"
    return err


MAP_ATOL = 1e-6  # mAP/mAR card against CPU: the same host numpy on the same IoUs; bit for bit expected


def detection_path(mt, checks, histogram, card: str) -> dict:
    """Phase 18: COCO val2017 bbox evaluation of a detector's top-100 output (5,000 images, 80 classes),
    then ``iou_type="segm"`` over 100 images of 480 x 640 instance masks; each against the port on the CPU."""
    data = coco_detections(DETECTION_IMAGES)
    on = lambda ds, dev: [{k: torch.as_tensor(v).to(dev) for k, v in d.items()} for d in ds]  # noqa: E731
    batches = []
    for i in range(0, DETECTION_IMAGES, DETECTION_UPDATE):
        chunk = data[i : i + DETECTION_UPDATE]
        batches.append((on([p for p, _ in chunk], GEN_DEVICE), on([t for _, t in chunk], GEN_DEVICE)))
    torch.cuda.synchronize()
    histogram.KERNEL_LAUNCHES = 0
    card_map = mt.MeanAveragePrecision(box_format="xywh", class_metrics=True, device=GEN_DEVICE)
    t0 = time.perf_counter()
    for preds, target in batches:
        card_map.update(preds, target)
    torch.cuda.synchronize()
    result = {"images": DETECTION_IMAGES, "classes": DETECTION_CLASSES, "updates": len(batches),
              "gt_boxes": sum(len(t["labels"]) for _, t in data), "detections": sum(len(p["labels"]) for p, _ in data),
              "update_ms": (time.perf_counter() - t0) / len(batches) * 1e3, "card": card}
    spare = mt.MeanAveragePrecision(box_format="xywh", device=GEN_DEVICE)
    result["update_reads"] = update_reads(lambda: spare.update(*batches[0]))
    first: dict = {}

    def first_compute():  # the one bbox compute() of the card, timed under the profiler (a slow call runs once)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first["values"], first["copies"] = cpu_copies(card_map.compute)
        torch.cuda.synchronize()
        first["s"] = time.perf_counter() - t0

    prof = compute_profile(first_compute, warmup_fn=torch.cuda.synchronize)
    got = first["values"]
    result["compute_s"] = first["s"]
    result["iou_cells"] = dict(card_map.iou_cells)
    result["compute_reads"] = {"host_reads": prof["host_reads"], "device_to_host_copies": prof["device_to_host_copies"],
                               "cpu_calls_on_device_tensors": first["copies"], "device_ms": prof["device_ms"],
                               "device_idle_share": 1 - (prof["device_ms"] or 0) / 1e3 / first["s"]}
    result["values"] = {k: float(v) for k, v in got.items() if v.numel() == 1}
    assert 0 < result["values"]["map"] < 1 and got["map_per_class"].shape == (DETECTION_CLASSES,), result["values"]
    cpu_map = mt.MeanAveragePrecision(box_format="xywh", class_metrics=True, device="cpu")
    for i in range(0, DETECTION_IMAGES, DETECTION_UPDATE):
        chunk = data[i : i + DETECTION_UPDATE]
        cpu_map.update(on([p for p, _ in chunk], "cpu"), on([t for _, t in chunk], "cpu"))
    t0 = time.perf_counter()
    want = cpu_map.compute()
    result["cpu_compute_s"] = time.perf_counter() - t0
    result["max_abs_err_vs_cpu"] = map_values_equal(got, want, "detection bbox")
    assert cpu_map.iou_cells == result["iou_cells"], (cpu_map.iou_cells, result["iou_cells"])
    del batches, card_map, cpu_map, spare

    # instance masks
    masks = coco_masks()
    seg = mt.MeanAveragePrecision(iou_type="segm", device=GEN_DEVICE)
    t0 = time.perf_counter()
    for i in range(0, SEGM_IMAGES, DETECTION_UPDATE):
        chunk = masks[i : i + DETECTION_UPDATE]
        seg.update([p for p, _ in chunk], [t for _, t in chunk])
    torch.cuda.synchronize()
    seg_result = {"images": SEGM_IMAGES, "shape": list(DETECTION_SIZE[::-1]),
                  "gt_instances": sum(len(t["labels"]) for _, t in masks),
                  "update_ms": (time.perf_counter() - t0) / -(-SEGM_IMAGES // DETECTION_UPDATE) * 1e3}
    t0 = time.perf_counter()
    seg_got, seg_copies = cpu_copies(seg.compute)
    torch.cuda.synchronize()
    seg_result["compute_s"] = time.perf_counter() - t0
    seg_result["cpu_calls_on_device_tensors"] = seg_copies
    seg_result["iou_cells"] = dict(seg.iou_cells)
    assert seg.iou_cells["device"] > 0, seg.iou_cells
    seg._computed = None
    prof = compute_profile(lambda: seg.compute(), warmup_fn=torch.cuda.synchronize)
    seg_result["compute_reads"] = {"host_reads": prof["host_reads"], "device_to_host_copies": prof["device_to_host_copies"],
                                   "device_ms": prof["device_ms"]}
    seg_result["peak_extra_bytes"] = peak_extra_bytes(lambda: (setattr(seg, "_computed", None), seg.compute()))
    seg_cpu = mt.MeanAveragePrecision(iou_type="segm", device="cpu")
    for i in range(0, SEGM_IMAGES, DETECTION_UPDATE):
        chunk = masks[i : i + DETECTION_UPDATE]
        seg_cpu.update(on([p for p, _ in chunk], "cpu"), on([t for _, t in chunk], "cpu"))
    t0 = time.perf_counter()
    seg_want = seg_cpu.compute()
    seg_result["cpu_compute_s"] = time.perf_counter() - t0
    seg_result["max_abs_err_vs_cpu"] = map_values_equal(seg_got, seg_want, "detection segm")
    seg_result["values"] = {k: float(v) for k, v in seg_got.items() if v.numel() == 1}
    result["segm"] = seg_result
    result["kernel_launches"] = histogram.KERNEL_LAUNCHES
    assert result["kernel_launches"] == 0, f"detection: {result['kernel_launches']} bincount launches"
    log(f"detection_coco {DETECTION_IMAGES} images, {result['gt_boxes']} ground-truth boxes, {result['detections']} "
        f"detections in {len(data) // DETECTION_UPDATE} updates: update {result['update_ms']:.4f} ms, compute "
        f"{result['compute_s']:.3f} s (CPU twin {result['cpu_compute_s']:.3f} s), IoU cells {result['iou_cells']}, "
        f"reads an update {result['update_reads']}, compute reads {result['compute_reads']}; values "
        f"{result['values']}; max |err| vs CPU {result['max_abs_err_vs_cpu']}  [{card}]")
    log(f"detection_coco segm {json.dumps(seg_result)}  [{card}]")
    return result


def generative_detection_paths(mt, checks, histogram, card: str) -> dict:
    """Phases 17 and 18, each timed."""
    out = {}
    for label, fn in (("generative_ffhq256", generative_path), ("detection_coco", detection_path)):
        t0 = time.perf_counter()
        out[label] = fn(mt, checks, histogram, card)
        out[label]["phase_s"] = time.perf_counter() - t0
    out["kernel_launches"] = sum(out[k]["kernel_launches"] for k in ("generative_ffhq256", "detection_coco"))
    return out


# ------------------------------------------------------------------ phases 19 and 20
TEXT_DEVICE = "cuda"  # where phases 19 and 20 run
ASR_SHAPE = (2620, 20, 10_000, 32)  # utterances, mean words, vocabulary, utterances an update: LibriSpeech test-clean
MT_SHAPE = (3003, 27, 10_000, 64)  # sentences, mean words, vocabulary, sentences an update: WMT14 newstest2014 en-de
SUMM_SHAPE = (11_490, 56, 64)  # pairs, words a summary (3 to 4 sentences), pairs an update: CNN/DailyMail test
SUMM_CUT_PAIRS = 2000  # pairs the summarisation family keeps when all of them would take more than SUMM_FULL_S
SUMM_FULL_S = 60.0
QA_SHAPE = (10_570, 256)  # questions (1 to 3 answers each), questions an update: SQuAD v1.1 dev
LM_SHAPE = (16, 8, 1024, 50_257)  # updates, sequences an update, tokens, vocabulary: GPT-2 small's evaluation
LM_IGNORED = 0.05  # share of positions with the target -100 (ignore_index)
LM_CPU_UPDATES = 2  # float32 updates the CPU twin takes (a stated cut), beside the bfloat16 one
BERT_SHAPE = (1024, 64, 64)  # embedding width (roberta-large's), tokens at most, pairs a block (batch_size)
INFOLM_SHAPE = (256, 32, 30_522, 768, 64)  # pairs, max_length, vocabulary and width (bert-base's), batch_size
INFOLM_CPU_PAIRS = 8  # pairs the CPU twin scores, against the card on the same pairs (a stated cut: a CPU forward)
TEXT_HOST_RTOL = 1e-6  # host-computed scores, rounded to float32 on each side; reductions of float32 on the device
TEXT_DEVICE_RTOL = 1e-5  # Perplexity, BERTScore, InfoLM: float32 sums over the vocabulary or the width
PIT_SHAPE = (3000, 2, 32_000, 50)  # mixtures, speakers, samples (4 s at 8 kHz), mixtures an update: WSJ0-2mix test
PIT3_SHAPE = (500, 3, 32_000, 50)  # WSJ0-3mix shape
SDR_SHAPE = (500, 32_000, 50, 512)  # clips, samples, clips an update, filter_length
SDR_F64_CLIPS = 50
STOI_SHAPE = (100, 48_000, 16_000, 20)  # clips, samples (3 s at 16 kHz), rate, clips an update
ESTOI_CLIPS = 20
SNR_ATOL_DB = 1e-4  # SNR, SI-SNR, SI-SDR: float32 sums over 32,000 samples in another order
SDR_F32_ATOL_DB = 5e-3  # the float32 solve of a 512 x 512 Toeplitz system: cuSOLVER and LAPACK round differently
SDR_CG_ATOL_DB = 1e-3  # ten conjugate-gradient steps: cuFFT and the CPU's FFT round differently
SDR_F64_ATOL_DB = 1e-9
STOI_ATOL = 1e-6  # the same float64 numpy on both sides; the float32 sums of the clips' scores


def word_vocab(rng, size: int) -> list:
    """``size`` distinct lowercase words of 2 to 9 letters."""
    out, seen = [], set()
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(out) < size:
        w = "".join(rng.choice(letters, rng.randint(2, 10)))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def zipf_words(rng, vocab: list, n: int, probs) -> list:
    return [vocab[i] for i in rng.choice(len(vocab), n, p=probs)]


def zipf_probs(size: int):
    p = 1.0 / np.arange(1, size + 1) ** 1.1
    return p / p.sum()


def edit_words(rng, words: list, vocab: list, rate: float) -> list:
    """About ``rate`` of the words deleted, substituted or followed by an inserted word, a third each."""
    out = []
    for w in words:
        r = rng.rand()
        if r < rate / 3:
            continue
        out.append(vocab[rng.randint(len(vocab))] if r < 2 * rate / 3 else w)
        if 2 * rate / 3 <= r < rate:
            out.append(vocab[rng.randint(len(vocab))])
    return out


def asr_corpus(seed: int = 90) -> tuple:
    """LibriSpeech test-clean shape: 2,620 lowercase utterances of about 20 words from a 10,000-word
    Zipf vocabulary, hypotheses with about 10% substitutions, insertions and deletions."""
    n, mean_words, vocab_size, _ = ASR_SHAPE
    rng = np.random.RandomState(seed)
    vocab, probs = word_vocab(rng, vocab_size), zipf_probs(vocab_size)
    refs, hyps = [], []
    for length in np.clip(rng.poisson(mean_words, n), 2, None):
        words = zipf_words(rng, vocab, int(length), probs)
        refs.append(" ".join(words))
        hyps.append(" ".join(edit_words(rng, words, vocab, 0.10)))
    return hyps, refs


def mt_sentence(rng, vocab, probs, length: int) -> list:
    words = zipf_words(rng, vocab, length, probs)
    words[0] = words[0].capitalize()
    for i in range(1, length - 1):
        r = rng.rand()
        if r < 0.06:
            words[i] += ","
        elif r < 0.09:
            words[i] = str(rng.randint(1, 3000))
        elif r < 0.12:
            words[i] = words[i].capitalize()
    words[-1] += "."
    return words


def mt_corpus(seed: int = 91, n: int = 0) -> tuple:
    """WMT14 newstest2014 en-de shape: 3,003 sentences of about 27 words (capitals, numbers, commas,
    a full stop), one reference each; hypotheses about 10% edited, one in five with a block of 2 to 4
    words moved (TER's shifts)."""
    n = n or MT_SHAPE[0]
    _, mean_words, vocab_size, _ = MT_SHAPE
    rng = np.random.RandomState(seed)
    vocab, probs = word_vocab(rng, vocab_size), zipf_probs(vocab_size)
    refs, hyps = [], []
    for length in np.clip(rng.poisson(mean_words, n), 4, None):
        words = mt_sentence(rng, vocab, probs, int(length))
        refs.append(" ".join(words))
        hyp = edit_words(rng, words, vocab, 0.10)
        if rng.rand() < 0.2 and len(hyp) > 8:
            start, size = rng.randint(0, len(hyp) - 4), rng.randint(2, 5)
            block, rest = hyp[start : start + size], hyp[:start] + hyp[start + size :]
            at = rng.randint(0, len(rest) + 1)
            hyp = rest[:at] + block + rest[at:]
        hyps.append(" ".join(hyp))
    return hyps, refs


def summ_corpus(seed: int = 92, n: int = 0) -> tuple:
    """CNN/DailyMail test shape: 11,490 pairs of 3 to 4 sentences (split by "\\n") of about 56 words in
    all; the system summary shares about 60% of the reference's sentences' words."""
    n = n or SUMM_SHAPE[0]
    rng = np.random.RandomState(seed)
    vocab, probs = word_vocab(rng, 10_000), zipf_probs(10_000)
    preds, refs = [], []
    for _ in range(n):
        k = rng.randint(3, 5)
        ref_sents = [mt_sentence(rng, vocab, probs, max(4, int(rng.poisson(SUMM_SHAPE[1] / k)))) for _ in range(k)]
        pred_sents = [edit_words(rng, s, vocab, 0.4) for s in ref_sents if rng.rand() < 0.85] or [ref_sents[0]]
        refs.append("\n".join(" ".join(s) for s in ref_sents))
        preds.append("\n".join(" ".join(s) for s in pred_sents))
    return preds, refs


def squad_corpus(seed: int = 93) -> tuple:
    """SQuAD v1.1 dev shape: 10,570 questions with 1 to 3 gold answers of 1 to 4 words; a prediction is a
    gold answer (half of them with an article or a full stop added), a part of one, or other words."""
    n, _ = QA_SHAPE
    rng = np.random.RandomState(seed)
    vocab, probs = word_vocab(rng, 10_000), zipf_probs(10_000)
    preds, target = [], []
    for i in range(n):
        answers = [" ".join(zipf_words(rng, vocab, rng.randint(1, 5), probs)) for _ in range(rng.randint(1, 4))]
        r = rng.rand()
        if r < 0.55:
            pred = answers[rng.randint(len(answers))]
            pred = ("the " + pred) if rng.rand() < 0.3 else (pred + "." if rng.rand() < 0.3 else pred)
        elif r < 0.8:
            words = answers[0].split()
            pred = " ".join(words[: max(1, len(words) - 1)] + zipf_words(rng, vocab, 1, probs))
        else:
            pred = " ".join(zipf_words(rng, vocab, rng.randint(1, 5), probs))
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{i}"})
    return preds, target


def chunks(seq, size: int) -> list:
    return [seq[i : i + size] for i in range(0, len(seq), size)]


def states_equal(card: dict, cpu: dict, label: str) -> None:
    """Every state of every member on the card bit for bit the CPU twin's (lists concatenated)."""
    for name, cpu_m in cpu.items():
        for state, want in cpu_m.metric_state.items():
            got = getattr(card[name], state)
            got = torch.cat(got) if isinstance(got, list) else got
            want = torch.cat(want) if isinstance(want, list) else want
            assert got.device.type == torch.device(TEXT_DEVICE).type, f"{label}: {name}.{state} on {got.device}"
            assert got.dtype == want.dtype and torch.equal(got.cpu(), want), f"{label}: {name}.{state} differs"


def run_text_family(label: str, make, update_args, batches, card: str, rtol: float = TEXT_HOST_RTOL) -> dict:
    """One text family: the members made by ``make(device)`` fed every batch on the card (each update
    timed, ending in a synchronise), one update's host reads and copies (on a spare set), every
    ``compute()`` timed first and again with its reads and copies, then the CPU twin fed the same
    batches: every state bit for bit, every value within ``rtol``."""
    from metrics_tpu_torch.ops import text_native

    members = make(TEXT_DEVICE)
    dp0, calls0 = text_native.DP_CALLS, text_native.LIBRARY_CALLS
    ms = {name: [] for name in members}
    t_family = time.perf_counter()
    for batch in batches:
        for name, m in members.items():
            settle(m)
            t0 = time.perf_counter()
            m.update(*update_args(name, batch))
            settle(m)
            ms[name].append((time.perf_counter() - t0) * 1e3)
    result = {"updates": len(batches), "card": card,
              "update_ms": {k: median(v) for k, v in ms.items()},
              "update_ms_total": {k: sum(v) for k, v in ms.items()},
              "dp_calls": text_native.DP_CALLS - dp0, "library_calls": text_native.LIBRARY_CALLS - calls0}
    spare = make(TEXT_DEVICE)
    result["update_reads"] = {name: update_reads(lambda m=m, name=name: m.update(*update_args(name, batches[0])))
                              for name, m in spare.items()}
    del spare
    values, computes = {}, {}
    for name, m in members.items():
        r: dict = {}
        values[name] = timed_compute({name: m}, r)[name]
        computes[name] = {"compute_ms": r["compute_ms"], "compute_again_ms": r["compute_again_ms"],
                          "host_reads": r["compute_profile"]["host_reads"],
                          "device_to_host_copies": r["compute_profile"]["device_to_host_copies"],
                          "host_to_device_copies": r["compute_profile"]["host_to_device_copies"],
                          "memcpy_calls": r["compute_profile"]["memcpy_calls"],
                          "device_ms": r["compute_profile"]["device_ms"]}
    result["compute"] = computes
    result["card_s"] = time.perf_counter() - t_family
    t0 = time.perf_counter()
    twin = make("cpu")
    for batch in batches:
        for name, m in twin.items():
            m.update(*update_args(name, batch))
            settle(m)  # observed where the card's member was (SQuAD folds its host sums at each observation)
    want = {name: m.compute() for name, m in twin.items()}
    result["cpu_twin_s"] = time.perf_counter() - t0
    states_equal(members, twin, label)
    result["max_abs_err_vs_cpu"] = assert_values_close(values, want, label, atol=0.0, rtol=rtol)
    result["values"] = {k: (float(v) if isinstance(v, torch.Tensor) and v.numel() == 1 else
                            {kk: float(vv) for kk, vv in v.items()} if isinstance(v, dict) else str(type(v)))
                        for k, v in values.items()}
    log(f"text_eval {label}: {json.dumps(result)}  [{card}]")
    return result


def text_asr(mt, card: str) -> dict:
    hyps, refs = asr_corpus()
    size = ASR_SHAPE[3]
    batches = list(zip(chunks(hyps, size), chunks(refs, size)))

    def make(device):
        return {n: getattr(mt, n)(device=device) for n in
                ("WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved")}

    out = run_text_family("asr_librispeech", make, lambda name, b: b, batches, card)
    out["utterances"], out["words"] = len(refs), sum(len(r.split()) for r in refs)
    return out


def text_mt(mt, card: str, hyps, refs) -> dict:
    size = MT_SHAPE[3]
    batches = list(zip(chunks(hyps, size), chunks([[r] for r in refs], size)))

    def make(device):
        return {"bleu": mt.BLEUScore(device=device), "sacrebleu_13a": mt.SacreBLEUScore(tokenize="13a", device=device),
                "chrf++": mt.CHRFScore(n_word_order=2, device=device), "ter": mt.TranslationEditRate(device=device),
                "eed": mt.ExtendedEditDistance(device=device)}

    out = run_text_family("mt_wmt14", make, lambda name, b: b, batches, card)
    out["sentences"] = len(refs)
    return out


def text_summ(mt, card: str) -> dict:
    """ROUGE-1/2/L/Lsum over the CNN/DM pairs; all 11,490 if a timed first 500 say that takes at most
    SUMM_FULL_S on the card and its twin together, else SUMM_CUT_PAIRS (a stated cut)."""
    preds, refs = summ_corpus()
    size = SUMM_SHAPE[2]
    probe = mt.ROUGEScore(device="cpu")
    t0 = time.perf_counter()
    probe.update(preds[:500], refs[:500])
    per_pair_s = (time.perf_counter() - t0) / 500
    n = len(preds) if 2 * per_pair_s * len(preds) <= SUMM_FULL_S else SUMM_CUT_PAIRS
    batches = list(zip(chunks(preds[:n], size), chunks(refs[:n], size)))
    out = run_text_family("summ_cnndm", lambda device: {"rouge": mt.ROUGEScore(device=device)},
                          lambda name, b: b, batches, card)
    out.update(pairs=n, pairs_in_dataset=len(preds), host_s_per_pair=per_pair_s)
    return out


def text_squad(mt, card: str) -> dict:
    preds, target = squad_corpus()
    size = QA_SHAPE[1]
    batches = list(zip(chunks(preds, size), chunks(target, size)))
    out = run_text_family("qa_squad", lambda device: {"squad": mt.SQuAD(device=device)},
                          lambda name, b: b, batches, card)
    out["questions"] = len(preds)
    return out


def lm_batch(g, shape, device):
    """(logits, target) of one update: float32 logits from a seeded generator on the card, targets drawn
    from the softmax-sharpened logits' top ids half of the time, ``LM_IGNORED`` of them -100."""
    batch, seq, vocab = shape
    logits = torch.randn(batch, seq, vocab, generator=g, device=device) * 2.0
    target = torch.randint(0, vocab, (batch, seq), generator=g, device=device)
    top = logits.argmax(-1)
    target = torch.where(torch.rand(batch, seq, generator=g, device=device) < 0.5, top, target)
    target = torch.where(torch.rand(batch, seq, generator=g, device=device) < LM_IGNORED, -100, target)
    return logits, target


def text_lm(mt, card: str) -> dict:
    """Perplexity at GPT-2 small's evaluation shape, 16 updates of 8 x 1024 x 50,257 float32 logits, then
    one bfloat16 batch; the update beside its bytes bound and one ``F.cross_entropy``; the CPU twin on
    ``LM_CPU_UPDATES`` updates and the bfloat16 one, against a card metric fed the same."""
    from metrics_tpu_torch.functional.text.perplexity import _perplexity_update

    steps, batch, seq, vocab = LM_SHAPE
    g = torch.Generator(device=TEXT_DEVICE).manual_seed(94)
    metric = mt.Perplexity(ignore_index=-100, device=TEXT_DEVICE)
    ms, kept = [], []
    for i in range(steps):
        logits, target = lm_batch(g, (batch, seq, vocab), TEXT_DEVICE)
        if i < LM_CPU_UPDATES:
            kept.append((logits.cpu(), target.cpu()))
        settle(metric)
        t0 = time.perf_counter()
        metric.update(logits, target)
        settle(metric)
        ms.append((time.perf_counter() - t0) * 1e3)
    logits, target = lm_batch(g, (batch, seq, vocab), TEXT_DEVICE)
    half = logits.to(torch.bfloat16)
    settle(metric)
    t0 = time.perf_counter()
    metric.update(half, target)
    settle(metric)
    bf16_ms = (time.perf_counter() - t0) * 1e3
    value = metric.compute()
    assert torch.isfinite(value) and float(value) > 1.0, value
    result = {"updates": steps, "logits_shape": [batch, seq, vocab], "card": card, "update_ms": median(ms),
              "update_ms_runs": [min(ms), max(ms)], "bf16_update_ms": bf16_ms, "value": float(value),
              "tokens_counted": float(metric.count)}
    # the update beside its bound: the logits read once (the float32 copy of a float32 input is the input)
    nbytes = logits.numel() * 4 + target.numel() * 8
    result["update_device"] = op_profile(lambda: _perplexity_update(logits, target, -100), bytes_moved=nbytes,
                                         ops=logits.numel() * 4)
    flat_logits, flat_target = logits.view(-1, vocab), target.view(-1)
    result["cross_entropy_device"] = op_profile(
        lambda: torch.nn.functional.cross_entropy(flat_logits, flat_target, reduction="sum", ignore_index=-100),
        bytes_moved=nbytes, ops=logits.numel() * 4)
    result["update_peak_extra_bytes"] = peak_extra_bytes(lambda: _perplexity_update(logits, target, -100))
    result["update_reads"] = update_reads(lambda: metric.update(logits, target))
    r: dict = {}
    timed_compute({"ppl": metric}, r)
    result["compute"] = {k: r[k] for k in ("compute_ms", "compute_again_ms")}
    # the CPU twin: the kept float32 updates and the bfloat16 one, against a card metric fed the same
    card_twin = mt.Perplexity(ignore_index=-100, device=TEXT_DEVICE)
    cpu_twin = mt.Perplexity(ignore_index=-100, device="cpu")
    t0 = time.perf_counter()
    for x, t in kept + [(half.cpu(), target.cpu())]:
        card_twin.update(x.to(TEXT_DEVICE), t.to(TEXT_DEVICE))
        cpu_twin.update(x, t)
    want = cpu_twin.compute()
    result["cpu_twin_s"] = time.perf_counter() - t0
    got = card_twin.compute()
    assert torch.equal(card_twin.count.cpu(), cpu_twin.count), "perplexity: the counted tokens differ"
    result["max_abs_err_vs_cpu"] = assert_values_close(
        {"ppl": got, "nll": card_twin.total_log_probs}, {"ppl": want, "nll": cpu_twin.total_log_probs},
        "perplexity", atol=0.0, rtol=TEXT_DEVICE_RTOL)
    del logits, half, flat_logits, kept
    log(f"text_eval lm_gpt2: {json.dumps(result)}  [{card}]")
    return result


class WordTable:
    """BERTScore's forward for the card phase: a seeded embedding table of roberta-large's width looked
    up by word (no transformer), with a [CLS]-like first and a [SEP]-like last position, at most
    ``BERT_SHAPE[1]`` tokens; the ids are made on the host and copied once a call."""

    def __init__(self, vocab: list, width: int, device):
        g = torch.Generator(device="cpu").manual_seed(95)
        self.ids = {w: i + 3 for i, w in enumerate(vocab)}
        self.table = (torch.randn(len(vocab) + 3, width, generator=g) / width**0.5).to(device)

    def __call__(self, sentences):
        max_tokens = BERT_SHAPE[1]
        ids = np.zeros((len(sentences), max_tokens), np.int64)
        mask = np.zeros((len(sentences), max_tokens), np.float32)
        for i, s in enumerate(sentences):
            row = [1] + [self.ids.get(w.lower().strip(",."), 0) for w in s.split()][: max_tokens - 2] + [2]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1.0
        both = torch.from_numpy(np.concatenate([ids, mask.astype(np.int64)], axis=1)).to(self.table.device)
        return self.table[both[:, :max_tokens]], both[:, max_tokens:].to(torch.float32)

    def to(self, device):
        twin = WordTable.__new__(WordTable)
        twin.ids, twin.table = self.ids, self.table.to(device)
        return twin


def text_bert(mt, card: str, hyps, refs, vocab) -> dict:
    from metrics_tpu_torch.functional.text.bert import _greedy_layerwise_scores

    width, _, block = BERT_SHAPE
    forward = WordTable(vocab, width, TEXT_DEVICE)
    metric = mt.BERTScore(user_forward_fn=forward, batch_size=block, device=TEXT_DEVICE)
    ms = []
    for p, r in zip(chunks(hyps, MT_SHAPE[3]), chunks(refs, MT_SHAPE[3])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(p, r)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    result = {"pairs": len(hyps), "card": card, "update_ms": median(ms), "width": width, "block": block}
    spare = mt.BERTScore(user_forward_fn=forward, device=TEXT_DEVICE)
    result["update_reads"] = update_reads(lambda: spare.update(hyps[:block], refs[:block]))
    r: dict = {}
    got = timed_compute({"bert": metric}, r)["bert"]
    result["compute"] = {k: r[k] for k in ("compute_ms", "compute_again_ms")}
    result["compute"].update({k: r["compute_profile"][k] for k in ("host_reads", "device_to_host_copies",
                                                                  "host_to_device_copies", "memcpy_calls",
                                                                  "device_ms")})
    result["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all({"bert": metric}))
    # the matcher on one block of pairs, beside its bound: two (block, 64, width) inputs read, (3, block) written
    emb = forward(hyps[:block])[0][:, None]
    emb2 = forward(refs[:block])[0][:, None]
    scale = torch.full((block, BERT_SHAPE[1]), 1.0 / BERT_SHAPE[1], device=TEXT_DEVICE)
    tokens = BERT_SHAPE[1]
    result["matcher_device"] = op_profile(lambda: _greedy_layerwise_scores(emb, scale, emb2, scale),
                                          bytes_moved=2 * emb.numel() * 4, ops=2 * block * tokens * tokens * width)
    t0 = time.perf_counter()
    twin = mt.BERTScore(user_forward_fn=forward.to("cpu"), batch_size=block, device="cpu")
    for p, r_ in zip(chunks(hyps, MT_SHAPE[3]), chunks(refs, MT_SHAPE[3])):
        twin.update(p, r_)
    want = twin.compute()
    result["cpu_twin_s"] = time.perf_counter() - t0
    states_equal({"bert": metric}, {"bert": twin}, "bertscore")
    result["max_abs_err_vs_cpu"] = assert_values_close(got, want, "bertscore", atol=1e-6, rtol=TEXT_DEVICE_RTOL)
    result["f1_mean"] = float(np.mean(got["f1"]))
    log(f"text_eval bertscore_wmt14: {json.dumps(result)}  [{card}]")
    return result


class StubMLM(torch.nn.Module):
    """InfoLM's masked LM for the card phase, NOT a transformer: a seeded embedding of bert-base's
    30,522 ids and width 768, plus the mean of the sentence's embeddings, into a linear head over the
    vocabulary. It has the call contract of a transformers masked LM."""

    class Config:
        max_length = INFOLM_SHAPE[1]

    class Output:
        def __init__(self, logits):
            self.logits = logits

    config = Config()

    def __init__(self):
        super().__init__()
        _, _, vocab, width, _ = INFOLM_SHAPE
        g = torch.Generator(device="cpu").manual_seed(96)
        self.emb = torch.nn.Parameter(torch.randn(vocab, width, generator=g) / width**0.5)
        self.head = torch.nn.Parameter(torch.randn(width, vocab, generator=g) / width**0.5 * 4)

    def forward(self, input_ids, attention_mask):
        h = self.emb[input_ids]
        m = attention_mask.to(h.dtype)[..., None]
        ctx = (h * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(min=1.0)
        return self.Output((h + ctx) @ self.head)


class WhitespaceTokenizer:
    """Whitespace words hashed (crc32) to ids 1,000 to 30,521, with bert-base's [PAD] 0, [UNK] 100,
    [CLS] 101, [SEP] 102 and [MASK] 103, under the transformers call contract."""

    pad_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 101, 102, 103

    def __call__(self, sentences, padding="max_length", max_length=32, truncation=True, return_tensors="np"):
        import zlib

        ids = np.zeros((len(sentences), max_length), np.int64)
        mask = np.zeros((len(sentences), max_length), np.int64)
        for i, s in enumerate(sentences):
            row = [101] + [1000 + zlib.crc32(w.lower().encode()) % (INFOLM_SHAPE[2] - 1000) for w in s.split()]
            row = row[: max_length - 1] + [102]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def text_infolm(mt, card: str, hyps, refs) -> dict:
    import copy

    pairs, max_length, _, _, block = INFOLM_SHAPE
    model = StubMLM().to(TEXT_DEVICE)
    tok = WhitespaceTokenizer()
    kw = dict(model=model, user_tokenizer=tok, idf=True, max_length=max_length, batch_size=block,
              information_measure="kl_divergence", return_sentence_level_score=True)
    metric = mt.InfoLM(**kw, device=TEXT_DEVICE)
    metric.update(hyps[:pairs], refs[:pairs])
    r: dict = {}
    mean, scores = timed_compute({"infolm": metric}, r)["infolm"]
    assert scores.shape == (pairs,) and torch.isfinite(scores).all(), scores
    result = {"pairs": pairs, "card": card, "model": "stub masked LM (embedding + context mean + linear head),"
              " not a transformer", "compute": {k: r[k] for k in ("compute_ms", "compute_again_ms")},
              "forwards_per_compute": None, "value": float(mean)}
    result["compute"].update({k: r["compute_profile"][k] for k in ("host_reads", "device_to_host_copies",
                                                                  "host_to_device_copies", "memcpy_calls",
                                                                  "device_ms")})
    calls = [0]
    real_forward = model.forward

    def counted(*a, **k):
        calls[0] += 1
        return real_forward(*a, **k)

    model.forward = counted
    compute_all({"infolm": metric})
    model.forward = real_forward
    result["forwards_per_compute"] = calls[0]
    # every forward a full chunk's (block, max_length, width) x (width, vocab) product: the compute's bound
    _, _, vocab, width, _ = INFOLM_SHAPE
    ops = calls[0] * 2 * block * max_length * width * vocab
    result["forward_bound_ms"] = ops / FP32_OPS_PER_S * 1e3
    if result["compute"]["device_ms"]:
        result["share_of_bound"] = result["forward_bound_ms"] / result["compute"]["device_ms"]
    result["compute_peak_extra_bytes"] = peak_extra_bytes(lambda: compute_all({"infolm": metric}))
    n = INFOLM_CPU_PAIRS
    card_twin = mt.InfoLM(**kw, device=TEXT_DEVICE)
    card_twin.update(hyps[:n], refs[:n])
    cpu_kw = dict(kw, model=copy.deepcopy(model).to("cpu"))
    t0 = time.perf_counter()
    cpu_twin = mt.InfoLM(**cpu_kw, device="cpu")
    cpu_twin.update(hyps[:n], refs[:n])
    want = cpu_twin.compute()
    result["cpu_twin_s"] = time.perf_counter() - t0
    result["cpu_twin_pairs"] = n
    result["max_abs_err_vs_cpu"] = assert_values_close(card_twin.compute(), want, "infolm", atol=1e-6,
                                                       rtol=TEXT_DEVICE_RTOL)
    log(f"text_eval infolm: {json.dumps(result)}  [{card}]")
    return result


def text_path(mt, histogram, card: str) -> dict:
    """Phase 19, ``text_eval``: ASR, MT, summarisation, QA, LM, BERTScore and InfoLM families, each
    held against its CPU twin; the host text library built first (timed); 0 bincount launches."""
    from metrics_tpu_torch.ops import text_native

    t0 = time.perf_counter()
    path = text_native.build()
    out = {"library": {"path": str(path.relative_to(HERE)), "build_s": time.perf_counter() - t0}}
    histogram.KERNEL_LAUNCHES = 0
    dp0 = text_native.DP_CALLS
    hyps, refs = mt_corpus()
    for label, fn, args in (("asr_librispeech", text_asr, ()), ("mt_wmt14", text_mt, (hyps, refs)),
                            ("summ_cnndm", text_summ, ()), ("qa_squad", text_squad, ()), ("lm_gpt2", text_lm, ()),
                            ("bertscore_wmt14", text_bert, (hyps, refs, word_vocab(np.random.RandomState(91), MT_SHAPE[2]))),
                            ("infolm", text_infolm, (hyps, refs))):
        t1 = time.perf_counter()
        out[label] = fn(mt, card, *args)
        out[label]["family_s"] = time.perf_counter() - t1
    out["library"]["dp_calls"] = text_native.DP_CALLS - dp0
    out["kernel_launches"] = histogram.KERNEL_LAUNCHES
    assert out["kernel_launches"] == 0, f"text_eval: {out['kernel_launches']} bincount launches"
    return out


def separation_batches(seed: int, shape, device) -> list:
    """(preds, target, true permutation) of each update, on the card: sources of speech-like envelope,
    the estimates the sources in a random order per mixture plus white noise at 10 dB."""
    n, spk, samples, size = shape
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.linspace(0, 1, samples, device=device)
    out = []
    for start in range(0, n, size):
        b = min(size, n - start)
        rate = 2 + 6 * torch.rand(b, spk, 1, generator=g, device=device)
        envelope = 0.6 + 0.4 * torch.sin(2 * torch.pi * rate * t)
        target = torch.randn(b, spk, samples, generator=g, device=device) * envelope
        perm = torch.argsort(torch.rand(b, spk, generator=g, device=device), dim=1)
        preds = torch.gather(target, 1, perm[:, :, None].expand(-1, -1, samples))
        preds = preds + torch.randn(b, spk, samples, generator=g, device=device) * preds.pow(2).mean(-1, keepdim=True).div(10).sqrt()
        out.append((preds, target, perm))
    return out


def timed_updates(update, batches, owners=()) -> list:
    ms = []
    for b in batches:
        settle(*owners)
        t0 = time.perf_counter()
        update(*b)
        settle(*owners)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def pit_family(mt, F, label: str, shape, seed: int, card: str) -> dict:
    """PIT(SI-SDR, "max") over the mixtures; SI-SNR and SNR of the estimates in the permutation found.
    The permutations must be the true ones and the CPU twin's; the values within ``SNR_ATOL_DB``."""
    batches = separation_batches(seed, shape, TEXT_DEVICE)

    def make(device):
        return {"pit": mt.PermutationInvariantTraining(F.scale_invariant_signal_distortion_ratio, "max", device=device),
                "si_snr": mt.ScaleInvariantSignalNoiseRatio(device=device), "snr": mt.SignalNoiseRatio(device=device)}

    def feed(members, perms, preds, target):
        members["pit"].update(preds, target)
        _, perm = F.permutation_invariant_training(preds, target, F.scale_invariant_signal_distortion_ratio, "max")
        permuted = F.pit_permutate(preds, perm)
        members["si_snr"].update(permuted, target)
        members["snr"].update(permuted, target)
        perms.append(perm)

    card_m, card_perms = make(TEXT_DEVICE), []
    ms = timed_updates(lambda p, t, _: feed(card_m, card_perms, p, t), batches, owners=tuple(card_m.values()))
    result = {"mixtures": shape[0], "speakers": shape[1], "samples": shape[2], "update_mixtures": shape[3],
              "card": card, "update_ms": median(ms)}
    spare = make(TEXT_DEVICE)
    result["update_reads"] = update_reads(lambda: feed(spare, [], *batches[0][:2]))
    found = torch.cat(card_perms)
    # preds[b, i] = target[b, perm[b, i]]: target j is matched by the prediction at argsort(perm)[b, j]
    truth = torch.cat([torch.argsort(p, dim=1) for _, _, p in batches])
    wrong = int((found != truth).any(dim=1).sum())
    assert wrong == 0, f"{label}: {wrong} mixtures with a permutation that is not the true one"
    values = compute_all(card_m)
    t0 = time.perf_counter()
    cpu_m, cpu_perms = make("cpu"), []
    for preds, target, _ in batches:
        feed(cpu_m, cpu_perms, preds.cpu(), target.cpu())
    want = compute_all(cpu_m)
    result["cpu_twin_s"] = time.perf_counter() - t0
    assert torch.equal(found.cpu(), torch.cat(cpu_perms)), f"{label}: the permutations differ from the CPU's"
    assert all(torch.equal(card_m[k].total.cpu(), cpu_m[k].total) for k in card_m), f"{label}: counts differ"
    result["max_abs_err_db_vs_cpu"] = max(float((values[k].cpu() - want[k]).abs()) for k in want)
    assert result["max_abs_err_db_vs_cpu"] <= SNR_ATOL_DB, f"{label}: {values} against {want}"
    result["values_db"] = {k: float(v) for k, v in values.items()}
    log(f"audio_separation {label}: {json.dumps(result)}  [{card}]")
    return result


def sdr_family(mt, F, card: str) -> dict:
    """SDR (filter_length 512) over 500 clips of 32,000 samples in updates of 50, by the solve and by 10
    conjugate-gradient steps, then 50 clips in float64; the solve and the FFTs beside their bounds."""
    from metrics_tpu_torch.functional.audio import sdr as sdr_mod

    n, samples, size, taps = SDR_SHAPE
    g = torch.Generator(device=TEXT_DEVICE).manual_seed(97)
    batches = []
    for _ in range(n // size):
        target = torch.randn(size, samples, generator=g, device=TEXT_DEVICE)
        smooth = torch.nn.functional.avg_pool1d(target[:, None], 5, 1, 2)[:, 0]  # a filtered target
        batches.append((smooth + 0.3 * torch.randn(size, samples, generator=g, device=TEXT_DEVICE), target))
    result = {"clips": n, "samples": samples, "update_clips": size, "filter_length": taps, "card": card}
    for variant, kwargs, atol in (("solve", {}, SDR_F32_ATOL_DB), ("cg10", {"use_cg_iter": 10}, SDR_CG_ATOL_DB)):
        metric = mt.SignalDistortionRatio(filter_length=taps, device=TEXT_DEVICE, **kwargs)
        ms = timed_updates(metric.update, batches, owners=(metric,))
        got = metric.compute()
        per_clip_card = torch.cat([F.signal_distortion_ratio(p, t, filter_length=taps, **kwargs) for p, t in batches[:2]])
        t0 = time.perf_counter()
        per_clip_cpu = torch.cat([F.signal_distortion_ratio(p.cpu(), t.cpu(), filter_length=taps, **kwargs)
                                  for p, t in batches[:2]])
        twin = mt.SignalDistortionRatio(filter_length=taps, device="cpu", **kwargs)
        for p, t in batches:
            twin.update(p.cpu(), t.cpu())
        want = twin.compute()
        err = float((per_clip_card.cpu() - per_clip_cpu).abs().max())
        assert err <= atol and abs(float(got) - float(want)) <= atol, f"sdr {variant}: {err} dB per clip"
        result[variant] = {"update_ms": median(ms), "value_db": float(got), "max_abs_err_db_vs_cpu": err,
                           "mean_abs_err_db_vs_cpu": abs(float(got) - float(want)),
                           "cpu_twin_s": time.perf_counter() - t0,
                           "update_reads": update_reads(lambda m=metric: m.update(*batches[0]))}
    p64, t64 = (x[:SDR_F64_CLIPS].double() for x in batches[0])
    got64 = F.signal_distortion_ratio(p64, t64, filter_length=taps)
    want64 = F.signal_distortion_ratio(p64.cpu(), t64.cpu(), filter_length=taps)
    assert got64.dtype == torch.float64
    result["float64"] = {"clips": SDR_F64_CLIPS, "max_abs_err_db_vs_cpu": float((got64.cpu() - want64).abs().max())}
    assert result["float64"]["max_abs_err_db_vs_cpu"] <= SDR_F64_ATOL_DB, result["float64"]
    # the solve and the FFTs of one update beside their bounds
    preds, target = batches[0]
    tn = target / sdr_mod._l2_norm(target, dim=-1, keepdim=True)
    pn = preds / sdr_mod._l2_norm(preds, dim=-1, keepdim=True)
    r_0, b = sdr_mod._compute_autocorr_crosscorr(tn, pn, taps)
    system = sdr_mod._symmetric_toeplitz(r_0)
    n_fft = 2 ** int(np.ceil(np.log2(2 * samples - 1)))
    # four real FFTs of n_fft points a clip (two forward, two inverse), 2.5 n log2 n operations each
    fft_ops = 4 * size * int(2.5 * n_fft * np.log2(n_fft))
    result["ffts_device"] = op_profile(lambda: sdr_mod._compute_autocorr_crosscorr(tn, pn, taps),
                                       bytes_moved=2 * tn.numel() * 4 + 2 * size * taps * 4, ops=fft_ops)
    # LU of each 512 x 512 system (2/3 n^3) and its two triangular solves (2 n^2)
    solve_ops = size * int(2 / 3 * taps**3 + 2 * taps**2)
    result["solve_device"] = op_profile(lambda: torch.linalg.solve_ex(system, b[..., None]),
                                        bytes_moved=system.numel() * 4 + 2 * b.numel() * 4, ops=solve_ops)
    log(f"audio_separation sdr: {json.dumps(result)}  [{card}]")
    return result


def stoi_family(mt, card: str) -> dict:
    """STOI over 100 clips of 3 s at 16 kHz (resampled to 10 kHz on the host) in updates of 20, ESTOI
    over 20; PESQ's ``ModuleNotFoundError`` where ``pesq`` is absent, else PESQ over 20 clips."""
    from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE

    n, samples, fs, size = STOI_SHAPE
    g = torch.Generator(device=TEXT_DEVICE).manual_seed(98)
    t = torch.arange(samples, device=TEXT_DEVICE) / fs
    batches = []
    for _ in range(n // size):
        f0 = 100 + 200 * torch.rand(size, 1, generator=g, device=TEXT_DEVICE)
        envelope = (torch.sin(2 * torch.pi * 3 * t) > -0.3).float() * (0.5 + 0.5 * torch.rand(size, 1, generator=g, device=TEXT_DEVICE))
        clean = (torch.sin(2 * torch.pi * f0 * t) + 0.3 * torch.randn(size, samples, generator=g, device=TEXT_DEVICE)) * envelope
        batches.append((clean + 0.5 * torch.randn(size, samples, generator=g, device=TEXT_DEVICE), clean))
    result = {"clips": n, "samples": samples, "fs": fs, "card": card}
    for label, extended, use in (("stoi", False, batches), ("estoi", True, batches[: ESTOI_CLIPS // size])):
        metric = mt.ShortTimeObjectiveIntelligibility(fs, extended, device=TEXT_DEVICE)
        ms = timed_updates(metric.update, use, owners=(metric,))
        got = metric.compute()
        twin = mt.ShortTimeObjectiveIntelligibility(fs, extended, device="cpu")
        for p, c in use:
            twin.update(p.cpu(), c.cpu())
        want = twin.compute()
        err = abs(float(got) - float(want))
        assert err <= STOI_ATOL and 0 < float(got) <= 1, (label, float(got), float(want))
        result[label] = {"clips": sum(len(p) for p, _ in use), "update_ms": median(ms), "value": float(got),
                         "abs_err_vs_cpu": err, "update_reads": update_reads(lambda m=metric, b=use[0]: m.update(*b))}
    if _PESQ_AVAILABLE:
        metric = mt.PerceptualEvaluationSpeechQuality(fs, "wb", device=TEXT_DEVICE)
        metric.update(*batches[0])
        result["pesq"] = {"available": True, "clips": size, "value": float(metric.compute())}
    else:
        try:
            mt.PerceptualEvaluationSpeechQuality(fs, "wb", device=TEXT_DEVICE)
        except ModuleNotFoundError as err:
            result["pesq"] = {"available": False, "error": str(err)}
        else:
            raise AssertionError("PESQ without the pesq package did not raise ModuleNotFoundError")
    log(f"audio_separation stoi: {json.dumps(result)}  [{card}]")
    return result


def audio_path(mt, histogram, card: str) -> dict:
    """Phase 20, ``audio_separation``: PIT at WSJ0-2mix and WSJ0-3mix shape, SDR, STOI/ESTOI and PESQ,
    each against its CPU twin; 0 bincount launches."""
    import metrics_tpu_torch.functional as F

    histogram.KERNEL_LAUNCHES = 0
    out = {}
    for label, fn in (("pit_wsj0_2mix", lambda: pit_family(mt, F, "pit_wsj0_2mix", PIT_SHAPE, 99, card)),
                      ("pit_wsj0_3mix", lambda: pit_family(mt, F, "pit_wsj0_3mix", PIT3_SHAPE, 100, card)),
                      ("sdr", lambda: sdr_family(mt, F, card)), ("stoi", lambda: stoi_family(mt, card))):
        t0 = time.perf_counter()
        out[label] = fn()
        out[label]["family_s"] = time.perf_counter() - t0
    out["kernel_launches"] = histogram.KERNEL_LAUNCHES
    assert out["kernel_launches"] == 0, f"audio_separation: {out['kernel_launches']} bincount launches"
    return out


def text_audio_paths(mt, histogram, card: str) -> dict:
    """Phases 19 and 20, each timed."""
    out = {}
    for label, fn in (("text_eval", text_path), ("audio_separation", audio_path)):
        t0 = time.perf_counter()
        out[label] = fn(mt, histogram, card)
        out[label]["phase_s"] = time.perf_counter() - t0
    out["kernel_launches"] = out["text_eval"]["kernel_launches"] + out["audio_separation"]["kernel_launches"]
    return out


# ------------------------------------------------------------------ phase 10
SYNC_SUITES = ("headline", "agreement", "segmentation", "aggregators", "curves", "regression", "retrieval", "bootstrap",
               "ssim", "map", "fid", "text", "audio")
SYNC_TEXT_SENTENCES = 32  # sentences of each synced text update on each rank
SYNC_AUDIO_SHAPE = (8, 2, 4000)  # mixtures, speakers, samples of each synced audio update on each rank
SYNC_MAP_IMAGES = 4  # images of each synced mAP update on each rank (five list states of spec None, a row an image)
SYNC_FID_SHAPE = (32, 1, 8, 8)  # the synced FID's images an update on each rank; its features the first 48 pixels
SYNC_BOOT_CLONES = 100  # the synced BootStrapper's clones of Accuracy (macro, C=1000): 600 states
SYNC_IMAGE_SHAPE = (4, 3, 64, 64)  # the synced SSIM suite's images an update on each rank
SYNC_REGRESSION_ROWS = 65_536  # rows of each regression update on each rank
SYNC_STEPS = 2  # updates of each suite on each rank
SYNC_STEPS_OF = {"segmentation": 1}  # but these: the CPU reference of 2 x 19 x 1024 x 2048 takes 9 s an update
SYNC_TRIALS = 3  # timed syncs of each protocol, alternating, after one untimed sync
SYNC_WORLD_S = 600  # wall-clock limit of the two-rank world
SYNC_DEVICE = "cuda"  # where the synced suites live


def sync_suite(mt, name: str, device: str):
    if name == "headline":
        return make_suite(mt, 128, device)
    if name == "agreement":
        return agreement_suite(mt, device, 1000)
    if name == "segmentation":
        return segmentation_suite(mt, device, 19)
    if name == "curves":
        return mt.MetricCollection({"auroc": mt.AUROC(pos_label=1, device=device),
                                    "ap": mt.AveragePrecision(pos_label=1, device=device)})
    if name == "regression":  # Pearson's moments of spec None, stacked; Spearman's `cat` rows
        return mt.MetricCollection({"mse": mt.MeanSquaredError(device=device), "r2": mt.R2Score(device=device),
                                    "pearson": mt.PearsonCorrCoef(device=device),
                                    "spearman": mt.SpearmanCorrCoef(device=device),
                                    "tweedie": mt.TweedieDevianceScore(power=1.5, device=device)})
    if name == "retrieval":  # rows of int64 query ids in list states of spec None
        return mt.MetricCollection({"map": mt.RetrievalMAP(device=device), "mrr": mt.RetrievalMRR(device=device),
                                    "ndcg@10": mt.RetrievalNormalizedDCG(k=10, device=device),
                                    "r@100": mt.RetrievalRecall(k=100, device=device)})
    if name == "bootstrap":  # a wrapper tree: 100 clones' states, none of the wrapper's own
        return mt.MetricCollection({"boot": mt.BootStrapper(mt.Accuracy(num_classes=1000, average="macro", device=device),
                                                            num_bootstraps=SYNC_BOOT_CLONES)})
    if name == "ssim":  # buffered image rows, `cat` lists shared by one compute group
        return mt.MetricCollection({"ssim": mt.StructuralSimilarityIndexMeasure(data_range=1.0, device=device),
                                    "uqi": mt.UniversalImageQualityIndex(device=device)})
    if name == "map":  # per-image rows of boxes, scores and labels: list states of spec None
        return mt.MetricCollection({"map": mt.MeanAveragePrecision(box_format="xywh", device=device)})
    if name == "fid":  # the real and generated feature buffers: list states of spec None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return mt.MetricCollection({"fid": mt.FrechetInceptionDistance(feature=sync_features, device=device)})
    if name == "text":  # float32 sums, packed uint8 `cat` sentences (chrF), per-sentence rows of spec None (ROUGE)
        return mt.MetricCollection({"wer": mt.WordErrorRate(device=device), "bleu": mt.BLEUScore(device=device),
                                    "chrf": mt.CHRFScore(device=device),
                                    "rouge": mt.ROUGEScore(rouge_keys=("rouge1", "rougeL"), device=device)},
                                   compute_groups=False)
    if name == "audio":  # the float32 sums and int32 counts of PIT and SDR
        import metrics_tpu_torch.functional as F

        return mt.MetricCollection({"pit": mt.PermutationInvariantTraining(F.scale_invariant_signal_distortion_ratio,
                                                                           "max", device=device),
                                    "sdr": mt.SignalDistortionRatio(filter_length=32, device=device)},
                                   compute_groups=False)
    return mt.MetricCollection({n: getattr(mt, n)(device=device) for n in AGGREGATORS}, compute_groups=False)


def sync_features(imgs):
    """The synced FID's feature: an image's first 48 pixels (no network: the suite syncs buffers)."""
    return imgs.reshape(imgs.shape[0], -1)[:, :48]


def to_device(obj, device):
    """Tensors in (nested lists, tuples and dicts of) ``obj`` moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def sync_batches(name: str, rank: int, steps: Optional[int] = None) -> list:
    """Rank ``rank``'s updates of suite ``name`` on the card, ``(args, kwargs)`` each, from a seed
    of the suite and the rank: full-width batches, and per-sample losses of an uneven length."""
    seed = 100 + 10 * rank + SYNC_SUITES.index(name)
    steps = SYNC_STEPS_OF.get(name, SYNC_STEPS) if steps is None else steps
    if name == "headline":
        return [((p, t), {}) for p, t in make_batches(8192, 128, steps, seed)]
    if name == "agreement":
        return [((p, t), {}) for p, t in make_batches(4096, 1000, steps, seed, signal=4.0)]
    if name == "segmentation":
        return [((p, t), {}) for p, t in make_batches(2, 19, steps, seed, signal=3.0, spatial=(1024, 2048))]
    if name == "regression":
        return [(b, {}) for b in regression_batches(seed, shape=(steps, SYNC_REGRESSION_ROWS))]
    if name == "retrieval":  # the ranks hold rows of the same queries
        return [(b, {}) for b in retrieval_batches(seed, steps=steps)]
    if name == "text":
        hyps, refs = mt_corpus(seed, n=steps * SYNC_TEXT_SENTENCES)
        return [((p, r), {}) for p, r in zip(chunks(hyps, SYNC_TEXT_SENTENCES), chunks(refs, SYNC_TEXT_SENTENCES))]
    if name == "audio":
        mixtures, spk, samples = SYNC_AUDIO_SHAPE
        return [((p, t), {}) for p, t, _ in separation_batches(seed, (steps * mixtures, spk, samples, mixtures),
                                                                SYNC_DEVICE)]
    g = torch.Generator(device=SYNC_DEVICE).manual_seed(seed)
    if name == "bootstrap":
        return [((torch.softmax(torch.randn(1000, 1000, generator=g, device=SYNC_DEVICE) * 2, dim=1),
                  torch.randint(0, 1000, (1000,), generator=g, device=SYNC_DEVICE)), {}) for _ in range(steps)]
    if name == "map":
        data = coco_detections(steps * SYNC_MAP_IMAGES, seed=seed)
        return [((to_device([{k: torch.as_tensor(v) for k, v in p.items()} for p, _ in chunk], SYNC_DEVICE),
                  to_device([{k: torch.as_tensor(v) for k, v in t.items()} for _, t in chunk], SYNC_DEVICE)), {})
                for chunk in (data[i : i + SYNC_MAP_IMAGES] for i in range(0, len(data), SYNC_MAP_IMAGES))]
    if name == "fid":
        return [((torch.rand(SYNC_FID_SHAPE, generator=g, device=SYNC_DEVICE) + 0.2 * step,), {"real": step % 2 == 0})
                for step in range(steps)]
    if name == "ssim":
        out = []
        for _ in range(steps):
            target = torch.rand(SYNC_IMAGE_SHAPE, generator=g, device=SYNC_DEVICE)
            noise = 0.05 * torch.randn(SYNC_IMAGE_SHAPE, generator=g, device=SYNC_DEVICE)
            out.append((((target + noise).clamp(0, 1), target), {}))
        return out
    if name == "curves":
        # binary rows of shapes (n,) and (n, 1) in turn, rank 1's in the other order: each sync
        # must bring them to one rank before it packs them
        out = []
        for step in range(steps):
            n = 65536 + 4096 * rank
            preds = torch.round(torch.rand(n, generator=g, device=SYNC_DEVICE) * 4096) / 4096
            target = (torch.rand(n, generator=g, device=SYNC_DEVICE) < 0.3).to(torch.int64)
            if (step + rank) % 2:
                preds, target = preds[:, None], target[:, None]
            out.append(((preds, target), {}))
        return out
    batch = 4096 + 1000 * rank  # CatMetric holds an uneven number of rows on each rank
    return [((torch.rand(batch, generator=g, device=SYNC_DEVICE) * 3,),
             {"weight": torch.rand(batch, generator=g, device=SYNC_DEVICE)}) for _ in range(steps)]


def per_state_gather(tensor, group=None):
    """``gather_all_tensors`` behind another name: a ``dist_sync_fn`` that forces the per-state protocol."""
    from metrics_tpu_torch.parallel import gather_all_tensors

    return gather_all_tensors(tensor, group)


def suite_nodes(suite) -> dict:
    """Every metric of a suite's trees by dotted name: the members (of a collection, or of a dict)
    and, under them, the child metrics of wrappers and compositions."""
    out = {}

    def walk(name, metric):
        out[name] = metric
        for child_name, child in metric._named_child_metrics():
            walk(f"{name}.{child_name}", child)

    items = suite.items() if isinstance(suite, dict) else suite.items(keep_base=True, copy_state=False)
    for name, m in items:
        walk(name, m)
    return out


def suite_states(suite) -> dict:
    """(node, state) -> the state of every metric of the suite's trees, a list state concatenated
    as a sync leaves it."""
    out = {}
    for name, m in suite_nodes(suite).items():
        for state, value in m.metric_state.items():
            out[(name, state)] = torch.cat(value) if isinstance(value, list) else value
    return out


def timed_sync(suite, protocol: str) -> tuple:
    """One suite sync by ``protocol``: (ms on the host clock, ending in a synchronise; collective counts)."""
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    kwargs = {"dist_sync_fn": per_state_gather} if protocol == "per_state" else {}
    reset_collective_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    suite.sync(distributed_available=lambda: True, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = collective_stats()
    return ms, {k: stats[k] for k in ("sync_shape_collectives", "sync_payload_collectives", "sync_bytes_gathered",
                                      "sync_states_coalesced")}


def sync_trials(suite, check=None) -> dict:
    """One untimed coalesced sync (a live group checks a new static layout once), then
    ``SYNC_TRIALS`` syncs of each protocol, alternating; ``check(suite)`` after each sync."""
    out = {"first": None, "coalesced": [], "per_state": []}
    order = ["coalesced"] + ["coalesced", "per_state", "per_state", "coalesced"] * ((SYNC_TRIALS + 1) // 2)
    for i, protocol in enumerate(order):
        ms, counts = timed_sync(suite, protocol)
        if check is not None:
            check(suite)
        suite.unsync()
        if i == 0:
            out["first"] = counts
        elif len(out[protocol]) < SYNC_TRIALS:
            out[protocol].append((ms, counts))
    result = {"first_sync_counts": out["first"]}
    for protocol in ("coalesced", "per_state"):
        times = sorted(ms for ms, _ in out[protocol])
        counts = [c for _, c in out[protocol]]
        assert all(c == counts[0] for c in counts), f"{protocol}: the collective counts differ between syncs: {counts}"
        result[protocol] = {"sync_ms_median": times[len(times) // 2], "sync_ms": times, "counts": counts[0]}
    return result


def sync_profile(suite, protocol: str, syncs: int = 1) -> dict:
    """Where a suite sync's time goes (torch.profiler, ``syncs`` syncs after one in the warm-up
    cycle): device ms and device operations per sync, and per sync the host ops with the most
    self CPU time, each with its calls. Host times are taken under the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kwargs = {"dist_sync_fn": per_state_gather} if protocol == "per_state" else {}

    def one_sync():
        suite.sync(distributed_available=lambda: True, **kwargs)
        torch.cuda.synchronize()
        suite.unsync()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        one_sync()
        prof.step()
        for _ in range(syncs):
            one_sync()
        prof.step()

    rows = [e for e in prof.key_averages() if not e.key.startswith("ProfilerStep")]
    device = [e for e in rows if device_us(e) > 0 and e.self_cpu_time_total == 0]
    host = sorted((e for e in rows if e.self_cpu_time_total > 0), key=lambda e: -e.self_cpu_time_total)
    return {
        "device_ms_per_sync": sum(device_us(e) for e in device) / 1e3 / syncs if device else None,
        "device_ops_per_sync": sum(e.count for e in device) / syncs,
        "host_op_ms_per_sync": sum(e.self_cpu_time_total for e in host) / 1e3 / syncs,
        "top_host_ops_per_sync": {e.key[:60]: [e.self_cpu_time_total / 1e3 / syncs, e.count / syncs] for e in host[:8]},
    }


def assert_sync_counts(label: str, result: dict, n_states: int, has_cat: bool, row_gathers: int = 0,
                       row_states: int = 0) -> None:
    """A coalesced sync is one payload collective (plus one metadata collective for ``cat`` states),
    the per-state protocol two collectives a state. List states of spec None (``row_states`` of the
    ``n_states``, ``row_gathers`` rows in all: the retrieval, mAP and FID rows, ROUGE's sentences)
    decline the packed lane in both packages: two collectives a row, in both protocols."""
    co, ps = result["coalesced"]["counts"], result["per_state"]["counts"]
    if row_gathers and row_states == n_states:
        for counts in (co, ps):
            assert counts["sync_shape_collectives"] == counts["sync_payload_collectives"] == row_gathers, (
                f"{label}: {counts} for {row_gathers} buffered rows")
        return
    packed = n_states - row_states
    assert co["sync_payload_collectives"] == 1 + row_gathers, f"{label}: {co} payload collectives per coalesced sync"
    assert co["sync_shape_collectives"] == int(has_cat) + row_gathers, f"{label}: {co} metadata collectives per coalesced sync"
    assert co["sync_states_coalesced"] == packed, f"{label}: {co['sync_states_coalesced']} of {packed} states packed"
    assert ps["sync_shape_collectives"] == ps["sync_payload_collectives"] == packed + row_gathers, (
        f"{label}: the per-state protocol issued {ps} for {packed} states and {row_gathers} rows")


def sync_world_of_one(mt, histogram, name: str, card: str) -> dict:
    """Suite ``name`` updated on the card, then synced through NCCL in a world of one rank: every
    state bit-exact after each sync, the local states back after each unsync, the collective
    counts of both protocols, and their sync times."""
    suite = sync_suite(mt, name, SYNC_DEVICE)
    histogram.KERNEL_LAUNCHES = 0
    with eager_clone_rows() as clone_rows:
        for args, kwargs in sync_batches(name, 0):
            suite.update(*args, **kwargs)
    settle(suite)
    launches = histogram.KERNEL_LAUNCHES
    members = suite_nodes(suite)
    if name in ("curves", "retrieval"):
        # buffered raw rows (shapes (n,) and (n, 1); int64 targets): the first sync brings them to their
        # canonical form in place (Metric._canonicalize_list_states) before it packs them; the local
        # states are read after it
        suite.sync(distributed_available=lambda: True)
        suite.unsync()
        assert all(r.ndim == 1 for m in members.values() for r in m.preds + m.target), "rows not canonicalised"
    local = {(m, s): v for m, member in members.items() for s, v in member.metric_state.items()}
    want = {k: v.clone() for k, v in suite_states(suite).items()}
    has_cat = any(isinstance(v, list) and members[m]._reduction_specs[s] == "cat" for (m, s), v in local.items())
    row_gathers = sum(len(v) for (m, s), v in local.items() if isinstance(v, list) and members[m]._reduction_specs[s] is None)
    row_states = sum(1 for (m, s), v in local.items() if isinstance(v, list) and members[m]._reduction_specs[s] is None)

    def check(synced):
        for (m, s), value in want.items():
            got = getattr(members[m], s)
            if isinstance(got, list):  # rows of spec None, gathered row by row
                got = torch.cat(got)
            elif members[m]._reduction_specs[s] is None:
                assert got.shape == (1,) + value.shape, f"sync {name}: {m}.{s} not stacked"  # one row a process
                got = got[0]
            assert got.device == value.device and got.dtype == value.dtype and torch.equal(got, value), (
                f"sync {name}: {m}.{s} changed in a world of one")

    result = sync_trials(suite, check)
    for (m, s), value in local.items():  # unsync put back the very same local states
        got = getattr(members[m], s)
        assert (got == value) if isinstance(value, list) else (got is value), f"sync {name}: {m}.{s} not restored"
    assert_sync_counts(f"sync {name} (NCCL, world of one)", result, len(want), has_cat, row_gathers, row_states)
    # the first update of a collection runs every member: each confusion-matrix member and each stat-scores
    # member with class pairs launches once; then one a compute group a step. The bootstrap's updates are all
    # eager or certified by eager clone updates, over Accuracy of as many classes as rows: a clone's update
    # launches once where it drew enough rows for the class ids (pair_histogram_updates)
    steps = SYNC_STEPS_OF.get(name, SYNC_STEPS)
    if name == "bootstrap":
        assert len(clone_rows) == SYNC_BOOT_CLONES * steps, f"sync bootstrap: {len(clone_rows)} eager clone updates"
        expected = pair_histogram_updates(clone_rows, 1000)
    else:
        expected = {"headline": 3 * steps + 1, "agreement": 2 * steps + 2, "segmentation": 2 * steps}.get(name, 0)
    assert launches == expected, f"sync {name}: {launches} bincount launches in {steps} updates, not {expected}"
    packed = result["coalesced"]["counts"]["sync_bytes_gathered"]
    result.update(states=len(want), bytes_packed=packed, kernel_launches=launches, card=card)
    result["profile"] = {protocol: sync_profile(suite, protocol) for protocol in ("coalesced", "per_state")}
    log(f"sync {name} (NCCL, world of one): {len(want)} states, {packed} bytes packed; collectives a sync: coalesced "
        f"{result['coalesced']['counts']['sync_shape_collectives']} metadata + "
        f"{result['coalesced']['counts']['sync_payload_collectives']} payload (first sync "
        f"{result['first_sync_counts']['sync_shape_collectives']} + "
        f"{result['first_sync_counts']['sync_payload_collectives']}), per-state "
        f"{result['per_state']['counts']['sync_shape_collectives']} shape + "
        f"{result['per_state']['counts']['sync_payload_collectives']} payload; sync ms (median of {SYNC_TRIALS}): "
        f"coalesced {result['coalesced']['sync_ms_median']:.4f}, per-state {result['per_state']['sync_ms_median']:.4f}"
        f"  [{card}]")
    log(f"sync {name} profile: {json.dumps(result['profile'])}  [{card}]")
    return result


def gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """One rank of the two-rank world on the one card (Gloo, CUDA tensors): each suite fed this
    rank's batches and computed (``compute()`` syncs), then timed syncs of both protocols."""
    import torch.distributed as dist

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    result: dict = {}
    try:
        probe = torch.full((4,), rank, dtype=torch.int32, device=SYNC_DEVICE)
        rows = [torch.empty_like(probe) for _ in range(world)]
        try:
            dist.all_gather(rows, probe)
            result["gloo_cuda"] = [r.tolist() for r in rows] == [[r] * 4 for r in range(world)]
        except RuntimeError as err:
            result["gloo_cuda"], result["gloo_cuda_error"] = False, str(err)
        for name in SYNC_SUITES if result["gloo_cuda"] else ():
            suite = sync_suite(mt, name, SYNC_DEVICE)
            for args, kwargs in sync_batches(name, rank):
                suite.update(*args, **kwargs)
            reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values = suite.compute()
            torch.cuda.synchronize()
            compute_ms = (time.perf_counter() - t0) * 1e3
            stats = collective_stats()
            suite.unsync()  # the retrieval members leave compute() synced, as in JAX
            n_states = len(suite_states(suite))
            row_lists = [getattr(m, s) for m in suite_nodes(suite).values()
                         for s, spec in m._reduction_specs.items() if spec is None and isinstance(getattr(m, s), list)]
            result[name] = {
                "values": {k: v.cpu() for k, v in values.items()},
                "compute_ms": compute_ms,
                "compute_counts": {k: stats[k] for k in ("sync_shape_collectives", "sync_payload_collectives",
                                                         "sync_bytes_gathered")},
                "states": n_states,
                "has_cat": name in ("aggregators", "curves", "regression", "ssim", "text"),
                "row_gathers": sum(len(rows) for rows in row_lists),
                "row_states": len(row_lists),
                **sync_trials(suite),
            }
            if name == "bootstrap":  # the draws differ by rank: the reference is the sum of the local states
                result[name]["local"] = {k: v.cpu() for k, v in suite_states(suite).items()}
            del suite
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        dist.destroy_process_group()


def run_two_ranks(world: int = 2) -> list:
    """Spawn the two ranks of the Gloo world; kill them at ``SYNC_WORLD_S`` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=gloo_rank, args=(rank, world, init_method, tmp)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SYNC_WORLD_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise RuntimeError(f"two-rank sync world: exit codes {codes}, {len(hung)} killed at {SYNC_WORLD_S} s")
        return [torch.load(os.path.join(tmp, f"{rank}.pt")) for rank in range(world)]


def sync_two_ranks(mt, card: str) -> dict:
    """Two ranks on the one card over Gloo: both ranks' synced values equal one CPU instance
    fed every batch of both (counts bit-exact, values within atol 1e-6 and rtol 1e-5)."""
    t0 = time.perf_counter()
    results = run_two_ranks()
    log(f"sync two ranks: the spawned world took {time.perf_counter() - t0:.1f} s")
    if not all(r["gloo_cuda"] for r in results):
        log(f"sync two ranks: torch's Gloo refused CUDA tensors for all_gather: {results[0].get('gloo_cuda_error')}")
        return {"gloo_cuda": False, "error": results[0].get("gloo_cuda_error"), "card": card}
    out = {"gloo_cuda": True, "card": card}
    for name in SYNC_SUITES:
        t_ref = time.perf_counter()
        reference = sync_suite(mt, name, "cpu")
        ranks_batches = [sync_batches(name, rank) for rank in range(len(results))]
        if name == "bootstrap":
            # every clone's synced state is the sum of the ranks' local states: a CPU BootStrapper
            # loaded with those sums computes what each rank's synced compute() must give
            summed = {f"{node}.{state}": sum(r[name]["local"][(node, state)] for r in results).numpy()
                      for node, state in results[0][name]["local"]}
            mt.load_reference_state(reference, summed, update_count=SYNC_STEPS * len(results), mode="multi-class")
            ranks_batches = []
        # rows in the order the sync leaves them: rank by rank, but the rows of spec None (gathered
        # row by row) row by row, each row's ranks in turn: a retrieval or FID row is an update's,
        # an mAP row an image's
        if name in ("retrieval", "fid"):
            order = [ranks_batches[r][b] for b in range(SYNC_STEPS) for r in range(len(results))]
        elif name == "map":
            order = [(tuple(part[i : i + 1] for part in ranks_batches[r][b][0]), {})
                     for b in range(SYNC_STEPS) for i in range(SYNC_MAP_IMAGES) for r in range(len(results))]
        else:
            order = [batch for batches in ranks_batches for batch in batches]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for args, kwargs in order:
                reference.update(*to_device(args, "cpu"), **to_device(kwargs, "cpu"))
            want = reference.compute()
        for rank, result in enumerate(results):
            got = result[name]["values"]
            assert sorted(got) == sorted(want), f"sync {name}, rank {rank}: keys {sorted(got)}"
            for key, value in want.items():
                g = got[key]
                assert torch.isfinite(g.float()).all(), f"sync {name}, rank {rank}: {key} is not finite"
                if value.is_floating_point():
                    torch.testing.assert_close(g, value, atol=1e-6, rtol=1e-5, msg=f"sync {name}, rank {rank}: {key}")
                else:
                    assert g.dtype == value.dtype and torch.equal(g, value), f"sync {name}, rank {rank}: {key} differs"
            assert_sync_counts(f"sync {name} (Gloo, rank {rank})", result[name], result[name]["states"],
                               result[name]["has_cat"], result[name]["row_gathers"], result[name]["row_states"])
        r0 = results[0][name]
        out[name] = {k: [r[name][k] for r in results] for k in ("compute_ms", "compute_counts")}
        out[name]["reference_s"] = time.perf_counter() - t_ref
        out[name].update({p: [r[name][p] for r in results] for p in ("coalesced", "per_state", "first_sync_counts")})
        out[name]["states"] = r0["states"]
        log(f"sync {name} (Gloo, two ranks on one card, CUDA tensors): both ranks equal the CPU fed every batch; "
            f"compute() with its sync {[round(r[name]['compute_ms'], 4) for r in results]} ms; sync ms (median of "
            f"{SYNC_TRIALS}, rank 0): coalesced {r0['coalesced']['sync_ms_median']:.4f} "
            f"({r0['coalesced']['counts']['sync_shape_collectives']} metadata + "
            f"{r0['coalesced']['counts']['sync_payload_collectives']} payload, "
            f"{r0['coalesced']['counts']['sync_bytes_gathered']} bytes gathered), per-state "
            f"{r0['per_state']['sync_ms_median']:.4f} ({r0['per_state']['counts']['sync_payload_collectives']} x 2)"
            f"  [{card}]")
    return out


def sync_path(mt, histogram, card: str) -> dict:
    """Phase 10: every suite synced through NCCL in a world of one rank, then two ranks over Gloo."""
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the machine has no network: bootstrap over loopback
    torch.cuda.set_device(0)
    result, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0, world_size=1)
        try:
            for name in SYNC_SUITES:
                t0 = time.perf_counter()
                result[name] = sync_world_of_one(mt, histogram, name, card)
                seconds[f"nccl_{name}"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    result["kernel_launches"] = sum(result[name]["kernel_launches"] for name in SYNC_SUITES)
    t0 = time.perf_counter()
    result["two_ranks_gloo"] = sync_two_ranks(mt, card)
    seconds["two_ranks_gloo"] = time.perf_counter() - t0
    result["seconds"] = seconds
    log(f"sync phase seconds: {json.dumps(seconds)}")
    return result


# ---- phase 21: observability_journal
OBS_DEVICE = "cuda"  # where phase 21 runs
OBS_SHAPE = (8192, 128, 5, 50)  # the headline suite's batch, classes, warm-up and timed steps (phase 3's)
OBS_TRIALS = 3  # armed and disarmed runs, alternating
OBS_BOOT_STEPS = (10, 5)  # the BootStrapper's updates before the save, and after the restore
OBS_DRILL_SYNCS = 12  # at most this many syncs after the sync-pack drill, until the suite's lane re-promotes


def journal_copies(fn) -> dict:
    """One call of ``fn`` under torch.profiler (nothing in the warm-up cycle): its copy calls."""
    prof = compute_profile(fn, warmup_fn=lambda: None)
    return {k: prof[k] for k in ("memcpy_calls", "device_to_host_copies", "host_to_device_copies")}


def host_ms(fn) -> tuple:
    """(ms on the host clock of one call of ``fn``, ending in a synchronise; its return value)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def assert_states_bit_equal(got_suite, want_suite, label: str) -> int:
    """Every state of two suites (or metric trees), byte for byte after a move to the CPU; returns the bytes compared."""
    tree = lambda x: {"m": x} if hasattr(x, "_named_child_metrics") else x  # noqa: E731 - a metric, or a collection
    got, want = suite_states(tree(got_suite)), suite_states(tree(want_suite))
    assert got.keys() == want.keys(), f"{label}: the trees differ"
    nbytes = 0
    for key, w in want.items():
        g, w = (got[key].cpu(), w.cpu()) if not isinstance(w, list) else (got[key], w)
        if isinstance(w, list):
            assert g == w == [], f"{label} {key}: rows on one side only"
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label} {key}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}"
        assert torch.equal(g.reshape(-1).view(torch.uint8) if g.dtype != torch.bool else g, w.reshape(-1).view(
            torch.uint8) if w.dtype != torch.bool else w), f"{label} {key}: the bytes differ"
        nbytes += w.numel() * w.element_size()
    return nbytes


def journal_tree(label: str, make_card, make_cpu, live, path: str, cpu_run=None, extra_steps=None) -> dict:
    """Phase 21's journal round trip of one tree: save ``live`` (timed, copies counted), load into a fresh
    card instance (timed, copies counted) and into a CPU twin; every state byte for byte, ``compute()``
    equal to the uninterrupted run, the twin equal to ``cpu_run`` where one is given (else to the card's
    states). ``extra_steps(metric)`` runs after the restore on both the live and the restored tree."""
    from metrics_tpu_torch.ops import journal

    save_ms, nbytes = host_ms(lambda: live.save_state(path))
    save_copies = journal_copies(lambda: live.save_state(path))
    restored = make_card()
    load_ms, gen = host_ms(lambda: restored.load_state(path))
    assert gen == 0, f"{label}: restored generation {gen}"
    load_copies = journal_copies(lambda: restored.load_state(path))
    for copies, what in ((save_copies, "save"), (load_copies, "load")):
        assert copies["memcpy_calls"] == 1, f"{label}: {copies['memcpy_calls']} copy calls in a {what}"
    state_bytes = assert_states_bit_equal(restored, live, f"journal {label} (card)")
    twin = make_cpu()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a BootStrapper's card generator does not fit the CPU twin's: it says so
        twin_ms, _ = host_ms(lambda: twin.load_state(path))
    assert_states_bit_equal(twin, cpu_run if cpu_run is not None else live, f"journal {label} (CPU twin)")
    if extra_steps is not None:
        extra_steps(live)
        extra_steps(restored)
        assert_states_bit_equal(restored, live, f"journal {label} after the restore's own updates")
    compute_ms, want = host_ms(live.compute)
    assert_values_close(restored.compute(), to_device(want, "cpu"), f"journal {label} compute", atol=0.0, rtol=0.0)
    if cpu_run is not None:
        assert_values_close(twin.compute(), cpu_run.compute(), f"journal {label} CPU twin compute", atol=0.0, rtol=0.0)
    out = {"record_bytes": nbytes, "state_bytes": state_bytes, "save_ms": save_ms, "load_ms": load_ms,
           "cpu_twin_load_ms": twin_ms, "compute_ms": compute_ms, "save_copies": save_copies,
           "load_copies": load_copies, "bit_exact": True}
    assert os.path.getsize(path) == nbytes and journal.journal_generations() >= 1
    return out


def telemetry_cost(mt, checks, histogram, card: str) -> tuple:
    """The headline suite with telemetry armed and disarmed, alternating: ms/step, spans by site, launches."""
    from metrics_tpu_torch.ops import telemetry

    batch, num_classes, warmup, timed = OBS_SHAPE
    batches = make_batches(batch, num_classes, warmup + timed, seed=0, device=OBS_DEVICE)
    checks.set_validation_mode("first")
    reference = make_suite(mt, num_classes, "cpu")
    for preds, target in batches:
        reference.update(preds.cpu(), target.cpu())
    runs = {"armed": [], "disarmed": []}
    result = {"batch": batch, "num_classes": num_classes, "timed_steps": timed, "trials": OBS_TRIALS}
    kept = None
    for trial in range(OBS_TRIALS):
        for mode in ("armed", "disarmed"):
            telemetry.set_telemetry(mode == "armed")
            telemetry.clear_spans()
            suite = make_suite(mt, num_classes, OBS_DEVICE)
            histogram.KERNEL_LAUNCHES = 0
            runs[mode].append(run_suite(suite, batches, warmup) / timed * 1e3)
            launches = histogram.KERNEL_LAUNCHES
            confmat_updates = dict(suite.items(keep_base=True, copy_state=False))["confmat"].update_count
            assert confmat_updates == warmup + timed, f"telemetry {mode}: {confmat_updates} confmat updates"
            assert launches == 3 * confmat_updates + 1, f"telemetry {mode}: {launches} launches"
            spans = telemetry.spans()
            if mode == "disarmed":
                assert spans == [] and telemetry.telemetry_stats()["spans_recorded"] == 0, "a disarmed run emitted"
            else:
                by_site = {}
                for r in spans:
                    by_site[r["site"]] = by_site.get(r["site"], 0) + 1
                # one suite-step a call; every call after the first enqueues (validation mode "first"), and
                # the flushes run the suite's step program (a build, a first run of a chunk length, a run)
                assert by_site.pop("suite-step") == warmup + timed, f"telemetry: spans {by_site}"
                assert by_site.pop("engine-enqueue") == warmup + timed - 1, f"telemetry: spans {by_site}"
                assert by_site.pop("engine-flush") >= 2, f"telemetry: spans {by_site}"
                assert set(by_site) <= {"engine-build", "engine-compile", "engine-dispatch"}, by_site
                by_site = {r["site"]: 0 for r in spans}
                for r in spans:
                    by_site[r["site"]] += 1
                if trial == 0:
                    result["spans_per_step"] = {k: v / (warmup + timed) for k, v in by_site.items()}
                    result["kernel_launches"] = launches
                    kept = suite
            if trial == 0:
                assert_suites_equal(suite, reference, f"telemetry {mode}")
                gpu_res, cpu_res = suite.compute(), reference.compute()
                result.setdefault("values_bit_equal_to_cpu", {})[mode] = all(
                    torch.equal(gpu_res[k].cpu(), cpu_res[k]) for k in cpu_res)
    telemetry.set_telemetry(True)
    for mode, per_step in runs.items():
        result[f"{mode}_ms_per_step_runs"] = per_step
        result[f"{mode}_ms_per_step"] = median(per_step)
    result["armed_minus_disarmed_ms_per_step"] = result["armed_ms_per_step"] - result["disarmed_ms_per_step"]
    log(f"observability telemetry: armed {result['armed_ms_per_step']:.4f} ms/step, disarmed "
        f"{result['disarmed_ms_per_step']:.4f} ms/step (medians of {OBS_TRIALS}: {runs}); spans per step "
        f"{result['spans_per_step']}; {result['kernel_launches']} bincount launches for as many ConfusionMatrix "
        f"updates; values bit-equal to the CPU twin {result['values_bit_equal_to_cpu']}  [{card}]")
    return result, kept, reference, batches


def sync_pack_drill(mt, suite, card: str) -> dict:
    """The ``sync-pack`` fault drill in a NCCL world of one: the injected pack failures demote the suite
    and its members to the per-state protocol (two collectives a state) with the coalesced sync's
    states; clean syncs re-promote them, back to one payload collective."""
    import torch.distributed as dist

    from metrics_tpu_torch.ops import faults
    from metrics_tpu_torch.parallel import bucketing, collective_stats

    members = len(suite)
    steps = faults.recovery_steps()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    out = {"recovery_steps": steps}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0,
                                world_size=1)
        try:
            bucketing._MANIFEST_CACHE.clear()
            timed_sync(suite, "coalesced")  # the first sync of the layout checks it once
            suite.unsync()
            coalesced = []
            for _ in range(3):
                ms, counts = timed_sync(suite, "coalesced")
                assert (counts["sync_shape_collectives"], counts["sync_payload_collectives"]) == (0, 1), counts
                coalesced.append(ms)
                want = {k: v.clone() for k, v in suite_states(suite).items()}
                suite.unsync()
            n_states = len(want)
            with warnings.catch_warnings(record=True) as record:
                warnings.simplefilter("always")
                with faults.inject_faults("sync-pack", members + 1) as plan:
                    drill_ms, counts = timed_sync(suite, "coalesced")
            warned = sum("Coalesced" in str(w.message) for w in record)
            assert plan.fired == members + 1 and warned == members + 1, (plan.fired, warned)
            assert counts["sync_shape_collectives"] == counts["sync_payload_collectives"] == n_states, counts
            assert collective_stats()["sync_pack_fallbacks"] == members + 1
            for key, value in suite_states(suite).items():
                assert torch.equal(value, want[key]), f"sync-pack drill: {key} differs from the coalesced sync"
            suite.unsync()
            after = []
            for _ in range(OBS_DRILL_SYNCS):
                ms, counts = timed_sync(suite, "coalesced")
                suite.unsync()
                after.append({"ms": ms, "shape": counts["sync_shape_collectives"],
                              "payload": counts["sync_payload_collectives"]})
                if (counts["sync_shape_collectives"], counts["sync_payload_collectives"]) == (0, 1):
                    break
            assert after[-1]["payload"] == 1 and after[-1]["shape"] == 0, f"the suite did not re-promote: {after}"
            assert not suite.__dict__["_fault_ladders"]["sync-pack"].demoted
        finally:
            dist.destroy_process_group()
    demoted = [a["ms"] for a in after if a["shape"] == n_states]
    out.update(states=n_states, coalesced_ms_runs=coalesced, coalesced_ms=median(coalesced), drill_sync_ms=drill_ms,
               drill_collectives={"shape": n_states, "payload": n_states}, syncs_after_drill=after,
               demoted_per_state_ms=median(demoted) if demoted else None,
               syncs_to_repromote=len(after) - 1, warnings=warned)
    log(f"observability sync-pack drill ({n_states} states, {members} members, recovery_steps {steps}): coalesced "
        f"{out['coalesced_ms']:.3f} ms (1 payload); the drill's sync {drill_ms:.3f} ms ({n_states} shape + "
        f"{n_states} payload collectives, {warned} warnings); demoted per-state syncs {out['demoted_per_state_ms']} "
        f"ms; syncs after the drill {[(a['shape'], a['payload']) for a in after]}  [{card}]")
    return out


def journal_drills(suite, make_card, batch, path: str) -> dict:
    """``journal-write`` keeps the ring byte-identical; ``journal-load`` and a flipped byte in the newest
    generation each restore generation 1, with one demotion."""
    from metrics_tpu_torch.ops import faults, journal
    from metrics_tpu_torch.utils.exceptions import JournalFault

    suite.save_state(path)
    gen1 = make_card()
    gen1.load_state(path)
    suite.update(*batch)  # the newest generation differs from generation 1
    suite.save_state(path)
    ring = {p: open(p, "rb").read() for p in (path, path + ".g1")}
    with faults.inject_faults("journal-write") as plan:
        try:
            suite.save_state(path)
            raise AssertionError("journal-write: the injected save did not raise")
        except JournalFault:
            pass
    assert plan.fired == 1 and {p: open(p, "rb").read() for p in ring} == ring, "journal-write: the ring changed"
    assert not os.path.exists(path + ".tmp")
    out = {"journal_write_ring_identical": True}
    for drill in ("journal_load", "flipped_byte"):
        before = journal.journal_stats()["journal_load_demotions"]
        fresh = make_card()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if drill == "journal_load":
                with faults.inject_faults("journal-load"):
                    gen = fresh.load_state(path)
            else:
                data = bytearray(ring[path])
                data[len(data) // 2] ^= 0xFF
                with open(path, "wb") as fh:
                    fh.write(bytes(data))
                gen = fresh.load_state(path)
        demotions = journal.journal_stats()["journal_load_demotions"] - before
        assert gen == 1 and demotions == 1, f"{drill}: generation {gen}, {demotions} demotions"
        assert_states_bit_equal(fresh, gen1, f"{drill}: generation 1")
        out[drill] = {"generation": gen, "journal_load_demotions": demotions}
    return out


def observability_path(mt, checks, histogram, card: str) -> dict:
    """Phase 21: the telemetry's cost on the headline suite, the journal at real sizes, the fault drills and the
    exports. The suite's states equal the CPU twin's bit for bit; its float values within atol 1e-6 (phase 3's
    contract; ``values_bit_equal_to_cpu`` says whether they were bit-equal too)."""
    from metrics_tpu_torch.ops import telemetry

    t_phase = time.perf_counter()
    result, suite, reference, batches = telemetry_cost(mt, checks, histogram, card)
    num_classes = OBS_SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        journal_rows = {}
        journal_rows["headline"] = journal_tree(
            "headline", lambda: make_suite(mt, num_classes, OBS_DEVICE), lambda: make_suite(mt, num_classes, "cpu"),
            suite, os.path.join(tmp, "headline.journal"), cpu_run=reference)

        c = CURVES_IMAGENET_SHAPE[2]
        curves = curves_imagenet_suite(mt, OBS_DEVICE, c)
        for preds, target in curves_imagenet_batches():
            curves.update(preds, target)
        journal_rows["curves_imagenet"] = journal_tree(
            "curves_imagenet", lambda: curves_imagenet_suite(mt, OBS_DEVICE, c),
            lambda: curves_imagenet_suite(mt, "cpu", c), curves, os.path.join(tmp, "curves.journal"))
        del curves

        boot_batches = wrapper_batches()
        before, after = OBS_BOOT_STEPS
        make_boot = lambda device: wrapper_member(mt, "boot_poisson", device)  # noqa: E731
        boot = make_boot(OBS_DEVICE)
        for b in boot_batches[:before]:
            boot.update(*b)

        def more_updates(metric):
            for b in boot_batches[before:before + after]:
                metric.update(*b)

        journal_rows["bootstrap"] = journal_tree(
            "bootstrap", lambda: make_boot(OBS_DEVICE), lambda: make_boot("cpu"), boot,
            os.path.join(tmp, "boot.journal"), extra_steps=more_updates)
        result["journal"] = journal_rows
        for label, row in journal_rows.items():
            log(f"observability journal {label}: record {row['record_bytes']} bytes ({row['state_bytes']} of "
                f"states), save {row['save_ms']:.2f} ms, load {row['load_ms']:.2f} ms (CPU twin "
                f"{row['cpu_twin_load_ms']:.2f} ms), copies save {row['save_copies']} load {row['load_copies']}, "
                f"bit-exact  [{card}]")

        result["sync_pack_drill"] = sync_pack_drill(mt, suite, card)
        result["journal_drills"] = journal_drills(suite, lambda: make_suite(mt, num_classes, OBS_DEVICE),
                                                  batches[0], os.path.join(tmp, "drill.journal"))
        log(f"observability journal drills: {json.dumps(result['journal_drills'])}  [{card}]")

        prom_ms, text = host_ms(telemetry.prometheus_text)
        trace_path = os.path.join(tmp, "trace.json")
        trace_ms, events = host_ms(lambda: telemetry.export_trace(trace_path))
        result["exports"] = {"prometheus_ms": prom_ms, "prometheus_bytes": len(text.encode()),
                             "export_trace_ms": trace_ms, "trace_bytes": os.path.getsize(trace_path),
                             "trace_events": events, "spans_retained": telemetry.telemetry_stats()["spans_retained"]}
        assert text.startswith("# TYPE metrics_tpu_") and events > 0
        json.loads(open(trace_path).read())
    log(f"observability exports: {json.dumps(result['exports'])}  [{card}]")
    result["phase_s"] = time.perf_counter() - t_phase
    assert result["phase_s"] < 60.0, f"phase 21 took {result['phase_s']:.1f} s"
    return result


# ------------------------------------------------------------------ phase 22
PLANES_DEVICE = "cuda"  # where phase 22 runs
PLANES_SHAPE = (8192, 128, 5)  # phase 3's headline suite: rows a batch, classes, updates before each drill
PLANES_DEADLINE_MS = 200  # the deadline drill's deadline; its slowed seam sleeps PLANES_SLOW_S
PLANES_SLOW_S = 0.5
PLANES_QUANT_ATOL = 2e-2  # float values under a quantized tier (tests/parallel/test_async_sync.py:498)
PLANES_QUANT_RTOL = 2**-8  # and of a value above 1 (MAPE's near 2.6e5), bfloat16's 8 bits of mantissa, rounded once
PLANES_QUANT_SHAPE = (4, 65_536)  # phase 12's suites: updates, rows an update
PLANES_ENCODE_N = 2**24  # floats of the timed int8 and bf16 encodes (a 64 MiB float32 state)
PLANES_RANK_BATCH = 2048  # rows of each batch of the spawned worlds; rank r takes 2 + r batches
PLANES_GLOO_TIMEOUT_S = 30  # init_process_group(timeout=): a peer gone for good raises instead of hanging
PLANES_QUORUM_ENV = {"METRICS_TPU_SYNC_DEGRADED": "quorum", "METRICS_TPU_SYNC_DEADLINE_MS": "2000",
                     "METRICS_TPU_SYNC_RETRIES": "1", "METRICS_TPU_SYNC_DEAD_AFTER": "2",
                     "METRICS_TPU_SYNC_BACKOFF_MS": "0"}
PLANES_WORLD_S = 120  # wall-clock limit of each spawned world
PLANES_PHASE_S = 90.0
PLANES_ENV = ("METRICS_TPU_SYNC_RETRIES", "METRICS_TPU_SYNC_BACKOFF_MS", "METRICS_TPU_SYNC_DEADLINE_MS",
              "METRICS_TPU_SYNC_DEGRADED", "METRICS_TPU_SYNC_QUANT", "METRICS_TPU_SYNC_HIER")


def states_bit_equal(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), f"{label}: states {sorted(got)}"
    for key, value in want.items():
        g = got[key]
        assert g.dtype == value.dtype and g.shape == value.shape and torch.equal(g, value), f"{label}: {key} differs"


def clone_states(suite) -> dict:
    return {k: v.clone() for k, v in suite_states(suite).items()}


def planes_world_of_one(mt, histogram, card: str) -> dict:
    """Phase 22 (a): the headline suite in a NCCL world of one: the sync-gather retry drill, the deadline drill,
    the local degraded tier and its re-promotion, the asynchronous lane with updates in flight, then the
    quantized tiers on phase 12's suites and the encodes' times beside their byte bounds."""
    import torch.distributed as dist

    import metrics_tpu_torch.metric as metric_mod
    from metrics_tpu_torch.ops import faults, telemetry
    from metrics_tpu_torch.parallel import bucketing, collective_stats, reset_collective_stats
    from metrics_tpu_torch.parallel import sync as psync
    from metrics_tpu_torch.utils.exceptions import SyncTimeoutFault

    batch, num_classes, steps = PLANES_SHAPE
    batches = make_batches(batch, num_classes, 2 * steps, seed=220, signal=2.0, device=PLANES_DEVICE)
    sync_on = lambda: True  # noqa: E731 - a world of one syncs all the same (its gather is the identity)
    out: dict = {"card": card}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0,
                                world_size=1)
        try:
            histogram.KERNEL_LAUNCHES = 0
            suite, twin = make_suite(mt, num_classes, PLANES_DEVICE), make_suite(mt, num_classes, PLANES_DEVICE)
            for preds, target in batches[:steps]:
                suite.update(preds, target)
                twin.update(preds, target)
            local_values = suite.compute()  # a world of one: no sync
            bucketing._MANIFEST_CACHE.clear()
            timed_sync(suite, "coalesced")  # the layout's first sync
            suite.unsync()
            blocking = []
            for _ in range(3):
                ms, counts = timed_sync(suite, "coalesced")
                blocking.append(ms)
                want = clone_states(suite)
                suite.unsync()
            local = suite_states(suite)
            out["blocking_sync_ms"] = median(blocking)

            # the sync-gather retry drill
            os.environ.update({"METRICS_TPU_SYNC_RETRIES": "3", "METRICS_TPU_SYNC_BACKOFF_MS": "0"})
            with faults.inject_faults("sync-gather", 2) as plan:
                ms, counts = timed_sync(suite, "coalesced")
            assert plan.fired == 2, plan.fired
            states_bit_equal(suite_states(suite), want, "sync-gather retry drill")
            suite.unsync()
            out["retry_drill"] = {"injected": 2, "retries": 3, "sync_ms": ms, "collectives": counts}

            # the deadline drill: the payload seam slowed past the deadline (it never reaches NCCL)
            os.environ.update({"METRICS_TPU_SYNC_RETRIES": "0", "METRICS_TPU_SYNC_DEADLINE_MS": str(PLANES_DEADLINE_MS)})
            real_payload = bucketing._payload_allgather

            def slowed(packed, group):
                time.sleep(PLANES_SLOW_S)
                raise RuntimeError("the slowed transport, abandoned by the watchdog")

            timeouts = collective_stats()["sync_deadline_timeouts"]
            bucketing._payload_allgather = slowed
            try:
                t0 = time.perf_counter()
                try:
                    suite.sync(distributed_available=sync_on)
                    raise AssertionError("deadline drill: the slowed sync did not time out")
                except SyncTimeoutFault:
                    timeout_ms = (time.perf_counter() - t0) * 1e3
            finally:
                bucketing._payload_allgather = real_payload
            assert collective_stats()["sync_deadline_timeouts"] == timeouts + 1
            assert not any(m._is_synced for m in suite.values(copy_state=False))
            assert all(suite_states(suite)[k] is v for k, v in local.items()), "deadline drill: states moved"
            ms, counts = timed_sync(suite, "coalesced")  # the next sync is clean, the deadline still armed
            states_bit_equal(suite_states(suite), want, "after the deadline drill")
            suite.unsync()
            out["deadline_drill"] = {"deadline_ms": PLANES_DEADLINE_MS, "raised_after_ms": timeout_ms,
                                     "next_sync_ms": ms}

            # the local degraded tier: compute() serves the local value, then re-promotes
            os.environ["METRICS_TPU_SYNC_DEGRADED"] = "local"
            metric_mod._dist_available = sync_on
            try:
                bucketing._payload_allgather = slowed
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        served = fresh_compute(suite)
                finally:
                    bucketing._payload_allgather = real_payload
                health = suite.sync_health()
                assert health["degraded"] and health["degraded_serves"] == 1, health
                for key, value in local_values.items():
                    assert torch.equal(served[key], value), f"degraded serve: {key}"
                serves = []
                for _ in range(faults.recovery_steps() + 1):
                    reset_collective_stats()
                    fresh_compute(suite)
                    serves.append(collective_stats()["sync_payload_collectives"])
                    if serves[-1]:
                        break
                health_after = suite.sync_health()
                assert serves[-1] == 1 and len(serves) == faults.recovery_steps(), serves
                assert not health_after["degraded"] and health_after["last_good_sync_step"] is not None
            finally:
                metric_mod._dist_available = psync.distributed_available
                os.environ.pop("METRICS_TPU_SYNC_DEGRADED")
            out["degraded_local"] = {"served_local": True, "serves_before_promotion": len(serves) - 1,
                                     "recovery_steps": faults.recovery_steps(),
                                     "health": {k: health[k] for k in ("degraded", "degraded_tier",
                                                                       "degraded_serves")}}

            # the asynchronous lane: dispatch, 5 updates in flight, force
            armed = telemetry.armed
            telemetry.set_telemetry(True)
            telemetry.clear_spans()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fut = suite.sync_async(distributed_available=sync_on)
                dispatch_ms = (time.perf_counter() - t0) * 1e3
                for preds, target in batches[steps:]:
                    suite.update(preds, target)
                t0 = time.perf_counter()
                fut.wait()
                torch.cuda.synchronize()
                force_ms = (time.perf_counter() - t0) * 1e3
                rows = telemetry.spans()
            finally:
                telemetry.set_telemetry(armed)
            states_bit_equal(suite_states(suite), want, "async: the forced states")
            suite.unsync()
            for preds, target in batches[steps:]:
                twin.update(preds, target)
            states_bit_equal(suite_states(suite), suite_states(twin), "async: the updates in flight after unsync")
            wire = sum(r["dur"] for r in rows if r["site"] == "sync-payload-gather" and (r["attrs"] or {}).get("overlapped"))
            waited = sum((r["attrs"] or {}).get("waited_s", 0.0) for r in rows if r["site"] == "sync-force")
            out["async"] = {"dispatch_ms": dispatch_ms, "force_ms": force_ms, "async_ms": dispatch_ms + force_ms,
                            "blocking_ms": out["blocking_sync_ms"], "wire_ms": wire * 1e3, "waited_ms": waited * 1e3,
                            "hidden_share": max(0.0, 1.0 - waited / wire) if wire else None,
                            "updates_in_flight": len(batches) - steps}
            settle(suite, twin)
            out["kernel_launches"] = histogram.KERNEL_LAUNCHES
            # both suites: one launch a compute group an update, one a member on the first
            expected = 2 * (3 * len(batches) + 1)
            assert out["kernel_launches"] == expected, (out["kernel_launches"], expected)

            out["quant"] = planes_quant(mt, sync_on)
        finally:
            for name in PLANES_ENV:
                os.environ.pop(name, None)
            dist.destroy_process_group()
    a = out["async"]
    log(f"sync planes (NCCL, world of one, headline C={num_classes} B={batch}): blocking sync "
        f"{out['blocking_sync_ms']:.4f} ms; retry drill 2 injected faults absorbed, bit-exact; deadline drill raised "
        f"after {out['deadline_drill']['raised_after_ms']:.1f} ms, next sync clean; local tier served, re-promoted "
        f"after {out['degraded_local']['serves_before_promotion']} serves; async dispatch {a['dispatch_ms']:.4f} + force "
        f"{a['force_ms']:.4f} ms, wire {a['wire_ms']:.4f} ms, hidden share {a['hidden_share']}  [{card}]")
    return out


def planes_quant(mt, sync_on) -> dict:
    """The bf16 and int8 tiers on phase 12's regression and multi-output suites: bytes shipped against the
    exact lane, integer states exact, float values within ``PLANES_QUANT_ATOL``; then the encodes timed."""
    from metrics_tpu_torch.parallel import bucketing, collective_stats, reset_collective_stats

    suites = {"regression": (regression_suite, regression_batches(seed=222, shape=PLANES_QUANT_SHAPE)),
              "multioutput": (multioutput_suite,
                              regression_batches(seed=223, shape=PLANES_QUANT_SHAPE + (MULTIOUTPUT_SHAPE[2],)))}
    out: dict = {}
    for label, (make, rows) in suites.items():
        runs = {}
        for tier in (None, "bf16", "int8"):
            if tier is None:
                os.environ.pop("METRICS_TPU_SYNC_QUANT", None)
            else:
                os.environ["METRICS_TPU_SYNC_QUANT"] = tier
            suite = make(mt, PLANES_DEVICE)
            for preds, target in rows:
                suite.update(preds, target)
            reset_collective_stats()
            suite.sync(distributed_available=sync_on)
            stats = collective_stats()
            runs[tier] = (clone_states(suite), {k: v.clone() for k, v in suite.compute().items()}, stats)
            suite.unsync()
        os.environ.pop("METRICS_TPU_SYNC_QUANT", None)
        exact_states, exact_values, exact_stats = runs[None]
        out[label] = {"exact_bytes": exact_stats["sync_bytes_gathered"]}
        for tier in ("bf16", "int8"):
            states, values, stats = runs[tier]
            worst_state = 0.0
            for key, value in exact_states.items():
                got = states[key]
                if value.is_floating_point():
                    worst_state = max(worst_state, float((got.double() - value.double()).abs().max()))
                else:
                    assert torch.equal(got, value), f"quant {tier} {label}: integer state {key} not exact"
            worst = worst_rel = 0.0
            for key, value in exact_values.items():
                torch.testing.assert_close(values[key], value, atol=PLANES_QUANT_ATOL, rtol=PLANES_QUANT_RTOL,
                                           msg=f"quant {tier} {label}: {key}")
                err = (values[key].double() - value.double()).abs()
                worst = max(worst, float(err.max()))
                worst_rel = max(worst_rel, float((err / value.double().abs().clamp(min=1.0)).max()))
            out[label][tier] = {"bytes": stats["sync_bytes_gathered"], "lossy_states": stats["sync_quant_lossy_states"],
                                "exact_states": stats["sync_quant_exact_states"],
                                "bytes_saved_logical": stats["sync_quant_bytes_saved"],
                                "max_abs_value_err": worst, "max_rel_value_err": worst_rel,
                                "max_abs_state_err": worst_state}
    x = torch.randn(PLANES_ENCODE_N, device=PLANES_DEVICE, generator=torch.Generator(device=PLANES_DEVICE).manual_seed(224))
    encodes = {}
    for tier, wire in (("int8", PLANES_ENCODE_N + 4), ("bf16", 2 * PLANES_ENCODE_N)):
        moved = 4 * PLANES_ENCODE_N + wire  # the state read once, its wire form written once
        encodes[tier] = {"n": PLANES_ENCODE_N, "ms": cuda_time_ms(lambda: bucketing._quant_bytes(x, tier), 50, 5),
                         "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": moved}
    out["encode"] = encodes
    log(f"sync planes quant: {json.dumps(out)}")
    return out


def planes_rank_batches(rank: int, device: str) -> list:
    """Rank ``rank``'s uneven share of the spawned worlds' batches: 2 + rank batches of ``PLANES_RANK_BATCH``."""
    return make_batches(PLANES_RANK_BATCH, PLANES_SHAPE[1], 2 + rank, seed=230 + rank, signal=2.0, device=device)


def _planes_init(rank: int, world: int, init_method: str, device: str):
    import datetime

    import torch.distributed as dist

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PLANES_GLOO_TIMEOUT_S))
    return dist


def planes_quorum_rank(rank: int, world: int, init_method: str, out_dir: str, device: str) -> None:
    """One rank of phase 22 (b). Every rank journals at the barrier; the last rank then stops: its heartbeat
    file goes, and it parks without closing its sockets (a hung host, which a collective waits for) until the
    survivors are done. The survivors' compute() times out, the prober reads the heartbeats and declares the
    rank dead, and the quorum tier serves the merge over the survivors; they then take the rank back."""
    import traceback

    result: dict = {}
    code = 0
    alive = lambda r: os.path.join(out_dir, f"alive{r}")  # noqa: E731
    try:
        _planes_init(rank, world, init_method, device)
        import metrics_tpu_torch as mt
        from metrics_tpu_torch.parallel import sync as psync

        open(alive(rank), "w").close()
        suite = make_suite(mt, PLANES_SHAPE[1], device)
        for preds, target in planes_rank_batches(rank, device):
            suite.update(preds, target)
        result["barrier"] = suite.checkpoint_barrier(os.path.join(out_dir, f"rank{rank}.journal"))
        if rank == world - 1:
            torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
            os.remove(alive(rank))
            while not os.path.exists(os.path.join(out_dir, "survivors-done")):
                time.sleep(0.01)
            os._exit(0)
        while os.path.exists(alive(world - 1)):
            time.sleep(0.01)
        os.environ.update(PLANES_QUORUM_ENV)
        psync.set_expected_world(world)
        psync.set_peer_prober(lambda: [r for r in range(world) if not os.path.exists(alive(r))])
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            values = suite.compute()
        result["compute_s"] = time.perf_counter() - t0
        result["values"] = {k: v.cpu() for k, v in values.items()}
        health = suite.sync_health()
        result["health"] = {k: health[k] for k in ("degraded", "degraded_tier", "quorum_serves", "degraded_serves",
                                                   "epoch")}
        result["world"] = {k: health["world"][k] for k in ("dead_ranks", "surviving_ranks", "epoch", "transitions")}
        result["epoch_after_rejoin"] = psync.rejoin_rank(world - 1)  # the coordinator's watch: the rank is back
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        result["error"] = traceback.format_exc()
        code = 1
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        # no destroy_process_group: the parked peer's collectives are still pending in the default group
        os._exit(code)


def planes_rejoin_rank(out_dir: str, world: int, device: str) -> None:
    """Phase 22 (b)'s fresh process for the stopped rank: restore its barrier record and rejoin."""
    import traceback

    result: dict = {}
    code = 0
    try:
        if str(HERE) not in sys.path:
            sys.path.insert(0, str(HERE))
        import metrics_tpu_torch as mt
        from metrics_tpu_torch.parallel import sync as psync

        psync.set_expected_world(world)
        psync.mark_peer_dead(world - 1, reason="restarted")  # how the world last saw this rank
        suite = make_suite(mt, PLANES_SHAPE[1], device)
        result["rejoin"] = suite.rejoin(os.path.join(out_dir, f"rank{world - 1}.journal"), rank=world - 1)
        result["values"] = {k: v.cpu() for k, v in suite.compute().items()}
        result["states"] = {k: v.cpu() for k, v in suite_states(suite).items()}
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
        code = 1
    finally:
        torch.save(result, os.path.join(out_dir, "rejoin.pt"))
        os._exit(code)


def run_planes_world(target, world: int, out_dir: str, device: str, extra=()) -> list:
    """Spawn ``world`` processes of ``target`` in one Gloo world; kill them at ``PLANES_WORLD_S`` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    init_method = f"file://{os.path.join(out_dir, 'rendezvous')}"
    procs = [ctx.Process(target=target, args=(rank, world, init_method, out_dir, device) + tuple(extra))
             for rank in range(world)]
    return _join_planes(procs, out_dir, [f"{rank}.pt" for rank in range(world)])


def _join_planes(procs, out_dir: str, files: list, done_file: str = "", wait_for=()) -> list:
    for p in procs:
        p.start()
    deadline = time.monotonic() + PLANES_WORLD_S
    for p in wait_for or procs:
        p.join(max(0.0, deadline - time.monotonic()))
    if done_file:
        open(os.path.join(out_dir, done_file), "w").close()
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    for p in procs:
        p.join(30)
    results = [torch.load(os.path.join(out_dir, f)) if os.path.exists(os.path.join(out_dir, f)) else {} for f in files]
    errors = [r["error"] for r in results if "error" in r]
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"phase 22 world: exit codes {[p.exitcode for p in procs]}, {len(hung)} killed at "
                           f"{PLANES_WORLD_S} s\n" + "\n".join(errors))
    return results


def planes_quorum(mt, card: str, device: str = PLANES_DEVICE) -> dict:
    """Phase 22 (b): three spawned ranks over Gloo, CUDA tensors on the one card, uneven batches."""
    import multiprocessing as mp

    from metrics_tpu_torch.ops import journal

    world = 3
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=planes_quorum_rank, args=(rank, world, init_method, tmp, device))
                 for rank in range(world)]
        t0 = time.perf_counter()
        results = _join_planes(procs, tmp, [f"{rank}.pt" for rank in range(world)], done_file="survivors-done",
                               wait_for=procs[:-1])
        world_s = time.perf_counter() - t0
        manifests = [journal.read_record(os.path.join(tmp, f"rank{r}.journal"))[0] for r in range(world)]
        stamps = {(m["epoch"], m["barrier_step"], m["world_size"]) for m in manifests}
        assert len(stamps) == 1 and all(m["barrier"] is True for m in manifests), stamps
        assert all(r["barrier"]["barrier_step"] == manifests[0]["barrier_step"] for r in results)
        proc = ctx.Process(target=planes_rejoin_rank, args=(tmp, world, device))
        rejoined = _join_planes([proc], tmp, ["rejoin.pt"])[0]
    batches = [[(p.cpu(), t.cpu()) for p, t in planes_rank_batches(r, device)] for r in range(world)]

    def cpu_suite(ranks):
        s = make_suite(mt, PLANES_SHAPE[1], "cpu")
        for r in ranks:
            for preds, target in batches[r]:
                s.update(preds, target)
        return s

    want = cpu_suite([0, 1]).compute()
    for rank, result in enumerate(results[:-1]):
        assert result["health"]["degraded"] and result["health"]["quorum_serves"] == 1, result["health"]
        assert result["world"]["dead_ranks"] == [world - 1] and result["world"]["surviving_ranks"] == [0, 1]
        for key, value in want.items():
            got = result["values"][key]
            if value.is_floating_point():
                torch.testing.assert_close(got, value, atol=1e-6, rtol=1e-5, msg=f"quorum rank {rank}: {key}")
            else:
                assert got.dtype == value.dtype and torch.equal(got, value), f"quorum rank {rank}: {key}"
    alone = cpu_suite([world - 1])
    states_bit_equal(rejoined["states"], {k: v.cpu() for k, v in suite_states(alone).items()}, "rejoined rank")
    assert rejoined["rejoin"]["generation"] == 0 and rejoined["rejoin"]["epoch"] == results[0]["epoch_after_rejoin"]
    out = {"world": world, "world_s": world_s, "barrier": {"epoch": manifests[0]["epoch"],
                                                          "barrier_step": manifests[0]["barrier_step"]},
           "quorum_compute_s": [r["compute_s"] for r in results[:-1]],
           "epoch_after_death": results[0]["world"]["epoch"], "epoch_after_rejoin": results[0]["epoch_after_rejoin"],
           "rejoin": rejoined["rejoin"], "card": card}
    log(f"sync planes quorum (Gloo, {world} ranks on one card): barrier (epoch, step) "
        f"{tuple(out['barrier'].values())} on every rank; rank {world - 1} stopped; quorum compute() "
        f"{[round(s, 3) for s in out['quorum_compute_s']]} s equal to the CPU fed ranks 0 and 1; the fresh rank "
        f"rejoined at epoch {out['epoch_after_rejoin']}  [{card}]")
    return out


def planes_hier_rank(rank: int, world: int, init_method: str, out_dir: str, device: str) -> None:
    """One rank of phase 22 (c): the headline suite synced flat, then on the hierarchical psum lane with the
    seams bound to the node's subgroup (two ranks a node) and a group of the node leaders."""
    import traceback

    result: dict = {}
    code = 0
    try:
        dist = _planes_init(rank, world, init_method, device)
        import metrics_tpu_torch as mt
        from metrics_tpu_torch.parallel import bucketing, collective_stats, reset_collective_stats

        node_group, _ = dist.new_subgroups(group_size=2)
        leaders = dist.new_group(list(range(0, world, 2)))
        leader = rank - rank % 2

        def intranode(packed):
            rows = torch.empty((2,) + tuple(packed.shape), dtype=packed.dtype, device=packed.device)
            dist.all_gather(list(rows.unbind(0)), packed.contiguous(), group=node_group)
            return rows

        def internode(block):
            rows = torch.empty((world // 2,) + tuple(block.shape), dtype=block.dtype, device=block.device)
            if rank == leader:
                dist.all_gather(list(rows.unbind(0)), block.contiguous(), group=leaders)
            dist.broadcast(rows, src=leader, group=node_group)
            return rows

        suite = make_suite(mt, PLANES_SHAPE[1], device)
        for preds, target in planes_rank_batches(rank, device):
            suite.update(preds, target)
        suite.sync()  # the layout's first sync checks it once
        suite.unsync()
        for lane in ("flat", "hier"):
            if lane == "hier":
                bucketing._intranode_allgather, bucketing._internode_allgather = intranode, internode
                os.environ["METRICS_TPU_SYNC_HIER"] = "2"
            reset_collective_stats()
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            suite.sync()
            if device == "cuda":
                torch.cuda.synchronize()
            result[f"{lane}_ms"] = (time.perf_counter() - t0) * 1e3
            result[lane] = {k: v.cpu() for k, v in suite_states(suite).items()}
            stats = collective_stats()
            result[f"{lane}_stats"] = {k: stats[k] for k in ("sync_bytes_gathered", "sync_payload_collectives",
                                                             "sync_hier_intranode_collectives",
                                                             "sync_hier_internode_collectives",
                                                             "sync_hier_node_reduces")}
            suite.unsync()
        dist.barrier()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
        code = 1
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        os._exit(code)


def planes_hier(card: str, device: str = PLANES_DEVICE) -> dict:
    """Phase 22 (c): four spawned Gloo ranks, two a node: the psum lane bit-exact against the flat gather,
    with half its inter-node bytes."""
    world = 4
    with tempfile.TemporaryDirectory() as tmp:
        results = run_planes_world(planes_hier_rank, world, tmp, device)
    for rank, r in enumerate(results):
        states_bit_equal(r["hier"], r["flat"], f"hierarchical lane, rank {rank}")
        assert r["hier_stats"]["sync_hier_node_reduces"] == 1, r["hier_stats"]
        assert 2 * r["hier_stats"]["sync_bytes_gathered"] == r["flat_stats"]["sync_bytes_gathered"], r
    out = {"world": world, "node_size": 2, "flat_ms": [r["flat_ms"] for r in results],
           "hier_ms": [r["hier_ms"] for r in results], "flat_bytes": results[0]["flat_stats"]["sync_bytes_gathered"],
           "internode_bytes": results[0]["hier_stats"]["sync_bytes_gathered"], "card": card}
    log(f"sync planes hierarchical (Gloo, 4 ranks, 2 a node): psum lane bit-exact against the flat gather; "
        f"inter-node bytes {out['internode_bytes']} against {out['flat_bytes']}; sync ms flat {out['flat_ms']}, "
        f"hierarchical {out['hier_ms']}  [{card}]")
    return out


def planes_compute_on_cpu(mt, card: str) -> dict:
    """Phase 22 (d): phase 9's 2**24 binary scores through AUROC and AveragePrecision, with and without
    ``compute_on_cpu``: peak device memory of the updates and of compute(), ms an update, the values."""
    steps, batch = CURVES_BINARY_SHAPE
    runs = {}
    for offload in (False, True):
        suite = mt.MetricCollection({
            "auroc": mt.AUROC(pos_label=1, compute_on_cpu=offload, device=PLANES_DEVICE),
            "ap": mt.AveragePrecision(pos_label=1, compute_on_cpu=offload, device=PLANES_DEVICE),
        })
        g = torch.Generator(device=PLANES_DEVICE).manual_seed(20)  # phase 9's scores, made an update at a time
        gc.collect()  # a metric's wrapped methods hold it in a cycle: the last run's rows go only now
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        update_s = 0.0
        for _ in range(steps):
            target = (torch.rand(batch, generator=g, device=PLANES_DEVICE) < 0.03).to(torch.int64)
            logits = torch.randn(batch, generator=g, device=PLANES_DEVICE) + 2.0 * target - 1.5
            preds = torch.round(torch.sigmoid(logits) * 4096) / 4096
            del logits
            settle(suite)
            t0 = time.perf_counter()
            suite.update(preds, target)
            settle(suite)
            update_s += time.perf_counter() - t0
            del preds, target
        peak_updates = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = suite.compute()
        torch.cuda.synchronize()
        runs[offload] = {"update_ms": update_s / steps * 1e3, "peak_update_bytes": peak_updates,
                         "held_bytes": held, "compute_ms": (time.perf_counter() - t0) * 1e3,
                         "peak_compute_bytes": torch.cuda.max_memory_allocated() - base,
                         "values": {k: float(v) for k, v in values.items()}}
        if offload:
            assert all(r.device.type == "cpu" for _, m in suite.items(keep_base=True, copy_state=False)
                       for r in m.preds + m.target), "compute_on_cpu: rows not on the host after compute()"
        del suite, values
    assert runs[True]["values"] == runs[False]["values"], runs
    out = {"on_card": runs[False], "compute_on_cpu": runs[True], "card": card}
    log(f"sync planes compute_on_cpu (2**24 binary scores, AUROC + AP): {json.dumps(out)}")
    return out


def sync_planes_path(mt, checks, histogram, card: str) -> dict:
    """Phase 22: the sync planes beyond the core, parts (a) to (d); under PLANES_PHASE_S seconds."""
    t_phase = time.perf_counter()
    result = {"world_of_one": planes_world_of_one(mt, histogram, card)}
    result["kernel_launches"] = result["world_of_one"]["kernel_launches"]
    result["quorum"] = planes_quorum(mt, card)
    result["hierarchical"] = planes_hier(card)
    result["compute_on_cpu"] = planes_compute_on_cpu(mt, card)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"sync planes: phase 22 took {result['phase_s']:.1f} s  [{card}]")
    assert result["phase_s"] < PLANES_PHASE_S, f"phase 22 took {result['phase_s']:.1f} s"
    return result


# ---- phase 23: engine
ENGINE_DEVICE = "cuda"  # where phase 23 runs
ENGINE_SHAPE = (8192, 128, 5, 128)  # the headline suite (phase 3's): rows a batch, classes, warm-up and timed updates
ENGINE_FORWARDS = 32  # (b) forwards under deferral
ENGINE_READS_STEPS = 16  # the updates of each way whose host reads are counted
ENGINE_LANE_UPDATES = 16  # (d) updates of the curve and retrieval lanes (the first one validated)
ENGINE_PHASE_S = 60.0


def engine_counts(engine) -> dict:
    stats = engine.engine_stats()
    return {k: stats[k] for k in ("builds", "hits", "deferred_steps", "deferred_flushes", "deferred_fallbacks",
                                  "device_probes")}


def counts_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def host_read_count(fn) -> int:
    """Host reads (``item``, ``nonzero``) of one call of ``fn``, from a CPU-only profiler session."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    counts = {e.key: e.count for e in prof.key_averages()}
    return counts.get("aten::_local_scalar_dense", 0) + counts.get("aten::nonzero", 0)


def suite_state_tensors(suite) -> dict:
    return {(name, state): value for name, m in suite.items(keep_base=True, copy_state=False)
            for state, value in m.metric_state.items()}


def assert_suite_states_bit_equal(got, want, label: str) -> None:
    a, b = suite_state_tensors(got), suite_state_tensors(want)
    assert a.keys() == b.keys(), f"{label}: states {sorted(a)} against {sorted(b)}"
    for key, value in b.items():
        mine = a[key]
        if isinstance(value, list):
            assert len(mine) == len(value) and all(
                x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(mine, value)), f"{label}: {key}"
        else:
            assert mine.dtype == value.dtype and torch.equal(mine.cpu(), value.cpu()), f"{label}: {key} differs"


def engine_ways(mt, engine, histogram, batches, card: str) -> dict:
    """(a) The headline suite three ways in mode "first": per call (deferral off), deferred (compute()
    inside the timed window), one update_many over the timed steps stacked. Each way ends at 5 + 2 x 128
    updates (per call and deferred repeat the timed steps untimed; update_many's first chunk of a
    signature runs call by call, validated), and the three must be bit-equal."""
    batch, num_classes, warmup, timed = ENGINE_SHAPE
    out: dict = {}
    suites = {}
    stacked = (torch.stack([p for p, _ in batches[warmup:]]), torch.stack([t for _, t in batches[warmup:]]))
    for way in ("per_call", "deferred", "update_many"):
        engine.set_deferred_dispatch(way != "per_call")
        try:
            suite = make_suite(mt, num_classes, ENGINE_DEVICE)
            for preds, target in batches[:warmup]:
                suite.update(preds, target)
            if way == "update_many":
                suite.update_many(*stacked)  # the chunk signature's first sight: call by call
            settle(suite)
            histogram.KERNEL_LAUNCHES = 0
            before = engine_counts(engine)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if way == "update_many":
                suite.update_many(*stacked)
            else:
                for preds, target in batches[warmup:]:
                    suite.update(preds, target)
            values = suite.compute()
            settle(suite)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            launches = histogram.KERNEL_LAUNCHES
            counts = counts_delta(engine_counts(engine), before)
            # one a compute group an update: acc; f1 with precision; confmat
            assert launches == 3 * timed, f"engine {way}: {launches} bincount launches for {timed} updates"
            if way != "update_many":  # the second pass, untimed
                for preds, target in batches[warmup:]:
                    suite.update(preds, target)
                settle(suite)
            # host reads of ENGINE_READS_STEPS updates (a flush of as many entries, a chunk of as many steps)
            spare = make_suite(mt, num_classes, ENGINE_DEVICE)
            for preds, target in batches[:warmup]:
                spare.update(preds, target)
            few = batches[warmup:warmup + ENGINE_READS_STEPS]
            if way == "update_many":
                chunk = (torch.stack([p for p, _ in few]), torch.stack([t for _, t in few]))
                spare.update_many(*chunk)
                reads = host_read_count(lambda: (spare.update_many(*chunk), settle(spare)))
            else:
                settle(spare)
                reads = host_read_count(lambda: ([spare.update(p, t) for p, t in few], settle(spare)))
            del spare
            suites[way] = suite
            out[way] = {"ms_per_step": seconds / timed * 1e3, "kernel_launches": launches, "engine": counts,
                        "peak_extra_bytes": peak, "host_reads_per_16_updates": reads,
                        "values": {k: v.cpu().tolist() if v.numel() == 1 else None for k, v in values.items()}}
            log(f"engine (a) {way}: {seconds / timed * 1e3:.4f} ms/step over {timed} updates (compute() included), "
                f"{launches} launches, engine {counts}, peak extra {peak} bytes, host reads of "
                f"{ENGINE_READS_STEPS} updates {reads}  [{card}]")
        finally:
            engine.set_deferred_dispatch(True)
    assert out["deferred"]["engine"]["deferred_steps"] == timed, out["deferred"]["engine"]
    assert out["deferred"]["engine"]["deferred_flushes"] >= 1, out["deferred"]["engine"]
    assert out["per_call"]["engine"]["deferred_steps"] == 0, out["per_call"]["engine"]
    assert out["deferred"]["host_reads_per_16_updates"] <= out["per_call"]["host_reads_per_16_updates"], out
    assert out["update_many"]["host_reads_per_16_updates"] <= out["per_call"]["host_reads_per_16_updates"], out
    assert_suite_states_bit_equal(suites["deferred"], suites["per_call"], "engine: deferred against per call")
    assert_suite_states_bit_equal(suites["update_many"], suites["per_call"], "engine: update_many against per call")
    # the CPU twin over the first steps that fit CPU_TWIN_S, against a card suite fed the same (deferred)
    cpu = make_suite(mt, num_classes, "cpu")
    t0 = time.perf_counter()
    cpu.update(batches[0][0].cpu(), batches[0][1].cpu())
    depth = cpu_twin_steps(time.perf_counter() - t0, len(batches))
    card_twin = make_suite(mt, num_classes, ENGINE_DEVICE)
    card_twin.update(*batches[0])
    for preds, target in batches[1:depth]:
        cpu.update(preds.cpu(), target.cpu())
        card_twin.update(preds, target)
    assert_suite_states_bit_equal(card_twin, cpu, "engine: the card (deferred) against the CPU twin")
    out["cpu_twin_steps"] = depth
    del suites, stacked, card_twin, cpu
    return out


def engine_forwards(mt, engine, histogram, batches, card: str) -> dict:
    """(b) ENGINE_FORWARDS forwards of the headline suite under deferral, their lazy values read after,
    each bit-equal to the per-call forward's."""
    num_classes = ENGINE_SHAPE[1]
    use = batches[:ENGINE_FORWARDS]
    engine.set_deferred_dispatch(False)
    try:
        ref = make_suite(mt, num_classes, ENGINE_DEVICE)
        want = [ref(p, t) for p, t in use]
    finally:
        engine.set_deferred_dispatch(True)
    suite = make_suite(mt, num_classes, ENGINE_DEVICE)
    before = engine_counts(engine)
    histogram.KERNEL_LAUNCHES = 0
    settle(suite)
    t0 = time.perf_counter()
    got = [suite(p, t) for p, t in use]
    enqueue_s = time.perf_counter() - t0
    lazy = sum(isinstance(v, engine.LazyValue) for row in got for v in row.values())
    resolved = [{k: v._force() if isinstance(v, engine.LazyValue) else v for k, v in row.items()} for row in got]
    settle(suite)
    counts = counts_delta(engine_counts(engine), before)
    launches = histogram.KERNEL_LAUNCHES
    for i, (g, w) in enumerate(zip(resolved, want)):
        assert g.keys() == w.keys(), (g.keys(), w.keys())
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), f"engine (b): forward {i} {k} differs"
    assert_suite_states_bit_equal(suite, ref, "engine (b): states after the forwards")
    assert lazy == 4 * (ENGINE_FORWARDS - 1), f"engine (b): {lazy} lazy values"
    # a forward updates each of the 4 members: one launch each
    assert launches == 4 * ENGINE_FORWARDS and counts["deferred_steps"] == ENGINE_FORWARDS - 1, (launches, counts)
    out = {"forwards": ENGINE_FORWARDS, "lazy_values": lazy, "kernel_launches": launches, "engine": counts,
           "enqueue_ms_per_forward": enqueue_s / ENGINE_FORWARDS * 1e3}
    log(f"engine (b) forwards: {json.dumps(out)}  [{card}]")
    return out


def engine_forward_many(mt, engine, histogram, card: str) -> dict:
    """(c) forward_many over phase 9's ImageNet-1k rows through the headline suite at C=1000: the
    per-step values equal 50 forwards bit for bit (the chunk signature seen once before, then reset)."""
    steps, _, num_classes = CURVES_IMAGENET_SHAPE
    rows = curves_imagenet_batches()
    P, T = torch.stack([p for p, _ in rows]), torch.stack([t for _, t in rows])
    engine.set_deferred_dispatch(False)
    try:
        ref = make_suite(mt, num_classes, ENGINE_DEVICE)
        want = [ref(p, t) for p, t in rows]
    finally:
        engine.set_deferred_dispatch(True)
    suite = make_suite(mt, num_classes, ENGINE_DEVICE)
    suite.forward_many(P, T)  # the chunk signature's first sight runs forward by forward
    suite.reset()
    settle(suite)
    histogram.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    got = suite.forward_many(P, T)
    settle(suite)
    ms = (time.perf_counter() - t0) * 1e3
    launches = histogram.KERNEL_LAUNCHES
    for k in want[0]:
        assert got[k].shape[0] == steps, (k, got[k].shape)
        for i in range(steps):
            assert torch.equal(got[k][i], want[i][k]), f"engine (c): step {i} {k} differs"
    assert_suite_states_bit_equal(suite, ref, "engine (c): states after forward_many")
    assert launches == steps, f"engine (c): {launches} launches for {steps} steps"
    out = {"steps": steps, "rows": rows[0][0].shape[0], "num_classes": num_classes, "ms": ms,
           "ms_per_step": ms / steps, "kernel_launches": launches}
    log(f"engine (c) forward_many ImageNet: {json.dumps(out)}  [{card}]")
    del rows, P, T
    return out


def device_tensor_calls(fn, device) -> int:
    """How many tensors ``fn`` made on ``device`` from host data (``torch.tensor(..., device=device)``, SQuAD's
    one way to the card), counted at the call: a profiler session can lose a single small copy."""
    real, count, want = torch.tensor, [0], torch.device(device).type

    def counting(*args, **kwargs):
        made_on = kwargs.get("device")
        count[0] += made_on is not None and torch.device(made_on).type == want
        return real(*args, **kwargs)

    torch.tensor = counting
    try:
        fn()
    finally:
        torch.tensor = real
    return count[0]


def lane_updates(make, batches, update, telemetry) -> tuple:
    """(first validated update's host µs, the lane updates' mean host µs, host-lane spans, the metric)."""
    obj = make(ENGINE_DEVICE)
    telemetry.clear_spans()
    settle()
    t0 = time.perf_counter()
    update(obj, batches[0])
    first_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    for b in batches[1:]:
        update(obj, b)
    lane_us = (time.perf_counter() - t0) / (len(batches) - 1) * 1e6
    spans = sum(r["site"] == "host-lane" for r in telemetry.spans())
    return first_us, lane_us, spans, obj


def engine_lanes(mt, card: str) -> dict:
    """(d) The host lanes: phase 9's binary curve suite (ENGINE_LANE_UPDATES of its updates), phase 14's
    MS MARCO suite (as many updates of 100 queries), phase 19's SQuAD updates; each against its first,
    validated update, its rows or sums bit-equal to the CPU twin's."""
    from metrics_tpu_torch.ops import telemetry

    armed = telemetry.armed
    telemetry.set_telemetry(True)
    out = {}
    try:
        curves = curves_binary_batches()[:ENGINE_LANE_UPDATES]
        retrieval = retrieval_batches(steps=ENGINE_LANE_UPDATES)
        preds, target = squad_corpus()
        squad = list(zip(chunks(preds, QA_SHAPE[1]), chunks(target, QA_SHAPE[1])))
        cases = (("curves_binary", lambda d: curves_binary_suite(mt, d), curves),
                 ("retrieval", lambda d: retrieval_suite(mt, d), retrieval),
                 ("squad", lambda d: mt.SQuAD(device=d), squad))
        for name, make, batches in cases:
            first_us, lane_us, spans, obj = lane_updates(make, batches, update_batch, telemetry)
            assert spans == len(batches) - 1, f"engine (d) {name}: {spans} host-lane updates of {len(batches) - 1}"
            cpu = make("cpu")
            for b in batches:
                update_batch(cpu, tuple(t.cpu() for t in b) if isinstance(b[0], torch.Tensor) else b)
            row = {"updates": len(batches), "first_update_us": first_us, "lane_update_us": lane_us,
                   "lane_updates": spans}
            if name == "squad":
                spare = make(ENGINE_DEVICE)
                spare.update(*batches[0])
                more = batches[1:9]
                row["copies_to_card_per_update"] = device_tensor_calls(
                    lambda: [spare.update(*b) for b in more], ENGINE_DEVICE) / len(more)
                row["copies_to_card_compute"] = device_tensor_calls(spare.compute, ENGINE_DEVICE)
                got, want = obj.compute(), cpu.compute()
                for k in want:
                    assert torch.equal(got[k].cpu(), want[k]), f"engine (d) squad: {k}"
                assert row["copies_to_card_per_update"] == 0 and row["copies_to_card_compute"] == 1, row
                states = {k: float(v) for k, v in obj.metric_state.items()}
                assert states == {k: float(v) for k, v in cpu.metric_state.items()}, states
            else:
                assert_suite_states_bit_equal(obj, cpu, f"engine (d) {name}")
            out[name] = row
            log(f"engine (d) {name}: {json.dumps(row)}  [{card}]")
    finally:
        telemetry.set_telemetry(armed)
    return out


def engine_probe_and_drills(mt, engine, histogram, batches, card: str) -> dict:
    """(e) The device probe at every=1 on (a)'s deferred flushes: ``device_probes`` counted, the
    device-inclusive wall beside the host wall. (f) ``flush-chunk-2`` injected: an eager replay,
    ``deferred_fallbacks`` 1, states bit-equal; ``compile`` injected on a cache miss: counted, the
    updates still run."""
    from metrics_tpu_torch.ops import faults, telemetry

    num_classes, warmup, timed = ENGINE_SHAPE[1:]
    out: dict = {}
    armed = telemetry.armed
    telemetry.set_telemetry(True)
    engine.set_device_probe(1)
    try:
        suite = make_suite(mt, num_classes, ENGINE_DEVICE)
        for preds, target in batches[:warmup]:
            suite.update(preds, target)
        settle(suite)
        telemetry.clear_spans()
        before = engine_counts(engine)
        for preds, target in batches[warmup:]:
            suite.update(preds, target)
        settle(suite)
        counts = counts_delta(engine_counts(engine), before)
        rows = telemetry.spans()
        host = [r["dur"] * 1e3 for r in rows if r["site"] == "engine-dispatch"]
        device = [r["dur"] * 1e3 for r in rows if r["site"] == "device-dispatch"]
        assert counts["device_probes"] >= 1 and len(device) == counts["device_probes"], (counts, len(device))
        out["probe"] = {"device_probes": counts["device_probes"], "host_wall_ms": host, "device_inclusive_ms": device,
                        "per_program": telemetry.device_dispatch_stats()}
        log(f"engine (e) probe every=1: {counts['device_probes']} probes; host wall ms {host}, device-inclusive "
            f"ms {device}  [{card}]")
    finally:
        engine.set_device_probe(0)
        telemetry.set_telemetry(armed)

    def twin_states(n):
        engine.set_deferred_dispatch(False)
        try:
            twin = make_suite(mt, num_classes, ENGINE_DEVICE)
            for preds, target in batches[:n]:
                twin.update(preds, target)
            return twin
        finally:
            engine.set_deferred_dispatch(True)

    # flush-chunk-2: 1 eager update, then 7 queued (chunks of 4, 2, 1): chunks 0 and 1 apply, then the replay
    suite = make_suite(mt, num_classes, ENGINE_DEVICE)
    for preds, target in batches[:8]:
        suite.update(preds, target)
    before = engine_counts(engine)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject_faults("flush-chunk-2", count=1) as plan:
            settle(suite)
    counts = counts_delta(engine_counts(engine), before)
    assert plan.fired == 1 and counts["deferred_fallbacks"] == 1, (plan.fired, counts)
    assert any("Replaying the queue eagerly" in str(w.message) for w in caught), [str(w.message) for w in caught]
    assert_suite_states_bit_equal(suite, twin_states(8), "engine (f) flush-chunk-2")
    out["flush_chunk_drill"] = {"fired": plan.fired, "engine": counts}

    # compile on a miss: the cache emptied, a new suite's first flush must build its program
    engine.reset_engine()
    suite = make_suite(mt, num_classes, ENGINE_DEVICE)
    for preds, target in batches[:4]:
        suite.update(preds, target)
    compile_faults = faults.fault_stats().get("fault_compile", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.inject_faults("compile", count=1) as plan:
            settle(suite)
    assert plan.fired == 1 and faults.fault_stats().get("fault_compile", 0) == compile_faults + 1, plan.fired
    assert_suite_states_bit_equal(suite, twin_states(4), "engine (f) compile")
    out["compile_drill"] = {"fired": plan.fired, "fault_compile": faults.fault_stats().get("fault_compile", 0)}
    log(f"engine (f) drills: {json.dumps(out['flush_chunk_drill'])}, {json.dumps(out['compile_drill'])}  [{card}]")
    return out


def engine_path(mt, checks, histogram, card: str) -> dict:
    """Phase 23: the dispatch engine (see the module docstring). The bincount launches of (a) are
    the kernel row's launches on this path."""
    from metrics_tpu_torch.ops import engine

    t_phase = time.perf_counter()
    checks.set_validation_mode("first")
    engine.set_deferred_dispatch(True, max_pending=128, max_age_ms=250)
    batch, num_classes, warmup, timed = ENGINE_SHAPE
    batches = make_batches(batch, num_classes, warmup + timed, seed=0, device=ENGINE_DEVICE)
    result = {"card": card, "shape": list(ENGINE_SHAPE)}
    result["ways"] = engine_ways(mt, engine, histogram, batches, card)
    result["forwards"] = engine_forwards(mt, engine, histogram, batches, card)
    result["forward_many_imagenet"] = engine_forward_many(mt, engine, histogram, card)
    result["lanes"] = engine_lanes(mt, card)
    result.update(engine_probe_and_drills(mt, engine, histogram, batches, card))
    result["kernel_launches"] = sum(result["ways"][w]["kernel_launches"] for w in ("per_call", "deferred",
                                                                                     "update_many"))
    result["phase_s"] = time.perf_counter() - t_phase
    assert result["phase_s"] < ENGINE_PHASE_S, f"phase 23 took {result['phase_s']:.1f} s"
    log(f"engine phase: {result['phase_s']:.1f} s  [{card}]")
    return result


# ------------------------------------------------------------------ phase 24
# ---- phase 24: functional_core
FUNCORE_DEVICE = "cuda"  # where phase 24 runs
FUNCORE_SHAPE = (8192, 128, 128)  # the headline suite (phase 3's): rows a batch, classes, timed updates
FUNCORE_STACK = 8  # (c) suites stacked under torch.func.vmap
FUNCORE_VMAP_STEPS = 16  # (c) vmapped calls, each one batch a suite
FUNCORE_RANK_STEPS = 4  # (d) updates of each rank of the two-rank Gloo world
FUNCORE_WORLD_S = 300  # (d) wall-clock limit of the two-rank world
FUNCORE_PHASE_S = 60.0
FUNCORE_MEAN_RTOL = 1e-6  # (d) a "mean" state merged by the functional collectives against sync_pytree's


def funcore_states_equal(got: dict, want: dict, label: str) -> None:
    """Two ``{member: {state: tensor}}`` trees bit for bit."""
    assert got.keys() == want.keys(), f"{label}: members {sorted(got)} against {sorted(want)}"
    for name, states in want.items():
        assert got[name].keys() == states.keys(), f"{label}: {name}'s states differ"
        for key, value in states.items():
            mine = got[name][key]
            assert mine.dtype == value.dtype and torch.equal(mine.cpu(), value.cpu()), f"{label}: {name}.{key} differs"


def shell_states(suite) -> dict:
    return {name: dict(m.metric_state) for name, m in suite.items(keep_base=True, copy_state=True)}


def functional_collectives_counted():
    """A counter of the functional collectives issued (``all_reduce`` and the all-gathers), and its undo."""
    import torch.distributed._functional_collectives as funcol

    count = [0]
    real = {name: getattr(funcol, name) for name in ("all_reduce", "all_gather_single", "all_gather_tensor")
            if hasattr(funcol, name)}

    def counting(fn):
        def call(*args, **kwargs):
            count[0] += 1
            return fn(*args, **kwargs)

        return call

    for name, fn in real.items():
        setattr(funcol, name, counting(fn))

    def undo():
        for name, fn in real.items():
            setattr(funcol, name, fn)

    return count, undo


def funcore_apply(mt, histogram, batches, card: str) -> dict:
    """(a) init, apply_update over every batch, apply_compute: against the stateful per-call suite and
    the CPU twin; (b) the same apply_update captured once in a CUDA graph and replayed for every batch."""
    from metrics_tpu_torch.ops import engine

    _, num_classes, timed = FUNCORE_SHAPE
    out: dict = {}
    suite = make_suite(mt, num_classes, FUNCORE_DEVICE)
    state = suite.apply_update(suite.init(), *batches[0])  # the signature's first call: checked, export built
    torch.cuda.synchronize()
    histogram.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    for preds, target in batches[1:]:
        state = suite.apply_update(state, preds, target)
    values = suite.apply_compute(state)
    torch.cuda.synchronize()
    out["apply_ms_per_step"] = (time.perf_counter() - t0) / timed * 1e3
    out["kernel_launches"] = histogram.KERNEL_LAUNCHES
    # apply_update updates each of the 4 members: one launch each
    assert out["kernel_launches"] == 4 * timed, f"funcore (a): {out['kernel_launches']} launches for {timed} updates"
    few = batches[1:17]

    def sixteen():
        s = state
        for p, t in few:
            s = suite.apply_update(s, p, t)
        torch.cuda.synchronize()

    out["host_reads_per_16_updates"] = host_read_count(sixteen)
    assert out["host_reads_per_16_updates"] == 0, out["host_reads_per_16_updates"]
    # the stateful per-call path over the same batches (deferral off)
    engine.set_deferred_dispatch(False)
    try:
        shell = make_suite(mt, num_classes, FUNCORE_DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for preds, target in batches:
            shell.update(preds, target)
        want_values = shell.compute()
        torch.cuda.synchronize()
        out["per_call_ms_per_step"] = (time.perf_counter() - t0) / len(batches) * 1e3
    finally:
        engine.set_deferred_dispatch(True)
    funcore_states_equal(state.states, shell_states(shell), "funcore (a): apply_update against per call")
    for key, value in want_values.items():
        assert torch.equal(values[key].cpu(), value.cpu()), f"funcore (a): {key} differs from the shell's compute()"
    # the CPU twin over the first steps that fit CPU_TWIN_S, against a card run of as many
    cpu = make_suite(mt, num_classes, "cpu")
    t0 = time.perf_counter()
    cpu_state = cpu.apply_update(cpu.init(), batches[0][0].cpu(), batches[0][1].cpu())
    depth = cpu_twin_steps(time.perf_counter() - t0, len(batches))
    card_state = suite.apply_update(suite.init(), *batches[0])
    for preds, target in batches[1:depth]:
        cpu_state = cpu.apply_update(cpu_state, preds.cpu(), target.cpu())
        card_state = suite.apply_update(card_state, preds, target)
    funcore_states_equal(card_state.states, cpu_state.states, "funcore (a): the card against the CPU twin")
    out["cpu_twin_steps"] = depth

    # (b) one capture, a replay a batch; the inputs copied into the captured buffers
    static = suite.init()
    sp, st = batches[0][0].clone(), batches[0][1].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            suite.apply_update(static, sp, st)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    histogram.KERNEL_LAUNCHES = 0
    with torch.cuda.graph(graph):
        new = suite.apply_update(static, sp, st)
        for name, states in static.states.items():
            for key, value in states.items():
                value.copy_(new.states[name][key])
    out["graph_capture_launches"] = histogram.KERNEL_LAUNCHES
    del new
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for preds, target in batches:
        sp.copy_(preds)
        st.copy_(target)
        graph.replay()
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = (time.perf_counter() - t0) / len(batches) * 1e3
    funcore_states_equal(static.states, state.states, "funcore (b): graph replays against apply_update")
    out["graph_replays"] = len(batches)
    del graph, static
    log(f"functional_core (a) apply_update {out['apply_ms_per_step']:.4f} ms/step ({timed} updates, apply_compute "
        f"included), per call {out['per_call_ms_per_step']:.4f} ms/step, {out['kernel_launches']} launches, host reads "
        f"of 16 updates {out['host_reads_per_16_updates']}, CPU twin over {depth} updates bit-equal; (b) CUDA graph "
        f"{out['graph_ms_per_step']:.4f} ms/step over {len(batches)} replays (input copies included), "
        f"{out['graph_capture_launches']} launches captured, states bit-equal  [{card}]")
    return out, state


def funcore_vmap(mt, histogram, batches, card: str) -> dict:
    """(c) torch.func.vmap of apply_update over FUNCORE_STACK stacked suites, FUNCORE_VMAP_STEPS calls, against
    as many separate runs; the bincount one batched launch a member a vmapped call."""
    _, num_classes, _ = FUNCORE_SHAPE
    suite = make_suite(mt, num_classes, FUNCORE_DEVICE)
    k, steps = FUNCORE_STACK, FUNCORE_VMAP_STEPS
    feeds = [[batches[1 + s * k + i] for i in range(k)] for s in range(steps)]
    stacked_inputs = [(torch.stack([p for p, _ in f]), torch.stack([t for _, t in f])) for f in feeds]
    step = torch.func.vmap(lambda s, p, t: suite.apply_update(s, p, t))
    state = mt.stack_states([suite.init() for _ in range(k)])
    state = step(state, *stacked_inputs[0])  # the export and its first call, outside the window
    torch.cuda.synchronize()
    histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
    t0 = time.perf_counter()
    for p, t in stacked_inputs[1:]:
        state = step(state, p, t)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"ms_per_vmapped_call": seconds / (steps - 1) * 1e3, "suites": k, "calls": steps - 1,
           "batched_launches": histogram.BATCHED_LAUNCHES, "kernel_launches": histogram.KERNEL_LAUNCHES}
    assert out["batched_launches"] == 4 * (steps - 1) and out["kernel_launches"] == 0, out  # one a member a call
    rows = mt.unstack_states(state, k)
    for i in range(k):
        one = suite.init()
        for s in range(steps):
            one = suite.apply_update(one, *feeds[s][i])
        funcore_states_equal(rows[i].states, one.states, f"funcore (c): suite {i} vmapped against alone")
    log(f"functional_core (c) vmap over {k} suites: {out['ms_per_vmapped_call']:.4f} ms a call "
        f"({out['ms_per_vmapped_call'] / k:.4f} a suite-step), {out['batched_launches']} batched launches for "
        f"{steps - 1} calls, 0 unbatched; each suite bit-equal to its own run  [{card}]")
    return out


def funcore_merge_check(mt, suite, state, axis, label: str) -> dict:
    """apply_compute(axis_name=axis) against sync_pytree over the same group: the merged states (bit for bit,
    "mean" within FUNCORE_MEAN_RTOL) and the values; one functional collective a state, no host read."""
    from metrics_tpu_torch.parallel.collectives import merge_pytree, resolve_axis, sync_pytree

    group = resolve_axis(axis)
    members = dict(suite._modules.items())
    count, undo = functional_collectives_counted()
    try:
        merged = {n: merge_pytree(state.states[n], members[n]._reduction_specs, axis) for n in members}
        torch.cuda.synchronize()
        collectives = count[0]
        reads = host_read_count(lambda: [merge_pytree(state.states[n], members[n]._reduction_specs, axis)
                                         for n in members])
        values = suite.apply_compute(state, axis_name=axis)
    finally:
        undo()
    synced = {n: sync_pytree(state.states[n], members[n]._reduction_specs, group) for n in members}
    n_states = sum(len(s) for s in state.states.values())
    assert collectives == n_states, f"{label}: {collectives} functional collectives for {n_states} states"
    assert reads == 0, f"{label}: {reads} host reads in the merge"
    for n in members:
        for key, value in synced[n].items():
            got = merged[n][key]
            if members[n]._reduction_specs[key] == "mean":
                torch.testing.assert_close(got, value, rtol=FUNCORE_MEAN_RTOL, atol=0.0)
            else:
                assert got.dtype == value.dtype and torch.equal(got, value), f"{label}: {n}.{key} differs"
    want = suite.apply_compute(mt.FuncState(synced, state.epoch))
    for key, value in want.items():
        assert torch.equal(values[key], value), f"{label}: value {key} differs from sync_pytree's"
    return {"functional_collectives": collectives, "states": n_states, "merge_host_reads": reads,
            "values": {k: v.cpu().tolist() for k, v in values.items() if v.numel() == 1}}


def funcore_gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """(d) One rank of the two-rank Gloo world on the one card (CUDA tensors): apply_update over its own
    batches, then apply_compute(axis_name=the world's group) against sync_pytree's."""
    import torch.distributed as dist

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.utils import checks

    torch.cuda.set_device(0)
    checks.set_validation_mode("first")
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    result: dict = {}
    try:
        batch, num_classes, _ = FUNCORE_SHAPE
        suite = make_suite(mt, num_classes, FUNCORE_DEVICE)
        state = suite.init()
        for preds, target in make_batches(batch, num_classes, FUNCORE_RANK_STEPS, seed=240 + rank,
                                          device=FUNCORE_DEVICE):
            state = suite.apply_update(state, preds, target)
        result = funcore_merge_check(mt, suite, state, dist.group.WORLD, f"funcore (d) rank {rank}")
        result["local"] = {n: {k: v.cpu() for k, v in s.items()} for n, s in state.states.items()}
    except Exception as exc:  # noqa: BLE001 - reported to the parent, which raises
        result = {"error": f"{type(exc).__name__}: {exc}"}
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        dist.destroy_process_group()


def funcore_two_ranks(mt, card: str) -> dict:
    """(d) The two-rank Gloo world: each rank's merge equals sync_pytree's, and the merged counts equal the
    sum of both ranks' local counts."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=funcore_gloo_rank, args=(r, 2, init_method, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + FUNCORE_WORLD_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        results = [torch.load(os.path.join(tmp, f"{r}.pt")) for r in range(2)] if not any(codes) else []
    if any(codes) or any("error" in r for r in results):
        raise RuntimeError(f"funcore two-rank world: exit codes {codes}, {[r.get('error') for r in results]}")
    confmat = sum(r["local"]["confmat"]["confmat"] for r in results)
    assert all(r["values"] == results[0]["values"] for r in results), "funcore (d): the ranks' values differ"
    out = {k: results[0][k] for k in ("functional_collectives", "states", "merge_host_reads", "values")}
    out["confmat_total"] = int(confmat.sum())
    log(f"functional_core (d) two Gloo ranks: {out['functional_collectives']} functional collectives for "
        f"{out['states']} states, 0 host reads, values equal sync_pytree's on both ranks {out['values']}  [{card}]")
    return out


def funcore_world_of_one(mt, suite, state, card: str) -> dict:
    """(d) The NCCL world of one: every axis_name form; (e) host_handoff merged (compute() then issues no
    collective) and with a stale epoch (EpochFault, the states intact)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch import metric as metric_mod
    from metrics_tpu_torch.parallel import sync as psync
    from metrics_tpu_torch.utils.exceptions import EpochFault, SyncConfigFault

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0, world_size=1)
        try:
            out["process_group"] = funcore_merge_check(mt, suite, state, dist.group.WORLD, "funcore (d) NCCL")
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("dp",))
            for label, axis in (("mesh", mesh), ("mesh_dim", (mesh, "dp"))):
                out[label] = funcore_merge_check(mt, suite, state, axis, f"funcore (d) NCCL {label}")
            try:
                suite.apply_compute(state, axis_name="dp")
                raise AssertionError("funcore (d): a bare axis string did not raise")
            except SyncConfigFault as err:
                assert "DeviceMesh" in str(err) and "ProcessGroup" in str(err), str(err)
            # (e) the handoff seam, in a world of one that syncs (as phase 22 makes it)
            shell = make_suite(mt, FUNCORE_SHAPE[1], FUNCORE_DEVICE)
            metric_mod._dist_available = lambda: True
            try:
                before = psync.collective_stats()["sync_collectives_issued"]
                shell.host_handoff(state)
                values = shell.compute()
                out["handoff_collectives"] = psync.collective_stats()["sync_collectives_issued"] - before
                assert out["handoff_collectives"] == 0, out["handoff_collectives"]
                want = suite.apply_compute(state)
                for key, value in want.items():
                    assert torch.equal(values[key], value), f"funcore (e): {key} after host_handoff"
                shell.unsync()
                kept = shell_states(shell)
                stale = state.with_epoch(psync.world_epoch())
                psync.bump_epoch("phase 24 drill: a stale functional tree")
                try:
                    shell.host_handoff(stale)
                    raise AssertionError("funcore (e): a stale epoch landed")
                except EpochFault:
                    pass
                funcore_states_equal(shell_states(shell), kept, "funcore (e): the states after the fenced handoff")
            finally:
                metric_mod._dist_available = psync.distributed_available
                psync.reset_membership()
        finally:
            dist.destroy_process_group()
    log(f"functional_core (d) NCCL world of one: {out['process_group']['functional_collectives']} functional "
        f"collectives for {out['process_group']['states']} states (ProcessGroup, DeviceMesh, (mesh, dim) alike), "
        f"0 host reads, values equal sync_pytree's; (e) merged host_handoff: compute() issued "
        f"{out['handoff_collectives']} collectives; a stale epoch raised EpochFault, states intact  [{card}]")
    return out


def int32_matmul_on_the_card() -> str:
    """Whether this torch multiplies int32 matrices on the card: the fused wrappers' integer row deltas
    contract in float64 because it does not (``wrappers/_fanout.py``)."""
    a = torch.ones(4, 4, dtype=torch.int32, device=FUNCORE_DEVICE)
    try:
        torch.matmul(a, a)
        torch.cuda.synchronize()
        out = "supported"
    except RuntimeError as err:
        out = f"refused: {str(err).splitlines()[0][:120]}"
    log(f"functional_core int32 matmul on the card: {out}")
    return out


def functional_core_path(mt, checks, histogram, card: str) -> dict:
    """Phase 24: the functional core (see the module docstring). The launches of (a) count in the bincount
    row, (c)'s in the batched bincount's."""
    t_phase = time.perf_counter()
    checks.set_validation_mode("first")
    batch, num_classes, timed = FUNCORE_SHAPE
    batches = make_batches(batch, num_classes, timed + 1, seed=24, device=FUNCORE_DEVICE)
    result: dict = {"card": card, "shape": list(FUNCORE_SHAPE)}
    result["apply"], state = funcore_apply(mt, histogram, batches, card)
    result["vmap"] = funcore_vmap(mt, histogram, batches, card)
    suite = make_suite(mt, num_classes, FUNCORE_DEVICE)
    result["world_of_one"] = funcore_world_of_one(mt, suite, state, card)
    result["two_ranks_gloo"] = funcore_two_ranks(mt, card)
    del batches, state
    result["int32_matmul"] = int32_matmul_on_the_card()
    result["kernel_launches"] = result["apply"]["kernel_launches"]
    result["batched_launches"] = result["vmap"]["batched_launches"]
    result["phase_s"] = time.perf_counter() - t_phase
    assert result["phase_s"] < FUNCORE_PHASE_S, f"phase 24 took {result['phase_s']:.1f} s"
    log(f"functional_core phase: {result['phase_s']:.1f} s  [{card}]")
    return result


# ------------------------------------------------------------------ phase 25
# ---- phase 25: tenant_planes
TENANT_DEVICE = "cuda"  # where phase 25 runs
TENANT_TIERS = (100_000, 1_000_000)  # (a) tenants of the Accuracy(2) + MeanMetric arena (bench.py's tiers)
TENANT_ROWS = 8  # rows a tenant an update
TENANT_SLAB = 1024
TENANT_STEPS = 3  # (a), (b) timed updates of each tier, after one untimed
TENANT_TWIN = 1024  # tenants of each CPU twin: the card's first TENANT_TWIN tenants fed the same rows
TENANT_LOOP_SAMPLE = 256  # suites of the per-instance loop the arena is compared with (bench.py's sample)
TENANT_CONFMAT = (100_000, 10)  # (b) tenants, classes
TENANT_LIFECYCLE = (300, 64, 4096, 2)  # (c) one-at-a-time adds, their slab; the lifecycle arena's tenants, cohorts
STREAM_SHAPE = (8192, 128, 32, 8)  # (d) phase 3's batch and classes, updates, window
INGEST_SHAPE = (256, 64)  # (e) tenants (one row each a payload), payloads (bench.py's full setting)
SHARD_CLASSES = 1000  # (f) the ConfusionMatrix split over two Gloo ranks on the CPU
TENANT_WORLD_S = 120  # (f) wall-clock limit of the two-rank world
TENANT_MEAN_RTOL = 1e-6  # float32 sums of 8 (or 4) values in another order on the card and the CPU
TENANT_COHORT_RTOL = 1e-5  # (c) a cohort's value merges 2,048 tenants' float32 sums in another order (the JAX tests' 1e-5)
INGEST_RTOL = 1e-5  # (e) float32 running sums over 129 updates in another order (the JAX tests' float tolerance)
TENANT_PHASE_S = 90.0


def acc_mean_suite(mt, device):
    return mt.MetricCollection({"acc": mt.Accuracy(num_classes=2, device=device), "mean": mt.MeanMetric(device=device)})


def arena_states_equal(card_arena, cpu_arena, rows: int, label: str, rtol: float = 0.0) -> None:
    """The card arena's first ``rows`` tenants against the CPU twin's: counts bit for bit, floats within rtol."""
    for name, twin in cpu_arena._stacked.items():
        got = card_arena._stacked[name][:rows].cpu()
        if got.is_floating_point() and rtol:
            torch.testing.assert_close(got, twin[:rows], rtol=rtol, atol=0.0, equal_nan=True, msg=f"{label}: {name}")
        else:
            assert torch.equal(got, twin[:rows]), f"{label}: {name} differs from the CPU twin"


def idle_share(update, steps: int, wall_ms: float) -> dict:
    """The device's busy ms over ``steps`` profiled updates (torch.profiler) against their wall time."""
    rows = device_profile([update] * (steps + 1), warmup=1)
    busy = sum(ms for ms, _ in rows.values())
    return {"device_ms_per_step": busy / steps if rows else None,
            "idle_share": max(0.0, 1.0 - busy / (wall_ms * steps)) if rows else None}


def loop_suites_per_s(make, update, sample: int, steps: int = 3) -> float:
    """Suite-updates a second of a per-instance loop over ``sample`` suites on the card (mode "first")."""
    suites = [make() for _ in range(sample)]
    for i, s in enumerate(suites):  # the validated first call of each
        update(s, i)
    settle(*suites)
    t0 = time.perf_counter()
    for _ in range(steps):
        for i, s in enumerate(suites):
            update(s, i)
    settle(*suites)
    return sample * steps / (time.perf_counter() - t0)


def arena_tier(mt, engine, histogram, n: int, card: str) -> dict:
    """(a) One tier: ``n`` tenants, ``TENANT_STEPS`` timed updates of all of them."""
    g = torch.Generator(device=TENANT_DEVICE).manual_seed(250 + n % 997)
    preds = torch.randint(0, 2, (n, TENANT_ROWS), generator=g, device=TENANT_DEVICE, dtype=torch.int32)
    target = torch.randint(0, 2, (n, TENANT_ROWS), generator=g, device=TENANT_DEVICE, dtype=torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b0 = engine.engine_stats()["builds"]
    arena = mt.MetricArena(acc_mean_suite(mt, TENANT_DEVICE), capacity=n, slab=TENANT_SLAB, name=f"tier{n}")
    ids = arena.add(n)
    histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
    arena.update(ids, preds, target)  # the untimed first update builds the chunk programs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TENANT_STEPS):
        arena.update(ids, preds, target)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    chunks = len(engine.pow2_chunks(n))
    out = {"tenants": n, "ms_per_step": seconds / TENANT_STEPS * 1e3, "tenant_updates_per_s": n * TENANT_STEPS / seconds,
           "builds": engine.engine_stats()["builds"] - b0, "chunks": chunks,
           "peak_extra_bytes": torch.cuda.max_memory_allocated() - base,
           "batched_launches": histogram.BATCHED_LAUNCHES, "kernel_launches": histogram.KERNEL_LAUNCHES}
    # one update program a chunk size, one compute program: bounded by the chunk sizes, not by the tenants
    assert out["builds"] <= chunks + 1, out
    # the vmapped update counts Accuracy(2)'s class pairs with the batched form, MeanMetric with sums: no plain launch
    assert out["kernel_launches"] == 0, out
    values = arena.compute(ids[:TENANT_TWIN])
    twin = mt.MetricArena(acc_mean_suite(mt, "cpu"), capacity=TENANT_TWIN, slab=TENANT_SLAB)
    tids = twin.add(TENANT_TWIN)
    for _ in range(TENANT_STEPS + 1):
        twin.update(tids, preds[:TENANT_TWIN].cpu(), target[:TENANT_TWIN].cpu())
    arena_states_equal(arena, twin, TENANT_TWIN, f"tenant (a) {n}", rtol=TENANT_MEAN_RTOL)
    twin_values = twin.compute()
    for key, value in twin_values.items():
        torch.testing.assert_close(values[key].cpu(), value, rtol=TENANT_MEAN_RTOL, atol=0.0, equal_nan=True)
    out.update(idle_share(lambda: arena.update(ids, preds, target), 2, out["ms_per_step"]))
    log(f"tenant_planes (a) arena of {n} tenants: {out['ms_per_step']:.3f} ms a step, "
        f"{out['tenant_updates_per_s']:.0f} tenant-updates/s, {out['builds']} builds ({chunks} chunk sizes), "
        f"peak +{out['peak_extra_bytes'] / 2**20:.1f} MiB, device {out['device_ms_per_step']} ms a step, idle share "
        f"{out['idle_share']}, {out['batched_launches']} batched launches (Accuracy(2)'s class pairs); the first "
        f"{TENANT_TWIN} tenants equal the CPU twin  [{card}]")
    del arena, preds, target
    return out


def arena_confmat(mt, engine, histogram, card: str) -> dict:
    """(b) A ConfusionMatrix(10) arena: one batched launch a chunk, the stacked counts bit-equal to the CPU
    twin, against a per-instance loop over TENANT_LOOP_SAMPLE metrics."""
    n, c = TENANT_CONFMAT
    g = torch.Generator(device=TENANT_DEVICE).manual_seed(251)
    preds = torch.randint(0, c, (n, TENANT_ROWS), generator=g, device=TENANT_DEVICE)
    target = torch.randint(0, c, (n, TENANT_ROWS), generator=g, device=TENANT_DEVICE)
    arena = mt.MetricArena(mt.ConfusionMatrix(num_classes=c, device=TENANT_DEVICE), capacity=n, slab=TENANT_SLAB)
    ids = arena.add(n)
    arena.update(ids, preds, target)
    torch.cuda.synchronize()
    histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
    t0 = time.perf_counter()
    for _ in range(TENANT_STEPS):
        arena.update(ids, preds, target)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    chunks = len(engine.pow2_chunks(n))
    out = {"tenants": n, "classes": c, "ms_per_step": seconds / TENANT_STEPS * 1e3,
           "tenant_updates_per_s": n * TENANT_STEPS / seconds,
           "batched_launches": histogram.BATCHED_LAUNCHES, "kernel_launches": histogram.KERNEL_LAUNCHES}
    assert out["batched_launches"] == chunks * TENANT_STEPS and out["kernel_launches"] == 0, out
    twin = mt.MetricArena(mt.ConfusionMatrix(num_classes=c, device="cpu"), capacity=TENANT_TWIN, slab=TENANT_SLAB)
    tids = twin.add(TENANT_TWIN)
    for _ in range(TENANT_STEPS + 1):
        twin.update(tids, preds[:TENANT_TWIN].cpu(), target[:TENANT_TWIN].cpu())
    arena_states_equal(arena, twin, TENANT_TWIN, "tenant (b) confmat")
    sample = TENANT_LOOP_SAMPLE
    out["loop_suites_per_s"] = loop_suites_per_s(lambda: mt.ConfusionMatrix(num_classes=c, device=TENANT_DEVICE),
                                                 lambda m, i: m.update(preds[i], target[i]), sample)
    out["vs_loop"] = out["tenant_updates_per_s"] / out["loop_suites_per_s"]
    log(f"tenant_planes (b) ConfusionMatrix({c}) arena of {n} tenants: {out['ms_per_step']:.3f} ms a step, "
        f"{out['tenant_updates_per_s']:.0f} tenant-updates/s against {out['loop_suites_per_s']:.0f} of a "
        f"{sample}-metric loop ({out['vs_loop']:.1f}x); {out['batched_launches']} batched launches for "
        f"{TENANT_STEPS} steps of {chunks} chunks, 0 unbatched; counts bit-equal to the CPU twin  [{card}]")
    return out


def arena_lifecycle(mt, engine, histogram, card: str, tmp: str) -> dict:
    """(c) One-at-a-time adds across slab boundaries, a masked reset, save and restore of every slab with a
    torn slab falling back to its previous generation, and the cohort views over two cohorts."""
    adds, slab, n, cohorts = TENANT_LIFECYCLE
    out: dict = {}
    arena = mt.MetricArena(mt.MeanMetric(device=TENANT_DEVICE), capacity=1, slab=slab, name="lifecycle")
    row = torch.ones(1, TENANT_ROWS, device=TENANT_DEVICE)
    b0 = engine.engine_stats()["builds"]
    caps = set()
    for _ in range(adds):
        arena.update(arena.add(1), row)
        caps.add(arena.capacity)
    out["retraces_per_add"] = (engine.engine_stats()["builds"] - b0) / adds
    out["capacities"] = sorted(caps)
    assert engine.engine_stats()["builds"] - b0 == len(caps), (engine.engine_stats()["builds"] - b0, caps)
    # the lifecycle arena proper: MeanMetric (sum states: decay and cohort merges apply), two cohorts
    g = torch.Generator(device=TENANT_DEVICE).manual_seed(252)
    x = [torch.rand(n, TENANT_ROWS, generator=g, device=TENANT_DEVICE) for _ in range(4)]
    arena = mt.MetricArena(mt.MeanMetric(device=TENANT_DEVICE), capacity=n, slab=TENANT_SLAB, name="cohorts")
    twin = mt.MetricArena(mt.MeanMetric(device="cpu"), capacity=n, slab=TENANT_SLAB, name="cohorts_cpu")
    half = n // cohorts
    ids = arena.add(half, cohort="a") + arena.add(n - half, cohort="b")
    twin.add(half, cohort="a")
    twin.add(n - half, cohort="b")
    histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
    for a in (arena, twin):
        a.update(ids, x[0] if a is arena else x[0].cpu())
    mask = np.zeros(n, dtype=bool)
    mask[::3] = True
    kept = {k: v.clone() for k, v in arena._stacked.items()}
    arena.reset(mask)
    twin.reset(mask)
    m = torch.from_numpy(mask).to(TENANT_DEVICE)
    for k, v in arena._stacked.items():
        assert torch.equal(v[~m], kept[k][~m]) and not v[m].any(), f"tenant (c): reset(mask) of {k}"
    path = os.path.join(tmp, "arena")
    first = {k: v.clone() for k, v in arena._stacked.items()}
    arena.save(path)
    for a in (arena, twin):
        a.update(ids, x[1] if a is arena else x[1].cpu())
    nbytes = arena.save(path)
    out["slab_record_bytes"] = nbytes // arena.slabs
    with open(f"{path}.slab1", "r+b") as fh:  # tear slab 1's newest record
        fh.seek(40)
        fh.write(b"\xff" * 8)
    restored = mt.MetricArena(mt.MeanMetric(device=TENANT_DEVICE), capacity=1, slab=TENANT_SLAB, name="restored")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the demotion's warning is the point
        out["restore"] = restored.restore(path)
    assert out["restore"] == {"slabs": n // TENANT_SLAB, "demotions": 1, "tenants": n}, out["restore"]
    s = slice(TENANT_SLAB, 2 * TENANT_SLAB)
    for k, v in restored._stacked.items():
        want = arena._stacked[k].clone()
        want[s] = first[k][s]
        assert torch.equal(v, want), f"tenant (c): restored {k} is not the saved slabs with slab 1 demoted"
    # the cohort views: a window close over both cohorts, a decay tick, a drift report between them
    closed, twin_closed = arena.close_window(), twin.close_window()
    for cohort, value in twin_closed["cohorts"].items():
        torch.testing.assert_close(closed["cohorts"][cohort].cpu(), value, rtol=TENANT_COHORT_RTOL, atol=0.0,
                                   equal_nan=True)
    for a in (arena, twin):
        a.update(ids, x[2] if a is arena else x[2].cpu())
        a.decay_tick(4.0)
    arena_states_equal(arena, twin, n, "tenant (c) decay_tick", rtol=TENANT_MEAN_RTOL)
    before = histogram.KERNEL_LAUNCHES
    out["drift"] = arena.cohort_drift("a", "b")
    assert histogram.KERNEL_LAUNCHES - before == 2, "tenant (c): cohort_drift did not count with the kernel"
    # the same samples counted on the CPU: the same bins, so the same scores exactly
    twin_drift = mt.drift_report(arena._cohort_sample("a"), arena._cohort_sample("b"), device="cpu")
    assert {k: v for k, v in out["drift"].items()} == twin_drift, (out["drift"], twin_drift)
    out["window_values"] = {k: float(v) for k, v in arena.window_values().items()}
    out["kernel_launches"], out["batched_launches"] = histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES
    log(f"tenant_planes (c) lifecycle: {adds} one-at-a-time adds over capacities {out['capacities']}, "
        f"retraces_per_add {out['retraces_per_add']:.4f}; reset(mask) left the other rows bit-equal; "
        f"save/restore of {n // TENANT_SLAB} slabs ({out['slab_record_bytes']} bytes a slab record), the torn "
        f"slab fell back to its previous generation; close_window, decay_tick equal the CPU twin; cohort_drift "
        f"psi {out['drift']['psi']:.6g} ks {out['drift']['ks']:.6g} through the kernel  [{card}]")
    return out


def streaming_plane(mt, checks, histogram, card: str, tmp: str) -> dict:
    """(d) Windowed over phase 3's headline suite, its journal restore, Decayed, and a drift report between
    the first and the last window's scores."""
    batch, c, updates, window = STREAM_SHAPE
    batches = make_batches(batch, c, updates, seed=253, signal=1.0, device=TENANT_DEVICE)
    suite = make_suite(mt, c, TENANT_DEVICE)
    path = os.path.join(tmp, "window")
    win = mt.Windowed(suite, window=window, name="headline", journal_path=path)
    histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
    closes = []
    t0 = time.perf_counter()
    for preds, target in batches:
        out = win.update(preds, target)
        if out is not None:
            closes.append(out)
    settle(suite)
    seconds = time.perf_counter() - t0
    result = {"updates": updates, "window": window, "closes": len(closes), "ms_per_update": seconds / updates * 1e3,
              "close_bytes": closes[-1]["bytes"]}
    assert len(closes) == updates // window and win.window_id == len(closes), (len(closes), win.window_id)
    # the last window's value against a fresh suite fed the last window's batches
    fresh = make_suite(mt, c, TENANT_DEVICE)
    for preds, target in batches[-window:]:
        fresh.update(preds, target)
    want = fresh.compute()
    for key, value in win.value().items():
        assert torch.equal(value, want[key]), f"tenant (d): window value {key}"
    restored = mt.Windowed(make_suite(mt, c, TENANT_DEVICE), window=window, name="headline_restored",
                           journal_path=path)
    back = restored.restore()
    for key, value in back["value"].items():
        assert torch.equal(value, want[key]), f"tenant (d): restored window value {key}"
    try:
        mt.Decayed(make_suite(mt, c, TENANT_DEVICE), halflife=4.0)
        raise AssertionError("tenant (d): Decayed took integer count states")
    except ValueError:
        result["decayed_suite"] = "refused: integer count states cannot decay (as in JAX)"
    ema = mt.Decayed(mt.MeanMetric(device=TENANT_DEVICE), halflife=4.0)
    ema_cpu = mt.Decayed(mt.MeanMetric(device="cpu"), halflife=4.0)
    for preds, _ in batches:
        conf = preds.max(dim=1).values
        ema.update(conf)
        ema_cpu.update(conf.cpu())
    result["decayed_confidence"] = float(ema.compute())
    torch.testing.assert_close(ema.compute().cpu(), ema_cpu.compute(), rtol=1e-5, atol=0.0)
    first = torch.cat([p.max(dim=1).values for p, _ in batches[:window]])
    last = torch.cat([p.max(dim=1).values for p, _ in batches[-window:]])
    before = histogram.KERNEL_LAUNCHES
    result["drift"] = mt.drift_report(last, first, name="headline_scores", device=TENANT_DEVICE)
    assert histogram.KERNEL_LAUNCHES - before == 2, "tenant (d): the drift report did not count with the kernel"
    twin = mt.drift_report(last.cpu(), first.cpu(), device="cpu")
    assert result["drift"] == twin, (result["drift"], twin)
    result["kernel_launches"], result["batched_launches"] = histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES
    log(f"tenant_planes (d) Windowed(headline suite C={c}, window={window}) over {updates} updates: "
        f"{result['closes']} closes, {result['ms_per_update']:.3f} ms an update, {result['close_bytes']} bytes a slot; "
        f"the window value and its journal restore equal a fresh suite's; Decayed(MeanMetric of the confidences) "
        f"{result['decayed_confidence']:.6f} equals the CPU; drift psi {result['drift']['psi']:.6g} "
        f"ks {result['drift']['ks']:.6g} equal to the CPU's  [{card}]")
    del batches
    return result


def ingest_plane(mt, histogram, card: str) -> dict:
    """(e) IngestGateway into a MeanMetric arena at bench.py's full setting: admitted rows/s, offer latency,
    the 2x overload's shed fraction, and the settlement identity."""
    from metrics_tpu_torch import ingest

    tenants, payloads = INGEST_SHAPE
    rows = tenants
    rng = np.random.RandomState(19)
    x = rng.rand(rows, 4).astype(np.float32)
    arena = mt.MetricArena(mt.MeanMetric(device=TENANT_DEVICE), capacity=tenants, slab=64, name="ingest")
    ids = np.asarray(arena.add(tenants))
    twin = mt.MetricArena(mt.MeanMetric(device="cpu"), capacity=tenants, slab=64, name="ingest_cpu")
    twin.add(tenants)
    stats0 = ingest.ingest_stats()
    gw = mt.IngestGateway(arena, name="bench_ingest", auto_flush=True, max_rows=rows * payloads * 2,
                          flush_rows=rows * 8)
    gw.offer(x, tenant_ids=ids)
    gw.flush()  # the first payload pins the schema and builds the chunk program
    torch.cuda.synchronize()
    histogram.KERNEL_LAUNCHES, histogram.BATCHED_LAUNCHES = 0, 0
    admitted0 = ingest.ingest_stats()["ingest_admitted_rows"]
    t0 = time.perf_counter()
    for _ in range(payloads):
        gw.offer(x, tenant_ids=ids)
    gw.flush()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    admitted = ingest.ingest_stats()["ingest_admitted_rows"] - admitted0
    lat = []
    for _ in range(payloads):
        t1 = time.perf_counter()
        gw.offer(x, tenant_ids=ids)
        lat.append((time.perf_counter() - t1) * 1e6)
    gw.flush()
    gw.close()
    for _ in range(2 * payloads + 1):
        twin.update(ids, x)
    torch.testing.assert_close(arena.compute().cpu(), twin.compute(), rtol=INGEST_RTOL, atol=0.0, equal_nan=True)
    over = mt.IngestGateway(arena, name="bench_ingest_2x", auto_flush=False, max_rows=rows * payloads)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the shed warning is the point
        for _ in range(payloads * 2):
            over.offer(x, tenant_ids=ids)
        over.flush()
    over.close()
    torch.cuda.synchronize()
    stats = {k: v - stats0[k] for k, v in ingest.ingest_stats().items()}
    settled = (stats["ingest_admitted_rows"] + stats["ingest_coalesced_rows"] + stats["ingest_shed_rows"]
               + stats["ingest_quarantined_rows"])
    assert stats["ingest_offered_rows"] == settled, stats
    over_offered = rows * payloads * 2
    out = {"tenants": tenants, "payloads": payloads, "admitted_rows_per_s": admitted / seconds,
           "offered_rows_per_s": rows * payloads / seconds, "window_admitted_rows": admitted,
           "offer_p50_us": float(np.percentile(lat, 50)), "offer_p99_us": float(np.percentile(lat, 99)),
           "shed_fraction": stats["ingest_shed_rows"] / over_offered, "identity": "exact",
           "offered_rows": stats["ingest_offered_rows"], "settled_rows": settled,
           "kernel_launches": histogram.KERNEL_LAUNCHES, "batched_launches": histogram.BATCHED_LAUNCHES}
    log(f"tenant_planes (e) IngestGateway into a MeanMetric arena ({tenants} tenants, {payloads} payloads of "
        f"{rows} rows): {out['admitted_rows_per_s']:.0f} admitted rows/s ({admitted} admitted of "
        f"{rows * payloads} offered in the timed window, {out['offered_rows_per_s']:.0f} offered rows/s), offer p50 {out['offer_p50_us']:.1f} us "
        f"p99 {out['offer_p99_us']:.1f} us; 2x overload shed fraction {out['shed_fraction']:.4f}; offered "
        f"{settled} rows = admitted + coalesced + shed + quarantined exactly; values equal the CPU twin  [{card}]")
    return out


def shard_gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """(f) One rank of the two-rank Gloo world on the CPU: ConfusionMatrix(SHARD_CLASSES) split on its class
    axis, updated once with each rank's own batches (plain tensors, against an unsharded twin of every rank's
    rows) and once with the same batches on every rank (``Replicate()`` DTensors, against one rank's run);
    then PearsonCorrCoef under each rank's own rows, against an unsharded run of both ranks' rows."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.parallel.sharding import PartitionSpec, infer_state_pspecs, shard_states

    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    result: dict = {}
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("c",))
        metric = mt.ConfusionMatrix(num_classes=SHARD_CLASSES, device="cpu")
        gens = [torch.Generator().manual_seed(254 + r) for r in range(world)]
        steps = [[(torch.randint(0, SHARD_CLASSES, (8192,), generator=g),
                   torch.randint(0, SHARD_CLASSES, (8192,), generator=g)) for g in gens] for _ in range(2)]
        for mode in ("dp", "replicated"):
            state = shard_states(metric.init(), mesh, {"confmat": PartitionSpec("c", None)})
            plain = metric.init()
            for batches in steps:
                if mode == "dp":  # each rank its own rows; the twin runs every rank's
                    state = metric.apply_update(state, *batches[rank])
                    plain = metric.apply_update(plain, *(torch.cat(t) for t in zip(*batches)))
                else:  # every rank rank 0's rows
                    state = metric.apply_update(state, *(DTensor.from_local(t, mesh, [Replicate()], run_check=False)
                                                         for t in batches[0]))
                    plain = metric.apply_update(plain, *batches[0])
            local = state.states["confmat"].to_local()
            result[mode] = {"local_shape": tuple(local.shape),
                            "equal": bool(torch.equal(metric.apply_compute(state), metric.apply_compute(plain))),
                            "local_equal": bool(torch.equal(local, plain.states["confmat"].chunk(world)[rank]))}
        # PearsonCorrCoef's six moments (reduction None) placed by infer_state_pspecs, each rank its own rows:
        # merged by the metric's own moment merge, against an unsharded run of both ranks' rows
        pearson = mt.PearsonCorrCoef(device="cpu")
        specs = {k: v for k, v in infer_state_pspecs(pearson.init().states, mesh, pearson._reduction_specs).items()
                 if v is not None}
        cols = []
        for r in range(world):
            g = torch.Generator().manual_seed(256 + r)
            x = torch.rand(2, 4096, generator=g)
            cols.append((x, 0.5 * x + 0.5 * torch.rand(2, 4096, generator=g)))
        state, plain = shard_states(pearson.init(), mesh, specs), pearson.init()
        for step in range(2):
            state = pearson.apply_update(state, cols[rank][0][step], cols[rank][1][step])
            plain = pearson.apply_update(plain, *(torch.cat([c[i][step] for c in cols]) for i in (0, 1)))
        result["pearson_dp"] = {"value": float(pearson.apply_compute(state)), "plain": float(pearson.apply_compute(plain))}
    except Exception as exc:  # noqa: BLE001 - reported to the parent, which raises
        result = {"error": f"{type(exc).__name__}: {exc}"}
    finally:
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        dist.destroy_process_group()


def shard_planes(mt, card: str) -> dict:
    """(f) The headline suite's states placed by shard_states on a NCCL DeviceMesh of one on the card, updated
    and computed, equal to the unsharded run; then the two-rank Gloo world on the CPU."""
    import multiprocessing as mp

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.parallel.sharding import PartitionSpec, shard_states

    batch, c, _, _ = STREAM_SHAPE
    batches = make_batches(batch, c, 3, seed=255, device=TENANT_DEVICE)
    suite = make_suite(mt, c, TENANT_DEVICE)
    out: dict = {}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=0, world_size=1)
        try:
            mesh = init_device_mesh(torch.device(TENANT_DEVICE).type, (1,), mesh_dim_names=("c",))
            state = suite.init()
            state.states = {name: shard_states(s, mesh, {"confmat": PartitionSpec("c", None)} if name == "confmat" else {})
                            for name, s in state.states.items()}
            plain = suite.init()
            for preds, target in batches:
                state = suite.apply_update(state, preds, target)
                plain = suite.apply_update(plain, preds, target)
            confmat = state.states["confmat"]["confmat"]
            out["card_placements"] = [type(p).__name__ for p in confmat.placements]
            got, want = suite.apply_compute(state), suite.apply_compute(plain)
            for key, value in want.items():
                assert torch.equal(got[key], value), f"tenant (f): sharded {key} on the card"
            assert torch.equal(confmat.to_local(), plain.states["confmat"]["confmat"])
        finally:
            dist.destroy_process_group()
        ctx = mp.get_context("spawn")
        init_method = f"file://{os.path.join(tmp, 'gloo_rendezvous')}"
        procs = [ctx.Process(target=shard_gloo_rank, args=(r, 2, init_method, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TENANT_WORLD_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        ranks = [torch.load(os.path.join(tmp, f"{r}.pt")) for r in range(2)] if not any(codes) else []
    if any(codes) or any("error" in r for r in ranks):
        raise RuntimeError(f"tenant (f) two-rank world: exit codes {codes}, {[r.get('error') for r in ranks]}")
    for r in ranks:
        for mode in ("dp", "replicated"):
            got = r[mode]
            assert got["local_shape"] == (SHARD_CLASSES // 2, SHARD_CLASSES) and got["equal"] and got["local_equal"], r
        pearson = r["pearson_dp"]  # float32 moments merged pairwise against one stream: within 1e-5
        assert abs(pearson["value"] - pearson["plain"]) <= 1e-5, pearson
    out["gloo_local_shape"] = list(ranks[0]["dp"]["local_shape"])
    out["pearson_dp"] = ranks[0]["pearson_dp"]
    log(f"tenant_planes (f) sharding: the headline suite's states on a NCCL DeviceMesh of one "
        f"({out['card_placements']}) updated and computed equal to the unsharded run; two Gloo ranks on the CPU "
        f"hold {out['gloo_local_shape']} of ConfusionMatrix({SHARD_CLASSES}) each; with each rank's own batches "
        f"the values equal an unsharded run of both ranks' rows, with the same batches replicated they equal "
        f"one rank's unsharded run; PearsonCorrCoef's moments (reduction None) under each rank's own rows "
        f"{out['pearson_dp']['value']:.7f} against the unsharded {out['pearson_dp']['plain']:.7f}  [{card}]")
    return out


def tenant_planes_path(mt, checks, histogram, card: str) -> dict:
    """Phase 25: the tenant planes (see the module docstring). The launches of (a) to (e) count in the
    kernels line: plain ones in the bincount row, batched ones in the batched row."""
    from metrics_tpu_torch.ops import engine

    t_phase = time.perf_counter()
    checks.set_validation_mode("first")
    result: dict = {"card": card}
    part_s: dict = {}

    def part(label, fn, *args):
        t0 = time.perf_counter()
        result[label] = fn(*args)
        part_s[label] = time.perf_counter() - t0

    part("tiers", lambda: [arena_tier(mt, engine, histogram, n, card) for n in TENANT_TIERS])
    part("confmat", arena_confmat, mt, engine, histogram, card)
    with tempfile.TemporaryDirectory() as tmp:
        part("lifecycle", arena_lifecycle, mt, engine, histogram, card, tmp)
        part("streaming", streaming_plane, mt, checks, histogram, card, tmp)
    part("ingest", ingest_plane, mt, histogram, card)
    part("sharding", shard_planes, mt, card)
    result["part_s"] = part_s
    parts = result["tiers"] + [result[k] for k in ("confmat", "lifecycle", "streaming", "ingest")]
    result["kernel_launches"] = sum(p["kernel_launches"] for p in parts)
    result["batched_launches"] = sum(p["batched_launches"] for p in parts)
    result["phase_s"] = time.perf_counter() - t_phase
    assert result["phase_s"] < TENANT_PHASE_S, f"phase 25 took {result['phase_s']:.1f} s"
    log(f"tenant_planes phase: {result['phase_s']:.1f} s ({json.dumps({k: round(v, 1) for k, v in part_s.items()})}), "
        f"{result['kernel_launches']} bincount launches, {result['batched_launches']} batched  [{card}]")
    return result


# ------------------------------------------------------------------ phase 26
LEDGER_DEVICE = "cuda"  # where phase 26 runs
LEDGER_SHAPE = (8192, 128, 96)  # (a) phase 3's headline suite: rows a batch, classes, updates of the decomposed loop
LEDGER_DEFER_MAX = 4  # (a) a queue flushes every 4 updates: one run of the suite's program each
LEDGER_PROBE_EVERY = 8  # (a) every 8th run of a program synchronises and is timed on the device
TUNE_BINNED = (1000, 1000, 100)  # (c) rows, classes, thresholds: one ImageNet-width BinnedAveragePrecision update
TUNE_SORT_N = 2**20  # (c) scores of the sort variants
TUNE_FID_D = 2048  # (c) InceptionV3's pool features: the FID covariances, float64
TUNE_MAP_IMAGES = 24  # (c) COCO-like images whose mAP compute consults map_box_iou at its small cells
TUNE_MAP_ATOL = 1e-6  # (c) mAP with the autotuner armed against it disarmed: the same host matching on IoUs within 1e-5
CACHE_CHUNKS = 8  # (d) the precompiled queue lengths: 1, 2, 4, 8
CACHE_ACQUIRE_ROWS = 64  # (d) rows of the batches the warm boot's precompile acquires its programs with
FLEET_SLOW_S = 0.05  # (e) the slowed rank's pack sleeps this long a sync
FLEET_WORLD_S = 120  # (e) wall-clock limit of the two-rank world
LEDGER_PHASE_S = 90.0


def ledger_perf(mt, checks, histogram, card: str) -> dict:
    """(a) perf_report over the headline suite's decomposed loop, device probes every 8 runs, and its coverage
    of the measured wall; the probed run's states equal an unprobed run's bit for bit; (b) the roofline
    peaks calibrated on the card and the suite's programs classified against them."""
    from metrics_tpu_torch.ops import engine, perf, telemetry

    batch, num_classes, steps = LEDGER_SHAPE
    batches = make_batches(batch, num_classes, steps, seed=260, device=LEDGER_DEVICE)
    checks.set_validation_mode("first")
    engine.set_deferred_dispatch(max_pending=LEDGER_DEFER_MAX)
    telemetry.set_telemetry(True)
    try:
        plain = make_suite(mt, num_classes, LEDGER_DEVICE)
        for preds, target in batches:
            plain.update(preds, target)
        settle(plain)
        suite = make_suite(mt, num_classes, LEDGER_DEVICE)
        for preds, target in batches[:2]:  # the first calls are validated and build the programs
            suite.update(preds, target)
        settle(suite)
        engine.set_device_probe(LEDGER_PROBE_EVERY)
        telemetry.clear_spans()
        before = telemetry.latency_stats()
        histogram.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        for preds, target in batches[2:]:
            suite.update(preds, target)
        settle(suite)
        wall = time.perf_counter() - t0
        launches = histogram.KERNEL_LAUNCHES
        report = perf.perf_report(measured_wall_s=wall)
        columns = perf.phase_columns(before, telemetry.latency_stats())
    finally:
        engine.set_device_probe(0)
        engine.set_deferred_dispatch(max_pending=128)
    assert launches == 3 * (steps - 2), f"ledger: {launches} bincount launches in {steps - 2} updates"
    for name, member in suite.items(keep_base=True, copy_state=False):
        for state, value in member.metric_state.items():
            assert torch.equal(value, getattr(dict(plain.items(keep_base=True, copy_state=False))[name], state)), (
                f"ledger: {name}.{state} of the probed run differs from the unprobed run")
    rec = report["reconciliation"]
    assert rec["within_tolerance"], f"ledger: the spans cover {rec['coverage']} of the measured wall"
    assert report["device_probe"]["probes"] >= 1, "ledger: no device probe was taken"
    log(f"ledger (a) perf_report over {steps - 2} headline updates (B={batch}, C={num_classes}, a queue of "
        f"{LEDGER_DEFER_MAX}, a probe every {LEDGER_PROBE_EVERY} runs): wall {wall * 1e3:.2f} ms, coverage "
        f"{rec['coverage']} (tolerance {perf.TOLERANCE}); phase columns ms {json.dumps(columns)}; opportunities "
        f"{[(o['phase'], o['share']) for o in report['opportunities']]}  [{card}]")
    peaks = engine.roofline_peaks()
    assert peaks["calibrated"] and peaks["peak_flops_per_s"] > 0 and peaks["peak_bytes_per_s"] > 0, peaks
    rows = [r for r in report["programs"] if r["device"]]
    assert rows, "ledger: no probed program in the report"
    ledger = [{"program": r["program"], "kind": r["kind"], "bound": r["roofline"]["bound"],
               "device_p50_ms": r["roofline"]["device_p50_s"] * 1e3, "probes": r["roofline"]["probes"],
               "flops": (r["analysis"] or {}).get("flops"), "bytes": (r["analysis"] or {}).get("bytes_accessed"),
               "host_share": r["roofline"]["host_share"]} for r in rows]
    log(f"ledger (b) roofline_peaks: {peaks['peak_flops_per_s'] / 1e12:.2f} TFLOP/s float32 (TF32 off), "
        f"{peaks['peak_bytes_per_s'] / 1e12:.3f} TB/s, ridge {peaks['ridge_flops_per_byte']:.2f} FLOP/B; "
        f"program_report: {json.dumps(ledger)}  [{card}]")
    return {"steps": steps - 2, "wall_ms": wall * 1e3, "reconciliation": rec, "phase_columns_ms": columns,
            "opportunities": report["opportunities"], "peaks": peaks, "programs": ledger, "kernel_launches": launches,
            "card": card}


def tune_binned(histogram, card: str) -> dict:
    """(c) binned_counts at ImageNet width: each variant's device time, the hand kernel's launches in the
    sweep's segment_sum candidate, its counts bit for bit against the reference, then the selected path."""
    from metrics_tpu_torch.ops import autotune, binned

    n, c, t = TUNE_BINNED
    g = torch.Generator(device=LEDGER_DEVICE).manual_seed(261)
    preds = torch.softmax(torch.randn(n, c, generator=g, device=LEDGER_DEVICE), dim=1)
    labels = torch.randint(0, c, (n,), generator=g, device=LEDGER_DEVICE)
    target = torch.nn.functional.one_hot(labels, c).to(torch.float32)
    thresholds = torch.linspace(0, 1, t, device=LEDGER_DEVICE)
    want = binned._binned_onehot_matmul(preds, target, thresholds)
    got = binned._binned_segment_sum(preds, target, thresholds)  # the variant alone, on the card
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "segment_sum variant differs from onehot_matmul"
    histogram.KERNEL_LAUNCHES = 0
    report = autotune.sweep("binned_counts", (preds, target, thresholds))
    sweep_launches = histogram.KERNEL_LAUNCHES
    rows = {r["variant"]: r for r in report["candidates"]}
    assert all(r["ok"] and (r["reference"] or r["exact"]) for r in rows.values()), report["candidates"]
    # the segment_sum candidate's first run and its timed runs: two launches each (TP and all histograms)
    assert sweep_launches == 2 * 4, f"binned sweep: {sweep_launches} bincount launches"
    histogram.KERNEL_LAUNCHES = 0
    selected = binned.binned_curve_counts(preds, target, thresholds)
    torch.cuda.synchronize()
    selected_launches = histogram.KERNEL_LAUNCHES
    assert selected_launches == (2 if report["winner"] == "segment_sum" else 0), (report["winner"], selected_launches)
    assert all(torch.equal(a, b) for a, b in zip(selected, want)), "the selected binned path differs"
    bytes_moved = 4 * (2 * n * c + t + 3 * c * t)
    # each variant's device time under the profiler (launches made to measure, not counted), beside the
    # sweep's own: the best of 3 runs queued back to back behind a spin kernel, each between CUDA events
    variants = {"onehot_matmul": binned._binned_onehot_matmul, "scatter_add": binned._binned_scatter_add,
                "segment_sum": binned._binned_segment_sum}
    profiles = {v: op_profile(lambda fn=fn: fn(preds, target, thresholds), bytes_moved, 4 * n * c * t)
                for v, fn in variants.items()}
    out = {"n": n, "c": c, "t": t, "winner": report["winner"], "card": card,
           "device_us": {v: p["device_ms"] * 1e3 for v, p in profiles.items()},
           "device_kernels": {v: p["device_rows"] for v, p in profiles.items()},
           "sweep_wall_us": {v: r["wall_s"] * 1e6 for v, r in rows.items()},
           "sweep_launches": sweep_launches, "selected_launches": selected_launches,
           "bound_us": max(bytes_moved / HBM_BYTES_PER_S, 4 * n * c * t / FP32_OPS_PER_S) * 1e6,
           "bucketize_bound_us": bytes_moved / HBM_BYTES_PER_S * 1e6,
           "tp_fp_fn_sums": [float(x.sum()) for x in selected]}
    log(f"autotune (c) binned_counts N={n} C={c} T={t}: device us {json.dumps(out['device_us'])} (profiler); the "
        f"sweep's device us {json.dumps(out['sweep_wall_us'])} (best of 3 held runs, CUDA events); winner "
        f"{report['winner']}; "
        f"kernels {json.dumps(out['device_kernels'])}; the hand kernel launched {sweep_launches} times in the sweep's "
        f"segment_sum candidate, {selected_launches} in the selected path; TP/FP/FN bit for bit against "
        f"onehot_matmul; bound {out['bound_us']:.2f} us (operations), the bucketize {out['bucketize_bound_us']:.2f} "
        f"us (bytes)  [{card}]")
    return out


def tune_sorts_fid_map(mt, card: str) -> dict:
    """(c) auroc_sort and ap_sort at 2**20 scores, fid_sqrtm at 2048 x 2048 float64, map_box_iou at COCO-like
    cells through mAP's call site: each installed winner held to the reference under its contract."""
    import numpy as np

    from metrics_tpu_torch.image import generative
    from metrics_tpu_torch.ops import autotune, sorted_curves

    g = torch.Generator(device=LEDGER_DEVICE).manual_seed(262)
    scores = torch.round(torch.rand(TUNE_SORT_N, generator=g, device=LEDGER_DEVICE) * 1e4) / 1e4  # ties
    labels = (torch.rand(TUNE_SORT_N, generator=g, device=LEDGER_DEVICE) < 0.3).to(torch.float32)
    out = {"card": card}
    for kernel, public, reference in (("auroc_sort", sorted_curves.binary_auroc_sorted, sorted_curves._auroc_midranks),
                                      ("ap_sort", sorted_curves.binary_average_precision_sorted,
                                       sorted_curves._ap_argsort)):
        report = autotune.sweep(kernel, (scores, labels))
        value, want = float(public(scores, labels)), float(reference(scores, labels))
        assert abs(value - want) <= sorted_curves._SORT_TOL, (kernel, report["winner"], value, want)
        out[kernel] = {"winner": report["winner"], "device_us": {r["variant"]: r["wall_s"] * 1e6
                                                                  for r in report["candidates"] if r["ok"]},
                       "value": value, "reference_value": want}
    d = TUNE_FID_D
    feats = [torch.randn(2 * d, d, generator=g, device=LEDGER_DEVICE, dtype=torch.float64) for _ in range(2)]
    sigmas = [f.T @ f / (2 * d - 1) for f in feats]
    report = autotune.sweep("fid_sqrtm", tuple(sigmas))
    value, want = float(generative._trace_sqrtm_product(*sigmas)), float(generative._trace_sqrtm_eigh(*sigmas))
    assert abs(value - want) <= 1e-2 * (1 + abs(want)), ("fid_sqrtm", report["winner"], value, want)
    out["fid_sqrtm"] = {"winner": report["winner"], "value": value, "reference_value": want,
                        "device_us": {r["variant"]: r["wall_s"] * 1e6 for r in report["candidates"] if r["ok"]},
                        "disqualified": report["disqualified"]}
    data = coco_detections(TUNE_MAP_IMAGES, seed=263)
    on = lambda ds: [{k: torch.as_tensor(v).to(LEDGER_DEVICE) for k, v in x.items()} for x in ds]  # noqa: E731
    values = {}
    for armed in (False, True):
        autotune.configure(enabled=armed)
        m = mt.MeanAveragePrecision(box_format="xywh", device=LEDGER_DEVICE)
        m.update(on([p for p, _ in data]), on([t for _, t in data]))
        values[armed] = {k: float(v) for k, v in m.compute().items() if v.numel() == 1}
    autotune.configure(enabled=True)
    swept = {sc: v for (k, sc), v in autotune._SELECTIONS.items() if k == "map_box_iou"}
    assert swept, "map_box_iou: the call site swept no shape class"
    err = max(abs(values[True][k] - values[False][k]) for k in values[False])
    assert err <= TUNE_MAP_ATOL and all(np.isfinite(list(values[True].values()))), err
    out["map_box_iou"] = {"shape_classes": len(swept), "winners": sorted(set(swept.values())), "max_abs_err": err,
                          "map": values[True]["map"]}
    log(f"autotune (c) sorts at {TUNE_SORT_N} scores: {json.dumps({k: out[k] for k in ('auroc_sort', 'ap_sort')})}; "
        f"fid_sqrtm {d}x{d} float64: {json.dumps(out['fid_sqrtm'])}; map_box_iou over {TUNE_MAP_IMAGES} COCO-like "
        f"images: {json.dumps(out['map_box_iou'])}  [{card}]")
    return out


def cache_child(role: str, store: str, out_path: str) -> None:
    """(d) one fresh process on the card; the first headline update of each is timed. ``cold`` (store on):
    that update first, then a binned_counts sweep (which persists the table) and ``precompile`` (which
    stores every signature). ``warm`` (store on): one binned update (the table restored, nothing swept),
    ``precompile`` of CACHE_ACQUIRE_ROWS-row batches (it acquires the programs; none of the stored shapes) and
    ``warm_programs`` (which runs the stored shapes), the first update, then ``precompile`` of the stored
    shapes, which finds every one. ``control`` (store off): the binned update, ``precompile`` of the same
    shapes as the update, then the first update: what the store adds is the warm boot's difference from it."""
    os.environ.update(METRICS_TPU_PROGCACHE="0" if role == "control" else "1", METRICS_TPU_PROGCACHE_DIR=store,
                      METRICS_TPU_AUTOTUNE="1")
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import autotune, binned, engine
    from metrics_tpu_torch.utils import checks

    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.zeros(1, device=LEDGER_DEVICE)
    torch.cuda.synchronize()  # the CUDA context exists in every role before any timing
    checks.set_validation_mode("first")
    batch, num_classes, _ = LEDGER_SHAPE
    preds, target = make_batches(batch, num_classes, 1, seed=264, device=LEDGER_DEVICE)[0]
    n, c, t = TUNE_BINNED
    scores = torch.rand(n, c, device=LEDGER_DEVICE)
    onehot = (torch.rand(n, c, device=LEDGER_DEVICE) < 0.001).to(torch.float32)
    thresholds = torch.linspace(0, 1, t, device=LEDGER_DEVICE)
    suite = make_suite(mt, num_classes, LEDGER_DEVICE)
    result = {"role": role, "context_s": time.perf_counter() - t_start}

    def first_update():
        t0 = time.perf_counter()
        suite.update(preds, target)
        settle(suite)
        return (time.perf_counter() - t0) * 1e3

    # the selection table first: its digest is part of every program's key, so programs are stored (and
    # found) under the table they will serve with
    if role == "cold":
        result["first_update_ms"] = first_update()
        result["winner"] = autotune.ensure("binned_counts", scores, onehot, thresholds)
        result["precompile"] = suite.precompile(preds, target, defer_chunks=CACHE_CHUNKS)
    else:
        binned.binned_curve_counts(scores, onehot, thresholds)
        t0 = time.perf_counter()
        if role == "warm":
            rows = CACHE_ACQUIRE_ROWS
            result["acquire"] = suite.precompile(preds[:rows], target[:rows], defer_chunks=CACHE_CHUNKS)
            result["warmed_programs"] = engine.warm_programs()
        else:
            result["precompile"] = suite.precompile(preds, target, defer_chunks=CACHE_CHUNKS)
        torch.cuda.synchronize()
        result["boot_ms"] = (time.perf_counter() - t0) * 1e3
        result["first_update_ms"] = first_update()
        if role == "warm":
            result["precompile"] = suite.precompile(preds, target, defer_chunks=CACHE_CHUNKS)
    stats = engine.engine_stats()
    result.update({k: v for k, v in stats.items() if k.startswith(("progcache_", "autotune_"))})
    with open(out_path, "w") as fh:
        json.dump(result, fh)


def fleet_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """(e) one rank of the two-rank Gloo world on the card (CUDA tensors); rank 1's pack sleeps FLEET_SLOW_S."""
    import torch.distributed as dist

    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import fleetobs, telemetry
    from metrics_tpu_torch.parallel import bucketing

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        telemetry.set_telemetry(True)
        if rank == 1:
            collect = bucketing._collect

            def slow_collect(nodes):
                time.sleep(FLEET_SLOW_S)
                return collect(nodes)

            bucketing._collect = slow_collect
        suite = make_suite(mt, 128, LEDGER_DEVICE)
        for preds, target in make_batches(2048, 128, 2, seed=265 + rank, device=LEDGER_DEVICE):
            suite.update(preds, target)
        for _ in range(3):
            suite.sync()
            suite.unsync()
        snap = fleetobs.fleet_snapshot()
        result = {"snap": snap, "text": fleetobs.fleet_prometheus_text(snap), "perf": fleetobs.fleet_perf_report()}
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"fleet{rank}.pt"))


def ledger_cache_fleet(mt, card: str) -> dict:
    """(d) the program cache across three fresh processes on the card, one after the other, while (e) the
    two-rank Gloo world of the fleet plane runs beside them; then a world of one's fleet_health."""
    import multiprocessing as mp

    from metrics_tpu_torch.parallel import collective_stats

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        ranks = [ctx.Process(target=fleet_rank, args=(r, 2, init_method, tmp)) for r in range(2)]
        for p in ranks:
            p.start()
        cache = {}
        try:
            for role in ("cold", "warm", "control"):
                child = ctx.Process(target=cache_child, args=(role, os.path.join(tmp, "store"),
                                                              os.path.join(tmp, f"{role}.json")))
                child.start()
                child.join(LEDGER_PHASE_S)
                if child.is_alive():
                    child.kill()
                    child.join(10)
                assert child.exitcode == 0, f"progcache {role} process: exit code {child.exitcode}"
                cache[role] = json.load(open(os.path.join(tmp, f"{role}.json")))
        finally:
            deadline = time.monotonic() + FLEET_WORLD_S
            for p in ranks:
                p.join(max(0.0, deadline - time.monotonic()))
            for p in ranks:
                if p.is_alive():
                    p.kill()
                p.join(10)
        assert all(p.exitcode == 0 for p in ranks), f"fleet world: exit codes {[p.exitcode for p in ranks]}"
        fleet = [torch.load(os.path.join(tmp, f"fleet{r}.pt")) for r in range(2)]
    cold, warm, control = cache["cold"], cache["warm"], cache["control"]
    stored = cold["precompile"]["progcache_stores"]
    # the warm boot ran every stored shape of the suite's programs before its first update, and found them
    # all again in precompile; the table was restored, not swept
    assert stored > 0 and warm["warmed_programs"] == stored, (cold, warm)
    assert warm["precompile"]["compiles"] == 0 and warm["autotune_restores"] > 0 and warm["autotune_sweeps"] == 0
    assert control["progcache_hits"] == 0 and control["progcache_stores"] == 0, control
    log(f"progcache (d) three fresh processes, first headline update: cold {cold['first_update_ms']:.2f} ms (store "
        f"on, nothing warmed); warm {warm['first_update_ms']:.2f} ms (store on: precompile of {CACHE_ACQUIRE_ROWS}-row "
        f"batches and warm_programs, {warm['warmed_programs']} stored signatures warmed, boot {warm['boot_ms']:.2f} "
        f"ms); control {control['first_update_ms']:.2f} ms (store off: precompile of the update's shapes, boot "
        f"{control['boot_ms']:.2f} ms); the store's share is warm against control. Cold stored "
        f"{cold['progcache_stores']} signatures ({cold['progcache_bytes_stored']} bytes); warm progcache_hits "
        f"{warm['progcache_hits']}, autotune_restores {warm['autotune_restores']}, autotune_sweeps "
        f"{warm['autotune_sweeps']} (cold winner {cold['winner']})  [{card}]")
    for rank, res in enumerate(fleet):
        snap = res["snap"]
        assert snap["gathered"] and snap["world_size"] == 2 and snap["rank"] == rank
        assert snap["stragglers"]["phases"]["sync-pack"]["slowest_rank"] == 1, snap["stragglers"]["phases"]
        assert 1 in snap["stragglers"]["stragglers"], snap["stragglers"]
        assert 'metrics_tpu_fleet_straggler_flagged{rank="1"} 1' in res["text"]
        assert res["perf"]["gathered"] and sorted(res["perf"]["reports"]) == [0, 1]
    assert fleet[0]["snap"]["aggregate"] == fleet[1]["snap"]["aggregate"]
    suite = make_suite(mt, 128, LEDGER_DEVICE)
    before = collective_stats()
    health = suite.fleet_health()
    assert collective_stats() == before and not health["gathered"] and health["world_size"] == 1
    pack = fleet[0]["snap"]["stragglers"]["phases"]["sync-pack"]
    log(f"fleet (e) two Gloo ranks on one card: rank 1 slowed {FLEET_SLOW_S * 1e3:.0f} ms a pack; sync-pack means "
        f"{pack['per_rank_mean_s']} s, slowest rank {pack['slowest_rank']}, stragglers "
        f"{fleet[0]['snap']['stragglers']['stragglers']}; {len(fleet[0]['text'].splitlines())} exposition lines; "
        f"fleet_health of a world of one issued 0 collectives  [{card}]")
    return {"cache": cache, "fleet_stragglers": fleet[0]["snap"]["stragglers"]["stragglers"],
            "fleet_pack_means": pack["per_rank_mean_s"], "card": card}


def planes_ledger_autotune(mt, checks, histogram, card: str) -> dict:
    """Phase 26: the performance, fleet, program-cache and autotuner planes on the card (under LEDGER_PHASE_S)."""
    from metrics_tpu_torch.ops import autotune

    t0 = time.perf_counter()
    result = {"ledger": ledger_perf(mt, checks, histogram, card)}
    autotune.configure(enabled=True, reset=True)
    try:
        result["binned"] = tune_binned(histogram, card)
        result["sorts_fid_map"] = tune_sorts_fid_map(mt, card)
    finally:
        autotune.configure(reset=True)
    result["cache_fleet"] = ledger_cache_fleet(mt, card)
    result["kernel_launches"] = (result["ledger"]["kernel_launches"] + result["binned"]["sweep_launches"]
                                 + result["binned"]["selected_launches"])
    result["seconds"] = time.perf_counter() - t0
    log(f"planes (26): phase 26 took {result['seconds']:.1f} s  [{card}]")
    assert result["seconds"] <= LEDGER_PHASE_S, f"phase 26 took {result['seconds']:.1f} s of its {LEDGER_PHASE_S} s"
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import _native, histogram
    from metrics_tpu_torch.utils import checks

    if HERE not in Path(mt.__file__).resolve().parents:
        raise RuntimeError(f"metrics_tpu_torch was imported from {mt.__file__}, not from this checkout")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, device {kind}")
    build_s = build_kernels(_native, histogram)

    phase_s = {}

    def timed_phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t0
        return out

    max_abs_err = timed_phase("bincount_check", check_bincount, histogram)
    sweep = timed_phase("bincount_sweep", sweep_bincount, histogram, card)
    log(json.dumps({"bincount_sweep": sweep, "card": card}))
    kernel = kernel_entry(sweep, max_abs_err)
    batched_err = timed_phase("bincount_batched_check", check_batched_bincount, histogram)
    batched_sweep = timed_phase("bincount_batched_sweep", sweep_batched_bincount, histogram, card)
    log(json.dumps({"bincount_batched_sweep": batched_sweep, "card": card}))
    batched = batched_kernel_entry(batched_sweep, batched_err)
    main = timed_phase("main", main_path, mt, checks, histogram, card)
    large = timed_phase("large_l", large_l_path, mt, histogram)
    multilabel = timed_phase("multilabel", multilabel_path, mt, histogram)
    agreement = timed_phase("agreement", agreement_path, mt, checks, histogram, card)
    segmentation = timed_phase("segmentation", segmentation_path, mt, checks, histogram, card)
    aggregation = timed_phase("aggregation", aggregation_path, mt, checks, card)
    curves = timed_phase("curves", curves_path, mt, checks, histogram, card)
    evaluation = timed_phase("eval_11_14", eval_paths, mt, checks, histogram, card)
    wrappers_image = timed_phase("wrappers_image_15_16", wrapper_image_paths, mt, checks, histogram, card)
    generative_detection = timed_phase("generative_detection_17_18", generative_detection_paths, mt, checks,
                                       histogram, card)
    text_audio = timed_phase("text_audio_19_20", text_audio_paths, mt, histogram, card)
    sync = timed_phase("sync", sync_path, mt, histogram, card)
    observability = timed_phase("observability_journal", observability_path, mt, checks, histogram, card)
    sync_planes = timed_phase("sync_planes", sync_planes_path, mt, checks, histogram, card)
    engine_result = timed_phase("engine", engine_path, mt, checks, histogram, card)
    funcore = timed_phase("functional_core", functional_core_path, mt, checks, histogram, card)
    tenants = timed_phase("tenant_planes", tenant_planes_path, mt, checks, histogram, card)
    planes26 = timed_phase("planes_ledger_autotune", planes_ledger_autotune, mt, checks, histogram, card)
    log(f"phase seconds: {json.dumps(phase_s)}")
    # each path's first timed run in mode "first", the curve paths' first runs and weighted areas, the
    # retrieval path's first compute() and graded NDCG, the wrapper phase's first timed runs, and the
    # sync phase's updates, counted from 0 just before each
    kernel["launches"] = sum(p["first"]["kernel_launches"] for p in (main, agreement, segmentation))
    kernel["launches"] += (curves["kernel_launches"] + evaluation["kernel_launches"]
                           + wrappers_image["kernel_launches"] + generative_detection["kernel_launches"]
                           + text_audio["kernel_launches"] + sync["kernel_launches"]
                           + observability["kernel_launches"] + sync_planes["kernel_launches"]
                           + engine_result["kernel_launches"] + funcore["kernel_launches"]
                           + tenants["kernel_launches"] + planes26["kernel_launches"])
    # the batched form: phase 15's fused wrapper paths, phase 24 (c)'s vmapped suites and phase 25's arenas,
    # counted from 0 just before each
    batched["launches"] = (wrappers_image["wrappers_imagenet"]["batched_launches"] + funcore["batched_launches"]
                           + tenants["batched_launches"])

    log(json.dumps({"build_s": build_s, "main_path": main, "large_l_path": large, "multilabel_path": multilabel,
                    "agreement_path": agreement, "segmentation_path": segmentation, "aggregation_path": aggregation,
                    "curves_path": curves, "eval_paths": evaluation, "wrapper_image_paths": wrappers_image,
                    "generative_detection_paths": generative_detection, "text_audio_paths": text_audio,
                    "sync_path": sync, "observability_journal": observability, "sync_planes": sync_planes,
                    "engine": engine_result, "functional_core": funcore, "tenant_planes": tenants,
                    "planes_ledger_autotune": planes26, "phase_seconds": phase_s}))
    log(json.dumps({"kernels": [kernel, batched]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
