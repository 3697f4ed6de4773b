#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device of compute
capability (9, 0) and the CUDA toolkit (``nvcc``).  Phases, in order:

  1. device  — refuse without CUDA; print ``nvidia-smi``'s name and
     power limit of the card;
  2. build   — compile the hand-written kernels from ``src/repro_torch/
     kernels/csrc`` with nvcc for sm_90a, one process per source;
  2a. dry-run + hw — start the ``[dryrun]`` cells (``python -m
     repro_torch.launch.dryrun`` on the production meshes at full size,
     one subprocess a cell on the host, no card: deepseek-7b train_4k and
     qwen2-72b prefill_32k on 16x16, mamba2-1.3b decode_32k on 2x16x16,
     deepseek-7b decode_32k as ``dedup_serving`` and
     ``dedup_serving_dense_ref``, qwen3-14b long_500k skipped with the
     reference's reason), read back after 7c; ``[hw]``: the card's name
     and power limit, its bf16 GEMM rate (8192^3, ``torch.matmul``) and
     device-to-device copy bandwidth beside the roofline's ``HW``;
  2b. index  — the word2vec store below built twice, its Alg.-1 index
     signed on the card (``index_mode="cuda"``, the ``lsh_signature``
     kernel) and on the host (the reference's numpy routine): equal
     block maps, distinct blocks, pages and committed page hashes;
     then reopened live and one variant updated (Sec. 7.6, Approach 2:
     ``rebuild_index`` + ``update_model``) in both modes: equal block
     maps;
  3. kernels — at the main path's shapes, hold each kernel against its
     plain PyTorch version (``dedup_embedding`` bit-exact,
     ``dedup_matmul`` within 1e-4 in fp32 and 6e-2 in bf16, the same
     bits from two calls) and time kernel, plain version and one PyTorch
     library call with CUDA events; each line names the body that ran
     (``variant``: wgmma or fma) and ``dedup_matmul``'s K splits; a
     ``[matmul-splits]`` line times it with the split forced to 1-32; a
     ``[gather-shapes]`` line times ``dedup_embedding`` (both index
     instances, idx32 and idx64, forced) and ``flat_rows[idx]`` at the
     serving shape and at 65,536 ids over a 335 MB slab, each with its
     byte bound and the share of it reached; ``[split-dot]``: the exact
     bf16 split of an fp32 operand (``split_bf16x3``) bit-equal to its
     plain version, and ``dot``'s split3 route as close to float64 as
     SPLIT_ERR_LIMIT times the FFMA GEMM (TF32 off), a limit that two
     controls (x0 alone, x0 + x1) fail, at the benchmark cells' ``wo``
     shapes, each piece timed beside the FFMA GEMM;
  4. serving — the main path: the word2vec scenario at d = 300 (vocab
     32,768, 4 variants, 64x64 blocks, 8 blocks a page) committed to
     SQLite through ``DedupDB``, reopened live and served through the
     device slab and the CUDA kernels, 40 batches of 32 documents;
     every batch's logits within 1e-5 of a host-mode run of the same
     traffic on the same database;
  5. FFNN    — ``WeightServer.device_matmul`` on the paper's FFNN store
     (x [64, 2048] against W1 [2048, 256]) within 1e-4 of numpy;
     then the serving pass once more under torch.profiler: device-busy
     share and device time by kernel;
  5b. traffic — the request tier on the same database: an open-loop
     stream (Zipf 1.1 over the 4 variants, 4 documents a request, batches
     of up to 8) through ``ServingFrontend`` (SLO policy, deterministic
     compute model) over a cuda-mode engine (``[traffic]``): the same
     dispatches and ledger as a host-mode frontend on the same stream,
     logits within 1e-5, served + shed == offered, the ledger and the
     tracer's clock conserved, no dense fallback; then ``[restart]``: the
     cuda run stopped after a few dispatches, only its snapshot file kept,
     restored into a fresh cuda engine: no request served on both sides,
     every request's logits bit-equal to the uninterrupted run;
  5c. shards — the sharded slab on the same database: the 40 batches in
     order (overlap on, prefetch off) through ``DedupDB.serve_embedding
     (shards=n, placement=p)`` in cuda mode at 2 and 4 shards under both
     placements, each at the smallest per-shard capacity at which every
     batch's routed owned and borrowed page sets fit (derived from the
     store and the traffic, printed), held against the single slab in
     the same order and the host-mode sharded run (logits 1e-5, every
     batch on the device, the route and borrow counters equal); under
     ``hash`` pages are borrowed and gathers read the staging tail, and
     ``[shards-kernels]`` holds ``dedup_embedding`` at one such map
     against its plain version; the 2-shard ``sharers`` run again with
     shard 0 failed at batch 13 and revived at 26 (logits 1e-5 of the
     unfailed run, one failover, orphaned pages counted as store
     faults); ``stacked_slab()`` against the shards' resident pages; the
     FFNN ``device_matmul`` over 2 ``hash`` shards (staged W1 blocks)
     against the single slab and, at that input, ``dedup_matmul``
     against its plain version in fp32 and bf16; then ``[cli-shards]``:
     ``python -m repro_torch.launch.serve --shards 2 --placement hash
     --models 4`` with the embedding and the LM engine, each exiting 0
     with ``borrows=`` > 0;
  5d. sanitize — the port's ``PoolSanitizer`` (strict, attached by
     instance to the servers' pools alone, the buffer pools' callbacks
     pointed at the wrapped methods) on a cuda-mode ``WeightServer`` of
     the same store and a 2-shard ``hash`` ``ShardedWeightServer`` at
     the ``[shards]`` phase's capacity: 8 batches each through the
     embedding engine (``dedup_embedding``) and ``device_matmul`` on the
     FFNN store (``dedup_matmul``): 0 violations, logits and products
     bit-equal to the same batches on uninstrumented servers, events
     and per-batch wall time with and without printed; then three
     faults injected on cuda-mode ``DevicePagePool``s (a stale remap
     into ``gather_rows``, a load that skips the generation bump, a
     cross-pool map into ``virtual_matmul``), each of which must raise
     ``PoolSanitizerError`` before its kernel launches;
  5e. pressure — the paper's working set larger than the memory that
     holds it: the 40 batches at a slab of half the store (177 of 355
     pages; a batch touches ~321) in cuda mode, each through the slab's
     32-page staging tail and ``dedup_embedding``, with
     ``store.materialize`` refused: logits within 1e-5 of host mode and
     of dense numpy logits (computed once, before), the pool's hit flags,
     loads, evictions and every ServeStats field but the wall-clock
     ones equal to host mode's; the same over 2 hash shards of 88 pages
     (owned groups and borrow sets past their shard, through its
     overflow rows); each cuda run again under the strict PoolSanitizer
     (0 violations, bit-equal); the FFNN product at a slab of half W1's
     pages (K ranges through the tail) within 1e-4 of numpy; staged
     pages, tail writes, chunks, slab and tail bytes and wall time
     printed; ``[pressure-split]``: the single slab's first 10 batches
     in cuda mode at tails of 8, 32 and 64 pages, the host time split by
     step (per-page loads,
     the next batch's prestage, tail writes, the kernel's wrapper), and
     ``[pressure-profile]``: once more under torch.profiler;
  5f. examples — the port's four examples (``examples/torch_*.py``) as
     subprocesses on the card and with ``--device cpu``, all at once:
     each exits 0 and prints the CPU run's deterministic lines
     (``torch_train_tiny`` at ``--steps 20``, not its 200, for time;
     its losses within 1e-3); beside them ``[cli-lm-half]``: ``python
     -m repro_torch.launch.serve --engine lm --vocab 512
     --capacity-pages 0`` (the reference CLI's half-the-store
     expression; its default, 24 pages, holds the whole store) in cuda
     mode and on the CPU: the same store and greedy tokens (the
     ``[tokens]`` digest), the switches through the staging tail;
  6. LM      — deepseek-7b at full width (d_model 4096, 32 heads of 128,
     d_ff 11008; depth cut 30 -> 2, vocabulary 102,400 -> 32,768), two
     variants that differ in layer 1's feed-forward weights, registered
     twice, with the index signed on the card and on the host (equal
     block maps, distinct blocks and pages; each build's split printed),
     the card's committed to SQLite as per-layer 2-D tensors in 64x64
     blocks and served through
     ``DedupDB.serve_lm`` in cuda mode: 8 batches alternating the
     variants, 4 prompts of 512 tokens and 16 greedy steps each, every
     batch a model switch whose prefill runs ``flash_attention`` (its
     tensor-core body, asserted).  The kernel is held against its plain
     version at the path's shape (bf16), at head dims 64 and 256 with a
     window and the softcap (bf16) and at the reference's four test
     shapes (fp32), and timed beside SDPA at four more bf16 shapes
     (``[flash-shapes]``); the same traffic in
     torch mode on the card (plain attention) gives last-token prefill
     logits within the stated bf16 tolerance, and one batch rerun in fp32
     gives the same greedy tokens in both modes.  ``lsh_signature`` is
     held against its plain version at one chunk of the LM store
     ([65,536, 4096], 64 hashes, r = 0.25, the real weights), at the
     CLI's LM store ([n, 1024], 16 hashes, r = 4) and at the reference's
     three test shapes, and timed at the chunk (``[lsh-bodies]`` times
     both bodies, tf32x3 and fma, at the chunk and the CLI's shape, each
     with its bound); every launch of the word2vec and LM store builds
     must have taken the tf32x3 body; every block of lm-v0 is
     signed by the build's routine and held against the plain version
     on the card and, on a sample of 20,480 blocks, against the
     reference's per-block numpy signatures.  Signatures may differ only
     where the exact value lies within 1e-4 of a bucket edge (each line
     prints how many hashes lie there and how many of them differ);
     ``flash_attention``'s fp32-out epilogue (the prefill's call: q scaled
     in fp32 and rounded to bf16, scale 1) is held against the plain
     version at the path's shape and timed beside the bf16 one; then
     ``[lm-traffic]``: LM requests (1 prompt of 512 tokens, 16 greedy
     steps) behind the SLO frontend on the cuda-mode engine of the same
     store, every prefill on the wgmma body, each request's tokens equal
     to a direct ``generate`` of its dispatched batch;
  6b. cli-traffic — ``python -m repro_torch.launch.serve --traffic ...
     --snapshot ... --kill-after 3`` on the card, then resumed:
     ``[restart] resumed from``, offered == served + shed == 40 and
     ``dense_fallbacks=0``;
  7. the other families — ``[flash-families]``: ``flash_attention`` at
     their full-width shapes (hymba's 25 / 5 heads of 64 with and without
     a 1024-key window, phi-3-vision's hd 96, kimi-k2's hd 112, arctic's
     56 / 8, whisper's non-causal encoder and cross-attention over 1500
     keys), bf16, each against its plain version and timed beside its
     bound and SDPA; ``[lm-hybrid]`` (the slice's path): hymba-1.5b at
     full width, depth cut 32 -> 4 (global layers 0, 2, 3; a 1024-token
     window on layer 1), two variants (v1 redraws the last layer's MLP
     and mamba projections) built with the index signed on the card and
     committed to SQLite, served through ``DedupDB.serve_lm`` in cuda
     mode: 4 batches alternating the variants, 2 prompts of 2048 tokens
     and 16 greedy steps, every batch on the device and 16
     ``flash_attention`` launches on the wgmma body; torch mode on the
     card gives prefill logits within ``LM_LOGIT_TOL`` and one batch in
     fp32 the same greedy tokens; prefill / decode times and a profile
     (``[hy-profile]``); ``[families]``: every arch at its reduced config
     in fp32, prefill of 24 tokens and 3 decode steps through the kernel
     route against the plain attention (logits 1e-4, tokens equal; whisper
     takes frames, phi-3-vision ``image_embeds``); ``[encdec]``:
     whisper-small at full size in bf16 (12 + 12 layers, 1500 frames, an
     8-token prompt, 16 steps) through ``registry.build``, prefill logits
     within ``LM_LOGIT_TOL`` of the plain attention, fp32 tokens equal;
  6a. finetune — paper Sec. 4.3 on the LM store: lm-v1's dedup
     gradient masks (1 on blocks private to v1) mapped through
     ``lm_tensors``' ``rebuild`` onto its fp32 params taken from the
     store, 3 Adafactor steps (B 2 x S 256) with the masks as the train
     step's ``grad_transform``, every masked element bit-equal to
     ``store.materialize``; then ``store.update("lm-v1", tuned,
     approach=2)`` (v1's blocks signed again by ``lsh_signature``) and
     the pages rewritten at most the pages that held a private block;
  7b. training — deepseek-7b at full width (vocabulary 102,400), depth
     cut 30 -> 4, bf16, remat, AdamW, B 4 x S 512, through the port's
     ``launch.train.train``: ``[train]`` (20 ``--overfit`` steps, every
     loss finite, the last 5 at least 0.5 below the first 5; step ms
     median and spread, tokens/s, peak memory), ``[train-split]`` (fwd +
     bwd against ``opt.update``), ``[train-profile]`` (device busy share
     and top device ops of 3 steps), ``[train-resume]`` (at depth 2: 6
     steps, and 3 checkpointed then resumed with ``--resume auto``:
     losses within 1e-3) and ``[train-compress]`` (depth 2,
     ``--compress-grads``: the last loss within 0.25 of the uncompressed
     run's); ``ops.LAUNCHES`` before and
     after: training launches no kernel (the loss runs the plain
     attention, as the reference's does);
  7c. distribution — ``[pipeline]``: ``pipeline_apply`` (GPipe, 2
     stages of 2 of deepseek-7b's full-width layers on ``cuda:0``, 4
     microbatches of 1 x 512, prefill through ``flash_attention``):
     bit-equal to the unpipelined forward, 16 launches, bubble 0.2;
     ``[dist-step]``: the train step the dry-run traces, run for real on
     a (1, 1) ``("data", "model")`` mesh over a one-rank NCCL group,
     params and AdamW state as DTensors placed by ``param_specs`` /
     ``state_specs``: 3 losses equal to ``[train]``'s first 3; then the
     ``[dryrun]`` lines (status, mesh, per-device FLOPs, bytes,
     collective bytes by kind, argument bytes, dominant term,
     useful_flops_ratio); ``[slab-mesh]`` runs inside 5c:
     ``stacked_slab(make_shard_mesh(4))`` of the 4-shard store, its
     local tensor bit-equal to the per-shard stack and a
     ``dedup_embedding`` gather through it equal to each shard's own;
  8. a ``{"kernels": [...]}`` line with every ported kernel's launches
     on its path (phases 2b, 4, 5, 5b-5e, 6, 6a, 7 and 7c), its times
     and its bound;
  9. last line: ``{"ok": true, "device": {...}}``.

Every check raises on failure (the script catches nothing), so any
failed phase ends the run with a non-zero exit code and no result line.
The JAX package is never imported.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores (the kernels stay in IEEE fp32: no TF32), bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

VOCAB, D, VARIANTS, BATCHES, DOCS = 32768, 300, 4, 40, 32
SEED = 0
# LM phase: deepseek-7b at full width, depth cut 30 -> 2 and vocabulary
# 102,400 -> 32,768: at the full vocabulary the host's Alg.-1 build and
# SQLite commit of the two variants took 248 s on the card's host
LM_ARCH, LM_DEPTH, LM_VOCAB = "deepseek-7b", 2, 32768
LM_BATCHES, LM_PROMPTS, LM_PROMPT_LEN, LM_STEPS = 8, 4, 512, 16
# last-token prefill logits, cuda mode (flash_attention's tensor-core
# body) against torch mode (plain attend), both bf16 models.  Both round
# q the same way (scaled in fp32, then cast to bf16) and keep the
# attention output in fp32; they differ where each rounds p to bf16 (the
# kernel after each 64-key tile's running max, attend after the row's
# final max), in summation order and in ex2.approx, which the layers
# after attention carry into the logits.  Twice the 4.85e-2 measured
# once q's and O's extra bf16 roundings were gone (max |logit| 6.71;
# 7.7e-2 to 8.2e-2 before, when the bound was 0.15); each run also
# prints both modes' distance from the fp32 model on one batch
LM_LOGIT_TOL = 0.097
# the reference's four flash shapes (tests/test_kernels.py), in fp32
FLASH_CASES = [(2, 64, 64, 4, 2, 16, True, 0, 0.0),
               (1, 32, 48, 4, 4, 8, True, 16, 30.0),
               (2, 16, 64, 2, 1, 16, False, 0, 0.0),
               (1, 48, 48, 8, 2, 32, True, 0, 50.0)]
# the tensor-core body at the other head dims (gemma2's 256, hymba's 64),
# bf16, with a window and the softcap: (B, Sq, Skv, H, K, hd, window, cap)
FLASH_BF16_CASES = [(2, 512, 512, 8, 4, 64, 128, 50.0),
                    (2, 512, 512, 8, 4, 256, 128, 50.0)]
# flash_attention beside SDPA at shapes around the LM's, bf16 (timed only):
# (label, B, S, H, hd, causal)
FLASH_SHAPES = [("lm-noncausal", 4, 512, 32, 128, False),
                ("lm-b16", 16, 512, 32, 128, True),
                ("hd64", 4, 512, 64, 64, True),
                ("hd256", 4, 512, 16, 256, True)]
# flash_attention at the other families' full-width shapes, bf16 (the
# wgmma body), each held against the plain version (2e-2) and timed beside
# SDPA where SDPA computes the same function (no window): (label, B, Sq,
# Skv, H, K, hd, causal, window)
FAMILY_FLASH = [("hymba-local", 2, 2048, 2048, 25, 5, 64, True, 1024),
                ("hymba-global", 2, 2048, 2048, 25, 5, 64, True, 0),
                ("phi3v", 1, 2048, 2048, 32, 32, 96, True, 0),
                ("kimi-k2", 1, 2048, 2048, 64, 8, 112, True, 0),
                ("arctic", 1, 2048, 2048, 56, 8, 128, True, 0),
                ("whisper-enc", 1, 1500, 1500, 12, 12, 64, False, 0),
                ("whisper-cross", 1, 8, 1500, 12, 12, 64, False, 0)]
# dedup_matmul at the FFNN shape with the K split forced (timed only)
MATMUL_SPLITS = (1, 4, 8, 16, 32)
# dedup_embedding at a bytes-bound shape (timed only): ids over a slab of
# 262,144 rows at width 300 fp32 in 64x64 blocks (335 MB; out 79 MB)
GATHER_IDS, GATHER_ROWS = 65536, 262144
# the reference's three lsh_signature shapes (n, dim, hashes, r)
LSH_CASES = [(16, 64, 16, 2.0), (33, 100, 24, 4.0), (128, 512, 128, 1.0)]
# blocks of lm-v0 held against the reference's per-block numpy signatures
LSH_SAMPLE = 20480
# the hybrid phase (the slice's path): hymba-1.5b at full width (d_model
# 1600, 25 heads over 5 KV heads of 64, d_ff 5504, Mamba-2 SSD with 50
# heads of 64 and a state of 16, vocabulary 32,001), depth cut 32 -> 4,
# which leaves global layers 0, 2, 3 and a 1024-token window on layer 1;
# 4 batches alternating two variants, 2 prompts of 2048 tokens, 16 steps
HY_ARCH, HY_DEPTH = "hymba-1.5b", 4
HY_BATCHES, HY_PROMPTS, HY_PROMPT_LEN = 4, 2, 2048
# every arch at its reduced config in fp32: prefill of 24 tokens, 3 steps
FAM_PROMPT_LEN, FAM_STEPS, FAM_LOGIT_TOL = 24, 3, 1e-4
# whisper-small at its full size in bf16: 1 x 1500 frames, an 8-token
# prompt, 16 greedy steps, through registry.build
ED_ARCH, ED_FRAMES, ED_PROMPT_LEN, ED_MAX_DEC = "whisper-small", 1500, 8, 448
# the request tier on the word2vec store: open-loop requests of 4
# documents of 16 tokens, Zipf over the 4 variants, batches of up to 8
# requests (a full dispatch is the serving shape, 32 x 16 ids); the ssd
# preset and a deterministic compute model put fetch and compute on the
# virtual clock, so the cuda and host runs decide alike.  The rate closes
# full batches and the Zipf tail's queues are forced; the SLO covers a
# cold engine's first fetch (~300 pages, ~80 ms at the ssd preset), so a
# frontend restored into a fresh engine sheds no more than the
# uninterrupted one (below that, its cold pools shed what the warm run
# serves)
TRAFFIC_REQUESTS, TRAFFIC_DOCS, TRAFFIC_MAX_BATCH = 96, 4, 8
TRAFFIC_RATE, TRAFFIC_SLO_MS, TRAFFIC_ZIPF = 800.0, 400.0, 1.1
TRAFFIC_COMPUTE = (2e-3, 1e-4)            # seconds a batch, a request row
RESTART_AFTER = 5                          # dispatches before the "crash"
# the request tier on the LM store: 1 prompt of 512 tokens, 16 greedy
# steps a request; every model switch costs ~10 s on the host
LM_TRAFFIC_REQUESTS, LM_TRAFFIC_MAX_BATCH = 8, 4
LM_TRAFFIC_RATE, LM_TRAFFIC_SLO_MS = 20.0, 60000.0
# training: deepseek-7b at full width (vocabulary 102,400 not cut: training
# builds no store), depth cut 30 -> 4 (at full depth its bf16 params and
# grads and fp32 AdamW moments take 82.9 GB, more than the card's 80),
# bf16, AdamW, B 4 x S 512; 20 --overfit steps, a 6-step run broken at 3
# and resumed, the same 6 steps with --compress-grads
TRAIN_DEPTH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 4, 512, 3e-4
TRAIN_STEPS, RESUME_STEPS, RESUME_AT, TRAIN_SPLIT_STEPS = 20, 6, 3, 3
# the resume and compression runs at depth 2 (time: the script's limit)
RESUME_DEPTH = 2
# the dedup-masked fine-tune (paper Sec. 4.3) of lm-v1 on the LM store,
# fp32, Adafactor (weight decay 0: a zero gradient makes a zero update)
FT_STEPS, FT_BATCH, FT_SEQ = 3, 2, 256
DEVICE = "cuda"
# the CLI's traffic run on the card, killed and resumed
CLI_TRAFFIC = "rate=400,requests=40,slo_ms=200,max_batch=4"
# the PoolSanitizer's phase: batches served on each instrumented server
SANITIZE_BATCHES = 8
# the sharded slab on the word2vec store: the 40 batches in order, overlap
# on, prefetch off (it reads the host clock), at 2 and 4 shards under both
# placements; the 2-shard sharers run again with shard 0 failed at batch 13
# and revived at batch 26
SHARD_COUNTS, SHARD_FAIL, SHARD_REVIVE = (2, 4), 13, 26


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(torch, fn, reps: int = 200, warm: int = 10) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back eager
    calls, after ``warm`` untimed ones (CUDA events on the current
    stream).  For a short kernel this is the host's issue rate: the
    Python wrapper, not the device, sets it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, calls: int = 20, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between two events,
    so the host's issue cost stays out.  Inputs stay L2-warm."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                     # load modules, warm caches
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def timings(torch, kernel, plain, library):
    """Device (graph) and eager milliseconds of the three callables."""
    out = {}
    for key, fn in (("kernel", kernel), ("plain", plain),
                    ("library", library)):
        out[f"{key}_ms"] = graph_ms(torch, fn)
        out[f"{key}_eager_ms"] = eager_ms(torch, fn)
    return out


def bound_ms(nbytes: float, flops: float, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- split dot --
#: the benchmark cells' ``wo`` products: (label, rows, K = N)
SPLIT_SHAPES = (("deepseek-7b", 16384, 4096), ("hymba-1.5b", 16384, 1600))
#: the split3 route's relative Frobenius distance from the float64 product,
#: at most this many times the FFMA GEMM's.  Read on the H100 (two seeds
#: alike): the route 3.86 (deepseek) and 2.26 (hymba) times FFMA's, the
#: same GEMM over x0 + x1 alone 11.4 and 15.2 times, over x0 alone 2,895
#: and 4,634 times; over the parts laid [x0 | x1 | x2] it read 19 and 12
SPLIT_ERR_LIMIT = 6.0


def rel_err(y, exact):
    """||y - exact|| / ||exact|| (Frobenius), ``exact`` in float64."""
    return float((y.double() - exact).norm() / exact.norm())


def split_dot_phase(torch, ops, ref):
    """``split_bf16x3`` and ``dot``'s split3 route at SPLIT_SHAPES: the
    kernel bit-equal to its plain version (inf, NaN and zeros in the
    first row); the route's distance from the float64 product within
    SPLIT_ERR_LIMIT times the FFMA GEMM's, and the same check failing
    two controls over the same split (the GEMM over x0 alone and over
    x0 + x1); the device times of the split (kernel, plain version, the
    chain of torch casts), of the whole route and of the FFMA GEMM it
    replaces.  Returns the deepseek shape's record."""
    from repro_torch.models import layers
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    f32 = torch.float32
    recs = []
    for label, M, K in SPLIT_SHAPES:
        x = torch.randn(M, K, device=dev, generator=g)
        x[0, :4] = torch.tensor([float("inf"), float("nan"), 0.0, -0.0])
        w = (torch.randn(K, K, device=dev, generator=g) * 0.02).bfloat16()
        n0 = ops.LAUNCHES["split_bf16x3"]
        got = ops.split_bf16x3(x)
        want = ref.split_bf16x3(x)
        torch.cuda.synchronize()
        if ops.LAUNCHES["split_bf16x3"] != n0 + 1 or not torch.equal(
                got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"[split-dot] {label}: split_bf16x3 is not "
                                 f"bit-equal to its plain version")
        del want
        x[0, :2] = 0.0
        if layers.dot_route(x, w) != "split3":
            raise AssertionError(f"[split-dot] {label}: dot_route "
                                 f"{layers.dot_route(x, w)}")
        exact = x.double() @ w.double()
        s = ops.split_bf16x3(x)                         # [x2 | x1 | x0]
        with layers._fp32_reduction():
            errs = dict(
                route=rel_err(layers.dot(x, w), exact),
                ffma=rel_err(torch.matmul(x, w.to(f32)), exact),
                x0_only=rel_err(torch.mm(s[:, 2 * K:], w, out_dtype=f32),
                                exact),
                x0_x1=rel_err(torch.mm(s[:, K:], torch.cat([w, w]),
                                       out_dtype=f32), exact))
        del exact, s
        ratio = {k: v / errs["ffma"] for k, v in errs.items()}
        if ratio["route"] > SPLIT_ERR_LIMIT:
            raise AssertionError(f"[split-dot] {label}: the split3 route is "
                                 f"{ratio['route']:.3g} times as far from "
                                 f"float64 as the FFMA GEMM (limit "
                                 f"{SPLIT_ERR_LIMIT})")
        if min(ratio["x0_only"], ratio["x0_x1"]) <= SPLIT_ERR_LIMIT:
            raise AssertionError(f"[split-dot] {label}: a control passes the "
                                 f"limit: {ratio}")

        def chain():
            x0 = x.bfloat16()
            r = x - x0.float()
            x1 = r.bfloat16()
            return torch.cat([(r - x1.float()).bfloat16(), x1, x0], dim=1)

        t = dict(split_ms=graph_ms(torch, lambda: ops.split_bf16x3(x)),
                 plain_ms=graph_ms(torch, lambda: ref.split_bf16x3(x), 5, 5),
                 cast_chain_ms=graph_ms(torch, chain, 5, 5),
                 route_ms=graph_ms(torch, lambda: layers.dot(x, w), 5, 5),
                 ffma_ms=graph_ms(torch, lambda: torch.matmul(x, w.to(f32)),
                                  5, 5))
        nbytes = M * K * (4 + 3 * 2)
        b_ms, b_by = bound_ms(nbytes, 0)
        flops = 2 * M * K * K
        rec = dict(kernel="split_bf16x3", shape=label, variant="one pass",
                   max_abs_err=0.0, route_rel_err=errs["route"],
                   ffma_rel_err=errs["ffma"],
                   route_err_over_ffma=ratio["route"],
                   x0_x1_err_over_ffma=ratio["x0_x1"],
                   x0_only_err_over_ffma=ratio["x0_only"],
                   kernel_ms=t["split_ms"], library_ms=t["cast_chain_ms"],
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   route_tflops=flops / t["route_ms"] * 1e-9,
                   ffma_tflops=flops / t["ffma_ms"] * 1e-9, **t,
                   shapes=f"x [{M}, {K}] fp32 . w [{K}, {K}] bf16")
        log(f"[split-dot] {label} x[{M},{K}] fp32 . w[{K},{K}] bf16: "
            + " ".join(f"{k}={v:.4f}" for k, v in t.items())
            + f" bound_ms={b_ms:.4f} ({b_by}) route_tflops="
            f"{rec['route_tflops']:.1f} ffma_tflops="
            f"{rec['ffma_tflops']:.1f} rel_err vs float64: "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + " over ffma: " + " ".join(f"{k}={v:.2f}" for k, v in
                                         ratio.items() if k != "ffma")
            + f" (limit {SPLIT_ERR_LIMIT}) split bit-equal")
        log(json.dumps({"phase": "kernel-check", **rec}))
        recs.append(rec)
        del x, w
        torch.cuda.empty_cache()
    return recs[0]


# ----------------------------------------------------------------- stores --
def word2vec_store(index_mode):
    from repro_torch.data.pipeline import SyntheticTextTask
    from repro_torch.launch.serve import build_store
    task = SyntheticTextTask(vocab=VOCAB, d=D, seed=SEED)
    store, heads = build_store(task, VARIANTS, index_mode=index_mode)
    return task, store, heads


def block_maps(dedup):
    return {(m, t): e.block_map.copy() for m, r in dedup.models.items()
            for t, e in r.tensors.items()}


def same_maps(a, b, what):
    import numpy as np
    if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                       for k in a):
        raise AssertionError(f"{what}: the block maps of the cuda and the "
                             f"host index build differ")


def all_tf32x3(ops, launches, what):
    """Every lsh_signature launch since the last reset took the tf32x3
    body."""
    bodies = dict(ops.VARIANT_LAUNCHES["lsh_signature"])
    if bodies != {"tf32x3": launches, "fma": 0}:
        raise AssertionError(f"{what}: lsh_signature launches by body "
                             f"{bodies}, not all {launches} on tf32x3")


def index_line(st):
    return (f"blocks={st.blocks} launches={st.launches} "
            f"sign_device={st.sign_device_seconds * 1e3:.2f}ms "
            f"h2d={st.h2d_seconds * 1e3:.2f}ms "
            f"sign_wall={st.sign_wall_seconds:.3f}s "
            f"build={st.build_seconds:.3f}s")


def index_phase(torch, ops, tmpdir):
    """Phase 2b.  The word2vec store built with its index signed on the
    card and on the host, both committed; the card's reopened and one
    variant updated in both modes.  Returns (task, the cuda-built store,
    heads, its database URL, lsh_signature launches in the build and
    update windows)."""
    import numpy as np
    from repro_torch.db import DedupDB
    from repro_torch.storage import open_backend
    # the build window: the counts go to 0 right before, read right after
    ops.reset_launches()
    task, store, heads = word2vec_store("cuda")
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["lsh_signature"]
    all_tf32x3(ops, launches, "word2vec build")
    _, host, _ = word2vec_store("host")
    urls = {m: f"sqlite:///{Path(tmpdir) / f'models-{m}.db'}"
            for m in ("cuda", "host")}
    pages = {m: DedupDB(st, open_backend(urls[m])).commit()["pages"]
             for m, st in (("cuda", store), ("host", host))}
    same_maps(block_maps(store.dedup), block_maps(host.dedup),
              "word2vec build")
    dd, hd = store.dedup, host.dedup
    if (len(dd.distinct), dd.num_distinct, store.num_pages()) != \
            (len(hd.distinct), hd.num_distinct, host.num_pages()) \
            or pages["cuda"] != pages["host"]:
        raise AssertionError("word2vec build: the cuda and host stores "
                             "differ in distinct blocks, pages or "
                             "committed page hashes")
    log(f"[index] word2vec build cuda: {index_line(dd.index_stats)} "
        f"lsh_launches={launches} (all tf32x3)")
    log(f"[index] word2vec build host: {index_line(hd.index_stats)}")
    log(f"[index] word2vec cuda == host: block maps, distinct="
        f"{dd.num_distinct} of {len(dd.distinct)}, pages="
        f"{store.num_pages()}, {len(pages['cuda'])} committed page hashes")

    # Sec. 7.6 update of a reopened store: a further fine-tune of v1
    new = task.variant_embedding(1)
    rng = np.random.default_rng(SEED + 3)
    rows = rng.choice(VOCAB, VOCAB // 12, replace=False)
    new[rows] += (rng.standard_normal((len(rows), D)) * 0.02).astype(
        np.float32)
    maps, stats = {}, {}
    for mode in ("cuda", "host"):
        db = DedupDB.open(urls["cuda"], index_mode=mode)
        ops.reset_launches()
        res = db.update("word2vec-v1", {"embedding": new})
        torch.cuda.synchronize()
        if mode == "cuda":
            launches += ops.LAUNCHES["lsh_signature"]
            all_tf32x3(ops, ops.LAUNCHES["lsh_signature"],
                       "word2vec reopen + update")
        maps[mode] = block_maps(db.store.dedup)
        stats[mode] = (index_line(db.store.dedup.index_stats),
                       res.deduped_blocks, res.total_blocks)
        db.close()
    same_maps(maps["cuda"], maps["host"], "word2vec reopen + update")
    for mode, (line, deduped, total) in stats.items():
        log(f"[index] word2vec-v1 reopen+update {mode}: {line} "
            f"deduped={deduped} of {total}")
    log("[index] word2vec reopen+update cuda == host: block maps")
    return task, store, heads, urls["cuda"], launches


def traffic(task):
    """The CLI's traffic: 40 batches, each of one random variant."""
    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    out = []
    for b in range(BATCHES):
        v = int(rng.integers(0, VARIANTS))
        docs, _ = task.sample(DOCS, variant=v, seed=SEED + 100 + b)
        out.append((f"word2vec-v{v}", docs))
    return out


def ffnn_store(num_models=3, features=2048, hidden=256, labels=512):
    """Paper Sec. 7.1.3: transfer-learning FFNNs sharing W1 exactly."""
    import numpy as np
    from repro_torch.core import (DedupConfig, LSHConfig, ModelStore,
                                  StoreConfig)
    from repro_torch.core.blocks import block_tensor
    from repro_torch.core.lsh import estimate_r
    rng = np.random.default_rng(SEED)
    W1 = (rng.standard_normal((features, hidden)) * 0.05).astype(np.float32)
    blocks, _ = block_tensor(W1, (64, 64))
    cfg = StoreConfig(
        dedup=DedupConfig(block_shape=(64, 64),
                          lsh=LSHConfig(num_bands=16, rows_per_band=4,
                                        r=estimate_r(blocks, quantile=0.5),
                                        collision_threshold=14),
                          validate=False),
        blocks_per_page=8)
    store = ModelStore(cfg)
    for v in range(num_models):
        W2 = (rng.standard_normal((hidden, labels)) * 0.05).astype(np.float32)
        store.register(f"ffnn-{v}", {"W1": W1, "W2": W2,
                                     "b1": np.zeros(hidden, np.float32),
                                     "b2": np.zeros(labels, np.float32)})
    return store


# ---------------------------------------------------------------- phases --
def kernel_phase(torch, ops, ref, slab_blocks: int, ffnn_blocks: int):
    """Each kernel at the main path's shapes against its plain version;
    returns per-kernel records (without main-path launches)."""
    import numpy as np
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    recs = {}

    # dedup_embedding: 512 padded ids (32 docs x 16 tokens), the slab
    # viewed [capacity * 8, 64, 64], the [512, 5] stripe map, width 300
    gh, gw, bh, bw = VOCAB // 64, -(-D // 64), 64, 64
    B = DOCS * 16
    pool = torch.randn(slab_blocks, bh, bw, device=dev, generator=g)
    bmap = torch.randint(0, slab_blocks, (gh, gw), dtype=torch.int32,
                         device=dev, generator=g)
    ids = torch.randint(0, VOCAB, (B,), dtype=torch.int32, device=dev,
                        generator=g)
    n0 = ops.LAUNCHES["dedup_embedding"]
    v0 = dict(ops.VARIANT_LAUNCHES["dedup_embedding"])
    got = ops.dedup_embedding_striped(ids, pool, bmap, width=D)
    want = ref.dedup_embedding_striped(ids, pool, bmap, width=D)
    torch.cuda.synchronize()
    moved = [b for b, c in ops.VARIANT_LAUNCHES["dedup_embedding"].items()
             if c != v0[b]]
    expected = f"idx{ops.gather_index_bits(pool.numel(), B * D)}"
    if moved != [expected] or \
            ops.VARIANT_LAUNCHES["dedup_embedding"][expected] != \
            v0[expected] + 1:
        raise AssertionError(f"dedup_embedding ran {moved}, not the "
                             f"{expected} instance alone")
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"dedup_embedding differs from its plain "
                             f"version: max abs err {err}")
    flat_rows = pool.view(-1, bw)
    idx = (bmap.long()[ids.long() // bh] * bh
           + (ids.long() % bh)[:, None])              # [B, gw], untimed
    ms = timings(
        torch,
        lambda: ops.dedup_embedding_striped(ids, pool, bmap, width=D),
        lambda: ref.dedup_embedding_striped(ids, pool, bmap, width=D),
        lambda: flat_rows[idx].view(B, gw * bw)[:, :D])
    nbytes = ids.numel() * 4 + bmap.numel() * 4 + 2 * B * D * 4
    b_ms, b_by = bound_ms(nbytes, 0.0)
    log(f"[gather-shapes] {gather_shapes(torch, ops, ids, pool, bmap, g)}")
    recs["dedup_embedding"] = dict(
        kernel="dedup_embedding", variant=f"warp-per-row gather, {moved[0]}",
        max_abs_err=err, tolerance="bit-exact",
        **ms, bound_ms=b_ms, bytes=nbytes, flops=0,
        bound_by=b_by, launches=ops.LAUNCHES["dedup_embedding"] - n0,
        shapes=f"ids[{B}] pool[{slab_blocks},{bh},{bw}] bmap[{gh},{gw}] "
               f"width={D}")

    # dedup_matmul: the FFNN shape, x [64, 2048] @ W1 [2048, 256] in
    # 64x64 blocks of the FFNN slab
    M, nkb, nnb = 64, 2048 // 64, 256 // 64
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((M, nkb * 64)).astype(
        np.float32)).to(dev)
    wpool = torch.from_numpy(rng.standard_normal(
        (ffnn_blocks, 64, 64)).astype(np.float32) * 0.05).to(dev)
    wmap = torch.from_numpy(rng.integers(0, ffnn_blocks, (nkb, nnb)).astype(
        np.int32)).to(dev)
    n0 = ops.LAUNCHES["dedup_matmul"]
    errs, plans = {}, {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
        xa, wa = x.to(dtype), wpool.to(dtype)
        plans[dtype] = ops.matmul_plan(M, nkb, nnb, 64, 64, dtype)
        before = dict(ops.VARIANT_LAUNCHES["dedup_matmul"])
        first = ops.dedup_matmul(xa, wa, wmap)
        second = ops.dedup_matmul(xa, wa, wmap)
        got = first.float()
        want = ref.dedup_matmul(xa, wa, wmap).float()
        torch.cuda.synchronize()
        body = plans[dtype].variant
        if ops.VARIANT_LAUNCHES["dedup_matmul"][body] != before[body] + 2:
            raise AssertionError(f"dedup_matmul {dtype} did not run its "
                                 f"{body} body")
        if not torch.equal(first, second):
            raise AssertionError(f"dedup_matmul {dtype}: two calls differ")
        errs[str(dtype)] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"dedup_matmul {dtype} differs from its "
                                 f"plain version by {errs[str(dtype)]}")
    W = ref.materialize_virtual(wpool, wmap, nkb * 64, nnb * 64)
    ms = timings(torch, lambda: ops.dedup_matmul(x, wpool, wmap),
                 lambda: ref.dedup_matmul(x, wpool, wmap), lambda: x @ W)
    distinct = int(torch.unique(wmap).numel())
    nbytes = (x.numel() + distinct * 64 * 64 + M * nnb * 64) * 4 \
        + wmap.numel() * 4
    flops = 2 * M * nkb * 64 * nnb * 64
    b_ms, b_by = bound_ms(nbytes, flops)
    # the bf16 body, timed beside the fp32 one (not on the FFNN path)
    xb, wb, Wb = x.bfloat16(), wpool.bfloat16(), W.bfloat16()
    bf16_ms = {"kernel_ms": graph_ms(torch, lambda: ops.dedup_matmul(
                   xb, wb, wmap)),
               "library_ms": graph_ms(torch, lambda: xb @ Wb)}
    plan, plan16 = plans[torch.float32], plans[torch.bfloat16]
    log(f"[matmul-splits] {split_sweep(torch, ops, x, wpool, wmap)}")
    recs["dedup_matmul"] = dict(
        kernel="dedup_matmul", variant=plan.variant, splits=plan.grid[2],
        blocks=plan.blocks, max_abs_err=errs["torch.float32"],
        max_abs_err_bf16=errs["torch.bfloat16"], bit_equal_calls=True,
        bf16=dict(variant=plan16.variant, splits=plan16.grid[2],
                  blocks=plan16.blocks, **bf16_ms),
        tolerance="1e-4 fp32, 6e-2 bf16", **ms, bound_ms=b_ms,
        bytes=nbytes, flops=flops, bound_by=b_by,
        launches=ops.LAUNCHES["dedup_matmul"] - n0,
        shapes=f"x[{M},{nkb * 64}] pool[{ffnn_blocks},64,64] "
               f"bmap[{nkb},{nnb}] distinct={distinct}")
    for rec in recs.values():
        log(json.dumps({"phase": "kernel-check", **rec}))
    return recs


def gather_shapes(torch, ops, ids, pool, bmap, g) -> str:
    """Device microseconds of dedup_embedding (its 32- and 64-bit index
    instances, forced in turn) and of ``flat_rows[idx]``
    (idx precomputed, untimed) at the serving shape and at GATHER_IDS ids
    over a slab of GATHER_ROWS rows, width D fp32, each with its byte
    bound (ids, map, rows read, rows written) and the share of it the
    kernel reaches.  Timed only."""
    dev = ids.device
    gh = GATHER_ROWS // 64
    big_pool = torch.randn(gh * 5, 64, 64, device=dev, generator=g)
    big_map = torch.randint(0, gh * 5, (gh, 5), dtype=torch.int32,
                            device=dev, generator=g)
    big_ids = torch.randint(0, GATHER_ROWS, (GATHER_IDS,), dtype=torch.int32,
                            device=dev, generator=g)
    out = []
    for label, i, p, m in (("serving", ids, pool, bmap),
                           ("bytes", big_ids, big_pool, big_map)):
        B, gw = i.numel(), m.shape[1]
        flat_rows = p.view(-1, 64)
        idx = m.long()[i.long() // 64] * 64 + (i.long() % 64)[:, None]
        chooser = ops.gather_index_bits
        k_ms = {}
        try:
            for bits in (32, 64):
                ops.gather_index_bits = lambda *a, bits=bits: bits
                k_ms[bits] = graph_ms(torch, lambda: ops.dedup_embedding_striped(
                    i, p, m, width=D))
        finally:
            ops.gather_index_bits = chooser
        l_ms = graph_ms(torch, lambda: flat_rows[idx].view(B, gw * 64)[:, :D])
        b_ms, _ = bound_ms(i.numel() * 4 + m.numel() * 4 + 2 * B * D * 4, 0.0)
        out.append(f"{label} ids[{B}] pool[{p.shape[0]},64,64] "
                   f"({p.numel() * 4 / 1e6:.0f}MB) width={D}: "
                   f"kernel idx32={k_ms[32] * 1e3:.3f}us "
                   f"idx64={k_ms[64] * 1e3:.3f}us flat_rows[idx]="
                   f"{l_ms * 1e3:.3f}us bound={b_ms * 1e3:.3f}us "
                   f"share={b_ms / k_ms[32]:.3f}")
    del big_pool
    return "; ".join(out)


def split_sweep(torch, ops, x, wpool, wmap) -> str:
    """Device microseconds of dedup_matmul at the FFNN shape with the K
    split forced to each of MATMUL_SPLITS (the planner restored after)."""
    planner = ops.matmul_plan
    out = []
    try:
        for dtype in (torch.float32, torch.bfloat16):
            xa, wa = x.to(dtype), wpool.to(dtype)
            row = []
            for want in MATMUL_SPLITS:
                def forced(M, nkb, nnb, bk, bn, dt, want=want):
                    p = planner(M, nkb, nnb, bk, bn, dt)
                    per = -(-nkb // want)
                    n = -(-nkb // per)
                    return p._replace(grid=p.grid[:2] + (n,), per_split=per,
                                      workspace=(n, M, nnb * bn)
                                      if n > 1 else None)
                ops.matmul_plan = forced
                ms = graph_ms(torch, lambda: ops.dedup_matmul(xa, wa, wmap))
                row.append(f"s{want}={ms * 1e3:.2f}us")
            out.append(f"{str(dtype)[6:]}: " + " ".join(row))
    finally:
        ops.matmul_plan = planner
    return "; ".join(out)


def serve(db_url, heads, batches, capacity, kernel_mode):
    """Serve ``batches`` out of the database; (engine, per-batch
    [(model, logits)] in the order served, wall seconds)."""
    from repro_torch.db import DedupDB
    db = DedupDB.open(db_url)
    engine = db.serve_embedding(heads, capacity_pages=capacity,
                                scheduler="dedup_affinity", overlap=True,
                                prefetch=True, compute_backend="device",
                                kernel_mode=kernel_mode)
    served = []
    infer = engine._infer

    def recording_infer(batch):
        out = infer(batch)
        served.append((batch.model, engine.last_logits.copy()))
        return out

    engine._infer = recording_infer
    for model, docs in batches:
        engine.submit(model, docs)
    t0 = time.perf_counter()
    engine.run()
    if kernel_mode == "cuda":
        import torch
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    db.close()
    return engine, served, secs


def profile_serving(torch, url, heads, batches, capacity, tag="[profile]",
                    run=None, top=10) -> None:
    """The main path once more under torch.profiler (after the counted
    run): print the device-busy share of the window and device time by
    kernel.  ``run()`` -> engine replaces the main path's serve."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine = run() if run else serve(url, heads, batches, capacity,
                                         "cuda")[0]
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(r[1] for r in rows)
    log(f"{tag} wall={wall * 1e3:.1f}ms device_busy="
        f"{busy_us / 1e3:.3f}ms busy_share={busy_us / 1e6 / wall:.4f} "
        f"compute={engine.stats.compute_seconds * 1e3:.1f}ms "
        f"batches={engine.stats.batches}")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"{tag} {us / 1e3:9.3f}ms {n:6d}x  {key[:90]}")


# -------------------------------------------------------------------- LM --
def lm_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), num_layers=LM_DEPTH,
                               vocab=LM_VOCAB)


def lm_store(cfg, url):
    """v0 from ``init_params``; v1 = v0 with the last layer's feed-forward
    weights drawn again (a fine-tuned layer).  Per-layer 2-D tensors,
    64x64 blocks, 8 a page, a narrow LSH bucket (r = 0.25: at the init
    scale, r = 4 puts nearly every block in one bucket and the index
    query grows quadratically), committed to SQLite.  The store is built
    twice, its index signed on the card and on the host: the two must be
    equal, and the card's is committed.  Returns the carried tensors
    served in bf16 and in fp32, a record of the build and the card
    build's store (kept in memory for the fine-tune phase)."""
    import math
    import numpy as np
    from repro_torch.convert import lm_tensors
    from repro_torch.core import DedupConfig, LSHConfig, StoreConfig
    from repro_torch.core.device_index import DeviceModelStore
    from repro_torch.db import DedupDB
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.storage import open_backend
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    lm = lm_tensors(params, dtype=cfg.dtype, per_layer=True)
    # the same arrays served in fp32 (views: no second copy)
    lm32 = lm_tensors(params, dtype="float32", per_layer=True)
    rng = np.random.default_rng(SEED + 1)
    tuned = dict(lm.tensors)
    last = LM_DEPTH - 1
    for name, std in (("w1", 0.02), ("w3", 0.02),
                      ("w2", 0.02 / math.sqrt(2 * LM_DEPTH))):
        key = f"blocks/{last}/mlp/{name}"
        x = rng.standard_normal(tuned[key].shape, dtype=np.float32)
        x *= np.float32(std)
        tuned[key] = x
    t_init = time.perf_counter() - t0
    store_cfg = StoreConfig(
        dedup=DedupConfig(block_shape=(64, 64), lsh=LSHConfig(r=0.25),
                          validate=False),
        blocks_per_page=8)

    def build(index_mode):
        """(store, register seconds, packing seconds)"""
        st = DeviceModelStore(store_cfg, index_mode=index_mode)
        t0 = time.perf_counter()
        st.register("lm-v0", lm.tensors)
        st.register("lm-v1", tuned)
        t1 = time.perf_counter()
        st.num_pages()                         # packs
        return st, t1 - t0, time.perf_counter() - t1

    # the build window of lsh_signature
    ops.reset_launches()
    store, t_reg, t_pack = build("cuda")
    lsh_launches = ops.LAUNCHES["lsh_signature"]
    all_tf32x3(ops, lsh_launches, "LM build")
    host, h_reg, h_pack = build("host")
    same_maps(block_maps(store.dedup), block_maps(host.dedup), "LM build")
    if store.dedup.num_distinct != host.dedup.num_distinct \
            or store.packing.pages != host.packing.pages:
        raise AssertionError("LM build: the cuda and host stores differ in "
                             "distinct blocks or pages")
    pages, t_build = store.num_pages(), t_reg + t_pack
    t0 = time.perf_counter()
    DedupDB(store, open_backend(url)).commit()
    t_commit = time.perf_counter() - t0
    rec = dict(init_s=t_init, build_s=t_build, commit_s=t_commit,
               pages=pages, dense_mib=store.dense_bytes() / 2 ** 20,
               dedup_mib=store.storage_bytes() / 2 ** 20,
               variant_pages=[len(store.model_pages(m))
                              for m in ("lm-v0", "lm-v1")],
               blocks=sum(a.size for a in lm.tensors.values()) // 4096,
               lsh_launches=lsh_launches)
    log(f"[lm-store] {LM_ARCH} depth={LM_DEPTH} d_model={cfg.d_model} "
        f"vocab={cfg.vocab} blocks_a_variant={rec['blocks']} "
        f"pages={pages} variant_pages={rec['variant_pages']} "
        f"dense={rec['dense_mib']:.0f}MiB dedup={rec['dedup_mib']:.0f}MiB "
        f"init={t_init:.1f}s build={t_build:.1f}s commit={t_commit:.1f}s")
    # where the build's time goes: signatures, signature + index query
    # (index_query_seconds), the rest of Alg. 1, then page packing
    for mode, st, reg, pack in (("cuda", store, t_reg, t_pack),
                                ("host", host, h_reg, h_pack)):
        ix = st.dedup.index_stats
        query_s = sum(r.index_query_seconds
                      for r in st.dedup.models.values())
        log(f"[lm-index] {mode}: {index_line(ix)} register={reg:.1f}s "
            f"sign_share={ix.sign_wall_seconds / reg:.3f} "
            f"signature+query={query_s:.1f}s "
            f"rest={reg - query_s:.1f}s pack={pack:.1f}s")
    log(f"[lm-index] cuda == host: block maps, distinct="
        f"{store.dedup.num_distinct}, pages={pages}; lsh_launches="
        f"{lsh_launches} (all tf32x3)")
    return lm, lm32, rec, store


def lm_traffic(cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 7)
    return [(f"lm-v{b % 2}",
             rng.integers(1, cfg.vocab, size=(LM_PROMPTS, LM_PROMPT_LEN))
             .astype(np.int32)) for b in range(LM_BATCHES)]


def serve_lm(torch, url, apis, rebuild, traffic, capacity, kernel_mode):
    """Serve ``traffic`` out of the database on the card; (engine, db,
    per-batch [(model, last-token prefill logits, tokens)], per-switch
    wall seconds, wall seconds of the run)."""
    from repro_torch.db import DedupDB
    db = DedupDB.open(url)
    engine = db.serve_lm(apis, {m: {"rebuild": rebuild} for m in apis},
                         capacity_pages=capacity, scheduler="fifo",
                         compute_backend="device", kernel_mode=kernel_mode,
                         device=torch.device("cuda"))
    served, switches = [], []
    compute, load = engine._compute, engine._load_model

    def recording_compute(model, prompts, steps):
        out = compute(model, prompts, steps)
        served.append((model, engine.last_logits.float().cpu().numpy(),
                       out[0].copy()))
        return out

    def timed_load(model, grouped=False):
        t0 = time.perf_counter()
        out = load(model, grouped)
        torch.cuda.synchronize()
        switches.append(time.perf_counter() - t0)
        return out

    engine._compute, engine._load_model = recording_compute, timed_load
    for model, prompts in traffic:
        engine.submit(model, prompts, steps=LM_STEPS)
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    return engine, db, served, switches, time.perf_counter() - t0


def flash_phase(torch, ops, ref, cfg):
    """flash_attention against its plain version: at the LM path's shape
    in bf16 (timed, with SDPA as the library yardstick) and at the
    reference's four test shapes in fp32."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, S, H, hd = LM_PROMPTS, LM_PROMPT_LEN, cfg.num_heads, cfg.hd
    K = cfg.kv_heads
    q = torch.randn(B, S, H, hd, device=dev, generator=g).bfloat16()
    k = torch.randn(B, S, K, hd, device=dev, generator=g).bfloat16()
    v = torch.randn(B, S, K, hd, device=dev, generator=g).bfloat16()
    n0 = ops.LAUNCHES["flash_attention"]
    variant = ops.flash_variant(q.dtype, hd)
    w0 = ops.VARIANT_LAUNCHES["flash_attention"][variant]
    got = ops.flash_attention(q, k, v, causal=True).float()
    want = ref.flash_attention(q, k, v, causal=True).float()
    torch.cuda.synchronize()
    if ops.VARIANT_LAUNCHES["flash_attention"][variant] != w0 + 1:
        raise AssertionError(f"flash_attention did not run its {variant} "
                             f"body")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
        raise AssertionError(f"flash_attention bf16 differs from its plain "
                             f"version by {err} (tol 2e-2)")
    # the LM prefill's own call (models.attention.flash_prefill): q scaled
    # in fp32 and rounded to bf16, scale 1, the fp32 accumulator written
    # as fp32.  The wgmma body rounds P to bf16 and the plain version
    # does not; with O no longer rounded, 1e-2 (half the bf16 tolerance)
    qs = (q.float() * hd ** -0.5).bfloat16()
    path_kw = dict(causal=True, scale=1.0, out_dtype=torch.float32)
    w0 = ops.VARIANT_LAUNCHES["flash_attention"][variant]
    got32 = ops.flash_attention(qs, k, v, **path_kw)
    want32 = ref.flash_attention(qs, k, v, **path_kw)
    torch.cuda.synchronize()
    if ops.VARIANT_LAUNCHES["flash_attention"][variant] != w0 + 1 \
            or got32.dtype != torch.float32:
        raise AssertionError(f"flash_attention fp32 out: {got32.dtype}, not "
                             f"on its {variant} body")
    err32 = float((got32 - want32).abs().max())
    if not torch.allclose(got32, want32, rtol=1e-2, atol=1e-2):
        raise AssertionError(f"flash_attention fp32 out differs from its "
                             f"plain version by {err32} (tol 1e-2)")
    errs16 = {}
    for (b_, sq, skv, h_, k_, d_, window, cap) in FLASH_BF16_CASES:
        qq, kk, vv = (torch.randn(b_, s_, n_, d_, device=dev,
                                  generator=g).bfloat16()
                      for s_, n_ in ((sq, h_), (skv, k_), (skv, k_)))
        body = ops.flash_variant(qq.dtype, d_)
        w0 = ops.VARIANT_LAUNCHES["flash_attention"][body]
        a = ops.flash_attention(qq, kk, vv, causal=True, window=window,
                                softcap=cap).float()
        w = ref.flash_attention(qq, kk, vv, causal=True, window=window,
                                softcap=cap).float()
        torch.cuda.synchronize()
        if body != "wgmma" or \
                ops.VARIANT_LAUNCHES["flash_attention"][body] != w0 + 1:
            raise AssertionError(f"flash_attention hd {d_} ran {body}, not "
                                 f"the wgmma body")
        errs16[d_] = float((a - w).abs().max())
        if not torch.allclose(a, w, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"flash_attention bf16 hd {d_} window "
                                 f"{window} softcap {cap} differs from its "
                                 f"plain version by {errs16[d_]} (tol 2e-2)")
    errs32 = []
    for (b_, sq, skv, h_, k_, d_, causal, window, cap) in FLASH_CASES:
        qq = torch.randn(b_, sq, h_, d_, device=dev, generator=g)
        kk = torch.randn(b_, skv, k_, d_, device=dev, generator=g)
        vv = torch.randn(b_, skv, k_, d_, device=dev, generator=g)
        a = ops.flash_attention(qq, kk, vv, causal=causal, window=window,
                                softcap=cap)
        w = ref.flash_attention(qq, kk, vv, causal=causal, window=window,
                                softcap=cap)
        torch.cuda.synchronize()
        errs32.append(float((a - w).abs().max()))
        if not torch.allclose(a, w, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"flash_attention fp32 {(b_, sq, skv, h_, k_, d_)} "
                                 f"differs from its plain version by "
                                 f"{errs32[-1]} (rtol 1e-4, atol 1e-5)")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = timings(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                 lambda: ref.flash_attention(q, k, v, causal=True),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                        is_causal=True))
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2
    pairs = B * H * S * (S + 1) // 2            # visible (query, key) pairs
    flops = 2 * 2 * pairs * hd                  # q k^T and p v
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    # the fp32-out epilogue (the LM path's call) beside the bf16 one: O
    # written as fp32 doubles its bytes
    fp32_out_ms = graph_ms(torch, lambda: ops.flash_attention(qs, k, v,
                                                              **path_kw))
    b32_ms, _ = bound_ms(nbytes + q.numel() * 2, flops, BF16_FLOP_PER_S)
    rec = dict(kernel="flash_attention", variant=variant, max_abs_err=err,
               max_abs_err_fp32_out=err32,
               max_abs_err_bf16_hd=errs16, max_abs_err_fp32=max(errs32),
               tolerance="2e-2 bf16; 1e-2 fp32 out; rtol 1e-4 atol 1e-5 "
                         "fp32", **ms, fp32_out_ms=fp32_out_ms,
               fp32_out_bound_ms=b32_ms,
               bound_ms=b_ms, bytes=nbytes, flops=flops, bound_by=b_by,
               launches=ops.LAUNCHES["flash_attention"] - n0,
               shapes=f"q,k,v[{B},{S},{H},{hd}] bf16 causal, O in bf16 "
                      f"and (the LM path's call: q pre-scaled, scale 1) in "
                      f"fp32; bf16 hd 64 and 256 with window and softcap; "
                      f"the four reference shapes in fp32 (fma body)")
    log(json.dumps({"phase": "kernel-check", **rec}))
    for label, b_, s_, h_, d_, causal in FLASH_SHAPES:
        qq, kk, vv = (torch.randn(b_, s_, h_, d_, device=dev,
                                  generator=g).bfloat16() for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv))
        k_ms = graph_ms(torch, lambda: ops.flash_attention(qq, kk, vv,
                                                           causal=causal))
        s_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        log(f"[flash-shapes] {label} q,k,v[{b_},{s_},{h_},{d_}] causal="
            f"{causal} body={ops.flash_variant(qq.dtype, d_)} "
            f"kernel={k_ms * 1e3:.2f}us sdpa={s_ms * 1e3:.2f}us")
    return rec


def visible_pairs(Sq, Skv, causal, window):
    """(query, key) pairs the mask lets through, per (batch, head)."""
    import numpy as np
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def family_flash_phase(torch, ops, ref):
    """flash_attention at the other families' full-width shapes (bf16, the
    wgmma body): each against its plain version (2e-2) and timed beside
    its bound and, where no window masks it, beside SDPA.  Returns the
    records."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    recs = []
    for label, B, Sq, Skv, H, K, hd, causal, window in FAMILY_FLASH:
        q = torch.randn(B, Sq, H, hd, device=dev, generator=g).bfloat16()
        k, v = (torch.randn(B, Skv, K, hd, device=dev, generator=g)
                .bfloat16() for _ in range(2))
        body = ops.flash_variant(q.dtype, hd)
        w0 = ops.VARIANT_LAUNCHES["flash_attention"][body]
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if body != "wgmma" or \
                ops.VARIANT_LAUNCHES["flash_attention"][body] != w0 + 1:
            raise AssertionError(f"flash_attention {label} ran {body}, not "
                                 f"the wgmma body")
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=2e-2,
                              atol=2e-2):
            raise AssertionError(f"flash_attention {label} differs from "
                                 f"its plain version by {err} (tol 2e-2)")
        del want
        k_ms = graph_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window))
        p_ms = graph_ms(torch, lambda: ref.flash_attention(
            q, k, v, causal=causal, window=window), calls=2, replays=3)
        s_ms = None
        if not window:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            s_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != K))
        pairs = B * H * visible_pairs(Sq, Skv, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        b_ms, b_by = bound_ms(nbytes, 4 * pairs * hd, BF16_FLOP_PER_S)
        rec = dict(label=label, shape=f"q[{B},{Sq},{H},{hd}] k,v[{B},{Skv},"
                   f"{K},{hd}]", causal=causal, window=window, body=body,
                   max_abs_err=err, tolerance=2e-2, ms=k_ms, plain_ms=p_ms,
                   sdpa_ms=s_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[flash-families] {json.dumps(rec)}")
        recs.append(rec)
    log("[flash-families] sdpa_ms: F.scaled_dot_product_attention(q, k, v, "
        "is_causal=causal, enable_gqa=H != K) on [B, H, S, hd] contiguous "
        "bf16 copies of the same inputs; none where a window masks keys")
    return recs


def lsh_check(torch, ops, ref, x, proj, bias, r, what):
    """lsh_signature against its plain version on the card: equal except
    where the exact value lies within 1e-4 of a bucket edge.  Returns
    (max |difference| in buckets, hashes at an edge, hashes that
    differ)."""
    got = ops.lsh_signature(x, proj, bias, r)
    want = ref.lsh_signature(x, proj, bias, r)
    edges = ref.lsh_edges(x, proj, bias, r)
    torch.cuda.synchronize()
    diff = got != want
    off = int((diff & ~edges).sum())
    if off:
        raise AssertionError(f"lsh_signature {what}: {off} hashes differ "
                             f"from the plain version off the bucket edges")
    return (float((got - want).abs().max()), int(edges.sum()),
            int(diff.sum()))


def cli_lm_blocks():
    """The CLI's LM store: the reduced deepseek-7b's tensors in 32x32
    blocks, and its LSH (16 hashes, r = 4)."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import lm_tensors
    from repro_torch.core import LSHConfig
    from repro_torch.core.blocks import block_tensor
    from repro_torch.core.lsh import L2LSH
    from repro_torch.models.transformer import init_params
    cfg = reduced(get_config(LM_ARCH))
    lm = lm_tensors(init_params(cfg, SEED), dtype=cfg.dtype)
    blocks = np.concatenate([block_tensor(np.asarray(t), (32, 32))[0]
                             .reshape(-1, 1024) for t in lm.tensors.values()])
    lsh = L2LSH(1024, LSHConfig(num_bands=8, rows_per_band=2, r=4.0,
                                collision_threshold=6))
    return blocks.astype(np.float32), lsh


def lsh_phase(torch, ops, ref, chunk, lsh):
    """lsh_signature against its plain version at one chunk of the LM
    store's blocks (timed), at the CLI's LM store and at the reference's
    three test shapes."""
    import numpy as np
    dev = torch.device("cuda")
    proj, bias = (torch.from_numpy(a).to(dev) for a in (lsh.proj, lsh.bias))
    r = lsh.cfg.r
    x = torch.from_numpy(chunk).to(dev)
    n, dim = x.shape
    nh = proj.shape[1]
    variant = ops.lsh_variant(n, dim, nh)
    n0 = ops.LAUNCHES["lsh_signature"]
    v0 = ops.VARIANT_LAUNCHES["lsh_signature"][variant]
    err, edges, diff = lsh_check(torch, ops, ref, x, proj, bias, r, "chunk")
    if ops.VARIANT_LAUNCHES["lsh_signature"][variant] != v0 + 1:
        raise AssertionError(f"lsh_signature at the chunk did not run its "
                             f"{variant} body")
    checks = [f"chunk[{n},{dim}]x{nh}: edge_hashes={edges} differ={diff}"]
    cblocks, clsh = cli_lm_blocks()
    cases = [(f"cli[{len(cblocks)},1024]x16", cblocks, clsh.proj, clsh.bias,
              clsh.cfg.r)]
    rng = np.random.default_rng(SEED)
    for cn, cdim, cnh, cr in LSH_CASES:
        cases.append((f"ref[{cn},{cdim}]x{cnh}",
                      rng.standard_normal((cn, cdim)).astype(np.float32),
                      rng.standard_normal((cdim, cnh)).astype(np.float32),
                      (rng.random(cnh) * cr).astype(np.float32), cr))
    for what, cx, cp, cb, cr in cases:
        a, b, c = (torch.from_numpy(v).to(dev) for v in (cx, cp, cb))
        e, ed, df = lsh_check(torch, ops, ref, a, b, c, cr, what)
        err = max(err, e)
        checks.append(f"{what}: edge_hashes={ed} differ={df}")
    kernel = lambda: ops.lsh_signature(x, proj, bias, r)      # noqa: E731
    plain = lambda: ref.lsh_signature(x, proj, bias, r)       # noqa: E731
    ms = {"kernel_ms": graph_ms(torch, kernel),
          "kernel_eager_ms": eager_ms(torch, kernel, reps=50),
          "plain_ms": graph_ms(torch, plain),
          "plain_eager_ms": eager_ms(torch, plain, reps=50)}
    # the library yardstick is the plain version itself: one cuBLAS
    # sgemm (TF32 off) and the elementwise bias, divide and floor
    ms["library_ms"] = ms["plain_ms"]
    nbytes, flops, b_ms, b_by = lsh_bound(n, dim, nh, variant)
    core_ms, _ = bound_ms(nbytes, flops)
    log(f"[lsh-bodies] {lsh_bodies(torch, ops, x, proj, bias, r, cblocks, clsh)}")
    rec = dict(kernel="lsh_signature", variant=variant,
               max_abs_err=err,
               tolerance="equal off the 1e-4 bucket edges", **ms,
               bound_ms=b_ms, fp32_core_bound_ms=core_ms, bytes=nbytes,
               flops=flops, bound_by=b_by,
               launches=ops.LAUNCHES["lsh_signature"] - n0,
               shapes=f"blocks[{n},{dim}] proj[{dim},{nh}] r={r}; the CLI's "
                      f"LM store; the three reference shapes",
               checks=checks)
    log(json.dumps({"phase": "kernel-check", **rec}))
    return rec


def lsh_bound(n, dim, nh, variant):
    """(bytes, flops of the fp32 product, bound ms, bound by) of one call:
    x, proj and bias read once, the int32 signatures written once; the
    tf32x3 body does three tf32 products at the tensor cores' rate, the
    fma body one fp32 product at the CUDA cores'."""
    nbytes = (n * dim + dim * nh + nh + n * nh) * 4
    flops = 2 * n * dim * nh
    if variant == "tf32x3":
        return (nbytes, flops) + bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    return (nbytes, flops) + bound_ms(nbytes, flops)


def lsh_bodies(torch, ops, x, proj, bias, r, cblocks, clsh) -> str:
    """Device milliseconds of both lsh_signature bodies (forced) at the
    chunk and at the CLI's LM store shape, each beside its bound; the
    chooser restored after.  Timed only."""
    dev = x.device
    cx, cp, cb = (torch.from_numpy(a).to(dev)
                  for a in (cblocks, clsh.proj, clsh.bias))
    chooser = ops.lsh_variant
    out = []
    try:
        for label, a, p, b, rr in (("chunk", x, proj, bias, r),
                                   ("cli", cx, cp, cb, clsh.cfg.r)):
            (n, dim), nh = a.shape, p.shape[1]
            row = []
            for body in ("tf32x3", "fma"):
                ops.lsh_variant = lambda n, dim, nh, body=body: body
                ms = graph_ms(torch, lambda: ops.lsh_signature(a, p, b, rr),
                              calls=5, replays=4)
                _, _, b_ms, b_by = lsh_bound(n, dim, nh, body)
                row.append(f"{body}={ms:.4f}ms (bound {b_ms:.4f}ms, {b_by})")
            out.append(f"{label}[{n},{dim}]x{nh}: " + " ".join(row))
    finally:
        ops.lsh_variant = chooser
    return "; ".join(out)


def lm_signature_check(torch, ref, lsh, blocks):
    """Every block of lm-v0 signed by the build's routine (the kernel,
    chunked through pinned memory) against the plain version on the
    card, and a sample against the reference's per-block numpy
    signatures (the host build's routine), under the edge criterion."""
    import numpy as np
    from repro_torch.core.device_index import CHUNK_BLOCKS
    from repro_torch.core.lsh import L2LSH
    t0 = time.perf_counter()
    sig = lsh.signatures(blocks)
    dev = torch.device("cuda")
    proj, bias = (torch.from_numpy(a).to(dev) for a in (lsh.proj, lsh.bias))
    edges = np.empty(sig.shape, dtype=bool)
    diff_plain = 0
    for s in range(0, len(blocks), CHUNK_BLOCKS):
        x = torch.from_numpy(blocks[s:s + CHUNK_BLOCKS]).to(dev)
        plain = ref.lsh_signature(x, proj, bias, lsh.cfg.r).cpu().numpy()
        e = ref.lsh_edges(x, proj, bias, lsh.cfg.r).cpu().numpy()
        edges[s:s + len(e)] = e
        d = sig[s:s + len(e)] != plain
        if (d & ~e).any():
            raise AssertionError(f"lm-v0 signatures differ from the plain "
                                 f"version off the edges in "
                                 f"{int((d & ~e).sum())} hashes")
        diff_plain += int(d.sum())
    idx = np.sort(np.random.default_rng(SEED).choice(
        len(blocks), LSH_SAMPLE, replace=False))
    host = np.stack([L2LSH.signatures(lsh, blocks[i][None])[0] for i in idx])
    d = sig[idx] != host
    if (d & ~edges[idx]).any():
        raise AssertionError(f"lm-v0 signatures differ from numpy's off the "
                             f"edges in {int((d & ~edges[idx]).sum())} hashes")
    log(f"[lm-sig] lm-v0 blocks={len(blocks)} hashes={sig.size} "
        f"edge_hashes={int(edges.sum())} differ_plain={diff_plain} "
        f"sample={LSH_SAMPLE} sample_edge_hashes={int(edges[idx].sum())} "
        f"differ_numpy_per_block={int(d.sum())} (tol: equal off the 1e-4 "
        f"edges) seconds={time.perf_counter() - t0:.1f}")


def time_lm_steps(torch, engine, api, prompts):
    """Device milliseconds of one prefill and of one decode step on the
    engine's resident model (CUDA events, after a warm-up)."""
    params = engine._params
    toks = torch.as_tensor(prompts, device=params["embed"].device)
    max_len = prompts.shape[1] + LM_STEPS

    def run(n_decode):
        logits, cache = api.prefill(params, {"tokens": toks}, max_len)
        nxt = logits.argmax(-1)
        for _ in range(n_decode):
            logits, cache = api.decode(params, cache, nxt)
            nxt = logits.argmax(-1)
        return nxt

    run(2)
    out = {}
    for key, n in (("prefill", 0), ("prefill+decode", LM_STEPS - 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run(n)
        end.record()
        end.synchronize()
        out[key] = start.elapsed_time(end) / 3
    prefill = out["prefill"]
    decode = (out["prefill+decode"] - prefill) / (LM_STEPS - 1)
    return prefill, decode


def profile_lm_steps(torch, engine, api, prompts, tag="[lm-profile]"):
    """One prefill and the decode steps of a batch under torch.profiler:
    device-busy share of the window and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    params = engine._params
    toks = torch.as_tensor(prompts, device=params["embed"].device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": toks},
                                    prompts.shape[1] + LM_STEPS)
        for _ in range(LM_STEPS - 1):
            logits, cache = api.decode(params, cache, logits.argmax(-1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(r[1] for r in rows)
    log(f"{tag} wall={wall * 1e3:.1f}ms device_busy="
        f"{busy_us / 1e3:.3f}ms busy_share={busy_us / 1e6 / wall:.4f} "
        f"(1 prefill + {LM_STEPS - 1} decode steps)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"{tag} {us / 1e3:9.3f}ms {n:6d}x  {key[:90]}")


def check_modes(torch, cfg, url, plain_apis, lm, lm32, traffic, capacity,
                engine, served, tag):
    """The traffic served once more in torch mode on the card (plain
    attention): every batch's last-token prefill logits within
    LM_LOGIT_TOL of the cuda run's; then the last batch rerun in fp32 in
    both modes: the same greedy tokens.  Returns the torch-mode engine
    and its database."""
    import dataclasses
    import numpy as np
    from repro_torch.models import build
    t_engine, t_db, t_served, _, t_wall = serve_lm(
        torch, url, plain_apis, lm.rebuild, traffic, capacity, "torch")
    worst = 0.0
    for (m, a, ta), (tm, b, tb), (_, prompts) in zip(served, t_served,
                                                     traffic):
        n = len(prompts)
        if m != tm or a.shape != (n, 1, cfg.vocab) \
                or not np.isfinite(a).all() or ta.shape != (n, LM_STEPS):
            raise AssertionError(f"{tag} batch of {m}: logits {a.shape}, "
                                 f"tokens {ta.shape}, finite="
                                 f"{np.isfinite(a).all()}")
        worst = max(worst, float(np.abs(a - b).max()))
    scale = max(float(np.abs(b).max()) for _, b, _ in t_served)
    log(f"{tag} prefill logits cuda vs torch mode (bf16): "
        f"max_abs_err={worst:.3e} (tol {LM_LOGIT_TOL}, max |logit| "
        f"{scale:.2f}) torch_wall={t_wall:.3f}s")
    if worst > LM_LOGIT_TOL:
        raise AssertionError(f"{tag} prefill logits differ by {worst} "
                             f"(> {LM_LOGIT_TOL})")
    # the last batch's variant is resident: the rerun moves no page
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model, prompts = traffic[-1]
    bf16_last = {"kernel": served[-1][1], "plain": t_served[-1][1]}
    toks32, logits32 = {}, {}
    for eng, attention in ((engine, "kernel"), (t_engine, "plain")):
        eng.templates = {m: {"rebuild": lm32.rebuild} for m in eng.templates}
        eng.apis = {m: build(cfg32, attention=attention) for m in eng.apis}
        eng._resident_model = None
        toks32[attention], _ = eng.generate(model, prompts, LM_STEPS)
        logits32[attention] = eng.last_logits.float().cpu().numpy()
    same = np.array_equal(toks32["kernel"], toks32["plain"])
    log(f"{tag} fp32 greedy tokens cuda vs torch mode: equal={same} "
        f"({toks32['kernel'].shape}); last batch's prefill logits, "
        f"distance from the fp32 model: cuda bf16 "
        f"{float(np.abs(bf16_last['kernel'] - logits32['kernel']).max()):.3e}"
        f", torch bf16 "
        f"{float(np.abs(bf16_last['plain'] - logits32['plain']).max()):.3e}, "
        f"fp32 cuda vs torch "
        f"{float(np.abs(logits32['kernel'] - logits32['plain']).max()):.3e}")
    if not same:
        raise AssertionError(f"{tag} fp32 greedy tokens differ between cuda "
                             f"and torch mode")
    return t_engine, t_db


def lm_phase(torch, ops, ref, tmpdir):
    """The LM path: returns (kernel records, launches on the path) of
    flash_attention and lsh_signature, the request tier's launches, and
    the store with the carried tensors (the fine-tune phase's input)."""
    import numpy as np
    from repro_torch.core.blocks import block_tensor
    from repro_torch.core.device_index import CHUNK_BLOCKS
    from repro_torch.models import build
    cfg = lm_config()
    flash = flash_phase(torch, ops, ref, cfg)
    url = f"sqlite:///{Path(tmpdir) / 'lm.db'}"
    lm, lm32, store_rec, store = lm_store(cfg, url)
    lsh = store.dedup.index.lsh
    blocks = np.concatenate([block_tensor(np.asarray(t), (64, 64))[0]
                             .reshape(-1, 4096) for t in lm.tensors.values()])
    lsh_rec = lsh_phase(torch, ops, ref, blocks[:CHUNK_BLOCKS], lsh)
    lm_signature_check(torch, ref, lsh, blocks)
    del blocks
    traffic = lm_traffic(cfg)
    capacity = max(store_rec["variant_pages"])  # the larger variant's set
    kernel_apis = {m: build(cfg) for m in ("lm-v0", "lm-v1")}
    plain_apis = {m: build(cfg, attention="plain") for m in kernel_apis}

    ops.reset_launches()
    engine, db, served, switches, wall = serve_lm(
        torch, url, kernel_apis, lm.rebuild, traffic, capacity, "cuda")
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    st = engine.stats
    pool = engine.server.device_pool
    log(f"[lm-launches] {launches} flash_attention by body: {bodies}")
    tokens = LM_BATCHES * LM_PROMPTS * LM_STEPS
    log(f"[lm-serve] batches={st.batches} device_batches={st.device_batches} "
        f"dense_fallbacks={st.dense_fallbacks} slab={pool.capacity} "
        f"loads={pool.loads} evicts={pool.evicts} wall={wall:.3f}s "
        f"compute={st.compute_seconds:.3f}s "
        f"tokens_per_s_wall={tokens / wall:.1f} "
        f"tokens_per_s_compute={tokens / st.compute_seconds:.1f}")
    log(f"[lm-switch] first={switches[0]:.3f}s "
        f"rest_mean={float(np.mean(switches[1:])):.3f}s "
        f"rest_max={max(switches[1:]):.3f}s pages_moved={st.transfer_pages} "
        f"transfer_ops={st.transfer_groups} "
        f"transfer_device={st.transfer_seconds * 1e3:.1f}ms "
        f"virtual_fetch={st.fetch_seconds:.3f}s")
    if st.batches != LM_BATCHES or st.device_batches != LM_BATCHES:
        raise AssertionError(f"LM device_batches={st.device_batches} of "
                             f"{st.batches}, wanted {LM_BATCHES}")
    if st.dense_fallbacks != 0:
        raise AssertionError(f"LM dense_fallbacks={st.dense_fallbacks}")
    if launches["flash_attention"] < LM_DEPTH * LM_BATCHES:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, wanted "
                             f">= {LM_DEPTH * LM_BATCHES}")
    if bodies != {"wgmma": launches["flash_attention"], "fma": 0}:
        raise AssertionError(f"the LM prefill's flash_attention launches "
                             f"went to {bodies}, not all to the wgmma body")
    if launches["split_bf16x3"] < LM_DEPTH * LM_BATCHES:
        raise AssertionError(f"wo's split launched "
                             f"{launches['split_bf16x3']} times, wanted "
                             f">= {LM_DEPTH * LM_BATCHES}")
    prefill_ms, decode_ms = time_lm_steps(torch, engine,
                                          kernel_apis["lm-v1"],
                                          traffic[-1][1])
    log(f"[lm-time] prefill={prefill_ms:.2f}ms ({LM_PROMPTS}x"
        f"{LM_PROMPT_LEN} tokens) decode={decode_ms:.3f}ms a step "
        f"({LM_PROMPTS} tokens)")
    profile_lm_steps(torch, engine, kernel_apis["lm-v1"], traffic[-1][1])

    # the same traffic in torch mode on the card, plain attention; one
    # batch rerun in fp32 in both modes
    t_engine, t_db = check_modes(torch, cfg, url, plain_apis, lm, lm32,
                                 traffic, capacity, engine, served,
                                 "[lm-check]")
    db.close()
    t_db.close()
    del engine, t_engine
    # the request tier on the same store (not built again)
    t0 = time.perf_counter()
    traffic_launches = lm_traffic_phase(torch, ops, cfg, url, kernel_apis,
                                        lm.rebuild, capacity)
    log(f"[lm-traffic] seconds={time.perf_counter() - t0:.1f}")
    return ({"flash_attention": flash, "lsh_signature": lsh_rec},
            {"flash_attention": launches["flash_attention"],
             "lsh_signature": store_rec["lsh_launches"],
             "split_bf16x3": launches["split_bf16x3"]}, traffic_launches,
            (store, lm32))


# ------------------------------------------------------ other families --
def hybrid_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(HY_ARCH), num_layers=HY_DEPTH)


def hybrid_store(cfg, url):
    """v0 from ``init_params``; v1 = v0 with the last layer's MLP and
    mamba ``in_proj`` / ``out_proj`` drawn again.  Per-layer 2-D tensors,
    64x64 blocks, 8 a page, ``LSHConfig(r=0.25)``, the index signed on the
    card (every launch on the tf32x3 body), committed to SQLite.  Returns
    the carried tensors served in bf16 and in fp32 and a record of the
    build."""
    import math
    import numpy as np
    from repro_torch.convert import lm_tensors
    from repro_torch.core import DedupConfig, LSHConfig, StoreConfig
    from repro_torch.core.device_index import DeviceModelStore
    from repro_torch.db import DedupDB
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.storage import open_backend
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    lm = lm_tensors(params, dtype=cfg.dtype, per_layer=True)
    lm32 = lm_tensors(params, dtype="float32", per_layer=True)
    rng = np.random.default_rng(SEED + 2)
    tuned = dict(lm.tensors)
    last = HY_DEPTH - 1
    out_std = 0.02 / math.sqrt(2 * HY_DEPTH)
    for name, std in (("mlp/w1", 0.02), ("mlp/w3", 0.02),
                      ("mlp/w2", out_std), ("mamba/in_proj", 0.02),
                      ("mamba/out_proj", out_std)):
        key = f"blocks/{last}/{name}"
        x = rng.standard_normal(tuned[key].shape, dtype=np.float32)
        x *= np.float32(std)
        tuned[key] = x
    t_init = time.perf_counter() - t0
    st = DeviceModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(64, 64), lsh=LSHConfig(r=0.25),
                          validate=False),
        blocks_per_page=8), index_mode="cuda")
    ops.reset_launches()
    t0 = time.perf_counter()
    st.register("hy-v0", lm.tensors)
    st.register("hy-v1", tuned)
    pages = st.num_pages()                          # packs
    t_build = time.perf_counter() - t0
    lsh_launches = ops.LAUNCHES["lsh_signature"]
    all_tf32x3(ops, lsh_launches, "hybrid build")
    t0 = time.perf_counter()
    DedupDB(st, open_backend(url)).commit()
    t_commit = time.perf_counter() - t0
    ix = st.dedup.index_stats
    rec = dict(pages=pages, build_s=t_build, commit_s=t_commit,
               variant_pages=[len(st.model_pages(m))
                              for m in ("hy-v0", "hy-v1")],
               params=sum(a.size for a in lm.tensors.values()),
               blocks=sum(a.size for a in lm.tensors.values()) // 4096,
               lsh_launches=lsh_launches)
    log(f"[hy-store] {HY_ARCH} depth={HY_DEPTH} d_model={cfg.d_model} "
        f"vocab={cfg.vocab} params_a_variant={rec['params']} "
        f"blocks_a_variant={rec['blocks']} pages={pages} "
        f"variant_pages={rec['variant_pages']} "
        f"dense={st.dense_bytes() / 2 ** 20:.0f}MiB "
        f"dedup={st.storage_bytes() / 2 ** 20:.0f}MiB init={t_init:.1f}s "
        f"build={t_build:.1f}s commit={t_commit:.1f}s {index_line(ix)} "
        f"lsh_launches={lsh_launches} (all tf32x3)")
    return lm, lm32, rec


def hybrid_phase(torch, ops, tmpdir):
    """The slice's path: hymba-1.5b at full width served out of SQLite
    through ``DedupDB.serve_lm`` in cuda mode.  Returns the launches of
    flash_attention (serving) and lsh_signature (the build)."""
    import numpy as np
    from repro_torch.models import build
    from repro_torch.models.transformer import build_groups
    cfg = hybrid_config()
    windows = build_groups(cfg)[0].windows
    if windows != (0, cfg.sliding_window, 0, 0):
        raise AssertionError(f"hymba depth {HY_DEPTH}: windows {windows}, "
                             f"wanted global 0, 2, 3 and a local layer 1")
    url = f"sqlite:///{Path(tmpdir) / 'hymba.db'}"
    lm, lm32, rec = hybrid_store(cfg, url)
    rng = np.random.default_rng(SEED + 8)
    traffic = [(f"hy-v{b % 2}",
                rng.integers(1, cfg.vocab, size=(HY_PROMPTS, HY_PROMPT_LEN))
                .astype(np.int32)) for b in range(HY_BATCHES)]
    capacity = max(rec["variant_pages"])
    kernel_apis = {m: build(cfg) for m in ("hy-v0", "hy-v1")}
    plain_apis = {m: build(cfg, attention="plain") for m in kernel_apis}

    ops.reset_launches()
    engine, db, served, switches, wall = serve_lm(
        torch, url, kernel_apis, lm.rebuild, traffic, capacity, "cuda")
    launches = dict(ops.LAUNCHES)
    bodies = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    st = engine.stats
    pool = engine.server.device_pool
    log(f"[lm-hybrid] launches={launches} flash_attention by body: {bodies}")
    tokens = HY_BATCHES * HY_PROMPTS * LM_STEPS
    log(f"[lm-hybrid] batches={st.batches} device_batches="
        f"{st.device_batches} dense_fallbacks={st.dense_fallbacks} "
        f"slab={pool.capacity} loads={pool.loads} evicts={pool.evicts} "
        f"wall={wall:.3f}s compute={st.compute_seconds:.3f}s "
        f"tokens_per_s_wall={tokens / wall:.1f} switch_first="
        f"{switches[0]:.3f}s switch_rest_mean="
        f"{float(np.mean(switches[1:])):.3f}s pages_moved="
        f"{st.transfer_pages} transfer_device="
        f"{st.transfer_seconds * 1e3:.1f}ms")
    if st.batches != HY_BATCHES or st.device_batches != HY_BATCHES:
        raise AssertionError(f"[lm-hybrid] device_batches="
                             f"{st.device_batches} of {st.batches}, wanted "
                             f"{HY_BATCHES}")
    if st.dense_fallbacks != 0:
        raise AssertionError(f"[lm-hybrid] dense_fallbacks="
                             f"{st.dense_fallbacks}")
    want = HY_DEPTH * HY_BATCHES
    if launches["flash_attention"] != want \
            or bodies != {"wgmma": want, "fma": 0}:
        raise AssertionError(f"[lm-hybrid] flash_attention launches "
                             f"{bodies}, wanted {want} on the wgmma body")
    if launches["split_bf16x3"] < want:
        raise AssertionError(f"[lm-hybrid] wo's split launched "
                             f"{launches['split_bf16x3']} times, wanted "
                             f">= {want}")
    prefill_ms, decode_ms = time_lm_steps(torch, engine,
                                          kernel_apis["hy-v1"],
                                          traffic[-1][1])
    log(f"[lm-hybrid] prefill={prefill_ms:.2f}ms ({HY_PROMPTS}x"
        f"{HY_PROMPT_LEN} tokens) decode={decode_ms:.3f}ms a step "
        f"({HY_PROMPTS} tokens)")
    profile_lm_steps(torch, engine, kernel_apis["hy-v1"], traffic[-1][1],
                     tag="[hy-profile]")
    t_engine, t_db = check_modes(torch, cfg, url, plain_apis, lm, lm32,
                                 traffic, capacity, engine, served,
                                 "[lm-hybrid]")
    db.close()
    t_db.close()
    return launches["flash_attention"], rec["lsh_launches"]


def _family_tree(cfg):
    from repro_torch.models import encdec, transformer
    return encdec.init_params(cfg, SEED, max_dec=64) if cfg.encdec \
        else transformer.init_params(cfg, SEED)


def families_phase(torch, ops):
    """Every arch at its reduced config in fp32 on the card: prefill and
    greedy decode through the kernel route against the plain attention.
    Returns flash_attention's launches of the kernel runs."""
    import numpy as np
    from repro_torch.configs import get_config, list_archs, reduced
    from repro_torch.convert import lm_tensors
    from repro_torch.models import build
    dev = torch.device("cuda")
    launches = 0
    for arch in list_archs():
        cfg = reduced(get_config(arch))
        lm = lm_tensors(_family_tree(cfg), dtype=cfg.dtype)
        params = lm.rebuild(lm.tensors, device=dev)
        rng = np.random.default_rng(SEED + 3)
        batch = {"tokens": torch.from_numpy(rng.integers(
            1, cfg.vocab, size=(2, FAM_PROMPT_LEN)).astype(np.int32)).to(dev)}
        if cfg.encdec:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, 40, cfg.d_model)).astype(np.float32)).to(dev)
        if cfg.vlm_stub:
            batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(dev)
        max_len = FAM_PROMPT_LEN + FAM_STEPS + (
            cfg.num_patches if cfg.vlm_stub else 0)
        out = {}
        for attention in ("kernel", "plain"):
            api = build(cfg, attention=attention)
            ops.reset_launches()
            logits, cache = api.prefill(params, batch, max_len)
            steps = [logits]
            for _ in range(FAM_STEPS):
                logits, cache = api.decode(params, cache,
                                           steps[-1].argmax(-1))
                steps.append(logits)
            torch.cuda.synchronize()
            out[attention] = ([x.float().cpu().numpy() for x in steps],
                              dict(ops.VARIANT_LAUNCHES["flash_attention"]))
        want = 0 if cfg.family == "ssm" else cfg.num_layers + (
            cfg.enc_layers + cfg.num_layers if cfg.encdec else 0)
        kl, bodies = out["kernel"]
        pl, plain_bodies = out["plain"]
        err = max(float(np.abs(a - b).max()) for a, b in zip(kl, pl))
        same = all(np.array_equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(kl, pl))
        log(f"[families] {arch} family={cfg.family} groups="
            f"{_groups_line(cfg)} flash={bodies} max_abs_err={err:.3e} "
            f"(tol {FAM_LOGIT_TOL}) tokens_equal={same}")
        if bodies != {"wgmma": 0, "fma": want} or sum(plain_bodies.values()):
            raise AssertionError(f"[families] {arch}: flash_attention "
                                 f"{bodies} (plain {plain_bodies}), wanted "
                                 f"{want} on the fma body")
        if err > FAM_LOGIT_TOL or not same or not all(
                np.isfinite(a).all() for a in kl):
            raise AssertionError(f"[families] {arch}: logits differ by "
                                 f"{err} (tol {FAM_LOGIT_TOL}), tokens "
                                 f"equal={same}")
        launches += want
    return launches


def _groups_line(cfg):
    if cfg.encdec:
        return f"enc{cfg.enc_layers}+dec{cfg.num_layers}"
    from repro_torch.models.transformer import build_groups
    return "+".join(f"{g.kind}{g.n}" for g in build_groups(cfg))


def encdec_phase(torch, ops):
    """whisper-small at its full size in bf16 through ``registry.build``:
    1 x 1500 frames and an 8-token prompt, 16 greedy steps, the kernel
    route against the plain attention (prefill logits within
    LM_LOGIT_TOL), then fp32 greedy tokens equal.  Returns
    flash_attention's launches of the bf16 kernel run."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_tensors
    from repro_torch.models import build, encdec
    dev = torch.device("cuda")
    cfg = get_config(ED_ARCH)
    t0 = time.perf_counter()
    tree = encdec.init_params(cfg, SEED, max_dec=ED_MAX_DEC)
    rng = np.random.default_rng(SEED + 4)
    frames = torch.from_numpy(rng.standard_normal(
        (1, ED_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab, size=(1, ED_PROMPT_LEN)).astype(np.int32)).to(dev)
    batch = {"frames": frames, "tokens": tokens}
    max_len = ED_PROMPT_LEN + LM_STEPS
    runs = {}
    for dtype in ("bfloat16", "float32"):
        lm = lm_tensors(tree, dtype=dtype)
        params = lm.rebuild(lm.tensors, device=dev)
        c = dataclasses.replace(cfg, dtype=dtype)
        for attention in ("kernel", "plain"):
            api = build(c, attention=attention)
            ops.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = api.prefill(params, batch, max_len)
            first = logits.float().cpu().numpy()
            t_prefill = time.perf_counter() - t1
            toks = [logits.argmax(-1)]
            t1 = time.perf_counter()
            for _ in range(LM_STEPS - 1):
                logits, cache = api.decode(params, cache, toks[-1])
                toks.append(logits.argmax(-1))
            toks = torch.cat(toks, 1).cpu().numpy()
            t_decode = (time.perf_counter() - t1) / (LM_STEPS - 1)
            runs[dtype, attention] = (
                first, toks, dict(ops.VARIANT_LAUNCHES["flash_attention"]),
                t_prefill, t_decode)
        del params
    want = cfg.enc_layers + 2 * cfg.num_layers
    for dtype, body in (("bfloat16", "wgmma"), ("float32", "fma")):
        bodies = runs[dtype, "kernel"][2]
        if bodies[body] != want or sum(bodies.values()) != want \
                or sum(runs[dtype, "plain"][2].values()):
            raise AssertionError(f"[encdec] {dtype}: flash_attention "
                                 f"{bodies}, wanted {want} on {body}")
    a, b = runs["bfloat16", "kernel"][0], runs["bfloat16", "plain"][0]
    err = float(np.abs(a - b).max())
    same32 = np.array_equal(runs["float32", "kernel"][1],
                            runs["float32", "plain"][1])
    err32 = float(np.abs(runs["float32", "kernel"][0]
                         - runs["float32", "plain"][0]).max())
    k = runs["bfloat16", "kernel"]
    log(f"[encdec] {ED_ARCH} enc={cfg.enc_layers} dec={cfg.num_layers} "
        f"d_model={cfg.d_model} vocab={cfg.vocab} frames={ED_FRAMES} "
        f"prompt={ED_PROMPT_LEN} steps={LM_STEPS} flash={k[2]} "
        f"prefill_logits bf16 cuda vs torch max_abs_err={err:.3e} (tol "
        f"{LM_LOGIT_TOL}, max |logit| {float(np.abs(b).max()):.2f}) "
        f"bf16_tokens_equal={np.array_equal(k[1], runs['bfloat16', 'plain'][1])} "
        f"fp32 max_abs_err={err32:.3e} fp32_tokens_equal={same32} "
        f"prefill_wall={k[3] * 1e3:.1f}ms decode_wall={k[4] * 1e3:.2f}ms "
        f"a step seconds={time.perf_counter() - t0:.1f}")
    if a.shape != (1, 1, cfg.vocab) or not np.isfinite(a).all() \
            or err > LM_LOGIT_TOL:
        raise AssertionError(f"[encdec] prefill logits {a.shape} differ by "
                             f"{err} (tol {LM_LOGIT_TOL})")
    if not same32:
        raise AssertionError("[encdec] fp32 greedy tokens differ between "
                             "the kernel route and the plain attention")
    return want


# --------------------------------------------------------- request tier --
def traffic_requests(task):
    """The [traffic] stream: seeded, so a restart regenerates it."""
    from repro_torch.serving import OpenLoopTraffic

    def payload(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(TRAFFIC_DOCS, variant=v, seed=SEED + 5000 + rid)
        return docs

    return OpenLoopTraffic([f"word2vec-v{v}" for v in range(VARIANTS)],
                           rate=TRAFFIC_RATE, zipf_alpha=TRAFFIC_ZIPF,
                           slo_s=TRAFFIC_SLO_MS * 1e-3, seed=SEED + 11,
                           payload_fn=payload).generate(TRAFFIC_REQUESTS)


def traffic_frontend(url, heads, capacity, kernel_mode, snapshot_path=None,
                     snap=None, task=None):
    """A fresh DedupDB engine behind the SLO frontend: (db, frontend).
    With ``snap`` the frontend is restored from it (a warm restart)."""
    from repro_torch.db import DedupDB
    from repro_torch.serving import (BatchComputeModel, ServingFrontend,
                                     StorageModel)
    db = DedupDB.open(url)
    engine = db.serve_embedding(heads, capacity_pages=capacity,
                                scheduler="fifo", storage=StorageModel("ssd"),
                                compute_backend="device",
                                kernel_mode=kernel_mode)
    compute = BatchComputeModel(*TRAFFIC_COMPUTE)
    if snap is not None:
        return db, ServingFrontend.restore(
            engine, snap, traffic_requests(task), compute_model=compute,
            snapshot_path=snapshot_path)
    return db, ServingFrontend(engine, max_batch=TRAFFIC_MAX_BATCH,
                               policy="slo", compute_model=compute,
                               snapshot_path=snapshot_path)


def dispatches(fe):
    return [(m, [r.rid for r in batch]) for m, batch in fe.dispatched]


def traffic_phase(torch, ops, task, url, heads, capacity):
    """[traffic]: the word2vec store behind the SLO frontend in cuda mode,
    held against the same stream in host mode.  Returns (the cuda
    frontend's results, dispatch sequence, dedup_embedding launches)."""
    import numpy as np
    from repro_torch.obs import Tracer, use_tracer
    reqs = traffic_requests(task)
    db, fe = traffic_frontend(url, heads, capacity, "cuda")
    tracer = Tracer(clock=fe.clock)
    ops.reset_launches()
    t0 = time.perf_counter()
    with use_tracer(tracer):
        st = fe.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["dedup_embedding"]
    tracer.assert_matches_clock(fe.clock)
    fe.assert_ledger_conserved()
    served = len(st.request_latencies)
    sizes = [len(b) for _, b in fe.dispatched]
    full = sum(n == TRAFFIC_MAX_BATCH for n in sizes)
    log(f"[traffic] embedding d={D} policy=slo rate={TRAFFIC_RATE:g}/s "
        f"slo={TRAFFIC_SLO_MS:g}ms zipf={TRAFFIC_ZIPF:g} "
        f"docs_a_request={TRAFFIC_DOCS} max_batch={TRAFFIC_MAX_BATCH} "
        f"offered={st.offered_requests} served={served} "
        f"shed={st.shed_requests} slo_miss={st.slo_misses} "
        f"goodput={st.goodput:.3f} "
        f"p50={st.request_percentile(50) * 1e3:.2f}ms "
        f"p99={st.request_percentile(99) * 1e3:.2f}ms "
        f"dispatches={len(sizes)} full={full} partial={len(sizes) - full} "
        f"device_batches={st.device_batches} "
        f"dense_fallbacks={st.dense_fallbacks} launches={launches} "
        f"clock={fe.clock.now * 1e3:.1f}ms wall={wall:.3f}s "
        f"compute={st.compute_seconds * 1e3:.1f}ms")
    if served + st.shed_requests != st.offered_requests \
            or st.offered_requests != TRAFFIC_REQUESTS:
        raise AssertionError(f"[traffic] offered {st.offered_requests}, "
                             f"served {served} + shed {st.shed_requests}")
    if st.dense_fallbacks != 0 or st.device_batches != st.batches:
        raise AssertionError(f"[traffic] device_batches="
                             f"{st.device_batches} of {st.batches}, "
                             f"dense_fallbacks={st.dense_fallbacks}")
    if full < 1 or st.shed_requests + len(sizes) - full < 1:
        raise AssertionError(f"[traffic] batch sizes {sizes}, shed "
                             f"{st.shed_requests}: the run must close full "
                             f"batches and shed or force some")
    if launches < st.batches:
        raise AssertionError(f"[traffic] dedup_embedding launched "
                             f"{launches} times for {st.batches} batches")
    results, order = dict(fe.results), dispatches(fe)
    ledger = fe.ledger.to_dict()
    db.close()

    hdb, hfe = traffic_frontend(url, heads, capacity, "host")
    t0 = time.perf_counter()
    hfe.run(traffic_requests(task))
    h_wall = time.perf_counter() - t0
    if dispatches(hfe) != order or hfe.ledger.to_dict() != ledger:
        raise AssertionError("[traffic] the cuda and host frontends "
                             "dispatched or booked the stream differently")
    worst = 0.0
    for rid, a in results.items():
        b = hfe.results[rid]
        if a.shape != (TRAFFIC_DOCS, 2) or not np.isfinite(a).all():
            raise AssertionError(f"[traffic] rid {rid}: logits {a.shape}")
        worst = max(worst, float(np.abs(a - b).max()))
    hdb.close()
    if worst > 1e-5:
        raise AssertionError(f"[traffic] cuda logits differ from host mode "
                             f"by {worst} (> 1e-5)")
    log(f"[traffic] cuda vs host frontend: same {len(order)} dispatches and "
        f"ledger; logits max_abs_err={worst:.3e} (tol 1e-5) "
        f"host_wall={h_wall:.3f}s")
    return results, order, launches


def restart_phase(torch, ops, task, url, heads, capacity, tmpdir, golden,
                  golden_order):
    """[restart]: the cuda run stopped after RESTART_AFTER dispatches;
    only its snapshot file survives; a fresh engine restored from it
    finishes the stream.  Returns dedup_embedding launches (both
    sides)."""
    import json as _json
    import numpy as np
    snap_path = str(Path(tmpdir) / "frontend.json")
    db, fe = traffic_frontend(url, heads, capacity, "cuda",
                              snapshot_path=snap_path)
    ops.reset_launches()
    fe.run(traffic_requests(task), max_dispatches=RESTART_AFTER)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["dedup_embedding"]
    before, order = dict(fe.results), dispatches(fe)
    db.close()
    del fe, db                                  # the process "dies"
    with open(snap_path) as f:
        snap = _json.load(f)
    db, fe = traffic_frontend(url, heads, capacity, "cuda",
                              snapshot_path=snap_path, snap=snap, task=task)
    readmitted = fe.ledger.readmitted
    ops.reset_launches()
    st = fe.run(traffic_requests(task))
    torch.cuda.synchronize()
    launches += ops.LAUNCHES["dedup_embedding"]
    fe.assert_ledger_conserved()
    after = dict(fe.results)
    order += dispatches(fe)
    both = set(before) & set(after)
    if both:
        raise AssertionError(f"[restart] served on both sides of the "
                             f"crash: {sorted(both)[:5]}")
    combined = {**before, **after}
    if combined.keys() != golden.keys():
        raise AssertionError(f"[restart] served {len(combined)} requests, "
                             f"the uninterrupted run {len(golden)}")
    bad = [rid for rid, a in golden.items()
           if not np.array_equal(combined[rid], a)]
    if bad:
        raise AssertionError(f"[restart] logits of {len(bad)} requests are "
                             f"not bit-equal to the uninterrupted run "
                             f"(rids {bad[:5]})")
    if st.dense_fallbacks != 0:
        raise AssertionError(f"[restart] dense_fallbacks="
                             f"{st.dense_fallbacks}")
    log(f"[restart] stopped after {RESTART_AFTER} dispatches "
        f"(served {len(before)}), restored into a fresh cuda engine: "
        f"readmitted={readmitted} served_after={len(after)} "
        f"served_both=0 bit_equal={len(combined)}/{len(golden)} "
        f"same_dispatches={order == golden_order} launches={launches} "
        f"dense_fallbacks={st.dense_fallbacks}")
    db.close()
    return launches


def lm_traffic_phase(torch, ops, cfg, url, apis, rebuild, capacity):
    """[lm-traffic]: LM requests behind the SLO frontend on the cuda-mode
    LMServingEngine; each request's tokens against a direct generate of
    its dispatched batch (replayed grouped by variant).  Returns
    flash_attention launches of the frontend run."""
    import numpy as np
    from repro_torch.db import DedupDB
    from repro_torch.serving import (BatchComputeModel, OpenLoopTraffic,
                                     ServingFrontend, StorageModel)

    def payload(model, rid, rng):
        return (rng.integers(1, cfg.vocab, size=(1, LM_PROMPT_LEN))
                .astype(np.int32), LM_STEPS)

    db = DedupDB.open(url)
    engine = db.serve_lm(apis, {m: {"rebuild": rebuild} for m in apis},
                         capacity_pages=capacity, scheduler="fifo",
                         storage=StorageModel("ssd"),
                         compute_backend="device", kernel_mode="cuda",
                         device=torch.device("cuda"))
    fe = ServingFrontend(engine, max_batch=LM_TRAFFIC_MAX_BATCH,
                         compute_model=BatchComputeModel())
    reqs = OpenLoopTraffic(sorted(apis), rate=LM_TRAFFIC_RATE, zipf_alpha=1.1,
                           slo_s=LM_TRAFFIC_SLO_MS * 1e-3, seed=SEED + 13,
                           payload_fn=payload).generate(LM_TRAFFIC_REQUESTS)
    ops.reset_launches()
    t0 = time.perf_counter()
    st = fe.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["flash_attention"]
    bodies = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    fe.assert_ledger_conserved()
    served = len(st.request_latencies)
    log(f"[lm-traffic] {LM_ARCH} depth={LM_DEPTH} requests={len(reqs)} "
        f"(1x{LM_PROMPT_LEN} tokens, {LM_STEPS} steps) max_batch="
        f"{LM_TRAFFIC_MAX_BATCH} rate={LM_TRAFFIC_RATE:g}/s "
        f"slo={LM_TRAFFIC_SLO_MS:g}ms offered={st.offered_requests} "
        f"served={served} shed={st.shed_requests} "
        f"dispatches={len(fe.dispatched)} "
        f"sizes={[len(b) for _, b in fe.dispatched]} "
        f"models={[m for m, _ in fe.dispatched]} "
        f"device_batches={st.device_batches} "
        f"dense_fallbacks={st.dense_fallbacks} wall={wall:.1f}s "
        f"compute={st.compute_seconds:.3f}s flash_launches={launches} "
        f"bodies={bodies}")
    if served + st.shed_requests != len(reqs) or st.dense_fallbacks != 0 \
            or st.device_batches != st.batches:
        raise AssertionError(f"[lm-traffic] served {served} + shed "
                             f"{st.shed_requests} of {len(reqs)}; "
                             f"dense_fallbacks={st.dense_fallbacks}")
    if launches < LM_DEPTH * st.batches or bodies != {"wgmma": launches,
                                                      "fma": 0}:
        raise AssertionError(f"[lm-traffic] flash_attention launches "
                             f"{bodies}, not all {launches} on wgmma")
    # replay: a direct generate of each dispatched batch, the resident
    # variant's batches first, so at most two more switches
    t0 = time.perf_counter()
    resident = fe.dispatched[-1][0]
    order = sorted(range(len(fe.dispatched)),
                   key=lambda i: (fe.dispatched[i][0] != resident, i))
    for i in order:
        model, kept = fe.dispatched[i]
        prompts = np.concatenate([r.payload[0] for r in kept], axis=0)
        toks, _ = engine.generate(model, prompts, LM_STEPS)
        for row, r in enumerate(kept):
            if not np.array_equal(fe.results[r.rid], toks[row:row + 1]):
                raise AssertionError(f"[lm-traffic] rid {r.rid}: the "
                                     f"frontend's tokens differ from a "
                                     f"direct generate of its batch")
    torch.cuda.synchronize()
    log(f"[lm-traffic] tokens equal to a direct generate of each dispatched "
        f"batch: {served} requests, replay_wall="
        f"{time.perf_counter() - t0:.1f}s")
    db.close()
    return launches


def cli_traffic_phase(tmpdir):
    """[cli-traffic]: the CLI's traffic run on the card, killed after 3
    dispatches and resumed from its snapshot."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    snap = str(Path(tmpdir) / "cli_frontend.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--traffic",
           CLI_TRAFFIC, "--models", "4", "--vocab", "512", "--snapshot",
           snap]
    outs = []
    t0 = time.perf_counter()
    for extra in (["--kill-after", "3"], []):
        out = subprocess.run(cmd + extra, capture_output=True, text=True,
                             env=env, timeout=300, cwd=str(ROOT))
        if out.returncode != 0:
            raise AssertionError(f"[cli-traffic] {' '.join(extra) or 'resume'}"
                                 f" exited {out.returncode}:\n"
                                 f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        outs.append(out.stdout)
    first, second = outs

    def lines(text, tag):
        return [ln for ln in text.splitlines() if ln.startswith(tag)]

    line, device = lines(second, "[traffic]"), lines(second, "[device]")
    killed = lines(first, "[device]")
    if "[restart] stopped after 3 dispatches" not in first \
            or "[restart] resumed from" not in second or not line \
            or not device or not killed:
        raise AssertionError(f"[cli-traffic] missing report lines:\n"
                             f"{first}\n{second}")
    kv = dict(p.split("=", 1) for p in line[0].split()[1:] if "=" in p)
    if not int(kv["offered"]) == int(kv["served"]) + int(kv["shed"]) == 40:
        raise AssertionError(f"[cli-traffic] {line[0]}")
    # the killed run's dispatches that served anything ran on the card
    dev = dict(p.split("=", 1) for p in killed[0].split() if "=" in p)
    if int(dev["device_batches"]) < 1 or dev["dense_fallbacks"] != "0" \
            or "dense_fallbacks=0" not in device[0]:
        raise AssertionError(f"[cli-traffic] {killed[0]} / {device[0]}")
    log(f"[cli-traffic] killed after 3 dispatches: "
        f"{lines(first, '[traffic]')[0]}")
    log(f"[cli-traffic] killed run {killed[0]}")
    log(f"[cli-traffic] resumed: {line[0]}")
    log(f"[cli-traffic] resumed run {device[0]} "
        f"seconds={time.perf_counter() - t0:.1f}")


# ------------------------------------------------------------ shards --
def batch_pages(planner, batches):
    import numpy as np
    return [planner.embedding_rows_pages(m, "embedding", np.unique(d))
            for m, d in batches]


def shard_capacity(store, pages, shards, placement, fail=False):
    """The smallest per-shard capacity c at which every batch, routed in
    order as the server routes it (replica ties spread by load; with
    ``fail``, shard 0 dead from batch SHARD_FAIL to SHARD_REVIVE), has
    at most c owned pages (its pinned group) and at most c borrowed ones
    (the staging tail, borrow_capacity = c): below it the host-mode run
    of the same traffic takes the host fallback.  Pure placement
    arithmetic over the store's packing and the batches' page sets."""
    from repro_torch.serving import ShardRouter, make_placement
    lo = max(1, -(-max(len(p) for p in pages) // 2))
    for c in range(lo, store.num_pages() + 1):
        budget = int(0.5 * c) if placement == "sharers" else None
        pl = make_placement(placement, store, shards, replicate_budget=budget)
        dead = set()
        router = ShardRouter(lambda: pl, dead_fn=lambda: dead)
        need = 0
        for i, p in enumerate(pages):
            if fail and i == SHARD_FAIL:
                dead.add(0)
            if fail and i == SHARD_REVIVE:
                dead.discard(0)
            r = router.route(p)
            need = max(need, len(r.owned), len(r.borrowed))
            if need > c:
                break
        if need <= c:
            return c
    raise AssertionError(f"no capacity serves {shards} {placement} shards")


def serve_sharded(url, heads, batches, capacity, kernel_mode, shards,
                  placement, fail=False):
    """The batches in order through a sharded DedupDB engine; (engine,
    per-batch logits, wall seconds, the database)."""
    from repro_torch.db import DedupDB
    db = DedupDB.open(url)
    engine = db.serve_embedding(heads, capacity_pages=capacity,
                                scheduler="fifo", overlap=True,
                                compute_backend="device",
                                kernel_mode=kernel_mode, shards=shards,
                                placement=placement)
    srv = engine.server
    for model, docs in batches:
        engine.submit(model, docs)
    out = []
    t0 = time.perf_counter()
    for i in range(len(batches)):
        if fail and i == SHARD_FAIL:
            srv.fail_shard(0)
        if fail and i == SHARD_REVIVE:
            srv.revive_shard(0)
        engine.run(max_batches=1)
        out.append(engine.last_logits.copy())
        if shards > 1:
            srv.sharded.check_invariants()
    if kernel_mode == "cuda":
        import torch
        torch.cuda.synchronize()
    return engine, out, time.perf_counter() - t0, db


def shard_counters(srv):
    s = srv.stats
    return dict(shard_batches=dict(sorted(s.shard_batches.items())),
                borrow_pages=s.borrow_pages,
                borrow_mirror_hits=s.borrow_mirror_hits,
                borrow_store_faults=s.borrow_store_faults,
                borrow_coalesced=s.borrow_coalesced,
                failovers=s.failovers)


def max_err(a_list, b_list):
    import numpy as np
    return max(float(np.abs(a - b).max()) for a, b in zip(a_list, b_list))


def shard_kernel_checks(torch, ops, ref, srv, store, model, docs):
    """The gather at the sharded path's own input — the routed shard's
    extended map (staged pages at ``capacity + stage_idx``) over its slab
    and tail — against its plain version, bit-exact.  Returns the line."""
    import numpy as np
    s = srv._route.shard
    pool = srv.sharded.pools[s]
    vt = store.virtual_tensor(model, "embedding")
    dev_map, uses_extra = srv.sharded.remap(s, vt, strict=False)
    flat = pool.flat_pool()
    bmap = torch.from_numpy(dev_map.reshape(vt.grid.grid)).cuda()
    ids = torch.from_numpy(docs.reshape(-1).astype(np.int32)).cuda()
    tail = int((bmap[ids.long() // 64] >= pool.capacity * 8).sum())
    got = ops.dedup_embedding_striped(ids, flat, bmap, width=D)
    want = ref.dedup_embedding_striped(ids, flat, bmap, width=D)
    torch.cuda.synchronize()
    if not uses_extra or tail == 0 or not torch.equal(got, want):
        raise AssertionError(f"[shards-kernels] dedup_embedding over the "
                             f"tail: uses_extra={uses_extra} tail_blocks="
                             f"{tail} err="
                             f"{float((got - want).abs().max())}")
    return (f"dedup_embedding ids[{ids.numel()}] slab[{flat.shape[0]},64,64]"
            f" (capacity {pool.capacity} + tail {pool.stage_rows} pages) "
            f"blocks_from_tail={tail}: bit-exact")


def ffnn_shard_check(torch, ops, ref, fstore, y_single):
    """device_matmul("ffnn-1", "W1", x) through a 2-shard hash server:
    W1's pages split across the shards, so the routed shard reads staged
    blocks.  Held against the single slab's result (1e-4; bit-equality
    expected) and, at the same input, against the plain version (fp32
    1e-4, bf16 6e-2).  Returns (dedup_matmul launches in the counted
    call, the line)."""
    import numpy as np
    from repro_torch.launch.mesh import shard_devices
    from repro_torch.serving import ShardedWeightServer, StorageModel
    srv = ShardedWeightServer(fstore, fstore.num_pages(),
                              storage=StorageModel("dram"), shards=2,
                              placement="hash", kernel_mode="cuda",
                              devices=shard_devices(2, "cuda"))
    srv.access_pages("ffnn-1", fstore.model_pages("ffnn-1"))
    x = np.random.default_rng(SEED + 1).standard_normal(
        (64, 2048)).astype(np.float32)
    ops.reset_launches()
    y = srv.device_matmul("ffnn-1", "W1", x)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["dedup_matmul"]
    reads = srv.sharded.tail_reads["virtual_matmul"]
    y = y.cpu().numpy()
    err = float(np.abs(y - y_single).max())
    if launches != 1 or reads != 1 or not np.allclose(y, y_single,
                                                      rtol=1e-4, atol=1e-4):
        raise AssertionError(f"[shards] FFNN over 2 shards: launches="
                             f"{launches} tail_reads={reads} err={err}")
    # the same input against the plain version, in both dtypes
    s = srv._route.shard
    pool = srv.sharded.pools[s]
    vt = fstore.virtual_tensor("ffnn-1", "W1")
    dev_map, _ = srv.sharded.remap(s, vt)
    bmap = torch.from_numpy(dev_map.reshape(vt.grid.grid)).cuda()
    staged = int((bmap >= pool.capacity * 8).sum())
    xt = torch.from_numpy(x).cuda()
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
        xa, wa = xt.to(dtype), pool.flat_pool().to(dtype)
        got = ops.dedup_matmul(xa, wa, bmap).float()
        want = ref.dedup_matmul(xa, wa, bmap).float()
        torch.cuda.synchronize()
        errs[str(dtype)[6:]] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"[shards-kernels] dedup_matmul {dtype} "
                                 f"over the tail: {errs}")
    line = (f"FFNN device_matmul 2 shards hash: staged_blocks={staged} of "
            f"{bmap.numel()} launches={launches} vs single slab "
            f"max_abs_err={err:.3e} bit_equal={bool(np.array_equal(y, y_single))}"
            f" (tol 1e-4); at this input vs plain fp32={errs['float32']:.3e}"
            f" (tol 1e-4) bf16={errs['bfloat16']:.3e} (tol 6e-2)")
    return launches, line


def cli_shards_phase():
    """[cli-shards]: the CLI with --shards 2 --placement hash on the card,
    the embedding and the LM engine; each exits 0 and borrows."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--shards", "2",
            "--placement", "hash", "--models", "4"]
    # at --vocab 512 the word2vec store is 3 pages and a batch touches one:
    # nothing to borrow, so the embedding run keeps the CLI's vocabulary
    for engine, extra in (("embedding", []), ("lm", ["--vocab", "512"])):
        t0 = time.perf_counter()
        out = subprocess.run(base + ["--engine", engine] + extra,
                             capture_output=True, text=True, env=env,
                             timeout=300, cwd=str(ROOT))
        if out.returncode != 0:
            raise AssertionError(f"[cli-shards] {engine} exited "
                                 f"{out.returncode}:\n{out.stdout[-2000:]}\n"
                                 f"{out.stderr[-2000:]}")
        lines = {tag: [ln for ln in out.stdout.splitlines()
                       if ln.startswith(tag)]
                 for tag in ("[shards]", "[device]")}
        if not lines["[shards]"] or not lines["[device]"]:
            raise AssertionError(f"[cli-shards] {engine}: no [shards] or "
                                 f"[device] line:\n{out.stdout}")
        kv = dict(p.split("=", 1) for p in lines["[shards]"][0].split()
                  if "=" in p)
        dev = dict(p.split("=", 1) for p in lines["[device]"][0].split()
                   if "=" in p)
        if int(kv["borrows"]) < 1 or dev["dense_fallbacks"] != "0" \
                or dev["mode"] != "cuda":
            raise AssertionError(f"[cli-shards] {engine}: "
                                 f"{lines['[shards]'][0]} / "
                                 f"{lines['[device]'][0]}")
        log(f"[cli-shards] {engine}: {lines['[shards]'][0]}")
        log(f"[cli-shards] {engine}: {lines['[device]'][0]} "
            f"seconds={time.perf_counter() - t0:.1f}")


def shards_phase(torch, ops, ref, url, heads, batches, capacity, fstore,
                 y_single):
    """[shards]: the sharded slab on the word2vec database (2 and 4
    shards, both placements), cuda mode against the single slab and the
    host-mode sharded run; failover; stacked_slab; the FFNN product over
    2 shards; the CLI.  Returns the counted windows' launches."""
    import numpy as np
    from repro_torch.db import DedupDB
    from repro_torch.serving.engine import WeightServer
    t_phase = time.perf_counter()
    pdb = DedupDB.open(url)                     # page maps only
    store = pdb.store
    pages = batch_pages(WeightServer(store, 2, backend="numpy"), batches)
    # the single slab in the same order (the main path's scheduler
    # reorders its batches)
    _, single, _, db = serve_sharded(url, heads, batches, capacity, "cuda",
                                     1, "sharers")
    db.close()
    caps = {(n, p): shard_capacity(store, pages, n, p)
            for n in SHARD_COUNTS for p in ("sharers", "hash")}
    fail_cap = shard_capacity(store, pages, 2, "sharers", fail=True)
    log(f"[shards] capacity a shard (smallest that serves every batch on "
        f"the device): {', '.join(f'{n}x{p}={c}' for (n, p), c in caps.items())}"
        f", 2xsharers+failover={fail_cap}; single slab={capacity} of "
        f"{store.num_pages()} pages; batch pages max={max(map(len, pages))}")
    launches = {"dedup_embedding": 0, "dedup_matmul": 0}
    runs = {}
    kernel_line = None
    for (n, placement), cap in caps.items():
        # the counted window: counts to 0 right before, read right after
        ops.reset_launches()
        engine, out, wall, db = serve_sharded(url, heads, batches, cap,
                                              "cuda", n, placement)
        n_gather = ops.LAUNCHES["dedup_embedding"]
        launches["dedup_embedding"] += n_gather
        srv = engine.server
        st = engine.stats
        tail = srv.sharded.tail_reads["gather_rows"]
        hengine, hout, hwall, hdb = serve_sharded(url, heads, batches, cap,
                                                  "host", n, placement)
        # one page less a shard and the host-mode run takes the host
        # fallback: the capacity is the smallest that serves on the device
        below, _, _, bdb = serve_sharded(url, heads, batches, cap - 1, "host",
                                         n, placement)
        bdb.close()
        mine, host = shard_counters(srv), shard_counters(hengine.server)
        e_single, e_host = max_err(out, single), max_err(out, hout)
        log(f"[shards] n={n} placement={placement} capacity={cap} "
            f"batches={st.batches} device_batches={st.device_batches} "
            f"dense_fallbacks={st.dense_fallbacks} "
            f"batches_per_shard={mine['shard_batches']} "
            f"borrows={mine['borrow_pages']} (mirror="
            f"{mine['borrow_mirror_hits']} owner_faults="
            f"{mine['borrow_store_faults']} coalesced="
            f"{mine['borrow_coalesced']}) rebalanced={srv.router.rebalanced}"
            f" hit_ratio={srv.pool.hit_ratio:.3f} loads={srv.device_pool.loads}"
            f" gather_launches={n_gather} tail_gathers={tail} "
            f"wall={wall:.3f}s host_wall={hwall:.3f}s "
            f"host_device_batches_at_capacity-1="
            f"{below.stats.device_batches} "
            f"vs_single={e_single:.3e} vs_host={e_host:.3e} (tol 1e-5)")
        if below.stats.device_batches >= BATCHES:
            raise AssertionError(f"[shards] {n}x{placement}: capacity "
                                 f"{cap - 1} serves every batch too")
        if st.batches != BATCHES or st.device_batches != BATCHES \
                or st.dense_fallbacks != 0 \
                or hengine.stats.device_batches != BATCHES:
            raise AssertionError(f"[shards] {n}x{placement}: device_batches="
                                 f"{st.device_batches} (host "
                                 f"{hengine.stats.device_batches}) of "
                                 f"{st.batches}, dense_fallbacks="
                                 f"{st.dense_fallbacks}")
        if mine != host:
            raise AssertionError(f"[shards] {n}x{placement}: cuda counters "
                                 f"{mine} != host {host}")
        if e_single > 1e-5 or e_host > 1e-5 or not all(
                o.shape == (DOCS, 2) and np.isfinite(o).all() for o in out):
            raise AssertionError(f"[shards] {n}x{placement}: logits differ "
                                 f"by {e_single} / {e_host} (> 1e-5)")
        if n_gather != BATCHES:
            raise AssertionError(f"[shards] {n}x{placement}: "
                                 f"{n_gather} gathers for {BATCHES} batches")
        if placement == "hash" and (mine["borrow_pages"] < 1 or tail < 1):
            raise AssertionError(f"[shards] {n}x{placement}: borrows="
                                 f"{mine['borrow_pages']} tail_gathers={tail}")
        if placement == "hash" and kernel_line is None:
            kernel_line = shard_kernel_checks(torch, ops, ref, srv, store,
                                              *batches[-1])
        if (n, placement) == (4, "sharers"):
            slab_mesh_check(torch, ops, srv)
        if (n, placement) == (2, "sharers"):
            slab = srv.sharded.stacked_slab()
            for s_, pool in enumerate(srv.sharded.pools):
                pids = sorted(pool.slot_of)
                want = torch.from_numpy(np.stack(
                    [store.page_array(p) for p in pids])).cuda()
                slots = torch.tensor([pool.slot_of[p] for p in pids]).cuda()
                if not torch.equal(slab[s_, slots], want):
                    raise AssertionError(f"[shards] stacked_slab shard {s_} "
                                         f"!= its resident pages")
            log(f"[shards] stacked_slab {tuple(slab.shape)} == the shards' "
                f"resident rows ({[len(p.slot_of) for p in srv.sharded.pools]}"
                f" pages)")
        runs[(n, placement)] = out
        db.close()
        hdb.close()
    log(f"[shards-kernels] {kernel_line}")

    def profiled():
        engine, _, _, db = serve_sharded(url, heads, batches,
                                         caps[(2, "hash")], "cuda", 2,
                                         "hash")
        db.close()
        return engine
    # the 2-shard hash run once more under torch.profiler (uncounted)
    profile_serving(torch, url, heads, batches, None, "[shards-profile]",
                    profiled, top=6)

    # failover: shard 0 dead from batch SHARD_FAIL to SHARD_REVIVE
    ops.reset_launches()
    engine, out, wall, db = serve_sharded(url, heads, batches, fail_cap,
                                          "cuda", 2, "sharers", fail=True)
    launches["dedup_embedding"] += ops.LAUNCHES["dedup_embedding"]
    hengine, _, _, hdb = serve_sharded(url, heads, batches, fail_cap, "host",
                                       2, "sharers", fail=True)
    mine, host = shard_counters(engine.server), shard_counters(hengine.server)
    uengine, _, _, udb = serve_sharded(url, heads, batches, fail_cap, "host",
                                       2, "sharers")
    unfailed = shard_counters(uengine.server)
    udb.close()
    err = max_err(out, runs[(2, "sharers")])
    st = engine.stats
    log(f"[shards] failover 2xsharers capacity={fail_cap}: shard 0 failed at "
        f"batch {SHARD_FAIL}, revived at {SHARD_REVIVE}: failovers="
        f"{mine['failovers']} batches_per_shard={mine['shard_batches']} "
        f"borrows={mine['borrow_pages']} store_faults="
        f"{mine['borrow_store_faults']} (unfailed "
        f"{unfailed['borrow_store_faults']}) device_batches="
        f"{st.device_batches} dense_fallbacks={st.dense_fallbacks} "
        f"vs_unfailed={err:.3e} (tol 1e-5) wall={wall:.3f}s")
    if mine != host or mine["failovers"] != 1 or err > 1e-5 \
            or st.device_batches != BATCHES or st.dense_fallbacks \
            or mine["borrow_store_faults"] <= unfailed["borrow_store_faults"]:
        raise AssertionError(f"[shards] failover: {mine} (host {host}, "
                             f"unfailed {unfailed}), err {err}")
    db.close()
    hdb.close()

    # the FFNN product over 2 shards (its own counted window)
    n_mm, line = ffnn_shard_check(torch, ops, ref, fstore, y_single)
    launches["dedup_matmul"] += n_mm
    log(f"[shards] {line}")
    cli_shards_phase()
    pdb.close()
    log(f"[shards] launches={launches} seconds="
        f"{time.perf_counter() - t_phase:.1f}")
    return launches, caps[(2, "hash")]


# ------------------------------------------------------------- sanitizer --
def instrument(san, srv):
    """Attach ``san`` to the server's pools by instance.  A server binds
    its buffer pools' load / evict callbacks to its device pools' methods
    when it is built, so those are pointed at the wrapped methods too
    (``enable()`` instruments the pools before that binding)."""
    if hasattr(srv, "sharded"):
        san.attach_sharded_pool(srv.sharded)
        for bp, pool in zip(srv.sharded.buffer_pools, srv.sharded.pools):
            bp.on_evict = pool.evict
        return
    pool, bp = srv.device_pool, srv.pool
    san.attach_device_pool(pool)
    san.attach_buffer_pool(bp)
    bp.on_load, bp.on_evict = pool.load, pool.evict
    if bp.on_load_group is not None:
        bp.on_load_group = pool.load_group


def serve_with_sanitizer(torch, ops, store, heads, batches, fstore, make,
                         san):
    """SANITIZE_BATCHES batches on the servers ``make()`` builds (the
    word2vec store's, the FFNN store's), instrumented by ``san`` unless
    None: each batch served by the embedding engine and one
    ``device_matmul`` on the FFNN store.  Returns (logits, products,
    per-batch wall seconds, launches)."""
    import numpy as np
    from repro_torch.serving.engine import EmbeddingServingEngine
    srv, fsrv = make(store), make(fstore)
    if san is not None:
        instrument(san, srv)
        instrument(san, fsrv)
    engine = EmbeddingServingEngine(srv, heads, scheduler="fifo",
                                    overlap=True)
    rng = np.random.default_rng(SEED + 2)
    xs = rng.standard_normal((SANITIZE_BATCHES, 64, 2048)).astype(np.float32)
    logits, ys, walls = [], [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    for i, (model, docs) in enumerate(batches[:SANITIZE_BATCHES]):
        fmodel = f"ffnn-{i % 3}"
        t0 = time.perf_counter()
        engine.submit(model, docs)
        engine.run(max_batches=1)
        fsrv.access_pages(fmodel, fstore.model_pages(fmodel))
        y = fsrv.device_matmul(fmodel, "W1", xs[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        logits.append(engine.last_logits.copy())
        ys.append(y.cpu().numpy())
    launches = dict(ops.LAUNCHES)
    st = engine.stats
    if st.device_batches != SANITIZE_BATCHES or st.dense_fallbacks:
        raise AssertionError(f"[sanitize] device_batches={st.device_batches}"
                             f" dense_fallbacks={st.dense_fallbacks}")
    return logits, ys, walls, launches


def counting_sanitizer():
    """A strict PoolSanitizer that also counts every event it records, by
    operation (its own history keeps the last 4096)."""
    from repro_torch.analysis.sanitizer import PoolSanitizer

    class Counting(PoolSanitizer):
        def __init__(self):
            super().__init__(strict=True)
            self.emitted = 0
            self.by_op = {}

        def _emit(self, op, *a):
            self.emitted += 1
            self.by_op[op] = self.by_op.get(op, 0) + 1
            super()._emit(op, *a)
    return Counting()


def injected_faults(torch, ops, store, fstore) -> str:
    """Three violations on cuda-mode DevicePagePools, each of which must
    raise PoolSanitizerError before its kernel launches (the launch
    counts stay 0); the clean call after each launches its kernel once."""
    import numpy as np
    from repro_torch.analysis.sanitizer import (PoolSanitizer,
                                                PoolSanitizerError)
    from repro_torch.serving.device_pool import DevicePagePool
    rows = np.arange(64)

    def expect(what, kernel, fn, match):
        ops.reset_launches()
        try:
            fn()
        except PoolSanitizerError as e:
            if match not in str(e):
                raise AssertionError(f"[sanitize] {what}: raised {e!r}, "
                                     f"wanted {match!r}") from e
        else:
            raise AssertionError(f"[sanitize] {what}: no PoolSanitizerError")
        torch.cuda.synchronize()
        if ops.LAUNCHES[kernel]:
            raise AssertionError(f"[sanitize] {what}: {kernel} launched "
                                 f"{ops.LAUNCHES[kernel]} times")
        return f"{what}: raised before {kernel} (launches 0)"

    def launches_once(kernel, fn):
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if ops.LAUNCHES[kernel] != 1:
            raise AssertionError(f"[sanitize] the clean {kernel} call "
                                 f"launched {ops.LAUNCHES[kernel]} times")
        return out

    lines = []
    # 1. a remap minted before a load feeds gather_rows after it
    vt = store.virtual_tensor("word2vec-v0", "embedding")
    pids = list(dict.fromkeys(int(p) for p in vt.page_ids))
    pool = DevicePagePool(store, len(pids), kernel_mode="cuda")
    pool.load_group(pids[:-1])
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    stale = pool.remap(vt, strict=False)
    pool.load(pids[-1])
    lines.append(expect("stale-remap", "dedup_embedding",
                        lambda: pool.gather_rows(stale, vt.grid, rows),
                        "stale-remap"))
    launches_once("dedup_embedding",
                  lambda: pool.gather_rows(pool.remap(vt), vt.grid, rows))

    # 2. a load that admits a page without bumping the generation
    pool = DevicePagePool(store, len(pids), kernel_mode="cuda")
    pool.load_group(pids[:-1])

    def broken_load(pid):
        slot = pool._free.pop()
        pool.slot_of[pid] = slot
        pool._page_to_slot[pid] = slot

    pool.load = broken_load
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)

    def load_then_gather():
        pool.load(pids[-1])
        pool.gather_rows(pool.remap(vt), vt.grid, rows)
    lines.append(expect("missed-bump", "dedup_embedding", load_then_gather,
                        "missed generation bump"))

    # 3. pool A's map into pool B's virtual_matmul
    fvt = fstore.virtual_tensor("ffnn-1", "W1")
    fpids = list(dict.fromkeys(int(p) for p in fvt.page_ids))
    pool_a = DevicePagePool(fstore, len(fpids), kernel_mode="cuda")
    pool_b = DevicePagePool(fstore, len(fpids), kernel_mode="cuda")
    san = PoolSanitizer(strict=True)
    for p in (pool_a, pool_b):
        san.attach_device_pool(p)
        p.load_group(fpids)
    x = np.random.default_rng(SEED + 3).standard_normal(
        (64, 2048)).astype(np.float32)
    map_a = pool_a.remap(fvt)
    lines.append(expect("cross-pool", "dedup_matmul",
                        lambda: pool_b.virtual_matmul(map_a, fvt.grid, x),
                        "different pool"))
    ya = launches_once("dedup_matmul",
                       lambda: pool_a.virtual_matmul(map_a, fvt.grid, x))
    yb = launches_once("dedup_matmul", lambda: pool_b.virtual_matmul(
        pool_b.remap(fvt), fvt.grid, x))
    if not torch.equal(ya, yb):
        raise AssertionError("[sanitize] the two pools' products differ")
    return "; ".join(lines)


def sanitize_phase(torch, ops, store, heads, batches, capacity, fstore,
                   shard_cap):
    """[sanitize]: the strict PoolSanitizer on the single slab and on 2
    hash shards (cuda mode), against the same batches uninstrumented;
    then the injected faults.  Returns the instrumented runs' launches."""
    import numpy as np
    from repro_torch.launch.mesh import shard_devices
    from repro_torch.serving import ShardedWeightServer
    from repro_torch.serving.engine import StorageModel, WeightServer
    t_phase = time.perf_counter()

    def single(st):
        cap = capacity if st is store else st.num_pages()
        return WeightServer(st, cap, storage=StorageModel("dram"),
                            backend="device", kernel_mode="cuda")

    def sharded(st):
        cap = shard_cap if st is store else st.num_pages()
        return ShardedWeightServer(st, cap, storage=StorageModel("dram"),
                                   shards=2, placement="hash",
                                   kernel_mode="cuda",
                                   devices=shard_devices(2, "cuda"))

    launches = {"dedup_embedding": 0, "dedup_matmul": 0}
    for name, make in (("single", single), ("2xhash", sharded)):
        # in turns: uninstrumented, instrumented, instrumented,
        # uninstrumented; each run on servers of its own
        sans = [None, counting_sanitizer(), counting_sanitizer(), None]
        runs = [serve_with_sanitizer(torch, ops, store, heads, batches,
                                     fstore, make, san) for san in sans]
        plain, got = runs[0], runs[1]
        for run in runs[1:3]:
            for k in launches:
                launches[k] += run[3][k]
        equal = all(np.array_equal(a, b)
                    for run in runs[1:]
                    for a, b in zip(run[0] + run[1], plain[0] + plain[1]))
        walls = {kind: [w for run in pair for w in run[2]]
                 for kind, pair in (("plain", (runs[0], runs[3])),
                                    ("sanitized", runs[1:3]))}
        san = sans[1]
        log(f"[sanitize] {name}: batches={SANITIZE_BATCHES} "
            f"events={san.emitted} by_op={dict(sorted(san.by_op.items()))} "
            f"violations={len(san.violations) + len(sans[2].violations)} "
            f"batch_ms_median={np.median(walls['sanitized']) * 1e3:.3f} "
            f"(uninstrumented {np.median(walls['plain']) * 1e3:.3f}) "
            f"batch_ms_mean={np.mean(walls['sanitized']) * 1e3:.3f} "
            f"(uninstrumented {np.mean(walls['plain']) * 1e3:.3f}) "
            f"over 2 x {SANITIZE_BATCHES} batches each, launches={got[3]} "
            f"bit_equal={equal}")
        if san.violations or sans[2].violations or not equal:
            raise AssertionError(f"[sanitize] {name}: {san.report()}\n"
                                 f"{sans[2].report()}")
        # what each run must have had checked: the single slab's kernel
        # reads (its maps come from remap, which tags them); the shards'
        # loads and borrow staging (their maps reach into the staging
        # tail, are minted per batch outside remap, and carry no tag)
        need = {"load_group": 1, "evict": 1}
        need.update({"gather_rows": SANITIZE_BATCHES,
                     "virtual_matmul": SANITIZE_BATCHES}
                    if name == "single" else {"stage_borrows": 1})
        short = {op: san.by_op.get(op, 0) for op, n in need.items()
                 if san.by_op.get(op, 0) < n}
        if short or got[3]["dedup_matmul"] != SANITIZE_BATCHES \
                or got[3]["dedup_embedding"] < SANITIZE_BATCHES:
            raise AssertionError(f"[sanitize] {name}: too few checked "
                                 f"events {short} (wanted {need}), "
                                 f"launches {got[3]}")
    log(f"[sanitize] injected on cuda pools: "
        f"{injected_faults(torch, ops, store, fstore)}")
    log(f"[sanitize] seconds={time.perf_counter() - t_phase:.1f}")
    return launches


# ------------------------------------------------------------ pressure --
def record_pools(srv):
    """Record every hit flag the server's buffer pools return and every
    eviction they make, in order; returns (flags, evictions)."""
    flags, evicted = [], []
    pools = srv.sharded.buffer_pools if hasattr(srv, "sharded") \
        else [srv.pool]
    for i, bp in enumerate(pools):
        def access(model, pid, i=i, orig=bp.access):
            out = orig(model, pid)
            flags.append((i, int(pid), out))
            return out

        def access_group(model, pids, i=i, orig=bp.access_group):
            out = orig(model, pids)
            flags.append((i, "group", list(out)))
            return out

        def on_evict(pid, i=i, orig=bp.on_evict):
            evicted.append((i, int(pid)))
            orig(pid)
        bp.access, bp.access_group, bp.on_evict = access, access_group, \
            on_evict
    return flags, evicted


def no_host_weights(store):
    """Make every host materialization of a weight raise."""
    def refuse(*a, **k):
        raise AssertionError("[pressure] a weight was materialized on the "
                             "host")
    store.materialize = refuse
    store.materialize_rows = refuse


def serve_pressed(torch, url, heads, batches, capacity, kernel_mode,
                  shards=1, san=None, hook=None):
    """The batches in order (overlap on, prefetch off: it reads the host
    clock) through a server of ``capacity`` pages (a shard) on the
    database, ``store.materialize`` refused; recorded, or instrumented by
    ``san``; ``hook(server)`` runs before the first batch.  (logits,
    {"engine", "server": ServeStats fields but the wall-clock ones},
    flags, evictions, server, wall s, engine)."""
    import dataclasses
    from repro_torch.db import DedupDB
    from repro_torch.launch.mesh import shard_devices
    from repro_torch.serving import (EmbeddingServingEngine,
                                     ShardedWeightServer, StorageModel,
                                     WeightServer)
    db = DedupDB.open(url)
    no_host_weights(db.store)
    if shards == 1:
        srv = WeightServer(db.store, capacity, storage=StorageModel("dram"),
                           kernel_mode=kernel_mode)
    else:
        srv = ShardedWeightServer(db.store, capacity,
                                  storage=StorageModel("dram"),
                                  shards=shards, placement="hash",
                                  kernel_mode=kernel_mode,
                                  devices=shard_devices(shards, kernel_mode))
    flags = evicted = None
    if san is not None:
        instrument(san, srv)
    else:
        flags, evicted = record_pools(srv)
    engine = EmbeddingServingEngine(srv, heads, scheduler="fifo",
                                    overlap=True)
    if hook is not None:
        hook(srv)
    out = []
    t0 = time.perf_counter()
    for model, docs in batches:
        engine.submit(model, docs)
        engine.run(max_batches=1)
        out.append(engine.last_logits.copy())
    if kernel_mode == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wall_fields = {"compute_seconds", "latencies", "timeline_seconds",
                   "transfer_seconds"}
    stats = {who: {f.name: getattr(st, f.name)
                   for f in dataclasses.fields(st)
                   if f.name not in wall_fields}
             for who, st in (("engine", engine.stats), ("server", srv.stats))}
    db.close()
    return out, stats, flags, evicted, srv, wall, engine


def tail_counts(srv):
    pools = getattr(srv.device_pool, "pools", [srv.device_pool])
    page_b = pools[0].transfer.page_nbytes
    return dict(tail_rows=sum(p.overflow_rows for p in pools),
                slab_bytes=sum(p.capacity for p in pools) * page_b,
                tail_bytes=sum(p.overflow_rows for p in pools) * page_b,
                calls=sum(p.tail_calls for p in pools),
                staged_pages=sum(p.tail_staged for p in pools),
                tail_writes=sum(p.tail_writes for p in pools),
                chunks=sum(p.tail_chunks for p in pools),
                loads=srv.device_pool.loads, evicts=srv.device_pool.evicts)


def dense_logits(url, heads, batches):
    """Each batch's logits from the store's materialized embeddings, in
    numpy as the reference's host path computes them: the independent
    reference for the staged runs, made once outside the timed runs."""
    from repro_torch.db import DedupDB
    db = DedupDB.open(url)
    emb = {m: db.store.materialize(m, "embedding")
           for m in sorted({m for m, _ in batches})}
    db.close()
    return [emb[m][d].mean(axis=1) @ heads[m] for m, d in batches]


def host_split(targets):
    """Wrap each ``(obj, attr, label)`` with a host timer; a call made
    inside another wrapped call counts under ``caller/label``.  Returns
    (seconds by label path, undo)."""
    import collections
    tot, stack, undo = collections.Counter(), [], []
    for obj, attr, label in targets:
        orig = getattr(obj, attr)

        def timed(*a, _orig=orig, _label=label, **k):
            stack.append(_label)
            key = "/".join(stack)
            t = time.perf_counter()
            try:
                return _orig(*a, **k)
            finally:
                tot[key] += time.perf_counter() - t
                stack.pop()
        undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, timed)

    def restore():
        for obj, attr, was in reversed(undo):
            if was is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, was)
    return tot, restore


def split_targets(ops, srv):
    """What a staged batch does on the host, by step: the pool access
    and its per-page loads (the store read, the pinned copy, the
    host->device enqueue), the next batch's prestage, and the gather:
    its tail writes (page stack, pinned copy, enqueue, commit) and the
    kernel's wrapper.  The rest is the engine's own, the wait for the
    logits included."""
    pool = srv.device_pool
    tr = pool.transfer
    return [(srv, "_access", "access"),
            (srv, "device_gather_rows", "gather"),
            (srv.pool, "on_load", "page_load"),
            (tr, "stage", "prestage"),
            (pool, "_write_overflow", "tail_write"),
            (pool.store, "page_array", "page_array"),
            (pool.store, "page_stack", "page_stack"),
            (tr, "host_tensor", "pinned_copy"),
            (tr, "ship", "h2d_enqueue"),
            (pool, "write_stage", "tail_commit"),
            (ops, "dedup_embedding_striped", "kernel")]


#: batches of the tail sweep and the profile (the first of the 40)
SPLIT_BATCHES = 10


def pressure_split(torch, ops, url, heads, batches, cap):
    """The single slab's first :data:`SPLIT_BATCHES` batches in cuda mode
    at overflow tails of 8, 32 (the default) and 64 pages, each with its
    host time split by step (:func:`host_split`), then once at the
    default under torch.profiler for the device's share."""
    from repro_torch.serving import device_pool
    default = device_pool.TAIL_PAGES
    batches = batches[:SPLIT_BATCHES]
    for tail in (8, default, 64):
        device_pool.TAIL_PAGES = tail
        split = {}

        def hook(srv):
            split["tot"], split["undo"] = host_split(split_targets(ops, srv))
        try:
            got = serve_pressed(torch, url, heads, batches, cap, "cuda",
                                hook=hook)
        finally:
            device_pool.TAIL_PAGES = default
            if "undo" in split:
                split["undo"]()
        wall = got[5]
        tails = tail_counts(got[4])
        top = sum(v for k, v in split["tot"].items() if "/" not in k)
        parts = " ".join(f"{k}={v * 1e3:.1f}"
                         for k, v in sorted(split["tot"].items()))
        log(f"[pressure-split] TAIL_PAGES={tail}: tail="
            f"{tails['tail_rows']} pages ({tails['tail_bytes']} B) "
            f"batches={len(batches)} wall={wall:.3f}s "
            f"per_batch={wall / len(batches) * 1e3:.2f}ms "
            f"chunks={tails['chunks']} staged={tails['staged_pages']} "
            f"loads={tails['loads']} host ms: {parts} "
            f"rest={(wall - top) * 1e3:.1f}")
    profile_serving(torch, url, heads, batches, cap,
                    tag="[pressure-profile]", top=12,
                    run=lambda: serve_pressed(torch, url, heads, batches,
                                              cap, "cuda")[6])


def pressure_phase(torch, ops, url, heads, batches, fstore):
    """[pressure]: the paper's working set larger than the memory that
    holds it.  The 40 batches at a slab of half the store (177 of 355
    pages, below each batch's ~321) in cuda mode: every batch through the
    staging tail (``TAIL_PAGES``; slab + tail below every batch's page
    set) and ``dedup_embedding``, no weight materialized on the host,
    logits 1e-5 of host mode and of dense numpy logits from the store's
    materialized embeddings, and the pool's hit flags, loads, evictions
    and ServeStats equal to host mode's; the same over 2 hash shards of
    88 pages (owned groups and borrow sets both past their shard); each
    run again under the strict PoolSanitizer (0 violations, bit-equal);
    the single slab's host split, tail sweep and device profile
    (:func:`pressure_split`); the FFNN product at a slab of half W1's
    pages within 1e-4 of numpy.  Returns the counted runs' launches."""
    import numpy as np
    from repro_torch.db import DedupDB
    from repro_torch.serving import StorageModel, WeightServer
    t_phase = time.perf_counter()
    db = DedupDB.open(url)
    pages = db.store.num_pages()
    planner = WeightServer(db.store, 2, backend="numpy")   # page maps only
    least = min(len(planner.embedding_rows_pages(m, "embedding",
                                                 np.unique(d)))
                for m, d in batches)
    db.close()
    half = pages // 2
    dense = dense_logits(url, heads, batches)
    launches = {"dedup_embedding": 0, "dedup_matmul": 0}
    for shards, cap in ((1, half), (2, half // 2)):
        name = "single" if shards == 1 else f"{shards}xhash"
        host = serve_pressed(torch, url, heads, batches, cap, "host", shards)
        ops.reset_launches()
        got = serve_pressed(torch, url, heads, batches, cap, "cuda", shards)
        n = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += n[k]
        san = counting_sanitizer()
        checked = serve_pressed(torch, url, heads, batches, cap, "cuda",
                                shards, san=san)
        err = max_err(got[0], host[0])
        derr = max_err(got[0], dense)
        tails = tail_counts(got[4])
        same = {"flags": got[2] == host[2], "evictions": got[3] == host[3],
                "stats": got[1] == host[1],
                "loads": (tails["loads"], tails["evicts"])
                == (host[4].device_pool.loads, host[4].device_pool.evicts)}
        bit_equal = all(np.array_equal(a, b)
                        for a, b in zip(checked[0], got[0]))
        st = got[1]["engine"]
        page_b = got[4].device_pool.pools[0].transfer.page_nbytes \
            if shards > 1 else got[4].device_pool.transfer.page_nbytes
        log(f"[pressure] {name}: slab={cap} pages a shard of {pages} "
            f"(slab+tail {tails['slab_bytes'] + tails['tail_bytes']} B of "
            f"the store's {pages * page_b} B) "
            f"batches={st['batches']} dense_fallbacks={st['dense_fallbacks']}"
            f" device_batches={st['device_batches']} {tails} "
            f"dedup_embedding={n['dedup_embedding']} "
            f"max_abs_err={err:.3e} vs host mode, {derr:.3e} vs dense "
            f"numpy (tol 1e-5) equal_to_host={same} "
            f"wall={got[5]:.3f}s (host mode {host[5]:.3f}s) "
            f"sanitized: events={san.emitted} "
            f"violations={len(san.violations)} bit_equal={bit_equal} "
            f"wall={checked[5]:.3f}s")
        if err > 1e-5 or derr > 1e-5 or not all(same.values()) \
                or san.violations or not bit_equal:
            raise AssertionError(f"[pressure] {name}: err={err} "
                                 f"dense={derr} {same} "
                                 f"bit_equal={bit_equal}\n{san.report()}")
        if n["dedup_embedding"] < BATCHES or tails["calls"] < 1 \
                or st["dense_fallbacks"] != tails["calls"] \
                or shards * cap + tails["tail_rows"] >= least:
            raise AssertionError(f"[pressure] {name}: launches {n}, "
                                 f"tail {tails}, stats {st}")
        if shards == 1:
            pressure_split(torch, ops, url, heads, batches, cap)
    # the FFNN product with W1's pages past the slab
    w1 = fstore.virtual_tensor("ffnn-1", "W1").page_ids
    fcap = max(1, len(w1) // 2)
    x = np.random.default_rng(SEED + 3).standard_normal(
        (64, 2048)).astype(np.float32)
    want = x @ fstore.materialize("ffnn-1", "W1")
    ys = {}
    for mode in ("host", "cuda"):
        fsrv = WeightServer(fstore, fcap, storage=StorageModel("dram"),
                            kernel_mode=mode)
        fsrv.access_pages("ffnn-1", fstore.model_pages("ffnn-1"))
        ops.reset_launches()
        y = fsrv.device_matmul("ffnn-1", "W1", x)
        if mode == "cuda":
            torch.cuda.synchronize()
            n = dict(ops.LAUNCHES)
            launches["dedup_matmul"] += n["dedup_matmul"]
            y = y.cpu().numpy()
            ftail = tail_counts(fsrv)
        ys[mode] = np.asarray(y)
    ferr = float(np.abs(ys["cuda"] - want).max())
    log(f"[pressure] FFNN: slab={fcap} pages of W1's {len(w1)} "
        f"dedup_matmul={n['dedup_matmul']} {ftail} "
        f"max_abs_err={ferr:.3e} vs numpy (tol 1e-4), host mode "
        f"{float(np.abs(ys['host'] - want).max()):.3e}")
    if not np.allclose(ys["cuda"], want, rtol=1e-4, atol=1e-4) \
            or n["dedup_matmul"] < 1 or ftail["calls"] != 1:
        raise AssertionError(f"[pressure] FFNN: err={ferr} launches={n} "
                             f"tail={ftail}")
    log(f"[pressure] seconds={time.perf_counter() - t_phase:.1f}")
    return launches


# ------------------------------------------------- examples + LM CLI --
EXAMPLE_SKIP = {
    # lines read off the host's clock or only the port prints (where each
    # batch was served, the kernels' launches), and the database's path
    "torch_quickstart": ("committed store to", "device:", "[kernels]"),
    "torch_multi_model_serving": ("compute time", "end-to-end",
                                  "p50 / p99", "device", "[kernels]"),
    "torch_finetune_dedup": ("[kernels]",),
    "torch_train_tiny": ("step ", "loss:", "checkpoints in"),
}
#: train_tiny's steps here (its default is the reference's 200)
EXAMPLE_TRAIN_STEPS = 20
#: train_tiny's losses, card against CPU (fp32; other GEMM orders)
EXAMPLE_LOSS_TOL = 1e-3


def example_lines(name, text):
    """The lines of an example's output the card's run must print
    exactly as the CPU's; for multi-model serving the async run's hit
    ratio and I/O go too (the prefetch budget reads the compute clock)."""
    lines = text.splitlines()
    if name == "torch_multi_model_serving":
        i = next(i for i, ln in enumerate(lines) if ln.startswith("[async"))
        j = next(i for i, ln in enumerate(lines) if ln.startswith("[open"))
        lines = lines[:i + 2] + lines[j:]
    return [ln for ln in lines
            if not ln.strip().startswith(EXAMPLE_SKIP[name])]


def launches_printed(text):
    """The kernel launches a port process printed (``launches={...}``
    on its ``[kernels]`` or ``[tokens]`` line), or None."""
    for ln in text.splitlines():
        if ln.startswith(("[kernels]", "[tokens]")) and "launches=" in ln:
            return json.loads(ln.split("launches=", 1)[1])
    return None


#: what each card process must have launched at least once
EXAMPLE_KERNELS = {
    "torch_quickstart": ("lsh_signature", "dedup_embedding"),
    "torch_multi_model_serving": ("lsh_signature", "dedup_embedding"),
    "torch_finetune_dedup": ("lsh_signature",),
    "torch_train_tiny": (),
    "cli-lm": ("lsh_signature", "flash_attention"),
}


def train_losses(text):
    return [float(ln.split()[3]) for ln in text.splitlines()
            if ln.startswith("step ")]


def examples_phase(torch):
    """[examples] + [cli-lm-half]: each port example (``examples/torch_
    *.py``) on the card and with ``--device cpu``, all eight processes at
    once, and the LM CLI at ``--capacity-pages 0`` (the reference's half
    of the store, at least 2 pages) in cuda mode and on the CPU beside
    them.  Every process exits 0; each example's deterministic lines
    equal its CPU run's (``torch_train_tiny`` at ``--steps 20``, not the
    reference's 200, for time: its losses within ``EXAMPLE_LOSS_TOL``);
    the CLI's greedy tokens (the ``[tokens]`` digest) and store are equal,
    and its card run serves the switches the half slab cannot hold
    through the staging tail.  Returns the kernel launches the card
    processes printed (each must have launched its path's kernels; the
    CPU runs none)."""
    import os
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_")
    # ten processes share the host's cores: two threads each
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp.name,
               OMP_NUM_THREADS="2")
    procs = {}
    for name in EXAMPLE_SKIP:
        extra = ["--steps", str(EXAMPLE_TRAIN_STEPS)] \
            if name == "torch_train_tiny" else []
        for device in ("cuda", "cpu"):
            run_env = dict(env, TMPDIR=os.path.join(tmp.name, device))
            os.makedirs(run_env["TMPDIR"], exist_ok=True)
            procs[(name, device)] = subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                 "--device", device, *extra], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=run_env,
                cwd=str(ROOT))
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--engine", "lm",
           "--vocab", "512", "--capacity-pages", "0"]
    for device, extra in (("cuda", []), ("cpu", ["--kernel-mode", "torch",
                                                 "--index-mode", "torch"])):
        procs[("cli-lm", device)] = subprocess.Popen(
            cli + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=str(ROOT))
    outs = {}
    try:
        for key, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"[examples] {key} exited "
                                     f"{proc.returncode}:\n{out[-2000:]}\n"
                                     f"{err[-2000:]}")
            outs[key] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    launches = {}
    for key, out in outs.items():
        got = launches_printed(out) or {}
        need = EXAMPLE_KERNELS[key[0]] if key[1] == "cuda" else ()
        if any(got.get(k, 0) < 1 for k in need) \
                or (key[1] == "cpu" and any(got.values())):
            raise AssertionError(f"[examples] {key}: launches {got}, "
                                 f"wanted {need}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    log(f"[examples] launches on the card: {launches}")
    for name in EXAMPLE_SKIP:
        card, cpu = outs[(name, "cuda")], outs[(name, "cpu")]
        same = example_lines(name, card) == example_lines(name, cpu)
        extra = ""
        if name == "torch_train_tiny":
            a, b = train_losses(card), train_losses(cpu)
            loss_err = max(abs(x - y) for x, y in zip(a, b)) \
                if a and len(a) == len(b) else float("inf")
            same = same and loss_err <= EXAMPLE_LOSS_TOL
            extra = (f" losses={len(a)} max_abs_err={loss_err:.3e} (tol "
                     f"{EXAMPLE_LOSS_TOL})")
        last = [ln for ln in card.splitlines() if ln.strip()][-1]
        log(f"[examples] {name}: exit 0 on the card and the CPU, "
            f"lines={len(example_lines(name, card))} equal={same}{extra} "
            f"last: {last.strip()}")
        if not same:
            raise AssertionError(f"[examples] {name}: the card's lines "
                                 f"differ from the CPU's:\n{card}\n----\n"
                                 f"{cpu}")
    kv = {}
    for device in ("cuda", "cpu"):
        text = outs[("cli-lm", device)]
        lines = {tag: [ln for ln in text.splitlines() if ln.startswith(tag)]
                 for tag in ("[store]", "[device]", "[tokens]")}
        if not all(lines.values()):
            raise AssertionError(f"[cli-lm-half] {device}: missing lines:\n"
                                 f"{text}")
        kv[device] = {tag: ln[0] for tag, ln in lines.items()}
        kv[device]["dev"] = dict(p.split("=", 1)
                                 for p in lines["[device]"][0].split()
                                 if "=" in p)
    card, cpu = kv["cuda"], kv["cpu"]
    log(f"[cli-lm-half] card: {card['[store]']} | {card['[device]']} | "
        f"{card['[tokens]']}")
    log(f"[cli-lm-half] cpu:  {cpu['[device]']} | {cpu['[tokens]']}")
    if card["[tokens]"].split(" launches=")[0] \
            != cpu["[tokens]"].split(" launches=")[0] \
            or card["[store]"] != cpu["[store]"] \
            or card["dev"]["mode"] != "cuda" \
            or int(card["dev"]["dense_fallbacks"]) < 1 \
            or card["dev"]["dense_fallbacks"] != cpu["dev"]["dense_fallbacks"]:
        raise AssertionError(f"[cli-lm-half] {card} / {cpu}")
    log(f"[examples] seconds={time.perf_counter() - t0:.1f}")
    return launches


# -------------------------------------------------------------- training --
def train_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), num_layers=TRAIN_DEPTH)


def train_args(*extra):
    """The trainer's flags for the full-width runs (parsed by the port's
    own ``launch.train``)."""
    from repro_torch.launch.train import parse_args
    return parse_args(["--arch", LM_ARCH, "--batch", str(TRAIN_BATCH),
                       "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
                       "--seed", str(SEED), "--log-every", "5",
                       "--device", DEVICE, *map(str, extra)])


def run_train(torch, ops, cfg, tag, *extra, init=None):
    """One ``launch.train.train`` run on the card (from the numpy ``init``
    tree where given), in a window of its own: no kernel may launch (the
    loss runs the plain attention).  Returns its result and prints
    losses, step times, tokens/s and peak memory."""
    import numpy as np
    from repro_torch.launch.train import train
    before = dict(ops.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(cfg, train_args(*extra), init=init)
    wall = time.perf_counter() - t0
    if ops.LAUNCHES != before:
        raise AssertionError(f"{tag}: training launched kernels: "
                             f"{before} -> {ops.LAUNCHES}")
    losses = out["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    steady = out["step_seconds"][1:] or out["step_seconds"]
    ms = np.asarray(steady) * 1e3
    out["step_ms"] = float(np.median(ms))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} steps={len(losses)} first_loss={losses[0]:.4f} "
        f"last_loss={losses[-1]:.4f} first_step_ms="
        f"{out['step_seconds'][0] * 1e3:.1f} step_ms_median="
        f"{out['step_ms']:.1f} min={ms.min():.1f} max={ms.max():.1f} "
        f"tokens_per_s={TRAIN_BATCH * TRAIN_SEQ / out['step_ms'] * 1e3:.0f} "
        f"peak_mem={out['peak_gb']:.2f}GB wall={wall:.1f}s")
    log(f"{tag} losses={[round(x, 5) for x in losses]}")
    return out


def train_split(torch, cfg, params, opt_state, tag="[train-split]"):
    """Where a step's time goes: forward + backward against ``opt.update``
    (host clock around each, synchronised), over TRAIN_SPLIT_STEPS steps
    on the overfit batch; then the same steps under torch.profiler:
    device-busy share of the window and the top device ops."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import token_batches
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import build
    from repro_torch.optim import cosine_schedule, make_optimizer
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR,
                         schedule=cosine_schedule(TRAIN_LR, warmup=5,
                                                  total=TRAIN_STEPS))
    dev = torch.device(DEVICE)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(token_batches(
        cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)).items()}
    fb, up = [], []
    for _ in range(TRAIN_SPLIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = value_and_grad(lambda p: api.loss(p, batch), params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt_state, _ = opt.update(grads, opt_state, params)
        torch.cuda.synchronize()
        up.append(time.perf_counter() - t1)
        fb.append(t1 - t0)
        del grads
    log(f"{tag} fwd+bwd_ms={[round(x * 1e3, 1) for x in fb]} "
        f"opt_update_ms={[round(x * 1e3, 1) for x in up]} "
        f"update_share={np.sum(up) / (np.sum(up) + np.sum(fb)):.3f}")
    step = make_train_step(api, opt)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_SPLIT_STEPS):
            params, opt_state, m = step(params, opt_state, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(r[1] for r in rows)
    log(f"[train-profile] wall={wall * 1e3:.1f}ms device_busy="
        f"{busy_us / 1e3:.1f}ms busy_share={busy_us / 1e6 / wall:.4f} "
        f"({TRAIN_SPLIT_STEPS} steps)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[train-profile] {us / 1e3:9.3f}ms {n:6d}x  {key[:90]}")
    return float(np.median(fb)) * 1e3, float(np.median(up)) * 1e3, \
        busy_us / 1e6 / wall


def train_phase(torch, ops, tmpdir):
    """deepseek-7b at full width (vocabulary 102,400), depth cut 30 ->
    TRAIN_DEPTH, bf16 params, AdamW, through the port's
    ``launch.train.train``: [train] (--overfit, the reference's
    criterion), the step split and profile, [train-resume] (checkpointed
    at RESUME_AT and resumed with --resume auto: losses within 1e-3 of
    the unbroken run's) and [train-compress] (--compress-grads: the last
    loss within 0.25 of the uncompressed run's), both at RESUME_DEPTH.
    Each depth's params are drawn on the host once; the record keeps
    TRAIN_DEPTH's (``init``) for [pipeline] and [dist-step]."""
    import dataclasses
    import shutil
    import numpy as np
    from repro_torch.models import build
    cfg = train_config()
    n = cfg.param_count() + (2 * TRAIN_DEPTH + 1) * cfg.d_model
    log(f"[train] {LM_ARCH} d_model={cfg.d_model} heads={cfg.num_heads}x"
        f"{cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab} depth={TRAIN_DEPTH} "
        f"params={n} dtype={cfg.dtype} remat={cfg.remat} "
        f"optimizer={cfg.optimizer} lr={TRAIN_LR} batch={TRAIN_BATCH}x"
        f"{TRAIN_SEQ}")
    t0 = time.perf_counter()
    init = build(cfg).init(SEED, TRAIN_SEQ * 2)
    log(f"[train] depth={TRAIN_DEPTH} host init "
        f"{time.perf_counter() - t0:.1f}s")
    out = run_train(torch, ops, cfg, "[train]", "--steps", TRAIN_STEPS,
                    "--overfit", init=init)
    losses = out["losses"]
    drop = float(np.mean(losses[:5]) - np.mean(losses[-5:]))
    if drop < 0.5:
        raise AssertionError(f"[train] the mean of the last 5 losses is "
                             f"{drop:.4f} below the first 5's, wanted >= 0.5")
    fb_ms, up_ms, busy = train_split(torch, cfg, out["params"],
                                     out["opt_state"])
    rec = dict(step_ms=out["step_ms"], peak_gb=out["peak_gb"], drop=drop,
               fwd_bwd_ms=fb_ms, update_ms=up_ms, busy_share=busy,
               params=n, losses=losses, init=init)
    del out
    log(f"[train] overfit drop={drop:.4f} (>= 0.5) "
        f"seconds={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    ck = str(Path(tmpdir) / "train_ckpt")
    cfg = dataclasses.replace(cfg, num_layers=RESUME_DEPTH)
    init = build(cfg).init(SEED, TRAIN_SEQ * 2)
    full = run_train(torch, ops, cfg, "[train-resume] unbroken",
                     "--steps", RESUME_STEPS, init=init)["losses"]
    run_train(torch, ops, cfg, "[train-resume] first", "--steps", RESUME_AT,
              "--ckpt", ck, init=init)
    resumed = run_train(torch, ops, cfg, "[train-resume] resumed",
                        "--steps", RESUME_STEPS, "--ckpt", ck,
                        "--resume", "auto", init=init)["losses"]
    shutil.rmtree(ck)
    err = float(np.max(np.abs(np.asarray(resumed)
                              - np.asarray(full[RESUME_AT:]))))
    if len(resumed) != RESUME_STEPS - RESUME_AT or err > 1e-3:
        raise AssertionError(f"[train-resume] resumed losses {resumed} vs "
                             f"unbroken {full[RESUME_AT:]}")
    log(f"[train-resume] depth={RESUME_DEPTH} steps {RESUME_AT}-"
        f"{RESUME_STEPS - 1}: "
        f"max_abs_err={err:.3e} (tol 1e-3) "
        f"seconds={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    comp = run_train(torch, ops, cfg, "[train-compress]", "--steps",
                     RESUME_STEPS, "--compress-grads", init=init)["losses"]
    gap = abs(comp[-1] - full[-1])
    if gap >= 0.25:
        raise AssertionError(f"[train-compress] last loss {comp[-1]} vs "
                             f"uncompressed {full[-1]}")
    log(f"[train-compress] depth={RESUME_DEPTH} last_loss={comp[-1]:.4f} "
        f"uncompressed="
        f"{full[-1]:.4f} gap={gap:.4f} (< 0.25) "
        f"seconds={time.perf_counter() - t0:.1f}")
    return rec


def _lm_key(params, key):
    """The tensor at a ``lm_tensors`` key in params that ``rebuild``
    returned (per-layer groups as lists)."""
    node = params
    for part in key.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def finetune_phase(torch, ops, store, lm32):
    """Paper Sec. 4.3 on the LM store: lm-v1's gradient masks (1 on
    blocks private to v1) mapped onto its fp32 params taken from the
    store, FT_STEPS Adafactor steps with the masks as ``grad_transform``,
    every masked element bit-equal to ``store.materialize``; then
    ``store.update("lm-v1", tuned, approach=2)`` and the pages rewritten
    (pages of the new packing whose blocks no old page holds) against
    the pages that hold a private block.  Returns the update's
    lsh_signature launches."""
    import dataclasses
    import numpy as np
    from repro_torch.convert import train_params
    from repro_torch.core.finetune import gradient_masks, private_block_mask
    from repro_torch.data.pipeline import token_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    model = "lm-v1"
    cfg = dataclasses.replace(lm_config(), dtype="float32")
    dev = torch.device(DEVICE)
    masks = gradient_masks(store.dedup, model)
    dense = {k: store.materialize(model, k) for k in lm32.tensors}
    params = train_params(tree_map(lambda t: t.numpy(), lm32.rebuild(dense)),
                          cfg, dev)
    mask_tree = lm32.rebuild(masks, device=dev)
    n_masked = sum(int((m == 0).sum()) for m in masks.values())
    step = make_train_step(
        build(cfg), make_optimizer("adafactor", lr=TRAIN_LR),
        grad_transform=lambda g: tree_map(torch.mul, g, mask_tree))
    opt_state = make_optimizer("adafactor").init(params)
    data = token_batches(cfg.vocab, FT_BATCH, FT_SEQ, seed=SEED + 9)
    ops.reset_launches()
    losses = []
    for _ in range(FT_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(data).items()}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    if any(ops.LAUNCHES.values()) or not all(np.isfinite(losses)):
        raise AssertionError(f"[finetune] launches {ops.LAUNCHES}, losses "
                             f"{losses}")
    tuned, changed = {}, 0
    for key, want in dense.items():
        got = _lm_key(params, key).detach().cpu().numpy().reshape(want.shape)
        frozen = masks[key] == 0
        if not np.array_equal(got[frozen], want[frozen]):
            raise AssertionError(f"[finetune] {key}: a masked element moved")
        changed += int((got != want).sum())
        tuned[key] = got
    del params, opt_state, mask_tree
    t_train = time.perf_counter() - t0
    if changed == 0:
        raise AssertionError("[finetune] no private element moved")

    # the pages the update rewrites, against the pages of private blocks
    old_pages = store.packing.pages
    private = set()
    for key, e in store.dedup.models[model].tensors.items():
        pm = private_block_mask(store.dedup, model, key)
        private.update(int(d) for d, p in zip(e.block_map, pm) if p == 1.0)
    private_pages = sum(1 for page in old_pages
                        if any(int(d) in private for d in page))
    old = {tuple(page) for page in old_pages}
    ops.reset_launches()
    t1 = time.perf_counter()
    n_distinct = len(store.dedup.distinct)
    res = store.update(model, tuned, approach=2)
    rewritten = sum(1 for page in store.packing.pages
                    if tuple(page) not in old)
    t_update = time.perf_counter() - t1
    lsh_launches = ops.LAUNCHES["lsh_signature"]
    all_tf32x3(ops, lsh_launches, "[finetune] update")
    if rewritten > private_pages:
        raise AssertionError(f"[finetune] {rewritten} pages rewritten, "
                             f"more than the {private_pages} private pages")
    log(f"[finetune] {model} fp32 depth={cfg.num_layers} vocab={cfg.vocab} "
        f"adafactor steps={FT_STEPS} batch={FT_BATCH}x{FT_SEQ} "
        f"losses={[round(x, 4) for x in losses]} masked_elements="
        f"{n_masked} bit_equal=yes elements_changed={changed} "
        f"train={t_train:.1f}s")
    log(f"[finetune] update approach=2: blocks={res.total_blocks} "
        f"deduped={res.deduped_blocks} new_distinct="
        f"{len(store.dedup.distinct) - n_distinct} pages_rewritten="
        f"{rewritten} private_pages={private_pages} pages="
        f"{store.packing.num_pages} lsh_launches={lsh_launches} "
        f"update={t_update:.1f}s seconds={time.perf_counter() - t0:.1f}")
    return lsh_launches


# ---------------------------------------------------------- distribution --
# the dry-run cells traced on the production meshes, one subprocess each
# (a fake world of 256 or 512 ranks on the host's CPU; no card): (arch,
# shape, multi-pod, variant)
DRYRUN_CELLS = [("deepseek-7b", "train_4k", False, "baseline"),
                ("qwen2-72b", "prefill_32k", False, "baseline"),
                ("mamba2-1.3b", "decode_32k", True, "baseline"),
                ("deepseek-7b", "decode_32k", False, "dedup_serving"),
                ("deepseek-7b", "decode_32k", False,
                 "dedup_serving_dense_ref"),
                ("qwen3-14b", "long_500k", False, "baseline")]
DRYRUN_TIMEOUT = 600
# [pipeline]: deepseek-7b's full-width layers (depth TRAIN_DEPTH), two
# stages of two layers, PIPE_MICRO microbatches of 1 x TRAIN_SEQ, prefill
PIPE_STAGES, PIPE_MICRO = 2, 4
DIST_STEPS = 3
HW_GEMM, HW_COPY_BYTES = 8192, 1 << 30


def dryrun_start(outdir):
    """Start every [dryrun] cell in a subprocess of its own, with no card
    visible and one thread each; they run while the card's phases do."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, multi, variant in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--variant", variant, "--out",
               str(outdir)] + (["--multi-pod"] if multi else [])
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def dryrun_finish(procs, outdir, t_start):
    """Wait for the [dryrun] cells and print one line a cell: status, mesh,
    per-device FLOPs, bytes, collective bytes by kind, argument bytes,
    the dominant roofline term and useful_flops_ratio.  Every cell must be
    ok but qwen3-14b long_500k, which must be skipped with the
    reference's reason."""
    from repro_torch.launch.dryrun import cell_path
    from repro_torch.roofline import HW
    deadline = t_start + DRYRUN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[dryrun] HW peak_flops={HW['peak_flops']:.3e} hbm_bw="
        f"{HW['hbm_bw']:.3e} nvlink_bw={HW['nvlink_bw']:.3e} (H100 SXM5 "
        f"datasheet); {len(procs)} cells traced on the host beside the "
        f"card's phases, read back {time.perf_counter() - t_start:.1f}s "
        f"after their start (each cell's own trace_s below)")
    for (arch, shape, multi, variant), p in zip(DRYRUN_CELLS, procs):
        path = Path(cell_path(str(outdir), arch, shape, multi, variant))
        if p.returncode != 0 or not path.exists():
            raise AssertionError(f"[dryrun] {arch} {shape} {variant}: exit "
                                 f"{p.returncode}: {p.stderr.read()[-2000:]}")
        rec = json.loads(path.read_text())
        tag = f"[dryrun] {arch} {shape} {variant} " \
              f"{'multi' if multi else 'single'}-pod"
        if shape == "long_500k":
            if rec["status"] != "skipped" or \
                    "full-attention" not in rec["reason"]:
                raise AssertionError(f"{tag}: {rec['status']} "
                                     f"{rec.get('reason')}")
            log(f"{tag} status=skipped reason={rec['reason']!r}")
            continue
        if rec["status"] != "ok":
            raise AssertionError(f"{tag}: {rec['status']} "
                                 f"{rec.get('error', '')[:1500]}")
        c, m, rl = rec["collectives"], rec["memory_analysis"], rec["roofline"]
        kinds = {k: int(v) for k, v in c.items() if k not in (
            "count", "total", "weighted_total") and v}
        log(f"{tag} status=ok mesh={rec['meta']['mesh']} "
            f"flops_per_device={rec['cost_analysis']['flops']:.4e} "
            f"bytes={rec['cost_analysis']['bytes accessed']:.4e} "
            f"collective_bytes={kinds} count={c['count']} "
            f"argument_bytes={m['argument_size_in_bytes']} "
            f"dominant={rl['dominant']} compute_s={rl['compute_s']:.4e} "
            f"memory_s={rl['memory_s']:.4e} "
            f"collective_s={rl['collective_s']:.4e} "
            f"useful_flops_ratio={rl['useful_flops_ratio']:.4f} "
            f"trace_s={rec['lower_seconds']:.1f}")
        if not rec["cost_analysis"]["flops"] > 0 or \
                not m["argument_size_in_bytes"] > 0:
            raise AssertionError(f"{tag}: empty trace {rec}")


def hw_phase(torch):
    """[hw]: the card's name and power limit, its achieved bf16 GEMM rate
    (HW_GEMM^3, torch.matmul, measured only) and device-to-device copy
    bandwidth, each beside the roofline's datasheet number."""
    from repro_torch.roofline import HW
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(f"[hw] {smi.stdout.strip().splitlines()[0]}")
    n = HW_GEMM
    a = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    b = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    ms = eager_ms(torch, lambda: torch.matmul(a, b), reps=20, warm=3)
    rate = 2 * n ** 3 / (ms * 1e-3)
    log(f"[hw] bf16 GEMM {n}^3: {ms:.3f}ms = {rate / 1e12:.1f} TFLOP/s "
        f"({rate / HW['peak_flops']:.3f} of HW peak_flops "
        f"{HW['peak_flops'] / 1e12:.0f} TFLOP/s)")
    del a, b
    src = torch.empty(HW_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = eager_ms(torch, lambda: dst.copy_(src), reps=20, warm=3)
    bw = 2 * HW_COPY_BYTES / (ms * 1e-3)           # read + write
    log(f"[hw] device copy {HW_COPY_BYTES >> 20} MiB: {ms:.3f}ms = "
        f"{bw / 1e12:.3f} TB/s read+write ({bw / HW['hbm_bw']:.3f} of HW "
        f"hbm_bw {HW['hbm_bw'] / 1e12:.2f} TB/s); nvlink_bw "
        f"{HW['nvlink_bw'] / 1e9:.0f} GB/s not measured (one card)")
    del src, dst
    torch.cuda.empty_cache()


def slab_mesh_check(torch, ops, srv):
    """[slab-mesh]: ``stacked_slab(make_shard_mesh(n))`` of an n-shard
    server: a DTensor on the one-rank NCCL serving mesh whose local tensor
    is the per-shard stack bit for bit, and a dedup_embedding gather of
    each shard's rows through it equal to the gather from that shard's
    own slab (checks: uncounted launches)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_shard_mesh
    sh = srv.sharded
    mesh = make_shard_mesh(sh.num_shards)
    slab = sh.stacked_slab(mesh)
    plain = sh.stacked_slab()
    if not isinstance(slab, DTensor) or slab.device.type != "cuda" \
            or not torch.equal(slab.to_local(), plain):
        raise AssertionError(f"[slab-mesh] stacked_slab(mesh) != the "
                             f"per-shard stack ({type(slab).__name__})")
    S, cap, l, bh, bw = plain.shape
    flat = slab.to_local().reshape(S * cap * l, bh, bw)
    g = torch.Generator().manual_seed(SEED)
    worst = 0.0
    for s in range(S):
        own = sh.pools[s].slab[:cap].reshape(cap * l, bh, bw)
        rows = torch.randint(0, cap * l * bh, (512,), generator=g,
                             dtype=torch.int32).cuda()
        own_map = torch.arange(cap * l, dtype=torch.int32).reshape(-1, 1)
        got = ops.dedup_embedding_striped(rows, flat,
                                          (own_map + s * cap * l).cuda())
        want = ops.dedup_embedding_striped(rows, own, own_map.cuda())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[slab-mesh] shard {s}: the gather "
                                 f"through the mesh slab differs")
        worst = max(worst, float((got - want).abs().max()))
    log(f"[slab-mesh] mesh={mesh.mesh_dim_names}x{tuple(mesh.shape)} "
        f"({mesh.device_type}, {sh.num_shards} shards on one card) "
        f"placements={tuple(slab.placements)} shape={tuple(slab.shape)}: "
        f"local == per-shard stack bit for bit; dedup_embedding of 512 rows "
        f"a shard through it == the shard's own gather "
        f"(max_abs_err={worst:.1e})")


def dist_phase(torch, ops, train_rec):
    """[pipeline] and [dist-step] on deepseek-7b at full width, depth
    TRAIN_DEPTH, from the [train] run's initial params (``train_rec``'s
    host init).  Returns the pipeline's flash_attention launches."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.data.pipeline import token_batches
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_apply)
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map
    cfg = train_config()
    dev = torch.device(DEVICE)
    train_losses = train_rec["losses"]
    params = convert.train_params(train_rec.pop("init"), cfg, dev)

    # ---- [pipeline]: the GPipe schedule, prefill, the kernel route ----
    (g,) = transformer.build_groups(cfg)
    per = TRAIN_DEPTH // PIPE_STAGES
    half = transformer.GroupSpec(g.name, g.kind, per, g.windows[:per])
    tokens = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (PIPE_MICRO, 1, TRAIN_SEQ))).to(dev)
    pos = torch.arange(TRAIN_SEQ, device=dev)[None, :]
    with torch.no_grad():
        blocks = tree_map(lambda t: t.detach(), params[g.name])
        x = torch.stack([transformer.embed(t, params["embed"].detach(),
                                           cfg.embed_scale) for t in tokens])
        stages = [tree_map(lambda a, s=s: a[s * per:(s + 1) * per], blocks)
                  for s in range(PIPE_STAGES)]

        def stage_fn(p, h):
            return transformer._run_group(h, p, half, cfg, pos, True)

        stage_fn(stages[0], x[0])                       # warm, uncounted
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = pipeline_apply(stage_fn, stages, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["flash_attention"]
        ref = torch.stack([transformer._run_group(x[m], blocks, g, cfg, pos,
                                                  True)
                           for m in range(PIPE_MICRO)])
    bubble = bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    log(f"[pipeline] {PIPE_STAGES} stages x {per} layers, {PIPE_MICRO} "
        f"microbatches of 1x{TRAIN_SEQ} on {torch.cuda.get_device_name(0)}: "
        f"wall={wall * 1e3:.1f}ms flash_attention launches={launches} "
        f"(want {TRAIN_DEPTH * PIPE_MICRO}) bubble_fraction={bubble:.2f} "
        f"out={tuple(out.shape)} {out.dtype} bit-equal to the unpipelined "
        f"forward: {torch.equal(out, ref)}")
    if launches != TRAIN_DEPTH * PIPE_MICRO or not torch.equal(out, ref) \
            or not torch.isfinite(out).all():
        raise AssertionError("[pipeline] launches or output differ")
    del out, ref, x, stages, blocks

    # ---- [dist-step]: the traced train step, run on a (1, 1) mesh ----
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.sharding import (P, make_recipe,
                                                  param_specs, placements,
                                                  sanitize_spec, use_recipe)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import cosine_schedule, make_optimizer
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR,
                         schedule=cosine_schedule(TRAIN_LR, warmup=5,
                                                  total=TRAIN_STEPS))

    def place(t, spec, grad=False):
        spec = sanitize_spec(spec, tuple(t.shape), mesh)
        d = distribute_tensor(t.detach(), mesh, placements(spec, mesh))
        return d.requires_grad_() if grad else d

    # plain tensors the model makes (positions, masks) count as replicated,
    # as in the dry-run's trace
    with use_recipe(make_recipe("train")), implicit_replication():
        pspecs = param_specs(params)
        dparams = tree_map(lambda t, s: place(t, s, True), params, pspecs)
        dstate = tree_map(place, opt.init(params),
                          opt.state_specs(params, pspecs))
        del params
        batch = {k: place(torch.from_numpy(v).to(dev), P(("data",), None))
                 for k, v in next(token_batches(cfg.vocab, TRAIN_BATCH,
                                                TRAIN_SEQ,
                                                seed=SEED)).items()}
        step = make_train_step(api, opt)
        losses = []
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            for _ in range(DIST_STEPS):
                dparams, dstate, m = step(dparams, dstate, batch)
                loss = m["loss"]
                losses.append(float(loss.full_tensor() if hasattr(
                    loss, "full_tensor") else loss))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    log(f"[dist-step] mesh=(1, 1) ('data', 'model') nccl, params and "
        f"AdamW state as DTensors by param_specs / state_specs: "
        f"{DIST_STEPS} steps wall={wall:.2f}s losses={losses} "
        f"[train] first {DIST_STEPS}={train_losses[:DIST_STEPS]} "
        f"equal={losses == train_losses[:DIST_STEPS]} "
        f"collectives={comm.get_total_counts()} {counts}")
    if losses != list(train_losses[:DIST_STEPS]):
        raise AssertionError(f"[dist-step] losses {losses} != [train]'s "
                             f"{train_losses[:DIST_STEPS]}")
    del dparams, dstate, batch
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    # ------------------------------------------------------ 1. device --
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {torch.cuda.get_device_name(0)} capability={cap} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ------------------------------------------------------- 2. build --
    from repro_torch.kernels import _build, ops, ref
    build_s = _build.build_all()
    log(f"[build] kernels={sorted(_build.KERNELS)} seconds={build_s:.2f} "
        f"flags={' '.join(_build.NVCC_FLAGS)}")

    # ---------------- 2a. the dry-run cells (host, beside the card) + hw --
    dry_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    t_dry = time.perf_counter()
    dry_procs = dryrun_start(dry_tmp.name)
    try:
        hw_phase(torch)
    except BaseException:
        for p in dry_procs:
            p.kill()
        raise

    # ------------------------------------------- 2b. index build (card) --
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    task, store, heads, url, index_launches = index_phase(torch, ops,
                                                          tmp.name)
    log(f"[index] seconds={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    fstore = ffnn_store()
    batches = traffic(task)
    import numpy as np
    from repro_torch.serving.engine import StorageModel, WeightServer
    planner = WeightServer(store, 2, backend="numpy")   # page maps only
    # The slab holds the largest page group one batch can pin, with no
    # margin: a variant's whole embedding tensor, so every batch is served
    # off the slab itself (a 512-token batch touches nearly all of its
    # variant's pages).  The size comes from the store alone, not from the
    # traffic, and every switch to another variant evicts.  [pressure]
    # serves the same traffic at half the store, through the staging tail.
    capacity = max(len(planner.tensor_pages(m, "embedding"))
                   for m in store.dedup.models)
    worst = max(len(planner.embedding_rows_pages(m, "embedding",
                                                 np.unique(d)))
                for m, d in batches)
    log(f"[setup] word2vec vocab={VOCAB} d={D} variants={VARIANTS} "
        f"pages={store.num_pages()} half={store.num_pages() // 2} "
        f"slab_pages={capacity} worst_batch_pages={worst} "
        f"ffnn_pages={fstore.num_pages()} "
        f"seconds={time.perf_counter() - t0:.2f}")

    # ----------------------------------------------------- 3. kernels --
    recs = kernel_phase(torch, ops, ref, capacity * 8,
                        fstore.num_pages() * 8)
    recs["split_bf16x3"] = split_dot_phase(torch, ops, ref)

    # ------------------------------------------- 4. serving (main path) --
    # each path's launches are counted in a window of its own: the
    # counts go to 0 right before the path runs and are read right after
    ops.reset_launches()
    engine, served, serve_s = serve(url, heads, batches, capacity, "cuda")
    serve_launches = dict(ops.LAUNCHES)
    # ---- 5. FFNN: device_matmul through the same kernels' slab path ----
    fserver = WeightServer(fstore, fstore.num_pages(),
                           storage=StorageModel("dram"), kernel_mode="cuda")
    fserver.access_pages("ffnn-1", fstore.model_pages("ffnn-1"))
    x = np.random.default_rng(SEED + 1).standard_normal(
        (64, 2048)).astype(np.float32)
    ops.reset_launches()
    y = fserver.device_matmul("ffnn-1", "W1", x)
    torch.cuda.synchronize()
    ffnn_launches = dict(ops.LAUNCHES)
    log(f"[launches] serving={serve_launches} ffnn={ffnn_launches}")
    # the path each kernel serves: embedding batches, or the FFNN product
    launches = {"dedup_embedding": serve_launches["dedup_embedding"],
                "dedup_matmul": ffnn_launches["dedup_matmul"]}

    st = engine.stats
    pool = engine.server.device_pool
    engine.server.device_pool.transfer.resolve()
    hbm = engine.server._hbm()
    log(f"[serve] batches={st.batches} requests={st.requests} "
        f"hit_ratio={engine.server.pool.hit_ratio:.3f} "
        f"pages={st.pages_fetched} compute={st.compute_seconds * 1e3:.1f}ms "
        f"makespan={st.makespan_seconds * 1e3:.1f}ms wall={serve_s:.3f}s "
        f"p50={st.percentile(50) * 1e3:.2f}ms "
        f"p99={st.percentile(99) * 1e3:.2f}ms")
    log(f"[device] slab={pool.capacity} pages loads={pool.loads} "
        f"evicts={pool.evicts} device_batches={st.device_batches} "
        f"dense_fallbacks={st.dense_fallbacks} mode={pool.mode()} "
        f"tail={pool.overflow_rows} pages "
        f"slab_bytes={pool.capacity * pool.transfer.page_nbytes} "
        f"tail_bytes={pool.overflow_rows * pool.transfer.page_nbytes} "
        f"staged={pool.tail_staged}")
    log(f"[transfer] pages={st.transfer_pages} ops={st.transfer_groups} "
        f"mean_group={st.mean_group_size:.1f} bytes={st.transfer_bytes} "
        f"moved={st.transfer_seconds * 1e3:.3f}ms "
        f"overlap={st.overlap_fraction:.2f} hbm_bw={hbm.bw / 1e9:.1f}GB/s "
        f"hbm_seek={hbm.seek * 1e6:.1f}us")
    # per-operation device seconds of the serving pass (first op first):
    # a first use (lazy kernel loading) shows as one outlier
    op_s = [s for _, _, s in pool.transfer.stats.records]
    log(f"[transfer] ops_timed={len(op_s)} first={op_s[0] * 1e3:.3f}ms "
        f"p50={float(np.median(op_s)) * 1e3:.3f}ms "
        f"max={max(op_s) * 1e3:.3f}ms "
        f"sum_after_first={sum(op_s[1:]) * 1e3:.3f}ms")

    if st.batches != BATCHES or st.device_batches != BATCHES:
        raise AssertionError(f"device_batches={st.device_batches} of "
                             f"{st.batches}, wanted {BATCHES}")
    if st.dense_fallbacks != 0:
        raise AssertionError(f"dense_fallbacks={st.dense_fallbacks}")
    if launches["dedup_embedding"] < BATCHES:
        raise AssertionError(f"dedup_embedding launched "
                             f"{launches['dedup_embedding']} times for "
                             f"{BATCHES} batches")
    if launches["dedup_matmul"] < 1:
        raise AssertionError("device_matmul did not launch dedup_matmul")

    # the same traffic in host mode on the same database
    _, host_served, host_s = serve(url, heads, batches, capacity, "host")
    if [m for m, _ in served] != [m for m, _ in host_served]:
        raise AssertionError("the cuda and host runs served batches in a "
                             "different order")
    worst_err = 0.0
    for (m, a), (_, b) in zip(served, host_served):
        if a.shape != (DOCS, 2) or not np.isfinite(a).all():
            raise AssertionError(f"logits of {m}: shape {a.shape}, "
                                 f"finite={np.isfinite(a).all()}")
        worst_err = max(worst_err, float(np.abs(a - b).max()))
    if worst_err > 1e-5:
        raise AssertionError(f"cuda logits differ from host mode by "
                             f"{worst_err} (> 1e-5)")
    log(f"[check] serving logits vs host mode: max_abs_err={worst_err:.3e} "
        f"(tol 1e-5) host_wall={host_s:.3f}s")

    dense = fstore.materialize("ffnn-1", "W1")
    y = y.cpu().numpy()
    ffnn_err = float(np.abs(y - x @ dense).max())
    if y.shape != (64, 256) or not np.allclose(y, x @ dense, rtol=1e-4,
                                               atol=1e-4):
        raise AssertionError(f"device_matmul vs numpy: {ffnn_err}")
    log(f"[check] FFNN device_matmul vs numpy x @ W1: "
        f"max_abs_err={ffnn_err:.3e} (tol 1e-4)")
    profile_serving(torch, url, heads, batches, capacity)

    # ------------------------------- 5b. the request tier (word2vec) --
    t0 = time.perf_counter()
    golden, golden_order, traffic_launches = traffic_phase(
        torch, ops, task, url, heads, capacity)
    traffic_launches += restart_phase(torch, ops, task, url, heads, capacity,
                                      tmp.name, golden, golden_order)
    # the traffic windows' gathers join the main path's
    launches["dedup_embedding"] += traffic_launches
    log(f"[traffic] seconds={time.perf_counter() - t0:.1f}")

    # ------------------------------------------ 5c. the sharded slab --
    shard_launches, shard_cap = shards_phase(torch, ops, ref, url, heads,
                                             batches, capacity, fstore, y)
    for name, n in shard_launches.items():
        launches[name] += n

    # ----------------------------------- 5d. the PoolSanitizer, armed --
    for name, n in sanitize_phase(torch, ops, store, heads, batches,
                                  capacity, fstore, shard_cap).items():
        launches[name] += n

    # ---------------------------- 5e. serving past the slab (pressure) --
    for name, n in pressure_phase(torch, ops, url, heads, batches,
                                  fstore).items():
        launches[name] += n

    # -------------- 5f. the port's examples and the LM CLI at half --
    # launches printed by the card's processes of the slice's path
    example_launches = examples_phase(torch)

    # ----------------------------------------------------------- 6. LM --
    t0 = time.perf_counter()
    lm_recs, lm_launches, lm_traffic_launches, lm_store_out = lm_phase(
        torch, ops, ref, tmp.name)
    recs.update(lm_recs)
    launches.update(lm_launches)
    for name, n in example_launches.items():
        launches[name] += n
    launches["flash_attention"] += lm_traffic_launches
    # the index build's windows: the word2vec build and update, the LM
    # store's two variants
    launches["lsh_signature"] += index_launches
    log(f"[lm] seconds={time.perf_counter() - t0:.1f}")

    # ------------------------- 6a. the dedup-masked fine-tune (Sec. 4.3) --
    launches["lsh_signature"] += finetune_phase(torch, ops, *lm_store_out)
    del lm_store_out

    # ------------------------------------- 6b. the CLI's request tier --
    cli_traffic_phase(tmp.name)

    # -------------------------------------------- 7. the other families --
    t0 = time.perf_counter()
    recs["flash_attention"]["family_shapes"] = family_flash_phase(torch, ops,
                                                                  ref)
    log(f"[flash-families] seconds={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    hy_flash, hy_lsh = hybrid_phase(torch, ops, tmp.name)
    launches["flash_attention"] += hy_flash
    launches["lsh_signature"] += hy_lsh
    log(f"[lm-hybrid] seconds={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    launches["flash_attention"] += families_phase(torch, ops)
    log(f"[families] seconds={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    launches["flash_attention"] += encdec_phase(torch, ops)
    log(f"[encdec] seconds={time.perf_counter() - t0:.1f}")

    # ---------------------------------------------------- 7b. training --
    torch.cuda.empty_cache()
    ops.reset_launches()
    log(f"[train] LAUNCHES before={ops.LAUNCHES}")
    train_rec = train_phase(torch, ops, tmp.name)
    log(f"[train] LAUNCHES after={ops.LAUNCHES}")
    if any(ops.LAUNCHES.values()):
        raise AssertionError("training launched a kernel")
    tmp.cleanup()

    # ------------------- 7c. distribution: pipeline, dist-step, dry-run --
    t0 = time.perf_counter()
    launches["flash_attention"] += dist_phase(torch, ops, train_rec)
    log(f"[dist] seconds={time.perf_counter() - t0:.1f}")
    dryrun_finish(dry_procs, dry_tmp.name, t_dry)
    dry_tmp.cleanup()

    # ------------------------------------------------------ 8. summary --
    csrc = "src/repro_torch/kernels/csrc"
    meta = {
        "dedup_embedding": ("src/repro/kernels/dedup_embedding.py:52",
                            f"{csrc}/dedup_embedding.cu"),
        "dedup_matmul": ("src/repro/kernels/dedup_matmul.py:75",
                         f"{csrc}/dedup_matmul.cu"),
        "flash_attention": ("src/repro/kernels/flash_attention.py:94",
                            f"{csrc}/flash_attention.cu"),
        "lsh_signature": ("src/repro/kernels/lsh_signature.py:50",
                          f"{csrc}/lsh_signature.cu"),
        "split_bf16x3": ("none: the exact bf16 split of dot's fp32 operand",
                         f"{csrc}/split_bf16x3.cu"),
    }
    kernels = []
    for name, rec in recs.items():
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][1],
            "replaces": meta[name][0], "variant": rec["variant"],
            "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
            **({"fp32_out_ms": rec["fp32_out_ms"]}
               if "fp32_out_ms" in rec else {}),
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(f"[total] seconds={time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
