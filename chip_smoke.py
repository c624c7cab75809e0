#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA device of the Hopper generation (the kernels are built for
``sm_90a``) and ``nvcc``; without a CUDA device it exits non-zero and prints
no result. Phases, in order; each raises on failure:

1. Build the CUDA kernels from the checkout's sources (``nvcc``, one
   process per source, in parallel).
2. Hold every paged-attention kernel against its plain PyTorch version on
   the card, in f32 (max abs err <= 1e-5), bf16 (2e-2 abs + 2e-2 rel
   per element, and each row's error over its norm at most 0.04) and
   float16 (5e-3 + 5e-3 rel, rows 0.01), at the serving path's shapes
   (H=16, D=128, block 16) and at head dims 64 and 32; the int8 variants
   over int8 pools (standard normal K/V quantized per token row) on
   permuted, partial tables, decode and chunks of 256 at prefixes 0 and
   768. Then the prefill kernel's tile edges, both instances, head dims
   128 and 64: 1, 37, 65 and 300 queries at prefixes 0, 5, 768 and 1000,
   and the full-prefill route at the same counts; then the prefix cache's
   inputs: a table sharing its first 32 blocks with another, 64 queries at
   prefix 512, one query at prefixes 511 and 1023 (a copy-on-write
   recompute). Then the decode kernel's
   edges (``decode_checks``): head dims 32, 64, 128 and 256, every dtype,
   both pools, the ragged positions ``DECODE_POS`` (block and split edges)
   in one launch, table entries past each slot's last block pointing at a
   scratch block that reads 1e4, and two launches on the same inputs equal
   bit for bit; at head dim 256 also the prefill's CUDA-core form. Each
   check prints its share of the bar. Then the sampling kernel
   (``sampling_checks``, launches of ``sampling_batches``) against its plain
   version on the card: 8 rows of 50304 float32 logits mixing greedy rows,
   temperatures, top-k 0/1/5/50/V+10, top-p 0/0.05/0.9/0.95/1, tied
   logits, -inf entries, an all -inf row and masks leaving 1, 3 or 1000
   tokens, in one launch, and a second launch of 8 more; rows where 64
   halvings of the JAX bracket do not narrow to one float (a cluster of
   values in [0, 1e-30) beside logits of 3-11 and -10, for top-k and for
   top-p) and a zero top-p threshold that a bisection step hits exactly;
   ties straddling the slice edges of the kernel's cluster; widths 50307
   (no cluster divides it) and 37 (ranks left empty); Llama 3's 128,256;
   600,000 (past the CTAs' shared memory: slices read again from L2);
   bf16 and float16 logits, whose tokens and u must equal those of the
   same logits cast to float32; each row also alone (the prefill's [1,
   V]): the drawn u bit-equal, tokens equal (a sampled token may differ
   only with the draw within 1e-6, relative, of its interval of the plain
   version's cum: printed), tokens inside their masks, two launches
   bit-equal, a row alone equal to its row in the batch. Then its time at
   [8, 50304] and [1, 50304], float32 and bf16, all sampled and all greedy,
   each beside its bound, the plain version and ``torch.argmax``.
3. Serve ``gpt_1p3b`` at full width and depth (seeded random weights, f32,
   TF32 off) through ``ServingAPI``: 8 slots, 12 requests of mixed prompt
   lengths. The engine runs its decode step and each prefill bucket as
   replays of captured CUDA graphs (the first call of each warms it up
   once, eagerly, then captures it). Every request's greedy tokens must
   equal the model's own ``generate()`` (contiguous cache, plain
   attention: no kernel), the decode kernel must have launched once per
   layer per decode step and per warm-up, the prefill kernel once per
   layer per prefill and per warm-up (a capture launches nothing; each
   replay is credited), and the arena's invariants must hold. The engine
   must hold one decode graph and one graph per bucket of its prompts,
   each built once (``hold_programs``). Then the churn wave (``CHURN``): 1,
   3, 5 and 8 live requests of other lengths in the same buckets build
   nothing, launch only through replays and equal ``generate()``. Every
   served run here and below also holds the sampling kernel's launches:
   one per decode step, prefill, chunk and warm-up.
3b. The same model, a new engine with chunks of 256 (``serve_sampled``):
   12 requests mixing greedy, sampled (temperature 0.8, top-k 50, top-p
   0.95, seeded), top-k 1, top-p 0.9 at temperature 1.2, a
   ``TrieConstraint`` and a ``TokenDFA.from_regex`` over a synthetic token
   table (``TABLE``). Unconstrained tokens equal ``generate(sampling=...)``
   (a sampled token may leave it only with its draw within 1e-4, relative,
   of its interval of cum: the served and generate() logits come through
   other attention kernels; printed; its later tokens must then equal
   ``generate(sampling=...)`` continued from the served tokens),
   constrained ones stay in their
   grammar, launches are exact, one decode graph and one per bucket; a
   second mixed wave builds nothing.
3c. ``gpt_1p3b`` cut to 2 layers with Llama 3's vocabulary of 128,256
   tokens (seeded f32 weights), chunks of 256 (``serve_wide_vocab``): 10
   requests of phase 3b's mix, held as phase 3b holds them.
3d. Phase 3's model and engine sizes with the radix prefix cache on and
   the arena invariants audited at every release (``serve_prefix``): 8
   requests sharing a 512-token prefix (one miss, 7 hits attached to its
   blocks), the prefix resubmitted alone (copy-on-write, one query at
   511), an eviction wave on an arena of 60 blocks, and a priority wave on
   2 slots with ``serving_starvation_steps=1`` (a priority-0 arrival
   preempts the priority-7 runner, which resumes from its journal). Tokens
   equal ``generate()``, one suffix prefill per hit,
   ``tokens.prefill_avoided`` = 7 x 512 and 511, launches exact (suffix
   prefills through the prefill kernel), every program built once.
3e. Recovery and the front door, phase 3's model (``serve_recovery``),
   with fault injection, spans and the arena audit on. A background
   ``ServingAPI`` (8 slots, the prefix cache) serves a first wave of 8
   requests -- greedy and seeded sampled (0.8 / top-k 50 / top-p 0.95), the
   first two sharing a 512-token prefix -- while the main thread computes
   the greedy references with ``generate()``: at least one of the pump
   thread's captures must overlap that CUDA work (captures run in
   ``thread_local`` mode). A second wave of the same shape: once all 8 are
   RUNNING a ``serving_device`` fault (armed inside ``api.paused()``, so it
   hits the next decode step), then, with a slot free, an ``arena_corrupt``
   fault on a 9th request's admission. Held: every output against
   ``generate()`` / ``generate(sampling=)`` (phase 3b's boundary rule),
   ``supervisor.rebuilds`` 2 and ``supervisor.replays`` 8 + the requests
   live at the second fault, each rebuild keeping every pool's
   ``data_ptr()``, ``torch.cuda.memory_reserved``, the graph count, the
   graph pool's bytes and every build counter, one decode program and
   every prefill key built once, exactly the buckets admitted (replays
   included; the keys new after the first fault printed), the paged and
   sampling launches exact (a replay prefill counts as a prefill), each
   request's spans (SUBMITTED, QUEUED, ..., one REPLAYED per fault it was
   live for, ..., FINISHED on one trace id), and a clean arena after
   ``drain(grace=5)``. Then the crash-loop breaker (``serving_device``
   armed ``max_rebuilds + 1`` times: 3 rebuilds, ``CrashLoopError`` for
   every request, nothing leaked, a fresh request equal to
   ``generate()``), ``cancel`` mid-decode, ``result``, ``outstanding`` and
   ``drain(grace=0)`` (stragglers fail with ``RequestDrainedError``), a
   bound ``PreemptionGuard`` drained by the background pump on the
   ``preempt`` fault, and ``EnginePredictor.run`` on 8 prompts equal to
   ``generate(stop_token_id=)`` row for row. Its times run in phase 6's
   bf16 setting (``recovery_times``).
4. A second f32 ``gpt_1p3b`` from the same weights, served with
   ``quant_weights`` (int8 weights, per-channel scales, quantized on the
   card: 8 of its linears, and one in bf16, must equal the CPU's
   quantization bit for bit): 12 requests of 37 to 1000 prompt tokens;
   greedy tokens must equal ``generate()`` of the same quantized model.
5. The same quantized model with ``quant_kv`` and ``chunked_prefill=256``
   as well, on the same requests: the six prompts longer than 256 are
   prefilled in chunks. The int8 decode kernel must launch exactly 24 times
   per decode step, the int8 prefill kernel 24 per chunk and the
   full-precision prefill kernel 24 per whole-prompt prefill; the arena's
   invariants hold; on the 10th decode step and the 2nd chunk (graph
   replays) every layer's kernel output is held against its plain version
   on the engine's own pools (bar of phase 2; ``Shadow``). The per-token
   agreement with phase 4's tokens is printed, not held.
6. Phase 3's model in float16 (a copy), unquantized and with the int8
   arena: every layer's kernel output of a 512-token prefill and of one
   decode step held against its plain version on the engine's own pools.
   Then the model in bf16. First the prefill kernel's tensor-core
   instances on the engine's own data: the host-clock time from admission
   to first token of a 512-token prompt at its bucket's first admission
   (warm-up and capture) and replayed, then every layer's kernel output
   of one such prefill and of an int8 chunk at prefix 768 held against its
   plain version (phase 2's bars). Then the prefix cache in bf16,
   unquantized and with ``quant_kv`` (``bf16_prefix``): the host-clock time
   from admission to first token of a 512 + 64 prompt, miss against hit
   (median of 5, captured buckets), every layer's prefill kernel output of
   a hit over another slot's blocks and of a COW recompute at 511 held
   against its plain version, the COW copy's time beside its bound, and
   the token agreement of 4 hits with the cache off (printed, not held).
   Then phase 3e's times (``recovery_times``, 8 slots, prompts of 512):
   ``rebuild()`` alone beside its bound (the arena's bytes over 3.35
   TB/s), the TTFT and inter-token p50/p99 of a clean wave from
   ``engine.hists``, the host decode-step median with
   ``FLAGS_serving_telemetry`` 0, 1, 1, 0, and the outage from a
   ``serving_device`` fault to the next token of all 8 streams, with the
   replays' bucket captured during the recovery and already captured.
   Then the median decode-step time (a
   graph replay) and tokens/s of 8 full slots, unquantized (greedy, all
   sampled, and 4 constrained + 4 sampled), with
   ``quant_kv``, and with ``quant_kv`` + ``quant_weights``, with the arena
   bytes per slot, the weight bytes and the graph pool bytes of each; each
   engine's programs held as in phase 3; then each kernel's time (the
   median of its
   launches) at the path's shapes beside its bound, its
   plain version's time and one ``scaled_dot_product_attention`` call on the
   same attention (a yardstick only; the port never calls it). No PyTorch
   call attends int8 paged K/V, so the int8 kernels stand beside the bf16
   kernel at the same shape instead.
7. Hold the three flash-attention kernels (forward with lse, dK/dV, dQ) and
   the ``FlashAttention`` autograd.Function against their plain versions
   (in f32 also against torch autograd through the plain forward) at
   ``FLASH_TOL``: per element f32 1e-5, bf16 4e-3 + 2e-2 |ref|, float16
   1e-3 + 5e-3 |ref|, and each row's error over its norm (or the median
   row norm) at most 1e-4 (f32), 1.5e-2 (bf16) and 4e-3 (float16; the
   float16 instances run on the CUDA cores). Shapes (``FLASH_SHAPES``):
   [2, 2048, 16, 128] causal and not, head dims 64 and 256 at 256
   positions, and causal 256 queries over 128 keys, whose rows with no key
   must give lse = -1e30 and dq = 0.
   Then the edges of the tensor-core backward tiles (``FLASH_EDGES``, a
   generator of their own): 192 queries and keys causal and not (ragged
   tiles), causal 64 queries over 320 keys and 320 over 64 (offsets +256
   and -256), and head dim 64 at 192.
8. Train ``gpt_1p3b`` in f32 (TF32 off), batch 1 x 2048. First one forward
   and backward on each route: the loss and every layer's qkv and proj
   weight gradients must agree (``ROUTE_TOL``). Then AdamW(3e-4, decay
   0.01) with ClipGradByGlobalNorm(1.0): 3 TrainSteps through the flash
   kernels (``FLAGS_flash_attention_min_seqlen=0``) and 3 from the same
   weights on the plain route (-1: 2048 is below the auto threshold 4608).
   The losses agree within rtol 1e-5 at every step; each flash kernel
   launches exactly 24 x steps times on the kernel route and never on the
   plain route.
9. Train in bf16 (AMP O1). First the same route comparison at batch 1
   (``ROUTE_TOL``: the plain route keeps bf16 logits, the kernels f32
   scores). Then batch 8 x 2048 through the flash kernels, 10 steps on one
   fixed batch: the loss is finite and falls. Prints the median step time,
   tokens/s, model FLOPs over 989 TFLOP/s and peak memory, then each flash
   kernel's time at the step's shapes beside its bound, its plain version's
   time and PyTorch's own flash attention (forward; backward for dq, dk and
   dv together) as a yardstick only. Each flash kernel launches exactly
   24 x steps times here too (its bf16 instances, on the tensor cores,
   where phase 8 ran the f32 instances).
10a. The dropout kernel (``dropout_checks``) against its plain version on
    the card in float32, bf16 and float16 at the residual [8, 2048,
    2048], the attention probabilities [1, 16, 2048, 2048] and 1,000,003
    elements, p 0.1/0.5/0.999, the axis form and ``downscale_in_infer``:
    keep masks with 0 differing elements, outputs and the backward (the
    autograd Function) bit-equal, a second launch bit-equal; p 0 and eval
    mode draw no key and launch nothing. Then its time at [8, 2048, 2048]
    and [8, 16, 2048, 2048] bf16 beside its bound, its plain version and
    torch's Philox dropout (a yardstick only). Then the alpha form
    (``alpha_checks``) in every dtype at [8, 2048, 2048] and 1,000,003
    elements, p 0.1 and 0.5: every dropped element holds the fill, output
    and backward bit-equal to the plain version, a second launch
    bit-equal; the ``AlphaDropout`` layer's forward and backward launch
    it twice; its time at [8, 16, 2048, 2048] bf16 beside its bound.
10b. Memory levers on phase 9's weights and batch (bf16 O1, 8 x 2048,
    flash route), 3 TrainSteps each: recompute ``full``, ``core_attn``,
    ``loss_chunk_size=1024`` with ``full``, and an untied head (``lm_head``
    = wte^T): step 1's loss within ROUTE_TOL of phase 9's, the exact flash
    launches (``LEVERS``), median step time, tokens/s, FLOP share and peak
    memory; one JSON line ``{"levers": [...]}``.
10c. ``gpt_1p3b`` with dropout 0.1, bf16 O1, recompute ``full``, batch 1 x
    2048 (attention on the plain route): one step's loss and qkv/proj
    gradients equal with recompute on and off under one key; 3 TrainSteps
    from ``rng.seed(0)`` with finite losses and exactly
    ``dropout_sites`` kernel launches a step; the plain attention's share
    of the step.
10d. float16 AMP O2 (``decorate``) with ``GradScaler`` at full width, 4
    layers, batch 1 x 2048: the step whose gradients overflow is skipped
    with parameters and slots bit-unchanged, the scale follows
    ``scaler_rule``.
11. Serve ``gpt_1p3b`` cut to 2 layers of 8 heads of 256 (full width
    2048), seeded f32 weights: tokens equal ``generate()``, the head_dim
    256 kernels launch 2 x (decode steps + warm-ups) and 2 x (prefills +
    warm-ups), and the engine's programs hold as in phase 3.
12c. The optimizer family at full width (``optimizer_family``): one bf16
    O1 gradient of ``gpt_1p3b`` at 1 x 2048; SGD, Momentum, Adagrad,
    Adadelta, RMSProp, Adamax, Lamb and LarsMomentum each take their first
    update from the same parameters through ``_apply_gradients`` (the
    TrainStep path), held per element against a float64 recomputation
    written from the update rules (within half an f32 ulp of the result
    twice over plus 1e-4 of the update); each update's time (median of 3),
    its device operations (a profiler trace) and its bound (parameters,
    gradients and slots read and written once, over 3.35 TB/s).
12a. ``hapi.Model.fit`` on full ``gpt_1p3b`` (``fit_gpt``): bf16 O2
    (``amp.decorate``), Lamb(multi_precision) under
    LinearWarmup(CosineAnnealingDecay), ClipGradByGlobalNorm, the flash
    route; a ``TensorDataset`` of seeded ids through a ``DataLoader`` with
    2 worker processes (spawned: CUDA is initialised) over shared memory,
    6 steps of 4 x 2048: each flash kernel launches exactly 24 x 6, the
    loss is finite and falls, the LRs equal the scheduler's own. Prints the
    median step beside a bare ``TrainStep`` of the same loss, the loader's
    wait per step, tokens/s and peak memory.
12b. Checkpoint and resume (``checkpoint_resume``), ``gpt_1p3b`` at full
    width cut to 4 layers, 12a's setup: an uninterrupted fit of 6 steps;
    a fit of 4 with ``TrainCheckpointer(async_save=True)`` saving step 2,
    ``ModelCheckpoint``, and an armed ``preempt`` fault so that
    ``PreemptionGuard.maybe_finalize`` writes step 4 and the resume marker;
    a rebuilt model, optimizer and scheduler restored from disk fit the
    last 2 steps: parameters, slots, step and LR bit-equal to the
    uninterrupted run's. Step 4 truncated: ``restore`` falls back to step
    2, and step 4 asked for by number raises CheckpointIntegrityError.
    Prints the async save's return time, the final save's, the bytes and
    the restore's time; removes ``build/chip_checkpoints``.
12d. LBFGS (``lbfgs_full``) on ``gpt_1p3b`` cut to 2 layers, f32, 1 x 2048,
    history 4, 3 iterations, without and with the strong Wolfe search: the
    loss falls and the state dict (with the history) round-trips.
13. Speculative decoding (``serve_spec``, run after phase 6) on phase 6's
    engine shape: bf16 ``gpt_1p3b``, 8 slots, 8 prompts of 512 with
    budgets of 41-48, k 4. A spec-off engine serves wave 1, wave 2 (other
    lengths of the same bucket) and the edge request (2027 + 21 tokens:
    its budget ends at max_model_len 2048) first, and an int8 arena
    (``quant_kv``, chunks of 256) wave 1; then lockstep, a
    ``gpt_base``-width draft (12 layers, 12 heads of 64, 2048 positions,
    seeded), the same draft over the int8 arena (its namespace int8 with
    scales), the same draft with ``quant_draft`` and a tied draft (the
    target itself), each on wave 1 (and, but over the int8 arena, the
    edge): every stream equal to the spec-off engine's of the same arena
    token for token; the launches exact: per replay or warm-up of the
    speculative step 24 k decode launches in lockstep, 24 (k + 1) + 12 k
    with the draft (24 k for the tied draft's part; the int8 decode kernel
    over the int8 arena, whose chunks take the int8 prefill kernel), k or
    2k + 1 sampling launches, 12 prefill launches a draft prefill (and per
    draft prefill warm-up); the gpt_base-width draft's own kernels, held
    to their plain versions at its shapes after wave 1 (the decode kernel,
    int8 over the int8 arena, at H 12, D 64, 8 lanes, every layer, every
    draft sub-step's positions and tables of the wave's first and last
    speculative runs; the full prefill at 512 and 2048 queries): a wrong
    draft kernel would only lower acceptance, which the streams cannot
    see; the 5th speculative run of each mode, replayed twice on its own
    values after wave 1, gives its outputs bit for bit; the draft engine's
    wave 2 builds nothing (one speculative graph, one draft prefill graph
    per bucket). The tied draft accepts everything. Then an f32 wave (TF32
    off) at gpt_1p3b's width cut to 4 layers, lockstep and a 2-layer
    draft, equal to
    ``generate()``, where the draft engine also meets a ``serving_device``
    fault at a speculative run (rebuild and replay, the pools in place, the
    step not built again; streams equal ``generate()``) and two
    ``serving_step`` faults retried inside one run (no rebuild). Prints
    each mode's median full-step host time, traced busy time and idle share
    beside the plain decode step's, tokens/s, acceptance, the engine's
    graph pool, the peak bytes of the speculative step's build beside the
    decode step's and ``memory_summary()``'s draft line.
14. Multi-LoRA and the tiered KV cache (``serve_lora_tier``, run after
    phase 13) on phase 6's engine shape. 14a: bf16 ``gpt_1p3b``, an
    adapter arena of rank 16 and capacity 4 (5 rows of 48 MiB), three
    adapters drawn from numpy seeds; a wave of 8 requests of 512 + 48 with
    ids 0-3 on two lanes each: the id-0 lanes equal a no-arena engine's
    streams, each adapter changes at least one token, each adapter lane
    equals its request served alone on the same engine, the launches are
    exact; a second wave after an unregister and a fresh register reuses
    the row and builds nothing; the decode step's host time, traced busy
    time and idle share with 0, 3 and 1 live adapters beside the no-arena
    engine's. 14c: the prefix cache over the tiers, an arena that one wave
    fills: a primer, wave A (8 hits on a shared 512-token prefix), a
    pressure wave that spills it, wave B restoring its 32 blocks from the
    host tier through one captured restore program (streams equal wave
    A's, the restored blocks bit-equal to the spilled payloads, launches
    exact); the same over an int8 arena (payload and scales bit-equal);
    a disk pass (a host budget of one byte: every entry on disk) restoring
    from disk, then a corrupted file of the chain's first block, which
    sends the next wave's first admission to a full prefill (its stream
    the primer's, the others wave A's); the spill and restore times
    beside a pinned host-to-device copy of the chain's bytes; the first
    token of 512 + 64 for a miss, a resident hit (also without tiers, in
    the same call) and a host- and a disk-restored hit. 14b: f32 (TF32
    off) at 4 layers, 8 requests with ids 0-3, greedy and sampled: each
    adapter's streams equal ``generate()`` under the arena's binding for
    its id (a sampled draw within SERVED_BOUNDARY excepted).
15. The gateway (``serve_gateway``, run after phase 14). 15a, the two
    repairs, bf16 ``gpt_1p3b``, 8 slots, prompts of 512 + 15 and 64 new
    tokens: with the prefix cache and an adapter arena of rank 16, a base
    then an adapter request of one prompt, and an adapter then a base
    request of another, each equal to its cache-off solo run (0 hits of
    4), and the adapter's shared prefix a hit of 512 tokens; the served
    state's fingerprint timed cold and memoized; an engine of the model
    with one layer's weights changed, sharing a ``HostKVCache`` with one of
    the model, equal to its solo run with 0 blocks restored, and a second
    engine of the model restoring the chain with the first's hit stream.
    15b: a reference engine of one replica's shape (8 slots, prefix cache
    and tiers on) serves a primer, a host-restored hit and the wave: 16
    requests of 512 + 15 + 64, the even ones on one shared prefix, two of
    every four sampled (0.8 / 50 / 0.95, seeded). Then two replicas of
    that shape sharing the model and one store, with background pumps,
    behind a ``Gateway`` on 127.0.0.1: each replica's first wave builds
    its programs (replica 1's a host-tier hit of the shared prefix replica
    0 wrote through, equal to the reference's host-restored hit; replica 1
    then spills its cache); 16 client threads ``POST /v1/stream`` the wave
    while a thread scrapes ``/v1/metrics``: every SSE stream equals the
    reference's along the same cache path (shared prefix: hits; own
    prefixes: misses), launches exact over both replicas' steps and
    prefills, no build, affinity routes taken, every scrape with
    ``replica="0"`` and ``replica="1"`` series; a tenant past its bucket
    gets 429 with Retry-After. Times: tokens/s of the pool through HTTP
    and through ``pool.submit`` against one engine of 8 and one of 16
    slots on the same traffic; both replicas decoding, the union of their
    graph replays' device intervals, the idle share and the time both
    streams replayed at once (CUDA events around each replay); first
    token of a hit through ``POST /v1/stream``, ``pool.submit`` and a bare
    ``ServingAPI.submit``. 15c, f32 (TF32 off) at 4 layers, a foreground
    pool of two replicas: replica 0 crash-loops on injected
    ``ServingDeviceError``s, its streams re-route to replica 1 and equal
    the uninterrupted streams, with each one's fault-to-next-token time;
    it respawns after the backoff and serves again, with the allocated
    bytes within one arena of their value before the fault; ``scale_to(1)``
    drains and re-routes without dropping a stream.
16. The process fleet and the write-ahead log (``serve_fleet_wal``, run
    after phase 15). 16a, bf16 ``gpt_1p3b``: a reference engine of 8
    slots with the prefix cache serves a primer (a miss of a 512-token
    shared prefix), a hit, and 15b's two waves; then ``serve()`` with
    ``FLAGS_gateway_process_replicas`` spawns two worker processes of
    that shape, each loading the weights from the pool's file (the spawn
    payload's bytes and each boot's seconds printed; no worker imports
    JAX); each is primed with the miss and the hit (its programs built),
    then 16 client threads ``POST /v1/stream`` the first wave: every SSE
    stream equals the reference's (the shared prefix resident in every
    worker: hits; own prefixes: misses), each worker's launches, set to 0
    just before and read from its own ``stats`` just after, equal what
    its engine ran, no worker builds a program; the second wave goes
    through ``pool.submit``, equal too. Times: both waves' tokens/s beside
    the reference's and this call's 15b, first tokens of hits, the card's
    free memory before the spawn, with both workers up and after
    ``close()`` (which reaps every worker). 16b, f32 (TF32 off) at 4
    layers, two workers: ``worker_kill`` mid-wave, the killed worker's
    streams re-routed and equal to one engine's uninterrupted streams (each
    one's fault-to-next-token time, the respawn's seconds, free memory
    after the respawn within a worker's footprint of before), then
    ``worker_hang``, classified by heartbeat age, equal too; no tenant
    slot left in flight, no worker alive after ``close()``. 16c, the same
    width cut to 2 layers (``WAL_MODEL``) on the harness's own seeded weights
    (``wal_harness.build_model``, which every incarnation and the
    reference call alike): ``paddle_tpu_torch.serving.gateway.wal_harness``
    on the card
    serves a greedy, a seeded-sampled and a constrained stream, is
    SIGKILLed mid-stream, and a second harness on the same ``--wal-dir``
    finishes all three equal to an in-process engine's (``/healthz``
    503 "recovering", then 200; the build counters frozen after the
    first resumed stream); a third answers both retried ids from its
    result cache. Each incarnation's boot and the replay's seconds are
    printed.
17. Disaggregated prefill and decode (``serve_disagg``, run after phase
    16). 17a, bf16 ``gpt_1p3b`` cut to ``DISAGG_LAYERS`` (8) layers: an
    in-process reference along the
    workers' path (engine P: chunks of ``DISAGG_CHUNK`` publishing into a
    disk directory of its own, one token a request; engine D, tiered on
    it: ``submit(prompt, journal=[first])``), then ``serve()`` with
    ``FLAGS_gateway_process_replicas`` and one prefill and one decode
    worker of 8 slots (``DisaggReplicaPool``, the shared disk tier under
    ``build/disagg_kv``, each host tier ``DISAGG_HOST_BYTES``): each
    worker's boot and state-fingerprint seconds, their tier namespaces
    equal to each other's and the reference's, no ``jax`` imported;
    both primed (a miss and a hit of the shared prefix); 15b's wave of 16
    clients through ``POST /v1/stream`` with each worker's launch
    counters set to 0 just before and read just after (equal to what its
    engine ran; per role and summed), all 16 handed off, none degraded,
    each client's first-to-second-token gap; a second wave through
    ``pool.submit``; first tokens and handoff gaps of hits; a third wave
    with ``FLAGS_gateway_prefetch`` = 2 on the full decode worker
    (``disagg.prefetches`` > 0). Every stream equals the reference's, no
    worker builds a program after its priming, the prefill worker's
    ``tier.published_blocks`` and the decode worker's disk hits and
    restored blocks move; the restore's mean ms, bytes published and
    tokens/s beside 16a's and 15b's are printed. 17b, f32 (TF32 off) at 4
    layers, one prefill and two decode workers, chunks of one block:
    ``worker_kill`` kills the prefill worker mid-prompt (its re-routed
    streams' successors restore what it published and prefill fewer
    chunks than the prompt, read from their spans), a decode worker is
    SIGKILLed mid-decode (the other restores the re-routed streams'
    published chains), ``scale_to(prefill=0)`` leaves unified routes;
    every stream equals ``generate()``; after ``close()`` no worker is
    alive and the minted disk directory is gone.
18. The deploy path (``serve_export``), bf16 ``gpt_1p3b`` at full width
    cut to ``EXPORT_LAYERS`` (8) layers on phase 3's seeded weights of
    those layers, eval. 18a:
    ``jit.save(model, prefix, input_spec=[InputSpec([None, None],
    "int64")])`` under ``FLAGS_flash_attention_min_seqlen`` = 0 (the flash
    forward enters the program as the registered op) and again at the auto
    value (the plain route below 4608), each into ``build/export_chip``
    (removed after), with the export's seconds and the bytes of
    ``.pdmodel`` and ``.pdparams``; ``inference.create_predictor`` over
    each at ``EXPORT_SHAPES`` ([2, 2048], [4, 512], and [3, 1000] and
    [2, 5], outside ``_shapes_ok``, where eager takes the plain route and
    the flash program the kernel): logits held to the eager model's (relative L2 within
    ``ROUTE_TOL["bf16"][1]``; whether bit-equal is printed), the flash
    program's runs at exactly one ``flash_forward`` launch a layer, the
    auto program's at none; a predictor run's host ms beside the loaded
    program's and the eager forward's, host and between CUDA events
    (where the program's host time goes: ``tools/profile_export.py``).
    18b: a ``to_static`` forward under
    ``no_grad`` at [2, 2048] with the flag at 0, captured once
    (``to_static.misses`` 1, hits on repeats), bit-equal to eager, one
    launch a layer credited a replay; ``bucket_batch`` at batch 3 then 5 (seq
    512) builds one graph, equal to eager within the same bound;
    ``load_state_dict`` of other weights is followed with no rebuild,
    ``load_state_dict(..., assign=True)`` rebuilds once and is followed;
    eager against graphed forward ms.

19. Tensor-parallel serving (``serve_tp``, run after phase 18). 19a, bf16
    ``gpt_1p3b`` (phase 3's seeded weights), 8 slots, phase 6's greedy wave
    (8 prompts of 512, 64 new): an engine without a mesh, then one on a
    one-rank NCCL mesh (``serving_mesh(1, backend="nccl")``, on a copy of
    the weights): each a priming wave, then the measured wave with the
    launch counters set to 0. The mesh engine's NCCL all-reduces are
    counted inside its captured decode and prefill graphs; its tokens,
    every head call's logits (a device checksum of their bits) and the
    last decode step's logits equal the engine's without a mesh bit for
    bit; its graphs, builds and launches equal the other's; a churn wave
    of other lengths in the same bucket builds nothing. 19c, where the
    machine has the cards (else it prints that it did not run): NCCL at tp
    = 2 and 4, one rank per card, graphs, on 19a's model and wave: the
    last prefill's logits within ``ROUTE_TOL["bf16"]`` of 19a's engine
    without a mesh, the greedy token agreement printed, every rank's
    graphs and launches equal to that engine's, no build under churn.
    19b, tp = 2 on the one card (rank 0 here, rank 1 a spawned process on
    the same card, gloo over CUDA tensors; the mesh says gloo cannot be
    captured, so the programs run uncaptured over the same static
    buffers): f32 (TF32 off) at full width cut to ``POOL_F32[0]`` layers,
    15c's prompts, a priming wave then the measured wave with both ranks'
    launch counters set to 0: greedy tokens equal the one-rank engine's
    token for token, each rank's launches equal its, each rank's weight
    and arena bytes at most 0.55 of its, the follower imports no JAX; then
    the int8 wave (``quant_weights``, ``quant_kv``, chunks of 256) on the
    same cut, tp = 2 against one rank: tokens equal, each rank's launches
    equal, the int8 kernels among them, the scale pools bit-equal on both
    ranks (19c runs it too over NCCL on two cards, its max all-reduces
    captured); then bf16 at 24 layers (the follower a thread of this
    process): the first token's logits within
    ``ROUTE_TOL["bf16"]`` of the one-rank engine's, the wave's token
    agreement printed, and the decode kernel at the rank's 8 heads of 128
    on rank 0's pools against its plain version, timed beside its bound
    and SDPA's time; last every paged kernel of the path (decode, suffix
    and chunk prefill, whole-prompt prefill; f32 and bf16, full precision
    and int8) at 8 and at 4 local heads against its plain version
    (``tp_local_kernels``).

20. Multi-GPU training (``train_tp``): ``gpt_1p3b``'s width cut to
    ``TT_LAYERS`` layers, batch 1 x 2048, AdamW under the global-norm
    clip, ranks as threads over gloo on this card. 20a, f32 (TF32 off),
    tp = 2: each rank's losses against the one-rank ``TrainStep``'s, its
    first-step gradient shards against the whole model's slices, the
    clip's norm, a column / row pair's ``x.grad``, exact flash launches;
    a dropout step whose masks are boxes of the whole model's. 20b, f32,
    data 2 and ZeRO ``os_g`` at sharding 2 against one rank, the slot
    bytes a rank. 20c, bf16 O1, tp = 2, three steps beside a one-rank
    control that computes each block's linears in the split's two parts
    with no collective (``tt_two_parts``; bounds at ``TT_BF16_HELD``);
    the flash kernels at a rank's [1, 2048, 8, 128] against their plain
    versions, timed. 20d, ``generate()`` on the tp = 2 model: greedy and
    sampled tokens equal the whole model's. 20e, only with four cards:
    NCCL data 2 x model 2, one rank a card, with 20a's checks.

21. Pipeline and context parallelism (``train_pipe``): ``gpt_1p3b``'s
    width at ``PP_LAYERS`` layers (phase 20's weights), ranks as threads
    over gloo on this card. 21a, GPipe at pp = 2, f32 (TF32 off), 4 x
    2048 in 4 microbatches: every rank's 3 ``train_batch`` losses against
    the one-rank ``GPTForCausalLM``'s, its first-step gradients and its
    parameters after step 1 against that run's parts of them (the tied
    ``wte`` included; both held tensor by tensor, the parameters over
    the entries whose one-rank gradient is not zero to rounding, the
    others counted and printed: AdamW's first step moves an entry whose
    gradient is rounding noise, as the key third of ``qkv``'s bias, by up
    to lr on that noise's sign; see PP_ZERO_ABS),
    the schedule's ticks against
    ``pipeline_tick_cost``, exact flash launches (2 layers x 4
    microbatches x 3 steps a rank); a dropout step at one microbatch
    bit-equal to the one-rank pipe model. 21b, the interleaved schedule
    (V = 2), the same checks. 21c, bf16 O1 at pp = 2, two steps within
    ``ROUTE_TOL["bf16"]``; the flash kernels at a stage's [1, 2048, 16,
    128], timed. 21d, ring and Ulysses attention at sep = 2 on [1, 2048,
    16, 128] in f32 and bf16 against one rank's ``_sdpa_reference``
    (``PP_CP_TOL``), and the GPT trained at sep 2 x model 2 on the ring
    against one rank, with 0 flash launches (the flag at 0: the sep route
    comes first). 21e, only with four cards: NCCL pp 2 x data 2 and sep 2
    x model 2 at 2 x 2048, one rank a card.

Each phase prints its seconds. ``--phase 19``, ``--phase 20`` and
``--phase 21`` run the build and that phase alone (a check of 19c, 20e
or 21e on a machine with four cards) and end on a line of their own,
``{"phase_only": "19", ...}``; any other argument is refused. The smoke
run proper takes no arguments. It draws the seeded weights of every model
it seeds on host threads while the kernels build (``draw_ahead``).

Every serving engine is closed at the end of its phase
(``ServingAPI.close``), which drops its graphs and their pool before the
training phases.

Then one JSON line of per-kernel results (a paged row's ``launches`` are
phase 3's, an int8 row's phase 5's; a flash row's are phase 9's, the
instances its times belong to, and ``launches_f32`` phase 8's; the
sampling row's phase 3b's, its times the 8 all-sampled float32 rows',
the dropout row's phase 10c's, its times 10a's at [8, 16, 2048, 2048],
with the alpha form's (``launches_alpha``, ``alpha_*``) beside them,
with every timed setting and ``torch.argmax`` beside them; the two
unquantized paged rows' and the sampling row's ``launches_prefix`` phase
3d's shared-prefix wave, ``launches_recovery`` phase 3e's faulted wave;
``launches_spec`` phase 13's draft engine's wave 1, over the int8 arena
for the int8 rows; ``launches_lora`` phase 14a's wave 1, ``launches_tier``
phase 14c's host-tier wave B, the int8 rows' over the int8 arena;
``launches_pool`` phase 15b's HTTP wave, both replicas'; ``launches_fleet``
phase 16a's HTTP wave, summed over the two worker processes' own counts;
``launches_disagg`` phase 17a's HTTP wave, per role and summed;
the flash forward row's ``launches_export`` a run of phase 18a's flash
program, ``launches_to_static`` a replay of 18b's graph; ``launches_tp``
the measured waves of 19a, of 19b's f32 case and of 19b's int8 wave, per
rank; a flash or dropout row's ``launches_tp_train`` phase 20a's and
``launches_pipe_train`` phase 21a's (its dropout step's for the dropout
row), per rank),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Phase 12 prints its own JSON line before them
(``training_loop``: 12a-12d's numbers).
"""
import contextlib
import copy
import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SOURCES = {name: f"paddle_tpu_torch/ops/csrc/{name}.cu"
           for name in ("paged_attention", "flash_attention", "sampling",
                        "dropout")}
PAGED = ("paged_decode_attention", "paged_prefill_attention",
         "paged_decode_attention_int8", "paged_prefill_attention_int8")
FLASH = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
SAMPLING = ("sample_tokens",)
DROPOUT = ("dropout",)
REPLACES = {
    "paged_decode_attention":
        "paddle_tpu/ops/paged_attention.py:141 _decode_kernel",
    "paged_prefill_attention":
        "paddle_tpu/ops/paged_attention.py:306 _prefill_kernel",
    "paged_decode_attention_int8":
        "paddle_tpu/ops/paged_attention.py:141 _decode_kernel (quantized)",
    "paged_prefill_attention_int8":
        "paddle_tpu/ops/paged_attention.py:306 _prefill_kernel (quantized)",
    "flash_forward": "paddle_tpu/ops/pallas_ops.py:101 _flash_fwd_kernel",
    "flash_backward_dkv":
        "paddle_tpu/ops/pallas_ops.py:234 _flash_bwd_dkv_kernel",
    "flash_backward_dq":
        "paddle_tpu/ops/pallas_ops.py:269 _flash_bwd_dq_kernel",
    # no Pallas body: the JAX package computes it with XLA ops
    "sample_tokens": "paddle_tpu/serving/sampling.py:84 sample_tokens",
    "dropout": ("paddle_tpu/nn/functional/common.py:32 dropout; "
                "paddle_tpu/nn/functional/attention.py:26 _prob_dropout "
                "(XLA ops, no Pallas body)"),
}
H, D, BS = 16, 128, 16          # gpt_1p3b heads, head_dim; kv_block_size
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense
F32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# (atol, rtol) per element, and the bound on the worst row's error (the
# last dim: head_dim) over that row's norm, or over the median row norm
# where the row's own is smaller (None: no row bound). The flash bars sit
# 1.7 to 5 times above the worst sound reading on an H100; one 64-row tile
# dropped from one head's walk gave worst rows of 0.55-0.76 (PERF.md). The
# paged bf16 row bound sits 2 times above the worst sound reading (0.0201:
# the plain version rounds its logits to bf16, the kernels keep f32
# scores); a dropped 64-key tile or a diagonal off by one fails it (PERF.md).
TOL = {torch.float32: (1e-5, 0.0, None), torch.bfloat16: (2e-2, 2e-2, 4e-2),
       torch.float16: (5e-3, 5e-3, 1e-2)}
FLASH_TOL = {torch.float32: (1e-5, 0.0, 1e-4),
             torch.bfloat16: (4e-3, 2e-2, 1.5e-2),
             torch.float16: (1e-3, 5e-3, 4e-3)}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the decode checks' positions in one launch (MB = 132 blocks of 16): the
# first keys, block edges, the edges of splits of 16 and 64 keys (129: the
# first length cut into 32-key splits), MB * bs - 1 and 2047
DECODE_POS = [0, 15, 16, 17, 63, 64, 65, 127, 128, 129, 700, 1000, 2047,
              132 * BS - 1]
# the quantized serving phases: 12 prompts of 37-1000 tokens, chunks of 256
# (the six longer than a chunk are admitted in 2-4 chunks)
QLENS = [37, 1000, 300, 64, 700, 129, 511, 250, 48, 900, 100, 257]
QNEWS = [16, 32, 24, 20, 32, 16, 28, 18, 30, 22, 26, 32]
CHUNK = 256
SEQ = 2048                      # gpt_1p3b's positions: the training length
STEPS_F32, STEPS_BF16 = 3, 10   # TrainSteps of the parity and timing phases
BATCH_BF16 = 8                  # sequences per bf16 step
# kernel route against plain route: (loss rtol, worst relative L2 error of
# an attention weight's gradient) in f32 (TF32 off) and bf16 (AMP O1, where
# the plain route rounds its logits to bf16 and the kernels do not)
ROUTE_TOL = {"f32": (1e-5, 1e-4), "bf16": (2e-4, 3e-2)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def randn(rng, shape, dtype):
    a = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(device="cuda", dtype=dtype)


def qkv_split(rng, rows, h, d, dtype):
    """q, k, v ``[rows, h, d]`` as the model hands them over: strided views
    of one ``[rows, 3, h, d]`` projection."""
    return randn(rng, (rows, 3, h, d), dtype).unbind(1)


def readings(out, ref, tol):
    """Kernel output against its plain version under one dtype's ``tol``
    ``(atol, rtol, row bound)``: (max abs error, largest share of the
    element tolerance used, worst row's error over that row's norm -- or
    over the median row norm where the row's own is smaller: rows of zeros,
    which have no key -- or None without a row bound, whether all hold, a
    note)."""
    o, r = out.float(), ref.float()
    atol, rtol, row_tol = tol
    diff = (o - r).abs()
    err = diff.max().item()
    used = (diff / (atol + rtol * r.abs())).max().item()
    ok = used <= 1.0
    note = f"max_abs_err={err:.3e} ({used:.3f} of atol {atol:g} + rtol {rtol:g})"
    row = None
    if row_tol is not None:
        norms = r.norm(dim=-1)
        live = norms[norms > 0]
        floor = live.median().item() if live.numel() else 1.0
        row = ((o - r).norm(dim=-1) / norms.clamp_min(floor)).max().item()
        ok = ok and row <= row_tol
        note += f", worst row {row:.3e} (bound {row_tol:g})"
    return err, used, row, ok, note


def check(name, dtype, shape, out, ref, tol=TOL) -> float:
    """Kernel output against the plain version: finite, same shape, each
    element within the dtype's (atol, rtol) and, where ``tol`` gives a row
    bound, each row (last dim) within it. Returns the max abs error."""
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {dtype} {shape}: non-finite output")
    err, _, _, ok, note = readings(out, ref, tol[dtype])
    print(f"check {name} {str(dtype)[6:]} {shape} {note} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape} disagrees with its "
                             f"plain version: {note}")
    return err


def int8_entry(rng, shape):
    """An int8 pool entry ``(k, v, k_scale, v_scale)`` of ``shape`` ``[NB,
    BS, H, D]``: standard normal K/V quantized per token row on the card."""
    from paddle_tpu_torch.quantization import quantize_kv

    (kq, ks), (vq, vs) = (quantize_kv(randn(rng, shape, torch.float32))
                          for _ in range(2))
    return kq, vq, ks, vs


def scratch_entry(rng, shape, dtype, int8):
    """A pool entry of ``shape`` ``[NB, BS, H, D]`` (full precision in
    ``dtype``, or int8) whose scratch block 0 reads 1e4 in every element
    (int8: payload 127 at scale 1e4 / 127), so a key read through a stale
    table entry shows."""
    if int8:
        entry = int8_entry(rng, shape)
        entry[0][0] = entry[1][0] = 127
        entry[2][0] = entry[3][0] = 1e4 / 127
        return entry
    kp, vp = (randn(rng, shape, dtype) for _ in range(2))
    kp[0] = vp[0] = 1e4
    return kp, vp


def decode_checks(pa):
    """Phase 2, the decode kernel's edges (a generator of their own): at
    head dims 32, 64, 128 (H = 16) and 256, in f32, bf16 and float16, over
    full-precision and int8 pools, the positions DECODE_POS in one launch
    through a permuted table of 132 blocks whose entries past each slot's
    last block are 0 (the scratch block, which reads 1e4), two lanes
    sharing their first block, q the qkv split's strided view. A second
    launch on the same inputs must give the same bits (the merge order and
    the ticket counters' reset). At head dim 256 also the prefill's
    CUDA-core form, both pools: 37 queries at prefixes 5 and 1000, and the
    full prefill of 37 and 300."""
    rng = np.random.default_rng(11)
    S, MB = len(DECODE_POS), 132
    nb = S * MB + 1
    for d in (32, 64, D, 256):
        h = H if d == D else 4
        perm = rng.permutation(np.arange(1, nb)).reshape(S, MB)
        perm[2, 0] = perm[1, 0]  # lanes 1 and 2 share their first block
        for i, p in enumerate(DECODE_POS):
            perm[i, p // BS + 1:] = 0
        bt = torch.as_tensor(perm, dtype=torch.int32, device="cuda")
        pos = torch.tensor(DECODE_POS, dtype=torch.int32, device="cuda")
        for dtype in DTYPES:
            for int8 in (False, True):
                entry = scratch_entry(rng, (nb, BS, h, d), dtype, int8)
                name = "paged_decode_attention" + ("_int8" if int8 else "")
                q = qkv_split(rng, S, h, d, dtype)[0]
                out = pa.paged_decode_attention(q, entry, bt, pos)
                again = pa.paged_decode_attention(q, entry, bt, pos)
                tag = f"S={S} H={h} D={d} MB={MB} ragged"
                check(name, dtype, tag, out,
                      pa.paged_decode_attention_ref(q, entry, bt, pos))
                if not torch.equal(out, again):
                    raise AssertionError(f"{name} {dtype} {tag}: two "
                                         "launches on the same inputs differ")
                if d != 256:
                    continue
                name = "paged_prefill_attention" + ("_int8" if int8 else "")
                q = qkv_split(rng, 37, h, d, dtype)[0]
                row = bt[DECODE_POS.index(2047)]  # 128 blocks, then 0s
                for prefix in (5, 1000):
                    check(name, dtype, f"sq=37 prefix={prefix} H={h} D={d}",
                          pa.paged_prefill_attention(q, entry, row, prefix),
                          pa.paged_prefill_attention_ref(q, entry, row,
                                                         prefix))
                if int8:
                    continue
                for sq in (37, 300):
                    q, k, v = qkv_split(rng, sq, h, d, dtype)
                    check("paged_full_prefill_attention", dtype,
                          f"sq={sq} H={h} D={d}",
                          pa.paged_full_prefill_attention(q, k, v, BS),
                          pa.paged_full_prefill_attention_ref(q, k, v, BS))
            torch.cuda.empty_cache()


def kernel_checks(pa):
    """Phase 2: every kernel against its plain version on the card."""
    rng = np.random.default_rng(0)
    for dtype in DTYPES:
        # the serving path's shapes: 8 slots x 128 blocks of 16 (2048 keys)
        S, MB = 8, 128
        nb = S * MB + 1
        kp, vp = (randn(rng, (nb, BS, H, D), dtype) for _ in range(2))
        perm = rng.permutation(np.arange(1, nb))[:S * MB].reshape(S, MB)
        perm[1, 0] = perm[0, 0]  # lanes 0 and 1 share their first block
        bt = torch.as_tensor(perm, dtype=torch.int32, device="cuda")
        pos = torch.tensor([0, BS - 1, BS, 2047, 700, 33, 1000, 2040],
                           dtype=torch.int32, device="cuda")
        q = qkv_split(rng, S, H, D, dtype)[0]
        check("paged_decode_attention", dtype, f"S={S} H={H} D={D} MB={MB}",
              pa.paged_decode_attention(q, (kp, vp), bt, pos),
              pa.paged_decode_attention_ref(q, (kp, vp), bt, pos))
        for sq, prefix in ((16, 0), (48, 0), (512, 0), (48, 37)):
            q = qkv_split(rng, sq, H, D, dtype)[0]
            check("paged_prefill_attention", dtype,
                  f"sq={sq} prefix={prefix} H={H} D={D} MB={MB}",
                  pa.paged_prefill_attention(q, (kp, vp), bt[3], prefix),
                  pa.paged_prefill_attention_ref(q, (kp, vp), bt[3], prefix))
        sq = 200  # not a multiple of the block size: pad keys are masked
        q, k, v = qkv_split(rng, sq, H, D, dtype)
        check("paged_full_prefill_attention", dtype, f"sq={sq} H={H} D={D}",
              pa.paged_full_prefill_attention(q, k, v, BS),
              pa.paged_full_prefill_attention_ref(q, k, v, BS))
        del kp, vp
        # the int8 variants over the same tables: decode, and chunks of 256
        # (the chunked-prefill path's) at prefixes 0 and 768
        entry = int8_entry(rng, (nb, BS, H, D))
        q = qkv_split(rng, S, H, D, dtype)[0]
        check("paged_decode_attention_int8", dtype,
              f"S={S} H={H} D={D} MB={MB}",
              pa.paged_decode_attention(q, entry, bt, pos),
              pa.paged_decode_attention_ref(q, entry, bt, pos))
        for sq, prefix in ((256, 0), (256, 768), (48, 37)):
            q = qkv_split(rng, sq, H, D, dtype)[0]
            check("paged_prefill_attention_int8", dtype,
                  f"sq={sq} prefix={prefix} H={H} D={D} MB={MB}",
                  pa.paged_prefill_attention(q, entry, bt[3], prefix),
                  pa.paged_prefill_attention_ref(q, entry, bt[3], prefix))
        del entry
        for d in (64, 32):  # the other supported GPT head dims, small
            h, S, MB = 4, 3, 8
            nb = S * MB + 1
            kp, vp = (randn(rng, (nb, BS, h, d), dtype) for _ in range(2))
            bt = torch.as_tensor(
                rng.permutation(np.arange(1, nb)).reshape(S, MB),
                dtype=torch.int32, device="cuda")
            pos = torch.tensor([0, 17, MB * BS - 1], dtype=torch.int32,
                               device="cuda")
            q = qkv_split(rng, S, h, d, dtype)[0]
            check("paged_decode_attention", dtype, f"S={S} H={h} D={d}",
                  pa.paged_decode_attention(q, (kp, vp), bt, pos),
                  pa.paged_decode_attention_ref(q, (kp, vp), bt, pos))
            q = qkv_split(rng, 24, h, d, dtype)[0]
            check("paged_prefill_attention", dtype,
                  f"sq=24 prefix=5 H={h} D={d}",
                  pa.paged_prefill_attention(q, (kp, vp), bt[2], 5),
                  pa.paged_prefill_attention_ref(q, (kp, vp), bt[2], 5))
            q, k, v = qkv_split(rng, 20, h, d, dtype)
            check("paged_full_prefill_attention", dtype, f"sq=20 H={h} D={d}",
                  pa.paged_full_prefill_attention(q, k, v, BS),
                  pa.paged_full_prefill_attention_ref(q, k, v, BS))
            entry = int8_entry(rng, (nb, BS, h, d))
            q = qkv_split(rng, S, h, d, dtype)[0]
            check("paged_decode_attention_int8", dtype, f"S={S} H={h} D={d}",
                  pa.paged_decode_attention(q, entry, bt, pos),
                  pa.paged_decode_attention_ref(q, entry, bt, pos))
            q = qkv_split(rng, 24, h, d, dtype)[0]
            check("paged_prefill_attention_int8", dtype,
                  f"sq=24 prefix=5 H={h} D={d}",
                  pa.paged_prefill_attention(q, entry, bt[2], 5),
                  pa.paged_prefill_attention_ref(q, entry, bt[2], 5))
    for dtype in DTYPES:
        prefill_edges(pa, np.random.default_rng(9), dtype)
    decode_checks(pa)


def prefill_edges(pa, rng, dtype):
    """The prefill kernel's tile edges, both instances, head dims 128 and
    64, through a permuted table of 16-key blocks: one query and query
    counts that end inside a 16-row warp tile, a 32- and a 64-row block tile
    (37, 65, 300), at prefixes 0, 5, 768 and 1000, so the last key (and the
    last 64-key tile) ends inside a block; and the full-prefill route at the
    same counts. Then the prefix cache's inputs: a table sharing its first
    32 blocks with the first, 64 queries at prefix 512, and one query at
    prefixes 511 and 1023 (a copy-on-write recompute)."""
    h, MB = 4, 96  # 1536 keys: the longest walk is 1000 + 300
    for d in (D, 64):
        nb = MB + 1
        entries = {
            "paged_prefill_attention":
                tuple(randn(rng, (nb, BS, h, d), dtype) for _ in range(2)),
            "paged_prefill_attention_int8": int8_entry(rng, (nb, BS, h, d))}
        bt = torch.as_tensor(rng.permutation(np.arange(1, nb)),
                             dtype=torch.int32, device="cuda")
        for sq in (1, 37, 65, 300):
            q, k, v = qkv_split(rng, sq, h, d, dtype)
            check("paged_full_prefill_attention", dtype,
                  f"sq={sq} H={h} D={d}",
                  pa.paged_full_prefill_attention(q, k, v, BS),
                  pa.paged_full_prefill_attention_ref(q, k, v, BS))
            for prefix in (0, 5, 768, 1000):
                for name, entry in entries.items():
                    check(name, dtype, f"sq={sq} prefix={prefix} H={h} D={d}",
                          pa.paged_prefill_attention(q, entry, bt, prefix),
                          pa.paged_prefill_attention_ref(q, entry, bt,
                                                         prefix))
        # the prefix cache's inputs: a table whose first 32 blocks are
        # ``bt``'s (a hit attached to another slot's prefix, then its own
        # blocks), a 64-token suffix at 512, and one query at clen - 1 (the
        # copy-on-write recompute of a fully cached, block-aligned context)
        # (queries from a generator of their own: the older checks keep
        # their inputs)
        hit = torch.cat([bt[:32], bt[32:].flip(0)])
        qrng = np.random.default_rng(90 + d)
        for table, sq, prefix in ((hit, 64, 512), (hit, 1, 511),
                                  (bt, 1, 511), (hit, 1, 1023)):
            q = qkv_split(qrng, sq, h, d, dtype)[0]
            for name, entry in entries.items():
                check(name, dtype, f"shared table sq={sq} prefix={prefix} "
                      f"H={h} D={d}",
                      pa.paged_prefill_attention(q, entry, table, prefix),
                      pa.paged_prefill_attention_ref(q, entry, table,
                                                     prefix))


def decode_compiles() -> int:
    from paddle_tpu_torch.core import compile_cache

    return compile_cache.stats().get("serving.decode_compiles", 0)


def builds(eng):
    """The engine's program builds so far: (decode, whole-prompt prefill,
    suffix/chunk prefill). On the card each build warmed its step up once
    (a real launch of every layer's kernel) and captured it."""
    return (eng.decode_traces, sum(eng.prefill_traces.values()),
            sum(eng.prefix_prefill_traces.values()))


def ran_counts(eng):
    """What the engine has run so far: decode steps, whole-prompt
    prefills, prefill chunks, cache hits' suffix prefills, then
    ``builds``."""
    return (eng.decode_steps, eng.prefills, eng.prefill_chunks,
            eng.suffix_prefills) + builds(eng)


def serve(api, pa, prompts, news, what, card, submit_kw=None, drive=None):
    """Serve ``prompts`` through ``api`` with the launch counters (paged
    attention and sampling) set to 0 just before and read just after;
    ``submit_kw`` gives each request's other ``submit`` arguments;
    ``drive(submit)``, where given, submits (``submit(i)`` submits request
    i) and pumps in its own order instead of submitting all at once. Every
    request must finish with its budget of tokens (or at its stop token),
    every block must be free again (or held by the prefix cache) and the
    arena's invariants must hold. Returns the requests, the launches and
    what the engine ran meanwhile (``ran_counts``)."""
    from paddle_tpu_torch.ops import sampling as so
    from paddle_tpu_torch.serving import RequestState

    eng = api.engine
    submit_kw = submit_kw or [{}] * len(prompts)
    before = ran_counts(eng)
    t0 = time.perf_counter()
    pa.reset_launches()
    so.reset_launches()
    reqs = [None] * len(prompts)

    def submit(i):
        reqs[i] = api.submit(prompts[i], max_new_tokens=news[i],
                             **submit_kw[i])
        return reqs[i]

    if drive is None:
        for i in range(len(prompts)):
            submit(i)
    else:
        drive(submit)
    api.run_until_idle()
    torch.cuda.synchronize()
    launches = dict(pa.launches) | dict(so.launches)
    ran = types.SimpleNamespace(**dict(zip(
        ("steps", "prefills", "chunks", "suffix", "decode_builds",
         "prefill_builds", "chunk_builds"),
        (a - b for a, b in zip(ran_counts(eng), before)))))
    print(f"e2e {what}: served {len(reqs)} requests in "
          f"{time.perf_counter() - t0:.2f} s, {ran.prefills} prefills, "
          f"{ran.chunks} prefill chunks, {ran.suffix} suffix prefills, "
          f"{ran.steps} decode steps (graphs built: decode "
          f"{ran.decode_builds}, prefill {ran.prefill_builds}, chunk "
          f"{ran.chunk_builds}), launches {launches} [{card}]")
    for r, n in zip(reqs, news):
        stopped = (r.stop_token_id is not None and r.tokens
                   and r.tokens[-1] == r.stop_token_id)
        if r.state != RequestState.FINISHED or (len(r.tokens) != n
                                                and not stopped):
            raise AssertionError(f"{r.request_id}: state {r.state}, "
                                 f"{len(r.tokens)}/{n} tokens, {r.error!r}")
    eng.check_invariants()
    if eng.arena.blocks_in_use() != eng.arena.blocks_cached():
        raise AssertionError("blocks still in use after every retire")
    return reqs, launches, ran


def want_launches(layers, ran, decode="paged_decode_attention",
                  prefill="paged_prefill_attention", chunk=None):
    """The exact launch counts of a served run: each layer's kernel once per
    replay of a program that attends through it, and once per warm-up
    (one per build; a capture launches nothing and is not counted); the
    sampling kernel once per replay and warm-up of every program. Chunks
    and cache hits' suffixes run the suffix programs, through the ``chunk``
    kernel (the prefill kernel where None)."""
    chunk = chunk or prefill
    want = {decode: layers * (ran.steps + ran.decode_builds),
            prefill: layers * (ran.prefills + ran.prefill_builds),
            "sample_tokens": (ran.steps + ran.decode_builds + ran.prefills
                              + ran.prefill_builds + ran.chunks
                              + ran.suffix + ran.chunk_builds)}
    want[chunk] = want.get(chunk, 0) + layers * (ran.chunks + ran.suffix
                                                 + ran.chunk_builds)
    return want


def hold_programs(eng, compiles_before, lens, what, card, chunk=0,
                  decoded=True):
    """The no-rebuild contract after a serving phase: one decode graph
    (``decode_traces == 1``, ``serving.decode_compiles`` moved by 1 since
    the engine was built), every prefill and chunk bucket built once, their
    keys exactly the buckets of the phase's prompts (``lens``; with
    ``chunk`` the chunk buckets, clamped to the positions left), and one
    CUDA graph per program. ``decoded=False``: an engine that only
    prefilled holds no decode program. Prints the engine's graph pool
    bytes."""
    from paddle_tpu_torch.core import compile_cache

    full, suffix = set(), set()
    max_pos = eng._model.cfg.max_position_embeddings
    for n in lens:
        if chunk <= 0 or n <= chunk:
            full.add(compile_cache.prefill_bucket(
                n, eng.max_model_len, eng.prefill_bucket_min))
            continue
        for done in range(0, n, chunk):
            take = min(chunk, n - done)
            suffix.add(min(compile_cache.prefill_bucket(
                take, eng.max_model_len, eng.prefill_bucket_min),
                max_pos - done))
    graphs = eng.stats()["programs.graphs"]
    moved = decode_compiles() - compiles_before
    print(f"programs {what}: decode_traces {eng.decode_traces} "
          f"(serving.decode_compiles +{moved}), prefill_traces "
          f"{dict(sorted(eng.prefill_traces.items()))}, prefix_prefill_traces"
          f" {dict(sorted(eng.prefix_prefill_traces.items()))}, {graphs} CUDA"
          f" graphs, pool {eng.stats()['programs.pool_bytes']} bytes [{card}]")
    if eng.decode_traces != decoded or moved != decoded:
        raise AssertionError(f"{what}: {eng.decode_traces} decode builds, "
                             f"serving.decode_compiles +{moved}, not "
                             f"{int(decoded)}")
    for traces, want in ((eng.prefill_traces, full),
                         (eng.prefix_prefill_traces, suffix)):
        if set(traces) != want or any(v != 1 for v in traces.values()):
            raise AssertionError(f"{what}: prefill builds {traces}, want "
                                 f"each of {sorted(want)} once")
    if graphs != decoded + len(full) + len(suffix):
        raise AssertionError(f"{what}: {graphs} CUDA graphs for "
                             f"{decoded + len(full) + len(suffix)} programs")


def hold_to_generate(model, prompts, reqs, news, what, card):
    """Every request's greedy tokens must equal ``model.generate()``."""
    t0 = time.perf_counter()
    for i, (p, r, n) in enumerate(zip(prompts, reqs, news)):
        ref = model.generate(p[None], max_new_tokens=n)[0, len(p):]
        got = np.asarray(r.tokens)
        ref = ref.cpu().numpy()
        if not np.array_equal(got, ref):
            j = int(np.flatnonzero(got != ref)[0])
            raise AssertionError(f"{what}: request {i} (prompt {len(p)}): "
                                 f"served tokens diverge from generate() at "
                                 f"{j}: {got[:j + 2]} vs {ref[:j + 2]}")
    print(f"e2e {what}: greedy tokens of all {len(reqs)} requests equal "
          f"generate() ({time.perf_counter() - t0:.1f} s) [{card}]")


def hold_launches(launches, want, what):
    want = {name: want.get(name, 0) for name in PAGED + SAMPLING}
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches} != {want}")


#: seeded weights drawn on host threads while the kernels build (the
#: whole run's; ``seeded`` takes them, or draws at once without them)
_DRAWN = {}


def _seeded_meta(gpt, cfg, seed):
    """``gpt.seeded_state`` of a tied ``GPTForCausalLM(cfg)``: the same
    arrays, drawn from its parameters' names and shapes on the meta device
    (nothing allocated)."""
    holder = torch.nn.Module()
    holder.gpt = gpt.GPTModel(cfg, device="meta")
    return gpt.seeded_state(holder, seed=seed)


def draw_ahead(gpt, pool):
    """Start drawing, on ``pool``'s threads, the seeded weights of every
    model the whole run seeds: gpt_1p3b (phase 3 on, seed 0), 3c's wide
    vocabulary (seed 5), 11's heads of 256 (seed 3) and 13's drafts (seeds
    3 and 1)."""
    base = gpt.gpt_1p3b()
    jobs = {("1p3b", 0): base,
            ("wide_vocab", 5): dataclasses.replace(
                base, num_layers=2, vocab_size=LLAMA3_VOCAB),
            ("d256", 3): dataclasses.replace(base, num_heads=8,
                                             num_layers=2)}
    for seed, layers in ((3, SPEC_F32[1]), (1, 12)):
        jobs[("draft", seed)] = spec_draft_config(gpt, layers)
    for key, cfg in jobs.items():
        _DRAWN[key] = pool.submit(_seeded_meta, gpt, cfg, key[1])


def seeded(gpt, model, key, seed):
    """``gpt.seeded_state(model, seed)``: the arrays :func:`draw_ahead`
    drew under ``(key, seed)``, else drawn now."""
    fut = _DRAWN.get((key, seed))
    if fut is not None:
        arrays = fut.result()
        if [n for n, _ in model.named_parameters()] == list(arrays):
            return arrays
    return gpt.seeded_state(model, seed=seed)


def serve_f32(pa, gpt, serving, card):
    """Phase 3: gpt_1p3b in f32 through ServingAPI, held against
    generate(). Returns the model, the main path's kernel launches and the
    seeded weights (numpy, reused by the later phases)."""
    t0 = time.perf_counter()
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    arrays = seeded(gpt, model, "1p3b", 0)
    gpt.load_functional_state(model, arrays)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"e2e f32: gpt_1p3b {n_params} params, 24 layers, seeded weights "
          f"loaded in {time.perf_counter() - t0:.1f} s [{card}]")
    layers = model.cfg.num_layers
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    rng = np.random.default_rng(1)
    lens = [5, 700, 37, 129, 16, 300, 64, 511, 9, 250, 48, 17]
    news = [16, 32, 24, 20, 32, 16, 28, 18, 30, 22, 26, 32]
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]
    reqs, launches, ran = serve(api, pa, prompts, news, "f32", card)
    if ran.prefills != len(reqs):
        raise AssertionError(f"{ran.prefills} prefills for {len(reqs)} "
                             "requests")
    hold_launches(launches, want_launches(layers, ran),
                  "f32 (24 x (decode steps + warm-ups), 24 x (prefills + "
                  "warm-ups))")
    hold_to_generate(model, prompts, reqs, news, "f32", card)
    hold_programs(api.engine, cc, lens, "f32", card)
    churn(api, pa, model, lens, card)
    hold_programs(api.engine, cc, lens, "f32 after the churn wave", card)
    api.close()
    return model, launches, arrays


# the churn wave on phase 3's engine: 1, 3, 5 and 8 live requests of other
# lengths, each in a bucket phase 3 already captured
CHURN = [([7], [8]), ([22, 41, 650], [6, 9, 7]),
         ([11, 55, 150, 230, 320], [5, 8, 6, 9, 7]),
         ([3, 19, 35, 60, 140, 200, 290, 450], [6, 7, 8, 9, 5, 6, 7, 8])]


def churn(api, pa, model, lens, card):
    """Phase 3's churn check (the card's ``test_admit_retire_never_
    recompiles``): waves of 1, 3, 5 and 8 live requests of other lengths
    in the buckets already captured. No program is built again, every
    launch is a replay's (24 x decode steps, 24 x prefills), and the tokens
    equal generate()."""
    from paddle_tpu_torch.core import compile_cache

    eng = api.engine
    layers = model.cfg.num_layers
    buckets = {compile_cache.prefill_bucket(n, eng.max_model_len,
                                            eng.prefill_bucket_min)
               for n in lens}
    rng = np.random.default_rng(13)
    for wave, news in CHURN:
        if not {compile_cache.prefill_bucket(n, eng.max_model_len,
                                             eng.prefill_bucket_min)
                for n in wave} <= buckets:
            raise AssertionError(f"churn wave {wave} leaves the captured "
                                 "buckets")
        prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in wave]
        what = f"f32 churn, {len(wave)} live"
        reqs, launches, ran = serve(api, pa, prompts, news, what, card)
        if (ran.decode_builds, ran.prefill_builds, ran.chunk_builds) \
                != (0, 0, 0):
            raise AssertionError(f"{what}: programs built again {ran}")
        hold_launches(launches, want_launches(layers, ran),
                      f"{what} (24 x decode steps, 24 x prefills)")
        hold_to_generate(model, prompts, reqs, news, what, card)


# the sampling phases: a synthetic token table for the regex constraint
# (token 10 + i spells a letter, 40 + i a digit), the stop token and the
# trie's choices; the sampled setting is profile_decode.SAMPLED
STOP = 3
TABLE = {**{10 + i: chr(97 + i) for i in range(26)},
         **{40 + i: str(i) for i in range(10)}}
REGEX = r"[a-c]+[0-9][a-z]+"
TRIE = [[5, 6, 7], [5, 9], [1000, 2000, 3000, 4000]]
# a sampled token that another computation of the same draw chose may
# differ only with the draw this close (relative to cum[-1]) to its interval
# of cum: the kernel against its plain version on the same logits (float32
# sums of another order), and a served token against generate()'s, whose
# logits come through other attention kernels (on a near-flat distribution
# over 50304 tokens, intervals are about 2e-5 wide and a boundary moves by
# about the logits' relative difference, 1e-6 to 1e-5 after 24 layers)
BOUNDARY, SERVED_BOUNDARY = 1e-6, 1e-4
LLAMA3_VOCAB = 128256  # the vocabulary of Llama 3
# a width past the cluster's shared memory (H100: 227 KB a CTA): each CTA
# reads its slice again from the logits at every pass
WIDE_VOCAB = 600000


def sampling_rows(rng, vocab, cases, dtype=torch.float32):
    """One launch's inputs on the card from ``cases``, one per row: a dict
    of temperature, top_k, top_p and what to do to the row (``tie``:
    integer logits; ``half_inf``: every other entry -inf; ``all_inf``;
    ``allow``: the number of tokens its mask allows; ``near_zero``: a
    cluster of values in [0, 1e-30) with 16 logits of ``near_zero`` + U(0,
    1) and one of -10, where 64 halvings of the bracket do not narrow to one
    float; ``zeros``: exact zeros with 10 and -10 once each and every third
    entry -inf, so the symmetric bracket's first step lands on the zero
    threshold; ``boundary``: the row's maximum tied on both sides of every
    multiple of ``boundary`` (the kernel's slice edges)). Logits are N(0, 3)
    in ``dtype``."""
    rows = len(cases)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    allowed = np.ones((rows, vocab), np.bool_)
    for i, c in enumerate(cases):
        if c.get("tie"):
            logits[i] = np.round(logits[i] / 3)
        if c.get("half_inf"):
            logits[i, 1::2] = -np.inf
        if c.get("all_inf"):
            logits[i] = -np.inf
        if "near_zero" in c:
            logits[i] = rng.random(vocab) * 1e-30
            logits[i, rng.choice(vocab, 16, replace=False)] = (
                c["near_zero"] + rng.random(16))
            logits[i, rng.integers(vocab)] = -10
        if c.get("zeros"):
            logits[i] = 0
            logits[i, 2::3] = -np.inf
            logits[i, [1, vocab - 2]] = [10, -10]
        if "boundary" in c:
            edges = np.arange(c["boundary"], vocab, c["boundary"])
            top = logits[i].max() + 1
            logits[i, np.concatenate([edges - 1, edges])] = top
        if "allow" in c:
            allowed[i] = False
            allowed[i, rng.choice(vocab, c["allow"], replace=False)] = True
    col = lambda key, default, dt: torch.tensor(  # noqa: E731
        [c.get(key, default) for c in cases], dtype=dt, device="cuda")
    return (torch.from_numpy(logits).to(device="cuda", dtype=dtype),
            col("temperature", 0.0, torch.float32),
            col("top_k", 0, torch.int32), col("top_p", 1.0, torch.float32),
            torch.tensor(rng.integers(-2 ** 31, 2 ** 31, rows),
                         dtype=torch.int32, device="cuda"),
            torch.tensor(rng.integers(0, 2048, rows), dtype=torch.int32,
                         device="cuda"),
            torch.from_numpy(allowed).cuda())


def hold_sampling(so, args, what, card):
    """The sampling kernel against its plain version on the same inputs: u
    bit-equal, tokens equal (a sampled row's token may differ only with its
    draw within BOUNDARY of the kernel token's interval of the plain
    version's cum: printed), every token allowed by its mask, and two
    launches bit-equal; bf16 and float16 logits also give the tokens and u
    of the same logits cast to float32, bit for bit. Returns the number of
    rows whose tokens differed and the largest |u - plain u|."""
    tok, u = so.sample(*args)
    tok2, u2 = so.sample(*args)
    ref, ref_u = so.sample_ref(*args)
    torch.cuda.synchronize()
    if not (torch.equal(tok, tok2) and torch.equal(u.view(torch.int32),
                                                   u2.view(torch.int32))):
        raise AssertionError(f"sampling {what}: two launches differ")
    if not torch.equal(u.view(torch.int32), ref_u.view(torch.int32)):
        raise AssertionError(f"sampling {what}: u differs from the plain "
                             f"version's: {u.tolist()} vs {ref_u.tolist()}")
    logits, temperature, top_k, top_p, _, _, allowed = args
    if logits.dtype != torch.float32:
        tok32, u32 = so.sample(logits.float(), *args[1:])
        if not (torch.equal(tok, tok32) and torch.equal(
                u.view(torch.int32), u32.view(torch.int32))):
            raise AssertionError(f"sampling {what}: {logits.dtype} logits "
                                 f"give {tok.tolist()}, their float32 cast "
                                 f"{tok32.tolist()}")
    rows = torch.arange(len(tok), device="cuda")
    if not bool(allowed[rows, tok].all()):
        raise AssertionError(f"sampling {what}: a token outside its mask")
    diff = torch.nonzero(tok != ref).flatten().tolist()
    if diff:
        margin = so.draw_margin(logits, temperature, top_k, top_p, allowed,
                                ref_u, tok)
        for i in diff:
            print(f"sampling {what}: row {i} token {int(tok[i])} vs plain "
                  f"{int(ref[i])}, the draw {float(margin[i]):.3e} "
                  f"(relative) from the kernel token's interval of the plain "
                  f"cum [{card}]")
            if not (float(temperature[i]) > 0
                    and float(margin[i]) <= BOUNDARY):
                raise AssertionError(f"sampling {what}: row {i} differs away "
                                     "from any boundary of cum")
    print(f"sampling {what}: {len(tok)} rows, u bit-equal, tokens equal in "
          f"{len(tok) - len(diff)} rows, two launches bit-equal ok [{card}]")
    return len(diff), float((u - ref_u).abs().max())


def hold_alone(so, args, i, tok, what):
    """Row ``i`` sampled alone ([1, V], a prefill's shape) gives its token
    of the batch."""
    one = tuple(a[i:i + 1] for a in args)
    if int(so.sample(*one)[0][0]) != int(tok[i]):
        raise AssertionError(f"sampling {what} row {i}: alone and in the "
                             "batch differ")


def sampling_batches(so, vocab):
    """The sampling checks' launches: (what, vocab, dtype, seed, cases);
    launches that name the same seed draw from one stream, in order. Two
    batches of every case at ``vocab`` (greedy, temperatures, top-k
    0/1/5/50/V+10, top-p 0/0.05/0.9/0.95/1, tied logits, -inf entries, an
    all -inf row, masks leaving 1, 3 and 1000 tokens); the rows where the
    JAX bisection keeps another set than an exact threshold (near-zero
    clusters for top-k and for top-p, a zero threshold hit by a step) and
    ties straddling the slice edges of the kernel's cluster plan; a width
    that no cluster divides (V + 3, no 16-byte loads) and one that leaves
    ranks empty (37); Llama 3's 128,256; ``WIDE_VOCAB``, past the CTAs'
    shared memory (slices read again from L2); bf16 and float16 logits;
    rows whose crossing bucket holds more entries than a warp sorts."""
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    edge = so.slice_len(vocab)
    mixed = [dict(), dict(temperature=0.7),
             dict(temperature=1.3, top_k=5, top_p=0.9), dict(SAMPLED),
             dict(temperature=1.0, top_k=vocab + 10, top_p=0.05, tie=True),
             dict(temperature=0.9, top_k=1, top_p=0.0, half_inf=True),
             dict(temperature=1.1, top_p=0.9, allow=3),
             dict(temperature=1.0, all_inf=True)]
    second = [dict(temperature=0.5, top_k=40, allow=1000),
              dict(temperature=1.5, top_p=0.5),
              dict(temperature=1.0, top_k=vocab, top_p=0.9, allow=1000),
              dict(allow=1), dict(temperature=0.8, allow=1), dict(tie=True),
              dict(temperature=1.2, top_k=50, top_p=0.95, tie=True),
              dict(temperature=0.6, top_p=0.99, half_inf=True)]
    bracket = [dict(temperature=1.0, top_k=40, near_zero=3),
               dict(temperature=1.0, top_k=300, near_zero=10),
               dict(temperature=1.0, top_p=0.95, near_zero=10),
               dict(temperature=1.0, top_k=60, top_p=0.97, near_zero=3),
               dict(temperature=2.0, top_p=0.95, zeros=True),
               dict(temperature=2.0, top_p=0.9, zeros=True),
               dict(boundary=edge),
               dict(temperature=1.0, top_k=3, top_p=0.9, boundary=edge),
               # tens to hundreds of entries in the crossing bucket: the
               # gather sorts them in shared memory, not in one warp
               dict(temperature=1.0, top_k=500),
               dict(temperature=3.0, top_p=0.5)]
    llama = LLAMA3_VOCAB
    wide_edge = so.slice_len(llama)
    wide = WIDE_VOCAB
    return [
        (f"batch 0 [8, {vocab}]", vocab, torch.float32, 20, mixed),
        (f"batch 1 [8, {vocab}]", vocab, torch.float32, 20, second),
        (f"bracket and edges [10, {vocab}], slice {edge}", vocab,
         torch.float32, 23, bracket),
        (f"[8, {vocab + 3}]", vocab + 3, torch.float32, 24, mixed),
        ("[4, 37]", 37, torch.float32, 25,
         [dict(), dict(SAMPLED), dict(temperature=1.0, top_p=0.6),
          dict(temperature=0.9, top_k=3, tie=True)]),
        (f"[8, {llama}], slice {wide_edge}", llama, torch.float32, 26,
         [dict(), dict(SAMPLED), dict(temperature=1.2, top_p=0.9),
          dict(temperature=1.0, top_k=50, near_zero=10),
          dict(temperature=2.0, top_p=0.95, zeros=True),
          dict(boundary=wide_edge),
          dict(temperature=1.0, top_k=2, boundary=wide_edge),
          dict(temperature=0.8, top_k=20, allow=1000)]),
        (f"[4, {wide}], resident "
         f"{so.row_resident(torch.device('cuda', 0), wide, torch.float32)}",
         wide, torch.float32, 30,
         [dict(), dict(SAMPLED), dict(temperature=1.2, top_p=0.9),
          dict(temperature=1.0, top_k=5, boundary=so.slice_len(wide))]),
        (f"bf16 [8, {vocab}]", vocab, torch.bfloat16, 27, mixed),
        (f"float16 [8, {vocab}]", vocab, torch.float16, 28, second),
    ]


def sampling_checks(so, vocab, card):
    """Phase 2, sampling: the kernel against its plain version on every
    launch of ``sampling_batches``, each row also alone ([1, V], the
    prefill's shape) and equal to its row of the batch. Returns the number
    of rows whose tokens differed and the largest |u - plain u|."""
    readings, streams = [], {}
    for what, v, dtype, seed, cases in sampling_batches(so, vocab):
        rng = streams.setdefault(seed, np.random.default_rng(seed))
        args = sampling_rows(rng, v, cases, dtype)
        readings.append(hold_sampling(so, args, what, card))
        tok = so.sample(*args)[0]
        for i in range(len(cases)):
            one = tuple(a[i:i + 1] for a in args)
            readings.append(hold_sampling(so, one, f"{what} row {i} alone",
                                          card))
            hold_alone(so, args, i, tok, what)
    return (sum(r[0] for r in readings), max(r[1] for r in readings))


def sampling_times(so, vocab, card):
    """The sampling kernel at the decode step's shape, 8 rows of ``vocab``,
    and at a prefill's, 1 row: float32 and bf16 logits, all sampled at
    SAMPLED and all greedy, each beside its bound, the plain version and
    ``torch.argmax`` on the same logits in the same call (the greedy
    function; no one PyTorch call samples with top-k/top-p under threefry
    keys). Keyed ``(dtype name, rows, "sampled" or "greedy")``."""
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    rng = np.random.default_rng(22)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    # float32 operations per element that the function needs: mask,
    # divide, the softmax's max, subtract, exp, sum and normalise, a radix
    # select of the top-k and of the top-p threshold (4 passes of 8 bits
    # over a 32-bit key, a compare and a count or sum each), the scan and
    # the final count; a greedy row: mask, argmax
    per_sampled = 2 + 5 + 2 * 4 * 2 + 2
    t = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        esz = torch.empty((), dtype=dtype).element_size()
        for rows in (8, 1):
            for kind, case, per in (("sampled", dict(SAMPLED), per_sampled),
                                    ("greedy", dict(), 2)):
                args = sampling_rows(rng, vocab, [case] * rows, dtype)
                nbytes = rows * vocab * (esz + 1) + rows * (5 * 4 + 8 + 4)
                b_ms, b_by = bound(nbytes, 0)
                t_ops = rows * vocab * per / F32_FLOPS_PER_S * 1e3
                if t_ops > b_ms:
                    b_ms, b_by = t_ops, "operations"
                r = t[(name, rows, kind)] = dict(
                    ms=time_ms(lambda: so.sample(*args), flush),
                    plain_ms=time_ms(lambda: so.sample_ref(*args), flush,
                                     iters=5),
                    bound_ms=b_ms, bound_by=b_by,
                    argmax_ms=time_ms(lambda: torch.argmax(args[0], dim=-1),
                                      flush))
                print(f"time sample_tokens {kind} [{rows}, {vocab}] {name}: "
                      f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                      f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                      f"torch.argmax {r['argmax_ms']:.4f} ms [{card}]")
    return t


def served_gap(model, ctx, sampling, token):
    """The relative distance from the draw of the token after ``ctx`` under
    ``sampling`` to ``token``'s interval of the cum of the model's full
    causal forward at ``ctx`` (``ops.sampling.draw_margin``)."""
    from paddle_tpu_torch.ops import sampling as so

    with torch.no_grad():
        logits = model(torch.as_tensor(ctx[None], device="cuda"))[0, -1:]
    row = lambda v, dt: torch.tensor([v], dtype=dt, device="cuda")  # noqa
    params = (row(sampling.temperature, torch.float32),
              row(sampling.top_k, torch.int32),
              row(sampling.top_p, torch.float32))
    u = so.sample_ref(logits, *params, row(sampling.seed, torch.int32),
                      row(len(ctx), torch.int32))[1]
    return float(so.draw_margin(logits, *params, None, u,
                                row(token, torch.int64))[0])


def sampled_mix(vocab, n, seed):
    """``submit`` arguments of ``n`` requests cycling through greedy,
    sampled (SAMPLED, seeded), top-k 1 at temperature 0.8, sampled at 1.2
    with top-p 0.9, a TrieConstraint, and a TokenDFA.from_regex over TABLE
    (sampled); request i's seed is ``seed + i``."""
    from paddle_tpu_torch.serving import (SamplingParams, TokenDFA,
                                          TrieConstraint)
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    kinds = ["greedy", "sampled", "top_k1", "top_p", "trie", "regex"]
    kw = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        sp = {"greedy": None, "trie": None,
              "sampled": dict(SAMPLED),
              "top_k1": dict(temperature=0.8, top_k=1),
              "top_p": dict(temperature=1.2, top_p=0.9),
              "regex": dict(temperature=1.0)}[kind]
        k = {} if sp is None else {
            "sampling": SamplingParams(**sp, seed=seed + i)}
        if kind == "trie":
            k.update(constraint=TrieConstraint(TRIE, vocab,
                                               stop_token_id=STOP),
                     stop_token_id=STOP)
        if kind == "regex":
            k.update(constraint=TokenDFA.from_regex(
                REGEX, TABLE, vocab, stop_token_id=STOP),
                stop_token_id=STOP)
        kw.append(k)
    return kw


def hold_sampled_wave(api, pa, model, prompts, news, kw, what, card):
    """Serve one wave of ``sampled_mix`` requests and hold it: every launch
    exact (the sampling kernel once per decode step, prefill, chunk and
    warm-up); unconstrained tokens equal ``generate(sampling=...)``, where a
    sampled token may differ only with its draw within SERVED_BOUNDARY of
    its interval of the cum of the model's full causal forward at that
    context (printed), and the request's later tokens are then held against
    ``generate(sampling=...)`` over the prompt and the served tokens up to
    and including that one (positional keys continue the same stream);
    constrained ones stay in their grammar. Returns the launches and what
    the engine ran."""
    layers = model.cfg.num_layers
    reqs, launches, ran = serve(api, pa, prompts, news, what, card, kw)
    hold_launches(launches, want_launches(
        layers, ran, chunk="paged_prefill_attention"),
        f"{what} ({layers} x (decode steps + warm-ups), {layers} x "
        "(prefills + chunks + warm-ups), sampling 1 x (decode steps + "
        "prefills + chunks + warm-ups))")
    hold_served_tokens(api, model, prompts, reqs, news, kw, what, card)
    return launches, ran


def hold_served_tokens(api, model, prompts, reqs, news, kw, what, card,
                       greedy_refs=None):
    """``hold_sampled_wave``'s token hold: unconstrained tokens equal
    ``generate(sampling=...)`` under the boundary rule, constrained ones
    stay in their grammar. ``greedy_refs`` (request index -> tokens)
    gives greedy references computed beforehand."""
    greedy_refs = greedy_refs or {}
    t0, ok_gen, ok_grammar, diverged = time.perf_counter(), 0, 0, 0
    for i, (p, r, n, k) in enumerate(zip(prompts, reqs, news, kw)):
        c = k.get("constraint")
        if c is not None:
            state = c.initial()
            for tok in r.tokens:
                if not c.allowed(state)[tok]:
                    raise AssertionError(f"{what}: request {i} emitted "
                                         f"{tok} outside its grammar: "
                                         f"{r.tokens}")
                state = c.advance(state, tok)
            ok_grammar += 1
            continue
        got = np.asarray(r.tokens)
        if len(got) != n:
            raise AssertionError(f"{what}: request {i} emitted "
                                 f"{len(got)} tokens, asked {n}")
        start, left = 0, False
        while start < n:
            # generate() from the prompt and got[:start] gives got[start:]
            ctx = np.concatenate([p, got[:start]])
            if start == 0 and i in greedy_refs:
                ref = np.asarray(greedy_refs[i])
            else:
                ref = model.generate(ctx[None], max_new_tokens=n - start,
                                     sampling=r.sampling)[0, len(ctx):]
                ref = ref.cpu().numpy()
            off = np.flatnonzero(got[start:] != ref)
            if not off.size:
                break
            j = start + int(off[0])
            gap = served_gap(model, np.concatenate([p, got[:j]]),
                             r.sampling, int(got[j]))
            print(f"e2e {what}: request {i} ({r.sampling}) leaves "
                  f"generate(sampling=...) at token {j}: {got[j]} vs "
                  f"{ref[j - start]}, the draw {gap:.3e} (relative) "
                  f"from the served token's interval of the full "
                  f"forward's cum; tokens after it held against "
                  f"generate() from there [{card}]")
            if r.sampling is None or r.sampling.greedy \
                    or gap > SERVED_BOUNDARY:
                raise AssertionError(
                    f"{what}: request {i} diverges from generate() at "
                    f"{j}: {got[start:j + 2]} vs "
                    f"{ref[:j - start + 2]}")
            left, start = True, j + 1
        diverged += left
        ok_gen += not left
    print(f"e2e {what}: {ok_gen} unconstrained requests equal "
          f"generate(sampling=...), {diverged} left it at a boundary of "
          f"cum and equal it after, {ok_grammar} constrained ones in "
          f"their grammar ({time.perf_counter() - t0:.1f} s); stats "
          f"sampling.admits {api.engine.sampled_admits}, "
          f"constrain.admits {api.engine.constrained_admits} [{card}]")


def serve_sampled(pa, model, serving, card):
    """Phase 3b: phase 3's f32 model through ServingAPI with chunks of 256,
    12 requests of ``sampled_mix``, held by ``hold_sampled_wave``; the
    engine builds one decode graph and one per bucket, and a second mixed
    wave builds nothing. Returns the first wave's launches."""
    vocab = model.cfg.vocab_size
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, chunked_prefill=CHUNK), device="cuda")
    lens = [5, 700, 37, 129, 16, 300, 64, 511, 9, 250, 48, 17]
    news = [16, 24, 20, 16, 24, 16, 20, 18, 24, 16, 20, 24]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, vocab, n) for n in lens]
    what = f"f32 mixed sampling, chunks of {CHUNK}"
    launches, _ = hold_sampled_wave(api, pa, model, prompts, news,
                                    sampled_mix(vocab, len(lens), 1000),
                                    what, card)
    hold_programs(api.engine, cc, lens, what, card, chunk=CHUNK)
    rng.shuffle(lens)
    prompts = [rng.integers(0, vocab, n) for n in lens]
    _, ran = hold_sampled_wave(api, pa, model, prompts, news,
                               sampled_mix(vocab, len(lens), 2000),
                               what + ", second wave", card)
    if (ran.decode_builds, ran.prefill_builds, ran.chunk_builds) != (0, 0, 0):
        raise AssertionError(f"{what}: the second wave built programs {ran}")
    hold_programs(api.engine, cc, lens, what + ", second wave", card,
                  chunk=CHUNK)
    api.close()
    return launches


def serve_wide_vocab(pa, gpt, serving, card):
    """Phase 3c: gpt_1p3b cut to 2 layers with Llama 3's 128,256-token
    vocabulary (seeded f32 weights), served with chunks of 256 through
    ``hold_sampled_wave``: 10 requests of ``sampled_mix``, greedy tokens
    equal to ``generate()`` and sampled ones to ``generate(sampling=...)``,
    the sampling kernel at a width its first design refused."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=2,
                              vocab_size=LLAMA3_VOCAB)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    gpt.load_functional_state(model, seeded(gpt, model, "wide_vocab", 5))
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, chunked_prefill=CHUNK), device="cuda")
    rng = np.random.default_rng(14)
    lens = [5, 300, 37, 129, 16, 700, 64, 250, 9, 48]
    news = [16, 24, 20, 16, 24, 16, 20, 18, 24, 16]
    prompts = [rng.integers(0, LLAMA3_VOCAB, n) for n in lens]
    what = f"f32 vocab {LLAMA3_VOCAB} (2 layers), chunks of {CHUNK}"
    hold_sampled_wave(api, pa, model, prompts, news,
                      sampled_mix(LLAMA3_VOCAB, len(lens), 3000), what, card)
    hold_programs(api.engine, cc, lens, what, card, chunk=CHUNK)
    api.close()


# the prefix-cache phase (3d): a 512-token prefix shared by a wave of 8
# (suffixes of 5-100 tokens), its resubmission alone (block-aligned: COW)
PREFIX_LEN = 512
PREFIX_SUFFIXES = [5, 64, 17, 100, 33, 9, 48, 80]
PREFIX_NEWS = [12, 16, 10, 14, 16, 12, 10, 16]


def hold_built_once(eng, compiles_before, what, card, full=None,
                    suffix=None, decoded=True):
    """The no-rebuild contract of an engine whose admissions hit the prefix
    cache: one decode program (``decoded``), each whole-prompt and each
    suffix bucket built once -- exactly ``full`` and ``suffix`` where given
    (a preempted request's re-admission may first use a bucket, and builds
    it then, once) -- the copy-on-write program at most once, and one CUDA
    graph per program."""
    graphs = eng.stats()["programs.graphs"]
    moved = decode_compiles() - compiles_before
    print(f"programs {what}: decode_traces {eng.decode_traces} "
          f"(serving.decode_compiles +{moved}), prefill_traces "
          f"{dict(sorted(eng.prefill_traces.items()))}, prefix_prefill_traces"
          f" {dict(sorted(eng.prefix_prefill_traces.items()))}, cow_traces "
          f"{eng.cow_traces}, {graphs} CUDA graphs [{card}]")
    if eng.decode_traces != decoded or moved != decoded:
        raise AssertionError(f"{what}: {eng.decode_traces} decode builds, "
                             f"serving.decode_compiles +{moved}")
    for traces, want in ((eng.prefill_traces, full),
                         (eng.prefix_prefill_traces, suffix)):
        if any(v != 1 for v in traces.values()) or (
                want is not None and set(traces) != set(want)):
            raise AssertionError(f"{what}: builds {traces}, want each of "
                                 f"{sorted(want or traces)} once")
    if eng.cow_traces > 1:
        raise AssertionError(f"{what}: {eng.cow_traces} COW builds")
    if graphs != (decoded + len(eng.prefill_traces)
                  + len(eng.prefix_prefill_traces) + eng.cow_traces):
        raise AssertionError(f"{what}: {graphs} CUDA graphs")


def metric_delta(before, keys):
    from paddle_tpu_torch.serving import metrics

    now = metrics.stats()
    return {k: now.get(k, 0) - before.get(k, 0) for k in keys}


PREFIX_KEYS = ("prefix.hits", "prefix.misses", "prefix.suffix_prefills",
               "prefix.cow_copies", "prefix.evictions",
               "tokens.prefill_avoided", "scheduler.preemptions")


def serve_prefix(pa, model, serving, card):
    """Phase 3d: phase 3's f32 model and engine sizes with the prefix cache
    on (the arena invariants audited at every release). A wave of 8
    requests sharing a 512-token prefix (the first a miss, the 7 after it
    hits attached to its blocks), then the prefix alone resubmitted (a
    fully cached block-aligned prompt: copy-on-write and a one-token suffix
    at 511), then an eviction wave on an arena of 60 blocks, then a
    priority wave on 2 slots with ``serving_starvation_steps=1`` whose
    priority-0 arrival preempts the priority-7 runner, which resumes from
    its journal. Held: tokens equal ``generate()``, one suffix prefill per
    hit, ``tokens.prefill_avoided``, the exact launches of the prefill and
    decode kernels, and the no-rebuild contract. Returns the launches of
    the shared-prefix wave."""
    from paddle_tpu_torch.core import compile_cache, flags
    from paddle_tpu_torch.serving import metrics

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    max_pos = model.cfg.max_position_embeddings
    bucket = lambda n: compile_cache.prefill_bucket(  # noqa: E731
        n, max_pos, flags.flag("serving_prefill_bucket_min"))
    keep = flags.get_flags(["serving_arena_invariants",
                            "serving_starvation_steps"])
    flags.set_flags({"serving_arena_invariants": 1})
    try:
        rng = np.random.default_rng(30)
        cc = decode_compiles()
        api = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=8, prefix_cache=True), device="cuda")
        eng = api.engine
        shared = rng.integers(0, vocab, PREFIX_LEN)
        prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
                   for n in PREFIX_SUFFIXES]
        what = f"f32 prefix cache, {len(prompts)} requests sharing 512"
        m0 = metrics.stats()
        reqs, launches, ran = serve(api, pa, prompts, PREFIX_NEWS, what,
                                    card)
        d = metric_delta(m0, PREFIX_KEYS)
        hits = len(prompts) - 1
        if (ran.prefills, ran.suffix, d["prefix.hits"],
                d["prefix.suffix_prefills"], d["tokens.prefill_avoided"]) \
                != (1, hits, hits, hits, hits * PREFIX_LEN):
            raise AssertionError(f"{what}: {ran.prefills} prefills, "
                                 f"{ran.suffix} suffix prefills, {d}")
        hold_launches(launches, want_launches(layers, ran),
                      f"{what} (24 x (decode steps + warm-ups), 24 x "
                      "(prefills + suffix prefills + warm-ups))")
        hold_to_generate(model, prompts, reqs, PREFIX_NEWS, what, card)
        wave_launches = launches
        what = "f32 prefix cache, the shared 512 resubmitted (COW)"
        m0 = metrics.stats()
        reqs, launches, ran = serve(api, pa, [shared], [12], what, card)
        d = metric_delta(m0, PREFIX_KEYS)
        if (ran.prefills, ran.suffix, d["prefix.cow_copies"],
                d["tokens.prefill_avoided"]) != (0, 1, 1, PREFIX_LEN - 1):
            raise AssertionError(f"{what}: {ran}, {d}")
        hold_launches(launches, want_launches(layers, ran), what)
        hold_to_generate(model, [shared], reqs, [12], what, card)
        hold_built_once(
            eng, cc, "f32 prefix cache", card,
            full={bucket(PREFIX_LEN + PREFIX_SUFFIXES[0])},
            suffix={min(bucket(n), max_pos - PREFIX_LEN)
                    for n in PREFIX_SUFFIXES[1:]} | {bucket(1)})
        print(f"e2e f32 prefix cache: engine stats "
              + json.dumps({k: v for k, v in eng.stats().items()
                            if k.startswith(("prefix.", "arena.blocks"))
                            or k in ("suffix_prefills", "cow_copies")})
              + f" [{card}]")
        api.close()

        # eviction: 60 allocatable blocks, 3 prompts of 300 fill them; the
        # next wave reserves past the free list and evicts LRU leaves
        cc = decode_compiles()
        api = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=4, num_blocks=61, prefix_cache=True), device="cuda")
        a = [rng.integers(0, vocab, 300) for _ in range(5)]
        waves = [a[:3], [a[3], a[4], a[0]],
                 [a[3], np.concatenate([a[2][:256], rng.integers(0, vocab,
                                                                 30)])]]
        m0 = metrics.stats()
        for i, wave in enumerate(waves):
            what = f"f32 prefix cache, eviction wave {i + 1}"
            news = [8] * len(wave)
            reqs, launches, ran = serve(api, pa, wave, news, what, card)
            hold_launches(launches, want_launches(layers, ran), what)
            hold_to_generate(model, wave, reqs, news, what, card)
        d = metric_delta(m0, PREFIX_KEYS)
        print(f"e2e f32 prefix cache eviction: {d} [{card}]")
        if d["prefix.evictions"] <= 0 or d["prefix.hits"] <= 0:
            raise AssertionError(f"eviction waves: {d}")
        hold_built_once(api.engine, cc, "f32 prefix cache eviction", card)
        api.close()

        # priority: 2 slots held by priorities 5 and 7; a priority-0
        # arrival starves 2 steps, then preempts the priority-7 runner
        flags.set_flags({"serving_starvation_steps": 1})
        cc = decode_compiles()
        api = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=2, prefix_cache=True), device="cuda")
        prompts = [rng.integers(0, vocab, n) for n in (300, 200, 100)]
        news = [24, 24, 16]
        kw = [dict(priority=5), dict(priority=7), dict(priority=0)]

        def drive(submit):
            submit(0), submit(1)
            for _ in range(3):
                api._pump_once()
            submit(2)

        what = "f32 priority wave, serving_starvation_steps=1"
        m0 = metrics.stats()
        reqs, launches, ran = serve(api, pa, prompts, news, what, card,
                                    submit_kw=kw, drive=drive)
        d = metric_delta(m0, PREFIX_KEYS)
        print(f"e2e {what}: {d}, preemptions per request "
              f"{[r.preemptions for r in reqs]} [{card}]")
        if d["scheduler.preemptions"] != 1 or [
                r.preemptions for r in reqs] != [0, 1, 0]:
            raise AssertionError(f"{what}: {d}")
        hold_launches(launches, want_launches(layers, ran), what)
        hold_to_generate(model, prompts, reqs, news, what + " (resumed)",
                         card)
        hold_built_once(api.engine, cc, what, card)
        api.close()
    finally:
        flags.set_flags(keep)
    return wave_launches


# phase 3e: recovery on the card. Each wave is 8 requests, greedy (even) and
# seeded sampled (odd, SAMPLED), the first two sharing a 512-token prefix
# (suffixes of 40 and 70 tokens); the first wave captures the buckets the
# second (the faulted one) admits in
RECOVERY_LENS = [40, 70, 37, 100, 140, 300, 200, 64]
RECOVERY_NEWS = [40, 36, 32, 40, 36, 32, 40, 36]
RECOVERY_KEYS = ("supervisor.rebuilds", "supervisor.replays",
                 "engine.rebuilds", "api.recoveries", "prefix.hits",
                 "prefix.misses")


def wait_for(cond, what, timeout=120.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not reached in {timeout} s")
        time.sleep(0.001)


class Recorder:
    """Host-side records of one background API's engine, by wrapping its
    methods: the bucket of every whole-prompt and suffix prefill (the keys
    the engine must hold, each built once), every capture's interval on
    the host clock, every emitted token's time, the program key each
    injected fault hit, and what each rebuild kept (pool addresses,
    reserved bytes, graphs, pool bytes, builds)."""

    def __init__(self, api):
        from paddle_tpu_torch.core import compile_cache, resilience

        eng = self.eng = api.engine
        self.full, self.suffix = set(), set()
        self.captures, self.rebuilds, self.emits = [], [], {}
        max_pos = eng._model.cfg.max_position_embeddings

        def bucket(n):
            return compile_cache.prefill_bucket(n, eng.max_model_len,
                                                eng.prefill_bucket_min)

        full_call, suffix_call = eng._full_prefill_call, eng._suffix_prefill_call

        def full(ctx, clen, res, slot):
            self.full.add(bucket(clen))
            return full_call(ctx, clen, res, slot)

        def suffix(ctx, clen, prefix_len, slot, chunked=False):
            self.suffix.add(min(bucket(clen - prefix_len),
                                max_pos - prefix_len))
            return suffix_call(ctx, clen, prefix_len, slot, chunked)

        eng._full_prefill_call, eng._suffix_prefill_call = full, suffix
        backend = eng._graphs.backend
        capture = backend.capture

        def timed_capture(fn):
            t0 = time.perf_counter()
            try:
                return capture(fn)
            finally:
                self.captures.append((t0, time.perf_counter()))

        backend.capture = timed_capture
        rebuild = eng.rebuild

        def kept():
            return dict(ptrs=[t.data_ptr() for e in eng.arena.pools
                              for t in e],
                        reserved=torch.cuda.memory_reserved(),
                        graphs=eng._graphs.graph_count(),
                        pool_bytes=eng._graphs.pool_bytes,
                        builds=(eng.decode_traces, dict(eng.prefill_traces),
                                dict(eng.prefix_prefill_traces),
                                eng.cow_traces))

        def recorded():
            before, t0 = kept(), time.perf_counter()
            rebuild()
            self.rebuilds.append((t0, before, kept(), program_keys(eng)))

        eng.rebuild = recorded
        emit = api.scheduler._emit

        def emitted(req, token):
            self.emits.setdefault(req.request_id, []).append(
                time.perf_counter())
            return emit(req, token)

        api.scheduler._emit = emitted
        self.faults = []
        run = eng._run

        def probed(prog, *args, **values):
            try:
                return run(prog, *args, **values)
            except (resilience.ServingDeviceError,
                    resilience.ArenaCorruptError) as e:
                self.faults.append((prog.key, type(e).__name__))
                raise

        eng._run = probed


def program_keys(eng):
    """The engine's prefill program keys: ("prefill" | "suffix", bucket)."""
    return ({("prefill", b) for b in eng.prefill_traces}
            | {("suffix", b) for b in eng.prefix_prefill_traces})


def recovery_wave(vocab, rng, seed):
    from paddle_tpu_torch.serving import SamplingParams
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    shared = rng.integers(0, vocab, PREFIX_LEN)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               for n in RECOVERY_LENS[:2]]
    prompts += [rng.integers(0, vocab, n) for n in RECOVERY_LENS[2:]]
    kw = [{} if i % 2 == 0 else
          {"sampling": SamplingParams(**SAMPLED, seed=seed + i)}
          for i in range(len(prompts))]
    return prompts, kw


def greedy_refs(model, prompts, news, kw):
    return {i: model.generate(p[None], max_new_tokens=n)[0, len(p):]
            .cpu().numpy()
            for i, (p, n, k) in enumerate(zip(prompts, news, kw))
            if "sampling" not in k}


def serve_recovery(pa, so, model, serving, card):
    """Phase 3e: recovery and the front door at full width (phase 3's f32
    ``gpt_1p3b``). Returns the faulted wave's launches."""
    from paddle_tpu_torch.core import flags, resilience

    keep = flags.get_flags(["fault_injection", "serving_telemetry",
                            "serving_arena_invariants"])
    flags.set_flags({"fault_injection": 1, "serving_telemetry": 1,
                     "serving_arena_invariants": 1})
    try:
        launches = recovery_under_load(pa, so, model, serving, card)
        torch.cuda.empty_cache()
        front_door(model, serving, card)
    finally:
        flags.set_flags(keep)
        resilience.clear_faults()
    torch.cuda.empty_cache()
    return launches


def recovery_under_load(pa, so, model, serving, card):
    """Phase 3e, first: a background ``ServingAPI`` with the prefix cache.
    Wave 1 is served while the main thread computes the greedy references
    of both waves (its CUDA work overlaps the pump thread's captures, which
    run in ``thread_local`` mode). Wave 2: once all 8 are RUNNING a
    ``serving_device`` fault (the next decode step), then, with a slot free,
    an ``arena_corrupt`` fault on a 9th request's admission. Held: every
    output against ``generate()`` / ``generate(sampling=)``, the rebuild and
    replay counts, each rebuild keeping pool addresses, reserved bytes,
    graphs, pool bytes and builds, every program built once with its keys
    exactly the buckets admitted (replays included), the launches exact,
    each request's spans, and a clean arena after ``drain(grace=5)``."""
    from paddle_tpu_torch.core import compile_cache, resilience
    from paddle_tpu_torch.serving import RequestState, metrics, telemetry

    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, prefix_cache=True), device="cuda", background=True)
    eng = api.engine
    rec = Recorder(api)
    rng = np.random.default_rng(31)
    news = RECOVERY_NEWS
    prompts1, kw1 = recovery_wave(vocab, rng, 5000)
    prompts2, kw2 = recovery_wave(vocab, rng, 6000)
    what = "f32 recovery, wave 1 (background pump)"
    reqs1 = [api.submit(p, max_new_tokens=n, **k)
             for p, n, k in zip(prompts1, news, kw1)]
    t0 = time.perf_counter()
    refs1 = greedy_refs(model, prompts1, news, kw1)
    refs2 = greedy_refs(model, prompts2, news, kw2)
    t1 = time.perf_counter()
    for r in reqs1:
        api.result(r, timeout=120)
    overlap = [c for c in rec.captures if c[0] < t1 and c[1] > t0]
    print(f"e2e {what}: {len(rec.captures)} captures in the pump thread, "
          f"{len(overlap)} of them while the main thread ran generate() "
          f"({t1 - t0:.2f} s of references) [{card}]")
    if not overlap:
        raise AssertionError(f"{what}: no capture overlapped the main "
                             "thread's CUDA work")
    hold_served_tokens(api, model, prompts1, reqs1, news, kw1, what, card,
                       greedy_refs=refs1)

    what = "f32 recovery, wave 2 (two faults)"
    sup = api.supervisor
    telemetry.reset_tracelog()
    m0, before = metrics.stats(), ran_counts(eng)
    pa.reset_launches()
    so.reset_launches()
    reqs2 = [api.submit(p, max_new_tokens=n, **k)
             for p, n, k in zip(prompts2, news, kw2)]
    wait_for(lambda: all(r.state == RequestState.RUNNING and r.tokens
                         for r in reqs2), what + ", all 8 running")
    with api.paused():  # no step runs while the fault is armed
        live1 = list(api.scheduler.running)
        journal = {r.request_id: len(r.tokens) for r in live1}
        resilience.inject_fault("serving_device", times=1)
    # once a request finished after the recovery, a 9th request meets the
    # arena_corrupt fault at its admission (the step's first program run)
    late_prompt, late, t0 = rng.integers(0, vocab, 90), None, time.time()
    while late is None:
        if time.time() - t0 > 120:
            raise AssertionError(f"{what}: no slot came free")
        with api.paused():
            if sup.rebuild_count == 1 and eng.free_slots() > 0:
                late = api.submit(late_prompt, max_new_tokens=24)
                live2 = list(api.scheduler.running)
                resilience.inject_fault("arena_corrupt", times=1)
        time.sleep(0.001)
    for r in reqs2 + [late]:
        api.result(r, timeout=120)
    torch.cuda.synchronize()
    launches = dict(pa.launches) | dict(so.launches)
    ran = types.SimpleNamespace(**dict(zip(
        ("steps", "prefills", "chunks", "suffix", "decode_builds",
         "prefill_builds", "chunk_builds"),
        (a - b for a, b in zip(ran_counts(eng), before)))))
    d = metric_delta(m0, RECOVERY_KEYS)
    print(f"e2e {what}: {d}; journals at the first fault {journal}; "
          f"{len(live2)} live at the second; launches {launches}; ran "
          f"{vars(ran)} [{card}]")
    want = {"supervisor.rebuilds": 2, "engine.rebuilds": 2,
            "api.recoveries": 2, "supervisor.replays": 8 + len(live2)}
    late_key = ("prefill", compile_cache.prefill_bucket(
        len(late_prompt), eng.max_model_len, eng.prefill_bucket_min))
    print(f"e2e {what}: the faults hit {rec.faults} [{card}]")
    if (len(live1) != 8 or {k: d[k] for k in want} != want
            or sup.rebuild_count != 2
            or rec.faults != [("decode", "ServingDeviceError"),
                              (late_key, "ArenaCorruptError")]):
        raise AssertionError(f"{what}: {len(live1)} live at the first "
                             f"fault, counts {d}, want {want}, faults "
                             f"{rec.faults}")
    hold_launches(launches, want_launches(layers, ran),
                  f"{what} (24 x (decode steps + warm-ups), 24 x (prefills "
                  "+ replay prefills + suffix prefills + warm-ups))")
    for t_fault, kept_before, kept_after, keys in rec.rebuilds:
        same = {k: kept_before[k] == kept_after[k] for k in kept_before}
        print(f"e2e {what}: rebuild kept pool addresses, reserved "
              f"{kept_after['reserved']} bytes, {kept_after['graphs']} "
              f"graphs, pool {kept_after['pool_bytes']} bytes, builds "
              f"{kept_after['builds']}: {same} [{card}]")
        if not all(same.values()):
            raise AssertionError(f"{what}: the rebuild changed {same}")
    print(f"programs {what}: prefill keys built after the first fault "
          f"{sorted(program_keys(eng) - rec.rebuilds[0][3])} (buckets of "
          f"the replays and of the 9th request) [{card}]")
    hold_built_once(eng, cc, what, card, full=rec.full, suffix=rec.suffix)
    # outage: the fault to the next token of every stream
    t_fault = rec.rebuilds[0][0]
    outage = max(min(t for t in rec.emits[r.request_id] if t > t_fault)
                 for r in live1) - t_fault
    print(f"e2e {what}: outage from the first rebuild to the next token "
          f"of all 8 streams {outage * 1e3:.1f} ms (f32, host clock) "
          f"[{card}]")
    # spans: one trace per request, SUBMITTED ... REPLAYED ... FINISHED
    for r in reqs2 + [late]:
        evs = telemetry.trace(r.trace_id)
        kinds = [e["event"] for e in evs]
        replays = (r in live1) + (r in live2)
        ok = (kinds[:2] == [telemetry.SUBMITTED, telemetry.QUEUED]
              and kinds.count(telemetry.SUBMITTED) == 1
              and kinds.count(telemetry.REPLAYED) == replays
              and kinds.count(telemetry.FIRST_TOKEN) == 1
              and kinds[-1] == telemetry.FINISHED
              and {e["trace_id"] for e in evs} == {r.trace_id})
        if not ok:
            raise AssertionError(f"{what}: {r.request_id} spans {kinds}")
    print(f"e2e {what}: spans of the 9 requests well formed, e.g. "
          f"{[e['event'] for e in telemetry.trace(reqs2[0].trace_id)]} "
          f"[{card}]")
    hold_served_tokens(api, model, prompts2, reqs2, news, kw2, what, card,
                       greedy_refs=refs2)
    hold_to_generate(model, [late_prompt], [late], [24],
                     what + ", the admission that failed", card)
    api.drain(grace=5)
    eng.check_invariants()
    a = eng.arena.stats()
    if (a["blocks_reserved"], a["blocks_in_use"] - a["blocks_cached"],
            eng.active_slots()) != (0, 0, 0):
        raise AssertionError(f"{what}: arena after drain {a}")
    api.close()
    return launches


def front_door(model, serving, card):
    """Phase 3e, then: the crash-loop breaker (``serving_device`` armed
    ``max_rebuilds + 1`` times: 3 rebuilds, then every request fails with
    ``CrashLoopError`` and nothing leaks; a fresh request equals
    ``generate()``); ``cancel`` mid-decode, ``result``, ``outstanding`` and
    ``drain(grace=0)``; a bound ``PreemptionGuard`` (the ``preempt``
    fault) drained by the background pump; ``EnginePredictor.run`` on 8
    prompts equal to ``generate(stop_token_id=)`` row for row."""
    import logging

    from paddle_tpu_torch.core import resilience
    from paddle_tpu_torch.serving import (CrashLoopError, EnginePredictor,
                                          PreemptionGuard, RequestState)

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(32)
    what = "f32 crash-loop breaker"
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    eng, sup = api.engine, api.supervisor
    reqs = [api.submit(rng.integers(0, vocab, n), max_new_tokens=16)
            for n in (20, 40, 60)]
    for _ in range(2):
        api._pump_once()
    resilience.inject_fault("serving_device", times=sup.max_rebuilds + 1)
    try:
        api.run_until_idle()
        raise AssertionError(f"{what}: no CrashLoopError")
    except CrashLoopError:
        pass
    a = eng.arena.stats()
    print(f"e2e {what}: {sup.rebuild_count} rebuilds, then "
          f"{[type(r.error).__name__ for r in reqs]} (caused by "
          f"{type(reqs[0].error.__cause__).__name__}); arena in use "
          f"{a['blocks_in_use']}, reserved {a['blocks_reserved']} [{card}]")
    if (sup.rebuild_count != sup.max_rebuilds or not sup.breaker_open
            or any(not isinstance(r.error, CrashLoopError) for r in reqs)
            or (a["blocks_in_use"], a["blocks_reserved"],
                eng.active_slots()) != (0, 0, 0)):
        raise AssertionError(f"{what}: {sup.rebuild_count} rebuilds, {a}")
    eng.check_invariants()
    fresh = rng.integers(0, vocab, 50)
    r = api.submit(fresh, max_new_tokens=16)
    out = api.result(r)
    hold_to_generate(model, [fresh], [r], [16], what + ", then fresh", card)
    if not np.array_equal(out, r.output_ids()):
        raise AssertionError(f"{what}: result() is not prompt + tokens")

    what = "f32 front door"
    long = api.submit(rng.integers(0, vocab, 30), max_new_tokens=64)
    for _ in range(3):
        api._pump_once()
    api.cancel(long)
    a = eng.arena.stats()
    if (long.state != RequestState.CANCELLED or eng.active_slots()
            or a["blocks_in_use"] or a["blocks_reserved"]):
        raise AssertionError(f"{what}: cancel left {long.state}, {a}")
    waiting = [api.submit(rng.integers(0, vocab, 30), max_new_tokens=64)
               for _ in range(3)]
    counted = [api.outstanding()]
    api._pump_once()
    counted.append(api.outstanding())
    api.drain(grace=0)
    counted.append(api.outstanding())
    a = eng.arena.stats()
    print(f"e2e {what}: cancel mid-decode freed its slot and blocks; "
          f"outstanding {counted} (queued, running, drained); drain(grace=0) "
          f"failed {[type(w.error).__name__ for w in waiting]} [{card}]")
    if (counted != [3, 3, 0] or a["blocks_in_use"] or any(
            not isinstance(w.error, resilience.RequestDrainedError)
            for w in waiting)):
        raise AssertionError(f"{what}: {counted}, {a}")
    api.close()

    what = "f32 preemption guard, background pump"
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda", background=True)
    guard = PreemptionGuard(install=False)
    api.bind_preemption_guard(guard, grace=0.0)
    r = api.submit(rng.integers(0, vocab, 30), max_new_tokens=200)
    wait_for(lambda: len(r.tokens) >= 2, what)
    resilience.inject_fault("preempt", times=1)
    if not r.done_event.wait(60):
        raise AssertionError(f"{what}: no drain")
    print(f"e2e {what}: {r.state} after {len(r.tokens)} tokens, "
          f"{type(r.error).__name__}: {r.error} [{card}]")
    if not (isinstance(r.error, resilience.RequestDrainedError)
            and "preemption requested" in str(r.error)
            and api.drain_count == 1):
        raise AssertionError(f"{what}: {r.state} {r.error!r}")
    api.close()

    what = "f32 EnginePredictor"
    ids = rng.integers(0, vocab, (8, 48)).astype(np.int32)
    first = model.generate(ids[:1].astype(np.int64), max_new_tokens=16)
    stop = int(first[0, 48 + 5])  # row 0 stops at its 6th token
    pred = EnginePredictor(model, max_new_tokens=16, stop_token_id=stop,
                           config=serving.ServingConfig(num_slots=8),
                           device="cuda")
    (out,) = pred.run([ids])
    logs = []
    handler = logging.Handler()
    handler.emit = lambda record: logs.append(record.getMessage())
    logger = logging.getLogger("paddle_tpu_torch.serving")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        pred.close()
    finally:
        logger.removeHandler(handler)
    for i in range(8):
        ref = model.generate(ids[i:i + 1].astype(np.int64),
                             max_new_tokens=16, stop_token_id=stop)
        if not np.array_equal(out[i], ref[0].cpu().numpy()):
            raise AssertionError(f"{what}: row {i} {out[i, 48:]} vs "
                                 f"{ref[0, 48:].cpu().numpy()}")
    print(f"e2e {what}: 8 rows of [8, 48] + 16 equal generate("
          f"stop_token_id={stop}) row for row; {logs[-1]} [{card}]")


def recovery_times(model, serving, card):
    """Phase 3e's times, bf16, on phase 6's engine shape (8 slots, prompts
    of 512, 64 new tokens): ``rebuild()`` alone beside its bound (the
    arena's bytes written once), the TTFT and inter-token p50/p99 of a
    clean wave from ``engine.hists``, the host decode-step median with
    ``FLAGS_serving_telemetry`` 0, 1, 1, 0, and the outage of a
    ``serving_device`` fault after 4 steps -- the fault to the next token
    of all 8 streams -- first with the replays' bucket (768) captured
    during the recovery, then captured already."""
    from paddle_tpu_torch.core import flags, resilience
    from paddle_tpu_torch.serving import RequestState

    keep = flags.get_flags(["fault_injection", "serving_telemetry"])
    flags.set_flags({"fault_injection": 1, "serving_telemetry": 0})
    vocab, slots, plen, new = model.cfg.vocab_size, 8, 512, 64
    rng = np.random.default_rng(41)
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=slots),
                             device="cuda")
    eng, sched = api.engine, api.scheduler
    out = {}

    def wave():
        return [api.submit(rng.integers(0, vocab, plen), max_new_tokens=new)
                for _ in range(slots)]

    def finish(reqs, what):
        api.run_until_idle()
        for r in reqs:
            if r.state != RequestState.FINISHED or len(r.tokens) != new:
                raise AssertionError(f"{what}: {r.request_id} {r.state} "
                                     f"{len(r.tokens)} {r.error!r}")

    try:
        finish(wave(), "bf16 recovery warm-up")
        # rebuild() alone, the engine idle
        ptrs = [t.data_ptr() for e in eng.arena.pools for t in e]
        kept = (torch.cuda.memory_reserved(), eng._graphs.graph_count(),
                eng._graphs.pool_bytes, builds(eng))
        host, dev = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            eng.rebuild()
            b.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(a.elapsed_time(b))
        kv_bytes = eng.stats()["arena.kv_bytes"]
        bound_ms = kv_bytes / HBM_BYTES_PER_S * 1e3
        now = (torch.cuda.memory_reserved(), eng._graphs.graph_count(),
               eng._graphs.pool_bytes, builds(eng))
        out["rebuild_ms"] = float(np.median(host[1:]))
        out["rebuild_device_ms"] = float(np.median(dev[1:]))
        out["rebuild_bound_ms"] = bound_ms
        print(f"bf16 recovery: rebuild() alone {out['rebuild_ms']:.3f} ms "
              f"host clock, {out['rebuild_device_ms']:.3f} ms between "
              f"events (median of 5, {min(host[1:]):.3f}-"
              f"{max(host[1:]):.3f}), bound {bound_ms:.3f} ms "
              f"({kv_bytes} arena bytes over 3.35 TB/s); kept pool "
              f"addresses, reserved, graphs, pool bytes, builds: "
              f"{ptrs == [t.data_ptr() for e in eng.arena.pools for t in e]}"
              f", {kept == now} {now} [{card}]")
        if ptrs != [t.data_ptr() for e in eng.arena.pools
                    for t in e] or kept != now:
            raise AssertionError(f"bf16 rebuild changed {kept} -> {now}")
        # a clean wave's latency percentiles
        eng.hists.clear()
        finish(wave(), "bf16 recovery clean wave")
        ttft = eng.hists.peek("latency.ttft")
        gap = eng.hists.peek("latency.inter_token")
        out.update(ttft_p50_ms=ttft.percentile(50) * 1e3,
                   ttft_p99_ms=ttft.percentile(99) * 1e3,
                   inter_token_p50_ms=gap.percentile(50) * 1e3,
                   inter_token_p99_ms=gap.percentile(99) * 1e3)
        print(f"bf16 recovery: a clean wave of 8 x (512 + 64) from "
              f"engine.hists: TTFT p50 {out['ttft_p50_ms']:.2f} / p99 "
              f"{out['ttft_p99_ms']:.2f} ms ({ttft.n} samples), "
              f"inter-token p50 {out['inter_token_p50_ms']:.3f} / p99 "
              f"{out['inter_token_p99_ms']:.3f} ms ({gap.n}) [{card}]")
        # the host decode step with span collection off and on
        steps = {}
        for on in (0, 1, 1, 0):
            flags.set_flags({"serving_telemetry": on})
            reqs, times = wave(), []
            while sched.has_work():
                full = not sched.waiting and eng.active_slots() == slots
                t0 = time.perf_counter()
                sched.step()
                if full:
                    times.append(time.perf_counter() - t0)
            finish(reqs, "bf16 telemetry wave")
            steps.setdefault(on, []).append(float(np.median(times)) * 1e3)
        flags.set_flags({"serving_telemetry": 0})
        out["telemetry_step_ms"] = steps
        print(f"bf16 recovery: median host decode step, telemetry off "
              f"{steps[0]} / on {steps[1]} ms (order off, on, on, off) "
              f"[{card}]")
        # the outage of a fault after 4 steps: the next pump recovers, and
        # every stream's next token is its replayed one
        lens = [plen]
        for what in ("replay bucket captured in the recovery",
                     "replay bucket captured already"):
            reqs = wave()
            for _ in range(4):
                api._pump_once()
            journal = {len(r.tokens) for r in reqs}
            lens += [plen + j for j in journal]
            keys = set(eng.prefill_traces)
            resilience.inject_fault("serving_device", times=1)
            n0 = [len(r.tokens) for r in reqs]
            t0 = time.perf_counter()
            api._pump_once()
            outage = (time.perf_counter() - t0) * 1e3
            if [len(r.tokens) for r in reqs] != [n + 1 for n in n0]:
                raise AssertionError(f"bf16 outage: {n0} -> "
                                     f"{[len(r.tokens) for r in reqs]}")
            finish(reqs, "bf16 outage wave")
            out.setdefault("outage_ms", {})[what] = outage
            print(f"bf16 recovery: outage {outage:.1f} ms from the fault "
                  f"to the next token of all 8 streams (rebuild + 8 replay "
                  f"prefills of 512 + {sorted(journal)} tokens), {what}; "
                  f"new prefill keys {sorted(set(eng.prefill_traces) - keys)}"
                  f" [{card}]")
        hold_programs(eng, cc, lens, "bf16 recovery", card)
    finally:
        flags.set_flags(keep)
        resilience.clear_faults()
        api.close()
    return out


def bf16_prefix(model, pa, serving, card):
    """Phase 6, the prefix cache in bf16, unquantized and with ``quant_kv``:
    on 8 slots, one admission of a 512-token prefix plus a 64-token suffix
    is kept (its blocks are shared by the next hit), then 5 misses (other
    prefixes) and, after the first hit, 5 hits at prefix 512: the host-clock
    time from ``admit()`` to the first token on the host, median of 5, on
    captured buckets. Every layer's prefill kernel output of the first hit
    (a table whose 32 first blocks are another slot's) and of a COW
    recompute (one query at 511) is held against its plain version on the
    engine's pools (``Shadow``). The COW copy is timed beside its bound (the
    block's bytes read and written once). Then 4 hits are served 16 tokens
    and their agreement with the cache off is printed, not held."""
    from paddle_tpu_torch.core import compile_cache, flags
    from paddle_tpu_torch.serving import engine as engine_mod

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    bucket = lambda n: compile_cache.prefill_bucket(  # noqa: E731
        n, model.cfg.max_position_embeddings,
        flags.flag("serving_prefill_bucket_min"))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for quant_kv in (False, True):
        what = "bf16 prefix cache" + (" int8 KV" if quant_kv else "")
        rng = np.random.default_rng(31)
        cc = decode_compiles()
        api = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=8, prefix_cache=True, quant_kv=quant_kv), device="cuda")
        eng = api.engine
        prefixes = [rng.integers(0, vocab, PREFIX_LEN) for _ in range(6)]

        def ctx(i):
            return np.concatenate([prefixes[i], rng.integers(0, vocab, 64)])

        def first_token_ms(prompt):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, _ = eng.admit(prompt, 8)  # the first token to the host
            ms = (time.perf_counter() - t0) * 1e3
            return slot, ms

        holder, _ = first_token_ms(ctx(0))  # builds the 576 bucket
        miss = []
        for i in range(1, 6):
            slot, ms = first_token_ms(ctx(i))
            miss.append(ms)
            eng.retire(slot)
        with Shadow(engine_mod, pa, layers,
                    {"paged_prefill_attention": 0}) as shadow:
            slot, hit_capture = first_token_ms(ctx(0))  # builds the 64 bucket
            eng.retire(slot)
        shadow.report(f"{what}: a hit at prefix 512 over shared blocks",
                      card)
        hit = []
        for i in range(1, 6):
            slot, ms = first_token_ms(ctx(i))
            hit.append(ms)
            eng.retire(slot)
        if eng.suffix_prefills != 6 or eng.prefills != 6:
            raise AssertionError(f"{what}: {eng.prefills} prefills, "
                                 f"{eng.suffix_prefills} suffix prefills")
        with Shadow(engine_mod, pa, layers,
                    {"paged_prefill_attention": 0}) as shadow:
            slot, _ = eng.admit(prefixes[0], 8)  # COW: one query at 511
            eng.retire(slot)
        shadow.report(f"{what}: the COW recompute at prefix 511", card)
        if eng.cow_copies != 1:
            raise AssertionError(f"{what}: {eng.cow_copies} COW copies")
        eng.retire(holder)
        prog = eng._graphs.programs["cow"]
        src = next(iter(eng.prefix_cache._nodes.values())).block
        dst = eng.arena._free[-1]  # a free block: its contents are unread
        cow_ms = time_ms(lambda: (prog.run(src=src, dst=dst), prog.read()),
                         flush)
        nbytes = 2 * sum(t[0].numel() * t.element_size()
                         for entry in eng.arena.pools for t in entry)
        cow_bound = nbytes / HBM_BYTES_PER_S * 1e3
        r = dict(miss_ms=float(np.median(miss)),
                 hit_ms=float(np.median(hit)), hit_capture_ms=hit_capture,
                 cow_ms=cow_ms, cow_bound_ms=cow_bound,
                 cow_bytes=nbytes // 2)
        print(f"{what}: admission to first token of a 512 + 64 prompt, "
              f"median of 5 on captured buckets: miss {r['miss_ms']:.3f} ms "
              f"({min(miss):.3f}-{max(miss):.3f}), hit {r['hit_ms']:.3f} ms "
              f"({min(hit):.3f}-{max(hit):.3f}; {hit_capture:.3f} at the "
              f"bucket's capture); COW copy {cow_ms:.4f} ms, bound "
              f"{cow_bound:.4f} ms ({nbytes // 2} bytes read and written) "
              f"[{card}]")
        # agreement with the cache off: 4 hits against whole prefills
        prompts = [ctx(i) for i in range(1, 5)]
        news = [16] * 4
        reqs = [api.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]
        api.run_until_idle()
        hold_built_once(eng, cc, what, card,
                        full={bucket(PREFIX_LEN + 64)},
                        suffix={bucket(64), bucket(1)})
        api.close()
        off = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=8, quant_kv=quant_kv), device="cuda")
        ref = [off.submit(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
        off.run_until_idle()
        off.close()
        same = sum(int(a == b) for x, y in zip(reqs, ref)
                   for a, b in zip(x.tokens, y.tokens))
        r["agree_with_cache_off"] = same / sum(news)
        print(f"{what}: tokens of 4 hits equal to the cache off: {same} of "
              f"{sum(news)} (printed, not held: bf16) [{card}]")
        out[what] = r
    return out


class Shadow:
    """Wraps some of the engine's paged wrappers (in ``serving.engine``, for
    this script only) and the step programs' ``run``: ``pick`` maps a
    wrapper's name to the index of the run of a program that attends
    through it (one decode step, prefill or chunk; 0 is the first) whose
    every layer's kernel output is held against the plain version on the
    same inputs -- the engine's own pools, tables and positions -- at the
    kernel checks' bar (TOL, row bound included).

    Under the engine's CUDA graphs a wrapper's Python runs only when its
    program is warmed up and captured. The shadow keeps the ``(q, args,
    out)`` of every call made while a program captures (holding them also
    keeps their memory from reuse inside the graph), and after the picked
    run's replay computes the plain versions on those tensors: that
    replay's inputs and outputs, and the pools, which after the step equal
    the pools at each layer's attention (each layer scatters into its own
    entry before it attends). So it must be installed before the engine
    captures the programs it watches. The plain versions launch no kernel
    and run outside any capture, so the launch counts stay exact."""

    def __init__(self, engine_mod, pa, layers, pick):
        from paddle_tpu_torch.serving import graphs

        self.engine_mod, self.graphs, self.pa = engine_mod, graphs, pa
        self.pick = dict(pick)
        self.layers = layers
        self.calls = dict.fromkeys(self.pick, 0)
        self.seen = {name: [] for name in self.pick}  # readings()
        self.records = {}  # program -> {wrapper: [(q, args, out)]}
        self.recording = None
        self._run = self.graphs.StepProgram.run

    def _wrap(self, name):
        fn = getattr(self.pa, name)

        def shadowed(q, *args):
            out = fn(q, *args)
            if self.recording is not None \
                    and torch.cuda.is_current_stream_capturing():
                self.recording.setdefault(name, []).append((q, args, out))
            return out
        return shadowed

    def _shadowed_run(self):
        run, shadow = self._run, self

        def shadowed_run(prog, **values):
            if not prog.built:
                shadow.recording = shadow.records.setdefault(prog, {})
            try:
                outs = run(prog, **values)
            finally:
                shadow.recording = None
            for name, rec in shadow.records.get(prog, {}).items():
                if len(rec) != shadow.layers:
                    raise AssertionError(f"shadow {name}: {len(rec)} calls "
                                         f"captured, not {shadow.layers}")
                call = shadow.calls[name]
                shadow.calls[name] += 1
                if call == shadow.pick[name]:
                    shadow.hold(name, rec)
            return outs
        return shadowed_run

    def hold(self, name, rec):
        ref = getattr(self.pa, name + "_ref")
        for q, args, out in rec:
            expect = ref(q, *args)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise AssertionError(f"shadow {name}: non-finite output")
            self.seen[name].append(readings(out, expect, TOL[q.dtype]))

    def __enter__(self):
        for name in self.pick:
            setattr(self.engine_mod, name, self._wrap(name))
        self.graphs.StepProgram.run = self._shadowed_run()
        return self

    def __exit__(self, *exc):
        for name in self.pick:
            setattr(self.engine_mod, name, getattr(self.pa, name))
        self.graphs.StepProgram.run = self._run
        self.records.clear()

    def report(self, what, card):
        for name, seen in self.seen.items():
            if len(seen) != self.layers:
                raise AssertionError(f"shadow {name}: {len(seen)} layers "
                                     f"checked, not {self.layers}")
            worst = max(seen, key=lambda r: r[1])
            rows = [r[2] for r in seen if r[2] is not None]
            ok = all(r[3] for r in seen)
            note = (f"max_abs_err={max(r[0] for r in seen):.3e} "
                    f"({worst[1]:.3f} of the element bar)")
            if rows:
                note += f", worst row {max(rows):.3e}"
            print(f"shadow {what} {name} (run {self.pick[name] + 1} of its "
                  f"programs, a graph replay, all {self.layers} layers, the "
                  f"engine's own pools): {note} {'ok' if ok else 'FAIL'} "
                  f"[{card}]")
            if not ok:
                raise AssertionError(f"shadow {name}: the kernel disagrees "
                                     "with its plain version on the engine's "
                                     "pools")


def hold_device_quantization(model, arrays, card):
    """The engine quantized the weights on the card: the first and last
    layers' int8 payloads and float32 scales must equal ``quantize_weight``
    of the same arrays on the CPU, bit for bit; so must the two devices'
    quantizations of the same weights cast to bf16."""
    from paddle_tpu_torch.quantization import quantize_weight

    n = 0
    for i in (0, model.cfg.num_layers - 1):
        for lin in ("attn.qkv", "attn.proj", "mlp.up", "mlp.down"):
            name = f"gpt.layers.{i}.{lin}"
            w = torch.from_numpy(arrays[f"{name}.weight"])
            layer = model.get_submodule(name)
            got = [(layer.weight, layer.weight_scale)]
            want = [quantize_weight(w, channel_axis=1)]
            if n == 0:  # one bf16 weight, quantized on each device
                got.append(quantize_weight(w.to("cuda", torch.bfloat16), 1))
                want.append(quantize_weight(w.to(torch.bfloat16), 1))
            for (q, s), (q_ref, s_ref) in zip(got, want):
                bad_q = int((q.cpu() != q_ref).sum())
                bad_s = int((s.cpu() != s_ref).sum())
                if bad_q or bad_s:
                    raise AssertionError(
                        f"{name}: quantized on the card, {bad_q} of "
                        f"{q.numel()} int8 weights and {bad_s} of "
                        f"{s.numel()} scales differ from the CPU's")
                n += 1
    print(f"e2e f32 weight-only: {n} int8 payloads and scales quantized on "
          f"the card equal the CPU's bit for bit (f32 and bf16) [{card}]")


def serve_quantized(pa, gpt, serving, arrays, card):
    """Phases 4-5: a second f32 gpt_1p3b from the same weights, quantized
    by the engine. Phase 4, weight-only: the card's quantization equals the
    CPU's; tokens equal generate() of the same quantized model, through the
    full-precision kernels. Phase 5, int8
    weights + int8 KV arena + chunked prefill (chunks of 256): exact launch
    counts (int8 decode 24 per decode step, int8 prefill 24 per chunk,
    full-precision prefill 24 per whole-prompt prefill) and the shadow
    checks; the per-token agreement with phase 4 is printed. Returns phase
    5's launches."""
    from paddle_tpu_torch.serving import engine as engine_mod

    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    layers = model.cfg.num_layers
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in QLENS]

    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, quant_weights=True), device="cuda")
    print(f"e2e f32 weight-only: {api.engine.stats()['quant.weight_layers']} "
          f"int8 linears [{card}]")
    hold_device_quantization(model, arrays, card)
    reqs, launches, ran = serve(api, pa, prompts, QNEWS, "f32 weight-only",
                                card)
    hold_launches(launches, want_launches(layers, ran), "f32 weight-only")
    hold_to_generate(model, prompts, reqs, QNEWS, "f32 weight-only", card)
    hold_programs(api.engine, cc, QLENS, "f32 weight-only", card)
    tokens_w = [r.tokens for r in reqs]
    api.close()
    del api, reqs

    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, quant_weights=True, quant_kv=True,
        chunked_prefill=CHUNK), device="cuda")
    what = f"f32 int8 weights + int8 KV + chunks of {CHUNK}"
    pick = {"paged_decode_attention": 9, "paged_prefill_attention": 1}
    with Shadow(engine_mod, pa, layers, pick) as shadow:
        reqs, launches, ran = serve(api, pa, prompts, QNEWS, what, card)
    want_chunks = sum(-(-n // CHUNK) for n in QLENS if n > CHUNK)
    if ran.chunks != want_chunks or ran.prefills != len(QLENS) - sum(
            n > CHUNK for n in QLENS):
        raise AssertionError(f"{ran.prefills} prefills and {ran.chunks} "
                             f"chunks for prompts {QLENS}")
    hold_launches(launches, want_launches(
        layers, ran, decode="paged_decode_attention_int8",
        chunk="paged_prefill_attention_int8"),
        f"{what} (24 x (decode steps + warm-ups), 24 x (chunks + warm-ups),"
        " 24 x (prefills + warm-ups))")
    shadow.report(what, card)
    hold_programs(api.engine, cc, QLENS, what, card, chunk=CHUNK)
    api.close()
    same = [np.mean(np.asarray(a) == np.asarray(r.tokens))
            for a, r in zip(tokens_w, reqs)]
    print(f"e2e {what}: per-token agreement with the weight-only tokens "
          f"{np.mean(same):.4f} (by request: "
          f"{', '.join(f'{x:.2f}' for x in same)}; printed, not held) "
          f"[{card}]")
    return launches


def serve_d256(pa, gpt, serving, card):
    """Phase 11: gpt_1p3b cut to 8 heads of 256 and 2 layers (full width
    2048), seeded f32 weights, served on 8 slots through the head_dim 256
    kernels: greedy tokens equal generate(), the decode kernel launched 2
    x decode steps and the prefill kernel 2 x prefills."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_heads=8, num_layers=2)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    gpt.load_functional_state(model, seeded(gpt, model, "d256", 3))
    layers = model.cfg.num_layers
    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda")
    rng = np.random.default_rng(12)
    lens = [5, 300, 37, 129, 16, 700, 64, 250, 9, 48]
    news = [16, 24, 20, 32, 12, 16, 28, 18, 30, 22]
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]
    what = "f32 head_dim 256 (8 heads, 2 layers)"
    reqs, launches, ran = serve(api, pa, prompts, news, what, card)
    hold_launches(launches, want_launches(layers, ran),
                  f"{what} (2 x (decode steps + warm-ups), 2 x (prefills + "
                  "warm-ups))")
    hold_to_generate(model, prompts, reqs, news, what, card)
    hold_programs(api.engine, cc, lens, what, card)
    api.close()


def flash_inputs(rng, b, sq, sk, h, d, dtype):
    """q, k, v, dO ``[b, s, h, d]``; at sq == sk q, k, v are the strided
    views of one ``[b, s, 3, h, d]`` projection, as the model hands them
    over."""
    if sq == sk:
        q, k, v = randn(rng, (b, sq, 3, h, d), dtype).unbind(2)
    else:
        q = randn(rng, (b, sq, h, d), dtype)
        k, v = randn(rng, (b, sk, 2, h, d), dtype).unbind(2)
    return q, k, v, randn(rng, (b, sq, h, d), dtype)


# phase 7's edge checks of the tensor-core backward tiles (dK/dV: 128 keys
# x 64-row query tiles; dQ: 128 rows x 64-key tiles): ragged tiles of 192,
# causal offsets of +256 and -256 (rows with no key), then lengths that are
# no multiple of a tile (5, 77, 100, 300, 1000); a generator of their own
# keeps the older checks' inputs
FLASH_SHAPES = [(2, 2048, 2048, H, D, False), (2, 2048, 2048, H, D, True),
                (2, 256, 256, 4, 64, True), (2, 256, 256, 4, 256, True),
                (2, 256, 256, 4, 256, False), (2, 256, 128, 4, D, True)]
FLASH_EDGES = [(2, 192, 192, 4, D, True), (2, 192, 192, 4, D, False),
               (2, 64, 320, 4, D, True), (2, 320, 64, 4, D, True),
               (2, 192, 192, 4, 64, True),
               # ragged lengths, 5, 300 and 1000 outside ``_shapes_ok``:
               # an exported program's symbolic length sends them to the
               # kernels (18a)
               (3, 77, 77, 4, D, True), (2, 5, 5, 4, D, True),
               (3, 1000, 1000, 4, D, True), (2, 100, 300, 4, D, False),
               (2, 300, 100, 4, 64, True), (2, 5, 5, 4, 64, False)]
FLASH_SETS = ((3, FLASH_SHAPES), (7, FLASH_EDGES))  # (seed, shapes)


def flash_case(fa, rng, dtype, b, sq, sk, h, d, causal):
    """The three flash kernels and the autograd.Function against their
    plain versions on one shape."""
    tag = f"b={b} sq={sq} sk={sk} H={h} D={d} causal={causal}"
    q, k, v, do = flash_inputs(rng, b, sq, sk, h, d, dtype)
    scale = 1.0 / np.sqrt(d)
    o, lse = fa.flash_forward(q, k, v, scale, causal)
    ro, rlse = fa.flash_forward_ref(q, k, v, scale, causal)
    check("flash_forward o", dtype, tag, o, ro, FLASH_TOL)
    live = torch.arange(sq, device="cuda") + (sk - sq) >= 0
    check("flash_forward lse", torch.float32, tag, lse[..., live],
          rlse[..., live])
    if not bool((lse[..., ~live] == fa.NEG_INF).all()):
        raise AssertionError(f"lse of rows with no key != -1e30 ({tag})")
    # both backward versions take the plain forward's o and lse
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, causal)
    dk, dv = fa.flash_backward_dkv(*args)
    rdk, rdv = fa.flash_backward_dkv_ref(*args)
    check("flash_backward_dkv dk", dtype, tag, dk, rdk, FLASH_TOL)
    check("flash_backward_dkv dv", dtype, tag, dv, rdv, FLASH_TOL)
    dq = fa.flash_backward_dq(*args)
    rdq = fa.flash_backward_dq_ref(*args)
    check("flash_backward_dq", dtype, tag, dq, rdq, FLASH_TOL)
    if not bool((dq[:, ~live] == 0).all()):
        raise AssertionError(f"dq of rows with no key != 0 ({tag})")
    # the autograd.Function: in f32 against torch autograd through the
    # plain forward; in bf16 against the plain backward above (torch
    # autograd keeps ds in f32 where the contract rounds it)
    a = [t.detach().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.backward(fa.FlashAttention.apply(*a, scale, causal), do)
    want = (rdq, rdk, rdv)
    if dtype == torch.float32:
        r = [t.detach().requires_grad_(True) for t in (q, k, v)]
        torch.autograd.backward(fa.flash_forward_ref(*r, scale, causal)[0],
                                do)
        want = [t.grad for t in r]
    for x, y, name in zip(a, want, "qkv"):
        check(f"FlashAttention d{name}", dtype, tag, x.grad, y, FLASH_TOL)


def flash_checks(fa):
    """Phase 7: the three flash kernels and the autograd.Function against
    their plain versions on the card, at FLASH_SHAPES, then at the edges of
    the backward tiles (FLASH_EDGES)."""
    for seed, shapes in FLASH_SETS:
        rng = np.random.default_rng(seed)
        for dtype in DTYPES:
            for shape in shapes:
                flash_case(fa, rng, dtype, *shape)
                torch.cuda.empty_cache()


def time_ms(fn, flush, iters=20) -> float:
    """Median device time of ``fn`` in ms between CUDA events, with L2
    flushed before each call (the serving path reads every layer's pools
    cold). The flush leaves L2 full of written lines that a short kernel
    must evict, so its launches swing up to 3x on an H100: the median of
    the launches, not their mean."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def decode_run(model, serving, modes, card, scenario="greedy"):
    """One bf16 decode-timing run of 8 full slots (prompt 512, 64 new) in
    one of ``profile_decode.scenario_kw``'s scenarios: the median host time
    of the scheduler steps that run only a decode step of 8 slots, and what
    the kernel timings reuse (layer 0's pool entry, the tables and
    positions mid-way)."""
    from paddle_tpu_torch.tools.profile_decode import scenario_kw

    cc = decode_compiles()
    api = serving.ServingAPI(model, serving.ServingConfig(num_slots=8,
                                                          **modes),
                             device="cuda")
    eng, sched = api.engine, api.scheduler
    rng = np.random.default_rng(2)
    plen, new, slots = 512, 64, 8
    reqs = [api.submit(rng.integers(0, model.cfg.vocab_size, plen),
                       max_new_tokens=new, **kw)
            for kw in scenario_kw(scenario, slots, model.cfg.vocab_size)]
    step_s, snap = [], None
    while sched.has_work():
        full = not sched.waiting and eng.active_slots() == slots
        t0 = time.perf_counter()
        sched.step()  # the decode step ends in a device-to-host copy
        if full:
            step_s.append(time.perf_counter() - t0)
        if len(step_s) == new // 2 and snap is None:
            snap = (torch.tensor(eng._bt_host, device="cuda"),
                    torch.tensor(eng._positions, device="cuda"))
    for r in reqs:
        if r.state != serving.RequestState.FINISHED or len(r.tokens) != new:
            raise AssertionError(f"bf16 {r.request_id}: {r.state} "
                                 f"{len(r.tokens)}/{new} {r.error!r}")
    med = float(np.median(step_s))
    arena = eng.arena.bytes_total() / slots
    weights = tensor_bytes(list(model.parameters()) + list(model.buffers()))
    name = "+".join(k for k, v in modes.items() if v) or "unquantized"
    if scenario != "greedy":
        name += f" {scenario}"
    print(f"bf16 serving {name}: median decode step {med * 1e3:.3f} ms (a "
          f"graph replay; steps {np.min(step_s) * 1e3:.3f}-"
          f"{np.max(step_s) * 1e3:.3f} ms) over {len(step_s)} steps of "
          f"{slots} slots (prompt {plen}), {slots / med:.1f} tokens/s; arena "
          f"{arena:.0f} bytes per slot, weights {weights} bytes [{card}]")
    hold_programs(eng, cc, [plen], f"bf16 {name}", card)
    pool = eng.stats()["programs.pool_bytes"]
    api.close()
    return dict(median_ms=med * 1e3, tokens_per_s=slots / med,
                arena_bytes_per_slot=arena, weight_bytes=weights,
                pool_bytes=pool, entry=eng.arena.pools[0], snap=snap)


def bf16_prefills(model, pa, serving, card):
    """Phase 6, first: the bf16 prefill kernel's tensor-core instances on
    the engine's own data. A 512-token prompt prefilled whole (the
    full-prefill route) seven times: the host-clock time from ``admit()``
    to the first token on the host (synchronised) of the first admission,
    which warms up and captures the bucket's graph, and the median of the
    next five, graph replays; the seventh holds every layer's kernel output
    against its plain version. Then a 1000-token prompt through an int8
    arena in chunks of 256, every layer of the fourth chunk (prefix 768)
    held the same way."""
    from paddle_tpu_torch.serving import engine as engine_mod

    layers = model.cfg.num_layers
    rng = np.random.default_rng(8)
    cc = decode_compiles()
    eng = serving.ServingAPI(model, serving.ServingConfig(num_slots=8),
                             device="cuda").engine
    prompt = rng.integers(0, model.cfg.vocab_size, 512)
    times = []
    with Shadow(engine_mod, pa, layers,
                {"paged_full_prefill_attention": 6}) as shadow:
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot, _ = eng.admit(prompt, 8)  # the first token to the host
            times.append((time.perf_counter() - t0) * 1e3)
            eng.retire(slot)
    shadow.report("bf16 512-token prefill", card)
    med = float(np.median(times[1:6]))
    print(f"bf16 prefill of 512 tokens: admission to first token {med:.3f} "
          f"ms replayed (host clock, synchronised; median of 5, "
          f"{min(times[1:6]):.3f}-{max(times[1:6]):.3f}), {times[0]:.3f} ms "
          f"at the bucket's first admission (warm-up, capture and replay) "
          f"[{card}]")
    hold_programs(eng, cc, [512], "bf16 512-token prefill", card,
                  decoded=False)
    eng.close()
    cc = decode_compiles()
    eng = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=8, quant_kv=True, chunked_prefill=CHUNK),
        device="cuda").engine
    prompt = rng.integers(0, model.cfg.vocab_size, 1000)
    with Shadow(engine_mod, pa, layers,
                {"paged_prefill_attention": 768 // CHUNK}) as shadow:
        slot, first = eng.admit_begin(prompt, 8)
        while first is None:
            first = eng.admit_chunk(slot)
        eng.retire(slot)
    shadow.report(f"bf16 int8 KV, chunks of {CHUNK}, prefix 768", card)
    hold_programs(eng, cc, [1000], "bf16 int8 KV chunks", card, chunk=CHUNK,
                  decoded=False)
    eng.close()
    return dict(first_token_ms=med, first_token_capture_ms=times[0])


def fp16_shadows(model, pa, serving, card):
    """Phase 6, float16: a float16 copy of the model served on 8 slots, the
    unquantized and the int8 arena. Three prompts (512, 100 and 37 tokens)
    are admitted whole, then one decode step runs; every layer's kernel
    output of the first prefill and of the decode step is held against its
    plain version on the engine's own pools (TOL[float16])."""
    from paddle_tpu_torch.serving import engine as engine_mod

    half = copy.deepcopy(model).to(torch.float16)
    layers = half.cfg.num_layers
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, half.cfg.vocab_size, n) for n in (512, 100, 37)]
    for quant_kv in (False, True):
        cc = decode_compiles()
        eng = serving.ServingAPI(half, serving.ServingConfig(
            num_slots=8, quant_kv=quant_kv), device="cuda").engine
        pick = {"paged_full_prefill_attention": 0, "paged_decode_attention": 0}
        with Shadow(engine_mod, pa, layers, pick) as shadow:
            slots = [eng.admit(p, 8)[0] for p in prompts]
            eng.decode_step()
        for slot in slots:
            eng.retire(slot)
        what = "float16" + (" int8 KV" if quant_kv else "")
        shadow.report(what + ": a 512-token prefill and a decode step of 3 "
                      "slots", card)
        hold_programs(eng, cc, [len(p) for p in prompts], what, card)
        eng.close()
        del eng
    del half
    torch.cuda.empty_cache()


def serve_bf16(model, pa, serving, card):
    """Phase 6: float16 shadows of one prefill and one decode step
    (``fp16_shadows``); then decode-step time and tokens/s of 8 full bf16
    slots in five settings, in this order: unquantized greedy, sampled,
    constrained+sampled (``scenario_kw``), quant_kv, and quant_kv +
    quant_weights (which quantizes the model in place); then each kernel's
    time at the path's shapes, the int8 ones beside the bf16 kernel at the
    same shape."""
    fp16_shadows(model, pa, serving, card)
    model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    first = bf16_prefills(model, pa, serving, card)
    torch.cuda.empty_cache()
    prefix = bf16_prefix(model, pa, serving, card)
    torch.cuda.empty_cache()
    recovery = recovery_times(model, serving, card)
    print("bf16 recovery, one call: " + json.dumps(recovery)
          + f" [{card}]")
    torch.cuda.empty_cache()
    runs = {"unquantized": decode_run(model, serving, {}, card),
            "sampled": decode_run(model, serving, {}, card, "sampled"),
            "constrained+sampled": decode_run(model, serving, {}, card,
                                              "constrained+sampled"),
            "quant_kv": decode_run(model, serving, dict(quant_kv=True), card),
            "quant_kv+quant_weights": decode_run(
                model, serving, dict(quant_kv=True, quant_weights=True),
                card)}
    base = runs["unquantized"]
    for name, r in runs.items():
        print(f"bf16 serving {name}: step "
              f"{r['median_ms'] / base['median_ms']:.3f} x unquantized greedy, arena bytes per slot "
              f"{r['arena_bytes_per_slot'] / base['arena_bytes_per_slot']:.4f}"
              f" x, weight bytes "
              f"{r['weight_bytes'] / base['weight_bytes']:.4f} x, graph pool "
              f"{r['pool_bytes']} bytes [{card}]")
    print("bf16 serving through CUDA graphs, one call: " + json.dumps(
        {name: {k: r[k] for k in ("median_ms", "tokens_per_s", "pool_bytes")}
         for name, r in runs.items()} | first | prefix) + f" [{card}]")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    rng = np.random.default_rng(2)
    dt = torch.bfloat16
    esz = 2
    slots = 8
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # decode: layer 0's pools, tables and positions of each run mid-way
    bt, pos = base["snap"]
    entry = base["entry"]
    q = qkv_split(rng, slots, H, D, dt)[0]
    err = check("paged_decode_attention", dt, "timing shapes",
                pa.paged_decode_attention(q, entry, bt, pos),
                pa.paged_decode_attention_ref(q, entry, bt, pos))
    keys = int((pos.long() + 1).sum())
    tables = 4 * int((pos.long() // BS + 1).sum()) + 4 * slots
    nbytes = 2 * keys * H * D * esz + 2 * q.numel() * esz + tables
    b_ms, b_by = bound(nbytes, 4 * keys * H * D)
    # the yardstick reads only the live keys, as the kernel does
    live = int(pos.max()) + 1
    k_all, v_all = pa._gather_ctx(entry, bt)
    kt, vt = (t[:, :live].transpose(1, 2).contiguous()
              for t in (k_all, v_all))
    mask = (torch.arange(live, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    results["paged_decode_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_decode_attention(q, entry, bt, pos),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_ref(q, entry, bt, pos), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask), flush))
    del k_all, v_all, kt, vt
    # int8 decode: the quant_kv run's pools at the same positions
    bt8, pos8 = runs["quant_kv"]["snap"]
    entry8 = runs["quant_kv"]["entry"]
    if not torch.equal(pos8, pos):
        raise AssertionError("the quant_kv run's positions differ")
    err = check("paged_decode_attention_int8", dt, "timing shapes",
                pa.paged_decode_attention(q, entry8, bt8, pos8),
                pa.paged_decode_attention_ref(q, entry8, bt8, pos8))
    b_ms, b_by = bound(2 * keys * (H * D + 4) + 2 * q.numel() * esz + tables,
                       4 * keys * H * D)
    results["paged_decode_attention_int8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_decode_attention(q, entry8, bt8, pos8),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_decode_attention_ref(q, entry8, bt8, pos8),
            flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bf16_kernel_ms=results["paged_decode_attention"]["ms"])
    del runs
    # prefill: a full prefill at the path's 512 bucket
    sq = 512
    q, k, v = qkv_split(rng, sq, H, D, dt)
    err = check("paged_full_prefill_attention", dt, f"sq={sq} timing",
                pa.paged_full_prefill_attention(q, k, v, BS),
                pa.paged_full_prefill_attention_ref(q, k, v, BS))
    b_ms, b_by = bound(4 * sq * H * D * esz + 4 * (sq // BS),
                       4 * H * D * sq * (sq + 1) // 2)
    qt, kt, vt = (t.transpose(0, 1)[None].contiguous() for t in (q, k, v))
    results["paged_prefill_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_full_prefill_attention(q, k, v, BS),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_full_prefill_attention_ref(q, k, v, BS), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), flush))
    # int8 prefill: a chunk of 256 at prefix 768 through a permuted table,
    # beside the bf16 kernel on bf16 pools at the same shape
    sq, prefix, MB = CHUNK, 768, 128
    nb = slots * MB + 1
    entry8 = int8_entry(rng, (nb, BS, H, D))
    entry = tuple(randn(rng, (nb, BS, H, D), dt) for _ in range(2))
    bt = torch.as_tensor(rng.permutation(np.arange(1, nb))[:MB],
                         dtype=torch.int32, device="cuda")
    q = qkv_split(rng, sq, H, D, dt)[0]
    tag = f"sq={sq} prefix={prefix} timing"
    err = check("paged_prefill_attention_int8", dt, tag,
                pa.paged_prefill_attention(q, entry8, bt, prefix),
                pa.paged_prefill_attention_ref(q, entry8, bt, prefix))
    check("paged_prefill_attention", dt, tag,
          pa.paged_prefill_attention(q, entry, bt, prefix),
          pa.paged_prefill_attention_ref(q, entry, bt, prefix))
    keys = prefix + sq
    pairs = sq * prefix + sq * (sq + 1) // 2
    b_ms, b_by = bound(2 * keys * (H * D + 4) + 2 * q.numel() * esz
                       + 4 * (keys // BS) + 4, 4 * H * D * pairs)
    results["paged_prefill_attention_int8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_prefill_attention(q, entry8, bt, prefix),
                   flush),
        plain_ms=time_ms(
            lambda: pa.paged_prefill_attention_ref(q, entry8, bt, prefix),
            flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bf16_kernel_ms=time_ms(
            lambda: pa.paged_prefill_attention(q, entry, bt, prefix), flush))
    for name, r in results.items():
        lib = (f"sdpa {r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else f"no library call; bf16 kernel {r['bf16_kernel_ms']:.4f} "
                    "ms at the same shape")
        print(f"time {name} bf16: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, {lib} [{card}]")
        if r["library_ms"] is None:
            r["library_note"] = ("no PyTorch call attends int8 paged K/V "
                                 "with per-token scales")
    return results


def train_setup(model, arrays, port, batch, seed):
    """The seeded weights loaded into ``model`` (train mode), a fresh
    AdamW(lr 3e-4, weight decay 0.01) with ClipGradByGlobalNorm(1.0), and
    one fixed batch of ``batch`` x SEQ next-token pairs."""
    port.gpt.load_functional_state(model, arrays)
    model.train()
    opt = port.AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                     weight_decay=0.01,
                     grad_clip=port.ClipGradByGlobalNorm(1.0))
    ids = np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (batch, SEQ + 1))
    ids = torch.as_tensor(ids, device="cuda")
    return opt, ids[:, :-1], ids[:, 1:]


def compare_routes(model, loss_fn, x, y, port, what, card):
    """One forward and backward of ``loss_fn(x, y)`` on the kernel route
    (FLAGS_flash_attention_min_seqlen=0) and on the plain route (-1), same
    weights, no update: the losses and the gradients of every layer's qkv
    and proj weights (what attention moves) must agree within
    ROUTE_TOL[what]."""
    leaves = [p for layer in model.gpt.layers
              for p in (layer.attn.qkv.weight, layer.attn.proj.weight)]
    res = {}
    for route, thr in (("kernel", 0), ("plain", -1)):
        port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": thr})
        loss = loss_fn(x, y)
        res[route] = (float(loss.detach()),
                      torch.autograd.grad(loss, leaves))
        del loss
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(float((a - b).norm() / b.norm()) for a, b in zip(gk, gp))
    loss_tol, grad_tol = ROUTE_TOL[what]
    print(f"train {what} routes, batch {x.shape[0]} x {x.shape[1]}: loss "
          f"{lk!r} (kernel) vs {lp!r} (plain), rel {loss_rel:.3e} (bound "
          f"{loss_tol:g}); qkv/proj weight gradients of all layers, worst "
          f"relative L2 error {grad_rel:.3e} (bound {grad_tol:g}) [{card}]")
    if not (np.isfinite(lk) and loss_rel <= loss_tol
            and grad_rel <= grad_tol):
        raise AssertionError(f"{what}: the kernel route's loss or attention "
                             f"gradients disagree with the plain route's")


def train_f32(model, arrays, port, card):
    """Phase 8: the attention weights' gradients of gpt_1p3b (batch 1 x
    2048, f32) on the kernel route against the plain route, then three f32
    TrainSteps through the flash kernels (FLAGS_flash_attention_min_seqlen
    =0) and three from the same weights on the plain route (-1: 2048 <
    4608). Losses agree within ROUTE_TOL at every step; the kernel route
    launches each flash kernel 24 x steps times, the plain route none.
    Returns the kernel route's launches."""
    fa, flags = port.fa, port.flags
    losses, launches = {}, {}
    loss_tol = ROUTE_TOL["f32"][0]
    for route, thr in (("kernel", 0), ("plain", -1)):
        opt, x, y = train_setup(model, arrays, port, 1, seed=4)
        if route == "kernel":
            compare_routes(model, model, x, y, port, "f32", card)
        step = port.TrainStep(lambda a, b: model(a, b), opt)
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": thr})
        t0 = time.perf_counter()
        fa.reset_launches()
        losses[route] = [float(step(x, y)) for _ in range(STEPS_F32)]
        torch.cuda.synchronize()
        launches[route] = dict(fa.launches)
        print(f"train f32 {route} route (FLAGS_flash_attention_min_seqlen="
              f"{thr}): losses {losses[route]} in "
              f"{time.perf_counter() - t0:.2f} s, launches {launches[route]} "
              f"[{card}]")
        del step, opt
        torch.cuda.empty_cache()
    layers = model.cfg.num_layers
    want = {"kernel": layers * STEPS_F32, "plain": 0}
    for route, n in want.items():
        if any(v != n for v in launches[route].values()):
            raise AssertionError(f"{route} route launches {launches[route]} "
                                 f"!= {n} each (24 x steps on the kernel "
                                 f"route, 0 on the plain route)")
    got, ref = np.array(losses["kernel"]), np.array(losses["plain"])
    rel = np.abs(got - ref) / np.abs(ref)
    if not (np.isfinite(got).all() and (rel <= loss_tol).all()):
        raise AssertionError(f"kernel-route losses {got} disagree with the "
                             f"plain route's {ref} (rel {rel}; rtol "
                             f"{loss_tol:g})")
    print(f"train f32: kernel-route losses within rel {rel.max():.3e} of the "
          f"plain route's at each of {STEPS_F32} steps (rtol {loss_tol:g}) "
          f"[{card}]")
    return launches["kernel"]


def train_bf16(model, arrays, port, card):
    """Phase 9: the loss and attention weights' gradients of one bf16 (AMP
    O1) batch of 1 x 2048 on the kernel route against the plain route; then
    ten bf16 TrainSteps of gpt_1p3b on one fixed batch of BATCH_BF16 x 2048
    through the flash kernels (24 launches of each per step): the loss is
    finite and falls; the median step time, tokens/s, FLOP share and peak
    memory. Then each flash kernel at the step's shapes beside its bound,
    its plain version and one library call (a yardstick only). Returns the
    timings and the main path's launches."""
    fa, flags, amp = port.fa, port.flags, port.amp
    opt, x, y = train_setup(model, arrays, port, BATCH_BF16, seed=5)

    def loss_fn(a, b):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(a, b)

    compare_routes(model, loss_fn, x[:1], y[:1], port, "bf16", card)
    torch.cuda.empty_cache()
    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    step = port.TrainStep(loss_fn, opt)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(STEPS_BF16):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))  # the loss's copy to the host syncs
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fa.launches)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 losses {losses} must be finite and fall")
    cfg = model.cfg
    if any(n != cfg.num_layers * STEPS_BF16 for n in launches.values()):
        raise AssertionError(f"bf16 launches {launches} != 24 x steps")
    tokens = BATCH_BF16 * SEQ
    flops = model_flops(model, BATCH_BF16)
    med = float(np.median(step_s))
    print(f"train bf16 O1: batch {BATCH_BF16} x {SEQ}, losses {losses}; "
          f"median step {med * 1e3:.1f} ms over {STEPS_BF16} steps, "
          f"{tokens / med:.0f} tokens/s, {flops:.4e} model FLOPs/step = "
          f"{flops / med / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s, peak "
          f"memory {peak / 2**30:.2f} GiB, launches {launches} [{card}]")
    del step, opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    base = dict(loss1=losses[0], step_ms=med * 1e3, tokens_s=tokens / med,
                flop_share=flops / med / BF16_FLOPS_PER_S,
                peak_gib=peak / 2**30)
    return flash_times(fa, card), launches, base


def model_flops(model, batch) -> float:
    """Model FLOPs of one training step on ``batch`` x SEQ tokens: 6 N per
    token, plus causal attention, 12 b s^2 h d per layer for forward and
    backward over all pairs, half of the pairs kept. A recompute adds no
    model FLOPs."""
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    hd = cfg.hidden_size // cfg.num_heads
    return 6 * n_params * batch * SEQ + 6 * batch * SEQ * SEQ \
        * cfg.num_heads * hd * cfg.num_layers


def flash_times(fa, card, b=BATCH_BF16, h=H):
    """Each flash kernel at the bf16 step's shapes (``[b, SEQ, h, D]``; a
    tensor-parallel rank's at its local heads): its error against the
    plain version, its time, bound, plain time and library time."""
    rng = np.random.default_rng(6)
    dt, esz, d = torch.bfloat16, 2, D
    q, k, v, do = flash_inputs(rng, b, SEQ, SEQ, h, d, dt)
    scale = 1.0 / np.sqrt(d)
    o, lse = fa.flash_forward(q, k, v, scale, True)
    ro, rlse = fa.flash_forward_ref(q, k, v, scale, True)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, True)
    tag = "timing shapes"
    errs = {"flash_forward": check("flash_forward", dt, tag, o, ro,
                                   FLASH_TOL)}
    dk, dv = fa.flash_backward_dkv(*args)
    rdk, rdv = fa.flash_backward_dkv_ref(*args)
    errs["flash_backward_dkv"] = max(
        check("flash_backward_dkv dk", dt, tag, dk, rdk, FLASH_TOL),
        check("flash_backward_dkv dv", dt, tag, dv, rdv, FLASH_TOL))
    errs["flash_backward_dq"] = check(
        "flash_backward_dq", dt, tag, fa.flash_backward_dq(*args),
        fa.flash_backward_dq_ref(*args), FLASH_TOL)
    del o, lse, ro, rlse, dk, dv, rdk, rdv
    torch.cuda.empty_cache()

    # bound: each operand read once, each output written once; operations
    # per kept (row, key) pair: 4d forward, 8d dK/dV (S and dP recomputed),
    # 6d dQ
    pairs = b * h * SEQ * (SEQ + 1) // 2
    row = b * SEQ * h * d * esz   # one [b, s, h, d] operand
    res = b * h * SEQ * 4         # one f32 residual (lse or delta)
    bounds = {"flash_forward": bound(4 * row + res, 4 * d * pairs),
              "flash_backward_dkv": bound(6 * row + 2 * res, 8 * d * pairs),
              "flash_backward_dq": bound(5 * row + 2 * res, 6 * d * pairs)}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fns = {"flash_forward": (lambda: fa.flash_forward(q, k, v, scale, True),
                             lambda: fa.flash_forward_ref(q, k, v, scale,
                                                          True)),
           "flash_backward_dkv": (lambda: fa.flash_backward_dkv(*args),
                                  lambda: fa.flash_backward_dkv_ref(*args)),
           "flash_backward_dq": (lambda: fa.flash_backward_dq(*args),
                                 lambda: fa.flash_backward_dq_ref(*args))}
    # the yardstick: PyTorch's own flash attention on [b, h, s, d] copies
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    aten = torch.ops.aten
    lib = aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)
    out, lib_lse, cq, ck, mq, mk, seed, offset = lib[:8]
    lib_fwd = time_ms(lambda: aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale), flush, iters=10)
    lib_bwd = time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lib_lse, cq, ck, mq, mk, 0.0, True, seed,
        offset, scale=scale), flush, iters=10)
    results = {}
    for name, (kern, plain) in fns.items():
        b_ms, b_by = bounds[name]
        results[name] = dict(
            max_abs_err=errs[name], ms=time_ms(kern, flush, iters=10),
            plain_ms=time_ms(plain, flush, iters=3), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=lib_fwd if name == "flash_forward" else lib_bwd)
        if name != "flash_forward":
            results[name]["library_covers"] = "dq, dk and dv together"
        r = results[name]
        print(f"time {name} bf16 [{b}, {SEQ}, {h}, {d}] causal: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms [{card}]")
    return results


# ------------------------------------------------------------------ phase 10
# the dropout kernel's bound: threefry's 32-bit integer operations a mask
# element (2 + 20 rounds x 3 + 5 injections x 2, and the draw's xor, shift
# and or) over the most 32-bit operations the SMs can issue: one per lane
# per clock on 128 lanes an SM (4 schedulers x 32), the lanes of the
# published 67 TFLOP/s float32 (132 SMs x 128 x 2 FLOPs of an FMA x 1.98
# GHz), so 33.5 T/s. The 64 dedicated INT32 lanes an SM would give half
# that, but nvcc issues integer adds as IMAD on the float32 lanes too: the
# kernel measured faster than that half rate allows on an H100 (PERF.md)
INT32_OPS_PER_S = F32_FLOPS_PER_S / 2
THREEFRY_INT_OPS = 75
DROPOUT_SHAPES = [(BATCH_BF16, SEQ, 2048), (1, H, SEQ, SEQ), (1000003,)]
DROPOUT_AXES = [((8, H, 64, 64), (0, 1)), ((4, SEQ, 2048), 1)]
DROPOUT_PS = (0.1, 0.5, 0.999)
# buf[1:] of this many elements: a contiguous view whose base is not
# 16-byte aligned (the wrapper copies it before the kernel's 16-byte packs)
DROPOUT_OFFSET_BUF = 1000004
DROPOUT_TIMED = [(BATCH_BF16, SEQ, 2048), (BATCH_BF16, H, SEQ, SEQ)]
# a mesh rank's box of a whole tensor: (whole shape, the box's offsets)
DROPOUT_BOX = ((4, H, 512, 512), (2, H // 2, 0, 0))
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16}


def nonzero_input(gen, shape, dtype):
    """Values of magnitude 0.5 to 4 with random signs (none is 0, so a
    dropped element is the only 0 of an output)."""
    mag = torch.rand(shape, generator=gen, device="cuda") * 3.5 + 0.5
    sign = torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1
    return (mag * sign).to(dtype)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(_INT_VIEW[a.dtype]),
                                              b.view(_INT_VIEW[b.dtype]))


def dropout_case(do, rng_mod, x, key, p, axis, upscale, what, box=None):
    """One kernel launch against the plain version on the same x and key
    (``box``: x is that box of a whole tensor, a mesh rank's draw): the
    keep masks (0 differing elements), the outputs bit for bit, the
    backward (the Function on a random gradient) bit for bit, and a second
    launch equal to the first. Returns the max abs error."""
    y = do.dropout_apply(x, key, p, axis, upscale, box)
    ref = do.dropout_ref(x, key, p, axis, upscale, box)
    if box is None:
        keep = rng_mod.bernoulli(key, 1.0 - p, do.mask_shape(x.shape, axis))
    else:
        keep = rng_mod.bernoulli(key, 1.0 - p, box[0])[tuple(
            slice(o, o + n) for o, n in zip(box[1], x.shape))]
    mask_diff = int(((y != 0) != keep).sum())
    xg = x.detach().clone().requires_grad_(True)
    g = torch.randn_like(x.float()).to(x.dtype)
    do.Dropout.apply(xg, key, p, axis, upscale, box).backward(g)
    g_ref = do.dropout_ref(g, key, p, axis, upscale, box)
    again = do.dropout_apply(x, key, p, axis, upscale, box)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    ok = (mask_diff == 0 and same_bits(y, ref) and same_bits(xg.grad, g_ref)
          and same_bits(again, y))
    kept = float(keep.float().mean())
    print(f"check dropout {str(x.dtype)[6:]} {list(x.shape)} p={p} "
          f"{what}: mask differs at {mask_diff} elements, kept {kept:.4f}, "
          f"output bits equal {same_bits(y, ref)}, backward bits equal "
          f"{same_bits(xg.grad, g_ref)}, second launch equal "
          f"{same_bits(again, y)}, max_abs_err={err:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dropout kernel {x.dtype} {tuple(x.shape)} p={p}"
                             f" {what} disagrees with its plain version")
    return err


def dropout_checks(do, rng_mod, functional, card):
    """Phase 10a: the dropout kernel against its plain version on the card
    (``dropout_case``) in every dtype at the residual, the attention
    probabilities' and a ragged 1,000,003 elements, p 0.1/0.5/0.999; a
    mesh rank's box (DROPOUT_BOX); the axis form; downscale_in_infer; a
    view at an offset of one element; p 0 and eval mode draw no key and
    launch nothing. Returns the max abs error
    over all checks."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    err, n = 0.0, 0
    for dtype in DTYPES:
        for shape in DROPOUT_SHAPES:
            x = nonzero_input(gen, shape, dtype)
            for p in DROPOUT_PS:
                key = rng_mod.fold_in(rng_mod.prng_key(n, device="cuda"), 7)
                err = max(err, dropout_case(do, rng_mod, x, key, p, None,
                                            True, "upscale_in_train"))
                n += 1
            if shape == DROPOUT_SHAPES[0]:
                key = rng_mod.prng_key(n, device="cuda")
                err = max(err, dropout_case(do, rng_mod, x, key, 0.5, None,
                                            False, "downscale_in_infer"))
                n += 1
            del x
            torch.cuda.empty_cache()
        # a mesh rank's box: the second half of the batch rows and of
        # the heads of a whole [batch, heads, s, s]
        whole, offs = DROPOUT_BOX
        x = nonzero_input(gen, tuple(w - o for w, o in zip(whole, offs)),
                          dtype)
        key = rng_mod.prng_key(n, device="cuda")
        err = max(err, dropout_case(do, rng_mod, x, key, 0.1, None, True,
                                    f"box at {list(offs)} of {list(whole)}",
                                    box=(whole, offs)))
        n += 1
        del x
        for shape, axis in DROPOUT_AXES:
            x = nonzero_input(gen, shape, dtype)
            key = rng_mod.prng_key(n, device="cuda")
            err = max(err, dropout_case(do, rng_mod, x, key, 0.5, axis, True,
                                        f"axis {axis}"))
            n += 1
        buf = nonzero_input(gen, (DROPOUT_OFFSET_BUF,), dtype)
        key = rng_mod.prng_key(n, device="cuda")
        err = max(err, dropout_case(do, rng_mod, buf[1:], key, 0.1, None, True,
                                    "offset view buf[1:]"))
        n += 1
    x = nonzero_input(gen, DROPOUT_SHAPES[0], torch.bfloat16)
    state, count = rng_mod.get_rng_state(), do.launches["dropout"]
    ident = (functional.dropout(x, 0.0) is x
             and functional.dropout(x, 0.5, training=False) is x)
    if not (ident and torch.equal(rng_mod.get_rng_state(), state)
            and do.launches["dropout"] == count):
        raise AssertionError("dropout at p 0 or in eval mode must return its "
                             "input, draw no key and launch nothing")
    print(f"check dropout: {n} kernel checks bit-equal to the plain version "
          f"(masks, outputs, backward, relaunch); p 0 and eval draw no key "
          f"and launch nothing [{card}]")
    return err


def dropout_times(do, rng_mod, card):
    """The kernel's time at the residual [8, 2048, 2048] and attention
    probabilities' [8, 16, 2048, 2048] bf16, p 0.1, beside its bound, its
    plain version and torch's Philox dropout (a yardstick only: it draws
    other bits)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    key = rng_mod.prng_key(5, device="cuda")
    out = {}
    for shape in DROPOUT_TIMED:
        x = nonzero_input(gen, shape, torch.bfloat16)
        n = x.numel()
        t_bytes = 2 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
        t_ops = THREEFRY_INT_OPS * n / INT32_OPS_PER_S * 1e3
        r = dict(ms=time_ms(lambda: do.dropout_apply(x, key, 0.1), flush,
                            iters=10),
                 plain_ms=time_ms(lambda: do.dropout_ref(x, key, 0.1), flush,
                                  iters=3),
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 philox_ms=time_ms(lambda: torch.nn.functional.dropout(
                     x, 0.1), flush, iters=10))
        out[str(list(shape))] = r
        print(f"time dropout bf16 {list(shape)} p=0.1: kernel {r['ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{t_bytes:.4f} ms of bytes at 3.35 TB/s, {t_ops:.4f} ms of "
              f"{THREEFRY_INT_OPS} integer operations an element at "
              f"{INT32_OPS_PER_S / 1e12:.1f} T/s), plain {r['plain_ms']:.4f} "
              f"ms, torch Philox dropout (yardstick) {r['philox_ms']:.4f} ms "
              f"[{card}]")
        del x
        torch.cuda.empty_cache()
    return out


# phase 10a, the alpha form: the same keys and inputs, p 0.1 and 0.5
ALPHA_SHAPES = [(BATCH_BF16, SEQ, 2048), (1000003,)]
ALPHA_PS = (0.1, 0.5)


def alpha_case(do, rng_mod, x, key, p):
    """The alpha form against its plain version on one x and key: every
    dropped element holds the fill (the keep mask), the output and the
    backward (the Function on a random gradient) bit for bit, a second
    launch equal to the first. Returns the max abs error."""
    y = do.alpha_dropout_apply(x, key, p)
    ref = do.alpha_dropout_ref(x, key, p)
    keep = rng_mod.bernoulli(key, 1.0 - p, tuple(x.shape))
    fill = do.alpha_constants(p, x.dtype)[2]
    mask_diff = int(((~keep) & (y.float() != fill)).sum())
    xg = x.detach().clone().requires_grad_(True)
    g = torch.randn_like(x.float()).to(x.dtype)
    do.AlphaDropout.apply(xg, key, p).backward(g)
    g_ref = do._alpha_grad_ref(g, key, p)
    again = do.alpha_dropout_apply(x, key, p)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    ok = (mask_diff == 0 and same_bits(y, ref) and same_bits(xg.grad, g_ref)
          and same_bits(again, y))
    print(f"check alpha_dropout {str(x.dtype)[6:]} {list(x.shape)} p={p}: "
          f"dropped elements off the fill {mask_diff}, output bits equal "
          f"{same_bits(y, ref)}, backward bits equal "
          f"{same_bits(xg.grad, g_ref)}, second launch equal "
          f"{same_bits(again, y)}, max_abs_err={err:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"alpha dropout {x.dtype} {tuple(x.shape)} p={p}"
                             " disagrees with its plain version")
    return err


def alpha_checks(do, rng_mod, nn_layers, card):
    """Phase 10a, the alpha form (``alpha_case``) in every dtype at [8,
    2048, 2048] and 1,000,003 elements, p 0.1 and 0.5; then the
    ``AlphaDropout`` layer's forward and backward with the counts at 0:
    the alpha form launches twice (its launches). Returns the max abs
    error and those launches."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    err, n = 0.0, 0
    for dtype in DTYPES:
        for shape in ALPHA_SHAPES:
            x = nonzero_input(gen, shape, dtype)
            for p in ALPHA_PS:
                key = rng_mod.fold_in(rng_mod.prng_key(100 + n, device="cuda"),
                                      3)
                err = max(err, alpha_case(do, rng_mod, x, key, p))
                n += 1
            del x
            torch.cuda.empty_cache()
    layer = nn_layers.AlphaDropout(0.1)
    x = nonzero_input(gen, ALPHA_SHAPES[0], torch.bfloat16).requires_grad_(
        True)
    do.reset_launches()
    with rng_mod.key_guard(rng_mod.prng_key(9, device="cuda")):
        layer(x).float().sum().backward()
    torch.cuda.synchronize()
    launches = do.launches["alpha_dropout"]
    if launches != 2:
        raise AssertionError(f"AlphaDropout forward + backward launched the "
                             f"alpha form {launches} times, not 2")
    print(f"check alpha_dropout: {n} kernel checks bit-equal to the plain "
          f"version; the AlphaDropout layer launched it {launches} times "
          f"(forward, backward) [{card}]")
    return err, launches


def alpha_times(do, rng_mod, card):
    """The alpha form's time at [8, 16, 2048, 2048] bf16, p 0.1, beside its
    bound (the same threefry instruction bound as dropout's) and its plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    key = rng_mod.prng_key(6, device="cuda")
    x = nonzero_input(gen, DROPOUT_TIMED[1], torch.bfloat16)
    n = x.numel()
    t_bytes = 2 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
    t_ops = THREEFRY_INT_OPS * n / INT32_OPS_PER_S * 1e3
    r = dict(ms=time_ms(lambda: do.alpha_dropout_apply(x, key, 0.1), flush,
                        iters=10),
             plain_ms=time_ms(lambda: do.alpha_dropout_ref(x, key, 0.1),
                              flush, iters=3),
             bound_ms=max(t_bytes, t_ops),
             bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"time alpha_dropout bf16 {list(x.shape)} p=0.1: kernel "
          f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms [{card}]")
    del x
    torch.cuda.empty_cache()
    return r


# phase 10b: the memory levers on phase 9's batch and weights; each
# setting's expected flash launches per step per layer: a full recompute
# runs the flash forward again in backward (the Function's saved o and lse
# are rebuilt), and so does core_attn (a custom kernel is no matmul the
# policy could save)
RECOMPUTED = {"flash_forward": 2, "flash_backward_dkv": 1,
              "flash_backward_dq": 1}
PLAIN_STEP = {"flash_forward": 1, "flash_backward_dkv": 1,
              "flash_backward_dq": 1}
LEVERS = [("recompute full", dict(use_recompute=True,
                                  recompute_policy="full"), RECOMPUTED),
          ("recompute core_attn", dict(use_recompute=True,
                                       recompute_policy="core_attn"),
           RECOMPUTED),
          ("loss_chunk_size 1024 + recompute full",
           dict(use_recompute=True, recompute_policy="full",
                loss_chunk_size=1024), RECOMPUTED),
          ("untied head", dict(tie_word_embeddings=False), PLAIN_STEP)]
STEPS_LEVER = 3


def train_lever(model, arrays, port, card, name, per_layer, base):
    """Three bf16 O1 TrainSteps of ``model`` (its config set to one
    lever) on phase 9's batch and weights through the flash kernels: step
    1's loss against phase 9's within ROUTE_TOL["bf16"], the exact flash
    launches, then the median step time, tokens/s, FLOP share and peak
    memory."""
    fa, flags, amp = port.fa, port.flags, port.amp
    opt, x, y = train_setup(model, arrays, port, BATCH_BF16, seed=5)

    def loss_fn(a, b):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(a, b)

    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    step = port.TrainStep(loss_fn, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(STEPS_LEVER):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fa.launches)
    layers = model.cfg.num_layers
    want = {k: v * layers * STEPS_LEVER for k, v in per_layer.items()}
    med = float(np.median(step_s))
    flops = model_flops(model, BATCH_BF16)
    tokens = BATCH_BF16 * SEQ
    rel = abs(losses[0] - base["loss1"]) / abs(base["loss1"])
    row = dict(setting=name, step_ms=med * 1e3, tokens_s=tokens / med,
               flop_share=flops / med / BF16_FLOPS_PER_S,
               peak_gib=peak / 2**30, loss1=losses[0], loss1_rel=rel,
               launches=launches)
    print(f"train bf16 O1 {name}: batch {BATCH_BF16} x {SEQ}, losses "
          f"{losses}, step 1 against phase 9's {base['loss1']!r}: rel "
          f"{rel:.3e} (bound {ROUTE_TOL['bf16'][0]:g}); median step "
          f"{med * 1e3:.1f} ms over {STEPS_LEVER} steps, "
          f"{tokens / med:.0f} tokens/s, {row['flop_share']:.4f} of 989 "
          f"TFLOP/s, peak memory {peak / 2**30:.2f} GiB, launches "
          f"{launches} (expected {want}) [{card}]")
    del step, opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and rel <= ROUTE_TOL["bf16"][0]):
        raise AssertionError(f"{name}: step 1's loss {losses[0]} disagrees "
                             f"with phase 9's {base['loss1']}")
    if launches != want:
        raise AssertionError(f"{name}: flash launches {launches} != {want}")
    return row


def train_levers(model, arrays, port, card, base):
    """Phase 10b on phase 9's model: the three tied settings of LEVERS,
    each set on the model's config and put back after."""
    rows = []
    for name, kw, per_layer in LEVERS[:3]:
        old = {k: getattr(model.cfg, k) for k in kw}
        for k, v in kw.items():
            setattr(model.cfg, k, v)
        try:
            rows.append(train_lever(model, arrays, port, card, name,
                                    per_layer, base))
        finally:
            for k, v in old.items():
                setattr(model.cfg, k, v)
    return rows


def train_untied(arrays, port, card, base):
    """Phase 10b's last setting: a model with its own lm_head, loaded with
    the tied weights and ``lm_head = wte^T`` (so step 1 computes what phase
    9's step 1 computed)."""
    gpt = port.gpt
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(tie_word_embeddings=False),
                               device="cuda")
    untied = dict(arrays)
    untied["lm_head.weight"] = np.ascontiguousarray(
        arrays["gpt.wte.weight"].T)
    name, _, per_layer = LEVERS[3]
    row = train_lever(model, untied, port, card, name, per_layer, base)
    del model
    torch.cuda.empty_cache()
    return row


STEPS_DROPOUT = 3


def dropout_sites(layers):
    """Dropout launches of one TrainStep with recompute "full": the forward
    draws 1 + 3 per layer (the embedding, the attention probabilities and
    the two residual branches); the recompute of a block stops after its
    last saved tensor (torch's early stop), the input of the MLP's down
    matmul, so it runs the attention probabilities' and the first
    residual's dropout again (2 per layer) but not the last; backward runs
    the kernel once per forward site."""
    fwd = 1 + 3 * layers
    return fwd + 2 * layers + fwd


def train_dropout(arrays, port, card):
    """Phase 10c: gpt_1p3b with dropout 0.1, bf16 O1, recompute "full",
    batch 1 x 2048, attention on the plain route (live dropout never takes
    the flash kernels). One forward and backward under one key with
    recompute on and off: equal losses, qkv/proj gradients within
    ROUTE_TOL["bf16"] (recompute replayed the keys). Then 3 TrainSteps from
    rng.seed(0): finite losses, step 1's equal to the recompute-on loss, the
    dropout kernel launched exactly ``dropout_sites`` per step and no flash
    kernel. Returns the dropout launches."""
    gpt, rng_mod, do, fa, amp = port.gpt, port.rng, port.do, port.fa, port.amp
    cfg = gpt.gpt_1p3b(dropout=0.1, use_recompute=True,
                       recompute_policy="full")
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})

    def loss_fn(a, b):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(a, b)

    opt, x, y = train_setup(model, arrays, port, 1, seed=7)
    leaves = [p for layer in model.gpt.layers
              for p in (layer.attn.qkv.weight, layer.attn.proj.weight)]
    res = {}
    for on in (True, False):
        model.cfg.use_recompute = on
        rng_mod.seed(0)
        key = rng_mod.next_key("cuda")
        with rng_mod.key_guard(key):
            loss = loss_fn(x, y)
        res[on] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
        del loss
    model.cfg.use_recompute = True
    (l_on, g_on), (l_off, g_off) = res[True], res[False]
    loss_rel = abs(l_on - l_off) / abs(l_off)
    grad_rel = max(float((a - b).norm() / b.norm())
                   for a, b in zip(g_on, g_off))
    print(f"train dropout 0.1 bf16 O1, batch 1 x {SEQ}: recompute on "
          f"{l_on!r} vs off {l_off!r}, rel {loss_rel:.3e}; qkv/proj "
          f"gradients worst relative L2 {grad_rel:.3e} (bounds "
          f"{ROUTE_TOL['bf16'][0]:g}, {ROUTE_TOL['bf16'][1]:g}) [{card}]")
    if not (loss_rel <= ROUTE_TOL["bf16"][0]
            and grad_rel <= ROUTE_TOL["bf16"][1]):
        raise AssertionError("recompute did not replay the forward's "
                             "dropout keys: its loss or gradients differ")
    del res, g_on, g_off
    step = port.TrainStep(loss_fn, opt)
    rng_mod.seed(0)
    do.reset_launches()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(STEPS_DROPOUT):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        step_s.append(time.perf_counter() - t0)
    secs = sum(step_s)
    launches = do.launches["dropout"]
    want = dropout_sites(cfg.num_layers) * STEPS_DROPOUT
    rel1 = abs(losses[0] - l_on) / abs(l_on)
    print(f"train dropout 0.1: {STEPS_DROPOUT} TrainSteps, losses {losses} "
          f"in {secs:.2f} s, step 1 against the recompute-on loss rel "
          f"{rel1:.3e}; dropout launches {launches} (expected {want}: "
          f"{dropout_sites(cfg.num_layers)} a step), flash launches "
          f"{dict(fa.launches)} [{card}]")
    if not (np.isfinite(losses).all() and rel1 <= ROUTE_TOL["bf16"][0]):
        raise AssertionError(f"dropout losses {losses} must be finite, step "
                             f"1's equal to {l_on}")
    if launches != want or any(fa.launches.values()):
        raise AssertionError(f"dropout launches {launches} != {want}, or a "
                             f"flash kernel ran: {fa.launches}")
    del step, opt, model
    torch.cuda.empty_cache()
    attention_share(port, float(np.median(step_s)) * 1e3, cfg, card)
    return launches


def attention_share(port, step_ms, cfg, card):
    """How much of phase 10c's step the plain attention route with live
    dropout takes: one layer's forward, and its forward plus backward, at
    the step's shape (bf16 [1, 2048, 16, 128], causal, p 0.1), times the
    layers, the forward counted twice (the recompute), over the median
    step."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, g = (torch.randn((1, SEQ, H, D), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    key = port.rng.prng_key(3, device="cuda")
    scale = 1.0 / np.sqrt(D)

    def fwd():
        return port.attention._sdpa_reference(q, k, v, scale=scale,
                                               causal=True, dropout_p=0.1,
                                               key=key)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd_ms = time_ms(fwd, flush, iters=5)
    both_ms = time_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), g),
                      flush, iters=5)
    share = cfg.num_layers * (fwd_ms + both_ms) / step_ms
    print(f"train dropout 0.1: plain attention with dropout, one layer bf16 "
          f"[1, {SEQ}, {H}, {D}]: forward {fwd_ms:.3f} ms, forward + "
          f"backward {both_ms:.3f} ms; x {cfg.num_layers} layers with the "
          f"recompute's second forward = {share:.3f} of the median step "
          f"{step_ms:.1f} ms [{card}]")
    return share


# phase 10d: float16 O2 with GradScaler on gpt_1p3b cut to 4 layers. After
# two good steps the scale rises from 2^15 to 2^32, whose gradients
# overflow float16 (the head's logit gradients alone reach 2^32 / 2048):
# step 3 is skipped and the scale falls back to 2^15
FP16_LAYERS, FP16_STEPS = 4, 4
SCALER_KW = dict(init_loss_scaling=2.0 ** 15, incr_ratio=2.0 ** 17,
                 decr_ratio=2.0 ** -17, incr_every_n_steps=4,
                 decr_every_n_nan_or_inf=2)


def scaler_rule(state, found_inf):
    """The JAX package's ``GradScaler.update`` on ``(scale, good, bad)``,
    transcribed, for the expected schedule."""
    scale, good, bad = state
    if found_inf:
        good, bad = 0, bad + 1
        if bad >= SCALER_KW["decr_every_n_nan_or_inf"]:
            scale, bad = max(scale * SCALER_KW["decr_ratio"], 1.0), 0
    else:
        good, bad = good + 1, 0
        if good >= SCALER_KW["incr_every_n_steps"]:
            scale, good = scale * SCALER_KW["incr_ratio"], 0
    return scale, good, bad


def train_fp16_scaler(arrays, port, card):
    """Phase 10d: float16 AMP O2 (``decorate``: float16 parameters, f32
    master weights) at full width, 4 layers, batch 1 x 2048, eager
    ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update()``
    (the JAX package's ``step`` updates the scale itself, so each step
    updates it twice). The step whose gradients overflow is skipped with
    parameters and optimizer slots bit-unchanged, the others update; the
    scale follows ``scaler_rule`` step for step."""
    gpt, amp = port.gpt, port.amp
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=FP16_LAYERS)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    keep = {n for n, _ in model.named_parameters()}
    opt, x, y = train_setup(model, {k: v for k, v in arrays.items()
                                    if k in keep}, port, 1, seed=8)
    amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(**SCALER_KW)
    state = (SCALER_KW["init_loss_scaling"], 0, 0)
    skipped, scales = [], []
    for i in range(FP16_STEPS):
        before = [p.detach().clone() for p in model.parameters()]
        slots = {(i, k): v.clone() for i, acc in opt._accumulators.items()
                 for k, v in acc.items()}
        count = opt._step_count
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = model(x, y)
        scaler.scale(loss).backward()
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in model.parameters())
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        for _ in range(2):
            state = scaler_rule(state, not finite)
        same = all(torch.equal(a, p.detach())
                   for a, p in zip(before, model.parameters()))
        same_slots = all(torch.equal(v, opt._accumulators[i][k])
                         for (i, k), v in slots.items())
        skipped.append(not finite)
        scales.append(scaler.get_loss_scaling())
        print(f"train float16 O2 + GradScaler step {i + 1}: loss "
              f"{float(loss.detach()):.6f}, scaled gradients finite {finite}, "
              f"parameters unchanged {same}, slots unchanged {same_slots}, "
              f"optimizer steps {count} -> {opt._step_count}, scale "
              f"{scaler.get_loss_scaling():g} (expected {state[0]:g}) "
              f"[{card}]")
        if (not finite) != (same and same_slots and opt._step_count == count):
            raise AssertionError(f"step {i + 1}: a step with non-finite "
                                 "gradients must leave parameters, slots and "
                                 "the step count bit-unchanged, and only it")
        if scaler.get_loss_scaling() != state[0] or not np.isfinite(
                float(loss.detach())):
            raise AssertionError(f"step {i + 1}: scale "
                                 f"{scaler.get_loss_scaling()} != "
                                 f"{state[0]} or the loss is not finite")
    if skipped.count(True) != 1:
        raise AssertionError(f"exactly one step must overflow: {skipped}")
    del model, opt
    torch.cuda.empty_cache()
    return scales


# phase 12: the training loop around TrainStep
FIT_STEPS, FIT_BATCH = 6, 4
LOADER_TIMEOUT = 120  # seconds a worker batch may take: a hung worker fails
CKPT_LAYERS, LBFGS_LAYERS = 4, 2
CKPT_DIR = os.path.join("build", "chip_checkpoints")
# 12c: each optimizer's first update from fresh slots, and the bytes an
# update must move per parameter (f32 parameter, gradient and the slots the
# algorithm reads and writes, each once)
FAMILY = [("SGD", dict(learning_rate=1.0), 0),
          ("Momentum", dict(learning_rate=1.0, momentum=0.9), 1),
          ("Adagrad", dict(learning_rate=1e-3, epsilon=1e-6), 1),
          ("Adadelta", dict(learning_rate=1.0, rho=0.95, epsilon=1e-6), 2),
          ("RMSProp", dict(learning_rate=1e-3, rho=0.95, epsilon=1e-6), 2),
          ("Adamax", dict(learning_rate=1e-3, beta1=0.9, epsilon=1e-8), 2),
          ("Lamb", dict(learning_rate=1e-3, lamb_weight_decay=0.01,
                        epsilon=1e-6), 2),
          ("LarsMomentum", dict(learning_rate=0.1, lars_coeff=0.001,
                                lars_weight_decay=5e-4), 1)]
# bound on |p_f32 - p_f64| per element: the f32 rounding of the new
# parameter (two halves of an ulp) plus 1e-4 of the update's size
FAMILY_REL = 1e-4


def lm_loss(functional):
    """The GPT's own loss on its logits: mean cross entropy in f32."""
    def loss(logits, y):
        return functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(), y.reshape(-1))
    return loss


def f64_first_update(name, hp, p, g):
    """Float64 recomputation of the first update of optimizer ``name``
    from fresh slots, written from the update rules, not the port's
    code."""
    lr = hp["learning_rate"]
    if name == "SGD" or name == "Momentum":
        return p - lr * g
    if name == "Adagrad":
        return p - lr * g / (g.abs() + hp["epsilon"])
    if name == "Adadelta":
        rho, eps = hp["rho"], hp["epsilon"]
        upd = (eps ** 0.5) / torch.sqrt((1 - rho) * g * g + eps) * g
        return p - lr * upd
    if name == "RMSProp":
        rho, eps = hp["rho"], hp["epsilon"]
        return p - lr * g / torch.sqrt((1 - rho) * g * g + eps)
    if name == "Adamax":
        b1 = hp["beta1"]
        return p - lr / (1 - b1) * ((1 - b1) * g) / (g.abs() + hp["epsilon"])
    if name == "Lamb":
        r = g / (g.abs() + hp["epsilon"]) + hp["lamb_weight_decay"] * p
        wn, rn = p.norm(), r.norm()
        trust = wn / rn if (wn > 0 and rn > 0) else 1.0
        return p - lr * trust * r
    if name == "LarsMomentum":
        wd, pn, gn = hp["lars_weight_decay"], p.norm(), g.norm()
        local = (lr * hp["lars_coeff"] * pn / (gn + wd * pn)
                 if (wd > 0 and pn > 0 and gn > 0) else lr)
        return p - local * (g + wd * p)
    raise KeyError(name)


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) ``fn`` runs, from a
    torch.profiler trace; None when the trace shows no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n or None


def optimizer_family(model, arrays, t, card):
    """Phase 12c: one bf16 O1 gradient of gpt_1p3b at batch 1 x 2048; for
    each optimizer of FAMILY, its first update from the same parameters
    through ``_apply_gradients`` (the TrainStep path) against a float64
    recomputation on the card, then its time (median of 3 more updates),
    its device operations and its bound (the bytes of parameters,
    gradients and slots read and written, over 3.35 TB/s)."""
    t.gpt.load_functional_state(model, arrays)
    model.train()
    t.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    ids = np.random.default_rng(41).integers(0, model.cfg.vocab_size,
                                             (1, SEQ + 1))
    ids = torch.as_tensor(ids, device="cuda")
    names, params = zip(*model.named_parameters())
    with t.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = model(ids[:, :-1], ids[:, 1:])
    grads = torch.autograd.grad(loss, params)
    del loss
    p0 = [p.detach().clone() for p in params]
    n_params = sum(p.numel() for p in params)
    out = {}
    for name, hp, n_slots in FAMILY:
        opt = getattr(t.optimizer, name)(
            parameters=list(zip(names, params)), **hp)
        opt._apply_gradients(list(params), list(grads))
        torch.cuda.synchronize()
        worst, num, den = 0.0, 0.0, 0.0
        with torch.no_grad():
            for p, a, g in zip(params, p0, grads):
                ref = f64_first_update(name, hp, a.double(), g.double())
                err = (p.double() - ref).abs()
                bound = (2.0 ** -23 * ref.abs() + FAMILY_REL
                         * (ref - a.double()).abs() + 1e-30)
                worst = max(worst, float((err / bound).max()))
                num += float(((p.double() - a.double())
                              - (ref - a.double())).norm() ** 2)
                den += float((ref - a.double()).norm() ** 2)
                del ref, err, bound
        rel = (num / den) ** 0.5 if den else 0.0
        ms = []
        for _ in range(3):
            a_ev = torch.cuda.Event(enable_timing=True)
            b_ev = torch.cuda.Event(enable_timing=True)
            a_ev.record()
            opt._apply_gradients(list(params), list(grads))
            b_ev.record()
            torch.cuda.synchronize()
            ms.append(a_ev.elapsed_time(b_ev))
        ops = device_ops(lambda: opt._apply_gradients(list(params),
                                                      list(grads)))
        nbytes = n_params * 4 * (3 + 2 * n_slots)
        r = dict(ms=float(np.median(ms)), device_ops=ops,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                 worst_share=worst, normwise_rel=rel)
        out[name] = r
        print(f"optimizer {name}: first update within {worst:.3f} of its "
              f"bound per element (f32 rounding + {FAMILY_REL:g} of the "
              f"update), normwise rel {rel:.3e}; update {r['ms']:.2f} ms "
              f"(median of 3), {ops} device operations, bound "
              f"{r['bound_ms']:.3f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s) "
              f"[{card}]")
        with torch.no_grad():
            for p, a in zip(params, p0):
                p.copy_(a)
        del opt
        torch.cuda.empty_cache()
        if not worst <= 1.0:
            raise AssertionError(f"{name}: the f32 update leaves its float64 "
                                 f"recomputation ({worst:.3f} of the bound)")
    del grads, p0
    torch.cuda.empty_cache()
    print(json.dumps({"optimizer_updates": out}))
    return out


class _TimedLoader:
    """An iterable over ``loader``'s batches that records how long the
    caller waited for each; the first wait includes ``iter()``, where the
    workers start (a spawned worker reads its pickled dataset before
    ``start`` returns)."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __iter__(self):
        t0 = time.perf_counter()
        it = iter(self.loader)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch
            t0 = time.perf_counter()


def fit_dataset(t, vocab, batches, seed):
    """A TensorDataset of ``batches`` x FIT_BATCH sequences: the same
    FIT_BATCH seeded sequences in every batch."""
    ids = np.random.default_rng(seed).integers(0, vocab, (FIT_BATCH,
                                                          SEQ + 1))
    ids = np.tile(ids, (batches, 1))
    return t.io.TensorDataset([ids[:, :-1], ids[:, 1:]])


def fit_schedule(t):
    return t.lr.LinearWarmup(t.lr.CosineAnnealingDecay(1e-3,
                                                       T_max=FIT_STEPS),
                             2, 1e-4, 1e-3)


def fit_model(t, model, functional):
    """``hapi.Model`` over ``model``: bf16 O2 (``amp.decorate``),
    Lamb(multi_precision) under LinearWarmup(Cosine),
    ClipGradByGlobalNorm(1.0), the LM loss."""
    sched = fit_schedule(t)
    opt = t.optimizer.Lamb(learning_rate=sched,
                           parameters=model.named_parameters(),
                           lamb_weight_decay=0.01, multi_precision=True,
                           grad_clip=t.ClipGradByGlobalNorm(1.0))
    t.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    hm = t.Model(model)
    hm.prepare(opt, loss=lm_loss(functional))
    return hm, opt, sched


def fit_gpt(model, arrays, t, functional, card):
    """Phase 12a: ``Model.fit`` on full gpt_1p3b (bf16 O2, Lamb under
    LinearWarmup(Cosine), global-norm clip, flash route) over a
    ``DataLoader`` with 2 worker processes (shared memory) for FIT_STEPS
    steps of FIT_BATCH x 2048: each flash kernel launches exactly 24 x
    steps, the loss is finite and falls, the LR sequence is the
    scheduler's own. Then the same loss driven by a bare TrainStep for 4
    steps. Prints both median step times, the loader wait per step,
    tokens/s and peak memory."""
    t.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    t.gpt.load_functional_state(model, arrays)
    hm, opt, sched = fit_model(t, model, functional)
    loader = t.io.DataLoader(fit_dataset(t, model.cfg.vocab_size, FIT_STEPS,
                                         31),
                             batch_size=FIT_BATCH, num_workers=2,
                             timeout=LOADER_TIMEOUT, device="cuda")
    timed_loader = _TimedLoader(loader)
    start_method = t.io._start_method()

    class Recorder(t.callbacks.Callback):
        """Each step's LR, loss and host time."""

        def __init__(self):
            super().__init__()
            self.lrs, self.losses, self.step_s = [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self.lrs.append(opt.get_lr())
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])  # float(loss): synchronised
            self.step_s.append(time.perf_counter() - self._t0)

    rec = Recorder()
    torch.cuda.reset_peak_memory_stats()
    t.fa.reset_launches()
    t0 = time.perf_counter()
    hm.fit(timed_loader, epochs=1, verbose=0,
           callbacks=[rec, t.callbacks.LRScheduler()])
    fit_s = time.perf_counter() - t0
    launches = dict(t.fa.launches)
    peak = torch.cuda.max_memory_allocated()
    want_lrs = []
    ref = fit_schedule(t)
    for _ in range(FIT_STEPS):
        want_lrs.append(ref())
        ref.step()
    layers = model.cfg.num_layers
    if any(n != layers * FIT_STEPS for n in launches.values()):
        raise AssertionError(f"fit launches {launches} != 24 x {FIT_STEPS}")
    if not (np.isfinite(rec.losses).all() and rec.losses[-1] < rec.losses[0]):
        raise AssertionError(f"fit losses {rec.losses} must be finite and "
                             "fall")
    if rec.lrs != want_lrs:
        raise AssertionError(f"fit LRs {rec.lrs} != the scheduler's "
                             f"{want_lrs}")
    x, y = next(iter(t.io.DataLoader(
        fit_dataset(t, model.cfg.vocab_size, 1, 31), batch_size=FIT_BATCH,
        device="cuda")))
    bare = t.TrainStep(hm._loss_of, opt)
    bare_s = []
    for _ in range(4):
        t1 = time.perf_counter()
        float(bare(x, y))
        bare_s.append(time.perf_counter() - t1)
    tokens = FIT_BATCH * SEQ
    med = float(np.median(rec.step_s[1:]))
    bare_med = float(np.median(bare_s[1:]))
    waits = timed_loader.waits
    r = dict(step_ms=med * 1e3, bare_step_ms=bare_med * 1e3,
             steps_ms=[x * 1e3 for x in rec.step_s],
             bare_steps_ms=[x * 1e3 for x in bare_s],
             start_method=start_method,
             first_wait_ms=waits[0] * 1e3,
             wait_ms=float(np.median(waits[1:])) * 1e3,
             max_wait_ms=float(max(waits[1:])) * 1e3,
             tokens_s=tokens / med, peak_gib=peak / 2**30, fit_s=fit_s,
             losses=rec.losses, lrs=rec.lrs)
    print(f"fit gpt_1p3b bf16 O2 Lamb: {FIT_STEPS} steps of {FIT_BATCH} x "
          f"{SEQ} through a DataLoader of 2 workers ({start_method}) in "
          f"{fit_s:.1f} s; losses "
          f"{rec.losses}; LRs equal the scheduler's; median step "
          f"{r['step_ms']:.1f} ms against a bare TrainStep's "
          f"{r['bare_step_ms']:.1f} ms; loader wait {r['wait_ms']:.3f} ms "
          f"median, {r['max_wait_ms']:.3f} ms max (first batch "
          f"{r['first_wait_ms']:.1f} ms, the workers' start); "
          f"{r['tokens_s']:.0f} tokens/s; peak memory {r['peak_gib']:.2f} "
          f"GiB; launches {launches} [{card}]")
    loader.close()
    del hm, opt, bare
    torch.cuda.empty_cache()
    return r


def ckpt_build(t, arrays, functional):
    cfg = dataclasses.replace(t.gpt.gpt_1p3b(), num_layers=CKPT_LAYERS)
    m = t.gpt.GPTForCausalLM(cfg, device="cuda")
    t.gpt.load_functional_state(m, {n: arrays[n]
                                    for n, _ in m.named_parameters()})
    return fit_model(t, m, functional)


def ckpt_loader(t, vocab, batches):
    return t.io.DataLoader(fit_dataset(t, vocab, batches, 32),
                           batch_size=FIT_BATCH, device="cuda")


def _same_state(a, b) -> bool:
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def checkpoint_resume(arrays, t, functional, card):
    """Phase 12b: gpt_1p3b at full width cut to CKPT_LAYERS layers, phase
    12a's setup. An uninterrupted fit of 6 steps; then a fit of 4 steps
    with ``TrainCheckpointer(async_save=True)`` saving step 2 from a
    callback and ``ModelCheckpoint``, an armed ``preempt`` fault so that
    ``PreemptionGuard.maybe_finalize`` writes step 4 and the resume marker
    at the 4th step boundary; a model, optimizer and scheduler rebuilt and
    restored from disk then fit the last 2 steps: parameters, slots, step
    and LR bit-equal to the uninterrupted run's. Then step 4's data
    truncated: ``restore`` falls back to step 2, and asking for step 4
    raises CheckpointIntegrityError. Prints save seconds (async: until
    ``save`` returns; blocking: the final save), bytes and restore
    seconds. Removes its directory."""
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ck = t.checkpoint
    lrcb = t.callbacks.LRScheduler
    hm, opt, sched = ckpt_build(t, arrays, functional)
    vocab = hm.network.cfg.vocab_size
    hm.fit(ckpt_loader(t, vocab, 6), epochs=1, verbose=0, callbacks=[lrcb()])
    want = {"params": {k: v.detach().clone()
                       for k, v in hm.network.state_dict().items()},
            "opt": opt.state_dict(), "lr": opt.get_lr()}
    del hm, opt, sched
    torch.cuda.empty_cache()

    hm, opt, sched = ckpt_build(t, arrays, functional)
    ckpt = ck.TrainCheckpointer(os.path.join(CKPT_DIR, "steps"),
                                max_to_keep=2, async_save=True)
    guard = t.resilience.PreemptionGuard(install=False)
    times = {}

    def state():
        return {"model": hm.network.state_dict(), "opt": opt.state_dict()}

    class StepCheckpoint(t.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            if step + 1 == 2:
                t0 = time.perf_counter()
                ckpt.save(2, state())
                times["async_save_s"] = time.perf_counter() - t0
            if step + 1 == 4:
                t.flags.set_flags({"fault_injection": 1})
                t.resilience.inject_fault("preempt")
                t0 = time.perf_counter()
                times["finalized"] = guard.maybe_finalize(
                    4, ckpt, state, exit_process=False)
                times["final_save_s"] = time.perf_counter() - t0

    try:
        hm.fit(ckpt_loader(t, vocab, 4), epochs=1, verbose=0,
               callbacks=[lrcb(), StepCheckpoint(),
                          t.callbacks.ModelCheckpoint(
                              1, os.path.join(CKPT_DIR, "model"))])
    finally:
        t.resilience.clear_faults()
        t.flags.set_flags({"fault_injection": 0})
    marker = ckpt.resume_marker()
    if not (times.get("finalized") and marker and marker["step"] == 4
            and ckpt.all_steps() == [2, 4]
            and os.path.exists(os.path.join(CKPT_DIR, "model", "0",
                                            "model.pdopt"))):
        raise AssertionError(f"the preempted run must end with steps [2, 4],"
                             f" the marker at 4 and the epoch's model files: "
                             f"{ckpt.all_steps()}, {marker}")
    del hm, opt, sched
    torch.cuda.empty_cache()

    hm, opt, sched = ckpt_build(t, arrays, functional)
    t0 = time.perf_counter()
    restored = ckpt.restore()
    ck.apply_state_dict(hm.network, restored["model"])
    opt.set_state_dict(restored["opt"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if ckpt.last_restored_step != 4:
        raise AssertionError(f"restored step {ckpt.last_restored_step}")
    hm.fit(ckpt_loader(t, vocab, 2), epochs=1, verbose=0, callbacks=[lrcb()])
    got = {"params": dict(hm.network.state_dict()), "opt": opt.state_dict(),
           "lr": opt.get_lr()}
    same = (_same_state(got["params"], want["params"])
            and _same_state(got["opt"], want["opt"])
            and got["lr"] == want["lr"])
    data4 = os.path.join(CKPT_DIR, "steps", "4", "data.bin")
    nbytes = os.path.getsize(data4)
    with open(data4, "r+b") as f:
        f.truncate(nbytes // 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fallback = ckpt.restore()
    fell_back = ckpt.last_restored_step == 2 and fallback is not None
    try:
        ckpt.restore(step=4)
        refused = False
    except ck.CheckpointIntegrityError:
        refused = True
    ckpt.close()
    del hm, opt, sched, restored, fallback, want, got
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    r = dict(async_save_s=times["async_save_s"],
             final_save_s=times["final_save_s"], bytes=nbytes,
             restore_s=restore_s)
    print(f"checkpoint gpt_1p3b {CKPT_LAYERS} layers: resumed run bit-equal "
          f"to the uninterrupted one {same} (parameters, slots, step, LR); "
          f"truncated step 4 falls back to step 2 {fell_back}, asked for "
          f"by number refused {refused}; async save returned in "
          f"{r['async_save_s']:.3f} s, final (blocking) save "
          f"{r['final_save_s']:.3f} s, {nbytes / 1e9:.3f} GB a step, "
          f"restore {restore_s:.3f} s [{card}]")
    if not (same and fell_back and refused):
        raise AssertionError("checkpoint resume, fallback or refusal failed")
    return r


def lbfgs_full(arrays, t, card):
    """Phase 12d: LBFGS (history 4, 3 iterations in one step) on gpt_1p3b
    at full width cut to LBFGS_LAYERS layers, f32, batch 1 x 2048, without
    and with the strong Wolfe line search, each from the seeded weights:
    the loss falls, and the state dict (with the history) round-trips into
    a second optimizer."""
    cfg = dataclasses.replace(t.gpt.gpt_1p3b(), num_layers=LBFGS_LAYERS)
    m = t.gpt.GPTForCausalLM(cfg, device="cuda")
    sub = {n: arrays[n] for n, _ in m.named_parameters()}
    ids = np.random.default_rng(43).integers(0, cfg.vocab_size, (1, SEQ + 1))
    ids = torch.as_tensor(ids, device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]
    out = {}
    for ls in (None, "strong_wolfe"):
        t.gpt.load_functional_state(m, sub)
        opt = t.optimizer.LBFGS(learning_rate=1.0, max_iter=3,
                                history_size=4, line_search_fn=ls,
                                parameters=m.named_parameters())

        def closure():
            opt.clear_grad()
            loss = m(x, y)
            loss.backward()
            return loss

        with torch.no_grad():
            first = float(m(x, y))
        t0 = time.perf_counter()
        last = float(opt.step(closure).detach())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sd = opt.state_dict()
        opt2 = t.optimizer.LBFGS(learning_rate=1.0, max_iter=3,
                                 history_size=4, line_search_fn=ls,
                                 parameters=m.named_parameters())
        opt2.set_state_dict(sd)
        trips = (len(opt2._s) == len(opt._s) > 0
                 and all(torch.equal(a, b) for a, b in zip(opt2._s, opt._s))
                 and all(torch.equal(a, b) for a, b in zip(opt2._y, opt._y)))
        print(f"lbfgs {ls or 'no line search'}: loss {first!r} -> {last!r} "
              f"in {secs:.2f} s, history {len(opt._s)} pairs, state dict "
              f"round-trips {trips} [{card}]")
        if not (np.isfinite(last) and last < first and trips):
            raise AssertionError(f"LBFGS {ls}: the loss must fall and the "
                                 "state dict round-trip")
        out[ls or "none"] = dict(first=first, last=last, seconds=secs)
        del opt, opt2, sd
        torch.cuda.empty_cache()
    del m
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 13
# speculative decoding on phase 6's engine shape: bf16 gpt_1p3b, 8 slots,
# prompts of 512, k 4. Wave 1's budgets differ by one token each; wave 2
# admits other lengths of wave 1's prefill bucket (385-512) and must build
# nothing; the edge request's budget ends exactly at max_model_len (2048)
SPEC_K, SPEC_SLOTS, SPEC_PLEN = 4, 8, 512
SPEC_NEWS = [48, 47, 46, 45, 44, 43, 42, 41]
SPEC_WAVE2 = ([400, 480, 390, 511, 450, 420, 500, 386],
              [9, 14, 7, 12, 10, 8, 11, 13])
SPEC_EDGE = (2048 - 21, 21)
SPEC_TRACED = 3  # iterations in the profiler's window
SPEC_F32 = (4, 2)  # the f32 wave's target and draft depths
SPEC_F32_LENS = ([5, 700, 37, 129, 16, 300, 64, 511],
                 [16, 23, 9, 30, 17, 12, 26, 21])
SPEC_RAN = ("steps", "prefills", "chunks", "suffix", "decode_builds",
            "prefill_builds", "chunk_builds", "iters", "spec_builds",
            "draft_prefills", "draft_builds")


def spec_draft_config(gpt, layers):
    return dataclasses.replace(gpt.gpt_base(max_position_embeddings=2048),
                               num_layers=layers)


def spec_draft(gpt, dtype, seed, layers=12):
    """A ``gpt_base``-width draft (hidden 768, 12 heads of 64: the decode
    kernel at head dim 64) with ``gpt_1p3b``'s vocabulary of 50304 and 2048
    positions, seeded random weights, ``layers`` deep."""
    draft = gpt.GPTForCausalLM(spec_draft_config(gpt, layers), device="cuda")
    gpt.load_functional_state(draft, seeded(gpt, draft, "draft", seed))
    return draft.to(dtype)


def spec_ran(eng):
    """``ran_counts`` and what the speculative sidecar ran: its iterations
    (one replay of the speculative step each), its step's builds, the draft
    prefills and their builds."""
    sp = eng.spec
    extra = ((sp.iterations, sp.spec_traces, sp.draft_prefills,
              sum(sp.draft_prefill_traces.values())) if sp is not None
             else (0, 0, 0, 0))
    return ran_counts(eng) + extra


def want_spec_launches(layers, d_layers, k, ran, draft, quant_kv=False):
    """The exact launches of a speculative run: ``want_launches`` of the
    plain programs (prefills, chunks, fallback decode steps), plus per
    replay and per warm-up of the speculative step k target sub-steps in
    lockstep, or k + 1 target and k draft sub-steps with a draft (the
    decode kernel, its int8 form over a ``quant_kv`` arena, whose chunks
    take the int8 prefill kernel), and one greedy pick per sub-step
    (sampling kernel: k, or 2k + 1); plus each draft prefill's and each
    draft prefill warm-up's ``d_layers`` full-prefill launches."""
    decode = "paged_decode_attention" + ("_int8" if quant_kv else "")
    want = want_launches(layers, ran, decode=decode, chunk=(
        "paged_prefill_attention_int8" if quant_kv else None))
    runs = ran.iters + ran.spec_builds
    want[decode] += runs * (
        (k + 1) * layers + k * d_layers if draft else k * layers)
    want["paged_prefill_attention"] += d_layers * (ran.draft_prefills
                                                   + ran.draft_builds)
    want["sample_tokens"] += runs * (2 * k + 1 if draft else k)
    return want


def traced_window(sched, n, attention_per_step):
    """``n`` scheduler steps under ``torch.profiler`` (and CUDA events
    around every graph replay): per step, the host range, the device busy
    time (the union of the kernels' intervals when the trace shows the
    graphs' attention kernels, else the replays' event time) and the idle
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.tools.profile_decode import _ReplayTimer, _union_us

    torch.cuda.synchronize()
    with _ReplayTimer() as timer, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("spec_window"):
                sched.step()
    events = prof.events()
    ranges = [e.time_range for e in events
              if e.name == "spec_window" and e.device_type == DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name != "spec_window"]
    window_us = sum(r.end - r.start for r in ranges)
    if sum("decode" in e.name for e in kernels) >= attention_per_step * n:
        method = "profiler intervals"
        busy_us = _union_us((e.time_range.start, e.time_range.end)
                            for e in kernels)
    else:
        method = "CUDA events around each replay"
        busy_us = timer.ms() * 1e3
    return dict(window_ms=window_us / n / 1e3, busy_ms=busy_us / n / 1e3,
                busy_method=method, idle_share=1.0 - busy_us / window_us)


def spec_serve(api, pa, so, prompts, news, what, card, trace=None,
               submit_kw=None):
    """Serve ``prompts`` (launch counters at 0 just before, read just after)
    by stepping the scheduler: the host clock of every full step (all
    SPEC_SLOTS lanes decoding, nothing waiting) and the tokens it emitted;
    with ``trace`` (attention launches per step) a profiler window of
    SPEC_TRACED full steps after the third, outside those clocks;
    ``submit_kw`` gives each request's other ``submit`` arguments. Every
    request must finish with its budget, every block be free, the arena's
    invariants hold. Returns the requests, the launches, what ran
    (``spec_ran`` by SPEC_RAN) and the timing."""
    from paddle_tpu_torch.serving import RequestState

    eng, sched = api.engine, api.scheduler
    before = spec_ran(eng)
    pa.reset_launches()
    so.reset_launches()
    t0 = time.perf_counter()
    submit_kw = submit_kw or [{}] * len(prompts)
    reqs = [api.submit(p, max_new_tokens=n, **kw)
            for p, n, kw in zip(prompts, news, submit_kw)]
    step_s, step_tok, traced = [], [], None
    while sched.has_work():
        full = (not sched.waiting and not sched.prefilling
                and eng.active_slots() == SPEC_SLOTS)
        if full and trace and traced is None and len(step_s) >= 3:
            traced = traced_window(sched, SPEC_TRACED, trace)
            continue
        n0 = sum(len(r.tokens) for r in reqs)
        t1 = time.perf_counter()
        sched.step()  # ends in a device-to-host copy of the tokens
        if full:
            step_s.append(time.perf_counter() - t1)
            step_tok.append(sum(len(r.tokens) for r in reqs) - n0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.launches) | dict(so.launches)
    ran = types.SimpleNamespace(**dict(zip(
        SPEC_RAN, (a - b for a, b in zip(spec_ran(eng), before)))))
    for r, n in zip(reqs, news):
        if r.state != RequestState.FINISHED or len(r.tokens) != n:
            raise AssertionError(f"{what} {r.request_id}: {r.state} "
                                 f"{len(r.tokens)}/{n} {r.error!r}")
    eng.check_invariants()
    if eng.arena.blocks_in_use() != 0:
        raise AssertionError(f"{what}: blocks still in use")
    timing = dict(wall_s=wall, full_steps=len(step_s))
    if step_s:
        timing.update(step_ms=float(np.median(step_s)) * 1e3,
                      tokens_per_step=float(np.mean(step_tok)),
                      tokens_per_s=float(sum(step_tok) / sum(step_s)))
    if traced is not None:
        timing["traced"] = traced
        if step_s:
            # the traced busy time over the untraced host step: the
            # profiler's own cost inflates the traced window's host time
            timing["untraced_idle_share"] = 1.0 - traced["busy_ms"] / \
                timing["step_ms"]
    print(f"e2e {what}: {len(reqs)} requests in {wall:.2f} s, ran "
          f"{vars(ran)}, full steps: median {timing.get('step_ms', 0):.3f} ms"
          f" host, {timing.get('tokens_per_step', 0):.2f} tokens/step, "
          f"{timing.get('tokens_per_s', 0):.1f} tokens/s"
          + (f", traced {traced}" if traced else "") + f" [{card}]")
    return reqs, launches, ran, timing


def hold_streams(reqs, want, what, card, ref="the spec-off engine's"):
    """Every request's tokens must equal ``want`` (lists of tokens), the
    streams of ``ref``."""
    for i, (r, w) in enumerate(zip(reqs, want)):
        got = list(r.tokens)
        if got != list(w):
            j = next((j for j, (a, b) in enumerate(zip(got, w)) if a != b),
                     min(len(got), len(w)))
            raise AssertionError(f"{what}: request {i} diverges from {ref} "
                                 f"at token {j}: {got[:j + 2]} vs "
                                 f"{list(w)[:j + 2]}")
    print(f"e2e {what}: the streams of all {len(reqs)} requests equal "
          f"{ref} [{card}]")


SPEC_REPLAYED = 5  # the speculative run replayed again after wave 1


def record_spec_run(eng):
    """Wrap the engine's run helper to keep the values and outputs of the
    SPEC_REPLAYED-th run of the speculative step, and the draft positions
    and tables of the first and the last run (copies: the engine's arrays
    move on). Returns the record and the unwrapped helper."""
    run, seen, count = eng._run, {}, [0]

    def recording(prog, *args, **values):
        out = run(prog, *args, **values)
        if prog.key == "spec":
            count[0] += 1
            lanes = {k: np.array(values[k], copy=True)
                     for k in ("d_pos", "d_bt") if k in values}
            seen.setdefault("first", lanes)
            seen["last"] = lanes
            if count[0] == SPEC_REPLAYED:
                seen["values"] = {k: np.array(v, copy=True)
                                  for k, v in values.items()}
                seen["out"] = [np.array(o, copy=True) for o in out]
        return out

    eng._run = recording
    return seen, run


def hold_spec_replays(eng, seen, run, what, card):
    """Replay the recorded speculative run twice on its own values once
    its wave has ended (no block reused yet): each replay rewrites the
    positions it reads past the context, so both must give the recorded
    outputs bit for bit (the decode kernel's workspace and ticket counters
    reused by every launch of the graph, cuBLAS's picks) in every lane
    that run served. A lane it did not serve (a slot still prefilling in
    chunks) reads blocks that later chunks wrote: its outputs, discarded
    by the host, are not held."""
    eng._run = run
    prog = eng._graphs.programs["spec"]
    live = seen["values"]["t_rows"][0] != 0  # block 0 is the scratch block
    if not live.any():
        raise AssertionError(f"{what}: speculative run {SPEC_REPLAYED} "
                             "served no lane")
    for i in range(2):
        out = run(prog, None, "serving.spec_step", **seen["values"])
        if not all(np.array_equal(np.asarray(a)[live], b[live])
                   for a, b in zip(out, seen["out"])):
            raise AssertionError(f"{what}: replay {i} of speculative run "
                                 f"{SPEC_REPLAYED} differs from it")
    print(f"e2e {what}: speculative run {SPEC_REPLAYED} ({int(live.sum())} "
          f"lanes) replayed twice on its own values, both bit-equal to it "
          f"[{card}]")


def hold_draft_kernels(pa, eng, seen, what, card):
    """The draft's own attention launches held against their plain
    versions at the shapes the main path gave them (a wrong draft kernel
    would only lower acceptance, which the streams cannot see): the decode
    kernel over the draft namespace's pools -- its int8 form over a
    ``quant_kv`` arena -- at every layer, each draft sub-step's positions
    and the draft tables of the wave's first and last speculative runs
    (``record_spec_run``; the pools still hold the wave's K/V), a fresh
    bf16 query per launch; and the full prefill of the draft prefill
    buckets (SPEC_PLEN and 2048 queries). TOL's bf16 bar, row bound
    included; non-finite output fails it."""
    pools = eng.arena.ns_pools("draft")
    dec = "paged_decode_attention" + ("_int8" if len(pools[0]) == 4 else "")
    _, bs, h, d = pools[0][0].shape
    dt, rng = torch.bfloat16, np.random.default_rng(45)
    got, positions = {dec: [], "paged_full_prefill_attention": []}, set()
    for key in ("first", "last"):
        bt = torch.as_tensor(seen[key]["d_bt"], device="cuda")
        for pos in seen[key]["d_pos"]:
            positions.update(int(p) for p in pos)
            pos = torch.as_tensor(pos, device="cuda")
            for entry in pools:
                q = randn(rng, (bt.shape[0], h, d), dt)
                got[dec].append(readings(
                    pa.paged_decode_attention(q, entry, bt, pos),
                    pa.paged_decode_attention_ref(q, entry, bt, pos),
                    TOL[dt]))
    for sq in (SPEC_PLEN, 2048):
        q, k, v = qkv_split(rng, sq, h, d, dt)
        out = pa.paged_full_prefill_attention(q, k, v, bs)
        ref = pa.paged_full_prefill_attention_ref(q, k, v, bs)
        if out.shape != ref.shape:
            raise AssertionError(f"{what}: draft prefill shape "
                                 f"{tuple(out.shape)} != {tuple(ref.shape)}")
        got["paged_full_prefill_attention"].append(readings(out, ref,
                                                            TOL[dt]))
    for name, seen_r in got.items():
        worst = max(seen_r, key=lambda r: r[1])
        ok = all(r[3] for r in seen_r)
        print(f"check {what}, the draft's {name} (H {h}, D {d}, "
              + (f"S {bt.shape[0]}, positions {min(positions)}-"
                 f"{max(positions)}" if name == dec else
                 f"{SPEC_PLEN} and 2048 queries")
              + f"): {len(seen_r)} launches, worst {worst[4]} "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            bad = [r[4] for r in seen_r if not r[3]]
            raise AssertionError(f"{what}: the draft's {name} disagrees with "
                                 f"its plain version: {bad[:3]}")


def build_bytes(eng, key):
    """Wrap the engine's run helper: at the run that builds program
    ``key`` (its warm-up and capture), the peak bytes allocated above what
    was allocated before it -- the step's own working set, which its graph
    takes from the shared pool, whether or not an earlier capture left
    room there. Returns the dict it fills under ``key``."""
    run, got = eng._run, {}

    def measuring(prog, *args, **values):
        if prog.key != key or prog.built:
            return run(prog, *args, **values)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = run(prog, *args, **values)
        torch.cuda.synchronize()
        got[key] = torch.cuda.max_memory_allocated() - before
        return out

    eng._run = measuring
    return got


def spec_engine(model, serving, draft=None, **kw):
    return serving.ServingAPI(model, serving.ServingConfig(
        num_slots=SPEC_SLOTS, spec_k=SPEC_K, draft_model=draft, **kw),
        device="cuda")


def spec_mode(model, serving, pa, so, waves, base, name, draft, card,
              quant=False, d_layers=0, quant_kv=False):
    """One speculative mode on ``waves`` (wave 1; with ``draft`` of
    gpt_base width also wave 2 and the faults, and without ``quant_kv`` the
    edge request): streams equal to the spec-off engine's (``base``; with
    ``quant_kv`` the int8 arena's, both prefilling in chunks of CHUNK),
    exact launches, the draft's own kernels held to their plain versions
    (``hold_draft_kernels``), one speculative graph and one draft prefill
    graph per bucket, each built once, and nothing built by wave 2.
    Returns the timing, the launches and the memory readings."""
    from paddle_tpu_torch.core import compile_cache, memory_stats

    layers = model.cfg.num_layers
    kv = dict(quant_kv=True, chunked_prefill=CHUNK) if quant_kv else {}
    api = spec_engine(model, serving, draft, quant_draft=quant, **kv)
    eng = api.engine
    sp = eng.spec
    attn = (SPEC_K + 1) * layers + SPEC_K * d_layers if draft else \
        SPEC_K * layers
    what = f"bf16 spec {name}"
    built_bytes = build_bytes(eng, "spec")
    seen, run = record_spec_run(eng)
    reqs, launches, ran, timing = spec_serve(api, pa, so, *waves["w1"], what,
                                             card, trace=attn)
    hold_streams(reqs, base["kv8" if quant_kv else "w1"], what, card)
    hold_launches(launches, want_spec_launches(layers, d_layers, SPEC_K, ran,
                                               draft is not None, quant_kv),
                  f"{what} (decode {attn} a speculative replay)")
    drafting = draft is not None and name != "tied draft"
    if drafting:
        hold_draft_kernels(pa, eng, seen, what, card)
    hold_spec_replays(eng, seen, run, what, card)
    out = dict(timing, acceptance=sp.acceptance_rate(),
               iterations=ran.iters, spec_build_bytes=built_bytes["spec"],
               pool_bytes=eng.stats()["programs.pool_bytes"],
               launches=launches, mode=sp.mode())
    if drafting:
        line = [ln for ln in memory_stats.memory_summary().splitlines()
                if "kv_arena_draft_bytes" in ln]
        print(f"memory_summary, {what}: {line[0].strip()} [{card}]")
        out["draft_line"] = line[0].strip()
    if name == "draft":
        built = (sp.spec_traces, dict(sp.draft_prefill_traces),
                 dict(eng.prefill_traces), eng.decode_traces,
                 eng.stats()["programs.graphs"], decode_compiles())
        reqs, launches, ran, _ = spec_serve(api, pa, so, *waves["w2"],
                                            what + ", wave 2", card)
        hold_streams(reqs, base["w2"], what + ", wave 2", card)
        hold_launches(launches, want_spec_launches(
            layers, d_layers, SPEC_K, ran, True), what + ", wave 2")
        now = (sp.spec_traces, dict(sp.draft_prefill_traces),
               dict(eng.prefill_traces), eng.decode_traces,
               eng.stats()["programs.graphs"], decode_compiles())
        bucket = compile_cache.prefill_bucket(
            SPEC_PLEN, eng.max_model_len, eng.prefill_bucket_min)
        if now != built or built[0] != 1 or built[1] != {bucket: 1}:
            raise AssertionError(f"{what}: builds before wave 2 {built}, "
                                 f"after {now}")
        print(f"programs {what}: one speculative graph, draft prefill "
              f"builds {built[1]}, prefill builds {built[2]}, decode builds "
              f"{built[3]}, {built[4]} CUDA graphs; wave 2 built nothing "
              f"[{card}]")
    if (draft is None or drafting) and not quant_kv:
        reqs, launches, ran, _ = spec_serve(api, pa, so, *waves["edge"],
                                            what + ", edge", card)
        hold_streams(reqs, base["edge"], what + ", edge (budget ends at "
                     "max_model_len 2048)", card)
        hold_launches(launches, want_spec_launches(
            layers, d_layers, SPEC_K, ran, draft is not None), what + ", edge")
    api.close()
    return out


def spec_faults(api, wave, want, what, card):
    """On a draft engine: a ``serving_device`` fault at a speculative
    step's run (all 8 running), recovered by rebuild and replay (each replay
    prefills its draft cache again): the streams equal ``want``, one
    rebuild, the pools (both namespaces) in place, the speculative step not
    built again. Then two ``serving_step`` faults (OSError) at a
    speculative run, retried inside it: no rebuild, the streams equal. In
    f32: a replay prefills the journal, and in bf16 the prefill's K/V are
    not bit for bit the decode steps' (so a bf16 replay may part from the
    uninterrupted stream, with or without speculation)."""
    from paddle_tpu_torch.core import flags, resilience
    from paddle_tpu_torch.serving import RequestState

    eng, sched = api.engine, api.scheduler
    keep = flags.get_flags(["fault_injection", "io_retry_backoff"])
    flags.set_flags({"fault_injection": 1, "io_retry_backoff": 0.001})
    ptrs = lambda: [t.data_ptr() for pools in (  # noqa: E731
        eng.arena.pools, eng.arena.ns_pools("draft")) for e in pools
        for t in e]
    out = {}
    try:
        p0, spec0 = ptrs(), eng.spec.spec_traces
        rb0 = resilience.stats().get("serving.rebuilds", 0)
        reqs = [api.submit(p, max_new_tokens=n) for p, n in zip(*wave)]
        for _ in range(3):
            sched.step()
        if not all(r.state == RequestState.RUNNING for r in reqs):
            raise AssertionError(f"{what}: not all 8 running at the fault")
        resilience.inject_fault("serving_device", times=1)
        t0 = time.perf_counter()
        api.run_until_idle()
        out["device_fault_s"] = time.perf_counter() - t0
        hold_streams(reqs, want, what + ", serving_device fault mid-verify",
                     card, "generate()'s")
        rb = resilience.stats().get("serving.rebuilds", 0) - rb0
        if rb != 1 or ptrs() != p0 or eng.spec.spec_traces != spec0:
            raise AssertionError(f"{what}: {rb} rebuilds, pools moved "
                                 f"{ptrs() != p0}, spec builds "
                                 f"{eng.spec.spec_traces}")
        r0 = resilience.stats().get("retry.serving.spec_step", 0)
        reqs = [api.submit(p, max_new_tokens=n) for p, n in zip(*wave)]
        for _ in range(2):
            sched.step()
        resilience.inject_fault("serving_step", times=2,
                                exc=OSError("injected serving_step fault"))
        api.run_until_idle()
        hold_streams(reqs, want, what + ", serving_step fault retried", card,
                     "generate()'s")
        retried = resilience.stats().get("retry.serving.spec_step", 0) - r0
        rb = resilience.stats().get("serving.rebuilds", 0) - rb0
        if retried != 2 or rb != 1:
            raise AssertionError(f"{what}: {retried} retries, {rb} rebuilds "
                                 "(want 2 and still 1)")
        print(f"e2e {what}: serving_device fault mid-verify recovered "
              f"(1 rebuild, pools in place, the speculative graph kept) in "
              f"{out['device_fault_s']:.2f} s; serving_step fault retried "
              f"twice, no rebuild [{card}]")
    finally:
        flags.set_flags(keep)
        resilience.clear_faults()
    return out


def spec_f32(gpt, serving, pa, so, arrays, card):
    """Phase 13's f32 wave (TF32 off) at a cut depth: gpt_1p3b's width at
    SPEC_F32[0] layers, lockstep and a gpt_base-width draft of SPEC_F32[1]
    layers, every stream equal to ``generate()``, the launches exact; then
    the faults on the draft engine (``spec_faults``). Returns what they
    measured."""
    layers, d_layers = SPEC_F32
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=layers)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    draft = spec_draft(gpt, torch.float32, 3, d_layers)
    rng = np.random.default_rng(41)
    lens, news = SPEC_F32_LENS
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    want = [model.generate(p[None], max_new_tokens=n)[0, len(p):].tolist()
            for p, n in zip(prompts, news)]
    for name, d in (("lockstep", None), ("draft", draft)):
        api = spec_engine(model, serving, d)
        what = f"f32 spec {name} ({layers} layers)"
        reqs, launches, ran, _ = spec_serve(api, pa, so, prompts, news, what,
                                            card)
        hold_launches(launches, want_spec_launches(
            layers, d_layers if d is not None else 0, SPEC_K, ran,
            d is not None), what)
        hold_streams(reqs, want, what, card, "generate()'s")
        if d is not None:
            faults = spec_faults(api, (prompts, news), want, what, card)
        api.close()
    del model, draft
    torch.cuda.empty_cache()
    return faults


def serve_spec(gpt, serving, pa, so, arrays, card):
    """Phase 13: speculative decoding on bf16 gpt_1p3b (8 slots, prompts of
    512, k 4): a spec-off engine's streams and decode step first, then
    lockstep, a gpt_base-width draft (with wave 2, the max_model_len edge
    and the faults), the same draft with ``quant_draft``, and a tied draft
    (the target itself: acceptance 1), each held to the spec-off streams
    with exact launches; then the f32 wave against ``generate()``. Prints
    each mode's host and traced-busy times beside the plain decode step's,
    tokens/s, acceptance, the speculative graph's pool bytes beside the
    decode graph's and ``memory_summary()``'s draft line. Returns the
    draft mode's launches and the times."""
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    model.to(torch.bfloat16)
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    rng = np.random.default_rng(40)
    waves = {"w1": ([rng.integers(0, vocab, SPEC_PLEN)
                     for _ in SPEC_NEWS], SPEC_NEWS),
             "w2": ([rng.integers(0, vocab, n) for n in SPEC_WAVE2[0]],
                    SPEC_WAVE2[1]),
             "edge": ([rng.integers(0, vocab, SPEC_EDGE[0])],
                      [SPEC_EDGE[1]])}
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=SPEC_SLOTS), device="cuda")
    built_bytes = build_bytes(api.engine, "decode")
    base, times = {}, {}
    for key, (prompts, news) in waves.items():
        reqs, launches, ran, timing = spec_serve(
            api, pa, so, prompts, news, f"bf16 spec off, {key}", card,
            trace=layers if key == "w1" else None)
        hold_launches(launches, want_launches(layers, ran),
                      f"bf16 spec off, {key}")
        base[key] = [list(r.tokens) for r in reqs]
        if key == "w1":
            times["spec off"] = dict(
                timing, decode_build_bytes=built_bytes["decode"],
                pool_bytes=api.engine.stats()["programs.pool_bytes"])
    api.close()
    # the int8 arena's spec-off streams, prefilled in chunks
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=SPEC_SLOTS, quant_kv=True, chunked_prefill=CHUNK),
        device="cuda")
    reqs, launches, ran, _ = spec_serve(api, pa, so, *waves["w1"],
                                        "bf16 spec off, quant_kv", card)
    hold_launches(launches, want_launches(
        layers, ran, decode="paged_decode_attention_int8",
        chunk="paged_prefill_attention_int8"), "bf16 spec off, quant_kv")
    base["kv8"] = [list(r.tokens) for r in reqs]
    api.close()
    torch.cuda.empty_cache()
    draft = spec_draft(gpt, torch.bfloat16, 1)
    d_layers = draft.cfg.num_layers
    times["lockstep"] = spec_mode(model, serving, pa, so, waves, base,
                                  "lockstep", None, card)
    times["draft"] = spec_mode(model, serving, pa, so, waves, base, "draft",
                               draft, card, d_layers=d_layers)
    times["draft, quant_kv"] = spec_mode(
        model, serving, pa, so, waves, base, "draft, quant_kv", draft, card,
        d_layers=d_layers, quant_kv=True)
    del draft
    torch.cuda.empty_cache()
    times["draft-int8"] = spec_mode(
        model, serving, pa, so, waves, base, "draft-int8",
        spec_draft(gpt, torch.bfloat16, 1), card, quant=True,
        d_layers=d_layers)
    torch.cuda.empty_cache()
    times["tied draft"] = spec_mode(model, serving, pa, so, waves, base,
                                    "tied draft", model, card,
                                    d_layers=layers)
    if times["tied draft"]["acceptance"] != 1.0:
        raise AssertionError(f"tied draft acceptance "
                             f"{times['tied draft']['acceptance']}")
    del model
    torch.cuda.empty_cache()
    off = times["spec off"]
    for name, t in times.items():
        tr = t["traced"]
        acc = t.get("acceptance")
        print(f"bf16 spec {name}: full step {t['step_ms']:.3f} ms host "
              f"({t['step_ms'] / off['step_ms']:.3f} x the plain decode "
              f"step), traced busy {tr['busy_ms']:.3f} ms "
              f"({tr['busy_method']}; plain {off['traced']['busy_ms']:.3f} "
              f"ms), idle share {t['untraced_idle_share']:.3f} of the "
              f"untraced step ({tr['idle_share']:.3f} traced), "
              f"{t['tokens_per_step']:.2f} tokens/step, "
              f"{t['tokens_per_s']:.1f} tokens/s ("
              f"{t['tokens_per_s'] / off['tokens_per_s']:.3f} x), acceptance "
              + ("n/a" if acc is None else f"{acc:.4f}") + ", the engine's "
              f"graph pool {t['pool_bytes']} bytes (spec off "
              f"{off['pool_bytes']}); its step's build peaked "
              f"{t.get('spec_build_bytes', t.get('decode_build_bytes'))} "
              f"bytes above what was allocated before it (the decode "
              f"step's {off['decode_build_bytes']}) [{card}]")
    faults = spec_f32(gpt, serving, pa, so, arrays, card)
    summary = {name: {k: v for k, v in t.items() if k != "launches"}
               for name, t in times.items()}
    summary["f32 faults"] = faults
    print("bf16 speculative decoding, one call: " + json.dumps(summary)
          + f" [{card}]")
    # the int8 rows' speculative launches are the quant_kv draft wave's
    launches = dict(times["draft"]["launches"])
    for name in PAGED[2:]:
        launches[name] = times["draft, quant_kv"]["launches"][name]
    return launches, summary


# ------------------------------------------------------------------ phase 14
# multi-LoRA and the tiered KV cache on phase 6's engine shape: bf16
# gpt_1p3b, 8 slots, prompts of 512. 14a: adapters of rank 16 in an arena of
# 4 (5 rows of 48 MiB), three registered from numpy seeds, one wave with
# ids 0-3 on two lanes each; 14b: the same in f32 at 4 layers against
# generate() under the arena's binding; 14c: the prefix cache over host and
# disk tiers, an arena that a pressure wave empties
LORA_RANK, LORA_CAP, LORA_SCALE = 16, 4, 0.25
LORA_SEEDS = (141, 142, 143, 144)  # three registered; the fourth replaces 2
LORA_PLEN, LORA_NEW = 512, 48
LORA_IDS = [0, 1, 2, 3, 0, 1, 2, 3]
LORA_F32 = (4, [5, 700, 37, 129, 16, 300, 64, 511],
            [16, 23, 9, 30, 17, 12, 26, 21])
# 14c: every prompt is one shared 512-token prefix (32 blocks of 16) and a
# private tail shorter than a block, so a chain is exactly the prefix; a
# primer (request 0 alone, a miss) fills the cache first, so every request
# of waves A and B attaches the same prefix bytes and prefills its tail
TIER_PREFIX, TIER_TAIL, TIER_NEW, TIER_BLOCK = 512, 15, 64, 16
# the pressure wave: 15-token prompts (no full block to insert) whose
# 572-token budgets reserve 37 blocks each, the whole arena, so the last
# admissions evict every cached block; cancelled once admitted
TIER_PRESSURE = (15, 572)
TIER_TIMED, TIER_DISK_TIMED = 5, 3  # first-token samples per kind
TIER_SUFFIX = 64  # the timed prompts: prefix 512 + a fresh suffix of 64


def lora_adapter(serving, cfg, seed):
    """A dense random adapter of rank LORA_RANK over every site of ``cfg``,
    drawn from numpy's ``default_rng(seed)``."""
    return serving.LoraAdapter.random(cfg, rank=LORA_RANK, seed=seed,
                                      scale=LORA_SCALE, name=f"seed-{seed}")


def lora_engine(model, serving, lora=True):
    cfg = dict(num_slots=SPEC_SLOTS)
    if lora:
        cfg.update(lora_rank=LORA_RANK, lora_adapters=LORA_CAP)
    return serving.ServingAPI(model, serving.ServingConfig(**cfg),
                              device="cuda")


def print_step(what, t, base, card):
    tr = t["traced"]
    print(f"{what}: decode step {t['step_ms']:.3f} ms host "
          f"({t['step_ms'] / base['step_ms']:.3f} x the no-arena engine's), "
          f"traced busy {tr['busy_ms']:.3f} ms ({tr['busy_method']}; no "
          f"arena {base['traced']['busy_ms']:.3f} ms), idle share "
          f"{t['untraced_idle_share']:.3f} of the untraced step "
          f"({tr['idle_share']:.3f} traced), {t['tokens_per_s']:.1f} "
          f"tokens/s [{card}]")


def serve_lora_bf16(model, serving, pa, so, card):
    """Phase 14a: a no-arena engine's streams and decode step, then an
    engine with an adapter arena: its decode step with 0 live adapters,
    three adapters registered, one wave with ids 0-3 on two lanes each
    (the id-0 lanes equal the no-arena engine's, each adapter lane its
    request served alone on the same engine, the launches exact, each
    adapter changing at least one token), a second wave after an
    unregister and a fresh register that reuses the row and builds
    nothing, and the decode step with 3 and with 1 live adapters. Returns
    wave 1's launches and the times."""
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(50)
    prompts = [rng.integers(0, vocab, LORA_PLEN) for _ in LORA_IDS]
    news = [LORA_NEW] * len(prompts)
    kw = [{"adapter": a} for a in LORA_IDS]
    times = {}
    api = lora_engine(model, serving, lora=False)
    reqs, launches, ran = serve(api, pa, prompts, news,
                                "bf16 lora, no arena", card)
    hold_launches(launches, want_launches(layers, ran), "bf16 lora, no arena")
    base = [list(r.tokens) for r in reqs]
    times["no arena"] = spec_serve(api, pa, so, prompts, news,
                                   "bf16 lora timing, no arena", card,
                                   trace=layers)[3]
    api.close()
    torch.cuda.empty_cache()

    api = lora_engine(model, serving)
    eng = api.engine
    arena_bytes = eng.lora.bytes_total()
    row = arena_bytes // (LORA_CAP + 1)
    print(f"bf16 lora arena: rank {LORA_RANK}, {LORA_CAP} rows + the "
          f"identity, {LORA_CAP + 1} rows of {row / 2 ** 20:.1f} MiB "
          f"({arena_bytes} bytes) [{card}]")
    times["arena, 0 live"] = spec_serve(api, pa, so, prompts, news,
                                        "bf16 lora timing, 0 live", card,
                                        trace=layers)[3]
    t0 = time.perf_counter()
    ids = [api.register_adapter(lora_adapter(serving, model.cfg, s))
           for s in LORA_SEEDS[:3]]
    print(f"bf16 lora: 3 adapters drawn and registered in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    if ids != [1, 2, 3]:
        raise AssertionError(f"adapter ids {ids}, not 1, 2, 3")
    what = "bf16 lora wave 1"
    reqs, launches, ran = serve(api, pa, prompts, news, what, card, kw)
    hold_launches(launches, want_launches(layers, ran), what)
    got = [list(r.tokens) for r in reqs]
    changed = {a: 0 for a in ids}
    for i, a in enumerate(LORA_IDS):
        if a == 0:
            hold_streams([reqs[i]], [base[i]], f"{what}, lane {i} (id 0)",
                         card, "the no-arena engine's")
        else:
            changed[a] += sum(x != y for x, y in zip(got[i], base[i]))
    print(f"{what}: tokens each adapter changes against the base stream "
          f"over its two lanes: {changed} [{card}]")
    if min(changed.values()) < 1:
        raise AssertionError(f"{what}: an adapter changed no token: "
                             f"{changed}")
    built = builds(eng)
    for i, a in enumerate(LORA_IDS):
        if a:
            solo, _, _ = serve(api, pa, [prompts[i]], [LORA_NEW],
                               f"{what}, lane {i} alone", card, [kw[i]])
            hold_streams(solo, [got[i]], f"{what}, lane {i} (id {a}) alone",
                         card, "its lane's in the wave")
    api.unregister_adapter(2)
    if api.register_adapter(lora_adapter(serving, model.cfg,
                                         LORA_SEEDS[3])) != 2:
        raise AssertionError("the re-registered adapter did not reuse row 2")
    what = "bf16 lora wave 2 (row 2 re-registered)"
    reqs2, launches2, ran2 = serve(api, pa, prompts, news, what, card, kw)
    hold_launches(launches2, want_launches(layers, ran2), what)
    for i, a in enumerate(LORA_IDS):
        if a != 2:
            hold_streams([reqs2[i]], [got[i]], f"{what}, lane {i}", card,
                         "wave 1's")
        else:
            solo, _, _ = serve(api, pa, [prompts[i]], [LORA_NEW],
                               f"{what}, lane {i} alone", card, [kw[i]])
            hold_streams(solo, [list(reqs2[i].tokens)],
                         f"{what}, lane {i} alone", card, "its lane's")
    if builds(eng) != built:
        raise AssertionError(f"bf16 lora: builds {builds(eng)} after the "
                             f"first wave's {built}")
    times["arena, 3 live"] = spec_serve(api, pa, so, prompts, news,
                                        "bf16 lora timing, 3 live", card,
                                        trace=layers, submit_kw=kw)[3]
    api.unregister_adapter(2)
    api.unregister_adapter(3)
    one = [{"adapter": i % 2} for i in range(len(prompts))]
    times["arena, 1 live"] = spec_serve(api, pa, so, prompts, news,
                                        "bf16 lora timing, 1 live", card,
                                        trace=layers, submit_kw=one)[3]
    if builds(eng) != built:
        raise AssertionError("bf16 lora: the timing waves built a program")
    api.close()
    torch.cuda.empty_cache()
    for name, t in times.items():
        print_step(f"bf16 lora {name}", t, times["no arena"], card)
    return launches, times


def serve_lora_f32(gpt, serving, pa, so, arrays, card):
    """Phase 14b (TF32 off): gpt_1p3b's width cut to LORA_F32[0] layers, an
    arena with three adapters, 8 requests with ids 0-3, greedy and sampled
    by turns: each adapter's streams equal ``generate()`` of the same model
    under the arena's binding for that one id (a sampled draw within
    SERVED_BOUNDARY of its interval excepted, ``hold_served_tokens``), the
    launches exact."""
    from paddle_tpu_torch.serving import SamplingParams
    from paddle_tpu_torch.tools.profile_decode import SAMPLED

    layers, lens, news = LORA_F32
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=layers)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    api = lora_engine(model, serving)
    for s in LORA_SEEDS[:3]:
        api.register_adapter(lora_adapter(serving, cfg, s))
    rng = np.random.default_rng(51)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    kw = [dict(adapter=a, **({"sampling": SamplingParams(**SAMPLED,
                                                         seed=60 + i)}
                             if i % 2 else {}))
          for i, a in enumerate(LORA_IDS)]
    what = f"f32 lora ({layers} layers)"
    reqs, launches, ran = serve(api, pa, prompts, news, what, card, kw)
    hold_launches(launches, want_launches(layers, ran), what)
    device = model.gpt.wte.weight.device
    for a in sorted(set(LORA_IDS)):
        idx = [i for i, b in enumerate(LORA_IDS) if b == a]
        with api.engine.lora.bind(torch.tensor([a], device=device)):
            hold_served_tokens(api, model, [prompts[i] for i in idx],
                               [reqs[i] for i in idx],
                               [news[i] for i in idx], [kw[i] for i in idx],
                               f"{what}, adapter {a} against generate() "
                               "under its binding", card)
    api.close()
    del model
    torch.cuda.empty_cache()


def tier_prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, TIER_PREFIX)
    return rng, [np.concatenate([prefix, rng.integers(0, vocab, TIER_TAIL)])
                 for _ in range(SPEC_SLOTS)]


def tier_engine(model, serving, store, quant_kv=False):
    """An engine whose arena one wave of SPEC_SLOTS x (prompt + TIER_NEW)
    fills: the pressure wave then evicts every cached block."""
    per = -(-(TIER_PREFIX + TIER_TAIL + TIER_NEW) // TIER_BLOCK)
    return serving.ServingAPI(model, serving.ServingConfig(
        num_slots=SPEC_SLOTS, kv_block_size=TIER_BLOCK, prefix_cache=True,
        kv_tiering=True, tier_store=store, quant_kv=quant_kv,
        num_blocks=SPEC_SLOTS * per + 1), device="cuda")


def tier_pressure(api, rng, vocab, chain, what):
    """The pressure wave (TIER_PRESSURE), cancelled once admitted; every
    node of ``chain`` must be spilled after it."""
    from paddle_tpu_torch.serving import RequestState

    sched = api.scheduler
    reqs = [api.submit(rng.integers(0, vocab, TIER_PRESSURE[0]),
                       max_new_tokens=TIER_PRESSURE[1])
            for _ in range(SPEC_SLOTS)]
    while sched.waiting or sched.prefilling:
        sched.step()
    for r in reqs:
        r.cancel()
    api.run_until_idle()
    if any(r.state != RequestState.CANCELLED for r in reqs):
        raise AssertionError(f"{what}: pressure wave {[r.state for r in reqs]}")
    if not all(n.spilled for n in chain):
        raise AssertionError(f"{what}: the pressure wave left "
                             f"{sum(not n.spilled for n in chain)} of the "
                             f"chain's {len(chain)} blocks resident")


def same_payload(a, b) -> bool:
    return all(len(x) == len(y) and all(
        u.dtype == v.dtype and u.tobytes() == v.tobytes()
        for u, v in zip(x, y)) for x, y in zip(a, b))


def hold_restored(eng, chain, snap, what, card):
    """Every restored block of ``chain`` bit-equal (payload and, in int8,
    scales) to its snapshot taken before the spill and to the tier's
    spilled payload."""
    view = eng.tier
    for i, (node, want) in enumerate(zip(chain, snap)):
        if node.spilled:
            raise AssertionError(f"{what}: chain block {i} still spilled")
        got = eng.arena.read_block(node.block)
        spilled, _ = view.store.get(view._k(node.key))
        if not same_payload(got, want) or not same_payload(got, spilled):
            raise AssertionError(f"{what}: restored block {i} differs from "
                                 "the spilled one")
    print(f"e2e {what}: the {len(chain)} restored blocks are bit-equal to "
          f"the spilled payloads ({len(snap[0][0])} arrays a layer) [{card}]")


def tier_waves(model, pa, api, what, card, kernels, seed):
    """The primer (request 0 alone, a miss), wave A (every request a hit on
    the primer's prefix), the pressure wave, wave B (the first admission
    restores the chain, the others hit it): wave B's streams equal wave A's,
    its restored blocks bit-equal to the spilled ones, TIER_PREFIX / 16
    blocks restored, the launches exact, one restore program built.
    Returns the prompts, the primer's and wave A's streams, the chain, the
    rng and wave B's launches."""
    eng = api.engine
    view = eng.tier
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng, prompts = tier_prompts(vocab, seed)
    news = [TIER_NEW] * len(prompts)
    primer, _, _ = serve(api, pa, prompts[:1], news[:1], f"{what}, primer",
                         card)
    reqs, launches, ran = serve(api, pa, prompts, news, f"{what}, wave A",
                                card)
    hold_launches(launches, want_launches(layers, ran, **kernels),
                  f"{what}, wave A")
    if ran.suffix != len(prompts):
        raise AssertionError(f"{what}: wave A ran {ran.suffix} hits")
    want = [list(r.tokens) for r in reqs]
    chain = eng.prefix_cache.match(prompts[0])
    if len(chain) != TIER_PREFIX // eng.block_size:
        raise AssertionError(f"{what}: a chain of {len(chain)} blocks")
    snap = [eng.arena.read_block(n.block) for n in chain]
    tier_pressure(api, rng, vocab, chain, what)
    before = view.stats()
    reqs, launches, ran = serve(api, pa, prompts, news, f"{what}, wave B",
                                card)
    hold_launches(launches, want_launches(layers, ran, **kernels),
                  f"{what}, wave B")
    hold_streams(reqs, want, f"{what}, wave B", card, "wave A's")
    moved = {k: v - before[k] for k, v in view.stats().items()
             if k in ("tier.restored_blocks", "tier.host_hits",
                      "tier.disk_hits", "tier.misses")}
    print(f"e2e {what}: wave B moved {moved}, restore builds "
          f"{eng.restore_traces} (captures {eng.restore_captures}) [{card}]")
    if moved["tier.restored_blocks"] != len(chain) or moved["tier.misses"]:
        raise AssertionError(f"{what}: wave B {moved}")
    hold_restored(eng, eng.prefix_cache.match(prompts[0]), snap, what, card)
    if (eng.restore_traces, eng.restore_captures) != (
            1, int(eng.device.type == "cuda")):
        raise AssertionError(f"{what}: restore built "
                             f"{eng.restore_traces} times")
    return prompts, list(primer[0].tokens), want, chain, rng, launches


def tier_ttft(api, rng, prefixes, kind, restored):
    """Host ms from ``admit()`` to the first token of each of ``prefixes``
    with TIER_SUFFIX fresh tokens, each slot retired at once; the admissions
    must restore ``restored`` blocks in all (``kind`` names them)."""
    eng = api.engine
    vocab = eng.vocab
    restored_blocks = lambda: (0 if eng.tier is None  # noqa: E731
                               else eng.tier.restored_blocks)
    before = restored_blocks()
    ms = []
    for p in prefixes:
        prompt = np.concatenate([p, rng.integers(0, vocab, TIER_SUFFIX)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot, _ = eng.admit(prompt, 8)
        ms.append((time.perf_counter() - t0) * 1e3)
        eng.retire(slot)
    if restored_blocks() - before != restored:
        raise AssertionError(f"first token, {kind}: "
                             f"{restored_blocks() - before} blocks "
                             f"restored, not {restored}")
    return ms


def tier_times(api, rng, n, resident=True):
    """First-token times on ``api``, ``n`` samples a kind after one warm-up
    prefix (every bucket then built): misses (a full prefill, and the
    prompt's blocks written through to the tiers), with ``resident`` hits
    on the device-resident prefix, and, on an engine with tiers, hits on
    the prefix spilled to the engine's store first, restored from it."""
    eng = api.engine
    chain = TIER_PREFIX // eng.block_size
    prefixes = [rng.integers(0, eng.vocab, TIER_PREFIX) for _ in range(n + 1)]
    out = {"miss": tier_ttft(api, rng, prefixes, "miss", 0)[1:]}
    if resident:
        out["resident"] = tier_ttft(api, rng, prefixes, "resident", 0)[1:]
    if eng.tier is None:
        return out
    eng.prefix_cache.evict(eng.prefix_cache.evictable_blocks())
    out["restored"] = tier_ttft(api, rng, prefixes[1:], "restored",
                                n * chain)
    return out


def tier_restore_times(api, chain, card, flush):
    """A spilled block's host ms (``read_block``: its device-to-host copy
    into pinned memory) and a restored chain's (its host buffers copied to
    the staging and one run of the restore program, synchronised), beside
    the bound measured here: one pinned host-to-device copy of the chain's
    bytes."""
    eng = api.engine
    view = eng.tier
    blocks = [n.block for n in chain]
    payloads = [view.store.get(view._k(n.key))[0] for n in chain]
    spill = []
    for blk in blocks[:10]:
        t0 = time.perf_counter()
        eng.arena.read_block(blk)
        spill.append((time.perf_counter() - t0) * 1e3)
    restore = []
    for _ in range(6):  # rewrites the chain's own bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._restore_call(payloads, blocks)
        torch.cuda.synchronize()
        restore.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(p.buffer.numel() for p in payloads)
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    bound_ms = time_ms(lambda: dst.copy_(src, non_blocking=True), flush,
                       iters=10)
    out = dict(spill_block_ms=float(np.median(spill)),
               restore_chain_ms=float(np.median(restore[1:])),
               chain_blocks=len(blocks), chain_bytes=nbytes,
               restore_bound_ms=bound_ms,
               h2d_gb_per_s=nbytes / bound_ms / 1e6)
    print(f"e2e bf16 tiers: a spilled block {out['spill_block_ms']:.3f} ms "
          f"host (device to pinned host, into a buffer the host allocator "
          f"reuses; median of {len(spill)}); a "
          f"restored chain of {len(blocks)} blocks ({nbytes} bytes) "
          f"{out['restore_chain_ms']:.3f} ms host, synchronised (median of "
          f"5), bound {bound_ms:.3f} ms: one pinned host-to-device copy of "
          f"its bytes ({out['h2d_gb_per_s']:.1f} GB/s), "
          f"{out['restore_chain_ms'] / bound_ms:.2f} x [{card}]")
    return out


def serve_tiers(model, serving, pa, card):
    """Phase 14c: the tiered KV cache in bf16 (``tier_waves`` over a host
    store, then over an int8 arena, where payload and scales must come back
    bit-equal), the spill and restore times against their bound, the first
    token of a miss, a resident hit and a host-restored hit; then a disk
    pass: a host budget below one block, so every entry lives on disk,
    wave B restored from disk, and a corrupted file of the chain's first
    block, which sends the next wave's first admission to a full prefill
    (its stream then the primer's, the others' wave A's), and the first
    token of a disk-restored hit. Returns wave B's launches, the int8
    ones and the times."""
    import tempfile

    from paddle_tpu_torch.serving import HostKVCache

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    layers = model.cfg.num_layers
    out = {}
    store = HostKVCache(max_bytes=8 << 30, disk_dir="")
    api = tier_engine(model, serving, store)
    prompts, _, _, chain, rng, launches = tier_waves(
        model, pa, api, "bf16 tiers (host)", card, {}, 53)
    out.update(tier_restore_times(api, chain, card, flush))
    out.update({f"ttft_{k}_ms": v
                for k, v in tier_times(api, rng, TIER_TIMED).items()})
    print(f"bf16 tiers (host): engine {api.engine.stats()['tier.enabled']}, "
          f"store {store.stats()} [{card}]")
    api.close()
    del store
    torch.cuda.empty_cache()
    # the same first tokens with the prefix cache and no tiers, in this call
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=SPEC_SLOTS, kv_block_size=TIER_BLOCK, prefix_cache=True),
        device="cuda")
    out.update({f"ttft_{k}_no_tier_ms": v
                for k, v in tier_times(api, rng, TIER_TIMED).items()})
    api.close()
    torch.cuda.empty_cache()

    store = HostKVCache(max_bytes=8 << 30, disk_dir="")
    api = tier_engine(model, serving, store, quant_kv=True)
    kv8 = dict(decode="paged_decode_attention_int8",
               chunk="paged_prefill_attention_int8")
    launches8 = tier_waves(model, pa, api, "bf16 tiers (quant_kv)", card,
                           kv8, 54)[5]
    api.close()
    del store
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        store = HostKVCache(max_bytes=1, disk_dir=root)
        api = tier_engine(model, serving, store)
        eng = api.engine
        what = "bf16 tiers (disk)"
        prompts, primer, want, chain, rng, _ = tier_waves(
            model, pa, api, what, card, {}, 55)
        if eng.tier.disk_hits < len(chain) - 1:
            raise AssertionError(f"{what}: {eng.tier.disk_hits} disk hits")
        tier_pressure(api, rng, eng.vocab, chain, what)
        path = os.path.join(root, eng.tier._k(chain[0].key).hex() + ".kv")
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(raw)
        misses, corrupt = eng.tier.misses, store.disk.stats()
        reqs, _, _ = serve(api, pa, prompts, [TIER_NEW] * len(prompts),
                           f"{what}, wave C (first block corrupted)", card)
        if eng.tier.misses != misses + 1:
            raise AssertionError(f"{what}: wave C counted "
                                 f"{eng.tier.misses - misses} misses")
        hold_streams(reqs[:1], [primer], f"{what}, wave C request 0 (a "
                     "miss: the corrupted chain prefilled again)", card,
                     "the primer's")
        hold_streams(reqs[1:], want[1:], f"{what}, wave C", card,
                     "wave A's")
        out["ttft_disk_restored_ms"] = tier_times(
            api, rng, TIER_DISK_TIMED, resident=False)["restored"]
        print(f"{what}: disk {store.disk.stats()} (was {corrupt}), view "
              f"{eng.tier.stats()} [{card}]")
        api.close()
    torch.cuda.empty_cache()
    med = {k: float(np.median(v)) for k, v in out.items()
           if k.startswith("ttft_")}
    print(f"bf16 tiers: first token of {TIER_PREFIX} + {TIER_SUFFIX}, "
          f"median ms: miss {med['ttft_miss_ms']:.3f} (no tiers "
          f"{med['ttft_miss_no_tier_ms']:.3f}), resident hit "
          f"{med['ttft_resident_ms']:.3f} (no tiers "
          f"{med['ttft_resident_no_tier_ms']:.3f}), host-restored hit "
          f"{med['ttft_restored_ms']:.3f}, disk-restored hit "
          f"{med['ttft_disk_restored_ms']:.3f}; samples "
          + json.dumps({k: [round(x, 3) for x in v] for k, v in out.items()
                        if k.startswith("ttft_")}) + f" [{card}]")
    out.update({k.replace("_ms", "_median_ms"): v for k, v in med.items()})
    return launches, launches8, out


def serve_lora_tier(gpt, serving, pa, so, arrays, card):
    """Phase 14: 14a and 14c on bf16 gpt_1p3b, 14b in f32 at 4 layers.
    Returns the launches of 14a's wave 1 and of 14c's wave B (the int8
    rows' from the quant_kv wave B) and the times."""
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    model.to(torch.bfloat16)
    t0 = time.perf_counter()
    lora_launches, lora_times = serve_lora_bf16(model, serving, pa, so, card)
    print(f"phase 14a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tier_launches, tier_launches8, tier = serve_tiers(model, serving, pa,
                                                      card)
    print(f"phase 14c: {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_lora_f32(gpt, serving, pa, so, arrays, card)
    print(f"phase 14b: {time.perf_counter() - t0:.1f} s")
    for name in PAGED[2:]:
        tier_launches[name] = tier_launches8[name]
    summary = dict(lora=lora_times, tiers=tier)
    print("phase 14, one call: " + json.dumps(summary) + f" [{card}]")
    return lora_launches, tier_launches, summary


# ------------------------------------------------------------------ phase 15
# the gateway: two replicas of phase 6's engine shape sharing one model
POOL_SLOTS = 8                  # each replica's slots
POOL_PREFIX, POOL_TAIL, POOL_NEW = 512, 15, 64
POOL_CLIENTS = 16               # 15b's client threads, one request each
POOL_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
POOL_TTFT = 5                   # first-token samples per front door
POOL_TRACE_NEW = 192            # the traced wave's budget: decode-bound
POOL_TRACE_S = 0.25             # its profiler window, seconds
POOL_F32 = (4, [40, 70, 37, 100, 140, 300, 200, 64], 32)  # 15c
POOL_BACKOFF = 0.2              # 15c's respawn backoff, seconds


def pool_prefixes(vocab, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, POOL_PREFIX) for _ in range(n)]


def pool_wave(vocab, sysp, seed):
    """POOL_CLIENTS requests of POOL_PREFIX + POOL_TAIL tokens and
    POOL_NEW new ones: the even ones share the system prefix ``sysp``
    (block-aligned, so their chain is exactly it), the odd ones have a
    prefix of their own (a miss wherever they land); requests 2 and 3 of
    every 4 sample (POOL_SAMPLED, seeded), the others are greedy. Returns
    the prompts and each request's ``submit`` keywords."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    own = pool_prefixes(vocab, seed + 1, POOL_CLIENTS)
    prompts = [np.concatenate([sysp if i % 2 == 0 else own[i],
                               rng.integers(0, vocab, POOL_TAIL)])
               for i in range(POOL_CLIENTS)]
    kws = [{"sampling": SamplingParams(**POOL_SAMPLED, seed=80 + i)}
           if i % 4 >= 2 else {} for i in range(POOL_CLIENTS)]
    return prompts, kws


def body_of(prompt, n, kw, **extra):
    """The HTTP body of one request of ``pool_wave``."""
    body = {"prompt": [int(t) for t in prompt], "max_new_tokens": n, **extra}
    sp = kw.get("sampling")
    if sp is not None:
        body.update(temperature=sp.temperature, top_k=sp.top_k,
                    top_p=sp.top_p, seed=sp.seed)
    return body


def sse_stream(url, body=None, timeout=300):
    """An SSE stream (a POST of ``body`` to ``/v1/stream``, or a GET of
    ``/v1/stream/<id>`` when there is no body): the tokens, the done event
    and each token's host ms from the request's start."""
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    toks, done, times = [], None, []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        event = None
        for line in resp:
            line = line.decode().strip()
            if line.startswith("event:"):
                event = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                d = json.loads(line.split(":", 1)[1])
                if event == "done":
                    done = d
                elif event == "error":
                    raise AssertionError(f"SSE error event: {d}")
                else:
                    times.append((time.perf_counter() - t0) * 1e3)
                    toks.append(d["token"])
                event = None
    return toks, done, times


def repair_adapter_roots(model, serving, pa, card):
    """15a, adapter-rooted prefix chains (bf16, an arena of rank
    LORA_RANK): with the prefix cache, a base request then an adapter
    request of one prompt, and an adapter request then a base request of
    another, each equal to its cache-off solo run (the second of each pair
    a miss: a full prefill, as its solo run); then an adapter request
    sharing the first prompt's prefix hits the adapter's chain. Launches
    exact in every wave."""
    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    dev = model.gpt.wte.weight.device
    rng = np.random.default_rng(70)
    prompts = [np.concatenate([p, rng.integers(0, vocab, POOL_TAIL)])
               for p in pool_prefixes(vocab, 71, 2)]
    prompts.append(np.concatenate([prompts[0][:POOL_PREFIX],
                                   rng.integers(0, vocab, POOL_TAIL)]))
    cfg = dict(num_slots=POOL_SLOTS, lora_rank=LORA_RANK,
               lora_adapters=LORA_CAP)
    adapter = lora_adapter(serving, model.cfg, LORA_SEEDS[0])
    off = serving.ServingAPI(model, serving.ServingConfig(**cfg), device=dev)
    aid = off.register_adapter(adapter)
    solo = {}
    for i, a in ((0, 0), (0, aid), (1, aid), (1, 0)):
        reqs, _, _ = serve(off, pa, [prompts[i]], [POOL_NEW],
                           f"bf16 roots, prompt {i} adapter {a}, cache off",
                           card, [{"adapter": a}])
        solo[i, a] = list(reqs[0].tokens)
    off.close()
    if solo[0, 0] == solo[0, aid]:
        raise AssertionError("bf16 roots: the adapter changed no token")
    on = serving.ServingAPI(model, serving.ServingConfig(
        **cfg, prefix_cache=True), device=dev)
    if on.register_adapter(adapter) != aid:
        raise AssertionError("bf16 roots: another adapter id")
    cache = on.engine.prefix_cache
    for i, order in ((0, (0, aid)), (1, (aid, 0))):
        for a in order:
            what = f"bf16 roots, prompt {i} adapter {a} (order {order})"
            reqs, launches, ran = serve(on, pa, [prompts[i]], [POOL_NEW],
                                        what, card, [{"adapter": a}])
            hold_launches(launches, want_launches(layers, ran), what)
            hold_streams(reqs, [solo[i, a]], what, card,
                         "its cache-off solo run's")
    if (cache.hits, cache.misses) != (0, 4):
        raise AssertionError(f"bf16 roots: {cache.hits} hits, "
                             f"{cache.misses} misses, not 0 and 4")
    what = "bf16 roots, the adapter's shared prefix"
    reqs, launches, ran = serve(on, pa, [prompts[2]], [POOL_NEW], what, card,
                                [{"adapter": aid}])
    hold_launches(launches, want_launches(layers, ran), what)
    if (cache.hits, cache.hit_tokens, ran.suffix) != (1, POOL_PREFIX, 1):
        raise AssertionError(f"{what}: {cache.hits} hits of "
                             f"{cache.hit_tokens} tokens, {ran.suffix} "
                             "suffix prefills")
    print(f"e2e bf16 roots: base and adapter chains of one prompt stay "
          f"apart in both orders (0 hits of 4), and the adapter's own "
          f"prefix is a hit of {cache.hit_tokens} tokens [{card}]")
    on.close()
    del on, off
    release()


def repair_tier_signature(model, serving, pa, card):
    """15a, the weights in the tier signature (bf16): the served state's
    fingerprint timed cold and memoized; an engine of a copy of the model
    with one layer's weights changed, sharing a ``HostKVCache`` with an
    engine of the model that wrote the prompt's blocks through, gives its
    solo stream with nothing restored; a second engine of the model on the
    same store restores the chain and gives the first engine's hit
    stream. Returns the fingerprint times."""
    from paddle_tpu_torch.serving import HostKVCache, tiered

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(model.parameters()) + list(model.buffers()))
    model.__dict__.pop("_state_fingerprint", None)
    t0 = time.perf_counter()
    tiered.state_fingerprint(model)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiered.state_fingerprint(model)
    memo = time.perf_counter() - t0
    print(f"bf16 tier signature: state fingerprint of {nbytes} bytes, cold "
          f"{cold:.3f} s ({nbytes / cold / 1e9:.2f} GB/s: device-to-host "
          f"copies and blake2b), memoized {memo * 1e3:.3f} ms [{card}]")
    other = copy.deepcopy(model)
    other.__dict__.pop("_state_fingerprint", None)
    with torch.no_grad():
        other.gpt.layers[layers // 2].mlp.down.weight.mul_(1.0625)
    rng = np.random.default_rng(72)
    prompt = np.concatenate([pool_prefixes(vocab, 73, 1)[0],
                             rng.integers(0, vocab, POOL_TAIL)])
    api = tier_engine(other, serving, HostKVCache(max_bytes=8 << 30,
                                                  disk_dir=""))
    solo = serve(api, pa, [prompt], [POOL_NEW], "bf16 tier signature, the "
                 "changed model alone", card)[0]
    api.close()
    store = HostKVCache(max_bytes=8 << 30, disk_dir="")
    a = tier_engine(model, serving, store)
    serve(a, pa, [prompt], [POOL_NEW], "bf16 tier signature, engine A",
          card)
    hit, _, _ = serve(a, pa, [prompt], [POOL_NEW],
                      "bf16 tier signature, engine A again (a hit)", card)
    b = tier_engine(other, serving, store)
    what = "bf16 tier signature, engine B (other weights) after A"
    reqs, launches, ran = serve(b, pa, [prompt], [POOL_NEW], what, card)
    hold_launches(launches, want_launches(layers, ran), what)
    hold_streams(reqs, [list(solo[0].tokens)], what, card,
                 "the changed model's solo run's")
    view = b.engine.tier
    if view.restored_blocks or view.host_hits or b.engine.prefix_cache.hits:
        raise AssertionError(f"{what}: {view.restored_blocks} blocks "
                             f"restored, {view.host_hits} host hits")
    differ = sum(x != y for x, y in zip(solo[0].tokens, hit[0].tokens))
    b.close()
    c = tier_engine(model, serving, store)
    what = "bf16 tier signature, engine C (the same weights) after A"
    reqs, launches, ran = serve(c, pa, [prompt], [POOL_NEW], what, card)
    hold_launches(launches, want_launches(layers, ran), what)
    hold_streams(reqs, [list(hit[0].tokens)], what, card, "A's hit's")
    chain = POOL_PREFIX // c.engine.block_size
    if c.engine.tier.restored_blocks != chain:
        raise AssertionError(f"{what}: {c.engine.tier.restored_blocks} "
                             f"blocks restored, not {chain}")
    print(f"e2e bf16 tier signature: other weights restore 0 blocks (their "
          f"stream differs from A's in {differ} of {POOL_NEW} tokens); the "
          f"same weights restore {chain} [{card}]")
    a.close()
    c.close()
    del a, b, c, other
    release()
    return dict(fingerprint_bytes=nbytes, fingerprint_cold_s=cold,
                fingerprint_memoized_ms=memo * 1e3)


def pool_config(serving, store, slots=POOL_SLOTS):
    return serving.ServingConfig(num_slots=slots, prefix_cache=True,
                                 kv_tiering=True, tier_store=store)


def engine_wave(api, pa, prompts, kws, what, card):
    """Serve one wave on a single engine: the streams, tokens/s on the
    host clock and what ran (``serve``)."""
    layers = api.engine._model.cfg.num_layers
    t0 = time.perf_counter()
    reqs, launches, ran = serve(api, pa, prompts, [POOL_NEW] * len(prompts),
                                what, card, kws)
    wall = time.perf_counter() - t0
    hold_launches(launches, want_launches(layers, ran), what)
    return [list(r.tokens) for r in reqs], POOL_NEW * len(prompts) / wall


def pool_ran(pool):
    return [ran_counts(rep.api.engine) for rep in pool.replicas()]


class _ReplaySpans:
    """CUDA events around every ``CUDAGraph.replay`` while installed, on
    the stream the replay runs on, whichever thread replays: each replay's
    device interval against one base event."""

    def __init__(self):
        self.spans = []
        self._replay = torch.cuda.CUDAGraph.replay

    def __enter__(self):
        replay, spans = self._replay, self.spans

        def timed(graph):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay(graph)
            b.record()
            spans.append((torch.cuda.current_stream().stream_id, a, b))
        torch.cuda.synchronize()
        self.base = torch.cuda.Event(enable_timing=True)
        self.base.record()
        torch.cuda.CUDAGraph.replay = timed
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self._replay


def pool_trace(pool, sysp, vocab, card):
    """Both replicas decoding their lanes (shared-prefix hits of
    POOL_TRACE_NEW tokens): over a POOL_TRACE_S host window, CUDA events
    around every graph replay on each replica's stream give the device
    intervals the replays occupied: busy is their union, the idle share
    what of the window it leaves, the overlap the time replays of the two
    streams ran at once (the sum of each stream's busy time less the
    union). (``torch.profiler`` showed no kernel of the replicas' graph
    replays in such a window.)"""
    from paddle_tpu_torch.tools.profile_decode import _union_us

    rng = np.random.default_rng(75)
    rrs = [pool.submit(np.concatenate([sysp, rng.integers(0, vocab,
                                                          POOL_TAIL)]),
                       max_new_tokens=POOL_TRACE_NEW, tenant="trace")
           for _ in range(2 * POOL_SLOTS)]
    scheds = [rep.api.scheduler for rep in pool.replicas()]
    wait_for(lambda: all(len(s.running) == min(POOL_SLOTS, len(s.running)
                                               + len(s.waiting)
                                               + len(s.prefilling))
                         for s in scheds)
             and min(len(s.running) for s in scheds) > 0,
             "both replicas decoding every lane they can")
    with _ReplaySpans() as spans:
        t0 = time.perf_counter()
        time.sleep(POOL_TRACE_S)
        window = (time.perf_counter() - t0) * 1e3
    for rr in rrs:
        pool.result(rr, timeout=300)
    torch.cuda.synchronize()
    by_stream = {}
    for sid, a, b in spans.spans:
        s0 = spans.base.elapsed_time(a)
        s1 = min(spans.base.elapsed_time(b), window)
        if s1 > s0:
            by_stream.setdefault(sid, []).append((s0, s1))
    busy = _union_us(iv for ivs in by_stream.values() for iv in ivs)
    per = {s: _union_us(ivs) for s, ivs in by_stream.items()}
    overlap = sum(per.values()) - busy
    out = dict(window_ms=window, busy_ms=busy, idle_share=1.0 - busy / window,
               replays=len(spans.spans),
               streams={str(s): round(v, 3) for s, v in per.items()},
               overlap_ms=overlap,
               overlap_share_of_busy=overlap / busy if busy else 0.0,
               busy_method="CUDA events around each replay")
    print(f"bf16 pool trace: a {window:.1f} ms window with both replicas "
          f"decoding, {out['replays']} replays: device busy (union of the "
          f"replays' intervals) {busy:.3f} ms, idle share "
          f"{out['idle_share']:.3f}; busy per replica stream (ms) "
          f"{out['streams']}; both streams replaying at once for "
          f"{overlap:.3f} ms ({out['overlap_share_of_busy']:.3f} of busy) "
          f"[{card}]")
    return out


def pool_ttft(pool, base, ref, sysp, vocab, card):
    """First-token host ms of a shared-prefix hit (POOL_TTFT samples each,
    one at a time on an idle system): through ``POST /v1/stream``, through
    ``pool.submit`` and on a bare ``ServingAPI.submit`` (``ref``, an
    engine of one replica's shape with a background pump)."""
    rng = np.random.default_rng(76)

    def prompt():
        return np.concatenate([sysp, rng.integers(0, vocab, POOL_TAIL)])

    out = {"http": [], "pool": [], "api": []}
    for _ in range(POOL_TTFT):
        out["http"].append(sse_stream(base + "/v1/stream",
                                      body_of(prompt(), 8, {}))[2][0])
        t0 = time.perf_counter()
        rr = pool.submit(prompt(), max_new_tokens=8, tenant="ttft")
        next(pool.stream(rr))
        out["pool"].append((time.perf_counter() - t0) * 1e3)
        pool.result(rr, timeout=120)
        t0 = time.perf_counter()
        req = ref.submit(prompt(), max_new_tokens=8)
        next(ref.stream(req))
        out["api"].append((time.perf_counter() - t0) * 1e3)
        ref.result(req, timeout=120)
    med = {k: float(np.median(v)) for k, v in out.items()}
    print(f"bf16 pool first token of a {POOL_PREFIX} + {POOL_TAIL} hit, "
          f"median of {POOL_TTFT} (ms): POST /v1/stream {med['http']:.3f}, "
          f"pool.submit {med['pool']:.3f}, bare ServingAPI.submit "
          f"{med['api']:.3f}; samples "
          + json.dumps({k: [round(x, 3) for x in v] for k, v in out.items()})
          + f" [{card}]")
    return {f"ttft_{k}_ms": v for k, v in med.items()}


def serve_pool_http(model, serving, pa, so, card):
    """Phase 15b (bf16): a reference engine of one replica's shape, then
    two replicas sharing the model behind a ``Gateway``, then one engine
    of both replicas' slots (the module docstring's phase 15). Returns
    the held HTTP wave's launches and the times."""
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.serving import HostKVCache
    from paddle_tpu_torch.serving.gateway import Gateway

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    dev = model.gpt.wte.weight.device
    sysp = pool_prefixes(vocab, 77, 1)[0]
    prompts, kws = pool_wave(vocab, sysp, 78)
    primer = np.concatenate([sysp, np.arange(POOL_TAIL) + 7])
    pushed = np.concatenate([sysp, np.arange(POOL_TAIL) + 99])
    times = {}

    # the reference: one engine of a replica's shape, its own store
    ref = serving.ServingAPI(model, pool_config(
        serving, HostKVCache(max_bytes=8 << 30, disk_dir="")),
        device=dev, background=True)
    serve(ref, pa, [primer], [POOL_NEW], "bf16 pool reference, primer", card)
    cache = ref.engine.prefix_cache
    cache.evict(cache.evictable_blocks())  # spilled: the next hit restores
    want_pushed = list(serve(ref, pa, [pushed], [POOL_NEW], "bf16 pool "
                             "reference, a host-restored hit", card)[0][0]
                       .tokens)
    if ref.engine.tier.restored_blocks != POOL_PREFIX // 16:
        raise AssertionError("bf16 pool reference: the hit restored "
                             f"{ref.engine.tier.restored_blocks} blocks")
    want, times["tokens_per_s_1x8"] = engine_wave(
        ref, pa, prompts, kws, "bf16 pool reference wave (1 x 8 slots)",
        card)

    store = HostKVCache(max_bytes=8 << 30, disk_dir="")
    tm = serving.TenantManager()
    tm.configure(serving.TenantConfig("metered", rate=1.0,
                                      burst=float(POOL_NEW)))
    pool = serving.ReplicaPool(model, replicas=2, config=pool_config(
        serving, store), tenants=tm, background=True, device=dev)
    gw = Gateway(pool, port=0).start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        rep0, rep1 = pool.replicas()
        # each replica's first wave builds every program the next waves
        # run: replica 0 a miss and a hit, replica 1 a miss and the pushed
        # request, a host-tier hit on the prefix replica 0 wrote through
        serve(rep0.api, pa, [primer], [POOL_NEW],
              "bf16 pool, replica 0's first miss", card)
        serve(rep0.api, pa, [np.concatenate([sysp, np.arange(POOL_TAIL)])],
              [POOL_NEW], "bf16 pool, replica 0's first hit", card)
        serve(rep1.api, pa, [np.concatenate([pool_prefixes(vocab, 74, 1)[0],
                                             np.arange(POOL_TAIL)])],
              [POOL_NEW], "bf16 pool, replica 1's first miss", card)
        what = "bf16 pool, a request pushed to the cold replica 1"
        reqs, launches, ran = serve(rep1.api, pa, [pushed], [POOL_NEW], what,
                                    card)
        hold_launches(launches, want_launches(layers, ran), what)
        hold_streams(reqs, [want_pushed], what, card,
                     "the single engine's host-restored hit's")
        view = rep1.api.engine.tier
        if (view.host_hits, view.restored_blocks) != (POOL_PREFIX // 16,) * 2:
            raise AssertionError(f"{what}: {view.host_hits} host hits, "
                                 f"{view.restored_blocks} restored")
        # replica 1 device-cold again: its blocks spill to the shared
        # store, so that the shared prefix draws affinity to replica 0
        with rep1.api.paused():
            c1 = rep1.api.engine.prefix_cache
            c1.evict(c1.evictable_blocks())
        built = [builds(rep.api.engine) for rep in pool.replicas()]
        # affinity within the slack: replica 0 one request busier, a
        # shared-prefix request still goes there
        a0 = metrics_counter("gateway.affinity_routes")
        tail = np.arange(POOL_TAIL) + 300
        busy = rep0.api.submit(np.concatenate(
            [pool_prefixes(vocab, 82, 1)[0], tail]), max_new_tokens=POOL_NEW)
        rr = pool.submit(np.concatenate([sysp, tail]),
                         max_new_tokens=POOL_NEW, tenant="aff")
        if (rr._replica_idx, metrics_counter("gateway.affinity_routes")) != (
                0, a0 + 1):
            raise AssertionError(f"bf16 pool: the warm request went to "
                                 f"replica {rr._replica_idx}, not by "
                                 f"affinity to replica 0")
        pool.result(rr, timeout=300)
        rep0.api.result(busy, timeout=300)
        print(f"e2e bf16 pool: with replica 0 one request busier, a "
              f"shared-prefix request routes to it by affinity (slack "
              f"{pool._affinity_slack}) [{card}]")

        # the held wave: 16 client threads through POST /v1/stream, a
        # scraper on /v1/metrics meanwhile
        results = [None] * POOL_CLIENTS
        scrapes, errors = [], []
        stop = threading.Event()
        start = threading.Barrier(POOL_CLIENTS)

        def client(i):
            try:
                start.wait(timeout=60)
                results[i] = sse_stream(
                    base + "/v1/stream", body_of(prompts[i], POOL_NEW,
                                                 kws[i]))
            except BaseException as e:  # held below, on the main thread
                errors.append(e)

        def scraper():
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(base + "/v1/metrics",
                                                timeout=60) as resp:
                        scrapes.append(resp.read().decode())
                except BaseException as e:  # held below
                    errors.append(e)
                    return
                time.sleep(0.05)

        a0 = metrics_counter("gateway.affinity_routes")
        ran0 = pool_ran(pool)
        torch.cuda.synchronize()
        pa.reset_launches()
        so.reset_launches()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(POOL_CLIENTS)]
        scrape = threading.Thread(target=scraper, daemon=True)
        t0 = time.perf_counter()
        scrape.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        stop.set()
        scrape.join(timeout=60)
        if errors or any(th.is_alive() for th in threads + [scrape]):
            raise AssertionError(f"bf16 pool HTTP wave: {errors[:2]}")
        torch.cuda.synchronize()
        launches = dict(pa.launches) | dict(so.launches)
        moved = [[a - b for a, b in zip(now, before)]
                 for now, before in zip(pool_ran(pool), ran0)]
        ran = types.SimpleNamespace(**dict(zip(
            ("steps", "prefills", "chunks", "suffix", "decode_builds",
             "prefill_builds", "chunk_builds"),
            (sum(col) for col in zip(*moved)))))
        what = "bf16 pool HTTP wave"
        print(f"e2e {what}: {POOL_CLIENTS} SSE streams in {wall:.2f} s, per "
              f"replica (steps, prefills, chunks, suffix prefills, builds) "
              f"{moved}, launches {launches} [{card}]")
        hold_launches(launches, want_launches(layers, ran), what)
        if [builds(rep.api.engine) for rep in pool.replicas()] != built:
            raise AssertionError(f"{what}: a replica built a program")
        for i, (toks, done, _) in enumerate(results):
            if toks != want[i] or done["state"] != "FINISHED":
                raise AssertionError(f"{what}: request {i} ({done}) "
                                     f"diverges from the single engine's")
        print(f"e2e {what}: all {POOL_CLIENTS} streams equal the single "
              f"engine's along the same cache path (shared prefix: hits, "
              f"own prefixes: misses) [{card}]")
        wins = metrics_counter("gateway.affinity_routes") - a0
        last = scrapes[-1] if scrapes else ""
        for idx in (0, 1):
            if f'replica="{idx}"' not in last:
                raise AssertionError(f"{what}: the scrape has no "
                                     f'replica="{idx}" series')
        for line in last.splitlines():
            if line and not line.startswith("#") and len(line.split()) != 2:
                raise AssertionError(f"{what}: scrape line {line!r}")
        print(f"e2e {what}: {wins} affinity routes in the wave; "
              f"{len(scrapes)} "
              f"/v1/metrics scrapes during the streams, the last "
              f"{len(last.splitlines())} lines with replica=\"0\" and "
              f"replica=\"1\" series [{card}]")
        times["tokens_per_s_pool_http"] = POOL_NEW * POOL_CLIENTS / wall

        mbody = body_of(prompts[1], POOL_NEW, {}, tenant="metered")
        urllib.request.urlopen(urllib.request.Request(
            base + "/v1/submit", data=json.dumps(mbody).encode(),
            method="POST"), timeout=60)
        try:
            urllib.request.urlopen(urllib.request.Request(
                base + "/v1/submit", data=json.dumps(mbody).encode(),
                method="POST"), timeout=60)
            raise AssertionError("the metered tenant was not shed")
        except urllib.error.HTTPError as e:
            if e.code != 429 or float(e.headers["Retry-After"]) <= 0:
                raise AssertionError(f"the metered tenant got {e.code}")
            print(f"e2e bf16 pool: a tenant past its bucket gets 429, "
                  f"Retry-After {e.headers['Retry-After']} s [{card}]")

        # the same traffic in process (fresh own prefixes: misses again)
        p2, k2 = pool_wave(vocab, sysp, 79)
        t0 = time.perf_counter()
        rrs = [pool.submit(p, max_new_tokens=POOL_NEW, tenant="inproc", **k)
               for p, k in zip(p2, k2)]
        for rr in rrs:
            pool.result(rr, timeout=600)
        times["tokens_per_s_pool_submit"] = (POOL_NEW * POOL_CLIENTS
                                             / (time.perf_counter() - t0))
        times["trace"] = pool_trace(pool, sysp, vocab, card)
        times.update(pool_ttft(pool, base, ref, sysp, vocab, card))
        if [builds(rep.api.engine) for rep in pool.replicas()] != built:
            raise AssertionError("bf16 pool: a later wave built a program")
    finally:
        gw.close()
        ref.close()
    del gw, pool, ref
    release()

    # one engine of both replicas' slots on the same traffic
    big = serving.ServingAPI(model, pool_config(
        serving, HostKVCache(max_bytes=8 << 30, disk_dir=""),
        slots=2 * POOL_SLOTS), device=dev)
    serve(big, pa, [primer], [POOL_NEW], "bf16 1 x 16 slots, primer", card)
    engine_wave(big, pa, *pool_wave(vocab, sysp, 80),
                "bf16 1 x 16 slots, first wave", card)
    times["tokens_per_s_1x16"] = engine_wave(
        big, pa, *pool_wave(vocab, sysp, 81),
        "bf16 1 x 16 slots, timed wave", card)[1]
    big.close()
    del big
    release()
    print(f"bf16 pool tokens/s ({POOL_CLIENTS} requests of {POOL_PREFIX} + "
          f"{POOL_TAIL} + {POOL_NEW}, host clock): pool 2 x {POOL_SLOTS} "
          f"through HTTP {times['tokens_per_s_pool_http']:.1f}, through "
          f"pool.submit {times['tokens_per_s_pool_submit']:.1f}; one engine "
          f"1 x {POOL_SLOTS} {times['tokens_per_s_1x8']:.1f}, 1 x "
          f"{2 * POOL_SLOTS} {times['tokens_per_s_1x16']:.1f} [{card}]")
    return launches, times


def release():
    """Collect closed engines held in reference cycles (an adapter arena
    points back at its engine, a gateway at its server), so that their
    arenas go back to the device before the next phase allocates."""
    gc.collect()
    torch.cuda.empty_cache()


def metrics_counter(key):
    from paddle_tpu_torch.serving import metrics

    return metrics.stats().get(key, 0)


def pool_faults(gpt, serving, arrays, card):
    """Phase 15c (f32, TF32 off, gpt_1p3b's width cut to POOL_F32[0]
    layers, a foreground pool of two replicas of 8 slots): replica 0 is
    driven into a crash loop (every decode step raises the injected
    ``ServingDeviceError``; one rebuild allowed): its streams re-route to
    replica 1 and equal the uninterrupted streams (one engine's) token for
    token, and the fault-to-next-token time of each is printed; after the
    backoff it respawns and serves the wave again, and the allocated bytes
    are then within one arena of their value before the fault; then
    ``scale_to(1)`` drains replica 1 with no grace and re-routes its
    streams to replica 0, none dropped. Returns the times."""
    from paddle_tpu_torch.core import flags, resilience
    from paddle_tpu_torch.serving import RequestState

    layers, lens, new = POOL_F32
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=layers)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    dev = model.gpt.wte.weight.device
    rng = np.random.default_rng(90)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    one = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=POOL_SLOTS), device=dev)
    reqs = [one.submit(p, max_new_tokens=new) for p in prompts]
    one.run_until_idle()
    want = [list(r.tokens) for r in reqs]
    one.close()
    torch.cuda.empty_cache()

    def submit_all(pool):
        return [pool.submit(p, max_new_tokens=new, tenant="f32")
                for p in prompts]

    def hold(rrs, what):
        if any(rr.state != RequestState.FINISHED for rr in rrs):
            raise AssertionError(f"{what}: {[rr.state for rr in rrs]}")
        hold_streams([types.SimpleNamespace(tokens=rr.tokens())
                      for rr in rrs], want, what, card,
                     "the uninterrupted engine's")

    keep = flags.get_flags("serving_max_rebuilds")
    flags.set_flags({"serving_max_rebuilds": 1})
    pool = serving.ReplicaPool(model, replicas=2, num_slots=POOL_SLOTS,
                               respawn_backoff=POOL_BACKOFF, device=dev)
    try:
        rrs = submit_all(pool)
        pool.run_until_idle(timeout=300)
        hold(rrs, "f32 pool, first wave")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        arena = pool.replicas()[0].api.engine.arena.bytes_total()
        victim = pool.replicas()[0]
        rrs = submit_all(pool)
        for _ in range(4):
            pool.pump_once()
        moved = [rr for rr in rrs if rr._replica_idx == victim.idx]
        if not moved or any(rr.finished for rr in moved):
            raise AssertionError("f32 pool: replica 0 has no stream left "
                                 "in flight to fault")
        seen = {id(rr): len(rr.tokens()) for rr in moved}

        def dying():
            raise resilience.ServingDeviceError(
                "injected: replica 0's device lost")

        victim.api.engine.decode_step = dying
        t_fault = time.perf_counter()
        gaps = {}
        deadline = t_fault + 300
        while not all(rr.finished for rr in rrs):
            if time.perf_counter() > deadline:
                raise AssertionError("f32 pool fault: not done in 300 s")
            pool.pump_once()
            now = time.perf_counter()
            for rr in moved:
                if id(rr) not in gaps and len(rr.tokens()) > seen[id(rr)]:
                    gaps[id(rr)] = (now - t_fault) * 1e3
            for rr in rrs:
                pool._observe(rr)
        what = "f32 pool, replica 0 crash-looping"
        hold(rrs, what)
        if victim.ejections != 1 or any(rr.reroutes != 1 for rr in moved):
            raise AssertionError(f"{what}: {victim.ejections} ejections, "
                                 f"reroutes {[rr.reroutes for rr in moved]}")
        ms = sorted(gaps.values())
        print(f"e2e {what}: its {len(moved)} streams re-routed to replica 1 "
              f"and equal the uninterrupted ones; fault to next token (host "
              f"ms, each stream) {[round(x, 3) for x in ms]} [{card}]")
        time.sleep(POOL_BACKOFF * 1.5)
        pool.pump_once()  # past the backoff: the respawn, if not yet done
        if victim.generation != 1 or len(pool.healthy_replicas()) != 2:
            raise AssertionError("f32 pool: replica 0 did not respawn")
        rrs = submit_all(pool)
        pool.run_until_idle(timeout=300)
        what = "f32 pool, after replica 0's respawn"
        hold(rrs, what)
        if not any(rr._replica_idx == victim.idx for rr in rrs):
            raise AssertionError(f"{what}: the respawn served nothing")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        print(f"e2e {what}: allocated {after} bytes against {before} before "
              f"the fault ({after - before:+d}; one arena {arena}) [{card}]")
        if abs(after - before) > arena:
            raise AssertionError(f"{what}: memory moved by more than one "
                                 "arena")
        rrs = submit_all(pool)
        for _ in range(3):
            pool.pump_once()
        pool.scale_to(1, grace=0.0)
        pool.run_until_idle(timeout=300)
        what = "f32 pool, scale_to(1)"
        hold(rrs, what)
        n = sum(rr.reroutes for rr in rrs)
        if not n or pool.stats()["replicas_total"] != 1:
            raise AssertionError(f"{what}: {n} re-routes")
        print(f"e2e {what}: {n} streams re-routed to the survivor, none "
              f"dropped [{card}]")
    finally:
        pool.close()
        flags.set_flags(keep)
    del model
    torch.cuda.empty_cache()
    return dict(fault_to_next_token_ms=ms, memory_before=before,
                memory_after=after, arena_bytes=arena)


def serve_gateway(gpt, serving, pa, so, arrays, card):
    """Phase 15: 15a and 15b on bf16 gpt_1p3b, 15c in f32 at 4 layers.
    Returns the launches of 15b's held HTTP wave and the times."""
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    model.to(torch.bfloat16)
    t0 = time.perf_counter()
    repair_adapter_roots(model, serving, pa, card)
    out = dict(repairs=repair_tier_signature(model, serving, pa, card))
    print(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, out["pool"] = serve_pool_http(model, serving, pa, so, card)
    print(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    del model
    release()
    t0 = time.perf_counter()
    out["faults"] = pool_faults(gpt, serving, arrays, card)
    print(f"phase 15c: {time.perf_counter() - t0:.1f} s")
    release()
    print(f"phase 15: {torch.cuda.memory_allocated()} bytes still allocated "
          f"[{card}]")
    print("phase 15, one call: " + json.dumps(out) + f" [{card}]")
    return launches, out


# ------------------------------------------------------------------ phase 16
# the process fleet: two worker processes of 15b's replica shape, each a
# whole serving stack in a CUDA context of its own; the WAL's restart
FLEET_WORKERS = 2
FLEET_HB, FLEET_MISSES = 0.2, 5  # heartbeats: a hang classified past 1 s
FLEET_BACKOFF = 0.2              # 16b's respawn backoff, seconds
FLEET_DEVICE = "cuda"            # 16b's and 16c's models and harnesses
# 16b's kill wave: new tokens a stream, many times what a step of the f32
# model makes in the two watchdog ticks between the wave's first tokens
# reaching the parent and the kill, so that every stream of the victim is
# still live when it dies (the other waves take POOL_F32's, a prefix of it)
FLEET_KILL_NEW = 256
# 16c: (prompt length, new tokens) of the greedy, seeded-sampled and
# constrained streams; the SIGKILL falls after WAL_SEEN greedy tokens. Each
# choice is longer than WAL_SEEN by far, so that all three streams are still
# live at the kill (submitted after the greedy one, the constrained stream is
# never ahead of it) and the next incarnation recovers all three
WAL_STREAMS = ((120, 96), (300, 96), (75, 48))
WAL_SAMPLED = dict(temperature=0.9, top_k=50, top_p=0.95, seed=7)
WAL_CHOICES = [[5, 6, 7, 8, *range(100, 140)], [5, 9, *range(200, 240)]]
WAL_STOP = 3
WAL_SEEN = 8
WAL_MAX_LEN = 2048               # the harness's max_model_len
# the harness's --config, --layers, --dtype and --seed (build_model's)
# 16c's model: gpt_1p3b's width cut to 2 layers (its three harness boots
# and the reference build the seeded weights each; the checks need no depth)
WAL_MODEL = ("gpt_1p3b", 2, "float32", 0)


def free_bytes():
    """Free bytes of the card (``torch.cuda.mem_get_info``): every
    process's allocations count, the workers' too."""
    return torch.cuda.mem_get_info()[0]


def fleet_config(serving):
    return serving.ServingConfig(num_slots=POOL_SLOTS, prefix_cache=True)


_RAN_KEYS = ("decode_steps", "prefills", "prefill_chunks", "suffix_prefills",
             "decode_traces", "prefill_traces", "prefix_prefill_traces")


def worker_ran(snap):
    """``ran_counts`` of a worker's engine, from its ``stats`` scrape."""
    return tuple(snap["engine"][k] for k in _RAN_KEYS)


def ran_between(now, before):
    return types.SimpleNamespace(**dict(zip(
        ("steps", "prefills", "chunks", "suffix", "decode_builds",
         "prefill_builds", "chunk_builds"),
        (a - b for a, b in zip(now, before)))))


def prime_worker(handle, prompt, what, timeout=300.0):
    """Serve one request on one worker (its handle's own submit; the
    pool's watchdog polls it) and return its tokens."""
    req = handle.submit(prompt, max_new_tokens=POOL_NEW)
    if not req.done_event.wait(timeout) or req.state != "FINISHED":
        raise AssertionError(f"{what}: {req.state} {req.error!r}")
    return list(req.tokens)


def fleet_reference(model, serving, pa, primer, hit, waves, card):
    """One in-process engine of a worker's shape (8 slots, the prefix
    cache) along the workers' cache path: the primer (a miss), a hit, then
    each wave (the shared prefix: hits; own prefixes: misses). Returns each
    wave's streams and tokens/s (host clock, foreground)."""
    dev = model.gpt.wte.weight.device
    ref = serving.ServingAPI(model, fleet_config(serving), device=dev)
    serve(ref, pa, [primer], [POOL_NEW], "bf16 fleet reference, primer",
          card)
    serve(ref, pa, [hit], [POOL_NEW], "bf16 fleet reference, a hit", card)
    out, rates = [], []
    for i, (prompts, kws) in enumerate(waves):
        t0 = time.perf_counter()
        reqs = serve(ref, pa, prompts, [POOL_NEW] * len(prompts),
                     f"bf16 fleet reference, wave {i}", card, kws)[0]
        rates.append(POOL_NEW * len(prompts) / (time.perf_counter() - t0))
        out.append([list(r.tokens) for r in reqs])
    ref.close()
    return out, rates


def fleet_http_wave(pool, base, layers, prompts, kws, want, card,
                    what="bf16 fleet HTTP wave", label=lambda idx: "worker"):
    """16 client threads through ``POST /v1/stream`` with each worker's
    launch counters set to 0 just before and read just after: every
    stream equals the reference's, and each worker's launches equal what
    its engine ran (``label(idx)`` names a worker in the lines printed).
    Returns each worker's launches, the wave's wall seconds and each
    client's ``sse_stream``."""
    handles = {rep.idx: rep.api for rep in pool.replicas()}
    results = [None] * len(prompts)
    errors = []
    start = threading.Barrier(len(prompts))

    def client(i):
        try:
            start.wait(timeout=60)
            results[i] = sse_stream(
                base + "/v1/stream", body_of(prompts[i], POOL_NEW, kws[i]))
        except BaseException as e:  # held below, on the main thread
            errors.append(e)

    before = {i: worker_ran(s) for i, s in pool.worker_stats().items()}
    for h in handles.values():
        h.reset_launches()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    after = pool.worker_stats()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"{what}: {errors[:2]}")
    launches = {}
    for idx, snap in sorted(after.items()):
        ran = ran_between(worker_ran(snap), before[idx])
        got = {k: snap["launches"].get(k, 0) for k in PAGED + SAMPLING}
        print(f"e2e {what}, {label(idx)} {idx} (pid {snap['pid']}): "
              f"{ran.steps} decode steps, {ran.prefills} prefills, "
              f"{ran.chunks} chunks, {ran.suffix} suffix prefills, builds "
              f"{(ran.decode_builds, ran.prefill_builds, ran.chunk_builds)}"
              f", launches {got} [{card}]")
        hold_launches(got, want_launches(layers, ran),
                      f"{what}, {label(idx)} {idx}")
        launches[idx] = got
    for i, (toks, done, _) in enumerate(results):
        if toks != want[i] or done["state"] != "FINISHED":
            raise AssertionError(f"{what}: request {i} ({done}) diverges "
                                 "from the reference engine's")
    print(f"e2e {what}: all {len(prompts)} SSE streams equal the reference "
          f"engine's along the same cache path, in {wall:.2f} s [{card}]")
    return launches, wall, results


def summed(launches):
    """Launches summed over workers (``fleet_http_wave``'s per worker)."""
    total = {}
    for got in launches:
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


def fleet_builds(pool):
    """Each worker's builds: whole-prompt, decode and chunk programs (from
    ``worker_ran``) and captured restores."""
    return {i: worker_ran(s)[4:] + (s["engine"]["restore_traces"],)
            for i, s in pool.worker_stats().items()}


def serve_fleet(model, serving, pa, card, pool15):
    """Phase 16a (bf16 gpt_1p3b): the reference engine, then two worker
    processes behind ``serve()`` with ``FLAGS_gateway_process_replicas``
    (8 slots and the prefix cache each, the weights loaded from the pool's
    file), each primed (a miss and a hit of the shared prefix), then 15b's
    wave through ``POST /v1/stream`` and through ``pool.submit``, first
    tokens of hits, and ``close()``. Returns the HTTP wave's launches
    (summed over the workers) and the numbers."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.serving.gateway import serve as serve_gateway_http

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    dev = model.gpt.wte.weight.device
    sysp = pool_prefixes(vocab, 77, 1)[0]
    http_wave, sub_wave = pool_wave(vocab, sysp, 78), pool_wave(vocab,
                                                                sysp, 79)
    primer = np.concatenate([sysp, np.arange(POOL_TAIL) + 7])
    hit = np.concatenate([sysp, np.arange(POOL_TAIL)])
    (want_http, want_sub), rates = fleet_reference(
        model, serving, pa, primer, hit, (http_wave, sub_wave), card)
    release()
    out = {"tokens_per_s_reference_1x8": rates}
    free0 = free_bytes()
    keep = flags.get_flags("gateway_process_replicas")
    flags.set_flags({"gateway_process_replicas": True})
    t0 = time.perf_counter()
    try:
        gw = serve_gateway_http(model, replicas=FLEET_WORKERS, guard=False,
                                port=0, device=dev,
                                config=fleet_config(serving),
                                heartbeat_interval=FLEET_HB)
    finally:
        flags.set_flags(keep)
    out["spawn_s"] = time.perf_counter() - t0
    pool = gw.pool
    base = f"http://127.0.0.1:{gw.port}"
    procs = [rep.api.proc for rep in pool.replicas()]
    try:
        st = pool.stats()
        out["boot_s"] = [rep.api.boot_seconds for rep in pool.replicas()]
        out["spawn_payload_bytes"] = st["spawn_payload_bytes"]
        print(f"e2e bf16 fleet: {FLEET_WORKERS} workers up in "
              f"{out['spawn_s']:.2f} s (parallel boots, spawn to hello: "
              f"{[round(s, 2) for s in out['boot_s']]} s), spawn payload "
              f"{out['spawn_payload_bytes']} bytes (the weights go through "
              f"the pool's file: {pool._payload_for(0)['model_file']}), "
              f"pids {[r['pid'] for r in st['replicas']]} [{card}]")
        ws = pool.worker_stats()
        if any(s["imports"] for s in ws.values()):
            raise AssertionError(f"a worker imported "
                                 f"{[s['imports'] for s in ws.values()]}")
        # each worker's first wave builds what the next waves run: a miss
        # of the shared prefix (the whole-prompt bucket, decode), then a
        # hit (the suffix bucket); the shared prefix is then resident in
        # every worker, as in the reference
        for rep in pool.replicas():
            prime_worker(rep.api, primer, f"worker {rep.idx}'s primer")
            prime_worker(rep.api, hit, f"worker {rep.idx}'s first hit")
        built = fleet_builds(pool)
        out["free_up"] = free_bytes()
        launches, wall, _ = fleet_http_wave(pool, base, layers,
                                            *http_wave, want_http, card)
        launches = summed(launches.values())
        out["tokens_per_s_http"] = POOL_NEW * POOL_CLIENTS / wall
        t0 = time.perf_counter()
        rrs = [pool.submit(p, max_new_tokens=POOL_NEW, tenant="inproc", **k)
               for p, k in zip(*sub_wave)]
        got = [list(map(int, pool.result(rr, timeout=600)[len(p):]))
               for rr, p in zip(rrs, sub_wave[0])]
        out["tokens_per_s_submit"] = (POOL_NEW * POOL_CLIENTS
                                      / (time.perf_counter() - t0))
        if got != want_sub:
            bad = [i for i, (a, b) in enumerate(zip(got, want_sub)) if a != b]
            raise AssertionError(f"bf16 fleet pool.submit wave: requests "
                                 f"{bad} diverge from the reference's")
        print(f"e2e bf16 fleet pool.submit wave: all {POOL_CLIENTS} streams "
              f"equal the reference engine's [{card}]")
        rng = np.random.default_rng(76)
        ttft = {"http": [], "pool": []}
        for _ in range(POOL_TTFT):
            p = np.concatenate([sysp, rng.integers(0, vocab, POOL_TAIL)])
            ttft["http"].append(sse_stream(base + "/v1/stream",
                                           body_of(p, 8, {}))[2][0])
            t0 = time.perf_counter()
            rr = pool.submit(np.concatenate(
                [sysp, rng.integers(0, vocab, POOL_TAIL)]), max_new_tokens=8,
                tenant="ttft")
            next(pool.stream(rr))
            ttft["pool"].append((time.perf_counter() - t0) * 1e3)
            pool.result(rr, timeout=120)
        out["ttft_http_ms"] = float(np.median(ttft["http"]))
        out["ttft_pool_ms"] = float(np.median(ttft["pool"]))
        print(f"bf16 fleet first token of a {POOL_PREFIX} + {POOL_TAIL} hit, "
              f"median of {POOL_TTFT} (ms): POST /v1/stream "
              f"{out['ttft_http_ms']:.3f}, pool.submit "
              f"{out['ttft_pool_ms']:.3f}; samples "
              + json.dumps({k: [round(x, 3) for x in v]
                            for k, v in ttft.items()}) + f" [{card}]")
        if fleet_builds(pool) != built:
            raise AssertionError(f"bf16 fleet: a worker built a program "
                                 f"after its first wave: {built} -> "
                                 f"{fleet_builds(pool)}")
        out["worker_memory_allocated"] = [
            s.get("memory_allocated") for s in pool.worker_stats().values()]
    finally:
        gw.close()
    if any(p.is_alive() for p in procs):
        raise AssertionError("bf16 fleet: a worker outlived close()")
    out["free_before_spawn"], out["free_after_close"] = free0, free_bytes()
    print(f"e2e bf16 fleet: card free memory (bytes) before the spawn "
          f"{free0}, both workers up and primed {out['free_up']} (a worker's "
          f"footprint {(free0 - out['free_up']) / FLEET_WORKERS:.0f}; "
          f"allocated in each {out['worker_memory_allocated']}), after "
          f"close() {out['free_after_close']} "
          f"({out['free_after_close'] - free0:+d}) [{card}]")
    if abs(out["free_after_close"] - free0) > (free0 - out["free_up"]) / 4:
        raise AssertionError("bf16 fleet: the card's memory did not come "
                             "back after close()")
    print(f"bf16 fleet tokens/s ({POOL_CLIENTS} requests of {POOL_PREFIX} + "
          f"{POOL_TAIL} + {POOL_NEW}, host clock): {FLEET_WORKERS} worker "
          f"processes x {POOL_SLOTS} through HTTP "
          f"{out['tokens_per_s_http']:.1f}, through pool.submit "
          f"{out['tokens_per_s_submit']:.1f}; the reference engine (1 x "
          f"{POOL_SLOTS}, the prefix cache, no tiers, foreground) on the same "
          f"waves {[round(r, 1) for r in rates]}; this call's phase 15b "
          f"(prefix cache and tiers on): in-process pool 2 x {POOL_SLOTS} "
          f"through HTTP "
          f"{pool15['tokens_per_s_pool_http']:.1f}, through pool.submit "
          f"{pool15['tokens_per_s_pool_submit']:.1f}, one engine 1 x "
          f"{POOL_SLOTS} {pool15['tokens_per_s_1x8']:.1f}, 1 x "
          f"{2 * POOL_SLOTS} {pool15['tokens_per_s_1x16']:.1f} [{card}]")
    return launches, out


def f32_cut(gpt, arrays):
    """15c's model: gpt_1p3b's width at POOL_F32[0] layers, f32, the
    seeded arrays of its parameters."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=POOL_F32[0])
    model = gpt.GPTForCausalLM(cfg, device=FLEET_DEVICE)
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    return model


def fleet_faults(gpt, serving, arrays, card):
    """Phase 16b (f32, TF32 off, 15c's model and prompts): two worker
    processes of 8 slots. A first wave builds; then a wave during which
    ``worker_kill`` SIGKILLs worker 0 (the watchdog's probe): its streams
    re-route to worker 1 and equal the uninterrupted ones (one in-process
    engine's), with each one's fault-to-next-token time; worker 0 respawns
    after its backoff, serves the next wave, and the card's free memory is
    then within one worker's footprint of its value before the fault. Then
    ``worker_hang``: worker 0 stops heartbeating, the watchdog classifies
    it by heartbeat age, its streams re-route equal. After each fault the
    tenant holds nothing in flight, and after ``close()`` no worker process
    is alive. Returns the numbers."""
    from paddle_tpu_torch.core import flags, resilience
    from paddle_tpu_torch.serving.gateway import ProcessReplicaPool

    _, lens, new = POOL_F32
    model = f32_cut(gpt, arrays)
    dev = model.gpt.wte.weight.device
    rng = np.random.default_rng(90)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in lens]

    def reference():
        one = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=POOL_SLOTS), device=dev)
        reqs = [one.submit(p, max_new_tokens=FLEET_KILL_NEW)
                for p in prompts]
        one.run_until_idle()
        one.close()
        # greedy: a shorter wave's streams are prefixes of these
        return [list(r.tokens) for r in reqs]

    def wave(pool, n=new):
        return [pool.submit(p, max_new_tokens=n, tenant="f32")
                for p in prompts]

    def hold(pool, rrs, what):
        for rr in rrs:
            pool.result(rr, timeout=300)
        hold_streams([types.SimpleNamespace(tokens=rr.tokens())
                      for rr in rrs], [w[:rr.max_new_tokens] for w, rr in
                                       zip(want, rrs)], what, card,
                     "the uninterrupted engine's")
        inflight = pool.stats()["tenants"]["f32"]["inflight"]
        if inflight:
            raise AssertionError(f"{what}: {inflight} still in flight")

    def when(cond, what, timeout=120.0):
        wait_for(cond, what, timeout)
        return time.perf_counter()

    out = {}
    keep = flags.get_flags("fault_injection")
    free0 = free_bytes()
    # the reference runs on this card while the workers boot
    with ThreadPoolExecutor(1) as ex:
        want_f = ex.submit(reference)
        flags.set_flags({"fault_injection": True})
        pool = ProcessReplicaPool(model, replicas=FLEET_WORKERS,
                                  background=True, num_slots=POOL_SLOTS,
                                  respawn_backoff=FLEET_BACKOFF,
                                  heartbeat_interval=FLEET_HB,
                                  heartbeat_misses=FLEET_MISSES, device=dev)
        try:
            want = want_f.result()
        except BaseException:
            pool.close()
            raise
    release()
    procs = []
    try:
        victim = pool.replicas()[0]
        procs.append(victim.api.proc)
        hold(pool, wave(pool), "f32 fleet, first wave")
        free_before = free_bytes()
        footprint = (free0 - free_before) / FLEET_WORKERS

        # worker_kill mid-wave
        survivor = pool.replicas()[1]
        built = fleet_builds(pool)[survivor.idx]
        rrs = wave(pool, FLEET_KILL_NEW)
        when(lambda: all(rr.tokens() for rr in rrs), "every stream started")
        # the victim's streams, taken before the kill can move them
        moved = [rr for rr in rrs if rr._replica_idx == victim.idx]
        kills0 = resilience._counts.get("fault.worker_kill", 0)
        resilience.inject_fault("worker_kill", times=1)
        t_fault = when(lambda: resilience._counts.get(
            "fault.worker_kill", 0) > kills0, "the watchdog's kill")
        seen = {id(rr): len(rr.tokens()) for rr in moved}
        gaps = {}
        deadline = t_fault + 300
        while not all(rr.finished for rr in rrs):
            if time.perf_counter() > deadline:
                raise AssertionError("f32 fleet kill: not done in 300 s")
            now = time.perf_counter()
            for rr in moved:
                if id(rr) not in gaps and len(rr.tokens()) > seen[id(rr)]:
                    gaps[id(rr)] = (now - t_fault) * 1e3
            time.sleep(0.0005)
        what = "f32 fleet, worker 0 SIGKILLed mid-wave"
        hold(pool, rrs, what)
        if not moved or any(rr.reroutes != 1 for rr in moved):
            raise AssertionError(f"{what}: reroutes "
                                 f"{[rr.reroutes for rr in moved]}")
        out["fault_to_next_token_ms"] = sorted(gaps.values())
        # the journals' prefills may take buckets the survivor never built
        out["survivor_builds"] = [a - b for a, b in zip(
            fleet_builds(pool)[survivor.idx], built)]
        t_up = when(lambda: victim.generation == 1 and victim.healthy,
                    "worker 0's respawn")
        out["respawn_s"] = t_up - t_fault
        procs.append(victim.api.proc)
        print(f"e2e {what}: its {len(moved)} streams re-routed to worker 1 "
              f"and equal the uninterrupted ones; fault to next token (host "
              f"ms, each stream) "
              f"{[round(x, 3) for x in out['fault_to_next_token_ms']]} "
              f"(programs the survivor built meanwhile: decode, prefill, "
              f"suffix {out['survivor_builds']}); "
              f"respawned in {out['respawn_s']:.2f} s (backoff "
              f"{FLEET_BACKOFF} s, boot {victim.api.boot_seconds:.2f} s) "
              f"[{card}]")
        rrs = wave(pool)
        hold(pool, rrs, "f32 fleet, after worker 0's respawn")
        if not any(rr._replica_idx == victim.idx for rr in rrs):
            raise AssertionError("f32 fleet: the respawn served nothing")
        out["free_before_fault"], out["free_after_respawn"] = (
            free_before, free_bytes())
        print(f"e2e f32 fleet: card free memory {out['free_after_respawn']} "
              f"bytes after the respawn against {free_before} before the "
              f"fault ({out['free_after_respawn'] - free_before:+d}; a "
              f"worker's footprint {footprint:.0f}) [{card}]")
        if abs(out["free_after_respawn"] - free_before) > footprint:
            raise AssertionError("f32 fleet: free memory moved by more than "
                                 "one worker's footprint across a respawn")

        # worker_hang: classified by heartbeat age
        rrs = wave(pool)
        when(lambda: all(rr.tokens() for rr in rrs), "every stream started")
        hangs0 = resilience._counts.get("worker.hangs", 0)
        resilience.inject_fault("worker_hang", times=1)
        t_hang = time.perf_counter()
        t_seen = when(lambda: resilience._counts.get("worker.hangs", 0)
                      > hangs0, "the hang's classification")
        out["hang_classified_s"] = t_seen - t_hang
        what = "f32 fleet, worker 0 hung mid-wave"
        hold(pool, rrs, what)
        print(f"e2e {what}: classified as hung (heartbeats stale past "
              f"{FLEET_MISSES} x {FLEET_HB} s, a poll unanswered) after "
              f"{out['hang_classified_s']:.3f} s, its streams re-routed and "
              f"equal the uninterrupted ones [{card}]")
    except BaseException:
        pool.close()
        raise
    finally:
        flags.set_flags(keep)
        resilience.clear_faults()

    def finish():
        """Worker 0's second respawn (it boots while 16c runs), then
        ``close()``: no worker process outlives it."""
        try:
            when(lambda: victim.generation == 2 and victim.healthy,
                 "worker 0's second respawn", timeout=300.0)
            procs.append(victim.api.proc)
            procs.append(pool.replicas()[1].api.proc)
        finally:
            pool.close()
        if any(p.is_alive() for p in procs):
            raise AssertionError("f32 fleet: a worker outlived close()")
        print(f"e2e f32 fleet: worker 0 respawned after the hang; none of "
              f"the {len(procs)} worker processes is alive after close() "
              f"[{card}]")
        release()

    return out, finish


def harness_boot(args, log):
    """Start ``wal_harness`` with ``args``; returns the process, its base
    URL and the seconds from the start to its JSON line."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.gateway.wal_harness",
         *args], stdout=subprocess.PIPE, stderr=log, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=30)
        raise AssertionError(f"wal_harness exited {proc.returncode} before "
                             f"printing its port (log: {log.name})")
    info = json.loads(line)
    return proc, f"http://127.0.0.1:{info['port']}", \
        time.perf_counter() - t0


def harness_end(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)
    proc.stdout.close()


def http_json(url, body=None, timeout=300):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def healthz_until_ok(base, timeout=120.0):
    seen = []
    deadline = time.perf_counter() + timeout
    while True:
        code, h = http_json(base + "/healthz", timeout=30)
        seen.append((code, h["status"]))
        if h["status"] == "ok":
            return seen, h
        if time.perf_counter() > deadline:
            raise AssertionError(f"/healthz never ok: {seen[-3:]}")
        time.sleep(0.005)


def wal_restart(serving, card):
    """Phase 16c (WAL_MODEL: f32, TF32 off, gpt_1p3b's width at
    WAL_MODEL[1] layers):
    ``wal_harness`` on the card, booted on ``build_model``'s seeded
    weights (the in-process reference calls it alike), serves greedy,
    seeded-sampled and constrained streams (WAL_STREAMS), is SIGKILLed
    after WAL_SEEN tokens of
    the greedy one, and a second harness on the same ``--wal-dir`` replays
    the log: every accepted stream finishes equal to an in-process
    engine's (computed while the first harness boots), the ``?offset=``
    client sees no token twice and none missing, and the build counters
    are frozen once the first resumed stream ended; a third harness
    answers the retried ids from its result cache (no decode). Prints each
    incarnation's boot seconds, the replay's seconds and the ``/healthz``
    statuses seen. Returns the numbers."""
    from paddle_tpu_torch.serving import SamplingParams, TrieConstraint
    from paddle_tpu_torch.serving.gateway import wal_harness

    cfg, layers, dtype, seed = WAL_MODEL
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    wal_dir = os.path.join(root, "wal_chip")
    shutil.rmtree(wal_dir, ignore_errors=True)
    args = ["--wal-dir", wal_dir, "--device", FLEET_DEVICE, "--config", cfg,
            "--layers", str(layers), "--dtype", dtype, "--seed", str(seed),
            "--num-slots", str(POOL_SLOTS), "--kv-block-size", str(BS),
            "--max-model-len", str(WAL_MAX_LEN)]
    out = {"boot_s": []}
    log = open(os.path.join(root, "wal_harness.log"), "w")
    procs = []
    # the first harness boots while the in-process reference runs
    first = ThreadPoolExecutor(1)
    booting = first.submit(harness_boot, args, log)
    try:
        model = wal_harness.build_model(cfg, layers, dtype, FLEET_DEVICE,
                                        seed)
        dev = model.gpt.wte.weight.device
        vocab = model.cfg.vocab_size
        rng = np.random.default_rng(91)
        prompts = [rng.integers(0, vocab, n) for n, _ in WAL_STREAMS]
        news = [n for _, n in WAL_STREAMS]
        ref = serving.ServingAPI(model, serving.ServingConfig(
            num_slots=POOL_SLOTS), device=dev)
        kws = [{}, {"sampling": SamplingParams(**WAL_SAMPLED)},
               {"stop_token_id": WAL_STOP, "constraint": TrieConstraint(
                   WAL_CHOICES, vocab_size=vocab, stop_token_id=WAL_STOP)}]
        reqs = [ref.submit(p, max_new_tokens=n, **k)
                for p, n, k in zip(prompts, news, kws)]
        ref.run_until_idle()
        want = [[int(t) for t in r.tokens] for r in reqs]
        ref.close()
        del model, ref, reqs
        release()
        if want[2] not in ([*c, WAL_STOP] for c in WAL_CHOICES):
            raise AssertionError(f"wal: the constrained stream {want[2]}")
    except BaseException:
        first.shutdown(wait=True)
        if booting.exception() is None:
            harness_end(booting.result()[0])
        log.close()
        raise
    first.shutdown(wait=True)
    bodies = [
        {"prompt": prompts[0].tolist(), "max_new_tokens": news[0],
         "request_id": "wg"},
        {"prompt": prompts[1].tolist(), "max_new_tokens": news[1],
         "request_id": "ws", **WAL_SAMPLED},
        {"prompt": prompts[2].tolist(), "max_new_tokens": news[2],
         "stop_token_id": WAL_STOP, "choices": WAL_CHOICES,
         "request_id": "wc"}]
    try:
        proc, base, boot = booting.result()
        procs.append(proc)
        out["boot_s"].append(boot)
        healthz_until_ok(base)
        for body in bodies:
            code, sub = http_json(base + "/v1/submit", body)
            if code != 200 or sub["request_id"] != body["request_id"]:
                raise AssertionError(f"wal submit: {code} {sub}")
        seen = []
        import urllib.request
        with urllib.request.urlopen(base + "/v1/stream/wg",
                                    timeout=300) as resp:
            for line in resp:
                line = line.decode().strip()
                if line.startswith("data:"):
                    seen.append(json.loads(line.split(":", 1)[1])["token"])
                if len(seen) >= WAL_SEEN:
                    break
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        if len(seen) >= news[0]:
            raise AssertionError("wal: the greedy stream ended before the "
                                 "SIGKILL")

        proc, base, boot = harness_boot(args, log)
        procs.append(proc)
        out["boot_s"].append(boot)
        statuses, h = healthz_until_ok(base)
        # the statuses in order, each with its run's length
        out["healthz"] = []
        for code, status in statuses:
            if out["healthz"] and out["healthz"][-1][:2] == [code, status]:
                out["healthz"][-1][2] += 1
            else:
                out["healthz"].append([code, status, 1])
        toks, done, _ = sse_stream(
            base + f"/v1/stream/wg?offset={len(seen)}")
        if seen + toks != want[0] or done["state"] != "FINISHED":
            raise AssertionError(f"wal: the resumed greedy stream diverges "
                                 f"({len(seen)} seen before the kill)")
        _, st1 = http_json(base + "/v1/stats")
        for i, rid in ((1, "ws"), (2, "wc")):
            code, res = http_json(base + f"/v1/result/{rid}?timeout=300")
            if code != 200 or res["tokens"] != want[i]:
                raise AssertionError(f"wal: {rid} diverges: {code} {res}")
        _, st2 = http_json(base + "/v1/stats")
        for key in ("serving.decode_compiles", "serving.prefill_compiles"):
            if st2["compile"].get(key, 0) != st1["compile"].get(key, 0):
                raise AssertionError(f"wal: {key} moved after the first "
                                     "resumed stream ended")
        walst = st2["pool"]["wal"]
        out["replay_s"], out["recovered"] = (walst["recovery_s"],
                                             walst["recovered"])
        if walst["recovered"] != 3:
            raise AssertionError(f"wal: {walst['recovered']} streams "
                                 "recovered, not 3")
        time.sleep(0.3)  # the sweep commits the TERMINAL records
        harness_end(proc)

        proc, base, boot = harness_boot(args, log)
        procs.append(proc)
        out["boot_s"].append(boot)
        healthz_until_ok(base)
        code, sub = http_json(base + "/v1/submit", {
            "prompt": prompts[0].tolist(), "request_id": "wg"})
        code2, res = http_json(base + "/v1/result/ws")
        _, st3 = http_json(base + "/v1/stats")
        if (not sub.get("cached") or sub["tokens"] != want[0]
                or not res.get("cached") or res["tokens"] != want[1]
                or st3["compile"].get("serving.decode_compiles", 0)):
            raise AssertionError(f"wal: the third incarnation decoded "
                                 f"again: {sub} {res}")
    finally:
        for p in procs:
            harness_end(p)
        log.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    print(f"e2e f32 wal: a harness SIGKILLed after {len(seen)} greedy "
          f"tokens, its 3 streams (greedy, seeded sampled, constrained) "
          f"finished by the next incarnation equal to the in-process "
          f"engine's; the replay (read and resubmissions) took "
          f"{out['replay_s'] * 1e3:.3f} ms; /healthz seen (code, status, "
          f"times in a row) {out['healthz']}; boots (start to port) "
          f"{[round(s, 2) for s in out['boot_s']]} s; the third incarnation "
          f"answered both retried ids from its cache, decoding nothing "
          f"[{card}]")
    return out


def serve_fleet_wal(gpt, serving, pa, arrays, card, pool15):
    """Phase 16: 16a on bf16 gpt_1p3b, 16b in f32 at POOL_F32[0] layers,
    16c at WAL_MODEL[1]. Returns 16a's launches (the workers' sum) and the
    numbers."""
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    model.to(torch.bfloat16)
    release()
    t0 = time.perf_counter()
    launches, out = serve_fleet(model, serving, pa, card, pool15)
    out = {"fleet": out}
    print(f"phase 16a: {time.perf_counter() - t0:.1f} s")
    del model
    release()
    t0 = time.perf_counter()
    out["faults"], finish_16b = fleet_faults(gpt, serving, arrays, card)
    print(f"phase 16b: {time.perf_counter() - t0:.1f} s (worker 0's second "
          "respawn boots during 16c)")
    t0 = time.perf_counter()
    try:
        out["wal"] = wal_restart(serving, card)
        print(f"phase 16c: {time.perf_counter() - t0:.1f} s")
    finally:
        t0 = time.perf_counter()
        finish_16b()
        print(f"phase 16b's end after 16c: {time.perf_counter() - t0:.1f} s")
    print("phase 16, one call: " + json.dumps(out) + f" [{card}]")
    return launches, out


# ------------------------------------------------------------------ phase 17
# disaggregated prefill and decode: role-typed worker processes that hand
# each request off through the shared disk tier
DISAGG_CHUNK = 256            # 17a's prefill role: 527 tokens in 3 chunks
DISAGG_HOST_BYTES = 4 << 30   # each worker's host tier: the waves' chains fit
DISAGG_PREFETCH = 2           # 17a's third wave's restore-ahead depth
DISAGG_DIR = os.path.join("build", "disagg_kv")        # 17a's shared tier
DISAGG_REF_DIR = os.path.join("build", "disagg_ref_kv")  # its reference's
# 17b (f32, POOL_F32[0] layers): chunks of one block, so that a chain
# publishes block by block; the prefill kill's prompts (lengths), published
# blocks seen before the kill, the decode kill's new tokens (FLEET_KILL_NEW)
DISAGG_F32_CHUNK = 16
DISAGG_KILL_LENS = [1000, 960, 920, 880, 840, 800, 760, 720]
DISAGG_KILL_SEEN = 8
DISAGG_DECODE_WORKERS = 2
# 17a's model: bf16 gpt_1p3b at full width cut to 8 layers (its reference,
# its weights file and both workers' boots and state fingerprints scale
# with the depth; every check holds at any depth)
DISAGG_LAYERS = 8


def disagg_reference(model, serving, pa, waves, card):
    """The in-process reference of 17a along the workers' cache path (a
    bf16 stream follows its path's bits): engine P, chunked prefill of
    DISAGG_CHUNK publishing into a disk directory of its own, serves each
    prompt with ``max_new_tokens=1``; engine D, tiered on P's directory,
    serves ``submit(prompt, journal=[first])``, wave after wave in the
    workers' order. Returns each wave's streams (first token included),
    P's tier namespace and the parent's fingerprint seconds."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.serving.tiered import HostKVCache

    dev = model.gpt.wte.weight.device
    shutil.rmtree(DISAGG_REF_DIR, ignore_errors=True)

    def engine(chunk):
        return serving.ServingAPI(model, serving.ServingConfig(
            num_slots=POOL_SLOTS, prefix_cache=True, kv_tiering=True,
            chunked_prefill=chunk, tier_store=HostKVCache(
                max_bytes=DISAGG_HOST_BYTES, disk_dir=DISAGG_REF_DIR)),
            device=dev)

    pre, dec = engine(DISAGG_CHUNK), engine(0)
    keep = flags.get_flags(["serving_publish_chunks", "serving_tier_publish"])
    out = []
    try:
        for i, (prompts, kws) in enumerate(waves):
            n = len(prompts)
            flags.set_flags({"serving_publish_chunks": True,
                             "serving_tier_publish": True})
            try:
                firsts = serve(pre, pa, prompts, [1] * n,
                               f"bf16 disagg reference P, wave {i}", card,
                               kws)[0]
            finally:
                flags.set_flags(keep)
            reqs = serve(dec, pa, prompts, [POOL_NEW] * n,
                         f"bf16 disagg reference D, wave {i}", card,
                         [dict(k, journal=[r.tokens[0]])
                          for k, r in zip(kws, firsts)])[0]
            out.append([list(r.tokens) for r in reqs])
        ns = pre.engine.tier.namespace
        fp = pre.engine.fingerprint_seconds
    finally:
        pre.close()
        dec.close()
        shutil.rmtree(DISAGG_REF_DIR, ignore_errors=True)
    return out, ns, fp


def disagg_moved(before, what):
    """Hold one wave's handoffs: every request handed off once, none took
    a degraded route."""
    got = {k: metrics_counter(k) - v for k, v in before.items()}
    if (got["disagg.handoffs"] != POOL_CLIENTS
            or got["disagg.degraded_routes"]):
        raise AssertionError(f"{what}: {got}, want {POOL_CLIENTS} handoffs "
                             "and no degraded route")
    return got


def disagg_counters():
    return {k: metrics_counter(k) for k in (
        "disagg.handoffs", "disagg.degraded_routes", "disagg.prefetches",
        "disagg.prefetched_chains")}


def disagg_submit_wave(pool, prompts, kws, want, what, card):
    """One wave through ``pool.submit``: streams equal the reference's;
    returns tokens/s (host clock)."""
    t0 = time.perf_counter()
    rrs = [pool.submit(p, max_new_tokens=POOL_NEW, tenant="inproc", **k)
           for p, k in zip(prompts, kws)]
    got = [list(map(int, pool.result(rr, timeout=600)[len(p):]))
           for rr, p in zip(rrs, prompts)]
    rate = POOL_NEW * len(prompts) / (time.perf_counter() - t0)
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"{what}: requests {bad} diverge from the "
                             "reference's")
    print(f"e2e {what}: all {len(prompts)} streams equal the reference, "
          f"{rate:.1f} tokens/s [{card}]")
    return rate


def disagg_ttft(pool, sysp, vocab, card):
    """First token and first-to-second gap (host ms) of POOL_TTFT hits
    through ``pool.submit`` one at a time: the prefill worker's first
    token, then the handoff."""
    rng = np.random.default_rng(95)
    first, gap = [], []
    for _ in range(POOL_TTFT):
        p = np.concatenate([sysp, rng.integers(0, vocab, POOL_TAIL)])
        t0 = time.perf_counter()
        rr = pool.submit(p, max_new_tokens=8, tenant="ttft")
        it = pool.stream(rr)
        next(it)
        t1 = time.perf_counter()
        next(it)
        t2 = time.perf_counter()
        first.append((t1 - t0) * 1e3)
        gap.append((t2 - t1) * 1e3)
        pool.result(rr, timeout=120)
    print(f"bf16 disagg first token of a {POOL_PREFIX} + {POOL_TAIL} hit "
          f"through pool.submit, median of {POOL_TTFT} (ms): "
          f"{np.median(first):.3f}, first to second token "
          f"{np.median(gap):.3f}; samples {[round(x, 3) for x in first]} / "
          f"{[round(x, 3) for x in gap]} [{card}]")
    return float(np.median(first)), float(np.median(gap))


def serve_disagg_bf16(model, serving, pa, card, pool15, fleet16):
    """Phase 17a (bf16 gpt_1p3b cut to DISAGG_LAYERS layers): the reference
    of (f), then ``serve()``
    with FLAGS_gateway_process_replicas and one prefill and one decode
    worker of POOL_SLOTS slots (chunks of DISAGG_CHUNK on the prefill
    role), both primed; 15b's wave through ``POST /v1/stream``, another
    through ``pool.submit``, first tokens and handoff gaps of hits, and a
    third wave with FLAGS_gateway_prefetch on a full decode worker.
    Returns the HTTP wave's launches (per role and summed) and the
    numbers."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.serving.disagg import DisaggReplicaPool
    from paddle_tpu_torch.serving.gateway import serve as serve_gateway_http

    layers, vocab = model.cfg.num_layers, model.cfg.vocab_size
    dev = model.gpt.wte.weight.device
    sysp = pool_prefixes(vocab, 91, 1)[0]
    primer = np.concatenate([sysp, np.arange(POOL_TAIL) + 7])
    hit = np.concatenate([sysp, np.arange(POOL_TAIL)])
    waves = [pool_wave(vocab, sysp, s) for s in (92, 94, 96)]
    t0 = time.perf_counter()
    want, ref_ns, ref_fp = disagg_reference(
        model, serving, pa,
        [([primer], [{}]), ([hit], [{}])] + waves, card)
    out = {"reference_s": time.perf_counter() - t0,
           "fingerprint_s_parent": ref_fp}
    release()
    shutil.rmtree(DISAGG_DIR, ignore_errors=True)
    free0 = free_bytes()
    role_flags = {"gateway_process_replicas": True,
                  "gateway_prefill_replicas": 1,
                  "gateway_decode_replicas": 1,
                  "serving_chunked_prefill": DISAGG_CHUNK,
                  "serving_host_cache_bytes": DISAGG_HOST_BYTES}
    keep = flags.get_flags(list(role_flags))
    flags.set_flags(role_flags)
    t0 = time.perf_counter()
    try:
        gw = serve_gateway_http(
            model, guard=False, port=0, device=dev,
            config=serving.ServingConfig(num_slots=POOL_SLOTS),
            heartbeat_interval=FLEET_HB, disk_dir=DISAGG_DIR)
    finally:
        flags.set_flags(keep)
    out["spawn_s"] = time.perf_counter() - t0
    pool = gw.pool
    base = f"http://127.0.0.1:{gw.port}"
    procs = [rep.api.proc for rep in pool.replicas()]
    try:
        if not isinstance(pool, DisaggReplicaPool):
            raise AssertionError(f"serve() built {type(pool).__name__}")
        ws = pool.worker_stats()
        roles = [pool.role_of(i) for i in sorted(ws)]
        out["boot_s"] = [rep.api.boot_seconds for rep in pool.replicas()]
        out["fingerprint_s"] = [ws[i]["tier"]["fingerprint_s"]
                                for i in sorted(ws)]
        names = {ws[i]["tier"]["namespace"] for i in ws}
        print(f"e2e bf16 disagg: roles {roles} up in {out['spawn_s']:.2f} "
              f"s (spawn to hello {[round(s, 2) for s in out['boot_s']]} s;"
              f" state fingerprint {[round(s, 2) for s in out['fingerprint_s']]}"
              f" s, the parent's {ref_fp:.2f} s); tier namespaces "
              f"{sorted(names)}, the reference's {ref_ns} [{card}]")
        if names != {ref_ns}:
            raise AssertionError("bf16 disagg: the workers' tier signatures "
                                 "differ from each other or the reference's")
        if any(s["imports"] for s in ws.values()):
            raise AssertionError(f"a worker imported "
                                 f"{[s['imports'] for s in ws.values()]}")
        # prime: a miss of the shared prefix (the prefill role's chunk
        # buckets; the decode role's restore, suffix bucket and decode),
        # then a hit (the prefill role's suffix bucket)
        for p, w, what in ((primer, want[0][0], "primer"),
                           (hit, want[1][0], "first hit")):
            rr = pool.submit(p, max_new_tokens=POOL_NEW, tenant="prime")
            got = list(map(int, pool.result(rr, timeout=600)[len(p):]))
            if got != w:
                raise AssertionError(f"bf16 disagg {what}: diverges from "
                                     "the reference's")
        built = fleet_builds(pool)
        out["free_up"] = free_bytes()
        tier0 = {i: dict(s["metrics"]) for i, s in
                 pool.worker_stats().items()}
        lat0 = {i: s["latency"].get("latency.restore", [0, 0.0])
                for i, s in pool.worker_stats().items()}
        what = "bf16 disagg HTTP wave"
        moved = disagg_counters()
        by_worker, wall, results = fleet_http_wave(
            pool, base, layers, *waves[0], want[2], card, what=what,
            label=lambda idx: f"{pool.role_of(idx)} worker")
        disagg_moved(moved, what)
        launches = {pool.role_of(i): got for i, got in by_worker.items()}
        launches["total"] = summed(by_worker.values())
        gaps = [t[1] - t[0] for _, _, t in results]
        print(f"e2e {what}: all {POOL_CLIENTS} handed off; first token "
              f"(ms) median {np.median([t[0] for _, _, t in results]):.3f},"
              f" first to second token (the handoff) median "
              f"{np.median(gaps):.3f}, max {max(gaps):.3f} [{card}]")
        out["tokens_per_s_http"] = POOL_NEW * POOL_CLIENTS / wall
        out["handoff_gap_ms"] = [round(g, 3) for g in gaps]
        moved = disagg_counters()
        out["tokens_per_s_submit"] = disagg_submit_wave(
            pool, *waves[1], want[3], "bf16 disagg pool.submit wave", card)
        disagg_moved(moved, "bf16 disagg pool.submit wave")
        out["ttft_pool_ms"], out["handoff_pool_ms"] = disagg_ttft(
            pool, sysp, vocab, card)
        # the third wave: the decode worker's slots fill, the rest wait
        # and the planner restores their chains ahead
        moved = disagg_counters()
        keep = flags.get_flags("gateway_prefetch")
        flags.set_flags({"gateway_prefetch": DISAGG_PREFETCH})
        try:
            out["tokens_per_s_prefetch"] = disagg_submit_wave(
                pool, *waves[2], want[4],
                f"bf16 disagg wave with FLAGS_gateway_prefetch="
                f"{DISAGG_PREFETCH}", card)
        finally:
            flags.set_flags(keep)
        got = disagg_moved(moved, "bf16 disagg prefetch wave")
        ws = pool.worker_stats()
        pre_i = next(i for i in ws if pool.role_of(i) == "prefill")
        dec_i = next(i for i in ws if pool.role_of(i) == "decode")
        out["prefetches"] = got["disagg.prefetches"]
        out["prefetched_blocks"] = ws[dec_i]["metrics"].get(
            "disagg.prefetched_blocks", 0)
        print(f"e2e bf16 disagg prefetch wave: {got['disagg.prefetches']} "
              f"prefetch calls, {got['disagg.prefetched_chains']} restored "
              f"a chain, {out['prefetched_blocks']} blocks restored ahead in "
              f"the decode worker [{card}]")
        if not got["disagg.prefetches"]:
            raise AssertionError("bf16 disagg: no prefetch fired on a full "
                                 "decode worker")
        if fleet_builds(pool) != built:
            raise AssertionError(f"bf16 disagg: a worker built a program "
                                 f"during the waves: {built} -> "
                                 f"{fleet_builds(pool)}")
        tier = {i: {k: s["metrics"].get(k, 0) - tier0[i].get(k, 0)
                    for k in ("tier.published_blocks", "tier.disk_writes",
                              "tier.disk_hits", "tier.host_hits",
                              "tier.restored_blocks", "tier.restored_bytes",
                              "tokens.prefill_avoided")}
                for i, s in ws.items()}
        n, total = (a - b for a, b in zip(
            ws[dec_i]["latency"].get("latency.restore", [0, 0.0]),
            lat0[dec_i]))
        out["restore_ms_mean"] = total / max(n, 1) * 1e3
        out["restores"] = n
        out["published_bytes"] = ws[pre_i]["metrics"].get("tier.disk_bytes")
        out["tier"] = {pool.role_of(i): t for i, t in tier.items()}
        print(f"e2e bf16 disagg tiers over the three waves: "
              f"{json.dumps(out['tier'])}; the prefill worker's disk tier "
              f"holds {out['published_bytes']} bytes; the decode worker "
              f"restored {n} chains in {out['restore_ms_mean']:.3f} ms each "
              f"(mean; {out['restore_ms_mean'] / np.median(gaps):.3f} of the "
              f"HTTP wave's median handoff gap) [{card}]")
        if (not tier[pre_i]["tier.published_blocks"]
                or not tier[dec_i]["tier.disk_hits"]
                or not tier[dec_i]["tier.restored_blocks"]):
            raise AssertionError("bf16 disagg: the chains did not go "
                                 "through the shared disk tier")
        out["worker_memory_allocated"] = [
            s.get("memory_allocated") for s in ws.values()]
    finally:
        gw.close()
        shutil.rmtree(DISAGG_DIR, ignore_errors=True)
    if any(p.is_alive() for p in procs):
        raise AssertionError("bf16 disagg: a worker outlived close()")
    out["free_before_spawn"], out["free_up_primed"] = free0, out["free_up"]
    print(f"bf16 disagg tokens/s ({POOL_CLIENTS} requests of {POOL_PREFIX} "
          f"+ {POOL_TAIL} + {POOL_NEW}, host clock): 1 prefill + 1 decode "
          f"worker x {POOL_SLOTS} through HTTP {out['tokens_per_s_http']:.1f}"
          f", through pool.submit {out['tokens_per_s_submit']:.1f}, with "
          f"prefetch {out['tokens_per_s_prefetch']:.1f}; this call's 16a "
          f"(two unified workers x {POOL_SLOTS}, no tiers) HTTP "
          f"{fleet16['tokens_per_s_http']:.1f}, pool.submit "
          f"{fleet16['tokens_per_s_submit']:.1f}, first token of a hit "
          f"{fleet16['ttft_pool_ms']:.3f} ms against "
          f"{out['ttft_pool_ms']:.3f} here; 15b's in-process pool through "
          f"pool.submit {pool15['tokens_per_s_pool_submit']:.1f} [{card}]")
    return launches, out


def serve_disagg_f32(gpt, serving, arrays, card):
    """Phase 17b (f32, TF32 off, gpt_1p3b's width at POOL_F32[0] layers):
    one prefill and DISAGG_DECODE_WORKERS decode workers, chunks of one
    block. A first wave builds; ``worker_kill`` SIGKILLs the prefill worker
    mid-prompt and its streams' successors prefill only what it had not
    published; the decode worker holding more streams is SIGKILLed
    mid-decode and the other restores their published chains;
    ``scale_to(prefill=0)`` leaves unified routes. Every stream equals
    ``generate()``; after ``close()`` no worker is alive and the minted
    disk directory is gone. Returns the numbers."""
    from paddle_tpu_torch.core import flags, resilience
    from paddle_tpu_torch.serving import telemetry
    from paddle_tpu_torch.serving.disagg import DisaggReplicaPool

    _, lens, new = POOL_F32
    model = f32_cut(gpt, arrays)
    dev = model.gpt.wte.weight.device
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(97)
    prompts = [rng.integers(0, vocab, n) for n in lens]
    long_ps = [rng.integers(0, vocab, n) for n in DISAGG_KILL_LENS]
    # the decode kill's prompts are new to both decode workers, so that
    # the survivor must restore each moved stream's chain
    kill_ps = [rng.integers(0, vocab, n) for n in lens]

    def refs(ps, n):
        return [model.generate(p[None], max_new_tokens=n)[0, len(p):]
                .tolist() for p in ps]

    # the references run on this card while the workers boot
    ref_pool = ThreadPoolExecutor(1)
    wants = ref_pool.submit(lambda: (refs(prompts, new), refs(long_ps, new),
                                     refs(kill_ps, FLEET_KILL_NEW)))

    def hold(rrs, ps, ref, what):
        for rr, p, w in zip(rrs, ps, ref):
            got = list(map(int, pool.result(rr, timeout=300)[len(p):]))
            if got != w[:rr.max_new_tokens]:
                raise AssertionError(f"{what}: a stream diverges from "
                                     "generate()")
        print(f"e2e {what}: all {len(rrs)} streams equal generate() "
              f"[{card}]")

    def kinds(rr):
        return [e["event"] for e in telemetry.trace(rr.trace_id)]

    out = {}
    # fault injection and spans for the whole phase (the parent arms
    # worker_kill and reads the spans); the chunks go in the snapshot
    phase_flags = {"fault_injection": True, "serving_telemetry": True,
                   "serving_chunked_prefill": DISAGG_F32_CHUNK}
    keep = flags.get_flags(list(phase_flags))
    flags.set_flags(phase_flags)
    pool = None
    try:
        pool = DisaggReplicaPool(
            model, prefill_replicas=1, decode_replicas=DISAGG_DECODE_WORKERS,
            background=True, num_slots=POOL_SLOTS,
            respawn_backoff=FLEET_BACKOFF, heartbeat_interval=FLEET_HB,
            heartbeat_misses=FLEET_MISSES, device=dev)
        want, want_long, want_kill = wants.result()
        disk = pool.disk_dir
        procs = [rep.api.proc for rep in pool.replicas()]
        hold([pool.submit(p, max_new_tokens=new) for p in prompts], prompts,
             want, "f32 disagg, first wave")
        prefill = pool.replicas()[0]

        # worker_kill the prefill worker mid-prompt, once it has published
        # DISAGG_KILL_SEEN blocks of this wave
        pub0 = prefill.api.remote_stats()["metrics"].get(
            "tier.published_blocks", 0)
        rrs = [pool.submit(p, max_new_tokens=new) for p in long_ps]
        wait_for(lambda: prefill.api.remote_stats()["metrics"].get(
            "tier.published_blocks", 0) >= pub0 + DISAGG_KILL_SEEN,
            "the prefill worker's first published blocks", 120)
        kills0 = resilience._counts.get("fault.worker_kill", 0)
        resilience.inject_fault("worker_kill", times=1)
        wait_for(lambda: resilience._counts.get("fault.worker_kill", 0)
                 > kills0, "the watchdog's kill", 60)
        what = "f32 disagg, the prefill worker killed mid-prompt"
        hold(rrs, long_ps, want_long, what)
        moved = [rr for rr in rrs if rr.reroutes]
        resumed = []
        for rr, p in zip(rrs, long_ps):
            if not rr.reroutes:
                continue
            k = kinds(rr)
            after = k[k.index(telemetry.REROUTED):]
            chunks = after.count(telemetry.PREFILL_CHUNK)
            if telemetry.RESTORED in after:
                resumed.append((len(p), chunks))
        out["prefill_kill"] = {"rerouted": len(moved),
                               "resumed_len_chunks": resumed}
        print(f"e2e {what}: {len(moved)} streams re-routed; those whose "
              f"chain was partly published restored it and prefilled "
              f"(prompt tokens, chunks of {DISAGG_F32_CHUNK} after the "
              f"re-route) {resumed} [{card}]")
        if not moved or not resumed or any(
                chunks * DISAGG_F32_CHUNK >= n for n, chunks in resumed):
            raise AssertionError(f"{what}: no successor prefilled only the "
                                 "unpublished suffix")
        wait_for(lambda: prefill.generation == 1 and prefill.healthy,
                 "the prefill worker's respawn", 120)
        procs.append(prefill.api.proc)

        # SIGKILL a decode worker mid-decode: the one holding more handed
        # off streams that are early in their decode (under half their
        # budget seen: far from their end when the signal lands)
        rrs = [pool.submit(p, max_new_tokens=FLEET_KILL_NEW)
               for p in kill_ps]

        def early():
            out = {}
            for rr in rrs:
                n = len(rr.tokens())
                if (pool._phase(rr) == "decode" and not rr.finished
                        and 2 <= n < FLEET_KILL_NEW // 2):
                    out.setdefault(rr._replica_idx, []).append(rr)
            return out

        wait_for(lambda: max(map(len, early().values()), default=0) >= 2,
                 "two streams decoding on one decode worker", 120)
        victim, taken = max(early().items(), key=lambda kv: len(kv[1]))
        os.kill(pool._replica_at(victim).api.pid, signal.SIGKILL)
        what = "f32 disagg, a decode worker killed mid-decode"
        hold(rrs, kill_ps, want_kill, what)
        restored = []
        for rr in taken:
            k = kinds(rr)
            after = k[k.index(telemetry.REROUTED):] \
                if telemetry.REROUTED in k else []
            restored.append(telemetry.RESTORED in after)
        out["decode_kill"] = {"rerouted": sum(rr.reroutes for rr in taken),
                              "restored": restored}
        print(f"e2e {what}: the {len(taken)} streams it held early in "
              f"their decode re-routed to the other decode worker, which "
              f"restored their published chains ({restored}) [{card}]")
        if not taken or any(rr.reroutes != 1 for rr in taken) \
                or not all(restored):
            raise AssertionError(f"{what}: {out['decode_kill']}")
    except BaseException:
        ref_pool.shutdown(wait=True)
        if pool is not None:
            pool.close()
        resilience.clear_faults()
        flags.set_flags(keep)
        raise
    ref_pool.shutdown(wait=True)

    def finish():
        """The decode worker's respawn (it boots while phase 7 runs), the
        prefill role scaled to zero, then ``close()``: no worker outlives
        it and the minted disk directory is gone."""
        nonlocal procs
        try:
            wait_for(lambda: all(r.healthy for r in pool.replicas()),
                     "the decode worker's respawn", 300)
            # scale the prefill role to zero: unified routes
            pool.scale_to(prefill=0)
            d0 = metrics_counter("disagg.degraded_routes")
            h0 = metrics_counter("disagg.handoffs")
            what = "f32 disagg, the prefill role scaled to zero"
            hold([pool.submit(p, max_new_tokens=new) for p in prompts],
                 prompts, want, what)
            out["degraded_routes"] = metrics_counter(
                "disagg.degraded_routes") - d0
            if (out["degraded_routes"] != len(prompts)
                    or metrics_counter("disagg.handoffs") != h0):
                raise AssertionError(f"{what}: {out['degraded_routes']} "
                                     "degraded routes, or a handoff")
            procs += [rep.api.proc for rep in pool.replicas()]
        finally:
            pool.close()
            resilience.clear_faults()
            flags.set_flags(keep)
        if any(p.is_alive() for p in procs):
            raise AssertionError("f32 disagg: a worker outlived close()")
        if os.path.exists(disk):
            raise AssertionError("f32 disagg: the minted disk directory "
                                 "stayed")
        print(f"e2e f32 disagg: none of the {len(procs)} worker processes "
              f"is alive after close(), the minted directory {disk} is gone "
              f"[{card}]")
        release()
        return out

    return out, finish


def serve_disagg(gpt, serving, pa, arrays, card, pool15, fleet16):
    """Phase 17: 17a on bf16 gpt_1p3b cut to DISAGG_LAYERS layers, 17b in
    f32 at POOL_F32[0] layers. Returns 17a's HTTP-wave launches (per role
    and summed) and the numbers."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=DISAGG_LAYERS)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    model.to(torch.bfloat16)
    release()
    t0 = time.perf_counter()
    launches, out = serve_disagg_bf16(model, serving, pa, card, pool15,
                                      fleet16)
    out = {"bf16": out}
    print(f"phase 17a: {time.perf_counter() - t0:.1f} s")
    del model
    release()
    t0 = time.perf_counter()
    out["f32"], finish_17b = serve_disagg_f32(gpt, serving, arrays, card)
    print(f"phase 17b: {time.perf_counter() - t0:.1f} s (its tail runs "
          "after phase 7)")
    return launches, out, finish_17b


# ------------------------------------------------------------------ phase 18

# 18a's predictor runs; the flag-0 program sends the lengths 1000 and 5
# (outside ``_shapes_ok``) to the kernel where eager takes the plain route
EXPORT_SHAPES = ((2, 2048), (4, 512), (3, 1000), (2, 5))
EXPORT_LAYERS = 8                      # phase 18's depth
EXPORT_DIR = os.path.join("build", "export_chip")
STATIC_SHAPE = (2, 2048)               # 18b's captured forward
BUCKET_BATCHES = (3, 5)                # 18b's bucketed batches, one bucket
BUCKET_SEQ = 512


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def hold_logits(got, want, what, card):
    """Logits against the eager model's on the same route: finite, the
    same shape, relative L2 within ``ROUTE_TOL["bf16"][1]``; prints
    whether they are bit-equal. Returns (relative L2, bit-equal)."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: logits {tuple(got.shape)} (want "
                             f"{tuple(want.shape)}) or not finite")
    err = rel_l2(got.float(), want.float())
    same = bool(torch.equal(got.float(), want.float()))
    print(f"e2e {what}: relative L2 {err:.3e} (bound "
          f"{ROUTE_TOL['bf16'][1]:g}), bit-equal {same} [{card}]")
    if err > ROUTE_TOL["bf16"][1]:
        raise AssertionError(f"{what}: logits off the eager model's by "
                             f"{err:.3e}")
    return err, same


def host_ms(fn, iters=5) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def device_ms(fn, iters=5) -> float:
    """Median ms of ``fn`` between CUDA events on the current stream (no
    flush: a forward reads far more than L2)."""
    fn()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def export_routes(model, fa, flags, jit, inference, card):
    """18a: the model saved under the flag at 0 and at auto, each run by a
    predictor at EXPORT_SHAPES against the eager model."""
    layers = model.cfg.num_layers
    rng = np.random.default_rng(18)
    ids = [rng.integers(0, model.cfg.vocab_size, shape) for shape in
           EXPORT_SHAPES]
    out = {}
    for flag, want in ((0, layers), (-1, 0)):
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": flag})
        prefix = os.path.join(EXPORT_DIR, f"gpt_flag{flag}")
        t0 = time.perf_counter()
        jit.save(model, prefix, input_spec=[jit.InputSpec([None, None],
                                                          "int64")])
        save_s = time.perf_counter() - t0
        sizes = {ext: os.path.getsize(prefix + ext)
                 for ext in (".pdmodel", ".pdparams")}
        t0 = time.perf_counter()
        pred = inference.create_predictor(
            inference.Config(prefix + ".pdmodel"))
        load_s = time.perf_counter() - t0
        row = dict(save_s=round(save_s, 2), load_s=round(load_s, 2),
                   **{f"bytes{ext.replace('.', '_')}": n
                      for ext, n in sizes.items()})
        print(f"e2e export flag {flag}: jit.save {save_s:.1f} s, .pdmodel "
              f"{sizes['.pdmodel']} bytes, .pdparams {sizes['.pdparams']} "
              f"bytes; predictor loaded in {load_s:.1f} s [{card}]")
        for a, shape in zip(ids, EXPORT_SHAPES):
            with torch.no_grad():
                eager = model(torch.from_numpy(a).cuda()).float().cpu()
            fa.reset_launches()
            got = torch.from_numpy(pred.run([a])[0])
            torch.cuda.synchronize()
            n = fa.launches["flash_forward"]
            if n != want or fa.launches["flash_backward_dkv"] \
                    or fa.launches["flash_backward_dq"]:
                raise AssertionError(f"export flag {flag} {shape}: launches "
                                     f"{dict(fa.launches)}, want "
                                     f"flash_forward {want}")
            err, same = hold_logits(got, eager, f"export flag {flag} "
                                    f"{list(shape)}", card)
            x = torch.from_numpy(a).cuda()
            ms = host_ms(lambda: pred.run([a]), iters=2)  # 0.2-0.5 s each
            layer_ms = host_ms(lambda: pred._layer(x))
            layer_dev = device_ms(lambda: pred._layer(x))
            with torch.no_grad():
                eager_ms = host_ms(lambda: model(x))
                eager_dev = device_ms(lambda: model(x))
            print(f"e2e export flag {flag} {list(shape)}: {n} flash_forward "
                  f"launches a run; predictor.run {ms:.2f} ms (host, with "
                  f"its copies: the logits to numpy), the loaded program on "
                  f"a device input {layer_ms:.2f} ms host / {layer_dev:.2f} "
                  f"ms between events, eager forward {eager_ms:.2f} / "
                  f"{eager_dev:.2f} ms ({threading.active_count()} Python "
                  f"threads alive) [{card}]")
            row[str(list(shape))] = dict(
                launches=n, rel_l2=err, bit_equal=same, run_ms=ms,
                program_ms=layer_ms, program_event_ms=layer_dev,
                eager_ms=eager_ms, eager_event_ms=eager_dev,
                threads=threading.active_count())
        out[f"flag {flag}"] = row
        del pred
        release()
    return out


def static_graphs(model, fa, flags, jit, compile_cache, card):
    """18b: a to_static forward captured on the card, its buckets, and
    weights loaded in place and replaced."""
    layers = model.cfg.num_layers
    flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    rng = np.random.default_rng(19)
    ids = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                        STATIC_SHAPE)).cuda()
    fwd = jit.to_static(lambda x: model(x))
    before = compile_cache.stats()
    with torch.no_grad():
        eager = model(ids)
        first = fwd(ids)
        fa.reset_launches()
        again = fwd(ids)
        torch.cuda.synchronize()
        credited = dict(fa.launches)
        fwd(ids)
    moved = compile_cache.stats_delta(before, compile_cache.stats(),
                                      drop_zero=True)
    want = {"to_static.misses": 1, "to_static.hits": 2,
            "to_static.captures": 1}
    if {k: moved.get(k, 0) for k in want} != want or fwd.builds != 1:
        raise AssertionError(f"to_static counters {moved}, builds "
                             f"{fwd.builds}; want {want} and one build")
    if credited != {"flash_forward": layers, "flash_backward_dkv": 0,
                    "flash_backward_dq": 0}:
        raise AssertionError(f"to_static replay credited {credited}, want "
                             f"{layers} flash_forward launches")
    for what, got in (("first call", first), ("replay", again)):
        if not torch.equal(got, eager):
            raise AssertionError(f"to_static {what} differs from eager by "
                                 f"{rel_l2(got.float(), eager.float()):.3e}")
    with torch.no_grad():
        eager_ms = host_ms(lambda: model(ids))
        graph_ms = host_ms(lambda: fwd(ids))
        eager_dev = device_ms(lambda: model(ids))
        graph_dev = device_ms(lambda: fwd(ids))
    print(f"e2e to_static {list(STATIC_SHAPE)}: captured once "
          f"({moved}), bit-equal to eager, {layers} flash_forward launches "
          f"credited a replay; eager {eager_ms:.2f} ms, graphed "
          f"{graph_ms:.2f} ms (host, median of 5; between events "
          f"{eager_dev:.2f} / {graph_dev:.2f}) [{card}]")
    out = dict(counters=moved, launches=credited["flash_forward"],
               eager_ms=eager_ms, graph_ms=graph_ms,
               eager_event_ms=eager_dev, graph_event_ms=graph_dev)

    bucketed = jit.to_static(lambda x: model(x), bucket_batch=True)
    errs = []
    with torch.no_grad():
        for b in BUCKET_BATCHES:
            x = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                              (b, BUCKET_SEQ))).cuda()
            got = bucketed(x)
            errs.append(hold_logits(got, model(x), f"to_static bucket_batch "
                                    f"{b} x {BUCKET_SEQ}", card))
    if bucketed.builds != 1:
        raise AssertionError(f"bucket_batch {BUCKET_BATCHES}: "
                             f"{bucketed.builds} graphs, want 1")
    out["bucket"] = dict(builds=bucketed.builds, readings=errs)
    del bucketed

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    other = {k: v.roll(1, 0) for k, v in saved.items()}
    with torch.no_grad():
        for what, assign, builds in (("load_state_dict", False, 1),
                                     ("load_state_dict(assign=True)", True,
                                      2)):
            model.load_state_dict(other if not assign else {
                k: v.clone() for k, v in saved.items()}, assign=assign)
            got = fwd(ids)
            if fwd.builds != builds or not torch.equal(got, model(ids)):
                raise AssertionError(f"to_static after {what}: builds "
                                     f"{fwd.builds} (want {builds}), equal "
                                     "to eager on the new weights: "
                                     f"{torch.equal(got, model(ids))}")
            print(f"e2e to_static after {what}: {fwd.builds} build(s), "
                  f"bit-equal to eager on the new weights [{card}]")
    out["builds_after_assign"] = fwd.builds
    return out


def serve_export(gpt, fa, arrays, card):
    """Phase 18: 18a and 18b on bf16 gpt_1p3b cut to EXPORT_LAYERS layers.
    Returns the flash forward's launches a run of 18a's flash program and
    a replay of 18b's graph, and the numbers."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.core import compile_cache, flags

    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=EXPORT_LAYERS)
    model = gpt.GPTForCausalLM(cfg, device="cuda")
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    model.to(torch.bfloat16)
    model.eval()
    old = flags.get_flags(["FLAGS_flash_attention_min_seqlen"])
    try:
        t0 = time.perf_counter()
        out = {"export": export_routes(model, fa, flags, jit, inference,
                                       card)}
        print(f"phase 18a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["to_static"] = static_graphs(model, fa, flags, jit,
                                         compile_cache, card)
        print(f"phase 18b: {time.perf_counter() - t0:.1f} s")
    finally:
        flags.set_flags(old)
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    del model
    release()
    print("phase 18, one call: " + json.dumps(out) + f" [{card}]")
    launches = {"launches_export": out["export"]["flag 0"][
        str(list(EXPORT_SHAPES[0]))]["launches"],
        "launches_to_static": out["to_static"]["launches"]}
    return launches, out


# ------------------------------------------------------------------ phase 19
# tensor-parallel serving: 19a tp = 1 over NCCL with its collectives in the
# captured graphs, 19b tp = 2 as two ranks on the one card over gloo (CUDA
# tensors, programs uncaptured), 19c NCCL at tp = 2 and 4, one rank per card
TP_SLOTS = 8
TP_WAVE = (512, 64)        # 19a's wave: phase 6's greedy wave (8 x 512, 64)
TP_CHURN = ([400, 512, 420, 390, 505, 433, 470, 460], 16)  # bucket 512
TP_BF16_NEW = 16           # 19b's bf16 wave: TP_WAVE's prompts, 16 new
TP_TIMEOUT = 120.0         # the mesh's collective and control timeout, s
TP_POS = TP_WAVE[0] + TP_WAVE[1] // 2   # 19b's decode timing positions


class LogitSink:
    """Watches a model's head (``_head_logits``, which the serving
    programs call): every call adds the bits of its logits to a device
    checksum and copies them into a buffer kept per row count, both made
    before any capture, so a captured program's replays update them too."""

    def __init__(self, model, vocab, rows=(TP_SLOTS, 1), dtype=None):
        self.model = model
        self.head = model._head_logits
        dtype = dtype or model.gpt.wte.weight.dtype
        self.bits = torch.zeros((), dtype=torch.int64, device="cuda")
        self.last = {r: torch.zeros((r, vocab), dtype=dtype, device="cuda")
                     for r in rows}
        model._head_logits = self

    def __call__(self, h):
        out = self.head(h)
        view = torch.int16 if out.element_size() == 2 else torch.int32
        self.bits.add_(out.view(view).to(torch.int64).sum())
        self.last[out.shape[0]].copy_(out)
        return out

    def detach(self):
        del self.model._head_logits


def count_captured_collectives():
    """Counts every all-reduce the parallel layers and the int8 arena's
    scale reduction issue, by whether a CUDA graph is being captured on the
    current stream: ``(counts, undo)``; ``counts["max"]`` the captured
    max-reductions (the int8 scales') among ``counts["captured"]``."""
    from paddle_tpu_torch.distributed import collective

    real = collective.all_reduce
    counts = {"captured": 0, "eager": 0, "max": 0}

    def counting(t, group, op="sum"):
        key = ("captured" if torch.cuda.is_current_stream_capturing()
               else "eager")
        counts[key] += 1
        counts["max"] += key == "captured" and op == "max"
        return real(t, group, op)

    collective.all_reduce = counting

    def undo():
        collective.all_reduce = real
    return counts, undo


def tp_prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def rank_bytes(model, eng):
    """A rank's weight bytes (parameters and buffers) and arena bytes."""
    return (tensor_bytes(list(model.parameters()) + list(model.buffers())),
            eng.arena.bytes_total())


def tp_reference(model, serving, pa, prompts, news, what, card, prime=True,
                 **kw):
    """One engine without a mesh over ``prompts`` (``kw``: the config's
    other fields): a priming wave (every program built), then the measured
    wave with the launch counters set to 0 just before. Returns the tokens,
    launches, engine facts, the logit sink's checksum and the int8 scale
    pools' digest."""
    from paddle_tpu_torch.serving import tp as tpmod

    vocab = model.cfg.vocab_size
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=TP_SLOTS, **kw), device="cuda")
    sink = LogitSink(model, vocab)
    try:
        if prime:
            serve(api, pa, prompts, news, f"{what} (priming)", card)
        sink.bits.zero_()
        reqs, launches, ran = serve(api, pa, prompts, news, what, card)
        eng = api.engine
        out = dict(tokens=[list(map(int, r.tokens)) for r in reqs],
                   launches=launches, ran=ran,
                   graphs=eng._graphs.graph_count(),
                   builds=builds(eng), bytes=rank_bytes(model, eng),
                   bits=int(sink.bits), last=sink.last[TP_SLOTS].clone(),
                   last_prefill=sink.last[1].clone(),
                   digest=tpmod.scale_digest(eng.arena))
    finally:
        api.close()
        sink.detach()
    return out


def tp_first_logits(api, model, prompt, pa, what, card):
    """The first token's logits of ``prompt`` through ``api`` (a request
    of one new token: one prefill)."""
    sink = LogitSink(model, model.cfg.vocab_size)
    try:
        serve(api, pa, [prompt], [1], what, card)
        return sink.last[1].clone()
    finally:
        sink.detach()


def serve_tp_nccl1(model, serving, pa, tpm, card):
    """19a: bf16 gpt_1p3b (phase 3's seeded weights), 8 slots, phase 6's
    greedy wave; an engine without a mesh, then one on a one-rank NCCL
    mesh (on a copy of the weights: the mesh shards its model in place).
    The mesh engine's NCCL all-reduces are captured in its decode and
    prefill graphs; its tokens, every head call's logits (a checksum of
    their bits) and the last decode step's logits equal the engine
    without a mesh bit for bit; its graphs and launches equal the other's;
    a churn wave of other lengths in the same bucket builds nothing."""
    vocab = model.cfg.vocab_size
    prompts = tp_prompts(vocab, [TP_WAVE[0]] * TP_SLOTS, 2)
    news = [TP_WAVE[1]] * TP_SLOTS
    ref = tp_reference(model, serving, pa, prompts, news,
                       "19a bf16 no mesh", card)
    mesh_model = copy.deepcopy(model)
    mesh = tpm.serving_mesh(1, backend="nccl", timeout=TP_TIMEOUT,
                            install=False)
    counts, undo = count_captured_collectives()
    api = serving.ServingAPI(mesh_model, serving.ServingConfig(
        num_slots=TP_SLOTS, mesh=mesh), device="cuda")
    sink = LogitSink(mesh_model, vocab)
    try:
        eng = api.engine
        serve(api, pa, prompts, news, "19a bf16 tp=1 NCCL (priming)", card)
        captured = dict(counts)
        sink.bits.zero_()
        reqs, launches, ran = serve(api, pa, prompts, news,
                                    "19a bf16 tp=1 NCCL", card)
        tokens = [list(map(int, r.tokens)) for r in reqs]
        st = eng.stats()
        out = dict(mesh_key=st["mesh.key"], captured=st["mesh.captured"],
                   collectives_captured=captured["captured"],
                   graphs=eng._graphs.graph_count(), launches=launches)
        print(f"e2e 19a: mesh {st['mesh.key']} backend {st['mesh.backend']}"
              f", programs captured {st['mesh.captured']}, "
              f"{captured['captured']} NCCL all-reduces captured over "
              f"{out['graphs']} graphs ({captured['eager']} run eagerly: the "
              f"warm-ups and the communicator's first call); graphs "
              f"{out['graphs']} against {ref['graphs']} without a mesh "
              f"[{card}]")
        if not (st["mesh.captured"] and captured["captured"]
                >= (2 * model.cfg.num_layers + 2) * out["graphs"]):
            raise AssertionError(f"19a: the NCCL all-reduces are not in the "
                                 f"graphs ({captured})")
        if tokens != ref["tokens"]:
            raise AssertionError("19a: tp=1 tokens differ from the engine "
                                 "without a mesh")
        if int(sink.bits) != ref["bits"] or not torch.equal(
                sink.last[TP_SLOTS], ref["last"]):
            raise AssertionError("19a: tp=1 logits are not bit-equal to the "
                                 "engine without a mesh")
        if out["graphs"] != ref["graphs"] or builds(eng) != ref["builds"]:
            raise AssertionError(f"19a: {out['graphs']} graphs, builds "
                                 f"{builds(eng)}; without a mesh "
                                 f"{ref['graphs']}, {ref['builds']}")
        if launches != ref["launches"]:
            raise AssertionError(f"19a: launches {launches} != "
                                 f"{ref['launches']}")
        hold_launches(launches, want_launches(model.cfg.num_layers, ran),
                      "19a bf16 tp=1 NCCL")
        before = (builds(eng), eng._graphs.graph_count())
        cp = tp_prompts(vocab, TP_CHURN[0], 3)
        serve(api, pa, cp, [TP_CHURN[1]] * len(cp), "19a churn wave", card)
        if (builds(eng), eng._graphs.graph_count()) != before:
            raise AssertionError("19a: the churn wave built a program")
        print(f"e2e 19a: tokens of all {TP_SLOTS} requests and the logits "
              f"of every head call (bit checksum {ref['bits']}) bit-equal to "
              f"the engine without a mesh; launches {launches} equal; the "
              f"churn wave built nothing [{card}]")
    finally:
        undo()
        api.close()
        sink.detach()
    del mesh_model
    release()
    return ref, out


def serve_tp_gloo_f32(gpt, serving, pa, arrays, tpm, card):
    """19b, f32 (TF32 off) at gpt_1p3b's width cut to POOL_F32[0] layers:
    an engine without a mesh, then tp = 2 on the one card (rank 0 here,
    rank 1 a spawned process on cuda:0, gloo over CUDA tensors): each a
    priming wave, then the measured wave with every rank's launch counters
    set to 0. Greedy tokens equal, each rank's launches equal the one-rank
    engine's, each rank's weight and arena bytes at most 0.55 of its."""
    lens, new = POOL_F32[1], POOL_F32[2]
    model = f32_cut(gpt, arrays)
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    prompts = tp_prompts(vocab, lens, 5)
    news = [new] * len(prompts)
    ref = tp_reference(model, serving, pa, prompts, news,
                       "19b f32 no mesh", card)
    mesh = tpm.serving_mesh(2, backend="gloo", launch="process",
                            timeout=TP_TIMEOUT, install=False)
    t0 = time.perf_counter()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=TP_SLOTS, mesh=mesh), device="cuda")
    boot = time.perf_counter() - t0
    eng = api.engine
    try:
        (follower,) = eng.follower_reports
        if follower["modules"]:
            raise AssertionError(f"19b: the follower imported "
                                 f"{follower['modules']}")
        serve(api, pa, prompts, news, "19b f32 tp=2 (priming)", card)
        eng._tp.send("reset_launches")
        t0 = time.perf_counter()
        reqs, launches, ran = serve(api, pa, prompts, news,
                                    "19b f32 tp=2 gloo", card)
        wave_s = time.perf_counter() - t0
        (follower,) = eng._tp.stats()
        theirs = {k: follower["launches"][k] for k in launches}
        tokens = [list(map(int, r.tokens)) for r in reqs]
        w0, a0 = rank_bytes(model, eng)
        w1, a1 = ref["bytes"]
        shares = [(w0 + a0) / (w1 + a1),
                  (follower["weight_bytes"] + follower["arena_bytes"])
                  / (w1 + a1)]
        st = eng.stats()
        out = dict(boot_s=boot, wave_s=wave_s, launches_rank0=launches,
                   launches_rank1=theirs, byte_shares=shares,
                   local_heads=follower["local_heads"])
        print(f"e2e 19b f32 tp=2: two ranks on {follower['device']} over "
              f"gloo (CUDA tensors); programs captured {st['mesh.captured']}"
              f": the mesh says gloo cannot be captured, so every program "
              f"runs uncaptured over its static buffers (not a fallback); "
              f"engine up in {boot:.2f} s with its follower; the measured "
              f"wave {wave_s:.2f} s; launches rank 0 {launches}, rank 1 "
              f"{theirs}, one rank {ref['launches']}; weight + arena bytes "
              f"per rank {[round(x, 4) for x in shares]} of the one-rank "
              f"engine's; {follower['local_heads']} local heads [{card}]")
        if tokens != ref["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(tokens, ref["tokens"]))
                   if a != b]
            raise AssertionError(f"19b f32: tp=2 tokens differ from the "
                                 f"one-rank engine's in requests {bad}")
        if st["mesh.captured"] or eng._graphs.graph_count():
            raise AssertionError("19b: a gloo mesh captured a graph")
        for rank, got in enumerate((launches, theirs)):
            if got != ref["launches"]:
                raise AssertionError(f"19b f32: rank {rank}'s launches {got}"
                                     f" != the one-rank engine's "
                                     f"{ref['launches']}")
        hold_launches(launches, want_launches(layers, ran), "19b f32 tp=2")
        if max(shares) > 0.55:
            raise AssertionError(f"19b: a rank holds {max(shares):.4f} of "
                                 "the one-rank engine's bytes")
    finally:
        api.close()
    if eng._tp.followers[0].worker.is_alive():
        raise AssertionError("19b: the follower outlived close()")
    del model, api, eng
    release()
    return out


def serve_tp_gloo_bf16(gpt, serving, pa, arrays, tpm, flush, card):
    """19b, bf16 gpt_1p3b at full depth: the first token's logits of the
    wave's first prompt at tp = 2 (gloo, two ranks on the card, the
    follower a thread) within
    ROUTE_TOL["bf16"] of the one-rank engine's, and each one's distance to
    the f32 model's logits (a causal forward) printed beside; the wave's
    token agreement printed; then the decode kernel at the rank's 8 heads
    against its plain version on rank 0's pools, timed beside its
    bound."""
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    vocab = model.cfg.vocab_size
    prompts = tp_prompts(vocab, [TP_WAVE[0]] * TP_SLOTS, 2)
    with torch.no_grad():
        f32_first = model(torch.as_tensor(prompts[0], device="cuda")[None])[
            0, -1:].clone()
    model.to(torch.bfloat16)
    news = [TP_BF16_NEW] * TP_SLOTS
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=TP_SLOTS), device="cuda")
    try:
        want_first = tp_first_logits(api, model, prompts[0], pa,
                                     "19b bf16 no mesh (first token)", card)
        reqs, _, _ = serve(api, pa, prompts, news, "19b bf16 no mesh", card)
        want = [list(map(int, r.tokens)) for r in reqs]
    finally:
        api.close()
    release()
    # the follower is a thread of this process: it boots without a spawn or
    # the 24 layers' trip through a file (19b f32 and the int8 wave hold the
    # process launch), and this run reads no launch counter it would share
    mesh = tpm.serving_mesh(2, backend="gloo", launch="thread",
                            timeout=TP_TIMEOUT, install=False)
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=TP_SLOTS, mesh=mesh), device="cuda")
    eng = api.engine
    out = {}
    try:
        first = tp_first_logits(api, model, prompts[0], pa,
                                "19b bf16 tp=2 (first token)", card)
        out["first_rel_l2"], out["first_bit_equal"] = hold_logits(
            first, want_first, "19b bf16 tp=2 first token's logits", card)
        out["to_f32"] = [rel_l2(x.float(), f32_first) for x in
                         (want_first, first)]
        print(f"e2e 19b bf16 first token's logits against the f32 model's: "
              f"one rank relative L2 {out['to_f32'][0]:.3e}, tp=2 "
              f"{out['to_f32'][1]:.3e} [{card}]")
        reqs, _, _ = serve(api, pa, prompts, news, "19b bf16 tp=2 gloo",
                           card)
        got = [list(map(int, r.tokens)) for r in reqs]
        agree = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
        out["token_agreement"] = agree / (len(want) * TP_BF16_NEW)
        print(f"e2e 19b bf16 tp=2: {agree} of {len(want) * TP_BF16_NEW} "
              f"greedy tokens equal the one-rank engine's (a row-parallel "
              f"sum in bf16 can flip a near tie) [{card}]")
        (follower,) = eng._tp.stats()
        w1 = tensor_bytes(list(model.parameters()) + list(model.buffers()))
        out["weight_bytes"] = [w1, follower["weight_bytes"]]
        out["decode"] = tp_decode_kernel(pa, eng, flush, card)
    finally:
        api.close()
    del model, api, eng
    release()
    return out


def tp_decode_kernel(pa, eng, flush, card):
    """The decode kernel at a tp = 2 rank's 8 heads of 128 on its own pools
    (layer 0, bf16), 8 slots at TP_POS through tables over the arena's
    blocks, against its plain version; its time, the plain version's and
    SDPA's beside its bound (each K/V row up to the position read once)."""
    entry = eng.arena.pools[0]
    heads = int(entry[0].shape[2])
    mb = eng.blocks_per_slot
    gen = torch.Generator(device="cuda").manual_seed(19)
    bt = torch.randint(1, eng.arena.num_blocks, (TP_SLOTS, mb),
                       dtype=torch.int32, device="cuda", generator=gen)
    pos = torch.full((TP_SLOTS,), TP_POS, dtype=torch.int32, device="cuda")
    q = qkv_split(np.random.default_rng(19), TP_SLOTS, heads, D,
                  torch.bfloat16)[0]
    pa.reset_launches()
    err = check("paged_decode_attention", torch.bfloat16,
                f"tp=2 rank 0, {heads} heads",
                pa.paged_decode_attention(q, entry, bt, pos),
                pa.paged_decode_attention_ref(q, entry, bt, pos))
    keys = int((pos.long() + 1).sum())
    tables = 4 * int((pos.long() // BS + 1).sum()) + 4 * TP_SLOTS
    nbytes = 2 * keys * heads * D * 2 + 2 * q.numel() * 2 + tables
    b_ms, b_by = bound(nbytes, 4 * keys * heads * D)
    live = TP_POS + 1
    k_all, v_all = pa._gather_ctx(entry, bt)
    kt, vt = (t[:, :live].transpose(1, 2).contiguous()
              for t in (k_all, v_all))
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = dict(heads=heads, max_abs_err=err,
               ms=time_ms(lambda: pa.paged_decode_attention(q, entry, bt,
                                                            pos), flush),
               plain_ms=time_ms(lambda: pa.paged_decode_attention_ref(
                   q, entry, bt, pos), flush),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: sdpa(q4, kt, vt), flush))
    print(f"kernel paged_decode_attention at a tp=2 rank's {heads} heads, "
          f"{TP_SLOTS} slots at position {TP_POS}: {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, SDPA {res['library_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}) [{card}]")
    return res


def serve_tp_int8(gpt, serving, pa, arrays, tpm, backend, card):
    """The int8 wave at tp = 2 (``quant_weights``, ``quant_kv``, chunks of
    CHUNK) on f32 gpt_1p3b width cut to POOL_F32[0] layers, over
    ``backend``: 19b's gloo ranks on the one card, 19c's NCCL ranks on two
    cards. An engine without a mesh, then the mesh engine (each on a fresh
    model: quant_weights quantizes in place), each a priming wave and the
    measured wave. Greedy tokens equal; each rank's launches equal the
    one-rank engine's, the int8 decode and prefill kernels among them at
    the rank's 8 heads; the scale pools bit-equal on both ranks (a digest:
    each token row's scale is the whole row's, through the max
    all-reduce); under NCCL the programs captured with their max
    all-reduces inside."""
    from paddle_tpu_torch.serving import tp as tpmod

    lens, new = POOL_F32[1], POOL_F32[2]
    kw = dict(quant_weights=True, quant_kv=True, chunked_prefill=CHUNK)
    model = f32_cut(gpt, arrays)
    vocab = model.cfg.vocab_size
    prompts = tp_prompts(vocab, lens, 7)
    news = [new] * len(prompts)
    what = f"int8 tp=2 {backend}"
    ref = tp_reference(model, serving, pa, prompts, news,
                       f"{what}: no mesh", card, **kw)
    model = f32_cut(gpt, arrays)
    mesh = tpm.serving_mesh(2, backend=backend, launch="process",
                            timeout=TP_TIMEOUT, install=False)
    counts, undo = count_captured_collectives()
    api = serving.ServingAPI(model, serving.ServingConfig(
        num_slots=TP_SLOTS, mesh=mesh, **kw), device="cuda")
    eng = api.engine
    try:
        serve(api, pa, prompts, news, f"{what} (priming)", card)
        eng._tp.send("reset_launches")
        reqs, launches, _ = serve(api, pa, prompts, news, what, card)
        (follower,) = eng._tp.stats()
        theirs = {k: follower["launches"][k] for k in launches}
        tokens = [list(map(int, r.tokens)) for r in reqs]
        digests = [tpmod.scale_digest(eng.arena), follower["scale_digest"]]
        captured = eng.stats()["mesh.captured"]
        out = dict(launches=launches, launches_rank1=theirs,
                   local_heads=follower["local_heads"], digests=digests,
                   captured=captured, max_reductions_captured=counts["max"],
                   scales_equal_one_rank=digests[0] == ref["digest"])
        print(f"e2e {what}: ranks on {[str(eng.device), follower['device']]}"
              f", programs captured {captured} ({counts['max']} max "
              f"all-reduces of the int8 scales captured); launches rank 0 "
              f"{launches}, rank 1 {theirs}, one rank {ref['launches']}; "
              f"scale digests {digests} (the one-rank engine's "
              f"{ref['digest']}: equal {out['scales_equal_one_rank']}, "
              f"printed, not held) [{card}]")
        if tokens != ref["tokens"]:
            bad = [i for i, (a, b) in enumerate(zip(tokens, ref["tokens"]))
                   if a != b]
            raise AssertionError(f"{what}: tokens differ from the one-rank "
                                 f"engine's in requests {bad}")
        for rank, got in enumerate((launches, theirs)):
            if got != ref["launches"]:
                raise AssertionError(f"{what}: rank {rank}'s launches {got}"
                                     f" != the one-rank engine's "
                                     f"{ref['launches']}")
        if not (launches["paged_decode_attention_int8"]
                and launches["paged_prefill_attention_int8"]):
            raise AssertionError(f"{what}: the int8 kernels did not run "
                                 f"({launches})")
        if digests[0] is None or digests[0] != digests[1]:
            raise AssertionError(f"{what}: the ranks' scale pools differ "
                                 f"({digests})")
        if captured != (backend == "nccl") or (captured and not
                                                counts["max"]):
            raise AssertionError(f"{what}: captured {captured}, max "
                                 f"all-reduces captured {counts['max']}")
    finally:
        undo()
        api.close()
    del model, api, eng
    release()
    return out


def tp_local_kernels(pa, card):
    """Every paged kernel of phase 19's path at a rank's local heads (8 of
    gpt_1p3b's 16 at tp = 2, 4 at tp = 4) and head dim 128, at the shapes
    19a-19c give them, against its plain version on the same inputs under
    the dtype's TOL, in f32 and bf16, over full-precision and int8 pools:
    the decode kernel over 8 slots at positions up to 19a's last (tables
    of 128 blocks whose entries past a slot's last block are the scratch
    block, which reads 1e4); the suffix and chunk prefill, a chunk of CHUNK
    after a prefix of CHUNK and 37 queries after 475; the whole-prompt
    prefill of TP_WAVE[0] and 37 queries (full precision: its K/V are the
    step's own). Returns each kernel's worst error."""
    rng = np.random.default_rng(20)
    S, MB = TP_SLOTS, 128
    nb = S * MB + 1
    pos_list = [0, BS - 1, BS, 300, TP_WAVE[0] - 1, TP_WAVE[0], TP_POS,
                sum(TP_WAVE) - 1]
    perm = rng.permutation(np.arange(1, nb)).reshape(S, MB)
    for i, p in enumerate(pos_list):
        perm[i, p // BS + 1:] = 0
    bt = torch.as_tensor(perm, dtype=torch.int32, device="cuda")
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    row = torch.as_tensor(rng.permutation(np.arange(1, nb))[:MB],
                          dtype=torch.int32, device="cuda")
    worst = {}

    def held(name, dtype, tag, out, ref):
        err = check(name, dtype, tag, out, ref)
        worst[name] = max(worst.get(name, 0.0), err)

    for h in (8, 4):
        for dtype in (torch.float32, torch.bfloat16):
            for int8 in (False, True):
                sfx = "_int8" if int8 else ""
                entry = scratch_entry(rng, (nb, BS, h, D), dtype, int8)
                q = qkv_split(rng, S, h, D, dtype)[0]
                held("paged_decode_attention" + sfx, dtype,
                     f"local heads H={h} D={D} S={S} MB={MB}",
                     pa.paged_decode_attention(q, entry, bt, pos),
                     pa.paged_decode_attention_ref(q, entry, bt, pos))
                for sq, prefix in ((CHUNK, CHUNK), (37, 475)):
                    q = qkv_split(rng, sq, h, D, dtype)[0]
                    held("paged_prefill_attention" + sfx, dtype,
                         f"local heads H={h} D={D} sq={sq} prefix={prefix}",
                         pa.paged_prefill_attention(q, entry, row, prefix),
                         pa.paged_prefill_attention_ref(q, entry, row,
                                                        prefix))
                if int8:
                    continue
                for sq in (TP_WAVE[0], 37):
                    q, k, v = qkv_split(rng, sq, h, D, dtype)
                    held("paged_full_prefill_attention", dtype,
                         f"local heads H={h} D={D} sq={sq}",
                         pa.paged_full_prefill_attention(q, k, v, BS),
                         pa.paged_full_prefill_attention_ref(q, k, v, BS))
                del entry
        torch.cuda.empty_cache()
    print(f"kernels at local heads (8 and 4 of 16, f32 and bf16, full "
          f"precision and int8): every one within its dtype's tolerance; "
          f"worst max_abs_err {worst} [{card}]")
    return worst


def serve_tp_nccl_cards(model, serving, pa, tpm, ref, card):
    """19c: NCCL at tp = 2 and tp = 4 with graphs, one rank per card, on
    19a's model and wave where the machine has the cards: 19a's checks
    but the bit-equality, which a row-parallel sum in bf16 at tp > 1
    cannot keep: the logits of the wave's last prefill (a function of its
    prompt alone) within ROUTE_TOL["bf16"] of the engine without a mesh,
    the greedy token agreement printed, every rank's graphs and launches
    equal to its, no build under churn. Prints that it did not run
    otherwise."""
    vocab = model.cfg.vocab_size
    prompts = tp_prompts(vocab, [TP_WAVE[0]] * TP_SLOTS, 2)
    news = [TP_WAVE[1]] * TP_SLOTS
    out = {}
    for tp in (2, 4):
        if torch.cuda.device_count() < tp:
            print(f"19c tp={tp}: not run: this machine has "
                  f"{torch.cuda.device_count()} card(s), NCCL takes one rank "
                  f"per card [{card}]")
            out[tp] = "not run"
            continue
        mesh = tpm.serving_mesh(tp, backend="nccl", launch="process",
                                timeout=TP_TIMEOUT, install=False)
        t0 = time.perf_counter()
        api = serving.ServingAPI(copy.deepcopy(model), serving.ServingConfig(
            num_slots=TP_SLOTS, mesh=mesh), device="cuda")
        boot = time.perf_counter() - t0
        eng = api.engine
        sink = LogitSink(eng._model, vocab)
        try:
            serve(api, pa, prompts, news, f"19c tp={tp} (priming)", card)
            eng._tp.send("reset_launches")
            reqs, launches, ran = serve(api, pa, prompts, news,
                                        f"19c bf16 tp={tp} NCCL", card)
            tokens = [list(map(int, r.tokens)) for r in reqs]
            reports = eng._tp.stats()
            rel = rel_l2(sink.last[1].float(), ref["last_prefill"].float())
            agree = sum(a == b for x, y in zip(tokens, ref["tokens"])
                        for a, b in zip(x, y))
            res = dict(boot_s=boot, graphs=eng._graphs.graph_count(),
                       token_agreement=agree / (TP_SLOTS * TP_WAVE[1]),
                       rank_graphs=[r["graphs"] for r in reports],
                       launches=launches,
                       rank_launches=[{k: r["launches"][k] for k in launches}
                                      for r in reports],
                       last_prefill_rel_l2=rel,
                       devices=[str(eng.device)]
                       + [r["device"] for r in reports])
            print(f"e2e 19c bf16 tp={tp} NCCL: ranks on {res['devices']}, up "
                  f"in {boot:.2f} s; graphs {res['graphs']} "
                  f"(followers {res['rank_graphs']}, without a mesh "
                  f"{ref['graphs']}); launches rank 0 {launches}, the others "
                  f"{res['rank_launches']}; the last prefill's logits "
                  f"relative L2 {rel:.3e} (bound {ROUTE_TOL['bf16'][1]:g}); "
                  f"{agree} of {TP_SLOTS * TP_WAVE[1]} greedy tokens equal "
                  f"the engine's without a mesh [{card}]")
            if rel > ROUTE_TOL["bf16"][1]:
                raise AssertionError(f"19c tp={tp}: logits off by {rel:.3e}")
            if {res["graphs"], *res["rank_graphs"]} != {ref["graphs"]}:
                raise AssertionError(f"19c tp={tp}: graphs {res}")
            for got in [launches] + res["rank_launches"]:
                if got != ref["launches"]:
                    raise AssertionError(f"19c tp={tp}: launches {got} != "
                                         f"{ref['launches']}")
            before = builds(eng)
            cp = tp_prompts(vocab, TP_CHURN[0], 3)
            serve(api, pa, cp, [TP_CHURN[1]] * len(cp),
                  f"19c tp={tp} churn wave", card)
            if builds(eng) != before or [r["graphs"] for r in
                                         eng._tp.stats()] \
                    != res["rank_graphs"]:
                raise AssertionError(f"19c tp={tp}: churn built a program")
            out[tp] = res
        finally:
            api.close()
            sink.detach()
        release()
    return out


def serve_tp(gpt, serving, pa, arrays, card):
    """Phase 19: 19a, 19b (f32, then bf16), 19c. Returns the launches of
    19a's and 19b's measured waves per kernel and the numbers."""
    from paddle_tpu_torch.distributed import mesh as tpm

    t0 = time.perf_counter()
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    gpt.load_functional_state(model, arrays)
    model.to(torch.bfloat16)
    ref, out19a = serve_tp_nccl1(model, serving, pa, tpm, card)
    print(f"phase 19a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out19c = serve_tp_nccl_cards(model, serving, pa, tpm, ref, card)
    del model
    release()
    if torch.cuda.device_count() >= 2:
        out19c["int8"] = serve_tp_int8(gpt, serving, pa, arrays, tpm, "nccl",
                                       card)
    else:
        print(f"19c int8 tp=2: not run: this machine has "
              f"{torch.cuda.device_count()} card(s) [{card}]")
        out19c["int8"] = "not run"
    print(f"phase 19c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out19b = serve_tp_gloo_f32(gpt, serving, pa, arrays, tpm, card)
    int8 = serve_tp_int8(gpt, serving, pa, arrays, tpm, "gloo", card)
    out19b["int8"] = {k: v for k, v in int8.items()
                      if not k.startswith("launches")}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out19b["bf16"] = serve_tp_gloo_bf16(gpt, serving, pa, arrays, tpm,
                                        flush, card)
    del flush
    out19b["local_kernels"] = tp_local_kernels(pa, card)
    print(f"phase 19b: {time.perf_counter() - t0:.1f} s")
    out = {"19a": {k: v for k, v in out19a.items() if k != "launches"},
           "19b": {k: v for k, v in out19b.items()
                   if not k.startswith("launches")},
           "19c": out19c}
    print("phase 19, one call: " + json.dumps(out, default=str)
          + f" [{card}]")
    # the int8 rows' launches are the int8 wave's, the path that runs them
    runs = {"19a": out19a["launches"], "19b_rank0": out19b["launches_rank0"],
            "19b_rank1": out19b["launches_rank1"],
            "19b_int8_rank0": int8["launches"],
            "19b_int8_rank1": int8["launches_rank1"]}
    launches = {name: {run: got.get(name, 0) for run, got in runs.items()}
                for name in PAGED + SAMPLING}
    return launches, out


# ------------------------------------------------------------------ phase 20
# multi-GPU training: gpt_1p3b's width cut to TT_LAYERS layers, batch 1 x
# SEQ, AdamW (lr 3e-4, weight decay 0.01) under ClipGradByGlobalNorm(1.0),
# flash flag 0; ranks are threads of this process (gloo over CUDA tensors
# on the one card, NCCL one rank a card in 20e)
TT_LAYERS = 4
TT_STEPS = 3              # 20a's TrainSteps
TT_STEPS_BF16 = 3         # 20c's, each read beside its two-part control
# 20c's bounds (readings on an H100 at 700 W): steps 1-2 within
# ROUTE_TOL["bf16"] of the whole run (read <= 1.5e-5). The first step's
# loss (the forward) within about an f32 ulp of the two-part control,
# which rounds as the split does with no collective (read 0, the whole
# run 4.3e-7 away). The third step within 4x its largest reading
# (1.917e-4): AdamW's first steps move every weight by about lr whatever
# its gradient, so the split's bf16 rounding alone moves that loss (the
# control, no collective, 4.5e-5 from the whole run)
TT_BF16_HELD, TT_BF16_FORWARD_TOL, TT_BF16_LATE_TOL = 2, 1e-7, 8e-4
TT_STEPS_DATA = 2         # 20b's and 20e's: each moves the whole gradient
TT_TIMEOUT = 600.0        # a rank's collectives and its thread's join, s
TT_NCCL_TIMEOUT = 120.0   # 20e's: a stuck NCCL collective fails, not hangs
TT_DROPOUT, TT_DROP_SEED = 0.1, 21
TT_GEN = (2, 64, 32)      # 20d: prompts, prompt length, new tokens
TT_GEN_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=13)
TT_SLOT_SHARE = 0.55      # 20b: a ZeRO rank's slot bytes over one rank's
# f32 (TF32 off): losses rtol; a gradient shard's and the pair check's
# x.grad relative L2 against the whole model's; the clip's norm rtol
TT_LOSS_TOL, TT_GRAD_TOL, TT_PAIR_TOL, TT_NORM_TOL = 1e-5, 1e-4, 1e-5, 1e-5
TT_DEVICE = "cuda"        # the gloo ranks' and the references' device


def tt_arrays(gpt):
    """Seeded arrays of phase 20's parameters (``--phase 20`` alone)."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=TT_LAYERS)
    model = gpt.GPTForCausalLM(cfg, device=TT_DEVICE)
    arrays = gpt.seeded_state(model, seed=0)
    del model
    return arrays


def tt_model(gpt, arrays, device=None, **kw):
    """Phase 20's model: gpt_1p3b's width at TT_LAYERS layers, the seeded
    arrays of its parameters, in train mode."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=TT_LAYERS, **kw)
    model = gpt.GPTForCausalLM(cfg, device=device or TT_DEVICE)
    names = dict(model.named_parameters())
    gpt.load_functional_state(model, {n: a for n, a in arrays.items()
                                      if n in names})
    model.train()
    return model


def tt_batch(vocab, batch, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, (batch, SEQ + 1))
    ids = torch.as_tensor(ids, device=TT_DEVICE)
    return ids[:, :-1], ids[:, 1:]


def tt_step(port, model, bf16=False):
    """A TrainStep of ``model`` (AMP O1 bf16 with ``bf16``) and its
    optimizer."""
    opt = port.AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                     weight_decay=0.01,
                     grad_clip=port.ClipGradByGlobalNorm(1.0))

    def loss_fn(a, b):
        if not bf16:
            return model(a, b)
        with port.amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(a, b)

    return port.TrainStep(loss_fn, opt), opt


def slot_bytes(opt) -> int:
    return sum(t.numel() * t.element_size()
               for slots in opt._accumulators.values()
               for t in slots.values())


def pair_grad(mlp, seed, device):
    """The gradient of ``sum(mlp(x) * c)`` for x, c ``[1, SEQ, hidden]``
    made from ``seed``: a column / row pair's input gradient, the §3
    fault's reading."""
    rng = np.random.default_rng(seed)
    h = mlp.up.weight.shape[0]   # [in, out] whole or split by columns
    x, c = (torch.from_numpy(rng.standard_normal((1, SEQ, h),
                                                 dtype=np.float32))
            .to(device) for _ in range(2))
    x.requires_grad_(True)
    (mlp(x) * c).sum().backward()
    return x.grad


def rel_l2_t(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def shard_of(gpt, name, whole, mesh):
    """The slice of the whole model's ``name`` that a rank of ``mesh``
    holds (``models.gpt.shard_model``'s rule)."""
    su = gpt.sharding_util
    cfg = gpt.gpt_1p3b()
    heads, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    if name.endswith(("attn.qkv.weight", "attn.qkv.bias")):
        cols = torch.as_tensor(su.qkv_columns(heads, hd, mesh),
                               device=whole.device)
        return whole.index_select(whole.dim() - 1, cols)
    if name.endswith("attn.proj.weight"):
        lo, hi = su.head_rows(heads, hd, mesh)
        return whole[lo:hi]
    if name.endswith(("mlp.up.weight", "mlp.up.bias")):
        lo, hi = su.split_range(cfg.intermediate_size, mesh)
        return whole[..., lo:hi]
    if name.endswith("mlp.down.weight"):
        lo, hi = su.split_range(cfg.intermediate_size, mesh)
        return whole[lo:hi]
    if name == "gpt.wte.weight":
        lo, hi = su.split_range(cfg.vocab_size, mesh)
        return whole[lo:hi]
    return whole


def tt_two_parts(port, model):
    """20c's control: ``model`` (one rank, whole) computing each block's
    four linears in the parts a tp = 2 split computes them in, with no
    collective: ``proj``'s and ``down``'s products from the two halves of
    their input rows, each rounded to the output type and then summed
    (the row layer's partial products and their all-reduce); ``qkv``'s and
    ``up``'s outputs as the two ranks' columns, the input's gradient the
    sum of the two parts' (the column layer's *f*). The same function as
    the whole model's, in the split's rounding."""
    cfg = model.gpt.cfg
    h, inter = cfg.hidden_size, cfg.intermediate_size
    dev = model.gpt.wte.weight.device

    def rows(lin):
        k = lin.weight.shape[0] // 2

        def forward(x):
            x0, w0 = port.amp.cast_inputs("linear_nb", x[..., :k],
                                          lin.weight[:k])
            x1, w1 = port.amp.cast_inputs("linear_nb", x[..., k:],
                                          lin.weight[k:])
            y = torch.matmul(x0, w0) + torch.matmul(x1, w1)
            return y + lin.bias.to(y.dtype)

        lin.forward = forward

    def columns(lin, parts):
        order = torch.cat(parts)
        inverse = torch.argsort(order)

        def forward(x):
            outs = []
            for c in parts:
                xc, w, b = port.amp.cast_inputs(
                    "linear", x, lin.weight.index_select(1, c),
                    lin.bias.index_select(0, c))
                outs.append(torch.matmul(xc, w) + b)
            return torch.cat(outs, -1).index_select(-1, inverse)

        lin.forward = forward

    half = h // 2
    qkv = [torch.as_tensor(np.concatenate(
        [np.arange(j * h + r * half, j * h + (r + 1) * half)
         for j in range(3)]), device=dev) for r in range(2)]
    up = [torch.arange(r * inter // 2, (r + 1) * inter // 2, device=dev)
          for r in range(2)]
    for blk in model.gpt.layers:
        columns(blk.attn.qkv, qkv)
        rows(blk.attn.proj)
        columns(blk.mlp.up, up)
        rows(blk.mlp.down)
    return model


def tt_whole(port, gpt, arrays, x, y, steps, grads=False, **kw):
    """The one-rank run phase 20 holds the ranks to: with ``grads`` the
    first step's gradients, the clip's global norm and the pair check's
    x.grad (no update); then ``steps`` TrainSteps' losses and the
    optimizer's slot bytes. ``kw``: ``bf16``, ``two_parts`` (20c's
    control, :func:`tt_two_parts`) or the config's."""
    bf16 = kw.pop("bf16", False)
    two_parts = kw.pop("two_parts", False)
    model = tt_model(gpt, arrays, **kw)
    if two_parts:
        tt_two_parts(port, model)
    out = {}
    if grads:
        names, params = zip(*model.named_parameters())
        g = torch.autograd.grad(model(x, y), params)
        out["grads"] = dict(zip(names, g))
        out["norm"] = float(port.ClipGradByGlobalNorm(1.0).global_norm(
            list(g)))
        out["pair"] = pair_grad(model.gpt.layers[0].mlp, 31, x.device)
        del g
    if "dropout" in kw:
        port.rng.seed(TT_DROP_SEED)
    step, opt = tt_step(port, model, bf16)
    out["losses"] = [float(step(x, y)) for _ in range(steps)]
    out["slot_bytes"] = slot_bytes(opt)
    del step, opt, model
    release()
    return out


def tt_train(ctx, mesh, dev, x, y, steps, ref=None, bf16=False, zero=None,
             **kw):
    """On one rank of ``mesh``: the model split over its model axis (a
    ZeRO optimizer at level ``zero``), its rows of the global batch; with
    ``ref`` (a :func:`tt_whole` with grads) the first step's gradient
    shards (averaged over the data group) against the whole model's slices,
    the clip's norm and the pair check; then ``steps`` TrainSteps with
    this thread's flash and dropout launches counted."""
    port, gpt, par = ctx.port, ctx.gpt, ctx.parallel
    model = tt_model(gpt, ctx.arrays, device=dev, **kw)
    gpt.shard_model(model, mesh)
    xs, ys = par.shard_batch(x.to(dev)), par.shard_batch(y.to(dev))
    out = {}
    if ref is not None:
        names, params = zip(*model.named_parameters())
        g = par.sync_gradients(torch.autograd.grad(model(xs, ys), params))
        out["grad_rel"] = max(
            rel_l2_t(a, shard_of(gpt, n, ref["grads"][n], mesh).to(dev))
            for n, a in zip(names, g))
        out["norm"] = float(port.ClipGradByGlobalNorm(1.0).global_norm(
            list(g), par.norm_groups(params)))
        out["pair"] = rel_l2_t(pair_grad(model.gpt.layers[0].mlp, 31, dev),
                               ref["pair"].to(dev))
        del g
    if "dropout" in kw:
        port.rng.seed(TT_DROP_SEED)
    step, opt = tt_step(port, model, bf16)
    if zero is not None:
        ctx.sharding.group_sharded_parallel(model, opt, level=zero)
    port.fa.reset_launches()
    port.do.reset_launches()
    out["losses"] = [float(step(xs, ys)) for _ in range(steps)]
    out["launches"] = {**port.fa.thread_launches(),
                       "dropout": port.do.thread_launches()["dropout"]}
    out["slot_bytes"] = slot_bytes(opt)
    del step, opt, model
    return out


def tt_hold(what, res, ref, card, tol=TT_LOSS_TOL, launches=None,
            steps=TT_STEPS, grads=False):
    """Hold every rank's readings against the one-rank run's."""
    for r, got in enumerate(res):
        held = got["losses"][:steps]
        rel = (np.abs(np.array(held) - ref["losses"][:steps])
               / np.abs(ref["losses"][:steps]))
        line = (f"20{what} rank {r}: losses {held} against one "
                f"rank's {ref['losses'][:steps]} (rel {rel.max():.3e}, rtol "
                f"{tol:g})")
        if not (np.isfinite(got["losses"]).all() and (rel <= tol).all()):
            raise AssertionError(line)
        if grads:
            nrel = abs(got["norm"] - ref["norm"]) / ref["norm"]
            line += (f"; first-step gradient shards within relative L2 "
                     f"{got['grad_rel']:.3e} of the whole model's slices "
                     f"(bound {TT_GRAD_TOL:g}); clip norm {got['norm']!r} "
                     f"vs {ref['norm']!r} (rel {nrel:.3e}); the pair's "
                     f"x.grad relative L2 {got['pair']:.3e} (bound "
                     f"{TT_PAIR_TOL:g})")
            if not (got["grad_rel"] <= TT_GRAD_TOL and nrel <= TT_NORM_TOL
                    and got["pair"] <= TT_PAIR_TOL):
                raise AssertionError(line)
        if launches is not None:
            want = {k: launches[k] for k in launches}
            got_l = {k: got["launches"][k] for k in launches}
            line += f"; launches {got_l}"
            if got_l != want:
                raise AssertionError(f"{line} != {want}")
        print(line + f" [{card}]")


def bf16_drift(ref, ctrl, ranks, card):
    """20c's reading, step by step: each rank's relative loss difference
    from the whole one-rank run and from its two-part control, and the
    control's from the whole run; the first step held to the control and
    the steps after TT_BF16_HELD to TT_BF16_LATE_TOL (``tt_hold`` holds
    the others)."""
    def rel(a, b):
        a, b = np.array(a), np.array(b)
        return (np.abs(a - b) / np.abs(b)).tolist()

    out = {"control_vs_whole": rel(ctrl["losses"], ref["losses"]),
           "ranks_vs_whole": [rel(r["losses"], ref["losses"])
                              for r in ranks],
           "ranks_vs_control": [rel(r["losses"], ctrl["losses"])
                                for r in ranks]}
    line = (f"20c bf16 drift by step: {json.dumps(out)} (bounds: the "
            f"first step {TT_BF16_FORWARD_TOL:g} of the control, steps "
            f"after {TT_BF16_HELD} {TT_BF16_LATE_TOL:g} of the whole run)")
    for whole, control in zip(out["ranks_vs_whole"],
                              out["ranks_vs_control"]):
        if not (control[0] <= TT_BF16_FORWARD_TOL and all(
                w <= TT_BF16_LATE_TOL for w in whole[TT_BF16_HELD:])):
            raise AssertionError(line)
    print(f"{line} [{card}]")
    return out


def tt_generate(model, prompts, sampling):
    return (model.generate(prompts, max_new_tokens=TT_GEN[2]).cpu(),
            model.generate(prompts, max_new_tokens=TT_GEN[2],
                           sampling=sampling).cpu())


def train_tp(gpt, arrays, port, card):
    """Phase 20 (f32 TF32 off but 20c; see the module docstring): 20a tp =
    2 with a dropout step, 20c bf16 O1 tp = 2 and its kernels at 8 local
    heads, 20d generate() at tp = 2, all in one run of two rank threads
    over gloo on this card; 20b data 2 and ZeRO os_g at sharding 2; 20e
    NCCL data 2 x model 2 on four cards where the machine has them.
    Returns the launches of 20a (rows 3-5) and of its dropout step (row
    7) per rank, and the numbers."""
    from paddle_tpu_torch.distributed import parallel, sharding
    from paddle_tpu_torch.serving import SamplingParams

    port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    ctx = types.SimpleNamespace(port=port, gpt=gpt, arrays=arrays,
                                parallel=parallel, sharding=sharding)
    vocab = gpt.gpt_1p3b().vocab_size
    x, y = tt_batch(vocab, 1, 40)
    x2, y2 = tt_batch(vocab, 2, 41)
    prompts = np.random.default_rng(42).integers(0, vocab, TT_GEN[:2])
    sampling = SamplingParams(**TT_GEN_SAMPLED)
    t0 = time.perf_counter()
    ref_a = tt_whole(port, gpt, arrays, x, y, TT_STEPS, grads=True)
    ref_drop = tt_whole(port, gpt, arrays, x, y, 1, dropout=TT_DROPOUT)
    ref_c = tt_whole(port, gpt, arrays, x, y, TT_STEPS_BF16, bf16=True)
    ctrl_c = tt_whole(port, gpt, arrays, x, y, TT_STEPS_BF16, bf16=True,
                      two_parts=True)
    model = tt_model(gpt, arrays)
    want_tokens = tt_generate(model, prompts, sampling)
    del model
    release()
    print(f"phase 20 one-rank references: {time.perf_counter() - t0:.1f} s")

    def tp2(mesh):
        dev = TT_DEVICE
        out = {"a": tt_train(ctx, mesh, dev, x, y, TT_STEPS, ref=ref_a)}
        release()
        out["drop"] = tt_train(ctx, mesh, dev, x, y, 1, dropout=TT_DROPOUT)
        release()
        out["c"] = tt_train(ctx, mesh, dev, x, y, TT_STEPS_BF16, bf16=True)
        release()
        model = tt_model(gpt, arrays)
        gpt.shard_model(model, mesh)
        out["d"] = tt_generate(model, prompts, sampling)
        return out

    t0 = time.perf_counter()
    res = tt_ranks(parallel, tp2, "gloo", mp=2)
    per_step = {k: TT_LAYERS * TT_STEPS for k in FLASH}
    tt_hold("a (tp = 2, f32)", [r["a"] for r in res], ref_a, card,
            launches=per_step, grads=True)
    # a step draws at the embedding, and at each layer's probabilities and
    # two residual branches, forward and backward
    drops = {"dropout": 2 * (1 + 3 * TT_LAYERS), **{k: 0 for k in FLASH}}
    tt_hold("a (tp = 2, f32, dropout 0.1: the plain attention route)",
            [r["drop"] for r in res], ref_drop, card, launches=drops,
            steps=1)
    drift = bf16_drift(ref_c, ctrl_c, [r["c"] for r in res], card)
    tt_hold("c (tp = 2, bf16 O1)", [r["c"] for r in res], ref_c, card,
            tol=ROUTE_TOL["bf16"][0], steps=TT_BF16_HELD,
            launches={k: TT_LAYERS * TT_STEPS_BF16 for k in FLASH})
    for r, got in enumerate(res):
        for kind, a, b in zip(("greedy", "sampled"), got["d"], want_tokens):
            if not torch.equal(a, b):
                raise AssertionError(f"20d rank {r}: {kind} tokens differ "
                                     f"from the whole model's")
    print(f"20d generate() at tp = 2: greedy and sampled "
          f"({TT_GEN_SAMPLED}) tokens of {TT_GEN[0]} prompts of "
          f"{TT_GEN[1]} + {TT_GEN[2]} equal the whole model's on both ranks "
          f"[{card}]")
    print(f"phase 20a/20c/20d ranks: {time.perf_counter() - t0:.1f} s")
    times = flash_times(port.fa, card, b=1, h=H // 2)

    t0 = time.perf_counter()
    ref_b = tt_whole(port, gpt, arrays, x2, y2, TT_STEPS_DATA, grads=True)
    res_dp = tt_ranks(parallel, lambda mesh: tt_train(
        ctx, mesh, TT_DEVICE, x2, y2, TT_STEPS_DATA), "gloo", dp=2)
    tt_hold("b (data 2, f32)", res_dp, ref_b, card, steps=TT_STEPS_DATA)
    res_zero = tt_ranks(parallel, lambda mesh: tt_train(
        ctx, mesh, TT_DEVICE, x, y, TT_STEPS_DATA, zero="os_g"), "gloo",
        sharding_=2)
    tt_hold("b (ZeRO os_g, sharding 2, f32)", res_zero, ref_a, card,
            steps=TT_STEPS_DATA)
    shares = [r["slot_bytes"] / ref_a["slot_bytes"] for r in res_zero]
    print(f"20b ZeRO os_g: each rank's optimizer slots {shares} of one "
          f"rank's {ref_a['slot_bytes']} bytes (bound {TT_SLOT_SHARE}) "
          f"[{card}]")
    if max(shares) > TT_SLOT_SHARE:
        raise AssertionError(f"20b: slot shares {shares}")
    print(f"phase 20b: {time.perf_counter() - t0:.1f} s")

    out = {"tp_launches": [r["a"]["launches"] for r in res],
           "dropout_launches": [r["drop"]["launches"]["dropout"]
                                for r in res],
           "flash_times_8_heads": times, "slot_shares": shares,
           "bf16_drift": drift}
    if torch.cuda.device_count() >= 4:
        t0 = time.perf_counter()

        # each rank reads only host data and its own card: a copy from
        # another rank's card waits on that card's stream, which an NCCL
        # kernel waiting for this rank may hold
        host_ref = {"grads": {n: g.cpu() for n, g in ref_b["grads"].items()},
                    "pair": ref_b["pair"].cpu()}
        xh, yh = x2.cpu(), y2.cpu()

        def nccl(mesh):
            return tt_train(ctx, mesh, f"cuda:{mesh.rank}", xh, yh,
                            TT_STEPS_DATA, ref=host_ref)

        res_nccl = tt_ranks(parallel, nccl, "nccl", dp=2, mp=2,
                            timeout=TT_NCCL_TIMEOUT)
        tt_hold("e (NCCL, data 2 x model 2, four cards)", res_nccl, ref_b,
                card, launches={k: TT_LAYERS * TT_STEPS_DATA for k in FLASH},
                steps=TT_STEPS_DATA, grads=True)
        out["nccl_launches"] = [r["launches"] for r in res_nccl]
        print(f"phase 20e: {time.perf_counter() - t0:.1f} s")
    else:
        print(f"20e (NCCL data 2 x model 2): not run: this machine has "
              f"{torch.cuda.device_count()} card(s) [{card}]")
    del ref_a, ref_b
    release()
    launches = {name: {f"rank{r}": got[name]
                       for r, got in enumerate(out["tp_launches"])}
                for name in FLASH}
    launches["dropout"] = {f"rank{r}": n
                           for r, n in enumerate(out["dropout_launches"])}
    return launches, out


def tt_ranks(parallel, fn, backend, dp=1, mp=1, sharding_=1, pp=1, sep=1,
             timeout=TT_TIMEOUT):
    """``fn(mesh)`` on every rank of a ``dp x pp x sharding x sep x mp``
    mesh of threads of this process (``timeout``: each collective's and
    the join's)."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    world = dp * mp * sharding_ * pp * sep

    def body(rank, store):
        if backend == "nccl":
            torch.cuda.set_device(rank)   # one rank a card
        mesh = mesh_mod.init_hybrid_mesh(
            dp=dp, mp=mp, sharding=sharding_, pp=pp, sep=sep, rank=rank,
            world_size=world, backend=backend, store=store, timeout=timeout)
        return fn(mesh)

    return parallel.run_thread_ranks(body, world, timeout=timeout)


# ------------------------------------------------------------------ phase 21
# pipeline and context parallelism: gpt_1p3b's width at PP_LAYERS layers
# (phase 20's arrays), sequence SEQ, f32 with TF32 off but 21c; ranks are
# threads of this process (gloo over CUDA tensors on the one card, NCCL one
# rank a card in 21e)
PP_LAYERS = TT_LAYERS
PP_BATCH, PP_MICRO, PP_STEPS = 4, 4, 3   # 21a / 21b: 4 x SEQ, 4 microbatches
PP_STEPS_BF16 = 2                       # 21c: held to ROUTE_TOL["bf16"]
PP_STEPS_SEP = 2                        # 21d's GPT at sep 2 x model 2
PP_NCCL_BATCH = 2                       # 21e: 2 x SEQ on four cards
# f32: losses rtol against one rank; first-step gradients and parameters
# after step 1, relative L2 tensor by tensor
PP_LOSS_TOL, PP_PARAM_TOL = 1e-6, 1e-5
# the parameters after step 1 are held over the entries whose one-rank
# first-step gradient is not zero to rounding. AdamW's first step moves an
# entry by lr g / (|g| + eps), about lr on g's sign, so an entry whose g is
# rounding noise moves on that noise. Left out, counted and printed: the
# key third of each block's qkv bias (its gradient is 0 in exact
# arithmetic: a key bias adds one amount to every logit of a query's row,
# which softmax ignores), and entries with |g| <= PP_ZERO_ABS = 100 x
# AdamW's eps (where eps and g's rounding set the move). The readings
# with only the first rule are printed beside them
PP_ZERO_ABS = 100 * 1e-8
# 21d: ring and Ulysses outputs and gradients against one rank's
# _sdpa_reference, relative L2 (bf16: both round probabilities and
# products in bf16, in other orders)
PP_CP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def pp_model(gpt, parrays, device, micro, virtual=None, **kw):
    """Phase 21's pipe model on this thread's mesh: gpt_1p3b's width at
    PP_LAYERS layers, ``micro`` microbatches, ``virtual`` chunks a rank,
    the seeded arrays, in train mode."""
    cfg = dataclasses.replace(gpt.gpt_1p3b(), num_layers=PP_LAYERS, **kw)
    model = gpt.GPTForCausalLMPipe(cfg, num_microbatches=micro,
                                   num_virtual_pipeline_stages=virtual,
                                   device=device)
    gpt.load_pipe_state(model, parrays)
    model.train()
    return model


def pp_opt(port, model):
    return port.AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                      weight_decay=0.01,
                      grad_clip=port.ClipGradByGlobalNorm(1.0))


def pp_names(gpt, tensors):
    """``{name: tensor}`` of a GPTForCausalLM (f32) as host copies under
    the pipe model's names (``models.gpt.pipe_arrays``)."""
    arrays = {n: t.detach().to("cpu", copy=True).numpy()
              for n, t in tensors.items()}
    return {n: torch.from_numpy(a)
            for n, a in gpt.pipe_arrays(arrays, PP_LAYERS).items()}


def pp_kept(name, grad, floor=PP_ZERO_ABS):
    """The entries of parameter ``name`` (the whole model's) whose reading
    after step 1 is held: outside the key third of a qkv bias, and with a
    one-rank first-step gradient ``grad`` above ``floor`` (see
    PP_ZERO_ABS)."""
    keep = grad.abs() > floor
    if name.endswith("attn__qkv__bias"):
        h = grad.shape[-1] // 3
        keep[..., h:2 * h] = False
    return keep


def pp_whole(ctx, x, y, steps, bf16=False, **kw):
    """The one-rank run phase 21 holds the pipe ranks to: phase 20's whole
    GPTForCausalLM, ``steps`` TrainSteps' losses and, in f32, the first
    step's loss gradients and its parameters after step 1, under the pipe
    model's names."""
    port, gpt = ctx.port, ctx.gpt
    model = tt_model(gpt, ctx.arrays, **kw)
    out = {}
    if not bf16:
        names, params = zip(*model.named_parameters())
        out["grads"] = pp_names(gpt, dict(zip(names, torch.autograd.grad(
            model(x, y), params))))
    step, opt = tt_step(port, model, bf16)
    out["losses"] = [float(step(x, y))]
    if not bf16:
        out["params"] = pp_names(gpt, dict(model.named_parameters()))
    out["losses"] += [float(step(x, y)) for _ in range(steps - 1)]
    del step, opt, model
    release()
    return out


def pp_train(ctx, mesh, dev, x, y, steps, micro, virtual=None, ref=None,
             bf16=False, **kw):
    """On one rank of ``mesh``: the pipe model (its stage's blocks, the
    replicated sections), ``steps`` PipelineParallel.train_batch steps of
    the global batch with this thread's flash and dropout launches
    counted; with ``ref`` first the relative L2 of each first-step loss
    gradient (no update) from the one-rank run's part of it, then, after
    step 1, each parameter's."""
    from paddle_tpu_torch.distributed import pipeline
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel)

    port, gpt = ctx.port, ctx.gpt
    model = pp_model(gpt, ctx.parrays, dev, micro, virtual, **kw)
    w = PipelineParallel(model)
    opt = pp_opt(port, model)
    xs, ys = x.to(dev), y.to(dev)
    out = {"losses": []}

    def rels(tensors, whole, grads=None, floor=PP_ZERO_ABS):
        """Each tensor's relative L2 from the one-rank run's part of it
        (with ``grads``, over the entries ``pp_kept`` keeps): the largest,
        the three largest by name, and the entries left out by name."""
        got, left = {}, {}
        for (n, p), t in zip(model.named_parameters(), tensors):
            a, b = t.detach().float(), gpt._local_part(p, whole[n].to(dev))
            if grads is not None:
                keep = gpt._local_part(p, pp_kept(n, grads[n].to(dev),
                                                  floor))
                if not bool(keep.all()):
                    left[n] = f"{int((~keep).sum())} of {keep.numel()}"
                a, b = a[keep], b[keep]
            got[n] = rel_l2_t(a, b)
        top = sorted(got, key=got.get, reverse=True)[:3]
        return max(got.values()), {n: got[n] for n in top}, left

    if ref is not None:
        with torch.autograd.set_multithreading_enabled(False):
            grads = torch.autograd.grad(
                model.loss_fn(model(ctx.parallel.shard_batch(xs)),
                              ctx.parallel.shard_batch(ys)),
                [p for _, p in model.named_parameters()])
        out["grad_rel"], out["grad_top"], _ = rels(
            ctx.parallel.sync_gradients(grads), ref["grads"])
        del grads
    if "dropout" in kw:
        port.rng.seed(TT_DROP_SEED)
    port.fa.reset_launches()
    port.do.reset_launches()
    def cast():
        return (port.amp.auto_cast(level="O1", dtype="bfloat16") if bf16
                else contextlib.nullcontext())

    for i in range(steps):
        with cast():
            out["losses"].append(float(w.train_batch((xs, ys), opt)))
        if i == 0 and ref is not None:
            params = [p for _, p in model.named_parameters()]
            out["param_rel"], out["param_top"], out["param_left"] = rels(
                params, ref["params"], ref["grads"])
            _, out["param_top_no_floor"], _ = rels(
                params, ref["params"], ref["grads"], floor=0.0)
    out["launches"] = {**port.fa.thread_launches(),
                       "dropout": port.do.thread_launches()["dropout"]}
    out["schedule"] = pipeline.last_schedule()
    out["rows"] = f"blocks {list(model.blocks.rows)}"
    del w, opt, model
    return out


def pp_hold(what, res, ref, card, tol=PP_LOSS_TOL, steps=None,
            launches=None, cost=None, params=False):
    """Hold every rank's readings of a phase-21 run against one rank's."""
    for r, got in enumerate(res):
        n = steps or len(got["losses"])
        held = np.array(got["losses"][:n])
        want = np.array(ref["losses"][:n])
        rel = np.abs(held - want) / np.abs(want)
        line = (f"21{what} rank {r} (holds {got['rows']}): losses "
                f"{held.tolist()} against one rank's {want.tolist()} (rel "
                f"{rel.max():.3e}, rtol {tol:g})")
        ok = bool(np.isfinite(held).all() and (rel <= tol).all())
        if params:
            line += (f"; first-step gradients within relative L2 "
                     f"{got['grad_rel']:.3e} of one rank's, each tensor "
                     f"(bound {PP_PARAM_TOL:g}; largest {got['grad_top']}); "
                     f"parameters after step 1 within "
                     f"{got['param_rel']:.3e} of one rank's parts, each "
                     f"tensor (bound {PP_PARAM_TOL:g}; the tied wte "
                     f"included; largest {got['param_top']}; left out, "
                     f"their one-rank gradient zero to rounding: "
                     f"{got['param_left'] or 'none'}; with only the key "
                     f"thirds left out, not held: "
                     f"{got['param_top_no_floor']})")
            ok = ok and max(got["grad_rel"], got["param_rel"]) <= \
                PP_PARAM_TOL
        if cost is not None:
            line += (f"; schedule {got['schedule']} (cost "
                     f"{got['schedule']['cost']} against pipeline_tick_cost "
                     f"{cost})")
            ok = ok and got["schedule"]["cost"] == cost
        if launches is not None:
            got_l = {k: got["launches"][k] for k in launches}
            line += f"; launches {got_l} (want {launches})"
            ok = ok and got_l == launches
        if not ok:
            raise AssertionError(line)
        print(line + f" [{card}]")


def cp_checks(port, parallel, card):
    """21d's kernels-free route: ring_attention and ulysses_attention at
    sep 2 (gloo thread ranks on this card) on [1, SEQ, H, D] in f32 and
    bf16, causal, forward and the gradients of ``sum(out * c)``, each
    rank's rows against one rank's ``_sdpa_reference`` on the whole
    sequence (PP_CP_TOL); no flash launch on either route."""
    from paddle_tpu_torch.distributed import context_parallel as cp

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=TT_DEVICE).manual_seed(17)
        q, k, v, c = [(0.5 * torch.randn((1, SEQ, H, D), generator=gen,
                                         device=TT_DEVICE)).to(dt)
                      for _ in range(4)]
        scale = 1.0 / np.sqrt(D)
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = port.attention._sdpa_reference(*ts, scale=scale, causal=True)
        (ref.float() * c.float()).sum().backward()
        want = [ref.detach()] + [t.grad for t in ts]
        n = SEQ // 2

        def rank(mesh, fn):
            j = mesh.axis_rank("sep")
            rows = slice(j * n, (j + 1) * n)
            mine = [t[:, rows].detach().clone().requires_grad_()
                    for t in (q, k, v)]
            port.fa.reset_launches()
            with torch.autograd.set_multithreading_enabled(False):
                got = fn(*mine, scale=scale, causal=True)
                (got.float() * c[:, rows].float()).sum().backward()
            flash = sum(port.fa.thread_launches().values())
            return flash, [rel_l2_t(a, b[:, rows]) for a, b in zip(
                [got.detach()] + [t.grad for t in mine], want)]

        for name, fn in (("ring", cp.ring_attention),
                         ("ulysses", cp.ulysses_attention)):
            res = tt_ranks(parallel, lambda mesh: rank(mesh, fn), "gloo",
                           sep=2)
            worst = max(max(r) for _, r in res)
            flash = [f for f, _ in res]
            tol = PP_CP_TOL[dt]
            line = (f"21d {name} attention {str(dt)[6:]} [1, {SEQ}, {H}, "
                    f"{D}] causal at sep 2: out, dq, dk, dv within relative "
                    f"L2 {worst:.3e} of one rank's _sdpa_reference (bound "
                    f"{tol:g}); flash launches per rank {flash}")
            if worst > tol or any(flash):
                raise AssertionError(line)
            print(line + f" [{card}]")
            out[f"{name}_{str(dt)[6:]}"] = worst
        del q, k, v, c, ts, ref, want
        release()
    return out


def sep_train(ctx, mesh, dev, x, y, steps):
    """21d's GPT on a rank of a sep x model mesh: phase 20's model split
    over the model axis, this rank's block of the batch's positions
    (``shard_batch``), ``steps`` TrainSteps on the ring route; the flash
    launches counted (the flag at 0: the sep route comes first)."""
    port, gpt, par = ctx.port, ctx.gpt, ctx.parallel
    model = tt_model(gpt, ctx.arrays, device=dev)
    gpt.shard_model(model, mesh)
    xs, ys = par.shard_batch(x.to(dev)), par.shard_batch(y.to(dev))
    step, opt = tt_step(port, model)
    port.fa.reset_launches()
    out = {"losses": [float(step(xs, ys)) for _ in range(steps)],
           "launches": dict(port.fa.thread_launches()),
           "rows": f"tokens {tuple(xs.shape)}"}
    del step, opt, model
    return out


def train_pipe(gpt, arrays, port, card):
    """Phase 21 (see the module docstring): 21a GPipe and 21b the
    interleaved schedule at pp = 2 in f32 with a dropout step each, 21c
    bf16 O1 at pp = 2 and the flash kernels at a stage's shape, 21d ring
    and Ulysses at sep = 2 and a GPT trained at sep 2 x model 2, all as
    gloo thread ranks on this card; 21e NCCL pp 2 x data 2 and sep 2 x
    model 2 on four cards where the machine has them. Returns 21a's
    launches per rank (rows 3-5 and its dropout step's row 7) and the
    numbers."""
    from paddle_tpu_torch.distributed import parallel
    from paddle_tpu_torch.distributed import pipeline

    ctx = types.SimpleNamespace(port=port, gpt=gpt, arrays=arrays,
                                parallel=parallel,
                                parrays=gpt.pipe_arrays(arrays, PP_LAYERS))
    vocab = gpt.gpt_1p3b().vocab_size
    x, y = tt_batch(vocab, PP_BATCH, 50)
    out = {}
    t0 = time.perf_counter()
    port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    ref = pp_whole(ctx, x, y, PP_STEPS)
    # the dropout step's one rank: the pipe model without a pipe axis runs
    # its blocks on the whole batch, as the schedule does at one microbatch
    port.rng.seed(TT_DROP_SEED)
    port.do.reset_launches()
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel)
    one = pp_model(gpt, ctx.parrays, TT_DEVICE, 1, dropout=TT_DROPOUT)
    # backward on this thread, so that its dropout launches count here
    with torch.autograd.set_multithreading_enabled(False):
        ref_drop = {"losses": [float(PipelineParallel(one).train_batch(
            (x, y), pp_opt(port, one)))]}
    one_drops = port.do.thread_launches()["dropout"]
    del one
    release()
    print(f"phase 21 one-rank references: {time.perf_counter() - t0:.1f} s")

    for tag, virtual in (("a", None), ("b", 2)):
        t0 = time.perf_counter()

        def ranks(mesh):
            got = {"f32": pp_train(ctx, mesh, TT_DEVICE, x, y, PP_STEPS,
                                   PP_MICRO, virtual, ref=ref)}
            release()
            got["drop"] = pp_train(ctx, mesh, TT_DEVICE, x, y, 1, 1, virtual,
                                   dropout=TT_DROPOUT)
            release()
            return got

        res = tt_ranks(parallel, ranks, "gloo", pp=2)
        name = ("a (GPipe, pp = 2, f32)" if virtual is None else
                "b (interleaved, pp = 2 x V = 2, f32)")
        per = {k: (PP_LAYERS // 2) * PP_MICRO * PP_STEPS for k in FLASH}
        pp_hold(name, [r["f32"] for r in res], ref, card, launches=per,
                cost=pipeline.pipeline_tick_cost(PP_MICRO, 2, virtual or 1),
                params=True)
        pp_hold(f"{tag} (dropout {TT_DROPOUT}, one microbatch; the one-rank "
                f"pipe model drew {one_drops} dropout launches)",
                [r["drop"] for r in res], ref_drop, card, tol=0.0)
        out[tag] = {"launches": [r["f32"]["launches"] for r in res],
                    "dropout_launches": [r["drop"]["launches"]["dropout"]
                                         for r in res],
                    "schedule": res[0]["f32"]["schedule"],
                    "param_rel": [r["f32"]["param_rel"] for r in res],
                    "param_top": [r["f32"]["param_top"] for r in res],
                    "param_left": [r["f32"]["param_left"] for r in res],
                    "param_top_no_floor": [r["f32"]["param_top_no_floor"]
                                           for r in res],
                    "grad_rel": [r["f32"]["grad_rel"] for r in res]}
        print(f"phase 21{tag}: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ref_c = pp_whole(ctx, x, y, PP_STEPS_BF16, bf16=True)
    res_c = tt_ranks(parallel, lambda mesh: pp_train(
        ctx, mesh, TT_DEVICE, x, y, PP_STEPS_BF16, PP_MICRO, bf16=True),
        "gloo", pp=2)
    pp_hold("c (GPipe, pp = 2, bf16 O1)", res_c, ref_c, card,
            tol=ROUTE_TOL["bf16"][0],
            launches={k: (PP_LAYERS // 2) * PP_MICRO * PP_STEPS_BF16
                      for k in FLASH})
    out["c"] = {"losses": [r["losses"] for r in res_c],
                "one_rank": ref_c["losses"]}
    release()
    out["flash_times_stage"] = flash_times(port.fa, card,
                                           b=PP_BATCH // PP_MICRO, h=H)
    print(f"phase 21c: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    out["d"] = cp_checks(port, parallel, card)
    x1, y1 = tt_batch(vocab, 1, 40)
    port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": -1})
    ref_d = tt_whole(port, gpt, arrays, x1, y1, PP_STEPS_SEP)
    port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
    res_d = tt_ranks(parallel, lambda mesh: sep_train(
        ctx, mesh, TT_DEVICE, x1, y1, PP_STEPS_SEP), "gloo", sep=2, mp=2)
    pp_hold("d (GPT, sep 2 x model 2, f32, the ring; one rank on the plain "
            "route)", res_d, ref_d, card, launches={k: 0 for k in FLASH})
    out["d"]["gpt_losses"] = [r["losses"] for r in res_d]
    print(f"phase 21d: {time.perf_counter() - t0:.1f} s")

    if torch.cuda.device_count() >= 4:
        t0 = time.perf_counter()
        x2, y2 = tt_batch(vocab, PP_NCCL_BATCH, 41)
        ref_pp = pp_whole(ctx, x2, y2, TT_STEPS_DATA)
        port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": -1})
        ref_sep = tt_whole(port, gpt, arrays, x2, y2, TT_STEPS_DATA)
        port.flags.set_flags({"FLAGS_flash_attention_min_seqlen": 0})
        # each rank reads only host data and its own card
        xh, yh = x2.cpu(), y2.cpu()
        res_pp = tt_ranks(parallel, lambda mesh: pp_train(
            ctx, mesh, f"cuda:{mesh.rank}", xh, yh, TT_STEPS_DATA, 1),
            "nccl", pp=2, dp=2, timeout=TT_NCCL_TIMEOUT)
        pp_hold("e (NCCL, pp 2 x data 2, four cards)", res_pp, ref_pp, card,
                launches={k: (PP_LAYERS // 2) * TT_STEPS_DATA for k in FLASH})
        res_sep = tt_ranks(parallel, lambda mesh: sep_train(
            ctx, mesh, f"cuda:{mesh.rank}", xh, yh, TT_STEPS_DATA), "nccl",
            sep=2, mp=2, timeout=TT_NCCL_TIMEOUT)
        pp_hold("e (NCCL, sep 2 x model 2, four cards)", res_sep, ref_sep,
                card, launches={k: 0 for k in FLASH})
        out["e"] = {"pp_launches": [r["launches"] for r in res_pp],
                    "pp_losses": [r["losses"] for r in res_pp],
                    "sep_losses": [r["losses"] for r in res_sep]}
        print(f"phase 21e: {time.perf_counter() - t0:.1f} s")
    else:
        print(f"21e (NCCL pp 2 x data 2, sep 2 x model 2): not run: this "
              f"machine has {torch.cuda.device_count()} card(s) [{card}]")
    del ref
    release()
    launches = {name: {f"rank{r}": got[name]
                       for r, got in enumerate(out["a"]["launches"])}
                for name in FLASH}
    launches["dropout"] = {f"rank{r}": n for r, n in
                           enumerate(out["a"]["dropout_launches"])}
    return launches, out


def timed(label, fn, *args):
    """``fn(*args)``, printing the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    # ``--phase 19`` / ``--phase 20``: the build and that phase alone (a
    # four-card check of 19c or 20e), ending on a line of its own; the
    # smoke run proper takes no arguments
    if sys.argv[1:] not in ([], ["--phase", "19"], ["--phase", "20"],
                            ["--phase", "21"]):
        print(f"chip_smoke: arguments {sys.argv[1:]}: the only ones taken "
              f"are '--phase 19', '--phase 20' and '--phase 21'",
              file=sys.stderr)
        return 2
    only = sys.argv[2] if sys.argv[1:] else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    # the training phases hold a 1.3B-parameter model, its AdamW state and
    # a batch of 16k tokens' activations: let the allocator grow segments
    # instead of fragmenting (read at the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch import amp, serving
    from paddle_tpu_torch.core import flags, rng
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.nn import functional
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import dropout as do
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import sampling as so
    from paddle_tpu_torch import callbacks, optimizer
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.core import resilience
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import layers as nn_layers
    from paddle_tpu_torch.optimizer import AdamW
    port = types.SimpleNamespace(gpt=gpt, fa=fa, do=do, rng=rng, flags=flags,
                                 amp=amp, TrainStep=TrainStep, AdamW=AdamW,
                                 ClipGradByGlobalNorm=ClipGradByGlobalNorm,
                                 attention=attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    # the whole run's seeded weights are drawn on host threads while nvcc
    # builds the kernels
    drawing = ThreadPoolExecutor(2)
    if only is None:
        draw_ahead(gpt, drawing)
    drawing.shutdown(wait=False)
    with ThreadPoolExecutor(len(SOURCES)) as ex:  # one nvcc per source
        list(ex.map(_build.build, SOURCES))
    pa.load_kernels()
    fa.load_kernels()
    so.load_kernels()
    do.load_kernels()
    print(f"build: {', '.join(SOURCES.values())} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.1f} s"
                      for n in SOURCES) + ")")
    print(f"phase 1 (build): {time.perf_counter() - t0:.1f} s")
    t = timed
    if only == "19":
        model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
        arrays = gpt.seeded_state(model, seed=0)
        del model
        t("19", serve_tp, gpt, serving, pa, arrays, card)
        print(card)
        print(json.dumps({"phase_only": "19", "passed": True,
                          "cards": torch.cuda.device_count()}))
        return 0
    if only == "20":
        arrays = tt_arrays(gpt)
        launches, out = t("20", train_tp, gpt, arrays, port, card)
        print("phase 20, one call: " + json.dumps(
            {"launches_tp_train": launches, **out}, default=str)
            + f" [{card}]")
        print(card)
        print(json.dumps({"phase_only": "20", "passed": True,
                          "cards": torch.cuda.device_count()}))
        return 0
    if only == "21":
        arrays = tt_arrays(gpt)
        launches, out = t("21", train_pipe, gpt, arrays, port, card)
        print("phase 21, one call: " + json.dumps(
            {"launches_pipe_train": launches, **out}, default=str)
            + f" [{card}]")
        print(card)
        print(json.dumps({"phase_only": "21", "passed": True,
                          "cards": torch.cuda.device_count()}))
        return 0
    t("2", kernel_checks, pa)
    vocab = gpt.gpt_1p3b().vocab_size
    differ, u_err = t("2 (sampling checks)", sampling_checks, so, vocab,
                      card)
    samp_times = t("2 (sampling times)", sampling_times, so, vocab, card)
    model, launches, arrays = t("3", serve_f32, pa, gpt, serving, card)
    # the sampling row's launches are phase 3b's, the sampled main path
    launches["sample_tokens"] = t("3b", serve_sampled, pa, model, serving,
                                  card)["sample_tokens"]
    t("3c", serve_wide_vocab, pa, gpt, serving, card)
    prefix_launches = t("3d", serve_prefix, pa, model, serving, card)
    recovery_launches = t("3e", serve_recovery, pa, so, model, serving, card)
    quant_launches = t("4-5", serve_quantized, pa, gpt, serving, arrays,
                       card)
    torch.cuda.empty_cache()
    # the int8 rows' launches are phase 5's, the path that runs them
    for name in PAGED[2:]:
        launches[name] = quant_launches[name]
    timing = t("6", serve_bf16, model, pa, serving, card)
    del model
    torch.cuda.empty_cache()
    spec_launches, _ = t("13", serve_spec, gpt, serving, pa, so, arrays, card)
    lora_launches, tier_launches, _ = t("14", serve_lora_tier, gpt, serving,
                                        pa, so, arrays, card)
    pool_launches, phase15 = t("15", serve_gateway, gpt, serving, pa, so,
                               arrays, card)
    fleet_launches, phase16 = t("16", serve_fleet_wal, gpt, serving, pa,
                                arrays, card, phase15["pool"])
    disagg_launches, phase17, finish_17b = t(
        "17", serve_disagg, gpt, serving, pa, arrays, card, phase15["pool"],
        phase16["fleet"])
    # 17b's decode worker respawns while phase 7 checks the flash kernels
    try:
        t("7", flash_checks, fa)
    finally:
        t("17b's end after 7", finish_17b)
    print("phase 17, one call: " + json.dumps(phase17) + f" [{card}]")
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    launches_f32 = t("8", train_f32, model, arrays, port, card)
    flash_timing, flash_launches, base = t("9", train_bf16, model, arrays,
                                           port, card)
    drop_err = t("10a (checks)", dropout_checks, do, rng, functional, card)
    drop_times = t("10a (times)", dropout_times, do, rng, card)
    alpha_err, alpha_launches = t("10a (alpha checks)", alpha_checks, do,
                                  rng, nn_layers, card)
    alpha_time = t("10a (alpha times)", alpha_times, do, rng, card)
    levers = t("10b", train_levers, model, arrays, port, card, base)
    del model
    torch.cuda.empty_cache()
    levers.append(t("10b (untied head)", train_untied, arrays, port, card,
                    base))
    print(json.dumps({"levers": [dict(setting="phase 9 (baseline)",
                                      **base)] + levers}))
    launches["dropout"] = t("10c", train_dropout, arrays, port, card)
    t("10d", train_fp16_scaler, arrays, port, card)
    t("11", serve_d256, pa, gpt, serving, card)
    train = types.SimpleNamespace(
        gpt=gpt, fa=fa, flags=flags, amp=amp, TrainStep=TrainStep,
        ClipGradByGlobalNorm=ClipGradByGlobalNorm, Model=Model,
        callbacks=callbacks, io=pio, optimizer=optimizer, lr=optimizer.lr,
        checkpoint=checkpoint, resilience=resilience)
    model = gpt.GPTForCausalLM(gpt.gpt_1p3b(), device="cuda")
    family = t("12c", optimizer_family, model, arrays, train, card)
    fit = t("12a", fit_gpt, model, arrays, train, functional, card)
    del model
    torch.cuda.empty_cache()
    ckpt = t("12b", checkpoint_resume, arrays, train, functional, card)
    lbfgs = t("12d", lbfgs_full, arrays, train, card)
    export_launches, _ = t("18", serve_export, gpt, fa, arrays, card)
    tp_launches, _ = t("19", serve_tp, gpt, serving, pa, arrays, card)
    tt_launches, phase20 = t("20", train_tp, gpt, arrays, port, card)
    print("phase 20, one call: " + json.dumps(phase20, default=str)
          + f" [{card}]")
    pp_launches, phase21 = t("21", train_pipe, gpt, arrays, port, card)
    print("phase 21, one call: " + json.dumps(phase21, default=str)
          + f" [{card}]")
    print(json.dumps({"training_loop": dict(fit=fit, checkpoint=ckpt,
                                            lbfgs=lbfgs,
                                            optimizer_updates=family)}))
    timing.update(flash_timing)
    res = drop_times[str(list(DROPOUT_TIMED[1]))]
    timing["dropout"] = dict(
        max_abs_err=drop_err, ms=res["ms"], plain_ms=res["plain_ms"],
        bound_ms=res["bound_ms"], bound_by=res["bound_by"], library_ms=None,
        library_note="no PyTorch call draws JAX's threefry bits; torch's "
                     "Philox dropout is timed beside it as a yardstick",
        philox_ms=res["philox_ms"], times=drop_times,
        launches_alpha=alpha_launches, alpha_max_abs_err=alpha_err,
        alpha_ms=alpha_time["ms"], alpha_plain_ms=alpha_time["plain_ms"],
        alpha_bound_ms=alpha_time["bound_ms"],
        alpha_bound_by=alpha_time["bound_by"])
    # a flash row's launches are the timed bf16 phase's (the tensor-core
    # instances its times belong to); launches_f32 the f32 phase's
    launches.update(flash_launches)
    st = samp_times[("f32", 8, "sampled")]
    timing["sample_tokens"] = dict(
        max_abs_err=u_err, token_mismatches=differ, ms=st["ms"],
        plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
        bound_by=st["bound_by"], library_ms=None,
        library_note="no PyTorch call samples with top-k/top-p under "
                     "threefry keys; torch.argmax computes the greedy rows",
        argmax_ms=st["argmax_ms"],
        times={f"{n} [{r}, {vocab}] {k}": v
               for (n, r, k), v in samp_times.items()})
    kernels = [dict(name=name, route="cuda", source=SOURCES[src],
                    replaces=REPLACES[name], launches=launches[name],
                    **({"launches_f32": launches_f32[name]}
                       if name in FLASH else {}),
                    **({"launches_tp_train": tt_launches[name],
                        "launches_pipe_train": pp_launches[name]}
                       if name in FLASH + DROPOUT else {}),
                    **(export_launches if name == "flash_forward" else {}),
                    **({"launches_prefix": prefix_launches[name],
                        "launches_recovery": recovery_launches[name]}
                       if name in PAGED[:2] + SAMPLING else {}),
                    **({"launches_spec": spec_launches[name],
                        "launches_lora": lora_launches.get(name, 0),
                        "launches_tier": tier_launches.get(name, 0),
                        "launches_pool": pool_launches.get(name, 0),
                        "launches_fleet": fleet_launches.get(name, 0),
                        "launches_disagg": {
                            role: disagg_launches.get(role, {}).get(name, 0)
                            for role in ("prefill", "decode", "total")},
                        "launches_tp": tp_launches[name]}
                       if name in PAGED + SAMPLING else {}),
                    **timing[name])
               for src, names in (("paged_attention", PAGED),
                                  ("flash_attention", FLASH),
                                  ("sampling", SAMPLING),
                                  ("dropout", DROPOUT))
               for name in names]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
