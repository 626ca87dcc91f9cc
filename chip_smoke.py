#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Drives the port's mapping, analytics, serving, deployment, LM serving,
training and MoE paths through their public entry points
(``GeoEngine.build`` / ``assign`` / ``assign_padded``, ``ops.pip_one``,
``BlockAggregator``, ``ops.assign_aggregate``, ``GeoServer``,
``GeoIndexSet.save`` / ``GeoServer.from_artifact``, ``AsyncGeoServer``,
``enrich``, ``data.make_source``, ``repro_torch.launch.serve``,
``launch.train``'s ``setup`` / ``run_config`` with
``runtime.driver.train_loop`` over ``runtime.steps.make_train_step``,
``checkpoint.manager``, the MoE, vlm, encdec and recurrent families
through ``make_prefill_step``, ``launch.serve`` and ``launch.train``,
and the Morton-sharded lookup through ``GeoEngine.assign_sharded`` and
``core.distributed.assign_fast_distributed`` over
``launch.mesh.Mesh``) on the card:

  1. prints the card (nvidia-smi name and power limit), torch and nvcc
     versions, and builds the CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (build seconds, ptxas register counts), and beside
     them a copy of the tensor-core flash kernel with a planted fault
     (one KV tile skipped); meanwhile a child process builds the host map
     of phase 3;
  2. LM path: ``flash_attn_bhsd`` against its twin on both routes (f32
     and bf16, causal and full, D 12 / 16 / 24 / 32 / 64 / 128, S 64 /
     100 / 300 / 2048: bf16 at D 64 / 128 on the tensor-core kernel, the
     rest on the CUDA-core one, D 12 and 24 zero-padded to 16 and 32 by
     the wrapper and held against the twin at the true D; a second
     launch bit-equal; GQA through ``flash_attn`` and
     ``ops.flash_attn``), then
     Qwen1.5-0.5B at full width (24 layers, d 1024, vocab 151,936; random
     weights from ``LM_SEED``) serving 8 prompts of 2,048 tokens and 64
     greedy tokens through ``launch.serve.serve``: the prefill launches
     the flash kernel once per layer, every call on the tensor-core route
     (each call held against the twin, and the planted fault shown to
     fail the same bound on each), decode
     launches none of the eight kernels, and a teacher-forced
     ``forward`` over prompt + generated tokens agrees with decode's
     logits and, wherever its top-2 margin is clear, with its tokens;
     after the LM timing of phase 7, MiniCPM-2B's reduced config (head
     dim 12) served through ``launch.serve.serve``, each prefill flash
     call held against the twin, and one flash call over 65,537 heads
     (two launches), its first, last and sampled heads against the twin;
  3. the benchmark-scale census (benchmarks/common.py SCALE: 16 states /
     128 counties / 3,072 blocks) and its covering at max_level 9, from
     the child process, and six engines on cuda: ``fast`` (gathered PIP
     kernel), ``fast`` with ``fused=True`` (candidate PIP kernel),
     ``fast_onepass`` (one-pass cascade kernel), ``simple`` and
     ``simple`` with ``fused=True`` (the bbox kernels, then gathered /
     candidate PIP per level) and ``hybrid`` (the cell lookup, then the
     simple cascade on boundary points);
  4. kernel phase: a 2^16-point batch through each engine, and through
     ``ops.pip_one`` against each state's edge table; every kernel call
     is held against its plain PyTorch twin on the same inputs (exact
     equality), and each engine against a CPU engine of the same config
     (the twins) on ids and stats, and on ``flat[1:].view(-1, 2)``, a
     misaligned view of the batch, equal to the aligned copy;
     ``crossings_one`` on E = 0, 1 and 284 (no tile multiple) and a state
     table over 2^16 + 5 points with NaN / inf / off-extent ones, and
     ``crossings_candidates`` on the state tables packed at BE = 64
     (2-3 blocks a polygon), a pool with a polygon of 0 live edges and a
     pool rebuilt through ``EdgePool.from_numpy`` (derived live counts),
     each bit-equal to its twin and a second launch bit-equal;
     ``bbox_mask`` at 1 / 7 / 16 / 33 / 56 / 513 / 3,072 boxes (both
     kernel layouts) x 0 / 1 / 2^16 + 3 points with NaN / inf / FAR
     points, points on box edges and empty boxes, the points also 8
     bytes into a buffer: bit-equal to the twin, a second launch
     bit-equal, one launch a call; ``segment_reduce_sorted`` on 2^16
     rows of uniform, skewed (40 % in one segment), invalid (parked and
     unparked), odd-``S``, ``S`` = 1, ``S`` > rows, 2^16 + 3 rows and
     empty ids, and on 2^21 rows with one segment over more than 64 row
     tiles: integer-valued and absent (zero) columns exact against the
     twin and the numpy oracle, f32 columns within rtol 1e-5 of the
     oracle, a second launch bit-equal to the first, a column 4 bytes
     into a buffer bit-equal to the aligned one, 1 launch a call without
     values and 2 with;
  5. main path: 2^24 points through each engine, with every launch
     counter set to 0 just before and read just after (the kernels each
     engine must launch, and no other); block ids equal across the exact
     paths and to ground truth (accuracy 1.0), ``hybrid`` equal to
     ``fast`` id for id, ``simple`` equal to ``simple`` fused in ids and
     stats, no overflow, ``assign_padded`` -1 on its pad rows; then the
     2^24 points against all 16 state tables through ``ops.pip_one``;
     then the analytics path: ``BlockAggregator.fused_counts`` of the
     2^24 points through ``fast`` (equal to ``np.bincount`` of the
     assigned ids; the segment kernel launched once), ``reduce`` with an
     integer-valued column (equal to the numpy oracle) and
     ``ops.assign_aggregate`` on the ``fast_onepass`` index (equal to the
     segment reduction of the cascade's ids);
  6. serving path: a ``GeoServer`` over ``fast`` with the windowed
     analytics mounted replays examples/analytics_geo.py's stream on
     this map (served ids equal direct assigns, cache on = cache off,
     analytics snapshot equal to a CPU port server's on the same
     requests, spans and histograms for every stage), then serves 256
     requests of 16,384 points (pts/s, p50/p99 request latency);
  7. times each engine (pts/s), ``fused_counts`` (pts/s, and its
     assign / sort / kernel split), the LM's prefill and decode tok/s
     (right after phase 2, while the child process builds the host map),
     and each kernel at the main path's inputs beside its plain twin,
     its bound and, for flash attention, ``scaled_dot_product_attention``
     and, for the segment counts, ``torch.bincount`` (timed only: the
     port never calls them) and an empty kernel (the least time a launch
     shows by the same clock), ``bbox_mask`` at a second width (56
     county boxes), ``bbox_count_select`` (off the main path) on the
     boxes the cascade's glue gathered before ``bbox_select_children``,
     ``bbox_select_children`` also at the paper cell's shapes (2^22
     points of a 56 x 58 x 68 map, k 4), with each
     ``crossings_candidates`` call's rows, those with a candidate and
     those at the padding slots' alias point; then ``assign_cascade`` on
     three more batches sampled (seed CASCADE_SEED) from the main path's
     points as its call classified them: 2^20 points all in boundary
     cells, 2^20 all in interior cells, and 2^20 + 37 points with
     off-extent, infinite and NaN ones mixed in, each bit-equal to the
     twin, the first two timed (the locate stage alone against locate +
     edge tests);
  8. deployment paths (after phase 7, whose pts/s name the winner):
     a. the winner among ``fast``, ``fast`` fused and ``fast_onepass``
        recorded in a ``GeoIndexSet`` (``record_tuning``: winner, pool
        block size, device kind, pts/s), saved (seconds, bytes on disk),
        and a ``GeoServer.from_artifact(strategy="auto")`` cold start on
        the card (load + ensure + first assign seconds beside phase 3's
        covering BFS): its plan is the winner's strategy, its served ids
        on 2^20 of the main path's points equal the warm engine's, and
        only the one-pass kernel launched (the planner's CUDA rule puts
        exact ``fast`` on it too); a copy whose tuning names device kind
        "tpu" replans to ``fast``, on the one-pass kernel
        (``assign_cascade``);
     b. ``AsyncGeoServer`` over ``fast`` with phase 6's ServeConfig
        (analytics mounted), 4 submitters and 2 replicas: phase 6's
        stream from one client in order (ids and analytics snapshot
        equal to the sync server's), then phase 6's 256 requests of
        16,384 points from 8 client threads (every future resolves with
        a direct assign's ids, no failed flush or request; pts/s and
        p50 / p99 beside the sync server's), ``crossings_gathered`` the
        only kernel launched;
     c. ``core.enrich.enrich`` of the 2^24 points (ids equal the ``fast``
        engine's) and ``data.make_source`` of Qwen1.5-0.5B's full config
        (8 x 2,048 tokens) over the ``fast`` engine: ``batch_at(0..3)``'s
        geo blocks equal a direct assign of the sampled points, its
        tokens a CPU source's, most points on the map, and
        ``crossings_gathered`` launched;
  9. training (after phase 8):
     a. ``make_flash_attn_trainable`` at [2, 2048, 16, 64] bf16: output
        equal to ``flash_attn``'s bit for bit (the wgmma kernel launched
        once), dq / dk / dv equal to ``torch.autograd.grad`` through
        ``blockwise_attn`` bit for bit;
     b. Qwen1.5-0.5B at full width built to train (f32 master weights,
        random from TRAIN_SEED), ``launch.train.run_config`` with remat
        "full", 8 x 2,048 GeoEnriched tokens over the ``fast`` engine,
        ``train_loop`` over ``make_train_step`` for a warm-up step and 4
        timed ones: each step launches ``flash_attn_bhsd`` 48 times (24
        forward + 24 recompute), all on wgmma, and nothing else of the
        eight; the warm-up's calls each held against the twin; losses
        and grad norms finite, the first ce near ln(V), the loss falling;
        step ms, tok/s, peak device memory; one more step split into
        forward / backward / optimizer (CUDA events) and one under
        torch.profiler (busy share, top kernels and operators);
     c. the step's loss, ce and grad norm against the plain path's (the
        same parameters and batch with flash's twin in the kernel's
        place), within TRAIN_LOSS_ATOL / TRAIN_GNORM_RTOL;
     d. one checkpoint save and restore of the full-width state (params,
        m, v; free disk printed first), timed, the restored tensors equal
        to the saved ones;
     e. ``train_loop`` at the reduced config, 8 x 2,048 tokens: a failure
        injected at step 6, restored from step 4, ends with parameters
        and optimizer state equal to a run without it, bit for bit;
 10. the MoE family (after phase 9):
     a. Mixtral-8x7B at its published widths, MOE_LAYERS of 32 layers,
        random weights drawn leaf by leaf (``launch.serve.load_model``):
        ``runtime.steps.make_prefill_step`` over MOE_BATCH x MOE_SEQ
        tokens launches ``flash_attn_bhsd`` once a layer (S <= window),
        all on the tensor-core route, and nothing else of the eight; each
        call held against the twin and the planted fault shown to fail
        it; the forward's logits within LOGIT_TOL of the plain path's
        (flash's twin), that run routed as the kernel's (each choice of
        its own that differs a near tie, ROUTE_GAP) and dropping the
        same choices; step tok/s, peak memory and a profile by part
        (router, dispatch, expert products, flash, unembedding); the
        flash kernel timed at that shape beside its bound and
        ``scaled_dot_product_attention``;
     b. ``launch.serve.serve`` with MOE_SERVE (the prompt fed token by
        token: the MoE model has no ``prefill``, as in ``repro``): no
        kernel of the eight launched, tok/s;
     c. the no-drop copy (capacity_factor E / k): decode over the prompt
        and generated tokens, routed as a teacher-forced ``forward``
        routed, within LOGIT_TOL of its logits, argmax equal where its
        margin is clear;
     d. DeepSeek-V2 at its published widths, DSV2_LAYERS of 60 layers:
        a forward over DSV2_BATCH x DSV2_SEQ and the token-loop serve of
        DSV2_SERVE, no kernel of the eight launched (head dim 192; MLA);
     e. Mixtral's reduced config trained MOE_TRAIN_STEPS steps through
        ``launch.train.setup`` and ``train_loop``: losses finite,
        ``lb_loss`` and ``dropped`` reported;
 11. the vlm and encdec families (after phase 10):
     a. Llama-3.2-Vision-90B at its published widths, VLM_GROUPS of its
        20 groups (random weights drawn leaf by leaf, both gates of each
        cross block then drawn non-zero): ``make_prefill_step`` over
        VLM_BATCH x VLM_SEQ tokens and 1,600 image tokens a row launches
        ``flash_attn_bhsd`` once a self layer (causal, on the tensor-core
        route) and nothing else of the eight (the gated cross-attention
        is ``blockwise_attn``, as in ``repro``); each call held against
        the twin and the planted fault shown to fail it; the logits
        within LOGIT_TOL of the plain path's; tok/s, peak memory and a
        profile by part (flash, cross attention, FFN, unembedding, the
        rest); ``launch.serve.serve`` with XATTN_SERVE (the token loop):
        no kernel launched; with the attention gates at 0, decode within
        LOGIT_TOL of a teacher-forced forward (decode never fills the
        image caches, as in ``repro``);
     b. SeamlessM4T-medium whole: ``make_prefill_step`` over
        ENCDEC_BATCH x ENCDEC_SEQ frames and tokens launches flash once
        an encoder layer on the full (non-causal) route and once a
        decoder layer causal, all on wgmma, each call against the twin
        and the planted fault; logits within LOGIT_TOL of the plain
        path's; profile by part; flash timed at both shapes beside its
        bound and ``scaled_dot_product_attention``; the token-loop serve,
        no kernel launched;
     c. both reduced configs trained XATTN_TRAIN_STEPS steps through
        ``launch.train.setup`` and ``train_loop``: losses finite, flash
        once a self layer a step, the loss on a held-out batch lower
        after the steps than before;
 12. the ssm_hybrid and xlstm families (after phase 11; RECURRENT_*):
     a. Zamba2-1.2B whole at its published widths (random weights drawn
        leaf by leaf, ``a_log`` / ``dt_bias`` / ``b_q`` then drawn live:
        ``live_ssm``): ``make_prefill_step`` over RECURRENT_BATCH x
        RECURRENT_SEQ tokens launches ``flash_attn_bhsd`` once a group
        (the shared block, causal, on the tensor-core route) and nothing
        else of the eight; each call held against the twin and the
        planted fault shown to fail it; each shared block's output
        within RECURRENT_BLOCK_RTOL of the same block on the plain path
        (flash's twin) fed the same input, the whole-model logits
        against the plain path's reported; tok/s, peak memory and a
        profile by part (Mamba2's in_proj, conv, SSD chunk scan, gated
        norm + out_proj; the shared block, flash inside it; the
        unembedding; the rest); flash timed at that shape beside its
        bound and ``scaled_dot_product_attention``; the token-loop serve
        of RECURRENT_SERVE (no kernel launched); decode over its prompt
        and tokens against a teacher-forced forward, block by block
        (each block fed the forward's input through ``decode_step``'s
        caches, within RECURRENT_BLOCK_RTOL), the whole-model logits
        reported;
     b. xLSTM-1.3B whole: the forward over RECURRENT_BATCH x
        RECURRENT_SEQ launches none of the eight (the sLSTM steps one
        position at a time, host-bound: tok/s and peak memory of the
        whole forward; launches, busy share and the profile split by
        mLSTM, sLSTM and unembedding over RECURRENT_PROFILE_SEQ tokens a
        row);
        the token-loop serve; decode against the forward as in (a), from
        the forward's start state (``repro``'s ``init_cache`` zeroes the
        stabilizers, the forward starts them at -inf: decode starts
        there too);
     c. both reduced configs trained RECURRENT_TRAIN_STEPS steps as in
        11c (flash once a group a step for zamba2, never for xLSTM);
 13. the Morton-sharded lookup (after phase 12; SHARDED_*), from phase
     3's host map:
     a. one NCCL rank (world size 1) and a (1, 1) mesh, whose
        reductions are the identity: ``assign_sharded`` of the 2^24
        points through the ``fast`` engine (only ``crossings_gathered``
        launched) and the ``fast`` fused one (only
        ``crossings_candidates``), ids equal to ``fast`` exact's, none
        dropped, n_boundary equal; pts/s of TIMED_BATCHES batches
        beside ``fast``'s and ``fast`` fused's;
     b. SHARDED_RANKS gloo ranks spawned with torch.multiprocessing,
        all on cuda:0 (four processes time-share the card: their pts/s
        is no scaling figure), the host map handed over as a saved
        ``GeoIndexSet``: ``assign_sharded`` of the first SHARDED_N
        points on a (1, 4) mesh (gathered and fused) and a (2, 2) one,
        on every rank ids equal to ``fast`` exact's, n_boundary and
        n_pip equal to a (1, 1) run's on the same points, none dropped,
        each run's kernel launched and no other; each rank's
        coordinates row-major, its index bytes per shard, peak device
        memory, and whether gloo took the CUDA buffers ("direct") or
        ``Mesh`` staged them through the host ("host");
     c. drops: cap_shard SHARDED_DROP_CAP on SHARDED_SKEW_N points, 3/4
        of them in one Morton range, on the (1, 4) mesh: n_dropped
        equal to the host's count over the owners, and the ids that
        come back -1 exactly the points past the first ``capacity`` of
        their shard's points in input order;
     d. ``assign_fast_distributed`` on the (1, 4) mesh: ids equal to
        (a)'s.
 14. the model half of distributed (after phase 13; MESH_*): one
     process first runs the references (Mixtral-8x7B at its published
     widths, MESH_MOE_LAYERS layers, random weights from MOE_SEED: its
     forward over the whole batch and over each half, each forward's
     routing recorded, and its token loop with each step's fed token,
     routing and what ``op_log`` records;
     Qwen1.5-0.5B's steps on a (1,) mesh, which casts as the ranks'
     mesh does; (d) / (e)'s models: each forward's last logits and
     token loop), then MESH_RANKS gloo ranks spawned on cuda:0 (time-
     shared: no scaling figure) draw their blocks of the same weights
     (``sharding.rules.init_sharded``) and run the steps with the
     residual sequence-parallel wherever ``repro`` pins it (every
     transformer block of (a), (b'), (d), (e)'s encoder, (f) and (g)'s
     shared blocks: S = 2,048 divides the 4-way and 2-way axes), each
     printing its ranks' collective calls and result bytes by kind
     (``dryrun.counted_collectives`` around the forward or step):
     a. ``make_prefill_step`` over MESH_MOE_BATCH x MESH_MOE_SEQ on a
        (1, 4) and a (2, 2) mesh, tensor-parallel over "model" (each
        rank its heads, vocab block and experts), from the rank's blocks
        (the step gathers each block just before it runs and frees it
        after: no two blocks' gathered leaves alive at once, by weakrefs),
        routed as one process routed the same rows (each choice of their
        own that differs must be a near tie): flash_attn_bhsd launched
        once a layer a rank at [B_loc * H / m, S, hd] (wgmma, each call
        against the twin) and nothing else, the last logits (gathered
        over the vocab and the rows) within LOGIT_TOL of one process's,
        dropped equal to one process's at the same per-shard capacity; ms
        a forward, the most compute-tree bytes held at once beside the
        whole tree's (gathered at once, its seconds) and the gathered
        layout's (every leaf but the experts whole over "model"), peak
        memory of the timed forwards (blocks included) and the
        collectives' routes per rank; flash timed at the
        (1, 4) shape on rank 0's first call (the kernels line's
        ``mesh_tp_shape``); then the token loop (MESH_SERVE) on (1, 4)
        through ``make_serve_step`` on each rank's block of the cache
        (its kv heads: 1/4 of one process's k / v bytes), no kernel
        launched, fed one process's tokens and routed as it routed: each
        rank's vocab block of every step's last logits within LOGIT_TOL
        of one process's (where they are not bit-equal, ``op_log`` names
        the first value that differs after equal ones: an attention
        output, the expert buckets or outputs, the MoE output, the final
        hidden state or the logits);
     b. Qwen1.5-0.5B at its published width through
        ``launch.train.setup_mesh`` on the (MESH_RANKS,) ("data",) mesh,
        MESH_TRAIN_STEPS steps of ``make_train_step`` (remat "full"; 48
        wgmma flash launches a step a rank, the first step's each
        against the twin): step 0's loss, ce and grad norm within
        phase 9's bounds of one process's; on the same mesh Mixtral-8x7B
        at its published widths, each rank's experts on its slice of
        one global capacity plan's slots (ROADMAP item 7f): (a)'s
        prefill over MESH_MOE_BATCH x MESH_MOE_SEQ, routed as one
        process's forward of the whole batch routed (each differing
        choice a near tie), every expert call on [8, ceil(C / 4), 4096]
        (C = 2,560), dropped equal to one process's, the last logits
        within LOGIT_TOL of its own (the largest difference printed, and
        whether they are bit-equal); then one ``make_train_step`` of
        MESH_DATA_MOE_TRAIN (remat "full"), routed as one process's step
        on a (1,) mesh routed: loss and ce within phase 9's bounds,
        ``lb_loss`` within tests/moe_pair.py's bound, dropped equal;
     c. that state saved from the mesh (``CheckpointManager.save(...,
        shardings=)``: rank 0 writes whole arrays), restored on a (2, 2)
        mesh (each rank its blocks) and in one process, all three equal
        bit for bit (position-weighted integer checksums of the f32
        bits, summed over the blocks);
     b'. Qwen1.5-0.5B at its published width, one ``make_train_step``
        on a (2, 2) ("data", "model") mesh, tensor-parallel (remat
        "full", MESH_TRAIN_BATCH x MESH_TRAIN_SEQ, 48 wgmma flash
        launches a rank at [B_loc * H / 2, S, hd], each against the
        twin), from the rank's blocks (a block gathered at a time, in the
        forward and again in the recompute, never two at once): its loss,
        ce and grad norm within phase 9's bounds of one process's first
        step; the blocks' bytes, the most compute-tree bytes held at once
        beside the whole tree's, and the step's peak bytes a rank;
     d. Llama-3.2-Vision-90B at its published widths, VLM_GROUPS of its
        20 groups (both gates of each cross block drawn live), on a
        (1, 4) mesh, tensor-parallel over "model" (16 q heads, 2 kv heads
        and a quarter of the FFN and the vocab a rank, self and cross
        blocks alike; each rank draws its blocks in turn):
        ``make_prefill_step`` over MESH_VLM_BATCH x VLM_SEQ tokens and
        1,600 image tokens a row launches flash once a self layer a rank
        at [B_loc * 16, S, 128] (causal, wgmma, each call against the
        twin) and nothing else; the last logits (gathered over the
        vocab) within LOGIT_TOL of one process's; ms a forward, the
        compute tree's bytes and gather seconds beside the gathered
        layout's (gathered leaf by leaf), peak memory; then the token
        loop (MESH_SERVE) through ``make_serve_step`` on each rank's
        block of the caches (k / v / img_k / img_v: 2 of 8 kv heads, a
        quarter of one process's bytes), no kernel launched, and fed one
        process's tokens: every step's last logits within LOGIT_TOL of
        its own;
     e. SeamlessM4T-medium whole on (1, 4), the same way: over
        MESH_ENCDEC_BATCH x ENCDEC_SEQ frames and tokens, flash once an
        encoder layer (full) and once a decoder layer (causal) a rank at
        [B_loc * 4, S, 64], the head whole on every rank (its vocab of
        256,206 does not split 4 ways), the k / v / cross_k / cross_v
        caches 4 of 16 kv heads a rank; flash timed at (d)'s and (e)'s
        rank shapes on rank 0's first call (the kernels line's
        ``mesh_vlm_causal_shape``, ``mesh_encdec_full_shape`` and
        ``mesh_encdec_causal_shape``);
     f. DeepSeek-V2 at its published widths, 2 of its 60 layers (the
        dense first layer and one MoE layer), on (1, 4), tensor-parallel
        over "model" (32 of 128 MLA heads, its re-blocked ``wuq`` cut to
        them, the shared experts' width and the dense layer's GQA and FFN
        split; the latents and the ``ckv`` / ``kr`` cache whole):
        ``make_prefill_step`` over MESH_LAST_BATCH x MESH_LAST_SEQ
        tokens, no kernel launched (head dim 192), routed as one process
        routed (each differing choice a near tie), the last logits within
        LOGIT_TOL of one process's; the head fed one process's final
        hidden state within LOGIT_TOL; then the token loop (4 x 128 +
        16) on the whole ckv / kr cache, fed one process's tokens and
        routed alike, every step within LOGIT_TOL;
     g. Zamba2-1.2B whole (38 layers) on (1, 4): 16 of 64 Mamba2 heads
        and 8 of 32 attention heads a rank; flash launched once a shared
        block (6) a rank at [16, 2048, 64], causal, wgmma, each call
        against the twin, and nothing else of the eight; each Mamba2 and
        shared block fed one process's input to it within
        RECURRENT_BLOCK_RTOL of its output's scale, the head fed one
        process's final hidden state within LOGIT_TOL (the whole
        forward's logits reported: they decorrelate at full depth); the
        token loop (2 x 32 + 16: MESH_LAST's comment) on the head-split
        state (S and the conv state at the rank's heads, the shared
        caches at its kv heads), no kernel launched, its logits
        reported;
     h. xLSTM-1.3B, one of its six groups (7 mLSTM blocks and its sLSTM),
        on (1, 4), one of 4 heads a rank, the same way, no kernel
        launched, its last logits and every loop step's (2 x 128 + 16)
        within LOGIT_TOL of one process's; for each of (f)-(h): ms a forward a rank, the compute
        tree's bytes and gather seconds beside the gathered layout's,
        peak memory a rank, each cache leaf's bytes a rank beside one
        process's; flash at (g)'s rank shape on rank 0's first call
        (the kernels line's ``mesh_zamba2_shape``).
 15. the dry-run (``launch.dryrun``, after phase 14; no kernel launched):
     a. ``count_step`` on the meta device for phase 14 (a)'s cells (the
        serving build of Mixtral-8x7B at MESH_MOE_LAYERS layers, the
        (1, 4) and (2, 2) meshes, MESH_MOE_BATCH x MESH_MOE_SEQ prefill)
        at each rank: its blocks' bytes, the most compute-tree bytes its
        step holds at once (``tree_bytes``) and the whole tree's, and its
        collectives' bytes and calls by kind equal to what that rank
        measured in phase 14 (a) (``held_tree``; ``dryrun.
        counted_collectives`` around its first step call, its gathers
        included); its argument + temp bytes printed beside the rank's
        peak allocation, with their ratio (reported, not held);
     b. the CLI's ``main`` over DRYRUN_CLI in this process: exit 0, and
        ``torch.cuda.memory_allocated()`` unchanged across it, its peak
        too (nothing allocated on the card);
     c. the phase's seconds.

Kernel calls are held against their twins as they happen when their
arguments are too large to keep (the simple path's gathered state edges
are 19 GB a call at 2^24 points); the calls that are timed are kept.
Any failed check raises and the script exits non-zero.  The last line
is the device JSON; the line before it the kernels JSON.  Without a
CUDA device it exits non-zero and prints no result.
"""
import argparse
import contextlib
import ctypes
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# benchmarks/common.py SCALE: 16 states / 128 counties / 3,072 blocks.
SCALE = dict(seed=0, n_states=16, counties_per_state=8, blocks_per_county=24)
MAX_LEVEL = 9
N_MAIN = 1 << 24
N_KERNEL = 1 << 16
N_PADDED, PAD_TO = 1000, 4096
TWIN_CHUNK = 1 << 18          # rows per plain-twin call (bounds its memory)
TIMED_BATCHES = 3
KERNEL_REPS = 5
LEAD_CYCLES = 10_000_000      # ~5 ms of spin on the card before a timing
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) peak, dense
# bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
OPS_PER_EDGE_TEST = 6         # 4 subtractions + 2 products (crosses())
OPS_PER_BOX_TEST = 4          # 4 comparisons (in_box())
OPS_PER_SEGMENT_ROW = 3       # add, min, max (segment.cu add_value())
SECTOR_BYTES = 32             # one DRAM sector: a binary-search step's read
# f32 segment sums vs the f64 oracle: the card's fixed-order tree sums
# came within 1.44e-7 relative on the kernel phase's cases.
SUM_RTOL = 1e-5
# examples/analytics_geo.py's stream and analytics mount.
SERVE_BUCKETS = (1024, 4096, 16384)
SERVE_SECONDS, SERVE_BACKGROUND, SERVE_VENUE, SERVE_TAIL_T = 16, 2048, 1024, 32.0
LOAD_REQUESTS, LOAD_POINTS = 256, 16384
# The deployment paths: points served after the cold start; the async
# server's threads; the GeoEnriched pipeline's shape and steps.
N_COLD = 1 << 20
ASYNC_SUBMITTERS, ASYNC_REPLICAS, ASYNC_CLIENTS = 4, 2, 8
PIPE_BATCH, PIPE_SEQ, PIPE_STEPS = 8, 2048, 4
# The LM serving path: Qwen1.5-0.5B at full width, a chat-style batch.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = "qwen1.5-0.5b", 8, 2048, 64, 0
# Head dims 12 and 24 are no kernel instance: the wrapper pads them.
FLASH_DIMS, FLASH_LENGTHS = (12, 16, 24, 32, 64, 128), (64, 100, 300, 2048)
# MiniCPM-2B's reduced config (head dim 12) served on the card.
MINICPM_ARCH, MINICPM_BATCH, MINICPM_PROMPT, MINICPM_GEN = (
    "minicpm-2b", 4, 64, 8)
# One flash call over more heads than the kernels' grid y (65,535).
MANY_HEADS, MANY_HEADS_SAMPLE = (65537, 128, 64), 8
# The candidate-PIP pool cases: the block polygon emptied of its edges;
# crossings_one's extra cases: rows (no multiple of 4 or 1,024).
EMPTY_POLY, ONE_ROWS = 5, (1 << 16) + 5
# bbox_mask's kernel-phase shapes: box counts in both of the kernel's
# layouts (513 alone in its box tiles), most no multiple of 16; the second
# timed width (56, the paper's count of US state-level entities).
BBOX_BOXES, BBOX_ROWS, BBOX_WIDE = ((1, 7, 16, 33, 56, 513, 3072),
                                    (0, 1, (1 << 16) + 3), 56)
# segment_reduce_sorted's long-span case: one segment over more than
# SPAN_TILES of the kernel's row tiles, in SPAN_ROWS rows.
SPAN_TILES, SPAN_ROWS = 64, 1 << 21
# Flash kernel vs its twin.  f32: within 1e-5 absolute (summation order
# only; on an H100 the cases came within 1.4e-6).  bf16, element by
# element: two bf16 ulps of the twin's output plus 2^-7 times the twin's
# spread, sum_j p_j |v_j| / l (``ref.flash_attn_bhsd(spread=True)``).
# Kernel and twin round p to bf16 from scores summed in another order, so
# a p at a rounding edge can round to the neighbouring value, a step of
# at most 2^-7 p_j; those steps move the output by at most 2^-7 times the
# spread, and its own rounding by up to two ulps.  (On an H100 a 2-ulp
# bound alone failed a [2, 2048, 64] case at 2.5 ulps.)  The f32 cases
# run the CUDA-core kernel without the roundings and hold its arithmetic
# to 1e-5.  The bound must also have teeth at the prefill's shape: a copy
# of the tensor-core kernel that skips KV tile FAULT_TILE must fail it on
# every prefill call.
FLASH_F32_ATOL, FLASH_BF16_ULPS, FLASH_P_STEP = 1e-5, 2.0, 2.0 ** -7
FAULT_TILE = 12               # keys 1,536-1,663 of the prefill's 2,048
# The cascade's extra batches: 2^20 boundary points, 2^20 interior ones,
# and a ragged 2^20 + 37 with off-extent points mixed in.
CASCADE_SEED, CASCADE_BATCH, CASCADE_RAGGED = 7, 1 << 20, (1 << 20) + 37
# Training (phase 9): Qwen1.5-0.5B at full width, a warm-up step then
# TRAIN_STEPS - 1 timed ones of TRAIN_BATCH x TRAIN_SEQ tokens; the
# trainable flash checked at one [B, S, H, D] bf16 shape; the restart at
# the reduced config.  The first ce sits near ln(V) (random weights give
# unit-scale logits, which add ~0.5).  The kernel's step against the
# plain path's (flash's twin on the card): the CPU tests' bounds of the
# port's step against repro's (tests/test_torch_train.py: loss 5e-3
# absolute, grad norm 5e-3 relative).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED = 5, 8, 2048, 0
TRAIN_FLASH_SHAPE = (2, 2048, 16, 64)
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 8, 4, 6
TRAIN_CE0_TOL, TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL = 1.0, 5e-3, 5e-3
# Phase 10, the MoE family: Mixtral-8x7B at its published widths, cut to
# MOE_LAYERS of 32 layers (32 are 93 GB in bf16, more than the card's 80),
# forward over MOE_BATCH x MOE_SEQ tokens, served MOE_SERVE (prompts,
# prompt tokens, generated tokens) through the token loop; DeepSeek-V2 at
# its published widths, DSV2_LAYERS of 60 (the dense first layer and two
# MoE layers, ~20 GB); Mixtral's reduced config trained MOE_TRAIN_STEPS
# steps at MOE_TRAIN_SEQ (<= its window of 32).  Two runs of the port
# compared (kernel vs plain path, decode vs forward) are routed alike: the
# second takes the first's expert choices, and each choice of its own
# that differs must be a near tie, the k-th and (k+1)-th probabilities
# within ROUTE_GAP (tests/moe_pair.py's bound).  Random weights leave
# the router's probabilities close together, so near ties are common.
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ, MOE_SEED = (
    "mixtral-8x7b", 8, 8, 2048, 0)
MOE_SERVE = (8, 128, 32)
DSV2_ARCH, DSV2_LAYERS, DSV2_BATCH, DSV2_SEQ = "deepseek-v2-236b", 3, 2, 2048
DSV2_SERVE = (2, 64, 16)
MOE_TRAIN_STEPS, MOE_TRAIN_SEQ = 2, 32
ROUTE_GAP = 2.0 ** -6
# Phase 11, the vlm and encdec families.  Llama-3.2-Vision-90B at its
# published widths, cut to VLM_GROUPS of its 20 groups of 5 layers (4
# self + 1 gated cross-attention): 10 of 100 layers, 17.1 GB of bf16
# blocks beside 8.4 GB of f32 embedding and unembedding (the 100 layers
# would be ~94 GB, over the card's 80); its forward over VLM_BATCH x
# VLM_SEQ tokens and n_img_tokens (1,600) image tokens a row.
# SeamlessM4T-medium whole (12 + 12 layers), its forward over
# ENCDEC_BATCH x ENCDEC_SEQ frames and as many tokens.  Both served
# XATTN_SERVE (prompts, prompt tokens, generated tokens) through the
# token loop (neither has a prefill, as in repro); their reduced configs
# trained XATTN_TRAIN_STEPS steps of 8 x XATTN_TRAIN_SEQ.  Both gates of
# a vlm cross block start at zero (repro's init, which would hide the
# image path): the smoke draws them from U(0.5, 1.5) after the load.
VLM_ARCH, VLM_GROUPS, VLM_BATCH, VLM_SEQ = "llama-3.2-vision-90b", 2, 4, 2048
ENCDEC_ARCH, ENCDEC_BATCH, ENCDEC_SEQ = "seamless-m4t-medium", 4, 2048
XATTN_SERVE, XATTN_SEED = (4, 128, 32), 0
XATTN_TRAIN_STEPS, XATTN_TRAIN_SEQ = 16, 64
# Teacher-forced logits (f32, scale ~1): decode against forward over the
# same tokens, both in bf16 through 24 layers; on an H100 they came
# 0.068-0.071 apart (the CPU tests see 0.05 between repro and the port
# over two layers).
LOGIT_TOL = 0.125
# Phase 12, the ssm_hybrid and xlstm families, both whole at their
# published widths: Zamba2-1.2B (38 layers: 6 groups of 6 Mamba2 blocks
# and the shared attention block, a tail of 2) and xLSTM-1.3B (48: 6
# groups of 7 mLSTMs and an sLSTM); forwards over RECURRENT_BATCH x
# RECURRENT_SEQ tokens, served RECURRENT_SERVE through the token loop
# (neither has a prefill, as in repro), the reduced configs trained
# RECURRENT_TRAIN_STEPS steps.  RunConfig's ssm_chunk (256) is the
# chunk.  Both families amplify bf16 rounding through their depth (the
# decay is an exponential of a projection of the unnormalized residual
# stream): repro's own jitted and op-by-op forwards of the reduced
# zamba2 lie 0.189 apart at the logits, and on the CPU a 24-layer
# zamba2 at d 512 moved 0.98 between flash and blockwise_attn, a
# 16-layer xLSTM's decode 2.0 from its forward.  So two runs that round
# apart (kernel and plain path, decode and forward) are held block by
# block: each block fed the same input, its output within
# RECURRENT_BLOCK_RTOL of its largest magnitude at every position: four
# bf16 ulps at that magnitude (an ulp is at most 2^-7 of it), for the
# two roundings of the residual adds and one ulp of each added term (the
# shared block's x + attention + FFN; a Mamba2 block's output is one
# rounded product).  On the CPU the reduced zamba2's decode came within
# 0.0139 of the scale of the forward's (the shared block; Mamba2 0.0116),
# the xLSTM's within 0.  The mLSTM's decode is fed the forward's
# projections as well (q, k, v and the gates' pre-activations): its
# input gate is exp of a bf16 projection of the unnormalized residual
# stream, and the card's GEMMs round 4 rows and 640 otherwise, so one
# ulp at |log i| ~ 17 moves the output by up to a quarter (on an H100
# the mLSTM blocks came 0.197 of their scale apart without it; on the
# CPU, one-ulp flips in 5 % of those pre-activations gave 0.24 at that
# residual scale, 0.006 without them).  The whole-model logits are
# reported beside it.
SSM_ARCH, XLSTM_ARCH = "zamba2-1.2b", "xlstm-1.3b"
RECURRENT_BATCH, RECURRENT_SEQ, RECURRENT_SERVE = 4, 2048, (4, 128, 32)
RECURRENT_BLOCK_RTOL = 2.0 ** -5
# The xLSTM forward is profiled over its first RECURRENT_PROFILE_SEQ
# tokens a row: its 2,048 sLSTM steps launch ~3.7e5 kernels, whose
# profiler events took ~140 s to collect on the card's host.  The
# reduced configs train RECURRENT_TRAIN_STEPS steps: at 16 the reduced
# zamba2's held-out loss moved by -0.04 to +0.13 over two seeds on the
# CPU (and rose by 0.007 on an H100), at 64 it fell by 0.07-0.17 over
# three.
RECURRENT_PROFILE_SEQ, RECURRENT_TRAIN_STEPS = 512, 64
# Phase 13, the Morton-sharded lookup: SHARDED_RANKS gloo ranks sharing
# the one card (NCCL refuses two ranks on one device), each joined within
# SHARDED_TIMEOUT_S, drive SHARDED_RUNS on the first SHARDED_N of the
# main path's points; the drop run sends 3/4 of SHARDED_SKEW_N of them
# (drawn with SHARDED_SEED) into Morton shard SHARDED_SKEW_SHARD, with
# cap_shard SHARDED_DROP_CAP (a capacity of N / 8 a shard).
SHARDED_RANKS, SHARDED_N, SHARDED_TIMEOUT_S = 4, 1 << 22, 180
SHARDED_SKEW_N, SHARDED_SKEW_SHARD, SHARDED_DROP_CAP, SHARDED_SEED = (
    1 << 20, 1, 0.5, 13)
# run -> (mesh shape, entry point, batch, EngineConfig changes)
SHARDED_RUNS = {
    "1x4": ((1, 4), "engine", "main", {}),
    "1x4_fused": ((1, 4), "engine", "main", {"fused": True}),
    "2x2": ((2, 2), "engine", "main", {}),
    "1x4_drop": ((1, 4), "engine", "skew", {"cap_shard": SHARDED_DROP_CAP}),
    "1x4_distributed": ((1, 4), "distributed", "main", {}),
}
# Phase 14, the model half of distributed (ROADMAP item 7): MESH_RANKS
# gloo ranks sharing cuda:0 (NCCL refuses two ranks on one device; their
# times are time-shared, no scaling figure), each joined within
# MESH_TIMEOUT_S.  (a) Mixtral-8x7B at its published widths cut to
# MESH_MOE_LAYERS of 32 layers, random weights from MOE_SEED: a
# make_prefill_step forward over MESH_MOE_BATCH x MESH_MOE_SEQ tokens,
# tensor-parallel over "model", on a (1, 4) mesh (8 heads and 2 experts a
# rank) and a (2, 2) one (16 heads and 4 experts a rank, the experts
# weights gathered over "data"), each routed as the one-process forward of
# the same rows routed (its own differing choices must be near ties), then
# the token loop serving MESH_SERVE on (1, 4).  (b) Qwen1.5-0.5B at its
# published width trained MESH_TRAIN_STEPS steps of MESH_TRAIN_BATCH x
# MESH_TRAIN_SEQ tokens on launch/train.py's (4,) ("data",) mesh, remat
# "full", against one process's step on a (1,) mesh (which casts alike);
# and one step on a (2, 2) mesh, tensor-parallel over "model".
# (c) Its state after them saved from that mesh and restored on a (2, 2)
# mesh and in one process, held bit for bit by integer checksums of the
# f32 bits (position-weighted, summed over the blocks: integer sums do
# not depend on the order).
# (d) Llama-3.2-Vision-90B at its published widths, VLM_GROUPS of its 20
# groups (random weights from XATTN_SEED, both gates of each cross block
# drawn live as in phase 11), and (e) SeamlessM4T-medium whole, each
# tensor-parallel on MESH_XATTN_SHAPE: make_prefill_step over
# MESH_VLM_BATCH x VLM_SEQ tokens (1,600 image tokens a row) and
# MESH_ENCDEC_BATCH x ENCDEC_SEQ frames and tokens against one process's
# forward, then the token loop (MESH_SERVE) on each rank's block of the
# caches against one process's loop fed the same tokens.  A row of the
# vlm adds ~1.3 GB of f32 all-reduces to a forward through gloo's host
# staging, so the batches stay small.
MESH_RANKS, MESH_TIMEOUT_S = 4, 900
MESH_MOE_LAYERS, MESH_MOE_BATCH, MESH_MOE_SEQ = 2, 4, 2048
MESH_SERVE = (4, 128, 32)
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 4, 1024
# (b) also runs Mixtral-8x7B at its published widths on the same (4,)
# ("data",) mesh, where each rank runs the experts on its slice of one
# global capacity plan's slots (ROADMAP item 7f): (a)'s prefill
# (MESH_MOE_LAYERS layers, MESH_MOE_BATCH x MESH_MOE_SEQ) against one
# process's forward of the whole batch, and one train step of
# MESH_DATA_MOE_TRAIN (layers, rows, sequence) against one process's
# step on a (1,) mesh, both routed as one process routed.
MESH_DATA_MOE_TRAIN = (1, 4, 512)
MESH_SHAPES = ((1, 4), (2, 2))
MESH_XATTN_SHAPE, MESH_VLM_BATCH, MESH_ENCDEC_BATCH = (1, 4), 2, 2
GATHER_PIECE_BYTES = 1 << 28     # gathered_layout's piece, 256 MiB
# (tag, arch, batch, sequence) of phase 14 (d) and (e).
MESH_XATTN = (("vlm", VLM_ARCH, MESH_VLM_BATCH, VLM_SEQ),
              ("encdec", ENCDEC_ARCH, MESH_ENCDEC_BATCH, ENCDEC_SEQ))
# (f)-(h) the last three families, each at its published widths on
# MESH_LAST_SHAPE, tensor-parallel over "model" (random weights from
# XATTN_SEED, zamba2's live leaves as phase 12 draws them), a forward
# over MESH_LAST_BATCH x MESH_LAST_SEQ tokens and a token loop: (tag,
# arch, layers kept (None: whole), the loop's (prompts, prompt length,
# generated)).  DeepSeek-V2 keeps its dense first layer and one MoE
# layer, the xLSTM one of its six groups (7 mLSTM blocks and its sLSTM),
# zamba2 all 38 layers.  zamba2's loop is cut to 2 x 32 + 16 (each of
# its steps all-reduces ~90 times through gloo's host staging, 0.56 s a
# step on the H100's host: 2 x 128 + 16 took 80 s of the three cases'
# 150 s).  The whole forward's and the loop's logits are held against
# one process's where they stay within LOGIT_TOL (DeepSeek-V2, the
# xLSTM); zamba2's decorrelate at full depth (phase 12's
# RECURRENT_BLOCK_RTOL comment) and are reported, its blocks and its
# head held.
MESH_LAST_SHAPE, MESH_LAST_BATCH, MESH_LAST_SEQ = (1, 4), 2, 2048
MESH_LAST = (("dsv2", DSV2_ARCH, 2, (4, 128, 16)),
             ("zamba2", SSM_ARCH, None, (2, 32, 16)),
             ("xlstm", XLSTM_ARCH, 8, (2, 128, 16)))
MESH_LAST_WHOLE = ("moe", "xlstm")      # families whose logits are held
SERVE_STAGES = ("queue_wait", "host_prepare", "device_assign", "merge",
                "request", "analytics_observe")
SPAN_NAMES = {"request", "submit", "queue_wait", "host_prepare", "route",
              "cache_lookup", "cache_learn", "device_assign", "merge"}
KERNELS = {
    "assign_cascade": ("src/repro_torch/kernels/csrc/cascade.cu",
                       "src/repro/kernels/cascade.py:224"),
    "crossings_candidates": ("src/repro_torch/kernels/csrc/gather_pip.cu",
                             "src/repro/kernels/gather_pip.py:151"),
    "crossings_gathered": ("src/repro_torch/kernels/csrc/pip.cu",
                           "src/repro/kernels/pip.py:113"),
    "crossings_one": ("src/repro_torch/kernels/csrc/pip.cu",
                      "src/repro/kernels/pip.py:86"),
    "bbox_mask": ("src/repro_torch/kernels/csrc/bbox.cu",
                  "src/repro/kernels/bbox.py:57"),
    "bbox_count_select": ("src/repro_torch/kernels/csrc/bbox.cu",
                          "src/repro/kernels/bbox.py:80"),
    "bbox_select_children": ("src/repro_torch/kernels/csrc/bbox.cu",
                             "none: the glue around bbox_count_select in "
                             "src/repro_torch/core/simple.py::_level_pass"),
    "segment_reduce_sorted": ("src/repro_torch/kernels/csrc/segment.cu",
                              "src/repro/kernels/segment.py:83"),
    "flash_attn_bhsd": ("src/repro_torch/kernels/csrc/flash_attn_wgmma.cu",
                        "src/repro/kernels/flash_attn.py:78"),
}
# The kernels each engine's assign must launch (and no other).
ENGINE_KERNELS = {
    "fast": ("crossings_gathered",),
    "fast_fused": ("crossings_candidates",),
    "fast_onepass": ("assign_cascade",),
    "simple": ("bbox_mask", "bbox_select_children", "crossings_gathered"),
    "simple_fused": ("bbox_mask", "bbox_select_children",
                     "crossings_candidates"),
    "hybrid": ("bbox_mask", "bbox_select_children", "crossings_gathered"),
    "fused_counts": ("crossings_gathered", "segment_reduce_sorted"),
    "serving": ("crossings_gathered",),
    "lm_prefill": ("flash_attn_bhsd",),
    "lm_decode": (),
    "lm_forward": ("flash_attn_bhsd",),
    "train_step": ("flash_attn_bhsd",),
}
# The main-path run whose calls each kernel's row is measured on.
ROW_PATH = {"assign_cascade": "fast_onepass",
            "crossings_candidates": "fast_fused",
            "crossings_gathered": "fast", "bbox_mask": "simple",
            "bbox_select_children": "simple", "crossings_one": "pip_one",
            "segment_reduce_sorted": "fused_counts"}
# Kernels off the main path, timed on the inputs the glue they replaced
# gathered from another kernel's main-path calls (``gathered_boxes``).
OFF_PATH = {"bbox_count_select": "bbox_select_children"}
# Positional arguments of each kernel wrapper that are per-row.
ROW_ARGS = {"assign_cascade": (0,), "crossings_candidates": (0, 1),
            "crossings_gathered": (0, 1), "crossings_one": (0,),
            "bbox_mask": (0,), "bbox_count_select": (0, 1),
            "bbox_select_children": (0, 1),
            "segment_reduce_sorted": (0, 1)}
# bbox_select_children at the paper cell's map (56 states, 58 counties a
# state, 68 blocks a county; map seed 0) and batch, k_cand 4.
PAPER_MAP = dict(seed=0, n_states=56, counties_per_state=58,
                 blocks_per_county=68)
PAPER_BATCH = 1 << 22


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after one warm run).  A spin kernel ahead of the start event keeps
    the card busy while the host queues the runs, so a kernel shorter
    than its launch's host overhead is timed on the device, not at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_over(out, want, spread) -> float:
    """Max over the elements of |out - want| / (FLASH_BF16_ULPS bf16 ulps
    of want + FLASH_P_STEP spread); equal elements count 0."""
    if not out.numel():
        return 0.0
    want = want.float()
    diff = (out.float() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)   # 0 at 0
    tol = FLASH_BF16_ULPS * ulp + FLASH_P_STEP * spread
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def flash_err(out, want, spread, what) -> tuple:
    """(max abs err, max err / tolerance) of a flash output against its
    twin's ``(want, spread)``; raises unless it is within the dtype's
    tolerance (see FLASH_*)."""
    err = max_abs_err(out, want, what)
    if out.dtype == torch.float32:
        check(err <= FLASH_F32_ATOL, f"{what}: max abs err {err} > "
                                     f"{FLASH_F32_ATOL}")
        return err, err / FLASH_F32_ATOL
    over = flash_over(out, want, spread)
    check(over <= 1.0, f"{what}: max abs err {err}, {over:.3g}x the "
                       f"tolerance")
    return err, over


def max_abs_err(a, b, what):
    """Max |a - b| of two same-shape, same-type tensors; equal values
    (infinities included) count 0."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: output {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if not a.numel():
        return 0
    if a.is_floating_point():
        d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max())
    return int((a.long() - b.long()).abs().max())


def call_bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size() for t in list(args) + list(outs)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Capture:
    """What ``Smoke.capture`` saw: ``calls[name]`` the kept calls (args,
    kwargs, outputs); ``checked[name]`` the calls held against the twin
    as they happened (count, rows, bytes, max abs err)."""

    calls: dict
    checked: dict


class Smoke:
    def __init__(self):
        from repro_torch.kernels import (_build, bbox, cascade, flash_attn,
                                         gather_pip, pip, ref, segment)
        self.build, self.ref, self.flash = _build, ref, flash_attn
        self.modules = {"assign_cascade": cascade,
                        "crossings_candidates": gather_pip,
                        "crossings_gathered": pip, "crossings_one": pip,
                        "bbox_mask": bbox, "bbox_count_select": bbox,
                        "bbox_select_children": bbox,
                        "segment_reduce_sorted": segment,
                        "flash_attn_bhsd": flash_attn}

    @contextlib.contextmanager
    def capture(self, keep=None):
        """Record every kernel-wrapper call made through ``ops`` inside the
        block; the calls still launch.  Calls of the kernels in ``keep``
        (default: all) are kept whole; every other call is held against
        its twin at once, and only its summary is kept."""
        keep = set(self.modules) if keep is None else set(keep)
        cap = Capture({name: [] for name in self.modules},
                      {name: dict(calls=0, rows=0, bytes=0, max_abs_err=0)
                       for name in self.modules})
        saved = {name: getattr(m, name) for name, m in self.modules.items()}

        def recorder(name, fn):
            def rec(*args, **kw):
                out = fn(*args, **kw)
                call = (args, kw, out if isinstance(out, tuple) else (out,))
                if name in keep:
                    cap.calls[name].append(call)
                else:
                    c = cap.checked[name]
                    c["calls"] += 1
                    c["rows"] += args[0].shape[0]
                    c["bytes"] += call_bytes(args, call[2])
                    c["max_abs_err"] = max(c["max_abs_err"],
                                           self.compare(name, [call]))
                return out
            return rec

        for name, m in self.modules.items():
            setattr(m, name, recorder(name, saved[name]))
        try:
            yield cap
        finally:
            for name, m in self.modules.items():
                setattr(m, name, saved[name])

    def twin(self, name, args, kw):
        """The kernel's plain twin on one call's inputs, run over
        TWIN_CHUNK-row slices (the twins materialize [rows, ...] temps)."""
        ref = self.ref
        if name == "segment_reduce_sorted":    # a reduction over all rows
            return ref.segment_reduce(*args)
        if name == "flash_attn_bhsd":          # (out, spread): see FLASH_*
            q = args[0]
            return ref.flash_attn_bhsd(
                *args, **kw, bk=self.flash.kv_tile(q.dtype, q.shape[2]),
                spread=True)
        rows = args[0].shape[0]
        parts = []
        for lo in range(0, rows, TWIN_CHUNK):
            a = [x[lo:lo + TWIN_CHUNK] if i in ROW_ARGS[name] else x
                 for i, x in enumerate(args)]
            if name == "assign_cascade":
                count = a[9]
                out = ref.assign_cascade(
                    *a, **kw, max_blocks=max(int(count.max()), 1))
            else:
                out = getattr(ref, name)(*a, **kw)
                out = out if isinstance(out, tuple) else (out,)
            parts.append(out)
        return tuple(torch.cat(p) for p in zip(*parts))

    def compare(self, name, calls):
        """Max |kernel - twin| over every output of every call (float
        outputs: equal values, infinities included, count 0; NaN against
        a number counts inf).  Flash attention is held to its tolerance
        here (``flash_err``); every other kernel must give 0."""
        err = 0
        for args, kw, outs in calls:
            want = self.twin(name, args, kw)
            if name == "flash_attn_bhsd":
                err = max(err, flash_err(outs[0], *want, name)[0])
            else:
                err = max([err] + [max_abs_err(a, b, name)
                                   for a, b in zip(outs, want)])
        return err

    def check_all(self, cap, what: str) -> dict:
        """Hold every call of ``cap`` against its twin; return the number
        of calls per kernel."""
        n = {}
        for name in self.modules:
            kept = cap.calls[name]
            err = max(self.compare(name, kept),
                      cap.checked[name]["max_abs_err"])
            check(err == 0 or name == "flash_attn_bhsd",
                  f"{name} differs from its twin (max abs err {err}) on "
                  f"{what}")
            n[name] = len(kept) + cap.checked[name]["calls"]
        return n


def cascade_edge_tests(fast_mod, index, pts, bid, flags, nskip) -> int:
    """Edge tests the cascade kernel ran on this batch: for each boundary
    point, the BE-edge blocks of every candidate slot it attempted
    (valid, no earlier hit) whose bbox held the point.  The hit slot is
    read back from the kernel's outputs (slot 0 from flags bit 1, a later
    slot from bid; candidate ids in a row are unique), and the rebuilt
    bbox rejections must equal the kernel's nskip."""
    pool, bbox = index.edge_pool, index.block_bbox
    k = index.cand.shape[1]
    slots = torch.arange(k, device=pts.device)[None, :]
    tests = 0
    for lo in range(0, pts.shape[0], 1 << 22):
        sl = slice(lo, lo + (1 << 22))
        p, b, f = pts[sl], bid[sl], flags[sl]
        v = fast_mod.cell_values(index, p)
        boundary = (f & 1) == 1
        cand = index.cand[(-(v + 1)).clamp(0, index.cand.shape[0] - 1)]
        valid = boundary[:, None] & (cand >= 0)
        safe = cand.clamp(0, bbox.shape[0] - 1)
        bb = bbox[safe]
        px, py = p[:, 0:1], p[:, 1:2]
        inb = ((px > bb[..., 0]) & (px < bb[..., 1])
               & (py > bb[..., 2]) & (py < bb[..., 3]))
        hit = (cand == b[:, None]) & valid
        hit[:, 0] = (f & 2) == 2
        hit_slot = torch.where(hit.any(1), hit.int().argmax(1), k)
        attempted = valid & (slots <= hit_slot[:, None])
        check(torch.equal((attempted & ~inb).sum(1).int(), nskip[sl]),
              "cascade work count: rebuilt bbox rejections != nskip")
        tests += int((pool.count[safe] * (attempted & inb)).sum())
    return tests * pool.be


def cascade_batches(smoke, call, extent, main_ms) -> dict:
    """``assign_cascade`` on three batches drawn (seed CASCADE_SEED) from
    the main path's points as its call classified them: CASCADE_BATCH
    points all in boundary cells, CASCADE_BATCH all in interior cells, and
    CASCADE_RAGGED points (no multiple of the block's 256) with one in a
    hundred replaced by an off-extent, FAR, infinite or NaN point.  Each
    must be bit-equal to the twin.  The first two are then timed: the
    interior batch runs the locate stage alone, the boundary batch the
    locate and the edge tests, which splits ``main_ms`` (the main path's
    batch) between the two stages."""
    (pts, *tables), kw, (bid, flags, _, _) = call
    fn = smoke.modules["assign_cascade"].assign_cascade
    gen = torch.Generator(device="cuda").manual_seed(CASCADE_SEED)

    def sample(rows, n):
        return rows[torch.randperm(rows.numel(), generator=gen,
                                   device="cuda")[:n]]

    is_bnd = (flags & 1) == 1
    bnd_rows = is_bnd.nonzero().squeeze(1)
    int_rows = (~is_bnd & (bid >= 0)).nonzero().squeeze(1)
    x0, x1, y0, y1 = extent
    odd = torch.tensor([[x0 - 1.0, y0], [x1 + 1.0, y1], [1e30, 1e30],
                        [-1e30, -1e30], [math.inf, y0], [x0, -math.inf],
                        [math.nan, y0], [x0, math.nan]], device="cuda")
    ragged = pts[sample(torch.arange(pts.shape[0], device="cuda"),
                        CASCADE_RAGGED)].clone()
    at = sample(torch.arange(CASCADE_RAGGED, device="cuda"),
                CASCADE_RAGGED // 100)
    ragged[at] = odd[torch.arange(at.numel(), device="cuda") % len(odd)]
    batches = {"boundary": pts[sample(bnd_rows, CASCADE_BATCH)],
               "interior": pts[sample(int_rows, CASCADE_BATCH)],
               "ragged": ragged}
    out = {}
    for name, b in batches.items():
        got = fn(b, *tables, **kw)
        want = smoke.twin("assign_cascade", (b, *tables), kw)
        err = max(max_abs_err(g, w, f"assign_cascade {name}")
                  for g, w in zip(got, want))
        check(err == 0, f"assign_cascade differs from its twin on the "
                        f"{name} batch (max abs err {err})")
        bflags = got[1] & 1
        out[name] = dict(rows=b.shape[0], max_abs_err=err,
                         boundary=int(bflags.sum()))
    check(out["boundary"]["boundary"] == CASCADE_BATCH
          and out["interior"]["boundary"] == 0,
          f"assign_cascade batches not as sampled: {out}")
    odd_out = fn(ragged[at], *tables, **kw)
    check(bool((odd_out[0] == -1).all()) and all(
        bool((o == 0).all()) for o in odd_out[1:]),
        "assign_cascade: an off-extent point got an id or flags")
    for name in ("interior", "boundary"):
        b = batches[name]
        out[name]["ms"] = cuda_ms(lambda: fn(b, *tables, **kw), KERNEL_REPS)
    per_pt = {k: out[k]["ms"] / CASCADE_BATCH for k in ("interior",
                                                        "boundary")}
    n_bnd = bnd_rows.numel()
    locate = pts.shape[0] * per_pt["interior"]
    edges = n_bnd * (per_pt["boundary"] - per_pt["interior"])
    out["split"] = dict(main_ms=main_ms, locate_ms=locate, edge_ms=edges,
                        boundary_points=n_bnd)
    print(f"assign_cascade on three more batches (seed {CASCADE_SEED}), "
          f"each == twin: {CASCADE_BATCH} boundary points "
          f"{out['boundary']['ms']:.4f} ms, {CASCADE_BATCH} interior points "
          f"{out['interior']['ms']:.4f} ms, {CASCADE_RAGGED} points with "
          f"{at.numel()} off-extent / FAR / infinite / NaN ones (-1, no "
          f"flags); the main batch's {main_ms:.4f} ms modelled as locate "
          f"{locate:.4f} ms ({pts.shape[0]} points at the interior rate) + "
          f"edge tests {edges:.4f} ms ({n_bnd} boundary points at the "
          f"boundary rate's excess)")
    return out


def segment_work(ids, values, n_segments) -> tuple:
    """(bytes, operations) that ``segment_reduce_sorted`` needs: the
    values read once (none for a zero column), 16 bytes out per segment,
    and, since the ids are sorted, only the sectors of the S + 1 binary
    searches over them (one per step); 3 operations a row with values,
    one subtraction a segment without."""
    n = ids.shape[0]
    steps = max(1, (n - 1).bit_length())
    nbytes = 16 * n_segments + (n_segments + 1) * steps * SECTOR_BYTES
    if values is None:
        return nbytes, n_segments
    return nbytes + 4 * n, n * OPS_PER_SEGMENT_ROW


def candidates_work(pids, points, first, count, live, blocks,
                    max_blocks=1) -> tuple:
    """(bytes, live-edge tests) that one ``crossings_candidates`` call
    needs: each row's id and point read once and its count written (16
    bytes), the pool's per-polygon tables and its live edges (16 bytes
    each) read once; one test for each live edge of each row's
    candidate (none for a row without one), as ``ops`` clamps the ids."""
    valid = pids >= 0
    safe = pids.clamp(0, first.shape[0] - 1).long()
    n = torch.minimum(live[safe].long(), count[safe].long() * blocks.shape[2])
    tests = int(torch.where(valid, n, 0).sum())
    nbytes = (16 * pids.shape[0] + 12 * first.shape[0]
              + 16 * int(live.long().sum()))
    return nbytes, tests


def live_edges(edges) -> int:
    """Rows of an [E, 4] table that ``crossings_one`` stages: y1 != y2."""
    return int((edges[:, 1] != edges[:, 3]).sum())


def bound_ms(name, calls, index, fast_mod) -> tuple:
    """Least time for the work of ``calls`` on an H100: the larger of the
    bytes moved (each input read once, each output written once; the
    segment kernel's sorted ids only where searched; the candidate
    pool's live edges only) over the HBM rate and the operations
    (crossing tests, box tests, segment rows) over the fp32 peak.  The
    crossing tests are those these inputs need: ``crossings_candidates``
    tests each row's candidate's live edges, ``crossings_one`` the
    table's edges with y1 != y2 (the others never straddle, and its
    staging drops them).  ``bbox_select_children`` reads each table once
    from HBM; its reads of the tables from L2 are not in the bound
    (``select_children_paper`` gives them)."""
    nbytes = ops = 0
    for args, kw, outs in calls:
        if name == "segment_reduce_sorted":
            b, o = segment_work(*args)
            nbytes, ops = nbytes + b, ops + o
            continue
        if name == "crossings_candidates":
            b, tests = candidates_work(*args, **kw)
            nbytes, ops = nbytes + b, ops + tests * OPS_PER_EDGE_TEST
            continue
        nbytes += call_bytes(args, outs)
        if name == "crossings_gathered":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_EDGE_TEST
        elif name == "crossings_one":
            ops += args[0].shape[0] * live_edges(args[1]) * OPS_PER_EDGE_TEST
        elif name == "bbox_mask":
            ops += args[0].shape[0] * args[1].shape[0] * OPS_PER_BOX_TEST
        elif name == "bbox_count_select":
            ops += args[1].shape[0] * args[1].shape[1] * OPS_PER_BOX_TEST
        elif name == "bbox_select_children":
            ops += args[0].shape[0] * args[2].shape[1] * OPS_PER_BOX_TEST
        else:
            bid, flags, _, nskip = outs
            ops += cascade_edge_tests(fast_mod, index, args[0], bid, flags,
                                      nskip) * OPS_PER_EDGE_TEST
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def gathered_boxes(smoke, calls) -> list:
    """``bbox_count_select`` calls on the boxes the cascade's glue
    gathered before ``bbox_select_children`` took its place: for each of
    that kernel's calls, the [N, C, 4] boxes of each point's parent's
    children, padded slots on the sentinel box."""
    fn = smoke.modules["bbox_count_select"].bbox_count_select
    out = []
    for (pts, parent, children, bbox, _), _, _ in calls:
        cand = children[torch.where(parent >= 0, parent,
                                    children.shape[0] - 1).long()]
        boxes = bbox[torch.where(cand >= 0, cand,
                                 bbox.shape[0] - 1).long()].contiguous()
        del cand
        res = fn(pts, boxes)
        out.append(((pts, boxes), {}, res))
    return out


def select_children_paper(smoke) -> dict:
    """``bbox_select_children`` at the paper cell's shapes: the PAPER_MAP
    census (58 counties a state, 68 blocks a county) on the card,
    PAPER_BATCH points from its sampler with their true states and
    counties as parents, k 4.  Both levels' calls bit-equal to the twin
    and launched once each; timed together and by level beside the
    twin, the bound (HBM bytes: points, parents and outputs, each table
    once) and the bytes the kernel reads from L2 ((4 + 16) C a point)."""
    from repro_torch.core.simple import SimpleIndex
    from repro_torch.core.synth import build_synth_census
    t0 = time.perf_counter()
    sc = build_synth_census(**PAPER_MAP)
    index = SimpleIndex.from_census(sc.census, device="cuda")
    xy, _, cid, sid = sc.sample_points(np.random.default_rng(0), PAPER_BATCH)
    build_s = time.perf_counter() - t0
    pts = torch.from_numpy(xy).cuda()
    fn = smoke.modules["bbox_select_children"].bbox_select_children
    levels = ("county", "block")
    calls = []
    smoke.build.reset_launches()
    for lvl, parent in zip(levels, (sid, cid)):
        args = (pts, torch.from_numpy(parent).cuda(),
                getattr(index, f"{lvl}_children"),
                getattr(index, f"{lvl}_bbox"), 4)
        calls.append((args, {}, fn(*args)))
    torch.cuda.synchronize()
    launches = smoke.build.LAUNCHES["bbox_select_children"]
    check(launches == 2, f"bbox_select_children: {launches} launches for "
                         f"two calls")
    err = smoke.compare("bbox_select_children", calls)
    check(err == 0, f"bbox_select_children differs from its twin at the "
                    f"paper's shapes (max abs err {err})")
    ms = cuda_ms(lambda: [fn(*a) for a, _, _ in calls], KERNEL_REPS)
    by_level = {lvl: cuda_ms(lambda a=a: fn(*a), KERNEL_REPS)
                for lvl, (a, _, _) in zip(levels, calls)}
    plain = cuda_ms(lambda: [smoke.twin("bbox_select_children", a, kw)
                             for a, kw, _ in calls], 2)
    bound, bound_by, nbytes, n_ops = bound_ms("bbox_select_children", calls,
                                              None, None)
    widths = {lvl: a[2].shape[1] for lvl, (a, _, _) in zip(levels, calls)}
    l2 = sum(PAPER_BATCH * (4 + 16) * c for c in widths.values())
    need = {lvl: int((outs[0] > 1).sum())
            for lvl, (_, _, outs) in zip(levels, calls)}
    row = dict(rows=PAPER_BATCH, widths=widths, k=4, launches=launches,
               max_abs_err=err, ms=ms, ms_by_level=by_level, plain_ms=plain,
               bound_ms=bound, bound_by=bound_by, hbm_bytes=nbytes,
               ops=n_ops, l2_bytes=l2, need=need, build_s=build_s)
    print(f"bbox_select_children at the paper's shapes ({PAPER_BATCH} "
          f"points, C {widths['county']} / {widths['block']}, k 4; map "
          f"and points {build_s:.1f} s): {ms:.4f} ms for both levels "
          f"(county {by_level['county']:.4f}, block "
          f"{by_level['block']:.4f}), {launches} launches, == twin; plain "
          f"twin {plain:.3f} ms; bound {bound:.4f} ms by {bound_by} "
          f"({nbytes} B, {n_ops} ops), {bound / ms:.1%} of bound; L2 reads "
          f"{l2} B ({l2 / ms / 1e9:.2f} TB/s); points in more than one "
          f"box {need}")
    return row


def segment_phase(n_blocks, tile_rows) -> list:
    """``segment_reduce_sorted`` against its twin and the numpy oracle on
    2^16 rows: uniform, skewed (40 % in one segment), invalid (ids < 0
    and >= S, parked at S as ``ops`` parks them, and unparked, straight
    to the wrapper), an odd segment count, one segment, more segments
    than rows, a row count that is no multiple of 4 and an empty input;
    and SPAN_ROWS rows with one segment over more than SPAN_TILES row
    tiles of ``tile_rows``.  Each with an integer-valued column, a uniform
    f32 column and no column (a zero column the kernel never reads);
    each column also from a view that starts 4 bytes into a buffer (not
    16-byte aligned), which must give the aligned call's bits.  A call
    launches once without values and twice with them.  Returns one
    summary row per case."""
    from repro_torch.kernels import _build, ref, segment
    rng = np.random.default_rng(2)
    n = N_KERNEL
    uniform = rng.integers(0, n_blocks, n)
    skewed = uniform.copy()
    skewed[rng.random(n) < 0.4] = n_blocks // 3
    invalid = rng.integers(-3, n_blocks + 3, n)
    span = SPAN_TILES * tile_rows + 1237
    long_span = np.sort(np.concatenate([
        rng.integers(0, n_blocks, SPAN_ROWS - span),
        np.full(span, n_blocks // 2)]))
    cases = [("uniform", uniform, n_blocks, True),
             ("skewed", skewed, n_blocks, True),
             ("invalid", invalid, n_blocks, True),
             ("unparked", invalid, n_blocks, False),
             ("odd_segments", rng.integers(0, 1000, n), 1000, True),
             ("one_segment", rng.integers(-1, 2, n), 1, True),
             ("sparse", rng.integers(0, 4 * n, n), 4 * n, True),
             ("odd_rows", rng.integers(0, 500, n + 3), 500, True),
             ("long_span", long_span, n_blocks, True),
             ("empty", np.zeros(0, np.int64), n_blocks, True)]
    rows = []
    for name, ids, n_seg, parked in cases:
        ids = ids.astype(np.int32)
        for kind in ("int", "float", "none"):
            vals = None if kind == "none" else (
                rng.integers(-50, 50, len(ids)) if kind == "int"
                else rng.random(len(ids))).astype(np.float32)
            t_ids = torch.from_numpy(ids).cuda()
            if parked:
                t_ids = torch.where((t_ids < 0) | (t_ids >= n_seg), n_seg,
                                    t_ids)
            s_ids, order = torch.sort(t_ids, stable=True)
            s_vals = None if vals is None \
                else torch.from_numpy(vals).cuda()[order]
            what = f"segment_reduce_sorted, {name} ids, {kind} values"
            _build.reset_launches()
            first = segment.segment_reduce_sorted(s_ids, s_vals, n_seg)
            launched = _build.LAUNCHES["segment_reduce_sorted"]
            # An empty column is counts alone: one launch.
            check(launched == (1 if vals is None or not len(ids) else 2),
                  f"{what}: {launched} launches")
            second = segment.segment_reduce_sorted(s_ids, s_vals, n_seg)
            twin = ref.segment_reduce(s_ids, s_vals, n_seg)
            if s_vals is not None:
                buf = torch.empty(len(ids) + 1, device="cuda")
                buf[1:] = s_vals
                view = buf[1:]
                check(not len(ids) or view.data_ptr() % 16 != 0,
                      "the column view is 16-byte aligned")
                shifted = segment.segment_reduce_sorted(s_ids, view, n_seg)
                check(all(torch.equal(a, b) for a, b in zip(first, shifted)),
                      f"{what}: a column 4 bytes into a buffer differs "
                      f"from the aligned one")
            torch.cuda.synchronize()
            oracle = ref.np_segment_reduce(ids, vals, n_seg)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{what}: a second launch is not bit-equal")
            err = 0
            for out, got, tw, want in zip(("count", "sum", "min", "max"),
                                          first, twin, oracle):
                host = got.cpu().numpy()
                if out == "sum" and kind == "float":
                    check(np.allclose(host, want, rtol=SUM_RTOL, atol=0),
                          f"{what}: sum beyond rtol {SUM_RTOL}")
                    continue
                e = max_abs_err(got, tw, what)
                check(e == 0 and np.array_equal(host, want),
                      f"{what}: {out} differs from the twin / oracle "
                      f"(max abs err {e})")
                err = max(err, e)
            total = np.abs(oracle[1]).astype(np.float64)
            rel = float(np.max(np.abs(first[1].cpu().numpy() - oracle[1])
                               / np.maximum(total, 1e-30))) \
                if len(ids) and kind == "float" else 0.0
            rows.append(dict(case=name, values=kind, rows=len(ids),
                             segments=n_seg, launches=launched,
                             max_abs_err=err, sum_max_rel_err=rel))
    return rows


def bbox_phase(smoke, pts, extent) -> list:
    """``bbox_mask`` against its twin at BBOX_BOXES boxes x BBOX_ROWS
    points: seeded boxes over the extent, one in five empty (xmin >
    xmax); the kernel phase's points with NaN, infinite and FAR rows and
    rows exactly on a box's edges mixed in; each batch also as a view
    that starts 8 bytes into a buffer (float2-aligned, not 16-byte).
    Each call bit-equal to the twin, a second launch bit-equal to the
    first, one launch a call."""
    mod = smoke.modules["bbox_mask"]
    x0, x1, y0, y1 = extent
    gen = torch.Generator(device="cuda").manual_seed(8)
    odd = torch.tensor([[math.nan, y0], [x0, math.nan], [math.inf, y0],
                        [-math.inf, y1], [x0, math.inf], [1e30, 1e30]],
                       device="cuda")
    out = []
    for m in BBOX_BOXES:
        u = torch.rand((m, 4), generator=gen, device="cuda")
        xa = x0 + (x1 - x0) * u[:, 0]
        ya = y0 + (y1 - y0) * u[:, 2]
        boxes = torch.stack([xa, xa + 0.5 * (x1 - x0) * u[:, 1], ya,
                             ya + 0.5 * (y1 - y0) * u[:, 3]], 1)
        boxes[2::5] = boxes[2::5][:, [1, 0, 3, 2]]    # empty boxes
        rows = torch.cat([pts, odd])[:max(BBOX_ROWS)].clone()
        k = torch.arange(rows.shape[0], device="cuda") % m
        edge = (torch.arange(rows.shape[0], device="cuda") % 13) == 0
        rows[edge, 0] = boxes[k[edge], 0]             # on xmin
        rows[edge, 1] = 0.5 * (boxes[k[edge], 2] + boxes[k[edge], 3])
        top = (torch.arange(rows.shape[0], device="cuda") % 17) == 5
        rows[top, 1] = boxes[k[top], 3]               # on ymax
        rows[3::97] = odd[torch.arange(rows[3::97].shape[0],
                                       device="cuda") % odd.shape[0]]
        for n in BBOX_ROWS:
            p = rows[:n].contiguous()
            buf = torch.empty(2 * n + 2, device="cuda")
            buf[2:] = p.reshape(-1)
            view = buf[2:].view(-1, 2)
            check(n == 0 or view.data_ptr() % 16 == 8,
                  "the +8-byte view is aligned")
            for layout, q in (("aligned", p), ("plus8", view)):
                what = f"bbox_mask, {n} points x {m} boxes, {layout}"
                smoke.build.reset_launches()
                got = mod.bbox_mask(q, boxes)
                launched = smoke.build.LAUNCHES["bbox_mask"]
                again = mod.bbox_mask(q, boxes)
                want = smoke.ref.bbox_mask(q, boxes)
                torch.cuda.synchronize()
                check(launched == (1 if n else 0),
                      f"{what}: {launched} launches")
                check(torch.equal(got, again), f"{what}: a second launch "
                                               f"differs")
                err = max_abs_err(got, want, what)
                check(err == 0, f"{what}: differs from its twin (max abs "
                                f"err {err})")
                out.append(dict(boxes=m, rows=n, points=layout,
                                inside=int(got.sum()), max_abs_err=err))
    print(f"kernel phase: bbox_mask == twin (and a second launch == the "
          f"first, one launch a call) at {BBOX_BOXES} boxes x {BBOX_ROWS} "
          f"points, aligned and 8 bytes into a buffer, with NaN / inf / "
          f"FAR points, points on box edges and one box in five empty; "
          f"inside bits at {max(BBOX_ROWS)} points: " + ", ".join(
              f"M {r['boxes']} {r['inside']}" for r in out
              if r["rows"] == max(BBOX_ROWS) and r["points"] == "aligned"))
    return out


def flash_phase(smoke) -> list:
    """``flash_attn_bhsd`` against its twin on the card: f32 and bf16,
    causal and full, D in FLASH_DIMS, S in FLASH_LENGTHS (100 and 300 are
    no tile multiple), BH 3 (2 at S = 2048), each within its tolerance
    and a second launch bit-equal to the first, each on the route
    ``flash_route`` names (both routes run); then GQA 8:2 through
    ``flash_attn`` (S = 256, a tile multiple) and ``ops.flash_attn``
    (S = 100).  Returns one summary row per case."""
    from repro_torch.kernels import ops
    fa, ref = smoke.flash, smoke.ref
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = []
    for dtype, causal, d, s in itertools.product(
            (torch.float32, torch.bfloat16), (True, False), FLASH_DIMS,
            FLASH_LENGTHS):
        bh = 2 if s >= 2048 else 3
        q, k, v = (rand(bh, s, d, dtype=dtype) for _ in range(3))
        route = fa.flash_route(dtype, d)
        before = smoke.build.ROUTE_LAUNCHES[f"flash_attn_bhsd:{route}"]
        out = fa.flash_attn_bhsd(q, k, v, causal=causal)
        again = fa.flash_attn_bhsd(q, k, v, causal=causal)
        twin = smoke.twin("flash_attn_bhsd", (q, k, v), {"causal": causal})
        torch.cuda.synchronize()
        what = (f"flash_attn_bhsd {route} {dtype} causal={causal} "
                f"[{bh}, {s}, {d}]")
        check(smoke.build.ROUTE_LAUNCHES[f"flash_attn_bhsd:{route}"]
              == before + 2, f"{what}: not launched on its route")
        check(torch.equal(out, again), f"{what}: a second launch is not "
                                       f"bit-equal")
        err, over = flash_err(out, *twin, what)
        rows.append(dict(case="bhsd", route=route,
                         dtype=str(dtype).split(".")[-1], causal=causal,
                         bh=bh, s=s, d=d, max_abs_err=err, over=over))

    def twin_part(i):          # the twin's output (0) or spread (1)
        return lambda q, k, v, causal: ref.flash_attn_bhsd(
            q, k, v, causal=causal, bk=fa.kv_tile(q.dtype, q.shape[2]),
            spread=True)[i]

    b, h, kh, d = 2, 8, 2, 64
    for s, fn, name in ((256, fa.flash_attn, "flash_attn"),
                        (100, ops.flash_attn, "ops.flash_attn")):
        q = rand(b, s, h, d, dtype=torch.bfloat16)
        k, v = (rand(b, s, kh, d, dtype=torch.bfloat16) for _ in range(2))
        out = fn(q, k, v, causal=True)
        want, spread = (fa.attend_bshd(twin_part(i), q, k, v, causal=True)
                        for i in (0, 1))
        torch.cuda.synchronize()
        err, over = flash_err(out, want, spread, f"GQA via {name}")
        rows.append(dict(case=f"gqa {h}:{kh} via {name}",
                         route=fa.flash_route(q.dtype, d), dtype="bfloat16",
                         causal=True, bh=b * h, s=s, d=d, max_abs_err=err,
                         over=over))
    return rows


def start_fault_build(build, tmp):
    """Start nvcc on a copy of ``csrc/flash_attn_wgmma.cu`` in ``tmp`` with
    one fault planted: the consumers of every block skip KV tile
    FAULT_TILE (they still release its stage, so the ring runs on).
    Returns (the nvcc process, the library it writes)."""
    src = (build.CSRC / "flash_attn_wgmma.cu").read_text()
    wait = "    mbar_wait(full + 8 * stage, phase);\n"
    check(src.count(wait) == 1, "flash_attn_wgmma.cu: the consumers' KV "
                                "tile wait is not where the planted fault "
                                "goes")
    cu = os.path.join(tmp, "flash_attn_fault.cu")
    with open(cu, "w") as f:
        f.write(src.replace(wait, wait + (
            f"    if (t == {FAULT_TILE}) {{\n"
            f"      mbar_arrive(empty + 8 * stage);\n"
            f"      continue;\n"
            f"    }}\n")))
    lib = os.path.join(tmp, "libflash_fault.so")
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib, cu,
         *build.LINK_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load_fault(build, proc, lib_path):
    """Wait for ``start_fault_build``'s nvcc and bind its library: a
    function of bf16 q, k, v [BH, S, D] (and ``causal``) -> the faulty
    output.  Its launches are counted nowhere."""
    log = proc.communicate()[0]
    check(proc.returncode == 0, f"planted-fault flash build failed:\n{log}")
    fn = ctypes.CDLL(lib_path).repro_flash_attn_wgmma
    fn.argtypes = build._SIGNATURES["repro_flash_attn_wgmma"]
    fn.restype = ctypes.c_int

    def faulty(q, k, v, causal=True):
        out = torch.empty_like(q)
        bh, s, d = q.shape
        status = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
                    bh, s, d, int(causal), ctypes.c_float(1.0 / math.sqrt(d)),
                    build.stream_of(q))
        check(status == 0, f"planted-fault flash launch failed ({status})")
        return out
    return faulty


def flash_bound(q, causal: bool) -> tuple:
    """(bound ms, by, bytes, operations) of one flash call on an H100: q,
    k, v read once and o written once, over the HBM rate; 4 BH S^2 D
    operations (2 products of [S, D] by [D, S]), half under the causal
    mask, over the tensor-core peak of the input dtype (bf16) or the
    fp32 peak."""
    bh, s, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    ops = 4 * bh * s * s * d // (2 if causal else 1)
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def pip_one_states(ops, state_edges, pts):
    """[S, N] inside masks of every point against each state's edge
    table, through the public ``ops.pip_one``."""
    return torch.stack([ops.pip_one(pts, state_edges[s])
                        for s in range(state_edges.shape[0])])


def lm_path(smoke, result, launches, main_calls, faulty):
    """The LM serving path on the card (phase 2 of the module doc): the
    flash kernel phase, then Qwen1.5-0.5B at full width through
    ``launch.serve.serve`` with the launch counts of each phase, every
    prefill flash call held against the twin (and ``faulty``, the kernel
    with a planted fault, shown to fail the same bound on each), and the
    teacher-forced check.  Records the prefill's flash launches and its
    first call (for the timing) in ``launches`` / ``main_calls``; returns
    (model, prompts, generated tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    result["flash_phase"] = flash_phase(smoke)
    f32_err = max(r["max_abs_err"] for r in result["flash_phase"]
                  if r["dtype"] == "float32")
    worst = {route: max(r["over"] for r in result["flash_phase"]
                        if r["dtype"] == "bfloat16" and r["route"] == route)
             for route in ("wgmma", "simt")}
    n_route = {route: sum(r["route"] == route for r in result["flash_phase"])
               for route in ("wgmma", "simt")}
    print(f"kernel phase: flash_attn_bhsd == twin on "
          f"{len(result['flash_phase'])} cases (f32 and bf16, causal and "
          f"full, D {FLASH_DIMS}, S {FLASH_LENGTHS}; GQA 8:2 via "
          f"flash_attn and ops.flash_attn; {n_route['wgmma']} on the "
          f"tensor-core route, {n_route['simt']} on the CUDA-core one): f32 "
          f"max abs err {f32_err:.3g} (tol {FLASH_F32_ATOL}), bf16 within "
          f"{worst['wgmma']:.3g}x (wgmma) / {worst['simt']:.3g}x (simt) the "
          f"tolerance ({FLASH_BF16_ULPS} ulps + {FLASH_P_STEP} spread, "
          f"element by element); second launch bit-equal")
    lm_cfg = get_config(LM_ARCH)
    n_layers = lm_cfg.n_layers
    t0 = time.perf_counter()
    model = serve_mod.load_model(lm_cfg, seed=LM_SEED, device="cuda")
    prompts = serve_mod.make_prompts(lm_cfg, LM_BATCH, LM_PROMPT, LM_SEED,
                                     "cuda")
    torch.cuda.synchronize()
    result["lm_load_s"] = time.perf_counter() - t0
    result["lm_params"] = model.param_count()
    print(f"LM: {lm_cfg.name} at full width ({n_layers} layers, d "
          f"{lm_cfg.d_model}, {lm_cfg.n_heads} heads of {lm_cfg.hd}, d_ff "
          f"{lm_cfg.d_ff}, vocab {lm_cfg.vocab}): {result['lm_params']} "
          f"parameters, random from seed {LM_SEED}, on the card in "
          f"{result['lm_load_s']:.2f} s")
    phase_counts, phase_routes = {}, {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            phase_counts[name] = dict(smoke.build.LAUNCHES)
            phase_routes[name] = dict(smoke.build.ROUTE_LAUNCHES)

    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        res = serve_mod.serve(model, prompts, LM_GEN, on_phase=on_phase)
    for name, counts in phase_counts.items():
        for kname, n in counts.items():
            want = kname in ENGINE_KERNELS[f"lm_{name}"]
            check((n > 0) == want, f"LM {name}: {kname} launched {n} times")
    check(phase_counts["prefill"]["flash_attn_bhsd"] == n_layers,
          f"LM prefill: flash_attn_bhsd launched "
          f"{phase_counts['prefill']['flash_attn_bhsd']} times, not once "
          f"per layer ({n_layers})")
    check(phase_routes["prefill"]["flash_attn_bhsd:wgmma"] == n_layers,
          f"LM prefill: flash calls by route {phase_routes['prefill']}, not "
          f"all {n_layers} on the tensor cores")
    prefill_calls = cap.calls["flash_attn_bhsd"]
    bhsd = (LM_BATCH * lm_cfg.n_heads, LM_PROMPT, lm_cfg.hd)
    check(len(prefill_calls) == n_layers and all(
        a[0].shape == bhsd and a[0].dtype == torch.bfloat16
        and kw == {"causal": True} for a, kw, _ in prefill_calls),
        f"LM prefill: flash calls not {n_layers} causal bf16 {bhsd}")
    lm_err, lm_over, fault_over, fault_vmax = 0.0, 0.0, [], []
    for args, kw, (out,) in prefill_calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        err, over = flash_err(out, want, spread, "LM prefill flash call")
        lm_err, lm_over = max(lm_err, err), max(lm_over, over)
        # The planted fault must fail where the kernel passes.
        bad = faulty(*args)
        fault_over.append(flash_over(bad, want, spread))
        # What the earlier whole-call rule (2^-7 max|v|) would have said.
        fault_vmax.append(float((bad.float() - want.float()).abs().max()
                                / (FLASH_P_STEP
                                   * args[2].float().abs().max())))
        del want, spread, bad
    check(min(fault_over) > 1.0,
          f"LM prefill: a kernel that skips KV tile {FAULT_TILE} passes the "
          f"flash tolerance on a call ({min(fault_over):.3g}x)")
    launches["flash_attn_bhsd"] = phase_counts["prefill"]["flash_attn_bhsd"]
    main_calls["flash_attn_bhsd"] = prefill_calls[:1]
    del cap, prefill_calls
    gen_tok = res.tokens
    check(gen_tok.shape == (LM_BATCH, LM_GEN)
          and bool(((gen_tok >= 0) & (gen_tok < lm_cfg.vocab)).all())
          and torch.equal(gen_tok[:, 0], res.prefill_logits.argmax(-1).int())
          and bool(torch.isfinite(res.prefill_logits).all()),
          "LM: generated tokens out of range or not the prefill's argmax")
    print(f"main path LM prefill: {LM_BATCH} x {LM_PROMPT} tokens, launches "
          f"{ {k: v for k, v in phase_counts['prefill'].items() if v} } (one "
          f"per layer over B * H = {bhsd[0]} heads; by route "
          f"{ {k: v for k, v in phase_routes['prefill'].items() if v} }); "
          f"each call == twin "
          f"(max abs err {lm_err:.3g}, {lm_over:.3g}x the tolerance; the "
          f"kernel with KV tile {FAULT_TILE} skipped fails it on every call, "
          f"{min(fault_over):.3g}-{max(fault_over):.3g}x; against the earlier "
          f"2^-7 max|v| rule {min(fault_vmax):.3g}-{max(fault_vmax):.3g}x); "
          f"decode "
          f"{LM_GEN - 1} steps, launches "
          f"{ {k: v for k, v in phase_counts['decode'].items() if v} } (none "
          f"of the eight kernels)")
    # Teacher-forced: forward over prompt + generated tokens (its flash
    # calls held against the twin as they run), and decode fed the same
    # tokens; position S - 1 + i predicts generated token i.
    full = torch.cat([prompts, gen_tok], dim=1)
    run = serve_mod.run_config(LM_PROMPT)
    with smoke.capture(keep=[]) as cap, torch.no_grad():
        smoke.build.reset_launches()
        logits, _ = model.forward(run, {"tokens": full})
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
        routes = dict(smoke.build.ROUTE_LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["lm_forward"]
        check((n > 0) == want, f"LM forward: {kname} launched {n} times")
    check(counts["flash_attn_bhsd"] == n_layers
          and cap.checked["flash_attn_bhsd"]["calls"] == n_layers
          and routes["flash_attn_bhsd:wgmma"] == n_layers,
          f"LM forward: flash_attn_bhsd not once per layer on the tensor "
          f"cores ({routes})")
    fwd_err = cap.checked["flash_attn_bhsd"]["max_abs_err"]
    pred = logits[:, LM_PROMPT - 1:LM_PROMPT - 1 + LM_GEN].clone()
    del logits
    with torch.inference_mode():
        lg, cache = model.prefill(run, prompts, LM_PROMPT + LM_GEN)
        dec = [lg[:, -1]]
        for i in range(LM_GEN - 1):
            lg, cache = model.decode_step(run, gen_tok[:, i:i + 1], cache)
            dec.append(lg[:, -1])
    dec = torch.stack(dec, dim=1)
    del cache
    dec_diff = float((dec - pred).abs().max())
    check(bool(torch.isfinite(pred).all()) and dec_diff <= LOGIT_TOL,
          f"LM: decode logits differ from forward's by {dec_diff} > "
          f"{LOGIT_TOL}")
    top = pred.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    agree = top.indices[..., 0] == gen_tok.long()
    check(bool(agree[clear].all()), "LM: forward's argmax differs from a "
                                    "generated token where its margin is "
                                    "clear")
    result["lm_check"] = dict(
        prefill_flash_max_abs_err=lm_err, prefill_flash_over=lm_over,
        fault_over=fault_over, fault_over_vmax_rule=fault_vmax,
        forward_flash_max_abs_err=fwd_err, decode_vs_forward=dec_diff,
        skipped=int((~clear).sum()), agree_all=int(agree.sum()),
        distinct_tokens=int(torch.unique(gen_tok).numel()))
    print(f"main path LM teacher-forced: forward over {LM_BATCH} x "
          f"{full.shape[1]} tokens (flash once per layer, each == twin as it "
          f"ran, max abs err {fwd_err:.3g}); decode logits within "
          f"{dec_diff:.4g} of forward's (tol {LOGIT_TOL}); forward's argmax "
          f"== the generated token on all {int(clear.sum())} steps whose "
          f"top-2 margin > {LOGIT_TOL}, {result['lm_check']['skipped']} of "
          f"{clear.numel()} skipped ({int(agree.sum())} agree in all); "
          f"{result['lm_check']['distinct_tokens']} distinct tokens "
          f"generated")
    del pred, dec

    return model, prompts, gen_tok


def device_us(evt, names=("self_device_time_total",
                          "self_cuda_time_total")) -> float:
    """A profiler event's own device microseconds (the attribute's name
    differs across torch versions)."""
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_total(evt) -> float:
    """A profiler event's device microseconds, its children's included."""
    return device_us(evt, ("device_time_total", "cuda_time_total"))


def profile_busy(fn, top: int = 5, ops: bool = False, ranges=()) -> dict:
    """Run ``fn`` once under torch.profiler: host wall ms (synchronized),
    device ms summed over kernels, the busy share, launches and the
    ``top`` kernels by device time; with ``ops``, also the ``top``
    operators (aten ops and the like) by the device time of the kernels
    they launched themselves; with ``ranges`` ((module, attribute,
    label), ...), each of those functions wrapped in a
    ``record_function(label)`` range for the run, and ``ranges`` {label:
    (device ms of the kernels launched inside, calls)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = []
    for mod, attr, label in ranges:
        real = getattr(mod, attr)

        def wrap(*a, _real=real, _label=label, **kw):
            with record_function(_label):
                return _real(*a, **kw)
        saved.append((mod, attr, real))
        setattr(mod, attr, wrap)
    labels = {label for _, _, label in ranges}
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in labels), key=device_us, reverse=True)
    busy = sum(device_us(e) for e in kernels) / 1e3
    out = dict(wall_ms=wall, device_ms=busy, busy=busy / wall,
               launches=sum(e.count for e in kernels),
               top=[(e.key[:60], device_us(e) / 1e3, e.count)
                    for e in kernels[:top]])
    if ops:
        cpu = sorted((e for e in events if e.device_type == DeviceType.CPU
                      and device_us(e) > 0), key=device_us, reverse=True)
        out["ops"] = [(e.key[:60], device_us(e) / 1e3, e.count)
                      for e in cpu[:top]]
    if ranges:
        out["ranges"] = {e.key: (device_total(e) / 1e3, e.count)
                         for e in events if e.key in labels
                         and e.device_type == DeviceType.CPU}
    return out


def lm_timing(model, prompts, gen_tok, result, card) -> None:
    """Prefill and decode tok/s and peak device memory of one more
    ``serve`` run (no capture, no checks inside it); then one prefill and
    four decode steps under torch.profiler (device busy share, top
    kernels)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime.steps import make_serve_step
    res_t = serve_mod.serve(model, prompts, LM_GEN)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    result["lm"] = dict(
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
        prefill_s=res_t.prefill_s, decode_s=res_t.decode_s,
        prefill_tok_s=res_t.prefill_tok_s(),
        decode_tok_s=res_t.decode_tok_s(), weight_bytes=weights,
        peak_bytes=weights + res_t.peak_bytes,
        same_tokens=bool(torch.equal(res_t.tokens, gen_tok)))
    lm = result["lm"]
    print(f"LM serving ({card}): prefill {LM_BATCH} x {LM_PROMPT} in "
          f"{lm['prefill_s'] * 1e3:.1f} ms = {lm['prefill_tok_s']:.5g} tok/s; "
          f"{LM_GEN - 1} decode steps in {lm['decode_s'] * 1e3:.1f} ms = "
          f"{lm['decode_tok_s']:.5g} tok/s "
          f"({lm['decode_s'] / (LM_GEN - 1) * 1e3:.2f} ms a step); peak "
          f"device memory {lm['peak_bytes'] / 2**30:.2f} GiB (the weights "
          f"{weights / 2**30:.2f} GiB + the run's own peak); tokens equal "
          f"to the first run: {lm['same_tokens']}")
    run = serve_mod.run_config(LM_PROMPT)
    state = {}

    def prefill():
        state["out"] = model.prefill(run, prompts, LM_PROMPT + LM_GEN)

    step = make_serve_step(model, run)

    def decode():
        tok, cache = gen_tok[:, :1], state["out"][1]
        for _ in range(4):
            tok, cache = step(tok, cache)

    lm["profile"] = {"prefill": profile_busy(prefill),
                     "decode_4_steps": profile_busy(decode)}
    for name, p in lm["profile"].items():
        print(f"LM {name} under torch.profiler: wall {p['wall_ms']:.2f} ms, "
              f"device {p['device_ms']:.2f} ms (busy {p['busy']:.1%}), "
              f"{p['launches']} launches; top kernels "
              + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in p["top"]))


def flash_row(smoke, calls, launches: int, batch: int = LM_BATCH,
              path: str = "lm_prefill") -> dict:
    """The flash kernel's row, per call at a path's shape ([B * H, S, hd]
    bf16, causal or full: ``calls`` holds the path's first call of the
    kind, ``batch`` its B), beside its twin and PyTorch's fused attention
    on the same tensors viewed [B, H, S, hd] (timed only; the port never
    calls it)."""
    (q, k, v), kw, (out,) = calls[0]
    err = smoke.compare("flash_attn_bhsd", calls)
    fa_fn = smoke.flash.flash_attn_bhsd
    ms = cuda_ms(lambda: fa_fn(q, k, v, **kw), KERNEL_REPS)
    plain = cuda_ms(lambda: smoke.ref.flash_attn_bhsd(
        q, k, v, **kw, bk=smoke.flash.kv_tile(q.dtype, q.shape[2])),
        2)                                             # without the spread
    bh, s, d = q.shape
    q4, k4, v4 = (x.view(batch, bh // batch, s, d) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    causal = kw["causal"]
    lib_diff = float((sdpa(q4, k4, v4, is_causal=causal).float().reshape(
        out.shape) - out.float()).abs().max())
    library = cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=causal),
                      KERNEL_REPS)
    bound, bound_by, nbytes, n_ops = flash_bound(q, causal)
    route = smoke.flash.flash_route(q.dtype, q.shape[2])
    print(f"flash_attn_bhsd ({route} route): {ms:.4f} ms per call at "
          f"{list(q.shape)} bf16 {'causal' if causal else 'full'} (the "
          f"{path} path: {launches} calls, "
          f"{ms * launches:.2f} ms a pass; {n_ops / ms / 1e9:.4g} "
          f"TFLOP/s) vs plain twin {plain:.3f} ms, "
          f"scaled_dot_product_attention {library:.4f} ms (output within "
          f"{lib_diff:.3g} of the kernel's; kernel / library "
          f"{ms / library:.3g}x); bound {bound:.4f} ms by {bound_by} "
          f"({nbytes} B, {n_ops} ops); {bound / ms:.2%} of bound")
    return {"name": "flash_attn_bhsd", "route": "cuda",
            "source": KERNELS["flash_attn_bhsd"][0],
            "replaces": KERNELS["flash_attn_bhsd"][1], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
            "kernel_route": route}


def minicpm_path(smoke, result) -> None:
    """MiniCPM-2B's reduced config (head dim 72 / 6 = 12, which no flash
    kernel instance has) through ``launch.serve.serve`` on the card:
    MINICPM_BATCH prompts of MINICPM_PROMPT tokens and MINICPM_GEN greedy
    tokens.  The prefill must launch the flash kernel once per layer (its
    wrapper pads D to 16 and slices it back), each call held against the
    twin at the true D; decode launches none of the eight kernels."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as serve_mod
    cfg = get_reduced_config(MINICPM_ARCH)
    model = serve_mod.load_model(cfg, seed=LM_SEED, device="cuda")
    prompts = serve_mod.make_prompts(cfg, MINICPM_BATCH, MINICPM_PROMPT,
                                     LM_SEED, "cuda")
    counts = {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            counts[name] = dict(smoke.build.LAUNCHES)

    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        res = serve_mod.serve(model, prompts, MINICPM_GEN, on_phase=on_phase)
    torch.cuda.synchronize()
    for name in ("prefill", "decode"):
        for kname, n in counts[name].items():
            want = kname in ENGINE_KERNELS[f"lm_{name}"]
            check((n > 0) == want, f"{cfg.name} {name}: {kname} launched "
                                   f"{n} times")
    calls = cap.calls["flash_attn_bhsd"]
    hd = cfg.d_model // cfg.n_heads
    check(counts["prefill"]["flash_attn_bhsd"] == cfg.n_layers
          and len(calls) == cfg.n_layers
          and all(a[0].shape[2] == hd for a, _, _ in calls),
          f"{cfg.name} prefill: flash calls {len(calls)} / launches "
          f"{counts['prefill']['flash_attn_bhsd']}, not one per layer at "
          f"head dim {hd}")
    err = over = 0.0
    for args, kw, (out,) in calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        e, o = flash_err(out, want, spread, f"{cfg.name} prefill flash call")
        err, over = max(err, e), max(over, o)
    tok = res.tokens
    check(tok.shape == (MINICPM_BATCH, MINICPM_GEN)
          and bool(((tok >= 0) & (tok < cfg.vocab)).all())
          and bool(torch.isfinite(res.prefill_logits).all())
          and torch.equal(tok[:, 0], res.prefill_logits.argmax(-1).int()),
          f"{cfg.name}: generated tokens out of range or not the prefill's "
          f"argmax")
    result["minicpm"] = dict(
        head_dim=hd, padded_to=smoke.flash.padded_head_dim(hd),
        route=smoke.flash.flash_route(calls[0][0][0].dtype, hd),
        dtype=str(calls[0][0][0].dtype).split(".")[-1],
        prefill_flash_launches=counts["prefill"]["flash_attn_bhsd"],
        max_abs_err=err, over=over, prefill_tok_s=res.prefill_tok_s(),
        decode_tok_s=res.decode_tok_s())
    m = result["minicpm"]
    print(f"main path {cfg.name} (head dim {hd}, padded to "
          f"{m['padded_to']} on the {m['route']} route, {m['dtype']}): "
          f"{MINICPM_BATCH} x {MINICPM_PROMPT} prompt tokens and "
          f"{MINICPM_GEN} greedy tokens through launch.serve.serve; prefill "
          f"launches {m['prefill_flash_launches']} flash calls (one per "
          f"layer), each == twin at the true head dim (max abs err "
          f"{err:.3g}, {over:.3g}x the tolerance); decode launches none")


def flash_many_heads(smoke, result) -> None:
    """One ``flash_attn_bhsd`` call over MANY_HEADS = 65,537 heads (more
    than the kernels' grid y of 65,535): the wrapper launches it in two
    chunks on one stream.  The first and last heads (past 65,535) and a
    seeded sample are held against the twin."""
    fa = smoke.flash
    bh, s, d = MANY_HEADS
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = smoke.build.ROUTE_LAUNCHES["flash_attn_bhsd:wgmma"]
    out = fa.flash_attn_bhsd(q, k, v, causal=True)
    torch.cuda.synchronize()
    n_launch = smoke.build.ROUTE_LAUNCHES["flash_attn_bhsd:wgmma"] - before
    want_launch = -(-bh // fa.MAX_BH)
    check(n_launch == want_launch, f"flash over {bh} heads: {n_launch} "
                                   f"launches, not {want_launch}")
    heads = torch.cat([torch.arange(4, device="cuda"),
                       torch.arange(bh - 4, bh, device="cuda"),
                       torch.randperm(bh, generator=gen,
                                      device="cuda")[:MANY_HEADS_SAMPLE]])
    args = (q[heads], k[heads], v[heads])
    want, spread = smoke.twin("flash_attn_bhsd", args, {"causal": True})
    err, over = flash_err(out[heads], want, spread,
                          f"flash over {bh} heads")
    ms = cuda_ms(lambda: fa.flash_attn_bhsd(q, k, v, causal=True), 2)
    result["flash_many_heads"] = dict(
        shape=[bh, s, d], launches=n_launch, heads_checked=heads.numel(),
        max_abs_err=err, over=over, ms=ms)
    print(f"kernel phase: flash_attn_bhsd over [{bh}, {s}, {d}] bf16 "
          f"causal ({q.numel() * 2 / 2**30:.2f} GiB a tensor): {n_launch} "
          f"launches of at most {fa.MAX_BH} heads; heads 0-3, "
          f"{bh - 4}-{bh - 1} and {MANY_HEADS_SAMPLE} seeded ones == twin "
          f"(max abs err {err:.3g}, {over:.3g}x the tolerance); {ms:.3f} ms "
          f"a call")
    del q, k, v, out, args, want, spread
    torch.cuda.empty_cache()


def misaligned_phase(engines, pts) -> None:
    """Each engine's ``assign`` on ``flat[1:].view(-1, 2)``: contiguous
    points whose data starts 4 bytes past a float2 boundary.  Ids and
    stats must equal those of the aligned copy."""
    flat = torch.empty(2 * pts.shape[0] + 1, device="cuda")
    flat[1:] = pts.reshape(-1)
    view = flat[1:].view(-1, 2)
    check(view.is_contiguous() and view.data_ptr() % 8 != 0,
          "the misaligned view is aligned")
    for name, eng in engines.items():
        got, want = eng.assign(view), eng.assign(view.clone())
        for f in ("state", "county", "block"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"{name}: {f} ids on misaligned points differ")
        check(got.stats.as_dict() == want.stats.as_dict(),
              f"{name}: stats on misaligned points differ")
    print(f"kernel phase: every engine's assign on flat[1:].view(-1, 2) of "
          f"{pts.shape[0]} points (data_ptr % 8 == {view.data_ptr() % 8}) == "
          f"on the aligned copy (ids, stats)")


def pool_phase(smoke, ops, sindex, findex, pts, truth_block,
               truth_state) -> list:
    """``crossings_candidates`` against its twin on pools the main path
    does not build: the state tables packed at BE = 64 (polygons of
    92-142 live edges over 2-3 blocks), the block table with one polygon
    emptied (0 live edges), and the block pool rebuilt through
    ``EdgePool.from_numpy`` from its host arrays (live counts derived
    from the blocks, equal to the packed ones).  Rows: each point's true
    polygon, a random one, -1 and an id past the table, unsorted and
    sorted; every count bit-equal to the twin and a second launch
    bit-equal to the first."""
    gp = smoke.modules["crossings_candidates"]
    block_edges = findex.block_edges.cpu().numpy()
    emptied = block_edges.copy()
    emptied[EMPTY_POLY] = 0.0
    base = ops.build_edge_pool(block_edges, device="cuda")
    derived = ops.EdgePool.from_numpy(*(getattr(base, f).cpu().numpy()
                                        for f in ("blocks", "first",
                                                  "count")), device="cuda")
    check(torch.equal(derived.live, base.live),
          "EdgePool.from_numpy: derived live counts differ from the packed")
    state = ops.build_edge_pool(sindex.state_edges.cpu().numpy(), be=64,
                                device="cuda")
    check(int(state.count.min()) >= 2, "state pool at BE 64: a polygon in "
                                       "one block")
    empty = ops.build_edge_pool(emptied, device="cuda")
    check(int(empty.live[EMPTY_POLY]) == 0
          and int(empty.count[EMPTY_POLY]) == 0, "emptied polygon has edges")
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for name, pool, truth in (("state_be64", state, truth_state),
                              ("empty_polygon", empty, truth_block),
                              ("from_numpy", derived, truth_block)):
        n, p = pts.shape[0], pool.n_poly
        pick = torch.randint(0, 4, (n,), generator=gen, device="cuda")
        rand = torch.randint(0, p, (n,), generator=gen, device="cuda")
        pid = torch.where(pick == 0, rand, truth.long())
        pid = torch.where(pick == 1, -1, pid)
        pid = torch.where((pick == 2) & (rand % 8 == 0), p, pid)
        if name == "empty_polygon":
            pid = torch.where(rand % 16 == 0, EMPTY_POLY, pid)
        pid = pid.int()
        for order in ("unsorted", "sorted"):
            rows = pid if order == "unsorted" else torch.sort(pid)[0]
            args = (rows, pts, pool.first, pool.count, pool.live,
                    pool.blocks)
            kw = {"max_blocks": pool.max_blocks}
            got = gp.crossings_candidates(*args, **kw)
            again = gp.crossings_candidates(*args, **kw)
            want = smoke.twin("crossings_candidates", args, kw)[0]
            check(torch.equal(got, again), f"crossings_candidates {name}: "
                                           f"a second launch differs")
            err = max_abs_err(got, want, f"crossings_candidates {name}")
            check(err == 0, f"crossings_candidates differs from its twin "
                            f"on the {name} pool ({order}; max abs err "
                            f"{err})")
            out.append(dict(pool=name, order=order, rows=n,
                            blocks_per_poly=[int(pool.count.min()),
                                             int(pool.count.max())],
                            live=[int(pool.live.min()),
                                  int(pool.live.max())],
                            inside=int((got & 1).sum()), max_abs_err=err))
    print("kernel phase: crossings_candidates == twin (and a second launch "
          "== the first) on " + "; ".join(
              f"{r['pool']} ({r['order']}: blocks a polygon "
              f"{r['blocks_per_poly']}, live edges {r['live']}, "
              f"{r['inside']} of {r['rows']} rows inside)" for r in out))
    return out


def one_phase(smoke, sindex, pts, extent) -> list:
    """``crossings_one`` against its twin on tables the main path does
    not pass: E = 0, E = 1, E = 284 (two state tables, no multiple of
    the 256-edge tile, their y1 == y2 padding rows among them), and a
    state table, each over ONE_ROWS points (no multiple of the 4-point
    thread or the 1,024-point block) with NaN, infinite, FAR and
    off-extent ones mixed in; bit-equal, and a second launch bit-equal
    to the first."""
    fn = smoke.modules["crossings_one"].crossings_one
    x0, x1, y0, y1 = extent
    odd = torch.tensor([[x0 - 1.0, y0], [x1 + 1.0, y1], [1e30, 1e30],
                        [-1e30, -1e30], [math.inf, y0], [x0, -math.inf],
                        [math.nan, y0], [x0, math.nan]], device="cuda")
    rows = torch.cat([pts, odd])[:ONE_ROWS]
    rows[::97] = odd[torch.arange(rows[::97].shape[0], device="cuda")
                     % odd.shape[0]]
    se = sindex.state_edges
    tables = {"E=0": se[0, :0], "E=1": se[0, :1],
              "E=284": torch.cat([se[0], se[1]])[:284],
              "state 0": se[0]}
    out = []
    for name, edges in tables.items():
        edges = edges.contiguous()
        got, again = fn(rows, edges), fn(rows, edges)
        want = smoke.ref.crossings_one(rows, edges)
        check(torch.equal(got, again), f"crossings_one {name}: a second "
                                       f"launch differs")
        err = max_abs_err(got, want, f"crossings_one {name}")
        check(err == 0, f"crossings_one differs from its twin at {name} "
                        f"(max abs err {err})")
        out.append(dict(table=name, edges=edges.shape[0],
                        staged=live_edges(edges), rows=rows.shape[0],
                        max_abs_err=err))
    print(f"kernel phase: crossings_one == twin (and a second launch == "
          f"the first) on {rows.shape[0]} points with NaN / inf / FAR / "
          f"off-extent ones against " + ", ".join(
              f"{r['table']} ({r['staged']} of {r['edges']} edges staged)"
              for r in out))
    return out


def candidate_rows(calls) -> list:
    """Per ``crossings_candidates`` call: its rows, the rows that carry a
    candidate, and the rows at the call's most repeated point: the
    compaction's unfilled slots, which all alias one row
    (core/compact.py), times the candidate slots a point brings."""
    out = []
    for args, _, _ in calls:
        pids, points = args[0], args[1]
        _, reps = torch.unique(points.view(torch.int64), return_counts=True)
        out.append(dict(rows=pids.shape[0],
                        with_candidate=int((pids >= 0).sum()),
                        alias_rows=int(reps.max()) if reps.numel() else 0))
    return out


def launched_only(smoke, path: str, kernels) -> dict:
    """The launch counts since the last reset; fails unless each of
    ``kernels`` launched and no other kernel did."""
    counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        check((n > 0) == (kname in kernels),
              f"{path}: {kname} launched {n} times (expected "
              f"{'> 0' if kname in kernels else '0'})")
    return {k: v for k, v in counts.items() if v}


def same_ids(res, want, what: str) -> None:
    """Served (numpy) or assigned (tensor) ids equal ``want``'s tensors."""
    for field, w in zip(("state", "county", "block"), want):
        got = getattr(res, field)
        got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
        check(np.array_equal(got, w.cpu().numpy()),
              f"{what}: {field} ids differ")


def cold_start_phase(smoke, engines, census, cov, cfg, xy, pts, result):
    """Phase 8a: record the measured winner among the three fast paths in
    a GeoIndexSet, save it, cold-start a GeoServer from it on cuda
    (``strategy="auto"``), and serve 2^20 of the main path's points; then
    a copy whose tuning names another device kind replans to ``fast``.
    On cuda either plan runs the one-pass kernel: the record's
    ``fast_onepass``, or the planner's CUDA rule for exact ``fast``."""
    import shutil
    from repro_torch.core.artifact import GeoIndexSet, MANIFEST_NAME
    from repro_torch.serving import GeoServer, ServeConfig
    rates = {n: result["pts_per_s"][n]
             for n in ("fast", "fast_fused", "fast_onepass")}
    winner = max(rates, key=rates.get)
    want_strategy = "fast_onepass" if winner == "fast_onepass" else "fast"
    onepass = engines["fast_onepass"]
    be = onepass.fast_index.edge_pool.be
    iset = GeoIndexSet(census=census, covering=cov, max_level=MAX_LEVEL,
                       gbits=cfg.gbits, max_cand=cfg.max_cand)
    iset.record_tuning({"winner": winner, "be": int(be),
                        "device_kind": "cuda",
                        "pts_per_sec": float(rates[winner])})
    out = {"winner": winner, "rates": rates, "be": int(be)}
    with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
        path = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        iset.save(path)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = {f: os.path.getsize(os.path.join(path, f))
                        for f in sorted(os.listdir(path))}
        serve_cfg = ServeConfig(buckets=SERVE_BUCKETS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = GeoServer.from_artifact(path, strategy="auto",
                                       cfg=serve_cfg, engine_cfg=cfg)
        t1 = time.perf_counter()
        engine = cold.regions[0].engine
        smoke.build.reset_launches()
        first = engine.assign(pts[:N_COLD])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        served = cold.submit(xy[:N_COLD])
        torch.cuda.synchronize()
        out["launches"] = launched_only(smoke, "cold start",
                                        ENGINE_KERNELS["fast_onepass"])
        out.update(from_artifact_s=t1 - t0, first_assign_s=t2 - t1,
                   cold_start_s=t2 - t0, plan=engine.explain())
        check(engine.device.type == "cuda", "cold-start index not on cuda")
        check(out["plan"]["strategy"] == want_strategy,
              f"cold start planned {out['plan']['strategy']}, the recorded "
              f"winner is {winner}")
        check(out["plan"]["fused"] == "onepass",
              f"cold start planned fused={out['plan']['fused']} on cuda")
        warm = onepass.assign(pts[:N_COLD])
        warm_ids = (warm.state, warm.county, warm.block)
        same_ids(first, warm_ids, "cold-start assign vs the warm engine")
        same_ids(served, warm_ids, "cold-start server vs the warm engine")
        check(engine.indices.memory_footprint()
              == onepass.indices.memory_footprint(),
              "cold-start footprint differs from the warm engine's")
        # Another device kind's record must not steer the plan on cuda.
        other = os.path.join(tmp, "artifact_tpu")
        shutil.copytree(path, other)
        mpath = os.path.join(other, MANIFEST_NAME)
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["tuning"]["device_kind"] = "tpu"
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        foreign = GeoServer.from_artifact(other, strategy="auto",
                                          cfg=serve_cfg, engine_cfg=cfg)
        plan = foreign.regions[0].engine.explain()
        check(plan["strategy"] == "fast" and plan["fused"] == "onepass",
              f"a tpu tuning record replanned to {plan['strategy']} "
              f"fused={plan['fused']} on cuda, not fast on the one-pass "
              f"kernel")
        smoke.build.reset_launches()
        served = foreign.submit(xy[:N_KERNEL])
        torch.cuda.synchronize()
        out["foreign_launches"] = launched_only(
            smoke, "cold start with a tpu record",
            ENGINE_KERNELS["fast_onepass"])
        same_ids(served, [t[:N_KERNEL] for t in warm_ids],
                 "tpu-record cold start vs the warm engine")
    result["cold_start"] = out
    print(f"cold start: winner {winner} (pts/s "
          f"{ {k: f'{v:.4g}' for k, v in rates.items()} }), be {be}; saved "
          f"in {out['save_s']:.3f} s, {sum(out['bytes'].values())} bytes on "
          f"disk {out['bytes']}; from_artifact (load + ensure + server) "
          f"{out['from_artifact_s']:.3f} s + first assign of {N_COLD} points "
          f"{out['first_assign_s']:.3f} s = {out['cold_start_s']:.3f} s, "
          f"against the covering BFS's {result['covering_s']:.2f} s; plan "
          f"{out['plan']['strategy']} fused={out['plan']['fused']}, "
          f"launches {out['launches']}; served ids == the warm engine's on "
          f"{N_COLD} points; a tpu tuning record plans {plan['strategy']} "
          f"(launches {out['foreign_launches']}), ids equal")


def async_phase(smoke, engine, make_server, replay, stream, now, served,
                snap, want_ids, reqs, result):
    """Phase 8b: AsyncGeoServer over ``fast`` with phase 6's ServeConfig
    (analytics mounted): phase 6's stream from one client in order (ids
    and analytics snapshot equal to the sync server's), then the 256
    requests of 16,384 points from 8 client threads (every future
    resolves with a direct assign's ids, no failed flush)."""
    import threading
    from repro_torch.serving import AsyncGeoServer, FrontendConfig
    frontend = FrontendConfig(n_submitters=ASYNC_SUBMITTERS,
                              n_replicas=ASYNC_REPLICAS)
    out = {"submitters": ASYNC_SUBMITTERS, "replicas": ASYNC_REPLICAS}
    with make_server(engine, True, cls=AsyncGeoServer,
                     frontend=frontend) as srv:
        srv.warm()
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        got = replay(srv)
        torch.cuda.synchronize()
        out["stream_launches"] = launched_only(smoke, "async stream",
                                               ENGINE_KERNELS["serving"])
        for a, b in zip(got, served):
            check(all(np.array_equal(getattr(a, f), getattr(b, f))
                      for f in ("state", "county", "block", "region")),
                  "async served ids differ from the sync server's")
        check(srv.snapshot_analytics() == snap,
              "async analytics snapshot differs from the sync server's")
    with make_server(engine, True, cls=AsyncGeoServer,
                     frontend=frontend) as srv:
        srv.warm()
        now[0] = 100.0
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        futures = [None] * len(reqs)

        def client(c):
            for i in range(c, len(reqs), ASYNC_CLIENTS):
                futures[i] = srv.submit_async(reqs[i])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(ASYNC_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        out["load_launches"] = launched_only(smoke, "async load",
                                             ENGINE_KERNELS["serving"])
        counters = srv.metrics.snapshot()["counters"]
        lat = srv.metrics.latency.snapshot_ms()
        stages = srv.metrics.snapshot()["stages"]
    for field in ("failed_flushes", "failed_requests", "shed_requests"):
        check(counters.get(field, 0) == 0, f"async load: {field} "
                                           f"{counters.get(field, 0)}")
    n = len(reqs) * LOAD_POINTS
    for field, w in zip(("state", "county", "block"), want_ids):
        got = np.concatenate([getattr(r, field) for r in results])
        check(np.array_equal(got, w[:n].cpu().numpy()),
              f"async load: {field} ids differ from a direct assign")
    sync = result["serve_load"]
    out.update(clients=ASYNC_CLIENTS, requests=len(reqs),
               points_per_request=LOAD_POINTS, seconds=load_s,
               pts_per_s=n / load_s, latency_ms=lat,
               stage_p50_ms={k: v["p50"] for k, v in stages.items()},
               batches=counters.get("batches", 0))
    result["async_serving"] = out
    print(f"async serving: phase 6's stream from one client == the sync "
          f"server (ids, analytics snapshot), launches "
          f"{out['stream_launches']}; {len(reqs)} requests x {LOAD_POINTS} "
          f"points from {ASYNC_CLIENTS} client threads ({ASYNC_SUBMITTERS} "
          f"submitters, {ASYNC_REPLICAS} replicas) in {load_s:.3f} s = "
          f"{out['pts_per_s']:.4g} pts/s (sync: {sync['pts_per_s']:.4g}); "
          f"request latency p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms "
          f"(sync: {sync['latency_ms']['p50']:.3f} / "
          f"{sync['latency_ms']['p99']:.3f} ms); stage p50 ms "
          f"{ {k: round(v, 3) for k, v in out['stage_p50_ms'].items()} }; "
          f"every future == a direct assign, no failed flush; launches "
          f"{out['load_launches']}")


def pipeline_phase(smoke, engine, cpu_engine, pts, want_ids, result):
    """Phase 8c: ``enrich`` of the main path's points through the fast
    index (ids equal the engine's), then the GeoEnriched source of
    Qwen1.5-0.5B's full config: geo blocks equal a direct assign of the
    sampled points, tokens equal a CPU source's."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.enrich import enrich
    from repro_torch.data import make_source
    out = {}
    index, fcfg = engine.fast_index, engine.cfg.fast_cfg()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    feats = enrich(index, pts, fcfg)
    torch.cuda.synchronize()
    out["enrich_s"] = time.perf_counter() - t0
    out["enrich_launches"] = launched_only(smoke, "enrich",
                                           ENGINE_KERNELS["fast"])
    for key, w in zip(("state", "county", "block"), want_ids):
        check(torch.equal(feats[key], w), f"enrich {key} ids differ from "
                                          f"the fast engine's")
    bid = want_ids[2]
    check(torch.equal(feats["feature_token"],
                      torch.where(bid >= 0, bid % 1024, 1024).int()),
          "enrich feature tokens")
    out["enrich_pts_per_s"] = N_MAIN / out["enrich_s"]
    lm_cfg = get_config(LM_ARCH)
    shape = ShapeConfig("geo_smoke", PIPE_SEQ, PIPE_BATCH, "train")
    src = make_source(lm_cfg, shape, geo=engine)
    cpu_src = make_source(lm_cfg, shape, geo=cpu_engine, device="cpu")
    check(engine.cfg.mode == "exact", "the pipeline's engine is not exact")
    src.batch_at(0)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    batches = [src.batch_at(step) for step in range(PIPE_STEPS)]
    torch.cuda.synchronize()
    out["batch_ms"] = (time.perf_counter() - t0) * 1e3 / PIPE_STEPS
    out["pipeline_launches"] = launched_only(smoke, "GeoEnriched",
                                             ENGINE_KERNELS["fast"])
    on_map, ulps = 0, 0
    for step, b in enumerate(batches):
        check(b["tokens"].shape == (PIPE_BATCH, PIPE_SEQ)
              and b["tokens"].device.type == "cuda", "pipeline batch shape")
        xy_s = src.sample_points(step, PIPE_BATCH)
        check(torch.equal(b["geo_block"], engine.assign(xy_s).block),
              f"step {step}: geo_block differs from a direct assign")
        cb = cpu_src.batch_at(step)
        for key in ("tokens", "labels", "geo_block"):
            check(torch.equal(b[key].cpu(), cb[key]),
                  f"step {step}: {key} differs from the CPU source's")
        cxy = cpu_src.sample_points(step, PIPE_BATCH)
        ulps = max(ulps, int((xy_s.cpu().view(torch.int32)
                              - cxy.view(torch.int32)).abs().max()))
        on_map += int((b["geo_block"] >= 0).sum())
    check(on_map * 2 > PIPE_STEPS * PIPE_BATCH,
          f"only {on_map} of {PIPE_STEPS * PIPE_BATCH} pipeline points on "
          f"the map")
    out.update(on_map=on_map, points=PIPE_STEPS * PIPE_BATCH,
               point_ulps_vs_cpu=ulps)
    result["pipeline"] = out
    print(f"enrich: {N_MAIN} points in {out['enrich_s'] * 1e3:.2f} ms "
          f"({out['enrich_pts_per_s']:.4g} pts/s), ids == the fast engine's, "
          f"launches {out['enrich_launches']}; GeoEnriched({LM_ARCH} full "
          f"config, {PIPE_BATCH} x {PIPE_SEQ}): batch_at(0..{PIPE_STEPS - 1}) "
          f"{out['batch_ms']:.3f} ms a batch, geo_block == a direct assign, "
          f"tokens == the CPU source's (points {ulps} ulps apart), {on_map} "
          f"of {PIPE_STEPS * PIPE_BATCH} on the map, launches "
          f"{out['pipeline_launches']}")


def trainable_flash_check(smoke) -> dict:
    """Phase 9a: ``make_flash_attn_trainable`` at TRAIN_FLASH_SHAPE bf16 on
    the card: its output equals ``flash_attn``'s (the kernel, no grad) bit
    for bit, its gradients equal ``torch.autograd.grad`` through
    ``blockwise_attn`` (the program its backward runs) bit for bit, and
    its forward launched the tensor-core kernel once."""
    from repro_torch.models.attention import blockwise_attn
    b, s, h, d = TRAIN_FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f = smoke.flash.make_flash_attn_trainable(causal=True)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    out = f(q, k, v)
    torch.cuda.synchronize()
    launches = dict(smoke.build.ROUTE_LAUNCHES)
    check(launches["flash_attn_bhsd:wgmma"] == 1
          and smoke.build.LAUNCHES["flash_attn_bhsd"] == 1,
          f"trainable flash: launches {launches}, not one wgmma call")
    grads = torch.autograd.grad(out, (q, k, v), g)
    with torch.no_grad():
        want = smoke.flash.flash_attn(q, k, v, causal=True)
    check(torch.equal(out.detach(), want), "trainable flash: output differs "
                                           "from flash_attn's")
    c = min(1024, s)
    ref = blockwise_attn(q, k, v, causal=True, chunk_q=c, chunk_kv=c)
    want_g = torch.autograd.grad(ref, (q, k, v), g)
    for name, a, w in zip("qkv", grads, want_g):
        check(torch.equal(a, w), f"trainable flash: d{name} differs from "
                                 f"autograd through blockwise_attn "
                                 f"(max abs err {max_abs_err(a, w, name)})")
    print(f"phase 9: make_flash_attn_trainable at {list(TRAIN_FLASH_SHAPE)} "
          f"bf16: output == flash_attn (the wgmma kernel, launched once: "
          f"{ {k: n for k, n in launches.items() if n} }), dq / dk / dv == "
          f"autograd through blockwise_attn (chunk {c}) bit for bit")
    return {"shape": list(TRAIN_FLASH_SHAPE), "launches": launches}


def twin_flash(smoke):
    """``flash_attn_bhsd`` replaced by its plain twin (at the route's KV
    tile) inside the block: the plain path of the training step."""
    ref, flash = smoke.ref, smoke.flash
    saved = flash.flash_attn_bhsd

    def twin(q, k, v, *, causal=True):
        return ref.flash_attn_bhsd(q, k, v, causal=causal,
                                   bk=flash.kv_tile(q.dtype, q.shape[2]))

    @contextlib.contextmanager
    def ctx():
        flash.flash_attn_bhsd = twin
        try:
            yield
        finally:
            flash.flash_attn_bhsd = saved
    return ctx()


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def state_of(params, opt) -> dict:
    return {**{f"params/{k}": p for k, p in params.items()},
            **{f"m/{k}": t for k, t in opt.m.items()},
            **{f"v/{k}": t for k, t in opt.v.items()}, "step": opt.step}


def checkpoint_round_trip(params, opt, root, result) -> None:
    """Phase 9d: one save and one restore of the full-width state (params,
    m, v: f32; the step), timed; every restored tensor equal to the saved
    one after the live tensors were moved (+1)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    free = shutil.disk_usage(root).free
    state_bytes = sum(t.numel() * t.element_size()
                      for t in state_of(params, opt).values())
    print(f"phase 9: checkpoint at full width: {state_bytes / 1e9:.3f} GB of "
          f"state; {free / 1e9:.1f} GB free on the disk under {root}")
    path = os.path.join(root, "ckpt")
    shutil.rmtree(path, ignore_errors=True)
    mgr = CheckpointManager(path, keep=1, async_save=False)
    before = {k: t.detach().clone() for k, t in state_of(params, opt).items()}
    step = int(opt.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(step, {"params": params, "opt": opt})
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(path)
    with torch.no_grad():
        for t in state_of(params, opt).values():
            t.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore(step, {"params": params, "opt": opt})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for k, t in state_of(params, opt).items():
        check(torch.equal(t, before[k]), f"checkpoint: {k} restored unequal")
    keys = len(mgr.meta(step)["keys"])
    shutil.rmtree(path)
    result["checkpoint"] = dict(state_bytes=state_bytes, disk_bytes=nbytes,
                                free_bytes=free, save_s=save_s,
                                restore_s=restore_s, keys=keys)
    print(f"phase 9: checkpoint save {save_s:.2f} s ({nbytes} B on disk, "
          f"{keys} keys, {nbytes / save_s / 1e9:.3g} GB/s), restore "
          f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.3g} GB/s); every "
          f"restored tensor == the saved one")


def restart_check(smoke, root, result) -> None:
    """Phase 9e: ``train_loop`` at the reduced config, TRAIN_BATCH x
    TRAIN_SEQ tokens (vocab 512: tokens repeat, so the embedding's
    backward sums duplicates), RESTART_STEPS steps, a checkpoint every
    RESTART_EVERY; with a failure injected at RESTART_FAIL its final
    parameters and optimizer state equal a run without it, bit for
    bit."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.driver import DriverConfig, train_loop
    from repro_torch.runtime.steps import make_train_step
    cfg = get_reduced_config(LM_ARCH)
    run = train_mod.run_config(LM_ARCH, RESTART_STEPS, TRAIN_SEQ,
                               remat="full")
    src = SyntheticLM(cfg=cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      seed=TRAIN_SEED, device="cuda")
    runs = []
    for name, fail in (("clean", None), ("fault", {RESTART_FAIL})):
        model, params, opt = train_mod.setup(cfg, seed=TRAIN_SEED,
                                             device="cuda")
        dcfg = DriverConfig(total_steps=RESTART_STEPS,
                            ckpt_every=RESTART_EVERY,
                            ckpt_dir=os.path.join(root, f"restart_{name}"),
                            keep=2, log_every=RESTART_STEPS)
        smoke.build.reset_launches()
        t0 = time.perf_counter()
        params, opt, hist = train_loop(make_train_step(model, run), params,
                                       opt, src, dcfg, fail_at=fail,
                                       log=lambda *_: None)
        runs.append((params, opt, hist, time.perf_counter() - t0,
                     dict(smoke.build.ROUTE_LAUNCHES)))
    (p1, o1, h1, s1, l1), (p2, o2, h2, s2, l2) = runs
    check(h1["restarts"] == 0 and h2["restarts"] == 1
          and h2["steps_run"] == RESTART_STEPS + RESTART_FAIL - RESTART_EVERY,
          f"restart: histories {h1} / {h2}")
    check(int(o1.step) == int(o2.step) == RESTART_STEPS, "restart: steps")
    diff = [k for k in p1 if not (torch.equal(p1[k], p2[k])
                                  and torch.equal(o1.m[k], o2.m[k])
                                  and torch.equal(o1.v[k], o2.v[k]))]
    check(not diff, f"restart: {len(diff)} tensors differ from the clean "
                    f"run's, first {diff[:3]}")
    check(l1["flash_attn_bhsd:simt"] > 0, f"restart: flash launches {l1}")
    result["restart"] = dict(steps=RESTART_STEPS, clean_s=s1, fault_s=s2,
                             loss=h1["loss"], launches=l1)
    print(f"phase 9: restart at the reduced config ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, vocab {cfg.vocab}): failure at step {RESTART_FAIL}, "
          f"restored from step {RESTART_EVERY}; {len(p1)} params and their "
          f"m, v == the clean run's bit for bit (clean {s1:.2f} s, with the "
          f"restart {s2:.2f} s; flash {l1['flash_attn_bhsd:simt']} launches "
          f"on the CUDA-core route); loss {h1['loss'][0]:.4f} -> "
          f"{h1['loss'][-1]:.4f}")
    shutil.rmtree(os.path.join(root, "restart_clean"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "restart_fault"), ignore_errors=True)


def train_phase(smoke, engine, result) -> dict:
    """Phase 9: training on the card (see the module doc).  Returns the
    flash kernel's launches on the training path, for the kernels line."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import make_source
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import DriverConfig, train_loop
    out = result["train"] = {
        "trainable_flash": trainable_flash_check(smoke)}
    cfg = get_config(LM_ARCH)
    n_flash = 2 * cfg.n_layers      # forward + the remat="full" recompute
    root = str(smoke.build.BUILD_ROOT.parent / "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, params, opt = train_mod.setup(cfg, seed=TRAIN_SEED, device="cuda")
    run = train_mod.run_config(LM_ARCH, TRAIN_STEPS, TRAIN_SEQ, remat="full")
    src = make_source(cfg, ShapeConfig("train_smoke", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), seed=TRAIN_SEED, geo=engine,
                      device="cuda")
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    # The step train_loop calls, timed and counted: every counter set to 0
    # just before a step and read just after it (the batch's geo join runs
    # before, in batch_at); the warm-up step's flash calls each held
    # against the twin as they run.
    inner = steps.make_train_step(model, run)
    rec = []

    def step(params, opt, batch):
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        t0 = time.perf_counter()
        with (smoke.capture(keep=[]) if not rec
              else contextlib.nullcontext()) as cap:
            params, opt, metrics = inner(params, opt, batch)
            loss = float(metrics["loss"])
        rec.append(dict(
            s=time.perf_counter() - t0, loss=loss, ce=float(metrics["ce"]),
            grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
            launches=dict(smoke.build.LAUNCHES),
            routes=dict(smoke.build.ROUTE_LAUNCHES),
            checked=cap and dict(cap.checked["flash_attn_bhsd"])))
        return params, opt, metrics

    dcfg = DriverConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                        ckpt_dir=os.path.join(root, "loop"), keep=1,
                        log_every=1)
    t0 = time.perf_counter()
    params, opt, hist = train_loop(step, params, opt, src, dcfg)
    out["loop_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    shutil.rmtree(os.path.join(root, "loop"))
    for i, r in enumerate(rec):
        for kname, n in r["launches"].items():
            check((n > 0) == (kname in ENGINE_KERNELS["train_step"]),
                  f"train step {i}: {kname} launched {n} times")
        check(r["launches"]["flash_attn_bhsd"] == n_flash
              and r["routes"]["flash_attn_bhsd:wgmma"] == n_flash,
              f"train step {i}: flash launches {r['routes']}, not {n_flash} "
              f"on the tensor cores")
        check(all(math.isfinite(r[k]) for k in ("loss", "grad_norm")),
              f"train step {i}: loss {r['loss']}, grad norm "
              f"{r['grad_norm']}")
    checked = rec[0]["checked"]
    check(checked["calls"] == n_flash, f"train warm-up: {checked['calls']} "
                                       f"flash calls held against the twin")
    lnv = math.log(cfg.vocab)
    check(abs(rec[0]["ce"] - lnv) < TRAIN_CE0_TOL,
          f"train: first ce {rec[0]['ce']} not near ln(V) = {lnv:.4f}")
    check(hist["loss"] == [r["loss"] for r in rec]
          and hist["loss"][-1] < hist["loss"][0] and hist["restarts"] == 0,
          f"train: losses {hist['loss']} do not fall")
    timed = [r["s"] for r in rec[1:]]
    step_s = float(np.median(timed))
    out.update(steps=rec, step_s=step_s, step_s_all=timed,
               tok_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               flash_per_step=n_flash, params=model.param_count())
    print(f"phase 9: {cfg.name} at full width ({out['params']} params, f32 "
          f"master weights, remat full, z-loss {run.z_loss}) through "
          f"train_loop over make_train_step, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"GeoEnriched tokens ({card_line()}): losses "
          f"{[round(x, 4) for x in hist['loss']]} (ln V = {lnv:.4f}), grad "
          f"norms {[round(r['grad_norm'], 4) for r in rec]}, lr "
          f"{[r['lr'] for r in rec]}; each step launched "
          f"flash_attn_bhsd {n_flash} times, all on wgmma, and nothing else "
          f"of the eight; the warm-up's {checked['calls']} calls each == twin "
          f"(max abs err {checked['max_abs_err']:.3g}); step "
          f"{step_s * 1e3:.1f} ms (median of {timed}), "
          f"{out['tok_s']:.5g} tok/s; peak device memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB; train_loop with its two "
          f"checkpoints {out['loop_s']:.1f} s")
    batch = src.batch_at(TRAIN_STEPS)
    # Forward / backward (with the remat recompute) / optimizer on the
    # card, by CUDA events around the step's own pieces.
    loss_fn = steps.make_loss_fn(model, run)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = loss_fn(batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, list(params.values()))
    ev[2].record()
    adamw.update(dict(zip(params, grads)), opt, params, run,
                 adamw.schedule(run, opt.step))
    ev[3].record()
    torch.cuda.synchronize()
    out["split_ms"] = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in
                       enumerate(("forward", "backward", "optimizer"))}
    del loss, grads
    out["profile"] = profile_busy(
        lambda: float(inner(params, opt, batch)[2]["loss"]), top=10,
        ops=True)
    p = out["profile"]
    print(f"phase 9: a step on the card: forward "
          f"{out['split_ms']['forward']:.1f} ms, backward (with the "
          f"recompute) {out['split_ms']['backward']:.1f} ms, optimizer "
          f"{out['split_ms']['optimizer']:.1f} ms; under torch.profiler: "
          f"wall {p['wall_ms']:.1f} ms, device {p['device_ms']:.1f} ms (busy "
          f"{p['busy']:.1%}), {p['launches']} launches; top kernels "
          + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in p["top"])
          + "; top operators " + "; ".join(f"{k} {ms:.1f} ms x{n}"
                                           for k, ms, n in p["ops"]))
    # The plain path: the same parameters and batch, flash's twin in the
    # kernel's place.
    grad_fn = steps.make_grad_fn(model, run)
    cmp = {}
    for name in ("kernel", "plain"):
        with (twin_flash(smoke) if name == "plain"
              else contextlib.nullcontext()):
            smoke.build.reset_launches()
            g, m = grad_fn(params, batch)
            cmp[name] = dict(loss=float(m["loss"]), ce=float(m["ce"]),
                             grad_norm=float(adamw.global_norm(g)),
                             flash=smoke.build.LAUNCHES["flash_attn_bhsd"])
            del g, m
    k, pl = cmp["kernel"], cmp["plain"]
    check(k["flash"] == n_flash and pl["flash"] == 0,
          f"train plain path: flash launches {k['flash']} / {pl['flash']}")
    check(abs(k["loss"] - pl["loss"]) <= TRAIN_LOSS_ATOL
          and abs(k["ce"] - pl["ce"]) <= TRAIN_LOSS_ATOL
          and abs(k["grad_norm"] - pl["grad_norm"])
          <= TRAIN_GNORM_RTOL * pl["grad_norm"],
          f"train: the kernel's step differs from the plain path's: {cmp}")
    out["plain_path"] = cmp
    print(f"phase 9: the step's loss / ce / grad norm on the kernel "
          f"{k['loss']:.6f} / {k['ce']:.6f} / {k['grad_norm']:.6f} vs the "
          f"plain path (flash's twin) {pl['loss']:.6f} / {pl['ce']:.6f} / "
          f"{pl['grad_norm']:.6f} (tol {TRAIN_LOSS_ATOL} abs, "
          f"{TRAIN_GNORM_RTOL} rel)")
    checkpoint_round_trip(params, opt, root, out)
    del model, params, opt, inner, loss_fn, grad_fn, src
    torch.cuda.empty_cache()
    restart_check(smoke, root, out)
    shutil.rmtree(root, ignore_errors=True)
    return {"train_step": n_flash, "train_run": sum(
        r["launches"]["flash_attn_bhsd"] for r in rec)}


def flash_calls_vs_twin(smoke, calls, faulty, what) -> tuple:
    """Each kept ``flash_attn_bhsd`` call of a forward held against its
    twin (``flash_err``), and the planted fault shown to fail the same
    bound on each.  Returns (max abs err, max err / tolerance, the
    fault's err / tolerance per call)."""
    err = over = 0.0
    fault = []
    for args, kw, (o,) in calls:
        want, spread = smoke.twin("flash_attn_bhsd", args, kw)
        e, ov = flash_err(o, want, spread, f"{what} flash call")
        err, over = max(err, e), max(over, ov)
        fault.append(flash_over(faulty(*args, **kw), want, spread))
        del want, spread
    check(min(fault) > 1.0, f"{what}: the kernel with KV tile {FAULT_TILE} "
                            f"skipped passes the flash tolerance on a call "
                            f"({min(fault):.3g}x)")
    return err, over, fault


def step_timing(step, batch, n_tokens) -> dict:
    """The median host seconds of three runs of ``step(batch)`` (each
    ending in a sync), tok/s over ``n_tokens``, and the runs' peak device
    memory above what was allocated before them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = float(np.median(times))
    return dict(step_s=median, step_s_all=times, tok_s=n_tokens / median,
                peak_bytes=torch.cuda.max_memory_allocated() - base)


def tally_of(*tallies) -> dict:
    """{"bytes": {kind: B}, "counts": {kind: calls}} summed over
    ``launch.dryrun.Collectives`` tallies."""
    from repro_torch.launch.dryrun import KINDS
    return {"bytes": {k: sum(t.bytes[k] for t in tallies) for k in KINDS},
            "counts": {k: sum(t.counts[k] for t in tallies) for k in KINDS}}


def collectives_line(runs) -> str:
    """Each rank's collectives (calls, MB of results) by kind."""
    return "; ".join(
        f"rank {i} " + ", ".join(
            f"{k} {r['collectives']['counts'][k]} / "
            f"{r['collectives']['bytes'][k] / 1e6:.2f} MB"
            for k in r["collectives"]["counts"])
        for i, r in enumerate(runs))


class RouteLog:
    """The port's router calls inside ``record()``: ([T, k] ids, [T] gap
    between the k-th and (k+1)-th probability), on the host, in call
    order (one call a MoE layer a pass)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe = moe

    @contextlib.contextmanager
    def record(self, force=None):
        """With ``force`` (another run's calls, in order), each call routes
        as that run's did: its ids, weighted by this run's probabilities
        at them (renormalized, as the router does); the call's own choice
        is what is recorded."""
        calls, real = [], self.moe._router

        def rec(params, cfg, x2d):
            out = real(params, cfg, x2d)
            probs = torch.softmax(x2d.float() @ params["router"]["w"].float(),
                                  dim=-1)
            top = probs.topk(cfg.top_k + 1, dim=-1).values
            calls.append((out[1].cpu(), (top[:, -2] - top[:, -1]).cpu()))
            if force is None:
                return out
            ids = force[len(calls) - 1][0].to(x2d.device)
            p = probs.gather(1, ids.long())
            return p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-9), ids, \
                out[2]
        self.moe._router = rec
        try:
            yield calls
        finally:
            self.moe._router = real


def route_flips(ref_calls, calls, what) -> int:
    """The routing choices of ``calls`` that differ from ``ref_calls``'
    (the same pass in another run); each must be a near tie in the
    reference, its k-th and (k+1)-th probabilities within ROUTE_GAP.
    Returns their count."""
    check(len(ref_calls) == len(calls) > 0, f"{what}: router calls "
                                            f"{len(ref_calls)} vs {len(calls)}")
    flips = 0
    for (rids, gap), (ids, _) in zip(ref_calls, calls):
        flip = (rids.sort(-1).values != ids.sort(-1).values).any(-1)
        bad = flip & (gap >= ROUTE_GAP)
        check(not bool(bad.any()),
              f"{what}: routing differs at a clear gap (tokens "
              f"{bad.nonzero().flatten()[:5].tolist()}, gaps "
              f"{gap[bad][:5].tolist()})")
        flips += int(flip.sum())
    return flips


@contextlib.contextmanager
def op_log(model):
    """What ``model``'s decode steps compute inside, in call order, kept on
    the card: each ``moe_ffn`` call's input and output ("moe_in",
    "moe_out"), each ``moe._expert_ffn`` call's (weights held, buf, h)
    ("experts"), each step's hidden state before the final norm
    ("final"), the unembedding's (normed input, weight held) ("unembed")
    and its last logits in f32 ("logits"; under a tensor-parallel mesh
    this rank's vocab block)."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    ops = {k: [] for k in ("moe_in", "moe_out", "experts", "final",
                           "unembed", "logits")}
    real_ffn, real_moe, real_logits = moe._expert_ffn, tf.moe_ffn, \
        model._logits
    real_unembed = model_mod.unembed

    def experts(w_gate, w_up, w_down, buf):
        h = real_ffn(w_gate, w_up, w_down, buf)
        ops["experts"].append(((w_gate, w_up, w_down), buf.clone(),
                               h.clone()))
        return h

    def moe_ffn(params, cfg, x, *a, **kw):
        y, aux = real_moe(params, cfg, x, *a, **kw)
        ops["moe_in"].append(x.clone())
        ops["moe_out"].append(y.clone())
        return y, aux

    def unembed(params, x):
        ops["unembed"].append((x.clone(), params["w"]))
        return real_unembed(params, x)

    def logits(x, *a, **kw):
        out = real_logits(x, *a, **kw)
        ops["final"].append(x.clone())
        ops["logits"].append(out[:, -1].float())
        return out
    moe._expert_ffn, tf.moe_ffn, model._logits = experts, moe_ffn, logits
    model_mod.unembed = unembed
    try:
        yield ops
    finally:
        moe._expert_ffn, tf.moe_ffn = real_ffn, real_moe
        model_mod.unembed = real_unembed
        del model._logits


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bits as an int16 array (npz has no bf16)."""
    return t.contiguous().view(torch.int16).cpu().numpy()


def moe_load(arch, layers, result_key, result):
    """``arch``'s full config cut to ``layers`` layers, on the card with
    random weights (``launch.serve.load_model``, drawn leaf by leaf)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = serve_mod.load_model(cfg, seed=MOE_SEED, device="cuda")
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    result[result_key] = dict(
        layers=layers, published_layers=get_config(arch).n_layers,
        params=model.param_count(), weight_bytes=weights,
        load_s=time.perf_counter() - t0,
        load_peak_bytes=torch.cuda.max_memory_allocated() - base)
    r = result[result_key]
    print(f"phase 10: {cfg.name} at full width, {layers} of "
          f"{r['published_layers']} layers (d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.hd}, {cfg.n_experts} experts of {cfg.d_ff_expert} "
          f"+ {cfg.n_shared_experts} shared, top-{cfg.top_k}, vocab "
          f"{cfg.vocab}): {r['params']} params, {weights / 2**30:.2f} GiB on "
          f"the card, drawn leaf by leaf in {r['load_s']:.2f} s (peak "
          f"{r['load_peak_bytes'] / 2**30:.2f} GiB during the load)")
    return cfg, model


def token_serve(smoke, model, shape, out, what, phase=10, seed=MOE_SEED):
    """``launch.serve.serve`` (no ``prefill``: the prompt fed token by
    token) with the counts of each phase: no kernel of the eight
    launched.  Returns the ServeResult."""
    from repro_torch.launch import serve as serve_mod
    b, s, gen = shape
    prompts = serve_mod.make_prompts(model.cfg, b, s, seed, "cuda")
    counts = {}

    def on_phase(name, edge):
        if edge == "start":
            smoke.build.reset_launches()
        else:
            counts[name] = dict(smoke.build.LAUNCHES)

    res = serve_mod.serve(model, prompts, gen, on_phase=on_phase)
    for name, c in counts.items():
        check(not any(c.values()), f"{what} serve {name}: launches {c}")
    tok = res.tokens
    check(tok.shape == (b, gen) and bool(((tok >= 0)
                                          & (tok < model.cfg.vocab)).all())
          and bool(torch.isfinite(res.prefill_logits).all())
          and torch.equal(tok[:, 0], res.prefill_logits.argmax(-1).int()),
          f"{what} serve: tokens out of range or not the last prompt "
          f"step's argmax")
    out["serve"] = dict(batch=b, prompt=s, gen=gen,
                        prompt_tok_s=res.prefill_tok_s(),
                        decode_tok_s=res.decode_tok_s(),
                        prompt_s=res.prefill_s, decode_s=res.decode_s,
                        peak_bytes=res.peak_bytes)
    sv = out["serve"]
    print(f"phase {phase}: {what} through launch.serve.serve, {b} prompts "
          f"of {s} tokens fed token by token (no prefill, as repro) in "
          f"{res.prefill_s:.2f} s = {sv['prompt_tok_s']:.5g} tok/s, then "
          f"{gen - 1} greedy steps in {res.decode_s:.2f} s = "
          f"{sv['decode_tok_s']:.5g} tok/s; no kernel of the eight launched; "
          f"peak {res.peak_bytes / 2**30:.2f} GiB above the weights")
    return res


def mixtral_forward(smoke, cfg, model, faulty, out):
    """Phase 10a: ``make_prefill_step`` over MOE_BATCH x MOE_SEQ tokens
    (flash once a layer, each call against the twin and the planted
    fault), the forward's logits and aux against the plain path (flash's
    twin), then tok/s, peak memory and a profile by operator.  Returns
    the first flash call (for the timing)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.runtime.steps import make_prefill_step
    run = serve_mod.run_config(MOE_SEQ)
    toks = serve_mod.make_prompts(cfg, MOE_BATCH, MOE_SEQ, MOE_SEED, "cuda")
    step = make_prefill_step(model, run)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        last = step({"tokens": toks})
        torch.cuda.synchronize()
    counts = dict(smoke.build.LAUNCHES)
    routes = dict(smoke.build.ROUTE_LAUNCHES)
    for kname, n in counts.items():
        check((n > 0) == (kname == "flash_attn_bhsd"),
              f"mixtral forward: {kname} launched {n} times")
    bhsd = (MOE_BATCH * cfg.n_heads, MOE_SEQ, cfg.hd)
    calls = cap.calls["flash_attn_bhsd"]
    check(counts["flash_attn_bhsd"] == cfg.n_layers == len(calls)
          and routes["flash_attn_bhsd:wgmma"] == cfg.n_layers
          and all(a[0].shape == bhsd and a[0].dtype == torch.bfloat16
                  for a, _, _ in calls),
          f"mixtral forward: flash launches {routes}, not {cfg.n_layers} "
          f"wgmma calls at {bhsd}")
    check(bool(torch.isfinite(last).all()) and last.shape == (MOE_BATCH,
                                                              cfg.vocab),
          "mixtral forward: last logits not finite")
    err, over, fault = flash_calls_vs_twin(smoke, calls, faulty,
                                           "mixtral forward")
    first = calls[:1]
    del cap, calls
    # The kernel's forward and the plain path's (flash's twin), the plain
    # path routed as the kernel's routed (its own choices recorded: each
    # that differs must be a near tie), so the two compute the same
    # function and drop the same choices.
    log = RouteLog()
    res = {}
    for name in ("kernel", "plain"):
        force = res["kernel"][3] if name == "plain" else None
        with (twin_flash(smoke) if name == "plain"
              else contextlib.nullcontext()), log.record(force) as rc, \
                torch.inference_mode():
            smoke.build.reset_launches()
            logits, aux = model.forward(run, {"tokens": toks})
            torch.cuda.synchronize()
            res[name] = (logits, int(aux["dropped"]), float(aux["lb_loss"]),
                         rc, smoke.build.LAUNCHES["flash_attn_bhsd"])
    (kl, kd, klb, krc, kn), (pl, pd, plb, prc, pn) = res["kernel"], \
        res["plain"]
    check(kn == cfg.n_layers and pn == 0,
          f"mixtral plain path: flash launches {kn} / {pn}")
    flips = route_flips(krc, prc, "mixtral kernel vs plain")
    diff = float((kl - pl).abs().max())
    check(bool(torch.isfinite(kl).all()) and diff <= LOGIT_TOL,
          f"mixtral forward: logits differ from the plain path's by {diff}")
    check(kd == pd, f"mixtral forward: dropped {kd} vs the plain path's {pd}")
    del kl, pl, res
    out["forward"] = dict(
        batch=MOE_BATCH, seq=MOE_SEQ, flash_launches=cfg.n_layers,
        flash_max_abs_err=err, flash_over=over, fault_over=fault,
        logits_vs_plain=diff, near_tie_flips=flips,
        routing_decisions=MOE_BATCH * MOE_SEQ * cfg.n_layers, dropped=kd,
        dropped_plain=pd, lb_loss=klb, lb_loss_plain=plb,
        capacity=moe.capacity_of(cfg, MOE_BATCH * MOE_SEQ))
    f = out["forward"]
    print(f"phase 10: mixtral make_prefill_step over {MOE_BATCH} x {MOE_SEQ} "
          f"tokens: flash_attn_bhsd launched {cfg.n_layers} times (one a "
          f"layer, all wgmma at {list(bhsd)}) and nothing else of the eight; "
          f"each call == twin (max abs err {err:.3g}, {over:.3g}x the "
          f"tolerance; the planted fault fails each, "
          f"{min(fault):.3g}-{max(fault):.3g}x); forward's logits within "
          f"{diff:.4g} of the plain path's (tol {LOGIT_TOL}; routed as the "
          f"kernel's, whose choice it would have made otherwise in {flips} "
          f"of {f['routing_decisions']} token-layers, all near ties, gap < "
          f"{ROUTE_GAP}); dropped {kd} (plain {pd}) of "
          f"{MOE_BATCH * MOE_SEQ * cfg.top_k} choices at capacity "
          f"{f['capacity']}; lb_loss {klb:.6f} (plain {plb:.6f})")
    # Timing: tok/s of the step, peak memory, a profile by operator.
    f.update(step_timing(step, {"tokens": toks}, MOE_BATCH * MOE_SEQ))
    patches = [(moe, "_router", "router"),
               (moe, "plan_routes", "dispatch: plan (sort)"),
               (moe, "slot_tables", "dispatch: slot tables"),
               (moe, "scatter_to_buckets", "dispatch: scatter"),
               (moe, "gather_from_buckets", "dispatch: gather"),
               (moe, "_expert_ffn", "expert products"),
               (ops, "flash_attn", "flash attention"),
               (model_mod, "unembed", "unembedding (f32)")]
    f["profile"] = p = profile_busy(lambda: step({"tokens": toks}), top=8,
                                    ranges=patches)
    print(f"phase 10: mixtral forward step {f['step_s'] * 1e3:.1f} ms "
          f"(median of {[round(t * 1e3, 1) for t in f['step_s_all']]}) = "
          f"{f['tok_s']:.5g} tok/s ({card_line()}); peak "
          f"{f['peak_bytes'] / 2**30:.2f} GiB above the weights; under "
          f"torch.profiler: wall {p['wall_ms']:.1f} ms, device "
          f"{p['device_ms']:.1f} ms (busy {p['busy']:.1%}), {p['launches']} "
          f"launches; by operator "
          + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n)
                      in p["ranges"].items())
          + "; top kernels " + "; ".join(f"{k} {ms:.2f} ms x{n}"
                                         for k, ms, n in p["top"]))
    return first


def mixtral_teacher_forced(smoke, cfg, model, gen_tok, prompts, out):
    """Phase 10c: the no-drop copy (capacity_factor = E / k, so capacity
    = T and nothing drops, in decode as in the forward): decode fed the
    prompt and generated tokens one at a time, each step routed as the
    teacher-forced forward routed those positions (its own choices
    recorded: each that differs must be a near tie), against that
    forward; logits within LOGIT_TOL at every position, argmax equal
    where the forward's margin is clear."""
    from repro_torch.launch import serve as serve_mod
    full = torch.cat([prompts, gen_tok], dim=1)
    b, n = full.shape
    run = serve_mod.run_config(prompts.shape[1])
    saved = model.cfg
    model.cfg = nodrop = dataclasses.replace(
        saved, capacity_factor=saved.n_experts / saved.top_k)
    log = RouteLog()
    flips = 0
    try:
        with torch.inference_mode():
            with log.record() as fwd_calls:
                smoke.build.reset_launches()
                pred, aux = model.forward(run, {"tokens": full})
                torch.cuda.synchronize()
                fwd_flash = smoke.build.LAUNCHES["flash_attn_bhsd"]
            check(int(aux["dropped"]) == 0, "no-drop forward dropped "
                                            f"{int(aux['dropped'])}")
            cache = model.init_cache(b, n)
            dec = []
            for i in range(n):
                # Step i's rows are the forward's positions i.
                force = [(ids.reshape(b, n, -1)[:, i], gap.reshape(b, n)[:, i])
                         for ids, gap in fwd_calls]
                with log.record(force) as rc:
                    lg, cache = model.decode_step(run, full[:, i:i + 1],
                                                  cache)
                flips += route_flips(force, rc, "no-drop decode vs forward")
                dec.append(lg[:, -1])
            dec = torch.stack(dec, dim=1)
    finally:
        model.cfg = saved
    check(fwd_flash == cfg.n_layers, f"no-drop forward: {fwd_flash} flash "
                                     f"launches")
    diff = float((dec - pred).abs().max())
    check(bool(torch.isfinite(pred).all()) and diff <= LOGIT_TOL,
          f"no-drop decode: logits differ from the forward's by {diff}")
    top = pred.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    agree = dec.argmax(-1) == top.indices[..., 0]
    check(bool(agree[clear].all()), "no-drop decode: argmax differs from the "
                                    "forward's where its margin is clear")
    out["teacher_forced"] = dict(
        positions=n, decode_vs_forward=diff, near_tie_flips=flips,
        routing_decisions=b * n * cfg.n_layers,
        argmax_checked=int(clear.sum()),
        capacity_factor=nodrop.capacity_factor)
    print(f"phase 10: the no-drop copy (capacity_factor "
          f"{nodrop.capacity_factor}: capacity = T): decode over {b} x {n} "
          f"tokens, routed as the teacher-forced forward routed (whose "
          f"choice it would have made otherwise in {flips} of "
          f"{b * n * cfg.n_layers} token-layers, all near ties), within "
          f"{diff:.4g} of the forward's logits (tol {LOGIT_TOL}); argmax "
          f"equal at all {int(clear.sum())} positions whose margin > "
          f"{LOGIT_TOL}")


def deepseek_path(smoke, out):
    """Phase 10d: DeepSeek-V2 at full width, DSV2_LAYERS layers (the dense
    first one, MLA + MoE after): ``make_prefill_step`` over DSV2_BATCH x
    DSV2_SEQ tokens and the token-loop serve; no kernel of the eight
    launched (head dim 192 and MLA's dv != d are no flash instance)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime.steps import make_prefill_step
    cfg, model = moe_load(DSV2_ARCH, DSV2_LAYERS, "deepseek", out)
    r = out["deepseek"]
    run = serve_mod.run_config(DSV2_SEQ)
    toks = serve_mod.make_prompts(cfg, DSV2_BATCH, DSV2_SEQ, MOE_SEED, "cuda")
    step = make_prefill_step(model, run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    smoke.build.reset_launches()
    with torch.inference_mode():
        logits, aux = model.forward(run, {"tokens": toks})
        torch.cuda.synchronize()
    check(not any(smoke.build.LAUNCHES.values()),
          f"deepseek forward: launches {dict(smoke.build.LAUNCHES)}")
    check(logits.shape == (DSV2_BATCH, DSV2_SEQ, cfg.vocab)
          and bool(torch.isfinite(logits).all())
          and math.isfinite(float(aux["lb_loss"])),
          "deepseek forward: logits or lb_loss not finite")
    r["forward_dropped"] = int(aux["dropped"])
    r["forward_lb_loss"] = float(aux["lb_loss"])
    del logits, aux
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        step({"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    r["forward_s"] = float(np.median(times))
    r["forward_tok_s"] = DSV2_BATCH * DSV2_SEQ / r["forward_s"]
    r["forward_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    print(f"phase 10: {cfg.name} forward over {DSV2_BATCH} x {DSV2_SEQ} "
          f"tokens in {r['forward_s'] * 1e3:.1f} ms = "
          f"{r['forward_tok_s']:.5g} tok/s ({card_line()}), peak "
          f"{r['forward_peak_bytes'] / 2**30:.2f} GiB above the weights; "
          f"no kernel of the eight launched; dropped {r['forward_dropped']}, "
          f"lb_loss {r['forward_lb_loss']:.6f}")
    token_serve(smoke, model, DSV2_SERVE, r, cfg.name)
    del model, step
    torch.cuda.empty_cache()


def moe_train_check(smoke, out):
    """Phase 10e: Mixtral's reduced config trained MOE_TRAIN_STEPS steps on
    the card through ``launch.train.setup`` and ``train_loop`` over
    ``make_train_step``: the loss finite, ``lb_loss`` and ``dropped``
    reported each step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import DriverConfig, train_loop
    cfg = get_reduced_config(MOE_ARCH)
    model, params, opt = train_mod.setup(cfg, seed=MOE_SEED, device="cuda")
    run = train_mod.run_config(MOE_ARCH, MOE_TRAIN_STEPS, MOE_TRAIN_SEQ)
    src = SyntheticLM(cfg=cfg, batch=8, seq=MOE_TRAIN_SEQ, seed=MOE_SEED,
                      device="cuda")
    inner = steps.make_train_step(model, run)
    rec = []

    def step(params, opt, batch):
        smoke.build.reset_launches()
        params, opt, m = inner(params, opt, batch)
        rec.append(dict({k: float(v) for k, v in m.items()},
                        flash=smoke.build.LAUNCHES["flash_attn_bhsd"]))
        return params, opt, m

    root = str(smoke.build.BUILD_ROOT.parent / "moe_train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    dcfg = DriverConfig(total_steps=MOE_TRAIN_STEPS,
                        ckpt_every=MOE_TRAIN_STEPS, ckpt_dir=root, keep=1,
                        log_every=1)
    _, _, hist = train_loop(step, params, opt, src, dcfg,
                            log=lambda *_: None)
    shutil.rmtree(root, ignore_errors=True)
    check(hist["steps_run"] == MOE_TRAIN_STEPS and len(rec) == MOE_TRAIN_STEPS
          and all(math.isfinite(r["loss"]) and math.isfinite(r["lb_loss"])
                  and r["flash"] == cfg.n_layers for r in rec),
          f"mixtral reduced train_loop: {rec}")
    out["train"] = rec
    print(f"phase 10: {cfg.name} through train_loop over make_train_step on "
          f"the card, {MOE_TRAIN_STEPS} steps of 8 x {MOE_TRAIN_SEQ} (S <= "
          f"window: flash's CUDA-core route at head dim {cfg.hd}): "
          + "; ".join(f"loss {r['loss']:.4f} lb_loss {r['lb_loss']:.4f} "
                      f"dropped {r['dropped']:.0f} (flash {r['flash']} "
                      f"launches)" for r in rec))


def moe_phase(smoke, result, faulty) -> dict:
    """Phase 10 (see the module doc).  Returns the flash kernel's launches
    on the Mixtral forward and its timing at that shape."""
    out = result["moe"] = {}
    cfg, model = moe_load(MOE_ARCH, MOE_LAYERS, "mixtral", out)
    first = mixtral_forward(smoke, cfg, model, faulty, out["mixtral"])
    timing = flash_row(smoke, first, cfg.n_layers, batch=MOE_BATCH,
                       path="mixtral forward")
    del first
    res = token_serve(smoke, model, MOE_SERVE, out["mixtral"], cfg.name)
    from repro_torch.launch import serve as serve_mod
    prompts = serve_mod.make_prompts(cfg, MOE_SERVE[0], MOE_SERVE[1],
                                     MOE_SEED, "cuda")
    mixtral_teacher_forced(smoke, cfg, model, res.tokens, prompts,
                           out["mixtral"])
    del model, res
    torch.cuda.empty_cache()
    deepseek_path(smoke, out)
    moe_train_check(smoke, out)
    return {"launches": cfg.n_layers, "timing": timing}


# -- phase 11: the vlm and encdec families -----------------------------------
def draw_gates(pairs, gate=None) -> None:
    """The vlm's gates (zero at init, as in ``repro``, which would hide the
    whole image path), ``pairs`` of (gate, ffn_gate) in group order, drawn
    from U(0.5, 1.5) with XATTN_SEED; ``gate`` then sets every attention
    gate to that value (the ffn gates stay)."""
    gen = torch.Generator(device="cuda").manual_seed(XATTN_SEED + 1)
    with torch.no_grad():
        for attn_gate, ffn_gate in pairs:
            for p in (attn_gate, ffn_gate):
                p.uniform_(0.5, 1.5, generator=gen)
            if gate is not None:
                attn_gate.fill_(gate)


def set_gates(model, gate=None) -> None:
    """``draw_gates`` over a vlm model's cross blocks."""
    draw_gates([(g["cross"].gate, g["cross"].ffn_gate)
                for g in model.groups], gate)


def family_load(arch, out, phase=11, **changes):
    """``arch``'s full config (with ``changes``) on the card, random
    weights drawn leaf by leaf (``launch.serve.load_model``); the leaves
    ``repro`` starts at zero that would hide a path then drawn live: the
    vlm's gates (``set_gates``), zamba2's decay (``live_ssm``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    cfg = dataclasses.replace(get_config(arch), **changes)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = serve_mod.load_model(cfg, seed=XATTN_SEED, device="cuda")
    if cfg.family == "vlm":
        set_gates(model)
    if cfg.family == "ssm_hybrid":
        live_ssm(model)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    out.update(layers=cfg.n_layers + cfg.enc_layers,
               published_layers=get_config(arch).n_layers
               + get_config(arch).enc_layers,
               params=model.param_count(), weight_bytes=weights,
               load_s=time.perf_counter() - t0,
               load_peak_bytes=torch.cuda.max_memory_allocated() - base)
    print(f"phase {phase}: {cfg.name} at full width, {out['layers']} of "
          f"{out['published_layers']} layers (d {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, {cfg.n_kv_heads} KV heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}): {out['params']} params, "
          f"{weights / 2**30:.2f} GiB on the card, drawn leaf by leaf in "
          f"{out['load_s']:.2f} s (peak {out['load_peak_bytes'] / 2**30:.2f} "
          f"GiB during the load)")
    return cfg, model


def xattn_batch(cfg, b, s) -> dict:
    """Prompt tokens [b, s] (``make_prompts``) and the family's stub,
    image tokens [b, n_img, d_vision] or frames [b, s, d], bf16 normals
    from XATTN_SEED on the card."""
    from repro_torch.launch import serve as serve_mod
    gen = torch.Generator(device="cuda").manual_seed(XATTN_SEED)
    batch = {"tokens": serve_mod.make_prompts(cfg, b, s, XATTN_SEED,
                                              "cuda")}
    if cfg.family == "vlm":
        shape, name = (b, cfg.n_img_tokens, cfg.d_vision), "img"
    else:
        shape, name = (b, s, cfg.d_model), "frames"
    batch[name] = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    return batch


def family_forward(smoke, cfg, model, batch, faulty, want_calls, out, what,
                   phase=11, patches=None, logits_tol=LOGIT_TOL,
                   profile_seq=None):
    """``make_prefill_step`` over ``batch``: ``flash_attn_bhsd`` launched
    once for each of ``want_calls`` ((causal, [BH, S, D]), in order), all
    on the tensor-core route, nothing else of the eight; each call held
    against the twin and the planted fault shown to fail it; the
    forward's logits within ``logits_tol`` of the plain path's (flash's
    twin; None: reported only, see RECURRENT_*); then tok/s, peak memory
    and a profile by part (``patches``: ``profile_busy`` ranges, the
    cross-attention families' by default; a label with "(inside" names
    a range nested in another, left out of the rest's sum; over the
    first ``profile_seq`` tokens of each row if given).  Returns the first
    call of each kind (causal, full) for the timing."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.steps import make_prefill_step
    b, s = batch["tokens"].shape
    run = serve_mod.run_config(s)
    step = make_prefill_step(model, run)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    with smoke.capture(keep=["flash_attn_bhsd"]) as cap:
        last = step(batch)
        torch.cuda.synchronize()
    counts = dict(smoke.build.LAUNCHES)
    routes = dict(smoke.build.ROUTE_LAUNCHES)
    calls = cap.calls["flash_attn_bhsd"]
    for kname, n in counts.items():
        check(n == (len(want_calls) if kname == "flash_attn_bhsd" else 0),
              f"{what} forward: {kname} launched {n} times")
    got = [(kw["causal"], tuple(a[0].shape)) for a, kw, _ in calls]
    check(got == want_calls and counts["flash_attn_bhsd"] == len(want_calls)
          and routes.get("flash_attn_bhsd:wgmma", 0) == len(want_calls)
          and all(a[0].dtype == torch.bfloat16 for a, _, _ in calls),
          f"{what} forward: flash calls {got} by route {routes}, not "
          f"{want_calls} on wgmma")
    check(bool(torch.isfinite(last).all()) and last.shape == (b, cfg.vocab),
          f"{what} forward: last logits not finite")
    err, over, fault = flash_calls_vs_twin(smoke, calls, faulty,
                                           f"{what} forward") \
        if calls else (0.0, 0.0, [])
    first = {}
    for call in calls:
        first.setdefault(call[1]["causal"], [call])
    del cap, calls
    logits = {}
    for name in ("kernel", "plain"):
        with (twin_flash(smoke) if name == "plain"
              else contextlib.nullcontext()), torch.inference_mode():
            smoke.build.reset_launches()
            logits[name] = model.forward(run, batch)[0]
            torch.cuda.synchronize()
            n = smoke.build.LAUNCHES["flash_attn_bhsd"]
        check(n == (len(want_calls) if name == "kernel" else 0),
              f"{what} {name} forward: {n} flash launches")
    diff = float((logits["kernel"] - logits["plain"]).abs().max())
    mean_diff = float((logits["kernel"] - logits["plain"]).abs().mean())
    check(bool(torch.isfinite(logits["kernel"]).all())
          and (logits_tol is None or diff <= logits_tol),
          f"{what} forward: logits differ from the plain path's by {diff}")
    shape = tuple(logits["kernel"].shape)
    del logits
    n_full = sum(not c for c, _ in want_calls)
    out["forward"] = dict(batch=b, seq=s, flash_launches=len(want_calls),
                          flash_full=n_full,
                          flash_causal=len(want_calls) - n_full,
                          flash_max_abs_err=err, flash_over=over,
                          fault_over=fault, logits_vs_plain=diff,
                          logits_vs_plain_mean=mean_diff,
                          logits_shape=shape)
    f = out["forward"]
    faults = (f"the planted fault fails each, {min(fault):.3g}-"
              f"{max(fault):.3g}x" if fault else "no call")
    print(f"phase {phase}: {what} make_prefill_step over {b} x {s} tokens: "
          f"flash_attn_bhsd launched {len(want_calls)} times ({n_full} full, "
          f"{len(want_calls) - n_full} causal, all wgmma at "
          f"{sorted({sh for _, sh in want_calls})}) and nothing else of the "
          f"eight; each call == twin (max abs err {err:.3g}, {over:.3g}x the "
          f"tolerance; {faults}); forward's logits {shape} within "
          f"{diff:.4g} (mean {mean_diff:.3g}) of the plain path's (tol "
          f"{logits_tol})")
    f.update(step_timing(step, batch, b * s))
    if patches is None:
        patches = [(ops, "flash_attn", "self attention (flash)"),
                   (attn_mod, "blockwise_attn",
                    "cross attention (blockwise, f32)"),
                   (tf, "ffn", "FFN"), (model_mod, "ffn", "FFN"),
                   (model_mod, "unembed", "unembedding (f32)")]
    pbatch = {k: v[:, :profile_seq] for k, v in batch.items()} \
        if profile_seq else batch
    f["profile"] = p = profile_busy(lambda: step(pbatch), top=8,
                                    ranges=patches)
    p["tokens"] = int(pbatch["tokens"].numel())
    nested = {label for _, _, label in patches if "(inside" in label}
    rest = p["device_ms"] - sum(ms for k, (ms, _) in p["ranges"].items()
                                if k not in nested)
    f["profile"]["rest_ms"] = rest
    print(f"phase {phase}: {what} forward step {f['step_s'] * 1e3:.1f} ms "
          f"(median of {[round(t * 1e3, 1) for t in f['step_s_all']]}) = "
          f"{f['tok_s']:.5g} tok/s ({card_line()}); peak "
          f"{f['peak_bytes'] / 2**30:.2f} GiB above the weights; under "
          f"torch.profiler ({p['tokens']} tokens): wall {p['wall_ms']:.1f} "
          f"ms, device "
          f"{p['device_ms']:.1f} ms (busy {p['busy']:.1%}), {p['launches']} "
          f"launches; by part "
          + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n)
                      in p["ranges"].items())
          + f"; the rest {rest:.2f} ms"
          + "; top kernels " + "; ".join(f"{k} {ms:.2f} ms x{n}"
                                         for k, ms, n in p["top"]))
    return first


def vlm_teacher_forced(smoke, cfg, model, img, prompts, gen_tok, out):
    """Phase 11a's decode against a teacher-forced ``forward`` over the
    prompt and generated tokens, with every attention gate at 0: decode
    never fills the image caches (``repro``'s ``build_vlm``), so only then
    do the two compute the same function; the ffn gates stay non-zero,
    so the cross blocks' FFN runs in both.  Logits within LOGIT_TOL at
    every position, argmax equal where the forward's margin is clear."""
    from repro_torch.launch import serve as serve_mod
    full = torch.cat([prompts, gen_tok], dim=1)
    b, n = full.shape
    run = serve_mod.run_config(prompts.shape[1])
    saved = [g["cross"].gate.detach().clone() for g in model.groups]
    set_gates(model, gate=0.0)
    try:
        with torch.inference_mode():
            pred = model.forward(run, {"tokens": full, "img": img})[0]
            cache = model.init_cache(b, n)
            dec = []
            for i in range(n):
                lg, cache = model.decode_step(run, full[:, i:i + 1], cache)
                dec.append(lg[:, -1])
            dec = torch.stack(dec, dim=1)
            check(not cache["img_k"].any() and not cache["img_v"].any(),
                  "vlm decode wrote the image caches")
    finally:
        with torch.no_grad():
            for g, gate in zip(model.groups, saved):
                g["cross"].gate.copy_(gate)
    diff = float((dec - pred).abs().max())
    check(bool(torch.isfinite(pred).all()) and diff <= LOGIT_TOL,
          f"vlm decode (gate 0): logits differ from the forward's by {diff}")
    top = pred.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    check(bool((dec.argmax(-1) == top.indices[..., 0])[clear].all()),
          "vlm decode (gate 0): argmax differs from the forward's where its "
          "margin is clear")
    out["teacher_forced"] = dict(positions=n, decode_vs_forward=diff,
                                 argmax_checked=int(clear.sum()))
    print(f"phase 11: vlm decode over {b} x {n} tokens with the attention "
          f"gates at 0 (ffn gates not; the image caches stay zero, as in "
          f"repro) within {diff:.4g} of a teacher-forced forward (tol "
          f"{LOGIT_TOL}); argmax equal at all {int(clear.sum())} positions "
          f"whose margin > {LOGIT_TOL}")


def flash_layers(cfg) -> int:
    """The self-attention layers of a forward of ``cfg`` (flash launches
    a forward or a training step)."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every * (cfg.cross_attn_every
                                                      - 1)
    if cfg.family == "ssm_hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "xlstm":
        return 0
    return cfg.enc_layers + cfg.n_layers


def family_train_check(smoke, out, archs=(VLM_ARCH, ENCDEC_ARCH), phase=11,
                       n_steps=XATTN_TRAIN_STEPS):
    """Phase 11c / 12c: the reduced configs of ``archs`` trained
    ``n_steps`` steps on the card through ``launch.train.setup`` and
    ``train_loop`` over ``make_train_step`` (the pipeline draws the
    image / frames stub): every loss finite, flash launched once a self
    layer a step, and the loss on a batch the run never trains on lower
    after the steps than before (each step's loss is on fresh data, so
    the held batch is what shows the fall)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import DriverConfig, train_loop
    root = str(smoke.build.BUILD_ROOT.parent / "xattn_train_smoke")
    for arch in archs:
        cfg = get_reduced_config(arch)
        model, params, opt = train_mod.setup(cfg, seed=XATTN_SEED,
                                             device="cuda")
        run = train_mod.run_config(arch, n_steps, XATTN_TRAIN_SEQ)
        src = SyntheticLM(cfg=cfg, batch=8, seq=XATTN_TRAIN_SEQ,
                          seed=XATTN_SEED, device="cuda")
        held = src.batch_at(10 * n_steps)
        loss_fn = steps.make_loss_fn(model, run)
        with torch.no_grad():
            before = float(loss_fn(held)[0])
        inner = steps.make_train_step(model, run)
        rec = []

        def step(params, opt, batch, inner=inner, rec=rec):
            smoke.build.reset_launches()
            params, opt, m = inner(params, opt, batch)
            rec.append(dict(loss=float(m["loss"]),
                            flash=smoke.build.LAUNCHES["flash_attn_bhsd"]))
            return params, opt, m

        shutil.rmtree(root, ignore_errors=True)
        dcfg = DriverConfig(total_steps=n_steps,
                            ckpt_every=n_steps, ckpt_dir=root,
                            keep=1, log_every=1)
        _, _, hist = train_loop(step, params, opt, src, dcfg,
                                log=lambda *_: None)
        shutil.rmtree(root, ignore_errors=True)
        with torch.no_grad():
            after = float(loss_fn(held)[0])
        n_self = flash_layers(cfg)
        check(hist["steps_run"] == n_steps
              and len(rec) == n_steps
              and all(math.isfinite(r["loss"]) and r["flash"] == n_self
                      for r in rec) and after < before,
              f"{cfg.name} train_loop: {rec}, held-out loss {before} -> "
              f"{after}")
        out[arch] = dict(losses=[r["loss"] for r in rec], held_before=before,
                         held_after=after, flash_per_step=n_self)
        print(f"phase {phase}: {cfg.name} through train_loop over "
              f"make_train_step on the card, {n_steps} steps of 8 x "
              f"{XATTN_TRAIN_SEQ} (flash {n_self} launches a step): losses "
              f"{rec[0]['loss']:.4f} ... {rec[-1]['loss']:.4f}, all finite; "
              f"held-out batch {before:.4f} -> {after:.4f}")
        del model, params, opt


def xattn_phase(smoke, result, faulty) -> dict:
    """Phase 11 (see the module doc).  Returns the flash kernel's launches
    on the two forwards and its timing at the encdec shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    out = result["xattn"] = {"vlm": {}, "encdec": {}, "train": {}}
    # a. Llama-3.2-Vision-90B, VLM_GROUPS of its groups of k layers.
    k = get_config(VLM_ARCH).cross_attn_every
    cfg, model = family_load(VLM_ARCH, out["vlm"], n_layers=VLM_GROUPS * k)
    batch = xattn_batch(cfg, VLM_BATCH, VLM_SEQ)
    bhsd = (VLM_BATCH * cfg.n_heads, VLM_SEQ, cfg.hd)
    vlm_launches = VLM_GROUPS * (k - 1)
    family_forward(smoke, cfg, model, batch, faulty,
                   [(True, bhsd)] * vlm_launches, out["vlm"],
                   "llama-3.2-vision")
    res = token_serve(smoke, model, XATTN_SERVE, out["vlm"], cfg.name, 11,
                      XATTN_SEED)
    b, s, _ = XATTN_SERVE
    prompts = serve_mod.make_prompts(cfg, b, s, XATTN_SEED, "cuda")
    vlm_teacher_forced(smoke, cfg, model, batch["img"][:b], prompts,
                       res.tokens, out["vlm"])
    del model, res, batch
    torch.cuda.empty_cache()
    # b. SeamlessM4T-medium whole.
    cfg, model = family_load(ENCDEC_ARCH, out["encdec"])
    batch = xattn_batch(cfg, ENCDEC_BATCH, ENCDEC_SEQ)
    bhsd = (ENCDEC_BATCH * cfg.n_heads, ENCDEC_SEQ, cfg.hd)
    first = family_forward(smoke, cfg, model, batch, faulty,
                           [(False, bhsd)] * cfg.enc_layers
                           + [(True, bhsd)] * cfg.n_layers,
                           out["encdec"], "seamless-m4t")
    timing = {}
    for causal, calls in first.items():
        timing["causal" if causal else "full"] = flash_row(
            smoke, calls, cfg.n_layers if causal else cfg.enc_layers,
            batch=ENCDEC_BATCH,
            path=f"seamless-m4t {'decoder' if causal else 'encoder'}")
    del first
    token_serve(smoke, model, XATTN_SERVE, out["encdec"], cfg.name, 11,
                XATTN_SEED)
    del model, batch
    torch.cuda.empty_cache()
    # c. Training at the reduced configs.
    family_train_check(smoke, out["train"])
    return {"launches": {"vlm_forward": vlm_launches,
                         "encdec_forward": cfg.enc_layers + cfg.n_layers},
            "timing": timing}


# -- phase 12: the ssm_hybrid and xlstm families ------------------------------
def live_ssm(model) -> None:
    """zamba2's leaves that ``repro`` starts at zero and that would hide a
    path, drawn with XATTN_SEED: ``a_log`` / ``dt_bias`` from U(-1, 1)
    (the decay then varies across heads) and each LoRA's ``b_q`` from
    N(0, 1 / rank) (at 0 the LoRA term is dead)."""
    gen = torch.Generator(device="cuda").manual_seed(XATTN_SEED + 2)
    rank = model.cfg.shared_lora_rank
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("a_log", "dt_bias"):
                p.uniform_(-1.0, 1.0, generator=gen)
            elif leaf == "b_q":
                p.normal_(0.0, rank ** -0.5, generator=gen)


@contextlib.contextmanager
def patched(*swaps):
    """``setattr(module, name, fn)`` for each (module, name, fn) inside
    the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def row_ratio(got, want):
    """max over rows (the last axis reduced) of max |got - want| / max
    |want|, on the device: a block output's error in units of its
    scale at each position."""
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(-1)
            / want.abs().amax(-1).clamp_min(1e-30)).max()


def shared_vs_plain(smoke, model, batch) -> dict:
    """Phase 12a's kernel against the plain path, block by block: each
    shared block's output on the card's forward against the same block
    on the same input with flash's twin, within RECURRENT_BLOCK_RTOL of
    its scale at every position (see RECURRENT_BLOCK_RTOL)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as tf
    real = tf._shared_attn
    seen = []

    def rec(*a, **kw):
        y = real(*a, **kw)
        seen.append((a, y))
        return y
    run = serve_mod.run_config(batch["tokens"].shape[1])
    with patched((tf, "_shared_attn", rec)), torch.inference_mode():
        model.forward(run, batch)
    with twin_flash(smoke), torch.inference_mode():
        ratios = [row_ratio(real(*a), y) for a, y in seen]
    worst = float(torch.stack(ratios).max())
    check(len(seen) == model.n_groups and worst <= RECURRENT_BLOCK_RTOL,
          f"zamba2 shared blocks on the plain path: {len(seen)} blocks, "
          f"{worst:.3g} of their scale apart")
    return dict(blocks=len(seen), worst_ratio=worst)


def recurrent_pairs(family):
    """[(module, forward block, its decode step, the index of x in the
    forward's arguments, in the step's)] of ``family``'s blocks."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models import transformer as tf
    if family == "ssm_hybrid":
        return [(ssm, "mamba2", "mamba2_step", 2, 2),
                (tf, "_shared_attn", "_shared_attn_decode", 4, 3)]
    return [(xlstm, "mlstm", "mlstm_step", 2, 2),
            (xlstm, "slstm", "slstm_step", 2, 2)]


def decode_vs_forward(model, toks, what) -> dict:
    """Phase 12's decode against a teacher-forced forward over ``toks``
    [B, S] (from the forward's start state: the xLSTM stabilizers at
    -inf, see the module doc).  Block by block: each block's decode step,
    fed the forward's input to that block through ``decode_step``'s own
    caches, within RECURRENT_BLOCK_RTOL of the forward's output scale at
    every position (the mLSTM's fed the forward's projections too:
    RECURRENT_BLOCK_RTOL's comment); then the whole model's decode logits
    against the forward's (reported: see RECURRENT_BLOCK_RTOL)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import xlstm
    b, s = toks.shape
    run = serve_mod.run_config(s)
    pairs = recurrent_pairs(model.cfg.family)
    seen, worst, at = [], {}, {"i": 0, "t": 0}
    proj, qkvif = [], xlstm._mlstm_qkvif

    def rec(real, xi):
        def fn(*a, **kw):
            y = real(*a, **kw)
            seen.append((a[xi], y))
            return y
        return fn

    def rec_proj(*a):
        out = qkvif(*a)
        proj.append(out)
        return out

    def sub_proj(*a):
        q, k, v, li, lf, dk = proj[at["j"]]
        at["j"] += 1
        t = at["t"]
        return (*(x[:, t:t + 1] for x in (q, k, v, li, lf)), dk)

    def sub(real, xi, name):
        def fn(*a, **kw):
            x_in, y_fwd = seen[at["i"]]
            at["i"] += 1
            t = at["t"]
            a = list(a)
            a[xi] = x_in[:, t:t + 1]
            out = real(*a, **kw)
            r = row_ratio(out[0], y_fwd[:, t:t + 1])
            worst[name] = torch.maximum(worst[name], r) if name in worst \
                else r
            return out
        return fn

    def start(cache):
        if model.cfg.family == "xlstm":
            for k in ("m", "s"):
                if k in cache:
                    cache[k]["m"].fill_(float("-inf"))
        return cache

    with torch.inference_mode():
        with patched(*[(mod, f, rec(getattr(mod, f), xi))
                       for mod, f, _, xi, _ in pairs],
                     (xlstm, "_mlstm_qkvif", rec_proj)):
            fwd = model.forward(run, {"tokens": toks})[0]
        with patched(*[(mod, st, sub(getattr(mod, st), xi, f))
                       for mod, f, st, _, xi in pairs],
                     (xlstm, "_mlstm_qkvif", sub_proj)):
            cache = start(model.init_cache(b, s))
            for t in range(s):
                at["i"], at["j"], at["t"] = 0, 0, t
                _, cache = model.decode_step(run, toks[:, t:t + 1], cache)
                check(at["i"] == len(seen), f"{what} decode: {at['i']} "
                                            f"blocks, forward {len(seen)}")
        del seen, proj
        cache = start(model.init_cache(b, s))
        dec = []
        for t in range(s):
            lg, cache = model.decode_step(run, toks[:, t:t + 1], cache)
            dec.append(lg[:, -1])
        dec = torch.stack(dec, dim=1)
    blocks = {k: float(v) for k, v in worst.items()}
    check(all(v <= RECURRENT_BLOCK_RTOL for v in blocks.values())
          and bool(torch.isfinite(dec).all()),
          f"{what} decode vs forward by block: {blocks} of the block "
          f"outputs' scale (tol {RECURRENT_BLOCK_RTOL})")
    diff = (dec - fwd).abs()
    top = fwd.topk(2, dim=-1)
    clear = (top.values[..., 0] - top.values[..., 1]) > LOGIT_TOL
    agree = (dec.argmax(-1) == top.indices[..., 0])
    out = dict(positions=s, batch=b, block_ratio=blocks,
               logits_max=float(diff.max()), logits_mean=float(diff.mean()),
               argmax_equal=float(agree.float().mean()),
               argmax_equal_clear=float(agree[clear].float().mean())
               if bool(clear.any()) else None,
               logits_max_by_position=[float(v) for v in
                                       diff.amax(dim=(0, 2))[::16]])
    print(f"phase 12: {what} decode over {b} x {s} tokens against a "
          f"teacher-forced forward: block by block within "
          + ", ".join(f"{k} {v:.3g}" for k, v in blocks.items())
          + f" of the block outputs' scale (tol {RECURRENT_BLOCK_RTOL}); "
          f"whole model (reported, not held: RECURRENT_BLOCK_RTOL's "
          f"comment) logits {out['logits_max']:.4g} apart at most, "
          f"{out['logits_mean']:.3g} on average, by position "
          f"{[round(v, 3) for v in out['logits_max_by_position']]}; argmax "
          f"equal at {out['argmax_equal']:.1%} of positions "
          f"({out['argmax_equal_clear']} where the margin > {LOGIT_TOL})")
    return out


def recurrent_phase(smoke, result, faulty) -> dict:
    """Phase 12 (see the module doc).  Returns flash's launches on the
    zamba2 forward and its timing at that shape."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import ssm, xlstm
    from repro_torch.models import transformer as tf
    out = result["recurrent"] = {"zamba2": {}, "xlstm": {}, "train": {}}
    b, s, gen = RECURRENT_SERVE
    # a. Zamba2-1.2B whole.
    cfg, model = family_load(SSM_ARCH, out["zamba2"], phase=12)
    batch = {"tokens": serve_mod.make_prompts(cfg, RECURRENT_BATCH,
                                              RECURRENT_SEQ, XATTN_SEED,
                                              "cuda")}
    bhsd = (RECURRENT_BATCH * cfg.n_heads, RECURRENT_SEQ, cfg.hd)
    n_flash = model.n_groups
    patches = [(ssm, "_split_in_proj", "mamba in_proj"),
               (ssm, "_causal_conv", "mamba conv"),
               (ssm, "_ssd_chunks", "SSD chunk scan"),
               (ssm, "_gated_out", "mamba gated norm + out_proj"),
               (tf, "_shared_attn", "shared block"),
               (ops, "flash_attn", "flash (inside the shared block)"),
               (model_mod, "unembed", "unembedding (f32)")]
    first = family_forward(smoke, cfg, model, batch, faulty,
                           [(True, bhsd)] * n_flash, out["zamba2"],
                           "zamba2", phase=12, patches=patches,
                           logits_tol=None)
    out["zamba2"]["shared_vs_plain"] = sv = shared_vs_plain(smoke, model,
                                                            batch)
    print(f"phase 12: zamba2's {sv['blocks']} shared blocks on the plain "
          f"path (flash's twin), each on the kernel run's input: within "
          f"{sv['worst_ratio']:.3g} of the output's scale at every position "
          f"(tol {RECURRENT_BLOCK_RTOL})")
    timing = flash_row(smoke, first[True], n_flash, batch=RECURRENT_BATCH,
                       path="zamba2 shared block")
    del first, batch
    res = token_serve(smoke, model, RECURRENT_SERVE, out["zamba2"], cfg.name,
                      12, XATTN_SEED)
    prompts = serve_mod.make_prompts(cfg, b, s, XATTN_SEED, "cuda")
    out["zamba2"]["teacher_forced"] = decode_vs_forward(
        model, torch.cat([prompts, res.tokens], dim=1), "zamba2")
    del model, res
    torch.cuda.empty_cache()
    # b. xLSTM-1.3B whole.
    cfg, model = family_load(XLSTM_ARCH, out["xlstm"], phase=12)
    batch = {"tokens": serve_mod.make_prompts(cfg, RECURRENT_BATCH,
                                              RECURRENT_SEQ, XATTN_SEED,
                                              "cuda")}
    family_forward(smoke, cfg, model, batch, faulty, [], out["xlstm"],
                   "xlstm", phase=12,
                   patches=[(xlstm, "mlstm", "mLSTM"),
                            (xlstm, "slstm", "sLSTM"),
                            (model_mod, "unembed", "unembedding (f32)")],
                   profile_seq=RECURRENT_PROFILE_SEQ)
    del batch
    res = token_serve(smoke, model, RECURRENT_SERVE, out["xlstm"], cfg.name,
                      12, XATTN_SEED)
    prompts = serve_mod.make_prompts(cfg, b, s, XATTN_SEED, "cuda")
    out["xlstm"]["teacher_forced"] = decode_vs_forward(
        model, torch.cat([prompts, res.tokens], dim=1), "xlstm")
    del model, res
    torch.cuda.empty_cache()
    # c. Training at the reduced configs.
    family_train_check(smoke, out["train"], (SSM_ARCH, XLSTM_ARCH), 12,
                       RECURRENT_TRAIN_STEPS)
    return {"launches": {"zamba2_forward": n_flash}, "timing": timing}


def free_addr() -> str:
    """A tcp://127.0.0.1 address on a free port (a process group's
    rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def sharded_rank(rank, addr, tmp):
    """Phase 13b-d on one of SHARDED_RANKS gloo ranks sharing cuda:0 (a
    spawned process): the host map loaded from ``tmp``, then each run of
    SHARDED_RUNS, warmed up once and then driven with the launch counts
    set to 0 just before and read just after.  Writes ``rank{rank}.json``:
    per run, its ids against the expected ones in ``inputs.npz``, stats,
    launches, seconds, peak device memory and the mesh's route."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.core.distributed import assign_fast_distributed
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, rank=rank,
                            world_size=SHARDED_RANKS,
                            timeout=timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        t0 = time.perf_counter()
        idx = GeoIndexSet.load(os.path.join(tmp, "map"), device="cuda")
        out = {"load_s": time.perf_counter() - t0, "runs": {}}
        with np.load(os.path.join(tmp, "inputs.npz")) as z:
            inp = {k: z[k] for k in z.files}
        meshes = {}
        for tag, (shape, kind, batch, changes) in SHARDED_RUNS.items():
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            cfg = EngineConfig(mode="exact", cap_boundary=0.5,
                               max_level=MAX_LEVEL, **changes)
            pts = torch.from_numpy(inp[f"{batch}_xy"]).cuda()
            if kind == "engine":
                eng = GeoEngine.from_index_set(idx, "fast", cfg)

                def run():
                    r = eng.assign_sharded(pts, mesh)
                    return r.state, r.county, r.block, r.stats.as_dict()
            else:
                sidx = idx.sharded_index(shape[-1])

                def run():
                    *ids, st = assign_fast_distributed(sidx, pts, mesh,
                                                       cfg.fast_cfg())
                    return (*ids, {k: int(v) for k, v in st.items()})
            run()                       # warm-up: the shard's copy to cuda
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            *ids, stats = run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            got = [t.cpu().numpy() for t in ids]
            out["runs"][tag] = dict(
                ids_equal=all(np.array_equal(g, inp[f"{batch}_{f}"])
                              for g, f in zip(got, ("state", "county",
                                                    "block"))),
                minus1=int((got[2] < 0).sum()), stats=stats,
                launches=launches, seconds=dt, pts_per_s=len(pts) / dt,
                peak_bytes=torch.cuda.max_memory_allocated(),
                index_bytes_per_shard=idx.sharded[
                    shape[-1]].index_bytes_per_shard(),
                coords=mesh.coords, route=mesh.route)
        out["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_sharded(tmp) -> list:
    """SHARDED_RANKS ``sharded_rank`` processes (``spawn_ranks``)."""
    return spawn_ranks(sharded_rank, SHARDED_RANKS, SHARDED_TIMEOUT_S, tmp,
                       "sharded")


def sharded_ranges() -> tuple:
    """``profile_busy`` ranges over the sharded path's parts: the routing
    plan, its slot tables, the shard-local lookup and, inside it, the
    candidate resolution."""
    from repro_torch.core import distributed, strategies
    return ((strategies, "plan_routes", "plan"),
            (strategies, "slot_tables", "slot tables"),
            (strategies, "local_lookup", "local lookup"),
            (distributed, "resolve_candidates", "resolve (in the lookup)"))


def sharded_phase(smoke, engines, census, cov, xy, pts, ids, result):
    """Phase 13: the Morton-sharded lookup (see the module docstring)."""
    import torch.distributed as dist
    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.core.compact import capacity_for
    from repro_torch.core.distributed import shard_covering
    from repro_torch.core.fast import np_quantize_codes
    from repro_torch.launch.mesh import make_mesh
    out = {}
    # -- a. one NCCL rank, a (1, 1) mesh, 2^24 points ------------------------
    dist.init_process_group("nccl", init_method=free_addr(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        runs = {"sharded": engines["fast"],
                "sharded_fused": engines["fast_fused"]}
        out["one_rank"] = {}
        for name, eng in runs.items():
            kernels = ENGINE_KERNELS["fast_fused" if "fused" in name
                                     else "fast"]
            # Each kernel call held against its twin as it runs (the
            # twins launch nothing, so the counts are the kernels').
            with smoke.capture(keep=()) as cap:
                smoke.build.reset_launches()
                res = eng.assign_sharded(pts, mesh)
                torch.cuda.synchronize()
                launches = launched_only(smoke, name, kernels)
            checked = {k: v for k, v in cap.checked.items() if v["calls"]}
            for kname, c in checked.items():
                check(c["max_abs_err"] == 0, f"{kname} differs from its "
                      f"twin (max abs err {c['max_abs_err']}) on {name}")
            same_ids(res, ids["fast"], f"{name} (1, 1) vs fast exact")
            st = res.stats.as_dict()
            check(st["n_dropped"] == 0 and st["overflow"] == 0,
                  f"{name}: dropped or overflowed: {st}")
            check(st["n_boundary"] == result["stats"]["fast"]["n_boundary"],
                  f"{name}: n_boundary {st['n_boundary']} differs from "
                  f"fast's")
            ts, dev = [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(TIMED_BATCHES):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                eng.assign_sharded(pts, mesh)
                end.record()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
                dev.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated()
            prof = profile_busy(lambda: eng.assign_sharded(pts, mesh),
                                ranges=sharded_ranges())
            out["one_rank"][name] = dict(
                launches=launches, checked=checked, stats=st,
                peak_bytes=peak,
                pts_per_s=N_MAIN / float(np.median(ts)),
                batch_device_ms=float(np.median(dev)), host_ms=ts,
                profile=prof)
            base = "fast_fused" if "fused" in name else "fast"
            base_peak = result.get("peak_bytes", {}).get(base)
            print(f"sharded (1, 1), one NCCL rank: {name}: "
                  f"{out['one_rank'][name]['pts_per_s']:.4g} pts/s (median "
                  f"of {TIMED_BATCHES} batches of {N_MAIN}: host "
                  f"{[round(t * 1e3, 3) for t in ts]} ms, CUDA events "
                  f"{[round(t, 3) for t in dev]} ms) vs {base} "
                  f"{result['pts_per_s'][base]:.4g} pts/s; launches "
                  f"{launches}, each call == twin as it ran ("
                  + ", ".join(f"{k}: {c['calls']} calls, {c['rows']} rows"
                              for k, c in checked.items())
                  + f"); ids == fast exact; stats {st}; peak "
                  f"{peak / 2**30:.2f} GiB (the {base} path's: "
                  f"{base_peak / 2**30 if base_peak else float('nan'):.2f}"
                  f" GiB); profiled: wall {prof['wall_ms']:.2f} ms, device "
                  f"{prof['device_ms']:.2f} ms, busy {prof['busy']:.1%}, "
                  f"{prof['launches']} launches; device ms by part "
                  f"{ {k: round(v[0], 2) for k, v in prof['ranges'].items()} }"
                  f"; top kernels "
                  f"{[(k, round(ms, 2), n) for k, ms, n in prof['top']]}")
        # The reference of the ranks' counters: (1, 1) on their points.
        ref = engines["fast"].assign_sharded(pts[:SHARDED_N], mesh)
        ref_stats = ref.stats.as_dict()
    finally:
        dist.destroy_process_group()
    # -- inputs of the ranks: the host map, 2^22 points, a skewed batch -----
    sidx = shard_covering(cov, census, SHARDED_RANKS, device="cpu")
    owner = np.clip(np.searchsorted(
        sidx.range_lo.numpy(), np_quantize_codes(sidx.quant.numpy(),
                                                 MAX_LEVEL, xy),
        side="right") - 1, 0, SHARDED_RANKS - 1)
    rng = np.random.default_rng(SHARDED_SEED)
    n = SHARDED_SKEW_N
    pick = np.concatenate([
        rng.choice(np.flatnonzero(owner == SHARDED_SKEW_SHARD), 3 * n // 4,
                   replace=False),
        rng.choice(np.flatnonzero(owner != SHARDED_SKEW_SHARD), n // 4,
                   replace=False)])
    rng.shuffle(pick)
    capacity = capacity_for(n, SHARDED_DROP_CAP / SHARDED_RANKS)
    rank_in_shard = np.zeros(n, np.int64)
    for s in range(SHARDED_RANKS):
        rows = np.flatnonzero(owner[pick] == s)
        rank_in_shard[rows] = np.arange(len(rows))
    dropped = rank_in_shard >= capacity
    want = [t.cpu().numpy() for t in ids["fast"]]
    inputs = {"main_xy": xy[:SHARDED_N], "skew_xy": xy[pick]}
    for f, w in zip(("state", "county", "block"), want):
        inputs[f"main_{f}"] = w[:SHARDED_N]
        inputs[f"skew_{f}"] = np.where(dropped, -1, w[pick])
    with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
        GeoIndexSet(census=census, covering=cov, max_level=MAX_LEVEL,
                    device="cpu").save(os.path.join(tmp, "map"))
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        t0 = time.perf_counter()
        ranks = spawn_sharded(tmp)
        out["spawn_s"] = time.perf_counter() - t0
    # -- b-d. the ranks' checks ---------------------------------------------
    for r, got in enumerate(ranks):
        for tag, (shape, kind, batch, changes) in SHARDED_RUNS.items():
            run = got["runs"][tag]
            what = f"sharded rank {r} {tag}"
            kernels = ENGINE_KERNELS["fast_fused" if changes.get("fused")
                                     else "fast"]
            check(set(run["launches"]) == set(kernels),
                  f"{what}: launches {run['launches']}, expected only "
                  f"{kernels}")
            check(run["ids_equal"], f"{what}: ids differ from the expected "
                                    f"(fast exact; -1 where dropped)")
            check(run["coords"] == dict(zip(("data", "model"),
                                            np.unravel_index(r, shape))),
                  f"{what}: coordinates {run['coords']} not row-major")
            st = run["stats"]
            if batch == "skew":
                check(st["n_dropped"] == int(dropped.sum()) > 0
                      and run["minus1"] == int(dropped.sum()),
                      f"{what}: n_dropped {st['n_dropped']}, -1 ids "
                      f"{run['minus1']}, expected {int(dropped.sum())}")
                continue
            check(st.get("n_dropped", 0) == 0 and st["overflow"] == 0,
                  f"{what}: dropped or overflowed: {st}")
            for key in ("n_boundary", "n_pip"):
                check(st[key] == ref_stats[key],
                      f"{what}: {key} {st[key]} differs from the (1, 1) "
                      f"run's {ref_stats[key]}")
    out["ranks"] = ranks
    out["reference_stats"] = ref_stats
    out["dropped"] = int(dropped.sum())
    result["sharded"] = out
    print(f"sharded, {SHARDED_RANKS} gloo ranks time-sharing one card (the "
          f"processes share cuda:0, so their pts/s is no scaling figure): "
          f"spawn + runs {out['spawn_s']:.2f} s; route of the collectives: "
          f"{ {r['runs'][t]['route'] for r in ranks for t in r['runs']} } "
          f"('direct': CUDA tensors handed to gloo; 'host': staged through "
          f"the host); n_boundary / n_pip == the (1, 1) run's on the same "
          f"{SHARDED_N} points ({ref_stats['n_boundary']} / "
          f"{ref_stats['n_pip']})")
    for tag, (shape, kind, batch, changes) in SHARDED_RUNS.items():
        per = [r["runs"][tag] for r in ranks]
        print(f"  {tag} ({kind} on mesh {shape}, {batch} batch"
              f"{', ' + str(changes) if changes else ''}): ids == expected "
              f"on every rank; launches {per[0]['launches']}; stats "
              f"{per[0]['stats']}; pts/s by rank "
              f"{[round(p['pts_per_s']) for p in per]}; index bytes per "
              f"shard {per[0]['index_bytes_per_shard']}; peak device memory "
              f"by rank (GiB) "
              f"{[round(p['peak_bytes'] / 2**30, 3) for p in per]}")
    print(f"  drops: cap_shard {SHARDED_DROP_CAP} on {SHARDED_SKEW_N} points "
          f"(3/4 in Morton shard {SHARDED_SKEW_SHARD}), capacity "
          f"{capacity} a shard: n_dropped {out['dropped']} == the host's "
          f"count, and the -1 ids are exactly the points past each shard's "
          f"first {capacity} in input order")


# -- phase 14: the model half of distributed ----------------------------------
@contextlib.contextmanager
def moe_dropped():
    """Each MoE layer's ``dropped`` (its ``aux``, the whole batch's) inside
    the block, in call order."""
    from repro_torch.models import transformer as tf
    seen, real = [], tf.moe_ffn

    def rec(*args, **kw):
        y, aux = real(*args, **kw)
        seen.append(int(aux["dropped"]))
        return y, aux
    tf.moe_ffn = rec
    try:
        yield seen
    finally:
        tf.moe_ffn = real


def checksums(tensors: dict, shardings=None) -> dict:
    """{name: an int64 checksum of the tensor's f32 bits}: the sum over its
    elements of bits * (1 + index along dim 0) * (1 + index along the last
    dim), wrapping mod 2^64.  With ``shardings`` the tensors are this
    rank's blocks: each sums its elements at their global indices and the
    sums are added over the axes the tensor is split on (integer sums: the
    same whatever the split)."""
    from repro_torch.sharding.rules import shard_slices
    out = {}
    for name, t in tensors.items():
        bits = t.detach().contiguous().view(torch.int32).to(torch.int64)
        if bits.dim():
            sh = shardings[name] if shardings else None
            if sh is not None:
                full = [d * math.prod(sh.mesh.shape[a] for a in (
                    () if p is None else (p,) if isinstance(p, str) else p))
                    for d, p in zip(bits.shape, tuple(sh.spec) + (None,) * (
                        bits.dim() - len(sh.spec)))]
                sl = shard_slices(full, sh.spec, sh.mesh)
            else:
                sl = [slice(0, d) for d in bits.shape]
            dev = bits.device

            def weight(dim):
                w = torch.arange(bits.shape[dim], dtype=torch.int64,
                                 device=dev) + (sl[dim].start or 0) + 1
                return w.reshape([-1] + [1] * (bits.dim() - 1 - dim))
            bits = bits * weight(0)
            if bits.dim() > 1:
                bits = bits * weight(bits.dim() - 1)
        total = bits.sum().reshape(1)
        if shardings and shardings[name] is not None:
            sh = shardings[name]
            axes = tuple(a for p in sh.spec if p is not None
                         for a in ((p,) if isinstance(p, str) else p))
            if axes:
                total = sh.mesh.psum(total, axes)
        out[name] = int(total.item())
    return out


def state_checksums(params, opt, shardings=None) -> dict:
    """``checksums`` of a training state (params, AdamW's m / v, step)."""
    sh = shardings or {}
    out = {f"params/{k}": v for k, v in checksums(
        params, sh.get("params")).items()}
    for tag in ("m", "v"):
        out.update({f"opt/{tag}/{k}": v for k, v in checksums(
            getattr(opt, tag), sh.get("params")).items()})
    out["opt/step"] = int(opt.step)
    return out


def tree_bytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


@contextlib.contextmanager
def held_tree():
    """What the steps that gather block by block
    (``runtime.steps.PerBlock``) hold of their compute tree inside the
    block: ``step_bytes``, the leaves outside the stacks (gathered once a
    step); ``block_bytes``, the largest stacked block's leaves as gathered;
    ``most``, their sum, the most compute-tree bytes held at once;
    ``blocks``, the blocks gathered; ``overlap``, the most stacked blocks
    whose gathered copies (new tensors, not the rank's blocks) were alive
    at once, by weakrefs, checked at each gather."""
    import types
    import weakref

    from repro_torch.runtime import steps
    rec = types.SimpleNamespace(step_bytes=0, block_bytes=0, blocks=0,
                                overlap=0, most=0)
    alive = []
    real_step, real_call = steps.PerBlock.step_tree, steps.PerBlock.__call__

    def step_tree(self):
        tree = real_step(self)
        rec.step_bytes = max(rec.step_bytes, tree_bytes(tree))
        return tree

    def call(self, block):
        nonlocal alive
        out = real_call(self, block)
        leaves = _tensors(out)
        rec.block_bytes = max(rec.block_bytes, sum(
            t.numel() * t.element_size() for t in leaves))
        rec.blocks += 1
        mine = {t.untyped_storage()._cdata for t in self.params.values()}
        alive = [(b, r) for b, r in alive if r() is not None] + [
            (id(block), weakref.ref(t if t._base is None else t._base))
            for t in leaves if t.untyped_storage()._cdata not in mine]
        rec.overlap = max(rec.overlap, len({b for b, _ in alive}))
        rec.most = rec.step_bytes + rec.block_bytes
        return out
    steps.PerBlock.step_tree, steps.PerBlock.__call__ = step_tree, call
    try:
        yield rec
    finally:
        steps.PerBlock.step_tree, steps.PerBlock.__call__ = real_step, \
            real_call


def kv_bytes(cache: dict, keys=("k", "v")) -> int:
    """The bytes of a cache's k / v leaves (``keys``)."""
    return tree_bytes({k: cache[k] for k in keys})


# The kv leaves of the cross-attention families' caches.
XATTN_KV = {"vlm": ("k", "v", "img_k", "img_v"),
            "encdec": ("k", "v", "cross_k", "cross_v")}


def mesh_xattn_cfg(arch):
    """Phase 14 (d) / (e)'s config: the vlm cut to VLM_GROUPS groups, the
    encdec whole."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.family == "vlm":
        cfg = dataclasses.replace(
            cfg, n_layers=VLM_GROUPS * cfg.cross_attn_every)
    return cfg


def gathered_layout(params, shardings) -> dict:
    """The layout before tensor parallelism (every leaf but the experts
    gathered whole over the mesh), leaf by leaf, each in pieces of at most
    GATHER_PIECE_BYTES gathered along a dimension the leaf's spec leaves
    whole, each piece freed before the next (a card shared by four ranks
    beside the main process holds no four whole vlms, nor four of its
    3.9 GiB f32 embeddings at once): its bytes and the gathers'
    seconds."""
    from repro_torch.runtime import steps
    nbytes, t0 = 0, time.perf_counter()
    for name, x in params.items():
        sh = shardings[name]
        split = [p for p in sh.spec if p is not None]
        whole = x.numel() * x.element_size() * math.prod(
            sh.mesh.shape[a] for p in split
            for a in ((p,) if isinstance(p, str) else p))
        free = [d for d in range(x.dim())
                if d >= len(sh.spec) or sh.spec[d] is None]
        pieces = (x.chunk(max(1, min(x.shape[free[0]],
                                     -(-whole // GATHER_PIECE_BYTES))),
                          free[0]) if free else (x,))
        for piece in pieces:
            t = steps._compute_tree({name: piece.contiguous()},
                                    {name: sh}, ())
            nbytes += tree_bytes(t)
            del t
    torch.cuda.synchronize()
    return dict(gather_s=time.perf_counter() - t0, tree_bytes=nbytes)


def xattn_flash_calls(cfg, b_loc, seq, m) -> list:
    """(causal, [BH, S, D]) of each flash call of a rank's prefill: the
    vlm's self layers causal, the encdec's encoder full then its decoder
    causal, each at this rank's heads."""
    shape = (b_loc * cfg.n_heads // m, seq, cfg.hd)
    if cfg.family == "vlm":
        n_self = cfg.n_layers // cfg.cross_attn_every * (
            cfg.cross_attn_every - 1)
        return [(True, shape)] * n_self
    return [(False, shape)] * cfg.enc_layers + [(True, shape)] * cfg.n_layers


def mesh_xattn_rank(smoke, ref, rank, tmp):
    """Phase 14 (d) and (e) on one rank: each cross-attention arch's
    ``make_prefill_step`` on MESH_XATTN_SHAPE, tensor-parallel over
    "model", and its token loop on this rank's block of the caches."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import init_sharded, model_shardings
    mesh = make_mesh(MESH_XATTN_SHAPE, ("data", "model"))
    m = mesh.shape["model"]
    out = {}
    for tag, arch, b, seq in MESH_XATTN:
        cfg = mesh_xattn_cfg(arch)
        model = build_model(cfg, "meta")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        shardings = model_shardings(model, mesh)
        # One rank draws at a time: ``init_sharded`` draws each stacked
        # leaf whole in f32 (7 GiB for the vlm's FFN leaves), and four
        # such draws beside the blocks overflow the one card.
        for r in range(MESH_RANKS):
            if r == rank:
                params = init_sharded(model, shardings, torch.Generator(
                    device="cuda").manual_seed(XATTN_SEED), "cuda")
                torch.cuda.empty_cache()
            dist.barrier()
        if cfg.family == "vlm":
            draw_gates([(params[f"groups.{g}.cross.gate"],
                         params[f"groups.{g}.cross.ffn_gate"])
                        for g in range(len(model.groups))])
        block_bytes = tree_bytes(params)
        gathered = gathered_layout(params, shardings)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tree = steps.compute_params(model, params, mesh)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        stub = "img" if cfg.family == "vlm" else "frames"
        batch = {"tokens": torch.from_numpy(ref[f"{tag}_tokens"]).cuda(),
                 stub: torch.from_numpy(ref[f"{tag}_{stub}"]).cuda().view(
                     torch.bfloat16)}
        run = serve_mod.run_config(seq)
        step = steps.make_prefill_step(model, run, mesh)
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        with smoke.capture(keep=["flash_attn_bhsd"]) as cap, \
                dryrun.counted_collectives() as tally:
            last = step(tree, batch)
            torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
        routes = dict(smoke.build.ROUTE_LAUNCHES)
        calls = cap.calls["flash_attn_bhsd"]
        want = xattn_flash_calls(cfg, b, seq, m)
        for kname, n in counts.items():
            check((n > 0) == (kname == "flash_attn_bhsd"),
                  f"mesh {tag} prefill: {kname} launched {n} times")
        got = [(kw["causal"], tuple(a[0].shape)) for a, kw, _ in calls]
        check(got == want and counts["flash_attn_bhsd"] == len(want)
              and routes.get("flash_attn_bhsd:wgmma") == len(want)
              and all(a[0].dtype == torch.bfloat16 for a, _, _ in calls),
              f"mesh {tag} prefill: flash calls {got} by route {routes}, "
              f"not {len(want)} wgmma calls {sorted(set(want))}")
        err = over = 0.0
        for args, kw, (o,) in calls:
            w, spread = smoke.twin("flash_attn_bhsd", args, kw)
            e, ov = flash_err(o, w, spread, f"mesh {tag} flash call")
            err, over = max(err, e), max(over, ov)
            del w, spread
        if rank == 0:
            # The first call of each kind, timed by the main process.
            firsts = {}
            for (q, k, v), kw, _ in calls:
                firsts.setdefault(kw["causal"], ([x.cpu() for x in (q, k, v)],
                                                 kw))
            torch.save({"calls": firsts, "b_loc": b},
                       os.path.join(tmp, f"mesh_{tag}_flash.pt"))
        del cap, calls
        check(bool(torch.isfinite(last).all())
              and last.shape == (b, cfg.vocab),
              f"mesh {tag} prefill: last logits {tuple(last.shape)} not "
              f"finite")
        diff = float((last.float().cpu() - torch.from_numpy(
            ref[f"{tag}_last"])).abs().max())
        timing = step_timing(lambda bt: step(tree, bt), batch, b * seq)
        unembed = tuple(tree["unembed.w"].shape)
        out[tag] = dict(
            coords=mesh.coords, routes=dict(mesh.routes),
            flash_launches=counts["flash_attn_bhsd"],
            flash_by_kind={kind: sum(c == causal for c, _ in want)
                           for kind, causal in (("full", False),
                                                ("causal", True))},
            flash_shapes=sorted(set(want)), flash_max_abs_err=err,
            flash_over=over, logits_vs_one=diff, unembed_shape=unembed,
            unembed_whole=unembed == (cfg.d_model, cfg.vocab),
            collectives=tally_of(tally),
            block_bytes=block_bytes, tree_bytes=tree_bytes(tree),
            gather_s=gather_s, gathered_layout=gathered,
            peak_total_bytes=torch.cuda.max_memory_allocated() - base,
            **timing)
        del last, batch
        out[tag]["serve"] = mesh_xattn_serve(smoke, model, mesh, tree, ref,
                                             tmp, tag, rank)
        del params, tree
    return out


def mesh_xattn_serve(smoke, model, mesh, tree, ref, tmp, tag, rank):
    """Phase 14 (d) / (e)'s token loop on this rank through
    ``make_serve_step`` (timed; no kernel of the eight launched) on its
    block of the caches (its rows and kv heads, ``local_cache``; its kv
    bytes beside one process's), fed the tokens one process was fed; on
    rank 0 each step's last logits (gathered over the vocab, as the step
    gathers them for its argmax) held against one process's after the
    loop."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime import steps
    b, s, gen = MESH_SERVE
    n_steps = s + gen - 1
    feed = torch.from_numpy(ref[f"{tag}_serve_feed"]).cuda()
    run = serve_mod.run_config(s)
    step = steps.make_serve_step(model, run, mesh)
    keys = XATTN_KV[tag]
    cache = steps.local_cache(model, mesh, b, s + gen, "cuda")
    cache_bytes = kv_bytes(cache, keys)
    seen, real = [], steps._last_row

    def last_row(model_, view, logits):
        last = real(model_, view, logits)
        check(last.shape[0] == b, f"mesh {tag} serve: rows split over "
                                  f"{view.batch_axes}")
        if rank == 0:
            seen.append(last)
        return last
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    steps._last_row = last_row
    try:
        t0 = time.perf_counter()
        for t in range(n_steps):
            _, cache = step(tree, feed[:, t:t + 1], cache)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        steps._last_row = real
    launched = {k: v for k, v in smoke.build.LAUNCHES.items() if v}
    check(not launched, f"mesh {tag} serve: kernels launched {launched}")
    errs = []
    if rank == 0:
        want = np.load(os.path.join(tmp, f"{tag}_serve_logits.npy"),
                       mmap_mode="r")
        check(len(seen) == n_steps, f"mesh {tag} serve: {len(seen)} steps")
        errs = [float((got.float().cpu() - torch.from_numpy(
            np.array(want[t]))).abs().max()) for t, got in enumerate(seen)]
    one = kv_bytes(model.cache_specs(b, s + gen), keys)
    return dict(cache_bytes=cache_bytes, cache_bytes_one=one,
                cache_shapes={k: list(cache[k].shape) for k in keys},
                step_max_abs_err=errs, steps=n_steps,
                ms_a_step=dt * 1e3 / n_steps, tok_s=b * n_steps / dt)


def mesh_moe_rank(smoke, ref, rank, tmp):
    """Phase 14a on one rank: Mixtral's prefill on each of MESH_SHAPES,
    tensor-parallel over "model", from the rank's blocks (the step
    gathers a block at a time), and the token loop on (1, 4) on the
    compute tree gathered once."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import init_sharded, model_shardings
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    model = build_model(cfg, "meta")
    run = serve_mod.run_config(MESH_MOE_SEQ)
    toks = torch.from_numpy(ref["moe_tokens"]).cuda()
    out = {}
    for shape in MESH_SHAPES:
        tag = "x".join(map(str, shape))
        mesh = make_mesh(shape, ("data", "model"))
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        shardings = model_shardings(model, mesh)
        params = init_sharded(model, shardings, torch.Generator(
            device="cuda").manual_seed(MOE_SEED), "cuda")
        block_bytes = tree_bytes(params)
        # The gathered layout (every leaf but the experts whole over
        # "model", as before tensor parallelism), timed and measured
        # beside the tensor-parallel one.
        gathered = gathered_layout(params, shardings)
        torch.cuda.empty_cache()
        # The whole compute tree, every leaf at once (the token loop's,
        # gathered once for its steps), beside what the step holds.
        t0 = time.perf_counter()
        tree = steps.compute_params(model, params, mesh)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        whole_tree = tree_bytes(tree)
        del tree
        step = steps.make_prefill_step(model, run, mesh)
        # The rows this rank routes: the whole batch on (1, 4), its half
        # on (2, 2); routed as the one-process forward of those rows.
        rows = "full" if shape[0] == 1 else f"half{mesh.coords['data']}"
        force = [(torch.from_numpy(ref[f"moe_{rows}_ids{i}"]),
                  torch.from_numpy(ref[f"moe_{rows}_gap{i}"]))
                 for i in range(cfg.n_layers)]
        log = RouteLog()
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        # The first step call's collectives by kind, its gathers included
        # (phase 15 holds the dry-run's count against them).
        with smoke.capture(keep=["flash_attn_bhsd"]) as cap, \
                log.record(force) as rc, moe_dropped() as dropped, \
                dryrun.counted_collectives() as step_tally, \
                held_tree() as held:
            last = step(params, {"tokens": toks})
            torch.cuda.synchronize()
        check(held.overlap <= 1 and held.blocks == cfg.n_layers,
              f"mesh {tag} prefill: {held.blocks} blocks gathered, up to "
              f"{held.overlap} held at once")
        collectives = step_collectives = tally_of(step_tally)
        counts = dict(smoke.build.LAUNCHES)
        routes = dict(smoke.build.ROUTE_LAUNCHES)
        b_loc = MESH_MOE_BATCH // shape[0]
        # Each rank's block of heads (tensor-parallel over "model").
        bhsd = (b_loc * cfg.n_heads // shape[1], MESH_MOE_SEQ, cfg.hd)
        calls = cap.calls["flash_attn_bhsd"]
        if rank == 0 and shape == (1, 4):
            # The path's first call, timed by the main process.
            (q, k, v), kw, _ = calls[0]
            torch.save({"qkv": [x.cpu() for x in (q, k, v)], "kw": kw,
                        "b_loc": b_loc}, os.path.join(tmp, "mesh_flash.pt"))
        for kname, n in counts.items():
            check((n > 0) == (kname == "flash_attn_bhsd"),
                  f"mesh {tag} prefill: {kname} launched {n} times")
        check(counts["flash_attn_bhsd"] == cfg.n_layers == len(calls)
              and routes.get("flash_attn_bhsd:wgmma") == cfg.n_layers
              and all(a[0].shape == bhsd and a[0].dtype == torch.bfloat16
                      for a, _, _ in calls),
              f"mesh {tag} prefill: flash launches {routes}, not "
              f"{cfg.n_layers} wgmma calls at {bhsd}")
        err = over = 0.0
        for args, kw, (o,) in calls:
            want, spread = smoke.twin("flash_attn_bhsd", args, kw)
            e, ov = flash_err(o, want, spread, f"mesh {tag} flash call")
            err, over = max(err, e), max(over, ov)
            del want, spread
        del cap, calls
        flips = route_flips(force, rc, f"mesh {tag} vs one process")
        check(bool(torch.isfinite(last).all())
              and last.shape == (MESH_MOE_BATCH, cfg.vocab),
              f"mesh {tag} prefill: last logits {tuple(last.shape)} not "
              f"finite")
        # The peak of the timed forwards, the rank's blocks included.
        torch.cuda.synchronize()
        held_before = torch.cuda.memory_allocated() - base
        timing = step_timing(lambda b: step(params, b), {"tokens": toks},
                             MESH_MOE_BATCH * MESH_MOE_SEQ)
        out[tag] = dict(
            coords=mesh.coords, routes=dict(mesh.routes),
            flash_launches=counts["flash_attn_bhsd"], flash_shape=bhsd,
            flash_max_abs_err=err, flash_over=over, near_tie_flips=flips,
            dropped=sum(dropped), block_bytes=block_bytes,
            tree_bytes=held.most, step_tree_bytes=held.step_bytes,
            largest_block_bytes=held.block_bytes,
            whole_tree_bytes=whole_tree, gather_s=gather_s,
            collectives=collectives,
            step_collectives=step_collectives,
            gathered_layout=gathered,
            peak_total_bytes=held_before + timing["peak_bytes"],
            last=last.float().cpu().numpy().tolist()
            if rank == 0 else None, **timing)
        if shape == (1, 4):
            tree = steps.compute_params(model, params, mesh)
            out["serve"] = mesh_serve(smoke, model, run, mesh, tree, ref)
            del tree
        del params, last
    return out


def mesh_serve(smoke, model, run, mesh, tree, ref):
    """Phase 14a's token loop on this rank through ``make_serve_step`` (no
    kernel of the eight launched) on its block of the cache (its rows and
    kv heads, ``local_cache``; its k / v bytes beside one process's), fed
    the tokens one process was fed (its prompts, then its greedy tokens):
    once timed, then once routed as one process routed, this rank's
    vocab block of each step's last logits held against the same block
    of one process's.
    ``first_difference`` is the first value of that second pass that is
    not one process's bit for bit, in the order a step computes them
    (per layer: ``moe_ffn``'s input, i.e. after the attention; this
    rank's expert buckets; their SwiGLU outputs; ``moe_ffn``'s output
    after the psum; then the hidden state before the final norm, and the
    logits).  Where it is an expert output from equal buckets, the same
    products are rerun batched over all E experts, as one process runs
    them, and compared with one process's bits.  ``first_logits`` is the
    first step whose logits differ though every value before them is
    equal; there the unembedding is rerun on a contiguous copy of its
    weight block."""
    from repro_torch.models import moe
    from repro_torch.runtime import steps
    b, s, gen = MESH_SERVE
    n_steps = s + gen - 1
    feed = torch.from_numpy(ref["serve_feed"]).cuda()
    force = list(zip(torch.from_numpy(ref["serve_ids"]),
                     torch.from_numpy(ref["serve_gaps"])))
    step = steps.make_serve_step(model, run, mesh)

    cache_bytes = {}

    def loop():
        cache = steps.local_cache(model, mesh, b, s + gen, "cuda")
        cache_bytes["rank"] = kv_bytes(cache)
        toks = []
        for t in range(n_steps):
            nxt, cache = step(tree, feed[:, t:t + 1], cache)
            if t + 1 >= s:
                toks.append(nxt)
        return torch.cat(toks, 1)
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    toks = loop()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: v for k, v in smoke.build.LAUNCHES.items() if v}
    check(not launched, f"mesh serve: kernels launched {launched}")
    with RouteLog().record(force) as rc, op_log(model) as ops:
        loop()
    flips = route_flips(force, rc, "mesh serve vs one process")
    # This rank's vocab block of the logits, beside the same block of one
    # process's.
    got = torch.stack(ops["logits"])
    v_lo = mesh.coords["model"] * got.shape[-1]
    want_logits = torch.from_numpy(ref["serve_logits"][
        ..., v_lo:v_lo + got.shape[-1]]).cuda()
    step_err = (got - want_logits).abs().amax(dim=(1, 2)).cpu().numpy()
    want = {k: torch.from_numpy(ref[f"serve_{k}"]).view(torch.bfloat16)
            for k in ("moe_in", "moe_out", "buf", "h", "final")}
    n_layers = len(ops["moe_in"]) // n_steps
    e_loc = ops["experts"][0][1].shape[0]
    lo = mesh.coords["model"] * e_loc
    first = first_logits = None
    for t in range(n_steps):
        stages = []
        for layer in range(n_layers):
            c = t * n_layers + layer
            _, buf, h = ops["experts"][c]
            stages += [
                ("moe_in", layer, ops["moe_in"][c], want["moe_in"][c]),
                ("expert_buckets", layer, buf,
                 want["buf"][c, lo:lo + e_loc]),
                ("expert_outputs", layer, h, want["h"][c, lo:lo + e_loc]),
                ("moe_out", layer, ops["moe_out"][c], want["moe_out"][c])]
        stages += [("final", None, ops["final"][t], want["final"][t]),
                   ("logits", None, got[t], want_logits[t])]
        for op, layer, a, w in stages:
            w = w.to(a.device)
            if torch.equal(a, w):
                continue
            err = float((a.float() - w.float()).abs().max())
            if op == "logits":
                if first_logits is None:
                    xn, wu = ops["unembed"][t]
                    redo = (xn.float() @ wu.contiguous().float())[:, -1]
                    first_logits = dict(
                        step=t, max_abs_err=err,
                        weight_stride=list(wu.stride()),
                        contiguous_equals_one_process=bool(
                            torch.equal(redo, w)))
                break
            first = dict(step=t, layer=layer, op=op, max_abs_err=err)
            if op == "expert_outputs":
                wts, buf, _ = ops["experts"][t * n_layers + layer]
                n = want["buf"].shape[1] // e_loc
                batched = moe._expert_ffn(
                    *(torch.cat([x] * n) for x in wts),
                    torch.cat([buf] * n))[:e_loc]
                first["batched_equals_one_process"] = bool(
                    torch.equal(batched, w))
            break
        if first is not None:
            break
    del ops
    one_cache = kv_bytes(model.cache_specs(b, s + gen))
    return dict(tokens=toks.cpu().numpy().tolist(),
                cache_bytes=cache_bytes["rank"], cache_bytes_one=one_cache,
                step_max_abs_err=step_err.tolist(),
                first_logit_step=int(np.flatnonzero(step_err)[0])
                if step_err.any() else None,
                first_logits=first_logits, first_difference=first,
                near_tie_flips=flips,
                steps=n_steps, ms_a_step=dt * 1e3 / n_steps,
                tok_s=b * n_steps / dt)


def mesh_train_rank(smoke, ref, rank, tmp):
    """Phase 14b-c on one rank: Qwen's training steps on the (4,) data
    mesh, the state saved, its checksums, and its restore on (2, 2)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import local_shard, model_shardings
    cfg = get_config(LM_ARCH)
    run = train_mod.run_config(LM_ARCH, MESH_TRAIN_STEPS, MESH_TRAIN_SEQ,
                               remat="full")
    mesh = make_mesh((MESH_RANKS,), ("data",))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, params, opt, shardings = train_mod.setup_mesh(
        cfg, mesh, seed=TRAIN_SEED, device="cuda")
    step = steps.make_train_step(model, run, mesh)
    out = {"steps": []}
    for i in range(MESH_TRAIN_STEPS):
        batch = {k: torch.from_numpy(ref[f"train_{k}"][i]).cuda()
                 for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        smoke.build.reset_launches()
        t0 = time.perf_counter()
        with (smoke.capture(keep=[]) if i == 0
              else contextlib.nullcontext()) as cap:
            params, opt, m = step(params, opt, batch)
            loss = float(m["loss"])
        dt = time.perf_counter() - t0
        launches = dict(smoke.build.LAUNCHES)
        routes = dict(smoke.build.ROUTE_LAUNCHES)
        n_flash = 2 * cfg.n_layers       # forward + the remat recompute
        check(launches["flash_attn_bhsd"] == n_flash
              == routes.get("flash_attn_bhsd:wgmma")
              and sum(launches.values()) == n_flash,
              f"mesh train step {i}: launches {launches} {routes}, not "
              f"{n_flash} wgmma flash calls")
        rec = dict(step_s=dt, loss=loss, ce=float(m["ce"]),
                   grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                   flash_launches=launches["flash_attn_bhsd"])
        if cap is not None:
            c = cap.checked["flash_attn_bhsd"]
            check(c["calls"] == n_flash, f"mesh train: {c['calls']} flash "
                                         f"calls held against the twin")
            rec["flash_max_abs_err"] = c["max_abs_err"]
        out["steps"].append(rec)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["routes"] = dict(mesh.routes)
    # (c) the state saved from this mesh (rank 0 writes whole arrays).
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), async_save=False)
    t0 = time.perf_counter()
    mgr.save(MESH_TRAIN_STEPS, {"params": params, "opt": opt},
             shardings=shardings)
    mgr.wait()
    out["save_s"] = time.perf_counter() - t0
    out["sums"] = state_checksums(params, opt, shardings)
    del params, opt
    torch.cuda.empty_cache()
    # ... and restored on a (2, 2) mesh: each rank reads its blocks.
    mesh22 = make_mesh((2, 2), ("data", "model"))
    sh22 = model_shardings(model, mesh22)
    meta = dict(model.named_parameters())
    blocks = {k: torch.empty(local_shard(meta[k], s.spec, mesh22).shape,
                             dtype=torch.float32, device="cuda")
              for k, s in sh22.items()}
    opt22 = adamw.init(blocks)
    t0 = time.perf_counter()
    mgr.restore(MESH_TRAIN_STEPS, {"params": blocks, "opt": opt22},
                {"params": sh22, "opt": adamw.state_shardings(sh22)})
    torch.cuda.synchronize()
    out["restore_2x2_s"] = time.perf_counter() - t0
    out["sums_2x2"] = state_checksums(blocks, opt22, {"params": sh22})
    return out


@contextlib.contextmanager
def expert_buffers():
    """The shapes of the buffers each ``moe._expert_ffn`` call runs on
    inside the block, in call order."""
    from repro_torch.models import moe
    seen, real = [], moe._expert_ffn

    def rec(w_gate, w_up, w_down, buf):
        seen.append(tuple(buf.shape))
        return real(w_gate, w_up, w_down, buf)
    moe._expert_ffn = rec
    try:
        yield seen
    finally:
        moe._expert_ffn = real


def lb_bound(cfg, n_tokens, flips) -> float:
    """How far two runs' ``lb_loss`` may lie apart (tests/moe_pair.py's
    ``lb_tol``): 1e-3, plus 2 E / T for each choice routed otherwise."""
    return 1e-3 + 2 * cfg.n_experts * flips / n_tokens


def mesh_data_moe_rank(smoke, ref, rank):
    """Phase 14b's Mixtral on one rank of the (MESH_RANKS,) ("data",)
    mesh: (a)'s prefill from the rank's blocks, routed as one process's
    forward of the whole batch routed, and one train step routed as one
    process's step routed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import init_sharded, model_shardings
    mesh = make_mesh((MESH_RANKS,), ("data",))
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    model = build_model(cfg, "meta")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_sharded(model, model_shardings(model, mesh),
                          torch.Generator(device="cuda").manual_seed(
                              MOE_SEED), "cuda")
    step = steps.make_prefill_step(model, serve_mod.run_config(
        MESH_MOE_SEQ), mesh)
    toks = torch.from_numpy(ref["moe_tokens"]).cuda()
    force = [(torch.from_numpy(ref[f"moe_full_ids{i}"]),
              torch.from_numpy(ref[f"moe_full_gap{i}"]))
             for i in range(cfg.n_layers)]
    log = RouteLog()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    with smoke.capture(keep=[]) as cap, log.record(force) as rc, \
            moe_dropped() as dropped, expert_buffers() as bufs, \
            dryrun.counted_collectives() as tally:
        last = step(params, {"tokens": toks})
        torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = dict(smoke.build.LAUNCHES)
    c = cap.checked["flash_attn_bhsd"]
    check(launches["flash_attn_bhsd"] == cfg.n_layers == c["calls"]
          and sum(launches.values()) == cfg.n_layers,
          f"data mesh prefill: launches {launches}, not {cfg.n_layers} "
          f"flash calls")
    check(bool(torch.isfinite(last).all())
          and last.shape == (MESH_MOE_BATCH, cfg.vocab),
          f"data mesh prefill: last logits {tuple(last.shape)} not finite")
    out = dict(prefill=dict(
        flips=route_flips(force, rc, "data mesh prefill vs one process"),
        dropped=sum(dropped), buffers=bufs, fwd_s=fwd_s,
        flash_launches=launches["flash_attn_bhsd"],
        flash_max_abs_err=c["max_abs_err"], collectives=tally_of(tally),
        peak_bytes=torch.cuda.max_memory_allocated(),
        routes=dict(mesh.routes),
        last=last.float().cpu().numpy().tolist() if rank == 0 else None))
    del params, step, last, cap
    torch.cuda.empty_cache()
    # One train step, routed as one process's (1,) mesh step routed.
    layers, b, s = MESH_DATA_MOE_TRAIN
    tcfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=layers)
    trun = train_mod.run_config(MOE_ARCH, 1, s, remat="full")
    torch.cuda.reset_peak_memory_stats()
    tmodel, params, opt, _ = train_mod.setup_mesh(tcfg, mesh, seed=MOE_SEED,
                                                  device="cuda")
    batch = {k: torch.from_numpy(ref[f"moe_train_{k}"]).cuda()
             for k in ("tokens", "labels")}
    force = [(torch.from_numpy(ref[f"moe_train_ids{i}"]),
              torch.from_numpy(ref[f"moe_train_gap{i}"]))
             for i in range(int(ref["moe_train_calls"]))]
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    with smoke.capture(keep=[]) as cap, log.record(force) as rc, \
            expert_buffers() as bufs, \
            dryrun.counted_collectives() as tally:
        _, _, m = steps.make_train_step(tmodel, trun, mesh)(params, opt,
                                                            batch)
        metrics = {k: float(m[k]) for k in ("loss", "ce", "lb_loss",
                                            "dropped", "grad_norm")}
    launches = dict(smoke.build.LAUNCHES)
    c = cap.checked["flash_attn_bhsd"]
    check(launches["flash_attn_bhsd"] == 2 * layers == c["calls"]
          and sum(launches.values()) == 2 * layers,
          f"data mesh train: launches {launches}, not {2 * layers} flash "
          f"calls (forward + recompute)")
    out["train"] = dict(
        metrics, step_s=time.perf_counter() - t0,
        flips=route_flips(force, rc, "data mesh train vs one process"),
        buffers=bufs, flash_launches=launches["flash_attn_bhsd"],
        flash_max_abs_err=c["max_abs_err"], collectives=tally_of(tally),
        peak_bytes=torch.cuda.max_memory_allocated())
    del params, opt, m, cap
    torch.cuda.empty_cache()
    return out


def mesh_data_moe_checks(ranks, ref, out) -> None:
    """Phase 14b's Mixtral on the data mesh against one process's runs."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity_of
    cfg = get_config(MOE_ARCH)
    runs = [r["data_moe"]["prefill"] for r in ranks]
    n_tok = MESH_MOE_BATCH * MESH_MOE_SEQ
    cap = capacity_of(cfg, n_tok)
    c = -(-cap // MESH_RANKS)
    want = [(cfg.n_experts, c, cfg.d_model)] * MESH_MOE_LAYERS
    check(all(r["buffers"] == [list(w) for w in want] for r in runs),
          f"data mesh prefill: expert buffers {runs[0]['buffers']}, not "
          f"{want}")
    check(all(r["dropped"] == ref["full_dropped"] for r in runs),
          f"data mesh prefill: dropped {[r['dropped'] for r in runs]} vs one "
          f"process's {ref['full_dropped']}")
    got = np.asarray(runs[0]["last"])
    diff = float(np.abs(got - ref["full_last"]).max())
    same = bool(np.array_equal(got, ref["full_last"]))
    check(diff <= LOGIT_TOL, f"data mesh prefill: last logits {diff} from "
                             f"one process's (tol {LOGIT_TOL})")
    trains = [r["data_moe"]["train"] for r in ranks]
    one = ref["moe_train_one"]
    layers, b, s = MESH_DATA_MOE_TRAIN
    tcap = capacity_of(cfg, b * s)
    for t in trains:
        for key in ("loss", "ce"):
            check(abs(t[key] - one[key]) <= TRAIN_LOSS_ATOL,
                  f"data mesh train: {key} {t[key]} vs one process's "
                  f"{one[key]}")
        check(abs(t["lb_loss"] - one["lb_loss"])
              <= lb_bound(cfg, b * s, t["flips"]),
              f"data mesh train: lb_loss {t['lb_loss']} vs one process's "
              f"{one['lb_loss']} ({t['flips']} choices routed otherwise)")
        check(t["dropped"] == one["dropped"],
              f"data mesh train: dropped {t['dropped']} vs one process's "
              f"{one['dropped']}")
        check(set(map(tuple, t["buffers"])) == {
            (cfg.n_experts, -(-tcap // MESH_RANKS), cfg.d_model)},
              f"data mesh train: expert buffers {t['buffers']}")
    out["data_moe"] = dict(logits_vs_one=diff, bit_equal=same,
                           capacity=cap, slots_a_rank=c, prefill=[
                               {k: v for k, v in r.items() if k != "last"}
                               for r in runs], train=trains, train_one=one)
    print(f"phase 14: mixtral {MESH_MOE_LAYERS} of 32 layers on the "
          f"({MESH_RANKS},) ('data',) mesh, each rank's experts on its "
          f"{c} of every expert's {cap} slots (one global plan), "
          f"make_prefill_step over {MESH_MOE_BATCH} x {MESH_MOE_SEQ} from "
          f"the rank's blocks: last logits within {diff:.4g} of one "
          f"process's forward of the whole batch (tol {LOGIT_TOL}; "
          f"bit-equal {same}), dropped {runs[0]['dropped']} = one "
          f"process's, near-tie flips {[r['flips'] for r in runs]}, flash "
          f"x{runs[0]['flash_launches']} a rank (each == twin), s a "
          f"forward {[round(r['fwd_s'], 2) for r in runs]}, peak GiB "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in runs]}, routes "
          f"{runs[0]['routes']}; collectives (calls / MB by kind) "
          f"{collectives_line(runs)}")
    print(f"phase 14: mixtral {layers} layer, one make_train_step of {b} x "
          f"{s} on the ({MESH_RANKS},) data mesh (remat full; experts on "
          f"{-(-tcap // MESH_RANKS)} of {tcap} slots a rank): loss "
          f"{[round(t['loss'], 5) for t in trains]} / ce "
          f"{[round(t['ce'], 5) for t in trains]} / lb_loss "
          f"{[round(t['lb_loss'], 6) for t in trains]} / dropped "
          f"{[t['dropped'] for t in trains]} / grad norm "
          f"{[round(t['grad_norm'], 5) for t in trains]} vs one process's "
          f"(1,) mesh {one['loss']:.5f} / {one['ce']:.5f} / "
          f"{one['lb_loss']:.6f} / {one['dropped']} / "
          f"{one['grad_norm']:.5f}; near-tie flips "
          f"{[t['flips'] for t in trains]}, flash x"
          f"{trains[0]['flash_launches']} a rank, s a step "
          f"{[round(t['step_s'], 2) for t in trains]}, peak GiB "
          f"{[round(t['peak_bytes'] / 2**30, 2) for t in trains]}; "
          f"collectives {collectives_line(trains)}")


def mesh_tp_train_rank(smoke, ref):
    """Phase 14b' on one rank: Qwen1.5-0.5B at its published width, one
    ``make_train_step`` on a (2, 2) ("data", "model") mesh, tensor-
    parallel over "model" (remat "full"; 2 flash launches a layer a rank
    at [B_loc * H / 2, S, hd], each call held against the twin), on step
    0's batch, from the rank's blocks (the step gathers a block at a
    time, again in the remat recompute): its loss, ce and grad norm, the
    step's seconds, the blocks' bytes, the most compute-tree bytes held
    at once beside the whole tree's, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import model_shardings, tp_leaves
    cfg = get_config(LM_ARCH)
    run = train_mod.run_config(LM_ARCH, MESH_TRAIN_STEPS, MESH_TRAIN_SEQ,
                               remat="full")
    mesh = make_mesh((2, 2), ("data", "model"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, params, opt, _ = train_mod.setup_mesh(cfg, mesh, seed=TRAIN_SEED,
                                                 device="cuda")
    # The whole compute tree, every leaf at once, for its bytes.
    with torch.no_grad():
        tree = steps._compute_tree(steps.cast_params(params),
                                   model_shardings(model, mesh), ("data",),
                                   tp_leaves(model, mesh))
    tree_b = tree_bytes(tree)
    del tree
    step = steps.make_train_step(model, run, mesh)
    batch = {k: torch.from_numpy(ref[f"train_{k}"][0]).cuda()
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    with smoke.capture(keep=[]) as cap, \
            dryrun.counted_collectives() as tally, held_tree() as held:
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
    dt = time.perf_counter() - t0
    check(held.overlap == 1 and held.blocks == 2 * cfg.n_layers,
          f"mesh TP train step: {held.blocks} blocks gathered (forward and "
          f"recompute), up to {held.overlap} held at once")
    launches = dict(smoke.build.LAUNCHES)
    routes = dict(smoke.build.ROUTE_LAUNCHES)
    n_flash = 2 * cfg.n_layers            # forward + the remat recompute
    shape = (MESH_TRAIN_BATCH // 2 * cfg.n_heads // 2, MESH_TRAIN_SEQ,
             cfg.hd)
    c = cap.checked["flash_attn_bhsd"]
    check(launches["flash_attn_bhsd"] == n_flash
          == routes.get("flash_attn_bhsd:wgmma") == c["calls"]
          and sum(launches.values()) == n_flash
          and c["rows"] == n_flash * shape[0],
          f"mesh TP train step: launches {launches} {routes}, {c['rows']} "
          f"rows, not {n_flash} wgmma flash calls at {shape}")
    return dict(step_s=dt, loss=loss, ce=float(m["ce"]),
                grad_norm=float(m["grad_norm"]),
                flash_launches=launches["flash_attn_bhsd"],
                flash_shape=shape, flash_max_abs_err=c["max_abs_err"],
                block_bytes=tree_bytes(params), tree_bytes=held.most,
                whole_tree_bytes=tree_b,
                peak_bytes=torch.cuda.max_memory_allocated(),
                collectives=tally_of(tally),
                routes=dict(mesh.routes), coords=mesh.coords)


def mesh_rank(rank, addr, tmp):
    """Phase 14 on one of MESH_RANKS gloo ranks sharing cuda:0 (a spawned
    process); writes ``rank{rank}.json``."""
    from datetime import timedelta

    import torch.distributed as dist
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, rank=rank,
                            world_size=MESH_RANKS,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        smoke = Smoke()
        with np.load(os.path.join(tmp, "ref.npz")) as z:
            ref = {k: z[k] for k in z.files}
        out = {"moe": mesh_moe_rank(smoke, ref, rank, tmp)}
        out["train"] = mesh_train_rank(smoke, ref, rank, tmp)
        out["data_moe"] = mesh_data_moe_rank(smoke, ref, rank)
        out["tp_train"] = mesh_tp_train_rank(smoke, ref)
        out["xattn"] = mesh_xattn_rank(smoke, ref, rank, tmp)
        out["last"] = mesh_last_rank(smoke, ref, rank, tmp)
        out["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n, timeout, tmp, what) -> list:
    """``n`` ``fn(rank, addr, tmp)`` processes (torch.multiprocessing,
    spawn), joined within ``timeout`` (a rank stuck in a collective is
    killed, never waited on); their ``rank{r}.json`` in rank order."""
    import torch.multiprocessing as torch_mp
    ctx = torch_mp.start_processes(fn, args=(free_addr(), tmp), nprocs=n,
                                   join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"{what}: the {n} gloo ranks did not finish within "
                  f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_references(smoke, tmp) -> dict:
    """Phase 14's one-process runs before the spawn: Mixtral's forward of
    the whole batch and of each half (logits, routing, dropped), its
    token loop (tokens and each step's top-2 margin), Qwen's step on a
    (1,) mesh; the inputs and references the ranks read, to
    ``tmp/ref.npz``.  Returns the numbers the checks need."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import make_source
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    model = serve_mod.load_model(cfg, seed=MOE_SEED, device="cuda")
    run = serve_mod.run_config(MESH_MOE_SEQ)
    toks = serve_mod.make_prompts(cfg, MESH_MOE_BATCH, MESH_MOE_SEQ,
                                  MOE_SEED, "cuda")
    ref, out = {"moe_tokens": toks.cpu().numpy()}, {}
    log = RouteLog()
    half = MESH_MOE_BATCH // 2
    for rows, sl in (("full", slice(None)), ("half0", slice(0, half)),
                     ("half1", slice(half, None))):
        with log.record() as rc, torch.inference_mode():
            logits, aux = model.forward(run, {"tokens": toks[sl]})
            out[f"{rows}_last"] = logits[:, -1].float().cpu().numpy()
            out[f"{rows}_dropped"] = int(aux["dropped"])
        del logits
        for i, (ids, gap) in enumerate(rc):
            ref[f"moe_{rows}_ids{i}"] = ids.numpy()
            ref[f"moe_{rows}_gap{i}"] = gap.numpy()
    b, s, gen = MESH_SERVE
    prompts = serve_mod.make_prompts(cfg, b, s, MOE_SEED + 1, "cuda")
    ref["serve_prompts"] = prompts.cpu().numpy()
    with torch.inference_mode(), log.record() as rc, \
            op_log(model) as ops:
        cache = model.init_cache(b, s + gen)
        tok, feed = prompts[:, :1], []
        for t in range(s + gen - 1):
            feed.append(tok)
            logits, cache = model.decode_step(run, tok, cache)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            tok = prompts[:, t + 1:t + 2] if t + 1 < s else nxt
    # What the ranks' loop is fed and held against: the tokens, each
    # router call (to route alike) and what ``op_log`` records.
    ref["serve_feed"] = torch.cat(feed, 1).cpu().numpy()
    ref["serve_ids"] = torch.stack([ids for ids, _ in rc]).numpy()
    ref["serve_gaps"] = torch.stack([gap for _, gap in rc]).numpy()
    ref["serve_logits"] = torch.stack(ops["logits"]).cpu().numpy()
    for k in ("moe_in", "moe_out", "final"):
        ref[f"serve_{k}"] = bf16_bits(torch.stack(ops[k]))
    ref["serve_buf"] = bf16_bits(torch.stack([x for _, x, _ in
                                              ops["experts"]]))
    ref["serve_h"] = bf16_bits(torch.stack([h for _, _, h in
                                            ops["experts"]]))
    out["serve_tokens"] = ref["serve_logits"][s - 1:].argmax(-1).T
    del model, cache, ops, logits
    torch.cuda.empty_cache()
    # Qwen: the global batches, and one process's first step on a (1,)
    # mesh (no process group; cast_params as the ranks' mesh casts).
    qcfg = get_config(LM_ARCH)
    src = make_source(qcfg, ShapeConfig("mesh_train", MESH_TRAIN_SEQ,
                                        MESH_TRAIN_BATCH, "train"),
                      seed=TRAIN_SEED, device="cpu")
    batches = [src.batch_at(i) for i in range(MESH_TRAIN_STEPS)]
    for k in ("tokens", "labels"):
        ref[f"train_{k}"] = np.stack([bt[k].numpy() for bt in batches])
    qrun = train_mod.run_config(LM_ARCH, MESH_TRAIN_STEPS, MESH_TRAIN_SEQ,
                                remat="full")
    one = Mesh((1,), ("data",))
    qmodel, params, opt, _ = train_mod.setup_mesh(qcfg, one, seed=TRAIN_SEED,
                                                  device="cuda")
    step = steps.make_train_step(qmodel, qrun, one)
    times = []
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, {k: batches[i][k].cuda()
                                     for k in ("tokens", "labels")})
        if i == 0:
            out["train_one"] = {k: float(m[k])
                                for k in ("loss", "ce", "grad_norm")}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["train_one"]["step_s"] = times
    del qmodel, params, opt, m
    torch.cuda.empty_cache()
    # Mixtral's train step on a (1,) mesh, its routing recorded.
    layers, b, s = MESH_DATA_MOE_TRAIN
    mcfg = dataclasses.replace(cfg, n_layers=layers)
    bt = make_source(mcfg, ShapeConfig("mesh_moe_train", s, b, "train"),
                     seed=MOE_SEED, device="cpu").batch_at(0)
    for k in ("tokens", "labels"):
        ref[f"moe_train_{k}"] = bt[k].numpy()
    mmodel, params, opt, _ = train_mod.setup_mesh(mcfg, one, seed=MOE_SEED,
                                                  device="cuda")
    with log.record() as rc:
        _, _, m = steps.make_train_step(mmodel, train_mod.run_config(
            MOE_ARCH, 1, s, remat="full"), one)(
                params, opt, {k: bt[k].cuda() for k in ("tokens", "labels")})
        out["moe_train_one"] = {k: float(m[k]) for k in (
            "loss", "ce", "lb_loss", "dropped", "grad_norm")}
    ref["moe_train_calls"] = np.array(len(rc))
    for i, (ids, gap) in enumerate(rc):
        ref[f"moe_train_ids{i}"] = ids.numpy()
        ref[f"moe_train_gap{i}"] = gap.detach().numpy()
    del mmodel, params, opt, m
    torch.cuda.empty_cache()
    xattn_references(ref, out, tmp)
    t0 = time.perf_counter()
    last_references(ref, out, tmp)
    out["last_references_s"] = time.perf_counter() - t0
    np.savez(os.path.join(tmp, "ref.npz"), **ref)
    return out


def xattn_references(ref, out, tmp) -> None:
    """Phase 14 (d) / (e)'s one-process runs: each cross-attention arch
    (``mesh_xattn_cfg``; the same weights the ranks draw, the vlm's gates
    drawn live) over its batch (``xattn_batch``): the forward's last
    logits; its token loop (MESH_SERVE: prompts from XATTN_SEED + 1, then
    its greedy tokens), each step's fed token and last logits (to
    ``tmp/{tag}_serve_logits.npy``), and its cache's kv bytes."""
    from repro_torch.launch import serve as serve_mod
    for tag, arch, b, seq in MESH_XATTN:
        cfg = mesh_xattn_cfg(arch)
        model = serve_mod.load_model(cfg, seed=XATTN_SEED, device="cuda")
        if cfg.family == "vlm":
            set_gates(model)
        batch = xattn_batch(cfg, b, seq)
        stub = "img" if cfg.family == "vlm" else "frames"
        ref[f"{tag}_tokens"] = batch["tokens"].cpu().numpy()
        ref[f"{tag}_{stub}"] = bf16_bits(batch[stub])
        run = serve_mod.run_config(seq)
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = model.forward(run, batch)[0]
            ref[f"{tag}_last"] = logits[:, -1].float().cpu().numpy()
        torch.cuda.synchronize()
        out[f"{tag}_forward_s"] = time.perf_counter() - t0
        del logits, batch
        bs, s, gen = MESH_SERVE
        prompts = serve_mod.make_prompts(cfg, bs, s, XATTN_SEED + 1, "cuda")
        sruns = serve_mod.run_config(s)
        feed, steps_logits = [], []
        with torch.inference_mode():
            cache = model.init_cache(bs, s + gen)
            out[f"{tag}_cache_bytes_one"] = kv_bytes(cache, XATTN_KV[tag])
            tok = prompts[:, :1]
            for t in range(s + gen - 1):
                feed.append(tok)
                logits, cache = model.decode_step(sruns, tok, cache)
                steps_logits.append(logits[:, -1].float().cpu())
                nxt = torch.argmax(logits[:, -1], dim=-1).to(
                    torch.int32)[:, None]
                tok = prompts[:, t + 1:t + 2] if t + 1 < s else nxt
        ref[f"{tag}_serve_feed"] = torch.cat(feed, 1).cpu().numpy()
        np.save(os.path.join(tmp, f"{tag}_serve_logits.npy"),
                torch.stack(steps_logits).numpy())
        del model, cache, logits, steps_logits
        torch.cuda.empty_cache()
    print(f"phase 14: one-process references done, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB left reserved on "
          f"the card", flush=True)


def mesh_xattn_timing(smoke, ranks, tmp) -> dict:
    """Flash at phase 14 (d) / (e)'s rank shapes, on rank 0's first call
    of each kind (``flash_row``: beside its twin, bound and SDPA)."""
    timing = {}
    for tag, _, _, _ in MESH_XATTN:
        saved = torch.load(os.path.join(tmp, f"mesh_{tag}_flash.pt"))
        for causal, (qkv, kw) in sorted(saved["calls"].items()):
            qkv = tuple(x.cuda() for x in qkv)
            fa = smoke.flash.flash_attn_bhsd(*qkv, **kw)
            kind = "causal" if causal else "full"
            timing[f"mesh_{tag}_{kind}"] = flash_row(
                smoke, [(qkv, kw, (fa,))],
                ranks[0]["xattn"][tag]["flash_by_kind"][kind],
                batch=saved["b_loc"],
                path=f"mesh {tag} prefill (1, 4), tensor-parallel, {kind}")
            del qkv, fa
    return timing


def mesh_xattn_checks(ranks, ref, out) -> None:
    """Phase 14 (d) / (e)'s checks on the ranks' records, against the
    one-process references (``xattn_references``), into ``out``."""
    m = MESH_XATTN_SHAPE[1]
    for tag, arch, b, seq in MESH_XATTN:
        cfg = mesh_xattn_cfg(arch)
        runs = [r["xattn"][tag] for r in ranks]
        diff = max(r["logits_vs_one"] for r in runs)
        check(diff <= LOGIT_TOL, f"mesh {tag}: last logits {diff} from the "
                                 f"one-process forward's (tol {LOGIT_TOL})")
        whole_vocab = cfg.vocab % m != 0
        check(all(r["unembed_whole"] == whole_vocab for r in runs),
              f"mesh {tag}: unembed.w a rank {runs[0]['unembed_shape']} "
              f"(vocab {cfg.vocab} on a {m}-way axis)")
        serves = [r["serve"] for r in runs]
        err = max(serves[0]["step_max_abs_err"])
        check(len(serves[0]["step_max_abs_err"]) == serves[0]["steps"]
              and err <= LOGIT_TOL,
              f"mesh {tag} serve: a step's logits {err} from one process's "
              f"(tol {LOGIT_TOL})")
        kv_split = cfg.n_kv_heads % m == 0
        check(all(x["cache_bytes"] * (m if kv_split else 1)
                  == ref[f"{tag}_cache_bytes_one"] for x in serves),
              f"mesh {tag} serve: kv cache bytes a rank "
              f"{[x['cache_bytes'] for x in serves]}, one process's "
              f"{ref[f'{tag}_cache_bytes_one']} ({cfg.n_kv_heads} kv heads "
              f"on a {m}-way 'model' axis)")
        out[tag] = dict(arch=arch, layers=cfg.n_layers + cfg.enc_layers,
                        batch=b, seq=seq, logits_vs_one=diff,
                        serve_max_abs_err=err,
                        one_process_forward_s=ref[f"{tag}_forward_s"],
                        cache_bytes_one=ref[f"{tag}_cache_bytes_one"],
                        ranks=runs)
        r0 = runs[0]
        print(f"phase 14: {cfg.name} at full width, {out[tag]['layers']} "
              f"layers, on a (1, 4) mesh ({MESH_RANKS} gloo ranks on "
              f"cuda:0), tensor-parallel over 'model' "
              f"({cfg.n_heads // m} q heads, "
              f"{cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads} kv "
              f"heads, d_ff {cfg.d_ff // m} a rank; unembed.w a rank "
              f"{r0['unembed_shape']}), make_prefill_step over {b} x "
              f"{seq}: last logits within {diff:.4g} of one process's (tol "
              f"{LOGIT_TOL}); per rank flash_attn_bhsd x"
              f"{r0['flash_launches']} at {r0['flash_shapes']} (wgmma, "
              f"each == twin, max "
              f"{max(r['flash_over'] for r in runs):.3g}x the tolerance) "
              f"and nothing else of the eight; ms a forward "
              f"{[round(r['step_s'] * 1e3, 1) for r in runs]} (one process "
              f"{ref[f'{tag}_forward_s'] * 1e3:.1f} ms, its first call), "
              f"peak GiB "
              f"{[round(r['peak_total_bytes'] / 2**30, 2) for r in runs]}, "
              f"blocks GiB {[round(r['block_bytes'] / 2**30, 3) for r in runs]}"
              f", compute tree GiB "
              f"{[round(r['tree_bytes'] / 2**30, 3) for r in runs]} in "
              f"{[round(r['gather_s'], 2) for r in runs]} s (the gathered "
              f"layout's, every leaf whole over 'model': "
              f"{[round(r['gathered_layout']['tree_bytes'] / 2**30, 3) for r in runs]}"
              f" GiB in "
              f"{[round(r['gathered_layout']['gather_s'], 2) for r in runs]}"
              f" s), routes {r0['routes']}; the forward's collectives "
              f"(calls / MB by kind) {collectives_line(runs)} "
              f"({card_line()})")
        bs, s_, gen = MESH_SERVE
        print(f"phase 14: {cfg.name} token loop on (1, 4), {bs} prompts of "
              f"{s_} + {gen} generated, fed one process's tokens: each "
              f"rank's {', '.join(XATTN_KV[tag])} cache "
              f"{serves[0]['cache_bytes']} B "
              f"({serves[0]['cache_shapes']}) beside one process's "
              f"{ref[f'{tag}_cache_bytes_one']} B; every step's last "
              f"logits within {err:.4g} of one process's (tol {LOGIT_TOL}); "
              f"no kernel launched; ms a step "
              f"{[round(x['ms_a_step'], 2) for x in serves]}")


def mesh_phase(smoke, result) -> dict:
    """Phase 14: the model half of distributed (see the module docstring).
    Returns the flash kernel's launches a rank on its paths and its
    timing at the tensor-parallel prefill's shape."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    out = result["mesh"] = {}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
        ref = mesh_references(smoke, tmp)
        out["references_s"] = time.perf_counter() - t_start
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_rank, MESH_RANKS, MESH_TIMEOUT_S, tmp,
                            "mesh")
        out["spawn_s"] = time.perf_counter() - t0
        # Flash at the (1, 4) prefill's shape, on rank 0's first call's
        # inputs: the kernel, its twin and PyTorch's fused attention.
        saved = torch.load(os.path.join(tmp, "mesh_flash.pt"))
        qkv = tuple(x.cuda() for x in saved["qkv"])
        fa = smoke.flash.flash_attn_bhsd(*qkv, **saved["kw"])
        tp_timing = flash_row(smoke, [(qkv, saved["kw"], (fa,))],
                              MESH_MOE_LAYERS, batch=saved["b_loc"],
                              path="mesh prefill (1, 4), tensor-parallel")
        del saved, qkv, fa
        xattn_timing = mesh_xattn_timing(smoke, ranks, tmp)
        last_timing = mesh_last_timing(smoke, ranks, tmp)
        # (c) one process restores the checkpoint whole.
        t0 = time.perf_counter()
        model = build_model(get_config(LM_ARCH), "cuda", trainable=True)
        params = dict(model.named_parameters())
        opt = adamw.init(params)
        CheckpointManager(os.path.join(tmp, "ckpt")).restore(
            MESH_TRAIN_STEPS, {"params": params, "opt": opt})
        torch.cuda.synchronize()
        out["restore_one_s"] = time.perf_counter() - t0
        sums_one = state_checksums(params, opt)
        del model, params, opt
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    # (a) Mixtral's prefill on each mesh.
    for shape in MESH_SHAPES:
        tag = "x".join(map(str, shape))
        runs = [r["moe"][tag] for r in ranks]
        check([tuple(r["coords"].values()) for r in runs]
              == [tuple(int(c) for c in np.unravel_index(i, shape))
                  for i in range(MESH_RANKS)],
              f"mesh {tag}: rank coordinates {[r['coords'] for r in runs]}")
        want_last = ref["full_last"] if shape[0] == 1 else np.concatenate(
            [ref["half0_last"], ref["half1_last"]])
        diff = float(np.abs(np.asarray(runs[0]["last"]) - want_last).max())
        check(diff <= LOGIT_TOL, f"mesh {tag}: last logits {diff} from the "
                                 f"one-process forward's")
        want_drop = ref["full_dropped"] if shape[0] == 1 else \
            ref["half0_dropped"] + ref["half1_dropped"]
        check(all(r["dropped"] == want_drop for r in runs),
              f"mesh {tag}: dropped {[r['dropped'] for r in runs]} vs one "
              f"process's {want_drop}")
        out[tag] = dict(logits_vs_one=diff, dropped=runs[0]["dropped"],
                        dropped_one=want_drop, ranks=[
                            {k: v for k, v in r.items() if k != "last"}
                            for r in runs])
        steps_of = [dict(collectives=r["step_collectives"]) for r in runs]
        print(f"phase 14: mixtral {MESH_MOE_LAYERS} of 32 layers on a {tag} "
              f"mesh ({MESH_RANKS} gloo ranks on cuda:0), make_prefill_step "
              f"over {MESH_MOE_BATCH} x {MESH_MOE_SEQ}: last logits within "
              f"{diff:.4g} of one process's (tol {LOGIT_TOL}), dropped "
              f"{runs[0]['dropped']} = one process's at per-shard capacity "
              f"{want_drop}; per rank flash_attn_bhsd x"
              f"{runs[0]['flash_launches']} at {runs[0]['flash_shape']} "
              f"(wgmma, each == twin, max {max(r['flash_over'] for r in runs):.3g}x "
              f"the tolerance), near-tie flips "
              f"{[r['near_tie_flips'] for r in runs]}, ms a forward "
              f"{[round(r['step_s'] * 1e3, 1) for r in runs]}, peak GiB "
              f"{[round(r['peak_total_bytes'] / 2**30, 3) for r in runs]} "
              f"(from the rank's blocks, a block gathered at a time), blocks "
              f"GiB {[round(r['block_bytes'] / 2**30, 2) for r in runs]}, "
              f"compute tree held at once GiB "
              f"{[round(r['tree_bytes'] / 2**30, 3) for r in runs]} (the "
              f"leaves outside the stacks "
              f"{[round(r['step_tree_bytes'] / 2**30, 3) for r in runs]} + "
              f"the largest block's "
              f"{[round(r['largest_block_bytes'] / 2**30, 3) for r in runs]})"
              f" beside the whole tree's "
              f"{[round(r['whole_tree_bytes'] / 2**30, 3) for r in runs]}, "
              f"gathered at once in "
              f"{[round(r['gather_s'], 2) for r in runs]} s (the gathered "
              f"layout's, every leaf but the experts whole over 'model': "
              f"{[round(r['gathered_layout']['tree_bytes'] / 2**30, 3) for r in runs]}"
              f" GiB in "
              f"{[round(r['gathered_layout']['gather_s'], 2) for r in runs]}"
              f" s), routes {runs[0]['routes']}; the forward's collectives "
              f"(calls / MB by kind; sequence-parallel residual) "
              f"{collectives_line(steps_of)}")
    # (a) the token loop on (1, 4), fed one process's tokens and routed
    # as it routed: every step's logits within LOGIT_TOL of its own.
    b, s, gen = MESH_SERVE
    serves = [r["moe"]["serve"] for r in ranks]
    got = np.asarray(serves[0]["tokens"])
    check(all(np.array_equal(np.asarray(x["tokens"]), got) for x in serves),
          "mesh serve: the ranks generated different tokens")
    err = max(max(x["step_max_abs_err"]) for x in serves)
    check(err <= LOGIT_TOL, f"mesh serve: a step's logits {err} from one "
                            f"process's (tol {LOGIT_TOL})")
    same = int((got == ref["serve_tokens"]).sum())
    firsts = [(x["first_logits"], x["first_difference"]) for x in serves]
    m = MESH_SHAPES[0][1]
    kv_split = cfg.n_kv_heads % m == 0
    check(all(x["cache_bytes"] * (m if kv_split else 1)
              == x["cache_bytes_one"] for x in serves),
          f"mesh serve: k / v cache bytes a rank "
          f"{[x['cache_bytes'] for x in serves]}, one process's "
          f"{serves[0]['cache_bytes_one']} ({cfg.n_kv_heads} kv heads on a "
          f"{m}-way 'model' axis)")
    out["serve"] = dict(max_abs_err=err, tokens_equal=same, ranks=serves)
    print(f"phase 14: mixtral token loop on (1, 4), {b} prompts of {s} + "
          f"{gen} generated, fed one process's tokens and routed alike "
          f"(near-tie flips {[x['near_tie_flips'] for x in serves]}), each "
          f"rank's k / v cache {serves[0]['cache_bytes']} B (its "
          f"{cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads} kv heads) "
          f"beside one process's {serves[0]['cache_bytes_one']} B: every "
          f"step's logits within {err:.4g} of one process's (tol "
          f"{LOGIT_TOL}), first unequal step "
          f"{[x['first_logit_step'] for x in serves]}; by rank, the first "
          f"logits that differ after equal values and the first hidden "
          f"value that differs {firsts}; {same} of {got.size} greedy "
          f"tokens equal "
          f"one process's, no kernel launched, ms a step "
          f"{[round(x['ms_a_step'], 2) for x in serves]}")
    # (b) Qwen's training steps on the (4,) data mesh.
    trains = [r["train"] for r in ranks]
    one = ref["train_one"]
    first = trains[0]["steps"][0]
    for key in ("loss", "ce"):
        check(all(abs(t["steps"][0][key] - one[key]) <= TRAIN_LOSS_ATOL
                  for t in trains),
              f"mesh train: {key} {first[key]} vs one process's {one[key]}")
    check(all(abs(t["steps"][0]["grad_norm"] - one["grad_norm"])
              <= TRAIN_GNORM_RTOL * one["grad_norm"] for t in trains),
          f"mesh train: grad norm {first['grad_norm']} vs one process's "
          f"{one['grad_norm']}")
    check(all(math.isfinite(x["loss"]) for t in trains for x in t["steps"]),
          "mesh train: loss not finite")
    # (c) the checkpoint, bit for bit.
    sums = trains[0]["sums"]
    check(all(t["sums"] == sums and t["sums_2x2"] == sums for t in trains)
          and sums_one == sums,
          "mesh checkpoint: restored state differs from the saved one")
    out["train"] = dict(one=one, ranks=trains, checksums=len(sums))
    print(f"phase 14: {LM_ARCH} at full width on launch/train.py's "
          f"({MESH_RANKS},) data mesh, {MESH_TRAIN_STEPS} steps of "
          f"{MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}, remat full: step 0 loss "
          f"{first['loss']:.5f} / ce {first['ce']:.5f} / grad norm "
          f"{first['grad_norm']:.5f} vs one process's (1,) mesh "
          f"{one['loss']:.5f} / {one['ce']:.5f} / {one['grad_norm']:.5f}; "
          f"per rank flash x{first['flash_launches']} a step (wgmma, the "
          f"first step's each == twin), ms a step "
          f"{[[round(x['step_s'] * 1e3, 1) for x in t['steps']] for t in trains]}"
          f" (one process {[round(x * 1e3, 1) for x in one['step_s']]}), "
          f"peak GiB "
          f"{[round(t['peak_bytes'] / 2**30, 2) for t in trains]}, routes "
          f"{trains[0]['routes']}; checkpoint saved from the mesh in "
          f"{trains[0]['save_s']:.2f} s, restored on (2, 2) in "
          f"{max(t['restore_2x2_s'] for t in trains):.2f} s and in one "
          f"process in {out['restore_one_s']:.2f} s, {len(sums)} tensors "
          f"bit-identical (checksums)")
    # (b') Qwen's tensor-parallel step on (2, 2) against the same one
    # process's first step.
    tps = [r["tp_train"] for r in ranks]
    for key in ("loss", "ce"):
        check(all(abs(t[key] - one[key]) <= TRAIN_LOSS_ATOL for t in tps),
              f"mesh TP train: {key} {[t[key] for t in tps]} vs one "
              f"process's {one[key]}")
    check(all(abs(t["grad_norm"] - one["grad_norm"])
              <= TRAIN_GNORM_RTOL * one["grad_norm"] for t in tps),
          f"mesh TP train: grad norm {[t['grad_norm'] for t in tps]} vs one "
          f"process's {one['grad_norm']}")
    out["tp_train"] = dict(ranks=tps)
    print(f"phase 14: {LM_ARCH} at full width, one make_train_step on a "
          f"(2, 2) ('data', 'model') mesh, tensor-parallel (remat full, "
          f"{MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}): loss "
          f"{tps[0]['loss']:.5f} / ce {tps[0]['ce']:.5f} / grad norm "
          f"{tps[0]['grad_norm']:.5f} vs one process's {one['loss']:.5f} / "
          f"{one['ce']:.5f} / {one['grad_norm']:.5f} (tol {TRAIN_LOSS_ATOL}, "
          f"{TRAIN_GNORM_RTOL} relative); per rank flash "
          f"x{tps[0]['flash_launches']} at {tps[0]['flash_shape']} (wgmma, "
          f"each == twin, max abs err "
          f"{max(t['flash_max_abs_err'] for t in tps):.3g}), step s "
          f"{[round(t['step_s'], 2) for t in tps]}, blocks GiB "
          f"{[round(t['block_bytes'] / 2**30, 3) for t in tps]}, compute "
          f"tree held at once GiB "
          f"{[round(t['tree_bytes'] / 2**30, 3) for t in tps]} (a block at "
          f"a time, from the rank's blocks) beside the whole tree's "
          f"{[round(t['whole_tree_bytes'] / 2**30, 3) for t in tps]}, "
          f"peak GiB a rank "
          f"{[round(t['peak_bytes'] / 2**30, 2) for t in tps]}, "
          f"routes {tps[0]['routes']}; the step's collectives (calls / MB "
          f"by kind) {collectives_line(tps)}")
    # (b) Mixtral on the data mesh.
    mesh_data_moe_checks(ranks, ref, out)
    # (d) / (e) the cross-attention families on (1, 4).
    mesh_xattn_checks(ranks, ref, out)
    # (f)-(h) the last three families on (1, 4).
    mesh_last_checks(ranks, ref, out)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 14: {out['seconds']:.1f} s ({out['references_s']:.1f} s "
          f"one-process references, {out['spawn_s']:.1f} s the spawn)")
    return {"launches": {
        "mesh_prefill_1x4": ranks[0]["moe"]["1x4"]["flash_launches"],
        "mesh_prefill_2x2": ranks[0]["moe"]["2x2"]["flash_launches"],
        "mesh_train_step": first["flash_launches"],
        "mesh_tp_train_step": tps[0]["flash_launches"],
        **{f"mesh_{tag}_prefill": ranks[0]["xattn"][tag]["flash_launches"]
           for tag, _, _, _ in MESH_XATTN},
        **{f"mesh_{tag}_prefill": ranks[0]["last"][tag]["flash_launches"]
           for tag, _, _, _ in MESH_LAST}},
        "timing": tp_timing, "xattn_timing": {**xattn_timing,
                                              **last_timing}}


# -- phase 14 (f)-(h): the last three families --------------------------------
def last_cfg(arch, layers):
    """Phase 14 (f)-(h)'s config: ``arch`` at its published widths, cut to
    its first ``layers`` layers (None: whole)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def live_ssm_blocks(model, params, shardings) -> None:
    """``live_ssm``'s draws (the same generator calls, leaf by leaf in
    parameter order, each into a tensor of the whole leaf's shape) cut
    to this rank's blocks of ``params``: the ranks hold blocks of the
    one process's live weights."""
    from repro_torch.sharding.rules import local_shard
    gen = torch.Generator(device="cuda").manual_seed(XATTN_SEED + 2)
    rank = model.cfg.shared_lora_rank
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in ("a_log", "dt_bias", "b_q"):
                continue
            t = torch.empty(p.shape, dtype=params[name].dtype, device="cuda")
            if leaf == "b_q":
                t.normal_(0.0, rank ** -0.5, generator=gen)
            else:
                t.uniform_(-1.0, 1.0, generator=gen)
            sh = shardings[name]
            params[name].copy_(local_shard(t, sh.spec, sh.mesh))


def last_blocks(family):
    """[(module, block function, the index of x in its arguments)] of the
    blocks phase 14 (g) / (h) holds one by one (none for MLA: its
    logits are held whole, routed alike)."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models import transformer as tf
    return {"ssm_hybrid": [(ssm, "mamba2", 2), (tf, "_shared_attn", 4)],
            "xlstm": [(xlstm, "mlstm", 2), (xlstm, "slstm", 2)]}.get(
                family, [])


def last_references(ref, out, tmp) -> None:
    """Phase 14 (f)-(h)'s one-process runs: each arch (``last_cfg``; the
    weights the ranks draw, zamba2's live leaves too) over
    MESH_LAST_BATCH x MESH_LAST_SEQ tokens: the forward's last logits,
    its routing (MLA), each block's input and output and the head's
    input (to ``tmp/{tag}_blocks.pt``); its token loop (prompts from
    XATTN_SEED + 1, then its greedy tokens): each step's fed token, last
    logits (``tmp/{tag}_serve_logits.npy``) and routing, and its cache
    leaves' bytes."""
    from repro_torch.launch import serve as serve_mod
    b, s = MESH_LAST_BATCH, MESH_LAST_SEQ
    for tag, arch, layers, serve in MESH_LAST:
        cfg = last_cfg(arch, layers)
        model = serve_mod.load_model(cfg, seed=XATTN_SEED, device="cuda")
        if cfg.family == "ssm_hybrid":
            live_ssm(model)
        toks = serve_mod.make_prompts(cfg, b, s, XATTN_SEED, "cuda")
        ref[f"{tag}_tokens"] = toks.cpu().numpy()
        run = serve_mod.run_config(s)
        seen, head = [], []

        def rec(real, xi):
            def fn(*a, **kw):
                y = real(*a, **kw)
                seen.append((a[xi].cpu(), y.cpu()))
                return y
            return fn
        logits_fn = model._logits

        def logits_rec(x, *a, **kw):
            head.append(x[:, -1:].cpu())
            return logits_fn(x, *a, **kw)
        model._logits = logits_rec
        log = RouteLog()
        try:
            t0 = time.perf_counter()
            with patched(*[(mod, f, rec(getattr(mod, f), xi))
                           for mod, f, xi in last_blocks(cfg.family)]), \
                    log.record() as rc, torch.inference_mode():
                logits = model.forward(run, {"tokens": toks})[0]
                ref[f"{tag}_last"] = logits[:, -1].float().cpu().numpy()
            torch.cuda.synchronize()
            out[f"{tag}_forward_s"] = time.perf_counter() - t0
        finally:
            del model._logits
        for i, (ids, gap) in enumerate(rc):
            ref[f"{tag}_ids{i}"] = ids.numpy()
            ref[f"{tag}_gap{i}"] = gap.numpy()
        torch.save({"blocks": seen, "head": head[0]},
                   os.path.join(tmp, f"{tag}_blocks.pt"))
        out[f"{tag}_blocks"] = len(seen)
        del logits, seen, head
        bs, ps, gen = serve
        prompts = serve_mod.make_prompts(cfg, bs, ps, XATTN_SEED + 1, "cuda")
        sruns = serve_mod.run_config(ps)
        feed, steps_logits = [], []
        with torch.inference_mode(), log.record() as rc:
            cache = model.init_cache(bs, ps + gen)
            out[f"{tag}_cache_bytes_one"] = {
                k: t.numel() * t.element_size()
                for k, t in flat_cache(cache).items()}
            tok = prompts[:, :1]
            for t in range(ps + gen - 1):
                feed.append(tok)
                logits, cache = model.decode_step(sruns, tok, cache)
                steps_logits.append(logits[:, -1].float().cpu())
                nxt = torch.argmax(logits[:, -1], dim=-1).to(
                    torch.int32)[:, None]
                tok = prompts[:, t + 1:t + 2] if t + 1 < ps else nxt
        ref[f"{tag}_serve_feed"] = torch.cat(feed, 1).cpu().numpy()
        if rc:
            ref[f"{tag}_serve_ids"] = torch.stack([i for i, _ in rc]).numpy()
            ref[f"{tag}_serve_gaps"] = torch.stack([g for _, g in rc]).numpy()
        np.save(os.path.join(tmp, f"{tag}_serve_logits.npy"),
                torch.stack(steps_logits).numpy())
        del model, cache, logits, steps_logits
        torch.cuda.empty_cache()


def flat_cache(cache, pre="") -> dict:
    """{"a/b": leaf} of a cache tree, its position counter left out."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(flat_cache(v, f"{pre}{k}/"))
        elif k != "pos":
            out[pre + k] = v
    return out


def mesh_last_rank(smoke, ref, rank, tmp):
    """Phase 14 (f)-(h) on one rank: each of MESH_LAST on
    MESH_LAST_SHAPE, tensor-parallel over "model" (``mesh_last_case``)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH_LAST_SHAPE, ("data", "model"))
    return {tag: mesh_last_case(smoke, ref, rank, tmp, mesh, tag, arch,
                                layers, serve)
            for tag, arch, layers, serve in MESH_LAST}


def mesh_last_case(smoke, ref, rank, tmp, mesh, tag, arch, layers, serve):
    """One of phase 14 (f)-(h) on this rank: the blocks drawn in turn,
    ``make_prefill_step`` (routed as one process routed, MLA), its kernel
    launches (zamba2: flash once a shared block, each call against the
    twin), its last logits; each block fed one process's input against
    its output, and the head fed one process's final hidden state; the
    timing, bytes and peak; then the token loop."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    from repro_torch.runtime import steps
    from repro_torch.sharding.rules import (gather_rows, init_sharded,
                                            model_shardings, split_batch)
    cfg = last_cfg(arch, layers)
    m = mesh.shape["model"]
    model = build_model(cfg, "meta")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shardings = model_shardings(model, mesh)
    for r in range(MESH_RANKS):
        if r == rank:
            params = init_sharded(model, shardings, torch.Generator(
                device="cuda").manual_seed(XATTN_SEED), "cuda")
            if cfg.family == "ssm_hybrid":
                live_ssm_blocks(model, params, shardings)
            torch.cuda.empty_cache()
        dist.barrier()
    block_bytes = tree_bytes(params)
    gathered = gathered_layout(params, shardings)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree = steps.compute_params(model, params, mesh)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    b, s = MESH_LAST_BATCH, MESH_LAST_SEQ
    batch = {"tokens": torch.from_numpy(ref[f"{tag}_tokens"]).cuda()}
    run = serve_mod.run_config(s)
    step = steps.make_prefill_step(model, run, mesh)
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    force = [(torch.from_numpy(ref[f"{tag}_ids{i}"]),
              torch.from_numpy(ref[f"{tag}_gap{i}"])) for i in range(n_moe)]
    log = RouteLog()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    with smoke.capture(keep=["flash_attn_bhsd"]) as cap, \
            log.record(force or None) as rc, \
            dryrun.counted_collectives() as tally:
        last = step(tree, batch)
        torch.cuda.synchronize()
    counts = dict(smoke.build.LAUNCHES)
    routes = dict(smoke.build.ROUTE_LAUNCHES)
    calls = cap.calls["flash_attn_bhsd"]
    n_flash = cfg.n_layers // cfg.shared_attn_every \
        if cfg.family == "ssm_hybrid" else 0
    bhsd = (b * cfg.n_heads // m, s, cfg.hd)
    for kname, n in counts.items():
        check((n > 0) == (kname == "flash_attn_bhsd" and n_flash > 0),
              f"mesh {tag} prefill: {kname} launched {n} times")
    check(len(calls) == counts.get("flash_attn_bhsd", 0) == n_flash
          and routes.get("flash_attn_bhsd:wgmma", 0) == n_flash
          and all(a[0].shape == bhsd and a[0].dtype == torch.bfloat16
                  and kw["causal"] for a, kw, _ in calls),
          f"mesh {tag} prefill: flash launches {routes}, not {n_flash} "
          f"causal wgmma calls at {bhsd}")
    err = over = 0.0
    for args, kw, (o,) in calls:
        w, spread = smoke.twin("flash_attn_bhsd", args, kw)
        e, ov = flash_err(o, w, spread, f"mesh {tag} flash call")
        err, over = max(err, e), max(over, ov)
        del w, spread
    if rank == 0 and calls:
        (q, k, v), kw, _ = calls[0]
        torch.save({"qkv": [x.cpu() for x in (q, k, v)], "kw": kw,
                    "b_loc": b}, os.path.join(tmp, f"mesh_{tag}_flash.pt"))
    del cap, calls
    flips = route_flips(force, rc, f"mesh {tag} vs one process") \
        if force else 0
    check(bool(torch.isfinite(last).all()) and last.shape == (b, cfg.vocab),
          f"mesh {tag} prefill: last logits {tuple(last.shape)} not finite")
    diff = float((last.float().cpu() - torch.from_numpy(
        ref[f"{tag}_last"])).abs().max())
    # Block by block: each block fed one process's input to it, against
    # its output (the forward's own blocks run on as they are); the head
    # fed one process's final hidden state.
    saved = torch.load(os.path.join(tmp, f"{tag}_blocks.pt"))
    worst, at = {}, [0]

    def fed(real, xi, name):
        def fn(*a, **kw):
            y = real(*a, **kw)
            x_in, y_one = saved["blocks"][at[0]]
            at[0] += 1
            a = list(a)
            a[xi] = x_in.cuda()
            r = float(row_ratio(real(*a, **kw), y_one.cuda()))
            worst[name] = max(worst.get(name, 0.0), r)
            return y
        return fn
    view = split_batch(mesh, batch)[0]
    with patched(*[(mod, f, fed(getattr(mod, f), xi, f))
                   for mod, f, xi in last_blocks(cfg.family)]), \
            log.record(force or None):
        step(tree, batch)
    with torch.inference_mode(), steps.bound(model, tree):
        head = model._logits(saved["head"].cuda(), view)
        head = gather_rows(view, steps._last_row(model, view, head))
    check(at[0] == len(saved["blocks"]),
          f"mesh {tag}: {at[0]} blocks fed, one process ran "
          f"{len(saved['blocks'])}")
    head_diff = float((head.float().cpu() - torch.from_numpy(
        ref[f"{tag}_last"])).abs().max())
    del saved, head
    timing = step_timing(lambda bt: step(tree, bt), batch, b * s)
    res = dict(coords=mesh.coords, routes=dict(mesh.routes),
               flash_launches=counts.get("flash_attn_bhsd", 0),
               flash_shape=bhsd if n_flash else None, flash_max_abs_err=err,
               flash_over=over, near_tie_flips=flips, logits_vs_one=diff,
               head_vs_one=head_diff, block_ratio=worst,
               collectives=tally_of(tally),
               block_bytes=block_bytes, tree_bytes=tree_bytes(tree),
               gather_s=gather_s, gathered_layout=gathered,
               peak_total_bytes=torch.cuda.max_memory_allocated() - base,
               **timing)
    del last, batch
    res["serve"] = mesh_last_serve(smoke, model, mesh, tree, ref, tmp, tag,
                                   serve, rank)
    del params, tree
    return res


def mesh_last_serve(smoke, model, mesh, tree, ref, tmp, tag, serve, rank):
    """Phase 14 (f)-(h)'s token loop on this rank through
    ``make_serve_step`` (timed; no kernel of the eight launched) on its
    block of the cache (``local_cache``: its heads of every state leaf,
    MLA's ckv / kr whole; each leaf's bytes beside one process's), fed
    one process's tokens and routed as it routed (MLA); on rank 0 each
    step's last logits (gathered over the vocab) against one process's
    after the loop."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime import steps
    b, s, gen = serve
    n_steps = s + gen - 1
    feed = torch.from_numpy(ref[f"{tag}_serve_feed"]).cuda()
    step = steps.make_serve_step(model, serve_mod.run_config(s), mesh)
    cache = steps.local_cache(model, mesh, b, s + gen, "cuda")
    cache_bytes = {k: t.numel() * t.element_size()
                   for k, t in flat_cache(cache).items()}
    force = list(zip(torch.from_numpy(ref[f"{tag}_serve_ids"]),
                     torch.from_numpy(ref[f"{tag}_serve_gaps"]))) \
        if f"{tag}_serve_ids" in ref else None
    seen, real = [], steps._last_row

    def last_row(model_, view, logits):
        last = real(model_, view, logits)
        if rank == 0:
            seen.append(last)
        return last
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    steps._last_row = last_row
    try:
        with RouteLog().record(force) as rc:
            t0 = time.perf_counter()
            for t in range(n_steps):
                _, cache = step(tree, feed[:, t:t + 1], cache)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        steps._last_row = real
    launched = {k: v for k, v in smoke.build.LAUNCHES.items() if v}
    check(not launched, f"mesh {tag} serve: kernels launched {launched}")
    flips = route_flips(force, rc, f"mesh {tag} serve vs one process") \
        if force else 0
    errs = []
    if rank == 0:
        want = np.load(os.path.join(tmp, f"{tag}_serve_logits.npy"),
                       mmap_mode="r")
        check(len(seen) == n_steps, f"mesh {tag} serve: {len(seen)} steps")
        errs = [float((got.float().cpu() - torch.from_numpy(
            np.array(want[t]))).abs().max()) for t, got in enumerate(seen)]
        check(all(math.isfinite(e) for e in errs),
              f"mesh {tag} serve: logits not finite")
    return dict(cache_bytes=cache_bytes,
                cache_shapes={k: list(t.shape)
                              for k, t in flat_cache(cache).items()},
                step_max_abs_err=errs, steps=n_steps, near_tie_flips=flips,
                ms_a_step=dt * 1e3 / n_steps, tok_s=b * n_steps / dt)


def mesh_last_timing(smoke, ranks, tmp) -> dict:
    """Flash at phase 14 (g)'s rank shape, on rank 0's first call
    (``flash_row``: beside its twin, bound and SDPA)."""
    timing = {}
    for tag, _, _, _ in MESH_LAST:
        path = os.path.join(tmp, f"mesh_{tag}_flash.pt")
        if not os.path.exists(path):
            continue
        saved = torch.load(path)
        qkv = tuple(x.cuda() for x in saved["qkv"])
        fa = smoke.flash.flash_attn_bhsd(*qkv, **saved["kw"])
        timing[f"mesh_{tag}"] = flash_row(
            smoke, [(qkv, saved["kw"], (fa,))],
            ranks[0]["last"][tag]["flash_launches"], batch=saved["b_loc"],
            path=f"mesh {tag} prefill (1, 4), tensor-parallel")
        del qkv, fa
    return timing


def mesh_last_checks(ranks, ref, out) -> None:
    """Phase 14 (f)-(h)'s checks on the ranks' records, against the
    one-process references (``last_references``), into ``out``."""
    m = MESH_LAST_SHAPE[1]
    for tag, arch, layers, serve in MESH_LAST:
        cfg = last_cfg(arch, layers)
        runs = [r["last"][tag] for r in ranks]
        r0 = runs[0]
        diff = max(r["logits_vs_one"] for r in runs)
        head = max(r["head_vs_one"] for r in runs)
        blocks = {k: max(r["block_ratio"].get(k, 0.0) for r in runs)
                  for k in r0["block_ratio"]}
        check(head <= LOGIT_TOL, f"mesh {tag}: the head fed one process's "
                                 f"hidden state {head} from its logits")
        check(all(v <= RECURRENT_BLOCK_RTOL for v in blocks.values()),
              f"mesh {tag}: blocks fed one process's inputs {blocks} of "
              f"their outputs' scale (tol {RECURRENT_BLOCK_RTOL})")
        held = cfg.family in MESH_LAST_WHOLE
        if held:
            check(diff <= LOGIT_TOL, f"mesh {tag}: last logits {diff} from "
                                     f"the one-process forward's")
        sv = [r["serve"] for r in runs]
        err = max(sv[0]["step_max_abs_err"])
        if held:
            check(err <= LOGIT_TOL, f"mesh {tag} serve: a step's logits "
                                    f"{err} from one process's")
        one = ref[f"{tag}_cache_bytes_one"]
        check(set(sv[0]["cache_bytes"]) == set(one),
              f"mesh {tag} serve: cache leaves {sorted(sv[0]['cache_bytes'])}")
        split = {k: one[k] / sv[0]["cache_bytes"][k] for k in one}
        for k, ratio in split.items():
            leaf = k.rsplit("/", 1)[-1]
            want = 1.0 if leaf in ("ckv", "kr") else None if leaf == "conv" \
                else float(m)
            check(want is None and 1.0 < ratio < m or ratio == want,
                  f"mesh {tag} serve: {k} a rank is 1/{ratio} of one "
                  f"process's")
        out[tag] = dict(arch=arch, layers=cfg.n_layers, batch=MESH_LAST_BATCH,
                        seq=MESH_LAST_SEQ, logits_vs_one=diff,
                        head_vs_one=head, block_ratio=blocks,
                        serve_max_abs_err=err,
                        serve_err_by_step=sv[0]["step_max_abs_err"][::16],
                        cache_split=split,
                        one_process_forward_s=ref[f"{tag}_forward_s"],
                        ranks=runs)
        heads = (f"{cfg.n_heads // m} of {cfg.n_heads} MLA heads"
                 if cfg.mla else f"{tp_ssm(cfg) // m} of {tp_ssm(cfg)} "
                 f"Mamba2 heads and {cfg.n_heads // m} of {cfg.n_heads} "
                 f"attention heads" if cfg.family == "ssm_hybrid"
                 else f"{cfg.n_heads // m} of {cfg.n_heads} heads")
        print(f"phase 14: {cfg.name} at full width, {cfg.n_layers} layers, "
              f"on a (1, 4) mesh ({MESH_RANKS} gloo ranks on cuda:0), "
              f"tensor-parallel over 'model' ({heads} a rank), "
              f"make_prefill_step over {MESH_LAST_BATCH} x {MESH_LAST_SEQ}: "
              f"last logits within {diff:.4g} of one process's"
              f"{' (routed alike)' if cfg.mla else ''}"
              f"{'' if held else ' (reported, not held)'}; the head fed one "
              f"process's final hidden state within {head:.4g} (tol "
              f"{LOGIT_TOL}); blocks fed one process's inputs within "
              + (", ".join(f"{k} {v:.3g}" for k, v in blocks.items())
                 or "(no recurrent block)")
              + f" of their scale (tol {RECURRENT_BLOCK_RTOL}); per rank "
              f"flash_attn_bhsd x{r0['flash_launches']} at "
              f"{r0['flash_shape']} (wgmma, each == twin, max "
              f"{max(r['flash_over'] for r in runs):.3g}x the tolerance) "
              f"and nothing else of the eight; ms a forward "
              f"{[round(r['step_s'] * 1e3, 1) for r in runs]} (one process "
              f"{ref[f'{tag}_forward_s'] * 1e3:.1f} ms, its first call), "
              f"peak GiB "
              f"{[round(r['peak_total_bytes'] / 2**30, 2) for r in runs]}, "
              f"blocks GiB {[round(r['block_bytes'] / 2**30, 3) for r in runs]}"
              f", compute tree GiB "
              f"{[round(r['tree_bytes'] / 2**30, 3) for r in runs]} in "
              f"{[round(r['gather_s'], 2) for r in runs]} s (the gathered "
              f"layout's, every leaf but the experts whole over 'model': "
              f"{[round(r['gathered_layout']['tree_bytes'] / 2**30, 3) for r in runs]}"
              f" GiB in "
              f"{[round(r['gathered_layout']['gather_s'], 2) for r in runs]}"
              f" s), routes {r0['routes']}; the forward's collectives "
              f"(calls / MB by kind) {collectives_line(runs)} "
              f"({card_line()})")
        bs, s_, gen = serve
        print(f"phase 14: {cfg.name} token loop on (1, 4), {bs} prompts of "
              f"{s_} + {gen} generated, fed one process's tokens"
              f"{' and routed alike' if cfg.mla else ''}: each cache leaf "
              f"a rank in B {sv[0]['cache_bytes']} ({sv[0]['cache_shapes']})"
              f" beside one process's {one}, one process's / a rank's "
              f"{ {k: round(v, 3) for k, v in split.items()} }; the last "
              f"logits' largest difference from one process's "
              f"{err:.4g}"
              f"{' (tol ' + str(LOGIT_TOL) + ')' if held else ' (reported)'},"
              f" by step {[round(e, 3) for e in out[tag]['serve_err_by_step']]}"
              f"; no kernel launched; ms a step "
              f"{[round(x['ms_a_step'], 2) for x in sv]}")


def tp_ssm(cfg) -> int:
    """zamba2's Mamba2 heads."""
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


def host_map():
    """The census and its covering at SCALE, on the host (numpy; no card).
    Returns (census, covering, census s, covering s)."""
    from repro_torch.core.cells import build_cell_covering
    from repro_torch.core.synth import build_synth_census
    t0 = time.perf_counter()
    sc = build_synth_census(**SCALE)
    t1 = time.perf_counter()
    cov = build_cell_covering(sc.census, max_level=MAX_LEVEL)
    return sc, cov, t1 - t0, time.perf_counter() - t1


# -- phase 15: the dry-run ----------------------------------------------------
DRYRUN_CLI = ("--arch", MOE_ARCH, "--shape", "train_4k", "--single-pod-only")


def dryrun_phase(result) -> None:
    """Phase 15: ``launch.dryrun`` on the meta device against phase 14
    (a)'s (1, 4) prefill, rank by rank, then its CLI on the card box."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    t_start = time.perf_counter()
    out = result["dryrun"] = {"ranks": []}
    # (a) phase 14 (a)'s cells: the serving build its ranks drew, their
    # run knobs, each mesh, counted at each rank.
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MESH_MOE_LAYERS)
    model = build_model(cfg, "meta")
    shape = ShapeConfig("mesh_moe_prefill", MESH_MOE_SEQ, MESH_MOE_BATCH,
                        "prefill")
    run = serve_mod.run_config(MESH_MOE_SEQ)
    for mshape in MESH_SHAPES:
        tag = "x".join(map(str, mshape))
        for rank, meas in enumerate(result["mesh"][tag]["ranks"]):
            mesh = dryrun.CountingMesh(mshape, ("data", "model"), rank)
            pred = dryrun.count_step(model, shape, mesh, run)
            got = meas["collectives"]
            keys = ("block_bytes", "tree_bytes", "whole_tree_bytes")
            check(all(pred[k] == meas[k] for k in keys),
                  f"dryrun {tag} rank {rank}: blocks / tree held at once / "
                  f"whole tree bytes {[pred[k] for k in keys]}, measured "
                  f"{[meas[k] for k in keys]}")
            check(pred["collective_bytes_per_device"] == got["bytes"]
                  and pred["collective_counts"] == got["counts"],
                  f"dryrun {tag} rank {rank}: collectives "
                  f"{pred['collective_counts']} / "
                  f"{pred['collective_bytes_per_device']} B, measured "
                  f"{got['counts']} / {got['bytes']} B")
            mem = pred["memory"]
            predicted = mem["argument_size"] + mem["temp_size"]
            out["ranks"].append(dict(
                mesh=tag, rank=rank, block_bytes=pred["block_bytes"],
                tree_bytes=pred["tree_bytes"],
                whole_tree_bytes=pred["whole_tree_bytes"],
                collective_bytes=pred["collective_bytes_per_device"],
                collective_counts=pred["collective_counts"],
                flops=pred["flops_per_device"], memory=mem,
                predicted_bytes=predicted,
                measured_peak_bytes=meas["peak_total_bytes"],
                ratio=predicted / meas["peak_total_bytes"]))
            print(f"phase 15: dryrun of phase 14 (a)'s {tag} prefill, rank "
                  f"{rank}: blocks {pred['block_bytes']} B, compute tree "
                  f"held at once {pred['tree_bytes']} B (whole "
                  f"{pred['whole_tree_bytes']} B), collectives "
                  f"{pred['collective_counts']} calls / "
                  f"{pred['collective_bytes_per_device']} B, each = "
                  f"measured; argument + temp {predicted / 2**30:.3f} GiB vs "
                  f"measured peak {meas['peak_total_bytes'] / 2**30:.3f} GiB "
                  f"(ratio {predicted / meas['peak_total_bytes']:.3f}, "
                  f"reported), {pred['flops_per_device']:.4g} FLOPs")
    # (b) the CLI (``python -m repro_torch.launch.dryrun``'s ``main``, in
    # this process) allocates nothing on the card.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    argv, sys.argv = sys.argv, ["repro_torch.launch.dryrun", *DRYRUN_CLI]
    t0 = time.perf_counter()
    try:
        dryrun.main()
    except SystemExit as e:
        check(not e.code, f"dryrun {' '.join(DRYRUN_CLI)}: exit {e.code}")
    finally:
        sys.argv = argv
    cli_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), \
        torch.cuda.max_memory_allocated()
    check(after == before and peak == before,
          f"dryrun {' '.join(DRYRUN_CLI)}: card memory {before} -> {after} "
          f"B, peak {peak} B")
    out.update(cli=list(DRYRUN_CLI), cli_s=cli_s,
               card_bytes_before=before, card_bytes_after=after,
               card_peak_bytes=peak)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 15: dryrun {' '.join(DRYRUN_CLI)} in {cli_s:.1f} s, card "
          f"memory {before} B before, {after} B after, peak {peak} B; "
          f"phase 15 {out['seconds']:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on "
              "the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_s = {}
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import fast as fast_mod
    from repro_torch.core.engine import EngineConfig, GeoEngine
    from repro_torch.kernels import ops

    result = {}
    # -- 1. card, toolchain, kernel build ------------------------------------
    card = card_line()
    print(card)
    nvcc = subprocess.run([os.path.join(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), "--version"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{nvcc[-1] if nvcc else 'nvcc not found'}")
    # The host map (phase 3) needs no card: a child process builds it
    # while the card builds the kernels and runs the LM path.
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        host = pool.apply_async(host_map)
        smoke = Smoke()
        smoke.build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=smoke.build.BUILD_ROOT) as tmp:
            fault_build = start_fault_build(smoke.build, tmp)
            try:
                smoke.build.load()
            finally:
                faulty = load_fault(smoke.build, *fault_build)
        info = smoke.build.BUILD_INFO
        result["build_s"] = time.perf_counter() - t0
        print(f"kernel build: {result['build_s']:.2f} s "
              f"(cached={info['cached']}) -> {info['path']}; beside it the "
              f"flash kernel with KV tile {FAULT_TILE} skipped")
        for line in info["log"].splitlines():
            if ("Used" in line and "registers" in line) or "Compiling" in line:
                print(f"  {line.strip()}")

        phase_s["build"] = time.perf_counter() - t_start
        # -- 2. LM path -------------------------------------------------------
        main_calls, launches = {}, {}
        model, prompts, gen_tok = lm_path(smoke, result, launches,
                                          main_calls, faulty)
        flash_kernel = flash_row(smoke, main_calls["flash_attn_bhsd"],
                                 launches["flash_attn_bhsd"])
        phase_s["lm_path"] = time.perf_counter() - t_start
        # The LM's timing needs no host map: it runs while the child
        # process still builds the covering.
        lm_timing(model, prompts, gen_tok, result, card)
        del model, prompts, gen_tok
        phase_s["lm_timing"] = time.perf_counter() - t_start
        minicpm_path(smoke, result)
        flash_many_heads(smoke, result)
        phase_s["lm_faults"] = time.perf_counter() - t_start
        # -- 3. census, covering, engines -------------------------------------
        t0 = time.perf_counter()
        sc, cov, result["census_s"], result["covering_s"] = host.get()
        result["host_map_wait_s"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    census = sc.census
    cfg = EngineConfig(mode="exact", cap_boundary=0.5, max_level=MAX_LEVEL)
    # The cascade's caps of examples/quickstart.py.
    scfg = EngineConfig(cap_state=0.5, cap_county=0.5, cap_block=0.5,
                        max_level=MAX_LEVEL)
    specs = {
        "fast": ("fast", cfg),
        "fast_fused": ("fast", dataclasses.replace(cfg, fused=True)),
        "fast_onepass": ("fast_onepass", cfg),
        "simple": ("simple", scfg),
        "simple_fused": ("simple", dataclasses.replace(scfg, fused=True)),
        "hybrid": ("hybrid", EngineConfig(cap_boundary=0.5,
                                          max_level=MAX_LEVEL)),
    }
    t0 = time.perf_counter()
    engines = {name: GeoEngine.build(census, strategy, c, covering=cov)
               for name, (strategy, c) in specs.items()}
    torch.cuda.synchronize()
    result["engines_s"] = time.perf_counter() - t0
    result["footprint"] = engines["fast_onepass"].indices.memory_footprint()
    print(f"host build (a child process, waited for "
          f"{result['host_map_wait_s']:.2f} s after the LM path): census "
          f"{result['census_s']:.2f} s, covering "
          f"{result['covering_s']:.2f} s ({len(cov.lo)} cells, "
          f"{cov.n_boundary} boundary), {len(engines)} engines "
          f"{result['engines_s']:.2f} s; footprint {result['footprint']}")
    for name, eng in engines.items():
        check(eng.device.type == "cuda", f"{name} index not on cuda")
        print(f"  {name}: plan {eng.explain()['strategy']} "
              f"fused={eng.explain()['fused']}")
    sindex = engines["simple"].simple_index
    print(f"  simple index: state_edges {list(sindex.state_edges.shape)}, "
          f"county_edges {list(sindex.county_edges.shape)}, block_edges "
          f"{list(sindex.block_edges.shape)}, county_children "
          f"{list(sindex.county_children.shape)}, block_children "
          f"{list(sindex.block_children.shape)}")

    phase_s["host_build"] = time.perf_counter() - t_start
    # -- 4. kernel phase: each kernel vs its twin, each engine vs the CPU ---
    xy_k, truth_k, _, sid_k = sc.sample_points(np.random.default_rng(1),
                                                N_KERNEL)
    pts_k = torch.from_numpy(xy_k).cuda()
    for name, eng in engines.items():
        strategy, c = specs[name]
        cpu_ref = GeoEngine.build(census, strategy, c, covering=cov,
                                  device="cpu").assign(xy_k)
        check(float(np.mean(cpu_ref.block.numpy() == truth_k)) == 1.0,
              f"CPU twin engine {name}: accuracy below 1.0")
        with smoke.capture() as cap:
            res = eng.assign(pts_k)
        torch.cuda.synchronize()
        n_calls = smoke.check_all(cap, f"the {N_KERNEL}-point batch")
        for kname in ENGINE_KERNELS[name]:
            check(n_calls[kname] > 0, f"{name}: {kname} was not called")
        for a, b in zip((res.state, res.county, res.block),
                        (cpu_ref.state, cpu_ref.county, cpu_ref.block)):
            check(torch.equal(a.cpu(), b), f"{name} ids differ from the "
                                           f"CPU twin engine")
        check(res.stats.as_dict() == cpu_ref.stats.as_dict(),
              f"{name} stats {res.stats.as_dict()} differ from the CPU "
              f"twin engine {cpu_ref.stats.as_dict()}")
        print(f"kernel phase: {name}: "
              + ", ".join(f"{k} == twin on {n_calls[k]} call(s)"
                          for k in ENGINE_KERNELS[name])
              + f"; {name} == CPU twin engine (ids, stats)")
    with smoke.capture() as cap:
        pip_one_states(ops, sindex.state_edges, pts_k)
    torch.cuda.synchronize()
    n_calls = smoke.check_all(cap, f"the {N_KERNEL}-point batch")
    check(n_calls["crossings_one"] == sindex.state_edges.shape[0],
          "pip_one: crossings_one not called once per state")
    print(f"kernel phase: crossings_one == twin on "
          f"{n_calls['crossings_one']} call(s) (one per state table)")
    misaligned_phase(engines, pts_k)
    result["one_phase"] = one_phase(smoke, sindex, pts_k, census.extent)
    result["pool_phase"] = pool_phase(
        smoke, ops, sindex, engines["fast_fused"].fast_index, pts_k,
        torch.from_numpy(truth_k).cuda(), torch.from_numpy(sid_k).cuda())
    n_blocks = int(engines["fast"].fast_index.block_parent.shape[0])
    result["bbox_phase"] = bbox_phase(smoke, pts_k, census.extent)
    tile_rows = smoke.build.load().repro_segment_tile_rows()
    result["segment_phase"] = segment_phase(n_blocks, tile_rows)
    worst = max(r["sum_max_rel_err"] for r in result["segment_phase"]
                if r["values"] == "float")
    print(f"kernel phase: segment_reduce_sorted == twin and oracle on "
          f"{len(result['segment_phase'])} cases of {N_KERNEL} rows "
          f"(uniform, skewed 40 %, invalid parked and unparked, S = 1000, "
          f"S = 1, S = {4 * N_KERNEL}, {N_KERNEL + 3} rows, empty) and of "
          f"{SPAN_ROWS} rows (one segment over more than {SPAN_TILES} tiles of "
          f"{tile_rows} rows); integer, f32 and no values, each column also "
          f"4 bytes into a buffer (bit-equal to the aligned call): count / "
          f"min / max and integer-valued and zero-column sums exact, f32 "
          f"sums within {worst:.3g} of the f64 oracle (rtol {SUM_RTOL}), "
          f"second launch bit-equal, 1 launch without values and 2 with")

    phase_s["kernel_phase"] = time.perf_counter() - t_start
    # -- 5. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    xy, truth, _, truth_sid = sc.sample_points(np.random.default_rng(0),
                                               N_MAIN)
    result["sample_s"] = time.perf_counter() - t0
    pts = torch.from_numpy(xy).cuda()
    ids, stats = {}, {}
    result["peak_bytes"], result["checked_in_flight"] = {}, {}
    for name, eng in engines.items():
        keep = [k for k, path in ROW_PATH.items() if path == name]
        torch.cuda.reset_peak_memory_stats()
        with smoke.capture(keep=keep) as cap:
            smoke.build.reset_launches()
            res = eng.assign(pts)
            torch.cuda.synchronize()
            counts = dict(smoke.build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for kname, n in counts.items():
            want = kname in ENGINE_KERNELS[name]
            check((n > 0) == want, f"{name}: {kname} launched {n} times "
                                   f"(expected {'> 0' if want else '0'})")
        for kname in keep:
            launches[kname] = counts[kname]
            main_calls[kname] = cap.calls[kname]
        # The kept calls are held against their twins in section 7.
        checked = {k: v for k, v in cap.checked.items() if v["calls"]}
        for kname, c in checked.items():
            check(c["max_abs_err"] == 0, f"{kname} differs from its twin "
                  f"(max abs err {c['max_abs_err']}) on the {name} path")
        ids[name] = (res.state, res.county, res.block)
        stats[name] = res.stats.as_dict()
        result["peak_bytes"][name] = peak
        result["checked_in_flight"][name] = checked
        acc = float(np.mean(res.block.cpu().numpy() == truth))
        check(acc == 1.0, f"{name}: accuracy {acc} != 1.0")
        launched = {k: v for k, v in counts.items() if v}
        kept = sum(call_bytes(a, o) for calls in main_calls.values()
                   for a, _, o in calls)
        print(f"main path {name}: launches {launched}, accuracy {acc}, "
              f"peak device memory {peak / 2**30:.2f} GiB (of it, "
              f"{kept / 2**30:.2f} GiB of calls kept for timing), stats "
              f"{stats[name]}")
        for kname, c in checked.items():
            print(f"  {kname} == twin as it ran: {c['calls']} call(s), "
                  f"{c['rows']} rows, {c['bytes'] / 2**30:.2f} GiB")
    blocks = {name: v[2] for name, v in ids.items()}
    check(torch.equal(blocks["fast"], blocks["fast_fused"])
          and torch.equal(blocks["fast"], blocks["fast_onepass"]),
          "the three fast paths' block ids differ")
    check(stats["fast"] == stats["fast_fused"], "fast stats differ")
    check(stats["fast"]["overflow"] == 0
          and stats["fast"]["phase2_miss"] == 0, "fast overflowed")
    for key in ("n_boundary", "n_pip"):
        check(stats["fast_onepass"][key] == stats["fast"][key],
              f"fast_onepass {key} differs")
    check(all(torch.equal(a, b) for a, b in zip(ids["hybrid"], ids["fast"])),
          "hybrid ids differ from fast's")
    check(all(torch.equal(a, b)
              for a, b in zip(ids["simple"], ids["simple_fused"])),
          "simple ids differ from simple fused's")
    check(stats["simple"] == stats["simple_fused"],
          "simple stats differ from simple fused's")
    for name in ("simple", "hybrid"):
        check(stats[name]["overflow"] == 0, f"{name} overflowed")
    result["stats"] = stats
    padded = torch.zeros(PAD_TO, 2, device="cuda")
    padded[:N_PADDED] = pts[:N_PADDED]
    for name, eng in engines.items():
        rp = eng.assign_padded(padded, N_PADDED)
        ru = eng.assign(pts[:N_PADDED])
        for a, b in zip((rp.state, rp.county, rp.block),
                        (ru.state, ru.county, ru.block)):
            check(torch.equal(a[:N_PADDED], b), f"{name} padded ids differ")
            check(bool((a[N_PADDED:] == -1).all()),
                  f"{name} pad rows not -1")
        check(rp.stats.as_dict() == ru.stats.as_dict(),
              f"{name} padded stats differ")
    print(f"assign_padded: {N_PADDED} rows padded to {PAD_TO}: pad rows -1, "
          f"stats equal, on all {len(engines)} paths")
    # ops.pip_one: every point against each state's edge table.
    with smoke.capture() as cap:
        smoke.build.reset_launches()
        inside = pip_one_states(ops, sindex.state_edges, pts)
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    check(counts["crossings_one"] == sindex.state_edges.shape[0]
          and sum(counts.values()) == counts["crossings_one"],
          f"pip_one: unexpected launches {counts}")
    launches["crossings_one"] = counts["crossings_one"]
    main_calls["crossings_one"] = cap.calls["crossings_one"]
    pip_sid = torch.where(inside.any(0), inside.int().argmax(0), -1)
    share = float(np.mean(pip_sid.cpu().numpy() == truth_sid))
    result["pip_one_state_share"] = share
    print(f"main path pip_one: launches {counts['crossings_one']} "
          f"(crossings_one), {N_MAIN} points x "
          f"{sindex.state_edges.shape[0]} state tables; share of points "
          f"whose inside-state is the true state: {share}")

    phase_s["main_path"] = time.perf_counter() - t_start
    # -- 5b. analytics path --------------------------------------------------
    from repro_torch.analytics import AnalyticsConfig, BlockAggregator
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import segment as segment_mod
    agg = BlockAggregator.from_engine(engines["fast"])
    check(agg.n_blocks == n_blocks, "aggregator block count")
    with smoke.capture(keep=["segment_reduce_sorted"]) as cap:
        smoke.build.reset_launches()
        fused = agg.fused_counts(pts)
        torch.cuda.synchronize()
        counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["fused_counts"]
        check((n > 0) == want, f"fused_counts: {kname} launched {n} times")
    check(counts["segment_reduce_sorted"] == 1,
          "fused_counts: segment_reduce_sorted not launched exactly once")
    for kname, c in cap.checked.items():
        check(c["max_abs_err"] == 0, f"{kname} differs from its twin on "
                                     f"the fused_counts path")
    launches["segment_reduce_sorted"] = counts["segment_reduce_sorted"]
    main_calls["segment_reduce_sorted"] = cap.calls["segment_reduce_sorted"]
    bid_np = blocks["fast"].cpu().numpy()
    expect = np.bincount(bid_np[bid_np >= 0], minlength=n_blocks)
    check(np.array_equal(fused, expect),
          "fused_counts differs from np.bincount of the assigned ids")
    vals_np = np.random.default_rng(4).integers(-50, 50, N_MAIN).astype(
        np.float32)
    vals = torch.from_numpy(vals_np).cuda()
    smoke.build.reset_launches()
    red = agg.reduce(blocks["fast"], vals)
    torch.cuda.synchronize()
    check(smoke.build.LAUNCHES["segment_reduce_sorted"] == 2,
          f"BlockAggregator.reduce: segment_reduce_sorted launched "
          f"{smoke.build.LAUNCHES['segment_reduce_sorted']} times, not 2")
    oracle = ref_mod.np_segment_reduce(bid_np, vals_np, n_blocks)
    for out, got, want in zip(("count", "sum", "min", "max"), red, oracle):
        check(np.array_equal(got.cpu().numpy(), want),
              f"BlockAggregator.reduce {out} differs from the numpy oracle")
    oidx = engines["fast_onepass"].fast_index
    agg_red, raw = ops.assign_aggregate(
        pts, oidx.quant, oidx.cell_lo, oidx.cell_hi, oidx.cell_val,
        oidx.top_start, oidx.cand, oidx.block_bbox, oidx.edge_pool,
        n_segments=n_blocks, max_level=oidx.max_level, gbits=oidx.gbits,
        search_iters=oidx.search_iters, values=vals)
    check(torch.equal(raw[0], blocks["fast_onepass"]),
          "assign_aggregate's cascade ids differ from fast_onepass's")
    again = ops.segment_reduce(raw[0], vals, n_segments=n_blocks)
    check(all(torch.equal(a, b) for a, b in zip(agg_red, again)),
          "assign_aggregate differs from segment_reduce of its cascade ids")
    check(all(np.array_equal(a.cpu().numpy(), b)
              for a, b in zip(agg_red, oracle)),
          "assign_aggregate differs from the numpy oracle")
    result["fused_counts_active_blocks"] = int((fused > 0).sum())
    print(f"main path fused_counts: launches "
          f"{ {k: v for k, v in counts.items() if v} }; counts == "
          f"np.bincount of fast's ids on {N_MAIN} points "
          f"({result['fused_counts_active_blocks']} of {n_blocks} blocks "
          f"hit); reduce(ids, integer-valued column) == np_segment_reduce; "
          f"assign_aggregate(fast_onepass index) == segment_reduce of its "
          f"cascade ids == oracle")

    phase_s["analytics"] = time.perf_counter() - t_start
    # -- 6. serving path -----------------------------------------------------
    from repro_torch.obs import Tracer
    from repro_torch.serving import GeoServer, ServeConfig
    from repro_torch.serving import server as server_mod
    rng = np.random.default_rng(11)
    xy_s, bid_s, *_ = sc.sample_points(rng, 40_000)
    venue = int(np.bincount(bid_s[bid_s >= 0]).argmax())
    venue_pts = xy_s[bid_s == venue]
    stream, off = [], 0
    for second in range(SERVE_SECONDS):
        req = xy_s[off:off + SERVE_BACKGROUND]
        off += len(req)
        if len(venue_pts) and second >= 4:
            req = np.concatenate([req, venue_pts[rng.integers(
                0, len(venue_pts), SERVE_VENUE)]])
        stream.append((float(second), req))
    stream.append((SERVE_TAIL_T, xy_s[:1]))
    now = [0.0]

    def make_server(engine, cache, tracer=None, cls=GeoServer, **kw):
        return cls(engine, ServeConfig(
            buckets=SERVE_BUCKETS, cache=cache, analytics=AnalyticsConfig(
                window_s=8.0, slide_s=2.0, k_anon=5, sketch_bits=2048,
                clock=lambda: now[0])), tracer=tracer, **kw)

    def replay(server):
        # Every replay stamps the same request sequence (the analytics
        # source ids), so the distinct-source sketches can be compared.
        server_mod._Ticket._seq = itertools.count()
        out = []
        for ts, req in stream:
            now[0] = ts
            out.append(server.submit(req))
        return out

    tracer = Tracer(sample_rate=1.0)
    srv = make_server(engines["fast"], True, tracer)
    warm_s = srv.warm()
    torch.cuda.synchronize()
    smoke.build.reset_launches()
    t0 = time.perf_counter()
    served = replay(srv)
    torch.cuda.synchronize()
    result["serve_stream_s"] = time.perf_counter() - t0
    counts = dict(smoke.build.LAUNCHES)
    for kname, n in counts.items():
        want = kname in ENGINE_KERNELS["serving"]
        check((n > 0) == want, f"serving: {kname} launched {n} times")
    for (_, req), res in zip(stream, served):
        direct = engines["fast"].assign(req)
        for field in ("state", "county", "block"):
            check(np.array_equal(getattr(res, field),
                                 getattr(direct, field).cpu().numpy()),
                  f"served {field} ids differ from a direct assign")
    served_off = replay(make_server(engines["fast"], False))
    for a, b in zip(served, served_off):
        check(all(np.array_equal(getattr(a, f), getattr(b, f))
                  for f in ("state", "county", "block", "region")),
              "served ids differ with the hot-cell cache off")
    cpu_engine = GeoEngine.build(census, "fast", cfg, covering=cov,
                                 device="cpu")
    cpu_srv = make_server(cpu_engine, True)
    served_cpu = replay(cpu_srv)
    snap = srv.snapshot_analytics()
    check(snap == cpu_srv.snapshot_analytics(),
          "the card server's analytics snapshot differs from the CPU "
          "server's")
    for a, b in zip(served, served_cpu):
        check(np.array_equal(a.block, b.block),
              "served ids differ from the CPU server's")
    region = snap["regions"][0]
    check(region["observed"] == sum(len(r) for _, r in stream),
          "analytics observed count")
    check(region["finalized_total"] > 0, "no analytics window finalized")
    # The busiest window holds 8 requests (8 distinct sources): the venue
    # passes k_anon = 5 there and must top it.
    busiest = max(region["finalized"], key=lambda w: w["n_events"])
    check(busiest["top"] and busiest["top"][0]["block"] == venue,
          "the venue block does not top the busiest finalized window")
    text = srv.metrics_text()
    for stage in SERVE_STAGES:
        check(f'stage_latency_seconds_count{{stage="{stage}"}}' in text,
              f"metrics_text has no {stage} histogram")
    names = {sp.name for sp in tracer.buffer.snapshot()}
    check(SPAN_NAMES <= names, f"spans missing: {SPAN_NAMES - names}")
    result["serve_stream"] = dict(
        requests=len(stream), points=sum(len(r) for _, r in stream),
        warm_s=warm_s, finalized=region["finalized_total"],
        cache=srv.cache_snapshot(), spans=len(tracer.buffer))
    print(f"serving path: {len(stream)} requests "
          f"({result['serve_stream']['points']} points) in "
          f"{result['serve_stream_s']:.3f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }; ids == direct "
          f"assign, cache on == off, analytics snapshot == CPU server's "
          f"({region['finalized_total']} windows finalized, venue block "
          f"{venue} tops the busiest, [{busiest['start']}, "
          f"{busiest['end']}), with {busiest['top'][0]['count']} points); "
          f"spans {sorted(names)}; cache hit rate "
          f"{srv.cache_snapshot()['hit_rate']:.3f}")
    load = make_server(engines["fast"], True)
    load.warm()
    reqs = xy[:LOAD_REQUESTS * LOAD_POINTS].reshape(LOAD_REQUESTS,
                                                    LOAD_POINTS, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        now[0] = 100.0 + 0.05 * i
        load.submit(req)
    load_s = time.perf_counter() - t0
    lat = load.metrics.latency.snapshot_ms()
    stages = load.metrics.snapshot()["stages"]
    result["serve_load"] = dict(
        requests=LOAD_REQUESTS, points_per_request=LOAD_POINTS,
        seconds=load_s, pts_per_s=LOAD_REQUESTS * LOAD_POINTS / load_s,
        latency_ms=lat, stage_p50_ms={k: v["p50"] for k, v in stages.items()},
        cache=load.cache_snapshot())
    print(f"serving load: {LOAD_REQUESTS} requests x {LOAD_POINTS} points "
          f"in {load_s:.3f} s = {result['serve_load']['pts_per_s']:.4g} "
          f"pts/s; request latency p50 {lat['p50']:.3f} ms, p99 "
          f"{lat['p99']:.3f} ms; stage p50 ms "
          f"{ {k: round(v, 3) for k, v in result['serve_load']['stage_p50_ms'].items()} }"
          f"; cache hit rate {load.cache_snapshot()['hit_rate']:.3f}")

    phase_s["serving"] = time.perf_counter() - t_start
    # -- 7. timing ------------------------------------------------------------
    result["pts_per_s"], result["batch_device_ms"] = {}, {}
    for name, eng in engines.items():
        ts, dev = [], []
        for _ in range(TIMED_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng.assign(pts)
            end.record()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            dev.append(start.elapsed_time(end))
        result["pts_per_s"][name] = N_MAIN / float(np.median(ts))
        result["batch_device_ms"][name] = float(np.median(dev))
        print(f"{name}: {result['pts_per_s'][name]:.4g} pts/s (median of "
              f"{TIMED_BATCHES} batches of {N_MAIN}: host "
              f"{[round(t * 1e3, 3) for t in ts]} ms, CUDA events "
              f"{[round(t, 3) for t in dev]} ms)")
    # fused_counts end to end (host clock, synced by the counts' copy to
    # the host) and its parts on the card (CUDA events).
    ts = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg.fused_counts(pts)
        ts.append(time.perf_counter() - t0)
    parked = agg.fused_ids(pts)
    split = {
        "assign": cuda_ms(lambda: engines["fast"].assign(pts), 2),
        "fused_ids": cuda_ms(lambda: agg.fused_ids(pts), 2),
        "sort": cuda_ms(lambda: torch.sort(parked, stable=True),
                        KERNEL_REPS),
        "segment_counts": cuda_ms(lambda: ops.segment_counts(
            parked, n_segments=n_blocks), KERNEL_REPS),
    }
    sk_rng = np.random.default_rng(5)
    skewed = torch.where(torch.from_numpy(sk_rng.random(N_MAIN) < 0.4).cuda(),
                         venue, parked)
    skewed_sorted = torch.sort(skewed, stable=True)[0]
    zeros = torch.zeros(N_MAIN, device="cuda")
    # What reading a value column costs: the kernel on a zero column read
    # from memory against the main path's call, which reads none; their
    # outputs must be equal.
    parked_sorted = torch.sort(parked, stable=True)[0]
    read = segment_mod.segment_reduce_sorted(parked_sorted, zeros, n_blocks)
    unread = segment_mod.segment_reduce_sorted(parked_sorted, None, n_blocks)
    check(all(torch.equal(a, b) for a, b in zip(read, unread)),
          "segment_reduce_sorted: a zero column read differs from none")
    split["kernel_zero_column_read"] = cuda_ms(
        lambda: segment_mod.segment_reduce_sorted(parked_sorted, zeros,
                                                  n_blocks), KERNEL_REPS)
    split["kernel_no_values"] = cuda_ms(
        lambda: segment_mod.segment_reduce_sorted(parked_sorted, None,
                                                  n_blocks), KERNEL_REPS)
    sk_out = segment_mod.segment_reduce_sorted(skewed_sorted, zeros, n_blocks)
    sk_twin = ref_mod.segment_reduce(skewed_sorted, zeros, n_blocks)
    check(max(max_abs_err(a, b, "skewed") for a, b in zip(sk_out, sk_twin))
          == 0, "segment_reduce_sorted differs from its twin on the skewed "
                "2^24 rows")
    split["kernel_skewed"] = cuda_ms(lambda: segment_mod.segment_reduce_sorted(
        skewed_sorted, zeros, n_blocks), KERNEL_REPS)
    hot = int(sk_out[0][venue])
    result["fused_counts"] = dict(
        pts_per_s=N_MAIN / float(np.median(ts)),
        host_ms=[t * 1e3 for t in ts], device_ms=split,
        skewed_hot_rows=hot)
    print(f"fused_counts: {result['fused_counts']['pts_per_s']:.4g} pts/s "
          f"(median of {TIMED_BATCHES} batches of {N_MAIN}: host "
          f"{[round(t * 1e3, 3) for t in ts]} ms); on the card: assign "
          f"{split['assign']:.3f} ms, assign + park {split['fused_ids']:.3f}"
          f" ms, stable sort {split['sort']:.4f} ms (glue), segment_counts "
          f"(park + sort + kernel + normalize) {split['segment_counts']:.4f}"
          f" ms; kernel without values (the counts path) "
          f"{split['kernel_no_values']:.4f} ms, with a zero column read "
          f"{split['kernel_zero_column_read']:.4f} ms, with a zero column "
          f"on skewed ids ({hot} of {N_MAIN} rows in block {venue}) "
          f"{split['kernel_skewed']:.4f} ms")
    phase_s["geo_timing"] = time.perf_counter() - t_start
    kernels = []
    index = engines["fast_onepass"].fast_index
    # The least time a launch shows by the same clock: an empty kernel (a
    # spin of 0 cycles), timed as the kernels are.
    result["launch_floor_ms"] = floor = cuda_ms(
        lambda: torch.cuda._sleep(0), KERNEL_REPS)
    for kname, src in OFF_PATH.items():
        main_calls[kname] = gathered_boxes(smoke, main_calls[src])
        launches[kname] = 0
    for kname in KERNELS:
        if kname == "flash_attn_bhsd":
            continue
        calls = main_calls[kname]
        err = smoke.compare(kname, calls)
        check(err == 0, f"{kname} differs from its twin at the main "
                        f"path's inputs (max abs err {err})")
        fn = getattr(smoke.modules[kname], kname)
        ms = cuda_ms(lambda: [fn(*a, **kw) for a, kw, _ in calls],
                     KERNEL_REPS)
        plain = cuda_ms(lambda: [smoke.twin(kname, a, kw)
                                 for a, kw, _ in calls], 2)
        bound, bound_by, nbytes, n_ops = bound_ms(kname, calls, index,
                                                  fast_mod)
        rows = sum(a[0].shape[0] for a, _, _ in calls)
        library, extra = None, ""
        if kname == "segment_reduce_sorted":
            # torch.bincount computes the counts-only call's counts (its
            # parked segment S lands in one more bin); timed, never called
            # by the port.
            (ids_s, _, n_seg), _, (count, *_) = calls[0]
            check(torch.equal(torch.bincount(ids_s, minlength=n_seg)[:n_seg]
                              .int(), count.int()),
                  "torch.bincount differs from the segment kernel's counts")
            library = cuda_ms(lambda: torch.bincount(ids_s, minlength=n_seg),
                              KERNEL_REPS)
            extra = (f"; torch.bincount {library:.4f} ms; an empty kernel "
                     f"{floor:.4f} ms; with a value column (2 launches) "
                     f"{split['kernel_zero_column_read']:.4f} ms")
        elif kname == "crossings_candidates":
            result["candidate_rows"] = candidate_rows(calls)
            extra = "; rows a call " + ", ".join(
                f"{c['rows']} ({c['with_candidate']} with a candidate, "
                f"{c['alias_rows']} at the padding slots' alias point)"
                for c in result["candidate_rows"])
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library})
        path = (f"{ROW_PATH[kname]} path" if kname in ROW_PATH else
                f"boxes gathered from the {OFF_PATH[kname]} calls (off "
                f"the main path)")
        print(f"{kname}: {ms:.4f} ms per batch on the {path} "
              f"({len(calls)} call(s), {rows} rows) vs plain twin "
              f"{plain:.3f} ms; bound {bound:.4f} ms by {bound_by} "
              f"({nbytes} B, {n_ops} ops); {bound / ms:.1%} of bound{extra}")
    # bbox_mask at a second width: the main path's points against the
    # first BBOX_WIDE county boxes.
    bm = smoke.modules["bbox_mask"].bbox_mask
    wide = sindex.county_bbox[:BBOX_WIDE].contiguous()
    wide_call = ((pts, wide), {}, (bm(pts, wide),))
    err = smoke.compare("bbox_mask", [wide_call])
    check(err == 0, f"bbox_mask differs from its twin at {BBOX_WIDE} boxes "
                    f"(max abs err {err})")
    wide_ms = cuda_ms(lambda: bm(pts, wide), KERNEL_REPS)
    bound, bound_by, nbytes, _ = bound_ms("bbox_mask", [wide_call], index,
                                          fast_mod)
    del wide_call
    result["bbox_wide"] = dict(boxes=BBOX_WIDE, rows=N_MAIN, ms=wide_ms,
                               bound_ms=bound, bound_by=bound_by)
    print(f"bbox_mask at [{N_MAIN}, {BBOX_WIDE}] (county boxes): "
          f"{wide_ms:.4f} ms vs bound {bound:.4f} ms by {bound_by} "
          f"({nbytes} B); {bound / wide_ms:.1%} of bound")
    result["cascade_batches"] = cascade_batches(
        smoke, main_calls["assign_cascade"][0], census.extent,
        next(k["ms"] for k in kernels if k["name"] == "assign_cascade"))
    # The kept calls are timed: free them before the deployment paths.
    main_calls.clear()
    torch.cuda.empty_cache()
    next(k for k in kernels if k["name"] == "bbox_select_children")[
        "paper_shape"] = select_children_paper(smoke)
    torch.cuda.empty_cache()
    phase_s["kernel_timing"] = time.perf_counter() - t_start
    # -- 8. deployment paths ---------------------------------------------------
    cold_start_phase(smoke, engines, census, cov, cfg, xy, pts, result)
    phase_s["cold_start"] = time.perf_counter() - t_start
    async_phase(smoke, engines["fast"], make_server, replay, stream, now,
                served, snap, ids["fast"], reqs, result)
    phase_s["async_serving"] = time.perf_counter() - t_start
    pipeline_phase(smoke, engines["fast"], cpu_engine, pts, ids["fast"],
                   result)
    phase_s["pipeline"] = time.perf_counter() - t_start
    # -- 9. training -----------------------------------------------------------
    torch.cuda.empty_cache()
    train_launches = train_phase(smoke, engines["fast"], result)
    phase_s["train"] = time.perf_counter() - t_start
    # -- 10. the MoE family ----------------------------------------------------
    torch.cuda.empty_cache()
    moe = moe_phase(smoke, result, faulty)
    phase_s["moe"] = time.perf_counter() - t_start
    # -- 11. the vlm and encdec families --------------------------------------
    torch.cuda.empty_cache()
    xattn = xattn_phase(smoke, result, faulty)
    phase_s["xattn"] = time.perf_counter() - t_start
    # -- 12. the ssm_hybrid and xlstm families --------------------------------
    torch.cuda.empty_cache()
    recurrent = recurrent_phase(smoke, result, faulty)
    phase_s["recurrent"] = time.perf_counter() - t_start
    # -- 13. the Morton-sharded lookup ----------------------------------------
    torch.cuda.empty_cache()
    sharded_phase(smoke, engines, census, cov, xy, pts, ids, result)
    phase_s["sharded"] = time.perf_counter() - t_start
    # -- 14. the model half of distributed ------------------------------------
    torch.cuda.empty_cache()
    mesh = mesh_phase(smoke, result)
    phase_s["mesh"] = time.perf_counter() - t_start
    # -- 15. the dry-run ------------------------------------------------------
    torch.cuda.empty_cache()
    dryrun_phase(result)
    phase_s["dryrun"] = time.perf_counter() - t_start
    # The two PIP kernels' launches on the sharded path at (1, 1) beside
    # their main path's.
    for row in kernels:
        name = {"crossings_gathered": "sharded",
                "crossings_candidates": "sharded_fused"}.get(row["name"])
        if name:
            row["launches_by_path"] = {
                ROW_PATH[row["name"]]: row["launches"],
                name: result["sharded"]["one_rank"][name]["launches"][
                    row["name"]]}
    # Flash's launches: the training run (and, by path, the prefill's, a
    # training step's, the Mixtral, vlm, encdec and zamba2 forwards'); its
    # time at the Mixtral forward's shape (the vlm's too), at the encdec
    # encoder's (full) and decoder's (causal) and at zamba2's beside the
    # prefill's.
    flash_kernel["launches_by_path"] = {
        "lm_prefill": flash_kernel["launches"], **train_launches,
        "moe_forward": moe["launches"], **xattn["launches"],
        **recurrent["launches"], **mesh["launches"]}
    flash_kernel["launches"] = train_launches["train_run"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    flash_kernel["moe_forward_shape"] = {k: moe["timing"][k] for k in keys}
    for kind, row in xattn["timing"].items():
        flash_kernel[f"encdec_{kind}_shape"] = {k: row[k] for k in keys}
    flash_kernel["zamba2_shape"] = {k: recurrent["timing"][k] for k in keys}
    flash_kernel["mesh_tp_shape"] = {k: mesh["timing"][k] for k in keys}
    for kind, row in mesh["xattn_timing"].items():
        flash_kernel[f"{kind}_shape"] = {k: row[k] for k in keys}
    kernels.append(flash_kernel)
    result["kernels"] = kernels
    result["card"] = card
    result["total_s"] = phase_s["dryrun"]
    result["phase_end_s"] = phase_s
    print(f"smoke ran {result['total_s']:.1f} s; each phase ended at "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} } s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("kernels: " + ", ".join(sorted(k["name"] for k in kernels)))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
