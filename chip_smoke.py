#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dra_torch``) on one NVIDIA
GPU: builds its CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version, times it, then drives the
port's paths at full width: it serves the headline model through the
port's HTTP server (bf16 weights over pages; int8 weights over the slab
and over pages, plainly and speculatively with a distilled draft, and
behind the front end with a shared prefix, admission, deadlines and a
drain; from a checkpoint through a weights cache; and disaggregated,
through the KV handoff, beside tenants held to the launcher's
contracts), runs
the tiled matmul's bench section, trains the flagship model through
``fit`` and through the fused training step, and trains it sharded over
a virtual mesh of 4 ranks on the card (DP×TP with the fused-collective
ring kernels, DP×SP with ring flash attention); then it checkpoints,
preempts and resumes the flagship under goodput accounting, fine-tunes
the serving model with LoRA and trains the MoE model; last it serves
through the bucketed pool (/generate without --continuous, /beam,
/speculative) and reads the server's spans, exemplars and a device
trace; last it runs the rest of the virtual mesh (zigzag ring
attention, ZeRO-1, GPipe, expert parallelism, LoRA and quantized serving
shardings over a mesh) and the port's dryrun_multichip; then it holds the
engine's captured passes to the eager ones under the retrace guard, and
runs the multi-process host side (rendezvous, collectives, elastic
respawn) as processes on the one card; last it runs the ring kernels and
the DP×SP ring-flash step with one process a rank on the card, each
process's kernels writing into its neighbours' buffers through CUDA IPC,
and the DP×TP step (fused-collective and dense), the AdamW step and
fit, ring attention, zigzag, GPipe, expert parallelism, the MoE AdamW
step and fit, LoRA and the serving shardings, one process a rank.

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Phases (each prints as it goes; any failed check exits non-zero):
  1. build every kernel (one nvcc per source, all at once); print the
     build times, the ptxas register/spill lines and the card's name and
     power limit (nvidia-smi); fail if ptxas reports spill bytes for the
     flash forward kernel, the ring kernels, the split flash backward's
     two kernels, the RMSNorm-matmul's kernel or the paged attention's
     kernels (or serializes wgmma in any of them but the last);
  2. paged attention: kernel vs plain version at the serving path's shapes
     (B=32, H=8, Hkv=2, Dh=128, ps=64, MP=16), scrambled pages, -1 tails,
     lengths 0, 1, a page boundary, mid-page and the full MP*ps, and 4
     slots at the full MP*ps; bf16 pages within rtol/atol 0.05, int8 pages
     within 0.08 (the reference's own kernel-vs-oracle tolerances,
     tests/test_paged_kv.py), and every slot within paged_kv.SLOT_REL_TOL
     relative L2 error; a second call must give the same bits;
  3. time the paged kernel, the plain version and a library yardstick with
     CUDA events at one decode step of a full 160-page pool, and at 4 slots
     of 1024 tokens, by a loop of launches (the kernel and the library
     call also from CUDA graphs, where the host's launch cost drops out);
     at both, the kernel's share of its bound, its ratio to the library
     call and its time before the split-page redesign;
  4. serve: start serve() on port 0 with the full-width model (vocab
     32768, d_model 1024, 8 heads over 2 kv heads, 8 layers, d_ff 4096,
     rope, bf16 weights from a seed), the paged layout, slots 32, chunk
     8, page size 64, 160 pages; POST 8 concurrent greedy /generate
     requests and check each answer against the port's
     paged_greedy_decode on the card, and that the decode went through
     the kernel (launch counts);
  5. flash attention: the forward, dQ, dK/dV and fused-backward kernels
     vs their plain versions at the training path's shapes ([256, 1024,
     128] causal, and the GQA run's [64 over 16, 1024, 128]) and at S 1,
     63, 64, 65, 1000, causal and not, g 1 and 4, D 64 and 128; out, l2,
     dq, dk and dv each held elementwise and per head-row (relative L2
     over the row's [S, D]), tolerances flash.ELEM_TOL and flash.ROW_TOL;
     a second call of the fused backward, and of the split pair (dQ, dK/dV),
     must give bit-equal dq, dk, dv;
  6. time the four flash kernels, their wrappers and plain versions, and
     the library yardstick (scaled_dot_product_attention forward, and its
     backward for the backward kernels) with CUDA events at the path's
     shapes and at one rank's block of the DP×SP step ([256, 256, 128],
     causal and full); for the forward, the fused backward and the split
     pair, each one's share of its bound, its ratio to the SDPA call and
     its time before the TMA/wgmma redesign, and the fused backward's
     scratch bytes;
  7. matmul kernels: the tiled matmul at 4096^3, k 512, a rectangle and
     ragged tiles, the fused RMSNorm-matmul at the flagship's ln1 -> wqkv
     and ln2 -> w1 ([16384, 2048] @ [2048, 6144] and @ [2048, 8192]), m <
     256, K 64 and K 1024, each held elementwise and per output row
     (matmul.ELEM_TOL, matmul.ROW_TOL); their times beside bound, plain
     version and library yardstick (torch.matmul; for the fused kernel the
     unfused pair, two calls); then tpu_dra_torch.bench's
     section_pallas_matmul, the tiled matmul's path (launch counts), and
     the matmul's share of its bound, its ratio to torch.matmul and its
     time before the wgmma redesign; the RMSNorm-matmul's share of its
     bound, its ratio to the unfused pair and its time before its wgmma
     redesign;
  8. train the flagship at full width (vocab 32768, d_model 2048, 16
     heads, 8 layers, d_ff 8192, max_seq 1024, learned positions; ~539 M
     fp32 parameters from a seed) on a synthetic token file: first one
     step's loss and gradients with the flash kernels against the same
     step with plain dense attention, then fit() for 10 steps at batch 16
     with finite, falling losses, the flash forward launched 2 x
     n_layers x steps times (the trunk's remat recomputes it in the
     backward) and each backward kernel n_layers x steps times; then
     (informational) the same fit with dense attention and one step
     under torch.profiler;
  9. the fused training path (norm_impl="fused", and the fused flash
     backward selected through flash.TUNE_FILE): one step against the
     split/plain-pair step of phase 8, then 10 make_train_step steps on
     [16, 1025] windows with finite, falling losses, exactly 2 x n_layers
     norm-matmul launches (never recomputed), 2 x n_layers flash forwards
     and n_layers fused-backward launches a step and no split
     launch; two steps from the seed run again must give bit-equal losses;
     its step time beside phase 8's, and one profiled step;
 10. a short GQA training run (8 heads over 2 kv heads, d_head 128, rope,
     2 layers), so the grouped forward and backward run inside training;
 11. the ring kernels (csrc/ring.cu) against their plain versions on a
     virtual ring of 4 ranks at the flagship's tp-4 shapes (all-gather-
     matmul at x [4096, 2048] per rank against the wqkv, w1 and wo^T
     shards, matmul-reduce-scatter at [16384, 512] @ wo, [16384, 2048] @
     w2 and [16384, 1536] @ wqkv^T: every shape of the DP×TP step's
     forward and backward; the shift at k/v blocks [16, 16, 256, 128]),
     then n 1 and 2, odd m,
     a ragged K and two groups: y elementwise and per row
     (collective_matmul.ELEM_TOL, ROW_TOL), the gathered operand and the
     shift byte-equal, the VJPs against autograd through the plain
     versions; then RING_BACK_TO_BACK (50) calls of each ring matmul
     enqueued with no host synchronize between them, on fresh inputs
     each, every output held to its plain version afterwards (each call
     is one launch that synchronizes its ring steps in the kernel on
     flags that carry the call's epoch: a flag or slot taken from the
     call before shows here);
 12. their times beside bound, plain version and library yardstick; each
     ring matmul's share of its bound, its ratio to the library call, its
     time before the wgmma redesign and its time as one launch a ring
     step (the earlier design);
 13. DP×TP on Mesh({"dp": 1, "tp": 4}): the flagship's
     make_sharded_train_step(attn_impl="flash",
     matmul_impl="fused_collective") step against the dense sharded step,
     then 10 SGD steps with exact ring launch counts (4·L of each ring
     kernel a step, one launch a call; no ring runs again in the
     backward) and 2 x n_layers flash forwards a step, its step
     time beside
     the dense step's, and one profiled step (the ring kernels' device
     time and the step's idle share);
 14. DP×SP on Mesh({"dp": 1, "sp": 4}): make_ring_train_step(ring_impl=
     "flash", hop_impl="pallas") bit-equal to hop_impl="xla", held to the
     one-device flash step, then 10 steps with an exact shift count
     (6·(n−1)·L a step: each block recomputed whole in the backward, as
     the reference's jax.checkpoint(block));
 15. the quantized weight forms (quant.py) at the serving model's matmul
     shapes (K x N of wqkv, wo, w1, w2 and unembed; 8, 32 and 256 rows):
     the int8 product through torch._int_mm bit-equal to its plain int32
     version (with the weight column-major, as quantize_int8 stores it,
     and row-major), and the whole int8_matmul bit-equal to the plain
     version on the CPU; int4 (bf16 operands, fp32 accumulation) within
     INT4_CARD_REL of the fp32 plain version; the STE backward and LoRA
     over an int8 base within one bf16 rounding; their times beside
     torch.matmul of the bf16 weights (informational);
 16. serve the headline configuration (phase 4's model and requests) with
     int8 weights from the seed through serve(), on the slab (32 slots,
     chunk 8) and on pages (64-token pages, 160 pages): every answer held
     to the port's greedy_decode on the card under argmax_tol, an int8
     product on every matmul (counts), the paged run launching the paged
     attention kernel n_layers times a decode step and the slab run never;
     one decode step of each layout at 32 slots under torch.profiler, and
     tpu_dra_torch.bench.section_decode at DECODE_STEPS steps (the
     bench's own run takes 256; bf16, int8 and int4 decode tokens/s;
     both informational);
 17. speculative serving at full width: phase 16's model, int8, with a
     draft made by spec_draft.make_draft (2 layers distilled 150 steps at
     batch 16, seq 256 from the fp32 tree, then int8), served through
     serve(draft=..., speculative_engine=True) at 16 slots, chunk 8, on
     the slab and on pages (64-token pages, 320 pages), 32 requests with
     prompts of 16-128 tokens and 32-128 steps: every answer held to the
     plain engine's of its layout under argmax_tol, the paged-attention
     kernel launched exactly draft layers x chunk times a pass on pages
     and never on the slab, a sampled batch of 8 in range; draft ==
     target accepting every proposal on the slab (on pages
     informational); plain and speculative tokens/s, accept rate, tokens
     per pass, the distillation's seconds and one pass of each layout
     under torch.profiler (informational);
 18. the front end at full width: phase 17's int8 model and draft behind
     serve() with admission on (admission_max_cost 8192), a 200-token
     system prompt through POST /prefix (3 full 64-token pages and an
     8-token tail) and 32 concurrent /generate requests naming it
     (suffixes 16-128 tokens, 32-128 steps) on pages (32 slots, chunk 8,
     160 pages) and on the slab (32 slots): every answer held to the
     port's greedy decode of prefix + suffix in the engine's layout
     (decode_ragged, or paged_greedy_decode, each over the 32 full
     prompts in one batch) under argmax_tol; on pages the paged
     attention kernel launched exactly n_layers times a decode step,
     more slots active at once than unshared pages admit (20), pages in
     use at the peak equal to the 3 shared pages and the joiners' own,
     the pool back to total - 3 after the load and to total once the
     prefix is evicted; eight prefix requests through the speculative
     engine in both layouts held to the plain engine's answers (#1
     launched exactly draft layers x chunk times a pass on pages);
     /stream equal to its final tokens and to /generate; a stop trimmed
     at its first occurrence; X-Deadline-Ms 200 under the slow-decode
     failpoint answering 504 deadline_expired with the pages back and
     badput counted; a request over the admission bound and a burst
     over it answering 503 with Retry-After; /metrics parsing, its
     /generate counts by code equal to what was sent; the reference's
     keys in /debug/slo and /debug/overload; drain() finishing the
     in-flight request and answering new ones 503; TTFT p50/p95 and
     tokens/s with the prefix against full prompts (informational);
 19. the lifecycle: (a) the flagship's widths cut to RESUME_LAYERS
     layers through fit, 6 steps at batch 16 saving at steps 3 and 6 (checkpointing.py), step 6's commit marker
     removed as a preemption mid-save leaves it, then fit(resume=True)
     for 3 steps: it must start at step 3, sweep the unmarked step, and
     give losses 4-6 and step 6's parameters and AdamW moments bit-equal
     to the uninterrupted run's, the flash forward launched 2 x n_layers
     x steps times and each backward kernel n_layers x
     steps times; save and restore seconds and bytes printed; (b) the
     fit command line, started before (a) and run beside it, trains
     phase 4's serving model 20 steps (flash, batch 8) and saves it; the server command line serves that
     checkpoint as int8 through --weights-cache (a miss: quantized and
     saved), then from the cache alone (a hit: restored, no
     quantization; this start, the int4 refusal below and the first
     auto-draft start run at once), 8 greedy requests one after another each time: every
     answer held to paged_greedy_decode of the restored-then-quantized
     tree under argmax_tol, the hit's answers bit-identical to the
     miss's, #1 launched exactly n_layers times a decode step (from
     /stats); --weights int4 against the int8 cache refused; two starts
     with --auto-draft --auto-draft-cache (the first distills and saves,
     the second restores with 0 s of distillation), answers equal, #1
     launched draft layers x chunk times a pass; (c) LoRA at r = 8 on
     that checkpoint with flash (GQA #4, #6, #7), 10 steps: losses
     finite and falling, the base bit-equal; the wrapped forward's logits
     within argmax_tol of the merged tree's; merged, int8, served through
     serve() on pages, answers held to paged_greedy_decode; (d) the MoE
     model at the flagship's widths (8 experts, capacity factor 1.25),
     top-1 and top-2: one step with flash against dense attention within
     STEP_LOSS_ATOL and STEP_LEAF_REL with the flash pass's routing
     replayed (the unpinned gap printed), then fit 5 steps at batch 8,
     losses finite and falling, the flash forward launched 2 x n_layers a
     step (the block's remat) and each backward kernel n_layers; peak
     memory and step time (informational);
 20. the rest of the server, on phase 17's int8 model and draft: (a)
     serve(continuous=False) with the draft armed, phase 4's 8 prompts
     as one /generate of POOL_STEPS steps, bit-equal to decode of the same
     padded batch [8, 128] (tokens/s and the request time printed), each
     row held to the slab decoder under argmax_tol; (b) /beam of 4 rows
     of 32 tokens, W = 4, 32 steps, bit-equal to beam_decode called
     directly, scores sorted, W = 1 equal to greedy_decode (a departure
     only at a near-tie), each best score within 2^-5 a token of the
     teacher-forced sum of its tokens' log-probabilities; (c)
     /speculative with k = 4 over those rows, with the serving model as
     its own draft and with the distilled draft: bit-equal to
     speculative_decode with the same target passes, held to
     greedy_decode under argmax_tol, the passes printed; (d) the server
     command line on phase 4's engine (int8 weights from seed 0; started
     while (a)-(c) run; a process of its own, whose only profiler is the server's: in this
     process, after the earlier phases, loaded sessions have come back
     with runtime records and no kernel record at all, a fault not yet
     explained; ROADMAP.md §3): one request with a traceparent, its
     serve.request and serve.engine.decode spans on /debug/traces, an
     exemplar trace id of an OpenMetrics scrape that resolves there, and
     one /debug/jax-trace?seconds=1 taken while waves of 8 requests run
     (half a second apart: a first profiler session starts only while
     the captured chunk pauses), holding
     CUDA kernel events, kernel #1's among them (its bytes and event
     counts printed); (e) phase 19a runs under
     goodput accounting (TPU_GOODPUT_FILE given to start_from_env): each
     segment's seconds and the ratio printed, the segments summing to
     the wall time within 1%, checkpoint_save and restore within 1% (and
     the printed values' rounding) of the save and restore times 19a
     printed;
 21. disaggregated serving and the launcher's contracts: (a) phase 4's
     model (bf16 from the seed) on three servers of phase 4's engine, a
     pool_role="prefill" one, a "decode" one and an "any" one as the
     oracle; HANDOFF_PROMPTS' 4 prompts of 17-700 tokens, one after
     another, each through
     /prefill then /decode_handoff with the blob, greedy and sampled at
     temperature 0.8 with a fixed seed, HANDOFF_STEPS steps: every
     answer bit-equal
     to the oracle's /generate (blob bytes, export and /decode_handoff
     times and both TTFTs printed); then all 4 at once, held to the
     oracle under argmax_tol; kernel #1 launched at least n_layers times
     a decode step; the decode engine's pages back to its total; a blob
     with a lying shape a 400 and the engine answering after it; (b) the
     sequential part again on phase 17's int8 weights with int8 pages on
     the decode and oracle servers, bit-equal; (c) one handoff's ks and
     vs as [1, 2, ...] blocks of a two-rank ring through
     kv_handoff.ici_shift one hop and back, bit-equal to ring_shift_ref,
     4 ring-shift launches; (d), beside (a)-(c) and phase 22 (their
     processes share the card), two server command lines as tenants of
     one card (the environment tenancy.tenant_edits writes: a slot pool
     of 2, an 8 GiB budget on chip 0, a priority, a heartbeat file)
     answer 8 requests each at the same time, each tenant's
     max_memory_reserved within its budget; a third tenant exits
     non-zero with the slot error; the tenants' heartbeat files are
     gone after their SIGTERM exit; a child under the same budget
     allocates half of it, then past it, gets torch.cuda.OutOfMemoryError
     and drops the oom sentinel, its heartbeat advancing;
 22. packed training at full width: the phase-8 flagship with dense
     attention (the reference's packed path: the flash kernels have no
     segment mask, so this path runs no hand-written kernel) on [16,
     1025] rows that data.pack_documents packs from documents of 17-700
     tokens: one packed_loss_fn loss and gradient, every leaf finite; the
     packed loss equal to the token-weighted mean of the same documents'
     losses taken alone within PACK_LOSS_ATOL; a packed row's trunk
     activations at one document's positions equal to that document run
     alone within STEP_LEAF_REL relative L2; the padding token's
     embedding row without gradient (its positions see only padding and
     predict nothing); its seconds and peak memory printed.  Two broken
     variants show the checks catch them: without the segment mask the
     document's activations depart past STEP_LEAF_REL, and without the
     valid mask the padding row gets a gradient.
 23. the rest of the virtual mesh at full width: (a) zigzag ring
     attention on Mesh({"dp": 1, "sp": 4}) at [2, 16, 4096, 128] bf16 and
     GQA 8 over 2 (C = 512): both engines, unpermuted, held to the
     one-device causal flash forward (ELEM_TOL, ROW_TOL), the fp32 engine
     also to the plain fp32 attention, the flash engine's dq, dk, dv to
     the one-device flash backward within STEP_LEAF_REL, exactly 3n
     forward and 3n of each backward launch, its time beside
     ring_attention_flash's (informational); (b) the phase-8 flagship
     through make_optax_train_step on Mesh({"dp": 2, "tp": 2}), 5 steps
     with zero1=True bit-equal (losses, parameters, moments) to 5 with
     zero1=False, the moment bytes a rank of both (every leaf with a
     dp-divisible replicated dimension halved), then fit(mesh=Mesh({"dp":
     4, "tp": 1}), zero1=True) 5 steps, finite and falling; (c) GPipe on
     Mesh({"dp": 1, "pp": 4}), n_micro 4, batch 16: one step held to the
     one-device SGD step (STEP_LOSS_ATOL, STEP_LEAF_REL), 5 steps finite
     and falling, the step time beside the one-device step's and the
     bubble 3/7; (d) phase 19d's MoE model (top-1, batch 8) on
     Mesh({"dp": 1, "ep": 4}): the SGD step held to the one-device step
     with its routing replayed (moe.PinnedChoices), 3 steps timed, and
     make_moe_optax_step(zero1=True) 3 steps bit-equal to zero1=False at
     2 layers, on dp 1 x ep 4 and dp 2 x ep 2; (e) phase 19c's LoRA step
     on Mesh({"dp": 2, "tp": 2}) bit-equal to the one-device step; (f)
     the int8 and int4 trees of the serving model through
     quant.serving_param_shardings on Mesh({"dp": 1, "tp": 4}) and back,
     every leaf equal, greedy tokens of phase 4's prompts equal; (g)
     tpu_dra_torch.entry.dryrun_multichip(4), whose MULTICHIP_REPORT line
     it prints.  Every kernel launched in these paths is added to its
     row of the kernels line.
 24. the captured passes: phase 16's model (int8 weights from a seed)
     and engines at 32 slots, chunk 8, on the slab and on pages, each
     stopped and driven from this thread over 32 admitted requests of
     16-128 tokens: one decode step captured in a CUDA graph against the
     same step run eagerly (the largest logit gap printed, any differing
     argmax row a near-tie), then GRAPH_CHUNKS chunks replayed from the
     engine's captured program against the eager chunk on the same state
     (tokens equal, or a departed row at an eager near-tie; the caches
     written equal), and GRAPH_CHUNKS speculative passes with a
     2-layer truncated draft (tokens and counts equal); each kind timed
     eager and graphed (host clock, GRAPH_TRACE_CHUNKS passes with the
     readback) and traced once each (device busy, idle share); then an
     engine with the retrace guard on (TPU_DRA_RETRACE_GUARD=1): warmup
     over every prompt bucket, the 32 requests at once, and
     recompiles_since_mark must read 0 with one program tracked, #1
     launched exactly n_layers times a decode step on pages; a parameter
     leaf replaced instead of copied in place, then one request, must
     read 1; then tpu_dra_torch.bench's section_continuous and
     section_paged (tokens/s, p50 and p95; informational);
 25. the multi-process host side on one card: psum_job as two processes
     of one domain, 127.0.0.1 and 127.0.0.2 in a settings dir's
     nodes_config.json, --backend gloo (NCCL refuses two ranks on one
     card): both resolve, join one group, print n_devices 2, the same
     all_reduce sum (on a tensor on the card) and the four bandwidths
     (host buffers over loopback: no card-to-card figure); run_elastic
     over a worker that exits for reconfiguration while the domain grows
     from 1 member to 2: the respawned worker carries generation 2 and
     resolves a world of 2; section_collectives in this process (no
     group) answers the reference's single-device skip, and in two gloo
     processes on the card (buffers of PSUM_MIB, 8 iterations) gives the
     four bandwidths and the fused collective-matmul comparison
     (ProcessRing's kernels against a group all-gather then a matmul and
     a matmul then a group reduce-scatter, (m, K, N) = (1024, 2048,
     2048) a rank, host clock, synced): the figures printed with the
     card's name, and a collective_matmul_error fails the phase.
 26. the ring kernels and the DP×SP step across processes: 4 processes
     on the one card, started through the port's rendezvous
     (launcher.run_local_group: each resolves its triple and joins one
     gloo group; NCCL refuses two ranks on one card), one rank each;
     a rank that fails fails the phase.  (a) collective_matmul.
     ProcessRing over the 4 and over the pairs {0, 1} and {2, 3} at
     once: all_gather_matmul at x [4096, 2048] (m even: bidirectional at
     n = 4) and [4095, 2048] (m odd) against the wqkv shard [2048, 1536],
     matmul_reduce_scatter at x [16384, 2048] @ w2 [2048, 2048], the
     shift of a k/v block [16, 16, 256, 128] both ways, each forward and
     VJP (ProcessAllGatherMatmul, ProcessMatmulReduceScatter,
     ProcessRingShift): every rank's y, a, reduce-scatter y, shift and
     dx / dw byte-equal to its rank's slice of the virtual ring's
     kernels on the same global inputs, y within ELEM_TOL / ROW_TOL of
     the group plain version (copies byte-equal), launches exact per
     process (one a call), then PROCESS_BACK_TO_BACK (10) gathers and
     reduce-scatters a process with no host synchronize and no group
     barrier between them, every output byte-equal to the virtual ring's
     afterwards, and a call's time by CUDA events (no host barrier in a
     call; informational, beside the earlier design's); (b) the
     flagship's widths at PROCESS_LAYERS layers on ProcessMesh({"dp": 1, "sp": 4}) at batch 16 on [16,
     1025] windows: one make_ring_train_step(ring_impl="flash") step at
     lr 1 with hop_impl="pallas" bit-equal to "xla" in every process,
     rank 0's held to the virtual mesh's step that this process took
     first (STEP_LOSS_ATOL, STEP_LEAF_REL), then PROCESS_STEPS (2) SGD
     steps with finite, falling losses and exact launches in each
     process: 6·(n−1)·L
     shifts, 2·(idx+1)·L flash forwards and (idx+1)·L of each backward
     kernel (the reference's per-device lax.cond folds step t's block
     only where t <= idx; summed over the ranks, the virtual step's
     rank-launches); the step's time and a gloo psum of the gradients'
     size (host memory; informational).
 27. the DP×TP step across processes, in phase 26's group after 26b:
     the flagship's widths at PROCESS_LAYERS layers on
     ProcessMesh({"dp": 1, "tp": 4}) at batch 16 on [16, 1025] windows with attn_impl="flash", each
     process holding its shards (ProcessMesh.shard_tree).  (a) one
     make_sharded_train_step(matmul_impl="fused_collective") step at lr
     1 against the virtual mesh's fused step that this process took
     first: the loss within STEP_LOSS_ATOL and each leaf's update within
     STEP_LEAF_REL, the norms assembled from each rank's squared sums
     psummed over the group; (b) PROCESS_STEPS SGD steps with finite,
     falling losses and exact launches in each process: 4·L of each
     ring kernel, 2·L flash forwards and L of each backward kernel a
     step; the step time (host clock, synced), the shares spent in ring
     calls and in the gloo collectives, and peak memory (informational);
     (c) the dense step (matmul_impl="dense", Megatron TP with gloo
     all-reduces) at TP_DENSE_LAYERS layers, one step at lr 1 against
     the virtual mesh's dense step, with the same tolerances.
 28. the AdamW step and fit across processes, in phase 26's group after
     27 (27's trees freed): the flagship's widths at PROCESS_LAYERS
     layers on ProcessMesh({"dp": 2, "tp": 2}) at batch 16 on 26's [16, 1025] windows, attn_impl="flash", the
     default optimizer (clip 1.0, AdamW 3e-4, decay 0.01).  (a)
     PROCESS_STEPS make_optax_train_step(matmul_impl=
     "fused_collective") steps, the first held to the same step on the
     virtual mesh dp 2 × tp 2 that this process took first: the loss
     within STEP_LOSS_ATOL and each leaf's first moment within
     STEP_LEAF_REL (norms from each rank's squared sums psummed over the
     group), the share of elements whose update's sign differs from the
     virtual step's printed (informational); (b) the same steps with
     zero1=True, run in turn with (a): after every step the parameters
     and moments bit-equal to (a)'s in every process (shard against
     shard), a process's moment bytes those of opt_state_bytes_per_rank
     and half of (a)'s; each step's time (host clock, synced), its
     shares in the gloo collectives, the gradient psum and the
     optimizer, and peak memory (informational); launches of (a) and (b)
     exact in each process: 4·L of each ring kernel, 2·L flash
     forwards and L of each backward kernel a step; (c) fit(mesh=the
     same mesh, zero1=True, head_impl="chunked", attn_impl="flash") at
     TP_DENSE_LAYERS layers on phase 8's corpus at batch 16: 2 steps
     uninterrupted, 1 saving at 1, then 1 resumed saving at 2, the
     resumed losses and the step-2 shards bit-equal to the uninterrupted
     run's, launches exact (no ring kernel), the save and restore
     seconds printed; this process then reads the checkpoint back and
     holds its tree, shapes and dtypes to a one-process run's.
 29. ring attention, zigzag, GPipe and ici_shift across processes, in
     phase 26's group after 28, each held to a yardstick the parent
     computed on the virtual mesh before the group started.  (a) on
     ProcessMesh({"sp": 4}), make_zigzag_ring_attention with both
     engines at ZIGZAG_CASES' two shapes (flagship heads and GQA 8 over
     2): every process passes the same global q, k, v and gets the
     global output and the q, k, v gradients of a fixed cotangent, each
     within flash.ELEM_TOL elementwise and STEP_LEAF_REL relative L2 of
     the virtual mesh's; the flash engine launches exactly 2n + 1 = 9
     forwards (#3, or #4 under GQA) and 9 of each backward kernel (#6,
     #7) a process a call, the per-process schedule running its own
     branch of the reference's lax.cond; a call's forward and forward
     plus backward timed (CUDA events, informational); (b) the same for
     make_ring_attention_flash and make_ring_attention with
     hop_impl="pallas" at the flagship-heads shape: #3 and each backward
     kernel 1 + idx times in rank idx, #11 2(n − 1) times forward and as
     many backward; (c) on ProcessMesh({"dp": 1, "pp": 4}) GPipe of the
     flagship at batch 16, n_micro 4, on 26's windows: each process
     builds the tree from the seed, keeps its stage's shards and frees
     the rest; one step at lr 1 held to the virtual mesh's pipeline step
     (the loss within STEP_LOSS_ATOL, every leaf's update within
     STEP_LEAF_REL, norms from each rank's squared sums; whether it is
     bit-equal printed), the replicated leaves the same bits in all 4
     processes, then PROCESS_STEPS steps with finite losses and no
     kernel launched (the stages run dense attention); the step time
     (host clock, synced), its shares in the activation hops and the
     gradient psum (gloo), peak memory and the bubble (pp − 1) /
     (n_micro + pp − 1); (d) kv_handoff.ici_shift with the ring of the
     4 on a seeded handoff of the serving model's shape (8 layers, 2 kv
     heads, head dim 128, a 1024-token prompt) as a bf16 cache and an
     int8 cache with fp32 scales, one dict of six leaves: one hop on is
     byte-equal to the neighbour's block, and back to the start, with
     exactly one #11 launch a leaf a direction.
 30. expert parallelism, the MoE AdamW step and fit, LoRA and the serving
     shardings across processes, in phase 26's group after 29, each held
     to a yardstick the parent computed on the virtual mesh before the
     group started; every process builds its trees from the seed (one
     process at a time where the tree is the MoE's), keeps its shards and
     frees the rest.  (a) on ProcessMesh({"dp": 1, "ep": 4}) the
     flagship MoE (MOE_MODEL: 8 experts, two a process; top-2, capacity
     factor 1.25) at batch 8 on the first rows of 26's windows, flash
     attention: one make_moe_train_step step at lr 1 held to the virtual
     mesh's (the loss within STEP_LOSS_ATOL, every leaf's update within
     STEP_LEAF_REL, norms from each rank's squared sums; whether it is
     bit-equal printed; where any route differs from the virtual step's,
     the number printed and the step taken again on the virtual step's
     choices, moe.PinnedChoices), then PROCESS_STEPS steps at SGD_LR with
     finite, falling losses; exactly 2·L #3 launches and L of #6 and #7
     a step in every process; the step time, its gloo share and peak
     memory (informational); (b) on ProcessMesh({"dp": 2, "ep": 2}) the
     same model at 1 layer: PROCESS_STEPS make_moe_optax_step steps,
     replicated, then zero1=True, from the same shards (one run on the
     card at a time), bit-equal after every step (losses, and digests of
     the parameters and moments), the first held to the virtual mesh's
     by its loss and first moments; a process's moment bytes half of replicated;
     the routes that differ from the virtual step's and the token-layers
     whose kept choices routing the rows alone would change, printed;
     launches exact; (c) fit of that model on the same mesh (zero1,
     flash) on phase 8's corpus at batch 8: 2 steps uninterrupted, 1
     saving at 1 (rank 0 gathers the state on its host and writes it),
     then 1 resumed, the resumed loss and the step-2 shards and moments
     bit-equal, launches exact, the save and restore seconds printed;
     this process then reads the checkpoint back and holds its tree,
     shapes and dtypes to a one-process run's;
     (d) on ProcessMesh({"dp": 2, "tp": 2}) LoRA (r 8, B drawn non-zero)
     on the serving model (8 heads over 2 kv heads) at batch 8, flash:
     PROCESS_STEPS make_lora_train_step steps, each loss within
     STEP_LOSS_ATOL of the virtual mesh's and each adapter leaf's first
     moment after step 1 within STEP_LEAF_REL, the base's bits kept, the
     adapters the same in all 4, 2·L #4 launches and L of #6 and #7 a
     step; then one step over the int8 base cut by
     serving_param_shardings, held alike to the virtual mesh's QLoRA
     step; (e) on ProcessMesh({"dp": 1, "tp": 4}) the serving model's
     int8 and int4 trees cut by serving_param_shardings and gathered
     back byte-equal in every process, the specs the virtual mesh's.
 31. tensor-parallel decoding and the dry run one process a rank, in a
     thread beside 19b (whose command lines it waits on), its times
     informational.  (a)
     the serving model (MODEL) in int8 from its own seed, decoded
     tensor-parallel by two processes on ProcessMesh({"dp": 1, "tp": 2}),
     each holding its serving shards (process_decode.local_tree: 4 q
     heads over 1 kv head a process): 8 prompts of 128 tokens, 32 greedy
     steps, decode.greedy_decode on the slab and
     paged_kv.paged_greedy_decode on pages of 64 with mesh=; the tokens
     held to the one-device decoders on the same tree in this process by
     the near-tie rule (departures), the first step's logits within
     argmax_tol of the one-device logits, both processes' tokens equal;
     #1 launched exactly n_layers times a decode step in each process on
     [8, 4, 128], its first step's launches held to the plain version
     (SLOT_REL_TOL); each process's resident weight bytes against half
     the one-device tree's, and the per-token time (host clock, synced)
     with its gloo share (informational); and an account of the logit
     gap (tp_residual_gaps, informational): the tensor-parallel
     prefill's activations after each layer, of the int8 tree and of its
     bf16 cast, against one device's, the gap each layer adds itself,
     and how far each layer's gap carries to the logits; (b)
     entry.dryrun_multichip(4, processes=True, backend="gloo"): every
     lane of the reference's dry run one process a rank on the card; its
     MULTICHIP_REPORT line logged, and each of #1, #3, #6, #7 and #9-#11
     launched at least once, summed over the ranks.
The script also prints, before phase 1, the seconds of a fixed CPU
workload (host_speed: the host's own speed, beside which host-clock
times from different machines compare).
The second-to-last line is a JSON object describing every kernel (eleven
entries: the flash forward once for each TPU kernel it replaces; phase
26's launches summed over its processes added to rows #3, #6, #7 and
#9-#11, 27b's and 28's to rows #3, #6, #7, #9 and #10, 29's to rows
#3, #4, #6, #7 and #11, 30's to rows #3, #4, #6 and #7, and 31's to
rows #1, #3, #6, #7 and #9-#11); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

HERE = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# full-width headline serving model (bench.py section_paged) and engine
MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
             n_layers=8, d_ff=4096, max_seq=1024, pos_emb="rope")
ENGINE = dict(slots=32, chunk=8, page_size=64, total_pages=160,
              kv_layout="paged")
# full-width flagship training model (bench.py section_train) and its run
TRAIN_MODEL = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8,
                   d_ff=8192, max_seq=1024, pos_emb="learned")
TRAIN_RUN = dict(steps=10, batch=16)
# the serving model's attention shape inside a short training run
GQA_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
                 n_layers=2, d_ff=4096, max_seq=1024, pos_emb="rope")
GQA_RUN = dict(steps=3, batch=8)
TOKENS = 2_200_000              # synthetic training tokens (uint16)
SEED = 0
# one full-width train step, flash kernels vs plain dense attention (the
# dense path rounds its scores to bf16 before the softmax, flash keeps
# them in fp32): the first run on an H100 80GB HBM3 at 700 W gave a loss
# gap of 2.9e-5 (flagship)
# and 3.7e-4 (GQA) and worst leaves of 0.0072 and 0.0065 relative L2
STEP_LOSS_ATOL = 5e-3
STEP_LEAF_REL = 3e-2
# the tune table that selects the fused flash backward at the flagship's
# attention shape (the counterpart of bench_cache/flash_tune.json)
FUSED_TUNE = {"entries": {"1024x128": {"bwd_impl": "fused"}}}
# (m, k, n) of the tiled matmul: the bench's 4096^3, k = 512, a rectangle
# and ragged tiles; of the fused RMSNorm-matmul: the flagship's ln1 -> wqkv
# and ln2 -> w1 at B·S = 16384, m < 256, K = 64 and K = 1024
MATMUL_CASES = [(4096, 4096, 4096), (1024, 512, 2048), (2048, 1024, 3072),
                (200, 512, 264)]
RMSNORM_CASES = [(16384, 2048, 6144), (16384, 2048, 8192), (100, 2048, 2048),
                 (512, 64, 256), (1024, 1024, 1024)]
# phases 13-14: plain SGD at the reference's learning rate
# (make_sharded_train_step's default) on [16, 1025] windows of the phase-8
# corpus, over a virtual mesh of 4 ranks on the one card
SGD_LR = 1e-2
SHARDED_RUN = dict(steps=10, batch=16)
# a ring VJP against autograd through the plain versions: the Functions
# round each fp32 sum to bf16 once, autograd through the plain version
# rounds each rank's share before it sums the ranks (0.0026 relative L2
# for the gather's dx at phase 11's VJP shapes in a CPU run of the plain
# paths)
VJP_REL = 1e-2
# the flash forward's card time before its TMA/wgmma redesign (the first
# version: mma.sync, 64-row blocks, one synchronous K/V stage), phase 6 on
# an H100 80GB HBM3 at 700 W (PERF.md §6)
FWD_BEFORE_US = {"flagship [256, 1024, 128]": "598.1-603.2",
                 "GQA run [64 over 16, 1024, 128]": "177.8-179.9"}
# the fused flash backward's and the plain matmul's card times before their
# TMA/wgmma redesign (the fused backward: per-tile dq slots on the mma.sync
# dK/dV kernel; the matmul: the first version, an mma.sync m16n8k16
# mainloop fed by ldmatrix, since deleted), phases 6 and 7 on an H100 80GB
# HBM3 at 700 W (PERF.md §6)
FUSED_BEFORE_US = {"flagship [256, 1024, 128]": "1897.4",
                   "GQA run [64 over 16, 1024, 128]": "539.7"}
MATMUL_BEFORE_US = "481.2-492.7"
# the split flash backward's card times before its TMA/wgmma redesign (the
# first version: mma.sync, 64-row dq blocks, 64-key dK/dV blocks over
# 32-row q tiles, synchronous tile loads), phase 6 on an H100 80GB HBM3 at
# 700 W (PERF.md §6)
SPLIT_BEFORE_US = {
    "flagship [256, 1024, 128]": "dq 669.0-677.6 us, dK/dV 1065.9-1080.6 us",
    "GQA run [64 over 16, 1024, 128]": "dq 202.0-207.6 us, dK/dV "
                                       "311.4-321.0 us"}
# the ring matmuls' card time before their wgmma redesign (the first
# version: the mma.sync m16n8k16 mainloop, since deleted), phase 12 on an
# H100 80GB HBM3 at 700 W (PERF.md §6)
RING_BEFORE_US = {"all_gather_matmul wqkv": "1707.9-1717.1",
                  "all_gather_matmul w1": "2243.7-2414.7",
                  "matmul_reduce_scatter w2": "2435.4-2546.7",
                  "matmul_reduce_scatter wo": "975.8-1015.6"}
# the same, one launch a ring step with the stream order between the
# launches (the earlier design, whose C entries took a step argument),
# phase 12 on an H100 80GB HBM3 at 700 W (PERF.md §6)
RING_STEPS_US = {"all_gather_matmul wqkv": "770.0",
                 "all_gather_matmul w1": "923.5",
                 "matmul_reduce_scatter w2": "926.3",
                 "matmul_reduce_scatter wo": "436.6"}
# the process ring's calls across 4 processes on one card with a stream
# synchronize and a group barrier after each ring step (the earlier
# design), phase 26a on an H100 80GB HBM3 at 700 W (PERF.md §6)
PROCESS_STEPS_MS = {"all_gather_matmul wqkv, m even": "8.44-12.73",
                    "matmul_reduce_scatter w2": "9.14-14.71",
                    "ring_shift right": "3.04-8.12",
                    "ring_shift left": "3.04-8.12"}
# ring matmul calls enqueued back to back with no host synchronize: on
# the virtual ring (phase 11, each kernel) and a process (phase 26a)
RING_BACK_TO_BACK = 50
PROCESS_BACK_TO_BACK = 10
# the RMSNorm-matmul's card time before its wgmma redesign (the first
# version: the same mma.sync mainloop, 128 x 128 tiles, x normalised on its
# way through registers into shared memory), phase 7 on an H100 80GB HBM3
# at 700 W (PERF.md §6)
NORM_BEFORE_US = {"rmsnorm_matmul ln1 -> wqkv": "2189.2-2321.7",
                  "rmsnorm_matmul ln2 -> w1": "2883.9-3101.1"}
# the paged attention's card time before its split-page redesign (the
# first version: one block per (slot, kv head), 8 warps over 8-token tiles,
# no copies in flight) on an H100 80GB HBM3 at 700 W (PERF.md §6): at the
# serving step phase 3's loop of launches; at 4 slots of 1024 tokens
# `python -m tpu_dra_torch.kernels.variants paged --before` with the first
# version's source (a loop of launches, then a CUDA graph)
PAGED_BEFORE_US = {"serving decode step [32 slots, lengths 257-320]":
                   "20.5-21.9 (a loop of launches), 19.0-19.1 (a CUDA graph)",
                   "4 slots at 1024 tokens":
                   "48.7-49.4 (a loop of launches), 47.5-48.1 (a CUDA graph)"}
# (prompt length, steps) of the served requests
REQUESTS = [(16, 32), (24, 128), (37, 45), (50, 96), (64, 60), (77, 110),
            (100, 77), (128, 128)]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, fn, *args):
    """``fn(*args)``, its seconds logged under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {label} {time.perf_counter() - t0:.1f} s")
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events around the whole run."""
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


def enqueue_ms(fn, iters: int) -> float:
    """Host milliseconds to enqueue one ``fn()``, over ``iters`` calls
    from an idle card (beside :func:`cuda_time_ms` it says whether the
    card waited on the host)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def cuda_graph_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Mean device time of ``fn()`` from a CUDA graph of ``iters`` calls
    replayed ``reps`` times: the host's launch cost, which a loop of
    launches measures for a kernel of a few microseconds, drops out.
    ``fn`` must launch its work on the current stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def attention_case(gen, lengths, *, H=8, Hkv=2, Dh=128, P=160, ps=64,
                   MP=16, quantized=False):
    """Decode-step attention inputs on the card: scrambled page ids, -1
    past each slot's pages."""
    import torch

    from tpu_dra_torch.workloads.quant import quantize_kv
    dev = gen.device
    B = len(lengths)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((Hkv, P, ps, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((Hkv, P, ps, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pages = torch.randint(0, P, (B, MP), generator=gen, device=dev,
                          dtype=torch.int32)
    used = (lengths + ps - 1) // ps
    live = torch.arange(MP, device=dev)[None] < used[:, None]
    table = torch.where(live, pages, torch.full_like(pages, -1))
    extra = {}
    if quantized:
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        extra = {"k_s": k_s, "v_s": v_s}
    return (q, k, v, table.contiguous(), lengths), extra


def check_kernel(gen, full_gen) -> float:
    """The kernel against its plain version on the same inputs, at the
    serving path's 32 slots (inputs from ``gen``) and at 4 slots of the
    full context (from ``full_gen``), bf16 and int8 pages: elementwise
    within the reference's rtol/atol, each slot within SLOT_REL_TOL
    relative L2 error on its own scale (the outputs of a long slot are too
    small for the elementwise bound to bind), and a second call bit-equal
    to the first."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import (SLOT_REL_TOL,
                                                  paged_attention,
                                                  paged_attention_ref,
                                                  slot_rel_err)
    ps, MP = 64, 16
    specials = [0, 1, ps, ps + 1, 100, MP * ps, 2 * ps - 1, 7 * ps + 33]
    rand = torch.randint(1, MP * ps + 1, (32 - len(specials),),
                         generator=gen, device=gen.device).tolist()
    cases = {"32 slots": (gen, specials + rand),
             "4 slots at the full context": (full_gen, [MP * ps] * 4)}
    worst = 0.0
    for label, (g, lengths) in cases.items():
        for quantized, tol in ((False, 0.05), (True, 0.08)):
            args, extra = attention_case(g, lengths, quantized=quantized)
            got = paged_attention(*args, **extra)
            again = paged_attention(*args, **extra)
            torch.cuda.synchronize()
            want = paged_attention_ref(*args, **extra)
            gf, wf = got.float(), want.float()
            err = float((gf - wf).abs().max())
            ok = bool(torch.all((gf - wf).abs() <= tol + tol * wf.abs()))
            rel = slot_rel_err(got, want)
            b = int(rel.argmax())
            rel_ok = float(rel.max()) <= SLOT_REL_TOL
            same = torch.equal(got, again)
            if not torch.isfinite(gf).all():
                fail("paged attention kernel produced non-finite values")
            if 0 in lengths and not bool((gf[lengths.index(0)] == 0).all()):
                fail("zero-length slot did not give zeros")
            kind = "int8" if quantized else "bf16"
            log(f"[kernel] paged_attention {label}, {kind} pages: max "
                f"|kernel - plain| = {err:.5f} (rtol/atol {tol}) -> "
                f"{'ok' if ok else 'FAIL'}; worst slot relative L2 error "
                f"{float(rel.max()):.5f} (slot {b}, length {lengths[b]}; "
                f"median {float(rel.median()):.5f}; tolerance "
                f"{SLOT_REL_TOL}) -> {'ok' if rel_ok else 'FAIL'}; a second "
                f"call bit-equal: {same}")
            if not (ok and rel_ok):
                fail(f"paged attention kernel disagrees with its plain "
                     f"version ({label}, {kind} pages, max abs err {err}, "
                     f"worst slot relative error {float(rel.max())})")
            if not same:
                fail(f"paged attention kernel: two calls differ ({label}, "
                     f"{kind} pages)")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: timing at one decode step of a full pool
# ---------------------------------------------------------------------------

# phase 3's shapes: (label, slots, shortest and longest length)
PAGED_SHAPES = [("serving decode step [32 slots, lengths 257-320]", 32, 257,
                 320),
                ("4 slots at 1024 tokens", 4, 1024, 1024)]


def time_kernel(gen, n_layers: int, B: int, lo: int, hi: int) -> dict:
    """Kernel, plain version and library yardstick at one decode step of
    the served model: B slots with lengths in [lo, hi], each its pages
    from a permutation of the 160-page pool (5 pages each at the serving
    step's 32 slots; 16 at 4 slots of 1024 tokens).  The kernel cycles
    through ``n_layers`` distinct layer pools, as one decode step does, so
    its pages come from device memory rather than the 50 MB L2 cache."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads.paged_kv import (_LOG2E, paged_attention,
                                                  paged_attention_ref,
                                                  workspace_floats)
    dev = gen.device
    H, Hkv, Dh, P, ps, MP = 8, 2, 128, 160, 64, 16
    npg = -(-hi // ps)                          # pages a slot
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    table[:, :npg] = perm[:B * npg].reshape(B, npg)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    k_all = torch.randn((n_layers, Hkv, P, ps, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)
    v_all = torch.randn((n_layers, Hkv, P, ps, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)

    # the kernel alone: its C entry point with the arguments prepared once
    lib = library("paged_attention")
    qs = (q * float(torch.tensor(Dh ** -0.5 * _LOG2E,
                                 dtype=torch.bfloat16))).contiguous()
    out = torch.empty_like(q)
    ws = torch.empty(workspace_floats(B, H, Hkv, Dh, MP, ps), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    layer = [0]

    def kernel(stream=stream):
        i = layer[0] = (layer[0] + 1) % n_layers
        rc = lib.tpu_dra_paged_attention(
            qs.data_ptr(), k_all[i].data_ptr(), v_all[i].data_ptr(), None,
            None, table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, H, Hkv, P, ps, Dh, MP, 0, stream)
        if rc:
            fail(f"kernel launch failed with CUDA error {rc}")

    def wrapper():
        i = layer[0] = (layer[0] + 1) % n_layers
        paged_attention(q, k_all[i], v_all[i], table, lengths)

    def plain():
        i = layer[0] = (layer[0] + 1) % n_layers
        paged_attention_ref(q, k_all[i], v_all[i], table, lengths)

    # library yardstick: one PyTorch attention call over K/V already
    # gathered into contiguous [B, Hkv, S, Dh] — it leaves the page gather
    # out, so it is cheaper work than the kernel's; the port never calls it
    S = npg * ps
    tab = table[:, :npg].long()
    kg = [k_all[i][:, tab].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, Dh)
          .contiguous() for i in range(n_layers)]
    vg = [v_all[i][:, tab].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, Dh)
          .contiguous() for i in range(n_layers)]
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None])[:, None,
                                                                   None]
    q4 = q[:, :, None]

    def library_call():
        i = layer[0] = (layer[0] + 1) % n_layers
        F.scaled_dot_product_attention(q4, kg[i], vg[i], attn_mask=mask,
                                       enable_gqa=True)

    # every call as a loop of launches, the way the served step launches
    # them (at a few microseconds a call the host's launch rate may bound
    # it); the kernel and the library call also from CUDA graphs, where
    # the host's launch cost drops out (graph_ms, library_graph_ms)
    t = {"ms": cuda_time_ms(kernel, 400),
         "wrapper_ms": cuda_time_ms(wrapper, 200),
         "plain_ms": cuda_time_ms(plain, 40),
         "library_ms": cuda_time_ms(library_call, 200),
         "graph_ms": cuda_graph_ms(
             lambda: kernel(torch.cuda.current_stream().cuda_stream)),
         "library_graph_ms": cuda_graph_ms(library_call)}
    live = int(lengths.sum())
    pages_read = int(((lengths + ps - 1) // ps).sum())
    nbytes = (2 * live * Hkv * Dh * 2          # live K and V rows, bf16
              + 2 * B * H * Dh * 2             # q in, out
              + pages_read * 4 + B * 4)        # live table entries, lengths
    flops = 4 * H * Dh * live                  # q.k and p.v per token
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t["bytes"], t["flops"] = nbytes, flops
    return t


# ---------------------------------------------------------------------------
# phase 4: serve the full-width model
# ---------------------------------------------------------------------------

def post(port: int, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def oracle(cfg, params, prompt, steps):
    """The port's own per-request greedy decoder on the card."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import PagePool, paged_greedy_decode
    pool = PagePool(ENGINE["total_pages"], ENGINE["page_size"])
    row = pool.table_row(pool.alloc(pool.pages_for(len(prompt) + steps)),
                         cfg.max_seq // ENGINE["page_size"])
    dev = torch.device("cuda", 0)
    return paged_greedy_decode(
        cfg, params, torch.tensor([prompt], device=dev),
        torch.from_numpy(row[None]).to(dev), steps=steps,
        total_pages=ENGINE["total_pages"],
        page_size=ENGINE["page_size"])[0].tolist()


def oracle_logits_at(cfg, params, prompt, tokens, step):
    """The oracle's logits at ``step`` when fed its own ``tokens``."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import (PagePool, _paged_step,
                                                  init_paged_cache,
                                                  prefill_pages)
    dev = torch.device("cuda", 0)
    ps, P = ENGINE["page_size"], ENGINE["total_pages"]
    pool = PagePool(P, ps)
    row = pool.table_row(pool.alloc(pool.pages_for(len(prompt) + step + 1)),
                         cfg.max_seq // ps)
    table = torch.from_numpy(row[None]).to(dev)
    cache = init_paged_cache(cfg, P, ps, device=dev)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    logits = prefill_pages(cfg, params, cache,
                           torch.tensor([prompt], device=dev), lens, table)
    for i in range(step):
        tok = torch.tensor([tokens[i]], dtype=torch.int32, device=dev)
        cache, logits, lens = _paged_step(cfg, params, cache, tok, lens,
                                          table)
    return logits[0].float()


def argmax_tol(top: float) -> float:
    """Where the served answer and the oracle may part: the oracle's
    top-2 margin within twice four bf16 ulps of the top logit (2 x
    max(2^-4, 2^-6 |top|)).  The engine runs 32 slots and bucket-padded
    prefills, the oracle one row, so cuBLAS takes other kernels and sums
    in another order; every bf16 rounding downstream may then land one
    ulp apart — the same rule the CPU parity tests apply."""
    return 2 * max(2 ** -4, 2 ** -6 * abs(top))


def serve_requests(label: str, cfg, params, engine: dict,
                   prompts: list, requests: list = REQUESTS,
                   sampled: int = 0) -> dict:
    """Start serve() on port 0 with ``engine``, POST one request first
    (first-use costs), then the ``requests`` at once, one client thread
    each; fail on any error or a wrong count.  Counts the paged-attention
    launches and the int8 products of the concurrent part, and returns
    the engine's stats after it.  ``sampled``: then one /generate of that
    many of the prompts at temperature 0.8, every answer of its length
    and every token in range."""
    from tpu_dra_torch.workloads.paged_kv import paged_attention
    from tpu_dra_torch.workloads.quant import int8_product
    from tpu_dra_torch.workloads.serve import serve
    srv = serve(cfg, params, port=0, **engine)
    try:
        port = srv.server_address[1]
        post(port, {"tokens": [[1, 2, 3]], "steps": 2})   # first-use costs
        srv.engine.reset_stats()
        results: dict[int, object] = {}
        lat: dict[int, float] = {}

        def client(i):
            t = time.perf_counter()
            try:
                results[i] = post(port, {"tokens": [prompts[i]],
                                         "steps": requests[i][1]})
            except Exception as exc:  # noqa: BLE001 — reported below
                results[i] = exc
            lat[i] = time.perf_counter() - t

        paged_attention.launches = 0
        int8_product.calls = 0
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches, int8_calls = paged_attention.launches, int8_product.calls
        stats = srv.engine.stats()
        if sampled:
            rows = post(port, {"tokens": prompts[:sampled], "steps": 32,
                               "temperature": 0.8, "seed": 7})["tokens"]
            if len(rows) != sampled or not all(
                    len(r) == 32 and all(0 <= t < cfg.vocab for t in r)
                    for r in rows):
                fail(f"{label}: the sampled batch gave {rows!r:.300}")
            log(f"[{label}] a sampled batch of {sampled} requests at "
                f"temperature 0.8: 32 tokens each, all in range")
    finally:
        srv.shutdown()
    answers = []
    for i, (n, steps) in enumerate(requests):
        res = results.get(i)
        if not isinstance(res, dict):
            fail(f"{label}: request {i} failed: {res!r}")
        toks = res["tokens"][0]
        if len(toks) != steps or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"{label}: request {i}: {len(toks)} tokens for {steps} "
                 f"steps")
        answers.append(toks)
    n_tok = sum(len(a) for a in answers)
    log(f"[{label}] {len(requests)} concurrent requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s, p50 latency "
        f"{1e3 * statistics.median(lat.values()):.1f} ms (informational)")
    return {"answers": answers, "launches": launches,
            "int8_calls": int8_calls, "decode_steps": stats["decode_steps"],
            "stats": stats, "tokens_per_s": n_tok / wall,
            "p50_latency_ms": 1e3 * statistics.median(lat.values())}


def hold_answers(label: str, answers: list, want_fn, logits_at,
                 requests: list = REQUESTS) -> int:
    """Each served answer against the oracle ``want_fn(i)`` on the card:
    equal, or departing only where the oracle's top-2 margin at the first
    difference (``logits_at(i, want, step)``) is within argmax_tol.
    Returns the number of tokens compared equal."""
    import torch
    compared = 0
    with torch.no_grad():
        for i, ((n, steps), toks) in enumerate(zip(requests, answers)):
            want = want_fn(i)
            diff = next((j for j, (a, b) in enumerate(zip(toks, want))
                         if a != b), None)
            if diff is None:
                compared += steps
                log(f"[{label}] request {i} (prompt {n}, steps {steps}): "
                    f"equals the oracle")
                continue
            lg = logits_at(i, want, diff)
            top2 = torch.topk(lg, 2).values.tolist()
            margin, tol = top2[0] - top2[1], argmax_tol(top2[0])
            compared += diff
            log(f"[{label}] request {i} (prompt {n}, steps {steps}): equals "
                f"the oracle for {diff} tokens; at step {diff} the oracle's "
                f"top-2 margin is {margin:.4f} (tolerance {tol:.4f})")
            if margin > tol:
                fail(f"{label}: request {i} departs from the oracle at step "
                     f"{diff} where the oracle's margin {margin:.4f} > "
                     f"{tol:.4f}")
    n_tok = sum(len(a) for a in answers)
    log(f"[{label}] {compared} of {n_tok} served tokens compared equal to "
        f"the oracle before any near-tie")
    return compared


def request_prompts(vocab: int) -> list:
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).tolist() for n, _ in REQUESTS]


def serve_phase(gen) -> dict:
    import torch

    from tpu_dra_torch.workloads.quant import cast_params_bf16
    from tpu_dra_torch.workloads.train import (ModelConfig, forward,
                                               init_params)
    cfg = ModelConfig(**MODEL)
    t0 = time.perf_counter()
    params = cast_params_bf16(init_params(cfg, gen))
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    log(f"[serve] full-width model: {n_params / 1e6:.1f} M bf16 params "
        f"from seed {SEED} in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        probe = forward(cfg, params, torch.arange(16, device="cuda")[None])
    if probe.shape != (1, 16, cfg.vocab) or not torch.isfinite(probe).all():
        fail(f"forward at full width gave {tuple(probe.shape)} / "
             f"non-finite logits")

    prompts = request_prompts(cfg.vocab)
    run = serve_requests("serve", cfg, params, ENGINE, prompts)
    launches, decode_steps = run["launches"], run["decode_steps"]
    log(f"[serve] kernel launches {launches} over {decode_steps} decode "
        f"steps: {launches / max(1, decode_steps):.2f} per decoded token "
        f"(n_layers = {cfg.n_layers})")
    if launches < cfg.n_layers * decode_steps or \
            decode_steps < max(s for _, s in REQUESTS) - 1:
        fail(f"paged attention kernel launched {launches} times for "
             f"{decode_steps} decode steps of {cfg.n_layers} layers")

    # each answer against the port's per-request decoder on the card
    hold_answers(
        "serve", run["answers"],
        lambda i: oracle(cfg, params, prompts[i], REQUESTS[i][1]),
        lambda i, want, step: oracle_logits_at(cfg, params, prompts[i],
                                               want, step))
    return run


# ---------------------------------------------------------------------------
# phase 5: flash kernels vs plain versions
# ---------------------------------------------------------------------------

def hold(label: str, name: str, got, want, row_tol: float,
         elem_tol: float | None = None) -> tuple:
    """Fail unless ``got`` is finite and within ``elem_tol`` (default
    ``flash.ELEM_TOL``) elementwise and ``row_tol`` per row (each leading
    index, ``flash.row_rel_err``) of ``want``; returns (max abs error,
    worst elementwise error as a share of its tolerance, worst row
    error)."""
    import torch

    from tpu_dra_torch.workloads.flash import ELEM_TOL, row_rel_err
    elem_tol = ELEM_TOL if elem_tol is None else elem_tol
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{label} {name}: shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)} or non-finite values")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ratio = float((diff / (elem_tol + elem_tol * want.float().abs())).max())
    rows = row_rel_err(got, want)
    worst = float(rows.max())
    if ratio > 1 or worst > row_tol:
        fail(f"{label} {name}: max abs err {err:.3g} (elementwise "
             f"{ratio:.3g} of the tolerance), worst row relative error "
             f"{worst:.3g} (row {int(rows.argmax())}, tolerance "
             f"{row_tol})")
    return err, ratio, worst


def flash_inputs(gen, bh: int, bhkv: int, s: int, d: int):
    import torch
    dev = gen.device

    def draw(n):
        return torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
    return draw(bh), draw(bhkv), draw(bhkv), draw(bh)


def check_flash_case(gen, bh, bhkv, s, d, causal) -> tuple:
    """Each flash kernel against its plain version on one input; the
    backward kernels get the plain forward's out and l2, so each kernel
    is held alone.  Returns {kernel: (max abs err, elementwise ratio,
    worst head-row error)} and the max abs error of l2."""
    import torch

    from tpu_dra_torch.workloads import flash as F
    label = (f"flash [{bh} over {bhkv}, {s}, {d}] "
             f"{'causal' if causal else 'full'}")
    q, k, v, do = flash_inputs(gen, bh, bhkv, s, d)
    out, l2 = F.flash_attn_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_l2 = F.flash_attn_fwd_ref(q, k, v, causal)
    res = {"flash_fwd": hold(label, "out", out, ref_out, F.ROW_TOL["out"])}
    l2_err = float((l2 - ref_l2).abs().max())
    if not l2_err <= F.L2_ATOL:
        fail(f"flash {label} l2: max abs err {l2_err} > {F.L2_ATOL}")
    qs = F._prescale(q).contiguous()
    dd = (do.float() * ref_out.float()).sum(dim=-1, keepdim=True)
    dq = F.flash_bwd_dq(qs, k, v, do, ref_l2, dd, causal)
    dk, dv = F.flash_bwd_dkdv(qs, k, v, do, ref_l2, dd, causal)
    torch.cuda.synchronize()
    res["flash_bwd_dq"] = hold(label, "dq", dq,
                               F.flash_bwd_dq_ref(qs, k, v, do, ref_l2, dd,
                                                  causal), F.ROW_TOL["dq"])
    rk, rv = F.flash_bwd_dkdv_ref(qs, k, v, do, ref_l2, dd, causal)
    ek = hold(label, "dk", dk, rk, F.ROW_TOL["dk"])
    ev = hold(label, "dv", dv, rv, F.ROW_TOL["dv"])
    res["flash_bwd_dkdv"] = tuple(max(a, b) for a, b in zip(ek, ev))
    again = (F.flash_bwd_dq(qs, k, v, do, ref_l2, dd, causal),
             *F.flash_bwd_dkdv(qs, k, v, do, ref_l2, dd, causal))
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        fail(f"{label}: two calls of the split backward differ")
    fused = F.flash_bwd_fused(qs, k, v, do, ref_l2, dd, causal)
    torch.cuda.synchronize()
    want = F.flash_bwd_fused_ref(qs, k, v, do, ref_l2, dd, causal)
    errs = [hold(label, f"fused {name}", g, w, F.ROW_TOL[name])
            for name, g, w in zip(("dq", "dk", "dv"), fused, want)]
    again = F.flash_bwd_fused(qs, k, v, do, ref_l2, dd, causal)
    if not all(torch.equal(a, b) for a, b in zip(fused, again)):
        fail(f"{label}: two calls of the fused backward differ")
    res["flash_bwd_fused"] = tuple(max(e) for e in zip(*errs))
    res["flash_bwd_fused (dq alone)"] = errs[0]
    return res, l2_err


def check_flash(gen) -> dict:
    """The path's shapes, then the edge cases; returns the max abs error
    of each kernel at the flagship path's shape."""
    path, l2_worst = check_flash_case(gen, 256, 256, 1024, 128, True)
    gqa, l2_err = check_flash_case(gen, 64, 16, 1024, 128, True)
    l2_worst = max(l2_worst, l2_err)
    for name in path:
        log(f"[flash] {name} at the path's shapes: max abs err "
            f"{path[name][0]:.4g} (elementwise {path[name][1]:.3f} of "
            f"the tolerance), worst head-row {path[name][2]:.3g}; GQA run "
            f"shape {gqa[name][0]:.4g} / {gqa[name][2]:.3g}")
    worst = {name: [0.0, 0.0, 0.0] for name in path}
    n = 0
    for s in (1, 63, 64, 65, 1000):
        for causal in (True, False):
            for g in (1, 4):
                for d in (64, 128):
                    res, l2_err = check_flash_case(gen, 8, 8 // g, s, d,
                                                   causal)
                    l2_worst = max(l2_worst, l2_err)
                    n += 1
                    for name, vals in res.items():
                        worst[name] = [max(a, b) for a, b in
                                       zip(worst[name], vals)]
    for name, (err, ratio, row) in worst.items():
        log(f"[flash] {name} over {n} edge cases: max abs err {err:.4g} "
            f"(elementwise {ratio:.3f} of the tolerance), worst head-row "
            f"{row:.3g} -> ok")
    from tpu_dra_torch.workloads.flash import ELEM_TOL, L2_ATOL, ROW_TOL
    log(f"[flash] l2 over all cases: max abs err {l2_worst:.3g}")
    log(f"[flash] tolerances: elementwise rtol = atol = {ELEM_TOL}; per "
        f"head-row {ROW_TOL}; l2 atol {L2_ATOL}")
    return {**{name: vals[0] for name, vals in path.items()},
            "flash_fwd_gqa": gqa["flash_fwd"][0]}


# ---------------------------------------------------------------------------
# phase 6: flash timing at the training path's shapes
# ---------------------------------------------------------------------------

def flash_bound(nbytes: int, flops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def time_flash(gen, B: int, H: int, Hkv: int, S: int = 1024,
               D: int = 128, causal: bool = True) -> dict:
    """Kernel alone (its C entry, arguments prepared once), wrapper, plain
    version and library yardstick for each flash kernel at one training
    path's attention: the flagship's [B·H, S, D] = [256, 1024, 128] bf16
    causal (each operand 67 MB, more than the 50 MB L2 cache holds, so
    every call reads device memory), the GQA run's 64 q heads over 16 kv
    heads, or one rank's block of the DP×SP step, [256, 256, 128], causal
    on the diagonal and full on the other hops."""
    import torch
    import torch.nn.functional as TF

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.train import weak_scalar
    BH, BHkv = B * H, B * Hkv
    q, k, v, do = flash_inputs(gen, BH, BHkv, S, D)
    out, l2 = F.flash_attn_fwd(q, k, v, causal)
    qs = F._prescale(q).contiguous()
    dd = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))   # per q head
    # the fused kernel's scratch: dq's fp32 accumulator and its flags
    scratch = torch.empty(-(-F.fused_scratch_bytes(BH, S, S, D) // 4),
                          dtype=torch.float32, device=q.device)
    lf, lb = library("flash_fwd"), library("flash_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    qscale = weak_scalar(D ** -0.5 * F._LOG2E, torch.bfloat16)
    P = lambda t: t.data_ptr()      # noqa: E731

    def checked(rc):
        if rc:
            fail(f"flash kernel launch failed with CUDA error {rc}")

    kernels = {
        "flash_fwd": lambda: checked(lf.tpu_dra_flash_fwd(
            P(q), P(k), P(v), P(out), P(l2), BH, BHkv, S, S, D, int(causal),
            qscale, stream)),
        "flash_bwd_dq": lambda: checked(lb.tpu_dra_flash_bwd_dq(
            P(qs), P(k), P(v), P(do), P(l2), P(dd), P(dq), BH, BHkv, S, S,
            D, int(causal), D ** -0.5, stream)),
        "flash_bwd_dkdv": lambda: checked(lb.tpu_dra_flash_bwd_dkdv(
            P(qs), P(k), P(v), P(do), P(l2), P(dd), P(dk), P(dv), BH, BHkv,
            S, S, D, int(causal), stream)),
        "flash_bwd_fused": lambda: checked(lb.tpu_dra_flash_bwd_fused(
            P(qs), P(k), P(v), P(do), P(l2), P(dd), P(dk), P(dv),
            P(scratch), P(dq), BH, BHkv, S, S, D, int(causal), F.KV_BLOCK,
            D ** -0.5, stream)),
    }
    args = (qs, k, v, do, l2, dd, causal)
    wrappers = {
        "flash_fwd": lambda: F.flash_attn_fwd(q, k, v, causal),
        "flash_bwd_dq": lambda: F.flash_bwd_dq(*args),
        "flash_bwd_dkdv": lambda: F.flash_bwd_dkdv(*args),
        "flash_bwd_fused": lambda: F.flash_bwd_fused(*args),
    }
    plains = {
        "flash_fwd": lambda: F.flash_attn_fwd_ref(q, k, v, causal),
        "flash_bwd_dq": lambda: F.flash_bwd_dq_ref(*args),
        "flash_bwd_dkdv": lambda: F.flash_bwd_dkdv_ref(*args),
        "flash_bwd_fused": lambda: F.flash_bwd_fused_ref(*args),
    }
    # library yardstick: one PyTorch call each way (never called by the
    # port); its backward computes dq, dk and dv together
    q4 = q.reshape(B, H, S, D).detach().requires_grad_()
    k4, v4 = (t.reshape(B, Hkv, S, D).detach().requires_grad_()
              for t in (k, v))
    do4 = do.reshape(B, H, S, D)
    gqa = Hkv != H
    o4 = TF.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                         enable_gqa=gqa)
    sdpa_fwd = cuda_time_ms(lambda: TF.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=gqa), 50)
    sdpa_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 20)
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkdv": sdpa_bwd, "flash_bwd_fused": sdpa_bwd}

    # bounds from these inputs: each operand read once, each output written
    # once; the products count only the (row, key) pairs the mask keeps
    # (S(S+1)/2 under the causal mask), 2 flops per multiply-add
    tile = BH * S * D * 2                   # one bf16 [BH, S, D] operand
    kv = BHkv * S * D * 2                   # k or v
    stat = BH * S * 4                       # one fp32 [BH, S] row vector
    mac = BH * D * (S * (S + 1) // 2 if causal else S * S)   # one product
    sizes = {"flash_fwd": (2 * tile + 2 * kv + stat, 2 * 2 * mac),
             "flash_bwd_dq": (3 * tile + 2 * kv + 2 * stat, 3 * 2 * mac),
             # dk, dv are written per q head
             "flash_bwd_dkdv": (4 * tile + 2 * kv + 2 * stat, 4 * 2 * mac),
             # the dkdv kernel's work, dq written once more, one product more
             "flash_bwd_fused": (5 * tile + 2 * kv + 2 * stat,
                                 5 * 2 * mac)}
    t = {}
    for name in kernels:
        t[name] = {"ms": cuda_time_ms(kernels[name], 20),
                   "wrapper_ms": cuda_time_ms(wrappers[name], 20),
                   "plain_ms": cuda_time_ms(plains[name], 5, warmup=1),
                   "library_ms": library_ms[name], **flash_bound(*sizes[name])}
    t["flash_bwd_fused"]["scratch_bytes"] = F.fused_scratch_bytes(BH, S, S, D)
    return t


# ---------------------------------------------------------------------------
# phases 8-10: training through fit and the fused step
# ---------------------------------------------------------------------------

def write_tokens(path: Path, vocab: int) -> str:
    """A learnable synthetic stream from SEED: a random 64-token motif
    repeated, 5% of the tokens replaced by noise."""
    import numpy as np

    from tpu_dra_torch.workloads.data import TokenDataset
    rng = np.random.default_rng(SEED)
    toks = np.resize(rng.integers(0, vocab, 64), TOKENS)
    noise = rng.random(TOKENS) < 0.05
    toks[noise] = rng.integers(0, vocab, int(noise.sum()))
    TokenDataset.write(str(path), toks)
    return str(path)


def leaf_errors(got: dict, want: dict, prefix: str = "") -> dict:
    """Relative L2 error of each gradient leaf."""
    out = {}
    for name, w in want.items():
        if isinstance(w, dict):
            out.update(leaf_errors(got[name], w, prefix + name + "/"))
        else:
            g = got[name].float()
            out[prefix + name] = float((g - w.float()).norm()
                                       / w.float().norm())
    return out


def compare_step(gen, cfg, data_path: str, batch: int, label: str) -> int:
    """One train step's loss and gradients with the flash kernels against
    the same step with plain dense attention, same params and batch.
    Returns the model's parameter count."""
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.train import (grads_fn, init_params,
                                               tree_leaves)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.from_numpy(next(batches(TokenDataset(data_path),
                                         batch=batch, seq=cfg.max_seq)))
    toks = toks.to(gen.device)
    loss_f, g_f = grads_fn(cfg, params, toks, attn_impl="flash")
    loss_d, g_d = grads_fn(cfg, params, toks, attn_impl="dense")
    hold_step(label, "flash kernels vs plain dense attention", loss_f, g_f,
              loss_d, g_d)
    del params, g_f, g_d
    torch.cuda.empty_cache()
    return n_params


def hold_step(label: str, what: str, loss_a, g_a, loss_b, g_b) -> None:
    """Fail unless two train steps' losses are within STEP_LOSS_ATOL and
    every gradient leaf within STEP_LEAF_REL relative L2."""
    errs = leaf_errors(g_a, g_b)
    worst = max(errs, key=errs.get)
    dl = abs(float(loss_a) - float(loss_b))
    log(f"[train] {label}: one step, {what}: loss {float(loss_a):.5f} vs "
        f"{float(loss_b):.5f} (|d| {dl:.2e}, tolerance {STEP_LOSS_ATOL}); "
        f"worst gradient leaf {worst} relative L2 {errs[worst]:.3e} "
        f"(tolerance {STEP_LEAF_REL}); median leaf "
        f"{statistics.median(errs.values()):.3e}")
    if not (dl <= STEP_LOSS_ATOL and errs[worst] <= STEP_LEAF_REL):
        fail(f"{label}: {what}: the steps depart (loss |d| {dl}, leaf "
             f"{worst} {errs[worst]})")


def fit_phase(cfg, data_path: str, steps: int, batch: int, label: str,
              n_params: int) -> dict:
    """fit() with attn_impl="flash"; the flash launch counts are zeroed
    just before and read just after.  Fails unless every logged loss is
    finite, the last is below the first, and each kernel launched
    2 x n_layers x steps times (forward, and its recompute in the
    backward) and each backward kernel n_layers x steps times."""
    import math

    import torch

    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.fit import fit
    stamps = []

    def record(line: str) -> None:
        stamps.append(time.perf_counter())
        log(f"[train]   {label} {line}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = {"flash_fwd": F.flash_attn_fwd, "flash_bwd_dq":
                F.flash_bwd_dq, "flash_bwd_dkdv": F.flash_bwd_dkdv}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = fit(cfg, data_path, steps=steps, batch=batch, attn_impl="flash",
              log_every=1, log_fn=record)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in res.losses) or \
            len(res.losses) != steps:
        fail(f"{label}: losses {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"{label}: loss did not fall: {res.losses}")
    want = flash_want(cfg.n_layers * steps)
    if launches != want:
        fail(f"{label}: flash launches {launches}, expected {want} "
             f"(n_layers {cfg.n_layers} x steps {steps}, the forward "
             f"twice under remat)")
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    tok_step = batch * cfg.max_seq
    log(f"[train] {label}: {n_params / 1e6:.1f} M params, loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f} over {steps} steps; "
        f"step time {1e3 * step_s:.1f} ms (median of steps 2-{steps}; "
        f"first step {1e3 * times[0]:.1f} ms), tokens/s from the start "
        f"{res.tokens_per_s:.0f}, steady {tok_step / step_s:.0f}; "
        f"6·N·tokens/time/989e12 = "
        f"{6 * n_params * tok_step / step_s / BF16_FLOPS_PER_S:.3f}; "
        f"peak memory (max_memory_allocated) {peak_gb:.2f} GB; flash "
        f"launches {launches} (informational)")
    return {"launches": launches, "losses": res.losses, "step_ms":
            1e3 * step_s, "tokens_per_s": res.tokens_per_s, "peak_gb":
            peak_gb, "n_params": n_params}


def dense_curve(cfg, data_path: str, flash_losses: list) -> None:
    """The same fit (seed, batches, optimizer) with plain dense attention,
    its losses printed beside the flash run's (informational: the two
    differ by bf16 noise from the first step on, and AdamW carries that
    into the curves)."""
    import torch

    from tpu_dra_torch.workloads.fit import fit
    torch.cuda.empty_cache()
    res = fit(cfg, data_path, steps=len(flash_losses),
              batch=TRAIN_RUN["batch"], attn_impl="dense", log_every=1,
              log_fn=lambda line: None)
    pairs = ", ".join(f"{a:.4f}/{b:.4f}" for a, b in
                      zip(flash_losses, res.losses))
    log(f"[train] flagship losses, flash/dense attention by step: {pairs} "
        f"(informational)")


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_kind(name: str) -> str:
    if "flash_" in name:
        return "flash kernels"
    if "ring_" in name:
        return "ring kernels (csrc/ring.cu)"
    if any(k in name for k in ("rownorm_kernel", "matmul_sm90_kernel",
                               "norm_sm90_kernel")):
        return "matmul kernels (csrc/matmul.cu)"
    if any(m in name.lower() for m in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmuls (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_step(cfg, data_path: str, batch: int, label: str = "flagship",
                 norm_impl: str = "dense") -> None:
    """One train step (after two warm-up steps) under torch.profiler:
    device time by kernel kind and the device's idle share of the step
    (informational; the profiler's own overhead lengthens the traced
    step)."""
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.optim import default_optimizer
    from tpu_dra_torch.workloads.train import init_params, make_train_step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    step, init_opt = make_train_step(cfg, default_optimizer(),
                                     attn_impl="flash", norm_impl=norm_impl)
    state = init_opt(params)
    it = batches(TokenDataset(data_path), batch=batch, seq=cfg.max_seq)
    toks = [torch.from_numpy(next(it)).to("cuda") for _ in range(3)]
    for t in toks[:2]:
        params, state, _ = step(params, state, t)
    profile_call(f"{label} train step",
                 lambda: step(params, state, toks[2]))
    del params, state
    torch.cuda.empty_cache()


def profile_call(label: str, fn) -> dict:
    """``fn()`` once (warmed up by the caller) under torch.profiler: wall
    time, device busy time and idle share, device time by kernel kind and
    the top kernels (informational); returns the device time by kind in
    µs with ``wall`` and ``busy`` ({} where the profiler saw no device
    activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("[profile] torch.profiler saw no device activity: device time "
            "by kernel not measured")
        return {}
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_kind[kernel_kind(e.name)] = by_kind.get(kernel_kind(e.name),
                                                   0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    log(f"[profile] {label} under torch.profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"(idle share {1 - busy / wall_us:.3f}), {len(kernels)} device "
        f"activities (informational)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {kind}: {us / 1e3:.1f} ms "
            f"({us / busy:.3f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   top: {us / 1e3:.2f} ms {name[:110]}")
    return {**by_kind, "wall": wall_us, "busy": busy}


@contextlib.contextmanager
def fused_backward(tune_path: Path):
    """Point ``flash.TUNE_FILE`` at the table that selects the fused flash
    backward for the duration."""
    from tpu_dra_torch.workloads import flash as F
    default = F.TUNE_FILE
    F.TUNE_FILE = tune_path
    try:
        yield
    finally:
        F.TUNE_FILE = default


def fused_compare_step(gen, cfg, data_path: str, batch: int,
                       tune_path: Path) -> None:
    """One flagship step with norm_impl="fused" and the fused flash
    backward against the same step (params, [B, S + 1] batch) with the
    plain rmsnorm -> matmul pair and the split backward."""
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.train import grads_fn, init_params
    params = init_params(cfg, gen)
    toks = torch.from_numpy(next(batches(TokenDataset(data_path),
                                         batch=batch, seq=cfg.max_seq)))
    toks = toks.to(gen.device)
    with fused_backward(tune_path):
        loss_f, g_f = grads_fn(cfg, params, toks, attn_impl="flash",
                               norm_impl="fused")
    loss_s, g_s = grads_fn(cfg, params, toks, attn_impl="flash")
    hold_step("flagship", "fused norm-matmul and fused flash backward vs "
              "the plain pair and the split backward", loss_f, g_f, loss_s,
              g_s)
    del params, g_f, g_s
    torch.cuda.empty_cache()


def fused_train_phase(cfg, data_path: str, tune_path: Path, steps: int,
                      batch: int, n_params: int, split_step_ms: float
                      ) -> dict:
    """``make_train_step(norm_impl="fused")`` with the fused flash backward
    for ``steps`` steps on ``data.batches`` windows [batch, S + 1]; the
    kernels' launch counts are zeroed just before and read just after.
    Fails unless every loss is finite, the last is below the first, each
    layer ran the norm-matmul kernel twice (its outputs kept by the
    remat, never run again), the flash forward twice (once more in the
    backward's recompute) and the fused backward once a step, neither
    split backward kernel ran, and the first two steps, run
    again from the seed, give bit-equal losses."""
    import math

    import torch

    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads import matmul as M
    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.optim import default_optimizer
    from tpu_dra_torch.workloads.train import init_params, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    step, init_opt = make_train_step(cfg, default_optimizer(),
                                     attn_impl="flash", norm_impl="fused")
    state = init_opt(params)
    it = batches(TokenDataset(data_path), batch=batch, seq=cfg.max_seq)
    counters = {"rmsnorm_matmul": M.fused_rmsnorm_matmul,
                "flash_bwd_fused": F.flash_bwd_fused,
                "flash_fwd": F.flash_attn_fwd, "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    losses, stamps, first = [], [], []
    with fused_backward(tune_path):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            toks = torch.from_numpy(next(it)).to("cuda")
            if len(first) < 2:
                first.append(toks)
            params, state, loss = step(params, state, toks)
            losses.append(float(loss))
            stamps.append(time.perf_counter())
        launches = {name: fn.launches for name, fn in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the same two steps again from the seed: the second loss carries
        # the first step's fused backward, so it must repeat bit for bit
        del params, state
        gen.manual_seed(SEED)
        params = init_params(cfg, gen)
        state = init_opt(params)
        again = []
        for toks in first:
            params, state, loss = step(params, state, toks)
            again.append(float(loss))
    log(f"[train] fused path, two steps from the seed run again: losses "
        f"{', '.join(repr(x) for x in again)} against "
        f"{', '.join(repr(x) for x in losses[:2])}")
    if again != losses[:2]:
        fail(f"fused path: two steps from one seed gave losses {again}, "
             f"then {losses[:2]}")
    log(f"[train] fused path losses by step (full precision, to compare "
        f"calls bit for bit): {', '.join(repr(x) for x in losses)}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        fail(f"fused path: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"fused path: loss did not fall: {losses}")
    want = {"rmsnorm_matmul": 2 * cfg.n_layers * steps,
            "flash_bwd_fused": cfg.n_layers * steps,
            "flash_fwd": 2 * cfg.n_layers * steps, "flash_bwd_dq": 0,
            "flash_bwd_dkdv": 0}
    if launches != want:
        fail(f"fused path: launches {launches}, expected {want}")
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_s = statistics.median(times[1:])
    tok_step = batch * cfg.max_seq
    log(f"[train] fused path (norm_impl=\"fused\", fused flash backward): "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps; "
        f"step time {1e3 * step_s:.1f} ms (median of steps 2-{steps}; first "
        f"step {1e3 * times[0]:.1f} ms) against {split_step_ms:.1f} ms for "
        f"the split path's fit step in this run; steady "
        f"{tok_step / step_s:.0f} tokens/s; 6·N·tokens/time/989e12 = "
        f"{6 * n_params * tok_step / step_s / BF16_FLOPS_PER_S:.3f}; peak "
        f"memory (max_memory_allocated) {peak_gb:.2f} GB; launches "
        f"{launches} (informational times)")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_ms": 1e3 * step_s,
            "peak_gb": peak_gb}


def train_phase(gen, tmp: Path) -> tuple:
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg = ModelConfig(**TRAIN_MODEL)
    t0 = time.perf_counter()
    data_path = write_tokens(tmp / "tokens.bin", cfg.vocab)
    log(f"[train] synthetic corpus: {TOKENS} uint16 tokens (64-token motif, "
        f"5% noise, seed {SEED})")
    n = compare_step(gen, cfg, data_path, TRAIN_RUN["batch"], "flagship")
    run = fit_phase(cfg, data_path, TRAIN_RUN["steps"], TRAIN_RUN["batch"],
                    "flagship", n)
    dense_curve(cfg, data_path, run["losses"])
    profile_step(cfg, data_path, TRAIN_RUN["batch"])
    log(f"[time] phase 8 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tune_path = tmp / "flash_tune.json"
    tune_path.write_text(json.dumps(FUSED_TUNE))
    fused_compare_step(gen, cfg, data_path, TRAIN_RUN["batch"], tune_path)
    fused = fused_train_phase(cfg, data_path, tune_path, TRAIN_RUN["steps"],
                              TRAIN_RUN["batch"], n, run["step_ms"])
    with fused_backward(tune_path):
        profile_step(cfg, data_path, TRAIN_RUN["batch"], "fused-path",
                     norm_impl="fused")
    log(f"[time] phase 9 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gcfg = ModelConfig(**GQA_MODEL)
    n = compare_step(gen, gcfg, data_path, GQA_RUN["batch"], "GQA")
    gqa_run = fit_phase(gcfg, data_path, GQA_RUN["steps"], GQA_RUN["batch"],
                        "GQA", n)
    log(f"[time] phase 10 {time.perf_counter() - t0:.1f} s")
    return run, fused, gqa_run


# ---------------------------------------------------------------------------
# phase 7: matmul kernels vs plain versions, timing, the bench section
# ---------------------------------------------------------------------------

def matmul_inputs(gen, m: int, k: int, n: int, norm: bool):
    """bf16 x ~ N(0, 1) and w; for the norm kernel rows of mixed scale, w
    at the init scale k^-0.5 and a gain 1 + 0.1·N(0, 1)."""
    import torch
    dev = gen.device
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    if not norm:
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    scale = torch.rand((m, 1), generator=gen, device=dev) * 4 + 0.05
    g = 1 + 0.1 * torch.randn((k,), generator=gen, device=dev)
    return ((x * scale).to(torch.bfloat16), g,
            (w * k ** -0.5).to(torch.bfloat16))


def check_matmul(gen) -> dict:
    """Each matmul kernel against its plain version at every case; returns
    the max abs error at the path's shape (4096^3; the wqkv shape)."""
    import torch

    from tpu_dra_torch.workloads import matmul as M
    path = {}
    for name, cases in (("matmul", MATMUL_CASES),
                        ("rmsnorm_matmul", RMSNORM_CASES)):
        worst = [0.0, 0.0, 0.0]
        for m, k, n in cases:
            args = matmul_inputs(gen, m, k, n, name == "rmsnorm_matmul")
            kernel, plain = ((M.matmul, M.matmul_ref) if name == "matmul"
                             else (M.fused_rmsnorm_matmul,
                                   M.fused_rmsnorm_matmul_ref))
            got = kernel(*args)
            torch.cuda.synchronize()
            res = hold(f"{name} [{m}, {k}] @ [{k}, {n}]", "out", got,
                       plain(*args), M.ROW_TOL, M.ELEM_TOL)
            log(f"[matmul] {name} [{m}, {k}] @ [{k}, {n}]: max abs err "
                f"{res[0]:.4g} (elementwise {res[1]:.3f} of the "
                f"tolerance), worst row {res[2]:.3g} -> ok")
            path.setdefault(name, res[0])
            worst = [max(a, b) for a, b in zip(worst, res)]
            del args, got
        log(f"[matmul] {name} over {len(cases)} cases: elementwise "
            f"{worst[1]:.3f} of the tolerance, worst row {worst[2]:.3g}")
    log(f"[matmul] tolerances: elementwise rtol = atol = {M.ELEM_TOL}; per "
        f"row {M.ROW_TOL}")
    return path


def time_matmul(gen) -> dict:
    """Kernel alone (its C entry, arguments prepared once), wrapper, plain
    version and library yardstick of each matmul kernel at its path's
    shapes: the bench's 4096^3 for matmul, the flagship's ln1 -> wqkv and
    ln2 -> w1 for rmsnorm_matmul.  Bounds count each operand read once,
    the output written once and 2 FLOP per multiply-add of the product
    (the norm's ~3 FLOP per x element are left out)."""
    import torch

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import matmul as M
    from tpu_dra_torch.workloads.train import _rmsnorm
    lib = library("matmul")
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()      # noqa: E731

    def checked(rc):
        if rc:
            fail(f"matmul kernel launch failed with CUDA error {rc}")
    times = {}
    x, y = matmul_inputs(gen, 4096, 4096, 4096, False)
    out = torch.empty((4096, 4096), dtype=torch.bfloat16, device=x.device)
    times["matmul 4096^3"] = {
        "ms": cuda_time_ms(lambda: checked(lib.tpu_dra_matmul(
            P(x), P(y), P(out), 4096, 4096, 4096, stream)), 50),
        "wrapper_ms": cuda_time_ms(lambda: M.matmul(x, y), 50),
        "plain_ms": cuda_time_ms(lambda: M.matmul_ref(x, y), 5, warmup=1),
        "library_ms": cuda_time_ms(lambda: torch.matmul(x, y), 50),
        "library": "torch.matmul, bf16",
        **flash_bound(3 * 4096 * 4096 * 2, 2 * 4096 ** 3)}
    del x, y, out
    for label, (m, k, n) in (("rmsnorm_matmul ln1 -> wqkv",
                              RMSNORM_CASES[0]),
                             ("rmsnorm_matmul ln2 -> w1", RMSNORM_CASES[1])):
        x, g, w = matmul_inputs(gen, m, k, n, True)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
        r = torch.empty(m, dtype=torch.float32, device=x.device)
        xn = torch.empty_like(x)
        log(f"[time] {label}: the plain tiled matmul kernel alone at the "
            f"same shape takes "
            f"{cuda_time_ms(lambda: M.matmul(x, w), 30) * 1e3:.1f} us "
            f"(informational: the norm's share is the difference)")
        times[f"{label} [{m}, {k}] @ [{k}, {n}]"] = {
            "ms": cuda_time_ms(lambda: checked(lib.tpu_dra_rmsnorm_matmul(
                P(x), P(g), P(w), P(r), P(xn), P(out), m, n, k, M.EPS,
                stream)), 30),
            "wrapper_ms": cuda_time_ms(
                lambda: M.fused_rmsnorm_matmul(x, g, w), 30),
            "plain_ms": cuda_time_ms(
                lambda: M.fused_rmsnorm_matmul_ref(x, g, w), 3, warmup=1),
            # two calls: the train trunk's unfused pair
            "library_ms": cuda_time_ms(
                lambda: torch.matmul(_rmsnorm(x, g), w), 30),
            "library": "two calls: train._rmsnorm, then torch.matmul",
            **flash_bound(m * k * 2 + k * 4 + k * n * 2 + m * n * 2,
                          2 * m * k * n)}
        del x, g, w, out, xn
    return times


def log_times(times: dict, card: str) -> None:
    for label, t in times.items():
        log(f"[time] {label}: kernel {t['ms'] * 1e3:.1f} us (through the "
            f"Python wrapper {t['wrapper_ms'] * 1e3:.1f} us), plain version "
            f"{t['plain_ms'] * 1e3:.1f} us, library yardstick "
            f"{t['library_ms'] * 1e3:.1f} us ({t['library']}); bound "
            f"{t['bound_ms'] * 1e3:.1f} us by {t['bound_by']} "
            f"({t['bytes']} B at 3.35 TB/s, {t['flops']} FLOP at 989 TF/s), "
            f"{t['bound_ms'] / t['ms']:.3f} of it reached, on {card}")


def bench_phase() -> dict:
    """``tpu_dra_torch.bench.section_pallas_matmul()``, the matmul kernel's
    path: its launch count is zeroed just before and read just after."""
    from tpu_dra_torch.bench import section_pallas_matmul
    from tpu_dra_torch.workloads.matmul import matmul
    matmul.launches = 0
    res = section_pallas_matmul()
    launches = matmul.launches
    log(f"[bench] section_pallas_matmul: {json.dumps(res)}; matmul kernel "
        f"launches {launches}")
    if launches < 200 or not res["pallas_matmul_tflops"] > 0:
        fail(f"section_pallas_matmul: {res}, {launches} launches")
    return {"launches": launches, **res}


def check_spills(built, pattern: str = "") -> None:
    """Fail if ptxas reported spill bytes, or wgmma serialized for want of
    registers (C7512), for a kernel of ``built`` whose mangled name
    matches ``pattern`` (every kernel where it is empty), from a fresh
    build's log (a reused library has none to read)."""
    if not built.log:
        log(f"[build] {built.path.name} was reused: no ptxas lines to check")
        return
    faults, name = [], ""
    for ln in built.log.splitlines():
        found = re.search(r"Function properties for (\S+)", ln)
        if found:
            name = found.group(1)
        elif re.search(r"[1-9]\d* bytes spill (stores|loads)", ln):
            if re.search(pattern, name):
                faults.append(f"{name}: {ln.strip()}")
        elif "C7512" in ln and any(re.search(pattern, f) for f in
                                   re.findall(r"'(\w+)'", ln)):
            faults.append(ln.strip())
    if faults:
        fail(f"ptxas spills or serialized wgmma in {built.path.name}: "
             f"{faults}")
    log(f"[build] {built.path.name}: no spills"
        + (f" in the kernels matching {pattern!r}" if pattern else ""))


def log_fwd_summary(shape: str, t: dict, card: str) -> None:
    """The forward's share of its bound, its ratio to the SDPA forward and
    its time before the redesign."""
    log(f"[time] flash_fwd at the {shape}: {t['ms'] * 1e3:.1f} us, "
        f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} us "
        f"bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x the SDPA "
        f"forward's {t['library_ms'] * 1e3:.1f} us; before the TMA/wgmma "
        f"redesign {FWD_BEFORE_US[shape]} us; on {card}")


def log_fused_summary(shape: str, times: dict, card: str) -> None:
    """The fused backward's time, the SDPA backward's, its share of the
    bound, its scratch and the split pair's time in the same run."""
    t = times["flash_bwd_fused"]
    split = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkdv"]["ms"]
    log(f"[time] flash_bwd_fused at the {shape}: {t['ms'] * 1e3:.1f} us, "
        f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} us "
        f"bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x the SDPA "
        f"backward's {t['library_ms'] * 1e3:.1f} us; scratch "
        f"{t['scratch_bytes']} B ({t['scratch_bytes'] / 1e9:.3f} GB); the "
        f"split pair (flash_bwd_dq + flash_bwd_dkdv) {split * 1e3:.1f} us; "
        f"before the TMA/wgmma redesign {FUSED_BEFORE_US[shape]} us; on "
        f"{card}")


def log_split_summary(shape: str, times: dict, card: str) -> None:
    """The split pair's times and shares of their bounds, the pair against
    the SDPA backward (which computes dq, dk and dv together) in the same
    run, and the pair's times before its TMA/wgmma redesign."""
    dq, kv = times["flash_bwd_dq"], times["flash_bwd_dkdv"]
    pair = dq["ms"] + kv["ms"]
    parts = [f"{name} {t['ms'] * 1e3:.1f} us ({t['bound_ms'] / t['ms']:.3f} "
             f"of its {t['bound_ms'] * 1e3:.1f} us bound by {t['bound_by']})"
             for name, t in (("flash_bwd_dq", dq), ("flash_bwd_dkdv", kv))]
    log(f"[time] split backward at the {shape}: {', '.join(parts)}; the "
        f"pair {pair * 1e3:.1f} us, {pair / dq['library_ms']:.2f}x the SDPA "
        f"backward's {dq['library_ms'] * 1e3:.1f} us; before the TMA/wgmma "
        f"redesign {SPLIT_BEFORE_US.get(shape, 'not measured')}; on {card}")


def log_matmul_summary(t: dict, benched: dict, card: str) -> None:
    """The plain matmul's share of its bound and its ratio to
    torch.matmul at 4096^3, and the bench section's rate."""
    log(f"[time] matmul 4096^3: {t['ms'] * 1e3:.1f} us, "
        f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} us "
        f"bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x "
        f"torch.matmul's {t['library_ms'] * 1e3:.1f} us; "
        f"pallas_matmul_tflops {benched['pallas_matmul_tflops']}; before "
        f"the wgmma redesign {MATMUL_BEFORE_US} us; on {card}")


def log_norm_summary(times: dict, card: str) -> None:
    """The RMSNorm-matmul's share of its bound, its ratio to the unfused
    pair and its time before the wgmma redesign, at both path shapes."""
    for name, before in NORM_BEFORE_US.items():
        t = next(v for k, v in times.items() if k.startswith(name))
        log(f"[time] {name}: {t['ms'] * 1e3:.1f} us, "
            f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} "
            f"us bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x "
            f"the unfused pair's {t['library_ms'] * 1e3:.1f} us; before the "
            f"wgmma redesign {before} us; on {card}")


def log_ring_summary(times: dict, card: str) -> None:
    """Each ring matmul's share of its bound, its ratio to the library
    call and its time before the wgmma redesign."""
    for name, before in RING_BEFORE_US.items():
        t = times[name]
        log(f"[time] {name}: {t['ms'] * 1e3:.1f} us, "
            f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} "
            f"us bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x "
            f"the library call's {t['library_ms'] * 1e3:.1f} us; before the "
            f"wgmma redesign {before} us; one launch a ring step (the "
            f"earlier design) "
            f"{RING_STEPS_US[name]} us; on {card}")


def log_flash_times(shape: str, times: dict, card: str) -> None:
    for name, t in times.items():
        lib = ("forward" if name == "flash_fwd"
               else "backward: dq, dk, dv together")
        log(f"[time] {name} at the {shape}: kernel {t['ms'] * 1e3:.1f} us "
            f"(through the Python wrapper {t['wrapper_ms'] * 1e3:.1f} us), "
            f"plain version {t['plain_ms'] * 1e3:.1f} us, library "
            f"yardstick {t['library_ms'] * 1e3:.1f} us "
            f"(scaled_dot_product_attention {lib}); bound "
            f"{t['bound_ms'] * 1e3:.1f} us by {t['bound_by']} "
            f"({t['bytes']} B at 3.35 TB/s, {t['flops']} FLOP at 989 "
            f"TF/s), {t['bound_ms'] / t['ms']:.3f} of it reached, on {card}")


# ---------------------------------------------------------------------------
# phases 11-12: the ring kernels against their plain versions, and timed
# ---------------------------------------------------------------------------

def ring_inputs(gen, G: int, n: int, rows: int, k: int, n_out: int):
    """bf16 x ~ N(0, 1) [G, n, rows, K] and per-rank w at the init scale
    K^-0.5 [n, K, N], shared by the G groups (an expanded view)."""
    import torch
    dev = gen.device
    x = torch.randn((G, n, rows, k), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((1, n, k, n_out), generator=gen, device=dev)
         * k ** -0.5).to(torch.bfloat16)
    return x, w.expand(G, -1, -1, -1)


def hold_ring(label: str, got, want) -> tuple:
    """A ring matmul's y against its plain version, elementwise and per
    output row (collective_matmul.ELEM_TOL, ROW_TOL)."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    return hold(label, "y", got.flatten(0, -2), want.flatten(0, -2),
                cm.ROW_TOL, cm.ELEM_TOL)


def check_ring(gen) -> dict:
    """Phase 11: each ring kernel against its plain version at every shape
    the training paths launch it at (tp 4: the gather at x [4096, 2048]
    per rank against the wqkv and w1 shards, and against wo^T for wo's
    dx; the reduce-scatter at [16384, 512] @ wo and [16384, 2048] @ w2,
    and [16384, 1536] @ wqkv^T for wqkv's dx; w1's and w2's dx run the
    w2 and w1 shapes; the shift at k/v blocks [16, 16, 256, 128]),
    then n 1 and 2, odd m (the unidirectional gather), a ragged K and two
    groups; the gathered operand and the shift byte-equal; then the VJPs
    against autograd through the plain versions.  Returns the max abs
    error of each kernel at its path's first shape."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    cases = [  # (label, G, n, m, K, N)
        ("path: wqkv", 1, 4, 4096, 2048, 1536),
        ("path: w1", 1, 4, 4096, 2048, 2048),
        ("bwd: wo^T", 1, 4, 4096, 2048, 512),
        ("n 1", 1, 1, 512, 256, 256), ("n 2", 1, 2, 1024, 512, 384),
        ("odd m (unidirectional)", 1, 4, 1001, 256, 512),
        ("ragged K", 1, 4, 512, 200, 136), ("dp 2", 2, 4, 256, 512, 256)]
    errs = {}
    for label, G, n, m, k, n_out in cases:
        x, w = ring_inputs(gen, G, n, m, k, n_out)
        y, a = cm.all_gather_matmul(x, w)
        torch.cuda.synchronize()
        want_y, want_a = cm.all_gather_matmul_ref(x, w)
        if not torch.equal(a, want_a):
            fail(f"all_gather_matmul {label}: gathered operand not "
                 f"byte-equal")
        err, ratio, row = hold_ring(f"all_gather_matmul {label}", y, want_y)
        errs.setdefault("all_gather_matmul", err)
        log(f"[ring] all_gather_matmul {label} [G {G}, n {n}, m {m}, K {k}, "
            f"N {n_out}]: max abs err {err:.4g} (elementwise {ratio:.3f} of "
            f"the tolerance), worst row {row:.3g}; gathered operand "
            f"byte-equal -> ok")
        del x, w, y, a, want_y, want_a
    cases = [("path: w2", 1, 4, 4096, 2048, 2048),
             ("path: wo", 1, 4, 4096, 512, 2048),
             ("bwd: wqkv^T", 1, 4, 4096, 1536, 2048),
             ("n 1", 1, 1, 512, 256, 256), ("n 2", 1, 2, 1024, 512, 384),
             ("odd m", 1, 4, 1001, 256, 512), ("ragged K", 1, 4, 512, 200, 136),
             ("dp 2", 2, 4, 256, 512, 256)]
    for label, G, n, m, k, n_out in cases:
        x, w = ring_inputs(gen, G, n, n * m, k, n_out)
        y = cm.matmul_reduce_scatter(x, w)
        torch.cuda.synchronize()
        err, ratio, row = hold_ring(f"matmul_reduce_scatter {label}", y,
                                    cm.matmul_reduce_scatter_ref(x, w))
        errs.setdefault("matmul_reduce_scatter", err)
        log(f"[ring] matmul_reduce_scatter {label} [G {G}, n {n}, n·m "
            f"{n * m}, K {k}, N {n_out}]: max abs err {err:.4g} (elementwise "
            f"{ratio:.3f} of the tolerance), worst row {row:.3g} -> ok")
        del x, w, y
    for label, shape, dtype in (
            ("path: k/v blocks", (1, 4, 16, 16, 256, 128), torch.bfloat16),
            ("n 2, fp32", (1, 2, 1000, 3), torch.float32),
            ("dp 2, ragged bytes", (2, 4, 33), torch.bfloat16)):
        x = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
        for reverse in (False, True):
            if not torch.equal(cm.ring_shift(x, reverse),
                               cm.ring_shift_ref(x, reverse)):
                fail(f"ring_shift {label}: not the plain shift")
        log(f"[ring] ring_shift {label} {list(shape)}: byte-equal both "
            f"ways -> ok")
    errs["ring_shift"] = 0.0
    # the VJPs: each backward is the other kernel
    for name, fn, ref, rows in (
            ("AllGatherMatmul", cm.AllGatherMatmul, cm.all_gather_matmul_ref,
             1024), ("MatmulReduceScatter", cm.MatmulReduceScatter,
                     cm.matmul_reduce_scatter_ref, 4096)):
        x, w = ring_inputs(gen, 2, 4, rows, 512, 256)
        w0 = w[:1].detach().clone()
        xs, ws = x.clone().requires_grad_(), w0.clone().requires_grad_()
        out = fn.apply(xs, ws.expand(2, -1, -1, -1))
        g = torch.randn(out.shape, generator=gen, device=gen.device).to(
            torch.bfloat16)
        got = torch.autograd.grad(out, (xs, ws), g)
        xr, wr = x.clone().requires_grad_(), w0.clone().requires_grad_()
        plain = ref(xr, wr.expand(2, -1, -1, -1))
        plain = plain[0] if isinstance(plain, tuple) else plain
        want = torch.autograd.grad(plain, (xr, wr), g)
        for part, a, b in zip(("dx", "dw"), got, want):
            err = float((a.float() - b.float()).norm() / b.float().norm())
            log(f"[ring] {name} {part} against autograd through the plain "
                f"version: relative L2 {err:.3g} (tolerance {VJP_REL})")
            if not err <= VJP_REL:
                fail(f"{name} {part}: relative L2 {err} > {VJP_REL}")
    x = torch.randn((1, 4, 8, 1024), generator=gen, device=gen.device).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn_like(x)
    (d,) = torch.autograd.grad(cm.RingShift.apply(x, False), x, g)
    if not torch.equal(d, cm.ring_shift_ref(g, True)):
        fail("RingShift: the cotangent did not shift back")
    log("[ring] RingShift: the cotangent shifts the other way, byte-equal "
        "-> ok")
    ring_back_to_back()
    log(f"[ring] tolerances: y elementwise rtol = atol = {cm.ELEM_TOL}, per "
        f"row {cm.ROW_TOL}; gathered operand and shift byte-equal; VJPs "
        f"{VJP_REL} relative L2")
    return errs


def ring_back_to_back() -> None:
    """Phase 11's last check: RING_BACK_TO_BACK gathers (m even and odd
    in turn: both schedules) and as many reduce-scatters on one virtual
    ring of two groups of 4, enqueued with no host synchronize between
    them, each call on inputs of its own; then every output held to its
    plain version (the gathered operand byte-equal).  Each call is one
    launch on the ring's one flag buffer, its waits met only by flags
    that carry its own epoch.  The inputs come from a generator of their
    own, so that every later phase's inputs come from `gen` as before."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    G, n, m, k, n_out = 2, 4, 1024, 1024, 768
    calls = []
    before = (cm.all_gather_matmul.launches,
              cm.matmul_reduce_scatter.launches)
    t0 = time.perf_counter()
    for i in range(RING_BACK_TO_BACK):
        x, w = ring_inputs(gen, G, n, m - i % 2, k, n_out)
        calls.append((x, w, cm.all_gather_matmul(x, w)))
        xr, wr = ring_inputs(gen, G, n, n * m, k, n_out)
        calls.append((xr, wr, cm.matmul_reduce_scatter(xr, wr)))
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = (cm.all_gather_matmul.launches - before[0],
                cm.matmul_reduce_scatter.launches - before[1])
    if launched != (RING_BACK_TO_BACK, RING_BACK_TO_BACK):
        fail(f"ring back to back: launches {launched}, expected one a call")
    worst = [0.0, 0.0]
    for i, (x, w, got) in enumerate(calls):
        if isinstance(got, tuple):
            want_y, want_a = cm.all_gather_matmul_ref(x, w)
            if not torch.equal(got[1], want_a):
                fail(f"all_gather_matmul back to back, call {i // 2}: "
                     f"gathered operand not byte-equal")
            err = hold_ring(f"all_gather_matmul back to back, call {i // 2}",
                            got[0], want_y)[1]
        else:
            err = hold_ring(f"matmul_reduce_scatter back to back, call "
                            f"{i // 2}", got, cm.matmul_reduce_scatter_ref(
                                x, w))[1]
        worst[i % 2] = max(worst[i % 2], err)
    log(f"[ring] back to back: {RING_BACK_TO_BACK} all_gather_matmul and "
        f"{RING_BACK_TO_BACK} matmul_reduce_scatter calls [G {G}, n {n}, m "
        f"{m - 1}-{m}, K {k}, N {n_out}] enqueued in {enqueued:.2f} s with "
        f"no host synchronize, one launch each; every output held to its "
        f"plain version afterwards (worst elementwise {worst[0]:.3f} and "
        f"{worst[1]:.3f} of the tolerance; gathered operands byte-equal) "
        f"-> ok")
    del calls
    torch.cuda.empty_cache()


def time_ring(gen) -> dict:
    """Phase 12: each ring kernel alone (its C entries with prepared
    arguments, one launch a call on the ring's zeroed flag words, each
    call its own epoch), through its wrapper, its plain
    version and a library yardstick, with CUDA events, at the path's
    shapes.  Bounds: operands read once; outputs written once; the n − 1
    ring copies read once more (the gathered slots at the next step, the
    reduce-scatter's fp32 partials written and read); 2 FLOP per
    multiply-add."""
    import torch

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import collective_matmul as cm
    lib = library("ring")
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()      # noqa: E731

    def checked(rc):
        if rc:
            fail(f"ring kernel launch failed with CUDA error {rc}")
    flags = torch.zeros(4 * lib.tpu_dra_ring_flag_words(4), dtype=torch.int32,
                        device="cuda")
    epoch = [0]

    def next_epoch():
        epoch[0] += 1
        return epoch[0]
    times = {}
    for label, m, k, n_out in (("wqkv", 4096, 2048, 1536),
                               ("w1", 4096, 2048, 2048)):
        n = 4
        x, w = ring_inputs(gen, 1, n, m, k, n_out)
        y = torch.empty((1, n, n * m, n_out), dtype=torch.bfloat16,
                        device=x.device)
        a = torch.empty((1, n, n, m, k), dtype=torch.bfloat16, device=x.device)

        def kernel():
            checked(lib.tpu_dra_ring_ag_matmul(
                P(x), P(w), P(y), P(a), P(flags), 1, n, m, k, n_out, m * k,
                n * m * k, w.stride(1), 0, 1, next_epoch(), stream))
        gathered = x.reshape(1, n * m, k)
        wl = w[0]
        times[f"all_gather_matmul {label}"] = {
            "ms": cuda_time_ms(kernel, 20),
            "wrapper_ms": cuda_time_ms(lambda: cm.all_gather_matmul(x, w), 20),
            "plain_ms": cuda_time_ms(lambda: cm.all_gather_matmul_ref(x, w), 3,
                                     warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.matmul(gathered, wl), 20),
            "library": "one batched torch.matmul of the gathered x against "
                       "the stacked w",
            **flash_bound(
                2 * (n * m * k + n * k * n_out + n * n * m * n_out
                     + n * n * m * k + (n - 1) * n * m * k),
                2 * n * (n * m) * k * n_out)}
        del x, w, y, a, gathered
    for label, m, k, n_out in (("w2", 4096, 2048, 2048),
                               ("wo", 4096, 512, 2048)):
        n = 4
        x, w = ring_inputs(gen, 1, n, n * m, k, n_out)
        y = torch.empty((1, n, m, n_out), dtype=torch.bfloat16,
                        device=x.device)
        comm = torch.empty((1, n, n - 1, m, n_out), dtype=torch.float32,
                           device=x.device)

        def kernel():
            checked(lib.tpu_dra_ring_matmul_rs(
                P(x), P(w), P(comm), P(y), P(flags), 1, n, m, k, n_out,
                n * m * k, n * n * m * k, w.stride(1), 0, next_epoch(),
                stream))
        xl, wl = x[0], w[0]
        times[f"matmul_reduce_scatter {label}"] = {
            "ms": cuda_time_ms(kernel, 20),
            "wrapper_ms": cuda_time_ms(
                lambda: cm.matmul_reduce_scatter(x, w), 20),
            "plain_ms": cuda_time_ms(
                lambda: cm.matmul_reduce_scatter_ref(x, w), 3, warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.matmul(xl, wl).reshape(
                n, n, m, n_out).sum(0), 20),
            "library": "two calls: torch.matmul, then the sum over ranks",
            **flash_bound(
                2 * (n * n * m * k + n * k * n_out + n * m * n_out)
                + 2 * 4 * (n - 1) * n * m * n_out,
                2 * n * (n * m) * k * n_out)}
        del x, w, y, comm
    x = torch.randn((1, 4, 16, 16, 256, 128), generator=gen,
                    device=gen.device).to(torch.bfloat16)
    out = torch.empty_like(x)
    per_rank = x[0, 0].numel() * 2
    times["ring_shift k/v block"] = {
        "ms": cuda_time_ms(lambda: checked(lib.tpu_dra_ring_shift(
            P(x), P(out), 1, 4, per_rank, 1, stream)), 50),
        "wrapper_ms": cuda_time_ms(lambda: cm.ring_shift(x), 50),
        "plain_ms": cuda_time_ms(lambda: cm.ring_shift_ref(x), 20),
        "library_ms": cuda_time_ms(lambda: torch.roll(x, 1, dims=1), 50),
        "library": "torch.roll",
        **flash_bound(2 * x.numel() * 2, 0)}
    return times


# ---------------------------------------------------------------------------
# phases 13-14: DP×TP fused collective and DP×SP ring flash training
# ---------------------------------------------------------------------------

def leaf_updates(old: dict, new: dict, scale: float) -> dict:
    """``(old − new) / scale`` per leaf of two parameter trees (the
    gradient an SGD step applied, for scale = lr)."""
    return {k: (leaf_updates(v, new[k], scale) if isinstance(v, dict)
                else (v - new[k]) / scale) for k, v in old.items()}


def window_batches(data_path: str, batch: int, seq: int, count: int):
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    it = batches(TokenDataset(data_path), batch=batch, seq=seq)
    return [torch.from_numpy(next(it)).to("cuda") for _ in range(count)]


def train_loop(label: str, step, params, windows, counters: dict,
               must_fall: bool = True) -> dict:
    """``step(params, window)`` over ``windows`` with the kernels' launch
    counts zeroed just before and read just after; fails unless every loss
    is finite and (``must_fall``) the last below the first."""
    import math

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, stamps = [], []
    t0 = time.perf_counter()
    for win in windows:
        params, loss = step(params, win)
        losses.append(float(loss))
        stamps.append(time.perf_counter())
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {label} losses by step: "
        f"{', '.join(repr(x) for x in losses)}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: losses {losses}")
    if must_fall and not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses}")
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_s = statistics.median(times[1:])
    return {"launches": launches, "losses": losses, "step_ms": 1e3 * step_s,
            "first_ms": 1e3 * times[0], "total_ms": 1e3 * sum(times),
            "peak_gb": peak_gb, "params": params}


def sharded_phase(gen, data_path: str) -> dict:
    """Phase 13: ``make_sharded_train_step`` on Mesh({"dp": 1, "tp": 4})
    with flash attention and matmul_impl="fused_collective": one step
    against the same mesh's dense step (loss within STEP_LOSS_ATOL, every
    gradient leaf, read off an SGD step at lr 1 as p − p', within
    STEP_LEAF_REL), then SHARDED_RUN steps at SGD_LR on [16, 1025]
    windows with finite, falling losses and exactly 4·L gather and 4·L
    reduce-scatter launches a step (4·L calls of each: the forward's two,
    and each one's backward through the other; one launch a call; the
    remat keeps their outputs, so none runs again) and the flash
    forward 2·L times a step (the remat recomputes it), then the dense
    sharded step's time beside it and one profiled step."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                               make_sharded_train_step,
                                               tree_leaves)
    cfg = ModelConfig(**TRAIN_MODEL)
    mesh = Mesh({"dp": 1, "tp": 4})
    n, L, batch = 4, cfg.n_layers, SHARDED_RUN["batch"]
    windows = window_batches(data_path, batch, cfg.max_seq,
                             SHARDED_RUN["steps"] + 1)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    grads = {}
    for impl in ("fused_collective", "dense"):
        step, _, _ = make_sharded_train_step(
            cfg, mesh, lr=1.0, attn_impl="flash", matmul_impl=impl)
        new, loss = step(params, windows[0])
        grads[impl] = (loss, leaf_updates(params, new, 1.0))
        del new
    hold_step("DP×TP tp 4", "fused-collective step vs the dense sharded "
              "step", *grads["fused_collective"], *grads["dense"])
    del grads
    counters = {"all_gather_matmul": cm.all_gather_matmul,
                "matmul_reduce_scatter": cm.matmul_reduce_scatter,
                "flash_fwd": F.flash_attn_fwd, "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    step, _, _ = make_sharded_train_step(cfg, mesh, lr=SGD_LR,
                                         attn_impl="flash",
                                         matmul_impl="fused_collective")
    steps = SHARDED_RUN["steps"]
    run = train_loop("DP×TP fused collective", step, params,
                     windows[1:], counters)
    want = {"all_gather_matmul": 4 * L * steps,
            "matmul_reduce_scatter": 4 * L * steps,
            **flash_want(L * steps)}
    if run["launches"] != want:
        fail(f"DP×TP fused collective: launches {run['launches']}, "
             f"expected {want}")
    dense_step, _, _ = make_sharded_train_step(cfg, mesh, lr=SGD_LR,
                                               attn_impl="flash")
    dense = train_loop("DP×TP dense (plain collectives, informational)",
                       dense_step, params, windows[1:], {}, must_fall=False)
    tok_step = batch * cfg.max_seq
    for label, r in (("fused collective", run), ("dense", dense)):
        log(f"[train] DP×TP {label}, tp 4 on one card: step "
            f"{r['step_ms']:.1f} ms (median of steps 2-{len(r['losses'])}; "
            f"first {r['first_ms']:.1f} ms), steady "
            f"{tok_step / r['step_ms'] * 1e3:.0f} tokens/s, "
            f"6·N·tokens/time/989e12 = "
            f"{6 * n_params * tok_step / r['step_ms'] * 1e3 / BF16_FLOPS_PER_S:.3f}"
            f", peak memory (max_memory_allocated) {r['peak_gb']:.2f} GB "
            f"(informational)")
    log(f"[train] DP×TP fused collective: launches over {steps} steps "
        f"{run['launches']} (exact: 4·L per matmul kernel, 2·L flash "
        f"forwards and L of each flash backward kernel a step)")
    state = {"p": run["params"]}

    def one():
        state["p"], _ = step(state["p"], windows[-1])
    prof = profile_call("DP×TP fused-collective train step", one)
    if prof:
        ring_us = prof.get(kernel_kind("ring_"), 0.0)
        log(f"[train] DP×TP fused collective, one traced step: ring kernels "
            f"{ring_us / 1e3:.1f} ms of {prof['busy'] / 1e3:.1f} ms device "
            f"busy ({ring_us / prof['busy']:.3f}), wall "
            f"{prof['wall'] / 1e3:.1f} ms, idle share "
            f"{1 - prof['busy'] / prof['wall']:.3f} (before the wgmma "
            f"redesign: ~114 ms of 272.9 ms busy, idle share 0.019)")
    del run["params"], dense["params"], params, state
    torch.cuda.empty_cache()
    return {**run, "dense_step_ms": dense["step_ms"]}


def ring_phase(gen, data_path: str) -> dict:
    """Phase 14: ``make_ring_train_step`` on Mesh({"dp": 1, "sp": 4}) with
    ring_impl="flash": one step with hop_impl="pallas" (the shift kernel)
    bit-equal to hop_impl="xla" (torch.roll), loss and updated parameters;
    the same step against the one-device flash step on the same window
    (loss within STEP_LOSS_ATOL; gradients, the update over lr·n_ranks as
    the reference's summed replica gradients carry the rank count, within
    STEP_LEAF_REL); then SHARDED_RUN steps with finite, falling losses and
    exactly 6·(n − 1)·L shift launches a step (2·(n − 1)·L forward, as
    many again when the backward recomputes each block, the reference's
    full remat, and as many backward), 2·n·L flash forwards and n·L of
    each backward kernel, and one profiled step."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.train import (ModelConfig, grads_fn,
                                               init_params, tree_leaves)
    cfg = ModelConfig(**TRAIN_MODEL)
    n, L, batch = 4, cfg.n_layers, SHARDED_RUN["batch"]
    mesh = Mesh({"dp": 1, "sp": n})
    windows = window_batches(data_path, batch, cfg.max_seq,
                             SHARDED_RUN["steps"] + 1)
    params = init_params(cfg, gen)
    win = windows[0]
    res = {}
    for hop in ("pallas", "xla"):
        step, _ = make_ring_train_step(cfg, mesh, lr=1.0, ring_impl="flash",
                                       hop_impl=hop)
        res[hop] = step(params, win[:, :-1], win[:, 1:])
    (pp, lp), (px, lx) = res["pallas"], res["xla"]
    same = float(lp) == float(lx) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(pp), tree_leaves(px)))
    log(f"[train] DP×SP ring flash, sp {n}: hop_impl=\"pallas\" vs \"xla\": "
        f"loss {float(lp)!r} vs {float(lx)!r}; loss and every updated "
        f"parameter bit-equal: {same}")
    if not same:
        fail("DP×SP: the shift kernel's step is not bit-equal to torch.roll's")
    del px, res
    loss1, g1 = grads_fn(cfg, params, win, attn_impl="flash")
    hold_step(f"DP×SP sp {n}", "ring flash step (update / (lr·n)) vs the "
              "one-device flash step", lp, leaf_updates(params, pp, n),
              loss1, g1)
    del pp, g1
    step, _ = make_ring_train_step(cfg, mesh, lr=SGD_LR, ring_impl="flash",
                                   hop_impl="pallas")
    counters = {"ring_shift": cm.ring_shift, "flash_fwd": F.flash_attn_fwd,
                "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    steps = SHARDED_RUN["steps"]
    run = train_loop("DP×SP ring flash", lambda p, w: step(p, w[:, :-1],
                                                           w[:, 1:]),
                     params, windows[1:], counters)
    want = {"ring_shift": 6 * (n - 1) * L * steps,
            **flash_want(n * L * steps)}
    if run["launches"] != want:
        fail(f"DP×SP ring flash: launches {run['launches']}, expected {want}")
    tok_step = batch * cfg.max_seq
    log(f"[train] DP×SP ring flash, sp {n} on one card: step "
        f"{run['step_ms']:.1f} ms (median of steps 2-{steps}; first "
        f"{run['first_ms']:.1f} ms), steady "
        f"{tok_step / run['step_ms'] * 1e3:.0f} tokens/s, peak memory "
        f"(max_memory_allocated) {run['peak_gb']:.2f} GB; launches "
        f"{run['launches']} (exact: 6·(n−1)·L shifts, 2·n·L flash forwards, "
        f"n·L of each backward kernel a step; informational times)")
    state = {"p": run["params"]}

    def one():
        state["p"], _ = step(state["p"], windows[-1][:, :-1],
                             windows[-1][:, 1:])
    profile_call("DP×SP ring-flash train step", one)
    del run["params"], params, state
    torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# phase 15: the quantized products on the card
# ---------------------------------------------------------------------------

# (K, N) of the serving model's matmuls (wqkv, wo, w1, w2, unembed) and the
# rows they see: a decode step at 8 requests, the engine's 32 slots, and a
# prefill of 256 tokens
QUANT_SHAPES = [(1024, 1536), (1024, 1024), (1024, 4096), (4096, 1024),
                (1024, 32768)]
QUANT_ROWS = (8, 32, 256)
# int4 on the card takes bf16 operands with fp32 accumulation, the plain
# version fp32 operands: with bf16 activations every product is exact in
# both, so they part only by the order and rounding of the fp32 sums
# (within 1e-4 of the output's largest magnitude); the STE backward and
# a LoRA adapter over an int8 base round their result to bf16 once
INT4_CARD_REL = 1e-4
BF16_REL = 2 ** -7


def quant_phase(gen) -> dict:
    """Each quantized product on the card against its plain version on
    the CPU (the same inputs): the int8 product through torch._int_mm
    bit-equal (the int32 product alone, and the whole int8_matmul), the
    STE backward, int4 at bf16 operands, LoRA over an int8 base; times
    beside torch.matmul of the bf16 weights, for information."""
    import torch

    from tpu_dra_torch.workloads.quant import (int4_matmul, int8_matmul,
                                               int8_product,
                                               int8_product_ref, matmul_any,
                                               quantize_int4, quantize_int8)

    def cpu(tree):
        return {k: v.cpu() for k, v in tree.items()}

    times = {}
    for K, N in QUANT_SHAPES:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        q8, q4 = quantize_int8(w), quantize_int4(w)
        row_major = q8["q8"].contiguous()          # the layout q8 is not
        wb = w.to(torch.bfloat16)
        for M in QUANT_ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            xq = torch.randint(-127, 128, (M, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            exact = int8_product_ref(xq, q8["q8"])
            if not (torch.equal(int8_product(xq, q8["q8"]), exact) and
                    torch.equal(int8_product(xq, row_major), exact)):
                fail(f"int8 product [{M}, {K}] @ [{K}, {N}] differs from "
                     f"its plain version")
            got = int8_matmul(x, q8["q8"], q8["s"])
            want = int8_matmul(x.cpu(), *cpu(q8).values())
            if not torch.equal(got.cpu(), want):
                fail(f"int8_matmul [{M}, {K}] @ [{K}, {N}] is not "
                     f"bit-equal to its plain version")
            got4 = int4_matmul(x, q4["q4"], q4["s4"]).cpu()
            want4 = int4_matmul(x.cpu(), *cpu(q4).values())
            err4 = float((got4 - want4).abs().max())
            if err4 > INT4_CARD_REL * float(want4.abs().max()):
                fail(f"int4_matmul [{M}, {K}] @ [{K}, {N}]: max error "
                     f"{err4:.3g} over {INT4_CARD_REL} of the output")
            times[(M, K, N)] = {
                "int8_matmul": cuda_time_ms(
                    lambda: int8_matmul(x, q8["q8"], q8["s"]), 20),
                "int8_product": cuda_time_ms(
                    lambda: int8_product(xq, q8["q8"]), 20),
                "int8_product_row_major": cuda_time_ms(
                    lambda: int8_product(xq, row_major), 20),
                "int4_matmul": cuda_time_ms(
                    lambda: int4_matmul(x, q4["q4"], q4["s4"]), 20),
                "bf16_matmul": cuda_time_ms(lambda: x @ wb, 20)}
    # the STE backward and LoRA over an int8 base, at wqkv's shape
    K, N = QUANT_SHAPES[0]
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    q8 = quantize_int8(w)
    x = torch.randn((32, K), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((32, N), generator=gen, device="cuda")
    xg = x.clone().requires_grad_(True)
    (int8_matmul(xg, q8["q8"], q8["s"]) * g).sum().backward()
    want = ((g.cpu().double() * q8["s"].cpu().double())
            @ q8["q8"].cpu().double().T)
    err = float((xg.grad.cpu().double() - want).abs().max())
    if err > BF16_REL * float(want.abs().max()):
        fail(f"int8_matmul STE backward: max error {err:.3g}")
    leaf = {"base": q8,
            "a": (torch.randn((K, 16), generator=gen, device="cuda")
                  * K ** -0.5).to(torch.bfloat16),
            "b": (torch.randn((16, N), generator=gen, device="cuda")
                  * 0.25).to(torch.bfloat16),
            "scale": torch.tensor(2.0, device="cuda")}
    got = matmul_any(x, leaf).float().cpu()
    want = matmul_any(x.cpu(), {k: cpu(v) if isinstance(v, dict)
                                else v.cpu() for k, v in leaf.items()})
    err_lora = float((got - want.float()).abs().max())
    if err_lora > BF16_REL * float(want.float().abs().max()):
        fail(f"LoRA over int8: max error {err_lora:.3g}")
    log(f"[quant] the int8 product through torch._int_mm is bit-equal to "
        f"its plain version at every shape ({len(QUANT_SHAPES)} weights x "
        f"rows {QUANT_ROWS}); int4 within {INT4_CARD_REL} of each output; "
        f"STE backward max error {err:.3g}, LoRA over int8 {err_lora:.3g}")
    return times


# section_decode's steps in phase 16: its host-bound decodes (seven runs,
# best of 3) took most of phases 15-16 at the bench's 256, about 50 s at
# 64 and 15.8 s at 16 (H100 80GB HBM3, 700 W)
DECODE_STEPS = 8


def short_section_decode() -> dict:
    """``bench.section_decode`` with its runs cut to DECODE_STEPS steps."""
    from tpu_dra_torch import bench
    saved = bench.DECODE_RUN
    bench.DECODE_RUN = dict(saved, steps=DECODE_STEPS)
    try:
        return bench.section_decode()
    finally:
        bench.DECODE_RUN = saved


def log_quant_times(times: dict, card: str) -> None:
    for (M, K, N), t in times.items():
        log(f"[time] [{M}, {K}] @ [{K}, {N}]: int8_matmul "
            f"{t['int8_matmul'] * 1e3:.2f} us (its int32 product "
            f"{t['int8_product'] * 1e3:.2f} us; with a row-major weight "
            f"{t['int8_product_row_major'] * 1e3:.2f} us), int4_matmul "
            f"{t['int4_matmul'] * 1e3:.2f} us, torch.matmul of the bf16 "
            f"weights {t['bf16_matmul'] * 1e3:.2f} us (informational); on "
            f"{card}")


# ---------------------------------------------------------------------------
# phase 16: serve the headline configuration with int8 weights
# ---------------------------------------------------------------------------

def slab_oracle(cfg, params, prompt, steps):
    """The port's greedy_decode (the slab decoder) for one request."""
    import torch

    from tpu_dra_torch.workloads.decode import greedy_decode
    return greedy_decode(cfg, params, torch.tensor([prompt], device="cuda"),
                         steps=steps)[0].tolist()


def slab_oracle_logits_at(cfg, params, prompt, tokens, step):
    """greedy_decode's logits at ``step`` when fed its own ``tokens``."""
    import torch

    from tpu_dra_torch.workloads.decode import (_token_logits, init_kv_cache,
                                                prefill)
    cache = init_kv_cache(cfg, 1, cfg.max_seq)
    cache, logits = prefill(cfg, params, cache,
                            torch.tensor([prompt], device="cuda"))
    for i in range(step):
        logits, cache = _token_logits(
            cfg, params, cache, len(prompt) + i,
            torch.tensor([tokens[i]], dtype=torch.int32, device="cuda"))
    return logits[0].float()


def quant_serve_phase(gen) -> dict:
    """The headline configuration (section_paged's model, int8 weights
    from the seed) served through serve() on the slab and on pages; every
    answer held to greedy_decode on the card; the paged run must launch
    the paged-attention kernel n_layers times a decode step, the slab run
    never; both must take the int8 product on every matmul."""
    import torch

    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    params = quantize_params_int8(init_params(cfg, gen))
    prompts = request_prompts(cfg.vocab)
    wants: dict[int, list] = {}

    def want(i):
        if i not in wants:
            wants[i] = slab_oracle(cfg, params, prompts[i], REQUESTS[i][1])
        return wants[i]

    runs = {}
    for layout, engine in (("slab", dict(slots=32, chunk=8,
                                         kv_layout="slab")),
                           ("paged", ENGINE)):
        label = f"serve int8 {layout}"
        run = serve_requests(label, cfg, params, engine, prompts)
        steps = run["decode_steps"]
        # 4 matmuls a layer and the head a step, plus the prefills
        if run["int8_calls"] < (4 * cfg.n_layers + 1) * steps:
            fail(f"{label}: {run['int8_calls']} int8 products over {steps} "
                 f"decode steps")
        paged_ok = (run["launches"] >= cfg.n_layers * steps
                    if layout == "paged" else run["launches"] == 0)
        if not paged_ok:
            fail(f"{label}: paged attention launched {run['launches']} "
                 f"times over {steps} decode steps")
        log(f"[{label}] {run['int8_calls']} int8 products and "
            f"{run['launches']} paged-attention launches over {steps} "
            f"decode steps")
        hold_answers(label, run["answers"], want,
                     lambda i, w, step: slab_oracle_logits_at(
                         cfg, params, prompts[i], w, step))
        runs[layout] = run
    with torch.no_grad():
        runs["profile"] = profile_decode_steps(cfg, params, gen)
    del params
    torch.cuda.empty_cache()
    return runs


def profile_decode_steps(cfg, params, gen) -> dict:
    """One decode step of each layout at the engine's 32 slots, every
    slot at 256 tokens of context, under torch.profiler (after two
    warm-up steps): device busy time and idle share (informational)."""
    import torch

    from tpu_dra_torch.workloads.decode import _token_logits, init_kv_cache
    from tpu_dra_torch.workloads.paged_kv import (_paged_step,
                                                  init_paged_cache)
    B, ctx, ps = ENGINE["slots"], 256, ENGINE["page_size"]
    token = torch.randint(0, cfg.vocab, (B,), generator=gen, device="cuda",
                          dtype=torch.int32)
    pos = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    slab = init_kv_cache(cfg, B, cfg.max_seq)
    per_slot = -(-(ctx + 1) // ps)
    pages = init_paged_cache(cfg, B * per_slot, ps, device="cuda")
    table = torch.full((B, cfg.max_seq // ps), -1, dtype=torch.int32,
                       device="cuda")
    table[:, :per_slot] = torch.arange(B * per_slot, dtype=torch.int32,
                                       device="cuda").reshape(B, per_slot)
    steps = {"slab": lambda: _token_logits(cfg, params, slab, pos, token),
             "paged": lambda: _paged_step(cfg, params, pages, token, pos,
                                          table)}
    out = {}
    for layout, step in steps.items():
        for _ in range(2):
            step()
        out[layout] = profile_call(
            f"{layout} decode step (int8 weights, {B} slots at {ctx} "
            f"tokens)", step)
    return out


# ---------------------------------------------------------------------------
# phase 17: speculative serving at full width
# ---------------------------------------------------------------------------

def spec_serve_phase(gen, card: str) -> dict:
    """The int8 serving model with a real draft (tpu_dra_torch.bench's
    section_spec_real settings: 2 layers distilled 150 steps at batch 16,
    seq 256 from the fp32 tree, then int8) served through serve() with
    --speculative-continuous's engine on the slab and on pages, beside
    the plain engine, 32 mixed-length requests at 16 slots, chunk 8.
    Every speculative answer held to the plain engine's of its layout by
    the near-tie rule; on pages the draft's steps must launch the paged
    attention kernel exactly draft layers x chunk times a pass, on the
    slab never; a sampled batch; the draft == target ceiling must accept
    every proposal; one pass of each layout under torch.profiler."""
    import numpy as np
    import torch

    from tpu_dra_torch.bench import LOAD, SPEC_DISTILL, SPEC_ENGINE, SPEC_PAGES
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.spec_draft import (_distill_loss,
                                                    make_draft,
                                                    truncate_draft)
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    fparams = init_params(cfg, gen)
    t0 = time.perf_counter()
    dcfg, dfloat = make_draft(cfg, fparams, **SPEC_DISTILL)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    held = torch.randint(0, cfg.vocab, (8, SPEC_DISTILL["seq"]),
                         generator=gen, device="cuda")
    with torch.no_grad():
        kl = [float(_distill_loss(dcfg, cfg, fparams, d, held))
              for d in (truncate_draft(cfg, fparams, dcfg.n_layers)[1],
                        dfloat)]
    log(f"[spec] draft: {dcfg.n_layers} of {cfg.n_layers} layers distilled "
        f"{SPEC_DISTILL['distill_steps']} steps at batch "
        f"{SPEC_DISTILL['batch']}, seq {SPEC_DISTILL['seq']} in "
        f"{distill_s:.1f} s; KL(target || draft) on a held-out batch "
        f"{kl[0]:.4f} truncated, {kl[1]:.4f} distilled (informational)")
    params = quantize_params_int8(fparams)
    dparams = quantize_params_int8(dfloat)
    del fparams, dfloat
    n = len(LOAD["lengths"])
    reqs = [(LOAD["lengths"][i % n], LOAD["steps"][i % n])
            for i in range(32)]
    rng = np.random.default_rng(SEED + 17)
    prompts = [rng.integers(0, cfg.vocab, ln).tolist() for ln, _ in reqs]
    chunk = SPEC_ENGINE["chunk"]
    logits_at = {"slab": slab_oracle_logits_at, "paged": oracle_logits_at}
    out: dict = {"distill_s": distill_s, "kl": kl}
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        engine = dict(kv_layout=layout, **SPEC_ENGINE, **kw)
        plain = serve_requests(f"spec {layout} plain", cfg, params, engine,
                               prompts, reqs)
        spec = serve_requests(
            f"spec {layout}", cfg, params,
            dict(engine, draft=(dcfg, dparams), speculative_engine=True),
            prompts, reqs, sampled=8)
        st = spec["stats"]
        passes = st["spec_target_passes"]
        want = dcfg.n_layers * chunk * passes if layout == "paged" else 0
        if spec["launches"] != want:
            fail(f"spec {layout}: paged attention launched "
                 f"{spec['launches']} times over {passes} speculative "
                 f"passes ({want} wanted)")
        log(f"[spec {layout}] {passes} target passes, accept rate "
            f"{st['spec_accept_rate']}, {st['spec_tokens_per_pass']} tokens "
            f"per slot-pass, paged attention launches {spec['launches']}; "
            f"{spec['tokens_per_s']:.1f} tokens/s against the plain "
            f"engine's {plain['tokens_per_s']:.1f} (informational); on "
            f"{card}")
        hold_answers(f"spec {layout}", spec["answers"],
                     lambda i, a=plain["answers"]: a[i],
                     lambda i, w, step, f=logits_at[layout]: f(
                         cfg, params, prompts[i], w, step), requests=reqs)
        out[layout] = {"plain": plain, "spec": spec}
    # the ceiling: draft == target accepts every proposal on the slab,
    # where the draft's step and the verify chunk round alike; on pages
    # the draft's step attends through the kernel (fp32 scores) and the
    # verify through the chunk path (bf16 scores), so near-ties reject
    # there (informational)
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        ceiling = serve_requests(
            f"spec ceiling {layout}", cfg, params,
            dict(kv_layout=layout, **SPEC_ENGINE, **kw, draft=(cfg, params),
                 speculative_engine=True), prompts[:8], reqs[:8])
        rate = ceiling["stats"]["spec_accept_rate"]
        log(f"[spec ceiling {layout}] draft == target: accept rate {rate}, "
            f"{ceiling['stats']['spec_tokens_per_pass']} tokens per "
            f"slot-pass, {ceiling['tokens_per_s']:.1f} tokens/s "
            f"(informational)")
        if layout == "slab" and rate != 1.0:
            fail(f"draft == target accepted {rate} of its proposals, not "
                 f"all")
        out[f"ceiling {layout}"] = ceiling
    with torch.no_grad():
        out["profile"] = profile_spec_pass(cfg, params, dcfg, dparams)
    # phase 18 serves the same models
    out["models"] = (cfg, params, dcfg, dparams)
    return out


def profile_spec_pass(cfg, params, dcfg, dparams) -> dict:
    """One speculative pass of each layout at 16 slots, every slot at 256
    tokens of context, under torch.profiler after two warm-up passes
    (informational)."""
    import torch

    from tpu_dra_torch.bench import SPEC_ENGINE, SPEC_PAGES
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    ctx = 256
    out = {}
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        eng = ContinuousEngine(cfg, params, draft=(dcfg, dparams),
                               kv_layout=layout, **SPEC_ENGINE, **kw)
        try:
            if eng.pool is not None:
                need = eng.pool.pages_for(ctx + 3 * eng.chunk)
                for slot in range(eng.slots):
                    eng._table[slot] = torch.from_numpy(eng.pool.table_row(
                        eng.pool.alloc(need), eng._mp)).to(eng.device)

            def one_pass():
                eng._pos.fill_(ctx)
                eng._done.fill_(False)
                eng._spec_chunk()
            for _ in range(2):
                one_pass()
            out[layout] = profile_call(
                f"speculative pass on the {layout} (int8 weights, "
                f"{eng.slots} slots at {ctx} tokens, chunk {eng.chunk})",
                one_pass)
        finally:
            eng.shutdown()
    return out


# ---------------------------------------------------------------------------
# phase 18: the front end at full width over a shared prefix
# ---------------------------------------------------------------------------

# the system prompt: 3 full 64-token pages and an 8-token tail
PREFIX_LEN = 200
# the admission bound of phase 18's servers: the 32 requests' cost (their
# suffixes and steps, 4480) fits under the one-tenant burst line
# (0.7 x 8192)
ADMISSION_MAX_COST = 8192
# the keys of the reference server's /debug/overload and /debug/slo
# (tpu_dra/workloads/serve.py :770-796, tpu_dra/workloads/slo.py :165-193)
OVERLOAD_KEYS = {"state", "role", "admission", "engine"}
OVERLOAD_ENGINE_KEYS = {"queued", "active", "slots", "batch_occupancy",
                        "kv_pages_free", "kv_pages_total", "expired_queued",
                        "expired_active", "goodput_slot_s", "badput_slot_s"}
SLO_OBJECTIVE_KEYS = {"target", "description", "lifetime", "windows"}
METRIC_LINE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')


def call(port: int, path: str, body=None, headers=None,
         timeout: float = 600) -> tuple:
    """(status, decoded body or text, headers) of a GET (``body`` None)
    or a JSON POST; HTTP errors are answers too."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, raw, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as exc:
        code, raw, hdrs = exc.code, exc.read(), exc.headers
    text = raw.decode()
    try:
        return code, json.loads(text), hdrs
    except ValueError:
        return code, text, hdrs


def prefix_load(cfg) -> tuple:
    """The system prompt and 32 requests of the bench's LOAD mix
    (suffixes of 16-128 tokens, 32-128 steps), random ids from the
    seed."""
    import numpy as np

    from tpu_dra_torch.bench import LOAD
    rng = np.random.default_rng(SEED + 18)
    n = len(LOAD["lengths"])
    reqs = [(LOAD["lengths"][i % n], LOAD["steps"][i % n])
            for i in range(32)]
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN).tolist()
    return prefix, reqs, [rng.integers(0, cfg.vocab, ln).tolist()
                          for ln, _ in reqs]


def ragged_oracle(cfg, params, prompts: list, steps: int,
                  layout: str) -> list:
    """The port's greedy decode of every full prompt in one ragged batch
    on the card, in the engine's layout: ``decode.decode_ragged`` for the
    slab, ``paged_kv.paged_greedy_decode`` over pages of its own for
    pages (the slab rounds its attention scores to bf16, the paged
    kernel keeps them in fp32, as in the reference)."""
    import numpy as np
    import torch

    from tpu_dra_torch.workloads.decode import decode_ragged
    from tpu_dra_torch.workloads.paged_kv import PagePool, paged_greedy_decode
    S = max(len(p) for p in prompts)
    batch = torch.tensor([p + [0] * (S - len(p)) for p in prompts],
                         device="cuda")
    lengths = torch.tensor([len(p) for p in prompts], device="cuda")
    with torch.no_grad():
        if layout == "slab":
            return decode_ragged(cfg, params, batch, lengths,
                                 steps=steps).tolist()
        ps = ENGINE["page_size"]
        pool = PagePool(len(prompts) * (cfg.max_seq // ps), ps)
        table = torch.from_numpy(np.stack([pool.table_row(
            pool.alloc(pool.pages_for(len(p) + steps)), cfg.max_seq // ps)
            for p in prompts])).to("cuda")
        return paged_greedy_decode(
            cfg, params, batch, table, steps=steps,
            total_pages=pool.total_pages, page_size=ps,
            lengths=lengths).tolist()


def serve_prefix_load(label: str, srv, pid: str, suffixes: list,
                      reqs: list, card: str) -> dict:
    """The 32 /generate requests naming ``pid``, one client thread each,
    after the counts are set to 0: answers, launches, engine stats."""
    from tpu_dra_torch.workloads.paged_kv import paged_attention
    port = srv.server_address[1]
    results: dict[int, object] = {}
    srv.engine.reset_stats()

    def client(i):
        try:
            code, body, _ = call(port, "/generate", {
                "tokens": [suffixes[i]], "steps": reqs[i][1],
                "prefix_id": pid})
            results[i] = body["tokens"][0] if code == 200 else (code, body)
        except Exception as exc:  # noqa: BLE001 — reported below
            results[i] = exc
    paged_attention.launches = 0
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    answers = []
    for i, (_, steps) in enumerate(reqs):
        toks = results.get(i)
        if not isinstance(toks, list) or len(toks) != steps:
            fail(f"{label}: request {i} gave {toks!r:.300}")
        answers.append(toks)
    stats = srv.engine.stats()
    n_tok = sum(len(a) for a in answers)
    log(f"[{label}] {len(reqs)} concurrent /generate requests naming the "
        f"{PREFIX_LEN}-token prefix: {n_tok} tokens in {wall:.3f} s, "
        f"{n_tok / wall:.1f} tokens/s, peak active slots "
        f"{stats['peak_active']}"
        + (f", peak pages in use {stats['kv_pages_peak_used']} of "
           f"{stats['kv_pages_total']} ({stats['kv_pages_own_at_peak']} "
           f"the joiners' own)" if "kv_pages_total" in stats else "")
        + f" (informational); on {card}")
    return {"answers": answers, "launches": launches, "stats": stats,
            "tokens_per_s": n_tok / wall}


def ttft_compare(eng, pid: str, prefix: list, suffixes: list,
                 reqs: list, card: str) -> None:
    """Informational: TTFT p50/p95 and tokens/s of the 32 requests with
    the prefix against the same requests sent as full prompts, through
    the engine of the paged server."""
    out = {}
    for how in ("prefix", "full prompts"):
        t0 = time.perf_counter()
        handles = [eng.submit_async(
            sfx if how == "prefix" else prefix + sfx, steps,
            prefix_id=pid if how == "prefix" else None)
            for sfx, (_, steps) in zip(suffixes, reqs)]
        for h in handles:
            if not h.done.wait(900) or h.error:
                fail(f"prefix TTFT ({how}): {h.error}")
        wall = time.perf_counter() - t0
        ttft = sorted(1e3 * (h.first_token_at - h.submitted)
                      for h in handles)
        n_tok = sum(len(h.tokens) for h in handles)
        out[how] = ttft
        log(f"[prefix] {how}: TTFT p50 {ttft[len(ttft) // 2]:.1f} ms, p95 "
            f"{ttft[int(0.95 * (len(ttft) - 1))]:.1f} ms, {n_tok / wall:.1f} "
            f"tokens/s, peak active slots {eng.stats()['peak_active']} "
            f"(informational); on {card}")
        eng.reset_stats()


def prefix_phase(models: tuple, card: str) -> dict:
    """The int8 headline model (phase 17's, with its distilled draft)
    behind serve() with admission on: a 200-token system prompt through
    /prefix, 32 concurrent /generate requests naming it on pages (32
    slots, chunk 8, 160 64-token pages: the 3 shared pages let all 32 in,
    where unshared pages fit 20) and on the slab, each answer held to the
    port's greedy decode of prefix + suffix in the engine's layout on the
    card by the near-tie rule; kernel #1 launched n_layers times a decode step; pages in use
    equal to the 3 shared pages and the joiners' own; the pool back to
    total - 3, then to total once the prefix is evicted; eight prefix
    requests through the speculative engine in both layouts held to the
    plain engine's answers; /stream, a stop, a deadline, admission
    sheds, /metrics, /debug/slo, /debug/overload and the drain."""
    import torch

    from tpu_dra_torch.bench import SPEC_ENGINE, SPEC_PAGES
    from tpu_dra_torch.resilience import failpoint
    from tpu_dra_torch.workloads.paged_kv import paged_attention
    from tpu_dra_torch.workloads.serve import serve
    cfg, params, dcfg, dparams = models
    prefix, reqs, suffixes = prefix_load(cfg)
    wants, logits_at = {}, {}
    for layout, at in (("slab", slab_oracle_logits_at),
                       ("paged", oracle_logits_at)):
        t0 = time.perf_counter()
        full = ragged_oracle(cfg, params, [prefix + s for s in suffixes],
                             max(st for _, st in reqs), layout)
        wants[layout] = [o[:st] for o, (_, st) in zip(full, reqs)]
        logits_at[layout] = lambda i, want, step, at=at: at(
            cfg, params, prefix + suffixes[i], want, step)
        log(f"[prefix] the {layout} oracle: the 32 full prompts "
            f"({PREFIX_LEN} + 16-128 tokens, 128 steps) in one ragged "
            f"batch in {time.perf_counter() - t0:.1f} s")
    out: dict = {}
    ps = ENGINE["page_size"]
    n_shared = PREFIX_LEN // ps
    for layout, engine in (("paged", ENGINE),
                           ("slab", dict(slots=32, chunk=8,
                                         kv_layout="slab"))):
        label = f"prefix {layout}"
        srv = serve(cfg, params, port=0,
                    admission_max_cost=ADMISSION_MAX_COST, **engine)
        try:
            port = srv.server_address[1]
            sent: dict[int, int] = {}
            sent_mu = threading.Lock()

            def generate(body, headers=None):
                code, got, hdrs = call(port, "/generate", body, headers)
                with sent_mu:
                    sent[code] = sent.get(code, 0) + 1
                return code, got, hdrs
            t_reg = time.perf_counter()
            code, reg, _ = call(port, "/prefix", {"tokens": prefix})
            torch.cuda.synchronize()
            reg_s = time.perf_counter() - t_reg
            if code != 200:
                fail(f"{label}: /prefix answered {code}: {reg}")
            pid = reg["prefix_id"]
            # first use of the join path, outside the counted run
            if generate({"tokens": [suffixes[0]], "steps": 2,
                         "prefix_id": pid})[0] != 200:
                fail(f"{label}: the first prefix request failed")
            run = serve_prefix_load(label, srv, pid, suffixes, reqs, card)
            st = run["stats"]
            sent[200] += len(reqs)
            if layout == "paged":
                steps = st["decode_steps"]
                if run["launches"] != cfg.n_layers * steps or steps == 0:
                    fail(f"{label}: paged attention launched "
                         f"{run['launches']} times over {steps} decode "
                         f"steps of {cfg.n_layers} layers")
                if st["kv_pages_peak_used"] != \
                        n_shared + st["kv_pages_own_at_peak"]:
                    fail(f"{label}: {st['kv_pages_peak_used']} pages in use "
                         f"at the peak, not the {n_shared} shared and the "
                         f"joiners' own {st['kv_pages_own_at_peak']}")
                if st["peak_active"] <= 20:
                    fail(f"{label}: only {st['peak_active']} slots active "
                         f"at once; unshared pages fit 20")
                if st["kv_pages_free"] != st["kv_pages_total"] - n_shared:
                    fail(f"{label}: {st['kv_pages_free']} pages free after "
                         f"the load, not total - {n_shared}")
                log(f"[{label}] kernel #1: {run['launches']} launches over "
                    f"{steps} decode steps ({cfg.n_layers} a step), over "
                    f"the {n_shared} shared prefix pages; the prefix's "
                    f"registration took {reg_s:.3f} s, so sharing it "
                    f"saves ~{(len(reqs) - 1) * reg_s:.2f} s of prefill "
                    f"over the 32 requests (informational); on {card}")
            hold_answers(label, run["answers"],
                         lambda i, w=wants[layout]: w[i], logits_at[layout],
                         requests=reqs)
            out[layout] = run
            if layout == "slab":
                continue
            front_end_checks(srv, port, pid, prefix, suffixes, reqs,
                             generate, sent, n_shared, card)
            ttft_compare(srv.engine, pid, prefix, suffixes, reqs, card)
            # evicted by eight newer prefixes (max_prefixes 8): back to
            # every page
            for k in range(8):
                call(port, "/prefix", {"tokens": [k + 1] * 16})
            st = srv.engine.stats()
            if st["kv_pages_free"] != st["kv_pages_total"]:
                fail(f"{label}: {st['kv_pages_free']} of "
                     f"{st['kv_pages_total']} pages free after the prefix "
                     f"was evicted")
            log(f"[{label}] after the load {st['kv_pages_total'] - n_shared}"
                f" pages free (the prefix's {n_shared} resident); after "
                f"its eviction all {st['kv_pages_free']}")
            drain_check(srv, port, prefix + suffixes[3])
        finally:
            failpoint.reset()
            srv.shutdown()
    # eight prefix requests through the speculative engine, both layouts
    paged_attention.launches = 0
    spec_launches = 0
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        label = f"prefix spec {layout}"
        srv = serve(cfg, params, port=0, kv_layout=layout, **SPEC_ENGINE,
                    **kw, draft=(dcfg, dparams), speculative_engine=True)
        try:
            port = srv.server_address[1]
            pid = call(port, "/prefix", {"tokens": prefix})[1]["prefix_id"]
            call(port, "/generate", {"tokens": [suffixes[0]], "steps": 2,
                                     "prefix_id": pid})
            run = serve_prefix_load(label, srv, pid, suffixes[:8], reqs[:8],
                                    card)
        finally:
            srv.shutdown()
        passes = run["stats"]["spec_target_passes"]
        want_launches = dcfg.n_layers * SPEC_ENGINE["chunk"] * passes \
            if layout == "paged" else 0
        if run["launches"] != want_launches:
            fail(f"{label}: paged attention launched {run['launches']} "
                 f"times over {passes} passes ({want_launches} wanted)")
        spec_launches += run["launches"]
        log(f"[{label}] accept rate {run['stats']['spec_accept_rate']}, "
            f"{passes} passes, paged attention launches {run['launches']} "
            f"(informational)")
        hold_answers(label, run["answers"],
                     lambda i, a=out[layout]["answers"]: a[i],
                     logits_at[layout], requests=reqs[:8])
    out["launches"] = out["paged"]["launches"] + spec_launches
    return out


def front_end_checks(srv, port: int, pid: str, prefix: list,
                     suffixes: list, reqs: list, generate, sent: dict,
                     n_shared: int, card: str) -> None:
    """/stream, a stop, a deadline under the slow-decode failpoint, the
    admission sheds, /metrics, /debug/slo and /debug/overload."""
    import http.client

    from tpu_dra_torch.resilience import failpoint
    # /stream: its ids equal its final tokens and a /generate's
    body = {"tokens": [suffixes[1]], "steps": reqs[1][1], "prefix_id": pid}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/stream", body=json.dumps(body).encode())
    resp = conn.getresponse()
    lines = [json.loads(ln) for ln in resp.read().decode().splitlines()
             if ln.strip()]
    conn.close()
    streamed = [ln["token"] for ln in lines if "token" in ln]
    _, gen, _ = generate(body)
    if resp.status != 200 or lines[-1] != {"done": True, "tokens": streamed} \
            or gen["tokens"] != [streamed]:
        fail(f"/stream gave {lines[-1]!r:.200} over {len(streamed)} lines "
             f"against /generate's {gen!r:.200}")
    log(f"[front end] /stream: {len(streamed)} token lines, equal to its "
        f"final tokens and to /generate of the same request")
    # a stop from a greedy answer: trimmed at its first occurrence
    ref = gen["tokens"][0]
    stop = ref[5:7]
    _, got, _ = generate(dict(body, stop=[stop]))
    cut = next(j for j in range(2, len(ref) + 1) if ref[j - 2:j] == stop)
    if got["tokens"] != [ref[:cut - 2]]:
        fail(f"stop {stop}: {got!r:.200} against {ref[:cut - 2]!r:.200}")
    log(f"[front end] stop {stop}: {len(ref)} tokens trimmed to "
        f"{cut - 2}")
    # a deadline under the slow-decode failpoint: 504, pages back, badput
    failpoint.activate("serve.engine.slow_decode=sleep(300)")
    try:
        code, dl, _ = generate(dict(body, steps=128),
                               {"X-Deadline-Ms": "200"})
    finally:
        failpoint.reset()
    if code != 504 or dl.get("reason") != "deadline_expired":
        fail(f"X-Deadline-Ms 200 answered {code}: {dl}")
    t_end = time.perf_counter() + 30
    while time.perf_counter() < t_end:
        st = srv.engine.stats()
        if st["active"] == 0:
            break
        time.sleep(0.05)
    if st["kv_pages_free"] != st["kv_pages_total"] - n_shared or \
            not st["badput_slot_s"]["deadline_expired"] > 0:
        fail(f"after the deadline: {st['kv_pages_free']} pages free, badput "
             f"{st['badput_slot_s']}")
    log(f"[front end] X-Deadline-Ms 200 under a 300 ms/pass failpoint: 504 "
        f"deadline_expired, pages back, badput "
        f"{st['badput_slot_s']['deadline_expired']} slot-s")
    # admission: one request over the bound, then a burst over it
    code, shed, hdrs = generate({"tokens": [[1] * 128] * 40, "steps": 128})
    if code != 503 or shed.get("reason") != "cost_too_large" or \
            int(hdrs.get("Retry-After", "0")) < 1:
        fail(f"an over-cost request answered {code} {shed}")
    failpoint.activate("serve.engine.slow_decode=sleep(300)")
    burst: list = []
    try:
        rows = [prefix[:190]] * 14            # cost 14 x 192 = 2688 each
        threads = [threading.Thread(target=lambda: burst.append(generate(
            {"tokens": rows, "steps": 2}))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        failpoint.reset()
    codes = sorted(c for c, _, _ in burst)
    sheds = [(b, h) for c, b, h in burst if c == 503]
    if not sheds or any(c not in (200, 503) for c in codes) or any(
            b.get("reason") not in ("queue_full", "tenant_quota")
            or int(h.get("Retry-After", "0")) < 1 for b, h in sheds):
        fail(f"a burst over the admission bound answered {codes}: "
             f"{[b for _, b, _ in burst]!r:.300}")
    log(f"[front end] over the admission bound: cost_too_large 503 with "
        f"Retry-After; a burst of 4 x 2688 against {ADMISSION_MAX_COST} "
        f"answered {codes}")
    # /metrics: every line parses; /generate counts by code as sent
    code, text, _ = call(port, "/metrics")
    bad = [ln for ln in text.splitlines()
           if ln and not ln.startswith("#") and not METRIC_LINE.match(ln)]
    counted: dict[int, float] = {}
    for ln in text.splitlines():
        m = re.match(r'tpu_serve_requests_total\{path="/generate",'
                     r'code="(\d+)",tenant="[^"]*"\} (\S+)$', ln)
        if m:
            counted[int(m.group(1))] = counted.get(int(m.group(1)), 0.0) + \
                float(m.group(2))
    if code != 200 or bad or counted != {c: float(n) for c, n in
                                         sent.items()}:
        fail(f"/metrics: {code}, unparsed {bad[:3]}, /generate by code "
             f"{counted} against sent {sent}")
    log(f"[front end] /metrics parses; /generate by code {counted} as sent")
    code, over, _ = call(port, "/debug/overload")
    code2, slo, _ = call(port, "/debug/slo")
    if set(over) != OVERLOAD_KEYS or \
            set(over["engine"]) != OVERLOAD_ENGINE_KEYS or \
            set(slo["objectives"]) != {"availability", "latency"} or any(
                set(o) != SLO_OBJECTIVE_KEYS
                for o in slo["objectives"].values()):
        fail(f"/debug/overload or /debug/slo keys: {sorted(over)}, "
             f"{sorted(slo)}")
    log(f"[front end] /debug/overload: {json.dumps(over)[:300]}")
    log(f"[front end] /debug/slo availability lifetime: "
        f"{slo['objectives']['availability']['lifetime']}")


def drain_check(srv, port: int, prompt: list) -> None:
    """drain(): an in-flight request finishes, a new one sheds 503."""
    result: dict = {}
    t = threading.Thread(target=lambda: result.update(r=call(
        port, "/generate", {"tokens": [prompt], "steps": 128})))
    t.start()
    t_end = time.perf_counter() + 60
    while time.perf_counter() < t_end and \
            srv.engine.stats()["active"] == 0:
        time.sleep(0.005)
    drained: dict = {}
    dt = threading.Thread(target=lambda: drained.update(ok=srv.drain(120)))
    dt.start()
    time.sleep(0.05)
    code, body, hdrs = call(port, "/generate", {"tokens": [[1, 2]],
                                                "steps": 2})
    health = call(port, "/healthz")[0]
    dt.join(300)
    t.join(300)
    r = result.get("r")
    if not drained.get("ok") or code != 503 or \
            body.get("reason") != "draining" or health != 503 or \
            r is None or r[0] != 200 or len(r[1]["tokens"][0]) != 128:
        fail(f"drain: ok {drained}, new request {code} {body}, /healthz "
             f"{health}, in-flight {r!r:.200}")
    log("[front end] drain(): the in-flight request finished with its 128 "
        "tokens, a new one answered 503 draining, /healthz 503")


# ---------------------------------------------------------------------------
# phase 19: checkpoints and exact resume, serving a checkpoint and a weights
# cache, LoRA, the MoE model
# ---------------------------------------------------------------------------

# 19a: the flagship through fit, saving every 3 steps; the resume runs the
# last 3 again from step 3
RESUME_RUN = dict(steps=6, every=3, batch=16)
# its depth: at the flagship's 8 layers its three saves of 6.5 GB took
# 43 s of the script's time limit (H100 80GB HBM3, 700 W)
RESUME_LAYERS = 2
# 19b: the headline serving model trained by the fit CLI, then served from
# its checkpoint by the server CLI; the auto-draft's distillation steps
SERVE_TRAIN = dict(steps=20, batch=8)
AUTO_DRAFT_STEPS = 20
# 19c: LoRA on 19b's checkpoint
LORA_RUN = dict(steps=10, rank=8, batch=8)
# 19d: the MoE model at the flagship's widths
MOE_MODEL = dict(TRAIN_MODEL, n_experts=8, capacity_factor=1.25)
MOE_RUN = dict(steps=5, batch=8)


def flash_counters() -> dict:
    from tpu_dra_torch.workloads import flash as F
    return {"flash_fwd": F.flash_attn_fwd, "flash_bwd_dq": F.flash_bwd_dq,
            "flash_bwd_dkdv": F.flash_bwd_dkdv}


def zero_counts(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters: dict) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def flash_want(calls: int) -> dict:
    """The flash launches of ``calls`` attention calls in training steps
    under the trunk's remat (``train.remat``, the reference's policy):
    the backward recomputes each call's forward, so the forward kernel
    runs twice a call and each backward kernel once."""
    return {"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
            "flash_bwd_dkdv": calls}


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def state_leaves(state: dict) -> list:
    """Parameters and both AdamW moment trees of a restored train state."""
    from tpu_dra_torch.workloads.train import tree_leaves
    opt = state["extra"]["opt_state"]
    return (tree_leaves(state["params"]) + tree_leaves(opt["mu"])
            + tree_leaves(opt["nu"]))


def timed_lines(lines: list, pattern: str) -> list:
    """The seconds of every ``fit`` log line matching ``pattern`` (a
    regular expression with one group, the seconds)."""
    return [float(m.group(1)) for ln in lines
            for m in [re.search(pattern, ln)] if m]


def resume_phase(tmp: Path, data_path: str, card: str) -> dict:
    """19a: fit runs the flagship's widths at RESUME_LAYERS layers 6 steps
    saving at 3 and 6; step 6's
    commit marker is removed (a preemption mid-save); fit(resume=True)
    for 3 steps must start at 3, sweep the unmarked step 6, and give
    losses 4-6 and step 6's parameters and moments bit-equal to the
    uninterrupted run's; each run launches the flash forward 2 x n_layers
    x steps times (the remat's recompute) and each backward kernel
    n_layers x steps times.  The whole of it runs under goodput accounting
    (TPU_GOODPUT_FILE in the environment given to ``start_from_env``),
    whose segments phase 20e holds to the times printed here."""
    import shutil

    import torch

    from tpu_dra_torch.workloads import goodput
    tracker = goodput.start_from_env(
        {goodput.STATE_ENV: str(tmp / "goodput.json")})
    wall0 = time.perf_counter()

    from tpu_dra_torch.workloads.checkpointing import (_COMMIT_MARKER,
                                                       latest_step,
                                                       restore_train_state)
    from tpu_dra_torch.workloads.fit import fit
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg = ModelConfig(**dict(TRAIN_MODEL, n_layers=RESUME_LAYERS))
    ck = tmp / "resume"
    steps, every, batch = (RESUME_RUN[k] for k in ("steps", "every",
                                                   "batch"))
    counters = flash_counters()
    lines: list[str] = []

    def record(line: str) -> None:
        lines.append(line)
        log(f"[resume]   {line}")

    def run(n: int, resume: bool) -> tuple:
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(counters)
        res = fit(cfg, data_path, steps=n, batch=batch, attn_impl="flash",
                  log_every=1, checkpoint_dir=str(ck),
                  checkpoint_every=every, resume=resume, log_fn=record)
        launches = read_counts(counters)
        want = flash_want(cfg.n_layers * n)
        if launches != want:
            fail(f"resume: flash launches {launches} over {n} steps, "
                 f"expected {want}")
        return res, launches

    log(f"[resume] disk free under {tmp}: "
        f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")
    full, first = run(steps, False)
    if latest_step(str(ck)) != steps or sorted(
            p.name for p in ck.iterdir()) != [str(every), str(steps)]:
        fail(f"resume: checkpoints {sorted(p.name for p in ck.iterdir())}")
    nbytes = dir_bytes(ck / str(steps))
    t0 = time.perf_counter()
    want = restore_train_state(str(ck), device="cpu")
    restore_host_s = time.perf_counter() - t0
    (ck / str(steps) / _COMMIT_MARKER).unlink()
    if latest_step(str(ck)) != every:
        fail(f"resume: latest_step {latest_step(str(ck))} with step "
             f"{steps} unmarked")
    first_lines = len(lines)
    res, second = run(steps - every, True)
    head = lines[first_lines:first_lines + 1]
    if not head or not head[0].startswith(f"resumed from step {every}"):
        fail(f"resume: the resumed run logged {head}")
    if latest_step(str(ck)) != steps:
        fail("resume: the resumed run's save did not replace the swept step")
    if res.losses != full.losses[every:]:
        fail(f"resume: losses {res.losses} vs the uninterrupted run's "
             f"{full.losses[every:]}")
    t0 = time.perf_counter()
    got = restore_train_state(str(ck), device="cpu")
    check_restore_s = time.perf_counter() - t0
    if int(got["extra"]["opt_state"]["count"]) != steps:
        fail(f"resume: optimizer count {got['extra']['opt_state']['count']}")
    bad = sum(not torch.equal(a, b)
              for a, b in zip(state_leaves(want), state_leaves(got)))
    n_leaves = len(state_leaves(want))
    if bad:
        fail(f"resume: {bad} of {n_leaves} parameter and moment leaves "
             f"differ from the uninterrupted run's")
    saves = timed_lines(lines, r"saved in ([\d.]+) s")
    restores = timed_lines(lines, r"restored in ([\d.]+) s")
    log(f"[resume] flagship ({cfg.n_layers} layers, batch {batch}): losses "
        f"of steps {every + 1}-{steps} {res.losses} bit-equal to the "
        f"uninterrupted run's, all {n_leaves} parameter and moment leaves "
        f"of step {steps} bit-equal; flash launches {first} then {second}; "
        f"a step on disk {nbytes} bytes; save {saves} s, restore to the "
        f"card {restores} s, restore to the host {restore_host_s:.2f} s; "
        f"on {card}")
    del want, got
    tracker.stop()
    wall = time.perf_counter() - wall0
    goodput_report(tracker, wall, saves,
                   sum(restores) + restore_host_s + check_restore_s, card)
    # its state file goes with the temporary directory: nothing more is
    # written to it (the tracker's exit hook included)
    tracker.state_path = None
    shutil.rmtree(ck)
    return {"launches": {k: first[k] + second[k] for k in first},
            "bytes": nbytes, "save_s": saves, "restore_s": restores,
            "restore_host_s": restore_host_s}


def model_flags(cfg) -> list:
    return ["--vocab", str(cfg.vocab), "--d-model", str(cfg.d_model),
            "--n-heads", str(cfg.n_heads), "--n-kv-heads",
            str(cfg.n_kv_heads), "--n-layers", str(cfg.n_layers),
            "--d-ff", str(cfg.d_ff), "--max-seq", str(cfg.max_seq),
            "--pos-emb", cfg.pos_emb]


def fit_cli_start(cfg, data_path: str, ck: Path) -> dict:
    """Start the fit command line in its own process: the serving model,
    flash attention, a checkpoint at the last step; its output goes to
    files beside ``ck``."""
    cmd = [sys.executable, "-m", "tpu_dra_torch.workloads.fit", "--data",
           data_path, "--steps", str(SERVE_TRAIN["steps"]), "--batch",
           str(SERVE_TRAIN["batch"]), "--attn-impl", "flash",
           "--checkpoint-dir", str(ck), "--checkpoint-every",
           str(SERVE_TRAIN["steps"]), *model_flags(cfg)]
    out, err = ck.parent / "fit-cli.out", ck.parent / "fit-cli.err"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=fo, stderr=fe,
                                text=True)
    return {"proc": proc, "out": out, "err": err, "t0": time.perf_counter()}


def fit_cli_finish(run: dict) -> None:
    """Wait for the fit command line: exit 0 and falling losses."""
    proc = run["proc"]
    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    stdout = run["out"].read_text()
    for ln in stdout.splitlines():
        log(f"[ckpt-serve]   fit: {ln}")
    if proc.returncode != 0:
        fail(f"the fit command line exited {proc.returncode}: "
             f"{run['err'].read_text()[-2000:]}")
    losses = [float(x) for x in re.findall(r"step \d+: loss ([\d.]+)",
                                           stdout)]
    if len(losses) < 2 or not losses[-1] < losses[0]:
        fail(f"the fit command line's losses {losses}")
    log(f"[ckpt-serve] the fit command line trained {SERVE_TRAIN['steps']} "
        f"steps at batch {SERVE_TRAIN['batch']} (losses {losses}) and saved "
        f"step {SERVE_TRAIN['steps']} in {time.perf_counter() - run['t0']:.1f}"
        f" s (process included; it ran beside 19a)")


def serve_cli(label: str, cfg, flags: list, prompts: list) -> dict:
    """The server command line in its own process on the card (paged, 32
    slots, chunk 8, 160 64-token pages), the requests of REQUESTS sent one
    after another (so that two starts see the same batches, and can be
    held to each other bit for bit); the paged-attention launches and
    decode steps from /stats around them; SIGTERM must drain and exit 0.
    Returns the answers, the lines printed before the ready line, and the
    stats' deltas."""
    cmd = [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
           "--continuous", "--kv-layout", "paged", "--port", "0", "--host",
           "127.0.0.1", "--slots", str(ENGINE["slots"]), "--chunk",
           str(ENGINE["chunk"]), "--page-size", str(ENGINE["page_size"]),
           "--total-pages", str(ENGINE["total_pages"]), *model_flags(cfg),
           *flags]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    try:
        while not lines or "serving on" not in lines[-1]:
            line = proc.stdout.readline()
            if not line:
                fail(f"{label}: the server exited before serving: "
                     f"{''.join(lines)[-3000:]}")
            lines.append(line.rstrip("\n"))
        start_s = time.perf_counter() - t0
        port = int(re.search(r", (\d+)\)", lines[-1]).group(1))
        post(port, {"tokens": [[1, 2, 3]], "steps": 2})   # first-use costs
        before = call(port, "/stats")[1]
        answers = []
        t1 = time.perf_counter()
        for prompt, (_, steps) in zip(prompts, REQUESTS):
            answers.append(post(port, {"tokens": [prompt],
                                       "steps": steps})["tokens"][0])
        wall = time.perf_counter() - t1
        after = call(port, "/stats")[1]
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    if proc.returncode != 0:
        fail(f"{label}: the server exited {proc.returncode} after SIGTERM: "
             f"{rest[-2000:]}")
    for ln in lines[:-1]:
        log(f"[{label}]   {ln}")
    delta = {k: after[k] - before[k] for k in ("decode_steps",
                                               "paged_attention_launches")}
    if "spec_target_passes" in after:
        delta["spec_target_passes"] = (after["spec_target_passes"]
                                       - before.get("spec_target_passes", 0))
    n_tok = sum(len(a) for a in answers)
    log(f"[{label}] ready {start_s:.1f} s after the start; {len(answers)} "
        f"requests one after another, {n_tok} tokens in {wall:.2f} s; "
        f"/stats deltas {delta}")
    return {"answers": answers, "lines": lines[:-1], "delta": delta}


def serve_cli_refused(label: str, cfg, flags: list, want: str) -> None:
    """The server command line must exit non-zero, printing ``want``."""
    cmd = [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
           "--continuous", "--kv-layout", "paged", "--port", "0",
           *model_flags(cfg), *flags]
    out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    if out.returncode == 0 or want not in out.stderr:
        fail(f"{label}: exit {out.returncode}, stderr "
             f"{out.stderr[-1000:]!r} (wanted {want!r})")
    log(f"[{label}] refused (exit {out.returncode}): "
        f"{out.stderr.strip().splitlines()[-1]}")


def draft_report(label: str, lines: list) -> dict:
    line = next((ln for ln in lines if ln.startswith("auto-draft: ")), None)
    if line is None:
        fail(f"{label}: no auto-draft line in {lines}")
    return json.loads(line[len("auto-draft: "):])


def checkpoint_serve_phase(tmp: Path, fit_run: dict, card: str) -> dict:
    """19b: the fit command line (``fit_run``, started before 19a) trains
    the headline serving model and saves it; the server command line serves that checkpoint as int8
    through a weights cache (a miss: quantized, saved), then from the
    cache alone (a hit: restored, no quantization) with bit-identical
    answers; int4 against the int8 cache is refused; an auto-draft
    distilled into a draft cache, then restored from it; every answer
    held to paged_greedy_decode of the restored-then-quantized tree, and
    kernel #1 launched exactly n_layers times a decode step (draft
    layers x chunk a speculative pass)."""
    import torch

    from tpu_dra_torch.workloads.checkpointing import (restore_train_state,
                                                       serving_meta)
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg = ModelConfig(**MODEL)
    ck, wc, dc = tmp / "serve-ck", tmp / "weights-cache", tmp / "draft-cache"
    fit_cli_finish(fit_run)
    prompts = request_prompts(cfg.vocab)
    # the first server start runs while this process takes the oracle
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        miss_f = pool.submit(serve_cli, "ckpt-serve miss", cfg, [
            "--checkpoint-dir", str(ck), "--weights", "int8",
            "--weights-cache", str(wc)], prompts)
        params = quantize_params_int8(restore_train_state(str(ck))["params"])
        rows = ragged_oracle(cfg, params, prompts,
                             max(s for _, s in REQUESTS), "paged")
        miss = miss_f.result()

    def hold_run(label: str, run: dict, spec_layers: int = 0) -> int:
        d = run["delta"]
        want = (spec_layers * ENGINE["chunk"] * d["spec_target_passes"]
                if spec_layers else cfg.n_layers * d["decode_steps"])
        if d["paged_attention_launches"] != want or want == 0:
            fail(f"{label}: kernel #1 launched "
                 f"{d['paged_attention_launches']} times, {want} wanted "
                 f"({d})")
        hold_answers(label, run["answers"],
                     lambda i: rows[i][:REQUESTS[i][1]],
                     lambda i, w, step: oracle_logits_at(
                         cfg, params, prompts[i], w, step),
                     requests=REQUESTS)
        return d["paged_attention_launches"]

    launches = 0
    if not any("int8 from --checkpoint-dir" in ln for ln in miss["lines"]) \
            or not any("cached in" in ln for ln in miss["lines"]):
        fail(f"ckpt-serve miss: {miss['lines']}")
    if (serving_meta(str(wc)) or {}).get("form") != "int8":
        fail(f"ckpt-serve: the cache's meta {serving_meta(str(wc))}")
    launches += hold_run("ckpt-serve miss", miss)
    spec_flags = ["--checkpoint-dir", str(ck), "--weights", "int8",
                  "--speculative-continuous", "--auto-draft",
                  "--auto-draft-cache", str(dc), "--auto-draft-steps",
                  str(AUTO_DRAFT_STEPS)]
    # the cache hit, the int4 refusal and the first auto-draft start read
    # only what the miss and the fit command line wrote: they run at once
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        hit_f = pool.submit(serve_cli, "ckpt-serve hit", cfg,
                            ["--weights-cache", str(wc)], prompts)
        int4_f = pool.submit(
            serve_cli_refused, "ckpt-serve int4", cfg,
            ["--weights-cache", str(wc), "--weights", "int4"],
            "holds form='int8' but --weights 'int4' was requested")
        drafted_f = pool.submit(serve_cli, "auto-draft miss", cfg,
                                spec_flags, prompts)
        hit, drafted = hit_f.result(), drafted_f.result()
        int4_f.result()
    if not any("restored from the cache" in ln for ln in hit["lines"]) or \
            any("from --checkpoint-dir" in ln for ln in hit["lines"]):
        fail(f"ckpt-serve hit: quantized again or not restored: "
             f"{hit['lines']}")
    if hit["answers"] != miss["answers"]:
        fail("ckpt-serve: the cache hit's answers differ from the miss's")
    launches += hold_run("ckpt-serve hit", hit)
    log(f"[ckpt-serve] the cache hit's {sum(map(len, hit['answers']))} "
        f"tokens are bit-identical to the miss's")
    d1 = draft_report("auto-draft miss", drafted["lines"])
    cached = serve_cli("auto-draft hit", cfg, spec_flags, prompts)
    d2 = draft_report("auto-draft hit", cached["lines"])
    if d1["source"] != "distilled" or not d2["source"].startswith("cache") \
            or d2["distill_s"] != 0.0 or d1["layers"] != d2["layers"]:
        fail(f"auto-draft: {d1} then {d2}")
    if cached["answers"] != drafted["answers"]:
        fail("auto-draft: the cached draft's answers differ from the "
             "distilled one's")
    for label, run in (("auto-draft miss", drafted),
                       ("auto-draft hit", cached)):
        launches += hold_run(label, run, spec_layers=d1["layers"])
    log(f"[ckpt-serve] auto-draft: distilled {AUTO_DRAFT_STEPS} steps in "
        f"{d1['distill_s']:.1f} s on the first start, restored from the "
        f"cache on the second ({d2['distill_s']} s), answers equal; on "
        f"{card}")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "checkpoint": ck, "prompts": prompts}


def lora_phase(ck: Path, data_path: str, prompts: list, card: str) -> dict:
    """19c: LoRA at r = 8 on 19b's checkpoint with flash (the GQA forward
    #4, #6, #7), 10 steps: losses finite and falling, the base bit-equal
    after; the wrapped forward's logits against the merged tree's within
    argmax_tol; the merged tree quantized to int8 and served through
    serve() on pages, answers held to paged_greedy_decode of it."""
    import numpy as np
    import torch

    from tpu_dra_torch.workloads.checkpointing import restore_train_state
    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.lora import (LoRAConfig, init_lora,
                                              make_lora_train_step,
                                              merge_lora, wrap_lora)
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import (ModelConfig, forward,
                                               tree_leaves)
    cfg = ModelConfig(**MODEL)
    base = restore_train_state(str(ck))["params"]
    before = [t.clone() for t in tree_leaves(base)]
    step, init_opt, lcfg, _ = make_lora_train_step(
        cfg, lcfg=LoRAConfig(rank=LORA_RUN["rank"]), attn_impl="flash")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    lora = init_lora(base, lcfg, gen)
    opt = init_opt(lora)
    it = batches(TokenDataset(data_path), batch=LORA_RUN["batch"],
                 seq=cfg.max_seq)
    counters = flash_counters()
    zero_counts(counters)
    losses, t0 = [], time.perf_counter()
    for _ in range(LORA_RUN["steps"]):
        toks = torch.from_numpy(next(it)).to("cuda")
        lora, opt, loss = step(base, lora, opt, toks)
        losses.append(float(loss))
    step_s = (time.perf_counter() - t0) / LORA_RUN["steps"]
    launches = read_counts(counters)
    want = flash_want(cfg.n_layers * LORA_RUN["steps"])
    if launches != want:
        fail(f"lora: flash launches {launches}, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"lora: losses {losses}")
    if not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(base))):
        fail("lora: the frozen base changed")
    n_adapter = sum(t.numel() for t in tree_leaves(lora))
    log(f"[lora] r = {lcfg.rank}, {n_adapter / 1e6:.2f} M adapter "
        f"parameters, {LORA_RUN['steps']} steps at batch {LORA_RUN['batch']}: "
        f"losses {losses}; {1e3 * step_s:.1f} ms a step (first included); "
        f"the base bit-equal; flash launches {launches}; on {card}")
    merged = merge_lora(base, lora, lcfg)
    probe = torch.tensor([prompts[-1]], device="cuda")
    with torch.no_grad():
        wrapped_lg = forward(cfg, wrap_lora(base, lora, lcfg), probe)[0]
        merged_lg = forward(cfg, merged, probe)[0]
    top = merged_lg.max(-1).values
    tol = torch.clamp(2 ** -6 * top.abs(), min=2 ** -4) * 2
    worst = float(((wrapped_lg - merged_lg).abs().max(-1).values
                   / tol).max())
    log(f"[lora] wrapped vs merged logits over {probe.shape[1]} positions: "
        f"worst row max |d| at {worst:.3f} of argmax_tol")
    if worst > 1:
        fail(f"lora: wrapped and merged logits part by {worst:.3f} x "
             f"argmax_tol")
    del base, before, lora, opt
    served = quantize_params_int8(merged)
    del merged
    run = serve_requests("lora serve", cfg, served, ENGINE, prompts,
                         requests=REQUESTS)
    steps = run["decode_steps"]
    if run["launches"] != cfg.n_layers * steps or steps == 0:
        fail(f"lora serve: kernel #1 launched {run['launches']} times over "
             f"{steps} decode steps")
    rows = ragged_oracle(cfg, served, prompts, max(s for _, s in REQUESTS),
                         "paged")
    hold_answers("lora serve", run["answers"],
                 lambda i: rows[i][:REQUESTS[i][1]],
                 lambda i, w, s: oracle_logits_at(cfg, served, prompts[i],
                                                  w, s), requests=REQUESTS)
    del served
    torch.cuda.empty_cache()
    return {"launches": launches, "paged_launches": run["launches"]}


def moe_phase(data_path: str, card: str) -> dict:
    """19d: the MoE model at the flagship's widths (8 experts, capacity
    factor 1.25), top-1 and top-2: one step with flash against the same
    step with dense attention within STEP_LOSS_ATOL and STEP_LEAF_REL,
    the flash pass's expert choices replayed in the dense pass
    (moe.PinnedChoices: unpinned, near-tie tokens may take other experts;
    that gap is printed for information), then fit for 5 steps at batch 8 with finite, falling losses and the
    flash forward launched 2 x n_layers a step (each block's forward runs
    again in its backward), the backward kernels n_layers a step; peak
    memory and step time for information."""
    import math

    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.fit import fit
    from tpu_dra_torch.workloads.moe import (MoEConfig, PinnedChoices,
                                             init_moe_params, moe_loss_fn)
    from tpu_dra_torch.workloads.train import tree_leaves, value_and_grad
    out = {}
    counters = flash_counters()
    for top_k in (1, 2):
        cfg = MoEConfig(**MOE_MODEL, router_top_k=top_k)
        label = f"MoE top-{top_k}"
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 20 + top_k)
        params = init_moe_params(cfg, gen)
        n_params = sum(t.numel() for t in tree_leaves(params))
        toks = torch.from_numpy(next(batches(
            TokenDataset(data_path), batch=MOE_RUN["batch"],
            seq=cfg.max_seq))).to("cuda")
        def grads(attn_impl: str) -> tuple:
            return value_and_grad(
                lambda p, t: moe_loss_fn(cfg, p, t, attn_impl), params,
                toks)
        with PinnedChoices() as pin:
            loss_f, g_f = grads("flash")
            pin.replay()
            loss_d, g_d = grads("dense")
        if pin.replayed != len(pin.recorded):
            fail(f"{label}: the dense pass called the router "
                 f"{pin.replayed} times, the flash pass "
                 f"{len(pin.recorded)}")
        hold_step(label, "flash kernels vs plain dense attention, the "
                  "flash pass's routing replayed", loss_f, g_f, loss_d, g_d)
        del g_d
        with PinnedChoices() as own:
            loss_u, g_u = grads("dense")
        errs = leaf_errors(g_f, g_u)
        L = cfg.n_layers
        moved = sum(int((a != b).any(-1).sum())
                    for a, b in zip(pin.recorded[:L], own.recorded[:L]))
        log(f"[moe] {label}: the same steps unpinned (the dense pass "
            f"routing by its own scores): {moved} of "
            f"{L * toks[:, :-1].numel()} "
            f"token-layer routes differ, loss |d| "
            f"{abs(float(loss_f) - float(loss_u)):.2e}, gradient leaves "
            f"relative L2 median {statistics.median(errs.values()):.3e}, "
            f"worst {max(errs.values()):.3e} (informational)")
        del params, g_f, g_u
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        stamps: list[float] = []
        t0 = time.perf_counter()
        res = fit(cfg, data_path, steps=MOE_RUN["steps"],
                  batch=MOE_RUN["batch"], attn_impl="flash", log_every=1,
                  log_fn=lambda ln: (stamps.append(time.perf_counter()),
                                     log(f"[moe]   {label} {ln}")))
        launches = read_counts(counters)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = cfg.n_layers * MOE_RUN["steps"]
        if launches != {"flash_fwd": 2 * want, "flash_bwd_dq": want,
                        "flash_bwd_dkdv": want}:
            fail(f"{label}: flash launches {launches}; wanted the forward "
                 f"{2 * want} (remat) and each backward {want}")
        if not all(math.isfinite(x) for x in res.losses) or \
                not res.losses[-1] < res.losses[0]:
            fail(f"{label}: losses {res.losses}")
        times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
        step_s = statistics.median(times[1:])
        tok_step = MOE_RUN["batch"] * cfg.max_seq
        log(f"[moe] {label}: {n_params / 1e9:.3f} B params, capacity "
            f"{cfg.capacity(tok_step)} slots an expert, losses "
            f"{res.losses}; step {1e3 * step_s:.1f} ms (median of steps "
            f"2-{MOE_RUN['steps']}; first {1e3 * times[0]:.1f} ms), "
            f"{tok_step / step_s:.0f} tokens/s; peak memory {peak_gb:.1f} "
            f"GB; flash launches {launches} (informational but the counts); "
            f"on {card}")
        out[top_k] = {"launches": launches, "step_ms": 1e3 * step_s,
                      "peak_gb": peak_gb, "losses": res.losses}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lifecycle_phase(card: str, beside=None) -> dict:
    """Phase 19 (a-d) in a temporary directory of its own, on the phase-8
    corpus written again there; ``beside()`` (phase 31) runs in a thread
    while 19b's command lines run, its result under ``"beside"``."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke-19-") as tmp:
        tmp = Path(tmp)
        data_path = write_tokens(tmp / "tokens.bin", TRAIN_MODEL["vocab"])
        from tpu_dra_torch.workloads.train import ModelConfig
        # 19b's fit command line trains while 19a runs
        fit_run = fit_cli_start(ModelConfig(**MODEL), data_path,
                                tmp / "serve-ck")
        t0 = time.perf_counter()
        try:
            resumed = resume_phase(tmp, data_path, card)
        except BaseException:
            fit_run["proc"].kill()
            fit_run["proc"].wait(30)
            raise
        log(f"[time] phase 19a {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            aside = pool.submit(beside) if beside else None
            served = checkpoint_serve_phase(tmp, fit_run, card)
            log(f"[time] phase 19b {time.perf_counter() - t0:.1f} s")
            aside = aside.result() if aside else None
        t0 = time.perf_counter()
        lora = lora_phase(served["checkpoint"], data_path, served["prompts"],
                          card)
        log(f"[time] phase 19c {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        moe = moe_phase(data_path, card)
        log(f"[time] phase 19d {time.perf_counter() - t0:.1f} s")
    moe_launches = {k: moe[1]["launches"][k] + moe[2]["launches"][k]
                    for k in moe[1]["launches"]}
    return {"resume": resumed, "moe": moe, "lora": lora, "beside": aside,
            "paged_launches": served["launches"] + lora["paged_launches"],
            "flash_launches": {k: resumed["launches"][k] + moe_launches[k]
                               for k in moe_launches},
            "lora_launches": lora["launches"]}



# ---------------------------------------------------------------------------
# phase 20: the bucketed pool (/generate without --continuous, /beam,
# /speculative), spans, exemplars and a device trace; 19a's goodput
# ---------------------------------------------------------------------------

POOL_STEPS = 32               # 20a's /generate, beside 8 slab oracles
BEAM_RUN = dict(rows=4, length=32, beams=4, steps=32)
SPEC_K = 4
# a beam score against the teacher-forced sum of its tokens'
# log-probabilities: equal to 4 decimals on the CPU at three sizes
# (tests/test_torch_beam.py), where the cached steps and the full forward
# take the same arithmetic; on the card they take other GEMM shapes, so
# each token's log-probability may move by the bf16 rounding of its
# logits: held to 2^-5 a token
BEAM_FORCED_TOL_PER_TOKEN = 2 ** -5
TRACE_REQUESTS = 8
# the load under the capture: waves of TRACE_REQUESTS requests of
# TRACE_STEPS steps at once, each wave TRACE_GAP_S after the last one
# ended, until the capture has answered (at most TRACE_LOAD_S).  The first
# profiler session of a server whose engine replays its captured chunk
# started only once the card idled: under requests sent back to back its
# capture hung in 2 of 4 server processes, and with a load that ended it
# began after the load (2 kernel events in 3 of 3; H100 80GB HBM3,
# 700 W); the server now starts and stops its profiler with the engine
# held between passes (ContinuousEngine.paused), and 6 of 6 captures held
# kernel #1.  A wave keeps the card busy about half of each second, so a
# 1 s window holds decode steps wherever it starts
TRACE_STEPS = 128
TRACE_GAP_S = 0.5
TRACE_LOAD_S = 240.0
TRACE_SECONDS = 1.0
PAGED_KERNEL = ("paged_span_kernel", "paged_combine_kernel")


def padded_batch(rows: list):
    """The pool's ``/generate`` batch: rows right-padded with 0 to the
    prompt bucket, a batch of the batch bucket (dummy rows of length 1)."""
    import torch

    from tpu_dra_torch.workloads.serve import _bucket
    B, S = _bucket(len(rows)), _bucket(max(len(r) for r in rows))
    prompts = torch.zeros((B, S), dtype=torch.int32)
    for i, r in enumerate(rows):
        prompts[i, :len(r)] = torch.tensor(r)
    lengths = [len(r) for r in rows] + [1] * (B - len(rows))
    return prompts.cuda(), lengths


def departures(label: str, cfg, params, rows: list, answers: list,
               want: list) -> int:
    """Rows of ``answers`` against ``want`` (the slab decoder's greedy
    tokens of each row) under the near-tie rule; fails past it, returns
    the count of rows that part at a near-tie."""
    n = 0
    for i, (got, w) in enumerate(zip(answers, want)):
        diff = next((j for j, (a, b) in enumerate(zip(got, w)) if a != b),
                    None)
        if diff is None:
            continue
        lg = slab_oracle_logits_at(cfg, params, rows[i], w, diff)
        top2 = lg.topk(2).values.tolist()
        margin, tol = top2[0] - top2[1], argmax_tol(top2[0])
        log(f"[{label}] row {i} parts from the slab decoder at step {diff}: "
            f"margin {margin:.4f} (tolerance {tol:.4f})")
        if margin > tol:
            fail(f"{label}: row {i} parts at step {diff} where the margin "
                 f"{margin:.4f} > {tol:.4f}")
        n += 1
    log(f"[{label}] {n} of {len(rows)} rows part from the slab decoder at a "
        f"near-tie, the rest equal it")
    return n


def pool_generate_check(port: int, cfg, params, card: str) -> None:
    """20a: phase 4's 8 prompts (16-128 tokens) as one /generate of 64
    steps on the pool: bit-equal to ``decode`` of the same padded batch
    [8, 128], and each row to the slab decoder under the near-tie rule."""
    import torch

    from tpu_dra_torch.workloads.decode import decode
    prompts = request_prompts(cfg.vocab)
    t0 = time.perf_counter()
    code, out, _ = call(port, "/generate", {"tokens": prompts,
                                            "steps": POOL_STEPS})
    secs = time.perf_counter() - t0
    if code != 200:
        fail(f"pool /generate answered {code}: {out!r:.300}")
    padded, lengths = padded_batch(prompts)
    with torch.no_grad():
        want = decode(cfg, params, padded, steps=POOL_STEPS,
                      lengths=lengths)[:len(prompts)].tolist()
    if out["tokens"] != want:
        bad = sum(a != b for a, b in zip(out["tokens"], want))
        fail(f"pool /generate: {bad} of {len(want)} rows differ from decode "
             f"of the same padded batch")
    n_tok = len(prompts) * POOL_STEPS
    log(f"[pool] /generate of {len(prompts)} rows (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, batch "
        f"bucket {padded.shape[0]}, prompt bucket {padded.shape[1]}), "
        f"{POOL_STEPS} steps: bit-equal to decode of the padded batch; "
        f"{n_tok} tokens in {secs:.3f} s, {n_tok / secs:.1f} tokens/s "
        f"(informational); on {card}")
    with torch.no_grad():
        slab = [slab_oracle(cfg, params, p, POOL_STEPS) for p in prompts]
        departures("pool /generate vs slab", cfg, params, prompts,
                   out["tokens"], slab)


def pool_beam_check(port: int, cfg, params, rows: list, card: str) -> list:
    """20b: /beam of 4 rows of 32 tokens, W = 4, 32 steps: bit-equal to
    ``beam_decode`` called directly; W = 1 equal to ``greedy_decode``
    (a departure only at a near-tie); scores sorted; the best
    hypothesis' score equal to the teacher-forced sum of its tokens'
    log-probabilities within BEAM_FORCED_TOL_PER_TOKEN a token.  Returns
    the greedy tokens of the rows."""
    import torch

    from tpu_dra_torch.workloads.decode import beam_decode, greedy_decode
    from tpu_dra_torch.workloads.train import forward
    W, steps = BEAM_RUN["beams"], BEAM_RUN["steps"]
    t0 = time.perf_counter()
    code, out, _ = call(port, "/beam", {"tokens": rows, "steps": steps,
                                        "beams": W})
    secs = time.perf_counter() - t0
    if code != 200:
        fail(f"/beam answered {code}: {out!r:.300}")
    prompt = torch.tensor(rows, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        hist, scores = beam_decode(cfg, params, prompt, steps=steps, beams=W)
        greedy = greedy_decode(cfg, params, prompt, steps=steps).tolist()
    if out["tokens"] != hist.tolist() or out["scores"] != scores.tolist():
        fail("/beam differs from beam_decode of the same rows")
    for b, sc in enumerate(out["scores"]):
        if any(x < y for x, y in zip(sc, sc[1:])):
            fail(f"/beam row {b}: scores not sorted: {sc}")
    code, one, _ = call(port, "/beam", {"tokens": rows, "steps": steps,
                                        "beams": 1})
    if code != 200:
        fail(f"/beam W = 1 answered {code}")
    departures("/beam W = 1 vs greedy_decode", cfg, params, rows,
               [h[0] for h in one["tokens"]], greedy)
    gaps = []
    with torch.no_grad():
        for b, row in enumerate(rows):
            best = out["tokens"][b][0]
            seq = torch.tensor([row + best], device="cuda")
            lp = torch.log_softmax(forward(cfg, params, seq).float(), -1)
            forced = sum(float(lp[0, len(row) - 1 + i, t])
                         for i, t in enumerate(best))
            gaps.append(abs(forced - out["scores"][b][0]))
    tol = BEAM_FORCED_TOL_PER_TOKEN * steps
    log(f"[pool] /beam {len(rows)} rows of {len(rows[0])} tokens, W = {W}, "
        f"{steps} steps in {secs:.3f} s: bit-equal to beam_decode, scores "
        f"sorted (best {[round(s[0], 3) for s in out['scores']]}); the best "
        f"hypothesis against its teacher-forced sum: gaps "
        f"{[round(g, 4) for g in gaps]} (tolerance {tol}); on {card}")
    if max(gaps) > tol:
        fail(f"/beam: a best score parts from its teacher-forced sum by "
             f"{max(gaps):.4f} > {tol}")
    return greedy


def pool_spec_check(srv, port: int, cfg, params, rows: list, greedy: list,
                    draft: tuple, card: str) -> None:
    """20c: /speculative with k = 4 over the beam's rows, first with the
    serving model as its own draft, then with phase 17's distilled draft:
    bit-equal to ``speculative_decode`` of the same rows, target passes
    equal, the tokens held to greedy_decode under the near-tie rule."""
    import torch

    from tpu_dra_torch.workloads.decode import speculative_decode
    steps = BEAM_RUN["steps"]
    prompt = torch.tensor(rows, dtype=torch.int32, device="cuda")
    for label, (dcfg, dparams) in (("draft == target", (cfg, params)),
                                   ("distilled draft", draft)):
        srv.pool.set_draft(dcfg, dparams)
        t0 = time.perf_counter()
        code, out, _ = call(port, "/speculative",
                            {"tokens": rows, "steps": steps, "k": SPEC_K})
        secs = time.perf_counter() - t0
        if code != 200:
            fail(f"/speculative ({label}) answered {code}: {out!r:.300}")
        with torch.no_grad():
            want, stats = speculative_decode(
                cfg, params, dcfg, dparams, prompt, steps=steps, k=SPEC_K,
                return_stats=True)
        if out["tokens"] != want.tolist() or \
                out["target_passes"] != stats["target_passes"]:
            fail(f"/speculative ({label}) differs from speculative_decode "
                 f"of the same rows")
        log(f"[pool] /speculative ({label}, {dcfg.n_layers} layers), k = "
            f"{SPEC_K}, {len(rows)} rows, {steps} steps in {secs:.3f} s: "
            f"bit-equal to speculative_decode; {out['target_passes']} target "
            f"passes (every proposal accepted would take ceil((steps - 1) / "
            f"k) = {-(-(steps - 1) // SPEC_K)}; steps - 1 = {steps - 1} if "
            f"none were); on {card}")
        departures(f"/speculative ({label}) vs greedy_decode", cfg, params,
                   rows, out["tokens"], greedy)


def serve_cli_cmd(cfg, weights: str) -> list:
    """The server command line on phase 4's engine, the model drawn from
    seed 0 in the ``weights`` form."""
    return [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
            "--continuous", "--kv-layout", "paged", "--init-seed", "0",
            "--weights", weights, "--port", "0", "--host", "127.0.0.1",
            "--slots", str(ENGINE["slots"]), "--chunk", str(ENGINE["chunk"]),
            "--page-size", str(ENGINE["page_size"]), "--total-pages",
            str(ENGINE["total_pages"]), *model_flags(cfg)]


def launch_server(cmd: list, env: dict | None = None) -> dict:
    """Start a server command line; its output is read on a thread (so a
    full pipe never blocks it) until it exits."""
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    ready = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if "serving on" in line:
                ready.set()
        ready.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return {"proc": proc, "lines": lines, "ready": ready, "reader": reader}


def server_port(label: str, server: dict) -> int:
    """The port of a launched server once it serves (within 300 s)."""
    server["ready"].wait(300)
    ready = [ln for ln in server["lines"] if "serving on" in ln]
    if not ready:
        fail(f"{label} did not serve: {chr(10).join(server['lines'])[-2000:]}")
    return int(re.search(r", (\d+)\)", ready[0]).group(1))


def terminate(server: dict) -> None:
    """One SIGTERM to a launched server that still runs, never a second:
    a server that has drained and returned finalizes with the default
    SIGTERM disposition, so a second signal then kills it (-15)."""
    proc = server["proc"]
    if proc.poll() is None and not server.get("terminated"):
        proc.send_signal(signal.SIGTERM)
        server["terminated"] = True


def stop_server(label: str, server: dict) -> None:
    """SIGTERM (:func:`terminate`): the server must drain and exit 0
    within 120 s."""
    proc = server["proc"]
    terminate(server)
    try:
        proc.wait(120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
    server["reader"].join(30)
    if proc.returncode != 0:
        fail(f"{label} exited {proc.returncode} after SIGTERM: "
             f"{chr(10).join(server['lines'])[-1500:]}")


def trace_check(cfg, card: str, server: dict) -> dict:
    """20d: the server command line on phase 4's engine (int8 weights from
    seed 0), a process whose only profiler is the server's own: one
    request with a traceparent whose serve.request and
    serve.engine.decode spans /debug/traces returns; an OpenMetrics
    scrape whose exemplar trace id resolves there;
    /debug/jax-trace?seconds=TRACE_SECONDS taken while waves of 8
    requests run (TRACE_GAP_S apart, until the capture has answered),
    holding CUDA kernel events, kernel #1's among them (the engine
    launches it from its captured chunk).  ``server`` is the launched
    command line (``launch_server``), stopped here.  Returns the
    kernel's launches in this drive (the server's /stats)."""
    import io
    import tarfile

    prompts = request_prompts(cfg.vocab)
    try:
        port = server_port("trace: the server command line", server)
        before = call(port, "/stats")[1]
        trace_id = "c0ffee" + "5e" * 13
        code, _, _ = call(port, "/generate",
                          {"tokens": [prompts[0]], "steps": 16},
                          headers={"traceparent":
                                   f"00-{trace_id}-{'ab' * 8}-01"})
        if code != 200:
            fail(f"trace: /generate answered {code}")
        code, doc, _ = call(port, f"/debug/traces?trace_id={trace_id}")
        names = {e["name"] for e in (doc.get("traceEvents", [])
                                     if code == 200 else [])
                 if e.get("ph") == "X"}
        if not {"serve.request", "serve.engine.decode"} <= names:
            fail(f"trace: /debug/traces gave {code}, spans {sorted(names)}")
        code, text, hdrs = call(port, "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        ids = {ln.split('trace_id="')[1].split('"')[0]
               for ln in text.splitlines()
               if ln.startswith("tpu_serve_request_seconds_bucket")
               and "# {" in ln} if code == 200 else set()
        resolved = [i for i in ids
                    if call(port, f"/debug/traces?trace_id={i}")[0] == 200]
        if not resolved or "openmetrics" not in hdrs.get("Content-Type", ""):
            fail(f"trace: the OpenMetrics scrape's exemplar ids {ids} do not "
                 f"resolve on /debug/traces")
        results: dict = {i: [] for i in range(TRACE_REQUESTS)}
        captured = threading.Event()
        load_until = time.perf_counter() + TRACE_LOAD_S

        def one(i):
            results[i].append(call(port, "/generate",
                                   {"tokens": [prompts[i]],
                                    "steps": TRACE_STEPS})[0])

        def waves():
            while not captured.is_set() and \
                    time.perf_counter() < load_until:
                wave = [threading.Thread(target=one, args=(i,))
                        for i in range(TRACE_REQUESTS)]
                for t in wave:
                    t.start()
                for t in wave:
                    t.join(600)
                captured.wait(TRACE_GAP_S)
        driver = threading.Thread(target=waves)
        driver.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/jax-trace?seconds="
                    f"{TRACE_SECONDS}",
                    timeout=300) as resp:
                body, hdrs = resp.read(), resp.headers
        finally:
            captured.set()
        capture_s = time.perf_counter() - t0
        driver.join(900)
        codes = [c for i in range(TRACE_REQUESTS) for c in results[i]]
        if not codes or any(c != 200 for c in codes):
            fail(f"trace: the requests under the capture answered {results}")
        with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
            members = tar.getnames()
            events = json.load(tar.extractfile("jax-trace/trace.json"))[
                "traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        ours = [n for n in kernels if any(k in n for k in PAGED_KERNEL)]
        after = call(port, "/stats")[1]
    finally:
        stop_server("trace: the server command line", server)
    launches = (after["paged_attention_launches"]
                - before["paged_attention_launches"])
    steps = after["decode_steps"] - before["decode_steps"]
    log(f"[trace] a traceparent's serve.request and serve.engine.decode "
        f"spans on /debug/traces; {len(resolved)} exemplar trace id(s) of "
        f"the OpenMetrics scrape resolve there; /debug/jax-trace?seconds="
        f"{TRACE_SECONDS} under waves of {TRACE_REQUESTS} requests "
        f"({len(codes)} requests of "
        f"{TRACE_STEPS} steps): {len(body)} bytes ({members}), "
        f"{len(events)} events, {len(kernels)} CUDA kernel events, "
        f"{len(ours)} of kernel #1 ({hdrs['X-Trace-Kernel-Events']} by the "
        f"server's count), answered in {capture_s:.2f} s; kernel #1 "
        f"launched {launches} times over {steps} decode steps; on {card}")
    if not ours:
        fail("trace: the device trace holds no event of kernel #1")
    if launches < cfg.n_layers * steps:
        fail(f"trace: kernel #1 launched {launches} times over {steps} "
             f"decode steps")
    return {"launches": launches}


def pool_phase(models: tuple, card: str) -> dict:
    """Phase 20 (a-d) on phase 17's int8 model and distilled draft."""
    import numpy as np

    from tpu_dra_torch.workloads.serve import serve
    t0 = time.perf_counter()
    cfg, params, dcfg, dparams = models
    rng = np.random.default_rng(SEED + 20)
    rows = rng.integers(0, cfg.vocab, (BEAM_RUN["rows"],
                                       BEAM_RUN["length"])).tolist()
    # 20d's server command line starts while 20a-c run
    server = launch_server(serve_cli_cmd(cfg, "int8"))
    try:
        srv = serve(cfg, params, port=0, continuous=False,
                    draft=(dcfg, dparams))
        try:
            port = srv.server_address[1]
            call(port, "/generate", {"tokens": [[1, 2, 3]], "steps": 2})
            pool_generate_check(port, cfg, params, card)
            greedy = pool_beam_check(port, cfg, params, rows, card)
            pool_spec_check(srv, port, cfg, params, rows, greedy,
                            (dcfg, dparams), card)
        finally:
            srv.shutdown()
    except BaseException:
        server["proc"].kill()
        server["proc"].wait(30)
        raise
    log(f"[time] phase 20a-c {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    traced = trace_check(cfg, card, server)
    log(f"[time] phase 20d {time.perf_counter() - t0:.1f} s")
    return traced


def goodput_report(tracker, wall: float, saves: list, restore_s: float,
                   card: str) -> None:
    """20e: the goodput segments of phase 19a: their sum against the wall
    time (within 1%), checkpoint_save against the saves fit printed,
    restore against the restores timed (each within 1%, plus the 0.01 s
    rounding of every printed value)."""
    rep = tracker.report()
    totals = rep["totals"]
    total = sum(totals.values())
    log(f"[goodput] phase 19a under TPU_GOODPUT_FILE: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in totals.items())
        + f"; sum {total:.3f} s against {wall:.3f} s of wall time; goodput "
        f"ratio {rep['goodput_ratio']}; on {card}")
    if abs(total - wall) > 0.01 * wall:
        fail(f"goodput: segments sum to {total:.3f} s, wall {wall:.3f} s")
    for seg, want, n in (("checkpoint_save", sum(saves), len(saves)),
                         ("restore", restore_s, 3)):
        got = totals.get(seg, 0.0)
        log(f"[goodput] {seg} {got:.3f} s against {want:.3f} s timed")
        if abs(got - want) > 0.01 * want + 0.01 * n:
            fail(f"goodput: {seg} {got:.3f} s against {want:.3f} s")


# ---------------------------------------------------------------------------
# phase 21: disaggregated serving and the launcher's one-card contracts
# ---------------------------------------------------------------------------

# 4 prompts from 17 tokens to one of 700 that spans 11 pages and the
# clamped top bucket, 257 one past a page boundary; each decodes
# HANDOFF_STEPS tokens (8 prompts took the script past its time limit)
HANDOFF_PROMPTS = (17, 100, 257, 700)
HANDOFF_STEPS = 32
HANDOFF_SAMPLED = dict(temperature=0.8, seed=21)
# each tenant's memory budget on the card (TPU_HBM_LIMIT_BYTES_0)
TENANT_BUDGET = 8 << 30


def ttft_totals(srv) -> tuple:
    """(count, sum) of a server's TTFT histogram."""
    snap = srv.metrics.ttft.snapshot().get(("default",))
    return (snap["count"], snap["sum"]) if snap else (0, 0.0)


def handoff_rows(label: str, pre: int, dec, oracle_srv, prompts: list,
                 card: str) -> dict:
    """For each prompt, one after another: /prefill on the prefill server,
    /decode_handoff with the blob on ``dec`` and /generate on the oracle
    server, greedy and sampled; every decode answer bit-equal to the
    oracle's.  Returns the blobs, the greedy answers, and kernel #1's
    launches and the decode steps of the decode and oracle engines."""
    from tpu_dra_torch.workloads.paged_kv import paged_attention
    dport, oport = dec.server_address[1], oracle_srv.server_address[1]
    blobs, greedy, launches = [], [], 0
    def engine_steps():
        return sum(srv.engine.stats()["decode_steps"]
                   for srv in (dec, oracle_srv))
    steps0 = engine_steps()
    for prompt in prompts:
        t0 = time.perf_counter()
        code, out, _ = call(pre, "/prefill", {"tokens": prompt})
        export_s = time.perf_counter() - t0
        if code != 200 or out["length"] != len(prompt):
            fail(f"{label}: /prefill of {len(prompt)} tokens answered {code}: "
                 f"{out!r:.300}")
        blobs.append(out["blob"])
        nbytes = len(base64.b64decode(out["blob"]))
        for kind, knobs in (("greedy", {}), ("sampled", HANDOFF_SAMPLED)):
            body = {"steps": HANDOFF_STEPS, **knobs}
            # one after the other: the engines are host-bound, and two
            # at once in one process ran each ~3x slower on the card
            before = paged_attention.launches
            ttft0, o0 = ttft_totals(dec), ttft_totals(oracle_srv)
            t0 = time.perf_counter()
            code, got, _ = call(dport, "/decode_handoff",
                                {"blob": out["blob"], **body})
            import_s = time.perf_counter() - t0
            code2, want, _ = call(oport, "/generate",
                                  {"tokens": [prompt], **body})
            launches += paged_attention.launches - before
            ttft1, o1 = ttft_totals(dec), ttft_totals(oracle_srv)
            if code != 200 or code2 != 200:
                fail(f"{label}: prompt {len(prompt)} {kind}: /decode_handoff "
                     f"{code} {got!r:.200}, /generate {code2} {want!r:.200}")
            if got["tokens"] != want["tokens"] or \
                    len(got["tokens"][0]) != HANDOFF_STEPS:
                first = next((j for j, (a, b) in enumerate(zip(
                    got["tokens"][0], want["tokens"][0])) if a != b), None)
                fail(f"{label}: prompt {len(prompt)} {kind}: the handoff "
                     f"departs from the oracle at step {first}")
            if kind == "greedy":
                greedy.append(want["tokens"][0])
            log(f"[{label}] prompt {len(prompt)} {kind}: bit-equal to the "
                f"oracle's /generate; blob {nbytes} B, export "
                f"{export_s * 1e3:.1f} ms, /decode_handoff "
                f"{import_s * 1e3:.1f} ms (host clock); "
                f"TTFT decode replica {(ttft1[1] - ttft0[1]) * 1e3:.2f} ms, "
                f"oracle {(o1[1] - o0[1]) * 1e3:.2f} ms; on {card}")
    steps = engine_steps() - steps0
    log(f"[{label}] {len(prompts)} prompts x (greedy, sampled), "
        f"{HANDOFF_STEPS} steps: every answer bit-equal to the oracle; "
        f"kernel #1 launched {launches} times over {steps} decode steps of "
        f"the decode and oracle engines")
    return {"blobs": blobs, "greedy": greedy, "launches": launches,
            "steps": steps}


def handoff_batched(label: str, pre: int, dport: int, cfg, params,
                    prompts: list, greedy: list) -> int:
    """All prompts at once, each through /prefill then /decode_handoff on
    its own thread: greedy answers held to the sequential oracle answers
    under the near-tie rule, departures printed."""
    results: dict[int, object] = {}

    def client(i):
        try:
            code, out, _ = call(pre, "/prefill", {"tokens": prompts[i]})
            if code != 200:
                raise RuntimeError(f"/prefill {code}: {out!r:.200}")
            code, got, _ = call(dport, "/decode_handoff",
                                {"blob": out["blob"],
                                 "steps": HANDOFF_STEPS})
            if code != 200:
                raise RuntimeError(f"/decode_handoff {code}: {got!r:.200}")
            results[i] = got["tokens"][0]
        except Exception as exc:  # noqa: BLE001 — reported below
            results[i] = exc

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    answers = []
    for i in range(len(prompts)):
        if not isinstance(results.get(i), list):
            fail(f"{label}: request {i} failed: {results.get(i)!r}")
        answers.append(results[i])
    requests = [(len(p), HANDOFF_STEPS) for p in prompts]
    compared = hold_answers(
        label, answers, lambda i: greedy[i],
        lambda i, want, step: oracle_logits_at(cfg, params, prompts[i], want,
                                               step), requests)
    log(f"[{label}] {len(prompts)} handoffs at once in {wall:.3f} s "
        f"(informational)")
    return compared


def handoff_servers(cfg, params, cache_dtype: str = "bf16") -> tuple:
    """Phase 4's engine three times: prefill, decode and oracle servers
    (the prefill one always bf16 pages: the wire carries bf16)."""
    from tpu_dra_torch.workloads.serve import serve
    pre = serve(cfg, params, port=0, pool_role="prefill", **ENGINE)
    dec = serve(cfg, params, port=0, pool_role="decode",
                cache_dtype=cache_dtype, **ENGINE)
    orc = serve(cfg, params, port=0, pool_role="any",
                cache_dtype=cache_dtype, **ENGINE)
    for srv, role in ((pre, "prefill"), (dec, "decode"), (orc, "any")):
        over = call(srv.server_address[1], "/debug/overload")[1]
        if over["role"] != role:
            fail(f"/debug/overload of the {role} server says {over['role']}")
        # first-use costs out of the measured requests
        call(srv.server_address[1], "/generate", {"tokens": [[1, 2, 3]],
                                                  "steps": 2})
    return pre, dec, orc


def lying_blob_check(port: int, blob: str) -> None:
    """A blob whose header lies about the KV's shape is a 400, and the
    engine answers the next request."""
    from tpu_dra_torch.workloads.kv_handoff import (KVHandoff, decode_blob,
                                                    encode)
    h = decode_blob(base64.b64decode(blob))
    lie = KVHandoff(prompt=h.prompt, length=h.length, page_size=h.page_size,
                    model=h.model, ks=h.ks[:, :, :1], vs=h.vs[:, :, :1],
                    last_logits=h.last_logits)
    code, out, _ = call(port, "/decode_handoff", {
        "blob": base64.b64encode(encode(lie)).decode(), "steps": 4})
    if code != 400:
        fail(f"a blob with a lying shape answered {code}: {out!r:.300}")
    why = out["error"]
    code, out, _ = call(port, "/decode_handoff", {"blob": blob, "steps": 4})
    if code != 200 or len(out["tokens"][0]) != 4:
        fail(f"after the lying blob the decode server answered {code}")
    log(f"[handoff] a blob with a lying shape: 400 ({why[:120]}); the "
        f"engine then answered the next handoff")


def pages_back(srv) -> None:
    deadline = time.monotonic() + 10
    while True:
        st = srv.engine.stats()
        if st["kv_pages_free"] == st["kv_pages_total"]:
            return
        if time.monotonic() > deadline:
            held = st["kv_pages_total"] - st["kv_pages_free"]
            fail(f"the decode engine holds {held} pages after its last "
                 f"handoff")
        time.sleep(0.05)


def ici_check(blob: str, card: str) -> int:
    """21c: one handoff's ks and vs as [1, 2, ...] blocks of a two-rank
    ring (rank 0 the prefill side, rank 1 the decode side's empty buffer)
    shifted one hop and back through kv_handoff.ici_shift, bit-equal to
    ring_shift_ref; returns the ring-shift kernel's launches."""
    import torch

    from tpu_dra_torch.workloads.collective_matmul import (ring_shift,
                                                           ring_shift_ref)
    from tpu_dra_torch.workloads.kv_handoff import decode_blob, ici_shift
    h = decode_blob(base64.b64decode(blob))
    tree = {n: torch.stack([t, torch.zeros_like(t)])[None].cuda()
            for n, t in (("ks", h.ks), ("vs", h.vs))}
    before = ring_shift.launches
    there = ici_shift(tree)
    back = ici_shift(there, reverse=True)
    torch.cuda.synchronize()
    launches = ring_shift.launches - before
    for name, x in tree.items():
        for got, want in ((there[name], ring_shift_ref(x)),
                          (back[name], ring_shift_ref(there[name], True))):
            if not torch.equal(got, want):
                fail(f"ici_shift of {name} differs from ring_shift_ref")
        if not (torch.equal(there[name][0, 1], x[0, 0])
                and torch.equal(back[name], x)):
            fail(f"ici_shift did not carry {name} to the decode rank and back")
    if launches != 2 * len(tree):
        fail(f"ici_shift launched the ring-shift kernel {launches} times for "
             f"{len(tree)} leaves each way")
    ms = cuda_time_ms(lambda: ici_shift(tree), 20)
    nbytes = sum(x.numel() * x.element_size() for x in tree.values())
    log(f"[handoff] ici_shift of one handoff's ks and vs ({nbytes} B on a "
        f"two-rank ring) one hop and back: bit-equal to ring_shift_ref, "
        f"{launches} ring-shift launches; {ms * 1e3:.1f} us a hop "
        f"(informational); on {card}")
    return launches


def handoff_phase(int8_models: tuple, card: str) -> dict:
    """21a-c on phase 4's model (bf16 from the seed) and, for 21b, phase
    17's int8 weights with int8 pages on the decode and oracle servers."""
    import numpy as np
    import torch

    from tpu_dra_torch.workloads.quant import cast_params_bf16
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    params = cast_params_bf16(init_params(cfg, gen))
    rng = np.random.default_rng(SEED + 21)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in HANDOFF_PROMPTS]
    pre, dec, orc = handoff_servers(cfg, params)
    try:
        rows = handoff_rows("handoff", pre.server_address[1], dec, orc,
                            prompts, card)
        launches = rows["launches"]
        if launches < cfg.n_layers * rows["steps"]:
            fail(f"kernel #1 launched {launches} times over {rows['steps']} "
                 f"decode steps of {cfg.n_layers} layers")
        from tpu_dra_torch.workloads.paged_kv import paged_attention
        before = paged_attention.launches
        handoff_batched("handoff batched", pre.server_address[1],
                        dec.server_address[1], cfg, params, prompts,
                        rows["greedy"])
        launches += paged_attention.launches - before
        pages_back(dec)
        lying_blob_check(dec.server_address[1], rows["blobs"][0])
        pages_back(dec)
        log(f"[handoff] the decode engine's pages are back: "
            f"{dec.engine.stats()['kv_pages_free']} free of "
            f"{dec.engine.stats()['kv_pages_total']}")
    finally:
        for srv in (pre, dec, orc):
            srv.shutdown()
    ring_launches = ici_check(rows["blobs"][-1], card)
    del params
    torch.cuda.empty_cache()

    cfg8, params8 = int8_models[0], int8_models[1]
    pre, dec, orc = handoff_servers(cfg8, params8, cache_dtype="int8")
    try:
        rows8 = handoff_rows("handoff int8", pre.server_address[1], dec, orc,
                             prompts, card)
        pages_back(dec)
    finally:
        for srv in (pre, dec, orc):
            srv.shutdown()
    return {"launches": launches + rows8["launches"],
            "ring_launches": ring_launches}


TENANT_CHILD = """
import json, os, sys, time
import torch
from tpu_dra_torch.workloads import launcher
# a fast beat first: the start-up then reports the running one
launcher.start_health_heartbeat(interval=0.2)
applied = launcher.init_tpu_workload()
beat = applied["heartbeat"][0]
m0 = os.stat(beat).st_mtime_ns
time.sleep(1.0)
m1 = os.stat(beat).st_mtime_ns
budget = applied["hbm_limit_bytes"]
under = torch.empty(budget // 2, dtype=torch.uint8, device="cuda")
under.fill_(1)
torch.cuda.synchronize()
del under
torch.cuda.empty_cache()
out = {"slot": applied["slot"], "budget": budget, "beat_advanced": m1 > m0}
try:
    past = torch.empty(budget + (1 << 30), dtype=torch.uint8, device="cuda")
    out["oom"] = False
except torch.cuda.OutOfMemoryError as exc:
    out["oom"] = True
    out["sentinels"] = launcher.report_hbm_oom(detail=str(exc)[:300])
print(json.dumps(out), flush=True)
"""


def tenant_env(tmp: Path, name: str, priority: str | None) -> dict:
    """The environment tenancy.tenant_edits writes for a tenant of chip 0
    with a slot pool of 2 (written out: the plugin is not imported), and
    a heartbeat file of the tenant's own."""
    env = dict(os.environ, TPU_ALLOW_MULTIPLE_LIBTPU_LOAD="1",
               TPU_HBM_LIMIT_BYTES_0=str(TENANT_BUDGET),
               TPU_SHARE_WEIGHT="5" if priority == "Low" else "10",
               TPU_MULTIPROCESS_SLOT_DIR=str(tmp / "mp-slots"),
               TPU_MULTIPROCESS_MAX="2", TPU_VISIBLE_CHIPS="0",
               TPU_HEALTH_HEARTBEAT_FILE=str(tmp / "beats" / name / "beat"))
    if priority:
        env["TPU_PROCESS_PRIORITY"] = priority
    return env


def tenants_phase(card: str) -> None:
    """21d: two server tenants on one card under one slot pool of 2, each
    with an 8 GiB budget, answer 8 requests each at the same time; a
    third is refused; a child under the budget allocates under it, then
    past it, gets the OOM error and drops the sentinel; the heartbeat
    advances."""
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg = ModelConfig(**MODEL)
    prompts = request_prompts(cfg.vocab)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-tenants-") as t:
        tmp = Path(t)
        pool = tmp / "mp-slots" / "tenant-pool"
        pool.mkdir(parents=True)
        (pool / "max").write_text("2")
        envs = {"tenant-a": tenant_env(tmp, "tenant-a", "Low"),
                "tenant-b": tenant_env(tmp, "tenant-b", None)}
        t0 = time.perf_counter()
        procs = {name: launch_server(serve_cli_cmd(cfg, "bf16"), env)
                 for name, env in envs.items()}
        try:
            ports = {name: server_port(name, p) for name, p in procs.items()}
            ready_s = time.perf_counter() - t0
            for name in procs:
                if not Path(envs[name]["TPU_HEALTH_HEARTBEAT_FILE"]).exists():
                    fail(f"{name} beats no heartbeat")
            results: dict = {}

            def client(name, i):
                try:
                    results[name, i] = post(ports[name], {
                        "tokens": [prompts[i]], "steps": REQUESTS[i][1]})
                except Exception as exc:  # noqa: BLE001 — reported below
                    results[name, i] = exc
            threads = [threading.Thread(target=client, args=(name, i))
                       for name in procs for i in range(len(REQUESTS))]
            t1 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t1
            for (name, i), res in sorted(results.items()):
                toks = res["tokens"][0] if isinstance(res, dict) else None
                if toks is None or len(toks) != REQUESTS[i][1] or not all(
                        0 <= x < cfg.vocab for x in toks):
                    fail(f"{name} request {i}: {res!r:.300}")
            if len(results) != 2 * len(REQUESTS):
                fail(f"the tenants answered {len(results)} requests")
            for name, port in ports.items():
                peak = call(port, "/stats")[1]["max_memory_reserved"]
                log(f"[tenants] {name}: max_memory_reserved {peak} B of its "
                    f"{TENANT_BUDGET} B budget ({peak / TENANT_BUDGET:.3f})")
                if peak > TENANT_BUDGET:
                    fail(f"{name} reserved {peak} B past its budget")
            log(f"[tenants] two tenants ready {ready_s:.1f} s after the "
                f"start; {2 * len(REQUESTS)} requests at once answered in "
                f"{wall:.2f} s (informational); on {card}")
            third = subprocess.run(
                serve_cli_cmd(cfg, "bf16"), cwd=HERE, env=dict(
                    envs["tenant-b"], TPU_HEALTH_HEARTBEAT_FILE=str(
                        tmp / "beats" / "tenant-c" / "beat")),
                capture_output=True, text=True, timeout=300)
            if third.returncode == 0 or \
                    "refusing to oversubscribe" not in third.stderr:
                fail(f"a third tenant exited {third.returncode}: "
                     f"{third.stderr[-1500:]}")
            log(f"[tenants] a third tenant exited {third.returncode}: "
                f"{third.stderr.strip().splitlines()[-1]}")
        finally:
            for p in procs.values():
                terminate(p)
            for name, p in procs.items():
                stop_server(name, p)
        for name in procs:
            if Path(envs[name]["TPU_HEALTH_HEARTBEAT_FILE"]).exists():
                fail(f"{name} left its heartbeat file behind")
        child = subprocess.run(
            [sys.executable, "-c", TENANT_CHILD], cwd=HERE,
            env=dict(envs["tenant-b"], PYTHONPATH=str(HERE),
                     TPU_HEALTH_HEARTBEAT_FILE=str(tmp / "beats" / "child"
                                                   / "beat")),
            capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            fail(f"the budget child exited {child.returncode}: "
                 f"{child.stderr[-1500:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        sentinel = tmp / "beats" / "child" / "oom"
        if not (got["oom"] and got["beat_advanced"] and sentinel.exists()
                and got["slot"] == {"tenant-pool": 0}):
            fail(f"the budget child: {got}")
        log(f"[tenants] a child under the {got['budget']} B budget allocated "
            f"half of it, then past it: torch.cuda.OutOfMemoryError, the oom "
            f"sentinel written ({sentinel.read_text()[:80]!r}...); its "
            f"heartbeat advanced; it took slot {got['slot']} once the tenants "
            f"had exited")


# ---------------------------------------------------------------------------
# phase 22: packed training at full width
# ---------------------------------------------------------------------------

# documents' lengths (uniform, inclusive) and the packed batch [rows, seq]
PACK_DOC_LENGTHS = (17, 700)
PACK_RUN = dict(rows=16, seq=1025)
# the packed loss against the isolated documents' token-weighted mean
# (|d| 5.21e-06 at the flagship on an H100 80GB HBM3, 700 W: a twentieth
# of the bound)
PACK_LOSS_ATOL = 1e-4


def packed_rows(vocab: int) -> tuple:
    """``data.pack_documents`` over documents of PACK_DOC_LENGTHS tokens
    (ids 1..vocab-1, seed SEED + 22), a little more than PACK_RUN's rows
    hold; the first ``rows`` rows as numpy (tokens, segment ids,
    positions)."""
    import numpy as np

    from tpu_dra_torch.workloads.data import pack_documents
    rows, seq = PACK_RUN["rows"], PACK_RUN["seq"]
    lo, hi = PACK_DOC_LENGTHS
    rng = np.random.default_rng(SEED + 22)
    docs, total = [], 0
    while total < 1.1 * rows * seq:
        n = int(rng.integers(lo, hi + 1))
        docs.append(rng.integers(1, vocab, n))
        total += n
    toks, segs, pos = pack_documents(docs, seq)
    return toks[:rows], segs[:rows], pos[:rows]


def packed_variant(cfg, params, toks, segs, pos, *, segments: bool = True,
                   valid: bool = True):
    """``train.packed_loss_fn`` broken on purpose: the same mean NLL of
    the packed rows, without the segment mask in the attention
    (``segments=False``) or with every prediction counted
    (``valid=False``)."""
    from tpu_dra_torch.workloads.train import _trunk, head_nll
    trunk = _trunk(cfg, params, toks[:, :-1],
                   segment_ids=segs[:, :-1] if segments else None,
                   positions=pos[:, :-1])
    nll = head_nll(params, trunk, toks[:, 1:].long())[..., 0]
    if not valid:
        return nll.mean()
    keep = ((segs[:, :-1] == segs[:, 1:]) & (segs[:, :-1] > 0)).float()
    return (nll * keep).sum() / keep.sum()


def packed_phase(card: str) -> dict:
    """Phase 22: ``train.packed_loss_fn`` on the flagship (dense
    attention, learned positions) over :func:`packed_rows`: one loss and
    gradient with every leaf finite; the loss against the token-weighted
    mean of ``loss_fn`` over each document alone (within
    PACK_LOSS_ATOL); the trunk of row 0 at its second document's
    positions against that document alone (relative L2 within
    STEP_LEAF_REL); no gradient in the padding token's embedding row.
    Then the same loss without the segment mask and without the valid
    mask (:func:`packed_variant`): the first must fail the activation
    check and the second the padding row's, else the checks could not
    see those faults."""
    import torch

    from tpu_dra_torch.workloads.train import (ModelConfig, _trunk,
                                               init_params, loss_fn,
                                               packed_loss_fn, tree_leaves,
                                               value_and_grad)
    cfg = ModelConfig(**TRAIN_MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)
    params = init_params(cfg, gen)
    toks, segs, pos = (torch.from_numpy(a).to("cuda")
                       for a in packed_rows(cfg.vocab))
    n_docs = int((segs.amax(dim=1)).sum())
    fill = float((segs > 0).float().mean())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(
        lambda p: packed_loss_fn(cfg, p, toks, segs, pos), params)
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pad_grad = float(grads["embed"][0].abs().max())
    del grads
    if not finite or not bool(torch.isfinite(loss)):
        fail(f"packed: loss {float(loss)} or a gradient leaf not finite")
    total, count = 0.0, 0
    with torch.no_grad():
        for r in range(toks.shape[0]):
            for sid in range(1, int(segs[r].max()) + 1):
                doc = toks[r][segs[r] == sid]
                if len(doc) > 1:
                    total += float(loss_fn(cfg, params, doc[None])) \
                        * (len(doc) - 1)
                    count += len(doc) - 1
        want = total / count
        dl = abs(float(loss) - want)
        S = toks.shape[1] - 1
        row = _trunk(cfg, params, toks[:1, :S], segment_ids=segs[:1, :S],
                     positions=pos[:1, :S])
        at = int(torch.nonzero(segs[0] == 2)[0])
        n = min(int((segs[0] == 2).sum()), S - at)
        alone = _trunk(cfg, params, toks[:1, at:at + n])
        got = row[0, at:at + n].float()
        ref = alone[0].float()
        rel = float((got - ref).norm() / ref.norm())
        max_abs = float((got - ref).abs().max())
        unmasked = _trunk(cfg, params, toks[:1, :S], positions=pos[:1, :S])
        got = unmasked[0, at:at + n].float()
        rel_unmasked = float((got - ref).norm() / ref.norm())
        dl_unmasked = abs(float(packed_variant(cfg, params, toks, segs, pos,
                                               segments=False)) - want)
    loss_all, grads = value_and_grad(
        lambda p: packed_variant(cfg, p, toks, segs, pos, valid=False),
        params)
    pad_grad_all = float(grads["embed"][0].abs().max())
    dl_all = abs(float(loss_all) - want)
    del grads
    log(f"[packed] flagship, dense attention, {n_docs} documents of "
        f"{PACK_DOC_LENGTHS[0]}-{PACK_DOC_LENGTHS[1]} tokens packed into "
        f"{list(toks.shape)} rows ({fill:.3f} of the positions filled): "
        f"packed loss {float(loss):.5f}, every gradient leaf finite: "
        f"{finite}; loss and gradient {1e3 * step_s:.1f} ms (first call), "
        f"peak memory (max_memory_allocated) {peak_gb:.2f} GB; on {card}")
    log(f"[packed] token-weighted mean of the {n_docs} documents' own "
        f"losses {want:.5f} over {count} predictions: |d| {dl:.2e} "
        f"(tolerance {PACK_LOSS_ATOL}); row 0's second document ({n} "
        f"tokens at {at}) against it alone: relative L2 {rel:.3e} "
        f"(tolerance {STEP_LEAF_REL}), max |d| {max_abs:.3e}; the padding "
        f"token's embedding row's largest gradient {pad_grad:.3e} (must be "
        f"0)")
    log(f"[packed] broken on purpose: without the segment mask the "
        f"document departs by relative L2 {rel_unmasked:.3e} (must pass "
        f"{STEP_LEAF_REL}) and the loss by |d| {dl_unmasked:.2e}; without "
        f"the valid mask the padding row's largest gradient is "
        f"{pad_grad_all:.3e} (must not be 0) and the loss departs by |d| "
        f"{dl_all:.2e} (tolerance {PACK_LOSS_ATOL})")
    if dl > PACK_LOSS_ATOL:
        fail(f"packed: loss {float(loss)} against the isolated documents' "
             f"{want}")
    if rel > STEP_LEAF_REL:
        fail(f"packed: the packed row's activations depart from the "
             f"document alone by {rel}")
    if pad_grad:
        fail(f"packed: the padding token's embedding row has gradient "
             f"{pad_grad}")
    if rel_unmasked <= STEP_LEAF_REL or not pad_grad_all:
        fail(f"packed: a check misses a broken mask (without segments "
             f"relative L2 {rel_unmasked}, without the valid mask the "
             f"padding row's gradient {pad_grad_all})")
    del params
    torch.cuda.empty_cache()
    return {"loss": float(loss), "isolated": want, "rel": rel,
            "rel_unmasked": rel_unmasked, "pad_grad_all": pad_grad_all,
            "step_ms": 1e3 * step_s, "peak_gb": peak_gb}


# ---------------------------------------------------------------------------
# phase 23: the rest of the virtual mesh (zigzag, ZeRO-1, GPipe, EP, LoRA
# and serving shardings over a mesh) and dryrun_multichip
# ---------------------------------------------------------------------------

# 23a: the long-context arm's shape, flagship heads and the GQA run's,
# zigzag over sp 4 (C = S / 2n = 512 a chunk): (label, B, H, Hkv, S, D)
ZIGZAG_CASES = [("flagship heads [2, 16, 4096, 128]", 2, 16, 16, 4096, 128),
                ("GQA 8 over 2 [2, 8, 4096, 128]", 2, 8, 2, 4096, 128)]
ZIGZAG_SP = 4
# 23b: the phase-8 flagship through make_optax_train_step on dp 2 x tp 2
ZERO1_RUN = dict(steps=5, batch=16)
# 23c: GPipe on pp 4
PIPE_RUN = dict(steps=5, batch=16, n_micro=4)
# 23d: phase 19d's MoE model (top-1) on ep 4: the SGD step at full depth;
# the AdamW pair (ZeRO-1 and replicated, both kept for the bit-equality
# check) at 2 layers, where the two trees and their moments fit the card,
# on dp 1 x ep 4 (where ZeRO-1 has no "dp" to cut over and keeps every
# spec) and on dp 2 x ep 2 (where it halves the moments)
EP_RUN = dict(steps=3, batch=8, optax_layers=2)
# 23e: phase 19c's LoRA step on dp 2 x tp 2
LORA_MESH_RUN = dict(steps=3, rank=8, batch=8)
# 23f: greedy steps of phase 4's prompts from each serving tree
MESH_DECODE_STEPS = 32


def kernel_counters() -> dict:
    """Every kernel wrapper a phase-23 path may launch, by its name in the
    kernels line."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import paged_kv
    return {**flash_counters(), "paged_attention": paged_kv.paged_attention,
            "all_gather_matmul": cm.all_gather_matmul,
            "matmul_reduce_scatter": cm.matmul_reduce_scatter,
            "ring_shift": cm.ring_shift}


def counted(fn, gqa: bool = False):
    """``fn()`` with every kernel count zeroed just before and read just
    after: ``(result, launches)``, the zero counts left out; a GQA path's
    forward launches are row #4's (``flash_fwd_gqa``)."""
    counters = kernel_counters()
    zero_counts(counters)
    out = fn()
    launches = {k: v for k, v in read_counts(counters).items() if v}
    if gqa and "flash_fwd" in launches:
        launches["flash_fwd_gqa"] = launches.pop("flash_fwd")
    return out, launches


def add_counts(total: dict, part: dict) -> dict:
    for name, n in part.items():
        total[name] = total.get(name, 0) + n
    return total


def same_trees(a: dict, b: dict) -> bool:
    import torch

    from tpu_dra_torch.workloads.train import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def zigzag_case(gen, label: str, B: int, H: int, Hkv: int, S: int, D: int,
                card: str) -> dict:
    """23a, one shape: both zigzag engines on Mesh({"dp": 1, "sp": 4}),
    unpermuted, against the one-device causal flash forward (ELEM_TOL
    elementwise, ROW_TOL["out"] per head-row); the fp32 engine also
    against the plain fp32 attention; the flash engine's dq, dk and dv
    against the one-device flash backward within STEP_LEAF_REL relative
    L2 (the ring step's tolerance); exactly 3n forward launches and 3n of
    each backward kernel (three rank subsets a ring step); its forward
    time beside ring_attention_flash's at the same shape
    (informational)."""
    import torch

    from tpu_dra_torch.workloads.flash import ROW_TOL, flash_attention
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.ring_attention import (
        inverse_permutation, make_ring_attention_flash,
        make_zigzag_ring_attention, zigzag_indices)
    n = ZIGZAG_SP
    mesh = Mesh({"dp": 1, "sp": n})

    def draw(h):
        return torch.randn((B, h, S, D), generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v, cot = draw(H), draw(Hkv), draw(Hkv), draw(H)
    order = zigzag_indices(S, n, device="cuda")
    inv = inverse_permutation(order)
    zz = {impl: make_zigzag_ring_attention(mesh, impl=impl)
          for impl in ("xla", "flash")}

    def heads(t):
        return t.reshape(B * H, S, D)

    ins = [t.clone().requires_grad_() for t in (q, k, v)]

    def flash_engine():
        out = zz["flash"](*(t[:, :, order] for t in ins))[:, :, inv]
        return out, torch.autograd.grad(out, ins, cot)
    (out_z, g_z), launches = counted(flash_engine, gqa=Hkv < H)
    want = {"flash_fwd_gqa" if Hkv < H else "flash_fwd": 3 * n,
            "flash_bwd_dq": 3 * n, "flash_bwd_dkdv": 3 * n}
    if launches != want:
        fail(f"zigzag {label}: launches {launches}, expected {want} (three "
             f"attends a ring step)")
    one = [t.clone().requires_grad_() for t in (q, k, v)]
    out_1 = flash_attention(*one, causal=True)
    g_1 = torch.autograd.grad(out_1, one, cot)
    out_z, out_1 = out_z.detach(), out_1.detach()
    errs = {"flash engine out vs one-device flash": hold(
        f"zigzag {label}", "flash engine out", heads(out_z), heads(out_1),
        ROW_TOL["out"])}
    for name, got, w in zip(("dq", "dk", "dv"), g_z, g_1):
        rel = float((got.float() - w.float()).norm() / w.float().norm())
        log(f"[zigzag] {label}: flash engine {name} vs the one-device "
            f"flash backward: relative L2 {rel:.3e} (tolerance "
            f"{STEP_LEAF_REL})")
        if not (torch.isfinite(got.float()).all() and rel <= STEP_LEAF_REL):
            fail(f"zigzag {label}: {name} relative L2 {rel}")
    with torch.no_grad():
        out_x = zz["xla"](*(t[:, :, order] for t in (q, k, v)))[:, :, inv]
        errs["fp32 engine out vs one-device flash"] = hold(
            f"zigzag {label}", "fp32 engine out", heads(out_x), heads(out_1),
            ROW_TOL["out"])
        grp = H // Hkv
        kf, vf = (t.float().repeat_interleave(grp, dim=1) for t in (k, v))
        s = (q.float() @ kf.transpose(-1, -2)) * D ** -0.5
        s.masked_fill_(~torch.ones(S, S, dtype=torch.bool,
                                   device="cuda").tril(), float("-inf"))
        plain = (torch.softmax(s, dim=-1) @ vf).to(torch.bfloat16)
        del s, kf, vf
        errs["fp32 engine out vs plain fp32 attention"] = hold(
            f"zigzag {label}", "fp32 engine vs plain fp32", heads(out_x),
            heads(plain), ROW_TOL["out"])
        ring = make_ring_attention_flash(mesh)
        zq, zk, zv = (t[:, :, order].contiguous() for t in (q, k, v))
        ms = cuda_time_ms(lambda: zz["flash"](zq, zk, zv), 10)
        ring_ms = cuda_time_ms(lambda: ring(q, k, v), 10)
        host_ms = enqueue_ms(lambda: zz["flash"](zq, zk, zv), 10)
        ring_host_ms = enqueue_ms(lambda: ring(q, k, v), 10)
    for name, (err, ratio, row) in errs.items():
        log(f"[zigzag] {label}: {name}: max abs err {err:.4g} "
            f"(elementwise {ratio:.3f} of the tolerance), worst head-row "
            f"{row:.3g}")
    log(f"[zigzag] {label}, sp {n} (C = {S // (2 * n)}): the flash engine's "
        f"forward {ms:.3f} ms, ring_attention_flash's {ring_ms:.3f} ms at "
        f"the same shape ({ms / ring_ms:.2f}x; informational; the host "
        f"enqueues a call in {host_ms:.3f} and {ring_host_ms:.3f} ms); "
        f"launches {launches}; on {card}")
    del ins, one, out_z, g_z, out_1, g_1, out_x, plain
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "ring_ms": ring_ms}


def optax_runs(make_step, init_fn, windows, label: str, card: str) -> dict:
    """``make_step(zero1)`` → ``(step, init_opt, ...)``: the same steps
    from the same ``init_fn()`` tree with zero1 False then True; fails
    unless the losses, parameters and (gathered) moments are bit-equal.
    Returns ``{zero1: (losses, step ms, final state)}`` and the launches."""
    import torch
    runs, launches = {}, {}
    for zero1 in (False, True):
        step, init_opt = make_step(zero1)[:2]
        params = init_fn()
        opt = init_opt(params)

        def loop(params=params, opt=opt):
            losses, stamps = [], [time.perf_counter()]
            for win in windows:
                params, opt, loss = step(params, opt, win)
                losses.append(float(loss))
                stamps.append(time.perf_counter())
            return losses, stamps, params, opt
        (losses, stamps, params, opt), part = counted(loop)
        add_counts(launches, part)
        times = [b - a for a, b in zip(stamps, stamps[1:])]
        ms = 1e3 * statistics.median(times[1:] or times)
        runs[zero1] = (losses, ms, params, opt)
        log(f"[{label}] zero1={zero1}: losses {losses}; step {ms:.1f} ms "
            f"(median of steps 2-{len(times)}); on {card}")
        del params, opt
    (la, _, pa, oa), (lb, _, pb, ob) = runs[False], runs[True]
    da, db = oa.to_dict(), ob.to_dict()
    same = (la == lb and same_trees(pa, pb) and same_trees(da["mu"], db["mu"])
            and same_trees(da["nu"], db["nu"]))
    log(f"[{label}] ZeRO-1 against replicated moments: losses, parameters "
        f"and moments bit-equal: {same}")
    if not same:
        fail(f"{label}: ZeRO-1 is not bit-equal to the replicated moments")
    del da, db
    torch.cuda.empty_cache()
    return runs, launches


def zero1_phase(data_path: str, card: str) -> dict:
    """23b: the phase-8 flagship (flash, batch 16) through
    make_optax_train_step on Mesh({"dp": 2, "tp": 2}), ZERO1_RUN steps
    with zero1=True against as many with zero1=False from the same seed,
    bit-equal (:func:`optax_runs`); the moment bytes a rank of each, every
    leaf with a dp-divisible replicated dimension holding half; then
    fit(mesh=Mesh({"dp": 4, "tp": 1}), zero1=True) for ZERO1_RUN steps with
    finite, falling losses."""
    import math

    import torch

    from tpu_dra_torch.workloads.fit import fit
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                               make_optax_train_step,
                                               opt_state_bytes_per_rank,
                                               opt_state_shardings,
                                               param_shapes, param_shardings,
                                               tree_leaves, tree_like)
    cfg = ModelConfig(**TRAIN_MODEL)
    mesh = Mesh({"dp": 2, "tp": 2})
    steps = ZERO1_RUN["steps"]
    windows = window_batches(data_path, ZERO1_RUN["batch"], cfg.max_seq,
                             steps)

    def init():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 23)
        return init_params(cfg, gen)
    runs, launches = optax_runs(
        lambda zero1: make_optax_train_step(cfg, mesh, attn_impl="flash",
                                            zero1=zero1),
        init, windows, "zero1", card)
    shapes = param_shapes(cfg)
    p_shard = param_shardings(cfg, mesh)
    sh0, _ = opt_state_shardings(None, shapes, p_shard, mesh, False)
    sh1, _ = opt_state_shardings(None, shapes, p_shard, mesh, True)
    b0 = opt_state_bytes_per_rank(sh0, shapes, mesh)
    b1 = opt_state_bytes_per_rank(sh1, shapes, mesh)
    mu = runs[True][3].mu
    rows = []
    for shape, spec, stacked in zip(
            tree_leaves(tree_like(mu, shapes)),
            tree_leaves(tree_like(mu, p_shard)), tree_leaves(mu)):
        rank = stacked[(0,) * len(mesh.axes)].numel()
        plain = math.prod(mesh.shard_shape(shape, spec))
        full = tuple(spec) + (None,) * (len(shape) - len(spec))
        halves = any(e is None and s % 2 == 0 for s, e in zip(shape, full))
        rows.append(f"{rank}/{plain}")
        if rank * (2 if halves else 1) != plain:
            fail(f"zero1: a {shape} moment holds {rank} elements a rank, "
                 f"the replicated layout {plain}")
    if 8 * sum(s[(0,) * len(mesh.axes)].numel()
               for s in tree_leaves(mu)) != b1:
        fail("zero1: the stacked moments do not hold the bytes their specs "
             "give")
    log(f"[zero1] AdamW moment bytes a rank (mu and nu, fp32) on dp 2 x "
        f"tp 2: replicated layout {b0} B ({b0 / 1e9:.3f} GB), ZeRO-1 {b1} B "
        f"({b1 / 1e9:.3f} GB), {b1 / b0:.3f} of it; elements a rank by "
        f"leaf, ZeRO-1/replicated: {', '.join(rows)}")
    step_ms = {z: runs[z][1] for z in runs}
    del runs, mu
    gc.collect()
    torch.cuda.empty_cache()

    def run_fit():
        return fit(cfg, data_path, mesh=Mesh({"dp": 4, "tp": 1}),
                   steps=steps, batch=ZERO1_RUN["batch"], attn_impl="flash",
                   zero1=True, log_every=1,
                   log_fn=lambda ln: log(f"[zero1]   fit dp 4 {ln}"))
    res, part = counted(run_fit)
    add_counts(launches, part)
    if not all(math.isfinite(x) for x in res.losses) or \
            not res.losses[-1] < res.losses[0]:
        fail(f"zero1 fit dp 4: losses {res.losses}")
    log(f"[zero1] fit(mesh=dp 4 x tp 1, zero1=True): losses {res.losses}, "
        f"{res.tokens_per_s:.0f} tokens/s from the start; on {card}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "bytes": (b0, b1), "step_ms": step_ms}


def pipeline_phase(data_path: str, card: str) -> dict:
    """23c: the flagship on Mesh({"dp": 1, "pp": 4}), n_micro 4, batch 16
    (the reference's dense attention in each stage): one step held to the
    one-device SGD step (loss within STEP_LOSS_ATOL, every leaf, read off
    as p − p' at lr 1, within STEP_LEAF_REL), then PIPE_RUN steps with
    finite, falling losses; the step time beside the one-device dense SGD
    step's on the same windows, and the bubble fraction (pp − 1) /
    (n_micro + pp − 1)."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.pipeline import make_pipeline_train_step
    from tpu_dra_torch.workloads.train import (ModelConfig, grads_fn,
                                               init_params, sgd_train_step)
    cfg = ModelConfig(**TRAIN_MODEL)
    pp, n_micro = 4, PIPE_RUN["n_micro"]
    mesh = Mesh({"dp": 1, "pp": pp})
    windows = window_batches(data_path, PIPE_RUN["batch"], cfg.max_seq,
                             PIPE_RUN["steps"] + 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 24)
    params = init_params(cfg, gen)
    step1, _, _ = make_pipeline_train_step(cfg, mesh, n_micro=n_micro,
                                           lr=1.0)
    new, loss = step1(params, windows[0])
    upd = leaf_updates(params, new, 1.0)
    del new
    loss1, g1 = grads_fn(cfg, params, windows[0])
    hold_step(f"GPipe pp {pp}", "pipeline step (update at lr 1) vs the "
              "one-device step", loss, upd, loss1, g1)
    del upd, g1
    torch.cuda.empty_cache()
    step, _, _ = make_pipeline_train_step(cfg, mesh, n_micro=n_micro,
                                          lr=SGD_LR)
    run = train_loop(f"GPipe pp {pp}", step, params, windows[1:], {})
    one = train_loop("one-device dense SGD (informational)",
                     lambda p, w: sgd_train_step(cfg, SGD_LR, p, w), params,
                     windows[1:], {}, must_fall=False)
    bubble = (pp - 1) / (n_micro + pp - 1)
    log(f"[pipeline] GPipe pp {pp}, n_micro {n_micro}, batch "
        f"{PIPE_RUN['batch']}: step {run['step_ms']:.1f} ms against the "
        f"one-device step's {one['step_ms']:.1f} ms "
        f"({run['step_ms'] / one['step_ms']:.2f}x; the bubble is "
        f"{pp - 1}/{n_micro + pp - 1} = {bubble:.3f} of the "
        f"{(n_micro + pp - 1) * pp} stage passes, computed on the one "
        f"card); peak memory {run['peak_gb']:.2f} GB against "
        f"{one['peak_gb']:.2f} GB; on {card}")
    del run["params"], one["params"], params
    torch.cuda.empty_cache()
    return {"step_ms": run["step_ms"], "one_ms": one["step_ms"],
            "bubble": bubble}


def ep_phase(data_path: str, card: str) -> dict:
    """23d: phase 19d's MoE model (MOE_MODEL, top-1, batch 8) on
    Mesh({"dp": 1, "ep": 4}): the SGD step (flash attention; lr 1, the
    update read off as p − p') held to the one-device step with the
    one-device pass's routing replayed (moe.PinnedChoices; STEP_LOSS_ATOL,
    STEP_LEAF_REL a leaf), EP_RUN steps of it timed with finite losses;
    then make_moe_optax_step(mesh, zero1=True) for EP_RUN steps bit-equal
    to zero1=False, at EP_RUN["optax_layers"] layers, on this mesh and on
    Mesh({"dp": 2, "ep": 2})."""
    import dataclasses
    import math

    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.moe import (MoEConfig, PinnedChoices,
                                             init_moe_params,
                                             make_moe_optax_step,
                                             make_moe_train_step,
                                             moe_loss_fn)
    from tpu_dra_torch.workloads.train import value_and_grad
    cfg = MoEConfig(**MOE_MODEL, router_top_k=1)
    mesh = Mesh({"dp": 1, "ep": 4})
    windows = window_batches(data_path, EP_RUN["batch"], cfg.max_seq,
                             EP_RUN["steps"] + 1)

    def init(c):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 25)
        return init_moe_params(c, gen)
    params = init(cfg)
    step1, _, _ = make_moe_train_step(cfg, mesh, lr=1.0, attn_impl="flash")
    with PinnedChoices() as pin:
        loss1, g1 = value_and_grad(
            lambda p, t: moe_loss_fn(cfg, p, t, "flash"), params,
            windows[0])
        pin.replay()
        (new, loss), launches = counted(lambda: step1(params, windows[0]))
    if pin.replayed != len(pin.recorded):
        fail(f"EP: the mesh step called the router {pin.replayed} times, "
             f"the one-device pass {len(pin.recorded)}")
    upd = leaf_updates(params, new, 1.0)
    del new
    hold_step("DP×EP ep 4", "expert-parallel step (update at lr 1) vs the "
              "one-device step, routing replayed", loss, upd, loss1, g1)
    del upd, g1
    torch.cuda.empty_cache()
    step, _, _ = make_moe_train_step(cfg, mesh, lr=SGD_LR, attn_impl="flash")
    run, part = counted(lambda: train_loop(
        "DP×EP MoE ep 4", step, params, windows[1:], {}, must_fall=False))
    add_counts(launches, part)
    tok_step = EP_RUN["batch"] * cfg.max_seq
    log(f"[ep] DP×EP MoE, ep 4 on one card: step {run['step_ms']:.1f} ms "
        f"(median of steps 2-{EP_RUN['steps']}; first "
        f"{run['first_ms']:.1f} ms), {tok_step / run['step_ms'] * 1e3:.0f} "
        f"tokens/s, peak memory {run['peak_gb']:.2f} GB; on {card}")
    step_ms = run["step_ms"]
    del run["params"], run, params
    gc.collect()
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, n_layers=EP_RUN["optax_layers"])
    for axes in ({"dp": 1, "ep": 4}, {"dp": 2, "ep": 2}):
        m = Mesh(axes)
        label = f"ep AdamW dp {axes['dp']} x ep {axes['ep']}"
        runs, part = optax_runs(
            lambda zero1: make_moe_optax_step(small, m, attn_impl="flash",
                                              zero1=zero1),
            lambda: init(small), windows[1:], label, card)
        add_counts(launches, part)
        if not all(math.isfinite(x) for x in runs[True][0]):
            fail(f"{label}: losses {runs[True][0]}")
        layout = runs[True][3].layout
        w1 = (layout.moment_specs["blocks"]["w1"] if layout else
              "the parameter's (no dp to cut over)")
        log(f"[{label}] the w1 moments' spec under ZeRO-1: {w1}")
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms}


def lora_mesh_phase(data_path: str, card: str) -> dict:
    """23e: phase 19c's LoRA step (the serving model, r = 8, flash, batch
    8) on Mesh({"dp": 2, "tp": 2}) against the one-device step from the
    same base, adapters and windows, LORA_MESH_RUN steps each: the mesh
    step is the one-device computation, so losses and adapters must be
    bit-equal."""
    import torch

    from tpu_dra_torch.workloads.lora import (LoRAConfig, init_lora,
                                              make_lora_train_step)
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 26)
    base = init_params(cfg, gen)
    windows = window_batches(data_path, LORA_MESH_RUN["batch"], cfg.max_seq,
                             LORA_MESH_RUN["steps"])
    out, launches = {}, {}
    for label, mesh in (("one device", None),
                        ("dp 2 x tp 2", Mesh({"dp": 2, "tp": 2}))):
        step, init_opt, lcfg, _ = make_lora_train_step(
            cfg, mesh, lcfg=LoRAConfig(rank=LORA_MESH_RUN["rank"]),
            attn_impl="flash")
        lg = torch.Generator(device="cuda")
        lg.manual_seed(SEED + 27)
        lora = init_lora(base, lcfg, lg)
        opt = init_opt(lora)

        def loop(lora=lora, opt=opt):
            losses = []
            for win in windows:
                lora, opt, loss = step(base, lora, opt, win)
                losses.append(float(loss))
            return losses, lora
        out[label], part = counted(loop, gqa=True)
        add_counts(launches, part)
        log(f"[lora] {label}: losses {out[label][0]}")
    (la, ra), (lb, rb) = out["one device"], out["dp 2 x tp 2"]
    same = la == lb and same_trees(ra, rb)
    log(f"[lora] the dp 2 x tp 2 step against the one-device step: losses "
        f"and adapters bit-equal: {same}; on {card}")
    if not same:
        fail("LoRA over dp 2 x tp 2 departs from the one-device step")
    del base, out
    torch.cuda.empty_cache()
    return {"launches": launches}


def serving_shardings_phase(card: str) -> dict:
    """23f: the phase-16 int8 tree and an int4 tree of the serving model
    (fp32 weights from the seed) cut by quant.serving_param_shardings on
    Mesh({"dp": 1, "tp": 4}) and put back: every leaf equal to the
    original, dtype, shape and value; greedy decode of phase 4's prompts
    (MESH_DECODE_STEPS steps, one ragged batch on the slab) from the
    round-tripped tree equal to the original tree's tokens."""
    import torch

    from tpu_dra_torch.workloads.decode import decode_ragged
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.quant import (quantize_params_int4,
                                               quantize_params_int8,
                                               serving_param_shardings)
    from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                               tree_leaves)
    cfg = ModelConfig(**MODEL)
    mesh = Mesh({"dp": 1, "tp": 4})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    prompts = request_prompts(cfg.vocab)
    S = max(len(p) for p in prompts)
    batch = torch.tensor([p + [0] * (S - len(p)) for p in prompts],
                         device="cuda")
    lengths = torch.tensor([len(p) for p in prompts], device="cuda")

    def round_trip(tree, specs):
        if isinstance(tree, dict):
            return {k: round_trip(tree[k], specs[k]) for k in tree}
        return mesh.unshard(mesh.shard(tree, specs), specs)
    for form, quant in (("int8", quantize_params_int8),
                        ("int4", quantize_params_int4)):
        tree = quant(params)
        specs = serving_param_shardings(cfg, mesh, tree)
        back = round_trip(tree, specs)
        n_leaves = 0
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            n_leaves += 1
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not torch.equal(a, b):
                fail(f"serving shardings {form}: a {tuple(a.shape)} "
                     f"{a.dtype} leaf changed through shard/unshard")
        with torch.no_grad():
            want = decode_ragged(cfg, tree, batch, lengths,
                                 steps=MESH_DECODE_STEPS)
            got = decode_ragged(cfg, back, batch, lengths,
                                steps=MESH_DECODE_STEPS)
        if not torch.equal(got, want):
            fail(f"serving shardings {form}: the round-tripped tree's "
                 f"tokens differ")
        log(f"[serve-mesh] {form}: {n_leaves} leaves through their specs "
            f"on tp 4 and back, equal; wqkv {specs['blocks']['wqkv']}; "
            f"greedy tokens of {len(prompts)} prompts x "
            f"{MESH_DECODE_STEPS} steps equal to the original tree's; on "
            f"{card}")
        del tree, back
    del params
    torch.cuda.empty_cache()
    return {}


def mesh_phase(data_path: str, card: str) -> dict:
    """Phase 23 (a-g); each sub-phase's seconds printed.  Returns the
    launches of every kernel over the phase's paths."""
    import torch

    from tpu_dra_torch.entry import dryrun_multichip
    launches: dict = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 23)
    zig = {}
    for label, *shape in ZIGZAG_CASES:
        zig[label] = zigzag_case(gen, label, *shape, card=card)
        add_counts(launches, zig[label]["launches"])
    log(f"[time] phase 23a {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero1 = zero1_phase(data_path, card)
    add_counts(launches, zero1["launches"])
    log(f"[time] phase 23b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    piped = pipeline_phase(data_path, card)
    log(f"[time] phase 23c {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ep = ep_phase(data_path, card)
    add_counts(launches, ep["launches"])
    log(f"[time] phase 23d {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(launches, lora_mesh_phase(data_path, card)["launches"])
    log(f"[time] phase 23e {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving_shardings_phase(card)
    log(f"[time] phase 23f {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    report, part = counted(lambda: dryrun_multichip(4))
    add_counts(launches, part)
    log(f"[dryrun] dryrun_multichip(4) launches {part}; strategies "
        f"{sorted(report['strategies'])}")
    log(f"[time] phase 23g {time.perf_counter() - t0:.1f} s")
    log(f"[mesh] phase 23 launches {launches}")
    return {"launches": launches, "zigzag": zig, "zero1": zero1,
            "pipeline": piped, "ep": ep, "dryrun": report}


# ---------------------------------------------------------------------------
# phase 24: the captured chunk and speculative pass, and the retrace guard
# ---------------------------------------------------------------------------

GRAPH_CHUNKS = 4             # passes compared graphed against eager
GRAPH_TRACE_CHUNKS = 4       # passes timed by the host clock, each kind
GRAPH_DRAFT_LAYERS = 2       # the truncated draft of the speculative pass


def idle_engine(cfg, params, kw: dict):
    """A ContinuousEngine whose batcher has been stopped, so the phase
    drives its admission and passes from this thread alone."""
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    eng = ContinuousEngine(cfg, params, **kw)
    eng.shutdown()
    return eng


def admit_all(eng, prompts: list, steps: list) -> None:
    """Admit greedy requests straight into the stopped engine's slots."""
    from tpu_dra_torch.workloads.continuous import _Request
    for prompt, st in zip(prompts, steps):
        eng._pending.append(_Request(prompt=list(prompt), steps=st,
                                     eos_id=None, temperature=0.0, seed=0))
    eng._admit()
    live = sum(r is not None for r in eng._requests)
    if live != len(prompts):
        fail(f"graph phase: {live} of {len(prompts)} requests admitted")


def engine_state_refs(eng) -> list:
    """Every tensor a pass writes: the slot state and the caches."""
    trees = [eng._token, eng._pos, eng._done, eng._cache]
    if eng.draft is not None:
        trees.append(eng._dcache)
    out = []
    for tree in trees:
        out += list(tree.values()) if isinstance(tree, dict) else [tree]
    return out


def engine_state(eng) -> list:
    return [t.clone() for t in engine_state_refs(eng)]


def restore_state(eng, saved: list) -> None:
    for t, v in zip(engine_state_refs(eng), saved):
        t.copy_(v)


def step_logits(eng, token, pos):
    """One decode step of ``eng``'s model in its layout (the chunk's)."""
    from tpu_dra_torch.workloads.decode import _token_logits
    from tpu_dra_torch.workloads.paged_kv import _paged_step
    if eng.pool is not None:
        return _paged_step(eng.cfg, eng.params, eng._cache, token, pos,
                           eng._table)[1]
    return _token_logits(eng.cfg, eng.params, eng._cache, pos, token)[0]


def eager_logits_at(eng, step: int):
    """The eager chunk's logits at ``step`` from the engine's state (the
    state and caches are written; the caller restores them)."""
    import torch
    token, pos, done = eng._token.clone(), eng._pos.clone(), \
        eng._done.clone()
    for _ in range(step + 1):
        logits = step_logits(eng, token, pos)
        nxt = torch.argmax(eng._biased(logits), dim=-1).to(torch.int32)
        nxt = torch.where(done, token, nxt)
        pos = pos + (~done).to(torch.int32)
        done = done | (nxt == eng._eos)
        token = nxt
    return logits.float()


def step_graph_gap(eng) -> tuple:
    """One decode step captured in a CUDA graph against the same step
    run eagerly on the same state: (largest logit gap, rows whose argmax
    differs, and each such row's eager top-2 margin and tolerance)."""
    import torch
    saved = engine_state(eng)
    eager = step_logits(eng, eng._token, eng._pos).float().clone()
    restore_state(eng, saved)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_logits(eng, eng._token, eng._pos)
    torch.cuda.current_stream().wait_stream(side)
    restore_state(eng, saved)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = step_logits(eng, eng._token, eng._pos)
    graph.replay()
    got = out.float().clone()
    restore_state(eng, saved)
    del graph
    gap = float((got - eager).abs().max())
    rows = (got.argmax(-1) != eager.argmax(-1)).nonzero()[:, 0].tolist()
    ties = []
    for r in rows:
        top2 = torch.topk(eager[r], 2).values.tolist()
        ties.append((r, top2[0] - top2[1], argmax_tol(top2[0])))
    return gap, rows, ties


def compare_passes(label: str, eng, kind: str) -> dict:
    """GRAPH_CHUNKS passes of ``kind`` ("chunk" or "spec"), each run
    eagerly and then, from the same state, as the replay of its captured
    program: the tokens (and counts) must be equal and the caches the
    passes wrote identical, or a differing chunk row must depart at an
    eager near-tie (the phase-20 rule).  Returns the largest cache gap
    and the rows that departed."""
    import torch
    body = eng._chunk_body if kind == "chunk" else eng._spec_body
    departed, cache_gap = 0, 0.0
    for c in range(GRAPH_CHUNKS):
        saved = engine_state(eng)
        want = body().clone()
        want_state = engine_state(eng)
        restore_state(eng, saved)
        got = eng._graphed(kind, body).clone()
        got_state = engine_state(eng)
        torch.cuda.synchronize()
        if torch.equal(got, want):
            for a, b in zip(got_state, want_state):
                cache_gap = max(cache_gap, float(
                    (a.float() - b.float()).abs().max()))
            continue
        if kind != "chunk":
            rows = (got != want).any(1).nonzero()[:, 0].tolist()
            fail(f"{label}: the captured {kind} pass {c} differs from the "
                 f"eager one in rows {rows[:8]}")
        for r in (got != want).any(1).nonzero()[:, 0].tolist():
            j = int((got[r] != want[r]).nonzero()[0, 0])
            restore_state(eng, saved)
            lg = eager_logits_at(eng, j)[r]
            top2 = torch.topk(lg, 2).values.tolist()
            margin, tol = top2[0] - top2[1], argmax_tol(top2[0])
            log(f"[{label}] pass {c}, row {r}: the captured chunk departs "
                f"at step {j}, eager top-2 margin {margin:.4f} (tolerance "
                f"{tol:.4f})")
            if margin > tol:
                fail(f"{label}: the captured chunk departs from the eager "
                     f"one at pass {c}, row {r}, step {j}, margin "
                     f"{margin:.4f} > {tol:.4f}")
            departed += 1
        # go on from the eager pass's state
        restore_state(eng, want_state)
    return {"cache_gap": cache_gap, "departed": departed}


def time_passes(label: str, eng, kind: str, card: str) -> dict:
    """GRAPH_TRACE_CHUNKS passes of ``kind`` eager and then graphed from
    the same state (host clock, synchronized, with the readback), and
    one traced pass of each under torch.profiler."""
    import torch
    body = eng._chunk_body if kind == "chunk" else eng._spec_body
    runs = {"eager": lambda: body().cpu(),
            "graphed": lambda: eng._graphed(kind, body).cpu()}
    saved = engine_state(eng)
    out = {}
    for name, run in runs.items():
        restore_state(eng, saved)
        run()                                    # warm (the capture)
        restore_state(eng, saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TRACE_CHUNKS):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / GRAPH_TRACE_CHUNKS
        restore_state(eng, saved)
        prof = profile_call(f"{label} {name} {kind} pass", run)
        out[name] = {"ms": ms, **prof}
    restore_state(eng, saved)
    e, g = out["eager"], out["graphed"]
    log(f"[{label}] a {kind} pass: eager {e['ms']:.2f} ms, graphed "
        f"{g['ms']:.2f} ms a pass (host clock with the readback, "
        f"{GRAPH_TRACE_CHUNKS} passes); traced: eager busy "
        f"{e.get('busy', 0) / 1e3:.2f} of {e.get('wall', 0) / 1e3:.2f} ms, "
        f"graphed busy {g.get('busy', 0) / 1e3:.2f} of "
        f"{g.get('wall', 0) / 1e3:.2f} ms; on {card}")
    return out


def guard_check(label: str, cfg, params, kw: dict, prompts: list,
                steps: list) -> dict:
    """An engine with the retrace guard on: warmup over every prompt
    bucket, then the mixed-length requests at once must capture nothing
    (recompiles_since_mark 0); a parameter leaf replaced instead of
    copied in place is a recapture the guard counts (1).  Returns the
    paged-attention launches of the mixed load."""
    import torch

    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    from tpu_dra_torch.workloads.paged_kv import paged_attention
    from tpu_dra_torch.workloads.retrace_guard import ENV_FLAG
    os.environ[ENV_FLAG] = "1"
    try:
        eng = ContinuousEngine(cfg, params, **kw)
    finally:
        del os.environ[ENV_FLAG]
    try:
        t0 = time.perf_counter()
        warmed = eng.warmup()
        warm_s = time.perf_counter() - t0
        before = paged_attention.launches
        reqs = [eng.submit_async(p, st) for p, st in zip(prompts, steps)]
        for r in reqs:
            if not r.done.wait(600) or r.error:
                fail(f"{label}: a request failed: {r.error}")
        launches = paged_attention.launches - before
        st = eng.stats()
        log(f"[{label}] warmup of {warmed} buckets in {warm_s:.1f} s, then "
            f"{len(reqs)} requests of {min(map(len, prompts))}-"
            f"{max(map(len, prompts))} tokens: recompiles_since_mark "
            f"{st['recompiles_since_mark']}, compile_cache_entries "
            f"{st['compile_cache_entries']}, jit_callables_tracked "
            f"{st['jit_callables_tracked']}, {st['decode_steps']} decode "
            f"steps, {launches} paged-attention launches")
        if st["recompiles_since_mark"] != 0 or \
                st["jit_callables_tracked"] != 1:
            fail(f"{label}: steady state captured again: {st}")
        want = cfg.n_layers * st["decode_steps"] if eng.pool else 0
        if launches != want:
            fail(f"{label}: paged attention launched {launches} times, "
                 f"{want} wanted")
        with torch.no_grad():
            eng.params["ln_f"] = eng.params["ln_f"].clone()
        eng.submit(prompts[0], 4, timeout=600)
        control = eng.stats()["recompiles_since_mark"]
        log(f"[{label}] control: a parameter leaf replaced instead of "
            f"copied in place, then one request: recompiles_since_mark "
            f"{control}")
        if control != 1:
            fail(f"{label}: the control recapture counted {control}, not 1")
        return {"launches": launches, "stats": st}
    finally:
        eng.shutdown()


def graph_phase(card: str) -> dict:
    """Phase 24: the int8 headline engine (phase 16's model and engines,
    32 slots) in both layouts: the captured greedy chunk and speculative
    pass (a truncated 2-layer draft) held to the eager ones on the same
    state, one step's logits captured against eager, the retrace guard
    through warmup and a mixed load and its control, one traced pass of
    each kind eager and graphed, then section_continuous and
    section_paged."""
    import numpy as np
    import torch

    from tpu_dra_torch.bench import LOAD, section_continuous, section_paged
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.spec_draft import truncate_draft
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 24)
    fparams = init_params(cfg, gen)
    dcfg, dfloat = truncate_draft(cfg, fparams, GRAPH_DRAFT_LAYERS)
    params = quantize_params_int8(fparams)
    dparams = quantize_params_int8(dfloat)
    del fparams, dfloat
    slots = ENGINE["slots"]
    n = len(LOAD["lengths"])
    rng = np.random.default_rng(SEED + 24)
    prompts = [rng.integers(0, cfg.vocab, LOAD["lengths"][i % n]).tolist()
               for i in range(slots)]
    steps = [LOAD["steps"][i % n] for i in range(slots)]
    out: dict = {"launches": 0}
    layouts = {"slab": dict(slots=slots, chunk=8, kv_layout="slab"),
               "paged": dict(ENGINE)}
    with torch.no_grad():
        for layout, kw in layouts.items():
            label = f"graph {layout}"
            eng = idle_engine(cfg, params, kw)
            admit_all(eng, prompts, steps)
            gap, rows, ties = step_graph_gap(eng)
            log(f"[{label}] one decode step at {slots} slots captured "
                f"against eager: largest logit gap {gap:.3e}, argmax rows "
                f"differing {rows}")
            for r, margin, tol in ties:
                if margin > tol:
                    fail(f"{label}: captured step row {r} departs at margin "
                         f"{margin:.4f} > {tol:.4f}")
            cmp = compare_passes(label, eng, "chunk")
            log(f"[{label}] {GRAPH_CHUNKS} chunks of 8 at {slots} slots: the "
                f"captured chunk's tokens equal the eager chunk's "
                f"({cmp['departed']} rows departed at near-ties), largest "
                f"state and cache gap {cmp['cache_gap']:.3e}")
            timed = time_passes(label, eng, "chunk", card)
            out[layout] = {"step_gap": gap, "compare": cmp, "timed": timed}
            del eng
            spec_kw = dict(kw, draft=(dcfg, dparams))
            if layout == "paged":
                spec_kw["total_pages"] = 2 * ENGINE["total_pages"]
            eng = idle_engine(cfg, params, spec_kw)
            admit_all(eng, prompts, steps)
            scmp = compare_passes(f"{label} spec", eng, "spec")
            log(f"[{label} spec] {GRAPH_CHUNKS} speculative passes (draft "
                f"{GRAPH_DRAFT_LAYERS} layers, chunk 8) at {slots} slots: "
                f"the captured pass's tokens and counts equal the eager "
                f"pass's, largest state and cache gap "
                f"{scmp['cache_gap']:.3e}")
            out[layout]["spec_timed"] = time_passes(f"{label} spec", eng,
                                                    "spec", card)
            del eng
            torch.cuda.empty_cache()
            guard = guard_check(f"graph {layout} guard", cfg, params, kw,
                                prompts, steps)
            out["launches"] += guard["launches"]
            out[layout]["guard"] = guard["stats"]
    for name, section in (("continuous", section_continuous),
                          ("paged", section_paged)):
        got = section()
        keys = ("tokens_per_s", "req_p50_ms", "req_p95_ms",
                "spec_ceiling_tokens_per_s")
        log(f"[bench] section_{name}: " + ", ".join(
            f"{k} {got.get(f'{name}_{k}')}" for k in keys)
            + f"; on {card}")
        out[f"section_{name}"] = got
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 25: the multi-process host side on one card
# ---------------------------------------------------------------------------

PSUM_MIB = 2                 # psum_job's buffers a process (gloo, host)
MP_WAIT = 300                # seconds a child process may take


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra) -> dict:
    """This environment without rendezvous or device variables of its
    own, the checkout on PYTHONPATH, and ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "JAX_", "SLICE_", "MEGASCALE_"))}
    env["PYTHONPATH"] = str(HERE)
    env.update(extra)
    return env


def write_nodes(path: Path, members: list, generation: int = 0) -> None:
    """A slice daemon's nodes_config.json: ``members`` (name, ip) in rank
    order, written whole (readers never see half a file)."""
    data = {"nodes": [{"name": n, "ipAddress": ip, "workerID": i, "rank": i}
                      for i, (n, ip) in enumerate(members)]}
    if generation:
        data["generation"] = generation
    tmp = path / "nodes_config.json.tmp"
    tmp.write_text(json.dumps(data))
    os.replace(tmp, path / "nodes_config.json")


def psum_pair(tmp: Path, card: str) -> list:
    """``psum_job --backend gloo`` as two processes of one domain, their
    triple resolved from a settings dir (127.0.0.1 and 127.0.0.2): both
    must print n_devices 2, the same all_reduce sum (3, on the card) and
    the four bandwidths."""
    write_nodes(tmp, [("n0", "127.0.0.1"), ("n1", "127.0.0.2")])
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_dra_torch.workloads.psum_job",
         "--mib", str(PSUM_MIB), "--backend", "gloo"],
        env=child_env(SLICE_DOMAIN_UUID="chip-smoke",
                      SLICE_SETTINGS_DIR=str(tmp), POD_IP=ip,
                      JAX_COORDINATOR_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for ip in ("127.0.0.1", "127.0.0.2")]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=MP_WAIT)
            if p.returncode != 0:
                fail(f"psum_job exited {p.returncode}: {out[-1500:]}")
            lines = out.strip().splitlines()
            said = [ln for ln in lines
                    if ln.startswith(("rendezvous", "devices"))]
            log(f"[mp] psum_job: {' | '.join(said)}")
            outs.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    keys = {"psum_gbps", "ppermute_gbps", "all_gather_gbps",
            "reduce_scatter_gbps"}
    for o in outs:
        if o.get("n_devices") != 2 or o.get("allreduce_sum") != 3.0 or \
                not keys <= set(o):
            fail(f"psum_job printed {o}")
    log(f"[mp] psum_job, two processes through a settings dir, gloo: "
        f"{outs[0]} and {outs[1]} (buffers of {PSUM_MIB} MiB in host "
        f"memory over loopback TCP: no card-to-card figure; the all_reduce "
        f"check on a tensor on the card); on {card}")
    return outs


ELASTIC_CHILD = """
import json, os, sys
from tpu_dra_torch.workloads.launcher import resolve
info = resolve()
with open(sys.argv[1], "a") as f:
    f.write(json.dumps({"generation": os.environ["TPU_ELASTIC_GENERATION"],
                        "world": info.num_processes,
                        "rank": info.process_id}) + "\\n")
sys.exit(75 if info.num_processes == 1 else 0)
"""


def elastic_respawn(tmp: Path) -> list:
    """run_elastic over a worker that resolves its membership and exits
    for reconfiguration while it is alone: the domain grows from 1 to 2
    members while the first worker runs, and the respawned worker must
    carry generation 2 and see a world of 2."""
    from tpu_dra_torch.workloads.elastic import run_elastic
    runs = tmp / "runs.jsonl"
    write_nodes(tmp, [("n0", "127.0.0.1")], generation=1)

    def on_spawn(proc, epoch):
        if epoch.generation == 1:
            proc.wait(timeout=MP_WAIT)
            write_nodes(tmp, [("n0", "127.0.0.1"), ("n1", "127.0.0.2")],
                        generation=2)

    t0 = time.perf_counter()
    rc = run_elastic([sys.executable, "-c", ELASTIC_CHILD, str(runs)],
                     env=child_env(SLICE_DOMAIN_UUID="chip-smoke",
                                   SLICE_SETTINGS_DIR=str(tmp),
                                   POD_IP="127.0.0.1"),
                     poll=0.1, member_timeout=MP_WAIT,
                     reconfigure_grace=30.0, on_spawn=on_spawn)
    lines = [json.loads(ln) for ln in runs.read_text().splitlines()]
    log(f"[mp] run_elastic: rc {rc} after {time.perf_counter() - t0:.1f} "
        f"s, workers {lines}")
    if rc != 0 or [(r["generation"], r["world"]) for r in lines] != \
            [("1", 1), ("2", 2)]:
        fail(f"run_elastic: rc {rc}, workers {lines}")
    return lines


SECTION_CHILD = """
import functools, json, sys
import torch
import torch.distributed as dist
from tpu_dra_torch import bench
from tpu_dra_torch.workloads import collectives as c
rank, port, mib = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
torch.cuda.set_device(0)
for name in ("psum_bandwidth", "ppermute_bandwidth", "all_gather_bandwidth",
             "reduce_scatter_bandwidth"):
    setattr(c, name, functools.partial(getattr(c, name), mib_per_device=mib,
                                       iters=8))
print(json.dumps(bench.section_collectives()), flush=True)
dist.destroy_process_group()
"""
COLLECTIVE_MATMUL_KEYS = [
    f"{name}_{key}" for name in ("ag_matmul", "matmul_rs")
    for key in ("fused_tflops", "xla_tflops", "overlap_win_pct")]


def collectives_pair(card: str) -> list:
    """``bench.section_collectives`` in two gloo processes on the card
    (bandwidth buffers of PSUM_MIB, 8 iterations: psum_job measures them
    already): each must print the four bandwidths
    and the fused collective-matmul keys, and no
    ``collective_matmul_error``."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", SECTION_CHILD, str(r), port, str(PSUM_MIB)],
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=HERE) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=MP_WAIT)
            if p.returncode != 0:
                fail(f"section_collectives child exited {p.returncode}: "
                     f"{out[-1500:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, o in enumerate(outs):
        if "collective_matmul_error" in o or not set(
                COLLECTIVE_MATMUL_KEYS) <= set(o):
            fail(f"section_collectives rank {r}: {o}")
        log(f"[mp] section_collectives rank {r} of two gloo processes on "
            f"the card: " + ", ".join(f"{k} {o[k]}" for k in (
                "psum_gbps", "ppermute_gbps", "all_gather_gbps",
                "reduce_scatter_gbps", *COLLECTIVE_MATMUL_KEYS,
                "collective_matmul_shape"))
            + f" (fused: ProcessRing's kernels; xla: a group all-gather "
            f"then a matmul, a matmul then a group reduce-scatter, through "
            f"host memory; host clock, synced; informational); on {card}")
    return outs


def multiprocess_phase(card: str) -> dict:
    """Phase 25: psum_job as two gloo processes through a settings dir,
    run_elastic across a 1 -> 2 membership change, and
    section_collectives in this process (no group: skipped) and in two
    gloo processes (the fused collective-matmul comparison)."""
    from tpu_dra_torch.bench import section_collectives
    with tempfile.TemporaryDirectory(prefix="chip_smoke-25-") as tmp:
        psum = psum_pair(Path(tmp), card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-25-") as tmp:
        elastic = elastic_respawn(Path(tmp))
    skipped = section_collectives()
    log(f"[mp] section_collectives on one card: {skipped}")
    if skipped != {"collectives_skipped": "single device"}:
        fail(f"section_collectives on one card gave {skipped}")
    pair = collectives_pair(card)
    return {"psum": psum, "elastic": elastic, "collectives": pair}


# ---------------------------------------------------------------------------
# phase 26: the ring kernels and the DP×SP step across processes on one card
# ---------------------------------------------------------------------------

PROCESSES = 4                # 26's group: one process a rank, all on cuda:0
PROCESS_WAIT = 600           # seconds the group may take
# 26a: (label, m, K, N) of the gathers a rank: the wqkv shard at tp 4 (m
# even: bidirectional at n = 4) and one row short (m odd: unidirectional);
# the reduce-scatter at w2 (x [16384, 2048] a rank); the k/v block
PROCESS_AG = [("wqkv, m even", 4096, 2048, 1536),
              ("wqkv, m odd", 4095, 2048, 1536)]
PROCESS_RS = ("w2", 16384, 2048, 2048)
PROCESS_KV = (16, 16, 256, 128)
PROCESS_TIMED = 3            # calls timed a case (CUDA events, median)
# 26b and 27b: SGD steps after the one-step comparisons (2, not 3, keeps
# the script inside its time limit with phase 27)
PROCESS_STEPS = 2
# 26b, 27a-b and 28a-b: the flagship's widths at this depth.  At its 8
# layers a gloo psum of the fp32 gradients took about 6 s a step and the
# group 322 s, past the script's time limit with phases 1-25 (H100 80GB
# HBM3, 700 W)
PROCESS_LAYERS = 2
PROCESS_MODEL = dict(TRAIN_MODEL, n_layers=PROCESS_LAYERS)
PROCESS_CHILD = ("import sys, chip_smoke; "
                 "sys.exit(chip_smoke.process_rank(sys.argv[1]))")


def same_bytes(label: str, got, want) -> None:
    """Fail unless ``got`` and ``want`` hold the same bits."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max()) \
            if got.shape == want.shape else float("nan")
        fail(f"{label}: not byte-equal (shapes {tuple(got.shape)} and "
             f"{tuple(want.shape)}, max abs difference {err})")


def call_ms(fn) -> float:
    """One call's time by CUDA events, median of PROCESS_TIMED (a
    process ring call neither synchronizes its stream nor meets its
    group: its kernel waits for the neighbours' kernels on flags, so the
    events span that wait)."""
    import torch
    times = []
    for _ in range(PROCESS_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def process_kernels(ring) -> dict:
    """26a in one process: each ring kernel through ``ring`` (this rank's
    shard of the global inputs drawn from one seed by every process)
    against rank r's slice of the virtual ring's kernel on the global
    inputs (byte-equal: y, a, the reduce-scatter's y, the shift, and
    each VJP's dx, dw) and against the group plain version (ELEM_TOL,
    ROW_TOL; copies byte-equal), with exact launch counts; then each
    call timed (informational)."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    n, r = ring.n, ring.rank
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 26 + n)
    counters = {"all_gather_matmul": cm.all_gather_matmul,
                "matmul_reduce_scatter": cm.matmul_reduce_scatter,
                "ring_shift": cm.ring_shift}
    total = dict.fromkeys(counters, 0)
    out = {"ms": {}, "err": {}}

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def counted(want: dict, fn):
        zero_counts(counters)
        got = fn()
        torch.cuda.synchronize()
        seen = read_counts(counters)
        if seen != {k: want.get(k, 0) for k in counters}:
            fail(f"process ring n {n} rank {r}: launches {seen}, expected "
                 f"{want}")
        for k, v in seen.items():
            total[k] += v
        return got

    def vjp(fn, args, cot):
        args = [a.detach().clone().requires_grad_() for a in args]
        y = fn(*args)
        return (y, *torch.autograd.grad(y, args, cot))

    for label, m, K, N in PROCESS_AG:
        x, w = ring_inputs(gen, 1, n, m, K, N)
        cot = draw(1, n, n * m, N)
        vy, va = cm.all_gather_matmul(x, w)
        _, vdx, vdw = vjp(cm.AllGatherMatmul.apply, (x, w.contiguous()), cot)
        xr, wr = x[0, r].contiguous(), w[0, r].contiguous()
        tag = f"all_gather_matmul {label}, n {n}, rank {r}"
        y, a = counted({"all_gather_matmul": 1},
                       lambda: ring.all_gather_matmul(xr, wr))
        yf, dx, dw = counted(
            {"all_gather_matmul": 1, "matmul_reduce_scatter": 1},
            lambda: vjp(lambda u, v: cm.ProcessAllGatherMatmul.apply(
                ring, u, v), (xr, wr), cot[0, r]))
        for name, got, want in (("y", y, vy[0, r]), ("a", a, va[0, r]),
                                ("VJP y", yf, vy[0, r]),
                                ("dx", dx, vdx[0, r]), ("dw", dw, vdw[0, r])):
            same_bytes(f"{tag}: {name} against the virtual ring", got, want)
        py, pa = ring.all_gather_matmul_ref(xr, wr)
        out["err"][f"ag {label}"] = hold_ring(f"{tag} vs the group plain "
                                              f"version", y, py)[0]
        same_bytes(f"{tag}: a against the group plain version", a, pa)
        out["ms"][f"all_gather_matmul {label}"] = call_ms(
            lambda: ring.all_gather_matmul(xr, wr))
        del x, w, cot, vy, va, vdx, vdw, y, a, yf, dx, dw, py, pa
    label, rows, K, N = PROCESS_RS
    x, w = ring_inputs(gen, 1, n, rows, K, N)
    cot = draw(1, n, rows // n, N)
    vy = cm.matmul_reduce_scatter(x, w)
    _, vdx, vdw = vjp(cm.MatmulReduceScatter.apply, (x, w.contiguous()), cot)
    xr, wr = x[0, r].contiguous(), w[0, r].contiguous()
    tag = f"matmul_reduce_scatter {label}, n {n}, rank {r}"
    y = counted({"matmul_reduce_scatter": 1},
                lambda: ring.matmul_reduce_scatter(xr, wr))
    yf, dx, dw = counted(
        {"matmul_reduce_scatter": 1, "all_gather_matmul": 1},
        lambda: vjp(lambda u, v: cm.ProcessMatmulReduceScatter.apply(
            ring, u, v), (xr, wr), cot[0, r]))
    for name, got, want in (("y", y, vy[0, r]), ("VJP y", yf, vy[0, r]),
                            ("dx", dx, vdx[0, r]), ("dw", dw, vdw[0, r])):
        same_bytes(f"{tag}: {name} against the virtual ring", got, want)
    out["err"][f"rs {label}"] = hold_ring(
        f"{tag} vs the group plain version", y,
        ring.matmul_reduce_scatter_ref(xr, wr))[0]
    out["ms"][f"matmul_reduce_scatter {label}"] = call_ms(
        lambda: ring.matmul_reduce_scatter(xr, wr))
    del x, w, cot, vy, vdx, vdw, y, yf, dx, dw
    kv = draw(1, n, *PROCESS_KV)
    cot = draw(1, n, *PROCESS_KV)
    for reverse in (False, True):
        way = "left" if reverse else "right"
        tag = f"ring_shift {way}, n {n}, rank {r}"
        vs = cm.ring_shift(kv, reverse)
        kvv = kv.clone().requires_grad_()
        (vdx,) = torch.autograd.grad(cm.RingShift.apply(kvv, reverse), kvv,
                                     cot)
        mine = kv[0, r].contiguous()
        got = counted({"ring_shift": 1},
                      lambda: ring.ring_shift(mine, reverse))
        sf, dx = counted({"ring_shift": 2}, lambda: vjp(
            lambda u: cm.ProcessRingShift.apply(ring, reverse, False, u)[0],
            (mine,), cot[0, r]))
        for name, g, want in (("out", got, vs[0, r]), ("VJP out", sf, vs[0, r]),
                              ("dx", dx, vdx[0, r])):
            same_bytes(f"{tag}: {name} against the virtual ring", g, want)
        same_bytes(f"{tag}: against the group plain version", got,
                   ring.ring_shift_ref(mine, reverse))
        out["ms"][f"ring_shift {way}"] = call_ms(
            lambda: ring.ring_shift(mine, reverse))
    out["back_to_back"] = process_back_to_back(ring, gen)
    out["launches"] = total
    gc.collect()
    torch.cuda.empty_cache()          # the card is shared by the processes
    return out


def process_back_to_back(ring, gen) -> float:
    """26a's last check: PROCESS_BACK_TO_BACK gathers (m even and odd in
    turn) and as many reduce-scatters through ``ring``, enqueued with no
    host synchronize and no group barrier between them, each on global
    inputs of its own (drawn alike by every process); then every output
    byte-equal to this rank's slice of the virtual ring's kernels on the
    same inputs.  Returns the seconds the calls took to enqueue."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    n, r = ring.n, ring.rank
    m, k, n_out = 512, 1024, 768
    calls = []
    t0 = time.perf_counter()
    for i in range(PROCESS_BACK_TO_BACK):
        x, w = ring_inputs(gen, 1, n, m - i % 2, k, n_out)
        calls.append((x, w, ring.all_gather_matmul(x[0, r].contiguous(),
                                                   w[0, r].contiguous())))
        xr, wr = ring_inputs(gen, 1, n, n * m, k, n_out)
        calls.append((xr, wr, ring.matmul_reduce_scatter(
            xr[0, r].contiguous(), wr[0, r].contiguous())))
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    for i, (x, w, got) in enumerate(calls):
        tag = f"back to back call {i // 2}, n {n}, rank {r}"
        if isinstance(got, tuple):
            vy, va = cm.all_gather_matmul(x, w)
            same_bytes(f"all_gather_matmul {tag}: y", got[0], vy[0, r])
            same_bytes(f"all_gather_matmul {tag}: a", got[1], va[0, r])
        else:
            same_bytes(f"matmul_reduce_scatter {tag}: y", got,
                       cm.matmul_reduce_scatter(x, w)[0, r])
    del calls
    return enqueued


def process_step(tmp: Path, mesh) -> dict:
    """26b in one process: the flagship's DP×SP ring-flash step on the
    process mesh dp 1 × sp 4, hop_impl="pallas" against "xla" (bit-equal)
    at lr 1; rank 0 holds it to the virtual mesh's step that the parent
    saved (loss within STEP_LOSS_ATOL, each leaf's update within
    STEP_LEAF_REL); then PROCESS_STEPS steps at SGD_LR with finite,
    falling losses and exact launch counts for this rank: 6·(n − 1)·L
    shifts, 2·(idx + 1)·L flash forwards and (idx + 1)·L of each backward
    kernel a step (the reference's per-device ``lax.cond`` folds the block
    of step t only where t ≤ idx); one gloo psum of the gradients' size
    timed (informational)."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                               tree_leaves)
    cfg = ModelConfig(**PROCESS_MODEL)
    n, L = mesh.axis_size("sp"), cfg.n_layers
    idx = mesh.axis_index("sp")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2600)
    params = init_params(cfg, gen)
    wins = [w.to(mesh.device) for w in torch.load(tmp / "windows.pt")]
    win = wins[0]
    res = {}
    for hop in ("pallas", "xla"):
        step, _ = make_ring_train_step(cfg, mesh, lr=1.0, ring_impl="flash",
                                       hop_impl=hop)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[hop] = step(params, win[:, :-1], win[:, 1:])
        torch.cuda.synchronize()
        res[hop + "_s"] = time.perf_counter() - t0
    (pp, lp), (px, lx) = res["pallas"], res["xla"]
    same = float(lp) == float(lx) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(pp), tree_leaves(px)))
    log(f"[mp26] rank {idx}: DP×SP across processes, hop_impl=\"pallas\" "
        f"vs \"xla\": loss {float(lp)!r} vs {float(lx)!r}; bit-equal: "
        f"{same}; one step {res['pallas_s']:.2f} s (the shift kernel) and "
        f"{res['xla_s']:.2f} s (send and receive through host memory)")
    if not same:
        fail(f"rank {idx}: the shift kernel's step across processes is not "
             f"bit-equal to the send and receive's")
    del px, res
    if idx == 0:
        want = torch.load(tmp / "virtual.pt", map_location=mesh.device)
        hold_step(f"DP×SP across {n} processes", "rank 0's step (update at "
                  "lr 1) vs the virtual mesh's", lp,
                  leaf_updates(params, pp, 1.0), want["loss"], want["upd"])
        del want
    del pp
    gc.collect()
    torch.cuda.empty_cache()
    step, _ = make_ring_train_step(cfg, mesh, lr=SGD_LR, ring_impl="flash",
                                   hop_impl="pallas")
    counters = {"ring_shift": cm.ring_shift, **flash_counters()}
    run = train_loop(f"DP×SP across processes, rank {idx}",
                     lambda p, w: step(p, w[:, :-1], w[:, 1:]), params,
                     wins[1:], counters)
    want = {"ring_shift": 6 * (n - 1) * L * PROCESS_STEPS,
            **flash_want((idx + 1) * L * PROCESS_STEPS)}
    if run["launches"] != want:
        fail(f"DP×SP across processes, rank {idx}: launches "
             f"{run['launches']}, expected {want}")
    flat = torch.zeros(sum(t.numel() for t in tree_leaves(params)),
                       device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh.psum(flat)
    psum_s = time.perf_counter() - t0
    del run["params"], params, flat
    return {"launches": run["launches"], "losses": run["losses"],
            "step_ms": run["step_ms"], "first_ms": run["first_ms"],
            "peak_gb": run["peak_gb"], "psum_ms": 1e3 * psum_s}


# ---------------------------------------------------------------------------
# phase 27: the DP×TP step across processes (tp 4) on one card, in 26's group
# ---------------------------------------------------------------------------

TP_DENSE_LAYERS = 2          # 27c: the dense step's depth (its gloo psums)
TP_SEED = SEED + 2700


def tp_cfgs() -> dict:
    """27's configurations: the flagship for the fused step, and the
    flagship cut to TP_DENSE_LAYERS layers for the dense one."""
    from tpu_dra_torch.workloads.train import ModelConfig
    return {"fused_collective": ModelConfig(**PROCESS_MODEL),
            "dense": ModelConfig(**dict(TRAIN_MODEL,
                                        n_layers=TP_DENSE_LAYERS))}


def tp_params(cfg):
    import torch

    from tpu_dra_torch.workloads.train import init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_SEED)
    return init_params(cfg, gen)


def virtual_tp_steps(tmp: Path) -> None:
    """27's yardsticks, in this process before the group starts: the
    fused and the dense step on the virtual mesh dp 1 × tp 4 (lr 1,
    flash attention, the first of 26's windows), each saved as its loss
    and each leaf's update."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import make_sharded_train_step
    win = torch.load(tmp / "windows.pt")[0].to("cuda")
    for impl, cfg in tp_cfgs().items():
        params = tp_params(cfg)
        step, _, _ = make_sharded_train_step(
            cfg, Mesh({"dp": 1, "tp": PROCESSES}), lr=1.0,
            attn_impl="flash", matmul_impl=impl)
        new, loss = step(params, win)
        upd = leaf_updates(params, new, 1.0)
        del new, params
        torch.save({"loss": float(loss), "upd": tree_to(upd, "cpu")},
                   tmp / f"tp_{impl}.pt")
        del upd
        gc.collect()
        torch.cuda.empty_cache()


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def hold_sharded_step(label: str, mesh, loss, upd: dict, want_loss,
                      want: dict, what: str = "one step at lr 1") -> None:
    """``hold_step`` over shards: each leaf's relative L2 from this rank's
    squared error and squared norm summed over the group (a leaf whole on
    every rank counts the same number of times in both), so no rank
    gathers the tree."""
    import torch

    from tpu_dra_torch.workloads.train import tree_leaves
    names = list(leaf_errors(upd, upd))          # the leaves' names
    got, ref = tree_leaves(upd), tree_leaves(want)
    sums = torch.stack([torch.stack([(g.float() - w.float()).square().sum(),
                                     w.float().square().sum()])
                        for g, w in zip(got, ref)])
    sums = mesh.psum(sums)
    errs = {n: (e / r) ** 0.5 for n, (e, r) in zip(names, sums.tolist())}
    worst = max(errs, key=errs.get)
    dl = abs(float(loss) - float(want_loss))
    log(f"[train] {label}: {what} vs the virtual mesh's: loss "
        f"{float(loss):.5f} vs {float(want_loss):.5f} (|d| {dl:.2e}, "
        f"tolerance {STEP_LOSS_ATOL}); worst leaf {worst} relative L2 "
        f"{errs[worst]:.3e} (tolerance {STEP_LEAF_REL}); median leaf "
        f"{statistics.median(errs.values()):.3e}")
    if not (dl <= STEP_LOSS_ATOL and errs[worst] <= STEP_LEAF_REL):
        fail(f"{label}: the step departs from the virtual mesh's (loss |d| "
             f"{dl}, leaf {worst} {errs[worst]})")


@contextlib.contextmanager
def tp_timers(more: dict | None = None):
    """Seconds spent in the process ring's kernel calls and in the mesh's
    gloo collectives while the block runs, and in each kind of ``more``
    (kind → ``[(owner, attribute name), ...]``), each call synchronized
    before and after (the wrappers add those syncs; informational)."""
    import torch

    from tpu_dra_torch.workloads import mesh as M
    from tpu_dra_torch.workloads.collective_matmul import ProcessRing
    spent = {"ring": 0.0, "gloo": 0.0, **dict.fromkeys(more or {}, 0.0)}
    saved = []

    def timed(owner, name, kind):
        real = getattr(owner, name)
        saved.append((owner, name, real))

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[kind] += time.perf_counter() - t0
        setattr(owner, name, call)
    for name in ("all_gather_matmul", "matmul_reduce_scatter"):
        timed(ProcessRing, name, "ring")
    for name in ("group_all_reduce", "group_all_gather",
                 "group_reduce_scatter", "group_all_to_all"):
        timed(M, name, "gloo")
    for kind, targets in (more or {}).items():
        for owner, name in targets:
            timed(owner, name, kind)
    try:
        yield spent
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def process_tp(tmp: Path, mesh) -> dict:
    """27 in one process (see the module's docstring): the fused step
    against the virtual mesh's, PROCESS_STEPS fused steps with exact
    launches, the step time, its ring and gloo shares and peak memory,
    then the dense step against the virtual mesh's."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.train import make_sharded_train_step
    n, r = mesh.axis_size("tp"), mesh.axis_index("tp")
    wins = [w.to(mesh.device) for w in torch.load(tmp / "windows.pt")]
    out = {}
    for impl, cfg in tp_cfgs().items():
        step, p_shard, _ = make_sharded_train_step(
            cfg, mesh, lr=1.0, attn_impl="flash", matmul_impl=impl)
        local = mesh.shard_tree(tp_params(cfg), p_shard)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, loss = step(local, wins[0])
        torch.cuda.synchronize()
        out[f"{impl}_one_s"] = time.perf_counter() - t0
        upd = leaf_updates(local, new, 1.0)
        del new
        want = torch.load(tmp / f"tp_{impl}.pt", mmap=True)
        want_upd = tree_to(mesh.shard_tree(want["upd"], p_shard),
                           mesh.device)
        label = "27a DP×TP fused collective" if impl != "dense" else \
            f"27c DP×TP dense, {cfg.n_layers} layers"
        hold_sharded_step(f"{label} across {n} processes, rank {r}", mesh,
                          loss, upd, want["loss"], want_upd)
        del upd, want, want_upd
        if impl == "dense":
            break
        step, _, _ = make_sharded_train_step(
            cfg, mesh, lr=SGD_LR, attn_impl="flash", matmul_impl=impl)
        counters = {"all_gather_matmul": cm.all_gather_matmul,
                    "matmul_reduce_scatter": cm.matmul_reduce_scatter,
                    **flash_counters()}
        with tp_timers() as spent:
            run = train_loop(f"27b DP×TP fused collective across processes, "
                             f"rank {r}", step, local, wins[1:], counters)
        L = cfg.n_layers
        want_n = {"all_gather_matmul": 4 * L * PROCESS_STEPS,
                  "matmul_reduce_scatter": 4 * L * PROCESS_STEPS,
                  **flash_want(L * PROCESS_STEPS)}
        if run["launches"] != want_n:
            fail(f"27b rank {r}: launches {run['launches']}, expected "
                 f"{want_n}")
        out.update({k: run[k] for k in ("launches", "losses", "step_ms",
                                         "first_ms", "total_ms", "peak_gb")})
        out["ring_s"], out["gloo_s"] = spent["ring"], spent["gloo"]
        del run, local, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 28: the AdamW step and fit across processes (dp 2 × tp 2), in 26's
# group
# ---------------------------------------------------------------------------

OPTAX_AXES = {"dp": 2, "tp": 2}
OPTAX_SEED = SEED + 2800
# 28c: fit's steps uninterrupted, and where the interrupted run saves
FIT_PROCESS_RUN = dict(steps=2, save=1, batch=16)


def optax_params(cfg):
    import torch

    from tpu_dra_torch.workloads.train import init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(OPTAX_SEED)
    return init_params(cfg, gen)


def virtual_optax_step(tmp: Path) -> None:
    """28a's yardstick, in this process before the group starts: one
    fused-collective ``make_optax_train_step`` step (the default
    optimizer, flash attention) of the flagship on the virtual mesh dp 2
    × tp 2 on the first of 26's windows, saved as its loss, each leaf's
    first moment and the sign of each element's update (int8)."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import (ModelConfig,
                                               make_optax_train_step,
                                               tree_leaves, tree_unflatten)
    cfg = ModelConfig(**PROCESS_MODEL)
    win = torch.load(tmp / "windows.pt")[0].to("cuda")
    step, init, _, _ = make_optax_train_step(
        cfg, Mesh(OPTAX_AXES), attn_impl="flash",
        matmul_impl="fused_collective")
    params = optax_params(cfg)
    p0 = [t.clone() for t in tree_leaves(params)]
    params, opt, loss = step(params, init(params), win)
    sign = tree_unflatten(params, [
        torch.sign(p - q).to(torch.int8).cpu()
        for p, q in zip(tree_leaves(params), p0)])
    del p0, params
    torch.save({"loss": float(loss), "mu": tree_to(opt.mu, "cpu"),
                "sign": sign}, tmp / "optax_virtual.pt")
    del opt, sign
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def kept_state(maker: str = "make_optax_train_step"):
    """The parameters and optimizer state that the last step of a ``fit``
    inside the block returned (``fit``'s step maker ``maker`` wrapped):
    ``{"params", "opt"}``."""
    from tpu_dra_torch.workloads import fit as F
    real, last = getattr(F, maker), {}

    def make(*a, **k):
        step, *rest = real(*a, **k)

        def kept(params, opt, tokens):
            out = step(params, opt, tokens)
            last["params"], last["opt"] = out[0], out[1]
            return out
        return (kept, *rest)
    setattr(F, maker, make)
    try:
        yield last
    finally:
        setattr(F, maker, real)


def optax_lockstep(tmp: Path, mesh) -> dict:
    """28a and 28b in one process: the replicated and the ZeRO-1 step in
    turn from the same shards, held to each other bit for bit after every
    step and 28a's first step to the yardstick; returns the launches, the
    losses, the moment bytes and each run's step times and shares."""
    import math

    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.optim import AdamW
    from tpu_dra_torch.workloads.train import (ModelConfig,
                                               make_optax_train_step,
                                               opt_state_bytes_per_rank,
                                               opt_state_shardings,
                                               param_shapes, tree_leaves)
    cfg = ModelConfig(**PROCESS_MODEL)
    r, n, L = mesh.rank, mesh.axis_size("tp"), cfg.n_layers
    wins = [w.to(mesh.device)
            for w in torch.load(tmp / "windows.pt")[:PROCESS_STEPS]]
    runs = {}
    for zero1 in (False, True):
        step, init, p_shard, _ = make_optax_train_step(
            cfg, mesh, attn_impl="flash", zero1=zero1,
            matmul_impl="fused_collective")
        local = mesh.shard_tree(optax_params(cfg), p_shard)
        gc.collect()
        torch.cuda.empty_cache()
        sh, _ = opt_state_shardings(None, param_shapes(cfg), p_shard, mesh,
                                    zero1)
        opt = init(local)
        runs[zero1] = {"step": step, "init": init, "params": local,
                       "opt": opt, "losses": [], "ms": [], "spent": [],
                       "bytes": [8 * sum(t.numel()
                                         for t in tree_leaves(opt.mu)),
                                 opt_state_bytes_per_rank(
                                     sh, param_shapes(cfg), mesh)]}
        del opt
    a, b = runs[False], runs[True]
    for run in (a, b):
        if run["bytes"][0] != run["bytes"][1]:
            fail(f"28 rank {r}: a process holds {run['bytes'][0]} moment "
                 f"bytes, opt_state_bytes_per_rank says {run['bytes'][1]}")
    if 2 * b["bytes"][0] != a["bytes"][0]:
        fail(f"28b rank {r}: ZeRO-1 holds {b['bytes'][0]} moment bytes, "
             f"not half of the replicated {a['bytes'][0]}")
    p0 = [t.clone() for t in tree_leaves(a["params"])]
    counters = {"all_gather_matmul": cm.all_gather_matmul,
                "matmul_reduce_scatter": cm.matmul_reduce_scatter,
                **flash_counters()}
    timed = {"psum": [(ProcessMesh, "psum")], "optimizer": [(AdamW,
                                                             "update")]}
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    for i, win in enumerate(wins):
        for run in (a, b):
            with tp_timers(timed) as spent:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run["params"], run["opt"], loss = run["step"](
                    run["params"], run["opt"], win)
                torch.cuda.synchronize()
                run["ms"].append(1e3 * (time.perf_counter() - t0))
            run["spent"].append(dict(spent))
            run["losses"].append(float(loss))
        if i == 0:
            optax_yardstick(tmp, mesh, a, p0)
            del p0
        same = (a["losses"][i] == b["losses"][i]
                and same_trees(a["params"], b["params"])
                and all(same_trees(b["init"].layout.cut(getattr(
                    a["opt"], key)), getattr(b["opt"], key))
                    for key in ("mu", "nu")))
        if not same:
            fail(f"28b rank {r}: ZeRO-1 after step {i + 1} is not bit-equal "
                 f"to the replicated run")
    launches = read_counts(counters)
    steps = 2 * len(wins)                    # 28a's and 28b's
    want = {"all_gather_matmul": 4 * L * steps,
            "matmul_reduce_scatter": 4 * L * steps,
            **flash_want(L * steps)}
    if launches != want:
        fail(f"28a-b rank {r}: launches {launches}, expected {want}")
    if not all(math.isfinite(x) for x in a["losses"]):
        fail(f"28a rank {r}: losses {a['losses']}")
    out = {"launches": launches, "losses": a["losses"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bytes": [a["bytes"][0], b["bytes"][0]]}
    for name, run in (("a", a), ("b", b)):
        out[name] = {"ms": run["ms"], "spent": run["spent"]}
    del runs, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def optax_yardstick(tmp: Path, mesh, run: dict, p0: list) -> None:
    """28a's first step against the virtual mesh's: the loss within
    STEP_LOSS_ATOL and each leaf's first moment within STEP_LEAF_REL
    (:func:`hold_sharded_step`), and the share of elements whose
    update's sign differs (informational)."""
    import torch

    from tpu_dra_torch.workloads.train import tree_leaves
    want = torch.load(tmp / "optax_virtual.pt", mmap=True)
    p_shard = run["init"].layout.param_specs
    hold_sharded_step(f"28a AdamW across {mesh.size} processes, rank "
                      f"{mesh.rank}", mesh, run["losses"][0], run["opt"].mu,
                      want["loss"], tree_to(mesh.shard_tree(want["mu"],
                                                            p_shard),
                                            mesh.device),
                      what="the first moment after one AdamW step")
    signs = mesh.shard_tree(want["sign"], p_shard)
    differ = total = 0
    for new, old, s in zip(tree_leaves(run["params"]), p0,
                           tree_leaves(signs)):
        differ += int((torch.sign(new - old).to(torch.int8)
                       != s.to(mesh.device)).sum())
        total += s.numel()
    counts = mesh.psum(torch.tensor([float(differ), float(total)],
                                    device=mesh.device)).tolist()
    log(f"[mp28] rank {mesh.rank}: 28a's first update's sign differs from "
        f"the virtual step's in {counts[0] / counts[1]:.4f} of the "
        f"elements (informational)")
    del want, signs


def fit_resume_check(tmp: Path, mesh) -> dict:
    """28c in one process: ``fit`` on the process mesh, uninterrupted and
    saved then resumed (see the module's docstring); returns the
    launches, the losses and the save and restore seconds."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.fit import fit
    cfg, run = tp_cfgs()["dense"], FIT_PROCESS_RUN
    lines: list = []
    kw = dict(mesh=mesh, batch=run["batch"], attn_impl="flash",
              head_impl="chunked", zero1=True, log_every=1,
              log_fn=lines.append)
    data, ck = str(tmp / "tokens.bin"), str(tmp / "ck28")
    counters = {"all_gather_matmul": cm.all_gather_matmul,
                "matmul_reduce_scatter": cm.matmul_reduce_scatter,
                **flash_counters()}
    zero_counts(counters)
    t0 = time.perf_counter()
    with kept_state() as last:
        full = fit(cfg, data, steps=run["steps"], **kw)
        want = dict(last)
        fit(cfg, data, steps=run["save"], checkpoint_dir=ck,
            checkpoint_every=run["save"], **kw)
        resumed = fit(cfg, data, steps=run["steps"] - run["save"],
                      checkpoint_dir=ck, checkpoint_every=run["save"],
                      resume=True, **kw)
        got = dict(last)
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    expect = {"all_gather_matmul": 0, "matmul_reduce_scatter": 0,
              **flash_want(cfg.n_layers * 2 * run["steps"])}
    if launches != expect:
        fail(f"28c rank {mesh.rank}: launches {launches}, expected {expect}")
    same = (resumed.losses == full.losses[run["save"]:]
            and resumed.step == run["steps"]
            and same_trees(want["params"], got["params"])
            and all(same_trees(getattr(want["opt"], k), getattr(got["opt"],
                                                                 k))
                    for k in ("mu", "nu")))
    if not same:
        fail(f"28c rank {mesh.rank}: the resumed run is not bit-equal to "
             f"the uninterrupted one: losses {resumed.losses} against "
             f"{full.losses}")
    del want, got, last
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": full.losses, "seconds": secs,
            "save_s": timed_lines(lines, r"saved in ([0-9.]+) s"),
            "restore_s": timed_lines(lines, r"restored in ([0-9.]+) s")}


def check_process_checkpoint(ck: Path, cfg=None, init_fn=None,
                             steps: int = FIT_PROCESS_RUN["steps"],
                             label: str = "28c") -> None:
    """A process run's checkpoint (28c's by default: ``cfg`` the dense
    2-layer flagship, ``init_fn`` ``train.init_params``), read back in
    this process: the tree, shapes and dtypes of a one-process run's
    (the global parameters; the count, the global fp32 moments and the
    step)."""
    import torch

    from tpu_dra_torch.workloads.checkpointing import (latest_step,
                                                       restore_train_state)
    from tpu_dra_torch.workloads.train import init_params
    cfg = cfg or tp_cfgs()["dense"]
    state = restore_train_state(str(ck), device="cpu")
    meta = (init_fn or init_params)(cfg, torch.Generator(), device="meta")
    want = {"params": meta, "extra": {"opt_state": {
        "count": steps, "mu": meta, "nu": meta}, "step": steps}}

    got, expect = flat_leaves(state), flat_leaves(want)
    bad = sorted(set(got) ^ set(expect))
    for k, v in expect.items():
        g = got.get(k)
        if torch.is_tensor(v):
            if not (torch.is_tensor(g) and g.shape == v.shape
                    and g.dtype == v.dtype):
                bad.append(k)
        elif g != v:
            bad.append(k)
    if bad or latest_step(str(ck)) != steps:
        fail(f"{label}: the process run's checkpoint departs from a "
             f"one-process run's at {bad[:8]}")
    log(f"[mp{label[:2]}] {label}: the checkpoint at step {steps} holds a "
        f"one-process run's tree ({len(expect)} leaves: the global "
        f"parameters and fp32 moments, the count and the step; shapes and "
        f"dtypes equal)")


def process_rank(tmp: str) -> int:
    """One rank of phase 26's group, started by ``process_phase`` through
    ``launcher.run_local_group``: it resolves its triple and joins the
    group over gloo (NCCL refuses several ranks on one card), runs 26a on
    the whole group (n = 4) and on its pair (n = 2, ranks {0, 1} and {2,
    3} at once), then 26b on ``ProcessMesh({"dp": 1, "sp": 4})`` and 27
    on ``ProcessMesh({"dp": 1, "tp": 4})`` and 28 on ``ProcessMesh({"dp":
    2, "tp": 2})``, 29a, b and d on ``ProcessMesh({"sp": 4})`` and 29c on
    ``ProcessMesh({"dp": 1, "pp": 4})``, 30a on ``ProcessMesh(EP_AXES)``,
    30b-c on ``ProcessMesh(EP_OPTAX_AXES)``, 30d on
    ``ProcessMesh(LORA_AXES)`` and 30e on ``ProcessMesh(SERVE_AXES)``, and
    writes its results to ``tmp/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from tpu_dra_torch.workloads.collective_matmul import ProcessRing
    from tpu_dra_torch.workloads.launcher import resolve
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resolve().initialize("gloo")
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]

    def release(done: str):
        """Give back this process's cached blocks between phases (the
        card is shared by the group's processes and the parent), and
        log what this process still holds (informational)."""
        gc.collect()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        print(f"[mp26] rank {rank}: after {done}: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the "
              f"card's free memory {free / 1e9:.2f} GB", flush=True)
    t0 = time.perf_counter()
    kernels = {}
    for n, ring in ((4, ProcessRing()), (2, ProcessRing(pairs[rank // 2]))):
        kernels[n] = process_kernels(ring)
        ring.close()
    release("26a")
    t1 = time.perf_counter()
    mesh = ProcessMesh({"dp": 1, "sp": PROCESSES})
    step = process_step(Path(tmp), mesh)
    mesh.close()
    release("26b")
    t2 = time.perf_counter()
    mesh = ProcessMesh({"dp": 1, "tp": PROCESSES})
    tp = process_tp(Path(tmp), mesh)
    mesh.close()
    release("27")
    t3 = time.perf_counter()
    mesh = ProcessMesh(OPTAX_AXES)
    optax = optax_lockstep(Path(tmp), mesh)
    t4 = time.perf_counter()
    optax["fit"] = fit_resume_check(Path(tmp), mesh)
    mesh.close()
    release("28")
    t5 = time.perf_counter()
    mesh = ProcessMesh(ATTN_AXES)
    attn = process_attention(Path(tmp), mesh)
    mesh.close()
    release("29a-b")
    t6 = time.perf_counter()
    mesh = ProcessMesh(PIPE_AXES)
    pipe = process_pipe(Path(tmp), mesh)
    mesh.close()
    release("29c")
    t7 = time.perf_counter()
    moe, stamps = {}, [t7]
    mesh = ProcessMesh(EP_AXES)
    moe["a"] = process_moe(Path(tmp), mesh)
    mesh.close()
    release("30a")
    stamps.append(time.perf_counter())
    mesh = ProcessMesh(EP_OPTAX_AXES)
    moe["b"] = process_moe_optax(Path(tmp), mesh)
    stamps.append(time.perf_counter())
    moe["c"] = moe_fit_check(Path(tmp), mesh)
    mesh.close()
    release("30b-c")
    stamps.append(time.perf_counter())
    mesh = ProcessMesh(LORA_AXES)
    moe["d"] = process_lora(Path(tmp), mesh)
    mesh.close()
    release("30d")
    stamps.append(time.perf_counter())
    mesh = ProcessMesh(SERVE_AXES)
    moe["e"] = process_serving(mesh)
    mesh.close()
    release("30e")
    stamps.append(time.perf_counter())
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps({
        "kernels": kernels, "step": step, "tp": tp, "optax": optax,
        "attn": attn, "pipe": pipe, "moe": moe,
        "kernels_s": t1 - t0, "step_s": t2 - t1, "tp_s": t3 - t2,
        "optax_s": t4 - t3, "fit_s": t5 - t4, "attn_s": t6 - t5,
        "pipe_s": t7 - t6,
        **{f"moe_{k}_s": b - a for k, a, b in zip("abcde", stamps,
                                                   stamps[1:])}}))
    dist.destroy_process_group()
    return 0


def virtual_step(tmp: Path) -> None:
    """26b's yardstick, in this process before the group starts: the
    same step on the virtual mesh dp 1 × sp 4 (lr 1, the same seed's
    parameters, the first window), saved as its loss and each leaf's
    update, with the windows the group trains on."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**PROCESS_MODEL)
    wins = window_batches(write_tokens(tmp / "tokens.bin", cfg.vocab),
                          SHARDED_RUN["batch"], cfg.max_seq,
                          PROCESS_STEPS + 1)
    torch.save([w.cpu() for w in wins], tmp / "windows.pt")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2600)
    params = init_params(cfg, gen)
    step, _ = make_ring_train_step(cfg, Mesh({"dp": 1, "sp": PROCESSES}),
                                   lr=1.0, ring_impl="flash",
                                   hop_impl="pallas")
    new, loss = step(params, wins[0][:, :-1], wins[0][:, 1:])
    upd = leaf_updates(params, new, 1.0)
    del new, params
    torch.save({"loss": float(loss), "upd": tree_to(upd, "cpu")},
               tmp / "virtual.pt")
    del upd
    gc.collect()
    torch.cuda.empty_cache()


def process_phase(card: str) -> dict:
    """Phases 26-30: the ring kernels (#9-#11), the DP×SP ring-flash
    step, the DP×TP step, the AdamW step and fit, the ring attention
    makers, zigzag, GPipe and ici_shift, and EP, the MoE AdamW step and
    fit, LoRA and the serving shardings across PROCESSES processes on the
    one card, started through the port's rendezvous
    (``launcher.run_local_group``: each rank resolves its triple and
    joins a gloo group); a rank that fails fails the phase.  Returns each
    rank's launches, summed, 26's, 27b's, 28's, 29's and 30's apart."""
    import torch

    from tpu_dra_torch.workloads.launcher import run_local_group
    with tempfile.TemporaryDirectory(prefix="chip_smoke-26-") as tmp:
        t0 = time.perf_counter()
        virtual_step(Path(tmp))
        virtual_tp_steps(Path(tmp))
        t1 = time.perf_counter()
        virtual_optax_step(Path(tmp))
        t2 = time.perf_counter()
        virtual_attention(Path(tmp))
        virtual_pipe_step(Path(tmp))
        t29 = time.perf_counter() - t2
        t30 = time.perf_counter()
        virtual_moe(Path(tmp))
        t30 = time.perf_counter() - t30
        # the group's processes share the card with this one: give back
        # what the virtual yardsticks left cached
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
        log(f"[mp26] the card before the group: {free / 1e9:.2f} of "
            f"{total / 1e9:.2f} GB free; this process "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; "
            f"processes on the card: {apps or 'none listed'}")
        t2 = time.perf_counter()
        # expandable segments: 30a's ranks, each at about 16 GB by its
        # first-step check, ran out of memory with 0.6 GB free on the card
        # and 1.0 GB fragmented in each rank's cache (H100 80GB HBM3)
        outs = run_local_group([sys.executable, "-c", PROCESS_CHILD, tmp],
                               PROCESSES, timeout=PROCESS_WAIT, cwd=str(HERE),
                               env=child_env(PYTORCH_CUDA_ALLOC_CONF=(
                                   "expandable_segments:True")))
        t3 = time.perf_counter()
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(PROCESSES)]
        check_process_checkpoint(Path(tmp) / "ck28")
        check_process_checkpoint(
            Path(tmp) / "ck30", moe_cfg(MOE_PROCESS_RUN["optax_layers"]),
            moe_init(), MOE_PROCESS_RUN["fit_save"], "30c")
        t4 = time.perf_counter()
    for r, out in enumerate(outs):
        for ln in out.splitlines():
            if ln.startswith(("[mp26]", "[mp28]", "[mp29]", "[mp30]",
                              "[train]")):
                log(f"[mp26] rank {r}: {ln}")
    total: dict = {}
    for r, res in enumerate(ranks):
        for n, k in res["kernels"].items():
            log(f"[mp26] 26a rank {r}, n {n}: byte-equal to the virtual "
                f"ring's rank {r % int(n)} and within the group plain "
                f"versions (max abs err {k['err']}); launches "
                f"{k['launches']} (exact, one a call); "
                f"{PROCESS_BACK_TO_BACK} gathers and {PROCESS_BACK_TO_BACK} "
                f"reduce-scatters back to back (enqueued in "
                f"{k['back_to_back']:.2f} s, no host synchronize or group "
                f"barrier) byte-equal to the virtual ring's; per call by "
                f"CUDA events (one launch, no host barrier; "
                f"informational): "
                + ", ".join(f"{name} {ms:.3f} ms" + (
                    f" (one launch and a barrier a ring step, the earlier "
                    f"design: "
                    f"{PROCESS_STEPS_MS[name]} ms at n 4)"
                    if name in PROCESS_STEPS_MS and n == "4" else "")
                    for name, ms in k["ms"].items())
                + f"; on {card}")
            add_counts(total, k["launches"])
        st = res["step"]
        log(f"[mp26] 26b rank {r}: {PROCESS_STEPS} steps, losses "
            f"{st['losses']}, launches {st['launches']} (exact), step "
            f"{st['step_ms']:.1f} ms (median of the steps after the first; "
            f"first {st['first_ms']:.1f}), a gloo psum of the "
            f"{TRAIN_MODEL['d_model']}-wide flagship's fp32 gradients at "
            f"{PROCESS_LAYERS} layers "
            f"{st['psum_ms']:.1f} ms ({st['psum_ms'] / st['step_ms']:.3f} of "
            f"the step), peak memory {st['peak_gb']:.2f} GB; 26a "
            f"{res['kernels_s']:.1f} s, 26b {res['step_s']:.1f} s; on {card}")
        add_counts(total, st["launches"])
    tp_total: dict = {}
    for r, res in enumerate(ranks):
        tp = res["tp"]
        log(f"[mp27] 27b rank {r}: {PROCESS_STEPS} fused-collective steps on "
            f"dp 1 × tp {PROCESSES}, losses {tp['losses']}, launches "
            f"{tp['launches']} (exact), step {tp['step_ms']:.1f} ms (median "
            f"of the steps after the first; first {tp['first_ms']:.1f}), of "
            f"the {tp['total_ms']:.1f} ms of the steps: ring calls "
            f"{tp['ring_s'] * 1e3:.1f} ms "
            f"({tp['ring_s'] * 1e3 / tp['total_ms']:.3f}), gloo collectives "
            f"{tp['gloo_s'] * 1e3:.1f} ms "
            f"({tp['gloo_s'] * 1e3 / tp['total_ms']:.3f}) (host clock, each "
            f"call synchronized), peak memory {tp['peak_gb']:.2f} GB; 27a "
            f"step {tp['fused_collective_one_s']:.1f} s, 27c dense "
            f"{TP_DENSE_LAYERS}-layer step {tp['dense_one_s']:.1f} s, phase "
            f"27 in this rank {res['tp_s']:.1f} s (informational); on {card}")
        add_counts(tp_total, tp["launches"])
    optax_total = log_optax(ranks, card)
    attn_total = log_attention(ranks, card)
    moe_total = log_moe(ranks, card)
    log(f"[mp26] phases 26-30: the virtual yardsticks {t1 - t0:.1f} s (26-27)"
        f", {t2 - t1 - t29 - t30:.1f} s (28), {t29:.1f} s (29) and "
        f"{t30:.1f} s (30), the group of {PROCESSES} {t3 - t2:.1f} s, 28c's "
        f"and 30c's checkpoints read back {t4 - t3:.1f} s; launches summed "
        f"over the ranks: 26 {total}, 27b {tp_total}, 28 {optax_total}, 29 "
        f"{attn_total}, 30 {moe_total}")
    return {"launches": total, "tp_launches": tp_total,
            "optax_launches": optax_total, "attn_launches": attn_total,
            "moe_launches": moe_total}


def log_optax(ranks: list, card: str) -> dict:
    """Phase 28's figures from each rank's results; returns its launches
    summed over the ranks."""
    optax_total: dict = {}
    for r, res in enumerate(ranks):
        op = res["optax"]
        for name, run in (("28a replicated", op["a"]), ("28b ZeRO-1",
                                                        op["b"])):
            log(f"[mp28] {name} rank {r}: {PROCESS_STEPS} AdamW steps on dp 2 "
                f"× tp 2, fused collective; "
                + "; ".join(
                    f"step {i + 1} {ms:.1f} ms: gloo collectives "
                    f"{sp['gloo'] * 1e3 / ms:.3f} of it, the gradient psum "
                    f"{sp['psum'] * 1e3 / ms:.3f}, the optimizer (its clip's "
                    f"gather and ZeRO-1's update gathers inside) "
                    f"{sp['optimizer'] * 1e3 / ms:.3f}, ring calls "
                    f"{sp['ring'] * 1e3 / ms:.3f}"
                    for i, (ms, sp) in enumerate(zip(run["ms"],
                                                     run["spent"])))
                + " (host clock, synced, each timed call synchronized; "
                f"informational); on {card}")
        log(f"[mp28] 28a-b rank {r}: losses {op['losses']}, ZeRO-1 bit-equal "
            f"to replicated after every step, moment bytes a process "
            f"{op['bytes'][1]} against {op['bytes'][0]} "
            f"(opt_state_bytes_per_rank), peak memory {op['peak_gb']:.2f} GB, "
            f"launches {op['launches']} (exact); 28a-b {res['optax_s']:.1f} "
            f"s; on {card}")
        add_counts(optax_total, op["launches"])
        ft = op["fit"]
        log(f"[mp28] 28c rank {r}: fit on dp 2 × tp 2 at {TP_DENSE_LAYERS} "
            f"layers, zero1, the chunked head: losses {ft['losses']}, the "
            f"resumed run bit-equal; saves {ft['save_s']} s, restore "
            f"{ft['restore_s']} s; launches {ft['launches']} (exact); 28c "
            f"{res['fit_s']:.1f} s; on {card}")
        add_counts(optax_total, ft["launches"])
    return optax_total


# ---------------------------------------------------------------------------
# phase 29: ring attention, zigzag, GPipe and ici_shift across processes, in
# 26's group
# ---------------------------------------------------------------------------

ATTN_AXES = {"sp": PROCESSES}          # 29a, 29b and 29d
PIPE_AXES = {"dp": 1, "pp": PROCESSES}  # 29c
ATTN_SEED = SEED + 2900
PIPE_SEED = SEED + 2950
# 29d: a handoff of the serving model's shape (MODEL's layers and kv heads,
# head dim 128) for a prompt of this many tokens
HANDOFF_TOKENS = 1024


def attn_inputs(i: int) -> list:
    """The global bf16 q, k, v and output cotangent at ZIGZAG_CASES[i],
    drawn from one seed alike by the parent and by every rank."""
    import torch
    _, B, H, Hkv, S, D = ZIGZAG_CASES[i]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ATTN_SEED + i)
    return [torch.randn((B, h, S, D), generator=gen, device="cuda").to(
        torch.bfloat16) for h in (H, Hkv, Hkv, H)]


def attn_makers(mesh) -> dict:
    """label → (attention over global q, k, v on ``mesh``, case index):
    29a's zigzag engines at both ZIGZAG_CASES shapes and 29b's ring
    makers (hop_impl="pallas") at the flagship-heads shape."""
    from tpu_dra_torch.workloads.ring_attention import (
        make_ring_attention, make_ring_attention_flash,
        make_zigzag_ring_attention)
    out = {}
    for i in range(len(ZIGZAG_CASES)):
        for impl, name in (("flash", "flash"), ("xla", "fp32")):
            out[f"29a zigzag {name} engine, {ZIGZAG_CASES[i][0]}"] = (
                make_zigzag_ring_attention(mesh, impl=impl), i)
    out[f"29b make_ring_attention_flash, {ZIGZAG_CASES[0][0]}"] = (
        make_ring_attention_flash(mesh, hop_impl="pallas"), 0)
    out[f"29b make_ring_attention, {ZIGZAG_CASES[0][0]}"] = (
        make_ring_attention(mesh, hop_impl="pallas"), 0)
    return out


def attn_want(label: str, gqa: bool, n: int, idx: int) -> dict:
    """A 29a-b call's exact launches (forward and backward) in rank idx
    of n: the zigzag flash engine 2n + 1 chunk-attends, the plain ring's
    flash engine 1 + idx blocks, #11 2(n − 1) shifts each way."""
    fwd = "flash_fwd_gqa" if gqa else "flash_fwd"
    if "zigzag flash" in label:
        k = 2 * n + 1
        return {fwd: k, "flash_bwd_dq": k, "flash_bwd_dkdv": k}
    if "zigzag" in label:
        return {}
    out = {"ring_shift": 4 * (n - 1)}
    if "flash" in label:
        out.update({fwd: 1 + idx, "flash_bwd_dq": 1 + idx,
                    "flash_bwd_dkdv": 1 + idx})
    return out


def virtual_attention(tmp: Path) -> None:
    """29a-b's yardsticks, in this process before the group starts: each
    maker of :func:`attn_makers` on the virtual mesh ATTN_AXES at its
    inputs, the output and the q, k, v gradients of the cotangent,
    saved."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    want = {}
    for label, (fn, i) in attn_makers(Mesh(ATTN_AXES)).items():
        q, k, v, cot = attn_inputs(i)
        ins = [t.requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        grads = torch.autograd.grad(out, ins, cot)
        want[label] = [t.detach().cpu() for t in (out, *grads)]
        del ins, out, grads
    torch.save(want, tmp / "attn29.pt")
    torch.cuda.empty_cache()


def handoff_payload(n: int) -> dict:
    """29d's global leaves ``[n, ...]`` (rank r's own at ``[r]``), drawn
    from one seed: a bf16 cache's k and v, an int8 cache's k and v and
    their fp32 scales, each ``[layers, kv heads, tokens, head dim]``
    (scales without the head dim)."""
    import torch
    shape = (n, MODEL["n_layers"], MODEL["n_kv_heads"], HANDOFF_TOKENS,
             MODEL["d_model"] // MODEL["n_heads"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ATTN_SEED + 99)

    def q8():
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    return {"ks": torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16),
            "vs": torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16),
            "ks_q8": q8(), "vs_q8": q8(),
            "ks_scale": torch.rand(shape[:-1], generator=gen, device="cuda"),
            "vs_scale": torch.rand(shape[:-1], generator=gen, device="cuda")}


def process_attention(tmp: Path, mesh) -> dict:
    """29a, 29b and 29d in one process on ``ProcessMesh(ATTN_AXES)``: each
    maker on the global inputs with exact launches (zeroed just before
    the call, read just after), its output and gradients held to the
    virtual mesh's (ELEM_TOL elementwise and STEP_LEAF_REL relative L2),
    then its calls timed; then ``ici_shift`` of this rank's handoff
    leaves one hop on and back, byte-equal, one #11 launch a leaf a
    direction."""
    import torch

    from tpu_dra_torch.workloads.flash import ELEM_TOL
    from tpu_dra_torch.workloads.kv_handoff import ici_shift
    n, idx = mesh.axis_size("sp"), mesh.axis_index("sp")
    want_all = torch.load(tmp / "attn29.pt", mmap=True)
    total: dict = {}
    out = {"err": {}, "ms": {}, "launches": {}}
    for label, (fn, i) in attn_makers(mesh).items():
        _, _, H, Hkv, _, _ = ZIGZAG_CASES[i]
        q, k, v, cot = attn_inputs(i)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]

        def call():
            y = fn(*ins)
            return (y.detach(), *torch.autograd.grad(y, ins, cot))
        got, launches = counted(call, gqa=Hkv < H)
        torch.cuda.synchronize()
        want = attn_want(label, Hkv < H, n, idx)
        if launches != want:
            fail(f"{label}, rank {idx}: launches {launches}, expected {want}")
        add_counts(total, launches)
        out["launches"][label] = launches
        errs = []
        for name, g, w in zip(("out", "dq", "dk", "dv"), got,
                              want_all[label]):
            g, w = g.float(), w.to(g.device).float()
            ratio = float(((g - w).abs() / (ELEM_TOL + ELEM_TOL * w.abs()))
                          .max())
            rel = float((g - w).norm() / w.norm())
            errs.append([name, float((g - w).abs().max()), ratio, rel])
            if not (torch.isfinite(g).all() and ratio <= 1.0
                    and rel <= STEP_LEAF_REL):
                fail(f"{label}, rank {idx}: {name} departs from the virtual "
                     f"mesh's ({ratio:.3f} of ELEM_TOL elementwise, "
                     f"relative L2 {rel:.3e})")
        out["err"][label] = errs
        del got, ins
        with torch.no_grad():
            fwd_ms = call_ms(lambda: fn(q, k, v))
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out["ms"][label] = [fwd_ms, call_ms(call)]
        del ins, q, k, v, cot
        torch.cuda.empty_cache()
    del want_all
    ring = mesh.ring("sp")
    payload = handoff_payload(n)
    mine = {name: t[idx].contiguous() for name, t in payload.items()}
    there, launches_on = counted(lambda: ici_shift(mine, ring=ring))
    back, launches_back = counted(
        lambda: ici_shift(there, reverse=True, ring=ring))
    for name, t in mine.items():
        same_bytes(f"29d ici_shift of {name}, rank {idx}: one hop on vs "
                   f"rank {(idx - 1) % n}'s block", there[name],
                   payload[name][(idx - 1) % n])
        same_bytes(f"29d ici_shift of {name}, rank {idx}: on and back",
                   back[name], t)
    for way, seen in (("on", launches_on), ("back", launches_back)):
        if seen != {"ring_shift": len(mine)}:
            fail(f"29d ici_shift {way}, rank {idx}: launches {seen}, "
                 f"expected one #11 launch for each of {len(mine)} leaves")
        add_counts(total, seen)
    out["ici_ms"] = call_ms(lambda: ici_shift(mine, ring=ring))
    out["ici_bytes"] = sum(t.numel() * t.element_size()
                           for t in mine.values())
    out["total"] = total
    return out


def virtual_pipe_step(tmp: Path) -> None:
    """29c's yardstick, in this process before the group starts: GPipe of
    the flagship on the virtual mesh PIPE_AXES at lr 1 (n_micro
    PIPE_RUN's, the PIPE_SEED tree, 26's first window), saved as its
    loss and each leaf's update."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.pipeline import make_pipeline_train_step
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**TRAIN_MODEL)
    win = torch.load(tmp / "windows.pt")[0].to("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PIPE_SEED)
    params = init_params(cfg, gen)
    step, _, _ = make_pipeline_train_step(cfg, Mesh(PIPE_AXES),
                                          n_micro=PIPE_RUN["n_micro"], lr=1.0)
    new, loss = step(params, win)
    upd = leaf_updates(params, new, 1.0)
    del new, params
    torch.save({"loss": float(loss), "upd": tree_to(upd, "cpu")},
               tmp / "pipe29.pt")
    del upd
    gc.collect()
    torch.cuda.empty_cache()


def process_pipe(tmp: Path, mesh) -> dict:
    """29c in one process on ``ProcessMesh(PIPE_AXES)``: stage
    ``coords["pp"]`` of the flagship's GPipe (see the module's
    docstring)."""
    import torch

    from tpu_dra_torch.workloads.collective_matmul import ProcessRing
    from tpu_dra_torch.workloads.pipeline import make_pipeline_train_step
    from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                               tree_leaves)
    cfg = ModelConfig(**TRAIN_MODEL)
    pp, n_micro = mesh.axis_size("pp"), PIPE_RUN["n_micro"]
    stage = mesh.axis_index("pp")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PIPE_SEED)
    whole = init_params(cfg, gen)
    step, p_shard, _ = make_pipeline_train_step(cfg, mesh, n_micro=n_micro,
                                                lr=1.0)
    params = mesh.shard_tree(whole, p_shard)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    wins = [w.to(mesh.device) for w in torch.load(tmp / "windows.pt")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, loss = step(params, wins[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    saved = torch.load(tmp / "pipe29.pt", mmap=True)
    want = tree_to(mesh.shard_tree(saved["upd"], p_shard), mesh.device)
    upd = leaf_updates(params, new, 1.0)
    hold_sharded_step(f"29c GPipe across {pp} processes, rank {stage}", mesh,
                      loss, upd, saved["loss"], want)
    mine = float(loss) == saved["loss"] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(upd),
                                          tree_leaves(want)))
    bit_equal = bool(mesh.psum(torch.tensor(float(mine))) == mesh.size)
    del upd, want, saved
    if not same_everywhere(mesh, {key: new[key] for key, spec in
                                  p_shard.items() if spec == ()}):
        fail(f"29c GPipe, rank {stage}: the replicated leaves differ between "
             f"the processes")
    del new
    step, _, _ = make_pipeline_train_step(cfg, mesh, n_micro=n_micro,
                                          lr=SGD_LR)
    with tp_timers({"hops": [(ProcessRing, "ring_shift_ref")]}) as spent:
        run = train_loop(f"29c GPipe across processes, rank {stage}", step,
                         params, wins[1:], kernel_counters(),
                         must_fall=False)
    if any(run["launches"].values()):
        fail(f"29c GPipe, rank {stage}: launched {run['launches']} (its "
             f"stages run dense attention)")
    del run["params"], params
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": run["losses"], "step_ms": run["step_ms"],
            "first_ms": run["first_ms"], "total_ms": run["total_ms"],
            "one_s": first_s, "bit_equal": bit_equal,
            "hops_s": spent["hops"], "gloo_s": spent["gloo"],
            "peak_gb": run["peak_gb"],
            "bubble": (pp - 1) / (n_micro + pp - 1)}


def log_attention(ranks: list, card: str) -> dict:
    """Phase 29's figures from each rank's results; returns its launches
    summed over the ranks."""
    total: dict = {}
    for r, res in enumerate(ranks):
        at = res["attn"]
        for label, errs in at["err"].items():
            fwd_ms, both_ms = at["ms"][label]
            log(f"[mp29] {label}, rank {r}: against the virtual mesh's "
                + ", ".join(f"{name} max abs err {e:.4g} ({ratio:.3f} of "
                            f"ELEM_TOL, relative L2 {rel:.3e})"
                            for name, e, ratio, rel in errs)
                + f"; launches {at['launches'][label]} (exact); a call's "
                f"forward {fwd_ms:.2f} ms, forward and backward "
                f"{both_ms:.2f} ms (CUDA events, median of {PROCESS_TIMED},"
                f" hops through gloo included; informational); on {card}")
        log(f"[mp29] 29d rank {r}: ici_shift of {at['ici_bytes']} B in six "
            f"leaves (bf16 k and v, int8 k and v, fp32 scales) one hop on "
            f"and back byte-equal, one #11 launch a leaf a direction; one "
            f"hop {at['ici_ms']:.3f} ms with its six barriers (CUDA events; "
            f"informational); on {card}")
        add_counts(total, at["total"])
        pp = res["pipe"]
        log(f"[mp29] 29c rank {r}: GPipe dp 1 × pp {PROCESSES}, n_micro "
            f"{PIPE_RUN['n_micro']}, batch {SHARDED_RUN['batch']}: the lr-1 "
            f"step bit-equal to the virtual mesh's: {pp['bit_equal']}; "
            f"{PROCESS_STEPS} steps, losses {pp['losses']}, step "
            f"{pp['step_ms']:.1f} ms (median of the steps after the first; "
            f"first {pp['first_ms']:.1f}; the lr-1 step {pp['one_s']:.2f} "
            f"s), of the {pp['total_ms']:.1f} ms of the steps: activation "
            f"hops {pp['hops_s'] * 1e3:.1f} ms "
            f"({pp['hops_s'] * 1e3 / pp['total_ms']:.3f}), gloo psums "
            f"{pp['gloo_s'] * 1e3:.1f} ms "
            f"({pp['gloo_s'] * 1e3 / pp['total_ms']:.3f}) (host clock, each "
            f"call synchronized); peak memory {pp['peak_gb']:.2f} GB; the "
            f"bubble {pp['bubble']:.3f} of the stage passes; no kernel "
            f"launched; 29a-b, d {res['attn_s']:.1f} s, 29c "
            f"{res['pipe_s']:.1f} s; on {card}")
    return total


# ---------------------------------------------------------------------------
# phase 30: expert parallelism, the MoE AdamW step and fit, LoRA and the
# serving shardings across processes, in 26's group
# ---------------------------------------------------------------------------

EP_AXES = {"dp": 1, "ep": PROCESSES}        # 30a
EP_OPTAX_AXES = {"dp": 2, "ep": 2}          # 30b-c
LORA_AXES = {"dp": 2, "tp": 2}              # 30d
SERVE_AXES = {"dp": 1, "tp": PROCESSES}     # 30e
EP_SEED = SEED + 3000
LORA_SEED = SEED + 3050
# 30a-d: batch 8 on the first rows of 26's [16, 1025] windows; 30b-c's
# depth: one layer of the flagship's widths (phase 23's AdamW pair has
# two; here every step's 1.15 GB dp psum and 30c's gathered state go
# through gloo: at two layers a step took 5.4-10.1 s and a save 35-53 s
# on an H100 80GB HBM3 at 700 W, and the script 1390.9 s on a slow
# host); 30c's fit steps and its one save
MOE_PROCESS_RUN = dict(batch=8, top_k=2, optax_layers=1, fit_steps=2,
                       fit_save=1, rank=8)


def moe_cfg(layers: int | None = None):
    import dataclasses

    from tpu_dra_torch.workloads.moe import MoEConfig
    cfg = MoEConfig(**MOE_MODEL, router_top_k=MOE_PROCESS_RUN["top_k"])
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def moe_init():
    from tpu_dra_torch.workloads.moe import init_moe_params
    return init_moe_params


def moe_params(cfg):
    import torch

    from tpu_dra_torch.workloads.moe import init_moe_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(EP_SEED)
    return init_moe_params(cfg, gen)


def lora_trees(cfg):
    """30d's base (the serving model's fp32 tree) and rank-r adapters,
    each from its seed.  B is drawn non-zero (0.02·N(0, 1), where
    ``init_lora`` starts it at 0), so that the adapters after a step are
    not the first AdamW updates alone: those move each element by about
    ±lr, with the sign of a gradient that may be near zero."""
    import torch

    from tpu_dra_torch.workloads.lora import LoRAConfig, init_lora
    from tpu_dra_torch.workloads.train import init_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(LORA_SEED)
    base = init_params(cfg, gen)
    lg = torch.Generator(device="cuda")
    lg.manual_seed(LORA_SEED + 1)
    lora = init_lora(base, LoRAConfig(rank=MOE_PROCESS_RUN["rank"]), lg)
    for ab in lora["blocks"].values():
        ab["b"] = 0.02 * torch.randn(ab["b"].shape, generator=lg,
                                     device="cuda")
    return base, lora


def moe_windows(tmp: Path, device) -> list:
    """30a-d's windows: the first MOE_PROCESS_RUN["batch"] rows of each of
    26's."""
    import torch
    return [w[:MOE_PROCESS_RUN["batch"]].to(device)
            for w in torch.load(tmp / "windows.pt")]


def virtual_moe(tmp: Path) -> None:
    """30a, 30b and 30d's yardsticks, in this process before the group
    starts, each saved: (a) one make_moe_train_step step at lr 1 of the
    flagship MoE on the virtual mesh EP_AXES (its loss, each leaf's
    update and the router's choices of every call); (b) the first
    make_moe_optax_step step at 30b's depth on EP_OPTAX_AXES (its loss,
    the first moments and the choices); (d) PROCESS_STEPS
    make_lora_train_step steps of the serving model on LORA_AXES (the
    losses, the adapters' first moments after step 1 and the adapters),
    then one from fresh adapters over the int8 base (alike)."""
    import torch

    from tpu_dra_torch.workloads.lora import LoRAConfig, make_lora_train_step
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.moe import (PinnedChoices,
                                             make_moe_optax_step,
                                             make_moe_train_step)
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig
    wins = moe_windows(tmp, "cuda")
    cfg = moe_cfg()
    params = moe_params(cfg)
    step, _, _ = make_moe_train_step(cfg, Mesh(EP_AXES), lr=1.0,
                                     attn_impl="flash")
    with PinnedChoices() as pin:
        new, loss = step(params, wins[0])
    upd = leaf_updates(params, new, 1.0)
    del new, params
    torch.save({"loss": float(loss), "upd": tree_to(upd, "cpu"),
                "routes": [t.cpu() for t in pin.recorded]}, tmp / "moe30.pt")
    del upd, pin
    gc.collect()
    torch.cuda.empty_cache()
    small = moe_cfg(MOE_PROCESS_RUN["optax_layers"])
    step, init, _, _ = make_moe_optax_step(small, Mesh(EP_OPTAX_AXES),
                                           attn_impl="flash")
    params = moe_params(small)
    with PinnedChoices() as pin:
        params, opt, loss = step(params, init(params), wins[0])
    torch.save({"loss": float(loss), "mu": tree_to(opt.mu, "cpu"),
                "routes": [t.cpu() for t in pin.recorded]},
               tmp / "moe30b.pt")
    del params, opt, pin
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**MODEL)
    base, lora = lora_trees(cfg)
    fresh = tree_to(lora, "cpu")
    step, init, _, _ = make_lora_train_step(
        cfg, Mesh(LORA_AXES), LoRAConfig(rank=MOE_PROCESS_RUN["rank"]),
        attn_impl="flash")
    opt, losses = init(lora), []
    for i, win in enumerate(wins[:PROCESS_STEPS]):
        lora, opt, loss = step(base, lora, opt, win)
        losses.append(float(loss))
        if i == 0:
            mu1 = tree_to(opt.mu, "cpu")
    qbase = quantize_params_int8(base)
    q_lora = tree_to(fresh, "cuda")
    q_lora, q_opt, q_loss = step(qbase, q_lora, init(q_lora), wins[0])
    torch.save({"losses": losses, "lora": tree_to(lora, "cpu"), "mu1": mu1,
                "q_loss": float(q_loss), "q_lora": tree_to(q_lora, "cpu"),
                "q_mu1": tree_to(q_opt.mu, "cpu")}, tmp / "lora30.pt")
    del base, qbase, lora, q_lora, opt, q_opt
    gc.collect()
    torch.cuda.empty_cache()


def staggered_shards(mesh, make, specs) -> dict:
    """``mesh.shard_tree(make(), specs)`` with the processes building the
    global tree one after another (a barrier between), so that one global
    tree at a time lives on the card beside the shards."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(mesh.size):
        if r == mesh.rank:
            whole = make()
            out = mesh.shard_tree(whole, specs)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    return out


def rows_of(mesh, n_tokens: int) -> slice:
    """The token rows ``[N/dp]`` of this process's dp shard of a batch of
    ``n_tokens`` tokens, in the router's order."""
    per = n_tokens // mesh.axis_size("dp")
    return slice(mesh.axis_index("dp") * per,
                 (mesh.axis_index("dp") + 1) * per)


def routes_differing(recorded: list, want: list, rows: slice) -> int:
    """Token-layer routes (router calls of one pass) whose choices differ
    from ``want``'s rows."""
    return sum(int((a.cpu() != b[rows]).any(-1).sum())
               for a, b in zip(recorded, want))


def process_moe(tmp: Path, mesh) -> dict:
    """30a in one process on ``ProcessMesh(EP_AXES)``: the flagship MoE
    (top-2, its 8 experts two a process), its shards from the seed's
    tree; one make_moe_train_step step at lr 1 held to the virtual
    mesh's (replayed on the virtual step's routes where any differ
    unpinned), then PROCESS_STEPS steps at SGD_LR with finite, falling
    losses; launches exact."""
    import torch

    from tpu_dra_torch.workloads.moe import PinnedChoices, make_moe_train_step
    from tpu_dra_torch.workloads.train import tree_leaves
    cfg, r = moe_cfg(), mesh.rank
    L = cfg.n_layers
    wins = moe_windows(tmp, mesh.device)
    step, p_shard, _ = make_moe_train_step(cfg, mesh, lr=1.0,
                                           attn_impl="flash")
    params = staggered_shards(mesh, lambda: moe_params(cfg), p_shard)
    saved = torch.load(tmp / "moe30.pt", mmap=True)
    rows = rows_of(mesh, wins[0].shape[0] * (wins[0].shape[1] - 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PinnedChoices() as pin:
        (new, loss), launches = counted(lambda: step(params, wins[0]))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    differ = routes_differing(pin.recorded, saved["routes"], rows)
    pinned = False
    if differ:
        del new
        replay = [t[rows].to(mesh.device) for t in saved["routes"]]
        with PinnedChoices.replaying(replay) as pin:
            (new, loss), more = counted(lambda: step(params, wins[0]))
        add_counts(launches, more)
        pinned = True
    steps = 2 if pinned else 1
    if launches != flash_want(L * steps):
        fail(f"30a rank {r}: launches {launches}, expected "
             f"{flash_want(L * steps)}")
    upd = leaf_updates(params, new, 1.0)
    del new
    want = tree_to(mesh.shard_tree(saved["upd"], p_shard), mesh.device)
    hold_sharded_step(f"30a EP SGD across {mesh.size} processes, rank {r}"
                      + (" (routes replayed)" if pinned else ""), mesh, loss,
                      upd, saved["loss"], want)
    mine = float(loss) == saved["loss"] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(upd),
                                          tree_leaves(want)))
    bit_equal = bool(mesh.psum(torch.tensor(float(mine),
                                            device=mesh.device))
                     == mesh.size)
    del upd, want, saved
    gc.collect()
    torch.cuda.empty_cache()
    step, _, _ = make_moe_train_step(cfg, mesh, lr=SGD_LR, attn_impl="flash")
    with tp_timers() as spent:
        run = train_loop(f"30a EP SGD across processes, rank {r}", step,
                         params, wins[1:], flash_counters())
    if run["launches"] != flash_want(L * PROCESS_STEPS):
        fail(f"30a rank {r}: launches {run['launches']}, expected "
             f"{flash_want(L * PROCESS_STEPS)}")
    add_counts(launches, run["launches"])
    del run["params"], params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "differ": differ, "pinned": pinned,
            "bit_equal": bit_equal, "one_s": one_s,
            "routes": len(pin.recorded) * (rows.stop - rows.start),
            "losses": run["losses"], "step_ms": run["step_ms"],
            "first_ms": run["first_ms"], "total_ms": run["total_ms"],
            "gloo_s": spent["gloo"], "peak_gb": run["peak_gb"]}


@contextlib.contextmanager
def local_drops(cfg):
    """Count, while the block runs, the tokens whose kept choices the
    router would change if it routed this process's rows alone (its own
    capacity, no other rank's counts) instead of claiming the global
    slots (``moe.process_route`` wrapped, forward calls only)."""
    import torch

    from tpu_dra_torch.workloads import moe as M
    real, seen = M.process_route, {"tokens": 0, "calls": 0}

    def plain_top_k(probs, k):
        return torch.topk(probs, k, dim=-1)

    def call(cfg_, flat, wg, capacity, mesh):
        out = real(cfg_, flat, wg, capacity, mesh)
        if torch.is_grad_enabled() and seen["calls"] < cfg.n_layers:
            pinned, M._top_k = M._top_k, plain_top_k   # out of any record
            try:
                with torch.no_grad():
                    alone = M.route(cfg_, flat, wg,
                                    cfg_.capacity(flat.shape[0]))
            finally:
                M._top_k = pinned
                kept = out[3].sum(-1) > 0                 # [K, N, E]
                kept_alone = alone[3].sum(-1) > 0
                seen["tokens"] += int((kept != kept_alone).any(0).any(-1)
                                      .sum())
            seen["calls"] += 1
        return out
    M.process_route = call
    try:
        yield seen
    finally:
        M.process_route = real


def digests(tree: dict) -> list:
    """A sha256 of each leaf's bytes (held on the host, so that a run's
    bits can be compared with a later run's after the first is freed)."""
    import hashlib
    return [hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
            for v in flat_leaves(tree).values()]


def process_moe_optax(tmp: Path, mesh) -> dict:
    """30b in one process on ``ProcessMesh(EP_OPTAX_AXES)``: the MoE at
    MOE_PROCESS_RUN["optax_layers"] layers, make_moe_optax_step
    replicated, then ZeRO-1, each for PROCESS_STEPS steps from the same
    shards (one run on the card at a time: four processes share it),
    bit-equal after every step (the losses, and digests of the
    parameters and of the replicated moments cut as ZeRO-1 cuts them);
    the first held to the virtual mesh's (loss and first moments); the
    moment bytes; launches exact."""
    import math

    import torch

    from tpu_dra_torch.workloads.moe import (PinnedChoices,
                                             init_moe_params,
                                             make_moe_optax_step)
    from tpu_dra_torch.workloads.optim import AdamW
    from tpu_dra_torch.workloads.train import (opt_state_bytes_per_rank,
                                               opt_state_shardings,
                                               param_shapes, tree_leaves)
    cfg, r = moe_cfg(MOE_PROCESS_RUN["optax_layers"]), mesh.rank
    L = cfg.n_layers
    wins = moe_windows(tmp, mesh.device)[:PROCESS_STEPS]
    shapes = param_shapes(cfg, init_moe_params)
    made = {zero1: make_moe_optax_step(cfg, mesh, attn_impl="flash",
                                       zero1=zero1)
            for zero1 in (False, True)}
    cut = made[True][1].layout.cut
    saved = torch.load(tmp / "moe30b.pt", mmap=True)
    rows = rows_of(mesh, wins[0].shape[0] * (wins[0].shape[1] - 1))
    counters = flash_counters()
    timed = {"psum": [(type(mesh), "psum")], "optimizer": [(AdamW,
                                                            "update")]}
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    runs, differ, drops = {}, 0, 0
    for zero1, (step, init, p_shard, _) in made.items():
        params = staggered_shards(mesh, lambda: moe_params(cfg), p_shard)
        sh, _ = opt_state_shardings(None, shapes, p_shard, mesh, zero1)
        opt = init(params)
        run = {"losses": [], "ms": [], "spent": [], "bits": [],
               "bytes": [8 * sum(t.numel() for t in tree_leaves(opt.mu)),
                         opt_state_bytes_per_rank(sh, shapes, mesh)]}
        for i, win in enumerate(wins):
            with tp_timers(timed) as spent, PinnedChoices() as pin, \
                    local_drops(cfg) as dropped:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, loss = step(params, opt, win)
                torch.cuda.synchronize()
                run["ms"].append(1e3 * (time.perf_counter() - t0))
            run["spent"].append(dict(spent))
            run["losses"].append(float(loss))
            moments = [opt.mu, opt.nu] if zero1 else [cut(opt.mu),
                                                      cut(opt.nu)]
            run["bits"].append([digests(t) for t in (params, *moments)])
            del moments
            if i == 0 and not zero1:
                differ = routes_differing(pin.recorded, saved["routes"],
                                          rows)
                drops = dropped["tokens"]
                hold_sharded_step(
                    f"30b MoE AdamW across {mesh.size} processes, rank {r}",
                    mesh, loss, opt.mu, saved["loss"],
                    tree_to(mesh.shard_tree(saved["mu"], p_shard),
                            mesh.device),
                    what="the first moment after one AdamW step")
        runs[zero1] = run
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
    del saved
    a, b = runs[False], runs[True]
    for run in (a, b):
        if run["bytes"][0] != run["bytes"][1]:
            fail(f"30b rank {r}: a process holds {run['bytes'][0]} moment "
                 f"bytes, opt_state_bytes_per_rank says {run['bytes'][1]}")
    if 2 * b["bytes"][0] != a["bytes"][0]:
        fail(f"30b rank {r}: ZeRO-1 holds {b['bytes'][0]} moment bytes, "
             f"not half of the replicated {a['bytes'][0]}")
    for i in range(len(wins)):
        if a["losses"][i] != b["losses"][i] or a["bits"][i] != b["bits"][i]:
            fail(f"30b rank {r}: ZeRO-1 after step {i + 1} is not bit-equal "
                 f"to the replicated run")
    launches = read_counts(counters)
    if launches != flash_want(L * 2 * len(wins)):
        fail(f"30b rank {r}: launches {launches}, expected "
             f"{flash_want(L * 2 * len(wins))}")
    if not all(math.isfinite(x) for x in a["losses"]):
        fail(f"30b rank {r}: losses {a['losses']}")
    out = {"launches": launches, "losses": a["losses"], "differ": differ,
           "drops": drops, "tokens": rows.stop - rows.start,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bytes": [a["bytes"][0], b["bytes"][0]]}
    for name, run in (("a", a), ("b", b)):
        out[name] = {"ms": run["ms"], "spent": run["spent"]}
    return out


def moe_fit_check(tmp: Path, mesh) -> dict:
    """30c in one process: ``fit`` of the MoE at 30b's depth on the process
    mesh (zero1, flash) on 26's corpus at MOE_PROCESS_RUN's batch:
    uninterrupted, then saved at fit_save in ``tmp/ck30`` and resumed to
    fit_steps (no second save); the resumed losses and the last step's
    shards and moments bit-equal to the uninterrupted run's; launches
    exact."""
    import torch

    from tpu_dra_torch.workloads.fit import fit
    cfg, run = moe_cfg(MOE_PROCESS_RUN["optax_layers"]), MOE_PROCESS_RUN
    lines: list = []
    kw = dict(mesh=mesh, batch=run["batch"], attn_impl="flash", zero1=True,
              log_every=1, log_fn=lines.append)
    data, ck = str(tmp / "tokens.bin"), str(tmp / "ck30")
    counters = flash_counters()
    zero_counts(counters)

    def kept_on_host(last: dict) -> dict:
        """The last step's shards and moments, copied to the host, and
        the card's copies let go (four processes share the card)."""
        out = {"params": tree_to(last["params"], "cpu"),
               "mu": tree_to(last["opt"].mu, "cpu"),
               "nu": tree_to(last["opt"].nu, "cpu")}
        last.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return out
    t0 = time.perf_counter()
    with kept_state("make_moe_optax_step") as last:
        full = fit(cfg, data, steps=run["fit_steps"], **kw)
        want = kept_on_host(last)
        fit(cfg, data, steps=run["fit_save"], checkpoint_dir=ck,
            checkpoint_every=run["fit_save"], **kw)
        kept_on_host(last)
        resumed = fit(cfg, data, steps=run["fit_steps"] - run["fit_save"],
                      checkpoint_dir=ck, resume=True, **kw)
        got = kept_on_host(last)
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    expect = flash_want(cfg.n_layers * 2 * run["fit_steps"])
    if launches != expect:
        fail(f"30c rank {mesh.rank}: launches {launches}, expected {expect}")
    same = (resumed.losses == full.losses[run["fit_save"]:]
            and resumed.step == run["fit_steps"]
            and all(same_trees(want[k], got[k])
                    for k in ("params", "mu", "nu")))
    if not same:
        fail(f"30c rank {mesh.rank}: the resumed run is not bit-equal to "
             f"the uninterrupted one: losses {resumed.losses} against "
             f"{full.losses}")
    del want, got, last
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": full.losses, "seconds": secs,
            "save_s": timed_lines(lines, r"saved in ([0-9.]+) s"),
            "restore_s": timed_lines(lines, r"restored in ([0-9.]+) s")}


def adapter_errors(got: dict, want: dict) -> dict:
    """Relative L2 of each adapter leaf of ``got`` against ``want``."""
    return {k: float((g.float() - want[k].to(g.device).float()).norm()
                     / want[k].float().norm())
            for k, g in flat_leaves(got).items()}


def flat_leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(flat_leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


def same_everywhere(mesh, tree: dict) -> bool:
    """Whether every process holds ``tree``'s bits (a digest of them
    gathered over the group)."""
    import hashlib

    import torch.distributed as dist
    digest = hashlib.sha256()
    for v in flat_leaves(tree).values():
        digest.update(v.detach().cpu().numpy().tobytes())
    digests = [None] * mesh.size
    dist.all_gather_object(digests, digest.hexdigest(), group=mesh.group)
    return len(set(digests)) == 1


def process_lora(tmp: Path, mesh) -> dict:
    """30d in one process on ``ProcessMesh(LORA_AXES)``: the serving
    model's base cut by ``param_shardings`` and its rank-r adapters,
    PROCESS_STEPS make_lora_train_step steps (flash) held to the virtual
    mesh's: each loss within STEP_LOSS_ATOL and each adapter leaf's
    first moment after step 1 within STEP_LEAF_REL (as 28a holds the
    AdamW step: an update moves each element by about ±lr whatever a
    near-zero gradient's sign, so the adapters after the steps are
    printed, not held); the base's bits kept, the adapters' the same in
    every process, launches exact (#4: the model's 8 heads over 2 kv
    heads, 4 over 1 a tp rank); then one step from fresh adapters over
    the int8 base cut by ``serving_param_shardings``, held to the
    virtual mesh's QLoRA step alike."""
    import torch

    from tpu_dra_torch.workloads.lora import LoRAConfig, make_lora_train_step
    from tpu_dra_torch.workloads.quant import (quantize_params_int8,
                                               serving_param_shardings)
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg, r = ModelConfig(**MODEL), mesh.rank
    L = cfg.n_layers
    wins = moe_windows(tmp, mesh.device)[:PROCESS_STEPS]
    saved = torch.load(tmp / "lora30.pt", mmap=True)
    base, lora = lora_trees(cfg)
    fresh = tree_to(lora, "cpu")
    step, init, _, sh = make_lora_train_step(
        cfg, mesh, LoRAConfig(rank=MOE_PROCESS_RUN["rank"]),
        attn_impl="flash")
    local = mesh.shard_tree(base, sh["params"])
    before = tree_to(local, "cpu")
    opt, losses, ms, mu1 = init(lora), [], [], {}

    def loop():
        nonlocal lora, opt
        for win in wins:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lora, opt, loss = step(local, lora, opt, win)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if not mu1:
                mu1.update(tree_to(opt.mu, "cpu"))
    with tp_timers() as spent:
        _, launches = counted(loop, gqa=True)
    want = {"flash_fwd_gqa": 2 * L * len(wins),
            "flash_bwd_dq": L * len(wins), "flash_bwd_dkdv": L * len(wins)}
    if launches != want:
        fail(f"30d rank {r}: launches {launches}, expected {want}")
    errs = adapter_errors(mu1, flat_leaves(saved["mu1"]))
    after = adapter_errors(lora, flat_leaves(saved["lora"]))
    dl = max(abs(a - b) for a, b in zip(losses, saved["losses"]))
    worst = max(errs, key=errs.get)
    kept = same_trees(tree_to(local, "cpu"), before)
    agree = same_everywhere(mesh, lora)
    if not (dl <= STEP_LOSS_ATOL and errs[worst] <= STEP_LEAF_REL and kept
            and agree):
        fail(f"30d rank {r}: losses |d| {dl}, adapter {worst}'s first "
             f"moment {errs[worst]}, base kept {kept}, adapters the same in "
             f"every process {agree}")
    del local, before
    qbase = quantize_params_int8(base)
    specs = serving_param_shardings(cfg, mesh, qbase)
    qlocal = mesh.shard_tree(qbase, specs)
    q_lora = tree_to(fresh, mesh.device)
    (q_lora, q_opt, q_loss), q_launches = counted(
        lambda: step(qlocal, q_lora, init(q_lora), wins[0],
                     base_specs=specs), gqa=True)
    add_counts(launches, q_launches)
    q_errs = adapter_errors(q_opt.mu, flat_leaves(saved["q_mu1"]))
    q_after = adapter_errors(q_lora, flat_leaves(saved["q_lora"]))
    q_dl = abs(float(q_loss) - saved["q_loss"])
    q_worst = max(q_errs, key=q_errs.get)
    q_agree = same_everywhere(mesh, q_lora)
    if not (q_dl <= STEP_LOSS_ATOL and q_errs[q_worst] <= STEP_LEAF_REL
            and q_agree):
        fail(f"30d QLoRA rank {r}: loss |d| {q_dl}, adapter {q_worst}'s "
             f"first moment {q_errs[q_worst]}, adapters the same in every "
             f"process {q_agree}")
    del qbase, qlocal, q_lora, q_opt, lora, opt, saved
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "ms": ms,
            "gloo_s": spent["gloo"], "loss_d": dl,
            "worst": [worst, errs[worst]], "after": max(after.values()),
            "q_loss_d": q_dl, "q_worst": [q_worst, q_errs[q_worst]],
            "q_after": max(q_after.values())}


def process_serving(mesh) -> dict:
    """30e in one process on ``ProcessMesh(SERVE_AXES)``: the serving
    model's int8 and int4 trees (from the seed's fp32 tree) cut by
    ``serving_param_shardings`` and gathered back, every leaf's dtype,
    shape and bytes equal; the spec tree the virtual mesh's of the same
    axes."""
    import torch

    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.quant import (quantize_params_int4,
                                               quantize_params_int8,
                                               serving_param_shardings)
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    out = {}
    for form, quant in (("int8", quantize_params_int8),
                        ("int4", quantize_params_int4)):
        tree = quant(params)
        specs = serving_param_shardings(cfg, mesh, tree)
        if specs != serving_param_shardings(cfg, Mesh(SERVE_AXES), tree):
            fail(f"30e {form}, rank {mesh.rank}: the process mesh's specs "
                 f"differ from the virtual mesh's")
        t0 = time.perf_counter()
        local = mesh.shard_tree(tree, specs)
        back = mesh.unshard_tree(local, specs)
        secs = time.perf_counter() - t0
        leaves = 0
        for k, a in flat_leaves(tree).items():
            b = flat_leaves(back)[k]
            leaves += 1
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not torch.equal(a, b):
                fail(f"30e {form}, rank {mesh.rank}: {k} changed through "
                     f"the process shards")
        out[form] = {"leaves": leaves, "s": secs,
                     "local_bytes": sum(t.numel() * t.element_size() for t in
                                        flat_leaves(local).values()),
                     "bytes": sum(t.numel() * t.element_size() for t in
                                  flat_leaves(tree).values()),
                     "wo": specs["blocks"]["wo"]}
        del tree, local, back
    del params
    torch.cuda.empty_cache()
    return out


def log_moe(ranks: list, card: str) -> dict:
    """Phase 30's figures from each rank's results; returns its launches
    summed over the ranks."""
    total: dict = {}
    for r, res in enumerate(ranks):
        m = res["moe"]
        ep = m["a"]
        log(f"[mp30] 30a rank {r}: the flagship MoE (8 experts, top-2) on "
            f"dp 1 × ep {PROCESSES}: routes differing from the virtual "
            f"step's unpinned {ep['differ']} of {ep['routes']} "
            f"(replayed: {ep['pinned']}); the lr-1 step bit-equal to the "
            f"virtual mesh's: {ep['bit_equal']} ({ep['one_s']:.2f} s); "
            f"{PROCESS_STEPS} steps, losses {ep['losses']}, step "
            f"{ep['step_ms']:.1f} ms (median of the steps after the first; "
            f"first {ep['first_ms']:.1f}), gloo collectives "
            f"{ep['gloo_s'] * 1e3:.1f} ms "
            f"({ep['gloo_s'] * 1e3 / ep['total_ms']:.3f} of the steps; host "
            f"clock, each call synchronized), peak memory "
            f"{ep['peak_gb']:.2f} GB; launches {ep['launches']} (exact); "
            f"on {card}")
        add_counts(total, ep["launches"])
        op = m["b"]
        for name, run in (("30b replicated", op["a"]), ("30b ZeRO-1",
                                                        op["b"])):
            log(f"[mp30] {name} rank {r}: {PROCESS_STEPS} MoE AdamW steps "
                f"on dp 2 × ep 2 at depth {MOE_PROCESS_RUN['optax_layers']}; "
                + "; ".join(
                    f"step {i + 1} {ms:.1f} ms: gloo collectives "
                    f"{sp['gloo'] * 1e3 / ms:.3f} of it, the gradient psum "
                    f"{sp['psum'] * 1e3 / ms:.3f}, the optimizer "
                    f"{sp['optimizer'] * 1e3 / ms:.3f}"
                    for i, (ms, sp) in enumerate(zip(run["ms"],
                                                     run["spent"])))
                + f" (host clock, synced; informational); on {card}")
        log(f"[mp30] 30b rank {r}: losses {op['losses']}, ZeRO-1 bit-equal "
            f"to replicated after every step, moment bytes a process "
            f"{op['bytes'][1]} against {op['bytes'][0]}; routes differing "
            f"from the virtual step's {op['differ']}; token-layers whose "
            f"kept choices the rows' routing alone (their own capacity, no "
            f"other rank's counts) would change in the first step's "
            f"forward: {op['drops']} of {op['tokens']} tokens x depth "
            f"{MOE_PROCESS_RUN['optax_layers']}; peak memory "
            f"{op['peak_gb']:.2f} GB; launches {op['launches']} (exact); "
            f"on {card}")
        add_counts(total, op["launches"])
        ft = m["c"]
        log(f"[mp30] 30c rank {r}: MoE fit on dp 2 × ep 2 at depth "
            f"{MOE_PROCESS_RUN['optax_layers']}, zero1: losses "
            f"{ft['losses']}, the resumed run bit-equal; saves "
            f"{ft['save_s']} s, restore {ft['restore_s']} s; launches "
            f"{ft['launches']} (exact); 30c {ft['seconds']:.1f} s; on {card}")
        add_counts(total, ft["launches"])
        lo = m["d"]
        log(f"[mp30] 30d rank {r}: LoRA r {MOE_PROCESS_RUN['rank']} on dp 2 "
            f"× tp 2, the serving model: losses {lo['losses']} (|d| "
            f"{lo['loss_d']:.2e} against the virtual mesh's), worst first "
            f"moment after step 1 {lo['worst'][0]} relative L2 "
            f"{lo['worst'][1]:.3e} (the adapters after the steps: worst "
            f"{lo['after']:.3e}, informational); the int8 base's step |d| "
            f"{lo['q_loss_d']:.2e}, worst first moment {lo['q_worst'][0]} "
            f"{lo['q_worst'][1]:.3e} (adapters {lo['q_after']:.3e}); base "
            f"kept, adapters the same in all {PROCESSES}; steps "
            + ", ".join(f"{x:.1f}" for x in lo["ms"])
            + f" ms, gloo {lo['gloo_s'] * 1e3:.1f} ms of them (host clock, "
            f"synced); launches {lo['launches']} (exact); on {card}")
        add_counts(total, lo["launches"])
        for form, sv in m["e"].items():
            log(f"[mp30] 30e rank {r}: the {form} serving tree "
                f"({sv['leaves']} leaves, {sv['bytes']} B; this process's "
                f"shards {sv['local_bytes']} B) cut on dp 1 × tp "
                f"{PROCESSES} and gathered back byte-equal in "
                f"{sv['s']:.2f} s, specs the virtual mesh's (wo's "
                f"{sv['wo']}); on {card}")
        log(f"[mp30] rank {r}: 30a {res['moe_a_s']:.1f} s, 30b "
            f"{res['moe_b_s']:.1f} s, 30c {res['moe_c_s']:.1f} s, 30d "
            f"{res['moe_d_s']:.1f} s, 30e {res['moe_e_s']:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 31: tensor-parallel decoding and the dry run one process a rank
# ---------------------------------------------------------------------------

TP_DECODE_AXES = {"dp": 1, "tp": 2}          # 31a
TP_DECODE_RUN = dict(prompts=8, length=128, steps=32, page_size=64)
TP_DECODE_SEED = SEED + 3100
TP_DECODE_CHILD = ("import sys, chip_smoke; "
                   "sys.exit(chip_smoke.tp_decode_rank(sys.argv[1]))")
# the fixed CPU workload of host_speed: a pure-Python loop of this many
# integer additions and a float64 sort of this many numbers
HOST_ADDS = 20_000_000
HOST_SORT = 1 << 22


def host_speed() -> float:
    """Seconds of a fixed single-threaded CPU workload (HOST_ADDS Python
    additions, then numpy's sort of HOST_SORT seeded float64s): the
    host's speed, printed beside the script's host-clock times."""
    import numpy as np
    t0 = time.perf_counter()
    acc = 0
    for i in range(HOST_ADDS):
        acc += i
    np.sort(np.random.default_rng(0).standard_normal(HOST_SORT))
    return time.perf_counter() - t0


def tp_decode_tree(form: str = "int8"):
    """31a's (config, serving tree) from TP_DECODE_SEED, int8 or its bf16
    cast, on the card (every process draws the same tree)."""
    import torch

    from tpu_dra_torch.workloads.quant import (cast_params_bf16,
                                               quantize_params_int8)
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_DECODE_SEED)
    params = init_params(cfg, gen)
    return cfg, (quantize_params_int8(params) if form == "int8"
                 else cast_params_bf16(params))


def logit_gap(got, want) -> dict:
    """Where ``got`` ``[B, V]`` fp32 logits part most from ``want``: the
    largest gap over every entry, the ``|logit|`` there and the gap in
    bf16 ulps at it; and the largest over each row's entries within
    ``argmax_tol`` of its top (those an argmax reads)."""
    import torch
    d = (got - want).abs()
    at = int(torch.argmax(d))
    top = want.max(dim=-1, keepdim=True).values
    tol = torch.tensor([[argmax_tol(float(t))] for t in top[:, 0]])
    near = want >= top - tol
    mag = abs(float(want.flatten()[at]))
    ulp = 2.0 ** (math.floor(math.log2(max(mag, 2.0 ** -100))) - 7)
    return {"max": float(d.max()), "at": mag,
            "ulps": float(d.flatten()[at]) / ulp,
            "near_top": float(d[near].max())}


def tp_residual_gaps(cfg, prompts, traces: dict, logits: dict) -> dict:
    """31a's account of its first-step logit gap, for the int8 tree and
    its bf16 cast (``traces``: the tensor-parallel prefill's activations
    after the embedding and each layer, ``[L + 1, B, S, D]``; ``logits``
    its first-step logits).  Per layer l: the gap to one device's
    activations; the gap this layer adds itself (the tensor-parallel
    output against one device's block on the same tensor-parallel input);
    and the first-step logits from the tensor-parallel activations of
    layer l through one device's layers above and head, against one
    device's logits (how far layer l's gap carries).  Logged; returns the
    logit gaps by form (:func:`logit_gap`)."""
    import torch

    from tpu_dra_torch.workloads.train import (_block, attn_impl_fn,
                                               embed_tokens, head_logits,
                                               layer_params)
    attn_fn = attn_impl_fn("dense")
    out = {}
    for form, tp in traces.items():
        _, tree = tp_decode_tree(form)
        layers = [layer_params(tree["blocks"], i)
                  for i in range(cfg.n_layers)]
        tp = tp.cuda()

        def above(x, start):
            for layer in layers[start:]:
                x = _block(cfg, x, layer, attn_fn)
            return head_logits(tree, x[:, -1:])[:, 0].float().cpu()
        with torch.no_grad():
            one = [embed_tokens(cfg, tree, prompts)]
            for layer in layers:
                one.append(_block(cfg, one[-1], layer, attn_fn))
            want = head_logits(tree, one[-1][:, -1:])[:, 0].float().cpu()
            for i in range(cfg.n_layers + 1):
                d = (tp[i].float() - one[i].float()).abs()
                line = (f"[mp31] 31a {form} layer {i}: |x_tp - x_one| max "
                        f"{float(d.max()):.4f} of |x| up to "
                        f"{float(one[i].abs().max()):.2f} (in "
                        f"{float((d > 0).float().mean()):.2e} of the "
                        f"elements)")
                if i:
                    own = (tp[i].float() - _block(
                        cfg, tp[i - 1], layers[i - 1], attn_fn).float()).abs()
                    line += (f"; added by this layer {float(own.max()):.4f} "
                             f"({float((own > 0).float().mean()):.2e} of "
                             f"the elements)")
                carried = float((above(tp[i], i) - want).abs().max())
                log(f"{line}; the logits from here through one device's "
                    f"layers above {carried:.4f} from its own")
        out[form] = logit_gap(logits[form].float(), want)
        g = out[form]
        log(f"[mp31] 31a {form}: first-step logits {g['max']:.4f} from one "
            f"device's at a logit of magnitude {g['at']:.3f} ("
            f"{g['ulps']:.1f} bf16 ulps there); {g['near_top']:.4f} over "
            f"the entries within argmax_tol of each row's top")
        del tree, layers, one, tp
    return out


def tree_bytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size()
               for t in flat_leaves(tree).values() if hasattr(t, "numel"))


def tp_decode_rank(tmp: str) -> int:
    """One of 31a's two processes (started by ``tp_decode_phase``): it
    joins the gloo group, keeps its serving shards of the int8 tree on
    ProcessMesh(TP_DECODE_AXES), decodes ``tmp``'s prompts
    tensor-parallel on the slab and on pages, and writes its tokens,
    first-step logits, launches, bytes and times to ``tmp``."""
    import torch
    import torch.distributed as dist

    from tpu_dra_torch.workloads import paged_kv
    from tpu_dra_torch.workloads.decode import greedy_decode
    from tpu_dra_torch.workloads.launcher import resolve
    from tpu_dra_torch.workloads.mesh import ProcessMesh
    from tpu_dra_torch.workloads.process_decode import (TPModel,
                                                        first_logits,
                                                        local_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    resolve().initialize("gloo")
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    mesh = ProcessMesh(TP_DECODE_AXES)
    cfg, tree = tp_decode_tree()
    local = local_tree(cfg, mesh, tree)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    inputs = torch.load(Path(tmp) / "inputs.pt")
    prompts = inputs["prompts"].cuda()
    table = inputs["table"].cuda()
    run = TP_DECODE_RUN
    max_len = run["length"] + run["steps"]
    out = {"bytes": tree_bytes(local)}

    def synced(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    logits, out["prefill_s"] = synced(lambda: first_logits(
        cfg, local, prompts, mesh, max_len=max_len))
    torch.save(logits.cpu(), Path(tmp) / f"logits{rank}.pt")
    # the first decode step's launches held to the plain version; the
    # kernel's wrapper counts its launches on the module's name, which
    # is this one's while it stands in
    kernel, seen = paged_kv.paged_attention, {"n": 0, "err": 0.0}

    def checked(*a, **k):
        got = kernel(*a, **k)
        if seen["n"] < cfg.n_layers:
            want = paged_kv.paged_attention_ref(*a, **k)
            seen["err"] = max(seen["err"], float(
                paged_kv.slot_rel_err(got, want).max()))
            seen["n"] += 1
            seen["shape"] = list(a[0].shape)
        return got
    for layout in ("slab", "paged"):
        checked.launches = 0
        paged_kv.paged_attention = checked
        with tp_timers() as spent:
            if layout == "slab":
                toks, secs = synced(lambda: greedy_decode(
                    cfg, local, prompts, steps=run["steps"],
                    max_len=max_len, mesh=mesh))
            else:
                toks, secs = synced(lambda: paged_kv.paged_greedy_decode(
                    cfg, local, prompts, table, steps=run["steps"],
                    total_pages=inputs["total_pages"],
                    page_size=run["page_size"], mesh=mesh))
        paged_kv.paged_attention = kernel
        out[layout] = {"tokens": toks.tolist(), "s": secs,
                       "gloo_s": spent["gloo"],
                       "launches": checked.launches}
    out["check"] = seen
    # the prefill's activations layer by layer, of the int8 tree and of
    # its bf16 cast, for the parent's account of the logit gap
    for form in ("int8", "bf16"):
        tree = local if form == "int8" else local_tree(
            cfg, mesh, tp_decode_tree(form)[1])
        trace = []
        with torch.no_grad():
            TPModel(cfg, tree, mesh).prefill_kv(prompts, trace=trace)
            lg = first_logits(cfg, tree, prompts, mesh, max_len=max_len)
        if rank == 0:
            torch.save({"trace": torch.stack(trace).cpu(), "logits": lg.cpu()},
                       Path(tmp) / f"trace_{form}.pt")
        del tree, trace
    mesh.close()
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def tp_decode_phase(card: str) -> dict:
    """31a (see the module's docstring): the one-device decoders in this
    process, then the two processes; returns #1's launches summed over
    them."""
    import torch

    from tpu_dra_torch.workloads.decode import (greedy_decode,
                                                init_kv_cache, prefill)
    from tpu_dra_torch.workloads.launcher import run_local_group
    from tpu_dra_torch.workloads.paged_kv import (PagePool,
                                                  paged_greedy_decode)
    run = TP_DECODE_RUN
    cfg, tree = tp_decode_tree()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TP_DECODE_SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (run["prompts"], run["length"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    max_len = run["length"] + run["steps"]
    need = -(-max_len // run["page_size"])
    pool = PagePool(run["prompts"] * need, run["page_size"])
    import numpy as np
    table = torch.as_tensor(np.stack([pool.table_row(pool.alloc(need), need)
                                      for _ in range(run["prompts"])]),
                            dtype=torch.int32)
    with torch.no_grad():
        _, want_logits = prefill(cfg, tree, init_kv_cache(
            cfg, run["prompts"], max_len), prompts)
        want = {"slab": greedy_decode(cfg, tree, prompts, steps=run["steps"],
                                      max_len=max_len).tolist(),
                "paged": paged_greedy_decode(
                    cfg, tree, prompts, table.cuda(), steps=run["steps"],
                    total_pages=pool.total_pages,
                    page_size=run["page_size"]).tolist()}
    whole = tree_bytes(tree)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-31-") as tmp:
        torch.save({"prompts": prompts.cpu(), "table": table,
                    "total_pages": pool.total_pages}, Path(tmp) / "inputs.pt")
        t0 = time.perf_counter()
        run_local_group([sys.executable, "-c", TP_DECODE_CHILD, tmp], 2,
                        timeout=PROCESS_WAIT, cwd=str(HERE),
                        env=child_env())
        group_s = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
        logits = [torch.load(Path(tmp) / f"logits{r}.pt") for r in range(2)]
        traced = {form: torch.load(Path(tmp) / f"trace_{form}.pt")
                  for form in ("int8", "bf16")}
    rows = [p.tolist() for p in prompts]
    n_layers, decode_steps = cfg.n_layers, run["steps"] - 1
    launches = 0
    for layout in ("slab", "paged"):
        answers = ranks[0][layout]["tokens"]
        if ranks[1][layout]["tokens"] != answers:
            fail(f"31a {layout}: the two processes' tokens differ")
        departures(f"31a tp-2 {layout}", cfg, tree, rows, answers,
                   want[layout])
    want_logits = want_logits.float().cpu()
    top = want_logits.max(dim=-1).values
    tol = torch.tensor([argmax_tol(float(t)) for t in top])
    logit_err = 0.0
    for r, lg in enumerate(logits):
        err = (lg.float() - want_logits).abs().max(dim=-1).values
        logit_err = max(logit_err, float(err.max()))
        if bool((err > tol).any()):
            fail(f"31a rank {r}: first-step logits {float(err.max()):.4f} "
                 f"from the one-device logits (tolerance per row "
                 f"{tol.tolist()})")
    tp_residual_gaps(cfg, prompts,
                     {f: t["trace"] for f, t in traced.items()},
                     {f: t["logits"] for f, t in traced.items()})
    for r, res in enumerate(ranks):
        for layout in ("slab", "paged"):
            got = res[layout]["launches"]
            if got != (n_layers * decode_steps if layout == "paged" else 0):
                fail(f"31a rank {r} {layout}: #1 launched {got} times over "
                     f"{decode_steps} decode steps of {n_layers} layers")
        chk = res["check"]
        if chk["n"] != n_layers or chk["err"] > 0.02:
            fail(f"31a rank {r}: the first step's #1 launches against the "
                 f"plain version {chk}")
        launches += res["paged"]["launches"]
        per_tok = {layout: (res[layout]["s"] - res["prefill_s"])
                   / decode_steps * 1e3 for layout in ("slab", "paged")}
        log(f"[mp31] 31a rank {r}: #1 {res['paged']['launches']} launches "
            f"over {decode_steps} decode steps ({n_layers} a step, exact) "
            f"on q {chk['shape']}, its first step within "
            f"{chk['err']:.2e} of the plain version; resident weights "
            f"{res['bytes'] / 1e6:.1f} MB against half the one-device "
            f"tree's {whole / 2e6:.1f} MB ({res['bytes'] / whole:.4f} of "
            f"it); per token (host clock, synced, prefill "
            f"{res['prefill_s'] * 1e3:.1f} ms taken off): slab "
            f"{per_tok['slab']:.2f} ms, paged {per_tok['paged']:.2f} ms, "
            f"gloo {res['slab']['gloo_s'] / res['slab']['s']:.3f} and "
            f"{res['paged']['gloo_s'] / res['paged']['s']:.3f} of the "
            f"decode calls (informational); on {card}")
        if res["bytes"] > 0.51 * whole:
            fail(f"31a rank {r}: {res['bytes']} resident weight bytes, more "
                 f"than half the one-device tree's {whole}")
    log(f"[mp31] 31a: {run['prompts']} prompts of {run['length']} tokens, "
        f"{run['steps']} greedy steps tensor-parallel on tp 2 (int8), slab "
        f"and pages of {run['page_size']}, held to the one-device decoders; "
        f"the first-step logits within {logit_err:.4f} of the one-device "
        f"logits (tolerance {float(tol.min()):.4f}-{float(tol.max()):.4f}); "
        f"the group {group_s:.1f} s")
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_attention": launches}


def dryrun_phase(card: str) -> dict:
    """31b: ``entry.dryrun_multichip(4, processes=True, backend="gloo")``
    on the card (its ranks' ``DRYRUN_LAUNCHES`` lines and its
    MULTICHIP_REPORT line print on earlier lines); returns the launches
    summed over its ranks, each of #1, #3, #6, #7 and #9-#11 at least
    once."""
    from tpu_dra_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    report, total = dryrun_multichip(PROCESSES, processes=True,
                                     backend="gloo", return_launches=True)
    secs = time.perf_counter() - t0
    missing = [k for k in ("paged_attention", "flash_fwd", "flash_bwd_dq",
                           "flash_bwd_dkdv", "all_gather_matmul",
                           "matmul_reduce_scatter", "ring_shift")
               if not total.get(k)]
    if missing or len(report["strategies"]) != 7:
        fail(f"31b: the dry run launched no {missing} (launches {total}), "
             f"strategies {sorted(report['strategies'])}")
    log(f"[mp31] 31b: dryrun_multichip({PROCESSES}, processes=True) on "
        f"mesh {report['mesh']}, {secs:.1f} s; launches summed over the "
        f"ranks {total}; on {card}")
    return total


def tp_phase(card: str) -> dict:
    """Phase 31 (31a, then 31b); returns their launches summed."""
    t0 = time.perf_counter()
    launches = tp_decode_phase(card)
    log(f"[time] phase 31a {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(launches, dryrun_phase(card))
    log(f"[time] phase 31b {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    if not (HERE / "tpu_dra_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tpu_dra_torch package beside {__file__}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from tpu_dra_torch.kernels.build import build_all
    # fp32 matmuls in full precision (the plain versions compare in fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"[host] a fixed CPU workload ({HOST_ADDS} Python additions, a "
        f"sort of {HOST_SORT} float64s): {host_speed():.2f} s (the host's "
        f"speed, beside which the [time] lines compare)")
    t_start = time.perf_counter()

    def lap(phases: str) -> None:
        log(f"[time] phases {phases} done {time.perf_counter() - t_start:.1f}"
            f" s after the start")

    t0 = time.perf_counter()
    built = build_all()
    log(f"[build] {len(built)} sources, one nvcc each in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        log(f"[build] {name}: nvcc {b.seconds:.1f} s -> {b.path.name}")
        for ln in b.log.splitlines():
            if "registers" in ln or "spill" in ln or "wgmma" in ln:
                log(f"[build]   {ln.strip()}")
    check_spills(built["flash_fwd"])
    check_spills(built["ring"])
    # the split backward: the dQ kernel and the fused kernel with DQ = false
    check_spills(built["flash_bwd"], r"flash_bwd_dq_kernel|"
                 r"flash_bwd_fused_kernelILi\d+ELb[01]ELb0E")
    check_spills(built["matmul"])
    check_spills(built["paged_attention"])
    card = nvidia_smi()
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi name, power "
        f"limit:")
    log(card)
    lap("1")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    with torch.no_grad():
        # the full-context cases draw from a generator of their own, so
        # that every other phase's inputs come from `gen` as before
        full_gen = torch.Generator(device="cuda")
        full_gen.manual_seed(SEED + 1)
        max_err = check_kernel(gen, full_gen)
        paged_t = {label: time_kernel(gen if B == 32 else full_gen,
                                      MODEL["n_layers"], B, lo, hi)
                   for label, B, lo, hi in PAGED_SHAPES}
    for label, t in paged_t.items():
        log(f"[time] paged_attention at the {label}: a loop of launches "
            f"{t['ms'] * 1e3:.2f} us ({t['bound_ms'] / t['ms']:.3f} of the "
            f"bound, {t['ms'] / t['library_ms']:.2f}x the library call's "
            f"{t['library_ms'] * 1e3:.2f} us); from a CUDA graph "
            f"{t['graph_ms'] * 1e3:.2f} us ({t['bound_ms'] / t['graph_ms']:.3f}"
            f" of the bound, {t['graph_ms'] / t['library_graph_ms']:.2f}x the "
            f"library call's {t['library_graph_ms'] * 1e3:.2f} us); through "
            f"the Python wrapper {t['wrapper_ms'] * 1e3:.2f} us; plain version "
            f"{t['plain_ms'] * 1e3:.2f} us; library call: SDPA over "
            f"pre-gathered K/V, gather excluded; bound "
            f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} ({t['bytes']} B "
            f"at 3.35 TB/s); before the split-page redesign "
            f"{PAGED_BEFORE_US[label]} us; on {card}")
    timing = paged_t[PAGED_SHAPES[0][0]]
    served = serve_phase(gen)
    log(f"[time] paged_attention launches per decoded token: "
        f"{served['launches'] / max(1, served['decode_steps']):.2f}")
    lap("2-4")

    with torch.no_grad():
        flash_err = check_flash(gen)
    flash_t = time_flash(gen, B=16, H=16, Hkv=16)
    log_flash_times("flagship [256, 1024, 128]", flash_t, card)
    log_fwd_summary("flagship [256, 1024, 128]", flash_t["flash_fwd"], card)
    log_fused_summary("flagship [256, 1024, 128]", flash_t, card)
    gqa_t = time_flash(gen, B=8, H=8, Hkv=2)
    log_flash_times("GQA run [64 over 16, 1024, 128]", gqa_t, card)
    log_fwd_summary("GQA run [64 over 16, 1024, 128]", gqa_t["flash_fwd"],
                    card)
    log_fused_summary("GQA run [64 over 16, 1024, 128]", gqa_t, card)
    log_split_summary("flagship [256, 1024, 128]", flash_t, card)
    log_split_summary("GQA run [64 over 16, 1024, 128]", gqa_t, card)
    for causal in (True, False):
        shape = (f"DP×SP block [256, 256, 128] "
                 f"{'causal' if causal else 'full'}")
        block_t = time_flash(gen, B=16, H=16, Hkv=16, S=256, causal=causal)
        log_flash_times(shape, block_t, card)
        log_split_summary(shape, block_t, card)

    with torch.no_grad():
        mm_err = check_matmul(gen)
        mm_t = time_matmul(gen)
    log_times(mm_t, card)
    benched = bench_phase()
    log_matmul_summary(mm_t["matmul 4096^3"], benched, card)
    log_norm_summary(mm_t, card)
    lap("5-7")

    ring_err = check_ring(gen)
    with torch.no_grad():
        ring_t = time_ring(gen)
    log_times(ring_t, card)
    log_ring_summary(ring_t, card)
    lap("11-12")

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        trained, fused, gqa_run = train_phase(gen, Path(tmp))
        t0 = time.perf_counter()
        sharded = sharded_phase(gen, str(Path(tmp) / "tokens.bin"))
        log(f"[time] phase 13 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ringed = ring_phase(gen, str(Path(tmp) / "tokens.bin"))
        log(f"[time] phase 14 {time.perf_counter() - t0:.1f} s")
    lap("8-10, 13-14")

    t0 = time.perf_counter()
    quant_t = quant_phase(gen)
    log_quant_times(quant_t, card)
    log(f"[time] phase 15 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    quant_served = quant_serve_phase(gen)
    log(f"[time] phase 16's serving {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    decoded = short_section_decode()
    log(f"[time] phase 16's section_decode {time.perf_counter() - t0:.1f} s")
    log(f"[bench] section_decode (greedy slab decode, batch 8, prompt 128, "
        f"{DECODE_STEPS} steps; informational): {json.dumps(decoded)}")
    slab_tps = quant_served["slab"]["tokens_per_s"]
    log(f"[serve] int8 weights: slab {slab_tps:.1f} tokens/s, paged "
        f"{quant_served['paged']['tokens_per_s']:.1f} tokens/s for the 8 "
        f"requests (informational); on {card}")
    lap("15-16")
    spec = spec_serve_phase(gen, card)
    lap("17")
    models = spec.pop("models")
    prefixed = prefix_phase(models, card)
    torch.cuda.empty_cache()
    lap("18")
    # phase 31's process groups run while 19b's command lines start and
    # serve (its times are informational, taken beside them)
    life = lifecycle_phase(card, beside=lambda: tp_phase(card))
    lap("19, 31")
    pooled = pool_phase(models, card)
    lap("20")
    # 21d's tenants are processes of their own: they run beside 21a-c and
    # 22 (the card holds both; their times are informational)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        tenants = pool.submit(timed, "phase 21d", tenants_phase, card)
        t0 = time.perf_counter()
        handed = handoff_phase(models, card)
        log(f"[time] phase 21a-c {time.perf_counter() - t0:.1f} s")
        del models
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        packed_phase(card)
        log(f"[time] phase 22 {time.perf_counter() - t0:.1f} s")
        tenants.result()
    lap("21-22")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-23-") as tmp:
        meshed = mesh_phase(write_tokens(Path(tmp) / "tokens.bin",
                                         TRAIN_MODEL["vocab"]), card)
    log(f"[time] phase 23 {time.perf_counter() - t0:.1f} s")
    lap("23")
    t0 = time.perf_counter()
    graphed = graph_phase(card)
    log(f"[time] phase 24 {time.perf_counter() - t0:.1f} s")
    lap("24")
    t0 = time.perf_counter()
    multiprocess_phase(card)
    log(f"[time] phase 25 {time.perf_counter() - t0:.1f} s")
    lap("25")
    t0 = time.perf_counter()
    processed = process_phase(card)
    log(f"[time] phases 26-30 {time.perf_counter() - t0:.1f} s")
    lap("26-30")
    more = dict(meshed["launches"])
    for key in ("launches", "tp_launches", "optax_launches",
                "attn_launches", "moe_launches"):
        add_counts(more, processed[key])
    add_counts(more, life["beside"])

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "tpu_dra_torch/csrc/paged_attention.cu",
        "replaces": "tpu_dra/workloads/paged_kv.py:248",
        "launches": served["launches"] + spec["paged"]["spec"]["launches"]
        + prefixed["launches"] + life["paged_launches"]
        + pooled["launches"] + handed["launches"]
        + more.get("paged_attention", 0) + graphed["launches"],
        "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    flash_src = {"flash_fwd": ("tpu_dra_torch/csrc/flash_fwd.cu",
                               "tpu_dra/workloads/pallas_kernels.py:151"),
                 "flash_bwd_dq": ("tpu_dra_torch/csrc/flash_bwd.cu",
                                  "tpu_dra/workloads/pallas_kernels.py:367"),
                 "flash_bwd_dkdv": ("tpu_dra_torch/csrc/flash_bwd.cu",
                                    "tpu_dra/workloads/pallas_kernels.py:453")}
    for name, (source, replaces) in flash_src.items():
        t = flash_t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": trained["launches"][name]
            + life["flash_launches"][name]
            + (life["lora_launches"][name] if name != "flash_fwd" else 0)
            + more.get(name, 0),
            "max_abs_err": flash_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # row #4: the same kernel at g = 4, timed and launched in the GQA run
    t = gqa_t["flash_fwd"]
    kernels.append({
        "name": "flash_fwd_gqa", "route": "cuda",
        "source": "tpu_dra_torch/csrc/flash_fwd.cu",
        "replaces": "tpu_dra/workloads/pallas_kernels.py:221",
        "launches": gqa_run["launches"]["flash_fwd"]
        + life["lora_launches"]["flash_fwd"] + more.get("flash_fwd_gqa", 0),
        "max_abs_err": flash_err["flash_fwd_gqa"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    wqkv = next(k for k in mm_t if "wqkv" in k)
    later = {  # name: (source, replaces, launches, max abs err, times)
        "matmul": ("tpu_dra_torch/csrc/matmul.cu",
                   "tpu_dra/workloads/pallas_kernels.py:57",
                   benched["launches"], mm_err["matmul"],
                   mm_t["matmul 4096^3"]),
        "rmsnorm_matmul": ("tpu_dra_torch/csrc/matmul.cu",
                           "tpu_dra/workloads/pallas_kernels.py:863",
                           fused["launches"]["rmsnorm_matmul"],
                           mm_err["rmsnorm_matmul"], mm_t[wqkv]),
        "flash_bwd_fused": ("tpu_dra_torch/csrc/flash_bwd.cu",
                            "tpu_dra/workloads/pallas_kernels.py:494",
                            fused["launches"]["flash_bwd_fused"],
                            flash_err["flash_bwd_fused"],
                            flash_t["flash_bwd_fused"])}
    later.update({
        "all_gather_matmul": ("tpu_dra_torch/csrc/ring.cu",
                              "tpu_dra/workloads/pallas_kernels.py:1058",
                              sharded["launches"]["all_gather_matmul"],
                              ring_err["all_gather_matmul"],
                              ring_t["all_gather_matmul wqkv"]),
        "matmul_reduce_scatter": ("tpu_dra_torch/csrc/ring.cu",
                                  "tpu_dra/workloads/pallas_kernels.py:1165",
                                  sharded["launches"]["matmul_reduce_scatter"],
                                  ring_err["matmul_reduce_scatter"],
                                  ring_t["matmul_reduce_scatter w2"]),
        "ring_shift": ("tpu_dra_torch/csrc/ring.cu",
                       "tpu_dra/workloads/pallas_kernels.py:1313",
                       ringed["launches"]["ring_shift"]
                       + handed["ring_launches"], ring_err["ring_shift"],
                       ring_t["ring_shift k/v block"])})
    for name, (source, replaces, launches, err, t) in later.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches + more.get(name, 0),
            "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
