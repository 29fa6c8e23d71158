#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any disagreement:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. every CUDA kernel, built from ``src/repro_torch/kernels/csrc`` on
   first use, against its plain PyTorch version on the same CUDA tensors:
   n in {1, 31, 33, 32785, 100000, 620,756,992} (the last is the glm4-9b
   unembedding), M in {1, 4, 7, 33} voters (fused_majority; bitpack
   takes 1, 4 and 7 rows), bf16 and float32 (and int8 for the sign
   kernels, whose payloads carry planted zeros and -0.0); at the
   unembedding n a stack above 24 GB (M = 33 in float32 and bf16) is left
   out. The ternary wire's kernels take the same sizes (and n = 17, and a
   row that starts off a 16-byte boundary): ternary_pack on 1, 4 and 7 rows
   of int8 / f32 / bf16 (4 rows at the unembedding n), ternary_majority
   with both tie rules (ties 0, and ties +1: hierarchical's) over M in
   VOTERS on words with planted 0b10 fields and ties, ternary_unpack to
   int8, float32 and bf16, and the ternary apply in f32 and bf16;
   momentum_sign_pack
   also without its words (the ternary2bit and ef_sign encode), and
   bitunpack of a whole (4, w) unembedding word stack to int8 (2,483,027,968
   signs, past 2^31, as weighted_vote's decode unpacks it). Both applies
   (1-bit and ternary, f32 and bf16) also run at those sizes and n in
   {32, 64, 95, 1024, 2047} on views that start 0, 1 and 3 elements past
   a 16-byte boundary, in place and into a separate out one element
   further along (the kernel's 16-byte path and its element path), with
   the elements around each view held unchanged and planted 0b10 fields
   in the ternary words. The three tallies (majority, ternary_majority
   with ties 0 and with ties +1) also take every M from 1 to 17 and M in {31, 32, 33, 63, 64, 65, 255, 256,
   257, 1000} at n in {33, 100000, 131072}, words of each remainder mod 4,
   planted all-ones, all-zero, tied and (2-bit) 0b10 columns, and a stack
   and an out that start off a 16-byte boundary. momentum_sign_pack with
   bf16 momentum (the preset's instantiation) takes g float32 and bf16 at
   every n of SIZES, beta in {0.9, 0.99, 0.5 + 2^-9 + 2^-31}, planted +0.0
   and -0.0 in g and m, a new m' with the words and m' in place with and
   without them (m' compared bit for bit, -0.0 apart from +0.0). All four
   momentum_sign_pack instantiations (g float32 / bf16 x m float32 / bf16)
   also run at the applies' sizes on g and m views 0, 1 and 3 elements past
   a 16-byte boundary (and g and m apart), in place and into an m_out one
   element further along, with and without the words, m carrying +0.0,
   -0.0 and a NaN (a NaN m' equals any NaN; bit 0). bitpack also reads
   strided views, all three dtypes: windows of a (7, 8256) and a (7, 8261)
   buffer (rows on and off 16-byte boundaries) at 1, 4 and 7 rows, from
   columns 0, 32 and 1, of every length 4096 + r, r < 32, and a window of a
   (4, 620,756,992) buffer whose last row starts past 2^31 bytes. The float
   payloads of every float-reading kernel carry planted float32 / bf16
   subnormals (SUBNORMALS), the momenta SUBNORMAL_MOMENTA beside g = 0
   (beta * m a subnormal operand or result), the applies subnormal
   parameters and eta = 0 (p - 0 flushes them): the kernels, built with
   -ftz=true, must read and write them as zeros as the plain versions do.
   Packed words, signs, momentum and parameters must be bit-equal. Before
   the checks, every float32 compare and operation (FSETP, FMUL, FADD,
   FFMA) in the five libraries' SASS (cuobjdump -sass) must carry .FTZ.
   ef_sign's float32 mean|t| over ten 2^26-element chunks must be within
   1e-5 of a float64 sum;
3. the training path: Algorithm 1 on glm4-9b at every published width,
   cut to 2 layers (1,649,439,744 parameters), M = 4 voters, global batch
   8, seq 512, for 5 steps through ``make_train_step`` ->
   ``materialize_state`` -> ``step_fn``, with random weights from a seeded
   CUDA generator. Every loss must be finite, every step must launch each
   kernel exactly as often as the step has leaves (momentum_sign_pack M
   times as often), and step 0's update of the unembedding leaf must be
   bit-equal to the plain versions recomputed from saved copies of its
   parameters and gradients (the momentum starts at zero);
4. the vote path: every leaf's trained (M, n) momentum voted through
   ``VirtualBackend(device="cuda").execute(VoteRequest(form="stacked"))``
   on four wires (fused allgather_1bit, staged allgather_1bit, psum_int8,
   hierarchical). Each wire must launch its kernels exactly once per leaf,
   report 1 bit (1-bit wire) or 8 bits (count wires) per coordinate, and
   vote the unembedding leaf bit-equal to its plain versions; fused and
   staged 1-bit votes must be equal on every leaf. The same momentum is
   then voted with codec ternary2bit on allgather_1bit (ternary_pack +
   ternary_majority + ternary_unpack, once per leaf, 2 bits per
   coordinate) and on psum_int8 (no kernel; its votes bit-equal to
   sign1bit's psum_int8 votes on every leaf). One more vote per wire runs
   under torch.profiler. Then the quickstart's 5 x 8 vote;
4b. the plan votes: the same momentum as one (M, n_params) int8 sign
   buffer (6.6 GB; each voter's row written leaf by leaf with
   ``vote_plan.write_signs``, as the trainer's plan path writes it),
   voted through ``VoteRequest(plan=build_plan(..., bucket_bytes=1<<24))``
   synchronously and with overlap=True on staged allgather_1bit (13
   buckets: exactly 13 bitpack / majority / bitunpack), psum_int8 and
   hierarchical (13 buckets), ternary2bit on allgather_1bit (25 buckets,
   25 ternary_pack / ternary_majority / ternary_unpack) and weighted_vote
   (13 buckets, its flip-rate state): each overlap result bit-equal to its
   sync twin, the stateless wires' votes bit-equal to phase 4's leaf-wise
   votes of each leaf, CUDA-event ms and the peak above the resident
   buffers printed; the per-bucket copies that remain (the 25 ternary and
   the 13 fused_majority buckets; bitpack reads a 1-bit bucket in place)
   timed alone; then
   ``plan_vote_stacked`` at 1<<24 and 1<<20 (197 buckets): exactly one
   fused_majority and one bitunpack per bucket, bit-equal to the staged
   plan;
5. the codec paths: the same training setup with codec ternary2bit,
   ef_sign and weighted_vote on allgather_1bit, 5 steps each from fresh
   state (the previous run's freed first): finite losses, each step's
   launches exactly the codec's per-leaf count, step 0's update of
   ``layers.attn_wq`` (``layers.mlp_w_down`` for ef_sign, whose mean|t|
   then spans two chunks) and its momentum, and ef_sign's residual,
   bit-equal to the plain versions recomputed from saved copies (ef_sign's
   mean|t| within 1e-5 of a float64 sum),
   ternary2bit's untouched embedding coordinates held still, the peak
   memory printed, and one more step of each under torch.profiler;
6. the preset path: the reference's configured glm4-9b training,
   ``make_train_step(cfg, default_train_config("glm4-9b", cell), 4)`` from
   ``configs/presets.py``: bf16 per-worker momentum on psum_int8 (the
   trainer's 2-bit count wire), 8 microbatches a voter, remat="full", lr
   1e-4, beta 0.9, at every published width, depth cut 40 -> 2 as in phase
   3. Its cell is seq 512 and global batch 32: train_4k's seq 4096 and
   batch of 256 are cut for time (phase 16 runs five other presets at seq
   4096). Five steps from fresh state: finite
   losses, each step's launches exactly momentum_sign_pack (the bf16-m
   instantiation, no words) and ternary_pack M times per leaf,
   ternary_majority and apply_ternary_vote once; step 0 of
   ``layers.attn_wq`` (its bf16 momentum rows and its update) bit-equal to
   the plain versions recomputed from saved copies; the peak memory (its
   profiled step cut for the script's time since phase 19d-19f
   joined it);
7. each kernel timed at the unembedding shape (median of CUDA-event-timed
   launches after warm-up) beside its plain version and its bound;
   momentum_sign_pack with bf16 momentum as a row of its own, each beside
   ``m.add_(g, alpha=0.1)`` of its dtypes (the stream yardstick); bitpack of
   the (4, n) float32, bf16 and (its own row) int8 stack, each also read one
   element off each row's 16-byte boundary (the element path); beside
   ternary_pack of a float32 row, its bf16 row (the preset's); beside the
   applies, a bf16 copy of the same n elements (the stream yardstick) and
   apply_vote on float32 parameters; beside the tallies, their times at
   M = 32, 64 and 128 voters, at M = 255 on half of the n and at M = 1000
   on an eighth of it;
8. the trainer's plan path (run after phase 7, its launches added to the
   kernels line): phase 3's training through a VotePlan of 1<<24 bytes
   (``OptimizerConfig.bucket_bytes``), 5 steps from fresh state with
   exact launches per step (momentum_sign_pack without words, per bucket
   bitpack / majority / bitunpack, per leaf ternary_pack and
   apply_ternary_vote of the int8 vote), its losses equal to phase 3's
   bit for bit, a profiled step (its PyTorch copy launches counted); again
   with overlap=True (the same
   losses); a codec map (the embedding on ternary2bit) for 2 steps with
   finite losses and exact launches per group; delayed_vote for 2 steps,
   step 0 leaving every parameter as it was and step 1 applying exactly
   the int8 vote banked at step 0 (recomputed with the plain versions);
   the peak memory of each run.
9. signSGD (beta = 0, ``signsgd_vote``): phase 3's cell with momentum 0,
   3 steps on allgather_1bit (each voter's bf16 gradient rows through
   bitpack, majority, apply_vote) and 3 on psum_int8 (ternary_pack of the
   bf16 rows, ternary_majority, apply_ternary_vote), each from fresh
   state: exact launches per step, finite losses, step 0 of the
   unembedding bit-equal to the plain versions recomputed from saved
   copies;
10. the qwen1.5-32b Mode B preset at every published width (d_model
   5120, 40 heads of 40 kv heads, head_dim 128, d_ff 27392, vocab
   152064, untied, qkv bias), depth cut 64 -> 2 (2,608,389,120
   parameters): ``make_train_step(cfg, dataclasses.replace(
   default_train_config("qwen1.5-32b", cell), fsdp=False), 4)`` with
   phase 6's cell (seq 512, batch 32): signsgd_vote, one global float32
   momentum at beta 0.9 on hierarchical, 8 microbatches, nested remat;
   fsdp is cut (with a mesh its fused ZeRO backward votes inside the
   reduce-scatter). Five steps, then 2 each on psum_int8 and
   allgather_1bit, each from fresh state: exact launches per step (per
   leaf the tally, the vote unpacked to bf16, the momentum kernel, the
   ternary pack of u and the ternary apply), finite losses, the peak
   memory under 80 GB; on hierarchical step 0 of layers.attn_wq (its
   momentum and parameters) bit-equal to the plain versions recomputed
   from saved copies and its vote bit-equal to the vote API's
   hierarchical vote of the same gradients (its profiled step cut in PR
   28 for the script's time);
11. the dense baselines: phase 3's cell with kind sgd, sgdm and adam, 3
   steps each from fresh state: no kernel launch, finite losses, the
   median step and the peak memory, the unembedding's mean gradient at
   step 0 within the bf16 rounding bound of a float64 sum of the four
   voters' gradients (bit-equal to the port's bf16 sum for sgdm), and
   float32 sqrt on the card the nearest float32 (Adam's root);
12. the failure drills (after phase 11): (a) the adversary kernel
   (``random``, ``colluding``, ``blind`` at flip_prob 0, 0.5, 0.9 and 1)
   bit for bit against its plain version on (4, 2^24) int8 windows at the
   start, the middle and the ragged tail of the unembedding row and at
   counter offsets past 2^31 and across 2^32, in place and on a view one
   byte off a 16-byte boundary (the bytes around it unchanged); (b) the
   reference's golden drill and its 7 non-adaptive presets through
   ``sim.ScenarioRunner`` on the card, each digest equal to the port's own
   CPU run of the same spec and draws, then ``fig4_grid()`` (51 drills, 16
   voters, 25 steps, dim 512) on the card, the flip fraction and loss of
   each (mode, fraction, wire) logged: the paper's Fig. 4 surface; (c)
   phase 3's cell with voter 0 adversarial: sign_flip and random on
   allgather_1bit (3 steps), blind at flip_prob 0.9 on psum_int8 (2),
   exact launches per step, step 0 of layers.attn_wq bit-equal to the
   plain versions (the adversary drawn by the plain version under the same
   key), the median step, the peak memory and the adversary's launches;
   (d) a checkpoint of the elastic preset's per-worker state (8 voters,
   refit to its events' 4 and 6) and of a narrow trainer's state (bf16
   momentum) saved and restored bit-equal on the card.
13. the federated population and the adaptive adversaries (after phase
   12): (a) one round of a 100,000-client population, 12,000 voters
   sampled, each row x + 4 N(0, 1) over 2^22 coordinates made on the card
   under its own (step, logical id) seed, voted through
   ``VoteRequest(form="streamed")`` on ``VirtualBackend(chunk_size=...)``
   in six configurations (sign1bit on allgather_1bit and psum_int8,
   dataset weights on allgather_1bit, weighted_vote in two passes, a
   random coalition of the ids below 25,000 drawn by the adversary kernel
   under each logical id's key, and low_margin on the previous sign1bit
   round's tally), each at chunks of 1,024 and 512 rows: votes, tallies and
   state bit-equal, the peak above the resident tensors at most the
   chunk's float32 rows plus three int8 (k, n) temporaries plus 2 GiB, its
   CUDA-event ms (beside the row maker's own ms, timed alone) and
   ``population.*`` counters printed, two of them once more under
   torch.profiler. Before each configuration's rounds, one full chunk of
   it (the first 1,024 sampled voters) runs with every launch of the
   adversary, bitpack and bitunpack wrappers held against its plain
   version on the same tensors, a slab at a time (these launches are not
   counted as the path's), and every kernel the configuration's round
   launches must be among those held; then, on the first 1,024 sampled voters, the
   stacked form annotated with ``voter_ids`` / ``weights`` (one 17 GB
   stack) bit-equal to the streamed form at chunk 512 for three
   configurations; (b) the two adaptive presets, the three fed-smoke
   drills and the M = 100,000 scale drill of benchmarks/bench_federated.py,
   and every breaking-point spec, on the card and on the CPU from the
   port's own draws with equal digests (peak rows within each chunk), then
   ``breaking_point_rows(with_identity=False)`` and the chunk-invariance
   identity row on both, every row equal (loss drops, float32 means summed
   in another order, within 1e-6); seconds per drill set printed.

14. the mesh (after phase 13): the stacked twin (M = 4) of phase 3's cell
   in six runs of 2 steps each (allgather_1bit, psum_int8, hierarchical on
   pod 2 x data 2, ternary2bit, a VotePlan of 1<<24 bytes with overlap, one
   sign_flip voter with diagnostics), then a world of 4 spawned processes
   on the one card over gloo (one card admits no NCCL world), one voter
   each, running the same six runs through ``make_train_step(...,
   mesh=ProcessMesh)``: every rank's losses, diagnostics and device
   checksums of its parameters and momentum equal to the twin's voter's,
   its launches per step exactly ``mesh_launches``, every launch of each
   run's step 0 on rank 0 (momentum_sign_pack, majority, the applies,
   bitpack / bitunpack, ternary_pack / ternary_unpack / ternary_majority,
   the adversary) held against its plain version on the same tensors, a
   slab at a time (the path's own launches: the checks launch nothing, and
   each kernel's largest difference joins the kernels line; step 0's time
   includes the check), each leaf's mesh vote
   of the trained momentum equal on rank 0 to ``VirtualBackend``'s vote of
   the (4, n) rows gathered from the ranks; the bytes each rank handed the
   collectives per step beside the WireReport and a float32 gradient, the
   step split into collectives and the rest, each rank's peak and the
   phase's seconds printed.

15. the fused ZeRO backward (after phase 14; ``scripts/fsdp_probe.py``
   runs it alone): (a) the qwen1.5-32b Mode B preset at every published
   width, 2 layers, with its fsdp on (the fused leaves voted inside the
   virtual reduce-scatter), M = 4 stacked, 8 microbatches, nested remat,
   hierarchical, 3 steps: exact launches, every launch of step 0 held
   against its plain version, ``layers.attn_wq``'s step-0 momentum and
   parameters bit-equal to the plain versions run on a plain recomputation
   of its accumulated vote (per microbatch the sign of the summed int8
   signs of the 4 voters' gradients); then remat "dots" for 2 steps (losses
   bit-equal to nested's) and the sgd preset with fsdp for 2; the step ms
   and each run's peak; (b) 4 spawned processes on the card over gloo, one
   voter each (as phase 14), cut to 1 layer, 2 microbatches and batch 8:
   the preset on pod 2 x data 2 with one sign_flip voter for 2 steps and
   sgd with fsdp on data 4 for 1, every rank's losses and checksums of its
   parameter and momentum slices equal to the stacked twin's slices (sgd:
   its ``layers.attn_wq`` slice within the mean's rounding bound), rank
   0's step-0 launches held against their plain versions; the bytes each
   rank hands the collectives per step, equal to the layout's count, each
   rank's peak; (c) the launcher: ``repro_torch.launch.train.main`` in
   this process with glm4-9b at full depth and width (signSGD, 3 steps,
   batch 8, seq 128), its launches exactly one ternary_pack, tally and
   apply_ternary_vote per leaf and step, every one held against its plain
   version; then ``python -m repro_torch.launch.train`` as a subprocess, a
   reduced run killed (SIGKILL) once its step-1 checkpoint is the latest
   and resumed to step 4, its losses from step 2 on equal to an
   uninterrupted run's.

16. the decoder-only model zoo (after phase 15; ``scripts/zoo_probe.py``
   runs it alone): gemma3's attention at full width (16 / 8 heads of 256)
   and seq 4096, the chunked path (q_chunk 1024) against the unchunked
   product, a local (window 1024) and a global layer, output and
   gradients within ATTN_ULPS bf16 ulps, each path's peak; then the
   presets (``default_train_config(arch, train_4k)``) of gemma3-12b (6
   layers: one 5:1 local / global period), pixtral-12b (1, the patch
   prefix a quarter of the sequence), qwen2-moe-a2.7b (1), qwen3-moe-235b-
   a22b (1, fsdp) and deepseek-67b (1, fsdp) at every published width, seq
   4096, M = 4 stacked, batch cut to one row a voter a microbatch (32; 16
   for qwen3-moe's 4 microbatches), tokens drawn on the card from a seed:
   step 0 with every launch held against its plain version and one leaf's
   step-0 vote (an expert leaf for the MoE archs) against its plain
   recomputation, step 0 again from the same state with losses, every
   tally output, parameters and momenta bit-equal (step 1 cut for the
   script's time once phase 19d-19f joined it; phase 17b likewise); exact
   launches, finite ce and aux, s/step, peak memory (qwen2-moe's next step
   under torch.profiler in ``scripts/zoo_probe.py`` only: about 40 s);
17. the priced wire and the last three families (after phase 16;
   ``scripts/family_probe.py`` runs it alone). 17a, at phase 3's cell
   (glm4-9b, 2 layers, M = 4, batch 8, seq 512): the trainer with
   ``vote_strategy=auto`` resolves the wire ``select_strategy`` gives for
   its 1,649,439,744 parameters over 4 voters under the port's H100 link
   model, and its 2 steps are bit-equal (losses, launches, parameters,
   momenta) to the run that names that wire; every leaf of the trained
   momentum voted through the vote API's default strategy on sign1bit,
   ef_sign, ternary2bit and weighted_vote reports select_strategy's wire
   for the leaf and votes bit-equal to the request naming it; the trainer
   with ``bucket_bytes=-1``, AUTO, overlap and the embeddings on
   ternary2bit prints each codec group's resolved strategy, bucket size
   and the schedule's cost, runs 2 steps under a TraceRecorder bit-equal to
   the plan that names those values, and the port's report renders the
   trace with every section and a predicted exchange on every bucket (the
   measured one is the host's spans on one card, not a link). 17b, the
   presets (``default_train_config(arch, train_4k)``: float32 momentum on
   psum_int8, full remat) of mamba2-2.7b (4 of 64 layers), zamba2-1.2b (8
   of 38: a segment of 6 and its shared block, then 2 without) and
   whisper-tiny (4 encoder + 2 decoder layers) at every published width,
   seq 4096, M = 4, batch
   cut to one row a voter a microbatch (16, 16, 32), as phase 16's: step 0
   with every launch held against its plain version and one leaf's vote
   (mamba2's float32 ``layers.mamba_A_log``, zamba2's
   ``shared_block.attn_wq``, whisper's ``layers.xattn_wq``) against its
   plain recomputation, step 0 again bit-equal, step 1, s/step, peak
   memory (mamba2's next step under torch.profiler in
   ``scripts/family_probe.py`` only: about 60 s);
18. serving (after phase 17; ``scripts/serve_probe.py`` runs it alone),
   which launches none of the port's kernels before 18d (checked): 18a,
   glm4-9b at every published width and 4 of its 40 layers (full depth
   until phase 20 joined the script, 20 until 19h did, cut for its time;
   bf16, seeded weights) behind the continuous ``ServeEngine`` (8 slots,
   max_len 1024, prefill admission in buckets of 128 / 256 / 512) on 24
   Poisson requests (prompts of 128-512, 16-48 tokens each, greedy; 32-96
   before phase 19d-19f joined the script, cut for its time), then
   the static scheduler on the same requests: zero dropped, the same
   tokens, 3 lanes (the longest prompt, then the recycled slots with the
   most stale rows) equal to their request served alone in an engine of
   the same shape, one decode build, continuous goodput >= static; ms per
   decode tick (CUDA events) beside its memory bound (the weights and the
   live KV rows over 3.35 TB/s), tokens/s, TTFT and latency p50 / p95 in
   ticks, peak memory; 4 of the requests by inline admission (token
   agreement and the largest logit gap printed). A float32 2-layer twin
   of the engine serves all 24, every lane equal to its request served
   alone, and its inline admission equals its prefill admission. 18b, qwen1.5-32b at every published width and 8
   of its 64 layers (32 until phase 20 joined the script, 16 until 19h did), its int8 KV cache: 4 slots, max_len 8192, prompts of
   4,200-4,600 tokens through one prefill bucket of 4608 and 32 tokens
   each (the chunked online-softmax decode over two KV_CHUNKs); the
   engine's tokens teacher-forced through the model API with the int8
   cache (its greedy tokens the engine's) and with a bf16 cache, every
   logit within 0.15 of the twin's (relative at max(|logit|, 1)). 18c,
   gemma3-12b (6 layers, prompts past its 1024 window), pixtral-12b (1,
   tokens only), qwen2-moe-a2.7b (1), qwen3-moe-235b-a22b (1),
   deepseek-67b (1), mamba2-2.7b (4) and zamba2-1.2b (8) (inline
   admission), phases 16's and 17's depths, at every published width behind 4 slots, every lane equal
   to its request served alone, and whisper-tiny's batch loop with
   stubbed frames (each row equal to itself served alone); each arch's
   float32 twin decoding 32 teacher-forced steps (64 before 19h) against its
   forward_logits at the CPU tests' rtol / atol 2e-3; ms per tick,
   tokens/s and peak memory printed. 18d, an engine serving glm4-9b's
   width at 2 layers while the port's launcher (in process, cut to the
   same depth) trains 3 steps and publishes with ``--serve-dir``; the
   engine's CheckpointWatcher picks the checkpoint up between ticks: zero
   dropped, one swap, every request admitted after it equal to an engine
   started on the published parameters, the launcher's launches exact and
   each held against its plain version.
19. the model axis (after phase 18; ``scripts/tp_probe.py`` runs it
   alone): one world of 4 processes sharing the card over gloo (pinned
   host memory: loopback on one card, not a link). 19a, phase 3's cell
   (glm4-9b at every published width, 2 layers, batch 8, seq 512) on
   (data 2, model 2), Mode A sign1bit on allgather_1bit, then ternary2bit.
   19g, the vote side of the model axis on 19a's cell, one adversary of
   the two voters: 19g-1 sign1bit leaf-wise with a random adversary,
   19g-2 a VotePlan of TP_ADV_BUCKET_BYTES with overlap on psum_int8 with
   a blind adversary at flip_prob 0.9; each against its stacked twin as
   19a, every step-0 draw of the adversarial voter's ranks held bit for
   bit to the twin's at the block's global coordinates (random: the sent
   signs; blind: the flip mask wherever the honest signs agree), the
   adversary's launches counted (``tp_adv_launches``: one a leaf, or one
   a segment of the rank's plan buffer; those under the counter map again
   as ``adversary_map``, every run) and the plan's bytes counted from
   the rank's windows (``tp_plan_vote_bytes``); before the ranks, the
   adversary under a column cut of the unembedding against its plain
   version, and every sharded leaf's blocks under the counter map against
   the whole leaf's draw (``check_adversary_map``).
   19d, qwen3-moe-235b-a22b's Mode B fsdp preset (1 layer, 1 microbatch
   (2 until its fused gathers were cut for the script's time), batch 8,
   seq 512) on (data 2, model 2): the experts in the EP form, 64
   a rank, its 4-D fused expert leaves carrying both axes (it replaces PR
   27's 19b, qwen1.5-32b's Mode B fsdp preset, whose fused backward over a
   model axis it drives too). 19e, the presets of mamba2-2.7b (2 layers),
   zamba2-1.2b (7: a segment of 6, its shared block, then 1) and
   whisper-tiny (4 + 2, 64 stubbed frames, whole vocabulary tables) on
   (data 2, model 2), psum_int8, 4 microbatches (the presets' 4 / 8 cut to
   divide 4 rows a voter), then each of them in float32 (parameters and
   momentum, one microbatch), step 0 once with its launches exact,
   against the stacked float32 step: the loss within TP_TWIN_TOL
   (relative) and every leaf's step-0 momentum on every rank within
   TP_TWIN_TOL of the twin leaf's largest |m'|. Each bf16 run: step 0
   from a saved state, step 0 again from it (bit-equal on every rank),
   step 1; each step's launches exact
   (phase 14's and 15b's counts), every launch of each rank's first step
   held against its plain version (each rank's vote equal to the plain
   majority of the gathered shard signs), the leaves that no spec shards
   (``router_w``, whisper's tables and ``enc_embed.pos`` among them)
   bit-equal on every rank, the bytes each rank hands the vote axes and
   the model group equal to the layout's counts (``tp_vote_bytes``,
   ``tp_fsdp_vote_bytes``, ``tp_psum_vote_bytes``, ``tp_bytes``), step 0's
   loss within TP_LOSS_RTOL of the stacked twin's (M = 2, computed first),
   and in 19a, 19e and 19g each leaf's step-0 vote (data index 0's model
   ranks, joined) equal to the twin's on at least TP_VOTE_AGREE of its
   coordinates (19e: TP_VOTE_AGREE_FAMILY, set after a reading), each
   difference at a coordinate where some voter's |m'| is under
   TP_FLIP_FRACTION of the leaf's largest (zamba2: all but
   TP_LARGE_FLIP_SHARE of a leaf's coordinates); 19d's routing choices
   against the twin's, each difference at a near tie (TP_ROUTE_TIE),
   counted; 19d's voter 0 a random adversary (19g-3), each model rank's
   draws of the fused leaves (from counter 0, its block as a whole) equal
   to the stacked twin's drawn model block by model block. 19c, serving
   glm4-9b at every published width, 2 layers (8 before phase 19d-19f, 4
   before 19h; cut for the script's time), and its float32 2-layer twin:
   on (model 4) (the repeat form, the cache sequence-sharded) 4 prompts of
   4,100-4,300 rows prefilled one at a time and re-homed into an
   8192-row cache, 4 greedy ticks through ``make_decode_step`` (the
   sharded flash decode), then the same with the int8 cache, 4 ticks (from
   the bf16 run's prefill, its cache quantized row by row: what an int8
   prefill stores, bit for bit); on
   (data 2, model 2) a heads-sharded cache through
   ``make_prefill_sharded``, 4 ticks. 19f, serving the other families at
   every published width beside a float32 twin each (the MoE's with
   capacity factor E / k): on (model 4) qwen2-moe-a2.7b (1 layer, EP with
   15 experts a rank, its shared branch), mamba2-2.7b (4), zamba2-1.2b (8;
   its twin 7) and whisper-tiny (2 + 4, the seq form, its 1,500-row cross
   cache sequence-sharded), 4 prompts of 64-256 rows prefilled one at a
   time; on (data 2, model 2) qwen3-moe-235b-a22b (1 layer, a
   heads-sharded cache) through ``make_prefill_sharded``; 4 greedy ticks
   each (8 before 19h), no kernel launch; and 19f's FSDP runs
   (TP_FSDP_SERVE: qwen1.5-32b at 2 layers, qwen3-moe, mamba2, zamba2
   and whisper on (data 2, model 2) over the FSDP serving layout, prefill
   and 8 ticks bit-equal to the same ranks' plain-layout run, logits and
   every cache block, each tick's bytes by axis ``tp_fsdp_tick_bytes``'s).
   Each serving run is held, tick by tick on the
   single-device step's greedy tokens, to the single-device steps on the
   same parameters (19f's equal prompts prefilled a data shard at a time,
   as the sharded prefill routes them): bf16 logits within TP_SERVE_SHARE
   of max(|logit|, 1) (mamba2's and zamba2's within TP_SERVE_SHARE_SSD, set
   after a reading), the float32 twin's within rtol / atol TP_TWIN_TOL
   with greedy tokens equal; every layer on the decode path the layout
   names; each tick's model-group bytes equal to ``tp_tick_bytes``; the
   MoE's routing choices against the single-device step's, each
   difference at a near tie, a row's logits left out of a comparison only
   where a flip (or a drop that followed one) touched the token they are
   of, or reached the cache of a later layer in an earlier token of the
   row; a comparison that would keep no row fails. Printed: ms per step
   split into vote-collective, tensor-parallel-collective and other host
   time, ms per decode tick (CUDA events on rank 0), bytes per rank by
   axis, peak memory per rank, the routing flips and the seconds of each
   sub-phase on each rank. 19h, after that world has exited: a second
   world of 8 processes, (data 1, model 8), qwen2-moe-a2.7b at every
   published width, 2 layers, its experts in the M2 form on every rank
   (checked): its Mode A preset (4 microbatches) against the single-device
   M = 1 step with 19d's and 19e's checks (its vote bounds in
   TP_VOTE_AGREE_FAMILY / TP_LARGE_FLIP_SHARE), its float32 twin (1
   microbatch) held as 19e's are, with every routing difference at a
   float32 near tie and none excused, then TP8_SERVE's 8 ticks against
   the single-device tick (bf16 at 1 layer, float32 at 2).

20. the dry run (``repro_torch.launch.dryrun``: a step built and run on
   the "meta" device, its FLOPs, bytes, memory, collectives and launches
   counted, no kernel launched), held to what the card does. 20a: phase
   3's cell (glm4-9b at every published width, 2 layers, M = 4 stacked,
   sign1bit on allgather_1bit, batch 8, seq 512) dry-run on "meta", then
   one real step of it on the card: its launches equal to the dry run's
   exactly, ``FlopCounterMode`` over the card's step equal to the dry
   run's ``flops_per_chip`` exactly, and the card's peak above its
   allocation before the step (``max_memory_allocated``, reset before it)
   within DRY_PEAK_SHARE of the dry run's ``peak_bytes_per_chip`` of the
   dry run's peak above its arguments. 20b: 19a's cells (data 2, model 2)
   dry-run in a fake world of 4 ranks, as each rank: its bytes by axis
   equal to what that rank of 19a handed them in step 0
   (``ProcessMesh.stats`` / ``model_stats``) and to ``tp_vote_bytes`` /
   ``tp_bytes``, its launches equal to that rank's, exactly. 20c: the
   production cell glm4-9b x train_4k on (16, 16), dry-run as rank 0 of
   a fake world of 256 ranks (in a process of its own, started after the
   build, tracing on the host beside phases 2-19), its record printed
   ("ok" required); the card's
   ``total_memory``, name and power limit printed and
   ``dryrun.H100_MEMORY_BYTES`` held against ``total_memory``.

Phase 13's, 14's, 15's, 16's, 17's, 18's, 19's and 19h's launches (phases
14's, 15b's, 19's and 19h's summed over their ranks) join the kernels
line.

Phase 7 also times ternary_majority with ties +1 (its own row),
ternary_unpack to bf16 and bitpack of the bf16 stack (its own row, whose
launches are phases 9's and 10's), and the adversary kernel on the whole
(4, n) unembedding stack (its own row, whose launches are phase 12's
and 19g's, 19g-3's included), uncut and under the counter map (the row's "map" entry, whose
launches are 19g's under a map).

It prints one JSON line per step and per wire, a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
N_UNEMBED = 151_552 * 4096  # elements of glm4-9b's unembedding leaf
SIZES = (1, 31, 33, 32_785, 100_000, N_UNEMBED)
VOTERS = (1, 4, 7, 33)
#: the apply kernels' placement checks: sizes (below, at and past one
#: warp's 1024-element segment), and views that start this many elements
#: past a 16-byte boundary (0: on it)
APPLY_SIZES = SIZES + (32, 64, 95, 1024, 2047)
APPLY_OFFSETS = (0, 1, 3)
#: the tallies' checks: every plane count of the bit-sliced counter (P = 1
#: to 8, M < 256) and the instantiation for any M, at these lengths in
#: elements (2, 3125 and 4096 words on the 1-bit wire, 3, 6250 and 8192 on
#: the 2-bit one: the last a multiple of 4, so every M also takes the
#: 16-byte path); word counts of each remainder mod 4 (the 16-byte path and
#: the word path) at TALLY_WORD_VOTERS; views off a 16-byte boundary at
#: TALLY_VIEW_VOTERS
TALLY_VOTERS = tuple(range(1, 18)) + (31, 32, 33, 63, 64, 65, 255, 256, 257,
                                      1000)
TALLY_SIZES = (33, 100_000, 131_072)
TALLY_WORDS = (4, 5, 6, 7, 1024, 1025, 1026, 1027)
TALLY_WORD_VOTERS = (1, 4, 7, 32, 65)
TALLY_VIEW_VOTERS = (4, 7, 33, 100)
#: the tallies' extra timings, (voters, the unembedding's n cut by): M =
#: 32, 64 and 128 at the unembedding, M = 255 (the largest with a plane
#: count of its own) on half of it, and M = 1000 (the kernel for any M) on
#: an eighth of it
TALLY_TIMED = ((32, 1), (64, 1), (128, 1), (255, 2), (1000, 8))
M_MAIN, GLOBAL_BATCH, SEQ, STEPS, LR, BETA = 4, 8, 512, 5, 1e-3, 0.9
#: planted in the float payloads of phase 2: float32 subnormals (the
#: largest, 1e-39, and the smallest, 1.4e-45) of both signs, which the
#: kernels (built with -ftz=true) and the plain versions read as zeros
SUBNORMALS = (1e-39, -1e-39, 1.4e-45, -1.4e-45)
#: momenta planted beside g = 0: subnormal ones (an operand flushed), and
#: normal ones whose product with beta underflows (a result flushed)
SUBNORMAL_MOMENTA = (1e-38, -1e-38, 1.2e-38, -1.2e-38)
#: the apply checks' (eta, weight decay); eta = 0 leaves p - 0, which
#: flushes a subnormal p
APPLY_RATES = ((1e-3, 0.0), (1e-2, 0.1), (0.0, 0.0))
#: beta of the bf16-momentum checks: the last one's float32 value lies half
#: way between two bf16 values and rounds to even (0.5)
BF16_BETAS = (0.9, 0.99, 0.5 + 2 ** -9 + 2 ** -31)
#: the preset path (phase 6): the glm4-9b preset's shape cell, cut from
#: train_4k's seq 4096 and batch 256 (see the docstring)
PRESET_SEQ, PRESET_BATCH = 512, 32
#: the preset path's leaf whose step 0 is recomputed from saved copies
PRESET_LEAF = "layers.attn_wq"
PACK_ROWS = (1, 4, 7)
STACK_CAP_BYTES = 24e9      # largest (M, n) stack phase 2 builds
#: largest (rows, n) int32 temporary of ternary_pack's plain version
TERNARY_CAP_BYTES = 12e9
#: the codec paths of phase 5, and the leaf whose step 0 each recomputes:
#: ef_sign's is above one SCALE_CHUNK per voter (112,197,632 elements), so
#: its mean|t| is summed in more than one chunk
CHECK_LEAF = {"ternary2bit": "layers.attn_wq",
              "ef_sign": "layers.mlp_w_down",
              "weighted_vote": "layers.attn_wq"}
#: relative error allowed of the float32 mean|t| against a float64 sum
SCALE_RTOL = 1e-5
SOURCE = "src/repro_torch/kernels/csrc/"
#: the vote path's wires: (label, use_kernels, strategy, codec, launches
#: per leaf, wire bits per coordinate)
VOTE_WIRES = (
    ("fused_allgather_1bit", True, "allgather_1bit", "sign1bit",
     {"fused_majority": 1, "bitunpack": 1}, 1.0),
    ("staged_allgather_1bit", False, "allgather_1bit", "sign1bit",
     {"bitpack": 1, "majority": 1, "bitunpack": 1}, 1.0),
    ("psum_int8", False, "psum_int8", "sign1bit", {}, 8.0),
    ("hierarchical", False, "hierarchical", "sign1bit",
     {"bitpack": 1, "bitunpack": 1}, 8.0),
    ("ternary_allgather_1bit", False, "allgather_1bit", "ternary2bit",
     {"ternary_pack": 1, "ternary_majority": 1, "ternary_unpack": 1}, 2.0),
    ("ternary_psum_int8", False, "psum_int8", "ternary2bit", {}, 8.0),
)


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def max_abs_err(a, b) -> float:
    import torch
    if a.dtype in (torch.int32, torch.int64):
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def require_equal(what: str, got, want) -> float:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version (max abs "
            f"err {max_abs_err(got, want) if got.shape == want.shape else 'shape'})")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def plant_subnormals(x, start: int = 1, step: int = 13):
    """Plant SUBNORMALS in every `step`-th element of the last dim of the
    float tensor `x` from `start` (float32 1e-39 cast to bf16 stays a
    bf16 subnormal; 1.4e-45 becomes a zero there)."""
    for i, v in enumerate(SUBNORMALS):
        x[..., start + i::step * len(SUBNORMALS)] = v
    return x


def signed_payload(torch, gen, shape, dtype, dev):
    """Random values of `dtype` with planted zeros, -0.0 and subnormals
    (bit +1: a subnormal reads as a zero)."""
    if dtype == torch.int8:
        x = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        x[..., ::7] = 0
        return x
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    x[..., ::7] = 0.0
    x[..., 3::7] = -0.0
    return plant_subnormals(x)


def plant_momenta(g, m):
    """Plant subnormals in g (a float32 or bf16 operand read as a zero),
    and SUBNORMAL_MOMENTA in m with g = 0 beside them (beta * m a subnormal
    operand or result, flushed: m' = +0.0, bit +1)."""
    plant_subnormals(g, start=2, step=17)
    k = len(SUBNORMAL_MOMENTA)
    for i, v in enumerate(SUBNORMAL_MOMENTA):
        m[5 + i::11 * k] = v
        g[5 + i::11 * k] = 0.0


def check_sign_kernels(torch, ops, ref, sc, dev, err) -> int:
    """fused_majority, bitpack and bitunpack against their plain versions;
    updates `err`, returns the number of checks."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    n_checks = 0
    for n in SIZES:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            rows = max(r for r in VOTERS + PACK_ROWS
                       if r * n * dtype.itemsize <= STACK_CAP_BYTES)
            x = signed_payload(torch, gen, (rows, n), dtype, dev)
            for m in VOTERS:
                if m > rows:
                    continue
                err["fused_majority"] = max(err["fused_majority"],
                                            require_equal(
                    f"fused_majority n={n} M={m} {dtype}",
                    ops.fused_majority(x[:m]),
                    ref.fused_majority(sc.pad_last(x[:m], sc.PACK)[0])))
                n_checks += 1
            for r in PACK_ROWS:
                err["bitpack"] = max(err["bitpack"], require_equal(
                    f"bitpack n={n} rows={r} {dtype}", ops.bitpack(x[:r]),
                    ref.bitpack(sc.pad_last(x[:r], sc.PACK)[0])))
                n_checks += 1
            del x
            words = torch.randint(-2 ** 31, 2 ** 31, (sc.words_for(n),),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
            err["bitunpack"] = max(err["bitunpack"], require_equal(
                f"bitunpack n={n} {dtype}", ops.bitunpack(words, n, dtype),
                ref.bitunpack(words[None], dtype)[0, :n]))
            n_checks += 1
            del words
        torch.cuda.synchronize()
    n_checks += check_stacked_unpack(torch, ops, ref, sc, dev, gen, err)
    return n_checks + check_bitpack_strided(torch, ops, ref, sc, dev, gen, err)


def check_stacked_unpack(torch, ops, ref, sc, dev, gen, err) -> int:
    """weighted_vote's decode unpacks a leaf's whole (M, w) word stack with
    one bitunpack: at the unembedding that is M_MAIN * 32 * w =
    2,483,027,968 int8 signs, past 2^31. Held against the plain version
    a slab of words at a time (the plain version's int64 temporaries of
    the whole stack would take ~30 GB)."""
    words = torch.randint(-2 ** 31, 2 ** 31,
                          (M_MAIN * sc.words_for(N_UNEMBED),), generator=gen,
                          device=dev, dtype=torch.int32)
    n = words.numel() * sc.PACK
    got = ops.bitunpack(words, n, torch.int8)
    slab = 1 << 24
    for w0 in range(0, words.numel(), slab):
        part = words[w0:w0 + slab]
        err["bitunpack"] = max(err["bitunpack"], require_equal(
            f"bitunpack n={n} int8 words {w0}..{w0 + part.numel()}",
            got[w0 * sc.PACK:(w0 + part.numel()) * sc.PACK],
            ref.bitunpack(part[None], torch.int8)[0]))
    del words, got
    torch.cuda.synchronize()
    log({"phase": "stacked_bitunpack", "n": n, "voters": M_MAIN,
         "ok": True})
    return 1


#: bitpack's strided checks: windows of a (rows, width) buffer, its rows
#: `width` elements apart (the first width keeps every row on a 16-byte
#: boundary in every dtype, the second drifts off it); windows starting at
#: column 0, 32 (a bucket's ALIGN) and 1 (off 16 bytes), STRIDE_LENGTHS
#: long (each remainder mod 32, past the 2048 elements of an int8 unit)
STRIDE_WIDTHS = (8256, 8261)
STRIDE_STARTS = (0, 32, 1)
STRIDE_LENGTHS = tuple(4096 + r for r in range(32))


def check_bitpack_strided(torch, ops, ref, sc, dev, gen, err) -> int:
    """bitpack on strided views (each row contiguous, the rows a buffer's
    width apart, as the plan's buckets are), float32 / bf16 / int8, rows in
    PACK_ROWS, every window of STRIDE_WIDTHS x STRIDE_STARTS x
    STRIDE_LENGTHS, and a window of a (4, N_UNEMBED) buffer whose last row
    starts past 2^31 bytes: bit-equal to the plain version of the zero-padded
    contiguous window. Updates `err`, returns the number of checks."""
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for width in STRIDE_WIDTHS:
            buf = signed_payload(torch, gen, (max(PACK_ROWS), width), dtype,
                                 dev)
            for rows in PACK_ROWS:
                for c0 in STRIDE_STARTS:
                    for n in STRIDE_LENGTHS:
                        x = buf[:rows, c0:c0 + n]
                        err["bitpack"] = max(err["bitpack"], require_equal(
                            f"bitpack {dtype} rows={rows} width={width} "
                            f"window {c0}..{c0 + n}", ops.bitpack(x),
                            ref.bitpack(sc.pad_last(x.contiguous(),
                                                    sc.PACK)[0])))
                        n_checks += 1
            del buf
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        buf = signed_payload(torch, gen, (M_MAIN, N_UNEMBED), dtype, dev)
        c0 = N_UNEMBED // 2 + 32
        x = buf[:, c0:N_UNEMBED - 7]
        if ((M_MAIN - 1) * N_UNEMBED + c0) * dtype.itemsize < 2 ** 31:
            raise AssertionError("the window's last row is below 2^31 bytes")
        err["bitpack"] = max(err["bitpack"], require_equal(
            f"bitpack {dtype} ({M_MAIN}, {N_UNEMBED}) window "
            f"{c0}..{N_UNEMBED - 7}", ops.bitpack(x),
            ref.bitpack(sc.pad_last(x.contiguous(), sc.PACK)[0])))
        n_checks += 1
        del buf, x
        torch.cuda.synchronize()
    return n_checks


def check_scale(torch, what: str, t, got) -> float:
    """ef_sign's float32 mean|t| `got` against a float64 sum of |t|, within
    SCALE_RTOL; returns the relative error."""
    want = float(t.double().abs().sum()) / t.numel()
    rel = abs(float(got) - want) / want
    if not rel <= SCALE_RTOL:
        raise AssertionError(f"{what}: mean|t| {float(got)!r} against "
                             f"{want!r} in float64 (rel err {rel})")
    return rel


def check_apply_placement(torch, ops, ref, sc, dev, gen, err,
                          ternary: bool) -> int:
    """apply_vote (apply_ternary_vote with `ternary`) on views that start
    APPLY_OFFSETS elements past a 16-byte boundary, in place (eta 1e-3, no
    weight decay) and into a separate out that starts one element further
    along (eta 1e-2, wd 0.1): bit-equal to the plain version, and the
    elements around each view untouched. Misaligned views and the ragged
    tail take the kernel's element path, the rest its 16-byte path; both
    are held to the same check. The ternary words carry planted 0b10
    fields. Updates `err`, returns the number of checks."""
    name = "apply_ternary_vote" if ternary else "apply_vote"
    kernel, plain = getattr(ops, name), getattr(ref, name)
    pack = sc.PACK2 if ternary else sc.PACK
    n_checks = 0
    for n in APPLY_SIZES:
        words = torch.randint(-2 ** 31, 2 ** 31, (-(-n // pack),),
                              generator=gen, device=dev, dtype=torch.int32)
        if ternary:
            words[::5] = -0x55555556            # 0b10 in every field
        for dtype in (torch.float32, torch.bfloat16):
            for off in APPLY_OFFSETS:
                buf = torch.randn(off + n + 5, generator=gen,
                                  device=dev).to(dtype)
                p, before = buf[off:off + n], buf.clone()
                for in_place in (True, False):
                    eta, wd = (1e-3, 0.0) if in_place else (1e-2, 0.1)
                    want = plain(sc.pad_to_pack(p, pack)[0], words, eta,
                                 wd)[:n]
                    if in_place:
                        whole, o = buf, off
                    else:
                        o = (off + 1) % 4
                        whole = torch.zeros(o + n + 5, dtype=dtype,
                                            device=dev)
                    guard = whole.clone()
                    got = kernel(p, words, eta, wd, out=whole[o:o + n])
                    what = (f"{name} n={n} {dtype} offset={off} "
                            + ("in place" if in_place else f"out offset={o}"))
                    err[name] = max(err[name], require_equal(what, got, want))
                    require_equal(f"{what}: elements around the view",
                                  torch.cat([whole[:o], whole[o + n:]]),
                                  torch.cat([guard[:o], guard[o + n:]]))
                    if in_place:    # restore p for the separate-out check
                        buf.copy_(before)
                    n_checks += 1
                del buf, p, before, want, whole, guard, got
        del words
        torch.cuda.synchronize()
    return n_checks


def ternary_payload(torch, gen, shape, dtype, dev):
    """ternary_pack inputs: int8 of any value (only the low two bits are
    packed) with {-1, 0, +1} symbols in the first half and planted zeros;
    f32 / bf16 values with planted +0.0 and -0.0 (both abstain)."""
    if dtype == torch.int8:
        x = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        half = shape[-1] // 2
        x[..., :half] = torch.randint(-1, 2, shape[:-1] + (half,),
                                      generator=gen, device=dev,
                                      dtype=torch.int8)
        x[..., ::7] = 0
        return x
    return signed_payload(torch, gen, shape, dtype, dev)


def check_ternary_kernels(torch, ops, ref, sc, dev, err) -> int:
    """ternary_pack, ternary_majority, ternary_unpack and the ternary apply
    against their plain versions; updates `err`, returns the number of
    checks."""
    gen = torch.Generator(device=dev).manual_seed(2468)
    n_checks = 0
    for n in SIZES + (17,):
        w = sc.ternary_words_for(n)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            rows = max(r for r in PACK_ROWS if r * n * 4 <= TERNARY_CAP_BYTES)
            x = ternary_payload(torch, gen, (rows, n), dtype, dev)
            for r in PACK_ROWS:
                if r > rows:
                    continue
                err["ternary_pack"] = max(err["ternary_pack"], require_equal(
                    f"ternary_pack n={n} rows={r} {dtype}",
                    ops.ternary_pack(x[:r]),
                    ref.ternary_pack(sc.pad_last(x[:r], sc.PACK2)[0])))
                n_checks += 1
            if n > 1:   # a row that starts one element off alignment
                row = x[0, 1:].view(1, -1)
                err["ternary_pack"] = max(err["ternary_pack"], require_equal(
                    f"ternary_pack n={n - 1} unaligned {dtype}",
                    ops.ternary_pack(row),
                    ref.ternary_pack(sc.pad_last(row, sc.PACK2)[0])))
                n_checks += 1
            del x
        for m in VOTERS:
            packed = torch.randint(-2 ** 31, 2 ** 31, (m, w), generator=gen,
                                   device=dev, dtype=torch.int32)
            packed[:, 0] = 0x55555555              # +1 in every field
            packed[m // 2:, 0] = -1                # -1: ties for even M
            packed[: (m + 1) // 2, -1] = -0x55555556   # 0b10 everywhere
            err["ternary_majority"] = max(err["ternary_majority"],
                                          require_equal(
                f"ternary_majority n={n} M={m}", ops.ternary_majority(packed),
                ref.ternary_majority(packed)))
            err["ternary_majority_plus_one"] = max(
                err["ternary_majority_plus_one"], require_equal(
                    f"ternary_majority_plus_one n={n} M={m}",
                    ops.ternary_majority(packed, ties="plus_one"),
                    ref.ternary_majority(packed, "plus_one")))
            n_checks += 2
            del packed
        words = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen,
                              device=dev, dtype=torch.int32)
        err["ternary_unpack"] = max(err["ternary_unpack"], require_equal(
            f"ternary_unpack n={n}", ops.ternary_unpack(words, n),
            ref.ternary_unpack(words[None])[0, :n]))
        # the float outputs (Mode B's momentum takes the bf16 vote), bit for
        # bit: a 0 is +0.0 in both
        for dtype, bits in ((torch.float32, torch.int32),
                            (torch.bfloat16, torch.int16)):
            require_equal(f"ternary_unpack n={n} {dtype}",
                          ops.ternary_unpack(words, n, dtype).view(bits),
                          ref.ternary_unpack(words[None], dtype)[0, :n]
                          .contiguous().view(bits))
        n_checks += 3
        for dtype in (torch.float32, torch.bfloat16):
            p = plant_subnormals(
                torch.randn(n, generator=gen, device=dev).to(dtype))
            for eta, wd in APPLY_RATES:
                err["apply_ternary_vote"] = max(
                    err["apply_ternary_vote"], require_equal(
                        f"apply_ternary_vote n={n} {dtype} eta={eta} wd={wd}",
                        ops.apply_ternary_vote(p, words, eta, wd),
                        ref.apply_ternary_vote(sc.pad_to_pack(p, sc.PACK2)[0],
                                               words, eta, wd)[:n]))
                n_checks += 1
            del p
        del words
        torch.cuda.synchronize()
    return n_checks + check_apply_placement(torch, ops, ref, sc, dev, gen,
                                            err, ternary=True)


#: the three tallies: (name, elements per word, a word of +1 votes in
#: every bit or field, a word of -1 votes, the 2-bit wire's unused 0b10
#: pattern); ternary_majority_plus_one is ternary_majority(ties="plus_one")
TALLIES = (("majority", 32, -1, 0, None),
           ("ternary_majority", 16, 0x55555555, -1, -0x55555556),
           ("ternary_majority_plus_one", 16, 0x55555555, -1, -0x55555556))


def tally_fns(ops, ref, name):
    """(kernel wrapper, plain version) of tally `name` of TALLIES."""
    if name == "ternary_majority_plus_one":
        return (lambda p, out=None: ops.ternary_majority(
                    p, ties="plus_one", out=out),
                lambda p: ref.ternary_majority(p, "plus_one"))
    return getattr(ops, name), getattr(ref, name)


def planted_words(torch, gen, m, w, dev, plus, minus, unused):
    """(m, w) random int32 words with planted columns, where w has room:
    column 0 all ones (on the 2-bit wire, all -1), column 1 all zeros (all
    abstaining), column 2 an exact tie at even M (the first M // 2 rows
    `plus`, the next M // 2 `minus`, an odd M's last row 0) and, on the
    2-bit wire, column 3 the unused 0b10 in every other row and 0 in the
    rest, which counts nothing."""
    words = torch.randint(-2 ** 31, 2 ** 31, (m, w), generator=gen,
                          device=dev, dtype=torch.int32)
    half = m // 2
    cols = [[-1] * m, [0] * m, [plus] * half + [minus] * half + [0] * (m % 2)]
    if unused is not None:
        cols.append(([unused, 0] * m)[:m])
    for j, col in enumerate(cols[:w]):
        words[:, j] = torch.tensor(col, dtype=torch.int32, device=dev)
    return words


def check_tallies(torch, ops, ref, sc, dev, err) -> int:
    """majority and ternary_majority against their plain versions, bit for
    bit: every M of TALLY_VOTERS at TALLY_SIZES, w of each remainder mod 4,
    and a (M, w) stack and an out that start off a 16-byte boundary (the
    elements around the out view held unchanged). Updates `err`, returns the
    number of checks."""
    gen = torch.Generator(device=dev).manual_seed(1357)
    n_checks = 0
    for name, per_word, plus, minus, unused in TALLIES:
        kernel, plain = tally_fns(ops, ref, name)

        def check(what, packed, out=None):
            got = kernel(packed) if out is None else kernel(packed, out=out)
            err[name] = max(err[name], require_equal(
                f"{name} {what}", got, plain(packed)))

        cases = [(m, -(-n // per_word)) for n in TALLY_SIZES
                 for m in TALLY_VOTERS]
        cases += [(m, w) for w in TALLY_WORDS for m in TALLY_WORD_VOTERS]
        for m, w in cases:
            check(f"M={m} w={w}", planted_words(torch, gen, m, w, dev, plus,
                                                minus, unused))
            n_checks += 1
        for m in TALLY_VIEW_VOTERS:
            for w in (1024, 1027):
                words = planted_words(torch, gen, m, w, dev, plus, minus,
                                      unused)
                buf = torch.zeros(m * w + 2, dtype=torch.int32, device=dev)
                packed = buf[1:1 + m * w].view(m, w)
                packed.copy_(words)
                check(f"M={m} w={w} stack 4 B off a 16-byte boundary",
                      packed)
                whole = torch.full((w + 2,), 0x5A5A5A5A, dtype=torch.int32,
                                   device=dev)
                guard = whole.clone()
                check(f"M={m} w={w} out=buf[1:]", words,
                      out=whole[1:1 + w])
                require_equal(f"{name} M={m} w={w}: words around out",
                              whole[[0, -1]], guard[[0, -1]])
                n_checks += 2
                del words, buf, packed, whole, guard
        torch.cuda.synchronize()
    return n_checks


def check_momentum_bf16(torch, ops, ref, sc, dev, err) -> int:
    """momentum_sign_pack with bf16 momentum (the preset path's
    instantiation) against its plain version, bit for bit: g float32 and
    bf16, every n of SIZES, every beta of BF16_BETAS, planted +0.0 / -0.0
    in g and m (m' = +0.0 or -0.0, bit +1), into a new m' with the words,
    then in place (m_out = m) with and without them. Updates `err` under
    "momentum_sign_pack_bf16m"; returns the number of checks."""
    gen = torch.Generator(device=dev).manual_seed(8642)
    name = "momentum_sign_pack_bf16m"
    n_checks = 0
    for n in SIZES:
        for gdtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, generator=gen, device=dev).to(gdtype)
            m0 = (torch.randn(n, generator=gen, device=dev) * 0.3).to(
                torch.bfloat16)
            g[::7], m0[::7] = 0.0, 0.0
            g[3::7], m0[3::7] = -0.0, -0.0
            g[5::11], m0[5::11] = -0.0, 0.0
            plant_momenta(g, m0)
            for beta in BF16_BETAS:
                m_r, p_r = ref.momentum_sign_pack(
                    sc.pad_to_pack(g)[0], sc.pad_to_pack(m0)[0], beta)
                m_r = m_r[:n]
                what = f"{name} n={n} g {gdtype} beta={beta!r}"
                m_k, p_k = ops.momentum_sign_pack(g, m0, beta)
                e = max(require_equal(f"{what} m'", m_k.view(torch.int16),
                                      m_r.view(torch.int16)),
                        require_equal(f"{what} words", p_k, p_r))
                for pack in (True, False):
                    m = m0.clone()
                    _, p_in = ops.momentum_sign_pack(g, m, beta, m_out=m,
                                                     pack=pack)
                    e = max(e, require_equal(
                        f"{what} in place pack={pack} m'",
                        m.view(torch.int16), m_r.view(torch.int16)))
                    if pack:
                        e = max(e, require_equal(
                            f"{what} in place words", p_in, p_r))
                    elif p_in is not None:
                        raise AssertionError(f"{what}: pack=False gave words")
                    del m, p_in
                err[name] = max(err[name], e)
                n_checks += 3
                del m_r, p_r, m_k, p_k
            del g, m0
        torch.cuda.synchronize()
    return n_checks


#: momentum_sign_pack's placement checks: (g, m) offsets in elements past a
#: 16-byte boundary (each of APPLY_OFFSETS, and g and m apart); m_out is m
#: itself (in place) or a view (m's offset + 1) % 4 past a boundary
MSP_PLACEMENTS = tuple((o, o) for o in APPLY_OFFSETS) + ((1, 0), (0, 3))
#: the four instantiations: (g dtype, m dtype) by name, and the name under
#: which phase 2 reports them
MSP_DTYPES = (("float32", "float32", "momentum_sign_pack"),
              ("bfloat16", "float32", "momentum_sign_pack"),
              ("float32", "bfloat16", "momentum_sign_pack_bf16m"),
              ("bfloat16", "bfloat16", "momentum_sign_pack_bf16m"))


def require_bits_equal(torch, what: str, got, want) -> float:
    """`got` bit-equal to `want` (float32 / bf16 compared as bit patterns,
    so -0.0 differs from +0.0), a NaN equal to any NaN: neither the kernel
    nor the plain version specifies a NaN's payload."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN where the plain version has none")
    return require_equal(what, got.masked_fill(both_nan, 0).view(
        bits[got.dtype]), want.masked_fill(both_nan, 0).view(bits[got.dtype]))


def check_momentum_placement(torch, ops, ref, sc, dev, err) -> int:
    """momentum_sign_pack, all four instantiations (g float32 / bf16 x m
    float32 / bf16), at APPLY_SIZES (below, at and past one 1024-element
    segment), with g and m views at MSP_PLACEMENTS, in place (m_out = m)
    and into a separate m_out one element further along, with and without
    the words (the 16-byte path and the element path). m carries planted
    +0.0, -0.0, a NaN (m' NaN, bit 0) and SUBNORMAL_MOMENTA, g subnormals.
    m' bit-equal to the plain version (a NaN to a NaN), the words bit-equal,
    the elements around every view unchanged. Updates `err`; returns the
    number of checks."""
    gen = torch.Generator(device=dev).manual_seed(9753)
    n_checks = 0
    for n in APPLY_SIZES:
        w = sc.words_for(n)
        for gname, mname, name in MSP_DTYPES:
            gdt, mdt = getattr(torch, gname), getattr(torch, mname)
            g0 = torch.randn(n, generator=gen, device=dev).to(gdt)
            m0 = torch.randn(n, generator=gen, device=dev).to(mdt)
            g0[::7], m0[::7] = 0.0, 0.0
            m0[3::7] = -0.0
            m0[4::97] = float("nan")
            plant_momenta(g0, m0)
            m_r, p_r = ref.momentum_sign_pack(sc.pad_to_pack(g0)[0],
                                              sc.pad_to_pack(m0)[0], BETA)
            m_r = m_r[:n]
            e = 0.0
            for g_off, m_off in MSP_PLACEMENTS:
                gbuf = torch.zeros(g_off + n + 5, dtype=gdt, device=dev)
                gbuf[g_off:g_off + n] = g0
                g = gbuf[g_off:g_off + n]
                mbuf = torch.full((m_off + n + 5,), 7.0, dtype=mdt,
                                  device=dev)
                for in_place in (True, False):
                    o = m_off if in_place else (m_off + 1) % 4
                    obuf = mbuf if in_place else torch.full(
                        (o + n + 5,), 7.0, dtype=mdt, device=dev)
                    for pack in (True, False):
                        mbuf[m_off:m_off + n] = m0
                        m = mbuf[m_off:m_off + n]
                        m_out = obuf[o:o + n]
                        guard = obuf.clone()
                        what = (f"{name} n={n} g {gname}+{g_off} m "
                                f"{mname}+{m_off} "
                                + ("in place" if in_place
                                   else f"m_out+{o}") + f" pack={pack}")
                        _, words = ops.momentum_sign_pack(
                            g, m, BETA, m_out=m_out, pack=pack)
                        e = max(e, require_bits_equal(torch, f"{what} m'",
                                                      m_out, m_r))
                        if pack:
                            e = max(e, require_equal(f"{what} words", words,
                                                     p_r))
                        elif words is not None:
                            raise AssertionError(f"{what}: words written")
                        require_equal(f"{what}: elements around m_out",
                                      torch.cat([obuf[:o], obuf[o + n:]]),
                                      torch.cat([guard[:o], guard[o + n:]]))
                        require_equal(f"{what}: g", gbuf[g_off:g_off + n],
                                      g0)
                        n_checks += 1
                        del words, guard
                    del obuf
                del gbuf, g, mbuf, m, m_out
            err[name] = max(err[name], e)
            del g0, m0, m_r, p_r
        torch.cuda.synchronize()
    return n_checks


def check_kernels(torch, ops, ref, sc, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    err = {name: 0.0 for name in ops.launch_counts()}
    err["momentum_sign_pack_bf16m"] = 0.0
    n_checks = 0
    for n in SIZES:
        w = sc.words_for(n)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, generator=gen, device=dev).to(dtype)
            m = torch.randn(n, generator=gen, device=dev)
            g[::7], m[::7] = 0.0, 0.0          # m' = 0 -> bit +1
            m[3::7], g[3::7] = -0.0, -0.0      # m' = -0 -> bit +1
            plant_momenta(g, m)
            m_k, p_k = ops.momentum_sign_pack(g, m, BETA)
            m_r, p_r = ref.momentum_sign_pack(sc.pad_to_pack(g)[0],
                                              sc.pad_to_pack(m)[0], BETA)
            e = max(require_equal(f"momentum_sign_pack m' n={n} {dtype}",
                                  m_k, m_r[:n]),
                    require_equal(f"momentum_sign_pack words n={n} {dtype}",
                                  p_k, p_r))
            # the ternary2bit / ef_sign encode: m' only, no words
            m_np, none = ops.momentum_sign_pack(g, m, BETA, pack=False)
            if none is not None:
                raise AssertionError("pack=False gave words")
            e = max(e, require_equal(
                f"momentum_sign_pack pack=False m' n={n} {dtype}", m_np,
                m_r[:n]))
            n_checks += 1
            err["momentum_sign_pack"] = max(err["momentum_sign_pack"], e)
            del g, m, m_k, p_k, m_r, p_r, m_np
            p = plant_subnormals(
                torch.randn(n, generator=gen, device=dev).to(dtype))
            votes = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen,
                                  device=dev, dtype=torch.int32)
            for eta, wd in APPLY_RATES:
                got = ops.apply_vote(p, votes, eta, wd)
                want = ref.apply_vote(sc.pad_to_pack(p)[0], votes, eta,
                                      wd)[:n]
                err["apply_vote"] = max(err["apply_vote"], require_equal(
                    f"apply_vote n={n} {dtype} eta={eta} wd={wd}", got,
                    want))
                del got, want
            del p, votes
            n_checks += 1 + len(APPLY_RATES)
        for m_voters in VOTERS:
            packed = torch.randint(-2 ** 31, 2 ** 31, (m_voters, w),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            err["majority"] = max(err["majority"], require_equal(
                f"majority n={n} M={m_voters}", ops.majority(packed),
                ref.majority(packed)))
            del packed
            n_checks += 1
        torch.cuda.synchronize()
    n_checks += check_apply_placement(torch, ops, ref, sc, dev, gen, err,
                                      ternary=False)
    n_checks += check_sign_kernels(torch, ops, ref, sc, dev, err)
    n_checks += check_ternary_kernels(torch, ops, ref, sc, dev, err)
    n_checks += check_tallies(torch, ops, ref, sc, dev, err)
    n_checks += check_momentum_bf16(torch, ops, ref, sc, dev, err)
    n_checks += check_momentum_placement(torch, ops, ref, sc, dev, err)
    # ef_sign's mean|t| summed over ten SCALE_CHUNKs (torch ops, no kernel)
    from repro_torch.core.codecs import ef_sign
    t = torch.randn(N_UNEMBED, generator=gen, device=dev)
    rel = check_scale(torch, f"scale_of n={N_UNEMBED}", t, ef_sign.scale_of(t))
    del t
    log({"phase": "kernels_vs_plain", "checks": n_checks, "max_abs_err": err,
         "scale_of_rel_err": rel})
    return err


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def leaf_grads(torch, M, cfg, params, tokens, per, leaf="unembed.table"):
    """Each voter's gradient of `leaf` at `params`, by plain autograd."""
    out = []
    for r in range(M_MAIN):
        leaves = dict(params)
        leaves[leaf] = params[leaf].detach().requires_grad_()
        loss, _ = M.loss_fn(cfg, leaves,
                            {"tokens": tokens[r * per:(r + 1) * per]})
        out.append(torch.autograd.grad(loss, [leaves[leaf]])[0])
    return out


def train_config(codec: str):
    from repro_torch.configs.base import (OptimizerConfig, TrainConfig,
                                          VoteStrategy)
    return TrainConfig(global_batch=GLOBAL_BATCH, seq_len=SEQ,
                       optimizer=OptimizerConfig(
                           kind="signum_vote", learning_rate=LR,
                           momentum=BETA,
                           vote_strategy=VoteStrategy.ALLGATHER_1BIT,
                           codec=codec))


def step_launches(codec: str, n_leaves: int) -> dict:
    """The kernel launches one step of `codec` makes (M_MAIN voters)."""
    per_voter = M_MAIN * n_leaves
    return {
        "sign1bit": {"momentum_sign_pack": per_voter, "majority": n_leaves,
                     "apply_vote": n_leaves},
        "ternary2bit": {"momentum_sign_pack": per_voter,
                        "ternary_pack": per_voter,
                        "ternary_majority": n_leaves,
                        "apply_ternary_vote": n_leaves},
        "ef_sign": {"momentum_sign_pack": per_voter, "bitpack": per_voter,
                    "majority": n_leaves, "apply_vote": n_leaves,
                    "bitunpack": n_leaves},
        "weighted_vote": {"momentum_sign_pack": per_voter,
                          "bitunpack": n_leaves, "bitpack": n_leaves,
                          "apply_vote": n_leaves},
    }[codec]


def run_train_path(torch, cfg, dev, codec: str, leaf: str,
                   vote_after: bool = False) -> dict:
    """One training path (phase 3 for sign1bit, phase 5 for the other
    codecs): 5 full-width steps from fresh state with exact launches per
    step, a bit-exact step 0 of `leaf`, the peak memory and a profiled
    step; then, with `vote_after`, the vote path (phase 4) and the plan
    votes (phase 4b) on the trained momentum. Returns the launches of the
    path and its losses."""
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    tcfg = train_config(codec)
    n_params = cfg.param_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
    params, opt_state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
    per = GLOBAL_BATCH // M_MAIN
    want = step_launches(codec, len(params))
    log({"phase": "train_path", "codec": art.codec, "arch": cfg.name,
         "num_layers": cfg.num_layers, "d_model": cfg.d_model,
         "vocab": cfg.vocab_size, "params": n_params, "voters": M_MAIN,
         "global_batch": GLOBAL_BATCH, "seq": SEQ,
         "state": sorted(opt_state), "resident_before_bytes": resident})

    ops.reset_launch_counts()
    seen = ops.launch_counts()
    step_ms, losses = [], []
    for step in range(STEPS):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=dev)
        if step == 0:   # saved copies for the bit-exact check of step 0
            p0 = params[leaf].clone()
            g0 = leaf_grads(torch, M, cfg, params, tokens, per, leaf)
            e0 = params["embed.table"].clone() if codec == "ternary2bit" \
                else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = art.step_fn(params, opt_state,
                                             {"tokens": tokens}, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(met["loss"])
        counts = ops.launch_counts()
        per_step = {k: counts[k] - seen[k] for k in counts
                    if counts[k] != seen[k]}
        seen = counts
        line = {"codec": codec, "step": step, "loss": loss, "ms": ms,
                "launches": per_step}
        if "codec" in opt_state:
            line["flip_ema"] = opt_state["codec"]["flip_ema"].tolist()
        log(line)
        if not math.isfinite(loss):
            raise AssertionError(f"{codec} step {step}: loss {loss}")
        if per_step != want:
            raise AssertionError(f"{codec} step {step}: launches {per_step}, "
                                 f"expected {want}")
        step_ms.append(ms)
        losses.append(loss)
        if step == 0:
            check_codec_step0(torch, signum, tcfg, codec, leaf, p0, g0,
                              params, opt_state)
            if e0 is not None:   # untouched embedding rows abstain
                held = int((params["embed.table"] == e0).sum())
                log({"phase": "ternary_step0_embed_held_still",
                     "coords": held, "of": e0.numel()})
                if held == 0:
                    raise AssertionError("ternary2bit moved every embedding "
                                         "coordinate at step 0")
            del p0, g0, e0
    launches = ops.launch_counts()   # read just after the training path
    peak = torch.cuda.max_memory_allocated()
    if "codec" in opt_state:
        ema = opt_state["codec"]["flip_ema"]
        if not (torch.isfinite(ema).all() and (ema >= 0).all()
                and (ema <= 1).all()):
            raise AssertionError(f"flip_ema out of range: {ema.tolist()}")
    # step 0 carries the warm-up (cuBLAS handles, first launches)
    median = statistics.median(step_ms[1:])
    log({"phase": "train_path_done", "codec": codec, "losses": losses,
         "step_ms_median_1_4": median, "max_memory_allocated_bytes": peak,
         "max_memory_allocated_GiB": peak / 2 ** 30})
    for k, v in want.items():
        if launches[k] != STEPS * v:
            raise AssertionError(f"{codec} {k}: {launches[k]} launches over "
                                 f"the run, expected {STEPS * v}")
    profile_step(torch, art, params, opt_state, pipe, dev, n_params, median,
                 codec)
    if vote_after:
        for k, v in run_vote_path(torch, opt_state["momentum"], dev).items():
            launches[k] += v
        for k, v in run_plan_votes(torch, opt_state["momentum"],
                                   dev).items():
            launches[k] += v
    del params, opt_state, art
    torch.cuda.empty_cache()
    return launches, losses


def plain_votes(torch, ref, sc, label, x):
    """(n,) int8 votes of the stacked (M, n) payload `x` on wire `label`,
    composed from the plain versions (``kernels/ref.py``) and torch ops."""
    m, n = x.shape
    if label == "ternary_allgather_1bit":
        words = ref.ternary_majority(ref.ternary_pack(
            sc.pad_last(sc.sign_ternary(x), sc.PACK2)[0]))
        return ref.ternary_unpack(words[None])[0, :n]
    if label == "fused_allgather_1bit":
        words = ref.fused_majority(sc.pad_last(x, sc.PACK)[0])
        return ref.bitunpack(words[None], torch.int8)[0, :n]
    signs = sc.sign_ternary(x)
    if label == "staged_allgather_1bit":
        words = ref.majority(ref.bitpack(sc.pad_last(signs, sc.PACK)[0]))
        return ref.bitunpack(words[None], torch.int8)[0, :n]
    if label in ("psum_int8", "ternary_psum_int8"):
        return torch.sign(signs.sum(dim=0)).to(torch.int8)
    shards = sc.sign_binary(sc.pad_last(signs, sc.PACK * m)[0].sum(dim=0)
                            .view(m, -1))
    words = ref.bitpack(shards).view(1, -1)
    return ref.bitunpack(words, torch.int8)[0, :n]


def run_vote_path(torch, momentum, dev) -> dict:
    """Vote every leaf's trained (M, n) momentum on each wire of
    VOTE_WIRES through the vote API; returns the launches of the sign
    kernels summed over the wires."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import vote_api as va
    from repro_torch.kernels import ops, ref

    payloads = {k: v.view(v.shape[0], -1) for k, v in momentum.items()}
    n_leaves = len(payloads)
    n_total = sum(p.shape[1] for p in payloads.values())
    big = max(payloads, key=lambda k: payloads[k].numel())
    totals = {k: 0 for wire in VOTE_WIRES for k in wire[4]}
    fused_votes = psum_votes = None
    for label, use_kernels, strategy, codec, per_leaf, bits in VOTE_WIRES:
        backend = va.VirtualBackend(use_kernels=use_kernels, device=dev)
        requests = {k: va.VoteRequest(payload=p, form="stacked",
                                      strategy=VoteStrategy(strategy),
                                      codec=codec)
                    for k, p in payloads.items()}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        start.record()
        votes, wires = {}, {}
        for k, req in requests.items():
            out = backend.execute(req)
            votes[k], wires[k] = out.votes, out.wire
        end.record()
        end.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * n_leaves for k, v in per_leaf.items()}
        if launches != want:
            raise AssertionError(f"vote {label}: launches {launches}, "
                                 f"expected {want}")
        for k, v in launches.items():
            totals[k] += v
        for k, wire in wires.items():
            n = payloads[k].shape[1]
            if (wire.payload_bytes != n * bits / 8.0
                    or wire.n_voters != M_MAIN or wire.n_messages != 1
                    or wire.strategy.value != strategy):
                raise AssertionError(f"vote {label} leaf {k}: {wire}")
            if votes[k].shape != (n,) or votes[k].dtype != torch.int8:
                raise AssertionError(f"vote {label} leaf {k}: votes "
                                     f"{votes[k].dtype} {votes[k].shape}")
        require_equal(f"vote {label} {big} against the plain versions",
                      votes[big], plain_votes(torch, ref, sc, label,
                                              payloads[big]))
        if label == "fused_allgather_1bit":
            fused_votes = votes
        elif label == "staged_allgather_1bit":
            for k in payloads:
                require_equal(f"fused and staged 1-bit votes of {k}",
                              votes[k], fused_votes[k])
            fused_votes = None
        elif label == "psum_int8":
            psum_votes = votes
        elif label == "ternary_psum_int8":
            # ternary symbols are the counts psum_int8 already sums
            for k in payloads:
                require_equal(f"ternary2bit and sign1bit psum votes of {k}",
                              votes[k], psum_votes[k])
            psum_votes = None
        plus = sum(int((v == 1).sum()) for v in votes.values())
        zero = sum(int((v == 0).sum()) for v in votes.values())
        log({"phase": "vote", "wire": label, "use_kernels": use_kernels,
             "strategy": strategy, "codec": codec, "leaves": n_leaves,
             "coords": n_total,
             "voters": M_MAIN, "ms": ms, "launches": launches,
             "payload_bytes": sum(w.payload_bytes for w in wires.values()),
             "votes_plus": plus, "votes_zero": zero,
             "votes_minus": n_total - plus - zero,
             "max_memory_allocated_bytes": peak,
             "above_resident_bytes": peak - resident})
        del votes, wires, out
        profile_vote(torch, label, backend, requests)
        del requests
    for k, v in totals.items():
        if not v:
            raise AssertionError(f"the vote path never launched {k}")
    quickstart_vote(torch, va, VoteStrategy, dev)
    return totals


def profile_vote(torch, label, backend, requests) -> None:
    """One more whole-model vote on wire `label` under torch.profiler:
    device time by kernel, for the breakdown of the vote's time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for req in requests.values():
            backend.execute(req)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:120])
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    log({"phase": "vote_profile", "wire": label,
         "device_busy_ms": sum(ms for ms, _, _ in kernels),
         "top_kernels": [{"ms": ms, "count": c, "name": k}
                         for ms, c, k in kernels[:6]]})


def quickstart_vote(torch, va, VoteStrategy, dev) -> None:
    """examples/quickstart.py's 5 x 8 vote, on the card, on both paths."""
    import numpy as np
    g = np.random.default_rng(0).normal(size=(5, 8))
    want = np.where(2 * (g >= 0).sum(axis=0) >= 5, 1, -1)
    req = va.VoteRequest(payload=g, form="stacked",
                         strategy=VoteStrategy.ALLGATHER_1BIT)
    for use_kernels in (False, True):
        out = va.VirtualBackend(use_kernels=use_kernels,
                                device=dev).execute(req)
        got = out.votes.cpu().numpy()
        log({"phase": "quickstart_vote", "use_kernels": use_kernels,
             "worker_signs": np.sign(g).astype(int).tolist(),
             "majority_vote": got.tolist(),
             "wire_bytes_per_replica": out.wire.payload_bytes,
             "messages": out.wire.n_messages,
             "strategy": out.wire.strategy.value})
        if out.votes.device.type != dev.type or not (got == want).all():
            raise AssertionError(f"quickstart vote {got.tolist()} on "
                                 f"{out.votes.device}, expected "
                                 f"{want.tolist()}")


KERNEL_GROUPS = (("momentum_sign_pack", ("momentum_sign_pack_kernel",)),
                 ("ternary_pack", ("ternary_pack_kernel",)),
                 ("ternary_unpack", ("ternary_unpack_kernel",)),
                 ("ternary_majority_plus_one", ("PluralityPlusOne",)),
                 ("ternary_majority", ("TernaryLanes",)),
                 ("apply_ternary_vote", ("TernaryVote>",)),
                 ("majority", ("SignLanes",)),
                 ("apply_vote", ("SignVote>",)),
                 ("bitpack", ("bitpack_kernel",)),
                 ("bitunpack", ("bitunpack_kernel",)),
                 ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
                 ("elementwise", ("elementwise_kernel", "fillfunctor")),
                 ("reduce_softmax", ("reduce_kernel", "softmax",
                                     "logsumexp")))


#: the profiled steps' launches of PyTorch's copy kernels, by codec
COPY_LAUNCHES = {}


def profile_step(torch, art, params, opt_state, pipe, dev, n_params,
                 unprofiled_ms: float, codec: str) -> None:
    """One more step under torch.profiler: device time by kernel group, the
    device's idle share of an unprofiled step (the median of steps 1..4;
    the profiler's own host cost stretches the profiled step's wall time),
    the step's kernels' time beside their per-step bounds over all
    parameters, and its copy kernels. The plan step must launch no more
    copy kernels than phase 3's leaf-wise step: bitpack reads the plan's
    1-bit buckets in place."""
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.global_batch_at(STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        art.step_fn(params, opt_state, batch, STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t_events = time.perf_counter()   # the trace's collection onward
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    kernels = []
    # PyTorch's copy kernels (.contiguous(), casts, slice writes), by name
    direct_copies = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key[:120]))
        if "direct_copy" in e.key:
            direct_copies.append({"ms": ms, "count": e.count,
                                  "name": e.key[:160]})
        low = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k.lower() in low for k in keys)), "other")
        groups[group] += ms
    busy = sum(groups.values())
    n = n_params
    m = M_MAIN
    per_step_bytes = {   # over all leaves, M voters, bf16 params
        "sign1bit": {"momentum_sign_pack": m * n * 10.125,
                     "majority": (m + 1) * n / 8, "apply_vote": n * 4.125},
        # m' alone (no sign words); then one f32 momentum row read, 2 bits
        # written, per voter
        "ternary2bit": {"momentum_sign_pack": m * n * 10,
                        "ternary_pack": m * n * 4.25,
                        "ternary_majority": (m + 1) * n / 4,
                        "apply_ternary_vote": n * 4.25},
        # m' alone; bitpack reads each voter's f32 t; bitunpack writes the
        # f32 vote
        "ef_sign": {"momentum_sign_pack": m * n * 10,
                    "bitpack": m * n * 4.125, "majority": (m + 1) * n / 8,
                    "apply_vote": n * 4.125, "bitunpack": n * 4.125},
        # bitunpack writes the (M, n) int8 signs; bitpack reads the int8
        # vote
        "weighted_vote": {"momentum_sign_pack": m * n * 10.125,
                          "bitunpack": m * n * 1.125,
                          "bitpack": n * 1.125, "apply_vote": n * 4.125},
        # the preset: bf16 g, m read, m' written, no words; ternary_pack
        # reads each voter's bf16 m' row and writes 2 bits
        # the plan path: m' alone; per bucket bitpack reads the (M, len)
        # int8 signs, bitunpack writes the int8 vote; per leaf ternary_pack
        # reads the int8 vote
        "plan": {"momentum_sign_pack": m * n * 10,
                 "bitpack": m * n * 1.125, "majority": (m + 1) * n / 8,
                 "bitunpack": n * 1.125, "ternary_pack": n * 1.25,
                 "apply_ternary_vote": n * 4.25},
        "preset": {"momentum_sign_pack": m * n * 6,
                   "ternary_pack": m * n * 2.25,
                   "ternary_majority": (m + 1) * n / 4,
                   "apply_ternary_vote": n * 4.25},
        # the preset with float32 momentum (phase 17b): bf16 g read, f32 m
        # read and m' written; ternary_pack reads each voter's f32 m' row
        "preset_f32m": {"momentum_sign_pack": m * n * 10,
                        "ternary_pack": m * n * 4.25,
                        "ternary_majority": (m + 1) * n / 4,
                        "apply_ternary_vote": n * 4.25},
        # Mode B on hierarchical: ternary_pack reads each voter's bf16
        # gradient row and u's float32 row, 2 bits out each; the tally; the
        # vote unpacked to bf16; the momentum kernel reads the bf16 vote and
        # the float32 u, writes u (no words); the ternary apply
        "mode_b": {"ternary_pack": m * n * 2.25 + n * 4.25,
                   "ternary_majority_plus_one": (m + 1) * n / 4,
                   "ternary_unpack": n * 2.25,
                   "momentum_sign_pack": n * 10,
                   "apply_ternary_vote": n * 4.25},
    }[codec]
    per_step_bound = {k: b / HBM_BYTES_PER_S * 1e3
                      for k, b in per_step_bytes.items()}
    COPY_LAUNCHES[codec] = sum(c["count"] for c in direct_copies)
    log({"phase": "profiled_step", "codec": codec, "profiled_wall_ms": wall_ms,
         "events_s": time.perf_counter() - t_events,
         "unprofiled_step_ms": unprofiled_ms, "device_busy_ms": busy,
         "device_idle_share": (1 - busy / unprofiled_ms) if busy else None,
         "device_ms_by_group": groups,
         "kernel_ms_per_step": {k: groups[k] for k in per_step_bound},
         "kernel_bound_ms_per_step": per_step_bound,
         "direct_copy_launches": COPY_LAUNCHES[codec],
         "direct_copy_kernels": sorted(direct_copies, key=lambda c: -c["ms"]),
         "top_kernels": [{"ms": ms, "count": c, "name": k} for ms, c, k
                         in sorted(kernels, reverse=True)[:12]]})
    if codec == "plan" and COPY_LAUNCHES["plan"] > COPY_LAUNCHES["sign1bit"]:
        raise AssertionError(
            f"the plan step launched {COPY_LAUNCHES['plan']} copy kernels, "
            f"the leaf-wise step {COPY_LAUNCHES['sign1bit']}: a bucket was "
            "copied")


def check_codec_step0(torch, signum, tcfg, codec, leaf, p0, g0, params,
                      opt_state) -> None:
    """Step 0 of `leaf` under `codec`, recomputed from the saved parameters
    and gradients with the plain versions (momentum and ef_sign's residual
    start at zero): momentum, ef_sign's residual and the parameters
    bit-equal."""
    from repro_torch.core.codecs import ef_sign, weighted
    from repro_torch.kernels import ref
    eta = signum.lr_at(tcfg.optimizer, 0)
    wd = tcfg.optimizer.weight_decay
    n = p0.numel()
    m1 = opt_state["momentum"][leaf].view(M_MAIN, -1)
    inputs, words, rel = [], [], 0.0
    for r in range(M_MAIN):
        g = g0[r].reshape(1, -1)
        m_ref, bits = ref.momentum_sign_pack(
            g, torch.zeros(g.shape, dtype=torch.float32, device=g.device),
            BETA)
        require_equal(f"{codec} step 0 momentum of voter {r}",
                      m1[r].view(1, -1), m_ref)
        if codec == "ef_sign":
            t = torch.zeros_like(m_ref) + m_ref     # e + m', e = 0
            inputs.append(t)
            words.append(ref.bitpack(t)[0])
        elif codec == "ternary2bit":
            words.append(ref.ternary_pack(m_ref)[0])
        else:
            words.append(bits[0])
    words = torch.stack(words)
    p = p0.view(1, -1)
    if codec == "ternary2bit":
        p_ref = ref.apply_ternary_vote(p, ref.ternary_majority(words)[None],
                                       eta, wd)
    else:
        votes = ref.majority(words)
        if codec == "weighted_vote":
            stacked = ref.bitunpack(words, torch.int8)[:, :n]
            w = weighted.reliability_weights(
                opt_state["codec"]["flip_ema"].new_zeros(M_MAIN))
            vote, _ = weighted.decode_leaf_fixed(stacked, w)
            # the zero prior's equal weights decode the plain majority
            require_equal("weighted_vote step 0 vote against the majority",
                          ref.bitpack(vote.view(1, -1))[0], votes)
        p_ref = ref.apply_vote(p, votes[None], eta, wd)
        if codec == "ef_sign":
            # the residual bit for bit with the program's mean|t|, which is
            # itself held to a float64 sum of |t|
            vote = ref.bitunpack(votes[None], torch.float32)[0, :n]
            e1 = opt_state["error"][leaf].view(M_MAIN, -1)
            for r, t in enumerate(inputs):
                scale = ef_sign.scale_of(t)
                rel = max(rel, check_scale(
                    torch, f"ef_sign step 0 mean|t| of voter {r}", t, scale))
                require_equal(f"ef_sign step 0 residual of voter {r}", e1[r],
                              t[0] - scale * vote)
    require_equal(f"{codec} step 0 parameters", params[leaf].view(1, -1),
                  p_ref)
    line = {"phase": "step0_bit_equal", "codec": codec, "leaf": leaf,
            "coords": n, "ok": True}
    if codec == "ef_sign":
        line["scale_rel_err"] = rel
    log(line)


# ---------------------------------------------------------------------------
# phase 6: the glm4-9b preset's train step
# ---------------------------------------------------------------------------


def preset_launches(n_leaves: int) -> dict:
    """The kernel launches one step of the preset makes (M_MAIN voters, the
    count wire: bf16-m momentum_sign_pack without words, then ternary_pack
    of each voter's m' row; one tally and one apply per leaf)."""
    per_voter = M_MAIN * n_leaves
    return {"momentum_sign_pack": per_voter, "ternary_pack": per_voter,
            "ternary_majority": n_leaves, "apply_ternary_vote": n_leaves}


def batch_rows(batch: dict, start: int, rows: int) -> dict:
    """Rows [start, start + rows) of every tensor of a batch."""
    return {k: v[start:start + rows] for k, v in batch.items()}


def preset_leaf_grads(torch, M, cfg, tcfg, params, batch, leaf):
    """Each voter's accumulated gradient of `leaf`, by plain autograd per
    microbatch of `batch` (each block checkpointed as the preset has it),
    summed in a bf16 accumulator from zeros and divided by the microbatch
    count, as the reference's acc_body scan does."""
    per = batch["tokens"].shape[0] // M_MAIN
    micro = tcfg.microbatches
    rows = per // micro
    out = []
    for r in range(M_MAIN):
        acc = torch.zeros_like(params[leaf], dtype=torch.bfloat16)
        for i in range(micro):
            leaves = dict(params)
            leaves[leaf] = params[leaf].detach().requires_grad_()
            start = r * per + i * rows
            loss, _ = M.loss_fn(cfg, leaves, batch_rows(batch, start, rows),
                                remat=tcfg.remat)
            acc.add_(torch.autograd.grad(loss, [leaves[leaf]])[0].to(
                torch.bfloat16))
        out.append(acc.div_(micro))
    return out


def run_preset_path(torch, cfg, dev) -> dict:
    """Phase 6: the reference's configured glm4-9b training,
    ``make_train_step(cfg, default_train_config("glm4-9b", cell), 4)``, at
    every published width, depth cut to 2 layers, cell (seq 512, batch 32):
    bf16 per-worker momentum on psum_int8, 8 microbatches, remat="full",
    lr 1e-4, beta 0.9. Five steps from fresh state with exact launches per
    step, step 0 of PRESET_LEAF (its bf16 momentum rows and its update)
    bit-equal to the plain versions recomputed from saved copies and the
    peak memory. Returns the launches of the path."""
    from repro_torch.configs.base import ShapeCell, VoteStrategy
    from repro_torch.configs.presets import default_train_config
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    cell = ShapeCell("train_smoke", PRESET_SEQ, PRESET_BATCH, "train")
    tcfg = default_train_config("glm4-9b", cell)
    opt = tcfg.optimizer
    if (opt.momentum_dtype, opt.vote_strategy, tcfg.microbatches,
            tcfg.remat) != ("bfloat16", VoteStrategy.PSUM_INT8, 8, "full"):
        raise AssertionError(f"not the glm4-9b preset: {tcfg}")
    n_params = cfg.param_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
    params, opt_state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    if any(m.dtype != torch.bfloat16 for m in opt_state["momentum"].values()):
        raise AssertionError("the preset's momentum is not bf16")
    pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, tcfg.seq_len, seed=0)
    want = preset_launches(len(params))
    log({"phase": "preset_path", "arch": cfg.name,
         "num_layers": cfg.num_layers, "d_model": cfg.d_model,
         "vocab": cfg.vocab_size, "params": n_params, "voters": M_MAIN,
         "global_batch": tcfg.global_batch, "seq": tcfg.seq_len,
         "microbatches": tcfg.microbatches, "remat": tcfg.remat,
         "momentum_dtype": opt.momentum_dtype,
         "vote_strategy": art.vote_strategy.value, "lr": opt.learning_rate,
         "beta": opt.momentum, "state": sorted(opt_state),
         "resident_before_bytes": resident})

    ops.reset_launch_counts()
    seen = ops.launch_counts()
    step_ms, losses = [], []
    for step in range(STEPS):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=dev)
        if step == 0:   # saved copies for the bit-exact check of step 0
            p0 = params[PRESET_LEAF].clone()
            g0 = preset_leaf_grads(torch, M, cfg, tcfg, params,
                                   {"tokens": tokens}, PRESET_LEAF)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = art.step_fn(params, opt_state,
                                             {"tokens": tokens}, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(met["loss"])
        counts = ops.launch_counts()
        per_step = {k: counts[k] - seen[k] for k in counts
                    if counts[k] != seen[k]}
        seen = counts
        log({"preset": "glm4-9b", "step": step, "loss": loss, "ms": ms,
             "launches": per_step})
        if not math.isfinite(loss):
            raise AssertionError(f"preset step {step}: loss {loss}")
        if per_step != want:
            raise AssertionError(f"preset step {step}: launches {per_step}, "
                                 f"expected {want}")
        step_ms.append(ms)
        losses.append(loss)
        if step == 0:
            eta = signum.lr_at(opt, 0)
            mom = opt_state["momentum"][PRESET_LEAF].view(M_MAIN, -1)
            words = []
            for r in range(M_MAIN):
                g = g0[r].reshape(1, -1)
                m_ref, _ = ref.momentum_sign_pack(
                    g, torch.zeros_like(g), opt.momentum)
                require_equal(f"preset step 0 momentum of voter {r}",
                              mom[r].view(1, -1).view(torch.int16),
                              m_ref.view(torch.int16))
                words.append(ref.ternary_pack(m_ref)[0])
            p_ref = ref.apply_ternary_vote(
                p0.view(1, -1), ref.ternary_majority(torch.stack(words))[None],
                eta, opt.weight_decay)
            require_equal("preset step 0 parameters",
                          params[PRESET_LEAF].view(1, -1), p_ref)
            log({"phase": "step0_bit_equal", "codec": "preset",
                 "leaf": PRESET_LEAF, "coords": p0.numel(), "ok": True})
            del p0, g0, mom, words, p_ref
    launches = ops.launch_counts()   # read just after the preset path
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(step_ms[1:])
    log({"phase": "preset_path_done", "losses": losses,
         "step_ms_median_1_4": median, "max_memory_allocated_bytes": peak,
         "max_memory_allocated_GiB": peak / 2 ** 30})
    for k, v in want.items():
        if launches[k] != STEPS * v:
            raise AssertionError(f"preset {k}: {launches[k]} launches over "
                                 f"the run, expected {STEPS * v}")
    # (its profiled step, ~23 s of profiler events on a host-bound step,
    # was cut for the script's time once phase 19d-19f joined it)
    del params, opt_state, art
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if v}


# ---------------------------------------------------------------------------
# the -ftz=true build: flushed float32 operations in the kernels' SASS
# ---------------------------------------------------------------------------

#: float32 SASS operations that must carry .FTZ (compares and arithmetic)
FTZ_OPS = ("FSETP", "FMUL", "FADD", "FFMA")


def check_ftz(build) -> None:
    """Each built library's float32 compares and arithmetic in its SASS
    (``cuobjdump -sass``) carry .FTZ: a subnormal operand reads as a zero
    and a subnormal result is flushed, as in the reference."""
    from pathlib import Path
    tool = str(Path(build.nvcc_path()).parent / "cuobjdump")
    counts = {}
    for name in build.SIGNATURES:
        sass = subprocess.run([tool, "-sass", str(build._target(name))],
                              check=True, capture_output=True,
                              text=True).stdout
        ops_seen = {op: [0, 0] for op in FTZ_OPS}
        bad, function = [], ""
        for line in sass.splitlines():
            if "Function :" in line:
                function = line.split("Function :")[1].strip()
            for op in FTZ_OPS:
                if f" {op}." in line or f" {op} " in line:
                    ops_seen[op][".FTZ" in line] += 1
                    if ".FTZ" not in line:
                        bad.append(f"{function}: {line.strip()}")
        counts[name] = {op: {"ftz": c[1], "not_ftz": c[0]}
                        for op, c in ops_seen.items() if any(c)}
        if bad:
            raise AssertionError(f"{name}: float32 SASS operations without "
                                 ".FTZ:\n" + "\n".join(bad[:12]))
    log({"phase": "ftz_sass", "ops": counts})


# ---------------------------------------------------------------------------
# phase 4b: the trained momentum voted through a VotePlan
# ---------------------------------------------------------------------------

#: the plan phases' bucket sizes: 13 buckets of the 1-bit (25 of the 2-bit)
#: wire at PLAN_BUCKET_BYTES, 197 at PLAN_SMALL_BUCKET_BYTES, over the
#: 1,649,439,744 coordinates of the cut glm4-9b
PLAN_BUCKET_BYTES, PLAN_SMALL_BUCKET_BYTES = 1 << 24, 1 << 20
FULL_PARAMS = 1_649_439_744
#: (bucket bytes, codec bits per coordinate) -> buckets at FULL_PARAMS
PLAN_BUCKETS = {(PLAN_BUCKET_BYTES, 1.0): 13, (PLAN_BUCKET_BYTES, 2.0): 25,
                (PLAN_SMALL_BUCKET_BYTES, 1.0): 197}
#: phase 4b's wires: (label, strategy, codec, the phase-4 wire whose
#: leaf-wise votes the plan's must equal, or None for a stateful codec)
PLAN_WIRES = (
    ("plan_staged_allgather_1bit", "allgather_1bit", "sign1bit",
     "staged_allgather_1bit"),
    ("plan_psum_int8", "psum_int8", "sign1bit", "psum_int8"),
    ("plan_hierarchical", "hierarchical", "sign1bit", "hierarchical"),
    ("plan_ternary_allgather_1bit", "allgather_1bit", "ternary2bit",
     "ternary_allgather_1bit"),
    ("plan_weighted_vote", "allgather_1bit", "weighted_vote", None),
)


def bucket_launches(bucket) -> dict:
    """The kernel launches of one bucket of the plan walk."""
    strategy = bucket.strategy.value
    if bucket.codec == "ternary2bit" and strategy == "allgather_1bit":
        return {"ternary_pack": 1, "ternary_majority": 1,
                "ternary_unpack": 1}
    if bucket.codec == "weighted_vote":
        return {"bitpack": 1, "bitunpack": 1}
    return {"allgather_1bit": {"bitpack": 1, "majority": 1, "bitunpack": 1},
            "hierarchical": {"bitpack": 1, "bitunpack": 1},
            "psum_int8": {}}[strategy]


def plan_launches(plan) -> dict:
    want = {}
    for b in plan.buckets:
        for k, v in bucket_launches(b).items():
            want[k] = want.get(k, 0) + v
    return want


def check_bucket_count(plan, n_total: int, bucket_bytes: int) -> None:
    bits = {"ternary2bit": 2.0}.get(plan.groups[0].codec, 1.0)
    want = PLAN_BUCKETS.get((bucket_bytes, bits))
    if n_total == FULL_PARAMS and want is not None \
            and plan.n_buckets != want:
        raise AssertionError(f"{plan.n_buckets} buckets, expected {want}")


def timed(torch, fn):
    """(fn(), CUDA-event ms, launches, peak above the memory resident
    before) of one call, the launch counts set to 0 just before it."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ops.reset_launch_counts()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    return (out, start.elapsed_time(end), launches,
            torch.cuda.max_memory_allocated() - resident)


def run_plan_votes(torch, momentum, dev) -> dict:
    """Phase 4b: the trained (M, n) momentum of every leaf flattened into
    one (M, n_params) int8 sign buffer (each voter's row written leaf by
    leaf, as the trainer's plan path writes it) and voted through the vote
    API with a VotePlan of PLAN_BUCKET_BYTES on each of PLAN_WIRES,
    synchronous and overlapped: exact launches per bucket, overlap
    bit-equal to sync, the stateless wires bit-equal to phase 4's
    leaf-wise votes of the same momentum; then plan_vote_stacked at both
    bucket sizes, one fused_majority and one bitunpack per bucket,
    bit-equal to the staged plan. Returns the launches of the phase."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import vote_api as va
    from repro_torch.core import vote_plan as vp

    shapes = {k: tuple(v.shape[1:]) for k, v in momentum.items()}
    layout = vp.build_plan(shapes, bucket_bytes=PLAN_BUCKET_BYTES,
                           strategy=VoteStrategy.ALLGATHER_1BIT)
    n_total = layout.n_params
    torch.cuda.synchronize()
    signs = torch.empty((M_MAIN, n_total), dtype=torch.int8, device=dev)
    for r in range(M_MAIN):
        for slot in layout.leaves:
            vp.write_signs(slot, momentum[slot.name][r], signs[r])
    def copy_buckets(plan):
        for b in plan.buckets:
            signs[:, b.start:b.start + b.length].contiguous()

    # the per-bucket copies that remain (a bucket's columns are strided):
    # ternary_pack's buckets and fused_majority's (plan_vote_stacked);
    # bitpack reads a 1-bit bucket in place
    ternary = vp.build_plan(shapes, bucket_bytes=PLAN_BUCKET_BYTES,
                            strategy=VoteStrategy.ALLGATHER_1BIT,
                            default_codec="ternary2bit", data_size=M_MAIN)
    _, ternary_ms, _, _ = timed(torch, lambda: copy_buckets(ternary))
    _, fused_ms, _, _ = timed(torch, lambda: copy_buckets(layout))
    copy_bound, _ = bound(2 * M_MAIN * n_total, 0)
    log({"phase": "plan_bucket_copy", "ternary_buckets": ternary.n_buckets,
         "ternary_ms": ternary_ms, "fused_majority_buckets": layout.n_buckets,
         "fused_majority_ms": fused_ms, "bound_ms_each": copy_bound})
    backend = va.VirtualBackend(device=dev)
    totals, staged = {}, None
    for label, strategy, codec, leafwise in PLAN_WIRES:
        plan = vp.build_plan(shapes, bucket_bytes=PLAN_BUCKET_BYTES,
                             strategy=VoteStrategy(strategy),
                             default_codec=codec, data_size=M_MAIN)
        if plan.leaves != layout.leaves:
            raise AssertionError(f"{label}: the plan's layout moved")
        check_bucket_count(plan, n_total, PLAN_BUCKET_BYTES)
        want = plan_launches(plan)
        state = plan.init_server_state(M_MAIN, dev) or None
        outs = {}
        for overlap in (False, True):
            req = va.VoteRequest(payload=signs, form="stacked", plan=plan,
                                 server_state=state, overlap=overlap)
            out, ms, launches, above = timed(torch,
                                             lambda: backend.execute(req))
            if launches != want:
                raise AssertionError(f"{label} overlap={overlap}: launches "
                                     f"{launches}, expected {want}")
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            wire = out.wire
            if (wire.n_messages != plan.n_buckets or wire.n_voters != M_MAIN
                    or wire.strategy.value != strategy):
                raise AssertionError(f"{label}: {wire}")
            outs[overlap] = out
            line = {"phase": "plan_vote", "wire": label, "codec": codec,
                    "strategy": strategy, "overlap": overlap,
                    "buckets": plan.n_buckets, "coords": n_total, "ms": ms,
                    "launches": launches,
                    "payload_bytes": wire.payload_bytes,
                    "above_resident_bytes": above}
            if "flip_ema" in out.server_state:
                line["flip_ema"] = out.server_state["flip_ema"].tolist()
            log(line)
        require_equal(f"{label}: overlap against sync votes",
                      outs[True].votes, outs[False].votes)
        for k in outs[False].server_state:
            require_equal(f"{label}: overlap against sync {k}",
                          outs[True].server_state[k],
                          outs[False].server_state[k])
        if leafwise is not None:
            _, _, ls, lc, _, _ = next(w for w in VOTE_WIRES
                                      if w[0] == leafwise)
            for slot in plan.leaves:
                want_votes = backend.execute(va.VoteRequest(
                    payload=momentum[slot.name].view(M_MAIN, -1),
                    form="stacked", strategy=VoteStrategy(ls),
                    codec=lc)).votes
                require_equal(f"{label} against the leaf-wise {leafwise} "
                              f"votes of {slot.name}",
                              outs[False].votes[slot.offset:slot.offset
                                                + slot.length], want_votes)
        else:
            ema = outs[False].server_state["flip_ema"]
            if not (torch.isfinite(ema).all() and (ema >= 0).all()
                    and (ema <= 1).all()):
                raise AssertionError(f"{label}: flip_ema {ema.tolist()}")
        if label == "plan_staged_allgather_1bit":
            staged = outs[False].votes
        del outs
    for bucket_bytes in (PLAN_BUCKET_BYTES, PLAN_SMALL_BUCKET_BYTES):
        plan = vp.build_plan(shapes, bucket_bytes=bucket_bytes,
                             strategy=VoteStrategy.ALLGATHER_1BIT)
        check_bucket_count(plan, n_total, bucket_bytes)
        votes, ms, launches, above = timed(
            torch, lambda: vp.plan_vote_stacked(plan, signs))
        want = {"fused_majority": plan.n_buckets,
                "bitunpack": plan.n_buckets}
        if launches != want:
            raise AssertionError(f"plan_vote_stacked {bucket_bytes}: "
                                 f"launches {launches}, expected {want}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        require_equal(f"plan_vote_stacked {bucket_bytes} against the staged "
                      "plan", votes, staged)
        log({"phase": "plan_vote_stacked", "bucket_bytes": bucket_bytes,
             "buckets": plan.n_buckets, "ms": ms, "launches": launches,
             "above_resident_bytes": above})
        del votes
    del signs, staged
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 8: the trainer's plan path
# ---------------------------------------------------------------------------

#: phase 8's runs: (label, optimizer options beside bucket_bytes, steps)
PLAN_RUNS = (
    ("plan", {}, STEPS),
    ("plan_overlap", {"overlap": True}, STEPS),
    ("plan_codec_map", {"codec_map": (("embed*", "ternary2bit"),)}, 2),
    ("plan_delayed", {"delayed_vote": True}, 2),
)


def plan_step_launches(plan, n_leaves: int) -> dict:
    """One plan step's launches: momentum_sign_pack without words per
    voter and leaf, the walk's per bucket, and per leaf the int8 vote's
    ternary_pack and apply_ternary_vote."""
    want = plan_launches(plan)
    want["momentum_sign_pack"] = M_MAIN * n_leaves
    for k in ("ternary_pack", "apply_ternary_vote"):
        want[k] = want.get(k, 0) + n_leaves
    return want


def run_plan_train_path(torch, cfg, dev, phase3_losses) -> dict:
    """Phase 8: phase 3's training (sign1bit on allgather_1bit) through a
    VotePlan of PLAN_BUCKET_BYTES, 5 steps from fresh state: exact launches
    per step, losses equal to phase 3's bit for bit; again with
    overlap=True; a codec map (the embedding on ternary2bit) for 2 steps
    with finite losses; delayed_vote for 2 steps, step 0 leaving every
    parameter as it was and step 1 applying exactly the int8 vote banked at
    step 0 (the plain versions recompute it). Peak memory per run and one
    profiled plan step. Returns the launches of the phase."""
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.core import sign_compress as sc
    from repro_torch.train import train_step as TS

    totals = {}
    for label, opts, steps in PLAN_RUNS:
        base = train_config("sign1bit")
        tcfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, bucket_bytes=PLAN_BUCKET_BYTES, **opts))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        want = plan_step_launches(art.plan, len(params))
        log({"phase": "plan_train_path", "run": label,
             "groups": [(g.codec, g.strategy.value, len(g.buckets))
                        for g in art.plan.groups],
             "vote_strategy": (art.vote_strategy.value
                               if art.vote_strategy else None),
             "state": sorted(opt_state), "launches_per_step": want})
        ops.reset_launch_counts()
        seen = ops.launch_counts()
        losses, step_ms, banked = [], [], None
        for step in range(steps):
            tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                     device=dev)
            if label == "plan_delayed":
                before = {k: p.clone() for k, p in params.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = art.step_fn(params, opt_state,
                                                 {"tokens": tokens}, step)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            per_step = {k: counts[k] - seen[k] for k in counts
                        if counts[k] != seen[k]}
            seen = counts
            loss = float(met["loss"])
            log({"plan_run": label, "step": step, "loss": loss, "ms": ms,
                 "launches": per_step})
            if per_step != want:
                raise AssertionError(f"{label} step {step}: launches "
                                     f"{per_step}, expected {want}")
            if not math.isfinite(loss):
                raise AssertionError(f"{label} step {step}: loss {loss}")
            losses.append(loss)
            step_ms.append(ms)
            if label == "plan_delayed":
                check_delayed_step(torch, ref, sc, signum, tcfg, step,
                                   before, params, opt_state, banked)
                banked = {k: v.clone()
                          for k, v in opt_state["delayed"].items()}
                del before
        launches = ops.launch_counts()   # read just after the run
        peak = torch.cuda.max_memory_allocated()
        if label in ("plan", "plan_overlap") and losses != phase3_losses:
            raise AssertionError(f"{label}: losses {losses} differ from the "
                                 f"leaf-wise phase 3's {phase3_losses}")
        median = statistics.median(step_ms[1:])
        log({"phase": "plan_train_path_done", "run": label,
             "losses": losses, "equal_to_phase3": losses == phase3_losses[
                 :len(losses)],
             "step_ms": step_ms, "step_ms_median_1_on": median,
             "max_memory_allocated_bytes": peak,
             "max_memory_allocated_GiB": peak / 2 ** 30})
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        if label == "plan":
            profile_step(torch, art, params, opt_state, pipe, dev,
                         cfg.param_count(), median, "plan")
        del params, opt_state, art, banked
        torch.cuda.empty_cache()
    return totals


def check_delayed_step(torch, ref, sc, signum, tcfg, step, before, params,
                       opt_state, banked) -> None:
    """delayed_vote: step 0 leaves every parameter bit-equal to its value
    before it (weight decay 0); step 1 applies exactly the int8 vote
    banked at step 0 (the plain ternary pack and apply, recomputed)."""
    eta = signum.lr_at(tcfg.optimizer, step)
    for k, p in params.items():
        if step == 0:
            require_equal(f"delayed step 0 {k}: parameters held", p,
                          before[k])
            continue
        flat = before[k].view(1, -1)
        words = ref.ternary_pack(sc.pad_last(banked[k].view(1, -1),
                                             sc.PACK2)[0])
        want = ref.apply_ternary_vote(sc.pad_to_pack(flat, sc.PACK2)[0],
                                      words, eta,
                                      tcfg.optimizer.weight_decay)
        require_equal(f"delayed step 1 {k}: the vote banked at step 0",
                      p.view(1, -1), want[:, :flat.shape[1]])
        del words, want
    log({"phase": "delayed_vote_check", "step": step, "ok": True})


# ---------------------------------------------------------------------------
# phase 9: signSGD (beta = 0) on the 1-bit and the count wire
# ---------------------------------------------------------------------------

#: phase 9's runs: (vote strategy, steps)
BETA0_RUNS = (("allgather_1bit", 3), ("psum_int8", 3))
#: the leaf whose step 0 phases 9 and 11 recompute from saved copies
UNEMBED = "unembed.table"


def beta0_launches(strategy: str, n_leaves: int) -> dict:
    """One beta = 0 step's launches: each voter's bf16 gradient row packed
    (bitpack on the 1-bit wire, ternary_pack on the count wire), one tally
    and one apply per leaf; no momentum kernel."""
    per_voter = M_MAIN * n_leaves
    if strategy == "allgather_1bit":
        return {"bitpack": per_voter, "majority": n_leaves,
                "apply_vote": n_leaves}
    return {"ternary_pack": per_voter, "ternary_majority": n_leaves,
            "apply_ternary_vote": n_leaves}


def run_steps(torch, label, art, params, opt_state, pipe, steps, want,
              leaf, on_step0=None) -> tuple:
    """`steps` steps of `art` from fresh state with exact launches per step
    (the counts reset just before the first, read just after the last) and
    finite losses. `on_step0(tokens)` runs before step 0 to save copies (by
    autograd alone: it launches no kernel of the port); after step 0 the
    parameters and optimizer state of `leaf` are cloned. Returns (launches
    of the run, losses, step ms, (on_step0's result, the leaf's parameters
    after step 0, its state after step 0))."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    seen = ops.launch_counts()
    saved, losses, step_ms = None, [], []
    for step in range(steps):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=art.device)
        if step == 0 and on_step0 is not None:
            saved = on_step0(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = art.step_fn(params, opt_state,
                                             {"tokens": tokens}, step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        per_step = {k: counts[k] - seen[k] for k in counts
                    if counts[k] != seen[k]}
        seen = counts
        loss = float(met["loss"])
        log({"run": label, "step": step, "loss": loss, "ms": ms,
             "launches": per_step})
        if not math.isfinite(loss):
            raise AssertionError(f"{label} step {step}: loss {loss}")
        if per_step != want:
            raise AssertionError(f"{label} step {step}: launches {per_step},"
                                 f" expected {want}")
        losses.append(loss)
        step_ms.append(ms)
        if step == 0:
            saved = (saved, params[leaf].clone(),
                     {k: v[leaf].clone() for k, v in opt_state.items()
                      if isinstance(v, dict) and leaf in v})
    return ops.launch_counts(), losses, step_ms, saved


def run_signsgd_path(torch, cfg, dev) -> dict:
    """Phase 9: signSGD (beta = 0) at phase 3's size on allgather_1bit and
    psum_int8, 3 steps each from fresh state: exact launches per step (each
    voter's bf16 gradient row through bitpack or ternary_pack, one tally and
    one apply per leaf), finite losses, and step 0 of the unembedding
    bit-equal to the plain versions recomputed from saved copies of its
    parameters and gradients. Returns the launches (bf16 bitpack counted
    apart as "bitpack_bf16")."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    totals = {}
    for strategy, steps in BETA0_RUNS:
        label = f"signsgd_{strategy}"
        base = train_config("sign1bit")
        tcfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, kind="signsgd_vote", momentum=0.0,
            vote_strategy=VoteStrategy(strategy)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        per = GLOBAL_BATCH // M_MAIN
        want = beta0_launches(strategy, len(params))
        log({"phase": "signsgd_path", "strategy": strategy,
             "state": sorted(opt_state), "launches_per_step": want})

        def save(tokens):
            return (params[UNEMBED].clone(),
                    leaf_grads(torch, M, cfg, params, tokens, per, UNEMBED))
        launches, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, steps, want, UNEMBED,
            save)
        peak = torch.cuda.max_memory_allocated()
        (p0, g0), p1, _ = saved
        if g0[0].dtype != torch.bfloat16:
            raise AssertionError(f"{label}: gradients {g0[0].dtype}")
        eta = signum.lr_at(tcfg.optimizer, 0)
        wd = tcfg.optimizer.weight_decay
        rows = [g.reshape(1, -1) for g in g0]
        if strategy == "allgather_1bit":
            words = torch.stack([ref.bitpack(r)[0] for r in rows])
            p_ref = ref.apply_vote(p0.view(1, -1), ref.majority(words)[None],
                                   eta, wd)
        else:
            words = torch.stack([ref.ternary_pack(r)[0] for r in rows])
            p_ref = ref.apply_ternary_vote(
                p0.view(1, -1), ref.ternary_majority(words)[None], eta, wd)
        require_equal(f"{label} step 0 of {UNEMBED}", p1.view(1, -1), p_ref)
        log({"phase": "step0_bit_equal", "run": label, "leaf": UNEMBED,
             "coords": p0.numel(), "ok": True})
        del p0, g0, p1, rows, words, p_ref, saved
        log({"phase": "signsgd_path_done", "strategy": strategy,
             "losses": losses, "step_ms": step_ms,
             "step_ms_median_1_on": statistics.median(step_ms[1:]),
             "max_memory_allocated_bytes": peak})
        for k, v in launches.items():
            if v:
                key = ("bitpack_bf16" if k == "bitpack" else k)
                totals[key] = totals.get(key, 0) + v
        del params, opt_state, art
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 10: the qwen1.5-32b Mode B preset at full width
# ---------------------------------------------------------------------------

#: phase 10's runs: (vote strategy, steps); the first is the preset's own
MODE_B_RUNS = (("hierarchical", STEPS), ("psum_int8", 2),
               ("allgather_1bit", 2))
#: the Mode B preset's leaf whose step 0 is recomputed from saved copies
MODE_B_LEAF = "layers.attn_wq"


def mode_b_launches(strategy: str, n_leaves: int) -> dict:
    """One Mode B step's launches (beta > 0): each voter's bf16 gradient
    row packed (bitpack or ternary_pack); per leaf the tally, the vote
    unpacked to bf16, the momentum kernel (no words), ternary_pack of u
    and apply_ternary_vote."""
    per_voter = M_MAIN * n_leaves
    if strategy == "allgather_1bit":
        want = {"bitpack": per_voter, "majority": n_leaves,
                "bitunpack": n_leaves, "ternary_pack": n_leaves}
    else:
        tally = ("ternary_majority_plus_one" if strategy == "hierarchical"
                 else "ternary_majority")
        want = {"ternary_pack": per_voter + n_leaves, tally: n_leaves,
                "ternary_unpack": n_leaves}
    return {**want, "momentum_sign_pack": n_leaves,
            "apply_ternary_vote": n_leaves}


def run_mode_b_path(torch, dev) -> dict:
    """Phase 10: the reference's qwen1.5-32b training configuration,
    ``make_train_step(cfg, dataclasses.replace(default_train_config(
    "qwen1.5-32b", cell), fsdp=False), 4)`` at every published width,
    depth cut 64 -> 2, cell (seq 512, batch 32): signsgd_vote, one global
    float32 momentum at beta 0.9, hierarchical, 8 microbatches, nested
    remat. Five steps on hierarchical, then 2 each on psum_int8 and
    allgather_1bit, each from fresh state: exact launches, finite losses;
    on hierarchical step 0 of MODE_B_LEAF (its momentum and parameters)
    bit-equal to the plain versions recomputed from saved copies, and its
    vote bit-equal to the port's VirtualBackend hierarchical vote of the
    same gradients; the median step, the peak memory and one profiled
    step. Returns the launches (bf16 bitpack counted apart)."""
    from repro_torch.configs.base import (MomentumMode, ShapeCell,
                                          VoteStrategy, get_config)
    from repro_torch.configs.presets import default_train_config
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import signum
    from repro_torch.core import vote_api as va
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config("qwen1.5-32b"), num_layers=2)
    cell = ShapeCell("train_smoke", PRESET_SEQ, PRESET_BATCH, "train")
    preset = default_train_config("qwen1.5-32b", cell)
    opt = preset.optimizer
    if (opt.kind, opt.momentum_mode, opt.vote_strategy, opt.momentum,
            opt.momentum_dtype, preset.microbatches, preset.remat,
            preset.fsdp) != ("signsgd_vote", MomentumMode.GLOBAL,
                             VoteStrategy.HIERARCHICAL, 0.9, "float32", 8,
                             "nested", True):
        raise AssertionError(f"not the qwen1.5-32b Mode B preset: {preset}")
    n_params = cfg.param_count()
    totals = {}
    for strategy, steps in MODE_B_RUNS:
        label = f"mode_b_{strategy}"
        # fsdp is cut: with a mesh its fused ZeRO backward votes inside the
        # reduce-scatter, which waits for the multi-process wire
        tcfg = dataclasses.replace(preset, fsdp=False,
                                   optimizer=dataclasses.replace(
                                       opt, vote_strategy=VoteStrategy(
                                           strategy)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        if any(u.shape != params[k].shape or u.dtype != torch.float32
               for k, u in opt_state["momentum"].items()):
            raise AssertionError("Mode B's momentum is not one leaf-shaped "
                                 "float32 tensor per leaf")
        pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, tcfg.seq_len,
                                   seed=0)
        want = mode_b_launches(strategy, len(params))
        log({"phase": "mode_b_path", "arch": cfg.name, "strategy": strategy,
             "num_layers": cfg.num_layers, "d_model": cfg.d_model,
             "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
             "voters": M_MAIN, "global_batch": tcfg.global_batch,
             "seq": tcfg.seq_len, "microbatches": tcfg.microbatches,
             "remat": tcfg.remat, "fsdp": "cut: True -> False",
             "kind": opt.kind, "momentum_mode": opt.momentum_mode.value,
             "beta": opt.momentum, "lr": opt.learning_rate,
             "state": sorted(opt_state), "launches_per_step": want,
             "resident_before_bytes": resident})
        check = strategy == "hierarchical"

        def save(tokens):
            if not check:
                return None
            return (params[MODE_B_LEAF].clone(),
                    preset_leaf_grads(torch, M, cfg, tcfg, params,
                                      {"tokens": tokens}, MODE_B_LEAF))
        launches, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, steps, want,
            MODE_B_LEAF, save)
        peak = torch.cuda.max_memory_allocated()
        median = statistics.median(step_ms[1:])
        log({"phase": "mode_b_path_done", "strategy": strategy,
             "losses": losses, "step_ms": step_ms,
             "step_ms_median_1_on": median,
             "max_memory_allocated_bytes": peak,
             "max_memory_allocated_GiB": peak / 2 ** 30})
        if peak >= 80e9:
            raise AssertionError(f"{label}: peak {peak} B")
        for k, v in launches.items():
            if v:
                key = ("bitpack_bf16" if k == "bitpack" else k)
                totals[key] = totals.get(key, 0) + v
        if check:
            (p0, g0), p1, s1 = saved
            eta = signum.lr_at(tcfg.optimizer, 0)
            wd = tcfg.optimizer.weight_decay
            words = torch.stack([ref.ternary_pack(g.reshape(1, -1))[0]
                                 for g in g0])
            vote = ref.ternary_unpack(ref.ternary_majority(
                words, "plus_one")[None], torch.bfloat16)[0, :p0.numel()]
            u_ref, _ = ref.momentum_sign_pack(
                vote.view(1, -1), torch.zeros((1, p0.numel()),
                                              dtype=torch.float32,
                                              device=dev), opt.momentum)
            require_equal(f"{label} step 0 momentum of {MODE_B_LEAF}",
                          s1["momentum"].view(1, -1).view(torch.int32),
                          u_ref.view(torch.int32))
            p_ref = ref.apply_ternary_vote(p0.view(1, -1),
                                           ref.ternary_pack(u_ref), eta, wd)
            require_equal(f"{label} step 0 of {MODE_B_LEAF}",
                          p1.view(1, -1), p_ref)
            # the trainer's vote (at step 0 u = (1 - beta) * vote) against
            # the vote API's hierarchical wire on the same gradients
            api = va.VirtualBackend(device=dev).execute(va.VoteRequest(
                payload=torch.stack([g.reshape(-1) for g in g0]),
                form="stacked", strategy=VoteStrategy.HIERARCHICAL))
            require_equal(f"{label} step 0 vote against the vote API",
                          sc.sign_ternary(s1["momentum"].view(-1)),
                          api.votes)
            log({"phase": "step0_bit_equal", "run": label,
                 "leaf": MODE_B_LEAF, "coords": p0.numel(),
                 "vote_api_equal": True, "ok": True})
            del p0, g0, p1, s1, words, vote, u_ref, p_ref, api
        del params, opt_state, art, saved
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 11: the dense baselines
# ---------------------------------------------------------------------------

DENSE_KINDS = ("sgd", "sgdm", "adam")
DENSE_STEPS = 3


def mean_bound(g64):
    """The rounding bound of a bf16 sum of the (M, ...) gradients in any
    order, then divided by M (exact: a power of two): M - 1 roundings of
    partial sums, each at most bf16's unit roundoff 2^-8 times a partial
    sum, itself at most sum|g|; 2 % on top for the second-order terms."""
    m = g64.shape[0]
    return 1.02 * (m - 1) * 2.0 ** -8 * g64.abs().sum(0) / m


def check_sqrt(torch, dev) -> None:
    """PyTorch's float32 sqrt on the card against the float64 root rounded
    to float32, bit for bit, on 2^24 values from 0 to 1000 (Adam's root
    must be the nearest float32, as XLA's is; on the CPU PyTorch's is not,
    so the port's CPU path rounds the float64 root)."""
    x = torch.rand(1 << 24, generator=torch.Generator(device=dev)
                   .manual_seed(5), device=dev) * 1e3
    require_equal("float32 sqrt on the card is the nearest float32",
                  x.sqrt().view(torch.int32),
                  x.double().sqrt().float().view(torch.int32))
    log({"phase": "sqrt_nearest", "values": x.numel(), "ok": True})


def run_dense_path(torch, cfg, dev) -> None:
    """Phase 11: the dense baselines (sgd, sgdm, adam; the voters' mean
    gradient, a float32 update) at phase 3's size, 3 steps each from fresh
    state: no kernel launch, finite losses, the median step and the peak
    memory; for sgdm and adam the mean gradient of the unembedding at step
    0 (sgdm's m is the mean itself, adam's (1 - beta1) times it) within
    :func:`mean_bound` of a float64 sum of the four voters' gradients, and
    (sgdm) bit-equal to the bf16 sum in the port's order. Also
    PyTorch's float32 sqrt on the card against the float64 root rounded
    (the Adam update relies on it rounding to nearest)."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    check_sqrt(torch, dev)
    for kind in DENSE_KINDS:
        label = f"dense_{kind}"
        base = train_config("sign1bit")
        tcfg = dataclasses.replace(base, optimizer=dataclasses.replace(
            base.optimizer, kind=kind))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        per = GLOBAL_BATCH // M_MAIN
        log({"phase": "dense_path", "kind": kind, "state": sorted(opt_state),
             "beta1": tcfg.optimizer.momentum, "lr": tcfg.optimizer
             .learning_rate})

        def save(tokens):
            return leaf_grads(torch, M, cfg, params, tokens, per, UNEMBED)
        _, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, DENSE_STEPS, {},
            UNEMBED, save)
        peak = torch.cuda.max_memory_allocated()
        del params, opt_state, art
        torch.cuda.empty_cache()
        g0, _, s1 = saved
        line = {"phase": "dense_path_done", "kind": kind, "losses": losses,
                "step_ms": step_ms,
                "step_ms_median_1_on": statistics.median(step_ms[1:]),
                "max_memory_allocated_bytes": peak,
                "max_memory_allocated_GiB": peak / 2 ** 30}
        if kind != "sgd":
            line.update(check_dense_mean(torch, kind, tcfg, g0, s1["m"]))
        log(line)
        del saved, g0, s1
        torch.cuda.empty_cache()


#: elements of the unembedding checked at a time in float64 (2 GB a chunk)
MEAN_CHUNK = 1 << 26


def check_dense_mean(torch, kind, tcfg, g0, m1) -> dict:
    """Step 0's mean gradient of the unembedding in the dense state `m1`
    (sgdm: m = the mean; adam: m = (1 - beta1) * mean, one more float32
    rounding) against a float64 sum of the voters' saved gradients `g0`,
    within :func:`mean_bound`; for sgdm also bit-equal to the bf16 sum in
    the port's order. Chunked, so the float64 copies stay at 2 GB."""
    total = g0[0].clone()
    for g in g0[1:]:
        total.add_(g)
    mean = total.div_(M_MAIN).float().view(-1)
    del total
    m1 = m1.view(-1)
    if kind == "sgdm":   # m = 0.9 * 0 + mean: the mean itself
        require_equal(f"dense_{kind} step 0 mean of {UNEMBED}", m1, mean)
    scale = 1.0 if kind == "sgdm" else 1 - tcfg.optimizer.momentum
    worst = slack_max = 0.0
    for start in range(0, mean.numel(), MEAN_CHUNK):
        part = slice(start, start + MEAN_CHUNK)
        g64 = torch.stack([g.view(-1)[part].double() for g in g0])
        want = g64.sum(0) / M_MAIN
        slack = mean_bound(g64)
        if kind == "adam":   # m / (1 - beta1): two float32 roundings
            slack += want.abs() * 2.0 ** -22
        err = (m1[part].double() / scale - want).abs()
        if (err > slack).any():
            raise AssertionError(
                f"dense_{kind}: mean gradient off a float64 sum by "
                f"{float(err.max())} (bound {float(slack.max())})")
        worst = max(worst, float(err.max()))
        slack_max = max(slack_max, float(slack.max()))
        del g64, want, slack, err
    return {"mean_grad_max_abs_err_vs_f64": worst,
            "mean_grad_bound_max": slack_max}


# ---------------------------------------------------------------------------
# phase 12: failure drills (Byzantine adversaries, stale votes, elastic
# refit) through the vote API, the trainer and checkpoints
# ---------------------------------------------------------------------------

#: the adversary kernel's checks: windows of the unembedding row (start,
#: length) at its start, its middle and its ragged tail, then counter
#: offsets past 2^31 and across the 2^32 boundary (the counter's high word)
ADV_WINDOW = 1 << 24
ADV_WINDOWS = ((0, ADV_WINDOW), (N_UNEMBED // 2 - 7, ADV_WINDOW),
               (N_UNEMBED - (ADV_WINDOW - 5), ADV_WINDOW - 5),
               (2 ** 31 + 3, ADV_WINDOW), (2 ** 32 - ADV_WINDOW // 2,
                                            ADV_WINDOW))
#: (mode, p): the stochastic modes, blind at the drills' and the trainer's
#: flip probabilities and at both ends
ADV_CASES = (("random", 0.5), ("colluding", 0.5), ("blind", 0.9),
             ("blind", 0.5), ("blind", 0.0), ("blind", 1.0))
#: 32-bit integer operations an element of the adversary kernel, counted
#: from its source: 20 rounds of add, funnel shift and xor (60), five key
#: injections of two adds (10), the first two adds, the final xor, the
#: 64-bit counter (2), the shift, compare and select (3) and the flip (1)
ADV_INT_OPS = 79
#: 32-bit integer operations a thread the counter map needs: its first
#: local index's quotient by the run as a multiply-high by a reciprocal
#: the host computes, and a shift (2), the remainder and the columns left
#: (3), the 64-bit base offset + l + q * gap (a wide multiply and two
#: 64-bit adds: 6) and the one-run test (1); 0.75 an element over the
#: thread's 16 columns. The kernel's software division (about 20 more, the
#: card has no integer divide) is what its design spends, not what the map
#: needs, so the bound leaves it out
ADV_MAP_OPS = 12
#: 32-bit integer operations an element of a thread whose 16 columns cross
#: a run's end (the step, its test and the gap's add), counted on the
#: layout's share of such threads (:func:`map_straddle_share`)
ADV_CARRY_OPS = 3
#: the map's timed layout: the (4, n) stack drawn as model rank 1's block
#: of a (151,552, 8,192) leaf cut in two along its columns (runs of 4,096)
ADV_MAP_RUN = 4096
#: the card's peak rate of 32-bit integer operations: one a lane a clock on
#: all 128 lanes of an SM (its four schedulers each issue one warp
#: instruction a clock; integer adds go to the FMA pipe beside the 64 INT32
#: lanes), half of FP32_OPS_PER_S, which counts an FMA as two. The 64 INT32
#: lanes alone (16.75e12 a second) are no bound: the kernel beat that rate
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
#: the trainer's failure runs (phase 3's cell): (mode, strategy,
#: adversaries, flip_prob, steps)
BYZ_RUNS = (("sign_flip", "allgather_1bit", 1, 0.5, 3),
            ("random", "allgather_1bit", 1, 0.5, 3),
            ("blind", "psum_int8", 1, 0.9, 2))
#: the leaf whose step 0 each failure run recomputes with the plain versions
BYZ_LEAF = "layers.attn_wq"
#: the reference's golden drill (tests/tier2/test_scenario_lab.py:159-162)
GOLDEN = {"name": "golden/fixed", "n_workers": 16, "n_steps": 10, "dim": 64,
          "strategy": "allgather_1bit",
          "adversary": {"mode": "sign_flip", "fraction": 0.25},
          "straggler_fraction": 0.125, "noise_scale": 0.0}


def check_adversary(torch, ops, ref, dev, err) -> int:
    """Phase 12a: the adversary kernel bit for bit against its plain version
    on (4, L) int8 signs of {-1, 0, +1}: every stochastic mode at the
    windows of ADV_WINDOWS (each drawing at its global counter), each
    voter's own key (one shared key for colluding), in place on a
    contiguous stack and on a view one byte off a 16-byte boundary whose
    rows are L + 17 bytes apart, the bytes around the view unchanged."""
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import byzantine
    gen = torch.Generator(device=dev).manual_seed(12)
    n_checks = 0
    for start, length in ADV_WINDOWS:
        x = torch.randint(-1, 2, (M_MAIN, length), generator=gen,
                          device=dev, dtype=torch.int8)
        buf = torch.randint(-1, 2, (M_MAIN, length + 17), generator=gen,
                            device=dev, dtype=torch.int8)
        for mode, p in ADV_CASES:
            cfg = ByzantineConfig(mode=mode, num_adversaries=M_MAIN,
                                  seed=2 ** 31 - 3, flip_prob=p)
            keys = [byzantine.adversary_key(
                cfg, None if mode == "colluding" else r, step=7,
                salt=2 ** 31 - 1) for r in range(M_MAIN)]
            want = ref.adversary(x, keys, p, mode == "blind", start)
            got = ops.adversary_(x.clone(), keys, p, mode == "blind", start)
            e = require_equal(f"adversary {mode} p={p} at {start}+{length}",
                              got, want)
            view = buf[:, 1:1 + length]
            around = buf.clone()
            view.copy_(x)
            ops.adversary_(view, keys, p, mode == "blind", start)
            e = max(e, require_equal(
                f"adversary {mode} p={p} at {start} off 16 bytes", view,
                want))
            around[:, 1:1 + length] = want
            require_equal(f"adversary {mode} at {start}: bytes around the "
                          "view", buf, around)
            err["adversary"] = max(err["adversary"], e)
            n_checks += 2
            del want, got, around
        del x, buf
    torch.cuda.synchronize()
    log({"phase": "adversary_vs_plain", "checks": n_checks,
         "windows": ADV_WINDOWS, "max_abs_err": err["adversary"]})
    return n_checks


def map_straddle_share(block: int, per: int = 16) -> float:
    """The share of the adversary kernel's threads (`per` columns each,
    from local index 0) whose columns cross the end of a run of `block`."""
    period = block // math.gcd(block, per)
    return sum(1 for t in range(period)
               if (t * per) % block > block - per) / period


def time_adversary(torch, ops, ref, dev, launches, errs) -> dict:
    """Phase 12a's row: the adversary kernel on the whole (4, n) unembedding
    stack, median of 25 CUDA-event runs, blind (flip_prob 0.9: each sign
    read and written) as the row and random (written only) beside it."""
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import byzantine
    gen = torch.Generator(device=dev).manual_seed(13)
    n = N_UNEMBED
    x = torch.randint(-1, 2, (M_MAIN, n), generator=gen, device=dev,
                      dtype=torch.int8)
    cfg = ByzantineConfig(mode="blind", num_adversaries=M_MAIN, seed=0,
                          flip_prob=0.9)
    keys = [byzantine.adversary_key(cfg, r, step=1) for r in range(M_MAIN)]
    ms = median_ms(torch, lambda: ops.adversary_(x, keys, 0.9, True),
                   reps=25)
    random_ms = median_ms(torch, lambda: ops.adversary_(x, keys, 0.5, False),
                          reps=25)
    cut = {"block": ADV_MAP_RUN, "gap": ADV_MAP_RUN}
    map_ms = median_ms(torch, lambda: ops.adversary_(
        x, keys, 0.9, True, ADV_MAP_RUN, **cut), reps=25)
    map_random_ms = median_ms(torch, lambda: ops.adversary_(
        x, keys, 0.5, False, ADV_MAP_RUN, **cut), reps=25)
    # the uncut launch again, after the map's: the two in turns
    ms_after = median_ms(torch, lambda: ops.adversary_(x, keys, 0.9, True),
                         reps=25)
    plain = median_ms(torch, lambda: ref.adversary(x, keys, 0.9, True),
                      reps=1, warmup=0)
    del x
    torch.cuda.empty_cache()
    t_bytes = 2 * M_MAIN * n / HBM_BYTES_PER_S * 1e3
    t_ops = ADV_INT_OPS * M_MAIN * n / INT32_OPS_PER_S * 1e3
    map_per_element = (ADV_INT_OPS + ADV_MAP_OPS / 16 + ADV_CARRY_OPS
                       * map_straddle_share(ADV_MAP_RUN))
    map_ops = map_per_element * M_MAIN * n / INT32_OPS_PER_S * 1e3
    b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {"name": "adversary", "route": "cuda",
            "source": SOURCE + "byzantine.cu",
            "replaces": "src/repro/core/byzantine.py:81-121 (jnp "
                        "jax.random.bernoulli draws, no pallas_call)",
            "launches": launches["adversary"],
            "max_abs_err": errs["adversary"], "max_diff": errs["adversary"],
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None,
            "excess_ms": launches["adversary"] * (ms - b),
            "shape": {"n": n, "voters": M_MAIN}, "mode": "blind, p 0.9",
            "random_ms": random_ms, "bytes_bound_ms": t_bytes,
            "ops_bound_ms": t_ops, "int_ops_per_element": ADV_INT_OPS,
            "uncut_ms_after_map": ms_after,
            "map": {"layout": f"model rank 1's block of a (151552, "
                              f"{2 * n // 151552}) leaf cut in two along "
                              f"its columns (runs of {ADV_MAP_RUN})",
                    "ms": map_ms, "random_ms": map_random_ms,
                    "over_uncut_ms": map_ms - ms,
                    "bound_ms": max(t_bytes, map_ops),
                    "bound_by": "bytes" if t_bytes >= map_ops
                    else "operations",
                    "int_ops_per_element": map_per_element,
                    "launches": launches.get("adversary_map", 0)}}


def drill_specs():
    """GOLDEN and the reference's non-adaptive presets (phase 12b)."""
    from repro_torch.sim import ScenarioSpec, preset_scenarios
    return [ScenarioSpec.from_dict(GOLDEN)] + [
        s for s in preset_scenarios() if not s.adversary.adaptive]


def run_drills(torch, dev) -> dict:
    """Phase 12b: GOLDEN and the 7 non-adaptive presets on the card, each
    digest equal to the port's CPU run of the same spec and draws; then the
    paper's Fig. 4 surface (``fig4_grid()``: 51 drills, 16 voters, 25 steps,
    dim 512) on the card. Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.sim import ScenarioRunner, fig4_grid
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for spec in drill_specs():
        tc = time.perf_counter()
        card = ScenarioRunner(spec, device=dev).run()
        tc = time.perf_counter() - tc
        cpu = ScenarioRunner(spec, device="cpu").run()
        if card.digest != cpu.digest:
            raise AssertionError(f"drill {spec.name}: card digest "
                                 f"{card.digest} != CPU {cpu.digest}")
        s = card.summary()
        log({"drill": spec.name, "digest": card.digest, "cpu_equal": True,
             "final_loss": s["final_loss"],
             "mean_flip_fraction": s["mean_flip_fraction"],
             "mean_margin": s["mean_margin"], "card_s": tc})
    t1 = time.perf_counter()
    surface = []
    for spec in fig4_grid():
        s = ScenarioRunner(spec, device=dev).run().summary()
        surface.append({"drill": spec.name,
                        "mode": spec.adversary.mode,
                        "fraction": spec.adversary.fraction,
                        "strategy": spec.strategy.value,
                        "mean_flip_fraction": s["mean_flip_fraction"],
                        "final_loss": s["final_loss"],
                        "digest": s["digest"]})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if not launches["adversary"]:
        raise AssertionError("the drills never launched the adversary kernel")
    log({"phase": "fig4_surface", "drills": len(surface), "rows": surface})
    log({"phase": "drills_done", "presets_s": t1 - t0,
         "fig4_s": time.perf_counter() - t1, "launches": launches})
    return launches


def byz_launches(mode: str, strategy: str, n_leaves: int) -> dict:
    """One step's launches with voter 0 adversarial: the honest voters'
    encode as phase 3's (or the count wire's), the adversary's m' without
    words, then its int8 symbols packed (and, for a stochastic mode, one
    adversary launch a leaf)."""
    honest = M_MAIN - 1
    want = {"momentum_sign_pack": M_MAIN * n_leaves}
    if strategy == "allgather_1bit":
        want.update({"bitpack": n_leaves, "majority": n_leaves,
                     "apply_vote": n_leaves})
    else:
        want.update({"ternary_pack": (honest + 1) * n_leaves,
                     "ternary_majority": n_leaves,
                     "apply_ternary_vote": n_leaves})
    if mode in ("random", "colluding", "blind"):
        want["adversary"] = n_leaves
    return want


def run_byzantine_train_path(torch, cfg, dev) -> dict:
    """Phase 12c: phase 3's cell (M = 4, batch 8, seq 512) with voter 0
    adversarial: sign_flip and random on allgather_1bit for 3 steps, blind
    (flip_prob 0.9) on psum_int8 for 2, each from fresh state: exact
    launches per step, finite losses, step 0 of BYZ_LEAF bit-equal to the
    plain versions recomputed from saved copies (the adversary's symbols
    drawn by the plain adversary under the same key), the median step and
    the peak memory. Returns the launches."""
    from repro_torch.configs.base import ByzantineConfig, VoteStrategy
    from repro_torch.core import byzantine, signum
    from repro_torch.core import sign_compress as sc
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    totals = {}
    for mode, strategy, n_adv, p, steps in BYZ_RUNS:
        label = f"byzantine_{mode}_{strategy}"
        base = train_config("sign1bit")
        byz = ByzantineConfig(mode=mode, num_adversaries=n_adv, seed=0,
                              flip_prob=p)
        tcfg = dataclasses.replace(
            base, byzantine=byz, optimizer=dataclasses.replace(
                base.optimizer, vote_strategy=VoteStrategy(strategy)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, opt_state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        per = GLOBAL_BATCH // M_MAIN
        want = byz_launches(mode, strategy, len(params))

        def save(tokens):
            return (params[BYZ_LEAF].clone(),
                    leaf_grads(torch, M, cfg, params, tokens, per, BYZ_LEAF))
        launches, losses, step_ms, saved = run_steps(
            torch, label, art, params, opt_state, pipe, steps, want,
            BYZ_LEAF, save)
        peak = torch.cuda.max_memory_allocated()
        (p0, g0), p1, _ = saved
        eta = signum.lr_at(tcfg.optimizer, 0)
        wd = tcfg.optimizer.weight_decay
        two_bit = strategy != "allgather_1bit"
        words = []
        for r, g in enumerate(g0):
            m_ref, bits = ref.momentum_sign_pack(
                g.reshape(1, -1), torch.zeros(g.shape, dtype=torch.float32,
                                              device=dev).view(1, -1), BETA)
            s = sc.sign_ternary(m_ref)
            if r < n_adv:
                if mode == "sign_flip":
                    s = -s
                else:
                    key = byzantine.adversary_key(byz, r, step=0)
                    s = ref.adversary(s, [key], p, mode == "blind")
            words.append((ref.ternary_pack(s) if two_bit
                          else ref.bitpack(s))[0])
        words = torch.stack(words)
        if two_bit:
            p_ref = ref.apply_ternary_vote(
                p0.view(1, -1), ref.ternary_majority(words)[None], eta, wd)
        else:
            p_ref = ref.apply_vote(p0.view(1, -1), ref.majority(words)[None],
                                   eta, wd)
        require_equal(f"{label} step 0 of {BYZ_LEAF}", p1.view(1, -1), p_ref)
        log({"phase": "step0_bit_equal", "run": label, "leaf": BYZ_LEAF,
             "coords": p0.numel(), "ok": True})
        del p0, g0, p1, words, p_ref, saved
        log({"phase": "byzantine_train_done", "run": label,
             "losses": losses, "step_ms": step_ms,
             "step_ms_median_1_on": statistics.median(step_ms[1:]),
             "adversary_launches": launches["adversary"],
             "max_memory_allocated_bytes": peak})
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        del params, opt_state, art
        torch.cuda.empty_cache()
    return totals


def check_checkpoints(torch, cfg, dev) -> None:
    """Phase 12d: checkpoints on the card. The elastic preset's per-worker
    state (8 voters: momentum, residual and stale signs of dim 256, the
    flip-rate EMA) saved, restored bit-equal, and refit to its elastic
    events' 4 and 6 voters (survivors bit-equal, joiners zero); a narrow
    trainer's state (2 layers of width 256, M = 4, bf16 momentum, one
    step) saved and restored bit-equal (dtypes and the step count too)."""
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import (OptimizerConfig, TrainConfig,
                                          VoteStrategy)
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.sim import preset_scenarios
    from repro_torch.train import train_step as TS

    spec = next(s for s in preset_scenarios() if s.elastic)
    gen = torch.Generator(device=dev).manual_seed(14)
    m0, d = spec.n_workers, spec.dim
    state = {"momentum": torch.randn(m0, d, generator=gen, device=dev),
             "error": torch.randn(m0, d, generator=gen, device=dev),
             "prev": torch.randint(-1, 2, (m0, d), generator=gen, device=dev,
                                   dtype=torch.int8),
             "codec": {"flip_ema": torch.rand(m0, generator=gen,
                                              device=dev)}}

    def walk(a, b, what):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{what}/{k}")
        elif isinstance(a, torch.Tensor):
            if b.device != a.device:
                raise AssertionError(f"{what}: restored on {b.device}")
            require_equal(what, b, a)
        elif int(b) != a:
            raise AssertionError(f"{what}: {int(b)} != {a}")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 1, {}, state)
        _, back, _, _ = ckpt.restore(tmp, device=dev)
        walk(state, back, "elastic state")
        for ev in spec.elastic:
            like = {"momentum": (ev.n_workers, d), "error": (ev.n_workers, d),
                    "prev": (ev.n_workers, d),
                    "codec": {"flip_ema": (ev.n_workers,)}}
            _, fit, _, _ = ckpt.restore(tmp, like_opt=like, device=dev)
            keep = min(ev.n_workers, m0)
            for k in ("momentum", "error", "prev"):
                require_equal(f"refit {k} to {ev.n_workers}", fit[k][:keep],
                              state[k][:keep])
                if fit[k][keep:].any():
                    raise AssertionError(f"refit {k}: joiners not zero")
    narrow = dataclasses.replace(cfg, d_model=256, num_heads=2,
                                 num_kv_heads=2, head_dim=128, d_ff=512,
                                 vocab_size=1024)
    tcfg = TrainConfig(global_batch=GLOBAL_BATCH, seq_len=64,
                       optimizer=OptimizerConfig(
                           kind="signum_vote", learning_rate=LR,
                           momentum=BETA, momentum_dtype="bfloat16",
                           vote_strategy=VoteStrategy.ALLGATHER_1BIT))
    art = TS.make_train_step(narrow, tcfg, M_MAIN, device=dev)
    params, opt_state = TS.materialize_state(
        narrow, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    pipe = SyntheticLMPipeline(narrow, GLOBAL_BATCH, 64, seed=0)
    params, opt_state, _ = art.step_fn(params, opt_state,
                                       pipe.global_batch_at(0), 0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 1, params, opt_state)
        p_back, o_back, _, meta = ckpt.restore(tmp, device=dev)
        walk(params, p_back, "trainer params")
        walk(opt_state, o_back, "trainer state")
    log({"phase": "checkpoint_roundtrip", "elastic_preset": spec.name,
         "refit_to": [ev.n_workers for ev in spec.elastic],
         "trainer_leaves": len(params), "momentum_dtype": "bfloat16",
         "ok": True})
    del params, opt_state, art
    torch.cuda.empty_cache()


def run_failure_path(torch, cfg, dev, ops, ref, err) -> dict:
    """Phase 12: the adversary kernel's checks (12a), then the drills (12b),
    the trainer under failures (12c) and checkpoints (12d), the counts set
    to 0 just before each path and read just after. Returns their
    launches."""
    t0 = time.perf_counter()
    check_adversary(torch, ops, ref, dev, err)
    totals = {}
    for path in (run_drills(torch, dev),
                 run_byzantine_train_path(torch, cfg, dev)):
        for k, v in path.items():
            totals[k] = totals.get(k, 0) + v
    check_checkpoints(torch, cfg, dev)
    log({"phase": "failure_path_done", "seconds": time.perf_counter() - t0,
         "launches": totals})
    return totals


# ---------------------------------------------------------------------------
# phase 13: the streamed population vote at federated scale, and the
# population and adaptive drills, card against CPU twin
# ---------------------------------------------------------------------------

#: the federated round: a logical population of POP_CLIENTS, POP_SAMPLE of
#: it sampled (12,000 voters), POP_N coordinates (2^22), voted in chunks of
#: POP_CHUNK rows and again of POP_CHUNK_ALT (chunk invariance)
POP_CLIENTS, POP_SAMPLE, POP_N = 100_000, 0.12, 1 << 22
POP_CHUNK, POP_CHUNK_ALT = 1024, 512
#: the random coalition: logical ids below a quarter of the population
POP_ADVERSARIES = POP_CLIENTS // 4
#: the voters of the streamed-equals-dense check (the dense (M, n) float32
#: stack is 17 GB at 1,024)
POP_DENSE = 1024
#: honest rows are x + POP_NOISE * N(0, 1), per (step, logical id)
POP_NOISE = 4.0
#: the peak's slack above the resident tensors: a chunk's float32 rows,
#: three (k, n) int8 / bool temporaries beside them, and 2 GiB
POP_SLACK_BYTES = 2 * 2 ** 30
#: the round's configurations: (label, strategy, codec, dataset weights,
#: adversary mode)
POP_CONFIGS = (
    ("sign1bit_allgather_1bit", "allgather_1bit", "sign1bit", False, None),
    ("sign1bit_psum_int8", "psum_int8", "sign1bit", False, None),
    ("dataset_allgather_1bit", "allgather_1bit", "sign1bit", True, None),
    ("weighted_vote", "allgather_1bit", "weighted_vote", True, None),
    ("random_25pct", "allgather_1bit", "sign1bit", False, "random"),
    ("low_margin_25pct", "allgather_1bit", "sign1bit", False, "low_margin"),
)
#: the rows and the columns of a slab held against the plain versions at
#: once in the kernel checks (the plain bitpack's bool and the draws'
#: temporaries of 64 rows of 2^22 stay below 2 GB; the plain apply's float32
#: temporaries of 2^25 elements below 1 GB)
POP_CHECK_ROWS, CHECK_COLS = 64, 1 << 25
#: the configurations voted once more under torch.profiler: in
#: ``scripts/population_probe.py`` only since phase 19d-19f (cut from the
#: script's main path for its time), which sets POP_PROBE_PROFILED here
POP_PROBE_PROFILED = ("sign1bit_allgather_1bit", "weighted_vote")
POP_PROFILED = ()
#: the streamed-equals-dense configurations (labels of POP_CONFIGS, the
#: random coalition added to the first two)
POP_DENSE_CONFIGS = (("dataset_allgather_1bit", "random"),
                     ("sign1bit_psum_int8", "random"),
                     ("weighted_vote", None))


def pop_peak_bound(chunk: int) -> int:
    """The most a streamed vote may hold above its resident tensors: the
    chunk's float32 rows and three int8 / bool (k, n) temporaries (the
    signs, a compare mask and the wire's unpacked signs), plus slack."""
    return chunk * POP_N * (4 + 3) + POP_SLACK_BYTES


class PopulationRows:
    """Client rows ``x + POP_NOISE * N(0, 1)`` made on the card, row by
    row, each under its own seed ``(step, logical id)`` (one Philox stream
    a row, offset 0), so no chunk boundary changes a row."""

    def __init__(self, torch, x, step: int):
        self.torch, self.x, self.step = torch, x, step
        self.gen = torch.Generator(device=x.device)

    def __call__(self, ids):
        torch = self.torch
        ids = ids.tolist()
        out = torch.empty((len(ids), self.x.numel()), dtype=torch.float32,
                          device=self.x.device)
        for r, cid in enumerate(ids):
            self.gen.manual_seed((self.step << 40) | (cid << 1) | 1)
            torch.randn(self.x.numel(), generator=self.gen, out=out[r])
        return out.mul_(POP_NOISE).add_(self.x)


def pop_round(np):
    """The sampled ids (sorted) and their dataset sizes (1..64)."""
    rng = np.random.default_rng(13)
    k = int(round(POP_SAMPLE * POP_CLIENTS))
    ids = np.sort(rng.choice(POP_CLIENTS, k, replace=False)).astype(np.int32)
    return ids, rng.integers(1, 65, size=k).astype(np.int64)


def pop_request(va, cfg, payload, state, astate, step, **annotations):
    """The round's request for configuration `cfg` of POP_CONFIGS: the
    streamed form of a PopulationStream `payload`, or the stacked form of
    an (M, n) tensor with its ``voter_ids`` / ``weights`` annotations."""
    from repro_torch.configs.base import ByzantineConfig, VoteStrategy
    from repro_torch.core import attacks
    label, strategy, codec, _, mode = cfg
    byz = obs = None
    if mode is not None:
        byz = ByzantineConfig(mode=mode, num_adversaries=POP_ADVERSARIES,
                              seed=21, target_fraction=0.25)
        if mode in attacks.ATTACK_MODES:
            obs = astate.observation(attacks.MODE_CHANNEL[mode])
    return va.VoteRequest(
        payload=payload, form="stacked" if annotations else "streamed",
        strategy=VoteStrategy(strategy), codec=codec,
        failures=va.FailureSpec(byz=byz), step=step, salt=5,
        server_state=state, attack_obs=obs, **annotations)


#: the wrappers phase 13a's chunk checks hold
POP_CHECKED = ("adversary_", "bitpack", "bitunpack")


@contextlib.contextmanager
def plain_checked(torch, ops, ref, sc, err, what: str,
                  names=POP_CHECKED, held=None):
    """Within the block, every launch of the ``ops`` wrappers `names` is
    held bit for bit against its plain version (``kernels/ref``) on the
    same tensors: POP_CHECK_ROWS rows and CHECK_COLS columns (of a 1-D
    tensor, CHECK_COLS elements) at a time, the input of an in-place
    kernel copied before the kernel writes it. `err` keeps each kernel's
    largest difference, by launch count name; `held` (a dict), when given,
    counts the launches held by the same names. The checks call only the
    plain versions, so they add no launch."""
    orig = {k: getattr(ops, k) for k in names}
    s, C = POP_CHECK_ROWS, CHECK_COLS

    def note(name, x, diff):
        err[name] = max(err.get(name, 0.0), diff)
        if held is not None and x.is_cuda:
            held[name] = held.get(name, 0) + 1

    def cols(n, per_word=1):
        """(element lo, hi, word lo, hi) of each CHECK_COLS slab of n."""
        for lo in range(0, n, C):
            hi = min(n, lo + C)
            yield lo, hi, lo // per_word, -(-hi // per_word)

    def adversary_(x, keys, p, flip, offset=0, *, start=0, block=0,
                   gap=0):
        before = x.clone()
        got = orig["adversary_"](x, keys, p, flip, offset, start=start,
                                 block=block, gap=gap)
        diff = 0.0
        for r in range(0, x.shape[0], s):
            for lo, hi, _, _ in cols(x.shape[1]):
                diff = max(diff, require_equal(
                    f"{what}: adversary {tuple(x.shape)} p={p} rows {r}.. "
                    f"cols {lo}.. map ({block}, {gap})",
                    got[r:r + s, lo:hi],
                    ref.adversary(before[r:r + s, lo:hi], keys[r:r + s], p,
                                  flip, offset, start + lo, block, gap)))
        note("adversary", x, diff)
        if block:
            note("adversary_map", x, diff)
        return got

    def packed_rows(name, x, got, per_word, plain):
        diff = 0.0
        for r in range(0, x.shape[0], s):
            for lo, hi, w0, w1 in cols(x.shape[1], per_word):
                diff = max(diff, require_equal(
                    f"{what}: {name} {tuple(x.shape)} {x.dtype} rows {r}.. "
                    f"cols {lo}..", got[r:r + s, w0:w1],
                    plain(sc.pad_last(x[r:r + s, lo:hi], per_word)[0])))
        note(name, x, diff)

    def bitpack(x, *, out=None):
        got = orig["bitpack"](x, out=out)
        packed_rows("bitpack", x, got, sc.PACK, ref.bitpack)
        return got

    def ternary_pack(x, *, out=None):
        got = orig["ternary_pack"](x, out=out)
        packed_rows("ternary_pack", x, got, sc.PACK2, ref.ternary_pack)
        return got

    def unpacked(name, packed, n, got, per_word, plain):
        diff = 0.0
        for lo, hi, w0, w1 in cols(n, per_word):
            diff = max(diff, require_equal(
                f"{what}: {name} n={n} {got.dtype} cols {lo}..", got[lo:hi],
                plain(packed[None, w0:w1])[0, :hi - lo]))
        note(name, packed, diff)

    def bitunpack(packed, n, dtype=torch.float32):
        got = orig["bitunpack"](packed, n, dtype)
        unpacked("bitunpack", packed, n, got, sc.PACK,
                 lambda w: ref.bitunpack(w, dtype))
        return got

    def ternary_unpack(packed, n, dtype=torch.int8):
        got = orig["ternary_unpack"](packed, n, dtype)
        unpacked("ternary_unpack", packed, n, got, sc.PACK2,
                 lambda w: ref.ternary_unpack(w, dtype))
        return got

    def tally(name, packed, got, plain):
        diff = 0.0
        for lo in range(0, packed.shape[1], C // sc.PACK):
            hi = lo + C // sc.PACK
            diff = max(diff, require_equal(
                f"{what}: {name} {tuple(packed.shape)} words {lo}..",
                got[lo:hi], plain(packed[:, lo:hi])))
        note(name, packed, diff)

    def majority(packed, *, out=None):
        got = orig["majority"](packed, out=out)
        tally("majority", packed, got, ref.majority)
        return got

    def ternary_majority(packed, *, ties="zero", out=None):
        got = orig["ternary_majority"](packed, ties=ties, out=out)
        name = "ternary_majority" + ("" if ties == "zero" else "_plus_one")
        tally(name, packed, got, lambda w: ref.ternary_majority(w, ties))
        return got

    def momentum_sign_pack(g, m, beta, *, m_out=None, packed_out=None,
                           pack=True):
        before = m.clone()
        m_out, packed_out = orig["momentum_sign_pack"](
            g, m, beta, m_out=m_out, packed_out=packed_out, pack=pack)
        diff = 0.0
        for lo, hi, w0, w1 in cols(g.shape[0], sc.PACK):
            want_m, want_w = ref.momentum_sign_pack(
                sc.pad_to_pack(g[lo:hi])[0], sc.pad_to_pack(before[lo:hi])[0],
                beta)
            diff = max(diff, require_equal(
                f"{what}: momentum_sign_pack n={g.shape[0]} m' cols {lo}..",
                m_out[lo:hi], want_m[:hi - lo]))
            if pack:
                require_equal(f"{what}: momentum_sign_pack words {w0}..",
                              packed_out[w0:w1], want_w)
        note("momentum_sign_pack", g, diff)
        return m_out, packed_out

    def applied(name, per_word, plain):
        def apply(p, votes, eta, weight_decay, *, out=None):
            before = p.clone()
            got = orig[name](p, votes, eta, weight_decay, out=out)
            diff = 0.0
            for lo, hi, w0, w1 in cols(p.shape[0], per_word):
                diff = max(diff, require_equal(
                    f"{what}: {name} n={p.shape[0]} cols {lo}..", got[lo:hi],
                    plain(sc.pad_to_pack(before[lo:hi], per_word)[0],
                          votes[w0:w1], eta, weight_decay)[:hi - lo]))
            note(name, p, diff)
            return got
        return apply

    wrapped = {"adversary_": adversary_, "bitpack": bitpack,
               "bitunpack": bitunpack, "ternary_pack": ternary_pack,
               "ternary_unpack": ternary_unpack, "majority": majority,
               "ternary_majority": ternary_majority,
               "momentum_sign_pack": momentum_sign_pack,
               "apply_vote": applied("apply_vote", sc.PACK, ref.apply_vote),
               "apply_ternary_vote": applied("apply_ternary_vote", sc.PACK2,
                                             ref.apply_ternary_vote)}
    for k in names:
        setattr(ops, k, wrapped[k])
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(ops, k, fn)


def check_population_chunk(torch, dev, err, cfg, x, ids, sizes, state,
                           astate, step) -> dict:
    """Phase 13a's kernel check of configuration `cfg`: its first POP_CHUNK
    sampled voters as one full chunk through the vote API (the shapes
    every chunk of its round gives the kernels), under
    :func:`plain_checked`. Returns the launches it held."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import vote_api as va
    from repro_torch.kernels import ops, ref
    label, weighted = cfg[0], cfg[3]
    k = POP_CHUNK
    stream = va.PopulationStream(
        n_voters=k, n_coords=POP_N, ids=ids[:k],
        weights=sizes[:k] if weighted else None,
        values=PopulationRows(torch, x, step))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with plain_checked(torch, ops, ref, sc, err, f"{label} chunk {k}"):
        va.VirtualBackend(device=dev, chunk_size=k).execute(
            pop_request(va, cfg, stream, state, astate, step))
    torch.cuda.synchronize()
    held = {n: v - before[n] for n, v in ops.launch_counts().items()
            if v > before[n]}
    log({"phase": "population_chunk_vs_plain", "config": label, "rows": k,
         "n": POP_N, "held": held, "seconds": time.perf_counter() - t0})
    return held


def time_population_rows(torch, x, ids, step: int) -> float:
    """CUDA-event ms of making the round's rows alone, POP_CHUNK at a time
    (what every pass of a streamed round spends in chip_smoke's row maker
    rather than in the port), after one untimed chunk (the allocator's and
    the generator's first use)."""
    rows = PopulationRows(torch, x, step)
    rows(torch.from_numpy(ids[:POP_CHUNK]))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for lo in range(0, len(ids), POP_CHUNK):
        rows(torch.from_numpy(ids[lo:lo + POP_CHUNK]))
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run_population_votes(torch, dev, err) -> dict:
    """Phase 13a: each of POP_CONFIGS over the sampled round at POP_CHUNK
    and POP_CHUNK_ALT (votes and tallies bit-equal), its ms beside the row
    maker's, peak memory and ``population.*`` counters, after one full
    chunk of it held against the plain versions
    (:func:`check_population_chunk`); low_margin sees the tally of the
    sign1bit round before it. Then POP_DENSE_CONFIGS on the first
    POP_DENSE sampled voters: the annotated stacked form (one (M, n)
    stack) against the streamed form at POP_CHUNK_ALT, votes, tallies and
    state bit-equal. Returns the launches (counts set to 0 just before,
    the chunk checks' launches taken out)."""
    import numpy as np
    from repro_torch.core import attacks
    from repro_torch.core import vote_api as va
    from repro_torch.kernels import ops
    from repro_torch.obs import COUNTERS
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(POP_N, generator=gen, device=dev)
    ids, sizes = pop_round(np)
    ema0 = torch.rand(POP_CLIENTS, generator=gen, device=dev) * 0.3
    astate = attacks.AttackState.init(POP_N, POP_CLIENTS, dev)
    rows_ms = {s: time_population_rows(torch, x, ids, s) for s in (0, 1)}
    log({"phase": "population_rows", "voters": len(ids), "n": POP_N,
         "chunk": POP_CHUNK, "ms": rows_ms})
    ops.reset_launch_counts()
    held = dict.fromkeys(ops.launch_counts(), 0)
    for cfg in POP_CONFIGS:
        label, _, codec, weighted, mode = cfg
        step = 1 if mode == "low_margin" else 0
        state = {"flip_ema": ema0} if codec == "weighted_vote" else None
        checked = check_population_chunk(torch, dev, err, cfg, x, ids, sizes,
                                         state, astate, step)
        for k, v in checked.items():
            held[k] += v
        got = {}
        for chunk in (POP_CHUNK, POP_CHUNK_ALT):
            stream = va.PopulationStream(
                n_voters=len(ids), n_coords=POP_N, ids=ids,
                weights=sizes if weighted else None,
                values=PopulationRows(torch, x, step))
            req = pop_request(va, cfg, stream, state, astate, step)
            be = va.VirtualBackend(device=dev, chunk_size=chunk)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = COUNTERS.snapshot("population.")
            launched = ops.launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = be.execute(req)
            end.record()
            end.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            launched = {k: v - launched[k] for k, v in
                        ops.launch_counts().items() if v > launched[k]}
            unchecked = sorted(set(launched) - set(checked))
            if unchecked:
                raise AssertionError(f"{label}: the round launched "
                                     f"{unchecked}, which its chunk check "
                                     "never held against the plain versions")
            counters = {k: v for k, v in COUNTERS.delta_since(
                before, "population.").items() if ".last." not in k}
            counters.update(COUNTERS.snapshot("population.last."))
            if counters["population.last.peak_rows"] > chunk:
                raise AssertionError(f"{label}: {counters} rows above the "
                                     f"chunk {chunk}")
            if peak > pop_peak_bound(chunk):
                raise AssertionError(
                    f"{label} at chunk {chunk}: peak {peak / 1e9:.2f} GB "
                    f"above {pop_peak_bound(chunk) / 1e9:.2f} GB")
            got[chunk] = out
            ms = start.elapsed_time(end)
            passes = counters["population.last.n_passes"]
            log({"phase": "population_vote", "config": label,
                 "voters": len(ids), "population": POP_CLIENTS, "n": POP_N,
                 "chunk": chunk, "ms": ms,
                 "rows_ms": passes * rows_ms[step],
                 "engine_ms": ms - passes * rows_ms[step],
                 "launches": launched, "wall_s": wall, "peak_gb": peak / 1e9,
                 "peak_bound_gb": pop_peak_bound(chunk) / 1e9,
                 "rows_gb": chunk * POP_N * 4 / 1e9,
                 "margin": out.wire.margin,
                 "agree_with_x": float((out.votes == torch.where(
                     x >= 0, 1, -1).to(torch.int8)).float().mean()),
                 "counters": counters})
        a, b = got[POP_CHUNK], got[POP_CHUNK_ALT]
        if not (torch.equal(a.votes, b.votes)
                and torch.equal(a.counts, b.counts)):
            raise AssertionError(f"{label}: chunk {POP_CHUNK} and "
                                 f"{POP_CHUNK_ALT} disagree")
        for k in a.server_state:
            if not torch.equal(a.server_state[k], b.server_state[k]):
                raise AssertionError(f"{label}: state {k} depends on the "
                                     "chunk")
        if label in POP_PROFILED:
            profile_population_vote(torch, label, va.VirtualBackend(
                device=dev, chunk_size=POP_CHUNK), req)
        if label == "sign1bit_allgather_1bit":
            astate = attacks.update_attack_state_population(
                astate, a.votes, a.counts, np.zeros(0, np.int32),
                np.zeros(0, np.float32))
        del got, a, b
    check_population_dense(torch, va, x, ids, sizes, ema0, astate)
    torch.cuda.synchronize()
    launches = {k: v - held[k] for k, v in ops.launch_counts().items()}
    for k in ("bitpack", "bitunpack", "adversary"):
        if not launches[k] or not held[k]:
            raise AssertionError(f"the streamed votes launched {k} "
                                 f"{launches[k]} times, their chunk checks "
                                 f"held it {held[k]} times")
    log({"phase": "population_votes_done", "launches": launches,
         "held_against_plain": held,
         "max_abs_err": {k: err[k] for k in ("adversary", "bitpack",
                                             "bitunpack")}})
    return launches


def profile_population_vote(torch, label, backend, req) -> None:
    """One more streamed vote under torch.profiler: device time by kernel
    beside the host's wall time (profiler overhead included), for the
    breakdown and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backend.execute(req)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:100])
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    log({"phase": "population_vote_profile", "config": label,
         "chunk": backend.chunk_size, "wall_ms": wall,
         "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
         "top_kernels": [{"ms": ms, "count": c, "name": k}
                         for ms, c, k in kernels[:8]]})


def check_population_dense(torch, va, x, ids, sizes, ema0, astate) -> None:
    """Phase 13a's streamed-equals-dense check (see run_population_votes)."""
    m = POP_DENSE
    dense = PopulationRows(torch, x, 0)(torch.from_numpy(ids[:m]))
    for label, mode in POP_DENSE_CONFIGS:
        cfg = next(c for c in POP_CONFIGS if c[0] == label)
        cfg = cfg[:4] + (mode,)
        weighted, codec = cfg[3], cfg[2]
        state = {"flip_ema": ema0} if codec == "weighted_vote" else None
        t0 = time.perf_counter()
        d = va.VirtualBackend(device=x.device).execute(pop_request(
            va, cfg, dense, state, astate, 0, voter_ids=ids[:m],
            weights=sizes[:m] if weighted else None))
        t1 = time.perf_counter()
        stream = va.PopulationStream(
            n_voters=m, n_coords=POP_N, ids=ids[:m],
            weights=sizes[:m] if weighted else None,
            values=PopulationRows(torch, x, 0))
        s = va.VirtualBackend(device=x.device,
                              chunk_size=POP_CHUNK_ALT).execute(
            pop_request(va, cfg, stream, state, astate, 0))
        same = (torch.equal(d.votes, s.votes)
                and torch.equal(d.counts, s.counts)
                and all(torch.equal(d.server_state[k], s.server_state[k])
                        for k in d.server_state))
        if not same:
            raise AssertionError(f"{label} ({mode}): the dense annotated "
                                 "form and the streamed form disagree")
        log({"phase": "population_streamed_eq_dense", "config": label,
             "adversary": mode, "voters": m, "n": POP_N,
             "dense_s": t1 - t0, "streamed_s": time.perf_counter() - t1})
    del dense


def fed_smoke_specs():
    """benchmarks/bench_federated.py's three fed-smoke drills and its
    M = 100,000 scale drill (the same specs)."""
    from repro_torch.configs.base import VoteStrategy as S
    from repro_torch.sim import (AdversarySpec, ChurnEvent, PopulationSpec,
                                 ScenarioSpec)
    return [
        ScenarioSpec("fed-smoke/uniform", n_steps=3, dim=64, momentum=0.0,
                     strategy=S.PSUM_INT8,
                     adversary=AdversarySpec("sign_flip", 0.2),
                     population=PopulationSpec(
                         n_clients=200, sample_fraction=0.12, chunk_size=6)),
        ScenarioSpec("fed-smoke/dataset", n_steps=3, dim=64, momentum=0.0,
                     strategy=S.ALLGATHER_1BIT,
                     adversary=AdversarySpec("colluding", 0.3),
                     population=PopulationSpec(
                         n_clients=120, sample_fraction=0.3,
                         weighting="dataset", max_data=50, chunk_size=6)),
        ScenarioSpec("fed-smoke/weighted", n_steps=5, dim=64, momentum=0.0,
                     strategy=S.ALLGATHER_1BIT, codec="weighted_vote",
                     adversary=AdversarySpec("blind", 0.25, flip_prob=0.8),
                     population=PopulationSpec(
                         n_clients=90, sample_fraction=0.4,
                         weighting="dataset",
                         churn=(ChurnEvent(2, leave=30, note="dropout"),
                                ChurnEvent(4, join=15, note="rejoin")),
                         chunk_size=6)),
        ScenarioSpec("fed-smoke/scale-100k", n_steps=2, dim=64,
                     momentum=0.0, strategy=S.PSUM_INT8,
                     population=PopulationSpec(
                         n_clients=100_000, sample_fraction=0.1,
                         churn=(ChurnEvent(1, join=25_000, leave=5_000,
                                           note="scale churn"),),
                         chunk_size=2000)),
    ]


def card_and_cpu(torch, dev, spec) -> tuple:
    """One drill on the card and on the CPU from the port's own draws; the
    digests must be equal. Returns the card's trace and its seconds."""
    from repro_torch.obs import COUNTERS
    from repro_torch.sim import ScenarioRunner
    t0 = time.perf_counter()
    card = ScenarioRunner(spec, device=dev).run()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak_rows = COUNTERS.get("population.last.peak_rows")
    cpu = ScenarioRunner(spec, device="cpu").run()
    if card.digest != cpu.digest:
        raise AssertionError(f"drill {spec.name}: card digest {card.digest} "
                             f"!= CPU {cpu.digest}")
    if spec.population.enabled and peak_rows > spec.population.chunk_size:
        raise AssertionError(f"drill {spec.name}: peak rows {peak_rows} "
                             f"above its chunk {spec.population.chunk_size}")
    return card, card_s


def run_population_drills(torch, dev) -> dict:
    """Phase 13b: the two adaptive presets, the fed-smoke drills and the
    scale drill, the breaking-point specs (every class at every fraction
    and the defense-degradation pair) and the chunk-invariance identity
    row, each on the card and on the CPU with equal digests; then
    ``breaking_point_rows(with_identity=False)`` on both, every row equal
    (the loss drops, float32 means summed in another order, within 1e-6).
    Returns the launches (counts set to 0 just before)."""
    from repro_torch.core.attacks import breaking_point as bp
    from repro_torch.kernels import ops
    from repro_torch.sim import preset_scenarios
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sets = {"adaptive_presets": [s for s in preset_scenarios()
                                 if s.adversary.adaptive],
            "fed_smoke": fed_smoke_specs(),
            "breaking_point": [
                bp._make_spec(c, f, n_workers=15, dim=48, n_steps=6, seed=0)
                for c in bp.ATTACK_CLASSES for f in bp.FRACTIONS] + [
                bp._make_spec(dict(mode=mode, observe=obs,
                                   codec="weighted_vote"), 0.3,
                              n_workers=15, dim=48, n_steps=10, seed=0)
                for mode, obs in (("colluding", "none"),
                                  ("reputation", "reputation"))]}
    seconds = {}
    for name, specs in sets.items():
        t = time.perf_counter()
        for spec in dict.fromkeys(specs):
            card, card_s = card_and_cpu(torch, dev, spec)
            s = card.summary()
            log({"drill": spec.name, "set": name, "digest": card.digest,
                 "cpu_equal": True, "final_loss": s["final_loss"],
                 "mean_flip_fraction": s["mean_flip_fraction"],
                 "mean_margin": s["mean_margin"], "card_s": card_s})
        seconds[name] = time.perf_counter() - t
    t = time.perf_counter()
    rows = {dev_: bp.breaking_point_rows(with_identity=False, device=dev_)
            for dev_ in (dev, "cpu")}
    rows_cpu = rows.pop("cpu")
    rows_card = rows.pop(dev)
    rows_card.append(bp.population_identity_row(device=dev))
    rows_cpu.append(bp.population_identity_row(device="cpu"))
    for (name, v, d), (name_c, v_c, d_c) in zip(rows_card, rows_cpu):
        close = (abs(v - v_c) <= 1e-6 if "/loss_drop_" in name
                 else v == v_c and ("/identity/" not in name or d == d_c))
        if name != name_c or not close:
            raise AssertionError(f"breaking-point row {name}: card {v} != "
                                 f"CPU {v_c}")
    if len(rows_card) != len(rows_cpu):
        raise AssertionError("breaking-point rows differ in number")
    seconds["breaking_point_rows"] = time.perf_counter() - t
    log({"phase": "breaking_point_rows", "rows": [list(r[:2])
                                                  for r in rows_card]})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for k in ("majority", "bitpack", "bitunpack", "adversary"):
        if not launches[k]:
            raise AssertionError(f"the drills never launched {k}")
    log({"phase": "population_drills_done", "seconds": seconds,
         "total_s": time.perf_counter() - t0, "launches": launches})
    return launches


def run_population_path(torch, dev, err) -> dict:
    """Phase 13: the streamed votes (13a), then the drills (13b). Returns
    their launches."""
    t0 = time.perf_counter()
    totals = {}
    for path in (run_population_votes(torch, dev, err),
                 run_population_drills(torch, dev)):
        for k, v in path.items():
            totals[k] = totals.get(k, 0) + v
    log({"phase": "population_path_done",
         "seconds": time.perf_counter() - t0, "launches": totals})
    return totals


# ---------------------------------------------------------------------------
# phase 14: the mesh on the card (one voter per process)
# ---------------------------------------------------------------------------

#: ranks of the mesh world, all on cuda:0 (NCCL takes one device per rank,
#: and there is one card, so they meet over gloo through host memory)
MESH_RANKS = 4
MESH_STEPS = 2
#: phase 14's runs: (label, mesh shape, mesh axes, optimizer options,
#: train options); every one from the same seed as phase 3
MESH_RUNS = (
    ("allgather_1bit", (4,), ("data",), {}, {}),
    ("psum_int8", (4,), ("data",), {"vote_strategy": "psum_int8"}, {}),
    ("hierarchical_pod2x2", (2, 2), ("pod", "data"),
     {"vote_strategy": "hierarchical"}, {}),
    ("ternary2bit", (4,), ("data",), {"codec": "ternary2bit"}, {}),
    ("plan_overlap", (4,), ("data",),
     {"bucket_bytes": PLAN_BUCKET_BYTES, "overlap": True}, {}),
    ("sign_flip_diagnostics", (4,), ("data",), {},
     {"diagnostics": True, "byzantine": ("sign_flip", 1)}),
)
#: the wrappers a mesh step launches, which rank 0 holds against their plain
#: versions in the first step of every run
MESH_CHECKED = ("momentum_sign_pack", "majority", "apply_vote",
                "apply_ternary_vote", "bitpack", "bitunpack", "ternary_pack",
                "ternary_unpack", "ternary_majority", "adversary_")
#: the wires whose votes of the trained momentum rank 0 holds against the
#: virtual vote of the gathered (4, n) rows: (wire, mesh shape, axes); the
#: paper's wire (the count wires' mesh votes are the trainer runs' own
#: collectives, held to the twin there; each adds ~5 s of gloo)
MESH_VOTE_WIRES = (("allgather_1bit", (4,), ("data",)),)
#: elements a device checksum reads at a time
CHECKSUM_CHUNK = 1 << 26


def mesh_train_config(opt: dict, train: dict):
    """Phase 3's train config with a run's options."""
    from repro_torch.configs.base import ByzantineConfig, VoteStrategy
    tcfg = train_config("sign1bit")
    opt = {k: VoteStrategy(v) if k == "vote_strategy" else v
           for k, v in opt.items()}
    train = dict(train)
    if "byzantine" in train:
        mode, n = train["byzantine"]
        train["byzantine"] = ByzantineConfig(mode=mode, num_adversaries=n)
    return dataclasses.replace(
        tcfg, optimizer=dataclasses.replace(tcfg.optimizer, **opt), **train)


def device_checksum(torch, tensors) -> str:
    """sha256 of position-weighted int64 checksums of the tensors' bits,
    computed on their device: each 32-bit word w_i (16-bit words of a bf16
    tensor, 8-bit of int8) times the odd weight 2i+1 + 2^33 i, summed
    modulo 2^64 per chunk. A single differing element changes its chunk's
    sum (an odd weight is a unit modulo 2^64); hashing every byte on the
    host instead would take minutes for the tens of GB of one run."""
    import hashlib
    sums = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        words = flat.view({1: torch.int8, 2: torch.int16}.get(
            flat.element_size(), torch.int32))
        for start in range(0, words.numel(), CHECKSUM_CHUNK):
            w = words[start:start + CHECKSUM_CHUNK].to(torch.int64)
            i = torch.arange(start, start + w.numel(), dtype=torch.int64,
                             device=w.device)
            sums.append(int((w * (2 * i + 1 + (i << 33))).sum()))
            del w, i
    return hashlib.sha256(json.dumps(sums).encode()).hexdigest()


def mesh_state_checksum(torch, params, opt_state, voter) -> str:
    """The checksum of the parameters and the momentum (of a stacked state,
    voter `voter`'s rows)."""
    parts = [params[k] for k in sorted(params)]
    for k in sorted(opt_state.get("momentum", {})):
        m = opt_state["momentum"][k]
        parts.append(m[voter] if voter is not None
                     and m.dim() > params[k].dim() else m)
    return device_checksum(torch, parts)


def mesh_launches(label: str, rank: int, n_leaves: int, plan) -> dict:
    """The kernel launches of one mesh step of run `label` on rank `rank`
    (one voter): the 1-bit wire as phase 3's step for one voter; the count
    wires' 2-bit symbols unpacked (ternary_unpack), voted by the
    collectives and repacked (ternary_pack), hierarchical's decision through
    bitpack / bitunpack; the plan's walk per bucket; the diagnostics'
    decode of each leaf's vote (bitunpack), and the adversary's encode
    through bitpack on rank 0."""
    L = n_leaves
    if label == "plan_overlap":
        want = plan_launches(plan)
        want["momentum_sign_pack"] = L
        for k in ("ternary_pack", "apply_ternary_vote"):
            want[k] = want.get(k, 0) + L
        return want
    want = {"momentum_sign_pack": L}
    if label in ("allgather_1bit", "sign_flip_diagnostics"):
        want.update(majority=L, apply_vote=L)
    elif label == "ternary2bit":
        want.update(ternary_pack=L, ternary_majority=L,
                    apply_ternary_vote=L)
    else:
        want.update(ternary_pack=2 * L, ternary_unpack=L,
                    apply_ternary_vote=L)
        if label.startswith("hierarchical"):
            want.update(bitpack=L, bitunpack=L)
    if label == "sign_flip_diagnostics":
        want["bitunpack"] = L
        if rank == 0:
            want["bitpack"] = L
    return want


def mesh_twin(torch, cfg, dev) -> dict:
    """The stacked twin of every phase-14 run (M = 4 on one device): per
    run its losses, diagnostics and each voter's state checksum."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.train import train_step as TS
    out = {}
    for label, _, _, opt, train in MESH_RUNS:
        tcfg = mesh_train_config(opt, train)
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        params, state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        mets, ms = [], []
        for step in range(MESH_STEPS):
            tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                     device=dev)
            sync(torch, dev)
            t0 = time.perf_counter()
            params, state, met = art.step_fn(params, state,
                                             {"tokens": tokens}, step)
            sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append({k: float(v) for k, v in met.items()})
        out[label] = {"metrics": mets, "ms": ms, "checksums": [
            mesh_state_checksum(torch, params, state, v)
            for v in range(M_MAIN)]}
        log({"phase": "mesh_twin", "run": label, "metrics": mets,
             "step_ms": ms})
        del params, state, art
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_rank(rank: int, init: str, cfg, dev_type: str, queue) -> None:
    """One rank of phase 14's world (a spawned process): every run of
    MESH_RUNS on its own voter, then the vote check of the trained momentum;
    puts ``(rank, results)`` on `queue`, or ``(rank, {"error": ...})``."""
    import traceback
    try:
        queue.put((rank, mesh_rank_body(rank, init, cfg, dev_type)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def mesh_rank_body(rank: int, init: str, cfg, dev_type: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core import sign_compress as sc
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.kernels import ops, ref
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=MESH_RANKS)
    try:
        # every rank builds every mesh, in one order
        meshes = {(shape, axes): ProcessMesh(shape, axes)
                  for _, shape, axes, _, _ in MESH_RUNS}
        pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
        out = {"runs": {}, "max_abs_err": {}}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for label, shape, axes, opt, train in MESH_RUNS:
            mesh = meshes[(shape, axes)]
            tcfg = mesh_train_config(opt, train)
            art = TS.make_train_step(cfg, tcfg, device=dev, mesh=mesh)
            params, state = TS.materialize_state(
                cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
            want = mesh_launches(label, rank, len(params), art.plan)
            mets, steps, err, held = [], [], {}, {}
            for step in range(MESH_STEPS):
                tokens = torch.as_tensor(pipe.global_batch_at(step)[
                    "tokens"], device=dev)
                sync(torch, dev)
                mesh.reset_stats()
                ops.reset_launch_counts()
                # rank 0's first step holds every launch against its plain
                # version (the same launches; the step's time includes it)
                checked = rank == 0 and step == MESH_CHECKED_STEP
                t0 = time.perf_counter()
                with (plain_checked(torch, ops, ref, sc, err,
                                    f"mesh {label} rank 0 step {step}",
                                    MESH_CHECKED, held) if checked
                      else contextlib.nullcontext()):
                    params, state, met = art.step_fn(params, state,
                                                     {"tokens": tokens}, step)
                sync(torch, dev)
                ms = (time.perf_counter() - t0) * 1e3
                launches = {k: v for k, v in ops.launch_counts().items()
                            if v}
                if (launches or dev.type == "cuda") and launches != want:
                    raise AssertionError(
                        f"rank {rank} {label} step {step}: launches "
                        f"{launches}, expected {want}")
                if checked and dev.type == "cuda" and held != launches:
                    raise AssertionError(
                        f"{label}: rank 0 held {held} of the launches "
                        f"{launches} against their plain versions")
                mets.append({k: float(v) for k, v in met.items()})
                steps.append({"ms": ms,
                              "collective_ms": mesh.stats.seconds * 1e3,
                              "bytes": mesh.stats.bytes,
                              "collectives": mesh.stats.calls,
                              "launches": launches})
            out["runs"][label] = {
                "metrics": mets, "steps": steps, "held": held,
                "max_abs_err": err,
                "checksum": mesh_state_checksum(torch, params, state, None)}
            for k, v in err.items():
                out["max_abs_err"][k] = max(out["max_abs_err"].get(k, 0.0),
                                            v)
            momentum = state["momentum"]
            del params, state, art
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if label == MESH_RUNS[0][0]:   # the parameters freed first
                out["votes"] = mesh_vote_check(torch, momentum, meshes,
                                               rank, dev)
            del momentum
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def mesh_vote_check(torch, momentum, meshes, rank: int, dev) -> dict:
    """Each leaf of this rank's trained momentum voted over the mesh on the
    MESH_VOTE_WIRES, and on rank 0 held against VirtualBackend's vote of
    the (4, n) int8 signs gathered from the ranks (replica order)."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import vote_api as va
    from repro_torch.distributed import mesh as pm
    data = meshes[((4,), ("data",))].vote_axes
    virtual = va.VirtualBackend(device=dev)
    coords = 0
    for k in sorted(momentum):
        signs = sc.sign_ternary(momentum[k].reshape(-1))
        rows = pm.gather_voters(signs, data)
        for wire, shape, axes in MESH_VOTE_WIRES:
            strategy = VoteStrategy(wire)
            got = va.MeshBackend(axes=meshes[(shape, axes)].vote_axes,
                                 device=dev).execute(va.VoteRequest(
                                     payload=signs, form="leaf",
                                     strategy=strategy)).votes
            if rank == 0:
                want = virtual.execute(va.VoteRequest(
                    payload=rows, form="stacked", strategy=strategy)).votes
                if not torch.equal(got.to(torch.int8), want):
                    raise AssertionError(f"mesh vote of {k} on {wire} "
                                         "differs from the virtual vote")
                del want
            del got
        coords += signs.numel()
        del signs, rows
    return {"leaves": len(momentum), "coords": coords,
            "wires": [w for w, _, _ in MESH_VOTE_WIRES]}


def mesh_wire_bytes(cfg, label: str) -> dict:
    """The WireReport of one step's vote on run `label` (the static report
    VirtualBackend and MeshBackend count) beside a float32 gradient."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import vote_api as va
    from repro_torch.core import vote_plan as vp
    opt = dict(MESH_RUNS[[r[0] for r in MESH_RUNS].index(label)][3])
    n = cfg.param_count()
    strategy = VoteStrategy(opt.get("vote_strategy", "allgather_1bit"))
    codec = opt.get("codec", "sign1bit")
    plan = (vp.build_plan(cfg.param_shapes(),
                          bucket_bytes=opt["bucket_bytes"], strategy=strategy)
            if "bucket_bytes" in opt else None)
    wire = va._static_wire(plan, codec, strategy, n,
                           len(cfg.param_shapes()), MESH_RANKS)
    return {"wire_report_payload_bytes": wire.payload_bytes,
            "float32_gradient_bytes": 4 * n}


def spawn_ranks(target, args, timeout_s: float,
                ranks: int = MESH_RANKS) -> dict:
    """Run `target(rank, init, *args, queue)` in `ranks` spawned processes
    over a fresh localhost port; returns {rank: result}, or raises the
    first rank's error (every process is stopped on return)."""
    import multiprocessing as mp
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init = f"tcp://127.0.0.1:{port}"
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=target, args=(r, init) + tuple(args)
                         + (queue,)) for r in range(ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < ranks:
            if time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"the ranks did not finish in "
                                     f"{timeout_s} s")
            if not queue.empty():
                rank, res = queue.get()
                if "error" in res:
                    raise AssertionError(f"rank {rank} failed:\n"
                                         f"{res['error']}")
                results[rank] = res
            elif any(p.exitcode not in (None, 0) for p in procs):
                raise AssertionError("a rank exited with "
                                     f"{[p.exitcode for p in procs]}")
            else:
                time.sleep(0.05)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


def run_mesh_path(torch, cfg, dev, errs, target=None) -> dict:
    """Phase 14: the stacked twin of each MESH_RUNS configuration, then a
    world of MESH_RANKS processes (spawned, over gloo, each on `dev`) runs
    them with one voter per rank. Every rank's losses, diagnostics and
    state checksum must equal the twin's voter's; rank 0 holds every
    kernel launch of each run's first step against its plain version
    (each kernel's largest difference into `errs`), and each leaf's mesh
    vote of the trained momentum against VirtualBackend. Returns the
    ranks' summed launches."""
    t_start = time.perf_counter()
    twin = mesh_twin(torch, cfg, dev)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log({"phase": "mesh_twin_done", "seconds":
             time.perf_counter() - t_start,
             "allocated_bytes_before_ranks": torch.cuda.memory_allocated(),
             "reserved_bytes_before_ranks": torch.cuda.memory_reserved(),
             "device_free_bytes_before_ranks": free,
             "device_total_bytes": total})
    t_ranks = time.perf_counter()
    results = spawn_ranks(target or mesh_rank, (cfg, dev.type),
                          MESH_TIMEOUT_S)
    ranks_s = time.perf_counter() - t_ranks
    launches = {}
    for k, v in results[0]["max_abs_err"].items():
        errs[k] = max(errs.get(k, 0.0), v)
    for label, shape, axes, _, _ in MESH_RUNS:
        want = twin[label]
        if dev.type == "cuda" and not results[0]["runs"][label]["held"]:
            raise AssertionError(f"mesh {label}: rank 0 held no launch "
                                 "against its plain version")
        for r in range(MESH_RANKS):
            got = results[r]["runs"][label]
            if got["metrics"] != want["metrics"]:
                raise AssertionError(
                    f"mesh {label} rank {r}: metrics {got['metrics']} != "
                    f"the stacked twin's {want['metrics']}")
            if got["checksum"] != want["checksums"][r]:
                raise AssertionError(
                    f"mesh {label} rank {r}: parameters / momentum differ "
                    "from the stacked twin's voter")
            for st in got["steps"]:
                for k, v in st["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        steps = [results[r]["runs"][label]["steps"] for r in range(
            MESH_RANKS)]
        per_step = [max(s[i]["ms"] for s in steps)
                    for i in range(MESH_STEPS)]
        coll = [max(s[i]["collective_ms"] for s in steps)
                for i in range(MESH_STEPS)]
        sent = steps[0][-1]["bytes"]
        line = {"phase": "mesh_wire", "run": label, "mesh": list(shape),
                "axes": list(axes), "bytes_per_step_rank0": sent,
                "bytes_per_step_by_rank": [s[-1]["bytes"] for s in steps],
                **mesh_wire_bytes(cfg, label),
                "step_ms": per_step, "collective_ms": coll,
                "other_ms": [a - b for a, b in zip(per_step, coll)],
                "twin_step_ms": want["ms"],
                "losses": [m["loss"] for m in want["metrics"]],
                "bit_equal_to_twin": True,
                "checked_step": MESH_CHECKED_STEP,
                "held_vs_plain_rank0": results[0]["runs"][label]["held"],
                "max_abs_err": results[0]["runs"][label]["max_abs_err"]}
        line["float32_over_sent"] = line["float32_gradient_bytes"] / sent
        if "vote_margin" in want["metrics"][0]:
            line["diagnostics"] = [{k: m[k] for k in (
                "vote_agreement", "vote_margin")} for m in want["metrics"]]
        log(line)
    log({"phase": "mesh_path_done", "ranks": MESH_RANKS,
         "backend": "gloo", "device": dev.type,
         "votes": results[0]["votes"],
         "peak_bytes_by_rank": [results[r].get("peak_bytes")
                                for r in range(MESH_RANKS)],
         "peak_reserved_bytes_by_rank": [
             results[r].get("peak_reserved_bytes")
             for r in range(MESH_RANKS)],
         "ranks_seconds": ranks_s,
         "seconds": time.perf_counter() - t_start, "smi": smi_line()
         if dev.type == "cuda" else None})
    return launches


#: how long phase 14's ranks may take, spawn to exit
MESH_TIMEOUT_S = 600
#: the step of every run whose launches rank 0 holds against the plain
#: versions (its time includes the check; step 1 is the one to read)
MESH_CHECKED_STEP = 0


# ---------------------------------------------------------------------------
# phase 15: the fused ZeRO backward (fsdp), stacked and over a mesh,
# remat="dots", and the training launcher
# ---------------------------------------------------------------------------

#: phase 15a: steps of the Mode B preset (nested remat), of remat="dots"
#: and of the sgd preset, all with fsdp, M = 4 stacked
FSDP_STEPS, FSDP_DOTS_STEPS, FSDP_SGD_STEPS = 3, 2, 2
#: the fused leaf whose step-0 vote is recomputed by plain PyTorch
FSDP_LEAF = "layers.attn_wq"
#: phase 15b's cuts (four ranks in 80 GB, gloo on loopback): microbatches
#: 8 -> 2, batch 32 -> 8, depth 2 -> 1
FSDP_MESH_MICRO, FSDP_MESH_BATCH, FSDP_MESH_LAYERS = 2, 8, 1
#: phase 15b's runs: (label, mesh shape, axes, train changes, steps)
FSDP_MESH_RUNS = (
    ("mode_b_pod2x2_sign_flip", (2, 2), ("pod", "data"),
     {"byzantine": ("sign_flip", 1)}, 2),
    ("sgd_data4", (4,), ("data",), {"kind": "sgd"}, 1),
)
#: phase 15c: the launcher at full glm4-9b depth and width (9.4e9
#: parameters, signSGD so no momentum), then a reduced run killed after a
#: checkpoint and resumed
LAUNCH_FULL = ("--arch", "glm4-9b", "--steps", "3", "--batch", "8",
               "--seq", "128", "--opt", "signsgd_vote", "--momentum", "0",
               "--log-every", "1")
LAUNCH_REDUCED = ("--arch", "glm4-9b", "--reduced", "--steps", "4",
                  "--log-every", "1")
LAUNCH_TIMEOUT_S = 300


def fsdp_config(torch, layers: int = 2):
    """qwen1.5-32b at every published width, `layers` deep, and its Mode B
    preset at (seq PRESET_SEQ, batch PRESET_BATCH) with fsdp on."""
    from repro_torch.configs.base import (MomentumMode, ShapeCell,
                                          VoteStrategy, get_config)
    from repro_torch.configs.presets import default_train_config
    cfg = dataclasses.replace(get_config("qwen1.5-32b"), num_layers=layers)
    preset = default_train_config("qwen1.5-32b", ShapeCell(
        "train_smoke", PRESET_SEQ, PRESET_BATCH, "train"))
    opt = preset.optimizer
    if (opt.kind, opt.momentum_mode, opt.vote_strategy, opt.momentum,
            preset.microbatches, preset.remat, preset.fsdp) != (
            "signsgd_vote", MomentumMode.GLOBAL, VoteStrategy.HIERARCHICAL,
            0.9, 8, "nested", True):
        raise AssertionError(f"not the qwen1.5-32b Mode B preset: {preset}")
    return cfg, preset


def fsdp_launches(kind: str, raw: int, fused: int, voters: int,
                  mesh: bool) -> dict:
    """One step's launches under fsdp on hierarchical (`raw` leaves on the
    wire, `fused` voted in the backward by PyTorch ops, no kernel). Mode B
    stacked: each voter's bf16 gradient row of a raw leaf packed
    (ternary_pack), per raw leaf the ties-+1 tally and the vote unpacked to
    bf16; over a mesh instead the rank's symbols unpacked, the strategy's
    bitpack / bitunpack of its decision and the vote repacked, then
    unpacked to bf16. Then per leaf, raw or fused, the momentum kernel
    without words, ternary_pack of u and apply_ternary_vote. The dense
    baselines launch nothing."""
    if kind == "sgd":
        return {}
    want = {"momentum_sign_pack": raw + fused,
            "apply_ternary_vote": raw + fused}
    if mesh:
        want.update(ternary_pack=3 * raw + fused, ternary_unpack=2 * raw,
                    bitpack=raw, bitunpack=raw)
    else:
        want.update(ternary_pack=voters * raw + raw + fused,
                    ternary_majority_plus_one=raw, ternary_unpack=raw)
    return want


def fsdp_leaf_vote(torch, M, sc, cfg, tcfg, params, batch, leaf):
    """Step 0's accumulated fused vote of `leaf`, by plain PyTorch: per
    microbatch of `batch` each voter's gradient by autograd (blocks
    checkpointed as the preset has them), the sum of their int8 signs and
    its sign, added in bf16 over the microbatches and divided by their
    count."""
    per = batch["tokens"].shape[0] // M_MAIN
    micro = tcfg.microbatches
    rows = per // micro
    acc = torch.zeros_like(params[leaf], dtype=torch.bfloat16)
    for i in range(micro):
        count = torch.zeros_like(params[leaf], dtype=torch.int8)
        for r in range(M_MAIN):
            leaves = dict(params)
            leaves[leaf] = params[leaf].detach().requires_grad_()
            start = r * per + i * rows
            loss, _ = M.loss_fn(cfg, leaves, batch_rows(batch, start, rows),
                                remat=tcfg.remat)
            g = torch.autograd.grad(loss, [leaves[leaf]])[0]
            count.add_(sc.sign_ternary(g))
            del g, leaves
        acc.add_(torch.sign(count).to(params[leaf].dtype).to(
            torch.bfloat16))
    return acc.div_(micro)


def fsdp_step_loop(torch, label, art, params, state, pipe, steps, want,
                   err, check_step0=True) -> tuple:
    """`steps` steps with exact launches, every launch of step 0 held
    against its plain version; returns (launches of the run, losses, step
    ms, the state after step 0 of FSDP_LEAF's momentum and parameters)."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import ops, ref
    total, losses, step_ms, after0 = {}, [], [], None
    for step in range(steps):
        tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                 device=art.device)
        ops.reset_launch_counts()
        held = {}
        checked = check_step0 and step == 0
        sync(torch, art.device)
        t0 = time.perf_counter()
        with (plain_checked(torch, ops, ref, sc, err,
                            f"fsdp {label} step {step}", MESH_CHECKED, held)
              if checked else contextlib.nullcontext()):
            params, state, met = art.step_fn(params, state,
                                             {"tokens": tokens}, step)
        sync(torch, art.device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        loss = float(met["loss"])
        log({"run": label, "step": step, "loss": loss, "ms": ms,
             "launches": launches, "held_vs_plain": held})
        if not math.isfinite(loss):
            raise AssertionError(f"{label} step {step}: loss {loss}")
        if (launches or art.device.type == "cuda") and launches != want:
            raise AssertionError(f"{label} step {step}: launches "
                                 f"{launches}, expected {want}")
        if checked and art.device.type == "cuda" and held != launches:
            raise AssertionError(f"{label}: held {held} of the launches "
                                 f"{launches} against their plain versions")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        losses.append(loss)
        step_ms.append(ms)
        if step == 0 and "momentum" in state:
            after0 = (state["momentum"][FSDP_LEAF].clone(),
                      params[FSDP_LEAF].clone())
    return total, losses, step_ms, after0


def peak_bytes(torch, dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def run_fsdp_stacked(torch, dev, err, cfg=None) -> dict:
    """Phase 15a: the qwen1.5-32b Mode B preset with its fsdp on, M = 4
    stacked (the fused backward's virtual form): FSDP_STEPS steps of the
    preset (nested remat), every launch of step 0 held against its plain
    version and FSDP_LEAF's step-0 momentum and parameters bit-equal to the
    plain versions run on the plain recomputation of its accumulated vote;
    then remat="dots" (losses bit-equal to nested's) and the sgd preset
    with fsdp. Returns the launches."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import signum
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    t_start = time.perf_counter()
    full, preset = fsdp_config(torch)
    cfg = cfg or full
    sgd = dataclasses.replace(preset, optimizer=dataclasses.replace(
        preset.optimizer, kind="sgd"))
    runs = (("mode_b_nested", preset, FSDP_STEPS),
            ("mode_b_dots", dataclasses.replace(preset, remat="dots"),
             FSDP_DOTS_STEPS),
            ("sgd", sgd, FSDP_SGD_STEPS))
    totals, out = {}, {}
    for label, tcfg, steps in runs:
        reset_peak(torch, dev)
        art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
        if not art.fused_leaves:
            raise AssertionError(f"fsdp {label}: no leaf is fused")
        params, state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, tcfg.seq_len,
                                   seed=0)
        raw = len(params) - len(art.fused_leaves)
        want = fsdp_launches(tcfg.optimizer.kind, raw,
                             len(art.fused_leaves), M_MAIN, mesh=False)
        log({"phase": "fsdp_stacked", "run": label, "arch": cfg.name,
             "num_layers": cfg.num_layers, "params": cfg.param_count(),
             "voters": M_MAIN, "global_batch": tcfg.global_batch,
             "seq": tcfg.seq_len, "microbatches": tcfg.microbatches,
             "remat": tcfg.remat, "fsdp": tcfg.fsdp,
             "kind": tcfg.optimizer.kind,
             "fused_leaves": list(art.fused_leaves), "raw_leaves": raw,
             "launches_per_step": want})
        vote0 = None
        check = label == "mode_b_nested"
        if check:
            p0 = params[FSDP_LEAF].clone()
            vote0 = fsdp_leaf_vote(torch, M, sc, cfg, tcfg, params, {
                "tokens": torch.as_tensor(pipe.global_batch_at(0)["tokens"],
                                          device=dev)}, FSDP_LEAF)
        launches, losses, step_ms, after0 = fsdp_step_loop(
            torch, label, art, params, state, pipe, steps, want, err,
            check_step0=check)
        peak = peak_bytes(torch, dev)
        line = {"phase": "fsdp_stacked_done", "run": label,
                "losses": losses, "step_ms": step_ms,
                "step_ms_median_1_on": statistics.median(step_ms[1:]
                                                         or step_ms),
                "max_memory_allocated_bytes": peak}
        if check:
            u0 = torch.zeros((1, p0.numel()), dtype=torch.float32,
                             device=dev)
            u_ref, _ = ref.momentum_sign_pack(vote0.view(1, -1), u0,
                                              tcfg.optimizer.momentum)
            u1, p1 = after0
            require_equal(f"fsdp {label} step 0 momentum of {FSDP_LEAF}",
                          u1.view(1, -1).view(torch.int32),
                          u_ref.view(torch.int32))
            p_ref = ref.apply_ternary_vote(
                p0.view(1, -1), ref.ternary_pack(u_ref),
                signum.lr_at(tcfg.optimizer, 0), tcfg.optimizer.weight_decay)
            require_equal(f"fsdp {label} step 0 of {FSDP_LEAF}",
                          p1.view(1, -1), p_ref)
            line["step0_vote"] = {
                "leaf": FSDP_LEAF, "coords": p0.numel(),
                "equal_to_plain_recomputation": True,
                "vote_values": sorted(float(v) for v in torch.unique(
                    vote0).tolist())[:17]}
            del p0, vote0, u0, u_ref, p_ref, u1, p1
        log(line)
        out[label] = {"losses": losses, "peak": peak}
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        del params, state, art, after0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    nested = out["mode_b_nested"]["losses"][:FSDP_DOTS_STEPS]
    if out["mode_b_dots"]["losses"] != nested:
        raise AssertionError(f"remat dots losses {out['mode_b_dots']} != "
                             f"nested {nested}")
    log({"phase": "fsdp_remat", "dots_losses_equal_nested": True,
         "peak_bytes": {k: v["peak"] for k, v in out.items()},
         "seconds": time.perf_counter() - t_start})
    return totals


def fsdp_mesh_config(torch, label: str, cfg=None):
    """Phase 15b's cut of the preset for run `label`."""
    from repro_torch.configs.base import ByzantineConfig
    full, preset = fsdp_config(torch, FSDP_MESH_LAYERS)
    changes = dict(FSDP_MESH_RUNS[[r[0] for r in FSDP_MESH_RUNS].index(
        label)][3])
    tcfg = dataclasses.replace(preset, microbatches=FSDP_MESH_MICRO,
                               global_batch=FSDP_MESH_BATCH)
    if "kind" in changes:
        tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
            tcfg.optimizer, kind=changes["kind"]))
    if "byzantine" in changes:
        mode, n = changes["byzantine"]
        tcfg = dataclasses.replace(tcfg, byzantine=ByzantineConfig(
            mode=mode, num_adversaries=n))
    return cfg or full, tcfg


def fsdp_slice_checksums(torch, art, params, state, shape) -> list:
    """Each rank's checksum of its slices of the stacked parameters and
    momentum (rank r holds data index r % data)."""
    from repro_torch.distributed import sharding as shd
    data = shape[-1]
    out = []
    for r in range(MESH_RANKS):
        p = shd.shard_tree(params, art.fused_dims, r % data, data)
        m = shd.shard_tree(state.get("momentum", {}), art.fused_dims,
                           r % data, data)
        out.append(mesh_state_checksum(torch, p, {"momentum": m}, None))
    return out


def fsdp_twin(torch, dev, cfg=None) -> dict:
    """Phase 15b's stacked twin (M = 4, the same cut): per run its losses,
    each rank's checksum of its slices and, for sgd, each voter's
    microbatch gradients of FSDP_LEAF (the mean's rounding bound) and the
    twin's FSDP_LEAF after the step."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    out = {}
    for label, shape, _, _, steps in FSDP_MESH_RUNS:
        cfg_, tcfg = fsdp_mesh_config(torch, label, cfg)
        art = TS.make_train_step(cfg_, tcfg, M_MAIN, device=dev)
        params, state = TS.materialize_state(
            cfg_, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        pipe = SyntheticLMPipeline(cfg_, tcfg.global_batch, tcfg.seq_len,
                                   seed=0)
        res = {"metrics": [], "ms": []}
        if tcfg.optimizer.kind == "sgd":
            tokens = torch.as_tensor(pipe.global_batch_at(0)["tokens"],
                                     device=dev)
            res["p0"] = params[FSDP_LEAF].clone()
            res["grads"] = fsdp_leaf_grads(torch, M, cfg_, tcfg, params,
                                           tokens, FSDP_LEAF)
        for step in range(steps):
            tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                     device=dev)
            sync(torch, dev)
            t0 = time.perf_counter()
            params, state, met = art.step_fn(params, state,
                                             {"tokens": tokens}, step)
            sync(torch, dev)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["metrics"].append({k: float(v) for k, v in met.items()})
        res["checksums"] = fsdp_slice_checksums(torch, art, params, state,
                                                shape)
        res["dims"] = dict(art.fused_dims)
        if tcfg.optimizer.kind == "sgd":
            res["p1"] = params[FSDP_LEAF].clone()
        out[label] = res
        log({"phase": "fsdp_twin", "run": label, "metrics": res["metrics"],
             "step_ms": res["ms"]})
        del params, state, art
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def fsdp_leaf_grads(torch, M, cfg, tcfg, params, tokens, leaf) -> list:
    """Each microbatch's gradients of `leaf` by each voter, [i][r], in the
    parameters' dtype (what the fused mean sums)."""
    per = tokens.shape[0] // M_MAIN
    rows = per // tcfg.microbatches
    out = []
    for i in range(tcfg.microbatches):
        row = []
        for r in range(M_MAIN):
            leaves = dict(params)
            leaves[leaf] = params[leaf].detach().requires_grad_()
            start = r * per + i * rows
            loss, _ = M.loss_fn(cfg, leaves,
                                {"tokens": tokens[start:start + rows]},
                                remat=tcfg.remat)
            row.append(torch.autograd.grad(loss, [leaves[leaf]])[0])
        out.append(row)
    return out


def fsdp_sgd_bound(torch, tcfg, twin, got_slice, d: int, data: int,
                   dim: int) -> dict:
    """A rank's FSDP_LEAF slice after sgd's step against the twin's: each
    microbatch's mean is a bf16 sum of the 4 voters' gradients in some
    order divided by 4 (:func:`mean_bound` from a float64 sum, for both
    the twin's and the mesh's sum), accumulated in float32 over the
    microbatches; the update moves by lr times it and rounds to bf16, so
    the two parameters differ by at most lr times both bounds plus one
    bf16 rounding of each (half an ulp of the larger magnitude)."""
    from repro_torch.distributed import sharding as shd

    def cut(t):
        return shd.shard_tree({"x": t}, {"x": dim}, d, data)["x"]
    lr = tcfg.optimizer.learning_rate
    slack = None
    for row in twin["grads"]:
        g64 = torch.stack([cut(g).double() for g in row])
        b = mean_bound(g64)
        slack = b if slack is None else slack + b
        del g64
    slack = 2 * lr * slack / len(twin["grads"])
    want = cut(twin["p1"]).double()
    got = torch.from_numpy(got_slice).view(torch.bfloat16).to(
        want.device).double()
    ulp = torch.maximum(want.abs(), got.abs()) * 2.0 ** -7
    err = (got - want).abs()
    bad = err > slack + ulp
    if bool(bad.any()):
        raise AssertionError(
            f"fsdp sgd rank slice {d}: {int(bad.sum())} elements off the "
            f"twin by more than the bound (max {float(err.max())})")
    return {"max_abs_diff": float(err.max()),
            "bound_max": float((slack + ulp).max()),
            "elements_bit_equal": int((err == 0).sum()),
            "elements": err.numel()}


def fsdp_mesh_bytes(cfg, label: str, shape, dims: dict, remat: bool,
                    shapes: dict = None, micro: int = FSDP_MESH_MICRO
                    ) -> dict:
    """The bytes each rank hands the collectives in one step of run
    `label`, counted from the layout: per microbatch and layer each fused
    leaf's bf16 slice gathered in the forward pass and again in the
    backward (remat), its whole cotangent reduce-scattered (int8 counts,
    or bf16 for the dense mean) and the count slice summed over pod; the
    other leaves on hierarchical (int8 counts padded to 32 x data, their
    pod sum and the packed all-gather) or, for sgd, all-reduced in float32
    (the accumulator's dtype); and per step the order check (16 B) and the
    metrics (12 B). `shapes` replaces the leaves' shapes (a rank's model
    blocks, phase 19d), `micro` the microbatches."""
    shapes = shapes or cfg.param_shapes()
    data = shape[-1]
    pod = shape[0] if len(shape) == 2 else 1
    sgd = label.startswith("sgd")
    fused = raw = 0
    for k, s in shapes.items():
        n = math.prod(s)
        if k in dims:
            per_layer = n // s[0]
            layer = 2 * (per_layer // data) * (2 if remat else 1)
            layer += per_layer * (2 if sgd else 1)
            if pod > 1:
                layer += per_layer // data * (2 if sgd else 1)
            fused += layer * s[0]
        elif sgd:
            raw += 4 * n
        else:
            pad = -(-n // (32 * data)) * 32 * data
            raw += pad + (pad // data if pod > 1 else 0) + pad // (8 * data)
    fused *= micro
    return {"analytic_bytes": fused + raw + 16 + 12,
            "analytic_fused_bytes": fused, "analytic_other_bytes": raw}


def fsdp_rank(rank: int, init: str, cfg, dev_type: str, queue) -> None:
    """One rank of phase 15b's world (a spawned process); puts ``(rank,
    results)`` on `queue`, or ``(rank, {"error": ...})``."""
    import traceback
    try:
        queue.put((rank, fsdp_rank_body(rank, init, cfg, dev_type)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def fsdp_rank_body(rank: int, init: str, cfg, dev_type: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core import sign_compress as sc
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.kernels import ops, ref
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=MESH_RANKS)
    try:
        meshes = {(shape, axes): ProcessMesh(shape, axes)
                  for _, shape, axes, _, _ in FSDP_MESH_RUNS}
        out = {"runs": {}, "max_abs_err": {}}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for label, shape, axes, _, steps in FSDP_MESH_RUNS:
            mesh = meshes[(shape, axes)]
            cfg_, tcfg = fsdp_mesh_config(torch, label, cfg)
            art = TS.make_train_step(cfg_, tcfg, device=dev, mesh=mesh)
            params, state = TS.materialize_state(
                cfg_, tcfg, art, torch.Generator(device=dev).manual_seed(0))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            pipe = SyntheticLMPipeline(cfg_, tcfg.global_batch, tcfg.seq_len,
                                       seed=0)
            raw = len(params) - len(art.fused_leaves)
            want = fsdp_launches(tcfg.optimizer.kind, raw,
                                 len(art.fused_leaves), 1, mesh=True)
            mets, rows, err, held = [], [], {}, {}
            for step in range(steps):
                tokens = torch.as_tensor(pipe.global_batch_at(step)[
                    "tokens"], device=dev)
                sync(torch, dev)
                mesh.reset_stats()
                ops.reset_launch_counts()
                checked = rank == 0 and step == 0
                t0 = time.perf_counter()
                with (plain_checked(torch, ops, ref, sc, err,
                                    f"fsdp mesh {label} rank 0 step {step}",
                                    MESH_CHECKED, held) if checked
                      else contextlib.nullcontext()):
                    params, state, met = art.step_fn(params, state,
                                                     {"tokens": tokens}, step)
                sync(torch, dev)
                ms = (time.perf_counter() - t0) * 1e3
                launches = {k: v for k, v in ops.launch_counts().items()
                            if v}
                if (launches or dev.type == "cuda") and launches != want:
                    raise AssertionError(
                        f"rank {rank} {label} step {step}: launches "
                        f"{launches}, expected {want}")
                if checked and dev.type == "cuda" and held != launches:
                    raise AssertionError(
                        f"{label}: rank 0 held {held} of the launches "
                        f"{launches} against their plain versions")
                mets.append({k: float(v) for k, v in met.items()})
                rows.append({"ms": ms,
                             "collective_ms": mesh.stats.seconds * 1e3,
                             "bytes": mesh.stats.bytes,
                             "collectives": mesh.stats.calls,
                             "launches": launches})
            res = {"metrics": mets, "steps": rows, "held": held,
                   "max_abs_err": err, "dims": dict(art.fused_dims),
                   "data_index": art.data_index,
                   "checksum": mesh_state_checksum(
                       torch, params, {"momentum": state.get("momentum",
                                                             {})}, None)}
            if dev.type == "cuda":
                res["peak_bytes"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            if tcfg.optimizer.kind == "sgd":
                # as numpy bits: a tensor on the queue would be shared
                # memory of a process that is about to end
                res["leaf"] = params[FSDP_LEAF].to("cpu").view(
                    torch.int16).numpy().copy()
            out["runs"][label] = res
            for k, v in err.items():
                out["max_abs_err"][k] = max(out["max_abs_err"].get(k, 0.0),
                                            v)
            del params, state, art
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if dev.type == "cuda":   # the largest run's (reset after each)
            out["peak_bytes"] = max(r["peak_bytes"]
                                    for r in out["runs"].values())
            out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def run_fsdp_mesh(torch, dev, errs, cfg=None, target=None) -> dict:
    """Phase 15b: the stacked twin of FSDP_MESH_RUNS, then 4 spawned ranks
    on `dev` over gloo running them with one voter each: every rank's
    losses equal the twin's, its checksum of its parameter and momentum
    slices equals the twin's slices' (Mode B), or its FSDP_LEAF slice is
    within the mean's rounding bound of the twin's (sgd); rank 0 holds
    every launch of each run's step 0 against its plain version. Returns
    the ranks' summed launches."""
    t_start = time.perf_counter()
    twin = fsdp_twin(torch, dev, cfg)
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log({"phase": "fsdp_twin_done", "seconds":
             time.perf_counter() - t_start,
             "device_free_bytes_before_ranks": free,
             "device_total_bytes": total})
    cfg_ = cfg if cfg is not None else fsdp_config(torch,
                                                   FSDP_MESH_LAYERS)[0]
    t_ranks = time.perf_counter()
    results = spawn_ranks(target or fsdp_rank, (cfg_, dev.type),
                          MESH_TIMEOUT_S)
    ranks_s = time.perf_counter() - t_ranks
    for k, v in results[0]["max_abs_err"].items():
        errs[k] = max(errs.get(k, 0.0), v)
    launches = {}
    for label, shape, axes, _, steps in FSDP_MESH_RUNS:
        _, tcfg = fsdp_mesh_config(torch, label, cfg)
        want = twin[label]
        sgd = tcfg.optimizer.kind == "sgd"
        if dev.type == "cuda" and not sgd and \
                not results[0]["runs"][label]["held"]:
            raise AssertionError(f"fsdp mesh {label}: rank 0 held no "
                                 "launch against its plain version")
        sgd_check = []
        for r in range(MESH_RANKS):
            got = results[r]["runs"][label]
            if got["metrics"] != want["metrics"]:
                raise AssertionError(
                    f"fsdp mesh {label} rank {r}: metrics {got['metrics']} "
                    f"!= the stacked twin's {want['metrics']}")
            if sgd:
                sgd_check.append(fsdp_sgd_bound(
                    torch, tcfg, want, got["leaf"], got["data_index"],
                    shape[-1], want["dims"][FSDP_LEAF]))
            elif got["checksum"] != want["checksums"][r]:
                raise AssertionError(
                    f"fsdp mesh {label} rank {r}: parameter / momentum "
                    "slices differ from the stacked twin's")
            for st in got["steps"]:
                for k, v in st["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        steps_ = [results[r]["runs"][label]["steps"] for r in range(
            MESH_RANKS)]
        per_step = [max(s[i]["ms"] for s in steps_) for i in range(steps)]
        coll = [max(s[i]["collective_ms"] for s in steps_)
                for i in range(steps)]
        counted = fsdp_mesh_bytes(cfg_, label, shape, want["dims"],
                                  tcfg.remat != "none")
        measured = [s[-1]["bytes"] for s in steps_]
        if any(b != counted["analytic_bytes"] for b in measured):
            raise AssertionError(
                f"fsdp mesh {label}: bytes per step by rank {measured} != "
                f"the layout's count {counted['analytic_bytes']}")
        line = {"phase": "fsdp_mesh_wire", "run": label, "mesh": list(shape),
                "axes": list(axes), "layers": FSDP_MESH_LAYERS,
                "microbatches": FSDP_MESH_MICRO,
                "global_batch": FSDP_MESH_BATCH,
                "bytes_per_step_by_rank": measured,
                "collectives_per_step_rank0": steps_[0][-1]["collectives"],
                **counted,
                "step_ms": per_step, "collective_ms": coll,
                "twin_step_ms": want["ms"],
                "losses": [m["loss"] for m in want["metrics"]],
                "held_vs_plain_rank0": results[0]["runs"][label]["held"],
                "peak_bytes_by_rank": [results[r]["runs"][label].get(
                    "peak_bytes") for r in range(MESH_RANKS)]}
        if sgd:
            line["sgd_leaf_vs_twin"] = sgd_check
        else:
            line["bit_equal_to_twin"] = True
        log(line)
    log({"phase": "fsdp_mesh_done", "ranks": MESH_RANKS, "backend": "gloo",
         "peak_bytes_by_rank": [results[r].get("peak_bytes")
                                for r in range(MESH_RANKS)],
         "peak_reserved_bytes_by_rank": [
             results[r].get("peak_reserved_bytes")
             for r in range(MESH_RANKS)],
         "phase14_peak_bytes_per_rank": 15.74e9,
         "ranks_seconds": ranks_s,
         "seconds": time.perf_counter() - t_start})
    return launches


def launcher(args, timeout_s: float = LAUNCH_TIMEOUT_S, **popen):
    """``python -m repro_torch.launch.train`` with `args`, from this
    checkout's ``src``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + list(args)
    if popen:
        return subprocess.Popen(cmd, env=env, cwd=here, text=True, **popen)
    return subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                          text=True, timeout=timeout_s)


def trace_losses(path) -> dict:
    from repro_torch.obs.recorder import read_trace
    return {r["step"]: r["loss"] for r in read_trace(path)
            if r["kind"] == "step"}


def kill_after_checkpoint(args, ckpt_dir: str, step: int) -> float:
    """Start the launcher and kill it (SIGKILL) as soon as the checkpoint
    of `step` is the latest in `ckpt_dir`; returns the seconds it ran.
    Raises if it ended before."""
    from repro_torch.checkpoint.checkpoint import latest_step_dir
    proc = launcher(args, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE)
    t0 = time.perf_counter()
    name = f"step_{step:08d}"
    try:
        while True:
            latest = latest_step_dir(ckpt_dir)
            if latest is not None and os.path.basename(latest) == name:
                proc.kill()
                break
            if proc.poll() is not None:
                raise AssertionError(
                    f"the launcher ended ({proc.returncode}) before its "
                    f"checkpoint of step {step}: {proc.stderr.read()[-2000:]}")
            if time.perf_counter() - t0 > LAUNCH_TIMEOUT_S:
                raise AssertionError(f"no checkpoint of step {step}")
            time.sleep(0.001)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        proc.stderr.close()
    return time.perf_counter() - t0


def launcher_launches(arch: str, steps: int) -> dict:
    """The full launcher run's launches: signSGD at one voter on psum_int8
    (AUTO at M = 1), per leaf and step the voter's ternary_pack, the tally
    and apply_ternary_vote."""
    from repro_torch.configs.base import get_config
    n = len(get_config(arch).param_shapes()) * steps
    return {"ternary_pack": n, "ternary_majority": n,
            "apply_ternary_vote": n}


def run_launcher_path(torch, dev, scratch: str, err,
                      full=LAUNCH_FULL) -> dict:
    """Phase 15c: the launcher on the card. In this process,
    ``repro_torch.launch.train.main`` with the full-depth glm4-9b signSGD
    flags: finite losses for every step, its launches exactly
    :func:`launcher_launches`, every one held against its plain version.
    Then, as subprocesses (``python -m repro_torch.launch.train``), the
    reduced run killed after its step-1 checkpoint and resumed to step 4,
    whose losses from step 2 on equal an uninterrupted run's. Returns the
    full run's launches."""
    import io
    import shutil
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch
    t0 = time.perf_counter()
    reset_peak(torch, dev)
    device = ["--device", dev.type]
    trace = os.path.join(scratch, "full.jsonl")
    printed, held = io.StringIO(), {}
    ops.reset_launch_counts()
    with plain_checked(torch, ops, ref, sc, err, "launcher", MESH_CHECKED,
                       held), contextlib.redirect_stdout(printed):
        rc = launch.main(list(full) + device + ["--trace", trace])
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    stdout = printed.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"launcher returned {rc}: {stdout[-20:]}")
    losses = trace_losses(trace)
    steps = int(full[full.index("--steps") + 1])
    if not all(math.isfinite(v) for v in losses.values()) or \
            sorted(losses) != list(range(steps)):
        raise AssertionError(f"launcher losses {losses}")
    want = launcher_launches(full[full.index("--arch") + 1], steps)
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"launcher launches {launches}, expected "
                             f"{want}")
    if dev.type == "cuda" and held != launches:
        raise AssertionError(f"launcher: held {held} of the launches "
                             f"{launches} against their plain versions")
    log({"phase": "launcher_full", "args": list(full), "losses": losses,
         "log": [ln for ln in stdout if ln.startswith("step ")],
         "launches": launches, "held_vs_plain": held,
         "max_memory_allocated_bytes": peak_bytes(torch, dev),
         "note": "in process; every launch held against its plain version "
                 "(step times include the checks)",
         "seconds": time.perf_counter() - t0})
    reduced = list(LAUNCH_REDUCED) + device
    # the uninterrupted run beside the killed and resumed ones (its own
    # trace and output file; the card holds both reduced models)
    whole_out = os.path.join(scratch, "a.out")
    with open(whole_out, "w") as f:
        whole = launcher(reduced + ["--trace",
                                    os.path.join(scratch, "a.jsonl")],
                         stdout=f, stderr=subprocess.STDOUT)
    try:
        ckpt = os.path.join(scratch, "ckpt")
        for attempt in range(3):
            shutil.rmtree(ckpt, ignore_errors=True)
            try:
                ran_s = kill_after_checkpoint(
                    reduced + ["--ckpt-dir", ckpt, "--ckpt-every", "2"],
                    ckpt, 1)
                break
            except AssertionError:
                if attempt == 2:
                    raise
        resumed = launcher(reduced + ["--ckpt-dir", ckpt, "--ckpt-every", "2",
                                      "--trace", os.path.join(scratch,
                                                              "b.jsonl")])
        if resumed.returncode != 0 or "restored checkpoint at step 1" not in \
                resumed.stdout:
            raise AssertionError(f"resume exit {resumed.returncode}:\n"
                                 f"{resumed.stdout[-2000:]}\n"
                                 f"{resumed.stderr[-4000:]}")
        if whole.wait(timeout=LAUNCH_TIMEOUT_S) != 0:
            with open(whole_out) as f:
                raise AssertionError(f"launcher exit {whole.returncode}:\n"
                                     f"{f.read()[-4000:]}")
    finally:
        if whole.poll() is None:
            whole.kill()
            whole.wait()
    a = trace_losses(os.path.join(scratch, "a.jsonl"))
    b = trace_losses(os.path.join(scratch, "b.jsonl"))
    if sorted(b) != [2, 3] or any(b[s] != a[s] for s in b):
        raise AssertionError(f"resumed losses {b} != uninterrupted {a}")
    log({"phase": "launcher_resume", "uninterrupted": a, "resumed": b,
         "killed_after_s": ran_s, "attempts": attempt + 1,
         "seconds": time.perf_counter() - t0})
    return launches


def run_fsdp_path(torch, dev, errs) -> dict:
    """Phase 15 (a, b, c); returns their launches."""
    import tempfile
    launches = run_fsdp_stacked(torch, dev, errs)
    for k, v in run_fsdp_mesh(torch, dev, errs).items():
        launches[k] = launches.get(k, 0) + v
    with tempfile.TemporaryDirectory() as scratch:
        for k, v in run_launcher_path(torch, dev, scratch, errs).items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ---------------------------------------------------------------------------
# phase 16: the decoder-only model zoo's presets at seq 4096
# ---------------------------------------------------------------------------

#: phase 16's archs: (arch, depth, the leaf whose step-0 vote is recomputed
#: by plain PyTorch). Every published width, seq 4096; depth cut by memory
#: (gemma3 keeps one whole 5:1 local / global period)
#: (depths cut for the script's time since phase 19 joined it: pixtral,
#: qwen2-moe and deepseek 2 -> 1 layer)
ZOO = (("gemma3-12b", 6, "layers.attn_wq"),
       ("pixtral-12b", 1, "layers.attn_wq"),
       ("qwen2-moe-a2.7b", 1, "layers.experts_w_down"),
       ("qwen3-moe-235b-a22b", 1, "layers.experts_w_gate"),
       ("deepseek-67b", 1, "layers.attn_wq"))
#: steps 0..ZOO_STEPS-1, step 0 run twice: two steps of compute an arch
#: (cut from 4 so that the phase stays under about 4 minutes, and from 2
#: for the script's time once phase 19d-19f joined it: step 0 twice,
#: bit-equal, stays)
ZOO_SEQ, ZOO_STEPS = 4096, 1
#: the arch whose step 3 runs under torch.profiler
ZOO_PROFILED = "qwen2-moe-a2.7b"
#: chunked against unchunked attention at gemma3's full width: bf16 q, k,
#: v of (1, ZOO_SEQ, 16 / 8 heads, 256); output and gradients within this
#: many bf16 ulps (2^-8 relative) of the largest magnitude (the chunked dk
#: and dv are bf16 sums of the 4 chunks' parts, one rounding per add)
ATTN_ULPS = 4


def zoo_config(torch, arch: str, depth: int):
    """`arch` at every published width, `depth` layers, and its preset at
    train_4k (seq 4096) with the batch cut to one row a voter a
    microbatch."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.configs.presets import (MODE_B_ARCHS,
                                             default_train_config)
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    preset = default_train_config(arch, ShapeCell("train_4k", ZOO_SEQ, 256,
                                                  "train"))
    tcfg = dataclasses.replace(
        preset, global_batch=M_MAIN * preset.microbatches)
    opt = tcfg.optimizer
    want = (("signsgd_vote", "hierarchical", "nested", True)
            if arch in MODE_B_ARCHS else
            ("signum_vote", "psum_int8", "full", False))
    got = (opt.kind, opt.vote_strategy.value, tcfg.remat, tcfg.fsdp)
    if got != want or tcfg.seq_len != ZOO_SEQ:
        raise AssertionError(f"{arch}: not the reference's preset: {tcfg}")
    return cfg, tcfg


def zoo_batch(torch, cfg, tcfg, step: int, dev) -> dict:
    """A seeded batch of `step`: tokens and, for the VLM, the image
    prefix's patch embeddings (a quarter of the sequence), for the
    encoder-decoder the encoder's frames (min(T_src, 64) of them in the
    model's dtype, as the reference's make_batch), made on the card (the
    numpy pipeline draws one token at a time)."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(1000 + step)
    rows, seq = tcfg.global_batch, tcfg.seq_len
    out = {}
    if cfg.family == ArchFamily.VLM:
        s_img, seq = M._vlm_split(seq)
        out["patch_embeds"] = torch.randn((rows, s_img, cfg.d_model),
                                          generator=gen, device=dev)
    if cfg.family == ArchFamily.AUDIO:
        t_src = min(cfg.max_source_positions, 64)
        out["enc_embeds"] = torch.randn(
            (rows, t_src, cfg.d_model), generator=gen,
            device=dev).to(getattr(torch, cfg.dtype))
    out["tokens"] = torch.randint(0, cfg.vocab_size, (rows, seq),
                                  generator=gen, device=dev)
    return out


@contextlib.contextmanager
def recorded_tallies(torch, ops, sink: list, keep: int = -1):
    """Within the block every ``ops.ternary_majority`` output's checksum is
    appended to `sink` (call order: the optimizer's leaf order), and the
    output of call number `keep` itself."""
    orig = ops.ternary_majority

    def tally(packed, *, ties="zero", out=None):
        got = orig(packed, ties=ties, out=out)
        if len(sink) == keep:
            sink.append(got.clone())
        else:
            sink.append(device_checksum(torch, [got]))
        return got
    ops.ternary_majority = tally
    try:
        yield
    finally:
        ops.ternary_majority = orig


def zoo_step0_check(torch, M, cfg, tcfg, art, params, batch, leaf):
    """The plain recomputation of `leaf`'s step 0, made before the step:
    Mode A, each voter's accumulated gradient; Mode B with fsdp, the fused
    leaf's accumulated vote. Returns (a copy of the leaf, the
    recomputation)."""
    from repro_torch.core import sign_compress as sc
    p0 = params[leaf].clone()
    if leaf in art.fused_dims:
        return p0, fsdp_leaf_vote(torch, M, sc, cfg, tcfg, params, batch,
                                  leaf)
    if art.fused_dims:
        raise AssertionError(f"{leaf} is not a fused leaf")
    return p0, preset_leaf_grads(torch, M, cfg, tcfg, params, batch, leaf)


def zoo_step0_verify(torch, ref, signum, tcfg, art, leaf, saved, params,
                     state, vote) -> dict:
    """`leaf` after step 0 against the plain versions run on the plain
    recomputation: Mode A, each voter's momentum row (bf16 or float32, as
    the preset has it, from zeros), the count wire's vote (`vote`, the
    step's own tally output of the leaf) and the parameters; Mode B, the
    float32 momentum taking the fused vote and the parameters."""
    opt = tcfg.optimizer
    eta = signum.lr_at(opt, 0)
    p0, plain = saved
    if leaf in art.fused_dims:
        u0 = torch.zeros((1, p0.numel()), dtype=torch.float32,
                         device=p0.device)
        u_ref, _ = ref.momentum_sign_pack(plain.view(1, -1), u0,
                                          opt.momentum)
        require_equal(f"zoo {leaf} step 0 momentum",
                      state["momentum"][leaf].view(1, -1).view(torch.int32),
                      u_ref.view(torch.int32))
        p_ref = ref.apply_ternary_vote(p0.view(1, -1), ref.ternary_pack(
            u_ref), eta, opt.weight_decay)
        require_equal(f"zoo {leaf} step 0 parameters",
                      params[leaf].view(1, -1), p_ref)
        return {"leaf": leaf, "coords": p0.numel(), "fused": True,
                "vote_values": sorted(float(v) for v in torch.unique(
                    plain).tolist())[:17]}
    mom = state["momentum"][leaf].view(M_MAIN, -1)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[
        mom.dtype]
    words = []
    for r in range(M_MAIN):
        g = plain[r].reshape(1, -1)
        m_ref, _ = ref.momentum_sign_pack(
            g, torch.zeros(g.shape, dtype=mom.dtype, device=g.device),
            opt.momentum)
        require_equal(f"zoo {leaf} step 0 momentum of voter {r}",
                      mom[r].view(1, -1).view(bits), m_ref.view(bits))
        words.append(ref.ternary_pack(m_ref)[0])
    vote_ref = ref.ternary_majority(torch.stack(words))
    require_equal(f"zoo {leaf} step 0 vote", vote, vote_ref)
    p_ref = ref.apply_ternary_vote(p0.view(1, -1), vote_ref[None], eta,
                                   opt.weight_decay)
    require_equal(f"zoo {leaf} step 0 parameters", params[leaf].view(1, -1),
                  p_ref)
    return {"leaf": leaf, "coords": p0.numel(), "fused": False,
            "vote_words": vote.numel()}


def run_zoo_arch(torch, dev, err, arch: str, depth: int, leaf: str,
                 cfg=None, phase_name: str = "zoo", profiled: bool = None
                 ) -> dict:
    """One arch of phase 16 (or 17b, `phase_name` "family"): the preset's step 0
    from a fresh state with every launch held against its plain version
    and `leaf` against its plain recomputation, step 0 again from the same
    state (losses, tally outputs, parameters and momenta bit-equal), then
    steps 1.. ZOO_STEPS-1; exact launches, s/step (the mean of the
    unchecked runs: step 0 again and the later steps), peak memory, and
    when `profiled` (default: `arch` is ZOO_PROFILED) one more step under
    torch.profiler. Returns the launches."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import signum
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    t0 = time.perf_counter()
    full, tcfg = zoo_config(torch, arch, depth)
    cfg = cfg or full
    reset_peak(torch, dev)
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)

    def fresh():
        return TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    params, state = fresh()
    n_leaves, fused = len(params), len(art.fused_leaves)
    mode_b = bool(fused)
    want = (fsdp_launches(tcfg.optimizer.kind, n_leaves - fused, fused,
                          M_MAIN, mesh=False) if mode_b
            else preset_launches(n_leaves))
    log({"phase": phase_name, "arch": arch, "family": cfg.family.value,
         "num_layers": cfg.num_layers, "d_model": cfg.d_model,
         "vocab": cfg.vocab_size, "params": cfg.param_count(),
         "voters": M_MAIN, "global_batch": tcfg.global_batch,
         "seq": tcfg.seq_len, "microbatches": tcfg.microbatches,
         "remat": tcfg.remat, "fsdp": tcfg.fsdp,
         "kind": tcfg.optimizer.kind,
         "momentum_dtype": tcfg.optimizer.momentum_dtype,
         "vote_strategy": tcfg.optimizer.vote_strategy.value,
         "fused_leaves": list(art.fused_leaves),
         "local_layers": list(cfg.local_layer_mask()),
         "moe": dataclasses.asdict(cfg.moe) if cfg.moe.enabled else None,
         "launches_per_step": want})
    batches = [zoo_batch(torch, cfg, tcfg, s, dev) for s in range(ZOO_STEPS)]
    saved = zoo_step0_check(torch, M, cfg, tcfg, art, params, batches[0],
                            leaf)
    # the check leaf's tally call: the optimizer tallies the unfused leaves
    # in the parameters' order
    keep = -1 if mode_b else list(params).index(leaf)
    total, runs, step_ms = {}, [], []
    for label in ("step0_checked", "step0_again"):
        if label == "step0_again":
            del params, state
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            params, state = fresh()
        tallies, held = [], {}
        ops.reset_launch_counts()
        sync(torch, dev)
        t1 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if label == "step0_checked":
                stack.enter_context(plain_checked(
                    torch, ops, ref, sc, err, f"{phase_name} {arch} step 0",
                    MESH_CHECKED, held))
            stack.enter_context(recorded_tallies(torch, ops, tallies, keep))
            params, state, met = art.step_fn(params, state, batches[0], 0)
        sync(torch, dev)
        ms = (time.perf_counter() - t1) * 1e3
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        mets = {k: float(v) for k, v in met.items()}
        if (launches or dev.type == "cuda") and launches != want:
            raise AssertionError(f"{phase_name} {arch} {label}: launches {launches}, "
                                 f"expected {want}")
        if label == "step0_checked" and dev.type == "cuda" and \
                held != launches:
            raise AssertionError(f"{phase_name} {arch}: held {held} of the launches "
                                 f"{launches} against their plain versions")
        if not all(math.isfinite(v) for v in mets.values()):
            raise AssertionError(f"{phase_name} {arch} {label}: metrics {mets}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if label == "step0_again":
            step_ms.append(ms)
        line = {"run": label, "arch": arch, "step": 0, "metrics": mets,
                "ms": ms, "launches": launches, "held_vs_plain": held}
        vote = None
        if keep >= 0:
            vote = tallies[keep]
            tallies[keep] = device_checksum(torch, [vote])
        runs.append({"metrics": mets, "tallies": tallies,
                     "params": device_checksum(torch, params.values()),
                     "momentum": device_checksum(
                         torch, state["momentum"].values())})
        if label == "step0_checked":
            line["step0_vote"] = zoo_step0_verify(
                torch, ref, signum, tcfg, art, leaf, saved, params, state,
                vote)
            del saved, vote
        log(line)
    if runs[0] != runs[1]:
        raise AssertionError(f"{phase_name} {arch}: step 0 twice from one state "
                             f"differs: {runs[0]} != {runs[1]}")
    log({"phase": f"{phase_name}_deterministic", "arch": arch, "step": 0,
         "metrics": runs[0]["metrics"], "tallies": len(runs[0]["tallies"]),
         "bit_equal": ["metrics", "tallies", "params", "momentum"]})
    losses = [runs[0]["metrics"]]
    for step in range(1, ZOO_STEPS):
        ops.reset_launch_counts()
        sync(torch, dev)
        t1 = time.perf_counter()
        params, state, met = art.step_fn(params, state, batches[step], step)
        sync(torch, dev)
        ms = (time.perf_counter() - t1) * 1e3
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        mets = {k: float(v) for k, v in met.items()}
        log({"run": phase_name, "arch": arch, "step": step, "metrics": mets,
             "ms": ms, "launches": launches})
        if (launches or dev.type == "cuda") and launches != want:
            raise AssertionError(f"{phase_name} {arch} step {step}: launches "
                                 f"{launches}, expected {want}")
        if not all(math.isfinite(v) for v in mets.values()):
            raise AssertionError(f"{phase_name} {arch} step {step}: {mets}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        losses.append(mets)
        step_ms.append(ms)
    peak = peak_bytes(torch, dev)
    log({"phase": f"{phase_name}_done", "arch": arch, "metrics": losses,
         "step_ms": step_ms, "s_per_step": statistics.mean(step_ms) / 1e3,
         "max_memory_allocated_bytes": peak,
         "seconds": time.perf_counter() - t0})
    if profiled is None:
        profiled = arch == ZOO_PROFILED
    if profiled and dev.type == "cuda":
        class Batches:
            @staticmethod
            def global_batch_at(step):
                return zoo_batch(torch, cfg, tcfg, step, dev)
        f32m = tcfg.optimizer.momentum_dtype == "float32" and not mode_b
        profile_step(torch, art, params, state, Batches, dev,
                     cfg.param_count(), statistics.median(step_ms),
                     "preset_f32m" if f32m else "preset")
    del params, state, art, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return total


def check_zoo_attention(torch, dev) -> None:
    """gemma3's attention at full width and S = ZOO_SEQ, a local (window
    1024) and a global layer: the chunked path (q_chunk 1024) against the
    unchunked plain product on the same bf16 q, k, v, output and
    gradients within ATTN_ULPS bf16 ulps of each one's largest magnitude,
    each path's peak memory above the inputs beside it."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_config("gemma3-12b")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S, hd = 1, ZOO_SEQ, cfg.resolved_head_dim
    shapes = ((B, S, cfg.num_heads, hd), (B, S, cfg.num_kv_heads, hd),
              (B, S, cfg.num_kv_heads, hd))
    qkv = [torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
           for s in shapes]
    cot = torch.randn(shapes[0], generator=gen, device=dev).to(
        torch.bfloat16)
    out = {}
    for is_local in (True, False):
        window = T._window_for(cfg, is_local, S)
        res = {}
        for label, q_chunk in (("chunked", L.Q_CHUNK), ("unchunked", S)):
            xs = [t.detach().requires_grad_() for t in qkv]
            reset_peak(torch, dev)
            base = (torch.cuda.memory_allocated() if dev.type == "cuda"
                    else 0)
            o = L.attention(*xs, window=window, q_chunk=q_chunk)
            grads = torch.autograd.grad(o, xs, cot)
            sync(torch, dev)
            peak = peak_bytes(torch, dev)
            res[label] = ([o.detach()] + list(grads),
                          None if peak is None else peak - base)
        diffs = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), res["chunked"][0],
                              res["unchunked"][0]):
            diff = float((a.float() - b.float()).abs().max())
            tol = ATTN_ULPS * 2.0 ** -8 * float(b.float().abs().max())
            if not diff <= tol:
                raise AssertionError(f"chunked attention {name} "
                                     f"(window {window}): {diff} > {tol}")
            diffs[name] = {"max_abs_diff": diff, "tolerance": tol}
        out["local" if is_local else "global"] = {
            "window": window, "diffs": diffs,
            "peak_bytes_chunked": res["chunked"][1],
            "peak_bytes_unchunked": res["unchunked"][1]}
        del res
    log({"phase": "zoo_attention", "arch": "gemma3-12b", "seq": S,
         "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
         "head_dim": hd, "q_chunk": L.Q_CHUNK, **out})


def run_zoo_path(torch, dev, err, profiled=ZOO_PROFILED) -> dict:
    """Phase 16: the chunked attention check, then each ZOO arch's preset
    (``run_zoo_arch``), the arch `profiled` (None: none) with one more
    step under torch.profiler. Returns the launches, Mode A's
    bf16-momentum momentum_sign_pack as ``momentum_sign_pack_bf16m``."""
    t0 = time.perf_counter()
    check_zoo_attention(torch, dev)
    launches = {}
    for arch, depth, leaf in ZOO:
        got = run_zoo_arch(torch, dev, err, arch, depth, leaf,
                           profiled=arch == profiled)
        if "ternary_majority" in got:   # Mode A: bf16 momentum
            got["momentum_sign_pack_bf16m"] = got.pop("momentum_sign_pack")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    log({"phase": "zoo_path_done", "launches": launches,
         "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# phase 17: the priced wire (17a) and the SSM, hybrid and encoder-decoder
# families' presets at seq 4096 (17b)
# ---------------------------------------------------------------------------

#: 17a: steps of each trainer run (the AUTO run and its named twin)
WIRE_STEPS = 2
#: 17a: the codecs whose votes of the trained momentum take AUTO
AUTO_CODECS = ("sign1bit", "ef_sign", "ternary2bit", "weighted_vote")
#: 17b's archs: (arch, depth, the leaf whose step-0 vote is recomputed by
#: plain PyTorch). Every published width, seq 4096. Depth is cut for the
#: phase's time, not by memory: at full depth mamba2 (64 layers, 64.0 GB)
#: took 19.0 s a step and zamba2 (38, 27.6 GB) 15.6 s on an H100 80GB at
#: 700 W (PERF.md §5, scripts/family_probe.py). zamba2 keeps one whole
#: segment of 6 mamba layers and its shared block, then a ragged segment of
#: 2 without one, as its last segment
#: (cut for the script's time since phase 19 joined it: mamba2-2.7b 8 ->
#: 4 layers, whisper-tiny's decoder 4 -> 2 layers, its encoder's 4 kept)
FAMILIES = (("mamba2-2.7b", 4, "layers.mamba_A_log"),
            ("zamba2-1.2b", 8, "shared_block.attn_wq"),
            ("whisper-tiny", 2, "layers.xattn_wq"))
#: the arch whose next step runs under torch.profiler
FAMILY_PROFILED = "mamba2-2.7b"


def wire_config(**opt):
    """Phase 3's training config (sign1bit, float32 momentum) with the
    optimizer options `opt`."""
    base = train_config("sign1bit")
    return dataclasses.replace(base, optimizer=dataclasses.replace(
        base.optimizer, **opt))


def wire_run(torch, cfg, dev, tcfg, steps, record=None):
    """`steps` steps of phase 3's cell under `tcfg` from a fresh state
    (seeded as phase 3): each step's launches, the losses, and checksums of
    the parameters and the momentum after the run. With `record` (an
    ``obs.TraceRecorder``) every step runs under it, with a ``train.step``
    span and a step row carrying the plan's wire payload. Returns (a dict
    of those, the momentum)."""
    from repro_torch.core import codecs
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.obs import recorder as obs
    from repro_torch.train import train_step as TS
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
    params, state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    pipe = SyntheticLMPipeline(cfg, GLOBAL_BATCH, SEQ, seed=0)
    out = {"vote_strategy": art.vote_strategy.value, "losses": [],
           "launches": [], "ms": []}
    if record is not None and art.plan is None:
        raise ValueError("a recorded wire run reports its plan's payload")
    if art.plan is not None:
        out["groups"] = [{"codec": g.codec, "strategy": g.strategy.value,
                          "bucket_bytes": g.bucket_bytes,
                          "buckets": len(g.buckets)}
                         for g in art.plan.groups]
        out["schedule_cost_s"] = art.plan.schedule_cost(
            M_MAIN, 1, overlap=tcfg.optimizer.overlap)
        payload = sum(g.total * codecs.get_codec(g.codec).wire_bits(
            g.strategy) / 8.0 for g in art.plan.groups)
    with contextlib.ExitStack() as stack:
        if record is not None:
            stack.enter_context(obs.recording(record))
        for step in range(steps):
            tokens = torch.as_tensor(pipe.global_batch_at(step)["tokens"],
                                     device=dev)
            ops.reset_launch_counts()
            sync(torch, dev)
            t0 = time.perf_counter()
            with obs.get_recorder().span("train.step", step=step):
                params, state, met = art.step_fn(params, state,
                                                 {"tokens": tokens}, step)
                loss = float(met["loss"])
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append(
                {k: v for k, v in ops.launch_counts().items() if v})
            if not math.isfinite(loss):
                raise AssertionError(f"wire step {step}: loss {loss}")
            out["losses"].append(loss)
            if record is not None:
                record.step(kind_detail="train", step=step, loss=loss,
                            payload_bytes=payload,
                            n_coords=art.plan.n_params, n_voters=M_MAIN)
    out["params"] = device_checksum(torch, [params[k]
                                            for k in sorted(params)])
    out["momentum"] = device_checksum(
        torch, [state["momentum"][k] for k in sorted(params)])
    momentum = state["momentum"]
    del params, state, art
    return out, momentum


def require_twins(what: str, auto: dict, named: dict) -> None:
    """The AUTO run and the run naming its choice: losses, launches,
    parameters and momentum equal."""
    for k in ("losses", "launches", "params", "momentum"):
        if auto[k] != named[k]:
            raise AssertionError(f"{what}: AUTO's {k} {auto[k]} differ from "
                                 f"the named wire's {named[k]}")


def run_auto_trainer(torch, cfg, dev) -> tuple:
    """17a's trainer: ``vote_strategy=auto`` at phase 3's cell resolves to
    select_strategy's wire for the parameter count over M_MAIN voters, and
    its WIRE_STEPS steps are bit-equal to the run that names that wire.
    Returns (the AUTO run's launches, the named run's momentum)."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import vote_engine as ve
    want = ve.select_strategy(cfg.param_count(), M_MAIN, 1, "sign1bit")
    auto, momentum = wire_run(torch, cfg, dev, wire_config(
        vote_strategy=VoteStrategy.AUTO), WIRE_STEPS)
    del momentum
    torch.cuda.empty_cache()
    if auto["vote_strategy"] != want.value:
        raise AssertionError(f"the trainer resolved AUTO to "
                             f"{auto['vote_strategy']}, select_strategy "
                             f"gives {want.value}")
    named, momentum = wire_run(torch, cfg, dev, wire_config(
        vote_strategy=want), WIRE_STEPS)
    require_twins("trainer at auto", auto, named)
    log({"phase": "auto_trainer", "params": cfg.param_count(),
         "voters": M_MAIN, "resolved": auto["vote_strategy"],
         "losses": auto["losses"], "launches_per_step": auto["launches"],
         "step_ms_auto": auto["ms"], "step_ms_named": named["ms"],
         "bit_equal_to_named": ["losses", "launches", "params",
                                "momentum"]})
    return auto["launches"], momentum


def run_auto_votes(torch, momentum, dev) -> dict:
    """17a's votes: every leaf's trained (M, n) momentum through the vote
    API's default strategy (AUTO) on each codec of AUTO_CODECS; the wire it
    reports is select_strategy's for the leaf's size over M_MAIN voters
    under the port's link model, and the votes (and weighted_vote's flip
    rates) equal the same request naming that wire. Returns the AUTO
    votes' launches."""
    from repro_torch.core import vote_api as va
    from repro_torch.core import vote_engine as ve
    from repro_torch.kernels import ops
    backend = va.VirtualBackend(device=dev)
    payloads = {k: v.view(v.shape[0], -1) for k, v in momentum.items()}
    totals = {}
    for codec in AUTO_CODECS:
        wires, ms = {}, 0.0
        for leaf, x in payloads.items():
            state = ({"flip_ema": torch.zeros(M_MAIN, device=dev)}
                     if codec == "weighted_vote" else None)
            want = ve.select_strategy(x.shape[1], M_MAIN, 1, codec)
            ops.reset_launch_counts()
            sync(torch, dev)
            t0 = time.perf_counter()
            auto = backend.execute(va.VoteRequest(
                payload=x, form="stacked", codec=codec, server_state=state))
            sync(torch, dev)
            ms += (time.perf_counter() - t0) * 1e3
            for k, v in ops.launch_counts().items():
                totals[k] = totals.get(k, 0) + v
            named = backend.execute(va.VoteRequest(
                payload=x, form="stacked", codec=codec, strategy=want,
                server_state=state))
            if auto.wire.strategy != want or auto.wire != named.wire:
                raise AssertionError(f"{codec} {leaf}: AUTO's wire "
                                     f"{auto.wire}, named {named.wire}")
            require_equal(f"{codec} {leaf}: AUTO's votes and the named "
                          f"{want.value} wire's", auto.votes, named.votes)
            for k, v in named.server_state.items():
                require_equal(f"{codec} {leaf}: {k}", auto.server_state[k],
                              v)
            wires[want.value] = wires.get(want.value, 0) + 1
            del auto, named
        log({"phase": "auto_votes", "codec": codec, "leaves": len(payloads),
             "voters": M_MAIN, "wires": wires, "ms": ms,
             "bit_equal_to_named": True})
    return totals


#: 17a's plan: the embeddings on ternary2bit, the rest on sign1bit
AUTO_PLAN_MAP = (("embed*", "ternary2bit"),)


def run_auto_plan(torch, cfg, dev) -> dict:
    """17a's plan: the trainer with ``bucket_bytes=-1`` (the priced ladder),
    AUTO, overlap on and AUTO_PLAN_MAP, WIRE_STEPS steps under a
    TraceRecorder, bit-equal to the run whose plan names the resolved
    values (the groups' strategy, and a bucket size that cuts every group
    as AUTO did: the same buckets, checked); each group's resolved
    (strategy, bucket_bytes) and the schedule's cost printed; the trace
    rendered by the port's report, every section present and every bucket
    with a predicted exchange; the summed measured (host spans on one
    card, not a link) and predicted exchange. Returns the AUTO run's
    launches."""
    import tempfile
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core import vote_plan as vp
    from repro_torch.obs import recorder as obs
    from repro_torch.obs import report
    scratch = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    path = os.path.join(scratch, "auto_plan.jsonl")
    rec = obs.TraceRecorder(path, meta={"phase": "17a", "arch": cfg.name})
    opts = dict(codec_map=AUTO_PLAN_MAP, overlap=True)
    auto_plan = vp.build_plan(
        cfg.param_shapes(), bucket_bytes=vp.AUTO_BUCKET_BYTES,
        codec_map=AUTO_PLAN_MAP, strategy=VoteStrategy.AUTO,
        data_size=M_MAIN, overlap=True)
    strategies = {g.strategy for g in auto_plan.groups}
    if len(strategies) != 1:
        raise AssertionError(f"the AUTO plan's groups resolve "
                             f"{strategies}: no single named wire")
    named_bytes = max(g.bucket_bytes for g in auto_plan.groups)
    named_plan = vp.build_plan(
        cfg.param_shapes(), bucket_bytes=named_bytes,
        codec_map=AUTO_PLAN_MAP, strategy=next(iter(strategies)),
        data_size=M_MAIN, overlap=True)
    if named_plan.buckets != auto_plan.buckets:
        raise AssertionError("the named plan cuts other buckets")
    auto, momentum = wire_run(torch, cfg, dev, wire_config(
        vote_strategy=VoteStrategy.AUTO, bucket_bytes=vp.AUTO_BUCKET_BYTES,
        **opts), WIRE_STEPS, record=rec)
    rec.close()
    del momentum
    torch.cuda.empty_cache()
    named, momentum = wire_run(torch, cfg, dev, wire_config(
        vote_strategy=next(iter(strategies)), bucket_bytes=named_bytes,
        **opts), WIRE_STEPS)
    del momentum
    torch.cuda.empty_cache()
    require_twins("plan at auto", auto, named)
    text = report.render(path)
    summary = report.summarize(path)
    missing = [s for s in report.SECTIONS if f"== {s} ==" not in text]
    buckets = summary["buckets"]
    if missing or len(buckets) != auto_plan.n_buckets or any(
            b["predicted_s"] is None for b in buckets):
        raise AssertionError(
            f"the report of the AUTO plan's trace: sections missing "
            f"{missing}, buckets {len(buckets)} of {auto_plan.n_buckets}, "
            f"predictions {[b['predicted_s'] for b in buckets]}")
    issues = [r for r in obs.read_trace(path) if r["kind"] == "span"
              and r["name"] == "plan.issue"]
    if not issues or any(r["attrs"]["pred_s"] is None for r in issues):
        raise AssertionError("a plan.issue span without pred_s")
    log({"phase": "auto_plan", "codec_map": AUTO_PLAN_MAP,
         "groups": auto["groups"], "named_bucket_bytes": named_bytes,
         "schedule_cost_s": auto["schedule_cost_s"],
         "schedule_cost_s_no_overlap": auto_plan.schedule_cost(M_MAIN),
         "losses": auto["losses"], "launches_per_step": auto["launches"],
         "step_ms_auto": auto["ms"], "step_ms_named": named["ms"],
         "bit_equal_to_named": ["losses", "launches", "params", "momentum"],
         "report_sections": list(report.SECTIONS),
         "plan_issue_spans": len(issues),
         "measured_exchange_s_sum": sum(b["measured_s"] for b in buckets),
         "predicted_exchange_s_sum": sum(b["predicted_s"] for b in buckets),
         "measured_is": "host spans of the walk on one card, not a link",
         "schedules": [{k: w[k] for k in ("n_buckets", "overlap", "wall_s",
                                          "issue_occ", "complete_occ",
                                          "gap")}
                       for w in summary["schedules"]],
         "steps": {k: v for k, v in summary["steps"].items()
                   if k != "rows"}})
    print(text, flush=True)
    return auto["launches"]


def run_wire_path(torch, cfg, dev) -> dict:
    """Phase 17a: the trainer at AUTO, the vote API's AUTO on each codec of
    the trained momentum, and the AUTO plan with its trace report. Returns
    the launches."""
    t0 = time.perf_counter()
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    steps, momentum = run_auto_trainer(torch, cfg, dev)
    for s in steps:
        add(s)
    add(run_auto_votes(torch, momentum, dev))
    del momentum
    torch.cuda.empty_cache()
    for s in run_auto_plan(torch, cfg, dev):
        add(s)
    log({"phase": "wire_path_done", "launches": totals,
         "seconds": time.perf_counter() - t0})
    return totals


def run_family_path(torch, dev, err, profiled=FAMILY_PROFILED) -> dict:
    """Phase 17b: each FAMILIES arch's preset (``run_zoo_arch``, the
    family's float32 momentum on psum_int8), the arch `profiled` (None:
    none) with one more step under torch.profiler. Returns the
    launches."""
    t0 = time.perf_counter()
    launches = {}
    for arch, depth, leaf in FAMILIES:
        got = run_zoo_arch(torch, dev, err, arch, depth, leaf,
                           phase_name="family",
                           profiled=arch == profiled)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    log({"phase": "family_path_done", "launches": launches,
         "seconds": time.perf_counter() - t0})
    return launches


def run_phase17(torch, cfg, dev, err, profiled=FAMILY_PROFILED) -> dict:
    """Phase 17 (a, b): returns their launches."""
    t0 = time.perf_counter()
    launches = run_wire_path(torch, cfg, dev)
    for k, v in run_family_path(torch, dev, err, profiled).items():
        launches[k] = launches.get(k, 0) + v
    log({"phase": "phase17_done", "launches": launches,
         "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# phase 18: serving on the card
# ---------------------------------------------------------------------------

#: 18a: glm4-9b at every published width, depth 40 -> 20 (cut for the
#: script's time when phase 20 joined it) -> 4 (when 19h and 19f's FSDP
#: runs joined it), behind the continuous engine
SERVE_MAIN_DEPTH = 4
SERVE_MAIN = dict(n_slots=8, max_len=1024, prompt_pad=512, admit="prefill",
                  prefill_buckets=(128, 256, 512))
SERVE_TRAFFIC = dict(n_requests=24, rate=0.15, prompt_lens=(128, 256, 512),
                     gen_range=(16, 48), seed=18)
#: 18a's inline check: this many of the requests (the shortest prompts)
SERVE_INLINE = 4
#: 18a's lanes held against their request served alone at SERVE_MAIN_DEPTH
#: (:func:`solo_lanes`); the float32 2-layer twin holds every lane
SERVE_SOLO_FULL = 3
#: 18b: qwen1.5-32b at a quarter of its depth (64 -> 32 layers for memory,
#: then 16 for the script's time when phase 20 joined it, and 8 when 19h
#: and 19f's FSDP runs did), its int8 KV cache past two KV_CHUNKs; the
#: reference test's bound on its logits against a bf16-cache twin
#: (relative at max(|logit|, 1))
SERVE_INT8_DEPTH = 8
SERVE_INT8 = dict(n_slots=4, max_len=8192, prompt_pad=4608, admit="prefill",
                  prefill_buckets=(4608,))
SERVE_INT8_TRAFFIC = dict(n_requests=4, rate=1.0,
                          prompt_lens=(4200, 4350, 4500, 4600),
                          gen_range=(32, 32), seed=19)
SERVE_INT8_BOUND = 0.15
#: 18c: the other archs at phase 16 / 17's cut depths: (arch, depth,
#: admission, prompt lengths); gemma3's prompts pass its 1024 window
_TRAINED_DEPTH = {arch: depth for arch, depth, _ in ZOO + FAMILIES}
SERVE_ZOO = tuple((arch, _TRAINED_DEPTH[arch], admit, lens)
                  for arch, admit, lens in (
                      ("gemma3-12b", "prefill", (1100, 1150, 1200)),
                      ("pixtral-12b", "prefill", (64, 96, 128)),
                      ("qwen2-moe-a2.7b", "prefill", (64, 96, 128)),
                      ("qwen3-moe-235b-a22b", "prefill", (64, 96, 128)),
                      ("deepseek-67b", "prefill", (64, 96, 128)),
                      ("mamba2-2.7b", "inline", (16, 24, 32)),
                      ("zamba2-1.2b", "inline", (16, 24, 32))))
SERVE_ZOO_TRAFFIC = dict(n_requests=6, rate=0.5, gen_range=(16, 32),
                         seed=20)
SERVE_ZOO_SLOTS = 4
#: teacher-forced decode steps against forward_logits, in a float32 twin
#: at the CPU tests' bound (rtol / atol 2e-3, tests/test_torch_decode.py);
#: the decoder-only twins first prefill SERVE_TF_PREFIX tokens (gemma3's
#: past its window); 64 steps before 19h and 19f's FSDP runs joined the
#: script, 32 since, for its time
SERVE_TF_STEPS, SERVE_TF_RTOL = 32, 2e-3
SERVE_TF_PREFIX = {"gemma3-12b": 1100}
#: whisper-tiny's batch loop: rows, prompt length, tokens generated
SERVE_AUDIO = (4, 32, 32)
#: 18d: the launcher at glm4-9b's width, 2 layers, publishing once, and
#: the engine it swaps into
SERVE_SWAP_DEPTH = 2
SERVE_SWAP_LAUNCH = ("--arch", "glm4-9b", "--steps", "3", "--batch", "8",
                     "--seq", "128", "--opt", "signsgd_vote",
                     "--momentum", "0", "--log-every", "1",
                     "--serve-every", "3")
SERVE_SWAP = dict(n_slots=4, max_len=160, prompt_pad=64)
SERVE_SWAP_TRAFFIC = dict(n_requests=8, rate=0.25, prompt_lens=(32, 64),
                          gen_range=(16, 32), seed=21)
SERVE_SWAP_TICK = 12


class TickTimer:
    """A serving engine's step functions with each decode tick between
    two CUDA events (read once the run has ended); admissions pass
    through untimed."""

    def __init__(self, torch, fns):
        self._torch, self._fns, self.events = torch, fns, []

    def __getattr__(self, name):
        return getattr(self._fns, name)

    def step(self, params, state):
        cuda = state["pos"].is_cuda
        if cuda:
            start = self._torch.cuda.Event(enable_timing=True)
            end = self._torch.cuda.Event(enable_timing=True)
            start.record()
        out = self._fns.step(params, state)
        if cuda:
            end.record()
            self.events.append((start, end))
        return out

    def ms(self) -> list:
        self._torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def param_bytes(params: dict, names=None) -> int:
    return sum(p.numel() * p.element_size() for k, p in params.items()
               if names is None or k in names)


def decode_weight_bytes(cfg, params: dict) -> int:
    """The least weight bytes one decode tick reads: every parameter once,
    but of an untied input embedding only the rows it gathers (counted as
    none) and of an MoE block only the top_k experts one token routes to
    (the tick's other experts depend on the data)."""
    skip = {"embed.table"} if "unembed.table" in params else set()
    expert = {k for k in params if ".experts_" in k}
    total = param_bytes(params, set(params) - skip - expert)
    if expert:
        total += param_bytes(params, expert) * cfg.moe.top_k \
            // cfg.moe.num_experts
    return total


def kv_bytes_per_position(cfg, cache: dict) -> int:
    """Cache bytes of one position of one slot, over the leaves a decode
    tick reads by position (K / V and int8 scales, the hybrid's attention
    slots); recurrent state is counted whole by :func:`state_bytes`."""
    per = 0
    for k, v in cache.items():
        if k in ("k", "v", "k_scale", "v_scale", "attn_k", "attn_v"):
            per += v[:, 0, 0].numel() * v.element_size()
    return per


def state_bytes(cache: dict) -> int:
    """Bytes of one slot's recurrent state (read and written each tick)."""
    return sum(v[:, 0].numel() * v.element_size() for k, v in cache.items()
               if k in ("ssm", "conv"))


def tick_bounds_ms(cfg, params, eng, report, requests) -> list:
    """The least time of each decode tick of `report`'s run: the weight
    bytes of :func:`decode_weight_bytes`, each live lane's KV rows up to
    its position and its recurrent state (read and written), over the
    card's memory rate. A lane's position on tick t follows from its
    record: inline from 0 at admission, prefill from the prompt's length
    (a request done at admission decodes no tick)."""
    cache = eng._state["cache"]
    per_pos, st = kv_bytes_per_position(cfg, cache), state_bytes(cache)
    weights = decode_weight_bytes(cfg, params)
    plen = {r.req_id: r.prompt_len for r in requests}
    live = {}
    for r in report.records.values():
        if r.finish_tick < 0:
            continue
        prefill = eng.sc.admit == "prefill"
        if prefill and r.finish_tick == r.admit_tick and len(r.tokens) == 1:
            continue
        pos0 = plen[r.req_id] if prefill else 0
        for t in range(r.admit_tick, r.finish_tick + 1):
            pos = pos0 + t - r.admit_tick
            live[t] = live.get(t, 0) + (pos + 1) * per_pos + 2 * st
    return [(weights + live[t]) / HBM_BYTES_PER_S * 1e3 for t in sorted(live)]


def serve_run(torch, dev, eng, requests, label: str, cfg, params,
              **run_kw):
    """Run `eng` on `requests` with every decode tick timed; returns its
    report and a result line: the report's schedule numbers, ms per tick
    over the whole run (CUDA events around it, admissions and prefills
    included), each decode tick's median and mean ms beside the mean of
    their bounds (:func:`tick_bounds_ms`), tokens/s, TTFT and latency p50
    / p95 in ticks, peak memory."""
    from repro_torch.serve.engine import _percentile
    timer = TickTimer(torch, eng.fns)
    eng.fns = timer
    reset_peak(torch, dev)
    cuda = dev.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    rep = eng.run(requests, **run_kw)
    if cuda:
        end.record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.fns = timer._fns
    fin = [r for r in rep.records.values() if r.finished]
    line = {"phase": "serve", "run": label, "arch": cfg.name,
            "layers": cfg.num_layers, "slots": eng.sc.n_slots,
            "max_len": eng.sc.max_len, "admit": eng.sc.admit,
            "scheduler": eng.sc.scheduler, "requests": rep.n_requests,
            "completed": rep.completed, "dropped": rep.dropped,
            "ticks": rep.ticks, "tokens": rep.total_tokens,
            "goodput_tokens_per_tick": rep.goodput_tokens_per_tick,
            "ttft_p50_ticks": rep.ttft_p50,
            "ttft_p95_ticks": _percentile([r.ttft for r in fin], 95),
            "latency_p50_ticks": rep.latency_p50,
            "latency_p95_ticks": rep.latency_p95,
            "occupancy": rep.occupancy_mean, "wall_s": wall,
            "tokens_per_s": rep.total_tokens / wall,
            "peak_bytes": peak_bytes(torch, dev)}
    if cuda:
        ms = timer.ms()
        bounds = tick_bounds_ms(cfg, params, eng, rep, requests)
        line.update({
            "ms_per_tick": start.elapsed_time(end) / max(rep.ticks, 1),
            "decode_ticks": len(ms),
            "decode_ms_median": statistics.median(ms),
            "decode_ms_mean": statistics.fmean(ms),
            "decode_bound_ms_mean": statistics.fmean(bounds),
            "decode_bound_by": "bytes",
            "weight_bytes_per_tick": decode_weight_bytes(cfg, params)})
    log(line)
    return rep, line


def require_served(label: str, rep, n: int) -> None:
    if rep.completed != n or rep.dropped:
        raise AssertionError(f"{label}: {rep.completed} of {n} completed, "
                             f"{rep.dropped} dropped")


def check_solo(cfg, params, sc, requests, rep, label: str) -> None:
    """Every lane's tokens equal the same request served alone in an
    engine of the same shape (exact)."""
    from repro_torch.serve import ServeEngine
    toks = rep.tokens_by_request()
    for r in requests:
        alone = ServeEngine(cfg, params, sc).run([r.with_arrival(0.0)])
        if alone.tokens_by_request()[r.req_id] != toks[r.req_id]:
            raise AssertionError(
                f"{label}: request {r.req_id} served in the pool "
                f"{toks[r.req_id]} != served alone "
                f"{alone.tokens_by_request()[r.req_id]}")


def solo_lanes(rep, requests, n: int) -> list:
    """`n` of `requests` whose lanes the pool could most plausibly get
    wrong: the longest prompt (the most cache rows; ties to the most
    tokens), then the requests admitted into a recycled slot, the one
    with the most stale rows first (its slot's previous occupant reached
    furthest past its own prompt: rows that only the position mask keeps
    out), then the last admitted."""
    recs, plen = rep.records, {r.req_id: r.prompt_len for r in requests}
    order = sorted(requests, key=lambda r: (recs[r.req_id].admit_tick,
                                            r.req_id))
    reach, stale = {}, {}
    for r in order:
        rec = recs[r.req_id]
        if rec.slot in reach:
            stale[r.req_id] = reach[rec.slot] - plen[r.req_id]
        reach[rec.slot] = plen[r.req_id] + len(rec.tokens)
    picks = [max(requests, key=lambda r: (plen[r.req_id],
                                          len(recs[r.req_id].tokens),
                                          -r.req_id))]
    picks += sorted((r for r in requests if r.req_id in stale),
                    key=lambda r: (-stale[r.req_id], r.req_id))
    picks.append(order[-1])
    out = []
    for r in picks:
        if r not in out and len(out) < n:
            out.append(r)
    return out


def serve_params(torch, cfg, dev, seed: int = 0) -> dict:
    from repro_torch.models import model as M
    return M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)


def inline_logit_gap(torch, cfg, params, requests, dev) -> float:
    """The largest difference between a prompt's last-position logits by
    prefill (batch 1, as the engine admits) and by streaming the prompt
    through the decode step, the prompts of one length as one batch, over
    `requests`."""
    from repro_torch.models import model as M
    gap = 0.0
    for plen in sorted({r.prompt_len for r in requests}):
        group = [r for r in requests if r.prompt_len == plen]
        prompts = torch.tensor([r.prompt for r in group], device=dev)
        cache = M.init_cache(cfg, len(group), plen, device=dev)
        for t in range(plen):
            lg, cache = M.decode_step(cfg, params, prompts[:, t:t + 1],
                                      cache, t)
        for b in range(len(group)):
            pre, _ = M.prefill(cfg, params, {"tokens": prompts[b:b + 1]})
            gap = max(gap, float((pre[0, -1].float() - lg[b].float())
                                 .abs().max()))
    return gap


def run_serve_main(torch, dev, cfg=None, twin=None) -> None:
    """Phase 18a: glm4-9b (every published width, SERVE_MAIN_DEPTH layers,
    bf16, seeded weights) behind the continuous engine with prefill admission
    on SERVE_TRAFFIC's requests, then the static scheduler on the same
    requests: zero dropped, SERVE_SOLO_FULL lanes (:func:`solo_lanes`)
    equal to their request served alone, one decode build, continuous
    goodput >= static, the same tokens. Then SERVE_INLINE of the requests
    (the shortest prompts) by inline admission: the token agreement with
    prefill admission and the largest logit gap printed. A float32
    2-layer twin (`twin`, default glm4-9b's width at 2 layers) of the
    continuous engine serves every request, each lane equal to its
    request served alone, and its inline admission equals its prefill
    admission."""
    from repro_torch.configs.base import get_config
    from repro_torch.obs import recorder as obs
    from repro_torch.serve import ServeConfig, ServeEngine, poisson_requests
    t0 = time.perf_counter()
    cfg = cfg or dataclasses.replace(get_config("glm4-9b"),
                                     num_layers=SERVE_MAIN_DEPTH)
    params = serve_params(torch, cfg, dev)
    reqs = poisson_requests(vocab_size=cfg.vocab_size, **SERVE_TRAFFIC)
    sc = ServeConfig(**SERVE_MAIN)
    builds0 = obs.COUNTERS.get("serve.decode.compiles")
    cont, line = serve_run(torch, dev, ServeEngine(cfg, params, sc), reqs,
                           "continuous", cfg, params)
    stat, sline = serve_run(
        torch, dev, ServeEngine(cfg, params, dataclasses.replace(
            sc, scheduler="static")), reqs, "static", cfg, params)
    for label, rep in (("continuous", cont), ("static", stat)):
        require_served(f"18a {label}", rep, len(reqs))
    if cont.tokens_by_request() != stat.tokens_by_request():
        raise AssertionError("18a: the static scheduler's tokens differ")
    if cont.goodput_tokens_per_tick < stat.goodput_tokens_per_tick:
        raise AssertionError(
            f"18a: continuous goodput {cont.goodput_tokens_per_tick} < "
            f"static {stat.goodput_tokens_per_tick}")
    solo = solo_lanes(cont, reqs, SERVE_SOLO_FULL)
    check_solo(cfg, params, sc, solo, cont, "18a")
    inline = sorted(reqs, key=lambda r: (r.prompt_len, r.req_id))[
        :SERVE_INLINE]
    inline = [r.with_arrival(0.0) for r in inline]
    irep, _ = serve_run(torch, dev, ServeEngine(
        cfg, params, dataclasses.replace(sc, admit="inline")), inline,
        "inline", cfg, params)
    require_served("18a inline", irep, len(inline))
    builds = obs.COUNTERS.get("serve.decode.compiles") - builds0
    if builds != 1:
        raise AssertionError(f"18a: {builds} decode builds across the "
                             "continuous, static, solo and inline engines")
    want, got = cont.tokens_by_request(), irep.tokens_by_request()
    same = sum(a == b for r in inline
               for a, b in zip(want[r.req_id], got[r.req_id]))
    total = sum(min(len(want[r.req_id]), len(got[r.req_id]))
                for r in inline)
    gap = inline_logit_gap(torch, cfg, params, inline, dev)
    del params
    twin = twin or dataclasses.replace(cfg, num_layers=2, dtype="float32")
    tparams = serve_params(torch, twin, dev)
    trep = ServeEngine(twin, tparams, sc).run(reqs)
    require_served("18a float32 twin", trep, len(reqs))
    check_solo(twin, tparams, sc, reqs, trep, "18a float32 twin")
    by = {}
    for admit in ("prefill", "inline"):
        by[admit] = ServeEngine(twin, tparams, dataclasses.replace(
            sc, admit=admit)).run(inline).tokens_by_request()
    if by["prefill"] != by["inline"]:
        raise AssertionError(f"18a float32 twin: inline {by['inline']} != "
                             f"prefill {by['prefill']}")
    del tparams
    log({"phase": "serve_main_done", "arch": cfg.name,
         "layers": cfg.num_layers, "decode_builds": builds,
         "continuous_over_static_goodput":
             cont.goodput_tokens_per_tick / stat.goodput_tokens_per_tick,
         "lanes_equal_alone": [r.req_id for r in solo],
         "float32_twin_lanes_equal_alone": len(reqs),
         "inline_requests_equal": sum(want[r.req_id] == got[r.req_id]
                                      for r in inline),
         "inline_token_agreement": same / max(total, 1),
         "inline_prefill_logit_gap_bf16": gap,
         "float32_twin_inline_equal_prefill": True,
         "seconds": time.perf_counter() - t0})


def run_serve_int8(torch, dev, cfg=None) -> None:
    """Phase 18b: qwen1.5-32b at every published width, SERVE_INT8_DEPTH
    layers, its int8 KV cache: SERVE_INT8_TRAFFIC's long prompts through
    one prefill bucket and the chunked online-softmax decode (two
    KV_CHUNKs). Then the same prompts and the engine's tokens, teacher-
    forced through the model API with the int8 cache (its greedy tokens
    must be the engine's) and with a bf16 cache: every lane's logits
    within SERVE_INT8_BOUND of the bf16 twin's (relative at max(|logit|,
    1), the reference test's bound)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L, model as M
    from repro_torch.serve import ServeConfig, ServeEngine, poisson_requests
    t0 = time.perf_counter()
    cfg = cfg or dataclasses.replace(get_config("qwen1.5-32b"),
                                     num_layers=SERVE_INT8_DEPTH)
    if cfg.kv_cache_dtype != "int8":
        raise AssertionError(f"18b: {cfg.name}'s cache is "
                             f"{cfg.kv_cache_dtype}")
    params = serve_params(torch, cfg, dev)
    sc = ServeConfig(**SERVE_INT8)
    if sc.max_len <= L.KV_CHUNK:
        raise AssertionError("18b: the cache must pass KV_CHUNK")
    reqs = poisson_requests(vocab_size=cfg.vocab_size, **SERVE_INT8_TRAFFIC)
    eng = ServeEngine(cfg, params, sc)
    rep, _ = serve_run(torch, dev, eng, reqs, "int8_cache", cfg, params)
    require_served("18b", rep, len(reqs))
    del eng
    toks = rep.tokens_by_request()
    lb = sc.prefill_buckets[-1]
    logits = {}
    for kv in ("int8", "bfloat16"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        cache = M.init_cache(c, len(reqs), sc.max_len, device=dev)
        rows = []
        for slot, r in enumerate(reqs):
            prompt = torch.zeros(lb, dtype=torch.int64, device=dev)
            prompt[:r.prompt_len] = torch.tensor(r.prompt, device=dev)
            lg, pcache = M.prefill(c, params, {"tokens": prompt[None]})
            for k, v in cache.items():
                src = pcache[k][:, 0]
                v[:, slot][tuple(slice(0, n) for n in src.shape)] = src
            rows.append(lg[0, r.prompt_len - 1].float())
            del lg, pcache
        steps = [torch.stack(rows)]
        pos = torch.tensor([r.prompt_len for r in reqs], device=dev)
        for i in range(len(toks[reqs[0].req_id]) - 1):
            fed = torch.tensor([toks[r.req_id][i] for r in reqs],
                               device=dev)[:, None]
            lg, cache = M.decode_step(c, params, fed, cache, pos + i)
            steps.append(lg.float())
        logits[kv] = torch.stack(steps, dim=1)          # (requests, gen, V)
        del cache
        if kv == "int8":
            greedy = logits[kv].argmax(dim=-1).tolist()
            if greedy != [list(toks[r.req_id]) for r in reqs]:
                raise AssertionError("18b: the model API's int8 decode "
                                     "differs from the engine's tokens")
    q, f = logits["int8"], logits["bfloat16"]
    rel = float(((q - f).abs() / f.abs().clamp(min=1.0)).max())
    if not rel < SERVE_INT8_BOUND:
        raise AssertionError(f"18b: int8 logits {rel} from the bf16 "
                             f"cache's (bound {SERVE_INT8_BOUND})")
    log({"phase": "serve_int8_done", "arch": cfg.name,
         "layers": cfg.num_layers, "kv_chunk": L.KV_CHUNK,
         "prompt_lens": [r.prompt_len for r in reqs],
         "int8_vs_bf16_cache_rel_max": rel, "bound": SERVE_INT8_BOUND,
         "seconds": time.perf_counter() - t0})


def teacher_forced_check(torch, dev, cfg, arch: str) -> dict:
    """SERVE_TF_STEPS teacher-forced decode steps of a float32 twin of
    `cfg` (its MoE's capacity factor raised to E / k, so that the forward
    drops no token, as one token's decode never does) against its
    ``forward_logits``, at the CPU tests' bound; the decoder-only twins
    continue from a prefill of SERVE_TF_PREFIX tokens (64 by default),
    the recurrent ones and whisper (its cross K / V from a prefill of 64
    stubbed frames) decode from position 0."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.models import model as M
    from repro_torch.train.serve_step import make_cache_rehome
    c = dataclasses.replace(cfg, dtype="float32")
    if c.moe.enabled:
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k))
    params = serve_params(torch, c, dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(2)
    decoder = c.family in (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.VLM)
    prefix = SERVE_TF_PREFIX.get(arch, 64) if decoder else 0
    n = prefix + SERVE_TF_STEPS
    toks = torch.randint(0, c.vocab_size, (1, n), generator=gen, device=dev)
    batch = {"tokens": toks}
    if c.family == ArchFamily.AUDIO:
        batch["enc_embeds"] = torch.randn(
            (1, min(c.max_source_positions, 64), c.d_model), generator=gen,
            device=dev)
    with torch.no_grad():
        full, _ = M.forward_logits(c, params, batch)
    if prefix:
        _, cache = M.prefill(c, params, {"tokens": toks[:, :prefix]})
        cache = make_cache_rehome(c, 1, n)(cache)
    else:
        cache = M.init_cache(c, 1, n, device=dev)
        if c.family == ArchFamily.AUDIO:
            _, pc = M.prefill(c, params, {"tokens": toks[:, :1],
                                          "enc_embeds": batch[
                                              "enc_embeds"]})
            cache["xk"], cache["xv"] = pc["xk"], pc["xv"]
    worst, err = 0.0, 0.0
    for t in range(prefix, n):
        lg, cache = M.decode_step(c, params, toks[:, t:t + 1], cache, t)
        d = (lg[0] - full[0, t]).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (SERVE_TF_RTOL + SERVE_TF_RTOL
                                       * full[0, t].abs())).max()))
    if not worst <= 1.0:
        raise AssertionError(
            f"{arch}: teacher-forced decode {err} from forward_logits "
            f"(rtol / atol {SERVE_TF_RTOL})")
    return {"tf_steps": SERVE_TF_STEPS, "tf_prefix": prefix,
            "tf_max_abs_err": err, "tf_rtol_atol": SERVE_TF_RTOL}


def run_serve_zoo_arch(torch, dev, arch: str, depth: int, admit: str,
                       lens, cfg=None) -> None:
    """Phase 18c for one arch: SERVE_ZOO_SLOTS slots, SERVE_ZOO_TRAFFIC's
    requests at `lens`, every lane equal to its request served alone,
    then :func:`teacher_forced_check`."""
    from repro_torch.configs.base import get_config
    from repro_torch.serve import ServeConfig, ServeEngine, poisson_requests
    t0 = time.perf_counter()
    cfg = cfg or dataclasses.replace(get_config(arch), num_layers=depth)
    params = serve_params(torch, cfg, dev)
    gen_max = SERVE_ZOO_TRAFFIC["gen_range"][1]
    sc = ServeConfig(n_slots=SERVE_ZOO_SLOTS, max_len=max(lens) + gen_max,
                     prompt_pad=max(lens), admit=admit,
                     prefill_buckets=tuple(sorted(lens))
                     if admit == "prefill" else ())
    reqs = poisson_requests(vocab_size=cfg.vocab_size, prompt_lens=lens,
                            **SERVE_ZOO_TRAFFIC)
    rep, line = serve_run(torch, dev, ServeEngine(cfg, params, sc), reqs,
                          "zoo", cfg, params)
    require_served(f"18c {arch}", rep, len(reqs))
    check_solo(cfg, params, sc, reqs, rep, f"18c {arch}")
    del params
    tf = teacher_forced_check(torch, dev, cfg, arch)
    log({"phase": "serve_zoo_done", "arch": arch, "layers": cfg.num_layers,
         "lanes_equal_alone": len(reqs), **tf,
         "seconds": time.perf_counter() - t0})


def audio_batch_loop(torch, cfg, params, batch, gen: int, dev) -> tuple:
    """launch/serve.py's batch loop (greedy): prefill, re-home, `gen`
    decode steps; returns the tokens (rows, gen + 1) and each decode
    step's ms (CUDA events)."""
    from repro_torch.models import model as M
    from repro_torch.train.serve_step import make_cache_rehome
    rows, plen = batch["tokens"].shape
    logits, cache = M.prefill(cfg, params, batch)
    cache = make_cache_rehome(cfg, rows, plen + gen)(cache)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    out, events = [tok], []
    for i in range(gen):
        if dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        lg, cache = M.decode_step(cfg, params, tok, cache, plen + i)
        tok = lg.argmax(dim=-1)[:, None]
        if dev.type == "cuda":
            ev[1].record()
            events.append(ev)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return toks, [s.elapsed_time(e) for s, e in events]


def run_serve_audio(torch, dev, cfg=None) -> None:
    """Phase 18c for whisper-tiny (every published width and depth): the
    batch loop on SERVE_AUDIO's rows with stubbed frames; each row equal
    to the same row served alone in a batch of the same shape (the other
    rows' tokens and frames zeroed); then :func:`teacher_forced_check`."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = cfg or get_config("whisper-tiny")
    rows, plen, gen = SERVE_AUDIO
    params = serve_params(torch, cfg, dev)
    batch = M.make_batch(cfg, rows, plen, torch.Generator(
        device=dev).manual_seed(3), dev)
    reset_peak(torch, dev)
    t1 = time.perf_counter()
    toks, ms = audio_batch_loop(torch, cfg, params, batch, gen, dev)
    wall = time.perf_counter() - t1
    peak = peak_bytes(torch, dev)
    for b in range(rows):
        alone = {k: torch.zeros_like(v) for k, v in batch.items()}
        for k in batch:
            alone[k][b] = batch[k][b]
        got, _ = audio_batch_loop(torch, cfg, params, alone, gen, dev)
        if not torch.equal(got[b], toks[b]):
            raise AssertionError(f"18c whisper: row {b} {toks[b].tolist()} "
                                 f"!= alone {got[b].tolist()}")
    line = {"phase": "serve", "run": "batch_loop", "arch": cfg.name,
            "rows": rows, "prompt_len": plen, "gen": gen,
            "tokens": rows * gen, "wall_s": wall,
            "tokens_per_s": rows * gen / wall, "peak_bytes": peak}
    if ms:
        weights = decode_weight_bytes(cfg, params)
        line.update({"decode_ms_median": statistics.median(ms),
                     "decode_ms_mean": statistics.fmean(ms),
                     "decode_bound_ms_min": weights / HBM_BYTES_PER_S * 1e3,
                     "decode_bound_by": "bytes"})
    log(line)
    del params
    tf = teacher_forced_check(torch, dev, cfg, cfg.name)
    log({"phase": "serve_zoo_done", "arch": cfg.name,
         "layers": cfg.num_layers, "lanes_equal_alone": rows, **tf,
         "seconds": time.perf_counter() - t0})


def run_serve_swap(torch, dev, scratch: str, err, cfg=None,
                   launch_args=SERVE_SWAP_LAUNCH) -> dict:
    """Phase 18d: an engine serving glm4-9b's width at SERVE_SWAP_DEPTH
    layers, a CheckpointWatcher on a serve directory; at tick
    SERVE_SWAP_TICK the port's launcher (``launch.train.main`` in
    process, its config cut to the engine's depth) trains 3 steps and
    publishes with ``--serve-dir``, every one of its launches held against
    its plain version; the engine picks the checkpoint up between ticks.
    Exact: zero dropped, one swap, every request admitted after it equal
    to an engine started on the published parameters, the launches the
    launcher's count. Returns them."""
    import io
    from repro_torch.checkpoint import checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.core import sign_compress as sc_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch
    from repro_torch.serve import (CheckpointWatcher, ServeConfig,
                                   ServeEngine, like_tree, poisson_requests)
    t0 = time.perf_counter()
    cfg = cfg or dataclasses.replace(get_config("glm4-9b"),
                                     num_layers=SERVE_SWAP_DEPTH)
    params = serve_params(torch, cfg, dev, seed=4)
    serve_dir = os.path.join(scratch, "serve")
    sc = ServeConfig(**SERVE_SWAP)
    eng = ServeEngine(cfg, params, sc, watcher=CheckpointWatcher(
        serve_dir, like_tree(params), device=dev))
    reqs = poisson_requests(vocab_size=cfg.vocab_size, **SERVE_SWAP_TRAFFIC)
    build = launch.build
    out, launches, held = {}, {}, {}

    def cut(*args, **kwargs):
        c, t = build(*args, **kwargs)
        return dataclasses.replace(c, num_layers=cfg.num_layers), t

    def on_tick(_eng, t):
        if t != SERVE_SWAP_TICK:
            return
        printed = io.StringIO()
        ops.reset_launch_counts()
        launch.build = cut
        try:
            with plain_checked(torch, ops, ref, sc_mod, err, "serve swap",
                               MESH_CHECKED, held), \
                    contextlib.redirect_stdout(printed):
                out["rc"] = launch.main(list(launch_args) + [
                    "--device", dev.type, "--serve-dir", serve_dir])
        finally:
            launch.build = build
        launches.update({k: v for k, v in ops.launch_counts().items() if v})
        out["log"] = [ln for ln in printed.getvalue().splitlines()
                      if ln.startswith("step ")]

    rep, _ = serve_run(torch, dev, eng, reqs, "hot_swap", cfg, params,
                       on_tick=on_tick)
    if out.get("rc") != 0:
        raise AssertionError(f"18d: the launcher returned {out.get('rc')}")
    require_served("18d", rep, len(reqs))
    if rep.swaps != 1 or eng.param_version != 1:
        raise AssertionError(f"18d: {rep.swaps} swaps, version "
                             f"{eng.param_version}")
    post = [r for r in reqs if rep.records[r.req_id].param_version_admit == 1]
    if not post or len(post) == len(reqs):
        raise AssertionError("18d: the swap must split the requests")
    published = checkpoint.restore(serve_dir, device=dev)[0]
    fresh = ServeEngine(cfg, published, sc).run(
        [r.with_arrival(0.0) for r in post]).tokens_by_request()
    toks = rep.tokens_by_request()
    for r in post:
        if toks[r.req_id] != fresh[r.req_id]:
            raise AssertionError(f"18d: request {r.req_id} after the swap "
                                 f"{toks[r.req_id]} != a fresh engine's "
                                 f"{fresh[r.req_id]}")
    steps = int(launch_args[launch_args.index("--steps") + 1])
    want = launcher_launches("glm4-9b", steps)
    if dev.type == "cuda" and (launches != want or held != launches):
        raise AssertionError(f"18d: launches {launches}, held {held}, "
                             f"expected {want}")
    log({"phase": "serve_swap_done", "arch": cfg.name,
         "layers": cfg.num_layers, "swaps": rep.swaps,
         "requests_after_swap": len(post), "launcher": out["log"],
         "launches": launches, "held_vs_plain": held,
         "seconds": time.perf_counter() - t0})
    return launches


def run_phase18(torch, dev, err) -> dict:
    """Phase 18 (a-d). 18a-c launch none of the port's kernels (serving's
    attention, SSM step and sampling are PyTorch ops, as the reference's
    are jnp): checked. Returns 18d's launches (the launcher's)."""
    import gc
    import tempfile
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    run_serve_main(torch, dev)
    gc.collect()
    run_serve_int8(torch, dev)
    gc.collect()
    for arch, depth, admit, lens in SERVE_ZOO:
        run_serve_zoo_arch(torch, dev, arch, depth, admit, lens)
        gc.collect()
    run_serve_audio(torch, dev)
    gc.collect()
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"18a-c launched kernels: {launched}")
    with tempfile.TemporaryDirectory() as scratch:
        launches = run_serve_swap(torch, dev, scratch, err)
    log({"phase": "phase18_done", "launches": launches,
         "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# phase 19: the model axis (tensor parallelism), 4 ranks sharing the card
# ---------------------------------------------------------------------------

#: 19a: phase 3's cell (glm4-9b at every published width, 2 layers, batch
#: 8, seq 512) on (data 2, model 2): M = 2 voters of 2 model ranks; per
#: codec step 0 twice from one state, then step 1
TP_TRAIN_MESH = ((2, 2), ("data", "model"))
TP_CODECS = ("sign1bit", "ternary2bit")
TP_VOTERS = 2
#: 19a's bounds, stated before the first run: step 0's loss within this
#: share of the stacked twin's; each leaf's step-0 vote equal to the
#: twin's on at least TP_VOTE_AGREE of its coordinates, and every
#: coordinate that differs one where some voter's |m'| is under
#: TP_FLIP_FRACTION of the leaf's largest. ``attn_bk`` is held to
#: TP_VOTE_AGREE_BK instead: a bias added to every key moves each query's
#: scores by nearly one constant, which the softmax removes (only RoPE's
#: rotation of it survives), so its gradient is mostly cancellation and its
#: sign rounding noise in either computation (CPU rehearsals of this phase
#: in bf16: 99.2 % at d_model 512, 97.3 % (sign1bit) and 94.1 %
#: (ternary2bit) at 2048, every other leaf 99.4 % or more; every flip
#: within TP_FLIP_FRACTION)
TP_LOSS_RTOL, TP_VOTE_AGREE, TP_FLIP_FRACTION = 1e-2, 0.99, 2.0 ** -5
TP_VOTE_AGREE_BK = 0.90
#: 19e's vote bounds by arch, in place of TP_VOTE_AGREE and (zamba2) of the
#: rule that every flip sits where a voter's |m'| is under
#: TP_FLIP_FRACTION: zamba2 may flip that many of a leaf's coordinates at
#: a larger |m'|. They were set after a reading, so they are not
#: predictions: a probe of this phase read mamba2 98.1 % (`mamba_A_log`, 3
#: of 160 coordinates), whisper 98.2 % and zamba2 86.8 %, with zamba2's
#: flips at up to 2.5 % of a leaf's coordinates at a larger |m'| (every
#: mamba2 and whisper flip near zero), against the 99 % stated before the
#: run. The unsharded bf16 step against itself, only the mamba
#: projections' float32 accumulation order changed
#: (``scripts/bf16_vote_noise.py``), flips zamba2's votes as widely: its
#: bf16 vote at this depth is rounding noise, and the float32 twins (19f)
#: hold the function
TP_VOTE_AGREE_FAMILY = {"mamba2-2.7b": 0.97, "whisper-tiny": 0.97,
                        "zamba2-1.2b": 0.80, "m2_model8": 0.94}
TP_LARGE_FLIP_SHARE = {"zamba2-1.2b": 0.05, "m2_model8": 0.01}
#: 19d: qwen3-moe-235b-a22b's Mode B fsdp preset at every published width,
#: 1 layer, seq 512, batch 8, 1 microbatch (its preset's 4 cut to 2 to fit
#: 4 rows a voter, then to 1 for the script's time: the fused gathers run
#: once a microbatch; phase 15b drives 2 over a mesh), on (data 2, model
#: 2): the experts in the EP form (64 a rank), grouped attention (4 kv
#: heads over 2), its 4-D fused expert leaves carrying both axes; step 0, step 0 again from a saved state,
#: step 1. It replaces the earlier 19b (qwen1.5-32b's Mode B fsdp preset),
#: whose fused backward over a model axis it drives too, with the experts
TP_MOE_ARCH, TP_MOE_LAYERS, TP_MOE_MICRO = "qwen3-moe-235b-a22b", 1, 1
#: 19g-3 rides in 19d: voter 0 of its two is a random adversary. Each
#: model rank of that voter draws its block of every fused leaf (the
#: fused ZeRO backward's, under no step) from counter 0 under the
#: voter's key, the reference's rule (each model block of the region
#: manual over "model"); its draws of the other leaves (hierarchical,
#: leaf-wise under the step) at the block's global coordinates. Both held
#: bit for bit to the stacked twin, which draws each fused leaf model
#: block by model block (:class:`TwinBlockDraws`)
TP_MOE_ADVERSARY = "random"
#: 19e: the families' presets at every published width on (data 2, model
#: 2), seq 512, batch 8: (arch, depth, encoder depth, microbatches (the
#: preset's, cut to divide 4 rows a voter)); mamba2 40 heads and 2,688
#: xBC channels a rank; zamba2 a segment of 6, its shared block, then 1;
#: whisper 64 stubbed frames a row, grouped attention, whole vocabulary
#: tables
TP_FAMILIES = (("mamba2-2.7b", 2, 0, 4), ("zamba2-1.2b", 7, 0, 4),
               ("whisper-tiny", 2, 4, 4))
TP_FRAMES = 64
#: 19g: the vote side of the model axis on 19a's cell (glm4-9b at every
#: published width, 2 layers, data 2 x model 2, one adversary of the two
#: voters): (label, adversary mode, flip_prob, optimizer options): 19g-1
#: sign1bit leaf-wise on allgather_1bit with a random adversary, 19g-2 a
#: VotePlan of TP_ADV_BUCKET_BYTES with overlap on psum_int8 with a blind
#: adversary at the kernel table's flip_prob; each step 0 twice, then
#: step 1, against its stacked M = 2 twin, at 19a's bounds (stated before
#: the first run)
TP_ADV_BUCKET_BYTES = 1 << 24
TP_ADV_RUNS = (
    ("adv_random", "random", 0.5, {}),
    ("adv_plan_blind", "blind", 0.9, {"vote_strategy": "psum_int8",
                                      "bucket_bytes": TP_ADV_BUCKET_BYTES,
                                      "overlap": True}))
#: elements a draw check unpacks at a time (19g)
TP_ADV_CHUNK = 1 << 26
#: the unembedding table whose column cut 19g's kernel check draws
ADV_MAP_TABLE = (151_552, 4096)
#: 19d / 19f's bound on a routing choice that differs from the twin's,
#: stated before the first run: the twin's k-th router probability exceeds
#: its (k+1)-th by under this share of the k-th (bf16: a residual a few
#: bf16 ulps away moves a router logit by about 1e-2, so a probability by
#: about 1 %); the float32 twins by under TP_ROUTE_TIE_F32
TP_ROUTE_TIE, TP_ROUTE_TIE_F32 = 0.05, 1e-4
#: 19c: serving glm4-9b at every published width, 2 layers (8 before 19d-19f,
#: 4 before 19h and 19f's FSDP runs, cut for the script's time; and a
#: float32 twin of 2): (label, mesh shape, axes, kv cache, prompt rows,
#: cache rows, greedy ticks: 16 / 8 / 8 before 19h and 19f's FSDP runs,
#: 4 / 4 / 4 since); per-row prompts prefilled one at a time, the equal
#: ones of the heads run through make_prefill_sharded
TP_SERVE_DEPTH, TP_TWIN_DEPTH = 2, 2
TP_PROMPTS = (4100, 4166, 4233, 4300)
#: the int8 run decodes from its bf16 run's prefill, its cache quantized
#: row by row (``layers.quantize_kv``: what an int8 prefill stores, bit for
#: bit; the int8 prefill is held on the CPU), for the phase's time
TP_INT8_FROM = {"seq_model4_int8": "seq_model4"}
TP_SERVE_RUNS = (
    ("seq_model4", (4,), ("model",), "bfloat16", TP_PROMPTS, 8192, 4),
    ("seq_model4_int8", (4,), ("model",), "int8", TP_PROMPTS, 8192, 4),
    ("heads_data2_model2", (2, 2), ("data", "model"), "bfloat16",
     (1024,) * 4, 2048, 4),
)
#: 19c's bounds, stated before the first run: the bf16 logits within this
#: share of max(|logit|, 1) of the single-device step's (int8: phase
#: 18b's bound); the float32 twins within rtol / atol TP_TWIN_TOL (PR
#: 26's twins), greedy tokens equal. An int8 cache's twin computes its
#: attention in bf16 whatever the model's dtype (each chunk dequantised to
#: bf16, and each shard's partial products rounded there on their own: the
#: CPU harness's bound 2e-2), so it is held as its bf16 run is
TP_SERVE_SHARE = {"bfloat16": 0.05, "int8": SERVE_INT8_BOUND}
#: 19f's bf16 runs of the SSD families (mamba2, zamba2) are held to this
#: share instead. It was set after a reading, so it is not a prediction:
#: a probe of this phase read 5.02 % on zamba2 (8 layers, tick 4) against
#: TP_SERVE_SHARE's 5 %, and 3.46 % on mamba2's prefill, while their
#: float32 twins agreed within 8e-6. The SSD's recurrence carries a bf16
#: rounding of a projection made in another accumulation order far into
#: the logits (on the CPU, at d_model 512 and 4 layers, only changing the
#: projections' order moves the logits by 0.6 % at the last position and
#: 2.0 % anywhere); the float32 twins hold the function at TP_TWIN_TOL
TP_SERVE_SHARE_SSD = 0.15
TP_TWIN_TOL = 2e-3
TP_SEED = 7
TP_TIMEOUT_S = 600
#: 19f: serving the other families at every published width, each beside
#: a float32 twin (the MoE's with capacity factor E / k, so nothing is
#: dropped), tick by tick on the single-device step's greedy tokens:
#: (label, arch, depth, encoder depth, twin depth, twin encoder depth,
#: mesh shape, axes, prompt rows, cache rows, ticks: 8 before 19h and
#: 19f's FSDP runs joined the script, 4 since); on (model 4)
#: qwen2-moe EP with 15 experts a rank and its shared branch (grouped
#: attention, a heads-sharded cache), mamba2, zamba2 (its shared block's
#: cache heads-sharded) and whisper (the seq form, its 1,500-row cross
#: cache sequence-sharded, 375 rows a rank, and its self cache too); on
#: (data 2, model 2) qwen3-moe with a heads-sharded cache through
#: make_prefill_sharded
TP_FAMILY_SERVE = (
    ("qwen2_moe_model4", "qwen2-moe-a2.7b", 1, 0, 1, 0, (4,), ("model",),
     (64, 128, 192, 256), 512, 4),
    ("mamba2_model4", "mamba2-2.7b", 4, 0, 2, 0, (4,), ("model",),
     (64, 128, 192, 256), 512, 4),
    ("zamba2_model4", "zamba2-1.2b", 8, 0, 7, 0, (4,), ("model",),
     (64, 128, 192, 256), 512, 4),
    ("whisper_model4", "whisper-tiny", 2, 4, 2, 2, (4,), ("model",),
     (64, 128, 192, 256), 512, 4),
    ("qwen3_moe_data2_model2", "qwen3-moe-235b-a22b", 1, 0, 1, 0, (2, 2),
     ("data", "model"), (128,) * 4, 512, 4),
)


#: 19f's FSDP runs: serving over the FSDP layout
#: (``serve_param_shardings(..., fsdp=True)``, the serving layout of the
#: Mode B archs' cells) on (data 2, model 2), each tick held bit for bit to
#: the same ranks' run over the plain layout (logits and every cache
#: leaf's block) and its bytes by axis to ``tp_fsdp_tick_bytes``:
#: (label, arch, depth, encoder depth); qwen1.5-32b at every published
#: width (depth 64 -> 2), qwen3-moe at 19f's cut (1 layer, a heads-sharded
#: cache), mamba2, zamba2 and whisper at 19f's widths and depths; 4 prompts
#: of TP_FSDP_PROMPT rows through make_prefill_sharded (FSDP and plain
#: alike), a cache of TP_FSDP_CACHE rows, TP_FSDP_TICKS greedy ticks
TP_FSDP_SERVE = (
    ("qwen15_fsdp", "qwen1.5-32b", 2, 0),
    ("qwen3_moe_fsdp", "qwen3-moe-235b-a22b", 1, 0),
    ("mamba2_fsdp", "mamba2-2.7b", 4, 0),
    ("zamba2_fsdp", "zamba2-1.2b", 8, 0),
    ("whisper_fsdp", "whisper-tiny", 2, 4),
)
TP_FSDP_MESH = ((2, 2), ("data", "model"))
TP_FSDP_PROMPT, TP_FSDP_ROWS, TP_FSDP_CACHE, TP_FSDP_TICKS = 128, 4, 512, 8


def _attn_gather_bytes(cfg, m: int, B: int, S: int, T: int) -> tuple:
    """(forward, backward) bytes of an attention's gathers over the model
    group in :func:`models.layers._attn_form`'s form, S query rows against
    T key rows: the repeat form's k / v (model dtype) and their backward's
    whole-tensor float32 sums, the seq form's q and output rows likewise."""
    from repro_torch.models.layers import _attn_form
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    el = 4 if cfg.dtype == "float32" else 2
    form = _attn_form(H, K, m)
    fwd = bwd = 0
    if form in ("repeat", "seq"):
        kv = B * T * K * hd // m            # each of k and v, one rank's
        fwd += 2 * kv * el
        bwd += 2 * 4 * kv * m               # the whole gathered cotangent
    if form == "seq":
        q = B * S * H * hd // m
        # q, and the output's rows; rows the axis does not divide stay
        # whole on every rank, with no gather of the output
        parts = 1 if S % m else 2
        fwd += parts * q * el
        bwd += parts * 4 * q * m
    return fwd, bwd


def _tp_layers(cfg, m: int, B: int, S: int, T: int = 0) -> list:
    """(forward, backward, closing) model-group bytes of each block of the
    stack a microbatch of B rows of S positions runs (a remat unit each:
    a layer, the hybrid's shared-block call, an encoder layer), its
    `closing` the last forward sum, which remat's recompute stops before
    when nothing after it is saved for the backward (0 where something
    is: the MoE's shared branch, whose output its gate's backward reads);
    an encoder-decoder's rows carry T frames.
    Every float sum is ``mesh.model_sum`` of float32 (its bytes
    ``mesh.model_sum_bytes``), a gather's backward the float32 sum of the
    whole cotangent."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.distributed.mesh import model_sum_bytes
    from repro_torch.models.hybrid import _segments
    d = cfg.d_model
    el = 4 if cfg.dtype == "float32" else 2

    def msb(n):
        return model_sum_bytes(n, m)
    stream = msb(B * S * d)
    g_fwd, g_bwd = _attn_gather_bytes(cfg, m, B, S, S)
    # a dense attention + MLP block: the two row-parallel sums forward,
    # the two column-parallel entries' cotangent sums backward
    dense = (2 * stream + g_fwd, 2 * stream + g_bwd, stream)
    if cfg.family in (ArchFamily.SSM, ArchFamily.HYBRID):
        cd = cfg.ssm.conv_dim(d)
        n = B * S * cd
        # the xBC gather (model dtype) and its backward's float32 sum of
        # the whole cotangent by blocks, the norm's (B, S) sums both ways,
        # out_proj's sum and the projections' entry
        scatter = 4 * m * -(-n // m)
        mamba = (el * n // m + msb(B * S) + stream,
                 scatter + msb(B * S) + stream, stream)
        if cfg.family == ArchFamily.SSM:
            return [mamba] * cfg.num_layers
        # the shared block: q / k / v, the attention and gate / up whole;
        # wo's and w_down's output columns gathered (model dtype), their
        # replicated inputs' cotangents summed backward
        H, hd, f = cfg.num_heads, cfg.resolved_head_dim, cfg.d_ff
        cols = el * B * S * d // m if d % m == 0 else 0
        shared = (2 * cols, (msb(B * S * H * hd) + msb(B * S * f))
                  if cols else 0, cols)
        out = []
        for start, end, shared_after in _segments(cfg):
            out += [mamba] * (end - start)
            if shared_after:
                out.append(shared)
        return out
    if cfg.family == ArchFamily.AUDIO:
        enc_stream = msb(B * T * d)
        e_fwd, e_bwd = _attn_gather_bytes(cfg, m, B, T, T)
        enc = (2 * enc_stream + e_fwd, 2 * enc_stream + e_bwd, enc_stream)
        x_fwd, x_bwd = _attn_gather_bytes(cfg, m, B, S, T)
        # self-attention, cross-attention (its q entry, and its k / v
        # entry of the encoder output) and the MLP
        dec = (3 * stream + g_fwd + x_fwd,
               3 * stream + enc_stream + g_bwd + x_bwd, stream)
        return [enc] * cfg.encoder_layers + [dec] * cfg.num_layers
    if cfg.moe.enabled:
        k = cfg.moe.top_k
        shared = bool(cfg.moe.num_shared_experts)
        # the combine's closing sum (and the shared branch's), the
        # experts' entry (and the shared branch's) and the routing
        # weights' cotangent (T, k) summed backward
        moe = (stream + g_fwd + stream * (1 + shared),
               stream + g_bwd + stream * (1 + shared) + msb(B * S * k),
               0 if shared else stream)
        return [moe] * cfg.num_layers
    return [dense] * cfg.num_layers


def tp_bytes(cfg, tcfg, mesh, frames: int = 0) -> int:
    """The bytes one rank hands the model group's collectives in one train
    step (``ProcessMesh.model_stats``), counted from the layout
    (:func:`_tp_layers`' blocks; an encoder-decoder's rows of `frames`
    frames): per microbatch, where the vocabulary is
    sharded the embedding's sum and the unembedding's cotangent sum
    (float32 (B, S, d) each, the VLM's over its text rows), the
    vocab-parallel CE's maximum (float32, B·(S-1)) and its one sum of the
    exp-sums and target logits (2·B·(S-1)); each block's forward and
    backward bytes; ``remat="full"`` runs each block's forward again in
    the backward up to its last saved tensor (the non-reentrant
    checkpoint's early stop), so all but its closing sum; ``"nested"``
    each group of layers (``transformer._best_group``; one layer below 4)
    likewise, all but the group's last closing sum. Then the optimizer's
    model-group sums: ef_sign's mean|t| (4 bytes a sharded leaf),
    weighted_vote's counts (8 bytes a voter, and 8), the diagnostics'
    three int64 sums."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import model_sum_bytes
    from repro_torch.models.model import _vlm_split
    from repro_torch.models.transformer import _best_group
    m = mesh.model
    if m == 1:
        return 0
    voters = mesh.size
    B = tcfg.global_batch // voters // tcfg.microbatches
    S, d = tcfg.seq_len, cfg.d_model
    # the VLM embeds and scores its text rows only (its patch prefix is
    # the first quarter of the sequence)
    text = _vlm_split(S)[1] if cfg.family == ArchFamily.VLM else S
    blocks = _tp_layers(cfg, m, B, S, frames)
    fwd = sum(b[0] for b in blocks)
    bwd = sum(b[1] for b in blocks)
    recompute = 0
    if tcfg.remat in ("full", "nested"):
        # sqrt-remat groups the decoder-only stack's layers; every other
        # stack checkpoints each block
        k = (_best_group(cfg.num_layers) if tcfg.remat == "nested"
             and cfg.num_layers >= 4 and len(blocks) == cfg.num_layers
             else 1)
        for g in range(0, len(blocks), k):
            group = blocks[g:g + k]
            recompute += sum(b[0] for b in group) - group[-1][2]
    elif tcfg.remat != "none":
        raise ValueError(f"tp_bytes counts remat none, full and nested, "
                         f"not {tcfg.remat!r}")
    ends = ce = 0
    if cfg.vocab_size % m == 0:
        ce = 4 * B * (text - 1) + model_sum_bytes(2 * B * (text - 1), m)
        ends = 2 * model_sum_bytes(B * text * d, m)
    total = tcfg.microbatches * (ends + fwd + ce + bwd + recompute)
    o = tcfg.optimizer
    if o.kind in ("signum_vote", "signsgd_vote"):
        specs = shd.param_specs(cfg.param_shapes(), fsdp=tcfg.fsdp,
                                mesh_shape={"pod": mesh.pod,
                                            "data": mesh.data, "model": m})
        if o.resolved_codec == "ef_sign":
            total += 4 * sum("model" in s for s in specs.values())
        if o.resolved_codec == "weighted_vote":
            total += 8 * voters + 8
        if tcfg.diagnostics:
            total += 8 * 3
    return total


def _tick_attn_bytes(cfg, m: int, rows: int, sharded: bool) -> int:
    """One decode attention's bytes beyond its output's sum: against a
    sequence-sharded cache (`sharded`) the new token's q, k and v columns
    in one gather (model dtype) and the sharded flash decode's combine
    (the float32 maximum, rows x H, then the numerator and denominator in
    one sum, rows x H x (hd + 1)); against a heads-sharded one nothing."""
    from repro_torch.distributed.mesh import model_sum_bytes
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    el = 4 if cfg.dtype == "float32" else 2
    if K % m == 0 or not sharded:
        return 0 if K % m == 0 else el * rows * (H + 2 * K) * hd // m
    return (el * rows * (H + 2 * K) * hd // m + 4 * rows * H
            + model_sum_bytes(rows * H * (hd + 1), m))


def tp_tick_bytes(cfg, mesh, rows: int, seq_sharded: bool = True,
                  cross_sharded: bool = False) -> int:
    """The bytes one rank hands the model group's collectives in one
    decode tick of `rows` rows (its batch block), counted from the layout:
    where the vocabulary is sharded the embedding's float32 sum (rows x d)
    and the logits' vocab shards gathered (model dtype); per attention
    block the attention output's and the MLP's float32 sums (rows x d
    each, ``mesh.model_sum_bytes``) and :func:`_tick_attn_bytes` (the
    self-attention cache sequence-sharded when `seq_sharded`); per MoE
    block the combine's sum (and the shared branch's); per mamba layer
    the conv's output row gathered (model dtype, rows x conv_dim / m), the
    norm's float32 sum (rows) and out_proj's sum; per call of the
    hybrid's shared block its heads' outputs gathered (a heads-sharded
    cache) or the combine (a sequence-sharded one) and its two output
    products' columns gathered (model dtype); per whisper decoder
    layer also the cross-attention: its output's sum and, against a cache
    not heads-sharded, the q columns gathered (model dtype) and, where
    the cache is sequence-sharded (`cross_sharded`), the combine."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.distributed.mesh import model_sum_bytes
    from repro_torch.models.hybrid import _segments
    m = mesh.model
    H, K, hd, d = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    el = 4 if cfg.dtype == "float32" else 2
    out = model_sum_bytes(rows * d, m)
    attn = 2 * out + _tick_attn_bytes(cfg, m, rows, seq_sharded) \
        if H else 0
    if cfg.family in (ArchFamily.SSM, ArchFamily.HYBRID):
        mamba = (el * rows * cfg.ssm.conv_dim(d) // m
                 + model_sum_bytes(rows, m) + out)
        layers = mamba * cfg.num_layers
        if cfg.family == ArchFamily.HYBRID:
            # the shared block: its attention's heads gathered against a
            # heads-sharded cache, the combine against a sequence-sharded
            # one; wo's and w_down's output columns gathered
            shared = 2 * el * rows * d // m
            if K % m == 0:
                shared += el * rows * H * hd // m
            elif seq_sharded:
                shared += 4 * rows * H + model_sum_bytes(
                    rows * H * (hd + 1), m)
            layers += shared * sum(s[2] for s in _segments(cfg))
    elif cfg.family == ArchFamily.AUDIO:
        cross = out
        if K % m:
            cross += el * rows * H * hd // m
            if cross_sharded:
                cross += 4 * rows * H + model_sum_bytes(rows * H * (hd + 1),
                                                        m)
        layers = (attn + cross) * cfg.num_layers
    elif cfg.moe.enabled:
        layers = (attn + out * bool(cfg.moe.num_shared_experts)) \
            * cfg.num_layers
    else:
        layers = attn * cfg.num_layers
    ends = 0
    if cfg.vocab_size % m == 0:
        ends = out + el * rows * (cfg.vocab_size // m)
    return ends + layers


def tp_fsdp_tick_bytes(cfg, mesh, batch: int, seq_sharded: bool = True,
                       cross_sharded: bool = False, fsdp: bool = True
                       ) -> dict:
    """The bytes one rank hands each axis in one decode tick of a global
    `batch` of rows over the serving layout, FSDP (`fsdp`) or plain,
    counted from the layout: {"model": :func:`tp_tick_bytes` of the
    rank's rows, "vote": where the batch is split over the vote axes the
    rank's rows' logits gathered (model dtype, rows x vocabulary), and
    with `fsdp` the
    ZeRO-3 gather of each leaf the FSDP layout shards (the rank's block,
    model dtype), once a tick: the top-level leaves' (zamba2's shared
    block) and each layer's, the encoder's left out (a decode runs no
    encoder)}."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import param_dtype
    from repro_torch.train import serve_step as SS
    sizes = mesh.axis_sizes
    el = 4 if cfg.dtype == "float32" else 2
    entry = SS.batch_entry(batch, sizes)
    rows = batch // shd.spec_block((entry,), mesh.coords, sizes)[0][1]
    vote = el * rows * cfg.vocab_size if entry is not None else 0
    if fsdp:
        specs = SS.serve_param_shardings(cfg, mesh, fsdp=True)
        shapes = cfg.param_shapes()
        for k in shd.fused_dims(specs):
            if k.startswith("encoder."):
                continue
            block = [n // c for n, (_, c) in zip(
                shapes[k], shd.spec_block(specs[k], mesh.coords, sizes))]
            vote += math.prod(block) * param_dtype(cfg, k).itemsize
    return {"vote": vote,
            "model": tp_tick_bytes(cfg, mesh, rows, seq_sharded,
                                   cross_sharded)}


def tp_vote_bytes(params: dict, codec: str) -> int:
    """The bytes one rank hands the vote axes' collectives in one step of
    19a (``ProcessMesh.stats``): each local leaf's words all-gathered over
    the data group (1-bit words of sign1bit, 2-bit of ternary2bit on
    allgather_1bit: 4 bytes a word), and the metrics (3 float32)."""
    per = 16 if codec == "ternary2bit" else 32
    return sum(4 * -(-p.numel() // per) for p in params.values()) + 12


def tp_plan_vote_bytes(art, tcfg) -> int:
    """The bytes one rank hands the vote axes' collectives in one step of
    a VotePlan over a model axis (19g-2), counted from the rank's windows
    (``art.optimizer.shard``, ``core.vote_plan.shard_plan``): per window
    its wire's message (1-bit words of sign1bit and weighted_vote, 2-bit
    words of ternary2bit, on allgather_1bit: 4 bytes a word; one int8
    count a coordinate on psum_int8 over fewer than 128 voters), with the
    diagnostics the int8 tally of the rank's flat signs and voter 0's
    agreement (one int64), and the metrics (3 float32)."""
    from repro_torch.configs.base import VoteStrategy
    shard = art.optimizer.shard
    out = 12
    for b in shard.plan.buckets:
        if b.strategy == VoteStrategy.ALLGATHER_1BIT:
            out += 4 * -(-b.length // (16 if b.codec == "ternary2bit"
                                       else 32))
        elif b.strategy == VoteStrategy.PSUM_INT8:
            out += b.length
        else:
            raise ValueError(f"no byte count for {b.strategy.value!r}")
    if tcfg.diagnostics:
        out += shard.plan.n_params + 8
    return out


def tp_psum_vote_bytes(params: dict, voters: int = 2) -> int:
    """The bytes one rank hands the vote axes' collectives in one psum_int8
    step over a data axis of `voters` (19e: 2): each local leaf's int8
    counts all-reduced (one byte a coordinate), and the metrics (3
    float32); over one voter (19h) no collective runs."""
    if voters == 1:
        return 0
    return sum(p.numel() for p in params.values()) + 12


def tp_fsdp_vote_bytes(cfg, art, micro: int) -> int:
    """The vote axes' bytes of one 19d step of `micro` microbatches, phase
    15b's count (``fsdp_mesh_bytes``) on the rank's model blocks of the
    leaves."""
    sizes = art.mesh_sizes
    local = {}
    for k, s in cfg.param_shapes().items():
        s = list(s)
        for i, e in enumerate(art.param_specs[k]):
            if e == "model":
                s[i] //= sizes["model"]
        local[k] = tuple(s)
    return fsdp_mesh_bytes(cfg, "mode_b", (sizes["data"],),
                           art.fused_dims, True, shapes=local,
                           micro=micro)[
        "analytic_bytes"]


def clone_state(torch, tree, host: bool = False):
    """A deep copy of a (params or optimizer state) tree of tensors (on
    the host, with `host`)."""
    if torch.is_tensor(tree):
        return tree.to("cpu", copy=True) if host else tree.clone()
    if isinstance(tree, dict):
        return {k: clone_state(torch, v, host) for k, v in tree.items()}
    return tree


def restore_state_(torch, tree, saved) -> None:
    """Copy `saved` (a :func:`clone_state`) back into `tree` in place."""
    for k, v in saved.items():
        if torch.is_tensor(v):
            tree[k].copy_(v)
        elif isinstance(v, dict):
            restore_state_(torch, tree[k], v)
        else:
            tree[k] = v


class VoteRecorder:
    """Within the block, the packed votes every ``apply_vote`` /
    ``apply_ternary_vote`` launch takes, in launch order (one a leaf)."""

    def __init__(self, ops):
        self.ops, self.votes = ops, []

    def __enter__(self):
        self.orig = {k: getattr(self.ops, k) for k in ("apply_vote",
                                                       "apply_ternary_vote")}

        def wrap(fn):
            def apply(p, votes, *a, **kw):
                self.votes.append(votes.detach().to("cpu", copy=True))
                return fn(p, votes, *a, **kw)
            return apply
        for k, fn in self.orig.items():
            setattr(self.ops, k, wrap(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.ops, k, fn)


def unpack_votes(torch, words, n: int, codec: str):
    """Packed votes (1-bit, or 2-bit for ternary2bit) -> (n,) int8, by the
    plain versions (no kernel launch)."""
    from repro_torch.kernels import ref
    if codec == "ternary2bit":
        return ref.ternary_unpack(words[None], torch.int8)[0, :n]
    return ref.bitunpack(words[None], torch.int8)[0, :n]


def tp_adv_config(mode: str, p: float, opt: dict):
    """19g's train config: 19a's sign1bit cell with `opt` and one
    adversary of `mode` (flip_prob `p`)."""
    from repro_torch.configs.base import ByzantineConfig, VoteStrategy
    tcfg = train_config("sign1bit")
    opt = {k: VoteStrategy(v) if k == "vote_strategy" else v
           for k, v in opt.items()}
    return dataclasses.replace(
        tcfg, optimizer=dataclasses.replace(tcfg.optimizer, **opt),
        byzantine=ByzantineConfig(mode=mode, num_adversaries=1,
                                  seed=TP_SEED, flip_prob=p))


def tp_adv_launches(art, params, evil: bool) -> dict:
    """19g's kernel launches on one rank: leaf-wise the 1-bit wire's
    (:func:`mesh_launches`), the adversarial voter's symbols taking one
    adversary launch and one bitpack a leaf; under the plan the walk's
    (psum_int8 buckets launch none) and the adversary once a segment of the
    rank's flat buffer (``vote_plan.shard_plan``: each sharded leaf's
    block, each run of adjacent replicated leaves). ``adversary_map``
    counts the adversary's launches under a counter map: a leaf's block cut
    along a dim after its first (``core.prng.counter_map``), or such a
    segment."""
    from repro_torch.core import prng
    shard = art.optimizer.shard
    if shard is None:
        want = mesh_launches("allgather_1bit", 1, len(params), None)
        if evil:
            mapped = sum(1 for k, x in params.items()
                         if "model" in art.param_specs[k]
                         and prng.counter_map(
                             tuple(x.shape),
                             art.param_specs[k].index("model"),
                             art.mesh_sizes["model"],
                             art.mesh_coords["model"])[1])
            want.update(bitpack=len(params), adversary=len(params),
                        adversary_map=mapped)
    else:
        want = mesh_launches("plan_overlap", 1, len(params), shard.plan)
        if evil:
            want["adversary"] = len(shard.segments)
            want["adversary_map"] = sum(1 for g in shard.segments
                                        if g.block)
    return {k: v for k, v in want.items() if v}


def tp_fused_draws(cfg, tcfg, art) -> int:
    """The adversary's draws of an adversarial voter's rank in the fused
    ZeRO backward of one step: one a fused leaf, layer and microbatch."""
    if not tcfg.fsdp:
        return 0
    return sum(cfg.num_layers if k.startswith("layers.") else 1
               for k in art.fused_leaves) * tcfg.microbatches


def tp_moe_launches(cfg, tcfg, art, params, evil: bool) -> dict:
    """19d's kernel launches on one rank: the Mode B fsdp step's
    (:func:`fsdp_launches`) and, on the adversarial voter's ranks (19g-3),
    one adversary launch a fused draw (:func:`tp_fused_draws`, each block
    from counter 0: no counter map) and one a leaf voted on the wire
    (``adversary_map``: those whose block the map cuts)."""
    from repro_torch.core import prng
    raw = [k for k in params if k not in art.fused_leaves]
    want = fsdp_launches("mode_b", len(raw), len(art.fused_leaves), 1,
                         mesh=True)
    if evil:
        want["adversary"] = len(raw) + tp_fused_draws(cfg, tcfg, art)
        want["adversary_map"] = sum(
            1 for k in raw if "model" in art.param_specs[k]
            and prng.counter_map(tuple(params[k].shape),
                                 art.param_specs[k].index("model"),
                                 art.mesh_sizes["model"],
                                 art.mesh_coords["model"])[1])
    return {k: v for k, v in want.items() if v}


def ternary_words_of(torch, x):
    """A flat int8 {-1, 0, +1} tensor -> its 2-bit words on the host, by
    the plain version a TP_ADV_CHUNK at a time (no kernel launch)."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import ref
    out = []
    for lo in range(0, x.numel(), TP_ADV_CHUNK):
        part = sc.pad_last(x[lo:lo + TP_ADV_CHUNK][None], sc.PACK2)[0]
        out.append(ref.ternary_pack(part)[0].cpu())
    return torch.cat(out)


class AdvTwinRecorder:
    """Within the block (a stacked twin's step), voter 0's adversary draws
    kept on the host as 2-bit words (the signs it sent and, for blind, its
    honest signs): those under a step a call at a time in call order
    (:attr:`rows`), and of those under no step (the fused backward's, each
    row from counter 0) the longest row (:attr:`fused`)."""

    def __init__(self, torch, blind: bool):
        self.torch, self.blind, self.rows, self.fused = torch, blind, [], None

    def __enter__(self):
        from repro_torch.core import byzantine
        self.mod, self.orig = byzantine, byzantine.evil_signs_

        def evil_signs_(signs, cfg, ids, **kw):
            r = list(ids).index(0) if 0 in ids else None
            honest = (signs[r].reshape(-1).clone()
                      if r is not None and self.blind else None)
            out = self.orig(signs, cfg, ids, **kw)
            fused = kw.get("step") is None
            if r is not None and not (fused and self.fused is not None and
                                      self.fused["n"] >= signs[r].numel()):
                t = self.torch
                row = {"n": signs[r].numel(),
                       "sent": ternary_words_of(t, signs[r].reshape(-1)),
                       "honest": (None if honest is None
                                  else ternary_words_of(t, honest))}
                if fused:
                    self.fused = row
                else:
                    self.rows.append(row)
            return out
        byzantine.evil_signs_ = evil_signs_
        return self

    def __exit__(self, *exc):
        self.mod.evil_signs_ = self.orig

    def save(self, path: str) -> None:
        self.torch.save({"stepped": self.rows, "fused": self.fused}, path)


class TwinBlockDraws:
    """Within the block, a stacked twin's fused ZeRO backward draws an
    adversary's signs of every leaf that `specs` cut over ``"model"`` block
    by block, each of the `parts` blocks (of each layer of a stacked leaf)
    drawn as a whole from counter 0: what the reference's fused backward
    draws on each model rank, inside its region manual over ``"model"``
    (``src/repro/core/majority_vote.py:139-176``). Other leaves draw as the
    twin does."""

    def __init__(self, specs, parts):
        self.specs, self.parts, self.leaf = specs, parts, None

    def __enter__(self):
        from repro_torch.core import byzantine
        from repro_torch.core import majority_vote as mv
        from repro_torch.core import sign_compress as sc
        from repro_torch.train import train_step as TS
        self.mv, self.orig = mv, mv.fused_signs
        self.cls, self.call = TS.StackedFusedVote, TS.StackedFusedVote.__call__
        ctx, call = self, self.call

        def named(vote, i, k, g):
            ctx.leaf = k
            return call(vote, i, k, g)

        def fused_signs(g, byz, replica, rows=1):
            spec = ctx.specs.get(ctx.leaf, ())
            if "model" not in spec or byz is None or byz.mode == "none" \
                    or replica >= byz.num_adversaries:
                return ctx.orig(g, byz, replica, rows)
            s = sc.sign_ternary(g)
            dim = spec.index("model")
            width = s.shape[dim] // ctx.parts
            for j in range(ctx.parts):
                blk = s.narrow(dim, j * width, width).contiguous()
                byzantine.evil_signs_(blk.view(rows, -1), byz,
                                      [replica] * rows, step=None)
                s.narrow(dim, j * width, width).copy_(blk)
            return s
        TS.StackedFusedVote.__call__ = named
        mv.fused_signs = fused_signs
        return self

    def __exit__(self, *exc):
        self.mv.fused_signs = self.orig
        self.cls.__call__ = self.call


class AdvCheck:
    """Within the block (a model-axis step on an adversarial voter's rank),
    each draw held bit for bit against the stacked twin's rows
    (:class:`AdvTwinRecorder`, in `path`) at the block's global
    coordinates (``core.prng.mapped_counters`` of its counter map): the
    i-th draw under a step against the twin's i-th row (leaf-wise) or
    every such draw against its one flat row (`flat`: a plan); each row
    of a draw under no step (the fused backward's, from counter 0) against
    the twin's longest such row. Random: the sent signs equal; blind: the
    flip mask equal wherever the honest signs agree (on at least
    TP_VOTE_AGREE of them). Plain ops only: no kernel launch."""

    def __init__(self, torch, path: str, blind: bool, flat: bool):
        self.torch, self.path, self.blind, self.flat = torch, path, blind, \
            flat
        self.calls = self.coords = self.honest_same = self.mapped = 0
        self.fused_calls = 0

    def _twin(self, row: dict, key: str, pos):
        from repro_torch.kernels import ref
        w0, w1 = int(pos[0]) // 16, int(pos[-1]) // 16 + 1
        words = row[key][w0:w1].to(pos.device)
        return ref.ternary_unpack(words[None], self.torch.int8)[0][
            pos - 16 * w0]

    def _hold(self, sent, honest, row: dict, cut: dict, what: str) -> None:
        """`sent` (flat) against the twin's `row` at the counters of
        `cut`'s map, a TP_ADV_CHUNK at a time."""
        from repro_torch.core import prng
        for lo in range(0, sent.numel(), TP_ADV_CHUNK):
            hi = min(sent.numel(), lo + TP_ADV_CHUNK)
            pos = prng.mapped_counters(hi - lo, cut["offset"], lo,
                                       cut["block"], cut["gap"],
                                       device=sent.device)
            if int(pos[-1]) >= row["n"]:
                raise AssertionError(f"19g: a draw reaches counter "
                                     f"{int(pos[-1])} of {row['n']}")
            want = self._twin(row, "sent", pos)
            if self.blind:
                was = self._twin(row, "honest", pos)
                same = honest[lo:hi] == was
                self.honest_same += int(same.sum())
                bad = ((sent[lo:hi] != honest[lo:hi]) != (want != was)) \
                    & same
            else:
                bad = sent[lo:hi] != want
            if bool(bad.any()):
                raise AssertionError(
                    f"19g: {what} (map {cut}) differs from the twin's at "
                    f"{int(bad.sum())} of its {hi - lo} coordinates from "
                    f"{lo}")
            del pos, want, bad

    def __enter__(self):
        from repro_torch.core import byzantine
        twin = self.torch.load(self.path)
        self.rows, self.fused = twin["stepped"], twin["fused"]
        self.mod, self.orig = byzantine, byzantine.evil_signs_

        def evil_signs_(signs, cfg, ids, **kw):
            honest = signs.reshape(-1).clone()
            out = self.orig(signs, cfg, ids, **kw)
            sent = signs.reshape(-1)
            cut = {k: kw.get(k, 0) for k in ("offset", "block", "gap")}
            if kw.get("step") is None:
                if self.fused is None:
                    raise AssertionError("19g: a fused draw, and none in "
                                         "the twin")
                n = sent.numel() // len(ids)
                for r in range(len(ids)):
                    self._hold(sent[r * n:(r + 1) * n],
                               honest[r * n:(r + 1) * n], self.fused, cut,
                               f"fused draw {self.fused_calls} row {r}")
                self.fused_calls += 1
            else:
                row = self.rows[0 if self.flat else self.calls]
                self._hold(sent, honest, row, cut, f"draw {self.calls}")
                self.calls += 1
                self.mapped += bool(cut["block"])
            self.coords += sent.numel()
            del honest
            return out
        byzantine.evil_signs_ = evil_signs_
        return self

    def __exit__(self, *exc):
        self.mod.evil_signs_ = self.orig
        del self.rows, self.fused


def check_adversary_map(torch, ops, ref, dev, err, cfg) -> dict:
    """19g's kernel checks (their launches count in no path): (1) the
    adversary under a column cut of the unembedding (model rank 1's block
    (151,552, 2,048) of the (151,552, 4,096) table cut in two along its
    columns: runs of 2,048) against its plain version, in windows at the
    block's start, inside a run, across a run's end and at its tail, for
    random and blind at 0.9; (2) every leaf that 19a's layout shards over
    model 2: each rank's block drawn under the map against the same block
    of the whole leaf's draw, both by the kernel."""
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import byzantine, prng
    from repro_torch.distributed import sharding as shd
    gen = torch.Generator(device=dev).manual_seed(19)
    (rows, cols), parts = ADV_MAP_TABLE, 2
    local = rows * cols // parts
    base, block, gap = prng.counter_map((rows, cols // parts), 1, parts, 1)
    windows = ((0, ADV_WINDOW), (block * 1000 + 7, ADV_WINDOW),
               (local - ADV_WINDOW // 2 - block // 2 - 3, ADV_WINDOW // 2),
               (local - (ADV_WINDOW - 5), ADV_WINDOW - 5))
    checks = 0
    for mode, p in (("random", 0.5), ("blind", 0.9)):
        cfg_b = ByzantineConfig(mode=mode, num_adversaries=M_MAIN, seed=5,
                                flip_prob=p)
        keys = [byzantine.adversary_key(cfg_b, r, step=3)
                for r in range(M_MAIN)]
        for start, length in windows:
            x = torch.randint(-1, 2, (M_MAIN, length), generator=gen,
                              device=dev, dtype=torch.int8)
            want = ref.adversary(x, keys, p, mode == "blind", base, start,
                                 block, gap)
            got = ops.adversary_(x.clone(), keys, p, mode == "blind", base,
                                 start=start, block=block, gap=gap)
            err["adversary"] = max(err["adversary"], require_equal(
                f"adversary {mode} under a column cut at {start}", got,
                want))
            checks += 1
            del x, want, got
    # every sharded leaf of 19a's layout, each block against the whole
    shapes = cfg.param_shapes()
    specs = shd.param_specs(shapes, fsdp=False,
                            mesh_shape={"data": 2, "model": parts})
    cfg_b = ByzantineConfig(mode="blind", num_adversaries=1, seed=5,
                            flip_prob=0.9)
    key = [byzantine.adversary_key(cfg_b, 0, step=1)]
    leaves = 0
    for k, spec in specs.items():
        if "model" not in spec:
            continue
        dim = spec.index("model")
        x = torch.randint(-1, 2, tuple(shapes[k]), generator=gen,
                          device=dev, dtype=torch.int8)
        whole = ops.adversary_(x.clone().view(1, -1), key, 0.9, True)
        whole = whole.view(tuple(shapes[k]))
        for idx in range(parts):
            blk = x.narrow(dim, idx * x.shape[dim] // parts,
                           x.shape[dim] // parts).contiguous()
            off, b, g = prng.counter_map(tuple(blk.shape), dim, parts, idx)
            got = ops.adversary_(blk.view(1, -1), key, 0.9, True, off,
                                 block=b, gap=g)
            require_equal(f"adversary: {k} block {idx} under the map",
                          got.view(blk.shape), whole.narrow(
                              dim, idx * x.shape[dim] // parts,
                              x.shape[dim] // parts))
            del blk, got
        leaves += 1
        del x, whole
    sync(torch, dev)
    out = {"column_cut_checks": checks, "windows": windows,
           "map": {"offset": base, "block": block, "gap": gap},
           "sharded_leaves_checked": leaves}
    log({"phase": "adversary_map_vs_plain", **out,
         "max_abs_err": err["adversary"]})
    return out


def tp_train_runs() -> list:
    """Phase 19's train runs beside their twins: (label, config, train
    config, whether the twin keeps its votes)."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    runs = [(codec, cfg, train_config(codec), True) for codec in TP_CODECS]
    runs.append(("moe_fsdp",) + tp_moe_config() + (False,))
    runs += [(arch,) + tp_family_config(arch) + (True,)
             for arch, *_ in TP_FAMILIES]
    runs += [(f"f32_{arch}",) + tp_family_config(arch, "float32") + (False,)
             for arch, *_ in TP_FAMILIES]
    runs += [(label, cfg, tp_adv_config(mode, p, opt), True)
             for label, mode, p, opt in TP_ADV_RUNS]
    return runs


def tp_train_twin(torch, dev, scratch: str, runs=None,
                  voters: int = TP_VOTERS) -> dict:
    """The stacked twins (M = `voters` on the card, no model axis) of
    `runs` (default :func:`tp_train_runs`: 19a per codec, 19d and 19e per
    arch): step 0's losses, each leaf's step-0 vote (int8, on the host)
    and the leaves' flippable masks (some voter's |m'| under
    TP_FLIP_FRACTION of the leaf's largest; Mode B's global momentum
    alone), an adversary's draws and an MoE's routing calls, written to
    `scratch` for the comparison after the ranks."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as TS
    out = {}
    for label, cfg, tcfg, votes_too in runs or tp_train_runs():
        art = TS.make_train_step(cfg, tcfg, voters, device=dev)
        params, state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
        batch = tp_train_batch(torch, cfg, tcfg, 0, dev)
        adv = (AdvTwinRecorder(torch, tcfg.byzantine.mode == "blind")
               if tcfg.byzantine.num_adversaries else
               contextlib.nullcontext())
        # the fused backward's draws made model block by model block, as
        # 19d's model ranks (and the reference's) make them
        blocks = (TwinBlockDraws(shd.param_specs(
            cfg.param_shapes(), fsdp=True, mesh_shape=dict(zip(
                TP_TRAIN_MESH[1], TP_TRAIN_MESH[0]))), TP_TRAIN_MESH[0][1])
                  if tcfg.fsdp else contextlib.nullcontext())
        with VoteRecorder(ops) as rec, RouteRecorder(torch) as routes, \
                adv, blocks:
            params, state, met = art.step_fn(params, state, batch, 0)
        out[label] = {"loss": float(met["loss"])}
        if tcfg.byzantine.num_adversaries:
            adv.save(os.path.join(scratch, f"tp_adv_twin_{label}.pt"))
            out[label]["draws"] = len(adv.rows) + (adv.fused is not None)
        if cfg.moe.enabled:
            torch.save(routes.calls, os.path.join(scratch,
                                                  f"tp_routes_{label}.pt"))
        if votes_too:
            save_twin_votes(torch, params, state, rec.votes,
                            os.path.join(scratch, f"tp_twin_{label}.pt"))
        if label.startswith("f32_"):
            # each voter's step-0 momentum, the leaf's largest |m'| and
            # the loss, for 19e's float32 twins on the ranks
            for v in range(voters):
                m = {k: t[v].to("cpu", copy=True)
                     for k, t in state["momentum"].items()}
                torch.save({"m": m, "loss": out[label]["loss"],
                            "largest": {k: float(t.abs().max())
                                        for k, t in m.items()}},
                           os.path.join(scratch, f"tp_{label}_v{v}.pt"))
                del m
        del params, state, art, rec, routes
        reset_peak(torch, dev)
    return out


def save_twin_votes(torch, params, state, votes, path) -> None:
    """Each leaf's recorded vote words and its flippable mask (packed 32
    a word: +1 where some voter's |m'| is near zero) to `path`."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import ref
    kept, flippable = {}, {}
    for (k, p), w in zip(params.items(), votes):
        kept[k] = (w, p.numel())
        m = state["momentum"][k].float().abs()
        a = m.view(1 if m.dim() == p.dim() else m.shape[0], -1)
        near = (a < TP_FLIP_FRACTION * a.max()).any(0)
        flippable[k] = ref.bitpack(sc.pad_last(near.to(torch.int8).mul_(
            2).sub_(1)[None], sc.PACK)[0])[0].cpu()
        del a, m, near
    torch.save({"votes": kept, "flippable": flippable}, path)


def tp_moe_config():
    """19d's cut of the qwen3-moe-235b-a22b Mode B fsdp preset, with 19g-3's
    adversary."""
    from repro_torch.configs.base import (MomentumMode, ShapeCell,
                                          VoteStrategy, get_config)
    from repro_torch.configs.presets import default_train_config
    cfg = dataclasses.replace(get_config(TP_MOE_ARCH),
                              num_layers=TP_MOE_LAYERS)
    preset = default_train_config(TP_MOE_ARCH, ShapeCell(
        "train_smoke", SEQ, GLOBAL_BATCH, "train"))
    opt = preset.optimizer
    if (opt.kind, opt.momentum_mode, opt.vote_strategy, preset.remat,
            preset.fsdp) != ("signsgd_vote", MomentumMode.GLOBAL,
                             VoteStrategy.HIERARCHICAL, "nested", True):
        raise AssertionError(f"not the {TP_MOE_ARCH} Mode B preset: "
                             f"{preset}")
    from repro_torch.configs.base import ByzantineConfig
    return cfg, dataclasses.replace(
        preset, microbatches=TP_MOE_MICRO, byzantine=ByzantineConfig(
            mode=TP_MOE_ADVERSARY, num_adversaries=1, seed=TP_SEED))


def tp_family_config(arch: str, dtype: str = ""):
    """19e's cut of `arch` and its preset (seq 512, batch 8); with `dtype`
    "float32", its float32 twin (parameters and momentum, one microbatch:
    with more, the sign family's accumulator is bf16, the reference's
    ``acc_dt``)."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.configs.presets import default_train_config
    _, depth, enc, micro = next(f for f in TP_FAMILIES if f[0] == arch)
    cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                              **({"encoder_layers": enc} if enc else {}),
                              **({"dtype": dtype} if dtype else {}))
    preset = default_train_config(arch, ShapeCell(
        "train_smoke", SEQ, GLOBAL_BATCH, "train"))
    if dtype:
        preset = dataclasses.replace(preset, optimizer=dataclasses.replace(
            preset.optimizer, momentum_dtype=dtype))
        micro = 1
    return cfg, dataclasses.replace(preset, microbatches=micro)


def tp_train_batch(torch, cfg, tcfg, step: int, dev) -> dict:
    """Step `step`'s global batch: the pipeline's tokens and, for the
    encoder-decoder, TP_FRAMES stubbed frames a row from a generator
    seeded by the step (the same on every rank and in the twin)."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.data.pipeline import SyntheticLMPipeline
    tokens = SyntheticLMPipeline(cfg, tcfg.global_batch, tcfg.seq_len,
                                 seed=0).global_batch_at(step)["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if cfg.family == ArchFamily.AUDIO:
        batch["enc_embeds"] = torch.randn(
            (tcfg.global_batch, TP_FRAMES, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(step),
            device=dev).to(getattr(torch, cfg.dtype))
    return batch


class RouteRecorder:
    """Within the block, every MoE block's routing on the host: each
    ``moe.route_topk`` call's experts, the relative margin of each token's
    k-th over its (k+1)-th router probability, and which tokens had a
    slot dropped by the dispatch that follows it (``moe.dispatch_plan``)."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import moe
        torch, self.moe = self.torch, moe
        self.orig = moe.route_topk, moe.dispatch_plan

        def route(logits, k):
            out = self.orig[0](logits, k)
            probs = torch.sort(torch.softmax(logits.float(), -1), -1,
                               descending=True)[0]
            margin = (probs[:, k - 1] - probs[:, k]) / probs[:, k - 1]
            self.calls.append([out[1].detach().cpu(),
                               margin.detach().cpu(), None])
            return out

        def dispatch(experts, num_experts, capacity):
            plan = self.orig[1](experts, num_experts, capacity)
            self.calls[-1][2] = (plan["slots"] == num_experts * capacity
                                 ).any(-1).cpu()
            return plan
        moe.route_topk, moe.dispatch_plan = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route_topk, self.moe.dispatch_plan = self.orig


def route_flips(torch, what: str, mine: list, twin: list, tie: float,
                seq: int = 1, depth: int = 0, excused=None, group: int = 0,
                carried: bool = True) -> tuple:
    """The tokens whose experts in the calls `mine` differ from the calls
    `twin` (the same calls, in order), each required at a near tie: the
    twin's relative top-k margin under `tie`; a token whose slot was
    dropped in one and kept in the other is allowed only beside such a
    flip in its call (it follows from the flip through the experts'
    capacity). A flip or a moved drop moves its token's residual, which
    the later layers of the same forward read at that position and, by
    attention, at the row's later ones: there a token may differ at any
    margin, as in a row of `excused` (a bool a row: touched in an earlier
    tick). A forward is `group` calls (default all of them; a train step's
    microbatch with its recompute). With `carried` False nothing is
    excused: every difference must be at a near tie (the float32 twins,
    whose ties are rare enough). Returns the count of flips and two
    bool tensors, one entry a row of the calls' tokens (`seq` tokens a
    row): `own`, where a flip or a moved drop touched the row's last token
    (its own logits move), and `carry`, where one touched any of its
    tokens in a call before the last of a forward of `depth` layers, one
    call a layer (the layers after it cache the moved residual, so the
    row's later tokens move too; when the calls are not one a layer,
    every flip carries)."""
    if len(mine) != len(twin):
        raise AssertionError(f"{what}: {len(mine)} routing calls against "
                             f"the twin's {len(twin)}")
    n = mine[0][0].shape[0] // seq if mine else 0
    own = torch.zeros(n, dtype=torch.bool)
    carry = torch.zeros(n, dtype=torch.bool)
    start = (excused.clone() if excused is not None
             else torch.zeros(n, dtype=torch.bool))[:, None].expand(n, seq)
    moved_on = start.clone()
    flips = 0
    for i, ((e, _, drop), (te, margin, tdrop)) in enumerate(zip(mine,
                                                                 twin)):
        if group and i % group == 0:
            moved_on = start.clone()
        bad = (torch.sort(e, -1)[0] != torch.sort(te, -1)[0]).any(-1)
        free = moved_on.reshape(-1) & carried
        if bool((bad & ~free & (margin >= tie)).any()):
            raise AssertionError(
                f"{what}: a token's experts differ from the twin's at a "
                f"margin of {float(margin[bad & ~free].max())}, over "
                f"{tie}, with no flip before it in its row")
        moved = drop != tdrop
        if bool(moved.any()) and not bool(bad.any()):
            raise AssertionError(f"{what}: a token's slot was dropped in "
                                 "one run and kept in the other with no "
                                 "routing flip in its call")
        flips += int(bad.sum())
        hit = (bad | moved).view(-1, seq)
        own |= hit[:, -1]
        if len(mine) != depth or i < len(mine) - 1:
            carry |= hit.any(-1)
        # the positions at and after a row's first moved token
        moved_on = moved_on | (torch.cummax(hit.to(torch.int8), 1)[0] > 0)
    return flips, own, carry


def tp_serve_cfg(kv: str, depth: int, dtype: str):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("glm4-9b"), num_layers=depth,
                               dtype=dtype, kv_cache_dtype=kv)


def quantized_cache(cache: dict) -> dict:
    """A bf16 attention cache's int8 form, row by row (``quantize_kv``)."""
    from repro_torch.models import layers as L
    (kq, ks), (vq, vs) = L.quantize_kv(cache["k"]), L.quantize_kv(cache["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def tp_prompts(torch, lens, vocab: int) -> list:
    """The seeded prompt of each row, (1, S) int64 on the host."""
    return [torch.randint(0, vocab, (1, s), generator=torch.Generator(
        ).manual_seed(TP_SEED + b)) for b, s in enumerate(lens)]


def tp_serve_reference(torch, dev, scratch: str) -> dict:
    """19c's single-device serving (the one-device serve steps) on the
    parameters every rank draws, per run and model (bf16 at
    TP_SERVE_DEPTH, float32 at TP_TWIN_DEPTH): each row's prompt prefilled
    and re-homed into the batch cache, then greedy ticks, each row at its
    own position; the prefill's last logits, every tick's logits and the
    greedy tokens written to `scratch`. Returns the tick ms."""
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as SS
    out, kept = {}, {}
    for label, _, _, kv, lens, T, ticks in TP_SERVE_RUNS:
        for dtype, depth in (("bfloat16", TP_SERVE_DEPTH),
                             ("float32", TP_TWIN_DEPTH)):
            cfg = tp_serve_cfg(kv, depth, dtype)
            params = M.init_params(cfg, torch.Generator(
                device=dev).manual_seed(TP_SEED), dev)
            prompts = [p.to(dev) for p in tp_prompts(torch, lens,
                                                     cfg.vocab_size)]
            B = len(lens)
            if label in TP_INT8_FROM:
                first, cache = kept.pop((TP_INT8_FROM[label], dtype))
            elif len(set(lens)) == 1:
                lg, cache = SS.make_prefill(cfg)(params, {
                    "tokens": torch.cat(prompts)})
                cache = SS.make_cache_rehome(cfg, B, T)(cache)
                first = lg[:, -1].float()
            else:
                cache, first = None, []
                for b, p in enumerate(prompts):
                    lg, c = SS.make_prefill(cfg)(params, {"tokens": p})
                    c = SS.make_cache_rehome(cfg, 1, T)(c)
                    if cache is None:
                        cache = {k: v.new_zeros((v.shape[0], B)
                                                + tuple(v.shape[2:]))
                                 for k, v in c.items()}
                    for k, v in c.items():
                        cache[k][:, b] = v[:, 0]
                    first.append(lg[0, -1].float())
                first = torch.stack(first)
            if label in TP_INT8_FROM.values():
                kept[(label, dtype)] = (first, quantized_cache(cache))
            step = SS.make_decode_step(cfg)
            pos = torch.tensor(lens, device=dev)
            tok = first.argmax(-1)
            toks, logits, ms = [tok.cpu()], [], []
            for i in range(ticks):
                sync(torch, dev)
                t0 = time.perf_counter()
                lg, cache = step(params, tok[:, None], cache, pos + i)
                sync(torch, dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                tok = lg.float().argmax(-1)
                toks.append(tok.cpu())
                logits.append(lg.float().cpu())
            torch.save({"first": first.cpu(), "tokens": toks,
                        "logits": logits},
                       os.path.join(scratch, f"tp_serve_{label}_{dtype}.pt"))
            out[f"{label}_{dtype}"] = {"tick_ms": ms}
            del params, cache, step
            reset_peak(torch, dev)
    return out


def tp_rank(rank: int, init: str, scratch: str, dev_type: str,
            queue) -> None:
    """One rank of phase 19's world (a spawned process): 19a, 19d, 19e and
    its float32 twins, 19c, 19f; puts ``(rank, results)`` on `queue`, or
    ``(rank, {"error": ...})``."""
    import traceback
    try:
        queue.put((rank, tp_rank_body(rank, init, scratch, dev_type)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def tp_step(torch, ops, ref, sc, mesh, art, params, state, batch, step,
            want, checked: bool, err: dict, held: dict, what: str,
            record=None) -> tuple:
    """One model-axis train step with its launches held to `want` (and,
    when `checked`, every launch held against its plain version); returns
    (params, state, metrics, timing row)."""
    dev = batch["tokens"].device
    sync(torch, dev)
    mesh.reset_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with (plain_checked(torch, ops, ref, sc, err, what, MESH_CHECKED, held)
          if checked else contextlib.nullcontext()):
        with (record if record is not None else contextlib.nullcontext()):
            params, state, met = art.step_fn(params, state, batch, step)
    sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if (launches or dev.type == "cuda") and launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{want}")
    if checked and dev.type == "cuda" and held != launches:
        raise AssertionError(f"{what}: held {held} of the launches "
                             f"{launches} against their plain versions")
    row = {"ms": ms, "vote_ms": mesh.stats.seconds * 1e3,
           "tp_ms": mesh.model_stats.seconds * 1e3,
           "vote_bytes": mesh.stats.bytes, "tp_bytes": mesh.model_stats.bytes,
           "launches": launches}
    row["other_ms"] = ms - row["vote_ms"] - row["tp_ms"]
    return params, state, {k: float(v) for k, v in met.items()}, row


def replicated_checksum(torch, art, params) -> str:
    """The checksum of the leaves whole on every rank (no spec entry)."""
    return device_checksum(torch, [
        params[k] for k in sorted(params)
        if all(e is None for e in art.param_specs[k])])


def tp_train_rank(torch, rank, mesh, cfg, tcfg, dev, label, want_fn,
                  vote_bytes, scratch, out, record_votes: bool,
                  twice: bool = True) -> None:
    """19a / 19d / 19e / 19g on this rank: step 0 from a state saved on
    the host, step 0 again from it (bit-equal: `twice`), then step 1; the
    launches exact and, on step 0, each held against its plain version;
    the bytes by axis held to the layout's counts; the replicated leaves'
    checksums, the step-0 votes (data index 0, `record_votes`) and, for an
    MoE, the step-0 routing calls kept for the main process. With an
    adversary (19g) its step-0 draws on an adversarial voter's ranks are
    held to the twin's (:class:`AdvCheck`), one a leaf, or one a segment
    of the rank's plan buffer."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import ops, ref
    from repro_torch.train import train_step as TS
    art = TS.make_train_step(cfg, tcfg, device=dev, mesh=mesh)
    params, state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    reset_peak(torch, dev)
    want = want_fn(art, params)
    expect_tp = tp_bytes(cfg, tcfg, mesh, TP_FRAMES)
    expect_vote = vote_bytes(art, params)
    # the start state kept on the host: four ranks share the card
    saved = ((clone_state(torch, params, True),
              clone_state(torch, state, True)) if twice else None)
    rows, mets, sums, err, held = [], [], [], {}, {}
    routes, draws = [], None
    for run, step in enumerate((0, 0, 1) if twice else (0, 1)):
        if run == 1 and twice:
            restore_state_(torch, params, saved[0])
            restore_state_(torch, state, saved[1])
            del saved
        batch = tp_train_batch(torch, cfg, tcfg, step, dev)
        rec = (VoteRecorder(ops) if run == 0 and record_votes
               and mesh.axis_index("data") == 0 else None)
        byz = tcfg.byzantine
        check = (AdvCheck(torch, os.path.join(scratch,
                                              f"tp_adv_twin_{label}.pt"),
                          byz.mode == "blind", art.plan is not None)
                 if run == 0 and byz.num_adversaries
                 and mesh.replica_index() < byz.num_adversaries else None)
        with (RouteRecorder(torch) if run == 0 and cfg.moe.enabled
              else contextlib.nullcontext()) as route, \
                (check if check is not None else contextlib.nullcontext()):
            params, state, met, row = tp_step(
                torch, ops, ref, sc, mesh, art, params, state, batch, step,
                want, run == 0, err, held,
                f"tp {label} rank {rank} step {step} run {run}", rec)
        if check is not None:
            shard = art.optimizer.shard
            n = len(params) if shard is None else len(shard.segments)
            # the fused leaves draw in the backward, once a layer and
            # microbatch, under no step
            fused = tp_fused_draws(cfg, tcfg, art)
            n -= len(art.fused_leaves) if tcfg.fsdp else 0
            if (check.calls, check.fused_calls) != (n, fused):
                raise AssertionError(
                    f"tp {label} rank {rank}: {check.calls} adversary draws "
                    f"under a step and {check.fused_calls} fused, expected "
                    f"{n} and {fused}")
            if check.blind and check.honest_same < TP_VOTE_AGREE \
                    * check.coords:
                raise AssertionError(
                    f"tp {label} rank {rank}: the honest signs agree with "
                    f"the twin's on {check.honest_same} of {check.coords}")
            draws = {"calls": check.calls, "coords": check.coords,
                     "honest_same": check.honest_same,
                     "mapped": check.mapped,
                     "fused_calls": check.fused_calls}
        if route is not None:
            routes = route.calls
        if row["tp_bytes"] != expect_tp:
            raise AssertionError(f"tp {label} rank {rank}: the model group "
                                 f"took {row['tp_bytes']} bytes, the "
                                 f"layout's count is {expect_tp}")
        if row["vote_bytes"] != expect_vote:
            raise AssertionError(f"tp {label} rank {rank}: the vote axes "
                                 f"took {row['vote_bytes']} bytes, the "
                                 f"layout's count is {expect_vote}")
        if rec is not None:
            torch.save({k: (w, tuple(p.shape)) for (k, p), w in zip(
                params.items(), rec.votes)}, os.path.join(
                    scratch, f"tp_votes_{label}_rank{rank}.pt"))
        rows.append(row)
        mets.append(met)
        sums.append({"state": (mesh_state_checksum(torch, params, state,
                                                   None)
                               if twice and run < 2 else None),
                     "replicated": replicated_checksum(torch, art, params)})
    if routes:
        twin = torch.load(os.path.join(scratch, f"tp_routes_{label}.pt"))
        per = len(twin) // mesh.size
        v = mesh.replica_index()
        out_routes = route_flips(torch, f"tp {label} rank {rank}", routes,
                                 twin[v * per:(v + 1) * per], TP_ROUTE_TIE,
                                 tcfg.seq_len, group=len(routes)
                                 // tcfg.microbatches)[0]
    else:
        out_routes = None
    if rank == 0:
        log({"phase": "tp_rank0_progress", "run": label,
             "step_ms": [r["ms"] for r in rows],
             "tp_ms": [r["tp_ms"] for r in rows],
             "vote_ms": [r["vote_ms"] for r in rows],
             "losses": [m["loss"] for m in mets]})
    out[label] = {"rows": rows, "metrics": mets, "checksums": sums,
                  "held": held, "max_abs_err": err,
                  "peak_bytes": peak_bytes(torch, dev),
                  "expected_tp_bytes": expect_tp,
                  "expected_vote_bytes": expect_vote,
                  "routing_flips": out_routes, "twice": twice,
                  "draws": draws,
                  "mesh": [list(mesh.axis_sizes.values()),
                           list(mesh.axis_sizes)],
                  "specs": {k: list(s) for k, s in art.param_specs.items()}}
    del params, state, art
    reset_peak(torch, dev)


def tp_f32_train_rank(torch, rank, mesh, label, cfg, tcfg, dev, scratch,
                      out) -> None:
    """A float32 twin run `label` on this rank (19e's of each TP_FAMILIES
    cut, 19h's of its M2 cut): parameters and momentum in float32, step 0
    once from the seeded state with its launches exact, against the
    stacked float32 step (M = 2; 19h M = 1): its loss within TP_TWIN_TOL
    of the twin's (relative) and each leaf's step-0 momentum m' (the
    rank's voter, its block) within TP_TWIN_TOL of the twin leaf's largest
    |m'| (a bound stated before its first run); an MoE's routing calls
    against the twin's, every difference at a float32 near tie
    (TP_ROUTE_TIE_F32), none excused. m' comes before the vote, so no flip
    moves it: it holds the backward over the model axis (the xBC gather's
    reduce-scatter, the gated norm's group sum, the shared block's and the
    cross-attention's gradients, M2's partial expert sums) where the bf16
    votes are rounding noise. Float32 sum order moves m' by about 1e-6 of
    its largest; a gradient that misses a group sum, by a large share."""
    from repro_torch.core import sign_compress as sc
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops, ref
    from repro_torch.train import train_step as TS
    art = TS.make_train_step(cfg, tcfg, device=dev, mesh=mesh)
    params, state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    reset_peak(torch, dev)
    what = f"tp {label} rank {rank}"
    route = RouteRecorder(torch) if cfg.moe.enabled else None
    params, state, met, row = tp_step(
        torch, ops, ref, sc, mesh, art, params, state,
        tp_train_batch(torch, cfg, tcfg, 0, dev), 0,
        mesh_launches("psum_int8", rank, len(params), None), False, {}, {},
        what, route)
    flips = None
    if route is not None:
        twin = torch.load(os.path.join(scratch, f"tp_routes_{label}.pt"))
        per = len(twin) // mesh.size
        v = mesh.replica_index()
        flips = route_flips(torch, what, route.calls,
                            twin[v * per:(v + 1) * per], TP_ROUTE_TIE_F32,
                            tcfg.seq_len, carried=False)[0]
        del twin, route
    twin = torch.load(os.path.join(
        scratch, f"tp_{label}_v{mesh.replica_index()}.pt"), mmap=True)
    shares = {}
    for k, g in state["momentum"].items():
        t = shd.shard_leaf(twin["m"][k], art.param_specs[k], mesh.coords,
                           mesh.axis_sizes).to(dev)
        if g.numel() != t.numel():
            raise AssertionError(f"{what} {k}: momentum block of "
                                 f"{g.numel()} against the twin's "
                                 f"{t.numel()}")
        diff = float((g.float().reshape(t.shape) - t).abs().max())
        top = twin["largest"][k]
        shares[k] = diff / top if top else (0.0 if diff == 0 else math.inf)
        del t
    worst = max(shares, key=shares.get)
    loss_share = abs(met["loss"] - twin["loss"]) / abs(twin["loss"])
    if loss_share > TP_TWIN_TOL:
        raise AssertionError(f"{what}: step 0's loss {met['loss']} against "
                             f"the float32 twin's {twin['loss']}")
    if shares[worst] > TP_TWIN_TOL:
        raise AssertionError(f"{what}: {worst}'s step-0 momentum differs "
                             f"from the float32 twin's by {shares[worst]} "
                             f"of its largest |m'|, over {TP_TWIN_TOL}")
    out[label] = {"loss": met["loss"], "twin_loss": twin["loss"],
                  "loss_share": loss_share,
                  "worst_leaf": [worst, shares[worst]],
                  "leaves": len(shares), "row": row, "routing_flips": flips,
                  "peak_bytes": peak_bytes(torch, dev)}
    del params, state, art, twin
    reset_peak(torch, dev)


def tp_serve_rank(torch, rank, meshes, dev, scratch, out) -> None:
    """19c on this rank: every TP_SERVE_RUNS run, bf16 and its float32
    twin, the parameters drawn as the main process drew them and cut to
    the rank's blocks, the prompts prefilled and re-homed, then the
    reference's greedy tokens fed tick by tick; each tick's logits held to
    the single-device step's, its model-group bytes to ``tp_tick_bytes``,
    its decode path to ``_should_flash_decode``'s (CUDA events on rank 0
    time the ticks)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as SS
    kept = {}
    for label, shape, axes, kv, lens, T, ticks in TP_SERVE_RUNS:
        mesh = meshes[(shape, axes)]
        for dtype, depth in (("bfloat16", TP_SERVE_DEPTH),
                             ("float32", TP_TWIN_DEPTH)):
            cfg = tp_serve_cfg(kv, depth, dtype)
            want = torch.load(os.path.join(
                scratch, f"tp_serve_{label}_{dtype}.pt"))
            specs = SS.serve_param_shardings(cfg, mesh, fsdp=False)
            params = M.init_params(
                cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev,
                shard=lambda k, t: shd.shard_leaf(
                    t, specs[k], mesh.coords, mesh.axis_sizes).clone())
            reset_peak(torch, dev)
            prompts = [p.to(dev) for p in tp_prompts(torch, lens,
                                                     cfg.vocab_size)]
            B = len(lens)
            sync(torch, dev)
            t0 = time.perf_counter()
            if label in TP_INT8_FROM:
                first, cache, first_want = kept.pop((TP_INT8_FROM[label],
                                                     dtype))
            elif len(set(lens)) == 1:
                per = B // mesh.size
                r = mesh.replica_index()
                lg, cache = SS.make_prefill_sharded(
                    cfg, mesh, fsdp=False, global_batch=B)(
                        params, {"tokens": torch.cat(prompts)})
                cache = SS.make_cache_rehome(cfg, B, T, mesh=mesh)(
                    cache, lens[0])
                first = SS.gather_vocab(lg[:, -1], mesh).float()
                first_want = want["first"][r * per:(r + 1) * per]
            else:
                cache, first = None, []
                for b, p in enumerate(prompts):
                    lg, c = SS.make_prefill(cfg, mesh=mesh)(
                        params, {"tokens": p})
                    c = SS.make_cache_rehome(cfg, 1, T, mesh=mesh)(
                        c, lens[b])
                    if cache is None:
                        cache = {k: v.new_zeros((v.shape[0], B)
                                                + tuple(v.shape[2:]))
                                 for k, v in c.items()}
                    for k, v in c.items():
                        cache[k][:, b] = v[:, 0]
                    first.append(SS.gather_vocab(lg[0, -1], mesh).float())
                first = torch.stack(first)
                first_want = want["first"]
            if label in TP_INT8_FROM.values():
                kept[(label, dtype)] = (first, quantized_cache(cache),
                                        first_want)
            sync(torch, dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            errs = [tp_logit_check(torch, f"{label} {dtype} prefill", first,
                                   first_want.to(dev), dtype, kv)]
            step = SS.make_decode_step(cfg, mesh=mesh, max_len=T)
            spec = SS.cache_leaf_spec("k", (cfg.num_layers, B, T,
                                            cfg.num_kv_heads,
                                            cfg.resolved_head_dim),
                                      mesh.axis_sizes)
            rows = B // shd.spec_block(spec, mesh.coords,
                                       mesh.axis_sizes)[1][1]
            expect = tp_tick_bytes(cfg, mesh, rows)
            path = ("heads" if cfg.num_kv_heads % mesh.model == 0 else
                    "flash_sharded" if L._should_flash_decode(
                        cfg.num_kv_heads, T, mesh.model) else
                    "sharded_short")
            pos = torch.tensor(lens, device=dev)
            L.reset_decode_paths()
            tick_ms, tick_bytes = [], []
            for i in range(ticks):
                tok = want["tokens"][i].to(dev)
                mesh.reset_stats()
                with tick_timer(torch, dev) as timed:
                    lg, cache = step(params, tok[:, None], cache, pos + i)
                tick_ms.append(timed["ms"])
                tick_bytes.append(mesh.model_stats.bytes)
                if mesh.model_stats.bytes != expect:
                    raise AssertionError(
                        f"tp serve {label} {dtype} tick {i}: the model group "
                        f"took {mesh.model_stats.bytes} bytes, the layout's "
                        f"count is {expect}")
                errs.append(tp_logit_check(
                    torch, f"{label} {dtype} tick {i}", lg.float(),
                    want["logits"][i].to(dev), dtype, kv))
            paths = dict(L.reset_decode_paths())
            if paths != {path: ticks * cfg.num_layers}:
                raise AssertionError(f"tp serve {label} {dtype}: decode "
                                     f"paths {paths}, expected {path}")
            if rank == 0:
                log({"phase": "tp_rank0_progress", "run": f"{label}_{dtype}",
                     "prefill_ms": prefill_ms, "tick_ms": tick_ms,
                     "errs": errs})
            out[f"{label}_{dtype}"] = {
                "prefill_ms": prefill_ms, "tick_ms": tick_ms,
                "tick_tp_bytes": expect, "paths": paths,
                "max_err_share" if dtype == "bfloat16" else "max_abs_err":
                    max(errs),
                "peak_bytes": peak_bytes(torch, dev)}
            del params, cache, step, want
            reset_peak(torch, dev)


def tp_family_cfg(arch: str, depth: int, enc: int, dtype: str):
    """19f's cut of `arch` in `dtype`; a float32 twin's MoE with capacity
    factor E / k, so that no token is dropped."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                              dtype=dtype,
                              **({"encoder_layers": enc} if enc else {}))
    if cfg.moe.enabled and dtype == "float32":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def tp_family_prompts(torch, cfg, lens, dev) -> list:
    """Each row's seeded prompt as a prefill batch of one row on `dev`
    (and, for the encoder-decoder, its TP_FRAMES stubbed frames)."""
    from repro_torch.configs.base import ArchFamily
    out = []
    for b, p in enumerate(tp_prompts(torch, lens, cfg.vocab_size)):
        batch = {"tokens": p.to(dev)}
        if cfg.family == ArchFamily.AUDIO:
            batch["enc_embeds"] = torch.randn(
                (1, TP_FRAMES, cfg.d_model), generator=torch.Generator(
                    ).manual_seed(TP_SEED + 100 + b)).to(
                        dev, getattr(torch, cfg.dtype))
        out.append(batch)
    return out


def tp_family_serve_reference(torch, dev, scratch: str,
                              runs=None) -> dict:
    """19f's (or 19h's, `runs`) single-device serving on the parameters
    every rank draws, per
    run and model (bf16 at its depth, the float32 twin at its own): each
    row's prompt prefilled and re-homed into the batch cache (equal
    prompts in one prefill a data shard: the batch-sharded prefill routes
    each shard's tokens together), then greedy ticks, each row at its own
    position; the first logits, every tick's logits, the greedy tokens
    and the MoE's routing calls (the prefills' and the ticks') written to
    `scratch`. Returns the tick
    ms."""
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as SS
    out = {}
    for run in runs or TP_FAMILY_SERVE:
        label, arch, depth, enc, tdepth, tenc, _, _, lens, T, ticks = run
        for dtype, dd, de in (("bfloat16", depth, enc),
                              ("float32", tdepth, tenc)):
            cfg = tp_family_cfg(arch, dd, de, dtype)
            params = M.init_params(cfg, torch.Generator(
                device=dev).manual_seed(TP_SEED), dev)
            prompts = tp_family_prompts(torch, cfg, lens, dev)
            B = len(lens)
            if len(set(lens)) == 1:
                # each data shard's rows prefilled together, as the
                # batch-sharded prefill routes its own rows' tokens
                dp = math.prod(run[6]) // run[6][-1]
                per = B // dp
                caches, first, pre_routes = [], [], []
                for i in range(dp):
                    batch = {k: torch.cat([p[k] for p in prompts[
                        i * per:(i + 1) * per]]) for k in prompts[0]}
                    with RouteRecorder(torch) as rec:
                        lg, c = SS.make_prefill(cfg)(params, batch)
                    pre_routes.append(rec.calls)
                    caches.append(SS.make_cache_rehome(cfg, per, T)(c))
                    first.append(lg[:, -1].float())
                cache = {k: torch.cat([c[k] for c in caches], dim=1)
                         for k in caches[0]}
                first = torch.cat(first)
                del caches
            else:
                cache, first, pre_routes = None, [], []
                for b, p in enumerate(prompts):
                    with RouteRecorder(torch) as rec:
                        lg, c = SS.make_prefill(cfg)(params, p)
                    pre_routes.append(rec.calls)
                    c = SS.make_cache_rehome(cfg, 1, T)(c)
                    if cache is None:
                        cache = {k: v.new_zeros((v.shape[0], B)
                                                + tuple(v.shape[2:]))
                                 for k, v in c.items()}
                    for k, v in c.items():
                        cache[k][:, b] = v[:, 0]
                    first.append(lg[0, -1].float())
                first = torch.stack(first)
            step = SS.make_decode_step(cfg)
            pos = torch.tensor(lens, device=dev)
            tok = first.argmax(-1)
            toks, logits, ms, routes = [tok.cpu()], [], [], []
            for i in range(ticks):
                sync(torch, dev)
                t0 = time.perf_counter()
                with RouteRecorder(torch) as rec:
                    lg, cache = step(params, tok[:, None], cache, pos + i)
                sync(torch, dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                routes.append(rec.calls)
                tok = lg.float().argmax(-1)
                toks.append(tok.cpu())
                logits.append(lg.float().cpu())
            torch.save({"first": first.cpu(), "tokens": toks,
                        "logits": logits, "routes": routes,
                        "prefill_routes": pre_routes},
                       os.path.join(scratch, f"tp_serve_{label}_{dtype}.pt"))
            out[f"{label}_{dtype}"] = {"tick_ms": ms}
            del params, cache, step
            reset_peak(torch, dev)
    return out


def tp_family_paths(cfg, mesh, seq_sharded: bool, cross_sharded: bool
                    ) -> dict:
    """The decode paths one tick of `cfg` takes over `mesh`, by kind (the
    layers' or the shared block's calls)."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.models.hybrid import _segments
    m = mesh.model
    heads = cfg.num_kv_heads % m == 0
    kind = ("heads" if heads else "sharded_short" if seq_sharded
            else "replicated")
    if cfg.family == ArchFamily.SSM:
        return {}
    if cfg.family == ArchFamily.HYBRID:
        calls = sum(s[2] for s in _segments(cfg))
        return {"shared_" + ("heads" if heads else "sharded" if seq_sharded
                             else "replicated"): calls}
    out = {kind: cfg.num_layers}
    if cfg.family == ArchFamily.AUDIO:
        cross = ("cross_heads" if heads else "cross_sharded"
                 if cross_sharded else "cross_replicated")
        out[cross] = cfg.num_layers
    return out


def tp_family_serve_rank(torch, rank, meshes, dev, scratch, out,
                         runs=None) -> None:
    """19f on this rank: every run of `runs` (TP_FAMILY_SERVE; 19h's
    TP8_SERVE), bf16 and its float32
    twin, the parameters drawn as the main process drew them and cut to
    the rank's blocks, the prompts prefilled (one at a time, or equal ones
    through make_prefill_sharded) and re-homed, then the reference's
    greedy tokens fed tick by tick; each tick's logits held to the
    single-device step's, its model-group bytes to ``tp_tick_bytes``, its
    decode paths to the layout's, the MoE's routing choices to the
    single-device step's (each difference at a near tie); no kernel
    launches (CUDA events on rank 0 time the ticks)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as SS
    ops.reset_launch_counts()
    for run in runs or TP_FAMILY_SERVE:
        label, arch, depth, enc, tdepth, tenc, shape, axes, lens, T, \
            ticks = run
        mesh = meshes[(shape, axes)]
        for dtype, dd, de in (("bfloat16", depth, enc),
                              ("float32", tdepth, tenc)):
            cfg = tp_family_cfg(arch, dd, de, dtype)
            want = torch.load(os.path.join(
                scratch, f"tp_serve_{label}_{dtype}.pt"))
            specs = SS.serve_param_shardings(cfg, mesh, fsdp=False)
            params = M.init_params(
                cfg, torch.Generator(device=dev).manual_seed(TP_SEED), dev,
                shard=lambda k, t: shd.shard_leaf(
                    t, specs[k], mesh.coords, mesh.axis_sizes).clone())
            reset_peak(torch, dev)
            prompts = tp_family_prompts(torch, cfg, lens, dev)
            B = len(lens)
            sync(torch, dev)
            t0 = time.perf_counter()
            tie = TP_ROUTE_TIE if dtype == "bfloat16" else TP_ROUTE_TIE_F32
            flips = 0
            if len(set(lens)) == 1:
                per = B // mesh.size
                r = mesh.replica_index()
                batch = {k: torch.cat([p[k] for p in prompts])
                         for k in prompts[0]}
                with RouteRecorder(torch) as rec:
                    lg, cache = SS.make_prefill_sharded(
                        cfg, mesh, fsdp=False, global_batch=B)(params,
                                                               batch)
                # a row's logits are left out where a routing flip (at a
                # near tie) or a drop that followed one touched the token
                # they are of (`own`), and from there on where one reached
                # the cache of a later layer (`carried`)
                own = torch.zeros(per, dtype=torch.bool)
                carried = torch.zeros(per, dtype=torch.bool)
                if rec.calls:
                    n, own, carried = route_flips(
                        torch, f"tp serve {label} {dtype} prefill",
                        rec.calls, want["prefill_routes"][r], tie, lens[0],
                        cfg.num_layers)
                    flips += n
                cache = SS.make_cache_rehome(cfg, B, T, mesh=mesh)(
                    cache, lens[0], TP_FRAMES)
                first = SS.gather_vocab(lg[:, -1], mesh,
                                        cfg.vocab_size).float()
                first_want = want["first"][r * per:(r + 1) * per]
                rows = slice(r * per, (r + 1) * per)
            else:
                cache, first = None, []
                own = torch.zeros(B, dtype=torch.bool)
                carried = torch.zeros(B, dtype=torch.bool)
                for b, p in enumerate(prompts):
                    with RouteRecorder(torch) as rec:
                        lg, c = SS.make_prefill(cfg, mesh=mesh)(params, p)
                    if rec.calls:
                        n, own[b:b + 1], carried[b:b + 1] = route_flips(
                            torch, f"tp serve {label} {dtype} prefill {b}",
                            rec.calls, want["prefill_routes"][b], tie,
                            lens[b], cfg.num_layers)
                        flips += n
                    c = SS.make_cache_rehome(cfg, 1, T, mesh=mesh)(
                        c, lens[b], TP_FRAMES)
                    if cache is None:
                        cache = {k: v.new_zeros((v.shape[0], B)
                                                + tuple(v.shape[2:]))
                                 for k, v in c.items()}
                    for k, v in c.items():
                        cache[k][:, b] = v[:, 0]
                    first.append(SS.gather_vocab(lg[0, -1], mesh,
                                                 cfg.vocab_size).float())
                first = torch.stack(first)
                first_want = want["first"]
                rows = slice(0, B)
            sync(torch, dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            bound = TP_SERVE_SHARE_SSD if cfg.ssm.enabled else 0.0
            compared = {"compared": 0, "excluded": 0}
            keep = tp_kept_rows(f"{label} {dtype} prefill", own | carried,
                                compared).to(dev)
            errs = [tp_logit_check(torch, f"{label} {dtype} prefill",
                                   first[keep], first_want.to(dev)[keep],
                                   dtype, "bfloat16", bound)]
            step = SS.make_decode_step(cfg, mesh=mesh, max_len=T)
            glob = SS._global_shapes(cfg, B, T)
            lspec = {k: SS.cache_leaf_spec(k, v, mesh.axis_sizes)
                     for k, v in glob.items()}
            n_rows = B // shd.spec_block(next(iter(lspec.values())),
                                         mesh.coords, mesh.axis_sizes)[1][1]
            attn = next((lspec[k] for k in ("k", "attn_k") if k in lspec),
                        None)
            seq_sharded = bool(attn and attn[2])
            cross_sharded = bool("xk" in lspec and lspec["xk"][2])
            expect = tp_tick_bytes(cfg, mesh, n_rows, seq_sharded,
                                   cross_sharded)
            pos = torch.tensor(lens, device=dev)
            L.reset_decode_paths()
            tick_ms = []
            for i in range(ticks):
                tok = want["tokens"][i].to(dev)
                mesh.reset_stats()
                with RouteRecorder(torch) as rec:
                    with tick_timer(torch, dev) as timed:
                        lg, cache = step(params, tok[:, None], cache,
                                         pos + i)
                tick_ms.append(timed["ms"])
                if mesh.model_stats.bytes != expect:
                    raise AssertionError(
                        f"tp serve {label} {dtype} tick {i}: the model group "
                        f"took {mesh.model_stats.bytes} bytes, the layout's "
                        f"count is {expect}")
                own = torch.zeros_like(carried)
                carry = torch.zeros_like(carried)
                if rec.calls:
                    twin = [(e[rows], m[rows], d[rows])
                            for e, m, d in want["routes"][i]]
                    n, own, carry = route_flips(
                        torch, f"tp serve {label} {dtype} tick {i}",
                        rec.calls, twin, tie, 1, cfg.num_layers, carried)
                    flips += n
                keep = tp_kept_rows(f"{label} {dtype} tick {i}",
                                    own | carried, compared).to(dev)
                carried |= carry
                errs.append(tp_logit_check(
                    torch, f"{label} {dtype} tick {i}",
                    lg.float()[rows][keep],
                    want["logits"][i].to(dev)[rows][keep], dtype,
                    "bfloat16", bound))
            paths = dict(L.reset_decode_paths())
            wpaths = {k: v * ticks for k, v in tp_family_paths(
                cfg, mesh, seq_sharded, cross_sharded).items()}
            if paths != wpaths:
                raise AssertionError(f"tp serve {label} {dtype}: decode "
                                     f"paths {paths}, expected {wpaths}")
            if rank == 0:
                log({"phase": "tp_rank0_progress", "run": f"{label}_{dtype}",
                     "prefill_ms": prefill_ms, "tick_ms": tick_ms,
                     "errs": errs, "routing_flips": flips,
                     "logit_rows": compared})
            out[f"{label}_{dtype}"] = {
                "logit_rows": compared,
                "prefill_ms": prefill_ms, "tick_ms": tick_ms,
                "tick_tp_bytes": expect, "paths": paths,
                "routing_flips": flips,
                "max_err_share" if dtype == "bfloat16" else "max_abs_err":
                    max(errs),
                "peak_bytes": peak_bytes(torch, dev)}
            del params, cache, step, want
            reset_peak(torch, dev)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"19f launched kernels: {launched}")


def fsdp_serve_pair(torch, cfg, mesh, dev, batch: dict, T: int,
                    ticks: int, frames: int, seed: int, what: str) -> dict:
    """One model served on this rank of `mesh` over the FSDP serving layout
    and over the plain one: the parameters drawn from `seed` and cut to
    the rank's blocks of both layouts as they are drawn, `batch` prefilled
    over each (make_prefill_sharded, fsdp on and off) and re-homed into a
    cache of `T` rows (`frames` encoder frames), then `ticks` greedy ticks
    (the plain run's tokens fed to both): the prefill's logits and cache
    block and each tick's logits and cache block bit-equal, each tick's
    bytes on the vote axes and the model group ``tp_fsdp_tick_bytes``'s
    for its layout. 19f's FSDP runs on the card and the CPU harness's
    ``check_decode_fsdp`` both run it. Returns by layout ("plain",
    "fsdp") the prefill's and each tick's ms and each tick's bytes by
    axis, with the gathered leaves, the cache's form and the peak."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.train import serve_step as SS
    specs = {f: SS.serve_param_shardings(cfg, mesh, fsdp=f)
             for f in (False, True)}
    gathered = len(shd.fused_dims(specs[True]))
    if not gathered:
        raise AssertionError(f"{what}: the FSDP layout shards no leaf")
    fsdp_params = {}

    def cut(k, t):
        fsdp_params[k] = shd.shard_leaf(t, specs[True][k], mesh.coords,
                                        mesh.axis_sizes).clone()
        return shd.shard_leaf(t, specs[False][k], mesh.coords,
                              mesh.axis_sizes).clone()
    params = {False: M.init_params(cfg, torch.Generator(
        device=dev).manual_seed(seed), dev, shard=cut), True: fsdp_params}
    reset_peak(torch, dev)
    B, S = batch["tokens"].shape
    glob = SS._global_shapes(cfg, B, T)
    lspec = {k: SS.cache_leaf_spec(k, v, mesh.axis_sizes)
             for k, v in glob.items()}
    attn = next((lspec[k] for k in ("k", "attn_k") if k in lspec), None)
    seq_sharded = bool(attn and attn[2])
    cross_sharded = bool("xk" in lspec and lspec["xk"][2])
    entry = SS.batch_entry(B, mesh.axis_sizes)
    caches, steps, expect, ms, wires = {}, {}, {}, {}, {}
    first = None
    for f in (False, True):
        mesh.reset_stats()
        with tick_timer(torch, dev) as timed:
            lg, cache = SS.make_prefill_sharded(
                cfg, mesh, fsdp=f, global_batch=B)(params[f], batch)
        ms[f] = {"prefill": timed["ms"], "prefill_vote_bytes":
                 mesh.stats.bytes, "ticks": []}
        if first is None:
            first, cache0 = lg, cache
        else:
            tp_bit_equal(torch, f"{what} prefill logits", lg, first)
            for k, v in cache0.items():
                tp_bit_equal(torch, f"{what} prefill cache {k}", cache[k], v)
        caches[f] = SS.make_cache_rehome(cfg, B, T, mesh=mesh)(
            cache, S, frames)
        steps[f] = SS.make_decode_step(cfg, mesh=mesh, max_len=T, fsdp=f)
        expect[f] = tp_fsdp_tick_bytes(cfg, mesh, B, seq_sharded,
                                       cross_sharded, fsdp=f)
        wires[f] = []
    # every row's first token, on every rank
    tok = SS._gather_rows(SS.gather_vocab(
        first[:, -1], mesh, cfg.vocab_size).float().argmax(-1)[:, None],
        mesh, entry)
    del first, cache0, cache, lg
    for i in range(ticks):
        got = {}
        for f in (False, True):
            mesh.reset_stats()
            with tick_timer(torch, dev) as timed:
                got[f], caches[f] = steps[f](params[f], tok, caches[f], S + i)
            ms[f]["ticks"].append(timed["ms"])
            wires[f].append({"vote": mesh.stats.bytes,
                             "model": mesh.model_stats.bytes})
            if wires[f][-1] != expect[f]:
                raise AssertionError(
                    f"{what} fsdp={f} tick {i}: the axes took {wires[f][-1]} "
                    f"bytes, the layout's count is {expect[f]}")
        tp_bit_equal(torch, f"{what} tick {i} logits", got[True], got[False])
        for k, v in caches[False].items():
            tp_bit_equal(torch, f"{what} tick {i} cache {k}",
                         caches[True][k], v)
        tok = got[False].float().argmax(-1)[:, None]
    name = {False: "plain", True: "fsdp"}
    out = {"ms": {name[f]: v for f, v in ms.items()},
           "wire": {name[f]: v for f, v in wires.items()},
           "tick_bytes": {name[f]: v for f, v in expect.items()},
           "gathered_leaves": gathered, "batch": B,
           "seq_sharded": seq_sharded, "cross_sharded": cross_sharded,
           "peak_bytes": peak_bytes(torch, dev)}
    del params, fsdp_params, caches, steps
    reset_peak(torch, dev)
    return out


def tp_fsdp_serve_rank(torch, rank, meshes, dev, out) -> None:
    """19f's FSDP runs on this rank: each TP_FSDP_SERVE model through
    :func:`fsdp_serve_pair` on TP_FSDP_ROWS seeded prompts of
    TP_FSDP_PROMPT rows, a cache of TP_FSDP_CACHE rows and TP_FSDP_TICKS
    greedy ticks; no kernel launches."""
    from repro_torch.kernels import ops
    mesh = meshes[TP_FSDP_MESH]
    ops.reset_launch_counts()
    for label, arch, depth, enc in TP_FSDP_SERVE:
        cfg = tp_family_cfg(arch, depth, enc, "bfloat16")
        prompts = tp_family_prompts(torch, cfg,
                                    (TP_FSDP_PROMPT,) * TP_FSDP_ROWS, dev)
        got = fsdp_serve_pair(
            torch, cfg, mesh, dev,
            {k: torch.cat([p[k] for p in prompts]) for k in prompts[0]},
            TP_FSDP_CACHE, TP_FSDP_TICKS, TP_FRAMES, TP_SEED,
            f"tp serve {label}")
        del prompts
        if rank == 0:
            log({"phase": "tp_rank0_progress", "run": label,
                 "prefill_ms": [got["ms"][f]["prefill"]
                                for f in ("plain", "fsdp")],
                 "tick_ms_fsdp": got["ms"]["fsdp"]["ticks"]})
        out[label] = {k: got[k] for k in ("ms", "tick_bytes",
                                          "gathered_leaves", "peak_bytes")}
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"19f's FSDP runs launched kernels: {launched}")


def tp_bit_equal(torch, what: str, got, want) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got, want):
        raise AssertionError(f"{what}: the FSDP layout's differs from the "
                             "plain layout's")


@contextlib.contextmanager
def tick_timer(torch, dev):
    """{"ms": ...} of the block: CUDA events on the card (the stream's own
    time), the host clock elsewhere."""
    out = {}
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield out
        end.record()
        torch.cuda.synchronize()
        out["ms"] = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        yield out
        out["ms"] = (time.perf_counter() - t0) * 1e3


def tp_kept_rows(what: str, skip, counts: dict):
    """The rows a logit comparison keeps (those not in the bool `skip`),
    counted into `counts`; raises when it would keep none."""
    keep = ~skip
    n = int(keep.sum())
    if n == 0:
        raise AssertionError(f"tp serve {what}: routing flips leave no row "
                             "to compare")
    counts["compared"] += n
    counts["excluded"] += int(skip.sum())
    return keep


def tp_logit_check(torch, what: str, got, want, dtype: str, kv: str,
                   share: float = 0.0) -> float:
    """A bf16 run's logits within TP_SERVE_SHARE[kv] of max(|logit|, 1) of
    the single-device step's (or of `share`, when given; returns the
    share); a float32 twin's within rtol / atol TP_TWIN_TOL with greedy
    tokens equal (returns the largest difference)."""
    diff = (got - want).abs()
    if dtype == "float32" and kv != "int8":
        if not bool((diff <= TP_TWIN_TOL + TP_TWIN_TOL * want.abs()).all()):
            raise AssertionError(f"tp serve {what}: float32 logits differ "
                                 f"by {float(diff.max())}")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"tp serve {what}: greedy tokens differ")
        return float(diff.max())
    bound = share or TP_SERVE_SHARE[kv]
    share = float(diff.max()) / max(float(want.abs().max()), 1.0)
    if share > bound:
        raise AssertionError(f"tp serve {what}: logits differ by {share} "
                             f"of max(|logit|, 1), over {bound}")
    return share


def tp_rank_body(rank: int, init: str, scratch: str, dev_type: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.mesh import ProcessMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=MESH_RANKS)
    try:
        shapes = [TP_TRAIN_MESH] + [
            (s, a) for _, s, a, _, _, _, _ in TP_SERVE_RUNS] + [
            (r[6], r[7]) for r in TP_FAMILY_SERVE]
        meshes = {}
        for shape, axes in shapes:   # every rank, one order
            if (shape, axes) not in meshes:
                meshes[(shape, axes)] = ProcessMesh(shape, axes)
        out = {"train": {}, "serve": {}, "fsdp_serve": {}, "seconds": {}}
        mesh = meshes[TP_TRAIN_MESH]
        cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            out["seconds"][name] = now - clock[0]
            clock[0] = now
        for codec in TP_CODECS:
            tp_train_rank(
                torch, rank, mesh, cfg, train_config(codec), dev, codec,
                lambda art, p, c=codec: mesh_launches(
                    "allgather_1bit" if c == "sign1bit" else c, rank,
                    len(p), None),
                lambda art, p, c=codec: tp_vote_bytes(p, c), scratch,
                out["train"], True)
        lap("19a")
        evil = mesh.replica_index() < 1
        for label, mode, p, opt in TP_ADV_RUNS:
            acfg = tp_adv_config(mode, p, opt)
            tp_train_rank(
                torch, rank, mesh, cfg, acfg, dev, label,
                lambda art, p: tp_adv_launches(art, p, evil),
                lambda art, p, t=acfg: (tp_plan_vote_bytes(art, t)
                                        if art.plan is not None
                                        else tp_vote_bytes(p, "sign1bit")),
                scratch, out["train"], True)
        lap("19g")
        qcfg, qtcfg = tp_moe_config()
        tp_train_rank(
            torch, rank, mesh, qcfg, qtcfg, dev, "moe_fsdp",
            lambda art, p: tp_moe_launches(qcfg, qtcfg, art, p, evil),
            lambda art, p: tp_fsdp_vote_bytes(qcfg, art,
                                              qtcfg.microbatches), scratch,
            out["train"], False)
        lap("19d")
        for arch, *_ in TP_FAMILIES:
            fcfg, ftcfg = tp_family_config(arch)
            tp_train_rank(
                torch, rank, mesh, fcfg, ftcfg, dev, arch,
                lambda art, p: mesh_launches("psum_int8", rank, len(p),
                                             None),
                lambda art, p: tp_psum_vote_bytes(p), scratch,
                out["train"], True)
        lap("19e")
        for arch, *_ in TP_FAMILIES:
            tp_f32_train_rank(torch, rank, mesh, f"f32_{arch}",
                              *tp_family_config(arch, "float32"), dev,
                              scratch, out["train"])
        lap("19e_float32")
        tp_serve_rank(torch, rank, meshes, dev, scratch, out["serve"])
        lap("19c")
        tp_family_serve_rank(torch, rank, meshes, dev, scratch,
                             out["serve"])
        lap("19f")
        tp_fsdp_serve_rank(torch, rank, meshes, dev, out["fsdp_serve"])
        lap("19f_fsdp")
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def tp_check_votes(torch, dev, results: dict, runs=None,
                   model: int = TP_TRAIN_MESH[0][1]) -> dict:
    """The step-0 votes of every leaf of `runs` ((label, codec); default
    19a's, 19e's and 19g's), data index 0's `model` model ranks joined,
    against the twin's: equal on at least TP_VOTE_AGREE of each leaf's
    coordinates, every difference a flippable coordinate. Returns the
    agreement and flips by run (psum_int8's votes are repacked 2 bits a
    coordinate, as ternary2bit's)."""
    from repro_torch.distributed import sharding as shd
    out = {}
    sizes = {"model": model}
    if runs is None:
        runs = [(c, c) for c in TP_CODECS] + [(arch, "ternary2bit")
                                              for arch, *_ in TP_FAMILIES]
        # 19g: the plan applies 2-bit votes (apply_ternary_vote)
        runs += [(label, "ternary2bit" if opt else "sign1bit")
                 for label, _, _, opt in TP_ADV_RUNS]
    every = []
    for label, codec in runs:
        twin = torch.load(os.path.join(results["scratch"],
                                       f"tp_twin_{label}.pt"))
        specs = {k: tuple(v) for k, v in
                 results[0]["train"][label]["specs"].items()}
        parts = [torch.load(os.path.join(
            results["scratch"], f"tp_votes_{label}_rank{r}.pt"))
            for r in range(sizes["model"])]
        worst, flips, by_leaf = 1.0, 0, {}
        failures = []
        for k, (words, n) in twin["votes"].items():
            # this leaf's vote on each model rank of data index 0, joined
            blocks = [{k: unpack_votes(torch, part[k][0].to(dev),
                                       math.prod(part[k][1]), codec).view(
                                           part[k][1])} for part in parts]
            got = shd.join_shards(blocks, {k: specs[k]}, sizes=sizes)[
                k].reshape(-1)
            want = unpack_votes(torch, words.to(dev), n, codec)
            near = unpack_votes(torch, twin["flippable"][k].to(dev), n,
                                "sign1bit") > 0
            bad = got != want
            agree = 1.0 - float(bad.sum()) / n
            worst = min(worst, agree)
            lost = int((bad & ~near).sum())
            by_leaf[k] = (agree, n, int(bad.sum()), lost)
            if agree < (TP_VOTE_AGREE_BK if k.endswith("attn_bk")
                        else TP_VOTE_AGREE_FAMILY.get(label,
                                                      TP_VOTE_AGREE)):
                failures.append(f"tp {label} {k}: the step-0 vote agrees "
                                f"with the twin's on {agree} of {n}")
            if lost > TP_LARGE_FLIP_SHARE.get(label, 0.0) * n:
                failures.append(
                    f"tp {label} {k}: {lost} coordinates differ where no "
                    f"voter's |m'| was under {TP_FLIP_FRACTION} of the "
                    "leaf's largest")
            flips += int(bad.sum())
            del blocks, got, want, near, bad
        out[label] = {"worst_leaf_agreement": worst, "flips": flips,
                      "lowest_leaves": sorted(by_leaf.items(),
                                              key=lambda kv: kv[1][0])[:8]}
        if failures:
            log({"phase": "tp_votes_failed", "run": label, **out[label]})
            every += failures
    # every run's reading first, then the failures
    if every:
        raise AssertionError("; ".join(every))
    return out


def tp_check_train(torch, dev, results: dict, labels, twin: dict,
                   ranks: int, launches: dict, errs: dict) -> None:
    """Phase 19's train runs `labels` on `ranks` ranks after they exit:
    every rank held its step-0 launches (on the card), step 0 twice
    bit-equal, the replicated leaves bit-equal over the ranks, step 0's
    loss within TP_LOSS_RTOL of the twin's; a ``tp_train`` line each. The
    launches join `launches`, the plain checks' errors `errs`."""
    for label in labels:
        runs = [results[r]["train"][label] for r in range(ranks)]
        for r, run in enumerate(runs):
            if dev.type == "cuda" and not run["held"]:
                raise AssertionError(f"tp {label}: rank {r} held no "
                                     "launch")
            for k, v in run["max_abs_err"].items():
                errs[k] = max(errs.get(k, 0.0), v)
        for r, run in enumerate(runs):
            a, b = run["checksums"][0], run["checksums"][1]
            if a["state"] != b["state"]:
                raise AssertionError(f"tp {label} rank {r}: step 0 run "
                                     "twice differs")
            for row in run["rows"]:
                for k, v in row["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        # the replicated leaves bit-equal over every rank (the model
        # ranks of a voter, and the voters, who applied one vote)
        for i in range(len(runs[0]["checksums"])):
            sums = {run["checksums"][i]["replicated"] for run in runs}
            if len(sums) != 1:
                raise AssertionError(f"tp {label} run {i}: replicated "
                                     "leaves differ over the ranks")
        want_loss = twin[label]["loss"]
        losses = [run["metrics"][0]["loss"] for run in runs]
        for loss in losses:
            if abs(loss - want_loss) > TP_LOSS_RTOL * abs(want_loss):
                raise AssertionError(f"tp {label}: step 0's loss {loss} "
                                     f"against the twin's {want_loss}")
        rows = [run["rows"] for run in runs]
        if label in TP_CODECS:   # phase 20b's
            TP_ROWS[label] = [r[0] for r in rows]
        log({"phase": "tp_train", "run": label,
             "mesh": runs[0]["mesh"][0], "axes": runs[0]["mesh"][1],
             "losses": [m["loss"] for m in runs[0]["metrics"]],
             "twin_step0_loss": want_loss,
             "step_ms": [max(r[i]["ms"] for r in rows)
                         for i in range(len(rows[0]))],
             "vote_collective_ms": [max(r[i]["vote_ms"] for r in rows)
                                    for i in range(len(rows[0]))],
             "tp_collective_ms": [max(r[i]["tp_ms"] for r in rows)
                                  for i in range(len(rows[0]))],
             "other_host_ms": [max(r[i]["other_ms"] for r in rows)
                               for i in range(len(rows[0]))],
             "vote_bytes_per_rank": runs[0]["expected_vote_bytes"],
             "tp_bytes_per_rank": runs[0]["expected_tp_bytes"],
             "peak_bytes_by_rank": [run["peak_bytes"] for run in runs],
             "routing_flips_by_rank": [run["routing_flips"]
                                       for run in runs],
             "step0_twice_bit_equal": True,
             "held_vs_plain_by_rank": [run["held"] for run in runs],
             "adversary_draws_by_rank": [run["draws"] for run in runs],
             "twin_draws": twin[label].get("draws")})


def tp_log_f32(results: dict, name: str, ranks: int,
               launches: dict) -> None:
    """A ``tp_train_float32`` line for the float32 twin run ``f32_{name}``
    of `ranks` ranks (:func:`tp_f32_train_rank`); its launches join
    `launches`."""
    runs = [results[r]["train"][f"f32_{name}"] for r in range(ranks)]
    for run in runs:
        for k, v in run["row"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log({"phase": "tp_train_float32", "run": name,
         "twin_step0_loss": runs[0]["twin_loss"],
         "losses_by_rank": [run["loss"] for run in runs],
         "loss_share_by_rank": [run["loss_share"] for run in runs],
         "worst_leaf_by_rank": [run["worst_leaf"] for run in runs],
         "leaves": runs[0]["leaves"], "bound": TP_TWIN_TOL,
         "routing_flips_by_rank": [run["routing_flips"] for run in runs],
         "route_tie": TP_ROUTE_TIE_F32,
         "step_ms_by_rank": [run["row"]["ms"] for run in runs],
         "peak_bytes_by_rank": [run["peak_bytes"] for run in runs]})


def tp_log_serve(results: dict, serve: list, serve_ref: dict,
                 ranks: int) -> None:
    """A ``tp_serve`` line for each (label, kv, prompt rows, cache rows) of
    `serve`, bf16 and float32, from `ranks` ranks' results beside the
    single-device ticks (`serve_ref`)."""
    for label, kv, lens, T in serve:
        for dtype in ("bfloat16", "float32"):
            got = [results[r]["serve"][f"{label}_{dtype}"]
                   for r in range(ranks)]
            log({"phase": "tp_serve", "run": label, "dtype": dtype,
                 "kv": kv, "cache_rows": T, "prompt_rows": list(lens),
                 "tick_ms_rank0": got[0]["tick_ms"],
                 "single_device_tick_ms": serve_ref[
                     f"{label}_{dtype}"]["tick_ms"],
                 "prefill_ms_rank0": got[0]["prefill_ms"],
                 "tp_bytes_per_tick_rank0": got[0]["tick_tp_bytes"],
                 "paths_rank0": got[0]["paths"],
                 "routing_flips_by_rank": [g.get("routing_flips")
                                           for g in got],
                 "worst": max(g.get("max_err_share",
                                    g.get("max_abs_err", 0.0))
                              for g in got),
                 "bound": (TP_TWIN_TOL if dtype == "float32"
                           and kv != "int8" else TP_SERVE_SHARE_SSD
                           if label.startswith(("mamba2", "zamba2"))
                           else TP_SERVE_SHARE[kv]),
                 "peak_bytes_by_rank": [g["peak_bytes"] for g in got]})


def run_phase19(torch, dev, errs, target=None) -> dict:
    """Phase 19: the stacked twins and the single-device serving references
    in this process, then one world of MESH_RANKS processes on the card
    (gloo through pinned host memory: loopback on one card, not a link)
    runs 19a, 19d, 19e, 19c and 19f; every exact check raises on the rank
    or here. Returns the ranks' summed kernel launches."""
    import tempfile
    t_start = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="tp19_")
    gc.collect()
    reset_peak(torch, dev)
    try:
        from repro_torch.configs.base import get_config
        from repro_torch.kernels import ops, ref
        adv_map = check_adversary_map(
            torch, ops, ref, dev, errs, dataclasses.replace(
                get_config("glm4-9b"), num_layers=2))
        twin = tp_train_twin(torch, dev, scratch)
        log({"phase": "tp_twin_done", "seconds": time.perf_counter() - t_start,
             **twin})
        serve_ref = tp_serve_reference(torch, dev, scratch)
        serve_ref.update(tp_family_serve_reference(torch, dev, scratch))
        log({"phase": "tp_serve_reference_done",
             "seconds": time.perf_counter() - t_start})
        gc.collect()
        reset_peak(torch, dev)
        t_ranks = time.perf_counter()
        results = spawn_ranks(target or tp_rank, (scratch, dev.type),
                              TP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t_ranks
        results["scratch"] = scratch
        launches = {}
        labels = TP_CODECS + ("moe_fsdp",) + tuple(a for a, *_ in
                                                    TP_FAMILIES) + tuple(
            a for a, *_ in TP_ADV_RUNS)
        tp_check_train(torch, dev, results, labels, twin, MESH_RANKS,
                       launches, errs)
        for arch, *_ in TP_FAMILIES:
            tp_log_f32(results, arch, MESH_RANKS, launches)
        votes = tp_check_votes(torch, dev, results)
        log({"phase": "tp_votes", **votes,
             "bounds": {"agree": TP_VOTE_AGREE,
                        "agree_attn_bk": TP_VOTE_AGREE_BK,
                        "agree_families": TP_VOTE_AGREE_FAMILY,
                        "large_flip_share": TP_LARGE_FLIP_SHARE,
                        "flip_fraction": TP_FLIP_FRACTION}})
        serve = [(r[0], r[3], r[4], r[5]) for r in TP_SERVE_RUNS] + [
            (r[0], "bfloat16", r[8], r[9]) for r in TP_FAMILY_SERVE]
        tp_log_serve(results, serve, serve_ref, MESH_RANKS)
        for label, arch, depth, enc in TP_FSDP_SERVE:
            got = [results[r]["fsdp_serve"][label]
                   for r in range(MESH_RANKS)]
            log({"phase": "tp_serve_fsdp", "run": label, "arch": arch,
                 "depth": depth, "encoder_depth": enc,
                 "mesh": list(TP_FSDP_MESH[0]), "axes": list(TP_FSDP_MESH[1]),
                 "prompt_rows": [TP_FSDP_PROMPT] * TP_FSDP_ROWS,
                 "cache_rows": TP_FSDP_CACHE, "ticks": TP_FSDP_TICKS,
                 "bit_equal_to_plain": True,
                 "gathered_leaves": got[0]["gathered_leaves"],
                 "tick_ms_rank0": got[0]["ms"],
                 "tick_bytes_by_rank": [g["tick_bytes"] for g in got],
                 "peak_bytes_by_rank": [g["peak_bytes"] for g in got]})
        for label in tuple(a for a, *_ in TP_ADV_RUNS) + ("moe_fsdp",):
            drawn = [results[r]["train"][label]["draws"]
                     for r in range(MESH_RANKS)]
            if not all(drawn[:TP_TRAIN_MESH[0][1]]):
                raise AssertionError(f"tp {label}: an adversarial rank's "
                                     f"draws were not held: {drawn}")
        # 19g-3: every model rank of the adversarial voter drew its block
        # of each fused leaf, held to the twin's block draws
        fused = [results[r]["train"]["moe_fsdp"]["draws"]["fused_calls"]
                 for r in range(TP_TRAIN_MESH[0][1])]
        log({"phase": "tp_fused_draws", "run": "moe_fsdp",
             "fused_draws_by_rank": fused,
             "draws_by_rank": [results[r]["train"]["moe_fsdp"]["draws"]
                               for r in range(MESH_RANKS)],
             "adversary_launches_by_rank": [
                 {k: sum(row["launches"].get(k, 0) for row in
                         results[r]["train"]["moe_fsdp"]["rows"])
                  for k in ("adversary", "adversary_map")}
                 for r in range(MESH_RANKS)]})
        log({"phase": "tp_adversary_map", **adv_map})
        log({"phase": "tp_done", "ranks": MESH_RANKS, "backend": "gloo",
             "note": "gloo loopback through pinned host memory, 4 ranks on "
                     "one card; not a link",
             "ranks_seconds": ranks_s,
             "subphase_seconds_by_rank": [results[r]["seconds"]
                                          for r in range(MESH_RANKS)],
             "seconds": time.perf_counter() - t_start,
             "smi": smi_line() if dev.type == "cuda" else None})
        return launches
    finally:
        import shutil
        shutil.rmtree(scratch, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 19h: M2 at qwen2-moe's published width, a world of 8 ranks
# ---------------------------------------------------------------------------

#: 19h's coordinates that differ away from zero are held to 1 % of a leaf
#: (TP_LARGE_FLIP_SHARE), stated before its first card run: a routing flip
#: at a near tie moves a token's gradient from one expert to another, and
#: a flip in layer 0 moves the row's residual after it, so the
#: coordinates those reach differ far from zero (a CPU rehearsal at
#: reduced width with 60 experts, bf16: up to 0.5 % of a leaf, 1.6 % of a
#: 256-coordinate bias). Its agreement bound (TP_VOTE_AGREE_FAMILY) was
#: set after a reading, so it is not a prediction: the card read 95.2-97.9
#: % a leaf against the 99 % stated before the run, 99.8 % of the
#: differing coordinates where |m'| is under TP_FLIP_FRACTION of the
#: leaf's largest and the rest at most 0.15 % of a leaf. At M = 1 each
#: vote is one voter's sign, with no majority to absorb the bf16 rounding
#: of an 8-way tensor-parallel step and its 590 routing flips; its loss
#: agreed with the twin's within 1.7e-6
#: 19h: qwen2-moe-a2.7b at every published width (d_model 2048, 16 heads,
#: 16 kv heads, 60 routed experts of d_ff 1408, 4 shared of 5632, vocab
#: 151,936), depth 24 -> 2, on a second world of TP8_RANKS processes
#: sharing the card over gloo, (data 1, model 8): 60 % 8 != 0 and
#: 1408 % 8 == 0, so the experts take the M2 form (176 d_ff columns of
#: every expert a rank), the vocabulary 18,992 rows a rank. Its Mode A
#: preset (``default_train_config``: bf16 momentum on psum_int8, batch 8,
#: seq 512, remat full; microbatches 8 -> TP8_MICRO, as 19e cuts its
#: presets', for the script's time) against the single-device M = 1 step,
#: with 19d's and 19e's checks, and its float32 twin (one microbatch) as
#: 19e holds its families': m' and the loss within TP_TWIN_TOL, and every
#: routing difference in both layers at a float32 near tie
#: (TP_ROUTE_TIE_F32), none excused after an earlier flip in its row (the
#: bf16 run excuses those, so its layer 1 is held there); then TP8_SERVE,
#: held as 19f holds its
#: qwen2-moe run: bf16 at 1 layer, as 19f's, beside a float32 twin (E / k
#: capacity) at TP8_LAYERS. At 2 layers in bf16 a near-tie routing flip in
#: layer 0 moves the row's residual, which layer 1 caches, so the row's
#: logits leave the comparison; in the card's first 19h run every row of
#: every prompt had one ("routing flips leave no row to compare"), while
#: float32's ties (TP_ROUTE_TIE_F32) are rare enough to compare 2 layers
TP8_RANKS = 8
TP8_MESH = ((8,), ("model",))
TP8_ARCH, TP8_LAYERS, TP8_MICRO = "qwen2-moe-a2.7b", 2, 4
TP8_LABEL = "m2_model8"
TP8_SERVE = (
    ("qwen2_moe_model8", TP8_ARCH, 1, 0, TP8_LAYERS, 0, (8,), ("model",),
     (64, 128, 192, 256), 512, 8),
)
TP8_TIMEOUT_S = 600


def tp8_config(dtype: str = ""):
    """19h's cut of the qwen2-moe-a2.7b Mode A preset; with `dtype`
    "float32", its float32 twin (parameters and momentum, one microbatch,
    as 19e's)."""
    from repro_torch.configs.base import (MomentumMode, ShapeCell,
                                          VoteStrategy, get_config)
    from repro_torch.configs.presets import default_train_config
    cfg = dataclasses.replace(get_config(TP8_ARCH), num_layers=TP8_LAYERS,
                              **({"dtype": dtype} if dtype else {}))
    preset = default_train_config(TP8_ARCH, ShapeCell(
        "train_smoke", SEQ, GLOBAL_BATCH, "train"))
    opt = preset.optimizer
    if (opt.kind, opt.momentum_mode, opt.vote_strategy, opt.momentum_dtype,
            preset.fsdp) != ("signum_vote", MomentumMode.PER_WORKER,
                             VoteStrategy.PSUM_INT8, "bfloat16", False):
        raise AssertionError(f"not the {TP8_ARCH} Mode A preset: {preset}")
    if dtype:
        return cfg, dataclasses.replace(
            preset, microbatches=1, optimizer=dataclasses.replace(
                opt, momentum_dtype=dtype))
    return cfg, dataclasses.replace(preset, microbatches=TP8_MICRO)


def tp8_rank(rank: int, init: str, scratch: str, dev_type: str,
             queue) -> None:
    """One rank of 19h's world (a spawned process); puts ``(rank,
    results)`` on `queue`, or ``(rank, {"error": ...})``."""
    import traceback
    try:
        queue.put((rank, tp8_rank_body(rank, init, scratch, dev_type)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def tp8_rank_body(rank: int, init: str, scratch: str, dev_type: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.models import moe
    from repro_torch.train import serve_step as SS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=TP8_RANKS)
    try:
        meshes = {}
        for shape, axes in [TP8_MESH] + [(r[6], r[7]) for r in TP8_SERVE]:
            if (shape, axes) not in meshes:
                meshes[(shape, axes)] = ProcessMesh(shape, axes)
        mesh = meshes[TP8_MESH]
        cfg, tcfg = tp8_config()
        form = moe.moe_form(cfg.moe, mesh.model)
        if form != "M2":
            raise AssertionError(f"19h rank {rank}: the experts take the "
                                 f"{form} form over model {mesh.model}")
        specs = SS.serve_param_shardings(cfg, mesh, fsdp=False)
        shapes = cfg.param_shapes()
        blocks = {k: [n // c for n, (_, c) in zip(shapes[k], shd.spec_block(
            specs[k], mesh.coords, mesh.axis_sizes))]
            for k in ("layers.experts_w_gate", "embed.table")}
        out = {"train": {}, "serve": {}, "seconds": {}, "moe_form": form,
               "blocks": blocks}
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            out["seconds"][name] = now - clock[0]
            clock[0] = now
        tp_train_rank(
            torch, rank, mesh, cfg, tcfg, dev, TP8_LABEL,
            lambda art, p: mesh_launches("psum_int8", rank, len(p), None),
            lambda art, p: tp_psum_vote_bytes(p, mesh.size), scratch,
            out["train"], True)
        lap("19h_train")
        tp_f32_train_rank(torch, rank, mesh, f"f32_{TP8_LABEL}",
                          *tp8_config("float32"), dev, scratch, out["train"])
        lap("19h_float32")
        tp_family_serve_rank(torch, rank, meshes, dev, scratch,
                             out["serve"], TP8_SERVE)
        lap("19h_serve")
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def run_phase19h(torch, dev, errs, target=None) -> dict:
    """Phase 19h, after phase 19's world has exited: the single-device
    M = 1 twin and serving reference in this process, then a world of
    TP8_RANKS processes on the card (gloo) trains and serves qwen2-moe in
    the M2 form; every exact check raises on a rank or here. Returns the
    ranks' summed kernel launches."""
    import tempfile
    t_start = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="tp19h_")
    gc.collect()
    reset_peak(torch, dev)
    try:
        cfg, tcfg = tp8_config()
        twin = tp_train_twin(torch, dev, scratch, [
            (TP8_LABEL, cfg, tcfg, True),
            (f"f32_{TP8_LABEL}",) + tp8_config("float32") + (False,)],
            voters=1)
        serve_ref = tp_family_serve_reference(torch, dev, scratch, TP8_SERVE)
        log({"phase": "tp8_references_done",
             "seconds": time.perf_counter() - t_start, **twin})
        gc.collect()
        reset_peak(torch, dev)
        t_ranks = time.perf_counter()
        results = spawn_ranks(target or tp8_rank, (scratch, dev.type),
                              TP8_TIMEOUT_S, ranks=TP8_RANKS)
        ranks_s = time.perf_counter() - t_ranks
        results["scratch"] = scratch
        forms = [results[r]["moe_form"] for r in range(TP8_RANKS)]
        if forms != ["M2"] * TP8_RANKS:
            raise AssertionError(f"19h: the experts' forms {forms}")
        launches = {}
        tp_check_train(torch, dev, results, (TP8_LABEL,), twin, TP8_RANKS,
                       launches, errs)
        tp_log_f32(results, TP8_LABEL, TP8_RANKS, launches)
        votes = tp_check_votes(torch, dev, results,
                               [(TP8_LABEL, "ternary2bit")],
                               model=TP8_MESH[0][-1])
        log({"phase": "tp8_votes", **votes,
             "bounds": {"agree": TP_VOTE_AGREE,
                        "flip_fraction": TP_FLIP_FRACTION}})
        tp_log_serve(results, [(r[0], "bfloat16", r[8], r[9])
                               for r in TP8_SERVE], serve_ref, TP8_RANKS)
        train = [results[r]["train"][TP8_LABEL] for r in range(TP8_RANKS)]
        log({"phase": "tp8_done", "ranks": TP8_RANKS, "backend": "gloo",
             "mesh": list(TP8_MESH[0]), "axes": list(TP8_MESH[1]),
             "moe_form_by_rank": forms,
             "blocks_rank0": results[0]["blocks"],
             "train_peak_bytes_by_rank": [t["peak_bytes"] for t in train],
             "serve_peak_bytes_by_rank": [
                 [v["peak_bytes"] for v in results[r]["serve"].values()]
                 for r in range(TP8_RANKS)],
             "step_s": [max(t["rows"][i]["ms"] for t in train) / 1e3
                        for i in range(len(train[0]["rows"]))],
             "note": "gloo loopback through pinned host memory, 8 ranks on "
                     "one card; not a link",
             "ranks_seconds": ranks_s,
             "subphase_seconds_by_rank": [results[r]["seconds"]
                                          for r in range(TP8_RANKS)],
             "seconds": time.perf_counter() - t_start,
             "smi": smi_line() if dev.type == "cuda" else None})
        return launches
    finally:
        import shutil
        shutil.rmtree(scratch, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 20: the dry run against the card
# ---------------------------------------------------------------------------

#: 20a's bound, stated before the first card run: the card's peak above
#: its allocation before the step within this share of the dry run's
#: peak_bytes_per_chip of the dry run's peak above its arguments
DRY_PEAK_SHARE = 0.02
#: 20b: each rank's step-0 row of 19a, by codec (filled by run_phase19)
TP_ROWS: dict = {}
#: 20c's production cell
DRY_CELL = ("glm4-9b", "train_4k")
#: seconds 20c's dry run may take (it runs beside phases 2-19, on the host)
DRY_CELL_TIMEOUT_S = 600


def start_dry_cell() -> tuple:
    """20c's dry run as a process of its own on the host (no card), started
    beside the card's phases so its trace costs the script no time:
    ``python -m repro_torch.launch.dryrun`` on DRY_CELL, its record to a
    file of a fresh temporary directory. Returns (process, path)."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tempfile.mkdtemp(prefix="dryrun_"), "cell.jsonl")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(here, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRY_CELL[0], "--shape", DRY_CELL[1], "--out", path], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def finish_dry_cell(pending: tuple) -> dict:
    """The record of :func:`start_dry_cell`'s run, once it has ended; its
    output is printed on failure."""
    import shutil
    proc, path = pending
    try:
        out, _ = proc.communicate(timeout=DRY_CELL_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    try:
        with open(path) as f:
            rec = json.loads(f.readline())
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    if proc.returncode or rec["status"] != "ok":
        raise AssertionError(f"dry run 20c: exit {proc.returncode}, "
                             f"{rec}\n{out[-4000:]}")
    return rec


def dry_card_step(torch, cfg, tcfg, dev) -> dict:
    """One real step of `cfg` under `tcfg` (M_MAIN stacked voters) on the
    card from fresh state: its launches, ``FlopCounterMode``'s FLOPs and
    its peak above the allocation before it."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ops
    from repro_torch.train import train_step as TS
    art = TS.make_train_step(cfg, tcfg, M_MAIN, device=dev)
    params, state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (tcfg.global_batch, tcfg.seq_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev,
        dtype=torch.int32)}
    gc.collect()
    sync(torch, dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with FlopCounterMode(display=False) as flops:
        art.step_fn(params, state, batch, 0)
    sync(torch, dev)
    out = {"launches": ops.launch_counts(),
           "flops": flops.get_total_flops(),
           "peak_above_before": torch.cuda.max_memory_allocated(dev) - before,
           "argument_bytes": sum(t.numel() * t.element_size() for t in
                                 list(params.values()) + [batch["tokens"]]
                                 + [v for d in state.values()
                                    if isinstance(d, dict)
                                    for v in d.values()])}
    del params, state, art
    gc.collect()
    return out


def run_phase20(torch, cfg, dev, pending: tuple = None) -> None:
    """Phase 20 (see the module doc); every check raises. `pending` is
    20c's run from :func:`start_dry_cell` (started here when not given)."""
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.launch import dryrun as D
    from repro_torch.train import train_step as TS
    t_start = time.perf_counter()
    # 20a
    tcfg = train_config("sign1bit")
    meta = D.train_record(cfg, tcfg, n_voters=M_MAIN)
    card = dry_card_step(torch, cfg, tcfg, dev)
    if card["launches"] != meta["launches"]:
        raise AssertionError(f"dry run 20a: launches {meta['launches']} on "
                             f"meta, {card['launches']} on the card")
    if card["flops"] != meta["flops_per_chip"]:
        raise AssertionError(f"dry run 20a: {meta['flops_per_chip']} FLOPs "
                             f"on meta, {card['flops']} on the card")
    mem = meta["memory"]
    above = mem["peak_bytes_per_chip"] - mem["argument_bytes"]
    gap = card["peak_above_before"] - above
    if abs(gap) > DRY_PEAK_SHARE * mem["peak_bytes_per_chip"]:
        raise AssertionError(
            f"dry run 20a: the card's peak above its arguments "
            f"{card['peak_above_before']} against the dry run's {above} "
            f"(bound {DRY_PEAK_SHARE} of {mem['peak_bytes_per_chip']})")
    log({"phase": "dryrun_vs_card", "cell": "phase 3 (glm4-9b, 2 layers, "
         "M = 4, sign1bit, allgather_1bit)",
         "launches": {k: v for k, v in card["launches"].items() if v},
         "flops": card["flops"], "meta_memory": mem,
         "card_peak_above_before": card["peak_above_before"],
         "card_argument_bytes": card["argument_bytes"],
         "meta_peak_above_arguments": above, "peak_gap": gap,
         "peak_gap_share": gap / mem["peak_bytes_per_chip"],
         "bound_share": DRY_PEAK_SHARE,
         "meta_hbm_bytes": meta["hbm_bytes_per_chip"],
         "meta_trace_s": meta["trace_s"],
         "seconds": time.perf_counter() - t_start})
    # 20b
    t0 = time.perf_counter()
    shape, axes = TP_TRAIN_MESH
    for codec in TP_CODECS:
        tcfg = train_config(codec)
        rows = TP_ROWS[codec]
        for rank in range(MESH_RANKS):
            with D.fake_world(MESH_RANKS, rank):
                mesh = ProcessMesh(shape, axes)
                rec = D.train_record(cfg, tcfg, mesh=mesh)
                art = TS.make_train_step(cfg, tcfg, device="meta", mesh=mesh)
                params, _ = TS.abstract_state(cfg, tcfg, art, mesh)
                want = {"vote": tp_vote_bytes(params, codec),
                        "model": tp_bytes(cfg, tcfg, mesh, TP_FRAMES)}
            got = {"vote": rows[rank]["vote_bytes"],
                   "model": rows[rank]["tp_bytes"]}
            if not rec["wire_bytes"] == got == want:
                raise AssertionError(
                    f"dry run 20b {codec} rank {rank}: bytes by axis "
                    f"{rec['wire_bytes']} on meta, {got} on the card, "
                    f"{want} by the layout")
            launched = {k: v for k, v in rec["launches"].items() if v}
            if launched != rows[rank]["launches"]:
                raise AssertionError(
                    f"dry run 20b {codec} rank {rank}: launches {launched} "
                    f"on meta, {rows[rank]['launches']} on the card")
        log({"phase": "dryrun_vs_19a", "codec": codec,
             "bytes_by_axis_rank0": rec["wire_bytes"],
             "launches_rank0": rows[0]["launches"],
             "collectives_rank3": rec["collectives"]})
    log({"phase": "dryrun_19a_done", "seconds": time.perf_counter() - t0})
    # 20c
    t0 = time.perf_counter()
    rec = finish_dry_cell(pending or start_dry_cell())
    total = torch.cuda.get_device_properties(dev).total_memory
    if not D.H100_MEMORY_BYTES <= total <= 1.1 * D.H100_MEMORY_BYTES:
        raise AssertionError(f"dryrun.H100_MEMORY_BYTES "
                             f"{D.H100_MEMORY_BYTES} against the card's "
                             f"total_memory {total}")
    log({"phase": "dryrun_production_cell", "record": rec,
         "waited_s": time.perf_counter() - t0})
    log({"phase": "dryrun_card", "total_memory": total,
         "H100_MEMORY_BYTES": D.H100_MEMORY_BYTES, "smi": smi_line(),
         "seconds": time.perf_counter() - t_start})


# ---------------------------------------------------------------------------
# phase 7: timing at the unembedding shape
# ---------------------------------------------------------------------------


def median_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops_done: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tally_at_more_voters(torch, kernel, gen, dev, n, per_word, ops_per_vote
                         ) -> list:
    """A tally's ms at TALLY_TIMED voters, each beside its bound: M + 1
    words moved per output word, `ops_per_vote` operations per voter and
    element."""
    rows = []
    for m, cut in TALLY_TIMED:
        n_m = n // cut
        w = -(-n_m // per_word)
        packed = torch.randint(-2 ** 31, 2 ** 31, (m, w), generator=gen,
                               device=dev, dtype=torch.int32)
        out = torch.empty(w, dtype=torch.int32, device=dev)
        b, by = bound((m + 1) * w * 4, ops_per_vote * m * n_m)
        rows.append({"voters": m, "n": n_m, "ms": median_ms(
            torch, lambda: kernel(packed, out=out), reps=25),
            "bound_ms": b, "bound_by": by})
        del packed, out
    return rows


def time_kernels(torch, ops, ref, sc, dev, launches, errs) -> list:
    gen = torch.Generator(device=dev).manual_seed(99)
    n, w = N_UNEMBED, sc.words_for(N_UNEMBED)
    rows = []

    def row(name, replaces, ms, plain, bytes_moved, ops_done, source,
            **extra):
        b, by = bound(bytes_moved, ops_done)
        # library_ms: no single PyTorch call computes any of these functions.
        # excess_ms, launches x (ms - bound_ms): the order in which the
        # kernels' time above their bounds costs the main path most
        rows.append({"name": name, "route": "cuda", "source": SOURCE + source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "max_diff": errs[name],
                     "ms": ms, "plain_ms": plain, "bound_ms": b,
                     "bound_by": by, "library_ms": None,
                     "excess_ms": launches[name] * (ms - b),
                     **{"shape": {"n": n, "voters": M_MAIN}, **extra}})

    def pack_stack(x):
        """ms of bitpack of the (rows, n) stack x, and of the same stack
        read one element past each row's start (off a 16-byte boundary:
        the element path)."""
        off = x.as_strided((x.shape[0], n - 1), (n, 1), 1)
        return (median_ms(torch, lambda: ops.bitpack(x), reps=25),
                median_ms(torch, lambda: ops.bitpack(off), reps=25))

    g = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    m = torch.randn(n, generator=gen, device=dev)
    words = torch.empty(w, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, m, BETA, m_out=m, packed_out=words), reps=25)
    plain = median_ms(torch, lambda: ref.momentum_sign_pack(
        g.view(1, -1), m.view(1, -1), BETA), reps=5, warmup=1)
    # the ternary2bit / ef_sign encode: m' written, no words
    nopack_ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, m, BETA, m_out=m, pack=False), reps=25)
    nopack_b, _ = bound(n * (2 + 4 + 4), 3 * n)
    # the stream yardstick: m += c * g moves the same bytes as m' without
    # the words (another function, so not library_ms)
    stream_ms = median_ms(torch, lambda: m.add_(g, alpha=1 - BETA), reps=25)
    # g bf16 read, m read and written, one bit out; 2 mul + 1 add
    row("momentum_sign_pack", "src/repro/kernels/signum_update.py:46", ms,
        plain, n * (2 + 4 + 4) + w * 4, 3 * n, "signum_update.cu",
        nopack_ms=nopack_ms, nopack_bound_ms=nopack_b, stream_ms=stream_ms,
        stream_bound_ms=nopack_b)
    del m
    # bf16 momentum (the preset path's instantiation): g bf16 read, m bf16
    # read and written, one bit out; 2 mul + 1 add and 3 roundings to bf16
    mb = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, mb, BETA, m_out=mb, packed_out=words), reps=25)
    plain = median_ms(torch, lambda: ref.momentum_sign_pack(
        g.view(1, -1), mb.view(1, -1), BETA), reps=5, warmup=1)
    # the count wire's encode: m' written, no words
    nopack_ms = median_ms(torch, lambda: ops.momentum_sign_pack(
        g, mb, BETA, m_out=mb, pack=False), reps=25)
    nopack_b, _ = bound(n * (2 + 2 + 2), 6 * n)
    stream_ms = median_ms(torch, lambda: mb.add_(g, alpha=1 - BETA),
                          reps=25)
    row("momentum_sign_pack_bf16m", "src/repro/kernels/signum_update.py:46",
        ms, plain, n * (2 + 2 + 2) + w * 4, 6 * n, "signum_update.cu",
        nopack_ms=nopack_ms, nopack_bound_ms=nopack_b, stream_ms=stream_ms,
        stream_bound_ms=nopack_b,
        shape={"n": n, "g": "bfloat16", "m": "bfloat16"})
    del g, mb, words

    packed = torch.randint(-2 ** 31, 2 ** 31, (M_MAIN, w), generator=gen,
                           device=dev, dtype=torch.int32)
    out = torch.empty(w, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.majority(packed, out=out), reps=25)
    plain = median_ms(torch, lambda: ref.majority(packed), reps=5, warmup=1)
    del packed
    # M words read and one written per output word; an add per voter and bit
    row("majority", "src/repro/kernels/vote.py:37", ms, plain,
        (M_MAIN + 1) * w * 4, M_MAIN * n, "vote.cu",
        more_voters=tally_at_more_voters(torch, ops.majority, gen, dev, n,
                                         sc.PACK, 1))
    del out

    p = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    votes = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen, device=dev,
                          dtype=torch.int32)
    ms = median_ms(torch, lambda: ops.apply_vote(p, votes, LR, 0.0, out=p),
                   reps=25)
    plain = median_ms(torch, lambda: ref.apply_vote(
        p.view(1, -1), votes[None], LR, 0.0), reps=5, warmup=1)
    # the stream yardstick: a bf16 copy of n elements moves 4 of apply's
    # 4.125 B per element (another function, so not library_ms)
    dst = torch.empty_like(p)
    stream_ms = median_ms(torch, lambda: dst.copy_(p), reps=25)
    stream_b, _ = bound(n * (2 + 2), 0)
    del p, dst
    p32 = torch.randn(n, generator=gen, device=dev)
    f32_ms = median_ms(torch, lambda: ops.apply_vote(p32, votes, LR, 0.0,
                                                     out=p32), reps=25)
    f32_b, _ = bound(n * (4 + 4) + w * 4, 4 * n)
    del p32
    # p bf16 read and written, one vote bit; mul, add, mul, sub
    row("apply_vote", "src/repro/kernels/signum_update.py:79", ms, plain,
        n * (2 + 2) + w * 4, 4 * n, "signum_update.cu", stream_ms=stream_ms,
        stream_bound_ms=stream_b, f32_ms=f32_ms, f32_bound_ms=f32_b)
    del votes

    x = torch.randn((M_MAIN, n), generator=gen, device=dev)
    ms = median_ms(torch, lambda: ops.fused_majority(x), reps=25)
    plain = median_ms(torch, lambda: ref.fused_majority(x), reps=5,
                      warmup=1)
    # the f32 stack read once, one word per 32 columns; a comparison and
    # an add per element
    row("fused_majority", "src/repro/kernels/fused_vote.py:52", ms, plain,
        M_MAIN * n * 4 + w * 4, 2 * M_MAIN * n, "fused_vote.cu")
    ms, elem_ms = pack_stack(x)
    plain = median_ms(torch, lambda: ref.bitpack(x), reps=5, warmup=1)
    del x
    # bf16 and int8 stacks: each read once, each row's words written; a
    # comparison per element
    bf16 = signed_payload(torch, gen, (M_MAIN, n), torch.bfloat16, dev)
    bf16_ms, bf16_elem_ms = pack_stack(bf16)
    bf16_plain = median_ms(torch, lambda: ref.bitpack(bf16), reps=5,
                           warmup=1)
    del bf16
    signs = signed_payload(torch, gen, (M_MAIN, n), torch.int8, dev)
    i8_ms, i8_elem_ms = pack_stack(signs)
    i8_plain = median_ms(torch, lambda: ref.bitpack(signs), reps=5,
                         warmup=1)
    del signs
    # the f32 stack read once, each row's words written; a comparison per
    # element. elem_ms: the element path (the first design), on the stack
    # read one element off each row's 16-byte boundary.
    row("bitpack", "src/repro/kernels/bitpack.py:47", ms, plain,
        M_MAIN * n * 4 + M_MAIN * w * 4, M_MAIN * n, "bitpack.cu",
        elem_ms=elem_ms, bf16_stack_ms=bf16_ms,
        bf16_stack_bound_ms=bound(M_MAIN * (n * 2 + w * 4), 0)[0],
        bf16_elem_ms=bf16_elem_ms)
    # the int8 signs of every staged 1-bit vote and plan bucket
    row("bitpack_i8", "src/repro/kernels/bitpack.py:47", i8_ms, i8_plain,
        M_MAIN * (n + w * 4), M_MAIN * n, "bitpack.cu", elem_ms=i8_elem_ms,
        shape={"n": n, "rows": M_MAIN, "dtype": "int8"})
    # the bf16 gradient rows of signSGD and Mode B on the 1-bit wire
    row("bitpack_bf16", "src/repro/kernels/bitpack.py:47", bf16_ms,
        bf16_plain, M_MAIN * (n * 2 + w * 4), M_MAIN * n, "bitpack.cu",
        elem_ms=bf16_elem_ms,
        shape={"n": n, "rows": M_MAIN, "dtype": "bfloat16"})
    words = torch.randint(-2 ** 31, 2 ** 31, (w,), generator=gen,
                          device=dev, dtype=torch.int32)
    ms = median_ms(torch, lambda: ops.bitunpack(words, n, torch.int8),
                   reps=25)
    plain = median_ms(torch, lambda: ref.bitunpack(words[None], torch.int8),
                      reps=5, warmup=1)
    # one bit read and one int8 sign written per element; a select each
    row("bitunpack", "src/repro/kernels/bitpack.py:64", ms, plain,
        w * 4 + n, n, "bitpack.cu")
    del words

    w2 = sc.ternary_words_for(n)
    signs = ternary_payload(torch, gen, (M_MAIN, n), torch.int8, dev)
    stack_ms = median_ms(torch, lambda: ops.ternary_pack(signs), reps=25)
    stack_b, _ = bound(M_MAIN * (n + w2 * 4), M_MAIN * n)
    del signs
    m_row = torch.randn((1, n), generator=gen, device=dev)
    out = torch.empty((1, w2), dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.ternary_pack(m_row, out=out), reps=25)
    plain = median_ms(torch, lambda: ref.ternary_pack(m_row), reps=5,
                      warmup=1)
    # the preset's count wire packs a bf16 m' row: 2 B read, 2 bits written
    b_row = m_row.to(torch.bfloat16)
    bf16_row_ms = median_ms(torch, lambda: ops.ternary_pack(b_row, out=out),
                            reps=25)
    bf16_row_b, _ = bound(n * 2 + w2 * 4, 2 * n)
    # the trainer's use: one f32 momentum row read, 2 bits written; a
    # compare and a shift per element. The vote API's (4, n) int8 wire
    # signs ride along as stack_*, the preset's bf16 row as bf16_row_*.
    row("ternary_pack", "src/repro/kernels/ternary_pack.py:61", ms, plain,
        n * 4 + w2 * 4, 2 * n, "ternary_pack.cu", stack_ms=stack_ms,
        stack_bound_ms=stack_b, stack_shape={"rows": M_MAIN,
                                             "dtype": "int8"},
        bf16_row_ms=bf16_row_ms, bf16_row_bound_ms=bf16_row_b)
    del m_row, b_row, out
    packed = torch.randint(-2 ** 31, 2 ** 31, (M_MAIN, w2), generator=gen,
                           device=dev, dtype=torch.int32)
    out = torch.empty(w2, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.ternary_majority(packed, out=out),
                   reps=25)
    plain = median_ms(torch, lambda: ref.ternary_majority(packed), reps=5,
                      warmup=1)
    del packed
    # M words read and one written per 16 fields; two compares and an add
    # per voter and field
    row("ternary_majority", "src/repro/kernels/ternary_pack.py:79", ms,
        plain, (M_MAIN + 1) * w2 * 4, 3 * M_MAIN * n, "vote.cu",
        more_voters=tally_at_more_voters(torch, ops.ternary_majority, gen,
                                         dev, n, sc.PACK2, 3))
    # the hierarchical wire's tally (ties +1): the same words and counting,
    # another finisher
    packed = torch.randint(-2 ** 31, 2 ** 31, (M_MAIN, w2), generator=gen,
                           device=dev, dtype=torch.int32)
    plus = torch.empty(w2, dtype=torch.int32, device=dev)
    ms = median_ms(torch, lambda: ops.ternary_majority(
        packed, ties="plus_one", out=plus), reps=25)
    plain = median_ms(torch, lambda: ref.ternary_majority(packed, "plus_one"),
                      reps=5, warmup=1)
    del packed, plus
    row("ternary_majority_plus_one", "src/repro/kernels/ternary_pack.py:79",
        ms, plain, (M_MAIN + 1) * w2 * 4, 3 * M_MAIN * n, "vote.cu",
        ties="plus_one: hierarchical's sign_binary of the count "
        "(src/repro/core/vote_engine.py:255-315, jnp)")
    ms = median_ms(torch, lambda: ops.ternary_unpack(out, n), reps=25)
    plain = median_ms(torch, lambda: ref.ternary_unpack(out[None]), reps=5,
                      warmup=1)
    # Mode B's vote unpacked to bf16 (2 B a symbol), and ef_sign's on the
    # 2-bit wires to float32 (4 B)
    bf16_ms = median_ms(torch, lambda: ops.ternary_unpack(
        out, n, torch.bfloat16), reps=25)
    f32_ms = median_ms(torch, lambda: ops.ternary_unpack(
        out, n, torch.float32), reps=25)
    # 2 bits read and one int8 symbol written per element; a select each
    row("ternary_unpack", "src/repro/kernels/ops.py:155 (jnp, no "
        "pallas_call)", ms, plain, w2 * 4 + n, n, "ternary_pack.cu",
        bf16_ms=bf16_ms, bf16_bound_ms=bound(w2 * 4 + 2 * n, n)[0],
        f32_ms=f32_ms, f32_bound_ms=bound(w2 * 4 + 4 * n, n)[0])
    p = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    ms = median_ms(torch, lambda: ops.apply_ternary_vote(p, out, LR, 0.0,
                                                         out=p), reps=25)
    plain = median_ms(torch, lambda: ref.apply_ternary_vote(
        p.view(1, -1), out[None], LR, 0.0), reps=5, warmup=1)
    dst = torch.empty_like(p)
    stream_ms = median_ms(torch, lambda: dst.copy_(p), reps=25)
    del p, dst
    # p bf16 read and written, 2 vote bits; mul, add, mul, sub
    row("apply_ternary_vote", "src/repro/core/signum.py:232 (jnp apply, no "
        "pallas_call)", ms, plain, n * (2 + 2) + w2 * 4, 4 * n,
        "signum_update.cu", stream_ms=stream_ms, stream_bound_ms=stream_b)
    return rows


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def device_line(torch) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def run_alone(name: str, phase) -> int:
    """One phase of this script alone on a card (the probes of
    ``scripts/``): build the kernels, call ``phase(torch, dev, build,
    err)`` (`err` each kernel's largest difference from its plain version
    so far) and log the dict it returns, then the card's name and power limit
    and ``{"ok": true, ...}``. Returns 2 without a card; a failed check
    raises."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import build, ops
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library("vote")
    log({"build_s": time.perf_counter() - t0})
    err = {k: 0.0 for k in ops.launch_counts()}
    log({**phase(torch, dev, build, err), "max_abs_err": err})
    log(smi_line())
    log({"ok": True, "seconds": time.perf_counter() - t0,
         "device": device_line(torch)})
    return 0


def main() -> int:
    # Phases 3-5 free and re-allocate tens of GB in blocks of many sizes;
    # expandable segments keep the cached memory from fragmenting so the
    # plain versions' large temporaries still find room (set before the
    # first CUDA allocation, which reads it).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(smi_line())
    dev = repro_torch.resolve_device()
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    build.library("vote")
    log({"phase": "build", "seconds": time.perf_counter() - t0})
    # 20c's dry run traces on the host beside phases 2-19
    pending = start_dry_cell()
    try:
        return run_phases(torch, dev, pending, t_start)
    finally:
        import shutil
        if pending[0].poll() is None:
            pending[0].kill()
            pending[0].wait()
        shutil.rmtree(os.path.dirname(pending[1]), ignore_errors=True)


def run_phases(torch, dev, pending: tuple, t_start: float) -> int:
    """Phases 2-20 and the last lines (see :func:`main`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import sign_compress as sc
    from repro_torch.kernels import build, ops, ref
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if any(k in line for k in ("Function properties", "registers",
                                       "spill")):
                log(f"ptxas {name}: {line.strip()}")

    check_ftz(build)
    errs = check_kernels(torch, ops, ref, sc, dev)
    # every published width of glm4-9b; depth cut to 2 layers
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    launches, sign1bit_losses = run_train_path(
        torch, cfg, dev, "sign1bit", "unembed.table", vote_after=True)
    ef_sign_packs = 0
    for codec, leaf in CHECK_LEAF.items():
        for k, v in run_train_path(torch, cfg, dev, codec, leaf)[0].items():
            launches[k] += v
            if codec == "ef_sign" and k == "bitpack":
                ef_sign_packs = v
    # every momentum_sign_pack launch of the preset path is the bf16-m one
    preset = run_preset_path(torch, cfg, dev)
    launches["momentum_sign_pack_bf16m"] = preset.pop("momentum_sign_pack")
    for k, v in preset.items():
        launches[k] += v
    for k, v in run_plan_train_path(torch, cfg, dev,
                                    sign1bit_losses).items():
        launches[k] += v
    # phases 9 and 10 count their bitpack launches, of bf16 gradient rows,
    # as "bitpack_bf16"
    launches["bitpack_bf16"] = 0
    for path in (run_signsgd_path(torch, cfg, dev),
                 run_mode_b_path(torch, dev)):
        for k, v in path.items():
            launches[k] += v
    run_dense_path(torch, cfg, dev)
    for k, v in run_failure_path(torch, cfg, dev, ops, ref, errs).items():
        launches[k] += v
    for k, v in run_population_path(torch, dev, errs).items():
        launches[k] += v
    for k, v in run_mesh_path(torch, cfg, dev, errs).items():
        launches[k] += v
    for k, v in run_fsdp_path(torch, dev, errs).items():
        launches[k] += v
    # the zoo's and the families' profiled steps (about 40 s and 60 s) run
    # in their probes (scripts/zoo_probe.py, scripts/family_probe.py), not
    # here, for the script's time
    for k, v in run_zoo_path(torch, dev, errs, profiled=None).items():
        launches[k] += v
    for k, v in run_phase17(torch, cfg, dev, errs, profiled=None).items():
        launches[k] += v
    for k, v in run_phase18(torch, dev, errs).items():
        launches[k] += v
    for k, v in run_phase19(torch, dev, errs).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in run_phase19h(torch, dev, errs).items():
        launches[k] = launches.get(k, 0) + v
    # the dry run launches no kernel; 20a's step on the card is phase 3's
    run_phase20(torch, cfg, dev, pending)
    # ef_sign's encode packs its float32 t; every other bitpack of the main
    # path packs int8 signs (staged votes, plan buckets, weighted_vote's vote)
    launches["bitpack_i8"] = launches["bitpack"] - ef_sign_packs
    launches["bitpack"] = ef_sign_packs
    errs["bitpack_i8"] = errs["bitpack"]   # the max over every dtype's check
    errs["bitpack_bf16"] = errs["bitpack"]
    rows = time_kernels(torch, ops, ref, sc, dev, launches, errs)
    rows.append(time_adversary(torch, ops, ref, dev, launches, errs))
    never = [r["name"] for r in rows if not r["launches"]]
    if never:
        raise AssertionError(f"the main path never launched {never}")
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    # again beside the results: a long run's output may be read from its end
    log(smi_line())
    log({"kernels": rows})
    log({"ok": True, "device": device_line(torch)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
