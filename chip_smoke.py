#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, torch and CUDA versions; TF32 off
   for float32 matmuls and convolutions;
2. build every CUDA kernel of the port from ``paddle_tpu_torch/kernels/
   csrc`` (one nvcc per source, in parallel), printing each source's
   build seconds and ptxas's registers, shared memory and spills of
   every kernel;
3. kernel phase: each kernel against its plain PyTorch version on the
   card, at the stated tolerances (paged attention on float pools and
   on int8 and fp8 pages with f32 scales, W 1, 4 and 5, and the rows
   that exercise its split page walk at W 1, 3 and 5: readable only in
   the first split, cursor 0, parked on the sentinel, nothing readable,
   only the last query readable, a window across two splits; the qkv
   forward also at S=320, a half-full last query block); then its time
   at the main path's shape (paged attention: the serving decode shape
   with bf16, int8 and fp8 pages at W=1 and W=5, printed with the split
   count it chose and the blocks it launched, its library call SDPA
   over the gathered view, dequantized beforehand; the beam's tail read
   `paged_tail_segment` at phase 10's beam shape, N=32 H=16 D=128 Pg=8,
   on bf16 and int8 pages at gen columns 127 and 40; the pair-major qkv
   flash kernels (their backward is the general kernels', held at p=0
   against the general backward on the unpacked views: dk and dv bit
   for bit, dq within 8 bf16 ulps): GPT's training shape B8 S1024 H16
   D128 bf16 causal, beside the general forward on the unpacked q/k/v,
   and the fused BERT's B8 S512 H16 D64 full, checked there too; the
   general flash kernels, held at nine shapes (bf16 edges among them:
   Sq != Sk causal, lengths that are not multiples of 128, a full
   bias, a fully masked row), timed at BERT-large's B8 S512 H16 D64 bf16
   with a key-padding mask and dropout 0.1 and at S=2048 causal, forward
   and backward; the which-major qkv3 flash
   kernels: BERT-large's unmasked B8 S512 H16 D64 bf16 with dropout 0.1,
   also held against the pair-major ones on the repacked projection (bit
   for bit but bf16 dq, whose atomics sum in a varying order: 8 ulps);
   the fused LayerNorm kernels through their entry
   ``_ln_maybe_fused``, then at BERT-large's [4096, 1024] bf16 rows with
   a residual) beside the plain version's, a PyTorch library call
   computing the same function (timed here only; the port never calls
   it) and the least time the card could take (its bound). Beside them
   the head dims and page sizes that are not 64/128 and multiples of 8:
   the paged kernel at D 80 and 16, ps 16, 4 and 3 (float and int8
   pages, W 1 and 5, the split-walk rows at D=80, the tail read at
   D=80), timed at gpt3-2.7b's decode shape (N=8 H=32 D=80, bf16 and
   int8 pages at W=1, int8 at W=5); B2 at D 192, 256 and 384 (f32 and
   bf16, the edge shapes above) and B4 at D=256 under a random lse
   cotangent, B2 timed at Gemma-2B's attention shape (B4 S1024 H8 D256
   bf16, causal, and key-padded with dropout 0.1) and B4 at B1 S2048
   H8 D256; last, the multi-tensor Adam/AdamW update
   (`kernels.multi_tensor_adam`) against its plain version on
   gpt3-1.3b's parameter list and one step's gradients: AdamW and Adam
   with L2 decay in bf16, bf16 params with f32 moments, f32 params with
   f32 and bf16 moments, a global-norm clip's scale, multi_precision
   masters, and the bf16 and multi_precision forms with mixed per-entry
   rate scales (`ParamAttr`'s ``learning_rate``; every stored element
   within 1 ulp, the share equal bit for bit printed), a found-inf flag (nothing written, the step count
   unchanged), and its time beside the plain version's, one
   ``torch._fused_adamw_`` call over the same lists and the bound;
4. engine phase: gpt3-1.3b at full width and depth, bf16, random
   weights from ``--seed``, served by
   the paged `Engine` (``kv_mode="paged"``, 8 slots, page 16, max_len
   640, buckets 128/512)
   under staggered traffic. Launch counts are zeroed just before the run
   and read just after: paged attention must have launched exactly
   decode_steps x layers times. Every request
   completes, every page returns to the pool, and a teacher-forced
   full-sequence forward with plain attention, of a float32 copy of the
   weights, agrees with each emitted token unless its logit is within
   0.05 of the reference's top one. Then a few full decode steps run
   under torch.profiler: the device's busy share and the top kernels.
   On graphs: every prefill and decode step is one CUDA graph replay
   (one graph per prompt bucket, one for decode), the launch counts
   counted through the replays, the sentinel armed around the traffic
   (decode_traces 1, prefill_traces = buckets used, capture_s printed),
   the profile's kernels/step and host launch calls/step (cudaLaunchKernel
   + cuLaunchKernelEx + cudaGraphLaunch); and a graph-against-eager check
   at 3 full decode steps: one replay and one eager run of the decode
   step on the same staged operands from cloned pools give the same
   float32 logits bit for bit, or the same tokens and logits within 1
   bf16 ulp of each element's own scale (which of the two held is
   printed);
5. training phase: gpt3-1.3b at full width and depth trains through
   `SpmdTrainStep` (b8 x s1024 from ``--seed``, dropout 0, bf16 params
   and AdamW moments, lr 1e-4, wd 0.01), one CUDA graph a batch
   signature. The bf16 model's loss and grads agree with a float32 copy
   of its weights run through the plain attention branch; the first
   call builds the step's graph (its warm-up is that call's step), then
   the launch counts are zeroed and five timed steps replay it under the
   armed sentinel (one build: ``xla_traces`` 1): both flash kernels
   launch exactly steps x layers times and the update once a step,
   every loss is finite and the first lies within 0.5 of ln(vocab). It
   prints tokens/s, step ms p50, MFU, capture_s, the graph pool's bytes
   and the replays' peak memory; then replays against eager steps
   (`run_eager`) from one state and keys over 3 steps: the first loss
   bit for bit, each tensor of params and slots within the larger of
   twice its spread over 5 eager runs and 4 ulps of its dtype at its
   largest magnitude (the key biases' params, whose true gradient is
   zero, left out), the same replays with their second update
   skipped outside that bound (the negative control), the replays' peak
   memory within 10% of the eager step's (the other training phases
   print theirs); then
   two steps under torch.profiler (busy share, kernels and host launch
   calls a step, the update's device time apart);
6. BERT phase: bert-large at full width and depth pretrains through
   `SpmdTrainStep` on padded batches (b8 x s512, per-row lengths in
   [384, 512) as a [B, 1, 1, S] key-padding mask, MLM on 15% of the real
   positions plus NSP, dropout 0.1, bf16 params and moments). On two
   sequences at dropout 0 the bf16 model (attention in the general flash
   kernels) agrees with a float32 copy whose attention is composed; then
   on graphs as phase 5 (dropout on in the graph-against-eager check),
   five timed replays in which both general flash kernels launch
   exactly steps x layers times, the update once a step and no other
   kernel runs, every loss is finite and the first MLM loss lies within
   0.5 of ln(vocab); the MLM parts the loss function hands out (its aux
   values) are kept from each step and must differ. It prints tokens/s,
   step ms p50, peak memory and MFU, then two steps under
   torch.profiler, with the general flash kernels' and the update's
   device time a step;
7. BERT unmasked phase, unfused: the same run on full-length batches
   (every row 512 real tokens, no mask; BASELINE row 4), every layer's
   attention in the qkv-direct branch: the which-major qkv3 kernels
   launch exactly steps x layers times each and no other kernel runs;
8. BERT unmasked phase, fused: the same batches through
   ``BertModel(fuse=True)``: the pair-major qkv kernels on the shuffled
   ``qkv_weight`` launch steps x layers times each, no other kernel;
9. quantized speculative serving: gpt3-1.3b, bf16, phase 4's engine
   and traffic with 1-byte KV pages: (a) int8 pages, all greedy, once
   with spec_k=0 and once with spec_k=4 (verify windows of 5 queries);
   (b) fp8 pages, spec_k=4, the odd requests sampled. The quantized
   kernel launches exactly decode steps x layers times per run and no
   other kernel runs; every request completes and every page returns;
   greedy tokens agree with a float32 teacher-forced forward whose
   attention reads K/V through the same quantization round trip (the
   first token against plain K/V), unless within 0.05 of its top logit;
   the spec_k=4 streams equal the spec_k=0 ones but at such a near-tie.
   Per run: drafted and accepted tokens, TTFT, decode ms/step,
   tokens/s, pool bytes and pages, and a profile of full steps. On
   graphs, as phase 4 (the verify window's graph at W=5), the sentinel
   armed around each run's traffic;
10. generation phase: gpt3-1.3b, bf16, `generate()` at the JAX
   package's decode benchmark shape (b8 x prompt 1024, dense, random
   ids from ``--seed``): (a) greedy + 128: B1's forward launches exactly
   layers times (the flash prefill) and nothing else; a float32 teacher
   agrees with every token but at a near-tie (within 0.05 of its top
   logit); (b) beam search, K=4,
   paged, + 128, no EOS: the tail read launches exactly (128 - 1) x
   layers times, each a bf16 paged-kernel launch, no other paged
   variant; (c) the same on the gather oracle; (b) against (c) in
   float32 at b2 x 128 + 16: identical, or parting where the two
   candidates' log-probs differ by less than 1e-4; (d) the paged beam on
   int8 tail pages, + 32: (32 - 1) x layers int8 launches, all through
   the tail; (e) greedy on weight-only int8 weights, + 32, against a
   float32 teacher on the dequantized weights, then the paged Engine
   with and without weight_quant on phase 4's traffic. Per arm: prefill
   ms, decode ms per step, tokens/s, launches; a profile of (b) and (c)
   (busy share, launches a step, top kernels); (d)'s pool bytes. On
   graphs: each decode step of (a)-(e) is one replay of its loop's
   captured step, the prefill runs eagerly; each timed reading is the
   median of 3 calls after a warm-up call of the same arguments, which
   must replay the decode step that call built (one build, under the
   armed sentinel); the profiles (and one of (e))
   print kernels/step and host launch calls/step; a graph-against-eager
   check of (a)'s and (b)'s decode steps at 3 generated columns holds as
   phase 4's; (e)'s loop dequantizes the int8 weights once, when it is
   built; the loops left on the model after (e) hold no more than
   generate's byte budget (or the last loop, if larger);
11. sequence-parallel phase, at GPT-1.3B's heads (H16 D128, bf16) on
   one ring chunk of a 4-way split of 8192 tokens (S=2048): (a) B4, the
   flash attention with a differentiable lse (`flash_attention_lse_fwd`
   / `_bwd`), bf16 and float32, causal and full, against its plain
   versions under a random ``do`` and a random lse cotangent; at a zero
   (and a missing) cotangent against B2's backward (dk, dv bit for bit,
   bf16 dq within 8 ulps); its times beside the plain versions, SDPA
   (which takes no lse cotangent) and the bound; (b) the ring's per-rank
   loop for all 4 ranks at S=8192 causal in this one process (the
   transport needs a card a rank): exactly 10 B4 launches each way (4
   diagonal and 6 earlier pairs) and no B2 launch, the output and the
   q/k/v grads held beside B2's over the whole sequence to a float32
   control, and their times beside B2's and SDPA's; (c) a one-rank NCCL
   world: `ring_attention` launches B4 once each way and matches B2,
   `sp_attention` on a one-rank mesh composes;
12. gpt3-2.7b serving phase (32 layers, 32 heads of 80, bf16, random
   weights from ``--seed``): (a) phase 4's Engine and traffic on bf16
   pages, then on int8 pages with spec_k=4: the pool's paged kernel
   launches exactly decode (verify) steps x layers times and nothing
   else runs, every request completes, every page returns, greedy
   tokens agree with a float32 teacher but at a near-tie of the bf16
   model's own measured rounding (at least 0.05); (b) `generate()`
   beam 4, paged, b2 x prompt 128 + 32: the tail read launches (32 - 1)
   x layers times; the gather oracle launches nothing; the two agree in
   float32 at + 16 (identical, or parting at a log-prob gap < 1e-4).
   On graphs, as phases 4 and 10, the sentinel armed around the timed
   traffic and calls;
13. attention at Gemma-2B's widths: 18 `TransformerEncoderLayer`
   (d_model 2048, 8 heads of 256, MLP 16384, GELU, dropout 0.1) train
   through `SpmdTrainStep` (AdamW, bf16 params and moments) on b4 x
   s1024 batches with a key-padding mask (lengths in [768, 1024)): the
   bf16 loss and grads against a float32 copy whose attention composes
   (phase 6's tolerances), then on graphs as phase 5, five timed replays
   in which B2's forward and backward (at D=256: the wgmma forward on
   64-key tiles and the one-pass backward on 64-key blocks) launch
   exactly steps x layers times each, the update once a step and no
   other kernel runs; step ms p50, tokens/s, MFU, peak memory and B2's
   and the update's device time a step from a profile, in which no
   kernel sliced over D may appear;
14. the optimizer plane on graphs, gpt-test: a `LinearWarmup` into a
   `CosineAnnealingDecay` drives a first call and five replays of one
   graph (each staged rate the scheduler's, each update the one an eager
   twin makes with it); `GradScaler` with an inf planted in one grad at
   a replay leaves params, moments and the step count bit for bit,
   halves the scale and reads ``found_inf_skips`` 1;
15. dense slot serving: gpt3-1.3b (bf16, random weights from
   ``--seed``, shared by phases 15-17) served by phase 4's Engine and
   traffic built with no ``kv_mode``, so on the dense slot caches (the
   reference's default): no kernel of the port launches (the slot step
   composes its attention with float32 scores, as the reference does),
   every request completes and every slot returns, greedy tokens agree
   with the float32 teacher but at a near-tie, one decode graph and one
   prefill graph a bucket under the armed sentinel, ``kv_cache_bytes``
   the slot caches' bytes; ms/step, TTFT and tokens/s beside phase 4's
   paged ms/step, a profile of full steps and the graph-against-eager
   check of phase 4;
16. prefix cache: 16 requests behind 2 system prompts of 384 tokens
   (user suffixes of 2-64 tokens, budgets of 8-32, one arrival every 3
   steps;
   the JAX package's ``make_shared_prefix_trace`` shape) through the
   paged Engine with ``prefix_cache=True`` and, on the same traffic,
   without it: ``prefix_tokens_saved`` is 384 for every request after
   the first on its system prompt; the paged kernel launches exactly
   decode steps x layers times, and is held against its plain version
   on the live state where several rows map one prefix page; every page
   and reference returns (the tree's dropped by ``evict_to(0)``);
   greedy tokens agree with the float32 teacher but at a near-tie; TTFT
   p50 of each arm, the hits' median time to their first token in each,
   and the cached pages;
17. chunked prefill and embed: 7 short prompts of 20-250 tokens (+ 64)
   decoding when one 1536-token prompt (+ 2) arrives (the JAX package's
   ``make_mixed_prefill_trace`` shape), max_len 2048, buckets 256/1536,
   with ``chunk_tokens=256`` and without: the paged kernel launches
   exactly (decode steps + mixed steps) x layers times, and is held
   against its plain version on the mixed step's decode view, whose
   chunking row is the sentinel page; every page returns; one decode
   graph; the long prompt's first token is the same in both arms or a
   teacher near-tie; the short streams' largest and p99 inter-token gap
   while the long prompt is admitted, and the mixed steps' ms. Then
   ``embed()`` of 64-, 300-, 1024- and 1536-token prompts in the chunked
   engine, each vector at cosine >= 0.999 with a float32 teacher's final
   ln_f hidden state, the pool empty after;
18. the rest of the paged Engine: gpt3-1.3b (bf16, random weights from
   ``--seed``) at phase 4's configuration and traffic. A ``spec_k=0``
   arm gives the target's own greedy streams. (a) ``spec_k=2,
   spec_adaptive=True, spec_k_max=8`` (rungs 1, 2, 4, 8: verify widths
   2, 3, 5, 9) with an oracle drafter of those streams climbs to k=8
   and ends there;
   (b) the same ladder from k=8 with an always-wrong drafter walks down
   to 1. In each, the first step (which builds every rung) runs before
   the sentinel is armed and the rest under it (decode_traces 1); B3
   launches exactly verify steps x layers on every rung, and is held
   against its plain version on each rung's live state; streams equal
   the spec_k=0 arm's or part at a float32-teacher near-tie; every page
   returns; the k history, accept rate, ms/step and tokens/s are
   printed, and a profile of (a)'s full verify steps. (c) The JAX
   package's repetitive trace shape (10 prompts repeating a 4-token
   motif, up to 512 tokens, budgets 16-32) through the n-gram drafter,
   adaptive, fixed spec_k=4 and spec_k=0. (d) ``draft_model=`` a
   gpt2-124m (random weights) greedily continuing the context, eagerly:
   its drafting ms a step beside the rest of the step. (e) Deadlines
   under an injected clock skew (queued expiries hold no page,
   mid-verify ones keep their tokens), ``max_queue=2`` under refuse,
   shed_newest and shed_closest_deadline (the documented victims), a
   ``reserve_fail`` x3 against ``admission_retries=3``
   (`PoolExhaustedError`), background mode (``with Engine(...) as
   eng:``: phase 4's requests from the main thread, streamed from the
   loop thread; the same tokens or a near-tie; stop() joins; every
   timeline monotone with its cause; the TTFT histogram's p50 within a
   bucket of the host's), and a ``step_error`` at a verify dispatch
   (every handle fails, every page returns);
19. the training plane: gpt3-1.3b's widths at 8 of its 24 layers (bf16
   params and AdamW moments, b8 x s1024 from ``--seed``, a step-indexed
   batch source) through `framework.ResilientTrainLoop` around phase 5's
   `SpmdTrainStep`, its checkpoints in ``_plane_ckpt/`` under the
   checkout (removed after). (a) 8 steps with async commits every 4, the
   launch counts zeroed just before and read just after (B1's forward and
   backward steps x layers, the update once a step), beside five runs
   with no checkpoint from the same state: step ms p50 of each, the
   snapshot's copy to pinned host memory (ms, bytes),
   ``train_checkpoint_write_seconds``; (b) a crash right after the
   commit at step 4, the live state zeroed, and a fresh loop on the same
   step resuming from it: every tensor the crashed state's bit for bit,
   the first resumed loss the crashed state's eager step bit for bit,
   the final state within the C.7 bound of (a)'s (the spread of the five
   runs from (a)'s), the later losses within the larger of twice their
   spread and 1e-4 of the loss, no new build, the restore's
   seconds; (c) a NaN loss rolled back with its data window skipped, a
   NaN planted in one layer's weight named by ``last_anomaly`` through
   ``introspect=True``, a torn and a corrupt checkpoint each passed over
   by the restore, and ``request_preemption()``'s emergency snapshot;
   (d) ``introspect=True`` against False: the first loss bit for bit,
   one build each, step ms of both. B1's and the update's launches in
   the kernels line are this phase's.
20. ViT-L/16 (`models.vit`: 24 layers, width 1024, 16 heads of 64, MLP
   4096, 224 px, patch 16: 197 tokens; bf16, random weights from
   ``--seed``), b32: (a) the eval forward's logits against a float32
   copy (cosine >= 0.999), no kernel launched, images/s; (b) training
   through `SpmdTrainStep` as one graph (AdamW lr 1e-4 wd 0.05,
   cross-entropy over 1000 classes; benchmarks/bench_vit.py's
   operating point): the bf16 loss and grads against the float32 copy,
   five timed replays under the armed sentinel in which no flash kernel
   launches (neither gate takes 197 tokens, as in the reference) and the
   update once a step, the first loss within 0.5 of ln 1000, images/s,
   step ms p50 and MFU by bench_vit.py:77-83's FLOP count, the
   replay-against-eager gate with both its controls, a profile; then,
   not a gate, B2 at ViT's attention shape (B32 S197 H16 D64, forward
   and backward) beside SDPA and the composition the gate picks;
21. the encoder-decoder `nn.Transformer` at its defaults (d_model 512, 8
   heads of 64, 6+6 layers, FFN 2048, ReLU, post-LN: the base model of
   Vaswani et al. 2017), bf16, b32, 256 source and 128 target random
   embeddings, ``tgt_mask = generate_square_subsequent_mask(128)``:
   the output against a float32 composed copy at dropout 0 and the bf16
   loss and grads (a grad whose bf16 control, the plain versions, lies
   below 0.999, behind ReLU flips, held to that control less 1e-3), no
   NaN; training through `SpmdTrainStep` as one graph at
   dropout 0.1 (MSE against a random target): in five timed replays B5
   (the encoder's self-attention) launches steps x 6 times each way, B2
   steps x 12 (the decoder's causal self-attention under the -inf bias
   and its cross-attention at Sq=128 Sk=256) and the update once a step;
   then incremental decode with `TransformerDecoder.gen_cache` (a
   `Cache` and a `StaticCache` a layer) over 128 steps from the
   encoder's memory, each step's row against the full causal forward's
   within 3 x the bf16 model's own error against the float32 copy (the
   float32 copy's within 1e-4), ms a step. B2's and B5's launches in the
   kernels line add this phase's to phases 6 and 7's;
22. `incubate.nn.FusedMultiTransformer` at gpt3-1.3b's widths (2048 wide,
   16 heads of 128, FFN 8192, 24 layers, GELU), bf16, eagerly: 8
   prompts of 128 random embeddings prefilled into ``gen_cache(8,
   640)``, 32 decode steps with ``time_step``, and a ``pre_caches`` arm;
   every row against the no-cache forward's under a causal mask within
   3 x the bf16 model's own error against float32; prefill ms, decode
   ms a step;
23. the MoE layer on one card (`incubate.distributed.models.moe`):
   d_model 2048, 8 stacked experts of 8192, `GShardGate` top-2 at
   capacity factor 1.25, b8 x s1024 tokens (capacity 320): forward and
   backward against a float32 copy (cosine >= 0.999 for the output and
   the grads), the dispatch equal on every token whose gate margins
   exceed 2^-8, listed experts equal to the stacked ones within 2 bf16
   ulps of the output's scale, forward and forward+backward ms;
24. A5's layer base: `nn.Transformer()` at its defaults (phase 21's
   model) built on the card from the reference's initializers and
   attrs, no `init_weights` (weights ``ParamAttr(XavierNormal(),
   learning_rate=0.5, regularizer=L2Decay(1e-4))``, biases
   ``ParamAttr(need_clip=False)``): every fresh weight's mean and std
   within 6 sampling sigmas of XavierNormal's, biases 0, LayerNorm
   scales 1; encoder layer 0's first LayerNorm ``trainable=False``;
   ``astype("bfloat16")``; the float32 copy's loss and grads at dropout 0
   (as phase 21); 5 eager steps of ``AdamW(parameters=...,
   multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))`` on phase
   21's batch shape with ``loss.backward(); opt.step();
   opt.clear_grad()`` at dropout 0.1, in which B5 launches 6 times each
   way a step, B2 12 and the update once (the rate scales in its
   entries), every loss finite, the frozen LayerNorm bit for bit; the
   eager step's ms p50; then ``state_dict`` through `framework.save` /
   ``load`` onto the card into a twin built under `LazyGuard` and
   ``initialize()``d on the card: bit for bit, its eval forward the
   model's bit for bit. B2's and B5's launches in the kernels line add
   this phase's;
25. A5 slice 2: (a) the reference's ``resnet50()`` at its defaults
   (1000 classes, 224 px, NCHW, float32, TF32 off) built on the card
   from its default initializers, trained eagerly for 6 steps on b32
   random batches with `nn.CrossEntropyLoss` and ``Momentum(0.01,
   0.9)``: a float64 copy holds the eval-mode pass (loss, logits, every
   grad at cosine >= 0.9999 and within 1e-4 of each tensor's largest
   |value|) and the first step's train-mode pass (loss, logits and every
   running statistic the same; every grad at cosine >= 0.999 and 5%
   relative L2 error: a train-mode batch norm's backward magnifies
   float32 rounding), bn1's running statistics are ``0.9 * init + 0.1 *
   (batch mean, biased batch variance)`` of its input, its eval output
   the formula on them; step ms p50, images/s, peak memory and a profile
   of one step; ``state_dict`` through `framework.save`/``load`` into a
   `LazyGuard` twin initialized on the card, bit for bit. (b) phase 24's
   `nn.Transformer()` and batch shape with ``activation="gelu"``, bf16:
   the float32 copy as phase 24, then one eager step with `nn.MSELoss`,
   6 B5 and 12 B2 launches each way (they add to the kernels line). (c)
   every activation, loss, norm, pooling and common layer and the vision
   functions on the card against a ``.to("cpu")`` copy: outputs, grads
   and buffers within 1e-5 of their scale.
26. A5 slice 3: (a) the "large" LSTM language model of Zaremba et al.
   2014 (vocabulary 10000, 2 x LSTM 1500, dropout 0.65, U(-0.04, 0.04)
   through `ParamAttr`, 66.0M parameters, float32) built on the card and
   trained eagerly for 10 steps of b20 x 35 token ids from the seed with
   ``SGD(1.0)`` and ``ClipGradByGlobalNorm(10)``, the state carried:
   with dropout off its loss and grads against a float64 copy whose LSTM
   runs the cells' formulas step by step and against its CPU copy; step
   ms p50, words/s, peak memory, a profile of one step, and the cost of
   the stack's separate weight tensors against ``torch.nn.LSTM`` on one
   flattened chunk. (b) `nn.Transformer()` at its defaults with a 37000
   vocabulary beam-searched (`BeamSearchDecoder`, `dynamic_decode`:
   beam 4, 64 steps, the decoder's caches, one query a step) from b8 x
   256 source ids: exactly 6 B5 forward launches (the encoder) and
   nothing else; the encoder's ms, ms a decode step, kernels and host
   launch calls a step; a float64 copy's ids, lengths and log-probs,
   rows that part held to the copy's 0.05 near-tie band. B5's launches
   in the kernels line add this phase's. (c) each new layer and function
   on the card against its CPU copy, as 25c: the stacks with
   ``sequence_length`` (the packed fused route), `RNN` and `BiRNN` over
   each cell, ``ctc_loss``, ``hsigmoid_loss``, ``max_unpool2d``,
   ``weight_norm``, ``spectral_norm`` and the quant layers (STE grads,
   running scales).
27. A2 and A3: (a) the float16 forms of B2 (B8 S512 H16 D64, key
   padding, dropout 0.1), B5 (the same shape, full), B1 (B8 S1024 H16
   D128 causal), B4 (B1 S2048 H16 D128, a random lse cotangent) and P1
   (gpt3-1.3b's 292 tensors: float16 params and grads with float32
   moments and masters, and float16 throughout) against their plain
   versions, 8 float16 ulps of each element's scale beside a float32
   control (P1 within 1 ulp), each timed beside its bf16 form at the
   same shape, SDPA in float16 (P1: ``torch._fused_adamw_`` on the
   masters) and its bound. (b) phase 26b's model in train mode (dropout
   0.1) trained eagerly on b32 x (256 + 128) ids with ``AdamW(0.9,
   0.98, 1e-9)`` under `amp.auto_cast`: O1 float16 with a
   ``GradScaler(2**15)``, O2 float16 through `amp.decorate` with the
   scaler, O1 bfloat16 without one; each run's float32 check on
   TR_HELD's grads (phases 20-25's rule), the hook's casts of one step
   by op, B2 (float16 or bf16) and B5 (float32 under O1, float16 under
   O2) launches, no composed attention, step ms p50 of steps 2-6,
   tokens/s, peak memory, the loss scale, skipped steps and a profile.
28. A4, the op namespace: (a) every function of ``ops`` (with
   ``linalg``'s), ``fft`` and ``signal`` on CUDA tensors from the seed
   against the same call on CPU copies, tolerances by family
   (`NS_TOL`), the decompositions by their invariants, the random ops
   by shape, dtype and device; the float ops of `NS_LOW` also in float16
   and bfloat16 against the CPU's float32 on the same rounded inputs;
   the counts, the card's total time, the functions that synchronise
   with the host inside the call, and any failure by name. (b)
   gpt3-1.3b (phase 5's model and b8 x s1024 shape, dropout 0, float32
   parameters) trained eagerly under ``amp.auto_cast(level="O1",
   dtype="float16")`` with ``GradScaler(2**15)`` and AdamW on a repeated
   batch: float16 logits (the LM head through ``ops.matmul``), step 0's
   loss within 0.5% of a float32 forward's, B1's float16 kernels exactly
   steps x layers times each way, the update once a kept step, a
   falling loss; step ms p50, tokens/s, MFU, peak memory and a profile
   (busy share, kernels and host launch calls a step). B1's float16
   launches in the kernels line are this phase's.

The kernel phase (3) also holds the paged kernel at head dims above 256
(D 320 and 512: width 512 in 2-query tiles; ps 16 and 4, f32, bf16 and
int8 pages, W 1 and 5, the split-walk rows, the tail read), timed at 8
slots x 2560 hidden (8 heads of 320, 5 of 512) beside its plain version,
SDPA over the gathered view and its bound (their launches are those
counted at width 512 on the main paths of phases 4-18, of their page
type: no model there serves such heads), and times it on bf16 pages at
the verify widths 2, 3, 5 and 9 of phase 18's rungs at phase 4's decode
shape (their launches phase 18's).

The last lines are a ``{"kernels": [...]}`` JSON line, the whole run's
wall seconds, the card's ``nvidia-smi`` name/power-limit line, and
``{"ok": true, "device": {...}}``. Without a visible CUDA device the
script prints no result and exits 1.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# kernel-phase tolerances: f32 differs only by summation order; bf16
# outputs are rounded to bf16 (lse stays f32 in both versions)
TOL_F32 = dict(atol=1e-4, rtol=0.0)
TOL_BF16_OUT = dict(atol=2e-2, rtol=2e-2)
TOL_BF16_LSE = dict(atol=1e-3, rtol=0.0)
# LayerNorm's dg and db, f32: column sums over 512 rows of values of
# order 1, in another order
TOL_LN_SUMS = dict(atol=1e-3, rtol=1e-4)
# at the engine's decode shape |out| is about 0.07 (a softmax over ~500
# random scores), so bf16 out is held to a few bf16 ulps there, and the
# same inputs in float32 to TOL_F32
TOL_BF16_OUT_DECODE = dict(atol=2e-3, rtol=0.0)
# the beam's tail read softmaxes as few as 41 columns, so |out| reaches
# about 0.7, where one bf16 ulp (2^-8 of the value) is 0.0039: both
# versions round the same float32 math (held to TOL_F32) to bf16 and
# may land one ulp of each element's own value apart
TOL_BF16_OUT_TAIL = dict(atol=2e-3, rtol=2.0 ** -8)
TEACHER_GAP = 0.05               # bf16 near-ties the teacher check allows
# the quantized pages: kv_quant mode -> page dtype name in torch
QUANT_DTYPES = {"int8": "int8", "fp8": "float8_e4m3fn"}
# flash kernels against their plain versions, bf16: the kernel rounds
# p*keep (against a running max) and ds to bf16 where the plain version
# rounds them against the global max, then sums them in another order.
# Each element of o and dqkv is held to a few bf16 ulps (2^-8) of its own
# scale (`flash_ulp`), never of the tensor's largest value: a 5% error
# on any one row is about 13 such ulps and fails
BF16_ULPS_O, BF16_ULPS_DQKV = 8, 8
# the scale's floor, as a share of the tensor's rms: only rows that
# cancel to about 0 in both versions (causal row 0's dq) sit on it
FLASH_SCALE_FLOOR = 1 / 64
FLASH_SEED = 20260               # the dropout seed of the kernel phase
# B2's bf16 kernels by their names in a profile (csrc/flash_attention.cu;
# the delta pre-pass is flash_common.cuh's): its forward, then the
# backward that B1 and B5 run too, with its pre- and post-pass
B2_KERNELS = ("::fwd_wg_kernel<", "::bwd_wg_kernel<", "flash_delta_kernel<",
              "::bwd_dq_round_kernel<")
# B1's and B5's bf16 kernels: the qkv forward (csrc/flash_attention_qkv.cu)
# and B2's backward
QKV_KERNELS = ("::flash_fwd_wg_kernel<", *B2_KERNELS[1:])
# B2's bf16 kernels at D=256 (phase 13): the wgmma forward resized, the
# one-pass backward of 64-key blocks, its pre- and post-pass; and the
# kernels sliced over D, which bf16 runs only above 256
B2_D256_KERNELS = ("::fwd_wg_kernel<256>(", "::bwd_wg_wide_kernel<256>(",
                   "flash_delta_kernel<", "::bwd_dq_round_kernel<256>(")
SLICED_TC_KERNELS = ("_wide_tc_kernel(",)
# the backward's times before it moved onto B2's kernel (PERF.md §6, the
# mma.sync kernels' last readings: PR 8's final run; the fused BERT's
# shape PR 7's), printed beside the new ones
OLD_BWD_MS = {"gpt": 1.2530, "fused_bert": 0.3978, "qkv3": 0.3901}
SLEEP_CYCLES = 100_000_000       # about 50 ms at the H100's clock

# engine phase: the serving configuration and its traffic
MODEL = "gpt3-1.3b"
SLOTS, PAGE, MAX_LEN, BUCKETS, MAX_NEW = 8, 16, 640, (128, 512), 32
SPEC_K = 4                       # phase 9's verify window: k + 1 = 5 lanes
# phase 18's adaptive ladder: spec_k 2 up to 8, rungs (1, 2, 4, 8), the
# verify widths k + 1
SPEC_K0, SPEC_K_MAX = 2, 8
VERIFY_WIDTHS = (2, 3, 5, 9)
# phase 18 (c): the JAX package's repetitive trace shape
# (benchmarks/bench_serving.py:238-255): REP_N prompts repeating a motif
# of REP_MOTIF tokens, up to max(BUCKETS) long, arriving over REP_SPREAD
# steps; (d): DRAFT_N requests of DRAFT_NEW tokens drafted by gpt2-124m
REP_N, REP_MOTIF, REP_SPREAD = 10, 4, 5
DRAFT_MODEL, DRAFT_N, DRAFT_NEW = "gpt2-124m", 4, 16
# the paged kernel's head dims above 256 (width 512, 2-query tiles)
WIDE_HEAD_DIMS = (320, 512)
# training phase: the flagship configuration of bench.py:76-133
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR, TRAIN_WD = 8, 1024, 5, 1e-4, 0.01
# the bf16 model against a float32 copy of its weights (plain attention):
# bf16 rounds every activation to 8 significant bits over 24 layers.
# Read on one H100 at seed 0: loss rel 2.0e-05, grad cosine >= 0.99985.
# The loss at random init is about ln(V) + 0.4 for any attention, so the
# grads carry the check: a 20% error on a quarter of the rows of a
# checked grad costs about 0.2^2 / 4 / 2 = 5e-3 of cosine
REF_LOSS_RTOL, REF_GRAD_COS = 1e-3, 0.999
# BERT phase: bert-large pretraining on padded batches (the repo's
# BASELINE row 4, benchmarks/exp_flash_mask_dropout.py:10-13): b8 x s512,
# per-row lengths in [384, 512), MLM labels on 15% of the real positions
BERT_MODEL, BERT_B, BERT_S, BERT_MIN_LEN, BERT_MLM = ("bert-large", 8, 512,
                                                      384, 0.15)
PROMPT_LENS = (20, 75, 130, 190, 250, 310, 370, 430, 480, 500)
SUBMIT_AT_STEP = (0, 0, 0, 0, 2, 2, 2, 5, 5, 5)
# generation phase: the JAX package's decode benchmark shapes
# (benchmarks/bench_decode.py:436-448) at full depth: b8 x prompt 1024
# (dense) + 128 new, beam 4; the int8 arms with 32 new
GEN_B, GEN_PROMPT, GEN_NEW, GEN_BEAMS, GEN_SHORT = 8, 1024, 128, 4, 32
# the paged beam against the gather oracle in float32 (TF32 off), at
# full depth on a smaller batch: identical tokens unless, where they
# part, the two candidates' log-probs differ by less than BEAM_GAP
GEN_AB_B, GEN_AB_PROMPT, GEN_AB_NEW, BEAM_GAP = 2, 128, 16, 1e-4
GEN_PROFILE_STEPS = 8
# timed generate calls a reading (their median): one call's host-clock
# wall moves by up to a few hundred ms between runs
GEN_TIMED_CALLS = 3
# sequence-parallel phase: GPT-1.3B's heads, one ring chunk of a 4-way
# split of 8192 tokens
SP_WAYS, SP_CHUNK = 4, (1, 2048, 16, 128)
# phase 12: gpt3-2.7b (32 heads of 80) served at phase 4's configuration
# and traffic; its paged beam at b2 x prompt 128 + 32
MODEL_27B, BEAM_B, BEAM_PROMPT, BEAM_NEW = "gpt3-2.7b", 2, 128, 32
# phase 13: attention at Gemma-2B's widths (its config.json on the
# Hugging Face Hub: hidden 2048, 8 heads of head_dim 256, MLP 16384, 18
# layers) in the port's TransformerEncoderLayer, b4 x s1024, key padding
# with lengths in [768, 1024), dropout 0.1
GEMMA_WIDTH, GEMMA_HEADS, GEMMA_FFN, GEMMA_LAYERS = 2048, 8, 16384, 18
GEMMA_B, GEMMA_S, GEMMA_MIN_LEN = 4, 1024, 768
GEMMA_ATTN = (GEMMA_B, GEMMA_S, GEMMA_HEADS, GEMMA_WIDTH // GEMMA_HEADS)
# phase 16: the JAX package's shared-prefix trace shape
# (benchmarks/bench_serving.py:215-236): PFX_N requests behind PFX_SYS
# system prompts of PFX_SYS_LEN tokens (24 pages of 16), user suffixes
# of 2..PFX_SUFFIX tokens, budgets of PFX_NEW // 4..PFX_NEW
PFX_N, PFX_SYS, PFX_SYS_LEN, PFX_SUFFIX, PFX_NEW = 16, 2, 384, 64, 32
# one arrival every PFX_EVERY steps: at one a step the 8 slots fill by
# step 8, and the TTFT p50 falls between requests admitted at once and
# requests that waited in the queue
PFX_EVERY = 3
# phase 17: its mixed long/short trace shape (bench_serving.py:191-212):
# MIX_SHORT prompts of MIX_SHORT_LEN tokens + MIX_SHORT_NEW decoding when
# one MIX_LONG-token prompt + MIX_LONG_NEW arrives at step MIX_LONG_AT.
# The long prompt's bucket is its own length: a 2048 bucket would leave
# no column for its tokens under gpt3-1.3b's 2048 positions
MIX_SHORT, MIX_SHORT_LEN, MIX_SHORT_NEW = 7, (20, 250), 64
MIX_LONG, MIX_LONG_NEW, MIX_LONG_AT = 1536, 2, 4
MIX_MAX_LEN, MIX_BUCKETS, MIX_CHUNK = 2048, (256, 1536), 256
# embed(): prompt lengths and the cosine each vector keeps with the
# float32 teacher's (the bf16 model's rounding over 24 layers)
EMBED_LENS, EMBED_COS = (64, 300, 1024, 1536), 0.999
# phase 19, the training plane: gpt3-1.3b's widths cut to PLANE_LAYERS
# layers (each snapshot crosses host memory and the disk), PLANE_STEPS
# steps, a commit every PLANE_INTERVAL, the crash at PLANE_CRASH_AT (right
# after a commit); checkpoints in PLANE_DIR under the checkout, removed
# after the phase. The C.7 bound of the resumed run's final state takes
# its spread from PLANE_SPREAD_RUNS runs with no checkpoint beside (a).
# Its losses, each a reduction over the whole state's noise, lie within
# the larger of GRAPH_SPREAD times those runs' loss spread and
# PLANE_LOSS_RTOL of the loss: on an H100 the dq atomics moved the later
# losses of two runs from one state by up to 1.27e-4 at 11.2 (1.1e-5 of
# it), while all five spread runs agreed bit for bit in some calls; the
# floor is ten times that reading and a tenth of the bf16 model's own
# error against float32 (REF_LOSS_RTOL). A resume fed the next batch
# must lie outside that bound (the control)
PLANE_LAYERS, PLANE_STEPS, PLANE_INTERVAL, PLANE_CRASH_AT = 8, 8, 4, 4
PLANE_SPREAD_RUNS, PLANE_LOSS_RTOL = 5, 1e-4
PLANE_DIR = "_plane_ckpt"
# phase 20: ViT-L/16 at benchmarks/bench_vit.py's operating point (b32,
# AdamW lr 1e-4 wd 0.05); its attention shape, where B2 is measured
VIT_MODEL, VIT_B, VIT_WD = "vit-l-16", 32, 0.05
VIT_ATTN = (32, 197, 16, 64)
# phase 21: nn.Transformer's defaults (Vaswani et al. 2017, base) on b32
# batches of 256 source and 128 target embeddings, dropout 0.1; the
# float32 copy's incremental decode against its full forward (summation
# order only)
TR_B, TR_SRC, TR_TGT, TR_D, TR_LAYERS, TR_DROPOUT = 32, 256, 128, 512, 6, 0.1
TR_F32_DECODE = 1e-4
# phase 24: the layer base's Transformer: its weights' rate scale and
# L2Decay, LB_STEPS eager steps, a fresh weight's mean and std within
# LB_SIGMAS sampling sigmas of XavierNormal's
LB_RATE, LB_L2, LB_STEPS, LB_SIGMAS = 0.5, 1e-4, 5, 6.0
# phase 21: the grads the float32 check holds. Phase 24 (XavierNormal
# weights, std 0.044 against phase 21's 0.02) holds the last layer's
# cross-attention value projection in place of its key projection and
# shows that one: its bf16 grad stood at cosine 0.925-0.969 against
# float32 through the plain versions in two card runs, rounding-bound
# with or without the kernels
TR_HELD = ("encoder.layers.0.self_attn.v_proj.weight",
           "encoder.layers.5.linear1.weight",
           "decoder.layers.0.self_attn.v_proj.weight",
           "decoder.layers.0.cross_attn.v_proj.weight",
           "decoder.layers.5.cross_attn.k_proj.weight",
           "decoder.layers.5.linear1.weight")
LB_HELD = (*TR_HELD[:4], "decoder.layers.5.cross_attn.v_proj.weight",
           TR_HELD[5])
LB_SHOWN = TR_HELD[4]
# phases 21-22: an incremental row against the full forward's, in bf16,
# within this many times the bf16 model's own error against float32
DECODE_OWN_ERRS = 3
# phases 20-21's float32 check: a grad whose bf16 control (the plain
# versions; a ReLU input that bf16 moves across 0 flips its grad) already
# lies below REF_GRAD_COS is held to that control's cosine less this
GRAD_COS_SLACK = 1e-3
# phase 22: FusedMultiTransformer at gpt3-1.3b's widths; 8 prompts of 128
# into a 640-column cache, 32 decode steps; the pre_caches arm carves out
# the first 32 tokens
FMT_WIDTH, FMT_HEADS, FMT_FFN, FMT_LAYERS = 2048, 16, 8192, 24
FMT_B, FMT_PROMPT, FMT_NEW, FMT_MAX_LEN, FMT_PRE = 8, 128, 32, 640, 32
# phase 25a: the reference's resnet50() at its defaults (1000 classes,
# 224 px, NCHW, float32, TF32 off) on b32 batches, trained eagerly with
# examples/train_vision.py's Momentum(0.01, 0.9) and CrossEntropyLoss
RN_B, RN_HW, RN_CLASSES, RN_STEPS = 32, 224, 1000, 6
RN_LR, RN_MOMENTUM = 0.01, 0.9
# its float64 copy (the same weights and batch): the loss within
# RN_LOSS_RTOL; the logits, the eval-mode grads and the running statistics
# after a step at cosine >= RN_COS and within RN_MAX_ERR of each tensor's
# largest |value|. The train-mode grads at cosine >= RN_TRAIN_COS and
# relative L2 error <= RN_TRAIN_L2: a train-mode batch norm's backward
# projects the mean and the normalised input out of the gradient that
# reaches it, most of which lies along them at initialisation, and so
# magnifies its float32 rounding (ResNet-50 on the CPU, b2-b8 at 64-112
# px, float32 against float64: cosine 0.9995-0.9997 and 1.7-3.2% L2
# error in the worst tensor, every tensor within 1.1e-6 in eval mode)
RN_LOSS_RTOL, RN_COS, RN_MAX_ERR = 1e-4, 0.9999, 1e-4
RN_TRAIN_COS, RN_TRAIN_L2 = 0.999, 0.05
# the eval-mode grads' largest element error: cuDNN's float32 weight
# gradients stood at 2.65e-3 of layer4.1.conv3.weight's largest |value|
# on one H100 at seed 0 (cosine 0.999998; 1.3e-6 for the same model on
# the CPU at b8 x 64 px): held at 1e-2
RN_GRAD_MAX_ERR = 1e-2
# bn1's running statistics and its eval output against their formulas,
# computed in float64 from its input: within RN_BN_TOL of the largest
# |value|
RN_BN_TOL = 1e-5
# phase 25c: each layer of A5 slice 2 on the card against its copy on the
# CPU, float32: outputs and buffers within SWEEP_REL of their largest
# |value|, grads within SWEEP_GRAD_REL (backward passes subtract nearly
# equal sums: softmax's g - sum(g * y), a batch norm's projections; the
# softmax input grad stood 4.4e-5 from the CPU's on one H100 at seed 0)
SWEEP_REL, SWEEP_GRAD_REL = 1e-5, 1e-4
# phase 26a: the "large" LSTM language model of Zaremba, Sutskever and
# Vinyals 2014 (arXiv:1409.2329 section 4.1; TensorFlow's ptb_word_lm.py
# LargeConfig, PaddlePaddle/models' ptb_lm "large"): vocabulary 10000,
# 2 layers of 1500, dropout 0.65, every parameter U(-0.04, 0.04), batch
# 20 x 35 steps unrolled, SGD at 1.0 with a global-norm clip at 10,
# float32; PTB_STEPS eager steps on token ids from the seed
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS, PTB_DROPOUT, PTB_INIT = (10000, 1500, 2,
                                                            0.65, 0.04)
PTB_B, PTB_T, PTB_LR, PTB_CLIP, PTB_STEPS = 20, 35, 1.0, 10.0, 10
# its float64 copy (the cells' formulas step by step) and its CPU copy,
# dropout off: the loss within PTB_LOSS_RTOL, every grad at relative L2
# error <= PTB_GRAD_L2 (float32 sums over 35 steps and 1500-wide rows)
PTB_LOSS_RTOL, PTB_GRAD_L2 = 1e-5, 1e-4
# phase 26b: nn.Transformer() beam-searched with dynamic_decode: the
# shared WMT14 En-De vocabulary of Vaswani et al. 2017 (section 5.1),
# b8 x 256-token sources, beam 4, 64 steps; float32 against a float64
# copy. Until a row's selections part, both decodes see the same tokens:
# there its logits are held within BS_LOGIT_ATOL of the copy's (one H100
# read 1.069e-06 at seed 0, the logits within 0.74 of 0). The
# log-probs and the copy's score gap where a row parts are held to what
# that logit error can explain: a step moves a log-softmax value by at
# most 2x the step's logit error, plus float32 rounding (one ulp of the
# running total and BS_LSM_ROUND for the log-softmax itself)
BS_VOCAB, BS_B, BS_SRC, BS_BEAMS, BS_STEPS = 37000, 8, 256, 4, 64
BS_START, BS_END, BS_LOGIT_ATOL, BS_LSM_ROUND = 0, 1, 5e-6, 2.0 ** -17
# phase 23: the MoE layer at gpt3-1.3b's width, 8 experts of 8192,
# GShardGate top-2 at capacity factor 1.25, b8 x s1024 tokens; a token's
# dispatch is held where its gates' margins exceed one bf16 rounding
MOE_D, MOE_E, MOE_H, MOE_CF, MOE_B, MOE_S = 2048, 8, 8192, 1.25, 8, 1024
MOE_TIE = 2.0 ** -8


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events).
    The calls are queued behind a sleep kernel, so the card runs them
    back to back and the host's time to issue them (a wrapper's Python
    checks, autograd) does not enter while the sleep lasts (a ``fn`` that
    waits for the card itself, as the plain versions that read the
    dropout seed do, is paced by the host whatever the sleep)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels
def paged_case(n, h, w, d, ps, pmax, dtype, seed, steps=None, pads=None):
    """Inputs of one paged-attention call on the card: a shuffled block
    table over ``n * pmax`` pages plus the sentinel (the last page), and
    left pads in ``valid_cols``. Without ``steps``, the steps are ragged
    and random, row 1 is fully masked by ``valid_cols`` and row 2 is
    parked on the sentinel page (a freed serving slot)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pages = n * pmax
    pool_k = torch.randn((pages + 1, h, ps, d), generator=g, device="cuda"
                         ).to(dtype)
    pool_v = torch.randn((pages + 1, h, ps, d), generator=g, device="cuda"
                         ).to(dtype)
    bt = torch.randperm(pages, generator=g, device="cuda").reshape(
        n, pmax).to(torch.int32)
    lp = pmax * ps
    special = steps is None
    if special:
        steps = torch.randint(0, lp - w + 1, (n,), generator=g,
                              device="cuda")
        pads = (torch.rand((n,), generator=g, device="cuda")
                * steps).long()
    steps = torch.as_tensor(steps, device="cuda").to(torch.int32)
    pads = torch.as_tensor(pads, device="cuda").long()
    vc = (torch.arange(lp, device="cuda")[None, :]
          >= pads[:, None]).to(torch.int32)
    if special:
        vc[1] = 0                                 # fully masked row
        bt[2] = pages                             # parked on the sentinel
        steps[2] = 0
        vc[2] = 0
    q = torch.randn((n, h, w, d), generator=g, device="cuda").to(dtype)
    return q, pool_k, pool_v, bt, steps.contiguous(), vc.contiguous()


def paged_work(bt, steps, vc, w, h, d, el, page_el=None, ps=PAGE):
    """Bytes and flops one paged-attention call needs on this data. A
    row needs the pages that hold a readable column (``valid_cols != 0``
    and at most ``steps + w - 1``); a page of left padding alone cannot
    change the row's result and is not counted (a row with no readable
    column averages every page of its table, so it needs them all).
    Bytes: those pages' K and V once (``page_el`` bytes an element; a
    1-byte page adds its column's f32 scale), their block-table entries,
    the valid_cols read, steps, q, out and lse (q and out ``el`` bytes an
    element). Flops: q.k and p.v over the pages' columns."""
    n, pmax = bt.shape
    pages = cols_read = 0
    for s, v in zip(steps.tolist(), vc.cpu()):
        last = min(s + w - 1, v.shape[0] - 1)
        live = v[:last + 1].nonzero().flatten()
        if live.numel():
            pages += len(set((live // ps).tolist()))
            cols_read += last + 1
        else:
            pages += pmax
            cols_read += pmax * ps
    page_el = el if page_el is None else page_el
    per_col = d * page_el + (4 if page_el == 1 else 0)
    nbytes = (pages * ps * h * 2 * per_col     # K and V pages (+ scales)
              + 2 * n * h * w * d * el         # q in, out
              + n * h * w * 4                  # lse
              + pages * 4 + n * 4 + cols_read * 4)
    flops = 4 * w * h * d * pages * ps
    return nbytes, flops


def quantize_case(torch, args, mode):
    """A `paged_case` with its pools quantized as the engine writes them
    (`paged_kv.quantize_tokens`: int8 or fp8 e4m3 pages, f32 scales).
    Returns ``(args, kwargs)`` of the kernel and its plain version."""
    from paddle_tpu_torch.kernels.paged_kv import quantize_tokens

    dt = getattr(torch, QUANT_DTYPES[mode])
    q, pk, pv, bt, st, vc = args
    (pk, ks), (pv, vs) = (quantize_tokens(p, dt) for p in (pk, pv))
    return (q, pk, pv, bt, st, vc), dict(k_scale=ks, v_scale=vs)


def paged_checks(torch, pa):
    """The paged kernel against its plain version on toy shapes (6 rows
    x 8 heads, 8 pages a row; ragged steps, left pads, a fully masked
    row, a row parked on the sentinel): float pools (q and pages f32 or
    bf16) and quantized ones (int8 and fp8 pages, q f32 or bf16), D 64
    and 128, W 1, 4 and 5, page size 16 and 32 for the quantized ones.
    Both dequantize in f32, so f32 holds to TOL_F32 and bf16 out to
    TOL_BF16_OUT, lse to TOL_BF16_LSE."""
    cases = [(d, dtype, w, PAGE, None) for d in (64, 128)
             for dtype in (torch.float32, torch.bfloat16) for w in (1, 4, 5)]
    cases += [(d, dtype, w, ps, mode) for mode in QUANT_DTYPES
              for d in (64, 128) for dtype in (torch.float32, torch.bfloat16)
              for w in (1, 4, 5) for ps in (16, 32)]
    for d, dtype, w, ps, mode in cases:
        args = paged_case(6, 8, w, d, ps, 8, dtype, seed=100 + d + w + ps)
        kw = {}
        if mode is not None:
            args, kw = quantize_case(torch, args, mode)
        out, lse = pa.fused_paged_attention(*args, **kw)
        ref_out, ref_lse = pa.paged_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            tol_o, tol_l = TOL_F32, TOL_F32
        else:
            tol_o, tol_l = TOL_BF16_OUT, TOL_BF16_LSE
        torch.testing.assert_close(out.float(), ref_out.float(), **tol_o)
        torch.testing.assert_close(lse, ref_lse, **tol_l)
        check(torch.isfinite(out.float()).all().item(), "non-finite out")
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        pages = mode or "float"
        print(f"  paged_attention {pages} pages D={d} q {str(dtype)[6:]} "
              f"W={w} ps={ps}: max|out-ref| {err_o:.3e}  max|lse-ref| "
              f"{err_l:.3e}  ok")


def split_case(torch, w, dtype, seed, d=128, ps=PAGE):
    """Inputs of one paged call whose rows exercise the split page walk
    (N=8, H=4, D=128, ps=16, Pmax=40: `plan_splits` cuts the table into
    4-page splits on an H100): row 0 readable only in its first split,
    its cursor on the last column; row 1 at cursor 0; row 2 parked on
    the sentinel page; row 3 with no readable column, its cursor on the
    last column (every page of every split averaged); row 4 whose last
    query alone has a readable column (its own cursor column); row 5
    whose window straddles the boundary of splits 0 and 1 (columns 62
    to 62 + w - 1); rows 6-7 ragged with left pads. Other head dims
    ``d`` and page sizes ``ps`` keep the table at about 640 columns
    (``640 // ps`` pages) and the same columns."""
    n, h, pmax = 8, 4, 640 // ps
    lp = pmax * ps
    steps = [lp - w, 0, 0, lp - w, 300, 62, 200, 450]
    pads = [0, 0, 0, 0, 0, 0, 37, 151]
    q, pk, pv, bt, st, vc = paged_case(n, h, w, d, ps, pmax, dtype, seed,
                                       steps=steps, pads=pads)
    vc[0, 64:] = 0                        # readable in its first columns
    bt[2] = pk.shape[0] - 1               # parked on the sentinel page
    vc[2] = 0
    vc[3] = 0
    vc[4] = 0
    vc[4, 300 + w - 1] = 1                # only the last query reads
    return q, pk, pv, bt, st, vc.contiguous()


def paged_split_checks(torch, pa, d=128, ps=PAGE, modes=(None, "int8",
                                                           "fp8")):
    """The split page walk and its in-launch merge against the plain
    version on `split_case`'s rows at head dim ``d`` and page size
    ``ps``: W 1, 3 and 5; float pages (f32 q and pages at TOL_F32, bf16
    at TOL_BF16_OUT / TOL_BF16_LSE) and the 1-byte ``modes`` (q f32 and
    bf16). Each line names the split count."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for w in (1, 3, 5):
        for mode in modes:
            for dtype in (torch.float32, torch.bfloat16):
                args = split_case(torch, w, dtype, seed=700 + w, d=d, ps=ps)
                kw = {}
                if mode is not None:
                    args, kw = quantize_case(torch, args, mode)
                out, lse = pa.fused_paged_attention(*args, **kw)
                ref, ref_lse = pa.paged_attention_reference(*args, **kw)
                torch.cuda.synchronize()
                f32 = dtype == torch.float32
                torch.testing.assert_close(
                    out.float(), ref.float(),
                    **(TOL_F32 if f32 else TOL_BF16_OUT))
                torch.testing.assert_close(
                    lse, ref_lse, **(TOL_F32 if f32 else TOL_BF16_LSE))
                check(torch.isfinite(out.float()).all().item(),
                      "non-finite out")
                n, h = args[0].shape[:2]
                splits, pps = pa.plan_splits(n, h, w, args[3].shape[1], ps,
                                             sms, d)
                err_o = (out.float() - ref.float()).abs().max().item()
                err_l = (lse - ref_lse).abs().max().item()
                print(f"  paged split cases D={d} ps={ps} W={w} "
                      f"{mode or 'float'} pages q {str(dtype)[6:]}: "
                      f"{splits} splits of {pps} pages; "
                      f"max|out-ref| {err_o:.3e}  max|lse-ref| {err_l:.3e}"
                      "  ok")


def split_plan_line(pa, n, h, w, pmax, d, ps=PAGE):
    """The kernel's split count and the blocks one call launches."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, pps = pa.plan_splits(n, h, w, pmax, ps, sms, d)
    blocks = n * h * -(-w // pa.query_tile(w, d)) * splits
    return (f"{splits} splits of {pps} pages, {blocks} blocks on {sms} "
            "SMs")


def kernel_phase(torch, pa):
    """The paged kernel against its plain version on the card, then its
    time at the engine's decode shape: bf16, int8 and fp8 pages, at W=1
    (a decode step) and W=5 (a k=4 verify window). Returns the records
    of the float, int8 and fp8 kernels (float at W=1, the quantized
    ones at W=5, as their main paths run them)."""
    paged_checks(torch, pa)
    paged_split_checks(torch, pa)
    arms = (("bf16", 1), ("int8", 1), ("fp8", 1), ("bf16", 5), ("int8", 5),
            ("fp8", 5), *(("bf16", w) for w in VERIFY_WIDTHS if w != 5))
    timed = decode_shape_times(torch, pa, 16, 128, arms)
    records = []
    for pages, w in (("bf16", 1), ("int8", 5), ("fp8", 5)):
        name = "paged_attention" + ("" if pages == "bf16" else "_" + pages)
        records.append({"name": name, **timed[pages, w]})
    # bf16 pages at the verify widths of phase 18's adaptive rungs
    for w in VERIFY_WIDTHS:
        records.append({"name": f"paged_attention_w{w}", **timed["bf16", w]})
    return records


def decode_shape_times(torch, pa, h, d, arms, ps=PAGE, pmax=None,
                       steps=None, pads=None):
    """The paged kernel at a serving model's decode shape (8 slots x ``h``
    heads of ``d``, bf16 q; by default 40 pages of 16 per slot: max_len
    640, each slot 16 tokens into decode after a prompt from PROMPT_LENS
    in its bucket), for each ``(pages, w)`` of ``arms`` (pages "bf16",
    "int8" or "fp8"): bf16 out against the plain version at
    TOL_BF16_OUT_DECODE and the same inputs in float32 at TOL_F32, then
    its time beside the plain version's, SDPA over the gathered view
    (1-byte pages dequantized beforehand) and the bound. Returns
    ``{(pages, w): record}`` without names."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.paged_kv import gather_pages, gather_scales

    n = SLOTS if steps is None else len(steps)
    if pmax is None:
        pmax = MAX_LEN // ps
        buckets = [min(b for b in BUCKETS if b >= p) for p in PROMPT_LENS[:n]]
        steps = [b + 16 for b in buckets]
        pads = [b - p for b, p in zip(buckets, PROMPT_LENS[:n])]
    records = {}
    lp = pmax * ps
    for pages, w in arms:
        quant = pages != "bf16"
        cases = []
        for i in range(4):              # 4 x 21-42 MB of pools > the L2
            args = paged_case(n, h, w, d, ps, pmax, torch.bfloat16,
                              seed=i, steps=steps, pads=pads)
            cases.append(quantize_case(torch, args, pages) if quant
                         else (args, {}))
        args, kw = cases[0]
        out, _ = pa.fused_paged_attention(*args, **kw)
        ref, _ = pa.paged_attention_reference(*args, **kw)
        # the same inputs before their rounding to bf16, in float32
        args32 = paged_case(n, h, w, d, ps, pmax, torch.float32, seed=0,
                            steps=steps, pads=pads)
        kw32 = {}
        if quant:
            args32, kw32 = quantize_case(torch, args32, pages)
        out32, lse32 = pa.fused_paged_attention(*args32, **kw32)
        ref32, ref_lse32 = pa.paged_attention_reference(*args32, **kw32)
        torch.cuda.synchronize()
        max_err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(),
                                   **TOL_BF16_OUT_DECODE)
        torch.testing.assert_close(out32, ref32, **TOL_F32)
        torch.testing.assert_close(lse32, ref_lse32, **TOL_F32)
        err32 = max((out32 - ref32).abs().max().item(),
                    (lse32 - ref_lse32).abs().max().item())
        it = iter(range(10 ** 9))

        def kernel():
            a, k = cases[next(it) % 4]
            pa.fused_paged_attention(*a, **k)

        ms = time_ms(kernel, 200)
        plain_ms = time_ms(lambda: pa.paged_attention_reference(*args, **kw),
                           20)
        # library: SDPA over the gathered view, dequantized beforehand
        dense = []
        for (q, pk, pv, bt, st, vc), k in cases:
            cols = torch.arange(lp, device="cuda")
            cur = st.long()[:, None] + torch.arange(w, device="cuda")
            mask = ((cols[None, None, :] <= cur[:, :, None])
                    & (vc != 0)[:, None, :])[:, None]
            vk, vv = gather_pages(pk, bt), gather_pages(pv, bt)
            if quant:
                vk = vk.float() * gather_scales(k["k_scale"], bt)[..., None]
                vv = vv.float() * gather_scales(k["v_scale"], bt)[..., None]
            dense.append((q, vk.to(q.dtype), vv.to(q.dtype), mask))

        def library():
            q, k, v, m = dense[next(it) % 4]
            F.scaled_dot_product_attention(q, k, v, attn_mask=m)

        library_ms = time_ms(library, 200)
        nbytes, flops = paged_work(*args[3:], w=w, h=h, d=d, el=2,
                                   page_el=1 if quant else 2, ps=ps)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        print(f"  decode shape N={n} H={h} W={w} D={d} ps={ps} Pmax={pmax} "
              f"{pages} pages, bf16 q, steps {steps}, pads {pads}: bf16 "
              f"max|out-ref| {max_err:.3e} (atol "
              f"{TOL_BF16_OUT_DECODE['atol']}), float32 max|out/lse-ref| "
              f"{err32:.3e} (atol {TOL_F32['atol']}); kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, SDPA over the "
              f"{'pre-dequantized ' if quant else ''}gathered view "
              f"{library_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} "
              f"bytes, {flops} flops); "
              f"{split_plan_line(pa, n, h, w, pmax, d, ps)}")
        records[pages, w] = {
            "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:120",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}
    return records


def paged_head_dim_checks(torch, pa):
    """The paged kernel at head dims that are not 64 or 128 (gpt3-2.7b's
    80, gpt-test's 16) and page sizes that are not multiples of 8, the
    pools at the model's D: `paged_checks`' rows (ragged steps, left
    pads, a fully masked row, a parked row) at D 80 and 16, ps 16, 4 and
    3, W 1 and 5, float pages (f32, bf16) and int8 pages (q f32, bf16);
    `paged_split_checks`' rows at D=80 for each page size (float and
    int8 pages); the tail read at D=80, bf16 and int8 pages. Then its
    time at gpt3-2.7b's decode shape (N=8, H=32, D=80, ps=16, Pmax=40):
    W=1 on bf16 and int8 pages, W=5 on int8; and at gpt-test's heads on
    4-column pages (N=8, H=4, D=16, ps=4, Pmax=16, bf16). Returns the
    bf16 W=1 and the int8 W=5 arms (the two pools phase 12 serves)."""
    cases = [(d, ps, w, dtype, mode) for d in (80, 16) for ps in (16, 4, 3)
             for w in (1, 5) for mode in (None, "int8")
             for dtype in (torch.float32, torch.bfloat16)]
    for d, ps, w, dtype, mode in cases:
        args = paged_case(6, 8, w, d, ps, 8 * 16 // ps, dtype,
                          seed=900 + d + ps + w)
        kw = {}
        if mode is not None:
            args, kw = quantize_case(torch, args, mode)
        out, lse = pa.fused_paged_attention(*args, **kw)
        ref, ref_lse = pa.paged_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        torch.testing.assert_close(out.float(), ref.float(),
                                   **(TOL_F32 if f32 else TOL_BF16_OUT))
        torch.testing.assert_close(lse, ref_lse,
                                   **(TOL_F32 if f32 else TOL_BF16_LSE))
        check(torch.isfinite(out.float()).all().item(), "non-finite out")
        print(f"  paged_attention {mode or 'float'} pages D={d} ps={ps} q "
              f"{str(dtype)[6:]} W={w}: max|out-ref| "
              f"{(out.float() - ref.float()).abs().max().item():.3e}  "
              f"max|lse-ref| {(lse - ref_lse).abs().max().item():.3e}  ok")
    for ps in (16, 4, 3):
        paged_split_checks(torch, pa, d=80, ps=ps, modes=(None, "int8"))
    n, h, d, pg = 8, 32, 80, 8
    for pages in ("bf16", "int8"):
        for dtype in (torch.bfloat16, torch.float32):
            q, pk, pv, bt = tail_case(torch, n, h, d, pg, dtype, seed=5)
            kw = {}
            if pages == "int8":
                (_, pk, pv, _, _, _), kw = quantize_case(
                    torch, (None, pk, pv, None, None, None), pages)
            out, lse = pa.paged_tail_segment(q, pk, pv, bt, 100, d, **kw)
            ref, ref_lse = pa.paged_tail_segment(
                q.cpu(), pk.cpu(), pv.cpu(), bt.cpu(), 100, d,
                **{k: v.cpu() for k, v in kw.items()})
            f32 = dtype == torch.float32
            torch.testing.assert_close(out.float().cpu(), ref.float(),
                                       **(TOL_F32 if f32
                                          else TOL_BF16_OUT_TAIL))
            torch.testing.assert_close(lse.cpu(), ref_lse,
                                       **(TOL_F32 if f32 else TOL_BF16_LSE))
            print(f"  paged_tail_segment N={n} H={h} D={d} Pg={pg} {pages} "
                  f"pages q {str(dtype)[6:]}, gen column 100: max|out-ref| "
                  f"{(out.float().cpu() - ref.float()).abs().max().item():.3e}"
                  "  ok")
    timed = decode_shape_times(torch, pa, 32, 80, (("bf16", 1), ("int8", 1),
                                                   ("int8", 5)))
    # gpt-test's heads (4 of 16) on 4-column pages: max_len 64, every
    # slot a few tokens past a prompt of up to 40 (a toy shape: the
    # launch sets it)
    decode_shape_times(torch, pa, 4, 16, (("bf16", 1),), ps=4, pmax=16,
                       steps=[44, 30, 51, 23, 40, 60, 35, 47],
                       pads=[3, 0, 10, 5, 0, 17, 2, 8])
    return [{"name": "paged_attention_d80", **timed["bf16", 1]},
            {"name": "paged_attention_int8_d80", **timed["int8", 5]}]


def wide_head_paged_checks(torch, pa):
    """B3 at head dims above 256 (width 512, 2-query tiles): D 320 and
    512, the pools at D. `paged_checks`' rows (ragged steps, left pads, a
    fully masked row, a parked row) at ps 16 and 4, W 1 and 5, float
    pages (f32, bf16) and int8 pages (q f32, bf16); `paged_split_checks`'
    rows at each page size (float and int8 pages); the tail read, bf16
    and int8 pages. Then its time at a decode shape of 8 slots x 2560
    hidden (8 heads of 320, or 5 of 512), 40 pages of 16 a slot: bf16
    pages at W 1 and 5, int8 at W 5. The records' launches are set in
    `main` from the main paths' width-512 counts."""
    for d in WIDE_HEAD_DIMS:
        for ps in (16, 4):
            for w in (1, 5):
                for mode in (None, "int8"):
                    for dtype in (torch.float32, torch.bfloat16):
                        args = paged_case(6, 4, w, d, ps, 8 * 16 // ps,
                                          dtype, seed=1300 + d + ps + w)
                        kw = {}
                        if mode is not None:
                            args, kw = quantize_case(torch, args, mode)
                        out, lse = pa.fused_paged_attention(*args, **kw)
                        ref, ref_lse = pa.paged_attention_reference(*args,
                                                                    **kw)
                        torch.cuda.synchronize()
                        f32 = dtype == torch.float32
                        torch.testing.assert_close(
                            out.float(), ref.float(),
                            **(TOL_F32 if f32 else TOL_BF16_OUT))
                        torch.testing.assert_close(
                            lse, ref_lse,
                            **(TOL_F32 if f32 else TOL_BF16_LSE))
                        check(torch.isfinite(out.float()).all().item(),
                              "non-finite out")
                        err_o = (out.float() - ref.float()).abs().max()
                        err_l = (lse - ref_lse).abs().max()
                        print(f"  paged_attention {mode or 'float'} pages "
                              f"D={d} ps={ps} q {str(dtype)[6:]} W={w}: "
                              f"max|out-ref| {err_o.item():.3e}  "
                              f"max|lse-ref| {err_l.item():.3e}  ok")
            paged_split_checks(torch, pa, d=d, ps=ps, modes=(None, "int8"))
        for pages in ("bf16", "int8"):
            q, pk, pv, bt = tail_case(torch, 8, 4, d, 8, torch.bfloat16,
                                      seed=d)
            kw = {}
            if pages == "int8":
                (_, pk, pv, _, _, _), kw = quantize_case(
                    torch, (None, pk, pv, None, None, None), pages)
            out, lse = pa.paged_tail_segment(q, pk, pv, bt, 100, d, **kw)
            ref, ref_lse = pa.paged_tail_segment(
                q.cpu(), pk.cpu(), pv.cpu(), bt.cpu(), 100, d,
                **{k: v.cpu() for k, v in kw.items()})
            torch.testing.assert_close(out.float().cpu(), ref.float(),
                                       **TOL_BF16_OUT_TAIL)
            torch.testing.assert_close(lse.cpu(), ref_lse, **TOL_BF16_LSE)
            print(f"  paged_tail_segment N=8 H=4 D={d} Pg=8 {pages} pages "
                  f"q bfloat16, gen column 100: max|out-ref| "
                  f"{(out.float().cpu() - ref.float()).abs().max().item():.3e}"
                  "  ok")
    records = []
    for d in WIDE_HEAD_DIMS:
        arms = (("bf16", 1), ("bf16", 5), ("int8", 5))
        timed = decode_shape_times(torch, pa, 2560 // d, d, arms)
        for pages, w in arms:
            records.append({"name": f"paged_attention_{pages}_d{d}_w{w}",
                            **timed[pages, w]})
    return records


def tail_case(torch, n, h, d, pg, dtype, seed):
    """Inputs of one beam tail read on the card: ``q [n, h, d]`` and two
    pools of ``n * pg`` pages (PAGE columns each) under a shuffled block
    table, as the paged beam lays out ``n = B*K`` beams."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool_k, pool_v = (torch.randn((n * pg, h, PAGE, d), generator=g,
                                  device="cuda").to(dtype) for _ in range(2))
    bt = torch.randperm(n * pg, generator=g, device="cuda").reshape(
        n, pg).to(torch.int32)
    q = torch.randn((n, h, d), generator=g, device="cuda").to(dtype)
    return q, pool_k, pool_v, bt


def tail_kernel_phase(torch, pa):
    """The beam's tail read (`paged_tail_segment`: the paged kernel at
    W=1, one cursor for every row, all columns valid) at phase 10's beam
    shape: N = 8 x 4 beams, H=16, D=128, ps=16, Pg=8 (127 gen columns).
    On bf16 and int8 pages, at gen column 127 (a full tail) and 40 (mid
    page), its ``(out, lse)`` against the plain version (bf16 out at
    TOL_BF16_OUT_TAIL, the same inputs in float32 at TOL_F32); then
    its time at gen column 127 beside the plain version's, SDPA over the
    gathered tail view (int8 pages dequantized beforehand) and its
    bound. Returns the bf16 record."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.paged_kv import (gather_pages,
                                                   gather_scales)

    n, h, d, pg = GEN_B * GEN_BEAMS, 16, 128, 8
    record = None
    for pages in ("bf16", "int8"):
        quant = pages == "int8"
        for j in (127, 40):
            cases = []
            for i in range(4):              # 4 x 33.5 MB of bf16 pools > L2
                args = tail_case(torch, n, h, d, pg, torch.bfloat16, seed=i)
                kw = {}
                if quant:
                    (_, pk, pv, _, _, _), kw = quantize_case(
                        torch, (None, *args[1:3], None, None, None), pages)
                    args = (args[0], pk, pv, args[3])
                cases.append((args, kw))
            args, kw = cases[0]
            out, lse = pa.paged_tail_segment(*args, j, d, **kw)
            ref, ref_lse = pa.paged_tail_segment(
                *(a.cpu() for a in args), j, d,
                **{k: v.cpu() for k, v in kw.items()})
            a32 = tail_case(torch, n, h, d, pg, torch.float32, seed=0)
            kw32 = {}
            if quant:
                (_, pk, pv, _, _, _), kw32 = quantize_case(
                    torch, (None, *a32[1:3], None, None, None), pages)
                a32 = (a32[0], pk, pv, a32[3])
            out32, lse32 = pa.paged_tail_segment(*a32, j, d, **kw32)
            ref32, ref_lse32 = pa.paged_tail_segment(
                *(a.cpu() for a in a32), j, d,
                **{k: v.cpu() for k, v in kw32.items()})
            torch.cuda.synchronize()
            max_err = (out.float().cpu() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float().cpu(), ref.float(),
                                       **TOL_BF16_OUT_TAIL)
            torch.testing.assert_close(lse.cpu(), ref_lse, **TOL_BF16_LSE)
            torch.testing.assert_close(out32.cpu(), ref32, **TOL_F32)
            torch.testing.assert_close(lse32.cpu(), ref_lse32, **TOL_F32)
            err32 = max((out32.cpu() - ref32).abs().max().item(),
                        (lse32.cpu() - ref_lse32).abs().max().item())
            line = (f"  paged_tail_segment N={n} H={h} D={d} ps={PAGE} "
                    f"Pg={pg} {pages} pages, gen column {j}: bf16 "
                    f"max|out-ref| {max_err:.3e} ({TOL_BF16_OUT_TAIL}), "
                    f"float32 max|out/lse-ref| {err32:.3e}")
            if j != 127:
                print(line + "  ok")
                continue
            it = iter(range(10 ** 9))

            def kernel():
                a, k = cases[next(it) % 4]
                pa.paged_tail_segment(*a, j, d, **k)

            ms = time_ms(kernel, 200)
            steps = torch.full((n,), j, dtype=torch.int32, device="cuda")
            vc = torch.ones((n, pg * PAGE), dtype=torch.int32, device="cuda")
            q4 = args[0][:, :, None, :]
            plain_ms = time_ms(lambda: pa.paged_attention_reference(
                q4, args[1], args[2], args[3], steps, vc, **kw), 20)
            dense = []
            for (q, pk, pv, bt), k in cases:
                vk, vv = gather_pages(pk, bt), gather_pages(pv, bt)
                if quant:
                    vk = vk.float() * gather_scales(k["k_scale"], bt)[..., None]
                    vv = vv.float() * gather_scales(k["v_scale"], bt)[..., None]
                dense.append((q[:, :, None, :], vk.to(q.dtype),
                              vv.to(q.dtype)))

            def library():
                q, k, v = dense[next(it) % 4]
                F.scaled_dot_product_attention(q, k, v)

            library_ms = time_ms(library, 200)
            nbytes, flops = paged_work(args[3], steps, vc, w=1, h=h, d=d,
                                       el=2, page_el=1 if quant else 2)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            print(f"{line}; kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
                  f"SDPA over the {'pre-dequantized ' if quant else ''}"
                  f"gathered tail {library_ms:.5f} ms, bound {bound_ms:.5f} "
                  f"ms ({nbytes} bytes, {flops} flops); "
                  f"{split_plan_line(pa, n, h, 1, pg, d)}")
            if not quant:
                record = {
                    "name": "paged_tail_segment", "route": "cuda",
                    "source": "paddle_tpu_torch/kernels/csrc/"
                              "paged_attention.cu",
                    "replaces": "paddle_tpu/kernels/paged_attention.py:308",
                    "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms}
    return record


#: phase 3's B3 rows beyond a float pool of q's own dtype, as (q dtype,
#: page dtype): float16 on both sides, float pages of a dtype other than
#: q's, float16 q over 1-byte pages
PAGED_DTYPE_PAIRS = (("float16", "float16"), ("bfloat16", "float32"),
                     ("bfloat16", "float16"), ("float16", "bfloat16"),
                     ("float16", "float32"), ("float32", "bfloat16"),
                     ("float32", "float16"), ("float16", "int8"),
                     ("float16", "fp8"))
SHORT_DTYPES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
                "int8": "int8", "fp8": "fp8"}


def dtype_case(torch, args, q_dt, pages):
    """A float32 paged case (`paged_case`, `split_case`) with q cast to
    ``q_dt`` and the pools to ``pages`` (a float dtype name, or "int8" /
    "fp8": quantized as the engine writes them). Returns ``(args,
    kwargs)``."""
    if pages in QUANT_DTYPES:
        args, kw = quantize_case(torch, args, pages)
    else:
        dt = getattr(torch, pages)
        args, kw = (args[0], args[1].to(dt), args[2].to(dt), *args[3:]), {}
    return (args[0].to(q_dt), *args[1:]), kw


def paged_dtype_held(torch, out, ref, lse, ref_lse, d):
    """The kernel's ``(out, lse)`` against the plain version's: a 16-bit
    out within 8 ulps of its dtype at each element's scale
    (`flash_ulps`, as phase 27a holds float16), a float32 out and lse
    at TOL_F32 (both widen the same page values to f32). Returns the
    largest |out - ref| and the reading (ulps or abs)."""
    check(torch.isfinite(out.float()).all().item(), "non-finite out")
    torch.testing.assert_close(lse, ref_lse, **TOL_F32)
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, **TOL_F32)
        return err, f"max|out-ref| {err:.3e}"
    ulps, _ = flash_ulps(out, ref, d)
    check(ulps <= 8, f"paged out {ulps:.2f} ulps from the plain version")
    return err, (f"max|out-ref| {err:.3e} ({ulps:.2f} "
                 f"{str(out.dtype)[6:]} ulps)")


def paged_dtype_phase(torch, pa):
    """B3 at the query-page pairs of PAGED_DTYPE_PAIRS, against
    its plain version: `paged_case`'s ragged rows (a fully masked row, a
    parked one) at D 128 and 80, page sizes 16 and 4, W 1 and 5;
    `split_case`'s split-walk rows at W 1 and 5; the beam tail read on
    float16 pages; then at the engine's decode shape (N8 H16 D128 ps16
    Pmax40, as `decode_shape_times`) the kernel's time beside the plain
    version's, SDPA over the gathered view in q's dtype (1-byte pages
    dequantized beforehand) and the bound, W 1 and 5. Returns one record
    a pair and width, named ``paged_attention_<q>_<pages>_w<W>``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.paged_kv import gather_pages, gather_scales

    for q_name, pages in PAGED_DTYPE_PAIRS:
        q_dt = getattr(torch, q_name)
        label = f"q {SHORT_DTYPES[q_name]} {SHORT_DTYPES[pages]} pages"
        for d, ps in ((128, 16), (80, 4)):
            for w in (1, 5):
                args, kw = dtype_case(torch, paged_case(
                    6, 8, w, d, ps, 8, torch.float32, seed=900 + d + w + ps),
                    q_dt, pages)
                out, lse = pa.fused_paged_attention(*args, **kw)
                ref, ref_lse = pa.paged_attention_reference(*args, **kw)
                torch.cuda.synchronize()
                line = paged_dtype_held(torch, out, ref, lse, ref_lse, d)[1]
                print(f"  paged_attention {label} D={d} ps={ps} W={w}: "
                      f"{line}  ok")
        for w in (1, 5):
            args, kw = dtype_case(torch, split_case(torch, w, torch.float32,
                                                    seed=950 + w), q_dt, pages)
            out, lse = pa.fused_paged_attention(*args, **kw)
            ref, ref_lse = pa.paged_attention_reference(*args, **kw)
            torch.cuda.synchronize()
            line = paged_dtype_held(torch, out, ref, lse, ref_lse, 128)[1]
            print(f"  paged split cases {label} W={w}: "
                  f"{split_plan_line(pa, 8, 4, w, 40, 128)}; {line}  ok")

    # the beam tail read on float16 pages under float16 queries
    n, h, d, pg = GEN_B * GEN_BEAMS, 16, 128, 8
    for j in (127, 40):
        args = tail_case(torch, n, h, d, pg, torch.float16, seed=5)
        out, lse = pa.paged_tail_segment(*args, j, d)
        ref, ref_lse = pa.paged_tail_segment(*(a.cpu() for a in args), j, d)
        torch.cuda.synchronize()
        line = paged_dtype_held(torch, out.cpu(), ref, lse.cpu(), ref_lse,
                                d)[1]
        print(f"  paged_tail_segment N={n} H={h} D={d} Pg={pg} f16 q and "
              f"pages, gen column {j}: {line}  ok")

    n, h, d = SLOTS, 16, 128
    pmax = MAX_LEN // PAGE
    buckets = [min(b for b in BUCKETS if b >= p) for p in PROMPT_LENS[:n]]
    steps = [b + 16 for b in buckets]
    pads = [b - p for b, p in zip(buckets, PROMPT_LENS[:n])]
    lp = pmax * PAGE
    records = []
    for q_name, pages in PAGED_DTYPE_PAIRS:
        q_dt = getattr(torch, q_name)
        quant = pages in QUANT_DTYPES
        for w in (1, 5):
            cases = [dtype_case(torch, paged_case(
                n, h, w, d, PAGE, pmax, torch.float32, seed=i, steps=steps,
                pads=pads), q_dt, pages) for i in range(4)]
            args, kw = cases[0]
            out, lse = pa.fused_paged_attention(*args, **kw)
            ref, ref_lse = pa.paged_attention_reference(*args, **kw)
            torch.cuda.synchronize()
            max_err, line = paged_dtype_held(torch, out, ref, lse, ref_lse, d)
            it = iter(range(10 ** 9))

            def kernel():
                a, k = cases[next(it) % 4]
                pa.fused_paged_attention(*a, **k)

            ms = time_ms(kernel, 200)
            plain_ms = time_ms(
                lambda: pa.paged_attention_reference(*args, **kw), 5, 1)
            dense = []
            for (q, pk, pv, bt, st, vc), k in cases:
                cols = torch.arange(lp, device="cuda")
                cur = st.long()[:, None] + torch.arange(w, device="cuda")
                mask = ((cols[None, None, :] <= cur[:, :, None])
                        & (vc != 0)[:, None, :])[:, None]
                vk, vv = gather_pages(pk, bt), gather_pages(pv, bt)
                if quant:
                    vk = vk.float() * gather_scales(k["k_scale"],
                                                    bt)[..., None]
                    vv = vv.float() * gather_scales(k["v_scale"],
                                                    bt)[..., None]
                dense.append((q, vk.to(q.dtype), vv.to(q.dtype), mask))

            def library():
                q, k, v, m = dense[next(it) % 4]
                F.scaled_dot_product_attention(q, k, v, attn_mask=m)

            library_ms = time_ms(library, 200)
            page_el = 1 if quant else getattr(torch, pages).itemsize
            nbytes, flops = paged_work(*args[3:], w=w, h=h, d=d,
                                       el=q_dt.itemsize, page_el=page_el)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            name = (f"paged_attention_{SHORT_DTYPES[q_name]}_"
                    f"{SHORT_DTYPES[pages]}_w{w}")
            print(f"  {name}: decode shape N={n} H={h} W={w} D={d} ps={PAGE} "
                  f"Pmax={pmax}: {line}; kernel {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, SDPA over the "
                  f"{'pre-dequantized ' if quant else ''}gathered view in "
                  f"{q_name} {library_ms:.5f} ms, bound {bound_ms:.5f} ms "
                  f"({nbytes} bytes, {flops} flops)")
            records.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
                "replaces": "paddle_tpu/kernels/paged_attention.py:120",
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms})
    return records


def ulp_unit(dtype):
    """One ulp of a value of scale 1 in a 16-bit ``dtype``, as these
    checks count it: 2^-8 in bfloat16 (7 stored mantissa bits), 2^-11 in
    float16 (10)."""
    return 2.0 ** -11 if str(dtype) == "torch.float16" else 2.0 ** -8


def flash_ulps(x, ref, d):
    """``|x - ref|`` of each element in ulps of ``ref``'s 16-bit dtype
    (`ulp_unit`: bf16 2^-8, fp16 2^-11) of its scale: the largest of its
    own ``|ref|``, the rms of its row (one head's ``d`` values at one
    position, which all sum the same rounded products) and
    FLASH_SCALE_FLOOR x the tensor's rms. Returns the largest reading and
    the mean ``|ref|`` (the typical value)."""
    r = ref.float().reshape(-1, d)
    ulps = (x.float().reshape(-1, d) - r).abs() / flash_ulp(
        r, ulp_unit(ref.dtype))
    return ulps.max().item(), r.abs().mean().item()


def flash_ulp(r, unit=2.0 ** -8):
    """One ulp (``unit``, default bf16's 2^-8) of the scale of each
    element of ``r`` (rows of one head's ``d`` values, float32): the
    largest of its own ``|r|``, its row's rms and FLASH_SCALE_FLOOR x the
    tensor's rms."""
    import torch

    scale = torch.maximum(r.abs(),
                          r.square().mean(dim=1, keepdim=True).sqrt())
    scale = scale.clamp(min=FLASH_SCALE_FLOOR * r.square().mean().sqrt()
                        .item())
    return scale * unit


def flash_case(b, s, h, d, dtype, seed):
    """``(qkv [b, s, 3hd], do [b, s, hd])`` of standard normals on the
    card, in ``dtype``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda")
    do = torch.randn((b, s, h * d), generator=g, device="cuda")
    return qkv.to(dtype), do.to(dtype)


def qkv_fns(fa, layout):
    """``(kernel fwd, plain fwd, kernel bwd, plain bwd)`` of the qkv flash
    kernels of one layout: "pair" (B1) or "which" (B5)."""
    if layout == "pair":
        return (fa.flash_attention_qkv_fwd, fa.flash_qkv_reference,
                fa.flash_attention_qkv_bwd, fa.flash_qkv_bwd_reference)
    return (fa.flash_attention_qkv3_fwd, fa.flash_qkv3_reference,
            fa.flash_attention_qkv3_bwd, fa.flash_qkv3_bwd_reference)


def flash_compare(torch, fns, qkv, do, h, causal, p, seed_t):
    """Both qkv flash kernels of one layout (`qkv_fns`) against their
    plain versions on one input. The backward of each gets the plain
    forward's ``o`` and ``lse``, so it is compared on the same inputs.
    lse (float32 math in both) is held to TOL_F32; so are o and dqkv in
    float32. In bfloat16, o and dqkv are held to BF16_ULPS_O /
    BF16_ULPS_DQKV of each element's scale (`flash_ulps`), and beside
    that reading stands a control: how far bf16 rounding alone moves the
    plain version (its float32 run on the same inputs against its bf16
    run). Returns the errors, a line of the readings and the kernels'
    ``(o, lse, dqkv)``."""
    kernel_fwd, plain_fwd, kernel_bwd, plain_bwd = fns
    d = qkv.shape[-1] // (3 * h)
    o, lse = kernel_fwd(qkv, h, causal, p, seed_t)
    ro, rlse = plain_fwd(qkv, h, causal, p, seed_t)
    dqkv = kernel_bwd(qkv, do, ro, rlse, h, causal, p, seed_t)
    rdqkv = plain_bwd(qkv, do, ro, rlse, h, causal, p, seed_t)
    torch.cuda.synchronize()
    err = {"o": (o.float() - ro.float()).abs().max().item(),
           "dqkv": (dqkv.float() - rdqkv.float()).abs().max().item()}
    torch.testing.assert_close(lse, rlse, **TOL_F32)
    line = f"max|lse-ref| {(lse - rlse).abs().max().item():.3e}"
    outs = (o, lse, dqkv)
    if qkv.dtype == torch.float32:
        torch.testing.assert_close(o, ro, **TOL_F32)
        torch.testing.assert_close(dqkv, rdqkv, **TOL_F32)
        return err, (f"max|o-ref| {err['o']:.3e}, {line}, max|dqkv-ref| "
                     f"{err['dqkv']:.3e} (atol {TOL_F32['atol']})"), outs
    ctrl_o, _ = plain_fwd(qkv.float(), h, causal, p, seed_t)
    ctrl_d = plain_bwd(qkv.float(), do.float(), ro.float(), rlse, h, causal,
                       p, seed_t)
    parts = [line]
    for name, x, ref, ctrl, limit in (("o", o, ro, ctrl_o, BF16_ULPS_O),
                                      ("dqkv", dqkv, rdqkv, ctrl_d,
                                       BF16_ULPS_DQKV)):
        ulps, typical = flash_ulps(x, ref, d)
        ctrl_ulps, _ = flash_ulps(ctrl, ref, d)
        reading = (f"{name}: max|diff| {err[name]:.3e}, {ulps:.3f} ulps of "
                   f"its scale (limit {limit}; {str(qkv.dtype)[6:]} "
                   f"rounding control "
                   f"{ctrl_ulps:.3f}; mean|ref| {typical:.3e})")
        check(ulps <= limit, f"flash {reading}")
        parts.append(reading)
    return err, "; ".join(parts), outs


def grads_agree(torch, what, mine, theirs, d):
    """``(dq, dk, dv)`` of the one backward kernel read through two
    layouts: dk and dv bit for bit, and dq too in float32; in bfloat16
    dq sums its key blocks by atomics in an order that varies, so it is
    held to BF16_ULPS_DQKV of each element's scale (`flash_ulps`).
    Returns the reading."""
    check(torch.equal(mine[1], theirs[1]) and torch.equal(mine[2], theirs[2]),
          f"{what}: dk or dv differs")
    if mine[0].dtype == torch.float32:
        check(torch.equal(mine[0], theirs[0]), f"{what}: dq differs")
        return "dq, dk, dv bitwise"
    ulps, _ = flash_ulps(mine[0], theirs[0], d)
    check(ulps <= BF16_ULPS_DQKV, f"{what}: dq {ulps:.3f} ulps apart (limit "
          f"{BF16_ULPS_DQKV})")
    return f"dk, dv bitwise, dq {ulps:.3f} ulps apart (limit {BF16_ULPS_DQKV})"


def qkv_against_general(torch, fa, qkv, do, h, causal):
    """B1's backward on the pair-major ``qkv`` against B2's
    (`flash_attention_bwd`) on its three unpacked views, at p=0, both
    given the plain forward's o and lse: one kernel at other columns
    (`grads_agree`). Returns a line of the readings."""
    from paddle_tpu_torch.models.gpt import unpack_qkv_pair_major

    b, s, hd3 = qkv.shape
    d = hd3 // (3 * h)
    o, lse = fa.flash_qkv_reference(qkv, h, causal)
    dqkv = fa.flash_attention_qkv_bwd(qkv, do, o, lse, h, causal)
    views = [t.contiguous() for t in unpack_qkv_pair_major(qkv, h, d)]
    grads = fa.flash_attention_bwd(*views, o.reshape(b, s, h, d), lse,
                                   do.reshape(b, s, h, d), causal)
    torch.cuda.synchronize()
    label = "B1's backward against B2's on the unpacked views"
    return label + ": " + grads_agree(
        torch, f"{label}, D={d} {str(qkv.dtype)[6:]} causal={causal}",
        unpack_qkv_pair_major(dqkv, h, d), grads, d)


def flash_kernel_phase(torch):
    """Flash kernels (rows 6-7) against their plain versions on the card,
    f32 and bf16, D 64 and 128, causal and full, dropout 0 and 0.1; at
    p=0 B1's backward also against B2's on the unpacked views
    (`qkv_against_general`). Then at the training shape (bf16, causal, no
    dropout) agreement, B1 against B2 again, and time beside the plain
    versions, SDPA over the unpacked head-major q/k/v (timed only; the
    port never calls it), the bound, and B2's forward over the unpacked
    q/k/v. Returns the forward's and the backward's records."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import unpack_qkv_pair_major

    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device="cuda")
    for d in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for p in (0.0, 0.1):
                    qkv, do = flash_case(2, 256, 4, d, dtype, seed=d + int(
                        causal) + int(10 * p))
                    _, line, _ = flash_compare(torch, qkv_fns(fa, "pair"),
                                               qkv, do, 4, causal, p,
                                               seed_t)
                    if p == 0.0:
                        line += "; " + qkv_against_general(torch, fa, qkv, do,
                                                           4, causal)
                    print(f"  flash_attention_qkv D={d} {str(dtype)[6:]} "
                          f"{'causal' if causal else 'full'} p={p}: {line}"
                          "  ok")
    # S = 320: the forward's last 128-query block holds 64 rows, so its
    # second consumer warpgroup reads no query
    for d in (64, 128):
        for causal in (True, False):
            qkv, do = flash_case(2, 320, 4, d, torch.bfloat16, seed=50 + d)
            _, line, _ = flash_compare(torch, qkv_fns(fa, "pair"), qkv, do,
                                       4, causal, 0.1, seed_t)
            print(f"  flash_attention_qkv S=320 D={d} bfloat16 "
                  f"{'causal' if causal else 'full'} p=0.1: {line}  ok")

    b, s, h, d = TRAIN_B, TRAIN_S, 16, 128
    el = 2
    # two input copies of 100 MB of qkv (+ do, o, lse) each: more than
    # the 50 MB L2
    copies = [flash_case(b, s, h, d, torch.bfloat16, seed=i) for i in (1, 2)]
    saved = [fa.flash_attention_qkv_fwd(q, h, True) for q, _ in copies]
    err, line, _ = flash_compare(torch, qkv_fns(fa, "pair"), *copies[0], h,
                                 True, 0.0, None)
    line += "; " + qkv_against_general(torch, fa, *copies[0], h, True)
    print(f"  training shape B={b} S={s} H={h} D={d} bf16 causal: {line}  ok")
    it = iter(range(10 ** 9))

    def fwd():
        fa.flash_attention_qkv_fwd(copies[next(it) % 2][0], h, True)

    def bwd():
        i = next(it) % 2
        fa.flash_attention_qkv_bwd(copies[i][0], copies[i][1], *saved[i], h,
                                   True)

    fwd_ms, bwd_ms = time_ms(fwd, 10), time_ms(bwd, 5)
    qkv, do = copies[0]
    plain_fwd = time_ms(lambda: fa.flash_qkv_reference(qkv, h, True), 3, 1)
    plain_bwd = time_ms(lambda: fa.flash_qkv_bwd_reference(
        qkv, do, *saved[0], h, True), 3, 1)
    heads = [[t.transpose(1, 2).contiguous()
              for t in unpack_qkv_pair_major(q, h, d)] for q, _ in copies]
    dos = [g.reshape(b, s, h, d).transpose(1, 2).contiguous()
           for _, g in copies]

    def lib_fwd():
        q, k, v = heads[next(it) % 2]
        F.scaled_dot_product_attention(q, k, v, is_causal=True)

    leaves = [[t.detach().requires_grad_(True) for t in hs] for hs in heads]

    def lib_fwd_bwd():
        i = next(it) % 2
        F.scaled_dot_product_attention(*leaves[i], is_causal=True).backward(
            dos[i])

    lib_f = time_ms(lib_fwd, 10)
    lib_fb = time_ms(lib_fwd_bwd, 5)
    # B2's forward over the unpacked [B, S, H, D] q/k/v: would moving
    # B1's forward onto B2's template pay (timed only)
    views = [[t.contiguous() for t in unpack_qkv_pair_major(q, h, d)]
             for q, _ in copies]
    b2_fwd = time_ms(lambda: fa.flash_attention_fwd(*views[next(it) % 2],
                                                    True), 10)
    io = b * s * h * d * el                      # one [B, S, H*D] tensor
    lse_bytes = b * h * s * 4
    attn = b * h * s * s * d // 2                # causal: half the pairs
    records = []
    for name, ms, plain, lib, nbytes, flops, line, src in (
            ("flash_attention_qkv_fwd", fwd_ms, plain_fwd, lib_f,
             3 * io + io + lse_bytes, 4 * attn, 849, "flash_attention_qkv"),
            ("flash_attention_qkv_bwd", bwd_ms, plain_bwd, lib_fb - lib_f,
             3 * io + 2 * io + lse_bytes + 3 * io, 10 * attn, 876,
             "flash_attention")):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        before = (f", before {OLD_BWD_MS['gpt']:.4f} ms (mma.sync, "
                  "PERF.md)" if name.endswith("bwd") else "")
        print(f"  {name} at B={b} S={s} H={h} D={d} bf16 causal: kernel "
              f"{ms:.4f} ms{before}, plain {plain:.4f} ms, SDPA {lib:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({nbytes} bytes, {flops} flops)")
        records.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "max_abs_err": err["o" if name.endswith("fwd") else "dqkv"],
            "ms": ms,
            "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib})
    print(f"  SDPA forward+backward {lib_fb:.4f} ms, forward {lib_f:.4f} ms "
          "(its backward alone: the difference)")
    print(f"  flash_attention_fwd (B2's forward) on the unpacked q/k/v at "
          f"the same shape: {b2_fwd:.4f} ms, beside B1's forward "
          f"{fwd_ms:.4f} ms and SDPA's {lib_f:.4f} ms")
    return records


# ------------------------------------------------- general flash (B2)
def general_case(b, s_q, s_k, h, d, dtype, seed):
    """``(q, k, v, do)`` of standard normals on the card in ``dtype``:
    q and do ``[b, s_q, h, d]``, k and v ``[b, s_k, h, d]``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((b, s_q, h, d), (b, s_k, h, d), (b, s_k, h, d), (b, s_q, h, d))
    return [torch.randn(sh, generator=g, device="cuda").to(dtype)
            for sh in shapes]


def key_padding(torch, b, s, seed, min_len=BERT_MIN_LEN):
    """A padded batch's mask: per-row lengths in [min_len, s) from
    ``seed`` (BERT's [384, 512): `benchmarks/exp_flash_mask_dropout.py:
    113-114`), as the bool ``[B, 1, 1, S]`` key-padding mask and the
    lengths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lens = torch.randint(min_len, s, (b,), generator=g, device="cuda")
    mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    return mask[:, None, None, :], lens


def general_compare(torch, fa, q, k, v, do, causal, bias, p, seed_t):
    """The B2 kernels against their plain versions on one input, as
    `flash_compare` holds B1: the backward of each gets the plain
    forward's o and lse; lse at TOL_F32; o, dq, dk, dv at TOL_F32 in
    float32 and at 8 bf16 ulps of each element's scale in bfloat16, with
    the bf16-rounding control beside. Returns ``(max |o - ref|, max
    |d(q, k, v) - ref|, line)``."""
    kw = dict(bias=bias, dropout_p=p, seed=seed_t)
    d = q.shape[-1]
    o, lse = fa.flash_attention_fwd(q, k, v, causal, **kw)
    ro, rlse = fa.flash_reference(q, k, v, causal, **kw)
    grads = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal, **kw)
    rgrads = fa.flash_bwd_reference(q, k, v, ro, rlse, do, causal, **kw)
    torch.cuda.synchronize()
    err_o = (o.float() - ro.float()).abs().max().item()
    err_g = max((a.float() - r.float()).abs().max().item()
                for a, r in zip(grads, rgrads))
    torch.testing.assert_close(lse, rlse, **TOL_F32)
    parts = [f"max|lse-ref| {(lse - rlse).abs().max().item():.3e}"]
    if q.dtype == torch.float32:
        for x, ref in zip((o, *grads), (ro, *rgrads)):
            torch.testing.assert_close(x, ref, **TOL_F32)
        parts.append(f"max|o-ref| {err_o:.3e}, max|d(q,k,v)-ref| "
                     f"{err_g:.3e} (atol {TOL_F32['atol']})")
        return err_o, err_g, "; ".join(parts)
    f32 = [t.float() for t in (q, k, v, do)]
    ctrl_o, _ = fa.flash_reference(*f32[:3], causal, **kw)
    ctrl_g = fa.flash_bwd_reference(*f32[:3], ro.float(), rlse, f32[3],
                                    causal, **kw)
    for name, x, ref, ctrl in (("o", o, ro, ctrl_o),
                               *zip(("dq", "dk", "dv"), grads, rgrads,
                                    ctrl_g)):
        ulps, typical = flash_ulps(x, ref, d)
        ctrl_ulps, _ = flash_ulps(ctrl, ref, d)
        reading = (f"{name} {ulps:.3f} ulps (control {ctrl_ulps:.3f}; "
                   f"mean|ref| {typical:.3e})")
        check(ulps <= BF16_ULPS_O, f"flash_attention {reading} over the "
              f"limit of {BF16_ULPS_O}")
        parts.append(reading)
    return err_o, err_g, "; ".join(parts)


def general_work(b, s_q, s_k, h, d, pairs, k_rows, el, bias_bytes):
    """``((bytes, flops) forward, (bytes, flops) backward)`` that the B2
    kernels need on this data: ``pairs`` visible (query, key) pairs of
    one head summed over the batch, ``k_rows`` key rows that some query
    sees (only those of k and v need reading). Forward: q, those k and v
    rows and the bias read, o and lse written; 4*D flops a pair (q.k and
    p.v). Backward: q, those k and v rows, o, dO, lse and the bias read,
    dq, dk and dv written in full; 10*D flops a pair."""
    row = h * d * el
    q_side = b * s_q * row
    kv_read = 2 * k_rows * row
    lse = b * h * s_q * 4
    fwd = (q_side + kv_read + bias_bytes + q_side + lse, 4 * d * h * pairs)
    bwd = (3 * q_side + kv_read + lse + bias_bytes + q_side
           + 2 * b * s_k * row, 10 * d * h * pairs)
    return fwd, bwd


def general_flash_phase(torch):
    """B2 kernels against their plain versions on the card, cases:
    (a) BERT-large's training shape B8 S512 H16 D64 bf16 with a
    [B,1,1,S] key-padding mask (lengths in [384, 512)) and dropout 0.1;
    (b) S=2048 H8 D128 bf16 causal with dropout 0.1, the reference's
    two-block regime (its 1024-blocks place the hash); (c) Sq=128 Sk=384
    causal with an additive [Sq, Sk] bias, f32; (d) S=200 with one fully
    masked row, f32; then the bf16 kernels' edges: (e) Sq=128 Sk=384
    causal, dropout; (f) S=200 key padding, dropout; (g) S=320 D128
    causal, dropout; (h) Sq=256 Sk=320 with a full [B,Sq,Sk] bias; (i)
    (d)'s fully masked row in bf16, D128, no dropout; then phase 21's two
    shapes at B32 H8 D64, in bf16 and f32, dropout 0 and 0.1: (j) the
    decoder's self-attention, Sq=Sk=128 under
    `Transformer.generate_square_subsequent_mask(128)` as the additive
    bias (-inf above the diagonal); (k) its cross-attention, Sq=128
    Sk=256, no mask. Then the forward and backward at (a) and at (b)
    timed beside the plain versions, SDPA (timed only; the port never
    calls it) and the bound. Returns the forward's and backward's records
    at (a)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import Transformer

    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    # phase 21's causal bias, from the layer that makes it there
    bias_j = fa.normalize_mask_bias(Transformer(
        64, 1, 1, 1, 64, device="cuda").generate_square_subsequent_mask(
            TR_TGT))
    check(bool(torch.isneginf(bias_j).any()), "the causal bias holds no -inf")
    mask_a, lens = key_padding(torch, BERT_B, BERT_S, 1)
    bias_a = fa.normalize_mask_bias(mask_a)
    g = torch.Generator(device="cuda").manual_seed(3)
    bias_c = torch.randn((128, 384), generator=g, device="cuda")[None] * 2
    mask_d = torch.ones((2, 1, 200, 200), dtype=torch.bool, device="cuda")
    mask_d[1, 0, 7] = False                       # query row 7 sees nothing
    mask_f = torch.arange(200, device="cuda")[None, :] < torch.tensor(
        [[130], [187]], device="cuda")
    bias_h = torch.randn((2, 256, 320), generator=g, device="cuda") * 2
    cases = {
        "a": ((BERT_B, BERT_S, BERT_S, 16, 64, bf), False, bias_a, 0.1),
        "b": ((2, 2048, 2048, 8, 128, bf), True, None, 0.1),
        "c": ((2, 128, 384, 4, 64, torch.float32), True, bias_c, 0.0),
        "d": ((2, 200, 200, 3, 128, torch.float32), False,
              fa.normalize_mask_bias(mask_d), 0.1),
        # bf16 edges of the TMA/wgmma kernels: Sq != Sk causal; Sk not a
        # multiple of 128 (a partial last key tile and query tile) with
        # key padding; D=128 with dropout at S=320; a full [B,Sq,Sk]
        # bias; a fully masked row at D=128 without dropout
        "e": ((2, 128, 384, 4, 64, bf), True, None, 0.1),
        "f": ((2, 200, 200, 4, 64, bf), False,
              fa.normalize_mask_bias(mask_f[:, None, None, :]), 0.1),
        "g": ((2, 320, 320, 4, 128, bf), True, None, 0.1),
        "h": ((2, 256, 320, 4, 64, bf), False, bias_h, 0.0),
        "i": ((2, 200, 200, 3, 128, bf), False,
              fa.normalize_mask_bias(mask_d), 0.0),
    }
    # phase 21's shapes: (j) the decoder's self-attention under the -inf
    # causal bias, (k) its cross-attention
    for dtype in (bf, torch.float32):
        for p in (0.0, 0.1):
            tag = f"{str(dtype)[6:]}, p={p}"
            cases[f"j {tag}"] = ((TR_B, TR_TGT, TR_TGT, 8, 64, dtype), False,
                                 bias_j, p)
            cases[f"k {tag}"] = ((TR_B, TR_TGT, TR_SRC, 8, 64, dtype), False,
                                 None, p)
    errs = {}
    for i, (name, (shape, causal, bias, p)) in enumerate(cases.items()):
        q, k, v, do = general_case(
            *shape, seed=ord(name) if len(name) == 1 else 1000 + i)
        err_o, err_g, line = general_compare(torch, fa, q, k, v, do, causal,
                                             bias, p, seed_t)
        errs[name] = (err_o, err_g)
        print(f"  flash_attention ({name}) B,Sq,Sk,H,D={shape[:5]} "
              f"{str(shape[5])[6:]} {'causal' if causal else 'full'} "
              f"bias {None if bias is None else tuple(bias.shape)} p={p}: "
              f"{line}  ok")

    # timing: three input copies of (a) (34 MB each) and (b) (42 MB each)
    # cycled past the 50 MB L2
    it = iter(range(10 ** 9))
    ta = [general_case(BERT_B, BERT_S, BERT_S, 16, 64, bf, seed=i)
          for i in range(3)]
    tb = [general_case(2, 2048, 2048, 8, 128, bf, seed=10 + i)
          for i in range(3)]
    kw_a = dict(bias=bias_a, dropout_p=0.1, seed=seed_t)
    kw_b = dict(dropout_p=0.1, seed=seed_t)
    saved_a = [fa.flash_attention_fwd(*t[:3], False, **kw_a) for t in ta]
    saved_b = [fa.flash_attention_fwd(*t[:3], True, **kw_b) for t in tb]

    def fwd_a():
        fa.flash_attention_fwd(*ta[next(it) % 3][:3], False, **kw_a)

    def bwd_a():
        i = next(it) % 3
        fa.flash_attention_bwd(*ta[i][:3], *saved_a[i], ta[i][3], False,
                               **kw_a)

    def fwd_b():
        fa.flash_attention_fwd(*tb[next(it) % 3][:3], True, **kw_b)

    def bwd_b():
        i = next(it) % 3
        fa.flash_attention_bwd(*tb[i][:3], *saved_b[i], tb[i][3], True,
                               **kw_b)

    ms = {"fwd_a": time_ms(fwd_a, 20), "bwd_a": time_ms(bwd_a, 10),
          "fwd_b": time_ms(fwd_b, 10), "bwd_b": time_ms(bwd_b, 5)}
    # (a) without dropout: the dropout hash's share of the kernels' time
    kw_a0 = dict(bias=bias_a)
    saved_a0 = [fa.flash_attention_fwd(*t[:3], False, **kw_a0) for t in ta]

    def bwd_a0():
        i = next(it) % 3
        fa.flash_attention_bwd(*ta[i][:3], *saved_a0[i], ta[i][3], False,
                               **kw_a0)

    no_drop = (time_ms(lambda: fa.flash_attention_fwd(
        *ta[next(it) % 3][:3], False, **kw_a0), 20), time_ms(bwd_a0, 10))
    qa, ka, va, doa = ta[0]
    qb, kb, vb, dob = tb[0]
    plain = {
        "fwd_a": time_ms(lambda: fa.flash_reference(qa, ka, va, False,
                                                    **kw_a), 3, 1),
        "bwd_a": time_ms(lambda: fa.flash_bwd_reference(
            qa, ka, va, *saved_a[0], doa, False, **kw_a), 3, 1),
        "fwd_b": time_ms(lambda: fa.flash_reference(qb, kb, vb, True,
                                                    **kw_b), 2, 1),
        "bwd_b": time_ms(lambda: fa.flash_bwd_reference(
            qb, kb, vb, *saved_b[0], dob, True, **kw_b), 2, 1)}

    # SDPA on [B, H, S, D] with the float bias as attn_mask, dropout 0.1
    def heads(ts):
        return [[x.transpose(1, 2).detach().requires_grad_(True)
                 for x in t[:3]] + [t[3].transpose(1, 2)] for t in ts]

    ha, hb = heads(ta), heads(tb)
    sdpa_mask = bias_a[:, None].to(bf)            # [B, 1, 1, S]

    def lib(hs, causal, mask, backward):
        def run():
            q, k, v, do = hs[next(it) % 3]
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=0.1, is_causal=causal)
            if backward:
                out.backward(do)
        return run

    lib_fa = time_ms(lib(ha, False, sdpa_mask, False), 20)
    lib_fba = time_ms(lib(ha, False, sdpa_mask, True), 10)
    lib_fb = time_ms(lib(hb, True, None, False), 5)
    lib_fbb = time_ms(lib(hb, True, None, True), 5)
    library = {"fwd_a": lib_fa, "bwd_a": lib_fba - lib_fa, "fwd_b": lib_fb,
               "bwd_b": lib_fbb - lib_fb}

    k_rows_a = int(lens.sum().item())             # keys some query sees
    pairs_a = BERT_S * k_rows_a
    work_a = general_work(BERT_B, BERT_S, BERT_S, 16, 64, pairs_a, k_rows_a,
                          2, BERT_B * BERT_S * 4)
    work_b = general_work(2, 2048, 2048, 8, 128, 2 * 2048 * 2049 // 2,
                          2 * 2048, 2, 0)
    label = {"a": "(a) B8 S512 H16 D64 key-padding",
             "b": "(b) B2 S2048 H8 D128 causal"}
    bounds = {}
    for key, (nbytes, flops) in (("fwd_a", work_a[0]), ("bwd_a", work_a[1]),
                                 ("fwd_b", work_b[0]), ("bwd_b", work_b[1])):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        bounds[key] = (max(t_bytes, t_ops) * 1e3,
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"  flash_attention {key[:3]} at {label[key[-1]]}"
              f" bf16 p=0.1: kernel {ms[key]:.4f} ms, plain {plain[key]:.4f}"
              f" ms, SDPA {library[key]:.4f} ms, bound {bounds[key][0]:.4f} "
              f"ms ({bounds[key][1]}; {nbytes} bytes, {flops} flops)")
    print(f"  SDPA forward+backward (a) {lib_fba:.4f} ms, (b) {lib_fbb:.4f} "
          f"ms; forward (a) {lib_fa:.4f} ms, (b) {lib_fb:.4f} ms (its "
          "backward alone: the difference)")
    print(f"  flash_attention at (a) without dropout: fwd {no_drop[0]:.4f} "
          f"ms, bwd {no_drop[1]:.4f} ms (the dropout hash's cost: the "
          "difference from p=0.1)")
    records = []
    for name, key, err, line in (
            ("flash_attention_fwd", "fwd_a", errs["a"][0], 207),
            ("flash_attention_bwd", "bwd_a", errs["a"][1], 536)):
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": library[key]})
    return records


def wide_flash_phase(torch):
    """B2 and B4 at head dims above 128: bf16 at D 192 and 256 on the
    wgmma kernels resized (64-key tiles and blocks), f32 and bf16 above
    256 on the kernels sliced over D. B2's kernels against their plain
    versions (`general_compare`: f32 at TOL_F32, bf16 at BF16_ULPS_O ulps
    beside a float32 control) at D 192, 256 and 384, f32 and bf16, at
    phase 3's edge shapes: (e) Sq=128 Sk=384 causal, dropout 0.1; (f)
    S=200 key padding, dropout 0.1; (h) Sq=256 Sk=320 with a full
    [B,Sq,Sk] bias; (i) S=200 with a fully masked row. B4 at D=256 against its plain versions under a random
    lse cotangent (`b4_compare`), causal and full, f32 and bf16. Then
    times at Gemma-2B's attention shape (GEMMA_ATTN: B4 S1024 H8 D256
    bf16), causal at p=0 and key-padded (lengths in [768, 1024)) at
    p=0.1 as phase 13 trains, forward and backward, beside the plain
    versions, SDPA (timed only) and the bound; and B4 at B1 S2048 H8
    D256. Returns the forward's and backward's records at the key-padded
    shape."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    mask_f = torch.arange(200, device="cuda")[None, :] < torch.tensor(
        [[130], [187]], device="cuda")
    bias_h = torch.randn((2, 256, 320), generator=g, device="cuda") * 2
    mask_i = torch.ones((2, 1, 200, 200), dtype=torch.bool, device="cuda")
    mask_i[1, 0, 7] = False                       # query row 7 sees nothing
    edges = {"e": ((2, 128, 384, 2), True, None, 0.1),
             "f": ((2, 200, 200, 2), False,
                   fa.normalize_mask_bias(mask_f[:, None, None, :]), 0.1),
             "h": ((2, 256, 320, 2), False, bias_h, 0.0),
             "i": ((2, 200, 200, 2), False, fa.normalize_mask_bias(mask_i),
                   0.0)}
    for d in (192, 256, 384):
        for dtype in (torch.float32, torch.bfloat16):
            for name, (shape, causal, bias, p) in edges.items():
                q, k, v, do = general_case(*shape, d, dtype,
                                           seed=ord(name) + d)
                _, _, line = general_compare(torch, fa, q, k, v, do, causal,
                                             bias, p, seed_t)
                print(f"  flash_attention ({name}) B,Sq,Sk,H={shape} D={d} "
                      f"{str(dtype)[6:]} {'causal' if causal else 'full'} "
                      f"bias {None if bias is None else tuple(bias.shape)} "
                      f"p={p}: {line}  ok")
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            q, k, v, do = general_case(1, 1024, 1024, 2, 256, dtype,
                                       seed=140 + int(causal))
            dlse = torch.randn((1, 2, 1024), generator=g, device="cuda")
            _, _, line = b4_compare(torch, fa, q, k, v, do, dlse, causal)
            print(f"  flash_attention_with_lse B=1 S=1024 H=2 D=256 "
                  f"{str(dtype)[6:]} {'causal' if causal else 'full'}, "
                  f"random dlse: {line}  ok")

    b, s, h, d = GEMMA_ATTN
    bf = torch.bfloat16
    it = iter(range(10 ** 9))
    copies = [general_case(b, s, s, h, d, bf, seed=150 + i) for i in range(3)]
    heads = [[x.transpose(1, 2).detach().requires_grad_(True)
              for x in t[:3]] + [t[3].transpose(1, 2)] for t in copies]
    mask, lens = key_padding(torch, b, s, 2, GEMMA_MIN_LEN)
    bias = fa.normalize_mask_bias(mask)
    arms = {"causal": (True, {}, None, b * s * (s + 1) // 2, b * s, 0),
            "key padding": (False, dict(bias=bias, dropout_p=0.1,
                                        seed=seed_t), bias[:, None].to(bf),
                            s * int(lens.sum()), int(lens.sum()), b * s * 4)}
    out = {}
    for label, (causal, kw, lib_mask, pairs, k_rows, bias_bytes) in \
            arms.items():
        saved = [fa.flash_attention_fwd(*t[:3], causal, **kw) for t in copies]

        def fwd():
            fa.flash_attention_fwd(*copies[next(it) % 3][:3], causal, **kw)

        def bwd():
            i = next(it) % 3
            fa.flash_attention_bwd(*copies[i][:3], *saved[i], copies[i][3],
                                   causal, **kw)

        def lib(backward):
            def run():
                q, k, v, do = heads[next(it) % 3]
                o = F.scaled_dot_product_attention(
                    q, k, v, attn_mask=lib_mask, is_causal=causal,
                    dropout_p=kw.get("dropout_p", 0.0))
                if backward:
                    o.backward(do)
            return run

        q, k, v, do = copies[0]
        ro, rlse = fa.flash_reference(q, k, v, causal, **kw)
        grads = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal, **kw)
        rgrads = fa.flash_bwd_reference(q, k, v, ro, rlse, do, causal, **kw)
        torch.cuda.synchronize()
        errs = ((saved[0][0].float() - ro.float()).abs().max().item(),
                max((a.float() - r.float()).abs().max().item()
                    for a, r in zip(grads, rgrads)))
        ulps = [flash_ulps(x, r, d)[0] for x, r in zip(
            (saved[0][0], *grads), (ro, *rgrads))]
        check(max(ulps) <= BF16_ULPS_O, f"Gemma-2B's attention, {label}: "
              f"o, dq, dk, dv {ulps} ulps over the limit of {BF16_ULPS_O}")
        del ro, grads, rgrads
        ms = (time_ms(fwd, 5, 1), time_ms(bwd, 3, 1))
        plain = (time_ms(lambda: fa.flash_reference(q, k, v, causal, **kw),
                         2, 1),
                 time_ms(lambda: fa.flash_bwd_reference(
                     q, k, v, *saved[0], do, causal, **kw), 2, 1))
        lib_f, lib_fb = time_ms(lib(False), 10), time_ms(lib(True), 5)
        library = (lib_f, lib_fb - lib_f)
        work = general_work(b, s, s, h, d, pairs, k_rows, 2, bias_bytes)
        for j, (nbytes, flops) in enumerate(work):
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            bound = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
            print(f"  flash_attention {('fwd', 'bwd')[j]} at Gemma-2B's "
                  f"attention B={b} S={s} H={h} D={d} bf16 {label}"
                  f"{' p=0.1' if kw else ''}: kernel {ms[j]:.4f} ms, plain "
                  f"{plain[j]:.4f} ms, SDPA {library[j]:.4f} ms, bound "
                  f"{bound[0]:.5f} ms ({bound[1]}; {nbytes} bytes, {flops} "
                  f"flops); max|{('o', 'd(q,k,v)')[j]}-plain| {errs[j]:.3e}, "
                  f"o, dq, dk, dv {[round(u, 3) for u in ulps]} ulps")
            out[label, j] = {
                "route": "cuda",
                "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                "max_abs_err": errs[j], "ms": ms[j], "plain_ms": plain[j],
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library[j]}
    del copies, heads
    gc.collect()
    torch.cuda.empty_cache()

    # B4 at D=256: one full pair of a ring over 8 heads of 256
    copies = [general_case(1, 2048, 2048, 8, 256, bf, seed=160 + i)
              for i in range(3)]
    dlses = [torch.randn((1, 8, 2048), device="cuda") for _ in copies]
    saved = [fa.flash_attention_lse_fwd(*t[:3], False) for t in copies]
    q, k, v, do = copies[0]

    def lse_bwd():
        i = next(it) % 3
        fa.flash_attention_lse_bwd(*copies[i][:3], *saved[i], copies[i][3],
                                   dlses[i], False)

    ms = (time_ms(lambda: fa.flash_attention_lse_fwd(
              *copies[next(it) % 3][:3], False), 5, 1),
          time_ms(lse_bwd, 3, 1))
    plain = (time_ms(lambda: fa.flash_reference(q, k, v, False), 2, 1),
             time_ms(lambda: fa.flash_bwd_reference(
                 q, k, v, *saved[0], do, False, dlse=dlses[0]), 2, 1))
    hq, hk, hv = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv), 10)
    lib_fb = time_ms(lambda: F.scaled_dot_product_attention(
        hq, hk, hv).backward(do.transpose(1, 2)), 5)
    work = general_work(1, 2048, 2048, 8, 256, 2048 * 2048, 2048, 2, 0)
    work = (work[0], (work[1][0] + 8 * 2048 * 4, work[1][1]))
    for j, (nbytes, flops) in enumerate(work):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        print(f"  flash_attention_lse_{('fwd', 'bwd')[j]} at B=1 S=2048 H=8 "
              f"D=256 bf16 full: kernel {ms[j]:.4f} ms, plain {plain[j]:.4f} "
              f"ms, SDPA {(lib_f, lib_fb - lib_f)[j]:.4f} ms (no lse "
              f"cotangent), bound {max(t_bytes, t_ops) * 1e3:.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}; {nbytes} "
              f"bytes, {flops} flops)")
    return [{"name": "flash_attention_fwd_d256",
             "replaces": "paddle_tpu/kernels/flash_attention.py:207",
             **out["key padding", 0]},
            {"name": "flash_attention_bwd_d256",
             "replaces": "paddle_tpu/kernels/flash_attention.py:536",
             **out["key padding", 1]}]


# ------------------------------------------------- which-major qkv3 (B5)
def qkv_work(b, s, h, d, el):
    """``((bytes, flops) forward, (bytes, flops) backward)`` of a qkv
    flash call without a mask, full (every pair visible). Forward: qkv
    read, o and lse written; 4*D flops a pair. Backward: qkv, o, dO and
    lse read, dqkv written; 10*D flops a pair."""
    io = b * s * h * d * el                       # one [B, S, H*D] tensor
    lse = b * h * s * 4
    pairs = b * h * s * s
    return ((3 * io + io + lse, 4 * d * pairs),
            (3 * io + 2 * io + lse + 3 * io, 10 * d * pairs))


def qkv3_against_qkv(torch, fa, outs, outs1, h):
    """B5's ``(o, lse, dqkv)`` against B1's ``outs1`` on the repacked
    (pair-major) projection: the same kernels at other column offsets
    give the same values and drop the same elements, so o and lse agree
    bit for bit, and the gradients as `grads_agree` holds them (bf16 dq
    also against its plain version, in `flash_compare`). Returns a line
    of the readings."""
    o, lse, dqkv = outs
    o1, lse1, d1 = outs1
    hd = dqkv.shape[-1] // 3
    what = (f"qkv3 {str(dqkv.dtype)[6:]} D={hd // h}: B5 against B1 on the "
            "repacked projection")
    check(torch.equal(o, o1) and torch.equal(lse, lse1),
          f"{what}: o or lse differs")
    return "o, lse bitwise B1's on the repacked projection; " + grads_agree(
        torch, what, dqkv.split(hd, dim=-1),
        fa._pair_to_which(d1, h).split(hd, dim=-1), hd // h)


def qkv3_kernel_phase(torch):
    """B5 (rows 8-9) against its plain versions on the card: f32 and
    bf16, D 64 and 128, causal and full, dropout 0 and 0.1, at B2 S256 H4,
    with B1's tolerances (`flash_compare`), and against B1's kernels on
    the repacked (pair-major) projection (`qkv3_against_qkv`); at phase
    21's encoder self-attention (B32 S256 H8 D64 bf16, full, dropout 0
    and 0.1) and at phase 26b's (B8 S256 H8 D64 f32, full, dropout 0)
    against its plain versions. Then at BERT-large's shape (B8 S512 H16
    D64 bf16, full, dropout 0.1): agreement, time beside the plain
    versions, SDPA on the unpacked [B, H, S, D] tensors with dropout 0.1
    (timed only; the port never calls it) and the bound; and B1 at the
    same shape (the fused BERT's): against its plain versions and
    against B5, timed. Returns the forward's and the backward's
    records."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device="cuda")
    three, pair = qkv_fns(fa, "which"), qkv_fns(fa, "pair")
    for d in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for p in (0.0, 0.1):
                    qkv, do = flash_case(2, 256, 4, d, dtype, seed=300 + d
                                         + int(causal) + int(10 * p))
                    _, line, (o, lse, dqkv) = flash_compare(
                        torch, three, qkv, do, 4, causal, p, seed_t)
                    ro, rlse = fa.flash_qkv3_reference(qkv, 4, causal, p,
                                                       seed_t)
                    qp = fa._which_to_pair(qkv, 4).contiguous()
                    o1, lse1 = fa.flash_attention_qkv_fwd(qp, 4, causal, p,
                                                          seed_t)
                    d1 = fa.flash_attention_qkv_bwd(qp, do, ro, rlse, 4,
                                                    causal, p, seed_t)
                    line1 = qkv3_against_qkv(torch, fa, (o, lse, dqkv),
                                             (o1, lse1, d1), 4)
                    print(f"  flash_attention_qkv3 D={d} {str(dtype)[6:]} "
                          f"{'causal' if causal else 'full'} p={p}: {line}; "
                          f"{line1}  ok")
    for p in (0.0, 0.1):
        qkv, do = flash_case(TR_B, TR_SRC, 8, 64, torch.bfloat16,
                             seed=500 + int(10 * p))
        _, line, _ = flash_compare(torch, three, qkv, do, 8, False, p, seed_t)
        print(f"  flash_attention_qkv3 at the Transformer encoder's shape "
              f"B{TR_B} S{TR_SRC} H8 D64 bf16 full p={p}: {line}  ok")
    # phase 26b's encoder: float32, no dropout (a beam search runs the
    # forward alone; the backward is held too)
    qkv, do = flash_case(BS_B, BS_SRC, 8, 64, torch.float32, seed=520)
    _, line, _ = flash_compare(torch, three, qkv, do, 8, False, 0.0, seed_t)
    print(f"  flash_attention_qkv3 at the beam search encoder's shape "
          f"B{BS_B} S{BS_SRC} H8 D64 f32 full p=0.0: {line}  ok")

    b, s, h, d = BERT_B, BERT_S, 16, 64
    bf, p = torch.bfloat16, 0.1
    # three input copies of 25 MB of qkv (+ do, o, lse) each: past the L2
    copies = [flash_case(b, s, h, d, bf, seed=40 + i) for i in range(3)]
    err, line, (o, lse, dqkv) = flash_compare(torch, three, *copies[0], h,
                                              False, p, seed_t)
    print(f"  BERT shape B={b} S={s} H={h} D={d} bf16 full p={p}: {line}  ok")
    pairs_in = [fa._which_to_pair(q, h).contiguous() for q, _ in copies]
    # B1 at the fused BERT's shape: against its plain versions, and bit
    # for bit against B5 on the same (repacked) inputs
    _, line1, outs1 = flash_compare(torch, pair, pairs_in[0], copies[0][1],
                                    h, False, p, seed_t)
    line2 = qkv3_against_qkv(torch, fa, (o, lse, dqkv), outs1, h)
    print(f"  flash_attention_qkv (B1) at the same shape, the fused BERT's: "
          f"{line1}; B5's against it: {line2}  ok")
    saved = [fa.flash_attention_qkv3_fwd(q, h, False, p, seed_t)
             for q, _ in copies]
    saved1 = [fa.flash_attention_qkv_fwd(q, h, False, p, seed_t)
              for q in pairs_in]
    it = iter(range(10 ** 9))

    def fwd(kernel, inputs):
        def run():
            kernel(inputs[next(it) % 3], h, False, p, seed_t)
        return run

    def bwd(kernel, inputs, outs):
        def run():
            i = next(it) % 3
            kernel(inputs[i], copies[i][1], *outs[i], h, False, p, seed_t)
        return run

    qkvs = [q for q, _ in copies]
    ms = {"fwd": time_ms(fwd(fa.flash_attention_qkv3_fwd, qkvs), 20),
          "bwd": time_ms(bwd(fa.flash_attention_qkv3_bwd, qkvs, saved), 10)}
    b1_ms = {"fwd": time_ms(fwd(fa.flash_attention_qkv_fwd, pairs_in), 20),
             "bwd": time_ms(bwd(fa.flash_attention_qkv_bwd, pairs_in,
                                saved1), 10)}
    qkv, do = copies[0]
    plain = {"fwd": time_ms(lambda: fa.flash_qkv3_reference(
        qkv, h, False, p, seed_t), 3, 1),
        "bwd": time_ms(lambda: fa.flash_qkv3_bwd_reference(
            qkv, do, *saved[0], h, False, p, seed_t), 3, 1)}
    b1_plain = {"fwd": time_ms(lambda: fa.flash_qkv_reference(
        pairs_in[0], h, False, p, seed_t), 3, 1),
        "bwd": time_ms(lambda: fa.flash_qkv_bwd_reference(
            pairs_in[0], do, *saved1[0], h, False, p, seed_t), 3, 1)}
    # SDPA on [B, H, S, D], dropout 0.1
    heads = [[t.contiguous().requires_grad_(True)
              for t in q.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)]
             for q in qkvs]
    dos = [g.reshape(b, s, h, d).transpose(1, 2).contiguous()
           for _, g in copies]

    def lib(backward):
        def run():
            i = next(it) % 3
            out = F.scaled_dot_product_attention(*heads[i], dropout_p=p)
            if backward:
                out.backward(dos[i])
        return run

    lib_f, lib_fb = time_ms(lib(False), 20), time_ms(lib(True), 10)
    library = {"fwd": lib_f, "bwd": lib_fb - lib_f}
    work = dict(zip(("fwd", "bwd"), qkv_work(b, s, h, d, 2)))
    records = []
    for key, line_no in (("fwd", 1018), ("bwd", 1044)):
        nbytes, flops = work[key]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        name = f"flash_attention_qkv3_{key}"
        bwd = key == "bwd"
        before = (f", before {OLD_BWD_MS['qkv3']:.4f} ms (mma.sync, "
                  "PERF.md)" if bwd else "")
        before1 = (f", before {OLD_BWD_MS['fused_bert']:.4f} ms (mma.sync, "
                   "PERF.md)" if bwd else "")
        print(f"  {name} at B={b} S={s} H={h} D={d} bf16 full p={p}: kernel "
              f"{ms[key]:.4f} ms{before}, plain {plain[key]:.4f} ms, SDPA "
              f"{library[key]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by};"
              f" {nbytes} bytes, {flops} flops)")
        print(f"  flash_attention_qkv_{key} (B1) at the same shape, the "
              f"fused BERT's: kernel {b1_ms[key]:.4f} ms{before1}, plain "
              f"{b1_plain[key]:.4f} ms, bound {bound_ms:.4f} ms, library "
              f"{library[key]:.4f} ms (the SDPA call above: the same "
              "function on the same inputs)")
        src = "flash_attention" if bwd else "flash_attention_qkv"
        records.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line_no}",
            "max_abs_err": err["o" if key == "fwd" else "dqkv"],
            "ms": ms[key], "plain_ms": plain[key], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[key]})
    print(f"  SDPA forward+backward {lib_fb:.4f} ms, forward {lib_f:.4f} ms "
          "(its backward alone: the difference)")
    return records


# ------------------------------------------------- fused LayerNorm (B6)
@contextlib.contextmanager
def plain_kernels(torch):
    """Every flash and LayerNorm wrapper through its plain version on the
    card: the reference's numerics, no kernel (a control only)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ln as fl

    saved = fa.runs_plain, fl.runs_plain
    fa.runs_plain = fl.runs_plain = lambda t, kernel: True
    try:
        yield
    finally:
        fa.runs_plain, fl.runs_plain = saved


def ln_case(torch, n, m, dtype, seed, residual):
    """``(x, residual or None, g, b, dy)`` on the card: rows of standard
    normals shifted by 0.5, g about 1 and b about 0, in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r, dy = (torch.randn((n, m), generator=g, device="cuda") + 0.5
                for _ in range(3))
    w = 1 + 0.5 * torch.randn(m, generator=g, device="cuda")
    b = torch.randn(m, generator=g, device="cuda")
    return (x.to(dtype), r.to(dtype) if residual else None, w.to(dtype),
            b.to(dtype), dy.to(dtype))


def ln_work(n, m, el, residual):
    """``((bytes, flops) forward, (bytes, flops) backward)`` of the fused
    LayerNorm on ``[n, m]`` rows of ``el``-byte values. Forward: x (and
    the residual) read, g and b (f32) read, y written, mean and rstd
    written; about 8 flops an element. Backward: x (and the residual), dy,
    g, mean and rstd read, dx written (the residual's gradient is the
    same tensor), dg and db written; about 14 flops an element."""
    rows = n * m * el
    ins = rows * (2 if residual else 1)
    stats = 2 * n * 4
    return ((ins + 2 * m * 4 + rows + stats, 8 * n * m),
            (ins + rows + m * 4 + stats + rows + 2 * m * 4, 14 * n * m))


def fused_ln_phase(torch):
    """B6 (rows 10-11; 10h-11h in float16) through its entry,
    ``incubate.nn.functional._ln_maybe_fused``, on the card: f32, bf16
    and f16, with and without a residual, y, dx, d(residual), dg and db
    against the same entry run through the plain versions (TOL_F32 /
    TOL_LN_SUMS in float32, TOL_BF16_OUT in bfloat16, where both round the
    same float32 math to bf16; float16 within 8 of its ulps at each
    element's scale, `flash_ulps`). No layer calls the entry (nor in the
    reference), so its launches are those of these calls. Then the
    kernels at BERT-large's rows ([8*512, 1024] with a residual) in bf16
    and f16 beside the plain versions, the library's two calls ``x + r``
    then ``F.layer_norm`` (timed only) and the bound. Returns the
    forward's and the backward's records of both dtypes and the
    launches."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.incubate.nn import functional as IF

    eps = 1e-5
    worst = {}
    launched = {"fused_ln_fwd": 0, "fused_ln_bwd": 0, "fused_ln_fwd_f16": 0,
                "fused_ln_bwd_f16": 0}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        f16 = dtype == torch.float16
        names_of = {k: k + ("_f16" if f16 else "") for k in ("fused_ln_fwd",
                                                             "fused_ln_bwd")}
        for residual in (True, False):
            case = ln_case(torch, 512, 1024, dtype, 7 + residual, residual)
            outs = []
            for plain in (False, True):
                leaves = [None if t is None else
                          t.detach().clone().requires_grad_(True)
                          for t in case[:4]]
                x, r, w, b = leaves
                with plain_kernels(torch) if plain else \
                        contextlib.nullcontext():
                    before = kernels.kernel_launch_counts()
                    y = IF._ln_maybe_fused(x, w, b, eps, residual=r)
                    y.backward(case[4])
                    torch.cuda.synchronize()
                    after = kernels.kernel_launch_counts()
                if not plain:
                    for k in names_of.values():
                        launched[k] += after[k] - before[k]
                        check(after[k] - before[k] == 1,
                              f"_ln_maybe_fused launched {k} "
                              f"{after[k] - before[k]} times, not once")
                outs.append([y] + [t.grad for t in leaves if t is not None])
            names = ["y", "dx"] + (["dres"] if residual else []) + ["dg",
                                                                    "db"]
            parts = []
            for name, a, ref in zip(names, *outs):
                key = names_of["fused_ln_fwd" if name == "y"
                               else "fused_ln_bwd"]
                e = (a.float() - ref.float()).abs().max().item()
                worst[key] = max(worst.get(key, 0.0), e)
                if f16:
                    ulps, _ = flash_ulps(a, ref, a.shape[-1])
                    check(ulps <= 8, f"fused_ln f16 {name} {ulps:.2f} ulps "
                          "from the plain version")
                    parts.append(f"{name} {e:.3e} ({ulps:.2f} ulps)")
                    continue
                if dtype == torch.bfloat16:
                    tol = TOL_BF16_OUT
                else:
                    tol = TOL_LN_SUMS if name in ("dg", "db") else TOL_F32
                torch.testing.assert_close(a.float(), ref.float(), **tol)
                parts.append(f"{name} {e:.3e}")
            print(f"  _ln_maybe_fused [512, 1024] {str(dtype)[6:]} "
                  f"{'with' if residual else 'without'} residual: max|diff| "
                  + ", ".join(parts) + "  ok")
    records = []
    for dtype in (torch.bfloat16, torch.float16):
        records += ln_times(torch, dtype, eps, worst)
    print(f"  launches through the entry {launched} (no main path runs it)")
    return records, launched


def ln_times(torch, dtype, eps, worst):
    """B6 at BERT-large's rows ([8*512, 1024] with a residual) in
    ``dtype``: the kernels' times beside the plain versions', the
    library's two calls and the bound; the records of the forward and
    the backward (float16 named with ``_f16``)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_ln as fl

    n, m = BERT_B * BERT_S, 1024
    suffix = "_f16" if dtype == torch.float16 else ""
    # four copies of 17 MB of x and residual (+ dy): past the 50 MB L2
    copies = [ln_case(torch, n, m, dtype, 20 + i, True) for i in range(4)]
    w32, b32 = copies[0][2].float(), copies[0][3].float()
    saved = [fl.fused_ln_fwd(c[0], c[1], w32, b32, eps) for c in copies]
    it = iter(range(10 ** 9))

    def fwd():
        c = copies[next(it) % 4]
        fl.fused_ln_fwd(c[0], c[1], w32, b32, eps)

    def bwd():
        i = next(it) % 4
        c = copies[i]
        fl.fused_ln_bwd(c[0], c[1], w32, *saved[i][1:], c[4])

    ms = {"fwd": time_ms(fwd, 50), "bwd": time_ms(bwd, 50)}
    x, r, _, _, dy = copies[0]
    plain = {"fwd": time_ms(lambda: fl.fused_ln_reference(x, r, w32, b32,
                                                          eps), 5, 1),
             "bwd": time_ms(lambda: fl.fused_ln_bwd_reference(
                 x, r, w32, *saved[0][1:], dy), 5, 1)}
    leaves = [[t.detach().requires_grad_(True) for t in c[:4]]
              for c in copies]

    def lib(backward):
        def run():
            i = next(it) % 4
            xl, rl, wl, bl = leaves[i]
            y = F.layer_norm(xl + rl, (m,), wl, bl, eps)
            if backward:
                y.backward(copies[i][4])
        return run

    lib_f, lib_fb = time_ms(lib(False), 50), time_ms(lib(True), 20)
    library = {"fwd": lib_f, "bwd": lib_fb - lib_f}
    work = dict(zip(("fwd", "bwd"), ln_work(n, m, 2, True)))
    records = []
    for key, line_no in (("fwd", 45), ("bwd", 62)):
        nbytes, flops = work[key]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        name = f"fused_ln_{key}{suffix}"
        print(f"  {name} at [{n}, {m}] {str(dtype)[6:]} with residual: "
              f"kernel {ms[key]:.4f} ms, plain {plain[key]:.4f} ms, library "
              f"(x + r then F.layer_norm, two calls) {library[key]:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes} bytes, "
              f"{flops} flops)")
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ln.cu",
            "replaces": f"paddle_tpu/kernels/fused_ln.py:{line_no}",
            "max_abs_err": worst[name], "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[key]})
    print(f"  {str(dtype)[6:]} library forward+backward {lib_fb:.4f} ms, "
          f"forward {lib_f:.4f} ms (its backward alone: the difference)")
    return records


# ---------------------------------------------------------------- engine
def engine_phase(torch, seed):
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import Engine

    cfg = gpt_config(MODEL)
    t = time.perf_counter()
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    torch.cuda.synchronize()
    print(f"  {MODEL}: h={cfg.hidden_size} layers={cfg.num_hidden_layers} "
          f"heads={cfg.num_attention_heads} d={cfg.head_dim} bf16, random "
          f"weights from seed {seed} ({time.perf_counter() - t:.1f} s)")
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    # warm-up on its own engine (cuBLAS handles, allocator), not counted
    warm = Engine(model, **kw)
    warm.submit(list(range(1, 30)), max_new_tokens=2).result()
    del warm
    torch.cuda.synchronize()

    prompts = phase_prompts(torch, cfg, seed)
    outs, s, wall, counts = serve_traffic(torch, Engine(model, **kw), prompts)
    want = s.decode_steps * cfg.num_hidden_layers
    check(counts["paged_attention"] == want,
          f"paged_attention launched {counts['paged_attention']} times, "
          f"decode_steps x layers = {want}")
    check(all(v == 0 for k, v in counts.items() if k != "paged_attention"),
          f"serving launched a training kernel: {counts}")
    print(f"  served {len(prompts)} requests (prompts {PROMPT_LENS}, "
          f"max_new {MAX_NEW}) in {wall:.3f} s: {s.prefill_steps} prefills,"
          f" {s.decode_steps} decode steps, {s.tokens_generated} tokens")
    print(f"  launches {counts}: paged_attention = decode_steps x layers")

    print(f"  TTFT p50 {s.ttft_p50 * 1e3:.3f} ms, decode "
          f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50), "
          f"{s.tokens_generated / wall:.1f} tokens/s")
    teacher_check(torch, model, prompts, outs)
    eng = Engine(model, **kw)
    profile_decode(torch, eng, prompts)
    engine_graph_check(torch, eng)
    return {"paged_attention": counts["paged_attention"]}, s.decode_step_p50


def graph_against_eager(torch, fn, ops, label):
    """One replay of the captured step ``fn`` and one `run_eager` on the
    same staged operands ``ops``, each from the same state (``fn.fixed``,
    the caches and pools it writes, cloned before and restored after
    each). Holds the float32 logits bit for bit, or, where cuBLAS picks
    other kernels under capture, the same argmax tokens and every logit
    within 1 bf16 ulp of its own scale. Returns which of the two held."""
    with torch.inference_mode():
        saved = [t.clone() for t in fn.fixed]
        graph = fn(**ops)
        for t, v in zip(fn.fixed, saved):
            t.copy_(v)
        eager = fn.run_eager(**ops)
        for t, v in zip(fn.fixed, saved):
            t.copy_(v)
    del saved
    if torch.equal(graph, eager):
        return "bit for bit"
    check(torch.equal(graph.argmax(-1), eager.argmax(-1)),
          f"{label}: the replay's tokens differ from the eager run's")
    scale = torch.maximum(graph.abs(), eager.abs()).clamp(min=1e-30)
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(
        torch.floor(torch.log2(scale)))
    worst = ((graph - eager).abs() / ulp).max().item()
    check(worst <= 1.0, f"{label}: the replay's logits lie {worst:.2f} "
          "bf16 ulps from the eager run's")
    return "tokens identical, logits within 1 bf16 ulp"


def engine_graph_check(torch, eng, steps=3):
    """The graph-against-eager check on a full engine's decode step, at
    each of ``steps`` decode steps (its pending tokens and slot state as
    they stand), one engine step between them."""
    held = []
    for _ in range(steps):
        held.append(graph_against_eager(
            torch, eng._verify, eng._step_operands(eng._tokens[:, None]),
            "engine decode step"))
        eng.step()
    print(f"  graph against eager, the engine's decode step at {steps} "
          f"full decode steps: {held}")


def buckets_used(prompts):
    """The prefill buckets ``prompts`` fall in: one prefill graph each."""
    return len({min(b for b in BUCKETS if b >= len(p)) for p in prompts})


def phase_prompts(torch, cfg, seed):
    """The serving phases' prompts: PROMPT_LENS tokens each, from
    ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, cfg.vocab_size, (p,), generator=g).tolist()
            for p in PROMPT_LENS]


def serve_traffic(torch, eng, prompts, sampled=()):
    """The serving phases' traffic through ``eng``: request ``i`` is
    submitted at step SUBMIT_AT_STEP[i], greedy, or sampled at
    temperature 1 with seed ``1000 + i`` when ``i`` is in ``sampled``.
    Launch counts are zeroed just before and read just after. Checks
    that every request completes and every page returns; returns
    ``(outputs, stats, wall seconds, launch counts)``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.observability import get_sentinel

    handles = [None] * len(prompts)
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    step = 0
    with get_sentinel().armed():
        while step <= max(SUBMIT_AT_STEP) or eng.stats().active_slots \
                or eng.stats().queue_depth:
            for i, at in enumerate(SUBMIT_AT_STEP):
                if at == step:
                    kw = (dict(decode_strategy="sampling", temperature=1.0,
                               seed=1000 + i) if i in sampled else {})
                    handles[i] = eng.submit(prompts[i],
                                            max_new_tokens=MAX_NEW, **kw)
            eng.step()
            step += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    s = eng.stats()
    outs = [h.result() for h in handles]
    check(s.completed == len(prompts) and all(
        len(o) == MAX_NEW for o in outs), f"not every request completed: {s}")
    if s.kv_mode == "paged":
        check(s.kv_pages_in_use == 0 and s.kv_pages_free == s.kv_pages_total,
              f"pages did not return to the pool: {s}")
    else:
        check(s.active_slots == 0 and s.free_slots == eng.slots,
              f"slots did not return: {s}")
    check(s.decode_traces == 1 and s.prefill_traces == buckets_used(prompts),
          f"graphs: decode_traces {s.decode_traces}, prefill_traces "
          f"{s.prefill_traces}, {buckets_used(prompts)} buckets used")
    print(f"  graphs of {eng.metrics.engine_id} (sentinel armed): "
          f"decode_traces {s.decode_traces}, prefill_traces "
          f"{s.prefill_traces} (= buckets used), capture_s "
          f"{s.capture_s:.3f}")
    return outs, s, wall, counts


def teacher_check(torch, model, prompts, outs, state=None, tie=TEACHER_GAP):
    """One full-sequence forward per request, with plain attention, of a
    float32 copy of the served weights (or of ``state``) on prompt +
    output: at every generated position the emitted token must be the
    reference's argmax, or trail its top logit by less than ``tie`` (a
    bf16 near-tie; TEACHER_GAP unless a phase measured its model's
    own, `bf16_tie_gap`)."""
    ref = float32_copy(torch, model, state)
    worst, near = 0.0, 0
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            seq = torch.tensor([p + o[:-1]], device=ref.device)
            caches = ref.gen_static_cache(1, seq.shape[1])
            hidden = ref.gpt.prefill(seq, caches)
            logits = ref._logits(hidden[0, len(p) - 1:])
            top = logits.argmax(dim=-1)
            got = torch.tensor(o, device=ref.device)
            gap = (logits.gather(1, top[:, None])
                   - logits.gather(1, got[:, None]))[:, 0]
            near += int((top != got).sum())
            worst = max(worst, gap.max().item())
    del ref
    check(worst < tie,
          f"an emitted token trails the reference's top logit by {worst}")
    print(f"  teacher-forced check ok (float32 reference): {near} of "
          f"{sum(map(len, outs))} tokens differ from its argmax, all within "
          f"{worst:.4f} < {tie:.4f} of its top logit")


def bf16_tie_gap(torch, model, prompts, outs, mode=None):
    """The near-tie allowance of a teacher check for ``model``'s own bf16
    numerics: max(TEACHER_GAP, 2e), e the largest |logit| error of the
    bf16 model against its float32 copy, both teacher-forced through the
    same computation with plain attention and no paged kernel on prompt +
    output of every request (``mode``: K/V through that page dtype's
    round trip, `quant_teacher_logits`): two logits each off by at most
    e can swap where they lie within 2e. TEACHER_GAP is that reading for
    gpt3-1.3b; a deeper, wider model rounds more."""
    ref = float32_copy(torch, model)
    err = 0.0
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            logits = []
            for m in (model, ref):
                if mode is None:
                    seq = torch.tensor([p + o[:-1]], device=ref.device)
                    hidden = m.gpt.prefill(seq, m.gen_static_cache(
                        1, seq.shape[1]))
                    logits.append(m._logits(hidden[0, len(p) - 1:]).float())
                else:
                    logits.append(quant_teacher_logits(
                        torch, m, p, o, getattr(torch, QUANT_DTYPES[mode])
                    ).float())
            err = max(err, (logits[0] - logits[1]).abs().max().item())
    del ref
    gap = max(TEACHER_GAP, 2 * err)
    print(f"  the bf16 model's own logit error against its float32 copy "
          f"(plain attention, {mode or 'no'} pages' round trip): {err:.4f} "
          f"at most; near-tie allowance max({TEACHER_GAP}, 2 x {err:.4f}) "
          f"= {gap:.4f}")
    return gap


def profile_decode(torch, eng, prompts, steps=8):
    """Where a decode step's time goes: ``steps`` steps of a full engine
    (every slot active) under torch.profiler."""
    for p in prompts[:SLOTS]:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                            # admits every slot, one decode
    profile_steps(torch, eng.step, steps, "full decode steps")


def profile_steps(torch, fn, steps, what, families=None, absent=()):
    """``steps`` calls of ``fn`` under torch.profiler: prints the device's
    busy share of the wall time, the kernels that take the most of it
    and, for each of ``families`` (label -> substrings of kernel names),
    the device time of the kernels it names; fails if a kernel whose name
    holds one of ``absent`` ran. Returns ``(wall ms/step, busy
    ms/step)``."""
    def run():
        for _ in range(steps):
            fn()

    wall_us, busy_us, per, kernels, calls, host = profile_totals(torch, run)
    ran = [k for k in per if any(x in k for x in absent)]
    check(not ran, f"{what}: kernels {ran} ran, none of {absent} should")
    print(f"  profile of {steps} {what}: wall "
          f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
          f"{busy_us / steps / 1e3:.3f} ms/step "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for key, t in sorted(per.items(), key=lambda kv: -kv[1])[:6]:
        share = 100 * t / busy_us if busy_us else 0.0
        print(f"    {t / steps / 1e3:8.4f} ms/step {share:5.1f}%  {key[:90]}")
    for label, parts in (families or {}).items():
        t = sum(v for k, v in per.items() if any(x in k for x in parts))
        share = 100 * t / busy_us if busy_us else 0.0
        print(f"    {label}: {t / steps / 1e3:.4f} ms/step ({share:.1f}% of "
              "device busy)")
    print(f"    {kernels / steps:.0f} kernels/step on the device; host: "
          f"{calls / steps:.1f} launch calls/step ({' + '.join(HOST_LAUNCH_CALLS)}"
          "); most self CPU time: " + ", ".join(
              f"{key} {t / steps / 1e3:.3f} ms" for key, t in host))
    return wall_us / steps / 1e3, busy_us / steps / 1e3


def qkv_families(label):
    """The profile's kernel families of B1 or B5 (``label``): the qkv
    forward and B2's backward with its pre- and post-pass."""
    return {f"{label} kernels (qkv forward; B2's backward, its pre- and "
            "post-pass)": QKV_KERNELS,
            "of which the backward (bwd_wg_kernel)": QKV_KERNELS[1:2],
            "and its pre- and post-pass": QKV_KERNELS[2:]}


# ---------------------------------------------------------------- the update
# the update's kernel by its name in a profile (csrc/multi_tensor_adam.cu)
ADAM_FAMILY = {"the update (multi_tensor_adam: adam_kernel)":
               ("adam_kernel<",)}
# the Adam hyperparameters of every training phase (AdamW's defaults)
ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
# the rate scales the kernel phase's mixed-rate cases give its entries
# in turn (phase 24's weights take 0.5)
ADAM_RATES = (0.5, 1.0, 2.0, 0.1)
# replays against eager steps: after GRAPH_CHECK_STEPS steps from one
# state, each tensor of the replays' state lies within the larger of two
# bounds of its own: GRAPH_SPREAD times its largest distance between
# GRAPH_EAGER_RUNS eager runs (each run against the first), and a floor.
# A slot's distance is its largest elementwise gap, its floor
# GRAPH_FLOOR_ULPS ulps of its dtype at its largest magnitude. A param's
# distance is that of its update: |p_replay - p_eager| / |p_eager -
# p_start| (two-norms), its floor GRAPH_PARAM_REL. The dq atomics
# (ROADMAP C.3) make every run a sample of one rounding noise, and
# replays part from eager runs more than eager runs part from each
# other. On an H100: at gpt3-1.3b's step two eager runs often agree bit
# for bit while the replays lie 1.5e-11 to 4.7e-10 away, in the second
# moments, and the update of a top layer's qkv weight up to 6.7% from
# the eager one's (its q and k thirds: a small true gradient); at
# Gemma-2B's widths (phase 13) the updates of the top layers' q and k
# weights part by 5-11.5% between any two runs, so the spread sets
# their bound, and with 2 eager runs in place of 5 the gate failed 4 of
# 6 reps (the moments of the q and k biases too). The params' floor is
# about twice the largest of those readings; a doubled learning rate
# puts a param's update 1.87-2.29 away. A param's elementwise
# gap says nothing of its update: lr 1e-4 moves a bf16 weight of 0.02
# by about one ulp, so a floor in ulps at the largest magnitude passed
# a replay that wrote no param or doubled the learning rate, while
# either puts the relative distance of the update near 1. The key
# projections' biases are left out of the params' comparison
# (`key_bias_masks`): their true gradient is exactly zero, so Adam moves
# them about lr either way on round-off.
# Two controls must fail the bound: the replays with their second update
# skipped (on the slots) and at twice the learning rate (on the params).
GRAPH_CHECK_STEPS, GRAPH_SPREAD = 3, 2.0
GRAPH_EAGER_RUNS, GRAPH_FLOOR_ULPS, GRAPH_PARAM_REL = 5, 4, 0.25
# peak memory of the timed replays (live tensors plus the graph's pool)
# against the eager step's at phase 5's shape, at most this ratio
GRAPH_MEMORY_RATIO = 1.10


def ulps_apart(torch, a, b):
    """``(largest distance in ulps of a's dtype, elements equal)``
    between two tensors of one dtype, each element's ulp taken at the
    larger of its two magnitudes."""
    x, y = a.float(), b.float()
    big = torch.maximum(x.abs(), y.abs()).clamp(
        min=torch.finfo(a.dtype).tiny)
    ulp = torch.finfo(a.dtype).eps * torch.exp2(torch.floor(torch.log2(big)))
    return ((x - y).abs() / ulp).max().item(), int((a == b).sum().item())


def adam_entries(torch, mta, params, grads, pdt, gdt, sdt, master, wd,
                 rates=(1.0,)):
    """`AdamEntry`s over ``params`` / ``grads`` (name -> tensor) in the
    given dtypes (copies), with moments as one step of Adam leaves them
    (m = 0.1 g, v = 0.001 g^2); the i-th entry's rate scale is
    ``rates[i % len(rates)]``."""
    out = []
    for i, (n, p) in enumerate(params.items()):
        g = grads[n]
        out.append(mta.AdamEntry(
            p.to(pdt, copy=True), g.to(gdt, copy=True),
            (0.1 * g.float()).to(sdt), (1e-3 * g.float().square()).to(sdt),
            p.float() if master else None, wd, rates[i % len(rates)]))
    return out


def copy_entries(torch, mta, entries):
    return [mta.AdamEntry(*(t.clone() if isinstance(t, torch.Tensor) else t
                            for t in e)) for e in entries]


def adam_kernel_phase(torch, seed):
    """`multi_tensor_adam` against its plain version (`adam_reference`) on
    gpt3-1.3b's parameter list and one step's gradients (b8 x s1024 from
    ``seed``), at step count 1: AdamW and Adam with L2 decay on bf16
    params, grads and moments (the training phases' form); bf16 params
    with float32 moments; float32 params and moments; float32 params
    with bf16 moments; a global-norm clip's scale; multi_precision
    (float32 masters, float32 grads and moments); and the bf16 and the
    multi_precision forms with mixed rate scales (`ParamAttr`'s
    ``learning_rate``: ADAM_RATES in turn over the entries, one launch).
    Every stored element (params, moments, masters) within 1 ulp of its
    dtype, the share equal bit for bit printed. Then the optimizer's ``apply_gradients``
    with ``found_inf`` set (nothing written, the step count unchanged)
    and clear. Then the bf16 AdamW update timed beside the plain version,
    the library's ``torch._fused_adamw_`` over the same lists (the same
    function, its bias correction rounded in another way; timed only)
    and the bound. Returns the kernel's record."""
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt_config(MODEL)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    model.train()
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                        generator=g, device="cuda")
    step = SpmdTrainStep(model, gpt_loss_fn, AdamW())
    params = {n: p.detach() for n, p in model.named_parameters()}
    _, grads = step.loss_and_grads(
        params, {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}, seed)
    del step
    n_el = sum(p.numel() for p in params.values())
    print(f"  {MODEL}: {len(params)} tensors, {n_el} parameters, one step's "
          f"gradients at b{TRAIN_B} x s{TRAIN_S}")
    lr = torch.tensor(TRAIN_LR, device="cuda")
    t = torch.ones((), dtype=torch.int32, device="cuda")
    tables = mta.AdamTables()
    bf, f32 = torch.bfloat16, torch.float32
    clip = ClipGradByGlobalNorm(1.0).scale(grads)
    mixed = f"mixed rate scales {ADAM_RATES}"
    cases = [("AdamW, bf16 params/grads/moments", bf, bf, bf, False, True,
              None),
             ("Adam + L2, bf16 params/grads/moments", bf, bf, bf, False,
              False, None),
             ("AdamW, bf16 params/grads, f32 moments", bf, bf, f32, False,
              True, None),
             ("AdamW, f32 params/grads/moments", f32, f32, f32, False, True,
              None),
             ("AdamW, f32 params/grads, bf16 moments", f32, f32, bf, False,
              True, None),
             ("AdamW, bf16, global-norm clip scale "
              f"{clip.item():.4g}", bf, bf, bf, False, True, clip),
             ("AdamW, multi_precision (f32 masters, grads, moments)", bf,
              f32, f32, True, True, None),
             (f"AdamW, bf16 params/grads/moments, {mixed}", bf, bf, bf,
              False, True, None, ADAM_RATES),
             (f"AdamW, multi_precision, {mixed}", bf, f32, f32, True, True,
              None, ADAM_RATES)]
    worst_err = 0.0
    kw = dict(beta1=ADAM_BETA1, beta2=ADAM_BETA2, epsilon=ADAM_EPS)
    for label, pdt, gdt, sdt, master, adamw, scale, *rates in cases:
        kern = adam_entries(torch, mta, params, grads, pdt, gdt, sdt, master,
                            TRAIN_WD, *rates)
        plain = copy_entries(torch, mta, kern)
        mta.multi_tensor_adam(kern, lr, t, adamw=adamw, clip_scale=scale,
                              tables=tables, **kw)
        mta.adam_reference(plain, lr, t, adamw=adamw, clip_scale=scale, **kw)
        torch.cuda.synchronize()
        worst, equal, total = 0.0, 0, 0
        for a, b in zip(kern, plain):
            for x, y in ((a.p, b.p), (a.m, b.m), (a.v, b.v),
                         (a.master, b.master)):
                if x is None:
                    continue
                u, e = ulps_apart(torch, x, y)
                worst, equal, total = max(worst, u), equal + e, \
                    total + x.numel()
                if label.startswith("AdamW, bf16 params/grads/moments"):
                    worst_err = max(worst_err, (x.float() - y.float())
                                    .abs().max().item())
        check(worst <= 1.0, f"multi_tensor_adam ({label}): a stored element "
              f"lies {worst} ulps from the plain version's")
        print(f"  {label}: within {worst:.0f} ulp (<= 1) of the plain "
              f"version, {equal / total:.6f} of {total} stored elements "
              "equal bit for bit  ok")
        del kern, plain
        torch.cuda.empty_cache()

    # the skip: the optimizer's update with found_inf set, then clear
    opt = AdamW(learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
    live = {n: p.clone() for n, p in params.items()}
    state = opt.init_state(live, slot_dtype=bf)
    kept = [p.clone() for p in live.values()]
    opt.apply_gradients(live, grads, state, found_inf=torch.ones(
        (), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    check(int(state["step"]) == 0 and all(
        torch.equal(a, b) for a, b in zip(kept, live.values())) and all(
        not s.any() for v in state["slots"].values() for s in v.values()),
        "multi_tensor_adam with found_inf wrote or advanced the step count")
    opt.apply_gradients(live, grads, state, found_inf=torch.zeros(
        (), dtype=torch.int32, device="cuda"))
    check(int(state["step"]) == 1 and not all(
        torch.equal(a, b) for a, b in zip(kept, live.values())),
        "multi_tensor_adam with found_inf clear did not update")
    print("  found_inf set: params, moments and the step count unchanged; "
          "clear: updated, step count 1  ok")
    del opt, live, state, kept

    main = adam_entries(torch, mta, params, grads, bf, bf, bf, False,
                        TRAIN_WD)
    run = dict(adamw=True, tables=tables, **kw)
    ms = time_ms(lambda: mta.multi_tensor_adam(main, lr, t, **run), 10)
    plain_ms = time_ms(lambda: mta.adam_reference(main, lr, t, adamw=True,
                                                  **kw), 3, 1)
    steps = [torch.zeros((), device="cuda") for _ in main]

    def library():
        torch._fused_adamw_(
            [e.p for e in main], [e.g for e in main], [e.m for e in main],
            [e.v for e in main], [], steps, lr=TRAIN_LR, beta1=ADAM_BETA1,
            beta2=ADAM_BETA2, weight_decay=TRAIN_WD, eps=ADAM_EPS,
            amsgrad=False, maximize=False)

    library_ms = time_ms(library, 10)
    nbytes = mta.update_bytes(main)
    flops = 25 * n_el
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  multi_tensor_adam, AdamW over {MODEL}'s {len(main)} bf16 "
          f"tensors ({n_el} parameters, one launch): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (torch._fused_adamw_) "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes} bytes, {flops} flops)")
    del main, model, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "multi_tensor_adam", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/multi_tensor_adam.cu",
            "replaces": "paddle_tpu/optimizer/optimizers.py:64",
            "max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def train_on_graphs(torch, step, params, opt_state, batches, label):
    """The training phases' timed run: the first call at the batches'
    signature builds the step's CUDA graph (its warm-up is that call's
    step); then, with the launch counts zeroed and the sentinel armed,
    TRAIN_STEPS timed calls replay it. Each call's aux values (the loss
    function's) are kept and must still read their own step after the
    next replay. Returns the run's numbers: losses, step times, wall,
    launch counts, capture_s, the bytes the graph holds between calls
    (its pool: reserved memory after the build less before it), the peak
    of the replays (live tensors plus the pool) and the live bytes before
    the build."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.observability import get_sentinel

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    loss, params, opt_state = step(params, opt_state, batches[0], 0)
    first = loss.item()
    first_s = time.perf_counter() - t0
    auxes = [step.last_aux]
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved
    capture_s = step.captured(batches[0]).capture_s
    kernels.reset_kernel_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], [first]
    with get_sentinel().armed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, TRAIN_STEPS + 1):
            ts = time.perf_counter()
            kept = {k: v.clone() for k, v in auxes[-1].items()}
            loss, params, opt_state = step(params, opt_state, batches[i], i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - ts)
            losses.append(loss.item())
            check(all(torch.equal(kept[k], v) for k, v in auxes[-1].items()),
                  f"{label}: a kept aux value changed at the next replay")
            auxes.append(step.last_aux)
        wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated() + held
    snap = step.metrics_snapshot()
    check(snap["xla_traces"] == 1, f"{label}: {snap['xla_traces']} builds "
          "of the step at one batch signature, not 1")
    check(counts["multi_tensor_adam"] == TRAIN_STEPS,
          f"{label}: multi_tensor_adam launched "
          f"{counts['multi_tensor_adam']} times, not once a step")
    print(f"  first call (warm-up step, then the capture): {first_s:.3f} s, "
          f"capture_s {capture_s:.3f}; {snap['executable']}: xla_traces "
          f"{snap['xla_traces']} (armed sentinel), steps {snap['steps']}, "
          f"tokens {snap['tokens']}")
    return {"losses": losses, "times": times, "wall": wall,
            "counts": counts, "held": held, "peak": peak, "base": base,
            "auxes": auxes, "first_s": first_s}


def state_gaps(torch, a, b, masks=None, start=None):
    """Per tensor of two states, the distance of ``a``'s from ``b``'s,
    the elements of its mask (`key_bias_masks`) left out: for a tensor
    with a ``start`` (a param) the two-norm of a - b over that of
    b - start, how far a's update lies from b's relative to b's; for
    the others (slots) the largest elementwise gap."""
    gaps = []
    for i, (x, y) in enumerate(zip(a, b)):
        m = masks[i] if masks else None
        s = start[i] if start else None
        d = x.float() - y.float()
        if s is None:
            gaps.append((d.masked_fill(m, 0) if m is not None else d)
                        .abs().max())
            continue
        u = y.float() - s.float()
        if m is not None:
            d, u = d.masked_fill(m, 0), u.masked_fill(m, 0)
        nd, nu = torch.linalg.vector_norm(d), torch.linalg.vector_norm(u)
        gaps.append(torch.where(nd == 0, 0.0, nd / nu))
    return torch.stack(gaps).tolist()


def param_starts(names, state):
    """Per tensor of a training state, its own value where it is a param
    (the start its update is measured from, `state_gaps`), else None."""
    return [t if n.startswith("param/") else None
            for n, t in zip(names, state)]


def key_bias_masks(torch, step, items):
    """Per ``(name, tensor)`` of a training state, a bool mask of the
    elements whose true gradient is exactly zero, or None: the params of
    the key projections' biases (``k_proj.bias``, the k third of the
    fused layers' ``qkv_bias`` and of GPT's pair-major
    ``qkv_proj.bias``), since a shift of every score of a softmax row by
    q.b_k leaves it as it is. Their gradients are round-off, which Adam
    turns into steps of about lr either way, so two runs' values of them
    say nothing of the step (the parity tests compare them as grads);
    their slots stay in the comparison."""
    from paddle_tpu_torch.models.gpt import unpack_qkv_pair_major

    out = []
    for name, t in items:
        pname = name[len("param/"):] if name.startswith("param/") else ""
        mask = None
        if pname.endswith("k_proj.bias"):
            mask = torch.ones_like(t, dtype=torch.bool)
        elif pname.endswith("qkv_bias"):                 # [3, H, D]
            mask = torch.zeros_like(t, dtype=torch.bool)
            mask[1] = True
        elif pname.endswith("qkv_proj.bias"):            # pair-major [3HD]
            att = step.model.get_submodule(pname.rsplit(".", 2)[0])
            idx = torch.arange(t.numel(), device=t.device).reshape(1, 1, -1)
            _, k, _ = unpack_qkv_pair_major(idx, att.num_heads, att.head_dim)
            mask = torch.zeros(t.numel(), dtype=torch.bool, device=t.device)
            mask[k.reshape(-1)] = True
        out.append(mask)
    return out


def state_floor(torch, state, start):
    """Per tensor, the floor of its C.7 bound: GRAPH_PARAM_REL for a
    param (a tensor with a ``start``), else GRAPH_FLOOR_ULPS ulps of its
    dtype at its largest magnitude (0 for an integer tensor: it must
    match exactly)."""
    out = []
    for t, s in zip(state, start):
        if s is not None:
            out.append(GRAPH_PARAM_REL)
        elif not t.is_floating_point():
            out.append(0.0)
        else:
            fi = torch.finfo(t.dtype)
            big = max(t.float().abs().max().item(), fi.tiny)
            out.append(GRAPH_FLOOR_ULPS * fi.eps
                       * 2.0 ** math.floor(math.log2(big)))
    return out


def state_bound(spread, floor):
    """The C.7 bound, tensor by tensor: the larger of GRAPH_SPREAD times
    the runs' own spread and the floor."""
    return [max(GRAPH_SPREAD * s, f) for s, f in zip(spread, floor)]


def worst_against(names, gaps, bound):
    """``(name, gap, bound, gap / bound)`` of the tensor nearest its
    bound (or furthest past it); gaps of 0 against a bound of 0 pass."""
    best = None
    for n, g, b in zip(names, gaps, bound):
        r = g / b if b > 0 else (math.inf if g > 0 else 0.0)
        if best is None or r > best[3]:
            best = (n, g, b, r)
    return best


def train_graph_gate(torch, step, params, opt_state, batches, run):
    """The readings of the replay-against-eager gate (`train_graph_check`)
    and its two controls: from one saved state and keys 200..,
    GRAPH_CHECK_STEPS replays, GRAPH_EAGER_RUNS eager runs
    (`SpmdTrainStep.run_eager`), the replays with their second update
    skipped and the replays at twice the learning rate. Returns the first
    losses (replay, eager), each tensor's distance of the replays from
    the first eager run (`state_gaps`), the eager spread after each
    further eager run (``spreads``, the last the gate's), the floor, the
    bound, the worst param and the worst slot of the replays, the worst
    slot of the first control and the worst param of the second, and
    the eager step's peak memory (live tensors). Leaves the saved state
    in place."""
    from paddle_tpu_torch.observability import get_sentinel

    items = step.state_items(params, opt_state)
    names = [n for n, _ in items]
    flat = [t for _, t in items]
    masks = key_bias_masks(torch, step, items)
    saved = [t.clone() for t in flat]
    start = param_starts(names, saved)

    def restore():
        for t, v in zip(flat, saved):
            t.copy_(v)

    def steps(fn, skip=None):
        restore()
        losses = [fn(params, opt_state, batches[i], 200 + i)[0]
                  for i in range(GRAPH_CHECK_STEPS) if i != skip]
        torch.cuda.synchronize()
        return losses, [t.clone() for t in flat]

    def gaps_of(state, ref):
        return state_gaps(torch, state, ref, masks, start)

    with get_sentinel().armed():
        g_loss, g_state = steps(step)
    restore()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step.run_eager(params, opt_state, batches[0], 200)
    torch.cuda.synchronize()
    eager_peak = run["base"] + torch.cuda.max_memory_allocated() - before
    e_loss, e_state = steps(step.run_eager)
    gaps = gaps_of(g_state, e_state)
    del g_state
    spreads, spread = [], [0.0] * len(flat)
    for _ in range(GRAPH_EAGER_RUNS - 1):
        _, other = steps(step.run_eager)
        spread = [max(a, b) for a, b in zip(spread, gaps_of(other, e_state))]
        spreads.append(spread)
        del other
    with get_sentinel().armed():
        _, other = steps(step, skip=1)
        skip_gaps = gaps_of(other, e_state)
        del other
        lr = step.optimizer.get_lr()
        step.optimizer.set_lr(2 * lr)
        try:
            _, other = steps(step)
        finally:
            step.optimizer.set_lr(lr)
        lr_gaps = gaps_of(other, e_state)
        del other
    floor = state_floor(torch, e_state, start)
    bound = state_bound(spread, floor)
    restore()
    del saved, e_state, start
    torch.cuda.empty_cache()
    pi = [i for i, n in enumerate(names) if n.startswith("param/")]
    # the slots' worst is read on the float tensors alone: the step
    # count, an integer that must match exactly, would catch a skipped
    # update anyway
    si = [i for i, t in enumerate(flat)
          if t.is_floating_point() and i not in pi]

    def worst(idx, g, bd=bound):
        return worst_against([names[i] for i in idx], [g[i] for i in idx],
                             [bd[i] for i in idx])

    return {"g_loss": g_loss[0], "e_loss": e_loss[0], "names": names,
            "gaps": gaps, "spreads": spreads, "floor": floor,
            "bound": bound, "params": pi, "slots": si, "worst_of": worst,
            "worst": worst(pi, gaps), "worst_slot": worst(si, gaps),
            "control": worst(si, skip_gaps), "control_lr": worst(pi, lr_gaps),
            "masked": sum(int(m.sum()) for m in masks if m is not None),
            "eager_peak": eager_peak}


def train_graph_check(torch, step, params, opt_state, batches, run, label,
                      memory_gate=False):
    """Replays against eager steps from the same state and keys
    (`train_graph_gate`): the first step's loss bit for bit; then every
    tensor of params and slots within its C.7 bound (the larger of
    GRAPH_SPREAD times its eager spread and its floor), and the two
    controls (the replays with one update skipped, read on the slots,
    and at twice the learning rate, read on the params) outside it. The
    eager step's peak memory is printed beside the replays' (``run``);
    with ``memory_gate`` (phase 5's shape) the replays' may be at most
    GRAPH_MEMORY_RATIO of it."""
    r = train_graph_gate(torch, step, params, opt_state, batches, run)
    check(torch.equal(r["g_loss"], r["e_loss"]), f"{label}: the replay's "
          f"first loss {r['g_loss'].item()!r} differs from the eager "
          f"step's {r['e_loss'].item()!r}")
    for key, what in (("worst", "param update"), ("worst_slot", "slot")):
        name, gap, bound, ratio = r[key]
        check(ratio <= 1.0, f"{label}: after {GRAPH_CHECK_STEPS} steps the "
              f"replays' {what} {name} lies {gap} from the eager run's, "
              f"beyond its bound {bound}")
    for key, what in (("control", "the second update skipped"),
                      ("control_lr", "twice the learning rate")):
        name, gap, bound, ratio = r[key]
        check(ratio > 1.0, f"{label}: the control ({what}) passed the gate:"
              f" its worst tensor {name} lies {gap} within its bound {bound}")
    eager_peak = r["eager_peak"]
    ratio_mem = run["peak"] / eager_peak
    check(not memory_gate or ratio_mem <= GRAPH_MEMORY_RATIO, f"{label}: "
          f"the replays' peak memory {run['peak']} bytes is {ratio_mem:.3f} "
          f"x the eager step's {eager_peak}")
    floored = sum(f >= GRAPH_SPREAD * s for s, f in zip(r["spreads"][-1],
                                                        r["floor"]))

    def reading(key):
        name, gap, bound, ratio = r[key]
        return f"{name} {gap:.3e} of {bound:.3e} ({ratio:.3f})"

    print(f"  graph against eager ({GRAPH_CHECK_STEPS} steps, keys 200-"
          f"{199 + GRAPH_CHECK_STEPS}): first loss bit for bit "
          f"({r['g_loss'].item():.6f}); tensor by tensor within max("
          f"{GRAPH_SPREAD} x the spread of {GRAPH_EAGER_RUNS} eager runs, "
          f"a floor of {GRAPH_PARAM_REL} of the update for params and "
          f"{GRAPH_FLOOR_ULPS} ulps at the largest magnitude for slots): "
          f"worst param {reading('worst')}, worst slot "
          f"{reading('worst_slot')}; {sum(g > 0 for g in r['gaps'])} of "
          f"{len(r['gaps'])} tensors apart, the floor the bound of "
          f"{floored}; {r['masked']} key-bias param elements left out  ok")
    print(f"  controls: the second update skipped, worst slot "
          f"{reading('control')}; twice the learning rate, worst param "
          f"{reading('control_lr')}  both caught")
    print(f"  memory: graph pool held between calls {run['held'] / 2 ** 30:.3f}"
          f" GiB; peak over the replays (live + pool) "
          f"{run['peak'] / 2 ** 30:.3f} GiB against the eager step's "
          f"{eager_peak / 2 ** 30:.3f} GiB ({ratio_mem:.3f} x"
          + (f", <= {GRAPH_MEMORY_RATIO})  ok" if memory_gate else
             "; held at phase 5's shape only)"))


# ---------------------------------------------------------------- training
def train_phase(torch, seed, card):
    """gpt3-1.3b at full width and depth trains through `SpmdTrainStep`
    on the card (bench.py's flagship configuration): b8 x s1024 of
    token ids from ``seed``, dropout 0, bf16 params and bf16 AdamW
    moments. First the float32-reference check, then the step's graph
    built by its first call and TRAIN_STEPS timed replays under the
    armed sentinel with the launch counts zeroed just before them, the
    graph against eager steps, then two steps under the profiler (the
    update's device time apart). Returns the flash kernels' and the
    update's launch counts of the timed steps."""
    import dataclasses

    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(gpt_config(MODEL), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    gc.collect()                 # what the earlier phases left in cycles
    torch.cuda.empty_cache()
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    model.train()
    step = SpmdTrainStep(model, gpt_loss_fn,
                         AdamW(learning_rate=TRAIN_LR, weight_decay=TRAIN_WD))
    params, opt_state = step.init(slot_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = [torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                            generator=g, device="cuda")
              for _ in range(TRAIN_STEPS + 3)]
    batches = [{"input_ids": t[:, :-1], "labels": t[:, 1:]} for t in tokens]
    print(f"  {MODEL}: {cfg.num_hidden_layers} layers, h={cfg.hidden_size}, "
          f"{cfg.num_attention_heads} heads, d={cfg.head_dim}, dropout 0; "
          f"b{TRAIN_B} x s{TRAIN_S}, bf16 params, bf16 AdamW moments, lr "
          f"{TRAIN_LR}, wd {TRAIN_WD}; one CUDA graph a batch signature")
    last = cfg.num_hidden_layers - 1
    ref = GPTForPretraining(dataclasses.replace(
        cfg, use_flash_attention=False), dtype="float32", seed=seed)
    float32_copy_check(
        torch, step, params, {k: v[:2] for k, v in batches[0].items()}, ref,
        gpt_loss_fn, [f"gpt.h.{i}.{m}.weight" for i in (0, last)
                      for m in ("attn.qkv_proj", "mlp.fc_in")], "GPT")
    del ref
    model.train()

    run = train_on_graphs(torch, step, params, opt_state, batches, "GPT")
    first, losses, times, counts = (run["losses"][0], run["losses"],
                                    run["times"], run["counts"])
    check(abs(first - math.log(cfg.vocab_size)) < 0.5,
          f"first loss {first} is not within 0.5 of ln(V) = "
          f"{math.log(cfg.vocab_size):.4f}")
    want = TRAIN_STEPS * cfg.num_hidden_layers
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for name in ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd"):
        check(counts[name] == want, f"{name} launched {counts[name]} times, "
              f"steps x layers = {want}")
    for name in ("paged_attention", "flash_attention_fwd",
                 "flash_attention_bwd"):
        check(counts[name] == 0, f"GPT training launched {name}: {counts}")
    tok_s = TRAIN_B * TRAIN_S * TRAIN_STEPS / run["wall"]
    flops_per_tok = (6 * cfg.num_params(include_embeddings=False)
                     + 12 * cfg.num_hidden_layers * cfg.hidden_size
                     * TRAIN_S)
    mfu = tok_s * flops_per_tok / BF16_FLOPS_PER_S
    p50 = sorted(times)[len(times) // 2] * 1e3
    print(f"  losses {[round(x, 4) for x in losses]} (first within 0.5 of "
          f"ln(V) = {math.log(cfg.vocab_size):.4f}, all finite)")
    print(f"  launches {counts}: flash fwd = bwd = steps x layers = {want}, "
          "the update once a step (through the replays)")
    print(f"  {card}: {tok_s:.1f} tokens/s, step {p50:.3f} ms p50 (steps "
          f"{[round(t * 1e3, 3) for t in times]} ms), peak memory over the "
          f"replays {run['peak'] / 2 ** 30:.3f} GiB (live tensors + the "
          f"graph's pool; {run['base'] / 2 ** 30:.3f} GiB of weights, "
          f"moments and batches), MFU {mfu:.4f} ({flops_per_tok} "
          "flops/token over 989 TFLOP/s)")
    train_graph_check(torch, step, params, opt_state, batches, run, "GPT",
                      memory_gate=True)
    it = iter(range(100))

    def one():
        nonlocal params, opt_state
        i = next(it) % len(batches)
        _, params, opt_state = step(params, opt_state, batches[i], 100 + i)

    profile_steps(torch, one, 2, "training steps",
                  {**qkv_families("B1"), **ADAM_FAMILY})
    del model, step, params, opt_state, batches, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in ("flash_attention_qkv_fwd",
                                   "flash_attention_qkv_bwd",
                                   "multi_tensor_adam")}


# ---------------------------------------------------------------- BERT
# the three BERT-large runs: masked batches through the unfused layers
# (B2), and full-length unmasked batches (BASELINE row 4,
# benchmarks/bench_bert_fused.py:33-43) through the unfused layers (the
# qkv-direct branch: B5) and through BertModel(fuse=True) (B1 on the
# pair-major weight shuffle). "kernels": the attention kernels the timed
# steps must launch exactly steps x layers times; every other kernel must
# not launch
BERT_VARIANTS = {
    "masked": dict(fuse=False, masked=True, label="B2",
                   kernels=("flash_attention_fwd", "flash_attention_bwd")),
    "unfused": dict(fuse=False, masked=False, label="B5",
                    kernels=("flash_attention_qkv3_fwd",
                             "flash_attention_qkv3_bwd")),
    "fused": dict(fuse=True, masked=False, label="B1",
                  kernels=("flash_attention_qkv_fwd",
                           "flash_attention_qkv_bwd")),
}


def bert_batch(torch, cfg, g, masked=True):
    """One pretraining batch on the card from generator ``g``: token ids
    in [0, V), MLM labels (the token) on 15% of the real positions and
    -100 elsewhere, random NSP labels. ``masked``: per-row lengths in
    [384, 512) (pad id 0 past each) and the bool [B, 1, 1, S] key-padding
    mask; else every row 512 real tokens and no mask."""
    lens = (torch.randint(BERT_MIN_LEN, BERT_S, (BERT_B,), generator=g,
                          device="cuda") if masked else
            torch.full((BERT_B,), BERT_S, device="cuda"))
    real = torch.arange(BERT_S, device="cuda")[None, :] < lens[:, None]
    ids = torch.randint(0, cfg.vocab_size, (BERT_B, BERT_S), generator=g,
                        device="cuda") * real
    pick = real & (torch.rand((BERT_B, BERT_S), generator=g, device="cuda")
                   < BERT_MLM)
    batch = {"input_ids": ids,
             "mlm_labels": torch.where(pick, ids, torch.full_like(ids, -100)),
             "nsp_labels": torch.randint(0, 2, (BERT_B,), generator=g,
                                         device="cuda")}
    if masked:
        batch["attention_mask"] = real[:, None, None, :]
    return batch


def bert_loss_fn(model, state, batch):
    """MLM cross-entropy (ignore_index -100) plus NSP cross-entropy of
    `BertForPretraining` run with ``state`` (and the batch's
    attention_mask, when it has one), with the two parts as the step's
    aux values (`SpmdTrainStep.last_aux` copies them out of each
    replay)."""
    from torch.func import functional_call

    from paddle_tpu_torch.nn.functional import cross_entropy

    logits, nsp = functional_call(
        model, state, (batch["input_ids"],),
        {"attention_mask": batch.get("attention_mask")})
    mlm = cross_entropy(logits, batch["mlm_labels"], ignore_index=-100)
    nsp_loss = cross_entropy(nsp, batch["nsp_labels"])
    return mlm + nsp_loss, {"mlm": mlm.detach(), "nsp": nsp_loss.detach()}


def bert_model(cfg, variant, dtype, seed):
    """The variant's `BertForPretraining`, drawn from ``seed``."""
    from paddle_tpu_torch.models.bert import BertForPretraining

    return BertForPretraining(cfg, fuse=BERT_VARIANTS[variant]["fuse"],
                              dtype=dtype, seed=seed)


def bert_phase(torch, seed, card, variant):
    """bert-large at full width and depth pretrains through
    `SpmdTrainStep` (b8 x s512, MLM + NSP, dropout 0.1 hidden and
    attention, bf16 params and AdamW moments, lr 1e-4, wd 0.01) in one of
    BERT_VARIANTS: masked batches (lengths in [384, 512)) or full-length
    unmasked ones, unfused or fused. First the float32-reference check at
    dropout 0, then the step's graph built by its first call and
    TRAIN_STEPS timed replays under the armed sentinel with the launch
    counts zeroed just before them, the graph against eager steps
    (dropout on), then two steps under the profiler. Returns the
    variant's kernels' launch counts of the timed steps."""
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.models.bert import bert_config
    from paddle_tpu_torch.optimizer import AdamW

    v = BERT_VARIANTS[variant]
    cfg = bert_config(BERT_MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    model = bert_model(cfg, variant, "bfloat16", seed)
    step = SpmdTrainStep(model, bert_loss_fn,
                         AdamW(learning_rate=TRAIN_LR, weight_decay=TRAIN_WD))
    params, opt_state = step.init(slot_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed)
    batches = [bert_batch(torch, cfg, g, v["masked"])
               for _ in range(TRAIN_STEPS + 3)]
    rows = (f"lengths in [{BERT_MIN_LEN}, {BERT_S}), MLM on {BERT_MLM:.0%} "
            "of real positions" if v["masked"] else
            f"every row {BERT_S} real tokens, no mask, MLM on "
            f"{BERT_MLM:.0%} of positions")
    layers = "fused layers (fuse=True)" if v["fuse"] else "unfused layers"
    print(f"  {BERT_MODEL}, {layers}: {cfg.num_hidden_layers} layers, h="
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, d="
          f"{cfg.head_dim}, ffn {cfg.intermediate_size}, vocab "
          f"{cfg.vocab_size}, dropout {cfg.hidden_dropout_prob} hidden and "
          f"{cfg.attention_probs_dropout_prob} attention; b{BERT_B} x "
          f"s{BERT_S}, {rows}; bf16 params and AdamW moments, lr "
          f"{TRAIN_LR}, wd {TRAIN_WD}; one CUDA graph a batch signature")
    held, shown = bert_grads_held(cfg, variant)
    ref = bert_model(cfg, variant, "float32", seed)
    for layer in ref.bert.encoder_layers:
        attn = layer.fused_attn if v["fuse"] else layer.self_attn
        attn.use_flash = False
    float32_copy_check(torch, step, params,
                       {k: x[:2] for k, x in batches[0].items()}, ref,
                       bert_loss_fn, held, f"BERT ({variant})", shown)
    del ref

    model.train()
    run = train_on_graphs(torch, step, params, opt_state, batches,
                          f"BERT ({variant})")
    losses, times, counts = run["losses"], run["times"], run["counts"]
    mlms = [a["mlm"].item() for a in run["auxes"]]
    first_mlm = mlms[0]
    check(abs(first_mlm - math.log(cfg.vocab_size)) < 0.5,
          f"first MLM loss {first_mlm} is not within 0.5 of ln(V) = "
          f"{math.log(cfg.vocab_size):.4f}")
    check(len(set(mlms)) == len(mlms), f"the kept MLM parts {mlms} repeat: "
          "a replay overwrote them")
    want = TRAIN_STEPS * cfg.num_hidden_layers
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for name in v["kernels"]:
        check(counts[name] == want, f"{name} launched {counts[name]} times, "
              f"steps x layers = {want}")
    for name, n in counts.items():
        check(name in v["kernels"] or name == "multi_tensor_adam" or n == 0,
              f"BERT ({variant}) launched {name}: {counts}")
    tok_s = BERT_B * BERT_S * TRAIN_STEPS / run["wall"]
    flops_per_tok = (6 * cfg.num_params(include_embeddings=False)
                     + 12 * cfg.num_hidden_layers * cfg.hidden_size * BERT_S)
    mfu = tok_s * flops_per_tok / BF16_FLOPS_PER_S
    p50 = sorted(times)[len(times) // 2] * 1e3
    print(f"  losses {[round(x, 4) for x in losses]} (MLM + NSP; MLM parts "
          f"kept from each step {[round(x, 4) for x in mlms]}, the first "
          f"within 0.5 of ln(V) = {math.log(cfg.vocab_size):.4f}; all "
          "finite)")
    print(f"  launches {counts}: {v['label']} fwd = bwd = steps x layers = "
          f"{want}, the update once a step, every other kernel 0")
    print(f"  {card}: {tok_s:.1f} tokens/s"
          f"{' (padding included)' if v['masked'] else ''}, step "
          f"{p50:.3f} ms p50 (steps {[round(t * 1e3, 3) for t in times]} ms),"
          f" peak memory over the replays {run['peak'] / 2 ** 30:.3f} GiB "
          f"(live tensors + the graph's pool), MFU {mfu:.4f} "
          f"({flops_per_tok} flops/token over 989 TFLOP/s)")
    train_graph_check(torch, step, params, opt_state, batches, run,
                      f"BERT ({variant})")
    it = iter(range(100))

    def one():
        nonlocal params, opt_state
        i = next(it) % len(batches)
        _, params, opt_state = step(params, opt_state, batches[i], 100 + i)

    families = {"B2 kernels (general flash, bf16: forward, backward, its "
                "pre- and post-pass)": B2_KERNELS,
                "of which the backward's pre- and post-pass": B2_KERNELS[2:],
                } if v["masked"] else qkv_families(v["label"])
    profile_steps(torch, one, 2, f"BERT training steps ({variant})",
                  {**families, **ADAM_FAMILY})
    del model, step, params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in v["kernels"]}


def bert_grads_held(cfg, variant):
    """``(held, shown)``: the weight grads the float32 check holds, as
    (label, name, index into the parameter's first dim or None), and the
    one it prints. Unfused: layer 0's q_proj, v_proj and linear1 of
    layers 0 and 23; shown: layer 23's q_proj. Fused: the q and v slices
    of layer 0's qkv_weight, the v slice and ffn.linear1_weight of layer
    23; shown: layer 23's q slice.

    Layer 23's q grad is printed, not held: it passes only through
    ``ds = p*(dp - delta)``, and at random init the deep layers' values
    share a large common part, so ``dp - delta`` cancels and amplifies
    the bf16 rounding of O inside the reference's ``delta =
    rowsum(dO*O)``."""
    last = cfg.num_hidden_layers - 1
    name = "bert.encoder_layers.{}.{}".format
    if not BERT_VARIANTS[variant]["fuse"]:
        held = [(f"{i}.{m}", name(i, f"{m}.weight"), None)
                for i, m in [(0, "self_attn.q_proj")] + [
                    (i, m) for i in (0, last)
                    for m in ("self_attn.v_proj", "linear1")]]
        return held, (f"{last}.self_attn.q_proj",
                      name(last, "self_attn.q_proj.weight"), None)
    qkv = "fused_attn.qkv_weight"
    held = [("0.q", name(0, qkv), 0), ("0.v", name(0, qkv), 2),
            ("0.ffn.linear1", name(0, "ffn.linear1_weight"), None),
            (f"{last}.v", name(last, qkv), 2),
            (f"{last}.ffn.linear1", name(last, "ffn.linear1_weight"), None)]
    return held, (f"{last}.q", name(last, qkv), 0)


# ------------------------------------------- quantized speculative serving
def quant_teacher_logits(torch, ref, prompt, out, dtype):
    """Teacher-forced float32 logits ``[len(out), V]`` of ``ref`` at every
    generated position of one request, as the quantized engine computes
    them: the first token from a plain prompt pass (prefill attends its
    float local cache), every later one from attention over K/V passed
    through the pages' `quantize_tokens` round trip, the prompt's K/V
    from that prompt pass, the generated tokens' from their own layers;
    composed attention (`mt_attention_core`)."""
    from paddle_tpu_torch.kernels.paged_kv import quantize_tokens
    from paddle_tpu_torch.nn.functional import mt_attention_core

    def round_trip(x):
        q, sc = quantize_tokens(x, dtype)
        return (q.float() * sc[..., None]).to(x.dtype)

    gpt, dev = ref.gpt, ref.device
    n_p, n_o = len(prompt), len(out)
    caches = ref.gen_static_cache(1, n_p)
    first = ref._logits(gpt.prefill(torch.tensor([prompt], device=dev),
                                    caches)[0, -1:])
    if n_o == 1:
        return first
    tok = torch.tensor([out[:-1]], device=dev)
    pos = torch.arange(n_p, n_p + n_o - 1, device=dev)[None]
    x = gpt.embeddings(tok, pos)
    cols = torch.arange(n_p + n_o - 1, device=dev)
    valid = (cols[None, :] <= pos[0][:, None])[None, None]
    for layer, (kc, vc) in zip(gpt.h, caches):
        qh, kh, vh = layer.attn._heads(layer.ln_1(x))
        keys = round_trip(torch.cat([kc, kh], dim=2))
        vals = round_trip(torch.cat([vc, vh], dim=2))
        ctx = mt_attention_core(qh, keys, vals, layer.attn.head_dim,
                                valid_mask=valid)
        x = x + layer.attn.out_proj(ctx)
        x = x + layer.mlp(layer.ln_2(x))
    return torch.cat([first, ref._logits(gpt.ln_f(x)[0])])


def quant_teacher(torch, model, prompts, runs, mode, tie=TEACHER_GAP):
    """Holds every greedy request of ``runs`` (``[(label, outs,
    greedy request indices)]``) against `quant_teacher_logits` of a
    float32 copy of ``model``: each emitted token is the teacher's argmax
    or trails its top logit by less than ``tie`` (as `teacher_check`).
    Returns the teacher's logits of each request of the first run, for
    the spec against no-spec comparison."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining

    ref = GPTForPretraining(model.config, dtype="float32")
    ref.load_state_dict(model.state_dict())          # casts bf16 -> f32
    dtype = getattr(torch, QUANT_DTYPES[mode])
    first_logits = {}
    with torch.inference_mode():
        for r, (label, outs, greedy) in enumerate(runs):
            worst, near, n = 0.0, 0, 0
            for i in greedy:
                logits = quant_teacher_logits(torch, ref, prompts[i],
                                              outs[i], dtype)
                if r == 0:
                    first_logits[i] = logits
                top = logits.argmax(dim=-1)
                got = torch.tensor(outs[i], device=ref.device)
                gap = (logits.gather(1, top[:, None])
                       - logits.gather(1, got[:, None]))[:, 0]
                near += int((top != got).sum())
                worst = max(worst, gap.max().item())
                n += len(outs[i])
            check(worst < tie, f"{label}: an emitted token trails "
                  f"the quantized teacher's top logit by {worst}")
            print(f"  {label}: teacher-forced check ok (float32, K/V through "
                  f"the {mode} round trip; the first token against plain "
                  f"K/V): {near} of {n} greedy tokens differ from its argmax,"
                  f" all within {worst:.4f} < {tie:.4f} of its top logit")
    del ref
    return first_logits


def spec_against_plain(torch, plain, spec, logits):
    """The spec_k=4 streams against the spec_k=0 streams of the same int8
    engine: equal, or diverging first at a position where the teacher
    (on the common prefix) puts the two tokens within TEACHER_GAP of each
    other; the rest of such a request is not compared."""
    diverged = []
    for i, (a, b) in enumerate(zip(plain, spec)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        gap = abs(logits[i][j, a[j]] - logits[i][j, b[j]]).item()
        check(gap < TEACHER_GAP, f"request {i}: spec_k=4 and spec_k=0 "
              f"diverge at token {j} ({b[j]} vs {a[j]}), {gap} apart on "
              "the teacher")
        diverged.append((i, j, round(gap, 5)))
    print(f"  spec_k=4 against spec_k=0 (int8): {len(plain) - len(diverged)}"
          f" of {len(plain)} streams equal; diverged (request, token, "
          f"teacher gap < {TEACHER_GAP}): {diverged}")


def spec_phase(torch, seed):
    """Phase 9: gpt3-1.3b, bf16, served by the paged Engine with 1-byte
    KV pages and k = 4 verify windows (8 slots, page 16, max_len 640,
    buckets 128/512; phase 4's traffic). (a) int8 pages, all greedy,
    spec_k=0 then spec_k=4; (b) fp8 pages, spec_k=4, the odd requests
    sampled (temperature 1, fixed seeds). Per run: every request
    completes and every page returns; the quantized kernel launched
    exactly decode steps x layers times (a verify step is one W=5 launch
    a layer), no other kernel. Greedy tokens against the quantized
    teacher; spec_k=4 against spec_k=0. Returns the launch counts of the
    int8 (spec_k=4) and fp8 runs."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import Engine

    cfg = gpt_config(MODEL)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    kw = dict(slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    prompts = phase_prompts(torch, cfg, seed)
    everyone = range(len(prompts))
    sampled = tuple(i for i in everyone if i % 2)
    runs, launches = {}, {}
    for label, mode, k, samp in (("int8 spec_k=0", "int8", 0, ()),
                                 ("int8 spec_k=4", "int8", SPEC_K, ()),
                                 ("fp8 spec_k=4", "fp8", SPEC_K, sampled)):
        warm = Engine(model, kv_quant=mode, spec_k=k, **kw)
        warm.submit(list(range(1, 30)), max_new_tokens=8).result()
        del warm
        eng = Engine(model, kv_quant=mode, spec_k=k, **kw)
        outs, s, wall, counts = serve_traffic(torch, eng, prompts, samp)
        name = "paged_attention_" + mode
        want = s.decode_steps * cfg.num_hidden_layers
        check(counts[name] == want, f"{label}: {name} launched "
              f"{counts[name]} times, decode_steps x layers = {want}")
        check(all(v == 0 for n, v in counts.items() if n != name),
              f"{label}: another kernel launched: {counts}")
        launches[name] = counts[name]
        rate = (f"{s.spec_accept_rate:.4f}" if s.spec_accept_rate is not None
                else "n/a")
        print(f"  {label}: {len(prompts)} requests in {wall:.3f} s, "
              f"{s.prefill_steps} prefills, {s.decode_steps} decode steps, "
              f"{s.tokens_generated} tokens; drafted {s.spec_draft_tokens} "
              f"(greedy {s.spec_drafted_greedy}, sampled "
              f"{s.spec_drafted_sampled}), accepted "
              f"{s.spec_accepted_tokens} (greedy {s.spec_accepted_greedy}, "
              f"sampled {s.spec_accepted_sampled}), accept rate {rate}; "
              f"TTFT p50 {s.ttft_p50 * 1e3:.3f} ms, decode "
              f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50), "
              f"{s.tokens_generated / wall:.1f} tokens/s; pool "
              f"{s.kv_pool_bytes} bytes, {s.kv_pages_total} pages + the "
              f"sentinel ({s.kv_bytes_per_token:.1f} bytes a token)")
        print(f"  launches {counts}: {name} = decode_steps x layers")
        runs[label] = (outs, [i for i in everyone if i not in samp])
        profile_decode(torch, Engine(model, kv_quant=mode, spec_k=k, **kw),
                       prompts)
    logits = quant_teacher(torch, model, prompts, [
        (label, *runs[label]) for label in ("int8 spec_k=0",
                                            "int8 spec_k=4")], "int8")
    spec_against_plain(torch, runs["int8 spec_k=0"][0],
                       runs["int8 spec_k=4"][0], logits)
    quant_teacher(torch, model, prompts,
                  [("fp8 spec_k=4", *runs["fp8 spec_k=4"])], "fp8")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ generation
def gen_prompts(torch, cfg, seed, b, s):
    """``[b, s]`` prompt ids from ``seed`` on the card."""
    g = torch.Generator().manual_seed(seed + 7)
    return torch.randint(1, cfg.vocab_size, (b, s), generator=g).cuda()


def only_launched(counts, want, label):
    """``counts`` holds exactly the non-zero launch counts of ``want``."""
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{label}: launches {got}, expected {want}")


def last_loop(model):
    """The generate loop ``model`` used last (its LRU's newest entry)."""
    return next(reversed(model._generate_graphs()[0].values()))


def timed_generate(torch, model, ids, **kw):
    """`GEN_TIMED_CALLS` `generate` calls after a warm-up call with the
    same arguments (it builds the loop and captures its decode step;
    cuBLAS handles, allocator): the timed calls only replay, under the
    armed sentinel, launch counts zeroed just before each and read just
    after; the decode step must have been built once. Returns ``(out,
    median wall s, counts of one call)``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.observability import get_sentinel

    model.generate(ids, **kw)
    torch.cuda.synchronize()
    step = last_loop(model).decode
    walls = []
    with get_sentinel().armed():
        for _ in range(GEN_TIMED_CALLS):
            kernels.reset_kernel_launch_counts()
            t0 = time.perf_counter()
            out = model.generate(ids, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = kernels.kernel_launch_counts()
    n = get_sentinel().trace_count(step.name)
    check(last_loop(model).decode is step and n == 1,
          f"{step.name}: built {n} times over {1 + GEN_TIMED_CALLS} calls "
          "at one shape")
    print(f"  {step.name}: decode_traces {n} over the warm-up and "
          f"{GEN_TIMED_CALLS} timed calls, capture_s {step.capture_s:.3f}; "
          f"the timed calls' walls {[round(w, 6) for w in walls]} s")
    return out, sorted(walls)[len(walls) // 2], counts


def generate_cache_bound(torch, model):
    """The device memory `generate`'s built loops still hold on ``model``
    after a phase's calls at many shapes: at most its byte budget, or
    the loop used last where that alone is larger."""
    from paddle_tpu_torch.models import generation

    loops = model._generate_graphs()[0]
    held = model.generate_cache_bytes()
    last = sum(t.untyped_storage().nbytes() for t in last_loop(model).held)
    check(held <= max(generation.GENERATE_CACHE_BYTES, last),
          f"generate's loops hold {held} bytes, over the budget "
          f"{generation.GENERATE_CACHE_BYTES} and the last loop's {last}")
    print(f"  generate's cache after the phase: {len(loops)} loops hold "
          f"{held} bytes (budget {generation.GENERATE_CACHE_BYTES}, the "
          f"last loop {last}); device memory allocated "
          f"{torch.cuda.memory_allocated()} bytes")


def loop_graph_check(torch, model, label, prompt_len, gen_cols):
    """The graph-against-eager check on the decode step of the loop
    ``model`` used last, at each generated column of ``gen_cols`` (cache
    column ``prompt_len + j``; the paged beam's ``gen_col = j``), on the
    tokens it staged last. A paged beam's columns must lie in its last
    page: the loop leaves that page each beam's own, where earlier pages
    may be shared by beams of one parent, and a write there from every
    beam at once is a race of no loop's making."""
    fn = last_loop(model).decode
    cur = fn.static["cur"].clone()
    held = []
    for j in gen_cols:
        ops = dict(cur=cur, step=prompt_len + j)
        if "gen_col" in fn.static:
            ops["gen_col"] = j
        held.append(graph_against_eager(torch, fn, ops, label))
    print(f"  graph against eager, {label}'s decode step at generated "
          f"columns {list(gen_cols)}: {held}")


def prefill_ms(torch, model, ids):
    """Device-synchronised wall ms of one prompt pass (after a warm-up)."""
    b, s = ids.shape
    with torch.inference_mode():
        for _ in range(2):
            caches = model.gen_static_cache(b, s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(ids, caches)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    del caches
    return ms


#: the host calls that launch work on the card: a kernel, or a CUDA graph
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch")


def profile_totals(torch, fn):
    """``fn()`` under torch.profiler: ``(wall us, device busy us, {kernel:
    device us}, kernels the device ran, host launch calls, [(host op,
    self CPU us)] of the four host ops with the most self CPU time)``.
    The host launch calls are `HOST_LAUNCH_CALLS` from the profile's CPU
    side: a graph replay is one, however many kernels it runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per = {}
    host = []
    kernels = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
        else:
            host.append(e)
    calls = sum(e.count for e in host if e.key in HOST_LAUNCH_CALLS)
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:4]
    return (wall_us, sum(per.values()), per, kernels, calls,
            [(e.key, e.self_cpu_time_total) for e in top])


def profile_generate(torch, model, ids, what, run, step_ms,
                     steps=GEN_PROFILE_STEPS):
    """Where a decode step's time goes: ``run(steps + 1)`` (a generation
    of ``steps + 1`` tokens) under torch.profiler, less a profiled
    prompt pass alone, over ``steps``: wall and device busy ms a step,
    the busy share of the profiled step and of the unprofiled one
    (``step_ms``; the profiler's host cost inflates the wall), launches
    a step and the kernels that take the most device time."""
    b, s = ids.shape
    caches = model.gen_static_cache(b, s)   # a loop's caches are built once

    def prefill():
        with torch.inference_mode():
            model.prefill(ids, caches)

    run(steps + 1)                          # warm-up (captures the step)
    p_wall, p_busy, p_per, p_kern, p_call, _ = profile_totals(torch, prefill)
    g_wall, g_busy, g_per, g_kern, g_call, _ = profile_totals(
        torch, lambda: run(steps + 1))
    wall, busy = (g_wall - p_wall) / steps, (g_busy - p_busy) / steps
    print(f"  profile of {what}, {steps} decode steps (a generation of "
          f"{steps + 1} tokens less a prompt pass): wall {wall / 1e3:.3f} "
          f"ms/step, device busy {busy / 1e3:.3f} ms/step "
          f"({100 * busy / wall:.1f}% of the profiled wall, "
          f"{100 * busy / 1e3 / step_ms:.1f}% of the timed step's "
          f"{step_ms:.3f} ms), {(g_kern - p_kern) / steps:.0f} kernels/step "
          f"on the device, {(g_call - p_call) / steps:.1f} host launch "
          "calls/step")
    per = {k: (v - p_per.get(k, 0.0)) / steps for k, v in g_per.items()}
    for key, t in sorted(per.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {t / 1e3:8.4f} ms/step {100 * t / busy:5.1f}%  {key[:90]}")
    del caches
    return wall / 1e3, busy / 1e3


def float32_copy(torch, model, state=None):
    """A float32 copy of ``model``'s weights (or of ``state``) whose
    attention composes (no flash branch): the teachers' model."""
    import dataclasses

    from paddle_tpu_torch.models.gpt import GPTForPretraining

    ref = GPTForPretraining(dataclasses.replace(model.config,
                                                use_flash_attention=False),
                            dtype="float32")
    ref.load_state_dict(model.state_dict() if state is None else state)
    return ref


def parting_gap(torch, ref, ids, a, b):
    """Where rows of ``a`` and ``b`` (``[B, T]`` continuations of ``ids``)
    first part: ``[(row, column, |log p(a_t) - log p(b_t)|)]`` under the
    float32 teacher ``ref`` on their common prefix (the gap of the two
    candidates' cumulative log-probs there)."""
    gaps = []
    with torch.inference_mode():
        for r in range(a.shape[0]):
            diff = (a[r] != b[r]).nonzero()
            if not diff.numel():
                continue
            t = int(diff[0])
            seq = torch.cat([ids[r], a[r, :t]])[None]
            logits = ref._logits(ref.gpt.prefill(
                seq, ref.gen_static_cache(1, seq.shape[1]))[0, -1])
            logp = torch.log_softmax(logits.float(), dim=-1)
            gaps.append((r, t, abs(logp[a[r, t]] - logp[b[r, t]]).item()))
    return gaps


def gen_phase(torch, seed):
    """Phase 10: `generate()` on gpt3-1.3b at full width and depth, bf16,
    random weights from ``seed``, b8 x prompt 1024 (dense) from the
    seed. (a) greedy, 128 new: B1's forward launches exactly ``layers``
    times (the flash prefill), nothing else; a float32 teacher agrees
    with every token but at a near-tie (TEACHER_GAP). (b) beam 4, paged,
    128 new, no
    EOS: the tail kernel launches (new - 1) x layers times, each one a
    bf16 paged launch, and no other paged kernel. (c) the same on the
    gather oracle: no paged launch; (b) against (c) in float32 at b2 x
    128 + 16 (identical, or parting at a log-prob gap < BEAM_GAP). (d)
    the paged beam on int8 tail pages, 32 new: (new - 1) x layers int8
    launches, all through the tail. (e) greedy on weight-only int8, 32
    new, against a float32 teacher on the dequantized weights; the paged
    Engine on the same weights serves phase 4's traffic. Returns the
    tail's launches of (b)."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import Engine

    cfg = gpt_config(MODEL)
    layers = cfg.num_hidden_layers
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    ids = gen_prompts(torch, cfg, seed, GEN_B, GEN_PROMPT)
    plist = ids.tolist()
    pf_ms = prefill_ms(torch, model, ids)

    # (a) greedy
    out, wall, counts = timed_generate(torch, model, ids,
                                       max_new_tokens=GEN_NEW)
    only_launched(counts, {"flash_attention_qkv_fwd": layers}, "(a) greedy")
    check(out.shape == (GEN_B, GEN_NEW), f"(a) output {tuple(out.shape)}")
    dec = (wall * 1e3 - pf_ms) / (GEN_NEW - 1)
    print(f"  (a) greedy b{GEN_B} x {GEN_PROMPT} + {GEN_NEW}: prefill "
          f"{pf_ms:.3f} ms, decode {dec:.3f} ms/token (a step of "
          f"{GEN_B} rows), {GEN_B * GEN_NEW / wall:.1f} tokens/s "
          f"({wall:.3f} s); launches {counts}")
    teacher_check(torch, model, plist, out.tolist())
    greedy = out
    loop_graph_check(torch, model, "(a) greedy", GEN_PROMPT,
                     range(GEN_NEW - 4, GEN_NEW - 1))

    # (b) the paged beam, (c) the gather oracle
    beam = dict(max_new_tokens=GEN_NEW, decode_strategy="beam_search",
                num_beams=GEN_BEAMS)
    outs = {}
    for label, kv in (("(b) beam, paged", "paged"),
                      ("(c) beam, gather", "gather")):
        out, wall, counts = timed_generate(torch, model, ids, beam_kv=kv,
                                           **beam)
        want = {"flash_attention_qkv_fwd": layers}
        if kv == "paged":
            tail = (GEN_NEW - 1) * layers
            want.update(paged_tail_segment=tail, paged_attention=tail)
            tail_launches = counts["paged_tail_segment"]
        only_launched(counts, want, label)
        check(out.shape == (GEN_B, GEN_NEW), f"{label}: output shape")
        dec = (wall * 1e3 - pf_ms) / (GEN_NEW - 1)
        print(f"  {label} K={GEN_BEAMS} b{GEN_B} x {GEN_PROMPT} + "
              f"{GEN_NEW}: decode {dec:.3f} ms/step, "
              f"{GEN_B * GEN_NEW / wall:.1f} tokens/s of best beams "
              f"({wall:.3f} s, prefill {pf_ms:.3f} ms); launches {counts}")
        if kv == "paged":
            loop_graph_check(torch, model, label, GEN_PROMPT,
                             range(GEN_NEW - 4, GEN_NEW - 1))
        profile_generate(
            torch, model, ids, label,
            lambda m, kv=kv: model.generate(ids, beam_kv=kv, **{
                **beam, "max_new_tokens": m}), dec)
        outs[kv] = out
        gc.collect()
        torch.cuda.empty_cache()
    same = [r for r in range(GEN_B) if torch.equal(outs["paged"][r],
                                                   outs["gather"][r])]
    print(f"  (b) against (c) in bf16: {len(same)} of {GEN_B} rows equal "
          "(not held: bf16 rounds the two layouts' sums apart)")

    ref = float32_copy(torch, model)
    ab_ids = ids[:GEN_AB_B, :GEN_AB_PROMPT].contiguous()
    ab = dict(max_new_tokens=GEN_AB_NEW, decode_strategy="beam_search",
              num_beams=GEN_BEAMS)
    a = ref.generate(ab_ids, beam_kv="paged", **ab)
    b = ref.generate(ab_ids, beam_kv="gather", **ab)
    gaps = parting_gap(torch, ref, ab_ids, a, b)
    check(all(g < BEAM_GAP for _, _, g in gaps),
          f"paged and gather beams part at a log-prob gap >= {BEAM_GAP}: "
          f"{gaps}")
    print(f"  (b) against (c) in float32 (TF32 off), b{GEN_AB_B} x "
          f"{GEN_AB_PROMPT} + {GEN_AB_NEW}, K={GEN_BEAMS}: "
          f"{GEN_AB_B - len(gaps)} of {GEN_AB_B} rows identical; parted "
          f"(row, column, log-prob gap < {BEAM_GAP}): {gaps}")
    del ref, a, b
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the paged beam on int8 tail pages
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.observability import get_sentinel

    tail_fns = {}

    def int8_tail(new):
        if new not in tail_fns:
            tail_fns[new] = model._build_beam_fn(
                GEN_B, GEN_PROMPT, new, GEN_BEAMS, None, None, 0.0,
                kv_quant="int8")
        with torch.inference_mode():
            return tail_fns[new](ids)

    int8_tail(GEN_SHORT)             # warm-up: captures the decode step
    torch.cuda.synchronize()
    kernels.reset_kernel_launch_counts()
    with get_sentinel().armed():
        t0 = time.perf_counter()
        out = int8_tail(GEN_SHORT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    print(f"  {tail_fns[GEN_SHORT].decode.name}: decode_traces "
          f"{get_sentinel().trace_count(tail_fns[GEN_SHORT].decode.name)}, "
          f"capture_s {tail_fns[GEN_SHORT].decode.capture_s:.3f}")
    tail = (GEN_SHORT - 1) * layers
    only_launched(counts, {"flash_attention_qkv_fwd": layers,
                           "paged_tail_segment": tail,
                           "paged_attention_int8": tail}, "(d) int8 tail")
    pages = GEN_B * GEN_BEAMS * -(-(GEN_SHORT - 1) // PAGE)
    per_page = 16 * PAGE * (cfg.head_dim + 4)          # int8 data + f32 scale
    pool_bytes = layers * 2 * pages * per_page
    match = sum(torch.equal(out[r], outs["paged"][r, :GEN_SHORT])
                for r in range(GEN_B))
    dec = (wall * 1e3 - pf_ms) / (GEN_SHORT - 1)
    print(f"  (d) beam, paged, int8 tail pages, b{GEN_B} x {GEN_PROMPT} + "
          f"{GEN_SHORT}: {wall:.3f} s, decode {dec:.3f} ms/step; tail pool "
          f"{pool_bytes} bytes ({pages} pages a layer and K/V, scales in; "
          f"bf16 pages {layers * 2 * pages * 16 * PAGE * cfg.head_dim * 2}); "
          f"{match} of {GEN_B} rows' best beams equal (b)'s first "
          f"{GEN_SHORT} tokens; launches {counts}")
    profile_generate(torch, model, ids, "(d) beam, paged, int8 tail pages",
                     int8_tail, dec)
    del tail_fns

    # (e) weight-only int8
    quant = model.serving_weights("int8")
    stored = sum(q.numel() + 4 * sc.numel() for q, sc, _ in quant.values())
    stored += sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n not in quant)
    full = sum(p.numel() * p.element_size() for p in model.parameters())
    out, wall, counts = timed_generate(torch, model, ids,
                                       max_new_tokens=GEN_SHORT,
                                       weight_quant="int8")
    only_launched(counts, {"flash_attention_qkv_fwd": layers},
                  "(e) weight-only int8")
    with model.dequantized(quant):                  # warms the allocator
        torch.cuda.synchronize()
    t_dq = time.perf_counter()
    with model.dequantized(quant):
        torch.cuda.synchronize()
        dq_ms = (time.perf_counter() - t_dq) * 1e3
        state = {n: p.detach().clone()
                 for n, p in model.state_dict().items()}
    print(f"  (e) greedy, weight-only int8, b{GEN_B} x {GEN_PROMPT} + "
          f"{GEN_SHORT}: stored weights {stored} bytes (bf16 {full}); "
          f"{wall:.3f} s, decode {(wall * 1e3 - pf_ms) / (GEN_SHORT - 1):.3f}"
          f" ms/token, the weights dequantized once, when the warm-up call "
          f"built the loop (one dequantization alone: {dq_ms:.3f} ms); "
          f"greedy bf16 agrees on "
          f"{sum(torch.equal(out[r], greedy[r, :GEN_SHORT]) for r in range(GEN_B))}"
          f" of {GEN_B} rows")
    teacher_check(torch, model, plist, out.tolist(), state)
    del state
    profile_generate(
        torch, model, ids, "(e) greedy, weight-only int8",
        lambda m: model.generate(ids, max_new_tokens=m, weight_quant="int8"),
        (wall * 1e3 - pf_ms) / (GEN_SHORT - 1))
    generate_cache_bound(torch, model)
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    prompts = phase_prompts(torch, cfg, seed)
    for wq in (None, "int8"):
        warm = Engine(model, weight_quant=wq, **kw)
        warm.submit(list(range(1, 30)), max_new_tokens=2).result()
        del warm
        _, s, wall, counts = serve_traffic(
            torch, Engine(model, weight_quant=wq, **kw), prompts)
        check(counts["paged_attention"] == s.decode_steps * layers,
              f"engine weight_quant={wq}: {counts}")
        print(f"  (e) Engine(weight_quant={wq!r}), phase 4's traffic: "
              f"{s.decode_steps} decode steps, decode "
              f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50), TTFT p50 "
              f"{s.ttft_p50 * 1e3:.3f} ms, {s.tokens_generated / wall:.1f} "
              f"tokens/s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_tail_segment": tail_launches}


# ------------------------------------- sequence parallel (B4 and the ring)
def b4_compare(torch, fa, q, k, v, do, dlse, causal):
    """B4's kernels against their plain versions on one input, as
    `general_compare` holds B2: the backward of each gets the plain
    forward's o and lse and the same random lse cotangent ``dlse``; lse
    at TOL_F32; o, dq, dk, dv at TOL_F32 in float32 and at BF16_ULPS_O
    bf16 ulps of each element's scale in bfloat16, with the
    bf16-rounding control beside. Returns ``(max |o - ref|, max |d(q, k,
    v) - ref|, line)``."""
    d = q.shape[-1]
    o, lse = fa.flash_attention_lse_fwd(q, k, v, causal)
    ro, rlse = fa.flash_reference(q, k, v, causal)
    grads = fa.flash_attention_lse_bwd(q, k, v, ro, rlse, do, dlse, causal)
    rgrads = fa.flash_bwd_reference(q, k, v, ro, rlse, do, causal,
                                    dlse=dlse)
    torch.cuda.synchronize()
    err_o = (o.float() - ro.float()).abs().max().item()
    err_g = max((a.float() - r.float()).abs().max().item()
                for a, r in zip(grads, rgrads))
    torch.testing.assert_close(lse, rlse, **TOL_F32)
    parts = [f"max|lse-ref| {(lse - rlse).abs().max().item():.3e}"]
    if q.dtype == torch.float32:
        for x, ref in zip((o, *grads), (ro, *rgrads)):
            torch.testing.assert_close(x, ref, **TOL_F32)
        parts.append(f"max|o-ref| {err_o:.3e}, max|d(q,k,v)-ref| "
                     f"{err_g:.3e} (atol {TOL_F32['atol']})")
        return err_o, err_g, "; ".join(parts)
    f32 = [t.float() for t in (q, k, v, do)]
    ctrl_o, _ = fa.flash_reference(*f32[:3], causal)
    ctrl_g = fa.flash_bwd_reference(*f32[:3], ro.float(), rlse, f32[3],
                                    causal, dlse=dlse)
    for name, x, ref, ctrl in (("o", o, ro, ctrl_o),
                               *zip(("dq", "dk", "dv"), grads, rgrads,
                                    ctrl_g)):
        ulps, typical = flash_ulps(x, ref, d)
        ctrl_ulps, _ = flash_ulps(ctrl, ref, d)
        reading = (f"{name} {ulps:.3f} ulps (control {ctrl_ulps:.3f}; "
                   f"mean|ref| {typical:.3e})")
        check(ulps <= BF16_ULPS_O, f"flash_attention_with_lse {reading} "
              f"over the limit of {BF16_ULPS_O}")
        parts.append(reading)
    return err_o, err_g, "; ".join(parts)


def b4_kernel_phase(torch):
    """(a) B4 at one ring chunk of GPT-1.3B's heads (SP_CHUNK: B1 S2048
    H16 D128), bf16 and float32, causal and full: o and lse, then dq, dk,
    dv under a random ``do`` and a random lse cotangent against the plain
    versions (`b4_compare`); with a zero cotangent B4's backward against
    B2's (`grads_agree`: dk, dv bit for bit, bf16 dq within 8 ulps). Then
    bf16 kernel times, forward and backward, beside the plain versions,
    SDPA at the same shape (it takes no lse cotangent: its backward is
    B2's work without the dlse row) and the bound. Returns the records
    of the forward and the backward at the full (non-causal) pair, which
    6 of the 10 pairs of phase (b)'s ring are."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    b, s, h, d = SP_CHUNK
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            q, k, v, do = general_case(b, s, s, h, d, dtype,
                                       seed=110 + int(causal))
            g = torch.Generator(device="cuda").manual_seed(120 + int(causal))
            dlse = torch.randn((b, h, s), generator=g, device="cuda")
            err_o, err_g, line = b4_compare(torch, fa, q, k, v, do, dlse,
                                            causal)
            errs[(dtype, causal)] = (err_o, err_g)
            ro, rlse = fa.flash_reference(q, k, v, causal)
            zero = fa.flash_attention_lse_bwd(q, k, v, ro, rlse, do,
                                              torch.zeros_like(rlse), causal)
            none = fa.flash_attention_lse_bwd(q, k, v, ro, rlse, do, None,
                                              causal)
            b2 = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal)
            torch.cuda.synchronize()
            line += ("; dlse 0 against B2's backward: " + grads_agree(
                torch, "B4 at dlse 0 against B2", zero, b2, d)
                + "; dlse None: " + grads_agree(
                    torch, "B4 without dlse against B2", none, b2, d))
            print(f"  flash_attention_with_lse B={b} S={s} H={h} D={d} "
                  f"{str(dtype)[6:]} {'causal' if causal else 'full'}, "
                  f"random dlse: {line}  ok")

    it = iter(range(10 ** 9))
    copies = [general_case(b, s, s, h, d, torch.bfloat16, seed=130 + i)
              for i in range(3)]
    dlses = [torch.randn((b, h, s), device="cuda") for _ in copies]
    heads = [[x.transpose(1, 2).detach().requires_grad_(True)
              for x in t[:3]] + [t[3].transpose(1, 2)] for t in copies]
    ms, plain, library, bounds = {}, {}, {}, {}
    for causal in (True, False):
        saved = [fa.flash_attention_lse_fwd(*t[:3], causal) for t in copies]

        def fwd():
            fa.flash_attention_lse_fwd(*copies[next(it) % 3][:3], causal)

        def bwd():
            i = next(it) % 3
            fa.flash_attention_lse_bwd(*copies[i][:3], *saved[i],
                                       copies[i][3], dlses[i], causal)

        def lib(backward):
            def run():
                q, k, v, do = heads[next(it) % 3]
                out = F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=causal)
                if backward:
                    out.backward(do)
            return run

        q, k, v, do = copies[0]
        key = "causal" if causal else "full"
        ms[key] = (time_ms(fwd, 20), time_ms(bwd, 10))
        plain[key] = (
            time_ms(lambda: fa.flash_reference(q, k, v, causal), 2, 1),
            time_ms(lambda: fa.flash_bwd_reference(
                q, k, v, *saved[0], do, causal, dlse=dlses[0]), 2, 1))
        lib_f, lib_fb = time_ms(lib(False), 20), time_ms(lib(True), 10)
        library[key] = (lib_f, lib_fb - lib_f)
        pairs = b * s * (s + 1) // 2 if causal else b * s * s
        work = general_work(b, s, s, h, d, pairs, b * s, 2, 0)
        # the backward reads the lse cotangent too
        work = (work[0], (work[1][0] + b * h * s * 4, work[1][1]))
        for j, (nbytes, flops) in enumerate(work):
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            bounds[key, j] = (max(t_bytes, t_ops) * 1e3,
                              "bytes" if t_bytes >= t_ops else "operations")
            print(f"  flash_attention_lse_{('fwd', 'bwd')[j]} at B={b} S={s} "
                  f"H={h} D={d} bf16 {key}: kernel {ms[key][j]:.4f} ms, "
                  f"plain {plain[key][j]:.4f} ms, SDPA {library[key][j]:.4f}"
                  f" ms (no lse cotangent), bound {bounds[key, j][0]:.5f} ms "
                  f"({bounds[key, j][1]}; {nbytes} bytes, {flops} flops)")
    records = []
    for j, (name, line) in enumerate((("flash_attention_lse_fwd", 767),
                                      ("flash_attention_lse_bwd", 536))):
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "max_abs_err": errs[torch.bfloat16, False][j],
            "ms": ms["full"][j], "plain_ms": plain["full"][j],
            "bound_ms": bounds["full", j][0],
            "bound_by": bounds["full", j][1],
            "library_ms": library["full"][j]})
    return records


def ring_loop_phase(torch):
    """(b) The ring's per-rank loop (`_ring_loop`) for every rank of an
    SP_WAYS-way split of S=SP_WAYS*2048 (GPT-1.3B's heads, bf16, causal)
    in this one process, each rank fed the K/V chunks the ring would
    deliver (no transport: that needs a card a rank), through the port's
    `flash_chunk_attention`. Launch counts are zeroed just before the run
    (forward and backward) and read just after: B4 launches once each way
    per computed pair (SP_WAYS diagonal + SP_WAYS*(SP_WAYS-1)/2 earlier),
    B2 never. The joined output and the whole q/k/v grads are held to a
    float32 control (the plain version on float32 copies) beside B2's
    `flash_attention` over the whole sequence: B2 itself strays far from
    the control at the first causal rows (its delta is formed from a
    bf16 o: about 100 ulps of dq at row 1 at this shape), and the ring
    computes those rows with the same kernel, so each element of the
    ring is held to BF16_ULPS_O ulps of its scale beyond B2's own
    distance from the control (`flash_ulp`). The same ring in float32
    (B4's float32 kernels) is held to the control at TOL_F32. Then times
    beside B2's and SDPA's over the whole sequence and the bound of the
    same work. Returns B4's launch counts."""
    import torch.nn.functional as F

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import sequence_parallel as sp
    from paddle_tpu_torch.kernels import flash_attention as fa

    gc.collect()                 # what the earlier phases left in cycles
    n = SP_WAYS
    b, s_loc, h, d = SP_CHUNK
    s = n * s_loc
    scale = d ** -0.5
    q, k, v, do = general_case(b, s, s, h, d, torch.bfloat16, seed=140)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def ring(leaves):
        qs = leaves[0].chunk(n, 1)
        kvs = [torch.stack(p) for p in zip(leaves[1].chunk(n, 1),
                                           leaves[2].chunk(n, 1))]
        outs = []
        for me in range(n):
            step = iter(range(1, n))

            def shift(kv, me=me, step=step):
                return kvs[(me - next(step)) % n]

            o, _ = sp._ring_loop(qs[me], *kvs[me], me, n, shift, True,
                                 scale, sp.flash_chunk_attention)
            outs.append(o)
        return torch.cat(outs, 1)

    kernels.reset_kernel_launch_counts()
    o = ring(leaves)
    o.backward(do)
    torch.cuda.synchronize()
    counts = kernels.kernel_launch_counts()
    pairs = n + n * (n - 1) // 2
    for name, want in (("flash_attention_lse_fwd", pairs),
                       ("flash_attention_lse_bwd", pairs),
                       ("flash_attention_fwd", 0),
                       ("flash_attention_bwd", 0)):
        check(counts[name] == want, f"the ring launched {name} "
              f"{counts[name]} times, want {want}: {counts}")
    ring_out = (o, *(t.grad for t in leaves))
    b2_leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    b2 = fa.flash_attention(*b2_leaves, is_causal=True)
    b2.backward(do)
    b2_out = (b2, *(t.grad for t in b2_leaves))
    f32 = [t.float() for t in (q, k, v, do)]
    ro, rlse = fa.flash_reference(*f32[:3], True)
    control = (ro, *fa.flash_bwd_reference(*f32[:3], ro, rlse, f32[3], True))
    torch.cuda.synchronize()
    parts = []
    for name, x, y, ref in zip(("o", "dq", "dk", "dv"), ring_out, b2_out,
                               control):
        r = ref.reshape(-1, d)
        ulp = flash_ulp(r)
        mine = (x.float().reshape(-1, d) - r).abs()
        theirs = (y.float().reshape(-1, d) - r).abs()
        beyond = ((mine - theirs).clamp(min=0) / ulp).max().item()
        check(beyond <= BF16_ULPS_O, f"the ring's {name} strays {beyond:.3f} "
              f"ulps further from the float32 control than B2's (limit "
              f"{BF16_ULPS_O})")
        rel = [((t - r).norm() / r.norm()).item() / 2 ** -8
               for t in (x.float().reshape(-1, d), y.float().reshape(-1, d))]
        parts.append(f"{name} {(mine / ulp).max().item():.3f} ulps, B2 "
                     f"{(theirs / ulp).max().item():.3f}, beyond B2's "
                     f"{beyond:.3f}; rel. L2 {rel[0]:.3f} bf16 ulps, B2 "
                     f"{rel[1]:.3f}")
    print(f"  {n} ranks x B={b} S={s_loc} H={h} D={d} bf16 causal (S={s}): "
          f"launches {counts}; against a float32 control (each element "
          f"held to {BF16_ULPS_O} ulps beyond B2's own distance): "
          f"{'; '.join(parts)}  ok")
    # the same ring in float32 (B4's float32 kernels): the control's math
    # in another order, held to TOL_F32
    leaves32 = [t.detach().requires_grad_(True) for t in f32[:3]]
    o32 = ring(leaves32)
    o32.backward(f32[3])
    torch.cuda.synchronize()
    err32 = []
    for name, x, ref in zip(("o", "dq", "dk", "dv"),
                            (o32, *(t.grad for t in leaves32)), control):
        torch.testing.assert_close(x, ref, **TOL_F32)
        err32.append(f"{name} {(x - ref).abs().max().item():.3e}")
    print(f"  the same ring in float32 against the control: max|diff| "
          f"{', '.join(err32)} (atol {TOL_F32['atol']})  ok")
    del control, ro, f32, leaves32, o32

    it = iter(range(10 ** 9))
    copies = [general_case(b, s, s, h, d, torch.bfloat16, seed=150 + i)
              for i in range(2)]
    ring_leaves = [[t.detach().requires_grad_(True) for t in c[:3]]
                   for c in copies]
    heads = [[x.transpose(1, 2).detach().requires_grad_(True)
              for x in c[:3]] + [c[3].transpose(1, 2)] for c in copies]

    def ring_fwd():
        with torch.no_grad():
            ring(ring_leaves[next(it) % 2])

    def ring_fwd_bwd():
        i = next(it) % 2
        ring(ring_leaves[i]).backward(copies[i][3])

    def b2_fwd_bwd(backward):
        def run():
            i = next(it) % 2
            out = fa.flash_attention(*ring_leaves[i], is_causal=True)
            if backward:
                out.backward(copies[i][3])
        return run

    def lib(backward):
        def run():
            qh, kh, vh, doh = heads[next(it) % 2]
            out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            if backward:
                out.backward(doh)
        return run

    with torch.no_grad():
        ring_f = time_ms(ring_fwd, 5)
    ring_fb = time_ms(ring_fwd_bwd, 3)
    b2_f, b2_fb = time_ms(b2_fwd_bwd(False), 5), time_ms(b2_fwd_bwd(True), 3)
    lib_f, lib_fb = time_ms(lib(False), 5), time_ms(lib(True), 3)
    work = general_work(b, s, s, h, d, b * s * (s + 1) // 2, b * s, 2, 0)
    for label, (nbytes, flops), mine, b2_ms, lib_ms in (
            ("forward", work[0], ring_f, b2_f, lib_f),
            ("backward", work[1], ring_fb - ring_f, b2_fb - b2_f,
             lib_fb - lib_f)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        print(f"  the {n}-rank ring's {label} (every rank's loop, no "
              f"transport): {mine:.4f} ms; B2 over S={s}: {b2_ms:.4f} ms; "
              f"SDPA: {lib_ms:.4f} ms; bound {max(t_bytes, t_ops) * 1e3:.4f}"
              f" ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{nbytes} bytes, {flops} flops)")
    return {name: counts[name] for name in ("flash_attention_lse_fwd",
                                            "flash_attention_lse_bwd")}


def one_rank_phase(torch):
    """(c) A one-rank NCCL world (this process; its store on a free
    port): `ring_attention` launches B4 once each way and matches B2's
    `flash_attention`;
    `sp_attention` on a one-rank mesh (no sp axis) composes plain
    attention, as the reference does, and launches no flash kernel. o
    and the grads are held to B2's at BF16_ULPS_O ulps; the line says
    where they are bit for bit."""
    import torch.distributed as dist

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import (HybridMesh,
                                              HybridParallelConfig,
                                              init_parallel_env,
                                              ring_attention, sp_attention)
    from paddle_tpu_torch.kernels import flash_attention as fa

    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(store.port),
                       "PADDLE_MASTER": f"127.0.0.1:{store.port}"})
    init_parallel_env()
    try:
        b, s, h, d = SP_CHUNK
        q, k, v, do = general_case(b, s, s, h, d, torch.bfloat16, seed=160)
        mine = [t.detach().requires_grad_(True) for t in (q, k, v)]
        theirs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        kernels.reset_kernel_launch_counts()
        o = ring_attention(*mine, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        counts = kernels.kernel_launch_counts()
        check(counts["flash_attention_lse_fwd"] == 1
              and counts["flash_attention_lse_bwd"] == 1
              and counts["flash_attention_fwd"] == 0, f"one rank: {counts}")
        ref = fa.flash_attention(*theirs, is_causal=True)
        ref.backward(do)
        parts = []
        for name, x, y in (("o", o, ref),
                           *zip(("dq", "dk", "dv"), (t.grad for t in mine),
                                (t.grad for t in theirs))):
            ulps, _ = flash_ulps(x, y, d)
            check(ulps <= BF16_ULPS_O, f"one rank: {name} {ulps:.3f} ulps "
                  "from B2's")
            parts.append(f"{name} {ulps:.3f} ulps"
                         f"{' (bitwise)' if torch.equal(x, y) else ''}")
        mesh = HybridMesh(HybridParallelConfig())
        kernels.reset_kernel_launch_counts()
        with torch.no_grad():
            composed = sp_attention(mesh, q, k, v, causal=True)
        torch.cuda.synchronize()
        check(not any(kernels.kernel_launch_counts().values()),
              "sp_attention on a one-rank mesh launched a kernel")
        ulps, _ = flash_ulps(composed, ref, d)
        check(ulps <= BF16_ULPS_O, f"the composed sp_attention is {ulps:.3f} "
              "ulps from B2's o")
        print(f"  one-rank ring_attention: B4 launched once each way; "
              f"{', '.join(parts)} from B2's; sp_attention on "
              f"{mesh}: composed, {ulps:.3f} ulps from B2's o  ok")
    finally:
        dist.destroy_process_group()


# ------------------------------------------ gpt3-2.7b serving (head dim 80)
def serve_27b_phase(torch, seed):
    """Phase 12: gpt3-2.7b (32 layers, hidden 2560, 32 heads of 80) at
    full width and depth, bf16, random weights from ``seed``: the paged
    kernel at a head dim other than 64 and 128. (a) Phase 4's Engine and
    traffic, on bf16 pages, then on int8 pages with spec_k=4 (W=5 verify
    windows): the paged kernel of the pool launches exactly decode (or
    verify) steps x layers times and no other kernel; every request
    completes and every page returns; greedy tokens agree with a
    float32 teacher (int8: through the pages' round trip) but at a
    near-tie of this model's own bf16 rounding (`bf16_tie_gap`, measured
    on the same sequences without the paged kernel). (b) `generate()` beam search K=4, paged (the default), at
    b2 x prompt 128 + 32: the tail read launches exactly (32 - 1) x
    layers times, each a bf16 paged launch, nothing else; the gather
    oracle beside it launches nothing; paged against gather in float32
    at + 16, identical or parting at a log-prob gap < BEAM_GAP. Returns
    the launch counts of the bf16 and int8 runs, under the names of
    their D=80 records."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import Engine

    cfg = gpt_config(MODEL_27B)
    layers = cfg.num_hidden_layers
    t = time.perf_counter()
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    torch.cuda.synchronize()
    print(f"  {MODEL_27B}: h={cfg.hidden_size} layers={layers} heads="
          f"{cfg.num_attention_heads} d={cfg.head_dim} bf16, random weights "
          f"from seed {seed} ({time.perf_counter() - t:.1f} s)")
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    prompts = phase_prompts(torch, cfg, seed)
    launches = {}
    for label, mode, k in (("(a) bf16 pages", None, 0),
                           ("(a) int8 pages, spec_k=4", "int8", SPEC_K)):
        warm = Engine(model, kv_quant=mode, spec_k=k, **kw)
        warm.submit(list(range(1, 30)), max_new_tokens=8).result()
        del warm
        outs, s, wall, counts = serve_traffic(
            torch, Engine(model, kv_quant=mode, spec_k=k, **kw), prompts)
        name = "paged_attention" + ("_" + mode if mode else "")
        want = s.decode_steps * layers
        check(counts[name] == want, f"{label}: {name} launched "
              f"{counts[name]} times, decode steps x layers = {want}")
        check(all(v == 0 for n, v in counts.items() if n != name),
              f"{label}: another kernel launched: {counts}")
        launches[name + "_d80"] = counts[name]
        print(f"  {label}: {len(prompts)} requests in {wall:.3f} s, "
              f"{s.prefill_steps} prefills, {s.decode_steps} decode steps, "
              f"{s.tokens_generated} tokens; TTFT p50 "
              f"{s.ttft_p50 * 1e3:.3f} ms, decode {s.decode_step_p50 * 1e3:.3f}"
              f" ms/step (p50), {s.tokens_generated / wall:.1f} tokens/s; "
              f"pool {s.kv_pool_bytes} bytes; launches {counts}: {name} = "
              "decode steps x layers")
        tie = bf16_tie_gap(torch, model, prompts, outs, mode)
        if mode is None:
            teacher_check(torch, model, prompts, outs, tie=tie)
        else:
            quant_teacher(torch, model, prompts,
                          [(label, outs, range(len(prompts)))], mode, tie)
        profile_decode(torch, Engine(model, kv_quant=mode, spec_k=k, **kw),
                       prompts)
        gc.collect()
        torch.cuda.empty_cache()

    ids = gen_prompts(torch, cfg, seed, BEAM_B, BEAM_PROMPT)
    pf_ms = prefill_ms(torch, model, ids)
    beam = dict(max_new_tokens=BEAM_NEW, decode_strategy="beam_search",
                num_beams=GEN_BEAMS)
    tail = (BEAM_NEW - 1) * layers
    for label, kv, want in (
            ("(b) beam, paged", "paged",
             {"paged_tail_segment": tail, "paged_attention": tail}),
            ("(b) beam, gather", "gather", {})):
        out, wall, counts = timed_generate(torch, model, ids, beam_kv=kv,
                                           **beam)
        only_launched(counts, want, label)
        check(out.shape == (BEAM_B, BEAM_NEW), f"{label}: output shape")
        dec = (wall * 1e3 - pf_ms) / (BEAM_NEW - 1)
        print(f"  {label} K={GEN_BEAMS} b{BEAM_B} x {BEAM_PROMPT} + "
              f"{BEAM_NEW}: prefill {pf_ms:.3f} ms, decode {dec:.3f} "
              f"ms/step, {BEAM_B * BEAM_NEW / wall:.1f} tokens/s of best "
              f"beams ({wall:.3f} s); launches {counts}")
        profile_generate(
            torch, model, ids, label,
            lambda m, kv=kv: model.generate(ids, beam_kv=kv, **{
                **beam, "max_new_tokens": m}), dec)
    ref = float32_copy(torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ab = dict(max_new_tokens=GEN_AB_NEW, decode_strategy="beam_search",
              num_beams=GEN_BEAMS)
    a = ref.generate(ids, beam_kv="paged", **ab)
    b = ref.generate(ids, beam_kv="gather", **ab)
    gaps = parting_gap(torch, ref, ids, a, b)
    check(all(g < BEAM_GAP for _, _, g in gaps),
          f"paged and gather beams part at a log-prob gap >= {BEAM_GAP}: "
          f"{gaps}")
    print(f"  (b) paged against gather in float32 (TF32 off), b{BEAM_B} x "
          f"{BEAM_PROMPT} + {GEN_AB_NEW}, K={GEN_BEAMS}: "
          f"{BEAM_B - len(gaps)} of {BEAM_B} rows identical; parted (row, "
          f"column, log-prob gap < {BEAM_GAP}): {gaps}")
    del ref, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- attention at Gemma-2B's widths (B2)
def gemma_stack(torch, dtype, seed):
    """GEMMA_LAYERS of the port's `TransformerEncoderLayer` at Gemma-2B's
    widths (post-LN, GELU, dropout 0.1 everywhere), weights from
    ``seed``, on the card."""
    from paddle_tpu_torch.nn import TransformerEncoderLayer, init_weights

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.ModuleList([
                TransformerEncoderLayer(GEMMA_WIDTH, GEMMA_HEADS, GEMMA_FFN,
                                        dropout=0.1, activation="gelu",
                                        device="cuda",
                                        dtype=dtype)
                for _ in range(GEMMA_LAYERS)])

        def forward(self, x, mask):
            for layer in self.layers:
                x = layer(x, mask)
            return x

    stack = Stack()
    with torch.no_grad():
        init_weights(stack, seed, 0.02)
    return stack


def gemma_loss_fn(model, state, batch):
    """Mean squared error of the stack's output against the batch's
    target, in float32."""
    from torch.func import functional_call

    out = functional_call(model, state, (batch["x"], batch["mask"]))
    return (out.float() - batch["target"]).square().mean()


def gemma_batch(torch, g, dtype):
    """One b4 x s1024 batch: inputs of unit scale in ``dtype``, a float32
    target, and the bool [B, 1, 1, S] key-padding mask of lengths in
    [768, 1024)."""
    lens = torch.randint(GEMMA_MIN_LEN, GEMMA_S, (GEMMA_B,), generator=g,
                         device="cuda")
    mask = torch.arange(GEMMA_S, device="cuda")[None] < lens[:, None]
    shape = (GEMMA_B, GEMMA_S, GEMMA_WIDTH)
    return {"x": torch.randn(shape, generator=g, device="cuda").to(dtype),
            "target": torch.randn(shape, generator=g, device="cuda"),
            "mask": mask[:, None, None, :]}


def gemma_phase(torch, seed, card):
    """Phase 13: a stack of GEMMA_LAYERS `TransformerEncoderLayer` at
    Gemma-2B's attention widths (d_model 2048, 8 heads of 256, MLP
    16384) trains through `SpmdTrainStep` with AdamW (bf16 params and
    moments, lr 1e-4, wd 0.01) on b4 x s1024 batches with a key-padding
    mask and dropout 0.1: every layer's attention runs B2 at D=256 (the
    wgmma kernels on 64-key tiles and blocks). First, on two sequences
    at dropout 0, the bf16 loss and grads against a float32 copy whose
    attention is composed (phase 6's tolerances); then the step's graph
    built by its first call and TRAIN_STEPS timed replays under the
    armed sentinel with the launch counts zeroed just before them: B2's
    forward and backward launch exactly steps x layers times each, the
    update once a step, no other kernel, every loss finite; the graph
    against eager steps. Prints step ms p50, tokens/s, MFU, peak memory
    and B2's and the update's device ms a step from a profile, in which
    no kernel sliced over D may run.
    Returns B2's launch counts under the names of its D=256 records."""
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    model = gemma_stack(torch, torch.bfloat16, seed)
    step = SpmdTrainStep(model, gemma_loss_fn,
                         AdamW(learning_rate=TRAIN_LR, weight_decay=TRAIN_WD))
    params, opt_state = step.init(slot_dtype="bfloat16")
    n_params = sum(p.numel() for p in params.values())
    g = torch.Generator(device="cuda").manual_seed(seed)
    batches = [gemma_batch(torch, g, torch.bfloat16)
               for _ in range(TRAIN_STEPS + 2)]
    print(f"  {GEMMA_LAYERS} x TransformerEncoderLayer(d_model={GEMMA_WIDTH},"
          f" nhead={GEMMA_HEADS}, dim_feedforward={GEMMA_FFN}): head dim "
          f"{GEMMA_WIDTH // GEMMA_HEADS}, {n_params} parameters, bf16 params "
          f"and AdamW moments; b{GEMMA_B} x s{GEMMA_S}, key padding with "
          f"lengths in [{GEMMA_MIN_LEN}, {GEMMA_S}), dropout 0.1, MSE loss "
          "against a random target")
    last = GEMMA_LAYERS - 1
    ref = gemma_stack(torch, torch.float32, seed)
    for layer in ref.layers:
        layer.self_attn.use_flash = False
    float32_copy_check(
        torch, step, params, {k: v[:2] for k, v in batches[0].items()}, ref,
        gemma_loss_fn, [f"layers.{i}.{m}.weight" for i, m in
                        [(0, "self_attn.q_proj")] + [
                            (i, m) for i in (0, last)
                            for m in ("self_attn.v_proj", "linear1")]],
        "Gemma-2B widths", f"layers.{last}.self_attn.q_proj.weight")
    del ref

    model.train()
    run = train_on_graphs(torch, step, params, opt_state, batches,
                          "Gemma-2B widths")
    losses, times, counts = run["losses"], run["times"], run["counts"]
    want = TRAIN_STEPS * GEMMA_LAYERS
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    only_launched(counts, {"flash_attention_fwd": want,
                           "flash_attention_bwd": want,
                           "multi_tensor_adam": TRAIN_STEPS},
                  "Gemma-2B widths training")
    p50 = sorted(times)[len(times) // 2] * 1e3
    tok_s = GEMMA_B * GEMMA_S * TRAIN_STEPS / run["wall"]
    flops_per_tok = 6 * n_params + 12 * GEMMA_LAYERS * GEMMA_WIDTH * GEMMA_S
    mfu = tok_s * flops_per_tok / BF16_FLOPS_PER_S
    print(f"  losses {[round(x, 5) for x in losses]} (all finite); launches "
          f"{counts}: B2 fwd = bwd = steps x layers = {want}, the update "
          "once a step")
    print(f"  {card}: {tok_s:.1f} tokens/s (padding included), step "
          f"{p50:.3f} ms p50 (steps {[round(t * 1e3, 3) for t in times]} "
          f"ms), peak memory over the replays {run['peak'] / 2 ** 30:.3f} "
          f"GiB (live tensors + the graph's pool), MFU {mfu:.4f} "
          f"({flops_per_tok} flops/token over 989 TFLOP/s)")
    train_graph_check(torch, step, params, opt_state, batches, run,
                      "Gemma-2B widths")
    it = iter(range(100))

    def one():
        nonlocal params, opt_state
        i = next(it) % len(batches)
        _, params, opt_state = step(params, opt_state, batches[i], 100 + i)

    profile_steps(torch, one, 2, "training steps at Gemma-2B's widths", {
        "B2 at D=256 (forward, one-pass backward, its pre- and post-pass)":
            B2_D256_KERNELS,
        "of which the forward (fwd_wg_kernel<256>)": B2_D256_KERNELS[:1],
        "of which the backward (bwd_wg_wide_kernel<256>)":
            B2_D256_KERNELS[1:2],
        "and its pre- and post-pass": B2_D256_KERNELS[2:], **ADAM_FAMILY},
        absent=SLICED_TC_KERNELS)
    print(f"    no kernel sliced over D (names holding {SLICED_TC_KERNELS}) "
          "ran  ok")
    del model, step, params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_d256": counts["flash_attention_fwd"],
            "flash_attention_bwd_d256": counts["flash_attention_bwd"]}


# ------------------------------------------------- the optimizer plane
def schedule_phase(torch, seed):
    """On gpt-test: a `LinearWarmup` into a `CosineAnnealingDecay` drives
    five replayed steps. Each call stages the scheduler's rate (the
    staged float32 bits equal it) and the update applies it: the params
    equal a twin's updated eagerly with that rate (`apply_gradients(lr=)`
    after `loss_and_grads` with the same key), within 1e-6."""
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_lr

    sched = sched_lr.LinearWarmup(sched_lr.CosineAnnealingDecay(1e-3, 8), 3,
                                  1e-4, 1e-3)
    models = [GPTForPretraining("gpt-test", seed=seed) for _ in range(2)]
    for m in models:
        m.train()
    step = SpmdTrainStep(models[0], gpt_loss_fn, AdamW(learning_rate=sched))
    twin = SpmdTrainStep(models[1], gpt_loss_fn, AdamW())
    (params, state), (tparams, tstate) = step.init(), twin.init()
    g = torch.Generator(device="cuda").manual_seed(seed)
    rates, worst = [], 0.0
    for i in range(6):
        ids = torch.randint(0, 256, (2, 65), generator=g, device="cuda")
        batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        rate = sched.get_lr()
        step(params, state, batch, i)
        _, grads = twin.loss_and_grads(tparams, batch, i)
        twin.optimizer.apply_gradients(tparams, grads, tstate, lr=rate)
        staged = step.captured(batch).static["lr"].view(torch.float32)
        want = torch.tensor(rate, dtype=torch.float32).item()
        check(staged.item() == want, f"step {i}: staged "
              f"lr {staged.item()} is not the scheduler's {rate}")
        worst = max(worst, max((params[n].float() - tparams[n].float())
                               .abs().max().item() for n in params))
        rates.append(rate)
        sched.step()
    check(worst <= 1e-6, f"the scheduled replays' params lie {worst} from "
          "the eager twin's")
    check(step.metrics_snapshot()["xla_traces"] == 1, "the scheduled step "
          "was built more than once")
    print(f"  LinearWarmup(3) -> CosineAnnealingDecay(1e-3, 8) over a first "
          f"call and 5 replays of one graph: rates "
          f"{[f'{r:.3e}' for r in rates]} staged and applied (params within "
          f"{worst:.1e} of the eager twin's)  ok")


def scaler_phase(torch, seed):
    """On gpt-test with `GradScaler` (AdamW, bf16 params and moments): a
    replayed step whose loss function plants an inf in one parameter's
    gradient leaves every param, moment and the step count bit for bit,
    halves the scale and reads ``found_inf_skips == 1``; the next replay
    updates again."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    planted = "gpt.h.0.mlp.fc_in.bias"

    def loss_fn(model, state, batch):
        # d/d(bias) of bias.sum() * poison is poison: inf in that grad only
        return (gpt_loss_fn(model, state, batch)
                + state[planted].float().sum() * batch["poison"][0])

    model = GPTForPretraining("gpt-test", dtype="bfloat16", seed=seed)
    model.train()
    step = SpmdTrainStep(model, loss_fn, AdamW(learning_rate=1e-3),
                         scaler=GradScaler(init_loss_scaling=2.0 ** 12))
    params, state = step.init(slot_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed)

    def batch(poison):
        ids = torch.randint(0, 256, (2, 65), generator=g, device="cuda")
        return {"input_ids": ids[:, :-1], "labels": ids[:, 1:],
                "poison": torch.full((1,), poison, device="cuda")}

    def slots():
        return [t for n in sorted(state["slots"])
                for t in state["slots"][n].values()]

    step(params, state, batch(0.0), 0)
    kept = {n: p.clone() for n, p in params.items()}
    kept_slots = [t.clone() for t in slots()]
    step(params, state, batch(float("inf")), 1)
    snap = step.metrics_snapshot(state)
    check(all(torch.equal(kept[n], p) for n, p in params.items())
          and all(torch.equal(a, b) for a, b in zip(kept_slots, slots()))
          and int(state["step"]) == 1,
          "the step with an inf changed params, moments or the step count")
    check(snap["loss_scale"] == 2.0 ** 11 and snap["found_inf_skips"] == 1,
          f"after the inf: {snap}")
    step(params, state, batch(0.0), 2)
    check(int(state["step"]) == 2 and not all(
        torch.equal(kept[n], p) for n, p in params.items()),
        "the replay after the skip did not update")
    check(step.metrics_snapshot()["xla_traces"] == 1, "the scaled step was "
          "built more than once")
    print(f"  GradScaler, inf planted in {planted}'s grad at a replay: "
          f"params and bf16 moments bit for bit, step count 1, scale "
          f"{2.0 ** 12:.0f} -> {snap['loss_scale']:.0f}, found_inf_skips "
          f"{snap['found_inf_skips']}; the next replay updates  ok")


# ------------------------------------------------------ the training plane
class PlaneData:
    """Phase 19's step-indexed batches: ``batch_at(i)`` draws b8 x s1024
    token ids on the card from a generator seeded with ``(seed, i)``, so
    every index gives the same batch in every run and process."""

    def __init__(self, torch, vocab, seed):
        self.torch, self.vocab, self.seed = torch, vocab, seed

    def batch_at(self, i):
        torch = self.torch
        g = torch.Generator(device="cuda").manual_seed(
            self.seed * 1_000_003 + int(i))
        t = torch.randint(0, self.vocab, (TRAIN_B, TRAIN_S + 1),
                          generator=g, device="cuda")
        return {"input_ids": t[:, :-1], "labels": t[:, 1:]}


def state_of(torch, items):
    """Device copies of a training state's tensors."""
    return [t.clone() for _, t in items]


def set_state(items, values):
    for (_, t), v in zip(items, values):
        t.copy_(v)


def p50_ms(seconds):
    return statistics.median(seconds) * 1e3


def plane_phase(torch, seed, card, root):
    """The training plane on the card (phase 19): gpt3-1.3b's widths at
    PLANE_LAYERS layers (bf16 params and AdamW moments, b8 x s1024)
    through `ResilientTrainLoop` around phase 5's `SpmdTrainStep`, its
    checkpoints under ``root``. (a) PLANE_STEPS steps with async commits
    every PLANE_INTERVAL steps, the launch counts zeroed just before and
    read just after, beside PLANE_SPREAD_RUNS runs with no checkpoint
    from the same state (their step ms, and the spread of the losses and
    the final state that the C.7 bound takes); (b) a crash right after a
    commit, the state wiped, and a fresh loop on the same step resuming:
    the restored state the crashed one bit for bit, its first loss the
    crashed state's eager step bit for bit, the rest and the final state
    within the C.7 bound of (a)'s, no new build; (c) a poisoned loss
    rolled back with its window skipped, a NaN param named by layer
    through ``introspect=True``, a torn and a corrupt checkpoint each
    passed over by the restore, a preemption's emergency snapshot; (d)
    ``introspect=True`` against False: the first loss bit for bit, one
    build each, step ms of both, and a profile of two steps of each.
    Returns the launch counts of (a)."""
    import dataclasses

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.framework import (InjectedCrash,
                                            ResilientTrainLoop,
                                            TrainFaultInjector,
                                            register_train_metrics)
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.observability import get_sentinel
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(gpt_config(MODEL), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0,
                              num_hidden_layers=PLANE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    model.train()

    def make(introspect=False):
        return SpmdTrainStep(model, gpt_loss_fn, AdamW(
            learning_rate=TRAIN_LR, weight_decay=TRAIN_WD),
            introspect=introspect)

    step = make()
    params, opt_state = step.init(slot_dtype="bfloat16")
    items = step.state_items(params, opt_state)
    names = [n for n, _ in items]
    masks = key_bias_masks(torch, step, items)
    nbytes = sum(t.numel() * t.element_size() for _, t in items)
    data = PlaneData(torch, cfg.vocab_size, seed)
    init = state_of(torch, items)
    m = register_train_metrics()
    print(f"  {MODEL}'s widths at {PLANE_LAYERS} of "
          f"{gpt_config(MODEL).num_hidden_layers} layers (the depth cut: "
          f"every snapshot goes through host memory and the disk), "
          f"b{TRAIN_B} x s{TRAIN_S}, bf16 params and AdamW moments; "
          f"{len(items)} state tensors, {nbytes} bytes a snapshot; "
          f"checkpoints under {root}")
    step(params, opt_state, data.batch_at(0), 0)     # builds the graph
    torch.cuda.synchronize()
    set_state(items, init)

    def run(tag, **kw):
        set_state(items, init)
        d = os.path.join(root, tag)
        loop = ResilientTrainLoop(step, data, params, opt_state,
                                  directory=d, seed=seed, **kw)
        return loop, loop.run(PLANE_STEPS)

    # (a) the uninterrupted runs
    kernels.reset_kernel_launch_counts()
    with get_sentinel().armed():
        loop_a, res_a = run("a", checkpoint_interval=PLANE_INTERVAL)
    torch.cuda.synchronize()
    counts = kernels.kernel_launch_counts()
    want = PLANE_STEPS * PLANE_LAYERS
    for name in ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd"):
        check(counts[name] == want, f"phase 19 (a): {name} launched "
              f"{counts[name]} times, steps x layers = {want}")
    check(counts["multi_tensor_adam"] == PLANE_STEPS, "phase 19 (a): "
          f"multi_tensor_adam launched {counts['multi_tensor_adam']} times")
    check(res_a.steps_run == PLANE_STEPS and
          res_a.last_committed_step == PLANE_STEPS and all(
              math.isfinite(x) for x in res_a.losses),
          f"phase 19 (a): {res_a}")
    s_a = state_of(torch, items)
    t0 = time.perf_counter()
    flat = step.host_state(params, opt_state)
    d2h_s = time.perf_counter() - t0
    del flat
    writes = m["write_seconds"].child(loop=loop_a.loop_id)
    start = param_starts(names, init)
    spread = [0.0] * len(items)
    loss_spread = 0.0
    plain = []
    for r in range(PLANE_SPREAD_RUNS):
        with get_sentinel().armed():
            _, res = run(f"a{r}", checkpoint_interval=0)
        plain.append(res)
        spread = [max(x, y) for x, y in zip(spread, state_gaps(
            torch, state_of(torch, items), s_a, masks, start))]
        loss_spread = max(loss_spread, max(
            abs(x - y) for x, y in zip(res.losses, res_a.losses)))
    bound = state_bound(spread, state_floor(torch, s_a, start))
    loss_bound = max(GRAPH_SPREAD * loss_spread,
                     PLANE_LOSS_RTOL * max(abs(x) for x in res_a.losses))
    counts = {k: counts[k] for k in ("flash_attention_qkv_fwd",
                                     "flash_attention_qkv_bwd",
                                     "multi_tensor_adam")}
    print(f"  (a) {PLANE_STEPS} steps, async commits every "
          f"{PLANE_INTERVAL}: launches {counts} (flash fwd = bwd = steps x "
          f"layers = {want}, the update once a step); losses "
          f"{[round(x, 4) for x in res_a.losses]}")
    snap_steps = [round(t * 1e3, 1) for t in
                  res_a.step_seconds[PLANE_INTERVAL - 1::PLANE_INTERVAL]]
    print(f"  {card}: step ms p50 {p50_ms(res_a.step_seconds):.3f} with "
          f"checkpoints (the snapshot steps {snap_steps} ms) against "
          f"{[round(p50_ms(r.step_seconds), 3) for r in plain]} with none; "
          f"snapshot to host {d2h_s * 1e3:.1f} ms for {nbytes} bytes "
          f"({nbytes / d2h_s / 1e9:.2f} GB/s); train_checkpoint_write_"
          f"seconds mean {writes[1] / max(writes[2], 1):.3f} s over "
          f"{writes[2]} commits (step 0's blocking); data wait p50 "
          f"{p50_ms(res_a.data_wait_seconds):.3f} ms")

    # (b) crash right after a commit, wipe, resume on the same step
    inj = TrainFaultInjector().add("crash_at_step", at_step=PLANE_CRASH_AT)
    set_state(items, init)
    loop_b = ResilientTrainLoop(step, data, params, opt_state,
                                directory=os.path.join(root, "b"),
                                seed=seed, fault_injector=inj,
                                checkpoint_interval=PLANE_INTERVAL)
    try:
        loop_b.run(PLANE_STEPS)
        check(False, "phase 19 (b): the injected crash did not fire")
    except InjectedCrash:
        pass
    loop_b._manager.wait()
    cursor = loop_b._data_cursor
    check(cursor == PLANE_CRASH_AT, f"phase 19 (b): the crashed loop's data "
          f"cursor is {cursor}, not {PLANE_CRASH_AT}")
    crashed = state_of(torch, items)
    key = loop_b.step_key(PLANE_CRASH_AT)
    eager = step.run_eager(params, opt_state, data.batch_at(PLANE_CRASH_AT),
                           key)[0].item()
    # the control: a resume fed the next batch, its first loss against
    # (a)'s on the right one, must lie outside the losses' bound
    set_state(items, crashed)
    wrong = abs(step.run_eager(params, opt_state,
                               data.batch_at(PLANE_CRASH_AT + 1), key)[0]
                .item() - res_a.losses_by_step[PLANE_CRASH_AT])
    check(wrong > loss_bound, f"phase 19 (b): the control (the next "
          f"batch) lies {wrong} from (a)'s loss, within {loss_bound}")
    for _, t in items:
        t.zero_()
    builds = get_sentinel().trace_count(step.exec_name)
    with get_sentinel().armed():
        loop_r = ResilientTrainLoop(step, data, params, opt_state,
                                    directory=os.path.join(root, "b"),
                                    seed=seed,
                                    checkpoint_interval=PLANE_INTERVAL)
        check(loop_r.resumed_from == PLANE_CRASH_AT, "phase 19 (b): resumed "
              f"from {loop_r.resumed_from}, not {PLANE_CRASH_AT}")
        same = [torch.equal(a, b) for a, b in zip(state_of(torch, items),
                                                  crashed)]
        check(all(same), "phase 19 (b): restored tensors differ from the "
              f"crashed state: {[n for n, s in zip(names, same) if not s]}")
        res_r = loop_r.run(PLANE_STEPS)
    check(get_sentinel().trace_count(step.exec_name) == builds,
          "phase 19 (b): resuming built the step again")
    first = res_r.losses_by_step[PLANE_CRASH_AT]
    check(first == eager, f"phase 19 (b): the first resumed loss {first!r} "
          f"is not the crashed state's eager step {eager!r}")
    rest = [abs(res_r.losses_by_step[s] - res_a.losses_by_step[s])
            for s in range(PLANE_CRASH_AT + 1, PLANE_STEPS)]
    check(max(rest) <= loss_bound, f"phase 19 (b): resumed losses lie "
          f"{max(rest)} from (a)'s, beyond {loss_bound}")
    worst = worst_against(names, state_gaps(torch, state_of(torch, items),
                                            s_a, masks, start), bound)
    check(worst[3] <= 1.0, f"phase 19 (b): the resumed final state's "
          f"{worst[0]} lies {worst[1]} from (a)'s, beyond {worst[2]}")
    print(f"  (b) crash at step {PLANE_CRASH_AT}, right after its commit; "
          f"the state wiped; a fresh loop on the same step resumed_from "
          f"{loop_r.resumed_from} at data cursor {cursor}, restore "
          f"{loop_r.restore_seconds:.3f} s; every tensor the crashed "
          f"state's bit for bit; first loss {first!r} = the eager step's; "
          f"later losses within {max(rest):.3e} of (a)'s (bound "
          f"{loss_bound:.3e}; a resume fed the next batch lies {wrong:.3e} "
          f"from it); final state's worst {worst[0]} {worst[1]:.3e} "
          f"of {worst[2]:.3e}; builds {builds} -> "
          f"{get_sentinel().trace_count(step.exec_name)}  ok")
    del crashed

    # (d) introspect=True against False (a's runs)
    istep = make(introspect=True)
    iparams, iopt = istep.init(slot_dtype="bfloat16")
    iitems = istep.state_items(iparams, iopt)
    set_state(iitems, init)
    with get_sentinel().armed():
        ires = ResilientTrainLoop(
            istep, data, iparams, iopt, directory=os.path.join(root, "d"),
            seed=seed, checkpoint_interval=0).run(PLANE_STEPS)
    check(ires.losses[0] == res_a.losses[0], "phase 19 (d): introspect's "
          f"first loss {ires.losses[0]!r} is not {res_a.losses[0]!r}")
    check(get_sentinel().trace_count(istep.exec_name) == 1 and
          get_sentinel().trace_count(step.exec_name) == builds,
          "phase 19 (d): more than one build a step")
    row = istep.last_telemetry_row
    check(all(math.isfinite(t["grad_norm"]) and t["nonfinite"] == 0
              for t in row["layers"].values()), f"phase 19 (d): {row}")
    print(f"  (d) introspect=True: first loss {ires.losses[0]!r} bit for "
          f"bit introspect=False's; one build each; step ms p50 "
          f"{p50_ms(ires.step_seconds[1:]):.3f} against "
          f"{[round(p50_ms(r.step_seconds), 3) for r in plain]}; "
          f"{len(row['layers'])} layer rows, global grad norm "
          f"{row['global_grad_norm']:.4f}  ok")
    for what, st, p_, o_ in (("training steps", step, params, opt_state),
                             ("introspecting steps", istep, iparams, iopt)):
        profile_steps(torch, lambda: st(p_, o_, data.batch_at(0), 0), 2,
                      f"{what} at {PLANE_LAYERS} layers",
                      {**qkv_families("B1"), **ADAM_FAMILY})

    # (c) faults
    set_state(items, init)
    inj = TrainFaultInjector().add("nan_loss_at_step", at_step=2)
    loop = ResilientTrainLoop(step, data, params, opt_state,
                              directory=os.path.join(root, "c1"), seed=seed,
                              checkpoint_interval=2, fault_injector=inj)
    res = loop.run(4)
    check(res.anomalies == 1 and res.rollbacks == 1 and
          sorted(loop._skipped) == [2] and res.steps_run == 4 and all(
              math.isfinite(x) for x in res.losses),
          f"phase 19 (c) poisoned loss: {res}, skipped {loop._skipped}")
    print(f"  (c) NaN loss at step 2: rolled back to step 2's checkpoint "
          f"(restore {loop.restore_seconds:.3f} s), data index 2 skipped, "
          f"4 steps finite  ok")
    shutil.rmtree(os.path.join(root, "c1"), ignore_errors=True)

    poison = f"gpt.h.{PLANE_LAYERS // 2}.mlp.fc_in.weight"
    set_state(iitems, init)
    inj = TrainFaultInjector().add("nan_param_at_step", at_step=2,
                                   param=poison)
    loop = ResilientTrainLoop(istep, data, iparams, iopt,
                              directory=os.path.join(root, "c2"), seed=seed,
                              checkpoint_interval=2, fault_injector=inj)
    res = loop.run(4)
    rec = loop.last_anomaly
    layer = f"gpt.h.{PLANE_LAYERS // 2}"
    check(res.rollbacks == 1 and rec is not None and rec["layer"] == layer
          and rec["attribution"]["reason"] == "param_nonfinite",
          f"phase 19 (c) NaN param: {res}, last_anomaly {rec}")
    print(f"  (c) NaN in {poison} at step 2, introspect=True: last_anomaly "
          f"names {rec['layer']} ({rec['attribution']['reason']}), rolled "
          "back  ok")
    shutil.rmtree(os.path.join(root, "c2"), ignore_errors=True)
    del istep, iparams, iopt, iitems

    for fault in ("torn_checkpoint_write", "corrupt_shard"):
        set_state(items, init)
        d = os.path.join(root, fault)
        inj = (TrainFaultInjector().add(fault, at_step=4)
               .add("crash_at_step", at_step=4))
        loop = ResilientTrainLoop(step, data, params, opt_state,
                                  directory=d, seed=seed,
                                  checkpoint_interval=2, fault_injector=inj)
        try:
            loop.run(6)
            check(False, f"phase 19 (c) {fault}: the crash did not fire")
        except InjectedCrash:
            pass
        loop._manager.wait()
        before = m["discarded"].value(loop=f"{fault}-r")
        again = ResilientTrainLoop(step, data, params, opt_state,
                                   directory=d, seed=seed,
                                   checkpoint_interval=2,
                                   loop_id=f"{fault}-r")
        discarded = m["discarded"].value(loop=f"{fault}-r") - before
        check(again.resumed_from == 2 and discarded == (
            fault == "corrupt_shard"), f"phase 19 (c) {fault}: resumed from "
            f"{again.resumed_from}, {discarded} discarded")
        print(f"  (c) {fault} at step 4, then a crash: restore_latest "
              f"passed over step 4 ({int(discarded)} discarded by its CRC) "
              f"and resumed from step 2  ok")
        shutil.rmtree(d, ignore_errors=True)

    set_state(items, init)

    class Notice(PlaneData):
        def batch_at(self, i):
            if i == 2:
                holder.request_preemption()
            return super().batch_at(i)

    d = os.path.join(root, "pre")
    holder = ResilientTrainLoop(step, Notice(torch, cfg.vocab_size, seed),
                                params, opt_state, directory=d, seed=seed,
                                checkpoint_interval=100)
    res = holder.run(PLANE_STEPS)
    resumed = ResilientTrainLoop(step, data, params, opt_state,
                                 directory=d, seed=seed,
                                 checkpoint_interval=100).resumed_from
    check(res.preempted and res.steps_run == 3 and
          res.last_committed_step == 3 and resumed == 3,
          f"phase 19 (c) preemption: {res}, resumed from {resumed}")
    print("  (c) request_preemption() during step 2: the loop committed an "
          "emergency snapshot at step 3 and returned preempted; a fresh "
          "loop resumed from 3  ok")
    del model, step, params, opt_state, init, s_a
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serve_arrivals(torch, eng, prompts, budgets, at, on_step=None):
    """Greedy request ``i`` (``prompts[i]``, ``budgets[i]`` new tokens)
    submitted just before step ``at[i]``; steps until every request is
    done, under the armed sentinel, with the launch counts zeroed just
    before and read just after. ``on_step(step)`` runs after each step
    with its launches uncounted (a kernel held against its plain version
    on the live state). Returns ``(outputs, stats, wall seconds, launch
    counts, log)``; the log holds, a step, ``(host seconds at its start
    and at its end, whether a decode-family step ran in it, tokens
    emitted so far by each request)``, on a clock that leaves
    ``on_step`` out."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.observability import get_sentinel

    handles = [None] * len(prompts)
    log = []
    m = eng.metrics
    done = m.completed
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    step = 0
    with get_sentinel().armed():
        while step <= max(at) or not all(h._req.done for h in handles):
            for i, a in enumerate(at):
                if a == step:
                    handles[i] = eng.submit(prompts[i],
                                            max_new_tokens=budgets[i])
            before = (m.decode_steps, m.prefill_chunk_steps)
            start = time.perf_counter() - t0
            eng.step()
            log.append((start, time.perf_counter() - t0,
                        (m.decode_steps, m.prefill_chunk_steps) != before,
                        [len(h._req.emitted) if h else 0 for h in handles]))
            if on_step is not None:
                # the check's time is left out of the clock
                t = time.perf_counter()
                with kernels.launches_uncounted():
                    on_step(step)
                t0 += time.perf_counter() - t
            step += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    outs = [h.result() for h in handles]
    s = eng.stats()
    check(s.completed - done == len(prompts) and all(
        len(o) == b for o, b in zip(outs, budgets)),
        f"not every request completed: {s}")
    return outs, s, wall, counts, log


def b3_live_check(torch, eng, label, block_table=None, w=1):
    """B3 against its plain version on an engine's live state: the first
    layer's pools, the steps and valid columns of every slot and its
    block table (or ``block_table``, the mixed step's decode view), with
    a random bf16 query window of ``w`` a row. Every row is held, parked ones and the
    sentinel row included, to TOL_BF16_OUT and the lse to TOL_BF16_LSE.
    Returns the largest error."""
    from paddle_tpu_torch.kernels import paged_attention as pa

    kv = eng.kv
    dev = kv.caches[0][0].device
    bt = torch.from_numpy(kv.block_table if block_table is None
                          else block_table).to(dev)
    steps = torch.from_numpy(kv.steps).to(dev)
    vc = torch.from_numpy(kv.valid_cols).to(dev)
    pk, pv = kv.caches[0]
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((eng.slots, pk.shape[1], w, pk.shape[3]), generator=g,
                    device=dev).to(pk.dtype)
    out, lse = pa.fused_paged_attention(q, pk, pv, bt, steps, vc)
    ref, ref_lse = pa.paged_attention_reference(q, pk, pv, bt, steps, vc)
    torch.testing.assert_close(out.float(), ref.float(), **TOL_BF16_OUT)
    torch.testing.assert_close(lse, ref_lse, **TOL_BF16_LSE)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  B3 on the live state ({label}): max|out-ref| {err:.3e}, "
          "ok")
    return err


def shared_rows(eng):
    """``{page: rows}`` of every page two or more active rows map."""
    rows = {}
    for s in range(eng.slots):
        if eng.kv.active[s]:
            for p in set(eng.kv.block_table[s].tolist()) - {
                    eng.kv.pool.sentinel}:
                rows.setdefault(p, []).append(s)
    return {p: r for p, r in rows.items() if len(r) > 1}


def pool_whole(eng, label):
    """After the traffic only the prefix tree holds pages, one reference
    each; once it drops them (`evict_to(0)`) no page and no reference is
    left."""
    kv = eng.kv
    cached = eng.prefix.cached_pages if eng.prefix is not None else 0
    check(kv.slot_page_counts() == (0,) * eng.slots
          and kv.pages_in_use == cached
          and all(n == 1 for n in kv.pool._refcount.values()),
          f"{label}: pages in use {kv.pages_in_use}, cached {cached}, "
          f"refcounts {sorted(set(kv.pool._refcount.values()))}")
    if eng.prefix is not None:
        check(eng.prefix.evict_to(0) == cached, f"{label}: eviction short")
    check(kv.pages_in_use == 0 and not kv.pool._refcount,
          f"{label}: {kv.pages_in_use} pages, "
          f"{len(kv.pool._refcount)} references left")
    print(f"  {label}: every page and reference returned ({cached} cached "
          "pages dropped by evict_to(0))")


def slots_phase(torch, model, seed, paged_step):
    """Phase 15: phase 4's Engine and traffic with no ``kv_mode``, so on
    the dense slot caches (the reference's default): no paged kernel
    and no other kernel launches (the slot step composes its attention
    with float32 scores, as the reference does); every request completes
    and every slot returns; greedy tokens agree with the float32 teacher
    but at a bf16 near-tie; one decode graph and one prefill graph a
    bucket under the armed sentinel; ``kv_cache_bytes`` is the slot
    caches'; the decode graph against its eager run; a profile of full
    steps beside phase 4's paged ms/step (``paged_step``)."""
    from paddle_tpu_torch.serving import Engine

    cfg = model.config
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_buckets=BUCKETS)
    prompts = phase_prompts(torch, cfg, seed)
    eng = Engine(model, **kw)
    check(eng.kv_mode == "slots", f"Engine(no kv_mode) is {eng.kv_mode}")
    outs, s, wall, counts = serve_traffic(torch, eng, prompts)
    check(not any(counts.values()), f"slot serving launched {counts}")
    want = (SLOTS * cfg.num_hidden_layers * 2 * cfg.num_attention_heads
            * MAX_LEN * cfg.head_dim * 2)
    check(s.kv_cache_bytes == want == eng.kv.memory_bytes()
          and s.kv_pages_total is None,
          f"kv_cache_bytes {s.kv_cache_bytes}, the slot caches' {want}")
    print(f"  kv_mode {s.kv_mode}: served {len(prompts)} requests in "
          f"{wall:.3f} s, {s.prefill_steps} prefills, {s.decode_steps} "
          f"decode steps, {s.tokens_generated} tokens; launches: none")
    print(f"  TTFT p50 {s.ttft_p50 * 1e3:.3f} ms, decode "
          f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50; phase 4's paged "
          f"engine in this run: {paged_step * 1e3:.3f} ms/step), "
          f"{s.tokens_generated / wall:.1f} tokens/s, kv_cache_bytes "
          f"{s.kv_cache_bytes}")
    teacher_check(torch, model, prompts, outs)
    paged, *_ = serve_traffic(torch, Engine(model, kv_mode="paged", **kw),
                              prompts)
    same = sum(a == b for a, b in zip(outs, paged))
    print(f"  the paged engine's streams on the same traffic: {same} of "
          f"{len(outs)} identical")
    if same < len(outs):
        teacher_check(torch, model, prompts, paged)
    eng = Engine(model, **kw)
    profile_decode(torch, eng, prompts)
    engine_graph_check(torch, eng)


def prefix_trace(torch, cfg, seed):
    """The shared-prefix trace (``make_shared_prefix_trace``): PFX_N
    prompts, each one of PFX_SYS system prompts of PFX_SYS_LEN tokens
    plus a user suffix of 2..PFX_SUFFIX tokens, budgets of PFX_NEW // 4
    ..PFX_NEW. Returns ``(prompts, budgets, system
    prompt of each)``."""
    g = torch.Generator().manual_seed(seed + 16)
    sys_p = [torch.randint(1, cfg.vocab_size, (PFX_SYS_LEN,), generator=g)
             .tolist() for _ in range(PFX_SYS)]
    which = torch.randint(0, PFX_SYS, (PFX_N,), generator=g).tolist()
    prompts, budgets = [], []
    for w in which:
        n = int(torch.randint(2, PFX_SUFFIX + 1, (1,), generator=g))
        prompts.append(sys_p[w] + torch.randint(
            1, cfg.vocab_size, (n,), generator=g).tolist())
        budgets.append(int(torch.randint(PFX_NEW // 4, PFX_NEW + 1, (1,),
                                         generator=g)))
    return prompts, budgets, which


def prefix_phase(torch, model, seed):
    """Phase 16: the shared-prefix trace through ``Engine(prefix_cache=
    True)`` and, on the same traffic, the paged engine without the
    cache. With it: ``prefix_tokens_saved`` is 384 for every request
    after the first on its system prompt (nothing is evicted); the tail
    prefill graphs are one a tail bucket; B3 launches exactly decode
    steps x layers times, over prefix pages that several rows map
    read-only (held against its plain version on that live state); every
    page and reference returns; greedy tokens agree with the float32
    teacher but at a bf16 near-tie. Returns B3's launches."""
    from paddle_tpu_torch.serving import Engine

    cfg = model.config
    layers = cfg.num_hidden_layers
    prompts, budgets, which = prefix_trace(torch, cfg, seed)
    at = [PFX_EVERY * i for i in range(len(prompts))]
    hits = [i for i in range(len(prompts)) if which[i] in which[:i]]
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    shared = {}

    def on_step(step):
        rows = shared_rows(eng)
        if rows and not shared:
            shared.update(rows)
            b3_live_check(torch, eng, f"step {step}, {len(rows)} pages "
                          f"mapped by {max(map(len, rows.values()))} rows")

    ttft, launches = {}, 0
    for cached in (True, False):
        eng = Engine(model, prefix_cache=cached, **kw)
        outs, s, wall, counts, log = serve_arrivals(
            torch, eng, prompts, budgets, at, on_step if cached else None)
        firsts = first_token_s(log, at)
        ttft[cached] = (s.ttft_p50,
                        statistics.median(firsts[i] for i in hits))
        want = s.decode_steps * layers
        check(counts["paged_attention"] == want and sum(counts.values())
              == want, f"prefix_cache={cached}: launches {counts}, decode "
              f"steps x layers = {want}")
        tails = {min(b for b in BUCKETS if b >= len(p) - PFX_SYS_LEN)
                 for p in prompts}
        check(s.decode_traces == 1 and s.prefill_traces == (
            len(tails | {BUCKETS[-1]}) if cached else buckets_used(prompts)),
            f"graphs: decode {s.decode_traces}, prefill {s.prefill_traces}")
        if cached:
            saved = PFX_SYS_LEN * (len(prompts) - len(set(which)))
            check(s.prefix_evicted_pages == 0
                  and s.prefix_tokens_saved == saved,
                  f"prefix_tokens_saved {s.prefix_tokens_saved}, the "
                  f"page-granular match implies {saved} (evicted "
                  f"{s.prefix_evicted_pages})")
            check(shared, "no prefix page was mapped by two live rows")
            launches = counts["paged_attention"]
            check(launches > 0, "prefix_cache=True launched no B3")
            print(f"  prefix_cache=True: {s.prefix_hits} hits of "
                  f"{s.prefix_lookups}, prefix_tokens_saved "
                  f"{s.prefix_tokens_saved} (= {PFX_SYS_LEN} x "
                  f"{len(prompts) - len(set(which))}), prefix_cached_pages "
                  f"{s.prefix_cached_pages}, prefill_traces "
                  f"{s.prefill_traces} (tail buckets), decode_traces 1")
        print(f"  prefix_cache={cached}: {len(prompts)} requests in "
              f"{wall:.3f} s, {s.decode_steps} decode steps, launches "
              f"{counts['paged_attention']} = decode steps x layers; TTFT "
              f"p50 {s.ttft_p50 * 1e3:.3f} ms, decode "
              f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50)")
        pool_whole(eng, f"prefix_cache={cached}")
        teacher_check(torch, model, prompts, outs)
        hit_prefill_profile(torch, eng, cached)
        del eng
    print(f"  TTFT p50 with the cache {ttft[True][0] * 1e3:.3f} ms, without "
          f"{ttft[False][0] * 1e3:.3f} ms; the {len(hits)} requests that hit: "
          f"first token after {ttft[True][1] * 1e3:.3f} ms (median from "
          f"the start of their step), without the cache "
          f"{ttft[False][1] * 1e3:.3f} ms")
    return launches


def hit_prefill_profile(torch, eng, cached):
    """Where a hit's admission goes: 4 replays of the prefill step a hit
    runs (with the cache: the tail bucket BUCKETS[0] at column
    PFX_SYS_LEN, PFX_SUFFIX real tokens; without: the whole prompt of
    PFX_SYS_LEN + PFX_SUFFIX tokens in bucket BUCKETS[-1]), on a parked
    row (its writes land on the sentinel page)."""
    row = eng.kv.block_table[[0]]
    n = PFX_SYS_LEN + PFX_SUFFIX
    if cached:
        fn, b = eng._cprefill_fns[BUCKETS[0]], BUCKETS[0]
        ops = dict(ids=[[1] * b], tail_lens=[PFX_SUFFIX], col0=[PFX_SYS_LEN],
                   page_rows=row)
        what = (f"tail prefills (b{b}pfx, {PFX_SUFFIX} tokens at column "
                f"{PFX_SYS_LEN})")
    else:
        fn, b = eng._prefill_fns[BUCKETS[-1]], BUCKETS[-1]
        ops = dict(ids=[[1] * b], amask=[[0] * (b - n) + [1] * n],
                   page_rows=row)
        what = f"whole prefills (b{b}, {n} tokens)"
    with torch.inference_mode():
        profile_steps(torch, lambda: fn(**ops), 4, what)


def first_token_s(log, at):
    """Each request's seconds from the start of the step it was submitted
    before to the end of the step that emitted its first token."""
    out = []
    for r, a in enumerate(at):
        i = next(i for i, (*_, em) in enumerate(log) if em[r])
        out.append(log[i][1] - log[a][0])
    return out


def mixed_trace(torch, cfg, seed):
    """The mixed prefill trace (``make_mixed_prefill_trace``): MIX_SHORT
    prompts of MIX_SHORT_LEN tokens (+ MIX_SHORT_NEW) submitted at step
    0, then one MIX_LONG-token prompt (+ MIX_LONG_NEW) at step
    MIX_LONG_AT. Returns ``(prompts, budgets, at)``."""
    g = torch.Generator().manual_seed(seed + 17)
    lo, hi = MIX_SHORT_LEN
    prompts = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g)
               .tolist() for n in torch.randint(lo, hi + 1, (MIX_SHORT,),
                                                 generator=g)]
    prompts.append(torch.randint(1, cfg.vocab_size, (MIX_LONG,),
                                 generator=g).tolist())
    return (prompts, [MIX_SHORT_NEW] * MIX_SHORT + [MIX_LONG_NEW],
            [0] * MIX_SHORT + [MIX_LONG_AT])


def admission_window(log):
    """The steps from the long prompt's (the last request's) submission
    to the one that emits its first token."""
    first = next(i for i, (*_, em) in enumerate(log) if em[-1])
    return range(MIX_LONG_AT, first + 1)


def admission_gaps(log, n_short):
    """The short streams' inter-token gaps (seconds) that end in the
    long prompt's `admission_window`."""
    window = admission_window(log)
    gaps = []
    for r in range(n_short):
        last = None
        for i, (_, t, _, em) in enumerate(log):
            if em[r] > (log[i - 1][3][r] if i else 0):
                if last is not None and i in window:
                    gaps.append(t - last)
                last = t
    return gaps


def chunk_phase(torch, model, seed):
    """Phase 17: the mixed trace through ``Engine(chunk_tokens=
    MIX_CHUNK)`` and through the same engine without chunking (the long
    prompt prefilled whole), each warmed on its own graphs first. B3
    launches exactly (decode steps + mixed steps) x layers times, inside
    the mixed step over a block table whose chunking row is the sentinel
    page (held against its plain version on that view); every page
    returns; one decode graph (the mixed step joins its family
    uncounted); the long prompt's first token is the same in both arms
    or both are within the bf16 near-tie of the float32 teacher. Prints
    the short streams' largest and p99 inter-token gap while the long
    prompt is admitted, the mixed steps and their ms. Then `embed` of
    EMBED_LENS prompts in the chunked engine, each vector at cosine >=
    EMBED_COS with the float32 teacher's final ln_f hidden state, and the
    pool empty after. Returns B3's launches of the chunked arm."""
    from paddle_tpu_torch.serving import Engine

    cfg = model.config
    layers = cfg.num_hidden_layers
    prompts, budgets, at = mixed_trace(torch, cfg, seed)
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE,
              max_len=MIX_MAX_LEN, prefill_buckets=MIX_BUCKETS)
    views = []

    def on_step(step):
        if eng._chunk_req is not None and not views:
            view = eng._chunk_fn.static["block_table"].cpu().numpy()
            slot = eng._chunk_req.slot
            check((view[slot] == eng.kv.pool.sentinel).all(),
                  "the mixed step's chunking row is not the sentinel page")
            views.append(view)
            b3_live_check(torch, eng, f"step {step}, the mixed step's "
                          f"decode view, row {slot} on the sentinel", view)

    firsts, launches, engines = {}, 0, {}
    for ct in (MIX_CHUNK, None):
        eng = Engine(model, chunk_tokens=ct, **kw)
        # its graphs first: a short and a long request to the end
        eng.submit(prompts[0], max_new_tokens=2).result()
        eng.submit(prompts[-1], max_new_tokens=2).result()
        before = (eng.metrics.decode_steps, eng.metrics.prefill_chunk_steps)
        outs, s, wall, counts, log = serve_arrivals(
            torch, eng, prompts, budgets, at, on_step if ct else None)
        ran = sum(r for _, _, r, _ in log)
        chunk_steps = s.prefill_chunk_steps - before[1]
        check(counts["paged_attention"] == ran * layers
              and sum(counts.values()) == ran * layers,
              f"chunk_tokens={ct}: launches {counts}, (decode steps + "
              f"mixed steps) x layers = {ran * layers}")
        check(s.decode_traces == 1, f"decode_traces {s.decode_traces}")
        check(s.kv_pages_in_use == 0, f"{s.kv_pages_in_use} pages in use")
        gaps = admission_gaps(log, MIX_SHORT)
        steps_ms = [(log[i][1] - log[i][0]) * 1e3
                    for i in admission_window(log)]
        firsts[ct] = outs[-1][0]
        if ct:
            launches = counts["paged_attention"]
            check(len(steps_ms) == chunk_steps == -(-MIX_LONG // ct),
                  f"{len(steps_ms)} steps to the first token, {chunk_steps}"
                  " mixed steps")
        label = f"chunk_tokens={ct}"
        print(f"  {label}: {len(prompts)} requests in {wall:.3f} s, "
              f"{ran} decode-family steps ({chunk_steps} mixed), launches "
              f"{counts['paged_attention']} = that x layers; decode "
              f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50)")
        print(f"  {label}: inter-token gap of the {MIX_SHORT} short streams "
              f"while the {MIX_LONG}-token prompt is admitted: largest "
              f"{max(gaps) * 1e3:.3f} ms, p99 "
              f"{torch.tensor(gaps).quantile(0.99).item() * 1e3:.3f} ms "
              f"over {len(gaps)} gaps; "
              f"its {len(steps_ms)} steps to its first token: "
              f"{' '.join(f'{m:.3f}' for m in steps_ms)} ms")
        teacher_check(torch, model, prompts, outs)
        engines[ct] = eng

        def admit_alone():
            h = eng.submit(prompts[-1], max_new_tokens=1)
            while not h._req.done:
                eng.step()

        profile_steps(torch, admit_alone, 1, f"admissions of the "
                      f"{MIX_LONG}-token prompt alone ({label}: "
                      f"{-(-MIX_LONG // ct) if ct else 1} steps)")
    check(views, "no step ran with a prompt mid-chunk")
    same = ("the same" if firsts[MIX_CHUNK] == firsts[None] else
            "a near-tie: each within the teacher's gap")
    print(f"  the long prompt's first token: {firsts[MIX_CHUNK]} chunked, "
          f"{firsts[None]} whole ({same})")
    eng = engines.pop(MIX_CHUNK)
    engines.clear()
    embed_check(torch, model, eng, seed)
    return launches


def embed_check(torch, model, eng, seed):
    """`Engine.embed` on EMBED_LENS prompts against a float32 teacher's
    final ln_f hidden state (cosine >= EMBED_COS), the pool empty
    after."""
    cfg = model.config
    g = torch.Generator().manual_seed(seed + 18)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in EMBED_LENS]
    t = time.perf_counter()
    vecs = eng.embed(prompts)
    dt = time.perf_counter() - t
    ref = float32_copy(torch, model)
    cos = []
    with torch.inference_mode():
        for p, v in zip(prompts, vecs):
            ids = torch.tensor([p], device=ref.device)
            hidden = ref.gpt.prefill(ids, ref.gen_static_cache(1, len(p)))
            want = hidden[0, -1].float().cpu()
            got = torch.from_numpy(v)
            check(got.shape == want.shape and torch.isfinite(got).all(),
                  f"embed({len(p)}): shape {tuple(got.shape)}")
            cos.append(torch.nn.functional.cosine_similarity(
                got, want, dim=0).item())
    del ref
    check(min(cos) >= EMBED_COS, f"embed cosines {cos} < {EMBED_COS}")
    check(eng.kv.pages_in_use == 0 and eng.scheduler.free_slots == SLOTS,
          "embed left pages or slots behind")
    print(f"  embed of {len(prompts)} prompts {EMBED_LENS} in {dt:.3f} s "
          f"(chunks of {eng._chunk_tokens}): cosine with the float32 "
          f"teacher's ln_f state {', '.join(f'{c:.6f}' for c in cos)} "
          f">= {EMBED_COS}; the pool is empty after")


def serving_modes_phases(torch, seed, paged_step):
    """Phases 15-17 on one gpt3-1.3b at full width and depth, bf16,
    random weights from ``seed``. Returns B3's launches in phases 16 and
    17."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config

    model = GPTForPretraining(gpt_config(MODEL), dtype="bfloat16", seed=seed)
    print("[15] dense slot serving phase (Engine with no kv_mode)")
    slots_phase(torch, model, seed, paged_step)
    print("[16] prefix-cache serving phase (shared system prompts)")
    pfx = prefix_phase(torch, model, seed)
    print("[17] chunked prefill and embed phase (a long prompt among "
          "decoding streams)")
    mix = chunk_phase(torch, model, seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return pfx, mix


# ---------------------------------------------------- phase 18: the Engine
def ladder_streams(torch, ref, prompts, base, other, label):
    """``other``'s greedy streams against ``base``'s (the spec_k=0 arm):
    equal, or parting first where the float32 teacher ``ref`` (on the
    common prefix) puts the two tokens within TEACHER_GAP of each other;
    the rest of such a stream is not compared. ``other`` may hold partial
    streams (a prefix of ``base``'s is equal)."""
    parted = []
    with torch.inference_mode():
        for i, (a, b) in enumerate(zip(base, other)):
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                continue
            seq = torch.tensor([list(prompts[i]) + list(a[:j])],
                               device=ref.device)
            logits = ref._logits(ref.gpt.prefill(
                seq, ref.gen_static_cache(1, seq.shape[1]))[0, -1])
            gap = abs(logits[a[j]] - logits[b[j]]).item()
            check(gap < TEACHER_GAP, f"{label}: request {i} parts from "
                  f"spec_k=0 at token {j} ({b[j]} vs {a[j]}), {gap} apart "
                  "on the teacher")
            parted.append((i, j, round(gap, 5)))
    print(f"  {label} against spec_k=0: {len(base) - len(parted)} of "
          f"{len(base)} streams equal; parted (request, token, teacher gap "
          f"< {TEACHER_GAP}): {parted}")


def stream_oracle(prompts, streams, vocab, wrong=False):
    """A drafter over known streams: for the request whose prompt the
    context starts with, the next ``k`` tokens of its stream while the
    tokens emitted so far are that stream's (a stream the engine left at
    a bf16 near-tie gets no more drafts: what follows is unknown);
    ``wrong``: another token than the stream's next, ``k`` times, which
    the target rejects."""
    import numpy as np

    rows = [np.asarray(p) for p in prompts]

    def fn(ctx, k):
        for p, s in zip(rows, streams):
            if len(ctx) >= len(p) and np.array_equal(ctx[:len(p)], p):
                done = len(ctx) - len(p)
                if wrong:
                    nxt = s[done] if done < len(s) else 0
                    return [(nxt + 1) % (vocab - 1) + 1] * k
                if not np.array_equal(ctx[len(p):], s[:done]):
                    return []
                return s[done:done + k]
        return []
    return fn


def serve_rungs(torch, eng, prompts, budgets, at, label):
    """The adaptive engine's traffic (request ``i`` submitted just before
    step ``at[i]``). The launch counts are zeroed just before and read
    just after; the first step (the first admissions and the first
    verify step, which builds every rung) runs before the sentinel is
    armed, the rest under it. Per rung: the verify steps it ran and B3's
    launches in them (their difference in the counts around each step),
    and B3 held against its plain version on the rung's live state after
    its first step (launches uncounted, off the clock). Returns
    ``(outputs, stats, wall seconds, counts, {k: [steps, launches]})``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.observability import get_sentinel

    handles = [None] * len(prompts)
    rungs, held = {}, set()
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    step = 0
    armed = contextlib.ExitStack()
    while step <= max(at) or not all(h._req.done for h in handles):
        for i, a in enumerate(at):
            if a == step:
                handles[i] = eng.submit(prompts[i], max_new_tokens=budgets[i])
        k, steps0 = eng._spec_k, eng.metrics.decode_steps
        before = kernels.kernel_launch_counts()["paged_attention"]
        eng.step()
        if step == 0:
            armed.enter_context(get_sentinel().armed())
        if eng.metrics.decode_steps > steps0:
            r = rungs.setdefault(k, [0, 0])
            r[0] += 1
            r[1] += kernels.kernel_launch_counts()["paged_attention"] - before
            if k not in held and eng.kv.active.any():
                t = time.perf_counter()
                with kernels.launches_uncounted():
                    b3_live_check(torch, eng, f"{label}, rung k={k}", w=k + 1)
                held.add(k)
                t0 += time.perf_counter() - t
        step += 1
    torch.cuda.synchronize()
    armed.close()
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    outs = [h.result() for h in handles]
    s = eng.stats()
    check(all(len(o) == b for o, b in zip(outs, budgets)),
          f"{label}: not every request completed")
    return outs, s, wall, counts, rungs


def rung_line(torch, label, s, wall, rungs, layers, counts):
    """Checks B3's launches (exactly verify steps x layers on every rung,
    all of the kernel's launches on them), one decode graph and every
    page back; prints the arm's numbers. Returns ``{k: launches}``."""
    for k, (steps, n) in rungs.items():
        check(n == steps * layers, f"{label}: rung k={k} launched B3 {n} "
              f"times in {steps} verify steps, not x {layers}")
    check(sum(n for _, n in rungs.values()) == counts["paged_attention"],
          f"{label}: B3 launched outside the verify steps: {counts}")
    check(s.decode_traces == 1, f"{label}: decode_traces {s.decode_traces}")
    check(s.kv_pages_in_use == 0 and s.kv_pages_free == s.kv_pages_total,
          f"{label}: pages did not return: {s}")
    rate = (f"{s.spec_accept_rate:.4f}" if s.spec_accept_rate is not None
            else "n/a")
    print(f"  {label}: {s.decode_steps} verify steps, {s.tokens_generated} "
          f"tokens in {wall:.3f} s ({s.tokens_generated / wall:.1f} "
          f"tokens/s, {s.tokens_generated / max(1, s.decode_steps):.2f} "
          f"tokens a step); accept rate {rate} ({s.spec_accepted_tokens} "
          f"of {s.spec_draft_tokens}); {s.decode_step_p50 * 1e3:.3f} "
          f"ms/step p50; k history {list(s.spec_k_history)}; decode_traces "
          f"{s.decode_traces} (sentinel armed after the first step), "
          f"capture_s {s.capture_s:.3f}")
    print(f"    B3 by rung (k: verify steps, launches = steps x {layers}): "
          f"{ {k: tuple(v) for k, v in sorted(rungs.items())} }")
    return {k: n for k, (_, n) in rungs.items()}


def repetitive_trace(seed, vocab):
    """The JAX package's repetitive trace shape (``benchmarks/
    bench_serving.py:238-255``): REP_N prompts that repeat a motif of
    REP_MOTIF tokens, REP_MOTIF + 1 to max(BUCKETS) tokens long, budgets
    of MAX_NEW // 2 to MAX_NEW; arrivals at steps 0 to REP_SPREAD."""
    import numpy as np

    rng = np.random.default_rng(seed + 18)
    prompts, budgets = [], []
    for _ in range(REP_N):
        plen = int(rng.integers(REP_MOTIF + 1, max(BUCKETS) + 1))
        motif = rng.integers(1, vocab, (REP_MOTIF,))
        prompts.append(np.tile(motif, -(-plen // REP_MOTIF))[:plen].tolist())
        budgets.append(int(rng.integers(MAX_NEW // 2, MAX_NEW + 1)))
    at = sorted(int(a) for a in rng.integers(0, REP_SPREAD + 1, REP_N))
    return prompts, budgets, at


def draft_model_fn(torch, dm, timer):
    """``draft_model=``: gpt2-124m (``dm``, bf16) greedily continuing the
    context by ``k`` tokens, eagerly (a full forward a token: no graph,
    nothing for the sentinel), its seconds added to ``timer``."""
    def fn(ctx, k):
        t = time.perf_counter()
        ids = torch.tensor([list(ctx)], device=dm.device)
        out = []
        for _ in range(k):
            hidden = dm.gpt.prefill(ids, dm.gen_static_cache(1, ids.shape[1]))
            tok = dm._logits(hidden[0, -1]).argmax(-1)
            out.append(int(tok))
            ids = torch.cat([ids, tok.view(1, 1)], dim=1)
        timer[0] += time.perf_counter() - t
        timer[1] += 1
        return out
    return fn


def a86_phase(torch, model, prompts, base, ref):
    """Phase 18 (e): deadlines under an injected clock skew, bounded
    admission's three policies, the retry budget, background mode with
    timelines and histograms, and a step error at a verify dispatch."""
    import numpy as np

    from paddle_tpu_torch.serving import (DeadlineExceededError, Engine,
                                          FaultInjector, OverloadedError,
                                          PoolExhaustedError)
    from paddle_tpu_torch.serving.timeline import PHASES, cause_of

    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    # deadlines: 8 requests decode, 2 wait; from decode step 2 the clock
    # runs 1e6 s ahead, so the next step's sweep fails all ten
    inj = FaultInjector().add("clock_skew", skew_s=1e6, at_step=2)
    eng = Engine(model, spec_k=2, fault_injector=inj, **kw)
    hs = [eng.submit(p, max_new_tokens=MAX_NEW, deadline_s=600.0)
          for p in prompts]
    while eng.step():
        pass
    for h in hs:
        try:
            h.result()
            check(False, "a request outlived its skewed deadline")
        except DeadlineExceededError:
            pass
    queued = [i for i, h in enumerate(hs) if not h.partial]
    check(len(queued) == len(prompts) - SLOTS
          and all(hs[i]._req.slot is None for i in queued),
          f"queued expiries {queued}")
    check(all(h.timeline.phases()[-2] == ("queued" if i in queued
                                          else "decode")
              for i, h in enumerate(hs)), "deadline timelines")
    ladder_streams(torch, ref, prompts, base, [h.partial for h in hs],
                   "deadline partials")
    s = eng.stats()
    check(s.deadline_exceeded == len(prompts) and s.kv_pages_in_use == 0,
          f"deadlines: {s}")
    print(f"  deadlines (clock skew from decode step 2, spec_k=2): "
          f"{len(queued)} expired queued with no page reserved, "
          f"{len(prompts) - len(queued)} mid-verify keeping "
          f"{[len(h.partial) for h in hs if h.partial]} tokens; every "
          f"page back ({s.kv_pages_free} of {s.kv_pages_total} free)")
    del eng
    # max_queue=2: eight slots busy, two queued, an eleventh arrives
    short = dict(max_new_tokens=4)
    for policy in ("refuse", "shed_newest", "shed_closest_deadline"):
        eng = Engine(model, max_queue=2, shed_policy=policy, **kw)
        for i in range(0, SLOTS, 2):        # two a step: the queue holds 2
            for p in prompts[i:i + 2]:
                eng.submit(p, max_new_tokens=MAX_NEW, deadline_s=600.0)
            eng.step()
        check(eng.stats().active_slots == SLOTS, "the slots are not full")
        q = [eng.submit(prompts[8], deadline_s=30.0, **short),
             eng.submit(prompts[9], deadline_s=600.0, **short)]
        victim = None
        try:
            late = eng.submit(prompts[0], deadline_s=300.0, **short)
        except OverloadedError:
            check(policy == "refuse", f"{policy} raised at submit")
            victim = "the newcomer, refused at submit"
        else:
            dead = [h for h in (*q, late) if h.done()]
            want = late if policy == "shed_newest" else q[0]
            check(dead == [want], f"{policy}: shed {dead}")
            try:
                want.result()
                check(False, f"{policy}: the victim finished")
            except OverloadedError:
                pass
            victim = ("the newcomer" if want is late
                      else "the queued request nearest its deadline (30 s)")
        while eng.step():
            pass
        s = eng.stats()
        check(s.shed == 1 and s.kv_pages_in_use == 0
              and s.completed == len(prompts), f"{policy}: {s}")
        print(f"  max_queue=2 shed_policy={policy}: the victim is {victim}; "
              f"{s.completed} completed, every page back")
        del eng
    # the retry budget
    inj = FaultInjector().add("reserve_fail", times=3)
    eng = Engine(model, fault_injector=inj, admission_retries=3, **kw)
    h = eng.submit(prompts[0], max_new_tokens=4)
    try:
        h.result()
        check(False, "the reservation did not fail")
    except PoolExhaustedError as exc:
        print(f"  reserve_fail x3, admission_retries=3: {exc}")
    check(eng.alive and eng.kv.pages_in_use == 0
          and eng.stats().kv_pages_exhausted == 3, "retries")
    del eng
    # background mode: phase 4's ten requests from the main thread, on
    # graphs captured on the main thread (one request a prompt bucket,
    # served cooperatively first) and replayed from the loop thread
    eng = Engine(model, **kw)
    for p in (prompts[0], prompts[-1]):
        eng.submit(p, max_new_tokens=2).result()
    t0 = time.perf_counter()
    with eng:
        hs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        outs = [list(h.tokens(timeout=120.0)) for h in hs]
        check(eng.running and eng._thread.name.startswith("serving-engine"),
              "the loop thread")
    wall = time.perf_counter() - t0
    check(not eng.running and eng._thread is None, "stop() did not join")
    s = eng.stats()
    check(s.decode_traces == 1 and s.prefill_traces == 2
          and s.completed == len(prompts) + 2
          and s.kv_pages_in_use == 0, f"background: {s}")
    ladder_streams(torch, ref, prompts, base, outs, "background mode")
    rows = eng.timelines.snapshot()["recent"]
    check(len(rows) == len(prompts) + 2, "the timeline ring")
    for h in hs:
        d = h.timeline.as_dict(h._req)
        offs = [p["t_s"] for p in d["phases"]]
        check(offs == sorted(offs) and [p["phase"] for p in d["phases"]]
              == ["submitted", "queued", "admitted", "prefill", "decode",
                  "terminal"] and all(p["phase"] in PHASES
                                      for p in d["phases"])
              and d["terminal"] == cause_of(h.state, h._error) == "done",
              f"timeline {d}")
    from paddle_tpu_torch.observability import get_registry
    hist = get_registry().get("serving_ttft_seconds")
    host = float(np.median(eng.metrics.ttft_s))
    edges = (0.0,) + hist.edges
    i = next((i for i, e in enumerate(hist.edges) if host <= e),
             len(hist.edges))
    lo, hi = edges[max(0, i - 1)], edges[min(len(edges) - 1, i + 1)]
    check(lo <= s.ttft_hist_p50 <= hi, f"TTFT histogram p50 "
          f"{s.ttft_hist_p50} vs host {host} (bucket [{lo}, {hi}])")
    print(f"  background mode (with Engine(...) as eng): {len(prompts)} "
          f"requests from the main thread in {wall:.3f} s, streamed from "
          f"the loop thread, which replays graphs the main thread "
          f"captured; stop() joined; decode_traces "
          f"{s.decode_traces}; every timeline monotone, cause done; TTFT "
          f"p50 host {host * 1e3:.3f} ms, histogram {s.ttft_hist_p50 * 1e3:.3f} "
          f"ms (buckets {lo}..{hi} s), p99 {s.ttft_p99 * 1e3:.3f} ms")
    del eng
    # a step error at the second verify dispatch
    inj = FaultInjector().add("step_error", at_step=1, phase="decode")
    eng = Engine(model, spec_k=2, fault_injector=inj, **kw)
    hs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    failed = 0
    for h in hs:
        try:
            h.result()
        except RuntimeError:
            failed += 1
    check(failed == len(prompts) and not eng.alive
          and eng.kv.pages_in_use == 0
          and eng.kv.pages_free == eng.kv.pages_total, "step_error")
    print(f"  step_error at verify dispatch 1: all {failed} handles failed "
          f"({hs[0]._error!r}), every page back, the engine refuses work")
    del eng


def engine_rest_phase(torch, seed, base_ms):
    """Phase 18 (module docstring). Returns B3's launches by verify
    width, ``{"paged_attention_w{k + 1}": n}``, from (a) and (b)."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import Engine

    cfg = gpt_config(MODEL)
    layers = cfg.num_hidden_layers
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    prompts = phase_prompts(torch, cfg, seed)
    budgets = [MAX_NEW] * len(prompts)
    warm = Engine(model, spec_k=SPEC_K0, spec_adaptive=True,
                  spec_k_max=SPEC_K_MAX, **kw)
    warm.submit(prompts[0], max_new_tokens=12).result()
    del warm
    base, s0, wall0, _ = serve_traffic(torch, Engine(model, **kw), prompts)
    print(f"  spec_k=0: {s0.decode_steps} decode steps, "
          f"{s0.decode_step_p50 * 1e3:.3f} ms/step p50, "
          f"{s0.tokens_generated / wall0:.1f} tokens/s (phase 4: "
          f"{base_ms * 1e3:.3f} ms/step)")
    ref = float32_copy(torch, model)
    launches = {}

    def adaptive(label, k0, drafter):
        eng = Engine(model, spec_k=k0, spec_adaptive=True,
                     spec_k_max=SPEC_K_MAX, draft_model=drafter, **kw)
        outs, s, wall, counts, rungs = serve_rungs(
            torch, eng, prompts, budgets, SUBMIT_AT_STEP, label)
        for k, n in rung_line(torch, label, s, wall, rungs, layers,
                              counts).items():
            name = f"paged_attention_w{k + 1}"
            launches[name] = launches.get(name, 0) + n
        ladder_streams(torch, ref, prompts, base, outs, label)
        return eng, s

    eng, s = adaptive("(a) grow, the oracle", SPEC_K0,
                      stream_oracle(prompts, base, cfg.vocab_size))
    check(s.spec_k == SPEC_K_MAX,
          f"(a) ended at k={s.spec_k}: {s.spec_k_history}")
    del eng
    eng = Engine(model, spec_k=SPEC_K0, spec_adaptive=True,
                 spec_k_max=SPEC_K_MAX,
                 draft_model=stream_oracle(prompts, base, cfg.vocab_size),
                 **kw)
    for p in prompts[:SLOTS]:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                  # admits every slot, builds every rung
    profile_steps(torch, eng.step, 3, "verify steps of (a) (every slot "
                  "active, the oracle; k 4, 8, 8)")
    del eng
    eng, s = adaptive("(b) shrink, the anti-oracle", SPEC_K_MAX,
                      stream_oracle(prompts, base, cfg.vocab_size,
                                    wrong=True))
    check(s.spec_k == 1 and s.spec_accepted_tokens == 0,
          f"(b) ended at k={s.spec_k}")
    del eng
    # (c) the n-gram drafter on repetitive prompts, three arms
    rp, rb, rat = repetitive_trace(seed, cfg.vocab_size)
    rep = {}
    for label, ekw in (("spec_k=0", {}), ("fixed spec_k=4", dict(spec_k=4)),
                       ("adaptive spec_k=2..8", dict(
                           spec_k=SPEC_K0, spec_adaptive=True,
                           spec_k_max=SPEC_K_MAX))):
        eng = Engine(model, **ekw, **kw)
        outs, s, wall, counts, _ = serve_arrivals(torch, eng, rp, rb, rat)
        check(s.decode_traces == 1 and s.kv_pages_in_use == 0
              and counts["paged_attention"] == s.decode_steps * layers,
              f"(c) {label}: {s}, {counts}")
        rate = (f"{s.spec_accept_rate:.4f}"
                if s.spec_accept_rate is not None else "n/a")
        print(f"  (c) repetitive trace ({REP_N} prompts, motif {REP_MOTIF}, "
              f"{min(map(len, rp))}-{max(map(len, rp))} tokens, budgets "
              f"{min(rb)}-{max(rb)}), {label}: {s.decode_steps} steps, "
              f"accept rate {rate}, {s.decode_step_p50 * 1e3:.3f} ms/step "
              f"p50, {s.tokens_generated / wall:.1f} tokens/s, "
              f"{s.tokens_generated / max(1, s.decode_steps):.2f} tokens a "
              f"step, k history {list(s.spec_k_history)}")
        rep[label] = outs
        del eng
    for label in ("fixed spec_k=4", "adaptive spec_k=2..8"):
        ladder_streams(torch, ref, rp, rep["spec_k=0"], rep[label],
                       f"(c) {label}")
    # (d) a draft model on the card: gpt2-124m, eager
    dm = GPTForPretraining(DRAFT_MODEL, dtype="bfloat16", seed=seed + 1)
    timer = [0.0, 0]
    eng = Engine(model, spec_k=SPEC_K, draft_model=draft_model_fn(
        torch, dm, timer), **kw)
    n = DRAFT_N
    outs, s, wall, counts, _ = serve_arrivals(
        torch, eng, prompts[:n], [DRAFT_NEW] * n, SUBMIT_AT_STEP[:n])
    check(s.decode_traces == 1 and s.kv_pages_in_use == 0
          and counts["paged_attention"] == s.decode_steps * layers,
          f"(d): {s}, {counts}")
    ladder_streams(torch, ref, prompts[:n], [b[:DRAFT_NEW] for b in base[:n]],
                   outs, "(d) draft model")
    draft_ms = timer[0] / max(1, s.decode_steps) * 1e3
    step_ms = statistics.mean(eng.metrics.decode_step_s) * 1e3
    print(f"  (d) draft_model= {DRAFT_MODEL} (bf16, random weights from seed "
          f"{seed + 1}, eager forwards): {n} requests x {DRAFT_NEW}, "
          f"{s.decode_steps} verify steps (k={SPEC_K}); drafting "
          f"{draft_ms:.3f} ms a step ({timer[1]} drafter calls) beside "
          f"{step_ms - draft_ms:.3f} ms of the rest of the step (mean "
          f"{step_ms:.3f} ms with drafting); accept "
          f"rate {s.spec_accept_rate or 0.0:.4f} (random weights: two "
          "unrelated models agree near chance); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    del eng, dm
    # (e) A8.6
    a86_phase(torch, model, prompts, base, ref)
    del ref, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ A13: ViT, decoder, MoE
def float32_copy_check(torch, step, params, batch, ref, loss_fn, held,
                       label, shown=None, relax=False):
    """At dropout 0 (eval mode), the bf16 model's loss and grads on
    ``batch`` against ``ref``, a float32 copy of the model whose attention
    composes, given ``params`` first: every bf16 grad finite, the loss
    within REF_LOSS_RTOL, and cosine at least REF_GRAD_COS for each grad
    in ``held`` (a name, or ``(label, name, index into the first dim or
    None)``); ``shown`` is read and printed, not held. Beside each stands
    a control, the same bf16 model through the plain versions of the
    kernels (the reference's rounding points). With ``relax``, a held grad
    whose control lies below REF_GRAD_COS is held to the control's cosine
    less GRAD_COS_SLACK instead: bf16 moves some ReLU inputs across 0, and
    the grads behind such a flip differ from float32's by more than
    rounding, kernels or not. Leaves both models in eval mode."""
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    entries = [e if isinstance(e, tuple) else (e, e, None) for e in held]
    read = entries + ([shown if isinstance(shown, tuple)
                       else (shown, shown, None)] if shown else [])

    def pick(grads):
        return {lab: (grads[n] if i is None else grads[n][i]).float()
                for lab, n, i in read}

    step.model.eval()
    loss, grads = step.loss_and_grads(params, batch, 0)
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    got = pick(grads)
    del grads
    with plain_kernels(torch):
        ctrl_grads = pick(step.loss_and_grads(params, batch, 0)[1])
    ref.eval()
    ref_params = dict(ref.named_parameters())
    with torch.no_grad():
        for n, p in ref_params.items():
            p.copy_(params[n])
    fbatch = {k: v.float() if v.is_floating_point() else v
              for k, v in batch.items()}
    ref_loss, ref_grads = SpmdTrainStep(ref, loss_fn, AdamW()).loss_and_grads(
        ref_params, fbatch, 0)
    want = pick(ref_grads)
    del ref_params, ref_grads

    def cosines(grads):
        return {k: torch.nn.functional.cosine_similarity(
            g.flatten(), want[k].flatten(), dim=0).item()
            for k, g in grads.items()}

    cos, ctrl = cosines(got), cosines(ctrl_grads)
    bound = {lab: min(REF_GRAD_COS, ctrl[lab] - GRAD_COS_SLACK) if relax
             else REF_GRAD_COS for lab, _, _ in entries}
    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    del got, ctrl_grads, want
    gc.collect()
    torch.cuda.empty_cache()
    check(not bad, f"{label}: non-finite bf16 grads {bad[:4]}")
    check(rel <= REF_LOSS_RTOL, f"{label}: bf16 loss {loss.item()} vs "
          f"float32 {ref_loss.item()}: relative difference {rel}")
    check(all(cos[k] >= b for k, b in bound.items()),
          f"{label}: grad cosine {cos} below {bound}")
    print(f"  float32 copy (composed attention, dropout 0, "
          f"{len(next(iter(batch.values())))} sequences): loss "
          f"{loss.item():.6f} vs {ref_loss.item():.6f} (rel {rel:.2e} <= "
          f"{REF_LOSS_RTOL}); every bf16 grad finite; grad cosine "
          + ", ".join(f"{k} {cos[k]:.5f} (plain versions {ctrl[k]:.5f})"
                      for k in bound)
          + f" (>= {REF_GRAD_COS}"
          + (f", or the plain versions' less {GRAD_COS_SLACK}" if relax
             else "") + ")  ok"
          + (f"; {read[-1][0]} {cos[read[-1][0]]:.5f} (not held; plain "
             f"versions {ctrl[read[-1][0]]:.5f})" if shown else ""))


def f32_twin(torch, model, make):
    """``make()`` (the float32 model) with ``model``'s weights, every
    attention composed (``use_flash`` off), in eval mode."""
    ref = make()
    with torch.no_grad():
        for (n, p), (_, q) in zip(ref.named_parameters(),
                                  model.named_parameters()):
            p.copy_(q)
    for mod in ref.modules():
        if hasattr(mod, "use_flash"):
            mod.use_flash = False
    return ref.eval()


def vit_loss_fn(model, state, batch):
    """Mean cross-entropy of the classifier's logits (float32 inside)."""
    from torch.func import functional_call

    from paddle_tpu_torch.nn.functional import cross_entropy

    logits = functional_call(model, state, (batch["images"],))
    return cross_entropy(logits, batch["labels"])


def vit_b2_measurement(torch, card):
    """Not a gate: B2 at ViT-L/16's attention shape (B32 S197 H16 D64 bf16,
    no mask) forward and backward, beside SDPA and the composition the
    gate picks at 197 (`nn.functional.scaled_dot_product_attention` with
    ``use_flash=False``, its backward through autograd), with the
    kernel's largest error against SDPA's output."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as pF

    b, s, h, d = VIT_ATTN
    cases = [general_case(b, s, s, h, d, torch.bfloat16, seed=40 + i)
             for i in range(3)]
    it = iter(range(10 ** 9))
    saved = [fa.flash_attention_fwd(*c[:3], False) for c in cases]

    def fwd():
        fa.flash_attention_fwd(*cases[next(it) % 3][:3], False)

    def bwd():
        i = next(it) % 3
        fa.flash_attention_bwd(*cases[i][:3], *saved[i], cases[i][3], False)

    heads = [[x.transpose(1, 2).detach().requires_grad_(True)
              for x in c[:3]] + [c[3].transpose(1, 2)] for c in cases]
    comp = [[x.detach().requires_grad_(True) for x in c[:3]] + [c[3]]
            for c in cases]

    def lib(backward):
        def run():
            q, k, v, do = heads[next(it) % 3]
            out = F.scaled_dot_product_attention(q, k, v)
            if backward:
                out.backward(do)
        return run

    def composed(backward):
        def run():
            q, k, v, do = comp[next(it) % 3]
            out = pF.scaled_dot_product_attention(q, k, v, use_flash=False)
            if backward:
                out.backward(do)
        return run

    ms = {"B2": (time_ms(fwd, 20), time_ms(bwd, 10)),
          "SDPA": (time_ms(lib(False), 20), time_ms(lib(True), 10)),
          "composed": (time_ms(composed(False), 10),
                       time_ms(composed(True), 5))}
    q, k, v, _ = heads[0]
    want = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
    err = (saved[0][0].float() - want.float()).abs().max().item()
    print(f"  B2 at ViT's attention shape B{b} S{s} H{h} D{d} bf16, no mask "
          f"(not a gate; {card}): fwd / bwd ms: " + "; ".join(
              f"{k} {f:.4f} / {fb - f if k != 'B2' else fb:.4f}"
              for k, (f, fb) in ms.items())
          + f" (SDPA and composed bwd = fwd+bwd - fwd); B2's output within "
          f"{err:.3e} of SDPA's")
    return ms


def vit_phase(torch, seed, card):
    """Phase 20: ViT-L/16 (24 layers, width 1024, 16 heads of 64, MLP 4096,
    224 px, patch 16: 197 tokens), bf16, random weights from ``seed``.
    (a) The eval forward of b32 images: its logits at cosine >=
    REF_GRAD_COS with a float32 copy's, no kernel launched, images/s.
    (b) Training through `SpmdTrainStep` as one graph (AdamW lr 1e-4 wd
    0.05, cross-entropy over 1000 classes; benchmarks/bench_vit.py's
    operating point): the float32-copy check, TRAIN_STEPS timed
    replays under the armed sentinel in which no flash kernel launches
    (the gate composes at 197) and the update once a step, the first loss
    within 0.5 of ln 1000, images/s, step ms p50 and MFU by bench_vit.py's
    FLOP count; the replay-against-eager gate with its controls; a
    profile; then B2 at ViT's attention shape (`vit_b2_measurement`)."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.models.vit import VisionTransformer, vit_config
    from paddle_tpu_torch.optimizer import AdamW

    cfg = vit_config(VIT_MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    model = VisionTransformer(cfg, dtype="bfloat16", seed=seed)
    ref = f32_twin(torch, model, lambda: VisionTransformer(
        cfg, dtype="float32", seed=seed))
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (VIT_B, cfg.in_channels, cfg.image_size, cfg.image_size)
    batches = [{"images": torch.randn(shape, generator=g, device="cuda").to(
                    torch.bfloat16),
                "labels": torch.randint(0, cfg.num_classes, (VIT_B,),
                                        generator=g, device="cuda")}
               for _ in range(TRAIN_STEPS + 2)]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {VIT_MODEL}: {cfg.num_layers} layers, width "
          f"{cfg.hidden_size}, {cfg.num_heads} heads of "
          f"{cfg.hidden_size // cfg.num_heads}, MLP {cfg.mlp_dim}, "
          f"{cfg.image_size} px, patch {cfg.patch_size}: {cfg.seq_len} "
          f"tokens; {n_params} parameters; b{VIT_B}, bf16")
    images = batches[0]["images"]
    with torch.no_grad():
        kernels.reset_kernel_launch_counts()
        logits = model(images).float()
        only_launched(kernels.kernel_launch_counts(), {}, "ViT eval")
        want = ref(images.float())
        cos = torch.nn.functional.cosine_similarity(
            logits.flatten(), want.flatten(), dim=0).item()
        check(torch.isfinite(logits).all() and cos >= REF_GRAD_COS,
              f"ViT eval logits: cosine {cos} with the float32 copy's")
        fwd_ms = time_ms(lambda: model(images), 5, 2)
    print(f"  (a) eval forward: logits {tuple(logits.shape)} at cosine "
          f"{cos:.6f} with the float32 copy's (>= {REF_GRAD_COS}); no "
          f"kernel launched; {fwd_ms:.3f} ms a batch of {VIT_B}, "
          f"{VIT_B / fwd_ms * 1e3:.1f} images/s ({card})  ok")

    step = SpmdTrainStep(model, vit_loss_fn,
                         AdamW(learning_rate=TRAIN_LR, weight_decay=VIT_WD))
    params, opt_state = step.init(slot_dtype="bfloat16")
    last = cfg.num_layers - 1
    held = ["patch_embed.proj.weight", "blocks.0.self_attn.v_proj.weight",
            "blocks.0.linear1.weight", f"blocks.{last}.self_attn.v_proj"
            ".weight", f"blocks.{last}.linear1.weight", "head.weight"]
    two = {k: v[:2] for k, v in batches[0].items()}
    float32_copy_check(torch, step, params, two, ref, vit_loss_fn, held,
                       "ViT-L/16", relax=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    model.train()
    run = train_on_graphs(torch, step, params, opt_state, batches,
                          "ViT-L/16")
    losses, times, counts = run["losses"], run["times"], run["counts"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - math.log(cfg.num_classes)) < 0.5,
          f"first loss {losses[0]} is not within 0.5 of "
          f"ln({cfg.num_classes})")
    only_launched(counts, {"multi_tensor_adam": TRAIN_STEPS},
                  "ViT-L/16 training")
    p50 = sorted(times)[len(times) // 2] * 1e3
    img_s = VIT_B * TRAIN_STEPS / run["wall"]
    flops_per_img = (6 * n_params + 12 * cfg.num_layers * cfg.hidden_size
                     * cfg.seq_len) * cfg.seq_len
    mfu = img_s * flops_per_img / BF16_FLOPS_PER_S
    print(f"  (b) losses {[round(x, 4) for x in losses]} (the first within "
          f"0.5 of ln({cfg.num_classes}) = "
          f"{math.log(cfg.num_classes):.4f}); launches "
          f"{ {k: v for k, v in counts.items() if v} }: no flash kernel (the "
          f"gate composes at {cfg.seq_len}), the update once a step")
    print(f"  {card}: {img_s:.1f} images/s, step {p50:.3f} ms p50 (steps "
          f"{[round(t * 1e3, 3) for t in times]} ms), peak memory over the "
          f"replays {run['peak'] / 2 ** 30:.3f} GiB, MFU {mfu:.4f} "
          f"({flops_per_img} flops/image, bench_vit.py:77-83, over 989 "
          "TFLOP/s)")
    train_graph_check(torch, step, params, opt_state, batches, run,
                      "ViT-L/16")
    it = iter(range(100))

    def one():
        nonlocal params, opt_state
        i = next(it) % len(batches)
        _, params, opt_state = step(params, opt_state, batches[i], 100 + i)

    profile_steps(torch, one, 2, "ViT-L/16 training steps", ADAM_FAMILY)
    del model, step, params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    vit_b2_measurement(torch, card)


def transformer_model(torch, dtype, seed):
    """`nn.Transformer` at its defaults (the base model of Vaswani et al.
    2017), weights from ``seed`` (`nn.init_weights`, std 0.02)."""
    from paddle_tpu_torch.nn import Transformer, init_weights

    model = Transformer(dropout=TR_DROPOUT, device="cuda", dtype=dtype)
    with torch.no_grad():
        init_weights(model, seed, 0.02)
    model.requires_grad_(False)
    return model


def transformer_loss_fn(model, state, batch):
    """Mean squared error of the decoder's output against the batch's
    target, in float32."""
    from torch.func import functional_call

    out = functional_call(model, state, (batch["src"], batch["tgt"]),
                          {"tgt_mask": batch["tgt_mask"]})
    return (out.float() - batch["target"]).square().mean()


def transformer_phase(torch, seed, card):
    """Phase 21: the encoder-decoder `nn.Transformer` at its defaults
    (d_model 512, 8 heads of 64, 6+6 layers, FFN 2048, ReLU, post-LN),
    bf16, weights from ``seed``, on b32 batches of 256 source and 128
    target embeddings with ``generate_square_subsequent_mask(128)``. The
    float32 composed copy at dropout 0 (output cosine, loss, grads, no
    NaN); training through `SpmdTrainStep` as one graph at dropout 0.1
    (MSE against a random target), TRAIN_STEPS replays under the armed
    sentinel in which B5 launches steps x 6 times each way (the encoder's
    self-attention), B2 steps x 12 (the decoder's causal self-attention
    under the -inf bias and its cross-attention at Sq=128 Sk=256) and the
    update once a step, every loss finite; then incremental decode with
    `TransformerDecoder.gen_cache` over 128 steps against the full causal
    forward, row by row, within DECODE_OWN_ERRS times the bf16 model's own
    error against the float32 copy (the float32 copy's steps within
    TR_F32_DECODE of its full forward). Returns the B2 and B5 launch
    counts."""
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.nn import functional as pF
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    model = transformer_model(torch, torch.bfloat16, seed)
    mask = model.generate_square_subsequent_mask(TR_TGT)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def batch():
        return {"src": torch.randn((TR_B, TR_SRC, TR_D), generator=g,
                                   device="cuda").to(torch.bfloat16),
                "tgt": torch.randn((TR_B, TR_TGT, TR_D), generator=g,
                                   device="cuda").to(torch.bfloat16),
                "target": torch.randn((TR_B, TR_TGT, TR_D), generator=g,
                                      device="cuda"),
                "tgt_mask": mask}

    batches = [batch() for _ in range(TRAIN_STEPS + 2)]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  nn.Transformer() defaults: d_model {TR_D}, 8 heads of 64, 6+6 "
          f"layers, FFN 2048, ReLU, post-LN, dropout {TR_DROPOUT}; "
          f"{n_params} parameters, bf16; b{TR_B}, src {TR_SRC}, tgt "
          f"{TR_TGT} tokens, tgt_mask generate_square_subsequent_mask("
          f"{TR_TGT}) (-inf above the diagonal)")
    ref = f32_twin(torch, model, lambda: transformer_model(
        torch, torch.float32, seed))
    two = {k: (v[:2] if k != "tgt_mask" else v)
           for k, v in batches[0].items()}
    model.eval()
    with torch.no_grad():
        out = model(two["src"], two["tgt"], tgt_mask=mask).float()
        want = ref(two["src"].float(), two["tgt"].float(), tgt_mask=mask)
    cos = torch.nn.functional.cosine_similarity(out.flatten(),
                                                want.flatten(), dim=0).item()
    check(torch.isfinite(out).all() and cos >= REF_GRAD_COS,
          f"Transformer output cosine {cos} against the float32 copy")
    print(f"  float32 copy: output cosine {cos:.6f} (>= {REF_GRAD_COS}), no "
          "NaN  ok")
    step = SpmdTrainStep(model, transformer_loss_fn,
                         AdamW(learning_rate=TRAIN_LR, weight_decay=TRAIN_WD))
    params, opt_state = step.init(slot_dtype="bfloat16")
    float32_copy_check(torch, step, params, two, ref, transformer_loss_fn,
                       TR_HELD, "Transformer", relax=True)
    model.train()
    kinds = {"self": 0, "cross": 0}
    real = pF.flash_attention

    def counted(q, k, v, **kw):
        """B2's entry as sdpa calls it, its calls sorted by kind while
        the step is built (a replay runs no Python)"""
        mask = kw.get("attn_mask")
        if mask is not None and tuple(mask.shape) == (TR_TGT, TR_TGT):
            kinds["self"] += 1
        elif mask is None and (q.shape[1], k.shape[1]) == (TR_TGT, TR_SRC):
            kinds["cross"] += 1
        return real(q, k, v, **kw)

    pF.flash_attention = counted
    try:
        run = train_on_graphs(torch, step, params, opt_state, batches,
                              "Transformer")
    finally:
        pF.flash_attention = real
    check(kinds["self"] == kinds["cross"] and kinds["self"] > 0
          and kinds["self"] % TR_LAYERS == 0,
          f"Transformer: B2 calls while the step was built {kinds}: not "
          f"{TR_LAYERS} causal self-attentions under the [{TR_TGT}, "
          f"{TR_TGT}] bias and {TR_LAYERS} cross-attentions a pass")
    losses, times, counts = run["losses"], run["times"], run["counts"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    n = TRAIN_STEPS * TR_LAYERS
    want_counts = {"flash_attention_qkv3_fwd": n,
                   "flash_attention_qkv3_bwd": n,
                   "flash_attention_fwd": 2 * n, "flash_attention_bwd": 2 * n,
                   "multi_tensor_adam": TRAIN_STEPS}
    only_launched(counts, want_counts, "Transformer training")
    p50 = sorted(times)[len(times) // 2] * 1e3
    tok_s = TR_B * (TR_SRC + TR_TGT) * TRAIN_STEPS / run["wall"]
    print(f"  losses {[round(x, 5) for x in losses]} (all finite); launches "
          f"{ {k: v for k, v in counts.items() if v} }: B5 = steps x 6 "
          "each way, B2 = steps x 12 each way, the update once a step; B2's "
          f"calls while the step was built {kinds}: per pass 6 causal "
          f"self-attentions under the [{TR_TGT}, {TR_TGT}] -inf bias and 6 "
          f"cross-attentions at Sq={TR_TGT} Sk={TR_SRC}")
    print(f"  {card}: step {p50:.3f} ms p50 (steps "
          f"{[round(t * 1e3, 3) for t in times]} ms), {tok_s:.1f} tokens/s "
          f"(src + tgt), peak memory over the replays "
          f"{run['peak'] / 2 ** 30:.3f} GiB")
    del step, params, opt_state
    model.eval()
    tr_decode_check(torch, model, ref, batches[1], mask, card)
    del model, ref, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want_counts if k != "multi_tensor_adam"}


def tr_decode_check(torch, model, ref, batch, mask, card):
    """Incremental decode from the encoder's memory: per decoder layer a
    `Cache` (self-attention) and a `StaticCache` (the memory's keys and
    values), one target token a step over TR_TGT steps; each step's row
    against the full causal forward's, in bf16 and in ``ref``, the
    float32 copy, given ``model``'s weights first. Prints ms a step."""
    def decode(m, src, tgt):
        with torch.no_grad():
            memory = m.encoder(src)
            full = m.decoder(tgt, memory, tgt_mask=mask).float()
            cache = m.decoder.gen_cache(memory)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = []
            for i in range(TR_TGT):
                row, cache = m.decoder(tgt[:, i:i + 1], memory, cache=cache)
                rows.append(row)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TR_TGT
        return full, torch.cat(rows, 1).float(), ms

    with torch.no_grad():                 # the trained weights
        for p, q in zip(ref.parameters(), model.parameters()):
            p.copy_(q)
    src, tgt = batch["src"], batch["tgt"]
    full, inc, ms = decode(model, src, tgt)
    full32, inc32, _ = decode(ref, src.float(), tgt.float())
    own = (full - full32).abs().max().item()
    err = (inc - full).abs().amax(dim=(0, 2))           # a step's worst
    err32 = (inc32 - full32).abs().max().item()
    tol = DECODE_OWN_ERRS * own
    check(torch.isfinite(inc).all() and err.max().item() <= tol,
          f"incremental decode: worst step {err.argmax().item()} lies "
          f"{err.max().item()} from the full forward's row, beyond "
          f"{DECODE_OWN_ERRS} x the bf16 model's own error {own}")
    check(err32 <= TR_F32_DECODE, f"float32 incremental decode lies {err32} "
          "from its full forward")
    print(f"  incremental decode (gen_cache: a Cache and a StaticCache a "
          f"layer, {TR_TGT} steps from the encoder's memory): every step's "
          f"row within {err.max().item():.3e} of the full causal forward's "
          f"(<= {tol:.3e}, {DECODE_OWN_ERRS} x the bf16 model's own error "
          "against float32)"
          f"; float32 copy {err32:.2e} (<= {TR_F32_DECODE}); {ms:.3f} ms a "
          f"step ({card})  ok")


def fmt_phase(torch, seed, card):
    """Phase 22: `incubate.nn.FusedMultiTransformer` at gpt3-1.3b's widths
    (2048 wide, 16 heads of 128, FFN 8192, 24 layers, GELU), bf16,
    weights from ``seed``, eagerly: 8 prompts of 128 random embeddings
    prefilled into ``gen_cache(8, 640)``, then 32 decode steps with
    ``time_step``; every row (the prefill's and each step's) against the
    no-cache forward's over all 160 tokens under a causal additive mask,
    within DECODE_OWN_ERRS times the bf16 model's own error against a
    float32 copy; a
    ``pre_caches`` arm (32 tokens prefilled alone, carved out, the other
    96 prefilled against them) against the one-shot prefill. No kernel of
    the port launches (the reference composes this attention). Prints
    prefill ms and decode ms a step."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.nn import init_weights

    def stack(dtype):
        m = FusedMultiTransformer(FMT_WIDTH, FMT_HEADS, FMT_FFN,
                                  num_layers=FMT_LAYERS, device="cuda",
                                  dtype=dtype)
        with torch.no_grad():
            init_weights(m, seed, 0.02)
        return m.requires_grad_(False).eval()

    gc.collect()
    torch.cuda.empty_cache()
    model = stack(torch.bfloat16)
    total = FMT_PROMPT + FMT_NEW
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((FMT_B, total, FMT_WIDTH), generator=g,
                    device="cuda").to(torch.bfloat16)
    causal = torch.full((total, total), -1e9, device="cuda").triu(1)[None,
                                                                    None]
    print(f"  FusedMultiTransformer({FMT_WIDTH}, {FMT_HEADS}, {FMT_FFN}, "
          f"num_layers={FMT_LAYERS}), GELU, bf16; {FMT_B} prompts of "
          f"{FMT_PROMPT} random embeddings into gen_cache({FMT_B}, "
          f"{FMT_MAX_LEN}), then {FMT_NEW} decode steps")
    kernels.reset_kernel_launch_counts()
    with torch.no_grad():
        full = model(x, attn_mask=causal).float()
        ref = stack(torch.float32)
        for p, q in zip(ref.parameters(), model.parameters()):
            p.copy_(q)
        full32 = ref(x.float(), attn_mask=causal)
        del ref
        torch.cuda.empty_cache()
        own = (full - full32).abs().max().item()
        tol = DECODE_OWN_ERRS * own
        caches = model.gen_cache(FMT_B, FMT_MAX_LEN)
        prefill_s = []
        for _ in range(3):       # each call rewrites the same columns
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pre, caches = model(x[:, :FMT_PROMPT], caches=caches)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        prefill_ms = statistics.median(prefill_s) * 1e3
        rows, step_s = [], []
        for t in range(FMT_PROMPT, total):
            ts = torch.full((1,), t, dtype=torch.int32, device="cuda")
            t0 = time.perf_counter()
            row, caches = model(x[:, t:t + 1], caches=caches, time_step=ts)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            rows.append(row.float())
        step_err = (torch.cat(rows, 1) - full[:, FMT_PROMPT:]).abs().amax(
            dim=(0, 2))
        pre_err = (pre.float() - full[:, :FMT_PROMPT]).abs().max().item()
        # the pre_caches arm: FMT_PRE tokens alone, carved out, the rest
        # of the prompt against them
        part = model.gen_cache(FMT_B, FMT_MAX_LEN)
        _, part = model(x[:, :FMT_PRE], caches=part)
        carved = [c[:, :, :, :FMT_PRE] for c in part]
        rest, _ = model(x[:, FMT_PRE:FMT_PROMPT],
                        caches=model.gen_cache(FMT_B, FMT_MAX_LEN),
                        pre_caches=carved)
        pc_err = (rest.float() - pre[:, FMT_PRE:].float()).abs().max().item()
    counts = kernels.kernel_launch_counts()
    only_launched(counts, {}, "FusedMultiTransformer")
    check(all(torch.isfinite(r).all() for r in rows), "non-finite rows")
    check(pre_err <= tol and step_err.max().item() <= tol and pc_err <= tol,
          f"FusedMultiTransformer: prefill rows {pre_err}, worst decode "
          f"step {step_err.argmax().item()} at {step_err.max().item()}, "
          f"pre_caches arm {pc_err}: beyond {DECODE_OWN_ERRS} x the bf16 "
          f"model's own error {own}")
    step_ms = statistics.median(step_s) * 1e3
    print(f"  prefill rows within {pre_err:.3e}, each of the {FMT_NEW} "
          f"decode steps' rows within {step_err.max().item():.3e} of the "
          f"no-cache forward's last row, the pre_caches arm ({FMT_PRE} "
          f"tokens carved out) within {pc_err:.3e} of the one-shot "
          f"prefill (all <= {tol:.3e}, {DECODE_OWN_ERRS} x the bf16 model's "
          "own error against float32); no kernel launched  ok")
    print(f"  {card}: prefill {prefill_ms:.3f} ms p50 of 3 ({FMT_B} x "
          f"{FMT_PROMPT}; {[round(t * 1e3, 3) for t in prefill_s]}), "
          f"decode {step_ms:.3f} ms a step p50 (eager, {FMT_B} rows, cache "
          f"{FMT_MAX_LEN})")
    del model, caches, part, carved, full, full32
    gc.collect()
    torch.cuda.empty_cache()


def one_expert(torch, stacked, i):
    """Expert ``i`` of an `ExpertFFN` as a module of its own, the
    reference's listed form: ``[g, c, m] -> [g, c, m]`` through the same
    `stacked_expert_ffn` on its slice."""
    from paddle_tpu_torch.distributed import moe

    class Expert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n in ("w1", "b1", "w2", "b2"):
                setattr(self, n, torch.nn.Parameter(
                    getattr(stacked, n)[i:i + 1].detach().clone(),
                    requires_grad=False))

        def forward(self, x):
            return moe.stacked_expert_ffn(x[None], self.w1, self.b1, self.w2,
                                          self.b2)[0]

    return Expert()


def moe_phase(torch, seed, card):
    """Phase 23: `MoELayer` in place of a dense FFN at gpt3-1.3b's width:
    d_model 2048, 8 experts of 8192 (stacked, `ExpertFFN`), `GShardGate`
    top-2 at capacity factor 1.25, on b8 x s1024 tokens (capacity 320),
    bf16, weights from ``seed``. Forward and backward (loss mean(y^2) +
    0.01 aux) against a float32 copy: the dispatch equal on every token
    whose gates' margins (first to second, second to third) exceed
    MOE_TIE, output and grads (input, gate, w1, w2) at cosine >=
    REF_GRAD_COS, every grad finite; the same layer with listed experts
    equal to the stacked one within 2 bf16 ulps of the output's scale;
    no kernel of the port launches. Prints forward and forward+backward
    ms."""
    from torch.func import functional_call

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ExpertFFN, GShardGate, MoELayer)
    from paddle_tpu_torch.nn import init_weights

    def layer(dtype):
        kw = dict(device="cuda", dtype=dtype)
        m = MoELayer(MOE_D, experts=ExpertFFN(MOE_E, MOE_D, MOE_H, **kw),
                     gate=GShardGate(MOE_D, MOE_E, topk=2,
                                     capacity=(MOE_CF, 2 * MOE_CF), **kw))
        with torch.no_grad():
            init_weights(m, seed, 0.02)
        return m.requires_grad_(False)

    gc.collect()
    torch.cuda.empty_cache()
    model, ref = layer(torch.bfloat16), layer(torch.float32)
    with torch.no_grad():
        for p, q in zip(ref.parameters(), model.parameters()):
            p.copy_(q)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((MOE_B, MOE_S, MOE_D), generator=g,
                    device="cuda").to(torch.bfloat16)
    cap = max(1, int(MOE_CF * 2 * MOE_S / MOE_E))
    print(f"  MoELayer(d_model {MOE_D}): {MOE_E} experts of {MOE_H} "
          f"(ExpertFFN, tanh GELU), GShardGate top-2, capacity factor "
          f"{MOE_CF}; b{MOE_B} x s{MOE_S} tokens, capacity {cap} a group; "
          "bf16")

    def run(m, xv):
        ps = {n: p.detach().requires_grad_(True)
              for n, p in m.named_parameters()}
        xr = xv.detach().requires_grad_(True)
        y = functional_call(m, ps, (xr,))
        loss = y.float().square().mean() + 0.01 * m.gate.loss
        loss.backward()
        return y.detach(), {"x": xr.grad, **{n: p.grad
                                             for n, p in ps.items()}}

    kernels.reset_kernel_launch_counts()
    y, grads = run(model, x)
    only_launched(kernels.kernel_launch_counts(), {}, "MoE")
    y32, grads32 = run(ref, x.float())
    # the dispatch: recomputed from each layer's gate logits
    with torch.no_grad():
        def gating(m, xv):
            logits = torch.einsum("gsm,me->gse", xv.float(),
                                  m.gate.weight.float())
            c, d, _ = moe.top_k_gating(logits, k=2, capacity_factor=MOE_CF)
            gates = torch.softmax(logits, -1).sort(-1, descending=True)[0]
            return d, gates

        d16, gates = gating(model, x)
        d32, _ = gating(ref, x.float())
        clear = ((gates[..., 0] - gates[..., 1] > MOE_TIE)
                 & (gates[..., 1] - gates[..., 2] > MOE_TIE))
        differ = (d16 != d32).any(-1).any(-1)
        bad = int((differ & clear).sum())
        near = int((~clear).sum())
    check(bad == 0, f"MoE dispatch differs on {bad} tokens clear of ties")

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0).item()

    held = {"y": cos(y, y32), "dx": cos(grads["x"], grads32["x"]),
            **{n: cos(grads[n], grads32[n])
               for n in ("gate.weight", "experts.w1", "experts.w2")}}
    finite = all(torch.isfinite(v).all() for v in grads.values())
    check(finite and min(held.values()) >= REF_GRAD_COS,
          f"MoE against float32: cosine {held}, grads finite {finite}")
    listed = MoELayer(MOE_D, experts=[one_expert(torch, model.experts, i)
                                      for i in range(MOE_E)],
                      gate=model.gate)
    with torch.no_grad():
        stacked_y, listed_y = model(x), listed(x)
    gap = (listed_y.float() - stacked_y.float()).abs().max().item()
    bound = 2 * 2.0 ** -8 * stacked_y.float().abs().max().item()
    check(gap <= bound, f"MoE listed experts lie {gap} from the stacked "
          f"ones (bound {bound})")

    def fwd():
        with torch.no_grad():
            model(x)

    def fwd_bwd():
        run(model, x)

    ms = (time_ms(fwd, 5, 2), time_ms(fwd_bwd, 3, 1))
    print(f"  dispatch equal on every token clear of ties ({near} of "
          f"{MOE_B * MOE_S} within {MOE_TIE} of one); against float32: "
          "cosine " + ", ".join(f"{k} {v:.6f}" for k, v in held.items())
          + f" (>= {REF_GRAD_COS}), every grad finite; listed experts "
          f"within {gap:.3e} of the stacked ones (<= {bound:.3e}); no "
          "kernel launched  ok")
    print(f"  {card}: forward {ms[0]:.3f} ms, forward+backward {ms[1]:.3f} "
          "ms (device time)")
    del model, ref, listed, grads, grads32
    gc.collect()
    torch.cuda.empty_cache()


def layer_base_model():
    """Phase 24's model: `nn.Transformer()` at its defaults built on the
    card from the reference's initializers, no `init_weights`: every
    projection weight ``ParamAttr(XavierNormal(), learning_rate=0.5,
    regularizer=L2Decay(1e-4))``, every projection bias
    ``ParamAttr(need_clip=False)``, the LayerNorms at their defaults."""
    from paddle_tpu_torch import ParamAttr
    from paddle_tpu_torch.nn import Transformer
    from paddle_tpu_torch.nn.initializer import XavierNormal
    from paddle_tpu_torch.regularizer import L2Decay

    return Transformer(
        dropout=TR_DROPOUT, weight_attr=ParamAttr(
            initializer=XavierNormal(), learning_rate=LB_RATE,
            regularizer=L2Decay(LB_L2)),
        bias_attr=ParamAttr(need_clip=False))


def initializer_check(torch, model, label):
    """Every fresh parameter of ``model`` by the reference's rule: each
    projection weight XavierNormal (mean within LB_SIGMAS sampling sigmas
    of 0, std within LB_SIGMAS of sqrt(2 / (fan_in + fan_out))), every
    bias and LayerNorm shift zero, every LayerNorm scale one, all on the
    card and finite. Returns the worst |z| of the std."""
    from paddle_tpu_torch.nn.initializer import _fan_in_out

    worst = 0.0
    for n, p in model.named_parameters():
        v = p.detach().float()
        check(v.is_cuda and torch.isfinite(v).all(),
              f"{label}: {n} not finite on the card")
        if v.dim() == 2:
            fi, fo = _fan_in_out(tuple(v.shape))
            std = math.sqrt(2.0 / (fi + fo))
            z_mean = v.mean().item() / (std / math.sqrt(v.numel()))
            z_std = (v.std().item() - std) / (std / math.sqrt(2 * v.numel()))
            check(abs(z_mean) <= LB_SIGMAS and abs(z_std) <= LB_SIGMAS,
                  f"{label}: {n} mean z {z_mean:.2f}, std z {z_std:.2f} "
                  f"against XavierNormal's std {std:.5f}")
            worst = max(worst, abs(z_std))
        else:
            want = 1.0 if "norm" in n and n.endswith("weight") else 0.0
            check(bool((v == want).all()), f"{label}: {n} is not all "
                  f"{want}")
    return worst


def layer_base_phase(torch, seed, card):
    """Phase 24: A5's layer base on the card. `nn.Transformer()` at its
    defaults (phase 21's model) built from the reference's initializers
    (`layer_base_model`, no `init_weights`; drawn from a generator
    seeded with ``seed``): every fresh weight checked
    against its initializer (`initializer_check`) and its attrs read
    back; one LayerNorm (encoder layer 0's first) set ``trainable=False``;
    the model cast with ``astype("bfloat16")``. A float32 copy agrees on
    loss and grads at dropout 0 (`float32_copy_check`, as phase 21, on
    LB_HELD's grads, LB_SHOWN's shown). Then
    LB_STEPS eager steps of ``AdamW(parameters=model.parameters(),
    multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))`` on phase
    21's batches (``loss.backward(); opt.step(); opt.clear_grad()``,
    dropout 0.1): with the launch counts zeroed just before and read
    just after, B5 launches 6 times each way a step, B2 12 times and the
    update once (one group: bf16 params with float32 masters, the rate
    scales in the entries); every loss finite; the frozen LayerNorm bit
    for bit. Then ``state_dict`` through `framework.io.save` / ``load``
    onto the card into a twin built under `LazyGuard` (on ``meta``) and
    ``initialize()``d on the card (checked as above), cast and
    ``set_state_dict``: every entry bit for bit, the twin's eval forward
    the model's bit for bit. Prints the eager step's ms beside the card
    and a profile of two more steps. Returns the B2 and B5 launch
    counts."""
    import tempfile

    from paddle_tpu_torch import LazyGuard, framework, kernels
    from paddle_tpu_torch.core.random import rng_guard, step_generator
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    with rng_guard(step_generator(seed, "cuda")):
        model = layer_base_model()
    worst = initializer_check(torch, model, "fresh Transformer")
    w = model.get_parameter("decoder.layers.5.linear1.weight")
    b = model.get_parameter("encoder.layers.0.self_attn.q_proj.bias")
    check(w.optimize_attr == {"learning_rate": LB_RATE}
          and w.regularizer._coeff == LB_L2 and w.need_clip
          and not b.need_clip and b.optimize_attr["learning_rate"] == 1.0,
          "ParamAttr's learning_rate, regularizer and need_clip not on "
          "the parameters")
    frozen = model.encoder.layers[0].norm1
    for p in frozen.parameters():
        p.trainable = False
    model.astype("bfloat16")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()),
          "astype('bfloat16') left a float parameter")
    frozen_start = [p.detach().clone() for p in frozen.parameters()]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  nn.Transformer() defaults from the reference's initializers "
          f"(no init_weights): weights XavierNormal, learning_rate "
          f"{LB_RATE}, L2Decay({LB_L2}); biases need_clip=False; {n_params} "
          f"parameters, every fresh weight's std within {worst:.2f} "
          f"sampling sigmas of XavierNormal's (<= {LB_SIGMAS}), biases 0, "
          "LayerNorm scales 1; encoder.layers.0.norm1 trainable=False; "
          "astype('bfloat16')  ok")

    mask = model.generate_square_subsequent_mask(TR_TGT)
    g = torch.Generator(device="cuda").manual_seed(seed + 24)

    def batch():
        return {"src": torch.randn((TR_B, TR_SRC, TR_D), generator=g,
                                   device="cuda").to(torch.bfloat16),
                "tgt": torch.randn((TR_B, TR_TGT, TR_D), generator=g,
                                   device="cuda").to(torch.bfloat16),
                "target": torch.randn((TR_B, TR_TGT, TR_D), generator=g,
                                      device="cuda"),
                "tgt_mask": mask}

    batches = [batch() for _ in range(LB_STEPS)]
    ref = f32_twin(torch, model, lambda: transformer_model(
        torch, torch.float32, seed))
    two = {k: (v[:2] if k != "tgt_mask" else v)
           for k, v in batches[0].items()}
    float32_copy_check(
        torch, SpmdTrainStep(model, transformer_loss_fn, AdamW()),
        {n: p.detach() for n, p in model.named_parameters()}, two, ref,
        transformer_loss_fn, LB_HELD, "Transformer (layer base)",
        shown=LB_SHOWN, relax=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    model.train()
    def eager_step(bt):
        out = model(bt["src"], bt["tgt"], tgt_mask=mask)
        loss = (out.float() - bt["target"]).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses, times = [], []
    torch.cuda.synchronize()
    kernels.reset_kernel_launch_counts()
    for bt in batches:
        t0 = time.perf_counter()
        loss = eager_step(bt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = kernels.kernel_launch_counts()
    n = LB_STEPS * TR_LAYERS
    want_counts = {"flash_attention_qkv3_fwd": n,
                   "flash_attention_qkv3_bwd": n,
                   "flash_attention_fwd": 2 * n, "flash_attention_bwd": 2 * n,
                   "multi_tensor_adam": LB_STEPS}
    only_launched(counts, want_counts, "eager Transformer training")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(all(torch.equal(a, p.detach()) for a, p in
              zip(frozen_start, frozen.parameters())),
          "the frozen LayerNorm moved")
    p50 = statistics.median(times[1:]) * 1e3
    print(f"  {LB_STEPS} eager steps (AdamW multi_precision, global-norm "
          f"clip 1.0, lr {TRAIN_LR} x the rate scales): losses "
          f"{[round(x, 5) for x in losses]} (all finite); launches "
          f"{ {k: v for k, v in counts.items() if v} }: B5 = steps x 6 "
          "each way, B2 = steps x 12 each way, the update once a step; "
          "the frozen LayerNorm bit for bit  ok")
    print(f"  {card}: eager step {p50:.3f} ms p50 of steps 2-{LB_STEPS} "
          f"(steps {[round(t * 1e3, 3) for t in times]} ms)")
    profile_steps(torch, lambda: eager_step(batches[0]), 2,
                  "eager Transformer steps", families=ADAM_FAMILY)

    sd = model.state_dict()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "transformer.pdparams")
        framework.save(sd, path)
        loaded = framework.load(path, device="cuda")
    with LazyGuard():
        twin = layer_base_model()
    check(all(p.is_meta for p in twin.parameters()),
          "a parameter built under LazyGuard holds memory")
    with rng_guard(step_generator(seed + 1, "cuda")):
        for p in twin.parameters():
            p.initialize()
    initializer_check(torch, twin, "LazyGuard twin")
    twin.astype("bfloat16")
    missing, unexpected = twin.set_state_dict(loaded)
    got = twin.state_dict()
    check(not missing and not unexpected and list(got) == list(sd)
          and all(torch.equal(got[k], v) for k, v in sd.items()),
          f"state_dict round trip: missing {missing}, unexpected "
          f"{unexpected}, or an entry not bit for bit")
    model.eval()
    twin.eval()
    with torch.no_grad():
        a = model(two["src"], two["tgt"], tgt_mask=mask)
        b = twin(two["src"], two["tgt"], tgt_mask=mask)
    check(torch.equal(a, b), "the twin's forward is not the model's")
    print(f"  state_dict ({len(sd)} entries) -> framework.save/load onto the "
          "card -> set_state_dict of a twin built under LazyGuard (meta) "
          "and initialize()d on the card (its draws checked): bit for bit, "
          "the eval forward too  ok")
    del model, twin, opt, sd, loaded, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want_counts if k != "multi_tensor_adam"}


# ------------------------------------------------ A5 slice 2: ResNet-50
def tensor_agreement(torch, got, want):
    """``(cosine, max error / largest |want|, relative L2 error)`` of
    ``got`` against ``want``, in float64."""
    a, b = got.detach().double().flatten(), want.detach().double().flatten()
    scale = b.abs().max().clamp(min=1e-30)
    return (torch.nn.functional.cosine_similarity(a, b, dim=0).item(),
            ((a - b).abs().max() / scale).item(),
            ((a - b).norm() / b.norm().clamp(min=1e-30)).item())


def worst_agreement(torch, got, want):
    """Over name -> tensor dicts: the least cosine, the largest max error
    and the largest relative L2 error, each with its tensor's name."""
    rows = {n: tensor_agreement(torch, got[n], want[n]) for n in want}
    cos = min((v[0], n) for n, v in rows.items())
    err = max((v[1], n) for n, v in rows.items())
    l2 = max((v[2], n) for n, v in rows.items())
    return cos, err, l2


def resnet_pass(torch, model, images, labels, train, f64=False):
    """One forward and backward of ``model`` in train (or eval) mode:
    ``(loss, logits, grads by name)``, the grads left on the parameters
    (a train-mode pass is then a step's). The float32 model's loss is
    `nn.CrossEntropyLoss`; the float64 copy's the same mean
    cross-entropy in float64 (the fused path keeps float32 statistics)."""
    from paddle_tpu_torch import nn

    model.train(train)
    model.zero_grad(set_to_none=True)
    logits = model(images)
    if f64:
        loss = -torch.log_softmax(logits, -1).gather(
            1, labels[:, None]).mean()
    else:
        loss = nn.CrossEntropyLoss()(logits, labels)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return loss.detach(), logits.detach(), grads


def resnet_f64_check(torch, model, twin, images, labels, train):
    """The float32 ``model`` against its float64 ``twin`` on one batch
    (train or eval mode): the loss, the logits, every grad and, in train
    mode, every running statistic the pass leaves (RN_* bounds), printed
    before they are checked. Returns the float32 pass."""
    loss, logits, grads = resnet_pass(torch, model, images, labels, train)
    loss64, logits64, grads64 = resnet_pass(
        torch, twin, images.double(), labels, train, f64=True)
    rel = abs(loss.item() - loss64.item()) / abs(loss64.item())
    lcos, lerr, _ = tensor_agreement(torch, logits, logits64)
    (gcos, gn), (gerr, en), (gl2, ln) = worst_agreement(torch, grads,
                                                        grads64)
    mode = "train" if train else "eval"
    line = (f"  float64 copy, {mode} mode: loss {loss.item():.7f} vs "
            f"{loss64.item():.7f} (rel {rel:.2e}; <= {RN_LOSS_RTOL}); logits "
            f"cosine {lcos:.7f}, max error {lerr:.2e} (<= {RN_MAX_ERR}); "
            f"every grad: least cosine {gcos:.7f} ({gn}), largest max error "
            f"{gerr:.2e} ({en}), largest relative L2 error {gl2:.2e} ({ln})")
    if train:
        (bcos, bn), (berr, bn2), _ = worst_agreement(
            torch, dict(model.named_buffers()), dict(twin.named_buffers()))
        print(line + f" (held: cosine >= {RN_TRAIN_COS}, relative L2 <= "
              f"{RN_TRAIN_L2}; a train-mode batch norm magnifies float32 "
              f"rounding); every _mean and _variance after the step: least "
              f"cosine {bcos:.7f} ({bn}), largest max error {berr:.2e} "
              f"({bn2}; <= {RN_MAX_ERR})")
    else:
        print(line + f" (held: cosine >= {RN_COS}, max error <= "
              f"{RN_GRAD_MAX_ERR})")
    check(math.isfinite(loss.item()) and rel <= RN_LOSS_RTOL,
          f"ResNet-50 {mode}: loss {loss.item()} against float64 "
          f"{loss64.item()} (rel {rel})")
    check(lcos >= RN_COS and lerr <= RN_MAX_ERR,
          f"ResNet-50 {mode}: logits cosine {lcos}, max error {lerr}")
    if train:
        check(gcos >= RN_TRAIN_COS and gl2 <= RN_TRAIN_L2,
              f"ResNet-50 train: grad {gn} cosine {gcos}, {ln} relative "
              f"L2 error {gl2}")
        check(bcos >= RN_COS and berr <= RN_MAX_ERR,
              f"ResNet-50 running statistics after a step: {bn} cosine "
              f"{bcos}, {bn2} max error {berr}")
    else:
        check(gcos >= RN_COS and gerr <= RN_GRAD_MAX_ERR,
              f"ResNet-50 eval: grad {gn} cosine {gcos}, {en} max error "
              f"{gerr}")
    print("  ok")
    return loss, logits, grads


def bn_formula(torch, x, mean, var, weight, bias, eps):
    """A batch norm's output by its formula, in float64."""
    shape = (1, -1, 1, 1)
    return ((x.double() - mean.double().reshape(shape))
            / (var.double().reshape(shape) + eps).sqrt()
            * weight.double().reshape(shape) + bias.double().reshape(shape))


def within_scale(torch, got, want, tol):
    err = (got.double() - want.double()).abs().max()
    return (err / want.double().abs().max()).item() <= tol, \
        (err / want.double().abs().max()).item()


def resnet_phase(torch, seed, card):
    """Phase 25a: the reference's `resnet50()` at its defaults (1000
    classes, 224 px, NCHW, float32 with TF32 off) built on the card from
    the reference's default initializers (no `init_weights`), drawn from
    a generator seeded with ``seed``, trained eagerly as a user's loop
    does: `nn.CrossEntropyLoss`, ``Momentum(learning_rate=0.01,
    momentum=0.9)``, ``loss.backward(); opt.step(); opt.clear_grad()``,
    RN_STEPS steps on random b32 images and labels from ``seed``. Before
    the first step a float64 copy (the same weights) holds the eval-mode
    pass on the first batch; the first step's own pass is held against
    the copy's train-mode pass, the running statistics it leaves too, and
    bn1's against ``0.9 * init + 0.1 * (batch mean, biased batch var)``
    of its input. Prints the step's ms p50 over steps 2-RN_STEPS,
    images/s, the peak memory and a profile of one step. Then in eval
    mode bn1's output is its formula on ``_mean``/``_variance`` and
    differs from the train-mode formula's; the state dict goes through
    `framework.save`/``load`` into a `LazyGuard` twin ``initialize()``d
    on the card: its state dict and eval forward bit for bit."""
    import copy
    import tempfile

    from paddle_tpu_torch import LazyGuard, framework, nn, vision
    from paddle_tpu_torch.core.random import rng_guard, step_generator
    from paddle_tpu_torch.optimizer import Momentum

    gc.collect()
    torch.cuda.empty_cache()
    with rng_guard(step_generator(seed, "cuda")):
        model = vision.resnet50()
    check(model.fc.weight.shape == (2048, RN_CLASSES)
          and all(p.is_cuda and p.dtype == torch.float32
                  for p in model.parameters())
          and model.bn1._mean.is_cuda, "resnet50() not built float32 on "
          "the card")
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed + 25)
    batches = [(torch.randn((RN_B, 3, RN_HW, RN_HW), generator=g,
                            device="cuda"),
                torch.randint(0, RN_CLASSES, (RN_B,), generator=g,
                              device="cuda")) for _ in range(RN_STEPS)]
    print(f"  resnet50(): {n_params} parameters, 53 batch norms, drawn from "
          f"the reference's initializers; b{RN_B} x 3 x {RN_HW} x {RN_HW} "
          f"float32 images, {RN_CLASSES} classes")

    twin = copy.deepcopy(model).double()
    resnet_f64_check(torch, model, twin, *batches[0], train=False)
    model.zero_grad(set_to_none=True)
    opt = Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM,
                   parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()

    seen = {}
    hook = model.bn1.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("x", args[0].detach().clone()))
    init = (model.bn1._mean.clone(), model.bn1._variance.clone())
    # step 1: its pass held against the float64 copy's, then the update
    loss = resnet_f64_check(torch, model, twin, *batches[0], train=True)[0]
    hook.remove()
    del twin
    opt.step()
    opt.clear_grad()
    losses = [loss.item()]
    var, mean = torch.var_mean(seen["x"].double(), dim=(0, 2, 3),
                               correction=0)
    ok_m, err_m = within_scale(torch, model.bn1._mean,
                               0.9 * init[0].double() + 0.1 * mean,
                               RN_BN_TOL)
    ok_v, err_v = within_scale(torch, model.bn1._variance,
                               0.9 * init[1].double() + 0.1 * var,
                               RN_BN_TOL)
    check(ok_m and ok_v, f"bn1's running statistics off the reference's "
          f"convention: max errors {err_m}, {err_v}")
    print(f"  bn1 after the step: _mean, _variance = 0.9 x init + 0.1 x "
          f"(batch mean, biased batch variance) of its input, computed in "
          f"float64 on the card: max errors {err_m:.2e}, {err_v:.2e} (<= "
          f"{RN_BN_TOL})  ok")

    def step(images, labels):
        out = loss_fn(model(images), labels)
        out.backward()
        opt.step()
        opt.clear_grad()
        return out

    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for images, labels in batches[1:]:
        t0 = time.perf_counter()
        out = step(images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out.item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    p50 = statistics.median(times) * 1e3
    print(f"  {RN_STEPS} eager steps (Momentum {RN_LR}, {RN_MOMENTUM}; "
          f"nn.CrossEntropyLoss): losses {[round(x, 5) for x in losses]} "
          "(all finite)  ok")
    print(f"  {card}: eager step {p50:.3f} ms p50 of steps 2-{RN_STEPS} "
          f"(steps {[round(t * 1e3, 3) for t in times]} ms), "
          f"{RN_B / p50 * 1e3:.1f} images/s, peak {peak:.3f} GiB")
    profile_steps(torch, lambda: step(*batches[0]), 1,
                  "eager ResNet-50 step")

    model.eval()
    seen = {}
    hook = model.bn1.register_forward_hook(
        lambda mod, args, out: seen.update(x=args[0].detach(),
                                           y=out.detach()))
    with torch.no_grad():
        want = model(batches[1][0])
    hook.remove()
    bn1 = model.bn1
    formula = bn_formula(torch, seen["x"], bn1._mean, bn1._variance,
                         bn1.weight, bn1.bias, bn1._epsilon)
    ok, err = within_scale(torch, seen["y"], formula, RN_BN_TOL)
    var, mean = torch.var_mean(seen["x"].double(), dim=(0, 2, 3),
                               correction=0)
    trained = bn_formula(torch, seen["x"], mean, var, bn1.weight, bn1.bias,
                         bn1._epsilon)
    _, apart = within_scale(torch, seen["y"], trained, 0.0)
    check(ok and apart > 1e-2, f"eval bn1: max error {err} against its "
          f"running-statistics formula; {apart} from the batch's")
    print(f"  eval mode: bn1's output is its formula on _mean/_variance "
          f"(max error {err:.2e} <= {RN_BN_TOL}) and lies {apart:.3f} of "
          "its scale from the train-mode (batch statistics) one  ok")

    sd = model.state_dict()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resnet50.pdparams")
        framework.save(sd, path)
        loaded = framework.load(path, device="cuda")
    with LazyGuard():
        lazy = vision.resnet50()
    check(all(p.is_meta for p in lazy.parameters()),
          "a parameter built under LazyGuard holds memory")
    with rng_guard(step_generator(seed + 1, "cuda")):
        for p in lazy.parameters():
            p.initialize()
    check(all(p.is_cuda for p in lazy.parameters()),
          "LazyGuard twin not initialized on the card")
    missing, unexpected = lazy.set_state_dict(loaded)
    got = lazy.state_dict()
    check(not missing and not unexpected and list(got) == list(sd)
          and all(torch.equal(got[k], v) for k, v in sd.items()),
          f"state_dict round trip: missing {missing}, unexpected "
          f"{unexpected}, or an entry not bit for bit")
    lazy.eval()
    with torch.no_grad():
        check(torch.equal(lazy(batches[1][0]), want),
              "the twin's eval forward is not the model's")
    print(f"  state_dict ({len(sd)} entries, 106 of them batch-norm buffers) "
          "-> framework.save/load onto the card -> set_state_dict of a twin "
          "built under LazyGuard and initialize()d on the card: bit for "
          "bit, the eval forward too  ok")
    del model, lazy, opt, sd, loaded, batches, seen
    gc.collect()
    torch.cuda.empty_cache()


def gelu_mse_loss_fn(model, state, batch):
    """`nn.MSELoss` of the decoder's output (in float32) against the
    batch's target."""
    from torch.func import functional_call

    from paddle_tpu_torch.nn import MSELoss

    out = functional_call(model, state, (batch["src"], batch["tgt"]),
                          {"tgt_mask": batch["tgt_mask"]})
    return MSELoss()(out.float(), batch["target"])


def gelu_transformer_phase(torch, seed, card):
    """Phase 25b: phase 24's `nn.Transformer()` and batch shape built with
    ``activation="gelu"`` (the layers look it up in
    `nn.functional.activation`) from its default initializers, bf16: the
    float32 copy's loss and grads (`float32_copy_check`, phase 24's
    bounds and held grads), then one eager step with `nn.MSELoss` and
    ``AdamW(multi_precision=True)``, in which B5 launches 6 times each way
    and B2 12. Returns the B2 and B5 launch counts."""
    from paddle_tpu_torch import kernels, nn
    from paddle_tpu_torch.core.random import rng_guard, step_generator
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.nn.functional import activation
    from paddle_tpu_torch.optimizer import AdamW

    def build(dtype=None):
        return nn.Transformer(dropout=TR_DROPOUT, activation="gelu",
                              device="cuda", dtype=dtype)

    gc.collect()
    torch.cuda.empty_cache()
    with rng_guard(step_generator(seed + 1, "cuda")):
        model = build()
    check(all(layer.activation is activation.gelu for layer in
              (*model.encoder.layers, *model.decoder.layers)),
          "activation='gelu' did not resolve to nn.functional.activation")
    model.astype("bfloat16")
    mask = model.generate_square_subsequent_mask(TR_TGT)
    g = torch.Generator(device="cuda").manual_seed(seed + 26)
    batch = {"src": torch.randn((TR_B, TR_SRC, TR_D), generator=g,
                                device="cuda").to(torch.bfloat16),
             "tgt": torch.randn((TR_B, TR_TGT, TR_D), generator=g,
                                device="cuda").to(torch.bfloat16),
             "target": torch.randn((TR_B, TR_TGT, TR_D), generator=g,
                                   device="cuda"),
             "tgt_mask": mask}
    ref = f32_twin(torch, model, lambda: build(torch.float32))
    two = {k: (v[:2] if k != "tgt_mask" else v) for k, v in batch.items()}
    float32_copy_check(
        torch, SpmdTrainStep(model, gelu_mse_loss_fn, AdamW()),
        {n: p.detach() for n, p in model.named_parameters()}, two, ref,
        gelu_mse_loss_fn, LB_HELD, "Transformer (GELU, MSELoss)",
        shown=LB_SHOWN, relax=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                multi_precision=True)
    model.train()
    torch.cuda.synchronize()
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = model(batch["src"], batch["tgt"], tgt_mask=mask)
    loss = nn.MSELoss()(out.float(), batch["target"])
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.kernel_launch_counts()
    want = {"flash_attention_qkv3_fwd": TR_LAYERS,
            "flash_attention_qkv3_bwd": TR_LAYERS,
            "flash_attention_fwd": 2 * TR_LAYERS,
            "flash_attention_bwd": 2 * TR_LAYERS, "multi_tensor_adam": 1}
    only_launched(counts, want, "eager GELU Transformer step")
    check(math.isfinite(loss.item()), f"loss {loss.item()}")
    print(f"  one eager step (nn.MSELoss, AdamW multi_precision, dropout "
          f"{TR_DROPOUT}): loss {loss.item():.5f} (finite); launches "
          f"{ {k: v for k, v in counts.items() if v} }: B5 6 each way, B2 "
          f"12 each way, the update once  ok")
    print(f"  {card}: the step {ms:.3f} ms (one step, its first)")
    del model, opt, batch, out, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want if k != "multi_tensor_adam"}


def sweep_cases(torch, nn, F, rand):
    """Phase 25c's cases: ``(label, make, inputs)``; ``make()`` builds the
    layer (or a function of the inputs) on the card."""
    x4, x3, x5 = rand(3, 6, 8, 10), rand(3, 6, 9), rand(2, 6, 4, 5, 6)
    nhwc = rand(3, 8, 10, 6)
    two = (rand(5, 7), rand(5, 7))
    probs = torch.softmax(rand(5, 7), -1)
    labels = torch.randint(0, 7, (5,), device="cuda")
    signs = torch.where(rand(5) > 0, 1.0, -1.0)
    cuda = dict(device="cuda")
    acts = [(name, lambda n=name: getattr(nn, n)(), [x4]) for name in
            ("ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Sigmoid", "Tanh",
             "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU",
             "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
             "Softplus", "Softshrink", "Softsign", "Mish", "Tanhshrink",
             "ThresholdedReLU", "LogSigmoid", "GLU")]
    acts += [("Maxout", lambda: nn.Maxout(2), [x4]),
             ("RReLU (eval slope)", lambda: nn.RReLU(0.1, 0.3, False), [x4]),
             ("PReLU", lambda: nn.PReLU(6, **cuda), [x4])]
    losses = [
        ("CrossEntropyLoss", lambda: nn.CrossEntropyLoss(
            label_smoothing=0.1), [two[0], labels]),
        ("MSELoss", nn.MSELoss, list(two)), ("L1Loss", nn.L1Loss, list(two)),
        ("NLLLoss", nn.NLLLoss, [torch.log(probs), labels]),
        ("BCELoss", nn.BCELoss, [probs, torch.sigmoid(two[1])]),
        ("BCEWithLogitsLoss", nn.BCEWithLogitsLoss,
         [two[0], torch.sigmoid(two[1])]),
        ("SmoothL1Loss", lambda: nn.SmoothL1Loss(delta=0.5), list(two)),
        ("KLDivLoss", nn.KLDivLoss, [torch.log(probs),
                                     torch.softmax(two[1], -1)]),
        ("MarginRankingLoss", nn.MarginRankingLoss,
         [two[0][:, 0], two[1][:, 0], signs]),
        ("HingeEmbeddingLoss", nn.HingeEmbeddingLoss,
         [two[0], torch.where(two[1] > 0, 1.0, -1.0)]),
        ("CosineEmbeddingLoss", nn.CosineEmbeddingLoss, [*two, signs]),
        ("TripletMarginLoss", nn.TripletMarginLoss, [*two, rand(5, 7)])]
    norms = [
        ("BatchNorm1D", lambda: nn.BatchNorm1D(6, **cuda), [x3]),
        ("BatchNorm2D", lambda: nn.BatchNorm2D(6, **cuda), [x4]),
        ("BatchNorm2D NHWC", lambda: nn.BatchNorm2D(
            6, data_format="NHWC", **cuda), [nhwc]),
        ("BatchNorm3D", lambda: nn.BatchNorm3D(6, **cuda), [x5]),
        ("BatchNorm", lambda: nn.BatchNorm(6, **cuda), [x4]),
        ("SyncBatchNorm", lambda: nn.SyncBatchNorm(6, **cuda), [x4]),
        ("GroupNorm", lambda: nn.GroupNorm(3, 6, **cuda), [x4]),
        ("InstanceNorm1D", lambda: nn.InstanceNorm1D(6, **cuda), [x3]),
        ("InstanceNorm2D", lambda: nn.InstanceNorm2D(6, **cuda), [x4]),
        ("InstanceNorm3D", lambda: nn.InstanceNorm3D(6, **cuda), [x5]),
        ("LayerNorm", lambda: nn.LayerNorm([8, 10], **cuda), [x4]),
        ("RMSNorm", lambda: nn.RMSNorm(10, **cuda), [x4]),
        ("LocalResponseNorm", lambda: nn.LocalResponseNorm(3), [x4]),
        ("SpectralNorm", lambda: nn.SpectralNorm([6, 4, 3], power_iters=2,
                                                 **cuda), [rand(6, 4, 3)])]
    pools = [
        ("MaxPool1D", lambda: nn.MaxPool1D(3, 2, 1, ceil_mode=True), [x3]),
        ("MaxPool2D", lambda: nn.MaxPool2D(3, 2, 1), [x4]),
        ("MaxPool2D NHWC", lambda: nn.MaxPool2D(
            3, 2, "SAME", data_format="NHWC"), [nhwc]),
        ("MaxPool3D", lambda: nn.MaxPool3D(2, 1, 1), [x5]),
        ("AvgPool1D", lambda: nn.AvgPool1D(3, 2, 1), [x3]),
        ("AvgPool2D", lambda: nn.AvgPool2D(3, 2, 1, ceil_mode=True), [x4]),
        ("AvgPool2D inclusive", lambda: nn.AvgPool2D(
            3, 2, 1, exclusive=False), [x4]),
        ("AvgPool3D", lambda: nn.AvgPool3D(2, 2), [x5]),
        ("AdaptiveAvgPool1D", lambda: nn.AdaptiveAvgPool1D(4), [x3]),
        ("AdaptiveAvgPool2D", lambda: nn.AdaptiveAvgPool2D((3, 4)), [x4]),
        ("AdaptiveAvgPool3D", lambda: nn.AdaptiveAvgPool3D(2), [x5]),
        ("AdaptiveMaxPool1D", lambda: nn.AdaptiveMaxPool1D(4), [x3]),
        ("AdaptiveMaxPool2D", lambda: nn.AdaptiveMaxPool2D((3, 4)), [x4]),
        ("AdaptiveMaxPool3D", lambda: nn.AdaptiveMaxPool3D(2), [x5])]
    common = [
        ("Identity", nn.Identity, [x4]), ("Flatten", nn.Flatten, [x4]),
        ("Dropout (eval)", lambda: nn.Dropout(0.3).eval(), [x4]),
        ("Dropout2D (eval)", lambda: nn.Dropout2D(0.3).eval(), [x4]),
        ("Dropout3D (eval)", lambda: nn.Dropout3D(0.3).eval(), [x5]),
        ("AlphaDropout (eval)", lambda: nn.AlphaDropout(0.3).eval(), [x4]),
        ("Upsample bicubic", lambda: nn.Upsample(
            scale_factor=2, mode="bicubic"), [x4]),
        ("Upsample area (down)", lambda: nn.Upsample(
            size=[3, 4], mode="area"), [x4]),
        ("UpsamplingBilinear2D", lambda: nn.UpsamplingBilinear2D(
            [11, 7]), [x4]),
        ("UpsamplingNearest2D", lambda: nn.UpsamplingNearest2D(
            scale_factor=2), [x4]),
        ("Pad1D", lambda: nn.Pad1D([2, 1], mode="reflect"), [x3]),
        ("Pad2D", lambda: nn.Pad2D([1, 2, 0, 1], mode="circular"), [x4]),
        ("Pad3D", lambda: nn.Pad3D([1, 0, 0, 1, 2, 0], mode="replicate"),
         [x5]),
        ("ZeroPad2D", lambda: nn.ZeroPad2D([1, 1, 2, 0]), [x4]),
        ("PixelShuffle", lambda: nn.PixelShuffle(2), [rand(2, 8, 3, 4)]),
        ("PixelUnshuffle", lambda: nn.PixelUnshuffle(2), [x4]),
        ("ChannelShuffle", lambda: nn.ChannelShuffle(3), [x4]),
        ("Bilinear", lambda: nn.Bilinear(7, 7, 4, **cuda), list(two)),
        ("CosineSimilarity", nn.CosineSimilarity, [x4, rand(*x4.shape)]),
        ("Unfold", lambda: nn.Unfold([3, 2], 2, 1), [x4])]
    theta = torch.eye(2, 3, device="cuda")[None] + 0.2 * rand(3, 2, 3)
    grid = F.affine_grid(theta, [3, 6, 5, 7], align_corners=False)
    fns = [
        ("affine_grid", lambda: lambda t: F.affine_grid(t, [3, 6, 5, 7]),
         [theta]),
        ("grid_sample", lambda: lambda a, b: F.grid_sample(
            a, b, padding_mode="reflection", align_corners=False),
         [x4, grid * 1.2]),
        ("fold", lambda: lambda c: F.fold(c, [8, 10], 3, paddings=1),
         [F.unfold(x4, 3, paddings=1)]),
        ("temporal_shift", lambda: lambda a: F.temporal_shift(a, 3),
         [rand(6, 8, 4, 5)]),
        ("max_pool2d mask", lambda: lambda a: F.max_pool2d(
            a, 3, 2, 1, return_mask=True)[1], [x4]),
        ("interpolate nearest", lambda: lambda a: F.interpolate(
            a, size=[5, 13]), [x4])]
    return acts + losses + norms + pools + common + fns


def layer_sweep_phase(torch, seed, cases=sweep_cases):
    """Phase 25c (``cases``: `sweep_cases`; 26c: `sweep_cases_26`): each
    layer of A5 slice 2 (the activations, losses, norms, pooling and
    common layers) and the vision functions, at a small shape on the
    card in float32, against a ``.to("cpu")`` copy of the same layer on
    the same values: the output, the grads of the inputs and of the
    parameters (the loss ``sum(out * r)``) and the buffers after the
    pass, each within SWEEP_REL of its largest |value| (integer outputs
    exactly)."""
    import copy

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core.random import rng_guard, step_generator
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device="cuda").manual_seed(seed + 27)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    errors, n_cases = [], 0
    with rng_guard(step_generator(seed + 2, "cuda")):
        cases = cases(torch, nn, F, rand)
    for label, make, inputs in cases:
        with rng_guard(step_generator(seed + 3, "cuda")):
            layer = make()
        cpu = (copy.deepcopy(layer).to("cpu")
               if isinstance(layer, torch.nn.Module) else layer)
        sides = []
        for mod, dev in ((layer, "cuda"), (cpu, "cpu")):
            xs = [t.detach().to(dev).requires_grad_(t.is_floating_point())
                  for t in inputs]
            out = mod(*xs)
            grads = {}
            if out.is_floating_point():
                r = torch.linspace(-1.0, 1.0, out.numel(), device=dev
                                   ).reshape(out.shape)
                (out * r).sum().backward()
                grads = {f"input {i}": t.grad for i, t in enumerate(xs)
                         if t.grad is not None}
                if isinstance(mod, torch.nn.Module):
                    grads.update((n, p.grad) for n, p in
                                 mod.named_parameters() if p.grad is not None)
            bufs = (dict(mod.named_buffers())
                    if isinstance(mod, torch.nn.Module) else {})
            sides.append((out.detach(), grads, bufs))
        (out, grads, bufs), (cout, cgrads, cbufs) = sides
        n_cases += 1
        check(out.is_cuda and out.dtype == cout.dtype
              and out.shape == cout.shape and sorted(grads) == sorted(cgrads),
              f"{label}: {out.device} {out.dtype} {tuple(out.shape)}, grads "
              f"{sorted(grads)} against the CPU's {cout.dtype} "
              f"{tuple(cout.shape)}, {sorted(cgrads)}")
        if not out.is_floating_point():
            check(torch.equal(out.cpu(), cout), f"{label}: integer output "
                  "differs from the CPU's")
            continue
        check(all(torch.equal(bufs[n].cpu(), cbufs[n]) for n in bufs
                  if not bufs[n].is_floating_point()),
              f"{label}: an integer buffer differs from the CPU's")
        pairs = ([("output", out, cout, SWEEP_REL)]
                 + [(f"grad of {n}", grads[n], cgrads[n], SWEEP_GRAD_REL)
                    for n in grads]
                 + [(f"buffer {n}", bufs[n], cbufs[n], SWEEP_REL)
                    for n in bufs if bufs[n].is_floating_point()])
        for what, a, b, tol in pairs:
            scale = b.abs().max().clamp(min=1e-30)
            errors.append((((a.cpu() - b).abs().max() / scale).item(), tol,
                           f"{label} {what}"))
    over = [e for e in errors if e[0] > e[1]]
    worst = sorted(errors, reverse=True)
    print(f"  {n_cases} layers and functions on the card against their CPU "
          f"copies ({len(errors)} outputs, grads of inputs and parameters, "
          f"buffers), largest errors of their scale: " + ", ".join(
              f"{name} {err:.2e}" for err, _, name in worst[:4])
          + f" (outputs and buffers <= {SWEEP_REL}, grads <= "
          f"{SWEEP_GRAD_REL})")
    check(not over, "beyond their bounds: " + ", ".join(
        f"{name} {err:.2e} > {tol}" for err, tol, name in over))
    print("  ok")


# --------------------------------------- A5 slice 3: RNNs, beam search
def zaremba_lm(pkg, vocab=PTB_VOCAB, hidden=PTB_HIDDEN, layers=PTB_LAYERS,
               dropout=PTB_DROPOUT, init=PTB_INIT, **kw):
    """Phase 26a's model built from ``pkg`` (`paddle_tpu_torch`, or a
    package with the same API): ``Embedding(vocab, hidden)``, dropout,
    ``LSTM(hidden, hidden, layers, dropout)``, dropout, ``Linear(hidden,
    vocab)``, every parameter ``U(-init, init)`` through `ParamAttr`;
    ``forward(ids, state) -> (logits, state)``. ``kw`` goes to each
    layer with parameters (``device=``)."""
    nn = pkg.nn

    def attr():
        return pkg.ParamAttr(initializer=nn.initializer.Uniform(-init, init))

    class ZarembaLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, hidden, weight_attr=attr(),
                                          **kw)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout, weight_ih_attr=attr(),
                                weight_hh_attr=attr(), bias_ih_attr=attr(),
                                bias_hh_attr=attr(), **kw)
            self.dropout = nn.Dropout(dropout)
            self.out = nn.Linear(hidden, vocab, weight_attr=attr(),
                                 bias_attr=attr(), **kw)

        def forward(self, ids, state=None):
            x = self.dropout(self.embedding(ids))
            y, state = self.lstm(x, state)
            return self.out(self.dropout(y)), state

    return ZarembaLM()


def ptb_loss(F, logits, target):
    """The sequences' summed cross-entropy averaged over the batch (the
    loss of ptb_word_lm.py and of ptb_lm), ``F`` the package's
    ``nn.functional``."""
    return F.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                           target.reshape([-1]), reduction="sum") \
        / target.shape[0]


def cell_stack(torch, lstm):
    """``lstm``'s weights (an `nn.LSTM`) as `nn.RNN` over one
    `nn.LSTMCell` a layer: the cells' formulas step by step, on the same
    device and dtype."""
    from paddle_tpu_torch import nn

    class CellStack(nn.Layer):
        def __init__(self):
            super().__init__()
            self.rnns = nn.LayerList()
            for n in range(lstm.num_layers):
                cell = nn.LSTMCell(lstm.input_size if n == 0
                                   else lstm.hidden_size, lstm.hidden_size,
                                   device=lstm.weight_ih_l0.device)
                cell.to(lstm.weight_ih_l0.dtype)
                with torch.no_grad():
                    for w in ("weight_ih", "weight_hh", "bias_ih",
                              "bias_hh"):
                        getattr(cell, w).copy_(getattr(lstm, f"{w}_l{n}"))
                self.rnns.append(nn.RNN(cell))

        def forward(self, x, state):
            hs, cs = [], []
            for n, rnn in enumerate(self.rnns):
                x, (h, c) = rnn(x, (state[0][n], state[1][n]))
                hs.append(h)
                cs.append(c)
            return x, (torch.stack(hs), torch.stack(cs))

    return CellStack()


def ptb_pass(torch, model, ids, target, state):
    """One eval-mode (dropout off) forward and backward: ``(loss, grads
    by name)``."""
    from paddle_tpu_torch.nn import functional as F

    model.eval()
    model.zero_grad(set_to_none=True)
    logits, _ = model(ids, state)
    loss = ptb_loss(F, logits, target)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def ptb_train_route(torch, model, ids, target, state):
    """One training-mode forward and backward with every `F.dropout` the
    identity: the LSTM (dropout > 0, training) then takes the route the
    timed steps take, one fused call a layer with the port's dropout
    between, which the eval-mode passes (one fused call over both
    layers) do not. Checks that it did; returns ``(loss, grads by
    name)``."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import rnn

    layers, fused, dropout = [], rnn._RNNBase._fused, F.dropout

    def counted(self, *args):
        layers.append(args[3])                    # layers in the call
        return fused(self, *args)

    rnn._RNNBase._fused = counted
    F.dropout = lambda x, *args, **kw: x
    try:
        model.train()
        model.zero_grad(set_to_none=True)
        logits, _ = model(ids, state)
        loss = ptb_loss(F, logits, target)
        loss.backward()
    finally:
        rnn._RNNBase._fused = fused
        F.dropout = dropout
    check(layers == [1] * PTB_LAYERS, f"the training-mode pass made fused "
          f"calls over {layers} layers, not one a layer")
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def ptb_held(torch, label, loss, grads, want_loss, want_grads):
    """``loss`` and ``grads`` against another pass's: PTB_LOSS_RTOL,
    PTB_GRAD_L2 (printed before they are checked)."""
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    (gcos, gn), _, (gl2, ln) = worst_agreement(
        torch, {n: g.cpu() for n, g in grads.items()},
        {n: g.cpu() for n, g in want_grads.items()})
    print(f"  {label}: loss {loss.item():.7f} vs {want_loss.item():.7f} "
          f"(rel {rel:.2e}; <= {PTB_LOSS_RTOL}); every grad: least cosine "
          f"{gcos:.8f} ({gn}), largest relative L2 error {gl2:.2e} ({ln}; "
          f"<= {PTB_GRAD_L2})")
    check(math.isfinite(loss.item()) and rel <= PTB_LOSS_RTOL
          and gl2 <= PTB_GRAD_L2, f"{label}: loss rel {rel}, grad {ln} "
          f"relative L2 {gl2}")
    print("  ok")


def lstm_copy_cost(torch, model, x, state):
    """Device ms of the stack's forward and backward at the model's shape
    with its separate weight tensors (cuDNN copies them into one buffer
    each call) against ``torch.nn.LSTM`` holding the same weights in one
    flattened chunk, dropout off."""
    lstm = model.lstm
    flat = torch.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                         batch_first=True, device="cuda")
    with torch.no_grad():
        for n, p in flat.named_parameters():
            p.copy_(getattr(lstm, n))
    x = x.detach().requires_grad_(True)
    lstm.eval()

    def ours():
        lstm(x, state)[0].sum().backward()

    def theirs():
        flat(x, state)[0].sum().backward()

    ms = [time_ms(fn, 10) for fn in (ours, theirs, theirs, ours)]
    model.zero_grad(set_to_none=True)
    return ms


def ptb_phase(torch, seed, card):
    """Phase 26a: the Zaremba large LSTM language model (`zaremba_lm`,
    66.0M parameters) built on the card from its `ParamAttr`s (drawn from
    a generator seeded with ``seed``), float32 with TF32 off, trained
    eagerly as the reference's loop does (``loss.backward(); opt.step();
    opt.clear_grad()``, ``SGD(1.0)`` with ``ClipGradByGlobalNorm(10)``)
    for PTB_STEPS steps of b20 x 35 token ids from the seed, the LSTM
    state carried (detached) from batch to batch. Before the first step,
    with dropout off, its loss and grads against a float64 copy of its
    weights whose LSTM runs the cells' formulas step by step
    (`cell_stack`) in eval mode and in training mode (`ptb_train_route`:
    the route the steps take), and against its copy on the CPU. Prints
    the step's ms p50 over steps 2-PTB_STEPS, words/s, peak memory, a
    profile of one step and the cost of the stack's separate weight
    tensors."""
    import copy

    import paddle_tpu_torch
    from paddle_tpu_torch.core.random import rng_guard, step_generator
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD

    gc.collect()
    torch.cuda.empty_cache()
    with rng_guard(step_generator(seed, "cuda")):
        model = zaremba_lm(paddle_tpu_torch, PTB_VOCAB, PTB_HIDDEN,
                           PTB_LAYERS, PTB_DROPOUT, PTB_INIT)
    n_params = sum(p.numel() for p in model.parameters())
    worst = max(p.detach().abs().max().item() for p in model.parameters())
    check(all(p.is_cuda and p.dtype == torch.float32
              for p in model.parameters()) and worst <= PTB_INIT,
          f"the model is not float32 on the card within U(-{PTB_INIT}, "
          f"{PTB_INIT}): largest |value| {worst}")
    g = torch.Generator(device="cuda").manual_seed(seed + 28)
    stream = torch.randint(0, PTB_VOCAB, (PTB_B, PTB_STEPS * PTB_T + 1),
                           generator=g, device="cuda")
    batches = [(stream[:, i * PTB_T:(i + 1) * PTB_T],
                stream[:, i * PTB_T + 1:(i + 1) * PTB_T + 1])
               for i in range(PTB_STEPS)]
    zeros = torch.zeros((PTB_LAYERS, PTB_B, PTB_HIDDEN), device="cuda")
    print(f"  zaremba_lm(): vocabulary {PTB_VOCAB}, {PTB_LAYERS} x LSTM "
          f"{PTB_HIDDEN}, dropout {PTB_DROPOUT}, U(-{PTB_INIT}, {PTB_INIT}) "
          f"through ParamAttr; {n_params} parameters, float32; b{PTB_B} x "
          f"{PTB_T} token ids from the seed, the state carried")

    ids, target = batches[0]
    loss, grads = ptb_pass(torch, model, ids, target, (zeros, zeros))
    twin = copy.deepcopy(model).double()
    twin.lstm = cell_stack(torch, twin.lstm)
    loss64, grads64 = ptb_pass(torch, twin, ids, target,
                               (zeros.double(), zeros.double()))
    # the cells' names as the stack's: lstm.rnns.{n}.cell.{w} -> {w}_l{n}
    grads64 = {(f"lstm.{n.split('.')[4]}_l{n.split('.')[2]}"
                if n.startswith("lstm.rnns.") else n): v
               for n, v in grads64.items()}
    ptb_held(torch, "float64 copy (the cells step by step), dropout off",
             loss, grads, loss64, grads64)
    loss_t, grads_t = ptb_train_route(torch, model, ids, target,
                                      (zeros, zeros))
    ptb_held(torch, "training mode, every dropout the identity (one fused "
             "call a layer, the timed steps' route), against the float64 "
             "copy", loss_t, grads_t, loss64, grads64)
    del twin, grads64, grads_t
    cpu = copy.deepcopy(model).to("cpu")
    loss_c, grads_c = ptb_pass(torch, cpu, ids.cpu(), target.cpu(),
                               (zeros.cpu(), zeros.cpu()))
    ptb_held(torch, "its copy on the CPU, one step's pass", loss, grads,
             loss_c, grads_c)
    del cpu, grads_c, grads
    gc.collect()
    torch.cuda.empty_cache()

    model.train()
    model.zero_grad(set_to_none=True)
    opt = SGD(learning_rate=PTB_LR, parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(PTB_CLIP))
    state = (zeros, zeros)

    def step(ids, target, state):
        logits, state = model(ids, state)
        out = ptb_loss(F, logits, target)
        out.backward()
        opt.step()
        opt.clear_grad()
        return out, tuple(s.detach() for s in state)

    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with rng_guard(step_generator(seed + 3, "cuda")):
        for ids, target in batches:
            t0 = time.perf_counter()
            out, state = step(ids, target, state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(out.item())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(math.isfinite(x) for x in losses)
              and abs(losses[0] / PTB_T - math.log(PTB_VOCAB)) < 0.5,
              f"losses {losses}: not finite, or the first not near "
              f"{PTB_T} x ln({PTB_VOCAB})")
        p50 = statistics.median(times[1:]) * 1e3
        print(f"  {PTB_STEPS} eager steps (SGD {PTB_LR}, global-norm clip "
              f"{PTB_CLIP}, dropout {PTB_DROPOUT}): losses a sequence "
              f"{[round(x, 4) for x in losses]} (all finite, the first "
              f"within 0.5 x {PTB_T} of {PTB_T} x ln({PTB_VOCAB}))  ok")
        print(f"  {card}: eager step {p50:.3f} ms p50 of steps "
              f"2-{PTB_STEPS} (steps {[round(t * 1e3, 3) for t in times]} "
              f"ms), {PTB_B * PTB_T / p50 * 1e3:.1f} words/s, peak "
              f"{peak:.3f} GiB")
        profile_steps(torch, lambda: step(*batches[0], state), 1,
                      "eager LSTM LM step")
    x = model.embedding(batches[0][0]).detach()
    ms = lstm_copy_cost(torch, model, x, (zeros, zeros))
    print(f"  {card}: the LSTM stack's forward + backward (dropout off) "
          f"with its separate weight tensors {ms[0]:.3f} / {ms[3]:.3f} ms "
          f"against torch.nn.LSTM on one flattened chunk {ms[1]:.3f} / "
          f"{ms[2]:.3f} ms (device time, turns ours, theirs, theirs, ours)")
    del model, opt, batches, stream
    gc.collect()
    torch.cuda.empty_cache()


def beam_model(torch, seed):
    """Phase 26b's model: `nn.Transformer()` at its defaults (d_model 512,
    8 heads, 6 + 6 layers, FFN 2048) with ``Embedding(BS_VOCAB, 512)``
    and ``Linear(512, BS_VOCAB)``, drawn on the card by their
    initializers from a generator seeded with ``seed``, float32, in eval
    mode."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core.random import rng_guard, step_generator

    with rng_guard(step_generator(seed + 4, "cuda")):
        parts = (nn.Transformer(), nn.Embedding(BS_VOCAB, TR_D),
                 nn.Linear(TR_D, BS_VOCAB))
    for p in parts:
        p.eval()
    return parts


def beam_search(torch, parts, src, record=None):
    """Encode ``src`` (token ids) with the model's encoder and
    beam-search from its memory: `nn.dynamic_decode` over a
    `BeamSearchDecoder` whose cell is the model's `TransformerDecoder`
    with its caches (`gen_cache`), one query a step. ``record`` (a list)
    gets each step's entry time and logits. Returns ``(ids, log_probs,
    lengths)``."""
    from paddle_tpu_torch import nn

    model, emb, out = parts

    def cell(x, states):
        memory, cache = states
        y, cache = model.decoder(x[:, None, :], memory, cache=cache)
        return y[:, 0], (memory, cache)

    decoder = nn.BeamSearchDecoder(cell, BS_START, BS_END, BS_BEAMS,
                                   embedding_fn=emb, output_fn=out)
    if record is not None:
        step = decoder.step

        def recorded(inputs, states):
            t = time.perf_counter()
            logits, states = step(inputs, states)
            record.append((t, logits))
            return logits, states

        decoder.step = recorded
    with torch.no_grad():
        memory = model.encoder(emb(src))
        return nn.dynamic_decode(
            decoder, inits=(memory, model.decoder.gen_cache(memory)),
            max_step_num=BS_STEPS, return_length=True)


def beam_replay(torch, logits_steps):
    """`nn.dynamic_decode`'s selections replayed from each step's logits
    (`decode.beam_search_step`, as it runs them: the log-softmax and the
    totals in float32): ``[(flat indices [B, k], totals [B, k*V],
    log-probs [B, k])]``, one a step."""
    from paddle_tpu_torch.nn.decode import beam_search_step

    log_probs = torch.full((BS_B, BS_BEAMS), -1e9, device="cuda")
    log_probs[:, 0] = 0.0
    finished = torch.zeros((BS_B, BS_BEAMS), dtype=torch.bool,
                           device="cuda")
    lengths = torch.zeros((BS_B, BS_BEAMS), dtype=torch.int32,
                          device="cuda")
    steps = []
    for logits in logits_steps:
        log_probs, finished, lengths, parent, token, totals = \
            beam_search_step(logits, log_probs, finished, lengths, BS_END)
        steps.append((parent * logits.shape[-1] + token, totals, log_probs))
    return steps


def beam_partings(torch, a, b):
    """Where each row's selections first part between the replays ``a``
    and ``b`` (`beam_replay`): ``{row: (step, gap)}``, the gap the largest
    difference of ``b``'s scores between the candidates the two took at
    one position there."""
    parted = {}
    for row in range(BS_B):
        for t, ((ia, _, _), (ib, tb, _)) in enumerate(zip(a, b)):
            if not torch.equal(ia[row], ib[row]):
                diff = ia[row] != ib[row]
                gap = (tb[row][ia[row][diff]] - tb[row][ib[row][diff]])
                parted[row] = (t, gap.abs().max().item())
                break
    return parted


def f32_ulp(x):
    """The spacing of float32 values at ``|x|`` (``x`` != 0)."""
    return 2.0 ** (math.frexp(abs(x))[1] - 24)


def beam_slack(torch, logits, logits64, replay, shared):
    """Per row, what a float32 decode's totals may stray from its float64
    copy's over the steps ``0..shared[row]``, on which both decoded the
    same tokens: each step 2x the largest |logit| error of the row's
    beams there (a log-softmax value moves by at most twice that), one
    float32 ulp of the row's largest live total after the step (the
    running sum's rounding) and BS_LSM_ROUND (the log-softmax's).
    Returns ``(slack by row, largest logit error by row)``."""
    slack, errs = {}, {}
    for row, last in shared.items():
        total, worst = 0.0, 0.0
        rows = slice(row * BS_BEAMS, (row + 1) * BS_BEAMS)
        for t in range(last + 1):
            err = (logits[t][rows].double()
                   - logits64[t][rows].double()).abs().max().item()
            lp = replay[t][2][row]
            live = lp[lp > -1e8].abs().max().item()
            total += 2 * err + f32_ulp(live) + BS_LSM_ROUND
            worst = max(worst, err)
        slack[row], errs[row] = total, worst
    return slack, errs


def beam_phase(torch, seed, card):
    """Phase 26b: `nn.Transformer()` at its defaults (`beam_model`)
    beam-searched with `nn.dynamic_decode` (`beam_search`: beam 4, 64
    steps) from a b8 x 256-token source with no mask, so that the
    encoder's self-attention takes B5: with the launch counts zeroed
    just before and read just after, B5's forward launches exactly 6
    times (once a layer) and nothing else launches (a decode step's
    attention is one query, which no kernel takes). Prints the encoder's
    ms, ms a decode step p50, the whole decode's ms and a profile's
    kernels and host launch calls a step. A float64 copy of the same
    weights (attention composed) decodes the same source: each row's
    ids and lengths equal, its log-probs within `beam_slack`, unless the
    copy's scores at the step where the two part lie within what the
    logit errors can explain (`beam_slack`); the logits on the steps
    each row shares with the copy within BS_LOGIT_ATOL. Returns the B5
    launch count."""
    import copy

    from paddle_tpu_torch import kernels

    gc.collect()
    torch.cuda.empty_cache()
    parts = beam_model(torch, seed)
    n_params = sum(p.numel() for m in parts for p in m.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    src = torch.randint(0, BS_VOCAB, (BS_B, BS_SRC), generator=g,
                        device="cuda")
    print(f"  nn.Transformer() defaults + Embedding({BS_VOCAB}, {TR_D}) + "
          f"Linear({TR_D}, {BS_VOCAB}): {n_params} parameters, float32; "
          f"b{BS_B} x {BS_SRC} source ids, beam {BS_BEAMS}, "
          f"max_step_num {BS_STEPS}, start {BS_START}, end {BS_END}")
    beam_search(torch, parts, src[:, :128])          # warm-up
    enc = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts[0].encoder(parts[1](src))
            torch.cuda.synchronize()
            enc.append((time.perf_counter() - t0) * 1e3)

    record = []
    torch.cuda.synchronize()
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    ids, logp, lengths = beam_search(torch, parts, src, record)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = kernels.kernel_launch_counts()
    want = {"flash_attention_qkv3_fwd": TR_LAYERS}
    only_launched(counts, want, "nn.Transformer() beam search")
    steps = len(record)
    check(ids.shape == (BS_B, steps, BS_BEAMS) and steps == BS_STEPS
          and torch.isfinite(logp).all(), f"ids {tuple(ids.shape)}, "
          f"{steps} steps, log-probs finite {torch.isfinite(logp).all()}")
    step_ms = statistics.median(
        (b[0] - a[0]) * 1e3 for a, b in zip(record, record[1:]))
    print(f"  launches { {k: v for k, v in counts.items() if v} }: "
          f"B5's forward once a layer of the encoder; no B2 (a decode "
          f"step's self- and cross-attention have one query, which "
          f"composes) and no backward  ok")
    print(f"  {card}: encoder {statistics.median(enc):.3f} ms p50 of 3 "
          f"(b{BS_B} x {BS_SRC}); a decode step {step_ms:.3f} ms p50 of "
          f"{steps - 1}; the whole beam search {wall:.1f} ms (encoder, "
          f"{steps} steps, gather_tree)")
    wall_us, busy_us, _, n_kern, calls, _ = profile_totals(
        torch, lambda: beam_search(torch, parts, src))
    print(f"  profile of one beam search: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}"
          f"%), {n_kern / steps:.0f} kernels and {calls / steps:.1f} host "
          f"launch calls a step (the encoder's shared over the steps)")

    twin = copy.deepcopy(parts)
    for m in twin:
        m.double()
        for mod in m.modules():
            if hasattr(mod, "use_flash"):
                mod.use_flash = False
    record64 = []
    ids64, logp64, lengths64 = beam_search(torch, twin, src, record64)
    del twin
    logits, logits64 = [r[1] for r in record], [r[1] for r in record64]
    rep32, rep64 = beam_replay(torch, logits), beam_replay(torch, logits64)
    check(torch.equal(rep32[-1][2], logp), "the replayed selections are "
          "not the decode's")
    parted = beam_partings(torch, rep32, rep64)
    n_shared = min(len(rep32), len(rep64))
    slack, errs = beam_slack(torch, logits, logits64, rep32, {
        r: parted[r][0] if r in parted else n_shared - 1
        for r in range(BS_B)})
    same = [r for r in range(BS_B) if r not in parted]
    for r in same:
        check(torch.equal(ids[r], ids64[r])
              and torch.equal(lengths[r], lengths64[r]),
              f"row {r}: no selection parted, yet its ids or lengths "
              "differ")
    lp_err = {r: (logp[r].double() - logp64[r].double()).abs().max().item()
              for r in same}
    scale = max(x.abs().max().item() for x in logits)
    held = ", ".join(f"{r}: {lp_err[r]:.2e} <= {slack[r]:.2e}"
                     for r in same)
    gaps = ", ".join(f"{r}: step {t}, {g:.2e} <= {2 * slack[r]:.2e}"
                     for r, (t, g) in parted.items())
    print(f"  float64 copy (attention composed): logits on each row's "
          f"shared steps within {max(errs.values()):.3e} (<= "
          f"{BS_LOGIT_ATOL}; largest |logit| {scale:.4f}); {len(same)} of "
          f"{BS_B} rows equal in ids and lengths, log-prob error against "
          f"its slack (row: error <= slack): {held or 'none'}; rows parted "
          f"(row: step, the copy's score gap <= 2 x slack): "
          f"{gaps or 'none'}")
    check(max(errs.values()) <= BS_LOGIT_ATOL
          and all(lp_err[r] <= slack[r] for r in same)
          and all(g <= 2 * slack[r] for r, (_, g) in parted.items()),
          f"beam search against its float64 copy: logit errors {errs}, "
          f"log-prob errors {lp_err}, partings {parted}, slack {slack}")
    print("  ok")
    del parts, record, record64
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def sweep_cases_26(torch, nn, F, rand):
    """Phase 26c's cases (A5 slice 3), as `sweep_cases`: the recurrent
    layers (the stacks with ``sequence_length`` through the packed fused
    route, `RNN` and `BiRNN` over each cell), the extra functions and
    layers, ``weight_norm`` and ``spectral_norm``, and the quant layers
    (forward, STE grads, running scales in their buffers)."""
    from paddle_tpu_torch.nn import quant, utils

    class Flat(nn.Layer):
        """``call(inner, *inputs)``'s tensors flattened into one."""

        def __init__(self, inner, call):
            super().__init__()
            self.inner, self._call = inner, call

        def forward(self, *xs):
            def leaves(o):
                if isinstance(o, (tuple, list)):
                    return [v for i in o for v in leaves(i)]
                return [o.reshape(-1)]
            return torch.cat(leaves(self._call(self.inner, *xs)))

    cuda = dict(device="cuda")
    x, lens = rand(3, 7, 6), torch.tensor([7, 2, 5], device="cuda")
    seq = lambda m, a, n: m(a, sequence_length=n)         # noqa: E731
    plain = lambda m, *a: m(*a)                           # noqa: E731
    x4 = rand(2, 6, 8, 10)
    pooled, mask = F.max_pool2d(x4, 2, 2, return_mask=True)
    labels = torch.randint(1, 5, (3, 4), device="cuda")
    ctc = [rand(12, 3, 5), labels, torch.tensor([12, 9, 10], device="cuda"),
           torch.tensor([4, 2, 1], device="cuda")]
    y5 = torch.randint(0, 7, (5,), device="cuda")
    two = (rand(5, 7), rand(5, 7))
    cells = {"LSTMCell": nn.LSTMCell, "GRUCell": nn.GRUCell,
             "SimpleRNNCell": nn.SimpleRNNCell}
    rnns = [
        ("GRU bidirect, sequence_length", lambda: Flat(nn.GRU(
            6, 5, 2, "bidirect", **cuda), seq), [x, lens]),
        ("LSTM bidirect, sequence_length", lambda: Flat(nn.LSTM(
            6, 5, 2, "bidirect", **cuda), seq), [x, lens]),
        ("SimpleRNN relu, time_major", lambda: Flat(nn.SimpleRNN(
            6, 5, 2, time_major=True, activation="relu", **cuda), plain),
         [x.transpose(0, 1).contiguous()])]
    rnns += [(f"RNN({c}), sequence_length", lambda c=c: Flat(nn.RNN(
        cells[c](6, 5, **cuda)), seq), [x, lens]) for c in cells]
    rnns += [(f"BiRNN({c}), sequence_length", lambda c=c: Flat(nn.BiRNN(
        cells[c](6, 5, **cuda), cells[c](6, 5, **cuda)), seq), [x, lens])
        for c in cells]
    extra = [
        ("ctc_loss (mean)", lambda: F.ctc_loss, ctc),
        ("CTCLoss (sum, norm_by_times)", lambda: Flat(nn.CTCLoss(
            reduction="sum"), lambda m, *a: m(*a, norm_by_times=True)), ctc),
        ("HSigmoidLoss", lambda: nn.HSigmoidLoss(7, 6, **cuda),
         [two[0], y5 % 6]),
        ("max_unpool2d", lambda: lambda a, m: F.max_unpool2d(a, m, 2, 2),
         [pooled, mask]),
        ("MaxUnPool2D", lambda: nn.MaxUnPool2D(2), [pooled, mask]),
        ("pairwise_distance", lambda: F.pairwise_distance, list(two)),
        ("multi_margin_loss", lambda: F.multi_margin_loss, [two[0], y5]),
        ("margin_cross_entropy", lambda: F.margin_cross_entropy,
         [torch.tanh(two[0]), y5]),
        ("sigmoid_focal_loss", lambda: F.sigmoid_focal_loss,
         [two[0], (two[1] > 0).float()]),
        ("npair_loss", lambda: F.npair_loss, [*two, y5 % 3]),
        ("TripletMarginWithDistanceLoss (swap)", lambda:
         nn.TripletMarginWithDistanceLoss(swap=True), [*two, rand(5, 7)]),
        ("diag_embed", lambda: lambda a: F.diag_embed(a, 1), [rand(3, 4)]),
        ("Softmax2D", nn.Softmax2D, [x4]),
        ("gather_tree", lambda: F.gather_tree,
         [torch.randint(0, 9, (6, 2, 3), device="cuda"),
          torch.randint(0, 3, (6, 2, 3), device="cuda")])]
    norms = [
        ("weight_norm(Linear)", lambda: utils.weight_norm(nn.Linear(
            7, 4, **cuda)), [two[0]]),
        ("weight_norm(Conv2D, dim=None)", lambda: utils.weight_norm(
            nn.Conv2D(6, 4, 3, **cuda), dim=None), [x4]),
        ("spectral_norm(Linear)", lambda: utils.spectral_norm(nn.Linear(
            7, 4, **cuda), n_power_iterations=3), [two[0]])]
    quants = [
        ("QuantedLinear (train: scale updates)", lambda: quant.QuantizedLinear(
            nn.Linear(7, 4, **cuda)), [two[0]]),
        ("QuantedConv2D", lambda: quant.QuantizedConv2D(nn.Conv2D(
            6, 4, 3, **cuda)), [x4]),
        ("FakeQuantChannelWiseAbsMax", lambda:
         quant.FakeQuantChannelWiseAbsMax(quant_axis=1), [x4]),
        ("QuantizedColumnParallelLinear", lambda:
         quant.QuantizedColumnParallelLinear(nn.Linear(7, 4, **cuda)),
         [two[0]]),
        ("MovingAverageAbsMaxScale", lambda: quant.MovingAverageAbsMaxScale(
            **cuda), [two[0]]),
        ("fake_quant (scale 0.8: STE zero outside)", lambda:
         lambda a: quant.fake_quant(a, 0.8), [two[0]])]
    return rnns + extra + norms + quants


# ----------------------------------- phase 27: A2 and A3, float16 and AMP
def half_times(torch, copies, fwd, bwd, iters=(20, 10)):
    """``(fwd ms, bwd ms)`` of a kernel pair over three input copies
    (past the L2): ``fwd(c)`` returns what ``bwd(c, saved)`` takes."""
    it = iter(range(10 ** 9))
    saved = [fwd(c) for c in copies]

    def back():
        i = next(it) % 3
        bwd(copies[i], saved[i])

    return (time_ms(lambda: fwd(copies[next(it) % 3]), iters[0]),
            time_ms(back, iters[1]))


def sdpa_times(torch, heads, **kw):
    """``(fwd ms, bwd ms)`` of SDPA over three copies of ``[q, k, v, do]``
    head-major (q, k, v leaves that require grad); the backward is the
    forward+backward less the forward."""
    import torch.nn.functional as F

    it = iter(range(10 ** 9))

    def run(backward):
        def go():
            q, k, v, do = heads[next(it) % 3]
            out = F.scaled_dot_product_attention(q, k, v, **kw)
            if backward:
                out.backward(do)
        return go

    f = time_ms(run(False), 20)
    return f, time_ms(run(True), 10) - f


def work_record(name, src, line, err, ms, plain, lib, work, label):
    """A kernel line record from its times and ``work`` = (bytes, flops)
    at 989 TFLOP/s (bf16 and fp16 tensor cores) and 3.35 TB/s; prints
    the reading."""
    nbytes, flops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  {name} at {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"library {lib:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
          f"{nbytes} bytes, {flops} flops)")
    return {"name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"paddle_tpu/kernels/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib}


def fp16_kernel_phase(torch, seed):
    """Phase 27a: the float16 forms of B2, B5, B1, B4 and P1 against their
    plain versions on the card at the shapes of PERF.md §6 (B2 also at
    head dims 192, 256 and 384, and B2 and B5 at phase 27b's own shapes,
    dropout 0 and 0.1, untimed), each 16-bit
    output held to 8 float16 ulps (2^-11) of each element's scale
    (`flash_ulps`, as bf16 is held to 8 bf16 ulps) beside a float32
    control, lse to TOL_F32; P1 within 1 ulp of each stored dtype. Each
    timed behind a sleep beside its bf16 form at the same shape, its
    plain version, SDPA in float16 (P1: ``torch._fused_adamw_`` on the
    float32 masters) and its bound. Returns the float16 records."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.nn import Transformer

    f16, bf = torch.float16, torch.bfloat16
    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device="cuda")
    records = []

    # (a) B2, rows 2-3: BERT-large's B8 S512 H16 D64, key padding, p=0.1
    b, s, h, d = BERT_B, BERT_S, 16, 64
    mask, lens = key_padding(torch, b, s, 1)
    bias = fa.normalize_mask_bias(mask)
    kw = dict(bias=bias, dropout_p=0.1, seed=seed_t)
    copies = {dt: [general_case(b, s, s, h, d, dt, seed=270 + i)
                   for i in range(3)] for dt in (f16, bf)}
    err_o, err_g, line = general_compare(torch, fa, *copies[f16][0], False,
                                         bias, 0.1, seed_t)
    print(f"  flash_attention (B2) B{b} S{s} H{h} D{d} float16 key padding "
          f"p=0.1: {line}  ok")
    times = {dt: half_times(
        torch, copies[dt], lambda c: fa.flash_attention_fwd(
            *c[:3], False, **kw),
        lambda c, sv: fa.flash_attention_bwd(*c[:3], *sv, c[3], False, **kw))
        for dt in (f16, bf)}
    q, k, v, do = copies[f16][0]
    ro, rlse = fa.flash_reference(q, k, v, False, **kw)
    plain = (time_ms(lambda: fa.flash_reference(q, k, v, False, **kw), 3, 1),
             time_ms(lambda: fa.flash_bwd_reference(q, k, v, ro, rlse, do,
                                                    False, **kw), 3, 1))
    heads = [[x.transpose(1, 2).detach().requires_grad_(True)
              for x in c[:3]] + [c[3].transpose(1, 2)] for c in copies[f16]]
    lib = sdpa_times(torch, heads, attn_mask=bias[:, None].to(f16),
                     dropout_p=0.1)
    k_rows = int(lens.sum().item())
    work = general_work(b, s, s, h, d, s * k_rows, k_rows, 2, b * s * 4)
    label = f"B{b} S{s} H{h} D{d} key padding p=0.1"
    for j, (name, ln) in enumerate((("flash_attention_fwd_f16", 207),
                                    ("flash_attention_bwd_f16", 536))):
        records.append(work_record(name, "flash_attention", ln,
                                   (err_o, err_g)[j], times[f16][j],
                                   plain[j], lib[j], work[j],
                                   label + " fp16"))
        print(f"    bf16 at the same shape {times[bf][j]:.4f} ms: fp16 / "
              f"bf16 {times[f16][j] / times[bf][j]:.3f}")
    del copies, heads

    # B2 at head dims above 128 in float16 (the wgmma kernels on 64-key
    # tiles at 192 and 256, mma.sync sliced over D at 384), wide_flash_
    # phase's edge shape (e): Sq=128 Sk=384 causal, dropout 0.1
    for d in (192, 256, 384):
        q, k, v, do = general_case(2, 128, 384, 2, d, f16, seed=300 + d)
        line = general_compare(torch, fa, q, k, v, do, True, None, 0.1,
                               seed_t)[2]
        print(f"  flash_attention (B2) B2 Sq128 Sk384 H2 D{d} float16 causal "
              f"p=0.1: {line}  ok")

    # phase 27b's own attention shapes at B32 H8 D64, dropout 0 (its
    # float32 check) and 0.1 (its steps), as general_flash_phase's (j)
    # and (k) and qkv3_kernel_phase hold bf16 and f32 there: B2 in the
    # decoder's self-attention (Sq=Sk=128 under the causal -inf bias) and
    # its cross-attention (Sq=128 Sk=256), B5 in the encoder's
    # self-attention (S=256, full; float16 under O2)
    bias_j = fa.normalize_mask_bias(Transformer(
        64, 1, 1, 1, 64, device="cuda").generate_square_subsequent_mask(
            TR_TGT))
    three = qkv_fns(fa, "which")
    for p in (0.0, 0.1):
        for name, s_k, bias in (("self-attention", TR_TGT, bias_j),
                                ("cross-attention", TR_SRC, None)):
            q, k, v, do = general_case(TR_B, TR_TGT, s_k, 8, 64, f16,
                                       seed=310 + s_k + int(10 * p))
            line = general_compare(torch, fa, q, k, v, do, False, bias, p,
                                   seed_t)[2]
            print(f"  flash_attention (B2) at 27b's decoder {name} B{TR_B} "
                  f"Sq{TR_TGT} Sk{s_k} H8 D64 float16 p={p}: {line}  ok")
        qkv, do = flash_case(TR_B, TR_SRC, 8, 64, f16, seed=330 + int(10 * p))
        line = flash_compare(torch, three, qkv, do, 8, False, p, seed_t)[1]
        print(f"  flash_attention_qkv3 (B5) at 27b's encoder self-attention "
              f"B{TR_B} S{TR_SRC} H8 D64 float16 full p={p}: {line}  ok")
    del q, k, v, do, qkv

    # (b) B5, rows 8-9, and (c) B1, rows 6-7: the which-major projection
    # at the fused BERT's B8 S512 H16 D64 full p=0.1; the pair-major one
    # at GPT's B8 S1024 H16 D128 causal p=0
    for layout, (b, s, h, d), causal, p, names, lines in (
            ("which", (BERT_B, BERT_S, 16, 64), False, 0.1,
             ("flash_attention_qkv3_fwd_f16", "flash_attention_qkv3_bwd_f16"),
             (1018, 1044)),
            ("pair", (TRAIN_B, TRAIN_S, 16, 128), True, 0.0,
             ("flash_attention_qkv_fwd_f16", "flash_attention_qkv_bwd_f16"),
             (849, 876))):
        fns = qkv_fns(fa, layout)
        sd = seed_t if p else None
        copies = {dt: [flash_case(b, s, h, d, dt, seed=280 + i)
                       for i in range(3)] for dt in (f16, bf)}
        err, line, _ = flash_compare(torch, fns, *copies[f16][0], h, causal,
                                     p, sd)
        label = (f"B{b} S{s} H{h} D{d} {'causal' if causal else 'full'} "
                 f"p={p}")
        print(f"  {names[0][:-8]} ({'B5' if layout == 'which' else 'B1'}) "
              f"{label} float16: {line}  ok")
        times = {dt: half_times(
            torch, copies[dt], lambda c: fns[0](c[0], h, causal, p, sd),
            lambda c, sv: fns[2](c[0], c[1], *sv, h, causal, p, sd))
            for dt in (f16, bf)}
        qkv, do = copies[f16][0]
        ro, rlse = fns[1](qkv, h, causal, p, sd)
        plain = (time_ms(lambda: fns[1](qkv, h, causal, p, sd), 3, 1),
                 time_ms(lambda: fns[3](qkv, do, ro, rlse, h, causal, p, sd),
                         3, 1))
        if layout == "which":
            split = [c[0].reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
                     for c in copies[f16]]
        else:
            split = [c[0].reshape(b, s, h // 2, 3, 2, d).permute(
                3, 0, 2, 4, 1, 5).reshape(3, b, h, s, d)
                for c in copies[f16]]
        heads = [[t.contiguous().requires_grad_(True) for t in sp]
                 + [c[1].reshape(b, s, h, d).transpose(1, 2).contiguous()]
                 for sp, c in zip(split, copies[f16])]
        lib = sdpa_times(torch, heads, dropout_p=p, is_causal=causal)
        work = qkv_work(b, s, h, d, 2)
        if causal:
            work = tuple((nb, fl // 2) for nb, fl in work)
        for j in range(2):
            records.append(work_record(
                names[j], "flash_attention_qkv" if j == 0 else
                "flash_attention", lines[j], err["o" if j == 0 else "dqkv"],
                times[f16][j], plain[j], lib[j], work[j], label + " fp16"))
            print(f"    bf16 at the same shape {times[bf][j]:.4f} ms: fp16 "
                  f"/ bf16 {times[f16][j] / times[bf][j]:.3f}")
        del copies, heads, split

    # (d) B4, row 12: one ring chunk (B1 S2048 H16 D128), full, a random
    # lse cotangent
    b, s, h, d = SP_CHUNK
    copies = {dt: [general_case(b, s, s, h, d, dt, seed=290 + i)
                   for i in range(3)] for dt in (f16, bf)}
    g = torch.Generator(device="cuda").manual_seed(seed + 27)
    dlses = [torch.randn((b, h, s), generator=g, device="cuda")
             for _ in range(3)]
    err_o, err_g, line = b4_compare(torch, fa, *copies[f16][0], dlses[0],
                                    False)
    print(f"  flash_attention_with_lse (B4) B{b} S{s} H{h} D{d} float16 full, "
          f"random dlse: {line}  ok")
    times = {dt: half_times(
        torch, [c + [dl] for c, dl in zip(copies[dt], dlses)],
        lambda c: fa.flash_attention_lse_fwd(*c[:3], False),
        lambda c, sv: fa.flash_attention_lse_bwd(*c[:3], *sv, c[3], c[4],
                                                 False))
        for dt in (f16, bf)}
    q, k, v, do = copies[f16][0]
    ro, rlse = fa.flash_reference(q, k, v, False)
    plain = (time_ms(lambda: fa.flash_reference(q, k, v, False), 2, 1),
             time_ms(lambda: fa.flash_bwd_reference(
                 q, k, v, ro, rlse, do, False, dlse=dlses[0]), 2, 1))
    heads = [[x.transpose(1, 2).detach().requires_grad_(True)
              for x in c[:3]] + [c[3].transpose(1, 2)] for c in copies[f16]]
    lib = sdpa_times(torch, heads)
    work = general_work(b, s, s, h, d, b * s * s, b * s, 2, 0)
    work = (work[0], (work[1][0] + b * h * s * 4, work[1][1]))
    for j, name in enumerate(("flash_attention_lse_fwd_f16",
                              "flash_attention_lse_bwd_f16")):
        records.append(work_record(
            name, "flash_attention", (767, 536)[j], (err_o, err_g)[j],
            times[f16][j], plain[j], lib[j], work[j],
            f"B{b} S{s} H{h} D{d} full fp16 (SDPA: no lse cotangent)"))
        print(f"    bf16 at the same shape {times[bf][j]:.4f} ms: fp16 / bf16 "
              f"{times[f16][j] / times[bf][j]:.3f}")
    del copies, heads

    # (e) P1 over gpt3-1.3b's parameter list: the eager O2 form (float16
    # params and grads, float32 moments and masters) against the plain
    # version; then float16 and bf16 params, grads and moments (P1's row
    # form) timed in one call, and the O2 form beside
    # torch._fused_adamw_ on the masters
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTForPretraining(gpt_config(MODEL), dtype="bfloat16", seed=seed)
    params = {n: p.detach() for n, p in model.named_parameters()}
    del model
    g = torch.Generator(device="cuda").manual_seed(seed + 270)
    grads = {n: 1e-2 * torch.randn(p.shape, generator=g, device="cuda")
             for n, p in params.items()}
    n_el = sum(p.numel() for p in params.values())
    lr = torch.tensor(TRAIN_LR, device="cuda")
    t = torch.ones((), dtype=torch.int32, device="cuda")
    tables = mta.AdamTables()
    run = dict(beta1=ADAM_BETA1, beta2=ADAM_BETA2, epsilon=ADAM_EPS,
               adamw=True)
    forms = {"O2 (fp16 params and grads, f32 moments and masters)":
             (f16, f16, torch.float32, True),
             "fp16 params/grads/moments": (f16, f16, f16, False),
             "bf16 params/grads/moments": (bf, bf, bf, False)}
    ms, worst_err = {}, 0.0
    for label, (pdt, gdt, sdt, master) in forms.items():
        kern = adam_entries(torch, mta, params, grads, pdt, gdt, sdt, master,
                            TRAIN_WD)
        if pdt == f16:
            plain_e = copy_entries(torch, mta, kern)
            mta.multi_tensor_adam(kern, lr, t, tables=tables, **run)
            mta.adam_reference(plain_e, lr, t, **run)
            torch.cuda.synchronize()
            worst = 0.0
            for a, b_ in zip(kern, plain_e):
                for x, y in ((a.p, b_.p), (a.m, b_.m), (a.v, b_.v),
                             (a.master, b_.master)):
                    if x is not None:
                        worst = max(worst, ulps_apart(torch, x, y)[0])
                        if master:
                            worst_err = max(worst_err, (
                                x.float() - y.float()).abs().max().item())
            check(worst <= 1.0, f"multi_tensor_adam ({label}): {worst} ulps "
                  "from the plain version")
            print(f"  multi_tensor_adam, AdamW, {label}, {len(kern)} tensors: "
                  f"within {worst:.0f} ulp (<= 1) of the plain version  ok")
            if master:
                plain_ms = time_ms(lambda: mta.adam_reference(
                    plain_e, lr, t, **run), 3, 1)
            del plain_e
        ms[label] = time_ms(lambda: mta.multi_tensor_adam(
            kern, lr, t, tables=tables, **run), 10)
        if master:
            o2, o2_bytes = kern, mta.update_bytes(kern)
        else:
            del kern
    steps = [torch.zeros((), device="cuda") for _ in o2]
    g32 = [e.g.float() for e in o2]

    def library():
        torch._fused_adamw_(
            [e.master for e in o2], g32, [e.m for e in o2],
            [e.v for e in o2], [], steps, lr=TRAIN_LR, beta1=ADAM_BETA1,
            beta2=ADAM_BETA2, weight_decay=TRAIN_WD, eps=ADAM_EPS,
            amsgrad=False, maximize=False)

    library_ms = time_ms(library, 10)
    o2_label, f16_label, bf_label = forms
    print(f"  multi_tensor_adam over {MODEL}'s {len(o2)} tensors ({n_el} "
          "parameters, one launch each): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; fp16 / bf16 (same bytes) {ms[f16_label] / ms[bf_label]:.3f}")
    t_bytes = o2_bytes / HBM_BYTES_PER_S
    t_ops = 25 * n_el / F32_FLOPS_PER_S
    print(f"  multi_tensor_adam_f16 ({o2_label}): kernel {ms[o2_label]:.4f} "
          f"ms, plain {plain_ms:.4f} ms, library (torch._fused_adamw_ on the "
          f"f32 masters) {library_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops) * 1e3:.4f} ms ({o2_bytes} bytes)")
    records.append({
        "name": "multi_tensor_adam_f16", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/multi_tensor_adam.cu",
        "replaces": "paddle_tpu/optimizer/optimizers.py:64",
        "max_abs_err": worst_err, "ms": ms[o2_label], "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms})
    del o2, g32, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return records


# phase 27b: phase 26b's model trained eagerly under amp.auto_cast, 6
# steps a run (p50 of steps 2-6), the loss scale of the float16 runs;
# (label, level, dtype, loss scale or None)
AMP_STEPS, AMP_SCALE, AMP_CHECK_B = 6, 2.0 ** 15, 4
AMP_RUNS = (("O1 float16", "O1", "float16", AMP_SCALE),
            ("O2 float16", "O2", "float16", AMP_SCALE),
            ("O1 bfloat16", "O1", "bfloat16", None))


def amp_forward(torch, parts, batch):
    """Phase 27b's loss: the Transformer on the embedded source and
    target ids under the causal mask, the head's logits, their mean
    cross-entropy against the labels."""
    from paddle_tpu_torch.nn import functional as F

    model, emb, head = parts
    out = model(emb(batch["src"]), emb(batch["tgt"]),
                tgt_mask=batch["mask"])
    logits = head(out)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1))


def amp_check(torch, parts, batch, level, dtype, scale, label):
    """The float32 check of one AMP run at dropout 0 on the first
    AMP_CHECK_B sequences: the loss within REF_LOSS_RTOL of a float32
    copy's (composed attention, no AMP), and each of TR_HELD's grads at
    cosine >= REF_GRAD_COS or its plain-versions control's cosine less
    GRAD_COS_SLACK (the rule of phases 20-25); the loss scaled and the
    grads unscaled as the run's steps do."""
    from paddle_tpu_torch import amp

    small = {k: (v[:AMP_CHECK_B] if k != "mask" else v)
             for k, v in batch.items()}
    for p in parts:
        p.eval()

    def grads(use_amp):
        for p in parts:
            p.zero_grad(set_to_none=True)
        with amp.auto_cast(enable=use_amp, level=level, dtype=dtype):
            loss = amp_forward(torch, parts, small)
        (loss * (scale or 1.0)).backward()
        got = {n: p.grad.float() / (scale or 1.0)
               for n, p in parts[0].named_parameters() if n in TR_HELD}
        for p in parts:
            p.zero_grad(set_to_none=True)
        return loss.item(), got

    loss, got = grads(True)
    with plain_kernels(torch):
        _, ctrl = grads(True)
    twins = [f32_twin(torch, p, lambda p=p: copy.deepcopy(p).float())
             for p in parts]
    ref_loss = amp_forward(torch, twins, small)
    ref_loss.backward()
    ref = {n: p.grad for n, p in twins[0].named_parameters() if n in TR_HELD}
    ref_loss = ref_loss.item()
    del twins

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()

    c = {n: cos(got[n], ref[n]) for n in TR_HELD}
    cc = {n: cos(ctrl[n], ref[n]) for n in TR_HELD}
    bound = {n: min(REF_GRAD_COS, cc[n] - GRAD_COS_SLACK) for n in TR_HELD}
    rel = abs(loss - ref_loss) / abs(ref_loss)
    check(all(math.isfinite(g.sum().item()) for g in got.values()),
          f"{label}: a non-finite grad")
    check(rel <= REF_LOSS_RTOL, f"{label}: loss {loss} against float32 "
          f"{ref_loss}: relative difference {rel}")
    check(all(c[n] >= bound[n] for n in TR_HELD),
          f"{label}: grad cosines {c} below {bound}")
    print(f"  {label}: float32 copy (composed attention, dropout 0, "
          f"{AMP_CHECK_B} sequences): loss {loss:.6f} vs {ref_loss:.6f} "
          f"(rel {rel:.2e} <= {REF_LOSS_RTOL}); grad cosine "
          + ", ".join(f"{n} {c[n]:.5f} (plain versions {cc[n]:.5f})"
                      for n in TR_HELD)
          + f" (>= {REF_GRAD_COS}, or the plain versions' less "
          f"{GRAD_COS_SLACK})  ok")
    for p in parts:
        p.train()


def amp_phase(torch, seed, card):
    """Phase 27b: phase 26b's model (`nn.Transformer()`, ``Embedding(
    37000, 512)``, ``Linear(512, 37000)``, drawn from ``seed``) trained
    eagerly in train mode (dropout 0.1) on b32 x (256 + 128) ids with
    ``AdamW(beta1=0.9, beta2=0.98, epsilon=1e-9)``, three runs of
    AMP_STEPS steps as a user writes them: O1 float16 with a
    ``GradScaler(init_loss_scaling=2**15)``, O2 float16 through
    `amp.decorate` (float16 parameters, float32 masters) with the scaler,
    O1 bfloat16 without one. Each run: the float32 check (`amp_check`);
    the hook's casts of the first step by op name (no ``sdpa``: no
    composed attention at these gated shapes); with the launch counts
    zeroed just before the steps and read just after, B2 12 and B5 6
    launches each way a step in the dtype the flow gives them (B5 float32
    under O1: the float32 biases promote the projection back) and the
    update once a kept step; step ms p50 of steps 2-6, tokens/s, peak
    GiB, the loss scale and the skipped steps, and a profile of two
    steps. Returns the launch counts of the three runs, added."""
    from paddle_tpu_torch import amp, kernels
    from paddle_tpu_torch.amp.auto_cast import amp_dtype_for_op
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.optimizer import AdamW

    g = torch.Generator(device="cuda").manual_seed(seed + 27)

    def ids(n, s):
        return torch.randint(0, BS_VOCAB, (n, s), generator=g,
                             device="cuda")

    total = collections.Counter()
    for label, level, dtype, scale in AMP_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        parts = beam_model(torch, seed)
        mask = parts[0].generate_square_subsequent_mask(TR_TGT)
        batches = [{"src": ids(TR_B, TR_SRC), "tgt": ids(TR_B, TR_TGT),
                    "labels": ids(TR_B, TR_TGT), "mask": mask}
                   for _ in range(AMP_STEPS)]
        params = [p for part in parts for p in part.parameters()]
        opt = AdamW(learning_rate=TRAIN_LR, parameters=params, beta1=0.9,
                    beta2=0.98, epsilon=1e-9)
        if level == "O2":
            amp.decorate(list(parts), opt, level="O2", dtype=dtype)
            check(all(p.dtype == getattr(torch, dtype) for p in params)
                  and opt._multi_precision, f"{label}: decorate left a "
                  "parameter or the optimizer as it was")
        amp_check(torch, parts, batches[0], level, dtype, scale, label)
        scaler = (amp.GradScaler(init_loss_scaling=scale) if scale
                  else None)
        for p in parts:
            p.train()
        casts = collections.Counter()

        def step(bt, record=False):
            with amp.auto_cast(level=level, dtype=dtype):
                if record:
                    def rec(op):
                        dt = amp_dtype_for_op(op)
                        if dt is not None:
                            casts[op, str(dt)[6:]] += 1
                        return dt
                    dispatch.set_amp_hook(rec)
                try:
                    loss = amp_forward(torch, parts, bt)
                finally:
                    dispatch.set_amp_hook(amp_dtype_for_op)
            if scaler is None:
                loss.backward()
                opt.step()
            else:
                scaler.scale(loss).backward()
                scaler.step(opt)
            opt.clear_grad()
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_kernel_launch_counts()
        times, losses, scales = [], [], []
        for i, bt in enumerate(batches):
            t0 = time.perf_counter()
            loss = step(bt, record=i == 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            scales.append(scaler.get_loss_scaling() if scaler else None)
        counts = kernels.kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        skipped = sum(1 for a, b in zip([scale] + scales, scales)
                      if a and b and b < a)
        n = AMP_STEPS * TR_LAYERS
        b2 = "flash_attention_{}" + ("_f16" if dtype == "float16" else "")
        b5 = "flash_attention_qkv3_{}" + (
            "_f16" if level == "O2" and dtype == "float16" else "")
        upd = "multi_tensor_adam" + ("_f16" if level == "O2"
                                     and dtype == "float16" else "")
        want = {b2.format("fwd"): 2 * n, b2.format("bwd"): 2 * n,
                b5.format("fwd"): n, b5.format("bwd"): n}
        if AMP_STEPS - skipped:
            want[upd] = AMP_STEPS - skipped
        only_launched(counts, want, f"{label} eager AMP training")
        check(casts[("sdpa", dtype)] == 0 and casts[("linear", dtype)] > 0
              and all(math.isfinite(x) for x in losses),
              f"{label}: casts {dict(casts)}, losses {losses}")
        p50 = statistics.median(times[1:]) * 1e3
        tokens = TR_B * (TR_SRC + TR_TGT)
        print(f"  {label}: {AMP_STEPS} eager steps, losses "
              f"{[round(x, 5) for x in losses]}; loss scale "
              f"{scales if scaler else 'none (bf16)'}, skipped steps "
              f"{skipped}; launches {want} (B2 {2 * TR_LAYERS} and B5 "
              f"{TR_LAYERS} each way a step in the dtypes named, no "
              "composed attention)  ok")
        print(f"    the hook's casts of one step, by op: "
              f"{dict(sorted(casts.items()))}")
        print(f"  {card}: {label} eager step {p50:.3f} ms p50 of steps "
              f"2-{AMP_STEPS} (steps {[round(t * 1e3, 3) for t in times]} "
              f"ms), {tokens / (p50 / 1e3):.1f} tokens/s, peak "
              f"{peak:.3f} GiB")
        profile_steps(torch, lambda: step(batches[0]), 2,
                      f"{label} eager AMP steps", families=ADAM_FAMILY)
        total.update(counts)
        del parts, opt, batches, params, scaler
    gc.collect()
    torch.cuda.empty_cache()
    return dict(total)


# ---------------------------------------------------------------- phase 28
# 28a: every function of the op namespace (ops.__all__, linalg, fft,
# signal) on CUDA tensors made from a seed, against the same call on CPU
# copies. Tolerances by family, (rtol, atol) of float32 outputs; "exact"
# families (integers, bools, index and layout ops) equal; the
# decompositions by their invariants (their factors are fixed only up to
# signs); the random ops by shape, dtype, device and range. The float ops
# of NS_LOW run again in float16 and bfloat16 (the reference's jnp takes
# both): the card's output against the CPU's on the same rounded inputs
# upcast to float32, within NS_LOW_ULPS of the 16-bit dtype at each
# element's scale (its own magnitude or the output's rms): an op composed
# of several 16-bit steps (``lerp``, ``stanh``) rounds at each.
NS_TOL = {"float": (1e-5, 1e-6), "special": (1e-4, 1e-6),
          "reduce": (1e-4, 1e-5), "linalg": (1e-3, 1e-4),
          "fft": (1e-4, 1e-4)}
NS_LOW_ULPS = {"float": 6, "special": 8, "reduce": 16}
NS_UNARY = ("abs", "acos", "asin", "atan", "acosh", "asinh", "atanh",
            "ceil", "floor", "cos", "cosh", "sin", "sinh", "tan", "tanh",
            "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
            "rsqrt", "square", "sign", "round", "trunc", "reciprocal", "neg",
            "erf", "erfinv", "sigmoid", "lgamma", "digamma", "angle", "conj",
            "deg2rad", "rad2deg", "frac", "i0", "i0e", "i1", "i1e", "isnan",
            "isinf", "isfinite", "real", "imag", "logit", "sgn", "stanh")
# the unary ops' input ranges (others: normal draws)
NS_DOMAIN = {"acos": (-0.9, 0.9), "asin": (-0.9, 0.9), "atanh": (-0.9, 0.9),
             "erfinv": (-0.9, 0.9), "acosh": (1.1, 3.0), "log": (0.1, 3.0),
             "log2": (0.1, 3.0), "log10": (0.1, 3.0), "log1p": (-0.5, 3.0),
             "sqrt": (0.1, 3.0), "rsqrt": (0.1, 3.0),
             "reciprocal": (0.5, 3.0), "lgamma": (0.2, 4.0),
             "digamma": (0.2, 4.0), "logit": (0.05, 0.95),
             "tan": (-1.2, 1.2)}
NS_SPECIAL = {"erfinv", "lgamma", "digamma", "i0", "i0e", "i1", "i1e",
              "tan", "acosh", "atanh", "logit"}
NS_BINARY = ("add", "subtract", "multiply", "divide", "floor_divide", "mod",
             "remainder", "floor_mod", "pow", "maximum", "minimum", "fmax",
             "fmin", "atan2", "logaddexp", "copysign", "nextafter", "hypot",
             "heaviside", "kron", "ldexp", "outer")
NS_INT_BINARY = ("gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
                 "bitwise_left_shift", "bitwise_right_shift")
NS_LOGIC = ("equal", "not_equal", "less_than", "less_equal",
            "greater_than", "greater_equal", "logical_and", "logical_or",
            "logical_xor")
NS_REDUCE = ("sum", "nansum", "mean", "nanmean", "prod", "max", "min",
             "amax", "amin", "logsumexp", "all", "any", "count_nonzero",
             "std", "var", "median", "nanmedian")
# the float ops also run in float16 and bfloat16 on the card
NS_LOW = (set(NS_UNARY) - {"angle", "conj", "real", "imag", "i0", "i0e", "i1",
                           "i1e", "erfinv", "lgamma", "digamma", "isnan",
                           "isinf", "isfinite", "sgn", "frac"}
          | {"add", "subtract", "multiply", "divide", "maximum", "minimum",
             "pow", "atan2", "hypot", "sum", "mean", "max", "min",
             "logsumexp", "prod", "cumsum", "matmul", "mm", "bmm", "mv",
             "einsum", "addmm", "clip", "scale", "lerp", "where",
             "concat", "stack", "transpose", "reshape", "gather",
             "index_select", "norm", "dist", "renorm", "sort", "topk"})


class _Sp:
    """A special argument of a case, made by `_materialize`: ``spd`` a
    16 x 16 symmetric positive definite matrix, ``chol`` its lower
    Cholesky factor, ``lu`` the two outputs of ``lu_factor`` of a 16 x 16
    matrix, ``hann`` a 128-point Hann window plus 0.1."""

    def __init__(self, what):
        self.what = what


class _Arr:
    """A tensor argument of a case: ``kind`` f (normal, or uniform in
    ``lo, hi``), i (ints in ``lo, hi``), b (bools), c (complex64)."""

    def __init__(self, kind, shape, lo=None, hi=None, sort=None):
        self.kind, self.shape, self.lo, self.hi = kind, shape, lo, hi
        self.sort = sort

    def numpy(self, np, rng):
        if self.kind == "f":
            a = (rng.uniform(self.lo, self.hi, self.shape)
                 if self.lo is not None else rng.standard_normal(self.shape))
            a = a.astype("float32")
        elif self.kind == "i":
            a = rng.integers(-9 if self.lo is None else self.lo,
                             10 if self.hi is None else self.hi, self.shape)
        elif self.kind == "b":
            a = rng.random(self.shape) < 0.5
        else:
            a = (rng.standard_normal(self.shape)
                 + 1j * rng.standard_normal(self.shape)).astype("complex64")
        return np.sort(a, self.sort) if self.sort is not None else a


def _f(*shape, lo=None, hi=None, sort=None):
    return _Arr("f", shape, lo, hi, sort)


def _i(*shape, lo=None, hi=None):
    return _Arr("i", shape, lo, hi)


def namespace_cases():
    """``(module, name, args, kwargs, family)`` of every function of the
    namespace: ``args`` hold `_Arr` specs (made tensors on each device)
    and plain values."""
    f34, f234 = _f(32, 48), _f(4, 32, 48)
    spd, chol = _Sp("spd"), _Sp("chol")
    cases = []

    def add(name, args, kw=None, family="float", mod="ops"):
        cases.append((mod, name, args, kw or {}, family))

    for n in NS_UNARY:
        lo, hi = NS_DOMAIN.get(n, (None, None))
        add(n, [_f(32, 48, lo=lo, hi=hi)],
            family="special" if n in NS_SPECIAL else "float")
    add("bitwise_not", [_i(32, 48)], family="exact")
    add("logical_not", [_Arr("b", (32, 48))], family="exact")
    for n in NS_BINARY:
        a = _f(32, 48, lo=0.5, hi=2.0) if n == "pow" else f34
        b = _f(32, 48, lo=0.3, hi=2.0) if n in (
            "divide", "floor_divide", "mod", "remainder", "floor_mod") \
            else _f(32, 48)
        if n in ("kron", "outer"):
            a, b = _f(6, 8), _f(5, 7)
        add(n, [a, b])
    add("inner", [_f(32, 48), _f(24, 48)], family="reduce")
    for n in NS_INT_BINARY:
        add(n, [_i(32, 48, lo=0, hi=50), _i(32, 48, lo=0, hi=5)],
            family="exact")
    for n in ("add", "floor_divide", "mod", "multiply"):
        add(n, [_i(32, 48), _i(32, 48, lo=1, hi=9)], family="exact")
    for n in NS_LOGIC:
        args = [_Arr("b", (32, 48))] * 2 if n.startswith("logical") \
            else [_i(32, 48, lo=0, hi=3), _i(32, 48, lo=0, hi=3)]
        add(n, args, family="exact")
    for n in NS_REDUCE:
        x = _f(4, 32, 48, lo=0.5, hi=1.5) if n == "prod" else f234
        fam = "exact" if n in ("all", "any", "count_nonzero") else "reduce"
        add(n, [x], {"axis": 1}, family=fam)
        add(n, [x], {}, family=fam)
    add("sum", [_i(4, 32, 48)], {"axis": 2}, family="exact")
    for n in ("quantile", "nanquantile"):
        add(n, [f34], {"q": [0.1, 0.5, 0.9], "axis": 1}, family="reduce")
    for n in ("cumsum", "logcumsumexp"):
        add(n, [f34], {"axis": 1}, family="reduce")
    add("cumprod", [_f(32, 48, lo=0.9, hi=1.1)], {"dim": 1},
        family="reduce")
    for n in ("cummax", "cummin"):
        add(n, [_i(32, 48)], {"axis": 1}, family="exact")
    add("scale", [f34], {"scale": 2.0, "bias": 0.5})
    add("increment", [f34], {"value": 2.0})
    add("clip", [f34], {"min": -0.5, "max": 0.5})
    add("multiplex", [[f34, f34], _i(32, 1, lo=0, hi=2)], family="exact")
    add("addmm", [_f(32, 40), _f(32, 48), _f(48, 40)], family="reduce")
    add("lerp", [f34, f34, _f(32, 48, lo=0, hi=1)])
    add("nan_to_num", [f34])
    add("trace", [_f(48, 48)], family="reduce")
    add("isclose", [f34, f34], family="exact")
    add("allclose", [f34, f34], family="exact")
    add("equal_all", [f34, f34], family="exact")
    add("isreal", [_Arr("c", (8, 8))], family="exact")
    add("where", [_Arr("b", (32, 48)), f34, f34])
    add("trapezoid", [f34], family="reduce")
    add("add_n", [[f34, f34, f34]])
    add("frexp", [f34])
    for n in ("is_floating_point", "is_integer", "is_complex", "is_tensor",
              "is_empty"):
        add(n, [f34], family="exact")
    add("while_loop", [_Sp("loop")], family="exact")
    # creation
    for n, args, kw in (("zeros", [[8, 16]], {}), ("ones", [[8, 16]], {}),
                        ("full", [[8, 16], 1.5], {}), ("empty", [[8]], {}),
                        ("arange", [0, 64, 3], {}),
                        ("linspace", [0.0, 1.0, 33], {}),
                        ("logspace", [0.0, 2.0, 17], {}),
                        ("eye", [16, 24], {}), ("tril_indices", [16], {}),
                        ("triu_indices", [16, 24, 2], {}),
                        ("to_tensor", [[[1.5, 2.0], [3.0, 4.0]]], {}),
                        ("as_tensor", [[1, 2, 3]], {}),
                        ("check_shape", [[2, 3]], {})):
        add(n, args, kw, family="create")
    for n in ("zeros_like", "ones_like", "empty_like", "clone", "numel",
              "assign"):
        add(n, [f34], family="exact")
    add("full_like", [f34, 2.5], family="exact")
    add("diag", [_f(48)], {"offset": 1, "padding_value": 9.0},
        family="exact")
    add("diagflat", [_f(6, 8)], family="exact")
    add("diag_embed", [_f(4, 8)], {"dim1": 0, "dim2": 2}, family="exact")
    add("meshgrid", [_f(8), _f(9)], family="exact")
    add("tril", [f34], {"diagonal": 1}, family="exact")
    add("triu", [f34], {"diagonal": -1}, family="exact")
    add("complex", [f34, f34], family="exact")
    add("polar", [_f(32, 48, lo=0, hi=2), f34])
    for n, args, kw in (("rand", [[64, 64]], {}), ("randn", [[64, 64]], {}),
                        ("standard_normal", [[64, 64]], {}),
                        ("randint", [0, 10, [64, 64]], {}),
                        ("randperm", [64], {}),
                        ("uniform", [[64, 64]], {"min": 2.0, "max": 4.0}),
                        ("normal", [1.0, 2.0, [64, 64]], {})):
        add(n, args, kw, family="random")
    for n, args in (("randint_like", [_i(64, 64), 10]),
                    ("bernoulli", [_f(64, 64, lo=0, hi=1)]),
                    ("poisson", [_f(64, 64, lo=0, hi=4)]),
                    ("multinomial", [_f(4, 16, lo=0.1, hi=1), 8])):
        add(n, args, family="random")
    add("create_parameter", [[16, 8]], family="random")
    # manipulation
    for n, args, kw in (
            ("reshape", [f234, [8, 16, 48]], {}),
            ("reshape_", [f234, [8, 16, 48]], {}),
            ("transpose", [f234, [2, 0, 1]], {}), ("t", [f34], {}),
            ("moveaxis", [f234, 0, 2], {}), ("swapaxes", [f234, 0, 2], {}),
            ("squeeze", [_f(4, 1, 48)], {}), ("unsqueeze", [f34, [0, -1]], {}),
            ("flatten", [f234], {"start_axis": 1}),
            ("concat", [[f34, f34]], {"axis": 1}),
            ("stack", [[f34, f34]], {"axis": -1}),
            ("split", [f34, 3], {"axis": 1}),
            ("split", [f34, [10, -1]], {"axis": 1}),
            ("chunk", [f34, 4], {}), ("unbind", [_f(3, 8)], {}),
            ("unstack", [_f(3, 8)], {}), ("tile", [_f(3, 8), [2, 2]], {}),
            ("expand", [_f(32, 1), [2, 32, 48]], {}),
            ("broadcast_to", [_f(1, 48), [32, 48]], {}),
            ("expand_as", [_f(1, 48), f34], {}),
            ("view_as", [_f(1, 48), f34], {}),
            ("broadcast_tensors", [[_f(1, 48), _f(32, 1)]], {}),
            ("broadcast_shape", [[2, 1, 3], [4, 1]], {}),
            ("flip", [f34, [0, 1]], {}), ("rot90", [f34], {}),
            ("roll", [f34, 5], {"axis": 1}), ("cast", [f34, "int32"], {}),
            ("slice", [f234, [1, 2], [2, 8], [20, 40]], {}),
            ("strided_slice", [f34, [1], [40], [2], [-3]], {}),
            ("crop", [f34, [8, 8]], {"offsets": [2, 3]}),
            ("pad", [_f(2, 3, 16, 16), [1, 2, 3, 0]], {"mode": "reflect"}),
            ("pad", [_f(2, 3, 16, 16), [1, 2, 3, 0]], {}),
            ("gather", [f34, _i(10, lo=0, hi=32)], {}),
            ("gather_nd", [f234, _i(5, 2, lo=0, hi=4)], {}),
            ("scatter", [f34, _i(5, lo=0, hi=32), _f(5, 48)],
             {"overwrite": False}),
            ("scatter_", [f34, _i(5, lo=0, hi=32), _f(5, 48)],
             {"overwrite": False}),
            ("scatter_nd_add", [f34, _i(6, 1, lo=0, hi=32), _f(6, 48)], {}),
            ("scatter_nd", [_i(6, 1, lo=0, hi=32), _f(6, 48), [32, 48]], {}),
            ("index_select", [f34, _i(7, lo=0, hi=48)], {"axis": 1}),
            ("index_sample", [f34, _i(32, 5, lo=0, hi=48)], {}),
            ("index_add", [f34, _i(6, lo=0, hi=32), 0, _f(6, 48)], {}),
            ("index_add_", [f34, _i(6, lo=0, hi=32), 0, _f(6, 48)], {}),
            ("index_put", [f34, (_i(6, lo=0, hi=32), _i(6, lo=0, hi=48)),
                           _f(6)], {"accumulate": True}),
            ("take_along_axis", [f34, _i(32, 3, lo=0, hi=48), 1], {}),
            ("put_along_axis", [f34, _i(32, 3, lo=0, hi=48), _f(32, 3), 1],
             {"reduce": "add"}),
            ("masked_select", [f34, _Arr("b", (32, 48))], {}),
            ("masked_fill", [f34, _Arr("b", (32, 48)), -1.0], {}),
            ("repeat_interleave", [f34, 2], {"axis": 1}),
            ("as_complex", [_f(8, 8, 2)], {}),
            ("as_real", [_Arr("c", (8, 8))], {}),
            ("view", [f234, [128, 48]], {}), ("view", [f34, "int32"], {}),
            ("atleast_1d", [f34], {}), ("atleast_2d", [_f(8)], {}),
            ("atleast_3d", [f34], {}),
            ("diagonal", [f234], {"axis1": 1, "axis2": 2}),
            ("argmax", [f34], {"axis": 1}), ("argmin", [f34], {}),
            ("argsort", [_i(32, 48)], {"descending": True}),
            ("sort", [f34], {"axis": 0}), ("topk", [f34, 5], {}),
            ("kthvalue", [f34, 3], {}), ("mode", [_i(32, 48)], {}),
            ("nonzero", [_Arr("b", (32, 48))], {}),
            ("searchsorted", [_f(64, sort=0), f34], {}),
            ("bucketize", [f34, _f(64, sort=0)], {}),
            ("unique", [_i(32, 48)], {"return_index": True,
                                      "return_inverse": True,
                                      "return_counts": True}),
            ("unique_consecutive", [_i(64, lo=0, hi=3)],
             {"return_inverse": True, "return_counts": True}),
            ("histogram", [_f(4096)], {"bins": 16, "min": -3, "max": 3}),
            ("bincount", [_i(256, lo=0, hi=30)], {}),
            ("diff", [f34], {"n": 2}),
            ("unflatten", [f234, 2, [6, 8]], {}),
            ("vander", [_f(8)], {}),
            ("as_strided", [f34, [16, 8], [48, 2]], {}),
            ("take", [f34, _i(6, 6, lo=-100, hi=100)], {"mode": "wrap"}),
            ("vsplit", [f34, 4], {}), ("reverse", [f34, [1]], {}),
            ("shard_index", [_i(32, 1, lo=0, hi=40)],
             {"index_num": 40, "nshards": 4, "shard_id": 2}),
            ("tolist", [_i(4, 4)], {}), ("shape", [f234], {}),
            ("rank", [f234], {})):
        add(n, args, kw, family="exact")
    add("renorm", [f234, 2.0, 1, 5.0], family="reduce")
    # linear algebra
    for n, args, kw, fam in (
            ("matmul", [_f(4, 32, 48), _f(40, 48)], {"transpose_y": True},
             "reduce"),
            ("mm", [f34, _f(48, 40)], {}, "reduce"),
            ("bmm", [f234, _f(4, 48, 40)], {}, "reduce"),
            ("mv", [f34, _f(48)], {}, "reduce"),
            ("dot", [f34, f34], {}, "reduce"),
            ("cross", [_f(32, 3), _f(32, 3)], {}, "float"),
            ("norm", [f34], {}, "reduce"),
            ("norm", [f34], {"p": 2, "axis": 1}, "reduce"),
            ("norm", [f234], {"p": "nuc", "axis": [1, 2]}, "linalg"),
            ("dist", [f34, f34], {"p": 3}, "reduce"),
            ("cdist", [_f(16, 8), _f(24, 8)], {}, "reduce"),
            ("det", [spd], {}, "linalg"),
            ("slogdet", [spd], {}, "linalg"),
            ("inv", [spd], {}, "linalg"),
            ("pinv", [_f(48, 32)], {}, "linalg"),
            ("eigvalsh", [spd], {}, "linalg"),
            ("cholesky", [spd], {}, "linalg"),
            ("cholesky_solve", [_f(16, 4), chol], {}, "linalg"),
            ("solve", [spd, _f(16, 4)], {}, "linalg"),
            ("triangular_solve", [chol, _f(16, 4)], {"upper": False},
             "linalg"),
            ("lstsq", [_f(48, 32), _f(48, 4)], {}, "linalg"),
            ("matrix_power", [spd], {"n": -2}, "linalg"),
            ("matrix_rank", [_f(48, 32)], {}, "exact"),
            ("multi_dot", [[_f(8, 16), _f(16, 24), _f(24, 4)]], {},
             "reduce"),
            ("cond", [spd], {}, "linalg"),
            ("cov", [_f(8, 64)], {}, "reduce"),
            ("corrcoef", [_f(8, 64)], {}, "reduce"),
            ("einsum", ["bij,bkj->bik", f234, f234], {}, "reduce"),
            ("tensordot", [f234, _f(48, 8)], {"axes": 1}, "reduce"),
            ("householder_product", [_f(32, 8), _f(8, lo=0.5, hi=1.5)], {},
             "linalg"),
            ("svd", [_f(48, 32)], {}, "svd"), ("qr", [_f(48, 32)], {}, "qr"),
            ("eigh", [spd], {}, "eigh"), ("eig", [_f(16, 16)], {}, "eig"),
            ("eigvals", [_f(16, 16)], {}, "eig"),
            ("lu", [_f(32, 32)], {}, "lu"),
            ("lu_unpack", [_Sp("lu")], {}, "linalg")):
        add(n, args, kw, fam)
    for n in ("fft", "ifft", "hfft"):
        add(n, [_Arr("c", (16, 64))], {"norm": "ortho"}, "fft", "fft")
    for n in ("rfft", "ihfft"):
        add(n, [_f(16, 64)], {}, "fft", "fft")
    add("irfft", [_Arr("c", (16, 33))], {}, "fft", "fft")
    for n in ("fftn", "ifftn", "fft2", "ifft2", "hfft2", "hfftn"):
        add(n, [_Arr("c", (4, 16, 32))], {}, "fft", "fft")
    for n in ("rfftn", "rfft2", "ihfft2", "ihfftn"):
        add(n, [_f(4, 16, 32)], {}, "fft", "fft")
    for n in ("irfftn", "irfft2"):
        add(n, [_Arr("c", (4, 16, 17))], {}, "fft", "fft")
    for n in ("fftshift", "ifftshift"):
        add(n, [_f(16, 64)], {}, "exact", "fft")
    for n in ("fftfreq", "rfftfreq"):
        add(n, [64], {"d": 0.5}, "create", "fft")
    add("frame", [_f(2, 512), 64, 32], {}, "exact", "signal")
    add("overlap_add", [_f(2, 64, 15), 32], {}, "reduce", "signal")
    add("stft", [_f(2, 1024), 128], {}, "fft", "signal")
    add("istft", [_Arr("c", (2, 65, 33)), 128], {"window": _Sp("hann")},
        "fft", "signal")
    return cases


def _materialize(a, torch, np, rng, device, dtype, upcast=False):
    """A case's argument on ``device``: `_Arr` specs drawn from ``rng``
    (float ones rounded to ``dtype``, then with ``upcast`` made float32
    again), specials built, lists and tuples walked, the rest as it
    is."""
    if isinstance(a, _Arr):
        t = torch.from_numpy(a.numpy(np, rng))
        if t.is_floating_point():
            t = t.to(dtype)
            if upcast:
                t = t.float()
        return t.to(device)
    if isinstance(a, _Sp):
        if a.what in ("spd", "chol"):
            m = torch.from_numpy(rng.standard_normal((16, 16)).astype(
                "float32"))
            t = m @ m.T / 16 + torch.eye(16)
            if a.what == "chol":
                t = torch.linalg.cholesky(t)
            return t.to(device)
        if a.what == "lu":
            m = torch.from_numpy(rng.standard_normal((16, 16)).astype(
                "float32"))
            return tuple(x.to(device) for x in torch.linalg.lu_factor(m))
        if a.what == "hann":
            return torch.from_numpy((np.hanning(128) + 0.1).astype(
                "float32")).to(device)
        return a
    if isinstance(a, (list, tuple)):
        return type(a)(_materialize(x, torch, np, rng, device, dtype,
                                    upcast) for x in a)
    return a


def _ns_args(torch, case, device, dtype, seed, upcast=False):
    """``(args, kwargs)`` of ``case`` with its tensors on ``device``."""
    import numpy as np

    _, name, args, kw, _ = case
    rng = np.random.default_rng(seed)
    a = [_materialize(x, torch, np, rng, device, dtype, upcast)
         for x in args]
    k = {n: _materialize(v, torch, np, rng, device, dtype, upcast)
         for n, v in kw.items()}
    return (list(a[0]) if name == "lu_unpack" else a), k


def _ns_call(torch, mods, case, device, a, k):
    """One call of ``case`` on the arguments ``a``, ``k`` (the expected
    device set to ``device``, for the creation ops)."""
    from paddle_tpu_torch import device as pdev

    mod, name = case[:2]
    saved = pdev.expected_device()
    pdev.set_expected_device(torch.device(device))
    try:
        if name == "while_loop":
            import paddle_tpu_torch as pt
            return pt.ops.while_loop(
                lambda i, s: i < 5, lambda i, s: [i + 1, s * 2.0],
                [pt.to_tensor(0), pt.to_tensor(1.5)])
        return getattr(mods[mod], name)(*a, **k)
    finally:
        pdev.set_expected_device(saved)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _close(torch, got, want, rtol, atol):
    """``got`` (any device) against ``want`` (CPU): shapes and dtypes
    equal, values within ``rtol``/``atol``; returns the largest gap."""
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
          f"shape/dtype {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    g = got.detach().cpu()
    w = want.detach()
    if not (w.is_floating_point() or w.is_complex()):
        check(torch.equal(g, w), "values differ")
        return 0.0
    check(torch.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True),
          f"values differ by {(g - w).abs().max().item():.3e}")
    return (g - w).abs().nan_to_num().max().item() if g.numel() else 0.0


def _ns_agree(torch, family, got, want):
    """The card's output ``got`` against the CPU's ``want`` by the case's
    family (see NS_TOL); returns the largest gap."""
    if family in ("svd", "qr", "eigh", "eig", "lu"):
        return _ns_invariants(torch, family, got, want)
    gl, wl = _leaves(got), _leaves(want)
    check(len(gl) == len(wl), f"{len(gl)} outputs against {len(wl)}")
    worst = 0.0
    for g, w in zip(gl, wl):
        if not isinstance(w, torch.Tensor):
            check(g == w, f"{g!r} against {w!r}")
            continue
        if family == "random":
            on = "cuda" if torch.cuda.is_available() else "cpu"
            check(tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype
                  and g.device.type == on, "random draw's shape, dtype "
                  "or device")
            check(bool(torch.isfinite(g.float()).all()), "non-finite draw")
            continue
        rtol, atol = NS_TOL.get(family, (1e-6, 1e-6))
        if family == "fft":
            atol *= max(w.abs().max().item(), 1.0)
        worst = max(worst, _close(torch, g, w, rtol, atol))
    return worst


def _ns_invariants(torch, family, got, want):
    """Factors fixed up to signs: their values (singular values,
    eigenvalues) and what they rebuild, on the card."""
    rtol, atol = NS_TOL["linalg"]
    if family == "svd":
        u, s, v = got
        rebuilt = (u * s) @ v.mH
        x = want[0] * want[1] @ want[2].mH
        return max(_close(torch, s, want[1], rtol, atol),
                   _close(torch, rebuilt, x, rtol, atol))
    if family == "qr":
        q, r = got
        return max(_close(torch, q @ r, want[0] @ want[1], rtol, atol),
                   _close(torch, r.abs(), want[1].abs(), rtol, atol))
    if family == "eigh":
        w, q = got
        return max(_close(torch, w, want[0], rtol, atol),
                   _close(torch, (q * w) @ q.mT, (want[1] * want[0])
                          @ want[1].mT, rtol, atol))

    def ordered(e):
        e = e.detach().cpu()
        key = e.real * 1e3 + e.imag
        return e[torch.argsort(key)]

    if family == "eig" and isinstance(got, tuple):
        w, v = got
        a = (v * w) @ torch.linalg.inv(v)
        a_cpu = (want[1] * want[0]) @ torch.linalg.inv(want[1])
        return max(_close(torch, ordered(w), ordered(want[0]), rtol, atol),
                   _close(torch, a, a_cpu, rtol, atol))
    if family == "eig":
        return _close(torch, ordered(got), ordered(want), rtol, atol)
    lu_mat, piv = got                           # "lu"
    check(piv.dtype == torch.int32 and int(piv.min()) >= 1,
          "pivots not 1-based int32")
    p, l, u = torch.lu_unpack(lu_mat, piv)
    pc, lc, uc = torch.lu_unpack(*want)
    return _close(torch, p @ l @ u, pc @ lc @ uc, rtol, atol)


def _ns_low_agree(torch, family, got, want, dtype):
    """A 16-bit card output against the float32 CPU output on the same
    rounded inputs: within NS_LOW_ULPS of ``dtype`` at each element's
    scale (its magnitude, or the output's rms), or equal for the exact
    family."""
    gl, wl = _leaves(got), _leaves(want)
    worst = 0.0
    for g, w in zip(gl, wl):
        g = g.detach().cpu()
        if not g.is_floating_point():
            check(torch.equal(g, w.to(g.dtype)), "values differ")
            continue
        check(g.dtype == dtype, f"dtype {g.dtype}, not {dtype}")
        if family == "exact":
            check(torch.equal(g.float(), w.float()), "values differ")
            continue
        unit = torch.finfo(dtype).eps / 2
        w = w.float()
        scale = torch.maximum(w.abs(), w.pow(2).mean().sqrt())
        ulps = ((g.float() - w).abs() / (scale * unit)).nan_to_num()
        worst = max(worst, ulps.max().item())
        check(worst <= NS_LOW_ULPS[family], f"{worst:.1f} ulps of {dtype}")
    return worst


def namespace_phase(torch, seed, dev="cuda"):
    """Phase 28a: every case of `namespace_cases` on ``dev`` against the
    CPU; the NS_LOW float ops again in float16 and bfloat16. Prints the
    counts, the largest gap by family, the card's total time, the
    functions that synchronise with the host inside the call (a read
    back of a count, a host check, a host solver) and the names of any
    that failed with the reason; fails if one did, or if a name of
    `ops`, `linalg`, `fft` or `signal` has no case."""
    import warnings

    import paddle_tpu_torch as pt

    mods = {"ops": pt.ops, "fft": pt.fft, "signal": pt.signal}
    cases = namespace_cases()
    have = collections.defaultdict(set)
    for mod, name, *_ in cases:
        have[mod].add(name)
    lacking = sorted({*(set(pt.ops.__all__) - have["ops"]),
                      *(set(pt.linalg.__all__) - have["ops"]),
                      *(set(pt.fft.__all__) - have["fft"]),
                      *(set(pt.signal.__all__) - have["signal"])})
    check(not lacking, f"namespace functions with no case: {lacking}")
    failed, gaps, synced = [], collections.defaultdict(float), {}
    runs, card_s = 0, 0.0
    for idx, case in enumerate(cases):
        mod, name, _, _, family = case
        dtypes = [torch.float32]
        if mod == "ops" and name in NS_LOW and family in (
                "float", "special", "reduce", "exact"):
            dtypes += [torch.float16, torch.bfloat16]
        for dt in dtypes:
            label = f"{mod}.{name}[{idx}] {str(dt)[6:]}"
            try:
                # the CPU's float32 call, on the 16-bit runs' inputs
                # rounded to the 16-bit dtype
                want = _ns_call(torch, mods, case, "cpu", *_ns_args(
                    torch, case, "cpu", dt, seed * 1000 + idx, upcast=True))
                a, k = _ns_args(torch, case, dev, dt, seed * 1000 + idx)
                if dev == "cuda":
                    torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    if dev == "cuda":
                        torch.cuda.set_sync_debug_mode("warn")
                    t0 = time.perf_counter()
                    try:
                        got = _ns_call(torch, mods, case, dev, a, k)
                    finally:
                        if dev == "cuda":
                            torch.cuda.set_sync_debug_mode(0)
                            torch.cuda.synchronize()
                    card_s += time.perf_counter() - t0
                # torch's sync debug warning (not its one-time notice that
                # the mode is a prototype)
                n_sync = sum("called a synchronizing CUDA operation"
                             in str(w.message) for w in seen)
                if n_sync and dt == torch.float32:
                    synced[f"{mod}.{name}"] = n_sync
                if dt == torch.float32:
                    gap = _ns_agree(torch, family, got, want)
                else:
                    gap = _ns_low_agree(torch, family, got, want, dt)
                gaps[f"{family} {str(dt)[6:]}"] = max(
                    gaps[f"{family} {str(dt)[6:]}"], gap)
                runs += 1
            except Exception as e:           # noqa: BLE001 (listed, then fail)
                failed.append(f"{label}: {type(e).__name__}: {e}"[:300])
    n_names = len(set(pt.ops.__all__) | set(pt.fft.__all__)
                  | set(pt.signal.__all__))
    print(f"  {len(cases)} cases over {n_names} functions (ops "
          f"{len(pt.ops.__all__)} incl. linalg's {len(pt.linalg.__all__)}, "
          f"fft {len(pt.fft.__all__)}, signal {len(pt.signal.__all__)}); "
          f"{runs} runs agreed on {dev} (float32; float16 and bfloat16 "
          f"for {len(NS_LOW)} float ops), {len(failed)} failed; the "
          f"card's calls {card_s:.3f} s in all")
    print("    largest gap by family and dtype (float32: absolute; 16-bit: "
          "ulps at scale): " + ", ".join(
              f"{k} {v:.3g}" for k, v in sorted(gaps.items())))
    print(f"    functions that synchronise with the host inside the call "
          f"({len(synced)}): " + ", ".join(
              f"{k} x{v}" for k, v in sorted(synced.items())))
    for line in failed:
        print(f"    FAILED {line}")
    check(not failed, f"{len(failed)} namespace runs failed on {dev}")
    return synced


# 28b: gpt3-1.3b (the model and shape of phase 5) trained eagerly as a
# user writes it under amp.auto_cast O1 float16 with a GradScaler
# (Megatron-LM's --fp16; Brown et al. 2020's GPT-3 XL widths): float32
# parameters and AdamW moments, dropout 0, one repeated batch of b8 x
# s1024 ids. GPT28_WARM steps, then GPT28_STEPS timed ones; step 0's
# loss within GPT28_LOSS_RTOL of a float32 no_grad forward of the batch
GPT28_B, GPT28_S, GPT28_WARM, GPT28_STEPS = 8, 1024, 2, 6
GPT28_LR, GPT28_SCALE, GPT28_LOSS_RTOL = 1e-4, 2.0 ** 15, 5e-3
# the device memory a run may peak at before the batch is cut to b4
GPT28_PEAK_LIMIT = 70 * 2 ** 30


def gpt_amp_phase(torch, seed, card):
    """Phase 28b: `GPTForPretraining("gpt3-1.3b")` drawn from ``seed``,
    trained eagerly with ``amp.auto_cast(level="O1", dtype="float16")``,
    ``amp.GradScaler`` and the port's AdamW. Checks: the logits are
    float16 (the repaired head); step 0's loss is within GPT28_LOSS_RTOL
    of the float32 forward's; B1's float16 forward and backward launch
    exactly steps x layers times each over the timed steps and the
    update (P1) once a kept step; the loss falls over the steps. Prints
    step ms p50, tokens/s, MFU, peak memory and a profile of two steps
    (busy share, kernels and host launch calls a step). Returns the
    timed steps' launch counts."""
    import dataclasses

    from paddle_tpu_torch import amp, kernels
    from paddle_tpu_torch.models.gpt import (GPTForPretraining,
                                             GPTPretrainingCriterion,
                                             gpt_config)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(gpt_config(MODEL), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTForPretraining(cfg, seed=seed)
    model.requires_grad_(True)
    model.train()
    params = list(model.parameters())
    opt = AdamW(learning_rate=GPT28_LR, parameters=params,
                weight_decay=TRAIN_WD)
    scaler = amp.GradScaler(init_loss_scaling=GPT28_SCALE)
    crit = GPTPretrainingCriterion()
    g = torch.Generator(device="cuda").manual_seed(seed + 28)
    ids = torch.randint(0, cfg.vocab_size, (GPT28_B, GPT28_S + 1),
                        generator=g, device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]
    print(f"  {MODEL}: {cfg.num_hidden_layers} layers, h={cfg.hidden_size}, "
          f"{cfg.num_attention_heads} heads, d={cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, dropout 0; b{GPT28_B} x s{GPT28_S}, one "
          f"repeated batch; float32 params, AdamW lr {GPT28_LR} wd "
          f"{TRAIN_WD}, GradScaler({GPT28_SCALE:g}), auto_cast O1 float16, "
          "eager")
    with torch.no_grad():
        ref = crit(model(x), y).item()
    dtypes = []

    def step():
        with amp.auto_cast(level="O1", dtype="float16"):
            logits = model(x)
            loss = crit(logits, y)
        dtypes.append(logits.dtype)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss

    losses, times, scales = [], [], []
    for i in range(GPT28_WARM + GPT28_STEPS):
        if i == GPT28_WARM:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_kernel_launch_counts()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        scales.append(scaler.get_loss_scaling())
    counts = kernels.kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = abs(losses[0] - ref) / abs(ref)
    check(all(d == torch.float16 for d in dtypes),
          f"logits {set(dtypes)}: the LM head does not cast under O1")
    check(rel <= GPT28_LOSS_RTOL, f"step 0's loss {losses[0]} against the "
          f"float32 forward's {ref}: relative {rel:.2e}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[-1] < losses[0] - 0.1, f"the loss did not fall: {losses}")
    timed_scales = [GPT28_SCALE] + scales
    skipped = sum(1 for a, b in zip(timed_scales[GPT28_WARM:],
                                    scales[GPT28_WARM:]) if b < a)
    want = {"flash_attention_qkv_fwd_f16": GPT28_STEPS
            * cfg.num_hidden_layers,
            "flash_attention_qkv_bwd_f16": GPT28_STEPS
            * cfg.num_hidden_layers}
    if GPT28_STEPS - skipped:
        want["multi_tensor_adam"] = GPT28_STEPS - skipped
    only_launched(counts, want, "gpt3-1.3b eager O1 float16 training")
    p50 = statistics.median(times[GPT28_WARM:]) * 1e3
    tok_s = GPT28_B * GPT28_S / (p50 / 1e3)
    flops_per_tok = (6 * cfg.num_params(include_embeddings=False)
                     + 12 * cfg.num_hidden_layers * cfg.hidden_size
                     * GPT28_S)
    mfu = tok_s * flops_per_tok / BF16_FLOPS_PER_S
    print(f"  float16 logits in every step; step 0's loss {losses[0]:.6f} "
          f"against the float32 forward's {ref:.6f} (rel {rel:.2e} <= "
          f"{GPT28_LOSS_RTOL}); losses {[round(v, 4) for v in losses]} "
          f"(falling); loss scale {scales}, {skipped} timed steps skipped")
    print(f"  launches over the {GPT28_STEPS} timed steps: {want} (B1 "
          f"float16 fwd = bwd = steps x layers, the update once a kept "
          "step)  ok")
    print(f"  {card}: eager O1 float16 step {p50:.3f} ms p50 of the "
          f"{GPT28_STEPS} timed steps (steps "
          f"{[round(t * 1e3, 3) for t in times]} ms, the first "
          f"{GPT28_WARM} warm-up), {tok_s:.1f} tokens/s, MFU {mfu:.4f} "
          f"({flops_per_tok} flops/token over 989 TFLOP/s), peak "
          f"{peak / 2 ** 30:.3f} GiB")
    check(peak <= GPT28_PEAK_LIMIT, f"peak {peak / 2 ** 30:.3f} GiB over "
          f"{GPT28_PEAK_LIMIT / 2 ** 30:.0f}: cut the batch to b4")
    profile_steps(torch, step, 2, "eager O1 float16 GPT steps",
                  {**qkv_families("B1"), **ADAM_FAMILY})
    del model, opt, scaler, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


# ------------------------------------------------------------- phase 29
def paged_launch_check(counts, name, s, layers, label, cross=False):
    """The paged kernel launched under ``name`` exactly decode steps x
    layers times (each decode or verify step one launch a layer), as
    ``paged_attention_cross`` too when ``cross``, and no other kernel."""
    want = s.decode_steps * layers
    check(counts[name] == want, f"{label}: {name} launched {counts[name]} "
          f"times, decode_steps x layers = {want}")
    allowed = {name, "paged_attention_cross"} if cross else {name}
    check(counts.get("paged_attention_cross", 0) == (want if cross else 0),
          f"{label}: paged_attention_cross launched "
          f"{counts.get('paged_attention_cross', 0)} times")
    others = {k: v for k, v in counts.items() if v and k not in allowed}
    check(not others, f"{label}: other kernels launched: {others}")
    return counts[name]


def serve_line(label, s, wall):
    print(f"  {label}: {s.decode_steps} decode steps, {s.tokens_generated} "
          f"tokens in {wall:.3f} s; decode {s.decode_step_p50 * 1e3:.3f} "
          f"ms/step p50, TTFT p50 {s.ttft_p50 * 1e3:.3f} ms, "
          f"{s.tokens_generated / wall:.1f} tokens/s")


def fp16_serving_phase(torch, seed, card):
    """Phase 29a: gpt3-1.3b at full width and depth in float16 (random
    weights from ``seed``) served by ``Engine(kv_mode="paged")`` on
    float16 pages, phase 4's configuration and traffic, with the tracing
    buffer off and no sink (the unarmed engine of 29c); then again with
    ``spec_k=4`` (W=5). Checks: every stream against a float32 teacher
    (the 0.05 near-tie rule), B3's float16 launches exactly decode steps
    x layers, one decode graph each under the armed sentinel. Prints
    ms/step p50, TTFT p50, tokens/s and a profile's busy share. Returns
    ``(model, prompts, outputs, stats, wall, launches by record name)``."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.serving import Engine

    cfg = gpt_config(MODEL)
    model = GPTForPretraining(cfg, dtype="float16", seed=seed)
    torch.cuda.synchronize()
    layers = cfg.num_hidden_layers
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    warm = Engine(model, **kw)
    warm.submit(list(range(1, 30)), max_new_tokens=2).result()
    del warm
    prompts = phase_prompts(torch, cfg, seed)
    saved = tracing.buffer_enabled()
    tracing.set_buffer_enabled(False)
    try:
        check(not tracing.active(), "a tracing sink is attached")
        eng = Engine(model, **kw)
        check(all(k.dtype == v.dtype == torch.float16
                  for k, v in eng.kv.caches), "pages are not float16")
        outs, s, wall, counts = serve_traffic(torch, eng, prompts)
        del eng
    finally:
        tracing.set_buffer_enabled(saved)
    n1 = paged_launch_check(counts, "paged_attention_f16", s, layers,
                            "29a")
    serve_line(f"{MODEL} float16, float16 pages, spec_k 0 (tracing off)",
               s, wall)
    teacher_check(torch, model, prompts, outs)
    outs5, s5, wall5, counts5 = serve_traffic(
        torch, Engine(model, spec_k=SPEC_K, **kw), prompts)
    n5 = paged_launch_check(counts5, "paged_attention_f16", s5, layers,
                            "29a spec_k=4")
    serve_line(f"{MODEL} float16, float16 pages, spec_k {SPEC_K} (W=5, "
               f"accept rate {s5.spec_accept_rate:.3f})", s5, wall5)
    teacher_check(torch, model, prompts, outs5)
    profile_decode(torch, Engine(model, **kw), prompts)
    return model, prompts, outs, s, wall, {
        "paged_attention_f16_f16_w1": n1, "paged_attention_f16_f16_w5": n5}


def dtype_engine_phase(torch, seed, card):
    """Phase 29b: phase 4's bf16 gpt3-1.3b served by
    ``Engine(kv_mode="paged", dtype="float32")`` and then
    ``dtype="float16"``: B3 reads float32 or float16 pages under bf16
    queries (cross-dtype launches counted). Checks: the streams against
    the float32 teacher; the pool holds the asked dtype; ``stats()``
    reports its bytes at that dtype (pages + sentinel, layers, K and V,
    heads, page size, head dim, the dtype's bytes) and `pages_in_budget`
    at the stored dtype gives the pool's page count back from those
    bytes. Returns the launches by record name."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.paged import pages_in_budget

    cfg = gpt_config(MODEL)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=seed)
    layers = cfg.num_hidden_layers
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    prompts = phase_prompts(torch, cfg, seed)
    launched = {}
    for dtype, short in (("float32", "f32"), ("float16", "f16")):
        eng = Engine(model, dtype=dtype, **kw)
        dt = getattr(torch, dtype)
        check(all(k.dtype == v.dtype == dt for k, v in eng.kv.caches),
              f"pages are not {dtype}")
        outs, s, wall, counts = serve_traffic(torch, eng, prompts)
        launched[f"paged_attention_bf16_{short}_w1"] = paged_launch_check(
            counts, "paged_attention", s, layers, f"29b dtype={dtype}",
            cross=True)
        serve_line(f"{MODEL} bf16, {dtype} pages (Engine(dtype="
                   f"{dtype!r}))", s, wall)
        teacher_check(torch, model, prompts, outs)
        per_page = (layers * 2 * cfg.num_attention_heads * PAGE
                    * cfg.head_dim * dt.itemsize)
        check(s.kv_pool_bytes == (s.kv_pages_total + 1) * per_page,
              f"kv_pool_bytes {s.kv_pool_bytes} != (pages + 1) x "
              f"{per_page}")
        back = pages_in_budget(model, s.kv_pool_bytes, page_size=PAGE,
                               dtype=dtype)
        check(back == s.kv_pages_total,
              f"pages_in_budget({s.kv_pool_bytes}) = {back}, the pool "
              f"holds {s.kv_pages_total}")
        print(f"  pool at {dtype}: {s.kv_pages_total} pages + the sentinel "
              f"= {s.kv_pool_bytes} bytes ({per_page} a page, "
              f"{s.kv_bytes_per_token:.0f} a token); pages_in_budget "
              f"gives {back} pages back from those bytes")
        del eng
    del model
    torch.cuda.empty_cache()
    return launched


def prometheus_lines(text):
    """The sample lines of a Prometheus text exposition; raises on a
    malformed one."""
    import re

    pat = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$')
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        check(pat.match(line) is not None,
              f"malformed exposition line: {line!r}")
        samples += 1
    return samples


def http_get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def analytic_decode_products(cfg, slots, w):
    """An analytic count of the products of one decode step of ``slots``
    rows of ``w`` queries: 2 x ((4 h^2 + 2 h I) a layer + h V) a query
    (qkv and the projection, the MLP's two of width I, the LM head)."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    return 2.0 * slots * w * ((4 * h * h + 2 * h * i)
                              * cfg.num_hidden_layers + h * v)


def armed_engine_phase(torch, seed, card, model, prompts, base_outs, base_s,
                       base_wall):
    """Phase 29c: 29a's float16 engine armed with every A9 argument
    (``slo=SLO(...)``, ``flight_recorder=True``, ``observability_port=0``,
    a ``profiler=`` callback) and tracing on (the span buffer, the
    recorder's ring). Checks: its greedy streams equal 29a's unarmed ones
    token for token; every endpoint answers over 127.0.0.1 and
    ``/metrics`` parses as Prometheus text; three steps under
    `profiler.Profiler` on the GPU target give a device trace and the
    engine's host spans. Prints decode_flops_per_token beside an analytic
    count and the armed ms/step beside the unarmed one. Then a small
    engine with a fault injector dies on a step and leaves exactly one
    postmortem in a temporary directory (removed after), and a clean
    ``close()`` leaves none."""
    import tempfile

    from paddle_tpu_torch import profiler as pprof
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    from paddle_tpu_torch.observability import SLO, FlightRecorder, tracing
    from paddle_tpu_torch.serving import Engine, FaultInjector

    cfg = model.config
    layers = cfg.num_hidden_layers
    kw = dict(kv_mode="paged", slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
              prefill_buckets=BUCKETS)
    events = []
    eng = Engine(model, slo=SLO(ttft_p99_s=5.0, itl_p99_s=1.0,
                                e2e_p99_s=30.0),
                 flight_recorder=True, observability_port=0,
                 profiler=lambda ev, info: events.append(ev), **kw)
    check(tracing.active(), "tracing is off in the armed run")
    try:
        outs, s, wall, counts = serve_traffic(torch, eng, prompts)
        paged_launch_check(counts, "paged_attention_f16", s, layers, "29c")
        check(outs == base_outs, "the armed engine's streams differ from "
              "the unarmed engine's")
        print(f"  armed streams equal the unarmed ones token for token "
              f"({sum(map(len, outs))} tokens); profiler callback events "
              f"{dict(collections.Counter(events))}")
        serve_line("armed (SLO, flight recorder, endpoint, profiler "
                   "callback, tracing on)", s, wall)
        print(f"  decode ms/step p50: armed {s.decode_step_p50 * 1e3:.3f}, "
              f"unarmed {base_s.decode_step_p50 * 1e3:.3f} (29a); wall "
              f"{wall:.3f} against {base_wall:.3f} s")
        check(s.slo_attained + s.slo_violated == len(prompts),
              f"the SLO scored {s.slo_attained + s.slo_violated} of "
              f"{len(prompts)} requests")
        print(f"  SLO: attained {s.slo_attained}, violated "
              f"{s.slo_violated}, attainment {s.slo_attainment}, burn "
              f"{s.slo_burn_rate}, goodput {s.goodput_per_s:.3f}/s")
        # the decode step's operators counted once (every slot parked:
        # the step the engine runs on idle rows, its K/V on the sentinel
        # page; B3 is a ctypes launch the counter cannot see) against
        # the analytic products and the engine's closed form
        from paddle_tpu_torch import kernels
        from paddle_tpu_torch.observability import costs

        check(not eng.kv.active.any(), "29c: a slot is still active")
        with torch.inference_mode(), kernels.launches_uncounted():
            _, counted = costs.count_flops(
                eng._verify.run_eager,
                **eng._step_operands(eng._tokens[:, None]))
        mm = analytic_decode_products(cfg, SLOTS, 1)
        products = costs.gpt_decode_flops(cfg, 1, [0] * SLOTS)
        check(abs(counted / mm - 1) < 0.02 and products == mm,
              f"counted decode-step operations {counted:.4e} against the "
              f"analytic products {mm:.4e} (closed form {products:.4e})")
        print(f"  decode step: counted {counted:.6e} operations "
              f"(FlopCounterMode over one eager run), analytic products "
              f"{mm:.6e} (ratio {counted / mm:.5f}); B3's 4 H W L D a "
              f"row and layer at the engine's columns "
              f"{s.decode_exec_flops - products:.6e}; decode_exec_flops "
              f"{s.decode_exec_flops:.6e}, decode_flops_per_token "
              f"{s.decode_flops_per_token:.6e} (analytic products a token "
              f"at full slots {mm / SLOTS:.6e})")
        url = eng.obs_server.url
        check(url.startswith("http://127.0.0.1:"), f"endpoint at {url}")
        for path in ("/metrics", "/healthz", "/readyz", "/stats", "/trace",
                     "/slo", "/requests", "/train"):
            code, body = http_get(url + path)
            check(code == 200, f"{path} answered {code}")
            if path == "/metrics":
                n = prometheus_lines(body)
                check("serving_tokens_emitted_total" in body
                      and "serving_slo_attained_total" in body,
                      "/metrics lacks the serving families")
            else:
                json.loads(body)
        print(f"  endpoint {url}: /metrics ({n} samples, parsed), "
              "/healthz, /readyz, /stats, /trace, /slo, /requests, /train "
              "all 200")
        prof = pprof.Profiler(targets=[pprof.ProfilerTarget.CPU,
                                       pprof.ProfilerTarget.GPU])
        for p in prompts[:SLOTS]:
            eng.submit(p, max_new_tokens=MAX_NEW)
        eng.step()
        with prof:
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in
                     prof.device_profile.key_averages())
        host = collections.Counter(e["name"] for e in prof._events)
        check(dev_us > 0, "the profiler's device trace holds no device time")
        check(host["serving.decode"] == 3,
              f"the profiler's host spans: {dict(host)}")
        print(f"  profiler.Profiler (CPU + GPU targets) over 3 steps: "
              f"device time {dev_us / 1e3:.3f} ms, host spans "
              f"{dict(host)}")
        eng.run_until_idle()
    finally:
        eng.close()
    check(eng._flight.dumps == [], "close() wrote a postmortem")

    small = GPTForPretraining("gpt-test", dtype="float16", seed=seed)
    tmp = tempfile.mkdtemp(prefix="flight-")
    try:
        rec = FlightRecorder(dump_dir=tmp)
        sk = dict(slots=2, max_len=24, prefill_buckets=(8,),
                  kv_mode="paged", page_size=4, flight_recorder=rec)
        dying = Engine(small, fault_injector=FaultInjector().add(
            "step_error", at_step=2), **sk)
        h = dying.submit(list(range(1, 7)), max_new_tokens=6)
        try:
            h.result()
            died = None
        except RuntimeError as exc:
            died = exc
        check(died is not None and not dying.alive,
              "the injected step fault did not kill the engine")
        files = sorted(os.listdir(tmp))
        check(len(files) == 1, f"postmortems after the death: {files}")
        art = json.load(open(os.path.join(tmp, files[0])))
        check(art["reason"] == "InjectedFault"
              and art["engine_id"] == dying.engine_id,
              f"postmortem: {art['reason']} {art['engine_id']}")
        clean = Engine(small, **sk)
        clean.submit(list(range(1, 7)), max_new_tokens=3).result()
        clean.close()
        check(len(os.listdir(tmp)) == 1, "close() wrote a postmortem")
        rec.detach()
        print(f"  a step fault killed {dying.engine_id}: one postmortem "
              f"({art['schema']}, {len(art['events'])} events, in-flight "
              f"{art['in_flight_request_ids']}); a clean close() wrote "
              "none")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), "the postmortem directory remains")


def print_build_report(name, report):
    """One source's build seconds, then for each kernel ptxas's register,
    shared-memory and spill lines, joined on one line."""
    from paddle_tpu_torch.kernels import _build

    src, flags = _build.source_and_flags(name)
    lines = report.splitlines()
    print(f"  {' '.join([src + '.cu', *flags])}: "
          f"{lines[0] if lines else 'not built here'}")
    kernel = None
    for ln in lines[1:]:
        if "Compiling entry function" in ln:
            kernel, spill = ln.split("'")[1], ""
        elif kernel and "Function properties" not in ln and (
                "spill" in ln or "Used" in ln):
            if "spill" in ln:
                spill = ln.strip()
                continue
            try:
                shown = subprocess.run(["c++filt", kernel], text=True,
                                       capture_output=True,
                                       timeout=10).stdout.strip()
            except OSError:
                shown = kernel
            print(f"    {shown}: {ln.split(':', 1)[1].strip()}; {spill}")
            kernel = None


@contextlib.contextmanager
def launches_tallied(names):
    """Inside, the launches counted under ``names`` over every phase:
    each phase sets the counts to 0 before it drives its path, so they
    are added up before each reset and once at the end. Starts from 0;
    yields the running sums."""
    from paddle_tpu_torch import kernels

    total = dict.fromkeys(names, 0)
    reset = kernels.reset_kernel_launch_counts

    def add_then_reset():
        counts = kernels.kernel_launch_counts()
        for name in names:
            total[name] += counts[name]
        reset()

    reset()
    kernels.reset_kernel_launch_counts = add_then_reset
    try:
        yield total
    finally:
        kernels.reset_kernel_launch_counts = reset
        add_then_reset()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_run = time.perf_counter()

    def say(line):
        """A phase's heading, with the seconds since the start."""
        print(f"{line} (at {time.perf_counter() - t_run:.1f} s)")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    card = nvidia_smi_line()
    say(f"[1] card: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("    TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t = time.perf_counter()
    _build.build_all()
    say(f"[2] built {_build.sources()} for sm_90a in "
        f"{time.perf_counter() - t:.1f} s (one nvcc a source, in "
        "parallel)")
    for name in _build.sources():
        print_build_report(name, _build.build_report(name))

    say("[3] kernel phase")
    records = [*kernel_phase(torch, pa), tail_kernel_phase(torch, pa),
               *paged_dtype_phase(torch, pa),
               *paged_head_dim_checks(torch, pa)]
    wide = wide_head_paged_checks(torch, pa)
    records += [*wide,
               *flash_kernel_phase(torch), *general_flash_phase(torch),
               *wide_flash_phase(torch), *qkv3_kernel_phase(torch)]
    ln_records, launches = fused_ln_phase(torch)
    records += ln_records
    records.append(adam_kernel_phase(torch, args.seed))
    # the C.6 rows' launches: every width-512 launch of their page type
    # on the main paths (no model there has heads above 256)
    counter = {"bf16": "paged_attention_wide",
               "int8": "paged_attention_int8_wide"}
    wide_names = {rec["name"]: counter[rec["name"].split("_")[2]]
                  for rec in wide}
    with launches_tallied(set(wide_names.values())) as wide_seen:
        say("[4] engine phase")
        counts, paged_step = engine_phase(torch, args.seed)
        launches.update(counts)
        say("[5] training phase")
        launches.update(train_phase(torch, args.seed, card))
        say("[6] BERT phase (masked, B2)")
        launches.update(bert_phase(torch, args.seed, card, "masked"))
        say("[7] BERT unmasked phase, unfused layers (B5)")
        launches.update(bert_phase(torch, args.seed, card, "unfused"))
        say("[8] BERT unmasked phase, fused layers (B1)")
        fused = bert_phase(torch, args.seed, card, "fused")
        print(f"  (B1's launches in the kernel line are GPT training's; "
              f"the fused BERT's were {fused})")
        say("[9] quantized speculative serving phase (int8/fp8 pages, "
            "k=4)")
        launches.update(spec_phase(torch, args.seed))
        say("[10] generation phase (greedy, beam paged/gather, int8 tail "
            "pages, weight-only int8)")
        launches.update(gen_phase(torch, args.seed))
        say("[11] sequence-parallel phase (B4, the ring's per-rank loop, "
            "one rank)")
        records += b4_kernel_phase(torch)
        launches.update(ring_loop_phase(torch))
        one_rank_phase(torch)
        say("[12] gpt3-2.7b serving phase (head dim 80: Engine on bf16 "
            "and int8 pages, the paged beam)")
        launches.update(serve_27b_phase(torch, args.seed))
        say("[13] attention at Gemma-2B's widths (B2 at head dim 256, "
            "training)")
        launches.update(gemma_phase(torch, args.seed, card))
        say("[14] the optimizer plane on graphs (gpt-test: an LR "
            "schedule, GradScaler's skip)")
        schedule_phase(torch, args.seed)
        scaler_phase(torch, args.seed)
        pfx, mix = serving_modes_phases(torch, args.seed, paged_step)
        print(f"  (B3's launches in the kernel line are phase 4's; phase "
              f"16's were {pfx}, phase 17's {mix})")
        say("[18] the rest of the paged Engine (gpt3-1.3b, bf16 pages: "
            "adaptive spec_k on W = 2, 3, 5, 9, draft_model=, deadlines, "
            "bounded admission, background mode)")
        launches.update(engine_rest_phase(torch, args.seed, paged_step))
        say("[19] the training plane (gpt3-1.3b's widths: "
            "ResilientTrainLoop around phase 5's step, async checkpoints, "
            "crash and resume, rollbacks, introspection)")
        phase5 = {k: launches[k] for k in ("flash_attention_qkv_fwd",
                                           "flash_attention_qkv_bwd",
                                           "multi_tensor_adam")}
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            PLANE_DIR)
        shutil.rmtree(root, ignore_errors=True)
        try:
            launches.update(plane_phase(torch, args.seed, card, root))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(f"  (B1's and the update's launches in the kernel line are "
              f"phase 19's; phase 5's were {phase5})")
        say("[20] ViT-L/16 (224 px, patch 16: 197 tokens; eval forward, "
            "training on a graph, B2 measured at its attention shape)")
        vit_phase(torch, args.seed, card)
        say("[21] the encoder-decoder Transformer (nn.Transformer's "
            "defaults: B5 in the encoder, B2 under the causal -inf mask "
            "and across; incremental decode)")
        phase21 = transformer_phase(torch, args.seed, card)
        for name, n in phase21.items():
            launches[name] += n
        print(f"  (B2's and B5's launches in the kernel line add phase 21's "
              f"{phase21} to phases 6 and 7's)")
        say("[22] FusedMultiTransformer at gpt3-1.3b's widths (CacheKV "
            "prefill, pre_caches, decode with time_step)")
        fmt_phase(torch, args.seed, card)
        say("[23] the MoE layer on one card (gpt3-1.3b's width, 8 experts, "
            "GShardGate top-2)")
        moe_phase(torch, args.seed, card)
        say("[24] A5's layer base (nn.Transformer() from the reference's "
            "initializers and ParamAttr, eager AdamW steps, state_dict "
            "through save/load into a LazyGuard twin)")
        phase24 = layer_base_phase(torch, args.seed, card)
        for name, n in phase24.items():
            launches[name] += n
        print(f"  (B2's and B5's launches in the kernel line add phase 24's "
              f"{phase24})")
        say("[25] A5 slice 2 (activations, losses, norms, pooling, vision "
            "functions, common layers): ResNet-50 trained eagerly at full "
            "width, nn.Transformer() with activation='gelu' and "
            "nn.MSELoss() through B5 and B2, a layer sweep against the "
            "CPU")
        say(f"[25a] ResNet-50 (1000 classes, 224 px, b32, float32) on "
            f"{card}")
        resnet_phase(torch, args.seed, card)
        say(f"[25b] nn.Transformer(activation='gelu'), nn.MSELoss on "
            f"{card}")
        phase25 = gelu_transformer_phase(torch, args.seed, card)
        for name, n in phase25.items():
            launches[name] += n
        print(f"  (B2's and B5's launches in the kernel line add phase 25's "
              f"{phase25})")
        say(f"[25c] the layer sweep, card against CPU, on {card}")
        layer_sweep_phase(torch, args.seed)
        say("[26] A5 slice 3 (the RNNs, BeamSearchDecoder/dynamic_decode, "
            "the extra layers and functions, nn.utils, nn.quant): the "
            "Zaremba large LSTM trained eagerly, nn.Transformer() "
            "beam-searched, a layer sweep against the CPU")
        say(f"[26a] the Zaremba large LSTM LM (b{PTB_B} x {PTB_T}, float32) "
            f"on {card}")
        ptb_phase(torch, args.seed, card)
        say(f"[26b] nn.Transformer() beam search (b{BS_B} x {BS_SRC}, beam "
            f"{BS_BEAMS}, {BS_STEPS} steps, float32) on {card}")
        phase26 = beam_phase(torch, args.seed, card)
        for name, n in phase26.items():
            launches[name] += n
        print(f"  (B5's launches in the kernel line add phase 26's "
              f"{phase26})")
        say(f"[26c] the layer sweep of A5 slice 3, card against CPU, on "
            f"{card}")
        layer_sweep_phase(torch, args.seed, sweep_cases_26)
        say("[27] A2 and A3 (dtypes with float16, places, Tensor, "
            "autograd, the dispatch hook, amp.auto_cast O1/O2): the "
            "float16 kernels, nn.Transformer() trained eagerly under AMP")
        say(f"[27a] the float16 forms of B2, B5, B1, B4 and P1 against "
            f"their plain versions on {card}")
        records += fp16_kernel_phase(torch, args.seed)
        say(f"[27b] nn.Transformer() + Embedding(37000, 512) + Linear(512, "
            f"37000), b{TR_B} x ({TR_SRC} + {TR_TGT}), dropout 0.1, eager "
            f"AdamW under amp.auto_cast (O1 fp16 + GradScaler, O2 fp16 "
            f"through decorate + GradScaler, O1 bf16) on {card}")
        phase27 = amp_phase(torch, args.seed, card)
        for name, n in phase27.items():
            launches[name] = launches.get(name, 0) + n
        print(f"  (the float16 rows' launches in the kernel line are phase "
              f"27b's; B2's, B5's and the update's add its other launches: "
              f"{ {k: v for k, v in phase27.items() if v} })")
        say("[28] A4 (the op namespace: ops, linalg, fft, signal) and the "
            "models' white-list matmuls under amp.auto_cast")
        say(f"[28a] every namespace function on the card against the CPU "
            f"(float32; float16 and bfloat16 for the float ops) on {card}")
        namespace_phase(torch, args.seed)
        say(f"[28b] gpt3-1.3b trained eagerly under amp.auto_cast O1 "
            f"float16 + GradScaler, b{GPT28_B} x s{GPT28_S} on {card}")
        phase28 = gpt_amp_phase(torch, args.seed, card)
        for name, n in phase28.items():
            launches[name] = launches.get(name, 0) + n
        print(f"  (B1's float16 launches in the kernel line are phase 28b's; "
              f"the update's add its {phase28.get('multi_tensor_adam', 0)})")
        say("[29] the Engine's single-card arguments: float16 and "
            "cross-dtype KV pages (Engine(dtype=)), the A9 plane (slo, "
            "flight_recorder, observability_port, profiler)")
        say(f"[29a] {MODEL} in float16 on float16 pages, spec_k 0 and "
            f"{SPEC_K}, on {card}")
        model16, prompts16, outs16, s16, wall16, phase29 = \
            fp16_serving_phase(torch, args.seed, card)
        say(f"[29b] {MODEL} in bf16 on float32 and float16 pages "
            f"(Engine(dtype=)) on {card}")
        phase29.update(dtype_engine_phase(torch, args.seed, card))
        say(f"[29c] 29a's engine armed (slo, flight_recorder, "
            f"observability_port=0, profiler, tracing on) on {card}")
        armed_engine_phase(torch, args.seed, card, model16, prompts16,
                           outs16, s16, wall16)
        del model16
        launches.update(phase29)
        print(f"  (B3's float16 and cross-dtype launches in the kernel line "
              f"are phase 29's: {phase29})")
    print(f"  width-512 launches of B3 over phases 4-18: {wide_seen}")
    launches.update({name: wide_seen[c] for name, c in wide_names.items()})
    for rec in records:
        rec["launches"] = launches.get(rec["name"], 0)

    print(json.dumps({"kernels": records}))
    print(f"whole run: {time.perf_counter() - t_run:.1f} s wall")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
