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
   H8 D256;
4. engine phase: gpt3-1.3b at full width and depth, bf16, random
   weights from ``--seed``, served by
   the paged `Engine` (8 slots, page 16, max_len 640, buckets 128/512)
   under staggered traffic. Launch counts are zeroed just before the run
   and read just after: paged attention must have launched exactly
   decode_steps x layers times. Every request
   completes, every page returns to the pool, and a teacher-forced
   full-sequence forward with plain attention, of a float32 copy of the
   weights, agrees with each emitted token unless its logit is within
   0.05 of the reference's top one. Then a few full decode steps run
   under torch.profiler: the device's busy share and the top kernels;
5. training phase: gpt3-1.3b at full width and depth trains through
   `SpmdTrainStep` (b8 x s1024 from ``--seed``, dropout 0, bf16 params
   and AdamW moments, lr 1e-4, wd 0.01). The bf16 model's loss and
   grads agree with a float32 copy of its weights run through the plain
   attention branch; after one warm-up step, the launch counts are
   zeroed and five timed steps run: both flash kernels launch exactly
   steps x layers times, every loss is finite and the first lies within
   0.5 of ln(vocab). It prints tokens/s, step ms p50, peak memory and
   MFU, then two steps under torch.profiler;
6. BERT phase: bert-large at full width and depth pretrains through
   `SpmdTrainStep` on padded batches (b8 x s512, per-row lengths in
   [384, 512) as a [B, 1, 1, S] key-padding mask, MLM on 15% of the real
   positions plus NSP, dropout 0.1, bf16 params and moments). On two
   sequences at dropout 0 the bf16 model (attention in the general flash
   kernels) agrees with a float32 copy whose attention is composed; then
   one warm-up step and five timed steps in which both general flash
   kernels launch exactly steps x layers times and no other attention
   kernel runs, every loss is finite and the first MLM loss lies within
   0.5 of ln(vocab). It prints tokens/s, step ms p50, peak memory and
   MFU, then two steps under torch.profiler, with the general flash
   kernels' device time a step;
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
   tokens/s, pool bytes and pages, and a profile of full steps;
10. generation phase: gpt3-1.3b, bf16, `generate()` at the JAX
   package's decode benchmark shape (b8 x prompt 1024, dense, random
   ids from ``--seed``): (a) greedy + 128: B1's forward launches exactly
   layers times (the flash prefill) and nothing else; a float32 teacher
   agrees with every token but at a near-tie; (b) beam search, K=4,
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
   (busy share, launches a step, top kernels); (d)'s pool bytes;
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
   float32 at + 16 (identical, or parting at a log-prob gap < 1e-4);
13. attention at Gemma-2B's widths: 18 `TransformerEncoderLayer`
   (d_model 2048, 8 heads of 256, MLP 16384, GELU, dropout 0.1) train
   through `SpmdTrainStep` (AdamW, bf16 params and moments) on b4 x
   s1024 batches with a key-padding mask (lengths in [768, 1024)): the
   bf16 loss and grads against a float32 copy whose attention composes
   (phase 6's tolerances), then five timed steps in which B2's forward
   and backward (at D=256: the wgmma forward on 64-key tiles and the
   one-pass backward on 64-key blocks) launch exactly steps x layers
   times each and no other kernel runs; step ms p50, tokens/s, peak
   memory and B2's device time a step from a profile, in which no kernel
   sliced over D may appear.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device":
{...}}``. Without a visible CUDA device the script prints no result
and exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
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
            ("fp8", 5))
    timed = decode_shape_times(torch, pa, 16, 128, arms)
    records = []
    for pages, w in (("bf16", 1), ("int8", 5), ("fp8", 5)):
        name = "paged_attention" + ("" if pages == "bf16" else "_" + pages)
        records.append({"name": name, **timed[pages, w]})
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


def flash_ulps(x, ref, d):
    """``|x - ref|`` of each element in bf16 ulps (2^-8) of its scale:
    the largest of its own ``|ref|``, the rms of its row (one head's
    ``d`` values at one position, which all sum the same rounded
    products) and FLASH_SCALE_FLOOR x the tensor's rms. Returns the
    largest reading and the mean ``|ref|`` (the typical value)."""
    r = ref.float().reshape(-1, d)
    ulps = (x.float().reshape(-1, d) - r).abs() / flash_ulp(r)
    return ulps.max().item(), r.abs().mean().item()


def flash_ulp(r):
    """One bf16 ulp (2^-8) of the scale of each element of ``r`` (rows of
    one head's ``d`` values, float32): the largest of its own ``|r|``,
    its row's rms and FLASH_SCALE_FLOOR x the tensor's rms."""
    import torch

    scale = torch.maximum(r.abs(),
                          r.square().mean(dim=1, keepdim=True).sqrt())
    scale = scale.clamp(min=FLASH_SCALE_FLOOR * r.square().mean().sqrt()
                        .item())
    return scale * 2.0 ** -8


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
                   f"its scale (limit {limit}; bf16 rounding control "
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
    (d)'s fully masked row in bf16, D128, no dropout. Then the forward
    and backward at (a) and at (b) timed beside the plain versions, SDPA
    (timed only; the port never calls it) and the bound. Returns the
    forward's and backward's records at (a)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
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
    errs = {}
    for name, (shape, causal, bias, p) in cases.items():
        q, k, v, do = general_case(*shape, seed=ord(name))
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
    the repacked (pair-major) projection (`qkv3_against_qkv`). Then at
    BERT-large's shape (B8 S512 H16 D64 bf16, full, dropout 0.1):
    agreement, time beside the plain versions, SDPA on the unpacked [B,
    H, S, D] tensors with dropout 0.1 (timed only; the port never calls
    it) and the bound; and B1 at the same shape (the fused BERT's):
    against its plain versions and against B5, timed. Returns the
    forward's and the backward's records."""
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
    """B6 (rows 10-11) through its entry, ``incubate.nn.functional.
    _ln_maybe_fused``, on the card: f32 and bf16, with and without a
    residual, y, dx, d(residual), dg and db against the same entry run
    through the plain versions (TOL_F32 / TOL_LN_SUMS in float32,
    TOL_BF16_OUT in bfloat16, where both round the same float32 math to
    bf16). No layer calls the entry (nor in the reference), so its
    launches are those of these calls. Then the kernels at BERT-large's
    rows ([8*512, 1024] bf16 with a residual) beside the plain versions,
    the library's two calls ``x + r`` then ``F.layer_norm`` (timed only)
    and the bound. Returns the forward's and the backward's records."""
    import torch.nn.functional as F

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import fused_ln as fl

    eps = 1e-5
    worst = {"fwd": 0.0, "bwd": 0.0}
    launched = {"fused_ln_fwd": 0, "fused_ln_bwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
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
                    for k in launched:
                        launched[k] += after[k] - before[k]
                        check(after[k] - before[k] == 1,
                              f"_ln_maybe_fused launched {k} "
                              f"{after[k] - before[k]} times, not once")
                outs.append([y] + [t.grad for t in leaves if t is not None])
            names = ["y", "dx"] + (["dres"] if residual else []) + ["dg",
                                                                    "db"]
            parts = []
            for name, a, ref in zip(names, *outs):
                if dtype == torch.bfloat16:
                    tol = TOL_BF16_OUT
                else:
                    tol = TOL_LN_SUMS if name in ("dg", "db") else TOL_F32
                torch.testing.assert_close(a.float(), ref.float(), **tol)
                e = (a.float() - ref.float()).abs().max().item()
                key = "fwd" if name == "y" else "bwd"
                worst[key] = max(worst[key], e)
                parts.append(f"{name} {e:.3e}")
            print(f"  _ln_maybe_fused [512, 1024] {str(dtype)[6:]} "
                  f"{'with' if residual else 'without'} residual: max|diff| "
                  + ", ".join(parts) + "  ok")

    n, m, bf = BERT_B * BERT_S, 1024, torch.bfloat16
    # four copies of 17 MB of x and residual (+ dy): past the 50 MB L2
    copies = [ln_case(torch, n, m, bf, 20 + i, True) for i in range(4)]
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
        name = f"fused_ln_{key}"
        print(f"  {name} at [{n}, {m}] bf16 with residual: kernel "
              f"{ms[key]:.4f} ms, plain {plain[key]:.4f} ms, library "
              f"(x + r then F.layer_norm, two calls) {library[key]:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes} bytes, "
              f"{flops} flops)")
        records.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ln.cu",
            "replaces": f"paddle_tpu/kernels/fused_ln.py:{line_no}",
            "max_abs_err": worst[key], "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[key]})
    print(f"  library forward+backward {lib_fb:.4f} ms, forward "
          f"{lib_f:.4f} ms (its backward alone: the difference); launches "
          f"through the entry {launched} (no main path runs it)")
    return records, launched


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
    kw = dict(slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
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
    profile_decode(torch, Engine(model, **kw), prompts)
    return {"paged_attention": counts["paged_attention"]}


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

    handles = [None] * len(prompts)
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    step = 0
    while step <= max(SUBMIT_AT_STEP) or eng.stats().active_slots \
            or eng.stats().queue_depth:
        for i, at in enumerate(SUBMIT_AT_STEP):
            if at == step:
                kw = (dict(decode_strategy="sampling", temperature=1.0,
                           seed=1000 + i) if i in sampled else {})
                handles[i] = eng.submit(prompts[i], max_new_tokens=MAX_NEW,
                                        **kw)
        eng.step()
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    s = eng.stats()
    outs = [h.result() for h in handles]
    check(s.completed == len(prompts) and all(
        len(o) == MAX_NEW for o in outs), f"not every request completed: {s}")
    check(s.kv_pages_in_use == 0 and s.kv_pages_free == s.kv_pages_total,
          f"pages did not return to the pool: {s}")
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

    wall_us, busy_us, per, launches, host = profile_totals(torch, run)
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
    print(f"    host: {launches / steps:.0f} kernel launches/step; most "
          "self CPU time: " + ", ".join(
              f"{key} {t / steps / 1e3:.3f} ms" for key, t in host))
    return wall_us / steps / 1e3, busy_us / steps / 1e3


def qkv_families(label):
    """The profile's kernel families of B1 or B5 (``label``): the qkv
    forward and B2's backward with its pre- and post-pass."""
    return {f"{label} kernels (qkv forward; B2's backward, its pre- and "
            "post-pass)": QKV_KERNELS,
            "of which the backward (bwd_wg_kernel)": QKV_KERNELS[1:2],
            "and its pre- and post-pass": QKV_KERNELS[2:]}


# ---------------------------------------------------------------- training
def train_phase(torch, seed, card):
    """gpt3-1.3b at full width and depth trains through `SpmdTrainStep`
    on the card (bench.py's flagship configuration): b8 x s1024 of
    token ids from ``seed``, dropout 0, bf16 params and bf16 AdamW
    moments. First the float32-reference check, then one warm-up step
    and TRAIN_STEPS timed steps with the launch counts zeroed just
    before them, then two steps under the profiler. Returns the flash
    kernels' launch counts of the timed steps."""
    import dataclasses

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(gpt_config(MODEL), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    gc.collect()                 # what the earlier phases left in cycles
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
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
          f"{TRAIN_LR}, wd {TRAIN_WD}")
    float32_reference_check(torch, step, params, batches[0], cfg, seed)

    loss, params, opt_state = step(params, opt_state, batches[0], 0)
    first = loss.item()
    check(abs(first - math.log(cfg.vocab_size)) < 0.5,
          f"first loss {first} is not within 0.5 of ln(V) = "
          f"{math.log(cfg.vocab_size):.4f}")
    kernels.reset_kernel_launch_counts()
    times, losses = [], [first]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        ts = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, batches[i], i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(loss.item())
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * cfg.num_hidden_layers
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for name in ("flash_attention_qkv_fwd", "flash_attention_qkv_bwd"):
        check(counts[name] == want, f"{name} launched {counts[name]} times, "
              f"steps x layers = {want}")
    for name in ("paged_attention", "flash_attention_fwd",
                 "flash_attention_bwd"):
        check(counts[name] == 0, f"GPT training launched {name}: {counts}")
    tok_s = TRAIN_B * TRAIN_S * TRAIN_STEPS / wall
    flops_per_tok = (6 * cfg.num_params(include_embeddings=False)
                     + 12 * cfg.num_hidden_layers * cfg.hidden_size
                     * TRAIN_S)
    mfu = tok_s * flops_per_tok / BF16_FLOPS_PER_S
    p50 = sorted(times)[len(times) // 2] * 1e3
    print(f"  losses {[round(x, 4) for x in losses]} (first within 0.5 of "
          f"ln(V) = {math.log(cfg.vocab_size):.4f}, all finite)")
    print(f"  launches {counts}: flash fwd = bwd = steps x layers = {want}")
    print(f"  {card}: {tok_s:.1f} tokens/s, step {p50:.3f} ms p50 (steps "
          f"{[round(t * 1e3, 3) for t in times]} ms), peak memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated; "
          f"{before / 2 ** 30:.3f} GiB held before the phase), MFU {mfu:.4f} "
          f"({flops_per_tok} flops/token over 989 TFLOP/s)")
    it = iter(range(100))

    def one():
        nonlocal params, opt_state
        i = next(it) % len(batches)
        _, params, opt_state = step(params, opt_state, batches[i], 100 + i)

    profile_steps(torch, one, 2, "training steps", qkv_families("B1"))
    return {k: counts[k] for k in ("flash_attention_qkv_fwd",
                                   "flash_attention_qkv_bwd")}


def float32_reference_check(torch, step, params, batch, cfg, seed):
    """On the batch's first two sequences, the bf16 model's loss and
    grads against a float32 copy of the same weights run through the
    plain (composed) attention branch: loss within REF_LOSS_RTOL, and
    cosine similarity at least REF_GRAD_COS for the qkv_proj and fc_in
    weight grads of the first and last layer."""
    import dataclasses

    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    two = {k: v[:2] for k, v in batch.items()}
    last = cfg.num_hidden_layers - 1
    names = [f"gpt.h.{i}.{m}.weight" for i in (0, last)
             for m in ("attn.qkv_proj", "mlp.fc_in")]
    loss, grads = step.loss_and_grads(params, two, 0)
    grads = {n: grads[n].float() for n in names}
    ref = GPTForPretraining(dataclasses.replace(cfg, use_flash_attention=False),
                            dtype="float32", seed=seed)
    ref.train()
    ref_params = dict(ref.named_parameters())
    with torch.no_grad():
        for n, p in ref_params.items():
            p.copy_(params[n])
    ref_step = SpmdTrainStep(ref, gpt_loss_fn, AdamW())
    ref_loss, ref_grads = ref_step.loss_and_grads(ref_params, two, 0)
    ref_grads = {n: ref_grads[n] for n in names}
    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    cos = {n: torch.nn.functional.cosine_similarity(
        grads[n].flatten(), ref_grads[n].flatten(), dim=0).item()
        for n in names}
    del ref, ref_params, ref_step, ref_grads, grads
    torch.cuda.empty_cache()
    check(rel <= REF_LOSS_RTOL, f"bf16 loss {loss.item()} vs float32 "
          f"{ref_loss.item()}: relative difference {rel}")
    check(min(cos.values()) >= REF_GRAD_COS, f"grad cosine {cos}")
    print(f"  float32 reference (plain attention, 2 sequences): loss "
          f"{loss.item():.5f} vs {ref_loss.item():.5f} (rel {rel:.2e} <= "
          f"{REF_LOSS_RTOL}); grad cosine "
          + ", ".join(f"{n[6:-7]} {c:.5f}" for n, c in cos.items())
          + f" (>= {REF_GRAD_COS})  ok")


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


def bert_loss_fn(model, state, batch, parts=None):
    """MLM cross-entropy (ignore_index -100) plus NSP cross-entropy of
    `BertForPretraining` run with ``state`` (and the batch's
    attention_mask, when it has one); each part is appended to ``parts``
    when given."""
    from torch.func import functional_call

    from paddle_tpu_torch.nn.functional import cross_entropy

    logits, nsp = functional_call(
        model, state, (batch["input_ids"],),
        {"attention_mask": batch.get("attention_mask")})
    mlm = cross_entropy(logits, batch["mlm_labels"], ignore_index=-100)
    nsp_loss = cross_entropy(nsp, batch["nsp_labels"])
    if parts is not None:
        parts.append((mlm.detach(), nsp_loss.detach()))
    return mlm + nsp_loss


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
    dropout 0, then one warm-up step and TRAIN_STEPS timed steps with the
    launch counts zeroed just before them, then two steps under the
    profiler. Returns the variant's kernels' launch counts of the timed
    steps."""
    import functools

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.models.bert import bert_config
    from paddle_tpu_torch.optimizer import AdamW

    v = BERT_VARIANTS[variant]
    cfg = bert_config(BERT_MODEL)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = bert_model(cfg, variant, "bfloat16", seed)
    parts = []
    step = SpmdTrainStep(model, functools.partial(bert_loss_fn, parts=parts),
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
          f"{TRAIN_LR}, wd {TRAIN_WD}")
    bert_reference_check(torch, step, params, batches[0], cfg, seed,
                         variant)

    model.train()
    parts.clear()
    loss, params, opt_state = step(params, opt_state, batches[0], 0)
    first_mlm = parts[0][0].item()
    check(abs(first_mlm - math.log(cfg.vocab_size)) < 0.5,
          f"first MLM loss {first_mlm} is not within 0.5 of ln(V) = "
          f"{math.log(cfg.vocab_size):.4f}")
    kernels.reset_kernel_launch_counts()
    times, losses = [], [loss.item()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        ts = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, batches[i], i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(loss.item())
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * cfg.num_hidden_layers
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for name in v["kernels"]:
        check(counts[name] == want, f"{name} launched {counts[name]} times, "
              f"steps x layers = {want}")
    for name, n in counts.items():
        check(name in v["kernels"] or n == 0,
              f"BERT ({variant}) launched {name}: {counts}")
    tok_s = BERT_B * BERT_S * TRAIN_STEPS / wall
    flops_per_tok = (6 * cfg.num_params(include_embeddings=False)
                     + 12 * cfg.num_hidden_layers * cfg.hidden_size * BERT_S)
    mfu = tok_s * flops_per_tok / BF16_FLOPS_PER_S
    p50 = sorted(times)[len(times) // 2] * 1e3
    print(f"  losses {[round(x, 4) for x in losses]} (MLM + NSP; first MLM "
          f"{first_mlm:.4f} within 0.5 of ln(V) = "
          f"{math.log(cfg.vocab_size):.4f}, all finite)")
    print(f"  launches {counts}: {v['label']} fwd = bwd = steps x layers = "
          f"{want}, every other kernel 0")
    print(f"  {card}: {tok_s:.1f} tokens/s"
          f"{' (padding included)' if v['masked'] else ''}, step "
          f"{p50:.3f} ms p50 (steps {[round(t * 1e3, 3) for t in times]} ms),"
          f" peak memory {peak / 2 ** 30:.3f} GiB (max_memory_allocated; "
          f"{before / 2 ** 30:.3f} GiB held before the phase), MFU {mfu:.4f} "
          f"({flops_per_tok} flops/token over 989 TFLOP/s)")
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
                  families)
    return {k: counts[k] for k in v["kernels"]}


def bert_grads_held(cfg, variant):
    """``(held, shown)``: the weight grads the float32 check holds, as
    (label, name, index into the parameter's first dim or None), and the
    one it prints. Unfused: layer 0's q_proj, v_proj and linear1 of
    layers 0 and 23; shown: layer 23's q_proj. Fused: the q and v slices
    of layer 0's qkv_weight, the v slice and ffn.linear1_weight of layer
    23; shown: layer 23's q slice."""
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


def bert_reference_check(torch, step, params, batch, cfg, seed, variant):
    """On the batch's first two sequences at dropout 0 (eval mode), the
    bf16 model's loss and grads (attention in the variant's kernels)
    against a float32 copy of the same weights whose attention runs the
    composition (``use_flash=False``): loss within REF_LOSS_RTOL; cosine
    at least REF_GRAD_COS for the grads `bert_grads_held` names.

    Layer 23's q grad is printed, not held: it passes only through
    ``ds = p*(dp - delta)``, and at random init the deep layers' values
    share a large common part, so ``dp - delta`` cancels and amplifies
    the bf16 rounding of O inside the reference's ``delta =
    rowsum(dO*O)``. Beside the kernels' reading stands a control, the
    same bf16 model through the plain versions (the reference's own
    rounding points)."""
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    two = {k: v[:2] for k, v in batch.items()}
    held, shown = bert_grads_held(cfg, variant)

    def pick(grads, entry):
        g = grads[entry[1]]
        return (g if entry[2] is None else g[entry[2]]).float()

    step.model.eval()
    loss, grads = step.loss_and_grads(params, two, 0)
    got = {e[0]: pick(grads, e) for e in held + [shown]}
    del grads
    with plain_kernels(torch):
        ctrl = pick(step.loss_and_grads(params, two, 0)[1], shown)
    ref = bert_model(cfg, variant, "float32", seed)
    for layer in ref.bert.encoder_layers:
        attn = layer.fused_attn if BERT_VARIANTS[variant]["fuse"] \
            else layer.self_attn
        attn.use_flash = False
    ref_params = dict(ref.named_parameters())
    with torch.no_grad():
        for n, p in ref_params.items():
            p.copy_(params[n])
    ref_step = SpmdTrainStep(ref, bert_loss_fn, AdamW())
    ref_loss, ref_grads = ref_step.loss_and_grads(ref_params, two, 0)
    want = {e[0]: pick(ref_grads, e) for e in held + [shown]}

    def cosine(a, label):
        return torch.nn.functional.cosine_similarity(
            a.flatten(), want[label].flatten(), dim=0).item()

    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    cos = {e[0]: cosine(got[e[0]], e[0]) for e in held}
    shown_cos, ctrl_cos = cosine(got[shown[0]], shown[0]), cosine(ctrl,
                                                                 shown[0])
    del ref, ref_params, ref_step, ref_grads, got, want, ctrl
    torch.cuda.empty_cache()
    check(rel <= REF_LOSS_RTOL, f"bf16 loss {loss.item()} vs float32 "
          f"{ref_loss.item()}: relative difference {rel}")
    check(min(cos.values()) >= REF_GRAD_COS, f"grad cosine {cos}")
    print(f"  float32 reference (composed attention, 2 sequences, dropout "
          f"0): loss {loss.item():.5f} vs {ref_loss.item():.5f} (rel "
          f"{rel:.2e} <= {REF_LOSS_RTOL}); grad cosine "
          + ", ".join(f"{k} {c:.5f}" for k, c in cos.items())
          + f" (>= {REF_GRAD_COS})  ok; {shown[0]} {shown_cos:.5f} "
          f"(not held; the plain versions' control {ctrl_cos:.5f})")


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


def timed_generate(torch, model, ids, **kw):
    """One `generate` call after a short warm-up at the same shapes
    (cuBLAS handles, allocator): launch counts zeroed just before the
    timed call and read just after. Returns ``(out, wall s, counts)``."""
    from paddle_tpu_torch import kernels

    model.generate(ids, **{**kw, "max_new_tokens": 3})
    torch.cuda.synchronize()
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    return out, wall, counts


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


def profile_totals(torch, fn):
    """``fn()`` under torch.profiler: ``(wall us, device busy us, {kernel:
    device us}, kernel launches, [(host op, self CPU us)] of the four
    host ops with the most self CPU time)``."""
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
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total
        else:
            host.append(e)
    launches = sum(e.count for e in host
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:4]
    return (wall_us, sum(per.values()), per, launches,
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

    def prefill():
        with torch.inference_mode():
            model.prefill(ids, model.gen_static_cache(b, s))

    run(steps + 1)                                        # warm-up
    p_wall, p_busy, p_per, p_launch, _ = profile_totals(torch, prefill)
    g_wall, g_busy, g_per, g_launch, _ = profile_totals(
        torch, lambda: run(steps + 1))
    wall, busy = (g_wall - p_wall) / steps, (g_busy - p_busy) / steps
    print(f"  profile of {what}, {steps} decode steps (a generation of "
          f"{steps + 1} tokens less a prompt pass): wall {wall / 1e3:.3f} "
          f"ms/step, device busy {busy / 1e3:.3f} ms/step "
          f"({100 * busy / wall:.1f}% of the profiled wall, "
          f"{100 * busy / 1e3 / step_ms:.1f}% of the timed step's "
          f"{step_ms:.3f} ms), {(g_launch - p_launch) / steps:.0f} kernel "
          "launches/step")
    per = {k: (v - p_per.get(k, 0.0)) / steps for k, v in g_per.items()}
    for key, t in sorted(per.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {t / 1e3:8.4f} ms/step {100 * t / busy:5.1f}%  {key[:90]}")
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
    with every token but at a near-tie. (b) beam 4, paged, 128 new, no
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

    def int8_tail(new):
        with torch.inference_mode():
            return model._build_beam_fn(GEN_B, GEN_PROMPT, new, GEN_BEAMS,
                                        None, None, 0.0, kv_quant="int8")(ids)

    int8_tail(GEN_SHORT)                   # warm-up at the same shapes
    torch.cuda.synchronize()
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    out = int8_tail(GEN_SHORT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
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
    t_dq = time.perf_counter()
    with model.dequantized(quant):
        torch.cuda.synchronize()
        dq_ms = (time.perf_counter() - t_dq) * 1e3
        state = {n: p.detach().clone()
                 for n, p in model.state_dict().items()}
    print(f"  (e) greedy, weight-only int8, b{GEN_B} x {GEN_PROMPT} + "
          f"{GEN_SHORT}: stored weights {stored} bytes (bf16 {full}); "
          f"{wall:.3f} s, decode {(wall * 1e3 - pf_ms) / (GEN_SHORT - 1):.3f}"
          f" ms/token with the dequantization once a call ({dq_ms:.3f} ms); "
          f"greedy bf16 agrees on "
          f"{sum(torch.equal(out[r], greedy[r, :GEN_SHORT]) for r in range(GEN_B))}"
          f" of {GEN_B} rows")
    teacher_check(torch, model, plist, out.tolist(), state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
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
    kw = dict(slots=SLOTS, page_size=PAGE, max_len=MAX_LEN,
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
    attention is composed (phase 6's tolerances); then one warm-up step and
    TRAIN_STEPS timed steps with the launch counts zeroed just before
    them: B2's forward and backward launch exactly steps x layers times
    each, no other kernel, every loss finite. Prints step ms p50,
    tokens/s, peak memory and B2's device ms a step from a profile, in
    which no kernel sliced over D may run.
    Returns B2's launch counts under the names of its D=256 records."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
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
    gemma_reference_check(torch, step, params, batches[0], seed)

    model.train()
    loss, params, opt_state = step(params, opt_state, batches[0], 0)
    kernels.reset_kernel_launch_counts()
    times, losses = [], [loss.item()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        ts = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, batches[i], i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(loss.item())
    wall = time.perf_counter() - t0
    counts = kernels.kernel_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * GEMMA_LAYERS
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    only_launched(counts, {"flash_attention_fwd": want,
                           "flash_attention_bwd": want},
                  "Gemma-2B widths training")
    p50 = sorted(times)[len(times) // 2] * 1e3
    print(f"  losses {[round(x, 5) for x in losses]} (all finite); launches "
          f"{counts}: B2 fwd = bwd = steps x layers = {want}")
    print(f"  {card}: {GEMMA_B * GEMMA_S * TRAIN_STEPS / wall:.1f} tokens/s "
          f"(padding included), step {p50:.3f} ms p50 (steps "
          f"{[round(t * 1e3, 3) for t in times]} ms), peak memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated)")
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
        "and its pre- and post-pass": B2_D256_KERNELS[2:]},
        absent=SLICED_TC_KERNELS)
    print(f"    no kernel sliced over D (names holding {SLICED_TC_KERNELS}) "
          "ran  ok")
    del model, step, params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_d256": counts["flash_attention_fwd"],
            "flash_attention_bwd_d256": counts["flash_attention_bwd"]}


def gemma_reference_check(torch, step, params, batch, seed):
    """On the batch's first two sequences at dropout 0 (eval mode), the
    bf16 stack's loss and grads (attention in B2's kernels at D=256)
    against a float32 copy of the same weights whose attention composes
    (``use_flash=False``): loss within REF_LOSS_RTOL, cosine at least
    REF_GRAD_COS for layer 0's and the last layer's q_proj, v_proj and
    linear1 weight grads."""
    from paddle_tpu_torch.distributed import SpmdTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    two = {k: v[:2] for k, v in batch.items()}
    last = GEMMA_LAYERS - 1
    held = [f"layers.{i}.{m}.weight" for i, m in [(0, "self_attn.q_proj")]
            + [(i, m) for i in (0, last)
               for m in ("self_attn.v_proj", "linear1")]]
    shown = f"layers.{last}.self_attn.q_proj.weight"
    step.model.eval()
    loss, grads = step.loss_and_grads(params, two, 0)
    got = {n: grads[n].float() for n in held + [shown]}
    del grads
    with plain_kernels(torch):
        ctrl = step.loss_and_grads(params, two, 0)[1][shown].float()
    ref = gemma_stack(torch, torch.float32, seed)
    for layer in ref.layers:
        layer.self_attn.use_flash = False
    ref.eval()
    ref_params = dict(ref.named_parameters())
    with torch.no_grad():
        for n, p in ref_params.items():
            p.copy_(params[n])
    ref_step = SpmdTrainStep(ref, gemma_loss_fn, AdamW())
    ref_loss, ref_grads = ref_step.loss_and_grads(
        ref_params, {**two, "x": two["x"].float()}, 0)
    cos = {n.split(".", 1)[1]: torch.nn.functional.cosine_similarity(
        got[n].flatten(), ref_grads[n].float().flatten(), dim=0).item()
        for n in held + [shown]}
    shown_cos = cos.pop(shown.split(".", 1)[1])
    ctrl_cos = torch.nn.functional.cosine_similarity(
        ctrl.flatten(), ref_grads[shown].float().flatten(), dim=0).item()
    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    del ref, ref_params, ref_step, ref_grads, got, ctrl
    gc.collect()
    torch.cuda.empty_cache()
    check(rel <= REF_LOSS_RTOL, f"bf16 loss {loss.item()} vs float32 "
          f"{ref_loss.item()}: relative difference {rel}")
    check(min(cos.values()) >= REF_GRAD_COS, f"grad cosine {cos}")
    print(f"  float32 reference (composed attention, 2 sequences, dropout "
          f"0): loss {loss.item():.6f} vs {ref_loss.item():.6f} (rel "
          f"{rel:.2e} <= {REF_LOSS_RTOL}); grad cosine "
          + ", ".join(f"{k} {c:.5f}" for k, c in cos.items())
          + f" (>= {REF_GRAD_COS})  ok; {shown.split('.', 1)[1]} "
          f"{shown_cos:.5f} (not held; the plain versions' control "
          f"{ctrl_cos:.5f})")


def print_build_report(name, report):
    """One source's build seconds, then for each kernel ptxas's register,
    shared-memory and spill lines, joined on one line."""
    lines = report.splitlines()
    print(f"  {name}.cu: {lines[0] if lines else 'not built here'}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    card = nvidia_smi_line()
    print(f"[1] card: {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("    TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t = time.perf_counter()
    _build.build_all()
    print(f"[2] built {_build.sources()} for sm_90a in "
          f"{time.perf_counter() - t:.1f} s (one nvcc a source, in "
          "parallel)")
    for name in _build.sources():
        print_build_report(name, _build.build_report(name))

    print("[3] kernel phase")
    records = [*kernel_phase(torch, pa), tail_kernel_phase(torch, pa),
               *paged_head_dim_checks(torch, pa),
               *flash_kernel_phase(torch), *general_flash_phase(torch),
               *wide_flash_phase(torch), *qkv3_kernel_phase(torch)]
    ln_records, launches = fused_ln_phase(torch)
    records += ln_records
    print("[4] engine phase")
    launches.update(engine_phase(torch, args.seed))
    print("[5] training phase")
    launches.update(train_phase(torch, args.seed, card))
    print("[6] BERT phase (masked, B2)")
    launches.update(bert_phase(torch, args.seed, card, "masked"))
    print("[7] BERT unmasked phase, unfused layers (B5)")
    launches.update(bert_phase(torch, args.seed, card, "unfused"))
    print("[8] BERT unmasked phase, fused layers (B1)")
    fused = bert_phase(torch, args.seed, card, "fused")
    print(f"  (B1's launches in the kernel line are GPT training's; the "
          f"fused BERT's were {fused})")
    print("[9] quantized speculative serving phase (int8/fp8 pages, k=4)")
    launches.update(spec_phase(torch, args.seed))
    print("[10] generation phase (greedy, beam paged/gather, int8 tail "
          "pages, weight-only int8)")
    launches.update(gen_phase(torch, args.seed))
    print("[11] sequence-parallel phase (B4, the ring's per-rank loop, one "
          "rank)")
    records += b4_kernel_phase(torch)
    launches.update(ring_loop_phase(torch))
    one_rank_phase(torch)
    print("[12] gpt3-2.7b serving phase (head dim 80: Engine on bf16 and "
          "int8 pages, the paged beam)")
    launches.update(serve_27b_phase(torch, args.seed))
    print("[13] attention at Gemma-2B's widths (B2 at head dim 256, "
          "training)")
    launches.update(gemma_phase(torch, args.seed, card))
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
