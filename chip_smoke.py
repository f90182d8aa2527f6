#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, torch and CUDA versions; TF32 off
   for float32 matmuls and convolutions;
2. build every CUDA kernel of the port from ``paddle_tpu_torch/kernels/
   csrc`` (one nvcc per source, in parallel);
3. kernel phase: each kernel against its plain PyTorch version on the
   card, at the stated tolerances; then its time at the serving decode
   shape beside the plain version's, a PyTorch library call computing
   the same function (timed here only; the port never calls it) and the
   least time the card could take (its bound);
4. engine phase: gpt3-1.3b at full width and depth, bf16, random
   weights from ``--seed``, served by
   the paged `Engine` (8 slots, page 16, max_len 640, buckets 128/512)
   under staggered traffic. Launch counts are zeroed just before the run
   and read just after: every kernel of the path must have launched
   (paged attention exactly decode_steps x layers times). Every request
   completes, every page returns to the pool, and a teacher-forced
   full-sequence forward with plain attention, of a float32 copy of the
   weights, agrees with each emitted token unless its logit is within
   0.05 of the reference's top one. Then a few full decode steps run
   under torch.profiler: the device's busy share and the top kernels.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device":
{...}}``. Without a visible CUDA device the script prints no result
and exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# kernel-phase tolerances: f32 differs only by summation order; bf16
# outputs are rounded to bf16 (lse stays f32 in both versions)
TOL_F32 = dict(atol=1e-4, rtol=0.0)
TOL_BF16_OUT = dict(atol=2e-2, rtol=2e-2)
TOL_BF16_LSE = dict(atol=1e-3, rtol=0.0)
# at the engine's decode shape |out| is about 0.07 (a softmax over ~500
# random scores), so bf16 out is held to a few bf16 ulps there, and the
# same inputs in float32 to TOL_F32
TOL_BF16_OUT_DECODE = dict(atol=2e-3, rtol=0.0)
TEACHER_GAP = 0.05               # bf16 near-ties the teacher check allows

# engine phase: the serving configuration and its traffic
MODEL = "gpt3-1.3b"
SLOTS, PAGE, MAX_LEN, BUCKETS, MAX_NEW = 8, 16, 640, (128, 512), 32
PROMPT_LENS = (20, 75, 130, 190, 250, 310, 370, 430, 480, 500)
SUBMIT_AT_STEP = (0, 0, 0, 0, 2, 2, 2, 5, 5, 5)


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
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
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


def paged_work(bt, steps, vc, w, h, d, el):
    """Bytes and flops one paged-attention call needs on this data. A
    row needs the pages that hold a readable column (``valid_cols != 0``
    and at most ``steps + w - 1``); a page of left padding alone cannot
    change the row's result and is not counted (a row with no readable
    column needs every page up to its cursor). Bytes: those pages' K and
    V once, their block-table entries, the valid_cols up to the cursor,
    steps, q, out and lse. Flops: q.k and p.v over the pages' columns."""
    ps = PAGE
    n = bt.shape[0]
    pages = cols_read = 0
    for s, v in zip(steps.tolist(), vc.cpu()):
        last = min(s + w - 1, v.shape[0] - 1)
        live = v[:last + 1].nonzero().flatten()
        if live.numel():
            pages += len(set((live // ps).tolist()))
        else:
            pages += last // ps + 1
        cols_read += last + 1
    nbytes = (pages * ps * h * d * 2 * el      # K and V pages
              + 2 * n * h * w * d * el         # q in, out
              + n * h * w * 4                  # lse
              + pages * 4 + n * 4 + cols_read * 4)
    flops = 4 * w * h * d * pages * ps
    return nbytes, flops


def kernel_phase(torch, pa):
    """Kernel against plain version on the card, then timing at the
    engine's decode shape. Returns the paged-attention record."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.paged_kv import gather_pages

    worst = {}
    for d in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for w in (1, 4):
                args = paged_case(6, 8, w, d, PAGE, 8, dtype,
                                  seed=100 + d + w)
                out, lse = pa.fused_paged_attention(*args)
                ref_out, ref_lse = pa.paged_attention_reference(*args)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    tol_o, tol_l = TOL_F32, TOL_F32
                else:
                    tol_o, tol_l = TOL_BF16_OUT, TOL_BF16_LSE
                torch.testing.assert_close(out.float(), ref_out.float(),
                                           **tol_o)
                torch.testing.assert_close(lse, ref_lse, **tol_l)
                err_o = (out.float() - ref_out.float()).abs().max().item()
                err_l = (lse - ref_lse).abs().max().item()
                name = f"D={d} {str(dtype)[6:]} W={w}"
                worst[name] = (err_o, err_l)
                print(f"  paged_attention {name}: max|out-ref| {err_o:.3e}"
                      f"  max|lse-ref| {err_l:.3e}  ok")

    # the engine's decode shape: 8 slots x 16 heads, W=1, D=128, bf16,
    # 40 pages of 16 per slot (max_len 640), each slot 16 tokens into
    # decode after a prompt from PROMPT_LENS in its bucket
    n, h, d, pmax = SLOTS, 16, 128, MAX_LEN // PAGE
    buckets = [min(b for b in BUCKETS if b >= p) for p in PROMPT_LENS[:n]]
    steps = [b + 16 for b in buckets]
    pads = [b - p for b, p in zip(buckets, PROMPT_LENS[:n])]
    copies = [paged_case(n, h, 1, d, PAGE, pmax, torch.bfloat16,
                         seed=i, steps=steps, pads=pads)
              for i in range(4)]          # 4 x 42 MB of pools > the L2
    args = copies[0]
    out, _ = pa.fused_paged_attention(*args)
    ref, _ = pa.paged_attention_reference(*args)
    # the same inputs before their rounding to bf16, in float32
    args32 = paged_case(n, h, 1, d, PAGE, pmax, torch.float32, seed=0,
                        steps=steps, pads=pads)
    out32, lse32 = pa.fused_paged_attention(*args32)
    ref32, ref_lse32 = pa.paged_attention_reference(*args32)
    torch.cuda.synchronize()
    max_err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL_BF16_OUT_DECODE)
    torch.testing.assert_close(out32, ref32, **TOL_F32)
    torch.testing.assert_close(lse32, ref_lse32, **TOL_F32)
    err32 = max((out32 - ref32).abs().max().item(),
                (lse32 - ref_lse32).abs().max().item())
    print(f"  decode shape: bf16 max|out-ref| {max_err:.3e} (atol "
          f"{TOL_BF16_OUT_DECODE['atol']}), float32 max|out/lse-ref| "
          f"{err32:.3e} (atol {TOL_F32['atol']})  ok")

    it = iter(range(10 ** 9))

    def kernel():
        pa.fused_paged_attention(*copies[next(it) % 4])

    ms = time_ms(kernel, 200)
    plain_ms = time_ms(lambda: pa.paged_attention_reference(*args), 20)
    lp = pmax * PAGE
    dense = []
    for q, pk, pv, bt, st, vc in copies:
        mask = ((torch.arange(lp, device="cuda")[None, :]
                 <= st.long()[:, None]) & (vc != 0))[:, None, None, :]
        dense.append((q, gather_pages(pk, bt), gather_pages(pv, bt), mask))

    def library():
        q, k, v, m = dense[next(it) % 4]
        F.scaled_dot_product_attention(q, k, v, attn_mask=m)

    library_ms = time_ms(library, 200)
    nbytes, flops = paged_work(*args[3:], w=1, h=h, d=d, el=2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  decode shape N={n} H={h} W=1 D={d} ps={PAGE} Pmax={pmax} "
          f"bf16, steps {steps}, pads {pads}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA over the gathered view {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({nbytes} bytes, {flops} flops)")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:120",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# ---------------------------------------------------------------- engine
def engine_phase(torch, seed):
    from paddle_tpu_torch import kernels
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

    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (p,), generator=g).tolist()
               for p in PROMPT_LENS]
    eng = Engine(model, **kw)
    handles = [None] * len(prompts)
    kernels.reset_kernel_launch_counts()
    t0 = time.perf_counter()
    step = 0
    while step <= max(SUBMIT_AT_STEP) or eng.stats().active_slots \
            or eng.stats().queue_depth:
        for i, at in enumerate(SUBMIT_AT_STEP):
            if at == step:
                handles[i] = eng.submit(prompts[i], max_new_tokens=MAX_NEW)
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
    want = s.decode_steps * cfg.num_hidden_layers
    check(counts["paged_attention"] == want,
          f"paged_attention launched {counts['paged_attention']} times, "
          f"decode_steps x layers = {want}")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} never launched on the main path")
    print(f"  served {len(prompts)} requests (prompts {PROMPT_LENS}, "
          f"max_new {MAX_NEW}) in {wall:.3f} s: {s.prefill_steps} prefills,"
          f" {s.decode_steps} decode steps, {s.tokens_generated} tokens")
    print(f"  launches {counts} = decode_steps x layers")

    print(f"  TTFT p50 {s.ttft_p50 * 1e3:.3f} ms, decode "
          f"{s.decode_step_p50 * 1e3:.3f} ms/step (p50), "
          f"{s.tokens_generated / wall:.1f} tokens/s")
    teacher_check(torch, model, prompts, outs)
    profile_decode(torch, Engine(model, **kw), prompts)
    return counts


def teacher_check(torch, model, prompts, outs):
    """One full-sequence forward per request, with plain attention, of a
    float32 copy of the served weights on prompt + output: at every
    generated position the emitted token must be the reference's argmax,
    or trail its top logit by less than TEACHER_GAP (a bf16 near-tie)."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining

    ref = GPTForPretraining(model.config, dtype="float32")
    ref.load_state_dict(model.state_dict())          # casts bf16 -> f32
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
    check(worst < TEACHER_GAP,
          f"an emitted token trails the reference's top logit by {worst}")
    print(f"  teacher-forced check ok (float32 reference): {near} of "
          f"{sum(map(len, outs))} tokens differ from its argmax, all within "
          f"{worst:.4f} < {TEACHER_GAP} of its top logit")


def profile_decode(torch, eng, prompts, steps=8):
    """Where a decode step's time goes: ``steps`` steps of a full engine
    (every slot active) under torch.profiler; prints the device's busy
    share of the wall time and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:SLOTS]:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                            # admits every slot, one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.self_device_time_total, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _ in kernels)
    print(f"  profile of {steps} full decode steps: wall "
          f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
          f"{busy_us / steps / 1e3:.3f} ms/step "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for t, key in sorted(kernels, reverse=True)[:6]:
        share = 100 * t / busy_us if busy_us else 0.0
        print(f"    {t / steps / 1e3:8.4f} ms/step {share:5.1f}%  {key[:90]}")


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
          f"{time.perf_counter() - t:.1f} s")

    print("[3] kernel phase")
    record = kernel_phase(torch, pa)

    print("[4] engine phase")
    counts = engine_phase(torch, args.seed)
    record["launches"] = counts[record["name"]]

    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
