"""Training phases 5-8 and 13 of `chip_smoke.py` and the optimizer's
update alone, on one CUDA GPU, for holding two trees against each other
on one card.

    python3 train_compare.py

Run from the root of a tree (this one, or another commit's unpacked
copy with this file beside its `chip_smoke.py`): it builds the flash
kernels, profiles `AdamW.apply_gradients` twice over gpt3-1.3b's
parameters (bf16 params, random grads and bf16 moments from seed 0:
device busy, wall, kernels and host launch calls of one update), then
runs the tree's own `chip_smoke` training phases (GPT, the three BERT
runs, Gemma-2B's widths) with their gates and prints. Without a CUDA
device it raises.

    python3 train_compare.py --gate-reps N [--phase 5|13]

runs the tree's own training phase 5 (gpt3-1.3b) or 13 (Gemma-2B's
widths) with its replay-against-eager gate run N times in place of once,
printing each outcome and the count that failed: how often the gate
fails on one tree. Where the tree's `chip_smoke` has the per-tensor gate
(`train_graph_gate`), each rep prints the worst param and the worst slot
against their bounds, the outcome with the spread of 2 eager runs beside
the tree's count, and its two controls (the replays with one update
skipped, and at twice the learning rate), which must fail the gate; an
older tree runs its own `train_graph_check`.

    python3 train_compare.py --eager-steps N

times N eager steps, after 3 warm-up steps, of phase 24's
`nn.Transformer()` (the tree's `chip_smoke.layer_base_model`, cast to
bfloat16, b32 x (256 + 128), `AdamW(multi_precision=True)` with a
global-norm clip; `loss.backward(); opt.step(); opt.clear_grad()`) and
prints their median and quartiles: a host-bound eager step, for holding
two trees' Python paths against each other (run the trees in
alternation, one process each).

    python3 train_compare.py --serve-runs N

serves phase 4's traffic (`chip_smoke.serve_traffic`: gpt3-1.3b bf16 on
the paged Engine, 8 slots, pages of 16, 10 requests of 20-500 tokens +
32) N times with the trace span buffer on (the default) and N times
with it off, alternating, a fresh engine each, and prints each run's
decode ms/step p50 and the medians: the serving step's host work, for
holding two trees against each other the same way. Then, with the
buffer off, it splits the decode step of a full engine (every slot
active, SPLIT_STEPS steps): the host time from the step's entry to the
graph's launch, the graph's device time (CUDA events around the
replay), the rest of the step after the launch, and the whole
``step()`` call, p50 each; and profiles 8 full decode steps
(`chip_smoke.profile_decode`: wall, device busy, the top kernels).
"""
import argparse
import os
import statistics
import sys
import time

import torch


def gate_reps(cs, reps, phase, card):
    """The replay-against-eager gate ``reps`` times on one run of phase
    5 (GPT) or 13 (Gemma-2B's widths): the tree's phase runs with its
    ``train_graph_check`` replaced by the reps."""
    counts = {"failed": 0, "failed_2": 0, "caught": 0, "caught_lr": 0}
    per_tensor = hasattr(cs, "train_graph_gate")
    check = cs.train_graph_check

    def reps_instead(torch, step, params, opt_state, batches, run, label,
                     memory_gate=False):
        for i in range(reps):
            if not per_tensor:
                try:
                    check(torch, step, params, opt_state, batches, run,
                          label, memory_gate=memory_gate)
                except RuntimeError as e:
                    counts["failed"] += 1
                    print(f"  rep {i}: FAILED {e}", flush=True)
                continue
            r = cs.train_graph_gate(torch, step, params, opt_state, batches,
                                    run)
            first = (torch.equal(r["g_loss"], r["e_loss"]) and (
                not memory_gate or run["peak"] / r["eager_peak"]
                <= cs.GRAPH_MEMORY_RATIO))
            bound_2 = cs.state_bound(r["spreads"][0], r["floor"])
            worst_2 = max(r["worst_of"](idx, r["gaps"], bound_2)[3]
                          for idx in (r["params"], r["slots"]))
            ok = first and max(r["worst"][3], r["worst_slot"][3]) <= 1.0
            ok_2 = first and worst_2 <= 1.0
            counts["failed"] += not ok
            counts["failed_2"] += not ok_2
            counts["caught"] += r["control"][3] > 1.0
            counts["caught_lr"] += r["control_lr"][3] > 1.0

            def reading(key):
                name, gap, bound, ratio = r[key]
                return f"{name} {gap:.3e} of {bound:.3e} ({ratio:.3f})"

            print(f"  rep {i}: gate {'ok' if ok else 'FAILED'} "
                  f"({cs.GRAPH_EAGER_RUNS} eager runs), "
                  f"{'ok' if ok_2 else 'FAILED'} (2 eager runs, worst "
                  f"{worst_2:.3f}): worst param {reading('worst')}, worst "
                  f"slot {reading('worst_slot')}; control, the second "
                  f"update skipped: {reading('control')}; control, twice "
                  f"the learning rate: {reading('control_lr')}", flush=True)

    cs.train_graph_check = reps_instead
    if phase == 5:
        cs.train_phase(torch, 0, card)
    else:
        cs.gemma_phase(torch, 0, card)
    print(f"gate reps, phase {phase}: {counts['failed']} of {reps} failed"
          + (f" ({counts['failed_2']} with 2 eager runs); controls caught "
             f"{counts['caught']} (update skipped) and {counts['caught_lr']}"
             f" (twice the learning rate) of {reps}" if per_tensor else
             " (the tree's own gate, no control)"), flush=True)


def eager_steps(cs, steps):
    """`--eager-steps`: phase 24's eager Transformer step, timed."""
    from paddle_tpu_torch.core.random import rng_guard, step_generator
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    with rng_guard(step_generator(0, "cuda")):
        model = cs.layer_base_model()
    model.astype("bfloat16")
    model.train()
    mask = model.generate_square_subsequent_mask(cs.TR_TGT)
    g = torch.Generator(device="cuda").manual_seed(24)
    src, tgt, target = (torch.randn((cs.TR_B, s, cs.TR_D), generator=g,
                                    device="cuda")
                        for s in (cs.TR_SRC, cs.TR_TGT, cs.TR_TGT))
    src, tgt = src.to(torch.bfloat16), tgt.to(torch.bfloat16)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    times = []
    for _ in range(steps + 3):
        t0 = time.perf_counter()
        out = model(src, tgt, tgt_mask=mask)
        (out.float() - target).square().mean().backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t = sorted(times[3:])
    q = statistics.quantiles(t, n=4)
    print(f"eager Transformer step (phase 24's model), {steps} steps: p50 "
          f"{statistics.median(t):.3f} ms, quartiles {q[0]:.3f} / "
          f"{q[2]:.3f} ms, min {t[0]:.3f} ms", flush=True)


def serve_runs(cs, runs):
    """`--serve-runs`: phase 4's traffic, the span buffer on and off."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.serving import Engine

    _build.build_all([n for n in _build.sources()
                      if n.startswith("paged_attention")])
    cfg = gpt_config(cs.MODEL)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=0)
    kw = dict(kv_mode="paged", slots=cs.SLOTS, page_size=cs.PAGE,
              max_len=cs.MAX_LEN, prefill_buckets=cs.BUCKETS)
    Engine(model, **kw).submit(list(range(1, 30)), max_new_tokens=2).result()
    prompts = cs.phase_prompts(torch, cfg, 0)
    res = {"buffer on": [], "buffer off": []}
    try:
        for _ in range(runs):
            for mode in res:
                tracing.set_buffer_enabled(mode == "buffer on")
                _, s, _, _ = cs.serve_traffic(torch, Engine(model, **kw),
                                              prompts)
                res[mode].append(s.decode_step_p50 * 1e3)
    finally:
        tracing.set_buffer_enabled(True)
    for mode, ms in res.items():
        print(f"phase 4's traffic, span {mode}: decode ms/step p50 of "
              f"{runs} runs {[round(m, 3) for m in ms]}, median "
              f"{statistics.median(ms):.3f}", flush=True)
    tracing.set_buffer_enabled(False)
    try:
        decode_split(cs, Engine(model, **kw), prompts)
        cs.profile_decode(torch, Engine(model, **kw), prompts)
    finally:
        tracing.set_buffer_enabled(True)


#: decode steps of a full engine that `decode_split` times
SPLIT_STEPS = 24


def decode_split(cs, eng, prompts):
    """A full engine's decode step in parts (see the module docstring):
    the engine's own `_decode_once` and its step's graph are wrapped on
    this engine alone, the same way in any tree."""
    for p in prompts[:cs.SLOTS]:
        eng.submit(p, max_new_tokens=cs.MAX_NEW)
    eng.step()                      # admits every slot, one decode
    fn = eng._verify_fn()
    graph, marks = fn._graph, {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    class Timed:
        def replay(self):
            marks["launch"] = time.perf_counter()
            ev[0].record()
            graph.replay()
            ev[1].record()

    decode = eng._decode_once

    def timed_decode():
        marks["entry"] = time.perf_counter()
        decode()
        marks["exit"] = time.perf_counter()

    fn._graph, eng._decode_once = Timed(), timed_decode
    parts = {"entry to launch": [], "graph (device)": [],
             "launch to exit": [], "step() call": []}
    for _ in range(SPLIT_STEPS):
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        parts["entry to launch"].append(marks["launch"] - marks["entry"])
        parts["graph (device)"].append(ev[0].elapsed_time(ev[1]) / 1e3)
        parts["launch to exit"].append(marks["exit"] - marks["launch"])
        parts["step() call"].append(t1 - t0)
    check_active = eng.stats().active_slots
    print(f"full decode step in parts, {SPLIT_STEPS} steps, "
          f"{check_active} slots still active after, ms p50: "
          + ", ".join(f"{k} {statistics.median(v) * 1e3:.4f}"
                      for k, v in parts.items()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gate-reps", type=int, default=0)
    ap.add_argument("--eager-steps", type=int, default=0)
    ap.add_argument("--serve-runs", type=int, default=0)
    ap.add_argument("--phase", type=int, choices=(5, 13), default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi_line()
    print("tree at", os.getcwd(), ";", card, flush=True)
    if args.serve_runs:
        serve_runs(cs, args.serve_runs)
        return
    _build.build_all(["flash_attention", "flash_attention_qkv"])
    if args.eager_steps:
        _build.build_all(["multi_tensor_adam"])
        eager_steps(cs, args.eager_steps)
        return
    if args.gate_reps:
        gate_reps(cs, args.gate_reps, args.phase, card)
        return
    model = GPTForPretraining(gpt_config("gpt3-1.3b"), dtype="bfloat16",
                              seed=0)
    params = {n: p.detach() for n, p in model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(0)
    grads = {n: (torch.randn(p.shape, generator=g, device="cuda") * 1e-3)
             .to(p.dtype) for n, p in params.items()}
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    state = opt.init_state(params, slot_dtype=torch.bfloat16)
    opt.apply_gradients(params, grads, state)
    for _ in range(2):
        wall, busy, per, kernels, calls, _ = cs.profile_totals(
            torch, lambda: opt.apply_gradients(params, grads, state))
        print(f"update (AdamW.apply_gradients, gpt3-1.3b bf16 params, "
              f"grads, moments): device busy {busy / 1e3:.4f} ms, wall "
              f"{wall / 1e3:.4f} ms, {kernels} kernels, {calls} host launch "
              "calls", flush=True)
    del model, params, grads, state, opt
    print("[5]", flush=True)
    cs.train_phase(torch, 0, card)
    for i, v in ((6, "masked"), (7, "unfused"), (8, "fused")):
        print(f"[{i}]", flush=True)
        cs.bert_phase(torch, 0, card, v)
    print("[13]", flush=True)
    cs.gemma_phase(torch, 0, card)


if __name__ == "__main__":
    main()
