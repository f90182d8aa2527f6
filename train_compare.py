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

    python3 train_compare.py --gate-reps N

builds phase 5's GPT run once (gpt3-1.3b, seed 0, its graph and timed
replays) and then runs the tree's own replay-against-eager gate
(`chip_smoke.train_graph_check`) N times on it, printing each outcome
and the count that failed: how often the gate fails on one tree.
"""
import argparse
import dataclasses
import os
import sys

import torch


def gate_reps(cs, reps):
    """Phase 5's graph-against-eager gate ``reps`` times on one run."""
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(gpt_config(cs.MODEL), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, dtype="bfloat16", seed=0)
    model.train()
    step = SpmdTrainStep(model, gpt_loss_fn, AdamW(
        learning_rate=cs.TRAIN_LR, weight_decay=cs.TRAIN_WD))
    params, opt_state = step.init(slot_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = [torch.randint(0, cfg.vocab_size, (cs.TRAIN_B, cs.TRAIN_S + 1),
                            generator=g, device="cuda")
              for _ in range(cs.TRAIN_STEPS + 3)]
    batches = [{"input_ids": t[:, :-1], "labels": t[:, 1:]} for t in tokens]
    run = cs.train_on_graphs(torch, step, params, opt_state, batches, "GPT")
    failed = 0
    for i in range(reps):
        try:
            cs.train_graph_check(torch, step, params, opt_state, batches,
                                 run, "GPT", memory_gate=True)
        except RuntimeError as e:
            failed += 1
            print(f"  rep {i}: FAILED {e}", flush=True)
    print(f"gate reps: {failed} of {reps} failed", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gate-reps", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.gpt import GPTForPretraining, gpt_config
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(["flash_attention", "flash_attention_qkv"])
    card = cs.nvidia_smi_line()
    print("tree at", os.getcwd(), ";", card, flush=True)
    if args.gate_reps:
        gate_reps(cs, args.gate_reps)
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
