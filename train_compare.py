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
"""
import os
import sys

import torch


def main():
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
