"""Where two MoE BERT-base gradients part: flash or dense attention, in
bfloat16 or float32, from the same weights and the same routing.

    python scripts/moe_grad_probe.py

On the card: builds the flash kernels, draws chip_smoke's MoE BERT-base
(8 experts, k = 2, batch 16, T = 512) from its numpy seed, takes the
masked-LM gradient five times (flash bf16, which records each layer's
routing; dense bf16, flash float32 and dense float32, which replay it
through chip_smoke.RoutingReplay; dense bf16 again on its own routing)
and prints, for each layer's gate, first expert weights and QKV weights,
max |a - b| / max |b| between the pairs, and how many tokens each
replaying pass would have routed apart. About 35 s of command time.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402
from deeplearning4j_tpu_torch.kernels import build  # noqa: E402
from deeplearning4j_tpu_torch.models import bert  # noqa: E402
from deeplearning4j_tpu_torch.utils.convert import (  # noqa: E402
    bert_params_from_numpy)

PASSES = (("flash bf16", "bfloat16", "flash"),
          ("dense bf16", "bfloat16", "dense"),
          ("flash f32", "float32", "flash"),
          ("dense f32", "float32", "dense"))
PAIRS = (("flash bf16", "dense bf16"), ("flash bf16", "flash f32"),
         ("dense bf16", "flash f32"), ("flash f32", "dense f32"),
         ("flash bf16", "dense bf16 own routing"))


def main():
    if not torch.cuda.is_available():
        print("moe_grad_probe: needs a GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    build.load_all(["flash_attn_fwd", "flash_attn_bwd"])
    tree = c.moe_bert_numpy_params(np.random.default_rng(c.SEED + 40))
    params = bert_params_from_numpy(tree, "cuda")
    leaves = bert.param_leaves(params)
    names = c._bert_leaf_names(params)
    base = bert.BertConfig(**c.BERT_BASE, **c.MOE_BERT, dropout=0.0)
    tok, lab = bert.synthetic_mlm_batch(base, c.BERT_BATCH, c.BERT_T,
                                        seed=40)
    pos, mlab, w = (torch.as_tensor(a, device="cuda") for a in
                    bert.mlm_gather(lab, bert.mlm_max_preds(c.BERT_T)))
    tokens = torch.as_tensor(tok, device="cuda").long()
    want = [i for i, n in enumerate(names) if n.endswith(
        ("moe.gate_w", "moe.w1", "qkv_w"))]
    grads = {}

    def grad(label, cfg):
        for p in leaves:
            p.requires_grad_(True)
        loss = bert.mlm_loss_masked(params, cfg, tokens, pos, mlab, w,
                                    deterministic=True)
        g = torch.autograd.grad(loss, [leaves[i] for i in want])
        for p in leaves:
            p.requires_grad_(False)
        grads[label] = [t.detach().float() for t in g]
        torch.cuda.empty_cache()
        return float(loss.detach())

    with c.RoutingReplay(bert) as replay:
        for label, dtype, impl in PASSES:
            if label == "flash bf16":
                replay.record()
            else:
                replay.replay()
            loss = grad(label, dataclasses.replace(
                base, compute_dtype=dtype, attention_impl=impl))
            print(f"{label}: loss {loss:.6f}, tokens routed apart by layer "
                  f"{replay.apart}", flush=True)
    loss = grad("dense bf16 own routing", dataclasses.replace(
        base, attention_impl="dense"))
    print(f"dense bf16 own routing: loss {loss:.6f}", flush=True)
    for j, i in enumerate(want):
        print(names[i], "; ".join(
            f"{a} ~ {b} {c._rel_err(grads[a][j], grads[b][j]):.3e}"
            for a, b in PAIRS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
