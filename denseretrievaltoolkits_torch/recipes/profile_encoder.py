"""Ablation profile of the encoder hot path on the card, for the port.

The twin of the JAX package's ``recipes/profile_encoder.py``. It decomposes the
bert-base encode / train conditions (B=256, S=156, bf16) into measurable
pieces:

  1. full encode forward and per-layer scaling (12 vs 2 layers -> marginal
     layer cost + fixed cost) on 'xla' (plain PyTorch), 'fused' (K1 / K2) and
     'flash' (F-fwd), each with its max |delta| against 'xla';
  2. the attention inner (QK^T -> softmax -> PV, the plain chain) against the
     port's flash kernel (F-fwd) on the same [B, S, nh, hd] inputs;
  3. the projection and MLP products at the block's shapes (cuBLAS);
  4. the train step split: forward only, forward + backward, full AdamW step
     (32 queries x 64 passages at S, 'fused', K3 / K4 for the loss);
  5. ``torch.profiler``: the device kernels of one 12-layer 'fused' encode,
     by device time, and the device's busy share of it.

Times are CUDA events on the card (host clock on the CPU), the mean of
``iters`` calls after warm-up. Usage:

    python -m denseretrievaltoolkits_torch.recipes.profile_encoder   # on the card
    python -m denseretrievaltoolkits_torch.recipes.profile_encoder --smoke --device cpu

Writes ``--out`` (default ``chiprun_out/profile_encoder.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

ATTENTIONS = ("xla", "fused", "flash")


def timeit(fn, device, iters=20, warmup=2) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def encoder(config, attention, device, seed=0):
    from ..models.biencoder import DRModelForInference, DRModelSpec
    from ..models.convert import init_params_numpy

    model = DRModelForInference(DRModelSpec(bert_config=config, dtype="bfloat16",
                                            attention=attention), device=device)
    model.load_tower_tree("lm_q", init_params_numpy(config, seed))
    return model


def device_profile(fn, top=8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device ms of its CUDA
    kernels, their share of the call's wall time (ended by a synchronize), and the
    ``top`` kernels by device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "kernels": {k[:120]: v for k, v in kernels}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, 1 iteration")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_encoder.json"))
    args = ap.parse_args(argv)

    from ..models.bert import BertConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profile_encoder: no CUDA card; pass --device cpu")
    if args.smoke:
        B, S, iters = 4, 32, 1
        cfg12 = BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=12,
                           num_attention_heads=2, intermediate_size=128,
                           max_position_embeddings=64)
    else:
        B, S, iters = 256, 156, 10
        cfg12 = BertConfig()
    cfg2 = BertConfig(**{**cfg12.__dict__, "num_hidden_layers": 2})
    H, nh = cfg12.hidden_size, cfg12.num_attention_heads
    hd, F = H // nh, cfg12.intermediate_size
    res = {}

    def record(name, ms, note=""):
        res[name] = ms
        print(f"{name:42s} {ms:9.3f} ms  {note}", flush=True)

    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(rng.integers(1, cfg12.vocab_size, (B, S))
                                           .astype(np.int32)).to(device),
             "attention_mask": torch.ones(B, S, dtype=torch.int32, device=device)}

    # -- 1: full encode + layer scaling, per attention ---------------------
    reps = {}
    for attention in ATTENTIONS:
        m12, m2 = encoder(cfg12, attention, device), encoder(cfg2, attention, device)
        reps[attention] = m12.encode_passage(batch)
        ms12 = timeit(lambda: m12.encode_passage(batch), device, iters)
        ms2 = timeit(lambda: m2.encode_passage(batch), device, iters)
        err = float((reps[attention] - reps["xla"]).abs().max())
        record(f"encode_12L_{attention}", ms12,
               f"{B * 1000.0 / ms12:.0f} passages/s, max|d| vs xla {err:.2e}")
        res[f"encode_12L_{attention}_max_abs_err_vs_xla"] = err
        record(f"encode_2L_{attention}", ms2)
        per_layer = (ms12 - ms2) / 10.0
        record(f"per_layer_marginal_{attention}", per_layer, "(12L-2L)/10")
        record(f"fixed_cost_{attention}", ms2 - 2 * per_layer, "embed+LN+dispatch")
        if attention == "fused" and device.type == "cuda":
            res["encode_12L_fused_profile"] = device_profile(lambda: m12.encode_passage(batch))
        del m12, m2

    # -- 2: attention inner, the plain chain vs the flash kernel -----------
    from ..ops import flash

    gen = torch.Generator(device="cpu").manual_seed(1)
    q, k, v = (torch.randn(B, S, nh, hd, generator=gen).to(device, torch.bfloat16)
               for _ in range(3))
    seg = torch.ones(B, S, dtype=torch.int32, device=device)

    def attn_plain():
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    qkv = torch.cat((q, k, v), dim=2).reshape(B, S, 3 * H).contiguous()
    with torch.inference_mode():
        ms_attn = timeit(attn_plain, device, iters)
        record("attn_inner_plain_x12", ms_attn * 12, f"one layer {ms_attn:.3f}")
        ms_flash = timeit(lambda: flash.flash_attention_qkv(qkv, seg, nh, hd), device, iters)
        record("attn_inner_flash_x12", ms_flash * 12, f"one layer {ms_flash:.3f}")
        err = float((flash.flash_attention_qkv(qkv, seg, nh, hd).float()
                     - attn_plain().float()).abs().max())
        res["attn_inner_flash_max_abs_err"] = err

        # -- 3: the projection and MLP products ----------------------------
        x2d = torch.randn(B * S, H, generator=gen).to(device, torch.bfloat16)
        wqkv, wo = (torch.randn(H, 3 * H, generator=gen).to(device, torch.bfloat16),
                    torch.randn(H, H, generator=gen).to(device, torch.bfloat16))
        wi, wod = (torch.randn(H, F, generator=gen).to(device, torch.bfloat16),
                   torch.randn(F, H, generator=gen).to(device, torch.bfloat16))

        def proj_mlp():
            a = x2d @ wqkv
            b = x2d @ wo
            h = torch.nn.functional.gelu(x2d @ wi)
            return a[:, :H] + b + h @ wod

        ms_mm = timeit(proj_mlp, device, iters)
        flops = 2 * B * S * (H * 3 * H + H * H + 2 * H * F)
        record("proj_mlp_matmuls_x12", ms_mm * 12,
               f"one layer {ms_mm:.3f} = {flops / ms_mm / 1e9:.0f} TFLOP/s")
        res["proj_mlp_tflops"] = flops / ms_mm / 1e9

    # -- 4: the train step split -------------------------------------------
    from ..models.biencoder import DRModel, DRModelSpec
    from ..models.convert import init_params_numpy

    model = DRModel(DRModelSpec(bert_config=cfg12, dtype="bfloat16", attention="fused",
                                fused_loss=True), device=device)
    model.load_tower_tree("lm_q", init_params_numpy(cfg12, 0))
    nq, npass = (4, 8) if args.smoke else (32, 64)
    qb = {"input_ids": torch.from_numpy(rng.integers(1, cfg12.vocab_size, (nq, S))
                                        .astype(np.int32)).to(device),
          "attention_mask": torch.ones(nq, S, dtype=torch.int32, device=device)}
    pb = {"input_ids": torch.from_numpy(rng.integers(1, cfg12.vocab_size, (npass, S))
                                        .astype(np.int32)).to(device),
          "attention_mask": torch.ones(npass, S, dtype=torch.int32, device=device)}
    steps = 1 if args.smoke else 5
    with torch.no_grad():
        record("train_forward_only", timeit(lambda: model(qb, pb)["loss"], device, steps))

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        model(qb, pb)["loss"].backward()

    record("train_forward_backward", timeit(fwd_bwd, device, steps))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-5)

    def full():
        fwd_bwd()
        opt.step()

    record("train_full_step", timeit(full, device, steps))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"B": B, "S": S, "device": str(device), **res}, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return res


if __name__ == "__main__":
    main()
