"""Batched LM serving on the PyTorch port: prefill a batch of prompts, then
greedy-decode with the KV cache (``examples/serve_lm.py`` on the port).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch olmo_1b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --arch deepseek_v3_671b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch jamba_v01_52b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch xlstm_350m
    PYTHONPATH=src python examples/torch_serve_lm.py \
        --arch seamless_m4t_large_v2

Serves the arch's smoke config with seeded random weights, on the CUDA
card unless ``--device cpu``. Every LM arch of the registry serves: the
dense and GQA archs, the MoE family (``phi35_moe_42b``;
``deepseek_v3_671b`` with MLA and its MTP module), the Jamba hybrid
(``jamba_v01_52b``: Mamba layers, one attention layer in eight, MoE on the
odd layers), xLSTM (``xlstm_350m``: mLSTM and sLSTM blocks, 7:1), the VLM
(``internvl2_26b``: seeded patch features before the prompt, so the cache
holds ``frontend_len`` more positions) and the speech encoder-decoder
(``seamless_m4t_large_v2``: seeded frame features, encoded once into the
``memory`` that every decode step attends to).
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training import steps as S


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = M.init_model(cfg, seed=0, device=dev)
    max_len = args.prompt_len + args.gen + (cfg.frontend_len or 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}
    if cfg.frontend:        # precomputed patch / frame features (a stub)
        batch["frontend"] = 0.02 * torch.randn(
            (args.batch, cfg.frontend_len, cfg.frontend_dim), generator=gen,
            device=dev)

    prefill = S.make_prefill_step(cfg, max_len)
    step = S.make_serve_step(cfg)

    t0 = time.perf_counter()
    memory = None
    if cfg.n_enc_layers:    # the encoder runs once per request
        with torch.no_grad():
            memory = M._encode(model, batch, cfg)
    nxt, caches = prefill(model, batch)
    out = [nxt]
    for _ in range(args.gen - 1):
        db = {"tokens": nxt[:, None]}
        if memory is not None:
            db["memory"] = memory
        nxt, caches = step(model, caches, db)
        out.append(nxt)
    toks = torch.stack(out, dim=1).cpu()     # waits for the device
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    print(f"{args.arch}: generated {args.batch}x{args.gen} tokens in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s on {where})")
    print("sample:", toks[0, :16].tolist())
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
    return toks


if __name__ == "__main__":
    main()
