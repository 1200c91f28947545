"""End-to-end LM training driver: train an arch on the synthetic token
stream with checkpoint and restart. The port of the JAX package's
``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \
        --steps 300 --batch 8 --seq 128 --ckpt-dir ckpts/olmo
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20

Runs on the CUDA card unless ``device="cpu"`` (``--device cpu``).
Checkpoints are atomic; ``resume`` picks up the latest one (parameters,
moments, step and data cursor) and continues where it left off: on the
CPU bit for bit.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training import steps as S
from repro_torch.training.checkpoint import (keep_last, latest_checkpoint,
                                             load_pytree, save_pytree)
from repro_torch.training.data import SyntheticTokens


def train(arch: str, *, smoke=True, steps=200, batch=8, seq=128,
          ckpt_dir=None, ckpt_every=50, resume=False, peak_lr=1e-3,
          log_every=10, seed=0, device: DeviceLike = None):
    """Train ``arch`` (its smoke config unless ``smoke=False``) from seed
    ``seed`` for ``steps`` steps on batches of ``SyntheticTokens(vocab,
    seq, batch, seed=seed)``, with 20 warm-up steps of the schedule; a
    frontend arch gets zero features ``[batch, frontend_len,
    frontend_dim]``. With ``ckpt_dir``: a checkpoint every ``ckpt_every``
    steps (the newest 3 kept) and one at the end, each with ``meta``
    ``{"data_cursor", "arch"}``. Returns (state, the per-step losses)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    state = S.make_train_state(cfg, seed=seed, device=dev)
    step_fn = S.make_train_step(cfg, peak_lr=peak_lr, warmup=20,
                                total=steps)
    ds = SyntheticTokens(cfg.vocab, seq, batch, seed=seed)
    start = 0

    if resume and ckpt_dir:
        path = latest_checkpoint(ckpt_dir)
        if path:
            state, meta = load_pytree(path, like=state)
            start = int(meta["data_cursor"])
            print(f"resumed from {path} at step {start}")

    hist = []
    t0 = time.time()
    for i in range(start, steps):
        b = ds.batch(i)
        tb = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
              "labels": torch.from_numpy(b["labels"]).to(dev)}
        if cfg.frontend:
            tb["frontend"] = torch.zeros(
                (batch, cfg.frontend_len, cfg.frontend_dim),
                dtype=torch.float32, device=dev)
        state, metrics = step_fn(state, tb)
        loss = float(metrics["loss"])
        hist.append(loss)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e}"
                  f" gnorm {float(metrics['grad_norm']):.3f}"
                  f" ({(time.time() - t0):.1f}s)", flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_pytree(os.path.join(ckpt_dir, f"step_{i + 1:07d}.npz"),
                        state, extra_meta={"data_cursor": i + 1,
                                           "arch": arch})
            keep_last(ckpt_dir, 3)
    if ckpt_dir:
        save_pytree(os.path.join(ckpt_dir, f"step_{steps:07d}.npz"), state,
                    extra_meta={"data_cursor": steps, "arch": arch})
    return state, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    _, hist = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=args.resume,
                    peak_lr=args.lr, seed=args.seed, device=args.device)
    print(f"final loss {hist[-1]:.4f} (first {hist[0]:.4f})")
    return hist


if __name__ == "__main__":
    main()
