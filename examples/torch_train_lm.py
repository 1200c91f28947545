"""End-to-end LM training on the PyTorch port: train a smoke-config model
for a few hundred steps on the synthetic token stream, with checkpoint and
restart (``examples/train_lm.py`` on the port).

    PYTHONPATH=src python examples/torch_train_lm.py
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --arch jamba_v01_52b \
        --steps 50

This wraps ``repro_torch.launch.train`` on the CUDA card unless ``--device
cpu``; checkpoints go under ``ckpts/<arch>``. Kill it mid-run and run it
again with ``--resume`` to exercise the restart.
"""
import argparse

from repro_torch.launch.train import train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    _, hist = train(args.arch, smoke=True, steps=args.steps, batch=8,
                    seq=128, ckpt_dir=f"ckpts/{args.arch}", ckpt_every=50,
                    resume=args.resume, peak_lr=1e-3, device=args.device)
    print(f"loss {hist[0]:.3f} -> {hist[-1]:.3f}")
    assert hist[-1] < hist[0]
    return hist


if __name__ == "__main__":
    main()
