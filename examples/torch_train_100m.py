"""End-to-end training driver example on the PyTorch port (the twin of
``examples/train_100m.py``): a ~100M-parameter dense model trained for a few
hundred steps on synthetic data, with checkpoint/resume.

  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] [--preset tiny] \
      [--device cpu]

Runs on the card unless ``--device cpu`` is given; there every attention
forward, and remat's recompute of it, runs the bf16 flash attention kernel
(head dim 64). On a CPU use ``--preset tiny --steps 50`` for a quick
demonstration; the training loop, checkpointing, and data pipeline are
identical. Checkpoints go to ``build/torch_train_100m_ckpt`` beside the
repository's sources unless ``--ckpt-dir`` says otherwise, never to the JAX
example's directory: a run there resumes from the last complete snapshot.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

from repro_torch.configs import Block, ModelConfig, register  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
CKPT_DIR = os.path.join(ROOT, "build", "torch_train_100m_ckpt")
# preset: (arch, batch, seq)
PRESETS = {"100m": ("demo-100m", 8, 256), "tiny": ("demo-tiny", 8, 128)}
CKPT_EVERY, LOG_EVERY = 100, 10


def register_presets() -> None:
    """Registers the two presets' configs (a second call registers equal ones)."""
    # ~100M params: 12L d=768 12H d_ff=3072 vocab=32000 (GPT-2-small-ish)
    register(
        ModelConfig(
            name="demo-100m",
            family="dense",
            d_model=768,
            vocab=32_000,
            n_heads=12,
            n_kv_heads=12,
            head_dim=64,
            d_ff=3072,
            pattern=(Block("gqa", "dense"),),
            n_pattern_repeats=12,
        )
    )
    register(
        ModelConfig(
            name="demo-tiny",
            family="dense",
            d_model=128,
            vocab=2_000,
            n_heads=4,
            n_kv_heads=4,
            head_dim=32,
            d_ff=512,
            pattern=(Block("gqa", "dense"),),
            n_pattern_repeats=4,
        )
    )


def train(preset: str, steps: int, ckpt_dir: str, device: str = "cuda",
          ckpt_every: int = CKPT_EVERY, log_every: int = LOG_EVERY) -> dict:
    """``repro_torch.launch.train.main`` on a preset; returns its record
    (``first_loss``, ``last_loss``, ``losses``, ``step_seconds``)."""
    register_presets()
    arch, batch, seq = PRESETS[preset]
    return train_main(
        [
            "--arch", arch,
            "--steps", str(steps),
            "--batch", str(batch),
            "--seq", str(seq),
            "--ckpt-dir", ckpt_dir,
            "--ckpt-every", str(ckpt_every),
            "--log-every", str(log_every),
            "--device", device,
        ]
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="100m")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.preset, args.steps, args.ckpt_dir, args.device)
    print(f"final: loss {out['first_loss']:.3f} -> {out['last_loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
