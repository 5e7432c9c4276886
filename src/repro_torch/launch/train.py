"""Training launcher: QAT ternary training with checkpoint/restore,
preemption (SIGTERM) and the straggler timer — the port's copy of
``repro/launch/train.py``.

Runs on the card unless ``--device cpu`` is given; a CUDA run without a
card raises.  The default is the reduced config (2 layers, d_model 128,
vocab 256), as in the reference; ``--full`` takes the config as
published.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch bitnet-0.73b \\
      --steps 100 --batch 8 --seq-len 128 --ckpt-dir /tmp/ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import install_sigterm_handler
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import transformer
from repro_torch.models.layers import Ctx
from repro_torch.optim import adamw
from repro_torch.runtime.fault import StepTimer
from repro_torch.training import make_train_step


def train(arch: str, *, steps: int, batch: int, seq_len: int,
          ckpt_dir: str | None, ckpt_every: int = 50, reduced: bool = True,
          lr: float = 3e-4, microbatches: int = 1, log_every: int = 10,
          resume: bool = True, seed: int = 0,
          device: str | torch.device = "cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda asked for, and no CUDA device "
                           "is present (pass device='cpu' to train on the "
                           "CPU)")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                          vocab_size=256)
    ctx = Ctx(mode="qat", attn="skip", attn_q_chunk=min(128, seq_len),
              attn_kv_chunk=min(128, seq_len))
    optimizer = adamw(lr=lr, warmup_steps=min(100, steps // 10 + 1))
    step_fn = make_train_step(cfg, ctx, optimizer, microbatches=microbatches,
                              loss_chunk=min(512, seq_len))

    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed))
    opt_state = optimizer.init(params)
    data = SyntheticLMDataset(cfg, batch=batch, seq_len=seq_len, seed=seed,
                              device=device)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        restored = mgr.restore(None, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start_step = mgr.latest_step()
        print(f"resumed from step {start_step}")

    preempted = install_sigterm_handler()
    timer = StepTimer()
    losses = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             data.batch_at(step))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if timer.record(step, dt):
            print(f"[straggler] step {step} took {dt:.2f}s "
                  f"(ema {timer.stats.ema:.2f}s)")
        losses.append(loss)
        if step % log_every == 0:
            tps = batch * seq_len / dt
            print(f"step {step:5d} loss {loss:.4f} {dt*1e3:.0f}ms "
                  f"({tps:.0f} tok/s)", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
        if preempted:
            print("SIGTERM received: checkpointing and exiting")
            if mgr:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         blocking=True)
            break
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt_state}, blocking=True)
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-0.73b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the config as published, not reduced")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, steps=args.steps, batch=args.batch,
                      seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, reduced=not args.full,
                      lr=args.lr, microbatches=args.microbatches,
                      seed=args.seed, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
