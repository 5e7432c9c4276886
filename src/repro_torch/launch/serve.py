"""Serving launcher: pack a model offline, serve with token-level
continuous batching (freed slots are refilled mid-flight from the queue):
the port's copy of ``repro/launch/serve.py``, with its flags and defaults.

Prompt lengths and tokens are drawn with ``np.random.default_rng(seed)``
exactly as the JAX launcher draws them, so both serve the same requests
(the weights are the port's own random draw).  Runs on the card unless
``--device cpu`` is given; a CUDA run without a card raises.  ``main``
returns the served requests.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-0.73b \\
      --n-requests 8 --prompt-len 32 --max-new 16 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.serving import Request, ServingEngine


def draw_requests(vocab_size: int, n_requests: int, prompt_len: int,
                  max_new: int, seed: int) -> list:
    """The JAX launcher's requests: lengths uniform in [min(4,
    prompt_len), prompt_len], then each prompt's tokens, from one
    ``default_rng(seed)`` in that order."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(min(4, prompt_len), prompt_len + 1,
                         size=n_requests)
    return [Request(prompt=rng.integers(0, vocab_size, size=int(plen)),
                    max_new_tokens=max_new)
            for plen in plens]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-0.73b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length; actual lengths are mixed "
                         "uniformly in [4, prompt-len]")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving on cuda asked for, and no CUDA device "
                           "is present (pass --device cpu to serve on the "
                           "CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                          vocab_size=256)
    print(f"init + offline base-3 packing ({args.arch})...")
    packed = transformer.init_packed_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))

    reqs = draw_requests(cfg.vocab_size, args.n_requests, args.prompt_len,
                         args.max_new, args.seed)
    eng = ServingEngine(cfg, packed, max_seq=args.prompt_len + args.max_new,
                        batch_slots=args.batch_slots, device=device)
    t0 = time.perf_counter()
    eng.run(reqs)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    ttfts = [r.ttft_s for r in reqs]
    print(f"served {len(reqs)} requests, {total_new} tokens in {wall:.2f}s "
          f"-> {total_new / wall:.1f} tok/s aggregate "
          f"({eng.stats['mid_flight_admissions']} mid-flight admissions)")
    print(f"TTFT: mean {np.mean(ttfts)*1e3:.0f}ms  "
          f"p90 {np.percentile(ttfts, 90)*1e3:.0f}ms")
    return reqs


if __name__ == "__main__":
    main()
