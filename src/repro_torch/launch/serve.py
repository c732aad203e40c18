"""Serving entry point of the port (``repro/launch/serve.py`` counterpart):
continuous batching behind the work-stealing frontend.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --requests 12 --device cpu

serves the smoke config on the CPU (the kernels' plain versions); on a CUDA
card drop ``--device cpu`` (the default is ``cuda``, and it raises without
one).  ``--full-config`` takes the full width and ``--n-layers`` cuts its
depth.  The weights are random, from ``--seed``.  Requests arrive skewed,
most of them at replica 0, so the frontend's stealing balances them
(``--no-steal`` turns it off).  Prompts are tokens only, as the reference's
engine takes them, so the encdec and vlm families raise.  Exits 0 only when
every request completed.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.models import init_params
from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=list(ARCH_MODULES))
    ap.add_argument("--full-config", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--n-layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--no-steal", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full_config)
    if args.n_layers is not None:
        cfg = cfg.replace(n_layers=args.n_layers)
    params = init_params(cfg, seed=args.seed, device=dev)
    fe = WorkStealingFrontend(
        lambda: ContinuousBatcher(params, cfg, slots=args.slots, capacity=args.capacity),
        n_replicas=args.replicas,
        steal=not args.no_steal,
    )
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        # skewed arrival: most requests hit replica 0, and stealing balances
        rep = 0 if rng.rand() < 0.8 else rng.randint(args.replicas)
        prompt = rng.randint(1, cfg.vocab_size, size=rng.randint(3, 9)).astype(np.int32)
        fe.submit(rep, Request(rid, prompt, max_new=args.max_new))
    completed = fe.run()
    dt = time.time() - t0
    ok = sorted(completed) == list(range(args.requests))
    print(f"[serve] {len(completed)}/{args.requests} completed in {dt:.1f}s "
          f"(all={ok}) on {dev}; stats={fe.stats()}")
    for rid in sorted(completed)[:4]:
        print(f"  req {rid}: out={completed[rid].out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
