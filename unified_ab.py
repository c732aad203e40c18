"""Time the unified engine step's free and lockstep modes at llama3.2-3b
fp32 for the checkout at ROOT, with that checkout's own build of
csrc/ws_unified.cu, on one CUDA card:

    python3 unified_ab.py ROOT [stats]

ROOT is a checkout with the repo's layout (``.`` for this one, or another
tree unpacked beside it).  With ``stats`` it first prints each ws_unified
function's registers, spill stores and SASS instructions (``fn`` lines).
Then, on random weights from seed 0 and caches of 4 slots at lengths 1024,
658, 531 and 288, it times a free step, a lockstep step and a free step
again, 3 steps each after one warm step, with CUDA events (``ms``) and the
host's enqueue time of each (``host_ms``), and prints them as one JSON
object on an ``AB`` line.  Free mode's step is one launch a stage, and the
host time shows how much of it the host's per-stage work takes.  Compare
two builds only within one call, running each root's process in turn."""
import json
import sys
import time

root = sys.argv[1]
sys.path.insert(0, root + "/src")
import numpy as np
import torch

from repro_torch import _build
from repro_torch.configs.llama3_2_3b import CONFIG
from repro_torch.models import Caches, KVCache, init_params
from repro_torch.models.unified import plan_step, run_step

t = time.time()
_build.load("ws_unified")
print("build", root, round(time.time() - t, 1), flush=True)
if len(sys.argv) > 2:
    for f, st in _build.function_stats("ws_unified").items():
        print("fn", root, f, st["registers"], st["spill_stores"], st["sass_instructions"])
dev = torch.device("cuda")
cfg = CONFIG.replace(dtype="float32")
params = init_params(cfg, seed=0, device=dev)
B, cap = 4, 1024
pos = np.array([1023, 657, 530, 287])
tok = torch.tensor([[11], [22], [33], [44]], device=dev)
g = torch.Generator(device=dev).manual_seed(0)
shape = (cfg.n_layers, B, cap, cfg.n_kv_heads, cfg.hd)
k0 = torch.randn(shape, generator=g, device=dev)
v0 = torch.randn(shape, generator=g, device=dev)
run = dict(steal=True, steal_policy="cost", n_programs=8)
out = {"root": root}
for mode in ("free", "lockstep", "free"):
    plan = plan_step(params, cfg, Caches(kv=KVCache(k0.clone(), v0.clone())), tok, pos)

    def step():
        plan.bufs["att"].zero_()
        run_step(params, cfg, plan, mode=mode, **run)

    step()
    torch.cuda.synchronize()
    ts, hs = [], []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        step()
        hs.append((time.perf_counter() - h0) * 1e3)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    out.setdefault(mode, []).append(dict(ms=ts, host_ms=hs))
    del plan
print("AB", json.dumps(out), flush=True)
