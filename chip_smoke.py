"""On-card smoke run of the PyTorch/CUDA port (repro_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build      nvcc builds csrc/ws_attention.cu for sm_90a from the checkout.
2. parity     the kernel against its plain PyTorch version on CPU copies of
              the same inputs, at the decode shapes of the main path
              (B=4, H=24, Hkv=8, hd=128, S=1024, bk=64, P=8, bf16, K/V read
              through the cache's transposed strides) and one causal flash
              launch (bq=16): lockstep integer arrays bit-equal and `out`
              within ATOL; free mode with every task run, `out` within ATOL
              of the plain version's normalised output, and a seeded rewind
              drill with mult == 2.
3. audit      0 atom/red/fence/membar in the kernel's SASS and PTX.
4. serving    llama3.2-3b at full width (bf16, random weights from a seed),
              2 ContinuousBatcher replicas (4 slots, 1024 positions) behind
              the WorkStealingFrontend; 8 requests all submitted to replica
              0; every request completes, launches == decode steps x 28, and
              decode_step_ws logits agree with the dense decode_step.
5. times      kernel ms (free, lockstep), bound, plain version, and one
              F.scaled_dot_product_attention call as a yardstick only.

The last three lines are the card (nvidia-smi name, power limit), one JSON
object listing the ported kernels, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

# fp32 accumulation of identical bf16 inputs in another order: 128-term dot
# products and softmax sums over up to 1024 keys of O(1) values differ by a
# few fp32 ulps of the sums, far below 1e-4.
ATOL = 1e-4
# ws vs dense logits at full width: both run the same bf16 projections and
# MLPs and differ in attention (the kernel's is fp32 end to end, the dense
# path rounds scores and weights to bf16), 28 layers deep with random
# weights.  The yardstick is the same step in fp32: the ws step may stray
# from it at most LOGIT_SLACK times as far as the dense bf16 step does.
LOGIT_SLACK = 2.0

SEED = 0
DECODE = dict(B=4, H=24, Hkv=8, hd=128, S=1024, bk=64, P=8)
FLASH = dict(B=2, H=24, Hkv=8, hd=128, S=256, bq=16, bk=64, P=8)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch import _build

    t0 = time.perf_counter()
    path = _build.build("ws_attention")
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS['ws_attention']:.2f} s)")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("[build] ptxas:", line.strip())
    log("[build] card:", card_line())


def _ints(res):
    names = ("head", "local_head", "taken", "remaining", "clock", "work",
             "steals", "scanned", "mult")
    return {n: getattr(res, n).cpu().numpy() for n in names}


def decode_inputs(rng, dev):
    c = DECODE
    lengths = rng.integers(16, c["S"] + 1, size=c["B"])
    lengths[0] = c["S"]  # one full-length slot: the skew the thieves erase
    q = torch.from_numpy(rng.standard_normal((c["B"], c["H"], c["hd"]), np.float32))
    # K/V as the serving cache lays them out: [B, S, Hkv, hd], read through a
    # transposed [B, Hkv, S, hd] view exactly as gqa_decode_ws passes them
    k = torch.from_numpy(rng.standard_normal((c["B"], c["S"], c["Hkv"], c["hd"]), np.float32))
    v = torch.from_numpy(rng.standard_normal((c["B"], c["S"], c["Hkv"], c["hd"]), np.float32))
    to = lambda t: t.to(torch.bfloat16).to(dev)  # noqa: E731
    return lengths, to(q), to(k).permute(0, 2, 1, 3), to(v).permute(0, 2, 1, 3)


def _check_lockstep(name, state, q, k, v, **kw):
    from repro_torch.pallas_ws import run_ws_schedule, to_device

    res_k = run_ws_schedule(to_device(state, q.device), q, k, v, mode="lockstep", **kw)
    torch.cuda.synchronize()
    res_p = run_ws_schedule(state, q.cpu(), k.cpu(), v.cpu(), mode="lockstep", **kw)
    ik, ip = _ints(res_k), _ints(res_p)
    for n in ik:
        if not np.array_equal(ik[n], ip[n]):
            raise AssertionError(f"{name}: lockstep {n} differs from the plain version")
    err = float((res_k.out.cpu() - res_p.out).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{name}: lockstep out max_abs_err {err} > {ATOL}")
    log(f"[parity] {name} lockstep: integer arrays bit-equal, out max_abs_err {err:.3g}")
    return res_p, err


def _check_free(name, state, q, k, v, expect, tasks, **kw):
    from repro_torch.pallas_ws import copy_state, normalized_out, run_ws_schedule, to_device

    B, H, Sq = q.shape[0], q.shape[1], q.shape[2]
    res = run_ws_schedule(to_device(state, q.device), q, k, v, mode="free", **kw)
    torch.cuda.synchronize()
    mult = res.mult[: state.n_tasks].cpu()
    if not bool((mult >= 1).all()):
        raise AssertionError(f"{name}: free mode left {(mult == 0).sum()} tasks unexecuted")
    err = float((res.out.cpu() - expect).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{name}: free out max_abs_err {err} > {ATOL}")
    log(f"[parity] {name} free: mult in [{int(mult.min())}, {int(mult.max())}], "
        f"out max_abs_err {err:.3g}, clock {res.clock.cpu().tolist()}")

    # rewind drill: resume from the finished launch with every head dragged
    # back to 0 and every local bound wiped; without thieves each task runs
    # exactly once more (mult == 2) and the stored out must not change.
    drill = copy_state(state)
    drill.head = np.zeros_like(drill.head)
    drill.local_head = np.zeros_like(drill.local_head)
    drill.taken = res.taken.cpu().numpy()
    drill.remaining = res.remaining.cpu().numpy()
    kw_static = dict(kw, steal=False)
    first = run_ws_schedule(to_device(state, q.device), q, k, v, mode="free", **kw_static)
    second = run_ws_schedule(to_device(drill, q.device), q, k, v, mode="free",
                             mult=first.mult, **kw_static)
    torch.cuda.synchronize()
    m2 = second.mult[: state.n_tasks].cpu()
    if not bool((m2 == 2).all()):
        raise AssertionError(f"{name}: rewind drill mult in [{int(m2.min())}, {int(m2.max())}], want 2")
    out2 = normalized_out(second, tasks, (B, H, second.out.shape[2]))
    err2 = float((out2.cpu() - expect).abs().max())
    if not err2 <= ATOL:
        raise AssertionError(f"{name}: rewind drill out max_abs_err {err2} > {ATOL}")
    # the same drill with thieves: every task runs at least once more
    second_ws = run_ws_schedule(to_device(drill, q.device), q, k, v, mode="free",
                                mult=res.mult, **kw)
    torch.cuda.synchronize()
    m3 = second_ws.mult[: state.n_tasks].cpu()
    err3 = float((second_ws.out.cpu() - expect).abs().max())
    if not (bool((m3 >= 2).all()) and err3 <= ATOL):
        raise AssertionError(f"{name}: stealing rewind drill mult min {int(m3.min())}, err {err3}")
    log(f"[parity] {name} rewind drill: mult == 2 without thieves (err {err2:.3g}), "
        f"mult in [{int(m3.min())}, {int(m3.max())}] with thieves (err {err3:.3g})")
    return max(err, err2, err3)


def phase_parity(dev):
    from repro_torch.pallas_ws import (
        emit_decode_tasks, emit_flash_tasks, make_queue_state, normalized_out,
        ragged_decode_ref,
    )

    rng = np.random.default_rng(SEED)
    c = DECODE
    lengths, q, k, v = decode_inputs(rng, dev)
    tasks = emit_decode_tasks(lengths, c["H"], c["bk"])
    state = make_queue_state(tasks, c["P"])
    q4 = q[:, :, None, :]
    kw = dict(causal=False, bq=1, bk=c["bk"])
    errs = []
    for steal, policy in ((True, "cost"), (True, "scan"), (False, "cost")):
        res_p, err = _check_lockstep(f"decode steal={steal} {policy}", state, q4, k, v,
                                     steal=steal, steal_policy=policy, **kw)
        errs.append(err)
    expect = normalized_out(res_p, tasks, (c["B"], c["H"], 1))
    errs.append(_check_free("decode", state, q4, k, v, expect, tasks, **kw))
    ref = ragged_decode_ref(q.cpu(), k.cpu(), v.cpu(), lengths).float()
    err_ref = float((expect[:, :, 0] - ref).abs().max())
    # the dense oracle rounds its output to bf16: half an ulp of |out| <= 4
    if not err_ref <= 2 ** -7:
        raise AssertionError(f"plain decode vs dense oracle max_abs_err {err_ref}")
    log(f"[parity] plain decode vs dense oracle (bf16 output) max_abs_err {err_ref:.3g}")

    f = FLASH
    fl = rng.integers(16, f["S"] + 1, size=f["B"])
    fq = torch.from_numpy(rng.standard_normal((f["B"], f["H"], f["S"], f["hd"]), np.float32))
    fk = torch.from_numpy(rng.standard_normal((f["B"], f["Hkv"], f["S"], f["hd"]), np.float32))
    fv = torch.from_numpy(rng.standard_normal((f["B"], f["Hkv"], f["S"], f["hd"]), np.float32))
    fq, fk, fv = (t.to(torch.bfloat16).to(dev) for t in (fq, fk, fv))
    ftasks = emit_flash_tasks(fl, f["H"], f["bq"], f["bk"], causal=True)
    fstate = make_queue_state(ftasks, f["P"])
    fkw = dict(causal=True, bq=f["bq"], bk=f["bk"])
    res_p, err = _check_lockstep("flash causal", fstate, fq, fk, fv, **fkw)
    errs.append(err)
    fexpect = normalized_out(res_p, ftasks, (f["B"], f["H"], res_p.out.shape[2]))
    errs.append(_check_free("flash causal", fstate, fq, fk, fv, fexpect, ftasks, **fkw))
    return max(errs)


def phase_audit():
    from repro_torch import _build

    audit = _build.fence_audit("ws_attention")
    log(f"[audit] kernels {audit['sass_kernels']}, {audit['sass_instructions']} SASS "
        f"instructions; forbidden SASS {audit['sass']}, forbidden PTX {audit['ptx']}")
    if audit["sass"] or audit["ptx"]:
        raise AssertionError("the scheduler kernel is not fence-free")
    if not audit["sass_kernels"]:
        raise AssertionError("cuobjdump found no kernel in the library")


def phase_serving(dev):
    from repro_torch.configs.llama3_2_3b import CONFIG
    from repro_torch.models import decode_step, decode_step_ws, init_params
    from repro_torch.models.model import Caches
    from repro_torch.models.attention import KVCache
    from repro_torch.pallas_ws import launches, reset_launches
    from repro_torch.serving import ContinuousBatcher, Request, WorkStealingFrontend

    cfg = CONFIG
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serving] {cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}) "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 769, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    max_new = 16
    front = WorkStealingFrontend(
        lambda: ContinuousBatcher(params, cfg, slots=4, capacity=1024), n_replicas=2)
    for rid, p in enumerate(prompts):
        front.submit(0, Request(rid=rid, tokens=p, max_new=max_new))

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = front.run(max_iters=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launches = launches["ws_attention"]

    stats = front.stats()
    steps = sum(s["steps"] for s in stats["batchers"])
    if sorted(done) != list(range(len(prompts))) or front.rejected:
        raise AssertionError(f"completed {sorted(done)}, rejected {sorted(front.rejected)}")
    for r in done.values():
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} produced {r.out}")
    if n_launches != steps * cfg.n_layers or n_launches == 0:
        raise AssertionError(f"ws_attention launches {n_launches} != {steps} steps x {cfg.n_layers}")
    lat = np.concatenate([np.asarray(b.metrics.step_latency_s) for b in front.batchers]) * 1e3
    stolen = stats["totals"]["stolen"]
    if stolen == 0:
        raise AssertionError("replica 1 stole nothing")
    tokens = sum(len(r.out) for r in done.values())
    serving = {
        "requests": len(done), "prompt_tokens": int(lens.sum()), "new_tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall, "decode_steps": steps,
        "step_ms_p50": float(np.percentile(lat, 50)),
        "step_ms_p99": float(np.percentile(lat, 99)),
        "stolen": stolen, "launches": n_launches,
        "per_replica": stats["per_replica"],
    }
    log(f"[serving] {len(done)} requests, {tokens} new tokens in {wall:.2f} s "
        f"({tokens / wall:.2f} tokens/s incl. prefill); {steps} decode steps, "
        f"step p50 {serving['step_ms_p50']:.2f} ms p99 {serving['step_ms_p99']:.2f} ms; "
        f"stolen {stolen}; ws_attention launches {n_launches} == {steps} x {cfg.n_layers}")

    # ws vs dense logits on the same caches: four prompts in a fresh batcher
    b = ContinuousBatcher(params, cfg, slots=4, capacity=1024)
    for rid in range(4):
        assert b.admit(Request(rid=rid, tokens=prompts[rid], max_new=max_new))
    tok = torch.tensor([[r.out[-1]] for r in b.live], device=dev)
    pos = b.pos.copy()

    def clone():
        return Caches(kv=KVCache(b.caches.kv.k.clone(), b.caches.kv.v.clone()))

    V = cfg.vocab_size
    lg_ws = decode_step_ws(params, cfg, clone(), tok, pos)[0][:, :V]
    lg_dense = decode_step(params, cfg, clone(), tok, pos)[0][:, :V]
    if tuple(lg_ws.shape) != (4, V) or not bool(torch.isfinite(lg_ws).all()):
        raise AssertionError(f"ws logits {tuple(lg_ws.shape)} not finite")
    # fp32 yardstick: the same weights and caches widened to fp32, dense step
    params32 = _map(params, lambda t: t.float())
    caches32 = Caches(kv=KVCache(b.caches.kv.k.float(), b.caches.kv.v.float()))
    lg_ref = decode_step(params32, cfg.replace(dtype="float32"), caches32, tok, pos)[0][:, :V]
    torch.cuda.synchronize()
    del params32, caches32
    err_ws = float((lg_ws - lg_ref).abs().max())
    err_dense = float((lg_dense - lg_ref).abs().max())
    diff = float((lg_ws - lg_dense).abs().max())
    scale = float(lg_ref.abs().max())
    agree = int((lg_ws.argmax(-1) == lg_dense.argmax(-1)).sum())
    log(f"[serving] logits vs the fp32 step (max |logit| {scale:.4g}): ws {err_ws:.4g}, "
        f"dense bf16 {err_dense:.4g} (ws <= {LOGIT_SLACK} x dense); ws vs dense "
        f"{diff:.4g}; argmax agree {agree}/4")
    if not err_ws <= LOGIT_SLACK * err_dense:
        raise AssertionError("ws logits stray further from the fp32 step than the dense step's")
    del b, params
    torch.cuda.empty_cache()
    serving.update(logit_err_ws=err_ws, logit_err_dense=err_dense, logit_ws_vs_dense=diff,
                   logit_scale=scale, argmax_agree=agree)
    return serving, n_launches


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _event_ms(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_times(dev):
    import torch.nn.functional as F

    from repro_torch.pallas_ws import (
        decode_queue_state, plain_ws_grid, to_device,
    )
    from repro_torch.pallas_ws import kernel as K

    c = DECODE
    lengths, q, k, v = decode_inputs(np.random.default_rng(SEED), dev)
    state = to_device(decode_queue_state(lengths, c["H"], c["S"], n_programs=c["P"],
                                         bk=c["bk"]), dev)
    q4 = q[:, :, None, :]
    out = torch.zeros((c["B"], c["H"], 1, c["hd"]), dtype=torch.float32, device=dev)
    n_tasks = state.n_tasks
    times = {}
    for mode in ("free", "lockstep"):
        rounds = K.default_rounds(decode_queue_state(lengths, c["H"], c["S"],
                                                     n_programs=c["P"], bk=c["bk"]), True)
        n = 20 if mode == "free" else 3
        arrs = []
        for _ in range(n + 2):
            a = {x: getattr(state, x).clone() for x in ("head", "local_head", "taken", "remaining")}
            a.update(tasks=state.tasks, tail=state.tail)
            for x in ("clock", "work", "steals", "scanned"):
                a[x] = torch.zeros(c["P"], dtype=torch.int32, device=dev)
            a["mult"] = torch.zeros((c["P"], n_tasks) if mode == "free" else (n_tasks,),
                                    dtype=torch.int32, device=dev)
            arrs.append(a)

        def launch(i, mode=mode, rounds=rounds):
            K._launch_cuda(arrs[i], q4, k, v, out, mode=mode, rounds=rounds, steal=True,
                           policy="cost", compress=False, causal=False, bq=1, bk=c["bk"],
                           scale=c["hd"] ** -0.5, g=c["H"] // c["Hkv"], n_tasks=n_tasks)

        launch(n)      # warm-up
        launch(n + 1)
        torch.cuda.synchronize()
        times[mode] = _event_ms(launch, n)

    def plain(_):
        plain_ws_grid(state, q4, k, v, torch.zeros_like(out), bq=1, bk=c["bk"],
                      causal=False, scale=c["hd"] ** -0.5, mode="free")

    plain(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    mask = (torch.arange(c["S"], device=dev)[None, :] < torch.as_tensor(lengths, device=dev)[:, None])
    mask = mask[:, None, None, :]
    g = c["H"] // c["Hkv"]
    k_rep, v_rep = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)

    def sdpa(_):
        F.scaled_dot_product_attention(q4, k_rep, v_rep, attn_mask=mask)

    sdpa(0)
    torch.cuda.synchronize()
    library_ms = _event_ms(sdpa, 20)

    live = int(np.asarray(lengths).sum())
    kv_bytes = 2 * live * c["Hkv"] * c["hd"] * 2            # K and V, bf16, each row once
    io_bytes = c["B"] * c["H"] * c["hd"] * (2 + 4)          # q in (bf16), out (fp32)
    task_bytes = n_tasks * 8 * 4
    byte_ms = (kv_bytes + io_bytes + task_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * live * c["H"] * c["hd"] / BF16_FLOPS * 1e3
    bound_ms = max(byte_ms, ops_ms)
    log(f"[times] decode B={c['B']} H={c['H']} S={c['S']} lengths {list(map(int, lengths))}: "
        f"kernel free {times['free']:.4f} ms, lockstep {times['lockstep']:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({'bytes' if byte_ms >= ops_ms else 'operations'}: "
        f"{kv_bytes + io_bytes + task_bytes} B), plain version {plain_ms:.2f} ms, "
        f"SDPA yardstick {library_ms:.4f} ms")
    return dict(ms=times["free"], lockstep_ms=times["lockstep"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes" if byte_ms >= ops_ms else "operations",
                library_ms=library_ms)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,parity,audit,serving,times",
                    help="comma-separated subset of the phases (all by default)")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_all = time.perf_counter()
    phase_build()
    max_err = phase_parity(dev) if "parity" in phases else None
    if "audit" in phases:
        phase_audit()
    serving, n_launches = phase_serving(dev) if "serving" in phases else (None, None)
    times = phase_times(dev) if "times" in phases else {}
    if phases != {"build", "parity", "audit", "serving", "times"}:
        log(f"[done] phases {sorted(phases)} passed; a partial run prints no result")
        return 3
    kernel = {
        "name": "ws_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ws_attention.cu",
        "replaces": "src/repro/pallas_ws/kernel.py:334",
        "launches": n_launches,
        "max_abs_err": max_err,
        **times,
    }
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    log("[serving] " + json.dumps(serving))
    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
