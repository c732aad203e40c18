"""Self-check of the mesh dispatch over N gloo ranks: seeded skewed routings
through :func:`~repro_torch.mesh_ws.expert_ffn_mesh_ws` on every rank,
held to the no-drop oracle (port of ``repro/mesh_ws/selfcheck.py``)::

    python -m repro_torch.mesh_ws.selfcheck --devices 4
    python -m repro_torch.mesh_ws.selfcheck --devices 8 --seeds 3 --device cpu

spawns N ranks on this host (:func:`~repro_torch.launch.mesh.run_ranks`),
all on ``cuda:0`` (the expert kernel; the ranks share the card), the
default, or on the CPU (the kernels' plain versions) when asked.
``launch/train.py --devices N`` reuses :func:`run_checks` after training.

The reference asserts bit-identity with the oracle; here a tile's products
and the oracle's einsums sum in other orders, so each rank's output is held
to the oracle within ``TOL`` (abs + rel), and the ranks to each other bit
for bit (every sum has one nonzero contributor a slot).
"""

import argparse
import json
import sys

TOL = 1e-5


def skewed_routing(rng, n_tokens: int, n_experts: int, top_k: int,
                   hot_frac: float = 0.75, hot_experts: int | None = None):
    """Seeded routing with a hot expert block (device 0's shard by
    default): ``hot_frac`` of tokens route entirely inside the hot block,
    the rest uniformly, the load shape cross-device stealing exists for.
    numpy ``(idx [T, k] int32, gates [T, k] float32)``."""
    import numpy as np

    if hot_experts is None:
        hot_experts = max(1, n_experts // 8)
    idx = np.zeros((n_tokens, top_k), np.int32)
    for t in range(n_tokens):
        pool = hot_experts if t < int(n_tokens * hot_frac) else n_experts
        idx[t] = rng.choice(pool, size=top_k, replace=False)
    gates = rng.random((n_tokens, top_k), dtype=np.float32)
    gates = gates / gates.sum(1, keepdims=True)
    return idx, gates


def _rank_checks(rank, n_devices, seeds, device, dims):
    """One rank's rows: the mesh dispatch on every seed against the oracle."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.mesh_ws import expert_ffn_mesh_ws
    from repro_torch.moe_ws import expert_ffn_nodrop_ref

    n_tokens, n_experts, top_k, d, f, bt, n_programs = dims
    dev = torch.device(device)
    mesh = make_expert_mesh(n_experts, n_devices)
    El = n_experts // n_devices
    mine = slice(rank * El, (rank + 1) * El)
    rows = []
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        idx, gates = skewed_routing(rng, n_tokens, n_experts, top_k)
        x = rng.standard_normal((n_tokens, d), dtype=np.float32)
        w = [0.1 * rng.standard_normal(s, dtype=np.float32)
             for s in ((n_experts, d, f), (n_experts, d, f), (n_experts, f, d))]
        x, *w = (torch.from_numpy(a).to(dev) for a in (x, *w))
        y, tele = expert_ffn_mesh_ws(idx, gates, x, *(t[mine] for t in w), mesh=mesh, bt=bt,
                                     n_programs=n_programs, return_telemetry=True)
        ref = expert_ffn_nodrop_ref(idx, gates, x, *w)
        y, ref, tele = y.cpu().numpy(), ref.cpu().numpy(), tele.cpu().numpy()
        err = float(np.abs(y - ref).max())
        rows.append({
            "seed": seed,
            "max_abs_err": err,
            "within_tol": bool(err <= TOL + TOL * float(np.abs(ref).max())),
            "devices_stole": int(tele[:, 5].sum()),
            "tiles_stolen": int(tele[:, 6].sum()),
            "y": y,
        })
    return rows


def run_checks(n_devices: int, seeds: int, *, n_tokens: int = 24, n_experts: int = 16,
               top_k: int = 2, d: int = 16, f: int = 32, bt: int = 4, n_programs: int = 2,
               device=None):
    """Spawn ``n_devices`` gloo ranks (on ``device``: ``"cuda"``, the
    default, every rank on ``cuda:0`` and raising without a card, or
    ``"cpu"``), run the mesh dispatch on ``seeds`` seeded skewed routings
    in each, and return rank 0's rows (``seed``,
    ``max_abs_err``, ``within_tol``, ``devices_stole``, ``tiles_stolen``,
    ``ranks_equal``: every rank's output bit-equal to rank 0's).  d and f are
    multiples of 16, as the expert kernel needs."""
    import numpy as np

    from repro_torch._device import resolve_device
    from repro_torch.launch.mesh import run_ranks

    device = resolve_device(device).type
    if device == "cuda":
        from repro_torch import _build

        _build.load("ws_expert")   # one build before the ranks load it
    dims = (n_tokens, n_experts, top_k, d, f, bt, n_programs)
    per_rank = run_ranks(_rank_checks, n_devices, n_devices, seeds, device, dims, device=device)
    rows = []
    for i, row in enumerate(per_rank[0]):
        row = dict(row)
        y = row.pop("y")
        row["ranks_equal"] = all(np.array_equal(r[i]["y"], y) for r in per_rank)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the ranks run (cuda unless told otherwise)")
    args = ap.parse_args(argv)
    rows = run_checks(args.devices, args.seeds, device=args.device)
    ok = all(r["within_tol"] and r["ranks_equal"] for r in rows)
    stole = any(r["devices_stole"] for r in rows)
    print(json.dumps({"devices": args.devices, "device": args.device or "cuda", "ok": ok,
                      "any_steals": stole, "rows": rows}, indent=2))
    if not ok:
        print("FAIL: mesh dispatch diverged from the no-drop oracle", file=sys.stderr)
        return 1
    if not stole:
        print("FAIL: no seed exercised a cross-device steal", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
