"""Measure how fast the ZeRO layer's collectives move bytes between 2 gloo
ranks that share one CUDA card, split over 1, 2, 4 and 8 lanes (process
groups of the same ranks), to choose ``repro_torch.launch.mesh.LANES``:

    python3 gloo_lanes_probe.py

Each rank calls ``repro_torch.models.fsdp``'s own row all-gather and
reduce-scatter on CUDA tensors of a 512 MiB bf16 and a 1 GiB fp32 whole
tensor (256 Mi elements; each rank holds half), once to warm and then
TIMED times, each after a barrier, for every lane count.  It prints the
card's ``nvidia-smi`` name and power limit, then one JSON object: GB/s of
the whole tensor a call (the median call), by op, dtype and lanes."""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
import torch  # noqa: E402

N = 256 << 20           # elements of the whole tensor
COLS = 1024
LANE_COUNTS = (1, 2, 4, 8)
TIMED = 3


def _probe(rank):
    import torch.distributed as dist

    from repro_torch.launch.mesh import Axis
    from repro_torch.models import fsdp

    groups = [dist.new_group([0, 1]) for _ in range(max(LANE_COUNTS))]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        shard = torch.ones((N // 2 // COLS, COLS), dtype=dt, device="cuda")
        whole = torch.ones((N // COLS, COLS), dtype=dt, device="cuda")
        for lanes in LANE_COUNTS:
            ax = Axis("data", groups[0], 2, rank, tuple(groups[1:lanes]))
            for op, fn in (("all_gather", lambda: fsdp._gather_rows(shard, ax)),
                           ("reduce_scatter", lambda: fsdp._scatter_rows(whole, ax))):
                fn()
                secs = []
                for _ in range(TIMED):
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    dist.barrier()
                    secs.append(time.perf_counter() - t0)
                out[f"{op} {str(dt)[6:]} lanes {lanes}"] = (
                    N * whole.element_size() / sorted(secs)[TIMED // 2] / 1e9)
    return out


def main():
    from repro_torch.launch.mesh import run_ranks

    if not torch.cuda.is_available():
        print("gloo_lanes_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rates = run_ranks(_probe, 2, device="cuda", timeout=600)[0]
    print(card.strip())
    print(json.dumps({"gb_per_s_of_the_whole_tensor": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
