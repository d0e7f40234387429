"""North-star benchmark: register + sigma-clip stack of a 100-frame
4096x4096 mono sequence, device-resident, on one GPU.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "frames/sec/chip",
     "runs": [...], "device": {"platform": ..., "kind": ..., "count": ...}}

``value`` is the median over BENCH_RUNS runs of BENCH_REPEATS batches,
each batch synced with ``block_until_ready``. The run fails when JAX finds
no GPU: a number from another device is not this metric.

Env: BENCH_FRAMES / BENCH_SIZE (workload), BENCH_RUNS, BENCH_REPEATS.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.join(ROOT, "siril-0.9")
if _PKG not in sys.path:
    sys.path.insert(0, _PKG)


def main() -> int:
    from siriltpu.utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    nframes = int(os.environ.get("BENCH_FRAMES", "100"))
    size = int(os.environ.get("BENCH_SIZE", "4096"))
    nruns = max(int(os.environ.get("BENCH_RUNS", "3")), 1)
    reps = max(int(os.environ.get("BENCH_REPEATS", "10")), 1)

    from siriltpu.pipelines.register_stack import RegisterStackBench
    bench = RegisterStackBench(size=size, nframes=nframes)
    runs = sorted(bench.run(repeats=reps) for _ in range(nruns))
    print(json.dumps({
        "metric": f"register+sigma-clip-stack {nframes}x{size}x{size} mono",
        "value": runs[len(runs) // 2],
        "unit": "frames/sec/chip",
        "runs": runs,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
