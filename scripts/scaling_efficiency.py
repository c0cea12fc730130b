"""Chain-parallel scaling efficiency across device counts.

BASELINE.md's protocol measures throughput "at 1 chip, 1 host, and N>=2
hosts" with a >=80% efficiency target (SURVEY 5.8).  Chains are
embarrassingly parallel (a shard_map'd leading axis with no collectives
on the hot path), so the expected curve is ~100%; the point of this
harness is to DEMONSTRATE that and to catch any accidental shard_map
serialization.  With ``SCALING_PLATFORM=gpu`` it runs on the host's
GPUs; by default it uses a virtual CPU mesh
(``--xla_force_host_platform_device_count``).

Protocol: a fixed per-chain workload (config-1-like Gaussian BART,
chains = device count, sharded over the "chains" mesh axis); efficiency
= (chain-draws/s at D devices) / (D x chain-draws/s at 1 device).

On the virtual CPU mesh the D "devices" share the box's physical cores,
so past D = cores the DEVICE-normalized efficiency necessarily falls —
the binding resource is cores, not the sharding.  The script therefore
also reports efficiency against the core-aware ideal
(base x min(D, cores)); >= 1.0 there means shard_map adds no
serialization, which is what transfers to real chips (where each
"device" has its own compute and the device-normalized number applies).

Usage:
    SCALING_PLATFORM=gpu python scripts/scaling_efficiency.py --devices 1 2 4
    python scripts/scaling_efficiency.py [--devices 1 2 4 8]
      [--processes N]   # optional jax.distributed multi-process run

Writes one JSON line per device count and a summary.  For the
2-process rehearsal see tests/test_multihost.py (correctness); run
this script under two processes with --processes 2 for its throughput.
"""

import argparse
import json
import os
import sys
import time

PLATFORM = os.environ.get("SCALING_PLATFORM", "cpu")  # "cpu" or "gpu"
if PLATFORM == "cpu":
    if "xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

from pymc_bart_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402


def run_point(n_devices, tune, draws, n, m, particles):
    import pymc_bart_tpu as pmb
    from pymc_bart_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, 10)).astype(np.float32)
    f = (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
         + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])
    Y = (f + rng.normal(0, 1.0, n)).astype(np.float32)

    mesh = make_mesh(n_chain_shards=n_devices,
                     devices=jax.devices()[:n_devices])
    timings = {}
    with pmb.Model():
        mu = pmb.BART("mu", X, Y, m=m)
        sigma = pmb.HalfNormal("sigma", 1.0)
        pmb.Normal("y", mu, sigma, observed=Y)
        pmb.sample(tune=tune, draws=draws, chains=n_devices,
                   random_seed=0, mesh=mesh, store_trees=False,
                   chunk_size=max(draws // 4, 1), timings=timings,
                   progressbar=False, num_particles=particles)
    secs, sizes = timings["draw_chunk_seconds"], timings["draw_chunk_sizes"]
    per_draw = (sum(secs[1:]) / sum(sizes[1:]) if len(secs) > 1
                else secs[0] / sizes[0])
    return n_devices / per_draw  # chain-draws/s (1 chain per device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--tune", type=int, default=50)
    ap.add_argument("--draws", type=int, default=200)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--particles", type=int, default=10)
    ap.add_argument("--processes", type=int, default=0,
                    help="initialize jax.distributed with this many "
                         "processes (set PROC_ID per process)")
    args = ap.parse_args()
    setup_compile_cache()
    if jax.default_backend() != PLATFORM:
        sys.exit(f"SCALING_PLATFORM={PLATFORM} but JAX runs on "
                 f"{jax.default_backend()}")

    if args.processes > 1:
        from pymc_bart_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(
            coordinator_address=os.environ.get("COORD", "127.0.0.1:9911"),
            num_processes=args.processes,
            process_id=int(os.environ.get("PROC_ID", "0")))

    avail = len(jax.devices())
    cores = os.cpu_count() or 1
    virtual = jax.devices()[0].platform == "cpu"
    rows = []
    base = None
    for d in args.devices:
        if d > avail:
            print(f"# skipping D={d}: only {avail} devices", file=sys.stderr)
            continue
        rate = run_point(d, args.tune, args.draws, args.n, args.m,
                         args.particles)
        if base is None:
            base = rate
        eff = rate / (base * d)
        ideal = base * (min(d, cores) if virtual else d)
        row = {"devices": d, "chain_draws_per_s": round(rate, 1),
               "efficiency_vs_1dev": round(eff, 3),
               "efficiency_vs_core_ideal": round(rate / ideal, 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    key = "efficiency_vs_core_ideal" if virtual else "efficiency_vs_1dev"
    ok = all(r[key] >= 0.8 for r in rows[1:])
    print(json.dumps({"summary": rows, "physical_cores": cores,
                      "virtual_mesh": virtual, "criterion": key,
                      "meets_baseline_80pct_target": ok}))


if __name__ == "__main__":
    main()
