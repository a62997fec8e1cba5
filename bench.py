"""Benchmark: one forward+adjoint application of the flagship operator on the GPU.

Prints progress on stderr and ONE JSON line on stdout:

* value: GVox/s of one forward+adjoint application of the flagship
  `SpectroSigRLSCT` (voxels = 2 × cube size per application), timed on the
  host clock around work that ends in `block_until_ready` (median of
  `SURFH_BENCH_REPS`, default 10);
* device: platform, device_kind and count as JAX reports them, and the
  card's `name, power.limit` from nvidia-smi;
* setup_s: host table build, table upload, compile of each program;
* gemm_flops_per_app (every `dot_general`, counted from the jaxpr's shapes)
  and bytes_per_app_modeled (XLA's cost analysis of the compiled programs),
  and their shares of the device's published peaks (`PEAKS`, keyed by
  device_kind) over the device-busy time;
* device_ms_per_app / device_busy_frac from a profiler trace of a few
  applications (the union of kernel intervals on the GPU planes);
* peak_bytes_in_use;
* vs_baseline: speedup over the recorded float64 NumPy reference path
  (`baseline_cpu.json`; BASELINE.md).

Presets (`SURFH_BENCH_PRESET`): flagship (default) — 12 MIRI bands × 4
dither pointings, 501² grid, ~3879-λ cube (scripts/main_fusion.py:34-39) in
window-local tables-as-args mode; small/medium/large — synthetic problems
in the same configuration.

There is no CPU path: without a GPU the bench exits non-zero.
"""

import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PRESETS = {
    "small": dict(im_size=81, n_lambda=60, n_tpl=4, n_channels=2, n_pointings=2, n_slit=5),
    "medium": dict(im_size=251, n_lambda=250, n_tpl=4, n_channels=2, n_pointings=2, n_slit=11),
    "large": dict(im_size=501, n_lambda=600, n_tpl=4, n_channels=4, n_pointings=4, n_slit=17),
}

_BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "baseline_cpu.json")

# Published peaks keyed by JAX's device_kind.  No program reaches them; they
# are the denominators of the roofline shares.  The flagship path runs its
# contractions in full f32 (precision="highest"), outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense "
                  "(no sparsity), at the 700 W power limit",
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of `device_kind`; a device not in `PEAKS` is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def device_busy(profile) -> dict:
    """Device busy time of a `jax.profiler.ProfileData` trace.

    Busy is the union of the event intervals on the lines of every
    `/device:GPU:N` plane (its stream lines carry one event per kernel,
    memset and copy); the window runs from the first event's start to the
    last one's end.  Host planes are ignored."""
    intervals = sorted(
        (ev.start_ns, ev.start_ns + ev.duration_ns)
        for plane in profile.planes
        if plane.name.startswith("/device:GPU:")
        for line in plane.lines
        for ev in line.events
    )
    if not intervals:
        raise RuntimeError("the trace holds no GPU events")
    busy = 0.0
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return {"busy_ns": busy, "window_ns": cur_end - intervals[0][0],
            "n_events": len(intervals)}


def trace_device_ms(jax, run_once, n_apps: int, trace_dir: str) -> dict:
    """Profile `run_once` (n_apps applications); device busy ms per app."""
    import glob

    shutil.rmtree(trace_dir, ignore_errors=True)
    jax.profiler.start_trace(trace_dir)
    try:
        run_once()
    finally:
        jax.profiler.stop_trace()
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))
    if not paths:
        raise RuntimeError(f"no xplane trace written under {trace_dir}")
    stats = device_busy(jax.profiler.ProfileData.from_file(paths[-1]))
    return {
        "device_ms_per_app": stats["busy_ns"] / 1e6 / n_apps,
        "device_busy_frac": stats["busy_ns"] / stats["window_ns"],
        "trace_events": stats["n_events"],
    }


def _xla_cost(compiled, key):
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca[key])


def dot_flops(jaxpr) -> float:
    """FLOPs of every `dot_general` in a (closed) jaxpr, from its shapes:
    2 · batch · lhs-free · rhs-free · contracted.  Sub-jaxprs count once per
    execution (a scan's body `length` times, a cond's costliest branch).
    XLA's GPU cost analysis cannot give this: the compiled program hands its
    GEMMs to cuBLAS custom calls, which it does not count."""
    import math

    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            ls, rs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            contracted = math.prod(ls[i] for i in lc)
            batch = math.prod(ls[i] for i in lb)
            lfree = math.prod(d for i, d in enumerate(ls) if i not in (*lc, *lb))
            rfree = math.prod(d for i, d in enumerate(rs) if i not in (*rc, *rb))
            total += 2.0 * batch * lfree * rfree * contracted
            continue
        subs = [v for v in eqn.params.values()
                if hasattr(v, "eqns") or hasattr(v, "jaxpr")]
        branches = eqn.params.get("branches")
        if branches:
            total += max(dot_flops(b) for b in branches)
        for sub in subs:
            total += dot_flops(sub) * eqn.params.get("length", 1)
    return total


def _baseline(preset, t_app):
    if os.environ.get("SURFH_BENCH_SKIP_BASELINE"):
        return {"vs_baseline": None}
    with open(_BASELINE_FILE) as fh:
        recorded = json.load(fh)
    if preset not in recorded:
        return {"vs_baseline": None,
                "baseline_config": f"no recorded baseline for preset {preset!r}"}
    rec = recorded[preset]
    return {"vs_baseline": float(rec["seconds"]) / t_app,
            "baseline_s": float(rec["seconds"]),
            "baseline_config": rec.get("config", "recorded")}


def build_model(preset: str, wblur_impl: str):
    if preset == "flagship":
        from surfh_tpu.simulation.flagship import make_flagship_model

        return make_flagship_model(wblur_impl=wblur_impl)
    from surfh_tpu.simulation.synthetic import make_model

    return make_model(window_local=True, psf_stamps=True, conv_impl="matmul",
                      conv_freq_rtol=1e-6, conv_rank_rtol=1e-7,
                      wblur_impl=wblur_impl, **PRESETS[preset])


def main() -> int:
    import jax

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    _log(f"device {device}")
    if device["platform"] != "gpu":
        _log("no GPU: the bench measures the GPU only")
        return 2

    from surfh_tpu.utils.cache import enable_compile_cache
    from surfh_tpu.utils.profiling import card_info

    peaks = device_peaks(device["kind"])
    card = card_info()
    _log(f"card {card}; compile cache {enable_compile_cache()}")
    result = measure(os.environ.get("SURFH_BENCH_PRESET", "flagship"),
                     int(os.environ.get("SURFH_BENCH_REPS", "10")), peaks)
    print(json.dumps({**result, "device": device, "card": card}), flush=True)
    return 0


def measure(preset: str, reps: int, peaks: dict) -> dict:
    """Build, upload, compile and time one preset on the default device."""
    import jax
    import jax.numpy as jnp

    from surfh_tpu.utils.cache import cache_dir

    setup_s = {}

    t0 = time.perf_counter()
    model, setup = build_model(preset, os.environ.get("SURFH_WBLUR_IMPL", "dense"))
    model.host_tables()
    setup_s["host_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = model.device_tables()
    jax.block_until_ready(tables)
    setup_s["upload"] = time.perf_counter() - t0

    x_spec = jax.ShapeDtypeStruct(model.ishape, jnp.float32)
    y_spec = jax.ShapeDtypeStruct(model.oshape, jnp.float32)
    programs = {}
    for name, fn, spec in (("fwd", model.forward_fn, x_spec),
                           ("adj", model.adjoint_fn, y_spec)):
        t0 = time.perf_counter()
        programs[name] = jax.jit(fn).lower(spec, tables).compile()
        setup_s[f"compile_{name}"] = time.perf_counter() - t0
    fwd, adj = programs["fwd"], programs["adj"]
    _log(f"setup {setup_s}")

    maps = jnp.asarray(setup["maps"], jnp.float32)

    def run(n):
        for _ in range(n):
            g = adj(fwd(maps, tables), tables)
        jax.block_until_ready(g)

    run(2)  # first executions
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(1)
        times.append(time.perf_counter() - t0)
    t_app = float(np.median(times))
    _log(f"application times (s): {times}")

    flops = (dot_flops(jax.make_jaxpr(model.forward_fn)(x_spec, tables))
             + dot_flops(jax.make_jaxpr(model.adjoint_fn)(y_spec, tables)))
    bytes_modeled = sum(_xla_cost(c, "bytes accessed")
                        for c in programs.values())
    n_trace = 3
    traced = trace_device_ms(jax, lambda: run(n_trace), n_trace,
                             cache_dir("bench_trace"))
    dev_s = traced["device_ms_per_app"] / 1e3
    stats = jax.devices()[0].memory_stats() or {}

    return {
        "metric": f"fwd+adjoint cube-op throughput ({preset})",
        "value": 2.0 * float(np.prod(model.cube_shape)) / t_app / 1e9,
        "unit": "GVox/s",
        "preset": preset,
        "t_app_s": t_app,
        "t_app_spread_s": [min(times), max(times)],
        "setup_s": setup_s,
        "gemm_flops_per_app": flops,
        "bytes_per_app_modeled": bytes_modeled,
        "tflops": flops / t_app / 1e12,
        # shares against the published peaks, over the device-busy time
        "f32_flop_share": flops / dev_s / peaks["f32_flops"],
        "hbm_share_modeled": bytes_modeled / dev_s / peaks["hbm_bytes_per_s"],
        "peaks_source": peaks["source"],
        **traced,
        "host_gap_ms_per_app": max(t_app * 1e3 - traced["device_ms_per_app"], 0.0),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "cube_shape": list(model.cube_shape),
        "n_channels": len(model.channels),
        "n_pointings": len(model.pointings[0]),
        **_baseline(preset, t_app),
    }


if __name__ == "__main__":
    sys.exit(main())
