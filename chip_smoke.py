"""Smoke run of the flagship MRS fusion operator on the GPU.

Drives the main path once through its normal entry points, at the full
flagship width (12 MIRI bands × 4 dither pointings × 501² sky grid ×
3879-λ cube, `window_local` tables on the device), and checks every result:

1. device      platform, device kind, count; the card's name and power limit
2. build       host table build, upload, compile of the forward and adjoint
3. apply       three forward+adjoint applications, finiteness, placement,
               the f32 dot test
4. solve       five dispatch-mode `lcg` iterations on data simulated from
               the seed
5. parity      one band at real width vs the float64 NumPy reference
6. wblur       the banded spectral blur vs the dense GEMM on one real band

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # channel-sharded flagship on four
                                       # GPUs vs the same code on one

Each phase prints its seconds; the last line is one JSON object
{"ok": true, "device": {...}}.  There is no CPU path: without a GPU the
script exits non-zero before any phase runs.  The phase functions take
their sizes as arguments so the tests can run them at tiny sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 19940407

# Tolerances, each with the precision it holds at.  Every f32 contraction
# on the flagship path pins precision="highest" (core/precision.py), so on
# the GPU they run in full f32, never TF32; a TF32 leak shows as ~1e-3.
DOT_RTOL = 1e-4  # f32 exact transpose pair: only f32 rounding of ~1e8-term sums
# f32 vs float64 of the whole forward, max-normalized, at real width: the
# H100 measures 1.2e-6 (forward) and 7.6e-7 (adjoint) on band 1c at 501²;
# TF32 operands (~1e-3 each) would land far above.  Grids much smaller than
# the field of view clamp it onto border pixels with large signed gather
# weights, so tiny test sizes pass a looser bound.
PARITY_F32_RTOL = 1e-4
F32_RTOL = 1e-5  # f32 rounding of one GEMM contraction (max-normalized)
SHARD_RTOL = 1e-4  # f32; psum over 4 devices re-associates the adjoint sum
SHARD_CG_RTOL = 1e-3  # the same, carried through 5 CG iterations


def _log(msg: str) -> None:
    print(msg, flush=True)


def _phase(name: str, t0: float) -> None:
    _log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def _rel_err(got, ref) -> tuple:
    """(max |got-ref| / max |ref|, ‖got-ref‖₂ / ‖ref‖₂) in float64."""
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    diff = got - ref
    return (
        float(np.abs(diff).max() / np.abs(ref).max()),
        float(np.linalg.norm(diff) / np.linalg.norm(ref)),
    )


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _on_default_device(arr) -> bool:
    import jax

    return set(arr.devices()) == {jax.devices()[0]}


def _peak_bytes(device) -> str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not reported"
    return str(stats["peak_bytes_in_use"])


def _memory_analysis(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys} if ma is not None else {}


def _median_s(fn, *args, reps: int) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# --------------------------------------------------------------------------
# 1. device
def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# --------------------------------------------------------------------------
# 2. build
@dataclasses.dataclass
class Flagship:
    model: object
    setup: dict
    tables: object
    fwd: object  # compiled forward  (maps, tables) -> flat data
    adj: object  # compiled adjoint  (flat data, tables) -> maps


def phase_build(npix=501, bands=None, n_pointings=4, lambda_subsample=3,
                conv_impl="auto", seed=SEED) -> Flagship:
    import jax
    import jax.numpy as jnp

    from surfh_tpu.simulation.flagship import make_flagship_model

    t0 = time.perf_counter()
    model, setup = make_flagship_model(
        conv_impl=conv_impl, npix=npix, bands=bands,
        n_pointings=n_pointings, lambda_subsample=lambda_subsample, seed=seed,
    )
    host = model.host_tables()
    host_mb = sum(np.asarray(l).nbytes
                  for l in jax.tree_util.tree_leaves(host)) / 1e6
    _log(f"model: {len(model.channels)} bands x {len(model.pointings[0])} "
         f"pointings, cube {model.cube_shape}, maps {model.ishape}, "
         f"data {model.oshape}, conv {model.conv_impl}, "
         f"pointing scan {[c.pointing_scan for c in model.channels][0]}")
    _log(f"host build: {time.perf_counter() - t0:.3f} s ({host_mb:.1f} MB of tables)")

    t1 = time.perf_counter()
    tables = model.device_tables()
    jax.block_until_ready(tables)
    _log(f"table upload + materialize: {time.perf_counter() - t1:.3f} s")

    x_spec = jax.ShapeDtypeStruct(model.ishape, jnp.float32)
    y_spec = jax.ShapeDtypeStruct(model.oshape, jnp.float32)
    t1 = time.perf_counter()
    fwd = jax.jit(model.forward_fn).lower(x_spec, tables).compile()
    _log(f"compile forward: {time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    adj = jax.jit(model.adjoint_fn).lower(y_spec, tables).compile()
    _log(f"compile adjoint: {time.perf_counter() - t1:.3f} s")
    _log(f"memory_analysis forward: {json.dumps(_memory_analysis(fwd))}")
    _log(f"memory_analysis adjoint: {json.dumps(_memory_analysis(adj))}")
    return Flagship(model, setup, tables, fwd, adj)


# --------------------------------------------------------------------------
# 3. apply
def phase_apply(fl: Flagship, n_apps=3, seed=SEED) -> dict:
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(fl.setup["maps"], jnp.float32)
    times = []
    for _ in range(n_apps):
        t0 = time.perf_counter()
        y = fl.fwd(x, fl.tables)
        g = fl.adj(y, fl.tables)
        jax.block_until_ready(g)
        times.append(time.perf_counter() - t0)
    _log(f"forward+adjoint applications: {[round(t * 1e3, 3) for t in times]} ms")
    _log(f"peak_bytes_in_use: {_peak_bytes(jax.devices()[0])}")
    for name, arr in (("forward", y), ("adjoint", g)):
        _check(_on_default_device(arr), f"{name} output is not on the default device")
        _check(bool(np.isfinite(np.asarray(arr)).all()), f"{name} output not finite")
    _check(y.shape == fl.model.oshape and g.shape == fl.model.ishape,
           "output shapes")

    rng = np.random.default_rng(seed)
    xr = rng.standard_normal(fl.model.ishape).astype(np.float32)
    yr = rng.standard_normal(fl.model.oshape).astype(np.float32)
    hx = np.asarray(fl.fwd(jnp.asarray(xr), fl.tables), np.float64)
    hty = np.asarray(fl.adj(jnp.asarray(yr), fl.tables), np.float64)
    lhs = float(np.vdot(hx, yr.astype(np.float64)))
    rhs = float(np.vdot(xr.astype(np.float64), hty))
    rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    _log(f"dot test (float32, precision=highest): <Hx,y>={lhs:.9e} "
         f"<x,Hty>={rhs:.9e} rel={rel:.3e} tol={DOT_RTOL:g} "
         "(exact transpose pair; the gap is f32 rounding only)")
    _check(rel <= DOT_RTOL, f"dot test rel {rel:.3e} > {DOT_RTOL}")
    return {"app_s": times, "dot_rel": rel}


# --------------------------------------------------------------------------
# 4. solve
def phase_solve(fl: Flagship, n_iter=5, mu_reg=5e3, seed=SEED) -> np.ndarray:
    import jax.numpy as jnp

    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    y = np.asarray(fl.fwd(jnp.asarray(fl.setup["maps"], jnp.float32),
                          fl.tables))
    rng = np.random.default_rng(seed + 1)
    y = y + rng.normal(0.0, 1e-2 * float(y.std()), y.shape).astype(y.dtype)
    crit = QuadCriterion_MRS(1.0, y, fl.model, mu_reg)
    res = crit.run_method("lcg", maximum_iterations=n_iter,
                          solver_loop="dispatch")
    g = np.asarray(res.grad_norm)
    _log(f"lcg dispatch, {res.n_iter} iterations, grad norms: "
         f"{[f'{v:.6e}' for v in g]}")
    _check(res.n_iter == n_iter, "iteration count")
    _check(bool(np.isfinite(g).all()), "gradient norm not finite")
    _check(bool(g[-1] < g[0]), "gradient norm did not decrease")
    _check(bool(np.isfinite(res.x).all()), "solution not finite")
    return g


# --------------------------------------------------------------------------
# 5. parity
def phase_parity(band="1c", npix=501, n_pointings=1, lambda_subsample=3,
                 f32_rtol=PARITY_F32_RTOL, seed=SEED):
    """GPU forward/adjoint (f32, λ-rank matmul conv) of one band at real
    width vs `core.numpy_ref` in float64 on the host.  Returns the model."""
    import jax.numpy as jnp

    from surfh_tpu.core import numpy_ref
    from surfh_tpu.simulation.flagship import (
        make_flagship_model, make_flagship_setup)

    setup = make_flagship_setup(
        npix=npix, bands=[band], n_pointings=n_pointings,
        lambda_subsample=lambda_subsample, seed=seed, build_sotf=True,
    )
    model, _ = make_flagship_model(setup, conv_impl="matmul")
    rng = np.random.default_rng(seed + 2)
    x = setup["maps"]
    yr = rng.standard_normal(model.oshape)
    y_dev = np.asarray(model.forward(jnp.asarray(x, jnp.float32)))
    a_dev = np.asarray(model.adjoint(jnp.asarray(yr, jnp.float32)))
    y_ref = numpy_ref.spectro_forward(model, x, sotf=setup["sotf"])
    a_ref = numpy_ref.spectro_adjoint(model, yr, sotf=setup["sotf"])

    sup = model.conv_supports[0]
    tail = float(sup.get("rank_tail", 0.0))
    dropped = float(sup["dropped_rel"])
    # PERF.md: the rank error is the SVD tail times a geometry factor < 10;
    # the frequency truncation drops OTF bins below dropped_rel of the peak
    tol = 10.0 * (tail + dropped) + f32_rtol
    _log(f"parity band {band}: {len(model.pointings[0])} pointing(s), "
         f"cube {model.cube_shape}, rank {sup.get('rank')}, "
         f"rank tail {tail:.3e}, dropped OTF {dropped:.3e}")
    for name, got, ref in (("forward", y_dev, y_ref), ("adjoint", a_dev, a_ref)):
        mx, rms = _rel_err(got, ref)
        _log(f"parity {name} (device float32 precision=highest vs numpy "
             f"float64): max rel {mx:.3e}, rms rel {rms:.3e}, tol {tol:.3e} "
             "(10x (rank tail + dropped OTF) + f32 rounding)")
        _check(mx <= tol, f"parity {name} max rel {mx:.3e} > {tol:.3e}")
    return model


# --------------------------------------------------------------------------
# 6. banded spectral blur vs dense
def phase_wblur(chan, rtols=(0.0, 1e-4), reps=20, seed=SEED) -> dict:
    """`core.wblur_banded` vs the dense `wblur_sum_beta_batched` on one real
    band's wpsf [K, W, B], with times."""
    import functools

    import jax
    import jax.numpy as jnp

    from surfh_tpu.core import wblur, wblur_banded

    wpsf = np.asarray(chan.wpsf, np.float64)
    K, W, B = wpsf.shape
    S, A = chan.oshape[1], chan.oshape[3]
    rng = np.random.default_rng(seed + 3)
    windows = jnp.asarray(rng.standard_normal((S, W, A, B)), jnp.float32)
    wpsf32 = jnp.asarray(wpsf, jnp.float32)
    dense = np.asarray(wblur.wblur_sum_beta_batched(windows, wpsf32), np.float64)
    t_dense = _median_s(wblur.wblur_sum_beta_batched, windows, wpsf32, reps=reps)
    out = {"dense_ms": t_dense * 1e3}
    _log(f"wblur dense GEMM on wpsf {wpsf.shape}, windows {tuple(windows.shape)}: "
         f"{t_dense * 1e3:.4f} ms")
    xmax = float(np.abs(np.asarray(windows)).max())
    for rtol in rtols:
        plan = wblur_banded.build_band_plan(wpsf, rel_eps=rtol)
        fn = jax.jit(functools.partial(wblur_banded.wblur_sum_beta_banded,
                                       plan=plan))
        got = np.asarray(fn(windows), np.float64)
        t_band = _median_s(fn, windows, reps=reps)
        # what the support threshold drops bounds the truncation error
        thresh = rtol * np.abs(wpsf).max()
        dropped = np.where(np.abs(wpsf).max(axis=2, keepdims=True) > thresh,
                           0.0, np.abs(wpsf))
        bound = (float(dropped.sum(axis=(1, 2)).max()) * xmax
                 / float(np.abs(dense).max()) + F32_RTOL)
        mx, _ = _rel_err(got, dense)
        _log(f"wblur banded rtol {rtol:g}: band {plan.LB}/{W} "
             f"(density {plan.density:.3f}), {t_band * 1e3:.4f} ms, max rel "
             f"{mx:.3e} vs dense, tol {bound:.3e} (dropped response mass + "
             "f32 rounding, float32 precision=highest)")
        _check(mx <= bound, f"banded rtol {rtol:g} max rel {mx:.3e} > {bound:.3e}")
        out[f"banded_{rtol:g}_ms"] = t_band * 1e3
    return out


# --------------------------------------------------------------------------
# four cards: channel-expert sharding vs the same code on one card
def phase_four_cards(n_dev=4, npix=501, bands=None, n_pointings=4,
                     lambda_subsample=3, n_iter=5, mu_reg=5e3,
                     conv_impl="auto", seed=SEED) -> dict:
    import jax
    import jax.numpy as jnp

    from surfh_tpu.parallel.fusion import ShardedSpectro, make_mesh
    from surfh_tpu.simulation.flagship import make_flagship_model

    t0 = time.perf_counter()
    model, setup = make_flagship_model(
        conv_impl=conv_impl, npix=npix, bands=bands,
        n_pointings=n_pointings, lambda_subsample=lambda_subsample, seed=seed,
    )
    model.host_tables()
    _phase("host build", t0)

    out = {}
    runs = {}
    for n in (n_dev, 1):
        t0 = time.perf_counter()
        sh = ShardedSpectro(model, make_mesh(n), shard_tables=True)
        jax.block_until_ready(sh._tables)
        _phase(f"mesh({n}) table upload", t0)
        tb = sh.table_hbm_bytes()
        in_use = [(d.memory_stats() or {}).get("bytes_in_use")
                  for d in jax.devices()[:n_dev]]
        _log(f"mesh({n}) table bytes per device {tb['per_device']} "
             f"(replicated would be {tb['replicated_would_be']}); "
             f"bytes_in_use per device {in_use}")
        if n == n_dev and None not in in_use:
            # each card holds its own bands' tables, not all on the first
            _check(min(in_use) >= tb["per_device"] // 2,
                   f"tables did not land on every device: {in_use}")
        x = jnp.asarray(setup["maps"], jnp.float32)
        t0 = time.perf_counter()
        yp = sh.forward(x)
        a = sh.adjoint(yp)
        jax.block_until_ready(a)
        _phase(f"mesh({n}) forward+adjoint (compile + first run)", t0)
        y = sh.unpack(yp)
        rng = np.random.default_rng(seed + 1)
        y_data = y + rng.normal(0.0, 1e-2 * float(y.std()), y.shape).astype(y.dtype)
        t0 = time.perf_counter()
        res = sh.solve(y_data, mu_reg=mu_reg, max_iter=n_iter, loop="dispatch")
        _phase(f"mesh({n}) {n_iter} lcg dispatch iterations (compile + run)", t0)
        g = np.asarray(res.grad_norm)
        _log(f"mesh({n}) grad norms: {[f'{v:.6e}' for v in g]}")
        _check(bool(np.isfinite(g).all()) and g[-1] < g[0],
               f"mesh({n}) gradient norm not finite and decreasing")
        runs[n] = (y, np.asarray(a), res.x, g)
        if n == n_dev:
            out["table_bytes"] = tb
            out["bytes_in_use"] = in_use
        del sh

    (y4, a4, x4, g4), (y1, a1, x1, g1) = runs[n_dev], runs[1]
    for name, got, ref, tol in (
        ("forward", y4, y1, SHARD_RTOL), ("adjoint", a4, a1, SHARD_RTOL),
        ("cg solution", x4, x1, SHARD_CG_RTOL),
        ("cg grad norms", g4, g1, SHARD_CG_RTOL),
    ):
        mx, rms = _rel_err(got, ref)
        _log(f"mesh({n_dev}) vs mesh(1) {name}: max rel {mx:.3e}, rms rel "
             f"{rms:.3e}, tol {tol:g} (float32 precision=highest; the psum "
             "re-associates the per-device sums)")
        _check(mx <= tol, f"{name} max rel {mx:.3e} > {tol:g}")
        out[name] = mx
    return out


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the channel-sharded flagship on four GPUs "
                         "and compare it with the same code on one")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    dev = device_info()
    _log(f"platform {dev['platform']}, device_kind {dev['kind']}, "
         f"device count {dev['count']}")
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev['platform']!r}); "
              "there is no CPU path", file=sys.stderr)
        return 2
    n_need = 4 if args.four_cards else 1
    if dev["count"] < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, found {dev['count']}",
              file=sys.stderr)
        return 2
    from surfh_tpu.utils.cache import enable_compile_cache
    from surfh_tpu.utils.profiling import card_info

    _log(f"card (name, power.limit): {card_info()}")
    _log(f"compile cache: {enable_compile_cache()}")
    _phase("device", t0)

    if args.four_cards:
        t0 = time.perf_counter()
        phase_four_cards()
        _phase("four cards", t0)
    else:
        t0 = time.perf_counter()
        fl = phase_build()
        _phase("build", t0)
        t0 = time.perf_counter()
        phase_apply(fl)
        _phase("apply", t0)
        t0 = time.perf_counter()
        phase_solve(fl)
        _phase("solve", t0)
        del fl
        t0 = time.perf_counter()
        model = phase_parity()
        _phase("parity", t0)
        t0 = time.perf_counter()
        phase_wblur(model.channels[0])
        _phase("wblur", t0)

    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
