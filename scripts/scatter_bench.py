"""Microbench of composed-transpose spellings on the real band tables.

The sorted-COO scatter (`apply_composed_plan_t`) is the largest single op
of the flagship channel normal (PERF.md post-composed budget).  It scatters
*columns* of a [W, P] patch (stride-P element updates).  Candidate wins:

  B. row layout — scatter contiguous [W]-rows of a [P, W] patch instead;
  C. B plus the two layout transposes it costs inside the current pipeline;
  D. gather-form transpose — per-destination padded tap lists [P, L] turn
     the scatter into L row-gathers + dense adds (L = max segment = 7);
  E. layered prefix — pixels sorted by segment length (static perm), layer
     k touches only the first T_k rows (dense prefix adds, no scatter),
     one final take unpermutes;
  F/G. forward gather: column-take (current) vs row-take layout.

    python scripts/scatter_bench.py [--band 1c] [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.core import bilinear
    from surfh_tpu.simulation.flagship import make_flagship_model
    from surfh_tpu.utils.profiling import chained_time

    model, _setup = make_flagship_model(
        bands=[args.band], npix=args.npix, n_pointings=1, conv_impl="matmul",
    )
    chan = model.channels[0]
    idx, w, csrc, cw, cdst = (np.asarray(a[0]) for a in chan._composed_stack)
    ha, wb = chan._tbbox[2], chan._tbbox[3]
    P = ha * wb
    C, n_out = idx.shape
    W = chan.wslice.stop - chan.wslice.start
    nz = cw != 0
    csrc, cw_nz, cdst = csrc[nz], cw[nz], cdst[nz]
    nnz = csrc.shape[0]
    print(f"band {args.band}: P={P} n_out={n_out} C={C} W={W} nnz={nnz}",
          flush=True)

    rng = np.random.default_rng(0)
    f32 = jnp.float32
    vals = jax.device_put(rng.standard_normal((W, n_out)).astype(np.float32))
    vals_T = jax.device_put(np.asarray(vals).T.copy())

    dev = jax.device_put
    j_idx, j_w = dev(idx), dev(w.astype(np.float32))
    j_csrc, j_cw, j_cdst = dev(csrc), dev(cw_nz.astype(np.float32)), dev(cdst)

    # --- host prep: gather-form [P, L] ----------------------------------
    seg = np.bincount(cdst, minlength=P)
    L = int(seg.max())
    starts = np.concatenate([[0], np.cumsum(seg)])
    tsrc = np.zeros((P, L), np.int32)
    tw = np.zeros((P, L), np.float32)
    for k in range(L):
        has = seg > k
        tsrc[has, k] = csrc[starts[:-1][has] + k]
        tw[has, k] = cw_nz[starts[:-1][has] + k]
    j_tsrc, j_tw = dev(tsrc), dev(tw)

    # --- host prep: layered prefix (perm by decreasing segment) ---------
    perm = np.argsort(-seg, kind="stable")
    T = [int((seg > k).sum()) for k in range(L)]
    lsrc = [csrc[starts[:-1][perm[: T[k]]] + k].astype(np.int32) for k in range(L)]
    lw = [cw_nz[starts[:-1][perm[: T[k]]] + k].astype(np.float32) for k in range(L)]
    inv = np.full(P, T[0], np.int32)
    inv[perm[: T[0]]] = np.arange(T[0], dtype=np.int32)
    j_lsrc = [dev(a) for a in lsrc]
    j_lw = [dev(a) for a in lw]
    j_inv = dev(inv)
    print(f"L={L} touched={T[0]} layer sizes {T}", flush=True)

    def t(name, fn, x):
        ms = chained_time(fn, x, chain=args.chain, reps=args.reps) * 1e3
        print(f"  {name:34s} {ms:8.2f} ms", flush=True)
        return ms

    # A. current column scatter
    def f_a(v):
        return bilinear.apply_composed_plan_t(j_csrc, j_cw, j_cdst, v, P)

    # B. row-layout scatter ([P, W] out, contiguous row updates)
    def f_b(vt):
        contrib = jnp.take(vt, j_csrc, axis=0) * j_cw[:, None]
        out = jnp.zeros((P, W), f32)
        return out.at[j_cdst].add(contrib, indices_are_sorted=True)

    # C. B with the layout round-trip the current pipeline would pay
    def f_c(v):
        return f_b(v.T).T

    # D. gather-form: L row-gathers + dense adds
    def f_d(vt):
        out = jnp.zeros((P, W), f32)
        for k in range(L):
            out = out + jnp.take(vt, j_tsrc[:, k], axis=0) * j_tw[:, k][:, None]
        return out

    # D2. gather-form as one big take + einsum
    def f_d2(vt):
        g = jnp.take(vt, j_tsrc.reshape(-1), axis=0).reshape(P, L, W)
        return jnp.einsum("plw,pl->pw", g, j_tw)

    # D3. gather-form loop with the [W,·] layout round-trip
    def f_d3(v):
        return f_d(v.T).T

    # E. layered prefix + unpermute take
    def f_e(vt):
        acc = jnp.zeros((T[0], W), f32)
        for k in range(L):
            upd = jnp.take(vt, j_lsrc[k], axis=0) * j_lw[k][:, None]
            acc = acc.at[: T[k]].add(upd)
        accz = jnp.concatenate([acc, jnp.zeros((1, W), f32)], axis=0)
        return jnp.take(accz, j_inv, axis=0)

    # E2. layered prefix, permuted output only (ceiling, no unpermute)
    def f_e2(vt):
        acc = jnp.zeros((T[0], W), f32)
        for k in range(L):
            upd = jnp.take(vt, j_lsrc[k], axis=0) * j_lw[k][:, None]
            acc = acc.at[: T[k]].add(upd)
        return acc

    # E3. layered prefix with the [W,·] layout round-trip
    def f_e3(v):
        return f_e(v.T).T

    # F. forward gather, current column form
    patch = jax.device_put(rng.standard_normal((W, P)).astype(np.float32))
    patch_T = jax.device_put(np.asarray(patch).T.copy())

    def f_f(p):
        return bilinear.apply_composed_plan(j_idx, j_w, p.reshape(W, P))

    # G. forward gather, row form: win_T [n_out, W]
    def f_g(pt):
        out = jnp.zeros((n_out, W), f32)
        for c in range(C):
            out = out + jnp.take(pt, j_idx[c], axis=0) * j_w[c][:, None]
        return out

    t("A  column scatter (current)", f_a, vals)
    t("B  row scatter", f_b, vals_T)
    t("C  row scatter + transposes", f_c, vals)
    t("D  gather-form loop", f_d, vals_T)
    t("D2 gather-form one-take einsum", f_d2, vals_T)
    t("D3 gather-form + transposes", f_d3, vals)
    t("E  layered prefix + unpermute", f_e, vals_T)
    t("E2 layered prefix (ceiling)", f_e2, vals_T)
    t("E3 layered prefix + transposes", f_e3, vals)
    t("F  fwd gather column (current)", f_f, patch)
    t("G  fwd gather row form", f_g, patch_T)

    # correctness cross-check (f32 tolerances)
    ref = np.asarray(f_a(vals))
    for name, fn, x, tr in [("B", f_b, vals_T, True), ("D", f_d, vals_T, True),
                            ("E", f_e, vals_T, True)]:
        got = np.asarray(fn(x))
        if tr:
            got = got.T
        rel = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        print(f"  check {name}: max rel {rel:.2e}")
    reff = np.asarray(f_f(patch))
    gotg = np.asarray(f_g(patch_T)).T.reshape(reff.shape)
    rel = np.abs(gotg - reff).max() / max(np.abs(reff).max(), 1e-30)
    print(f"  check G: max rel {rel:.2e}")


if __name__ == "__main__":
    main()
