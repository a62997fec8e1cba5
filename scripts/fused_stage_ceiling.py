"""TRUE fused-stage costs of the flagship channel normal via stage stubbing.

Isolated per-op timings (flagship_breakdown.py) overstate: XLA overlaps
the memory ops (gather/scatter) with the matmul ops (conv/wblur GEMMs) inside
the fused program.  This probe times the fused channel normal repeatedly,
each time monkeypatching ONE stage to a shape-correct O(small) stub that
keeps the dataflow alive — the delta vs stock is that stage's true
marginal cost (= the ceiling any kernel optimization of it can buy).

    python scripts/fused_stage_ceiling.py [--band 1c]
"""
import argparse, os, sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--band", default="1c")
    ap.add_argument("--npix", type=int, default=501)
    ap.add_argument("--pointings", type=int, default=4)
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import jax

    from surfh_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from surfh_tpu.core import bilinear, fft, wblur
    from surfh_tpu.simulation.flagship import make_flagship_model, make_flagship_setup

    setup = make_flagship_setup(npix=args.npix, bands=[args.band],
                                n_pointings=args.pointings)
    model, _ = make_flagship_model(setup)
    tables = model.device_tables()
    maps = jax.device_put(jnp.asarray(setup["maps"], jnp.float32))

    def chained(nrm):
        @jax.jit
        def run(x, tb):
            def body(i, carry):
                x, acc = carry
                out = nrm(x + acc.astype(x.dtype) * 1e-30, tb)
                return x, acc + jnp.sum(out).astype(jnp.float32)

            return jax.lax.fori_loop(0, args.chain, body, (x, jnp.float32(0)))[1]

        float(run(maps, tables))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            float(run(maps, tables))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) / args.chain * 1e3

    def nrm(x, tb):
        return model._channel_adj_tabled(
            model._channel_fwd_tabled(x, 0, tb), 0, tb)

    stock = chained(nrm)
    print(f"  stock fused normal        {stock:8.2f} ms", flush=True)

    # --- stubs (shape-correct, keep dataflow live, O(cheap)) -------------
    def stub_gather(cidx, cw, patch_flat):
        n_out = cidx.shape[1]
        return patch_flat[..., :n_out] * cw[0, 0]

    def stub_scatter(csrc, cw, cdst, values, patch_pixels):
        n = values.shape[-1]
        pad = [(0, 0)] * (values.ndim - 1) + [(0, patch_pixels - n)]
        return jnp.pad(values * cw[0], pad)

    def stub_wblur(arr, wpsf):
        # [s, λ, α, β] -> [s, λ', α]: slice/broadcast λ' from λ, keep deps
        s, l, a, b = arr.shape
        k = wpsf.shape[0]
        base = arr[:, :1, :, 0] * wpsf[0, 0, 0]
        return jnp.broadcast_to(base, (s, k, a))

    cases = []
    cases.append(("gather (fwd)", bilinear, "apply_composed_plan", stub_gather))
    cases.append(("scatter (adj)", bilinear, "apply_composed_plan_t", stub_scatter))
    cases.append(("wblur fwd GEMM", wblur, "wblur_sum_beta_batched", stub_wblur))

    for name, mod, attr, stub in cases:
        orig = getattr(mod, attr)
        setattr(mod, attr, stub)
        try:
            ms = chained(nrm)
        finally:
            setattr(mod, attr, orig)
        print(f"  -{name:24s} {ms:8.2f} ms   (share {stock - ms:6.2f})",
              flush=True)

    # conv pair: patch both lmm conv directions at once (the wblur ADJOINT
    # GEMM is inlined in channel.py and not patchable here — its cost is
    # bounded by the fwd GEMM share by symmetry)
    o_f, o_t = fft.lmm_conv_otf_matmul, fft.lmm_conv_otf_matmul_t

    # probe output shape once, then stub with broadcast
    probed = {}

    def conv_stub(maps, tpl_w, otf_re, otf_im, m, precision="highest"):
        W = tpl_w.shape[1]
        ha, wb = probed["hw"]
        base = (maps[0, :1, :1] * tpl_w[0, :, None]).reshape(W, 1, 1)
        return jnp.broadcast_to(base, (W, ha, wb))

    def conv_t_stub(g, tpl_w, otf_re, otf_im, m, precision="highest"):
        M = tpl_w.shape[0]
        npx = probed["npix"]
        base = jnp.sum(g[:1, :1, :]) * tpl_w[:, :1]
        return jnp.broadcast_to(base.reshape(M, 1, 1), (M, npx, npx))

    def probing_f(maps, tpl_w, otf_re, otf_im, m, precision="highest"):
        out = o_f(maps, tpl_w, otf_re, otf_im, m, precision=precision)
        probed["hw"] = (out.shape[1], out.shape[2])
        probed["npix"] = maps.shape[1]
        return out

    fft.lmm_conv_otf_matmul = probing_f
    try:
        jax.eval_shape(lambda x, tb: nrm(x, tb), maps, tables)
    finally:
        fft.lmm_conv_otf_matmul = o_f
    # rank-mode conv pair (fft.lmm_conv_rank — the flagship default): probe
    # the rank-basis output shape, then stub both directions
    r_f, r_t = fft.lmm_conv_rank, fft.lmm_conv_rank_t
    rprobed = {}

    def rprobe_f(maps, otf_re, otf_im, m, precision="highest"):
        out = r_f(maps, otf_re, otf_im, m, precision=precision)
        rprobed["shape"] = out.shape
        rprobed["npix"] = maps.shape[1:]
        return out

    def rank_stub(maps, otf_re, otf_im, m, precision="highest"):
        base = maps[:1, :1, :1] * otf_re[0, 0, 0]
        return jnp.broadcast_to(base.reshape(1, 1, 1), rprobed["shape"])

    def rank_t_stub(g, otf_re, otf_im, m, n_maps, precision="highest"):
        base = jnp.sum(g[:1, :1, :]) * otf_re[0, 0, 0]
        return jnp.broadcast_to(
            base.reshape(1, 1, 1), (n_maps,) + tuple(rprobed["npix"])
        )

    fft.lmm_conv_rank = rprobe_f
    try:
        jax.eval_shape(lambda x, tb: nrm(x, tb), maps, tables)
    finally:
        fft.lmm_conv_rank = r_f
    fft.lmm_conv_otf_matmul = conv_stub
    fft.lmm_conv_otf_matmul_t = conv_t_stub
    if rprobed:
        fft.lmm_conv_rank, fft.lmm_conv_rank_t = rank_stub, rank_t_stub
    try:
        ms = chained(nrm)
    finally:
        fft.lmm_conv_otf_matmul, fft.lmm_conv_otf_matmul_t = o_f, o_t
        fft.lmm_conv_rank, fft.lmm_conv_rank_t = r_f, r_t
    print(f"  -conv pair (fwd+adj)      {ms:8.2f} ms   (share {stock - ms:6.2f})",
          flush=True)


if __name__ == "__main__":
    main()
