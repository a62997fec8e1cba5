"""window_local tables-as-args flagship mode: equivalence with const mode.

The tabled program must be mathematically identical to the constant-embedding
program (the spatial FFT conv and the LMM are per-λ-plane, so window slicing
commutes), and its HLO must stay small (no inlined multi-MB constants) — the
property that makes the reference-scale problem compilable and cacheable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surfh_tpu.simulation.synthetic import make_model, make_setup


@pytest.fixture(scope="module")
def pair():
    setup = make_setup(
        im_size=41, n_lambda=36, n_tpl=3, n_channels=2, n_pointings=2, n_slit=3
    )
    const_model, _ = make_model(setup=setup, dtype=jnp.float32)
    from surfh_tpu.models.spectro import SpectroSigRLSCT

    tabled = SpectroSigRLSCT(
        setup["sotf"], setup["templates"], setup["alpha_axis"], setup["beta_axis"],
        setup["wavelength_axis"], setup["instrs"], setup["step_degree"],
        setup["pointings"], dtype=jnp.float32, window_local=True,
    )
    return const_model, tabled, setup


def test_forward_equivalence(pair):
    const_model, tabled, setup = pair
    x = np.asarray(setup["maps"], np.float32)
    y_const = np.asarray(const_model.forward(x))
    y_tab = np.asarray(tabled.forward(x))
    np.testing.assert_allclose(y_tab, y_const, rtol=2e-6, atol=0)


def test_adjoint_equivalence_and_exactness(pair):
    const_model, tabled, setup = pair
    rng = np.random.default_rng(0)
    y = rng.standard_normal(tabled.oshape).astype(np.float32)
    a_const = np.asarray(const_model.adjoint(y))
    a_tab = np.asarray(tabled.adjoint(y))
    scale = np.abs(a_const).max()
    np.testing.assert_allclose(a_tab, a_const, rtol=0, atol=2e-6 * scale)

    # dot test: the tabled adjoint is the exact transpose of the tabled forward
    x = rng.standard_normal(tabled.ishape).astype(np.float32)
    lhs = float(np.vdot(np.asarray(tabled.forward(x)), y))
    rhs = float(np.vdot(x, a_tab))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


def test_fused_normal_matches_composition(pair):
    _, tabled, setup = pair
    x = np.asarray(setup["maps"], np.float32)
    tables = tabled.device_tables()
    hthx = np.asarray(
        jax.jit(tabled._normal_fn_tabled)(jnp.asarray(x), tables)
    )
    ref = np.asarray(tabled.adjoint(tabled.forward(x)))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(hthx, ref, rtol=0, atol=2e-6 * scale)


def test_hlo_has_no_large_constants(pair):
    """The raison d'être: the lowered module stays small because every large
    table is an argument, not an inlined dense constant."""
    _, tabled, _ = pair
    x = jnp.zeros(tabled.ishape, jnp.float32)
    tables = tabled.device_tables()
    text = jax.jit(tabled._forward_fn_tabled).lower(x, tables).as_text()
    table_bytes = sum(
        np.asarray(leaf).nbytes for leaf in jax.tree_util.tree_leaves(tables)
    )
    # the fixture's tables are big (composed mode dropped the dead staged
    # plan arrays, so the bar is lower than the original 500 KB)...
    assert table_bytes > 300_000
    # ...but the HLO must not embed them: a dense f32 constant costs ~8+
    # text chars per element, so an embedding module would be ≫ table_bytes.
    assert len(text) < table_bytes


def test_criterion_lcg_window_local(pair):
    const_model, tabled, setup = pair
    from surfh_tpu.solvers.criterion import QuadCriterion_MRS

    x = np.asarray(setup["maps"], np.float32)
    y = np.asarray(const_model.forward(x))
    crit_c = QuadCriterion_MRS(1.0, y, const_model, mu_reg=5.0)
    crit_t = QuadCriterion_MRS(1.0, y, tabled, mu_reg=5.0)
    res_c = crit_c.run_method("lcg", maximum_iterations=12)
    res_t = crit_t.run_method("lcg", maximum_iterations=12)
    # per-application fp differences (different but mathematically equal
    # programs) amplify over CG iterations; compare iterates loosely and the
    # criterion value tightly
    scale = np.abs(res_c.x).max()
    np.testing.assert_allclose(res_t.x, res_c.x, rtol=0, atol=1e-3 * scale)
    jc = crit_c.get_crit_val(res_c.x)
    jt = crit_t.get_crit_val(res_t.x)
    assert abs(jc - jt) <= 1e-2 * abs(jc)
    assert res_t.grad_norm[-1] < res_t.grad_norm[0]


def test_composed_gridding_matches_staged():
    """The composed window plan (gridding∘box-sum∘slit-window as one deduped
    gather, the default) is the SAME linear map as the staged pipeline:
    forward, hand adjoint and dot-test agree at machine precision in f64 —
    and the staged path keeps its own coverage via the env toggle."""
    import os

    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model

    kw = dict(im_size=41, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2,
              n_slit=4, dtype=jnp.float64)
    old = os.environ.get("SURFH_COMPOSED_GRIDDING")
    try:
        os.environ["SURFH_COMPOSED_GRIDDING"] = "0"
        staged, setup = make_model(**kw)
        os.environ["SURFH_COMPOSED_GRIDDING"] = "1"
        composed, _ = make_model(**kw)
    finally:
        if old is None:
            os.environ.pop("SURFH_COMPOSED_GRIDDING", None)
        else:
            os.environ["SURFH_COMPOSED_GRIDDING"] = old
    assert all(c._composed_stack is None for c in staged.channels)
    assert any(c._composed_stack is not None for c in composed.channels)
    # composed-mode tables omit the dead staged plan arrays
    for chan in composed.channels:
        if chan._composed_stack is not None:
            t = chan.host_tables()
            assert ("cgrid" in t) or ("cgrid_b" in t)  # either layout ships
            assert "plan_idx" not in t and "tplan" not in t
    rng = np.random.default_rng(0)
    x = rng.random(staged.ishape)
    ys, yc = np.asarray(staged.forward(x)), np.asarray(composed.forward(x))
    np.testing.assert_allclose(yc, ys, rtol=0, atol=1e-13 * np.abs(ys).max())
    yr = rng.standard_normal(staged.oshape)
    as_, ac = np.asarray(staged.adjoint_fn(yr)), np.asarray(composed.adjoint_fn(yr))
    np.testing.assert_allclose(ac, as_, rtol=0, atol=1e-13 * np.abs(as_).max())
    lhs = float(np.vdot(yc, yr))
    rhs = float(np.vdot(x, ac))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_composed_transpose_layered_matches_coo():
    """The layered-prefix transpose (dense prefix adds + one
    unpermuting take, no scatter) is BIT-identical to the sorted-COO
    scatter form (`SURFH_COMPOSED_T_IMPL=coo`): same taps, same
    per-destination summation order.  Covers the tabled path too."""
    import os

    import jax
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model

    kw = dict(im_size=41, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=2,
              n_slit=4, dtype=jnp.float64)
    old = os.environ.get("SURFH_COMPOSED_T_IMPL")
    try:
        os.environ["SURFH_COMPOSED_T_IMPL"] = "coo"
        coo, setup = make_model(**kw)
        os.environ["SURFH_COMPOSED_T_IMPL"] = "layered"
        lay, _ = make_model(**kw)
    finally:
        if old is None:
            os.environ.pop("SURFH_COMPOSED_T_IMPL", None)
        else:
            os.environ["SURFH_COMPOSED_T_IMPL"] = old
    assert not coo.channels[0]._composed_t_layered
    assert lay.channels[0]._composed_t_layered
    rng = np.random.default_rng(7)
    y = rng.standard_normal(coo.oshape)
    a_coo = np.asarray(coo.adjoint_fn(y))
    a_lay = np.asarray(lay.adjoint_fn(y))
    np.testing.assert_allclose(a_lay, a_coo, rtol=0,
                               atol=1e-15 * np.abs(a_coo).max())
    # tabled (window-local flagship) path: one channel, tables as args
    chan = lay.channels[0]
    tb = {k: jax.device_put(v) for k, v in chan.host_tables().items()}
    yw = rng.standard_normal(chan.oshape)
    got = np.asarray(jax.jit(
        lambda yw, tb: chan._adjoint_windowed_fast_impl(
            yw, chan.n_wslice, tb["wpsf"], tables=tb)
    )(yw, tb))
    chan_coo = coo.channels[0]
    tb2 = {k: jax.device_put(v) for k, v in chan_coo.host_tables().items()}
    want = np.asarray(jax.jit(
        lambda yw, tb: chan_coo._adjoint_windowed_fast_impl(
            yw, chan_coo.n_wslice, tb["wpsf"], tables=tb)
    )(yw, tb2))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-15 * np.abs(want).max())


def test_conv_rank_mode_matches_dense():
    """λ-rank factorized conv (conv_rank_rtol, fft.lmm_conv_rank): the
    rank-basis pipeline (conv → composed gather → folded wblur, all on
    Q = M·R planes) deviates from the dense W-plane pipeline by at most the
    recorded SVD tail, its forward/adjoint stay an exact transpose pair,
    and the gate records per-channel ranks in conv_supports."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_setup, make_model

    setup = make_setup(im_size=41, n_lambda=120, n_tpl=2, n_channels=2,
                       n_pointings=2, n_slit=3)
    kw = dict(setup=setup, dtype=jnp.float64, window_local=True,
              conv_impl="matmul", psf_stamps=True)
    base, _ = make_model(conv_rank_rtol=0.0, **kw)
    rank, _ = make_model(conv_rank_rtol=1e-9, **kw)
    base.host_tables(), rank.host_tables()
    assert all("rank" not in s for s in base.conv_supports)
    ranks = [s.get("rank") for s in rank.conv_supports]
    tails = [s.get("rank_tail", 0.0) for s in rank.conv_supports]
    assert all(r is not None and r < 120 // 4 for r in ranks)

    x = np.asarray(setup["maps"], np.float64)
    yb, yr = np.asarray(base.forward(x)), np.asarray(rank.forward(x))
    # measured amplification of the SVD tail through the pipeline: 2.1x fwd
    # / 1.1x adj at this fixture (stable across rtol 1e-9..1e-5), 7.2x at
    # flagship scale in f64 (PERF.md "λ-rank fidelity at flagship scale") —
    # bound at 10x the recorded tail (≈5x slack over the fixture constant,
    # no 50x fudge).  In f32 the rank error is invisible below the
    # pipeline's own f32 rounding floor (same PERF.md section).
    bound = max(max(tails) * 10, 1e-13)
    assert np.abs(yr - yb).max() <= bound * np.abs(yb).max()

    rng = np.random.default_rng(3)
    y = rng.standard_normal(base.oshape)
    ab, ar = np.asarray(base.adjoint(y)), np.asarray(rank.adjoint(y))
    assert np.abs(ar - ab).max() <= bound * np.abs(ab).max()

    # pair exactness: the truncation modifies the operator, not the adjoint
    lhs = float(np.vdot(yr, y))
    rhs = float(np.vdot(x, ar))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)

    # fused normal matches fwd∘adj composition in rank mode
    import jax

    tables = rank.device_tables()
    hthx = np.asarray(jax.jit(rank._normal_fn_tabled)(jnp.asarray(x), tables))
    ref = np.asarray(rank.adjoint(rank.forward(x)))
    np.testing.assert_allclose(hthx, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_conv_rank_gate_declines_tiny_windows():
    """Channels where M·R is not decisively below W keep the dense path
    (no "cu" table, no rank in supports) — the no-win gate."""
    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model

    # 24-λ windows with 4 templates: M·R can't get under W/2
    model, _ = make_model(im_size=41, n_lambda=24, n_tpl=4, n_channels=2,
                          n_pointings=2, n_slit=3, dtype=jnp.float64,
                          window_local=True, conv_impl="matmul",
                          psf_stamps=True, conv_rank_rtol=1e-9)
    tables = model.host_tables()
    assert all("cu" not in t for t in tables["chan"])
    assert all("rank" not in s for s in model.conv_supports)


def test_pointing_batch_matches_scanned():
    """The pointing-batched composed path (SURFH_POINTING_BATCH, the
    default: one gather + one wblur GEMM forward, one take per transpose
    layer adjoint, all pointings at once) computes the SAME linear map as
    the scanned per-pointing spelling — same taps, same per-destination
    accumulation order; only the GEMM shape (and hence the backend's
    reduction blocking, ~1e-15 rel) changes."""
    import os

    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model

    kw = dict(im_size=41, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=3,
              n_slit=4, dtype=jnp.float64)
    old = os.environ.get("SURFH_POINTING_BATCH")
    old_impl = os.environ.get("SURFH_COMPOSED_T_IMPL")
    try:
        # the batched fold assumes the LAYERED transpose layout (the
        # shipped default is the banded-matmul form)
        os.environ["SURFH_COMPOSED_T_IMPL"] = "layered"
        os.environ["SURFH_POINTING_BATCH"] = "0"
        scanned, setup = make_model(**kw)
        os.environ["SURFH_POINTING_BATCH"] = "1"
        batched, _ = make_model(**kw)
    finally:
        if old is None:
            os.environ.pop("SURFH_POINTING_BATCH", None)
        else:
            os.environ["SURFH_POINTING_BATCH"] = old
        if old_impl is None:
            os.environ.pop("SURFH_COMPOSED_T_IMPL", None)
        else:
            os.environ["SURFH_COMPOSED_T_IMPL"] = old_impl
    assert all(not c.pointing_batch for c in scanned.channels)
    assert any(c.pointing_batch for c in batched.channels)
    for chan in batched.channels:
        if chan.pointing_batch:
            t = chan.host_tables()
            assert "cgrid_b" in t and "cgrid" not in t

    rng = np.random.default_rng(3)
    x = rng.random(scanned.ishape)
    ys = np.asarray(scanned.forward(x))
    yb = np.asarray(batched.forward(x))
    np.testing.assert_allclose(yb, ys, rtol=0, atol=1e-13 * np.abs(ys).max())
    yr = rng.standard_normal(scanned.oshape)
    a_s = np.asarray(scanned.adjoint_fn(yr))
    a_b = np.asarray(batched.adjoint_fn(yr))
    np.testing.assert_allclose(a_b, a_s, rtol=0, atol=1e-13 * np.abs(a_s).max())
    # dot-test of the batched pair
    lhs = float(np.vdot(yb, yr))
    rhs = float(np.vdot(x, a_b))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_host_table_disk_cache(tmp_path, monkeypatch):
    """host_tables disk cache (cold-start work): bit-identical roundtrip,
    key sensitivity to config, and SURFH_TABLE_CACHE=0 disables."""
    import jax.tree_util as jtu

    from surfh_tpu.simulation.synthetic import make_model

    monkeypatch.setenv("SURFH_TABLE_CACHE", str(tmp_path))
    kw = dict(im_size=31, n_lambda=60, n_tpl=2, n_channels=2, n_pointings=1,
              n_slit=3, window_local=True, conv_impl="matmul",
              conv_freq_rtol=1e-6, conv_rank_rtol=1e-7, psf_stamps=True)
    m1, _ = make_model(**kw)
    t1 = m1.host_tables()
    files1 = set(tmp_path.glob("tables_*.pkl"))
    assert len(files1) == 1
    m2, _ = make_model(**kw)
    t2 = m2.host_tables()  # cache hit
    assert set(tmp_path.glob("tables_*.pkl")) == files1
    for (p1, l1), (p2, l2) in zip(jtu.tree_flatten_with_path(t1)[0],
                                  jtu.tree_flatten_with_path(t2)[0]):
        assert jtu.keystr(p1) == jtu.keystr(p2)
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    assert m2.conv_supports == m1.conv_supports

    # a different conv config must key differently
    kw2 = dict(kw, conv_rank_rtol=0.0)
    m3, _ = make_model(**kw2)
    m3.host_tables()
    assert len(set(tmp_path.glob("tables_*.pkl"))) == 2

    # disabled: no new cache entries
    monkeypatch.setenv("SURFH_TABLE_CACHE", "0")
    m4, _ = make_model(**kw)
    assert m4._table_cache_path() is None


def test_banded_weights_ship_packed():
    """Banded-transpose weight blocks ship as packed nonzeros (cgrid_tz)
    in the model host tables — the dense [P, nb, tb, sw] blocks are ~5 %
    nonzero and dominated the flagship table upload — and
    `device_tables`/`materialize_otf` rebuilds dense blocks on device
    bit-identical to the construction-time ones, so the tabled adjoint
    matches the closure adjoint exactly."""
    import jax
    import jax.numpy as jnp

    from surfh_tpu.core import bilinear
    from surfh_tpu.simulation.synthetic import make_setup, make_model

    setup = make_setup(im_size=41, n_lambda=120, n_tpl=2, n_channels=2,
                       n_pointings=2, n_slit=3)
    model, _ = make_model(setup=setup, dtype=jnp.float64, window_local=True,
                          conv_impl="matmul", psf_stamps=True)
    assert model.channels[0]._composed_t_impl == "banded"

    host = model.host_tables()
    for c, t in enumerate(host["chan"]):
        assert "cgrid_tz" in t and "cgrid_t" not in t
        # pack/unpack roundtrip equals the dense construction-time blocks
        wb_dense = model.channels[c]._composed_t_stack[2]
        nzi, nzv = t["cgrid_tz"][2], t["cgrid_tz"][3]
        # the packed pair is genuinely smaller than the dense blocks
        assert nzi.nbytes + nzv.nbytes < wb_dense.nbytes
        rebuilt = np.asarray(
            bilinear.unpack_banded_weights(nzi, nzv, wb_dense.shape[1:])
        )
        np.testing.assert_array_equal(rebuilt, np.asarray(wb_dense))

    tables = model.device_tables()
    for c, t in enumerate(tables["chan"]):
        assert "cgrid_t" in t and "cgrid_tz" not in t
        np.testing.assert_array_equal(
            np.asarray(t["cgrid_t"][2]),
            np.asarray(model.channels[c]._composed_t_stack[2]),
        )

    rng = np.random.default_rng(11)
    y = rng.standard_normal(model.oshape)
    got = np.asarray(jax.jit(model._adjoint_fn_tabled)(
        jnp.asarray(y), tables))
    want = np.asarray(model.adjoint(y))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


def test_composed_transpose_impls_agree():
    """The five composed-transpose spellings — banded matmul (default),
    pointing-summed banded (banded_mp), bucketed rows, layered prefix
    adds, sorted COO scatter — compute the same exact transpose of the
    composed gather (same taps; only f64 reduction-order noise differs),
    and the model's forward/adjoint stay a transpose pair under each."""
    import os

    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_setup, make_model

    setup = make_setup(im_size=41, n_lambda=24, n_tpl=3, n_channels=2,
                       n_pointings=2, n_slit=4)
    kw = dict(setup=setup, dtype=jnp.float64)
    old = os.environ.get("SURFH_COMPOSED_T_IMPL")
    models = {}
    try:
        for impl in ("rows", "banded", "banded_mp", "layered", "coo"):
            os.environ["SURFH_COMPOSED_T_IMPL"] = impl
            models[impl], _ = make_model(**kw)
            assert models[impl].channels[0]._composed_t_impl == impl
    finally:
        if old is None:
            os.environ.pop("SURFH_COMPOSED_T_IMPL", None)
        else:
            os.environ["SURFH_COMPOSED_T_IMPL"] = old

    rng = np.random.default_rng(7)
    y = rng.standard_normal(models["rows"].oshape)
    x = np.asarray(setup["maps"], np.float64)
    adjs = {k: np.asarray(m.adjoint(y)) for k, m in models.items()}
    scale = np.abs(adjs["coo"]).max()
    for k in ("rows", "banded", "banded_mp", "layered"):
        np.testing.assert_allclose(adjs[k], adjs["coo"], rtol=0,
                                   atol=1e-13 * scale)
    for m in models.values():
        lhs = float(np.vdot(np.asarray(m.forward(x)), y))
        rhs = float(np.vdot(x, m.adjoint(y)))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_pointing_unroll_matches_scan():
    """The unrolled pointing structure (the GPU policy's default) computes
    bit-identical
    forward and adjoint to the scanned form: same per-pointing bodies,
    same float accumulation order over pointings."""
    import os

    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_setup, make_model

    setup = make_setup(im_size=41, n_lambda=24, n_tpl=3, n_channels=2,
                       n_pointings=4, n_slit=4)
    old = os.environ.get("SURFH_POINTING_SCAN")
    try:
        os.environ["SURFH_POINTING_SCAN"] = "1"
        m_scan, _ = make_model(setup=setup, dtype=jnp.float32)
        os.environ["SURFH_POINTING_SCAN"] = "0"
        m_unr, _ = make_model(setup=setup, dtype=jnp.float32)
    finally:
        if old is None:
            os.environ.pop("SURFH_POINTING_SCAN", None)
        else:
            os.environ["SURFH_POINTING_SCAN"] = old
    assert all(c.pointing_scan for c in m_scan.channels)
    assert not any(c.pointing_scan for c in m_unr.channels)

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(m_scan.ishape), jnp.float32)
    ys = np.asarray(m_scan.forward(x))
    yu = np.asarray(m_unr.forward(x))
    np.testing.assert_array_equal(ys, yu)
    y = jnp.asarray(ys)
    np.testing.assert_array_equal(np.asarray(m_scan.adjoint(y)),
                                  np.asarray(m_unr.adjoint(y)))


def test_pointing_cat_matches_unrolled():
    """The pointing-concatenated banded transpose + batched forward gather
    (SURFH_POINTING_CAT=1: index-offset tables into pointing-concatenated
    sources, one gather/scatter/take per channel instead of per pointing)
    computes the same linear map as the per-pointing unrolled banded
    default — same taps, same per-destination tap order; only the final
    pointing-sum reduction order changes."""
    import os

    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model

    kw = dict(im_size=41, n_lambda=24, n_tpl=3, n_channels=2, n_pointings=3,
              n_slit=4, dtype=jnp.float64)
    old_cat = os.environ.get("SURFH_POINTING_CAT")
    old_scan = os.environ.get("SURFH_POINTING_SCAN")
    try:
        os.environ["SURFH_POINTING_SCAN"] = "0"  # cat composes with unrolled
        os.environ["SURFH_POINTING_CAT"] = "0"
        plain, setup = make_model(**kw)
        os.environ["SURFH_POINTING_CAT"] = "1"
        cat, _ = make_model(**kw)
    finally:
        for k, v in (("SURFH_POINTING_CAT", old_cat),
                     ("SURFH_POINTING_SCAN", old_scan)):
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert all(not c.pointing_cat for c in plain.channels)
    assert all(c.pointing_cat for c in cat.channels)
    for chan in cat.channels:
        t = chan.host_tables()
        assert "cgrid_b" in t and "cgrid_ct" in t and "cgrid" not in t

    rng = np.random.default_rng(5)
    x = rng.random(plain.ishape)
    yp = np.asarray(plain.forward(x))
    yc = np.asarray(cat.forward(x))
    np.testing.assert_allclose(yc, yp, rtol=0, atol=1e-13 * np.abs(yp).max())
    yr = rng.standard_normal(plain.oshape)
    a_p = np.asarray(plain.adjoint_fn(yr))
    a_c = np.asarray(cat.adjoint_fn(yr))
    np.testing.assert_allclose(a_c, a_p, rtol=0, atol=1e-13 * np.abs(a_p).max())
    # dot-test of the cat pair: the adjoint is still the exact transpose
    lhs = float(np.vdot(yc, yr))
    rhs = float(np.vdot(x, a_c))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_pointing_cat_window_local_tabled():
    """The cat mode through the PRODUCTION window-local tables-as-args path:
    cgrid_ct ships packed (cgrid_ctz), materializes on device, and the
    tabled forward/adjoint match the per-pointing tabled default."""
    import os

    import jax.numpy as jnp

    from surfh_tpu.simulation.synthetic import make_model

    kw = dict(im_size=41, n_lambda=60, n_tpl=2, n_channels=2, n_pointings=3,
              n_slit=3, window_local=True, conv_impl="matmul",
              conv_freq_rtol=1e-6, psf_stamps=True)
    old_cat = os.environ.get("SURFH_POINTING_CAT")
    old_scan = os.environ.get("SURFH_POINTING_SCAN")
    try:
        os.environ["SURFH_POINTING_SCAN"] = "0"
        os.environ["SURFH_POINTING_CAT"] = "0"
        plain, setup = make_model(**kw)
        os.environ["SURFH_POINTING_CAT"] = "1"
        cat, _ = make_model(setup=setup, **{k: v for k, v in kw.items()
                                            if k not in ()})
    finally:
        for k, v in (("SURFH_POINTING_CAT", old_cat),
                     ("SURFH_POINTING_SCAN", old_scan)):
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert all(c.pointing_cat for c in cat.channels)
    host = cat.host_tables()
    assert any("cgrid_ctz" in t for t in host["chan"])

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random(plain.ishape), jnp.float32)
    yp = np.asarray(plain.forward(x))
    yc = np.asarray(cat.forward(x))
    np.testing.assert_allclose(yc, yp, rtol=0, atol=1e-5 * np.abs(yp).max())
    yr = rng.standard_normal(plain.oshape).astype(np.float32)
    a_p = np.asarray(plain.adjoint(yr))
    a_c = np.asarray(cat.adjoint(yr))
    np.testing.assert_allclose(a_c, a_p, rtol=0, atol=1e-5 * np.abs(a_p).max())
