"""Multi-chip sharding of the fusion forward/adjoint/solve pipeline.

The reference never parallelized across channels — "Parallelization on
channel" is an explicit TODO (/root/reference/README.md:57-60); its channel
loop is serial Python (/root/reference/surfh/Models/spectroModel.py:167-176).
Here the natural decomposition becomes the mesh layout:

* **channel-expert sharding** (mesh axis ``"chan"``): each device owns a
  static subset of the instrument bands.  The unknown (maps, a few MB) is
  replicated; each device computes T and C *only over its bands' λ-windows*
  (`wslice`), then its bands' S·L·R·Sig pipelines.  The forward needs **no
  communication at all**; the adjoint / normal operator needs exactly one
  `psum` of the maps-shaped contribution per application.  CG state is
  replicated and tiny, so a full CG iteration costs a single all-reduce of
  ~n_tpl·N² floats between the devices.

Because the 12 MRS bands have ragged shapes (different n_slit, λ-counts,
slit widths — scripts/main_fusion.py:34-39), devices run band-specific
programs selected by `lax.switch` on `axis_index` inside one SPMD
`shard_map` body; per-band outputs are zero-padded to a common block so the
sharded data vector is a dense [n_dev·slots, block] array.
"""

from __future__ import annotations

from math import ceil
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import fft, lmm
from ..core import linop as linop_mod
from ..solvers import cg as cg_mod
from ..solvers.criterion import dtd_separated


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "chan") -> Mesh:
    """A 1-D device mesh over the first `n_devices` available devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.asarray(devices[:n_devices]), (axis_name,))


class ShardedSpectro:
    """Channel-sharded wrapper of a `SpectroSigRLSCT` model.

    Parameters
    ----------
    model:
        The flagship operator (`surfh_tpu.models.spectro.SpectroSigRLSCT`).
    mesh:
        A 1-D `jax.sharding.Mesh`; its single axis shards the channel list.
    """

    def __init__(self, model, mesh: Mesh, axis_name: Optional[str] = None,
                 shard_tables: bool = False):
        self.model = model
        self.mesh = mesh
        if axis_name is None:
            axis_name = mesh.axis_names[0]
        self.axis = axis_name
        self.n_dev = int(mesh.shape[axis_name])
        n_ch = len(model.channels)
        self.n_ch = n_ch
        self.per_dev = max(1, ceil(n_ch / self.n_dev))
        self.block = max(int(np.prod(o)) for o in model.instrs_oshape)
        # round-robin: channel c → device c % n_dev, slot c // n_dev
        self.slots: List[List[int]] = [
            [c for c in range(n_ch) if c % self.n_dev == d] for d in range(self.n_dev)
        ]

        sm = lambda f, i, o: jax.jit(
            jax.shard_map(f, mesh=mesh, in_specs=i, out_specs=o, check_vma=False)
        )
        # Flagship (window_local) models pass their tables as shard_map
        # ARGUMENTS: closed-over tables would be inlined as HLO constants,
        # which cannot compile at flagship scale (GB-size programs; see
        # models/spectro.py `window_local`).  Two table layouts:
        # * replicated (default): every device holds all of the 12-band
        #   tables; compute and temps scale with devices, tables do not.
        # * `shard_tables=True`: each device holds ONLY its own channels'
        #   tables (padded to the per-slot max shape and stacked on a
        #   device-sharded leading axis) — per-device table memory drops
        #   from Σ_all-channels to Σ_slots max-channel, so it stays bounded
        #   as bands grow.  Assembled shard-by-shard with
        #   `make_array_from_single_device_arrays`; the OTF/rank-fold
        #   materialization runs once per channel ON ITS OWNER, keeping the
        #   exact-transpose contract pinned exactly like the replicated path.
        self.window_local = bool(getattr(model, "window_local", False))
        self.shard_tables = bool(shard_tables)
        if shard_tables and not self.window_local:
            raise ValueError("shard_tables requires a window_local model")
        if self.window_local and shard_tables:
            self._tables, tspec = self._build_owner_sharded_tables()
            self._forward_sm = sm(
                self._local_forward_packed, (P(), tspec), P(self.axis))
            self._adjoint_sm = sm(
                self._local_adjoint_packed, (P(self.axis), tspec), P())
            self._normal_sm = sm(
                self._local_normal_packed, (P(), tspec), P())
        elif self.window_local:
            repl = NamedSharding(mesh, P())
            # Stamp-mode tables ship compact PSF stamps; materialize the OTF
            # windows ON DEVICE once here (replicated) so the shard_map
            # forward/adjoint consume bit-identical `sotf_ri` values — the
            # exact-transpose contract needs the OTF pinned, not re-evaluated
            # per program (see SpectroSigRLSCT.materialize_otf).
            self._tables = model.materialize_otf(
                jax.device_put(model.host_tables(), repl), out_sharding=repl
            )
            tspec = jax.tree.map(lambda _: P(), self._tables)
            self._forward_sm = sm(
                self._local_forward_tabled, (P(), tspec), P(self.axis))
            self._adjoint_sm = sm(
                self._local_adjoint_tabled, (P(self.axis), tspec), P())
            self._normal_sm = sm(
                self._local_normal_tabled, (P(), tspec), P())
        else:
            self._tables = None
            self._fwd_fns = [self._make_channel_fwd(c) for c in range(n_ch)]
            self._adj_fns = [self._make_channel_adj(c) for c in range(n_ch)]
            self._forward_sm = sm(self._local_forward, P(), P(self.axis))
            self._adjoint_sm = sm(self._local_adjoint, P(self.axis), P())
            self._normal_sm = sm(self._local_normal, P(), P())

        self.y_sharding = NamedSharding(mesh, P(self.axis))
        self.x_sharding = NamedSharding(mesh, P())

    # ------------------------------------------------------------------
    # owner-sharded tables (shard_tables=True)
    def _build_owner_sharded_tables(self):
        """Pack per-channel tables onto their owner devices.

        Layout: for each slot s, each table leaf (keyed by its pytree path)
        becomes ONE global array [n_dev, *slot_max_shape] sharded P(axis) —
        device d's block is its channel `slots[d][s]`'s leaf zero-padded to
        the slot max (padding is never read: the SPMD branches statically
        slice back to the true shapes).  Blocks are built per device and
        assembled with `make_array_from_single_device_arrays`, so no device
        ever holds another device's tables.  The stamp→OTF and rank-fold
        materialization (see SpectroSigRLSCT.materialize_otf) runs once per
        channel on its owner, pinning the tables bit-exactly across the
        forward/adjoint programs."""
        import jax.tree_util as jtu

        from ..core import fft as fft_mod

        model = self.model
        host = model.host_tables()
        devices = list(self.mesh.devices.flat)

        # 1. materialize each channel's table dict on its owner device
        chan_tables: List[Optional[dict]] = [None] * self.n_ch
        for d, dev in enumerate(devices[: self.n_dev]):
            for c in self.slots[d]:
                t = dict(host["chan"][c])
                if "cgrid_tz" in t:
                    # banded weight blocks ship packed (see
                    # SpectroSigRLSCT._build_host_tables); rebuild the dense
                    # blocks ON THE OWNER device, mirroring materialize_otf
                    from ..core import bilinear as bilinear_mod

                    linv, idx, nzi, nzv, osrc, ow, odst = t.pop("cgrid_tz")
                    bshape = model.channels[c]._composed_t_stack[2].shape[1:]
                    wbk = jax.jit(
                        lambda i, v, s=bshape:
                        bilinear_mod.unpack_banded_weights(i, v, s)
                    )(jax.device_put(nzi, dev), jax.device_put(nzv, dev))
                    t["cgrid_t"] = (linv, idx, wbk, osrc, ow, odst)
                if "cgrid_mtz" in t:
                    from ..core import bilinear as bilinear_mod

                    linv, idx, nzi, nzv, osrc, wsel, odst = t.pop("cgrid_mtz")
                    bshape = (
                        model.channels[c]._composed_t_stack_mp[2].shape[1:]
                    )
                    wbc = jax.jit(
                        lambda i, v, s=bshape:
                        bilinear_mod.unpack_banded_weights(i, v, s)
                    )(jax.device_put(nzi, dev), jax.device_put(nzv, dev))
                    t["cgrid_mt"] = (linv, idx, wbc, osrc, wsel, odst)
                if "psf" in t:
                    psf = jax.device_put(t.pop("psf"), dev)
                    stamp = jax.device_put(t.pop("stamp"), dev)
                    if "cu" in t:
                        # rank mode keeps cu (static shapes + the conv path)
                        t["cu"] = np.asarray(t["cu"])
                    t["sotf_ri"] = jax.jit(
                        lambda p, st: jnp.stack(fft_mod.otf_from_stamps(p, st))
                    )(psf, stamp)
                    if "cu" in t:
                        wsl = model.channels[c].wslice

                        def fold(wpsf, tpl, cu, lo=wsl.start, hi=wsl.stop):
                            tpl_w = jax.lax.slice_in_dim(tpl, lo, hi, axis=1)
                            cmat = jnp.einsum(
                                "mw,wr->wmr", tpl_w, cu, precision="highest"
                            )
                            cmat = cmat.reshape(cmat.shape[0], -1)
                            return jnp.einsum(
                                "kwb,wq->kqb", wpsf, cmat, precision="highest"
                            )

                        t["wpsf_q"] = jax.jit(fold)(
                            jax.device_put(t["wpsf"], dev),
                            jax.device_put(host["tpl"], dev),
                            jax.device_put(t["cu"], dev),
                        )
                    # psf/stamp are consumed by the materialization and NOT
                    # repacked — exactly like materialize_otf, so the SPMD
                    # bodies take the pinned-sotf_ri path, never the
                    # in-graph re-evaluation
                chan_tables[c] = t

        # 2. flatten each channel dict to (pathkey → leaf); record structure
        self._chan_leaf_meta: List[Optional[tuple]] = [None] * self.n_ch
        flat_by_chan: List[Optional[dict]] = [None] * self.n_ch
        for c, t in enumerate(chan_tables):
            if t is None:
                continue
            leaves_p, treedef = jtu.tree_flatten_with_path(t)
            meta, flat = [], {}
            for path, leaf in leaves_p:
                key = jtu.keystr(path)
                arr = leaf if hasattr(leaf, "shape") else np.asarray(leaf)
                meta.append((key, tuple(arr.shape), arr.dtype))
                flat[key] = arr
            self._chan_leaf_meta[c] = (treedef, meta)
            flat_by_chan[c] = flat

        # 3. per slot: pad to the max shape per path, one block per device,
        #    assemble the device-sharded global array
        repl = NamedSharding(self.mesh, P())
        packed_slots = []
        for s in range(self.per_dev):
            slot_chans = {
                d: self.slots[d][s]
                for d in range(self.n_dev)
                if s < len(self.slots[d])
            }
            paths = sorted(
                {k for c in slot_chans.values() for k in flat_by_chan[c]}
            )
            slot_pack = {}
            for key in paths:
                leaves = {
                    d: flat_by_chan[c][key]
                    for d, c in slot_chans.items()
                    if key in flat_by_chan[c]
                }
                some = next(iter(leaves.values()))
                ndim = len(some.shape)
                dt = some.dtype
                target = tuple(
                    max(l.shape[i] for l in leaves.values()) for i in range(ndim)
                )
                blocks = []
                for d, dev in enumerate(devices[: self.n_dev]):
                    leaf = leaves.get(d)
                    if leaf is None:
                        blk = jax.device_put(
                            np.zeros((1,) + target, dt), dev
                        )
                    elif isinstance(leaf, np.ndarray):
                        pad = [(0, t_ - s_) for t_, s_ in zip(target, leaf.shape)]
                        blk = jax.device_put(
                            np.pad(leaf, pad)[np.newaxis], dev
                        )
                    else:  # device-resident (materialized on the owner)
                        pad = [(0, 0)] + [
                            (0, t_ - s_) for t_, s_ in zip(target, leaf.shape)
                        ]
                        blk = jax.jit(
                            lambda a, pad=tuple(pad): jnp.pad(
                                a[jnp.newaxis], pad
                            )
                        )(leaf)
                    blocks.append(blk)
                slot_pack[key] = jax.make_array_from_single_device_arrays(
                    (self.n_dev,) + target,
                    NamedSharding(self.mesh, P(self.axis)),
                    blocks,
                )
            packed_slots.append(slot_pack)

        packed = {
            "tpl": jax.device_put(host["tpl"], repl),
            "slots": packed_slots,
        }
        tspec = {
            "tpl": P(),
            "slots": [
                {k: P(self.axis) for k in sp} for sp in packed_slots
            ],
        }
        return packed, tspec

    def _unpack_chan(self, packed, s: int, c: int):
        """Rebuild channel c's true-shaped table dict from the local shard."""
        import jax.tree_util as jtu

        treedef, meta = self._chan_leaf_meta[c]
        leaves = []
        for key, shp, _dt in meta:
            v = packed["slots"][s][key][0]  # local block [1, *target]
            if tuple(v.shape) != shp:
                v = jax.lax.slice(v, (0,) * v.ndim, shp)
            leaves.append(v)
        return jtu.tree_unflatten(treedef, leaves)

    # SPMD bodies, owner-sharded tables
    def _local_forward_packed(self, x, packed):
        model, dt = self.model, self.model.dtype

        def branch(d):
            def f(x):
                rows = []
                for s in range(self.per_dev):
                    if s < len(self.slots[d]):
                        c = self.slots[d][s]
                        t = self._unpack_chan(packed, s, c)
                        view = {"tpl": packed["tpl"], "chan": {c: t}}
                        y = model._channel_fwd_tabled(x, c, view).ravel()
                        rows.append(jnp.pad(y, (0, self.block - y.size)))
                    else:
                        rows.append(jnp.zeros((self.block,), dt))
                return jnp.stack(rows)

            return f

        d = jax.lax.axis_index(self.axis)
        return jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], x)

    def _local_adjoint_packed(self, y_local, packed):
        model = self.model

        def branch(d):
            def f(y_local):
                acc = jnp.zeros(model.ishape, model.dtype)
                for s, c in enumerate(self.slots[d]):
                    osz = int(np.prod(model.instrs_oshape[c]))
                    yc = y_local[s, :osz].reshape(model.instrs_oshape[c])
                    t = self._unpack_chan(packed, s, c)
                    view = {"tpl": packed["tpl"], "chan": {c: t}}
                    acc = acc + model._channel_adj_tabled(yc, c, view)
                return acc

            return f

        d = jax.lax.axis_index(self.axis)
        acc = jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], y_local)
        return jax.lax.psum(acc, self.axis)

    def _local_normal_packed(self, x, packed):
        model = self.model

        def branch(d):
            def f(x):
                acc = jnp.zeros(model.ishape, model.dtype)
                for s, c in enumerate(self.slots[d]):
                    t = self._unpack_chan(packed, s, c)
                    view = {"tpl": packed["tpl"], "chan": {c: t}}
                    acc = acc + model._channel_adj_tabled(
                        model._channel_fwd_tabled(x, c, view), c, view
                    )
                return acc

            return f

        d = jax.lax.axis_index(self.axis)
        acc = jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], x)
        return jax.lax.psum(acc, self.axis)

    def table_hbm_bytes(self) -> dict:
        """Per-device table residency accounting.

        Returns {"per_device": bytes each device holds, "replicated_would_be":
        bytes the replicated layout would put on EVERY device}."""
        if not self.window_local:
            return {"per_device": 0, "replicated_would_be": 0}

        def nbytes(tree):
            return sum(
                int(np.prod(l.shape)) * l.dtype.itemsize
                for l in jax.tree_util.tree_leaves(tree)
                if hasattr(l, "shape")
            )

        if self.shard_tables:
            per_dev = sum(
                int(np.prod(a.shape[1:])) * a.dtype.itemsize
                for sp in self._tables["slots"]
                for a in sp.values()
            ) + nbytes(self._tables["tpl"])
            # what the replicated layout would put on EVERY device: the
            # MATERIALIZED per-channel tables (sotf_ri/wpsf_q included —
            # their true shapes are recorded in _chan_leaf_meta), not the
            # compact pre-materialization stamps
            repl = nbytes(self._tables["tpl"]) + sum(
                int(np.prod(shp)) * np.dtype(dt).itemsize
                for m in self._chan_leaf_meta
                if m is not None
                for (_k, shp, dt) in m[1]
            )
            return {"per_device": per_dev, "replicated_would_be": repl}
        return {
            "per_device": nbytes(self._tables),
            "replicated_would_be": nbytes(self._tables),
        }

    # ------------------------------------------------------------------
    # per-channel pure functions over the *windowed* cube — each device
    # materializes only its channels' λ-windows.
    def _make_channel_fwd(self, c: int) -> Callable:
        model = self.model
        chan = model.channels[c]
        wsl = chan.wslice
        npctype = np.complex64 if model.dtype == jnp.float32 else np.complex128
        npdtype = np.float32 if model.dtype == jnp.float32 else np.float64
        sotf_w = np.asarray(model.sotf[wsl], npctype)
        imshape = model.imshape
        if model.lmm:
            tpl_w = np.asarray(model.templates[:, wsl], npdtype)

            def fwd(x):
                cube_w = lmm.lmm_maps2cube(x, tpl_w)
                blurred = fft.idft(fft.dft(cube_w) * sotf_w, imshape)
                return chan._forward_windowed(blurred, chan._wpsf_dev)

        else:

            def fwd(x):
                xw = jax.lax.slice_in_dim(x, wsl.start, wsl.stop, axis=0)
                blurred = fft.idft(fft.dft(xw) * sotf_w, imshape)
                return chan._forward_windowed(blurred, chan._wpsf_dev)

        return fwd

    def _make_channel_adj(self, c: int) -> Callable:
        """Hand-written exact transpose of the per-channel windowed forward
        (same fast formulation as SpectroSigRLSCT.adjoint_fn)."""
        model = self.model
        chan = model.channels[c]
        wsl = chan.wslice
        npctype = np.complex64 if model.dtype == jnp.float32 else np.complex128
        npdtype = np.float32 if model.dtype == jnp.float32 else np.float64
        sotf_w_conj = np.asarray(model.sotf[wsl].conj(), npctype)
        imshape = model.imshape
        if model.lmm:
            tpl_w = np.asarray(model.templates[:, wsl], npdtype)

            def adj(y):
                cube_w = chan._adjoint_windowed_fast(y)
                blurred_t = fft.idft(fft.dft(cube_w) * sotf_w_conj, imshape)
                return lmm.lmm_cube2maps(blurred_t, tpl_w)

        else:

            def adj(y):
                cube_w = chan._adjoint_windowed_fast(y)
                blurred_t = fft.idft(fft.dft(cube_w) * sotf_w_conj, imshape)
                out = jnp.zeros(model.ishape, y.dtype)
                return out.at[wsl.start : wsl.stop].add(blurred_t)

        return adj

    # ------------------------------------------------------------------
    # SPMD bodies (run per device under shard_map)
    def _local_forward(self, x):
        dt = self.model.dtype

        def branch(d):
            def f(x):
                rows = []
                for s in range(self.per_dev):
                    if s < len(self.slots[d]):
                        c = self.slots[d][s]
                        y = self._fwd_fns[c](x).ravel()
                        rows.append(jnp.pad(y, (0, self.block - y.size)))
                    else:
                        rows.append(jnp.zeros((self.block,), dt))
                return jnp.stack(rows)

            return f

        d = jax.lax.axis_index(self.axis)
        return jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], x)

    def _local_adjoint(self, y_local):
        model = self.model

        def branch(d):
            def f(y_local):
                acc = jnp.zeros(model.ishape, model.dtype)
                for s, c in enumerate(self.slots[d]):
                    osz = int(np.prod(model.instrs_oshape[c]))
                    yc = y_local[s, :osz].reshape(model.instrs_oshape[c])
                    acc = acc + self._adj_fns[c](yc)
                return acc

            return f

        d = jax.lax.axis_index(self.axis)
        acc = jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], y_local)
        return jax.lax.psum(acc, self.axis)

    def _local_normal(self, x):
        model = self.model

        def branch(d):
            def f(x):
                acc = jnp.zeros(model.ishape, model.dtype)
                for c in self.slots[d]:
                    acc = acc + self._adj_fns[c](self._fwd_fns[c](x))
                return acc

            return f

        d = jax.lax.axis_index(self.axis)
        acc = jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], x)
        return jax.lax.psum(acc, self.axis)

    # ------------------------------------------------------------------
    # SPMD bodies, window-local (tables as replicated shard_map arguments)
    def _local_forward_tabled(self, x, tables):
        model, dt = self.model, self.model.dtype

        def branch(d):
            def f(x):
                rows = []
                for s in range(self.per_dev):
                    if s < len(self.slots[d]):
                        c = self.slots[d][s]
                        y = model._channel_fwd_tabled(x, c, tables).ravel()
                        rows.append(jnp.pad(y, (0, self.block - y.size)))
                    else:
                        rows.append(jnp.zeros((self.block,), dt))
                return jnp.stack(rows)

            return f

        d = jax.lax.axis_index(self.axis)
        return jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], x)

    def _local_adjoint_tabled(self, y_local, tables):
        model = self.model

        def branch(d):
            def f(y_local):
                acc = jnp.zeros(model.ishape, model.dtype)
                for s, c in enumerate(self.slots[d]):
                    osz = int(np.prod(model.instrs_oshape[c]))
                    yc = y_local[s, :osz].reshape(model.instrs_oshape[c])
                    acc = acc + model._channel_adj_tabled(yc, c, tables)
                return acc

            return f

        d = jax.lax.axis_index(self.axis)
        acc = jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], y_local)
        return jax.lax.psum(acc, self.axis)

    def _local_normal_tabled(self, x, tables):
        model = self.model

        def branch(d):
            def f(x):
                acc = jnp.zeros(model.ishape, model.dtype)
                for c in self.slots[d]:
                    acc = acc + model._channel_adj_tabled(
                        model._channel_fwd_tabled(x, c, tables), c, tables
                    )
                return acc

            return f

        d = jax.lax.axis_index(self.axis)
        acc = jax.lax.switch(d, [branch(i) for i in range(self.n_dev)], x)
        return jax.lax.psum(acc, self.axis)

    # ------------------------------------------------------------------
    # public API
    def _sm_args(self):
        return (self._tables,) if self.window_local else ()

    def forward(self, x):
        """maps → packed sharded data [n_dev·slots, block] (no communication)."""
        return self._forward_sm(
            jnp.asarray(x, self.model.dtype).reshape(self.model.ishape),
            *self._sm_args(),
        )

    def adjoint(self, y_packed):
        """packed sharded data → maps (one psum)."""
        return self._adjoint_sm(
            jnp.asarray(y_packed, self.model.dtype), *self._sm_args()
        )

    def normal(self, x):
        """HᵗH x, fused per device (one psum)."""
        return self._normal_sm(
            jnp.asarray(x, self.model.dtype).reshape(self.model.ishape),
            *self._sm_args(),
        )

    # ------------------------------------------------------------------
    # layout conversion host helpers (reference flat vector ↔ packed shards)
    def pack(self, y_flat) -> jax.Array:
        """Reference flat data vector → padded [n_dev·slots, block], placed
        with the sharded layout (row r = device r // slots, slot r % slots)."""
        flat = np.asarray(y_flat).ravel()
        dt = np.float32 if self.model.dtype == jnp.float32 else np.float64
        out = np.zeros((self.n_dev * self.per_dev, self.block), dt)
        for c in range(self.n_ch):
            d, s = c % self.n_dev, c // self.n_dev
            seg = flat[self.model._idx[c] : self.model._idx[c + 1]]
            out[d * self.per_dev + s, : seg.size] = seg
        return jax.device_put(out, self.y_sharding)

    def unpack(self, y_packed) -> np.ndarray:
        """Inverse of :meth:`pack` (returns the reference flat layout)."""
        packed = np.asarray(y_packed)
        flat = np.zeros((int(self.model._idx[-1]),), packed.dtype)
        for c in range(self.n_ch):
            d, s = c % self.n_dev, c // self.n_dev
            n = self.model._idx[c + 1] - self.model._idx[c]
            flat[self.model._idx[c] : self.model._idx[c + 1]] = packed[
                d * self.per_dev + s, :n
            ]
        return flat

    def forward_flat(self, x) -> np.ndarray:
        """Forward returning the reference flat layout (host-side reshuffle)."""
        return self.unpack(self.forward(x))

    # ------------------------------------------------------------------
    def make_train_step(self, mu_spectro: float = 1.0, mu_reg: float = 1.0, lr: float = 1e-6):
        """One jitted gradient step of ½µ_s‖y−Hx‖² + ½µ_r‖Dx‖² over the mesh.

        The whole step is a single compiled SPMD program: sharded forward
        (no comm) → sharded residual → adjoint (one psum) → replicated prior
        and update.  This is the framework's "training step" for multi-chip
        validation and long solves driven step-by-step from the host.
        """

        # tables ride as jit ARGUMENTS (a closed-over device array is inlined
        # as an HLO literal — at flagship scale that blows the program size)
        def step(x, y_packed, *sm_args):
            r = self._forward_sm(x, *sm_args) - y_packed
            g = mu_spectro * self._adjoint_sm(r, *sm_args) + mu_reg * dtd_separated(x)
            return x - lr * g

        jstep = jax.jit(step)
        return lambda x, y_packed: jstep(x, y_packed, *self._sm_args())

    def solve(
        self,
        y,
        mu_reg: float,
        x0=None,
        mu_spectro: float = 1.0,
        max_iter: int = 100,
        tol: float = 1e-12,
        method: str = "lcg",
        packed: bool = False,
        loop: str = "graph",
        chain_steps: int = 1,
        state=None,
        return_state: bool = False,
    ) -> cg_mod.SolverResult:
        """Sharded regularized least squares:
        min_x ½µ_s‖y − Hx‖² + ½µ_r‖Dx‖² via CG on the normal equations.

        Every iteration does one fused HᵗH (one psum) plus the replicated
        separated-difference prior; CG state is replicated maps.
        `loop="dispatch"` runs the production flagship-scale mode (Python
        loop, one jitted normal application per dispatch — the in-graph
        while-loop carry would hold a private copy of every table);
        `state`/`return_state` resume exactly, as in :func:`solvers.cg.lcg`.

        µ_spectro/µ_reg ride as TRACED op_args of one memoized normal_op
        closure, so repeated solves (µ sweeps, resumes) reuse the compiled
        CG step instead of re-tracing per call (the solver cache is keyed
        by the closure's identity).
        """
        model = self.model
        y_packed = y if packed else self.pack(y)
        dt = model.dtype
        mu_s = jnp.asarray(mu_spectro, dt)
        mu_r = jnp.asarray(mu_reg, dt)
        b = mu_s * self._adjoint_sm(y_packed, *self._sm_args())
        if x0 is None:
            x0 = jnp.zeros(model.ishape, model.dtype)
        x0 = jax.device_put(jnp.asarray(x0, model.dtype).reshape(model.ishape), self.x_sharding)

        if getattr(self, "_solve_normal_op", None) is None:
            def normal_op(x, mu_s, mu_r, *sm_args):
                return mu_s * self._normal_sm(x, *sm_args) + mu_r * dtd_separated(x)

            self._solve_normal_op = normal_op
        op_args = (mu_s, mu_r) + self._sm_args()

        if method == "lcg":
            return cg_mod.lcg(self._solve_normal_op, b, x0, max_iter=max_iter,
                              tol=tol, op_args=op_args, loop=loop,
                              chain_steps=chain_steps, state=state,
                              return_state=return_state)
        if state is not None or return_state or chain_steps != 1:
            raise ValueError(
                "state/return_state/chain_steps are lcg-only; mmmg would "
                "silently cold-restart from x0"
            )
        return cg_mod.mmmg(self._solve_normal_op, b, x0, max_iter=max_iter,
                           tol=tol, op_args=op_args, loop=loop)
