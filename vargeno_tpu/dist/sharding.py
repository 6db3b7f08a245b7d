"""Multi-chip execution: data-parallel read streaming over a device mesh.

The reference is strictly single-threaded (SURVEY.md §2.4); all parallelism
here is new design:

- Reads are the data axis: each device processes ``batch_reads`` reads per
  step (global batch = D * batch_reads), with the index replicated.
- Pileup counts are a per-device accumulator (a leading device axis), so the
  inner loop is collective-free; counts are merged with one ``psum``-style
  reduction at the END of the stream, not per batch -- per-SNP counts are
  order-independent saturating sums, so late merging is exact.

``ShardedGenoRunner`` subclasses the single-device ``GenoRunner`` and reuses
its ENTIRE host loop -- prefetch + native pre-encode, depth-N pipelined
dispatch, queued reverse-orientation retries, per-batch overflow
escalation-and-rerun, checkpoint/resume -- overriding only how a batch is
dispatched (a shard_map'd step over the mesh into per-device accumulators).

A second configuration (sharded-dictionary mode for indexes that exceed
one chip's HBM: hi-bit dictionary partition + all_to_all k-mer routing) is
dist.sharded_dict.ShardedDictGenoRunner, a subclass of this runner.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GenoConfig
from ..engine.batch import make_batch_processor
from ..engine.device_index import build_device_index
from ..engine.geno import GenoRunner, _prefetch_host
from ..index.store import VarGenoIndex


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} JAX device(s) are visible; for CPU-mesh "
                f"testing set JAX_PLATFORMS=cpu and XLA_FLAGS="
                f"--xla_force_host_platform_device_count={n_devices}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


class _MeshProc:
    """Mesh counterpart of the make_batch_processor return object: the same
    ``single_enc`` / ``multi_enc`` / dual ``__call__`` surface, each a jitted
    shard_map over the per-device step, so GenoRunner's dispatch methods and
    host loop drive a mesh without knowing it."""

    def __init__(self, runner: "ShardedGenoRunner", cfg: GenoConfig):
        base = make_batch_processor(runner._proc_dix(), cfg,
                                    backend_factory=runner._backend_factory(
                                        cfg))
        self.shapes = base.shapes
        mesh, axis = runner.mesh, runner.axis
        dix = runner.dix
        dix_specs = runner._dix_specs()
        local_view = runner._local_view
        data, none = P(axis), P()
        # multi-host runners need the stats vector REPLICATED (every process
        # must see identical overflow counters to take the same escalation
        # decision); single-process meshes keep the collective-free
        # per-device layout
        rep = runner._stats_replicated
        stats_spec = none if rep else data

        def maybe_rep(sv):
            # (1, S) per-device row -> (D, S) replicated via all_gather
            return jax.lax.all_gather(sv[0], axis) if rep else sv

        # Stats come back as a PER-DEVICE (D, S) sharded vector, summed /
        # maxed on host in _finalize_batch: the data-parallel inner loop
        # stays completely collective-free (a per-batch psum of 16 scalars
        # costs an all-reduce rendezvous every step -- and on oversubscribed
        # CPU test meshes that rendezvous can trip XLA's hard timeout).
        self._keys_single: list = []
        self._keys_multi: list = []
        self._keys_dual: list = []

        def svec_of(stats, keys_box):
            keys = sorted(stats)
            keys_box.clear()
            keys_box.extend(keys)
            return jnp.stack([jnp.asarray(stats[k], jnp.int32)
                              for k in keys])[None]   # (1, S) per device

        raw_se = base.raw_single_enc
        raw_me = base.raw_multi_enc
        raw_dual = base.raw_enc

        def local_single(dix_l, hi, lo, kv, rok, q, rc, ac):
            rc, ac, process, read_ok, stats = raw_se(
                local_view(dix_l), hi, lo, kv, rok, q, rc[0], ac[0])
            return (rc[None], ac[None], process, read_ok,
                    maybe_rep(svec_of(stats, self._keys_single)))

        single = jax.jit(jax.shard_map(
            local_single, mesh=mesh,
            in_specs=(dix_specs, data, data, data, data, data, data, data),
            out_specs=(data, data, data, data, stats_spec),
            check_vma=False),
            donate_argnums=(6, 7))

        def local_multi(dix_l, hi, lo, kv, rok, q, rc, ac):
            rc, ac, process, read_ok, stats = raw_me(
                local_view(dix_l), hi, lo, kv, rok, q, rc[0], ac[0])
            return (rc[None], ac[None], process, read_ok,
                    maybe_rep(svec_of(stats, self._keys_multi)))

        gdata = P(None, axis)   # (G, B, ...) stacks shard the read axis
        multi = jax.jit(jax.shard_map(
            local_multi, mesh=mesh,
            in_specs=(dix_specs, gdata, gdata, gdata, gdata, gdata, data,
                      data),
            out_specs=(data, data, gdata, gdata, stats_spec),
            check_vma=False),
            donate_argnums=(6, 7))

        def local_dual(dix_l, hi, lo, kv, rok, nk, q, rc, ac):
            rc, ac, stats = raw_dual(local_view(dix_l), hi, lo, kv, rok,
                                     nk, q, rc[0], ac[0])
            return (rc[None], ac[None],
                    maybe_rep(svec_of(stats, self._keys_dual)))

        dual = jax.jit(jax.shard_map(
            local_dual, mesh=mesh,
            in_specs=(dix_specs, data, data, data, data, data, data, data,
                      data),
            out_specs=(data, data, stats_spec), check_vma=False),
            donate_argnums=(7, 8))

        put = runner._put_data
        putg = runner._put_gdata

        def run_single(hi, lo, kv, rok, q, rc, ac):
            out = single(dix, put(hi), put(lo), put(kv), put(rok), put(q),
                         rc, ac)
            return out, tuple(self._keys_single)

        def run_multi(hi, lo, kv, rok, q, rc, ac):
            out = multi(dix, putg(hi), putg(lo), putg(kv), putg(rok),
                        putg(q), rc, ac)
            return out, tuple(self._keys_multi)

        def run_dual(hi, lo, kv, rok, nk, q, rc, ac):
            out = dual(dix, put(hi), put(lo), put(kv), put(rok), put(nk),
                       put(q), rc, ac)
            return out, tuple(self._keys_dual)

        self.single_enc = run_single
        self.multi_enc = run_multi
        self.dual_enc = run_dual


class ShardedGenoRunner(GenoRunner):
    """Data-parallel geno over a mesh. The host feeds global batches of
    D * batch_reads reads; device d handles reads [d*B, (d+1)*B). Inherits
    GenoRunner's pipelined/escalating/checkpointed host loop."""

    _producer_upload = False    # _put_data shards from HOST numpy; a
                                # producer-thread default-device upload
                                # would just bounce through np.asarray
    _stats_replicated = False   # multi-host subclasses set True (see
                                # _MeshProc: replicated stats make every
                                # process take identical escalation steps)
    _chain = False              # mesh runners keep per-batch fresh count
                                # buffers + late merge (the _MeshProc jits
                                # donate their accumulators)

    def __init__(self, index: VarGenoIndex, mesh: Mesh, config: GenoConfig,
                 queued_orientation: bool = True, metrics_path=None,
                 dix=None):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.D = mesh.devices.size
        self._data_sh = NamedSharding(mesh, P(self.axis))
        self._gdata_sh = NamedSharding(mesh, P(None, self.axis))
        self._repl_sh = NamedSharding(mesh, P())
        if not config.pre_encode:
            # the mesh dispatch path ships packed kmer words
            config = dataclasses.replace(config, pre_encode=True)
        self._ht_load = config.ht_target_load
        if dix is None:
            dix = self._prepare_dix(index)
        super().__init__(index, config, queued_orientation=queued_orientation,
                         metrics_path=metrics_path, dix=dix)
        n = self.dix.n_sites
        self.n_sites = n
        self.ref_cnt, self.alt_cnt = self._fresh_counts()

    # --- device placement hooks (multi-host runners override: a process
    # there holds only its local stripe and assembles global arrays with
    # jax.make_array_from_process_local_data) ---

    def _put_data(self, a):
        return jax.device_put(np.asarray(a), self._data_sh)

    def _put_gdata(self, a):
        return jax.device_put(np.asarray(a), self._gdata_sh)

    def _put_repl(self, a):
        return jax.device_put(a, self._repl_sh)

    def _put_dstack(self, a):
        """(D, ...) per-device stacked host array -> device-sharded rows
        (the multi-host mixin ships only the process-local slice)."""
        return jax.device_put(a, self._data_sh)

    # --- mesh plumbing (overridden by the sharded-dictionary subclass) ---

    def _prepare_dix(self, index: VarGenoIndex):
        dix = build_device_index(index, ht_target_load=self._ht_load)
        return jax.tree.map(
            lambda a: self._put_repl(a)
            if isinstance(a, jax.Array) else a, dix)

    def _proc_dix(self):
        """Index template handed to make_batch_processor (shape/geometry
        source for the backend factory)."""
        return self.dix

    def _dix_specs(self):
        """shard_map in_spec (pytree prefix) for the index argument."""
        return P()

    def _local_view(self, dix_l):
        """Per-device view of the index inside shard_map."""
        return dix_l

    def _backend_factory(self, cfg: GenoConfig):
        return None   # LocalBackend (replicated index)

    # --- GenoRunner hook overrides ---

    def _loop_batch(self) -> int:
        return self.D * self.config.batch_reads

    def global_batch(self) -> int:
        return self._loop_batch()

    def _proc(self, cfg: GenoConfig):
        proc = self._procs.get(cfg)
        if proc is None:
            proc = self._procs[cfg] = _MeshProc(self, cfg)
        return proc

    @property
    def _local_D(self) -> int:
        """Devices addressed by THIS process (== D single-process; the
        multi-host mixin narrows it to the local chip count)."""
        return self.D

    def _fresh_counts(self):
        n = self.dix.n_sites
        z = self._put_data(np.zeros((self._local_D, n + 1), np.int32))
        z2 = self._put_data(np.zeros((self._local_D, n + 1), np.int32))
        return z, z2

    def _dispatch_batch(self, codes, nk, qual, single: bool,
                        enc=None) -> dict:
        proc = self._proc(self._cfg_run)
        self.step = proc
        z, z2 = self._fresh_counts()
        if enc is None:
            from .. import native
            from ..core.kmer import np_encode_batch

            e = (native.encode_batch if native.available()
                 else np_encode_batch)(codes, nk,
                                       self.config.max_kmers_per_read)
        else:
            e = enc
        hi, lo, kv, rok = e
        if single:
            (rc, ac, process, read_ok, svec), keys = proc.single_enc(
                hi, lo, kv, rok, qual, z, z2)
            _prefetch_host(svec, process, read_ok)
        else:
            (rc, ac, svec), keys = proc.dual_enc(hi, lo, kv, rok, nk, qual,
                                                 z, z2)
            process = read_ok = None
            _prefetch_host(svec)
        return dict(rc=rc, ac=ac, process=process, read_ok=read_ok,
                    stats_keys=keys, stats_vec=svec, cfg=self._cfg_run,
                    redo=lambda: self._dispatch_batch(codes, nk, qual,
                                                      single, enc=enc),
                    rounds=0)

    def _dispatch_group(self, encs, quals) -> dict:
        proc = self._proc(self._cfg_run)
        self.step = proc
        z, z2 = self._fresh_counts()
        hi = np.stack([e[0] for e in encs])
        lo = np.stack([e[1] for e in encs])
        kv = np.stack([e[2] for e in encs])
        rok = np.stack([e[3] for e in encs])
        qual = np.stack(quals)
        (rc, ac, process, read_ok, svec), keys = proc.multi_enc(
            hi, lo, kv, rok, qual, z, z2)
        _prefetch_host(svec, process, read_ok)
        return dict(rc=rc, ac=ac, process=process, read_ok=read_ok,
                    stats_keys=keys, stats_vec=svec, cfg=self._cfg_run,
                    redo=lambda: self._dispatch_group(encs, quals),
                    rounds=0)

    def merge_counts(self):
        """(ref, alt) summed across the device axis (device arrays)."""
        return (jnp.sum(self.ref_cnt, axis=0), jnp.sum(self.alt_cnt, axis=0))

    def _host_counts(self):
        rc, ac = self.merge_counts()
        return np.asarray(rc), np.asarray(ac)

    def _restore_ckpt(self, rc, ac) -> None:
        """Checkpoints store merged (n+1,) counts -- layout-independent, so
        a single-device checkpoint resumes on any mesh size and vice versa.
        Counts are order-independent sums: restoring the merged total into
        device row 0 is exact."""
        rc = np.asarray(rc)
        ac = np.asarray(ac)
        if rc.ndim == 2:   # legacy per-device layout
            rc, ac = rc.sum(axis=0), ac.sum(axis=0)
        n = self.dix.n_sites
        buf_r = np.zeros((self.D, n + 1), np.int32)
        buf_a = np.zeros((self.D, n + 1), np.int32)
        buf_r[0] = rc
        buf_a[0] = ac
        self.ref_cnt = jax.device_put(buf_r, self._data_sh)
        self.alt_cnt = jax.device_put(buf_a, self._data_sh)

    # --- back-compat accessors (older API surface / tools) ---

    @property
    def ref_cnt_d(self):
        return self.ref_cnt

    @property
    def alt_cnt_d(self):
        return self.alt_cnt
