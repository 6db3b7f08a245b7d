"""Multi-host execution: N processes over several hosts via jax.distributed.

The reference is one thread in one process (SURVEY.md §2.4); BASELINE
targets data-parallel streaming across multiple hosts with
>=85% scaling at N>=2 hosts. This module is that axis:

- ``initialize()`` brings up the process group (DCN coordination service);
  each process then addresses only its local chips.
- Each process reads ONLY ITS STRIPE of the FASTQ
  (io.fastq.iter_read_batches_strided): global batch g is file reads
  [g*GB, (g+1)*GB); process p parses rows [p*LB, (p+1)*LB) of it and skips
  the rest at newline-count speed. Every stripe yields the same number of
  batches with the same ``global_n_valid``, so the N host loops stay
  collectively aligned with zero host-level communication.
- Global device arrays are assembled with
  ``jax.make_array_from_process_local_data``; the compiled step is the
  SAME shard_map program as single-process mesh mode, so collectives ride
  ICI within a host and DCN across hosts exactly as the mesh lays them
  out. Per-SNP counts stay per-device and merge once at the end
  (order-independent sums -- late merge is exact, SURVEY §2.4).
- Batch stats are replicated across processes inside the step (one tiny
  all_gather, dist.sharding._MeshProc) so every process sees identical
  overflow counters and takes identical escalation-and-rerun decisions --
  the fault-tolerance path needs no extra coordination.
- Orientation handling (src/qv.cc:1504-1510 semantics) defaults to
  LOCKSTEP QUEUED RETRY: forward-only batches plus reverse-complement
  retry batches scheduled purely from the replicated per-device `retry_n`
  stats, so N processes fire identical dispatch sequences with zero extra
  communication at ~1.5x device work per read (see _consume_queued_mh).
  The inline dual step (forward + reverse in one dispatch, 2x work, host
  loop a pure function of the read stream) remains available
  (queued_orientation=False / CLI --mh-inline-dual). Counts are
  bit-identical either way (order-independent sums).

Checkpoints hold the MERGED (n_sites+1,) counts plus the global read
count, so a run may be resumed on a different host count (or a single
host) and vice versa.

Local validation without hardware: N processes x K virtual CPU devices on
one machine (``initialize(..., cpu_devices=K)``), collectives via Gloo --
see tests/test_multihost.py.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..config import GenoConfig
from ..index.store import VarGenoIndex


def initialize(coordinator: str, num_processes: int, process_id: int,
               cpu_devices: int = 0) -> None:
    """Join the process group. MUST run before any other jax use in the
    process. ``cpu_devices > 0`` forces a virtual CPU host with that many
    devices (local multi-process testing; collectives go through Gloo)."""
    import os

    if cpu_devices:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={cpu_devices}")
    import jax

    if cpu_devices:
        # jax was already imported (the package enables the compilation
        # cache), so the env var above is read too late: the config API wins
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def barrier(name: str = "vgt") -> None:
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


class _MultiHostMixin:
    """Overrides that turn a single-process mesh runner into a
    multi-process one. Mix in FRONT of ShardedGenoRunner /
    ShardedDictGenoRunner."""

    _stats_replicated = True   # see dist.sharding._MeshProc

    def __init__(self, index: VarGenoIndex, mesh, config: GenoConfig,
                 queued_orientation: bool = True, **kw):
        import jax

        self._pid = jax.process_index()
        self._n_procs = jax.process_count()
        # queued (default): single-orientation forward batches + LOCKSTEP
        # reverse-complement retry batches, scheduled from the replicated
        # per-device `retry_n` stats -- ~1.5x device work per read instead
        # of the inline dual step's 2x, zero extra communication (see
        # _consume_queued_mh). inline (False): forward + reverse in one
        # dispatch -- the host loop is a pure function of the read stream.
        # Counts are bit-identical either way (order-independent sums).
        self._mh_queued = queued_orientation
        kw["queued_orientation"] = False   # the base loop is never used
        super().__init__(index, mesh, config, **kw)
        if self.D % self._n_procs:
            raise ValueError(
                f"mesh of {self.D} devices is not divisible by "
                f"{self._n_procs} processes")

    # --- device placement: local stripe -> global array ---

    @property
    def _local_D(self) -> int:
        return self.D // self._n_procs

    def _put_data(self, a):
        import jax

        a = np.asarray(a)
        return jax.make_array_from_process_local_data(self._data_sh, a)

    def _put_gdata(self, a):
        import jax

        a = np.asarray(a)
        return jax.make_array_from_process_local_data(self._gdata_sh, a)

    def _put_repl(self, a):
        import jax

        a = np.asarray(a)
        return jax.make_array_from_process_local_data(self._repl_sh, a,
                                                      a.shape)

    def _put_dstack(self, a):
        """Full (D, ...) stack -> sharded rows; ship only the local
        slice. (Each process still BUILDS the full stack on host --
        acceptable for index partitioning; the device memory is what
        sharding is for.)"""
        import jax

        a = np.asarray(a)
        lo = self._pid * self._local_D
        return jax.make_array_from_process_local_data(
            self._data_sh, np.ascontiguousarray(a[lo:lo + self._local_D]),
            a.shape)

    # --- count merge / checkpoint (collective on every process) ---

    def merge_counts(self):
        import jax

        if not hasattr(self, "_merge_repl"):
            self._merge_repl = jax.jit(
                lambda r, a: (r.sum(0), a.sum(0)),
                out_shardings=(self._repl_sh, self._repl_sh))
        return self._merge_repl(self.ref_cnt, self.alt_cnt)

    def _host_counts(self):
        rc, ac = self.merge_counts()
        # fully-replicated global arrays are host-readable on any process
        return np.asarray(rc), np.asarray(ac)

    def _restore_ckpt(self, rc, ac) -> None:
        rc = np.asarray(rc)
        ac = np.asarray(ac)
        if rc.ndim == 2:
            rc, ac = rc.sum(axis=0), ac.sum(axis=0)
        n = self.dix.n_sites
        lr = np.zeros((self._local_D, n + 1), np.int32)
        la = np.zeros((self._local_D, n + 1), np.int32)
        if self._pid == 0:   # merged totals live in global device row 0
            lr[0] = rc
            la[0] = ac
        self.ref_cnt = self._put_data(lr)
        self.alt_cnt = self._put_data(la)

    def _ckpt_save(self, path: str) -> None:
        """Merged counts are identical on every process; only process 0
        writes (a shared FS would race, per-host FSes just duplicate)."""
        from ..engine import checkpoint as ckpt

        arrays = self._ckpt_arrays()   # collective: all processes run it
        if self._pid == 0:
            ckpt.save(path, *arrays, self.n_reads)
        barrier("ckpt")

    # --- the multi-host host loops ---

    def _local_rows(self, arr) -> np.ndarray:
        """This process's rows of a (GB, ...) data-sharded global array,
        in global row order (== the rows this process parsed from its
        FASTQ stripe)."""
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards])

    def consume_fastq(self, fastq_path: str,
                      limit_batches: Optional[int] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 64) -> None:
        if self._mh_queued:
            return self._consume_queued_mh(fastq_path, limit_batches,
                                           checkpoint_path,
                                           checkpoint_every)
        return self._consume_inline(fastq_path, limit_batches,
                                    checkpoint_path, checkpoint_every)

    def _consume_queued_mh(self, fastq_path: str,
                           limit_batches: Optional[int],
                           checkpoint_path: Optional[str],
                           checkpoint_every: int) -> None:
        """Lockstep queued-retry host loop.

        Forward batches run ONE orientation; failed reads are re-dispatched
        reverse-complemented in dedicated retry batches, like the
        single-device queued loop (~1.5x device work at the workload's
        retry fraction vs the inline dual step's 2x). The multi-host
        difficulty is that the N host loops must dispatch identical
        sequences of device calls without negotiating: here the schedule is
        derived purely from REPLICATED state. Every process sees the same
        per-device `retry_n` stat rows (engine.batch `_finish_single`,
        replicated by the per-batch stats all_gather that escalation
        already requires), so every process tracks the same per-process
        pending-retry vector and fires a retry batch at the same loop
        points (any process's pending >= its per-process rows). Each
        process fills ITS rows of a retry batch from its OWN queue (a
        retry read stays on the process that parsed it -- counts are
        order-independent sums, so which global batch a retry rides in is
        irrelevant) and pads the rest; padding waste is bounded by stripe
        skew, ~0 for balanced streams."""
        from ..engine.geno import revcomp_select_host
        from ..io.fastq import iter_read_batches_strided, prefetch

        cfg = self.config
        LB = cfg.batch_reads * self._local_D    # this process's rows/batch
        depth = max(1, cfg.pipeline_depth)
        skip = 0
        if checkpoint_path:
            from ..engine import checkpoint as ckpt

            state = ckpt.load(checkpoint_path)
            if state is not None:
                rc, ac, meta = state
                self._restore_ckpt(rc, ac)
                skip = meta["n_reads"]
                self.n_reads = skip
        inflight: deque = deque()
        nb = 0
        n_retry_batches = 0
        # pending retries per PROCESS -- identical on every process by
        # construction (derived from replicated stats only)
        pend = np.zeros(self._n_procs, np.int64)
        seg_c: list = []   # local retry queue (front-consumed segments)
        seg_k: list = []
        seg_q: list = []
        n_local = 0
        L = None   # (LB, L) row width, learned from the first batch

        def dispatch_retry():
            nonlocal n_local, n_retry_batches
            n_retry_batches += 1
            take_all = np.minimum(pend, LB)
            self.n_retry_reads += int(take_all.sum())
            tc, tk, tq = [], [], []
            got = 0
            while seg_c and got < LB:
                need = LB - got
                c0 = seg_c[0]
                if c0.shape[0] <= need:
                    tc.append(seg_c.pop(0))
                    tk.append(seg_k.pop(0))
                    tq.append(seg_q.pop(0))
                    got += c0.shape[0]
                else:
                    tc.append(c0[:need])
                    tk.append(seg_k[0][:need])
                    tq.append(seg_q[0][:need])
                    seg_c[0] = c0[need:]
                    seg_k[0] = seg_k[0][need:]
                    seg_q[0] = seg_q[0][need:]
                    got += need
            if int(take_all[self._pid]) != got:
                raise RuntimeError(
                    f"multihost retry desync: replicated stats say "
                    f"{int(take_all[self._pid])} pending here, local "
                    f"queue held {got}")
            n_local -= got
            if got < LB:
                pad = LB - got
                Lw = tc[0].shape[1] if tc else L
                Kw = cfg.max_kmers_per_read
                tc.append(np.full((pad, Lw), 4, np.uint8))
                tk.append(np.zeros(pad, np.int32))
                tq.append(np.zeros((pad, Kw), np.uint8))
            codes = np.concatenate(tc) if len(tc) > 1 else tc[0]
            nk = np.concatenate(tk) if len(tk) > 1 else tk[0]
            qual = np.concatenate(tq) if len(tq) > 1 else tq[0]
            pend[:] = pend - take_all
            p = self._dispatch_batch(codes, nk, qual, single=True)
            p["count"] = 0
            p["fwd"] = None
            inflight.append(p)

        def finalize_one():
            p = inflight.popleft()
            self._finalize_batch(p)
            self.meter.bump(p["count"])
            if p["fwd"] is None:
                return
            nonlocal n_local
            keys = p["stats_keys"]
            rows = p["stats_rows"]          # (D, S) replicated
            rn = rows[:, keys.index("retry_n")].astype(np.int64)
            pend[:] = pend + rn.reshape(self._n_procs,
                                        self._local_D).sum(axis=1)
            codes, nk, qual = p["fwd"]
            proc_m = self._local_rows(p["process"])
            rok_m = self._local_rows(p["read_ok"])
            retry = (~proc_m) & rok_m & (nk > 0)
            sel = np.flatnonzero(retry)
            if sel.size:
                rc, k, q = revcomp_select_host(codes, nk, qual, sel)
                seg_c.append(rc)
                seg_k.append(k)
                seg_q.append(q)
                n_local += sel.size
            while pend.max() >= LB:
                dispatch_retry()

        def drain():
            while inflight:
                finalize_one()
            while pend.max() > 0:
                dispatch_retry()
                while inflight:
                    finalize_one()

        for batch in prefetch(iter_read_batches_strided(
                fastq_path, LB, self._n_procs, self._pid,
                cfg.max_read_len, cfg.max_kmers_per_read,
                skip_reads=skip)):
            L = batch.codes.shape[1]
            p = self._dispatch_batch(batch.codes, batch.n_kmers,
                                     batch.qual, single=True)
            self.n_reads += batch.global_n_valid
            p["count"] = batch.global_n_valid
            p["fwd"] = (batch.codes, batch.n_kmers, batch.qual)
            inflight.append(p)
            nb += 1
            while len(inflight) > depth:
                finalize_one()
            if checkpoint_path and nb % checkpoint_every == 0:
                drain()
                self._ckpt_save(checkpoint_path)
            if limit_batches and nb >= limit_batches:
                break
        drain()
        if checkpoint_path:
            self._ckpt_save(checkpoint_path)
        if self._pid == 0 and nb:
            import sys

            print(f"# multihost queued-retry: {nb} forward + "
                  f"{n_retry_batches} retry batches = "
                  f"{(nb + n_retry_batches) / nb:.3f}x device work/read "
                  f"(inline dual = 2.0x)", file=sys.stderr)
        overflow = {k: v for k, v in self.stats_totals.items()
                    if "overflow" in k and v}
        if overflow:
            import warnings

            warnings.warn(f"engine capacity overflows (results may "
                          f"diverge from reference): {overflow}")

    def _consume_inline(self, fastq_path: str,
                        limit_batches: Optional[int] = None,
                        checkpoint_path: Optional[str] = None,
                        checkpoint_every: int = 64) -> None:
        from ..io.fastq import iter_read_batches_strided, prefetch

        cfg = self.config
        LB = cfg.batch_reads * self._local_D
        skip = 0
        if checkpoint_path:
            from ..engine import checkpoint as ckpt

            state = ckpt.load(checkpoint_path)
            if state is not None:
                rc, ac, meta = state
                self._restore_ckpt(rc, ac)
                skip = meta["n_reads"]
                self.n_reads = skip
        inflight: deque = deque()
        depth = max(1, cfg.pipeline_depth)
        nb = 0
        for batch in prefetch(iter_read_batches_strided(
                fastq_path, LB, self._n_procs, self._pid,
                cfg.max_read_len, cfg.max_kmers_per_read,
                skip_reads=skip)):
            p = self._dispatch_batch(batch.codes, batch.n_kmers,
                                     batch.qual, single=False)
            self.n_reads += batch.global_n_valid
            p["count"] = batch.global_n_valid
            inflight.append(p)
            nb += 1
            while len(inflight) > depth:
                q = inflight.popleft()
                self._finalize_batch(q)
                self.meter.bump(q["count"])
            if checkpoint_path and nb % checkpoint_every == 0:
                while inflight:
                    q = inflight.popleft()
                    self._finalize_batch(q)
                    self.meter.bump(q["count"])
                self._ckpt_save(checkpoint_path)
            if limit_batches and nb >= limit_batches:
                break
        while inflight:
            q = inflight.popleft()
            self._finalize_batch(q)
            self.meter.bump(q["count"])
        if checkpoint_path:
            self._ckpt_save(checkpoint_path)
        overflow = {k: v for k, v in self.stats_totals.items()
                    if "overflow" in k and v}
        if overflow:
            import warnings

            warnings.warn(f"engine capacity overflows (results may "
                          f"diverge from reference): {overflow}")

    def write_vcf(self, vcf_in: str, vcf_out: str) -> None:
        calls = self.calls()   # collective (_host_counts) on all processes
        if self._pid == 0:
            from ..io.vcf_writer import write_calls_vcf

            write_calls_vcf(vcf_in, vcf_out, calls)
        barrier("vcf")


from .sharded_dict import ShardedDictGenoRunner  # noqa: E402
from .sharding import ShardedGenoRunner  # noqa: E402


class MultiHostGenoRunner(_MultiHostMixin, ShardedGenoRunner):
    """Data-parallel (replicated index) geno across processes."""


class MultiHostDictGenoRunner(_MultiHostMixin, ShardedDictGenoRunner):
    """Sharded-dictionary (all_to_all routed) geno across processes: dict
    shards span the GLOBAL device set, so N hosts hold indexes N times
    larger than one host's HBM; probe routing rides ICI within a host and
    DCN across."""
