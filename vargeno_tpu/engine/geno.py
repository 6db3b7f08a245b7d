"""End-to-end `geno` driver: FASTQ stream -> batched engine -> output VCF.

The device counterpart of the reference's genotype() (src/qv.cc:475-1787):
loads the index, streams fixed-shape read batches to the device, accumulates
per-site pileup counts on device, then calls genotypes (float64 host math for
bit-parity with the reference's double model) and rewrites the VCF.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GenoConfig, DEFAULT_CONFIG
from ..finalize import finalize_calls
from ..index import store
from ..io.fastq import iter_read_batches, prefetch
from ..io.vcf_writer import write_calls_vcf
from .batch import make_batch_processor
from .device_index import build_device_index


def _escalate_config(cfg: GenoConfig, tripped) -> GenoConfig:
    """Double every capacity whose overflow counter fired (the reference has
    no such caps -- its buffers are unbounded heap structures -- so any
    overflow means potential divergence; escalation restores exactness)."""
    upd: dict = {}

    def bump(field, cap=None):
        cur = upd.get(field, getattr(cfg, field))
        new = cur * 2
        if isinstance(cur, int):
            new = int(new)
        if cap is not None:
            new = min(new, cap)
        if new != cur:
            upd[field] = new

    for key in tripped:
        base = key.split("_", 1)[1] if key.startswith(("fwd_", "rev_")) \
            else key
        if base == "ni_overflow":
            bump("neighbor_item_frac", 1.0)
        elif base == "probe_overflow":
            bump("probe_hit_cap")
        elif base == "event_overflow":
            bump("events_per_read")
        elif base == "cand_overflow":
            bump("candidates_per_read")
        elif base == "snp_scan_overflow":
            bump("scan_slot_cap", cfg.block_size_threshold)
            bump("scan_active_frac", 1.0)
            # routed mode folds its compacted-scan + scan-route truncation
            # into the same stat key; bump its caps too (inert locally)
            bump("route_scan_slots", cfg.block_size_threshold)
            bump("route_factor", 64.0)
        elif base == "agree_overflow":
            bump("agree_cap")
        elif base == "sparse_overflow":
            bump("sparse_frac", 1.0)
        elif base == "act_overflow":
            bump("probe_active_frac", 1.0)
        elif base == "sev_overflow":
            bump("sparse_events_frac", 1.0)
        elif base == "site_slot_overflow":
            bump("sites_per_context", 32)
        elif base == "route_overflow":
            # sharded-dictionary mode: per-(src,dst) all_to_all lane cap
            bump("route_factor", 64.0)
    if not upd:
        return cfg
    return dataclasses.replace(cfg, **upd)


_merge_counts = jax.jit(lambda a, b, c, d: (a + c, b + d),
                        donate_argnums=(0, 1))
_pack_stats = jax.jit(
    lambda vals: jnp.stack([jnp.asarray(v, jnp.int32) for v in vals]))


def _prefetch_host(*arrs):
    """Start the device->host transfer of a sync value at DISPATCH time.

    Starting the copy as soon as the batch is dispatched lets the transfer
    ride the pipeline (depth batches are in flight) so _finalize_batch's
    later fetch finds the value host-resident. Best-effort: backends
    without copy_to_host_async simply fall through to the cold fetch."""
    for a in arrs:
        f = getattr(a, "copy_to_host_async", None)
        if f is not None:
            try:
                f()
            except Exception:  # noqa: BLE001 - optional fast path only
                pass


def revcomp_select_host(codes, nk, qual, sel):
    """Gather rows ``sel`` and reverse-complement them (qv.cc:787-806),
    native C when available (one pass, ~1 ms/batch) else numpy. Shared by
    the single-device retry queue and the multi-host lockstep retry
    protocol (dist.multihost)."""
    from .. import native

    if native.available():
        return native.revcomp_select(codes, nk, qual, sel)
    c = codes[sel]
    k = nk[sel]
    length = k * 32
    L = c.shape[1]
    idx = length[:, None] - 1 - np.arange(L)[None, :]
    valid = idx >= 0
    g = np.take_along_axis(c, np.clip(idx, 0, L - 1), axis=1)
    rc = np.where(g < 4, 3 - g, g)
    rc = np.where(valid, rc, 4).astype(np.uint8)
    return rc, k, qual[sel]


def _bits32(mask):
    """(..., B) bool -> (..., ceil(B/32)) i32 bit-pack."""
    b = mask.shape[-1]
    pad = (-b) % 32
    if pad:
        mask = jnp.concatenate(
            [mask, jnp.zeros(mask.shape[:-1] + (pad,), bool)], axis=-1)
    m = mask.reshape(mask.shape[:-1] + ((b + pad) // 32, 32))
    sh = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(
        jnp.where(m, jnp.uint32(1) << sh, jnp.uint32(0)),
        axis=-1, dtype=jnp.uint32).astype(jnp.int32)


@jax.jit
def _pack_host(svec, process, read_ok):
    """One flat i32 vector [stats | process bits | read_ok bits]: the
    host's per-batch sync is ONE value fetch instead of three (stats,
    process and read_ok), each a device->host round trip."""
    return jnp.concatenate([
        svec.astype(jnp.int32),
        _bits32(process).reshape(-1),
        _bits32(read_ok).reshape(-1)])


def _unpack_host(vals, n_stats: int, shape):
    """numpy inverse of _pack_host: (stats_row, process, read_ok)."""
    stats = vals[:n_stats]
    b = shape[-1]
    bp = b + ((-b) % 32)
    lead = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    nb = lead * (bp // 32)
    pb = vals[n_stats:n_stats + nb].astype(np.uint32)
    rb = vals[n_stats + nb:n_stats + 2 * nb].astype(np.uint32)

    def unpack(bits):
        sh = np.arange(32, dtype=np.uint32)
        full = ((bits[:, None] >> sh) & 1).astype(bool)
        return full.reshape(shape[:-1] + (bp,))[..., :b]

    return stats, unpack(pb), unpack(rb)


class GenoRunner:
    """Single-device geno.

    ``queued_orientation=True`` (default) runs each read forward once and
    queues only failed reads' reverse complements into later batches,
    mirroring the reference's retry-on-failure (qv.cc:1504-1510) at ~1.5x
    less device work than inlining both orientations every batch. Results
    are bit-identical either way (counts are order-independent).
    """

    # Chained accumulation: the running count totals are passed straight
    # through each step as its accumulator inputs (outputs become the new
    # totals), so a batch costs ONE device dispatch -- no per-batch zeros
    # or merge calls.
    # Overflow escalation REWINDS to the tripping batch's input totals and
    # immediately re-dispatches the tripping handle plus every LATER
    # in-flight handle in dispatch order (their outputs chained onto the
    # invalidated totals), so the rebuilt chain contains every batch
    # exactly once. Mesh runners keep fresh-buffers + late merge.
    _chain = True

    def __init__(self, index: store.VarGenoIndex,
                 config: GenoConfig = DEFAULT_CONFIG,
                 queued_orientation: bool = True,
                 metrics_path=None, dix=None):
        self.index = index
        self.config = config
        # dix: share one device-resident index across runners (sweeps,
        # cohort mode) instead of rebuilding/re-uploading it per runner
        self.dix = (build_device_index(
            index, ht_target_load=config.ht_target_load)
            if dix is None else dix)
        self._procs: dict = {}
        self._cfg_run = config   # escalated in place when capacities trip
        self.step = self._proc(config)
        self.queued = queued_orientation
        n = self.dix.n_sites
        self.ref_cnt = jnp.zeros(n + 1, jnp.int32)
        self.alt_cnt = jnp.zeros(n + 1, jnp.int32)
        self.stats_totals: dict = {}
        self.n_reads = 0
        self.n_retry_reads = 0   # reads re-dispatched reverse-complemented
                                 # (measured retry_frac for the roofline)
        self._inflight_chain: list = []   # chained handles, dispatch order
        self._tune_max: dict = {}   # per-batch telemetry maxima
        self._tune_seen = 0
        self._tuned = not config.auto_tune
        from ..utils.profiling import Meter

        self.meter = Meter(metrics_path)

    def _proc(self, cfg: GenoConfig):
        proc = self._procs.get(cfg)
        if proc is None:
            proc = self._procs[cfg] = make_batch_processor(self.dix, cfg)
        return proc

    # --- subclass hooks (dist.sharding overrides these to run the same
    # host loop -- pipelined dispatch, queued retries, escalation,
    # checkpointing -- over a device mesh) ---

    def _loop_batch(self) -> int:
        """Reads per host-loop batch (the mesh runner's is D x batch)."""
        return self.config.batch_reads

    def _fresh_counts(self):
        """Zeroed pileup accumulators in this runner's device layout."""
        n = self.dix.n_sites
        return jnp.zeros(n + 1, jnp.int32), jnp.zeros(n + 1, jnp.int32)

    def _host_counts(self):
        """Final (ref, alt) count arrays on host, merged across devices."""
        return np.asarray(self.ref_cnt), np.asarray(self.alt_cnt)

    def _ckpt_arrays(self):
        """Arrays persisted by a checkpoint (device-layout-independent)."""
        return self._host_counts()

    def _restore_ckpt(self, rc, ac) -> None:
        self.ref_cnt = jnp.asarray(rc)
        self.alt_cnt = jnp.asarray(ac)

    @staticmethod
    def _merge(trc, tac, rc, ac):
        return _merge_counts(trc, tac, rc, ac)

    def _dispatch_batch(self, codes, nk, qual, single: bool,
                        enc=None) -> dict:
        """Dispatch one batch into FRESH accumulators; returns the in-flight
        handle (device futures, nothing synced). Merging into the totals and
        the overflow check happen in _finalize_batch -- callers keep batches
        in flight (config.pipeline_depth) so the host prepares the next
        batches while the device runs this one. ``enc`` is an optional
        host-pre-encoded (hi, lo, kmer_valid, read_ok) tuple; when given,
        the packed words are shipped instead of the base codes."""
        proc = self._proc(self._cfg_run)
        self.step = proc
        if self._chain:
            z, z2 = self.ref_cnt, self.alt_cnt   # chained running totals
        else:
            z, z2 = self._fresh_counts()
        if enc is not None:
            assert single
            hi, lo, kv, rok = (jnp.asarray(a) for a in enc)
            rc, ac, process, read_ok, stats = proc.single_enc(
                hi, lo, kv, rok, jnp.asarray(qual), z, z2)
        elif single:
            rc, ac, process, read_ok, stats = proc.single(
                jnp.asarray(codes), jnp.asarray(nk), jnp.asarray(qual),
                z, z2)
        else:
            rc, ac, stats = proc(jnp.asarray(codes), jnp.asarray(nk),
                                 jnp.asarray(qual), z, z2)
            process = read_ok = None
        # pack the ~16 stat scalars -- and, in single mode, the process /
        # read_ok masks as bit vectors -- into ONE device buffer: every
        # separate value fetch costs a device->host round trip, so the
        # per-batch sync is one fetch
        keys = tuple(sorted(stats))
        svec = _pack_stats([stats[k] for k in keys])
        p = dict(rc=rc, ac=ac, stats_keys=keys, cfg=self._cfg_run,
                 redo=lambda: self._dispatch_batch(codes, nk, qual,
                                                   single, enc=enc),
                 rounds=0)
        if self._chain:
            p["totals_in"] = (z, z2)       # rewind point for escalation
            self.ref_cnt, self.alt_cnt = rc, ac
            self._inflight_chain.append(p)
        if process is not None:
            p["host_vec"] = _pack_host(svec, process, read_ok)
            p["mask_shape"] = tuple(process.shape)
            _prefetch_host(p["host_vec"])
        else:
            p["stats_vec"] = svec
            p["process"] = p["read_ok"] = None
            _prefetch_host(svec)
        return p

    def _dispatch_group(self, encs, quals) -> dict:
        """Dispatch a group of G pre-encoded sub-batches as ONE scanned
        device call (engine.batch step_multi_enc): one transfer, one launch,
        one packed stats readback for the whole group."""
        proc = self._proc(self._cfg_run)
        self.step = proc
        hi = jnp.asarray(np.stack([e[0] for e in encs]))
        lo = jnp.asarray(np.stack([e[1] for e in encs]))
        kv = jnp.asarray(np.stack([e[2] for e in encs]))
        rok = jnp.asarray(np.stack([e[3] for e in encs]))
        qual = jnp.asarray(np.stack(quals))
        if self._chain:
            z, z2 = self.ref_cnt, self.alt_cnt
        else:
            z, z2 = self._fresh_counts()
        rc, ac, process, read_ok, stats = proc.multi_enc(
            hi, lo, kv, rok, qual, z, z2)
        keys = tuple(sorted(stats))
        svec = _pack_stats([stats[k] for k in keys])
        hv = _pack_host(svec, process, read_ok)
        _prefetch_host(hv)
        p = dict(rc=rc, ac=ac, stats_keys=keys, cfg=self._cfg_run,
                 host_vec=hv,
                 mask_shape=tuple(process.shape),
                 redo=lambda: self._dispatch_group(encs, quals),
                 rounds=0)
        if self._chain:
            p["totals_in"] = (z, z2)
            self.ref_cnt, self.alt_cnt = rc, ac
            self._inflight_chain.append(p)
        return p

    def _finalize_batch(self, p: dict):
        """Sync p's overflow counters; if any capacity tripped, escalate and
        re-run the batch (deterministic, so the merged counts match a
        reference run exactly even when the first attempt truncated); then
        merge its counts into the totals. Returns (process, read_ok) --
        already-decoded numpy arrays when the dispatch packed them.

        The sync is ONE value fetch per batch: dispatches with host-side
        retry queueing pack [stats | process bits | read_ok bits] into a
        single device vector (_pack_host)."""
        process = read_ok = None
        while True:
            if "host_vec" in p:
                vals = self._fetched_vals(p)       # the one transfer
                srow, process, read_ok = _unpack_host(
                    vals, len(p["stats_keys"]), p["mask_shape"])
                stats = dict(zip(p["stats_keys"], srow.tolist()))
            else:
                vals = np.asarray(p["stats_vec"])
                process, read_ok = p["process"], p["read_ok"]
                if vals.ndim == 2:   # mesh runners: per-device (D, S) rows
                    p["stats_rows"] = vals   # multi-host retry scheduler
                    stats = {k: int(vals[:, i].max() if k.endswith("_max")
                                    else vals[:, i].sum())
                             for i, k in enumerate(p["stats_keys"])}
                    # capacities are per-device shapes: tune on the max
                    # single-device value, not the cross-device sum
                    p["tune_vals"] = {k: int(vals[:, i].max())
                                      for i, k in enumerate(p["stats_keys"])}
                else:
                    stats = dict(zip(p["stats_keys"], vals.tolist()))
            tripped = [k for k, v in stats.items()
                       if "overflow" in k and v]
            if not tripped or p["rounds"] >= self.config.auto_retry_max:
                break
            new_cfg = _escalate_config(self._cfg_run, tripped)
            if new_cfg == self._cfg_run and p.get("cfg") == self._cfg_run:
                break   # caps already at their limits for this attempt
            # With pipelined dispatch, several batches fly at the OLD
            # config; a sibling may have escalated _cfg_run past what this
            # attempt used, in which case redo at the current config even
            # though escalation itself has no further step to take.
            self._cfg_run = new_cfg
            rounds = p["rounds"] + 1
            if self._chain:
                self._chain_rewind(p)
            else:
                q = p["redo"]()
                p.update(q)
            p["rounds"] = rounds
        if self._chain:
            try:
                self._inflight_chain.remove(p)
            except ValueError:
                pass
        else:
            self.ref_cnt, self.alt_cnt = self._merge(
                self.ref_cnt, self.alt_cnt, p["rc"], p["ac"])
        self._bump(stats)
        if not self._tuned:
            if "tune_vals" in p:   # mesh runners: per-device maxima
                self._maybe_tune(p["tune_vals"])
            else:
                self._maybe_tune(stats)
        return process, read_ok

    # --- fetch worker: the per-batch one-value sync off the dispatch
    # thread, so the dispatch thread does not block in np.asarray while
    # depth batches are in flight ---

    def _fetched_vals(self, p: dict) -> np.ndarray:
        """p's synced host vector: the worker's pre-fetched copy when it
        matches the CURRENT host_vec (escalation redo replaces host_vec,
        invalidating any in-flight fetch of the old one), else a direct
        fetch."""
        hv = p["host_vec"]
        f = p.get("fetched")
        if f is None or f[0] is not hv:
            evt = p.get("fetch_evt")
            if evt is not None and p.get("submitted_hv") is hv:
                evt.wait()
                f = p["fetched"]
        if f is not None and f[0] is hv:
            if isinstance(f[1], Exception):
                raise f[1]
            return f[1]
        return np.asarray(hv)

    def _start_fetch_worker(self):
        """(submit, stop): submit(p) hands an in-flight handle to a worker
        thread that blocks on its device->host value fetch, so the dispatch
        thread never waits on a batch that hasn't landed. FIFO matches the
        pipeline's finalize order."""
        import queue
        import threading

        fq: "queue.Queue" = queue.Queue()

        def worker():
            while True:
                item = fq.get()
                if item is None:
                    return
                p, hv, evt = item
                try:
                    vals = np.asarray(hv)
                    p["fetched"] = (hv, vals)
                except Exception as e:  # noqa: BLE001 - surfaced at finalize
                    p["fetched"] = (hv, e)
                evt.set()

        t = threading.Thread(target=worker, daemon=True)
        t.start()

        def submit(p):
            if "host_vec" not in p:
                return
            evt = threading.Event()
            p["fetch_evt"] = evt
            p["submitted_hv"] = p["host_vec"]
            fq.put((p, p["host_vec"], evt))

        def stop():
            fq.put(None)
            t.join(timeout=5)

        return submit, stop

    def _maybe_tune(self, stats: dict) -> None:
        """Accumulate per-batch telemetry maxima; once ``tune_batches``
        batches are seen, shrink lane capacities to measured maxima x
        headroom and recompile once (engine.autotune). Overflow escalation
        keeps results exact if a tuned cap later trips."""
        from .autotune import TUNE_KEYS, tuned_config

        for k, v in stats.items():
            base = k.split("_", 1)[1] if k.startswith(("fwd_", "rev_")) \
                else k
            if base in TUNE_KEYS:
                self._tune_max[base] = max(self._tune_max.get(base, 0),
                                           int(v))
        self._tune_seen += 1
        if self._tune_seen < self.config.tune_batches:
            return
        self._tuned = True
        new = tuned_config(self._cfg_run, self.dix, self._tune_max,
                           self.config.tune_headroom)
        if new != self._cfg_run:
            self._cfg_run = new

    def _chain_rewind(self, p: dict) -> None:
        """Escalation rewind for chained accumulation: restore the totals
        to before handle ``p``'s (truncated) contribution, then re-dispatch
        p and every LATER in-flight handle in dispatch order, updating each
        handle dict IN PLACE so callers' references (pipeline deques) see
        the redone dispatches. The rebuilt chain contains every batch
        exactly once."""
        idx = self._inflight_chain.index(p)
        later = self._inflight_chain[idx + 1:]
        self.ref_cnt, self.alt_cnt = p["totals_in"]
        del self._inflight_chain[idx:]
        for q in [p] + later:
            rounds = q["rounds"]
            q2 = q["redo"]()   # re-appends itself to _inflight_chain
            # keep the caller's dict identity: move q2's contents into q
            q.update(q2)
            q["rounds"] = rounds
            self._inflight_chain[-1] = q

    def _run_batch(self, codes, nk, qual, single: bool):
        """Dispatch + finalize in one (unpipelined) call."""
        p = self._dispatch_batch(codes, nk, qual, single)
        return self._finalize_batch(p)

    def consume_fastq(self, fastq_path: str,
                      limit_batches: Optional[int] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 64) -> None:
        cfg = self.config
        nb = 0
        skip = 0
        if checkpoint_path:
            from . import checkpoint as ckpt

            state = ckpt.load(checkpoint_path)
            if state is not None:
                rc, ac, meta = state
                self._restore_ckpt(rc, ac)
                skip = meta["n_reads"]
                self.n_reads = skip
        if self.queued:
            consumed = self._consume_queued(fastq_path, skip, limit_batches,
                                            checkpoint_path,
                                            checkpoint_every)
        else:
            pending = None
            for batch in prefetch(iter_read_batches(
                    fastq_path, self._loop_batch(), cfg.max_read_len,
                    cfg.max_kmers_per_read, skip_reads=skip)):
                cur = self._dispatch_batch(batch.codes, batch.n_kmers,
                                           batch.qual, single=False)
                self.n_reads += batch.n_valid
                if pending is not None:
                    self._finalize_batch(pending)
                pending = cur
                nb += 1
                if checkpoint_path and nb % checkpoint_every == 0:
                    self._finalize_batch(pending)
                    pending = None
                    from . import checkpoint as ckpt

                    ckpt.save(checkpoint_path, *self._ckpt_arrays(),
                              self.n_reads)
                if limit_batches and nb >= limit_batches:
                    break
            if pending is not None:
                self._finalize_batch(pending)
        if checkpoint_path:
            from . import checkpoint as ckpt

            ckpt.save(checkpoint_path, *self._ckpt_arrays(), self.n_reads)
        overflow = {k: v for k, v in self.stats_totals.items()
                    if "overflow" in k and v}
        if overflow:
            import warnings
            warnings.warn(f"engine capacity overflows (results may diverge "
                          f"from reference): {overflow}")

    def _bump(self, stats):
        for k, v in stats.items():
            if k.endswith("_max"):  # telemetry maxima, not counters
                self.stats_totals[k] = max(self.stats_totals.get(k, 0),
                                           int(v))
            else:
                self.stats_totals[k] = self.stats_totals.get(k, 0) + int(v)

    def _consume_queued(self, fastq_path, skip, limit_batches,
                        checkpoint_path, checkpoint_every):
        import os
        from collections import deque

        from ..utils.profiling import StageTimer

        st = StageTimer(sync=False) if os.environ.get("VGT_TIMING") else None

        cfg = self.config
        B = self._loop_batch()
        depth = max(1, cfg.pipeline_depth)
        # fetch-lag slack: the dispatch thread keeps dispatching while the
        # fetch worker waits on batches the device hasn't finished; the
        # hard cap bounds device memory (each handle chains 2 count
        # buffers) and escalation-rewind cost
        hard = depth + 6
        submit_fetch, stop_fetch = self._start_fetch_worker()
        pend_codes = []
        pend_nk = []
        pend_qual = []
        pend_n = 0
        nb = 0
        inflight: deque = deque()   # depth-deep dispatch pipeline

        if cfg.pre_encode:
            from .. import native

            if native.available():
                encode = lambda c, k: native.encode_batch(
                    c, k, cfg.max_kmers_per_read)
            else:
                from ..core.kmer import np_encode_batch

                encode = lambda c, k: np_encode_batch(
                    c, k, cfg.max_kmers_per_read)
        else:
            encode = None

        G = max(1, cfg.group_size) if encode is not None else 1
        stage_buf: list = []   # staged (enc, qual, count, host) sub-batches

        def dispatch(codes, nk, qual, count_reads, host, enc=None):
            """host = (codes, nk, qual, n_valid) for forward batches whose
            failures must be re-queued reverse-complemented; None for the
            retry batches themselves (the reference tries exactly two
            orientations, qv.cc:1504-1510). ``enc``: pre-packed kmer words
            when the producer thread already encoded the batch."""
            nonlocal nb
            self.n_reads += count_reads
            nb += 1
            if encode is None:
                p = self._dispatch_batch(codes, nk, qual, single=True)
                p["count"] = count_reads
                p["hosts"] = [host]
                submit_fetch(p)
                inflight.append(p)
                return
            if enc is None:
                enc = encode(codes, nk)
            stage_buf.append((enc, qual, count_reads, host))
            if len(stage_buf) >= G:
                flush_stage()

        def flush_stage(force=False):
            """Dispatch staged sub-batches: full groups as one scanned call;
            on force, leftovers go as single-enc dispatches."""
            while len(stage_buf) >= G and G > 1:
                grp, del_n = stage_buf[:G], G
                del stage_buf[:del_n]
                p = self._dispatch_group([g[0] for g in grp],
                                         [g[1] for g in grp])
                p["count"] = sum(g[2] for g in grp)
                p["hosts"] = [g[3] for g in grp]
                submit_fetch(p)
                inflight.append(p)
            while stage_buf and (force or G == 1):
                enc, qual, count, host = stage_buf.pop(0)
                p = self._dispatch_batch(None, None, qual, single=True,
                                         enc=enc)
                p["count"] = count
                p["hosts"] = [host]
                submit_fetch(p)
                inflight.append(p)

        def pump(force=False):
            import contextlib

            while inflight and (force or len(inflight) > depth):
                head = inflight[0]
                evt = head.get("fetch_evt")
                if (not force and len(inflight) <= hard
                        and evt is not None and not evt.is_set()):
                    # head hasn't landed: keep dispatching instead of
                    # blocking (the fetch worker will flag it ready)
                    break
                p = inflight.popleft()
                with (st.stage("finalize_wait") if st
                      else contextlib.nullcontext()):
                    process, read_ok = self._finalize_batch(p)
                    if any(h is not None for h in p["hosts"]):
                        process = np.asarray(process)
                        read_ok = np.asarray(read_ok)
                self.meter.bump(p["count"])
                hosts = p["hosts"]
                if any(h is not None for h in hosts):
                    with (st.stage("enqueue_retry") if st
                          else contextlib.nullcontext()):
                        if len(hosts) == 1:
                            if hosts[0] is not None:
                                enqueue_failures(*hosts[0], process,
                                                 read_ok)
                        else:
                            for g, h in enumerate(hosts):
                                if h is not None:
                                    enqueue_failures(*h, process[g],
                                                     read_ok[g])

        def enqueue_failures(codes, nk, qual, n_valid, process, read_ok):
            nonlocal pend_n
            retry = (~process) & read_ok & (nk > 0)
            retry[n_valid:] = False
            if not retry.any():
                return
            sel = np.flatnonzero(retry)
            self.n_retry_reads += sel.size
            rc, k, q = revcomp_select_host(codes, nk, qual, sel)
            pend_codes.append(rc)
            pend_nk.append(k)
            pend_qual.append(q)
            pend_n += sel.size

        def flush_pending(force=False):
            nonlocal pend_n
            while pend_n >= B or (force and pend_n > 0):
                # consume B rows from the FRONT of the queue segments:
                # copies exactly one batch per flush instead of
                # re-concatenating the whole queue (~8 ms/batch saved)
                tc, tk, tq = [], [], []
                got = 0
                while pend_codes and got < B:
                    need = B - got
                    c0 = pend_codes[0]
                    if c0.shape[0] <= need:
                        tc.append(pend_codes.pop(0))
                        tk.append(pend_nk.pop(0))
                        tq.append(pend_qual.pop(0))
                        got += c0.shape[0]
                    else:
                        tc.append(c0[:need])
                        tk.append(pend_nk[0][:need])
                        tq.append(pend_qual[0][:need])
                        pend_codes[0] = c0[need:]
                        pend_nk[0] = pend_nk[0][need:]
                        pend_qual[0] = pend_qual[0][need:]
                        got += need
                if got < B:
                    pad = B - got
                    tc.append(np.full((pad, tc[0].shape[1]), 4, np.uint8))
                    tk.append(np.zeros(pad, np.int32))
                    tq.append(np.zeros((pad, tq[0].shape[1]), np.uint8))
                take = np.concatenate(tc) if len(tc) > 1 else tc[0]
                take_k = np.concatenate(tk) if len(tk) > 1 else tk[0]
                take_q = np.concatenate(tq) if len(tq) > 1 else tq[0]
                # queue state is updated BEFORE pump(): finalizing an
                # in-flight forward batch during pump() may append retries
                pend_n -= got
                dispatch(take, take_k, take_q, 0, None)
                pump()

        def drain():
            # finalize everything staged + in flight, then run the retry
            # queue to empty (finalizing a retry batch never enqueues more)
            flush_stage(force=True)
            pump(force=True)
            flush_pending(force=True)
            flush_stage(force=True)
            pump(force=True)

        import contextlib

        base_it = iter_read_batches(
            fastq_path, B, cfg.max_read_len, cfg.max_kmers_per_read,
            skip_reads=skip)
        # G == 1: ALSO start the device upload in the producer thread --
        # device_put is async, so issuing it off-thread overlaps the
        # ~1 MB/batch host->device transfer with the dispatch loop instead
        # of paying it inside jnp.asarray at dispatch time. Grouped
        # staging (G > 1) np.stacks sub-batches on host, and mesh runners
        # do their own sharded placement (_put_data would round-trip a
        # pre-placed array through np.asarray), so both keep numpy.
        pre_up = (encode is not None and G == 1
                  and getattr(self, "_producer_upload", True))
        if encode is not None:
            # encode in the PRODUCER thread: the native parse + pack both
            # release the GIL, so they overlap the main thread's dispatch
            # loop instead of serializing into it (~10-15 ms/batch)
            def _producer():
                for b in base_it:
                    e = encode(b.codes, b.n_kmers)
                    if pre_up:
                        yield (b, tuple(jnp.asarray(x) for x in e),
                               jnp.asarray(b.qual))
                    else:
                        yield b, e, None
        else:
            def _producer():
                for b in base_it:
                    yield b, None, None

        it = iter(prefetch(_producer(), depth=3))
        try:
            while True:
                with (st.stage("read_batch") if st
                      else contextlib.nullcontext()):
                    item = next(it, None)
                if item is None:
                    break
                batch, enc0, q_dev = item
                with (st.stage("dispatch") if st
                      else contextlib.nullcontext()):
                    dispatch(batch.codes, batch.n_kmers,
                             batch.qual if q_dev is None else q_dev,
                             batch.n_valid,
                             (batch.codes, batch.n_kmers, batch.qual,
                              batch.n_valid), enc=enc0)
                pump()
                flush_pending()
                if checkpoint_path and nb % checkpoint_every == 0:
                    drain()
                    from . import checkpoint as ckpt

                    ckpt.save(checkpoint_path, *self._ckpt_arrays(),
                              self.n_reads)
                if limit_batches and nb >= limit_batches:
                    break
            drain()
        finally:
            stop_fetch()
        if st:
            import sys

            print(st.report(), file=sys.stderr)
        return nb

    def calls(self):
        s = self.index.sites
        n = s.pos.shape[0]
        rc, ac = self._host_counts()
        ref = np.minimum(rc[:n], self.config.max_cov)
        alt = np.minimum(ac[:n], self.config.max_cov)
        return finalize_calls(self.index.chrlens, s.pos, s.ref, s.alt,
                              s.rf, s.af, ref, alt, self.config)

    def write_vcf(self, vcf_in: str, vcf_out: str) -> None:
        write_calls_vcf(vcf_in, vcf_out, self.calls())


def run_geno(prefix: str, fastq_path: str, vcf_in: str, vcf_out: str,
             config: GenoConfig = DEFAULT_CONFIG) -> GenoRunner:
    t0 = time.time()
    index = store.load_npz(prefix)
    runner = GenoRunner(index, config)
    runner.consume_fastq(fastq_path)
    runner.write_vcf(vcf_in, vcf_out)
    print(f"Time: {time.time()-t0:.3f} sec "
          f"({runner.n_reads} reads, "
          f"{runner.stats_totals.get('n_processed', 0)} matched)")
    return runner
