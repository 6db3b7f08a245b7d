"""Command-line interface, drop-in compatible with the reference's surface.

  vargeno-tpu index <ref.fa> <snps.vcf> <prefix>
  vargeno-tpu geno  <prefix> <reads.fq> <snps.vcf> <out.vcf>
  vargeno-tpu vcfbf <ref.fa> <snps.vcf> <ref.bf> <snp.bf>   (gbf equivalent)
  vargeno-tpu filt  <prefix> <out_prefix>                   (dict_filt)

(reference dispatch: src/qv.cc:1888-2395; gbf: src/gbf.cc:11-71)
Extra flags select the native .vgt.npz format and/or the reference's binary
formats, engine batch shapes, and the stride-bug compatibility toggle.
"""

from __future__ import annotations

import argparse
import sys

from .errors import InputError


def _add_engine_flags(p):
    p.add_argument("--batch-reads", type=int, default=32768,
                   help="reads per device batch (fixed per-batch dispatch "
                        "overheads amortize with size; short inputs just "
                        "run one padded batch)")
    p.add_argument("--max-read-len", type=int, default=None,
                   help="padded read length (default: auto-sized from a "
                        "FASTQ peek, 128..992, so long-read inputs are "
                        "never silently truncated)")
    p.add_argument("--no-stride-bug", action="store_true",
                   help="disable replication of the reference's small-block "
                        "scan pointer bug (qv.cc:359) - 'intended' behavior")
    g = p.add_argument_group("engine capacities (auto-escalated on "
                             "overflow; see --auto-retry-max)")
    g.add_argument("--events-per-read", type=int, default=None)
    g.add_argument("--candidates-per-read", type=int, default=None)
    g.add_argument("--neighbor-item-frac", type=float, default=None)
    g.add_argument("--probe-hit-cap", type=int, default=None)
    g.add_argument("--agree-cap", type=int, default=None)
    g.add_argument("--scan-slot-cap", type=int, default=None)
    g.add_argument("--auto-retry-max", type=int, default=None,
                   help="max per-batch cap-doubling rounds (0 disables)")
    g.add_argument("--no-auto-tune", action="store_true",
                   help="disable runtime capacity auto-tuning (by default "
                        "lane capacities shrink to measured maxima after a "
                        "few batches and the step recompiles once)")
    h = p.add_argument_group("host dispatch pipeline")
    h.add_argument("--group-size", type=int, default=None,
                   help="sub-batches scanned per device dispatch "
                        "(amortizes dispatch-link latency)")
    h.add_argument("--pipeline-depth", type=int, default=None,
                   help="in-flight dispatches kept by the host loop")
    h.add_argument("--no-pre-encode", action="store_true",
                   help="ship raw base codes instead of host-packed "
                        "kmer words")


def _config(args, fastqs=()):
    from .config import GenoConfig

    kw = {}
    if hasattr(args, "batch_reads"):
        L = args.max_read_len
        if L is None:
            L, K = 128, 4
            if fastqs:   # auto-size so long reads are never truncated
                from .io.fastq import autosize_shapes

                shapes = [autosize_shapes(fq) for fq in fastqs]
                L = max(s[0] for s in shapes)
                K = max(s[1] for s in shapes)
        else:
            K = max(1, L // 32)
        kw = dict(batch_reads=args.batch_reads,
                  max_read_len=L,
                  max_kmers_per_read=K,
                  replicate_stride_bug=not args.no_stride_bug)
        for f in ("events_per_read", "candidates_per_read",
                  "neighbor_item_frac", "probe_hit_cap", "agree_cap",
                  "scan_slot_cap", "auto_retry_max", "group_size",
                  "pipeline_depth"):
            v = getattr(args, f, None)
            if v is not None:
                kw[f] = v
        if getattr(args, "no_pre_encode", False):
            kw["pre_encode"] = False
        kw["auto_tune"] = not getattr(args, "no_auto_tune", False)
    return GenoConfig(**kw)


def geno(args):
    """The `geno` subcommand; returns the runner it drove (in-process
    callers read its counts and telemetry)."""
    if args.multihost:
        # before ANY jax backend use in this process
        from .dist import multihost

        multihost.initialize(args.multihost, args.num_processes,
                             args.process_id,
                             cpu_devices=args.mh_cpu_devices)
    cfg = _config(args, fastqs=(args.reads_fq,))
    from .index import store

    index = store.load(args.prefix)
    if args.multihost:
        from .dist import multihost
        from .dist.sharding import make_mesh

        mesh = make_mesh(args.mesh or None)
        cls = (multihost.MultiHostDictGenoRunner if args.sharded_dict
               else multihost.MultiHostGenoRunner)
        runner = cls(index, mesh, cfg,
                     queued_orientation=not args.mh_inline_dual,
                     metrics_path=args.metrics)
    elif args.mesh:
        from .dist.sharded_dict import ShardedDictGenoRunner
        from .dist.sharding import ShardedGenoRunner, make_mesh

        mesh = make_mesh(args.mesh)
        cls = (ShardedDictGenoRunner if args.sharded_dict
               else ShardedGenoRunner)
        runner = cls(index, mesh, cfg, metrics_path=args.metrics)
    else:
        from .engine.geno import GenoRunner

        runner = GenoRunner(index, cfg, metrics_path=args.metrics)
    runner.consume_fastq(args.reads_fq,
                         checkpoint_path=args.checkpoint,
                         limit_batches=args.limit_batches)
    if args.metrics:
        runner.meter.emit()
    runner.write_vcf(args.snp_vcf, args.out_vcf)
    if args.multihost:
        import jax

        multihost.barrier("done")
        jax.distributed.shutdown()
    return runner


def main(argv=None):
    try:
        return _main(argv)
    except InputError as e:
        # malformed user input: one actionable line, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vargeno-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="build dictionaries + Bloom filters")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("prefix")
    p.add_argument("--reference-format", action="store_true",
                   help="also write the reference's .dict/.bf binary formats")

    p = sub.add_parser("geno", help="genotype reads")
    p.add_argument("prefix")
    p.add_argument("reads_fq")
    p.add_argument("snp_vcf")
    p.add_argument("out_vcf")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path for resumable runs")
    p.add_argument("--limit-batches", type=int, default=None,
                   help="stop after N host-loop batches (checkpoint "
                        "testing / partial runs)")
    p.add_argument("--metrics", default=None,
                   help="append jsonl throughput metrics to this path")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel over N devices (0 = single device; "
                        "with --multihost, 0 = all global devices)")
    p.add_argument("--sharded-dict", action="store_true",
                   help="partition dictionaries across the mesh "
                        "(all_to_all routed probes)")
    m = p.add_argument_group("multi-host (jax.distributed; run the same "
                             "command on every host with its process-id)")
    m.add_argument("--multihost", default=None, metavar="HOST:PORT",
                   help="coordinator address -> multi-process execution")
    m.add_argument("--num-processes", type=int, default=1)
    m.add_argument("--process-id", type=int, default=0)
    m.add_argument("--mh-cpu-devices", type=int, default=0,
                   help="force a virtual CPU host with N local devices "
                        "(local multi-process validation)")
    m.add_argument("--mh-inline-dual", action="store_true",
                   help="forward+reverse in one dispatch (2x device work) "
                        "instead of the default lockstep queued-retry "
                        "(~1.5x); results are bit-identical")
    _add_engine_flags(p)

    p = sub.add_parser("cohort", help="genotype multiple samples")
    p.add_argument("prefix")
    p.add_argument("snp_vcf")
    p.add_argument("out_pattern", help="per-sample output, e.g. out_{sample}.vcf")
    p.add_argument("samples", nargs="+",
                   help="name=reads.fq pairs")
    p.add_argument("--mesh", type=int, default=0,
                   help="stream each sample data-parallel over N devices")
    _add_engine_flags(p)

    sub.add_parser("help", help="show this help (reference: qv.cc:1853)")

    p = sub.add_parser("vcfd", help="build dictionaries only (legacy vcfd)")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("ref_dict")
    p.add_argument("snp_dict")

    p = sub.add_parser("kmerc", help="count distinct LO32/LO40 k-mer halves "
                                     "(BF sizing tool, reference kmerc)")
    p.add_argument("ref_fasta")

    p = sub.add_parser(
        "genotype",
        help="legacy 7-arg form; a NO-OP in the reference (the genotype() "
             "call is commented out, src/qv.cc:2092) - use `geno`")
    p.add_argument("legacy_args", nargs="*")

    p = sub.add_parser("oracle-geno",
                       help="run the sequential oracle engine (debug / "
                            "bit-parity reference mode)")
    p.add_argument("prefix")
    p.add_argument("reads_fq")
    p.add_argument("snp_vcf")
    p.add_argument("out_vcf")

    p = sub.add_parser("vcfbf", help="build Bloom filters only (gbf vcf)")
    p.add_argument("ref_fasta")
    p.add_argument("snp_vcf")
    p.add_argument("ref_bf")
    p.add_argument("snp_bf")

    p = sub.add_parser("ucscd", help="build dicts from UCSC SNP txt")
    p.add_argument("ref_fasta")
    p.add_argument("snp_txt")
    p.add_argument("ref_dict")
    p.add_argument("snp_dict")

    p = sub.add_parser("ucscbf", help="build Bloom filters from UCSC txt")
    p.add_argument("ref_fasta")
    p.add_argument("snp_txt")
    p.add_argument("ref_bf")
    p.add_argument("snp_bf")

    p = sub.add_parser("encodebf",
                       help="SNP Bloom filter from raw values; without "
                       "--ref-fasta this is `gbf snp`, with it `gbf encode`"
                       " (both reference:src/gbf.cc:31-66)")
    p.add_argument("encode_file")
    p.add_argument("snp_bf")
    p.add_argument("--ref-fasta", default=None,
                   help="also build the genome Bloom filter (gbf encode)")
    p.add_argument("--ref-bf", default=None,
                   help="output path for the genome BF (with --ref-fasta)")

    p = sub.add_parser("filt", help="shrink ref dict to SNP-proximal k-mers")
    p.add_argument("prefix")
    p.add_argument("out_prefix")

    return ap


def _main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.cmd == "help":
        # reference: `vargeno help` prints usage (src/qv.cc:1853-1873)
        ap.print_help()
        return 0

    if args.cmd == "index":
        from .index.build import build_index

        build_index(args.ref_fasta, args.snp_vcf, args.prefix,
                    write_reference_format=args.reference_format)
        return 0

    if args.cmd == "geno":
        geno(args)
        return 0

    if args.cmd == "cohort":
        from .engine.cohort import CohortRunner
        from .index import store

        pairs = [s.split("=", 1) for s in args.samples]
        index = store.load(args.prefix)
        mesh = None
        if args.mesh:
            from .dist.sharding import make_mesh

            mesh = make_mesh(args.mesh)
        runner = CohortRunner(index, [n for n, _ in pairs],
                              _config(args, fastqs=[f for _, f in pairs]),
                              mesh=mesh)
        for name, fq in pairs:
            runner.consume_sample(name, fq)
        runner.write_vcfs(args.snp_vcf, args.out_pattern)
        return 0

    if args.cmd == "vcfd":
        from .index import dictgen, store
        from .io import fasta as fasta_io

        seqs = fasta_io.parse_fasta(args.ref_fasta)
        with open(args.ref_fasta + ".chrlens", "w") as f:
            f.write(fasta_io.chrlens_text(seqs))
        snp_dict, _ = dictgen.build_snp_dict_from_vcf(seqs, args.snp_vcf)
        ref_dict, _ = dictgen.build_ref_dict(seqs)
        store.write_snp_dict(args.snp_dict, snp_dict)
        store.write_ref_dict(args.ref_dict, ref_dict)
        return 0

    if args.cmd == "genotype":
        print("`genotype` is a no-op in the reference binary "
              "(src/qv.cc:2092); use `geno`.", file=sys.stderr)
        return 0

    if args.cmd == "oracle-geno":
        import numpy as np

        from .finalize import finalize_calls
        from .index import store
        from .io.vcf_writer import write_calls_vcf
        from .oracle import OracleEngine

        index = store.load(args.prefix)
        eng = OracleEngine(index)
        eng.run_fastq(args.reads_fq)
        s = index.sites
        rc = np.array([eng.pileup[int(p)][4] for p in s.pos])
        ac = np.array([eng.pileup[int(p)][5] for p in s.pos])
        calls = finalize_calls(index.chrlens, s.pos, s.ref, s.alt, s.rf,
                               s.af, rc, ac, eng.config)
        write_calls_vcf(args.snp_vcf, args.out_vcf, calls)
        return 0

    if args.cmd == "kmerc":
        import numpy as np

        from .core.kmer import np_rolling_kmers_u64, np_window_has_n
        from .io import fasta as fasta_io

        seqs = fasta_io.parse_fasta(args.ref_fasta)
        lo32 = set()
        lo40_count = 0
        all40 = []
        for s in seqs:
            codes = s.codes_normalized()
            roll = np_rolling_kmers_u64(codes)
            ok = ~np_window_has_n(codes)
            k = roll[ok]
            lo32.update(np.unique(k & np.uint64(0xFFFFFFFF)).tolist())
            all40.append(np.unique(k & np.uint64(0xFF_FFFF_FFFF)))
        n40 = np.unique(np.concatenate(all40)).size if all40 else 0
        print(f"distinct LO32: {len(lo32)}")
        print(f"distinct LO40: {n40}")
        return 0

    if args.cmd == "vcfbf":
        from .config import DEFAULT_CONFIG as cfg
        from .index import bloom, store
        from .io import fasta as fasta_io

        seqs = fasta_io.parse_fasta(args.ref_fasta)
        ref_bf, lite = bloom.build_ref_bfs(seqs, cfg.ref_bf_bits,
                                           cfg.ref_lite_bf_bits)
        snp_bf = bloom.build_snp_bf(seqs, args.snp_vcf, cfg.snp_bf_bits)
        store.write_sdsl_bf(args.ref_bf, ref_bf)
        store.write_sdsl_bf(args.ref_bf + ".lite.bf", lite)
        store.write_sdsl_bf(args.snp_bf, snp_bf)
        return 0

    if args.cmd == "filt":
        from .index import filt

        filt.filt_prefix(args.prefix, args.out_prefix)
        return 0

    if args.cmd == "ucscd":
        from .index import dictgen, store, ucsc
        from .io import fasta as fasta_io

        seqs = fasta_io.parse_fasta(args.ref_fasta)
        with open(args.ref_fasta + ".chrlens", "w") as f:
            f.write(fasta_io.chrlens_text(seqs))
        snp_dict, _ = ucsc.build_snp_dict_ucsc(seqs, args.snp_txt)
        ref_dict, _ = dictgen.build_ref_dict(seqs)
        store.write_snp_dict(args.snp_dict, snp_dict)
        store.write_ref_dict(args.ref_dict, ref_dict)
        return 0

    if args.cmd == "ucscbf":
        from .config import DEFAULT_CONFIG as cfg
        from .index import bloom, store, ucsc
        from .io import fasta as fasta_io

        seqs = fasta_io.parse_fasta(args.ref_fasta)
        ref_bf, lite = bloom.build_ref_bfs(seqs, cfg.ref_bf_bits,
                                           cfg.ref_lite_bf_bits)
        snp_bf = ucsc.build_snp_bf_ucsc(seqs, args.snp_txt,
                                        cfg.snp_bf_bits)
        store.write_sdsl_bf(args.ref_bf, ref_bf)
        store.write_sdsl_bf(args.ref_bf + ".lite.bf", lite)
        store.write_sdsl_bf(args.snp_bf, snp_bf)
        return 0

    if args.cmd == "encodebf":
        from .config import DEFAULT_CONFIG as cfg
        from .index import store, ucsc

        if args.ref_fasta:  # gbf encode: genome BF + encode snp BF
            from .index import bloom
            from .io import fasta as fasta_io

            if not args.ref_bf:
                print("encodebf: --ref-bf is required with --ref-fasta",
                      file=sys.stderr)
                return 1
            seqs = fasta_io.parse_fasta(args.ref_fasta)
            ref_bf, _ = bloom.build_ref_bfs(seqs, cfg.ref_bf_bits,
                                            cfg.ref_lite_bf_bits)
            store.write_sdsl_bf(args.ref_bf, ref_bf)
        bf = ucsc.build_snp_bf_encode(args.encode_file, cfg.snp_bf_bits)
        store.write_sdsl_bf(args.snp_bf, bf)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
