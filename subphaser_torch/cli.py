"""Command-line interface mirroring the reference's 40+ flags
(reference __main__.py:29-248), grouped Input/Output/Kmer/Cluster/LTR/Circos/Other.

The flags are the JAX package's, plus ``-device {cuda,cpu}`` (default cuda).
Steps this port does not do yet are refused by the Pipeline with
NotImplementedError: the run needs ``-disable_circos`` (circos and blocks
are not ported yet); ``-just_core`` stops after core phasing. The LTR step
runs whole, its trees included.
"""

from __future__ import annotations

import argparse
import sys

from subphaser_torch.utils.log import logger, setup_logging
from subphaser_torch.version import __version__


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="subphaser-torch",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="Phase and visualize subgenomes of an allopolyploid or "
        "hybrid based on repetitive kmers (PyTorch + CUDA).",
    )
    gin = parser.add_argument_group("Input", "Input genome and config files")
    gin.add_argument("-i", "-genomes", dest="genomes", nargs="+", metavar="GENOME",
                     required=True, help="Input genome sequences in fasta format [required]")
    gin.add_argument("-c", "-sg_cfgs", dest="sg_cfgs", nargs="+", required=True,
                     metavar="CFGFILE",
                     help="Subgenomes config file (one homologous group per line)")
    gin.add_argument("-labels", nargs="+", type=str, metavar="LABEL",
                     help="For multiple genomes, prefix labels per genome "
                     "[default: '1-, 2-, ..']")
    gin.add_argument("-no_label", action="store_true", default=False,
                     help="Do not use default prefix labels")
    gin.add_argument("-target", default=None, type=str, metavar="FILE",
                     help="Target chromosomes to output (id mapping allowed)")
    gin.add_argument("-sg_assigned", default=None, type=str, metavar="FILE",
                     help="Provide subgenome assignments to skip clustering")
    gin.add_argument("-sep", default="|", type=str, metavar="STR",
                     help='Separator for chromosome ID [default="%(default)s"]')
    gin.add_argument("-custom_features", nargs="+", metavar="FASTA", default=None,
                     help="Custom features in fasta to enrich subgenome-specific kmers")

    gout = parser.add_argument_group("Output")
    gout.add_argument("-pre", "-prefix", default=None, dest="prefix", metavar="STR",
                      help="Prefix for output [default=%(default)s]")
    gout.add_argument("-o", "-outdir", default="phase-results", dest="outdir",
                      metavar="DIR", help="Output directory [default=%(default)s]")
    gout.add_argument("-tmpdir", default="tmp", type=str, metavar="DIR",
                      help="Temporary directory [default=%(default)s]")
    gout.add_argument("-colors", default=None, metavar="HEX,HEX[,...]",
                      help="Subgenome colors in hex codes")

    gk = parser.add_argument_group("Kmer", "Options to count and filter kmers")
    gk.add_argument("-k", type=int, default=15, metavar="INT",
                    help="Length of kmer [default=%(default)s]")
    gk.add_argument("-f", "-min_fold", type=float, default=2, metavar="FLOAT",
                    dest="min_fold", help="Minimum fold [default=%(default)s]")
    gk.add_argument("-q", "-min_freq", type=int, default=200, metavar="INT",
                    dest="min_freq", help="Minimum total count for each kmer")
    gk.add_argument("-baseline", type=int, default=1,
                    help="Use sub-maximum (1) or minimum (-1) as the fold baseline")
    gk.add_argument("-ratio", type=float, default=1,
                    help="Min fraction of chromosome sets passing -min_fold")
    gk.add_argument("-lower_count", type=int, default=3, metavar="INT",
                    help="Don't count k-mers with per-chromosome count < this")
    gk.add_argument("-min_prop", type=float, default=None, metavar="FLOAT",
                    help="Minimum total proportion (< 1) for each kmer")
    gk.add_argument("-max_freq", type=int, default=int(1e9), metavar="INT",
                    help="Maximum total count for each kmer")
    gk.add_argument("-max_prop", type=float, default=None, metavar="FLOAT",
                    help="Maximum total proportion (< 1) for each kmer")
    gk.add_argument("-low_mem", action="store_true", default=None,
                    help="Low memory mode (reduced device/host buffers)")
    gk.add_argument("-by_count", action="store_true", default=False,
                    help="Calculate fold by count instead of by proportion")
    gk.add_argument("-re_filter", action="store_true", default=False,
                    help="Re-filter with a subset of chromosomes (always "
                    "effective here: per-chromosome counts are reused across "
                    "target-set changes and downstream steps recompute)")
    gk.add_argument("-tile_bases", type=int, default=1 << 23, metavar="INT",
                    help="Device tile size in bases [default=%(default)s]")

    gc = parser.add_argument_group("Cluster", "Options for clustering to phase")
    gc.add_argument("-nsg", type=int, default=None, metavar="INT",
                    help="Number of subgenomes (>1) [default: auto]")
    gc.add_argument("-replicates", type=int, default=1000, metavar="INT",
                    help="Number of replicates for bootstrap")
    gc.add_argument("-jackknife", type=float, default=50, metavar="FLOAT",
                    help="Percent of kmers to resample for each bootstrap")
    gc.add_argument("-max_pval", type=float, default=0.05, metavar="FLOAT",
                    help="Maximum P value for all hypothesis tests")
    gc.add_argument("-test_method", default="ttest_ind",
                    choices=["ttest_ind", "kruskal", "wilcoxon", "mannwhitneyu"],
                    help="Test to identify differential kmers")
    gc.add_argument("-figfmt", default="pdf", choices=["pdf", "png"],
                    help="Format of figures")
    gc.add_argument("-heatmap_colors", nargs="+", default=("green", "black", "red"),
                    metavar="COLOR", help="Color panel for heatmap plot")
    gc.add_argument("-heatmap_options", metavar="STR", default=None,
                    help="(compat) heatmap options; matplotlib backend ignores R args")
    gc.add_argument("-just_core", action="store_true", default=False,
                    help="Exit after the core phasing module")
    gc.add_argument("-seed", type=int, default=0,
                    help="Random seed for clustering/bootstrap [default=%(default)s]")

    gl = parser.add_argument_group("LTR", "Options for LTR analyses")
    gl.add_argument("-disable_ltr", action="store_true", default=False,
                    help="Disable the LTR step")
    gl.add_argument("-ltr_detectors", nargs="+", default=["ltr_harvest"],
                    choices=["ltr_finder", "ltr_harvest"],
                    help="Programs to detect LTR-RTs")
    gl.add_argument("-ltr_finder_options", metavar="STR",
                    default="-w 2 -D 15000 -d 1000 -L 7000 -l 100 -p 20 -C -M 0.8")
    gl.add_argument("-ltr_harvest_options", metavar="STR",
                    default="-seqids yes -similar 80 -vic 10 -seed 20 -minlenltr 100 "
                    "-maxlenltr 7000 -mintsd 4 -maxtsd 6")
    gl.add_argument("-tesorter_options", metavar="STR", default="-db rexdb -dp2",
                    help="TEsorter options: -eval (E-value gate), -rule id-cov-len "
                    "(pass-2 gates) and -nodp2/-dp2 are honoured; the database is -hmm_db")
    gl.add_argument("-hmm_db", metavar="FILE", default=None,
                    help="HMMER3 profile database (REXdb-style names) for native "
                    "TE classification; without it, -all_ltr behavior applies")
    gl.add_argument("-all_ltr", action="store_true", default=False,
                    help="Use all detected LTR-RTs (not only TEsorter-classified LTR)")
    gl.add_argument("-intact_ltr", action="store_true", default=False,
                    help="Use only complete LTR-RTs")
    gl.add_argument("-exclude_exchanges", action="store_true", default=False,
                    help="Exclude potential exchanged LTRs from age/tree analyses")
    gl.add_argument("-non_specific", action="store_true", default=False,
                    help="Plot non-specific LTRs")
    gl.add_argument("-mu", metavar="FLOAT", type=float, default=13e-9,
                    help="Substitution rate per year for LTR insertion age")
    gl.add_argument("-disable_ltrtree", action="store_true", default=False,
                    help="Disable subgenome-specific LTR tree")
    gl.add_argument("-subsample", type=int, default=1000, metavar="INT",
                    help="Subsample LTR-RTs for the tree (0 to disable)")
    gl.add_argument("-ltr_domains", nargs="+", default=["INT", "RT", "RH"],
                    choices=["GAG", "PROT", "INT", "RT", "RH", "AP", "RNaseH"],
                    help="Domains for the LTR tree")
    gl.add_argument("-trimal_options", metavar="STR", default="-automated1",
                    help="(compat) ignored by the native tree backend")
    gl.add_argument("-tree_method", default="FastTree", choices=["iqtree", "FastTree"],
                    help="(compat) tree construction method; the native "
                    "backend builds NJ trees from domain/element sketches")
    gl.add_argument("-tree_options", metavar="STR", default="",
                    help="(compat) ignored by the native tree backend")
    gl.add_argument("-ggtree_options", metavar="STR",
                    default="branch.length='none', layout='circular'",
                    help="(compat) ignored; figures are matplotlib")

    gcir = parser.add_argument_group("Circos", "Options for circos plot")
    gcir.add_argument("-disable_circos", action="store_true", default=False,
                      help="Disable the circos step")
    gcir.add_argument("-window_size", type=int, default=1000000, metavar="INT",
                      help="Window size (bp) for circos plot")
    gcir.add_argument("-disable_blocks", action="store_true", default=False,
                      help="Disable homologous block links")
    gcir.add_argument("-aligner", metavar="PROG", default="native",
                      choices=["minimap2", "unimap", "native"],
                      help="Program to identify homologous blocks "
                      "[default=%(default)s; external aligners are not "
                      "bundled and error loudly]")
    gcir.add_argument("-aligner_options", metavar="STR", default="-x asm20 -n 10",
                      help="(compat) ignored by the native aligner")
    gcir.add_argument("-min_block", type=int, default=100000, metavar="INT",
                      help="Minimum block size (bp) to show")
    gcir.add_argument("-alt_cfgs", nargs="+", metavar="CFGFILE", default=None,
                      help="Alternative config for homologous blocks")
    gcir.add_argument("-chr_ordered", default=None, type=str, metavar="FILE",
                      help="Chromosome order for the circos plot")

    go = parser.add_argument_group("Other options")
    go.add_argument("-p", "-ncpu", type=int, default=None, metavar="INT", dest="ncpu",
                    help="Maximum host worker threads [default: all]")
    go.add_argument("-max_memory", type=str, default=None, metavar="MEM",
                    help="Maximum host memory to use")
    go.add_argument("-cleanup", action="store_true", default=False,
                    help="Remove the temporary directory at the end")
    go.add_argument("-overwrite", action="store_true", default=False,
                    help="Overwrite even if checkpoint files exist")
    go.add_argument("-trace", metavar="DIR", default=None,
                    help="Write a device trace to DIR (not ported yet)")
    go.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                    help="Device to run on [default=%(default)s]")
    go.add_argument("-v", "-version", action="version", version=__version__)
    return parser


def main(argv=None):
    setup_logging()
    args = make_parser().parse_args(argv)
    if args.prefix is not None:
        args.prefix = args.prefix.replace("/", "_")
        args.outdir = args.prefix + args.outdir
        args.tmpdir = args.prefix + args.tmpdir
    args.ltr_detectors = sorted(set(args.ltr_detectors))
    logger.info("Command: %s", " ".join(sys.argv))
    logger.info("Version: %s", __version__)
    logger.info("Arguments: %s", args.__dict__)

    from subphaser_torch.phase.pipeline import Pipeline

    kargs = dict(args.__dict__)
    genomes = kargs.pop("genomes")
    sg_cfgs = kargs.pop("sg_cfgs")
    labels = kargs.pop("labels")
    pipeline = Pipeline(genomes, sg_cfgs, labels=labels, **kargs)
    return pipeline.run()


if __name__ == "__main__":
    main()
