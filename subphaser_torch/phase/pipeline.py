"""The phasing pipeline: pack -> count -> filter -> cluster -> map -> enrich ->
custom features -> LTR -> blocks and circos, with checkpoint/resume.

Mirrors the reference Pipeline (reference __main__.py:250-729) step for step:
core phasing (k 1..31), custom features, the LTR step (detection,
classification, SG enrichment, insertion ages, trees), homoeologous blocks
and the circos figure; ``-trace DIR`` records the run with torch.profiler.
The checkpoint files are the JAX package's, so a run resumes from a tmpdir
either package wrote.

Several devices: ``n_devices`` > 1 counts and maps over a mesh of devices in
this process (parallel/mesh); in a ``torch.distributed`` group of several
processes (parallel/distributed) the ranks share out counting, mapping, LTR
detection, classification and the block pairs by chromosome or item and
exchange the results, so every rank writes the same files. The core figures
(histogram, heatmap, PCA) and the circos figure are drawn where matplotlib
imports; elsewhere their step logs that they are not drawn.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from collections import Counter
from itertools import groupby

import numpy as np
import torch

from subphaser_torch import config as cfgmod
from subphaser_torch import kernels
from subphaser_torch.device import resolve_device
from subphaser_torch.io.fasta import xopen
from subphaser_torch.io.genome import DEFAULT_TILE_BASES, PackedGenome
from subphaser_torch.ops.filter import make_group_spec
from subphaser_torch.ops.mapbins import BinAccumulator, HitSet, nbins_for_tile
from subphaser_torch.parallel.distributed import exchange_arrays, owns_chrom, rank_world
from subphaser_torch.parallel.mesh import Mesh
from subphaser_torch.phase import enrich as enrichmod
from subphaser_torch.phase.budgets import pad_sig_pow2, parse_mem, plan_budgets
from subphaser_torch.phase.cluster import PhaseCluster, SigKmers, write_matrix_file
from subphaser_torch.phase.features import FeaturePack
from subphaser_torch.phase.filtering import streaming_filter
from subphaser_torch.phase.spectrum import count_genome
from subphaser_torch.utils.checkpoint import Checkpoint
from subphaser_torch.utils.log import logger, setup_logging
from subphaser_torch.utils.profiling import Spans, trace
from subphaser_torch.viz.colors import SGColors

BIN_SIZE = 10000  # fine bin for k-mer mapping (reference __main__.py:485)


class Pipeline:
    def __init__(self, genomes, sg_cfgs, labels=None, device=None, **kargs):
        setup_logging()
        self.device = resolve_device(device)
        self.genomes = genomes
        self.sg_cfgs = sg_cfgs
        defaults = dict(
            no_label=False, sep="|", target=None, sg_assigned=None,
            custom_features=None, prefix=None, outdir="phase-results",
            tmpdir="tmp", k=15, min_fold=2.0, min_freq=200,
            baseline=1, ratio=1.0, lower_count=3, min_prop=None,
            max_freq=int(1e9), max_prop=None, by_count=False,
            nsg=None, replicates=1000, jackknife=50, max_pval=0.05,
            test_method="ttest_ind", figfmt="pdf", just_core=False,
            disable_ltr=False, ltr_detectors=["ltr_harvest"], all_ltr=False,
            hmm_db=None, intact_ltr=False, exclude_exchanges=False,
            non_specific=False, mu=13e-9, disable_ltrtree=False, subsample=1000,
            ltr_domains=["INT", "RT", "RH"],
            colors=None, ltr_harvest_options=None, ltr_finder_options=None,
            tesorter_options=None,
            disable_circos=False, window_size=1000000,
            cleanup=False, overwrite=False, tile_bases=DEFAULT_TILE_BASES,
            seed=0, low_mem=None, ncpu=None, max_memory=None, trace=None,
            n_devices=None, heatmap_colors=("green", "black", "red"),
            heatmap_options=None, tree_method="FastTree", trimal_options=None,
            tree_options=None, ggtree_options=None, disable_blocks=False,
            min_block=100000, alt_cfgs=None, chr_ordered=None,
            aligner="native", aligner_options="-x asm20 -n 10",
        )
        defaults.update(kargs)
        self.__dict__.update(defaults)
        if self.aligner in ("minimap2", "unimap"):
            # reference shells out to minimap2/unimap (__main__.py:699-713);
            # this framework ships its own anchor-chain aligner and bundles
            # no external binaries — fail loudly instead of silently
            # substituting (flag default is "native")
            raise ValueError(
                f"-aligner {self.aligner}: external aligners are not bundled "
                "in subphaser_torch; use -aligner native (anchor-chain aligner "
                "with PAF output)"
            )
        self._check_scope()

        _check_duplicates(genomes)
        if labels is not None:
            _check_duplicates(labels)

        # genome-file prefix labels (reference __main__.py:262-268)
        if labels is None:
            if len(genomes) == 1 or self.no_label:
                self.labels = [""] * len(genomes)
            else:
                self.labels = [f"{i + 1}-" for i in range(len(genomes))]
        else:
            self.labels = labels
        if self.no_label:
            self.labels = [""] * len(genomes)

        self.sgs, self.chrs, _nsg = cfgmod.parse_configs(
            self.sg_cfgs, self.labels, sep=self.sep
        )
        if self.alt_cfgs:
            self.alt_sgs, _, _ = cfgmod.parse_configs(self.alt_cfgs, None, sep=self.sep)
        else:
            self.alt_sgs = self.sgs
        if not self.nsg or self.nsg < 2:
            self.nsg = _nsg
        self.sg_color = SGColors(self.colors)
        # the core figures' options are parsed all the same (A6b reads them)
        self._parse_plot_options()
        self._parse_aligner_options()
        self._parse_tool_options()
        # every step's and span's seconds by path, stream seconds by
        # ``path@device`` and the spans' counters by ``path@<name>``
        # (utils/profiling)
        self.spans = Spans()
        self.step_seconds: dict[str, float] = self.spans.seconds
        self.map_dense = None
        self.ltr_pipeline = None
        self.mesh = None

    def _check_scope(self):
        """Refuse, up front, a k the codes cannot hold."""
        if not 1 <= self.k <= 31:
            raise ValueError(
                f"k={self.k} unsupported: codes are int32 for k <= 15 and "
                "int64 pair codes hi << 31 | lo for 16 <= k <= 31"
            )

    def _parse_plot_options(self):
        """Native analogues for -heatmap_options / -ggtree_options.

        The reference forwards these verbatim to R heatmap.2 and ggtree
        (reference __main__.py:123-127, 200-204; Jellyfish.py:525-603);
        the matplotlib backends honor the sub-flags with direct analogues
        (heatmap.2: scale=, main=, xlab=, labCol=, key=; ggtree:
        branch.length=, layout=) and warn-ignore the rest.
        """
        import re

        pair = r"([A-Za-z._]+)\s*=\s*(\"[^\"]*\"|'[^']*'|[^,]+)"
        self.heatmap_kw: dict = {}
        known = {"scale", "main", "xlab", "labCol", "key"}
        for m in re.finditer(pair, self.heatmap_options or ""):
            kname, val = m.group(1), m.group(2).strip().strip("\"'")
            if kname == "scale":
                if val in ("row", "column", "none"):
                    self.heatmap_kw["scale"] = val
                else:
                    logger.warning("-heatmap_options scale=%r: unknown "
                                   "(row/column/none); ignored", val)
            elif kname == "main":
                self.heatmap_kw["title"] = val
            elif kname == "xlab":
                if val:
                    self.heatmap_kw["xlab"] = val
            elif kname == "labCol":
                self.heatmap_kw["lab_col"] = val.upper() in ("T", "TRUE")
            elif kname == "key":
                self.heatmap_kw["key"] = val.upper() in ("T", "TRUE")
            else:
                logger.warning(
                    "-heatmap_options %s=%r has no native analogue in "
                    "the matplotlib heatmap (honored: %s); ignored",
                    kname, val, ", ".join(sorted(known)))

        self.tree_branch_lengths = False
        for m in re.finditer(pair, self.ggtree_options or ""):
            kname, val = m.group(1), m.group(2).strip().strip("\"'")
            if kname == "branch.length":
                self.tree_branch_lengths = val != "none"
            elif kname == "layout":
                if val != "circular":
                    logger.warning(
                        "-ggtree_options layout=%r: the native tree "
                        "plot is circular-only; ignored", val)
            else:
                logger.warning(
                    "-ggtree_options %s=%r has no native analogue "
                    "(honored: branch.length, layout); ignored",
                    kname, val)

    def _parse_aligner_options(self):
        """-aligner_options sub-flags with native analogues: minimap2
        ``-n`` (min anchors per chain -> min_chain_anchors) and ``-g``
        (max chain gap -> max_gap); ``-x`` presets and the rest are
        warn-ignored (reference passes the string verbatim to minimap2,
        Blocks.py:42-43)."""
        self.block_min_anchors = 10
        self.block_max_gap = 100_000
        t = (self.aligner_options or "").split()
        i = 0
        while i < len(t):
            tok = t[i]
            if tok == "-n" and i + 1 < len(t):
                self.block_min_anchors = max(int(t[i + 1]), 1)
                i += 2
            elif tok == "-g" and i + 1 < len(t):
                self.block_max_gap = int(t[i + 1])
                i += 2
            elif tok == "-x" and i + 1 < len(t):
                if t[i + 1] != "asm20":
                    logger.warning(
                        "-aligner_options -x %s: the native aligner has no "
                        "presets; ignored", t[i + 1])
                i += 2
            else:
                logger.warning(
                    "-aligner_options %r has no native analogue "
                    "(honored: -n, -g); ignored", tok)
                i += 1

    def _parse_tool_options(self):
        """The sub-flags of -tesorter_options / -trimal_options /
        -tree_options with native analogues, as the JAX Pipeline parses
        them: TEsorter -eval/--max-evalue -> the E-value gate (reference
        api/TEsorter/app.py:93-95), -rule/--pass2-rule id-cov-len -> the
        pass-2 gates (app.py:118-120), -nodp2 disables pass-2; trimal -gt X
        -> the column trim threshold; FastTree/iqtree -b/-B N -> the
        bootstrap replicate count. The rest is warn-ignored."""
        self.max_evalue = 1e-3
        self.pass2_rule = (80.0, 80.0, 80)
        self.pass2_enabled = True
        self.trim_gt = None
        self.tree_boot = 1000 if self.tree_method == "iqtree" else 100
        known_defaults = {"-db", "rexdb", "-dp2"}
        t = (self.tesorter_options or "").split()
        i = 0
        while i < len(t):
            tok = t[i]
            if tok in ("-eval", "--max-evalue") and i + 1 < len(t):
                self.max_evalue = float(t[i + 1])
                i += 2
            elif tok in ("-rule", "--pass2-rule") and i + 1 < len(t):
                parts = t[i + 1].split("-")
                self.pass2_rule = (float(parts[0]), float(parts[1]),
                                   int(parts[2]))
                i += 2
            elif tok in ("-nodp2", "--no-pass2"):
                self.pass2_enabled = False
                i += 1
            elif tok == "-dp2":
                self.pass2_enabled = True
                i += 1
            elif tok == "-db" and i + 1 < len(t):
                if t[i + 1] != "rexdb":
                    logger.warning(
                        "-tesorter_options -db %s: only the -hmm_db path "
                        "selects the database here; ignored", t[i + 1])
                i += 2
            else:
                if tok not in known_defaults:
                    logger.warning(
                        "-tesorter_options %r has no native analogue; "
                        "ignored", tok)
                i += 1

        t = (self.trimal_options or "").split()
        i = 0
        while i < len(t):
            if t[i] == "-gt" and i + 1 < len(t):
                self.trim_gt = float(t[i + 1])
                i += 2
            elif t[i] == "-automated1":
                i += 1  # the default trim heuristic plays this role
            else:
                logger.warning(
                    "-trimal_options %r has no native analogue; ignored",
                    t[i])
                i += 1

        t = (self.tree_options or "").split()
        i = 0
        while i < len(t):
            if t[i] in ("-b", "-B", "--boot") and i + 1 < len(t):
                self.tree_boot = int(t[i + 1])
                i += 2
            else:
                logger.warning(
                    "-tree_options %r has no native analogue; ignored", t[i])
                i += 1

    # ------------------------------------------------------------------
    def run(self):
        with trace(self.trace), self.spans.job(self.device):
            return self._run()

    @staticmethod
    def _can_plot(what: str) -> bool:
        """Whether matplotlib imports; logs that ``what`` not drawn where
        it does not (a GPU host may have no matplotlib)."""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            logger.info("matplotlib is not installed: %s not drawn", what)
            return False
        return True

    def _plot_core_figures(self, res, cluster: PhaseCluster, sig: SigKmers):
        """The heatmap and the PCA figure (JAX pipeline.py:1015-1035). The
        PCA runs on the cluster's device outside the guard: a device fault
        raises; only a drawing failure is logged."""
        from subphaser_torch.viz.plots import plot_heatmap, plot_pca

        d_colors = self.sg_color.for_names(self.sg_names)
        # per-kmer SG for heatmap column colors
        kmer_sg = np.full(res.matrix.codes.size, -1, dtype=np.int64)
        idx = np.searchsorted(res.matrix.codes, sig.canon_codes)
        kmer_sg[idx] = sig.canon_sg
        scores, ratio = cluster.pca(n_components=max(2, self.nsg))
        heatfig = self.para_prefix + ".kmer.mat." + self.figfmt
        pcafig = self.para_prefix + ".kmer_pca." + self.figfmt
        try:
            plot_heatmap(
                res.matrix.freqs, self.chrom_labels, self.d_sg, kmer_sg,
                self.sg_names, d_colors, heatfig,
                **self.heatmap_kw,
            )
            plot_pca(scores, ratio, self.chrom_labels, self.d_sg, d_colors, pcafig)
            logger.info("Wrote figures %s, %s", heatfig, pcafig)
        except Exception as e:  # plotting must never kill the pipeline
            logger.warning("Core figures failed: %s", e)

    def _run(self):
        spans = self.spans
        with spans.span("pack"):
            self.outdir = os.path.realpath(self.outdir)
            self.tmpdir = os.path.realpath(self.tmpdir)
            os.makedirs(self.outdir, exist_ok=True)
            os.makedirs(self.tmpdir, exist_ok=True)
            out_prefix = self.prefix or ""
            self.ckp = Checkpoint(self.tmpdir)
            if self.overwrite:
                for f in os.listdir(self.tmpdir):
                    if f.endswith((".ok.json", ".ok.npz")):
                        os.remove(os.path.join(self.tmpdir, f))

            logger.info("Device: %s", self.device)
            logger.info("Target chromosomes: %s", self.chrs)
            genome, labels = self._load_genome()
            self.genome = genome
            self.chrom_labels = labels
            self.sgs = cfgmod.update_sgs(self.sgs, self.targets, self.sep)
            self.alt_sgs = cfgmod.update_sgs(self.alt_sgs, self.targets, self.sep)
            self.d_assigned = cfgmod.parse_assigned(self.sg_assigned, self.targets)
            self.chr_order = cfgmod.parse_ordered(self.chr_ordered, self.targets)
            logger.info("Chromosomes: %s", labels)
            logger.info("Chromosome Number: %d", len(labels))
            logger.info("CONFIG: %s", self.sgs)
            genome_size = genome.total_bases()
            logger.info("Genome size: %s bp", f"{genome_size:,}")
            # reference auto-low-memory above 3 Gb (__main__.py:395-398);
            # -max_memory caps the device merge budget
            max_mem_bytes = _parse_mem(self.max_memory)
            if max_mem_bytes and self.low_mem is None and genome_size * 3 > max_mem_bytes:
                logger.info(
                    "-max_memory %s < ~3x genome size; enabling low-memory mode",
                    self.max_memory,
                )
            self.tile_bases, device_budget, low_mem_eff, batch_tiles = plan_budgets(
                genome_size, self.tile_bases, self.low_mem, self.max_memory
            )
            if low_mem_eff:
                self.low_mem = True
                logger.info("Low-memory mode: tile=%d, device_budget=%d",
                            self.tile_bases, device_budget)
            if max_mem_bytes and device_budget < (1 << 27 if low_mem_eff else 1 << 28):
                logger.info("-max_memory %s: device_budget=%d entries",
                            self.max_memory, device_budget)
            self.mesh = self._make_mesh()

        with spans.span("count"):
            logger.info("###Step: Kmer Count")
            spectra = count_genome(
                genome, self.k, lower_count=self.lower_count,
                tile_bases=self.tile_bases, device_budget=device_budget,
                batch_tiles=batch_tiles, checkpoint=self.ckp, device=self.device,
                mesh=self.mesh,
            )

        with spans.span("filter"):
            # differential filter
            self.basename = f"k{self.k}_q{self.min_freq}_f{_num(self.min_fold)}"
            self.para_prefix = os.path.join(self.outdir, out_prefix + self.basename)
            tot_lens = float(sum(s.total for s in spectra))
            min_freq = self.min_prop * tot_lens if self.min_prop is not None else self.min_freq
            max_freq = self.max_prop * tot_lens if self.max_prop is not None else self.max_freq
            if self.min_prop is not None:
                logger.info("Adjust `min_freq` to %s according to `min_prop`", min_freq)
            if max_freq < min_freq:
                raise ValueError(
                    f"`min_freq` ({min_freq}) should be lower than `max_freq` ({max_freq})")
            gi = cfgmod.group_indices(self.sgs, labels)
            spec = make_group_spec(gi, len(labels))
            logger.info("Filtering differential kmers")
            with spans.span("select"):
                res = streaming_filter(
                    spectra, spec,
                    min_freq=min_freq, max_freq=max_freq, min_fold=self.min_fold,
                    ratio=self.ratio, baseline=self.baseline, by_count=self.by_count,
                )
            if res.n_differential == 0:
                raise ValueError(
                    "0 kmer remained after filtering. Please reset the filter options.")
            matfile = self.para_prefix + ".kmer.mat"
            with spans.span("write"), xopen(matfile, "wt") as f:
                write_matrix_file(res.matrix, self.k, f)
            logger.info("Wrote %s", matfile)
            plot_core = self._can_plot("the core figures (histogram, heatmap, PCA) are")
            if plot_core:
                from subphaser_torch.viz.plots import plot_histogram

                try:
                    plot_histogram(res.fold_tots, self.para_prefix + ".kmer_freq." + self.figfmt)
                except Exception as e:  # plotting must never kill the pipeline
                    logger.warning("Histogram plot failed: %s", e)

        with spans.span("cluster"):
            logger.info("###Step: Cluster")
            with spans.span("kmeans", device=True):
                cluster = PhaseCluster(
                    res.matrix, n_clusters=self.nsg, sg_assigned=self.d_assigned,
                    replicates=self.replicates, jackknife=self.jackknife, seed=self.seed,
                    device=self.device,
                )
            self.cluster = cluster
            self.d_sg = cluster.d_sg
            self.sg_names = cluster.sg_names
            logger.info("Subgenome assignments: %s", dict(cluster.d_sg))
            sg_chrs = self.para_prefix + ".chrom-subgenome.tsv"
            with spans.span("write"), open(sg_chrs, "w") as f:
                cluster.output_subgenomes(f)
            logger.info("Wrote %s", sg_chrs)

            sg_kmers = self.para_prefix + ".sig.kmer-subgenome.tsv"
            with open(sg_kmers, "w") as f:
                sig = cluster.output_kmers(
                    f, self.k, max_pval=self.max_pval, test_method=self.test_method
                )
            logger.info("Wrote %s", sg_kmers)
            if plot_core:
                self._plot_core_figures(res, cluster, sig)

        if self.just_core:
            self._final()
            logger.info("Pipeline completed early")
            return self

        with spans.span("map"):
            # map significant k-mers onto genome bins
            sg_map = self.para_prefix + ".subgenome.bin.count"
            acc = self._map_genome_bins(sig)
            sizes = [c.length for c in genome.chroms]
            with spans.span("write"), open(sg_map, "w") as f:
                enrichmod.write_bin_counts(f, acc.per_chrom, labels, sizes, BIN_SIZE,
                                           self.sg_names)
            logger.info("Wrote %s", sg_map)

        with spans.span("enrich"):
            # window enrichment
            logger.info("Enriching subgenome by chromosome window (size: %d)",
                        self.window_size)
            rownames, counts = enrichmod.stack_windows(
                acc.per_chrom, labels, BIN_SIZE, self.window_size
            )
            bin_enrich = self.para_prefix + ".bin.enrich"
            bin_group = self.para_prefix + ".bin.group"
            with open(bin_enrich, "w") as f, open(bin_group, "w") as f2:
                self.sg_lines = enrichmod.enrich_bin(
                    f, f2, self.d_sg, counts, self.sg_names, rownames, max_pval=self.max_pval
                )
            logger.info("Output: %s", bin_enrich)

        # custom features
        if self.custom_features:
            self._step_custom(sig)

        # LTR
        ltr_bedlines, enrich_ltr_bedlines = [], []
        if not self.disable_ltr:
            ltr_bedlines, enrich_ltr_bedlines = self._step_ltr(sig)

        # homoeologous blocks and circos
        if not self.disable_circos:
            self._step_circos(acc, ltr_bedlines, enrich_ltr_bedlines)

        self._final()
        logger.info("Pipeline completed")
        return self

    def _make_mesh(self) -> Mesh | None:
        """The data-parallel mesh of counting and mapping (the reference's
        process axis, RunCmdsMP.py:38-217): on CUDA, min(n_devices or every
        card, the cards there are) distinct cards from the Pipeline's own,
        so one card is no mesh; on the CPU, ``n_devices`` shards of the one
        CPU device (default 1), the counterpart of XLA's forced host device
        count. A run of several processes shares out by chromosome instead
        and has no mesh."""
        rank_n = rank_world()[1]
        if self.device.type == "cuda":
            n_cards = torch.cuda.device_count()
            devs = [torch.device("cuda", (self.device.index + i) % n_cards)
                    for i in range(n_cards)]
        else:
            devs = [self.device] * (self.n_devices or 1)
        want = self.n_devices or len(devs)
        if rank_n > 1:
            want = 1
            logger.info("Multi-process run (%d processes): chromosome-sharded "
                        "counting, replicated downstream steps", rank_n)
        if want > 1 and len(devs) > 1:
            devs = devs[:min(want, len(devs))]
            logger.info("Using %d devices (data-parallel mesh) for counting/mapping",
                        len(devs))
            return Mesh(np.array(devs, dtype=object), ("data",))
        return None

    # ------------------------------------------------------------------
    def _load_genome(self) -> tuple[PackedGenome, list[str]]:
        self.targets = cfgmod.parse_idmap(self.target) or cfgmod.build_targets(
            self.chrs, self.sep
        )
        params = {
            "files": [(g, os.path.getsize(g), os.path.getmtime(g)) for g in self.genomes],
            "targets": list(self.targets.items()),
            "prefixes": self.labels,
        }
        cache = os.path.join(self.tmpdir, "genome.packed.npz")
        if self.ckp.has("genome.packed", params) and os.path.exists(cache):
            genome = PackedGenome.load(cache)
            logger.info("Loaded packed genome checkpoint (%d chromosomes)", len(genome))
        else:
            with self.spans.span("read"):
                genome, got = PackedGenome.from_fasta_files(
                    self.genomes, self.labels, self.targets, workers=self.ncpu
                )
            missing = set(self.targets) - set(got)
            if missing:
                logger.error("Chromosomes %s are not found in sequences files", missing)
            with self.spans.span("save"):
                genome.save(cache)
                self.ckp.save("genome.packed", params)
        # order chromosomes by config/targets order (reference sort_labels)
        order = {name: i for i, name in enumerate(self.targets.values())}
        genome.chroms.sort(key=lambda c: order.get(c.name, 1 << 30))
        if len(genome) == 0:
            raise ValueError("0 chromosome remained after filtering. Please check the inputs.")
        return genome, genome.names

    def _map_use_dense(self) -> bool:
        # the dense 4^k int8 table (1 GiB at k=15) pays off only when the
        # genome is large enough to amortize building it; the sg+1 int8
        # value caps n_sg at 126
        if len(self.sg_names) > 126:
            return False
        return self.genome.total_bases() >= 50_000_000

    def _map_batch(self) -> int:
        return 4 if self.genome.total_bases() > 1e9 else 1

    def _map_genome_bins(self, sig: SigKmers) -> BinAccumulator:
        logger.info("Mapping %d subgenome-specific kmers to genome bins", len(sig) // 2)
        n_sg = len(self.sg_names)
        dev = self.device
        if self.k > 15:
            # pair codes: searchsorted into the int64 table, no dense table
            # and (as in the JAX package) no per-chromosome checkpoints
            from subphaser_torch.ops.mapbins_pair import map_genome_bins_pair, max_hi_run

            logger.info("Pair-code table: longest run of equal hi words %d",
                        max_hi_run(sig.codes))
            self.map_dense = False
            acc = map_genome_bins_pair(
                self.genome, sig.codes, sig.sg, self.k,
                self.tile_bases, BIN_SIZE, n_sg, device=dev,
            )
            self._log_mapped(acc, sig)
            return acc
        sizes = [c.length for c in self.genome.chroms]
        acc = BinAccumulator(sizes, BIN_SIZE, n_sg, device=dev)
        nbt = nbins_for_tile(self.tile_bases, BIN_SIZE)
        codes_np, sgs_np = pad_sig_pow2(sig.codes, sig.sg)
        n_pos_words = self.tile_bases // 16
        use_dense = self._map_use_dense()
        self.map_dense = use_dense
        if use_dense:
            from subphaser_torch.ops.mapbins_dense import (
                build_sig_table,
                map_tiles_batch_dense,
            )
        else:
            from subphaser_torch.ops.mapbins import map_tiles_batch
        # tile starts are multiples of the tile size, so when the bin size
        # is 16-divisible every word-column lands in one bin
        aligned16 = BIN_SIZE % 16 == 0 and self.tile_bases % 16 == 0
        batch = self._map_batch()
        kw = dict(k=self.k, n_pos_words=n_pos_words, bin_size=BIN_SIZE,
                  n_sg=n_sg, nbins_tile=nbt, aligned16=aligned16)
        # a mesh splits each batch of tiles over its devices, the
        # significant k-mers (or their dense table) on every device: the
        # JAX package's data-sharded batch with a replicated table, which
        # GSPMD partitions with no collective
        map_devs = self.mesh.axis_devices("data") if self.mesh is not None else [dev]
        if len(map_devs) > 1:
            batch = max(batch, len(map_devs))
            batch -= batch % len(map_devs)
        per_dev = batch // len(map_devs)
        tables: dict = {}
        with self.spans.span("table", device=True):
            for d in map_devs:
                if d not in tables:
                    codes = torch.from_numpy(codes_np).to(d)
                    sgs = torch.from_numpy(sgs_np).to(d)
                    tables[d] = (build_sig_table(codes, sgs, self.k) if use_dense else codes,
                                 sgs)

        def map_chunk(d, words, vwords, starts):
            table, sgs = tables[d]
            w_dev = torch.from_numpy(words).to(d)
            v_dev = torch.from_numpy(vwords).to(d)
            if not use_dense:
                return map_tiles_batch(w_dev, v_dev, table, sgs, starts, **kw)
            if batch > 1:
                return map_tiles_batch_dense(w_dev, v_dev, table, sgs, starts, **kw)
            return map_tiles_batch_dense(w_dev[0], v_dev[0], table, sgs, starts[0], **kw)

        # per-chromosome mapping checkpoints (reference checkpoints sg_map
        # after mapping, __main__.py:478-487). Params carry a digest of the
        # significant-kmer set; fmt 8 = the dense path's hit CODES, 1 = the
        # searchsorted path's sig indices.
        sig_digest = hashlib.sha256(
            np.asarray(sig.codes).tobytes() + np.asarray(sig.sg).tobytes()
        ).hexdigest()[:16]
        map_params = {"k": self.k, "bin": BIN_SIZE, "nsg": n_sg,
                      "tile": self.tile_bases, "sig": sig_digest,
                      "fmt": 8 if use_dense else 1}
        labels = self.chrom_labels
        # several processes: each rank maps the chromosomes it owns and the
        # per-chromosome (bins, hits) payloads are exchanged afterwards
        # (the reference farms sg_map chunks over its grid, RunCmdsMP.py:38-152)
        rank, nproc = rank_world()
        owned = None
        if nproc > 1:
            owned = {ci for ci in range(len(labels)) if owns_chrom(ci)}
            logger.info("Sharded mapping: rank %d owns %d/%d chromosomes",
                        rank, len(owned), len(labels))
        chrom_snaps: dict[int, np.ndarray] = {}
        done: set[int] = set()
        n_resumed = 0
        for ci, label in enumerate(labels):
            if owned is not None and ci not in owned:
                done.add(ci)  # arrives by the exchange after the loop
                continue
            name = f"map_bins_{label}"
            if self.ckp.has(name, map_params):
                payload = self.ckp.load(name)
                bins = payload.get("bins")
                if bins is None or bins.shape != acc.per_chrom[ci].shape:
                    continue
                acc.per_chrom[ci] = bins.astype(np.int64)
                acc.mapped_positions += int(bins.sum())
                hits = payload.get("hits")
                if hits is not None and hits.size:
                    acc.add(ci, np.zeros((0, n_sg), np.int64), 0, hits)
                chrom_snaps[ci] = hits if hits is not None else np.zeros(0, np.int32)
                done.add(ci)
                n_resumed += 1
        if n_resumed:
            logger.info("Resumed mapping from checkpoint for %d/%d chromosomes",
                        n_resumed, len(owned) if owned is not None else len(labels))

        tiles = (t for t in self.genome.tiles(self.k, tile_bases=self.tile_bases)
                 if t.chrom_index not in done)
        for ci, ctiles in groupby(tiles, key=lambda t: t.chrom_index):
            ctiles = list(ctiles)
            hs = HitSet(device=dev)
            for lo in range(0, len(ctiles), batch):
                bt = ctiles[lo : lo + batch]
                words = np.stack([t.words for t in bt])
                vwords = np.stack([t.vwords for t in bt])
                starts = [t.start for t in bt]
                if len(bt) < batch:
                    pad = batch - len(bt)
                    words = np.concatenate([words, np.zeros((pad,) + words.shape[1:], words.dtype)])
                    vwords = np.concatenate([vwords, np.zeros((pad,) + vwords.shape[1:], vwords.dtype)])
                    starts += [0] * pad
                bcs_parts = []
                for i, d in enumerate(map_devs):
                    part = slice(i * per_dev, (i + 1) * per_dev)
                    bcs, hits = map_chunk(d, words[part], vwords[part], starts[part])
                    bcs_parts.append(bcs.cpu().numpy())
                    hs.add(hits)
                bcs_np = np.concatenate(bcs_parts)
                for i, t in enumerate(bt):
                    acc.add(t.chrom_index, bcs_np[i], t.start // BIN_SIZE, None)
            snap = hs.snapshot()
            acc.add(ci, np.zeros((0, n_sg), np.int64), 0, snap)
            chrom_snaps[ci] = snap
            self.ckp.save(f"map_bins_{labels[ci]}", map_params,
                          bins=acc.per_chrom[ci], hits=snap)
        if owned is not None:
            # one payload exchange completes every rank's accumulator with
            # the chromosomes the other ranks mapped
            merged = exchange_arrays(
                {ci: {"bins": acc.per_chrom[ci],
                      "hits": chrom_snaps.get(ci, np.zeros(0, np.int32))}
                 for ci in sorted(owned)}, len(labels), "map_bins")
            for ci, d in merged.items():
                if ci in owned:
                    continue
                acc.per_chrom[ci] = d["bins"].astype(np.int64)
                acc.mapped_positions += int(d["bins"].sum())
                if d["hits"].size:
                    acc.add(ci, np.zeros((0, n_sg), np.int64), 0, d["hits"].astype(np.int32))
        self._log_mapped(acc, sig)
        return acc

    def _log_mapped(self, acc: BinAccumulator, sig: SigKmers) -> None:
        total = max(len(sig), 1)
        logger.info(
            "Mapped %d kmer hits; %.2f%% of %d subgenome-specific kmers mapped",
            acc.mapped_positions, 100.0 * acc.mapped_kmer_count / total, total // 2,
        )

    def _map_features(self, records: list[tuple[str, str]], sig: SigKmers, tag: str,
                      what: str) -> tuple[dict, dict, list[str]]:
        """Significant k-mers onto feature sequences: writes
        ``.<tag>.bin.count`` and ``.<tag>.enrich`` (reference
        __main__.py:502-524, 567-578); returns (d_enriched, d_exchange,
        names). Timed as ``<tag>_map`` and ``<tag>_enrich``."""
        with self.spans.span(f"{tag}_map"):
            pack = FeaturePack.build(records, self.k)
            counts = pack.map_counts(sig, self.k, device=self.device)
            lens = {name: len(seq) for name, seq in records}
            feat_map = self.para_prefix + f".{tag}.bin.count"
            with open(feat_map, "w") as f:
                f.write("\t".join(["#chrom", "start", "end"] + self.sg_names) + "\n")
                for name, row in zip(pack.names, counts):
                    if row.sum() == 0:
                        continue  # only mapped features are output (reference)
                    f.write(f"{name}\t0\t{min(10000000, lens[name])}\t"
                            + "\t".join(str(int(v)) for v in row) + "\n")
            logger.info("Wrote %s", feat_map)
        with self.spans.span(f"{tag}_enrich"):
            keep = counts.sum(axis=1) > 0
            feat_enrich = self.para_prefix + f".{tag}.enrich"
            with open(feat_enrich, "w") as f:
                d_enriched, d_exchange = enrichmod.enrich_features(
                    f, self.d_sg, counts[keep],
                    self.sg_names, [n for n, k_ in zip(pack.names, keep) if k_],
                    max_pval=self.max_pval,
                )
            logger.info("Output: %s", feat_enrich)
            logger.info("%d significant subgenome-specific %s", len(d_enriched), what)
            for sg, count in sorted(Counter(d_enriched.values()).items()):
                logger.info("\t%d %s-specific %s", count, sg, what)
        return d_enriched, d_exchange, pack.names

    def _step_custom(self, sig: SigKmers):
        from subphaser_torch.io.fasta import iter_fasta

        logger.info("Mapping subgenome-specific kmers to custom features: %s",
                    self.custom_features)
        records = []
        for path in self.custom_features:
            for rid, _d, seq in iter_fasta(path):
                records.append((rid, seq.tobytes().decode()))
        self._map_features(records, sig, "custom", "features")

    def _step_ltr(self, sig: SigKmers):
        """LTR detection, classification, SG enrichment, insertion ages,
        trees. Returns the circos step's (ltr_bedlines, enrich_ltr_bedlines):
        every LTR's bed row, and the SG-enriched ones' grouped by SG.

        Mirrors reference Pipeline.step_ltr (__main__.py:549-648).
        """
        from subphaser_torch.ltr.age import plot_insert_age
        from subphaser_torch.ltr.pipeline import LTRPipeline

        logger.info("###Step: LTR")
        lpipe = LTRPipeline(
            self.genome,
            tmpdir=os.path.join(self.tmpdir, "LTR"),
            harvest_options=self.ltr_harvest_options,
            finder_options=self.ltr_finder_options,
            detectors=self.ltr_detectors,
            hmm_db=self.hmm_db,
            all_ltr=self.all_ltr,
            intact_ltr=self.intact_ltr,
            mu=self.mu,
            overwrite=self.overwrite,
            max_evalue=self.max_evalue,
            pass2_rule=self.pass2_rule if self.pass2_enabled else None,
            pass2_enabled=self.pass2_enabled,
            device=self.device,
        )
        self.ltr_pipeline = lpipe
        ltrs, _ltr_fa = lpipe.run()
        self.enriched_ltrs = []
        if not ltrs:
            logger.warning("No LTR-RTs detected; skipping LTR analyses")
            return [], []

        # reuse the decoded sequences LTRPipeline already built (a second
        # full-genome decode would double peak host memory on Gb genomes)
        d_seqs = getattr(lpipe, "d_seqs", None) or {
            c.name: c.to_seq() for c in self.genome.chroms
        }
        records = [(ltr.id, ltr.get_full_seq(d_seqs[ltr.seq_id])) for ltr in ltrs]
        logger.info("Enriching subgenome-specific LTR-RTs")
        d_enriched, d_exchange, _names = self._map_features(records, sig, "ltr", "LTR-RTs")

        with self.spans.span("ltr_age"):
            d_colors = self.sg_color.for_names(self.sg_names)
            if d_enriched:
                self.enriched_ltrs = plot_insert_age(
                    ltrs, d_enriched, self.para_prefix + ".ltr.insert",
                    mu=self.mu, exclude_exchanges=self.exclude_exchanges,
                    d_exchange=d_exchange, non_specific=self.non_specific,
                    figfmt=self.figfmt, d_colors=d_colors,
                )
            else:
                logger.warning(
                    "Because of none subgenome-specific LTR-RTs, plots of LTR-RTs "
                    "are skipped."
                )

        if not self.disable_ltrtree and self.enriched_ltrs:
            self._step_ltr_tree(getattr(lpipe, "d_class", None), d_seqs, d_colors)

        ltr_bedlines = [ltr.to_bed() for ltr in ltrs]
        d_bed = {}
        for ltr in self.enriched_ltrs:
            d_bed.setdefault(ltr.sg, []).append(ltr.to_bed())
        enrich_ltr_bedlines = [v for _k, v in sorted(d_bed.items()) if v]
        return ltr_bedlines, enrich_ltr_bedlines

    def _step_ltr_tree(self, d_class, d_seqs, d_colors):
        """The SG-enriched LTRs' trees (JAX pipeline.py:951-965). A host
        failure is logged and the run goes on, as in the JAX package; a
        kernel that did not build, launch or run raises."""
        from subphaser_torch.ltr.tree import build_ltr_trees

        with self.spans.span("ltr_tree"):
            try:
                build_ltr_trees(
                    self.enriched_ltrs, d_seqs, self.para_prefix,
                    domains=self.ltr_domains, subsample=self.subsample,
                    exclude_exchanges=self.exclude_exchanges,
                    d_colors=d_colors, figfmt=self.figfmt, d_class=d_class,
                    trim_gt=self.trim_gt, n_boot=self.tree_boot,
                    use_branch_lengths=self.tree_branch_lengths,
                    device=self.device,
                )
            except kernels.KernelError:
                raise
            except Exception as e:
                if self.device.type == "cuda":
                    kernels.synchronize(self.device)  # a CUDA fault is not a host failure
                logger.warning("LTR tree step failed: %s", e)

    def _step_circos(self, acc, ltr_bedlines, enrich_ltr_bedlines):
        """Homoeologous blocks + multi-ring circos figure, timed as
        ``circos`` (its blocks part also as ``blocks``).

        Mirrors reference Pipeline.step_circos/step_blocks
        (__main__.py:679-713). Where matplotlib does not import, the PAFs
        are written and the figure and its legend are not.
        """
        with self.spans.span("circos"):
            logger.info("###Step: Circos")
            pafs = []
            if not self.disable_blocks:
                from subphaser_torch.blocks.align import run_align

                blocks_dir = os.path.join(self.tmpdir, "Blocks")
                with self.spans.span("blocks", top=True):
                    pafs, _offsets = run_align(
                        self.alt_sgs, self.genome, blocks_dir,
                        min_block=self.min_block, k=min(self.k, 15),
                        min_anchors=self.block_min_anchors,
                        max_gap=self.block_max_gap,
                        device=self.device, step_seconds=self.step_seconds,
                    )

            if self._can_plot("the circos figure is"):
                from subphaser_torch.viz.circos import circos_plot

                names = self.chrom_labels
                if self.chr_order:
                    names = [c for c in self.chr_order if c in set(self.chrom_labels)]
                chrom_sizes = {n: self.genome.chrom(n).length for n in names}
                bin_counts = {n: acc.per_chrom[self.chrom_labels.index(n)] for n in names}
                outfig = self.para_prefix + ".circos." + self.figfmt
                circos_plot(
                    chrom_sizes, self.d_sg, self.sg_names,
                    self.sg_color.for_names(self.sg_names),
                    bin_counts, BIN_SIZE, self.window_size, outfig,
                    enrich_lines=getattr(self, "sg_lines", None),
                    ltr_bedlines=ltr_bedlines,
                    enrich_ltr_bedlines=enrich_ltr_bedlines,
                    pafs=pafs, min_block=self.min_block,
                    legend_file=self.para_prefix + ".circos.legend.txt",
                )
                logger.info("Wrote %s", outfig)

    def _final(self):
        if self.cleanup:
            logger.info("Cleaning %s", self.tmpdir)
            shutil.rmtree(self.tmpdir, ignore_errors=True)


def _check_duplicates(lst):
    if not lst:
        return
    dup = {v: c for v, c in Counter(lst).items() if c > 1}
    if dup:
        raise ValueError(f"Duplicates detected: {dup}")


def _parse_mem(spec) -> int | None:
    """parse_mem with a friendly -max_memory error."""
    try:
        return parse_mem(spec)
    except ValueError:
        raise ValueError(f"Cannot parse -max_memory value {spec!r}") from None


def _num(x: float):
    """2.0 -> 2 in file basenames (argparse float defaults)."""
    return int(x) if float(x).is_integer() else x
