"""Plain reference of core phasing: FASTA + config -> the five core files.

Worked out again from the FASTA and the config alone, with plain torch
(k-mer codes, counting and mapping, on any device), numpy and scipy.stats
(the tests that upstream SubPhaser calls by name: ``ttest_ind`` and the
hypergeometric right tail of its Fisher test). It imports nothing of the
program. It returns, for each file, the lines that the program should
write:

- ``kmer.mat``: canonical k-mers counted per chromosome (k-mers touching a
  non-ACGT base skipped, counts below ``lower_count`` dropped), the total
  window ``min_freq..max_freq``, and the fold vote of each homoeologous set
  (group frequency = count / chromosome total; top over the
  ``baseline``-th largest plus 1e-20 at least ``min_fold``; the voting
  share of non-singleton sets at least ``ratio``), in float64;
- ``chrom-subgenome.tsv``: the partition of least k-means inertia on the
  z-scored frequencies, clusters named SG1.. by first appearance in sorted
  chromosome order (bootstrap support is drawn from the program's random
  stream and is not worked out here);
- ``sig.kmer-subgenome.tsv``: per k-mer the top-mean subgenome tested
  against the second, kept unless p > ``max_pval``;
- ``subgenome.bin.count``: forward k-mers of every position found among the
  kept k-mers and their reverse complements, counted per 10 kb bin;
- ``bin.enrich``: bins stacked into windows, a one-sided Fisher test per
  window and subgenome, the significance gates and BH-corrected p.

``precision`` is the float type of the host arithmetic (float64 as the
configuration states; float32 is the control).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy import stats as sps

MAX_INT = 2147483647 // 10  # the Fisher table's clamp (upstream Stats.py)
_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
    _LUT[_c + 32] = _i
_CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Options:
    k: int = 15
    min_freq: float = 200
    max_freq: float = 1e9
    min_fold: float = 2.0
    baseline: int = 1
    ratio: float = 1.0
    lower_count: int = 3
    max_pval: float = 0.05
    test_method: str = "ttest_ind"
    bin_size: int = 10000
    window_size: int = 1000000
    nsg: int | None = None

    @classmethod
    def from_argv(cls, argv: list[str]) -> "Options":
        """The options a job's command line sets (the CLI's flag names)."""
        names = {"-k": ("k", int), "-q": ("min_freq", int), "-min_freq": ("min_freq", int),
                 "-max_freq": ("max_freq", int), "-f": ("min_fold", float),
                 "-min_fold": ("min_fold", float), "-baseline": ("baseline", int),
                 "-ratio": ("ratio", float), "-lower_count": ("lower_count", int),
                 "-max_pval": ("max_pval", float), "-test_method": ("test_method", str),
                 "-window_size": ("window_size", int), "-nsg": ("nsg", int)}
        opts = cls()
        for flag, value in zip(argv, argv[1:]):
            if flag in names:
                key, conv = names[flag]
                setattr(opts, key, conv(value))
        return opts


def read_fasta(path: str) -> dict[str, np.ndarray]:
    """{id: ASCII bases} of a plain FASTA file."""
    with open(path, "rb") as f:
        data = f.read()
    out = {}
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        out[head.split()[0].decode()] = np.frombuffer(
            body.replace(b"\n", b"").replace(b"\r", b""), dtype=np.uint8)
    return out


def read_config(path: str) -> list[list[tuple[str, str]]]:
    """Homoeologous sets: rows of (name, FASTA id), one per column."""
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split("#")[0].split()
            if toks:
                rows.append([(t.split("|")[0], t.split("|")[-1]) for t in toks])
    return rows


def kmer_codes(seq: np.ndarray, k: int, device):
    """Forward and canonical codes (int64, first base in the high bits) of
    every start position, and whether the k-mer is all ACGT."""
    b = torch.from_numpy(_LUT[seq]).to(device)
    n = b.numel() - k + 1
    if n <= 0:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, empty, torch.zeros(0, dtype=torch.bool, device=device)
    fwd = torch.zeros(n, dtype=torch.int64, device=device)
    rc = torch.zeros(n, dtype=torch.int64, device=device)
    bad = torch.zeros(n, dtype=torch.int32, device=device)
    for j in range(k):
        x = b[j:j + n]
        bad += (x > 3).to(torch.int32)
        x = x.to(torch.int64) & 3
        fwd = (fwd << 2) | x
        rc |= (3 - x) << (2 * j)
    return fwd, torch.minimum(fwd, rc), bad == 0


def count_chrom(seq: np.ndarray, k: int, lower_count: int, device):
    """Sorted canonical codes and their counts (>= lower_count)."""
    _fwd, canon, valid = kmer_codes(seq, k, device)
    codes, counts = torch.unique(canon[valid], return_counts=True)
    keep = counts >= lower_count
    return codes[keep].cpu().numpy(), counts[keep].cpu().numpy().astype(np.int64)


def kmer_strings(codes: np.ndarray, k: int) -> np.ndarray:
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.int64))
    idx = (np.asarray(codes, dtype=np.int64)[:, None] >> shifts[None, :]) & 3
    return _CHARS[idx].view(f"S{k}").reshape(-1).astype(f"U{k}")


def revcomp(codes: np.ndarray, k: int) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.int64)
    out = np.zeros_like(codes)
    for j in range(k):
        out = (out << 2) | (3 - ((codes >> (2 * j)) & 3))
    return out


def fold_gate(mat, lengths, sets, opts: Options, dtype):
    """The fold vote of every row (see the module docstring)."""
    votes = np.zeros(mat.shape[0], dtype=np.int64)
    n_valid = 0
    for cols in sets:
        if len(cols) < 2:
            continue
        n_valid += 1
        freqs = np.stack([mat[:, c].sum(axis=1).astype(dtype) / dtype(lengths[c].sum())
                          for c in cols], axis=1)
        desc = np.sort(freqs, axis=1)[:, ::-1]
        b = opts.baseline if opts.baseline >= 0 else len(cols) + opts.baseline
        include = desc[:, 0] / (desc[:, b] + dtype(1e-20)) >= opts.min_fold
        votes += include
    return votes / max(n_valid, 1) >= opts.ratio


def _set_partitions(n: int, k: int):
    """Every partition of range(n) into k non-empty blocks, as labels."""
    def rec(i, labels, used):
        if i == n:
            if used == k:
                yield list(labels)
            return
        for lab in range(min(used + 1, k)):
            if n - i - 1 < k - max(used, lab + 1):
                continue
            labels.append(lab)
            yield from rec(i + 1, labels, max(used, lab + 1))
            labels.pop()
    yield from rec(0, [], 0)


def least_inertia_partition(data: np.ndarray, k: int) -> np.ndarray:
    """Labels of the k-means partition of least inertia, found by trying
    every partition (a handful of chromosomes), else by Lloyd from a
    farthest-first start."""
    n = data.shape[0]
    sq = (data * data).sum(axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * data @ data.T, 0.0)
    if n <= 10:
        best, best_lab = np.inf, None
        for labels in _set_partitions(n, k):
            lab = np.array(labels)
            inertia = sum(d2[np.ix_(lab == c, lab == c)].sum() / (2 * (lab == c).sum())
                          for c in range(k))
            if best_lab is None or inertia < best - 1e-9 * abs(best):
                best, best_lab = inertia, lab
        return best_lab
    centers = [0]
    for _ in range(1, k):
        centers.append(int(np.argmax(d2[:, centers].min(axis=1))))
    c = data[centers]
    for _ in range(300):
        lab = ((data[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
        c = np.stack([data[lab == j].mean(0) if (lab == j).any() else c[j] for j in range(k)])
    return lab


def zscore(x: np.ndarray) -> np.ndarray:
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    return (x - mean) / np.where(std > 0, std, 1.0)


def _fmt(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


def fisher_enrich_pvals(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum(axis=0)
    rowsum = counts.sum(axis=1, keepdims=True)
    grand = total.sum()
    x11 = counts
    x12 = rowsum - x11
    x21u = total[None, :] - x11
    x22 = np.minimum(grand - x21u - x12, MAX_INT)
    x21 = np.minimum(x21u, MAX_INT)
    return sps.hypergeom.sf(x11 - 1, x11 + x12 + x21 + x22, x11 + x12, x11 + x21)


def bh_fdr(p: np.ndarray) -> np.ndarray:
    n = p.size
    order = np.argsort(p, kind="stable")
    ranked = p[order] * n / np.arange(1, n + 1)
    adj = np.clip(np.minimum.accumulate(ranked[::-1])[::-1], 0, 1)
    out = np.empty_like(adj)
    out[order] = adj
    return out


def enrich_lines(counts, rownames, sg_names, d_sg, max_pval, dtype):
    """bin.enrich lines (window x subgenome Fisher tests and their gates)."""
    header = "\t".join(["#chrom", "start", "end", "subgenome", "p_value", "counts",
                        "ratios", "enrich", "pvals", "potential_exchange",
                        "p_corrected"])
    if counts.shape[0] == 0:
        return [header]
    n_sg = counts.shape[1]
    pvals = fisher_enrich_pvals(counts).astype(dtype)
    order = np.argsort(pvals, axis=1, kind="stable")
    rows = np.arange(counts.shape[0])
    minp, subp = pvals[rows, order[:, 0]], pvals[rows, order[:, 1]]
    sig = minp <= max_pval
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        sig &= np.where(minp > 0, (subp / minp) >= (max_pval / subp) * 1.0, True)
        raw = counts / counts.sum(axis=0).astype(dtype)[None, :]
        ratios = raw / raw.sum(axis=1, keepdims=True)
        sig &= ~(ratios[rows, order[:, 0]] < 0.5)
    lines, minps = [], []
    for r, (chrom, start, end) in enumerate(rownames):
        key = sg_names[order[r, 0]] if sig[r] else None
        obs = d_sg.get(chrom)
        pot = "none" if not key or not obs else ("no" if obs == key else "yes")
        enrich = np.zeros(n_sg + 1, dtype=np.int64)
        enrich[order[r, 0] if sig[r] else -1] = 1
        lines.append([chrom, start, end, key, float(minp[r]),
                      ",".join(str(int(v)) for v in counts[r]),
                      ",".join(repr(float(v)) for v in ratios[r]),
                      ",".join(str(int(v)) for v in enrich),
                      ",".join(repr(float(v)) for v in pvals[r]), pot])
        minps.append(float(minp[r]))
    q = bh_fdr(np.array(minps, dtype=dtype))
    return [header] + ["\t".join(_fmt(v) for v in line + [float(qv)])
                       for line, qv in zip(lines, q)]


def core_files(fasta: str, config: str, opts: Options, device="cpu",
               precision: str = "float64") -> dict[str, list[str]]:
    """{file suffix: lines} of the five core files for one genome."""
    dtype = np.dtype(precision).type
    device = torch.device(device)
    k = opts.k
    rows = read_config(config)
    names = [name for row in rows for name, _ in row]
    ids = [fid for row in rows for _, fid in row]
    seqs = read_fasta(fasta)
    col = {name: j for j, name in enumerate(names)}
    sets = [[[col[name]] for name, _ in row] for row in rows]
    nsg = opts.nsg if opts.nsg and opts.nsg >= 2 else max(len(r) for r in rows)

    # counting: per chromosome, then the union
    spectra = [count_chrom(seqs[fid], k, opts.lower_count, device) for fid in ids]
    lengths = np.array([c.sum() for _, c in spectra], dtype=np.int64)
    union = np.unique(np.concatenate([codes for codes, _ in spectra]))
    mat = np.zeros((union.size, len(names)), dtype=np.int64)
    for j, (codes, counts) in enumerate(spectra):
        mat[np.searchsorted(union, codes), j] = counts
    tot = mat.sum(axis=1)
    keep = (tot >= opts.min_freq) & (tot <= opts.max_freq)
    keep &= fold_gate(mat, lengths, sets, opts, dtype)
    codes, mat = union[keep], mat[keep]
    freqs = mat.astype(dtype) / lengths.astype(dtype)[None, :]
    kmers = kmer_strings(codes, k)
    out = {"kmer.mat": ["kmer\t" + "\t".join(names)] + [
        kmer + "\t" + "\t".join(repr(float(v)) for v in row)
        for kmer, row in zip(kmers, freqs)]}

    # cluster: the partition and its names
    labels = least_inertia_partition(zscore(freqs.T.astype(np.float64)), nsg)
    first = {}
    for i in np.argsort(names, kind="stable"):
        first.setdefault(int(labels[i]), len(first))
    width = len(str(nsg))
    d_sg = {name: f"SG{first[int(l)] + 1:0>{width}d}" for name, l in zip(names, labels)}
    sg_names = sorted(set(d_sg.values()))
    out["chrom-subgenome.tsv"] = ["#chrom\tsubgenome\tbootstrap"] + [
        f"{name}\t{sg}" for name, sg in sorted(d_sg.items(), key=lambda x: x[1])]

    # significant k-mers: top-mean subgenome against the second
    group_idx = [np.array([i for i, n in enumerate(names) if d_sg[n] == sg])
                 for sg in sg_names]
    means = np.stack([freqs[:, gi].mean(axis=1) for gi in group_idx], axis=1)
    rank = np.argsort(-means, axis=1, kind="stable")
    top, second = rank[:, 0], rank[:, 1]
    pvals = np.full(freqs.shape[0], np.nan)
    test = getattr(sps, opts.test_method)
    pair = top * len(sg_names) + second
    for key in np.unique(pair):
        r = np.flatnonzero(pair == key)
        x = freqs[np.ix_(r, group_idx[top[r[0]]])]
        y = freqs[np.ix_(r, group_idx[second[r[0]]])]
        with np.errstate(all="ignore"):
            pvals[r] = np.atleast_1d(test(x, y, axis=1).pvalue)
    with np.errstate(invalid="ignore"):
        sig = ~(pvals > opts.max_pval)
    out["sig.kmer-subgenome.tsv"] = ["#kmer\tsubgenome\tp_value\tratios"] + [
        f"{kmers[i]}\t{sg_names[top[i]]}\t{float(pvals[i])!r}\t"
        + ",".join(repr(float(v)) for v in means[i])
        for i in np.flatnonzero(sig)]

    # mapping: forward k-mers against the kept k-mers and their complements
    sig_codes = np.concatenate([codes[sig], revcomp(codes[sig], k)])
    sig_sg = np.concatenate([top[sig], top[sig]])
    order = np.argsort(sig_codes, kind="stable")
    table = torch.from_numpy(sig_codes[order]).to(device)
    table_sg = torch.from_numpy(sig_sg[order].astype(np.int64)).to(device)
    n_sg = len(sg_names)
    bins = []
    for fid in ids:
        fwd, _canon, valid = kmer_codes(seqs[fid], k, device)
        nb = -(-seqs[fid].size // opts.bin_size)
        if table.numel() == 0 or fwd.numel() == 0:
            bins.append(np.zeros((nb, n_sg), dtype=np.int64))
            continue
        idx = torch.searchsorted(table, fwd).clamp_max(table.numel() - 1)
        hit = valid & (table[idx] == fwd)
        pos = torch.nonzero(hit).reshape(-1)
        flat = (pos // opts.bin_size) * n_sg + table_sg[idx[pos]]
        bins.append(torch.bincount(flat, minlength=nb * n_sg).reshape(nb, n_sg)
                    .cpu().numpy().astype(np.int64))
    lines = ["\t".join(["#chrom", "start", "end"] + sg_names)]
    for name, fid, arr in zip(names, ids, bins):
        for b in np.flatnonzero(arr.sum(axis=1) > 0):
            s = int(b) * opts.bin_size
            e = min(s + opts.bin_size, int(seqs[fid].size))
            lines.append(f"{name}\t{s}\t{e}\t" + "\t".join(str(int(v)) for v in arr[b]))
    out["subgenome.bin.count"] = lines

    # enrichment over windows
    factor = opts.window_size // opts.bin_size
    rownames, wrows = [], []
    for name, arr in zip(names, bins):
        nw = -(-arr.shape[0] // factor)
        pad = np.zeros((nw * factor - arr.shape[0], n_sg), dtype=np.int64)
        w = np.concatenate([arr, pad]).reshape(nw, factor, n_sg).sum(axis=1)
        for wi in np.flatnonzero(w.sum(axis=1) > 0):
            start = int(wi) * opts.window_size
            rownames.append((name, start, start + opts.window_size))
            wrows.append(w[wi])
    counts = np.array(wrows, dtype=np.int64) if wrows else np.zeros((0, n_sg), np.int64)
    out["bin.enrich"] = enrich_lines(counts, rownames, sg_names, d_sg, opts.max_pval, dtype)
    return out

