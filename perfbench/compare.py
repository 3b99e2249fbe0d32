"""The comparison that decides ``correct``: a job's five core files against
the plain reference's lines.

Each file gives one number, the lines that are missing, extra or different
(keyed by their first fields, the header included). Every comparison is
exact, so every limit is 0. The bootstrap column of
``chrom-subgenome.tsv`` comes from the program's own random stream, which
the reference does not follow: there the first two fields are compared and
the third has to be a whole percent (0..100).
"""

from __future__ import annotations

FILES = ("kmer.mat", "chrom-subgenome.tsv", "sig.kmer-subgenome.tsv",
         "subgenome.bin.count", "bin.enrich")
KEY_FIELDS = {"kmer.mat": 1, "chrom-subgenome.tsv": 1, "sig.kmer-subgenome.tsv": 1,
              "subgenome.bin.count": 2, "bin.enrich": 2}
NUMBER = {"kmer.mat": "kmer_mat_off", "chrom-subgenome.tsv": "chrom_sg_off",
          "sig.kmer-subgenome.tsv": "sig_kmers_off",
          "subgenome.bin.count": "bin_count_off", "bin.enrich": "bin_enrich_off"}
LIMITS = {name: 0 for name in NUMBER.values()}


def _bootstrap_ok(field: str) -> bool:
    return field.isdigit() and 0 <= int(field) <= 100


def lines_off(suffix: str, got: list[str], want: list[str]) -> int:
    """Lines of ``got`` missing from, extra to or different from ``want``."""
    if suffix == "chrom-subgenome.tsv":
        bad = 0
        trimmed = []
        for i, line in enumerate(got):
            fields = line.split("\t")
            if i and (len(fields) != 3 or not _bootstrap_ok(fields[2])):
                bad += 1
            trimmed.append(line if i == 0 else "\t".join(fields[:2]))
        return bad + lines_off("", trimmed, want)
    n_key = KEY_FIELDS.get(suffix, 1)
    off = int(not got or not want or got[0] != want[0])

    def keyed(lines):
        out = {}
        for line in lines[1:]:
            key = tuple(line.split("\t", n_key)[:n_key])
            out[key] = line if key not in out else None  # a repeated key never matches
        return out

    g, w = keyed(got), keyed(want)
    off += sum(1 for key, line in g.items() if w.get(key) != line or line is None)
    off += sum(1 for key in w if key not in g)
    off += abs((len(got) - 1) - len(g))  # repeated lines
    return off


def compare(files: dict[str, str | None], reference: dict[str, list[str]]) -> dict[str, int]:
    """{number name: value} for one job's files ({suffix: text or None})."""
    out = {}
    for suffix in FILES:
        text = files.get(suffix)
        want = reference[suffix]
        if text is None:
            out[NUMBER[suffix]] = len(want)
            continue
        out[NUMBER[suffix]] = lines_off(suffix, text.splitlines(), want)
    return out


def verdict(numbers: dict[str, int]) -> bool:
    return all(numbers[name] <= LIMITS[name] for name in LIMITS)
