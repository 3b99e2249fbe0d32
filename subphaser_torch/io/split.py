"""Sequence windowing/splitting utilities (reference split_records.py roles).

The device pipeline tiles packed chromosomes natively, so these cover the
reference's standalone uses: windowed cutting with overlap + offset map
(reference cut_seqs, split_records.py:206-229) and size-balanced chunking
(bin_split_fastx_by_chunk_num, :230-270) for users scripting against the
API (e.g. preparing external-aligner inputs).
"""

from __future__ import annotations

from subphaser_torch.io.fasta import iter_fasta, xopen


def cut_seqs(paths, fout, window_size: int = 500_000, window_ovl: int = 100_000):
    """Cut records into overlapping windows; returns {window_id: (id, offset)}.

    Window ids are '<id>:<start1>-<end>' (1-based), like the reference's.
    """
    if isinstance(paths, str):
        paths = [paths]
    offsets = {}
    for path in paths:
        for rid, _desc, seq in iter_fasta(path):
            n = seq.shape[0]
            for s in range(0, n + 1, window_size):
                e = min(s + window_size + window_ovl, n)
                sub = seq[s:e].tobytes().decode()
                sid = f"{rid}:{s + 1}-{e}"
                offsets[sid] = (rid, s)
                fout.write(f">{sid} length={len(sub)}\n{sub}\n")
                if e == n:
                    break
    return offsets


def balanced_chunks(sizes: dict[str, int], n_chunks: int) -> list[list[str]]:
    """Greedy size-balanced partition (binpacking replacement)."""
    chunks: list[list[str]] = [[] for _ in range(max(n_chunks, 1))]
    loads = [0] * max(n_chunks, 1)
    for name, size in sorted(sizes.items(), key=lambda kv: -kv[1]):
        i = loads.index(min(loads))
        chunks[i].append(name)
        loads[i] += size
    return [c for c in chunks if c]


def split_fasta_balanced(path: str, prefix: str, n_chunks: int, suffix: str = ""):
    """Split records into ~equal-total-size files; returns the file list."""
    records = {rid: seq for rid, _d, seq in iter_fasta(path)}
    sizes = {rid: s.shape[0] for rid, s in records.items()}
    outfiles = []
    for i, chunk in enumerate(balanced_chunks(sizes, n_chunks), 1):
        out = f"{prefix}.{i}.fasta{suffix}"
        with xopen(out, "wt") as f:
            for rid in chunk:
                f.write(f">{rid}\n{records[rid].tobytes().decode()}\n")
        outfiles.append(out)
    return outfiles
