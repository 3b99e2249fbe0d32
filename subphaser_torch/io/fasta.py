"""Streaming FASTA(.gz) readers (no Biopython dependency).

Replaces the reference's Biopython/xopen IO (reference Seqs.py:27-71,
split_records.py). Sequences are returned as raw ASCII ``np.uint8`` arrays so
downstream 2-bit packing is a single LUT gather.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator

import numpy as np


def xopen(path: str, mode: str = "rt"):
    """Open a possibly-gzipped file transparently (by magic bytes for reads)."""
    if "r" in mode:
        f = open(path, "rb")
        magic = f.read(2)
        f.seek(0)
        if magic == b"\x1f\x8b":
            g = gzip.open(f, "rb")
            return io.TextIOWrapper(g) if "t" in mode or "b" not in mode else g
        return io.TextIOWrapper(f) if "t" in mode or "b" not in mode else f
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def iter_fasta(path: str) -> Iterator[tuple[str, str, np.ndarray]]:
    """Yield (id, description, seq_bytes uint8) per record.

    Bulk parser: the whole (decompressed) file is read and split with
    C-speed bytes operations — a line-by-line Python loop costs minutes on
    Gb-scale genomes.
    """
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f = gzip.open(f, "rb")
    with f:
        data = f.read()
    first = data.find(b">")
    if first < 0:
        return
    for block in data[first + 1 :].split(b"\n>"):
        eol = block.find(b"\n")
        if eol < 0:
            header, body = block, b""
        else:
            header, body = block[:eol], block[eol + 1 :]
        header = header.strip(b"\r").decode()
        parts = header.split(None, 1)
        name = parts[0] if parts else ""
        desc = parts[1] if len(parts) > 1 else ""
        body = body.replace(b"\n", b"")
        if b"\r" in body:
            body = body.replace(b"\r", b"")
        yield name, desc, np.frombuffer(body, dtype=np.uint8)


def iter_fasta_raw(path: str) -> Iterator[tuple[str, str, np.ndarray]]:
    """Yield (id, description, RAW body uint8 view — newlines/CR included).

    Zero-copy: record bodies are views into the one file buffer, so no
    split copy is made before the packer strips the line breaks. Offsets
    come from C-speed ``bytes.find`` scans.
    """
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f = gzip.open(f, "rb")
    with f:
        data = f.read()
    buf = np.frombuffer(data, dtype=np.uint8)
    pos = data.find(b">")
    while pos >= 0:
        eol = data.find(b"\n", pos)
        if eol < 0:
            header = data[pos + 1 :].strip(b"\r")
            body = buf[len(data) :]
            nxt = -1
        else:
            header = data[pos + 1 : eol].strip(b"\r")
            nxt = data.find(b"\n>", eol)
            end = len(data) if nxt < 0 else nxt + 1
            body = buf[eol + 1 : end]
        parts = header.decode().split(None, 1)
        name = parts[0] if parts else ""
        desc = parts[1] if len(parts) > 1 else ""
        yield name, desc, body
        pos = -1 if nxt < 0 else nxt + 1


def write_fasta(path: str, records, width: int = 60) -> None:
    """Write records ``(id, seq)`` where seq is str / bytes / uint8 array."""
    with xopen(path, "wt") as out:
        for rid, seq in records:
            if isinstance(seq, np.ndarray):
                seq = seq.tobytes().decode()
            elif isinstance(seq, (bytes, bytearray)):
                seq = bytes(seq).decode()
            out.write(f">{rid}\n")
            for i in range(0, len(seq), width):
                out.write(seq[i : i + width])
                out.write("\n")
