"""PyTorch port of parallel/phase_step and parallel/mesh, and the Pipeline
over a mesh of devices, against the JAX package's on its 8-device virtual
CPU mesh (tests/test_parallel.py's fixture); the port's meshes are CPU
shards.

Tolerance: exact counts, differential flags and output files; the labels
equal the JAX step's up to the canonical renumbering both apply (the two
packages' random streams differ, so only the assignment is compared). The
cuda cases hold the candidate_counts kernel to its plain version on the
card, bit for bit.
"""

import numpy as np
import pytest
import torch

from subphaser_torch.ops.kmer import SENTINEL
from subphaser_torch.parallel import phase_step as tps
from subphaser_torch.parallel.mesh import Mesh, make_mesh
from make_synthetic import make_genome
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

K = 15
TILE = 1 << 14


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from subphaser_tpu.config import SGConfig, build_targets, group_indices, update_sgs
    from subphaser_tpu.io.genome import PackedGenome
    from subphaser_tpu.ops.count import merge_host
    from subphaser_tpu.ops.filter import make_group_spec
    from subphaser_tpu.phase.filtering import streaming_filter
    from subphaser_tpu.phase.spectrum import count_genome

    base = tmp_path_factory.mktemp("par")
    fa, cfg = make_genome(str(base), n_sets=2, chrom_size=60_000)
    c = SGConfig.parse(cfg)
    targets = build_targets(c.chrs)
    genome, _ = PackedGenome.from_fasta_files([fa], targets=targets)
    order = {n: i for i, n in enumerate(targets.values())}
    genome.chroms.sort(key=lambda x: order[x.name])
    labels = genome.names
    sgs = update_sgs(c.sgs, targets)
    spectra = count_genome(genome, K, lower_count=3, tile_bases=TILE)
    all_codes, tot = merge_host([(s.codes, s.counts) for s in spectra])
    cand = all_codes[(tot >= 50) & (tot <= 1e9)].astype(np.int32)
    lengths = np.array([s.total for s in spectra], dtype=np.float32)
    spec = make_group_spec(group_indices(sgs, labels), len(labels))
    tiles = list(genome.tiles(K, tile_bases=TILE))
    words = np.stack([t.words for t in tiles])
    vwords = np.stack([t.vwords for t in tiles])
    onehot = np.zeros((len(tiles), len(labels)), dtype=np.float32)
    for i, t in enumerate(tiles):
        onehot[i, t.chrom_index] = 1.0
    host = streaming_filter(spectra, spec, min_freq=50, max_freq=1e9, min_fold=2.0,
                            want_histogram=False).matrix
    order = np.argsort(labels).astype(np.int32)
    args = (words, vwords, onehot, cand, lengths, spec.member, spec.set_groups,
            spec.set_ncols, np.asarray(spec.set_valid), order)
    return labels, args, host


def _jax_step(mesh_shape, args):
    import jax

    from subphaser_tpu.parallel.mesh import make_mesh as j_make_mesh
    from subphaser_tpu.parallel.phase_step import build_phase_step, shard_inputs

    mesh = j_make_mesh(*mesh_shape)
    step = build_phase_step(mesh, k=K, n_pos_words=TILE // 16, n_clusters=2, min_freq=50,
                            max_freq=1e9, min_fold=2.0)
    labels, counts, diff = step(*shard_inputs(mesh, *args), jax.random.PRNGKey(0))
    return np.asarray(labels), np.asarray(counts), np.asarray(diff)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_phase_step_matches_host_and_jax(setup, mesh_shape):
    labels, args, host = setup
    mesh = make_mesh(*mesh_shape, devices=["cpu"] * 8)
    step = tps.build_phase_step(mesh, k=K, n_pos_words=TILE // 16, n_clusters=2,
                                min_freq=50, max_freq=1e9, min_fold=2.0)
    sharded = tps.shard_inputs(mesh, *args)
    before = tps.launches["candidate_counts"]
    out, counts, diff = step(*sharded, torch.Generator().manual_seed(0))
    assert tps.launches["candidate_counts"] == before  # CPU tensors: the plain version
    out, counts, diff = out.numpy(), counts.numpy(), diff.numpy()

    # counts and flags on the padded candidate table against the host filter
    cand = sharded[3].numpy()
    assert cand.size % mesh_shape[1] == 0
    valid = cand != SENTINEL
    idx = np.searchsorted(host.codes, cand[valid])
    idx_c = np.minimum(idx, max(host.codes.size - 1, 0))
    isdiff = (idx < host.codes.size) & (host.codes[idx_c] == cand[valid])
    np.testing.assert_array_equal(diff[valid], isdiff)
    assert not diff[~valid].any()
    np.testing.assert_array_equal(counts[valid][isdiff], host.counts[idx_c[isdiff]])

    # the JAX step: the same counts and flags, the same canonical labels
    jlabels, jcounts, jdiff = _jax_step(mesh_shape, args)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(diff, jdiff)
    np.testing.assert_array_equal(out, jlabels)
    assign = dict(zip(labels, out))
    a = {assign[c] for c in labels if c.startswith("A")}
    b = {assign[c] for c in labels if c.startswith("B")}
    assert len(a) == 1 and len(b) == 1 and a != b


def test_mesh_shapes_and_refusal():
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "kmer": 2} and mesh.devices.shape == (4, 2)
    assert len(mesh.axis_devices("data")) == 4 and len(mesh.axis_devices("kmer")) == 2
    assert make_mesh(None, 2, devices=["cpu"] * 6).shape == {"data": 3, "kmer": 2}
    with pytest.raises(ValueError, match="needs 8 devices, have 6"):
        make_mesh(4, 2, devices=["cpu"] * 6)
    assert Mesh([torch.device("cpu")] * 3, ("data",)).shape == {"data": 3}


def _kernel_inputs(n_tiles, n, n_cand, n_chrom, seed, sorted_cand=True):
    rng = np.random.default_rng(seed)
    codes = np.full((n_tiles, n), SENTINEL, np.int32)
    counts = np.zeros((n_tiles, n), np.int32)
    for t in range(n_tiles):
        u = np.unique(rng.integers(0, 1 << 20, size=n - rng.integers(0, n // 4 + 1)))
        codes[t, :u.size] = u
        counts[t, :u.size] = rng.integers(1, 1 << 20, size=u.size)
    pool = np.unique(np.concatenate([codes[codes != SENTINEL],
                                     rng.integers(0, 1 << 20, size=n_cand)]))
    cand = rng.choice(pool, size=n_cand, replace=False).astype(np.int32)
    if sorted_cand:
        cand.sort()
    cand[rng.random(n_cand) < 0.05] = SENTINEL
    chrom = np.sort(rng.integers(0, n_chrom, size=n_tiles)).astype(np.int32)
    chrom[rng.random(n_tiles) < 0.1] = -1  # padding tiles
    return [torch.from_numpy(a) for a in (codes, counts, chrom, cand)]


def test_candidate_counts_plain_is_the_one_hot_product():
    codes, counts, chrom, cand = _kernel_inputs(12, 300, 500, 3, seed=1)
    got = tps.candidate_counts(codes, counts, chrom, cand, 3).numpy()
    want = np.zeros((cand.numel(), 3), np.int64)
    for t in range(codes.shape[0]):
        if chrom[t] < 0:
            continue
        row = dict(zip(codes[t].tolist(), counts[t].tolist()))
        for b, c in enumerate(cand.tolist()):
            if c != SENTINEL:
                want[b, chrom[t]] += row.get(c, 0)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_candidate_counts_refuses_bad_inputs():
    codes, counts, chrom, cand = _kernel_inputs(2, 16, 8, 2, seed=2)
    with pytest.raises(ValueError):
        tps.candidate_counts(codes.long(), counts, chrom, cand, 2)
    with pytest.raises(ValueError):
        tps.candidate_counts(codes, counts[:1], chrom, cand, 2)
    with pytest.raises(ValueError):
        tps.shard_inputs(make_mesh(2, 1, devices=["cpu"] * 2), codes.numpy(), codes.numpy(),
                         np.full((2, 2), 0.5, np.float32), cand.numpy())


def _edge(args, edge: str, seed: int):
    """The kernel inputs of an edge case: every candidate SENTINEL; every
    tile but one padding; chromosomes that change inside a group of tiles;
    sorted candidates every 10th code of a row (a block's segment beyond
    the stage); sorted candidates descending in each run of 4 (a thread's);
    counts whose sums wrap past 2^31."""
    codes, counts, chrom, cand = (a.clone() for a in args)
    rng = np.random.default_rng(seed)
    if edge == "all_sentinel":
        cand[:] = SENTINEL
    elif edge == "padding_tiles":
        chrom[:] = -1
        chrom[chrom.numel() // 2] = 0
    elif edge == "chrom_change":
        chrom[:] = torch.arange(chrom.numel()) // 3 % (int(chrom.max()) + 1)
    elif edge == "sparse":
        real = codes[0][codes[0] != SENTINEL]
        cand = real[::10][: cand.numel()].contiguous()
    elif edge == "local_unsorted":  # each thread's candidates descending
        m = cand.numel() // 4 * 4
        cand[:m] = cand[:m].reshape(-1, 4).flip(1).reshape(-1).clone()
    elif edge == "wrap":
        counts[:] = torch.from_numpy(rng.integers(1 << 29, 1 << 30, size=tuple(counts.shape),
                                                  dtype=np.int32))
        chrom[:] = 0
    return codes, counts, chrom, cand


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,n,n_cand,n_chrom,sorted_cand,edge", [
    (1, 1, 1, 1, True, ""), (3, 1000, 257, 2, True, ""), (20, 1 << 14, 5000, 5, True, ""),
    (9, 4096, 3000, 3, False, ""), (70, 2048, 700, 21, True, ""),
    (30, 1 << 18, 20_000, 6, True, ""),                     # the step's shape, cut
    (11, 4096, 600, 2, True, "all_sentinel"), (19, 4096, 3000, 3, True, "padding_tiles"),
    (19, 4096, 3000, 3, True, "chrom_change"), (9, 1 << 15, 2000, 2, True, "sparse"),
    (19, 8192, 1500, 1, True, "wrap"), (7, 4095, 1500, 2, True, ""),  # rows of 4-byte copies
    (12, 4096, 2500, 3, True, "local_unsorted")])
def test_cuda_candidate_counts_matches_plain(n_tiles, n, n_cand, n_chrom, sorted_cand, edge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _kernel_inputs(n_tiles, n, n_cand, n_chrom, seed=n_tiles, sorted_cand=sorted_cand)
    args = [a.cuda() for a in _edge(args, edge, n_tiles)]
    before = tps.launches["candidate_counts"]
    got = tps.candidate_counts(*args, n_chrom)
    torch.cuda.synchronize()
    assert tps.launches["candidate_counts"] == before + 1
    assert torch.equal(got.cpu(), tps.candidate_counts_plain(*args, n_chrom).cpu())


@pytest.mark.cuda
def test_cuda_candidate_counts_two_kernels_a_call():
    """A call captured into a CUDA graph holds two kernel launches: the
    segments (which also zero the output), then the counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from subphaser_torch import kernels

    args = [a.cuda() for a in _kernel_inputs(12, 4096, 1000, 3, seed=4)]
    assert kernels.graph_kernel_launches(lambda: tps.candidate_counts(*args, 3)) == 2


def test_pipeline_eight_shards_same_files_as_one_and_jax(tmp_path):
    """Pipeline(device="cpu", n_devices=8) counts and maps over an 8-shard
    mesh and writes the bytes of the one-device run; the JAX package's run
    on its 8 virtual devices writes the same files (the assignment columns
    of .chrom-subgenome.tsv: its support column comes from each package's
    own random draws)."""
    from subphaser_torch.phase.pipeline import Pipeline as TP
    from subphaser_tpu.phase.pipeline import Pipeline as JP

    d = tmp_path / "gen"
    genome, cfg = make_genome(str(d), n_sets=2, chrom_size=60_000)
    kw = dict(min_freq=40, replicates=10, tile_bases=1 << 16, figfmt="png",
              disable_ltr=True, disable_circos=True, window_size=40_000, seed=0)
    outs = {}
    for tag, ndev in (("multi", 8), ("single", 1)):
        pipe = TP([genome], [cfg], outdir=str(tmp_path / f"out_{tag}"),
                  tmpdir=str(tmp_path / f"tmp_{tag}"), device="cpu", n_devices=ndev, **kw)
        pipe.run()
        outs[tag] = tmp_path / f"out_{tag}"
        assert (pipe.mesh is not None) == (tag == "multi")
    assert pipe.basename == "k15_q40_f2"
    jpipe = JP([genome], [cfg], outdir=str(tmp_path / "out_jax"),
               tmpdir=str(tmp_path / "tmp_jax"), **kw).run()
    assert jpipe.mesh is not None and jpipe.mesh.shape["data"] == 8
    for suffix in (".kmer.mat", ".chrom-subgenome.tsv", ".sig.kmer-subgenome.tsv",
                   ".subgenome.bin.count", ".bin.enrich", ".bin.group"):
        name = pipe.basename + suffix
        got = (outs["multi"] / name).read_bytes()
        assert got == (outs["single"] / name).read_bytes(), name
        want = (tmp_path / "out_jax" / name).read_bytes()
        if suffix == ".chrom-subgenome.tsv":
            got, want = ([line.split(b"\t")[:2] for line in x.splitlines()[1:]]
                         for x in (got, want))
        assert got == want, name
