"""PyTorch port of ops/stats (float32 device statistics) against the JAX
package's, on tests/test_stats.py's own inputs (numpy seeds).

Tolerances: the Fisher tail at tests/test_stats.py's (rtol 5e-2, atol 1e-4,
same decisions at 0.05): float32 lgamma differs between XLA's and the C
library's, and the log pmf is a difference of large lgammas; BH-FDR at
rtol 1e-5; the t-test at rtol 2e-4 / atol 1e-6 (its continued fraction,
float32); Mann-Whitney and Kruskal at rel 1e-4. The CUDA kernel is held to
its plain version on the card by the ``cuda`` test (rel 1e-4 on p > 1e-30,
same decisions at 0.05), which imports nothing of the JAX package.
"""

import pathlib

import numpy as np
import pytest
import torch
from scipy import stats as sps

from subphaser_torch.ops import stats as tstats
from subphaser_torch.ops import stats_host as hstats
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PORT = pathlib.Path(__file__).resolve().parents[1] / "subphaser_torch"


class _Jax:
    """The JAX package's ops/stats, imported at first use (the ``cuda``
    test runs where JAX is not installed)."""

    def __getattr__(self, name):
        from subphaser_tpu.ops import stats

        return getattr(stats, name)


jstats = _Jax()


def _fisher_close(got, want):
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-4)
    np.testing.assert_array_equal(got <= 0.05, want <= 0.05)


def test_fisher_right_tail_matches_jax():
    rng = np.random.default_rng(0)
    tables = rng.integers(0, 80, size=(200, 4)).astype(np.float32)
    cols = [tables[:, i] for i in range(4)]
    got = tstats.fisher_right_tail(*(torch.from_numpy(c) for c in cols)).numpy()
    _fisher_close(got, np.asarray(jstats.fisher_right_tail(*cols)))
    host = hstats.fisher_right_tail(*(c.astype(np.int64) for c in cols))
    m = host > 1e-30
    _fisher_close(got[m], host[m])
    assert tstats.launches["fisher_right_tail"] == 0  # the plain version on the CPU


def test_fisher_enrich_matches_jax_and_host():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 500, size=(20, 3))
    got = tstats.fisher_enrich_pvals(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32 and got.shape == (20, 3)
    _fisher_close(got, np.asarray(jstats.fisher_enrich_pvals(counts)))
    ph = hstats.fisher_enrich_pvals(counts)
    m = ph > 1e-30
    _fisher_close(got[m], ph[m])


def test_fisher_enrich_clips_like_jax():
    """Margins above MAX_INT are clipped in float32 as the JAX function
    (ops/stats.py:71-77) clips them: x21 first, then x22 from the clipped
    x21. (At these margins float32 lgamma has no digits left for the p
    values; the host float64 path is what decides.)"""
    counts = np.array([[30, 2, 1], [5, 5, 5], [0, 40, 0], [250_000_000, 1, 2]])
    c = counts.astype(np.float32)
    total = c.sum(axis=0)
    x12 = c.sum(axis=1, keepdims=True) - c
    x21 = np.minimum(total[None, :] - c, np.float32(jstats.MAX_INT))
    x22 = np.minimum(total.sum() - x21 - x12, np.float32(jstats.MAX_INT))
    got = tstats.enrich_tables(torch.from_numpy(counts))
    for g, want in zip(got, (c, x12, x21, x22)):
        np.testing.assert_array_equal(g.numpy(), want)
    p = tstats.fisher_enrich_pvals(torch.from_numpy(counts)).numpy()
    assert np.all((p >= 0) & (p <= 1))


@pytest.mark.parametrize("max_terms", [0, 1, 3, 40])
def test_fisher_max_terms_truncates_like_jax(max_terms):
    """Tables whose tail runs longer than max_terms: the sum stops after
    max_terms terms in both packages."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 20, size=64).astype(np.float32)
    b = rng.integers(50, 400, size=64).astype(np.float32)
    c = rng.integers(20, 400, size=64).astype(np.float32)
    d = rng.integers(100, 900, size=64).astype(np.float32)
    got = tstats.fisher_right_tail(*(torch.from_numpy(v) for v in (a, b, c, d)),
                                   max_terms=max_terms).numpy()
    want = np.asarray(jstats.fisher_right_tail(a, b, c, d, max_terms=max_terms))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-4)
    full = tstats.fisher_right_tail(*(torch.from_numpy(v) for v in (a, b, c, d))).numpy()
    upper = np.minimum(a + b, a + c)
    cut = upper - a > max_terms  # terms left unsummed
    assert np.all(got[cut] <= full[cut])
    if max_terms < 40:
        assert np.any(got[cut] < full[cut])


def test_fisher_edge_tables():
    """a > min(n1, k1) gives 0 (impossible table), a = min(n1, k1) the pmf
    alone, an empty input an empty output."""
    a, b, c, d = (torch.tensor(v, dtype=torch.float32) for v in
                  ([5.0, 3.0, 0.0], [-2.0, 0.0, 4.0], [1.0, 2.0, 3.0], [7.0, 9.0, 0.0]))
    got = tstats.fisher_right_tail(a, b, c, d).numpy()
    want = np.asarray(jstats.fisher_right_tail(*(v.numpy() for v in (a, b, c, d))))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-4)
    assert got[0] == 0.0
    empty = tstats.fisher_right_tail(*(torch.zeros(0) for _ in range(4)))
    assert empty.shape == (0,)


def test_bh_fdr_matches_jax_and_scipy():
    rng = np.random.default_rng(2)
    p = rng.random(100).astype(np.float32)
    got = tstats.bh_fdr(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(jstats.bh_fdr(p)), rtol=1e-5)
    np.testing.assert_allclose(got, sps.false_discovery_control(p.astype(np.float64),
                                                                method="bh"), rtol=1e-5)


def test_ttest_from_stats_matches_jax_and_scipy():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, size=(50, 4))
    y = rng.normal(0.5, 1.2, size=(50, 6))
    args = (x.mean(1), x.var(1, ddof=1), np.full(50, 4.0),
            y.mean(1), y.var(1, ddof=1), np.full(50, 6.0))
    got = tstats.ttest_ind_from_stats(*(torch.from_numpy(v) for v in args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jstats.ttest_ind_from_stats(*args)),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got, sps.ttest_ind(x, y, axis=1).pvalue, rtol=2e-4, atol=1e-6)


def test_ttest_zero_variance_rule():
    """Zero pooled variance: equal means give NaN, unequal means 0."""
    m1 = torch.tensor([1.0, 1.0, 0.3])
    v = torch.tensor([0.0, 0.0, 0.5])
    n = torch.tensor([3.0, 3.0, 3.0])
    m2 = torch.tensor([1.0, 2.0, 0.1])
    got = tstats.ttest_ind_from_stats(m1, v, n, m2, v, n).numpy()
    want = np.asarray(jstats.ttest_ind_from_stats(*(t.numpy() for t in (m1, v, n, m2, v, n))))
    assert np.isnan(got[0]) and np.isnan(want[0])
    assert got[1] == 0.0 == want[1]
    np.testing.assert_allclose(got[2], want[2], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("a,b", [(0.5, 0.5), (2.0, 0.5), (7.5, 3.0), (40.0, 0.5)])
def test_betainc_matches_jax(a, b):
    import jax.scipy.special as jsp

    x = np.concatenate([[0.0, 1.0], np.linspace(0.001, 0.999, 61)]).astype(np.float32)
    got = tstats.betainc(torch.full((x.size,), a), torch.full((x.size,), b),
                         torch.from_numpy(x)).numpy()
    want = np.asarray(jsp.betainc(np.float32(a), np.float32(b), x))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_mannwhitneyu_matches_jax_and_scipy():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 10, size=(50, 5)).astype(np.float32)  # ties likely
    y = rng.integers(0, 10, size=(50, 7)).astype(np.float32)
    got = tstats.mannwhitneyu(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jstats.mannwhitneyu(x, y))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for i in range(50):
        expected = sps.mannwhitneyu(x[i], y[i], alternative="two-sided",
                                    method="asymptotic").pvalue
        assert got[i] == pytest.approx(expected, rel=1e-4), i


def test_kruskal_matches_jax_and_scipy():
    rng = np.random.default_rng(7)
    g1 = rng.integers(0, 12, size=(40, 4)).astype(np.float32)
    g2 = rng.integers(0, 12, size=(40, 5)).astype(np.float32)
    g3 = rng.integers(0, 12, size=(40, 3)).astype(np.float32)
    allv = np.concatenate([g1, g2, g3], axis=1)
    sizes = np.array([4, 5, 3])
    got = tstats.kruskal(torch.from_numpy(allv), sizes).numpy()
    np.testing.assert_allclose(got, np.asarray(jstats.kruskal(allv, sizes)), rtol=1e-4)
    for i in range(40):
        expected = sps.kruskal(g1[i], g2[i], g3[i]).pvalue
        assert got[i] == pytest.approx(expected, rel=1e-4), i


def test_fisher_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        tstats.fisher_right_tail(*(torch.zeros(4, device="meta") for _ in range(4)))


def test_fisher_wrapper_takes_the_plain_version_on_the_cpu_only():
    """The CPU branch is the only call of the plain version; on a CUDA
    tensor the wrapper launches csrc/stats.cu, counts under a lock and
    raises KernelError when the launch fails."""
    text = (PORT / "ops" / "stats.py").read_text()
    assert 'kernels.load("stats")' in text
    body = text[text.index("def fisher_right_tail("):]
    body = body[: body.index("\ndef ")]
    assert body.count("fisher_right_tail_plain(") == 1
    assert ('if a.device.type == "cpu":\n        return fisher_right_tail_plain(' in body)
    cuda = body[body.index("return fisher_right_tail_plain("):].split("\n", 1)[1]
    assert "_plain(" not in cuda and "lib = stats_lib()" in cuda
    assert "raise KernelError(" in cuda
    assert 'with _launch_lock:\n        launches["fisher_right_tail"] += 1' in cuda


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [20, 48_000])
def test_cuda_fisher_kernel_matches_plain(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(rows)
    counts = torch.from_numpy(rng.integers(0, 500, size=(rows, 3))).cuda()
    tables = tstats.enrich_tables(counts)
    before = tstats.launches["fisher_right_tail"]
    got = tstats.fisher_right_tail(*tables)
    torch.cuda.synchronize()
    assert tstats.launches["fisher_right_tail"] == before + 1
    want = tstats.fisher_right_tail_plain(*tables)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    m = want > 1e-30
    np.testing.assert_allclose(got[m], want[m], rtol=1e-4)
    np.testing.assert_array_equal(got <= 0.05, want <= 0.05)
