"""Device (torch) statistical functions, float32.

Float32 counterparts of ops/stats_host.py: batched one-sided Fisher exact via
a log-space hypergeometric tail recurrence (replaces the C ``fisher``
extension, reference Stats.py:14-31), Student t-test (reference
Cluster.py:189-192), Mann-Whitney U, Kruskal-Wallis and BH-FDR. The
file-writing pipeline uses the host float64 versions for decision parity;
these compute approximate p-values on whatever device their tensors lie on
(same decisions away from knife-edge ties).

:func:`fisher_right_tail` is a hand-written CUDA kernel (csrc/stats.cu: a
first pass of one thread a table, then a queue of the long walks that each
lane takes from as its table stops). A CPU tensor takes its plain version
(:func:`fisher_right_tail_plain`); a CUDA tensor launches the kernel or
raises :class:`~subphaser_torch.kernels.KernelError`.
``launches["fisher_right_tail"]`` counts the wrapper calls that launched it.
The other functions are torch ops on the input's device.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from subphaser_torch.kernels import KernelError

MAX_INT = 2147483647 // 10

launches = {"fisher_right_tail": 0}
_launch_lock = threading.Lock()
_lib = None


def _f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor, on its own device if it is a tensor."""
    return torch.as_tensor(x).to(torch.float32)


def _lpmf_hypergeom(x, m, n1, k1):
    """log pmf of hypergeom: P(X = x) with population m, successes n1, draws k1."""

    def lc(a, b):
        return torch.lgamma(a + 1.0) - torch.lgamma(b + 1.0) - torch.lgamma(a - b + 1.0)

    return lc(n1, x) + lc(m - n1, k1 - x) - lc(m, k1)


def fisher_right_tail_plain(a, b, c, d, max_terms: int = 16384):
    """The plain version of :func:`fisher_right_tail`: the JAX scan's step
    on whole tensors, as a loop that stops once every term is -inf (every
    later term is then -inf too, and adds nothing to the sum)."""
    m = a + b + c + d
    n1 = a + b
    k1 = a + c
    upper = torch.minimum(n1, k1)
    lp0 = _lpmf_hypergeom(a, m, n1, k1)
    log_sum, log_term = lp0, lp0
    for i in range(max_terms):
        x = a + float(i)
        ratio = ((n1 - x) * (k1 - x)) / ((x + 1.0) * (m - n1 - k1 + x + 1.0))
        valid = x < upper
        log_term = torch.where(valid & (ratio > 0), log_term + torch.log(ratio.clamp_min(1e-38)),
                               -math.inf)
        log_sum = torch.logaddexp(log_sum, log_term)
        if i % 32 == 31 and bool(torch.all(log_term == -math.inf)):
            break
    p = torch.exp(log_sum)
    return torch.where(a > upper, 0.0, p).clamp(0.0, 1.0)


def stats_lib():
    """csrc/stats.cu, built at first use."""
    global _lib
    with _launch_lock:
        if _lib is None:
            import ctypes

            from subphaser_torch import kernels

            lib = kernels.load("stats")
            ptr = ctypes.c_void_p
            lib.st_fisher_right_tail.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong,
                                                 ctypes.c_int, ptr, ptr, ptr]
            lib.st_fisher_right_tail.restype = ctypes.c_int
            lib.st_fisher_scratch_size.argtypes = [ctypes.c_longlong]
            lib.st_fisher_scratch_size.restype = ctypes.c_longlong
            lib.st_error_string.argtypes = [ctypes.c_int]
            lib.st_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def fisher_right_tail(a, b, c, d, max_terms: int = 16384):
    """P(X >= a) for 2x2 tables [[a, b], [c, d]], float32, via the upward
    pmf recurrence.

    pmf(x+1)/pmf(x) = (n1-x)(k1-x) / ((x+1)(m-n1-k1+x+1)); starting at the
    observed cell the ratio is < 1 for enriched tables, so the series
    converges geometrically; ``max_terms`` caps the terms. The four inputs
    broadcast to one shape. A CUDA tensor launches csrc/stats.cu's two
    kernels on the current stream (each walk stops where no later term can
    change its float32 result); a CPU tensor takes
    :func:`fisher_right_tail_plain`."""
    a, b, c, d = torch.broadcast_tensors(*(_f32(v) for v in (a, b, c, d)))
    if len({t.device for t in (a, b, c, d)}) != 1:
        raise ValueError("fisher_right_tail: the four tables' cells must be on one device")
    if max_terms < 0:
        raise ValueError(f"fisher_right_tail: max_terms={max_terms}")
    if a.device.type == "cpu":
        return fisher_right_tail_plain(a, b, c, d, max_terms)
    if a.device.type != "cuda":
        raise ValueError(f"fisher_right_tail: unsupported device {a.device}")
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if out.numel() >= 1 << 31:
        raise ValueError("fisher_right_tail: fewer than 2^31 tables a call")
    lib = stats_lib()
    cells = [t.contiguous() for t in (a, b, c, d)]
    scratch = torch.empty(lib.st_fisher_scratch_size(out.numel()), dtype=torch.int32,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.st_fisher_right_tail(*(t.data_ptr() for t in cells), out.numel(), max_terms,
                                       out.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise KernelError("st_fisher_right_tail launch failed: "
                          + lib.st_error_string(err).decode())
    with _launch_lock:
        launches["fisher_right_tail"] += 1
    return out


def enrich_tables(counts):
    """The (x11, x12, x21, x22) tables of :func:`fisher_enrich_pvals`, float32."""
    counts = _f32(counts)
    total = counts.sum(dim=0)
    rowsum = counts.sum(dim=1, keepdim=True)
    grand = total.sum()
    x11 = counts
    x12 = rowsum - x11
    x21 = torch.clamp_max(total[None, :] - x11, float(MAX_INT))
    x22 = torch.clamp_max(grand - x21 - x12, float(MAX_INT))
    return x11, x12, x21, x22


def fisher_enrich_pvals(counts):
    """Device version of stats_host.fisher_enrich_pvals (float32)."""
    return fisher_right_tail(*enrich_tables(counts))


def _lentz(a, b, x, num_iterations: int, small: float):
    """The continued fraction of the regularized incomplete beta function
    (DLMF 8.17.22) by the modified Lentz method, as jax.scipy's betainc
    evaluates it: every element iterates until all have converged."""

    def numerator(it):
        if it == 1:
            return torch.ones_like(x)
        m = float((it - 1) // 2)
        if it % 2 == 0:
            if m == 0:
                return -(a + b) * x / (a + 1.0)
            return -(a + m) * (a + b + m) * x / ((a + 2.0 * m) * (a + 2.0 * m + 1.0))
        return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))

    h = torch.full_like(x, small)  # the 0th partial denominator is 0
    c, d = h, torch.zeros_like(x)
    it = 1
    unconverged = True
    while it < num_iterations and unconverged:
        pn = numerator(it)
        c = 1.0 + pn / c
        c = torch.where(c.abs() < small, small, c)
        d = 1.0 + pn * d
        d = torch.where(d.abs() < small, small, d)
        d = 1.0 / d
        delta = c * d
        h = h * delta
        it += 1
        unconverged = bool(torch.any((delta - 1.0).abs() >= small))
    return h


def betainc(a, b, x):
    """Regularized incomplete beta function I_x(a, b), as
    jax.scipy.special.betainc computes it (its continued fraction, 200
    iterations in float32, 600 in float64); torch has none."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    info = torch.finfo(x.dtype)
    small = info.eps / 2
    a_is_zero = (a == 0) | (b == math.inf)
    b_is_zero = (b == 0) | (a == math.inf)
    x_is_zero, x_is_one = x == 0, x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_is_zero & b_is_zero)
                     | is_nan)
    # the fraction converges rapidly for x < (a + 1) / (a + b + 2), DLMF
    # 8.17.E23; else use the symmetry I_x(a, b) = 1 - I_{1-x}(b, a), 8.17.E4
    rapid = x < (a + 1.0) / (a + b + 2.0)
    a, b, x = torch.where(rapid, a, b), torch.where(rapid, b, a), torch.where(rapid, x, 1.0 - x)
    cf = _lentz(a, b, x, 200 if x.dtype == torch.float32 else 600, small)
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(a < info.tiny * 2,
                         torch.exp(torch.log1p(-x) * b - lbeta_small_a),
                         torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a)
    result = cf * factor
    result = torch.where(rapid, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, math.nan, result)


def ttest_ind_from_stats(m1, v1, n1, m2, v2, n2):
    """Two-sided pooled-variance t-test p-value (scipy ttest_ind parity)."""
    m1, v1, n1, m2, v2, n2 = (_f32(v) for v in (m1, v1, n1, m2, v2, n2))
    df = n1 + n2 - 2.0
    sp2 = ((n1 - 1.0) * v1 + (n2 - 1.0) * v2) / torch.clamp_min(df, 1e-30)
    denom = torch.sqrt(sp2 * (1.0 / n1 + 1.0 / n2))
    t = (m1 - m2) / denom
    x = df / (df + t * t)
    p = betainc(df / 2.0, torch.full_like(x, 0.5), x)
    # zero pooled variance: equal means -> nan (reference keeps those k-mers);
    # unequal means -> p = 0
    return torch.where(denom == 0, torch.where(m1 == m2, math.nan, 0.0), p)


def _rank_avg(values):
    """Average ranks (ties averaged) along the last axis via pairwise
    compares — group sizes are chromosome counts, so n is tiny."""
    v = values[..., :, None]
    w = values[..., None, :]
    less = (w < v).sum(dim=-1)
    equal = (w == v).sum(dim=-1)
    return less + (equal + 1.0) / 2.0


def _tie_sum(values):
    """sum_i (t_i^2 - 1) over the last axis, t_i the size of i's tie group."""
    counts = (values[..., :, None] == values[..., None, :]).sum(dim=-1)
    return (counts * counts - 1.0).sum(dim=-1)


def mannwhitneyu(x, y):
    """Two-sided Mann-Whitney U p-value, normal approximation with tie
    correction and continuity (scipy mannwhitneyu(method='asymptotic')
    parity; the host path uses scipy's exact method where scipy does).
    x: (B, n1), y: (B, n2).
    """
    x, y = _f32(x), _f32(y)
    n1 = x.shape[-1]
    n2 = y.shape[-1]
    both = torch.cat([x, y], dim=-1)
    ranks = _rank_avg(both)
    r1 = ranks[..., :n1].sum(dim=-1)
    u1 = r1 - n1 * (n1 + 1) / 2.0
    u = torch.maximum(u1, n1 * n2 - u1)
    mu = n1 * n2 / 2.0
    n = n1 + n2
    sigma2 = n1 * n2 / 12.0 * ((n + 1.0) - _tie_sum(both) / (n * (n - 1.0)))
    sigma = torch.sqrt(torch.clamp_min(sigma2, 1e-30))
    z = (u - mu - 0.5) / sigma
    p = torch.special.erfc(torch.clamp_min(z, 0.0) / math.sqrt(2.0))
    return p.clamp(0.0, 1.0)


def kruskal(groups_values, group_sizes):
    """Kruskal-Wallis H-test p-value (chi2 approximation, scipy parity).

    groups_values: (B, n_total) concatenated group observations;
    group_sizes: int array (G,) with sum == n_total.
    """
    values = _f32(groups_values)
    ranks = _rank_avg(values)
    n = values.shape[-1]
    sizes = torch.as_tensor(group_sizes, device=values.device)
    g = sizes.shape[0]
    idx = torch.arange(n, device=values.device)
    group_of = (idx[None, :] >= torch.cumsum(sizes, dim=0)[:, None]).sum(dim=0)  # (n,)
    onehot = F.one_hot(group_of, g).to(ranks.dtype)
    r_sums = ranks @ onehot  # (B, G)
    h = 12.0 / (n * (n + 1.0)) * torch.sum(r_sums**2 / sizes, dim=-1) - 3.0 * (n + 1.0)
    correction = 1.0 - _tie_sum(values) / (n**3 - n)
    h = h / torch.clamp_min(correction, 1e-30)
    df = g - 1.0
    return torch.special.gammaincc(torch.full_like(h, df / 2.0), torch.clamp_min(h, 0.0) / 2.0)


def bh_fdr(pvals):
    """Benjamini-Hochberg adjusted p-values, float32."""
    p = _f32(pvals)
    n = p.shape[0]
    order = torch.argsort(p, stable=True)
    ranked = p[order] * n / torch.arange(1, n + 1, dtype=p.dtype, device=p.device)
    adj = torch.cummin(ranked.flip(0), dim=0).values.flip(0).clamp(0.0, 1.0)
    out = torch.zeros_like(adj)
    out[order] = adj
    return out
