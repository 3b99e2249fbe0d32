"""PCA via the gram matrix (samples are chromosomes: n tiny, features huge).

Replaces sklearn.decomposition.PCA (reference Cluster.py:48-54). For
(n, F) data with n ~ 20 and F up to millions, the full SVD is wasteful;
the eigendecomposition of the (n, n) gram matrix of centered data gives the
same scores. Sign convention follows sklearn's svd_flip (largest-|loading|
component of each score column made positive) so plots are reproducible.

The gram product is one ``torch.matmul`` on the data's device, in full
float32 (TF32 off); the (n, n) eigendecomposition is ``torch.linalg.eigh``.
"""

from __future__ import annotations

import torch


def pca_fit_transform(x: torch.Tensor, n_components: int):
    """(scores (n, n_components), explained_variance_ratio (n_components,))
    of ``x`` (n, F), on ``x``'s device and in its dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    gram = torch.matmul(xc, xc.T)  # (n, n)
    evals, evecs = torch.linalg.eigh(gram)  # ascending
    evals = evals.flip(0).clamp_min(0.0)
    evecs = evecs.flip(1)
    # scores = U * S where gram = U S^2 U^T
    scores = evecs * evals.sqrt()[None, :]
    # svd_flip (u-based): flip sign so max-|value| entry of each column is +
    idx = scores.abs().argmax(dim=0)
    signs = torch.sign(scores[idx, torch.arange(n, device=x.device)])
    signs = torch.where(signs == 0, 1.0, signs)
    scores = scores * signs[None, :]
    total = evals.sum().clamp_min(1e-30)
    ratio = evals / total
    return scores[:, :n_components], ratio[:n_components]
