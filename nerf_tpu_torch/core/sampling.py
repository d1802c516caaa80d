"""Depth sampling: stratified and inverse-CDF importance samples, max-blur,
the proposal bounds, the coarse/fine merge of Ref-NeRF (port of
nerf_tpu/core/sampling.py:43-288 and fastmath.sorted_uniforms).

The JAX package reads interval endpoints with gather-free compare-and-reduce
forms and cumulative sums as triangular matmuls; those are TPU layout
workarounds.  The port keeps their values with ``torch.searchsorted``,
``torch.gather`` and ``torch.cumsum``.  Every random draw takes an explicit
``torch.Generator``; tests inject the draws instead.
"""

from __future__ import annotations

import torch


def stratified_samples(n_rays: int, n_samples: int, near: float, far: float,
                       jitter: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       device=None) -> torch.Tensor:
    """Jittered depths linspace(near, far - res) + U(0, res), (n_rays, n_samples).

    ``jitter`` (n_rays, n_samples) uniforms override the draw.
    """
    if jitter is not None:
        device = jitter.device
    res = (far - near) / n_samples
    base = torch.linspace(near, far - res, n_samples, dtype=torch.float32,
                          device=device)
    if jitter is None:
        jitter = torch.rand((n_rays, n_samples), generator=generator,
                            device=device)
    return base[None, :] + jitter * res


def sorted_uniforms(shape, generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """Sorted iid U(0, 1) draws without a sort: n + 1 Exp(1) spacings,
    prefix sums S, then S_i / S_{n+1} has the law of sorted uniforms."""
    *batch, n = shape
    e = torch.empty((*batch, n + 1), dtype=torch.float32, device=device)
    e.exponential_(generator=generator)
    s = torch.cumsum(e, dim=-1)
    return s[..., :n] / s[..., n:]


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
    """Inverse-transform sampling of the piecewise-constant PDF over ``bins``.

    bins (..., M) sorted edges, weights (..., M-1) unnormalized.  Returns
    (samples, below, above), each (..., n_samples).  Keeps the 1e-5 weight
    floor and the ``denom < 1e-5`` guard.
    """
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)           # (..., M)
    if u is None:
        u = torch.rand((*cdf.shape[:-1], n_samples), generator=generator,
                       device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b), below, above


def inverse_sample(weights: torch.Tensor, coarse_depth: torch.Tensor,
                   n_samples: int, u: torch.Tensor | None = None,
                   generator: torch.Generator | None = None):
    """Sorted importance samples of fine depths from proposal weights (R, P)
    (``inverse_sample(sort=True)`` of the JAX package).

    Bins are the midpoints of ``coarse_depth`` and the PDF the interior
    weights [1:-1].  The uniforms are sorted (drawn by ``sorted_uniforms``
    unless ``u`` is given, and then must be sorted), so the samples come out
    sorted without a sort.  Returns (samples, below).
    """
    weights = weights.detach()
    z_mid = 0.5 * (coarse_depth[..., 1:] + coarse_depth[..., :-1])
    if u is None:
        u = sorted_uniforms((*weights.shape[:-1], n_samples), generator,
                            device=weights.device)
    samples, below, _ = sample_pdf(z_mid, weights[..., 1:-1], n_samples, u=u)
    return samples, below


def max_blur_filter(weights: torch.Tensor, alpha: float) -> torch.Tensor:
    """2-tap max, then 2-tap blur, plus ``alpha`` (mip-360 proposal filter)."""
    maxi = torch.maximum(weights[..., :-1], weights[..., 1:])
    front = torch.cat([weights[..., :1], maxi], dim=-1)
    rear = torch.cat([maxi, weights[..., -1:]], dim=-1)
    return 0.5 * (front + rear) + alpha


def merge_coarse_fine(c_z: torch.Tensor, f_z: torch.Tensor) -> torch.Tensor:
    """Sorted merge of coarse (R, C) and fine (R, F) depths with the largest
    element dropped: z_merged (R, C + F - 1).

    A stable sort of cat(fine, coarse), as the reference does (on ties the
    fine entries come first); ``merge_coarse_fine_via_sort`` of the JAX
    package.  The index bookkeeping of its training form is not ported yet.
    """
    z = torch.cat([f_z, c_z], dim=-1).to(torch.float32)
    return torch.sort(z, dim=-1, stable=True).values[..., :-1]


def weight_bounds(prop_weights: torch.Tensor,
                  below_idx: torch.Tensor) -> torch.Tensor:
    """Proposal-weight mass over each fine-sample index interval.

    prop_weights (R, P); below_idx (R, K) sorted lower indices from
    ``inverse_sample``.  bounds[:, k] = sum(prop_weights[:, start_k:end_k])
    with starts = below_idx[:, :-1] and ends = below_idx[:, 1:] + 1, read as
    two endpoints of the cumulative sum (R, K - 1).  Differentiable in
    ``prop_weights``.
    """
    sat = torch.cat([torch.zeros_like(prop_weights[..., :1]),
                     torch.cumsum(prop_weights.to(torch.float32), dim=-1)],
                    dim=-1)
    below_idx = below_idx.to(torch.int64)
    return (torch.gather(sat, -1, below_idx[..., 1:] + 1)
            - torch.gather(sat, -1, below_idx[..., :-1]))
