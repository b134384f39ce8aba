"""m-step Lanczos tridiagonalization for Hessian spectra: the port of
``repro.diagnostics.lanczos``.

Given a symmetric linear operator ``matvec`` (normally a
:class:`repro_torch.diagnostics.hvp.FlatHVP` on the flat ``(rows,
128)`` buffer) this runs m Lanczos steps on the operator's device with
no read-back, producing the tridiagonal coefficients ``(alphas,
betas)`` as device tensors. From those (on the host: T is m×m):

* :func:`top_k_eigenvalues` — Ritz values, the top-k Hessian
  eigenvalue estimates (λ_max with k=1);
* :func:`spectral_density_stem` — (Ritz values, Gaussian-quadrature
  weights = squared first eigenvector components), the stem of
  stochastic Lanczos quadrature (Ghorbani et al. 2019);
* :func:`spectral_density` / :func:`slq_spectral_density` — the full
  SLQ estimate, Gaussian bumps at the Ritz values weighted by the
  quadrature weights, averaged over probe seeds.

``reorth=True`` (default) keeps the Krylov basis and
re-orthogonalizes every residual against it, which removes the
ghost-eigenvalue pathology of plain Lanczos in f32. The basis is
``num_iters × N`` floats on the device and is allocated only then;
without it the device holds one f32 vector beside the operator's own
work (the previous one waits in host memory), which is what lets a
probe run on a 3B-parameter model.

The residual keeps the reference's order of operations, ``(w − αv) −
βv_prev``, then the reorthogonalization; it is formed in place in
chunks, so no temporary as large as a vector is made. Breakdown (an
invariant subspace found before m steps) is handled as the reference
does: a residual norm at or below 1e-10 zeroes the next vector, and
the trailing block contributes exact zero eigenvalues.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_BREAKDOWN_TOL = 1e-10
_CHUNK = 1 << 26        # elements per piece of a vector-wide operation


class LanczosResult(NamedTuple):
    alphas: torch.Tensor   # [m] diagonal of T
    betas: torch.Tensor    # [m] residual norms; betas[:-1] = off-diagonal


def _pieces(n: int) -> list:
    return [slice(s, min(s + _CHUNK, n)) for s in range(0, n, _CHUNK)]


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a, b⟩ of two flat f32 vectors as a 0-d device tensor, summed
    piece by piece (a BLAS dot takes a 32-bit length)."""
    total = None
    for s in _pieces(a.numel()):
        d = torch.dot(a[s], b[s])
        total = d if total is None else total + d
    return total


class BlockInner:
    """Inner products of flat vectors that hold this rank's blocks of
    the whole vectors (the GSPMD probe): the sums over the segments this
    rank counts (``Placement.counts_once``: the ranks holding copies of
    one block count it once between them), then one sum over the mesh
    (``Mesh.sum_blocks_``), so every rank holds the whole vectors'
    product. ``spec`` is the rank's flat layout, ``place`` the
    placement; segments are whole rows, so each counted segment is one
    range of the flat vector."""

    def __init__(self, spec, place):
        from repro_torch.core.flatten import LANES
        self.mesh = place.mesh
        ranges: list = []
        for paths, off, rows in zip(spec.paths, spec.row_offset,
                                    spec.seg_rows):
            if not place.counts_once(paths[0]):
                continue
            a, b = off * LANES, (off + rows) * LANES
            if ranges and ranges[-1][1] == a:
                ranges[-1][1] = b
            else:
                ranges.append([a, b])
        self.pieces = [slice(s.start + a, s.stop + a) for a, b in ranges
                       for s in _pieces(b - a)]

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(1, -1).contiguous()
        self.mesh.sum_blocks_(flat, torch.ones(flat.shape[1],
                                               dtype=torch.bool),
                              name="lanczos_dot")
        return flat.reshape(t.shape)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """⟨a, b⟩ of the whole vectors (a 0-d tensor)."""
        total = torch.zeros((), dtype=torch.float32, device=a.device)
        for s in self.pieces:
            total = total + torch.dot(a[s], b[s])
        return self._reduce(total)

    def dots(self, basis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``basis @ w`` of the whole vectors ([m])."""
        total = torch.zeros(basis.shape[0], dtype=torch.float32,
                            device=w.device)
        for s in self.pieces:
            total = total + basis[:, s] @ w[s]
        return self._reduce(total)


def lanczos(matvec: Callable, v0: torch.Tensor, num_iters: int, *,
            reorth: bool = True,
            inner: Optional[BlockInner] = None) -> LanczosResult:
    """m-step Lanczos on ``matvec`` seeded with ``v0`` (any shape;
    normalized into a new buffer, so a caller that drops its reference
    frees it). Deterministic given (matvec, v0). ``inner`` takes the
    inner products of vectors of this rank's blocks over the mesh
    (:class:`BlockInner`); None: the vectors are whole here.

    v_prev is the basis's previous row with ``reorth``; without it,
    v_prev waits in host memory (pinned, for a CUDA vector) while the
    matvec runs and streams back piece by piece into the residual, so
    the device holds one f32 vector beside the operator's work."""
    if num_iters < 1:
        raise ValueError(f"num_iters must be >= 1, got {num_iters}")
    dot = vdot if inner is None else inner.dot
    shape = v0.shape
    r0 = v0.reshape(-1).float()
    del v0
    v = r0 / torch.sqrt(dot(r0, r0))
    del r0
    n = v.numel()
    if reorth:
        basis = torch.zeros((num_iters, n), dtype=torch.float32,
                            device=v.device)
        held = None
    else:
        basis = None
        held = torch.empty(n, dtype=torch.float32, pin_memory=v.is_cuda)
    beta = None
    alphas, betas = [], []
    for i in range(num_iters):
        if basis is not None:
            basis[i] = v
        w = matvec(v.view(shape)).reshape(-1).float()
        if w.data_ptr() == v.data_ptr():
            w = w.clone()
        alpha = dot(w, v)
        for s in _pieces(n):
            piece = w[s]
            piece.sub_(alpha * v[s])
            if i > 0:                   # beta * 0 on the first step
                prev = basis[i - 1][s] if basis is not None \
                    else held[s].to(v.device, non_blocking=True)
                piece.sub_(beta * prev)
        if basis is not None:
            # unwritten basis rows are zero vectors: coefficients 0
            w.sub_(basis.T @ (basis @ w if inner is None
                              else inner.dots(basis, w)))
        beta_new = torch.sqrt(dot(w, w))
        ok = beta_new > _BREAKDOWN_TOL
        w.div_(torch.clamp(beta_new, min=_BREAKDOWN_TOL)).mul_(ok)
        beta = torch.where(ok, beta_new, torch.zeros_like(beta_new))
        alphas.append(alpha)
        betas.append(beta)
        if held is not None:
            held.copy_(v)
        v = w
    return LanczosResult(alphas=torch.stack(alphas),
                         betas=torch.stack(betas))


def _host(x) -> torch.Tensor:
    """An f32 host tensor of ``x`` (a tensor on any device, or an
    array-like, copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32))


def tridiagonal(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """The m×m symmetric tridiagonal T from Lanczos coefficients."""
    off = betas[:-1]
    return torch.diag(alphas) + torch.diag(off, 1) + torch.diag(off, -1)


def top_k_eigenvalues(alphas: torch.Tensor, betas: torch.Tensor,
                      k: int = 1) -> torch.Tensor:
    """Top-k Ritz values (descending, f32 on the host) — Hessian
    eigenvalue estimates."""
    m = int(alphas.shape[0])
    if not 1 <= k <= m:
        raise ValueError(f"k={k} must be in [1, num_iters={m}]")
    evals = torch.linalg.eigh(tridiagonal(_host(alphas), _host(betas)))[0]
    return evals.flip(0)[:k]


def spectral_density_stem(alphas: torch.Tensor, betas: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ritz values asc., quadrature weights) for one probe vector.

    Weights are the squared first components of T's eigenvectors;
    averaging Gaussian bumps at the Ritz values over several random
    seeds yields the stochastic-Lanczos-quadrature spectral density.
    """
    evals, evecs = torch.linalg.eigh(tridiagonal(_host(alphas),
                                                 _host(betas)))
    return evals, evecs[0, :] ** 2


def spectral_density(ritz, weights, grid, sigma: float) -> torch.Tensor:
    """Gaussian-kernel SLQ density on ``grid`` from stacked stems.

    ``ritz``/``weights`` are ``[num_seeds, m]`` (one
    :func:`spectral_density_stem` per probe vector); the estimate is

        ρ(t) = (1/S) Σ_s Σ_i w_si · N(t; θ_si, σ²)

    — each seed's quadrature weights sum to 1, so ρ integrates to 1.
    Returns ``[len(grid)]`` f32 on the host.
    """
    ritz = torch.atleast_2d(_host(ritz))
    weights = torch.atleast_2d(_host(weights))
    grid = _host(grid)
    if sigma <= 0.0:
        raise ValueError(f"sigma must be > 0, got {sigma}")
    z = (grid[:, None, None] - ritz[None, :, :]) / sigma
    root = torch.sqrt(torch.tensor(2.0 * math.pi, dtype=torch.float32))
    bumps = torch.exp(-0.5 * z * z) / (sigma * root)
    return torch.mean(torch.sum(weights[None, :, :] * bumps, dim=-1),
                      dim=-1)


class SLQDensity(NamedTuple):
    grid: torch.Tensor      # [G] evaluation points
    density: torch.Tensor   # [G] normalized eigenvalue density
    ritz: torch.Tensor      # [S, m] Ritz values per seed
    weights: torch.Tensor   # [S, m] quadrature weights per seed
    sigma: float            # Gaussian kernel width used


def slq_spectral_density(matvec: Callable, v0s: torch.Tensor,
                         num_iters: int, grid=None, *,
                         grid_points: int = 64,
                         sigma: Optional[float] = None,
                         reorth: bool = True) -> SLQDensity:
    """Full SLQ pipeline: Lanczos per seed vector → stems → Gaussian
    density.

    ``v0s``: ``[num_seeds, ...]`` probe vectors (flat-layout probes
    should be :func:`repro_torch.diagnostics.hvp.padding_mask`-
    projected). ``grid=None`` auto-brackets: ``grid_points`` points
    spanning the observed Ritz range with a 10% margin. ``sigma``
    defaults to 2× the grid spacing.
    """
    num_seeds = int(v0s.shape[0])
    if num_seeds < 1:
        raise ValueError("need at least one seed vector")
    stems = []
    for s in range(num_seeds):
        res = lanczos(matvec, v0s[s], num_iters, reorth=reorth)
        stems.append(spectral_density_stem(res.alphas, res.betas))
    ritz = torch.stack([r for r, _ in stems])
    weights = torch.stack([w for _, w in stems])
    if grid is None:
        if grid_points < 2:
            raise ValueError(f"grid_points must be >= 2, "
                             f"got {grid_points}")
        lo = float(ritz.min())
        hi = float(ritz.max())
        pad = 0.1 * max(hi - lo, 1e-6)
        grid = torch.linspace(lo - pad, hi + pad, grid_points)
    grid = _host(grid)
    if sigma is None:
        if grid.shape[0] < 2:
            raise ValueError("default sigma needs a grid with >= 2 "
                             "points; pass sigma= explicitly")
        sigma = 2.0 * float(grid[1] - grid[0])
    return SLQDensity(grid=grid,
                      density=spectral_density(ritz, weights, grid, sigma),
                      ritz=ritz, weights=weights, sigma=float(sigma))


def lanczos_top_k(matvec: Callable, v0: torch.Tensor, num_iters: int,
                  k: int = 1, *, reorth: bool = True) -> torch.Tensor:
    """Convenience: run Lanczos, return top-k eigenvalues descending
    (``v0`` stays referenced by this frame during the run)."""
    res = lanczos(matvec, v0, num_iters, reorth=reorth)
    return top_k_eigenvalues(res.alphas, res.betas, k)
