"""Host-side graph math (numpy/scipy) that the ported models need.

The port's own copy of the pieces of the JAX package's
``utils/graph.py`` used by this slice: node orderings (Identity, Degree,
RCM) and K-hop neighborhood tables for selection pooling. Like there,
everything here runs once at build time and emits index arrays.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

ZERO_TOL = 1e-9

__all__ = ["compute_neighborhood", "perm_identity", "perm_degree",
           "perm_rcm", "permutation_by_name"]


def _binary_connectivity(S) -> scipy.sparse.csr_matrix:
    """Collapse an (E x N x N | N x N) GSO to a binary CSR."""
    S = np.asarray(S)
    S = np.abs(S).sum(axis=0) if S.ndim == 3 else np.abs(S)
    return scipy.sparse.csr_matrix((S > ZERO_TOL).astype(np.float64))


def compute_neighborhood(S, K: int, n_rows=None, nb=None, output_type="list"):
    """Indices of all nodes reachable in <= K hops from each of the first
    `n_rows` nodes, trimmed to indices < `nb`.

    output_type 'list'   -> list of sorted int arrays, one per node;
    output_type 'matrix' -> int array [n_rows, max_size] padded with the
                            row's own index, so that gathering a padded
                            slot re-reads the node itself (neutral for max
                            pooling).

    Reachability is R_K = bool((I + A)^K), K sparse boolean products.
    """
    if output_type not in ("list", "matrix"):
        raise ValueError(f"unknown output_type {output_type!r}")
    A = _binary_connectivity(S)
    N = A.shape[0]
    n_rows = N if n_rows is None else int(n_rows)
    nb = N if nb is None else int(nb)
    if not (0 <= n_rows <= N and 0 <= nb <= N):
        raise ValueError(f"n_rows={n_rows}, nb={nb} out of range for N={N}")

    reach = scipy.sparse.identity(N, dtype=bool, format="csr")
    hop = (A > 0).astype(bool) + scipy.sparse.identity(N, dtype=bool,
                                                       format="csr")
    for _ in range(K):
        reach = (reach @ hop).astype(bool)
    reach = reach.tocsr()

    neighbors = []
    for i in range(n_rows):
        cols = reach.indices[reach.indptr[i]:reach.indptr[i + 1]]
        neighbors.append(np.asarray(sorted(cols[cols < nb]), dtype=np.int64))

    if output_type == "list":
        return neighbors
    max_size = max((len(nb_i) for nb_i in neighbors), default=1)
    out = np.empty((n_rows, max_size), dtype=np.int64)
    for i, nb_i in enumerate(neighbors):
        out[i, :len(nb_i)] = nb_i
        out[i, len(nb_i):] = i  # pad with self
    return out


def _as_batched(S):
    if S.ndim == 2:
        if S.shape[0] != S.shape[1]:
            raise ValueError(f"GSO must be square, got {S.shape}")
        return S[None], True
    if not (S.ndim == 3 and S.shape[1] == S.shape[2]):
        raise ValueError(f"GSO must be (E, N, N), got {S.shape}")
    return S, False


def _apply_order(S, order, squeeze):
    S = S[:, order, :][:, :, order]
    return S[0] if squeeze else S


def perm_identity(S):
    """No reordering; returns (S, [0..N-1])."""
    Sb, squeeze = _as_batched(S)
    order = np.arange(Sb.shape[1])
    return (Sb[0] if squeeze else Sb), order.tolist()


def perm_degree(S):
    """Order nodes by decreasing degree (summed over edge features)."""
    Sb, squeeze = _as_batched(S)
    degree = Sb.sum(axis=(0, 1))
    order = np.flip(np.argsort(degree))
    return _apply_order(Sb, order, squeeze), order.tolist()


def perm_rcm(S):
    """Reverse-Cuthill-McKee ordering (bandwidth minimization), which keeps
    band-mode GSOs narrow."""
    Sb, squeeze = _as_batched(S)
    A = scipy.sparse.csr_matrix(
        (np.abs(Sb).sum(axis=0) > ZERO_TOL).astype(float))
    order = np.asarray(scipy.sparse.csgraph.reverse_cuthill_mckee(
        A, symmetric_mode=False))
    return _apply_order(Sb, order, squeeze), order.tolist()


_PERMS = {
    None: perm_identity,
    "Identity": perm_identity,
    "Degree": perm_degree,
    "RCM": perm_rcm,
}
# Orderings of the JAX package not ported yet (ROADMAP queue 1).
_NOT_PORTED = ("SpectralProxies", "EDS")


def permutation_by_name(name):
    """Ordering function by registry name (case-insensitive) or callable."""
    if callable(name):
        return name
    if name in _PERMS:
        return _PERMS[name]
    if isinstance(name, str):
        lowered = {k.lower(): v for k, v in _PERMS.items()
                   if isinstance(k, str)}
        if name.lower() in lowered:
            return lowered[name.lower()]
        if name.lower() in (n.lower() for n in _NOT_PORTED):
            raise NotImplementedError(
                f"node ordering {name!r} is not ported to PyTorch yet")
    raise ValueError(f"unknown node ordering: {name!r}")
