"""Host-side graph math (numpy/scipy) that the ported models need.

The port's own copy of the pieces of the JAX package's
``utils/graph.py`` that the ported slices use: node orderings (Identity,
Degree, RCM), K-hop neighborhood tables for selection pooling, the
structure tables of the static filter families (node-variant tap copies,
edge-variant sparsity masks, the spectral filters' B-spline basis), and
for the source-localization task the SBM generator, the ``Graph`` container, the
GFT, matrix powers and source-node selection. Like there, everything here
runs once at build time on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

ZERO_TOL = 1e-9

__all__ = ["adjacency_to_laplacian", "compute_gft", "matrix_powers",
           "compute_neighborhood", "compute_source_nodes", "is_connected",
           "create_graph", "Graph", "perm_identity", "perm_degree",
           "perm_rcm", "permutation_by_name", "compute_nonzero_rows",
           "nv_copy_nodes", "ev_sparsity_pattern", "spline_basis"]


def adjacency_to_laplacian(W: np.ndarray) -> np.ndarray:
    """Combinatorial Laplacian L = D - W."""
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"W must be square, got {W.shape}")
    return np.diag(W.sum(axis=1)) - W


def compute_gft(S: np.ndarray, order: str = "no"):
    """Eigendecomposition of a GSO.

    Returns (E, V) with E = diag(eigenvalues) ordered by `order`:
      'no'             -- whatever the solver returns,
      'increasing'     -- by |lambda|,
      'totalVariation' -- by |lambda - lambda_max| (graph frequency).
    """
    if order not in ("no", "increasing", "totalVariation"):
        raise ValueError(f"unknown GFT order {order!r}")
    if S.shape[0] != S.shape[1]:
        raise ValueError(f"S must be square, got {S.shape}")
    if np.allclose(S, S.T, atol=ZERO_TOL):
        e, V = np.linalg.eigh(S)
    else:
        e, V = np.linalg.eig(S)
    if order == "totalVariation":
        idx = np.argsort(np.abs(e - np.max(e.real)))
    elif order == "increasing":
        idx = np.argsort(np.abs(e))
    else:
        idx = np.arange(S.shape[0])
    return np.diag(e[idx]), V[:, idx]


def matrix_powers(S: np.ndarray, K: int) -> np.ndarray:
    """Stack [I, S, S^2, ..., S^{K-1}]; accepts N x N or E x N x N."""
    single = S.ndim == 2
    if single:
        S = S[None]
    E, N, _ = S.shape
    out = np.empty((E, K, N, N), dtype=S.dtype)
    out[:, 0] = np.eye(N, dtype=S.dtype)
    for k in range(1, K):
        out[:, k] = out[:, k - 1] @ S
    return out[0] if single else out


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


def compute_source_nodes(A: np.ndarray, C: int, seed=0):
    """Spectral-cluster A into C communities; return the max-degree node of
    each community (the class labels of the source-localization task).
    Needs scikit-learn."""
    from sklearn.cluster import SpectralClustering
    degree = A.sum(axis=0)
    labels = SpectralClustering(
        n_clusters=C, affinity="precomputed", assign_labels="discretize",
        random_state=seed,
    ).fit(A).labels_
    sources = []
    for c in range(C):
        members = np.flatnonzero(labels == c)
        sources.append(int(members[np.argmax(degree[members])]))
    return sources


def is_connected(W: np.ndarray) -> bool:
    """Connectivity of the undirected support of W."""
    Wb = scipy.sparse.csr_matrix((np.abs(W) + np.abs(W.T)) > ZERO_TOL)
    n_comp, _ = scipy.sparse.csgraph.connected_components(Wb, directed=False)
    return n_comp == 1


def _create_sbm(N, n_communities, prob_intra, prob_inter, rng):
    """Balanced-community SBM, resampled until connected."""
    C = n_communities
    sizes = [N // C] * C
    for c in range(N - sum(sizes)):
        sizes[c] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    prob = np.full((N, N), prob_inter)
    for c in range(C):
        prob[bounds[c]:bounds[c + 1], bounds[c]:bounds[c + 1]] = prob_intra
    while True:
        W = (rng.random((N, N)) < prob).astype(np.float64)
        W = np.triu(W, 1)
        W = W + W.T
        if is_connected(W):
            return W


def create_graph(graph_type: str, N: int, options: dict, rng=None):
    """Graph generator: 'SBM' or 'adjacency' (the JAX package's
    'SmallWorld' and 'fuseEdges' are not ported). Returns the (weighted)
    adjacency matrix."""
    rng = np.random.default_rng() if rng is None else rng
    if graph_type == "SBM":
        return _create_sbm(N, options["nCommunities"], options["probIntra"],
                           options["probInter"], rng)
    if graph_type == "adjacency":
        W = np.asarray(options["adjacencyMatrix"])
        if W.shape != (N, N):
            raise ValueError(f"adjacency {W.shape} is not {N} x {N}")
        return W
    if graph_type in ("SmallWorld", "fuseEdges"):
        raise NotImplementedError(
            f"graph type {graph_type!r} is not ported to PyTorch yet")
    raise ValueError(f"unknown graph type: {graph_type!r}")


class Graph:
    """Build-time graph container.

    Attributes: N, M (edges), W (weighted adjacency), A (binary), D (degree
    matrix), L (Laplacian if undirected & no self-loops), S (GSO; defaults to
    W), undirected, self_loops.
    """

    def __init__(self, graph_type: str, N: int, options: dict, rng=None):
        if N <= 0:
            raise ValueError(f"N must be positive, got {N}")
        self.W = create_graph(graph_type, N, options, rng=rng)
        self.N = self.W.shape[0]
        self.undirected = np.allclose(self.W, self.W.T, atol=ZERO_TOL)
        self.self_loops = bool(np.any(np.abs(np.diag(self.W)) > ZERO_TOL))
        self.D = np.diag(self.W.sum(axis=1))
        self.M = int(np.sum(np.triu(self.W)) if self.undirected
                     else np.sum(self.W))
        self.A = (np.abs(self.W) > 0).astype(self.W.dtype)
        self.L = (adjacency_to_laplacian(self.W)
                  if self.undirected and not self.self_loops else None)
        self.S = self.W


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


def compute_nonzero_rows(S: np.ndarray, n_rows=None):
    """Per-row nonzero column indices for the first `n_rows` rows."""
    n_rows = S.shape[0] if n_rows is None else n_rows
    return [np.flatnonzero(np.abs(S[i]) > ZERO_TOL) for i in range(n_rows)]


# ---------------------------------------------------------------------------
# Per-layer structure tables of the static filter families
# ---------------------------------------------------------------------------

def nv_copy_nodes(S, M: int) -> np.ndarray:
    """Tap-copy map for the hybrid node-variant filter.

    The first M nodes (in the importance order baked into S) own independent
    taps; every other node copies the tap of its nearest selected node by
    hop distance, ties broken by smallest index (reference semantics of
    NodeVariantGF.addGSO, graphML.py:2403-2468). Returns int array (N,)
    with values < M.
    """
    S = np.asarray(S)
    N = S.shape[-1]
    if M >= N:
        return np.arange(N, dtype=np.int64)
    copy_nodes = np.arange(N, dtype=np.int64)
    pending = list(range(M, N))
    K = 1
    while pending:
        nb = compute_neighborhood(S, K, nb=M, output_type="list")
        still = []
        for n in pending:
            if len(nb[n]) > 0:
                copy_nodes[n] = int(min(nb[n]))
            else:
                still.append(n)
        pending = still
        K += 1
        if K > N + 1:
            raise ValueError("graph has nodes unreachable from the first M")
    return copy_nodes


def ev_sparsity_pattern(S, M=None):
    """Sparsity masks for the (hybrid) edge-variant filter.

    Returns (identity_mask, shift_mask), both (E, N, N): shift_mask is the
    (|S|+I > 0) support ANDed with the hybrid mask that keeps full
    edge-variant freedom only among/into the first M nodes; identity_mask is
    the (hybrid-masked) identity used at k=0 (reference
    EdgeVariantGF.addGSO, graphML.py:2608-2668).
    """
    S = np.asarray(S)
    if S.ndim == 2:
        S = S[None]
    E, N, _ = S.shape
    M = N if M is None else int(M)
    eye = np.broadcast_to(np.eye(N), (E, N, N)).copy()
    pattern = ((np.abs(S) + eye) > ZERO_TOL).astype(np.float64)
    if M < N:
        hybrid = np.ones((N, N))
        hybrid[M:, M:] = 0.0
        pattern = pattern * hybrid[None]
        eye = eye * hybrid[None]
    return eye, pattern


def spline_basis(K: int, x, degree: int = 3) -> np.ndarray:
    """Cox-de Boor B-spline basis with K control points evaluated at x
    (or at `x` evenly spaced points if x is scalar): (len(x), K)."""
    if np.isscalar(x):
        x = np.linspace(0, 1, int(x))
    x = np.asarray(x, dtype=np.float64)
    knots = np.concatenate([
        np.full(degree, x.min()),
        np.linspace(x.min(), x.max(), K - degree + 1),
        np.full(degree, x.max()),
    ])

    def basis_fn(k, d):
        if d == 0:
            return ((x - knots[k] >= 0) & (x - knots[k + 1] < 0)).astype(float)
        out = 0.0
        den1 = knots[k + d] - knots[k]
        if den1 > 0:
            out = (x - knots[k]) / den1 * basis_fn(k, d - 1)
        den2 = knots[k + d + 1] - knots[k + 1]
        if den2 > 0:
            out = out - (x - knots[k + d + 1]) / den2 * basis_fn(k + 1, d - 1)
        return out

    B = np.column_stack([basis_fn(k, degree) for k in range(K)])
    # the half-open Cox-de Boor intervals leave the right endpoint uncovered
    B[np.isclose(x, x.max()), -1] = 1.0
    return B
